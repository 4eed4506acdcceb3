from .diffusion import (DiffusionProblem, solve_diffusion,
                        solve_diffusion_outputs, thomas_solve)
