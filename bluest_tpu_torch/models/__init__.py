from .analytic import (ExpSeriesHostProblem, ExpSeriesMultiProblem,
                       ExpSeriesProblem)
from .diffusion import (DiffusionProblem, solve_diffusion,
                        solve_diffusion_outputs, thomas_solve)
from .hodgkin_huxley import HodgkinHuxleyProblem
from .matern2d import Matern2DProblem, matern2d_outputs, sample_matern2d
