"""Multi-fidelity 2D Matern random field family (SPDE route).

Port of ``bluest_tpu/models/matern2d.py`` (the reference's Matern
restriction study,
examples/paper_examples/restrictions_matern/restrictions_matern.py): the
model hierarchy is the SPDE sampler of a Matern field,

    (kappa^2 - Laplace)^alpha  z = white noise,   z|_boundary = 0,

discretized with the Dirichlet sine basis on an n_l x n_l grid.  In that
basis the operator is diagonal, so a sample is one spectral scaling plus
two sine-synthesis matrix products, batched over samples:

    z = S ( W_hat * g(lambda) ) S^T,   g = (kappa^2 + lambda)^-alpha

Fidelities share the SAME white-noise coefficients on the finest spectral
grid (one (n, n0, n0) draw per chunk); coarser models use the
low-frequency block (spectral restriction -- the study's coupling).  QoIs
(3 outputs): field energy mean(z^2), center value z(1/2,1/2), and a
smooth exceedance functional mean(sigmoid(4 (z - 1))).  The synthesis is
a plain batched ``torch.matmul``, as the JAX package computes it outside
any Pallas kernel.  On a (samples x model) mesh the synthesis spans the
model axis (``sample_matern2d_sharded``): each rank of a model instance
synthesises its block of x-modes and the field is assembled by an
``all_reduce`` over the model group.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import MODEL_AXIS
from ..problem import BLUEProblem


def _sine_basis(n: int, dtype, device=None) -> torch.Tensor:
    """S[i, j] = sqrt(2) sin(pi (i+1/2)/n * (j+1)) evaluated on the cell
    centers of an n-point grid, modes j = 1..n (formed in f64, then
    cast)."""
    x = (np.arange(n) + 0.5) / n
    j = np.arange(1, n + 1)
    return torch.as_tensor(np.sqrt(2.0) * np.sin(np.pi * x[:, None]
                                                 * j[None, :]),
                           dtype=dtype, device=device)


def _spectrum(n: int, kappa: float, alpha: float, dtype,
              device=None) -> torch.Tensor:
    """g on the n x n mode grid, normalized so the field variance stays
    O(1) across kappa."""
    j = torch.arange(1, n + 1, dtype=dtype, device=device)
    lam = (np.pi * j[:, None]) ** 2 + (np.pi * j[None, :]) ** 2
    g = (kappa ** 2 + lam) ** (-alpha)
    return g * kappa ** (2 * alpha - 1)


def sample_matern2d(w_hat: torch.Tensor, n: int, kappa: float = 8.0,
                    alpha: float = 1.0, basis=None) -> torch.Tensor:
    """Field samples on the n x n grid from finest-grid white-noise
    coefficients w_hat (B, n0, n0); uses the top-left (low-frequency)
    n x n block.  ``basis`` = (S, g) if already formed.  Returns z
    (B, n, n)."""
    if basis is None:
        basis = (_sine_basis(n, w_hat.dtype, w_hat.device),
                 _spectrum(n, kappa, alpha, w_hat.dtype, w_hat.device))
    S, g = basis
    return S @ (w_hat[:, :n, :n] * g) @ S.T


def sample_matern2d_sharded(w_hat: torch.Tensor, n: int, mesh,
                            kappa: float = 8.0, alpha: float = 1.0,
                            basis=None) -> torch.Tensor:
    """Model-parallel field synthesis: this model rank synthesises its
    block of x-modes, ``S[:, blk] @ (w_hat g)[blk, :] @ S^T``, and the
    full field is assembled with an ``all_reduce`` over the model group
    of ``mesh`` -- the form of the reference's internally-MPI-parallel
    user models (blue_models.py:121-130, restrictions_matern.py:19-37).
    Every rank of the model group passes the same ``w_hat``.  Requires n
    divisible by the model-axis size."""
    if basis is None:
        basis = (_sine_basis(n, w_hat.dtype, w_hat.device),
                 _spectrum(n, kappa, alpha, w_hat.dtype, w_hat.device))
    S, g = basis
    if n % mesh.n_model:
        raise ValueError("grid %d is not divisible by the model-axis size "
                         "%d" % (n, mesh.n_model))
    rows = n // mesh.n_model
    blk = slice(mesh.model_rank * rows, (mesh.model_rank + 1) * rows)
    part = S[:, blk] @ (w_hat[:, :n, :n] * g)[:, blk, :] @ S.T
    return mesh.all_reduce_model(part)


def _qois(z: torch.Tensor, n: int) -> torch.Tensor:
    q_energy = torch.mean(z * z, dim=(1, 2))
    q_center = z[:, n // 2, n // 2]
    q_exceed = torch.mean(torch.sigmoid((z - 1.0) * 4.0), dim=(1, 2))
    return torch.stack([q_energy, q_center, q_exceed], dim=1)


def matern2d_outputs(w_hat: torch.Tensor, n: int, kappa: float = 8.0,
                     alpha: float = 1.0, basis=None,
                     mesh=None) -> torch.Tensor:
    """(B, n0, n0) white noise -> (B, 3) QoIs of the n x n model; with a
    ``mesh`` the synthesis spans its model axis."""
    if mesh is not None:
        z = sample_matern2d_sharded(w_hat, n, mesh, kappa, alpha, basis)
    else:
        z = sample_matern2d(w_hat, n, kappa, alpha, basis)
    return _qois(z, n)


class Matern2DProblem(BLUEProblem):
    """Fidelity = grid resolution (spectral restriction coupling).

    Costs default to the synthesis matmul work, O(n^3), normalized to the
    coarsest model.  ``dtype`` None = float64 (as the JAX package's).  On
    a 2D (samples x model) mesh the evaluation path itself spans the model
    axis (``sample_matern2d_sharded``); the ranks of one model instance
    draw the same chunks and hold the same sums."""

    def __init__(self, grids=(64, 32, 16, 8), kappa: float = 8.0,
                 alpha: float = 1.0, dtype=None, **params):
        self.grids = tuple(int(g) for g in grids)
        self.kappa = kappa
        self.alpha = alpha
        self.dtype = torch.float64 if dtype is None else dtype
        self._bases = {}
        params.setdefault("costs", np.array(
            [(g / grids[-1]) ** 3 for g in self.grids], dtype=float))
        params.setdefault("n_outputs", 3)
        # pilot sampling runs inside super().__init__, so the model axis
        # must be read from the mesh parameter before it
        self._model_mesh = None
        mesh = params.get("mesh")
        if (hasattr(mesh, "axis_names") and MODEL_AXIS in mesh.axis_names
                and mesh.shape[MODEL_AXIS] > 1):
            self._model_mesh = mesh
            if any(g % mesh.shape[MODEL_AXIS] for g in self.grids):
                raise ValueError("grids must be divisible by the model-axis "
                                 "size for sharded synthesis")
        super().__init__(len(self.grids), **params)

    def sample_inputs(self, generator, n):
        n0 = self.grids[0]
        return torch.randn((n, n0, n0), generator=generator,
                           dtype=self.dtype, device=self.device)

    def evaluate_model(self, l, w_hat):
        key = (l, w_hat.dtype, w_hat.device)
        if key not in self._bases:
            g = self.grids[l]
            self._bases[key] = (
                _sine_basis(g, w_hat.dtype, w_hat.device),
                _spectrum(g, self.kappa, self.alpha, w_hat.dtype,
                          w_hat.device))
        return matern2d_outputs(w_hat, self.grids[l], self.kappa,
                                self.alpha, basis=self._bases[key],
                                mesh=self._model_mesh)
