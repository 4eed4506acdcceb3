"""Multi-fidelity 1D stochastic diffusion: the PDE flagship model family.

Port of ``bluest_tpu/models/diffusion.py``: a lognormal-coefficient
elliptic problem

    -(a(x, xi) u')' = 1  on (0, 1),  u(0) = u(1) = 0,
    log a = sum_k  xi_k * sigma * k^-nu * sqrt(2) sin(k pi x)

solved by finite differences on a hierarchy of grids (fidelity = grid
resolution), with the SAME random coefficients xi shared across
fidelities.  The problem's model path is K1
(``ops/diffusion.py:diffusion_outputs``): the hand-written CUDA kernel
for tensors on the card -- K1 up to 1025 cells, its wide tier on finer
grids or with more modes than K1's tile holds, so every grid runs on the
card -- and their plain PyTorch version for tensors on the CPU.  ``thomas_solve`` / ``solve_diffusion_outputs`` below are the
model-level reference formulation (field, then solve, then QoIs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.diffusion import diffusion_outputs
from ..problem import BLUEProblem


def thomas_solve(lower, diag, upper, rhs):
    """Tridiagonal solve by the Thomas algorithm along the last axis.

    All args (..., n) (lower[..., 0] and upper[..., -1] ignored); leading
    axes are independent systems."""
    n = diag.shape[-1]
    cps, dps = [], []
    cp = torch.zeros_like(diag[..., 0])
    dp = torch.zeros_like(diag[..., 0])
    for i in range(n):
        denom = diag[..., i] - lower[..., i] * cp
        cp = upper[..., i] / denom
        dp = (rhs[..., i] - lower[..., i] * dp) / denom
        cps.append(cp)
        dps.append(dp)
    xs = [None] * n
    x = torch.zeros_like(diag[..., 0])
    for i in range(n - 1, -1, -1):
        x = dps[i] - cps[i] * x
        xs[i] = x
    if n == 0:
        return torch.zeros_like(diag)
    return torch.stack(xs, dim=-1)


def cyclic_reduction_solve(lower, diag, upper, rhs):
    """Tridiagonal solve by cyclic reduction along the last axis:
    log2(n) vectorized levels.  Requires n = 2^p - 1 unknowns; leading
    axes are independent systems.  The JAX package's model-level solver
    for power-of-two grids; the port's model path is K1, which solves by
    its own partitioned scheme, and this stays for users who write
    batched models directly (held to ``thomas_solve``)."""
    a, b, c, d = lower, diag, upper, rhs
    levels = []
    while b.shape[-1] > 1:
        alpha = a[..., 1::2] / b[..., 0:-1:2]
        gamma = c[..., 1::2] / b[..., 2::2]
        levels.append((a, b, c, d))
        a, b, c, d = (-alpha * a[..., 0:-1:2],
                      b[..., 1::2] - alpha * c[..., 0:-1:2]
                      - gamma * a[..., 2::2],
                      -gamma * c[..., 2::2],
                      d[..., 1::2] - alpha * d[..., 0:-1:2]
                      - gamma * d[..., 2::2])
    x = d / b
    for a0, b0, c0, d0 in reversed(levels):
        # x holds the odd-position solutions of this level; solve evens
        zpad = torch.zeros_like(b0[..., :1])
        xodd = torch.cat([zpad, x, zpad], dim=-1)        # x_{i-1}, x_{i+1}
        xe = (d0[..., 0::2] - a0[..., 0::2] * xodd[..., :-1]
              - c0[..., 0::2] * xodd[..., 1:]) / b0[..., 0::2]
        full = torch.empty_like(b0)
        full[..., 0::2] = xe
        full[..., 1::2] = x
        x = full
    return x


def _solve_field(xis, n_cells: int, sigma: float, nu: float):
    """Batched FD solve: (B, n_kl) -> interior u (B, n-1), face
    coefficients a (B, n), h.  Computes in xis' dtype."""
    dt, dev = xis.dtype, xis.device
    n_kl = xis.shape[-1]
    h = 1.0 / n_cells
    xf = (torch.arange(n_cells, dtype=dt, device=dev) + 0.5) * h
    k = torch.arange(1, n_kl + 1, dtype=dt, device=dev)
    ck = torch.as_tensor(sigma * np.arange(1, n_kl + 1) ** (-nu)
                         * np.sqrt(2.0), dtype=dt, device=dev)
    modes = torch.sin(np.pi * xf[:, None] * k[None, :])
    a = torch.exp((ck * xis) @ modes.T)                     # (B, n)
    am, ap = a[:, :-1], a[:, 1:]
    inv_h2 = 1.0 / h ** 2
    diag = (am + ap) * inv_h2
    zero = torch.zeros_like(a[:, :1])
    lower = torch.cat([zero, -am[:, 1:] * inv_h2], dim=1)
    upper = torch.cat([-ap[:, :-1] * inv_h2, zero], dim=1)
    u = thomas_solve(lower, diag, upper, torch.ones_like(diag))
    return u, a, h


def solve_diffusion_outputs(xis, n_cells: int, sigma: float = 1.0,
                            nu: float = 1.5):
    """Three QoIs per sample, (B, n_kl) -> (B, 3): integral of u, u(1/2)
    and the energy integral of a u'^2."""
    u, a, h = _solve_field(xis, n_cells, sigma, nu)
    zero = torch.zeros_like(a[:, :1])
    uu = torch.cat([zero, u, zero], dim=1)
    q_int = h * u.sum(dim=1)
    q_mid = uu[:, n_cells // 2]
    du = torch.diff(uu, dim=1) / h
    q_energy = h * (a * du * du).sum(dim=1)
    return torch.stack([q_int, q_mid, q_energy], dim=1)


# the JAX package keeps a second, natively batched entry point; here
# every model function is batched
solve_diffusion_outputs_batched = solve_diffusion_outputs


def solve_diffusion(xis, n_cells: int, sigma: float = 1.0, nu: float = 1.5):
    """Integral of u per sample, (B, n_kl) -> (B,)."""
    u, _a, h = _solve_field(xis, n_cells, sigma, nu)
    return h * u.sum(dim=1)


class DiffusionProblem(BLUEProblem):
    """Fidelity hierarchy over grid resolutions.

    Parameters: ``grids`` (cells per fidelity, finest first), ``n_kl``
    Karhunen-Loeve-style modes, field amplitude ``sigma`` and decay ``nu``,
    the model ``dtype`` (``None`` = float64; ``torch.float32`` for the fast
    path) and the sampling ``device`` (a ``BLUEProblem`` parameter: the
    card by default, ``device="cpu"`` for the host).  Costs default to
    the FD solve's O(n) work.
    """

    def __init__(self, grids=(256, 128, 64, 32, 16), n_kl: int = 16,
                 sigma: float = 0.5, nu: float = 1.5,
                 multi_output: bool = False, truncate_kl: bool = True,
                 dtype=None, **params):
        self.grids = tuple(int(g) for g in grids)
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError("dtype must be torch.float32 or torch.float64")
        self.n_kl = n_kl
        self.sigma = sigma
        self.nu = nu
        self.multi_output = multi_output
        # coarse fidelities resolve only the field modes their grid can
        # represent (fidelity = grid AND input dimension truncation)
        if truncate_kl:
            self.n_modes = tuple(min(self.n_kl, max(1, g // 4))
                                 for g in self.grids)
        else:
            self.n_modes = tuple(self.n_kl for _ in self.grids)
        self._masks = {}
        params.setdefault("costs", np.array([g / grids[-1]
                                             for g in self.grids]))
        if multi_output:
            params.setdefault("n_outputs", 3)
        super().__init__(len(self.grids), **params)

    def sample_inputs(self, generator, n):
        """n shared KL coefficient vectors, (n, n_kl) in the model dtype."""
        return torch.randn((n, self.n_kl), generator=generator,
                           dtype=self.dtype, device=self.device)

    def evaluate_model(self, l, xis):
        """Model l on a batch: the xi mask, then K1 or its wide tier (the
        kernel that ``ops.diffusion.tier`` names); (n, No)."""
        key = (l, xis.device)
        if key not in self._masks:
            self._masks[key] = (torch.arange(self.n_kl, device=xis.device)
                                < self.n_modes[l]).to(xis.dtype)
        out = diffusion_outputs(xis * self._masks[key], self.grids[l],
                                self.sigma, self.nu)
        return out if self.multi_output else out[:, :1]
