"""The wide tier's two stages in their plain versions, on the CPU.

On the card the wide tier (every shape K1 has no tile for) runs as two
kernels: stage 1 synthesizes the coefficients a = exp(xis @ mck^T), stage
2 solves each sample from them with L(n) = ``lanes_per_sample(n)`` lanes.
Their plain versions, ``synthesize_plain`` and ``solve_plain``, compose
to ``diffusion_outputs_plain`` bit for bit, which is what K1 and the f32
wide tier are held to (``tests/test_torch_diffusion.py`` holds L(n) and
its partition).  The plain version still holds against the JAX package
past K1's reach, the way ``tests/test_torch_deep_grids.py`` holds it: the
max against the JAX model, the median against its np.longdouble solve (same
tolerances, max relative 1e-9 and median 1e-11, both times
max(1, (n/1024)^2), and the median within 1.5x the JAX model's own).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bluest_tpu.models.diffusion import solve_diffusion_outputs as jax_outputs
from bluest_tpu_torch.ops import diffusion as k1
from test_torch_deep_grids import KW, _extended_outputs

torch.set_num_threads(1)

SIGMA, NU = KW["sigma"], KW["nu"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_kl", [(2, 3), (9, 5), (100, 17), (1025, 8),
                                    (1026, 32), (2050, 7), (4097, 3)])
def test_stages_compose_to_plain(n, n_kl, dtype):
    """solve_plain(synthesize_plain(xi)) is diffusion_outputs_plain bit for
    bit, and the stage wrappers take the plain versions on the CPU."""
    xi = torch.as_tensor(np.random.default_rng(n + n_kl).standard_normal(
        (6, n_kl)), dtype=dtype)
    a = k1.synthesize_plain(xi, n, SIGMA, NU)
    assert a.shape == (6, n) and a.dtype == dtype
    assert bool((a > 0).all())
    whole = k1.diffusion_outputs_plain(xi, n, SIGMA, NU)
    assert torch.equal(k1.solve_plain(a, n), whole)
    assert torch.equal(k1.solve(k1.synthesize(xi, n, SIGMA, NU), n), whole)


def test_solve_plain_edge_cases():
    """One cell has no interior unknowns (zeros); no samples, no rows; an
    a of the wrong width or layout is refused by the stage wrapper."""
    a = torch.ones((4, 1), dtype=torch.float64)
    assert torch.equal(k1.solve_plain(a, 1), torch.zeros(4, 3,
                                                         dtype=a.dtype))
    assert k1.solve_plain(torch.ones((0, 5)), 5).shape == (0, 3)
    with pytest.raises(ValueError):
        k1.solve(torch.ones((4, 6)), 5)
    with pytest.raises(ValueError):
        k1.solve(torch.ones((6, 4)).T, 6)


@pytest.mark.parametrize("n", [2048, 4097])
def test_wide_plain_matches_jax(n):
    """The plain version of the wide tier on deep grids with 512 modes,
    f64, against the JAX f64 model (max) and an np.longdouble solve of the
    same system (median, and within 1.5x the JAX model's own median)."""
    xis = np.random.default_rng(n).standard_normal((24, 512))
    ref = np.asarray(jax.jit(jax.vmap(lambda x: jax_outputs(
        x, n, SIGMA, NU)))(jnp.asarray(xis)), np.float64)
    got = k1.diffusion_outputs(torch.as_tensor(xis), n, SIGMA, NU).numpy()
    scale = max(1.0, (n / 1024) ** 2)
    assert (np.abs(got - ref) / np.abs(ref)).max() <= 1e-9 * scale
    ext = np.asarray(_extended_outputs(xis, n), np.float64)
    err = np.abs(got - ext) / np.abs(ext)
    err_jax = np.abs(ref - ext) / np.abs(ext)
    assert err.max() <= 1e-9 * scale
    assert np.median(err) <= 1e-11 * scale
    assert np.median(err) <= 1.5 * np.median(err_jax)
