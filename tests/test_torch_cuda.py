"""K1 on the card: the compiled kernel against its plain version.

These tests need a CUDA card and nvcc; without a card they skip.  They
import neither jax nor the JAX package, so they also run on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from bluest_tpu_torch.ops import diffusion as k1

torch.set_num_threads(1)

SIGMA, NU = 1.0, 0.6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is compiled with nvcc for sm_90a")
    return torch.device("cuda")


def _rel(got, ref):
    return np.abs(got - ref) / (np.abs(ref) + 1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 33, 64, 100, 512, 1024])
@pytest.mark.parametrize("B", [1, 77, 8192])
def test_kernel_matches_plain(cuda, n, B, dtype):
    """Same operations in the same order: bit-equal to the plain version
    in the same dtype; f32 also within the f32 class of the f64 plain."""
    xi = torch.as_tensor(np.random.default_rng(n + B).standard_normal(
        (B, 32)), dtype=dtype, device=cuda)
    before = k1.diffusion_outputs.launches
    got = k1.diffusion_outputs(xi, n, SIGMA, NU)
    torch.cuda.synchronize()
    assert k1.diffusion_outputs.launches == before + 1
    assert got.shape == (B, 3) and got.dtype == dtype
    plain = k1.diffusion_outputs_plain(xi, n, SIGMA, NU)
    assert torch.equal(got, plain)
    if dtype == torch.float32:
        ref = k1.diffusion_outputs_plain(xi.double(), n, SIGMA,
                                         NU).cpu().numpy()
        err = _rel(got.double().cpu().numpy(), ref)
        inc = _rel(plain.double().cpu().numpy(), ref)
        assert np.median(err) <= 10 * np.median(inc) + 1e-6
        assert err.max() <= 10 * inc.max() + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_long_lanes(cuda, dtype):
    """At the largest n the kernel takes, 1025, every lane owns 32 rows:
    still bit-equal to the plain version, ragged tile included."""
    n = k1.build_library().bluest_diffusion_max_cells()
    assert n == 1025
    xi = torch.as_tensor(np.random.default_rng(n).standard_normal((77, 32)),
                         dtype=dtype, device=cuda)
    got = k1.diffusion_outputs(xi, n, SIGMA, NU)
    torch.cuda.synchronize()
    assert torch.equal(got, k1.diffusion_outputs_plain(xi, n, SIGMA, NU))
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1026, 4097])
def test_kernel_refuses_past_max_cells(cuda, n, dtype):
    """Past 1025 cells a lane would own more than 32 rows: the launcher
    refuses the shape and the wrapper raises, naming the limit."""
    xi = torch.zeros((77, 32), dtype=dtype, device=cuda)
    before = k1.diffusion_outputs.launches
    with pytest.raises(ValueError, match="n_cells <= 1025"):
        k1.diffusion_outputs(xi, n, SIGMA, NU)
    assert k1.diffusion_outputs.launches == before


@pytest.mark.gpu
def test_kernel_allocates_no_workspace(cuda):
    """Once the library is built and the mode matrix cached, one launch at
    the flagship shape allocates only its (B, 3) output: under 8 MB."""
    xi = torch.randn((8192, 32), device=cuda)
    k1.diffusion_outputs(xi, 1024, SIGMA, NU)           # build, cache mck
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    out = k1.diffusion_outputs(xi, 1024, SIGMA, NU)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base < 8 << 20
    assert out.shape == (8192, 3)


@pytest.mark.gpu
def test_wrapper_checks_on_card(cuda):
    with pytest.raises(ValueError):
        k1.diffusion_outputs(torch.zeros(32, 8, device=cuda).T, 8)
    with pytest.raises(TypeError):
        k1.diffusion_outputs(torch.zeros(8, 4, dtype=torch.float16,
                                         device=cuda), 8)
    empty = k1.diffusion_outputs(torch.zeros(0, 4, device=cuda), 8)
    assert empty.shape == (0, 3)
    with pytest.raises(ValueError):     # a and xi overflow shared memory
        k1.diffusion_outputs(torch.zeros(4, 4000, dtype=torch.float64,
                                         device=cuda), 1024)


@pytest.mark.gpu
def test_problem_model_path_uses_kernel(cuda):
    """DiffusionProblem on device="cuda" evaluates through K1."""
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    p = DiffusionProblem(grids=(64, 16, 4), n_kl=8, sigma=SIGMA, nu=NU,
                         multi_output=True, verbose=False,
                         C=[np.eye(3)] * 3, device="cuda",
                         dtype=torch.float32)
    xi = p.sample_inputs(torch.Generator(device=cuda).manual_seed(0), 100)
    before = k1.diffusion_outputs.launches
    out = p.evaluate_model(1, xi)
    torch.cuda.synchronize()
    assert k1.diffusion_outputs.launches == before + 1
    assert out.shape == (100, 3) and out.is_cuda
