"""The port on the card: K1 and its wide tier against their plain
version, K2 (the Hodgkin-Huxley kernel) against its plain version, the
user models' card outputs against their CPU outputs, the group engine's
resample and its K2 launches per round, the snapshot-collecting path
through K1, the allocation on the card against the host (the seeded
cone programs of the allocation and warm-cache tests, the flagship-width
MOSAP, the integer projection from one continuous point, and the IPM's
iterations under the synchronisation debug mode), K3 and K4 (the IPM's
Jacobi eigenvalue and SVD kernels) against torch.linalg, the IPM's
graph loop against its eager card loop, and the span recorder's
host-sync spans against the synchronisation debug mode and the
profiler's device-to-host copies, and K6 (the sampling combiner) against
its plain version and its CPU mirror, its running sums, its launch count
and a group engine chunk's device items; the group engine's dispatch
sequence against a one-by-one loop, and its count read on a card that
is not the current one (two cards).

These tests need a CUDA card and nvcc; without a card they skip.  They
import neither jax nor the JAX package, so they also run on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import math
import re

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


def _holds(xi, n, got, wide):
    """K1, and the wide tier in f32: bit-equal to the plain version.  The
    wide tier in f64 takes its mode sums on the tensor cores in their own
    order, so it is held by its stages, as chip_smoke.py phase 3 holds it:
    stage 1 within the bound of a sum in any order, stage 2 bit-equal to
    solve_plain on stage 1's a, the call equal to the two stages."""
    if wide and xi.dtype == torch.float64:
        from chip_smoke import wide_stages_hold
        wide_stages_hold(xi, n, got)
    else:
        assert torch.equal(got, k1.diffusion_outputs_plain(xi, n, SIGMA, NU))


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
    """Past 1025 cells, where K1 has no tile, the wrapper launches the
    wide tier instead of refusing the shape: the launch succeeds, is
    counted (in all and for the wide tier) and holds against the plain
    version (bit-equal in f32, by its stages in f64)."""
    xi = torch.as_tensor(np.random.default_rng(n).standard_normal((77, 32)),
                         dtype=dtype, device=cuda)
    assert k1.tier(n, 32, dtype) == "wide"
    before = k1.diffusion_outputs.launches
    wide = k1.diffusion_outputs.launches_by_tier["wide"]
    got = k1.diffusion_outputs(xi, n, SIGMA, NU)
    torch.cuda.synchronize()
    assert k1.diffusion_outputs.launches == before + 1
    assert k1.diffusion_outputs.launches_by_tier["wide"] == wide + 1
    assert got.shape == (77, 3) and got.dtype == dtype
    _holds(xi, n, got, wide=True)
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_kl", [(1024, 3000), (100, 3700), (2048, 1024),
                                    (3, 5000)])
@pytest.mark.parametrize("B", [1, 77, 1500])
def test_wide_tier_matches_plain(cuda, n, n_kl, B, dtype):
    """The wide tier on the shapes K1 refuses for their n_kl (n=1024, 100
    and 3) and on a deep grid with many modes: bit-equal to the plain
    version in f32 and held by its stages in f64, one wide launch each."""
    xi = torch.as_tensor(np.random.default_rng(n + n_kl + B).standard_normal(
        (B, n_kl)), dtype=dtype, device=cuda)
    assert k1.tier(n, n_kl, dtype) == "wide"
    wide = k1.diffusion_outputs.launches_by_tier["wide"]
    got = k1.diffusion_outputs(xi, n, SIGMA, NU)
    torch.cuda.synchronize()
    assert k1.diffusion_outputs.launches_by_tier["wide"] == wide + 1
    _holds(xi, n, got, wide=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_kl", [(8, 32), (1024, 32), (1024, 1024)])
def test_wide_tier_takes_k1_shapes(cuda, n, n_kl, dtype):
    """launch() runs either tier by name: at a shape that tier() gives
    K1, K1's result equals the plain version's, the wide tier's does in
    f32 and holds by its stages in f64, and each launch is counted for its
    own tier; K1 named past its reach raises."""
    xi = torch.as_tensor(np.random.default_rng(n + n_kl).standard_normal(
        (77, n_kl)), dtype=dtype, device=cuda)
    assert k1.tier(n, n_kl, dtype) == "k1"
    before = dict(k1.diffusion_outputs.launches_by_tier)
    got_k1 = k1.launch("k1", xi, n, SIGMA, NU)
    got_wide = k1.launch("wide", xi, n, SIGMA, NU)
    torch.cuda.synchronize()
    after = k1.diffusion_outputs.launches_by_tier
    assert after == {"k1": before["k1"] + 1, "wide": before["wide"] + 1}
    _holds(xi, n, got_k1, wide=False)
    _holds(xi, n, got_wide, wide=True)
    with pytest.raises(RuntimeError, match="refused"):
        k1.launch("k1", xi, 2048, SIGMA, NU)


@pytest.mark.gpu
def test_tier_predicate_matches_library(cuda):
    """tier(), which the CPU path also takes, names K1 exactly where the
    library's own test of K1's tile says it fits."""
    lib = k1.build_library()
    for dtype, itemsize in ((torch.float32, 4), (torch.float64, 8)):
        for n in (1, 2, 33, 1000, 1024, 1025, 1026, 2048, 4097):
            for n_kl in (1, 32, 1024, 2577, 2578, 3000, 4000):
                fits = bool(lib.bluest_diffusion_k1_fits(itemsize, n_kl, n))
                assert (k1.tier(n, n_kl, dtype) == "k1") == fits


@pytest.mark.gpu
def test_deep_grid_problem_runs_both_tiers(cuda):
    """DiffusionProblem on a deep hierarchy, f64, 1024 modes, on the card:
    the grids past 1025 cells go through the wide tier, the rest through
    K1, one launch each, and every model's outputs hold against the plain
    version on the same masked inputs (K1 bit-equal; the wide tier in f64
    by its stages)."""
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    grids = (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8)
    p = DiffusionProblem(grids=grids, n_kl=1024, sigma=SIGMA, nu=NU,
                         multi_output=True, verbose=False,
                         C=[np.eye(len(grids)) + 0.5] * 3, device="cuda",
                         dtype=torch.float64)
    xi = p.sample_inputs(torch.Generator(device=cuda).manual_seed(0), 300)
    for l, n in enumerate(grids):
        want = "wide" if n > 1025 else "k1"
        before = dict(k1.diffusion_outputs.launches_by_tier)
        out = p.evaluate_model(l, xi)
        torch.cuda.synchronize()
        after = k1.diffusion_outputs.launches_by_tier
        assert after[want] == before[want] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        mask = (torch.arange(1024, device=cuda) < p.n_modes[l]).double()
        _holds(xi * mask, n, out, wide=want == "wide")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 77])
def test_wide_tier_past_register_rows(cuda, B, dtype):
    """At n=40000 a sample's 1024 lanes own 40 rows each, past the 32 a
    lane keeps in registers: the rows go to the row store beside the
    slab's coefficients, and the result still holds."""
    n = 40000
    xi = torch.as_tensor(np.random.default_rng(B).standard_normal((B, 32)),
                         dtype=dtype, device=cuda)
    assert k1.lanes_per_sample(n) == 1024
    lib = k1.build_library()
    assert lib.bluest_diffusion_wide_store(n) == 3 * 39 * 1024
    got = k1.diffusion_outputs(xi, n, SIGMA, NU)
    torch.cuda.synchronize()
    assert got.shape == (B, 3) and bool(torch.isfinite(got).all())
    _holds(xi, n, got, wide=True)


@pytest.mark.gpu
def test_wide_lanes_match_library(cuda):
    """L(n) of the plain version is the kernels' (wide_lanes), and the row
    store is used exactly past 256 lanes (n > 8193)."""
    lib = k1.build_library()
    for n in (1, 2, 3, 33, 1025, 1026, 2049, 2050, 4096, 8193, 8194, 16385,
              16386, 32769, 40000, 100000):
        L = k1.lanes_per_sample(n)
        assert lib.bluest_diffusion_wide_lanes(n) == L
        assert (lib.bluest_diffusion_wide_store(n) > 0) == (L > 256)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_buffer_within_slab(cuda, dtype):
    """The wide tier's buffer holds one slab's coefficients, ~32 MB, not a
    store per sample: at n=4096, B=8192 it is 32 MiB in both dtypes, and
    the call allocates little else beside its output."""
    n, B = 4096, 8192
    xi = torch.as_tensor(np.random.default_rng(0).standard_normal((B, 64)),
                         dtype=dtype, device=cuda)
    k1.diffusion_outputs(xi, n, SIGMA, NU)              # build, cache mck
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    out = k1.diffusion_outputs(xi, n, SIGMA, NU)
    torch.cuda.synchronize()
    assert k1.diffusion_outputs.workspace_bytes == 32 << 20
    assert (torch.cuda.max_memory_allocated(cuda) - base
            <= (32 << 20) + (2 << 20))
    assert out.shape == (B, 3)


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
    # K1's tile of a and xi would overflow shared memory: the wide tier
    # takes the shape instead of a refusal
    xi = torch.zeros(4, 4000, dtype=torch.float64, device=cuda)
    got = k1.diffusion_outputs(xi, 1024)
    torch.cuda.synchronize()
    assert torch.equal(got, k1.diffusion_outputs_plain(xi, 1024))


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


def _normwise(got, ref):
    """max |got - ref| over the rows, over max |ref|, worst output."""
    return float(((got - ref).abs().amax(dim=0)
                  / ref.abs().amax(dim=0).clamp_min(1e-300)).max())


@pytest.mark.gpu
def test_matern2d_card_matches_cpu(cuda):
    """The same white noise gives the same QoIs on the card and on the
    CPU, <= 1e-12 relative in f64, at the default grids."""
    from bluest_tpu_torch.models.matern2d import Matern2DProblem
    p = Matern2DProblem(C=[np.eye(4) + 0.5] * 3, verbose=False, device=cuda)
    w = p.sample_inputs(torch.Generator(device=cuda).manual_seed(0), 64)
    assert w.shape == (64, 64, 64) and w.dtype == torch.float64
    for l in range(p.M):
        got = p.evaluate_model(l, w)
        assert got.is_cuda and got.shape == (64, 3)
        assert _normwise(got.cpu(), p.evaluate_model(l, w.cpu())) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dt", [(0, 0.08), (1, 0.08), (2, 0.08),
                                     (0, 0.01)])
def test_hodgkin_huxley_card_matches_cpu(cuda, kind, dt):
    """The same parameters give the same outputs on the card and on the
    CPU, <= 1e-8 relative (the CPU parity tests' tolerance against JAX),
    with the same rows non-finite."""
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    p = hh.HodgkinHuxleyProblem(C=[np.eye(12) + 0.5] * 5, verbose=False,
                                device=cuda)
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    x = p.sample_group(torch.Generator(device=cuda).manual_seed(kind), (0,),
                       64)
    before = k2.hh_group_outputs.launches
    got = hh.hh_outputs(kind, dt, x).cpu()
    assert k2.hh_group_outputs.launches == before + 1      # through K2
    ref = hh.hh_outputs(kind, dt, x.cpu())
    fin = torch.isfinite(ref).all(dim=1)
    assert torch.equal(torch.isfinite(got).all(dim=1), fin)
    assert int(fin.sum()) > 0
    assert _normwise(got[fin], ref[fin]) <= 1e-8


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 77, 16384])
def test_k2_matches_plain(cuda, n):
    """K2 against its plain version on the card, on the same parameters:
    each default model alone and the 12-model group, one launch each; the
    same (row, model) pairs non-finite and each model's normwise
    difference <= 1e-10 on the rest (chip_smoke.k2_holds: the kernel
    repeats the plain version's operations in its order)."""
    from chip_smoke import hh_params, k2_holds
    from bluest_tpu_torch.models.hodgkin_huxley import DEFAULT_MODELS
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    x = hh_params(n, n)
    ref = k2.hh_group_outputs_plain(DEFAULT_MODELS, x)
    for l, m in enumerate(DEFAULT_MODELS):
        k2_holds(k2.hh_group_outputs((m,), x), ref[:, :, l:l + 1],
                 "model %d" % l)
    before = k2.hh_group_outputs.launches
    got = k2.hh_group_outputs(DEFAULT_MODELS, x)
    torch.cuda.synchronize()
    assert k2.hh_group_outputs.launches == before + 1
    assert got.is_cuda and got.shape == (n, 5, 12)
    k2_holds(got, ref, "group")


@pytest.mark.gpu
def test_k2_more_models_than_one_table(cuda):
    """40 models take two launches (32 + 8), each column its model."""
    from chip_smoke import hh_params, k2_holds
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    x = hh_params(77, 5)
    pair = ((2, 0.08), (1, 0.08))
    ref = k2.hh_group_outputs_plain(pair, x)
    before = k2.hh_group_outputs.launches
    got = k2.hh_group_outputs(pair * 20, x)
    torch.cuda.synchronize()
    assert k2.hh_group_outputs.launches == before + 2
    k2_holds(got, ref.repeat(1, 1, 20), "40 models")


@pytest.mark.gpu
def test_k2_refuses_on_the_card(cuda):
    """A CUDA tensor K2 does not take raises; nothing falls back."""
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    x = torch.zeros((4, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        k2.hh_group_outputs(((0, 0.08),), x.float())
    with pytest.raises(ValueError):
        k2.hh_group_outputs(((0, 0.08),), x.t().contiguous().t())
    n = 2 ** 31 // (5 * 32) + 1                  # n * 5 * L past an int
    big = torch.empty((n, 3), dtype=torch.float64, device=cuda)
    before = k2.hh_group_outputs.launches
    with pytest.raises(ValueError, match="int index"):
        k2.hh_group_outputs(((2, 0.08),) * 32, big)
    assert k2.hh_group_outputs.launches == before


_K2_PLAIN = {}


def _k2_plain_ref(n):
    """The plain version's outputs of the 12 default models at n (one
    call, kept for the variant tests)."""
    from chip_smoke import hh_params
    from bluest_tpu_torch.models.hodgkin_huxley import DEFAULT_MODELS
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    if n not in _K2_PLAIN:
        x = hh_params(n, 1000 + n)
        _K2_PLAIN[n] = x, k2.hh_group_outputs_plain(DEFAULT_MODELS, x)
    return _K2_PLAIN[n]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 77, 256, 16384])
@pytest.mark.parametrize("variant", ["thread", "lanes8"])
def test_k2_variant_matches_plain(cuda, variant, n):
    """Each variant forced on each default model alone and on the
    12-model group: bit-equal to the plain version (k2_holds), each launch
    counted once, in its variant."""
    from chip_smoke import k2_holds
    from bluest_tpu_torch.models.hodgkin_huxley import DEFAULT_MODELS
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    x, ref = _k2_plain_ref(n)
    by_variant = k2.hh_group_outputs.launches_by_variant
    cases = [((m,), [l]) for l, m in enumerate(DEFAULT_MODELS)]
    cases.append((DEFAULT_MODELS, list(range(12))))
    for models, cols in cases:
        before = (k2.hh_group_outputs.launches, by_variant[variant])
        got = k2.hh_group_outputs(models, x, variant=variant)
        torch.cuda.synchronize()
        assert (k2.hh_group_outputs.launches, by_variant[variant]) == (
            before[0] + 1, before[1] + 1)
        k2_holds(got, ref[:, :, cols], "%s, models %s" % (variant, cols))


@pytest.mark.gpu
def test_k2_refuses_a_variant_it_does_not_take(cuda):
    """A variant name outside VARIANTS raises before any launch, and the C
    entry point refuses a lane count it has no kernel for."""
    import ctypes
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    x = torch.zeros((4, 3), dtype=torch.float64, device=cuda)
    before = k2.hh_group_outputs.launches
    for bad in ("lanes2", "lanes4", "lanes16", "warp", ""):
        with pytest.raises(ValueError, match="variant"):
            k2.hh_group_outputs(((0, 0.08),), x, variant=bad)
    assert k2.hh_group_outputs.launches == before
    lib = k2.build_library()
    out = torch.empty((4, 5, 1), dtype=torch.float64, device=cuda)
    ints = (ctypes.c_int * 3)(0, 125, 0)
    reals = (ctypes.c_double * 4)(0.08, 0.04, 0.08 / 6.0, 1.0 / 125)
    for lanes in (0, 2, 3, 4, 16, 32):
        assert lib.bluest_hh_outputs_f64(
            x.data_ptr(), out.data_ptr(), 4, 1, 1, ints, reals, lanes,
            torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.gpu
def test_group_engine_launches_k2_once_per_round(cuda):
    """A group-engine draw of HH models on the card launches K2 once per
    round: the first evaluation and each redraw (Euler at dt 0.08 fails
    on most draws, so the draw takes several rounds)."""
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    from bluest_tpu_torch.ops import hodgkin_huxley as k2
    from bluest_tpu_torch.sampling.group_engine import GroupEngine
    p = hh.HodgkinHuxleyProblem(C=[np.eye(12) + 0.5] * 5, verbose=False,
                                device=cuda)
    rounds = []

    def evaluate(ls, x):
        rounds.append(x.shape[0])
        return p.evaluate_group(ls, x)

    eng = GroupEngine(p.sample_group, evaluate, 5, 4096, cuda)
    before = k2.hh_group_outputs.launches
    _, outs, ok = eng.draw(torch.Generator(device=cuda).manual_seed(3),
                           (0, 7, 11), 4096)
    torch.cuda.synchronize()
    assert len(rounds) >= 2
    assert k2.hh_group_outputs.launches - before == len(rounds)
    assert bool(ok.all()) and bool(torch.isfinite(outs).all())


@pytest.mark.gpu
def test_group_engine_resample_on_card(cuda):
    """The per-row resample on the card: the first draw's finite rows are
    kept bit for bit, every row ends finite, and the sums are the
    combiner's on the collected rows."""
    from bluest_tpu_torch.sampling.engine import (combine, finite_rows,
                                                  generator_seed)
    from bluest_tpu_torch.sampling.group_engine import GroupEngine

    def sample_group(gen, ls, n):
        return torch.randn(n, generator=gen, dtype=torch.float64,
                           device=cuda)

    def evaluate_group(ls, z):
        out = torch.stack([torch.exp(z) / (1.0 + l) for l in ls],
                          dim=1)[:, None]
        return torch.where(z[:, None, None] > 1.0, torch.nan, out)

    eng = GroupEngine(sample_group, evaluate_group, 1, 4096, cuda)
    ls = (0, 1, 2)
    sums, vals, z, ok = eng.collect(ls, 5, 0, 10000)
    assert bool(ok.all()) and int(sums.n_failed) == 0
    assert vals.is_cuda and bool(finite_rows(vals).all())
    assert bool((z[:, 0] <= 1.0).all())
    z0 = sample_group(torch.Generator(device=cuda).manual_seed(
        generator_seed(5, 0, 0)), ls, 4096)
    good = z0 <= 1.0
    assert 0 < int((~good).sum()) < 4096
    assert torch.equal(z[:4096, 0][good], z0[good])
    for g, r in zip(sums, combine(vals.movedim(2, 0), 0, 10000)):
        assert torch.allclose(g, r, rtol=1e-12, atol=0)


@pytest.mark.gpu
def test_factored_collect_through_kernel(cuda, tmp_path):
    """DiffusionProblem with a samplefile on the card: the collect path
    launches K1, the snapshot rows equal the samples the sums cover, and
    K1 on the stored inputs gives the stored outputs bit for bit."""
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    p = DiffusionProblem(grids=(64, 16, 4), n_kl=8, sigma=SIGMA, nu=NU,
                         multi_output=True, verbose=False,
                         C=[np.eye(3) + 0.5] * 3, device=cuda,
                         dtype=torch.float32, device_batch_size=100,
                         samplefile=str(tmp_path / "d.npz"),
                         outputs_to_save=[0, 2])
    before = k1.diffusion_outputs.launches
    se = p.blue_fn([0, 2], 250)[0]
    torch.cuda.synchronize()
    assert k1.diffusion_outputs.launches - before >= 2 * 3
    with np.load(str(tmp_path / "d02.npz")) as d:
        assert int(d["n_samples"][0]) == 250
        xi = d["inputs_0"]
        vals = {k: d[k] for k in d.files if k.startswith("values_")}
    assert xi.shape == (250, 8) and xi.dtype == np.float32
    assert sorted(vals) == ["values_0_0", "values_0_1", "values_2_0",
                            "values_2_1"]
    x = torch.as_tensor(xi[:17], device=cuda)
    for i, l in enumerate((0, 2)):
        out = p.evaluate_model(l, x).cpu().numpy()
        np.testing.assert_array_equal(out[:, 0], vals["values_0_%d" % i][:17])
        np.testing.assert_array_equal(out[:, 2], vals["values_2_%d" % i][:17])
        assert se[0][i] == pytest.approx(
            float(vals["values_0_%d" % i].astype(np.float64).sum()),
            rel=1e-9)


# --------------------- the allocation on the card ------------------------ #
# The seeded programs of tests/test_torch_allocation.py and
# tests/test_torch_warm.py, built here from the port alone (those files
# import jax).

def _alloc_programs():
    from itertools import combinations
    from bluest_tpu_torch.allocation import cones
    from bluest_tpu_torch.core import GroupStructure, psi as psimod

    def group_psi(M, K, C):
        groups = [[list(c) for c in combinations(range(M), k)]
                  for k in range(1, K + 1)]
        gs = GroupStructure(M, groups, C=C)
        return gs, psimod.GroupData.build(gs, device="cpu").psi.numpy()

    def mlblue(seed, form):
        rng = np.random.default_rng(seed)
        M, K = 4 + seed % 3, 2 + seed % 2
        A = rng.standard_normal((M, M))
        gs, psi = group_psi(M, K, A @ A.T + 0.5 * M * np.eye(M))
        w = gs.group_costs(np.sort(rng.uniform(0.1, 1, M))[::-1]
                           * np.arange(M, 0, -1))
        mp = [np.arange(gs.L)]
        if form == "budget":
            return cones.build_budget_sdp([psi], mp, gs.L, w, [gs.e],
                                          1e3)[:5]
        return cones.build_eps_sdp([psi], mp, gs.L, w, [gs.e],
                                   np.array([0.05]), 1.0)[:5]

    def covering(seed):
        rng = np.random.default_rng(seed)
        nx, n, nb = 6 + 3 * seed, 3 + seed % 3, 1 + seed % 2
        v = rng.standard_normal((nb, nx, n))
        return (rng.random(nx) + 0.1, -np.eye(nx), np.zeros(nx),
                -v[..., None] * v[..., None, :],
                -np.tile(np.eye(n), (nb, 1, 1)))

    def lmi(seed, L=40, No=2, n=4):
        rng = np.random.default_rng(seed)
        c = rng.random(L) + 0.5
        Gl = np.vstack([-np.eye(L), -rng.random((No, L))])
        hl = np.concatenate([np.zeros(L), -np.ones(No)])
        v = rng.standard_normal((No, L, n))
        return (c, Gl, hl, -v[..., None] * v[..., None, :],
                np.tile(np.eye(n), (No, 1, 1)) * 5.0)

    def mlblue_eps(seed, M=5, K=3):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((M, M))
        C = A @ A.T + M * np.eye(M)
        gs, psi = group_psi(M, K, C)
        return cones.build_eps_sdp(
            [psi], [np.arange(gs.L)], gs.L, np.geomspace(4.0, 1.0, gs.L),
            [gs.e], np.array([np.sqrt(C[0, 0]) * 0.05]), 1.0)[:5]

    progs = {
        "lp": lambda: (np.array([-1.0, -2.0]),
                       np.vstack([np.eye(2), -np.eye(2)]),
                       np.array([1.0, 1.0, 0.0, 0.0]), None, None),
        "min-eig": lambda: (np.array([1.0]), None, None,
                            np.array([[[[-1.0, 0.0], [0.0, -1.0]]]]),
                            np.array([[[0.0, 1.0], [1.0, 0.0]]])),
        "lmi-7": lambda: lmi(7),
        "lmi-21": lambda: lmi(21, L=60, No=3),
        "mlblue-eps": lambda: mlblue_eps(1234)}
    for seed in (2, 3):
        progs["covering-%d" % seed] = lambda s=seed: covering(s)
    for form in ("budget", "eps"):
        for seed in (0, 1, 3):
            progs["%s-%d" % (form, seed)] = lambda s=seed, f=form: mlblue(s, f)
    return progs


ALLOC_PROGRAMS = ("lp", "min-eig", "covering-2", "covering-3", "budget-0",
                  "budget-1", "budget-3", "eps-0", "eps-1", "eps-3", "lmi-7",
                  "lmi-21", "mlblue-eps")


@pytest.fixture
def cold_ipm(monkeypatch):
    from bluest_tpu_torch.solvers import sdp
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM", "0")
    monkeypatch.delenv("BLUEST_TPU_ALLOC_DEVICE", raising=False)
    sdp._WARM_CACHE.clear()
    return sdp


@pytest.mark.gpu
@pytest.mark.parametrize("case", ALLOC_PROGRAMS)
def test_cone_program_card_matches_host(cuda, cold_ipm, case):
    """The same cone program solved on the card and on the host: pobj
    within 1e-7 relative, an OK status, and the same status and
    iterations within 1 as far as the host agrees with itself.  Near the
    f64 floor round-off decides both (on the host alone, 1e-15 relative
    perturbations of c flip eps-3 between "inaccurate" in 21 iterations
    and "optimal" in 17, and move mlblue-eps between 24 and 26), so the
    host also solves five such perturbations of the program, and the
    card must land among the host's statuses and within 1 of its
    iteration range; where the host is stable this is the same status
    and iterations within 1."""
    from bluest_tpu_torch.config import allocation_device_scope
    prog = _alloc_programs()[case]()
    with allocation_device_scope("cuda"):
        rc = cold_ipm.solve_cone_lp(*prog)
    host = []
    with allocation_device_scope("cpu"):
        for k in range(6):
            c = np.asarray(prog[0], float)
            if k:
                c = c * (1 + 1e-15 * np.random.default_rng(k).standard_normal(
                    c.shape))
            host.append(cold_ipm.solve_cone_lp(c, *prog[1:]))
    rh = host[0]
    assert rc.status in ("optimal", "inaccurate")
    assert abs(rc.pobj - rh.pobj) <= 1e-7 * max(1.0, abs(rh.pobj))
    assert rc.status in {r.status for r in host}
    its = [r.iterations for r in host]
    assert min(its) - 1 <= rc.iterations <= max(its) + 1


def _flagship_width(device, seed=2):
    """The flagship-width problem of the allocation tests (M=10, three
    outputs, seeded covariances, the bench's grid costs), on ``device``;
    seed 2 is the allocation tests' own."""
    from bluest_tpu_torch import BLUEProblem
    grids = (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2)
    rng = np.random.default_rng(seed)
    M = len(grids)
    Cs = []
    for _ in range(3):
        A = rng.standard_normal((M, M)) * 0.05
        base = 0.97 ** np.abs(np.subtract.outer(np.arange(M), np.arange(M)))
        s = np.exp(rng.standard_normal(M) * 0.3)
        Cs.append(base * np.outer(s, s) + A @ A.T)
    return BLUEProblem(M, C=Cs, costs=np.array([g / 2.0 for g in grids]),
                       n_outputs=3, verbose=False, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["budget", "eps"])
def test_flagship_mosap_card_matches_host(cuda, cold_ipm, mode):
    """The flagship-width MOSAP (L=385) allocated on the card and on the
    host, at chip_smoke.py phase 11's tolerances: the same status for
    every cone solve, continuous cost within 1e-6 relative, max-variance
    within 1e-3 relative, the budget or the tolerance met."""
    how = {"budget": dict(K=4, budget=2.0e5), "eps": dict(K=4, eps=1e-3)}
    runs = {}
    for device in ("cuda", "cpu"):
        p = _flagship_width(device)
        p.setup_solver(**how[mode])
        assert p.MOSAP.device.type == device and p.MOSAP.L == 385
        runs[device] = p
    c, h = runs["cuda"], runs["cpu"]
    statuses = [[x["status"] for x in p.MOSAP.certificates] for p in (c, h)]
    print("statuses card %s, host %s" % tuple(statuses))
    assert statuses[0] == statuses[1]
    assert {"optimal", "inaccurate"} & set(statuses[0])
    cc = c.MOSAP.continuous_solution @ c.MOSAP.costs
    ch = h.MOSAP.continuous_solution @ h.MOSAP.costs
    assert abs(cc - ch) <= 1e-6 * ch
    vc = max(c.MOSAP_output["variances"])
    vh = max(h.MOSAP_output["variances"])
    assert abs(vc - vh) <= 1e-3 * vh
    for p in (c, h):
        if mode == "budget":
            assert p.MOSAP_output["cost"] <= 1.0001 * 2.0e5
        else:
            assert max(p.MOSAP_output["variances"]) <= 1.0001 * 1e-6


@pytest.mark.gpu
def test_integer_projection_card_matches_host(cuda, cold_ipm):
    """From one shared continuous point (the host's, after its cleanup
    walk), the integer projection on the card gives the host's samples,
    or, where cuSOLVER's rounding moves a corner, variances within 1e-8
    relative (the difference is printed)."""
    from bluest_tpu_torch.config import allocation_device_scope
    h = _flagship_width("cpu")
    h.setup_solver(K=4, budget=2.0e5, continuous_relaxation=True)
    m0 = h.MOSAP.continuous_solution.copy()
    sparse = h.MOSAP.cleanup_solution(m0.copy(), tol=1e-7 * m0.max())
    c = _flagship_width("cuda")
    c.prewarm_solver(K=4)
    assert c.MOSAP.device.type == "cuda"
    with allocation_device_scope("cuda"):
        ic = c.MOSAP.integer_projection(sparse.copy(), budget=2.0e5)
    ih = h.MOSAP.integer_projection(sparse.copy(), budget=2.0e5)
    vc = np.asarray(h.MOSAP.variances(ic.astype(float)))
    vh = np.asarray(h.MOSAP.variances(ih.astype(float)))
    if not np.array_equal(ic, ih):
        print("card and host corners differ at %s; variances rel diff %s"
              % (np.nonzero(ic != ih)[0].tolist(),
                 (np.abs(vc - vh) / vh).tolist()))
    np.testing.assert_allclose(vc, vh, rtol=1e-8, atol=0)


@pytest.mark.gpu
def test_ipm_iteration_syncs_only_at_its_read(cuda, cold_ipm, monkeypatch):
    """The IPM's iterations on the card under
    torch.cuda.set_sync_debug_mode("error"), lifted only for the packed
    read of each iteration: the graph's warm-up, capture and replays and
    the step's copies into the iterate raise if anything in them makes
    the host wait for the card (K3 and K4 in place of torch.linalg's
    eigenvalue and SVD calls, which read their status back).  Counted:
    one packed read and one graph replay an iteration, the iteration
    itself called twice (warm-up and capture), and K3/K4 launches of the
    start's two shifts into the cone (one eigenvalue solve each), of the
    warm-up, of each replay (three eigenvalue solves and one SVD) and of
    the final polish (one eigenvalue solve)."""
    from bluest_tpu_torch.config import allocation_device_scope
    from bluest_tpu_torch.ops import psd_eig
    sdp = cold_ipm
    calls = {"read": 0, "replay": 0, "core": 0}
    G = sdp._IterationGraph
    run, adopt, read, core = G.run, G.adopt, sdp._read, sdp._iteration_core

    def strict(name, fn):
        """``fn`` under the strict mode, lifted again after a step copy
        (the loop may end there, and the final polish reads)."""
        def f(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            torch.cuda.set_sync_debug_mode("error")
            out = fn(*a, **k)
            if name == "adopt":
                torch.cuda.set_sync_debug_mode(0)
            return out
        return f

    def lifted_read(t):
        """The packed read with the mode lifted; it stays lifted for the
        host's bookkeeping, until the next replay or step copy."""
        calls["read"] += 1
        torch.cuda.set_sync_debug_mode(0)
        return read(t)

    def counted_core(*a, **k):
        calls["core"] += 1
        return core(*a, **k)

    monkeypatch.setattr(G, "run", strict("replay", run))
    monkeypatch.setattr(G, "adopt", strict("adopt", adopt))
    monkeypatch.setattr(sdp, "_read", lifted_read)
    monkeypatch.setattr(sdp, "_iteration_core", counted_core)
    k3, k4 = psd_eig.sym_eigvalsh, psd_eig.nt_svd
    before = (k3.launches, k4.launches)
    prog = _alloc_programs()["budget-1"]()
    try:
        with allocation_device_scope("cuda"):
            res = sdp.solve_cone_lp(*prog, max_iter=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    it = calls["replay"]
    assert it == res.iterations == 3
    assert calls["read"] == it and calls["core"] == 2
    assert calls["adopt"] == it
    assert k3.launches - before[0] == 2 + 3 + 3 * it + 1
    assert k4.launches - before[1] == 1 + it


# ------------------- K3 and K4, the IPM's Jacobi kernels ------------------ #

@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 5, 11, 13, 33, 64, 100])
@pytest.mark.parametrize("B", [1, 3, 6, 12, 20])
def test_k3_k4_match_plain(cuda, n, B):
    """K3 and K4 against torch.linalg on seeded blocks at the IPM's batch
    sizes, at scales 1e-150 ... 1e150, with repeated and zero eigenvalues
    and rank-deficient blocks (chip_smoke.py's check, tolerances of
    k3_holds / k4_holds: 32 n eps ||A||_F for the eigenvalues and the
    singular values against the host's LAPACK on every block and the
    card's cuSOLVER on the unit-scale ones, 32 n eps for U^T U - I,
    64 n eps ||M||_F^2 for U diag(S^2) U^T - M M^T); n = 64 runs K4 and
    n = 100 both kernels from their global-memory workspace."""
    from chip_smoke import _psd_refs, k3_holds, k4_holds, psd_blocks
    from bluest_tpu_torch.ops import psd_eig
    A = psd_blocks(n, B, 11 * n + B, 3)
    w, st = psd_eig.sym_eigvalsh(A)
    k3_holds(A, w, st, [r[0] for r in _psd_refs(psd_eig.sym_eigvalsh_plain,
                                                A)], "n=%d" % n)
    M = psd_blocks(n, B, 13 * n + B, 4)
    U, S, st = psd_eig.nt_svd(M)
    k4_holds(M, U, S, st, [r[1] for r in _psd_refs(psd_eig.nt_svd_plain, M)],
             "n=%d" % n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 11, 64, 100])
def test_k3_k4_flag_non_finite_blocks(cuda, n):
    """A NaN or an inf block gets status 1 and NaN results; its
    neighbours are solved as alone."""
    from bluest_tpu_torch.ops import psd_eig
    A = torch.eye(n, dtype=torch.float64, device=cuda).repeat(4, 1, 1)
    A[1, 0, n - 1] = float("nan")
    A[2, n - 1, 0] = float("inf")
    w, st = psd_eig.sym_eigvalsh(A)
    U, S, st4 = psd_eig.nt_svd(A)
    assert st.tolist() == st4.tolist() == [0, 1, 1, 0]
    assert bool(w[1:3].isnan().all()) and bool(S[1:3].isnan().all())
    assert bool(U[1:3].isnan().all())
    assert torch.equal(w[[0, 3]], torch.ones(2, n, dtype=torch.float64,
                                             device=cuda))
    assert torch.equal(S[[0, 3]], torch.ones(2, n, dtype=torch.float64,
                                             device=cuda))


@pytest.mark.gpu
def test_k3_k4_refuse_on_the_card(cuda):
    from bluest_tpu_torch.ops import psd_eig
    good = torch.eye(3, dtype=torch.float64, device=cuda)[None]
    for fn in (psd_eig.sym_eigvalsh, psd_eig.nt_svd):
        with pytest.raises(TypeError):
            fn(good.float())
        with pytest.raises(ValueError):
            fn(good[0])
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 3, 4, dtype=torch.float64, device=cuda))
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 4, 4, dtype=torch.float64,
                           device=cuda).transpose(0, 1))


@pytest.mark.gpu
def test_k3_k4_launches_count_at_replay(cuda):
    """A launch recorded in a graph capture counts in ``captured``, not
    in ``launches``; count_replay adds it per replay."""
    from bluest_tpu_torch.ops import psd_eig
    A = torch.eye(5, dtype=torch.float64, device=cuda).repeat(3, 1, 1)
    fn = psd_eig.sym_eigvalsh
    fn(A)
    torch.cuda.synchronize()
    launches, captured = fn.launches, fn.captured
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        g.capture_begin()
        w, st = fn(A)
        g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert (fn.launches, fn.captured) == (launches, captured + 1)
    for _ in range(3):
        g.replay()
        psd_eig.count_replay({fn: 1})
    torch.cuda.synchronize()
    assert fn.launches == launches + 3
    assert torch.equal(w, torch.ones(3, 5, dtype=torch.float64, device=cuda))
    assert st.tolist() == [0, 0, 0]


# --------------- the IPM iteration as one graph: graph vs eager ---------- #

def _solve_both_loops(sdp, prog, fail_first=False, **kw):
    """The same cone program on the card through the graph loop and the
    eager loop: each interior-point solve's (iterations, done, best x),
    and the results.  ``fail_first`` replaces the 0.99 attempt by a
    failed one, so the solve retries at 0.85 (a second attempt, a second
    capture)."""
    from bluest_tpu_torch.config import allocation_device_scope
    real = sdp._ipm_solve
    out = {}
    for loop in ("eager", "graph"):
        rec = []

        def ipm(*a, **k):
            if fail_first and a[11] > 0.92:
                return dict(merit=np.inf), 0, 2, None, None
            r = real(*a, **k, loop=loop)
            rec.append((r[1], r[2], r[0]["x"].cpu().numpy()))
            return r
        sdp._ipm_solve = ipm
        try:
            with allocation_device_scope("cuda"):
                res = sdp.solve_cone_lp(*prog, **kw)
        finally:
            sdp._ipm_solve = real
        out[loop] = (res, rec)
    return out


def _graph_equals_eager(out):
    (re_, rece), (rg, recg) = out["eager"], out["graph"]
    assert rg.status == re_.status and rg.iterations == re_.iterations
    assert [r[:2] for r in recg] == [r[:2] for r in rece]
    for a, b in zip(recg, rece):
        assert np.array_equal(a[2], b[2])
    assert np.array_equal(rg.x, re_.x, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ALLOC_PROGRAMS)
def test_ipm_graph_matches_eager_card(cuda, cold_ipm, case):
    """Each iteration replayed as one CUDA graph gives the eager card
    loop's solve: the same status and iterations, x bit for bit."""
    _graph_equals_eager(_solve_both_loops(cold_ipm,
                                          _alloc_programs()[case]()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lmi-21", "budget-3"])
def test_ipm_graph_matches_eager_card_woodbury(cuda, cold_ipm, case):
    _graph_equals_eager(_solve_both_loops(
        cold_ipm, _alloc_programs()[case](), woodbury=True))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lmi-7", "eps-1"])
def test_ipm_graph_matches_eager_card_retry(cuda, cold_ipm, case):
    """The 0.85 retry is a second attempt with a graph of its own."""
    out = _solve_both_loops(cold_ipm, _alloc_programs()[case](),
                            fail_first=True)
    _graph_equals_eager(out)
    assert out["graph"][0].dims["retried"]


# ------------- K5: the allocation's Jacobi eigh and pinv(A)[0, 0] ------------ #

K5_SHAPES = [(n, B) for n in (1, 2, 10, 11, 12, 13, 33, 64, 100)
             for B in (1, 3, 77, 1024, 8192) if B * n * n <= 8192 * 13 * 13]


@pytest.mark.gpu
@pytest.mark.parametrize("n,B", K5_SHAPES)
def test_k5_matches_plain(cuda, n, B):
    """K5's sym_eigh and pinv00 against their plain versions on seeded
    blocks at scales 1e-150 ... 1e150 with repeated and zero eigenvalues
    (chip_smoke.py's K5 check and tolerances: sym_eigh's eigenvalues K3's
    bit for bit and within 32 n eps ||A||_F of LAPACK's on a host copy and
    of cuSOLVER's at unit scale, ||V^T V - I||_F <= 32 n eps, ||V diag(w)
    V^T - A||_F <= 64 n eps ||A||_F; pinv00 within 64 n eps kappa
    sum|v0^2/w| of the plain version's on the host and, at unit scale, on
    the card), each launch counted; n = 33 runs the block kernel from
    shared memory, 64 and 100 from the global workspace."""
    from chip_smoke import (K5_RCOND, k5_eigh_holds, k5_pinv_holds,
                            psd_blocks)
    from bluest_tpu_torch.ops import psd_eig
    A = psd_blocks(n, B, 17 * n + B, 3)
    before = (psd_eig.sym_eigh.launches, psd_eig.pinv00.launches)
    w, V, st = psd_eig.sym_eigh(A)
    var, st6 = psd_eig.pinv00(A, K5_RCOND)
    assert (psd_eig.sym_eigh.launches, psd_eig.pinv00.launches) == (
        before[0] + 1, before[1] + 1)
    w3, _ = psd_eig.sym_eigvalsh(A)
    card, host = psd_eig.sym_eigh_plain(A), psd_eig.sym_eigh_plain(A.cpu())
    k5_eigh_holds(A, w, V, st, w3, (card[:2], tuple(t.cuda() for t in
                                                     host[:2])), "n=%d" % n)
    refs = (psd_eig.pinv00_plain(A, K5_RCOND)[0],
            psd_eig.pinv00_plain(A.cpu(), K5_RCOND)[0].cuda())
    k5_pinv_holds(A, var, st6, refs, K5_RCOND, "n=%d" % n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 11, 33, 100])
def test_k5_flags_non_finite_blocks(cuda, n):
    """A NaN or an inf block gets status 1 and NaN results; its
    neighbours are solved as alone."""
    from bluest_tpu_torch.ops import psd_eig
    A = torch.eye(n, dtype=torch.float64, device=cuda).repeat(4, 1, 1)
    A[1, n - 1, 0] = float("nan")
    A[2, 0, 0] = float("inf")
    w, V, st = psd_eig.sym_eigh(A)
    var, st6 = psd_eig.pinv00(A, 1e-12)
    assert st.tolist() == st6.tolist() == [0, 1, 1, 0]
    assert bool(w[1:3].isnan().all()) and bool(V[1:3].isnan().all())
    assert bool(var[1:3].isnan().all())
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    assert torch.equal(V[[0, 3]], eye.repeat(2, 1, 1))
    assert var[[0, 3]].tolist() == [1.0, 1.0]


@pytest.mark.gpu
def test_k5_refuses_on_the_card(cuda):
    from bluest_tpu_torch.ops import psd_eig
    good = torch.eye(3, dtype=torch.float64, device=cuda)[None]
    for fn in (psd_eig.sym_eigh, lambda A: psd_eig.pinv00(A, 1e-10)):
        with pytest.raises(TypeError):
            fn(good.float())
        with pytest.raises(ValueError):
            fn(good[0])
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 3, 4, dtype=torch.float64, device=cuda))
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 4, 4, dtype=torch.float64,
                           device=cuda).transpose(1, 2))


@pytest.mark.gpu
def test_k5_launches_count_at_replay(cuda):
    """K5's launches recorded in a graph capture count in ``captured``;
    count_replay adds them per replay, as for K3 and K4."""
    from bluest_tpu_torch.ops import psd_eig
    A = 2.0 * torch.eye(5, dtype=torch.float64, device=cuda).repeat(3, 1, 1)
    psd_eig.sym_eigh(A)
    psd_eig.pinv00(A, 1e-10)
    torch.cuda.synchronize()
    fns = (psd_eig.sym_eigh, psd_eig.pinv00)
    before = [(f.launches, f.captured) for f in fns]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        g.capture_begin()
        w, V, st = psd_eig.sym_eigh(A)
        var, st6 = psd_eig.pinv00(A, 1e-10)
        g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert [(f.launches, f.captured) for f in fns] == [
        (n, c + 1) for n, c in before]
    for _ in range(2):
        g.replay()
        psd_eig.count_replay({f: 1 for f in fns})
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n + 2 for n, _ in before]
    assert torch.equal(w, torch.full((3, 5), 2.0, dtype=torch.float64,
                                     device=cuda))
    assert var.tolist() == [0.5] * 3 and st.tolist() == st6.tolist() == [0] * 3


def _search_instance(seed, mode):
    """A seeded multi-output flagship instance (M=10, 3 outputs, L=385)
    and a continuous point on 12 of its groups, at budget 2e5 or at the
    point's own variances (each output's eps^2 its variance there, so the
    point meets the tolerance); tests/test_torch_integer_dispatch.py
    holds the port's search on them against the JAX package's."""
    p = _flagship_width("cpu", seed)
    p.prewarm_solver(K=4)
    m = p.MOSAP
    rng = np.random.default_rng(seed)
    sol = np.zeros(m.L)
    sol[rng.choice(np.arange(1, m.L), 11, replace=False)] = rng.uniform(
        0.5, 30.0, 11)
    sol[0] = 3.0
    budget = eps = None
    if mode == "budget":
        budget = 2.0e5
        sol *= budget / float(sol @ m.costs)
    else:
        sol *= 1.0e4 / float(sol @ m.costs)
        eps = np.sqrt(np.asarray(m.variances(sol)))
    return (sol, [s.psi for s in m.SAPS], m.costs, m.e, m.mappings,
            dict(budget=budget, eps=eps))


@pytest.mark.gpu
@pytest.mark.parametrize("ll_max", [15, 4])
@pytest.mark.parametrize("mode", ["budget", "eps"])
@pytest.mark.parametrize("seed", [2, 3])
def test_integer_search_card_matches_host(cuda, seed, mode, ll_max):
    """The corner search (ll_max 15) and the greedy waves with their
    polish (ll_max 4) on the card through K5 give the host's samples on
    the seeded instances (the host's agree with the JAX package's there:
    tests/test_torch_integer_dispatch.py), and the same max-variance
    within 1e-12 relative."""
    from bluest_tpu_torch.config import allocation_device_scope
    from bluest_tpu_torch.ops import psd_eig
    from bluest_tpu_torch.solvers import integer
    sol, psis, w, e, maps, how = _search_instance(seed, mode)
    before = psd_eig.pinv00.launches
    with allocation_device_scope("cuda"):
        got, gv = integer.best_integer_blue_multi(sol, psis, w, e, maps,
                                                  ll_max=ll_max, **how)
    assert psd_eig.pinv00.launches > before
    with allocation_device_scope("cpu"):
        ref, rv = integer.best_integer_blue_multi(sol, psis, w, e, maps,
                                                  ll_max=ll_max, **how)
    assert got is not None and ref is not None
    np.testing.assert_array_equal(got, ref)
    assert abs(gv - rv) <= 1e-12 * abs(rv)


@pytest.mark.gpu
@pytest.mark.parametrize("ll_max", [15, 4])
def test_integer_search_syncs_once_a_read(cuda, monkeypatch, ll_max):
    """Under torch.cuda.set_sync_debug_mode("warn") the search on the card
    makes the host wait once a _gather (one a _multi_helper call, one a
    greedy wave) and nowhere else: its uploads are pinned and
    non-blocking, K5 writes its statuses to the card."""
    import warnings
    from bluest_tpu_torch.config import allocation_device_scope
    from bluest_tpu_torch.solvers import integer
    sol, psis, w, e, maps, how = _search_instance(2, "budget")
    gathers = [0]
    real = integer._gather

    def counted(pending):
        gathers[0] += 1
        return real(pending)
    monkeypatch.setattr(integer, "_gather", counted)
    with allocation_device_scope("cuda"):
        integer.best_integer_blue_multi(sol, psis, w, e, maps, ll_max=ll_max,
                                        **how)           # warm
        torch.cuda.synchronize()
        gathers[0] = 0
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got, _ = integer.best_integer_blue_multi(
                    sol, psis, w, e, maps, ll_max=ll_max, **how)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w_ for w_ in caught if "synchroniz" in str(w_.message)]
    sites = {"%s:%d" % (w_.filename, w_.lineno) for w_ in syncs}
    assert got is not None and gathers[0] >= 1
    assert len(syncs) == gathers[0], sites
    assert all("integer.py" in s for s in sites), sites


@pytest.mark.gpu
def test_card_sites_call_no_torch_linalg_eigensolver(cuda, cold_ipm,
                                                    monkeypatch):
    """On the card the allocation's eigensolves are K3 and K5: a budget
    set-up of the flagship-width problem (the IPM's start, psi's variance
    and pseudo-inverse, the integer search), the SPD clip and the masked
    SPG projection, ADMM's PSD projection and its history Gram matrix
    call no torch.linalg eigensolver on a CUDA tensor, and launch K3 and
    K5."""
    import bluest_tpu_torch.linalg.spd as spd
    from bluest_tpu_torch.config import allocation_device_scope
    from bluest_tpu_torch.core import psi as psimod
    from bluest_tpu_torch.ops import psd_eig
    from bluest_tpu_torch.solvers.admm import solve_cone_lp_admm
    names = ("eigh", "eigvalsh", "eig", "eigvals")
    calls = []
    for n in names:
        real = getattr(torch.linalg, n)

        def guard(A, *a, _real=real, _n=n, **k):
            if isinstance(A, torch.Tensor) and A.is_cuda:
                calls.append(_n)
            return _real(A, *a, **k)
        monkeypatch.setattr(torch.linalg, n, guard)
    before = {k: getattr(psd_eig, k).launches
              for k in ("sym_eigvalsh", "sym_eigh", "pinv00")}
    p = _flagship_width("cuda")
    p.setup_solver(K=4, budget=2.0e5)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((10, 10))
    C = X @ X.T - 3.0 * np.eye(10)
    with allocation_device_scope("cuda"):
        Cc = spd.clip_spd(torch.as_tensor(C, device=cuda), 1e-3)
        mask = np.ones((10, 10))
        mask[0, 1] = mask[1, 0] = 0.0
        spd.project_covariance_masked(C, mask, maxit=20)
        data = p.MOSAP.SAPS[0].data
        m = torch.ones(data.L, dtype=torch.float64, device=cuda)
        v = psimod.variance(data, m)
        g = psimod.variance_grad_hess(data, m)
        res = solve_cone_lp_admm(*_alloc_programs()["min-eig"](),
                                 max_iter=50)
    assert not calls, calls
    assert Cc.is_cuda and v.is_cuda and res.x is not None and g is not None
    got = {k: getattr(psd_eig, k).launches - b for k, b in before.items()}
    assert all(v_ > 0 for v_ in got.values()), got


def _span_problem(cuda):
    """A small Hodgkin-Huxley problem on the card whose Euler model at dt
    0.08 blows up on most draws, set up, solved once (K2 built, caches
    warm) and synchronised."""
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    from bluest_tpu_torch.solvers import sdp
    sdp._WARM_CACHE.clear()          # a cold allocation, alike each time
    corr = np.array([[1.0, 0.9, 0.8], [0.9, 1.0, 0.85], [0.8, 0.85, 1.0]])
    p = hh.HodgkinHuxleyProblem(models=((0, 0.04), (1, 0.04), (1, 0.08)),
                                C=[corr] * 5, verbose=False, device=cuda,
                                device_batch_size=4096, seed=3)
    p.setup_solver(K=3, budget=2e4)
    p.solve(K=3, budget=2e4)
    torch.cuda.synchronize()
    return p


@pytest.mark.gpu
def test_span_host_syncs_are_the_synchronising_calls(cuda):
    """One solve on the card: its ``host.sync`` spans are as many as the
    synchronising calls that the synchronisation debug mode reports and
    the group engine's waits on its count events (``draw.count``, which
    the debug mode does not see: they drain no stream), and the request's
    counters say the same."""
    import os
    import warnings
    from bluest_tpu_torch import profiling
    p = _span_problem(cuda)
    profiling.enable_spans()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p.solve(K=3, budget=2e4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        profiling.disable_spans()
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = "%s:%d" % (os.path.basename(w.filename), w.lineno)
            sites[site] = sites.get(site, 0) + 1
    spans = profiling.spans()
    syncs = [s for s in spans if s.name == "host.sync"]
    waits = sum(s.attrs["site"] == "draw.count" for s in syncs)
    root = next(s for s in spans if s.name == "solve")
    counted = sum(v for k, v in root.attrs["counters"].items()
                  if k.startswith("host.sync."))
    assert waits == sum(s.name == "sample.chunk" for s in spans)
    assert len(syncs) == sum(sites.values()) + waits == counted, (
        len(syncs), waits, sites)
    # the engine's reads that drain the stream: which rows failed, which
    # redrawn rows are finite
    assert sum(v for k, v in sites.items()
               if k.startswith("group_engine.py:")) == sum(
        s.attrs["site"] in ("draw.bad", "draw.good") for s in syncs), sites
    assert root.attrs["counters"]["k2.launches"] == sum(
        s.name == "model.evaluate" for s in spans)


@pytest.mark.gpu
def test_span_fetch_copy_lies_inside_its_span(cuda):
    """On the profiler's clock each ``fetch`` read's device-to-host copy
    lies inside its ``host.sync`` span (50 us of slack at either end), and
    so does every other device-to-host copy of the solve inside some
    ``host.sync`` span, but the group engine's count copies: those run
    while the host works, and each ends before its ``draw.count`` wait
    ends, after the wait before it."""
    from torch.profiler import ProfilerActivity, profile
    from bluest_tpu_torch import profiling
    p = _span_problem(cuda)
    profiling.enable_spans()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            p.solve(K=3, budget=2e4)
            torch.cuda.synchronize()
    finally:
        profiling.disable_spans()
    start = prof.profiler.kineto_results.trace_start_ns()
    copies = [(start + e.time_range.start * 1e3,
               start + e.time_range.end * 1e3)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "DtoH" in e.name]
    syncs = [(profiling.unix_ns(s.start_ns), profiling.unix_ns(s.end_ns),
              s.attrs["site"]) for s in profiling.spans()
             if s.name == "host.sync"]
    slack = 50e3
    fetches = [(a, b) for a, b, site in syncs if site == "fetch"]
    assert fetches
    for a, b in fetches:
        inside = [c for c in copies
                  if a - slack <= c[0] and c[1] <= b + slack]
        assert len(inside) == 1, (a, b, [c for c in copies
                                         if c[1] > a - 1e6 and c[0] < b + 1e6])
    # one stream: the card runs the copies in the order the host issued
    # them, one a read, the count that a draw.count span waits for issued
    # after the span before it
    copies.sort()
    syncs.sort()
    assert len(copies) == len(syncs) > 0, (len(copies), len(syncs))
    prev = -math.inf
    for c, (a, b, site) in zip(copies, syncs):
        if site == "draw.count":
            assert prev - slack <= c[0] and c[1] <= b + slack, (c, a, b)
        else:
            assert a - slack <= c[0] and c[1] <= b + slack, (c, a, b, site)
        prev = b


@pytest.mark.gpu
def test_span_recorder_adds_no_device_work(cuda):
    """Two problems alike, one solved with the recorder off and one with
    it on: the card runs the same items, in the same order, and the means
    and error bars are bit-equal."""
    from torch.profiler import ProfilerActivity, profile
    from bluest_tpu_torch import profiling
    runs = []
    for on in (False, True):
        p = _span_problem(cuda)
        if on:
            profiling.enable_spans()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                mus, errs, _ = p.solve(K=3, budget=2e4)
                torch.cuda.synchronize()
        finally:
            profiling.disable_spans()
        items = [e.name for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        runs.append((items, mus, errs))
    assert profiling.spans()
    (off, mus0, errs0), (on, mus1, errs1) = runs
    assert len(off) == len(on) and off == on
    for a, b in zip(mus0, mus1):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(errs0), np.asarray(errs1))


@pytest.mark.gpu
def test_group_engine_sequence_matches_one_by_one_on_card(cuda):
    """A K=3 Hodgkin-Huxley solve on the card, whose calls run as one
    sequence drawn one chunk ahead (the Euler model at dt 0.08 fails on
    most draws, so most chunks redraw and drop the draw made ahead of the
    next): every evaluation's rows and every call's sums are bit-equal to
    a loop of the engine's per-chunk steps that runs one chunk after
    another, and K2 launches once a ``model.evaluate`` span."""
    from bluest_tpu_torch import profiling
    from bluest_tpu_torch.sampling.engine import combine, fold
    p = _span_problem(cuda)
    rows, dispatched = [], []
    evaluate = p.evaluate_group

    def kept(ls, x):
        out = evaluate(ls, x)
        rows.append((tuple(ls), out))
        return out
    p.evaluate_group = kept
    p._engine = None                    # the engine takes the wrapper
    device_sums = p._device_sums

    def recorded(calls):
        sums = device_sums(calls)
        dispatched.append((list(calls), sums))
        return sums
    p._device_sums = recorded
    profiling.enable_spans()
    try:
        p.solve(K=3, budget=2e4)
    finally:
        profiling.disable_spans()
    spans = profiling.spans()
    counters = next(s for s in spans if s.name == "solve").attrs["counters"]
    chunks = sum(s.name == "sample.chunk" for s in spans)
    assert counters["k2.launches"] == len(rows) == sum(
        s.name == "model.evaluate" for s in spans)
    assert counters["draw.ahead"] == chunks - len(dispatched)
    assert counters.get("draw.ahead_dropped", 0) > 0
    seen = len(rows)
    eng = p._sampling_engine()
    gen = torch.Generator(device=cuda)
    for calls, got in dispatched:
        for (ls, N, counter, first, _sink), sums in zip(calls, got):
            acc = None
            for c in range(math.ceil(N / eng.batch)):
                base = c * eng.batch
                gen = eng.seed(gen, p.params["seed"], counter, first + c)
                _x, outs, _ok = eng.draw(gen, ls, min(eng.batch, N - base))
                acc = fold(combine, acc, outs.movedim(2, 0), base, N)
            assert all(torch.equal(a, b) for a, b in zip(sums, acc)), ls
    assert len(rows) == 2 * seen
    for (ls_a, a), (ls_b, b) in zip(rows[:seen], rows[seen:]):
        assert ls_a == ls_b
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_group_engine_counts_on_a_card_that_is_not_current(cuda):
    """The group engine's count copy and its event go on the count's
    card: a Hodgkin-Huxley problem on cuda:1 sampled while cuda:0 is
    current reads each chunk's count as a blocking read does, and its
    sums are bit-equal to the same problem's on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    corr = np.array([[1.0, 0.9, 0.8], [0.9, 1.0, 0.85], [0.8, 0.85, 1.0]])
    # the Euler model at dt 0.08 fails on most rows: counts differ chunk
    # to chunk, so a stale count would show
    calls = [((0, 1, 2), 0, 10000, 0), ((1, 2), 1, 9000, 0),
             ((0,), 2, 5000, 0)]
    got = []
    for dev in ("cuda:0", "cuda:1"):
        p = hh.HodgkinHuxleyProblem(models=((0, 0.04), (1, 0.04), (1, 0.08)),
                                    C=[corr] * 5, verbose=False, device=dev,
                                    device_batch_size=4096, seed=3)
        eng = p._sampling_engine()
        reads, read = [], eng.read_count

        def checked(count, read=read, reads=reads):
            n = read(count)
            reads.append((n, int(count)))
            return n
        eng.read_count = checked
        with torch.cuda.device(0):
            sums = eng.sample_calls(p.params["seed"], calls)
        torch.cuda.synchronize(dev)
        assert all(t.device == torch.device(dev) for s in sums for t in s)
        got.append(([[t.cpu() for t in s] for s in sums], reads))
    for (_sums, reads) in got:
        assert [n for n, _ in reads] == [want for _, want in reads], reads
        assert any(n < 4096 for n, _ in reads)
    assert got[0][1] == got[1][1]
    for a, b in zip(got[0][0], got[1][0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# K6, the sampling combiner: models a group, output dimensions, rows (one,
# a ragged few, past a block's tile many times)
K6_K = [1, 2, 3, 5, 12]
K6_D = [1, 3]
K6_ROWS = [1, 77, 3001]
# the cell's groups at its chunk of 262,144 rows: the Euler model alone,
# the K=3 groups, a 12-model group
K6_CELL = [(1, 5, 1), (3, 5, 1), (12, 5, 1)]
K6_CHUNK = 262144


def _k6_outputs(cuda, layout, dtype, k, rows, No, d, seed):
    """Model-major outputs on the card as an engine hands them to K6: the
    group engine's (rows, No, k[, d]) block moved model-major (strided),
    or the factored engine's stacked (k, rows, No[, d]); with NaN, inf
    and (through the callers' N) past-N rows."""
    from test_torch_combine import _outputs
    x = _outputs(k, rows, No, d, seed)
    if layout == "group":
        return x.movedim(0, 2).contiguous().to(cuda, dtype).movedim(2, 0)
    return x.to(cuda, dtype).contiguous()


def _k6_close(got, ref):
    """1e-12 of the tensor's largest entry for the sums, n_failed exact."""
    for g, r in zip(got[:4], ref[:4]):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        assert g.shape == r.shape
        assert np.abs(g - r).max(initial=0.0) <= 1e-12 * max(
            np.abs(r).max(initial=0.0), 1e-300)
    assert int(got[4]) == int(ref[4])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["group", "stacked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", K6_K)
@pytest.mark.parametrize("d", K6_D)
@pytest.mark.parametrize("rows", K6_ROWS)
def test_k6_matches_plain(cuda, layout, dtype, k, d, rows):
    """One K6 launch: within 1e-12 of combine_plain on the card, n_failed
    exact, and bit-equal to the CPU mirror of its order of summation
    (tests/test_torch_combine.py); the last five rows past N."""
    from test_torch_combine import k6_mirror
    from bluest_tpu_torch.ops import combine as k6
    from bluest_tpu_torch.sampling.engine import combine, combine_plain
    outs = _k6_outputs(cuda, layout, dtype, k, rows, 5, d, seed=rows + k)
    base, N = 3, rows - 2
    before = k6.combine_sums.launches
    got = combine(outs, base, N)
    torch.cuda.synchronize()
    assert k6.combine_sums.launches == before + 1
    assert got.sumse.dtype == torch.float64
    assert got.n_failed.dtype == torch.int64 and got.n_failed.dim() == 0
    _k6_close(got, combine_plain(outs, base, N))
    for g, m in zip(got, k6_mirror(outs.cpu(), base, N)):
        assert torch.equal(g.cpu(), m)


@pytest.mark.gpu
@pytest.mark.parametrize("k,No,d", K6_CELL)
def test_k6_cell_chunks_match_plain_and_repeat(cuda, k, No, d):
    """The cell's chunk shapes: within 1e-12 of combine_plain, and two
    calls on the same rows bit-equal; each launch counted."""
    from bluest_tpu_torch.ops import combine as k6
    from bluest_tpu_torch.sampling.engine import combine, combine_plain
    outs = _k6_outputs(cuda, "group", torch.float64, k, K6_CHUNK, No, d,
                       seed=k)
    before = k6.combine_sums.launches
    a = combine(outs, 0, K6_CHUNK - 100)
    b = combine(outs, 0, K6_CHUNK - 100)
    torch.cuda.synchronize()
    assert k6.combine_sums.launches == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _k6_close(a, combine_plain(outs, 0, K6_CHUNK - 100))


@pytest.mark.gpu
@pytest.mark.parametrize("k,d", [(1, 1), (3, 1), (2, 3), (12, 1)])
def test_k6_running_sums_in_place(cuda, k, d):
    """A call's chunks added in place into the sums its first chunk wrote
    equal add_sums of the chunks' own sums bit for bit; sums a caller
    hands to an engine call are copied (own_sums) and left as they are."""
    from bluest_tpu_torch.sampling.engine import add_sums, combine, own_sums
    rows, N = 3000, 2990
    outs = _k6_outputs(cuda, "group", torch.float64, k, rows, 5, d, seed=9)
    cuts = [(0, 1000), (1000, 1999), (1999, rows)]
    parts = [combine(outs[:, a:b], a, N) for a, b in cuts]
    acc = None
    for a, b in cuts:
        out = combine(outs[:, a:b], a, N, acc)
        if acc is not None:
            assert all(x.data_ptr() == y.data_ptr()
                       for x, y in zip(out, acc))
        acc = out
    ref = add_sums(add_sums(parts[0], parts[1]), parts[2])
    for x, y in zip(acc, ref):
        assert torch.equal(x, y)
    held = [t.clone() for t in parts[0]]
    keep = [t.clone() for t in held]
    out = combine(outs[:, 1000:1999], 1000, N, own_sums(held))
    for x, y in zip(held, keep):
        assert torch.equal(x, y)
    for x, y in zip(out, add_sums(parts[0], parts[1])):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_k6_refuses_on_the_card(cuda):
    from bluest_tpu_torch.ops import combine as k6
    with pytest.raises(ValueError):
        k6.combine_sums(torch.zeros(1, 4, 4096, device=cuda), 0, 4)
    with pytest.raises(ValueError):
        k6.combine_sums(torch.zeros(1, 2, 3, 1, 1, device=cuda), 0, 4)
    sums = k6.combine_sums(torch.zeros(2, 4, 3, device=cuda), 0, 4)
    with pytest.raises(ValueError):             # running sums of a k of 2
        k6.combine_sums(torch.zeros(3, 4, 3, device=cuda), 0, 4, sums)
    with pytest.raises(ValueError):             # or on the host
        k6.combine_sums(torch.zeros(2, 4, 3, device=cuda), 0, 4,
                        [t.cpu() for t in sums])
    with pytest.raises(ValueError):             # or not contiguous
        k6.combine_sums(torch.zeros(2, 4, 3, device=cuda), 0, 4,
                        [sums[0], sums[1].mT, *sums[2:]])


@pytest.mark.gpu
def test_k6_launches_are_the_solves_combines(cuda):
    """A recorded solve on the card: its ``k6.launches`` equals its
    ``sample.combine`` spans; combine_plain on a CUDA tensor launches
    nothing."""
    from bluest_tpu_torch import profiling
    from bluest_tpu_torch.ops import combine as k6
    from bluest_tpu_torch.sampling.engine import combine_plain
    p = _span_problem(cuda)
    profiling.enable_spans()
    try:
        p.solve(K=3, budget=2e4)
    finally:
        profiling.disable_spans()
    spans = profiling.spans()
    root = next(s for s in spans if s.name == "solve")
    combines = sum(s.name == "sample.combine" for s in spans)
    assert combines > 0
    assert root.attrs["counters"]["k6.launches"] == combines
    before = k6.combine_sums.launches
    combine_plain(torch.ones(2, 8, 5, device=cuda), 0, 8)
    torch.cuda.synchronize()
    assert k6.combine_sums.launches == before


@pytest.mark.gpu
def test_group_engine_chunk_runs_no_cublas(cuda):
    """The device items of a group engine's chunks of Hodgkin-Huxley
    models: one K6 launch a chunk, and no cuBLAS gemv, dot or GEMM."""
    from torch.profiler import ProfilerActivity, profile
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    from bluest_tpu_torch.sampling.group_engine import GroupEngine
    p = hh.HodgkinHuxleyProblem(C=[np.eye(12) + 0.5] * 5, verbose=False,
                                device=cuda)
    names = {}
    for ls in ((6,), (5, 6, 9)):
        eng = GroupEngine(p.sample_group, p.evaluate_group, 5, 4096, cuda)
        eng.sample_sums(ls, 1, 0, 2 * 4096)           # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.sample_sums(ls, 1, 1, 2 * 4096)
            torch.cuda.synchronize()
        names[ls] = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    for ls, items in names.items():
        assert sum("combine_kernel" in n for n in items) == 2, (ls, items)
        blas = [n for n in items if re.search(r"gemv|dot_kernel|gemm", n,
                                              re.IGNORECASE)]
        assert not blas, (ls, blas)
