"""Model level: the port's diffusion model against the JAX package.

The same numpy-seeded KL coefficients go through
``bluest_tpu.models.diffusion`` (f64 oracle; the Pallas kernel in
interpret mode) and the port's K1 wrapper, which runs its plain PyTorch
version for CPU tensors.  Tolerances:

* plain f64 vs the JAX f64 oracle: max relative 1e-9, median 1e-11, both
  times max(1, (n/1024)^2).  The JAX oracle solves by cyclic reduction at
  n = 2^p and by Thomas otherwise, the port by a partitioned Thomas solve
  (csrc/diffusion.cu); the lognormal coefficient makes the system
  ill-conditioned, its condition grows with n^2, and the two differ by up
  to ~5e-10 max / ~5e-12 median at n=1024, 2.7e-9 / 3.1e-11 at n=4096.
* f32 vs the f64 oracle: the error-class bound of
  tests/test_pallas_diffusion.py:34-36 (the f32 JAX path is the incumbent).
* plain f32 vs the Pallas kernel (interpret mode): rtol 2e-3, atol 1e-6,
  as tests/test_pallas_diffusion.py:48-49, on grids where f32 is that
  close; on finer grids (n >= 2048, where both f32 solves are off the f64
  oracle by up to ~1e-1) the error-class bound of
  tests/test_pallas_diffusion.py:34-36 against the Pallas kernel's own.

The plain version is the arithmetic of both kernels on the card, K1 and
its wide tier (n_cells > 1025 or an oversize n_kl); ``tier`` says which
one runs, and the CPU path takes the same decision.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bluest_tpu.models.diffusion import (DiffusionProblem as JaxDiffusion,
                                         solve_diffusion_outputs as jax_outputs)
from bluest_tpu.ops.pallas_diffusion import diffusion_outputs_pallas
from bluest_tpu_torch.models.diffusion import (DiffusionProblem,
                                               solve_diffusion_outputs,
                                               thomas_solve)
from bluest_tpu_torch.ops import diffusion as k1

torch.set_num_threads(1)

SIGMA, NU = 1.0, 0.6


def _jax_ref(xis, n, dtype=jnp.float64):
    fn = jax.jit(jax.vmap(lambda x: jax_outputs(x, n, SIGMA, NU)))
    return np.asarray(fn(jnp.asarray(xis, dtype)), np.float64)


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref) / (np.abs(ref) + 1e-9)


@pytest.mark.parametrize("n", [2, 3, 8, 9, 33, 64, 100, 256, 1024, 1026,
                               1500, 2048, 4096])
def test_plain_matches_jax(n):
    """f64 against the f64 oracle at B = 1, 77 and 200 (the oracle is per
    sample, so its B=200 run is sliced); f32 within the f32 error class,
    a property of a batch, at B = 77 and 200, and every B's f32 rows
    bit-equal to the same rows of the B=200 run.  Past 1025 cells the
    card runs the wide tier on this arithmetic."""
    scale = max(1.0, (n / 1024) ** 2)
    xis = np.random.default_rng(0).standard_normal((200, 32))
    x32 = xis.astype(np.float32)
    ref64 = _jax_ref(xis, n)
    ref64_32 = _jax_ref(x32, n)
    inc = _jax_ref(x32, n, jnp.float32)
    full32 = k1.diffusion_outputs(torch.as_tensor(x32), n, SIGMA, NU).numpy()
    for B in (1, 77, 200):
        got = k1.diffusion_outputs(torch.as_tensor(xis[:B]), n, SIGMA,
                                   NU).numpy()
        assert got.shape == (B, 3)
        err = np.abs(got - ref64[:B]) / np.abs(ref64[:B])
        assert err.max() <= 1e-9 * scale
        assert np.median(err) <= 1e-11 * scale

        got = k1.diffusion_outputs(torch.as_tensor(x32[:B]), n, SIGMA,
                                   NU).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, full32[:B])
        if B > 1:
            err = _rel(got, ref64_32[:B])
            err_inc = _rel(inc[:B], ref64_32[:B])
            assert np.median(err) <= 10 * np.median(err_inc) + 1e-6
            assert err.max() <= 10 * err_inc.max() + 1e-5


@pytest.mark.parametrize("n", [16, 64])
def test_plain_f32_matches_pallas_interpret(n):
    xis = np.random.default_rng(7).standard_normal((77, 32)).astype(
        np.float32)
    ref = np.asarray(diffusion_outputs_pallas(xis, n, SIGMA, NU,
                                              interpret=True))
    got = k1.diffusion_outputs(torch.as_tensor(xis), n, SIGMA, NU).numpy()
    assert got.shape == (77, 3)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("n", [2048])
def test_plain_f32_in_pallas_error_class(n):
    """Past K1's reach (the wide tier's grids) the f32 model is far from
    the f64 oracle in both packages (~0.1 max relative at n=2048): the
    port's f32 error stays in the class of the Pallas kernel's own, the
    bound of tests/test_pallas_diffusion.py:34-36."""
    xis = np.random.default_rng(7).standard_normal((77, 32)).astype(
        np.float32)
    pal = np.asarray(diffusion_outputs_pallas(xis, n, SIGMA, NU,
                                              interpret=True), np.float64)
    ref64 = _jax_ref(xis, n)
    got = k1.diffusion_outputs(torch.as_tensor(xis), n, SIGMA, NU).numpy()
    assert got.shape == (77, 3) and got.dtype == np.float32
    err, err_pal = _rel(got, ref64), _rel(pal, ref64)
    assert np.median(err) <= 10 * np.median(err_pal) + 1e-6
    assert err.max() <= 10 * err_pal.max() + 1e-5


@pytest.mark.parametrize("n,n_kl,dtype,want", [
    (1, 32, torch.float32, "k1"), (1024, 32, torch.float32, "k1"),
    (1025, 32, torch.float64, "k1"), (1026, 32, torch.float32, "wide"),
    (1026, 32, torch.float64, "wide"), (4096, 1024, torch.float64, "wide"),
    (1024, 2577, torch.float64, "k1"), (1024, 2578, torch.float64, "wide"),
    (1024, 2578, torch.float32, "wide"), (100, 3700, torch.float64, "wide"),
    (1, 4000, torch.float64, "wide")])
def test_tier_predicate(n, n_kl, dtype, want):
    """K1 where its tile fits (n <= 1025 and S (padded n + n_kl) values in
    one block's 232,448 bytes of shared memory, S = 16 in f32 and 8 in
    f64), the wide tier everywhere else; the CPU path gives the plain
    version's result whichever tier it names."""
    assert k1.tier(n, n_kl, dtype) == want
    xi = torch.as_tensor(np.random.default_rng(n).standard_normal(
        (3, n_kl)), dtype=dtype)
    got = k1.diffusion_outputs(xi, n, SIGMA, NU)
    assert torch.equal(got, k1.diffusion_outputs_plain(xi, n, SIGMA, NU))


def test_edge_cases_plain():
    """n=1 has no interior unknowns (all QoIs 0); B=0 and B=1 work; the
    model-level Thomas formulation agrees with K1's partitioned solve."""
    xi = torch.as_tensor(np.random.default_rng(3).standard_normal((5, 7)))
    assert torch.equal(k1.diffusion_outputs(xi, 1), torch.zeros(5, 3,
                                                                dtype=xi.dtype))
    assert k1.diffusion_outputs(xi[:0], 8).shape == (0, 3)
    one = k1.diffusion_outputs(xi[:1], 8, SIGMA, NU)
    np.testing.assert_allclose(one.numpy(),
                               k1.diffusion_outputs(xi, 8, SIGMA, NU)[:1]
                               .numpy(), rtol=0, atol=0)
    for n in (2, 3, 9, 33):
        np.testing.assert_allclose(
            solve_diffusion_outputs(xi, n, SIGMA, NU).numpy(),
            k1.diffusion_outputs(xi, n, SIGMA, NU).numpy(), rtol=1e-11)


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        k1.diffusion_outputs(torch.zeros(4, 3, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        k1.diffusion_outputs(torch.zeros(4, 3, 2), 8)
    with pytest.raises(ValueError):
        k1.diffusion_outputs(torch.zeros(3, 4).T, 8)
    with pytest.raises(ValueError):
        k1.diffusion_outputs(torch.zeros(4, 3), 0)


def test_launch_needs_the_card_and_a_tier():
    """launch() names a kernel, so it has no plain fallback: a CPU tensor
    or an unknown tier raises, and nothing is counted."""
    before = k1.diffusion_outputs.launches
    with pytest.raises(ValueError, match="device"):
        k1.launch("wide", torch.zeros(4, 3, dtype=torch.float64), 8)
    with pytest.raises(TypeError):
        k1.launch("k1", torch.zeros(4, 3, dtype=torch.int64), 8)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="tier"):
            k1.launch("k2", torch.zeros(4, 3, device="cuda"), 8)
    assert k1.diffusion_outputs.launches == before


def test_thomas_solve_matches_numpy():
    rng = np.random.default_rng(5)
    n = 12
    diag = rng.uniform(3, 4, (2, n))
    lower = rng.uniform(-1, 0, (2, n)); lower[:, 0] = 0
    upper = rng.uniform(-1, 0, (2, n)); upper[:, -1] = 0
    rhs = rng.standard_normal((2, n))
    x = thomas_solve(*(torch.as_tensor(a) for a in (lower, diag, upper, rhs)))
    for b in range(2):
        A = np.diag(diag[b]) + np.diag(lower[b, 1:], -1) + np.diag(
            upper[b, :-1], 1)
        np.testing.assert_allclose(x[b].numpy(), np.linalg.solve(A, rhs[b]),
                                   rtol=1e-12)


@pytest.mark.parametrize("multi_output", [True, False])
def test_problem_hooks_match_jax(multi_output):
    """evaluate_model applies the per-grid mode truncation and returns
    (B, 3) or (B, 1) like the JAX hook on the same xi (f64)."""
    grids = (64, 16, 8)
    No = 3 if multi_output else 1
    C = [np.eye(3) for _ in range(No)]
    kw = dict(grids=grids, n_kl=12, sigma=SIGMA, nu=NU,
              multi_output=multi_output, verbose=False, C=C)
    pj = JaxDiffusion(**kw)
    pt = DiffusionProblem(device="cpu", **kw)
    assert pt.n_modes == pj.n_modes == (12, 4, 2)
    xis = np.random.default_rng(11).standard_normal((40, 12))
    for l in range(len(grids)):
        ref = np.asarray(jax.jit(jax.vmap(lambda t: jnp.asarray(
            pj.evaluate_model_jax(l, t))))(jnp.asarray(xis)))
        got = pt.evaluate_model(l, torch.as_tensor(xis)).numpy()
        assert got.shape == (40, No)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    gen = torch.Generator().manual_seed(0)
    th = pt.sample_inputs(gen, 5)
    assert th.shape == (5, 12) and th.dtype == torch.float64


@pytest.mark.parametrize("n,lanes", [(1, 1), (2, 2), (3, 4), (8, 8), (9, 16),
                                     (32, 32), (33, 32), (1024, 32),
                                     (1026, 64), (4096, 128), (4097, 128),
                                     (8192, 256), (16385, 512),
                                     (32769, 1024), (40000, 1024)])
def test_partition_lanes(n, lanes):
    """Lanes per sample, L(n): the smallest power of two >= min(n, 32) and
    >= ceil((n-1)/32), at most 1024 -- a warp for 33 <= n <= 1025."""
    assert k1.lanes_per_sample(n) == lanes


@pytest.mark.parametrize("n", [3, 9, 100, 1026, 2048])
def test_partitioned_solve_solves_the_system(n):
    """The QoIs are those of the tridiagonal system itself: solve it from
    the same face coefficients by Thomas in np.longdouble (x86's 80-bit
    extended type), whose own error is far below the tolerance -- a dense
    f64 solve is not: it is off that solve by up to ~2e-11 at n=2048."""
    xis = np.random.default_rng(n).standard_normal((4, 6))
    a_all = k1.synthesize_plain(torch.as_tensor(xis), n, SIGMA, NU).numpy()
    got = k1.diffusion_outputs(torch.as_tensor(xis), n, SIGMA, NU).numpy()
    ld = np.longdouble
    h = ld(1) / n
    for b in range(4):
        a = a_all[b].astype(ld)
        cp, dp = np.zeros(n - 1, ld), np.zeros(n - 1, ld)
        for i in range(n - 1):
            lo = -a[i] if i > 0 else ld(0)
            r = 1 / ((a[i] + a[i + 1]) - lo * (cp[i - 1] if i > 0 else 0))
            cp[i] = -a[i + 1] * r if i < n - 2 else ld(0)
            dp[i] = (h * h - lo * (dp[i - 1] if i > 0 else 0)) * r
        uu = np.zeros(n + 1, ld)
        for i in range(n - 2, -1, -1):
            uu[i + 1] = dp[i] - cp[i] * uu[i + 2]
        du = np.diff(uu) / h
        want = np.array([h * uu.sum(), uu[n // 2], h * (a * du * du).sum()],
                        np.float64)
        np.testing.assert_allclose(got[b], want, rtol=1e-11)


@pytest.mark.parametrize("n", [2, 3, 9, 33, 64, 100, 1024, 1025, 1026, 1500,
                               2048, 4096, 4097, 8192, 16385, 32769, 40000])
def test_partition_covers_every_row(n):
    """Every lane of the partition below P owns one or more consecutive
    rows, together exactly the m = n-1 unknowns; a lane owns at most 32
    rows up to n = 32769 (past it, 1024 lanes own ceil((n-1)/1024))."""
    L = k1.lanes_per_sample(n)
    P, s, e = k1.partition(n, L)
    assert P == min(L, n - 1)
    assert s[0] == 0 and e[P - 1] == n - 1
    assert bool((e[:P] - s[:P] >= 1).all())
    assert bool((s[1:P] == e[:P - 1]).all())
    assert bool((e[P:] == s[P:]).all())
    assert int((e - s).max()) <= (32 if n <= 32769 else -(-(n - 1) // 1024))
