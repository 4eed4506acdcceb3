"""K3 and K4 (``bluest_tpu_torch/ops/psd_eig.py``, ``csrc/psd_eig.cu``) on
the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py`` holds them
against their plain versions there).  Here a mirror of their algorithm in
plain PyTorch -- the power-of-two scaling, K3's lower triangle, the
round-robin pair order, the rotation (t = sign(tau) 2 |a_pq| / (|d| +
sqrt(d^2 + 4 a_pq^2)), c from one rsqrt), the thresholds on
squares and the norm-relative floor, K3's rotations applied to 2 x 2
blocks of two pairs, rows then columns, each block stored with its
transpose, and the closed-form diagonal, K4's one-sided rotations of the
rows of M accumulated into U, the sweep cap and the statuses -- is held
against numpy's LAPACK on seeded batches: n in {1, 2, 5, 11, 13, 33},
scales 1e-150 ... 1e150, repeated and zero eigenvalues, indefinite and
rank-deficient blocks.  Eigenvalues within 32 n eps ||A||_F; U orthogonal
within 32 n eps, U diag(S^2) U^T within 64 n eps ||M||_F^2 of M M^T, the
singular values within 32 n eps ||M||_F.  The mirror describes the warp
kernels (n <= 32); past 32 the block kernels apply the same rotations to
both triangles of K3's matrix, which then differ by rounding.  Then the
wrappers on CPU tensors (bit-equal to torch.linalg, the calls the IPM
made) and their refusals.  No jax.
"""

import os
import re

import numpy as np
import pytest
import torch

from bluest_tpu_torch.ops import psd_eig

torch.set_num_threads(1)

EPS = float(np.finfo(np.float64).eps)
MAX_SWEEPS = 40                 # csrc/psd_eig.cu: PSD_MAX_SWEEPS
NS = (1, 2, 5, 11, 13, 33)


def _round(r, n):
    """Round r of the round-robin order of n rounded up to even indices:
    the pairs (p, q), p < q, slot by slot (slot 0: (r, m); slot j:
    ((r + j) mod m, (r - j) mod m), m = n_pad - 1), the padding pair
    included."""
    half = (n + 1) // 2
    m = 2 * half - 1
    j = torch.arange(half)
    a = torch.where(j == 0, r, (r + j) % m)
    b = torch.where(j == 0, m, (r - j + m) % m)
    return torch.minimum(a, b), torch.maximum(a, b)


def _pairs(r, n):
    """The non-padding pairs (p, q), p < q, of round r."""
    p, q = _round(r, n)
    keep = q < n
    return p[keep], q[keep]


def _slots(r, n):
    """The slot of round r's pair that holds each index 0..n-1."""
    p, q = _round(r, n)
    slot = torch.empty(2 * p.numel(), dtype=torch.long)
    slot[p] = torch.arange(p.numel())
    slot[q] = torch.arange(q.numel())
    return slot[:n]


def _scaled(A, lower=False):
    """The kernels' start: non-finite blocks flagged (and zeroed here),
    K3's matrix taken from its lower triangle (``lower``), each block
    scaled by the power of two that brings its largest entry into
    [1, 2); returns (bad, scaled, exponent, ||scaled||_F^2)."""
    bad = ~torch.isfinite(A).all(dim=(1, 2))
    a = torch.where(bad[:, None, None], 0.0, A)
    if lower:
        a = torch.tril(a) + torch.tril(a, -1).mT
    mx = a.abs().amax(dim=(1, 2))
    e = torch.where(mx > 0, torch.frexp(mx).exponent - 1, 0)
    a = torch.ldexp(a, -e[:, None, None].double())
    return bad, a, e, (a * a).sum(dim=(1, 2))


def _rotation(num, diff):
    """The kernels' rotation: GVL's t = sign(tau) / (|tau| + sqrt(1 +
    tau^2)), tau = diff / 2 num, as sign(tau) 2 |num| / (|diff| +
    sqrt(diff^2 + 4 num^2)); c = rsqrt(1 + t^2), s = t c."""
    n2 = 2.0 * num.abs()
    root = torch.sqrt(diff * diff + n2 * n2)
    plus = (diff == 0) | ((diff > 0) == (num > 0))
    t = torch.where(plus, n2, -n2) / (diff.abs() + root)
    c = torch.rsqrt(1.0 + t * t)
    return t, c, t * c


def jacobi_eigvalsh(A):
    """Mirror of K3: (eigenvalues ascending, status, sweeps)."""
    B, n, _ = A.shape
    bad, a, e, f = _scaled(A, lower=True)
    floor = EPS * EPS * torch.sqrt(f)
    converged = torch.zeros(B, dtype=torch.bool)
    sweeps = 0
    rows = torch.arange(B)[:, None]
    while sweeps < MAX_SWEEPS and not bool(converged.all()):
        sweeps += 1
        rotated = torch.zeros(B, dtype=torch.bool)
        for r in range(2 * ((n + 1) // 2) - 1):
            p, q = _pairs(r, n)
            if p.numel() == 0:
                continue
            apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
            rot = (apq.abs() > floor[:, None]) & (
                apq * apq > EPS * EPS * (app * aqq).abs())
            safe = torch.where(rot, apq, 1.0)
            t, c, s = _rotation(safe, aqq - app)
            c, s = torch.where(rot, c, 1.0), torch.where(rot, s, 0.0)
            x, y = a[:, p, :], a[:, q, :]
            a[:, p, :] = c[..., None] * x - s[..., None] * y
            a[:, q, :] = s[..., None] * x + c[..., None] * y
            x, y = a[:, :, p], a[:, :, q]
            a[:, :, p] = c[:, None, :] * x - s[:, None, :] * y
            a[:, :, q] = s[:, None, :] * x + c[:, None, :] * y
            # the block of two pairs (P, Q), P < Q, is stored with its
            # transpose at (Q, P)
            slot = _slots(r, n)
            a = torch.where(slot[:, None] > slot[None, :], a.mT, a)
            dp, dq = app - t * safe, aqq + t * safe
            a[rows, p, p] = torch.where(rot, dp, a[rows, p, p])
            a[rows, q, q] = torch.where(rot, dq, a[rows, q, q])
            a[rows, p, q] = torch.where(rot, 0.0, a[rows, p, q])
            a[rows, q, p] = torch.where(rot, 0.0, a[rows, q, p])
            rotated |= rot.any(dim=1)
        converged |= ~rotated
    w = torch.ldexp(torch.diagonal(a, dim1=1, dim2=2),
                    e[:, None].double()).sort(dim=1).values
    status = torch.where(converged, 0, 2).to(torch.int32)
    status[bad] = 1
    w[bad] = float("nan")
    return w, status, sweeps


def jacobi_svd(M, floor=True):
    """Mirror of K4: (U, singular values descending, status, sweeps);
    ``floor=False`` drops the norm-relative floor (to show what it is
    for)."""
    B, n, _ = M.shape
    bad, g, e, f = _scaled(M)
    v = torch.eye(n, dtype=M.dtype).repeat(B, 1, 1)    # rows: U's columns
    floor = EPS * EPS * f if floor else torch.zeros_like(f)
    converged = torch.zeros(B, dtype=torch.bool)
    sweeps = 0
    while sweeps < MAX_SWEEPS and not bool(converged.all()):
        sweeps += 1
        rotated = torch.zeros(B, dtype=torch.bool)
        for r in range(2 * ((n + 1) // 2) - 1):
            p, q = _pairs(r, n)
            if p.numel() == 0:
                continue
            x, y = g[:, p, :], g[:, q, :]
            alpha, beta = (x * x).sum(-1), (y * y).sum(-1)
            gamma = (x * y).sum(-1)
            rot = (gamma.abs() > floor[:, None]) & (
                gamma * gamma > (n * EPS) ** 2 * alpha * beta)
            _, c, s = _rotation(torch.where(rot, gamma, 1.0), beta - alpha)
            c, s = torch.where(rot, c, 1.0)[..., None], \
                torch.where(rot, s, 0.0)[..., None]
            g[:, p, :], g[:, q, :] = c * x - s * y, s * x + c * y
            ux, uy = v[:, p, :], v[:, q, :]
            v[:, p, :], v[:, q, :] = c * ux - s * uy, s * ux + c * uy
            rotated |= rot.any(dim=1)
        converged |= ~rotated
    sig = torch.sqrt((g * g).sum(-1))
    order = torch.argsort(-sig, dim=1, stable=True)
    S = torch.ldexp(torch.gather(sig, 1, order), e[:, None].double())
    U = torch.gather(v, 1, order[:, :, None].expand(-1, -1, n)).mT
    status = torch.where(converged, 0, 2).to(torch.int32)
    status[bad] = 1
    S[bad] = float("nan")
    U[bad] = float("nan")
    return U, S, status, sweeps


def _symmetric_batch(n, seed):
    """Seeded symmetric blocks: indefinite at scales 1e-150, 1, 1e150,
    with zero eigenvalues (rank-deficient), repeated ones, eigenvalues
    spread over 1e-150 ... 1e150 with mixed signs, and a diagonal one."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in (1e-150, 1.0, 1e150):
        X = rng.standard_normal((n, n))
        out.append(scale * (X + X.T) / 2)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = rng.standard_normal(n)
    lam[: n // 2] = 0.0
    out.append(Q @ np.diag(lam) @ Q.T)
    lam = np.repeat(rng.standard_normal((n + 2) // 3), 3)[:n]
    out.append(1e-120 * Q @ np.diag(lam) @ Q.T)
    d = np.logspace(-150, 150, n) * np.where(rng.random(n) < 0.5, -1.0, 1.0)
    out.append(Q @ np.diag(d) @ Q.T)
    out.append(np.diag(rng.standard_normal(n)))
    return np.stack(out)


def _general_batch(n, seed):
    """Seeded square blocks: the symmetric ones plus a random part, half
    the columns of one zeroed (rank-deficient), one of rank one."""
    rng = np.random.default_rng(seed)
    X = _symmetric_batch(n, seed) + rng.standard_normal((7, n, n)) * np.array(
        [1e-150, 1.0, 1e150, 1.0, 1e-120, 1.0, 0.0])[:, None, None]
    X[3] = X[3] * (np.arange(n) % 2)
    u, w = rng.standard_normal(n), rng.standard_normal(n)
    X[5] = 1e100 * np.outer(u, w)
    return X


@pytest.mark.parametrize("n", NS)
def test_k3_mirror_matches_lapack(n):
    A = _symmetric_batch(n, 10 + n)
    w, status, sweeps = jacobi_eigvalsh(torch.from_numpy(A.copy()))
    assert status.tolist() == [0] * A.shape[0]
    assert sweeps < MAX_SWEEPS
    ref = np.linalg.eigvalsh(A)
    nrm = np.linalg.norm(A, axis=(1, 2))
    err = np.abs(w.numpy() - ref).max(axis=1)
    assert np.all(err <= 32 * n * EPS * nrm), err / np.maximum(nrm, 1e-300)


@pytest.mark.parametrize("n", NS)
def test_k4_mirror_matches_lapack(n):
    M = _general_batch(n, 20 + n)
    U, S, status, sweeps = jacobi_svd(torch.from_numpy(M.copy()))
    assert status.tolist() == [0] * M.shape[0]
    assert sweeps < MAX_SWEEPS
    U, S = U.numpy(), S.numpy()
    nrm = np.maximum(np.linalg.norm(M, axis=(1, 2)), 1e-300)
    orth = np.abs(np.einsum("bki,bkj->bij", U, U) - np.eye(n)).max()
    assert orth <= 32 * n * EPS
    Mn, Sn = M / nrm[:, None, None], S / nrm[:, None]
    rec = np.abs(np.einsum("bik,bk,bjk->bij", U, Sn ** 2, U)
                 - Mn @ Mn.transpose(0, 2, 1)).max()
    assert rec <= 64 * n * EPS
    assert np.all(np.diff(S, axis=1) <= 0)
    err = np.abs(S - np.linalg.svd(M, compute_uv=False)).max(axis=1)
    assert np.all(err <= 32 * n * EPS * nrm)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_mirrors_flag_non_finite_blocks(bad):
    """A block with a NaN or an inf gets status 1 and NaN results before
    any sweep; its neighbours are solved as alone."""
    A = _symmetric_batch(5, 3)
    A[2, 1, 4] = bad
    w, status, sweeps = jacobi_eigvalsh(torch.from_numpy(A.copy()))
    assert status.tolist() == [0, 0, 1, 0, 0, 0, 0]
    assert sweeps <= MAX_SWEEPS
    assert bool(w[2].isnan().all()) and not bool(w[[0, 1, 3]].isnan().any())
    keep = [0, 1, 3, 4, 5, 6]
    assert torch.equal(w[keep], jacobi_eigvalsh(
        torch.from_numpy(A[keep].copy()))[0])
    U, S, status, sweeps = jacobi_svd(torch.from_numpy(A.copy()))
    assert status.tolist() == [0, 0, 1, 0, 0, 0, 0]
    assert bool(S[2].isnan().all()) and bool(U[2].isnan().all())
    assert torch.equal(S[keep], jacobi_svd(torch.from_numpy(A[keep].copy()))[1])


def test_mirror_sweep_cap_is_the_kernels():
    """The mirrors' cap is the source's PSD_MAX_SWEEPS."""
    src = os.path.join(os.path.dirname(psd_eig.__file__), os.pardir, "csrc",
                       "psd_eig.cu")
    with open(src) as f:
        cap = re.search(r"#define PSD_MAX_SWEEPS (\d+)", f.read()).group(1)
    assert int(cap) == MAX_SWEEPS


def test_k4_mirror_without_the_floor_stalls_on_rank_deficiency():
    """Why the floor is there: on a rank-deficient M the rows that the
    rotations leave at round-off level stay nearly parallel, and without
    the floor they are rotated against each other sweep after sweep
    until they underflow; with it the solve ends in a few sweeps.  The
    thresholds compare squares, so the stall ends where the squares of
    the dot products underflow (rows below ~1e-154), nine sweeps after
    the floor would have ended it at n = 11."""
    rng = np.random.default_rng(0)
    M = torch.from_numpy(rng.standard_normal((1, 11, 11))
                         * (np.arange(11) % 2))
    _, S, status, with_floor = jacobi_svd(M.clone())
    _, S0, status0, without = jacobi_svd(M.clone(), floor=False)
    assert status.tolist() == [0] and with_floor <= 8
    assert without >= with_floor + 8
    assert float(S0.min()) < 1e-150 < float(S.min())
    np.testing.assert_allclose(S.numpy(), S0.numpy(), rtol=0,
                               atol=32 * 11 * EPS * float(M.norm()))


@pytest.mark.parametrize("n", [1, 2, 11, 13])
def test_wrappers_on_cpu_are_torch_linalg(n):
    """On CPU tensors the wrappers are the calls the IPM made before, bit
    for bit, with a zero status."""
    A = torch.from_numpy(_symmetric_batch(n, n))
    w, st = psd_eig.sym_eigvalsh(A)
    assert torch.equal(w, torch.linalg.eigvalsh(A))
    assert st.dtype == torch.int32 and st.tolist() == [0] * A.shape[0]
    M = torch.from_numpy(_general_batch(n, n))
    U, S, st = psd_eig.nt_svd(M)
    Ur, Sr, _ = torch.linalg.svd(M)
    assert torch.equal(U, Ur) and torch.equal(S, Sr)
    assert st.tolist() == [0] * M.shape[0]


def test_cpu_calls_launch_nothing():
    before = (psd_eig.sym_eigvalsh.launches, psd_eig.nt_svd.launches)
    A = torch.from_numpy(_symmetric_batch(5, 1))
    psd_eig.sym_eigvalsh(A)
    psd_eig.nt_svd(A)
    assert (psd_eig.sym_eigvalsh.launches, psd_eig.nt_svd.launches) == before


@pytest.mark.parametrize("fn", [psd_eig.sym_eigvalsh, psd_eig.nt_svd,
                                psd_eig.sym_eigvalsh_plain,
                                psd_eig.nt_svd_plain])
def test_wrappers_refuse_bad_input(fn):
    good = torch.eye(3, dtype=torch.float64)[None]
    with pytest.raises(TypeError):
        fn(good.float())
    with pytest.raises(TypeError):
        fn(good.numpy())
    with pytest.raises(ValueError):
        fn(good[0])
    with pytest.raises(ValueError):
        fn(torch.zeros(2, 3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 2, 4, dtype=torch.float64).transpose(0, 1))
    with pytest.raises(ValueError):
        fn(torch.zeros(3, 4, 4, dtype=torch.float64).transpose(1, 2))


def test_count_replay_adds_captured_launches():
    before = (psd_eig.sym_eigvalsh.launches, psd_eig.nt_svd.launches)
    try:
        psd_eig.count_replay({psd_eig.sym_eigvalsh: 3, psd_eig.nt_svd: 1})
        psd_eig.count_replay({psd_eig.sym_eigvalsh: 3, psd_eig.nt_svd: 1})
        assert psd_eig.sym_eigvalsh.launches == before[0] + 6
        assert psd_eig.nt_svd.launches == before[1] + 2
    finally:
        psd_eig.sym_eigvalsh.launches, psd_eig.nt_svd.launches = before
