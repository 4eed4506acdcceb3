"""K5 (``bluest_tpu_torch/ops/psd_eig.py``: ``sym_eigh`` and ``pinv00``,
``csrc/psd_eig.cu``) on the CPU.

The kernel runs only on a card (``tests/test_torch_cuda.py`` holds it
against its plain versions there).  Here a mirror of its algorithm in
plain PyTorch -- K3's mirror (``test_torch_psd_eig.jacobi_eigvalsh``:
the scaling, the lower triangle, the round-robin pairs, the rotation,
the thresholds and the floor) with each round's rotations accumulated
into V on its columns p and q, V J -- is held against numpy's LAPACK on
the seeded blocks of K3's tests (n in {1, 2, 5, 10, 11, 12, 13, 33},
scales 1e-150 ... 1e150, repeated and zero eigenvalues): eigenvalues
within 32 n eps ||A||_F, ||V^T V - I||_F <= 32 n eps, ||V diag(w) V^T -
A||_F <= 64 n eps ||A||_F.  Its eigenvalues are K3's mirror's bit for
bit.  Its pinv(A)[0, 0] (the row e0^T V alone, the cutoff |w| > rcond
max|w|) against the JAX package's ``integer._chunk_var00`` on seeded
PHIs of a flagship-width psi (M=10): |d| <= 64 n eps kappa |var|, kappa =
max|w| / min kept |w|; blocks with an eigenvalue within 1e-3 relative of
the cutoff, where either side may keep it, are counted and left out.
Then the wrappers on CPU tensors (the torch.linalg calls the allocation
made before, bit for bit) and the sites that call them.
"""

import os
import re
from itertools import combinations

import numpy as np
import pytest
import torch

from bluest_tpu.solvers import integer as jinteger
from bluest_tpu_torch.core import GroupStructure, psi as tpsi
from bluest_tpu_torch.linalg import spd
from bluest_tpu_torch.ops import psd_eig

from test_torch_cuda import _flagship_width
from test_torch_psd_eig import (EPS, MAX_SWEEPS, _pairs, _rotation, _scaled,
                                _slots, _symmetric_batch, jacobi_eigvalsh)

torch.set_num_threads(1)

NS = (1, 2, 5, 10, 11, 12, 13, 33)
RCOND_SEARCH = 1.0e-10          # bluest_tpu/solvers/integer.py:_PINV_RCOND


def jacobi_eigh(A):
    """Mirror of K5: (eigenvalues ascending, V with its columns moved
    alike, e0^T V and the unsorted scaled-back diagonal, status, sweeps).
    K3's mirror, round for round, with V J applied to V's columns."""
    B, n, _ = A.shape
    bad, a, e, f = _scaled(A, lower=True)
    floor = EPS * EPS * torch.sqrt(f)
    V = torch.eye(n, dtype=A.dtype).repeat(B, 1, 1)
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
            slot = _slots(r, n)
            a = torch.where(slot[:, None] > slot[None, :], a.mT, a)
            dp, dq = app - t * safe, aqq + t * safe
            a[rows, p, p] = torch.where(rot, dp, a[rows, p, p])
            a[rows, q, q] = torch.where(rot, dq, a[rows, q, q])
            a[rows, p, q] = torch.where(rot, 0.0, a[rows, p, q])
            a[rows, q, p] = torch.where(rot, 0.0, a[rows, q, p])
            # K5: V J on the rotating pairs' columns (a pair that does
            # not rotate keeps its columns, as the kernel skips it)
            x, y = V[:, :, p], V[:, :, q]
            rc, rs = rot[:, None, :], (c[:, None, :], s[:, None, :])
            V[:, :, p] = torch.where(rc, rs[0] * x - rs[1] * y, x)
            V[:, :, q] = torch.where(rc, rs[1] * x + rs[0] * y, y)
            rotated |= rot.any(dim=1)
        converged |= ~rotated
    d = torch.ldexp(torch.diagonal(a, dim1=1, dim2=2), e[:, None].double())
    w, order = torch.sort(d, dim=1, stable=True)
    Vs = torch.gather(V, 2, order[:, None, :].expand(-1, n, -1))
    status = torch.where(converged, 0, 2).to(torch.int32)
    status[bad] = 1
    w[bad] = float("nan")
    Vs[bad] = float("nan")
    return w, Vs, V[:, 0, :], d, status, sweeps


def pinv00_mirror(A, rcond):
    """Mirror of K5's pinv00: sum over |w_j| > rcond max|w| of
    u_j (1 / w_j) u_j, u = e0^T V, on the unsorted diagonal."""
    _, _, u, d, status, _ = jacobi_eigh(A)
    cutoff = rcond * d.abs().amax(dim=1, keepdim=True)
    term = torch.where(d.abs() > cutoff, u * (1.0 / d) * u, 0.0)
    var = term.sum(dim=1)
    var[status == 1] = float("nan")
    return var, status


@pytest.mark.parametrize("n", NS)
def test_k5_mirror_matches_lapack(n):
    A = _symmetric_batch(n, 10 + n)
    w, V, _, _, status, sweeps = jacobi_eigh(torch.from_numpy(A.copy()))
    assert status.tolist() == [0] * A.shape[0]
    assert sweeps < MAX_SWEEPS
    w, V = w.numpy(), V.numpy()
    nrm = np.maximum(np.linalg.norm(A, axis=(1, 2)), 1e-300)
    err = np.abs(w - np.linalg.eigvalsh(A)).max(axis=1)
    assert np.all(err <= 32 * n * EPS * nrm), err / nrm
    orth = np.linalg.norm(V.transpose(0, 2, 1) @ V - np.eye(n), axis=(1, 2))
    assert np.all(orth <= 32 * n * EPS), orth
    wn = w / nrm[:, None]
    rec = np.linalg.norm(np.einsum("bik,bk,bjk->bij", V, wn, V)
                         - A / nrm[:, None, None], axis=(1, 2))
    assert np.all(rec <= 64 * n * EPS), rec


@pytest.mark.parametrize("n", NS)
def test_k5_mirror_eigenvalues_are_k3s(n):
    """K5 is K3 with its rotations accumulated: the same eigenvalues, bit
    for bit, the same statuses and sweeps."""
    A = torch.from_numpy(_symmetric_batch(n, 30 + n))
    w, _, _, _, status, sweeps = jacobi_eigh(A.clone())
    w3, status3, sweeps3 = jacobi_eigvalsh(A.clone())
    assert torch.equal(w, w3)
    assert torch.equal(status, status3) and sweeps == sweeps3


def _flagship_phis(seed, B):
    """B seeded PHI = psi @ m of one flagship-width output (M=10, K=4,
    the seeded covariances of the allocation tests): m integer on ~5% of
    the 385 groups for the even blocks, on 2 or 3 groups for the odd ones,
    whose PHIs are then singular, so the cutoff decides."""
    M = 10
    C = _flagship_width("cpu").get_covariance(0)
    groups = [[list(g) for g in combinations(range(M), k)]
              for k in range(1, 5)]
    data = tpsi.GroupData.build(GroupStructure(M, groups, C=C), device="cpu")
    psi = data.psi.numpy()
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 2000, (psi.shape[1], B)).astype(float)
    m[rng.random(m.shape) < 0.95] = 0.0
    for b in range(1, B, 2):
        keep = rng.choice(psi.shape[1], 2 + b % 3 // 2, replace=False)
        m[:, b] = 0.0
        m[keep, b] = rng.integers(1, 2000, len(keep))
    return (psi @ m).T.reshape(B, M, M)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k5_mirror_pinv00_matches_jax(seed):
    """The mirror's pinv(PHI)[0, 0] against the JAX package's
    _chunk_var00 on the same PHIs, and the port's plain version (the host
    path) likewise."""
    phis = _flagship_phis(seed, 256)
    n = phis.shape[1]
    ref = np.asarray(jinteger._chunk_var00(phis))
    w = np.linalg.eigvalsh(phis)
    aw = np.abs(w)
    cutoff = RCOND_SEARCH * aw.max(axis=1, keepdims=True)
    near = (np.abs(aw - cutoff) <= 1e-3 * cutoff).any(axis=1)
    kept = np.where(aw > cutoff, aw, np.inf).min(axis=1)
    kappa = aw.max(axis=1) / kept
    tol = 64 * n * EPS * kappa * np.abs(ref)
    got, status = pinv00_mirror(torch.from_numpy(phis.copy()), RCOND_SEARCH)
    plain, pstatus = psd_eig.pinv00_plain(torch.from_numpy(phis.copy()),
                                          RCOND_SEARCH)
    assert status.tolist() == [0] * len(phis) == pstatus.tolist()
    print("seed %d: %d of %d blocks with an eigenvalue within 1e-3 of the "
          "cutoff, left out; kappa up to %.3g"
          % (seed, int(near.sum()), len(phis), kappa[~near].max()))
    assert near.sum() < len(phis) // 4
    assert (aw <= cutoff).any(axis=1).sum() >= len(phis) // 2
    for name, v in (("mirror", got.numpy()), ("plain", plain.numpy())):
        d = np.abs(v - ref)[~near]
        assert np.all(d <= tol[~near]), (name, (d / tol[~near]).max())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_k5_mirror_flags_non_finite_blocks(bad):
    A = _symmetric_batch(5, 3)
    A[2, 4, 1] = bad
    w, V, _, _, status, _ = jacobi_eigh(torch.from_numpy(A.copy()))
    assert status.tolist() == [0, 0, 1, 0, 0, 0, 0]
    assert bool(w[2].isnan().all()) and bool(V[2].isnan().all())
    assert not bool(w[[0, 1, 3]].isnan().any())
    var, status = pinv00_mirror(torch.from_numpy(A.copy()), 1e-10)
    assert status.tolist() == [0, 0, 1, 0, 0, 0, 0]
    assert bool(var[2].isnan()) and not bool(var[[0, 1, 3]].isnan().any())


def test_k5_shares_k3s_sweep_cap_and_has_its_entry_points():
    src = os.path.join(os.path.dirname(psd_eig.__file__), os.pardir, "csrc",
                       "psd_eig.cu")
    with open(src) as f:
        text = f.read()
    assert int(re.search(r"#define PSD_MAX_SWEEPS (\d+)", text).group(1)) \
        == MAX_SWEEPS
    for name in ("bluest_sym_eigh_f64", "bluest_pinv00_f64"):
        assert 'extern "C" int %s(' % name in text


@pytest.mark.parametrize("n", [1, 2, 10, 13])
def test_k5_wrappers_on_cpu_are_torch_linalg(n):
    """On CPU tensors sym_eigh is torch.linalg.eigh and pinv00 the corner
    search's arithmetic before K5, bit for bit, with a zero status."""
    A = torch.from_numpy(_symmetric_batch(n, n))
    w, V, st = psd_eig.sym_eigh(A)
    wr, Vr = torch.linalg.eigh(A)
    assert torch.equal(w, wr) and torch.equal(V, Vr)
    assert st.dtype == torch.int32 and st.tolist() == [0] * A.shape[0]
    var, st = psd_eig.pinv00(A, 1e-10)
    cut = 1e-10 * wr.abs().max(dim=-1, keepdim=True).values
    inv = torch.where(wr.abs() > cut, 1.0 / wr, torch.zeros((), dtype=wr.dtype))
    v0 = Vr[:, 0, :]
    assert torch.equal(var, torch.sum(v0 * inv * v0, dim=-1))
    assert st.tolist() == [0] * A.shape[0]


def test_k5_cpu_calls_launch_nothing():
    before = (psd_eig.sym_eigh.launches, psd_eig.pinv00.launches)
    A = torch.from_numpy(_symmetric_batch(5, 1))
    psd_eig.sym_eigh(A)
    psd_eig.pinv00(A, 1e-12)
    assert (psd_eig.sym_eigh.launches, psd_eig.pinv00.launches) == before


@pytest.mark.parametrize("fn", [psd_eig.sym_eigh, psd_eig.sym_eigh_plain,
                                lambda A: psd_eig.pinv00(A, 1e-10),
                                lambda A: psd_eig.pinv00_plain(A, 1e-10)])
def test_k5_wrappers_refuse_bad_input(fn):
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
        fn(torch.zeros(3, 4, 4, dtype=torch.float64).transpose(1, 2))


def test_require_converged_raises_on_a_spent_sweep_budget():
    psd_eig.require_converged(torch.tensor([0, 1, 0], dtype=torch.int32), "x")
    with pytest.raises(torch.linalg.LinAlgError, match="matrix 2"):
        psd_eig.require_converged(torch.tensor([0, 1, 2], dtype=torch.int32),
                                  "x")


def test_require_converged_on_read_statuses_and_strict_on_request():
    """An array already read (the corner search's gathered statuses) is
    checked as a tensor is; ``strict`` (the interior-point solver's start
    and polish) raises on a non-finite block and on a Cholesky
    factorization's status as well."""
    psd_eig.require_converged(np.array([0.0, 1.0]), "x")
    with pytest.raises(torch.linalg.LinAlgError, match="matrix 1"):
        psd_eig.require_converged(np.array([0.0, 2.0, 1.0]), "x")
    with pytest.raises(torch.linalg.LinAlgError, match="matrix 1 .*status 1"):
        psd_eig.require_converged(torch.tensor([0, 1], dtype=torch.int32),
                                  "x", strict=True)
    with pytest.raises(torch.linalg.LinAlgError, match="matrix 0 .*status 3"):
        psd_eig.require_converged(torch.tensor([3, 0], dtype=torch.int32),
                                  "x", strict=True)


def test_sites_on_cpu_compute_what_they_did():
    """clip_spd and _pinv_h on the host are their torch.linalg.eigh forms
    bit for bit; variance is pinv00's sum, within round-off of the
    pseudo-inverse's [0, 0]."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((10, 10))
    C = torch.from_numpy(X @ X.T - 2.0 * np.eye(10))
    S = (C + C.T) / 2
    w, V = torch.linalg.eigh(S)
    assert torch.equal(spd.clip_spd(C, 1e-3),
                       (V * torch.clamp(w, min=1e-3)) @ V.T)
    cut = 1e-12 * torch.max(torch.abs(w))
    inv = torch.where(torch.abs(w) > cut, 1.0 / w,
                      torch.zeros((), dtype=w.dtype))
    P = (V * inv) @ V.T
    assert torch.equal(tpsi._pinv_h(C), P)
    phi = _flagship_phis(7, 1)[0]
    data = tpsi.GroupData(M=10, L=1, onehots=(), invcovs=(), cumsizes=(),
                          psi=torch.from_numpy(phi.reshape(-1, 1)))
    m = torch.ones(1, dtype=torch.float64)
    wv, Vv = torch.linalg.eigh(torch.from_numpy(phi))
    ref = float(((Vv / wv) @ Vv.T)[0, 0])
    assert abs(float(tpsi.variance(data, m)) - ref) <= 1e-12 * abs(ref)
