"""The IPM's PSD-cone primitives that K3 and K4 serve, the port's against
the JAX package's, on the CPU in float64.

* ``_max_step_psd`` (K3's caller: sup {a : S + a dS >= 0} over a batch of
  blocks): the port's, from the Cholesky factor of S, against
  ``bluest_tpu.solvers.sdp._max_step_psd`` from S, to 1e-12 relative
  (inf equal to inf);
* ``_nt_scaling`` (K4's caller: the NT scaling R with R^T Z R = diag(lam)
  and R R^T = T, T Z T = S): the port's against the JAX package's.  The
  SVD inside fixes U only up to the sign of each column and the order of
  equal singular values, and R = Ls U diag(lam)^-1/2 inherits both, so R
  and Rinv themselves may differ between two correct SVDs.  Compared
  instead is what that freedom cannot move: Tinv, R R^T = T and lam
  against the JAX package's, and the port's R^T Z R against diag(lam),
  each to 1e-10 relative to the block's norm.

Seeded numpy blocks: SPD S and Z and a symmetric dS, n in {2, 11, 13,
33}, nb in {1, 3, 5}, at scales 1e-100 ... 1e100.  Well-conditioned
blocks agree to a few eps (2.8e-15 in Tinv, 2.0e-15 in the step).  An
interior-point endgame hands over ill-conditioned blocks, S and Z
complementary, where two correct solvers part by ~cond(S) eps; those
are seeded too, each with eigenvalues over three decades: 4.4e-14 in
Tinv, 8.9e-14 in T and 2.3e-14 in the step.  (At four decades one
seeded step parts by 1.05e-12, so the step's tolerance leaves room for
cond(S) up to ~1e3; the NT scaling's for more: Tinv parted by 3e-13 at
cond 1e4 and 3.5e-9 at 1e8 in a trial with independent S and Z.)

The port runs its plain versions here (``torch.linalg.eigvalsh`` and
``svd`` on CPU tensors).  Then the same blocks go through the port's
functions with K3's and K4's CPU mirror (``tests/test_torch_psd_eig.py``)
in place of the plain versions, so the kernels' rounding is held against
the JAX package too.
"""

import numpy as np
import pytest
import torch

import bluest_tpu  # noqa: F401  (float64 on the JAX side)
import jax.numpy as jnp
from bluest_tpu.solvers import sdp as jsdp
from bluest_tpu_torch.ops import psd_eig
from bluest_tpu_torch.solvers import sdp as tsdp
from test_torch_psd_eig import jacobi_eigvalsh, jacobi_svd

torch.set_num_threads(1)

NS = (2, 11, 13, 33)
NBS = (1, 3, 5)
# (scale of S and dS, scale of Z)
SCALES = ((1e-100, 1e-100), (1.0, 1.0), (1e80, 1e-80), (1e100, 1e100),
          (1e-50, 1e50))
STEP_RTOL = 1e-12
NT_RTOL = 1e-10


def _spd(rng, n, scale, spread):
    """An SPD block: random eigenvectors, eigenvalues in [0.5, 2) or, at
    ``spread`` > 0, logspaced over that many decades."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = (np.logspace(0, -spread, n) if spread else rng.uniform(0.5, 2, n))
    rng.shuffle(lam)
    X = scale * (Q * lam) @ Q.T
    return (X + X.T) / 2, Q, lam


def _blocks(n, nb, sS, sZ, endgame, seed):
    """(S, Z, dS), each (nb, n, n).  ``endgame``: S's eigenvalues over
    three decades and Z complementary (its eigenvectors S's turned by
    1e-3, its eigenvalues mu / S's times [0.5, 2))."""
    rng = np.random.default_rng(seed)
    S, Z = [], []
    for _ in range(nb):
        s, Q, lam = _spd(rng, n, sS, 3 if endgame else 0)
        if endgame:
            E = rng.standard_normal((n, n))
            Qz, _ = np.linalg.qr(Q + 1e-3 * (E - E.T))
            z = sZ * 1e-3 / lam * rng.uniform(0.5, 2, n)
            Zb = (Qz * z) @ Qz.T
            Zb = (Zb + Zb.T) / 2
        else:
            Zb = _spd(rng, n, sZ, 0)[0]
        S.append(s)
        Z.append(Zb)
    dS = rng.standard_normal((nb, n, n))
    dS = sS * (dS + dS.transpose(0, 2, 1)) / 2
    return np.stack(S), np.stack(Z), dS


def _cases():
    for n in NS:
        for nb in NBS:
            for k, (sS, sZ) in enumerate(SCALES):
                for endgame in (False, True):
                    yield pytest.param(n, nb, sS, sZ, endgame,
                                       id="n%d-nb%d-s%d-%s" % (
                                           n, nb, k, "end" if endgame
                                           else "well"))


def _step_port(S, dS):
    L = torch.linalg.cholesky(torch.from_numpy(S))
    infos = []
    a = tsdp._max_step_psd(L, torch.from_numpy(dS), infos, k=1)
    assert bool(tsdp._all_ok(infos))
    return float(a[0])


def _step_jax(S, dS):
    return float(jsdp._max_step_psd(jnp.asarray(S), jnp.asarray(dS)))


def _check_step(got, ref):
    if np.isinf(ref):
        assert got == ref
    else:
        assert abs(got - ref) <= STEP_RTOL * abs(ref), (got, ref)


def _check_nt(S, Z):
    """The port's _nt_scaling against the JAX package's, in what the
    SVD's freedom cannot move; returns the largest relative gaps."""
    Tj, Rj, _, lj = [np.asarray(x) for x in
                     jsdp._nt_scaling(jnp.asarray(S), jnp.asarray(Z))]
    infos = []
    Tt, Rt, _, lt, _, _ = tsdp._nt_scaling(torch.from_numpy(S),
                                           torch.from_numpy(Z), infos)
    assert bool(tsdp._all_ok(infos))
    Tt, Rt, lt = Tt.numpy(), Rt.numpy(), lt.numpy()
    n = S.shape[1]

    def nrm(X):
        return np.linalg.norm(X, axis=(-2, -1))

    lnrm = np.linalg.norm(lj, axis=1)
    gaps = {
        "Tinv": nrm(Tt - Tj) / nrm(Tj),
        "T": nrm(Rt @ Rt.mT - Rj @ Rj.mT) / nrm(Rj @ Rj.mT),
        "lam": np.abs(lt - lj).max(axis=1) / lnrm,
        "RZR": nrm(Rt.mT @ Z @ Rt - lt[:, :, None] * np.eye(n)) / lnrm,
    }
    for name, g in gaps.items():
        assert np.all(g <= NT_RTOL), (name, g)
    return gaps


@pytest.mark.parametrize("n, nb, sS, sZ, endgame", list(_cases()))
def test_max_step_psd_matches_jax(n, nb, sS, sZ, endgame):
    S, _, dS = _blocks(n, nb, sS, sZ, endgame, 1000 * n + 10 * nb)
    _check_step(_step_port(S, dS), _step_jax(S, dS))
    # a direction along which every block stays PSD: the step is inf
    _check_step(_step_port(S, S.copy()), _step_jax(S, S.copy()))


@pytest.mark.parametrize("n, nb, sS, sZ, endgame", list(_cases()))
def test_nt_scaling_matches_jax(n, nb, sS, sZ, endgame):
    S, Z, _ = _blocks(n, nb, sS, sZ, endgame, 2000 * n + 10 * nb)
    _check_nt(S, Z)


@pytest.fixture
def kernel_mirrors(monkeypatch):
    """The port's _eigvalsh and _svd through K3's and K4's CPU mirror."""
    monkeypatch.setattr(psd_eig, "sym_eigvalsh",
                        lambda A: jacobi_eigvalsh(A.clone())[:2])
    monkeypatch.setattr(psd_eig, "nt_svd",
                        lambda M: jacobi_svd(M.clone())[:3])


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("endgame", [False, True])
def test_kernel_mirrors_through_the_port_match_jax(kernel_mirrors, n,
                                                   endgame):
    """K3's and K4's rounding (their CPU mirror) inside the port's
    _max_step_psd and _nt_scaling, held against the JAX package at the
    same tolerances, over every scale and nb."""
    for nb in NBS:
        for k, (sS, sZ) in enumerate(SCALES):
            S, Z, dS = _blocks(n, nb, sS, sZ, endgame, 1000 * n + 10 * nb)
            _check_step(_step_port(S, dS), _step_jax(S, dS))
            S, Z, _ = _blocks(n, nb, sS, sZ, endgame, 2000 * n + 10 * nb)
            _check_nt(S, Z)
