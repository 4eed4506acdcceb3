"""Plain reference of the MLBLUE estimator.

For models 0 .. M-1 with covariance C (per output), a group g of models
sampled m_g times contributes m_g R_g^T C_g^-1 R_g to the information
matrix PHI(m) (R_g picks the group's models, C_g = C[g, g]).  Inverses are
pseudo-inverses (numpy's default cut, 1e-15 of the largest singular
value), as the MLBLUE formulation takes them.  The BLUE of model 0's
mean from the group sums S_g (sums over the group's samples of
its models' outputs) is

    mu = e0^T PHI^+ y,   y = sum_g R_g^T C_g^-1 S_g,   Var = e0^T PHI^+ e0,

over the models that some sampled group covers.  NumPy on the host, in
float64 (or the dtype a control asks for); written from these formulas,
sharing no code with the program.
"""

from __future__ import annotations

import numpy as np


class Groups:
    """The groups' inverse covariances for every output, by group size,
    and the BLUE from them, all in ``dtype``."""

    def __init__(self, C, groups, dtype=np.float64):
        self.dtype = dtype
        self.C = [np.asarray(c, dtype=dtype) for c in C]
        self.M = self.C[0].shape[0]
        self.groups = [tuple(int(i) for i in g) for g in groups]
        self.index = {g: j for j, g in enumerate(self.groups)}
        self.by_size = {}
        for j, g in enumerate(self.groups):
            self.by_size.setdefault(len(g), []).append(j)
        self.sizes = {}
        for k, js in self.by_size.items():
            idx = np.array([self.groups[j] for j in js], dtype=np.int64)
            inv = np.stack([np.linalg.pinv(c[np.ix_(r, r)], hermitian=True)
                            for c in self.C for r in idx]).reshape(
                                len(self.C), len(js), k, k)
            self.sizes[k] = (np.array(js), idx, inv)

    def phi(self, m):
        """(No, M, M) information matrices at m."""
        m = np.asarray(m, dtype=self.dtype)
        out = np.zeros((len(self.C), self.M, self.M), dtype=self.dtype)
        for k, (js, idx, inv) in self.sizes.items():
            w = m[js]
            for a in range(k):
                for b in range(k):
                    np.add.at(out, (slice(None), idx[:, a], idx[:, b]),
                              w[None, :] * inv[:, :, a, b])
        return out

    def covered(self, m):
        m = np.asarray(m, dtype=np.float64)
        cov = np.zeros(self.M, dtype=bool)
        for j, g in enumerate(self.groups):
            if m[j] > 0:
                cov[list(g)] = True
        return np.flatnonzero(cov)

    def estimate(self, m, sums):
        """(mus, variances): ``sums[n][j]`` is the (k,) sum of the
        outputs n of group j's models over its samples."""
        idx = self.covered(m)
        mus, var = [], []
        P = self.phi(m)
        for n in range(len(self.C)):
            y = np.zeros(self.M, dtype=self.dtype)
            for k, (js, gidx, inv) in self.sizes.items():
                for t, j in enumerate(js):
                    if m[j] > 0:
                        y[gidx[t]] += inv[n, t] @ np.asarray(
                            sums[n][j], dtype=self.dtype)
            pinv = np.linalg.pinv(P[n][np.ix_(idx, idx)], hermitian=True)
            mus.append(float(pinv[0] @ y[idx]))
            var.append(float(pinv[0, 0]))
        return np.array(mus), np.array(var)
