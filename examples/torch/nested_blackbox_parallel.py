"""Nested parallelism for internally-parallel black-box models, on
bluest_tpu_torch.

The reference's headline pattern (README.md:26, demonstrated in
examples/paper_examples/restrictions_matern/restrictions_matern.py:19-37):
the user's model is itself parallel -- there, an MPI-parallel FEniCS
solver on a split communicator.  Here the same capability without MPI:

    params['host_workers']  = W   # W independent sample streams
    params['model_workers'] = G   # G processes cooperate per evaluation

The engine launches W groups of G processes; within a group every rank
runs the same sample stream and ``evaluate`` coordinates its ranks
through the MPI-like communicator returned by ``problem.get_comm()``
(rank/size/barrier/bcast/gather/allgather/allreduce).

The toy model below integrates a random field over a domain that is
decomposed across the group's ranks -- the structure of any
domain-decomposed PDE solver.  A black-box model runs on the host; the
cross-check at the end draws the same two sample streams in this
process, without a pool, so the two covariance estimates agree.

Run:  python examples/torch/nested_blackbox_parallel.py
(--device names the device the problem allocates on -- the covariance
projection and the MOSAP -- and torch models sample on; this model runs
on the host either way.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

from bluest_tpu_torch import BLUEProblem

M = 3                      # fidelities = quadrature resolutions
CELLS = (256, 64, 16)      # cells per fidelity
PILOT = 256


class DomainDecomposedProblem(BLUEProblem):
    """Black-box model: output = integral of exp(sin(8x + z)) over [0,1],
    midpoint rule with CELLS[l] cells, cells partitioned across the
    model group's ranks."""

    def set_worker_id(self, wid):
        # one RNG per sample stream (= per group); MANDATORY for
        # host_workers > 1 -- all ranks of a group share the stream
        self._rng = np.random.default_rng(123 + wid)

    def sampler(self, ls, N=1):
        if not hasattr(self, "_rng"):
            self._rng = np.random.default_rng(0)
        z = float(self._rng.standard_normal())
        return [z for _ in ls]

    def evaluate(self, ls, samples, N=1):
        comm = self.get_comm()                 # None when serial
        rank = comm.rank if comm is not None else 0
        size = comm.size if comm is not None else 1
        out = []
        for i, l in enumerate(ls):
            n = CELLS[l]
            # this rank's slice of the domain
            cells = np.arange(rank, n, size)
            x = (cells + 0.5) / n
            partial = float(np.sum(np.exp(np.sin(8 * x + samples[i]))) / n)
            total = (comm.allreduce(partial) if comm is not None
                     else partial)
            out.append(total)
        return [out]


def main(argv=None):
    """Run the study; returns what it printed as a dict."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="allocation device, and sampling device of "
                             "torch models (default: the card); this host "
                             "model samples on the host")
    args = parser.parse_args(argv)

    costs = np.array([float(c) for c in CELLS])
    p = DomainDecomposedProblem(
        M, C=np.full((M, M), np.nan), costs=costs,
        covariance_estimation_samples=PILOT, device=args.device,
        host_workers=2, model_workers=2, verbose=False)

    C = p.get_covariance()
    print("estimated covariance diagonal:", np.round(np.diag(C), 5))

    eps = 0.02 * np.sqrt(C[0, 0])
    p.setup_solver(K=2, eps=eps)
    mus, errs, cost = p.solve(K=2, eps=eps)
    print(f"estimate {mus[0]:.5f} +- {errs[0]:.5f}  (cost {cost:.0f})")

    # cross-check on the same seeds: the same two sample streams (the
    # pool splits the pilot between them, the first takes the remainder),
    # every evaluation in this process over the whole domain
    ps = DomainDecomposedProblem(M, C=np.eye(M), costs=costs,
                                 device=args.device, verbose=False)
    rows = []
    for wid, n in enumerate((PILOT - PILOT // 2, PILOT // 2)):
        ps.set_worker_id(wid)
        rows += [ps.evaluate(range(M), ps.sampler(range(M)))[0]
                 for _ in range(n)]
    # the pilot's covariance (divided by N), projected as the pilot's is
    Cs = DomainDecomposedProblem(
        M, C=np.cov(np.array(rows), rowvar=False, bias=True), costs=costs,
        device=args.device, verbose=False).get_covariance()
    print("serial covariance diagonal:   ", np.round(np.diag(Cs), 5))
    return {"diagonal": np.diag(C), "serial_diagonal": np.diag(Cs),
            "mu": float(mus[0]), "err": float(errs[0]), "cost": float(cost)}


if __name__ == "__main__":
    main()
