"""Write a configuration's frozen graph: the per-output covariances of
its models from a pilot of the plain reference, and its costs, in the
graph file format that ``BLUEProblem(datafile=...)`` loads (M,
n_outputs, costs, C0 .. C{No-1}, SG, dV).

    python perfbench/reference/pilot.py <config name>

The pilot draws its inputs on the host from ``torch.Generator`` seeded
with the configuration's ``pilot.seed`` (the family's input
distribution, in draws of ``pilot.samples`` rows, keeping the first
``pilot.samples`` rows whose outputs are finite in every model, as a
problem's sampling does) and evaluates every model in the configuration's model dtype, as a pilot of the program
would; each covariance is then symmetrised and its eigenvalues clipped
at ``SPD_THRESHOLD``, the projection that a problem built from a pilot
applies.  It is run once, when a configuration is added; runs
of the benchmark only load the file.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import numpy as np
import torch

SPD_THRESHOLD = 5.0e-14
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def covariances(cfg: dict, seed: int, n: int):
    """(No, M, M) sample covariances of the pilot's outputs."""
    fam = importlib.import_module("perfbench.reference." + cfg["family"])
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    dtype = getattr(torch, cfg["model_dtype"])
    M = len(fam.costs(cfg))
    rows = []
    while sum(len(r) for r in rows) < n:
        x = fam.sampler(cfg, "cpu")(gen, n)
        o = fam.group_outputs(cfg, list(range(M)), x, dtype).double()
        rows.append(o[torch.isfinite(o).flatten(1).all(dim=1)])
    out = torch.cat(rows)[:n].numpy()                       # (n, No, M)
    return np.stack([clip(np.cov(out[:, k, :].T))
                     for k in range(out.shape[1])])


def clip(C: np.ndarray) -> np.ndarray:
    """C symmetrised, its eigenvalues raised to at least SPD_THRESHOLD."""
    w, V = np.linalg.eigh((C + C.T) / 2)
    return (V * np.maximum(w, SPD_THRESHOLD)) @ V.T


def write(cfg: dict, path: str):
    fam = importlib.import_module("perfbench.reference." + cfg["family"])
    C = covariances(cfg, cfg["pilot"]["seed"], cfg["pilot"]["samples"])
    M, No = C.shape[1], C.shape[0]
    np.savez(path, M=M, n_outputs=No, costs=fam.costs(cfg),
             SG=np.tile(np.arange(M), (No, 1)),
             dV=np.full((No, M, M), np.nan),
             **{"C%d" % k: C[k] for k in range(No)})


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           sys.argv[1] + ".json")) as f:
        config = json.load(f)
    write(config, os.path.join(ROOT, config["inputs"]))
