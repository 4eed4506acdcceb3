"""The port's examples (examples/torch/) on the CPU at cut sizes, with the
gates that chip_smoke.py phase 9 holds on the card, and the parity of the
Navier-Stokes study's offline allocation with the JAX package on the same
graph.

Each example runs in a child process through its ``main([...])``, with
``--device cpu`` and its cut-size constants set on the module; the child
also reports which modules it imported, so each run shows that the
example leaves jax and bluest_tpu out of ``sys.modules``.
"""

import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from bluest_tpu import BLUEProblem as JaxBLUEProblem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "torch")

# the child: import the script, set its constants, count the chunk
# evaluations that sampling asks for (chip_smoke's own count) and the
# model evaluations it makes (on the card each of the diffusion model's
# is one K1 launch), run main
_CHILD = """
import pickle, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
sys.path.insert(0, {where!r})
import chip_smoke
from bluest_tpu_torch.models.diffusion import DiffusionProblem

model_evals = [0]
real_eval = DiffusionProblem.evaluate_model

def evaluate(self, l, x):
    model_evals[0] += 1
    return real_eval(self, l, x)

DiffusionProblem.evaluate_model = evaluate

if __name__ == "__main__":
    import importlib
    mod = importlib.import_module({name!r})
    for k, v in {patches!r}.items():
        setattr(mod, k, v)
    with chip_smoke.counting_chunk_evals() as chunk_evals:
        res = mod.main({argv!r})
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "bluest_tpu"))
    counts = {{"chunk_evals": chunk_evals[0], "model_evals": model_evals[0]}}
    with open({out!r}, "wb") as f:
        pickle.dump({{"res": res, "leaked": leaked, "counts": counts}}, f)
"""


def run_script(name, argv, tmp_path, where=EXAMPLES, **patches):
    """``main(argv + ["--device", "cpu"])`` of a script in a child
    process: (result, printed text, counts); fails if the child imported
    jax or bluest_tpu."""
    out = str(tmp_path / (name + ".pkl"))
    code = _CHILD.format(root=ROOT, where=where, name=name, patches=patches,
                         argv=list(argv) + ["--device", "cpu"], out=out)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["leaked"] == [], got["leaked"]
    return got["res"], proc.stdout, got["counts"]


@pytest.fixture(autouse=True)
def _cold_ipm():
    """Every test starts with both packages' warm-start caches empty."""
    from bluest_tpu.solvers import sdp as sdp_j
    from bluest_tpu_torch.solvers import sdp as sdp_t
    sdp_t._WARM_CACHE.clear()
    sdp_j._WARM_CACHE.clear()


def test_single_output_diffusion(tmp_path):
    """Phase 9(a) at grids 64..8: MLBLUE within 4 error bars of an MC
    estimate of model 0, complexity rate in [1.9, 2.1], variance_test
    ratio in [0.5, 1.6], one model evaluation per chunk evaluation."""
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    grids = (64, 32, 16, 8)
    res, text, counts = run_script("single_output_diffusion", ["--tests"],
                                   tmp_path, GRIDS=grids, PILOT=2048)
    assert "MLBLUE estimate" in text
    assert counts["model_evals"] == counts["chunk_evals"] > 0
    p = DiffusionProblem(grids=grids, n_kl=32, sigma=1.0, nu=0.6,
                         C=np.eye(4), costs=np.ones(4), device="cpu",
                         verbose=False)
    q = p.evaluate_model(0, p.sample_inputs(
        torch.Generator().manual_seed(8), 1 << 16))[:, 0].numpy()
    chip_smoke._within_bars("MLBLUE vs MC", [res["mu"]], [res["err"]],
                            [q.mean()], [q.std() / math.sqrt(q.size)])
    assert 1.9 <= res["complexity_rate"] <= 2.1
    ratio = res["variance_empirical"] / res["variance_predicted"]
    assert np.all((ratio >= 0.5) & (ratio <= 1.6)), ratio


def test_matern_restrictions(tmp_path):
    """Phase 9(b) at grids 16..2: every allocation meets its eps, the
    estimate is finite with a positive error."""
    res, text, _ = run_script("matern_restrictions", [], tmp_path,
                              GRIDS=(16, 8, 4, 2), N_EXACT=1024,
                              PILOTS=[32, 128])
    assert [a["pilot"] for a in res["allocations"]] == [1024, 32, 128]
    for a in res["allocations"]:
        assert np.all(a["errors"] <= 1.0001 * np.asarray(a["eps"])), a
    assert np.isfinite(res["mu"]) and res["err"] > 0
    assert "MLBLUE estimate" in text


def test_multi_output_hodgkin_huxley_fast(tmp_path):
    """Phase 9(c) with --fast: every estimate and error finite, output 0
    within 4 error bars of an MC estimate of model 0."""
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    subset = ((0, 0.02), (0, 0.04), (1, 0.02), (1, 0.04), (2, 0.02),
              (2, 0.04))
    res, _, _ = run_script("multi_output_hodgkin_huxley", ["--fast"],
                           tmp_path)
    assert tuple(res["models"]) == subset
    est, errs = np.asarray(res["estimates"]), np.asarray(res["errors"])
    assert est.shape == (5,) and np.all(np.isfinite(est))
    assert np.all(np.isfinite(errs))
    p = hh.HodgkinHuxleyProblem(models=subset, C=[np.eye(6)] * 5,
                                device="cpu", verbose=False)
    q = hh.hh_outputs(*subset[0], p.sample_group(
        torch.Generator().manual_seed(9), (0,), 4096))[:, 0].numpy()
    chip_smoke._within_bars("output 0 vs MC", est[:1], errs[:1],
                            [q.mean()], [q.std() / math.sqrt(q.size)])


@pytest.fixture(scope="module")
def ns_graph(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ns") / "ns_graph.npz")
    chip_smoke.write_ns_graph(path)
    return path


def test_navier_stokes_study(tmp_path, ns_graph):
    """Phase 9(d) on the written graph: 12 models, 6 outputs, MLBLUE's
    offline cost at most MFMC's and MLMC's, the surrogate's estimates
    within 5 predicted RMSEs of the known means."""
    with np.load(ns_graph, allow_pickle=True) as z:
        assert (int(z["M"]), int(z["n_outputs"])) == (12, 6)
        np.testing.assert_array_equal(z["costs"], 2.0 ** (11 - np.arange(12)))
    res, text, _ = run_script("navier_stokes_study", [], tmp_path,
                              NS_NPZ=ns_graph)
    c = res["costs"]
    assert c["mlblue"] <= min(c["mfmc"], c["mlmc"]), c
    assert res["within_5_rmse"] and len(res["estimates"]) == 6
    errs = np.asarray(res["errors"])
    assert np.all(np.abs(res["estimates"] - np.arange(1.0, 7.0))
                  < 5 * errs)
    assert "estimates within 5x predicted RMSE: True" in text


def test_navier_stokes_study_without_its_npz(tmp_path):
    """Without the study's npz the script says so and returns."""
    res, text, _ = run_script("navier_stokes_study", [], tmp_path,
                              NS_NPZ=str(tmp_path / "absent.npz"))
    assert res is None and "not mounted" in text


def test_nested_blackbox_parallel(tmp_path):
    """Phase 9(e): the nested pools' covariance diagonal equals the
    one-process evaluations' on the same streams at 5 decimals."""
    res, text, _ = run_script("nested_blackbox_parallel", [], tmp_path)
    np.testing.assert_array_equal(np.round(res["diagonal"], 5),
                                  np.round(res["serial_diagonal"], 5))
    assert np.isfinite(res["mu"]) and res["err"] > 0
    assert "serial covariance diagonal" in text


def test_navier_stokes_offline_matches_the_jax_package(ns_graph):
    """The study's offline part on the same graph in both packages:
    MLBLUE cost within 1e-4, MLMC and MFMC closed forms within 1e-10."""
    sys.path.insert(0, EXAMPLES)
    try:
        from navier_stokes_study import NSOffline
    finally:
        sys.path.remove(EXAMPLES)
    pt = NSOffline(12, n_outputs=6, datafile=ns_graph, device="cpu",
                   verbose=False)
    pj = JaxBLUEProblem(12, n_outputs=6, datafile=ns_graph, verbose=False)
    for n in range(6):
        np.testing.assert_array_equal(pt.get_covariance(n),
                                      pj.get_covariance(n))
    eps = 1e-3 * np.sqrt([c[0, 0] for c in pt.get_covariances()])
    bt, bj = pt.setup_solver(K=3, eps=eps), pj.setup_solver(K=3, eps=eps)
    assert abs(bt["total_cost"] - bj["total_cost"]) <= 1e-4 * bj["total_cost"]
    for setup in ("setup_mlmc", "setup_mfmc"):
        ct = getattr(pt, setup)(eps=eps)["total_cost"]
        cj = getattr(pj, setup)(eps=eps)["total_cost"]
        assert abs(ct - cj) <= 1e-10 * abs(cj), (setup, ct, cj)
