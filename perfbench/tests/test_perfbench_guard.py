"""What a run may load and where it may run: JAX and the JAX package are
told apart from the port by whole top-level names, the benchmark's
sources import neither, the reference imports nothing of the port, and
the runner refuses a machine without a card."""

import ast
import glob
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from perfbench import harness


@pytest.mark.parametrize("modules, found", [
    ({"bluest_tpu_torch", "bluest_tpu_torch.ops.diffusion", "numpy"}, []),
    ({"bluest_tpu.models", "bluest_tpu_torch"}, ["bluest_tpu"]),
    ({"jax.numpy", "jaxlib"}, ["jax", "jaxlib"]),
    ({"flax.linen"}, ["flax"]),
    ({"jaxtyping", "bluest_tpu_tools"}, []),
])
def test_forbidden_modules_by_whole_name(modules, found):
    assert harness.forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                           recursive=True))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    if "/reference/" in path:
        assert "bluest_tpu_torch" not in tops
        assert not {m for m in _imports(path) if m.startswith("perfbench.")
                    and not m.startswith("perfbench.reference")}


def test_runner_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "hh12.estimate_k3", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = harness.main(["--workload", "hh12.estimate_k3", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    rc = harness.main(["--workload", "hh12.estimate_k3", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"]
