"""The PyTorch port imports torch, numpy and scipy only -- never jax."""

import subprocess
import sys

import torch

torch.set_num_threads(1)


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import bluest_tpu_torch as bt\n"
            "import bluest_tpu_torch.models, bluest_tpu_torch.sampling\n"
            "import bluest_tpu_torch.estimators.closed_forms\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m.startswith('bluest_tpu.') or m == 'bluest_tpu'"
            " for m in sys.modules)\n"
            "for name in ('BLUEProblem', 'MOSAP', 'SAP', 'BLUESTError'):\n"
            "    assert hasattr(bt, name), name\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
