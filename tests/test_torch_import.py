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
            "import bluest_tpu_torch.progress, bluest_tpu_torch.parallel\n"
            "import bluest_tpu_torch.parallel.hostcomm\n"
            "import bluest_tpu_torch.parallel.mesh\n"
            "import bluest_tpu_torch.profiling\n"
            "import bluest_tpu_torch.linalg.spg, bluest_tpu_torch.linalg.spd\n"
            "import bluest_tpu_torch.sampling.snapshots\n"
            "import bluest_tpu_torch.sampling.host_engine\n"
            "import bluest_tpu_torch.sampling.group_engine\n"
            "import bluest_tpu_torch.models.analytic\n"
            "import bluest_tpu_torch.models.matern2d\n"
            "import bluest_tpu_torch.models.hodgkin_huxley\n"
            "import bluest_tpu_torch.ops._build\n"
            "import bluest_tpu_torch.ops.diffusion\n"
            "import bluest_tpu_torch.ops.hodgkin_huxley\n"
            "import bluest_tpu_torch.solvers.admm\n"
            "import bluest_tpu_torch.solvers.spg_alloc\n"
            "import bluest_tpu_torch.solvers.sdp\n"
            "import bluest_tpu_torch.solvers.integer\n"
            "import bluest_tpu_torch.allocation.polish\n"
            "import bluest_tpu_torch.allocation.sap\n"
            "import bluest_tpu_torch.allocation.mosap\n"
            "import bluest_tpu_torch._native\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m.startswith('bluest_tpu.') or m == 'bluest_tpu'"
            " for m in sys.modules)\n"
            "for name in ('blue_fn', 'BLUEProblem', 'MOSAP', 'SAP',\n"
            "             'BLUESTError'):\n"
            "    assert hasattr(bt, name), name\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_mesh_module_and_smoke_script_leave_jax_out():
    """``bluest_tpu_torch.parallel.mesh`` imports torch only and exports
    the JAX package's names; importing ``chip_smoke`` (the on-card smoke
    script at the root of the repo) imports neither package of JAX."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import bluest_tpu_torch.parallel.mesh as mesh\n"
            "import bluest_tpu_torch.parallel as par\n"
            "for name in ('SAMPLE_AXIS', 'MODEL_AXIS', 'sample_mesh',\n"
            "             'sample_model_mesh', 'dcn_sample_model_mesh',\n"
            "             'initialize_distributed', 'fetch_global'):\n"
            "    assert getattr(par, name) is getattr(mesh, name), name\n"
            "assert (par.SAMPLE_AXIS, par.MODEL_AXIS) == ('samples', 'model')\n"
            "for name in ('_coord_barrier', '_warm_mesh_cliques'):\n"
            "    assert not hasattr(mesh, name), name\n"
            "import chip_smoke\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m.startswith('bluest_tpu.') or m == 'bluest_tpu'"
            " for m in sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
