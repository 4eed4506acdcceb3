"""bluest_tpu_torch: multilevel best linear unbiased estimation on PyTorch.

The PyTorch/CUDA port of ``bluest_tpu`` (which stays the JAX reference).
Imports torch, numpy and scipy only -- never jax.
"""

from . import config  # noqa: F401
from .sampling.host_engine import blue_fn
from .allocation import SAP, MOSAP, BLUESTError
from .problem import BLUEProblem

__all__ = ["blue_fn", "BLUEProblem", "MOSAP", "SAP", "BLUESTError"]
