"""Process meshes over ``torch.distributed``.

Port of ``bluest_tpu/parallel/mesh.py``.  The reference distributes Monte
Carlo sampling with mpi4py (blue_fn.py:9, 106-110, 179-187); the JAX
package does so with a ``jax.sharding.Mesh``.  Here a mesh is a small
object over the ranks of an initialised ``torch.distributed`` job: the
sample axis replaces the MPI rank split (each sample rank evaluates a
block of whole chunks of every dispatch), one ``all_reduce(SUM)`` over the
sample group replaces ``allreduce``/``psum``, and a second 'model' axis
serves models that are themselves distributed (the nested-communicator
pattern of the reference, blue_models.py:121-130).

Ranks are laid out row-major, ``rank = sample_rank * n_model +
model_rank``, so the ranks of one model instance are neighbours.  Every
rank of the job makes every call of this module that builds a mesh (the
process groups are created collectively), and later reaches the same
collectives in the same order.  Nothing here switches backend or device
on failure: a mesh without an initialised process group raises, and
``nccl`` without a card raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import profiling

SAMPLE_AXIS = "samples"
MODEL_AXIS = "model"


def _require_initialized() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "bluest_tpu_torch.parallel.initialize_distributed (or "
            "torch.distributed.init_process_group) on every rank before "
            "building a mesh")


def _comm_device(group) -> torch.device:
    """Where a tensor must lie for a collective over ``group``: the
    rank's card for ``nccl``, the host for every other backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """This rank's view of a (samples x model) process mesh: the two
    process groups it belongs to, its coordinates and the axis sizes.
    Built by :func:`sample_mesh`, :func:`sample_model_mesh` and
    :func:`dcn_sample_model_mesh`."""

    def __init__(self, group, sample_group, model_group, sample_rank: int,
                 model_rank: int, n_sample: int, n_model: int):
        self.group = group                  # every rank of the mesh
        self.sample_group = sample_group    # ranks sharing this model_rank
        self.model_group = model_group      # ranks sharing this sample_rank
        self.sample_rank = int(sample_rank)
        self.model_rank = int(model_rank)
        self.n_sample = int(n_sample)
        self.n_model = int(n_model)

    @property
    def axis_names(self):
        return ((SAMPLE_AXIS, MODEL_AXIS) if self.model_group is not None
                else (SAMPLE_AXIS,))

    @property
    def shape(self):
        full = {SAMPLE_AXIS: self.n_sample, MODEL_AXIS: self.n_model}
        return {ax: full[ax] for ax in self.axis_names}

    @property
    def is_root(self) -> bool:
        """The one rank that writes files and prints."""
        return self.sample_rank == 0 and self.model_rank == 0

    def all_reduce_samples(self, x: torch.Tensor,
                           op: str = "sum") -> torch.Tensor:
        """Sum (or ``op="max"``) of ``x`` over the sample ranks, in a new
        tensor where the backend reduces: on the rank's card for
        ``nccl``; a backend that reduces host memory (``gloo``) gets the
        host copy of a card tensor, and the result stays on the host.
        Counted on the request as ``mesh.all_reduce`` and
        ``mesh.all_reduce_bytes``."""
        y = x.to(_comm_device(self.sample_group))
        if y is x:
            y = x.clone()
        profiling.count("mesh.all_reduce")
        profiling.count("mesh.all_reduce_bytes", y.numel() * y.element_size())
        dist.all_reduce(y, group=self.sample_group,
                        op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        return y

    def all_reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the ranks of this model instance."""
        if self.model_group is None:
            return x
        y = x.to(_comm_device(self.model_group))
        if y is x:
            y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.model_group)
        return y.to(x.device)

    def fetch_rows(self, x: Optional[torch.Tensor]) -> torch.Tensor:
        """:func:`fetch_global` over the sample group."""
        return fetch_global(x, self.sample_group)

    def broadcast_from_root(self, obj):
        """The root rank's ``obj`` on every rank of the mesh."""
        box = [obj]
        src = dist.get_global_rank(self.group, 0) \
            if self.group is not None else 0
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]


def _build(n_sample: int, n_model: int) -> Mesh:
    """Mesh over the first ``n_sample * n_model`` ranks of the world.
    Every rank of the world creates every group, in the same order."""
    _require_initialized()
    world, rank = dist.get_world_size(), dist.get_rank()
    size = n_sample * n_model
    if n_sample < 1 or n_model < 1 or size > world:
        raise ValueError("mesh larger than device count: %d x %d ranks of "
                         "a world of %d" % (n_sample, n_model, world))
    group = None if size == world else dist.new_group(list(range(size)))
    mine_s, mine_m = None, None
    if n_model == 1:
        mine_s = group
    else:
        for m in range(n_model):
            g = dist.new_group([s * n_model + m for s in range(n_sample)])
            if rank < size and rank % n_model == m:
                mine_s = g
        for s in range(n_sample):
            g = dist.new_group([s * n_model + m for m in range(n_model)])
            if rank < size and rank // n_model == s:
                mine_m = g
    if rank >= size:
        raise ValueError("rank %d is not part of the %d x %d mesh"
                         % (rank, n_sample, n_model))
    return Mesh(group, mine_s, mine_m, rank // n_model, rank % n_model,
                n_sample, n_model)


def sample_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1D mesh over all (or the first n) ranks for sample parallelism."""
    _require_initialized()
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return _build(n, 1)


def sample_model_mesh(n_sample: int, n_model: int) -> Mesh:
    """2D (samples, model) mesh: the equivalent of nested MPI
    communicators -- each model instance spans ``n_model`` ranks, with
    ``n_sample`` such instances running independent samples."""
    return _build(int(n_sample), int(n_model))


def dcn_sample_model_mesh(n_model: Optional[int] = None) -> Mesh:
    """2D mesh laid out for the interconnect hierarchy: the model axis
    stays WITHIN a node (the ranks that share ``LOCAL_WORLD_SIZE``, which
    ``torchrun`` sets; a job that does not set it is one node) and the
    sample axis varies across nodes.  Sampling communicates on the sample
    axis once per fetch, in the reduce of the small sums, while an
    internally-distributed model does per-chunk collectives on the model
    axis, which this layout keeps on the node's links.

    ``n_model``: ranks per model instance (must divide the local rank
    count; default all local ranks, i.e. one model instance per node).
    With ``n_model=1`` the model axis is dropped and the result is a 1D
    sample mesh."""
    _require_initialized()
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_model is None:
        n_model = local
    n_model = int(n_model)
    if n_model < 1 or local % n_model:
        raise ValueError(
            "n_model=%d must divide the local rank count %d so a model "
            "instance never straddles the node boundary" % (n_model, local))
    return _build(world // n_model, n_model)


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group`` -- replaces ``mpiexec``
    process management.  ``kwargs`` go to ``init_process_group`` (under
    ``torchrun`` none is needed; otherwise ``init_method``, ``world_size``
    and ``rank``), apart from ``device``: the sampling device of the
    problems to come (default ``"cuda"``, as ``BLUEProblem``'s), which
    picks the backend where the caller names none -- ``nccl`` for the
    card, where every rank needs a card of its own, ``gloo`` for
    ``device="cpu"``.  With ``nccl`` the rank takes the card of its
    ``LOCAL_RANK`` (or its rank, modulo the cards of the host)."""
    device = torch.device(kwargs.pop("device", "cuda"))
    backend = kwargs.setdefault(
        "backend", "nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend nccl: no CUDA card is available; "
                               "pass device=\"cpu\" (backend gloo) to "
                               "distribute on the host CPU")
        local_rank = os.environ.get("LOCAL_RANK", kwargs.get(
            "rank", os.environ.get("RANK", 0)))
        torch.cuda.set_device(int(local_rank) % torch.cuda.device_count())
    dist.init_process_group(**kwargs)


def fetch_global(x: Optional[torch.Tensor], group=None) -> torch.Tensor:
    """The rows (dimension 0) of every rank of ``group``, concatenated in
    rank order, on every rank -- the analog of the reference's rank-0
    snapshot gather (blue_fn.py:189-199).  Ranks may hold different row
    counts, and a rank that holds none may pass ``None``: the counts and
    the row shape are gathered first.  COLLECTIVE: every rank of the
    group must call this, in the same order.  Without an initialised
    process group (one process) ``x`` comes back as it is."""
    if not (dist.is_available() and dist.is_initialized()):
        return x
    size = dist.get_world_size(group)
    if size == 1:
        return x
    meta = [None] * size
    dist.all_gather_object(
        meta, None if x is None else (tuple(x.shape), x.dtype), group=group)
    known = [m for m in meta if m is not None]
    if not known:
        raise ValueError("fetch_global: no rank holds any rows")
    tail, dtype = known[0][0][1:], known[0][1]
    dev = _comm_device(group)
    me = dist.get_rank(group)
    parts = []
    for r, m in enumerate(meta):
        n = 0 if m is None else m[0][0]
        if n == 0:
            continue
        buf = (x.to(dev).contiguous() if r == me
               else torch.empty((n,) + tail, dtype=dtype, device=dev))
        src = r if group is None else dist.get_global_rank(group, r)
        dist.broadcast(buf, src=src, group=group)
        parts.append(buf)
    out = (torch.cat(parts) if parts
           else torch.empty((0,) + tail, dtype=dtype, device=dev))
    return out if x is None else out.to(x.device)
