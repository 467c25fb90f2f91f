"""The (data, model) mesh over ``torch.distributed`` (JAX counterpart:
parallel/mesh.py).

One process a card.  The processes form a grid of ``data`` rows and
``model`` columns: rank ``r`` sits at (``r // model``, ``r % model``).  The
batch is split over the data axis; the large matrices over the model axis
(Megatron columns and rows, ``parallel/tensor.py``), by the JAX package's
rule: a 2-D leaf whose output dimension is at least ``TP_MIN_DIM`` and
divisible is split by columns, else one whose input dimension is, by rows;
everything else is replicated.  The rule reads the JAX leaf's shape, and an
``nn.Linear`` weight is JAX's kernel transposed (``convert.py``), so a JAX
column split is a split of the port tensor's dimension 0.

Each rank belongs to one process group per axis: its *data group* (the
ranks of its model column, over which gradients and BatchNorm statistics
are summed) and its *model group* (the ranks of its data row, over which
the split matrices' partial products are gathered or summed).

The collectives here take CUDA tensors on NCCL and on gloo: gloo sums a
CUDA tensor through a host copy (it is the backend that can put two
processes on one card, which NCCL refuses), and an all-gather is an
all-reduce of zero-padded pieces, which both backends take for every
device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from ..convert import bundle_key

DATA_AXIS = "data"
MODEL_AXIS = "model"
# a dimension shorter than this is never split (JAX's _TP_MIN_DIM): the FF
# matrices (512 x 2048) are, the heads and norms are not
TP_MIN_DIM = 1024


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda") -> int:
    """Join this process to a multi-process run; returns the process count.

    A no-op returning 1 where nothing asks for more than one process, so
    entry points call it unconditionally.  Otherwise it reads, as the JAX
    package does, ``JAX_COORDINATOR`` (``host:port`` of rank 0's TCP store),
    ``NPROC`` and ``PROC_ID``; with ``MSTR_MULTIHOST=1`` (the counterpart of
    JAX's pod auto-detection) torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` instead.  On ``device="cuda"`` each
    process takes ``cuda:LOCAL_RANK`` (the rank modulo the host's cards
    where ``LOCAL_RANK`` is unset) and the backend is NCCL; gloo only on
    ``device="cpu"``.  Launch one process a card:

        JAX_COORDINATOR=host0:29500 NPROC=2 PROC_ID=<0|1> \\
            python -m multimodal_scene_text_recognition_tpu_torch.cli train ...
        MSTR_MULTIHOST=1 torchrun --nproc-per-node=4 -m \\
            multimodal_scene_text_recognition_tpu_torch.cli train ...
    """
    env = os.environ
    coordinator_address = coordinator_address or env.get("JAX_COORDINATOR")
    if num_processes is None and env.get("NPROC"):
        num_processes = int(env["NPROC"])
    if process_id is None and env.get("PROC_ID"):
        process_id = int(env["PROC_ID"])
    pod = env.get("MSTR_MULTIHOST") == "1"
    if not coordinator_address and not pod and (num_processes is None or num_processes <= 1):
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    if pod:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs JAX_COORDINATOR, NPROC and PROC_ID "
                         "(or MSTR_MULTIHOST=1 under torchrun)")
    if device == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: this torch has no NCCL backend")
        local = int(env.get("LOCAL_RANK", process_id % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid and its two groups."""

    data: int
    model: int
    rank: int
    data_group: Any
    model_group: Any

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(n: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """The (data, model) mesh over the ``n`` processes of the initialised
    default group (all of them by default; ``n`` must be that count).
    Raises where ``n`` is not a multiple of ``model_axis``, as JAX's does.
    Every rank makes every group, in one order, as ``new_group`` needs."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_distributed, or init_process_group)")
    world = dist.get_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"make_mesh: {n} ranks asked for, the process group has {world}")
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    data = n // model_axis
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(model_axis):  # the data groups: one model column each
        g = dist.new_group([d * model_axis + m for d in range(data)])
        if rank % model_axis == m:
            data_group = g
    for d in range(data):  # the model groups: one data row each
        g = dist.new_group([d * model_axis + m for m in range(model_axis)])
        if rank // model_axis == d:
            model_group = g
    return Mesh(data, model_axis, rank, data_group, model_group)


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in place (and returned).  Gloo sums
    a CUDA tensor through a host copy."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


@dataclass(frozen=True)
class GroupSum:
    """The sum over a process group as ``ops.batchnorm.bn_train`` takes it
    (its ``reducer``): called on a tensor, its sum over the group in place;
    ``size``, the group's process count."""

    group: Any

    @property
    def size(self) -> int:
        return group_size(self.group)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The pieces ``t`` of the ranks of ``group`` joined along ``dim`` in
    rank order (each rank's piece of one shape): an all-reduce of the
    pieces zero-padded to the whole, exact (x + 0 is x)."""
    size, me = group_size(group), dist.get_rank(group)
    if size == 1:
        return t
    dim = dim % t.dim()
    shape = list(t.shape)
    shape[dim] *= size
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out.narrow(dim, me * t.shape[dim], t.shape[dim]).copy_(t)
    return all_reduce(out, group)


def chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's piece of ``t`` split evenly along ``dim`` over ``group``."""
    size, me = group_size(group), dist.get_rank(group)
    return t.narrow(dim, me * (t.shape[dim] // size), t.shape[dim] // size)


def param_spec(shape: Tuple[int, ...], model_size: int) -> Tuple:
    """JAX's rule for a leaf of JAX shape ``shape``: ``(None, "model")``
    (split by columns), ``("model", None)`` (by rows) or ``()``
    (replicated), the axes of its ``PartitionSpec``."""
    if model_size <= 1 or len(shape) != 2:
        return ()
    d_in, d_out = shape
    if d_out >= TP_MIN_DIM and d_out % model_size == 0:
        return (None, MODEL_AXIS)
    if d_in >= TP_MIN_DIM and d_in % model_size == 0:
        return (MODEL_AXIS, None)
    return ()


def split_dim(name: str, t: torch.Tensor, model_size: int) -> Optional[int]:
    """The dimension of the port tensor ``name`` (a ``state_dict`` entry)
    that the model axis splits, or None: the JAX rule applied to the JAX
    leaf it carries, whose 2-D kernels are the port's weights transposed."""
    transposed = bundle_key(name, t)[1] and t.dim() == 2
    jshape = tuple(reversed(t.shape)) if transposed else tuple(t.shape)
    spec = param_spec(jshape, model_size)
    if not spec:
        return None
    jdim = spec.index(MODEL_AXIS)
    return 1 - jdim if transposed else jdim


def split_dims(state: Mapping[str, torch.Tensor], model_size: int) -> Dict[str, int]:
    """``{name: split dimension}`` of the entries of a full ``state_dict``
    that the model axis splits."""
    out = {}
    for name, t in state.items():
        d = split_dim(name, t, model_size)
        if d is not None:
            out[name] = d
    return out


def shard_state(full_state: Mapping[str, torch.Tensor], mesh: Mesh,
                dims: Optional[Mapping[str, int]] = None) -> Dict[str, torch.Tensor]:
    """This rank's ``state_dict`` from a full one (e.g. ``convert.py``'s
    bundle_to_state_dict of a JAX bundle): each split entry cut to its
    model rank's contiguous piece, as JAX's ``NamedSharding`` places it,
    the rest as they are.  ``dims`` defaults to :func:`split_dims`."""
    dims = split_dims(full_state, mesh.model) if dims is None else dims
    out = {}
    for name, t in full_state.items():
        d = dims.get(name)
        if d is None:
            out[name] = t
        else:
            size = t.shape[d] // mesh.model
            out[name] = t.narrow(d, mesh.model_rank * size, size).clone()
    return out


def gather_state(local_state: Mapping[str, torch.Tensor], mesh: Mesh,
                 dims: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state` (a collective over the model
    group): the full ``state_dict`` on every rank, the split entries of
    ``dims`` gathered from their pieces."""
    return {name: all_gather(t.detach(), mesh.model_group, dims[name]) if name in dims else t
            for name, t in local_state.items()}


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a whole batch (arrays or tensors with the batch
    first): the ``data_rank``-th of ``data`` equal pieces.  A batch the data
    axis does not divide raises, as JAX's ``device_put`` does."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = v
            continue
        n = v.shape[0]
        if n % mesh.data:
            raise ValueError(f"batch of {n} rows is not divisible by the data axis ({mesh.data})")
        rows = n // mesh.data
        out[k] = v[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
    return out
