"""Process groups, the ``(data, model)`` grid of ranks and its collectives
(counterpart of `tinyvc_tpu/parallel/mesh.py`).

JAX's single controller spreads one process over every local device and
lets XLA insert the collectives. NCCL takes one rank per card ("Duplicate
GPU detected" for two ranks on one) and ``torch.distributed`` has no group
of one process over many cards, so the port runs one process per card,
launched with the JAX CLIs' three flags (``--coordinator-address host:port
--num-processes N --process-id i``), and calls the collectives itself:

- ``data``: batch parallelism. Each rank holds its own rows of the global
  batch (:func:`shard_batch`, :func:`local_batch_size`) and the trainers
  average their gradients over the data group (:func:`all_reduce_mean`).
- ``model``: the kNN dictionary's rows, resolved by local top-k, a gather
  of the values and a re-top-k (`parallel/sharded_knn.py`).

Rank ``d * model + m`` sits at data index ``d`` and model index ``m``, as
JAX's mesh reshapes its device list. There is no fallback: a group that
cannot form within its timeout, or a collective that fails, raises.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600  # a rank that has not joined or answered by then fails the group
BUCKET_BYTES = 32 * 2**20  # the flattened buckets of one all-reduce or broadcast


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda",
                     timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group: a no-op for ``num_processes`` None or 1;
    else ``init_process_group`` over ``tcp://coordinator_address`` (process
    0's ``host:port``) with NCCL on CUDA, the process taking card
    ``process_id % device_count``, or gloo on the CPU (``device="cpu"``).
    Call it before anything touches a card."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need --coordinator-address, the host:port "
                         "of process 0")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id must be in [0, {num_processes}), got {process_id}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to join a gloo group "
                               "on the CPU")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(data, model)`` grid of ranks as one rank sees it: its place
    and the two groups it belongs to, its column over ``data`` and its row
    over ``model``."""

    data: int
    model: int
    rank: int
    data_group: Any
    model_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def axis(self, name: str):
        """(group, size, this rank's index) of the axis ``name``."""
        if name == "data":
            return self.data_group, self.data, self.data_index
        if name == "model":
            return self.model_group, self.model, self.model_index
        raise ValueError(f"a mesh has the axes 'data' and 'model', not {name!r}")


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The ``(data, model)`` grid over every rank of the group (``data``
    defaults to the world over ``model``): one ``new_group`` for each model
    row and each data column, made by every rank in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first "
                           "(one process per card)")
    n = dist.get_world_size()
    data = n // model if data is None else data
    if data * model != n:
        raise ValueError(f"{data}x{model} != {n} processes")
    rows = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    cols = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    rank = dist.get_rank()
    return Mesh(data, model, rank, data_group=cols[rank % model], model_group=rows[rank // model])


def local_batch_size(global_batch: int) -> int:
    """The rows this process feeds: the global batch split evenly over the
    processes (each process's loader draws only its share)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def shard_batch(x, mesh: Mesh):
    """This rank's rows of a global batch ``x`` (axis 0 over ``data``):
    the rows JAX's ``shard_batch`` places on this rank's device."""
    n, i = mesh.data, mesh.data_index
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows not divisible by data={n}")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def global_rows(mesh: Optional[Mesh], B: int):
    """(the global batch, this rank's rows of it as a slice, or None
    without a mesh) for a local batch of ``B`` rows: where a rank's share
    of a draw over the global batch lies."""
    if mesh is None:
        return B, None
    i = mesh.data_index
    return B * mesh.data, slice(i * B, (i + 1) * B)


def _buckets(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in consecutive runs of one dtype and device of
    at most ``BUCKET_BYTES`` each (a larger tensor is a run alone)."""
    out: List[List[int]] = []
    nbytes = 0
    for i, t in enumerate(tensors):
        size = t.numel() * t.element_size()
        last = tensors[out[-1][-1]] if out else None
        if (last is None or last.dtype != t.dtype or last.device != t.device
                or nbytes + size > BUCKET_BYTES):
            out.append([])
            nbytes = 0
        out[-1].append(i)
        nbytes += size
    return out


def all_reduce_mean(tensors: Dict[str, torch.Tensor], group, size: int) -> Dict[str, torch.Tensor]:
    """The mean of each tensor over the ``size`` ranks of ``group``, summed
    in flattened buckets (a few collectives, not one a leaf); new tensors,
    equal bit for bit on every rank."""
    names = list(tensors)
    flat = [tensors[k].detach() for k in names]
    out: Dict[str, torch.Tensor] = {}
    for idx in _buckets(flat):
        buf = torch.cat([flat[i].reshape(-1) for i in idx])
        dist.all_reduce(buf, group=group)
        buf /= size
        for i, part in zip(idx, torch.split(buf, [flat[i].numel() for i in idx])):
            out[names[i]] = part.view(flat[i].shape)
    return out


def data_mean(mesh: Optional[Mesh], *dicts: Dict[str, torch.Tensor]):
    """Each dict of tensors averaged over the mesh's data group, all in one
    set of buckets (:func:`all_reduce_mean`); the dicts as they are without
    a mesh."""
    if mesh is None:
        return dicts
    merged = {(i, k): v for i, d in enumerate(dicts) for k, v in d.items()}
    mean = all_reduce_mean(merged, mesh.data_group, mesh.data)
    return tuple({k: mean[(i, k)] for k in d} for i, d in enumerate(dicts))


def replicate(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Broadcast each tensor from rank ``src`` to every rank, in place, in
    flattened buckets: the state every rank then holds is rank 0's (JAX
    assumes identical host values; a broadcast makes them so)."""
    ts = list(tensors)
    with torch.no_grad():
        for idx in _buckets(ts):
            buf = torch.cat([ts[i].reshape(-1) for i in idx])
            dist.broadcast(buf, src)
            for i, part in zip(idx, torch.split(buf, [ts[i].numel() for i in idx])):
                ts[i].copy_(part.view(ts[i].shape))


def broadcast_object(obj, src: int = 0):
    """A picklable value from rank ``src`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]
