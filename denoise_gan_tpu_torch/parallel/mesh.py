"""The ``data`` and ``space`` axes over torch.distributed
(denoise_gan_tpu/parallel/mesh.py).

The JAX package runs one process per host over a device mesh and leaves
the data axis to GSPMD: the global batch split over the devices, the
parameters replicated, the gradients all-reduced and BatchNorm's training
statistics taken over the global batch.  Here one process (a rank) drives
one device, and the same pieces are written out over torch.distributed:

* :func:`init_distributed` joins the process group that ``torchrun`` (or
  the caller) describes; :func:`make_mesh` is the rank's view of it;
* :func:`shard_batch` / :class:`Shard` give a rank its rows of the global
  batch, :class:`GlobalDraw` its rows of a random draw made over the
  global batch (the step's JPEG qualities and dropout masks), so that a
  step on N ranks is the one-process step on their concatenated rows;
* :func:`all_sum` (differentiable: :func:`all_sum_grad`), :func:`all_mean`
  and :func:`gather_rows` are the collectives of models/layers.py::
  BatchNorm, train/step.py and infer/engine.py.  They use only
  ``broadcast`` and ``all_reduce``, the two collectives that gloo runs on
  CUDA tensors, so that one code path serves NCCL (one card a rank), gloo
  on the CPU and gloo with ranks sharing a card.

The ``space`` axis shards a frame's rows over the ranks for inference
(parallel/spatial.py::spatial_apply, each conv's halo rows exchanged with
the neighbouring ranks).  :func:`make_mesh` lays the ranks out as the JAX
mesh does, ``(ranks // space, space)``: a rank's data index is ``rank //
space``, its space index ``rank % space``.  The training step and the
frame engine split the data axis only, and refuse a mesh whose ``space``
is not 1 (:func:`data_only`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist

from denoise_gan_tpu_torch.utils.device import require_cuda, resolve_device

DATA_AXIS = "data"
SPACE_AXIS = "space"
JOIN_TIMEOUT_S = 300     # a rank that does not join or answer by then fails

_DEVICE: torch.device | None = None     # this rank's device, once joined


def world_size() -> int:
    """The ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device: torch.device | str | None,
                local_rank: int) -> torch.device:
    """A rank's device: `device` as given where it names one (``cpu``,
    ``cuda:1``); ``cuda`` or None is the card ``cuda:<local_rank>``, which
    must exist (RuntimeError otherwise: several ranks share one card only
    when the caller names it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    require_cuda(dev)
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no card {dev}: "
            f"{torch.cuda.device_count()} visible; give the card (e.g. "
            "--device cuda:0) for ranks to share it over gloo")
    return dev


def init_distributed(backend: str | None = None,
                     device: torch.device | str | None = None,
                     init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None,
                     timeout_s: float = JOIN_TIMEOUT_S) -> None:
    """Join the process group: from `init_method` (e.g. ``file://...``)
    with `rank` and `world_size` where given, else from the environment
    ``torchrun`` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT).  Without either it does nothing, as does a second call.

    The rank's device is :func:`rank_device` of `device` and LOCAL_RANK
    (the rank where LOCAL_RANK is unset).  `backend`: NCCL where every
    rank has a card of its own (`device` ``cuda`` or None), else gloo (the
    CPU, or ranks that share a named card; NCCL refuses two ranks of one
    communicator on one card); the caller may name either.  Every join
    and collective fails after `timeout_s` rather than hang on a rank
    that died."""
    global _DEVICE
    if dist.is_initialized():
        return
    if init_method is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None or world_size is None:
        raise ValueError("init_method needs rank and world_size")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank)
    if backend is None:
        own_card = dev.type == "cuda" and (
            device is None or torch.device(device).index is None)
        backend = "nccl" if own_card else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    _DEVICE = dev


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the (data, space) mesh: `size` ranks, this one's
    `rank`, its `device`, the `hosts` they run on (each host runs
    ``LOCAL_WORLD_SIZE`` ranks; all of them where that is unset) and the
    `space` axis' size."""

    size: int
    rank: int
    device: torch.device
    hosts: int = 1
    space: int = 1

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space


def data_only(mesh: "Mesh | None", what: str) -> None:
    """Refuse a mesh with a space axis where `what` splits the data axis
    only (NotImplementedError)."""
    if mesh is not None and mesh.space != 1:
        raise NotImplementedError(
            f"{what} splits the data axis only; a mesh with space="
            f"{mesh.space} shards a frame's rows, which "
            "parallel/spatial.py::spatial_apply runs")


def make_mesh(num_devices: int = 0, space: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The (data, space) mesh over every rank of the process group (one
    rank and `device`, the card by default, without a group).
    `num_devices`: 0 for every rank, else it must equal their number
    (ValueError: a rank drives one device, so a run on N devices is N
    processes).  `space` must divide the ranks (ValueError, as the JAX
    mesh; so space > 1 needs a group of as many ranks)."""
    n = world_size()
    if num_devices and num_devices != n:
        raise ValueError(
            f"num_devices={num_devices}, but this run has {n} rank(s): "
            f"launch one process a device (torchrun --nproc_per_node="
            f"{num_devices}) or give 0 for every rank")
    if space < 1 or n % space:
        raise ValueError(f"space={space} does not divide device count {n}")
    if n == 1:
        return Mesh(1, 0, resolve_device("cuda" if device is None
                                         else device))
    rank = dist.get_rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    dev = _DEVICE or rank_device(device, int(os.environ.get("LOCAL_RANK",
                                                            rank)))
    return Mesh(n, rank, dev, max(1, n // local), space)


def split_range(n: int, index: int, count: int) -> tuple[int, int]:
    """Part `index`'s [lo, hi) of `n` split into `count` parts as evenly
    as they go (sizes differ by at most one)."""
    return index * n // count, (index + 1) * n // count


@dataclass(frozen=True)
class Shard:
    """Axis 0 of a global batch split into `count` equal parts, of which
    this process holds part `index` (the JAX mesh's P('data')); with
    `row_count` > 1 also axis 1 (H of NHWC) split into that many parts as
    evenly as they go (``split_range``), of which it holds `row_index`
    (P('data', 'space'))."""

    index: int = 0
    count: int = 1
    row_index: int = 0
    row_count: int = 1

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This part of the global `x` (ValueError where its rows do not
        split evenly)."""
        n = x.shape[0]
        if n % self.count:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.count} ranks")
        b = n // self.count
        x = x[self.index * b:(self.index + 1) * b]
        if self.row_count == 1:
            return x
        lo, hi = split_range(x.shape[1], self.row_index, self.row_count)
        return x[:, lo:hi]


def batch_sharding(mesh: Mesh) -> Shard:
    """Batch tensors: axis 0 split over the data axis, H over the space
    axis (the JAX mesh's P('data', 'space'))."""
    return Shard(mesh.data_index, mesh.size // mesh.space, mesh.space_index,
                 mesh.space)


def spatial_sharding(mesh: Mesh) -> Shard:
    """Large-frame inference: H (axis 1 of NHWC) split over every rank, as
    the JAX package flattens every device onto the space axis; each
    rank's rows are ``row_range`` of them (parallel/spatial.py)."""
    return Shard(row_index=mesh.rank, row_count=mesh.size)


@dataclass(frozen=True)
class GlobalDraw:
    """Draws from `generator` made over the global batch, of which this
    rank keeps its rows: every rank draws the whole batch's values in the
    order the one-process step does, so their rows together are its
    draw.  models/layers.py::Dropout takes one in place of a
    torch.Generator."""

    generator: torch.Generator | None
    shard: Shard

    def rand(self, shape, device) -> torch.Tensor:
        full = (shape[0] * self.shard.count, *shape[1:])
        return self.shard.take(torch.rand(full, generator=self.generator,
                                          device=device))


def replicated(modules, mesh: Mesh):
    """Every parameter and buffer of `modules` (one module or a list)
    broadcast from rank 0 in place, so that the ranks start equal; the
    modules."""
    if mesh.size > 1:
        for m in (modules if isinstance(modules, (list, tuple))
                  else [modules]):
            with torch.no_grad():
                for t in list(m.parameters()) + list(m.buffers()):
                    dist.broadcast(t.data, src=0)
    return modules


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a tensor, or a tuple or list of
    them); the batch itself on one rank."""
    if mesh.size == 1:
        return batch
    take = batch_sharding(mesh).take
    if isinstance(batch, (list, tuple)):
        return type(batch)(take(x) for x in batch)
    return take(batch)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, in place (no gradient); `t`."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


class _AllSum(torch.autograd.Function):
    """y = the sum of x over the ranks; its backward sums the ranks'
    output gradients, so that each rank's parameters see every rank's
    loss through the sum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return all_sum(x.clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return all_sum(g.clone())


def all_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (models/layers.py::
    BatchNorm's statistics)."""
    return _AllSum.apply(x)


def all_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor (one all-reduce of them
    flattened together, then / ranks), new tensors; the same values on
    every rank."""
    n = world_size()
    if n == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_sum(flat).div_(n)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def row_range(n: int, mesh: Mesh, unit: int = 1) -> tuple[int, int]:
    """This rank's [lo, hi) of `n` rows split over every rank as evenly as
    they go (part sizes differ by at most one; none is empty where n >=
    ranks), in whole `unit`s of rows: ``unit`` times the split of ``n //
    unit`` (a frame's split rows after a `unit`-times upscale)."""
    lo, hi = split_range(n // unit, mesh.rank, mesh.size)
    return lo * unit, hi * unit


def gather_rows(local: torch.Tensor, n: int, mesh: Mesh, unit: int = 1
                ) -> torch.Tensor:
    """The (n, ...) whole of which every rank holds its ``row_range(n,
    mesh, unit)`` rows, on every rank: the rows put into a zeroed buffer,
    whose bytes are summed over the ranks as uint8 (a byte plus zeros is
    itself, so the gather is exact in any dtype)."""
    if mesh.size == 1:
        return local
    lo, hi = row_range(n, mesh, unit)
    if local.shape[0] != hi - lo:
        raise ValueError(f"rank {mesh.rank} holds {local.shape[0]} rows, "
                         f"not its {hi - lo} of {n}")
    buf = torch.zeros((n, *local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    buf[lo:hi] = local
    all_sum(buf.view(-1).view(torch.uint8))
    return buf


def map_frames(engine: Callable[[torch.Tensor], torch.Tensor],
               frames: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Frame parallelism: this rank's frames of a global (F, H, W, 3)
    batch, each through the rank's own `engine`; no communication (the
    JAX package's shard_map of its kernel engine, tests/test_parallel.py).
    """
    data_only(mesh, "map_frames")
    return torch.stack([engine(f) for f in shard_batch(frames, mesh)])


def checksum(*modules: torch.nn.Module) -> float:
    """The float64 sum of |x| over the parameters and buffers of
    `modules`: equal on every rank where the replicas are."""
    total = torch.zeros((), dtype=torch.float64)
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            total += t.detach().double().abs().sum().cpu()
    return float(total)


def same_on_all_ranks(value: float, device: torch.device) -> bool:
    """Whether every rank holds the same float64 `value` (one all-reduce
    of the ranks' values, each in its own slot of a zeroed vector)."""
    n = world_size()
    if n == 1:
        return True
    v = torch.zeros(n, dtype=torch.float64, device=device)
    v[dist.get_rank()] = value
    all_sum(v)
    return bool((v == v[0]).all())
