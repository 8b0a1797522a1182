"""Devices, process groups and row shardings: the communication layer
(counterpart of ``musicgan_tpu/parallel/mesh.py``).

JAX expresses parallelism as one program over a ``jax.sharding.Mesh``:
sharding annotations, and collectives that XLA inserts.  PyTorch's idiom is
different, and so is this module's:

* **Data parallelism is one process per card**, joined in a
  ``torch.distributed`` process group (:func:`initialize_distributed`).
  The train step receives the group as a hashable :class:`Group` (its world
  size and rank) and makes its collectives itself (``train/step.py``).
* **The time-sharded long clip is one process over several devices**: a
  :class:`Mesh` is a tuple of ``torch.device``\\ s, and
  ``parallel/longclip.py`` runs one shard of the clip on each, exchanging
  the halos itself.  A device may repeat: its shards then run one after
  another (the CPU tests shard over ``[cpu] * 8``, as JAX's over eight
  virtual CPU devices).

The backend rule of the process group: ``gloo`` on the CPU; on the card
``nccl``, unless two ranks share a card, where NCCL cannot run and ``gloo``
does.  It is decided once, at :func:`initialize_distributed`, from every
rank's (hostname, device index).  A second group, always ``gloo``, carries
the agreements on host values (booleans, counts, hostnames, the autotune
winner): NCCL reduces device tensors only.  On a CUDA tensor ``gloo`` has
only ``all_reduce``, ``broadcast`` and ``barrier``, so the data group is
used for nothing else.  Nothing falls back: a rank whose card or backend
cannot be had raises, and so does a collective that fails.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "Group",
    "make_mesh",
    "data_sharding",
    "replicated_sharding",
    "pad_rows",
    "initialize_distributed",
    "shutdown_distributed",
    "process_group",
    "process_count",
    "process_index",
    "process_device",
    "backend",
    "hosts",
    "host_allgather",
    "host_broadcast",
    "host_barrier",
    "all_reduce_sum",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of devices in one process: ``devices[k]`` holds shard
    ``k``.  Hashable, as JAX's ``Mesh`` is, so that functions memoized on
    their arguments can take it.  Devices may repeat."""

    devices: tuple
    axis: str = "data"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a Mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class Group:
    """The data-parallel process group as a train step sees it: the world
    size and this process's rank (hashable: a step memoized on it is one
    step a process, whatever the group object).  Its collectives run over
    the group :func:`initialize_distributed` made."""

    world: int
    rank: int
    axis: str = "data"

    @property
    def size(self) -> int:
        return self.world


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data") -> Optional[Mesh]:
    """A :class:`Mesh` over the given devices, by default every visible CUDA
    device; ``None`` for one device or none, as in JAX (a one-device
    program shards nothing)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(devices) <= 1:
        return None
    return Mesh(tuple(devices), axis)


def pad_rows(n_rows: int, size: int) -> int:
    """Rows appended to an ``(n_rows, ...)`` array so that ``size`` shards
    split it evenly (JAX's ``as_array(pad_rows=...)`` rule)."""
    return (-n_rows) % size


def data_sharding(mesh_or_group, n_rows: int) -> list[slice]:
    """The leading axis of an ``(n_rows, ...)`` array sharded over a
    :class:`Mesh`'s devices or a :class:`Group`'s ranks: entry ``k`` is the
    contiguous row range shard ``k`` holds of the array padded by
    :func:`pad_rows` (JAX's ``NamedSharding(mesh, P(axis))`` layout)."""
    size = mesh_or_group.size
    per = (n_rows + pad_rows(n_rows, size)) // size
    return [slice(k * per, (k + 1) * per) for k in range(size)]


def replicated_sharding(mesh_or_group, n_rows: int) -> list[slice]:
    """Every shard holds every row (JAX's ``P()``)."""
    return [slice(0, n_rows)] * mesh_or_group.size


@dataclasses.dataclass
class _Dist:
    world: int
    rank: int
    device: torch.device
    backend: str
    data_group: object   # the group the train step's collectives ride
    host_group: object   # gloo: agreements on host values
    hosts: tuple         # (hostname, device index) of every rank


_DIST: Optional[_Dist] = None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str | torch.device | None = None,
    timeout_s: float = 1800.0,
) -> None:
    """Join the process group of a multi-process run; a no-op when neither
    ``coordinator_address`` nor ``num_processes`` is given (one process),
    as in JAX.

    ``coordinator_address`` is ``host:port`` of rank 0's store.  ``device``:
    ``cuda`` unless the caller passes ``"cpu"``; on the card this process
    takes ``cuda:{process_id % device_count}`` and makes it current before
    anything else touches the card.  ``backend``: by the rule of the module
    docstring unless given.  ``timeout_s`` bounds every collective,
    rendezvous included: a peer that never arrives raises instead of
    hanging."""
    global _DIST
    if num_processes is None and coordinator_address is None:
        return
    if _DIST is not None:
        raise RuntimeError("initialize_distributed: this process already joined a group")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator, --num-processes and --process-id")
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    # Host agreements ride gloo in every case, so the default group is gloo
    # and the backend rule is decided over it.
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=timeout,
    )
    host_group = dist.group.WORLD
    me = (socket.gethostname(), dev.index if dev.type == "cuda" else -1)
    everyone: list = [None] * int(num_processes)
    dist.all_gather_object(everyone, me, group=host_group)
    hosts = tuple(tuple(h) for h in everyone)
    if backend is None:
        shared = dev.type == "cuda" and len(set(hosts)) < len(hosts)
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if backend == "nccl":
        data_group = dist.new_group(backend="nccl", timeout=timeout)
        # NCCL makes its communicator at the first collective: make it now,
        # so that a card or a network NCCL cannot use fails here.
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe, group=data_group)
        torch.cuda.synchronize(dev)
        if probe.item() != num_processes:
            raise RuntimeError(f"NCCL's first all_reduce gave {probe.item()}, not {num_processes}")
    elif backend == "gloo":
        data_group = host_group
    else:
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    _DIST = _Dist(int(num_processes), int(process_id), dev, backend, data_group, host_group, hosts)
    if process_id == 0:
        cards = len({h for h in hosts if h[1] >= 0})
        print(f"[dist] backend {backend} ({num_processes} processes, {cards} cards)", flush=True)


def shutdown_distributed() -> None:
    """Leave the process group (tests and scripts that join more than one
    in a process)."""
    global _DIST
    if _DIST is None:
        return
    _DIST = None
    dist.destroy_process_group()


def process_count() -> int:
    """World size of the run: 1 without a process group."""
    return 1 if _DIST is None else _DIST.world


def process_index() -> int:
    """This process's rank: 0 without a process group."""
    return 0 if _DIST is None else _DIST.rank


def process_device() -> Optional[torch.device]:
    """The device :func:`initialize_distributed` gave this process."""
    return None if _DIST is None else _DIST.device


def backend() -> Optional[str]:
    """The data group's backend (``nccl`` or ``gloo``), None without one."""
    return None if _DIST is None else _DIST.backend


def hosts() -> tuple:
    """``(hostname, device index)`` of every rank, in rank order."""
    if _DIST is None:
        return ((socket.gethostname(), -1),)
    return _DIST.hosts


def process_group(axis: str = "data") -> Optional[Group]:
    """The run's :class:`Group` where more than one process joined, else
    None."""
    if _DIST is None or _DIST.world <= 1:
        return None
    return Group(_DIST.world, _DIST.rank, axis)


def _need_dist() -> _Dist:
    if _DIST is None:
        raise RuntimeError("no process group: call initialize_distributed first")
    return _DIST


def host_allgather(value) -> list:
    """Every rank's ``value`` (a picklable host object), in rank order."""
    if _DIST is None:
        return [value]
    out: list = [None] * _DIST.world
    dist.all_gather_object(out, value, group=_DIST.host_group)
    return out


def host_broadcast(value, src: int = 0):
    """Rank ``src``'s ``value`` on every rank."""
    if _DIST is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src, group=_DIST.host_group)
    return box[0]


def host_barrier() -> None:
    """Every rank waits here for every other."""
    if _DIST is not None:
        dist.barrier(group=_DIST.host_group)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place, on the data group (a CUDA tensor
    under gloo too: ``all_reduce`` is one of the three collectives gloo
    offers there).  Every rank gets the same bits."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_need_dist().data_group)
    return t
