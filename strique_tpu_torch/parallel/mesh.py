"""Data parallelism over reads: the devices a run shards over, and the
multi-host rendezvous.

The port's counterpart of ``strique_tpu/parallel/mesh.py``.  The
reference shards each read batch over a 1-D ``data`` mesh with
``shard_map``; the port has no jitted body to shard, so a counter takes
a plain list of ``torch.device``s (:func:`local_devices`, in place of
``make_mesh``) and runs a batch's contiguous row shards one per entry,
each on its own CUDA stream (``detect/counter.py``).  Every read is
independent and the model is copied to each device, so the output is
the single device's, row for row.  A list may repeat a device: that is
how one card (or the CPU) drives the multi-device logic.

Multi-host runs rendezvous through :func:`init_distributed`
(``torch.distributed`` over gloo): each process counts a stride of the
SAM stream and writes its own TSV shard.  No collective crosses reads,
so barriers are all the processes exchange.
"""
from __future__ import annotations

import contextlib
import datetime
import os

import torch

# seconds the rendezvous waits for every process before it fails the run
# (there is no single-process fallback)
RENDEZVOUS_TIMEOUT_S = 600
# how long a barrier waits for a peer that is still counting: its SAM
# stride may end hours after another's, as the reference's barrier has
# no limit either.  A peer that dies closes its connections, which fails
# the barrier at once.
BARRIER_TIMEOUT = datetime.timedelta(days=7)
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Join the multi-host process group (idempotent); return this
    process' rank.

    With ``coordinator`` ("HOST:PORT", rank 0's address),
    ``num_processes`` and ``process_id`` it rendezvouses at HOST:PORT;
    with none of them, at ``MASTER_ADDR``:``MASTER_PORT`` with ``RANK``
    and ``WORLD_SIZE`` when all four are set (the counterpart of the
    reference's coordinator variables), else it stays a single process
    (rank 0).  The rendezvous is a ``TCPStore`` that waits for every
    process: one that fails or does not complete within
    ``RENDEZVOUS_TIMEOUT_S`` raises.  The gloo group built on it keeps
    ``BARRIER_TIMEOUT`` for its barriers.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    explicit = (coordinator, num_processes, process_id)
    if any(x is not None for x in explicit):
        if any(x is None for x in explicit):
            raise ValueError("a multi-host run needs the coordinator address, the number of "
                             "processes and this process' id")
        host, _, port = coordinator.rpartition(":")
        world, rank = num_processes, process_id
    elif all(os.environ.get(k) for k in _ENV):
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return 0
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is not in [0, {world})")
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S),
                          wait_for_workers=True)
    dist.init_process_group("gloo", store=store, world_size=world, rank=rank,
                            timeout=BARRIER_TIMEOUT)
    return dist.get_rank()


def process_count() -> int:
    """Processes in the run: the group's size, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every process of the group (a no-op without one); raises
    when a peer has died or does not arrive within ``BARRIER_TIMEOUT``."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def local_devices(kind: str = "cuda", n="auto") -> list[torch.device]:
    """The devices a run's batches shard over.

    ``kind`` "cuda": ``n`` "auto" takes every local card, an integer is
    capped at the local count (as the reference caps ``--devices``);
    raises without a card.  ``kind`` "cpu": ``n`` replicas of the CPU
    ("auto": one), the counterpart of the reference's virtual CPU
    devices.
    """
    want = None if n == "auto" else max(int(n), 1)
    if kind == "cpu":
        return [torch.device("cpu")] * (want or 1)
    if kind != "cuda":
        raise ValueError(f"unsupported device kind {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA run needs a CUDA device; pass the cpu kind for the plain "
                           "PyTorch path")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(min(want or count, count))]


def shard_streams(devices) -> list:
    """One CUDA stream per entry of ``devices`` when there are several
    (None for a CPU entry, and for a single device: it keeps the current
    stream)."""
    if len(devices) < 2:
        return [None] * len(devices)
    return [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]


def on_stream(stream):
    """The context that makes ``stream`` current (none for None)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def shard_rows(rows: int, n_shards: int) -> list[slice]:
    """Contiguous row slices of ``rows`` (a multiple of ``n_shards``), one
    a shard, in order: the reference's ``P("data")`` split."""
    if rows % n_shards:
        raise ValueError(f"{rows} rows do not split into {n_shards} equal shards")
    per = rows // n_shards
    return [slice(k * per, (k + 1) * per) for k in range(n_shards)]
