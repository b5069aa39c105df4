"""Multi-process initialisation, batch slices, the logits gather and the
single-host launcher.

Counterpart of ``resnetc_tpu/parallel/distributed.py``.  A JAX job runs one
process per host, and each process sees every device of the job.  The port
runs one process per rank, each on one card (or on a share of one), joined
in a ``torch.distributed`` process group, and its data parallelism is per
rank: every rank holds a replica of the weights and computes on its slice
of the global batch.  So where JAX assembles per-host arrays into one
global array, the port gathers the ranks' slices (``host_local_to_global``).

Each rank runs on ``cuda:(local_rank % cards)``, or on the CPU when the
caller asks for it.  The backend follows from that layout and is chosen
before the group is made: ``nccl`` when every rank of a host has a card of
its own, ``gloo`` when ranks share a card (NCCL refuses two ranks on one
device) or run on the CPU.  Gloo takes CUDA tensors in every collective
used here and stages them through the host itself.
"""

from __future__ import annotations

import os
import socket
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as dist

#: How long the ranks wait for each other at the rendezvous.
RENDEZVOUS_TIMEOUT = timedelta(seconds=300)


def choose_backend(device_type: str, ranks_on_host: int, cards: int) -> str:
    """``nccl`` when every rank of the host has a card of its own, else
    ``gloo`` (ranks that share a card, or ranks on the CPU)."""
    return "nccl" if device_type == "cuda" and ranks_on_host <= cards else "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device | None = None,
) -> torch.device:
    """Join the process group and return this rank's device.

    With ``coordinator_address`` ("host:port") the ranks meet in a TCP store
    there, the rendezvous of ``tcp://host:port``; rank ``process_id`` of
    ``num_processes`` creates it when it is 0.  Each rank posts its host
    name, so that every rank knows how many ranks share its host, and its
    local rank among them, before the backend is chosen.  Without a
    coordinator the group comes from the environment (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them), the counterpart of JAX's
    pod auto-detection.

    ``device=None`` is the card (and raises where CUDA is absent);
    ``device="cpu"`` runs the rank on the CPU over gloo.  A failed init
    raises: no other backend is tried."""
    from resnetc_tpu_torch.tensor import resolve_device

    dev = resolve_device(device)
    if coordinator_address is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        rendezvous = {"init_method": "env://"}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        host, port = coordinator_address.rsplit(":", 1)
        rank, world = process_id, num_processes
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=RENDEZVOUS_TIMEOUT)
        me = socket.gethostname()
        store.set(f"host/{rank}", me)
        hosts = [store.get(f"host/{r}").decode() for r in range(world)]
        local_rank, local_world = hosts[:rank].count(me), hosts.count(me)
        rendezvous = {"store": store}
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    backend = choose_backend(dev.type, local_world, cards)
    print(f"[parallel] rank {rank} of {world}: {dev}, {backend} ({local_world} ranks on "
          f"this host, {cards} cards)", file=sys.stderr, flush=True)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=RENDEZVOUS_TIMEOUT, **rendezvous)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_batch_slice(global_batch: int, group=None) -> tuple[int, int]:
    """(start, size) of this rank's slice of a batch dimension, for per-rank
    data loading (the whole batch outside a process group)."""
    n, i = (dist.get_world_size(group), dist.get_rank(group)) if dist.is_initialized() else (1, 0)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return i * per, per


def host_local_to_global(local: torch.Tensor, group=None) -> torch.Tensor:
    """The global batch (or logits) rebuilt from every rank's slice along
    dim 0, in rank order (``all_gather_into_tensor``): the counterpart of
    ``jax.make_array_from_process_local_data`` read as one array.  Every
    rank's slice must have the same shape; every rank gets the result."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return local
    n = dist.get_world_size(group)
    local = local.contiguous()
    out = local.new_empty((n * local.shape[0], *local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=group)
    return out


def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, nprocs, coordinator, device, args, results) -> None:
    dev = initialize(coordinator, nprocs, rank, device=device)
    try:
        out = fn(dev, *args)
    finally:
        shutdown()
    results.put((rank, out))


def spawn(fn, nprocs: int, *args, device=None, timeout: float | None = None) -> list:
    """Run ``fn(device, *args)`` on ``nprocs`` ranks of one host and return
    their results in rank order.

    Each rank is a fresh process (the *spawn* start method: CUDA cannot be
    forked) that joins a group at a free localhost port (``initialize``),
    calls ``fn`` with its device and leaves the group.  ``fn`` and the
    arguments travel by pickle, so ``fn`` is a module-level function of an
    importable module and its result is small.  A rank that raises ends
    the others and raises here with its traceback; so does a run that
    outlasts ``timeout`` seconds."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, f"127.0.0.1:{free_port()}", device, args, results),
        nprocs=nprocs, join=False, start_method="spawn",
    )
    out: dict = {}
    deadline = None if timeout is None else time.monotonic() + timeout

    def drain():
        while not results.empty():
            rank, res = results.get()
            out[rank] = res

    try:
        while not ctx.join(timeout=0.5):  # raises if a rank failed
            drain()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} outlasted {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()
    drain()
    if sorted(out) != list(range(nprocs)):
        raise RuntimeError(f"ranks {sorted(set(range(nprocs)) - set(out))} returned nothing")
    return [out[r] for r in range(nprocs)]

