"""Multi-process data parallelism over ``torch.distributed`` (counterpart of
``parallel/distributed.py``).

The JAX package runs one process per host and lets XLA insert every
cross-device reduction.  Here each rank is a process that owns a shard of
the envs (:class:`.sharding.Shard`) and calls two collectives itself:
``all_reduce`` (SUM) and ``broadcast``, each on one flat buffer where
several tensors travel together.  Those two are what the gloo backend
carries on CUDA tensors as well as CPU ones, so a run may name gloo to put
several ranks on one card; NCCL, the default on CUDA, needs a card per rank
and refuses to share one.

The backend and the device are explicit: nothing falls back to another
backend or to the CPU.  :func:`init_distributed` reads the ``LTPU_*``
variables the JAX package reads, else torchrun's (``env://``), and
:func:`launch` spawns K ranks on this host, the ``--num_devices K`` of the
train entries.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from .. import tracing


def rank_device(device, local_rank: int | None = None) -> torch.device:
    """The device of a rank: ``cpu``, the named ``cuda:i``, or for a bare
    ``cuda`` the card ``local_rank % device_count`` (``local_rank``
    defaults to torchrun's ``LOCAL_RANK``, else the process group's rank).
    Raises when the card is missing."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(f"device {device}: torch sees no CUDA device")
    if dev.index is None:
        if local_rank is None:
            local_rank = int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local_rank % count)
    if dev.index >= count:
        raise RuntimeError(f"device {dev}: torch sees {count} CUDA device(s)")
    return dev


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device="cuda") -> tuple[int, int]:
    """Join the process group and return ``(rank, world)``.

    Arguments first, then ``LTPU_COORDINATOR`` / ``LTPU_NUM_PROCESSES`` /
    ``LTPU_PROCESS_ID``; with no coordinator, torchrun's ``env://``
    variables (the counterpart of ``jax.distributed.initialize()``'s
    autodetection).  ``backend`` defaults to ``nccl`` for a CUDA
    ``device`` and ``gloo`` for the CPU.  NCCL with more ranks on this host
    than cards raises, naming the counts; on CUDA the rank's card
    (:func:`rank_device`) becomes the current device."""
    coordinator_address = coordinator_address or os.environ.get("LTPU_COORDINATOR")
    if num_processes is None and "LTPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LTPU_NUM_PROCESSES"])
    if process_id is None and "LTPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LTPU_PROCESS_ID"])
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                    rank=process_id)
        world, rank = num_processes, process_id
    else:
        init = dict(init_method="env://")
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs CUDA devices, not {device}")
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world > count:
            raise ValueError(f"nccl needs a card for each rank: {local_world} ranks on this "
                             f"host, {count} card(s); name backend 'gloo' to share cards")
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(device, local_rank))
    dist.init_process_group(backend, **init)
    if (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise RuntimeError(f"process group rank {dist.get_rank()} of "
                           f"{dist.get_world_size()}, expected {rank} of {world}")
    return rank, world


def flat(tensors: list) -> torch.Tensor:
    """``tensors`` flattened into one buffer: of their dtype where they share
    one, else float64."""
    dtypes = {t.dtype for t in tensors}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float64
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def unflat(buf: torch.Tensor, like: list) -> list:
    """The tensors of :func:`flat`'s buffer, in the shapes and dtypes of
    ``like``."""
    out, i = [], 0
    for t in like:
        out.append(buf[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def all_reduce_sum(tensors: list) -> list:
    """The sums over the ranks of ``tensors``, one ``all_reduce`` of one
    :func:`flat` buffer, returned as new tensors of the inputs' shapes and
    dtypes.  Every rank receives the same bytes."""
    buf = flat(tensors)
    with tracing.span("dist.all_reduce") as s:
        s.add("bytes", buf.numel() * buf.element_size())
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return unflat(buf, tensors)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loopback_bootstrap():
    """Point gloo's and NCCL's bootstrap sockets at the loopback interface,
    where the caller has not named one: for a group whose ranks all run on
    this host.  NCCL takes ``lo`` only when it finds no other interface, and
    on a host without a network another interface need not reach this host's
    ranks."""
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")


def _run_rank(rank, fn, world, port, backend, device, args):
    # every rank of a launch is local: rank_device reads these, and the
    # ranks connect over the loopback interface
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    loopback_bootstrap()
    init_distributed(f"127.0.0.1:{port}", world, rank, backend=backend, device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, *args, backend: str | None = None, device="cuda"):
    """Run ``fn(*args)`` in ``nprocs`` ranks on this host, each a process
    started with ``spawn`` (CUDA cannot be forked) that has joined one
    process group over a local port (:func:`init_distributed` with
    ``backend`` and ``device``).  ``fn`` must be importable by name.  Returns
    when every rank has; a rank's exception is raised here."""
    import torch.multiprocessing as mp
    mp.start_processes(_run_rank, args=(fn, nprocs, _free_port(), backend, device, args),
                       nprocs=nprocs, start_method="spawn", join=True)


def is_rank0() -> bool:
    """True outside a process group and on its rank 0 (the rank that prints
    and writes)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def entry_device(device) -> torch.device:
    """The device a train entry trains on: in a process group the rank's
    (:func:`rank_device`), else ``device``; raises where CUDA is asked for
    and torch sees none."""
    if dist.is_initialized():
        return rank_device(device)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}, but torch sees no CUDA device "
                           f"(--device cpu trains on the CPU)")
    return dev


def run_ranks(fn, args):
    """``fn(args)`` in the ranks a train entry's flags ask for:
    ``--num_devices`` K > 1 spawns K ranks on this host (:func:`launch`,
    returns None), ``--distributed`` joins a group launched outside
    (``LTPU_*`` or torchrun; on one host, with :func:`loopback_bootstrap`),
    else one process.  ``--dist_backend`` and ``--device`` pass to
    :func:`init_distributed`."""
    k = getattr(args, "num_devices", None) or 1
    if k > 1:
        return launch(fn, k, args, backend=args.dist_backend, device=args.device)
    if getattr(args, "distributed", False):
        world = os.environ.get("WORLD_SIZE")
        if world is not None and os.environ.get("LOCAL_WORLD_SIZE") == world:
            loopback_bootstrap()        # torchrun's group on this host alone
        init_distributed(backend=args.dist_backend, device=args.device)
        try:
            return fn(args)
        finally:
            dist.destroy_process_group()
    return fn(args)
