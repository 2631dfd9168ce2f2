"""Process groups: one process per rank over ``torch.distributed``.

Port of ``deepim_tpu/parallel/distributed.py`` (``initialize_multihost``,
``global_mesh``, ``process_local_batch_size``).  Where the reference runs
one program over every chip of a slice, the port runs one process per
rank, launched by :func:`spawn` (what ``--n-devices`` does) or by
``torchrun``, whose environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) gives the defaults.

Placement and backend, one rule for every entry point (:func:`placement`):

- rank r runs on ``cuda:(LOCAL_RANK % device_count)``, or on the CPU;
- the backend is NCCL when each local rank has a card of its own, and gloo
  when ranks share a card or run on the CPU.

NCCL refuses two ranks on one card, and gloo has no ``all_gather`` or
``reduce_scatter`` for CUDA tensors, so the port's collectives are
``all_reduce``, ``broadcast`` and ``barrier`` only.  A failed init raises;
nothing retries with another backend.
"""

from __future__ import annotations

import os
import socket
import tempfile

import torch
import torch.distributed as dist

_DEVICE: torch.device | None = None  # this rank's device, set by initialize_multihost


def world_size() -> int:
    """Ranks in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """``dist.barrier()`` when there is a group."""
    if dist.is_initialized():
        dist.barrier()


def env_world() -> int:
    """``WORLD_SIZE`` of the environment (1 when unset): above 1 under
    ``torchrun`` and in :func:`spawn`'s workers."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def placement(device_type: str, local_rank: int, local_world: int
              ) -> tuple[torch.device, str]:
    """(device, backend) of local rank ``local_rank`` of ``local_world``
    ranks on this host: ``cuda:(local_rank % device_count)`` and NCCL when
    every local rank has a card of its own, gloo when they share; the CPU
    and gloo for ``device_type`` "cpu"."""
    if device_type == "cpu":
        return torch.device("cpu"), "gloo"
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r} is not 'cuda' or 'cpu'")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device; pass --device cpu to run the ranks on the CPU")
    return torch.device("cuda", local_rank % n), ("nccl" if local_world <= n else "gloo")


def describe(device: torch.device) -> str:
    """The placement line every entry point prints."""
    backend = dist.get_backend() if dist.is_initialized() else "none"
    where = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    return (f"placement: rank {rank()} of {world_size()} on {device} ({where}), "
            f"backend {backend}; rank r runs on cuda:(LOCAL_RANK % device_count), NCCL "
            "when each rank has a card of its own, gloo when ranks share one or run on "
            "the CPU")


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device_type: str = "cuda") -> torch.device:
    """``torch.distributed.init_process_group`` for this process -> its
    device (made current on CUDA).

    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``, the local rank to ``LOCAL_RANK`` (else the rank) of
    ``LOCAL_WORLD_SIZE`` (else the world).  Without
    ``coordinator_address`` ("host:port") the group meets where the
    environment says (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, or
    torchrun's store).  The backend is :func:`placement`'s.
    """
    global _DEVICE
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    r = process_id if process_id is not None else int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", r))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev, backend = placement(device_type, local_rank, local_world)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev  # binds the communicator to the card now
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address.removeprefix('tcp://')}")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=r, **kwargs)
    _DEVICE = dev
    return dev


def global_mesh(n_model: int = 1):
    """The (data, model) mesh over every rank of the default group."""
    from deepim_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_data=world_size() // n_model, n_model=n_model)


def process_local_batch_size(global_batch: int) -> int:
    """This rank's share of ``global_batch`` (the rank-sharded input
    pipelines' batch size)."""
    n = world_size()
    assert global_batch % n == 0, f"global batch {global_batch} must divide {n} processes"
    return global_batch // n


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(index: int, fn, world: int, device_type: str, port: int, out_dir: str,
             args: tuple) -> None:
    os.environ.update(RANK=str(index), WORLD_SIZE=str(world), LOCAL_RANK=str(index),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    if device_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = initialize_multihost(device_type=device_type)
    try:
        out = fn(dev, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{index}.pt"))


def spawn(fn, world: int, device_type: str = "cuda", *args) -> list:
    """Run ``fn(device, *args)`` on ``world`` new processes (start method
    ``spawn``), each rank of one group placed by :func:`placement` ->
    each rank's return value, in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    what ``torch.save`` can write.  A rank that raises or dies fails the
    call, and the others are stopped.
    """
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.start_processes(
            _spawned, args=(fn, world, device_type, free_port(), out_dir, args),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{i}.pt"), weights_only=False)
                for i in range(world)]


def requested_world(n_devices: int, device: torch.device) -> int:
    """The ranks ``--n-devices`` asks for: 0 means every visible card (one
    on the CPU); on CUDA more than the visible cards raises."""
    if device.type != "cuda":
        return max(n_devices, 1)
    visible = torch.cuda.device_count()
    if n_devices > visible:
        raise ValueError(f"--n-devices {n_devices} exceeds the {visible} visible CUDA devices")
    return n_devices or visible


def launch(fn, n_devices: int, device: str, *args):
    """Run ``fn(device, *args)`` on the ranks an entry point asks for ->
    rank 0's return value (this rank's inside a group).

    In a process that is already a rank, ``fn`` runs here on its device;
    under ``torchrun`` (``WORLD_SIZE`` above 1) this process joins the
    group as its rank and runs ``fn`` here; otherwise ``n_devices``
    (:func:`requested_world`) above 1 spawns that many ranks, and 1 runs
    ``fn`` in this process on ``device``, with no group.
    """
    if dist.is_initialized():
        return fn(_DEVICE, *args)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device; pass --device cpu to run "
                           "on the CPU")
    if env_world() > 1:
        dev = initialize_multihost(device_type=dev.type)
        try:
            return fn(dev, *args)
        finally:
            dist.destroy_process_group()
    n = requested_world(n_devices, dev)
    if n > 1:
        return spawn(fn, n, dev.type, *args)[0]
    return fn(dev, *args)
