"""Processes of a data-parallel world (`darknet_tpu/parallel/multihost.py`)
on torch: each process builds only its block of the global batch, the
GetPartialData split (data.cpp:890-901), and `make_global_batch`
assembles the global batch where a caller needs it.

`spawn(fn, devices, *args)` starts one process a device with
`torch.multiprocessing` (the spawn method), joins them into one
`torch.distributed` world over a free local port and calls
`fn(rank, *args)` in each.  The backend is chosen from the devices and
printed: NCCL where each rank has a card of its own, gloo where ranks
share a card or run on the CPU (NCCL refuses two ranks on one card;
gloo sums CUDA tensors through the host), and gloo for a grid with a
model-parallel axis (its exchanges match messages by tag, which NCCL
does not: `ops/collective`).  A failing collective raises;
nothing retries on another backend or on the CPU.
"""

from __future__ import annotations

import datetime
import socket
import time

import torch
import torch.distributed as dist


def process_batch_slice(global_batch: int) -> tuple:
    """(start, size) of this process's contiguous block of the global
    batch, [r*B/n, (r+1)*B/n); (0, B) outside a distributed world.  The
    batch must divide by the world."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, global_batch
    n, i = dist.get_world_size(), dist.get_rank()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{n} processes")
    per = global_batch // n
    return i * per, per


def make_global_batch(mesh, local, axis: str | None = None):
    """The global batch on this rank's device, every rank's block in rank
    order, from this rank's block `local` (a tensor).  In one process
    (mesh.group None) the local block is the global batch.  With `axis`
    (a grid that spans the world, `parallel/mesh.world_mesh`) the blocks
    of the ranks along that axis through this one, in coordinate order.
    Under gloo, which has no CUDA all_gather, the blocks travel through
    the host."""
    if mesh.group is None:
        return local
    group = mesh.group if axis is None else mesh.sub(axis)
    if group is None:
        return local
    world = dist.get_world_size(group)
    staged = local.contiguous()
    if dist.get_backend(group) == "gloo":
        staged = staged.cpu()
    parts = [torch.empty_like(staged) for _ in range(world)]
    dist.all_gather(parts, staged, group=group)
    return torch.cat(parts).to(local.device)


def backend_for(devices, shape: dict | None = None) -> str:
    """"nccl" where every rank has a card of its own, else "gloo" (ranks
    sharing a card, or on the CPU); "gloo" too for a grid `shape` with an
    axis other than "dp" of several ranks (the model-parallel exchanges
    run over gloo, `ops/collective`)."""
    if any(n > 1 for a, n in (shape or {}).items() if a != "dp"):
        return "gloo"
    devices = [torch.device(d) for d in devices]
    cards = [d for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and \
            len({d.index or 0 for d in cards}) == len(cards):
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on localhost for the world's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# how long a rank waits for the others at the rendezvous or in a
# collective before it raises
COLLECTIVE_TIMEOUT_S = 600


def init_process(rank: int, devices, port: int,
                 shape: dict | None = None) -> str:
    """Join this process to a world of len(devices) ranks at
    tcp://localhost:<port>; rank r drives devices[r].  Returns the
    backend (`backend_for(devices, shape)`), which rank 0 prints."""
    backend = backend_for(devices, shape)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}",
        world_size=len(devices), rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if rank == 0:
        print(f"torch.distributed: {backend}, {len(devices)} ranks on "
              f"{[str(d) for d in devices]}", flush=True)
    return backend


def _rank_main(rank, fn, devices, port, args, shape):
    init_process(rank, devices, port, shape)
    try:
        if shape is None:
            fn(rank, *args)
        else:
            from darknet_tpu_torch.parallel.mesh import world_mesh

            fn(rank, *args, mesh=world_mesh(shape, devices=devices))
    finally:
        dist.destroy_process_group()


def spawn(fn, devices, *args, timeout_s: float | None = None,
          shape: dict | None = None) -> None:
    """Run fn(rank, *args) in len(devices) new processes joined into one
    world (rank r on devices[r]); returns when every rank has returned and
    raises when any rank raised (the others are then stopped).  With
    `shape` ({axis: size}, prod = the number of devices) each rank first
    makes the grid mesh of that shape over the world (`parallel/mesh.
    world_mesh`) and is called fn(rank, *args, mesh=mesh).  With
    timeout_s, ranks still running after it are killed and TimeoutError
    raised.  `fn` and `args` must pickle (`fn` a module-level function)."""
    import torch.multiprocessing as tmp

    devices = [str(d) for d in devices]
    ctx = tmp.start_processes(
        _rank_main, args=(fn, devices, free_port(), args, shape),
        nprocs=len(devices), start_method="spawn", join=False)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
            raise TimeoutError(f"{len(devices)} ranks still running after "
                               f"{timeout_s} s")
