"""Device mesh and batch placement, the communication layer
(`darknet_tpu/parallel/mesh.py`) on torch: data parallelism over a `dp`
axis.

The JAX package drives every device from one process and lets GSPMD
insert the sums.  The port follows PyTorch instead where it trains: one
process a device, joined by `torch.distributed` (`parallel/multihost`),
each rank holding an equal block of the batch (`parallel/dp`).  Serving
stays in one process, as the JAX package's does: a mesh there is a list
of devices, each holding a replica of the serving state, and a batch
splits over them (`Network.submit_detect_device(mesh=)`).

`Mesh` covers both: `devices` are the devices THIS process drives on the
axis, and `group` is the process group when the axis spans processes
(then `devices` is this rank's one device), else None.  The model-parallel
axes (`sp`, `tp`, pipeline stages) are ROADMAP A7b.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Mesh:
    """shape: {axis name: size}, as the JAX mesh's `shape` ({"dp": n});
    devices: the torch.devices this process drives on the axis; group: the
    process group that spans the axis, or None (one process)."""

    shape: dict
    devices: tuple
    group: object = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def rank(self) -> int:
        """This process's index on the axis (0 in one process)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    def __repr__(self) -> str:
        procs = (f", {dist.get_world_size(self.group)} processes"
                 if self.group is not None else "")
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]}{procs})")


def make_mesh(n: int | None = None, axis: str = "dp", *, devices=None,
              device: str = "cuda") -> Mesh:
    """A one-axis mesh of `n` devices.

    Under an initialised `torch.distributed` the mesh spans the world, one
    device a rank: `cuda:<local rank>` (or the CPU for device="cpu"), or
    `devices[rank]` where the caller names every rank's device (e.g.
    ["cuda:0", "cuda:0"]: two ranks sharing one card).  Otherwise it is n
    devices of this process: cuda:0..n-1 (n=None: every card), n CPU
    entries for device="cpu", or `devices` as named.  A mesh of more cards
    than the machine has raises, naming both counts; nothing wraps
    around."""
    if devices is not None:
        devices = [_indexed(d) for d in devices]
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n is not None and n != world:
            raise ValueError(f"a mesh of {n} over a world of {world} ranks")
        if devices is not None:
            if len(devices) != world:
                raise ValueError(f"{len(devices)} devices named for a world "
                                 f"of {world} ranks")
            mine = devices[rank]
        elif device == "cpu":
            mine = torch.device("cpu")
        else:
            mine = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                           rank)))
        _check_cards([mine])
        return Mesh({axis: world}, (mine,), dist.group.WORLD)
    if devices is None:
        if device == "cpu":
            devices = [torch.device("cpu")] * (n or 1)
        else:
            count = torch.cuda.device_count()
            n = count if n is None else n
            if n > count:
                raise ValueError(f"a mesh of {n} cards needs {n} cards; "
                                 f"this machine has {count}")
            devices = [torch.device("cuda", i) for i in range(n)]
    elif n is not None and n != len(devices):
        raise ValueError(f"a mesh of {n} with {len(devices)} devices named")
    if not devices:
        raise ValueError("a mesh needs at least one device")
    _check_cards(devices)
    return Mesh({axis: len(devices)}, tuple(devices))


def _indexed(d) -> torch.device:
    """A device name as a torch.device; "cuda" alone is cuda:0."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


def _check_cards(devices) -> None:
    """Every CUDA device named exists (no quiet wrap-around)."""
    count = torch.cuda.device_count()
    for d in devices:
        if d.type == "cuda" and (d.index or 0) >= count:
            raise ValueError(f"{d} named for the mesh; this machine has "
                             f"{count} cards")


def shard_batch(mesh: Mesh, x, axis: str = "dp") -> list:
    """The leading (batch) dim of `x` (a tensor or an array) split over
    the mesh: one block a device this process drives, each on its device
    (in a process group, this rank's block alone).  The batch must divide
    by the axis' size."""
    n = mesh.shape[axis]
    x = torch.as_tensor(x)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by the mesh's "
                         f"{axis} size {n}")
    per = x.shape[0] // n
    if mesh.group is not None:
        r = mesh.rank
        return [x[r * per:(r + 1) * per].to(mesh.devices[0])]
    return [x[i * per:(i + 1) * per].to(d)
            for i, d in enumerate(mesh.devices)]


def to_device(tree, device):
    """A copy of a tree of lists, tuples and dicts of tensors on `device`,
    each with its strides (channels_last stays channels_last); a tensor
    already there is the same tensor."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.device != device:
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype,
                                   device=device).copy_(tree)
    return tree


def replicate(mesh: Mesh, tree) -> list:
    """`tree` on every device this process drives, one entry a device;
    devices named twice share one copy."""
    copies: dict = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = to_device(tree, d)
    return [copies[d] for d in mesh.devices]


def round_batch_to_mesh(batch: int, n_dp: int) -> int:
    """Smallest adjustment of an inference batch so it divides over a
    dp mesh (serving requires batch % n_dp == 0): at least n_dp, rounded
    down to a multiple.  Shared by the valid mode's -num_chips path and
    the trainer's in-training mAP."""
    batch = max(batch, n_dp)
    return batch - batch % n_dp

