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

`Mesh` covers both: `devices` are the devices THIS process drives, and
`group` is the process group when the (one) axis spans processes (then
`devices` is this rank's one device), else None.  A mesh of one process
may have several axes: its devices lie on a grid in row-major order over
`shape`, as `np.array(devices).reshape(n_dp, n_sp)` lays them out in the
JAX package (`parallel/spatial.make_spatial_mesh`,
`parallel/tensor.make_tp_mesh`); `block` and `along` read the grid.
"""

from __future__ import annotations

import dataclasses
import math
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
    def size(self) -> int:
        """The number of devices on the grid, prod(shape)."""
        return math.prod(self.shape.values())

    def _at(self, index: dict):
        """The device at grid coordinates {axis: i}, 0 on other axes."""
        flat = 0
        for axis, n in self.shape.items():
            flat = flat * n + index.get(axis, 0)
        return self.devices[flat]

    def along(self, axis: str, **fixed) -> tuple:
        """The devices along `axis` in order, the other axes at the
        coordinates `fixed` names (0 where it names none); a mesh without
        `axis` gives the one device at those coordinates."""
        self._check_grid()
        n = self.shape.get(axis, 1)
        return tuple(self._at(dict(fixed, **{axis: i})) for i in range(n))

    def block(self, b: int, axis: str | None = None) -> tuple:
        """The devices of dp block b (index b on "dp"): along `axis` where
        given, else the block's first device alone."""
        if axis is None:
            self._check_grid()
            return (self._at({"dp": b}),)
        return self.along(axis, dp=b)

    def _check_grid(self) -> None:
        if self.group is not None or len(self.devices) != self.size:
            raise ValueError(f"{self} is not a grid of this process's "
                             f"devices")

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
    if devices is not None:
        if n is not None and n != len(devices):
            raise ValueError(f"a mesh of {n} with {len(devices)} devices "
                             f"named")
        n = len(devices)
    elif device == "cpu":
        n = n or 1
    elif n is None:
        n = torch.cuda.device_count()
    return grid_mesh({axis: n}, devices=devices, device=device)


def grid_mesh(shape: dict, *, devices=None, device: str = "cuda") -> Mesh:
    """A mesh of this process over the axes `shape` ({axis: size}, in
    order), its devices on a row-major grid: `devices` as named (a card
    may be named more than once), prod(shape) CPU entries for
    device="cpu", else cuda:0..n-1 (more cards than the machine has
    raise, naming both counts).  The model-parallel meshes
    (`parallel/spatial`, `parallel/tensor`) are grids of one process:
    their serving runs in one process that drives every device."""
    n = math.prod(shape.values())
    if devices is None:
        if device == "cpu":
            devices = [torch.device("cpu")] * n
        else:
            count = torch.cuda.device_count()
            if n > count:
                raise ValueError(f"a mesh of {n} cards needs {n} cards; "
                                 f"this machine has {count}")
            devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_indexed(d) for d in devices]
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if len(devices) != n:
        raise ValueError(f"a mesh of shape {shape} takes {n} devices, "
                         f"got {len(devices)}")
    _check_cards(devices)
    return Mesh(dict(shape), tuple(devices))


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
    the mesh's `axis`: one block a device along it (the other axes at
    index 0), each on its device (in a process group, this rank's block
    alone).  The batch must divide by the axis' size."""
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
            for i, d in enumerate(mesh.along(axis))]


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
    """`tree` on every device this process drives, one entry a device in
    the mesh's row-major order; devices named twice share one copy."""
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

