"""Tensor (model) parallelism (`darknet_tpu/parallel/tensor.py`) on torch:
conv filters split over a mesh's `tp` axis, the batch over `dp`.

Which layers shard is the JAX package's rule, kept exactly (`_tp_layers`):
plain convs (groups 1, no share_index) whose filter count divides the
axis.  Their HWIO weights ("w", "w_q") shard on the output filters and
their per-filter vectors (bias, BN vectors, "w_scale") on (n,); every
other leaf, and every other layer (the heads' 255 filters among them),
is replicated.  `tp_param_specs` gives those specs for numpy params in
the JAX package's layout, as plain tuples (an axis name or None a dim;
() replicated) that equal the JAX PartitionSpecs leaf for leaf.

The JAX package jits the same forward over the mesh and lets GSPMD slice
the filters and insert the all-gathers.  Here one process drives every
device (`make_tp_forward`): each dp block's activation lives on the
block's first device, which runs every replicated layer; a sharded conv
copies its input to each tp device of the block, each computes its
filter slice (the int8 GEMM once a shard, on the shard's filters, where
the params hold "w_q"), and the slices are gathered, concatenated on
channels, on the first device.  The torch params shard on their filter
dim (dim 0 of the OIHW "w" and of the (n, K) "w_q").  Regions and the
stem fold are off, as the JAX package's tp forward turns them off
(their packed layouts interleave channels), so this path launches no
region kernel.  A dynamic int8 scale is the whole batch's: the dp blocks
run layer by layer in lockstep and take max|x| over every block.

Training (`make_tp_train_step`, `darknet_tpu/parallel/tensor.py:149-200`):
the params, their gradients and their optimizer slots split by the same
rule (`tp_opt_specs` for the slots), one params list a shard on its
device (`shard_tp_train`; `gather` merges them back), and the step runs
over `parallel/spatial.MeshTrain`, whose tp layer step is this module's
structure with a backward: the cell's first device runs the replicated
layers, a sharded conv's filter slices run on the group's devices with
their batch norm over every cell's part of their channels, and the
slices concatenate on the cell's first device.  With `sp_axis` a cell
is a (dp block, sp slab): the (dp, sp, tp) step.
"""

from __future__ import annotations

import dataclasses

import torch

from darknet_tpu_torch.nn.emit import _aa_backref_needed, _aa_split
from darknet_tpu_torch.nn.emit import make_forward
from darknet_tpu_torch.ops.conv import antialias_blur
from darknet_tpu_torch.ops.quant_matmul import input_scale
from darknet_tpu_torch.parallel.mesh import Mesh, grid_mesh
from darknet_tpu_torch.parallel.spatial import _decode


def make_tp_mesh(n_dp: int, n_tp: int, *, devices=None,
                 device: str = "cuda") -> Mesh:
    """A ("dp", "tp") mesh of n_dp x n_tp devices of this process
    (`parallel/mesh.grid_mesh`)."""
    return grid_mesh({"dp": n_dp, "tp": n_tp}, devices=devices,
                     device=device)


def _tp_layers(graph, n_tp: int) -> set:
    """Graph indices of convs whose filters shard evenly over `n_tp`."""
    out = set()
    for i, l in enumerate(graph.layers):
        if (l.kind == "convolutional" and getattr(l, "groups", 1) == 1
                and getattr(l, "share_index", None) is None
                and l.n % n_tp == 0):
            out.add(i)
    return out


def _leaf_spec(key, arr, n, axis) -> tuple:
    """The spec of one numpy (HWIO) leaf of an eligible conv."""
    shape = getattr(arr, "shape", ())
    if key in ("w", "w_q") and len(shape) == 4 and shape[3] == n:
        return (None, None, None, axis)
    if len(shape) == 1 and shape[0] == n:   # b / scales / rolling / w_scale
        return (axis,)
    return ()


def tp_param_specs(graph, params, n_tp: int, *, axis: str = "tp") -> list:
    """Specs matching a numpy params list (the JAX package's layout)."""
    elig = _tp_layers(graph, n_tp)
    return [{k: _leaf_spec(k, v, graph.layers[i].n, axis) if i in elig
             else () for k, v in p.items()} for i, p in enumerate(params)]


def _filter_dim(key, t, n) -> bool:
    """Whether a torch leaf of an eligible conv shards on dim 0: the OIHW
    "w", the (n, K) "w_q" and the (n,) vectors."""
    if key in ("w", "w_q") and t.dim() in (2, 4) and t.shape[0] == n:
        return True
    return t.dim() == 1 and t.shape[0] == n


def shard_tp_params(mesh: Mesh, graph, params, *, axis: str = "tp") -> list:
    """The port's torch params placed over the mesh: placed[b][t] is the
    params list of dp block b's tp device t, each eligible conv's filter
    slice there, every other layer on the block's first tp device only
    (which runs it) and {} elsewhere."""
    n_tp = mesh.shape[axis]
    elig = _tp_layers(graph, n_tp)
    placed = []
    for b in range(mesh.shape.get("dp", 1)):
        row = []
        for t, d in enumerate(mesh.block(b, axis)):
            on = []
            for i, p in enumerate(params):
                n = graph.layers[i].n if i in elig else 0
                if i in elig:
                    per = n // n_tp
                    on.append({k: (v.narrow(0, t * per, per)
                                   if _filter_dim(k, v, n) else v).to(d)
                               for k, v in p.items()})
                else:
                    on.append({k: v.to(d) for k, v in p.items()}
                              if t == 0 else {})
            row.append(on)
        placed.append(row)
    return placed


class TensorForward:
    """The serving forward with the eligible convs' filters split over
    the tp devices of each dp block (the module docstring).

    tf.heads(placed, blocks) -> one list a block of its activated heads on
    the block's first device; blocks are (tp devices, the block's batch
    on the first), placed[b][t] the params list of block b's device t
    (`shard_tp_params`)."""

    def __init__(self, graph, n_tp: int, *, compute_dtype=None,
                 fused_bn: bool = True):
        self.graph = graph
        self.n_tp = n_tp
        self.fwd = make_forward(graph, compute_dtype=compute_dtype,
                                fused_bn=fused_bn, fuse_regions=None)
        self.elig = _tp_layers(graph, n_tp)

    def _src(self, i, l):
        s = getattr(l, "share_index", None)
        return i if s is None else s

    def _entry(self, placed_b, src):
        """A layer's full params on the block's first device: a sharded
        owner's slices gathered (a share_index borrower of an eligible
        conv)."""
        if src not in self.elig:
            return placed_b[0][src]
        ref = placed_b[0][src]
        home = ref["b"].device
        per = self.graph.layers[src].n // self.n_tp
        return {k: torch.cat([p[src][k].to(home) for p in placed_b])
                if k != "x_scale" and _filter_dim(k, v, per) else v
                for k, v in ref.items()}

    def heads(self, placed, blocks) -> list:
        layers, fwd = self.graph.layers, self.fwd
        states = [{"devs": tuple(devs), "cur": x, "outs": {}, "heads": []}
                  for devs, x in blocks]
        for i, l in enumerate(layers):
            scale = None
            if l.kind == "convolutional":
                src = self._src(i, l)
                p0 = placed[0][0][src]
                if "w_q" in p0 and "x_scale" not in p0:
                    m = None
                    for st in states:
                        v = st["cur"].float().abs().amax()
                        m = v if m is None else torch.maximum(
                            m, v.to(m.device))
                    scale = torch.clamp_min(m, 1e-8)
            for b, st in enumerate(states):
                self._step(i, l, st, placed[b], scale)
        return [st["heads"] for st in states]

    def _step(self, i, l, st, placed_b, scale):
        fwd, devs, cur = self.fwd, st["devs"], st["cur"]
        home = devs[0]

        def with_scale(p, dev):
            if scale is None:
                return p
            on = scale.to(dev)
            return dict(p, x_scale=input_scale(on, absmax=on))

        if i not in self.elig:
            params = placed_b[0]
            if l.kind == "convolutional":
                src = self._src(i, l)
                params = {src: with_scale(self._entry(placed_b, src), home)}
            st["cur"] = fwd.layer(i, l, cur, st["outs"], {}, st["heads"], [],
                                  params)
            return
        aa = bool(getattr(l, "antialiasing", 0))
        l1 = dataclasses.replace(l, antialiasing=0) if aa else l
        parts = []
        for t, d in enumerate(devs):
            p = with_scale(placed_b[t][i], d)
            parts.append(fwd.layer(i, l1, cur.to(d, non_blocking=True), {},
                                   {}, [], [], {i: p}))
        y = torch.cat([y.to(home, non_blocking=True) for y in parts], -1)
        if aa:
            if _aa_backref_needed(l, i, fwd.live):
                y, st["outs"][i] = _aa_split(y, l)
            else:
                y = antialias_blur(y, l)
                if i in fwd.live:
                    st["outs"][i] = y
        elif i in fwd.live:
            st["outs"][i] = y
        st["cur"] = y


def make_tp_forward(graph, mesh: Mesh, *, axis: str = "tp",
                    dp_axis: str | None = "dp", compute_dtype=None,
                    fused_bn: bool = True, decode: bool = True):
    """`fn(params, x) -> (boxes, obj, cls)` with the conv filters split
    over `axis` and the batch over `dp_axis` (when the mesh has it): the
    outputs in the unsharded order on the mesh's first device, or with
    decode=False the activated heads.  params are the port's torch
    params, placed once per list (`shard_tp_params`)."""
    n_tp = mesh.shape[axis]
    tf = TensorForward(graph, n_tp, compute_dtype=compute_dtype,
                       fused_bn=fused_bn)
    n_dp = mesh.shape[dp_axis] if dp_axis and dp_axis in mesh.shape else 1
    held: dict = {}
    home = mesh.devices[0]

    def run(params, x):
        if held.get("src") is not params:
            held["src"] = params
            held["placed"] = shard_tp_params(mesh, graph, params, axis=axis)
        x = torch.as_tensor(x)
        if x.shape[0] % n_dp:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"mesh's dp size {n_dp}")
        per = x.shape[0] // n_dp
        blocks = []
        for b in range(n_dp):
            devs = mesh.block(b, axis)
            blocks.append((devs, x[b * per:(b + 1) * per].to(devs[0])))
        with torch.inference_mode():
            per_block = tf.heads(held["placed"], blocks)
            if not decode:
                return [torch.cat([h[k].to(home) for h in per_block])
                        for k in range(len(per_block[0]))]
            dec = [_decode(h, graph) for h in per_block]
            return tuple(torch.cat([d[k].to(home) for d in dec])
                         for k in range(3))

    return run


# ------------------------------------------------------------------ training
def tp_opt_specs(graph, opt_state, params, n_tp: int, *,
                 axis: str = "tp") -> dict:
    """Specs of a numpy SGD or Adam state in the JAX package's layout
    (`darknet_tpu/parallel/tensor.py:68-83`): the params-shaped slot lists
    ("u", "m", "v") shard exactly as the params; every other entry is
    replicated (())."""
    elig = _tp_layers(graph, n_tp)

    def slots(tree):
        return [{k: _leaf_spec(k, v, graph.layers[i].n, axis) if i in elig
                 else () for k, v in p.items()} for i, p in enumerate(tree)]

    return {k: slots(v) if isinstance(v, list) else ()
            for k, v in opt_state.items()}


def shard_tp_train(graph, tree, n_tp: int, homes, *, grad: bool) -> list:
    """A params-shaped list of the port's training tensors (the params,
    or an optimizer slot list) split over the tp shards: one list a
    shard, shard t on homes[t], holding its filter slice of each
    eligible conv (every leaf of one shards on dim 0); every other layer
    whole in shard 0 and {} elsewhere.  Fresh tensors; with `grad` the
    trainable ones ("w", "b", "scales") require grad."""
    from darknet_tpu_torch.nn.params import TRAINABLE

    elig = _tp_layers(graph, n_tp)
    out = []
    for t, home in enumerate(homes):
        shard = []
        for i, p in enumerate(tree):
            if i not in elig and t:
                shard.append({})
                continue
            q = {}
            for k, v in p.items():
                if i in elig:
                    n = graph.layers[i].n
                    if not _filter_dim(k, v, n):
                        raise ValueError(f"layer {i} {k!r} {tuple(v.shape)}: "
                                         f"not a filter-dim leaf")
                    per = n // n_tp
                    v = v.narrow(0, t * per, per)
                c = torch.empty_like(v, device=home,
                                     memory_format=torch.preserve_format)
                with torch.no_grad():
                    c.copy_(v)
                q[k] = c.requires_grad_(grad and k in TRAINABLE)
            shard.append(q)
        out.append(shard)
    return out


def gather(placed) -> list:
    """Shards (`shard_tp_train`'s lists) merged into one params-shaped
    list: each sharded leaf's slices concatenated on filters (the
    counterpart of reading a sharded `jax.Array` whole), detached, on
    shard 0's device."""
    out = []
    for i, p0 in enumerate(placed[0]):
        out.append({k: torch.cat([s[i][k].detach().to(v.device)
                                  for s in placed if s[i]])
                    for k, v in p0.items()})
    return out


def gather_opt(opts) -> dict:
    """Per-shard optimizer states merged into one (`gather` on each slot
    list; the counter is the shards' own, equal in all)."""
    return {k: gather([o[k] for o in opts]) if isinstance(v, list) else v
            for k, v in opts[0].items()}


def make_tp_train_step(graph, mesh: Mesh, *, axis: str = "tp",
                       dp_axis: str = "dp", sp_axis: str | None = None,
                       accum: int = 1, compute_dtype=None,
                       train_act_dtype=None):
    """(step, place): the training step with the eligible convs' filters,
    their gradients and their optimizer slots split over the mesh's tp
    axis, the batch over `dp_axis` and, with `sp_axis`, every map's rows
    over it (`darknet_tpu/parallel/tensor.py:149-200`; the 3-axis step).

    place(params, opt_state, x=None, truths=None) -> (placed, opts[, x,
    truths]): the port's training params (torch, `nn/params.
    train_params_to_torch`) and optimizer state split by `tp_param_specs`/
    `tp_opt_specs`' rule, one list a shard, shard t on the device at
    (dp 0, sp 0, tp t), which runs its optimizer; x and truths on the
    mesh's first device.
    step(placed, opts, x, truths, lr, generator=None) -> (placed, opts,
    cost, metrics), in place.  `gather(placed)` gives one params list
    back.

    A cell (a dp block, and an sp slab) is a tp group: its activation
    lives on the group's first device, which runs every replicated layer
    (the heads' 255-filter convs among them) once; an eligible conv runs
    on every device of the group over its filter slice, its batch norm
    over that slice's channels in every cell (one node, `ops/
    train_epilogue.bn_act_train_parts`), and the slices are concatenated
    on channels on the cell's device (`parallel/spatial.MeshTrain`).
    Regions and the stem fold are off, as in the JAX package's tp step.
    The step equals `train/step.make_train_step(accum=...)`'s on the
    whole batch."""
    from darknet_tpu_torch.parallel.spatial import (MeshTrain,
                                                    mesh_train_step)

    if axis not in mesh.shape:
        raise ValueError(f"{mesh} has no {axis!r} axis for the tp step")
    if sp_axis is not None and sp_axis not in mesh.shape:
        raise ValueError(f"{mesh} has no {sp_axis!r} axis")
    n_tp = mesh.shape[axis]
    elig = _tp_layers(graph, n_tp)
    ex = MeshTrain(graph, mesh, dp_axis=dp_axis, sp_axis=sp_axis,
                   tp_axis=axis, elig=elig, compute_dtype=compute_dtype,
                   train_act_dtype=train_act_dtype)
    inner = mesh_train_step(graph, ex, accum=accum)

    def place(params, opt_state, x=None, truths=None):
        placed = shard_tp_train(graph, params, n_tp, ex.homes, grad=True)
        slots = {k: shard_tp_train(graph, v, n_tp, ex.homes, grad=False)
                 for k, v in opt_state.items() if isinstance(v, list)}
        opts = [{k: slots[k][t] if k in slots else v
                 for k, v in opt_state.items()} for t in range(n_tp)]
        out = [placed, opts]
        for a in (x, truths):
            if a is not None:
                out.append(torch.as_tensor(a).to(ex.first))
        return tuple(out)

    def step(placed, opts, x, truths, lr, generator=None):
        if len(placed) != n_tp:
            raise ValueError(f"{len(placed)} shards placed for a tp axis "
                             f"of {n_tp} (use `place`)")
        cost, metrics = inner(placed, opts, x, truths, lr, generator)
        return placed, opts, cost, metrics

    return step, place
