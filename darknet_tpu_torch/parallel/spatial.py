"""Spatial partitioning (`darknet_tpu/parallel/spatial.py`) on torch: the
feature maps' H split over the `sp` devices of a ("dp", "sp") mesh, the
batch over `dp`, for inputs too large for one device.

The JAX package annotates the input's H as sharded and lets GSPMD write
the halo exchanges.  Here one process drives every device of the mesh and
the executor writes them (`SpatialForward`):

* Partition.  Every map of height H splits over the sp devices of a dp
  block by one rule, rows [floor(iH/n), floor((i+1)H/n)) on device i,
  so slabs may be uneven or empty (a map of 3 rows over 4 devices).  A
  map of one row is replicated: every device of the block holds it.
* Rows a layer reads.  For a slab's output rows the executor derives the
  input rows each layer reads from the layer's own fields (size, stride,
  padding, dilation; an upsample's stride; a region plan's halo), copies
  those rows from the slabs that hold them (a view where the device holds
  them itself) and runs the layer on that extended slab with the
  layer's padding; a window that the extended slab's top or bottom
  edge cuts is dropped, so zero (or -inf) padding applies only at the
  true image edge.  Convs (plain, int8, grouped, dilated, antialiased),
  maxpools, [local], upsample (both ways), [reorg3d], shortcut, route,
  [scale_channels], [batchnorm], activations and the heads are
  row-local; [connected], [avgpool], the [detection] flatten, [crop],
  the legacy [reorg] and [reorg3d]'s reverse (flat CHW permutations)
  and a back-referenced antialiased stride > 1 layer read every row: the
  whole map is gathered on each device of the block first, and the
  output is replicated.
* Regions.  A region with a kernel prefix (`nn/emit.region_runner`)
  takes one exchange of the prefix's own halo (rt, rb rows of its
  coordinates: s2d row pairs for the stem) and runs the kernel once a
  slab on the extended slab; the output drops the halo rows.  The plain
  remainder runs layer by layer through the rules above, its convs as
  the plain steps run them (an int8 conv only with a calibrated scale).
* int8.  A conv whose params hold "w_q" and no calibrated "x_scale"
  quantizes with max|x| over every slab of every block (and over the
  ranks of a process group): the unsharded batch's scale.
* Heads.  Each head is gathered on its block's first device in row
  order, then decoded there.

Every layer runs for every (block, slab) before the next layer starts:
the devices work at once, and an int8 conv's scale is known before any
slab quantizes.  Copies between devices are asynchronous; nothing
synchronises the host inside a request.

Training (`make_spatial_train_step`, the port's form of the JAX
package's `make_train_step` jitted with `P("dp", "sp", None, None)`
inputs) runs `MeshTrain`: the same row rules through the training
forward's per-layer step, every fetch differentiable, each batch norm
one node over every slab of every block; `parallel/tensor.
make_tp_train_step` runs it with a tp group a cell.

Across processes (a grid that spans the world, `parallel/mesh.
world_mesh`, one slab a rank) the same executors run in lockstep on
every rank of a dp block: each rank computes its own slab of every
layer, and `_fetch` becomes an exchange (`_Lane`): the rank that holds
a row a slab reads sends it, the slab's rank receives it, and in
training the row's cotangent comes back the same way
(`ops/collective`).  The int8 scale's max and the batch statistics run
over the dp x sp ranks; the heads come back whole on every rank of the
block.  In training every rank computes the layers that read every
row, and the 1-row maps, on the whole micro-batch gathered from the
ranks (each drawing the same masks from its own generator, seeded
alike); the gather's backward sums the ranks' cotangents, so each
param's gradient, summed over the ranks once the backward is done, is
the one process's.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from darknet_tpu_torch.nn.emit import (_aa_backref_needed, local_block,
                                       make_forward, scope)
from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops import collective
from darknet_tpu_torch.ops import yolo as yoloops
from darknet_tpu_torch.ops.collective import group_max
from darknet_tpu_torch.ops.conv import antialias_blur
from darknet_tpu_torch.ops.quant_matmul import input_scale
from darknet_tpu_torch.parallel.mesh import Mesh, grid_mesh, to_device

# layers that pass their input on unchanged at inference
IDENTITY = ("empty", "blank", "dropout", "cost")
# layers whose output row o reads input row o: window (0, 1, 1)
ROW_LOCAL = ("route", "shortcut", "scale_channels", "activation",
             "batchnorm", "yolo", "gaussian_yolo")


def make_spatial_mesh(n_dp: int, n_sp: int, *, devices=None,
                      device: str = "cuda") -> Mesh:
    """A ("dp", "sp") mesh of n_dp x n_sp devices of this process
    (`parallel/mesh.grid_mesh`: `devices` as named, else cuda:0..n-1, or
    the CPU named n times for device="cpu")."""
    return grid_mesh({"dp": n_dp, "sp": n_sp}, devices=devices,
                     device=device)


def slab_rows(h: int, n: int) -> list:
    """The rows [lo, hi) of each of n devices of a map of height h."""
    return [(i * h // n, (i + 1) * h // n) for i in range(n)]


def shard_spatial(mesh: Mesh, x) -> list:
    """x (B, H, W, C) split over the mesh: one list a dp block, of one
    slab a sp device, each on its device.  The batch must divide by the
    dp size."""
    x = torch.as_tensor(x)
    n_dp = mesh.shape["dp"]
    if x.shape[0] % n_dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by the mesh's "
                         f"dp size {n_dp}")
    per = x.shape[0] // n_dp
    out = []
    for b in range(n_dp):
        devs = mesh.block(b, "sp")
        rows = slab_rows(x.shape[1], len(devs))
        out.append([x[b * per:(b + 1) * per, lo:hi].to(d)
                    for d, (lo, hi) in zip(devs, rows)])
    return out


@dataclasses.dataclass
class _Map:
    """A map of one dp block: a tensor a device (None for an empty slab),
    the rows [lo, hi) each holds (None: every device holds every row),
    and the map's height."""

    parts: list
    rows: list | None
    h: int


class _Lane:
    """The sp slabs of one dp block over ranks of a world grid (`parallel/
    mesh.world_mesh`): slab j on global rank ranks[j], this rank's slab
    `me`.  `extras` collects the training backward's extra roots
    (`ops/collective.zero_root`); None where no grad is taken."""

    def __init__(self, ranks, me: int, extras=None, height=None):
        self.ranks, self.me, self.extras = list(ranks), me, extras
        self.height = height

    def devs(self, dev) -> tuple:
        """The block's devices as the executors index them: this rank's
        own at `me`, None for the slabs other ranks hold."""
        return tuple(dev if j == self.me else None
                     for j in range(len(self.ranks)))

    def send(self, t, j: int) -> None:
        collective.send_grad(t, self.ranks[j], self.extras)

    def recv(self, j: int, dev):
        return collective.recv_grad(self.ranks[j], dev, self.extras)


def _fetch(m: _Map, j: int, lo: int, hi: int, dev, lane=None):
    """Rows [lo, hi) of map m on device j: a view of j's own slab where
    it holds them, else the pieces copied from the slabs that hold them
    (asynchronously) and concatenated on `dev`.  Over a `lane` of ranks
    every rank of the block calls it for every j in the same order: the
    rank that holds a piece sends it, slab j's rank receives it, and the
    others return None (`dev` is None for a slab of another rank)."""
    if lane is not None:
        return _fetch_over(m, j, lo, hi, dev, lane)
    if m.rows is None:
        return m.parts[j][:, lo:hi]
    olo, ohi = m.rows[j]
    if olo <= lo and hi <= ohi:
        return m.parts[j][:, lo - olo:hi - olo]
    pieces = []
    for part, (a, b) in zip(m.parts, m.rows):
        s, e = max(a, lo), min(b, hi)
        if s < e:
            pieces.append(part[:, s - a:e - a].to(dev, non_blocking=True))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1)


def _fetch_over(m: _Map, j, lo, hi, dev, lane):
    """`_fetch` over ranks: the parts of other ranks are None."""
    me = lane.me
    if m.rows is None:
        return m.parts[j][:, lo:hi] if j == me else None
    pieces = []
    for k, (part, (a, b)) in enumerate(zip(m.parts, m.rows)):
        s, e = max(a, lo), min(b, hi)
        if s >= e:
            continue
        if j == me:
            pieces.append(part[:, s - a:e - a] if k == me
                          else lane.recv(k, dev))
        elif k == me:
            lane.send(part[:, s - a:e - a], j)
    if j != me:
        return None
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1)


def _window(lo: int, keff: int, s: int, o_lo: int, o_hi: int, h_in: int):
    """Input rows [a, b) that output rows [o_lo, o_hi) of a window
    (top padding lo, extent keff, stride s) read, with a a multiple of s
    so that the op on rows [a, b) gives output rows from a // s on; the
    op's own top padding then falls on rows it drops, unless a is the
    image's row 0."""
    a = max(0, o_lo * s - s * -(-lo // s))
    b = min(h_in, (o_hi - 1) * s - lo + keff)
    return a, b


def _blur_window(l) -> tuple:
    """(lo, keff, stride) of an antialiased layer's blur."""
    lo, k = (0, 2) if l.antialiasing == 2 else (1, 3)
    return lo, k, l.blur_stride_y


def out_height(l) -> int:
    """A layer's output height as the next layer reads it (an antialiased
    layer's blurred height)."""
    if not getattr(l, "antialiasing", 0):
        return l.out_h
    lo, k, s = _blur_window(l)
    return (l.out_h + 2 * lo - k) // s + 1


def _rule(l, aa_backref: bool):
    """How a layer's output rows read its input's: ("window", lo, keff,
    s), ("up", s) (row o reads row o // s), ("identity",) or ("whole",)
    (every row, `_Map` replicated)."""
    k = l.kind
    if aa_backref:
        return ("whole",)
    if k in IDENTITY:
        return ("identity",)
    if k == "convolutional":
        return ("window", l.pad * l.dilation, l.dilation * (l.size - 1) + 1,
                l.stride_y)
    if k == "maxpool":
        if l.maxpool_depth:
            return ("window", 0, 1, 1)
        return ("window", l.pad // 2, l.size, l.stride_y)
    if k == "local":
        return ("window", l.pad, l.size, l.stride)
    if k == "upsample":
        return ("window", 0, l.stride, l.stride) if l.reverse else \
            ("up", l.stride)
    if k == "reorg" and not l.reverse:
        return ("window", 0, l.stride, l.stride)
    if k in ROW_LOCAL:
        return ("window", 0, 1, 1)
    return ("whole",)


class SpatialForward:
    """The serving forward over spatial slabs (the module docstring).

    sf.heads(params_of, blocks, group=None, lane=None) -> one list a
    block of its activated heads, each on the block's first device.
    blocks: one (devices, slabs) a dp block, the slabs of the net input by
    `slab_rows` over those devices; params_of(device) -> the forward's
    params on that device (`make_forward(...).with_step_weights` where
    the regions should read held step weights).  `group`: the process
    group whose ranks run the other slabs and blocks (int8 scales are
    maxed over it).  `lane` (a `_Lane`): the block's slabs are held by
    the ranks of a world grid, one a rank; blocks is then this rank's
    block alone, its devices `lane.devs(device)` and its slabs None but
    this rank's, every rank of the block runs every layer in lockstep
    with the others (each computing its own slab, sending the rows the
    others read and receiving those it reads), and the heads come back
    whole on every rank of the block.  `fwd` is the unsharded forward whose layers and region runners
    the slabs run (default: `make_forward` with the options given)."""

    def __init__(self, graph, *, compute_dtype=None, fused_bn: bool = True,
                 fwd=None):
        self.graph = graph
        self.fwd = fwd or make_forward(graph, compute_dtype=compute_dtype,
                                       fused_bn=fused_bn)
        self.layers = graph.layers
        self.live = self.fwd.live
        self._lane = None
        plans = self.fwd.region_plans
        self.region_of = {k: a for a, p in plans.items()
                          for k in range(a, p.stop + 1)}

    # ----------------------------------------------------------- layers
    def _get(self, m, j, lo, hi, dev):
        """`_fetch` over this run's lane (None in one process)."""
        return _fetch(m, j, lo, hi, dev, self._lane)

    def _params(self, params, i, l, scale):
        """The params a layer reads: a region conv's "w_q" only with a
        calibrated scale (as `run_steps_plain` runs it), a dynamic scale
        `scale` where given."""
        src = l.share_index if getattr(l, "share_index", None) is not None \
            else i
        p = params[src]
        if l.kind != "convolutional" or "w_q" not in p:
            return params
        if scale is not None:
            q = dict(p, x_scale=scale)
        elif "x_scale" not in p and i in self.region_of:
            q = {k: v for k, v in p.items() if k != "w_q"}
        else:
            return params
        params = list(params)
        params[src] = q
        return params

    def _dynamic_int8(self, params, i, l) -> bool:
        if l.kind != "convolutional" or i in self.region_of:
            return False
        src = l.share_index if l.share_index is not None else i
        p = params[src]
        return "w_q" in p and "x_scale" not in p

    def _run_layer(self, i, l, x, outs, params):
        """(output, heads appended, the back-referenced view of an
        antialiased layer or None) of one layer through the forward's
        own step."""
        heads: list = []
        view: dict = {}
        outs = dict(outs)
        y = self.fwd.layer(i, l, x, outs, {}, heads, [], params)
        if i in outs and _aa_backref_needed(l, i, self.live):
            view[i] = outs[i]
        return y, heads, view.get(i)

    def _slab(self, i, l, rule, cur, maps, j, o_lo, o_hi, h_out, dev,
              params):
        """Device j's rows [o_lo, o_hi) of layer i: (output, heads); (None,
        []) for a slab of another rank (dev None), after this rank's part
        of its exchanges."""
        h_in = cur.h
        whole = o_lo == 0 and o_hi == h_out
        kind = rule[0]
        if kind == "up":
            s = rule[1]
            a, b = o_lo // s, (o_hi - 1) // s + 1
            x = self._get(cur, j, a, b, dev)
            if dev is None:
                return None, []
            y, heads, _v = self._run_layer(i, l, x, {}, params)
            return y[:, o_lo - a * s:o_hi - a * s], heads
        lo, keff, s = rule[1:]
        if kind == "window" and getattr(l, "antialiasing", 0):
            # the layer at stride 1, then its blur, each by its window
            blo, bk, bs = _blur_window(l)
            a2, b2 = _window(blo, bk, bs, o_lo, o_hi, l.out_h)
            a, b = _window(lo, keff, s, a2, b2, h_in)
            x = self._get(cur, j, a, b, dev)
            if dev is None:
                return None, []
            l1 = dataclasses.replace(l, antialiasing=0, h=b - a,
                                     out_h=b2 - a // s)
            y, _h, _v = self._run_layer(i, l1, x, {}, params)
            y = antialias_blur(y[:, a2 - a // s:], l)
            return y[:, o_lo - a2 // bs:o_hi - a2 // bs], []
        refs = {}
        for r in l.input_indices():
            m = maps[r]
            refs[r] = self._get(m, j, o_lo, o_hi, dev) if m.h == h_out \
                else self._get(m, j, 0, m.h, dev)
        if l.kind == "route" or (rule == ("window", 0, 1, 1)
                                 and h_in != h_out):
            # the output's rows are the back-referenced maps' rows; a cur
            # of another height is a broadcast gate (a [scale_channels]
            # (B, 1, 1, C)), read whole
            x = None if l.kind == "route" else self._get(cur, j, 0, h_in,
                                                         dev)
            if dev is None:
                return None, []
            y, heads, _v = self._run_layer(i, l, x, refs, params)
            return y, heads
        a, b = _window(lo, keff, s, o_lo, o_hi, h_in)
        x = self._get(cur, j, a, b, dev)
        if dev is None:
            return None, []
        j0 = o_lo - a // s
        if l.kind == "local":
            return local_block(x, params[i], dataclasses.replace(l, h=b - a),
                               rows=(j0, o_lo, o_hi - o_lo)), []
        if whole and a == 0 and b == h_in:
            y, heads, _v = self._run_layer(i, l, x, refs, params)
            return y, heads
        # the ops that size their padding and output from the layer's
        # fields get the slab's; the others size them from x
        lx = dataclasses.replace(l, h=b - a, out_h=o_hi - a // s) \
            if l.kind in ("convolutional", "maxpool") else l
        y, heads, _v = self._run_layer(i, lx, x, refs, params)
        return y[:, j0:j0 + o_hi - o_lo], [h[:, j0:j0 + o_hi - o_lo]
                                           for h in heads]

    # ---------------------------------------------------------- regions
    def _prefix(self, run, cur, params_of, devs):
        """The region's kernel prefix once a slab, each slab extended by
        the prefix plan's halo: the map of its boundary layer."""
        sub = run.prefix
        rows = slab_rows(sub.h, len(devs))
        k = 2 if sub.stem else 1
        parts = []
        for j, (dev, (o_lo, o_hi)) in enumerate(zip(devs, rows)):
            if o_lo == o_hi:
                parts.append(None)
                continue
            e_lo, e_hi = max(0, o_lo - sub.rt), min(sub.h, o_hi + sub.rb)
            x = self._get(cur, j, k * e_lo, k * e_hi, dev)
            if dev is None:
                parts.append(None)
                continue
            y = run.run_prefix(params_of(dev), x, e_hi - e_lo)
            parts.append(y[:, o_lo - e_lo:o_hi - e_lo])
        return _Map(parts, rows, sub.h)

    # ------------------------------------------------------------ run
    def heads(self, params_of, blocks, *, group=None, lane=None) -> list:
        self._lane = lane
        try:
            return self._heads(params_of, blocks, group)
        finally:
            self._lane = None
            if lane is not None:
                collective.flush()

    def _heads(self, params_of, blocks, group) -> list:
        fwd, layers, lane = self.fwd, self.layers, self._lane
        self._ref = None
        states = []
        for devs, slabs in blocks:
            devs = tuple(devs)
            h = lane.height if lane is not None else \
                sum(s.shape[1] for s in slabs)
            rows = slab_rows(h, len(devs))
            states.append({"devs": devs, "cur": _Map(list(slabs), rows,
                                                     rows[-1][1]),
                           "maps": {}, "heads": []})
        i = 0
        while i < len(layers):
            l = layers[i]
            run = fwd.runners.get(i)
            if run is not None and all(len(st["devs"]) == 1
                                       for st in states):
                # one device a block: the region as the forward runs it
                for st in states:
                    d = st["devs"][0]
                    y = run(params_of(d), st["cur"].parts[0])
                    st["cur"] = _Map([y], [(0, y.shape[1])], y.shape[1])
                i = fwd.region_plans[i].stop
            elif run is not None and run.prefix is not None:
                for st in states:
                    st["cur"] = self._prefix(run, st["cur"], params_of,
                                             st["devs"])
                i = run.prefix.out_slot
            else:
                self._layer(i, l, states, params_of, group)
            if i in self.live:
                for st in states:
                    st["maps"][i] = st.pop("view", None) or st["cur"]
            i += 1
        out = []
        for st in states:
            home = st["devs"][0]
            heads = []
            for m in st["heads"]:
                if lane is not None:
                    heads.append(self._gather_head(m, lane))
                elif m.rows is None:
                    heads.append(m.parts[0])
                else:
                    heads.append(torch.cat([p.to(home, non_blocking=True)
                                            for p in m.parts
                                            if p is not None], 1))
            out.append(heads)
        return out

    def _gather_head(self, m, lane):
        """A head's map whole on every rank of the lane, in row order."""
        part = m.parts[lane.me]
        if m.rows is None:
            return part
        return collective.all_gather_cat(part, lane.ranks, lane.me, 1)

    def _layer(self, i, l, states, params_of, group):
        if l.kind in IDENTITY:
            return
        aa = _aa_backref_needed(l, i, self.live)
        rule = _rule(l, aa)
        h_out = out_height(l)
        scale = None
        home = next(d for d in states[0]["devs"] if d is not None)
        if self._dynamic_int8(params_of(home), i, l):
            m = None
            for st in states:
                cur = st["cur"]
                parts = cur.parts
                if cur.rows is None:
                    parts = [next(p for p in parts if p is not None)]
                for p in parts:
                    if p is not None and p.shape[1]:
                        v = p.float().abs().amax().to(home)
                        m = v if m is None else torch.maximum(
                            m, v.to(m.device))
            if group is not None:
                if m is None:
                    m = torch.zeros((), device=home)
                m = group_max(m, group)
            scale = torch.clamp_min(m, 1e-8)
        scales: dict = {}
        for st in states:
            devs, cur, maps = st["devs"], st["cur"], st["maps"]
            n = len(devs)
            if rule[0] == "whole" or h_out == 1:
                rows = None
                want = [(0, h_out)] * n
            else:
                rows = want = slab_rows(h_out, n)
            parts, view_parts, head_parts = [], [], []
            for j, (dev, (o_lo, o_hi)) in enumerate(zip(devs, want)):
                params = None
                if dev is not None:
                    sc = None if scale is None else scales.get(dev)
                    if scale is not None and sc is None:
                        on = scale.to(dev)
                        sc = scales[dev] = input_scale(on, absmax=on)
                    params = self._params(params_of(dev), i, l, sc)
                if o_lo == o_hi:
                    parts.append(None)
                    head_parts.append(None)
                    continue
                if rule[0] == "whole":
                    x = self._get(cur, j, 0, cur.h, dev)
                    refs = {r: self._get(maps[r], j, 0, maps[r].h, dev)
                            for r in l.input_indices()}
                    if dev is None:
                        y = heads = view = None
                    else:
                        y, heads, view = self._run_layer(i, l, x, refs,
                                                         params)
                    view_parts.append(view)
                else:
                    y, heads = self._slab(i, l, rule, cur, maps, j, o_lo,
                                          o_hi, h_out, dev, params)
                if dev is None:
                    parts.append(None)
                    head_parts.append(None)
                    continue
                if y.shape[1] != o_hi - o_lo:
                    raise RuntimeError(
                        f"layer {i} ({l.kind}): device {j}'s slab gave "
                        f"{y.shape[1]} rows for rows [{o_lo}, {o_hi})")
                parts.append(y)
                head_parts.append(heads[0] if heads else None)
            lane = self._lane
            if lane is not None and head_parts[lane.me] is None and \
                    l.kind in ("yolo", "gaussian_yolo", "detection"):
                # an empty slab's part of a head, for the gather
                ref = self._ref
                head_parts[lane.me] = ref.new_empty(
                    (ref.shape[0], 0, l.out_w, l.out_c))
            st["cur"] = _Map(parts, rows, h_out)
            mine = next((p for p in parts if p is not None), None)
            if mine is not None:
                self._ref = mine
            if aa and i in self.live:
                # what back-references read: the stride-1 buffer's view
                st["view"] = _Map(view_parts, None, next(
                    v for v in view_parts if v is not None).shape[1])
            if l.kind in ("yolo", "gaussian_yolo", "detection"):
                st["heads"].append(_Map(head_parts, rows, h_out))


def _decode(heads, graph):
    """(boxes, obj, cls) of the [yolo] and [Gaussian_yolo] heads in the
    reference order, concatenated (`darknet_tpu/parallel/spatial.py`)."""
    net = graph.net
    outs = []
    for t, l in zip(heads, graph.heads()):
        t = t.float()
        if l.kind == "yolo":
            outs.append(yoloops.yolo_decode(t, l, net.w, net.h)[:3])
        elif l.kind == "gaussian_yolo":
            outs.append(yoloops.gaussian_yolo_decode(t, l, net.w,
                                                     net.h)[:3])
    return tuple(torch.cat([o[k] for o in outs], 1) for k in range(3))


class _Replicas:
    """A params list on each device, copied once per list (held by
    identity) and device; the regions' step weights held with them."""

    def __init__(self, fwd):
        self.fwd = fwd
        self.src = None
        self.copies: dict = {}

    def __call__(self, params, device):
        if params is not self.src:
            self.src, self.copies = params, {}
        if device not in self.copies:
            held = self.copies.get("held")
            if held is None:
                held = self.copies["held"] = self.fwd.with_step_weights(
                    params)
            self.copies[device] = to_device(held, device)
        return self.copies[device]


def make_spatial_forward(graph, mesh: Mesh, *, compute_dtype=None,
                         fused_bn: bool = True, decode: bool = True):
    """`fn(params, x) -> (boxes, obj, cls)` over a ("dp", "sp") mesh: the
    batch over dp, each map's H over sp (the module docstring), the
    outputs in the unsharded order on the mesh's first device (over a
    grid that spans the world: every rank passes the whole batch and
    gets the whole batch's outputs); with decode=False the activated
    heads instead.  x is (B, H, W, C) on any
    device, or `shard_spatial`'s lists; params are the port's torch
    params, copied to each device once per list."""
    sf = SpatialForward(graph, compute_dtype=compute_dtype,
                        fused_bn=fused_bn)
    reps = _Replicas(sf.fwd)
    n_dp = mesh.shape["dp"]
    home = mesh.devices[0]
    if mesh.spans_world:
        return _world_spatial_forward(graph, mesh, sf, reps, decode)

    def run(params, x):
        slabs = x if isinstance(x, list) else shard_spatial(mesh, x)
        blocks = [(mesh.block(b, "sp"), slabs[b]) for b in range(n_dp)]
        with torch.inference_mode():
            per = sf.heads(lambda d: reps(params, d), blocks)
            if not decode:
                return [torch.cat([h[k].to(home) for h in per])
                        for k in range(len(per[0]))]
            dec = [_decode(h, graph) for h in per]
            return tuple(torch.cat([d[k].to(home) for d in dec])
                         for k in range(3))

    return run


def world_lane(mesh, axis: str = "sp", extras=None, height=None) -> _Lane:
    """This rank's lane along `axis` of a world grid."""
    return _Lane(mesh.line(axis), mesh.coords.get(axis, 0), extras, height)


def world_slab(mesh, x, axis: str = "sp"):
    """This rank's slab of its dp block's batch `x` (B/n_dp, H, W, C): its
    rows by `slab_rows` over the `axis` line, on its device."""
    n = mesh.shape.get(axis, 1)
    lo, hi = slab_rows(x.shape[1], n)[mesh.coords.get(axis, 0)]
    return x[:, lo:hi].to(mesh.devices[0])


def _world_spatial_forward(graph, mesh, sf, reps, decode):
    """`make_spatial_forward` over a grid that spans the world: every rank
    takes the whole batch, runs its (dp block, sp slab) in lockstep with
    the block's other ranks, and returns the whole batch's outputs, the
    blocks gathered over dp (`parallel/multihost.make_global_batch`)."""
    from darknet_tpu_torch.parallel.multihost import make_global_batch

    n_dp, dev = mesh.shape["dp"], mesh.devices[0]
    group = mesh.sub("dp", "sp")

    def run(params, x):
        x = torch.as_tensor(x)
        if x.shape[0] % n_dp:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"mesh's dp size {n_dp}")
        per = x.shape[0] // n_dp
        b = mesh.coords["dp"]
        xb = x[b * per:(b + 1) * per]
        lane = world_lane(mesh, height=xb.shape[1])
        slabs = [world_slab(mesh, xb) if d is not None else None
                 for d in lane.devs(dev)]
        with torch.inference_mode():
            heads = sf.heads(lambda d: reps(params, d),
                             [(lane.devs(dev), slabs)], group=group,
                             lane=lane)[0]
            outs = _decode(heads, graph) if decode else heads
            return type(outs)(make_global_batch(mesh, o, "dp")
                              for o in outs)

    return run


# ------------------------------------------------------------------ training
class _OnDevice:
    """Layer i's whole params on one device, read through the executor's
    copies (`MeshTrain._full`): what `nn/emit`'s per-layer step indexes."""

    def __init__(self, ex, dev):
        self.ex, self.dev = ex, dev

    def __getitem__(self, i):
        return self.ex._full(i, self.dev)


class MeshTrain(SpatialForward):
    """The lockstep training executor over a (dp, sp, tp) grid of this
    process's devices: `SpatialForward`'s row rules with a backward.

    ex.micro(shards, x, generator) runs one micro-batch `x` (its global
    images, any device) forward and returns (the raw heads, each gathered
    over the blocks and slabs on the mesh's first device in batch and row
    order, and the batch statistics, one {layer: (mean, var)} a shard).
    `shards`: one params list a tp shard (`parallel/tensor.
    shard_tp_train`; without tp, [params]): each param one leaf on its
    home device, which every cell reads through a differentiable copy
    (`.to`, a no-op on its own device), so autograd sums every cell's
    gradient into the one leaf: the in-process counterpart of the JAX
    step's dp sum.

    A cell is a (dp block, sp slab); its tp group is the devices along
    tp at its coordinates, and its activations live on the group's first
    device.  Every layer runs for every cell before the next starts:

    * the batch splits over dp (contiguous blocks), every map's rows over
      sp by `slab_rows` (uneven and empty slabs included);
    * a row-local or windowed layer runs on each slab extended by the
      rows its window reads, fetched from the slabs that hold them by
      differentiable slices, `torch.cat` and `.to(dev, non_blocking=
      True)` (`_fetch`), so the halo rows' cotangents return to the
      slabs that sent them; training plans no region, so the halos are
      the layers' own windows;
    * a conv runs its first half on each cell (on each tp device of the
      group, over its filter slice, for a conv whose filters shard) and
      its batch norm + activation as ONE node over every cell's part
      (`ops/train_epilogue.bn_act_train_parts`, a shard's channels over
      every cell), so the statistics are the whole micro-batch's; the tp
      slices are then concatenated on channels on the cell's device (the
      all-gather, whose backward hands each shard its slice).  An
      antialiased conv's blur is a second windowed step over the
      normalised rows;
    * a [batchnorm] layer takes its statistics over every part
      (`ops/conv.batch_mean_var_parts`);
    * a layer that reads every row ([connected], [avgpool], [crop], the
      [detection] flatten, the legacy [reorg], reverse [reorg3d], a
      back-referenced antialiased layer) or whose output has one row runs
      once, on the whole micro-batch gathered on the mesh's first device,
      as the unsharded forward runs it (its statistics, gradients and
      draws counted once); each slab then reads its rows from a copy on
      its device;
    * dropout and dropblock draw the mask of the whole (micro-batch, H,
      W, C) tensor from the generator on the mesh's first device, and
      each cell applies its rows: with one generator the masks are the
      unsharded step's.

    Over a grid that spans the world (`parallel/mesh.world_mesh`) this
    rank is one cell at its (dp, sp) coordinates and one tp shard; every
    rank calls micro() with the whole micro-batch and the same
    generator state, `shards` is its one params list (its filter slice
    of each sharded conv, every other layer whole), and:

    * the halo rows come from the neighbouring sp ranks through the
      exchanges of `_Lane` (their cotangents go back the same way);
    * a sharded conv reads its input through `collective.copy_to_group`
      (the backward sums the tp ranks' cotangents) and its slices are
      gathered over the tp ranks (`collective.all_gather_cat`, whose
      backward takes this rank's slice); every tp rank runs the
      replicated layers on the same input, so their params stay equal
      without a sum;
    * each batch norm takes its statistics over the dp x sp ranks of its
      shard (`bn_act_train_parts(group=, count=)`, the whole
      micro-batch's rows counted);
    * a layer that reads every row, or whose output has one row, runs on
      every rank on the whole micro-batch gathered over sp, then dp
      (`_world_whole`), the gather's backward summing the ranks'
      cotangents; the masks are drawn whole on every rank;
    * the raw heads come back whole on every rank, which all take the
      same deltas, each keeping the cotangent of its own rows;
    * `extras` (read after micro()) are the extra roots that the
      backward must take, so that each exchange's and each sum's
      backward runs on every rank (`ops/collective.zero_root`);
      `mesh_train_step` sums the gradients over the dp x sp ranks of
      each shard after the backward.
    """

    def __init__(self, graph, mesh, *, dp_axis="dp", sp_axis=None,
                 tp_axis=None, elig=(), compute_dtype=None,
                 train_act_dtype=None):
        from darknet_tpu_torch.nn.emit import HEAD_KINDS

        # SpatialForward's fields for the training forward, which plans
        # no region
        self.graph, self.layers, self.region_of = graph, graph.layers, {}
        self.fwd = make_forward(graph, train=True,
                                compute_dtype=compute_dtype,
                                train_act_dtype=train_act_dtype)
        self.live = self.fwd.live
        self._lane = None
        named = {a for a in (dp_axis, sp_axis, tp_axis) if a}
        extra = [a for a in mesh.shape if a not in named]
        if extra:
            raise ValueError(f"{mesh}: this step takes the axes "
                             f"{sorted(named)}, not {extra}")
        self.compute_dtype = compute_dtype
        self.n_dp = mesh.shape.get(dp_axis, 1) if dp_axis else 1
        self.n_sp = mesh.shape.get(sp_axis, 1) if sp_axis else 1
        self.n_tp = mesh.shape.get(tp_axis, 1) if tp_axis else 1
        self.world = mesh.spans_world
        if self.world:
            self._world_init(mesh, dp_axis, sp_axis, tp_axis)
        else:
            mesh._check_grid()

            def at(b, j, t):
                return mesh._at({dp_axis: b, sp_axis: j, tp_axis: t})

            self.groups = [[tuple(at(b, j, t) for t in range(self.n_tp))
                            for j in range(self.n_sp)]
                           for b in range(self.n_dp)]
            self.first = mesh.devices[0]
            self.homes = tuple(at(0, 0, t) for t in range(self.n_tp))
            self.blocks = list(range(self.n_dp))
            self.stat_group = None
        self.elig = set(elig)
        self.heads = [l for l in graph.layers if l.kind in HEAD_KINDS]
        self.head_no = {l.index: n for n, l in enumerate(self.heads)}

    def _world_init(self, mesh, dp_axis, sp_axis, tp_axis):
        """Over a world grid: this rank is the cell at its (dp, sp)
        coordinates and the tp shard at its tp coordinate."""
        co = mesh.coords
        self.dev = self.first = mesh.devices[0]
        self.me_dp = co.get(dp_axis, 0) if dp_axis else 0
        self.me_sp = co.get(sp_axis, 0) if sp_axis else 0
        self.me_tp = co.get(tp_axis, 0) if tp_axis else 0
        rank = dist.get_rank()
        self.sp_ranks = mesh.line(sp_axis) if sp_axis else [rank]
        self.dp_ranks = mesh.line(dp_axis) if dp_axis else [rank]
        self.tp_ranks = mesh.line(tp_axis) if tp_axis else [rank]
        self.sp_group = mesh.sub(sp_axis) if sp_axis else None
        self.dp_group = mesh.sub(dp_axis) if dp_axis else None
        self.tp_group = mesh.sub(tp_axis) if tp_axis else None
        # the ranks that hold the same shard: statistics and gradients
        self.stat_group = mesh.sub(*(a for a in (dp_axis, sp_axis) if a))
        self.groups = [[(self.dev if j == self.me_sp else None,)
                        for j in range(self.n_sp)]]
        self.homes = (self.dev,)
        self.blocks = [self.me_dp]

    # ------------------------------------------------------------ params
    def _full(self, i, dev):
        """Layer i's whole params on `dev`: copies of its leaves (a
        sharded conv's slices concatenated on filters; over a world grid,
        gathered over the tp ranks, each keeping its slice's gradient)."""
        key = (i, None, dev)
        if key not in self._copies:
            sh = self._shards
            if self.world:
                p = sh[0][i]
                if i in self.elig:
                    p = {k: collective.all_gather_cat(
                        v, self.tp_ranks, self.me_tp, 0) for k, v in
                        p.items()}
            elif i in self.elig:
                p = {k: torch.cat([s[i][k].to(dev, non_blocking=True)
                                   for s in sh]) for k in sh[0][i]}
            else:
                p = {k: v.to(dev, non_blocking=True)
                     for k, v in sh[0][i].items()}
            self._copies[key] = p
        return self._copies[key]

    def _shard(self, i, t, dev):
        """Shard t of sharded conv i on `dev`."""
        if self.world:
            return self._shards[0][i]
        key = (i, t, dev)
        if key not in self._copies:
            self._copies[key] = {k: v.to(dev, non_blocking=True)
                                 for k, v in self._shards[t][i].items()}
        return self._copies[key]

    def _record(self, t, i, mean, var):
        """Batch statistics of layer i (shard t) for the rolling update,
        detached, on its "mean" leaf's device."""
        p = self._shards[t][i]
        if "mean" in p:
            dev = p["mean"].device
            self._stats[t][i] = (mean.detach().to(dev, non_blocking=True),
                                 var.detach().to(dev, non_blocking=True))

    # -------------------------------------------------------------- maps
    def _world_whole(self, m, reduce: bool):
        """Over a world grid: the whole micro-batch of this rank's block's
        map `m` on every rank, gathered over sp (rows) then dp (batch).
        reduce: each rank's downstream reads only some of it (the
        backward sums the cotangents over the ranks before it slices);
        else every rank computes the same downstream from it (the
        heads' deltas), and only the first slab of a map every slab holds
        keeps the cotangent."""
        me = self.me_sp
        if m.rows is None:
            y = m.parts[me]
            if not reduce and me:
                y = y.detach()
        else:
            y = m.parts[me]
            if y is None:
                ref = self._ref
                y = ref.new_empty((ref.shape[0], 0) + tuple(ref.shape[2:]))
            y = collective.all_gather_cat(y, self.sp_ranks, me, 1,
                                          group=self.sp_group, reduce=reduce,
                                          extras=self._extras)
        return collective.all_gather_cat(y, self.dp_ranks, self.me_dp, 0,
                                         group=self.dp_group, reduce=reduce,
                                         extras=self._extras)

    def _whole(self, m):
        """A block's map as one tensor on the mesh's first device."""
        if m.rows is None:
            return m.parts[0].to(self.first, non_blocking=True)
        parts = [p.to(self.first, non_blocking=True) for p in m.parts
                 if p is not None]
        return parts[0] if len(parts) == 1 else torch.cat(parts, 1)

    def _global(self, maps, reduce: bool = True):
        """The blocks' maps as the whole micro-batch, in batch order (over
        a world grid, `_world_whole`)."""
        if self.world:
            return self._world_whole(maps[0], reduce)
        parts = [self._whole(m) for m in maps]
        return parts[0] if len(parts) == 1 else torch.cat(parts, 0)

    def _replicas(self, y, b, h):
        """Block b's rows of the whole micro-batch's `y`, a copy on each
        slab's device: a map every slab holds whole."""
        per = y.shape[0] // self.n_dp
        yb = y[b * per:(b + 1) * per]
        if self.world:
            return _Map([yb if g[0] is not None else None
                         for g in self.groups[0]], None, h)
        return _Map([yb.to(g[0], non_blocking=True) for g in self.groups[b]],
                    None, h)

    def _run_layer(self, i, l, x, outs, params):
        y = self.fwd.layer(i, l, x, dict(outs), {}, [], [], params, None)
        return y, [], None

    # ------------------------------------------------------------ layers
    def _gate(self, l, st) -> None:
        if l.stopbackward or l.onlyforward:
            cur = st["cur"]
            cur.parts = [None if p is None else p.detach() for p in cur.parts]

    def _layer_train(self, i, l, states):
        k = l.kind
        if k in ("yolo", "gaussian_yolo", "cost"):
            self._raws[self.head_no[i]] = self._global(
                [st["cur"] for st in states], reduce=False)
            if k == "cost":
                return
        if k in ("empty", "blank", "dropout"):
            if k == "dropout" and self._gen is not None:
                self._dropout(l, states)
            for st in states:
                self._gate(l, st)
            return
        aa = _aa_backref_needed(l, i, self.live)
        rule = _rule(l, aa)
        h_out = out_height(l)
        if rule[0] == "whole" or h_out == 1:
            self._layer_global(i, l, states, aa, h_out)
        elif k == "convolutional":
            self._conv(i, l, states, h_out)
        elif k == "batchnorm":
            self._batchnorm(i, l, states)
        else:
            for b, st in enumerate(states):
                parts = []
                rows = slab_rows(h_out, self.n_sp)
                for j, (o_lo, o_hi) in enumerate(rows):
                    dev = self.groups[b][j][0]
                    if o_lo == o_hi:
                        parts.append(None)
                        continue
                    y, _h = self._slab(i, l, rule, st["cur"], st["maps"], j,
                                       o_lo, o_hi, h_out, dev,
                                       _OnDevice(self, dev))
                    parts.append(y)
                st["cur"] = _Map(parts, rows, h_out)
        self._note(states)

    def _note(self, states):
        """Keep a part of this rank's as the template of an empty one."""
        for st in states:
            p = next((q for q in st["cur"].parts if q is not None), None)
            if p is not None:
                self._ref = p

    def _layer_global(self, i, l, states, aa, h_out):
        """Layer i once on the whole micro-batch on the first device."""
        x = None if l.kind == "route" else self._global(
            [st["cur"] for st in states])
        outs = {r: self._global([st["maps"][r] for st in states])
                for r in l.input_indices()}
        stats: dict = {}
        raws: list = []
        y = self.fwd.layer(i, l, x, outs, stats, [], raws,
                           _OnDevice(self, self.first), self._gen)
        if raws:
            # over a world grid every rank computes the whole head: the
            # first cell alone takes its delta's cotangent
            keep = not self.world or (self.me_dp, self.me_sp) == (0, 0)
            self._raws[self.head_no[i]] = raws[0] if keep else \
                raws[0].detach()
        for j, (mean, var) in stats.items():
            self._stats_of(j, mean, var)
        for b, st in zip(self.blocks, states):
            st["cur"] = self._replicas(y, b, h_out)
            if aa and i in self.live:
                st["view"] = self._replicas(outs[i], b, outs[i].shape[1])

    def _stats_of(self, i, mean, var):
        """Whole-layer statistics of layer i, split over its shards."""
        if i not in self.elig:
            self._record(0, i, mean, var)
            return
        per = mean.shape[0] // self.n_tp
        if self.world:
            t = self.me_tp
            self._record(0, i, mean[t * per:(t + 1) * per],
                         var[t * per:(t + 1) * per])
            return
        for t in range(self.n_tp):
            self._record(t, i, mean[t * per:(t + 1) * per],
                         var[t * per:(t + 1) * per])

    def _tp_input(self, x):
        """A sharded conv's input: over a world grid through
        `collective.copy_to_group` (the tp ranks' cotangents sum), in one
        process itself (every shard's copy `.to` its device sums there)."""
        if not self.world:
            return x
        return collective.copy_to_group(x, self.tp_group, self._extras)

    def _tp_cat(self, parts, home):
        """A sharded conv's output slices, concatenated on channels on
        `home` (over a world grid, this rank's slice gathered over the tp
        ranks: the backward hands each its slice)."""
        if self.world:
            return collective.all_gather_cat(parts[0], self.tp_ranks,
                                             self.me_tp, -1)
        return parts[0] if len(parts) == 1 else torch.cat(
            [o.to(home, non_blocking=True) for o in parts], -1)

    def _conv(self, i, l, states, h_out):
        """A conv over every cell: each cell's window rows first (over a
        world grid, this rank's cell, in lockstep with its sp lane's halo
        exchanges), then its first half on each cell and each shard this
        process holds, then the batch norm + activation as one node over
        the parts."""
        from darknet_tpu_torch.ops.conv import train_keeps_lp
        from darknet_tpu_torch.ops.train_epilogue import bn_act_train_parts

        fwd = self.fwd
        src = l.share_index if l.share_index is not None else i
        sharded = i in self.elig
        # the shards this process computes (over a world grid, its own)
        n_t = self.n_tp if sharded and not self.world else 1
        aa = bool(getattr(l, "antialiasing", 0))
        l1 = dataclasses.replace(l, antialiasing=0) if aa else l
        h1 = l.out_h
        lo, keff, s = l.pad * l.dilation, l.dilation * (l.size - 1) + 1, \
            l.stride_y
        rows = slab_rows(h1, self.n_sp)
        cells = []
        for b, st in enumerate(states):
            cur = st["cur"]
            for j, (o_lo, o_hi) in enumerate(rows):
                if o_lo == o_hi:
                    continue
                a, e = _window(lo, keff, s, o_lo, o_hi, cur.h)
                x = self._get(cur, j, a, e, self.groups[b][j][0])
                if x is None:
                    continue
                lx = l1 if (a, e, o_lo, o_hi) == (0, cur.h, 0, h1) else \
                    dataclasses.replace(l1, h=e - a, out_h=o_hi - a // s)
                cells.append((b, j, x, lx, o_lo - a // s, o_hi - o_lo))
        pre = [[] for _ in range(n_t)]
        for b, j, x, lx, j0, n_rows in cells:
            group = self.groups[b][j]
            if sharded:
                x = self._tp_input(x)
            for t in range(n_t):
                dev = group[t] if sharded else group[0]
                p = self._shard(i, t, dev) if sharded else \
                    self._full(src, dev)
                y = fwd.conv_pre(i, lx, x.to(dev, non_blocking=True), p)
                pre[t].append(y[:, j0:j0 + n_rows])
        if sharded:
            p_home = [self._shards[t][i] for t in range(n_t)]
        elif src in self.elig:      # a share_index borrower of a shard
            p_home = [self._full(src, self.first)]
        else:
            p_home = [self._shards[0][src]]
        res_dt = fwd.train_act_dtype if i not in fwd.head_feed else None
        bn = bool(l.batch_normalize) and "scales" in p_home[0]
        keep_lp = train_keeps_lp(p_home[0], l, self.compute_dtype, res_dt)
        if bn and not cells:
            # a world rank's empty slab still joins the statistics' sums
            ref = self._ref
            pre[0].append(torch.empty(
                (ref.shape[0], 0, l.out_w, p_home[0]["b"].shape[0]),
                dtype=res_dt if keep_lp else torch.float32,
                device=self.first))
        outs = []
        for t in range(n_t):
            if bn:
                o, (mean, var) = bn_act_train_parts(
                    pre[t], p_home[t]["scales"], p_home[t]["b"],
                    l.activation, res_dt if keep_lp else None, res_dt,
                    group=self.stat_group,
                    count=self._per * self.n_dp * h1 * l.out_w
                    if self.world else None)
                if sharded:
                    self._record(t, i, mean, var)
                else:
                    self._stats_of(i, mean, var)
                if not cells:
                    collective.zero_root(o[0], self._extras)
            else:
                o = [apply_activation(
                    y + (self._shard(i, t, y.device) if sharded
                         else self._full(src, y.device))["b"], l.activation)
                    for y in pre[t]]
            outs.append(o)
        got = {}
        for c, (b, j, *_r) in enumerate(cells):
            got[(b, j)] = self._tp_cat([o[c] for o in outs],
                                       self.groups[b][j][0]) \
                if sharded else outs[0][c]
        maps = [_Map([got.get((b, j)) for j in range(self.n_sp)], rows, h1)
                for b in range(len(states))]
        if aa:
            maps = [self._blur(l, m, b, h_out) for b, m in enumerate(maps)]
        for st, m in zip(states, maps):
            m.parts = [None if p is None else fwd.conv_out(i, p)
                       for p in m.parts]
            st["cur"] = m
            self._gate(l, st)

    def _blur(self, l, m, b, h_out):
        """An antialiased layer's blur over its normalised rows `m`,
        each slab extended by the blur's window."""
        blo, bk, bs = _blur_window(l)
        rows = slab_rows(h_out, self.n_sp)
        parts = []
        for j, (o_lo, o_hi) in enumerate(rows):
            if o_lo == o_hi:
                parts.append(None)
                continue
            a, e = _window(blo, bk, bs, o_lo, o_hi, m.h)
            x = self._get(m, j, a, e, self.groups[b][j][0])
            if x is None:
                parts.append(None)
                continue
            parts.append(antialias_blur(x, l)[:, o_lo - a // bs:
                                              o_hi - a // bs])
        return _Map(parts, rows, h_out)

    def _batchnorm(self, i, l, states):
        from darknet_tpu_torch.ops.conv import BN_EPS, batch_mean_var_parts

        xs, where = [], []
        for b, st in enumerate(states):
            cur = st["cur"]
            for j, (o_lo, o_hi) in enumerate(slab_rows(cur.h, self.n_sp)):
                if o_lo < o_hi:
                    x = self._get(cur, j, o_lo, o_hi, self.groups[b][j][0])
                    if x is not None:
                        xs.append(x)
                        where.append((b, j))
        if not xs:
            ref = self._ref
            xs = [ref.new_empty((ref.shape[0], 0, l.out_w, l.out_c))]
        h = states[0]["cur"].h
        mean, var = batch_mean_var_parts(
            xs, self.first, self.stat_group,
            self._per * self.n_dp * h * l.out_w if self.world else None)
        if self.world:
            collective.zero_root(mean, self._extras)
            collective.zero_root(var, self._extras)
        self._record(0, i, mean, var)
        got = {}
        for x, (b, j) in zip(xs, where):
            dev = x.device
            p = self._full(i, dev)
            got[(b, j)] = ((x - mean.to(dev, non_blocking=True))
                           * torch.rsqrt(var.to(dev, non_blocking=True)
                                         + BN_EPS) * p["scales"] + p["b"])
        for b, st in enumerate(states):
            h = st["cur"].h
            st["cur"] = _Map([got.get((b, j)) for j in range(self.n_sp)],
                             slab_rows(h, self.n_sp), h)
            self._gate(l, st)

    def _dropout(self, l, states):
        """The whole micro-batch's mask, drawn on the first device, each
        cell's rows applied."""
        from darknet_tpu_torch.ops import shapes as shapeops

        cur0 = states[0]["cur"]
        ref = next((p for p in cur0.parts if p is not None), self._ref)
        shape = (ref.shape[0] * self.n_dp, cur0.h, l.out_w, l.out_c)
        like = torch.empty((), dtype=ref.dtype,
                           device=self.first).expand(shape)
        if l.dropblock:
            block = shapeops.dropblock_size(shape[1], shape[2],
                                            l.dropblock_size_abs,
                                            l.dropblock_size_rel)
            keep, denom = shapeops.dropblock_keep(shapeops.dropblock_seeds(
                like, l.probability, block, self._gen), block)

            def apply(x, bsl, rsl):
                dev = x.device
                return x * keep[bsl, rsl].to(dev, non_blocking=True) / \
                    denom[bsl].to(dev, non_blocking=True)
        else:
            keep = shapeops.dropout_keep(like, l.probability, self._gen)

            def apply(x, bsl, rsl):
                return shapeops.dropout_apply(
                    x, keep[bsl, rsl].to(x.device, non_blocking=True),
                    l.probability)
        per = ref.shape[0]
        for b, st in zip(self.blocks, states):
            cur = st["cur"]
            bsl = slice(b * per, (b + 1) * per)
            rows = cur.rows or [(0, cur.h)] * len(cur.parts)
            cur.parts = [None if p is None else apply(p, bsl, slice(lo, hi))
                         for p, (lo, hi) in zip(cur.parts, rows)]

    # --------------------------------------------------------------- run
    def micro(self, shards, x, generator=None):
        """One micro-batch forward (the class docstring)."""
        n = x.shape[0]
        if n % self.n_dp:
            raise ValueError(f"micro-batch {n} not divisible by the mesh's "
                             f"dp size {self.n_dp}")
        per = self._per = n // self.n_dp
        h = x.shape[1]
        self._shards, self._gen, self._copies = shards, generator, {}
        self._stats = [{} for _ in shards]
        self._raws = [None] * len(self.heads)
        self._extras = [] if self.world else None
        self._lane = _Lane(self.sp_ranks, self.me_sp, self._extras) \
            if self.world else None
        self._ref = x[:per].to(self.first, non_blocking=True)
        rows = slab_rows(h, self.n_sp)
        states = [{"cur": _Map([x[b * per:(b + 1) * per, lo:hi].to(
            g[0], non_blocking=True) if hi > lo and g[0] is not None
            else None for g, (lo, hi) in zip(self.groups[k], rows)],
            rows, h), "maps": {}} for k, b in enumerate(self.blocks)]
        try:
            for i, l in enumerate(self.layers):
                with scope(f"L{i:03d}_{l.kind}"):
                    self._layer_train(i, l, states)
                if i in self.live:
                    for st in states:
                        st["maps"][i] = st.pop("view", None) or st["cur"]
        finally:
            if self.world:
                collective.flush()
        raws, stats = self._raws, self._stats
        self.extras = self._extras or []
        self._shards = self._gen = self._copies = self._stats = None
        self._raws = self._lane = self._extras = self._ref = None
        return raws, stats


def mesh_train_step(graph, ex, *, accum: int = 1):
    """`step(shards, opts, x, truths, lr, generator=None) -> (cost,
    metrics)` over executor `ex` (`MeshTrain`): `train/step.
    make_train_step`'s step on the global batch, its parts reused: the
    interleaved micro-batches, each head's delta on the whole micro-batch
    on the mesh's first device (so the cost and metrics are the
    unsharded step's by construction), the backward through the gathers,
    then per shard the optimizer on its leaves (one update per param, on
    its home device, with its slots there) and the rolling statistics."""
    from darknet_tpu_torch.train import step as stepmod

    net = graph.net
    if not ex.heads:
        raise ValueError("a training step needs a head")

    def step(shards, opts, x, truths, lr, generator=None):
        x, truths = torch.as_tensor(x), torch.as_tensor(truths)
        for sh in shards:
            stepmod.zero_grads(sh)
        costs, mets, stats = [], [], []
        for xj, tj in stepmod.micro_batches(x, truths, accum):
            raws, st = ex.micro(shards, xj, generator)
            c, m, roots, cts = stepmod.head_deltas(
                raws, ex.heads, tj.to(ex.first, non_blocking=True), net)
            cost = torch.stack(c).sum()
            roots += [t for t, _c in ex.extras]
            cts += [c for _t, c in ex.extras]
            try:
                stepmod.backward(roots, cts, ex.compute_dtype, cost)
            finally:
                if ex.world:
                    collective.flush()
            costs.append(cost)
            mets.append(m)
            stats.append(st)
        cost, metrics = stepmod.summarize(costs, mets, len(ex.heads))
        if ex.stat_group is not None:
            for sh in shards:
                stepmod.all_reduce_grads(sh, ex.stat_group, every=True)
        for t, sh in enumerate(shards):
            stepmod.finish_step(graph, sh, opts[t], lr, cost)
            stepmod.roll_bn_stats(sh, [s[t] for s in stats])
        return cost, metrics

    return step


def make_spatial_train_step(graph, mesh: Mesh, *, accum: int = 1,
                            compute_dtype=None, train_act_dtype=None):
    """`step(params, opt_state, x, truths, lr, generator=None) -> (params,
    opt_state, cost, metrics)` over a ("dp", "sp") mesh of this process,
    or over a ("dp", "sp") grid that spans the world (every rank passes
    the whole batch and the same params, and holds the same params after
    the step):
    the port's form of the JAX package's `make_train_step` jitted with
    `P("dp", "sp", None, None)` inputs (`__graft_entry__.py:170-178`).
    The batch splits over dp and every map's rows over sp (`MeshTrain`);
    the step is `train/step.make_train_step(accum=...)`'s on the whole
    batch, its params and slots updated in place where they live (every
    cell reads them through copies).  x and truths: the global batch, on
    any device.  `generator` (on the mesh's first device) feeds the
    random layers, which draw the whole tensor's masks."""
    ex = MeshTrain(graph, mesh, dp_axis="dp", sp_axis="sp",
                   compute_dtype=compute_dtype,
                   train_act_dtype=train_act_dtype)
    inner = mesh_train_step(graph, ex, accum=accum)

    def step(params, opt_state, x, truths, lr, generator=None):
        cost, metrics = inner([params], [opt_state], x, truths, lr,
                              generator)
        return params, opt_state, cost, metrics

    return step
