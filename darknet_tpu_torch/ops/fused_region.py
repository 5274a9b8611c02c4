"""Fused conv regions: the planner of `darknet_tpu/ops/pallas/fused_region.py`
(pure Python) and the region's plain torch version.

A region is a run of layers (1x1/3x3 convs with elementwise activations,
shortcuts, route concats, optionally the space-to-depth stem) that one
kernel can execute with every intermediate kept on chip.  The planner
yields the same `RegionPlan`s as the JAX package, step for step; its
`pick_tile`/`_vmem_estimate` budget is kept only as the acceptance rule
that makes the two packages plan the same regions.  The CUDA kernel
(`ops/cuda/fused_region.py`) picks its own tiling.

`run_steps_plain` executes steps with plain torch ops on unpacked NHWC
tensors, in the inference order of the reference's `_run_steps_xla`:
conv with f32 accumulation, + bias, cast to the compute dtype, then the
activation; a shortcut is an add followed by its activation; a route
concat feeds a conv through its several `srcs`.  It is the CPU path and
the oracle of the kernel, and it runs the strided remainder of a region
on every device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable

import torch

from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops.conv import (conv2d_int8, conv2d_raw, conv_act,
                                        conv_int8_act)
from darknet_tpu_torch.ops.stem import pack_w0, pack_w1

ELEMENTWISE_ACTS = frozenset({
    "linear", "leaky", "relu", "relu6", "relie", "ramp", "mish", "swish",
    "logistic", "loggy", "tanh", "hardtan", "gelu",
})

IN_SLOT = -1          # region input tensor


class _Unplannable(Exception):
    """A layer inside the candidate region references an unresolvable
    slot (e.g. a stem region whose body routes to raw layer 0)."""


@dataclasses.dataclass(frozen=True)
class StepParam:
    """A conv step's weight (HWIO) or f32 bias, read from the params list:
    layer `li`'s own ("hwio", "bias"), or the stem's packed forms
    ("pack_w0", "pack_w1", "bias_x4").  A value, so that a plan compares
    and serialises (`RegionPlan.to_json`) with its accessors."""

    li: int
    form: str

    def __call__(self, params):
        q = params[self.li]
        if self.form == "bias":
            return q["b"]
        if self.form == "bias_x4":
            return q["b"].repeat(4)
        w = q["w"].permute(2, 3, 1, 0)
        if self.form == "pack_w0":
            return pack_w0(w)
        if self.form == "pack_w1":
            return pack_w1(w)
        return w


@dataclasses.dataclass(frozen=True)
class ConvStep:
    """One conv, possibly over a folded route concat of `srcs`."""

    srcs: tuple                  # slot ids, concat order (route order)
    srcs_c: tuple                # channels per src
    kh: int
    kw: int
    pt: int                      # top pad: taps dy = oy - pt
    pl_: int                     # left pad: taps dx = ox - pl_
    n: int                       # output channels
    act: str
    out_slot: int
    w_fn: Callable               # params -> HWIO (kh, kw, sum(srcs_c), n)
    b_fn: Callable               # params -> (n,) f32
    sy: int = 1
    sx: int = 1
    li: int = -1                 # graph layer index of this conv

    @property
    def taps(self) -> tuple:
        """The TPU kernel's packed taps (dy, dJ) over pixel pairs; the
        planner's halo and VMEM rules are written in them."""
        return tuple(sorted({
            (oy - self.pt, (self.sx * q + ox - self.pl_) // 2)
            for oy in range(self.kh) for ox in range(self.kw)
            for q in (0, 1)}))

    @property
    def c_tot(self) -> int:
        return sum(self.srcs_c)


@dataclasses.dataclass(frozen=True)
class AddStep:
    """Shortcut: out = act(a + b)."""

    a: int
    b: int
    act: str
    out_slot: int


@dataclasses.dataclass
class RegionPlan:
    steps: tuple                 # ConvStep | AddStep
    rt: int                      # input halo rows above
    rb: int                      # below
    h: int                       # region input height
    w2: int                      # region input width // 2
    in_c: int                    # input channels
    out_slot: int
    out_c: int
    start: int                   # first graph layer covered
    stop: int                    # last graph layer covered (inclusive)
    stem: bool = False           # input is the raw net input (s2d inside)
    tile: int = 0                # the TPU kernel's rows per grid step
    out_h: int = 0
    out_w: int = 0
    xla_only: bool = False       # has strided convs: no single kernel

    @property
    def conv_steps(self):
        return [s for s in self.steps if isinstance(s, ConvStep)]

    def to_json(self) -> str:
        """The plan as a canonical JSON string (the region op's `plan`
        argument, which an exported program carries as a constant)."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "RegionPlan":
        """The inverse of `to_json`: an equal plan."""
        d = json.loads(text)
        d["steps"] = tuple(
            ConvStep(**dict(f, srcs=tuple(f["srcs"]),
                            srcs_c=tuple(f["srcs_c"]),
                            w_fn=StepParam(**f["w_fn"]),
                            b_fn=StepParam(**f["b_fn"])))
            if "srcs" in f else AddStep(**f) for f in d["steps"])
        return cls(**d)


# --------------------------------------------------------------------------
# Planner: graph -> RegionPlan(s)
# --------------------------------------------------------------------------


def _conv_ok(l) -> bool:
    return (l.kind == "convolutional" and l.groups == 1 and l.dilation == 1
            and l.share_index is None and not l.antialiasing
            and l.stride_x == l.stride_y and l.stride_x in (1, 2)
            and l.size in (1, 3) and l.pad == l.size // 2
            and l.activation in ELEMENTWISE_ACTS
            and not l.binary and not l.xnor)


def _layer_inputs(layers, j):
    l = layers[j]
    if l.kind == "route":
        return list(l.layers)
    return [j - 1] + list(l.input_indices())


def _plan_region(graph, a: int, *, stem_steps=None, in_c=None):
    """The maximal region starting at layer `a` whose input is layer a-1's
    output (or the net input via `stem_steps`), or None."""
    layers = graph.layers
    res = (layers[a].h, layers[a].w)
    if res[1] % 2:
        return None

    # scan forward at the current resolution; stride-2 convs are allowed
    j = a
    cur = res
    wide_run = 0     # consecutive convs with min(c, n) >= 128: stop at 2
    while j < len(layers):
        l = layers[j]
        if l.kind == "convolutional":
            if (l.h, l.w) != cur or not _conv_ok(l):
                break
            if min(l.c, l.n) >= 128:
                wide_run += 1
                if wide_run >= 2:
                    break
            else:
                wide_run = 0
            if l.stride_x == 2 and (cur[0] % 2 or cur[1] % 2
                                    or l.out_w % 2):
                break
            cur = (l.out_h, l.out_w)
        elif (l.out_h, l.out_w) != cur:
            break
        elif l.kind == "route":
            if l.groups != 1 or any(s < a - 1 for s in l.layers):
                break
        elif l.kind == "shortcut":
            if (l.from_layer < a - 1
                    or l.activation not in ELEMENTWISE_ACTS):
                break
        else:
            break
        j += 1
    end = j - 1
    if end < a:
        return None

    # shrink until no inner layer is consumed outside [a, end]; a stem
    # region also swallows layers 0..a-1
    lo = 0 if stem_steps else a

    def consumed_outside(e):
        for k in range(e + 1, len(layers)):
            for s in _layer_inputs(layers, k):
                if lo <= s < e:
                    return True
        return False

    changed = True
    while changed and end >= a:
        changed = False
        while end > a and consumed_outside(end):
            end -= 1
            changed = True
        # the region output must be one tensor, never a multi-concat
        while end >= a and layers[end].kind == "route" and \
                len(layers[end].layers) > 1:
            end -= 1
            changed = True
    n_convs = sum(1 for k in range(a, end + 1)
                  if layers[k].kind == "convolutional")
    if end < a or n_convs < 3:
        return None
    # only lane-starved stages (some conv with < 128 channels) or the stem
    lane_starved = any(
        l.kind == "convolutional" and min(l.c, l.n) < 128
        for l in layers[a:end + 1]) or stem_steps is not None
    if not lane_starved:
        return None

    steps = list(stem_steps or [])
    slot_of = {a - 1: (steps[-1].out_slot if steps else IN_SLOT)}
    chan_of = {IN_SLOT: in_c if in_c is not None else layers[a].c}
    for s in steps:
        chan_of[s.out_slot] = s.n

    def resolve(idx):
        """Layer index -> ((slot, channels), ...)."""
        if idx not in slot_of:
            raise _Unplannable
        s = slot_of[idx]
        if isinstance(s, tuple):
            return s
        return ((s, chan_of[s]),)

    try:
        _build_steps(layers, a, end, steps, slot_of, chan_of, resolve)
    except _Unplannable:
        return None
    out = slot_of[end]
    if isinstance(out, tuple):
        return None

    halo = _steps_halo(steps)
    strided = any(isinstance(s, ConvStep) and (s.sy > 1 or s.sx > 1)
                  for s in steps)
    plan = RegionPlan(
        steps=tuple(steps), rt=halo[out][0], rb=halo[out][1],
        h=res[0], w2=res[1] // 2,
        in_c=chan_of[IN_SLOT], out_slot=out, out_c=chan_of[out],
        out_h=layers[end].out_h, out_w=layers[end].out_w,
        start=a, stop=end, stem=stem_steps is not None,
        xla_only=strided)
    if not strided:
        plan.tile = pick_tile(plan)
        if plan.tile is None:
            return None
    return plan


def _build_steps(layers, a, end, steps, slot_of, chan_of, resolve):
    for k in range(a, end + 1):
        l = layers[k]
        if l.kind == "convolutional":
            pairs = resolve(k - 1)
            steps.append(ConvStep(
                srcs=tuple(p[0] for p in pairs),
                srcs_c=tuple(p[1] for p in pairs),
                kh=l.size, kw=l.size, pt=l.pad, pl_=l.pad, n=l.n,
                act=l.activation, out_slot=k,
                w_fn=StepParam(k, "hwio"), b_fn=StepParam(k, "bias"),
                sy=l.stride_y, sx=l.stride_x, li=k))
            slot_of[k] = k
            chan_of[k] = l.n
        elif l.kind == "route":
            pairs = []
            for s in l.layers:
                pairs.extend(resolve(s))
            slot_of[k] = tuple(pairs)
        elif l.kind == "shortcut":
            (sa, ca), = resolve(k - 1)
            (sb, cb), = resolve(l.from_layer)
            if ca != cb:
                raise _Unplannable
            steps.append(AddStep(a=sa, b=sb, act=l.activation, out_slot=k))
            slot_of[k] = k
            chan_of[k] = ca


def _steps_halo(steps) -> dict:
    """Halo rows (top, bottom) required at each slot, keyed by slot id."""
    halo = {IN_SLOT: (0, 0)}
    for s in steps:
        if isinstance(s, ConvStep):
            up = max(0, -min(dy for dy, _ in s.taps))
            dn = max(0, max(dy for dy, _ in s.taps))
            ht = max(halo[x][0] for x in s.srcs) + up
            hb = max(halo[x][1] for x in s.srcs) + dn
        else:
            ht = max(halo[s.a][0], halo[s.b][0])
            hb = max(halo[s.a][1], halo[s.b][1])
        halo[s.out_slot] = (ht, hb)
    return halo


def hybrid_prefix(plan: RegionPlan):
    """Largest stride-1 step prefix of a region that one kernel can run,
    leaving the strided remainder to the plain steps.  A cut k is valid
    when steps[k:] read no prefix-produced slot but the boundary
    (steps[k-1].out_slot), so the kernel writes exactly one tensor.
    Returns (sub_plan, k) or None."""
    steps = plan.steps
    first_strided = len(steps)
    for i, s in enumerate(steps):
        if isinstance(s, ConvStep) and (s.sy > 1 or s.sx > 1):
            first_strided = i
            break

    chan = {IN_SLOT: plan.in_c}
    for s in steps:
        chan[s.out_slot] = s.n if isinstance(s, ConvStep) else chan[s.a]

    for k in range(first_strided, 1, -1):
        prefix = steps[:k]
        if sum(1 for s in prefix if isinstance(s, ConvStep)) < 2:
            return None
        boundary = prefix[-1].out_slot
        produced = {IN_SLOT} | {s.out_slot for s in prefix}
        if any(x in produced and x != boundary
               for s in steps[k:]
               for x in (s.srcs if isinstance(s, ConvStep) else (s.a, s.b))):
            continue
        rt, rb = _steps_halo(prefix)[boundary]
        sub = RegionPlan(
            steps=tuple(prefix), rt=rt, rb=rb, h=plan.h, w2=plan.w2,
            in_c=plan.in_c, out_slot=boundary, out_c=chan[boundary],
            out_h=plan.h, out_w=2 * plan.w2,
            start=plan.start, stop=plan.start, stem=plan.stem)
        sub.tile = pick_tile(sub)
        if sub.tile is None:
            continue
        return sub, k
    return None


def pick_tile(plan, budget_bytes=12 * 1024 * 1024, t_max=64):
    """The TPU kernel's row tile: the largest divisor of H whose VMEM peak
    fits its budget.  Kept as the acceptance rule of the planner."""
    for t in range(min(t_max, plan.h), max(plan.rt, plan.rb, 4) - 1, -1):
        if plan.h % t:
            continue
        if _vmem_estimate(plan, t) <= budget_bytes:
            return t
    return None


def _vmem_estimate(plan, t):
    """The TPU kernel's peak VMEM with step-level liveness."""
    s = plan.rt + t + plan.rb
    px = s * plan.w2
    io = 3 * 2 * (t * plan.w2) * 2 * plan.in_c * 2 \
        + 2 * (t * plan.w2) * 2 * plan.out_c * 2

    chan = {IN_SLOT: plan.in_c}
    last_use = {IN_SLOT: 0}
    for i, st in enumerate(plan.steps):
        srcs = st.srcs if isinstance(st, ConvStep) else (st.a, st.b)
        for x in srcs:
            last_use[x] = i
        chan[st.out_slot] = st.n if isinstance(st, ConvStep) else \
            chan[srcs[0]]
        last_use[st.out_slot] = i
    last_use[plan.out_slot] = len(plan.steps)

    live = {IN_SLOT}
    peak = 0
    for i, st in enumerate(plan.steps):
        live.add(st.out_slot)
        cur = sum(px * 2 * chan[x] * 2 for x in live)
        if isinstance(st, ConvStep):
            k_chunk = _chunk_len(st) * 2 * st.c_tot
            cur += px * k_chunk * 2 + px * 2 * st.n * 4
        peak = max(peak, cur)
        live = {x for x in live if last_use.get(x, -1) > i}
    return io + peak


def _chunk_len(step) -> int:
    k1 = 2 * step.c_tot
    n_dj = len({dj for _, dj in step.taps})
    return max(1, min(n_dj, max(1, 512 // k1)))


def make_stem_steps(graph):
    """Fold the s2d stem into region steps: conv0 becomes a 3x3 conv over
    s2d coordinates (pack_w0), conv1 a 2x2 conv with taps {-1, 0}
    (pack_w1, pad (1, 0))."""
    l0, l1 = graph.layers[0], graph.layers[1]
    c_in = 4 * l0.c
    s0 = ConvStep(
        srcs=(IN_SLOT,), srcs_c=(c_in,), kh=3, kw=3, pt=1, pl_=1,
        n=4 * l0.n, act=l0.activation, out_slot=-100,
        w_fn=StepParam(0, "pack_w0"), b_fn=StepParam(0, "bias_x4"),
        li=0)
    s1 = ConvStep(
        srcs=(-100,), srcs_c=(4 * l0.n,), kh=2, kw=2, pt=1, pl_=1,
        n=l1.n, act=l1.activation, out_slot=1,
        w_fn=StepParam(1, "pack_w1"), b_fn=StepParam(1, "bias"),
        li=1)
    return [s0, s1], c_in


def plan_graph_regions(graph, *, stem: bool = False):
    """Scan the graph for inference regions: {start_layer: plan}; a stem
    plan starts at 0 and consumes the net input."""
    from darknet_tpu_torch.ops.stem import stem_pattern

    layers = graph.layers
    plans = {}
    i = 0
    if stem and stem_pattern(graph) and len(layers) > 2:
        stem_steps, in_c = make_stem_steps(graph)
        p = _plan_region(graph, 2, stem_steps=stem_steps, in_c=in_c)
        if p is not None:
            p.start = 0
            plans[0] = p
            i = p.stop + 1
    while i < len(layers):
        if layers[i].kind == "convolutional" and _conv_ok(layers[i]) \
                and i > 0:
            p = _plan_region(graph, i)
            if p is not None:
                plans[i] = p
                i = p.stop + 1
                continue
        i += 1
    return plans


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------


def step_weights(steps, params, dtype):
    """Per conv step: HWIO weights in `dtype` and f32 biases."""
    convs = [s for s in steps if isinstance(s, ConvStep)]
    return ([s.w_fn(params).to(dtype) for s in convs],
            [s.b_fn(params).float() for s in convs])


def run_steps_plain(steps, slots: dict, weights, biases, compute_dtype,
                    params=None, *, one_pass: bool = False):
    """Execute `steps` on unpacked NHWC tensors, updating `slots` in place.
    weights/biases: one per ConvStep, in step order (`step_weights`;
    in bf16 the weights may be their f32 copies, see `ops/conv.conv2d_raw`).

    With `params` (the layer list), a conv step whose layer carries a
    calibrated "x_scale" and its "w_q" runs the int8 conv
    (`ops/conv.conv2d_int8`: the int8 GEMM kernel for a CUDA tensor), the
    same integers as the unpacked int8 chain (`conv_block_int8`); a step
    without "x_scale" stays in floating point.  Under region_int8 every
    conv step of a region carries both (`Network.calibrate_int8`).

    one_pass (the served remainder of a hybrid region, `nn/emit.
    region_runner`): each conv step runs as `ops/conv.conv_block` and
    `conv_block_int8` run a layer (`conv_act`, `conv_int8_act`: the
    one-pass kernel for a bf16 step on the card whose activation has a
    code, leaky in the int8 GEMM's epilogue), counted as they count:
    the mesh paths run these layers through those blocks, and serve the
    same numbers."""
    cd = compute_dtype
    wi = 0
    for step in steps:
        if isinstance(step, AddStep):
            slots[step.out_slot] = apply_activation(
                slots[step.a] + slots[step.b], step.act)
            continue
        src = torch.cat([slots[s] for s in step.srcs], dim=-1) \
            if len(step.srcs) > 1 else slots[step.srcs[0]]
        pad = ((step.pt, step.kh - 1 - step.pt),
               (step.pl_, step.kw - 1 - step.pl_))
        p_l = params[step.li] if params is not None and step.li >= 0 else {}
        if "x_scale" in p_l:
            if ("w_q" not in p_l or p_l["w_q"].shape[1]
                    != step.kh * step.kw * step.c_tot):
                # no w_q, or a stem step, whose packed geometry is not the
                # layer's (region_int8 plans no stem)
                raise ValueError(
                    f"layer {step.li}: an int8 region step needs the "
                    f"layer's own w_q over the step's window")
            out_hw = ((src.shape[1] - 1) // step.sy + 1,
                      (src.shape[2] - 1) // step.sx + 1)
            geom = dict(size=step.kh, stride=(step.sy, step.sx),
                        padding=pad, out_hw=out_hw, out_dtype=cd)
            y = conv_int8_act(src, p_l, step.act, **geom) if one_pass \
                else apply_activation(conv2d_int8(src, p_l, **geom),
                                      step.act)
        else:
            w = weights[wi].permute(3, 2, 0, 1)    # HWIO -> OIHW
            geom = dict(stride=(step.sy, step.sx), padding=pad,
                        compute_dtype=cd)
            y = conv_act(src, w, biases[wi], step.act, **geom) if one_pass \
                else apply_activation(conv2d_raw(src, w, biases[wi], **geom),
                                      step.act)
        slots[step.out_slot] = y
        wi += 1


def region_plain(plan: RegionPlan, x, weights, biases, *,
                 compute_dtype=torch.float32, params=None,
                 one_pass: bool = False):
    """The plain version of the region kernel: same contract as
    `ops.cuda.fused_region.region_call` (x is the raw net input when
    plan.stem, else the previous layer's NHWC output).  `params` and
    `one_pass` (a served region the kernel does not run) as in
    `run_steps_plain` (the whole region in plain form)."""
    from darknet_tpu_torch.ops.stem import space_to_depth

    if plan.stem:
        x = space_to_depth(x)
    slots = {IN_SLOT: x.to(compute_dtype)}
    run_steps_plain(plan.steps, slots, weights, biases, compute_dtype,
                    params, one_pass=one_pass)
    return slots[plan.out_slot]
