"""Graph IR -> forward function (`darknet_tpu/nn/emit.py`).

`make_forward(graph)` returns `forward(params, x) -> {"heads", "raw_heads",
"output"}` over NHWC tensors.  It keeps only the outputs that a later layer reads
again (liveness over route/shortcut/scale_channels edges) and dispatches
per layer over every kind the JAX package's forward runs
(`darknet_tpu/nn/emit.py:342-432`).  `make_forward(graph, train=True)`
is the training forward (`_make_train_forward`).

A stride > 1 antialiased conv or maxpool that a later layer reads again
exposes to that reader the reference's stride-1 buffer with the blurred
output over its front (`ops/conv.antialias_backref_view`), while the next
layer reads the blurred tensor.

Fused regions (`ops/fused_region.py`) run in the reference's "hybrid"
form: the stride-1 step prefix of a region (`hybrid_prefix`; for yolov4
the space-to-depth stem plus the first CSP block, layers 0-10) goes
through `ops.cuda.fused_region.region_call` (the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor), and the strided remainder
through the plain steps, each conv with the epilogue `ops/conv.conv_block`
gives it (on the card the one-pass kernel, `ops/cuda/conv_epilogue`).
fuse_regions="plain" runs whole regions through
the plain steps on any device (the reference the kernel path is checked
against on the card).

A conv whose params carry "w_q" (`Network.from_cfg(int8=True)`) runs
`ops/conv.conv_block_int8`, the int8 GEMM kernel on a CUDA tensor; inside
a region, a step whose layer carries a calibrated "x_scale" does too.
`make_forward(region_int8=True)` plans the regions without the stem fold
and runs them as plain steps: with every region conv quantized
(`Network.calibrate_int8(region_int8=True)`), layer 0 runs as its own
int8 conv on the raw input and each region step as an int8 conv, and no
region kernel launches.
"""

from __future__ import annotations

import dataclasses
import zlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from darknet_tpu_torch.ops import shapes as shapeops
from darknet_tpu_torch.ops import yolo as yoloops
from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops.conv import (antialias_backref_view,
                                        antialias_blur, batchnorm_block,
                                        connected_block, conv_block,
                                        conv_block_int8, conv_train_pre,
                                        precise_matmul)
from darknet_tpu_torch.ops.pooling import (global_avgpool, maxpool,
                                           maxpool_block)
from darknet_tpu_torch.utils import debug
from darknet_tpu_torch.utils.spans import scope

HEAD_KINDS = ("yolo", "gaussian_yolo", "detection", "cost")


def _detection_head(x, l):
    """The YOLOv1 head's output: the input flattened NHWC to (B, 1, 1, -1),
    as the JAX package flattens it (`darknet_tpu/nn/emit.py:418-423`)."""
    return x.reshape(x.shape[0], 1, 1, -1)


# the heads' inference activation
ACTIVATE = {"yolo": yoloops.yolo_activate,
            "gaussian_yolo": yoloops.gaussian_yolo_activate,
            "detection": _detection_head}


def local_block(x, p, l, rows=None):
    """[local] (local_layer.c, `darknet_tpu/nn/emit.py:58-80`): a conv with
    its own weights at every output location.  The patches are channel-
    major (c, kh, kw), as `F.unfold` gives them; p["w"] is (locations, n,
    size*size*c) and p["b"] one bias per output element in CHW order.
    The product runs in f32 with TF32 off whatever the compute dtype (the
    reference's einsum of the input with f32 weights), and so does the
    activation.  rows=(j0, o0, n): x is a slab of the input, and the
    output is rows o0..o0+n-1 of the layer's, which are rows j0..j0+n-1
    of what the slab's windows give (`parallel/spatial.py`)."""
    b = x.shape[0]
    patches = F.unfold(x.float().permute(0, 3, 1, 2), l.size, padding=l.pad,
                       stride=l.stride)              # (B, c*k*k, locations)
    j0, o0, n = (0, 0, l.out_h) if rows is None else rows
    if rows is not None:
        k = patches.shape[1]
        patches = patches.reshape(b, k, -1, l.out_w)[:, :, j0:j0 + n]
        patches = patches.reshape(b, k, n * l.out_w)
    sl = slice(o0 * l.out_w, (o0 + n) * l.out_w)
    with precise_matmul(torch.float32):
        y = torch.bmm(patches.permute(2, 0, 1), p["w"][sl].transpose(1, 2))
    loc = l.out_h * l.out_w
    y = y.permute(1, 0, 2) + p["b"].reshape(l.n, loc).t()[sl][None]
    return apply_activation(y, l.activation).reshape(b, n, l.out_w, l.n)


def _aa_backref_needed(l, i, live) -> bool:
    """A stride > 1 antialiased layer whose output a later layer reads."""
    return (bool(getattr(l, "antialiasing", 0)) and i in live
            and (l.blur_stride_x > 1 or l.blur_stride_y > 1))


def _aa_split(y, l):
    """(the blurred tensor, the back-referenced view) of an antialiased
    layer's stride-1 output `y`."""
    blur = antialias_blur(y, l)
    return blur, antialias_backref_view(y, blur, l)


def _no_aa(l):
    return dataclasses.replace(l, antialiasing=0)


def _common(k, l, cur, outs, params):
    """The layers that serve and train alike, shared by both forwards
    (None for another kind)."""
    if k == "route":
        return shapeops.route([outs[s] for s in l.layers], l.groups,
                              l.group_id)
    if k == "shortcut":
        return shapeops.shortcut(cur, outs[l.from_layer], l.activation)
    if k == "scale_channels":
        return shapeops.scale_channels(cur, outs[l.from_layer], l.scale_wh,
                                       l.activation)
    if k == "upsample":
        if l.reverse:
            return shapeops.upsample_reverse(cur, l.stride, l.scale)
        return shapeops.upsample(cur, l.stride, l.scale)
    if k == "reorg":
        return shapeops.reorg3d(cur, l.stride, l.reverse,
                                (l.out_h, l.out_w, l.out_c))
    if k == "reorg_old":
        return shapeops.reorg_old(cur, l.stride, l.reverse,
                                  (l.out_h, l.out_w, l.out_c))
    if k == "avgpool":
        return global_avgpool(cur)
    if k == "activation":
        return apply_activation(cur, l.activation)
    if k == "local":
        return local_block(cur, params[l.index], l)
    return None


def _refuse_unservable(layers) -> None:
    """Layer forms the port refuses when a forward is built, before any
    work: a legacy [reorg] (reorg_old) needs C >= stride^2 input
    channels, since darknet's reorg_cpu divides by C // stride^2 (the
    JAX package serves all-NaN heads there instead)."""
    for l in layers:
        if l.kind == "reorg_old" and l.c < l.stride * l.stride:
            raise ValueError(
                f"layer {l.index}: [reorg] with stride {l.stride} needs "
                f"C >= stride^2 = {l.stride * l.stride} input channels, "
                f"got C = {l.c}")


def _liveness(graph) -> set:
    """Indices whose outputs a non-adjacent later layer reads, plus the
    heads and the last layer."""
    live = set()
    for l in graph.layers:
        live.update(l.input_indices())
    live.update(l.index for l in graph.layers if l.kind in HEAD_KINDS)
    if graph.layers:
        live.add(len(graph.layers) - 1)
    return live


def region_runner(plan, *, compute_dtype=torch.float32,
                  mode: str = "hybrid"):
    """run(params, x) -> region output (NHWC) for one plan.

    run.step_weights(params) derives the conv steps' weights and f32
    biases in the forms the runner reads: the kernel's prefix in the
    compute dtype, the plain remainder as f32 copies of those values (in
    bf16 the plain convs read bf16 weights so, `ops/conv.conv2d_raw`).
    run.keys names them in a params entry (`make_forward(...).
    with_step_weights`); params whose start layer holds them are read as
    they are, other params derive them for the call."""
    from darknet_tpu_torch.ops import fused_region as fr
    from darknet_tpu_torch.ops.cuda.fused_region import region_call

    cd = compute_dtype
    pre = kernel_prefix(plan) if mode == "hybrid" else None
    n_pre = 0 if pre is None else len(pre[0].conv_steps)
    n_conv = len(plan.conv_steps)
    tag = zlib.crc32(f"{plan.to_json()}|{mode}|{cd}".encode())
    keys = ([f"step{tag:08x}_w{j}" for j in range(n_conv)]
            + [f"step{tag:08x}_b{j}" for j in range(n_conv)])

    def step_weights(params):
        ws, bs = fr.step_weights(plan.steps, params, cd)
        return ws[:n_pre] + [w.float() for w in ws[n_pre:]], bs

    def weights(params):
        held = params[plan.start]
        if keys and keys[0] in held:
            return ([held[k] for k in keys[:n_conv]],
                    [held[k] for k in keys[n_conv:]])
        return step_weights(params)

    run_prefix = None
    if pre is None:
        def run(params, x):
            ws, bs = weights(params)
            return fr.region_plain(plan, x, ws, bs, compute_dtype=cd,
                                   params=params, one_pass=mode == "hybrid")
    else:
        sub, k = pre
        rest = plan.steps[k:]
        sub_json = sub.to_json()
        slab_json: dict = {}

        def run(params, x):
            ws, bs = weights(params)
            y = region_call(sub_json, x, ws[:n_pre], bs[:n_pre],
                            compute_dtype=cd)
            slots = {sub.out_slot: y}
            fr.run_steps_plain(rest, slots, ws[n_pre:], bs[n_pre:], cd,
                               params, one_pass=True)
            return slots[plan.out_slot]

        def run_prefix(params, x, h):
            """The kernel prefix alone on x, a slab of `h` rows of the
            prefix's own coordinates (s2d rows for a stem plan) cut from
            the region input: the kernel pads the slab's edges with
            zeros, so only rows at least (rt, rb) inside them are the
            unsharded prefix's (`parallel/spatial.py`)."""
            if h not in slab_json:
                slab_json[h] = dataclasses.replace(sub, h=h,
                                                   out_h=h).to_json()
            ws, bs = weights(params)
            return region_call(slab_json[h], x, ws[:n_pre], bs[:n_pre],
                               compute_dtype=cd)

    run.step_weights, run.keys = step_weights, keys
    # the kernel prefix's plan (None without one) and its slab runner
    run.prefix = None if pre is None else pre[0]
    run.run_prefix = run_prefix
    return run


def region_conv_indices(graph) -> set:
    """Conv layer indices covered by the inference region plans (stem
    fold included when layer 0 is not live), as make_forward plans them."""
    from darknet_tpu_torch.ops.fused_region import plan_graph_regions
    from darknet_tpu_torch.ops.stem import stem_pattern

    stem = bool(stem_pattern(graph) and 0 not in _liveness(graph))
    return {k for p in plan_graph_regions(graph, stem=stem).values()
            for k in range(p.start, p.stop + 1)
            if graph.layers[k].kind == "convolutional"}


def kernel_prefix(plan):
    """(sub-plan, steps) of `plan` the region kernel runs in the hybrid
    form: the stride-1 step prefix (`hybrid_prefix`), else the whole plan
    unless it is xla_only; None when the kernel runs none of it."""
    from darknet_tpu_torch.ops import fused_region as fr

    pre = fr.hybrid_prefix(plan)
    if pre is None and not plan.xla_only:
        pre = (plan, len(plan.steps))
    return pre


def kernel_conv_indices(graph) -> set:
    """Conv layer indices the region kernel runs: the kernel prefixes
    (`kernel_prefix`) of the inference region plans.  Every other served
    conv takes its own epilogue (`ops/conv.conv_block`, or the
    remainder's plain steps)."""
    from darknet_tpu_torch.ops import fused_region as fr
    from darknet_tpu_torch.ops.stem import stem_pattern

    stem = bool(stem_pattern(graph) and 0 not in _liveness(graph))
    out = set()
    for plan in fr.plan_graph_regions(graph, stem=stem).values():
        pre = kernel_prefix(plan)
        if pre is not None:
            out |= {s.li for s in pre[0].steps
                    if isinstance(s, fr.ConvStep)}
    return out


def region_int8_convs(graph) -> set:
    """The convs region_int8 quantizes: the region convs, less those that
    feed a head (`darknet_tpu/nn/network.py:185-197`)."""
    return region_conv_indices(graph) - {
        l.index - 1 for l in graph.layers
        if l.kind in ("yolo", "gaussian_yolo", "detection")}


def make_forward(graph, *, compute_dtype=None, fuse_regions="hybrid",
                 fused_bn: bool = True, probe_conv_absmax: bool = False,
                 region_int8: bool = False, train: bool = False,
                 train_act_dtype=None, remat: bool | str = False,
                 stats_group=None):
    """Build `forward(params, x) -> {"heads", "raw_heads", "output"}`:
    the activated heads, the head inputs before activation, and the last
    layer's output.  A conv whose params carry "w_q" runs the int8 conv
    (`ops/conv.conv_block_int8`).

    probe_conv_absmax adds "conv_in_absmax": {layer index: max |input|}
    (a device scalar per conv), the int8 calibration probe; it plans no
    region and no stem fold, so every conv is observed.

    region_int8 plans the regions without the stem fold and runs them as
    plain steps (no region kernel), for params whose region convs all
    carry "w_q" and "x_scale".  fuse_regions=None plans no region and no
    stem fold: every layer runs as its own op (`parallel/tensor.py`).

    compute_dtype None (or float32) is the f32 parity path; bfloat16 is
    the serving path (convs on the tensor cores, activations stored in
    bf16, heads returned as computed).  params are post-BN-fold torch
    params (`nn/params.params_to_torch`).

    train=True builds the training forward instead (`_make_train_forward`;
    unfolded params from `nn/params.train_params_to_torch`), its batch
    statistics taken over the process group `stats_group` where one is
    given (sync-BN, `parallel/dp.py`)."""
    if train:
        return _make_train_forward(graph, compute_dtype=compute_dtype,
                                   train_act_dtype=train_act_dtype,
                                   remat=remat, stats_group=stats_group)
    from darknet_tpu_torch.ops.fused_region import plan_graph_regions
    from darknet_tpu_torch.ops.stem import stem_pattern

    _refuse_unservable(graph.layers)
    cd = compute_dtype or torch.float32
    live = _liveness(graph)
    layers = graph.layers
    if fuse_regions not in ("hybrid", "plain", None):
        raise ValueError(f"fuse_regions must be 'hybrid', 'plain' or None, "
                         f"got {fuse_regions!r}")
    off = probe_conv_absmax or not fused_bn or fuse_regions is None
    stem = bool(stem_pattern(graph) and 0 not in live and not region_int8
                and not off)
    plans = {} if off else plan_graph_regions(graph, stem=stem)
    runners = {a: region_runner(p, compute_dtype=cd,
                                mode="plain" if region_int8 else fuse_regions)
               for a, p in plans.items()}

    def layer(i, l, cur, outs, absmax, heads, raw_heads, params):
        k = l.kind
        aa_backref = _aa_backref_needed(l, i, live)
        y = _common(k, l, cur, outs, params)
        if y is not None:
            cur = y
        elif k == "convolutional":
            if probe_conv_absmax:
                absmax[i] = cur.float().abs().amax()
            p = params[l.share_index if l.share_index is not None else i]
            block = conv_block_int8 if "w_q" in p else conv_block
            cur = block(cur, p, _no_aa(l) if aa_backref else l,
                        compute_dtype=cd)
        elif k == "maxpool":
            cur = maxpool(cur, l) if aa_backref else maxpool_block(cur, l)
        elif k == "connected":
            cur, _st = connected_block(cur, params[i], l, compute_dtype=cd)
            cur = cur.reshape(cur.shape[0], 1, 1, -1)
        elif k == "batchnorm":
            cur, _st = batchnorm_block(cur, params[i], l)
        elif k == "crop":
            cur = shapeops.crop_layer(cur, l)
        elif k in ACTIVATE:
            raw_heads.append(cur)
            cur = ACTIVATE[k](cur, l)
            heads.append(cur)
        elif k in ("empty", "blank", "dropout", "cost"):
            pass                        # identity at inference
        else:
            raise NotImplementedError(f"layer {i}: kind {k!r}")
        if aa_backref:
            cur, backref = _aa_split(cur, l)
            outs[i] = backref
        elif i in live:
            outs[i] = cur
        return cur

    def forward(params, x, *, _lo=0, _hi=None, _extern=None):
        """_lo/_hi/_extern: stage-slice mode (`parallel/pipeline.py`,
        `darknet_tpu/nn/emit.py:203-260`): only layers [_lo, _hi) run,
        `x` is layer _lo's input and `_extern` seeds the outputs of
        earlier layers that later ones read; the result then also holds
        "outs", every live output so far.  A region runs whole in the
        slice that holds its start layer: a slice may not begin or end
        inside one."""
        outs: dict = dict(_extern or {})
        absmax: dict = {}
        heads: list = []
        raw_heads: list = []
        check = debug.layer_check()
        cur = x
        hi = len(layers) if _hi is None else _hi
        for a, p in plans.items():
            if a < _lo <= p.stop or a < hi <= p.stop:
                raise ValueError(
                    f"layers [{_lo}, {hi}) cut the region "
                    f"{a}-{p.stop}: a region runs whole in one slice")
        i = _lo
        while i < hi:
            l = layers[i]
            if i in runners:
                name = f"L{i:03d}-{plans[i].stop:03d}_region"
                with scope(name):
                    cur = runners[i](params, cur)
                i = plans[i].stop
                if i in live:
                    outs[i] = cur
            else:
                name = f"L{i:03d}_{l.kind}"
                with scope(name):
                    cur = layer(i, l, cur, outs, absmax, heads, raw_heads,
                                params)
            if check is not None:
                check(name, cur)
            i += 1
        r = {"heads": heads, "raw_heads": raw_heads, "output": cur}
        if probe_conv_absmax:
            r["conv_in_absmax"] = absmax
        if _lo or _hi is not None:
            r["outs"] = outs
        return r

    def with_step_weights(params) -> list:
        """A copy of `params` whose region start layers also hold their
        runners' step weights (`region_runner`), which the forward then
        reads instead of deriving them a call: the Network holds it
        (`Network.forward_params`), for eager serving and its export
        alike.  Each is a copy with the strides of the tensor it copies,
        so every conv sees the layout a derived one has, and no two
        params share storage."""
        out = list(params)
        for a, run in runners.items():
            ws, bs = run.step_weights(params)
            out[a] = dict(out[a])
            for key, t in zip(run.keys, ws + bs):
                out[a][key] = torch.empty_strided(
                    t.shape, t.stride(), dtype=t.dtype,
                    device=t.device).copy_(t)
        return out

    forward.region_plans = plans
    forward.with_step_weights = with_step_weights
    # for the executors that run the layers themselves (`parallel/`):
    # the stem fold, the liveness set, the region runners and the
    # per-layer step, `layer(i, l, cur, outs, absmax, heads, raw_heads,
    # params)` -> the layer's output (outs, heads updated in place)
    forward.stem = any(p.stem for p in plans.values())
    forward.live = live
    forward.runners = runners
    forward.layer = layer
    return forward


def _make_train_forward(graph, *, compute_dtype=None, train_act_dtype=None,
                        remat: bool | str = False, stats_group=None):
    """The training forward (`darknet_tpu/nn/emit.py:100-464`, train=True):
    `forward(params, x, generator=None) -> {"heads", "raw_heads",
    "bn_stats", "output"}`, with "bn_stats" {layer index: (batch mean,
    batch var)} of the batch-normalised convs, connected and [batchnorm]
    layers, detached for the rolling update, and "raw_heads" the head
    inputs the deltas apply to ([yolo], [Gaussian_yolo], [detection] and
    [cost], in layer order).

    Every conv runs `ops/conv.conv_block(train=True)` (live batch norm, no
    region plan, no stem fold: the JAX package plans regions for training
    only on a TPU).  train_act_dtype (bf16: act16) carries the conv
    outputs and the y_hat residuals at reduced precision, except the
    outputs of convs that feed a head, which stay f32.  remat=True
    recomputes each conv block in the backward pass
    (`torch.utils.checkpoint`).  stopbackward/onlyforward detach a layer's
    output; train_only_bn is the optimizer's gate.

    Dropout, dropblock and [crop] draw from `generator`, which must live on
    x's device (`ops/shapes`); with none, dropout is the identity and crop
    the centre crop, as the JAX package's forward with rng=None.  Not
    ported: remat "steps"/"all" (region-only levels).

    `forward(params, x, generator, _lo=, _hi=, _extern=)` runs a stage
    slice (`parallel/pipeline.PipelineTrain`); the executors that run
    the layers themselves (`parallel/spatial.MeshTrain`) read the
    per-layer step `forward.layer`, `forward.live`, and a conv's two
    halves: `forward.conv_pre` (`ops/conv.conv_train_pre`) and, after the
    batch norm + activation over the parts, `forward.conv_out` (the
    act16 cast)."""
    if remat not in (False, True):
        raise NotImplementedError(
            f"remat={remat!r}: only False and True are ported (the "
            f"region-only levels have no region in the port's training)")
    layers = graph.layers
    _refuse_unservable(layers)
    live = _liveness(graph)
    head_feed = {j - 1 for j, l in enumerate(layers) if l.kind in HEAD_KINDS}

    def conv(cur, p, l, res_dt):
        return conv_block(cur, p, l, train=True, compute_dtype=compute_dtype,
                          res_dtype=res_dt, stats_group=stats_group)

    def forward(params, x, generator=None, *, _lo=0, _hi=None,
                _extern=None):
        """_lo/_hi/_extern: stage-slice mode (`parallel/pipeline.
        PipelineTrain`, `darknet_tpu/nn/emit.py:203-260`): only layers
        [_lo, _hi) run, `x` is layer _lo's input and `_extern` seeds the
        outputs of earlier layers that later ones read; the result then
        also holds "outs", every live output so far.  The random layers
        draw from `generator` in layer order, so slices run in layer order
        with one generator draw the unsliced forward's masks (the JAX
        package offsets its split keys by the random layers below _lo to
        the same end)."""
        outs: dict = dict(_extern or {})
        bn_stats: dict = {}
        heads: list = []
        raw_heads: list = []
        check = debug.layer_check()
        cur = x
        hi = len(layers) if _hi is None else _hi
        for i in range(_lo, hi):
            l = layers[i]
            name = f"L{i:03d}_{l.kind}"
            with scope(name):
                cur = layer(i, l, cur, outs, bn_stats, heads, raw_heads,
                            params, generator)
            if check is not None:
                check(name, cur)
        r = {"heads": heads, "raw_heads": raw_heads, "bn_stats": bn_stats,
             "output": cur}
        if _lo or _hi is not None:
            r["outs"] = outs
        return r

    def layer(i, l, cur, outs, bn_stats, heads, raw_heads, params,
              generator):
        k = l.kind
        aa_backref = _aa_backref_needed(l, i, live)
        st = None
        y = _common(k, l, cur, outs, params)
        if y is not None:
            cur = y
        elif k == "convolutional":
            p = params[l.share_index if l.share_index is not None else i]
            res_dt = train_act_dtype if i not in head_feed else None
            l_eff = _no_aa(l) if aa_backref else l
            if remat:
                cur, st = checkpoint(conv, cur, p, l_eff, res_dt,
                                     use_reentrant=False)
            else:
                cur, st = conv(cur, p, l_eff, res_dt)
            if aa_backref:
                cur, outs[i] = _aa_split(cur, l)
            if train_act_dtype is not None and i not in head_feed:
                cur = cur.to(train_act_dtype)
        elif k == "maxpool":
            if aa_backref:
                cur, outs[i] = _aa_split(maxpool(cur, l, train=True), l)
            else:
                cur = maxpool_block(cur, l, train=True)
        elif k == "connected":
            cur, st = connected_block(cur, params[i], l, train=True,
                                      compute_dtype=compute_dtype,
                                      stats_group=stats_group)
            cur = cur.reshape(cur.shape[0], 1, 1, -1)
        elif k == "batchnorm":
            cur, st = batchnorm_block(cur, params[i], l, train=True,
                                      stats_group=stats_group)
        elif k == "dropout":
            if generator is not None:
                if l.dropblock:
                    cur = shapeops.dropblock(
                        cur, generator, l.probability,
                        l.dropblock_size_abs, l.dropblock_size_rel)
                else:
                    cur = shapeops.dropout(cur, generator, l.probability)
        elif k == "crop":
            cur = shapeops.crop_layer(cur, l, train=True,
                                      generator=generator)
        elif k in ACTIVATE:
            raw_heads.append(cur)
            cur = ACTIVATE[k](cur, l)
            heads.append(cur)
        elif k == "cost":
            raw_heads.append(cur)
        elif k in ("empty", "blank"):
            pass
        else:
            raise NotImplementedError(f"layer {i}: kind {k!r}")
        if st is not None:
            bn_stats[i] = (st[0].detach(), st[1].detach())
        if l.stopbackward or l.onlyforward:
            # BackwardNetwork stops here (network.cpp:179-181)
            cur = cur.detach()
        if i in live:
            outs[i] = outs.get(i, cur) if aa_backref else cur
        return cur

    def conv_pre(i, l, x, p):
        """The first half of layer i's conv on `x` (`ops/conv.
        conv_train_pre`) with `p` its params (the share_index owner's)."""
        res_dt = train_act_dtype if i not in head_feed else None
        return conv_train_pre(x, p, l, compute_dtype=compute_dtype,
                              res_dtype=res_dt)

    def conv_out(i, y):
        """A conv output as the next layer reads it: at train_act_dtype
        unless the conv feeds a head."""
        if train_act_dtype is not None and i not in head_feed:
            return y.to(train_act_dtype)
        return y

    # for the executors that run the layers themselves (`parallel/`): the
    # per-layer step `layer(i, l, cur, outs, bn_stats, heads, raw_heads,
    # params, generator)` -> the layer's output (outs, bn_stats and the
    # head lists updated in place), the liveness set, the convs that
    # feed a head, the conv's first half and its output cast; training
    # plans no region
    forward.layer = layer
    forward.live = live
    forward.head_feed = head_feed
    forward.conv_pre = conv_pre
    forward.conv_out = conv_out
    forward.train_act_dtype = train_act_dtype
    return forward
