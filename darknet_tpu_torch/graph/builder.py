"""cfg sections → typed IR graph, replicating the reference parser semantics.

This mirrors `ParseNetworkCfg` (reference `parser.cpp:1076-1520`): the first
section must be `[net]`/`[network]`; each subsequent section becomes one
layer; (h, w, c, inputs) shape state threads through layers exactly as in
`parser.cpp:1383-1398` (with the antialiasing rewiring); and layer defaults
match the per-type `Parse*` functions (`parser.cpp:161-860`).
"""

from __future__ import annotations

import warnings

from darknet_tpu_torch.config.cfg import Section, parse_cfg_file, parse_cfg_text
from darknet_tpu_torch.graph import ir
from darknet_tpu_torch.graph.ir import (
    ActivationIR, AvgpoolIR, BatchnormIR, ConnectedIR, ConvIR, CostIR, CropIR,
    DetectionIR, DropoutIR, EmptyIR, GaussianYoloIR, LayerIR, LocalIR,
    MaxpoolIR, NetConfig, ReorgIR, ReorgOldIR, RouteIR, ScaleChannelsIR,
    ShortcutIR, UpsampleIR, YoloIR, conv_bflops, conv_out_hw,
    normalize_activation,
)

_NET_TYPES = ("[net]", "[network]")

# Activations with NO case in the reference's generic ``activate()`` /
# ``activate_kernel()`` switch (activations.c:97-137,
# activation_kernels.cu:144-184): the switch default returns 0.0f, so the
# layers that activate through the generic path — [activation], [local],
# [scale_channels], [connected]; conv and shortcut have dedicated mish/
# swish branches — silently ZERO their output for these activations, on
# both the CPU and GPU builds.  Reproduced by rewriting to the "zero"
# activation (ops/activations.zero); gradient() likewise defaults to 0
# for mish/swish, which autodiff of the constant matches.  Found by fuzz
# seed 907 ([activation] activation=mish after an antialiased conv).
_GENERIC_ACT_ZEROED = frozenset((
    "mish", "swish", "normalize_channels", "normalize_channels_softmax",
    "normalize_channels_softmax_maxval",
))


def _generic_path_activation(act: str, kind: str) -> str:
    """Rewrite activations the reference's generic path zeroes (above)."""
    if act in _GENERIC_ACT_ZEROED:
        warnings.warn(
            f"[{kind}] activation={act}: the reference's generic activate() "
            "has no case for it and returns 0 — output is zeroed "
            "(activations.c:97-137); matching.")
        return "zero"
    return act

# cfg section name -> canonical kind (StrToLayerType, parser.cpp:102-147)
_SECTION_KINDS = {
    "[shortcut]": "shortcut",
    "[scale_channels]": "scale_channels",
    "[crop]": "crop",
    "[cost]": "cost",
    "[detection]": "detection",
    "[yolo]": "yolo",
    "[Gaussian_yolo]": "gaussian_yolo",
    "[local]": "local",
    "[conv]": "convolutional",
    "[convolutional]": "convolutional",
    "[activation]": "activation",
    "[conn]": "connected",
    "[connected]": "connected",
    "[max]": "maxpool",
    "[maxpool]": "maxpool",
    "[reorg3d]": "reorg",
    "[reorg]": "reorg_old",
    "[avg]": "avgpool",
    "[avgpool]": "avgpool",
    "[dropout]": "dropout",
    "[batchnorm]": "batchnorm",
    "[route]": "route",
    "[upsample]": "upsample",
    "[empty]": "empty",
}


class Graph:
    """Parsed network: net-level config + ordered layer IR list."""

    def __init__(self, net: NetConfig, layers: list[LayerIR]):
        self.net = net
        self.layers = layers

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i: int) -> LayerIR:
        return self.layers[i]

    @property
    def total_bflops(self) -> float:
        return sum(l.bflops for l in self.layers)

    def heads(self) -> list[LayerIR]:
        """Detection heads in layer order (yolo / gaussian_yolo / detection)."""
        return [l for l in self.layers
                if l.kind in ("yolo", "gaussian_yolo", "detection")]

    def consumers(self) -> dict:
        """index -> list of later layer indices that read this output."""
        out: dict[int, list[int]] = {i: [] for i in range(len(self.layers))}
        for i, l in enumerate(self.layers):
            srcs = l.input_indices()
            # layers that implicitly consume the previous layer's output
            if l.kind not in ("route",) and i > 0:
                srcs = [i - 1] + srcs
            for s in srcs:
                if 0 <= s < len(self.layers):
                    out[s].append(i)
        return out

    def receptive_fields(self) -> list:
        """Per-layer theoretical receptive field (w, h), replicating the
        `show_receptive_field` recurrence exactly (parser.cpp:1260-1315)
        including its quirks: [upsample]/[reorg3d] divide the running
        scale by their stride (integer division), [route] takes the max
        over its inputs, and every other layer grows the field by
        (size + 2*(dilation-1) - 1) * scale then multiplies the scale by
        its stride."""
        rw = rh = rws = rhs = 1
        per_layer: dict = {}
        out = []
        for i, l in enumerate(self.layers):
            dilation = max(1, getattr(l, "dilation", 1) or 1)
            stride = max(1, getattr(l, "stride", None)
                         or getattr(l, "stride_x", 1) or 1)
            size = max(1, getattr(l, "size", 1) or 1)
            if l.kind in ("upsample", "reorg3d"):
                rws //= stride
                rhs //= stride
            elif l.kind == "route":
                rw = rh = rws = rhs = 0
                for k in l.input_indices():
                    fw, fh, fws, fhs = per_layer.get(k, (0, 0, 0, 0))
                    rw, rh = max(rw, fw), max(rh, fh)
                    rws, rhs = max(rws, fws), max(rhs, fhs)
            else:
                inc = max(0, size + (dilation - 1) * 2 - 1)
                rw += inc * rws
                rh += inc * rhs
                rws *= stride
                rhs *= stride
            per_layer[i] = (rw, rh, rws, rhs)
            out.append((rw, rh))
        return out

    def layer_table(self) -> str:
        """Human-readable per-layer table like the reference stderr output."""
        rf = self.receptive_fields() if self.net.show_receptive_field else None
        lines = ["   layer   filters  size/strd(dil)      input                output"]
        for l in self.layers:
            lines.append(_format_layer_row(l))
            if rf is not None:
                w, h = rf[l.index]
                lines.append(f"{l.index:4d} - receptive field: {w} x {h} ")
        lines.append(f"Total BFLOPS {self.total_bflops:5.3f}")
        return "\n".join(lines)


def _format_layer_row(l: LayerIR) -> str:
    i = l.index
    if l.kind == "convolutional":
        s = (f"{i:4d} conv {l.n:8d} {l.size:2d} x{l.size:2d}/{l.stride_x:2d}  "
             f"{l.w:4d} x{l.h:4d} x{l.c:4d} -> {l.out_w:4d} x{l.out_h:4d} "
             f"x{l.out_c:4d} {l.bflops:5.3f} BF")
        return s
    if l.kind == "maxpool":
        return (f"{i:4d} max          {l.size:2d}x{l.size:2d}/{l.stride_x:2d}  "
                f"{l.w:4d} x{l.h:4d} x{l.c:4d} -> {l.out_w:4d} x{l.out_h:4d} "
                f"x{l.out_c:4d}")
    if l.kind == "route":
        return f"{i:4d} route {','.join(map(str, l.layers))} -> " \
               f"{l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}"
    if l.kind == "shortcut":
        return f"{i:4d} shortcut {l.from_layer}"
    if l.kind == "upsample":
        return (f"{i:4d} upsample {l.stride:10d}x  {l.w:4d} x{l.h:4d} x{l.c:4d}"
                f" -> {l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}")
    return f"{i:4d} {l.kind}"


# --------------------------------------------------------------------------
# [net] options — ParseNetOptions (parser.cpp:921-1054)
# --------------------------------------------------------------------------


def _parse_net_options(s: Section, train: bool) -> NetConfig:
    batch = s.get_int("batch", 1)
    subdiv = s.get_int("subdivisions", 1)
    batch //= subdiv
    h = s.get_int("height", 0)
    w = s.get_int("width", 0)
    c = s.get_int("channels", 0)
    if not (h and w and c):
        raise ValueError("No input parameters supplied ([net] needs "
                         "height/width/channels)")
    if not train or batch < 1:
        batch = 1

    net = NetConfig(h=h, w=w, c=c, batch=batch, subdiv=subdiv)
    net.inputs = h * w * c
    net.max_epoch = s.get_int("max_epoch", 0)

    net.lr = s.get_float("learning_rate", 1e-3)
    net.lr_min = s.get_float("learning_rate_min", 1e-5)
    net.momentum = s.get_float("momentum", 0.9)
    net.decay = s.get_float("decay", 1e-4)

    policy = s.get_str("policy", "constant")
    if policy not in ir.LR_POLICIES:
        warnings.warn(f"Couldn't find policy {policy}, going with constant")
        policy = "constant"
    net.policy = policy
    net.burn_in = s.get_int("burn_in", 0)
    net.power = s.get_float("power", 4.0)

    if policy == "step":
        net.step = s.get_int("step", 1)
        net.scale = s.get_float("scale", 1.0)
    if policy in ("steps", "sgdr"):
        net.sgdr_cycle = s.get_int("sgdr_cycle", net.max_iter)
        net.sgdr_mult = s.get_int("sgdr_mult", 2)
        steps = s.get_float_list("steps")
        scales = s.get_float_list("scales")
        if policy == "steps" and (steps is None or scales is None):
            raise ValueError("STEPS policy must have steps and scales in cfg")
        if steps is not None:
            # the reference reads exactly len(steps) scales, reading garbage
            # if scales is shorter — we require matching lengths instead
            if scales is None or len(scales) < len(steps):
                raise ValueError("scales must have one entry per step")
            net.steps = tuple(steps)
            net.scales = tuple(scales[: len(steps)])
            net.num_steps = len(steps)
    if policy == "exp":
        net.gamma = s.get_float("gamma", 1.0)
    if policy == "sigmoid":
        net.gamma = s.get_float("gamma", 1.0)
        net.step = s.get_int("step", 1)

    net.adam = bool(s.get_int("adam", 0))
    if net.adam:
        net.B1 = s.get_float("B1", 0.9)
        net.B2 = s.get_float("B2", 0.999)
        net.eps = s.get_float("eps", 1e-6)
    net.loss_scale = s.get_float("loss_scale", 1.0)

    # augmentation
    net.max_crop = s.get_int("max_crop", w * 2)
    net.min_crop = s.get_int("min_crop", w)
    net.flip = bool(s.get_int("flip", 1))
    net.blur = s.get_int("blur", 0)
    net.gaussian_noise = s.get_int("gaussian_noise", 0)
    cutmix = s.get_int("cutmix", 0)
    mosaic = s.get_int("mosaic", 0)
    if mosaic and cutmix:
        net.mixup = 4
    elif cutmix:
        net.mixup = 2
    elif mosaic:
        net.mixup = 3
    net.label_smooth_eps = s.get_float("label_smooth_eps", 0.0)
    net.resize_step = int(s.get_float("resize_step", 32))
    net.angle = s.get_float("angle", 0.0)
    net.aspect = s.get_float("aspect", 1.0)
    net.saturation = s.get_float("saturation", 1.0)
    net.exposure = s.get_float("exposure", 1.0)
    net.hue = s.get_float("hue", 0.0)
    net.power = s.get_float("power", net.power)
    net.show_receptive_field = bool(
        s.get_float("show_receptive_field", 0.0))
    # accepted no-op: CUDA delta-buffer sharing (parser.cpp:1411-1453) —
    # XLA's buffer assignment subsumes the reference's optimized_memory /
    # cuDNN workspace cap (parser.cpp:1031-1035) — read both quietly so
    # cfgs carrying them don't trip UnusedOption warnings
    s.get_int("optimized_memory", 0)
    s.get_float("workspace_size_limit_MB", 1024.0)
    return net


# --------------------------------------------------------------------------
# Per-layer parsers
# --------------------------------------------------------------------------


def _parse_conv(s: Section, p: dict, index: int, layers: list[LayerIR]) -> ConvIR:
    n = s.get_int("filters", 1)
    groups = s.get_int("groups", 1)
    size = s.get_int("size", 1)
    stride_x = s.get_int("stride_x", -1)
    stride_y = s.get_int("stride_y", -1)
    if stride_x < 1 or stride_y < 1:
        stride = s.get_int("stride", 1)
        stride_x = stride if stride_x < 1 else stride_x
        stride_y = stride if stride_y < 1 else stride_y
    dilation = s.get_int("dilation", 1)
    antialiasing = s.get_int("antialiasing", 0)
    if size == 1:
        dilation = 1
    pad_flag = s.get_int("pad", 0)
    padding = s.get_int("padding", 0)
    if pad_flag:
        padding = size // 2
    activation = normalize_activation(s.get_str("activation", "logistic"))

    share_index_rel = s.get_int("share_index", None)
    share_index = None
    if share_index_rel is not None:
        share_index = share_index_rel if share_index_rel >= 0 \
            else index + share_index_rel

    h, w, c = p["h"], p["w"], p["c"]
    if not (h and w and c):
        raise ValueError("Layer before convolutional layer must output image")
    if bool(s.get_int("xnor", 0)):
        groups = 1
    groups = max(groups, 1)
    # accepted no-op: XNOR binary output buffers (parser.cpp:196) have no
    # analogue on the MXU — the int8 path is the low-precision mode here
    s.get_int("bin_output", 0)

    blur_sx, blur_sy = stride_x, stride_y
    if antialiasing:
        stride_x = stride_y = 1

    out_h, out_w = conv_out_hw(h, w, size, stride_y, stride_x, padding)
    l = ConvIR(
        index=index, h=h, w=w, c=c, inputs=h * w * c,
        out_h=out_h, out_w=out_w, out_c=n, outputs=out_h * out_w * n,
        n=n, groups=groups, size=size, stride_x=stride_x, stride_y=stride_y,
        dilation=dilation, pad=padding, activation=activation,
        batch_normalize=bool(s.get_int("batch_normalize", 0)),
        binary=bool(s.get_int("binary", 0)),
        xnor=bool(s.get_int("xnor", 0)),
        antialiasing=antialiasing, blur_stride_x=blur_sx, blur_stride_y=blur_sy,
        share_index=share_index,
    )
    l.bflops = conv_bflops(l.nweights, out_h, out_w)
    s.get_float("angle", 15)  # parsed (rotation augment), mark as used
    return l


def _blur_out_hw(out_h: int, out_w: int, stride_y: int, stride_x: int,
                 antialiasing: int) -> tuple:
    """Antialias blur sublayer (convolutional_layer.cpp:744-801): a depthwise
    blur conv at the ORIGINAL stride — 3x3 binomial/16 pad 1 (antialiasing=1)
    or 2x2 box/4 pad 0 (antialiasing=2)."""
    if antialiasing == 2:
        return conv_out_hw(out_h, out_w, 2, stride_y, stride_x, 0)
    return conv_out_hw(out_h, out_w, 3, stride_y, stride_x, 1)


def _parse_maxpool(s: Section, p: dict, index: int) -> MaxpoolIR:
    stride = s.get_int("stride", 1)
    stride_x = s.get_int("stride_x", stride)
    stride_y = s.get_int("stride_y", stride)
    size = s.get_int("size", stride)
    padding = s.get_int("padding", size - 1)
    maxpool_depth = bool(s.get_int("maxpool_depth", 0))
    out_channels = s.get_int("out_channels", 1)
    antialiasing = s.get_int("antialiasing", 0)

    h, w, c = p["h"], p["w"], p["c"]
    if not (h and w and c):
        raise ValueError("Layer before [maxpool] layer must output image")

    blur_sx, blur_sy = stride_x, stride_y
    if antialiasing:
        stride_x = stride_y = 1

    if maxpool_depth:
        out_h, out_w, out_c = h, w, out_channels
    else:
        out_w = (w + padding - size) // stride_x + 1
        out_h = (h + padding - size) // stride_y + 1
        out_c = c
    return MaxpoolIR(
        index=index, h=h, w=w, c=c, inputs=h * w * c,
        out_h=out_h, out_w=out_w, out_c=out_c, outputs=out_h * out_w * out_c,
        size=size, stride_x=stride_x, stride_y=stride_y, pad=padding,
        maxpool_depth=maxpool_depth, out_channels=out_channels,
        antialiasing=antialiasing, blur_stride_x=blur_sx, blur_stride_y=blur_sy,
    )


def _parse_yolo_common(s: Section, l: YoloIR) -> None:
    """Options shared by [yolo] and [Gaussian_yolo]."""
    cpc = s.get_int_list("counters_per_class")
    if cpc is not None:
        if len(cpc) != l.classes:
            raise ValueError(
                f"counters_per_class has {len(cpc)} values, classes={l.classes}")
        mx = max(cpc)
        l.classes_multipliers = tuple(mx / c for c in cpc)
    l.label_smooth_eps = s.get_float("label_smooth_eps", 0.0)
    l.scale_x_y = s.get_float("scale_x_y", 1.0)
    l.max_delta = s.get_float("max_delta", float("inf"))
    l.iou_normalizer = s.get_float("iou_normalizer", 0.75)
    l.cls_normalizer = s.get_float("cls_normalizer", 1.0)
    iou_loss = s.get_str("iou_loss", "mse")
    l.iou_loss = iou_loss if iou_loss in ir.IOU_LOSSES else "iou"
    kind = s.get_str("iou_thresh_kind", "iou")
    l.iou_thresh_kind = kind if kind in ("iou", "giou", "diou", "ciou") else "iou"
    l.beta_nms = s.get_float("beta_nms", 0.6)
    nms_kind = s.get_str("nms_kind", "greedynms")
    l.nms_kind = nms_kind if nms_kind in ir.NMS_KINDS else "greedynms"
    l.jitter = s.get_float("jitter", 0.2)
    l.ignore_thresh = s.get_float("ignore_thresh", 0.5)
    l.truth_thresh = s.get_float("truth_thresh", 1.0)
    l.iou_thresh = s.get_float("iou_thresh", 1.0)
    l.random = s.get_float("random", 0.0)
    map_file = s.get_str("map")
    if map_file:
        # class-id remap file (read_map; one target id per line) — applied
        # to truth class ids in the loss (yolo_layer.cpp:497,673 l->map)
        try:
            with open(map_file) as f:
                l.class_map = tuple(int(x) for x in f.read().split())
        except OSError:
            import warnings

            warnings.warn(f"could not read map file {map_file}")


def _parse_yolo(s: Section, p: dict, index: int) -> YoloIR:
    classes = s.get_int("classes", 20)
    total = s.get_int("num", 1)
    mask = s.get_int_list("mask")
    mask = tuple(mask) if mask else tuple(range(total))
    max_boxes = s.get_int("max", 90)
    n = len(mask)

    h, w = p["h"], p["w"]
    c = n * (classes + 4 + 1)
    outputs = h * w * c
    l = YoloIR(
        index=index, h=h, w=w, c=c, inputs=outputs,
        out_h=h, out_w=w, out_c=c, outputs=outputs,
        classes=classes, total=total, mask=mask, max_boxes=max_boxes,
    )
    if l.outputs != p["inputs"]:
        raise ValueError(
            f"[yolo] layer {index}: filters= in the previous [convolutional] "
            f"({p['inputs']}) doesn't correspond to classes={classes}/"
            f"mask={mask} (expected {l.outputs})")
    _parse_yolo_common(s, l)
    l.focal_loss = bool(s.get_int("focal_loss", 0))
    anchors = s.get_float_list("anchors")
    if anchors:
        biases = [0.5] * (total * 2)
        for i, a in enumerate(anchors[: total * 2]):
            biases[i] = a
        l.anchors = tuple(biases)
    else:
        l.anchors = tuple([0.5] * (total * 2))
    return l


def _parse_gaussian_yolo(s: Section, p: dict, index: int) -> GaussianYoloIR:
    classes = s.get_int("classes", 20)
    max_boxes = s.get_int("max", 90)
    total = s.get_int("num", 1)
    mask = s.get_int_list("mask")
    mask = tuple(mask) if mask else tuple(range(total))
    n = len(mask)

    h, w = p["h"], p["w"]
    # 8 box channels: mu_x, sigma_x, mu_y, sigma_y, mu_w, sigma_w, mu_h, sigma_h
    c = n * (classes + 8 + 1)
    outputs = h * w * c
    l = GaussianYoloIR(
        index=index, h=h, w=w, c=c, inputs=outputs,
        out_h=h, out_w=w, out_c=c, outputs=outputs,
        classes=classes, total=total, mask=mask, max_boxes=max_boxes,
    )
    if l.outputs != p["inputs"]:
        raise ValueError(
            f"[Gaussian_yolo] layer {index}: filters mismatch "
            f"(expected {l.outputs}, got {p['inputs']})")
    _parse_yolo_common(s, l)
    l.uc_normalizer = s.get_float("uc_normalizer", 1.0)
    point = s.get_str("yolo_point", "center")
    l.yolo_point = point if point in ir.YOLO_POINTS else "center"
    anchors = s.get_float_list("anchors")
    if anchors:
        biases = [0.5] * (total * 2)
        for i, a in enumerate(anchors[: total * 2]):
            biases[i] = a
        l.anchors = tuple(biases)
    else:
        l.anchors = tuple([0.5] * (total * 2))
    return l


def _resolve_backref(i: int, index: int, kind: str) -> int:
    """Resolve a relative/absolute layer reference with bounds checking.

    The reference resolves `idx = params.index + idx` for negatives and
    indexes the layer array unchecked (parser.cpp:745-748, 837-843) —
    out-of-range references read out of bounds, and a too-negative value
    would (in Python) silently WRAP to a valid but wrong layer.  Fail
    loudly instead."""
    idx = i if i >= 0 else index + i
    if not 0 <= idx < index:
        raise ValueError(
            f"{kind} layer {index}: reference {i} resolves to layer {idx}, "
            f"outside the preceding layers [0, {index - 1}]")
    return idx


def _parse_route(s: Section, p: dict, index: int,
                 layers: list[LayerIR]) -> RouteIR:
    raw = s.get_int_list("layers")
    if raw is None:
        raise ValueError("Route Layer must specify input layers")
    idxs = tuple(_resolve_backref(i, index, "route") for i in raw)
    groups = s.get_int("groups", 1)
    group_id = s.get_int("group_id", 0)

    first = layers[idxs[0]]
    out_h, out_w, out_c = first.out_h, first.out_w, first.out_c
    for i in idxs[1:]:
        nxt = layers[i]
        if nxt.out_w == first.out_w and nxt.out_h == first.out_h:
            out_c += nxt.out_c
        else:
            warnings.warn("route: input layer sizes differ; output zeroed")
            out_h = out_w = out_c = 0
    out_c //= groups

    total_inputs = sum(layers[i].outputs for i in idxs)
    return RouteIR(
        index=index,
        h=first.h, w=first.w, c=out_c,
        inputs=total_inputs // groups,
        out_h=out_h, out_w=out_w, out_c=out_c,
        outputs=out_h * out_w * out_c,
        layers=idxs, groups=groups, group_id=group_id,
    )


def _parse_shortcut(s: Section, p: dict, index: int,
                    layers: list[LayerIR]) -> ShortcutIR:
    activation = normalize_activation(s.get_str("activation", "linear"))
    frm = s.get_str("from")
    if frm is None:
        raise ValueError("Shortcut layer must specify from = ...")
    idx = _resolve_backref(int(frm.split(",")[0]), index, "shortcut")
    src = layers[idx]
    if (src.out_w, src.out_h) != (p["w"], p["h"]):
        raise ValueError(
            f"shortcut layer {index}: spatial dims mismatch "
            f"({p['w']}x{p['h']} vs {src.out_w}x{src.out_h})")
    # channel mismatch is allowed: channel-prefix add, matching the
    # reference's GPU kernel semantics (ops/shapes.shortcut)
    h, w, c = p["h"], p["w"], p["c"]
    return ShortcutIR(
        index=index, h=h, w=w, c=c, inputs=h * w * c,
        out_h=h, out_w=w, out_c=c, outputs=h * w * c,
        from_layer=idx, activation=activation,
    )


def _parse_scale_channels(s: Section, p: dict, index: int,
                          layers: list[LayerIR]) -> ScaleChannelsIR:
    frm = s.get_str("from")
    if frm is None:
        raise ValueError("scale_channels must specify from = ...")
    idx = _resolve_backref(int(frm.split(",")[0]), index, "scale_channels")
    scale_wh = bool(s.get_int("scale_wh", 0))
    src = layers[idx]
    h, w, c = p["h"], p["w"], p["c"]
    if not scale_wh:
        if not (w == 1 and h == 1):
            raise ValueError("scale_channels (channel mode) expects a 1x1 gate")
        if src.out_c != c:
            raise ValueError("scale_channels: channel count mismatch")
    else:
        if c != 1:
            raise ValueError("scale_channels (scale_wh mode) expects c==1 gate")
        if (src.out_w, src.out_h) != (w, h):
            raise ValueError("scale_channels: spatial dims mismatch")
    activation = normalize_activation(s.get_str("activation", "linear"))
    if activation in ("swish", "mish"):
        # mirrors the reference's parse-time printf (parser.cpp:797-801)
        warnings.warn("[scale_channels] layer doesn't support SWISH or MISH")
    activation = _generic_path_activation(activation, "scale_channels")
    return ScaleChannelsIR(
        index=index, h=h, w=w, c=c, inputs=src.outputs,
        out_h=src.out_h, out_w=src.out_w, out_c=src.out_c,
        outputs=src.outputs,
        from_layer=idx, scale_wh=scale_wh, activation=activation,
    )


def _parse_dropout(s: Section, p: dict, index: int) -> DropoutIR:
    probability = s.get_float("probability", 0.2)
    dropblock = bool(s.get_int("dropblock", 0))
    size_rel = s.get_float("dropblock_size_rel", 0.0)
    size_abs = int(s.get_float("dropblock_size_abs", 0))
    if size_abs > p["w"] or size_abs > p["h"]:
        size_abs = min(p["w"], p["h"])
    if dropblock and not size_rel and not size_abs:
        size_abs = 7
    if size_rel and size_abs:
        size_rel = 0.0
    h, w, c = p["h"], p["w"], p["c"]
    return DropoutIR(
        index=index, h=h, w=w, c=c, inputs=p["inputs"],
        out_h=h, out_w=w, out_c=c, outputs=p["inputs"],
        probability=probability, dropblock=dropblock,
        dropblock_size_rel=size_rel, dropblock_size_abs=size_abs,
    )


# --------------------------------------------------------------------------
# Main builder
# --------------------------------------------------------------------------


def build_graph(cfg, train: bool = False) -> Graph:
    """Parse a cfg (path or text) into a Graph with inferred shapes."""
    if isinstance(cfg, str) and "\n" in cfg:
        sections = parse_cfg_text(cfg)
    elif isinstance(cfg, (list, tuple)):
        sections = list(cfg)
    else:
        sections = parse_cfg_file(cfg)

    if not sections:
        raise ValueError("Config file has no sections")
    if sections[0].type not in _NET_TYPES:
        raise ValueError("First section must be [net] or [network]")

    net = _parse_net_options(sections[0], train=train)
    p = {"h": net.h, "w": net.w, "c": net.c, "inputs": net.inputs}

    layers: list[LayerIR] = []
    for index, s in enumerate(sections[1:]):
        kind = _SECTION_KINDS.get(s.type, "blank")
        if kind == "convolutional":
            l = _parse_conv(s, p, index, layers)
        elif kind == "local":
            h, w, c = p["h"], p["w"], p["c"]
            if not (h and w and c):
                raise ValueError("Layer before local layer must output image")
            n = s.get_int("filters", 1)
            size = s.get_int("size", 1)
            stride = s.get_int("stride", 1)
            pad = s.get_int("pad", 0)
            activation = _generic_path_activation(normalize_activation(
                s.get_str("activation", "logistic")), "local")
            out_h = (h + 2 * pad - size) // stride + 1
            out_w = (w + 2 * pad - size) // stride + 1
            l = LocalIR(
                index=index, h=h, w=w, c=c, inputs=h * w * c,
                out_h=out_h, out_w=out_w, out_c=n, outputs=out_h * out_w * n,
                n=n, size=size, stride=stride, pad=pad, activation=activation,
            )
        elif kind == "activation":
            act = _generic_path_activation(normalize_activation(
                s.get_str("activation", "linear")), "activation")
            l = ActivationIR(
                index=index, h=p["h"], w=p["w"], c=p["c"], inputs=p["inputs"],
                out_h=p["h"], out_w=p["w"], out_c=p["c"], outputs=p["inputs"],
                activation=act,
            )
        elif kind == "connected":
            output = s.get_int("output", 1)
            act = _generic_path_activation(normalize_activation(
                s.get_str("activation", "logistic")), "connected")
            l = ConnectedIR(
                index=index, h=1, w=1, c=p["inputs"], inputs=p["inputs"],
                out_h=1, out_w=1, out_c=output, outputs=output,
                activation=act,
                batch_normalize=bool(s.get_int("batch_normalize", 0)),
            )
        elif kind == "crop":
            h, w, c = p["h"], p["w"], p["c"]
            crop_height = s.get_int("crop_height", 1)
            crop_width = s.get_int("crop_width", 1)
            l = CropIR(
                index=index, h=h, w=w, c=c, inputs=h * w * c,
                out_h=crop_height, out_w=crop_width, out_c=c,
                outputs=crop_height * crop_width * c,
                crop_height=crop_height, crop_width=crop_width,
                flip=bool(s.get_int("flip", 0)),
                angle=s.get_float("angle", 0.0),
                saturation=s.get_float("saturation", 1.0),
                exposure=s.get_float("exposure", 1.0),
                shift=s.get_float("shift", 0.0),
                noadjust=bool(s.get_int("noadjust", 0)),
            )
        elif kind == "cost":
            l = CostIR(
                index=index, h=p["h"], w=p["w"], c=p["c"], inputs=p["inputs"],
                out_h=p["h"], out_w=p["w"], out_c=p["c"], outputs=p["inputs"],
                cost_type=s.get_str("type", "sse"),
                cost_scale=s.get_float("scale", 1.0),
                ratio=s.get_float("ratio", 0.0),
            )
        elif kind == "yolo":
            l = _parse_yolo(s, p, index)
        elif kind == "gaussian_yolo":
            l = _parse_gaussian_yolo(s, p, index)
        elif kind == "detection":
            coords = s.get_int("coords", 1)
            classes = s.get_int("classes", 1)
            num = s.get_int("num", 1)
            side = s.get_int("side", 7)
            # layout: S*classes probs + S*num confs + S*num*coords boxes
            # (FillDetectionLayer asserts inputs match, detection_layer.cpp:27)
            outputs = side * side * ((1 + coords) * num + classes)
            if outputs != p["inputs"]:
                raise ValueError(
                    f"[detection] layer {index}: previous layer outputs "
                    f"{p['inputs']} != side^2*((1+coords)*num+classes) "
                    f"= {outputs}")
            l = DetectionIR(
                index=index, h=p["h"], w=p["w"], c=p["c"], inputs=p["inputs"],
                out_h=1, out_w=1, out_c=outputs, outputs=outputs,
                coords=coords, classes=classes,
                rescore=bool(s.get_int("rescore", 0)), num=num, side=side,
                sqrt=bool(s.get_int("sqrt", 0)),
                max_boxes=s.get_int("max", 30),
                coord_scale=s.get_float("coord_scale", 1.0),
                forced=bool(s.get_int("forced", 0)),
                object_scale=s.get_float("object_scale", 1.0),
                noobject_scale=s.get_float("noobject_scale", 1.0),
                class_scale=s.get_float("class_scale", 1.0),
                jitter=s.get_float("jitter", 0.2),
                random=s.get_float("random", 0.0),
                reorg=bool(s.get_int("reorg", 0)),
            )
        elif kind == "batchnorm":
            h, w, c = p["h"], p["w"], p["c"]
            l = BatchnormIR(
                index=index, h=h, w=w, c=c, inputs=h * w * c,
                out_h=h, out_w=w, out_c=c, outputs=h * w * c,
            )
        elif kind == "maxpool":
            l = _parse_maxpool(s, p, index)
        elif kind == "reorg":
            h, w, c = p["h"], p["w"], p["c"]
            stride = s.get_int("stride", 1)
            reverse = bool(s.get_int("reverse", 0))
            if reverse:
                out_h, out_w, out_c = h * stride, w * stride, c // (stride * stride)
            else:
                out_h, out_w, out_c = h // stride, w // stride, c * stride * stride
            l = ReorgIR(
                index=index, h=h, w=w, c=c, inputs=h * w * c,
                out_h=out_h, out_w=out_w, out_c=out_c,
                outputs=out_h * out_w * out_c, stride=stride, reverse=reverse,
            )
        elif kind == "reorg_old":
            h, w, c = p["h"], p["w"], p["c"]
            stride = s.get_int("stride", 1)
            reverse = bool(s.get_int("reverse", 0))
            if reverse:
                out_h, out_w, out_c = h * stride, w * stride, c // (stride * stride)
            else:
                out_h, out_w, out_c = h // stride, w // stride, c * stride * stride
            l = ReorgOldIR(
                index=index, h=h, w=w, c=c, inputs=h * w * c,
                out_h=out_h, out_w=out_w, out_c=out_c,
                outputs=out_h * out_w * out_c, stride=stride, reverse=reverse,
            )
        elif kind == "avgpool":
            h, w, c = p["h"], p["w"], p["c"]
            if not (h and w and c):
                raise ValueError("Layer before avgpool layer must output image")
            l = AvgpoolIR(
                index=index, h=h, w=w, c=c, inputs=h * w * c,
                out_h=1, out_w=1, out_c=c, outputs=c,
            )
        elif kind == "route":
            l = _parse_route(s, p, index, layers)
        elif kind == "upsample":
            stride = s.get_int("stride", 2)
            h, w, c = p["h"], p["w"], p["c"]
            # negative stride = reverse (block-sum downsample),
            # FillUpsampleLayer (upsample_layer.c:19-25)
            reverse = stride < 0
            if reverse:
                stride = -stride
                out_h, out_w = h // stride, w // stride
            else:
                out_h, out_w = h * stride, w * stride
            l = UpsampleIR(
                index=index, h=h, w=w, c=c, inputs=h * w * c,
                out_h=out_h, out_w=out_w, out_c=c,
                outputs=out_h * out_w * c,
                stride=stride, scale=s.get_float("scale", 1.0),
                reverse=reverse,
            )
        elif kind == "shortcut":
            l = _parse_shortcut(s, p, index, layers)
        elif kind == "scale_channels":
            l = _parse_scale_channels(s, p, index, layers)
        elif kind == "dropout":
            l = _parse_dropout(s, p, index)
        elif kind == "empty":
            l = EmptyIR(
                index=index, h=p["h"], w=p["w"], c=p["c"], inputs=p["inputs"],
                out_h=p["h"], out_w=p["w"], out_c=p["c"], outputs=p["inputs"],
            )
        else:
            warnings.warn(f"Type is not recognized: {s.type}")
            l = EmptyIR(
                index=index, h=p["h"], w=p["w"], c=p["c"], inputs=p["inputs"],
                out_h=p["h"], out_w=p["w"], out_c=p["c"], outputs=p["inputs"],
            )

        # per-layer generic flags (parser.cpp:1360-1369)
        l.clip = s.get_float("clip", 0.0)
        l.onlyforward = bool(s.get_int("onlyforward", 0))
        l.dont_update = s.get_int("dont_update", 0)
        l.burnin_update = s.get_int("burnin_update", 0)
        l.stopbackward = bool(s.get_int("stopbackward", 0))
        l.train_only_bn = bool(s.get_int("train_only_bn", 0))
        l.dontload = bool(s.get_int("dontload", 0))
        l.dontloadscales = bool(s.get_int("dontloadscales", 0))
        l.learning_rate_scale = s.get_float("learning_rate", 1.0)

        layers.append(l)

        # thread shape state (parser.cpp:1383-1398): antialiased layers
        # expose their blur sublayer's output dims downstream
        if getattr(l, "antialiasing", 0):
            bh, bw = _blur_out_hw(l.out_h, l.out_w,
                                  l.blur_stride_y, l.blur_stride_x,
                                  l.antialiasing)
            p = {"h": bh, "w": bw, "c": l.out_c, "inputs": bh * bw * l.out_c}
        else:
            p = {"h": l.out_h, "w": l.out_w, "c": l.out_c, "inputs": l.outputs}

    # train_only_bn propagates backwards (SetTrainOnlyBn, parser.cpp:1058-1071)
    flag = False
    for l in reversed(layers):
        if l.train_only_bn:
            flag = True
        if flag:
            l.train_only_bn = True

    # unused-key warnings, like the reference's UnusedOption sweep at the
    # end of every section parse (option_list.cpp:232, parser.cpp:1370) —
    # typos in a cfg surface instead of being silently ignored
    from darknet_tpu_torch.config.cfg import iter_unused_warnings

    for msg in iter_unused_warnings(sections):
        warnings.warn(msg)

    return Graph(net, layers)
