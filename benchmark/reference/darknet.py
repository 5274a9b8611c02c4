"""The plain reference of a darknet detector's serving program, in PyTorch.

It reads the cfg text itself, derives every layer's shape, folds batch
norm, quantizes what the configuration serves in int8, calibrates the
activation scales, runs the forward in float32 (TF32 off) and decodes
the heads into candidates.  It imports nothing of the program under test.

Layer kinds: [convolutional], [route], [shortcut], [maxpool],
[upsample], [yolo] and [Gaussian_yolo] (AlexeyAB darknet's semantics).
Tensors are NCHW inside and the candidates come out in the order (head,
row, column, anchor), which is the order the program ranks ties in.

`precision` of `forward`: "f32" plain; "int8" runs the convs that
`int8_convs` names on int8 operands (per-filter weight scales,
per-tensor activation scales, exact integer sums, the f32 dequant and
bias), the rest in f32; "int4" does the same on a grid of 7 instead of
127; "fp8" rounds every conv's operands to float8 e4m3 (per-tensor
activation and per-filter weight scales) and sums in f32.  The last two
are the controls: a precision below the one the configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ACTIVATIONS = ("linear", "leaky", "mish", "logistic", "relu")
HEADS = ("yolo", "gaussian_yolo")
# quantization grids: the largest integer of each precision's grid
GRID = {"int8": 127.0, "int4": 7.0}
FP8_MAX = 448.0                       # float8 e4m3's largest finite value


class Layer:
    """One cfg section with its shapes: `h, w, c` in, `out_h, out_w,
    out_c` out, and its own options as attributes."""

    def __init__(self, kind: str, index: int, opts: dict):
        self.kind = kind
        self.index = index
        self.opts = opts

    def get(self, key, default=None, cast=str):
        v = self.opts.get(key)
        return default if v is None else cast(v)

    def ints(self, key) -> list:
        v = self.opts.get(key)
        return [] if v is None else [int(t) for t in v.split(",") if t.strip()]

    def floats(self, key) -> list:
        v = self.opts.get(key)
        return [] if v is None else [float(t) for t in v.split(",")
                                     if t.strip()]


def parse_cfg(text: str) -> list:
    """[(section name lowercased, {key: value})] in file order."""
    sections = []
    for raw in text.splitlines():
        line = raw.split("#")[0].split(";")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            sections.append((line.strip("[]").strip().lower(), {}))
        elif "=" in line:
            k, v = line.split("=", 1)
            sections[-1][1][k.strip()] = v.strip()
    return sections


class Model:
    """The cfg as layers with shapes, the input size and the heads."""

    def __init__(self, text: str):
        sections = parse_cfg(text)
        if not sections or sections[0][0] not in ("net", "network"):
            raise ValueError("a cfg starts with [net]")
        net = sections[0][1]
        self.net_w, self.net_h = int(net["width"]), int(net["height"])
        self.net_c = int(net.get("channels", 3))
        self.layers: list = []
        h, w, c = self.net_h, self.net_w, self.net_c
        for i, (name, opts) in enumerate(sections[1:]):
            kind = "gaussian_yolo" if name == "gaussian_yolo" else name
            l = Layer(kind, i, opts)
            l.h, l.w, l.c = h, w, c
            self._shape(l)
            self.layers.append(l)
            h, w, c = l.out_h, l.out_w, l.out_c
        self.heads = [l for l in self.layers if l.kind in HEADS]
        self.live = {s for l in self.layers for s in getattr(l, "srcs", ())}

    def _ref(self, l, v: int) -> int:
        j = l.index + v if v < 0 else v
        if not 0 <= j < l.index:
            raise ValueError(f"layer {l.index}: bad reference {v}")
        return j

    def _shape(self, l) -> None:
        k = l.kind
        if k == "convolutional":
            l.n = l.get("filters", 1, int)
            l.size = l.get("size", 1, int)
            l.stride = l.get("stride", 1, int)
            l.groups = l.get("groups", 1, int)
            l.padding = l.size // 2 if l.get("pad", 0, int) else \
                l.get("padding", 0, int)
            l.bn = bool(l.get("batch_normalize", 0, int))
            l.act = l.get("activation", "logistic")
            if l.act not in ACTIVATIONS:
                raise NotImplementedError(f"activation {l.act}")
            l.out_h = (l.h + 2 * l.padding - l.size) // l.stride + 1
            l.out_w = (l.w + 2 * l.padding - l.size) // l.stride + 1
            l.out_c = l.n
        elif k == "route":
            l.srcs = [self._ref(l, v) for v in l.ints("layers")]
            if l.get("groups", 1, int) != 1:
                raise NotImplementedError("route groups")
            first = self.layers[l.srcs[0]]
            l.out_h, l.out_w = first.out_h, first.out_w
            l.out_c = sum(self.layers[s].out_c for s in l.srcs)
        elif k == "shortcut":
            l.srcs = [self._ref(l, v) for v in l.ints("from")]
            l.act = l.get("activation", "linear")
            l.out_h, l.out_w, l.out_c = l.h, l.w, l.c
        elif k == "maxpool":
            l.stride = l.get("stride", 1, int)
            l.size = l.get("size", l.stride, int)
            l.padding = l.get("padding", l.size - 1, int)
            l.out_h = (l.h + l.padding - l.size) // l.stride + 1
            l.out_w = (l.w + l.padding - l.size) // l.stride + 1
            l.out_c = l.c
        elif k == "upsample":
            l.stride = l.get("stride", 2, int)
            l.out_h, l.out_w, l.out_c = l.h * l.stride, l.w * l.stride, l.c
        elif k in HEADS:
            l.classes = l.get("classes", 20, int)
            total = l.get("num", 1, int)
            l.mask = l.ints("mask") or list(range(total))
            a = l.floats("anchors")
            l.anchors = [(a[2 * m], a[2 * m + 1]) for m in l.mask]
            l.scale_x_y = l.get("scale_x_y", 1.0, float)
            l.point = l.get("yolo_point", "center")
            l.entries = (9 if k == "gaussian_yolo" else 5) + l.classes
            if l.c != len(l.mask) * l.entries:
                raise ValueError(f"head {l.index}: {l.c} channels")
            l.out_h, l.out_w, l.out_c = l.h, l.w, l.c
        else:
            raise NotImplementedError(f"layer kind [{k}]")

    def convs(self) -> list:
        return [l for l in self.layers if l.kind == "convolutional"]

    def int8_convs(self, min_ch: int = 128) -> set:
        """The convs served in int8: ungrouped, at least `min_ch` wide on
        both sides, and not feeding a head."""
        head_in = {h.index - 1 for h in self.heads}
        return {l.index for l in self.convs() if l.groups == 1
                and min(l.c, l.n) >= min_ch and l.index not in head_in}


def fold(model: Model, raw: dict) -> dict:
    """{conv index: {"w" (n,c,k,k), "b"}} with batch norm folded in f32:
    w * (scales / std), b - scales * mean / std, std = sqrt(var + 1e-5)."""
    out = {}
    for l in model.convs():
        p = raw[l.index]
        if l.bn:
            std = torch.sqrt(p["var"] + 1e-5)
            out[l.index] = {"w": p["w"] * (p["scales"] / std)[:, None, None,
                                                               None],
                            "b": p["b"] - p["scales"] * p["mean"] / std}
        else:
            out[l.index] = {"w": p["w"], "b": p["b"]}
    return out


def quantize_weights(folded: dict, which, grid: float) -> dict:
    """{index: (w_q as float integers, w_scale (n,))}: per-filter
    symmetric absmax over the grid, round half to even."""
    out = {}
    for i in which:
        w = folded[i]["w"]
        absmax = torch.clamp_min(w.abs().flatten(1).amax(1), 1e-8)
        scale = absmax / torch.tensor(grid, device=w.device)
        q = torch.clamp(torch.round(w / scale[:, None, None, None]),
                        -grid, grid)
        out[i] = (q, scale)
    return out


def activate(x, act: str):
    if act == "linear":
        return x
    if act == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if act == "relu":
        return torch.clamp_min(x, 0)
    if act == "logistic":
        return torch.sigmoid(x)
    # mish with darknet's softplus threshold of 20
    return x * torch.tanh(torch.where(x > 20, x, F.softplus(x)))


def _fp8(t, scale):
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """What the forward reads: the folded convs and, for a quantized
    precision, the quantized weights and the calibrated activation
    scales ({index: x_scale}; absent: the batch's own absmax)."""

    def __init__(self, model: Model, raw: dict, precision: str = "f32",
                 quantized=()):
        self.model = model
        self.precision = precision
        self.folded = fold(model, raw)
        self.quantized = set(quantized) if precision in GRID else set()
        self.q = quantize_weights(self.folded, self.quantized,
                                  GRID[precision]) \
            if self.quantized else {}
        self.x_scale: dict = {}

    def calibrate(self, batches) -> None:
        """Per-tensor activation scales of the quantized convs: max|input|
        over `batches` (NHWC float32 tensors in [0, 1]), in a forward whose
        quantized convs take each batch's own scale, then absmax / grid."""
        absmax: dict = {}
        for x in batches:
            forward(self, x, probe=absmax)
        grid = GRID[self.precision]
        self.x_scale = {i: torch.clamp_min(v, 1e-8) / grid
                        for i, v in absmax.items()}


def _conv(wts: Weights, l, x, probe):
    p = wts.folded[l.index]
    if l.index in wts.quantized:
        if probe is not None:
            probe[l.index] = torch.maximum(
                probe.get(l.index, torch.zeros((), device=x.device)),
                x.abs().amax())
        grid = GRID[wts.precision]
        xs = wts.x_scale.get(l.index)
        if xs is None:
            xs = torch.clamp_min(x.abs().amax(), 1e-8) / grid
        xq = torch.clamp(torch.round(x / xs), -grid, grid)
        wq, ws = wts.q[l.index]
        y = F.conv2d(xq, wq, None, l.stride, l.padding, 1, l.groups)
        return y * (xs * ws)[None, :, None, None] + p["b"][None, :, None,
                                                            None]
    w = p["w"]
    if wts.precision == "fp8":
        xs = torch.clamp_min(x.abs().amax(), 1e-12) / FP8_MAX
        ws = torch.clamp_min(w.abs().flatten(1).amax(1), 1e-12) / FP8_MAX
        x = _fp8(x, xs)
        w = _fp8(w, ws[:, None, None, None])
    return F.conv2d(x, w, p["b"], l.stride, l.padding, 1, l.groups)


def forward(wts: Weights, x, probe=None) -> list:
    """NHWC float32 frames in [0, 1] -> the raw head tensors, NCHW."""
    return walk(wts.model, x,
                lambda l, y: activate(_conv(wts, l, y, probe), l.act))


def walk(model: Model, x, conv) -> list:
    """Run the layers on NHWC frames, each conv as `conv(layer, NCHW
    input)`; the raw head tensors, NCHW."""
    prev = tf32_off()
    try:
        cur = x.permute(0, 3, 1, 2).contiguous()
        outs, heads = {}, []
        for l in model.layers:
            k = l.kind
            if k == "convolutional":
                cur = conv(l, cur)
            elif k == "route":
                parts = [outs[s] for s in l.srcs]
                cur = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
            elif k == "shortcut":
                cur = activate(cur + outs[l.srcs[0]], l.act)
            elif k == "maxpool":
                lo = l.padding // 2
                hi = l.padding - lo
                y = F.pad(cur, (lo, hi, lo, hi), value=-math.inf)
                cur = F.max_pool2d(y, l.size, l.stride)[..., :l.out_h,
                                                         :l.out_w]
            elif k == "upsample":
                cur = cur.repeat_interleave(l.stride, 2).repeat_interleave(
                    l.stride, 3)
            else:
                heads.append(cur)
            if l.index in model.live:
                outs[l.index] = cur
        return heads
    finally:
        tf32_restore(prev)


def tf32_off():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return prev


def tf32_restore(prev) -> None:
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


def decode(model: Model, heads: list) -> tuple:
    """Raw heads -> candidates (boxes (B,N,4) relative centre-format,
    obj (B,N), cls (B,N,classes)); a Gaussian head's class scores are
    scaled by 1 - mean(sigmas)."""
    boxes, objs, clss = [], [], []
    for l, t in zip(model.heads, heads):
        b, _c, h, w = t.shape
        a = len(l.mask)
        v = t.float().reshape(b, a, l.entries, h, w).permute(0, 3, 4, 1, 2)
        dev = t.device
        col = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :,
                                                                None]
        row = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None,
                                                                None]
        anc = torch.tensor(l.anchors, device=dev, dtype=torch.float32)
        aw, ah = anc[:, 0], anc[:, 1]
        s = l.scale_x_y
        if l.kind == "yolo":
            x, y = torch.sigmoid(v[..., 0]), torch.sigmoid(v[..., 1])
            tw, th = v[..., 2], v[..., 3]
            obj = torch.sigmoid(v[..., 4])
            cls = torch.sigmoid(v[..., 5:])
        else:
            x, y = torch.sigmoid(v[..., 0]), torch.sigmoid(v[..., 2])
            tw, th = v[..., 4], v[..., 6]
            sig = torch.sigmoid(v[..., 1:8:2])
            obj = torch.sigmoid(v[..., 8])
            cls = torch.sigmoid(v[..., 9:]) * (1.0 - sig.mean(-1,
                                                              keepdim=True))
        if s != 1.0:
            x = x * s - 0.5 * (s - 1.0)
            y = y * s - 0.5 * (s - 1.0)
        bw = torch.exp(tw) * aw / model.net_w
        bh = torch.exp(th) * ah / model.net_h
        bx = (col + x) / w
        by = (row + y) / h
        if l.point == "left_top":
            bx, by = bx + bw / 2, by + bh / 2
        elif l.point == "right_bottom":
            bx, by = bx - bw / 2, by - bh / 2
        boxes.append(torch.stack([bx, by, bw, bh], -1).reshape(b, -1, 4))
        objs.append(obj.reshape(b, -1))
        clss.append(cls.reshape(b, -1, l.classes))
    return torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(clss, 1)


def grid_sizes(model: Model, device) -> torch.Tensor:
    """(N, 2): the (width, height) of the grid that each candidate's head
    decodes on, in the candidates' order."""
    return torch.cat([torch.tensor([[float(l.w), float(l.h)]]).expand(
        l.h * l.w * len(l.mask), 2) for l in model.heads]).to(device)
