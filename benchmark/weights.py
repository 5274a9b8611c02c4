"""Random darknet weights from the seed, made on the device, and the
`.weights` file the program loads them from.

Every conv draws darknet's own init (scale sqrt(2 / (size*size*c/groups))
times U(-1, 1)); batch norm draws its scales from U(0.75, 1.25), its
rolling variances from U(0.5, 1.5) and its rolling means and biases from
U(-1, 1), all in one call to the generator.  One pass over camera-like
frames of the seed (`images.py`; `frames` of them, 8 by default) then
scales each layer as a whole, so that every layer's output spreads with
`bn_scale` and its means and biases are `bias` of that: the signal
neither fades nor grows with depth, and no channel of the trunk is
divided by its own spread, which on a few frames would magnify rounding
by thousands.  Each channel of a conv that feeds a head is then set to
spread as a trained detector's scores spread, with `head_std` (box sizes
`wh_std`) around 0 (box centres and sizes), `sigma_mean`, `obj_mean`
and `cls_mean`, rather than all at sigmoid(0), the same for every seed.  The recipe's
numbers are the configuration's (`weights` in its file).
"""

from __future__ import annotations

import struct

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import images
from benchmark.reference import darknet

# the .weights header: major, minor, revision, then `seen` as uint64
VERSION = (0, 2, 5)


def make(model, recipe: dict, seed: int, device) -> dict:
    """{conv index: {"w" (n,c,k,k), "b", and "scales", "mean", "var" with
    batch norm}} as float32 tensors on `device`."""
    convs = model.convs()
    sizes = [(l.n * (l.c // l.groups) * l.size * l.size, l.n,
              3 * l.n if l.bn else 0) for l in convs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(map(sum, sizes)), generator=gen, device=device)
    raw, off = {}, 0
    for l, (nw, nb, nbn) in zip(convs, sizes):
        fan = l.size * l.size * (l.c // l.groups)
        w = (u[off:off + nw] * 2 - 1).mul_(np.sqrt(2.0 / fan)).reshape(
            l.n, l.c // l.groups, l.size, l.size)
        off += nw
        # U(-1, 1) for now: the pass below scales it to the layer
        p = {"w": w, "b": u[off:off + nb] * 2 - 1}
        off += nb
        if l.bn:
            s = u[off:off + nbn].reshape(3, l.n)
            off += nbn
            p["scales"] = 0.75 + 0.5 * s[0]
            p["mean"] = (s[1] * 2 - 1)
            p["var"] = 0.5 + s[2]
        raw[l.index] = p
    frames = images.frames(int(recipe.get("frames", 8)), model.net_h,
                           model.net_w, model.net_c, gen, device).float() / 255
    _set_scales(model, raw, recipe, frames)
    return raw


def _roles(head) -> dict:
    """{role: the entries of an anchor it covers} of a head."""
    if head.kind == "gaussian_yolo":
        return {"xy": (0, 2), "wh": (4, 6), "sigma": (1, 3, 5, 7),
                "obj": (8,), "cls": tuple(range(9, head.entries))}
    return {"xy": (0, 1), "wh": (2, 3), "obj": (4,),
            "cls": tuple(range(5, head.entries))}


def _set_scales(model, raw: dict, recipe: dict, frames) -> None:
    """One pass over the frames: each batch-norm conv's scales take the
    factor that brings its output to `bn_scale` over the whole layer, its
    rolling means and biases that many times `bias` x U(-1, 1); each
    channel of a head conv the scale and bias that spread it as the
    recipe says for its role (box centres, sizes, sigmas, objectness,
    classes)."""
    feeds = {h.index - 1: h for h in model.heads}
    bn_scale = float(recipe.get("bn_scale", 1.0))
    bias = float(recipe.get("bias", 0.0))
    target = {"xy": (recipe["head_std"], 0.0),
              "wh": (recipe["wh_std"], 0.0),
              "sigma": (recipe["head_std"], recipe.get("sigma_mean", 0.0)),
              "obj": (recipe["head_std"], recipe["obj_mean"]),
              "cls": (recipe["head_std"], recipe["cls_mean"])}

    def conv(l, x):
        p = raw[l.index]
        y = F.conv2d(x, p["w"], None, l.stride, l.padding, 1, l.groups)
        if l.bn:
            fold = 1.0 / torch.sqrt(p["var"] + 1e-5)
            spread = float((y * fold[:, None, None]).std())
            p["scales"] = p["scales"] * bn_scale / spread
            p["mean"] = p["mean"] * bias * spread
            p["b"] = p["b"] * bias * bn_scale
            std = torch.sqrt(p["var"] + 1e-5)
            y = (y - p["mean"][:, None, None]) * (
                p["scales"] / std)[:, None, None] + p["b"][:, None, None]
        elif l.index in feeds:
            # each channel of a head conv to its role's spread and centre
            head = feeds[l.index]
            e, n = head.entries, len(head.mask)
            std = torch.zeros(l.n, device=y.device)
            mean = torch.zeros(l.n, device=y.device)
            for role, entries in _roles(head).items():
                idx = [a * e + k for a in range(n) for k in entries]
                std[idx], mean[idx] = (float(v) for v in target[role])
            gain = std / y.std((0, 2, 3)).clamp_min(1e-12)
            p["w"] = p["w"] * gain[:, None, None, None]
            p["b"] = mean - y.mean((0, 2, 3)) * gain
            y = y * gain[:, None, None] + p["b"][:, None, None]
        else:
            p["b"] = p["b"] * bias * float(y.std())
            y = y + p["b"][:, None, None]
        return darknet.activate(y, l.act)

    with torch.no_grad():
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            darknet.walk(model, frames, conv)
        finally:
            torch.backends.cudnn.deterministic = deterministic


def write(model, raw: dict, path: str) -> None:
    """darknet's `.weights` layout: the header, then per conv its biases,
    [scales, rolling mean, rolling variance], and weights (n, c, kh, kw),
    float32 little-endian."""
    with open(path, "wb") as f:
        f.write(struct.pack("<iiiQ", *VERSION, 0))
        for l in model.convs():
            p = raw[l.index]
            keys = ["b"] + (["scales", "mean", "var"] if l.bn else []) + ["w"]
            for k in keys:
                f.write(p[k].detach().float().cpu().numpy().astype(
                    "<f4").tobytes())


def to_device(raw: dict, device) -> dict:
    return {i: {k: v.to(device) for k, v in p.items()}
            for i, p in raw.items()}
