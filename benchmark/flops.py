"""Operations and bytes of a detector's layers, from the cfg's shapes
(`reference/darknet.Model`), and the card's published peaks.

Useful work only: a conv's multiply-adds are out_h * out_w * n *
size * size * c / groups an image, with no halo, padding or tile that an
implementation may compute besides.  A byte count reads each input and
weight once and writes each output once.
"""

from __future__ import annotations

import json
import os
import re

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")
# a profiler range the forward opens around a layer or a fused region
SCOPE = re.compile(r"^L(\d{3})(?:-(\d{3}))?_\w+$")


def peaks(kind: str) -> dict:
    """The published peaks of the card named `kind`
    (`torch.cuda.get_device_name()`), matched by the table's key."""
    with open(PEAKS) as f:
        table = json.load(f)
    for key, row in table.items():
        if key in kind:
            return row
    raise KeyError(f"no peaks for {kind!r} in {PEAKS}")


def conv_macs(l) -> int:
    """Multiply-adds of one image through conv `l`."""
    return l.out_h * l.out_w * l.n * l.size * l.size * (l.c // l.groups)


def conv_bytes(l, batch: int, x_bytes: int, w_bytes: int,
               y_bytes: int) -> int:
    return (batch * l.h * l.w * l.c * x_bytes
            + l.n * (l.c // l.groups) * l.size * l.size * w_bytes
            + batch * l.out_h * l.out_w * l.n * y_bytes)


def scope_layers(name: str):
    """(first, last) layer of a forward's range name, or None."""
    m = SCOPE.match(name)
    if m is None:
        return None
    a = int(m.group(1))
    return a, int(m.group(2)) if m.group(2) else a


def forward_least_s(model, int8=(), *, peak: dict) -> float:
    """The least seconds one image's convs take at the published dense
    peaks: int8 convs at the int8 rate, the others at bf16's."""
    t = 0.0
    for l in model.convs():
        rate = peak["int8_ops_s"] if l.index in int8 else peak["bf16_flops_s"]
        t += 2 * conv_macs(l) / rate
    return t
