"""The region ranges' share of their roofline: the useful operations of
the layers each `L###-###_region` range covers, from the cfg's shapes,
and its bytes (the region's input read once in f32 where it is the
frames, else bf16; bf16 weights; the bf16 output written once), at the
published bf16 and memory peaks; over the device time of every kernel
launched under those ranges.  A later kernel or a wider region changes
the range's name, and so the work counted with it."""

import re

from benchmark import flops

LAYER = "region kernel"
UNIT = "%"
MOVES = "serve_img_s"
REGION = re.compile(r"^L\d{3}-\d{3}_region$")


def least_s(model, a: int, b: int, batch: int, peak: dict) -> float:
    layers = model.layers[a:b + 1]
    convs = [l for l in layers if l.kind == "convolutional"]
    ops = sum(2 * flops.conv_macs(l) for l in convs) * batch
    first, last = layers[0], layers[-1]
    nbytes = (batch * first.h * first.w * first.c * (4 if a == 0 else 2)
              + sum(l.n * (l.c // l.groups) * l.size * l.size for l in convs)
              * 2 + batch * last.out_h * last.out_w * last.out_c * 2)
    return max(ops / peak["bf16_flops_s"], nbytes / peak["hbm_bytes_s"])


def read(record):
    tr, peak = record.get("trace"), record.get("peaks")
    if not tr or not peak:
        return None
    time_us, scopes = 0.0, set()
    for _n, s, t, scope in tr["kernels"]:
        if scope and REGION.match(scope):
            time_us += t - s
            scopes.add(scope)
    if not time_us:
        return None
    batch = record["traffic"]["batch"]
    least = sum(least_s(record["model"], *flops.scope_layers(sc), batch, peak)
                for sc in scopes) * tr["requests"]
    return 100.0 * least / (time_us / 1e6)
