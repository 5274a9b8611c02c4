"""Per-shape times of the int8 conv kernel on one CUDA card: each distinct
quantized conv of yolov4-608 at b=8 (91 convs, 24 shapes), the kernel
(`ops/quant_matmul.int8_conv`, bf16 out) against torch._int_mm (int32
out) on the explicit im2col of the same operands, and the shape's bound.

    python3 chip_int8_shapes.py

Times are device times: each call captured in a CUDA graph and replayed
(no host launch time).  Operands are seeded random int8; the card's name
and power limit head the output.
"""

from __future__ import annotations

import collections
import subprocess
import sys
import warnings

import numpy as np

BATCH, PX = 8, 608
PEAK_INT8, PEAK_BYTES = 1979e12, 3.35e12


def graph_ms(fn, reps=20) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_int8_shapes: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("card", card, flush=True)

    from darknet_tpu_torch import model_zoo
    from darknet_tpu_torch.graph.builder import build_graph
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.conv import darknet_conv_padding

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.yolov4_cfg(PX, PX))
    heads = {l.index - 1 for l in g.layers if l.kind == "yolo"}
    shapes = collections.Counter(
        (l.size, l.stride_x, l.h, l.w, l.c, l.n, l.pad, l.out_h, l.out_w)
        for l in g.layers if l.kind == "convolutional" and l.groups == 1
        and min(l.c, l.n) >= 128 and l.index not in heads)
    rng = np.random.default_rng(0)
    dev = "cuda"
    tot = collections.Counter()
    print("size stride H C N count | M K | kernel_ms int_mm_ms bound_ms "
          "(per conv)", flush=True)
    for (size, s, h, w, c, n, pad, oh, ow), count in sorted(shapes.items()):
        x_q = torch.from_numpy(rng.integers(-127, 128, (BATCH, h, w, c),
                                            dtype=np.int8)).to(dev)
        w_q = torch.from_numpy(rng.integers(-127, 128, (n, size * size * c),
                                            dtype=np.int8)).to(dev)
        ws = torch.full((n,), 1e-3, device=dev)
        bias = torch.zeros(n, device=dev)
        xs = torch.tensor([0.01], device=dev)
        padding = darknet_conv_padding(size, pad, 1, (h, w), (s, s), (oh, ow))
        kw = dict(size=size, stride=(s, s), padding=padding, out_hw=(oh, ow))
        a = qm.im2col_int8(x_q, size, size, (s, s), padding, (oh, ow))
        wt = w_q.t()
        k_ms = graph_ms(lambda: qm.int8_conv(x_q, w_q, ws, bias, xs,
                                             out_dtype=torch.bfloat16, **kw))
        l_ms = graph_ms(lambda: torch._int_mm(a, wt))
        m, k = a.shape
        nbytes = x_q.numel() + w_q.numel() + 8 * n + m * n * 2
        bound = 1e3 * max(2 * m * n * k / PEAK_INT8, nbytes / PEAK_BYTES)
        tot["kernel"] += count * k_ms
        tot["int_mm"] += count * l_ms
        tot["bound"] += count * bound
        print(f"{size} {s} {h} {c} {n} x{count} | {m} {k} | {k_ms:.4f} "
              f"{l_ms:.4f} {bound:.4f}", flush=True)
        del x_q, w_q, a, wt
    print(f"sum over the 91 convs: kernel {tot['kernel']:.3f} ms, "
          f"torch._int_mm {tot['int_mm']:.3f} ms, bound {tot['bound']:.3f} "
          f"ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
