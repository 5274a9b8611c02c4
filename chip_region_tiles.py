"""The bf16 region kernel's tile and block size on one CUDA card: the
tensor-core kernel (`csrc/fused_region.cu`, region_tc_kernel) on
yolov4-608's region prefix at b=8, for each (tile, threads) candidate
that fits shared memory, checked against the plain version and timed.

    python3 chip_region_tiles.py

Per candidate: shared memory per block, the blocks per SM that it
allows, the multiply-adds executed (halo and padding included) against
the useful ones, the max abs error against the plain version (one bf16
ulp of the scale allowed) with the share of elements that differ, and
the kernel's time by CUDA events over 10 launches, in two rounds (the
candidates in order, then in reverse).  The card's name and power limit
head the output.
"""

from __future__ import annotations

import subprocess
import sys
import warnings

import numpy as np

BATCH, PX = 8, 608
CANDIDATES = ((12, 256), (12, 512), (16, 256), (16, 512), (18, 512),
              (14, 512), (8, 256), (24, 512))
SMEM_SM = 228 * 1024          # shared memory of one SM, 1 KB per block kept


def cuda_ms(fn, iters=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_region_tiles: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("card", card, flush=True)

    from darknet_tpu_torch import model_zoo
    from darknet_tpu_torch.graph.builder import build_graph
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import fused_region as fr
    from darknet_tpu_torch.ops.cuda import build
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    build.load("fused_region")
    log = build.build_log["fused_region"]
    print(f"built fused_region in {log['seconds']:.2f} s", flush=True)
    print(log["ptxas"].strip(), flush=True)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.yolov4_cfg(PX, PX))
    npar = paramlib.fuse_conv_batchnorm(g, paramlib.init_params(g, seed=0))
    tp = paramlib.params_to_torch(g, npar, "cuda", torch.bfloat16)
    sub, _k = fr.hybrid_prefix(fr.plan_graph_regions(g, stem=True)[0])
    ws, bs = fr.step_weights(sub.steps, tp, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (BATCH, PX, PX, 3)).astype(np.float32)).to("cuda")
    useful = BATCH * sub.h * 2 * sub.w2 * sum(
        st.kh * st.kw * st.c_tot * st.n for st in sub.conv_steps)
    with torch.inference_mode():
        want = fr.region_plain(sub, x, ws, bs,
                               compute_dtype=torch.bfloat16).float()
    scale = float(want.abs().max())

    fits = {}
    for tile, threads in CANDIDATES:
        try:
            kp = kfr.tc_kernel_plan(sub, tile, threads)
        except ValueError as e:
            print(f"tile {tile} threads {threads}: {e}", flush=True)
            continue
        wbuf, bbuf = kfr.pack_weights(kp, ws, bs, torch.bfloat16)
        fits[tile, threads] = (kp, torch.from_numpy(kp.table).to("cuda"),
                               wbuf, bbuf)
    xb = x.to(torch.bfloat16)

    def run(key):
        return kfr.launch(*fits[key], xb, sub.out_c)

    times = {}
    with torch.inference_mode():
        for rnd in (list(fits), list(fits)[::-1]):
            for key in rnd:
                times.setdefault(key, []).append(cuda_ms(lambda: run(key)))
        print("tile threads smem_B blocks/SM(smem) executed/useful MACs "
              "max_abs_err/scale differing_share ms (two rounds)", flush=True)
        for (tile, threads), (kp, *_rest) in fits.items():
            got = run((tile, threads)).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            share = float((got != want).float().mean())
            per_sm = min(SMEM_SM // (kp.smem_bytes + 1024), 2048 // threads)
            executed = kp.macs_per_tile * kp.tiles_y * kp.tiles_x * BATCH
            t = times[(tile, threads)]
            print(f"{tile} {threads} {kp.smem_bytes} {per_sm} "
                  f"{executed / useful:.4f} {err / scale:.3e} {share:.3e} "
                  f"{t[0]:.3f} {t[1]:.3f} [{card}]", flush=True)
            if not (bool(torch.isfinite(got).all())
                    and err <= 2.0 ** -7 * scale):
                print(f"tile {tile} threads {threads}: disagrees with the "
                      f"plain version", flush=True)
                return 1
    print(f"useful {useful / 1e9:.3f} GMAC; scale {scale}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
