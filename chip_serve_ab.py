"""Eager serving rates of yolov4-608 at b=8, bf16 and calibrated int8, of
one tree of the port, for comparing two trees in turns on one CUDA card.

    python3 chip_serve_ab.py [--tree DIR] [--windows 3] [--requests 20]

imports `darknet_tpu_torch` from DIR (default: the directory of this
script), builds its kernels there, makes both networks from one seed
(the same weights, frames and calibration in every tree), and times
whole requests (`submit_detect_device`, then the detections on the
host) with the host clock around synchronised work: `--windows` windows
of `--requests` requests each dtype, the dtypes in turns.  It prints the
card's name and power limit, then one JSON line: the tree, the rates of
each window (img/s) and each dtype's kernel launches a request.  To
compare two trees, run it on each in turns (A, B, B, A) in one session
on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

BATCH, PX, SEED, CALIB_FRAMES, WARMUP = 8, 608, 12, 4, 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--requests", type=int, default=20)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("chip_serve_ab: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)

    import darknet_tpu_torch
    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import build
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    if os.path.dirname(os.path.dirname(
            os.path.abspath(darknet_tpu_torch.__file__))) != tree:
        raise RuntimeError(f"darknet_tpu_torch came from "
                           f"{darknet_tpu_torch.__file__}, not {tree}")
    build.build(("fused_region", "int8_gemm"))
    rng = np.random.default_rng(SEED)
    frames = rng.uniform(0, 1, (BATCH, PX, PX, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as root, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = os.path.join(root, "yolov4.cfg")
        with open(cfg, "w") as f:
            f.write(model_zoo.yolov4_cfg(PX, PX))
        nets = {"bf16": Network.from_cfg(cfg, compute_dtype=torch.bfloat16,
                                         seed=SEED, device="cuda"),
                "int8": Network.from_cfg(cfg, int8=True,
                                         compute_dtype=torch.bfloat16,
                                         seed=SEED, device="cuda")}
    nets["int8"].calibrate_int8([
        rng.uniform(0, 1, (PX, PX, 3)).astype(np.float32)
        for _ in range(CALIB_FRAMES)])

    def request(net):
        net.device_out_to_dets(*net.submit_detect_device(frames))

    per_request = {}
    for label, net in nets.items():
        for _ in range(WARMUP):
            request(net)
        torch.cuda.synchronize()
        kfr.launches, qm.launches = 0, 0
        request(net)
        torch.cuda.synchronize()
        per_request[label] = {"region": kfr.launches, "int8": qm.launches}
    rates: dict = {label: [] for label in nets}
    for _ in range(args.windows):
        for label, net in nets.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.requests):
                request(net)
            torch.cuda.synchronize()
            rates[label].append(args.requests * BATCH
                                / (time.perf_counter() - t0))
    print(json.dumps({"tree": tree, "img_s": rates,
                      "launches_a_request": per_request,
                      "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
