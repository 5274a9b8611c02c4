"""Serving: batches of uint8 frames through `Network.submit_detect_device`,
each request's triple (boxes, objectness, probs) read back to the host.

Set-up writes the seed's weights as a `.weights` file under TMPDIR and
loads them the way a user does (`Network.from_cfg`), calibrates int8 on
the seed's frames where the configuration serves int8, and warms up on
the traffic's own batches.  The window is a closed loop (`traffic.py`).
After it, a `--trace 1` run profiles a few more requests twice (the
CUDA activity alone for the device's busy time, then with the host's
ranges too); then the program is freed and the reference recomputes a
sample of the window's requests from the same weights and frames
(`reference/`), and the comparison decides `correct`
(`reference/compare.py`).
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np
import torch

from benchmark import flops, harness
from benchmark import trace as tracing
from benchmark import traffic as gen
from benchmark import weights as wgen
from benchmark.reference import compare, darknet, postprocess

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CHUNK = 8            # images a reference forward takes at once


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def inputs(ctx, model):
    """The seed's weights (on the host), frame batches and int8
    calibration frames (None without int8)."""
    s_w, s_f, s_c = harness.streams(ctx.seed, 3)
    raw = wgen.make(model, ctx.config["weights"], s_w, ctx.device)
    raw = {i: {k: v.cpu() for k, v in p.items()} for i, p in raw.items()}
    batches = gen.pool(ctx.traffic, model, s_f, ctx.device)
    int8 = ctx.config.get("int8")
    calib = gen.frames(int8["calibration_frames"], model, s_c, ctx.device) \
        if int8 else None
    return raw, batches, calib


def reference(ctx, model, raw, calib, precision: str):
    """The reference's weights in `precision`, calibrated like the
    program where it quantizes."""
    int8 = ctx.config.get("int8")
    quantized = model.int8_convs(int8["min_ch"]) if int8 else ()
    wts = darknet.Weights(model, wgen.to_device(raw, ctx.device), precision,
                          quantized)
    if wts.quantized:
        wts.calibrate([gen.to_unit(calib, ctx.device)])
    return wts


def answer(ctx, wts, frames) -> tuple:
    """(candidates, served triple) of the reference for a uint8 batch."""
    parts = []
    with torch.no_grad():
        for i in range(0, len(frames), CHUNK):
            x = gen.to_unit(frames[i:i + CHUNK], ctx.device)
            parts.append(darknet.decode(wts.model, darknet.forward(wts, x)))
        cand = tuple(torch.cat(p) for p in zip(*parts))
        t = ctx.traffic
        triple = postprocess.serve(*cand, thresh=t["thresh"], nms=t["nms"],
                                   top_k=t["top_k"])
    return cand, triple


def judge(ctx, wts, answers: dict, batches, log=None) -> dict:
    """The comparison's numbers over the answers ({batch index: [served
    triples]}), reference computed once a batch."""
    t = ctx.traffic
    classes = wts.model.heads[0].classes
    grid = darknet.grid_sizes(wts.model, ctx.device)
    box_tol = ctx.cell["check"]["limits"]["box_gap"]
    per, malformed = [], 0
    for k, got in sorted(answers.items()):
        ok = [g for g in got if compare.well_formed(
            g, t["batch"], t["top_k"], classes)]
        malformed += len(got) - len(ok)
        if not ok:
            continue
        cand, ref = answer(ctx, wts, batches[k])
        per += [compare.gaps(g, ref, cand, grid, thresh=t["thresh"],
                             nms=t["nms"], box_tol=box_tol) for g in ok]
        del cand, ref
        _free(ctx.device)
    if log is not None and per:
        box = max(per, key=lambda r: r["box_gap"])["box_worst"]
        log(f"compared: requests {len(per)}, decisive kept pairs "
            f"{sum(r['decisive'] for r in per)}, missed "
            f"{sum(r['missed'] for r in per)}; the widest box gap by "
            f"coordinate (x, y in cells, log w, log h, objectness) "
            f"{[round(v, 4) for v in box]}")
    return compare.combine(per, malformed)


def run(ctx) -> harness.Outcome:
    from darknet_tpu_torch import Network    # the program under test

    cfg, t, dev = ctx.config, ctx.traffic, ctx.device
    marks = [("imports", time.perf_counter())]
    model = darknet.Model(cfg["cfg_text"])
    raw, batches, calib = inputs(ctx, model)
    _free(dev)
    marks.append(("inputs", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fd, path = tempfile.mkstemp(suffix=".weights")
    os.close(fd)
    try:
        wgen.write(model, raw, path)
        marks.append(("weights file", time.perf_counter()))
        net = Network.from_cfg(cfg["cfg_text"], weights=path,
                               compute_dtype=DTYPES[cfg["compute"]],
                               device=dev, int8=bool(cfg.get("int8")))
    finally:
        os.remove(path)
    marks.append(("from_cfg", time.perf_counter()))
    if calib is not None:
        net.calibrate_int8([gen.to_unit(calib, "cpu").numpy()])
        marks.append(("calibrate_int8", time.perf_counter()))

    def request(frames):
        out = net.submit_detect_device(frames, thresh=t["thresh"],
                                       nms=t["nms"], top_k=t["top_k"])
        return tuple(x.cpu() for x in out)

    warm = t["warmup_requests"]
    for i in range(warm):
        request(batches[i % len(batches)])
    _sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    window = gen.closed_loop(request, batches, ctx.seconds, start=warm)
    setup_s = window["t0"] - ctx.t_start
    marks.insert(0, ("process start", ctx.t_start))
    ctx.log("set-up s: " + ", ".join(
        f"{name} {t1 - t0:.3f}" for (_n, t0), (name, t1)
        in zip(marks, marks[1:])))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    classes = model.heads[0].classes
    good = [compare.well_formed(a, t["batch"], t["top_k"], classes)
            for a in window["answers"]]
    lat_ms = [1e3 * (s if ok else window["seconds"])
              for s, ok in zip(window["latencies_s"], good)]
    metrics = {"serve_img_s": t["batch"] * sum(good) / window["seconds"],
               "serve_p95_ms": float(np.percentile(lat_ms, 95)),
               "setup_s": setup_s}
    record = {"window": {"seconds": window["seconds"],
                         "images": t["batch"] * sum(good)},
              "model": model, "config": cfg, "traffic": t}
    outcome_extra = {}
    if ctx.trace:
        n = t["profiled_requests"]
        sent = [len(window["answers"]) + warm]

        def traced():
            request(batches[sent[0] % len(batches)])
            sent[0] += 1

        busy = tracing.device_busy(traced, n, dev)
        events = tracing.capture(traced, n, dev)
        tr = tracing.reduce(events, n)
        del events
        record["trace"] = tr
        if dev.type == "cuda":
            record["peaks"] = flops.peaks(torch.cuda.get_device_name(dev))
        if busy is None:
            w0, w1 = tr["window_us"]
            busy = (tr["busy_us"], w1 - w0)
        record["busy_us"], record["window_us"] = busy
        outcome_extra = {"busy_s": busy[0] / 1e6, "window_s": busy[1] / 1e6,
                         "breakdown": tracing.breakdown(tr)}
    del net
    _free(dev)

    picked = gen.sample(len(window["answers"]),
                        ctx.cell["check"]["sample_requests"],
                        harness.streams(ctx.seed, 4)[3])
    answers: dict = {}
    for i in picked:
        answers.setdefault(window["batch_index"][i], []).append(
            window["answers"][i])
    wts = reference(ctx, model, raw, calib, cfg["reference"])
    numbers = judge(ctx, wts, answers, batches, log=ctx.log)
    limits = ctx.cell["check"]["limits"]
    return harness.Outcome(
        correct=compare.judge(numbers, limits),
        attempted=len(window["answers"]), failed=len(good) - sum(good),
        metrics=metrics,
        checks={k: (numbers[k], lim) for k, lim in limits.items()},
        memory_peak_bytes=int(peak), record=record, **outcome_extra)


def control(ctx) -> dict:
    """The comparison's numbers with the reference put in the program's
    place in the configuration's control precision (`control` in its
    file: a precision below the one it states), over as many requests as
    a run compares, cycling the traffic's batches as the window does."""
    model = darknet.Model(ctx.config["cfg_text"])
    raw, batches, calib = inputs(ctx, model)
    n = ctx.cell["check"]["sample_requests"]
    counts: dict = {}
    for i in range(n):
        counts[i % len(batches)] = counts.get(i % len(batches), 0) + 1
    ctl = reference(ctx, model, raw, calib, ctx.config["control"])
    answers = {k: [tuple(t.cpu() for t in answer(ctx, ctl, batches[k])[1])]
               * c for k, c in counts.items()}
    del ctl
    _free(ctx.device)
    wts = reference(ctx, model, raw, calib, ctx.config["reference"])
    return judge(ctx, wts, answers, batches)
