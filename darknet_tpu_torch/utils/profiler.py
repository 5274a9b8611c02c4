"""Per-layer cost reports, the `-benchmark_layers` equivalent
(network_kernels.cu:27-114; `darknet_tpu/utils/profiler.py`) on torch.

* `trace_report` runs a program under `torch.profiler` and attributes the
  device time of each kernel to the cfg layer whose profiler range
  launched it: the ranges are `utils/spans.scope`'s, named as the JAX
  emitter's scopes (`L{i:03d}_{kind}`, `L{a:03d}-{b:03d}_region`,
  `head_delta_{n}`, `optimizer_update`).  A kernel is tied to the runtime
  call that launched it by its correlation id, and that call to its
  range through the `cpu_parent` chain; what no range holds is
  "(other)".  (The links torch draws from a kernel to its aten op miss
  the kernels launched through ctypes, the region kernel and the int8
  GEMM.)  It prints the reference's sorted table, the device time of the
  whole trace beside its TOTAL, and how many launch calls have their
  kernel in the trace, since a trace can drop events.  On the CPU there are no kernels: the rows are the host
  ops' own times, as the JAX package's CPU schema reads them.
* `benchmark_layers` times prefix programs (the layers up to each
  checkpoint) and prints the marginal cost of each span, by CUDA events
  on the card and by the host clock on the CPU.
"""

from __future__ import annotations

import collections
import copy
import re
import time

import numpy as np
import torch

from darknet_tpu_torch.nn.emit import make_forward

SCOPE = re.compile(
    r"^(L\d{3}(?:-\d{3})?_\w+|head_delta_\d+|optimizer_update)$")


def _device_of(obj):
    """The device of the first tensor in nested lists, tuples and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    items = obj.values() if isinstance(obj, dict) else (
        obj if isinstance(obj, (list, tuple)) else ())
    for v in items:
        d = _device_of(v)
        if d is not None:
            return d
    return None


def _scope_of(event):
    while event is not None:
        if SCOPE.match(event.name):
            return event.name
        event = event.cpu_parent
    return None


def device_events(events) -> list:
    """The kernels, copies and sets of a profile: its device events less
    the device-side spans of the profiler ranges."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def attribute(events, on_card: bool) -> dict:
    """{scope or "(other)": Counter(name: us)} over a profile's events: on
    the card each device event's time, by kernel name, under the range
    that holds the runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...)
    sharing its correlation id, which also reaches the kernels launched
    through ctypes; a device event with no such call is in no row.  On
    the CPU each op's own time, by op name."""
    from torch.autograd import DeviceType

    per: dict = collections.defaultdict(collections.Counter)
    if on_card:
        runtime = {e.id: e for e in events
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith("cu")}
        for e in device_events(events):
            call = runtime.get(e.id)
            if call is not None:
                per[_scope_of(call) or "(other)"][e.name] += \
                    e.time_range.elapsed_us()
        return per
    for e in events:
        if e.device_type == DeviceType.CPU:
            per[_scope_of(e) or "(other)"][e.name] += e.self_cpu_time_total
    return per


def _layer_bflops(graph, scopes) -> dict:
    """BFLOPs of each scope: its layer's, or the sum over a region's."""
    out = {}
    for key in scopes:
        m = re.match(r"L(\d{3})(?:-(\d{3}))?_", key)
        if m:
            a = int(m.group(1))
            b = int(m.group(2)) if m.group(2) else a
            out[key] = sum(l.bflops for l in graph.layers[a:b + 1])
    return out


def trace_report(fn, *args, graph=None, iters: int = 5, log=print,
                 top: int = 0):
    """Profile `fn(*args)` (after one untimed call) over `iters` calls and
    print the sorted per-layer table: ms per iteration, share, BFLOPs and
    TFLOP/s of each scope, "(other)", the TOTAL and, on the card, the
    trace's whole device time.  `graph` adds each layer's BFLOPs; `top`
    shows the first rows only.  Returns [(scope, ms_per_iter, bflops)]
    sorted by time, which sum to the TOTAL."""
    from torch.profiler import ProfilerActivity, profile

    device = _device_of(args)
    on_card = device is not None and device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    # the untimed call runs under a profiler too: a process's first trace
    # pays the profiler's start-up inside its first ops
    with profile(activities=acts):
        fn(*args)
        sync()
    with profile(activities=acts) as prof:
        if on_card:
            # a trace can lose its first device event: let it be this one
            torch.zeros(1, device=device)
            sync()
        for _ in range(iters):
            fn(*args)
        sync()
    events = prof.events()
    per_scope = {k: sum(v.values())
                 for k, v in attribute(events, on_card).items()}
    dev = device_events(events)
    device_us = sum(e.time_range.elapsed_us() for e in dev)
    bflops = _layer_bflops(graph, per_scope) if graph is not None else {}
    rows = sorted(((k, v / iters / 1000.0, bflops.get(k, 0.0))
                   for k, v in per_scope.items()), key=lambda r: -r[1])
    total_ms = sum(r[1] for r in rows)
    log(f"{'layer':<28} {'ms/iter':>9} {'%':>6} {'BFLOPs':>8} {'TFLOP/s':>8}")
    for k, ms, bf in (rows[:top] if top else rows):
        tf = (bf / ms) if ms > 0 else 0.0   # BFLOP/ms == TFLOP/s
        log(f"{k:<28} {ms:9.3f} {100 * ms / max(total_ms, 1e-9):5.1f}% "
            f"{bf:8.2f} {tf:8.1f}")
    log(f"{'TOTAL (device)' if on_card else 'TOTAL (host)':<28} "
        f"{total_ms:9.3f}")
    if on_card:
        log(f"{'device time in the trace':<28} "
            f"{device_us / iters / 1000.0:9.3f}")
        # a kernel the trace dropped is in neither number: count the
        # launch calls whose kernel is missing
        ids = {e.id for e in dev}
        calls = [e for e in events if "LaunchKernel" in e.name]
        log(f"kernels in the trace: {sum(e.id in ids for e in calls)} of "
            f"{len(calls)} launches")
    return rows


def benchmark_layers(graph, params, *, batch: int = 1, compute_dtype=None,
                     fused_bn: bool = True, iters: int = 5,
                     checkpoints: list | None = None, log=print):
    """Time the prefix programs of the layers up to each checkpoint
    (default: every 10th layer, the heads and the last) and print the
    marginal cost of each span.  Returns [((first, last), ms, bflops)]."""
    n = len(graph.layers)
    if checkpoints is None:
        checkpoints = sorted(
            set(list(range(9, n, 10)) + [l.index for l in graph.heads()]
                + [n - 1]))
    device = _device_of(params) or torch.device("cpu")
    on_card = device.type == "cuda"
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (batch, graph.net.h, graph.net.w, graph.net.c)).astype(
            np.float32)).to(device)

    def ms_per_call(f):
        # the region step weights are made once, as a Network holds them
        p = f.with_step_weights(params)
        with torch.inference_mode():
            f(p, x)
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    f(p, x)
                stop.record()
                torch.cuda.synchronize(device)
                return start.elapsed_time(stop) / iters
            t0 = time.perf_counter()
            for _ in range(iters):
                f(p, x)
            return (time.perf_counter() - t0) / iters * 1000

    times = []
    prev_ms, prev_i = 0.0, -1
    for ci in checkpoints:
        sub = copy.copy(graph)
        sub.layers = graph.layers[:ci + 1]
        ms = ms_per_call(make_forward(sub, compute_dtype=compute_dtype,
                                      fused_bn=fused_bn))
        bflops = sum(l.bflops for l in graph.layers[prev_i + 1:ci + 1])
        times.append(((prev_i + 1, ci), ms - prev_ms, bflops))
        log(f"layers {prev_i + 1:3d}-{ci:3d}: {ms - prev_ms:8.2f} ms "
            f"marginal ({ms:8.2f} ms cum), {bflops:6.2f} BFLOPs")
        prev_ms, prev_i = ms, ci
    return times
