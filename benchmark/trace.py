"""The traced sub-windows: `torch.profiler` over a few requests, reduced
to what the per-layer readers read.  The device's busy and idle time
come from a profile of the CUDA activity alone, which leaves the host as
fast as it runs unprofiled; the kernels' ranges, the launches and the
host ranges under the idle gaps from a second one that records the host
too.

A kernel is tied to the runtime call that launched it by the
correlation id they share, which reaches the kernels launched through
ctypes too, and that call to the innermost forward range (`L###_kind`,
`L###-###_region`) that holds it through its parents.  The window is a
range the benchmark opens around the requests; the device is busy where
any of its events runs (the union of their intervals), idle elsewhere.
"""

from __future__ import annotations

import bisect
import collections

import torch

from benchmark.flops import SCOPE

WINDOW = "benchmark.window"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
TOP = 10


def _scope_of(event):
    while event is not None:
        if SCOPE.match(event.name):
            return event.name
        event = event.cpu_parent
    return None


def capture(fn, n: int, device):
    """Profile `n` calls of fn() inside the window range; the events."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        # a trace can lose its first device event: let it be this one
        torch.zeros(1, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with record_function(WINDOW):
            for _ in range(n):
                fn()
    return prof.events()


def device_busy(fn, n: int, device):
    """Profile `n` calls of fn() recording the CUDA activity alone:
    (busy us, window us), the window from a marker kernel launched just
    before the first call to one launched just after the last; None off
    the card."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # two start markers: a trace can lose its first device event
        torch.zeros(1, device=device)
        torch.zeros(1, device=device)
        for _ in range(n):
            fn()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    dev = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation()]
    if not dev:
        return None
    window = max(t for _s, t in dev) - min(s for s, _t in dev)
    return sum(t - s for s, t in _union(dev)), window


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events, requests: int) -> dict:
    """{"requests", "window_us" (start, end), "launches", "kernels":
    [(name, start_us, end_us, scope)], "busy_us", "gaps": [(host range
    open at the gap, us)] longest first}."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = next(e for e in cpu if e.name == WINDOW)
    w0, w1 = win.time_range.start, win.time_range.end
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    kernels = []
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        s, t = e.time_range.start, e.time_range.end
        if t <= w0 or s >= w1:
            continue
        call = runtime.get(e.id)
        kernels.append((e.name, max(s, w0), min(t, w1),
                        _scope_of(call) if call is not None else None))
    busy = _union([(s, t) for _n, s, t, _sc in kernels])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    launches = sum(1 for e in cpu if e.name in LAUNCHES
                   and w0 <= e.time_range.start <= w1)
    return {"requests": requests, "window_us": (w0, w1),
            "launches": launches, "kernels": kernels,
            "busy_us": sum(t - s for s, t in busy),
            "gaps": _name_gaps(gaps, cpu)}


def _name_gaps(gaps, cpu, keep: int = 300, back: int = 2000) -> list:
    """The longest gaps, each named by the innermost host range or op
    open at its start (inside the forward range holding it, if any)."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:keep]
    cpu = sorted((e for e in cpu if e.name != WINDOW),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in cpu]
    out = []
    for s, t in longest:
        # the latest-starting event that still runs at s, among the last
        # `back` to start before it
        inner = None
        hi = bisect.bisect_right(starts, s) - 1
        for i in range(hi, max(hi - back, -1), -1):
            if cpu[i].time_range.end > s:
                inner = cpu[i]
                break
        name = "(no host range)"
        if inner is not None:
            scope = _scope_of(inner)
            name = inner.name if scope in (None, inner.name) \
                else f"{scope}/{inner.name}"
        out.append((name, t - s))
    return out


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the ten host
    ranges under which the device idled longest, in seconds."""
    ops = collections.Counter()
    for name, s, t, _sc in trace["kernels"]:
        ops[name[:160]] += t - s
    idle = collections.Counter()
    for name, us in trace["gaps"]:
        idle[name[:160]] += us
    return {"device_ops": [[n, us / 1e6] for n, us in ops.most_common(TOP)],
            "idle_gaps": [[n, us / 1e6] for n, us in idle.most_common(TOP)]}
