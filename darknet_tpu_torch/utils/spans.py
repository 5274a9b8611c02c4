"""The port's tracing: profiler ranges, and the spans and counts of the
serving requests.

* `scope(name)` is a `record_function` range, named after a cfg layer or
  a step phase (`L{i:03d}_{kind}`, `L{a:03d}-{b:03d}_region`,
  `head_delta_{n}`, `optimizer_update`), which `utils/profiler.
  trace_report` attributes device time to.
* `span(name)` is such a range that also records, in an in-memory store,
  its name, its request's id, its parent span and its host start and end
  (`time.perf_counter_ns()`).  `span(name, request=True)` opens a new
  request when none is open on the thread (`Network.submit_detect_device`
  opens one a call, `serve_request`); a span or count outside a request
  records nothing in the store.
* `count(name, n=1)` adds n to a counter of the open request
  (`nms_rounds`, `host_syncs`).
* `requests()` returns the finished requests, oldest first (reading does
  not clear them); `clear()` empties the store.  It holds the last
  `LIMIT` requests.

Tracing is on exactly while torch.profiler records
(`torch.autograd._profiler_enabled()`), with the CUDA activity alone
too, and off while torch compiles or exports a program
(`torch.compiler.is_compiling()`), so an exported program holds no span.
Off, a span or count site costs that one check and allocates nothing.
On, a span adds no CUDA call, event, tensor or synchronisation: its
times are the host's, and in a profile it lines up with the kernels
through its range of the same name.  No span is named like a `scope`,
so the kernels each `L###` range holds stay as they are.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch
from torch.autograd.profiler import record_function

LIMIT = 1024          # requests the store keeps, the oldest dropped first
_OFF = contextlib.nullcontext()


def scope(name: str):
    """A profiler range while torch.profiler records: one check when
    not."""
    return record_function(name) if torch.autograd._profiler_enabled() \
        else _OFF


@dataclasses.dataclass
class Span:
    """A recorded span: `parent` is the index of the enclosing span in its
    request's `spans` (None for the request's root)."""

    name: str
    request: int
    parent: int | None
    start_ns: int
    end_ns: int | None = None


@dataclasses.dataclass
class Request:
    """A request's spans, in the order they opened, and its counts."""

    id: int
    spans: list
    counts: dict

    def ms(self, name: str) -> float:
        """Host milliseconds under the spans named `name`, summed."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name == name) / 1e6


class Store:
    """Finished requests (the last `limit`) and, per thread, the open
    request and the stack of its open spans."""

    def __init__(self, limit: int = LIMIT):
        self._done = collections.deque(maxlen=limit)
        self._ids = itertools.count()
        self._local = threading.local()

    def open(self, name: str, request: bool) -> Span | None:
        local = self._local
        req = getattr(local, "request", None)
        if req is None:
            if not request:
                return None
            req = local.request = Request(next(self._ids), [], {})
            local.stack = []
        stack = local.stack
        s = Span(name, req.id, stack[-1] if stack else None,
                 time.perf_counter_ns())
        stack.append(len(req.spans))
        req.spans.append(s)
        return s

    def close(self, s: Span | None) -> None:
        if s is None:
            return
        s.end_ns = time.perf_counter_ns()
        local = self._local
        local.stack.pop()
        if not local.stack:
            self._done.append(local.request)
            local.request = None

    def count(self, name: str, n: int) -> None:
        req = getattr(self._local, "request", None)
        if req is not None:
            req.counts[name] = req.counts.get(name, 0) + n

    def requests(self) -> list:
        return list(self._done)

    def clear(self) -> None:
        self._done.clear()


STORE = Store()


class _Span:
    __slots__ = ("_name", "_request", "_range", "_span")

    def __init__(self, name: str, request: bool):
        self._name, self._request = name, request

    def __enter__(self):
        self._range = record_function(self._name)
        self._range.__enter__()
        self._span = STORE.open(self._name, self._request)
        return self

    def __exit__(self, *exc):
        STORE.close(self._span)
        return self._range.__exit__(*exc)


def span(name: str, *, request: bool = False):
    """A profiler range that the store records while tracing is on; with
    request=True it opens a new request where none is open."""
    if not torch.autograd._profiler_enabled() \
            or torch.compiler.is_compiling():
        return _OFF
    return _Span(name, request)


def count(name: str, n: int = 1) -> None:
    """Add n to the open request's counter `name` while tracing is on."""
    if not torch.autograd._profiler_enabled() \
            or torch.compiler.is_compiling():
        return
    STORE.count(name, n)


def count_copy(x: torch.Tensor, device) -> None:
    """Count a host sync where copying x to `device` makes the host wait:
    torch's blocking copy between host memory and a CUDA device waits for
    the stream's queue (a pageable upload would in any case)."""
    if not torch.autograd._profiler_enabled() \
            or torch.compiler.is_compiling():
        return
    if (x.device.type == "cuda") != (torch.device(device).type == "cuda"):
        STORE.count("host_syncs", 1)


def requests() -> list:
    """The finished requests, oldest first."""
    return STORE.requests()


def clear() -> None:
    """Empty the store."""
    STORE.clear()
