"""The program's own spans and counts of the profiled requests
(`darknet_tpu_torch.utils.spans`), for the per-layer readers that read
them.

The program records a request's spans and counts while torch.profiler
records.  A `--trace 1` run profiles `profiled_requests` requests first
with the CUDA activity alone (on a card), which leaves the host at its
unprofiled pace: those are the first requests in the store (on the CPU,
the requests of the profile that records the host).  A program without
the store, or a store that holds fewer requests, gives None.
"""

from __future__ import annotations


def profiled(record):
    """The first `profiled_requests` requests in the program's store, or
    None."""
    try:
        from darknet_tpu_torch.utils import spans
    except ImportError:
        return None
    n = record["traffic"]["profiled_requests"]
    reqs = spans.requests()[:n]
    return reqs if n and len(reqs) == n else None


def host_ms(record, name: str):
    """Host ms a request under the spans named `name`; None where no
    profiled request has one."""
    reqs = profiled(record)
    if reqs is None or not any(s.name == name for r in reqs
                               for s in r.spans):
        return None
    return sum(r.ms(name) for r in reqs) / len(reqs)


def per_request(record, name: str):
    """The counter `name` a request (0 where a request counted none)."""
    reqs = profiled(record)
    if reqs is None:
        return None
    return sum(r.counts.get(name, 0) for r in reqs) / len(reqs)
