"""The port's tracing (`darknet_tpu_torch/utils/spans.py`) in the serving
path, on the CPU, and on a CUDA card where there is one.

- Off (no profiler), a request records nothing and makes no call into
  the tracing module beyond the gate's check.
- On, one `submit_detect_device` records one `serve_request` whose
  children are `serve_upload`, `serve_forward`, `serve_select` and
  `serve_nms`, in order, under one request id; the profiler holds
  ranges of the same names, every `L###` range inside `serve_forward`;
  the triple is the one served with tracing off.
- `nms_rounds` is the number of rounds the test counts itself by
  iterating `nms_device`'s Lo/Hi bounds on the same boxes and probs;
  `host_syncs` is two more (the NMS loop's flag reads: before each round
  and after the last, the first read twice; a CPU input makes no copy to
  a card).
- `conv_epilogues` counts each conv a request serves outside the region
  kernel; `conv_epilogues_fused` those whose epilogue ran in one pass,
  none on the CPU and all of a benchmark cell's on the card.
- No span is named like a layer range (`benchmark.flops.SCOPE`,
  `utils.profiler.SCOPE`); the store keeps its last `LIMIT` requests;
  `export_serving` under the profiler exports a program with no span or
  count in it, which serves the same triple.
- On a card (skips here): one request of each benchmark cell's
  configuration at its size under `torch.cuda.set_sync_debug_mode("warn")`
  warns of exactly as many synchronising calls inside the program as it
  counts `host_syncs`; a profile of the CUDA activity alone turns tracing on.

This file imports no jax.  On the card:
    python -m pytest --noconftest -s tests/test_torch_spans.py
"""

import os
import re
import sys
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import emit as temit
from darknet_tpu_torch.ops import boxes as boxops
from darknet_tpu_torch.ops import nms as nmslib
from darknet_tpu_torch.utils import profiler as tprofiler
from darknet_tpu_torch.utils import spans
from darknet_tpu_torch.weights import io as wio
# by file, not as tests.torch_params: an installed package named `tests`
# would shadow this directory
from torch_params import cell_net, chip_smoke, spread_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PX = 160
KIDS = ["serve_upload", "serve_forward", "serve_select", "serve_nms"]
NAMES = ["serve_request"] + KIDS
SERVE = {"thresh": 0.2, "nms": 0.45, "top_k": 64}


def _frames(b, px, seed=0):
    return (np.random.default_rng(seed).uniform(0, 1, (b, px, px, 3))
            * 255).astype(np.uint8)


def _yolov4_tiny(tmp):
    cfg = model_zoo.yolov4_tiny_cfg(PX, PX)
    x = _frames(2, PX).astype(np.float32) / 255
    path = os.path.join(tmp, "tiny.weights")
    g = build_graph(cfg)
    wio.save_weights(g, spread_params(g, x, 1.5), path)
    return Network.from_cfg(cfg, weights=path, device="cpu")


def _gaussian(_tmp):
    return Network.from_cfg(chip_smoke().GAUSSIAN_TRAIN_CFG, seed=1,
                            device="cpu")


NETS = {"yolov4-tiny": _yolov4_tiny, "gaussian": _gaussian}


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = str(tmp_path_factory.mktemp("spans"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {k: make(tmp) for k, make in NETS.items()}


@pytest.fixture(autouse=True)
def empty_store():
    spans.clear()
    yield
    spans.clear()


def _traced(net, x, **kw):
    """(triple, profiler events) of one request under a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = net.submit_detect_device(x, **{**SERVE, **kw})
    return out, prof.events()


def test_off_records_nothing(nets):
    """No profiler: the store stays empty, and the only calls made in the
    tracing module are the gates (the layers' `scope` too) and their one
    check."""
    net = nets["yolov4-tiny"]
    x = _frames(2, PX, seed=1)
    net.submit_detect_device(x, **SERVE)             # warm
    calls = []

    def watch(frame, event, arg):
        if frame.f_code.co_filename != spans.__file__:
            return
        if event == "call":
            calls.append(frame.f_code.co_name)
        elif event == "c_call":
            calls.append(arg.__name__)

    sys.setprofile(watch)
    try:
        net.submit_detect_device(x, **SERVE)
    finally:
        sys.setprofile(None)
    assert spans.requests() == []
    assert "_profiler_enabled" in calls
    assert set(calls) <= {"scope", "span", "count", "count_copy",
                          "_profiler_enabled"}, set(calls)


@pytest.mark.parametrize("kind", sorted(NETS))
def test_request_spans(nets, kind):
    net = nets[kind]
    x = _frames(2, net.net.w, seed=2)
    want = net.submit_detect_device(x, **SERVE)
    got, events = _traced(net, x)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    (req,) = spans.requests()
    assert [s.name for s in req.spans] == NAMES
    assert {s.request for s in req.spans} == {req.id}
    assert [s.parent for s in req.spans] == [None, 0, 0, 0, 0]
    root = req.spans[0]
    for a, b in zip(req.spans[1:], req.spans[2:]):
        assert a.end_ns <= b.start_ns
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
               for s in req.spans)
    assert req.ms("serve_request") > req.ms("serve_forward") > 0

    ranges = {}
    for e in events:
        if e.name in NAMES:
            ranges.setdefault(e.name, []).append(e.time_range)
    assert sorted(ranges) == sorted(NAMES)
    assert all(len(v) == 1 for v in ranges.values())
    (fwd,) = ranges["serve_forward"]
    layers = [e for e in events if re.match(r"^L\d{3}", e.name)]
    assert layers
    assert all(fwd.start <= e.time_range.start <= e.time_range.end
               <= fwd.end for e in layers)


def _own_rounds(boxes, probs, thresh):
    """Rounds of nms_device's docstring fixpoint, iterated here in numpy:
    Lo' = f(Hi), Hi' = f(Lo) from Lo = 0, Hi = active until they meet."""
    sim = boxops.iou(boxes[:, :, None, :], boxes[:, None, :, :]).numpy()
    p = probs.transpose(1, 2).numpy()                          # (B,C,N)
    n = p.shape[-1]
    pi, pj = p[..., :, None], p[..., None, :]
    lt = np.tril(np.ones((n, n), bool), -1)
    rank = (pj > pi) | ((pj == pi) & lt)
    P = rank & (sim > thresh)[:, None]
    active = p > 0

    def f(K):
        return active & ~(P & K[..., None, :]).any(-1)

    lo, hi, rounds = np.zeros_like(active), active, 0
    while (lo != hi).any():
        lo, hi = lo | f(hi), hi & f(lo)
        rounds += 1
    return rounds


@pytest.mark.parametrize("kind", sorted(NETS))
def test_nms_rounds_and_host_syncs(nets, kind, monkeypatch):
    net = nets[kind]
    seen = []
    real = nmslib.nms_device

    def nms_device(boxes, probs, thresh, **kw):
        seen.append((boxes.clone(), probs.clone(), thresh))
        return real(boxes, probs, thresh, **kw)

    monkeypatch.setattr(nmslib, "nms_device", nms_device)
    _traced(net, _frames(2, net.net.w, seed=3), thresh=0.1)
    (req,) = spans.requests()
    (case,) = seen
    rounds = _own_rounds(*case)
    assert rounds >= 2
    assert {k: req.counts[k] for k in ("nms_rounds", "host_syncs")} == {
        "nms_rounds": rounds, "host_syncs": rounds + 2}
    assert set(req.counts) == {"nms_rounds", "host_syncs", "conv_epilogues"}


def _served_convs(net) -> list:
    """The conv layers a request runs outside the region kernel."""
    kernel = temit.kernel_conv_indices(net.graph)
    return [l.index for l in net.graph.layers
            if l.kind == "convolutional" and l.index not in kernel]


@pytest.mark.parametrize("kind", sorted(NETS))
def test_conv_epilogues_counted(nets, kind):
    """A request counts each conv it serves outside the region kernel
    (`conv_epilogues`); on the CPU none runs the one-pass kernel, so
    `conv_epilogues_fused` stays unrecorded."""
    net = nets[kind]
    _traced(net, _frames(2, net.net.w, seed=5))
    (req,) = spans.requests()
    assert req.counts["conv_epilogues"] == len(_served_convs(net)) > 0
    assert "conv_epilogues_fused" not in req.counts


def test_span_names_are_not_layer_ranges():
    sys.path.insert(0, REPO)
    try:
        from benchmark import flops
    finally:
        sys.path.remove(REPO)
    for name in NAMES:
        assert not flops.SCOPE.match(name)
        assert not tprofiler.SCOPE.match(name)


def test_store_keeps_its_last_requests(monkeypatch):
    monkeypatch.setattr(spans, "STORE", spans.Store(limit=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with spans.span("serve_request", request=True):
                spans.count("n", i)
                with spans.span("inner"):
                    pass
        spans.count("outside")                 # no open request
        with spans.span("inner"):
            pass
    reqs = spans.requests()
    assert [r.counts for r in reqs] == [{"n": i} for i in range(2, 6)]
    assert [r.id for r in reqs] == [2, 3, 4, 5]
    assert all([s.name for s in r.spans] == ["serve_request", "inner"]
               for r in reqs)
    assert spans.requests() == reqs                    # reading keeps them
    spans.clear()
    assert spans.requests() == []


def test_export_under_the_profiler(nets, tmp_path):
    """Exported with tracing on, the program holds no span or count and
    serves the eager triple; the export records no request."""
    net = nets["yolov4-tiny"]
    art = str(tmp_path / "serve.pt2")
    with profile(activities=[ProfilerActivity.CPU]):
        net.export_serving(art, batch=2, **SERVE)
    assert spans.requests() == []
    targets = {str(n.target) for n in torch.export.load(art).graph.nodes}
    assert not any("profiler" in t or "record_function" in t
                   for t in targets), targets
    x = _frames(2, PX, seed=4).astype(np.float32) / 255
    got = Network.run_exported_serving(art, x)
    want = net.submit_detect_device(x, **SERVE)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with profile(activities=[ProfilerActivity.CPU]):
        Network.run_exported_serving(art, x)
    assert spans.requests() == []


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sync_sites(fn):
    """Run fn() with the card's sync debug mode warning: for each
    synchronising call made inside the program, the innermost frames of
    the Python stack that made it."""
    sites = []
    program = os.sep + "darknet_tpu_torch" + os.sep

    def hook(message, category, filename, lineno, file=None, line=None):
        stack = [f for f in traceback.extract_stack()[:-1]
                 if os.path.basename(f.filename) != "warnings.py"]
        if "synchroniz" in str(message) and any(
                program in f.filename for f in stack):
            sites.append(" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}"
                for f in stack[::-1][:5]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["yolov4-608.serve-b8",
                                  "gaussian-yolov3-512-int8.serve-b32"])
def test_cuda_syncs_are_counted(cuda, cell):
    net, x, kw = cell_net(cell, cuda)
    net.submit_detect_device(x, **kw)                  # builds, uploads
    torch.cuda.synchronize()

    def traced():
        with profile(activities=[ProfilerActivity.CPU]):
            net.submit_detect_device(x, **kw)

    sites = _sync_sites(traced)
    (req,) = spans.requests()
    print(f"\n{cell}: {len(sites)} synchronising calls; counted "
          f"{req.counts}")
    for site in sorted(set(sites)):
        print(f"  {sites.count(site)} x {site}")
    assert req.counts["host_syncs"] == len(sites)
    assert req.counts["nms_rounds"] >= 2


@pytest.mark.cuda
def test_cuda_only_profile_traces(cuda):
    """The benchmark's busy-time profile (the CUDA activity alone) turns
    the program's tracing on."""
    net, x, kw = cell_net("yolov4-608.serve-b8", cuda)
    net.submit_detect_device(x, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd._profiler_enabled()
        net.submit_detect_device(x, **kw)
        torch.cuda.synchronize()
    (req,) = spans.requests()
    assert [s.name for s in req.spans] == NAMES
    print("\nCUDA-only profile, host ms:",
          {s.name: (s.end_ns - s.start_ns) / 1e6 for s in req.spans},
          req.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["yolov4-608.serve-b8",
                                  "gaussian-yolov3-512-int8.serve-b32"])
def test_cuda_conv_epilogues_fused(cuda, cell):
    """On the card every conv a benchmark cell serves outside the region
    runs its epilogue in one pass: the bf16 kernel or the int8 GEMM's
    own."""
    net, x, kw = cell_net(cell, cuda)
    net.submit_detect_device(x, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        net.submit_detect_device(x, **kw)
        torch.cuda.synchronize()
    (req,) = spans.requests()
    print(f"\n{cell}: {req.counts}")
    assert req.counts["conv_epilogues"] == len(_served_convs(net)) > 0
    assert req.counts["conv_epilogues_fused"] == req.counts["conv_epilogues"]
