"""darknet_tpu_torch's debug aids, per-layer profiler and benchmark
(`utils/debug.py`, `utils/profiler.py`, `apps/bench.py`) on the CPU,
against darknet_tpu where it has the same function:

* `compare_arrays` prints the JAX package's report, character for
  character, and returns its value;
* `debug_nans` raises FloatingPointError at the first layer whose output
  holds a NaN or an Inf, named by its profiler scope, in serving and in a
  training step (the planted NaN is in that layer's weights), and nothing
  outside the block; `debug_sync_mode` leaves outputs unchanged, bitwise,
  and both modes restore the previous state, on an error too;
* `trace_report` on tests/test_profiler.py's cfg: a row for every layer
  scope, sorted, BFLOPs from the IR, rows summing to the TOTAL (on the CPU
  the rows are the host ops' own times); the train step's
  head_delta and optimizer_update scopes; a region's row;
* `benchmark_layers`: one marginal a checkpoint;
* the bench's JSON line at a test size on the CPU: bench.py's keys less
  vs_baseline, positive rates, the host named as the device.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from darknet_tpu.utils import debug as jdebug
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.apps import bench
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.nn.emit import make_forward
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
from darknet_tpu_torch.utils import debug, profiler
from tests.test_profiler import CFG
from tests.test_torch_train_loop import CFG as TRAIN_CFG

torch.set_num_threads(2)


def _net():
    g = build_graph(CFG)
    p = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=0))
    return g, p


def _x(b=2, px=64, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, px, px, 3)).astype(
        np.float32)


@pytest.mark.parametrize("shape_b", [(3, 4), (5, 2)])
def test_compare_arrays_as_jax(shape_b):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=shape_b).astype(np.float32)
    got, want = [], []
    v = debug.compare_arrays(torch.from_numpy(a), b, "x", log=got.append)
    w = jdebug.compare_arrays(jnp.asarray(a), b, "x", log=want.append)
    assert got == want and v == w


@pytest.mark.parametrize("layer", [0, 2, 3])
def test_debug_nans_names_the_layer_in_serving(layer):
    g, p = _net()
    p[layer] = dict(p[layer], w=p[layer]["w"].copy())
    p[layer]["w"][0, 0, 0, 0] = np.nan
    fwd = make_forward(g)
    tp = tparams.params_to_torch(g, p, "cpu")
    x = torch.from_numpy(_x())
    fwd(tp, x)                                 # off: NaN flows on
    with pytest.raises(FloatingPointError,
                       match=f"L{layer:03d}_convolutional"):
        with debug.debug_nans():
            fwd(tp, x)
    assert debug.layer_check() is None         # restored after the error


def test_debug_nans_names_the_layer_in_training():
    g = build_graph(TRAIN_CFG.format(random=0), train=True)
    p0 = tparams.init_params(g, seed=0)
    p0[2]["w"][0, 0, 0, 0] = np.nan
    params = tparams.train_params_to_torch(g, p0, "cpu")
    opt = init_opt_state(g, params)
    step = make_train_step(g, accum=2)
    x = torch.from_numpy(_x(4))
    y = torch.zeros(4, 90, 5)
    y[:, 0] = torch.tensor([0.5, 0.5, 0.2, 0.2, 1.0])
    with debug.debug_sync_mode(), debug.debug_nans():
        with pytest.raises(FloatingPointError, match="L002_convolutional"):
            step(params, opt, x, y, 1e-3)


def test_debug_sync_mode_same_outputs():
    g, p = _net()
    fwd = make_forward(g)
    tp = tparams.params_to_torch(g, p, "cpu")
    x = torch.from_numpy(_x())
    want = fwd(tp, x)["heads"]
    with debug.debug_sync_mode():
        assert debug.layer_check() is not None
        with debug.debug_nans():
            got = fwd(tp, x)["heads"]
        assert debug.layer_check() is not None
    assert debug.layer_check() is None
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_trace_report_rows():
    g, p = _net()
    fwd = make_forward(g)
    tp = tparams.params_to_torch(g, p, "cpu")
    lines = []
    rows = profiler.trace_report(lambda p, x: fwd(p, x)["output"], tp,
                                 torch.from_numpy(_x()), graph=g, iters=2,
                                 log=lines.append)
    scopes = {r[0] for r in rows}
    assert {f"L{l.index:03d}_{l.kind}" for l in g.layers} <= scopes
    assert scopes - {f"L{l.index:03d}_{l.kind}" for l in g.layers} <= {
        "(other)"}
    times = [r[1] for r in rows]
    assert times == sorted(times, reverse=True) and min(times) > 0
    for name, _ms, bf in rows:
        if name.startswith("L"):
            assert bf == pytest.approx(g.layers[int(name[1:4])].bflops)
    total = float(lines[-1].split()[-1])
    assert lines[-1].startswith("TOTAL (host)")
    assert total == pytest.approx(sum(times), abs=2e-3)
    assert len(lines) == len(rows) + 2


def test_trace_report_region_and_step_scopes():
    """A planned region is one row (the plain steps on the CPU) with its
    layers' BFLOPs; a training step's deltas and update have their own
    rows."""
    cfg = model_zoo.yolov4_cfg(64, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, device="cpu")
    rows = profiler.trace_report(
        lambda p, x: net._fwd(p, x)["output"], net.params,
        torch.from_numpy(_x(1)), graph=net.graph, iters=1, log=lambda s: 0)
    got = dict((r[0], r[2]) for r in rows)
    assert got["L000-023_region"] == pytest.approx(
        sum(l.bflops for l in net.graph.layers[:24]))
    assert "L010_convolutional" not in got and "L024_convolutional" in got

    g = build_graph(TRAIN_CFG.format(random=0), train=True)
    params = tparams.train_params_to_torch(
        g, tparams.init_params(g, seed=0), "cpu")
    opt = init_opt_state(g, params)
    step = make_train_step(g, accum=2)
    y = torch.zeros(4, 90, 5)
    y[:, 0] = torch.tensor([0.5, 0.5, 0.2, 0.2, 1.0])
    rows = profiler.trace_report(step, params, opt, torch.from_numpy(_x(4)),
                                 y, 1e-3, graph=g, iters=1, log=lambda s: 0)
    names = {r[0] for r in rows}
    assert {"head_delta_0", "optimizer_update", "L000_convolutional",
            "L013_yolo"} <= names


def test_benchmark_layers_marginals():
    g, p = _net()
    tp = tparams.params_to_torch(g, p, "cpu")
    lines = []
    times = profiler.benchmark_layers(g, tp, iters=2, checkpoints=[1, 4],
                                      log=lines.append)
    assert [t[0] for t in times] == [(0, 1), (2, 4)]
    assert sum(t[2] for t in times) == pytest.approx(
        sum(l.bflops for l in g.layers))
    assert len(lines) == 2 and lines[0].startswith("layers   0-  1")


def test_bench_line_on_the_cpu():
    """bench.run at 64 px, batch 2, few repetitions: bench.py's keys (no
    vs_baseline), positive rates, no kernel launch on the CPU."""
    line = bench.run(2, size=64, device="cpu", iters=2, series=1,
                     lat_reps=2, train_batch=2)
    assert set(line) == {
        "metric", "value", "unit", "p50_latency_ms_batch1_sync",
        "batch1_ms_amortized", "batch", "card", "launches_per_request",
        "bf16_img_s", "bf16_launches_per_request", "train_608_img_s",
        "train_608_img_s_blocking"}
    assert "int8" in line["metric"] and "[host: cpu]" in line["metric"]
    assert line["card"] == "cpu" and line["unit"] == "img/s"
    for k in ("value", "bf16_img_s", "train_608_img_s",
              "train_608_img_s_blocking", "p50_latency_ms_batch1_sync"):
        assert line[k] > 0
    assert line["launches_per_request"] == {"fused_region": 0,
                                            "int8_gemm": 0}

