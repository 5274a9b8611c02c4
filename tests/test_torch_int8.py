"""The int8 serving path, darknet_tpu_torch against darknet_tpu on the CPU.

Numpy makes every input; both packages get the same arrays.

Tolerances, each with its reason:
* int8 GEMM: bitwise equal to the exact int32 sum followed by the
  epilogue's rounded multiply, multiply and add (numpy); against the
  Pallas kernel in interpret mode at rtol 1e-6 / atol 1e-5, as
  tests/test_pallas_quant.py does: XLA on the CPU may contract the
  epilogue's multiply and add into one FMA, which rounds once.
* quantization, int8 weights and scale arrays: equal, byte for byte.
* conv_block_int8: x_q and the int32 accumulator equal, the f32
  pre-activation bitwise equal to the reference epilogue; outputs within
  1 f32 ulp after leaky or linear, and at rtol 1e-6 after mish (exp and a
  division in another order; tests/test_torch_ops.py holds mish there).
* calibration ranges: rtol 1e-5 on the float net; on the quantized net
  the probe runs the int8 convs and carries the slice's int8 noise
  (below): rtol 0.15.
* yolov4-64 slice (f32), end to end: the chain of 91 quantized convs
  amplifies differences below an f32 ulp.  The region's float convs sum
  in another order in each package (~5e-7 at layer 24's input); where a
  value lies that close to a rounding boundary of x / x_scale, the two
  packages quantize it one int8 step apart, the next conv's output moves
  by ~1e-4, which flips many more values at the next quantization, and
  so on: by the heads the two int8 runs differ as much as either differs
  from the float net (over six inputs, dynamic and calibrated: max 0.33,
  mean 0.014, of heads up to 2.8, and once not at all; int8 against f32:
  0.19 and 0.011; measured).  So the slice is held to JAX three ways:
  every quantized conv, fed the input JAX gave it, agrees as the unit
  tests do (equal x_q and int32 sums); the heads within 0.75 and on
  average within 0.04; and the served kept set equals,
  slot by slot once each port slot is matched to the JAX slot of its
  candidate (by box, `torch_params.match_slots`), what JAX's serving
  program keeps from the same heads.
* region_int8 (the region convs quantized as well; yolov4-64): every
  region conv's int8 output, fed the input the port's forward gave it,
  bitwise equal (1 ulp after leaky, rtol 1e-6 after mish) to
  `conv_block_int8` on that input; the heads against the JAX package's
  region_int8 forward (`fuse_regions="xla"`, the packed steps) within
  the same HEAD_ATOL and HEAD_MEAN_ATOL.  Measured over 9 pairs of
  calibration frame and input: 7 agree within 2.3e-6, 2 differ by at
  most 0.21 (mean 0.0065) where the int8 noise flips a step; the port
  quantizes per filter where the JAX step quantizes the packed weights
  per packed channel, and on yolov4 both grids give the same integers
  (ROADMAP C).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from darknet_tpu import model_zoo
from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import network as jnetwork
from darknet_tpu.nn import params as jparams
from darknet_tpu.nn.emit import make_forward as jax_forward
from darknet_tpu.ops import conv as jconv
from darknet_tpu.ops.pallas import quant_matmul as jqm
from darknet_tpu.weights import io as wio
from darknet_tpu_torch import Network
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.nn.emit import (make_forward, region_conv_indices,
                                      region_int8_convs)
from darknet_tpu_torch.ops import conv as tconv
from darknet_tpu_torch.ops import quant_matmul as tqm
from tests.torch_params import lively_params, match_slots, matched

torch.set_num_threads(2)
CFG = model_zoo.yolov4_cfg(64, 64)
HEAD_ATOL = 0.75         # measured at most 0.33 (module docstring)
HEAD_MEAN_ATOL = 0.04    # measured at most 0.014

CONV_CFG = """[net]
width=18
height=14
channels=8
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=24
size=1
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=20
size=3
stride=2
pad=1
activation=linear
[convolutional]
filters=12
size=3
stride=2
pad=1
activation=leaky
"""


def _quiet(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg)


# ---------------------------------------------------------------- GEMM


@pytest.mark.parametrize("m,k,n,leaky", [(1000, 96, 200, False),
                                         (37, 50, 9, True),
                                         (129, 128, 130, True),
                                         (64, 288, 48, False)])
def test_int8_matmul_plain_matches_pallas(m, k, n, leaky):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (k, n), dtype=np.int8)
    ws = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    xs = np.float32(0.0123)
    want = np.asarray(jqm.int8_matmul(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ws), jnp.asarray(bias),
        xs, leaky=leaky, tm=64, tn=64, interpret=True))
    got = tqm.int8_matmul(torch.from_numpy(a),
                          torch.from_numpy(np.ascontiguousarray(b.T)),
                          torch.from_numpy(ws), torch.from_numpy(bias),
                          torch.tensor([xs]), leaky=leaky)
    assert got.dtype == torch.float32 and tqm.launches == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    # to the bit: the exact int32 sum, then the epilogue's rounded ops
    acc = a.astype(np.int64) @ b.astype(np.int64)
    y = acc.astype(np.float32) * (xs * ws) + bias
    np.testing.assert_array_equal(
        got.numpy(), np.where(y > 0, y, np.float32(0.1) * y) if leaky else y)


def test_quantizers_match(rng):
    w = rng.normal(size=(3, 3, 16, 32)).astype(np.float32)
    for a, b in zip(tqm.quantize_weights_int8(w),
                    jqm.quantize_weights_int8(w)):
        np.testing.assert_array_equal(a, b)
    x = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    for absmax in (None, np.float32(1.7)):
        q, s = tqm.quantize_activations_int8(torch.from_numpy(x), absmax)
        jq, js = jqm.quantize_activations_int8(jnp.asarray(x), absmax)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s) == np.float32(js)


@pytest.mark.parametrize("leaky", [False, True])
def test_quantized_conv1x1_matches(rng, leaky):
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    w = rng.normal(size=(1, 1, 32, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    wq, ws = jqm.quantize_weights_int8(w)
    want = jqm.quantized_conv1x1(jnp.asarray(x), wq, ws, b, leaky=leaky,
                                 interpret=True)
    got = tqm.quantized_conv1x1(torch.from_numpy(x), wq, ws, b, leaky=leaky)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


# -------------------------------------------------------------- params


@pytest.fixture(scope="module")
def yolo():
    """yolov4-64: graph and BN-folded lively numpy params."""
    g = _quiet(CFG)
    return g, tparams.fuse_conv_batchnorm(g, lively_params(g))


def test_quantize_conv_params_byte_identical(yolo):
    g, npar = yolo
    want = jparams.quantize_conv_params(g, npar)
    got = tparams.quantize_conv_params(g, npar)
    assert sum("w_q" in p for p in got) == 91
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()
    absmax = {i: float(i) / 7 for i in range(0, len(g.layers), 3)}
    extra = {2, 9}
    for a, b in zip(tparams.apply_conv_input_scales(got, absmax, g, extra),
                    jparams.apply_conv_input_scales(want, absmax, g, extra)):
        assert a.keys() == b.keys()
        if "x_scale" in a:
            assert a["x_scale"].tobytes() == b["x_scale"].tobytes()


def test_params_to_torch_int8_layout(yolo):
    g, npar = yolo
    qp = tparams.quantize_conv_params(g, npar)
    tp = tparams.params_to_torch(g, tparams.apply_conv_input_scales(
        qp, {23: 2.5}), "cpu")
    w_q = qp[23]["w_q"]
    assert tp[23]["w_q"].dtype == torch.int8
    assert tp[23]["w_q"].is_contiguous()
    np.testing.assert_array_equal(tp[23]["w_q"].numpy(),
                                  w_q.reshape(-1, w_q.shape[-1]).T)
    assert tp[23]["x_scale"].shape == (1,)
    assert tp[23]["x_scale"].dtype == torch.float32
    assert float(tp[23]["x_scale"]) == np.float32(2.5 / 127.0)
    assert "w" in tp[23] and "x_scale" not in tp[24]
    assert region_conv_indices(g) >= {0, 1, 23}
    assert max(region_conv_indices(g)) == 23


# ---------------------------------------------------------- conv block


@pytest.fixture(scope="module")
def convs():
    g = _quiet(CONV_CFG)
    npar = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=7))
    qp = tparams.quantize_conv_params(g, npar, min_ch=1, skip_heads=False)
    return g, qp


def _jax_acc(x_q, w_q, l):
    pad = jconv.darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x_q), jnp.asarray(w_q), (l.stride_y, l.stride_x), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("li", [0, 1, 2, 3])
def test_conv_block_int8_matches(convs, li, static):
    g, qp = convs
    l = g.layers[li]
    x = np.random.default_rng(li).normal(
        size=(2, l.h, l.w, l.c)).astype(np.float32)
    p = dict(qp[li])
    if static:
        p["x_scale"] = np.float32(1.3 * np.abs(x).max() / 127.0)
    tp = tparams.params_to_torch(g, [{}] * li + [p], "cpu")[li]

    # the quantized input and the int32 accumulator
    xs = p["x_scale"] if static else jqm.quantize_activations_int8(
        jnp.asarray(x))[1]
    jx_q = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / xs), -127,
                               127).astype(jnp.int8))
    scale = tp["x_scale"] if static else tqm.input_scale(torch.from_numpy(x))
    x_q = tqm.quantize_int8(torch.from_numpy(x), scale)
    np.testing.assert_array_equal(x_q.numpy(), jx_q)
    jacc = _jax_acc(jx_q, p["w_q"], l)
    pad = tconv.darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    cols = tqm.im2col_int8(x_q, l.size, l.size, (l.stride_y, l.stride_x),
                           pad, (l.out_h, l.out_w))
    acc = (cols.long() @ tp["w_q"].long().T).reshape(jacc.shape)
    np.testing.assert_array_equal(acc.numpy(), jacc)

    # pre-activation to the bit, then the block's output
    pre = tconv.conv2d_int8(torch.from_numpy(x), tp, size=l.size,
                            stride=(l.stride_y, l.stride_x), padding=pad,
                            out_hw=(l.out_h, l.out_w))
    jpre = jacc.astype(np.float32) * (np.float32(xs) * p["w_scale"]) + p["b"]
    np.testing.assert_array_equal(pre.numpy(), jpre)
    want = np.asarray(jconv.conv_block_int8(jnp.asarray(x), p, l,
                                            compute_dtype=jnp.float32))
    got = tconv.conv_block_int8(torch.from_numpy(x), tp, l).numpy()
    if l.activation == "mish":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


# --------------------------------------------------------- yolov4 slice


def _image(b=2, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("quantized,rtol", [(False, 1e-5), (True, 0.15)])
def test_calibration_matches_jax(yolo, quantized, rtol):
    """The probe forward records every conv's input range as JAX's does:
    at rtol 1e-5 on the float net (sum-order noise; 2.2e-6 measured); on
    the quantized net the probe runs the int8 convs and carries the
    slice's int8 noise (module docstring): rtol 0.15 (at most 5.1%
    measured over five pairs of frames)."""
    g, npar = yolo
    if quantized:
        npar = tparams.quantize_conv_params(g, npar)
    frames = [_image(seed=8), _image(seed=9)]
    got = tparams.calibrate_conv_input_scales(
        g, tparams.params_to_torch(g, npar, "cpu"), frames)
    want = jparams.calibrate_conv_input_scales(g, npar, frames)
    assert got.keys() == want.keys()
    assert len(got) == sum(l.kind == "convolutional" for l in g.layers)
    for i in want:
        np.testing.assert_allclose(got[i], want[i], rtol=rtol)


@pytest.fixture(scope="module")
def weights_path(yolo, tmp_path_factory):
    g, _ = yolo
    path = str(tmp_path_factory.mktemp("w") / "yolov4-64.weights")
    wio.save_weights(g, lively_params(g), path)
    return path


def _nets(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (jnetwork.Network.from_cfg(CFG, weights=path, int8=True),
                Network.from_cfg(CFG, weights=path, int8=True,
                                 device="cpu"))


@pytest.fixture(scope="module", params=["dynamic", "calibrated"])
def int8_run(request, weights_path, tmp_path_factory):
    """Both packages' int8 Networks from one weights file (calibrated: the
    port calibrates and saves, JAX loads the file), and the JAX hybrid
    forward of one batch with every conv_block_int8 call recorded."""
    jnet, tnet = _nets(weights_path)
    if request.param == "calibrated":
        path = tmp_path_factory.mktemp("c") / "scales.cache"
        tnet.calibrate_int8([_image(seed=8)])
        tnet.save_calibration(path)
        jnet.load_calibration(path)
    x = _image()
    recs = []
    orig = jconv.conv_block_int8

    def record(xin, p, l, **kw):
        y = orig(xin, p, l, **kw)
        recs.append((l.index, np.asarray(xin), np.asarray(y)))
        return y

    jconv.conv_block_int8 = record
    try:
        heads = jax_forward(jnet.graph, fused_bn=True, fuse_regions="hybrid",
                            region_interpret=True)(jnet.params, x)["heads"]
    finally:
        jconv.conv_block_int8 = orig
    return jnet, tnet, x, recs, [np.asarray(h) for h in heads]


def test_slice_int8_convs_match_jax(int8_run):
    """Every quantized conv of the yolov4-64 slice, fed the input JAX
    gave it: the port's conv_block_int8 output agrees with JAX's to 1 ulp
    (leaky) or rtol 1e-6 (mish), which holds only where x_q and the int32
    sums are equal (one int8 step moves an output by ~1e-3 of its
    scale).  Layer 23 runs inside the region (test_region_int8_step)."""
    jnet, tnet, _x, recs, _heads = int8_run
    assert [i for i, *_ in recs] == [
        i for i, p in enumerate(jnet.params) if "w_q" in p and i != 23]
    for i, p in enumerate(jnet.params):
        assert ("x_scale" in p) == ("x_scale" in tnet.params[i])
        if "x_scale" in p:
            assert tnet.params[i]["x_scale"].numpy().tobytes() == \
                np.float32(p["x_scale"]).tobytes()
    for i, xin, want in recs:
        l = jnet.graph.layers[i]
        got = tconv.conv_block_int8(torch.from_numpy(xin), tnet.params[i],
                                    l).numpy()
        if l.activation == "mish":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"layer {i}")
        else:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_region_int8_step_matches_jax(yolo):
    """The calibrated int8 step of the region remainder (layer 23, a 1x1
    over the route concat of slots 21 and 12) against JAX's packed int8
    step on the same slot tensors."""
    from darknet_tpu.ops.pallas import fused_region as jfr
    from darknet_tpu_torch.ops import fused_region as tfr

    g, npar = yolo
    qp = tparams.apply_conv_input_scales(
        tparams.quantize_conv_params(g, npar), {23: 3.1})
    jstep, tstep = (m.plan_graph_regions(g, stem=True)[0].steps[-1]
                    for m in (jfr, tfr))
    assert tstep.li == 23 and tstep.srcs == (21, 12)
    rng = np.random.default_rng(23)
    srcs = {s: rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
            for s in tstep.srcs}
    jslots = {s: jnp.asarray(v.reshape(2, 16, 8, 128))
              for s, v in srcs.items()}
    jfr._run_steps_xla(qp, jslots, [jstep], jnp.float32)
    want = np.asarray(jslots[23]).reshape(2, 16, 16, 128)
    tp = tparams.params_to_torch(g, qp, "cpu")
    slots = {s: torch.from_numpy(v) for s, v in srcs.items()}
    ws, bs = tfr.step_weights([tstep], tp, torch.float32)
    tfr.run_steps_plain([tstep], slots, ws, bs, torch.float32, tp)
    np.testing.assert_allclose(slots[23].numpy(), want, rtol=1e-6,
                               atol=1e-6)
    # without the scale the step stays in floating point
    del tp[23]["x_scale"]
    tfr.run_steps_plain([tstep], slots, ws, bs, torch.float32, tp)
    assert float(np.abs(slots[23].numpy() - want).max()) > 1e-4


def test_int8_serving_matches_hybrid(int8_run, monkeypatch):
    """Network.from_cfg(int8=True) against the JAX Network with the
    hybrid region plan (the JAX Network on the CPU plans no region, so
    make_forward is called with it here): heads at the int8 noise level
    (module docstring), and the served kept set equal to what JAX's
    serving program keeps from the port's heads."""
    jnet, tnet, x, _recs, jheads = int8_run
    with torch.inference_mode():
        heads = [h.numpy() for h in
                 tnet._fwd(tnet.params, torch.from_numpy(x))["heads"]]
    for a, b in zip(heads, jheads):
        np.testing.assert_allclose(a, b, rtol=0, atol=HEAD_ATOL)
        assert float(np.abs(a - b).mean()) < HEAD_MEAN_ATOL
    monkeypatch.setattr(jnetwork, "make_forward", lambda *a, **k: (
        lambda params, x: {"heads": [jnp.asarray(h) for h in heads]}))
    ref = jnet._device_detect_fn(2, 64, 64, 0.1, 0.3, 256)(jnet.params, x)
    tb, ov, probs = tnet.submit_detect_device(x, thresh=0.1, nms=0.3)
    slot = match_slots(tb.numpy(), ref[0])
    jtb, jov, jp = matched(ref, slot)
    np.testing.assert_allclose(ov.numpy(), jov, atol=1e-6)
    kept = set(zip(*np.nonzero(jp > 0)))
    assert len(kept) > 5
    assert set(zip(*np.nonzero(probs.numpy() > 0))) == kept
    np.testing.assert_allclose(tb.numpy(), jtb, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def region_int8_run(weights_path, tmp_path_factory):
    """Both packages' int8 Networks with region_int8: the port calibrates
    on one frame and saves, the JAX package loads the file; the JAX
    package's region_int8 forward of one batch (its Network on the CPU
    plans no region, so make_forward is called with the packed steps)."""
    jnet, tnet = _nets(weights_path)
    path = tmp_path_factory.mktemp("r") / "scales.cache"
    tnet.calibrate_int8([_image(seed=8)], region_int8=True)
    tnet.save_calibration(path)
    jnet.load_calibration(path, region_int8=True)
    x = _image()
    heads = jax_forward(jnet.graph, fused_bn=True, fuse_regions="xla")(
        jnet.params, x)["heads"]
    return jnet, tnet, x, [np.asarray(h) for h in heads]


def test_region_int8_quantizes_the_region(region_int8_run):
    """The 16 region convs without "w_q" are quantized per filter by
    quantize_conv_params' rule, and with the other 91 carry a calibrated
    scale; the regions are planned without the stem and run plain."""
    _jnet, tnet, _x, _h = region_int8_run
    g = tnet.graph
    scaled = [i for i, p in enumerate(tnet.params) if "x_scale" in p]
    assert len(scaled) == 107
    assert all("w_q" in tnet.params[i] for i in scaled)
    assert sorted(region_int8_convs(g) - {23}) == [
        0, 1, 2, 4, 5, 6, 8, 10, 11, 12, 14, 15, 16, 18, 19, 21]
    npar = tparams.fuse_conv_batchnorm(g, lively_params(g))
    want = jparams.quantize_conv_params(g, npar, min_ch=1)
    for i in region_int8_convs(g):
        w_q = want[i]["w_q"]
        np.testing.assert_array_equal(tnet.params[i]["w_q"].numpy(),
                                      w_q.reshape(-1, w_q.shape[-1]).T)
        np.testing.assert_array_equal(tnet.params[i]["w_scale"].numpy(),
                                      want[i]["w_scale"])
    plans = tnet._fwd.region_plans
    assert [(p.start, p.stop, p.stem) for p in plans.values()] == [
        (1, 23, False)]


def test_region_int8_convs_match_conv_block_int8(region_int8_run):
    """Layer 0 on the raw input and each step of the region, fed the
    tensor the port's own forward gave it: the step's int8 output equals
    `conv_block_int8`'s on that input (1 ulp after leaky, rtol 1e-6
    after mish: the activation is the same code, so in practice
    bitwise)."""
    from darknet_tpu_torch.ops import fused_region as tfr

    _jnet, tnet, x, _h = region_int8_run
    g, tp = tnet.graph, tnet.params
    plan = tnet._fwd.region_plans[1]
    y0 = tconv.conv_block_int8(torch.from_numpy(x), tp[0], g.layers[0])
    slots = {tfr.IN_SLOT: y0}
    n = 0
    for step in plan.steps:
        ws, bs = tfr.step_weights([step] if isinstance(step, tfr.ConvStep)
                                  else [], tp, torch.float32)
        tfr.run_steps_plain([step], slots, ws, bs, torch.float32, tp)
        if not isinstance(step, tfr.ConvStep):
            continue
        src = torch.cat([slots[s] for s in step.srcs], dim=-1)
        l = g.layers[step.li]
        want = tconv.conv_block_int8(src, tp[step.li], l).numpy()
        got = slots[step.out_slot].numpy()
        if l.activation == "mish":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"layer {step.li}")
        else:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        n += 1
    assert n == 16


def test_region_int8_serving_matches_jax(region_int8_run, monkeypatch):
    """The port's region_int8 heads against the JAX package's region_int8
    forward at the int8 noise level (module docstring), and the served
    kept set equal to what JAX's serving program keeps from the port's
    heads."""
    jnet, tnet, x, jheads = region_int8_run
    with torch.inference_mode():
        heads = [h.numpy() for h in
                 tnet._fwd(tnet.params, torch.from_numpy(x))["heads"]]
    for a, b in zip(heads, jheads):
        np.testing.assert_allclose(a, b, rtol=0, atol=HEAD_ATOL)
        assert float(np.abs(a - b).mean()) < HEAD_MEAN_ATOL
    monkeypatch.setattr(jnetwork, "make_forward", lambda *a, **k: (
        lambda params, x: {"heads": [jnp.asarray(h) for h in heads]}))
    ref = jnet._device_detect_fn(2, 64, 64, 0.1, 0.3, 256)(jnet.params, x)
    tb, ov, probs = tnet.submit_detect_device(x, thresh=0.1, nms=0.3)
    slot = match_slots(tb.numpy(), ref[0])
    jtb, jov, jp = matched(ref, slot)
    np.testing.assert_allclose(ov.numpy(), jov, atol=1e-6)
    kept = set(zip(*np.nonzero(jp > 0)))
    assert len(kept) > 5
    assert set(zip(*np.nonzero(probs.numpy() > 0))) == kept


def test_calibration_round_trip(weights_path, tmp_path):
    _, tnet = _nets(weights_path)
    with pytest.raises(ValueError):
        tnet.save_calibration(tmp_path / "none.cache")
    tnet.calibrate_int8([_image(seed=8)[0], _image(seed=9)])
    path = tmp_path / "scales.cache"          # no .npz suffix appended
    tnet.save_calibration(path)
    _, other = _nets(weights_path)
    other.load_calibration(path)
    scaled = [i for i, p in enumerate(tnet.params) if "x_scale" in p]
    assert len(scaled) == 91
    for i in scaled:
        assert torch.equal(other.params[i]["x_scale"],
                           tnet.params[i]["x_scale"])
    x = _image(seed=3)
    a = tnet.submit_detect_device(x, thresh=0.1)
    b = other.submit_detect_device(x, thresh=0.1)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    # region_int8 through the same file: 107 scales, equal triples
    tnet.calibrate_int8([_image(seed=8)[0], _image(seed=9)],
                        region_int8=True)
    tnet.save_calibration(path)
    _, other = _nets(weights_path)
    other.load_calibration(path, region_int8=True)
    scaled = [i for i, p in enumerate(tnet.params) if "x_scale" in p]
    assert len(scaled) == 107
    for i in scaled:
        assert torch.equal(other.params[i]["x_scale"],
                           tnet.params[i]["x_scale"])
        assert torch.equal(other.params[i]["w_q"], tnet.params[i]["w_q"])
    a = tnet.submit_detect_device(x, thresh=0.1)
    b = other.submit_detect_device(x, thresh=0.1)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    # a float network has no int8 weights to give the region convs
    fnet = Network.from_cfg(CFG, weights=weights_path, device="cpu")
    with pytest.raises(ValueError, match="int8=True"):
        fnet._apply_calibration({0: 1.0}, region_int8=True)
