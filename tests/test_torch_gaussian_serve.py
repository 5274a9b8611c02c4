"""Gaussian YOLOv3 served by darknet_tpu_torch against darknet_tpu on the
CPU: `model_zoo.gaussian_yolov3_cfg` at 64 px, full width (darknet53 +
FPN, 107 layers), 10 classes, f32, b=2.

Params: `spread_params` (`lively_params` with BN scales 1.2, as for
yolov3 in tests/test_torch_zoo.py, the sigma channels at fixed biases,
and each head conv scaled so that its objectness logits, entry 8, spread
by about 2 on the test frames); both packages get the same `.weights`.

Tolerances as tests/test_torch_zoo.py: heads at rtol 1e-4 / atol 1e-5;
the served triples after each port slot is matched to the JAX slot of
its candidate (objectness within 1e-5, equal kept sets, box centres
within 1e-5 and sizes at rtol 1e-4); the host path's detections in the
same order, with the same classes kept, probabilities and objectness
within 1e-5 and the sigmas (`Detection.uc`) at rtol 1e-6 (a logistic of
the same logit).  int8 as tests/test_torch_int8.py: every quantized conv
fed the input the JAX package gave it agrees to 1 f32 ulp (leaky), the
calibrated ranges byte for byte; the network quantizes 63 of its 75
convs (the three head convs excluded).
"""

import warnings

import numpy as np
import pytest
import torch

from darknet_tpu.nn.emit import make_forward as jax_forward
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu.ops import conv as jconv
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.ops import conv as tconv
from darknet_tpu_torch.weights import io as wio
from tests.test_torch_slice import assert_boxes_close, assert_serving_matches
from tests.torch_params import spread_params

torch.set_num_threads(2)
CFG = model_zoo.gaussian_yolov3_cfg(64, 64, classes=10)
E = 9 + 10
BN_SCALE = 1.2
INT8_CONVS = 63


def frames(b=2, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(CFG)
    assert [l.kind for l in g.heads()] == ["gaussian_yolo"] * 3
    path = str(tmp_path_factory.mktemp("w") / "gaussian-64.weights")
    wio.save_weights(g, spread_params(g, frames(), BN_SCALE), path)
    return path


def nets(path, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JaxNetwork.from_cfg(CFG, weights=path, **kw),
                Network.from_cfg(CFG, weights=path, device="cpu", **kw))


def test_heads_and_serving_match_jax(weights):
    jnet, tnet = nets(weights)
    x = frames()
    got = tnet._fwd(tnet.params, torch.from_numpy(x))
    want = jax_forward(jnet.graph, fused_bn=True)(jnet.params, x)
    assert len(got["heads"]) == len(want["heads"]) == 3
    for a, b in zip(got["heads"], want["heads"]):
        b = np.asarray(b)
        assert float(np.std(b.reshape(*b.shape[:3], 3, E)[..., 8])) > 0.05
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)
    for thresh, nms in ((0.25, 0.45), (0.1, 0.3)):
        ref = jnet._device_detect_fn(2, 64, 64, thresh, nms, 256)(
            jnet.params, x)
        port = tnet.submit_detect_device(x, thresh=thresh, nms=nms,
                                         top_k=256)
        assert len(port) == 3
        assert_serving_matches(port, ref)


@pytest.mark.parametrize("thresh,nms", [(0.25, 0.45), (0.1, 0.3)])
def test_host_detections_match_jax(weights, thresh, nms):
    jnet, tnet = nets(weights)
    x = frames(seed=1)
    want = jnet.detect_batch(x, thresh=thresh, nms=nms)
    got = tnet.detect_batch(x, thresh=thresh, nms=nms)
    assert [len(d) for d in got] == [len(d) for d in want]
    assert sum(len(d) for d in got) > 5
    for dt, dj in zip(got, want):
        for a, b in zip(dt, dj):
            assert_boxes_close(np.asarray(a.bbox), np.asarray(b.bbox))
            assert np.array_equal(a.prob > 0, b.prob > 0)
            np.testing.assert_allclose(a.prob, b.prob, rtol=0, atol=1e-5)
            assert abs(a.objectness - b.objectness) <= 1e-5
            assert a.uc.shape == (4,)
            np.testing.assert_allclose(a.uc, b.uc, rtol=1e-6)
    # the reference-order decode carries uc; the device triple does not
    heads, dec = tnet.forward_heads(x)
    assert len(heads) == 3 and dec[3].shape == (2, dec[0].shape[1], 4)


@pytest.fixture(scope="module", params=["dynamic", "calibrated"])
def int8_run(request, weights, tmp_path_factory):
    """Both packages' int8 Networks from one weights file (calibrated: the
    port calibrates and saves, JAX loads the file), and the JAX hybrid
    forward of one batch with every conv_block_int8 call recorded."""
    jnet, tnet = nets(weights, int8=True)
    if request.param == "calibrated":
        path = tmp_path_factory.mktemp("c") / "scales.cache"
        tnet.calibrate_int8([frames(seed=8)])
        tnet.save_calibration(path)
        jnet.load_calibration(path)
    recs = []
    orig = jconv.conv_block_int8

    def record(xin, p, l, **kw):
        y = orig(xin, p, l, **kw)
        recs.append((l.index, np.array(xin), np.asarray(y)))
        return y

    jconv.conv_block_int8 = record
    try:
        jax_forward(jnet.graph, fused_bn=True, fuse_regions="hybrid",
                    region_interpret=True)(jnet.params, frames())
    finally:
        jconv.conv_block_int8 = orig
    return jnet, tnet, recs


def test_int8_convs_match_jax(int8_run):
    """Every quantized conv of Gaussian YOLOv3, fed the input JAX gave
    it: the port's conv_block_int8 output within 1 ulp of JAX's.  Layer
    12 runs inside the region's strided remainder (in floating point
    there, or int8 with a calibrated scale, as yolov4's layer 23)."""
    jnet, tnet, recs = int8_run
    quantized = [i for i, p in enumerate(tnet.params) if "w_q" in p]
    assert len(quantized) == INT8_CONVS
    assert not {l.index - 1 for l in tnet.graph.heads()} & set(quantized)
    assert [i for i, *_ in recs] == [i for i in quantized if i != 12]
    for i, p in enumerate(jnet.params):
        assert ("x_scale" in p) == ("x_scale" in tnet.params[i])
        if "x_scale" in p:
            assert tnet.params[i]["x_scale"].numpy().tobytes() == \
                np.float32(p["x_scale"]).tobytes()
    for i, xin, want in recs:
        got = tconv.conv_block_int8(torch.from_numpy(xin), tnet.params[i],
                                    jnet.graph.layers[i]).numpy()
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    tb, _ov, _probs = tnet.submit_detect_device(frames(), thresh=0.1)
    assert tb.shape == (2, 252, 4) and torch.isfinite(tb).all()
