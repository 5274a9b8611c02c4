"""The yolov4 serving slice, darknet_tpu_torch against darknet_tpu on the
CPU: yolov4 at full width and 64 px, b=2, f32.

At random init a deep yolov4 damps its heads to sigmoid(~1e-6), where
every score ties.  The params here (`tests/torch_params.lively_params`)
spread the head logits over O(1); both packages get the same numpy arrays.

Tolerances: heads at rtol 1e-4 / atol 1e-5 (as tests/test_fused_region.py;
the head logits carry about 1e-5 of their spread in f32 sum-order noise
through 100 layers); served box centres within 1e-5; box sizes, which
are exp() of a head logit times an anchor of up to 7 net widths at 64 px,
at rtol 1e-4; the kept (image, candidate, class) sets equal once each
port slot is matched to the JAX slot of its candidate: two candidates of
image 1 tie exactly in f32 objectness, and the two packages' sum-order
noise may split the tie either way (`torch_params.match_slots`).
"""

import warnings

import numpy as np
import pytest
import torch

from darknet_tpu import model_zoo
from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as jparams
from darknet_tpu.nn.emit import make_forward as jax_forward
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu.weights import io as wio
from darknet_tpu_torch import Network
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.nn.emit import make_forward
from tests.torch_params import lively_params, match_slots, matched

torch.set_num_threads(2)
CFG = model_zoo.yolov4_cfg(64, 64)


def _graph():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(CFG)


def _image(b=2, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(jax Network, port Network, .weights path) from one weights file."""
    g = _graph()
    path = str(tmp_path_factory.mktemp("w") / "yolov4-64.weights")
    wio.save_weights(g, lively_params(g), path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet = JaxNetwork.from_cfg(CFG, weights=path)
        tnet = Network.from_cfg(CFG, weights=path, device="cpu")
    return jnet, tnet, path


def test_heads_match_hybrid_region():
    g = _graph()
    npar = jparams.fuse_conv_batchnorm(g, lively_params(g))
    x = _image()
    want = jax_forward(g, fused_bn=True, fuse_regions="hybrid",
                       region_interpret=True)(npar, x)
    got = make_forward(g)(tparams.params_to_torch(g, npar, "cpu"),
                          torch.from_numpy(x))
    assert len(got["heads"]) == len(want["heads"]) == 3
    for a, b in zip(got["heads"], want["heads"]):
        b = np.asarray(b)
        assert float(np.std(b[..., 4])) > 0.05       # not saturated
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["output"].numpy(),
                               np.asarray(want["output"]),
                               rtol=1e-4, atol=1e-5)


def test_region_modes_agree():
    g = _graph()
    tp = tparams.params_to_torch(
        g, tparams.fuse_conv_batchnorm(g, lively_params(g)), "cpu")
    x = torch.from_numpy(_image())
    a = make_forward(g)(tp, x)["heads"]
    b = make_forward(g, fuse_regions="plain")(tp, x)["heads"]
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-5)


def assert_boxes_close(a, b):
    np.testing.assert_allclose(a[..., :2], b[..., :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(a[..., 2:], b[..., 2:], rtol=1e-4, atol=1e-5)


def _kept(probs):
    return set(zip(*np.nonzero(np.asarray(probs) > 0)))


def assert_serving_matches(port, ref):
    """A served port triple against a reference triple, once each port
    slot is matched to the reference slot of its candidate
    (`match_slots`): objectness within 1e-5, then the kept (image, slot,
    class) sets equal and the boxes close."""
    ttb, tov, tp = (t.float().cpu().numpy() for t in port)
    slot = match_slots(ttb, ref[0])
    jtb, jov, jp = matched(ref, slot)
    np.testing.assert_allclose(tov, jov, atol=1e-5)
    kept = _kept(jp)
    assert len(kept) > 5
    assert _kept(tp) == kept
    assert_boxes_close(ttb, jtb)


@pytest.mark.parametrize("thresh,nms", [(0.25, 0.45), (0.1, 0.3)])
def test_serving_matches_device_detect(nets, thresh, nms):
    jnet, tnet, _ = nets
    x = _image()
    jtb, jov, jp = jnet._device_detect_fn(2, 64, 64, thresh, nms, 256)(
        jnet.params, x)
    ttb, tov, tp = tnet.submit_detect_device(x, thresh=thresh, nms=nms,
                                             top_k=256)
    assert_serving_matches((ttb, tov, tp), (jtb, jov, jp))
    dets = Network.device_out_to_dets(ttb, tov, tp)
    jdets = JaxNetwork.device_out_to_dets(jtb, jov, jp)
    assert [len(d) for d in dets] == [len(d) for d in jdets]


def test_uint8_ingest(nets):
    """uint8 frames normalize on the device: the same kept set as the
    host-divided f32 frames, boxes within 1 ulp-scale."""
    _, tnet, _ = nets
    frames = (np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3))
              * 255).astype(np.uint8)
    a = tnet.submit_detect_device(frames, thresh=0.25)
    b = tnet.submit_detect_device(frames.astype(np.float32) / 255.0,
                                  thresh=0.25)
    assert _kept(a[2].numpy()) == _kept(b[2].numpy())
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-6)


def test_detect_after_weights_round_trip(nets):
    jnet, tnet, _ = nets
    x = _image(b=1, seed=3)[0]
    want = jnet.detect(x, thresh=0.25, nms=0.45)
    got = tnet.detect(x, thresh=0.25, nms=0.45)
    assert len(want) > 0 and len(got) == len(want)
    for a, b in zip(got, want):
        assert_boxes_close(np.asarray(a.bbox), np.asarray(b.bbox))
        np.testing.assert_allclose(a.prob, b.prob, atol=1e-5)
        assert a.best_class == b.best_class


def test_detect_batch_and_predict(nets):
    jnet, tnet, _ = nets
    x = _image(seed=4)
    want = jnet.detect_batch(x, thresh=0.25)
    got = tnet.detect_batch(x, thresh=0.25)
    assert [len(d) for d in got] == [len(d) for d in want]
    dev = tnet.detect_batch(x, thresh=0.25, use_device_nms=True)
    assert [len(d) for d in dev] == [len(d) for d in want]
    np.testing.assert_allclose(tnet.predict(x), jnet.predict(x),
                               rtol=1e-4, atol=1e-5)
    heads, dec = tnet.forward_heads(x)
    jheads, jdec = jnet.forward_heads(x)
    assert_boxes_close(dec[0].numpy(), np.asarray(jdec[0]))
    for a, b in zip(dec[1:3], jdec[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_input_shape_is_checked(nets):
    _, tnet, _ = nets
    with pytest.raises(ValueError):
        tnet.detect(np.zeros((32, 32, 3), np.float32))
    with pytest.raises(ValueError):
        tnet.submit_detect_device(torch.zeros(1, 32, 32, 3))
