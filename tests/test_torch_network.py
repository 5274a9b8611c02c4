"""The port's `Network` remainders against darknet_tpu's on the CPU:
`from_cfg(train=, clear=, fuse=)`, `save_weights`, `curr_iter`,
`detections_to_json`, serving with unfolded BN and the training forward
of a train=True network.

Tolerances: `.weights` files and the JSON text are byte-equal; served
boxes and probabilities with unfolded BN within 1e-5 of the folded
network's (f32: BN applied after the conv rounds differently from the
folded weights, ~1e-7 of the head's scale through yolov3-tiny's 24
layers); heads against the JAX package at rtol 1e-4 / atol 1e-5, as in
tests/test_torch_slice.py.
"""

import pathlib
import re
import warnings

import numpy as np
import pytest
import torch

from darknet_tpu import model_zoo as jzoo
from darknet_tpu.nn.network import Detection as JDetection
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu.nn.network import detections_to_json as jdetections_to_json
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.data import image as timage
from darknet_tpu_torch.nn.network import Detection, detections_to_json

torch.set_num_threads(2)
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "yolov3-tiny.cfg"
TINY64 = model_zoo.yolov3_tiny_cfg(64, 64)


def quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def frames(b=2, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 64, 64, 3)).astype(np.float32)


def test_save_weights_round_trip(tmp_path):
    """The verify skill's drive on the port: from_cfg(train=True,
    fuse=False), save_weights (byte-equal to the JAX package's), then a
    reload that folds BN and serves as the JAX reload does."""
    cfg = str(FIXTURE)
    tnet = quiet(Network.from_cfg, cfg, train=True, fuse=False, seed=42,
                 device="cpu")
    jnet = quiet(JaxNetwork.from_cfg, cfg, train=True, fuse=False, seed=42)
    assert (tnet.fused, tnet.train) == (jnet.fused, jnet.train) == (
        False, True)
    assert tnet._cfg_text == jnet._cfg_text == FIXTURE.read_text()
    tnet.seen = jnet.seen = 640
    tpath, jpath = tmp_path / "t.weights", tmp_path / "j.weights"
    tnet.save_weights(str(tpath))
    jnet.save_weights(str(jpath))
    assert tpath.read_bytes() == jpath.read_bytes()
    tnet.save_weights(str(tmp_path / "t10.weights"), cutoff=10)
    jnet.save_weights(str(tmp_path / "j10.weights"), cutoff=10)
    assert (tmp_path / "t10.weights").read_bytes() == \
        (tmp_path / "j10.weights").read_bytes()

    tload = quiet(Network.from_cfg, cfg, weights=str(tpath), device="cpu")
    jload = quiet(JaxNetwork.from_cfg, cfg, weights=str(jpath))
    assert tload.fused and tload.seen == jload.seen == 640
    assert tload.curr_iter == jload.curr_iter == 640
    img = np.zeros((480, 640, 3), np.float32)
    img[100:300, 200:400] = 0.7
    x = timage.resize_image_cv(img, tload.net.w, tload.net.h)
    heads, _ = tload.forward_heads(x)
    jheads, _ = jload.forward_heads(x)
    for a, b in zip(heads, jheads):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    got = tload.detect(x, thresh=0.01, nms=0.45)
    want = jload.detect(x, thresh=0.01, nms=0.45)
    assert len(got) == len(want) > 0


@pytest.mark.parametrize("clear", [False, True])
def test_clear_and_curr_iter(tmp_path, clear):
    net = quiet(Network.from_cfg, TINY64, train=True, fuse=False,
                device="cpu")
    net.seen = 64 * 30
    path = str(tmp_path / "w.weights")
    net.save_weights(path)
    for train in (False, True):
        kw = dict(weights=path, clear=clear, train=train)
        tnet = quiet(Network.from_cfg, TINY64, device="cpu", **kw)
        jnet = quiet(JaxNetwork.from_cfg, TINY64, **kw)
        assert tnet.seen == jnet.seen == (0 if clear else 64 * 30)
        assert tnet.curr_iter == jnet.curr_iter == \
            tnet.seen // tnet.net.optimizer_batch


def test_unfused_serving_matches_fused(tmp_path):
    """fuse=False serves with BN from the rolling statistics (no region,
    no stem fold) and keeps what the folded network keeps."""
    rng = np.random.default_rng(3)
    net = quiet(Network.from_cfg, TINY64, train=True, fuse=False,
                device="cpu")
    for p in net.params:
        if "scales" in p:          # non-trivial rolling statistics
            n = p["scales"].shape[0]
            p["scales"] = torch.from_numpy(rng.uniform(0.8, 1.6, n)
                                           .astype(np.float32))
            p["mean"] = torch.from_numpy(rng.normal(0, 0.1, n)
                                         .astype(np.float32))
            p["var"] = torch.from_numpy(rng.uniform(0.5, 2, n)
                                        .astype(np.float32))
    path = str(tmp_path / "w.weights")
    net.save_weights(path)
    unfused = quiet(Network.from_cfg, TINY64, weights=path, fuse=False,
                    device="cpu")
    fused = quiet(Network.from_cfg, TINY64, weights=path, device="cpu")
    assert not unfused.fused and not unfused._fwd.region_plans
    x = frames()
    a = unfused.submit_detect_device(x, thresh=0.1)
    b = fused.submit_detect_device(x, thresh=0.1)
    assert (a[2] > 0).sum() > 5
    assert torch.equal(a[2] > 0, b[2] > 0)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-5)
    jnet = quiet(JaxNetwork.from_cfg, TINY64, weights=path, fuse=False)
    jheads, _ = jnet.forward_heads(x)
    for u, v in zip(unfused.forward_heads(x)[0], jheads):
        np.testing.assert_allclose(u, np.asarray(v), rtol=1e-4, atol=1e-5)


def test_train_network_forward_matches_jax():
    """A train=True network runs the training forward (BN from the batch
    statistics), as the JAX package's does."""
    tnet = quiet(Network.from_cfg, TINY64, train=True, seed=5, device="cpu")
    jnet = quiet(JaxNetwork.from_cfg, TINY64, train=True, seed=5)
    x = frames(seed=6)
    np.testing.assert_allclose(tnet.predict(x), np.asarray(jnet.predict(x)),
                               rtol=1e-4, atol=1e-5)


def test_fused_params_refuse_to_save(tmp_path):
    net = quiet(Network.from_cfg, TINY64, device="cpu")
    with pytest.raises(ValueError, match="fuse=False"):
        net.save_weights(str(tmp_path / "w.weights"))
    with pytest.raises(ValueError, match="int8"):
        quiet(Network.from_cfg, TINY64, fuse=False, int8=True, device="cpu")


@pytest.mark.parametrize("names,filename", [
    (None, None), (["person", "dont_show_me", "car"], "a.png")])
def test_detections_to_json(names, filename):
    rng = np.random.default_rng(2)
    dets = []
    for _ in range(4):
        prob = (rng.uniform(0, 1, 3) * (rng.uniform(0, 1, 3) > 0.4)).astype(
            np.float32)
        box = tuple(float(v) for v in rng.uniform(0.1, 0.9, 4))
        dets.append((box, float(prob.max()), prob))
    got = detections_to_json([Detection(*d) for d in dets], frame_id=3,
                             names=names, filename=filename)
    want = jdetections_to_json([JDetection(*d) for d in dets], frame_id=3,
                               names=names, filename=filename)
    assert got == want and '"objects"' in got


def test_shape_hint_names_a_port_function():
    """The wrong-shape error names a resize function the port has."""
    net = quiet(Network.from_cfg, jzoo.yolov3_tiny_cfg(64, 64), device="cpu")
    with pytest.raises(ValueError) as err:
        net.detect(np.zeros((32, 48, 3), np.float32))
    mod, fn = re.search(r"\((darknet_tpu_torch[\w.]*)\.(\w+)\)",
                        str(err.value)).groups()
    import importlib

    resize = getattr(importlib.import_module(mod), fn)
    assert resize(np.zeros((32, 48, 3), np.float32), 64, 64).shape == (
        64, 64, 3)
