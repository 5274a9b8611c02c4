"""`Network.resize` of darknet_tpu_torch against darknet_tpu's on the CPU:
yolov4-tiny (two regions) and chip_smoke.py's narrow Gaussian graph (a
region with the stem, two [Gaussian_yolo] heads), 64 -> 96 and 96 -> 64
px, the same `.weights` file on both sides.

* The resized network's heads equal those of a network built directly at
  the new size from the same file, bitwise (the same ops on the same
  values), and JAX's resized network's at rtol 1e-4 / atol 1e-5 (as
  tests/test_torch_zoo.py).
* Its region plans are made anew for the new size and equal the fresh
  network's; the kernel's packed tables are cached per plan
  (`ops/cuda/fused_region._prepared`), so a plan of another size never
  finds the table of the old one, although both share the weights.
* The same dims return the network itself; a network without cfg text
  raises ValueError.
* A calibrated int8 network resized keeps its int8 weights and scales,
  serves, and still saves its calibration (the port's twin of
  tests/test_int8.py::test_int8_calibration_survives_resize).
"""

import warnings

import numpy as np
import pytest
import torch

from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.ops.cuda import fused_region as kfr
from darknet_tpu_torch.weights import io as wio
from tests.torch_params import lively_params
from torch_params import chip_smoke

torch.set_num_threads(2)
CS = chip_smoke()
CFGS = {"yolov4-tiny": lambda px: model_zoo.MODELS["yolov4-tiny"](px, px),
        "narrow-gaussian": lambda px: CS.GAUSSIAN_TRAIN_CFG.replace(
            "width=64\nheight=64", f"width={px}\nheight={px}")}


def quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    out = {}
    for name, cfg in CFGS.items():
        g = quiet(build_graph, cfg(64))
        path = str(tmp_path_factory.mktemp("w") / f"{name}.weights")
        wio.save_weights(g, lively_params(g, head_gain={}), path)
        out[name] = path
    return out


def frames(px, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (2, px, px, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("src,dst", [(64, 96), (96, 64)])
def test_resize_matches_fresh_and_jax(weights, name, src, dst):
    path = weights[name]
    net = quiet(Network.from_cfg, CFGS[name](src), weights=path,
                device="cpu")
    fresh = quiet(Network.from_cfg, CFGS[name](dst), weights=path,
                  device="cpu")
    jnet = quiet(JaxNetwork.from_cfg, CFGS[name](src), weights=path)
    resized = net.resize(dst, dst)
    jresized = jnet.resize(dst, dst)
    assert resized is not net and (resized.net.w, resized.net.h) == (dst,
                                                                     dst)
    assert resized.params is net.params
    assert resized.fuse_regions == net.fuse_regions == "hybrid"
    assert (resized.fused, resized.train, resized.compute_dtype,
            resized.device, resized.seen) == (
        net.fused, net.train, net.compute_dtype, net.device, net.seen)

    plans, want = resized._fwd.region_plans, fresh._fwd.region_plans
    assert plans and plans.keys() == want.keys()
    for a in plans:
        assert (plans[a].h, plans[a].w2) == (want[a].h, want[a].w2)
        assert plans[a].h != net._fwd.region_plans[a].h

    x = frames(dst)
    heads, dec = resized.forward_heads(x)
    fheads, fdec = fresh.forward_heads(x)
    jheads, _jdec = jresized.forward_heads(x)
    assert len(heads) == len(jheads) == 2
    for a, b, c in zip(heads, fheads, jheads):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)
    assert (dec[3] is None) == (name == "yolov4-tiny")
    for a, b in zip(dec, fdec):
        assert (a is None and b is None) or torch.equal(a, b)
    for u, v in zip(resized.submit_detect_device(x, thresh=0.1),
                    fresh.submit_detect_device(x, thresh=0.1)):
        assert torch.equal(u, v)


def test_packed_tables_are_per_plan(weights):
    """The kernel's table and packed weights of the resized plan, not
    the original plan's, on the same weight tensors (prepared on the CPU
    here: the table and the packing are torch code)."""
    from darknet_tpu_torch.ops import fused_region as fr

    net = quiet(Network.from_cfg, CFGS["narrow-gaussian"](64),
                weights=weights["narrow-gaussian"], device="cpu")
    big = net.resize(96, 96)
    tables = []
    for n in (net, big):
        sub, _k = fr.hybrid_prefix(n._fwd.region_plans[0])
        ws, bs = fr.step_weights(sub.steps, n.params, torch.bfloat16)
        kp, tab, _w, _b = kfr._prepared(sub, ws, bs, torch.bfloat16, "cpu")
        assert (kp.table[3], kp.table[4]) == (sub.h, 2 * sub.w2)
        assert kp.table.tolist() == kfr.kernel_plan(sub, 2).table.tolist()
        tables.append(tab)
    assert tables[0].shape != tables[1].shape or not torch.equal(*tables)


def test_resize_same_dims_and_no_cfg(weights):
    net = quiet(Network.from_cfg, CFGS["narrow-gaussian"](64),
                weights=weights["narrow-gaussian"], device="cpu")
    assert net.resize(64, 64) is net
    bare = Network(net.graph, net.params, device="cpu")
    with pytest.raises(ValueError):
        bare.resize(96, 96)


def test_int8_calibration_survives_resize(tmp_path):
    cfg = ("[net]\nbatch=1\nsubdivisions=1\nwidth=32\nheight=32\n"
           "channels=3\n"
           "[convolutional]\nfilters=128\nsize=3\nstride=2\npad=1\n"
           "activation=leaky\n"
           "[convolutional]\nbatch_normalize=1\nfilters=128\nsize=3\n"
           "stride=2\npad=1\nactivation=mish\n"
           "[convolutional]\nfilters=20\nsize=1\nactivation=linear\n"
           "[yolo]\nmask=0,1\nnum=2\nclasses=5\nanchors=10,14, 23,27\n")
    net = Network.from_cfg(cfg, int8=True, seed=2, device="cpu")
    rng = np.random.default_rng(0)
    net.calibrate_int8(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    net2 = net.resize(64, 64)
    assert any("w_q" in p for p in net2.params)
    assert all(torch.equal(a["x_scale"], b["x_scale"])
               for a, b in zip(net.params, net2.params) if "x_scale" in a)
    net2.save_calibration(str(tmp_path / "c.cache"))   # must not raise
    other = Network.from_cfg(cfg, int8=True, seed=2, device="cpu")
    other.load_calibration(str(tmp_path / "c.cache"))
    assert all(torch.equal(a["x_scale"], b["x_scale"])
               for a, b in zip(net.params, other.params) if "x_scale" in a)
    d = net2.detect_batch_device(
        rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32),
        thresh=0.05, top_k=16)
    assert len(d[0]) > 0
