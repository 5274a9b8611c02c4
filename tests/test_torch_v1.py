"""YOLOv1 in darknet_tpu_torch against darknet_tpu on the CPU: the
[detection] head's decode, truth encoding and delta, the [cost] layer,
chip_smoke.py's narrow YOLOv1 (NARROW_V1_CFG: conv s2, maxpool, conv, a
stride-2 conv, [local] 3x3, [dropout], [connected] with and without BN,
[detection] with sqrt and rescore) served and stepped, the Network's
behaviour on a v1 head, the CHW order of a [connected] layer's weights in
a `.weights` file, the training params' layouts, and the trainer drawing
its dropout masks from its own checkpointed generator.

Tolerances:
* decode, truth encoding: exact (the same f32 operations);
* the [detection] delta and [cost]: rtol 1e-6 with atol 1e-6 of the
  delta's scale (the IoU and RMSE sum in another order);
* served heads: f32 within 1e-5 of the heads' scale (max |head|); bf16
  within 2^-7 of it (one bf16 ulp: the packages round a conv's f32 sum
  to bf16 once each, in another order, and the [local] and [connected]
  products carry such a difference on);
* the `.weights` file the port saves: byte-equal to the JAX package's;
* training steps (f32, rng=None / generator=None, burn_in 0), each of
  five taken from the JAX package's state before it: updates, momentum
  and rolling statistics within 1e-4 of the largest change, or within 3
  times what a 1e-7 relative change of the input moves the JAX step
  (measured: at most 3e-5 of the scale); costs within 1e-5, the loss,
  match count and mean IoU within 1e-4 (the IoU of a box that moved by
  the noise).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.nn.network import Network as JNetwork
from darknet_tpu.ops import detection_v1 as jv1
from darknet_tpu.train.step import init_opt_state as jinit
from darknet_tpu.train.step import make_train_step as jstep
from darknet_tpu.weights import io as jwio
from darknet_tpu_torch import Network
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.ops import detection_v1 as tv1
from darknet_tpu_torch.train import step as tstep
from darknet_tpu_torch.train.step import make_train_step
from darknet_tpu_torch.train.trainer import DetectorTrainer
from tests.test_torch_train_step import CS, to_numpy

torch.set_num_threads(2)

CFG = CS.NARROW_V1_CFG
RTOL = 1e-5
BF16_ULP = 2.0 ** -7
STEPS = 5
STEP_TOL = 1e-4
YARDSTICK = 3.0

HEAD = """[net]
width=112
height=112
channels=3
[connected]
output={outputs}
activation=linear
[detection]
classes=3
coords=4
rescore={rescore}
side=4
num=2
sqrt={sqrt}
forced={forced}
object_scale=1
noobject_scale=.5
class_scale=1
coord_scale=5
"""


def _t(a):
    return torch.from_numpy(np.array(a))


def _quiet(build, cfg, train=False):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build(cfg, train=train)


def _heads(sqrt=1, rescore=1, forced=0):
    """The [detection] layer of HEAD from both builders: (JAX, port)."""
    cfg = HEAD.format(outputs=4 * 4 * 13, sqrt=sqrt, rescore=rescore,
                      forced=forced)
    return (_quiet(jbuild, cfg, True).layers[1],
            _quiet(tbuild, cfg, True).layers[1])


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _boxes(rng, b, t, classes):
    """(b, t, 5) box lists: the first rows filled, a box pair sharing a
    cell, one on the far edge (x = y = 1), then padding."""
    y = np.zeros((b, t, 5), np.float32)
    for i in range(b):
        n = int(rng.integers(2, t - 1))
        for k in range(n):
            w, h = rng.uniform(0.05, 0.5, 2)
            y[i, k] = [rng.uniform(0.01, 0.99), rng.uniform(0.01, 0.99), w, h,
                       rng.integers(0, classes)]
        y[i, 1, :2] = y[i, 0, :2] + 0.01        # same cell as box 0
        y[i, n - 1, :2] = 1.0
    return y


# ------------------------------------------------------------ the head

@pytest.mark.parametrize("sqrt", [0, 1])
def test_detection_decode(sqrt):
    jl, tl = _heads(sqrt=sqrt)
    flat = np.random.default_rng(sqrt).normal(size=(3, jl.inputs)).astype(
        np.float32)
    want = jv1.detection_decode(jnp.asarray(flat), jl)
    got = tv1.detection_decode(_t(flat), tl)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_encode_v1_truth():
    jl, tl = _heads()
    y = _boxes(np.random.default_rng(0), 4, 9, 3)
    for i in range(4):
        np.testing.assert_array_equal(tv1.encode_v1_truth(y[i], tl),
                                      jv1.encode_v1_truth(y[i], jl))
    want = jv1.encode_v1_truth_batch(jnp.asarray(y), jl)
    got = tv1.encode_v1_truth_batch(_t(y), tl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[2],
                                  jv1.encode_v1_truth(y[2], jl))


@pytest.mark.parametrize("sqrt,rescore,forced", [(1, 1, 0), (0, 0, 0),
                                                 (1, 0, 1)])
def test_detection_head_delta(sqrt, rescore, forced):
    jl, tl = _heads(sqrt, rescore, forced)
    rng = np.random.default_rng(sqrt + 2 * rescore + 4 * forced)
    flat = rng.uniform(0.05, 0.9, (4, jl.inputs)).astype(np.float32)
    grid = np.asarray(jv1.encode_v1_truth_batch(
        jnp.asarray(_boxes(rng, 4, 9, 3)), jl))
    wd, wc, wm = jv1.detection_head_delta(jnp.asarray(flat),
                                          jnp.asarray(grid), jl)
    gd, gc, gm = tv1.detection_head_delta(_t(flat), _t(grid), tl)
    _close(gd, wd, 1e-6)
    np.testing.assert_allclose(float(gc), float(wc), rtol=1e-6)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


def test_detection_delta_given_the_jax_random_best():
    """The reference's early-training random responsible box (random=1,
    seen < 64000): the JAX package draws it from rng_best; the port takes
    the same draw as `best`."""
    jl, tl = _heads()
    jl, tl = (dataclasses.replace(jl, random=1.0),
              dataclasses.replace(tl, random=1.0))
    rng = np.random.default_rng(5)
    flat = rng.uniform(0.05, 0.9, (2, jl.inputs)).astype(np.float32)
    grid = np.asarray(jv1.encode_v1_truth_batch(
        jnp.asarray(_boxes(rng, 2, 9, 3)), jl))
    key = jax.random.PRNGKey(7)
    best = np.asarray(jax.random.randint(key, (2, 16), 0, jl.num))
    wd, wc, _ = jv1.detection_head_delta(jnp.asarray(flat), jnp.asarray(grid),
                                         jl, seen=0, rng_best=key)
    gd, gc, _ = tv1.detection_head_delta(_t(flat), _t(grid), tl,
                                         best=_t(best))
    _close(gd, wd, 1e-6)
    np.testing.assert_allclose(float(gc), float(wc), rtol=1e-6)


@pytest.mark.parametrize("kind", ["sse", "smooth", "masked"])
def test_cost_layer(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 50)).astype(np.float32) * 2
    t = rng.normal(size=(3, 50)).astype(np.float32) * 2
    t[:, ::5] = tv1.SECRET_NUM
    wc, wd = jv1.cost_layer(jnp.asarray(x), jnp.asarray(t), kind)
    gc, gd = tv1.cost_layer(_t(x), _t(t), kind)
    _close(gd, wd, 1e-6)
    np.testing.assert_allclose(float(gc), float(wc), rtol=1e-6)


def test_step_head_deltas_as_jax():
    """The step's per-kind deltas (`train/step.HEAD_DELTA`) against the JAX
    step's `head_delta` on the same raw head and box lists."""
    from darknet_tpu.train.step import head_delta

    jg, tg = _quiet(jbuild, CFG, True), _quiet(tbuild, CFG, True)
    jl, tl = jg.layers[-1], tg.layers[-1]
    rng = np.random.default_rng(4)
    raw = rng.uniform(0.05, 0.9, (4, 1, 1, jl.inputs)).astype(np.float32)
    y = _boxes(rng, 4, jl.max_boxes, jl.classes)
    wd, wc, wm = head_delta(jnp.asarray(raw), jnp.asarray(y), jl, jg.net,
                            None, 0)
    gd, gc, gm = tstep.HEAD_DELTA["detection"](_t(raw), _t(y), tl, 64, 64)
    assert gd.shape == raw.shape
    _close(gd, wd, 1e-6)
    np.testing.assert_allclose(float(gc), float(wc), rtol=1e-6)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


# ------------------------------------------------ the narrow YOLOv1

def _weights(tmp_path, cfg=CFG, seed=0):
    """A .weights file of the JAX package's init with BN scales 1.5 and
    moved rolling statistics."""
    g = _quiet(jbuild, cfg)
    p = jparams.init_params(g, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for d in p:
        if "scales" in d:
            d["scales"] = d["scales"] * np.float32(1.5)
            d["mean"] = rng.normal(size=d["mean"].shape).astype(
                np.float32) * 0.1
            d["var"] = rng.uniform(0.5, 1.5, d["var"].shape).astype(
                np.float32)
    path = str(tmp_path / "v1.weights")
    jwio.save_weights(g, p, path)
    return path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_v1_serves_as_jax(tmp_path, dtype):
    path = _weights(tmp_path)
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jn = JNetwork.from_cfg(CFG, weights=path, compute_dtype=jd)
        tn = Network.from_cfg(CFG, weights=path, device="cpu",
                              compute_dtype=getattr(torch, dtype))
    x = np.random.default_rng(1).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)
    tol = BF16_ULP if dtype == "bfloat16" else RTOL
    jh, jdec = jn.forward_heads(x)
    th, tdec = tn.forward_heads(x)
    assert jdec is None and tdec is None
    assert len(th) == len(jh) == 1 and th[0].shape == (3, 1, 1, 208)
    _close(th[0], np.asarray(jh[0], np.float32), tol)
    _close(tn.predict(x), np.asarray(jn.predict(x), np.float32), tol)
    l = tn.graph.layers[-1]
    for a, b in zip(tv1.detection_decode(_t(th[0]).reshape(3, -1), l),
                    jv1.detection_decode(jnp.asarray(jh[0]).reshape(3, -1),
                                         jn.graph.layers[-1])):
        _close(a, np.asarray(b, np.float32), tol)
    assert tn.detect_batch(x, thresh=0.0) == jn.detect_batch(x, thresh=0.0) \
        == [[], [], []]
    assert tn.detect(x[0]) == []


def test_v1_device_path_refuses_before_any_work():
    """No [yolo] head to decode on the device: a ValueError naming the
    head kind (the JAX package fails on an empty concatenate)."""
    tn = Network.from_cfg(CFG, device="cpu")
    x = np.zeros((2, 64, 64, 3), np.float32)
    for call in (tn.submit_detect_device, tn.detect_batch_device,
                 lambda a: tn.detect_batch(a, use_device_nms=True)):
        with pytest.raises(ValueError, match="detection"):
            call(x)


@pytest.mark.parametrize("accum", [1, 2])
def test_narrow_v1_step_matches_jax(accum):
    """Each of five steps taken by the port from the JAX package's state
    before it, with rng=None / generator=None (dropout the identity)."""
    jg, tg = _quiet(jbuild, CFG, True), _quiet(tbuild, CFG, True)
    p0 = jparams.init_params(jg, seed=0)
    x, y = CS.train_batch(jg, 4, seed=30 + accum)
    noise = np.random.default_rng(99).standard_normal(x.shape)
    xe = jnp.asarray((x * (1 + 1e-7 * noise)).astype(np.float32))
    lr = jnp.float32(jg.net.lr)
    step = jstep(jg, donate=False, accum=accum)
    port = make_train_step(tg, accum=accum)
    p = jax.device_put(p0)
    o = jinit(jg, p)
    for n in range(1, STEPS + 1):
        before, u_before = to_numpy(p), to_numpy(o["u"])
        pj, oj, cj, mj = step(p, o, jnp.asarray(x), jnp.asarray(y), None, lr)
        pe, oe, _ce, _m = step(p, o, xe, jnp.asarray(y), None, lr)
        pt = tparams.train_params_to_torch(tg, before, "cpu")
        ot = {"t": int(o["t"]),
              "u": tparams.numpy_to_train_layout(tg, u_before, "cpu")}
        pt, ot, ct, mt = port(pt, ot, _t(x), _t(y), jg.net.lr)
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)
        for k in ("count", "avg_iou", "loss"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4)
        got = {"params": tparams.train_params_to_numpy(tg, pt),
               "momentum": tparams.train_params_to_numpy(tg, ot["u"])}
        for name, want, moved, ref, keysets in (
                ("params", pj, pe, before,
                 (("w", "b", "scales"), ("mean", "var"))),
                ("momentum", oj["u"], oe["u"], u_before,
                 (("w", "b", "scales"),))):
            for keys in keysets:
                want_n, moved_n = to_numpy(want), to_numpy(moved)
                err, scale = CS.update_gap(want_n, got[name], ref, keys)
                yard, _ = CS.update_gap(want_n, moved_n, ref, keys)
                assert scale > 0 and err <= max(STEP_TOL * scale,
                                                YARDSTICK * yard), (
                    n, name, keys, err / scale, yard / scale)
        p, o = pj, oj


def test_v1_step_draws_dropout_from_the_generator():
    """With a generator the [dropout] layer drops and scales: the step
    differs from the generator-free one, two equal generators give equal
    steps, and the kept share of a micro-batch is about 1 - p."""
    g = _quiet(tbuild, CFG, True)
    p0 = tparams.init_params(g, seed=0)
    x, y = CS.train_batch(g, 4, seed=3)

    def run(gen):
        p = tparams.train_params_to_torch(g, p0, "cpu")
        o = tstep.init_opt_state(g, p)
        _p, _o, c, _m = make_train_step(g)(p, o, _t(x), _t(y), g.net.lr,
                                           gen)
        return float(c), tparams.train_params_to_numpy(g, _p)

    c0, _ = run(None)
    c1, p1 = run(torch.Generator().manual_seed(5))
    c2, p2 = run(torch.Generator().manual_seed(5))
    assert c1 == c2 and c1 != c0
    for a, b in zip(p1, p2):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    from darknet_tpu_torch.nn.emit import make_forward

    # the [dropout] output (layer 6) feeds [connected]: seen in its input
    cut = _quiet(tbuild, CFG.split("[connected]")[0], True)
    tp = tparams.train_params_to_torch(cut, p0[:7], "cpu")
    with torch.no_grad():
        kept = make_forward(cut, train=True)(
            tp, _t(x), torch.Generator().manual_seed(1))["output"]
        full = make_forward(cut, train=True)(tp, _t(x))["output"]
    share = float((kept != 0).sum()) / float((full != 0).sum())
    n = float((full != 0).sum())
    assert abs(share - 0.5) <= 5 * np.sqrt(0.25 / n)
    nz = full != 0
    np.testing.assert_allclose(kept[nz & (kept != 0)].numpy(),
                               2 * full[nz & (kept != 0)].numpy(), rtol=1e-6)


# ------------------------------------- the .weights CHW connected order

CHW_CFG = """[net]
width=20
height=12
channels=3
[convolutional]
batch_normalize=1
filters=4
size=3
stride=2
pad=1
activation=leaky
[connected]
output=9
batch_normalize=1
activation=linear
[connected]
output=5
activation=leaky
"""


def test_connected_weights_chw_round_trip(tmp_path):
    """A conv output of (6, 10, 4) feeds a [connected] layer: the JAX
    package's `.weights` file loads into the port, which serves what the
    JAX package serves; the port saves the same file byte for byte.  The
    test can see the order: flattening the same input HWC moves the
    output."""
    path = _weights(tmp_path, CHW_CFG, seed=3)
    x = np.random.default_rng(2).uniform(0, 1, (2, 12, 20, 3)).astype(
        np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jn = JNetwork.from_cfg(CHW_CFG, weights=path)
        tn = Network.from_cfg(CHW_CFG, weights=path, device="cpu")
        raw = Network.from_cfg(CHW_CFG, weights=path, device="cpu",
                               fuse=False)
    want = np.asarray(jn.predict(x))
    _close(tn.predict(x), want)
    _close(raw.predict(x), want)
    saved = str(tmp_path / "port.weights")
    raw.save_weights(saved)
    with open(path, "rb") as f, open(saved, "rb") as g:
        assert f.read() == g.read()
    # the HWC order would give another output
    from darknet_tpu_torch.nn.emit import make_forward

    conv = make_forward(_quiet(tbuild, CHW_CFG.split("[connected]")[0]))(
        tn.params, _t(x))["output"]
    p = tn.params[1]
    hwc = conv.reshape(2, -1) @ p["w"]
    chw = conv.permute(0, 3, 1, 2).reshape(2, -1) @ p["w"]
    assert float((hwc - chw).abs().max()) > 0.1 * float(chw.abs().max())


def test_train_params_layouts_as_jax():
    """Connected "w" (inputs, outputs), local "w" (locations, n,
    size*size*c) and [batchnorm] params carry the JAX layouts to torch
    and back, exactly; "mean"/"var" need no grad."""
    cfg = CFG.replace("[dropout]", "[batchnorm]\n[dropout]")
    g = _quiet(tbuild, cfg, True)
    p0 = jparams.init_params(_quiet(jbuild, cfg, True), seed=2)
    tp = tparams.train_params_to_torch(g, p0, "cpu")
    kinds = {l.kind for l, d in zip(g.layers, tp) if d}
    assert kinds == {"convolutional", "local", "batchnorm", "connected"}
    assert tp[5]["w"].shape == (16, 8, 3 * 3 * 16)
    assert tp[8]["w"].shape == (128, 64)
    assert not tp[6]["mean"].requires_grad and tp[6]["scales"].requires_grad
    back = tparams.train_params_to_numpy(g, tp)
    for a, b in zip(back, p0):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    served = tparams.params_to_torch(g, p0, "cpu", torch.bfloat16)
    np.testing.assert_array_equal(served[8]["w"].numpy(), p0[8]["w"])


# ------------------------------------------------------ the trainer

@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1")
    files = synth.generate(str(root / "data"), n_train=8, n_val=0, seed=4)
    return root, files


def _trainer(root, files, name, **kw):
    cfg = CFG.replace("classes=3", "classes=4").replace(
        "output=208", "output=224")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return DetectorTrainer(cfg, files["train_paths"], classes=4,
                               device="cpu", log=lambda s: None,
                               save_dir=str(root / name), save_name="v1",
                               loader_processes=0, seed=0, **kw)


def test_trainer_draws_dropout_from_its_checkpointed_generator(synth_set):
    """Two iterations straight, and one, a saved state, a resumed trainer
    and one more: the same weights, byte for byte (the resumed trainer
    draws the masks the straight run drew); the loss finite; the final
    .weights serve the trained params folded."""
    root, files = synth_set
    straight = _trainer(root, files, "a")
    straight.train(max_iters=2)
    first = _trainer(root, files, "b")
    first.train(max_iters=1)
    resumed = _trainer(root, files, "b", resume=True)
    resumed.train(max_iters=1)
    for t in (straight, first, resumed):
        t.close()
    assert resumed.curr_iter == straight.curr_iter == 2
    a = tparams.train_params_to_numpy(straight.graph, straight.params)
    b = tparams.train_params_to_numpy(resumed.graph, resumed.params)
    for da, db in zip(a, b):
        for k in da:
            np.testing.assert_array_equal(da[k], db[k])
    assert np.isfinite(straight._avg_loss)
    served = Network.from_cfg(straight.cfg, weights=str(
        root / "a" / "v1_final.weights"), device="cpu")
    folded = Network(served.graph, tparams.params_to_torch(
        served.graph, tparams.fuse_conv_batchnorm(served.graph, a), "cpu"),
        device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(served.forward_heads(x)[0][0],
                                  folded.forward_heads(x)[0][0])
