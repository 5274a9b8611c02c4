"""The port's `train/trainer` against the JAX package's on the CPU:
`train_detector` for 3 iterations on the same synth files at 64 px (the
logged losses within 1e-5 relative at the first iteration and 2e-3
after; the updates in the final `.weights` (final - init), the trainable
ones within 1e-3 of the largest trainable update and the rolling
statistics within 5e-3 of their largest change: after one iteration
both agree to 4e-6, and the difference grows through BN statistics over
two-image micro-batches, to 1.2e-4 and 1.6e-3 after three), the
multi-scale bucket picks, an exact resume (4 straight
iterations against 2, save, load, 2: equal to the bit), a start from a
`.weights` file with and without clear, and the entry points' refusals:
no card without device="cpu", and a mesh of one process's devices
(data parallelism runs one process a device: tests/test_torch_parallel.
py; in-training mAP is tests/test_torch_train_map.py).

The cfg has no maxpool: on synth images (flat colour regions) a
maxpool's windows hold exact ties, and which positions tie exactly
depends on each conv implementation's rounding, so the tie-to-all
backward of the stride-1 pools turns 1-ulp forward differences into
large gradient differences (the JAX package's jitted and eager steps
disagree by ~25% there).  The pools are held to JAX on constructed
ties in tests/test_torch_train_ops.py."""

import json
import os

import numpy as np
import pytest
import torch

from darknet_tpu.train.trainer import DetectorTrainer as JTrainer
from darknet_tpu.train.trainer import train_detector as jtrain_detector
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn.params import init_params
from darknet_tpu_torch.train.trainer import DetectorTrainer, train_detector
from darknet_tpu_torch.weights import io as wio

CFG = """[net]
batch=4
subdivisions=2
width=64
height=64
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
burn_in=0
mosaic=1
hue=.1
saturation=1.5
exposure=1.5
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=mish
[route]
layers = -2
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=mish
[shortcut]
from=-2
activation=linear
[route]
layers = -1,-4
[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky
[upsample]
stride=2
[route]
layers=-1,-4
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[convolutional]
filters=27
size=1
stride=1
pad=1
activation=linear
[yolo]
mask=0,1,2
anchors=8,8, 16,20, 28,24
classes=4
num=3
jitter=.3
ignore_thresh=.7
truth_thresh=1
scale_x_y=1.05
iou_thresh=0.213
iou_normalizer=0.07
cls_normalizer=1.0
iou_loss=ciou
max_delta=5
random={random}
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    files = synth.generate(str(root / "data"), n_train=16, n_val=2, seed=5)
    return root, files


def setup_run(root, files, name, random=0):
    out = root / name
    out.mkdir()
    cfg = out / "m.cfg"
    cfg.write_text(CFG.format(random=random))
    data_file = out / "obj.data"
    with open(files["data"]) as f:
        data_file.write_text(f.read() + f"save = {out}\n")
    return out, str(cfg), str(data_file)


def test_train_detector_matches_jax(data):
    root, files = data
    runs = {}
    for name, fn, kw in (("jax", jtrain_detector, {}),
                         ("port", train_detector, {"device": "cpu"})):
        out, cfg, data_file = setup_run(root, files, name)
        logs = []
        avg = fn(data_file, cfg, max_iters=3, metrics_path=str(out / "m.jsonl"),
                 log=logs.append, **kw)
        with open(out / "m.jsonl") as f:
            losses = [json.loads(l)["loss"] for l in f if '"loss"' in l]
        runs[name] = (avg, losses, str(out / "m_final.weights"), logs)
    (ja, jl, jw, _), (ta, tl, tw, tlogs) = runs["jax"], runs["port"]
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    np.testing.assert_allclose(ta, ja, rtol=2e-3)
    assert any(line.startswith("[0003] loss:") for line in tlogs)
    with open(jw, "rb") as fj, open(tw, "rb") as ft:
        bj, bt = fj.read(), ft.read()
    assert bj[:20] == bt[:20] and len(bj) == len(bt)   # header, seen
    graph = build_graph(CFG.format(random=0), train=True)
    p0 = init_params(graph, seed=0)         # what both trainers start from
    pj, pt = wio.load_weights(graph, jw)[0], wio.load_weights(graph, tw)[0]
    for keys, tol in ((("w", "b", "scales"), 1e-3), (("mean", "var"), 5e-3)):
        err = scale = 0.0
        for dj, dt, d0 in zip(pj, pt, p0):
            for k in keys:
                if k in d0:
                    err = max(err, float(np.abs(dt[k] - dj[k]).max()))
                    scale = max(scale, float(np.abs(dj[k] - d0[k]).max()))
        assert scale > 0 and err <= tol * scale, (keys, err, scale)


def test_multiscale_buckets_match_jax(data):
    root, files = data
    _out, cfg, _d = setup_run(root, files, "buckets", random=1)
    tt = DetectorTrainer(cfg, files["train_paths"], classes=4, device="cpu",
                         loader_processes=0, log=lambda *_: None)
    jt = JTrainer(cfg, files["train_paths"], classes=4, loader_processes=0,
                  log=lambda *_: None)
    try:
        assert tt._pick_dims(-1.0) == jt._pick_dims(-1.0) == (128, 128)
        for it in (10, 20, 30, 40, 50):
            tt.seen = jt.seen = it * 4
            assert tt._pick_dims(5.0) == jt._pick_dims(5.0)
    finally:
        tt.close()
        jt.close()


def test_exact_resume(data):
    root, files = data
    out, cfg, _d = setup_run(root, files, "resume")

    def trainer(**kw):
        return DetectorTrainer(cfg, files["train_paths"], classes=4,
                               device="cpu", loader_processes=0,
                               save_dir=str(out), log=lambda *_: None, **kw)
    straight = trainer(save_name="straight")
    straight.train(max_iters=4)
    straight.close()
    half = trainer(save_name="half")
    half.train(max_iters=2)
    half.close()
    resumed = trainer(save_name="half", resume=True)
    assert resumed.curr_iter == 2
    resumed.train(max_iters=2)
    resumed.close()
    for k in ("final",):
        a = wio.load_weights(straight.graph, str(out / f"straight_{k}.weights"))
        b = wio.load_weights(resumed.graph, str(out / f"half_{k}.weights"))
        assert a[1] == b[1] == 16
        for da, db in zip(a[0], b[0]):
            for name in da:
                np.testing.assert_array_equal(da[name], db[name])
    for slot, v in straight.opt_state.items():
        if slot != "t":
            for da, db in zip(v, resumed.opt_state[slot]):
                for name in da:
                    torch.testing.assert_close(da[name], db[name], rtol=0,
                                               atol=0)
    assert straight._avg_loss == resumed._avg_loss


def test_entry_points_refuse(data):
    root, files = data
    _out, cfg, data_file = setup_run(root, files, "refuse")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            DetectorTrainer(cfg, files["train_paths"], classes=4)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            train_detector(data_file, cfg, max_iters=1)
    from darknet_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="one process a device"):
        DetectorTrainer(cfg, files["train_paths"], classes=4, device="cpu",
                        mesh=make_mesh(2, device="cpu"))
    assert not os.path.exists(os.path.join(_out, "m_final.weights"))


@pytest.mark.parametrize("clear", [False, True])
def test_weights_and_clear_match_jax(data, clear):
    """Starting from a .weights file: its `seen` carries over (and sets
    the iteration counter) unless clear=True, as in the JAX package."""
    root, files = data
    out, cfg, _d = setup_run(root, files, f"clear{int(clear)}")
    graph = build_graph(CFG.format(random=0), train=True)
    path = str(out / "start.weights")
    wio.save_weights(graph, init_params(graph, seed=7), path, seen=48)
    kw = dict(weights=path, clear=clear, classes=4, loader_processes=0,
              log=lambda *_: None)
    tt = DetectorTrainer(cfg, files["train_paths"], device="cpu", **kw)
    jt = JTrainer(cfg, files["train_paths"], **kw)
    try:
        assert tt.seen == jt.seen == (0 if clear else 48)
        assert tt.opt_state["t"] == int(jt.opt_state["t"]) == tt.curr_iter
        np.testing.assert_array_equal(
            tt.params[0]["w"].detach().permute(2, 3, 1, 0).numpy(),
            init_params(graph, seed=7)[0]["w"])
    finally:
        tt.close()
        jt.close()
