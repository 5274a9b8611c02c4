"""In-training mAP of the port's trainer against the JAX package's on the
CPU: `train_detector(calc_map=True)` and `DetectorTrainer(calc_map=True)`
on the pool-free 64 px cfg of tests/test_torch_train_loop.py (burn_in 0,
4 iterations over 16 synth images, 6 validation images).

The cadence: mAP at the first iteration (iter_map = max(burn_in, start)),
then every max(100, iter_per_epoch) iterations, and at max_iter, so
iterations 1 and 4 here; a run resumed at iteration 2 evaluates at 3 and
4, as the JAX package's does.

Each mAP of the port's trainer equals, exactly, the JAX validator's mAP
of a JAX Network built from the port's weights at that iteration.
Against the JAX trainer's own mAP the values are within 15% relative:
the two trainers' weights differ by f32 noise that grows through the BN
statistics of two-image micro-batches (4e-6 after one iteration, 1e-4
after three; test_torch_train_loop.py), and the mAP of a detector this
young rests on a few true positives among ~2,000 ranked detections at
the .005 threshold, so that noise moves it (measured: 2.5e-4 relative
after one iteration, 7.6% after three).  The resumed state (mAP history,
best mAP, weights) is exact, the history as the float32 the checkpoint
stores, in both packages.
"""

import json
import os

import numpy as np
import pytest
import torch

from darknet_tpu.eval.map import validate_detector as jvalidate
from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu.train.trainer import DetectorTrainer as JTrainer
from darknet_tpu.train.trainer import train_detector as jtrain_detector
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.nn.params import train_params_to_numpy
from darknet_tpu_torch.train.trainer import DetectorTrainer, train_detector
from darknet_tpu_torch.weights import io as wio
from tests.test_torch_train_loop import CFG

torch.set_num_threads(2)
RTOL = 0.15


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_map")
    return root, synth.generate(str(root / "data"), n_train=16, n_val=6,
                                seed=5)


def map_events(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(r["iter"], r["map"]) for r in rows if r["event"] == "map"]


def test_train_detector_map_events_match_jax(data):
    root, files = data
    events = {}
    for name, fn, kw in (("jax", jtrain_detector, {}),
                         ("port", train_detector, {"device": "cpu"})):
        out = root / f"td_{name}"
        out.mkdir()
        cfg = out / "m.cfg"
        cfg.write_text(CFG.format(random=0))
        data_file = out / "obj.data"
        with open(files["data"]) as f:
            data_file.write_text(f.read() + f"save = {out}\n")
        fn(str(data_file), str(cfg), calc_map=True,
           metrics_path=str(out / "m.jsonl"), log=lambda *_: None, **kw)
        events[name] = map_events(out / "m.jsonl")
        assert (out / "m_best.weights").exists()
    (ji, jm), (ti, tm) = (list(zip(*events[k])) for k in ("jax", "port"))
    assert ti == ji == (1, 4)
    np.testing.assert_allclose(tm, jm, rtol=RTOL)
    assert max(tm) > 0


def trainer(cls, root, files, name, **kw):
    return cls(CFG.format(random=0), files["train_paths"], classes=4,
               calc_map=True, val_paths=files["val_paths"],
               save_dir=str(root / "dt"), save_name=name, loader_processes=0,
               log=lambda *_: None, **kw)


def run(t, iters):
    hooks = []
    try:
        t.train(max_iters=iters, map_hook=lambda it, m: hooks.append((it, m)))
    finally:
        t.close()
    return hooks


def test_map_hook_best_and_exact_resume(data):
    """map_hook sees every mAP, `_best.weights` holds the best iteration's
    weights, and a save, load and continue carries the mAP history and
    the best mAP exactly, beside the JAX trainer's resumed run."""
    root, files = data
    straight = trainer(DetectorTrainer, root, files, "straight", device="cpu")
    jgraph = jbuild(CFG.format(random=0))
    jax_maps = []

    def jax_map(_it, _m):
        """The JAX validator on the port's weights of this iteration."""
        params = jparams.fuse_conv_batchnorm(jgraph, train_params_to_numpy(
            straight.graph, straight.params))
        jax_maps.append(jvalidate(
            JaxNetwork(jgraph, params, fused=True), files["val_paths"], 4,
            batch=4, progress=False, resize="darknet").map)
    straight.train(max_iters=4, map_hook=jax_map)
    straight.close()
    hooks = list(zip(straight._chart["map_iters"], straight._chart["maps"]))
    assert hooks == list(zip([1, 4], jax_maps))
    assert straight._best_map == max(m for _it, m in hooks) > 0
    assert os.path.exists(root / "dt" / "straight_best.weights")

    runs = {}
    for name, cls, kw in (("port", DetectorTrainer, {"device": "cpu"}),
                          ("jax", JTrainer, {})):
        half = trainer(cls, root, files, f"half_{name}", **kw)
        first = run(half, 2)
        resumed = trainer(cls, root, files, f"half_{name}", resume=True, **kw)
        assert resumed.curr_iter == 2
        assert resumed._best_map == half._best_map
        # the checkpoint keeps the history in float32, as the JAX one does
        assert resumed._chart["map_iters"] == [1]
        assert resumed._chart["maps"] == [float(np.float32(first[0][1]))]
        later = run(resumed, 2)
        runs[name] = (resumed, first + later)
    (tr, th), (jr, jh) = runs["port"], runs["jax"]
    assert [it for it, _m in th] == [it for it, _m in jh] == [1, 3, 4]
    np.testing.assert_allclose([m for _it, m in th], [m for _it, m in jh],
                               rtol=RTOL)
    assert tr._chart["map_iters"] == [1, 3, 4]
    assert tr._chart["maps"] == [float(np.float32(th[0][1]))] + [
        m for _it, m in th[1:]]
    assert tr._best_map == max(m for _it, m in th)
    a = wio.load_weights(straight.graph,
                         str(root / "dt" / "straight_final.weights"))
    b = wio.load_weights(tr.graph, str(root / "dt" / "half_port_final.weights"))
    for da, db in zip(a[0], b[0]):
        for k in da:
            np.testing.assert_array_equal(da[k], db[k])
