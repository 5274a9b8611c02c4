"""Training a Gaussian-YOLO graph with darknet_tpu_torch against
darknet_tpu on the CPU: the narrow Gaussian graph of chip_smoke.py
(GAUSSIAN_TRAIN_CFG: a residual, an upsample + route and two
[Gaussian_yolo] heads, BN + leaky, 64 px), f32, burn_in 0.

* The train step, accum 1 and 2, in the step-by-step form of
  tests/test_torch_train_step.py's yolov4 test: the Gaussian heads make
  the graph chaotic in f32 at init (the NLL divides by the sigmas, so a
  head's deltas move by ~1e-5 for a 1e-6 change of its logits: a 1e-7
  relative change of the input moves the first cost by 1.2e-5 and the
  free-running updates and momentum by up to 0.8% of their largest
  element after five steps).  Each of five steps is taken by the port
  from the JAX package's state before it (params, momentum, counter)
  and held to JAX's step from that state: the updates, momentum buffers
  and rolling statistics within YARDSTICK_V4 (10) times the yardstick
  (the same JAX step on the changed input) plus 1e-4 of the scale,
  never more than CAP of it; the cost likewise (its scale the cost).  Measured: at most 3.6
  yardsticks for the updates and momentum.  One discrete decision is
  sensitive to f32 noise: leaky's slope at a pre-activation within noise
  of 0.  Batch seed 21 (accum 1) has one at layer 0 in step 2 (4.4e-8
  from 0 among 131,072), whose slope the two packages take on either
  side: 1e-3 of layer 0's update, every other layer equal to the
  yardstick.  The batches here are drawn from seeds without such a
  value, as tests/test_torch_zoo_train.py does for maxpool ties.
* One `train_detector` iteration on a synth set: the trainer's loss line
  (not its timing) as the JAX package's: iteration, lr and images
  equal, loss and avg loss within LOSS_RTOL; the logged match count
  equal and the class loss within 1e-5.  The loss is not equal to the
  printed digit: the two loaders' images differ by an f32 ulp here and
  there, the flat synth images amplify sum-order noise through batch
  norm to ~1e-4 at the head logits, and the sigma deltas (up to ~20
  here, where sigmas are small) scale it into the loss: the JAX
  package's own loss moves by 4.5e-4 (relative) when given the port's
  head logits, and the port's loss differs from JAX's by 1.8e-4.  Both
  packages' deltas agree to 1e-7 relative on the same logits
  (tests/test_torch_gaussian_loss.py).
* The CLI's `-mode valid -device cpu` against the JAX CLI on the same set
  and `.weights`: the same report, exactly (only the timing lines
  differ), as tests/test_torch_cli.py holds yolov4.
* The CLI's `-mode train` and `-mode video` run the graph.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from darknet_tpu.apps import cli as jcli
from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.train.step import init_opt_state as jinit
from darknet_tpu.train.step import make_train_step as jstep
from darknet_tpu.train.trainer import train_detector as jtrain_detector
from darknet_tpu_torch.apps import cli
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
from darknet_tpu_torch.train.trainer import train_detector
from darknet_tpu_torch.weights import io as wio
from tests.test_torch_train_step import (CAP, CS, STATS, TRAINABLE,
                                         YARDSTICK_V4, to_numpy)
from tests.torch_params import lively_params

torch.set_num_threads(2)
CFG = CS.GAUSSIAN_TRAIN_CFG
STEPS = 5
LOSS_RTOL = 1e-3          # measured 1.8e-4 (module docstring)
TIMING = ("Total prediction time", "Prediction per second")


@pytest.mark.parametrize("accum", [1, 2])
def test_narrow_gaussian_step_matches_jax(accum):
    """Each of five steps taken by the port from the JAX package's state
    before it, held to JAX's step from that state (module docstring)."""
    jg, tg = jbuild(CFG, train=True), tbuild(CFG, train=True)
    p0 = jparams.init_params(jg, seed=0)
    x, y = CS.train_batch(jg, 4, seed=30 + accum)
    noise = np.random.default_rng(99).standard_normal(x.shape)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xe = jnp.asarray((x * (1 + 1e-7 * noise)).astype(np.float32))
    lr = jnp.float32(jg.net.lr)
    step = jstep(jg, donate=False, accum=accum)
    port = make_train_step(tg, accum=accum)
    p = jax.device_put(p0)
    o = jinit(jg, p)
    rows = []
    for n in range(1, STEPS + 1):
        before, u_before = to_numpy(p), to_numpy(o["u"])
        pj, oj, cj, _m = step(p, o, xj, yj, None, lr)
        pe, oe, ce, _m = step(p, o, xe, yj, None, lr)
        pt = tparams.train_params_to_torch(tg, before, "cpu")
        ot = {"t": int(o["t"]),
              "u": tparams.numpy_to_train_layout(tg, u_before, "cpu")}
        pt, ot, ct, mt = port(pt, ot, torch.from_numpy(x),
                              torch.from_numpy(y), jg.net.lr)
        assert set(mt) == {"loss", "avg_iou", "count", "class_loss",
                           "iou_loss_mag"}
        assert ot["t"] == int(oj["t"]) == n
        rows.append((n, "cost", "-", abs(float(ct) - float(cj)),
                     abs(float(ce) - float(cj)), abs(float(cj))))
        got = {"params": tparams.train_params_to_numpy(tg, pt),
               "momentum": tparams.train_params_to_numpy(tg, ot["u"])}
        for name, want, moved, ref in (
                ("params", pj, pe, before),
                ("momentum", oj["u"], oe["u"], u_before)):
            want, moved = to_numpy(want), to_numpy(moved)
            for keys in ((TRAINABLE, STATS) if name == "params"
                         else (TRAINABLE,)):
                yard, scale = CS.update_gap(want, moved, ref, keys)
                err, _ = CS.update_gap(want, got[name], ref, keys)
                rows.append((n, name, keys[0], err, yard, scale))
        p, o = pj, oj
    for n, name, key, err, yard, scale in rows:
        assert scale > 0 and err <= min(YARDSTICK_V4 * yard + 1e-4 * scale,
                                        CAP * scale), (
            (n, name, key, err / scale, yard / scale), rows)


@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("gauss")
    files = synth.generate(str(root / "data"), n_train=8, n_val=8, seed=6)
    return root, files


def test_trainer_iteration_matches_jax(synth_set):
    root, files = synth_set
    runs = {}
    for name, fn, kw in (("jax", jtrain_detector, {}),
                         ("port", train_detector, {"device": "cpu"})):
        out = root / f"train_{name}"
        out.mkdir()
        cfg = out / "m.cfg"
        cfg.write_text(CFG)
        data = out / "obj.data"
        with open(files["data"]) as f:
            data.write_text(f.read() + f"save = {out}\n")
        logs = []
        fn(str(data), str(cfg), max_iters=1, log=logs.append,
           metrics_path=str(out / "m.jsonl"), **kw)
        with open(out / "m.jsonl") as f:
            row = [json.loads(line) for line in f if '"loss"' in line]
        runs[name] = ([line.split(", ") for line in logs
                       if line.startswith("[0001] loss:")], row)
    (jl, jm), (tl, tm) = runs["jax"], runs["port"]
    assert len(tl) == len(jl) == 1 and len(tm) == len(jm) == 1
    # iteration, lr and images exactly; loss and avg loss at LOSS_RTOL
    assert tl[0][2:4] == jl[0][2:4]
    for a, b in zip(tl[0][:2], jl[0][:2]):
        assert a.split(":")[0] == b.split(":")[0]
        np.testing.assert_allclose(float(a.split(": ")[1]),
                                   float(b.split(": ")[1]), rtol=LOSS_RTOL)
    assert tm[0]["count"] == jm[0]["count"] > 0
    np.testing.assert_allclose(tm[0]["class_loss"], jm[0]["class_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(tm[0]["loss"], jm[0]["loss"], rtol=LOSS_RTOL)


def test_valid_matches_jax(synth_set, capsys, monkeypatch):
    root, files = synth_set
    cfg = root / "valid.cfg"
    cfg.write_text(CFG)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = tbuild(CFG)
    weights = root / "valid.weights"
    wio.save_weights(g, lively_params(g, head_gain={8: 4.0, 15: 4.0}),
                     str(weights))
    # the JAX CLI would turn on a compile cache under HOME
    monkeypatch.setattr("darknet_tpu.utils.cache.enable_persistent_cache",
                        lambda *a, **k: None)
    out = {}
    for name, main, extra in (("port", cli.main, ["-device", "cpu"]),
                              ("jax", jcli.main, [])):
        main(["-mode", "valid", "-model_file", str(cfg), "-data_file",
              files["data"], "-weights_file", str(weights), *extra])
        out[name] = [line for line in capsys.readouterr().out.splitlines()
                     if line.strip()
                     and not line.strip().startswith(TIMING)]
    assert out["port"] == out["jax"]
    n_pred = [int(line.split(":")[1]) for line in out["port"]
              if line.startswith(" # of pred:")]
    assert n_pred[0] > 0
    assert any(line.startswith(" mAP@0.5") for line in out["port"])


def test_cli_trains_and_streams_gaussian(synth_set, capsys):
    """The CLI's `-mode train` (one epoch of 2 iterations) and `-mode
    video` (a 4-frame clip, tracking on) run the narrow Gaussian graph
    with no head-kind special case, as the JAX package's CLI does."""
    from darknet_tpu_torch.data import video

    root, files = synth_set
    out = root / "cli"
    out.mkdir()
    cfg = out / "m.cfg"
    cfg.write_text(CFG.replace("burn_in=0", "burn_in=0\nmax_epoch=1"))
    data = out / "obj.data"
    with open(files["data"]) as f:
        data.write_text(f.read() + f"save = {out}\n")
    base = ["-model_file", str(cfg), "-data_file", str(data), "-device",
            "cpu"]
    cli.main(["-mode", "train", "-weights_file", "none",
              "-loader_processes", "0", *base])
    weights = out / "m_final.weights"
    assert wio.load_weights(tbuild(CFG), str(weights))[1] == 8
    frames = []
    for t in range(4):
        fr = np.full((48, 64, 3), 100, np.uint8)
        fr[10:30, 4 + 4 * t:24 + 4 * t] = (30, 200, 60)
        frames.append(fr)
    clip = out / "clip.y4m"
    video.write_y4m(str(clip), frames, 10)
    capsys.readouterr()
    cli.main(["-mode", "video", "-weights_file", str(weights), "-input_file",
              str(clip), "-thresh", "0.1", "-out_dir", str(out / "video"),
              *base])
    assert "processed 4 frames" in capsys.readouterr().out
