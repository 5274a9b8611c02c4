"""darknet_tpu_torch stands alone: a subprocess blocks jax, jaxlib and the
JAX package `darknet_tpu` with a meta-path finder, imports the port and
serves yolov4 at 64 px on the CPU, in f32 and in int8 (quantized,
calibrated); another blocks OpenCV (cv2) and PIL too and trains 3
iterations through `train_detector` on the port's synth set (nonzero
image batches, non-empty truths, finite losses), and a third, with the
same five blocked, runs `validate_detector` (both resizes) and the CLI's
`-mode valid` on a synth set; a fourth, with jax, jaxlib, `darknet_tpu`
and cv2 blocked, runs the CLI's `-mode video -device cpu` on a y4m clip
with tracking, and `-mode image` on a PNG; a fifth, with jax, jaxlib and
`darknet_tpu` blocked, serves chip_smoke.py's narrow Gaussian graph
(host and device paths, uc on the host's detections) and takes one
training step of it; a sixth, with the same three blocked, serves
chip_smoke.py's narrow YOLOv1 (heads, the host path's empty lists, the
device path's ValueError, and the rare-kind cfgs) and steps it, without
and with a generator; a seventh, with the same three blocked, imports
`utils/debug`, `utils/profiler` and `apps/bench`, serves a yolov4-64
request with region_int8 (107 quantized convs, no stem, no region kernel)
under `debug_nans` and profiles it per layer; an eighth, with the same
three blocked, loads and runs a serving artifact (`Network.
export_serving`) and returns the exporting process's triple bitwise; a
ninth runs a data-parallel step over two spawned gloo ranks with the
same three blocked in every process (a `sitecustomize` that the ranks
load too); a tenth, with jax, jaxlib and `darknet_tpu` blocked, serves
yolov4-64 through `make_spatial_forward`, `make_tp_forward`,
`PipelineForward` and the Network's ("dp", "sp") mesh; an eleventh,
with the same three blocked, trains one step of yolov4-64 each through
`PipelineTrain`, `make_tp_train_step` and `make_spatial_train_step` and
runs `dryrun_multichip(2, device="cpu")`; and no source of the port (`eval/`, `apps/` and `parallel/`
included), nor the chip
scripts (chip_smoke.py, chip_int8_shapes.py, chip_region_tiles.py),
imports any of the three, nor does the port's C shim import a module
outside darknet_tpu_torch (and numpy)."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

BLOCKED_SERVE = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import warnings
import numpy as np
import torch
torch.set_num_threads(2)
import darknet_tpu_torch
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.ops.cuda import fused_region

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    net = Network.from_cfg(model_zoo.yolov4_cfg(64, 64), seed=0,
                           device="cpu")
frames = (np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3))
          * 255).astype(np.uint8)
tb, ov, probs = net.submit_detect_device(frames, thresh=0.1)
dets = net.device_out_to_dets(tb, ov, probs)
assert tb.shape == (2, 252, 4) and len(dets) == 2
assert torch.isfinite(tb).all()
host = net.detect(frames[0], thresh=0.1)
assert fused_region.launches == 0        # CPU: the plain version ran

# int8: quantize, calibrate with the port's probe forward, serve
from darknet_tpu_torch.ops import quant_matmul
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    qnet = Network.from_cfg(model_zoo.yolov4_cfg(64, 64), seed=0, int8=True,
                            device="cpu")
qnet.calibrate_int8([frames[0].astype(np.float32) / 255.0])
assert sum("x_scale" in p for p in qnet.params) == 91
qtb, _qov, _qprobs = qnet.submit_detect_device(frames, thresh=0.1)
assert qtb.shape == (2, 252, 4) and torch.isfinite(qtb).all()
assert quant_matmul.launches == 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("SERVED", sum(len(d) for d in dets), len(host))
"""


BLOCKED_TRAIN = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu", "cv2",
                                  "PIL"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import json, math, os, warnings
import numpy as np
import torch
torch.set_num_threads(2)
from darknet_tpu_torch.data import loader, synth
from darknet_tpu_torch.train.trainer import train_detector

seen = []
next_batch = loader.DetectionLoader.next

def spy(self):
    x, y = next_batch(self)
    seen.append(((x != 0).mean(), int((y[:, :, 0] > 0).sum())))
    return x, y

loader.DetectionLoader.next = spy
root = sys.argv[1]
files = synth.generate(os.path.join(root, "data"), n_train=12, n_val=2, seed=1)
cfg = os.path.join(root, "m.cfg")
with open(cfg, "w") as f:
    f.write(CFG)
data = os.path.join(root, "obj.data")
with open(files["data"]) as f, open(data, "w") as g:
    g.write(f.read() + "save = " + root + "\n")
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    avg = train_detector(data, cfg, max_iters=3, device="cpu",
                         metrics_path=os.path.join(root, "m.jsonl"))
with open(os.path.join(root, "m.jsonl")) as f:
    losses = [json.loads(l)["loss"] for l in f if '"loss"' in l]
assert len(losses) == 3 and all(math.isfinite(v) for v in losses), losses
assert math.isfinite(avg)
assert len(seen) >= 3 and all(nz > 0.9 and n > 0 for nz, n in seen), seen
assert os.path.exists(os.path.join(root, "m_final.weights"))
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu", "cv2", "PIL")]
assert not bad, bad
print("TRAINED", losses)
"""

BLOCKED_VALID = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu", "cv2",
                                  "PIL"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import contextlib, io, os, warnings
import torch
torch.set_num_threads(2)
from darknet_tpu_torch import Network
from darknet_tpu_torch.apps import cli
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.eval.map import validate_detector

root = sys.argv[1]
files = synth.generate(os.path.join(root, "data"), n_train=0, n_val=5, seed=2)
cfg = os.path.join(root, "m.cfg")
with open(cfg, "w") as f:
    f.write(CFG)
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    net = Network.from_cfg(cfg, device="cpu")
for resize in ("cv", "darknet"):
    r = validate_detector(net, files["val_paths"], 4, batch=2,
                          progress=False, resize=resize)
    assert r.n_gt > 0 and r.n_pred > 0, r
out = io.StringIO()
with contextlib.redirect_stdout(out), warnings.catch_warnings():
    warnings.simplefilter("ignore")
    cli.main(["-mode", "valid", "-data_file", files["data"], "-model_file",
              cfg, "-weights_file", "none", "-device", "cpu"])
assert " mAP@0.5" in out.getvalue(), out.getvalue()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu", "cv2", "PIL")]
assert not bad, bad
print("VALIDATED", r.n_pred)
"""

BLOCKED_VIDEO = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu", "cv2"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import contextlib, io, os, warnings
import numpy as np
import torch
torch.set_num_threads(2)
from darknet_tpu_torch.apps import cli
from darknet_tpu_torch.data import video
from darknet_tpu_torch.data.image import read_png, write_png

root = sys.argv[1]
cfg = os.path.join(root, "m.cfg")
with open(cfg, "w") as f:
    f.write(CFG)
with open(os.path.join(root, "names"), "w") as f:
    f.write("a\nb\nc\nd\n")
with open(os.path.join(root, "t.data"), "w") as f:
    f.write("classes=4\nnames=" + os.path.join(root, "names") + "\n")
frames = []
for t in range(6):
    fr = np.full((48, 64, 3), 100, np.uint8)
    fr[10:30, 4 + 4 * t:24 + 4 * t] = (30, 200, 60)
    frames.append(fr)
clip = os.path.join(root, "clip.y4m")
video.write_y4m(clip, frames, 10)
write_png(os.path.join(root, "img.png"), frames[2])
base = ["-data_file", os.path.join(root, "t.data"), "-model_file", cfg,
        "-weights_file", "none", "-device", "cpu", "-thresh", "0.1",
        "-out_dir", os.path.join(root, "out")]
out = io.StringIO()
with contextlib.redirect_stdout(out), warnings.catch_warnings():
    warnings.simplefilter("ignore")
    cli.main(base + ["-mode", "video", "-input_file", clip])
    cli.main(base + ["-mode", "image", "-input_file",
                     os.path.join(root, "img.png")])
assert "processed 6 frames" in out.getvalue(), out.getvalue()
assert read_png(os.path.join(root, "out", "det_img.png")).shape == (48, 64, 3)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu", "cv2")]
assert not bad, bad
print("STREAMED")
"""

BLOCKED_GAUSSIAN = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import warnings
import numpy as np
import torch
torch.set_num_threads(2)
from chip_smoke import GAUSSIAN_TRAIN_CFG, train_batch
from darknet_tpu_torch import Network
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train.step import init_opt_state, make_train_step

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    net = Network.from_cfg(GAUSSIAN_TRAIN_CFG, seed=0, device="cpu")
x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
tb, ov, probs = net.submit_detect_device(x, thresh=0.1)
assert tb.shape == (2, 256, 4) and torch.isfinite(tb).all()
host = net.detect_batch(x, thresh=0.1)
assert all(d.uc.shape == (4,) for dets in host for d in dets)

g = build_graph(GAUSSIAN_TRAIN_CFG, train=True)
p = tparams.train_params_to_torch(g, tparams.init_params(g, seed=0), "cpu")
xb, yb = train_batch(g, 4, seed=1)
p, o, cost, m = make_train_step(g)(p, init_opt_state(g, p),
                                   torch.from_numpy(xb),
                                   torch.from_numpy(yb), g.net.lr)
assert torch.isfinite(cost) and float(m["count"]) > 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("GAUSSIAN", sum(len(d) for d in host), float(cost))
"""

BLOCKED_V1 = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import warnings
import numpy as np
import torch
torch.set_num_threads(2)
from chip_smoke import (NARROW_V1_CFG, RARE_COST_CFG, RARE_KINDS_CFG,
                        train_batch)
from darknet_tpu_torch import Network
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.ops.detection_v1 import detection_decode
from darknet_tpu_torch.train.step import init_opt_state, make_train_step

warnings.simplefilter("ignore")
net = Network.from_cfg(NARROW_V1_CFG, seed=0, device="cpu")
x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
heads, dec = net.forward_heads(x)
assert heads[0].shape == (2, 1, 1, 208) and dec is None
boxes, conf, cls = detection_decode(torch.from_numpy(heads[0]).reshape(2, -1),
                                    net.graph.layers[-1])
assert boxes.shape == (2, 32, 4) and torch.isfinite(boxes).all()
assert net.detect_batch(x) == [[], []]
try:
    net.submit_detect_device(x)
    raise AssertionError("the device path served a [detection] head")
except ValueError as e:
    assert "detection" in str(e)
for cfg in (RARE_KINDS_CFG, RARE_COST_CFG):
    out = Network.from_cfg(cfg, seed=0, device="cpu").predict(x)
    assert np.isfinite(out).all()

g = build_graph(NARROW_V1_CFG, train=True)
xb, yb = train_batch(g, 4, seed=1)
for gen in (None, torch.Generator().manual_seed(0)):
    p = tparams.train_params_to_torch(g, tparams.init_params(g, seed=0), "cpu")
    p, o, cost, m = make_train_step(g)(p, init_opt_state(g, p),
                                       torch.from_numpy(xb),
                                       torch.from_numpy(yb), g.net.lr, gen)
    assert torch.isfinite(cost) and float(m["count"]) > 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("YOLOV1", float(cost))
"""

TRAIN_CFG = """[net]
batch=4
subdivisions=2
width=32
height=32
channels=3
learning_rate=0.001
burn_in=0
mosaic=1
hue=.1
saturation=1.5
exposure=1.5
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=mish
[maxpool]
size=2
stride=2
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
iou_loss=ciou
"""


BLOCKED_TOOLS = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import warnings
import numpy as np
import torch
torch.set_num_threads(2)
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.apps import bench
from darknet_tpu_torch.utils import debug, profiler

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    net = Network.from_cfg(model_zoo.yolov4_cfg(64, 64), seed=0, int8=True,
                           device="cpu")
x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
    np.float32)
net.calibrate_int8([x], region_int8=True)
assert sum("x_scale" in p for p in net.params) == 107
assert [p.stem for p in net._fwd.region_plans.values()] == [False]
with debug.debug_sync_mode(), debug.debug_nans():
    tb, ov, probs = net.submit_detect_device(x, thresh=0.1)
assert tb.shape == (2, 252, 4) and torch.isfinite(tb).all()
rows = profiler.trace_report(lambda p, a: net._fwd(p, a)["output"],
                             net.params, torch.from_numpy(x), iters=1,
                             graph=net.graph, log=lambda s: None)
assert "L000_convolutional" in {r[0] for r in rows}
assert callable(bench.run)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("TOOLS", len(rows))
"""


BLOCKED_EXPORT = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(2)
from darknet_tpu_torch import Network

art, frames, want = sys.argv[1:4]
got = Network.run_exported_serving(art, np.load(frames))
want = np.load(want)
for g, k in zip(got, ("tb", "ov", "probs")):
    assert np.array_equal(g.float().numpy(), want[k]), k
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("EXPORTED", int((got[2] > 0).sum()))
"""


BLOCKER = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
"""

BLOCKED_DP = r"""
import sys
import tempfile

import numpy as np
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn.params import init_params
from darknet_tpu_torch.parallel.multihost import spawn
import torch_parallel_workers as workers

cfg = '''[net]
batch=4
subdivisions=2
width=32
height=32
channels=3
burn_in=0
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=mish
[convolutional]
filters=12
size=1
activation=linear
[yolo]
mask=0,1
num=2
classes=1
anchors=10,14, 23,27
'''
rng = np.random.default_rng(0)
x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
y = np.zeros((4, 90, 5), np.float32)
y[:, 0] = [0.5, 0.5, 0.3, 0.3, 0]
case = {"name": "dp", "cfg": cfg, "accum": 2, "bf16": False, "steps": 1,
        "p0": init_params(build_graph(cfg, train=True), seed=0), "x": x,
        "y": y}
out = tempfile.mkdtemp()
spawn(workers.dp_steps, ["cpu", "cpu"], out, [case], timeout_s=240)
z = [np.load(f"{out}/dp_{r}.npz") for r in (0, 1)]
assert all(np.array_equal(z[0][k], z[1][k]) for k in z[0].files)
assert np.isfinite(z[0]["costs"]).all() and int(z[0]["t"]) == 1
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("DATA-PARALLEL", float(z[0]["costs"][0]))
"""


BLOCKED_MP_WORLD = BLOCKED_DP.split("case = {")[0] + r"""
from darknet_tpu_torch.nn.params import init_params as _init
out = tempfile.mkdtemp()
spawn(workers.mp_nojax_ranks, ["cpu", "cpu"], out, cfg, x, y,
      _init(build_graph(cfg, train=True), seed=0), timeout_s=240,
      shape={"dp": 1, "sp": 2})
z = [np.load(f"{out}/mp_{r}.npz") for r in (0, 1)]
assert float(z[0]["cost"]) == float(z[1]["cost"])
assert np.isfinite(float(z[0]["cost"]))
assert "head0" in z[0].files and "head0" not in z[1].files
assert np.isfinite(z[0]["head0"]).all()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("MP-WORLD", float(z[0]["cost"]))
"""


BLOCKED_MODEL_PARALLEL = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import warnings
import numpy as np
import torch
torch.set_num_threads(2)
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.parallel.pipeline import PipelineForward
from darknet_tpu_torch.parallel.spatial import (make_spatial_forward,
                                                make_spatial_mesh)
from darknet_tpu_torch.parallel.tensor import make_tp_forward, make_tp_mesh

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    net = Network.from_cfg(model_zoo.yolov4_cfg(64, 64), seed=0,
                           device="cpu")
x = np.random.default_rng(0).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
whole = net._fwd(net.params, torch.from_numpy(x))["heads"]
sp = make_spatial_forward(net.graph, make_spatial_mesh(2, 2, device="cpu"),
                          decode=False)(net.params, x)
tp = make_tp_forward(net.graph, make_tp_mesh(2, 2, device="cpu"),
                     decode=False)(net.params, x)
pp = PipelineForward(net.graph, net.params, ["cpu"] * 2)(x)
for heads in (sp, tp, pp):
    for a, b in zip(heads, whole):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
dets = net.detect_batch_device(x, thresh=0.1,
                               mesh=make_spatial_mesh(2, 2, device="cpu"))
assert len(dets) == 4
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("MODEL-PARALLEL", sum(map(len, dets)))
"""


BLOCKED_MODEL_PARALLEL_TRAIN = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import warnings
import numpy as np
import torch
torch.set_num_threads(2)
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.dryrun import dryrun_multichip
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as paramlib
from darknet_tpu_torch.parallel.mesh import grid_mesh
from darknet_tpu_torch.parallel.pipeline import PipelineTrain
from darknet_tpu_torch.parallel.spatial import (make_spatial_mesh,
                                                make_spatial_train_step)
from darknet_tpu_torch.parallel.tensor import gather, make_tp_train_step
from darknet_tpu_torch.train.step import init_opt_state, make_train_step

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    g = build_graph(model_zoo.yolov4_cfg(64, 64, batch=4, subdiv=1),
                    train=True)
p0 = paramlib.init_params(g, seed=0)
x = np.random.default_rng(0).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
y = np.zeros((4, 4, 5), np.float32)
y[:, 0] = [0.5, 0.5, 0.4, 0.4, 1]


def fresh():
    p = paramlib.train_params_to_torch(g, p0, "cpu")
    return p, init_opt_state(g, p)


p, o = fresh()
_p, _o, ref, _m = make_train_step(g)(p, o, torch.from_numpy(x),
                                     torch.from_numpy(y), 1e-3)
costs = {}
costs["pp"], _m = PipelineTrain(g, p0, ["cpu"] * 2, microbatches=1).step(
    x, y, 1e-3)
step, place = make_tp_train_step(g, grid_mesh({"dp": 2, "tp": 2},
                                              device="cpu"))
placed, opts, xt, yt = place(*fresh(), x, y)
placed, opts, costs["tp"], _m = step(placed, opts, xt, yt, 1e-3)
assert len(gather(placed)) == len(g.layers)
p, o = fresh()
_p, _o, costs["sp"], _m = make_spatial_train_step(
    g, make_spatial_mesh(2, 2, device="cpu"))(p, o, torch.from_numpy(x),
                                              torch.from_numpy(y), 1e-3)
for k, c in costs.items():
    assert abs(float(c) - float(ref)) <= 1e-4 * abs(float(ref)), (k, c, ref)
out = dryrun_multichip(2, device="cpu")
assert np.isfinite(out["cost"]) and np.isfinite(out["pp_cost"])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu")]
assert not bad, bad
print("MODEL-PARALLEL-TRAIN", float(ref))
"""


def run_blocked(script, *args, site=None):
    """Run `script` with the repo on the path; `site`: a directory whose
    sitecustomize.py every process of the run loads first."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        ([str(site)] if site else []) + [str(REPO), str(REPO / "tests")] +
        [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_port_serves_with_jax_blocked():
    assert "SERVED" in run_blocked(BLOCKED_SERVE)


def test_port_trains_without_jax_opencv_or_pil(tmp_path):
    script = BLOCKED_TRAIN.replace("f.write(CFG)",
                                   f"f.write({TRAIN_CFG!r})")
    assert "TRAINED" in run_blocked(script, str(tmp_path))


def test_port_validates_without_jax_opencv_or_pil(tmp_path):
    script = BLOCKED_VALID.replace("f.write(CFG)",
                                   f"f.write({TRAIN_CFG!r})")
    assert "VALIDATED" in run_blocked(script, str(tmp_path))


def test_port_streams_video_without_jax_or_opencv(tmp_path):
    script = BLOCKED_VIDEO.replace("f.write(CFG)",
                                   f"f.write({TRAIN_CFG!r})")
    assert "STREAMED" in run_blocked(script, str(tmp_path))


def test_port_serves_and_trains_gaussian_with_jax_blocked():
    assert "GAUSSIAN" in run_blocked(BLOCKED_GAUSSIAN)


def test_port_serves_and_trains_yolov1_with_jax_blocked():
    assert "YOLOV1" in run_blocked(BLOCKED_V1)


def test_model_parallel_serving_with_jax_blocked():
    assert "MODEL-PARALLEL" in run_blocked(BLOCKED_MODEL_PARALLEL)


def test_model_parallel_training_with_jax_blocked():
    """One step each of PipelineTrain, make_tp_train_step and
    make_spatial_train_step on yolov4-64, and dryrun_multichip(2)."""
    assert "MODEL-PARALLEL-TRAIN" in run_blocked(
        BLOCKED_MODEL_PARALLEL_TRAIN)


def test_tools_and_region_int8_with_jax_blocked():
    assert "TOOLS" in run_blocked(BLOCKED_TOOLS)


def test_exported_artifact_runs_with_jax_blocked(tmp_path):
    import warnings

    import numpy as np

    from darknet_tpu_torch import Network, model_zoo

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(model_zoo.yolov4_tiny_cfg(64, 64), seed=0,
                               device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    art = str(tmp_path / "serve.pt2")
    net.export_serving(art, batch=2, thresh=0.1, top_k=32)
    tb, ov, probs = net.submit_detect_device(x, thresh=0.1, top_k=32)
    np.save(tmp_path / "x.npy", x)
    np.savez(tmp_path / "want.npz", tb=tb.numpy(), ov=ov.numpy(),
             probs=probs.numpy())
    assert "EXPORTED" in run_blocked(BLOCKED_EXPORT, art,
                                     str(tmp_path / "x.npy"),
                                     str(tmp_path / "want.npz"))


def test_data_parallel_step_with_jax_blocked(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    assert "DATA-PARALLEL" in run_blocked(BLOCKED_DP, site=tmp_path)


def test_model_parallel_world_with_jax_blocked(tmp_path):
    """A spatial (sp=2) step and a 2-stage PipelineForward over a world
    of two gloo ranks, jax, jaxlib and darknet_tpu blocked in every rank
    (a sitecustomize on the ranks' path)."""
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    assert "MP-WORLD" in run_blocked(BLOCKED_MP_WORLD, site=tmp_path)


def test_capi_imports_only_the_port():
    import re

    text = (REPO / "darknet_tpu_torch" / "capi" /
            "darknet_tpu_torch_c.c").read_text()
    mods = re.findall(r'PyImport_ImportModule\("([^"]+)"\)', text)
    assert "darknet_tpu_torch.nn.network" in mods
    assert all(m == "numpy" or m.startswith("darknet_tpu_torch.")
               for m in mods), mods
    assert "jax" not in text


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in (REPO / "darknet_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py", "chip_int8_shapes.py", "chip_region_tiles.py",
        "chip_serve_ab.py"])
def test_no_jax_import_in_source(path):
    text = (REPO / path).read_text()
    for line in text.splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            names = words[1:2] if words[0] == "from" else words[1:]
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "darknet_tpu"), line
