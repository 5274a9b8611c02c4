"""darknet_tpu_torch stands alone: a subprocess blocks jax, jaxlib and the
JAX package `darknet_tpu` with a meta-path finder, imports the port and
serves yolov4 at 64 px on the CPU, in f32 and in int8 (quantized,
calibrated); and no source of the port, nor the chip scripts
(chip_smoke.py, chip_int8_shapes.py, chip_region_tiles.py), imports any
of the three."""

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


def test_port_serves_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", BLOCKED_SERVE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in (REPO / "darknet_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py", "chip_int8_shapes.py", "chip_region_tiles.py"])
def test_no_jax_import_in_source(path):
    text = (REPO / path).read_text()
    for line in text.splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            names = words[1:2] if words[0] == "from" else words[1:]
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "darknet_tpu"), line
