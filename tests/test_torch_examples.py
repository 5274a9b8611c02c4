"""The port's walkthroughs (`darknet_tpu_torch/examples`, twins of
examples/01-04) end to end on the CPU (--device cpu), in a subprocess
each, sharing one workdir like a user following them in order, at the
originals' test sizes (`tests/test_examples.py`)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "darknet_tpu_torch", "examples")


def _run(example: str, *args: str, timeout: int = 600) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, example), *args,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, (
        f"{example} failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return r.stdout


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("shapes_demo"))
    out = _run("01_train_synthetic.py", "--workdir", workdir,
               "--iters", "12", "--images", "48")
    return workdir, out


def test_01_train_synthetic(trained):
    workdir, out = trained
    assert "final EMA loss:" in out and "mAP@0.5" in out
    assert os.path.exists(os.path.join(workdir, "backup",
                                       "shapes_final.weights"))


def test_02_detect(trained):
    workdir, _ = trained
    out = _run("02_detect.py", "--workdir", workdir, "--thresh", "0.01")
    assert "JSON:" in out
    assert os.path.exists(os.path.join(workdir, "detections.png"))


def test_03_serving_export(trained):
    workdir, _ = trained
    out = _run("03_serving_export.py", "--workdir", workdir,
               "--batch", "4")
    assert "img/s" in out and "torch.export artifact" in out
    assert os.path.exists(os.path.join(workdir, "shapes_serving.pt2"))


def test_04_video_tracking(trained):
    workdir, _ = trained
    out = _run("04_video_tracking.py", "--workdir", workdir)
    assert "output video:" in out
    assert os.path.exists(os.path.join(workdir, "tracking.y4m"))
