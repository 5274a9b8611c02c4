"""The port's streaming CLI (`darknet_tpu_torch/apps/cli.py` -mode image,
video and multi-video, -device cpu) against the JAX package's CLI on the
same decoded frames, and the trainer's loss chart.

A yolov3-tiny at 128 px (80 classes) with lively `.weights` (BN scales
1.5, head convs x4: its heads do not tie at 0.5) reads y4m clips of
moving blocks; the port's reader is patched to cv2.VideoCapture so that
both CLIs see cv2's frames.  Spies on both `_host_tail`s record each
frame's most-prob detections and the tracker's visible tracks.  The port
equals the JAX CLI frame by frame: detections' boxes within 1e-5
(absolute, and relative where a box's size exceeds 1: exp(tw) carries
the f32 noise) and probs within 1e-5, classes exact; tracks' boxes
likewise, labels (both label counters reset to 0) and statuses exact;
and the printed counts.  Cases: image
(host and device NMS), video (tracking on and off, -device_nms on and
off, depths 1 and 2, -save_output), multi-video (-letter_box, a geo XML
with a parking lot and a handover zone, host and device NMS).
"""

import os
import warnings

import cv2
import numpy as np
import pytest
import torch

from darknet_tpu.apps import cli as jcli
from darknet_tpu.apps import tracker as jtracker
from darknet_tpu_torch.apps import cli
from darknet_tpu_torch.apps import tracker as ttracker
from darknet_tpu_torch.data import video
from darknet_tpu_torch.data.image import read_png, write_png
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.weights import io as wio
from tests.torch_params import lively_params

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov3-tiny.cfg")
TOL = 1e-5
FRAMES = 8

GEO_XML = """<polygons>
  <polygon><name>P1</name><num>4</num>
    <x0>0.05</x0><y0>0.2</y0><x1>0.6</x1><y1>0.2</y1>
    <x2>0.6</x2><y2>0.75</y2><x3>0.05</x3><y3>0.75</y3></polygon>
  <polygon><name>HANDOVER</name><num>4</num>
    <x0>0.5</x0><y0>0.1</y0><x1>0.98</x1><y1>0.1</y1>
    <x2>0.98</x2><y2>0.9</y2><x3>0.5</x3><y3>0.9</y3></polygon>
</polygons>
"""


def _frames(seed, h=120, w=160):
    rng = np.random.default_rng(seed)
    bg = np.repeat(np.repeat(rng.integers(60, 200, (h // 20, w // 20, 3)),
                             20, 0), 20, 1).astype(np.uint8)
    out = []
    for t in range(FRAMES):
        f = bg.copy()
        f[30:80, 20 + 8 * t:60 + 8 * t] = (40, 90, 210)
        f[70:110, 130 - 6 * t:150 - 6 * t] = (220, 220, 40)
        out.append(f)
    return out


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("apps_cli")
    with open(FIXTURE) as f:
        text = f.read().replace("width=416", "width=128").replace(
            "height=416", "height=128")
    (root / "m.cfg").write_text(text)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(text)
    heads = {l.index - 1: 4.0 for l in g.layers if l.kind == "yolo"}
    wio.save_weights(g, lively_params(g, head_gain=heads),
                     str(root / "m.weights"))
    (root / "names").write_text("\n".join(f"c{i}" for i in range(80)))
    (root / "t.data").write_text(f"classes=80\nnames={root / 'names'}\n")
    video.write_y4m(str(root / "cam0.y4m"), _frames(0), 10)
    video.write_y4m(str(root / "cam1.y4m"), _frames(1)[::-1], 10)
    write_png(str(root / "img.png"), _frames(2)[3][..., ::-1])
    (root / "zones.xml").write_text(GEO_XML)
    return root


def _spy(monkeypatch, mod, log):
    tail = mod._host_tail

    def spy(net, md, frame_bgr, dets, args, track_manager=None):
        out = tail(net, md, frame_bgr, dets, args, track_manager)
        tracks = [] if track_manager is None else [
            (t.bbox, t.label, t.status, t.det.cid, t.det.prob)
            for t in track_manager.get_tracks()]
        log.append(([(d.bbox, d.cid, d.prob) for d in out[1]], tracks))
        return out
    monkeypatch.setattr(mod, "_host_tail", spy)


CASES = {
    "image-host": (["-mode", "image", "-input_file", "img.png",
                    "-device_nms", "off"]),
    "image-device": (["-mode", "image", "-input_file", "img.png",
                      "-device_nms", "on"]),
    "video-host": ["-mode", "video", "-input_file", "cam0.y4m",
                   "-device_nms", "off", "-save_output"],
    "video-host-untracked": ["-mode", "video", "-input_file", "cam0.y4m",
                             "-device_nms", "off", "-disable_tracking"],
    "video-device-depth2": ["-mode", "video", "-input_file", "cam0.y4m",
                            "-device_nms", "on", "-pipeline_depth", "2"],
    "video-device-depth1": ["-mode", "video", "-input_file", "cam0.y4m",
                            "-device_nms", "on", "-pipeline_depth", "1"],
    "video-device-untracked": ["-mode", "video", "-input_file", "cam0.y4m",
                               "-device_nms", "on", "-disable_tracking"],
    "multi-video-host": ["-mode", "multi-video", "-input_file",
                         "cam0.y4m,cam1.y4m", "-letter_box",
                         "-geo_info_file", "zones.xml", "-device_nms",
                         "off"],
    "multi-video-device": ["-mode", "multi-video", "-input_file",
                           "cam0.y4m,cam1.y4m", "-letter_box",
                           "-geo_info_file", "zones.xml", "-device_nms",
                           "on", "-pipeline_depth", "2"],
}


def _argv(root, extra, out_dir):
    files = {"img.png", "cam0.y4m", "cam1.y4m", "zones.xml",
             "cam0.y4m,cam1.y4m"}
    extra = [",".join(str(root / p) for p in a.split(","))
             if a in files else a for a in extra]
    return ["-data_file", str(root / "t.data"), "-model_file",
            str(root / "m.cfg"), "-weights_file", str(root / "m.weights"),
            "-thresh", "0.3", "-out_dir", str(out_dir), *extra]


def _counts(out):
    """The printed lines that count: frames processed, objects found."""
    keep = []
    for line in out.splitlines():
        if line.startswith("processed"):
            keep.append(line)
        elif " objects, " in line:
            keep.append(line.split(" objects, ")[0])
        elif line.startswith("  c") and line.endswith("%"):
            keep.append(line)
    return keep


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_cli_matches_jax(run_dir, tmp_path, case, monkeypatch,
                                   capsys):
    root = run_dir
    monkeypatch.setattr("darknet_tpu.utils.cache.enable_persistent_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(video, "open_video",
                        lambda p: video._CvReader(cv2.VideoCapture(p)))
    logs, outs = {}, {}
    for name, main, mod, trk, extra in (
            ("port", cli.main, cli, ttracker, ["-device", "cpu"]),
            ("jax", jcli.main, jcli, jtracker, [])):
        logs[name] = []
        trk.Track._shared_label = 0
        with monkeypatch.context() as m:
            _spy(m, mod, logs[name])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                main(_argv(root, CASES[case], tmp_path / name) + extra)
        outs[name] = capsys.readouterr().out
    port, ref = logs["port"], logs["jax"]
    n_cams = 2 if case.startswith("multi") else 1
    assert len(port) == len(ref) == (1 if case.startswith("image")
                                     else FRAMES * n_cams)
    assert _counts(outs["port"]) == _counts(outs["jax"])
    n_dets = n_tracks = 0
    for (pd, pt), (rd, rt) in zip(port, ref):
        assert [d[1] for d in pd] == [d[1] for d in rd]
        for a, b in zip(pd, rd):
            np.testing.assert_allclose(a[0], b[0], rtol=TOL, atol=TOL)
            assert abs(a[2] - b[2]) <= TOL
        assert [t[1:4] for t in pt] == [t[1:4] for t in rt]
        for a, b in zip(pt, rt):
            np.testing.assert_allclose(a[0], b[0], rtol=TOL, atol=TOL)
        n_dets += len(pd)
        n_tracks += len(pt)
    assert n_dets > 0
    if "video" in case and "untracked" not in case:
        assert n_tracks > 0
    if case.startswith("image"):
        out = read_png(str(tmp_path / "port" / "det_img.png"))
        assert out.shape == (120, 160, 3)
    if case == "video-host":
        cap = cv2.VideoCapture(str(tmp_path / "port" / "cam0_out.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == FRAMES
        cap.release()


def test_trainer_draws_loss_chart(tmp_path, monkeypatch):
    """The port's trainer draws chart.png every 10th iteration and at the
    end, through its own primitives and PNG codec."""
    from darknet_tpu_torch.apps import visualize as viz
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.train.trainer import DetectorTrainer
    from tests.test_torch_nojax import TRAIN_CFG

    files = synth.generate(str(tmp_path / "data"), n_train=8, n_val=0,
                           seed=1)
    drawn = []
    draw = viz.draw_loss_chart

    def spy(iters, *a, **k):
        img = draw(iters, *a, **k)
        drawn.append((iters[-1], len(iters), read_png(k["path"]).shape))
        return img

    monkeypatch.setattr(viz, "draw_loss_chart", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = DetectorTrainer(TRAIN_CFG.replace(
            "burn_in=0", "burn_in=0\nmax_epoch=6"), files["train_paths"],
                                  classes=4,
                                  save_dir=str(tmp_path / "backup"),
                                  device="cpu", loader_processes=0,
                                  log=lambda *_: None)
        try:
            trainer.train(max_iters=11)
        finally:
            trainer.close()
    assert drawn == [(10, 10, (720, 1000, 3)), (11, 11, (720, 1000, 3))]
    assert (tmp_path / "backup" / "chart.png").exists()


@pytest.mark.parametrize("mode", ["image", "video", "multi-video"])
def test_streaming_needs_a_card_or_cpu(run_dir, tmp_path, mode):
    """Without -device cpu the streaming modes run on the card, and
    without a card they raise: they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(_argv(run_dir, ["-mode", mode, "-input_file", "cam0.y4m"],
                       tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_video_decode_failure_raises(run_dir, tmp_path, monkeypatch):
    """A reader that fails mid-clip stops the video mode with the error
    (the frames before it processed), not a hang or a silent end."""
    open_video = video.open_video

    class Failing:
        def __init__(self, path):
            self._r, self._n = open_video(path), 0
            self.fps, self.frame_count = self._r.fps, self._r.frame_count

        def isOpened(self):
            return True

        def read(self):
            self._n += 1
            if self._n > 3:
                raise ValueError("corrupt frame")
            return self._r.read()

        def release(self):
            self._r.release()

    monkeypatch.setattr(video, "open_video", Failing)
    with pytest.raises(RuntimeError, match="reading a frame failed") as e, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(_argv(run_dir, CASES["video-device-depth2"],
                       tmp_path / "out") + ["-device", "cpu"])
    assert isinstance(e.value.__cause__, ValueError)
