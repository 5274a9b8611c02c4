"""The port's `eval/map` and inference image helpers against darknet_tpu's
on the CPU.

Tolerances:
* the PR math, the stub-net `validate_detector` runs and
  `resize_image_darknet` are exact: the same float64 quotients and sums
  in the same order, the same numpy resize;
* the det/GT matcher's rows: prob, class and GT index exact, best IoU
  within 2e-6 relative (the port computes in float32 as the JAX
  package's native matcher does, to within one float32 ulp; the JAX
  Python branch mixes Python floats into the float32 sums);
* real networks (yolov3-tiny, yolov4 at 64 px, f32): n_gt, n_pred and
  mAP equal.  At the validation threshold (.005) every candidate passes
  and NMS runs on the host in reference order, so only a probability
  within f32 noise of another's rank or of the threshold could differ,
  and none does on these seeds;
* `resize_image_cv` and `letterbox_image` within 1e-5 of OpenCV's.
"""

import warnings

import numpy as np
import pytest
import torch

from darknet_tpu.data import image as jimage
from darknet_tpu.eval import map as jmap
from darknet_tpu.nn.network import Detection as JDetection
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu.utils import native
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.data import image as timage
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.eval import map as tmap
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn.network import Detection
from darknet_tpu_torch.weights import io as wio
from tests.torch_params import lively_params

torch.set_num_threads(2)
FIELDS = ("map", "recall", "precision", "n_pred", "n_gt", "map_by_iou",
          "map_mean_iou")


def assert_same_result(a, b):
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.per_class_ap, b.per_class_ap)


def test_pr_math_hand_computed():
    """tests/test_map.py's case: the reference's AP quirk drops recall
    mass present from the first rank, so class 0's AP is 0."""
    val_boxes = [(0.9, 0, True, 0), (0.8, 0, False, -1), (0.7, 1, True, 2),
                 (0.6, 0, True, 0)]
    num_gt_class = np.array([2, 1], np.int64)
    got = tmap._pr_from_valboxes(val_boxes, num_gt_class, 3, 2, 1.0, 4)
    np.testing.assert_array_equal(got.per_class_ap, [0.0, 1.0])
    assert got.map == 0.5
    assert_same_result(got, jmap._pr_from_valboxes(val_boxes, num_gt_class,
                                                   3, 2, 1.0, 4))


def random_valboxes(seed):
    """Seeded rows with tied probs, repeated GT claims and empty
    classes."""
    rng = np.random.default_rng(seed)
    n, c, g = int(rng.integers(0, 400)), int(rng.integers(1, 7)), \
        int(rng.integers(1, 50))
    probs = np.round(rng.uniform(0, 1, n), 2)
    rows = []
    for p in probs:
        m = bool(rng.uniform() < 0.5)
        rows.append((float(p), int(rng.integers(0, c)), m,
                     int(rng.integers(0, g)) if m else -1))
    num_gt_class = np.bincount(rng.integers(0, c, g), minlength=c)
    return rows, num_gt_class.astype(np.int64), g, c


@pytest.mark.parametrize("seed", range(8))
def test_pr_math_random(seed):
    rows, ngc, g, c = random_valboxes(seed)
    assert_same_result(tmap._pr_from_valboxes(rows, ngc, g, c, 1.0, 10),
                       jmap._pr_from_valboxes(rows, ngc, g, c, 1.0, 10))


def python_branch(boxes, probs, gt):
    """The JAX validator's Python matcher (eval/map.py:159-175)."""
    rows = []
    for bbox, p in zip(boxes, probs):
        bbox = tuple(float(v) for v in bbox)
        for cid in np.nonzero(np.abs(p) >= np.finfo(np.float32).eps)[0]:
            gi, best = -1, 0.0
            for k, row in enumerate(gt):
                if int(row[0]) != cid:
                    continue
                iou = jmap._iou_single(bbox, row[1:5])
                if iou > best:
                    best, gi = iou, k
            rows.append((float(p[cid]), cid, gi, best))
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_match_rows(seed):
    """The port's numpy matcher gives the rows of the JAX package's
    Python branch, and of its native matcher where that builds, in the
    same order."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        nd, nc, ng = int(rng.integers(0, 7)), 3, int(rng.integers(0, 6))
        boxes = rng.uniform(0.05, 0.6, (nd, 4)).astype(np.float32)
        probs = (rng.uniform(0, 1, (nd, nc))
                 * (rng.uniform(0, 1, (nd, nc)) > 0.4)).astype(np.float32)
        gt = np.concatenate([rng.integers(0, nc, (ng, 1)),
                             rng.uniform(0.05, 0.6, (ng, 4))],
                            1).astype(np.float32)
        got = list(zip(*tmap._match_rows(boxes, probs, gt)))
        refs = [python_branch(boxes, probs, gt)]
        if native.load() is not None:
            refs.append(native.match_dets_native(boxes, probs, gt, 0.0))
        for ref in refs:
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                assert float(a[0]) == float(b[0])
                assert int(a[1]) == int(b[1]) and int(a[2]) == int(b[2])
                np.testing.assert_allclose(float(a[3]), float(b[3]),
                                           rtol=2e-6)


@pytest.fixture(scope="module")
def png_set(tmp_path_factory):
    """Seeded flat PNGs (the brightness keys the stub's detections) with
    one to three labelled boxes each."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(7)
    paths = []
    for i in range(7):
        p = root / f"im{i}.png"
        timage.write_png(str(p), np.full((40, 48, 3), 20 + 10 * i, np.uint8))
        with open(root / f"im{i}.txt", "w") as f:
            for _ in range(int(rng.integers(1, 4))):
                x, y = rng.uniform(0.2, 0.8, 2)
                w, h = rng.uniform(0.1, 0.3, 2)
                f.write(f"{rng.integers(0, 3)} {x:.6f} {y:.6f} {w:.6f} "
                        f"{h:.6f}\n")
        paths.append(str(p))
    return paths


def stub_net(det_cls):
    """A net whose detect_batch returns canned detections, drawn from a
    seed that the image's brightness sets (padding images get seed 0)."""

    class _N:
        w, h = 32, 24

    class Stub:
        net = _N()

        def __init__(self):
            self.shapes = []

        def detect_batch(self, x, thresh=0.005, nms=0.45):
            self.shapes.append(x.shape)
            out = []
            for img in x:
                rng = np.random.default_rng(int(round(img.mean() * 255)))
                dets = []
                for _ in range(int(rng.integers(0, 6))):
                    prob = (rng.uniform(0, 1, 3)
                            * (rng.uniform(0, 1, 3) > 0.5)).astype(np.float32)
                    box = rng.uniform(0.1, 0.8, 4).astype(np.float32)
                    dets.append(det_cls(bbox=tuple(float(v) for v in box),
                                        objectness=float(prob.max()),
                                        prob=prob))
                out.append(dets)
            return out
    return Stub()


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("sweep", [None, jmap.COCO_IOUS])
def test_validate_detector_stub(png_set, batch, sweep):
    """Both validators on one canned-detection stub: equal MapResults
    (the IoU sweep too); batch 2 and 3 end on a ragged chunk, which is
    zero-padded to the batch."""
    kw = dict(classes=3, batch=batch, progress=False, threads=3,
              iou_thresholds=sweep)
    tnet, jnet = stub_net(Detection), stub_net(JDetection)
    got = tmap.validate_detector(tnet, png_set, **kw)
    want = jmap.validate_detector(jnet, png_set, **kw)
    n_gt = 0
    for p in png_set:
        with open(p[:-len(".png")] + ".txt") as f:
            n_gt += len(f.readlines())
    assert got.n_pred > 0 and got.n_gt == n_gt
    assert_same_result(got, want)
    assert all(s[0] == batch for s in tnet.shapes)
    assert tnet.shapes == jnet.shapes


def test_mesh_refused(png_set):
    """The mesh reaches the network's detect_batch, which refuses an
    'sp' axis over processes on a mesh that is not a grid over the world
    (`parallel.mesh.world_mesh`, which tests/test_torch_mp_serve.py
    serves on); an 'sp' mesh of one process validates as one device
    does.  Mesh validation itself is tests/test_torch_parallel.py."""
    from darknet_tpu_torch.parallel.mesh import Mesh

    net = Network.from_cfg(model_zoo.MODELS["yolov3-tiny"](64, 64,
                                                          classes=3),
                           device="cpu")
    cpu = torch.device("cpu")
    sp = Mesh({"dp": 1, "sp": 2}, (cpu,), group=object())
    with pytest.raises(ValueError, match="world_mesh"):
        tmap.validate_detector(net, png_set, classes=3, mesh=sp,
                               progress=False)
    got = tmap.validate_detector(net, png_set, classes=3, progress=False,
                                 mesh=Mesh({"dp": 1, "sp": 2}, (cpu,) * 2))
    want = tmap.validate_detector(net, png_set, classes=3, progress=False)
    for f in ("map", "recall", "precision", "n_pred", "n_gt"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    return synth.generate(str(tmp_path_factory.mktemp("syn")), n_train=0,
                          n_val=6, seed=3)


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov4"])
def test_real_networks_match(synth_set, tmp_path, name):
    cfg = model_zoo.MODELS[name](64, 64, classes=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(cfg)
        path = str(tmp_path / "w.weights")
        wio.save_weights(g, lively_params(g), path)
        jnet = JaxNetwork.from_cfg(cfg, weights=path)
        tnet = Network.from_cfg(cfg, weights=path, device="cpu")
    for resize in ("darknet", "cv"):
        kw = dict(classes=4, batch=4, progress=False, resize=resize)
        got = tmap.validate_detector(tnet, synth_set["val_paths"], **kw)
        want = jmap.validate_detector(jnet, synth_set["val_paths"], **kw)
        assert got.n_gt == want.n_gt > 0
        assert got.n_pred == want.n_pred > 0
        assert got.map == want.map
        np.testing.assert_array_equal(got.per_class_ap, want.per_class_ap)


@pytest.mark.parametrize("shape,wh", [((37, 53, 3), (64, 64)),
                                      ((64, 64, 3), (64, 64)),
                                      ((100, 80, 3), (33, 17)),
                                      ((2, 9, 3), (8, 5))])
def test_image_helpers_match(shape, wh):
    im = np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(
        np.float32)
    got = timage.resize_image_darknet(im, *wh)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jimage.resize_image_darknet(im, *wh))
    np.testing.assert_allclose(timage.resize_image_cv(im, *wh),
                               jimage.resize_image_cv(im, *wh), atol=1e-5)
    np.testing.assert_allclose(timage.letterbox_image(im, *wh),
                               jimage.letterbox_image(im, *wh), atol=1e-5)
    boxes = np.random.default_rng(1).uniform(0.1, 0.9, (5, 4))
    np.testing.assert_array_equal(
        timage.correct_boxes_letterbox(boxes, shape[1], shape[0], *wh),
        jimage.correct_boxes_letterbox(boxes, shape[1], shape[0], *wh))
