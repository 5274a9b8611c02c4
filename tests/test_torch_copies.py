"""The port's own copies of the cfg parser, graph builder, `.weights` io
and model zoo against darknet_tpu's, on the CPU; and the port's entry
points, which run on the card unless the caller names the CPU.

The copies must build the same graphs and read and write the same bytes:
every cfg of the model zoo and every cfg text of the port's tests builds
the same layers in both packages, compared field by field; `.weights`
files written by either package are byte-equal and load back to equal
arrays in the other.  The copies of `resize_image_darknet`,
`detections_to_json` and the eval PR math give the originals' results
on seeded inputs, exactly.
"""

import dataclasses
import pathlib
import warnings

import numpy as np
import pytest
import torch

from darknet_tpu import model_zoo as jzoo
from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.weights import io as jio
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.weights import io as tio
from tests.test_fused_region import CSP_CFG
from tests.test_reference_fuzz import random_cfg
from tests.test_torch_bf16 import CFG as BF16_CFG
from tests.test_torch_int8 import CONV_CFG

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "yolov3-tiny.cfg"

ZOO = [(name, (px, px)) for name in sorted(jzoo.MODELS)
       for px in (64, 416)] + [("yolov3-spp", (416, 416)),
                               ("yolov4", (608, 608))]


def _zoo_cfg(zoo, name, wh):
    fn = zoo.yolov3_spp_cfg if name == "yolov3-spp" else zoo.MODELS[name]
    return fn(*wh)


def _build(fn, cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(cfg)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same_graph(cfg):
    got, want = _build(build_graph, cfg), _build(jbuild, cfg)
    assert _fields(got.net) == _fields(want.net)
    assert len(got.layers) == len(want.layers)
    for a, b in zip(got.layers, want.layers):
        assert type(a).__name__ == type(b).__name__
        assert _fields(a) == _fields(b), a.index


@pytest.mark.parametrize("name,wh", ZOO)
def test_model_zoo_copy(name, wh):
    cfg = _zoo_cfg(model_zoo, name, wh)
    assert cfg == _zoo_cfg(jzoo, name, wh)
    _same_graph(cfg)


@pytest.mark.parametrize("which", ["fixture", "csp", "int8-convs", "bf16",
                                   "random116", "random162", "random450"])
def test_builder_copy_on_test_cfgs(which):
    cfg = {"fixture": FIXTURE.read_text() if FIXTURE.exists() else None,
           "csp": CSP_CFG, "int8-convs": CONV_CFG, "bf16": BF16_CFG}.get(
        which) or random_cfg(int(which[len("random"):]))
    _same_graph(cfg)


@pytest.mark.parametrize("name", ["yolov4", "yolov3-tiny"])
def test_weights_io_copy_round_trip(name, tmp_path):
    """Both writers give byte-equal files from the same params, and each
    package reads the other's file back to equal arrays."""
    cfg = _zoo_cfg(model_zoo, name, (64, 64))
    g = _build(build_graph, cfg)
    params = tparams.init_params(g, seed=5)
    rng = np.random.default_rng(5)
    for p in params:
        for k in p:
            p[k] = rng.normal(size=p[k].shape).astype(np.float32)
    tpath, jpath = tmp_path / "t.weights", tmp_path / "j.weights"
    tio.save_weights(g, params, str(tpath), seen=123)
    jio.save_weights(_build(jbuild, cfg), params, str(jpath), seen=123)
    assert tpath.read_bytes() == jpath.read_bytes()
    for loader, path in ((tio.load_weights, jpath), (jio.load_weights, tpath)):
        loaded, seen, version = loader(g, str(path))
        assert seen == 123 and tuple(version[:3]) == tio.WEIGHTS_VERSION
        for p, q in zip(loaded, params):
            assert p.keys() == q.keys()
            for k in p:
                np.testing.assert_array_equal(p[k], q[k])


def test_port_init_matches_on_port_graph():
    """The port's numpy init over its own graph equals the JAX package's
    init over the JAX graph, byte for byte."""
    cfg = model_zoo.yolov4_cfg(64, 64)
    a = tparams.init_params(_build(build_graph, cfg), seed=2)
    b = jparams.init_params(_build(jbuild, cfg), seed=2)
    for p, q in zip(a, b):
        assert p.keys() == q.keys()
        for k in p:
            assert p[k].tobytes() == q[k].tobytes()


def test_entry_points_default_to_the_card():
    """Without a card, an entry point that is not told device="cpu"
    raises instead of serving on the CPU; named, the CPU serves."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    cfg = model_zoo.yolov4_tiny_cfg(64, 64)
    g = _build(build_graph, cfg)
    npar = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Network.from_cfg(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tparams.params_to_torch(g, npar)
    tp = tparams.params_to_torch(g, npar, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Network(g, tp)
    net = Network(g, tp, device="cpu")
    assert net.device == torch.device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert Network.from_cfg(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module", ["config/metadata.py", "utils/metrics.py",
                                    "data/labels.py", "train/schedule.py"])
def test_verbatim_copies(module):
    """The training slice's jax-free modules are copied whole: the same
    code as the JAX package's, the module docstring aside."""
    import ast

    repo = pathlib.Path(__file__).resolve().parents[1]

    def body(pkg):
        tree = ast.parse((repo / pkg / module).read_text())
        return [ast.dump(n) for n in tree.body
                if not (isinstance(n, ast.Expr)
                        and isinstance(n.value, ast.Constant))]
    assert body("darknet_tpu_torch") == body("darknet_tpu")


def _copied_outputs(pkg_image, pkg_network, pkg_map, seed):
    """The copied functions' results on inputs drawn from `seed`."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(v) for v in rng.integers(2, 40, 2)) + (3,)
    im = rng.uniform(0, 1, shape).astype(np.float32)
    out = [pkg_image.resize_image_darknet(im, *(int(v) for v in
                                                rng.integers(1, 50, 2)))]
    dets = []
    for _ in range(int(rng.integers(0, 5))):
        prob = (rng.uniform(0, 1, 4) * (rng.uniform(0, 1, 4) > 0.5)).astype(
            np.float32)
        dets.append(pkg_network.Detection(
            bbox=tuple(float(v) for v in rng.uniform(0, 1, 4)),
            objectness=float(prob.max(initial=0.0)), prob=prob))
    out.append(pkg_network.detections_to_json(
        dets, frame_id=seed, names=["a", "dont_show", "c", "d"],
        filename=f"f{seed}.png"))
    rows = [(float(rng.uniform()), int(rng.integers(0, 3)),
             bool(m), int(rng.integers(0, 9)) if m else -1)
            for m in rng.uniform(0, 1, int(rng.integers(0, 60))) < 0.5]
    r = pkg_map._pr_from_valboxes(rows, np.asarray([3, 4, 2], np.int64), 9,
                                  3, 1.0, 5)
    out.append((r.map, r.recall, r.precision, r.n_pred, r.n_gt,
                r.per_class_ap.tolist()))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_copied_functions_agree(seed):
    """resize_image_darknet, detections_to_json and the eval PR math give
    the originals' results, exactly, on seeded inputs."""
    from darknet_tpu.data import image as jimage
    from darknet_tpu.eval import map as jmap
    from darknet_tpu.nn import network as jnetwork
    from darknet_tpu_torch.data import image as timage
    from darknet_tpu_torch.eval import map as tmap
    from darknet_tpu_torch.nn import network as tnetwork

    got = _copied_outputs(timage, tnetwork, tmap, seed)
    want = _copied_outputs(jimage, jnetwork, jmap, seed)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
