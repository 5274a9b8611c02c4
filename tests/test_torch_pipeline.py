"""The port's pipeline parallelism (`darknet_tpu_torch/parallel/pipeline.py`)
on the CPU: the cut bookkeeping against the JAX package's, the stage
forward against the JAX package's `PipelineForward` and the port's own
unsharded forward.

Tolerances.  Against the port's unsharded forward rtol / atol 1e-6, the
tolerance of tests/test_pipeline.py (there the pipeline against the
unsharded forward within one package); the stages run the same ops in
the same order, and the heads come out equal.  Against the JAX
package's `PipelineForward` the two packages' f32 sums run in other
orders, as they do unsharded: the heads are held at the unsharded
slice's bound, rtol 1e-4 and 1e-5 of each head's largest value
(tests/test_torch_slice.py: "the head logits carry about 1e-5 of their
spread in f32 sum-order noise"; measured up to 2.4e-5 absolute on heads
up to 10, so 1e-6 cannot hold between the packages).  On the CPU the JAX `PipelineForward` plans no
regions (`fuse_regions` defaults to the TPU only), so its cuts may
differ from the port's, which keeps the stem fold and the region in
stage 0; the heads do not depend on the cuts.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

from darknet_tpu import model_zoo as jzoo
from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.parallel import pipeline as jpipe
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.nn.emit import make_forward
from darknet_tpu_torch.parallel import pipeline as tpipe
from tests.test_reference_fuzz import random_cfg
from tests.torch_params import spread_params

torch.set_num_threads(2)


def _graphs(cfg, jcfg=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg), jbuild(jcfg or cfg)


@pytest.mark.parametrize("name", sorted(model_zoo.MODELS))
def test_cut_bookkeeping_equals_jax(name):
    """consumed, crossing_set and plan_cuts with _forbidden_cuts(
    fuse_regions=True, stem_s2d=False): the JAX package's cut rule on the
    TPU, for every zoo cfg at 2-4 stages."""
    g, jg = _graphs(model_zoo.MODELS[name](608, 608),
                    jzoo.MODELS[name](608, 608))
    for i, (l, jl) in enumerate(zip(g.layers, jg.layers)):
        assert tpipe.consumed(l, i) == jpipe.consumed(jl, i)
    for c in range(1, len(g.layers)):
        assert tpipe.crossing_set(g, c) == jpipe.crossing_set(jg, c)
    forb = tpipe._forbidden_cuts(g, fuse_regions=True, stem_s2d=False)
    assert forb == jpipe._forbidden_cuts(jg, fuse_regions=True,
                                         stem_s2d=False)
    for n in (2, 3, 4):
        assert tpipe.plan_cuts(g, n, forbidden=forb) == \
            jpipe.plan_cuts(jg, n, forbidden=forb)


def _near_jax(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()))


def _params(g, px, seed=1):
    x = np.random.default_rng(seed).uniform(0, 1, (2, px, px, 3)).astype(
        np.float32)
    return jparams.fuse_conv_batchnorm(g, spread_params(g, x, 1.5))


@pytest.mark.parametrize("name,px,stages,mb", [("yolov4-tiny", 128, 4, 2),
                                                ("yolov4", 96, 4, 1),
                                                ("yolov4", 96, 2, 2)])
def test_pipeline_matches_jax(name, px, stages, mb):
    """yolov4-tiny-128 over 4 stages, 2 micro-batches; yolov4-96 (the
    neck's back-references cross every cut; the region in stage 0)."""
    g, jg = _graphs(model_zoo.MODELS[name](px, px))
    npar = _params(g, px)
    x = np.random.default_rng(0).uniform(0, 1, (4, px, px, 3)).astype(
        np.float32)
    want = jpipe.PipelineForward(jg, npar, jax.devices()[:stages],
                                 microbatches=mb)(x)
    tp = tparams.params_to_torch(g, npar, "cpu")
    pf = tpipe.PipelineForward(g, tp, ["cpu"] * stages, microbatches=mb)
    if name == "yolov4":
        assert pf.cuts[0] > 23 and pf.fwd.stem     # the region in stage 0
    got = pf(x)
    assert len(got) == len(want) == len(g.heads())
    _near_jax(got, want)
    with torch.inference_mode():
        whole = make_forward(g)(tp, torch.from_numpy(x))["heads"]
    for a, b in zip(got, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


SHARE_CFG = """[net]
width=64
height=64
channels=3
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[convolutional]
filters=16
size=3
stride=1
pad=1
activation=leaky
share_index=-1
[maxpool]
size=2
stride=2
[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky
[convolutional]
size=1
stride=1
pad=1
filters=27
activation=linear
[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23
classes=4
num=3
"""


def test_stage_holds_share_index_owner():
    """A conv that borrows its owner's weights (share_index) stays in the
    owner's stage, which holds the owner's params; the heads equal the
    unsharded forward's and the JAX package's."""
    g, jg = _graphs(SHARE_CFG)
    npar = jparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=2))
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    tp = tparams.params_to_torch(g, npar, "cpu")
    pf = tpipe.PipelineForward(g, tp, ["cpu"] * 3, microbatches=2)
    borrower = next(i for i, l in enumerate(g.layers)
                    if getattr(l, "share_index", None) is not None)
    owner = g.layers[borrower].share_index
    stage = next(s for s in pf.stages if s["lo"] <= borrower < s["hi"])
    assert stage["lo"] <= owner and stage["params"][owner]
    got = pf(x)
    with torch.inference_mode():
        want = make_forward(g)(tp, torch.from_numpy(x))["heads"]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    jwant = jpipe.PipelineForward(jg, npar, jax.devices()[:3],
                                  microbatches=2)(x)
    _near_jax(got, jwant)


# random_cfg seeds (size, width) whose cut at 2 or 3 stages lands right
# after a back-referenced antialiased layer of stride 2 (ROADMAP C5)
AA_CUT_CFGS = [(294, 64, None), (421, 64, None), (441, 64, None),
               (388, 48, 64)]


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("seed,size,width", AA_CUT_CFGS)
def test_cut_after_backref_antialias(seed, size, width, stages):
    """A cut right after a back-referenced antialiased layer (ROADMAP C5):
    the next stage takes the blurred tensor as its input and the stride-1
    view as that layer's output (`pipeline.stage_keys`), and the heads are
    the unsharded forward's at full resolution, within 1e-4 of each
    head's largest value (measured equal).  Held to the unsharded forward
    and not to the JAX `PipelineForward`, which hands the next stage the
    blurred tensor in both roles."""
    g, _jg = _graphs(random_cfg(seed, size, width=width))
    npar = tparams.init_params(g, seed=1)
    tp = tparams.params_to_torch(g, npar, "cpu")
    x = np.random.default_rng(0).uniform(
        0, 1, (4, size, width or size, 3)).astype(np.float32)
    pf = tpipe.PipelineForward(g, tp, ["cpu"] * stages, microbatches=2)
    if stages == 3:
        lo = pf.stages[2]["lo"]
        assert lo - 1 in pf.stages[2]["keys_in"]
    got = pf(x)
    with torch.inference_mode():
        want = make_forward(g)(tp, torch.from_numpy(x))["heads"]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
