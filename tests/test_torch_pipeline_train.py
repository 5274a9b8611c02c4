"""The port's pipeline training (`darknet_tpu_torch/parallel/pipeline.
PipelineTrain`) and the training forward's stage-slice mode on the CPU,
the CPU named once a stage: against the JAX package's `PipelineTrain`
and the port's own `train/step.make_train_step(accum=M)`.

Tolerances:
* against the JAX package: the tolerance of tests/test_pipeline.py
  (there the pipeline against `make_train_step(accum=2)` within one
  package): cost rtol 1e-4 / atol 1e-5, params rtol 2e-4 / atol 5e-5;
* against the port's unsharded step: equal, bitwise (measured).  Every
  stage runs the unsharded forward's ops on the same micro-batch in the
  same order on one device, and the backward's per-stage sums meet the
  same values: the cut only adds copies.  yolov4-96 (one micro-batch, 4
  stages, the neck's back-references crossing every cut) is held as
  tests/test_pipeline.py holds it, to the update's cosine > 0.98 and
  norm ratio in (0.85, 1.15) at layers 0, 54, 85 and the last conv, and
  measured bitwise too;
* the slice mode with a generator: bitwise the unsliced forward; a
  step with a generator: bitwise the unsharded step given the same seed.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

from darknet_tpu import model_zoo as jzoo
from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.nn.emit import make_forward as jmake_forward
from darknet_tpu.parallel import pipeline as jpipe
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.nn.emit import make_forward
from darknet_tpu_torch.parallel import pipeline as tpipe
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
from test_torch_pipeline import AA_CUT_CFGS, SHARE_CFG, random_cfg
from torch_params import chip_smoke

torch.set_num_threads(2)


def _graphs(cfg, train=True):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg, train=train), jbuild(cfg, train=train)


def _unsharded(g, p0, x, truths, accum, iters=1):
    step = make_train_step(g, accum=accum)
    p = tparams.train_params_to_torch(g, p0, "cpu")
    o = init_opt_state(g, p)
    for _ in range(iters):
        p, o, c, m = step(p, o, torch.from_numpy(x), torch.from_numpy(truths),
                          1e-3)
    return tparams.train_params_to_numpy(g, p), c, m


def _equal(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), i
        for k in b:
            assert np.array_equal(a[k], b[k]), (i, k)


def test_train_slice_mode_with_generator_bitwise():
    """The dropout cfg of tests/test_pipeline.py: slices [0, 3) and
    [3, end) run in order with one generator draw the unsliced forward's
    masks, bitwise (the port's form of the JAX package's key offset)."""
    cfg = model_zoo._net(64, 64, 2, 1)
    cfg += model_zoo._conv(16, 3, 1, act="leaky")
    cfg += "[dropout]\nprobability=.3\n\n"
    cfg += model_zoo._conv(16, 3, 1, act="leaky")
    cfg += "[dropout]\nprobability=.4\n\n"
    cfg += model_zoo._conv(33, 1, 1, act="linear")
    cfg += ("[yolo]\nmask=0,1,2\nnum=3\nclasses=6\n"
            "anchors=10,10, 20,20, 30,30\n\n")
    g, _jg = _graphs(cfg)
    p = tparams.train_params_to_torch(g, tparams.init_params(g, seed=2),
                                      "cpu")
    fwd = make_forward(g, train=True)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    full = fwd(p, x, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    mid = fwd(p, x, gen, _lo=0, _hi=3)
    part = fwd(p, mid["output"], gen, _lo=3, _extern=mid["outs"])
    assert "outs" in mid and "outs" in part and "outs" not in full
    assert torch.equal(part["heads"][0], full["heads"][0])
    assert torch.equal(part["raw_heads"][0], full["raw_heads"][0])
    stats = {**mid["bn_stats"], **part["bn_stats"]}
    assert stats.keys() == full["bn_stats"].keys()
    for i, (m, v) in full["bn_stats"].items():
        assert torch.equal(stats[i][0], m) and torch.equal(stats[i][1], v)
    # and the masks are drawn: another seed moves the heads
    other = fwd(p, x, torch.Generator().manual_seed(4))
    assert not torch.equal(other["heads"][0], full["heads"][0])


def drop_cfg(accum):
    """A net whose 3-stage cuts (at layers 4 and 6) leave a random layer
    in every stage (the second's a dropblock): their masks draw from the
    generator's state handed across the cuts, as the unsliced step draws
    them."""
    cfg = model_zoo._net(64, 64, 4, accum)
    cfg += model_zoo._conv(16, 3, 1, act="leaky")
    cfg += model_zoo._conv(16, 3, 1, act="leaky")
    cfg += "[dropout]\nprobability=.3\n\n"
    cfg += model_zoo._conv(32, 3, 2, act="leaky")
    cfg += ("[dropout]\nprobability=.2\ndropblock=1\n"
            "dropblock_size_abs=3\n\n")
    cfg += model_zoo._conv(32, 3, 1, act="leaky")
    cfg += model_zoo._conv(32, 3, 1, act="leaky")
    cfg += "[dropout]\nprobability=.4\n\n"
    cfg += model_zoo._conv(27, 1, 1, act="linear", bn=False)
    return cfg + ("[yolo]\nmask=0,1,2\nnum=3\nclasses=4\n"
                  "anchors=10,13, 16,30, 33,23\n\n")


@pytest.mark.parametrize("n_stages", [2, 3])
def test_train_with_generator_bitwise(n_stages):
    """A step with a generator over 2 and 3 stages (a random layer in
    every stage at 3): bitwise the unsharded step given the same seed,
    the generator left in the same state."""
    g, _jg = _graphs(drop_cfg(2))
    p0 = tparams.init_params(g, seed=0)
    x = np.random.default_rng(6).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)
    y = np.zeros((4, 8, 5), np.float32)
    y[:, 0] = [0.5, 0.5, 0.25, 0.25, 1]
    pt = tpipe.PipelineTrain(g, p0, ["cpu"] * n_stages, microbatches=2)
    gen = torch.Generator().manual_seed(3)
    cost, _m = pt.step(x, y, 1e-3, generator=gen)
    p = tparams.train_params_to_torch(g, p0, "cpu")
    ref_gen = torch.Generator().manual_seed(3)
    p, _o, c_ref, _m = make_train_step(g, accum=2)(
        p, init_opt_state(g, p), torch.from_numpy(x), torch.from_numpy(y),
        1e-3, ref_gen)
    _equal(tparams.train_params_to_numpy(g, pt.gather_params()),
           tparams.train_params_to_numpy(g, p))
    assert float(cost) == float(c_ref)
    assert torch.equal(gen.get_state(), ref_gen.get_state())


@pytest.mark.parametrize("name", sorted(model_zoo.MODELS))
def test_train_cut_rule_equals_jax(name):
    """_forbidden_cuts(train=True) and plan_cuts at 2-4 stages: the JAX
    `PipelineTrain`'s rule off the TPU (no region, its training forward's
    own plans), for every zoo cfg."""
    g, jg = _graphs(model_zoo.MODELS[name](608, 608), train=False)
    forb = tpipe._forbidden_cuts(g, fuse_regions=True, stem_s2d=False,
                                 train=True)
    jfwd = jmake_forward(jg, train=True, fuse_regions=False)
    jforb = jpipe._forbidden_cuts(jg, fuse_regions=False, stem_s2d=False,
                                  train=True, fwd=jfwd)
    assert forb == jforb
    for n in (2, 3, 4):
        assert tpipe.plan_cuts(g, n, forbidden=forb) == \
            jpipe.plan_cuts(jg, n, forbidden=jforb)


def test_pipeline_train_matches_jax_and_accum():
    """yolov4-tiny-128, 4 stages, 2 micro-batches, 2 iterations, the
    truths of tests/test_pipeline.py.  The pixels are seed 10's: a batch
    whose two steps move by at most 5.6e-5 under two 1e-7 input changes.
    With that test's seed (1234) a near-tie (a leaky input or a maxpool
    window within f32 noise) falls the other way in the two packages and
    moves layer 0's "b" by 3.9e-4; the other seeds of 0-11 move by 6e-4
    to 2e-3 under the same input changes but seed 4 (6.2e-5), which
    still takes a near-tie of layer 0 the other way."""
    cfg = model_zoo.yolov4_tiny_cfg(128, 128, batch=4, subdiv=2)
    g, jg = _graphs(cfg)
    p0 = tparams.init_params(g, seed=0)
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32)
    truths = np.zeros((4, 6, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    truths[:, 1] = [0.25, 0.7, 0.2, 0.4, 2]
    key = jax.random.PRNGKey(9)
    jpt = jpipe.PipelineTrain(jg, p0, jax.devices()[:4], microbatches=2)
    pt = tpipe.PipelineTrain(g, p0, ["cpu"] * 4, microbatches=2)
    assert pt.cuts == jpt_cuts(jpt)
    for it in range(2):
        jcost, jm = jpt.step(x, truths, jax.random.fold_in(key, it), 1e-3)
        cost, m = pt.step(x, truths, 1e-3)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-4,
                               atol=1e-5)
    assert float(m["count"]) == float(jm["count"])
    got = tparams.train_params_to_numpy(g, pt.gather_params())
    want = jpt.gather_params()
    for i, (a, b) in enumerate(zip(got, want)):
        for k in b:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=2e-4,
                                       atol=5e-5, err_msg=f"layer {i} {k}")
    ref, c_ref, m_ref = _unsharded(g, p0, x, truths, 2, iters=2)
    _equal(got, ref)
    assert float(cost) == float(c_ref)
    assert all(float(m[k]) == float(m_ref[k]) for k in m_ref)


def jpt_cuts(jpt):
    return [st["lo"] for st in jpt.stages[1:]]


def test_pipeline_train_yolov4_backref_cotangents():
    """yolov4-96, 4 stages, one micro-batch: the neck's routes to layers
    54 and 85 cross cuts, so their gradients sum a local path and paths
    through intermediate stages; held as tests/test_pipeline.py holds
    the JAX pipeline (cosine, norm ratio), and bitwise as measured."""
    g, _jg = _graphs(model_zoo.yolov4_cfg(96, 96, batch=2, subdiv=1))
    p0 = tparams.init_params(g, seed=3)
    x = np.random.default_rng(1234).uniform(0, 1, (2, 96, 96, 3)).astype(
        np.float32)
    truths = np.zeros((2, 4, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.4, 0.4, 0]
    pt = tpipe.PipelineTrain(g, p0, ["cpu"] * 4, microbatches=1)
    assert any(54 in st["keys_in"] for st in pt.stages[1:])
    assert any(85 in st["keys_in"] for st in pt.stages[1:])
    cost, _m = pt.step(x, truths, 1e-3)
    got = tparams.train_params_to_numpy(g, pt.gather_params())
    ref, c_ref, _m = _unsharded(g, p0, x, truths, 1)
    np.testing.assert_allclose(float(cost), float(c_ref), rtol=1e-4,
                               atol=1e-5)
    last = max(i for i, l in enumerate(g.layers)
               if l.kind == "convolutional")
    for i in (0, 54, 85, last):
        for k in ref[i]:
            da = got[i][k].astype(np.float64) - p0[i][k]
            db = ref[i][k].astype(np.float64) - p0[i][k]
            na, nb = np.linalg.norm(da), np.linalg.norm(db)
            assert nb > 0, (i, k)
            assert float(da.ravel() @ db.ravel() / (na * nb)) > 0.98, (i, k)
            assert 0.85 < na / nb < 1.15, (i, k)
    _equal(got, ref)


def test_stage_holds_share_index_owner():
    """A conv that borrows its owner's weights stays in the owner's
    stage, whose params, grads and slots hold the owner's; the step
    equals the unsharded accum=2 step."""
    cfg = SHARE_CFG.replace("[net]\n", "[net]\nbatch=4\nsubdivisions=2\n"
                            "burn_in=0\n", 1)
    g, _jg = _graphs(cfg)
    p0 = tparams.init_params(g, seed=2)
    x = np.random.default_rng(2).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)
    truths = np.zeros((4, 4, 5), np.float32)
    truths[:, 0] = [0.4, 0.6, 0.3, 0.2, 1]
    pt = tpipe.PipelineTrain(g, p0, ["cpu"] * 3, microbatches=2)
    borrower = next(i for i, l in enumerate(g.layers)
                    if getattr(l, "share_index", None) is not None)
    owner = g.layers[borrower].share_index
    st = next(s for s in pt.stages if s["lo"] <= borrower < s["hi"])
    assert st["lo"] <= owner and st["params"][owner]
    assert st["opt"]["u"][owner]
    others = [s for s in pt.stages if s is not st]
    assert all(not s["params"][owner] and not s["opt"]["u"][owner]
               for s in others)
    pt.step(x, truths, 1e-3)
    ref, _c, _m = _unsharded(g, p0, x, truths, 2)
    _equal(tparams.train_params_to_numpy(g, pt.gather_params()), ref)


def test_pipeline_train_adam():
    """Adam (the narrow CSP + SPP graph with adam=1): each stage's m and
    v slots for its own layers only; two steps equal the unsharded
    accum=2 steps."""
    cs = chip_smoke()
    cfg = cs.TRAIN_CSP_CFG.replace("burn_in=1000", "burn_in=0").replace(
        "[net]\n", "[net]\nadam=1\n", 1)
    g, _jg = _graphs(cfg)
    assert g.net.adam
    p0 = tparams.init_params(g, seed=0)
    x, y = cs.train_batch(g, 4, 3)
    pt = tpipe.PipelineTrain(g, p0, ["cpu"] * 2, microbatches=2)
    for s in pt.stages:
        held = {i for i, p in enumerate(s["params"]) if p}
        assert held == {i for i, m in enumerate(s["opt"]["m"]) if m} == \
            {i for i, v in enumerate(s["opt"]["v"]) if v}
        assert held <= set(range(s["lo"], s["hi"]))
    for _ in range(2):
        pt.step(x, y, 1e-3)
    ref, _c, _m = _unsharded(g, p0, x, y, 2, iters=2)
    _equal(tparams.train_params_to_numpy(g, pt.gather_params()), ref)


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("seed,size,width", AA_CUT_CFGS)
def test_train_cut_after_backref_antialias(seed, size, width, stages):
    """PipelineTrain with a cut right after a back-referenced antialiased
    layer (ROADMAP C5): the view crosses the cut as its own output and its
    cotangent comes back, so one f32 step (2 micro-batches) equals the
    unsharded step, held in the form of chip_smoke.py's phase 8 (a):
    within ten times the unsharded step's response to a 1e-7 input change
    plus 1e-4 of the update, capped at 30% of it (measured bitwise)."""
    g, _jg = _graphs(random_cfg(seed, size, width=width))
    p0 = tparams.init_params(g, seed=1)
    x = np.random.default_rng(0).uniform(
        0, 1, (4, size, width or size, 3)).astype(np.float32)
    truths = np.zeros((4, 4, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    pt = tpipe.PipelineTrain(g, p0, ["cpu"] * stages, microbatches=2)
    if stages == 3:
        assert pt.stages[2]["lo"] - 1 in pt.stages[2]["keys_in"]
    cost, _m = pt.step(x, truths, 1e-3)
    got = tparams.train_params_to_numpy(g, pt.gather_params())
    ref, c_ref, _m = _unsharded(g, p0, x, truths, 2)
    nudged, _c, _m = _unsharded(g, p0, x + np.float32(1e-7), truths, 2)
    keys = ("w", "b", "scales")
    err, scale = chip_smoke().update_gap(got, ref, p0, keys)
    noise, _s = chip_smoke().update_gap(nudged, ref, p0, keys)
    assert scale > 0
    assert err <= min(10 * noise + 1e-4 * scale, 0.3 * scale), (err, noise,
                                                                scale)
    np.testing.assert_allclose(float(cost), float(c_ref), rtol=1e-5)
