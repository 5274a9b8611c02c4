"""The port's filter-sharded training (`darknet_tpu_torch/parallel/tensor.
make_tp_train_step`, `tp_opt_specs`, `gather`) on the CPU, the CPU named
once a mesh device: against the JAX package's `make_tp_train_step` on
tests/conftest.py's 8 virtual devices and the port's own unsharded
`make_train_step`.

Tolerances: against the JAX package those of tests/test_tensor_parallel.
py (there the sharded step against the unsharded one within one
package): cost rtol 1e-5, params rtol 1e-4 / atol 2e-4; the (2, 2, 2)
step's last conv "w" at rtol 1e-4 / atol 2e-4.  Against the port's
unsharded step every param within 1e-5 of the largest update (measured
up to 1.2e-6: the batch statistics and the gradients sum over the
shards' parts in another order).  The batch is seed 5's, one whose
unsharded step moves by 1e-6 of its update under a 1e-7 input change:
about half of the seeds 0-19 hold a near-tie (a leaky input or a maxpool
window within f32 noise) that sum-order noise tips, moving some layer's
update by 1-6% (measured: seed 4 on the (2, 4) mesh at accum 2, layer
13's "w").
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from darknet_tpu import model_zoo as jzoo
from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.parallel import tensor as jtensor
from darknet_tpu.train.step import init_opt_state as jinit
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.parallel.mesh import grid_mesh
from darknet_tpu_torch.parallel.tensor import (_tp_layers, gather, gather_opt,
                                               make_tp_train_step,
                                               tp_opt_specs)
from darknet_tpu_torch.train.step import init_opt_state, make_train_step

torch.set_num_threads(2)

SEED = 5
SIZE, BATCH = 128, 4


def _graphs(cfg, train=True):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg, train=train), jbuild(cfg, train=train)


def _case():
    g, jg = _graphs(model_zoo.yolov4_tiny_cfg(SIZE, SIZE, batch=BATCH,
                                              subdiv=1))
    p0 = tparams.init_params(g, seed=0)
    x = np.random.default_rng(SEED).uniform(
        0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    truths = np.zeros((BATCH, 8, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.25, 0.25, 1]
    return g, jg, p0, x, truths


def _unsharded(g, p0, x, truths):
    step = make_train_step(g)
    p = tparams.train_params_to_torch(g, p0, "cpu")
    o = init_opt_state(g, p)
    p, o, c, _m = step(p, o, torch.from_numpy(x), torch.from_numpy(truths),
                       1e-3)
    return p, o, c


def _port_tp(g, shape, p0, x, truths, sp_axis=None):
    step, place = make_tp_train_step(g, grid_mesh(shape, device="cpu"),
                                     sp_axis=sp_axis)
    p = tparams.train_params_to_torch(g, p0, "cpu")
    placed, opts, xt, tt = place(p, init_opt_state(g, p), x, truths)
    placed, opts, cost, _m = step(placed, opts, xt, tt, 1e-3)
    return placed, opts, cost


def _jax_tp(jg, mesh, p0, x, truths, sp_axis=None):
    step, place = jtensor.make_tp_train_step(jg, mesh, sp_axis=sp_axis)
    pm, om, xm, tm = place(p0, jinit(jg, p0), x, truths)
    p, _o, cost, _m = step(pm, om, xm, tm, jax.random.PRNGKey(0),
                           jnp.float32(1e-3))
    return [{k: np.asarray(v) for k, v in d.items()} for d in p], cost


def _within(got, want, p0, frac):
    scale = max(float(np.abs(w[k] - q[k]).max())
                for w, q in zip(want, p0) for k in w)
    err = max(float(np.abs(a[k] - w[k]).max())
              for a, w in zip(got, want) for k in w)
    assert scale > 0 and err <= frac * scale, (err, scale)


@pytest.mark.parametrize("n_tp", [2, 4])
@pytest.mark.parametrize("name", sorted(model_zoo.MODELS))
def test_opt_specs_equal_jax(name, n_tp):
    """Leaf for leaf, SGD and Adam state (the JAX package's own
    init_opt_state), for every zoo cfg."""
    g, jg = _graphs(model_zoo.MODELS[name](64, 64), train=False)
    params = tparams.init_params(g, seed=0)
    for adam in (False, True):
        state = jinit(jg, params, adam)
        got = tp_opt_specs(g, state, params, n_tp)
        want = jtensor.tp_opt_specs(jg, state, params, n_tp)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, list):
                assert got[k] == [{kk: tuple(s) for kk, s in d.items()}
                                  for d in v], (k, adam)
            else:
                assert got[k] == tuple(v), (k, adam)


def test_tp_step_matches_jax_and_unsharded():
    """(dp=2, tp=4), yolov4-tiny-128: 19 convs shard, the heads' 255-
    filter convs stay replicated."""
    g, jg, p0, x, truths = _case()
    assert len(_tp_layers(g, 4)) == 19
    want, jcost = _jax_tp(jg, jtensor.make_tp_mesh(2, 4), p0, x, truths)
    placed, opts, cost = _port_tp(g, {"dp": 2, "tp": 4}, p0, x, truths)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    got = tparams.train_params_to_numpy(g, gather(placed))
    for i, (a, b) in enumerate(zip(got, want)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=2e-4,
                                       err_msg=f"layer {i} {k}")
    p1, o1, c1 = _unsharded(g, p0, x, truths)
    np.testing.assert_allclose(float(cost), float(c1), rtol=1e-6)
    _within(got, tparams.train_params_to_numpy(g, p1), p0, 1e-5)
    _within(tparams.train_params_to_numpy(g, gather_opt(opts)["u"]),
            tparams.train_params_to_numpy(g, o1["u"]),
            [{k: np.zeros_like(v) for k, v in d.items()} for d in p0], 1e-5)


def test_slots_live_on_their_shard():
    """Each shard's params and slots hold exactly its filter slice of the
    eligible convs (and shard 0 the replicated layers) on its home
    device; `gather` of the placed params and state gives back the
    unsharded layout, bitwise."""
    g, _jg, p0, _x, _t = _case()
    cfg = model_zoo.yolov4_tiny_cfg(SIZE, SIZE, batch=BATCH, subdiv=1)
    g = _graphs(cfg.replace("[net]\n", "[net]\nadam=1\n", 1))[0]
    mesh = grid_mesh({"dp": 2, "tp": 2}, device="cpu")
    _step, place = make_tp_train_step(g, mesh)
    p = tparams.train_params_to_torch(g, p0, "cpu")
    state = init_opt_state(g, p)
    for k in ("m", "v"):
        for d in state[k]:
            for v in d.values():
                v.uniform_()
    placed, opts = place(p, state)
    elig = _tp_layers(g, 2)
    for t, (shard, o) in enumerate(zip(placed, opts)):
        assert o["t"] == state["t"]
        for i, l in enumerate(g.layers):
            for tree in (shard, o["m"], o["v"]):
                if i in elig:
                    assert tree[i]["w"].shape[0] == l.n // 2
                    assert all(v.shape[0] == l.n // 2
                               for v in tree[i].values())
                elif t:
                    assert tree[i] == {}
        assert all(v.device == mesh.along("tp")[t] for d in shard
                   for v in d.values())
        assert all(v.requires_grad == (k in ("w", "b", "scales"))
                   for d in shard for k, v in d.items())
    for a, b in zip(gather(placed), p):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k].detach()) for k in b)
    back = gather_opt(opts)
    for k in ("m", "v"):
        for a, b in zip(back[k], state[k]):
            assert all(torch.equal(a[kk], b[kk]) for kk in b)


def test_3d_step_matches_jax():
    """(dp=2, sp=2, tp=2) with sp_axis="sp": the JAX package's 3-axis
    step (tests/test_tensor_parallel.py:108-140), and the unsharded
    step."""
    g, jg, p0, x, truths = _case()
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                 ("dp", "sp", "tp"))
    want, jcost = _jax_tp(jg, jmesh, p0, x, truths, sp_axis="sp")
    placed, _opts, cost = _port_tp(g, {"dp": 2, "sp": 2, "tp": 2}, p0, x,
                                   truths, sp_axis="sp")
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    got = tparams.train_params_to_numpy(g, gather(placed))
    last = max(i for i, l in enumerate(g.layers)
               if l.kind == "convolutional")
    np.testing.assert_allclose(got[last]["w"], want[last]["w"], rtol=1e-4,
                               atol=2e-4)
    p1, _o1, _c1 = _unsharded(g, p0, x, truths)
    _within(got, tparams.train_params_to_numpy(g, p1), p0, 1e-5)


def test_mesh_refusals():
    """A mesh the step cannot take raises and names it."""
    g, _jg, _p0, _x, _t = _case()
    with pytest.raises(ValueError, match="'tp'"):
        make_tp_train_step(g, grid_mesh({"dp": 2}, device="cpu"))
    with pytest.raises(ValueError, match="'sp'"):
        make_tp_train_step(g, grid_mesh({"dp": 2, "tp": 2}, device="cpu"),
                           sp_axis="sp")
    with pytest.raises(ValueError, match="not \\['sp'\\]"):
        make_tp_train_step(g, grid_mesh({"sp": 2, "tp": 2}, device="cpu"))


def test_share_index_borrower_of_a_shard():
    """A conv that borrows a sharded conv's weights (share_index) reads
    the owner's slices gathered, on the (dp=2, sp=2, tp=2) step; the step
    equals the unsharded accum=2 step within 1e-5 of the largest update
    (measured 3.0e-7)."""
    from test_torch_pipeline import SHARE_CFG

    cfg = SHARE_CFG.replace("[net]\n", "[net]\nbatch=4\nsubdivisions=2\n"
                            "burn_in=0\n", 1)
    g = _graphs(cfg)[0]
    owner = next(l.share_index for l in g.layers
                 if getattr(l, "share_index", None) is not None)
    assert owner in _tp_layers(g, 2)
    p0 = tparams.init_params(g, seed=2)
    x = np.random.default_rng(2).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)
    y = np.zeros((4, 4, 5), np.float32)
    y[:, 0] = [0.4, 0.6, 0.3, 0.2, 1]
    step, place = make_tp_train_step(
        g, grid_mesh({"dp": 2, "sp": 2, "tp": 2}, device="cpu"),
        sp_axis="sp", accum=2)
    p = tparams.train_params_to_torch(g, p0, "cpu")
    placed, opts, xt, yt = place(p, init_opt_state(g, p), x, y)
    step(placed, opts, xt, yt, 1e-3)
    ref = make_train_step(g, accum=2)
    q = tparams.train_params_to_torch(g, p0, "cpu")
    q, _o, _c, _m = ref(q, init_opt_state(g, q), torch.from_numpy(x),
                        torch.from_numpy(y), 1e-3)
    _within(tparams.train_params_to_numpy(g, gather(placed)),
            tparams.train_params_to_numpy(g, q), p0, 1e-5)
