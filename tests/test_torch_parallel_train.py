"""The port's data-parallel training step (`darknet_tpu_torch/parallel/dp.
py`) against the JAX package on the CPU: two gloo ranks of the port,
spawned with torch.multiprocessing, each stepping on its own block of the
global batch, held to

* the JAX package's `make_train_step` on the global batch, and
* its `make_dp_train_step` on a 2-device slice of the 8 virtual CPU
  devices that tests/conftest.py sets up;

for accum 1 and 2, f32 and the bf16 act16 path, on a narrow graph (BN,
leaky and mish, a shortcut, a route, a ciou [yolo] head, whose cost is a
mean over the truths) and one with a [batchnorm] layer (the autograd
statistics).  The two blocks are drawn from different ranges (dark
images on rank 0, bright on rank 1), so statistics taken per rank would
miss the global ones by far more than any tolerance here
(`test_blocks_need_global_statistics`).

Tolerances (after two steps, f32): every update (params after - before),
momentum buffer and rolling-statistic change within 1e-4 of the largest
of its kind, costs within 1e-5 (sum-order noise of the sync-BN sums and
the gradient sum, ~1e-7).  bf16: held to the JAX step on the global batch
as tests/test_torch_train_step.py holds the port's bf16 step (cost within
1%, the updates' cosine >= 0.99), and to the port's own single-process
bf16 step within 2e-2 of the largest update (bf16 rounds the
interlayer tensors once a layer, and a sum in another order flips a
rounding now and then; measured below 1e-3).  The ranks are bitwise
equal; a world of one rank is bitwise the step without a mesh.
Weight averaging is held to `darknet_tpu.parallel.weight_avg` at 1e-4 of
the largest update.
"""

import concurrent.futures as cf
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.parallel.dp import make_dp_train_step as jdp
from darknet_tpu.parallel.weight_avg import make_weight_avg_train_step as jwa
from darknet_tpu.parallel.weight_avg import replicate_params as jrep
from darknet_tpu.train.step import init_opt_state as jinit
from darknet_tpu.train.step import make_train_step as jstep
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.parallel import make_dp_train_step, make_mesh
from darknet_tpu_torch.parallel.multihost import spawn
from darknet_tpu_torch.parallel.weight_avg import (make_weight_avg_train_step,
                                                   replicate_params)
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
import torch_parallel_workers as workers

NET = """[net]
batch=8
subdivisions={accum}
width=32
height=32
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.001
burn_in=0
policy=constant
"""

NARROW = NET + """
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=mish
[shortcut]
from=-2
activation=linear
[route]
layers=-1,-3
[convolutional]
batch_normalize=1
filters=8
size=1
activation=leaky
[convolutional]
filters=12
size=1
activation=linear
[yolo]
mask=0,1
num=2
classes=1
anchors=10,14, 23,27
iou_loss=ciou
iou_normalizer=0.07
"""

BN_LAYER = NET + """
[convolutional]
filters=8
size=3
stride=2
pad=1
activation=linear
[batchnorm]
[convolutional]
batch_normalize=1
filters=12
size=1
activation=linear
[yolo]
mask=0,1
num=2
classes=1
anchors=10,14, 23,27
"""

CASES = {"f32_accum1": (NARROW, 1, False), "f32_accum2": (NARROW, 2, False),
         "bf16_accum1": (NARROW, 1, True), "bf16_accum2": (NARROW, 2, True),
         "batchnorm_accum2": (BN_LAYER, 2, False)}
STEPS = 2
TRAINABLE = ("w", "b", "scales")
STATS = ("mean", "var")
TOL = 1e-4
TOL_BF16_PORT = 2e-2


def global_batch(seed=7, b=8, px=32):
    """Dark images on the first block, bright on the second; 1-3 boxes
    an image."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(0.0, 0.4, (b // 2, px, px, 3)),
                        rng.uniform(0.5, 1.0, (b // 2, px, px, 3))]).astype(
        np.float32)
    y = np.zeros((b, 90, 5), np.float32)
    for i in range(b):
        for j in range(rng.integers(1, 4)):
            y[i, j] = [rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8),
                       rng.uniform(0.1, 0.4), rng.uniform(0.1, 0.4), 0]
    return x, y


def cfg_of(case):
    text, accum, _bf16 = CASES[case]
    return text.format(accum=accum)


def jax_run(graph, p0, x, y, accum, bf16, mesh=None):
    """(params, momentum, costs) after STEPS steps of the JAX package's
    step, on the global batch, or over `mesh` with make_dp_train_step."""
    dt = jnp.bfloat16 if bf16 else None
    if mesh is None:
        step = jstep(graph, donate=False, accum=accum, compute_dtype=dt,
                     train_act_dtype=dt)
        p, xs, ys = jax.device_put(p0), jnp.asarray(x), jnp.asarray(y)
    else:
        step = jdp(graph, mesh, donate=False, accum=accum, compute_dtype=dt,
                   train_act_dtype=dt)
        rep, dp = NamedSharding(mesh, P()), NamedSharding(mesh, P("dp"))
        p = jax.device_put(p0, rep)
        xs, ys = jax.device_put(x, dp), jax.device_put(y, dp)
    o = jinit(graph, p)
    costs = []
    for _ in range(STEPS):
        p, o, c, _m = step(p, o, xs, ys, None, jnp.float32(graph.net.lr))
        costs.append(float(c))
    to_np = lambda t: [{k: np.asarray(v) for k, v in d.items()} for d in t]
    return to_np(p), to_np(o["u"]), costs


def port_run(graph, p0, x, y, accum, bf16, group=None):
    """The same with the port's step in this process (one rank)."""
    dt = torch.bfloat16 if bf16 else None
    step = make_train_step(graph, accum=accum, compute_dtype=dt,
                           train_act_dtype=dt, group=group)
    p = tparams.train_params_to_torch(graph, p0, "cpu")
    o = init_opt_state(graph, p)
    costs = []
    for _ in range(STEPS):
        p, o, c, _m = step(p, o, torch.from_numpy(x), torch.from_numpy(y),
                           graph.net.lr)
        costs.append(float(c))
    return (tparams.train_params_to_numpy(graph, p),
            tparams.train_params_to_numpy(graph, o["u"]), costs)


def unflat(z, prefix, like):
    return [{k: z[f"{prefix}/{i}/{k}"] for k in d} for i, d in enumerate(like)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the port's two ranks (spawned once for all cases, run
    beside the JAX references), the JAX package's global and 2-device
    steps, the port's single-process step, and p0."""
    out = str(tmp_path_factory.mktemp("dp"))
    x, y = global_batch()
    cases, p0s = [], {}
    for name, (_t, accum, bf16) in CASES.items():
        p0s[name] = jparams.init_params(jbuild(cfg_of(name), train=True),
                                        seed=3)
        cases.append({"name": name, "cfg": cfg_of(name), "p0": p0s[name],
                      "x": x, "y": y, "accum": accum, "bf16": bf16,
                      "steps": STEPS})
    with cf.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, workers.dp_steps, ["cpu", "cpu"], out,
                            cases)
        mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        res = {}
        for name, (_t, accum, bf16) in CASES.items():
            jg = jbuild(cfg_of(name), train=True)
            tg = tbuild(cfg_of(name), train=True)
            res[name] = {
                "p0": p0s[name],
                "jax": jax_run(jg, p0s[name], x, y, accum, bf16),
                "jax_dp": jax_run(jg, p0s[name], x, y, accum, bf16, mesh),
                "port": port_run(tg, p0s[name], x, y, accum, bf16)}
        ranks.result(timeout=300)
    for name in CASES:
        zs = [np.load(os.path.join(out, f"{name}_{r}.npz")) for r in (0, 1)]
        p0 = res[name]["p0"]
        res[name]["ranks"] = [(unflat(z, "params", p0), unflat(z, "u", p0),
                               list(z["costs"]), z) for z in zs]
    return res


def gap(a, b, ref, keys):
    """(max |a - b|, max |a - ref|) over the arrays named in keys."""
    err = scale = 0.0
    for da, db, dr in zip(a, b, ref):
        for k in da:
            if k in keys:
                err = max(err, float(np.abs(da[k] - db[k]).max()))
                scale = max(scale, float(np.abs(da[k] - dr[k]).max()))
    return err, scale


def zeros_like(tree):
    return [{k: np.zeros_like(v) for k, v in d.items()} for d in tree]


def held_f32(want, got, p0):
    wp, wu, wc = want
    gp, gu, gc = got
    for keys in (TRAINABLE, STATS):
        err, scale = gap(wp, gp, p0, keys)
        assert scale > 1e-4 and err <= TOL * scale, (keys, err, scale)
    err, scale = gap(wu, gu, zeros_like(wu), TRAINABLE)
    assert scale > 0 and err <= TOL * scale, ("momentum", err, scale)
    assert np.allclose(gc, wc, rtol=1e-5, atol=0), (gc, wc)


def cosine_of_updates(a, b, p0):
    ua, ub = [], []
    for da, db, d0 in zip(a, b, p0):
        for k in sorted(d0):
            if k in TRAINABLE:
                ua.append((da[k] - d0[k]).ravel())
                ub.append((db[k] - d0[k]).ravel())
    ua, ub = np.concatenate(ua), np.concatenate(ub)
    return ua @ ub / (np.linalg.norm(ua) * np.linalg.norm(ub))


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_jax_global_batch(runs, case):
    r = runs[case]
    gp, gu, gc, _z = r["ranks"][0]
    if CASES[case][2]:
        wp, _wu, wc = r["jax"]
        assert abs(gc[0] - wc[0]) <= 0.01 * abs(wc[0]), (gc, wc)
        cos = cosine_of_updates(wp, gp, r["p0"])
        assert np.isfinite(cos) and cos >= 0.99, cos
    else:
        held_f32(r["jax"], (gp, gu, gc), r["p0"])


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_jax_dp_step(runs, case):
    r = runs[case]
    gp, gu, gc, _z = r["ranks"][0]
    if CASES[case][2]:
        wp, _wu, wc = r["jax_dp"]
        assert abs(gc[0] - wc[0]) <= 0.01 * abs(wc[0]), (gc, wc)
        assert cosine_of_updates(wp, gp, r["p0"]) >= 0.99
    else:
        held_f32(r["jax_dp"], (gp, gu, gc), r["p0"])


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_port_single_process(runs, case):
    """The two ranks against the port's own step on the global batch: the
    same arithmetic but for the order of the sums."""
    r = runs[case]
    gp, gu, gc, _z = r["ranks"][0]
    wp, wu, wc = r["port"]
    if not CASES[case][2]:
        held_f32((wp, wu, wc), (gp, gu, gc), r["p0"])
        return
    err, scale = gap(wp, gp, r["p0"], TRAINABLE)
    assert err <= TOL_BF16_PORT * scale, (err, scale)
    assert np.allclose(gc, wc, rtol=1e-3), (gc, wc)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_ranks_bitwise_equal(runs, case):
    (p0_, u0, c0, z0), (p1_, u1, c1, z1) = runs[case]["ranks"]
    for a, b in ((p0_, p1_), (u0, u1)):
        for da, db in zip(a, b):
            for k in da:
                assert np.array_equal(da[k], db[k]), k
    assert c0 == c1 and int(z0["t"]) == int(z1["t"]) == STEPS
    assert np.array_equal(z0["losses"], z1["losses"])
    assert np.array_equal(z0["counts"], z1["counts"])


def test_blocks_need_global_statistics(runs):
    """The blocks differ: the rolling mean that per-rank statistics
    would give layer 0 differs from the global one by far more than the
    tolerance the step tests hold the ranks to, and the ranks hold the
    global one."""
    r = runs["f32_accum1"]
    x, _y = global_batch()
    jg = jbuild(cfg_of("f32_accum1"), train=True)
    from darknet_tpu.nn.emit import make_forward as jfwd

    fwd = jfwd(jg, train=True)
    p0 = r["p0"]
    means = [np.asarray(fwd(jax.device_put(p0), jnp.asarray(xb),
                            None)["bn_stats"][0][0])
             for xb in (x[:4], x[4:], x)]
    m0 = p0[0]["mean"]
    per_rank = [0.9 * m0 + 0.1 * m for m in means[:2]]
    global_ = 0.9 * m0 + 0.1 * means[2]
    # one step moves layer 0's rolling mean by `step`: a per-rank mean
    # misses the global one by a large share of it
    step = np.abs(global_ - m0).max()
    for pr in per_rank:
        assert np.abs(pr - global_).max() > 0.1 * step, (pr, global_)
    got = r["ranks"][0][0][0]["mean"]
    want = r["jax"][0][0]["mean"]
    moved = np.abs(want - m0).max()
    assert np.abs(got - want).max() <= TOL * moved


def test_world_of_one_is_the_step_without_a_mesh():
    """A gloo world of one rank: the data-parallel step (its gradient
    sum runs) is bitwise the step without a mesh."""
    import torch.distributed as dist

    from darknet_tpu_torch.parallel.multihost import free_port

    x, y = global_batch()
    tg = tbuild(cfg_of("f32_accum2"), train=True)
    p0 = jparams.init_params(jbuild(cfg_of("f32_accum2"), train=True),
                             seed=3)
    want = port_run(tg, p0, x, y, 2, False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.shape == {"dp": 1} and mesh.group is not None
        make_dp_train_step(tg, mesh, accum=2)      # the mesh is accepted
        got = port_run(tg, p0, x, y, 2, False, group=mesh.group)
    finally:
        dist.destroy_process_group()
    for a, b in zip(want[:2], got[:2]):
        for da, db in zip(a, b):
            for k in da:
                assert np.array_equal(da[k], db[k]), k
    assert want[2] == got[2]


def test_dp_step_refuses_uneven_or_one_process_meshes():
    tg = tbuild(cfg_of("f32_accum2"), train=True)
    local = make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="one process a device"):
        make_dp_train_step(tg, local, accum=2)
    uneven = NET.format(accum=8) + NARROW[len(NET):]
    import dataclasses

    fake = dataclasses.replace(local, group=object())
    with pytest.raises(ValueError, match="must divide evenly"):
        make_dp_train_step(tbuild(uneven, train=True), fake, accum=8)


def test_weight_averaging_matches_jax():
    """Two replicas, each on its half of the batch with its own momentum,
    four steps with a sync after the second and the fourth (the
    reference's SyncNetworks every sync_interval), against
    darknet_tpu.parallel.weight_avg."""
    x, y = global_batch()
    cfg = cfg_of("f32_accum1")
    jg, tg = jbuild(cfg, train=True), tbuild(cfg, train=True)
    p0 = jparams.init_params(jg, seed=3)
    lr = jg.net.lr
    jstep_, jsync = jwa(jg, 2)
    jp, jo = jrep(jax.device_put(p0), 2), jrep(jinit(jg, p0), 2)
    xr, yr = x.reshape(2, 4, 32, 32, 3), y.reshape(2, 4, 90, 5)
    tstep, tsync = make_weight_avg_train_step(tg, 2)
    tp = replicate_params(tparams.train_params_to_torch(tg, p0, "cpu"), 2)
    to = [init_opt_state(tg, p) for p in tp]
    for it in range(4):
        jp, jo, jc, _m = jstep_(jp, jo, jnp.asarray(xr), jnp.asarray(yr),
                                jax.random.PRNGKey(0), jnp.float32(lr))
        tp, to, tc, _m = tstep(tp, to, torch.from_numpy(xr),
                               torch.from_numpy(yr), lr)
        assert np.allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
        if it % 2 == 1:
            jp, tp = jsync(jp), tsync(tp)
    for r in range(2):
        want = [{k: np.asarray(v[r]) for k, v in d.items()} for d in jp]
        got = tparams.train_params_to_numpy(tg, tp[r])
        for keys in (TRAINABLE, STATS):
            err, scale = gap(want, got, p0, keys)
            assert scale > 0 and err <= TOL * scale, (r, keys, err, scale)
        wu = [{k: np.asarray(v[r]) for k, v in d.items()} for d in jo["u"]]
        gu = tparams.train_params_to_numpy(tg, to[r]["u"])
        err, scale = gap(wu, gu, zeros_like(wu), TRAINABLE)
        assert err <= TOL * scale, (r, err, scale)
    # synced: the replicas' params are equal, their momenta are not
    a = tparams.train_params_to_numpy(tg, tp[0])
    b = tparams.train_params_to_numpy(tg, tp[1])
    assert all(np.array_equal(da[k], db[k]) for da, db in zip(a, b)
               for k in da)
    ua = tparams.train_params_to_numpy(tg, to[0]["u"])
    ub = tparams.train_params_to_numpy(tg, to[1]["u"])
    assert any(not np.array_equal(da[k], db[k]) for da, db in zip(ua, ub)
               for k in da)
