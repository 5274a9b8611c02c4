"""The port's tensor parallelism (`darknet_tpu_torch/parallel/tensor.py`)
on the CPU: the sharding rule against the JAX package's specs, the
filter-sharded forward against the JAX package's `make_tp_forward`, and
int8 shards against the port's unsharded int8 forward.

Tolerances: against the JAX package rtol 2e-4 / atol 2e-5, the tolerance
of tests/test_tensor_parallel.py (there the sharded forward against the
unsharded one within one package).  A filter shard computes a slice of
the unsharded conv's outputs from the same input with the same weights,
and the int8 conv sums exact int32 products: its quantized inputs, int32
sums and outputs are the unsharded ones, bitwise (the heads too).
"""

import warnings

import numpy as np
import pytest
import torch

from darknet_tpu import model_zoo as jzoo
from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.nn import params as jparams
from darknet_tpu.parallel import tensor as jtensor
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.nn.emit import make_forward
from darknet_tpu_torch.ops import conv as convmod
from darknet_tpu_torch.parallel.tensor import (_tp_layers, make_tp_forward,
                                               make_tp_mesh, shard_tp_params,
                                               tp_param_specs)
from tests.torch_params import spread_params

torch.set_num_threads(2)


def _graphs(name, px):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (build_graph(model_zoo.MODELS[name](px, px)),
                jbuild(jzoo.MODELS[name](px, px)))


@pytest.mark.parametrize("n_tp", [2, 4])
@pytest.mark.parametrize("name", sorted(model_zoo.MODELS))
def test_specs_equal_jax(name, n_tp):
    """Leaf for leaf, on unfolded, folded and int8 numpy params."""
    g, jg = _graphs(name, 64)
    raw = tparams.init_params(g, seed=0)
    folded = tparams.fuse_conv_batchnorm(g, raw)
    for params in (raw, folded, tparams.quantize_conv_params(g, folded)):
        got = tp_param_specs(g, params, n_tp)
        want = jtensor.tp_param_specs(jg, params, n_tp)
        assert got == [{k: tuple(v) for k, v in p.items()} for p in want]
    assert _tp_layers(g, n_tp) == jtensor._tp_layers(jg, n_tp)


def test_tp_forward_matches_jax_yolov4_tiny():
    """(2, 4) mesh, yolov4-tiny-128: 21 convs shard, the heads'
    255-filter convs stay replicated."""
    g, jg = _graphs("yolov4-tiny", 128)
    x = np.random.default_rng(0).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    npar = jparams.fuse_conv_batchnorm(g, spread_params(g, x, 1.5))
    jm = jtensor.make_tp_mesh(2, 4)
    want = jtensor.make_tp_forward(jg, jm, fused_bn=True)(npar, x)
    mesh = make_tp_mesh(2, 4, device="cpu")
    got = make_tp_forward(g, mesh)(tparams.params_to_torch(g, npar, "cpu"), x)
    assert float(np.std(np.asarray(want[1]))) > 0.05
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)


def test_shard_placement():
    """Each eligible conv's filter slice on its tp device, the replicated
    layers on each block's first device alone."""
    g, _jg = _graphs("yolov4-tiny", 64)
    tp = tparams.params_to_torch(g, tparams.fuse_conv_batchnorm(
        g, tparams.init_params(g, seed=0)), "cpu")
    mesh = make_tp_mesh(2, 2, device="cpu")
    placed = shard_tp_params(mesh, g, tp)
    elig = _tp_layers(g, 2)
    assert len(placed) == 2 and all(len(r) == 2 for r in placed)
    for i, p in enumerate(tp):
        n = g.layers[i].n if i in elig else None
        for b in range(2):
            for t in range(2):
                q = placed[b][t][i]
                if n is None:
                    assert (q is p or q == {} or all(
                        torch.equal(q[k], p[k]) for k in p)) and \
                        (t == 0 or q == {})
                    continue
                per = n // 2
                assert torch.equal(q["w"], p["w"][t * per:(t + 1) * per])
                assert torch.equal(q["b"], p["b"][t * per:(t + 1) * per])


@pytest.mark.parametrize("n_dp,n_tp", [(1, 2), (2, 4)])
def test_int8_shards_bitwise_unsharded(n_dp, n_tp):
    """yolov4-64 int8 (dynamic scales: the dp blocks in lockstep), tp=2
    and (dp=2, tp=4): every int8 conv's quantized input and output are
    the unsharded forward's (regions off), each filter shard its slice,
    and the heads equal, bitwise."""
    g, _jg = _graphs("yolov4", 64)
    x = np.random.default_rng(1).uniform(0, 1, (2 * n_dp, 64, 64, 3)).astype(
        np.float32)
    npar = tparams.quantize_conv_params(
        g, tparams.fuse_conv_batchnorm(g, spread_params(g, x, 1.5)))
    tp = tparams.params_to_torch(g, npar, "cpu")
    elig = _tp_layers(g, n_tp)
    orig, rec = convmod.int8_conv, []

    def spy(x_q, w_q, *a, **kw):
        y = orig(x_q, w_q, *a, **kw)
        rec.append((x_q, w_q, y))
        return y

    convmod.int8_conv = spy
    try:
        with torch.inference_mode():
            want = make_forward(g, fuse_regions=None)(
                tp, torch.from_numpy(x))["heads"]
        whole, rec[:] = list(rec), []
        got = make_tp_forward(g, make_tp_mesh(n_dp, n_tp, device="cpu"),
                              decode=False)(tp, torch.from_numpy(x))
        shards = list(rec)
    finally:
        convmod.int8_conv = orig
    q = [i for i, p in enumerate(npar) if "w_q" in p]
    assert len(whole) == len(q) == 91
    n_sharded = sum(1 for i in q if i in elig)
    assert len(shards) == n_dp * (n_tp * n_sharded + len(q) - n_sharded)
    per = x.shape[0] // n_dp
    k = 0
    for (x_q, _w, y), i in zip(whole, q):
        for b in range(n_dp):
            n = n_tp if i in elig else 1
            parts = shards[k:k + n]
            k += n
            for xs, _ws, _ys in parts:
                assert torch.equal(xs, x_q[b * per:(b + 1) * per])
            assert torch.equal(torch.cat([p[2] for p in parts], -1),
                               y[b * per:(b + 1) * per])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
