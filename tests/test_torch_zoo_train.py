"""One training step of the tiny zoo cfgs, darknet_tpu_torch against
darknet_tpu on the CPU: yolov4-tiny (route groups, strided training
maxpools) and yolov3-tiny (strided pools and the stride-1 2x2 pool) at
64 px, full width, f32, batch 4 in two micro-batches, burn_in 0.

Tolerance: momentum buffers and rolling statistics within 1e-4 of the
largest momentum (resp. statistic change) of the step, as the narrow CSP
graph in tests/test_torch_train_step.py, and the updated params within
that plus one float32 ulp of the largest param (yolov4-tiny's first
update, 8e-4, is 1.5e-4 of the params' ulp-scale rounding); measured up
to 1.5e-5 for the momentum and 2.1e-6 for the statistics.  The tiny
graphs are not chaotic at init, so no yardstick form is needed: a 1e-7
input change moves their first update by 5e-6 to 1.5e-4 of its largest
element.  One discrete decision is sensitive to f32 noise: a
maxpool routes its window's gradient to the largest of the window, and
where two values of a window lie within sum-order noise (~1e-5 here) of
each other the two packages may route it to different positions.  The
port's gradient then follows the chain rule through its own forward
(checked layer by layer against JAX's blocks on the port's activations),
and the two steps differ by that one routing: seed 3 of yolov3-tiny (a
window of layer 7: 2.5% of layer 6's update), seeds 2 and 4 of
yolov4-tiny (0.7% and 1.7%).  The batches here are drawn from seeds
without such a window.
"""

import numpy as np
import pytest
import torch

from darknet_tpu.nn import params as jparams
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.nn import params as tparams
from tests.test_torch_train_step import (STATS, TRAINABLE, batch, graphs,
                                         jax_step, jinit, worst)

import jax
import jax.numpy as jnp

torch.set_num_threads(2)
TOL = 1e-4


def jax_state(graph, p0, x, y, accum):
    """(params, momentum) after one JAX step, numpy."""
    step = jax_step(graph, accum)
    p = jax.device_put(p0)
    o = jinit(graph, p)
    p, o, _c, _m = step(p, o, jnp.asarray(x), jnp.asarray(y), None,
                        jnp.float32(graph.net.lr))
    to_np = lambda t: [{k: np.asarray(v) for k, v in d.items()} for d in t]
    return to_np(p), to_np(o["u"])


@pytest.mark.parametrize("name,seed", [("yolov4-tiny", 3),
                                       ("yolov3-tiny", 1)])
def test_tiny_zoo_step_matches_jax(name, seed):
    from darknet_tpu_torch.train.step import init_opt_state, make_train_step

    jg, tg = graphs(model_zoo.MODELS[name](64, 64))
    p0 = jparams.init_params(jg, seed=0)
    x, y = batch(jg, 4, seed=seed)
    jp, ju = jax_state(jg, p0, x, y, 2)
    p = tparams.train_params_to_torch(tg, p0, "cpu")
    o = init_opt_state(tg, p)
    p, o, _c, _m = make_train_step(tg, accum=2)(
        p, o, torch.from_numpy(x), torch.from_numpy(y), tg.net.lr)
    tp = tparams.train_params_to_numpy(tg, p)
    tu = tparams.train_params_to_numpy(tg, o["u"])
    zero = [{k: np.zeros_like(v) for k, v in d.items()} for d in ju]
    ulp = np.finfo(np.float32).eps * max(
        float(np.abs(d[k]).max()) for d in p0 for k in d if k in TRAINABLE)
    for what, got, want, ref, keys, slack in (
            ("updates", tp, jp, p0, TRAINABLE, ulp),
            ("stats", tp, jp, p0, STATS, 0.0),
            ("momentum", tu, ju, zero, TRAINABLE, 0.0)):
        err, scale = worst(want, got, ref, keys)
        assert scale > 0 and err <= TOL * scale + slack, (what, err, scale)
