"""The plain bf16 conv rounds once, as the reference does, on the CPU.

darknet_tpu's bf16 conv block sums bf16 products into f32
(`preferred_element_type`), adds the f32 bias and rounds to bf16 once
(`darknet_tpu/ops/conv.py:51-60, 204, 209`).  The port's `conv_block` in
bf16 runs the conv on f32 copies of the bf16-rounded input and weights,
adds the bias and rounds once too.

Seeded 1x1, 3x3 and 3x3/2 convs with mish and leaky, 2 x 24 x 20 x 64
inputs, random biases (the measurements below are over these layers and
two seeds):
* the pre-activation (the layer with a linear activation) differs from
  JAX's in under 0.1% of elements (measured 0.004-0.016%): both sum
  exact products in f32 in another order, and a sum that lands within
  f32 noise of a bf16 rounding boundary rounds the other way.  Such an
  element differs by one bf16 ulp, or, where the sum cancels to near
  zero, by at most 1e-6 of the layer's largest output.  Before the
  repair (cuDNN's bf16 output, then the f32 bias, then a second rounding)
  28-29% of the elements differed;
* with mish or leaky, the port's block equals the port's activation
  applied to JAX's bf16 pre-activation in all but those elements.  The
  two packages' bf16 activations are not compared with each other: JAX
  rounds at every bf16 op (and takes leaky's 0.1 as a bf16 constant),
  torch computes each op in f32 and rounds its result.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from darknet_tpu.ops import conv as jconv
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.ops import conv as tconv
from darknet_tpu_torch.ops.activations import apply_activation

torch.set_num_threads(2)

CFG = """[net]
width=24
height=20
channels=64
[convolutional]
batch_normalize=1
filters=96
size=1
stride=1
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=128
size=3
stride=2
pad=1
activation=mish
"""


@pytest.fixture(scope="module")
def layers():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(CFG)
    return g, tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=3))


def _case(layers, li, seed):
    g, npar = layers
    l = g.layers[li]
    rng = np.random.default_rng(seed)
    p = dict(npar[li])
    p["b"] = rng.normal(0, 0.5, p["b"].shape).astype(np.float32)
    x = rng.normal(size=(2, l.h, l.w, l.c)).astype(np.float32)
    tp = tparams.params_to_torch(g, [{}] * li + [p], "cpu",
                                 torch.bfloat16)[li]
    return l, p, tp, x


def _jax_pre(x, p, l):
    lin = dataclasses.replace(l, activation="linear")
    y, _ = jconv.conv_block(jnp.asarray(x), p, lin,
                            compute_dtype=jnp.bfloat16)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("li", [0, 1, 2])
def test_bf16_conv_rounds_once(layers, li, seed):
    l, p, tp, x = _case(layers, li, seed)
    want = _jax_pre(x, p, l)
    lin = dataclasses.replace(l, activation="linear")
    got = tconv.conv_block(torch.from_numpy(x), tp, lin,
                           compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    differ = got != want
    assert differ.mean() < 1e-3
    top = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    d = np.abs(got - want)
    assert np.all((d <= ulp) | (d <= 1e-6 * np.abs(want).max()))


@pytest.mark.parametrize("li", [0, 1, 2])
def test_bf16_conv_block_activation(layers, li):
    l, p, tp, x = _case(layers, li, seed=0)
    assert l.activation in ("mish", "leaky")
    want = apply_activation(torch.from_numpy(_jax_pre(x, p, l)).to(
        torch.bfloat16), l.activation).float().numpy()
    got = tconv.conv_block(torch.from_numpy(x), tp, l,
                           compute_dtype=torch.bfloat16).float().numpy()
    assert (got != want).mean() < 1e-3


def test_bf16_weights_kept_in_f32_once(layers):
    """A bf16 network keeps its rounded conv weights in float32 (read by
    the plain conv without a per-call copy); the region kernel's bf16
    copy of them is exact."""
    g, npar = layers
    tp = tparams.params_to_torch(g, npar, "cpu", torch.bfloat16)
    w = tp[1]["w"]
    assert w.dtype == torch.float32
    assert torch.equal(w, w.to(torch.bfloat16).float())
    want = torch.from_numpy(np.transpose(npar[1]["w"], (3, 2, 0, 1))).to(
        torch.bfloat16).float()
    assert torch.equal(w, want)
