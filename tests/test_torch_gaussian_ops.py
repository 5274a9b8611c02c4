"""The port's [Gaussian_yolo] activation and decode
(`darknet_tpu_torch/ops/yolo.py`) against the JAX package's
(`darknet_tpu/ops/yolo.py`) on random heads: scale_x_y 1.0 and 1.1,
yolo_point center, left_top and right_bottom, both orders, score_dtype
None and bf16.

Tolerances: the activation at rtol 1e-6 / atol 1e-7 (one logistic per
element, in another library); boxes and uc at rtol 1e-6 / atol 1e-7;
the scaled class scores at rtol 1e-6 / atol 1e-7 in f32, since
`mean(uc)` of four values may sum in another order in torch and in XLA;
in bf16 the scores within one bf16 ulp (2^-8 relative), since an f32
difference of one ulp can round to the neighbouring bf16 value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph as jbuild
from darknet_tpu.ops import yolo as jyolo
from darknet_tpu_torch.graph.builder import build_graph as tbuild
from darknet_tpu_torch.ops import yolo as tyolo

CLASSES = 3
CFG = """[net]
width=96
height=64
channels=3
[convolutional]
filters={filters}
size=1
stride=8
pad=0
activation=linear
[Gaussian_yolo]
mask=1,2,3
anchors=6,9, 14,11, 22,25, 40,33
classes={classes}
num=4
scale_x_y={sxy}
yolo_point={point}
"""


def head(sxy, point):
    cfg = CFG.format(filters=3 * (9 + CLASSES), classes=CLASSES, sxy=sxy,
                     point=point)
    return jbuild(cfg).layers[1], tbuild(cfg).layers[1]


def raw_head(seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (2, 8, 12, 3 * (9 + CLASSES))) * 2).astype(np.float32)


@pytest.mark.parametrize("sxy", [1.0, 1.1])
def test_activation_matches_jax(sxy):
    lj, lt = head(sxy, "center")
    x = raw_head(1)
    want = np.asarray(jyolo.gaussian_yolo_activate(jnp.asarray(x), lj))
    got = tyolo.gaussian_yolo_activate(torch.from_numpy(x), lt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    v = got.reshape(2, 8, 12, 3, 9 + CLASSES)
    np.testing.assert_array_equal(v[..., 4], x.reshape(v.shape)[..., 4])
    np.testing.assert_array_equal(v[..., 6], x.reshape(v.shape)[..., 6])


@pytest.mark.parametrize("sxy", [1.0, 1.1])
@pytest.mark.parametrize("point", ["center", "left_top", "right_bottom"])
@pytest.mark.parametrize("order", ["reference", "native"])
@pytest.mark.parametrize("score_dtype", [None, "bfloat16"])
def test_decode_matches_jax(sxy, point, order, score_dtype):
    lj, lt = head(sxy, point)
    act = np.array(jyolo.gaussian_yolo_activate(
        jnp.asarray(raw_head(2)), lj))
    want = jyolo.gaussian_yolo_decode(
        jnp.asarray(act), lj, 96, 64, order=order,
        score_dtype=getattr(jnp, score_dtype) if score_dtype else None)
    got = tyolo.gaussian_yolo_decode(
        torch.from_numpy(act), lt, 96, 64, order=order,
        score_dtype=getattr(torch, score_dtype) if score_dtype else None)
    assert len(got) == 4
    for name, a, b in zip(("boxes", "obj", "cls", "uc"), got, want):
        b = np.asarray(b.astype(jnp.float32))
        assert tuple(a.shape) == b.shape, name
        a = a.float().numpy()
        if score_dtype and name in ("obj", "cls"):
            np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=name)
    assert got[0].dtype == got[3].dtype == torch.float32
    if score_dtype:
        assert got[1].dtype == got[2].dtype == torch.bfloat16
