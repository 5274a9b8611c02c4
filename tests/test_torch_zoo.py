"""The rest of the yolo zoo served by darknet_tpu_torch against
darknet_tpu on the CPU: yolov3, yolov3-spp, yolov3-tiny and yolov4-tiny
at 64 px, full width, f32, b=2 (yolov4 is tests/test_torch_slice.py).

Params: the numpy init with the BN scales raised (1.2 for the two deep
leaky graphs, whose heads explode at 1.5, and 1.5 for the tiny ones) and
each head conv scaled so that its objectness logits spread by about 2 on
the test frames (`lively_params`); both packages get the same arrays.

Tolerances as tests/test_torch_slice.py: heads at rtol 1e-4 / atol 1e-5;
the served triples after each port slot is matched to the JAX slot of its
candidate (`torch_params.match_slots`): objectness within 1e-5, equal
kept (image, slot, class) sets, box centres within 1e-5 and sizes at
rtol 1e-4.
"""

import warnings

import numpy as np
import pytest
import torch

from darknet_tpu.nn.emit import make_forward as jax_forward
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.weights import io as wio
from tests.test_torch_slice import assert_serving_matches
from tests.torch_params import spread_params

torch.set_num_threads(2)
ZOO = {"yolov3": 1.2, "yolov3-spp": 1.2, "yolov3-tiny": 1.5,
       "yolov4-tiny": 1.5}


def zoo_cfg(name):
    fn = model_zoo.yolov3_spp_cfg if name == "yolov3-spp" else \
        model_zoo.MODELS[name]
    return fn(64, 64)


def frames(seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)


def zoo_params(graph, bn_scale):
    """lively_params with each head conv's gain set so that its
    objectness logits on `frames()` spread by about 2."""
    return spread_params(graph, frames(), bn_scale)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_serves_as_jax(name, tmp_path):
    cfg = zoo_cfg(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(cfg)
        path = str(tmp_path / "w.weights")
        wio.save_weights(g, zoo_params(g, ZOO[name]), path)
        jnet = JaxNetwork.from_cfg(cfg, weights=path)
        tnet = Network.from_cfg(cfg, weights=path, device="cpu")
    x = frames()
    got = tnet._fwd(tnet.params, torch.from_numpy(x))
    want = jax_forward(jnet.graph, fused_bn=True)(jnet.params, x)
    assert len(got["heads"]) == len(want["heads"]) >= 2
    for a, b in zip(got["heads"], want["heads"]):
        b = np.asarray(b)
        assert float(np.std(b[..., 4])) > 0.05          # not saturated
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)
    for thresh, nms in ((0.25, 0.45), (0.1, 0.3)):
        ref = jnet._device_detect_fn(2, 64, 64, thresh, nms, 256)(
            jnet.params, x)
        port = tnet.submit_detect_device(x, thresh=thresh, nms=nms,
                                         top_k=256)
        assert_serving_matches(port, ref)
