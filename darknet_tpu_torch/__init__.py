"""darknet_tpu_torch — the PyTorch/CUDA port of darknet_tpu for NVIDIA Hopper.

The JAX package `darknet_tpu` is the reference; this package computes the
same functions with PyTorch and hand-written CUDA kernels.  It imports
nothing of `darknet_tpu` (nor jax): it owns its copies of the cfg parser
(`config/cfg.py`), the graph IR and builder (`graph/`), `.weights` io
(`weights/io.py`) and the model zoo (`model_zoo.py`), under the reference's
module names.  Entry points run on the CUDA card unless the caller passes
device="cpu"; without a card such a call raises.

    from darknet_tpu_torch import Network, model_zoo
    net = Network.from_cfg(model_zoo.yolov4_cfg(608, 608), seed=0,
                           compute_dtype=torch.bfloat16)
    dets = net.device_out_to_dets(*net.submit_detect_device(frames))

Tests: `python -m pytest tests/test_torch_*.py` on the CPU (against the
JAX package); on a card `python3 chip_smoke.py` and `python -m pytest
--noconftest tests/test_torch_cuda.py`.
"""

_LAZY = {
    "Network": "darknet_tpu_torch.nn.network",
    "Detection": "darknet_tpu_torch.nn.network",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        val = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = val
        return val
    raise AttributeError(
        f"module 'darknet_tpu_torch' has no attribute {name!r}")


__all__ = ["Network", "Detection"]
