"""The epilogue of a bf16 conv outside a region, in one pass
(`conv_epilogue_kernel` of `csrc/fused_region.cu`).

    conv_epilogue(y, bias, act)
        y the conv's f32 sum (B, H, W, C) NHWC, bias (C,) f32, act a name
        of `ACT_CODES` -> (B, H, W, C) bf16
        = round(act(round(y + bias))), the activation in f32

The arithmetic is `ops/conv.conv_block`'s: the f32 bias add, one rounding
to bf16, the activation computed in f32 on that value and rounded once
(`ops/activations.apply_activation`).  It goes through the custom op
`darknet_tpu_torch::conv_epilogue` (`ops/library.py`), which
`torch.export` records as a node.  A CPU tensor goes to the plain version
(`conv_epilogue_plain`); a CUDA tensor launches the kernel
(`conv_epilogue_cuda`, the op's CUDA backend) or raises.  `launches`
counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops.cuda.fused_region import ACT_CODES

launches = 0


def conv_epilogue_plain(y, bias, act: str):
    """The plain version, on any device: `(y + bias).to(bf16)`, then the
    activation."""
    return apply_activation((y + bias).to(torch.bfloat16), act)


def conv_epilogue(y, bias, act: str):
    """The epilogue through the op `darknet_tpu_torch::conv_epilogue`: the
    plain version for a CPU tensor, the kernel for a CUDA tensor."""
    from darknet_tpu_torch.ops import library  # noqa: F401 (the ops)

    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue: no kernel for device {y.device}")
    return torch.ops.darknet_tpu_torch.conv_epilogue.default(y, bias, act)


def _lib():
    from darknet_tpu_torch.ops.cuda.build import load

    lib = load("fused_region")
    if not getattr(lib, "_epilogue_typed", False):
        lib.conv_epilogue_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.conv_epilogue_launch.restype = ctypes.c_int
        lib.region_error_string.argtypes = [ctypes.c_int]
        lib.region_error_string.restype = ctypes.c_char_p
        lib._epilogue_typed = True
    return lib


def conv_epilogue_cuda(y, bias, act: str):
    """The op's CUDA backend: operands checked, output allocated here,
    one launch on the current stream, counted in `launches`.  y is read
    in place when it is contiguous and 16-byte aligned (a conv's output
    is), else copied first."""
    global launches
    if act not in ACT_CODES:
        raise ValueError(f"conv_epilogue: no kernel code for activation "
                         f"{act!r}")
    if y.dtype != torch.float32 or y.dim() < 1:
        raise ValueError(f"conv_epilogue takes a float32 sum, got "
                         f"{y.dtype} of shape {tuple(y.shape)}")
    c = y.shape[-1]
    if (bias.device != y.device or bias.dtype != torch.float32
            or tuple(bias.shape) != (c,)):
        raise ValueError(f"conv_epilogue: bias must be float32 ({c},) on "
                         f"{y.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    bias = bias.contiguous()
    if not y.is_contiguous() or y.data_ptr() % 16:
        y = y.contiguous() if not y.is_contiguous() else y.clone()
    out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
    if y.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(y.device):
        err = lib.conv_epilogue_launch(
            y.data_ptr(), bias.data_ptr(), out.data_ptr(), y.numel(), c,
            ACT_CODES[act], torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue launch failed ({err}): "
                           f"{lib.region_error_string(err).decode()}")
    launches += 1
    return out
