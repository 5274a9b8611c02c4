"""The CUDA kernels as `torch.library` custom ops.

    torch.ops.darknet_tpu_torch.region(x, weights, biases, plan, dtype)
        the fused region (`ops/cuda/fused_region.py`); `plan` is
        `RegionPlan.to_json()`, weights/biases the per-conv-step HWIO
        weights and f32 biases (`ops/fused_region.step_weights`)
    torch.ops.darknet_tpu_torch.int8_conv(x_q, w_q, w_scale, bias, x_scale,
                                          size, stride, pad_lo, out_hw,
                                          out_dtype, leaky)
        the implicit-GEMM int8 conv (`ops/quant_matmul.int8_conv`)
    torch.ops.darknet_tpu_torch.int8_matmul(a_q, b_q, w_scales, bias,
                                            x_scale, leaky)
        the int8 GEMM (`ops/quant_matmul.int8_matmul`)
    torch.ops.darknet_tpu_torch.conv_epilogue(y, bias, act)
        a bf16 conv's bias, roundings and activation in one pass
        (`ops/cuda/conv_epilogue.conv_epilogue`)

Each op has a CPU backend, the kernel's plain version, and a CUDA
backend, which launches the hand-written kernel through its ctypes
binding and counts the launch (`ops.cuda.fused_region.launches` /
`variant_launches`, `ops.quant_matmul.launches`,
`ops.cuda.conv_epilogue.launches`); a missing nvcc, a
failed build or a failed launch raises there.  Each op also has a fake
(shape-only) implementation, so `torch.export` records the op as one
node: an exported serving program (`Network.export_serving`) reaches the
same kernels, and counts the same launches, as the eager path, which
calls the ops through `region_call`, `int8_conv`, `int8_matmul` and
`conv_epilogue`.

The ops are defined through `torch.library.Library` (a schema and one
implementation a dispatch key), not `torch.library.custom_op`, whose
Python layers (autograd registration, aliasing checks) add host time
to every call: the eager int8 path calls `int8_conv` 91 times a yolov4
request.  Importing this module registers
the ops; it imports neither nvcc's output nor triton, which the CUDA
backends build at their first call.
"""

from __future__ import annotations

import functools

import torch

from darknet_tpu_torch.ops import quant_matmul as qm
from darknet_tpu_torch.ops.cuda import conv_epilogue as cuda_epilogue
from darknet_tpu_torch.ops.cuda import fused_region as cuda_region
from darknet_tpu_torch.ops.fused_region import RegionPlan, region_plain

NS = "darknet_tpu_torch"
_lib = torch.library.Library(NS, "DEF")


@functools.lru_cache(maxsize=64)
def parse_plan(plan: str) -> RegionPlan:
    """The RegionPlan of a `to_json` string, parsed once per string."""
    return RegionPlan.from_json(plan)


def _define(schema: str, cpu, cuda, fake) -> None:
    name = schema.split("(", 1)[0]
    _lib.define(schema)
    _lib.impl(name, cpu, "CPU")
    _lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NS}::{name}", fake, lib=_lib)


# ------------------------------------------------------------------ region
def _region_cpu(x, weights, biases, plan, dtype):
    return region_plain(parse_plan(plan), x, weights, biases,
                        compute_dtype=dtype)


def _region_fake(x, weights, biases, plan, dtype):
    p = parse_plan(plan)
    return x.new_empty((x.shape[0], p.h, 2 * p.w2, p.out_c), dtype=dtype)


_define("region(Tensor x, Tensor[] weights, Tensor[] biases, str plan, "
        "ScalarType dtype) -> Tensor",
        _region_cpu, cuda_region.region_cuda, _region_fake)


# --------------------------------------------------------------- int8 conv
def _int8_conv_cpu(x_q, w_q, w_scale, bias, x_scale, size, stride, pad_lo,
                   out_hw, out_dtype, leaky):
    return qm.int8_conv_plain(
        x_q, w_q, w_scale, bias, x_scale, size=size, stride=tuple(stride),
        padding=qm.full_padding(x_q.shape[1:3], size, stride, pad_lo,
                                out_hw),
        out_hw=tuple(out_hw), out_dtype=out_dtype, leaky=leaky)


def _int8_conv_cuda(x_q, w_q, w_scale, bias, x_scale, size, stride, pad_lo,
                    out_hw, out_dtype, leaky):
    return qm.int8_conv_cuda(x_q, w_q, w_scale, bias, x_scale, size=size,
                             stride=tuple(stride), pad_lo=tuple(pad_lo),
                             out_hw=tuple(out_hw), out_dtype=out_dtype,
                             leaky=leaky)


def _int8_conv_fake(x_q, w_q, w_scale, bias, x_scale, size, stride, pad_lo,
                    out_hw, out_dtype, leaky):
    return x_q.new_empty((x_q.shape[0], out_hw[0], out_hw[1], w_q.shape[0]),
                         dtype=out_dtype)


_define("int8_conv(Tensor x_q, Tensor w_q, Tensor w_scale, Tensor bias, "
        "Tensor x_scale, int size, int[] stride, int[] pad_lo, int[] out_hw, "
        "ScalarType out_dtype, bool leaky) -> Tensor",
        _int8_conv_cpu, _int8_conv_cuda, _int8_conv_fake)


# ------------------------------------------------------------- int8 matmul
def _int8_matmul_cpu(a_q, b_q, w_scales, bias, x_scale, leaky):
    return qm.int8_matmul_plain(a_q, b_q, w_scales, bias, x_scale,
                                leaky=leaky)


def _int8_matmul_cuda(a_q, b_q, w_scales, bias, x_scale, leaky):
    return qm.int8_matmul_cuda(a_q, b_q, w_scales, bias, x_scale,
                               leaky=leaky)


def _int8_matmul_fake(a_q, b_q, w_scales, bias, x_scale, leaky):
    return a_q.new_empty((a_q.shape[0], b_q.shape[0]), dtype=torch.float32)


_define("int8_matmul(Tensor a_q, Tensor b_q, Tensor w_scales, Tensor bias, "
        "Tensor x_scale, bool leaky) -> Tensor",
        _int8_matmul_cpu, _int8_matmul_cuda, _int8_matmul_fake)


# ------------------------------------------------------------ conv epilogue
def _conv_epilogue_fake(y, bias, act):
    return y.new_empty(y.shape, dtype=torch.bfloat16)


_define("conv_epilogue(Tensor y, Tensor bias, str act) -> Tensor",
        cuda_epilogue.conv_epilogue_plain, cuda_epilogue.conv_epilogue_cuda,
        _conv_epilogue_fake)
