"""int8 quantized matmul (`darknet_tpu/ops/pallas/quant_matmul.py`) in torch.

    int8_matmul(a_q, b_q, w_scales, bias, x_scale, leaky=False)
        (M, K) int8 . (N, K) int8^T -> (M, N) float32
        = float(acc) * (x_scale * w_scales[n]) + bias[n], then leaky 0.1

The weight operand is (N, K), K-contiguous like the activations (the
JAX function takes (K, N)); conv weights are stored that way once
(`nn/params.params_to_torch`).  `x_scale` is a 1-element float32 tensor
on the operands' device (the kernel reads it through a pointer, so no
host sync) or a Python float.

A CPU tensor goes to `int8_matmul_plain`; a CUDA tensor launches the
CUDA kernel (`csrc/int8_gemm.cu`) or raises.  `launches` counts the
kernel launches.

The plain version sums in float64, which is exact (|acc| <= K * 127^2 is
far below 2^53) on the CPU and on the card alike (torch has no integer
matmul on CUDA), and applies the kernel's f32 epilogue as separate
rounded multiplies and adds: given the same operands the two agree
bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

launches = 0


def quantize_weights_int8(w: np.ndarray):
    """Per-output-channel symmetric int8 quantization of an HWIO (or
    (K, N)) weight array: (w_int8, scales (N,))."""
    w = np.asarray(w, dtype=np.float32)
    flat = w.reshape(-1, w.shape[-1])
    absmax = np.maximum(np.abs(flat).max(axis=0), 1e-8)
    scales = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(flat / scales), -127, 127).astype(np.int8)
    return q.reshape(w.shape), scales


def _f32(v, device):
    return torch.full((), v, dtype=torch.float32, device=device) \
        if not isinstance(v, torch.Tensor) else v.to(device, torch.float32)


def input_scale(x, absmax=None):
    """Per-tensor activation scale absmax / 127 as a float32 tensor on
    x's device; absmax defaults to max(max|x|, 1e-8) over the whole
    tensor (a dynamic scale, kept on the device).  Divides by a device
    tensor: on CUDA, a division by a Python scalar multiplies by its f32
    reciprocal, which is not always the correctly rounded quotient that
    the reference computes."""
    if absmax is None:
        absmax = torch.clamp_min(x.float().abs().amax(), 1e-8)
    return _f32(absmax, x.device) / _f32(127.0, x.device)


def quantize_int8(x, x_scale):
    """clip(round(x / x_scale), -127, 127) as int8, computed from x in
    float32 with a true division; torch.round rounds half to even, as
    jnp.round does."""
    q = torch.round(x.float() / _f32(x_scale, x.device))
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_activations_int8(x, absmax=None):
    """Per-tensor symmetric activation quantization: (x_q int8, scale)."""
    scale = input_scale(x, absmax)
    return quantize_int8(x, scale), scale


def int8_matmul_plain(a_q, b_q, w_scales, bias, x_scale, *,
                      leaky: bool = False):
    """The plain version of the kernel, on any device."""
    acc = a_q.double() @ b_q.double().T
    s = _f32(x_scale, a_q.device).reshape(-1)[0] * w_scales.float()
    y = acc.float() * s + bias.float()
    if leaky:
        y = torch.where(y > 0, y, 0.1 * y)
    return y


def int8_matmul(a_q, b_q, w_scales, bias, x_scale, *, leaky: bool = False):
    """(M, K) int8 . (N, K) int8^T -> (M, N) f32 with the dequant, bias
    and optional leaky epilogue: the plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor (operands checked, output allocated
    here, launched on the current stream, counted in `launches`)."""
    global launches
    if a_q.device.type == "cpu":
        return int8_matmul_plain(a_q, b_q, w_scales, bias, x_scale,
                                 leaky=leaky)
    if a_q.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {a_q.device}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[1]:
        raise ValueError(f"int8_matmul takes (M, K) and (N, K), got "
                         f"{tuple(a_q.shape)} and {tuple(b_q.shape)}")
    n = b_q.shape[0]
    x_scale = _f32(x_scale, a_q.device).reshape(-1)
    for name, t, dt, shape in (("a_q", a_q, torch.int8, None),
                               ("b_q", b_q, torch.int8, None),
                               ("w_scales", w_scales, torch.float32, (n,)),
                               ("bias", bias, torch.float32, (n,)),
                               ("x_scale", x_scale, torch.float32, (1,))):
        if t.device != a_q.device or t.dtype != dt:
            raise ValueError(f"int8_matmul: {name} must be {dt} on "
                             f"{a_q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or (shape and tuple(t.shape) != shape):
            raise ValueError(f"int8_matmul: {name} must be contiguous"
                             f"{'' if not shape else f' of shape {shape}'}"
                             f", got {tuple(t.shape)}")
    from darknet_tpu_torch.ops.cuda import int8_gemm

    out = torch.empty((a_q.shape[0], n), dtype=torch.float32,
                      device=a_q.device)
    int8_gemm.launch(a_q, b_q, w_scales, bias, x_scale, out, leaky)
    launches += 1
    return out


def quantized_conv1x1(x, w_q, w_scales, bias, *, leaky: bool = False):
    """int8 1x1 convolution: NHWC x (1, 1, C, N) int8 HWIO -> NHWC f32,
    with the activation quantized per tensor on the fly (dynamic)."""
    b, h, w, c = x.shape
    w_q = torch.as_tensor(np.asarray(w_q)).to(x.device)
    n = w_q.shape[-1]
    a_q, x_scale = quantize_activations_int8(x)
    out = int8_matmul(
        a_q.reshape(-1, c), w_q.reshape(c, n).T.contiguous(),
        torch.as_tensor(w_scales, dtype=torch.float32).to(x.device),
        torch.as_tensor(bias, dtype=torch.float32).to(x.device), x_scale,
        leaky=leaky)
    return out.reshape(b, h, w, n)
