"""int8 quantized matmul (`darknet_tpu/ops/pallas/quant_matmul.py`) in torch.

    int8_matmul(a_q, b_q, w_scales, bias, x_scale, leaky=False)
        (M, K) int8 . (N, K) int8^T -> (M, N) float32
        = float(acc) * (x_scale * w_scales[n]) + bias[n], then leaky 0.1
    int8_conv(x_q, w_q, w_scale, bias, x_scale, *, size, stride, padding,
              out_hw, out_dtype, leaky)
        the same product over the implicit im2col of an NHWC int8 input
        (K ordered (kh, kw, c)), -> (B, OH, OW, N) in out_dtype (float32,
        or bf16: the f32 result rounded once), leaky after the cast

The weight operand is (N, K), K-contiguous like the activations (the
JAX function takes (K, N)); conv weights are stored that way once
(`nn/params.params_to_torch`).  `x_scale` is a 1-element float32 tensor
on the operands' device (the kernel reads it through a pointer, so no
host sync) or a Python float.

Both go through the custom ops `darknet_tpu_torch::int8_matmul` and
`darknet_tpu_torch::int8_conv` (`ops/library.py`), which `torch.export`
records as nodes.  A CPU tensor goes to the plain version
(`int8_matmul_plain`, `int8_conv_plain`: the explicit `im2col_int8`,
then the GEMM); a CUDA tensor launches the CUDA kernel (`csrc/
int8_gemm.cu`, which reads the NHWC input in place; `int8_matmul_cuda`,
`int8_conv_cuda`) or raises.  `launches` counts the kernel launches of
both.

The plain version sums in float64, which is exact (|acc| <= K * 127^2 is
far below 2^53) on the CPU and on the card alike (torch has no integer
matmul on CUDA), and applies the kernel's f32 epilogue as separate
rounded multiplies and adds: given the same operands the two agree
bitwise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _aligned(t):
    """t contiguous at a 16-byte aligned address (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_epilogue(name, dev, n, w_scales, bias, x_scale):
    for what, t, shape in (("w_scales", w_scales, (n,)), ("bias", bias, (n,)),
                           ("x_scale", x_scale, (1,))):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be contiguous of shape "
                             f"{shape}, got {tuple(t.shape)}")


def _device_ok(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")


def int8_matmul(a_q, b_q, w_scales, bias, x_scale, *, leaky: bool = False):
    """(M, K) int8 . (N, K) int8^T -> (M, N) f32 with the dequant, bias
    and optional leaky epilogue, through the op `darknet_tpu_torch::
    int8_matmul`: the plain version for a CPU tensor, the CUDA kernel for
    a CUDA tensor (`int8_matmul_cuda`)."""
    from darknet_tpu_torch.ops import library  # noqa: F401 (the ops)

    _device_ok("int8_matmul", a_q)
    return torch.ops.darknet_tpu_torch.int8_matmul.default(
        a_q, b_q, w_scales, bias, _f32(x_scale, a_q.device).reshape(-1),
        leaky)


def int8_matmul_cuda(a_q, b_q, w_scales, bias, x_scale, *,
                     leaky: bool = False):
    """The op's CUDA backend: operands checked, output allocated here,
    launched on the current stream, counted in `launches`.  A K that is
    not a multiple of 16 is zero-padded (exact) and a misaligned operand
    copied, as the kernel's TMA loads need."""
    global launches
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[1]:
        raise ValueError(f"int8_matmul takes (M, K) and (N, K), got "
                         f"{tuple(a_q.shape)} and {tuple(b_q.shape)}")
    for name, t in (("a_q", a_q), ("b_q", b_q)):
        if t.device != a_q.device or t.dtype != torch.int8:
            raise ValueError(f"int8_matmul: {name} must be int8 on "
                             f"{a_q.device}, got {t.dtype} on {t.device}")
    n = b_q.shape[0]
    _check_epilogue("int8_matmul", a_q.device, n, w_scales, bias, x_scale)
    from darknet_tpu_torch.ops.cuda import int8_gemm

    k_pad = -a_q.shape[1] % 16
    if k_pad:
        a_q, b_q = F.pad(a_q, (0, k_pad)), F.pad(b_q, (0, k_pad))
    out = torch.empty((a_q.shape[0], n), dtype=torch.float32,
                      device=a_q.device)
    int8_gemm.launch(_aligned(a_q), _aligned(b_q), w_scales, bias, x_scale,
                     out, leaky)
    launches += 1
    return out


def im2col_int8(x_q, kh, kw, stride, padding, out_hw):
    """(B,H,W,C) int8 -> (B*OH*OW, kh*kw*C) int8, K ordered (kh, kw, c)
    like the stored "w_q" (`nn/params.params_to_torch`).  Zero padding is
    exact: a zero input quantizes to 0.  A 1x1 stride-1 conv is a view.
    The plain version's operand: the kernel reads x_q in place."""
    (lo_h, hi_h), (lo_w, hi_w) = padding
    b, h, w, c = x_q.shape
    (oh, ow), (sy, sx) = out_hw, stride
    if (kh, kw, sy, sx, lo_h, lo_w, oh, ow) == (1, 1, 1, 1, 0, 0, h, w):
        return x_q.reshape(-1, c)
    xp = F.pad(x_q, (0, 0, lo_w, hi_w, lo_h, hi_h))
    cols = [xp[:, ky:ky + sy * (oh - 1) + 1:sy, kx:kx + sx * (ow - 1) + 1:sx]
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(cols, dim=3).reshape(b * oh * ow, kh * kw * c)


def int8_conv_plain(x_q, w_q, w_scale, bias, x_scale, *, size, stride,
                    padding, out_hw, out_dtype=torch.float32,
                    leaky: bool = False):
    """The plain version of `int8_conv`, on any device: the explicit
    im2col and `int8_matmul_plain`, the cast, then leaky."""
    a = im2col_int8(x_q, size, size, stride, padding, out_hw)
    y = int8_matmul_plain(a, w_q, w_scale, bias, x_scale).to(out_dtype)
    if leaky:
        y = torch.where(y > 0, y, 0.1 * y)
    return y.reshape(x_q.shape[0], out_hw[0], out_hw[1], -1)


def pad_channels(x_q, w_q, size, multiple: int = 128):
    """x_q (B, H, W, C) and w_q (N, size*size*C) with C zero-padded to a
    multiple of `multiple`, in x_q and in each tap of w_q: the kernel reads
    128 channels a K step.  Exact: the padded products are 0."""
    c, n = x_q.shape[-1], w_q.shape[0]
    c_pad = -c % multiple
    if not c_pad:
        return x_q, w_q
    return (F.pad(x_q, (0, c_pad)),
            F.pad(w_q.reshape(n, size * size, c), (0, c_pad)).reshape(n, -1))


def full_padding(in_hw, size, stride, pad_lo, out_hw) -> tuple:
    """((lo, hi), (lo, hi)) from the low edges: hi is what the last window
    reads beyond the input (padding past it is never read)."""
    return tuple((lo, max(0, (o - 1) * s + size - n - lo))
                 for n, s, lo, o in zip(in_hw, stride, pad_lo, out_hw))


def int8_conv(x_q, w_q, w_scale, bias, x_scale, *, size, stride, padding,
              out_hw, out_dtype=torch.float32, leaky: bool = False):
    """int8 conv: x_q (B, H, W, C) NHWC int8 and w_q (N, size*size*C) int8
    ((kh, kw, c) order) -> (B, OH, OW, N) in out_dtype (float32 or
    bfloat16) = epilogue of the exact int32 sums, cast, then leaky.
    padding is darknet's ((lo, hi), (lo, hi)); the op takes the low edges
    (the high ones follow from out_hw).  Through the op
    `darknet_tpu_torch::int8_conv`: the plain version for a CPU tensor;
    for a CUDA tensor the implicit-GEMM kernel (`int8_conv_cuda`)."""
    from darknet_tpu_torch.ops import library  # noqa: F401 (the ops)

    _device_ok("int8_conv", x_q)
    return torch.ops.darknet_tpu_torch.int8_conv.default(
        x_q, w_q, w_scale, bias, _f32(x_scale, x_q.device).reshape(-1),
        size, stride, (padding[0][0], padding[1][0]), out_hw, out_dtype,
        leaky)


def int8_conv_cuda(x_q, w_q, w_scale, bias, x_scale, *, size, stride,
                   pad_lo, out_hw, out_dtype=torch.float32,
                   leaky: bool = False):
    """The op's CUDA backend: the implicit-GEMM kernel, which reads x_q in
    place (counted in `launches`).  A C that is not a multiple of 128 is
    zero-padded (`pad_channels`) and a misaligned operand copied."""
    global launches
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_conv writes float32 or bfloat16, not "
                         f"{out_dtype}")
    b, h, w, c = x_q.shape
    n = w_q.shape[0]
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if t.device != x_q.device or t.dtype != torch.int8:
            raise ValueError(f"int8_conv: {name} must be int8 on "
                             f"{x_q.device}, got {t.dtype} on {t.device}")
    if x_q.dim() != 4 or w_q.dim() != 2 or w_q.shape[1] != size * size * c:
        raise ValueError(f"int8_conv takes (B, H, W, C) and (N, {size}*"
                         f"{size}*C), got {tuple(x_q.shape)} and "
                         f"{tuple(w_q.shape)}")
    _check_epilogue("int8_conv", x_q.device, n, w_scale, bias, x_scale)
    from darknet_tpu_torch.ops.cuda import int8_gemm

    x_q, w_q = pad_channels(x_q, w_q, size)
    out = torch.empty((b, out_hw[0], out_hw[1], n), dtype=out_dtype,
                      device=x_q.device)
    int8_gemm.launch_conv(_aligned(x_q), _aligned(w_q), w_scale, bias,
                          x_scale, out, size=size, stride=stride,
                          pad_lo=pad_lo, out_hw=out_hw, leaky=leaky)
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
