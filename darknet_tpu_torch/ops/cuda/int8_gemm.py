"""ctypes binding of the CUDA int8 GEMM (`csrc/int8_gemm.cu`).

`launch` runs the GEMM and `launch_conv` the implicit-GEMM conv on the
current stream of the operands' card, and raise if the launch fails;
`ops.quant_matmul.int8_matmul` / `int8_conv` are the wrappers that check
the operands, allocate the output and count the launches.
"""

from __future__ import annotations

import ctypes

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    from darknet_tpu_torch.ops.cuda.build import load

    lib = load("int8_gemm")
    if not getattr(lib, "_typed", False):
        lib.int8_gemm_launch.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        lib.int8_gemm_launch.restype = _I
        lib.int8_conv_launch.argtypes = [_P] * 6 + [_I] * 15 + [_P]
        lib.int8_conv_launch.restype = _I
        lib.int8_gemm_error_string.argtypes = [_I]
        lib.int8_gemm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _stream(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def _check(lib, what, err):
    if err != 0:
        raise RuntimeError(f"{what} launch failed ({err}): "
                           f"{lib.int8_gemm_error_string(err).decode()}")


def _bf16(out) -> int:
    import torch

    return int(out.dtype == torch.bfloat16)


def launch(a_q, b_q, w_scales, bias, x_scale, out, leaky: bool) -> None:
    """out (M, N) f32 or bf16 = epilogue(a_q (M, K) int8 . b_q (N, K)
    int8^T).  Every tensor is contiguous, 16-byte aligned and on one card,
    K % 16 == 0 (the wrapper sees to it)."""
    import torch

    lib = _lib()
    (m, k), n = a_q.shape, b_q.shape[0]
    with torch.cuda.device(a_q.device):
        err = lib.int8_gemm_launch(
            a_q.data_ptr(), b_q.data_ptr(), w_scales.data_ptr(),
            bias.data_ptr(), x_scale.data_ptr(), out.data_ptr(), m, n, k,
            int(leaky), _bf16(out), _stream(a_q))
    _check(lib, "int8_gemm", err)


def launch_conv(x_q, w_q, w_scales, bias, x_scale, out, *, size, stride,
                pad_lo, out_hw, leaky: bool) -> None:
    """out (B*OH*OW, N) = epilogue(implicit im2col of x_q (B, H, W, C)
    NHWC int8 . w_q (N, size*size*C)^T); C % 16 == 0, every tensor
    contiguous, 16-byte aligned and on one card (the wrapper sees to it)."""
    import torch

    lib = _lib()
    b, h, w, c = x_q.shape
    with torch.cuda.device(x_q.device):
        err = lib.int8_conv_launch(
            x_q.data_ptr(), w_q.data_ptr(), w_scales.data_ptr(),
            bias.data_ptr(), x_scale.data_ptr(), out.data_ptr(), b, h, w, c,
            w_q.shape[0], size, size, stride[0], stride[1], pad_lo[0],
            pad_lo[1], out_hw[0], out_hw[1], int(leaky), _bf16(out),
            _stream(x_q))
    _check(lib, "int8_conv", err)
