"""ctypes binding of the CUDA int8 GEMM (`csrc/int8_gemm.cu`).

`launch` runs the kernel on the current stream of the operands' card and
raises if the launch fails; `ops.quant_matmul.int8_matmul` is the wrapper
that checks the operands, allocates the output and counts the launches.
"""

from __future__ import annotations

import ctypes


def _lib():
    from darknet_tpu_torch.ops.cuda.build import load

    lib = load("int8_gemm")
    lib.int8_gemm_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.int8_gemm_launch.restype = ctypes.c_int
    lib.int8_gemm_error_string.argtypes = [ctypes.c_int]
    lib.int8_gemm_error_string.restype = ctypes.c_char_p
    return lib


def launch(a_q, b_q, w_scales, bias, x_scale, out, leaky: bool) -> None:
    """out (M, N) f32 = epilogue(a_q (M, K) int8 . b_q (N, K) int8^T).
    Every tensor is contiguous and on one card (the wrapper checks)."""
    import torch

    lib = _lib()
    (m, k), n = a_q.shape, b_q.shape[0]
    with torch.cuda.device(a_q.device):
        stream = torch.cuda.current_stream(a_q.device).cuda_stream
        err = lib.int8_gemm_launch(
            a_q.data_ptr(), b_q.data_ptr(), w_scales.data_ptr(),
            bias.data_ptr(), x_scale.data_ptr(), out.data_ptr(), m, n, k,
            int(leaky), stream)
    if err != 0:
        raise RuntimeError(f"int8_gemm launch failed ({err}): "
                           f"{lib.int8_gemm_error_string(err).decode()}")
