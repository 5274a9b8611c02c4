"""Debug aids (`darknet_tpu/utils/debug.py`) on torch, standing in for the
reference's:

* `debug_sync_mode()`, the `-cuda_dbg_sync` analogue: the forward and the
  training step synchronise the card after every layer, so that a fault
  surfaces at the layer that made it, with the layer named in the error.
  `CUDA_LAUNCH_BLOCKING` cannot be set once CUDA is up, so the sync is
  explicit;
* `debug_nans()`, the fail-fast form of the reference's fix_nan_and_inf
  hooks (blas.h:63,145-147): the first layer whose output holds a NaN or
  an Inf raises FloatingPointError naming the layer, and training's
  backward runs under `torch.autograd.detect_anomaly`;
* `compare_arrays()`, `cuda_compare` / `compare_2_arrays_gpu`
  (dark_cuda.c:479): a max-abs difference report of two tensors.

Both modes are process-wide, as the JAX package's `jax.config` flags are,
and restore the previous state when their block exits.  Off, they cost one
check per layer (`layer_check()` is None).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class _Modes:
    sync: bool = False
    nans: bool = False


_MODES = _Modes()


@contextlib.contextmanager
def _mode(name: str, enable: bool):
    prev = getattr(_MODES, name)
    setattr(_MODES, name, enable)
    try:
        yield
    finally:
        setattr(_MODES, name, prev)


def debug_sync_mode(enable: bool = True):
    """Synchronise the card after every layer of a forward or train step
    (a context manager)."""
    return _mode("sync", enable)


def debug_nans(enable: bool = True):
    """Raise FloatingPointError at the first layer output with a NaN or an
    Inf; backward passes run under anomaly detection (a context
    manager)."""
    return _mode("nans", enable)


def _check(name: str, y) -> None:
    if not isinstance(y, torch.Tensor):
        return
    if _MODES.sync and y.is_cuda:
        try:
            torch.cuda.synchronize(y.device)
        except RuntimeError as e:
            raise RuntimeError(f"{name}: {e}") from e
    if _MODES.nans and y.is_floating_point() and \
            not bool(torch.isfinite(y).all()):
        raise FloatingPointError(f"{name}: the output holds NaN or Inf")


def layer_check():
    """The per-layer check of the modes in force, `check(name, output)`,
    or None when both are off."""
    return _check if (_MODES.sync or _MODES.nans) else None


def anomaly():
    """`torch.autograd.detect_anomaly` under debug_nans, else nothing."""
    return (torch.autograd.detect_anomaly() if _MODES.nans
            else contextlib.nullcontext())


def compare_arrays(a, b, name: str = "", log=print) -> float:
    """Max-abs difference of two arrays or tensors, logged with the mean
    and the largest relative difference; inf on a shape mismatch."""
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    if isinstance(b, torch.Tensor):
        b = b.detach().float().cpu().numpy()
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        log(f"compare {name}: SHAPE MISMATCH {a.shape} vs {b.shape}")
        return float("inf")
    diff = np.abs(a - b)
    rel = diff / np.maximum(np.abs(b), 1e-9)
    log(f"compare {name}: max_abs={diff.max():.3e} mean_abs={diff.mean():.3e}"
        f" max_rel={rel.max():.3e}")
    return float(diff.max())
