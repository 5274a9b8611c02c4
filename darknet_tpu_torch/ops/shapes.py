"""Wiring layers (`darknet_tpu/ops/shapes.py`) in torch: route, shortcut,
upsample (and its reverse), reorg3d, reorg_old, scale_channels, dropout,
dropblock and crop.  NHWC throughout.

The random layers draw from an explicit `torch.Generator` that lives on
the tensor's device (a generator on another device raises): `dropout`,
`dropblock` and `crop_layer` take their draw from it (`dropout_keep`,
`dropblock_seeds`, `crop_draw`) and hand it to the function that holds
the arithmetic (`dropout_apply`, `dropblock_apply`, `crop_apply`).  The
draws cannot equal the JAX package's (`jax.random` and torch's streams
differ); the arithmetic given the same draw does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from darknet_tpu_torch.ops.activations import apply_activation


def route(tensors: list, groups: int = 1, group_id: int = 0):
    """[route]: channel concat; with groups, the group_id-th 1/groups slice
    of each input (CSP partial concat, route_layer.c:95-103)."""
    if groups > 1:
        tensors = [t[..., group_id * (t.shape[-1] // groups):
                      (group_id + 1) * (t.shape[-1] // groups)]
                   for t in tensors]
    if len(tensors) == 1:
        return tensors[0]
    return torch.cat(tensors, dim=-1)


def shortcut(x, from_tensor, activation: str = "linear"):
    """[shortcut]: add + activation.  With mismatched channels only the
    first min(c_in, c_from) channels add and the rest of `x` passes
    through (the reference's GPU semantics, PARITY.md DEVIATION 16)."""
    c_in, c_from = x.shape[-1], from_tensor.shape[-1]
    if c_in == c_from:
        y = x + from_tensor
    elif c_from < c_in:
        y = torch.cat([x[..., :c_from] + from_tensor, x[..., c_from:]],
                      dim=-1)
    else:
        y = x + from_tensor[..., :c_in]
    return apply_activation(y, activation)


def upsample(x, stride: int, scale: float = 1.0):
    """[upsample]: nearest neighbour x stride, then a scalar scale."""
    y = x.repeat_interleave(stride, dim=1).repeat_interleave(stride, dim=2)
    if scale != 1.0:
        y = y * scale
    return y


def upsample_reverse(x, stride: int, scale: float = 1.0):
    """Reverse [upsample] (cfg stride < 0): the sum of each stride x
    stride block, then the scale."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // stride, stride, w // stride, stride, c).sum((2, 4))
    if scale != 1.0:
        y = y * scale
    return y


@functools.lru_cache(maxsize=64)
def _reorg_perm_chw(dims, stride, forward):
    """The flat CHW permutation of blas.c `reorg_cpu` (blas.c:12-44) for
    loop bounds `dims` = (C, H, W) (`darknet_tpu/ops/shapes.py:75-101`):
    out_flat = x_flat[perm]; forward=True inverts the scatter."""
    C, H, W = dims
    s = stride
    in_c = C // (s * s)
    k = np.arange(C)[:, None, None]
    j = np.arange(H)[None, :, None]
    i = np.arange(W)[None, None, :]
    in_index = i + W * (j + H * k)
    offset = k // in_c
    out_index = (i * s + offset % s) + W * s * (
        (j * s + offset // s) + H * s * (k % in_c))
    if forward:
        perm = np.zeros(int(out_index.max()) + 1, dtype=np.int64)
        perm[np.broadcast_to(out_index, in_index.shape).ravel()] = \
            np.broadcast_to(in_index, out_index.shape).ravel()
        return perm
    # a writable copy: torch.from_numpy warns on a read-only view
    return np.broadcast_to(out_index, (C, H, W)).ravel().copy()


def _chw_permuted(x, perm, out_shape):
    """x (NHWC) flattened CHW, gathered by `perm`, reshaped to
    (B, oc, oh, ow) and returned NHWC."""
    b = x.shape[0]
    oh, ow, oc = out_shape
    flat = x.permute(0, 3, 1, 2).reshape(b, -1)
    y = flat.index_select(1, torch.from_numpy(perm).to(x.device))
    return y.reshape(b, oc, oh, ow).permute(0, 2, 3, 1)


def reorg3d(x, stride: int, reverse: bool = False, out_shape=None):
    """[reorg3d] (reorg_layer.c:87-99): space-to-depth, output channel
    c2 + c * (dy * s + dx) at (j, i) reading channel c2 at (j*s + dy,
    i*s + dx); reverse uses `reorg_cpu`'s exact permutation (forward=1)."""
    b, h, w, c = x.shape
    s = stride
    if not reverse:
        y = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, h // s, w // s, s * s * c)
    oh, ow, oc = out_shape if out_shape else (h * s, w * s, c // (s * s))
    return _chw_permuted(x, _reorg_perm_chw((oc, oh, ow), s, True),
                         (oh, ow, oc))


def reorg_old(x, stride: int, reverse: bool = False, out_shape=None):
    """[reorg] (reorg_old_layer.c:87-93): `reorg_cpu` called with the
    layer's input dims, the old flat-reinterpretation quirk, exactly."""
    b, h, w, c = x.shape
    s = stride
    out_shape = out_shape if out_shape else (
        (h // s, w // s, c * s * s) if not reverse
        else (h * s, w * s, c // (s * s)))
    return _chw_permuted(x, _reorg_perm_chw((c, h, w), s, bool(reverse)),
                         out_shape)


def scale_channels(gate, feature, scale_wh: bool = False,
                   activation: str = "linear"):
    """[scale_channels] (scale_channels_layer.c:72-100): feature * gate,
    the gate (B,1,1,C) per channel or, with scale_wh, (B,H,W,1) per
    pixel, broadcast; then the activation."""
    return apply_activation(feature * gate, activation)


def _on_device(generator, x):
    if generator.device.type != x.device.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"tensor on {x.device}: draw where the tensor is")


def dropout_keep(x, probability: float, generator):
    """The keep mask of dropout: True with probability 1 - p per element,
    drawn on x's device."""
    _on_device(generator, x)
    return torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - probability


def dropout_apply(x, keep, probability: float):
    """Inverted dropout (dropout_layer.c:89-105) given the keep mask:
    kept values scaled by 1/(1-p), the rest 0."""
    return torch.where(keep, x / (1.0 - probability), 0.0)


def dropout(x, generator, probability: float):
    return dropout_apply(x, dropout_keep(x, probability, generator),
                         probability)


def dropblock_size(h: int, w: int, block_size_abs: int,
                   block_size_rel: float) -> int:
    if block_size_abs:
        return min(block_size_abs, min(h, w))
    return max(1, int(block_size_rel * min(h, w)))


def dropblock_seeds(x, probability: float, block: int, generator):
    """DropBlock's seed map (B, H, W, 1) in x's dtype: 1 with probability
    p / block^2 per position (the expected dropped share is p)."""
    _on_device(generator, x)
    b, h, w, _c = x.shape
    gamma = probability / float(block * block)
    return (torch.rand((b, h, w, 1), generator=generator, device=x.device)
            < gamma).to(x.dtype)


def dropblock_apply(x, seeds, block: int):
    """DropBlock given its seed map: each seed grows to a block x block
    square (a stride-1 max over the map padded with 0, the seed at offset
    block // 2), those positions drop, and the rest scale by 1 / the kept
    share of each image (at least 1e-6)."""
    keep, denom = dropblock_keep(seeds, block)
    return x * keep / denom


def dropblock_keep(seeds, block: int):
    """(keep (B, H, W, 1), denom (B, 1, 1, 1)) of `dropblock_apply`: the
    grown blocks' complement and each image's kept share."""
    pad = block // 2
    m = F.pad(seeds.permute(0, 3, 1, 2),
              (pad, block - 1 - pad, pad, block - 1 - pad), value=0.0)
    mask = F.max_pool2d(m, block, 1).permute(0, 2, 3, 1)
    keep = 1.0 - mask
    return keep, keep.mean((1, 2, 3), keepdim=True).clamp_min(1e-6)


def dropblock(x, generator, probability: float, block_size_abs: int,
              block_size_rel: float):
    """DropBlock (dropout_layer.c, the dropblock branch)."""
    block = dropblock_size(x.shape[1], x.shape[2], block_size_abs,
                           block_size_rel)
    return dropblock_apply(
        x, dropblock_seeds(x, probability, block, generator), block)


def crop_draw(x, l, generator):
    """[crop]'s one draw for the whole batch (crop_layer.c:65-67): the
    offsets (dh, dw), uniform over the valid range, and a flip (when the
    layer flips, with probability 1/2); Python values, read from x's
    device."""
    _on_device(generator, x)
    h, w = x.shape[1], x.shape[2]
    dev = x.device
    flip = bool(l.flip) and bool(torch.rand(
        (), generator=generator, device=dev) < 0.5)
    dh = int(torch.randint(0, h - l.crop_height + 1, (),
                           generator=generator, device=dev))
    dw = int(torch.randint(0, w - l.crop_width + 1, (),
                           generator=generator, device=dev))
    return dh, dw, flip


def crop_apply(x, l, dh: int, dw: int, flip: bool):
    """[crop] (crop_layer.c:63-101) given its offsets and flip: the
    (crop_height, crop_width) window at (dh, dw) of x, flipped
    horizontally first when `flip`, then `out * 2 - 1` unless noadjust."""
    if flip:
        x = x.flip(2)
    out = x[:, dh:dh + l.crop_height, dw:dw + l.crop_width, :]
    if not l.noadjust:
        out = out * 2.0 - 1.0
    return out


def crop_layer(x, l, *, train: bool = False, generator=None):
    """[crop]: in training with a generator, a random window and flip;
    otherwise the centre crop, no flip (`darknet_tpu/ops/shapes.py:
    193-223`)."""
    if train and generator is not None:
        return crop_apply(x, l, *crop_draw(x, l, generator))
    return crop_apply(x, l, (x.shape[1] - l.crop_height) // 2,
                      (x.shape[2] - l.crop_width) // 2, False)
