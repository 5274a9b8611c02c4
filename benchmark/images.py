"""Camera-like frames from the seed, made on the device.

Uniform noise is a poor stand-in for a camera: a deep network's
receptive fields average it away, every deep feature sits near its
mean, and batch norm statistics taken on it magnify rounding by
thousands.  These frames have structure at every scale instead:
smooth noise at three scales, then flat-coloured rectangles of 4-25%
of the side (the objects), then a little pixel noise, as uint8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SCALES = ((4, 0.5), (16, 0.3), (64, 0.2))     # (grid, weight) of the noise
RECTS = 12                                   # rectangles a frame


def frames(n: int, h: int, w: int, c: int, gen, device) -> torch.Tensor:
    """(n, h, w, c) uint8 on `device`, drawn from `gen`."""
    img = torch.zeros((n, c, h, w), device=device)
    for grid, weight in SCALES:
        g = torch.rand((n, c, grid, grid), generator=gen, device=device)
        img += weight * F.interpolate(g, size=(h, w), mode="bilinear",
                                      align_corners=False)
    r = torch.rand((5 + c, n, RECTS), generator=gen, device=device)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    for k in range(RECTS):
        size_y = 0.04 + 0.21 * r[0, :, k]
        size_x = 0.04 + 0.21 * r[1, :, k]
        y0 = r[2, :, k] * (1 - size_y)
        x0 = r[3, :, k] * (1 - size_x)
        inside = ((ys >= y0[:, None, None]) & (ys < (y0 + size_y)[:, None, None])
                  & (xs >= x0[:, None, None])
                  & (xs < (x0 + size_x)[:, None, None]))      # (n, h, w)
        colour = r[5:, :, k].t()[:, :, None, None]           # (n, c, 1, 1)
        img = torch.where(inside[:, None], colour, img)
    img += 0.05 * (torch.rand((n, c, h, w), generator=gen, device=device)
                   - 0.5)
    return (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(
        0, 2, 3, 1).contiguous()
