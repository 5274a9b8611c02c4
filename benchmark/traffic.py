"""The one generator of serving traffic: it reads a mix's parameters
(`benchmark/traffic/<name>.json`) and makes the frames from the seed.

    {"batch": 8, "pool_batches": 8, "warmup_requests": 8,
     "profiled_requests": 3, "thresh": 0.25, "nms": 0.45, "top_k": 256}

The loop is closed, with one client and one request in flight: the
next batch goes in once the last one's triple is on the host.  Batches of
`batch` uint8 frames at the network's size (`images.py`) cycle through a
pool of `pool_batches`, made from the seed on the device and held on the
host as a camera's frames would be.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import images


def frames(n: int, model, seed: int, device) -> np.ndarray:
    """`n` camera-like uint8 frames (n, H, W, C) from the seed
    (`images.py`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return images.frames(n, model.net_h, model.net_w, model.net_c, gen,
                         device).cpu().numpy()


def pool(traffic: dict, model, seed: int, device) -> np.ndarray:
    """(pool_batches, batch, H, W, C) uint8."""
    p, b = traffic["pool_batches"], traffic["batch"]
    return frames(p * b, model, seed, device).reshape(
        p, b, model.net_h, model.net_w, model.net_c)


def unit_table(device) -> torch.Tensor:
    """uint8 v -> v / 255 as the host divides (correctly rounded f32)."""
    return torch.from_numpy(np.arange(256, dtype=np.float32)
                            / np.float32(255)).to(device)


def to_unit(u8, device) -> torch.Tensor:
    """uint8 frames -> float32 in [0, 1] on `device`, the host's
    quotients."""
    return unit_table(device)[torch.from_numpy(np.ascontiguousarray(u8))
                              .to(device).long()]


def closed_loop(request, batches: np.ndarray, seconds: float,
                start: int = 0) -> dict:
    """Send batches in turn until `seconds` have passed, each once the
    last one's answer is back.  request(batch) returns the answer on the
    host.  {"latencies_s", "answers", "batch_index", "seconds", "t0"}:
    the window runs from the first send (perf_counter t0) to the last
    answer."""
    lat, answers, which = [], [], []
    i = start
    t0 = time.perf_counter()
    while True:
        k = i % len(batches)
        t = time.perf_counter()
        answers.append(request(batches[k]))
        end = time.perf_counter()
        lat.append(end - t)
        which.append(k)
        i += 1
        if end - t0 >= seconds:
            break
    return {"latencies_s": lat, "answers": answers, "batch_index": which,
            "seconds": end - t0, "t0": t0}


def sample(n_done: int, k: int, seed: int) -> list:
    """`k` of the finished requests, drawn from the seed, in order."""
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(n_done, size=min(k, n_done),
                             replace=False).tolist())
