"""Threaded detection-data loader with double buffering.

Mirrors the reference's permanent worker pool + double buffer
(`data.cpp:723-837`, `detector.cpp:185-189`): a `DetectionLoader` keeps a
persistent worker pool producing batches ahead of the trainer; `next()`
hands over the ready batch and immediately kicks off the next one.  Mosaic
(4-image cut) and mixup (50/50 blend) are composed here, replicating the
`i_mixup` outer loop of `load_data_detection` (data.cpp:462-676).

Worker modes: the default thread pool matches the reference's
6-pthreads-per-GPU design, but Python threads serialize on the GIL for
the numpy parts of the augmentation.  `processes=N` switches the
per-sample stage to a spawn-based process pool (same seeds, same batches
bit-for-bit — `_sample_one` is a pure function of (paths, seed, dims,
aug config)); batch assembly (mosaic/mixup composition) stays in the
single assembler thread.  Spawned workers import numpy and torch (CPU
ops only) and keep to one torch thread each; spawning (not forking)
keeps the parent's CUDA context out of them.

`out_dtype=torch.bfloat16` has the assembler emit the image batch as a
bf16 CPU tensor (`bf16_from_f32`: round to nearest even, as torch's cast
rounds), so the upload is half the bytes; the augmentation stays f32.
`show_imgs=N` writes the first N samples of every batch, boxes drawn, to
`show_imgs_dir/aug_%05d.png` (`data/augment.save_augmented_sample`).

The port's copy of `darknet_tpu/data/loader.py`, with two repairs: a
sample is replaced by zeros (and logged to bad.list) only when its image
cannot be read or decoded (`OSError`, `data/image.ImageDecodeError`); a
missing library or a failed assertion propagates, so the loader never
trains on zeros for want of a decoder.  Batches are float32 numpy
arrays unless out_dtype says otherwise.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os
import threading

import numpy as np
import torch

from darknet_tpu_torch.data.augment import (blend_truth, blend_truth_mosaic,
                                            load_detection_sample,
                                            save_augmented_sample)
from darknet_tpu_torch.data.image import ImageDecodeError


def bf16_from_f32(x) -> torch.Tensor:
    """float32 -> a bfloat16 CPU tensor with torch's own rounding (to
    nearest even, NaN to 0x7FC0; c10's round_to_nearest_even), built
    from the bit patterns: numpy has no bf16 type."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    bits = ((u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16).astype(
        np.uint16)
    bits[np.isnan(x)] = 0x7FC0
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


# ---- process-worker plumbing (module-level: must pickle by reference) ----
_WCFG: dict = {}


def _init_worker(cfg):
    import torch

    torch.set_num_threads(1)
    _WCFG.update(cfg)


def _sample_one(cfg, seed, w, h):
    """One augmented sample from config dict `cfg` — the single body
    behind both worker modes (thread pool via DetectionLoader._sample,
    process pool via _worker_sample), keeping them bit-identical."""
    rng = np.random.default_rng(seed)
    path = cfg["paths"][rng.integers(0, len(cfg["paths"]))]
    try:
        return load_detection_sample(
            path, w, h, cfg["boxes"], cfg["classes"], rng=rng, **cfg["aug"])
    except (OSError, ImageDecodeError):
        # bad image: log to bad.list like the reference (data.cpp:87-89)
        # and emit zeros
        try:
            with open(os.path.join(cfg["bad_dir"], "bad.list"), "a") as f:
                f.write(path + "\n")
        except OSError:
            pass
        return (np.zeros((h, w, 3), np.float32),
                np.zeros((cfg["boxes"], 5), np.float32), {})


def _worker_sample(seed, w, h):
    """Per-sample stage in a worker process, config from the initializer."""
    return _sample_one(_WCFG, seed, w, h)


class DetectionLoader:
    def __init__(self, paths, *, w, h, batch, boxes=90, classes=80,
                 jitter=0.3, hue=0.1, saturation=1.5, exposure=1.5,
                 flip=True, blur=0, gaussian_noise=0, mixup=0,
                 threads=6, processes=0, seed=0, bad_dir=".",
                 show_imgs=0, show_imgs_dir=".", out_dtype=None):
        # cutmix: the reference refuses it for detection training
        # (data.cpp:428-432 prints and exits); mosaic+cutmix degrades to
        # plain mosaic with a warning
        if mixup == 2:
            raise ValueError(
                "cutmix=1 isn't supported for detector training "
                "(reference data.cpp:430)")
        if mixup == 4:
            import warnings

            warnings.warn("mosaic+cutmix: cutmix unsupported for detection;"
                          " using mosaic only (reference data.cpp:430)")
            mixup = 3
        self.paths = list(paths)
        self.bad_dir = bad_dir              # where bad.list is written
        self.show_imgs = show_imgs          # samples written a batch
        self.show_imgs_dir = show_imgs_dir
        self._show_counter = 0
        if show_imgs:
            os.makedirs(show_imgs_dir, exist_ok=True)
        if out_dtype not in (None, torch.bfloat16):
            raise ValueError(f"out_dtype is None (float32) or bfloat16, "
                             f"not {out_dtype}")
        self.out_dtype = out_dtype
        self.w, self.h = w, h
        self.batch = batch
        self.boxes = boxes
        self.classes = classes
        self.aug = dict(jitter=jitter, hue=hue, saturation=saturation,
                        exposure=exposure, use_flip=flip, use_blur=blur,
                        use_gaussian_noise=gaussian_noise)
        self.mixup = mixup           # 0=off, 1=mixup, 3=mosaic (net.mixup)
        self.rng = np.random.default_rng(seed)
        if processes:
            self.pool = cf.ProcessPoolExecutor(
                max_workers=processes,
                mp_context=mp.get_context("spawn"),
                initializer=_init_worker,
                initargs=({"paths": self.paths, "boxes": boxes,
                           "classes": classes, "aug": self.aug,
                           "bad_dir": bad_dir},))
            self._submit = lambda seed, w, h: self.pool.submit(
                _worker_sample, seed, w, h)
        else:
            self.pool = cf.ThreadPoolExecutor(max_workers=threads)
            self._submit = lambda seed, w, h: self.pool.submit(
                self._sample, seed, w, h)
        # the batch assembler blocks on sample futures, so it must NOT share
        # the sample pool (self-starvation deadlock at small pool sizes)
        self._assembler = cf.ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._lock = threading.Lock()
        self.resize(w, h)            # no-op; sets current dims
        self._kickoff()

    # ------------------------------------------------------------------
    def resize(self, w: int, h: int) -> None:
        """Multi-scale training support: subsequent batches load at the new
        resolution (the trainer re-jits per bucket)."""
        self.w, self.h = w, h

    def _sample(self, seed, w, h):
        return _sample_one({"paths": self.paths, "boxes": self.boxes,
                            "classes": self.classes, "aug": self.aug,
                            "bad_dir": self.bad_dir}, seed, w, h)

    def _make_batch(self, seed, w, h):
        rng = np.random.default_rng(seed)
        use_mixup = self.mixup
        if use_mixup and rng.integers(0, 2) == 0:
            use_mixup = 0             # 50% off (data.cpp:433-434)
        n_draws = {0: 1, 1: 2, 3: 4}.get(use_mixup, 1)

        seeds = rng.integers(0, 2 ** 31, size=(n_draws, self.batch))
        x = np.zeros((self.batch, h, w, 3), np.float32)
        y = np.zeros((self.batch, self.boxes, 5), np.float32)

        if use_mixup == 3:
            min_off = 0.2
            cut_x = rng.integers(int(w * min_off), int(w * (1 - min_off)),
                                 self.batch)
            cut_y = rng.integers(int(h * min_off), int(h * (1 - min_off)),
                                 self.batch)

        for quad in range(n_draws):
            futures = [self._submit(int(seeds[quad, i]), w, h)
                       for i in range(self.batch)]
            for i, fut in enumerate(futures):
                img, truth, meta = fut.result()
                if use_mixup == 0:
                    x[i], y[i] = img, truth
                elif use_mixup == 1:
                    if quad == 0:
                        x[i], y[i] = img, truth
                    else:
                        x[i] = 0.5 * x[i] + 0.5 * img
                        blend_truth(y[i], truth)
                elif use_mixup == 3:
                    cx, cy = int(cut_x[i]), int(cut_y[i])
                    pleft = meta.get("pleft", 0)
                    pright = meta.get("pright", 0)
                    ptop = meta.get("ptop", 0)
                    pbot = meta.get("pbot", 0)
                    if meta.get("flip"):
                        pleft, pright = pright, pleft
                    # the reference shifts crop windows by the out-of-image
                    # padding scaled from original-image to net pixels
                    # (`-pleft * w / ow`, data.cpp:577-586); C int division
                    # truncates toward zero but max(0, .) only passes
                    # positives, so floor (//) is equivalent
                    ow = meta.get("ow", w)
                    oh = meta.get("oh", h)
                    ls = min(cx, max(0, (-pleft * w) // ow))
                    ts = min(cy, max(0, (-ptop * h) // oh))
                    rs = min(w - cx, max(0, (-pright * w) // ow))
                    bs = min(h - cy, max(0, (-pbot * h) // oh))
                    if quad == 0:
                        x[i, :cy, :cx] = img[h - cy - bs:h - bs,
                                             w - cx - rs:w - rs]
                    elif quad == 1:
                        x[i, :cy, cx:] = img[h - cy - bs:h - bs,
                                             ls:ls + (w - cx)]
                    elif quad == 2:
                        x[i, cy:, :cx] = img[ts:ts + (h - cy),
                                             w - cx - rs:w - rs]
                    else:
                        x[i, cy:, cx:] = img[ts:ts + (h - cy),
                                             ls:ls + (w - cx)]
                    blend_truth_mosaic(y[i], truth, w, h, cx, cy, quad,
                                       ls, rs, ts, bs)
        for i in range(min(self.show_imgs, self.batch)):
            self._show_counter += 1
            save_augmented_sample(x[i], y[i], os.path.join(
                self.show_imgs_dir, f"aug_{self._show_counter:05d}.png"))
        if self.out_dtype == torch.bfloat16:
            return bf16_from_f32(x), y
        return x, y

    # ------------------------------------------------------------------
    def _kickoff(self):
        seed = int(self.rng.integers(0, 2 ** 31))
        w, h = self.w, self.h
        self._pending = self._assembler.submit(self._make_batch, seed, w, h)

    def fast_forward(self, n: int) -> None:
        """Skip the first `n` batches of the seed stream without building
        them — exact data-stream continuation when resuming training from
        a full-state checkpoint (each batch consumes exactly one draw
        from self.rng; construction already spent draw #1 on the
        in-flight batch)."""
        if n <= 0:
            return
        with self._lock:
            # discard the in-flight batch; cancel skips the (expensive)
            # assembly when the assembler hasn't started it yet
            if not self._pending.cancel():
                self._pending.result()
            for _ in range(n - 1):               # discard seeds 2..n
                self.rng.integers(0, 2 ** 31)
            self._kickoff()                      # batch n+1 in flight

    def next(self):
        """Block for the in-flight batch, immediately start the next one
        (the reference's pthread_join + load_data relaunch)."""
        with self._lock:
            batch = self._pending.result()
            self._kickoff()
        return batch

    def close(self):
        self.pool.shutdown(wait=False, cancel_futures=True)
        self._assembler.shutdown(wait=False, cancel_futures=True)
