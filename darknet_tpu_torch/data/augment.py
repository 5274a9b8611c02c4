"""Detection-sample augmentation, mirroring `load_data_detection`
(data.cpp:420-676) and `image_data_augmentation` (image_opencv.cpp:378-500):

* random jitter crop: per-side offsets in [-jitter*dim, +jitter*dim], the
  crop canvas filled with the image mean, then resized to (w, h);
* 50% horizontal flip; HSV hue shift (+-hue, in OpenCV's 0..179 hue units),
  saturation/exposure random scale (RandScale: s or 1/s);
* optional gaussian noise and (background-)blur;
* truth transform `CorrectBoxAnnot` (data.cpp:116-164): edge-space affine,
  clamp to [0,1], degenerate boxes dropped; boxes smaller than one net
  pixel dropped (fill_truth_detection:166-270);
* mixup (50/50 blend of two samples, off half the time like the reference's
  `RandGen()%2` gate) and 4-image mosaic with shift-aware truth rebuild
  (blend_truth_mosaic, data.cpp:315-418).

Output truth layout: (max_boxes, 5) [x, y, w, h, id] packed prefix,
zero-terminated — exactly what the loss expects.

The port's copy of `darknet_tpu/data/augment.py`: the OpenCV calls are
the port's own functions (`data/image.py`), so no OpenCV is needed.
"""

from __future__ import annotations

import numpy as np

from darknet_tpu_torch.data import image as imageops


def rand_scale(rng, s: float) -> float:
    """RandScale (utils): uniform in [1, s], inverted with p=0.5."""
    scale = rng.uniform(1.0, s)
    return scale if rng.integers(0, 2) == 0 else 1.0 / scale


def correct_box_annot(annot: np.ndarray, dx, dy, sx, sy, flip) -> np.ndarray:
    """CorrectBoxAnnot: annot rows [id,x,y,w,h] -> transformed rows.

    Returns rows with sentinel 999999 coords for dropped boxes (matching
    the reference's marking; the caller filters)."""
    out = annot.copy()
    for r in out:
        _id, x, y, w, h = r
        if (x == 0 and y == 0) or (x + w / 2) < 0 or (y + h / 2) < 0 or \
                (x - w / 2) > 1 or (y - h / 2) > 1:
            r[1:5] = 999999
            continue
        left = (x - w / 2) * sx - dx
        right = (x + w / 2) * sx - dx
        top = (y - h / 2) * sy - dy
        bottom = (y + h / 2) * sy - dy
        if flip:
            left, right = 1.0 - right, 1.0 - left
        left, right = np.clip(left, 0, 1), np.clip(right, 0, 1)
        top, bottom = np.clip(top, 0, 1), np.clip(bottom, 0, 1)
        r[1] = (left + right) / 2
        r[2] = (top + bottom) / 2
        r[3] = np.clip(right - left, 0, 1)
        r[4] = np.clip(bottom - top, 0, 1)
    return out


def fill_truth_detection(annot: np.ndarray, num_boxes: int, classes: int,
                         flip, dx, dy, sx, sy, net_w: int, net_h: int,
                         rng) -> tuple:
    """fill_truth_detection (data.cpp:166-270): shuffle, transform, filter,
    pack.  Returns (truth (num_boxes,5) [x,y,w,h,id], min_w_h pixels)."""
    truth = np.zeros((num_boxes, 5), np.float32)
    if annot.shape[0]:
        perm = rng.permutation(annot.shape[0])
        annot = annot[perm]
    annot = correct_box_annot(annot, dx, dy, sx, sy, flip)
    lowest_w, lowest_h = 1.0 / net_w, 1.0 / net_h
    min_w_h = 0
    k = 0
    for r in annot[: num_boxes + 64]:
        if k >= num_boxes:
            break
        cid, x, y, w, h = r
        if cid >= classes:
            continue
        if w < lowest_w or h < lowest_h:
            continue
        if x == 999999 or y == 999999:
            continue
        if x <= 0 or x > 1 or y <= 0 or y > 1:
            continue
        w = min(w, 1.0)
        h = min(h, 1.0)
        if x == 0:
            x += lowest_w
        if y == 0:
            y += lowest_h
        truth[k] = [x, y, w, h, cid]
        if min_w_h == 0:
            min_w_h = w * net_w
        min_w_h = min(min_w_h, w * net_w, h * net_h)
        k += 1
    return truth, int(min_w_h)


def image_data_augmentation(img: np.ndarray, w: int, h: int, pleft, ptop,
                            swidth, sheight, flip, dhue, dsat, dexp,
                            gaussian_noise, blur, truth) -> np.ndarray:
    """image_data_augmentation (image_opencv.cpp:378-500) on an HWC float32
    RGB [0,1] image."""
    ih, iw = img.shape[:2]
    if pleft == 0 and ptop == 0 and (swidth, sheight) == (iw, ih):
        sized = imageops.resize_linear(img, w, h)
    else:
        # mean-fill pad + crop (cv::mean accumulates in double)
        mean = img.reshape(-1, img.shape[2]).astype(np.float64).mean(0)
        # src/dst rect intersection
        sx0, sy0 = max(pleft, 0), max(ptop, 0)
        sx1 = min(pleft + swidth, iw)
        sy1 = min(ptop + sheight, ih)
        if sx1 > sx0 and sy1 > sy0:
            dx0, dy0 = max(0, -pleft), max(0, -ptop)
            cropped = imageops.pad_constant(
                img[sy0:sy1, sx0:sx1], dy0, sheight - dy0 - (sy1 - sy0),
                dx0, swidth - dx0 - (sx1 - sx0), mean)
        else:
            cropped = np.empty((sheight, swidth, img.shape[2]), img.dtype)
            cropped[:] = np.asarray(mean, img.dtype)
        sized = imageops.resize_linear(cropped, w, h)

    if flip:
        sized = imageops.flip_horizontal(sized)

    if dsat != 1 or dexp != 1 or dhue != 0:
        if sized.shape[2] >= 3:
            hsv = imageops.rgb_to_hsv(sized)
            hsv[..., 1] *= dsat
            hsv[..., 2] *= dexp
            # the reference shifts 8-bit hue (0..179) by 179*dhue — a
            # full-scale fraction of dhue; OpenCV's float path uses 0..360,
            # so the equivalent shift is 360*dhue
            hsv[..., 0] += 360.0 * dhue
            sized = imageops.hsv_to_rgb(hsv)
        else:
            sized = sized * dexp

    if gaussian_noise:
        noise = np.random.normal(0, gaussian_noise / 255.0, sized.shape)
        sized = np.clip(sized + noise.astype(np.float32), 0, 1)

    if blur:
        k = 17 if blur == 1 else (int(blur) // 2) * 2 + 1
        dst = imageops.gaussian_blur(sized, k)
        if blur == 1 and truth is not None:
            # background-only blur: restore truth ROIs (image_opencv.cpp:480+)
            for t in truth:
                if not t[0]:
                    break
                x, y, bw, bh = t[0], t[1], t[2], t[3]
                left = int((x - bw / 2) * w)
                top = int((y - bh / 2) * h)
                right = left + int(bw * w)
                bot = top + int(bh * h)
                left, top = max(left, 0), max(top, 0)
                right, bot = min(right, w), min(bot, h)
                if right > left and bot > top:
                    dst[top:bot, left:right] = sized[top:bot, left:right]
        sized = dst

    return np.ascontiguousarray(sized, dtype=np.float32)


def blend_truth(new_truth: np.ndarray, old_truth: np.ndarray) -> None:
    """Mixup truth union (data.cpp:287-313), in place on new_truth."""
    boxes = new_truth.shape[0]
    n_new = 0
    while n_new < boxes and new_truth[n_new, 0]:
        n_new += 1
    for t in range(n_new, boxes):
        src = old_truth[t - n_new]
        if not src[0]:
            break
        new_truth[t] = src


def blend_truth_mosaic(new_truth, old_truth, w, h, cut_x, cut_y, i_quad,
                       left_shift, right_shift, top_shift, bot_shift):
    """blend_truth_mosaic (data.cpp:315-418), in place on new_truth."""
    boxes = new_truth.shape[0]
    n_new = 0
    while n_new < boxes and new_truth[n_new, 0]:
        n_new += 1
    new_t = n_new
    for t in range(n_new, boxes):
        if new_t >= boxes:
            break
        new_truth[new_t, 0] = 0
        src = old_truth[t - n_new]
        if not src[0]:
            break
        xb, yb, wb, hb = float(src[0]), float(src[1]), float(src[2]), \
            float(src[3])
        if i_quad == 0:
            xb -= (w - cut_x - right_shift) / w
            yb -= (h - cut_y - bot_shift) / h
        elif i_quad == 1:
            xb += (cut_x - left_shift) / w
            yb -= (h - cut_y - bot_shift) / h
        elif i_quad == 2:
            xb -= (w - cut_x - right_shift) / w
            yb += (cut_y - top_shift) / h
        else:
            xb += (cut_x - left_shift) / w
            yb += (cut_y - top_shift) / h

        left = int((xb - wb / 2) * w)
        right = int((xb + wb / 2) * w)
        top = int((yb - hb / 2) * h)
        bot = int((yb + hb / 2) * h)
        if left < 0:
            diff = left / w
            xb -= diff / 2
            wb += diff
        if right > w:
            diff = (right - w) / w
            xb -= diff / 2
            wb -= diff
        if top < 0:
            diff = top / h
            yb -= diff / 2
            hb += diff
        if bot > h:
            diff = (bot - h) / h
            yb -= diff / 2
            hb -= diff
        left = int((xb - wb / 2) * w)
        right = int((xb + wb / 2) * w)
        top = int((yb - hb / 2) * h)
        bot = int((yb + hb / 2) * h)
        if (0 <= left and right <= w and 0 <= top and bot <= h and
                0 < wb < 1 and 0 < hb < 1 and 0 < xb < 1 and 0 < yb < 1):
            new_truth[new_t, :4] = [xb, yb, wb, hb]
            new_truth[new_t, 4] = src[4]
            new_t += 1


def save_augmented_sample(img, truth, path) -> None:
    """-show_imgs (data.cpp:631-666; `darknet_tpu/data/augment.py:250-263`):
    the augmented image with its transformed truth boxes drawn, for
    augmentation debugging.  The boxes are `apps/raster.rectangle`'s (the
    reference's colour and thickness), and the file is a PNG
    (`data/image.write_png`) where the JAX package writes a JPEG."""
    from darknet_tpu_torch.apps.raster import rectangle

    out = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w = out.shape[:2]
    for t in truth:
        if not t[0]:
            break
        x, y, bw, bh = t[0], t[1], t[2], t[3]
        p1 = (int((x - bw / 2) * w), int((y - bh / 2) * h))
        p2 = (int((x + bw / 2) * w), int((y + bh / 2) * h))
        rectangle(out, p1, p2, (150, 100, 50), 1)
    imageops.write_png(path, out)


def load_detection_sample(path, w, h, boxes, classes, *, jitter=0.3,
                          hue=0.1, saturation=1.5, exposure=1.5,
                          use_flip=True, use_blur=0, use_gaussian_noise=0,
                          rng=None):
    """One augmented (image, truth) sample (no mosaic/mixup — the caller's
    batch assembler composes those, mirroring the i_mixup loop)."""
    from darknet_tpu_torch.data.image import load_image_rgb
    from darknet_tpu_torch.data.labels import (image_to_label_path,
                                               read_box_annot)

    rng = rng or np.random.default_rng()
    img = load_image_rgb(path)
    oh, ow = img.shape[:2]
    dw, dh_ = int(ow * jitter), int(oh * jitter)

    pleft = int(rng.uniform(-dw, dw))
    pright = int(rng.uniform(-dw, dw))
    ptop = int(rng.uniform(-dh_, dh_))
    pbot = int(rng.uniform(-dh_, dh_))
    flip = bool(rng.integers(0, 2)) if use_flip else False

    dhue = rng.uniform(-hue, hue)
    dsat = rand_scale(rng, saturation)
    dexp = rand_scale(rng, exposure)

    blur = 0
    if use_blur:
        tmp = rng.integers(0, 3)
        blur = 0 if tmp == 0 else (1 if tmp == 1 else use_blur)
    noise = use_gaussian_noise if (use_gaussian_noise and
                                   rng.integers(0, 2)) else 0

    swidth = ow - pleft - pright
    sheight = oh - ptop - pbot
    sx, sy = swidth / ow, sheight / oh
    ddx = (pleft / ow) / sx
    ddy = (ptop / oh) / sy

    annot = read_box_annot(image_to_label_path(path))
    truth, min_w_h = fill_truth_detection(
        annot, boxes, classes, flip, ddx, ddy, 1.0 / sx, 1.0 / sy, w, h, rng)
    if blur > 1 and (min_w_h / 8) < blur:
        blur = min_w_h // 8

    img_aug = image_data_augmentation(
        img, w, h, pleft, ptop, swidth, sheight, flip, dhue, dsat, dexp,
        noise, blur, truth)
    return img_aug, truth, dict(pleft=pleft, pright=pright, ptop=ptop,
                                pbot=pbot, flip=flip, ow=ow, oh=oh)
