"""The training batch's upload and the -show_imgs samples of
darknet_tpu_torch, against torch and darknet_tpu on the CPU:

* `data/loader.bf16_from_f32`: bit-equal to torch's own cast on every
  float32 that is not a NaN (random bit patterns, halfway ties, the
  largest finite values, infinities, zeros and subnormals); a NaN becomes
  0x7FC0, c10's scalar rule (the card's cast gives it; torch's CPU vector
  path gives 0xFFFF for some payloads);
* the loader's bf16 batch equals its f32 batch cast by torch, bitwise;
* the trainer's batch dtype is the JAX trainer's (`_loader_out_dtype`):
  bf16 for a bf16 step of a graph that opens with a conv, f32 otherwise
  and for a graph that opens with [crop]; the bytes it uploads halve;
* a bf16 training step from the bf16 batch equals the same step from the
  f32 batch, bitwise (the first conv casts its input first);
* `train/trainer.PinnedUploader` on the CPU passes the batch through;
* `data/augment.save_augmented_sample`: the PNG's pixels equal the JAX
  package's array before its `cv2.imwrite` (which takes BGR), exactly;
* the loader's and the trainer's show_imgs: the first N samples of each
  batch as `aug_%05d.png`, the JAX package's names with .png for .jpg.
"""

import os

import numpy as np
import pytest
import torch

from darknet_tpu.data import augment as jaugment
from darknet_tpu.data.loader import DetectionLoader as JLoader
from darknet_tpu_torch.data import augment, image, synth
from darknet_tpu_torch.data.loader import DetectionLoader, bf16_from_f32
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
from darknet_tpu_torch.train.trainer import DetectorTrainer, PinnedUploader
from tests.test_torch_train_loop import CFG
from tests.test_torch_train_step import CS

torch.set_num_threads(2)


def _bits(t):
    return t.view(torch.int16).numpy()


def test_bf16_bits_equal_torch_cast():
    rng = np.random.default_rng(0)
    patterns = rng.integers(0, 2 ** 32, 400_000, dtype=np.uint64).astype(
        np.uint32)
    ties = (rng.integers(0, 2 ** 16, 1000, dtype=np.uint32) << 16) | 0x8000
    special = np.array([0, 0x80000000, 1, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                        0x7F7F8000, 0x7F800000, 0xFF800000, 0x3F808000,
                        0x3F818000], np.uint32)
    x = np.concatenate([patterns, ties, special]).view(np.float32)
    finite = x[~np.isnan(x)]
    np.testing.assert_array_equal(
        _bits(bf16_from_f32(finite)),
        _bits(torch.from_numpy(finite).to(torch.bfloat16)))
    nan = x[np.isnan(x)]
    assert nan.size > 1000
    assert (_bits(bf16_from_f32(nan)) == 0x7FC0).all()
    img = rng.uniform(0, 1, (2, 8, 6, 3)).astype(np.float32)
    got = bf16_from_f32(img)
    assert got.dtype == torch.bfloat16 and got.shape == img.shape
    assert torch.equal(got, torch.from_numpy(img).to(torch.bfloat16))


@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("upload")
    return root, synth.generate(str(root / "data"), n_train=8, n_val=2,
                                seed=6)


LOADER = dict(w=64, h=64, batch=4, boxes=20, classes=4, jitter=0.3,
              hue=0.1, saturation=1.5, exposure=1.5, flip=True, mixup=3,
              threads=2, seed=3)


def test_loader_bf16_batch_is_the_cast_f32_batch(synth_set):
    _root, files = synth_set
    a = DetectionLoader(files["train_paths"], **LOADER)
    b = DetectionLoader(files["train_paths"], out_dtype=torch.bfloat16,
                        **LOADER)
    try:
        for _ in range(2):
            (xa, ya), (xb, yb) = a.next(), b.next()
            assert isinstance(xa, np.ndarray) and xb.dtype == torch.bfloat16
            assert torch.equal(xb, torch.from_numpy(xa).to(torch.bfloat16))
            np.testing.assert_array_equal(ya, yb)
    finally:
        a.close()
        b.close()
    with pytest.raises(ValueError, match="out_dtype"):
        DetectionLoader(files["train_paths"], out_dtype=torch.float16,
                        **LOADER)


@pytest.mark.parametrize("cfg,dtype,want", [
    ("conv", torch.bfloat16, torch.bfloat16), ("conv", None, None),
    ("crop", torch.bfloat16, None)])
def test_trainer_batch_dtype(synth_set, cfg, dtype, want):
    root, files = synth_set
    text = CFG.format(random=0) if cfg == "conv" else CS.RARE_COST_CFG
    tr = DetectorTrainer(text, files["train_paths"], classes=4,
                         device="cpu", compute_dtype=dtype,
                         loader_processes=0, save_dir=str(root / cfg),
                         log=lambda *a: None)
    try:
        assert tr.graph.layers[0].kind == ("convolutional" if cfg == "conv"
                                           else "crop")
        assert tr.loader.out_dtype == want
    finally:
        tr.close()


def test_trainer_uploads_half_the_bytes_in_bf16(synth_set):
    """One iteration each: the bf16 run's image bytes are half the f32
    run's; the truths go up as f32 in both."""
    root, files = synth_set
    sent = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        tr = DetectorTrainer(CFG.format(random=0), files["train_paths"],
                             classes=4, device="cpu", compute_dtype=dtype,
                             loader_processes=0,
                             save_dir=str(root / f"bytes_{name}"),
                             log=lambda *a: None)
        try:
            tr.train(max_iters=1)
            sent[name] = (tr._upload_x.bytes, tr._upload_y.bytes)
        finally:
            tr.close()
    assert sent["f32"][0] == 4 * 64 * 64 * 3 * 4
    assert sent["bf16"][0] * 2 == sent["f32"][0]
    assert sent["bf16"][1] == sent["f32"][1] > 0


def test_bf16_step_from_bf16_batch_is_bitwise(synth_set):
    """The same bf16 step (act16, two micro-batches) from the f32 batch
    and from its bf16 cast: equal params, momentum and cost, bitwise."""
    _root, files = synth_set
    loader = DetectionLoader(files["train_paths"], **LOADER)
    try:
        x, y = loader.next()
    finally:
        loader.close()
    g = build_graph(CFG.format(random=0), train=True)
    p0 = tparams.init_params(g, seed=0)
    out = []
    for batch in (torch.from_numpy(x), bf16_from_f32(x)):
        params = tparams.train_params_to_torch(g, p0, "cpu")
        opt = init_opt_state(g, params)
        step = make_train_step(g, compute_dtype=torch.bfloat16, accum=2,
                               train_act_dtype=torch.bfloat16)
        params, opt, cost, _m = step(params, opt, batch,
                                     torch.from_numpy(y), 1e-3)
        out.append((tparams.train_params_to_numpy(g, params),
                    tparams.train_params_to_numpy(g, opt["u"]),
                    float(cost)))
    (pa, ua, ca), (pb, ub, cb) = out
    assert ca == cb
    for a, b in zip(pa + ua, pb + ub):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_pinned_uploader_on_the_cpu():
    up = PinnedUploader("cpu")
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t = up(x)
    assert t.device.type == "cpu" and not t.is_pinned()
    np.testing.assert_array_equal(t.numpy(), x)
    assert up.bytes == x.nbytes
    b = bf16_from_f32(x)
    assert torch.equal(up(b), b) and up.bytes == x.nbytes + b.numel() * 2


def _capture_jax_sample(monkeypatch, img, truth):
    written = {}

    def imwrite(path, arr):
        written[path] = np.array(arr)
        return True
    monkeypatch.setattr(jaugment.cv2, "imwrite", imwrite)
    jaugment.save_augmented_sample(img, truth, "aug.jpg")
    return written["aug.jpg"]


def test_save_augmented_sample_as_jax(tmp_path, monkeypatch):
    """Boxes inside, on and across the image's edges, and the zero row
    that ends the list."""
    rng = np.random.default_rng(11)
    img = rng.uniform(-0.1, 1.1, (48, 64, 3)).astype(np.float32)
    truth = np.zeros((6, 5), np.float32)
    truth[:4, :4] = [[0.5, 0.5, 0.3, 0.4], [0.1, 0.1, 0.25, 0.3],
                     [0.95, 0.9, 0.2, 0.3], [0.3, 0.7, 1.0, 0.2]]
    truth[5] = [0.5, 0.5, 0.2, 0.2, 0]        # after the zero row: unused
    want = _capture_jax_sample(monkeypatch, img, truth)[..., ::-1]
    path = tmp_path / "aug.png"
    augment.save_augmented_sample(img, truth, str(path))
    got = image.read_png(str(path))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_show_imgs_writes_the_first_samples(synth_set, tmp_path,
                                            monkeypatch):
    """The loader writes the first 3 samples of every batch; each equals
    the JAX package's drawing of that sample (same seeds, same batches:
    tests/test_torch_train_data.py holds the batches)."""
    _root, files = synth_set
    out = tmp_path / "shown"
    kw = dict(LOADER, mixup=0)
    loader = DetectionLoader(files["train_paths"], show_imgs=3,
                             show_imgs_dir=str(out), **kw)
    try:
        batches = [loader.next() for _ in range(2)]
    finally:
        loader.close()
    names = sorted(os.listdir(out))
    assert names[:6] == [f"aug_{i:05d}.png" for i in range(1, 7)]
    for j, (x, y) in enumerate(batches):
        for i in range(3):
            want = _capture_jax_sample(monkeypatch, x[i], y[i])[..., ::-1]
            got = image.read_png(str(out / f"aug_{3 * j + i + 1:05d}.png"))
            np.testing.assert_array_equal(got, want)
    jl = JLoader(files["train_paths"], **kw)
    try:
        np.testing.assert_allclose(jl.next()[0][:3], batches[0][0][:3],
                                   atol=1e-5)
    finally:
        jl.close()


def test_trainer_show_imgs(synth_set):
    root, files = synth_set
    save = root / "shown_trainer"
    tr = DetectorTrainer(CFG.format(random=0), files["train_paths"],
                         classes=4, device="cpu", loader_processes=0,
                         show_imgs=3, save_dir=str(save),
                         log=lambda *a: None)
    try:
        tr.train(max_iters=1)
    finally:
        tr.close()
    shown = sorted(n for n in os.listdir(save) if n.startswith("aug_"))
    # the batch trained and the one the loader built ahead of it
    assert shown[:3] == ["aug_00001.png", "aug_00002.png", "aug_00003.png"]
    assert len(shown) % 3 == 0 and image.read_png(
        str(save / shown[0])).shape == (64, 64, 3)
