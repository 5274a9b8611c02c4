"""The port's CLI (`darknet_tpu_torch/apps/cli.py`) against the JAX
package's on the CPU: `-mode train` for 2 iterations writes its weights;
`-mode valid` of both CLIs on the same synth set, cfg (yolov4 at 64 px,
4 classes) and `.weights` prints the same report, exactly (prediction
count, GT count, recall, precision, per-class AP, mAP and the COCO sweep;
only the timing lines differ: the detections are the same, as in
tests/test_torch_eval.py); int8 validation with a calibration cache;
`-mode bench` (its JSON line); `-benchmark_layers` 1 and 2 in front of
`-mode valid` (the per-layer table, then the same report as without);
`-dbg_sync` 1 and 2 (the same report as without, and at 2 a NaN planted
in a conv's weights stops the run at that layer); `-show_imgs` in
`-mode train` (three samples a batch); and the refusals: a -num_chips
mesh of cards the machine does not have raises before any work and
writes nothing, in the streaming modes too (-num_chips itself runs:
tests/test_torch_parallel.py), and without a card `-device cpu` is
required.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from darknet_tpu.apps import cli as jcli
from darknet_tpu_torch import model_zoo
from darknet_tpu_torch.apps import cli
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.weights import io as wio
from tests.test_torch_train_loop import CFG
from tests.torch_params import lively_params

torch.set_num_threads(2)
TIMING = ("Total prediction time", "Prediction per second")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A synth set (8 training, 10 validation images), a 64 px cfg that
    trains for one epoch of 2 iterations, and its .data file."""
    root = tmp_path_factory.mktemp("cli")
    files = synth.generate(str(root / "data"), n_train=8, n_val=10, seed=4)
    cfg = root / "m.cfg"
    cfg.write_text(CFG.format(random=0).replace("burn_in=0",
                                                "burn_in=0\nmax_epoch=1"))
    data = root / "obj.data"
    with open(files["data"]) as f:
        data.write_text(f.read() + f"save = {root / 'backup'}\n")
    return root, str(cfg), str(data)


def zoo_model(root, name):
    """A 4-class zoo cfg at 64 px and lively .weights for it (yolov4: the
    weights of tests/test_torch_eval.py's exact validation parity)."""
    cfg = model_zoo.MODELS[name](64, 64, classes=4)
    path = root / f"{name}.cfg"
    path.write_text(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(cfg)
    weights = root / f"{name}.weights"
    wio.save_weights(g, lively_params(g), str(weights))
    return str(path), str(weights)


def args(mode, cfg, data, weights, *extra):
    return ["-mode", mode, "-model_file", cfg, "-data_file", data,
            "-weights_file", weights, *extra]


def report(out):
    return [line for line in out.splitlines()
            if line.strip() and not line.strip().startswith(TIMING)]


def test_train_writes_weights(run_dir, capsys):
    root, cfg, data = run_dir
    cli.main(args("train", cfg, data, "none", "-device", "cpu",
                  "-loader_processes", "0"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(CFG.format(random=0))
    _params, seen, _v = wio.load_weights(
        g, str(root / "backup" / "m_final.weights"))
    assert seen == 8                       # 2 iterations of 4 images
    assert "mAP@0.5" in capsys.readouterr().out     # -calc_map's default


def test_valid_matches_jax(run_dir, capsys, monkeypatch):
    root, _cfg, data = run_dir
    cfg, weights = zoo_model(root, "yolov4")
    # the JAX CLI would turn on a compile cache under HOME
    monkeypatch.setattr("darknet_tpu.utils.cache.enable_persistent_cache",
                        lambda *a, **k: None)
    out = {}
    for name, main, extra in (("port", cli.main, ["-device", "cpu"]),
                              ("jax", jcli.main, [])):
        main(args("valid", cfg, data, weights, "-coco_map", *extra))
        out[name] = capsys.readouterr().out
    assert report(out["port"]) == report(out["jax"])
    assert any(line.startswith(" mAP@0.5") for line in report(out["port"]))
    assert any("AP@[.5:.95]" in line for line in report(out["port"]))
    n_pred = [int(line.split(":")[1]) for line in report(out["port"])
              if line.startswith(" # of pred:")]
    assert n_pred[0] > 0


def test_valid_int8_calibration_cache(run_dir, capsys):
    root, _cfg, data = run_dir
    calib = root / "scales.npz"
    cfg, weights = zoo_model(root, "yolov3-tiny")
    cli.main(args("valid", cfg, data, weights, "-device", "cpu",
                  "-int8", "-int8_calib", "2", "-calib_file", str(calib)))
    assert calib.exists()
    cli.main(args("valid", cfg, data, weights, "-device", "cpu",
                  "-int8", "-calib_file", str(calib)))
    outs = capsys.readouterr().out.split("mAP@0.5")
    assert len(outs) == 3


@pytest.mark.parametrize("extra", [
    ["-mode", "video", "-num_chips", "2"], ["-num_chips", "2"]])
def test_unported_refused(run_dir, tmp_path, extra, monkeypatch):
    """A mesh of more cards than the machine has (two on a machine of
    one) is refused before any work, nothing written, never wrapped
    around."""
    _root, cfg, data = run_dir
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = args("valid", cfg, data, "none", "-device", "cuda")
    argv = [a for a in argv if a not in ("-mode", "valid")] + extra
    if "-mode" not in extra:
        argv += ["-mode", "valid"]
    before = sorted(os.listdir(_root))
    with pytest.raises(ValueError, match="this machine has"):
        cli.main(argv)
    assert sorted(os.listdir(_root)) == before


def test_bench_mode(capsys):
    """-mode bench with the bench's own arguments after the CLI's: one
    JSON line with bench.py's keys (no vs_baseline), the host named."""
    cli.main(["-mode", "bench", "-device", "cpu", "2", "--size", "64",
              "--no-train", "--headline-only"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit",
                         "p50_latency_ms_batch1_sync", "batch1_ms_amortized",
                         "batch", "card", "launches_per_request"}
    assert line["batch"] == 2 and line["card"] == "cpu"
    assert line["value"] > 0 and "int8" in line["metric"]
    with pytest.raises(SystemExit):
        cli.main(["-mode", "valid", "-device", "cpu", "2"])


@pytest.fixture(scope="module")
def yolo_model(run_dir):
    """(cfg, .data, .weights) of yolov4-64 on the synth set."""
    root, _cfg, data = run_dir
    cfg, weights = zoo_model(root, "yolov4")
    return cfg, data, weights


def _valid(cfg, data, weights, capsys, *extra):
    cli.main(args("valid", cfg, data, weights, "-device", "cpu", *extra))
    return capsys.readouterr().out


@pytest.mark.parametrize("level", [1, 2])
def test_benchmark_layers_then_valid(yolo_model, capsys, level):
    """The per-layer table (the region's row, every conv outside it, the
    host TOTAL), at 2 the prefix marginals, then the report of the run
    without the flag."""
    cfg, data, weights = yolo_model
    plain = report(_valid(cfg, data, weights, capsys))
    out = _valid(cfg, data, weights, capsys, "-benchmark_layers",
                 str(level))
    lines = out.splitlines()
    table = lines[lines.index(next(ln for ln in lines
                                   if ln.startswith("layer "))):]
    rows = {ln.split()[0] for ln in table[1:]
            if ln.startswith(("L", "(other)"))}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(open(cfg).read())
    convs = {f"L{l.index:03d}_convolutional" for l in g.layers
             if l.kind == "convolutional" and l.index > 23}
    assert "L000-023_region" in rows and convs <= rows
    assert any(ln.startswith("TOTAL (host)") for ln in table)
    assert any("ms marginal" in ln for ln in lines) == (level >= 2)
    tail = [ln for ln in report(out) if not ln.startswith(
        ("layer", "L", "(other)", "TOTAL"))]
    assert tail[-len(plain):] == plain


@pytest.mark.parametrize("level", [1, 2])
def test_dbg_sync_same_report(yolo_model, capsys, level):
    cfg, data, weights = yolo_model
    plain = report(_valid(cfg, data, weights, capsys))
    assert report(_valid(cfg, data, weights, capsys, "-dbg_sync",
                         str(level))) == plain


def test_dbg_sync_2_stops_at_a_nan(run_dir, yolo_model, capsys):
    """A NaN planted in the weights of layer 25 (a conv after the region):
    -dbg_sync 2 raises at that layer before any detection; -dbg_sync 1
    runs through."""
    root = run_dir[0]
    cfg, data, weights = yolo_model
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(open(cfg).read())
    assert g.layers[25].kind == "convolutional"
    params = wio.load_weights(g, weights)[0]
    params[25]["w"] = params[25]["w"].copy()
    params[25]["w"][0, 0, 0, 0] = np.nan
    path = str(root / "nan.weights")
    wio.save_weights(g, params, path)
    with pytest.raises(FloatingPointError, match="L025_convolutional"):
        _valid(cfg, data, path, capsys, "-dbg_sync", "2")
    assert "mAP@0.5" in _valid(cfg, data, path, capsys, "-dbg_sync", "1")


def test_show_imgs_in_train(run_dir, tmp_path):
    """-show_imgs: three augmented samples a batch in the backup dir."""
    root, cfg, data = run_dir
    backup = tmp_path / "backup"
    data2 = tmp_path / "obj.data"
    data2.write_text(open(data).read().replace(str(root / "backup"),
                                               str(backup)))
    cli.main(args("train", cfg, str(data2), "none", "-device", "cpu",
                  "-loader_processes", "0", "-show_imgs", "-no_calc_map"))
    shown = sorted(n for n in os.listdir(backup) if n.startswith("aug_"))
    assert shown[:6] == [f"aug_{i:05d}.png" for i in range(1, 7)]
    assert len(shown) % 3 == 0


def test_valid_needs_a_card_or_cpu(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    _root, cfg, data = run_dir
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(args("valid", cfg, data, "none"))
