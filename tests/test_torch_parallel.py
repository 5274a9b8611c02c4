"""The port's data parallelism (`darknet_tpu_torch/parallel`) around the
step on the CPU: the mesh helpers against the JAX package's; the loader's
rank rows; sharded checkpoints; the trainer over two gloo ranks (a
resume equal to the uninterrupted run, a stop signalled to one rank
stopping both); serving and validation over a ["cpu", "cpu"] mesh and
over two processes; the CLI's -num_chips 2.  The step itself is
tests/test_torch_parallel_train.py.

Tolerances.  The loader's rows are the global batch's bit for bit (the
same seeds draw the same samples); a two-rank resume is bitwise the
uninterrupted two-rank run (the same batches, the same sums in the same
order).  Serving over a mesh is bitwise the same network serving each
block alone; against the whole batch served at once it is within 1e-5
relative, the kept sets equal: a conv of a smaller batch may sum in
another order (oneDNN on the CPU, cuDNN on the card choose by batch
size).  Validation over a mesh gives the one-device MapResult exactly,
and the JAX package's with its own mesh (as tests/test_torch_eval.py
holds the unsharded ones): no probability lies within that noise of a
rank or of the threshold on these seeds.
"""

import concurrent.futures as cf
import os
import warnings

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from darknet_tpu.eval import map as jmap
from darknet_tpu.nn.network import Network as JaxNetwork
from darknet_tpu.parallel import mesh as jmesh
from darknet_tpu.parallel import multihost as jmulti
from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.apps import cli
from darknet_tpu_torch.data import synth
from darknet_tpu_torch.data.loader import DetectionLoader
from darknet_tpu_torch.eval import map as tmap
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.parallel import make_mesh, replicate, shard_batch
from darknet_tpu_torch.parallel import mesh as tmesh
from darknet_tpu_torch.parallel import multihost as tmulti
from darknet_tpu_torch.parallel.mesh import Mesh
from darknet_tpu_torch.train import checkpoint as ck
from darknet_tpu_torch.train.trainer import DetectorTrainer
from darknet_tpu_torch.weights import io as wio
from tests.torch_params import lively_params
import torch_parallel_workers as workers

SPAWN_S = 240          # each spawned world's time limit

CFG = """[net]
batch=4
subdivisions=2
width=32
height=32
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
burn_in=0
max_epoch=2
mosaic=1
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky
[shortcut]
from=-2
activation=linear
[convolutional]
filters=27
size=1
activation=linear
[yolo]
mask=0,1,2
num=3
classes=4
anchors=6,6, 10,12, 16,14
"""


# ---------------------------------------------------------------- helpers
@pytest.mark.parametrize("batch,n", [(8, 2), (8, 4), (12, 3), (16, 8)])
def test_process_batch_slice_matches_jax(monkeypatch, batch, n):
    """Every rank's (start, size) equals the JAX package's for the same
    process index, and the blocks tile the batch in rank order."""
    got = []
    for r in range(n):
        monkeypatch.setattr(tmulti.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(tmulti.dist, "get_world_size", lambda: n)
        monkeypatch.setattr(tmulti.dist, "get_rank", lambda r=r: r)
        monkeypatch.setattr(jmulti.jax, "process_count", lambda: n)
        monkeypatch.setattr(jmulti.jax, "process_index", lambda r=r: r)
        got.append(tmulti.process_batch_slice(batch))
        assert got[-1] == jmulti.process_batch_slice(batch)
    assert [s for s, _ in got] == list(range(0, batch, batch // n))
    monkeypatch.undo()
    assert tmulti.process_batch_slice(batch) == (0, batch)


def test_process_batch_slice_refuses_an_uneven_split(monkeypatch):
    monkeypatch.setattr(tmulti.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmulti.dist, "get_world_size", lambda: 3)
    monkeypatch.setattr(tmulti.dist, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match="does not divide"):
        tmulti.process_batch_slice(8)


@pytest.mark.parametrize("batch,n", [(1, 2), (3, 2), (8, 2), (9, 4),
                                     (4, 8), (16, 8)])
def test_round_batch_to_mesh_matches_jax(batch, n):
    assert tmesh.round_batch_to_mesh(batch, n) == \
        jmesh.round_batch_to_mesh(batch, n)


def test_make_mesh_devices_and_refusals():
    m = make_mesh(2, device="cpu")
    assert m.shape == {"dp": 2} and m.axis_names == ("dp",)
    assert m.devices == (torch.device("cpu"),) * 2 and m.group is None
    assert m.rank == 0
    assert make_mesh(devices=["cpu"] * 3).shape == {"dp": 3}
    assert make_mesh(4, axis="x", device="cpu").axis_names == ("x",)
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"this machine has {cards}"):
        make_mesh(cards + 1)
    with pytest.raises(ValueError, match=f"this machine has {cards}"):
        make_mesh(devices=[f"cuda:{cards}"] * 2)
    with pytest.raises(ValueError, match="devices named"):
        make_mesh(3, devices=["cpu", "cpu"])


def test_shard_and_replicate():
    m = make_mesh(2, device="cpu")
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    parts = shard_batch(m, x)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:].tolist()]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(m, x[:3])
    tree = [{"w": torch.ones(2, 3, 4, 5).to(
        memory_format=torch.channels_last)}]
    reps = replicate(m, tree)
    assert len(reps) == 2 and reps[0] is reps[1]
    assert reps[0][0]["w"] is tree[0]["w"]          # already on the device


def test_backend_rule():
    assert tmulti.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert tmulti.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert tmulti.backend_for(["cpu", "cpu"]) == "gloo"
    assert tmulti.backend_for(["cuda:0", "cpu"]) == "gloo"


# ----------------------------------------------------------------- loader
@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    return synth.generate(str(tmp_path_factory.mktemp("syn")), n_train=8,
                          n_val=6, seed=5)


@pytest.mark.parametrize("mixup", [0, 1, 3])
def test_loader_rows_are_the_global_batch(synth_set, mixup):
    """Two ranks' rows (plain, mixup, mosaic), three batches each and a
    fast_forward, concatenate to the global batch bit for bit."""
    kw = dict(w=32, h=32, batch=4, boxes=20, classes=4, mixup=mixup,
              threads=2, seed=11)
    full = DetectionLoader(synth_set["train_paths"], **kw)
    ranks = [DetectionLoader(synth_set["train_paths"], rows=(2 * r, 2),
                             **kw) for r in (0, 1)]
    try:
        for i in range(3):
            if i == 2:
                for ld in [full] + ranks:
                    ld.fast_forward(2)
            x, y = full.next()
            parts = [ld.next() for ld in ranks]
            assert parts[0][0].shape == (2, 32, 32, 3)
            np.testing.assert_array_equal(
                np.concatenate([p[0] for p in parts]), x)
            np.testing.assert_array_equal(
                np.concatenate([p[1] for p in parts]), y)
    finally:
        for ld in [full] + ranks:
            ld.close()
    with pytest.raises(ValueError, match="outside a batch"):
        DetectionLoader(synth_set["train_paths"], rows=(3, 2), **kw)


# ----------------------------------------------------------- checkpoints
def small_state(seed=0):
    rng = np.random.default_rng(seed)
    params = [{"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
               "b": rng.standard_normal(4).astype(np.float32)}, {},
              {"scales": rng.standard_normal(5).astype(np.float32)}]
    opt = {"t": 7, "u": [{k: v * 0.5 for k, v in d.items()}
                         for d in params]}
    extra = {"avg_loss": np.float64(1.25),
             "chart_iters": np.arange(3, dtype=np.int64)}
    return params, opt, 96, np.arange(5, dtype=np.uint8), extra


def assert_state_equal(got, want):
    gp, go, gseen, grng, gextra = got
    wp, wo, wseen, wrng, wextra = want
    for a, b in zip(gp + go["u"], wp + wo["u"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert int(go["t"]) == wo["t"] and gseen == wseen
    np.testing.assert_array_equal(grng, wrng)
    assert sorted(gextra) == sorted(wextra)
    for k in wextra:
        np.testing.assert_array_equal(gextra[k], wextra[k])


def test_sharded_round_trip(tmp_path):
    state = small_state()
    path = tmp_path / "state"
    ck.save_checkpoint_sharded(path, *state[:2], seen=state[2],
                               rng_key=state[3], extra=state[4])
    assert sorted(os.listdir(path)) == [ck.MANIFEST, "rank-00000.npz"]
    assert ck.resolve_sharded_dir(path) == str(path)
    assert_state_equal(ck.load_checkpoint_sharded(path, *state[:2]), state)
    # a second save replaces the first and leaves no sibling behind
    state2 = small_state(1)
    ck.save_checkpoint_sharded(path, *state2[:2], seen=state2[2],
                               rng_key=state2[3], extra=state2[4])
    assert sorted(os.listdir(tmp_path)) == ["state"]
    assert_state_equal(ck.load_checkpoint_sharded(path, *state2[:2]), state2)


@pytest.mark.parametrize("left_at", [".tmp", ".old"])
def test_sharded_crash_window(tmp_path, left_at):
    """A crash in the swap leaves the state at .tmp (the newer, complete)
    or .old: the load finds it and promotes it to the primary name; a
    directory without its manifest (a save cut short) never counts."""
    state = small_state()
    path = str(tmp_path / "state")
    ck.save_checkpoint_sharded(path, *state[:2], seen=state[2],
                               rng_key=state[3], extra=state[4])
    os.rename(path, path + left_at)
    if left_at == ".old":
        os.makedirs(path + ".tmp")                  # a save cut short
        np.savez(os.path.join(path + ".tmp", "rank-00000.npz"), x=1)
    assert ck.resolve_sharded_dir(path) == path + left_at
    assert_state_equal(ck.load_checkpoint_sharded(path, *state[:2]), state)
    assert os.path.isfile(os.path.join(path, ck.MANIFEST))
    assert not os.path.exists(path + left_at)
    assert ck.resolve_sharded_dir(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint_sharded(str(tmp_path / "none"), *state[:2])


def test_sharded_two_ranks(tmp_path):
    """Two ranks write their halves of the entries; each loads the whole
    state back."""
    state = small_state()
    tmulti.spawn(workers.checkpoint_ranks, ["cpu", "cpu"], str(tmp_path),
                 state, timeout_s=SPAWN_S)
    for r in (0, 1):
        z = np.load(tmp_path / f"ck_{r}.npz")
        assert list(z["files"]) == [ck.MANIFEST, "rank-00000.npz",
                                    "rank-00001.npz"]
        assert int(z["seen"]) == state[2]
        np.testing.assert_array_equal(z["rng"], state[3])
        for i, d in enumerate(state[0]):
            for k, v in d.items():
                np.testing.assert_array_equal(z[f"params/{i}/{k}"], v)
        np.testing.assert_array_equal(z["extra/chart_iters"],
                                      state[4]["chart_iters"])
    sizes = [os.path.getsize(tmp_path / "state" / f"rank-0000{r}.npz")
             for r in (0, 1)]
    assert min(sizes) > 300              # both ranks wrote entries


# ------------------------------------------------------------- training
@pytest.fixture(scope="module")
def train_runs(tmp_path_factory, synth_set):
    """Two-rank trainers: A straight for max_epoch (4 iterations, the
    in-training mAP on the mesh at the first and the last); B
    signalled on rank 1 at its second iteration (both stop and save),
    then B resumed to the end; a one-process trainer's loader for the
    global batches."""
    root = tmp_path_factory.mktemp("dp_train")
    cfg = str(root / "m.cfg")
    with open(cfg, "w") as f:
        f.write(CFG)

    def kw(name):
        return dict(cfg=cfg, train_paths=synth_set["train_paths"],
                    classes=4, save_dir=str(root / name), save_name="m",
                    loader_processes=0, loader_threads=2)

    out = {n: root / n for n in ("a", "b1", "b2")}
    for d in out.values():
        os.makedirs(d, exist_ok=True)
    kw_a = dict(kw("a"), calc_map=True, val_paths=synth_set["val_paths"])
    with cf.ThreadPoolExecutor(2) as pool:
        a = pool.submit(tmulti.spawn, workers.train_ranks, ["cpu", "cpu"],
                        str(out["a"]), kw_a, None, timeout_s=SPAWN_S)
        b1 = pool.submit(tmulti.spawn, workers.train_ranks, ["cpu", "cpu"],
                         str(out["b1"]), kw("b"), None, (1, 1),
                         timeout_s=SPAWN_S)
        b1.result()
        kw_b = dict(kw("b"), resume=True)
        tmulti.spawn(workers.train_ranks, ["cpu", "cpu"], str(out["b2"]),
                     kw_b, None, timeout_s=SPAWN_S)
        a.result()
    one = DetectorTrainer(**kw("one"), device="cpu")
    try:
        global_batches = [one.loader.next() for _ in range(4)]
    finally:
        one.close()
    runs = {n: [np.load(out[n] / f"train_{r}.npz") for r in (0, 1)]
            for n in out}
    return root, runs, global_batches


def params_of(z):
    return {k: z[k] for k in z.files if k.startswith("params/")}


def test_trainer_ranks_equal_and_rows_global(train_runs):
    _root, runs, global_batches = train_runs
    z0, z1 = runs["a"]
    assert int(z0["seen"]) == int(z1["seen"]) == 16
    # the in-training mAP rode the mesh: every rank matched the gathered
    # detections
    assert len(z0["maps"]) == 2 and np.array_equal(z0["maps"], z1["maps"])
    assert np.isfinite(z0["maps"]).all()
    for k, v in params_of(z0).items():
        np.testing.assert_array_equal(v, z1[k])
    for i, (x, y) in enumerate(global_batches):
        np.testing.assert_array_equal(
            np.concatenate([z0["x"][i], z1["x"][i]]), np.asarray(x))
        np.testing.assert_array_equal(
            np.concatenate([z0["y"][i], z1["y"][i]]), y)


def test_stop_signal_to_one_rank_stops_both(train_runs):
    root, runs, _g = train_runs
    z0, z1 = runs["b1"]
    # rank 1 was signalled while loading its second batch: both ranks
    # finished that iteration and stopped at the same boundary
    assert int(z0["seen"]) == int(z1["seen"]) == 8
    assert len(z0["x"]) == len(z1["x"]) == 2
    assert os.path.isfile(root / "b" / "m_preempt.weights")
    assert ck.resolve_sharded_dir(root / "b" / "m_last.ckpt") == \
        str(root / "b" / "m_last.ckpt")
    assert sorted(os.listdir(root / "b" / "m_last.ckpt"))[1:] == [
        "rank-00000.npz", "rank-00001.npz"]


def test_two_rank_resume_equals_the_straight_run(train_runs):
    _root, runs, _g = train_runs
    for z, straight in zip(runs["b2"], runs["a"]):
        assert int(z["seen"]) == 16
        np.testing.assert_array_equal(z["x"], straight["x"][2:])
        for k, v in params_of(straight).items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


# ------------------------------------------------------- serving, mAP
@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """yolov3-tiny at 64 px, 4 classes, lively weights: the port's network
    and the JAX package's."""
    root = tmp_path_factory.mktemp("mesh_nets")
    cfg = model_zoo.MODELS["yolov3-tiny"](64, 64, classes=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(cfg)
        path = str(root / "w.weights")
        wio.save_weights(g, lively_params(g), path)
        tnet = Network.from_cfg(cfg, weights=path, device="cpu")
        jnet = JaxNetwork.from_cfg(cfg, weights=path)
    cfg_path = str(root / "m.cfg")
    with open(cfg_path, "w") as f:
        f.write(cfg)
    return tnet, jnet, cfg_path, path


def frames(n=4, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 64, 64, 3)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_serving_equals_unsharded(nets, dtype, n):
    tnet = nets[0]
    x = frames()
    if dtype == "uint8":
        x = (x * 255).astype(np.uint8)
    m = make_mesh(n, device="cpu")
    got = tnet.submit_detect_device(x, thresh=0.1, mesh=m)
    per = x.shape[0] // n
    blocks = [tnet.submit_detect_device(x[i * per:(i + 1) * per],
                                        thresh=0.1) for i in range(n)]
    for a, parts in zip(got, zip(*blocks)):
        assert torch.equal(a, torch.cat(parts))
    want = tnet.submit_detect_device(x, thresh=0.1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    dets = tnet.detect_batch_device(x, thresh=0.1, mesh=m)
    assert sum(map(len, dets)) > 0
    assert [len(i) for i in dets] == \
        [len(i) for i in tnet.detect_batch_device(x, thresh=0.1)]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_host_path_equals_unsharded(nets, n):
    tnet = nets[0]
    x = frames(seed=1)
    m = make_mesh(n, device="cpu")
    got = tnet.detect_batch(x, thresh=0.1, mesh=m)
    per = x.shape[0] // n
    blocks = sum((tnet.detect_batch(x[i * per:(i + 1) * per], thresh=0.1)
                  for i in range(n)), [])
    want = tnet.detect_batch(x, thresh=0.1)
    assert sum(map(len, want)) > 0
    for gi, bi, wi in zip(got, blocks, want):
        assert [(d.bbox, d.objectness) for d in gi] == \
            [(d.bbox, d.objectness) for d in bi]
        assert len(gi) == len(wi)
        for a, b in zip(gi, wi):
            np.testing.assert_allclose(a.bbox, b.bbox, rtol=1e-5)
            np.testing.assert_allclose(a.prob, b.prob, rtol=1e-5, atol=1e-7)


def test_mesh_refusals(nets):
    tnet = nets[0]
    x = frames()
    cpu = (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="'dp' axis"):
        tnet.submit_detect_device(x, mesh=make_mesh(2, axis="x",
                                                    device="cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        tnet.detect_batch(x[:3], mesh=make_mesh(2, device="cpu"))
    # an sp axis over processes is ROADMAP A7c (the sp mesh of one
    # process: tests/test_torch_spatial.py); the refusal comes before the
    # group is used
    with pytest.raises(NotImplementedError, match="A7c"):
        tnet.detect_batch_device(x, mesh=Mesh({"dp": 1, "sp": 2}, cpu[:1],
                                              group=object()))


def test_mesh_validation_equals_unsharded_and_jax(nets, synth_set):
    tnet, jnet = nets[:2]
    paths = synth_set["val_paths"]
    kw = dict(classes=4, batch=4, progress=False, resize="darknet")
    got = tmap.validate_detector(tnet, paths,
                                 mesh=make_mesh(2, device="cpu"), **kw)
    want = tmap.validate_detector(tnet, paths, **kw)
    jgot = jmap.validate_detector(
        jnet, paths, mesh=JaxMesh(np.array(jax.devices()[:2]), ("dp",)),
        **kw)
    assert got.n_pred > 0 and got.n_gt > 0
    for other in (want, jgot):
        for f in ("map", "recall", "precision", "n_pred", "n_gt"):
            assert getattr(got, f) == getattr(other, f), f
        np.testing.assert_array_equal(got.per_class_ap, other.per_class_ap)


def test_validation_over_two_processes(nets, synth_set, tmp_path):
    """Each rank predicts its block of a batch and matches the gathered
    batch: both ranks' MapResult is the one-process result."""
    tnet, _jnet, cfg, weights = nets
    paths = synth_set["val_paths"]
    want = tmap.validate_detector(tnet, paths, classes=4, batch=4,
                                  progress=False, resize="darknet")
    tmulti.spawn(workers.validate_ranks, ["cpu", "cpu"], str(tmp_path), cfg,
                 weights, paths, 4, 4, timeout_s=SPAWN_S)
    for r in (0, 1):
        z = np.load(tmp_path / f"map_{r}.npz")
        assert float(z["map"]) == want.map
        assert int(z["n_pred"]) == want.n_pred and int(z["n_gt"]) == want.n_gt
        np.testing.assert_array_equal(z["ap"], want.per_class_ap)


def test_cli_camera_batch_rides_the_mesh(nets):
    """The multi-camera serving of the CLI (`_submit_frames_batch`) with
    -num_chips 2: the device triple of the mesh, each block's served
    alone; no mesh where the camera batch does not divide."""
    tnet = nets[0]
    cams = [(f * 255).astype(np.uint8) for f in frames(n=4, seed=3)]
    argv = ["-device", "cpu", "-device_nms", "on", "-thresh", "0.1"]
    one = cli.build_parser().parse_args(argv)
    two = cli.build_parser().parse_args(argv + ["-num_chips", "2"])
    kind, got = cli._submit_frames_batch(tnet, cams, two)
    assert kind == "dev" and two._serve_mesh.shape == {"dp": 2}
    blocks = [cli._submit_frames_batch(tnet, cams[i:i + 2], one)[1]
              for i in (0, 2)]
    for a, parts in zip(got, zip(*blocks)):
        assert torch.equal(a, torch.cat(parts))
    assert cli._serving_mesh(two, 3) is None


# -------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory, synth_set, nets):
    root = tmp_path_factory.mktemp("cli_dp")
    data = root / "obj.data"
    with open(synth_set["data"]) as f:
        data.write_text(f.read() + f"save = {root / 'backup'}\n")
    cfg = root / "m.cfg"
    cfg.write_text(CFG)
    return root, str(cfg), str(data)


def test_cli_train_num_chips_2(cli_dir):
    """-mode train -num_chips 2 on the CPU: two gloo ranks for max_epoch
    (4 iterations), one .weights written by rank 0, the sharded state."""
    root, cfg, data = cli_dir
    cli.main(["-mode", "train", "-model_file", cfg, "-data_file", data,
              "-weights_file", "none", "-device", "cpu", "-num_chips", "2",
              "-loader_processes", "0"])
    backup = root / "backup"
    assert os.path.isfile(backup / "m_final.weights")
    _loaded, seen, _v = wio.load_weights(build_graph(CFG, train=True),
                                         str(backup / "m_final.weights"))
    assert seen == 16
    assert ck.resolve_sharded_dir(backup / "m_last.ckpt") is not None


def test_cli_valid_num_chips_2(cli_dir, nets, capsys):
    """-mode valid -num_chips 2: the same report as one device."""
    root, _cfg, data = cli_dir
    _t, _j, cfg, weights = nets
    argv = ["-mode", "valid", "-model_file", cfg, "-data_file", data,
            "-weights_file", weights, "-device", "cpu"]
    cli.main(argv)
    one = capsys.readouterr().out
    cli.main(argv + ["-num_chips", "2"])
    two = capsys.readouterr().out
    # all but the progress line and the timing lines
    keep = lambda out: [ln for ln in out.splitlines() if ln.strip() and
                        "prediction" not in ln.lower() and
                        "Calculating mAP" not in ln]
    assert keep(one) == keep(two) and "mAP@0.5" in two


def _triple(boxes, obj, probs):
    return (torch.tensor([boxes], dtype=torch.float32),
            torch.tensor([obj], dtype=torch.float32),
            torch.tensor([probs], dtype=torch.float32)[..., None])


def _served(pre, nms=0.45):
    from darknet_tpu_torch.ops.nms import nms_numpy

    post = nms_numpy(pre[0][0].numpy(), pre[2][0].numpy(), nms)
    return pre[0], pre[1], torch.from_numpy(post)[None]


@pytest.mark.parametrize("case", ["threshold", "overlap", "far"])
def test_chip_smoke_traces_kept_differences(case):
    """chip_smoke.py phase 15's bf16 check (`flips_explained`) on two
    hand-made requests whose scores differ by 4e-4 and boxes by 0.04 px:
    a candidate one side passes the .25 threshold by less than that
    noise is traced to the threshold; a pair whose overlap is over NMS's
    .45 in one request and not in the other is traced to the overlap,
    and the box the pair's survivor suppresses in one request only to
    the chain; a candidate that passes by far on one side only is left
    unexplained."""
    from tests.torch_params import chip_smoke

    smoke = chip_smoke()
    # slot 0 and slot 2 overlap at IoU 0.44948 in a, 0.45033 in b; slot 3
    # lies on slot 2 (IoU 0.8); slot 1 stands alone
    box_a = [[100, 100, 50, 50], [300, 300, 40, 40],
             [118.99, 100, 50, 50], [121.77, 100, 50, 50]]
    box_b = [[100, 100, 50, 50], [300.04, 300, 40, 40],
             [118.95, 100, 50, 50], [121.77, 100, 50, 50]]
    obj = [0.6, 0.2503, 0.4, 0.3]
    p_a, p_b = [0.6, 0.2503, 0.4, 0.3], [0.6004, 0.2503, 0.4, 0.3]
    if case == "threshold":
        box_a[2] = box_b[2] = [500, 100, 30, 30]
        box_a[3] = box_b[3] = [700, 500, 30, 30]
        p_b[1] = 0.0                # 0.2497 in b: under the threshold
    elif case == "far":
        box_a[2] = box_b[2] = [500, 100, 30, 30]
        box_a[3] = box_b[3] = [700, 500, 30, 30]
        p_b[2] = 0.0                # 0.4 in a, nothing in b
    a_pre, b_pre = _triple(box_a, obj, p_a), _triple(box_b, obj, p_b)
    a, b = _served(a_pre), _served(b_pre)
    args = (0.25, 0.45, "greedynms", 0.6)
    fwd = smoke.flips_explained(a, a_pre, b, b_pre, *args)
    bwd = smoke.flips_explained(b, b_pre, a, a_pre, *args)
    _slot, _held, noise_p, noise_box = smoke.score_noise(a_pre, b_pre)
    assert noise_p == pytest.approx(4e-4, abs=1e-6)
    assert noise_box == pytest.approx(0.04, abs=1e-4)
    want = {"threshold": ({(0, 1, 0): "threshold"}, []),
            "overlap": ({(0, 2, 0): "overlap", (0, 3, 0): "chain"}, []),
            "far": ({}, [(0, 2, 0)])}[case]
    for got in (fwd, bwd):
        assert (got[1], got[2]) == want
