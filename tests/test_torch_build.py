"""The CUDA builder (`darknet_tpu_torch/ops/cuda/build.py`) on the CPU,
with a stand-in for nvcc: one process per source, started together,
named by the source's hash, and a failed build raises and stops the
others."""

import os
import stat
import sys
import time

import pytest

from darknet_tpu_torch.ops.cuda import build

FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
src, out = args[-1], args[args.index("-o") + 1]
if "bad" in src:
    sys.stderr.write("error: bad source\\n")
    sys.exit(2)
time.sleep(float(open(src).read() or 0))
open(out, "w").write("built " + src)
sys.stderr.write("ptxas info    : Used 1 registers\\n")
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "build_log", {})
    return csrc


def test_build_runs_nvcc_per_source_in_parallel(fake_tree):
    for name in ("k1", "k2", "k3"):
        (fake_tree / f"{name}.cu").write_text("2.0")
    t0 = time.perf_counter()
    build.build(["k1", "k2", "k3"])
    assert time.perf_counter() - t0 < 5.0          # not 3 x 2 s in a row
    for name in ("k1", "k2", "k3"):
        so = build._paths(name)[1]
        assert os.path.exists(so)
        assert "Used 1 registers" in build.build_log[name]["ptxas"]
    build.build_log.clear()
    build.build(["k1"])                             # built: nothing to do
    assert build.build_log == {}
    (fake_tree / "k1.cu").write_text("0.0")         # edited: a new library
    build.build(["k1"])
    assert build.build_log["k1"]["so"] == build._paths("k1")[1]


def test_failed_build_raises_and_stops_the_others(fake_tree):
    (fake_tree / "bad.cu").write_text("")
    (fake_tree / "slow.cu").write_text("30")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="bad source"):
        build.build(["bad", "slow"])
    assert time.perf_counter() - t0 < 20
    assert not os.path.exists(build._paths("slow")[1])
