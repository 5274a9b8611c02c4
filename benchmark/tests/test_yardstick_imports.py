"""What the harness loads: no module whose top-level name is jax,
jaxlib, flax or darknet_tpu (compared whole: the port's name begins with
the JAX package's), and nothing of the program in the reference."""

from __future__ import annotations

import glob
import os
import subprocess
import sys

from conftest import REPO

PROBE = r"""
import glob, os, sys
sys.path.insert(0, {repo!r})
from benchmark import harness, run, control, sets
from benchmark.reference import compare, darknet, postprocess
for kind in ("modes", "metrics"):
    for path in sorted(glob.glob(os.path.join({repo!r}, "benchmark", kind,
                                              "*.py"))):
        name = os.path.basename(path)[:-3]
        harness.load_module(path, "probe_" + name.replace(".", "_"))
ref = {{m.split(".")[0] for m in sys.modules}}
print(sorted(ref & {{"jax", "jaxlib", "flax", "darknet_tpu",
                     "darknet_tpu_torch"}}))
"""


def test_harness_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", PROBE.format(repo=REPO)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    # the modes import the program inside run(), not when loaded
    assert p.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(REPO, "benchmark", "reference",
                                       "*.py")):
        with open(path) as f:
            text = f.read()
        assert "darknet_tpu" not in text, path
        assert "import jax" not in text and "from jax" not in text, path
    code = (f"import sys; sys.path.insert(0, {REPO!r}); "
            "import benchmark.reference.darknet, "
            "benchmark.reference.postprocess, benchmark.reference.compare; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('darknet_tpu') "
            "or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_run_refuses_forbidden_modules(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "darknet_tpu_torch_extra", object())
    assert "darknet_tpu" not in harness.forbidden_modules()
