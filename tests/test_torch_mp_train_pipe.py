"""Model-parallel training over processes, the pipelines: `PipelineTrain`
over 2, 3 and 4 stages a rank each (the 3-stage ones the antialiased
random cfg whose cut ROADMAP C5 repaired, and a dropout cfg stepped with
a generator), one world of 4 gloo ranks on the CPU.  The cases, their
batches and their tolerances are those of tests/test_torch_mp_train.py's
module docstring."""

import warnings

import numpy as np
import pytest
import torch

from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
from test_torch_mp_train import (GEN, PIPE, _unflat, check_jax,
                                 check_one_process, run_world)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory, PIPE + GEN)


@pytest.mark.parametrize("name", PIPE + GEN)
def test_equals_one_process_mesh(world, name):
    check_one_process(world, name)


@pytest.mark.parametrize("name", PIPE)
def test_matches_jax(world, name):
    check_jax(world, name)


@pytest.mark.parametrize("name", GEN)
def test_draws_the_unsharded_masks(world, name):
    """Every rank's step bitwise the port's unsharded step given the same
    generator seed (taken in the rank, with its threads), the generator
    left in that step's state; another seed moves the params (the masks
    are drawn)."""
    cases, res = world
    c = cases[name]
    for r, d in res[name].items():
        got = _unflat(d, "got", c["p0"])
        want = _unflat(d, "unsharded", c["p0"])
        for a, w in zip(got, want):
            for k in w:
                assert np.array_equal(a[k], w[k]), (r, k)
        assert float(d["cost"]) == float(d["ucost"])
        assert np.array_equal(d["gstate"], d["ugstate"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(c["cfg"], train=True)
    steps = []
    for seed in (c["gen"], c["gen"] + 1):
        p = tparams.train_params_to_torch(g, c["p0"], "cpu")
        p, _o, _c, _m = make_train_step(g, accum=c["accum"])(
            p, init_opt_state(g, p), torch.from_numpy(c["x"]),
            torch.from_numpy(c["y"]), 1e-3, torch.Generator().manual_seed(
                seed))
        steps.append(tparams.train_params_to_numpy(g, p))
    gap = max(float(np.abs(a[k] - b[k]).max())
              for a, b in zip(*steps) for k in b)
    assert gap > 1e-3, gap
