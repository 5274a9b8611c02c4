"""The port's `dryrun_multichip` twin (`darknet_tpu_torch/dryrun.py`) on
the CPU named 8 and 2 times: the (dp, sp, tp) = (2, 2, 2) step and the
(dp, sp) = (2, 1) step each give the cost of the port's unsharded
accum=2 step on the same batch within rtol 1e-5 (the sharded steps sum
their statistics and gradients in another order; the cost is that of
the forward before any update), and the 2-stage pipeline's cost equals
the unsharded step's on its own batch, bitwise.  The mesh rule is the
JAX package's (`__graft_entry__.py:131-140`)."""

import numpy as np
import pytest
import torch

from darknet_tpu_torch import dryrun
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.train.step import init_opt_state, make_train_step

torch.set_num_threads(2)


def _unsharded_cost(batch, seed):
    g = dryrun.dryrun_graph(batch)
    p = tparams.train_params_to_torch(g, tparams.init_params(g, seed=0),
                                      "cpu")
    x, y = dryrun.dryrun_batch(batch, seed)
    _p, _o, c, _m = make_train_step(g, accum=2)(
        p, init_opt_state(g, p), torch.from_numpy(x), torch.from_numpy(y),
        1e-3)
    return float(c)


def test_mesh_rule():
    assert dryrun.mesh_shape(8) == {"dp": 2, "sp": 2, "tp": 2}
    assert dryrun.mesh_shape(16) == {"dp": 2, "sp": 2, "tp": 4}
    assert dryrun.mesh_shape(6) == {"dp": 2, "sp": 3}
    assert dryrun.mesh_shape(3) == {"dp": 1, "sp": 3}
    assert dryrun.mesh_devices(3, "cpu") == ["cpu"] * 3


@pytest.mark.parametrize("n", [8, 2])
def test_dryrun_cost_is_the_unsharded_steps(n, capsys):
    out = dryrun.dryrun_multichip(n, device="cpu")
    batch = max(2 * out["mesh"]["dp"], 2)
    np.testing.assert_allclose(out["cost"], _unsharded_cost(batch, 0),
                               rtol=1e-5)
    assert out["pp_cost"] == _unsharded_cost(batch, 1)
    printed = capsys.readouterr().out
    assert f"dryrun_multichip({n}): one train step over a" in printed
    assert "+ pp: one GPipe train step over 2 stages" in printed
