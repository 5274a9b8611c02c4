"""Model-parallel training over processes, the filter-sharded steps (tp=2,
(dp=2, tp=2), (sp=2, tp=2)) and `ops/train_epilogue.bn_act_train_parts`
with 2 parts a rank over a 2-rank group: one world of 4 gloo ranks on the
CPU.  The cases, their batches and their tolerances are those of
tests/test_torch_mp_train.py's module docstring."""

import pytest

from test_torch_mp_train import (TP, check_bn_parts, check_jax,
                                 check_one_process, run_world)

BN = ["bn-f32", "bn-bf16"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory, TP + BN)


@pytest.mark.parametrize("name", TP)
def test_equals_one_process_mesh(world, name):
    check_one_process(world, name)


@pytest.mark.parametrize("name", TP)
def test_matches_jax(world, name):
    check_jax(world, name)


@pytest.mark.parametrize("name", BN)
def test_bn_parts_over_a_group(world, name):
    check_bn_parts(world, name)
