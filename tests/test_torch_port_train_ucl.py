"""The port's training slice against the JAX package with the COM loss
weighting on (``UCL: True``): the heatmap loss is masked by the per-object
weight squares of kernel K3 in last_wins mode.  Same checks as
``test_torch_port_train_step.py``; setup and tolerances in
``test_torch_port_train_common.py``."""
import pytest
import torch

import test_torch_port_train_common as common

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def result():
    return common.run_slice(ucl=True)


def test_ucl_step_loss_matches_jax(result):
    common.check_loss_and_tb(result)


def test_ucl_step_gradients_match_jax(result):
    common.check_grads(result)


def test_ucl_step_state_matches_jax(result):
    common.check_state(result)


def test_ucl_step_parameters_match_jax(result):
    common.check_params_after_step(result)
