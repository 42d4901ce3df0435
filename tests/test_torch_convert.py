"""Weights carried across: JAX CMA params -> `state_dict_from_jax_params` ->
strict load into the port -> `convert_policy_state_dict` back gives exactly
the original params."""

import numpy as np
import pytest

import jax

from vlnce_tpu.models.convert import convert_policy_state_dict
from vlnce_torch.models.convert import state_dict_from_jax_params

from tests.torch_port_cases import build_pair


@pytest.mark.parametrize("progress_monitor", [False, True], ids=["rxr_cma", "with_progress_monitor"])
def test_round_trip_through_port_state_dict(progress_monitor):
    extra = []
    if progress_monitor:
        extra = ["MODEL.PROGRESS_MONITOR.use", True,
                 "TASK_CONFIG.TASK.SENSORS", ["RXR_INSTRUCTION_SENSOR", "VLN_ORACLE_PROGRESS_SENSOR"]]
    (_, _, params), (policy, _), _ = build_pair(seed=1, extra=extra)
    sd = {k: v.detach().numpy() for k, v in policy.state_dict().items()}
    assert ("net.progress_monitor.weight" in sd) == progress_monitor

    template = jax.tree_util.tree_map(np.zeros_like, params)
    back = convert_policy_state_dict(sd, template, "CMAPolicy")
    flat_in = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_in.keys() == flat_back.keys()
    for path, v in flat_in.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), v, err_msg=jax.tree_util.keystr(path))


def test_unplaced_jax_param_raises():
    (_, _, params), _, _ = build_pair(seed=2)
    params = dict(params)
    params["net"] = dict(params["net"], stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        state_dict_from_jax_params(params)
