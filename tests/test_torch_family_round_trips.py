"""Exact weight round trips for every backbone family on every tiny
trunk: the JAX tree -> the port's state dict (strict load) -> the JAX tree
again, through the port's inverse and through the JAX package's converter
of reference checkpoints (so the port's names are the reference's). The
weights are tests/test_torch_families.py's seeded numpy arrays in the JAX
model's tree.
"""

import numpy as np
import pytest

from test_torch_families import FAMILIES, _config, _jax_setup, _port
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.train.torch_import import (
    _flat_leaves, convert_lidar_centernet_statedict)
from transfuser_torch.train.jax_import import variables_from_state_dict

ROUND_TRIPS = [(f, t) for f in FAMILIES
               for t in ("regnety_micro", "resnet_micro", "convnext_tiny")]


@pytest.mark.parametrize("family,trunk", ROUND_TRIPS,
                         ids=[f"{f}-{t}" for f, t in ROUND_TRIPS])
def test_weight_round_trip_is_exact(family, trunk):
    """JAX tree -> port state dict (strict load) -> the JAX tree again,
    through the port's inverse and through the JAX package's converter of
    reference checkpoints (so the port's names are the reference's): every
    leaf bit for bit, nothing more or less."""
    cfg = _config(family, trunk, trunk)
    _, _, _, variables = _jax_setup(cfg, seed=7)
    tm = _port(cfg, variables)
    for back in (variables_from_state_dict(tm.state_dict(), cfg),
                 convert_lidar_centernet_statedict(tm.state_dict(), cfg)):
        for col in ("params", "batch_stats"):
            want = dict(_flat_leaves(variables.get(col, {})))
            got = dict(_flat_leaves(back[col]))
            assert got.keys() == want.keys(), col
            for path, v in want.items():
                np.testing.assert_array_equal(np.asarray(got[path]), v,
                                              err_msg="/".join(path))
