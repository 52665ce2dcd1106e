"""videopose3d_torch's model against videopose3d_tpu's on identical weights:
layout conversion, the plain dilated forward (eval) and the fused forward
(plain kernel versions on the CPU vs the Pallas kernels in interpret mode)."""

import numpy as np
import jax
import pytest
import torch

from videopose3d_tpu.models.convert import (params_from_torch_state_dict,
                                            params_to_torch_state_dict)
from videopose3d_tpu.models.temporal import forward_dilated as jax_forward_dilated
from videopose3d_tpu.models.temporal import (forward_dilated_fused as
                                             jax_forward_dilated_fused)
from videopose3d_tpu.models.temporal import receptive_field as jax_receptive_field
from videopose3d_torch.models.convert import (jax_params_from_state_dict,
                                              state_dict_from_jax)
from videopose3d_torch.models.temporal import (forward_dilated, forward_dilated_fused,
                                               receptive_field)

from torch_port_helpers import jax_model

# float32; outputs are O(1), sums run over up to 3*64 products per layer in a
# different order than XLA's, compounded over up to 5 layers.
ATOL = 5e-5


def _kwargs(fw, causal=False, channels=32, dense=False):
    return dict(num_joints_in=17, in_features=2, num_joints_out=17,
                filter_widths=fw, causal=causal, dropout=0.25,
                channels=channels, dense=dense)


def _input(cfg, extra, seed, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, jax_receptive_field(cfg) + extra, 17, 2)).astype(np.float32)


def test_state_dict_from_jax_round_trips():
    cfg, params, state, _, model = jax_model(_kwargs((3, 3, 3)))
    sd = state_dict_from_jax(params, state)
    want = params_to_torch_state_dict(params, state)
    assert sd.keys() == want.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k])
    # The port's model takes it with strict loading, keys and shapes alike.
    assert {k for k in model.state_dict() if "num_batches" not in k} == set(sd)
    p2, s2 = jax_params_from_state_dict(sd)
    pj, sj = params_from_torch_state_dict(cfg, want)
    for a, b in zip(jax.tree_util.tree_leaves((p2, s2)),
                    jax.tree_util.tree_leaves((pj, sj))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves((p2, s2)),
                    jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fw,causal,dense", [
    ((3,), False, False),
    ((3, 3), False, False),
    ((3, 3, 3), True, False),
    ((3, 3, 3, 3), False, False),
    ((3, 3, 3, 3, 3), False, False),
    ((3, 3, 3, 3, 3), True, False),
    ((3, 5, 3), False, True),
])
def test_forward_dilated_matches_jax(fw, causal, dense):
    cfg, params, state, tcfg, model = jax_model(_kwargs(fw, causal, dense=dense))
    assert receptive_field(tcfg) == jax_receptive_field(cfg)
    x = _input(cfg, 13, seed=len(fw))
    want, _ = jax_forward_dilated(cfg, params, state, x, train=False)
    got = forward_dilated(model, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("fw,causal,channels", [
    ((3,), False, 32),                 # no residual block: expand + shrink
    ((3, 3), False, 32),               # one block: fused expand, plain shrink
    ((3, 3), True, 64),
    ((3, 3, 3), False, 64),            # expand + shrink kernels, no mid block
    ((3, 3, 3, 3), False, 32),
    ((3, 3, 3, 3, 3), False, 32),
    ((3, 3, 3, 3, 3), True, 32),
    ((3, 3, 3, 3), True, 30),          # padded to 32 channels, 34 -> 36 columns, 51 -> 52
])
def test_forward_dilated_fused_matches_jax(fw, causal, channels):
    cfg, params, state, tcfg, model = jax_model(_kwargs(fw, causal, channels))
    x = _input(cfg, 37, seed=10 + len(fw))
    want = jax_forward_dilated_fused(cfg, params, state, x, t_tile=16,
                                     interpret=True)
    got = forward_dilated_fused(tcfg, model, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # ... and the fused form equals the plain dilated form of the port.
    np.testing.assert_allclose(got.numpy(),
                               forward_dilated(model, torch.from_numpy(x)).numpy(),
                               atol=ATOL)


def test_fused_operands_are_made_once_per_model_state():
    """The fused forward's padded operands are made once for a model and dtype,
    and made anew after an in-place update of any of its tensors."""
    from videopose3d_torch.models.temporal import _fused_operands
    cfg, _, _, tcfg, model = jax_model(_kwargs((3, 3, 3), channels=30))
    first = _fused_operands(model, torch.float32)
    assert _fused_operands(model, torch.float32) is first
    assert first[2][0][0].shape == (3, 32, 32) and first[3][0].shape == (32, 52)
    x = torch.from_numpy(_input(cfg, 5, seed=3))
    before = forward_dilated_fused(tcfg, model, x)
    with torch.no_grad():
        model.shrink.bias.add_(1.0)
    again = _fused_operands(model, torch.float32)
    assert again is not first
    torch.testing.assert_close(forward_dilated_fused(tcfg, model, x), before + 1.0)
    assert _fused_operands(model, torch.bfloat16)[2][0][0].shape == (3, 32, 32)


def test_forward_dilated_fused_rejects_dense():
    _, _, _, tcfg, model = jax_model(_kwargs((3, 3), dense=True))
    with pytest.raises(ValueError, match="dense"):
        forward_dilated_fused(tcfg, model, torch.zeros(1, 9, 17, 2))
