"""Port OneEuro filter (pipeline/temporal.py) against the JAX package.

Inputs from a numpy seed go through both; every output and every leaf
of the filter state must agree to 1e-5 (float32 arithmetic in the same
order; the orientation goes through each side's rotation conversions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.pipeline import temporal as jt
from acr_tpu_torch.pipeline import temporal as tt

torch.set_num_threads(2)
TOL = 1e-5


def leaves(state):
    if isinstance(state, tuple):
        return [x for s in state for x in leaves(s)]
    return [np.asarray(state)]


def assert_states(got, want):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


def hand_inputs(rng, n, near_pi=False):
    """(n, 2, 48) poses and (n, 2, 10) betas; with ``near_pi`` the global
    orientations have angles within 1e-3 of pi."""
    poses = (rng.randn(n, 2, 48) * 0.3).astype(np.float32)
    if near_pi:
        axis = rng.randn(n, 2, 3)
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        angle = np.pi - rng.rand(n, 2, 1) * 1e-3
        poses[..., :3] = (axis * angle).astype(np.float32)
    betas = (rng.randn(n, 2, 10) * 0.5).astype(np.float32)
    return poses, betas


@pytest.mark.parametrize("dx_from_output", [False, True])
def test_oneeuro_step_matches_jax(dx_from_output):
    rng = np.random.RandomState(int(dx_from_output))
    xs = np.cumsum(rng.randn(6, 45).astype(np.float32) * 0.1, axis=0)
    js, ts = jt.init_channel((45,)), tt.init_channel((45,), device="cpu")
    for x in xs:
        js, jy = jt.oneeuro_step(js, jnp.asarray(x), 4.0, 0.7,
                                 dx_from_output=dx_from_output)
        ts, ty = tt.oneeuro_step(ts, torch.tensor(x), 4.0, 0.7,
                                 dx_from_output=dx_from_output)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL)
        assert_states(ts, js)
    assert bool(ts.initialized)


def test_smooth_two_hands_undetected_hand_untouched():
    rng = np.random.RandomState(2)
    poses, betas = hand_inputs(rng, 4)
    js, ts = jt.init_two_hand_filter(), tt.init_two_hand_filter(device="cpu")
    flags = np.array([[True, True], [True, False], [True, False],
                      [False, False]])
    for p, b, d in zip(poses, betas, flags):
        before = leaves(ts.right)
        js, jp, jb = jt.smooth_two_hands(js, jnp.asarray(p), jnp.asarray(b),
                                         jnp.asarray(d))
        ts, tp, tb = tt.smooth_two_hands(ts, torch.tensor(p), torch.tensor(b),
                                         torch.tensor(d))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=TOL)
        assert_states(ts, js)
        for hand in range(2):
            if not d[hand]:       # outputs pass through, state untouched
                np.testing.assert_array_equal(tp[hand].numpy(), p[hand])
                np.testing.assert_array_equal(tb[hand].numpy(), b[hand])
        if not d[1]:
            for a, c in zip(leaves(ts.right), before):
                np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("near_pi", [False, True])
def test_smooth_sequence_matches_jax(near_pi):
    rng = np.random.RandomState(3 + near_pi)
    poses, betas = hand_inputs(rng, 6, near_pi=near_pi)
    flags = rng.rand(6, 2) > 0.25
    flags[0] = True
    js, jp, jb = jt.smooth_sequence(jt.init_two_hand_filter(),
                                    jnp.asarray(poses), jnp.asarray(betas),
                                    jnp.asarray(flags))
    ts, tp, tb = tt.smooth_sequence(tt.init_two_hand_filter(device="cpu"),
                                    torch.tensor(poses), torch.tensor(betas),
                                    torch.tensor(flags))
    assert tp.shape == (6, 2, 48) and tb.shape == (6, 2, 10)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=TOL)
    assert_states(ts, js)
    # the sequence is smooth_two_hands frame by frame
    st = tt.init_two_hand_filter(device="cpu")
    for k in range(6):
        st, p, b = tt.smooth_two_hands(st, torch.tensor(poses[k]),
                                       torch.tensor(betas[k]),
                                       torch.tensor(flags[k]))
        assert torch.equal(p, tp[k]) and torch.equal(b, tb[k])
