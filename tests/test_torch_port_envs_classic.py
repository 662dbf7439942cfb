"""The port's classic-control envs (CartPole-v1, Pendulum-v1,
MountainCarContinuous-v0) against the JAX package's: resets from the
uniforms the JAX keys give, steps from the same states and actions.

Reset states are compared exactly (a uniform maps to its range with one
rounding in both); reset observations, steps and rewards at rtol 1e-5 /
atol 1e-6 (rewards up to 100: atol 1e-5): XLA fuses products and sums
(x + TAU * x_dot) into one rounding where the port rounds twice, and its
sin and cos are other implementations than PyTorch's, so values differ in
their last bits. Terminations exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.envs.jax import classic as jclassic
from rl_games_tpu_torch.envs import registry
from rl_games_tpu_torch.envs.device import classic

torch.set_num_threads(1)

N = 64
TOL = dict(rtol=1e-5, atol=1e-6)
KEYS = jax.random.split(jax.random.PRNGKey(7), N)


def t(x):
    return torch.from_numpy(np.array(x))


def uniforms(keys, per_key):
    """The uniforms the JAX reset draws: ``per_key`` = 'shape' draws one
    uniform of the reset's shape from the key; 'split' one uniform per key
    of jax.random.split(key)."""
    def one(k, shape):
        if per_key == "split":
            return jnp.stack([jax.random.uniform(x) for x in jax.random.split(k)])
        return jax.random.uniform(k, shape)
    return lambda shape: t(jax.vmap(lambda k: one(k, shape))(keys))


ENVS = {
    # name: (JAX env, port env, reset draws, actions)
    "CartPole": (jclassic.CartPole, classic.CartPole, ("shape", (4,)),
                 lambda rng: rng.integers(0, 2, N).astype(np.int32)),
    "Pendulum": (jclassic.Pendulum, classic.Pendulum, ("split", None),
                 lambda rng: rng.uniform(-3, 3, (N, 1)).astype(np.float32)),
    "MountainCarContinuous": (jclassic.MountainCarContinuous, classic.MountainCarContinuous, ("shape", (1,)),
                              lambda rng: rng.uniform(-1.5, 1.5, (N, 1)).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_reset_and_steps_match_jax(name):
    jcls, pcls, (per_key, shape), draw_actions = ENVS[name]
    jenv, env = jcls(), pcls(device="cpu")
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(KEYS)
    u = uniforms(KEYS, per_key)(shape)
    if name == "MountainCarContinuous":
        u = u.reshape(N, 1)
    state, obs = env.reset_from(u)
    np.testing.assert_array_equal(state.x.numpy(), np.asarray(jstate.x))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)  # Pendulum: cos, sin

    # 20 steps from the same state each (the port's state set to the JAX one)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(8)
    if name == "MountainCarContinuous":  # start some cars near the goal
        jstate = jstate.replace(x=jstate.x.at[:8].set(jnp.asarray([0.44, 0.02])))
    ended = np.zeros(N, bool)
    for _ in range(20):
        actions = draw_actions(rng)
        state.x = t(jstate.x)
        want = jstep(jstate, jnp.asarray(actions), KEYS)
        got = env.step(state, t(actions))
        np.testing.assert_allclose(got[0].x.numpy(), np.asarray(want[0].x), **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        jstate = want[0]
        ended |= np.asarray(want[3])
    if name != "Pendulum":  # Pendulum never terminates
        assert ended.any()


def test_cartpole_terminates_and_autoresets():
    """The pole falls within 500 steps under a constant push; a terminated
    row restarts inside [-0.05, 0.05) in the same step."""
    vec = registry.create_vec_env("CartPole-v1", 8, device="cpu")
    state, obs = vec.reset(torch.Generator().manual_seed(0))
    push = torch.ones(8, dtype=torch.int64)
    for step in range(200):
        state, obs, reward, dones, infos = vec.step(state, push)
        assert torch.all(reward == 1.0)
        if dones.any():
            break
    assert dones.any() and not infos["time_outs"].any()
    assert torch.all(obs[dones].abs() < 0.05)
    assert torch.all(infos["final_observation"][dones].abs().amax(-1) > 0.05)
