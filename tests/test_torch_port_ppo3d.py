"""The port's PPO slice on a 3D morphology against the JAX PPOAgent:
rl_games_tpu/configs/ppo_humanoid3d.yaml read in place and cut to 8 envs,
horizon 4, units [32, 16], minibatch 16 and 2 mini-epochs. Weights,
normalizer stats and env states are carried from the JAX agent to the port;
the JAX rollout's action noise is recovered as (actions - mus) / sigmas and
fed to the port's rollout (as tests/test_torch_port_ppo.py does on Ant2D).

Tolerances: after 4 steps of 18-coordinate contact dynamics what is
computed from the observations (actions, values, neglogp, shaped rewards)
agrees to rtol = atol = 2e-4, the observations' positions too and their
velocities to 1e-3 (each step's rounding, 1e-5 in velocities, grows
through the stiff heel/toe contacts); one update of the config's
'standard' schedule from the same trajectory to 5e-6 in the parameters,
as on Ant2D.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.envs.device.humanoid3d import Humanoid3DState
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)

CONFIG = Path(__file__).resolve().parent.parent / "rl_games_tpu" / "configs" / "ppo_humanoid3d.yaml"
NUM_ACTORS, HORIZON = 8, 4


def tiny_params():
    with open(CONFIG) as f:
        params = yaml.safe_load(f)["params"]
    params["network"]["mlp"]["units"] = [32, 16]
    params["config"].update(num_actors=NUM_ACTORS, horizon_length=HORIZON, minibatch_size=16, mini_epochs=2)
    return params


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_run():
    """A JAX agent, its initial state, and one rollout from it (numpy)."""
    jagent = JPPOAgent("jax", tiny_params())
    jstate = jagent.init_state()
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    return jagent, jstate, after, to_np(traj), np.asarray(last_values)


def port_agent(jstate):
    """A port agent (on the CPU) holding the JAX state's weights, normalizer
    stats, env state and LR."""
    agent = PPOAgent("port", tiny_params(), device="cpu")
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    est = jstate.env_state.estate
    state.env_state.estate = Humanoid3DState(q=t(est.q), qd=t(est.qd), last_x=t(est.last_x))
    state.env_state.steps = t(jstate.env_state.steps)
    state.obs, state.dones, state.lr = t(jstate.obs), t(jstate.dones), t(jstate.lr)
    return agent, state


def test_rollout_matches_jax(jax_run, monkeypatch):
    _, jstate, after, traj, last_values = jax_run
    # resets draw from different generators in the two frameworks, so the
    # comparison needs a rollout in which no env terminates
    assert not traj["dones"][1:].any() and not np.asarray(after.dones).any()
    assert traj["obses"].shape == (HORIZON, NUM_ACTORS, 41)
    noise = iter(t((traj["actions"] - traj["mus"]) / traj["sigmas"]))
    monkeypatch.setattr(D, "normal_sample", lambda mean, std, generator=None: mean + std * next(noise))
    agent, state = port_agent(jstate)
    ptraj, plast = agent._rollout(state)
    tol = dict(rtol=2e-4, atol=2e-4)
    for k in ("actions", "mus", "sigmas", "values", "neglogpacs", "rewards"):
        np.testing.assert_allclose(ptraj[k].numpy(), traj[k], err_msg=k, **tol)
    # observations: height, orientation and joints (0-18) at 2e-4,
    # velocities (19-36) at 1e-3, contact flags (37-40) exactly
    obs, jobs = ptraj["obses"].numpy(), traj["obses"]
    np.testing.assert_allclose(obs[..., :19], jobs[..., :19], **tol)
    np.testing.assert_allclose(obs[..., 19:37], jobs[..., 19:37], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(obs[..., 37:], jobs[..., 37:])
    assert jobs[..., 37:].any(), "no foot contact in the rollout: contacts would go untested"
    np.testing.assert_array_equal(ptraj["dones"].numpy(), traj["dones"])
    np.testing.assert_allclose(plast.numpy(), last_values, **tol)
    np.testing.assert_allclose(state.env_state.estate.q.numpy(), np.asarray(after.env_state.estate.q), **tol)


def test_update_matches_jax(jax_run):
    """One epoch's update (the config's 'standard' adaptive LR) from the
    JAX trajectory, starting from the JAX state after the rollout."""
    jagent, _, after, traj, last_values = jax_run
    agent, state = port_agent(after)
    assert agent.schedule_type == jagent.schedule_type == "standard"
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, None)
    state, pm = agent._finish_epoch(state, {k: t(v) for k, v in traj.items()}, t(last_values))
    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm))
    for name, got in agent.model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), rtol=1e-5, atol=5e-6, err_msg=name)
    np.testing.assert_allclose(float(state.lr), float(jnew.lr), rtol=1e-5)
    jm = to_np(jm)
    for k in ("a_loss", "c_loss", "kl", "explained_variance", "entropy"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(state.frame) == int(jnew.frame) == NUM_ACTORS * HORIZON
