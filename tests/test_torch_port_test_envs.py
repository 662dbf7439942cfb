"""The port's test envs and the PPO paths they drive, against the JAX package.

- Envs: each test env's reset (from uniforms that land on the JAX draws)
  and step from the same states, MemoryEnv under each of its flags and its
  dict-observation variant (with and without 'aux_target'), the
  masks of MaskedMemoryEnv, and the {'obs', 'states'} observations through
  the vec env's autoreset. MemoryEnv computes in integers and one float32
  product and division: exact. The asymmetric envs repeat the classic
  envs' float32 arithmetic: rtol 1e-5 / atol 1e-6, as those envs' tests.
- PPO, each from the JAX agent's weights and states, with the Gumbel
  uniforms of the JAX rollout's ``jax.random.categorical`` handed to the
  port's sampler: one masked epoch on test_masked_env (actions, masks and
  observations exactly; the policy's outputs at 1e-5; the weights after the
  update at 2e-6 absolute, as test_torch_port_ppo_discrete.py holds them);
  one MultiDiscrete, multi-head-value epoch (GAE at V = 2 at 1e-6, the
  losses at rtol 1e-4 and the first Adam step's weights at 2e-6); one
  update of ref/ppo_pendulum.yaml's network (separate trunks, a
  state-dependent sigma) from the JAX rollout; the score meter.
- A masked host rollout over ``GymnasiumVecEnv.get_action_masks``.
"""

import dataclasses
from pathlib import Path

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.envs import registry as jregistry
from rl_games_tpu.envs.jax import test_envs as jtest_envs
from rl_games_tpu.ops.gae import compute_gae as jcompute_gae
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.common.player import PpoPlayer
from rl_games_tpu_torch.envs import registry
from rl_games_tpu_torch.envs.device import test_envs
from rl_games_tpu_torch.envs.device.base import DeviceVecEnv
from rl_games_tpu_torch.envs.device.classic import ArrayState
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.ops.gae import compute_gae
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
N = 16
TINY = jnp.finfo(jnp.float32).tiny


def t(x):
    return torch.from_numpy(np.array(x))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def load(name):
    return yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / name).read_text())["params"]


def assert_tree_equal(got, want, err_msg=""):
    if isinstance(want, dict):
        assert set(got) == set(want), err_msg
        for k in want:
            assert_tree_equal(got[k], want[k], f"{err_msg}/{k}")
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=err_msg)


# ---------------------------------------------------------------------------
# the envs
# ---------------------------------------------------------------------------

FLAGS = {
    "default": {},
    "shown_dist_central": dict(hide_object=False, apply_dist_reward=True, use_central_value=True),
    "multi_discrete_mhv": dict(multi_discrete_space=True, multi_head_value=True, apply_dist_reward=True,
                               max_dist=5),
}


def memory_states(rng, n=N, lim=9):
    return dict(pos=rng.integers(-lim, lim + 1, (n, 2)).astype(np.int32),
                goal=rng.integers(-lim, lim + 1, (n, 2)).astype(np.int32),
                steps=rng.integers(0, 20, n).astype(np.int32))


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_memory_env_reset_and_step_match_jax(flags):
    kw = FLAGS[flags]
    jenv, env = jtest_envs.MemoryEnv(**kw), test_envs.MemoryEnv(device="cpu", **kw)
    info, jinfo = env.env_info(), jenv.env_info()
    assert (info.value_size, info.observation_space.shape) == (jinfo.value_size, jinfo.observation_space.shape)
    assert getattr(info.action_space, "nvec", None) == getattr(jinfo.action_space, "nvec", None)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    # uniforms that land on the JAX randint draws: sign bit (1 - dir) / 2, distance
    goal = np.asarray(jstate.goal)
    bit, dist = (1 - np.sign(goal)) // 2, np.abs(goal)
    span = env.max_dist + 1 - env.min_dist
    u = np.concatenate([(bit + 0.5) / 2, (dist - env.min_dist + 0.5) / span], axis=1).astype(np.float32)
    state, obs = env.reset_from(t(u))
    assert_tree_equal(obs, jobs, "reset obs")
    np.testing.assert_array_equal(state.goal.numpy(), goal)
    # steps from random states, with a row that reaches its goal
    s = memory_states(np.random.default_rng(2))
    s["goal"][0] = s["pos"][0] + np.array([1, 0])
    s["steps"][0] = 3
    rng = np.random.default_rng(3)
    actions = (np.stack([rng.integers(0, 2, N), rng.integers(0, 3, N)], -1) if kw.get("multi_discrete_space")
               else rng.integers(0, 4, N)).astype(np.int32)
    if kw.get("multi_discrete_space"):
        actions[0] = [0, 2]  # +x onto the goal, no move in y
    else:
        actions[0] = 0  # +x onto the goal
    want = jax.vmap(jenv.step)(jtest_envs.MemoryState(**{k: jnp.asarray(v) for k, v in s.items()}),
                               jnp.asarray(actions), keys)
    got = env.step(test_envs.MemoryState(**{k: t(v) for k, v in s.items()}), t(actions).long())
    for f in ("pos", "goal", "steps"):
        np.testing.assert_array_equal(getattr(got[0], f).numpy(), np.asarray(getattr(want[0], f)), err_msg=f)
    assert_tree_equal(got[1], want[1], "obs")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4]["scores"].numpy(), np.asarray(want[4]["scores"]))
    assert bool(got[3][0]) and float(got[4]["scores"][0]) == 1.0


def test_memory_env_reachable():
    """tests/test_envs.py::test_memory_env_reachable: the goal is shown on
    reset and hidden after the first step."""
    env = DeviceVecEnv(test_envs.MemoryEnv(max_steps=21, device="cpu"), 2)
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (2, 6)
    assert torch.all(obs[:, 2:4].abs().sum(-1) > 0)
    state, obs, rew, done, info = env.step(state, torch.zeros(2, dtype=torch.int64))
    assert torch.all(obs[:, 2:4] == 0)


@pytest.mark.parametrize("aux_loss", [False, True], ids=["pos_info", "aux_target"])
def test_dict_obs_memory_env_matches_jax(aux_loss):
    """DictObsMemoryEnv: {'pos', 'info'} (and 'aux_target', the squared
    distance over (max_dist - min_dist)², computed by the JAX program, as it
    trains, as a product with the float32 reciprocal) from the reset's
    uniforms that land on the JAX draws, then a step from random states,
    jitted as the JAX package runs it, and the vec env's autoreset of the
    dict: exactly."""
    jenv, env = jtest_envs.DictObsMemoryEnv(aux_loss=aux_loss), test_envs.DictObsMemoryEnv(aux_loss, device="cpu")
    info, jinfo = env.env_info(), jenv.env_info()
    assert info.observation_space.as_dict().keys() == jinfo.observation_space.as_dict().keys()
    assert {k: v.shape for k, v in info.observation_space.spaces} == {k: v.shape for k, v in jinfo.observation_space.spaces}
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    goal = np.asarray(jstate.goal)
    bit, dist = (1 - np.sign(goal)) // 2, np.abs(goal)
    span = env.max_dist + 1 - env.min_dist
    u = np.concatenate([(bit + 0.5) / 2, (dist - env.min_dist + 0.5) / span], axis=1).astype(np.float32)
    state, obs = env.reset_from(t(u))
    assert_tree_equal(obs, jobs, "reset obs")
    s = memory_states(np.random.default_rng(7))
    actions = np.random.default_rng(8).integers(0, 4, N).astype(np.int32)
    want = jax.jit(jax.vmap(jenv.step))(jtest_envs.MemoryState(**{k: jnp.asarray(v) for k, v in s.items()}),
                                        jnp.asarray(actions), keys)
    got = env.step(test_envs.MemoryState(**{k: t(v) for k, v in s.items()}), t(actions).long())
    assert_tree_equal(got[1], want[1], "obs")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    vec = registry.create_vec_env("test_dict_obs_env", 4, device="cpu", aux_loss=aux_loss)
    vstate, vobs = vec.reset(torch.Generator().manual_seed(0))
    vstate.estate.goal = torch.tensor([[0, 0], [5, 5], [0, 0], [5, 5]], dtype=torch.int32)  # rows 0, 2 reach at once
    _, vobs, _, dones, infos = vec.step(vstate, torch.zeros(4, dtype=torch.int64))
    np.testing.assert_array_equal(dones.numpy(), [True, False, True, False])
    assert set(vobs) == set(infos["final_observation"]) == ({"pos", "info", "aux_target"} if aux_loss
                                                             else {"pos", "info"})
    assert torch.all(vobs["info"][[0, 2], 3] == 0) and torch.all(infos["final_observation"]["info"][:, 3] == 1)


def test_masked_memory_env_masks_match_jax():
    jenv, env = jtest_envs.MaskedMemoryEnv(), test_envs.MaskedMemoryEnv(device="cpu")
    s = memory_states(np.random.default_rng(4), n=64)
    want = jax.vmap(jenv.action_masks)(jtest_envs.MemoryState(**{k: jnp.asarray(v) for k, v in s.items()}))
    got = env.action_masks(test_envs.MemoryState(**{k: t(v) for k, v in s.items()}))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.all() and got.any()
    vec = registry.create_vec_env("test_masked_env", 3, device="cpu")
    state, _ = vec.reset(torch.Generator().manual_seed(0))
    assert vec.has_action_masks and vec.get_action_masks(state).all()  # at the origin every move is valid
    assert not registry.create_vec_env("test_env", 3, device="cpu").has_action_masks


@pytest.mark.parametrize("cls", ["AsymmetricEnv", "ContinuousAsymmetricEnv"])
def test_asymmetric_env_dict_obs(cls):
    """tests/test_envs.py::test_asymmetric_env_dict_obs, and a step from the
    same inner state against the JAX env (rtol 1e-5, atol 1e-6)."""
    jenv, env = getattr(jtest_envs, cls)(), getattr(test_envs, cls)(device="cpu")
    vec = DeviceVecEnv(env, 3)
    state, obs = vec.reset(torch.Generator().manual_seed(0))
    assert set(obs) == {"obs", "states"}
    hidden = 1 if cls == "AsymmetricEnv" else 2
    assert torch.all(obs["obs"][:, hidden] == 0) and obs["states"].shape == (3, 4 if hidden == 1 else 3)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(N, 4)) * 0.05).astype(np.float32) if hidden == 1 else \
        np.stack([rng.uniform(-3, 3, N), rng.uniform(-1, 1, N)], -1).astype(np.float32)
    actions = rng.integers(0, 2, N) if hidden == 1 else rng.uniform(-2, 2, (N, 1)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jstate = type(jax.vmap(jenv.reset)(keys)[0])(x=jnp.asarray(x))
    want = jax.vmap(jenv.step)(jstate, jnp.asarray(actions), keys)
    got = env.step(ArrayState(x=t(x)), t(actions))
    for k in ("obs", "states"):
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(want[1][k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)
    env_info = env.env_info()
    assert env_info.state_space == env_info.observation_space


def test_dict_observations_through_autoreset():
    """Rows that end take the next episode's first observation in both
    entries; final_observation keeps the dict of the last one."""
    env = test_envs.MemoryEnv(use_central_value=True, device="cpu")
    vec = DeviceVecEnv(env, 4)
    state, _ = vec.reset(torch.Generator().manual_seed(0))
    state.estate.goal = torch.tensor([[0, 0], [5, 5], [0, 0], [5, 5]], dtype=torch.int32)  # rows 0, 2 reach at once
    new, obs, _, dones, infos = vec.step(state, torch.zeros(4, dtype=torch.int64))
    np.testing.assert_array_equal(dones.numpy(), [True, False, True, False])
    assert set(obs) == set(infos["final_observation"]) == {"obs", "states"}
    for k in ("obs", "states"):
        assert torch.all(obs[k][[0, 2], 5] == 0)  # step counter of a fresh episode
        assert torch.all(infos["final_observation"][k][:, 5] == 1)
    np.testing.assert_array_equal(new.estate.steps.numpy(), [0, 1, 0, 1])


def test_registry_binds_the_test_envs():
    vec = registry.create_vec_env("test_env", 2, device="cpu", multi_discrete_space=True, multi_head_value=True,
                                  min_dist=3, seed=1)
    info = vec.get_env_info()
    assert info.action_space.nvec == (2, 3) and info.value_size == 2 and vec.env.min_dist == 3
    for name, cls in (("test_rnn_env", "MemoryEnv"), ("test_asymmetric_env", "AsymmetricEnv"),
                      ("test_masked_env", "MaskedMemoryEnv"),
                      ("test_asymmetric_continuous_env", "ContinuousAsymmetricEnv")):
        assert type(registry.create_vec_env(name, 2, device="cpu").env).__name__ == cls
    # the dict-observation variant (A8 (a)), as the JAX registry binds it
    for name, kw in (("test_dict_obs_env", {}), ("test_env", {"multi_obs_space": True, "aux_loss": True,
                                                               "use_central_value": True})):
        env = registry.create_vec_env(name, 2, device="cpu", **kw).env
        jenv = jregistry.create_vec_env(name, 2, **kw).env
        assert type(env).__name__ == type(jenv).__name__ == "DictObsMemoryEnv"
        assert (env.aux_loss, env.use_central_value) == (jenv.aux_loss, jenv.use_central_value)


# ---------------------------------------------------------------------------
# PPO from the JAX agent's state, its categorical draws handed over
# ---------------------------------------------------------------------------


def jax_uniforms(jstate, horizon, widths):
    """Per rollout step, the uniforms of each categorical head's Gumbel
    noise: the rollout's key schedule (rng, akey = split(rng)), with akey
    split once per head when there are several (models.py:391-403)."""
    rng, out = jstate.rng, []
    for _ in range(horizon):
        rng, akey = jax.random.split(rng)
        keys = [akey] if len(widths) == 1 else list(jax.random.split(akey, len(widths)))
        out += [np.asarray(jax.random.uniform(k, (N, w), minval=TINY, maxval=1.0)) for k, w in zip(keys, widths)]
    return out


def port_agent(params, jstate, estate_cls=None):
    """A CPU port agent with the JAX state's weights, normalizer stats, env
    state, observations, dones and LR."""
    agent = PPOAgent("port", params, device="cpu")
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    est = jstate.env_state.estate
    cls = estate_cls or type(state.env_state.estate)
    state.env_state.estate = cls(**{f.name: t(getattr(est, f.name)) for f in dataclasses.fields(cls)})
    state.env_state.steps = t(jstate.env_state.steps)
    state.obs = jax.tree.map(t, jstate.obs) if isinstance(jstate.obs, dict) else t(jstate.obs)
    state.dones, state.lr = t(jstate.dones), t(jstate.lr)
    return agent, state


def sample_from(monkeypatch, uniforms):
    noise = iter(t(u) for u in uniforms)
    monkeypatch.setattr(D, "categorical_sample",
                        lambda logits, generator=None, mask=None: D.gumbel_max(logits, next(noise), mask))


def check_update(jagent, jafter, traj, last_values, agent, state, ptraj, plast):
    """_finish_epoch of both from the same trajectory: weights at 2e-6
    absolute, normalizer stats at rtol 1e-5, LR at rtol 1e-5, losses at
    rtol 1e-4."""
    jnew, jm = jax.jit(jagent._finish_epoch)(jafter, traj, last_values, None)
    state, pm = agent._finish_epoch(state, ptraj, plast)
    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm))
    for name, got in agent.model.state_dict().items():
        tol = dict(rtol=0, atol=2e-6) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)
    np.testing.assert_allclose(float(state.lr), float(jnew.lr), rtol=1e-5)
    jm = to_np(jm)
    for k in ("a_loss", "c_loss", "kl", "entropy", "explained_variance"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    return state, pm, jm


def masked_params(**config):
    params = load("ref/test/test_discrete.yaml")
    params["config"].update({"env_name": "test_masked_env", "use_action_masks": True, "num_actors": N,
                             "horizon_length": 4, "minibatch_size": 32, "mini_epochs": 2, **config})
    return params


def test_masked_ppo_epoch_matches_jax(monkeypatch):
    """tests/test_ppo_rnn.py::test_action_masks_end_to_end without the RNN,
    against the JAX agent: half the envs start on the ±max_dist border, so
    their masks forbid a move; the rollout (4 steps: no goal is reached, no
    env resets) samples only allowed actions, stores the masks and the
    actor's 'obs', and the update applies them."""
    params = masked_params()
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    s = memory_states(np.random.default_rng(6), lim=7)
    s["pos"][: N // 2, 0] = np.where(np.arange(N // 2) % 2, 8, -8)
    s["pos"][: N // 2, 1] = np.where(np.arange(N // 2) % 4 < 2, 8, -8)
    s["goal"][:] = 30
    s["steps"] = np.clip(s["steps"], 1, 12)
    jest = jtest_envs.MemoryState(**{k: jnp.asarray(v) for k, v in s.items()})
    jenv = jagent.vec_env.env
    jobs = jax.vmap(lambda e: jenv._wrap(jenv._obs(e), e))(jest)
    jstate = jstate.replace(env_state=jstate.env_state.replace(estate=jest, steps=jnp.asarray(s["steps"])),
                            obs=jobs, dones=jnp.zeros(N))
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    traj, last_values = to_np(traj), np.asarray(last_values)
    assert not traj["dones"].any() and not np.asarray(after.dones).any()
    assert not traj["action_masks"].all()
    sample_from(monkeypatch, jax_uniforms(jstate, 4, (4,)))
    agent, state = port_agent(params, jstate)
    ptraj, plast = agent._rollout(state)
    assert set(ptraj) == {"obses", "dones", "actions", "values", "neglogpacs", "rewards", "action_masks"}
    np.testing.assert_array_equal(ptraj["action_masks"].numpy(), traj["action_masks"])
    np.testing.assert_array_equal(ptraj["actions"].numpy(), traj["actions"])
    masks, actions = ptraj["action_masks"].numpy(), ptraj["actions"].numpy()
    assert np.take_along_axis(masks, actions[..., None], -1).all()  # no masked action sampled
    np.testing.assert_array_equal(ptraj["obses"].numpy(), traj["obses"]["obs"])
    for k in ("values", "neglogpacs", "rewards"):
        np.testing.assert_allclose(ptraj[k].numpy(), traj[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(plast.numpy(), last_values, rtol=1e-5, atol=1e-5)
    # the update from the JAX trajectory (the actor's 'obs' only: no central value)
    jagent2 = JPPOAgent("jax", masked_params())
    agent2, state2 = port_agent(masked_params(), after)
    ptraj = {k: t(v) for k, v in traj.items() if k != "obses"}
    ptraj["obses"] = t(traj["obses"]["obs"])
    check_update(jagent2, after, traj, last_values, agent2, state2, ptraj, t(last_values))


def mhv_params(**config):
    params = load("ref/test/test_discrete_multidiscrete_mhv.yaml")
    params["config"]["env_config"]["multi_head_value"] = True
    params["config"].update(num_actors=N, horizon_length=4, minibatch_size=64, mini_epochs=1,
                            normalize_value=True, normalize_input=True, **config)
    return params


def test_multi_discrete_multi_head_value_epoch_matches_jax(monkeypatch):
    """MultiDiscrete (2, 3) actions and value_size 2 (rewards [win,
    distance]): the rollout with both heads' draws handed over, GAE at
    V = 2 (rtol 1e-6), then one update of one minibatch: the first Adam
    step, the value normalizer of shape (2,) and the losses."""
    params = mhv_params()
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    traj, last_values = to_np(traj), np.asarray(last_values)
    assert traj["rewards"].shape == (4, N, 2) and traj["actions"].shape == (4, N, 2)
    assert not traj["dones"][1:].any()
    sample_from(monkeypatch, jax_uniforms(jstate, 4, (2, 3)))
    agent, state = port_agent(params, jstate)
    ptraj, plast = agent._rollout(state)
    np.testing.assert_array_equal(ptraj["actions"].numpy(), traj["actions"])
    for k in ("values", "neglogpacs", "rewards"):
        np.testing.assert_allclose(ptraj[k].numpy(), traj[k], rtol=1e-5, atol=1e-5, err_msg=k)
    args = (traj["rewards"], traj["values"], traj["dones"], last_values, np.asarray(after.dones))
    want = np.asarray(jcompute_gae(*args, 0.99, 0.9))
    got = compute_gae(*(t(a) for a in args), 0.99, 0.9)
    assert got.shape == (4, N, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    agent2, state2 = port_agent(mhv_params(), after)
    state2, pm, _ = check_update(JPPOAgent("jax", mhv_params()), after, traj, last_values, agent2, state2,
                                 {k: t(v) for k, v in traj.items()}, t(last_values))
    assert agent2.model.value_mean_std.running_mean.shape == (2,)
    assert int(state2.opt_state.count) == 1


def test_ppo_pendulum_network_update_matches_jax():
    """ref/ppo_pendulum.yaml's network (separate trunks, a state-dependent
    sigma, adaptive LR) on the device Pendulum: one update of 2 mini-epochs
    x 4 minibatches from the JAX rollout."""
    params = load("ref/ppo_pendulum.yaml")
    params["config"].pop("vecenv_type")
    params["config"].update(num_actors=N, horizon_length=8, minibatch_size=32, mini_epochs=2)
    jagent = JPPOAgent("jax", params)
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jagent.init_state())
    traj, last_values = to_np(traj), np.asarray(last_values)
    agent, state = port_agent(params, after)
    assert not agent.model.a2c_network.fixed_sigma and agent.model.a2c_network.separate
    check_update(jagent, after, traj, last_values, agent, state, {k: t(v) for k, v in traj.items()},
                 t(last_values))


@pytest.mark.parametrize("min_dist, score", [(0, 1.0), (25, 0.0)])
def test_score_meter(min_dist, score):
    """infos['scores'] at done rows (ppo.py:628-633): a goal at the origin
    is reached on the first step (score 1), one 25 steps away never before
    the 21-step limit (score 0); mean_scores as the JAX agent's."""
    params = load("ref/test/test_discrete.yaml")
    params["config"].update(num_actors=N, horizon_length=24, minibatch_size=96, mini_epochs=1)
    params["config"]["env_config"].update(min_dist=min_dist, max_dist=min_dist)
    jagent = JPPOAgent("jax", params)
    _, jm = jax.jit(jagent.train_epoch)(jagent.init_state())
    agent = PPOAgent("port", params, device="cpu")
    _, pm = agent.train_epoch(agent.init_state())
    assert float(pm["mean_scores"]) == float(jm["mean_scores"]) == score
    assert int(pm["games_played"]) == int(jm["games_played"])
    # an env without scores reports none
    pendulum = load("ref/ppo_pendulum.yaml")
    pendulum["config"].pop("vecenv_type")
    pendulum["config"].update(num_actors=4, horizon_length=4, minibatch_size=16)
    agent = PPOAgent("port", pendulum, device="cpu")
    assert "mean_scores" not in agent.train_epoch(agent.init_state())[1]


def test_scores_reach_the_log_and_the_observer(tmp_path, capsys):
    from rl_games_tpu_torch.utils.observers import DefaultAlgoObserver

    params = load("ref/test/test_discrete.yaml")
    params["config"].update(num_actors=N, horizon_length=24, minibatch_size=96, mini_epochs=1, max_epochs=2,
                            train_dir=str(tmp_path))
    params["config"]["env_config"].update(min_dist=0, max_dist=0)
    tags = {}

    class Writer:
        def add_scalar(self, tag, value, step):
            tags.setdefault(tag, []).append(float(value))

        def flush(self):
            pass

    params["config"]["features"] = {"observer": DefaultAlgoObserver()}
    PPOAgent("port", params, device="cpu").train(writer=Writer())
    assert tags["scores/mean"] == [1.0, 1.0]
    assert " score: 1.000" in capsys.readouterr().out


def test_masked_player_never_plays_a_masked_action():
    params = masked_params()
    params["config"]["player"] = {"games_num": 8, "deterministic": False, "num_actors": N}
    player = PpoPlayer(params, device="cpu")
    env_state, obs = player.vec_env.reset(torch.Generator().manual_seed(0))
    env_state.estate.pos[:] = torch.tensor([8, -8], dtype=torch.int32)
    masks = player.vec_env.get_action_masks(env_state)
    gen = torch.Generator().manual_seed(1)
    for deterministic in (False, True):
        player.deterministic = deterministic
        for _ in range(8):
            actions = player._play_actions(gen, obs, env_state)
            assert masks[torch.arange(N), actions].all()
    assert np.isfinite(player.run(8))


# ---------------------------------------------------------------------------
# a masked host rollout
# ---------------------------------------------------------------------------


class _CountingMaskedEnv(gym.Env):
    """Discrete(3); the action equal to the step count mod 3 is masked."""

    observation_space = gym.spaces.Box(-10, 10, (2,), np.float32)
    action_space = gym.spaces.Discrete(3)

    def __init__(self):
        self.count = 0

    def get_action_mask(self):
        mask = np.ones(3, bool)
        mask[self.count % 3] = False
        return mask

    def reset(self, *, seed=None, options=None):
        self.count = 0
        return np.zeros(2, np.float32), {}

    def step(self, action):
        assert action != self.count % 3, "a masked action reached the env"
        self.count += 1
        return np.array([self.count % 3, action], np.float32), 1.0, self.count >= 7, False, {}


def test_masked_host_rollout():
    """Over GymnasiumVecEnv.get_action_masks: each step's masks go up in the
    copy that carries its observations, the policy samples inside them and
    the trajectory stores them; the update takes them."""
    gym.register(id="PortCountingMasked-v0", entry_point=_CountingMaskedEnv)
    try:
        params = masked_params(env_name="PortCountingMasked-v0", vecenv_type="GYMNASIUM", horizon_length=8,
                               host_inference_device="cpu")
        params["config"].pop("env_config")
        agent = PPOAgent("port", params, device="cpu")
        state = agent.init_state()
        uploads = []
        upload = agent._upload
        agent._upload = lambda *a: uploads.append(len(a)) or upload(*a)
        traj, _ = agent._host_rollout(state)
        assert uploads == [1] + [4] * 8  # the first masks alone, then obs, rewards, dones and masks
        masks, actions = traj["action_masks"].numpy(), traj["actions"].numpy()
        count = np.arange(8) % 7 % 3  # episodes of 7 steps
        np.testing.assert_array_equal(masks, np.broadcast_to(np.arange(3)[None, None] != count[:, None, None],
                                                             masks.shape))
        assert np.take_along_axis(masks, actions[..., None], -1).all()
        state, m = agent.host_train_epoch(state)
        assert np.isfinite(float(m["a_loss"])) and int(m["games_played"]) == N * 2
    finally:
        del gym.registry["PortCountingMasked-v0"]
