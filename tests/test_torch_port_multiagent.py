"""The port's multi-agent PPO and envs against the JAX package.

- CooperativeGather (envs/device/multiagent.py) reset and stepped from the
  JAX env's draws: bit for bit; the flattened contract
  (tests/test_multiagent.py::test_multiagent_vecenv_contract).
- A multi-agent rollout (tests/test_multiagent.py's config: 8 envs x 3
  agents, horizon 16) with the JAX rollout's normals and reset draws handed
  over, some envs near their time limit: the trajectory at rtol = atol =
  1e-5, the episode meters exactly (each env counted once, at its first
  agent row); one update from the JAX trajectory, with and without the
  central value net: weights at 2e-6 absolute, normalizers at rtol 1e-5,
  losses at rtol 1e-4 (test_torch_port_central_value.py's tolerances).
- ``clear_stats`` sizes its accumulators N · A rows.
- tests/test_multiagent.py's learning and central-value tests, with their
  gates.
- pettingzoo's multiwalker (envs/host/pettingzoo_env.py): the rows and the
  autoreset (tests/test_host_envs.py::test_multiwalker_vecenv_rows_and_autoreset),
  the rows against the JAX package's env under one seed and the same
  actions, bit for bit, and a host PPO epoch of shrunk
  ref/ppo_multiwalker.yaml with its central value net, whose meters count
  each env once.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.envs import registry as jregistry
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.envs import registry
from rl_games_tpu_torch.envs.device.multiagent import GatherState
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict
from test_multiagent import ma_params

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
A = 3

CV_CONFIG = {  # tests/test_multiagent.py::test_multiagent_central_value's
    "learning_rate": 5e-4, "mini_epochs": 2, "minibatch_size": 128, "clip_value": True, "normalize_input": False,
    "network": {"name": "actor_critic", "central_value": True,
                "mlp": {"units": [32], "activation": "elu", "initializer": {"name": "default"}}},
}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def tree_t(x):
    return {k: t(v) for k, v in x.items()} if isinstance(x, dict) else t(x)


def close(got, want, err_msg="", rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


def reset_noise(keys, parts, shape):
    """The uniforms a JAX env's reset draws from each of ``keys``: the key
    split into ``parts``, one uniform of ``shape`` from each ([N, parts,
    *shape], what the port's ``reset_from`` takes)."""
    return np.stack([np.stack([np.asarray(jax.random.uniform(k, shape)) for k in jax.random.split(key, parts)])
                     for key in keys])


def step_reset_noise(key, num_envs, steps, parts, shape):
    """The reset uniforms of each of ``steps`` JAX vec-env steps from the
    vec-env key ``key`` (JaxVecEnv.step: key, step_key, reset_key =
    split(key, 3); each env resets from split(reset_key, N))."""
    out = []
    for _ in range(steps):
        key, _, reset_key = jax.random.split(key, 3)
        out.append(reset_noise(jax.random.split(reset_key, num_envs), parts, shape))
    return out


def inject_resets(monkeypatch, env, noise):
    """The port env's resets take ``noise`` (one [N, ...] array a call)."""
    draws = iter(noise)
    monkeypatch.setattr(env, "reset", lambda num_envs, generator: env.reset_from(t(next(draws))))


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------


def test_multiagent_vecenv_contract():
    env = registry.create_vec_env("cooperative_gather", 4, device="cpu")
    assert env.num_agents == 3
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs["obs"].shape == (12, 2)  # N*A rows
    assert obs["states"].shape == (12, 6)  # the joint state a row
    state, obs, rew, done, infos = env.step(state, torch.zeros((12, 1)))
    assert rew.shape == (12,) and done.shape == (12,) and infos["time_outs"].shape == (12,)
    # a done is per env, shared across that env's agent rows
    d = done.numpy().reshape(4, 3)
    assert (d == d[:, :1]).all()


def test_cooperative_gather_matches_jax():
    """Reset from the JAX env's draws and 70 steps (past the 64-step limit:
    a time-out and in-step resets) with the same actions and the JAX
    vec env's reset draws: observations, rewards, dones, time_outs and the
    final observations bit for bit."""
    n = 6
    jenv = jregistry.create_vec_env("cooperative_gather", n)
    env = registry.create_vec_env("cooperative_gather", n, device="cpu")
    key = jax.random.PRNGKey(3)
    jstate, jobs = jenv.reset(key)
    state, _ = env.reset(torch.Generator())
    state.estate, obs = env.env.reset_from(t(reset_noise(jax.random.split(key, n + 1)[1:], 2, (A,))))
    obs = env._flatten(obs)
    for k in ("obs", "states"):
        np.testing.assert_array_equal(obs[k].numpy(), np.asarray(jobs[k]))
    rng = np.random.default_rng(0)
    jstep = jax.jit(jenv.step)
    noise = step_reset_noise(jstate.key, n, 70, 2, (A,))
    draws = iter(noise)
    env.env.reset = lambda num_envs, generator: env.env.reset_from(t(next(draws)))
    reached = timed_out = 0
    for i in range(70):
        a = rng.uniform(-1.0, 1.0, (n * A, 1)).astype(np.float32)
        if i < 30:  # walk env 0's agents onto their targets: terminal steps
            a[:A, 0] = np.clip(np.asarray(jstate.estate.targets[0] - jstate.estate.pos[0]) / 0.1, -1.0, 1.0)
        jstate, jobs, jrew, jdone, jinfos = jstep(jstate, jnp.asarray(a))
        state, obs, rew, done, infos = env.step(state, t(a))
        for k in ("obs", "states"):
            np.testing.assert_array_equal(obs[k].numpy(), np.asarray(jobs[k]), err_msg=f"{k} at step {i}")
            np.testing.assert_array_equal(infos["final_observation"][k].numpy(),
                                          np.asarray(jinfos["final_observation"][k]))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(infos["time_outs"].numpy(), np.asarray(jinfos["time_outs"]))
        reached += int((np.asarray(jdone) & ~np.asarray(jinfos["time_outs"])).sum())
        timed_out += int(np.asarray(jinfos["time_outs"]).sum())
    assert reached > 0 and timed_out > 0


# ---------------------------------------------------------------------------
# PPO over N * A rows
# ---------------------------------------------------------------------------


def ma_config(cv: bool = False):
    params = ma_params()
    if cv:
        params["config"]["central_value_config"] = {**CV_CONFIG, "network": dict(CV_CONFIG["network"])}
    return params


def port_agent(params, jstate):
    """A CPU port agent with the JAX state's weights (and central value
    net), env state, observations, dones and LR."""
    agent = PPOAgent("port", params, device="cpu")
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    if agent.has_central_value:
        agent.cv_model.load_state_dict(jax_to_state_dict(to_np(jstate.cv_params), to_np(jstate.cv_norm)))
    est = jstate.env_state.estate
    state.env_state.estate = GatherState(pos=t(est.pos), targets=t(est.targets), steps=t(est.steps))
    state.env_state.steps = t(jstate.env_state.steps)
    state.obs, state.dones, state.lr = tree_t(to_np(jstate.obs)), t(jstate.dones), t(jstate.lr)
    return agent, state


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "central_value"])
def jax_run(request):
    """A JAX multi-agent agent whose envs 0, 2 and 5 are near their 64-step
    limit, its state and one rollout from it (numpy)."""
    params = ma_config(request.param)
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    steps = np.zeros(8, np.int32)
    steps[[0, 2, 5]] = [60, 55, 51]
    jstate = jstate.replace(env_state=jstate.env_state.replace(steps=jnp.asarray(steps)))
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    return params, jagent, jstate, after, to_np(traj), np.asarray(last_values)


def test_rollout_matches_jax(jax_run, monkeypatch):
    params, jagent, jstate, after, traj, last_values = jax_run
    assert traj["dones"].shape == (16, 24) and traj["dones"][1:].any()
    noise = iter(t((traj["actions"] - traj["mus"]) / traj["sigmas"]))
    monkeypatch.setattr(D, "normal_sample", lambda mean, std, generator=None: mean + std * next(noise))
    agent, state = port_agent(params, jstate)
    inject_resets(monkeypatch, agent.vec_env.env, step_reset_noise(jstate.env_state.key, 8, 16, 2, (A,)))
    ptraj, plast = agent._rollout(state)
    close(ptraj["obses"], traj["obses"]["obs"], "obses")
    for k in ("actions", "mus", "sigmas", "values", "neglogpacs", "rewards"):
        close(ptraj[k], traj[k], k)
    if agent.has_central_value:
        close(ptraj["states"], traj["states"], "states")
    np.testing.assert_array_equal(ptraj["dones"].numpy(), traj["dones"])
    close(plast, last_values, "last values")
    # the meters count each env once, as the JAX package's: 3 envs ended
    for m in ("game_rewards", "game_lengths"):
        got, want = getattr(state, m), getattr(after, m)
        assert int(got.count) == int(want.count) == 3 and int(got.ptr) == int(want.ptr), m
        close(got.buf[:-1], np.asarray(want.buf)[:got.capacity], m)
    close(state.current_rewards, after.current_rewards, "current rewards")
    close(state.current_lengths, after.current_lengths, "current lengths")


def test_update_matches_jax(jax_run):
    """One update of the multi-agent agent from the JAX trajectory, the
    central value net's epochs first where there is one."""
    params, jagent, _, after, traj, last_values = jax_run
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, None)
    agent, state = port_agent(params, after)
    ptraj = {k: t(v) for k, v in traj.items() if k != "obses"}
    ptraj["obses"] = t(traj["obses"]["obs"])
    state, pm = agent._finish_epoch(state, ptraj, t(last_values))
    pairs = [(agent.model, jnew.params, jnew.norm)]
    if agent.has_central_value:
        pairs.append((agent.cv_model, jnew.cv_params, jnew.cv_norm))
    for model, p, n in pairs:
        expected = jax_to_state_dict(to_np(p), to_np(n))
        assert sorted(expected) == sorted(model.state_dict())
        for name, got in model.state_dict().items():
            tol = dict(rtol=0, atol=2e-6) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)
    jm = to_np(jm)
    keys = ("a_loss", "c_loss", "kl", "entropy") + (("cval_loss",) if agent.has_central_value else ())
    for k in keys:
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(state.opt_state.count) == 2 * (16 * 24 // 128)


def test_clear_stats_sizes_rows():
    """Every accumulator N · A rows (ppo.py:1558-1570): the next epoch's
    rollout adds [N · A] rewards to them."""
    agent = PPOAgent("t", ma_config(), device="cpu")
    assert agent.num_agents == 3 and agent.num_rows == 24 and agent.batch_size == 16 * 8 * 3
    state = agent.clear_stats(agent.init_state())
    assert state.current_rewards.shape == state.current_shaped_rewards.shape == (24, 1)
    assert state.current_lengths.shape == (24,)
    state, m = agent.train_epoch(state)
    assert state.current_rewards.shape == (24, 1) and np.isfinite(float(m["a_loss"]))


# ---------------------------------------------------------------------------
# tests/test_multiagent.py's tests, with their gates
# ---------------------------------------------------------------------------


def test_multiagent_ppo_learns():
    agent = PPOAgent("t", ma_params(), device="cpu")
    assert agent.num_agents == 3
    assert agent.batch_size == 16 * 8 * 3
    state = agent.init_state()
    fn = agent.make_train_fn()
    m = None
    for _ in range(120):
        state, m = fn(state)
    # random ~ -0.7*64 steps; near-optimal approaches small negative values
    assert float(m["mean_rewards"][0]) > -20.0


def test_multiagent_central_value():
    agent = PPOAgent("t", ma_config(cv=True), device="cpu")
    state = agent.init_state()
    state, m = agent.make_train_fn()(state)
    assert np.isfinite(float(m["cval_loss"]))


# ---------------------------------------------------------------------------
# pettingzoo's multiwalker on the host
# ---------------------------------------------------------------------------


def test_multiwalker_vecenv_rows_and_autoreset():
    from rl_games_tpu_torch.envs.host.pettingzoo_env import MultiWalkerVecEnv

    env = MultiWalkerVecEnv(2, central_value=True, apply_agent_ids=True, seed=3, max_cycles=2)
    info = env.get_env_info()
    assert info.agents == 3
    core = env.state_dim // 3
    assert info.observation_space.shape == (core + 3,)
    assert info.state_space.shape == (3 * core,)

    obs = env.reset()
    assert obs["obs"].shape == (6, core + 3)
    assert obs["states"].shape == (6, 3 * core)
    # agent-id one-hots in agents-minor order
    np.testing.assert_allclose(obs["obs"][:3, core:], np.eye(3))
    # per-row states identical within an env
    np.testing.assert_allclose(obs["states"][0], obs["states"][2])

    acts = np.zeros((6, env.action_dim), np.float32)
    for _ in range(2):
        obs, rewards, dones, infos = env.step(acts)
        assert rewards.shape == (6,)
        assert dones.shape == (6,)
        if dones.any():
            break
    assert dones.all(), "episode must end within max_cycles"
    # time_outs only ever marks done rows (trunc & ~term)
    assert infos["time_outs"].dtype == bool
    assert not np.any(infos["time_outs"] & ~dones)
    assert infos["final_observation"]["obs"].shape == (6, core + 3)
    # post-done obs is the fresh episode's first rows, not the final rows
    assert not np.allclose(obs["obs"], infos["final_observation"]["obs"])
    env.close()


def test_multiwalker_matches_jax():
    """Port and JAX env under seed 5 with the same actions, 30 steps with
    max_cycles 12 (two autoresets an env) and use_prev_actions: every
    array bit for bit (the same pettingzoo code runs under both)."""
    kw = dict(central_value=True, use_prev_actions=True, apply_agent_ids=True, seed=5, max_cycles=12)
    port = registry.create_vec_env("multiwalker_env", 3, device="cpu", **kw)
    jenv = jregistry.create_vec_env("multiwalker_env", 3, **kw)
    assert port.get_env_info().observation_space.shape == jenv.get_env_info().observation_space.shape
    obs, jobs = port.reset(), jenv.reset()
    for k in ("obs", "states"):
        np.testing.assert_array_equal(obs[k], jobs[k])
    rng = np.random.default_rng(1)
    done_steps = 0
    for i in range(30):
        a = rng.uniform(-1.0, 1.0, (9, port.action_dim)).astype(np.float32)
        got, want = port.step(a), jenv.step(a)
        for k in ("obs", "states"):
            np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=f"{k} at step {i}")
        for j in (1, 2):
            np.testing.assert_array_equal(got[j], want[j])
        assert sorted(got[3]) == sorted(want[3])
        np.testing.assert_array_equal(got[3]["time_outs"], want[3]["time_outs"])
        if "final_observation" in want[3]:
            for k in ("obs", "states"):
                np.testing.assert_array_equal(got[3]["final_observation"][k], want[3]["final_observation"][k])
        done_steps += int(got[2].any())
    assert done_steps >= 2
    port.close()
    jenv.close()


def test_multiwalker_host_epoch_counts_envs(tmp_path):
    """ref/ppo_multiwalker.yaml through Runner.create_agent, shrunk to 4 envs
    x horizon 24 with max_cycles 10: a host epoch over 12 rows with the
    central value net reading the host 'states'; the meters count each env
    once a finished episode."""
    import yaml

    doc = yaml.safe_load((ROOT / "rl_games_tpu/configs/ref/ppo_multiwalker.yaml").read_text())
    cfg = doc["params"]["config"]
    cfg.update(num_actors=4, horizon_length=24, minibatch_size=96, mini_epochs=1, train_dir=str(tmp_path))
    cfg["env_config"].update(max_cycles=10, seed=2)
    cfg["central_value_config"].update(minibatch_size=96, mini_epochs=1)
    runner = Runner(device="cpu")
    runner.load(doc)
    agent = runner.create_agent()
    assert agent.is_host_env and agent.has_central_value and agent.num_rows == 12
    assert agent.state_shape == (agent.vec_env.state_dim,)
    state = agent.init_state()
    traj, last_values = agent._host_rollout(state)
    assert traj["states"].shape == (24, 12, agent.vec_env.state_dim)
    # the dones each step produced, at each env's first row
    ended = torch.cat([traj["dones"][1:], state.dones[None]])[:, ::3]
    assert ended.sum() >= 8  # 10-cycle episodes: two an env at least in 24 steps
    state, m = agent._finish_epoch(state, traj, last_values)
    assert np.isfinite(float(m["cval_loss"])) and np.isfinite(float(m["a_loss"]))
    assert int(m["games_played"]) == int(ended.sum())
    assert state.current_rewards.shape == (12, 1)


def test_players_count_each_env_once(capsys):
    """The player over N · A rows counts an env's episode once, at its first
    agent row, as the trainer's meters do (the JAX player's accumulator has
    N rows and fails on the N · A rewards: ROADMAP.md §3, fault 8): on the
    device, 8 cooperative_gather envs end one 64-step episode each in 70
    steps; on the host, 2 multiwalker envs of 5 cycles, 3 episodes each."""
    from rl_games_tpu_torch.common.player import PpoPlayer

    params = ma_params()
    params["config"]["player"] = {"games_num": 100, "max_steps": 70}
    player = PpoPlayer(params, device="cpu")
    assert player.num_rows == 24 and player.steps_needed(100) == 70
    assert np.isfinite(player.run())
    assert "games played: 8" in capsys.readouterr().out

    params = ma_params(env_name="multiwalker_env", num_actors=2, env_config={"max_cycles": 5, "seed": 1})
    params["config"]["player"] = {"games_num": 6, "max_steps": 100}
    player = PpoPlayer(params, device="cpu")
    assert player.is_host_env and player.num_rows == 6
    assert np.isfinite(player.run())
    assert "games played: 6" in capsys.readouterr().out
