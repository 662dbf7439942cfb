"""The port's central value net (asymmetric actor-critic) against the JAX
package.

- One epoch of shrunk ref/test/test_asymmetric_continuous.yaml (separate
  LSTM actor trunks with a layer norm, an LSTM central value net with its
  own input normalizer, the value normalizer on the central net) on the
  device test_asymmetric_continuous_env: the rollout with the JAX
  rollout's normals handed over (the values from the central net, both
  nets' window states), then the update from the JAX trajectory: the
  central value net's epochs (its Adam, its minibatches, whole sequences)
  before the actor's. Weights at 2e-6 absolute, the normalizers at rtol
  1e-5, the losses at rtol 1e-4 (test_torch_port_test_envs.py's
  tolerances).
- The central value net at value_size 2 (test_asymmetric_discrete_mhv.yaml
  with multi_head_value): one update from the JAX trajectory.
- A host epoch over a fake {'obs', 'states'} host env (the JAX package's
  tests/test_host_envs.py::test_ppo_host_central_value_trains env), the
  JAX draws handed over: plain nets, then an LSTM actor and an LSTM central
  value net (the host rollout's window states).
- Checkpoints: the central value net in its section, a resume, and
  ``load_critic_only`` (the central net's weights, normalizers and Adam
  moments from a file, nothing else), through the Runner too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.envs import spaces as jspaces
from rl_games_tpu_torch.algos.ppo import CV_SECTION, PPOAgent
from rl_games_tpu_torch.envs import spaces as tspaces
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict
from test_torch_port_test_envs import load, port_agent, t, to_np

torch.set_num_threads(1)
N = 16


def close(got, want, err_msg="", rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


def with_cv(agent, jstate):
    """The JAX state's central value net (weights and normalizers) and its
    recurrent states in the port agent."""
    agent.cv_model.load_state_dict(jax_to_state_dict(to_np(jstate.cv_params), to_np(jstate.cv_norm)))


def states_of(x):
    return None if x is None else tuple(t(s) for s in x)


def check_weights(agent, jnew, atol=2e-6):
    """The actor's and the central net's weights at ``atol`` absolute, their
    normalizer stats at rtol 1e-5."""
    for model, params, norm in ((agent.model, jnew.params, jnew.norm), (agent.cv_model, jnew.cv_params, jnew.cv_norm)):
        expected = jax_to_state_dict(to_np(params), to_np(norm))
        assert sorted(expected) == sorted(model.state_dict())
        for name, got in model.state_dict().items():
            tol = dict(rtol=0, atol=atol) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)


def check_losses(pm, jm, keys=("a_loss", "c_loss", "cval_loss", "kl", "entropy")):
    jm = to_np(jm)
    for k in keys:
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)


def asym_continuous_params(**config):
    params = load("ref/test/test_asymmetric_continuous.yaml")
    cfg = params["config"]
    cfg.update({"num_actors": N, "horizon_length": 16, "minibatch_size": 64, "mini_epochs": 2, **config})
    cfg["central_value_config"].update(minibatch_size=64, mini_epochs=2)
    return params


def test_asymmetric_continuous_epoch_matches_jax(monkeypatch):
    params = asym_continuous_params()
    jagent = JPPOAgent("jax", params)
    assert jagent.is_rnn and jagent.cv_is_rnn and not jagent.has_value_loss
    jstate = jagent.init_state()
    after, traj, last_values, snapshots = jax.jit(jagent._rollout)(jstate)
    traj, last_values, snapshots = to_np(traj), np.asarray(last_values), to_np(snapshots)
    noise = iter(t((traj["actions"] - traj["mus"]) / traj["sigmas"]))
    monkeypatch.setattr(D, "normal_sample", lambda mean, std, generator=None: mean + std * next(noise))
    agent, state = port_agent(params, jstate)
    with_cv(agent, jstate)
    state.rnn_states, state.cv_rnn_states = states_of(jstate.rnn_states), states_of(jstate.cv_rnn_states)
    ptraj, plast = agent._rollout(state)
    # the classic envs' float32 arithmetic agrees in the last bits (rtol 1e-5)
    close(ptraj["states"], traj["states"], "states")
    close(ptraj["obses"], traj["obses"]["obs"], "obses")
    for k in ("actions", "mus", "sigmas", "values", "neglogpacs", "rewards"):
        close(ptraj[k], traj[k], k)
    close(plast, last_values, "last values")
    for key, snaps in (("rnn_snapshots", snapshots[0]), ("cv_rnn_snapshots", snapshots[1])):
        assert len(ptraj[key]) == len(snaps)
        for got, want in zip(ptraj[key], snaps):
            close(got, want, key)
    for got, want in zip(state.cv_rnn_states, after.cv_rnn_states):
        close(got, want, "cv states after")

    # the update from the JAX trajectory
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, snapshots)
    agent2, state2 = port_agent(asym_continuous_params(), after)
    with_cv(agent2, after)
    ptraj = {k: t(v) for k, v in traj.items() if k != "obses"}
    ptraj["obses"] = t(traj["obses"]["obs"])
    ptraj["rnn_snapshots"], ptraj["cv_rnn_snapshots"] = states_of(snapshots[0]), states_of(snapshots[1])
    state2, pm = agent2._finish_epoch(state2, ptraj, t(last_values))
    check_weights(agent2, jnew)
    check_losses(pm, jm)
    assert float(pm["c_loss"]) == 0.0  # the central net owns the value loss
    assert int(state2.cv_opt.count) == 2 * (N * 16 // 64) and int(state2.opt_state.count) == 2 * (N * 16 // 64)


def test_central_value_two_heads_update_matches_jax():
    """test_asymmetric_discrete_mhv.yaml with multi_head_value on: the
    central net's values, returns and value normalizer per head (V = 2);
    its minibatch (512 of a batch of 640) drops the tail."""
    params = load("ref/test/test_asymmetric_discrete_mhv.yaml")
    cfg = params["config"]
    cfg["env_config"]["multi_head_value"] = True
    cfg.update(num_actors=N, horizon_length=40, seq_length=8, minibatch_size=320, mini_epochs=1)
    cfg["central_value_config"].update(minibatch_size=512, mini_epochs=1)
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    after, traj, last_values, snapshots = jax.jit(jagent._rollout)(jstate)
    traj, last_values, snapshots = to_np(traj), np.asarray(last_values), to_np(snapshots)
    assert traj["values"].shape == (40, N, 2) and traj["dones"][1:].any()
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, snapshots)
    agent, state = port_agent(params, after)
    with_cv(agent, after)
    assert agent.cv_num_minibatches == 1
    ptraj = {k: t(v) for k, v in traj.items() if k != "obses"}
    ptraj["obses"] = t(traj["obses"]["obs"])
    ptraj["rnn_snapshots"], ptraj["cv_rnn_snapshots"] = states_of(snapshots[0]), states_of(snapshots[1])
    state, pm = agent._finish_epoch(state, ptraj, t(last_values))
    assert agent.cv_model.value_mean_std.running_mean.shape == (2,)
    check_weights(agent, jnew)
    check_losses(pm, jm)


# ---------------------------------------------------------------------------
# over a host env
# ---------------------------------------------------------------------------


class FakeAsymHostEnv:
    """tests/test_host_envs.py's host env with {'obs', 'states'}
    observations; ``spaces`` is either package's spaces module."""

    is_host_env = True
    autoreset_mode = "same_step"
    max_episode_steps = 20

    def __init__(self, n, spaces):
        self.n, self.spaces = n, spaces
        self.t = np.zeros(n, np.int64)

    def get_env_info(self):
        s = self.spaces
        return s.EnvInfo(observation_space=s.Box(shape=(3,)), action_space=s.Box(shape=(1,), low=-1.0, high=1.0),
                         state_space=s.Box(shape=(5,)))

    def _make(self):
        obs = np.stack([np.arange(self.n), self.t, np.sin(self.t)], -1).astype(np.float32)
        states = np.concatenate([obs, np.cos(self.t)[:, None], (self.t % 5)[:, None]], -1).astype(np.float32)
        return {"obs": obs, "states": states}

    def reset(self):
        return self._make()

    def step(self, actions):
        self.t += 1
        done = self.t >= 8
        rewards = np.sin(0.3 * self.t).astype(np.float32)
        final = self._make()
        self.t[done] = 0
        return self._make(), rewards, done, {"time_outs": np.zeros(self.n, bool), "final_observation": final}


def host_cv_params(rnn: bool):
    mlp = {"units": [16], "activation": "elu", "initializer": {"name": "default"}}
    network = {"name": "actor_critic", "separate": False, "mlp": mlp,
               "space": {"continuous": {"mu_activation": "None", "sigma_activation": "None",
                                        "mu_init": {"name": "default"},
                                        "sigma_init": {"name": "const_initializer", "val": 0.0},
                                        "fixed_sigma": True}}}
    cv_network = {"name": "actor_critic", "central_value": True, "mlp": mlp}
    if rnn:
        network["rnn"] = {"name": "lstm", "units": 8, "layers": 1}
        cv_network["rnn"] = {"name": "gru", "units": 8, "layers": 1}
    return {
        "algo": {"name": "a2c_continuous"}, "model": {"name": "continuous_a2c_logstd"}, "network": network,
        "config": {
            "env_name": "fake", "num_actors": 4, "horizon_length": 16, "seq_length": 4,
            "minibatch_size": 32, "mini_epochs": 1, "learning_rate": 1e-3,
            "e_clip": 0.2, "clip_value": False, "gamma": 0.99, "tau": 0.95,
            "critic_coef": 1.0, "entropy_coef": 0.0, "grad_norm": 1.0,
            "normalize_advantage": True, "normalize_input": False,
            "normalize_value": True, "value_bootstrap": False, "seed": 3,
            "central_value_config": {"learning_rate": 1e-3, "mini_epochs": 1, "minibatch_size": 32,
                                     "clip_value": False, "normalize_input": True, "network": cv_network},
        },
    }


@pytest.mark.parametrize("rnn", [False, True], ids=["mlp", "lstm_actor_gru_central"])
def test_host_central_value_epoch_matches_jax(rnn, monkeypatch):
    """One host epoch of both packages over the same fake env: the
    trajectory ({'obs', 'states'} uploaded together, the values from the
    central net), with an RNN each window's states (taken at t %
    seq_length == 0), and both nets after the update."""
    jagent = JPPOAgent("jax", host_cv_params(rnn), vec_env=FakeAsymHostEnv(4, jspaces))
    jstate = jagent.init_state()
    policy_step, finish = jagent._make_host_fns()
    seen = {}

    def capture(state, traj, last_values, rnn_snapshots):
        seen.update(traj=dict(traj), last_values=last_values, snapshots=rnn_snapshots)
        return finish(state, traj, last_values, rnn_snapshots)

    jagent._host_fns = (policy_step, capture)
    jafter, jm = jagent.host_train_epoch(jstate)
    jtraj, jsnaps = to_np(seen["traj"]), to_np(seen["snapshots"])

    agent = PPOAgent("port", host_cv_params(rnn), device="cpu", vec_env=FakeAsymHostEnv(4, tspaces))
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    with_cv(agent, jstate)
    assert isinstance(state.obs, dict) and set(state.obs) == {"obs", "states"}
    noise = iter(t((jtraj["actions"] - jtraj["mus"]) / jtraj["sigmas"]))
    monkeypatch.setattr(D, "normal_sample", lambda mean, std, generator=None: mean + std * next(noise))
    got = {}
    finish_port = agent._finish_epoch

    def capture_port(state, traj, last_values):
        got.update(traj=dict(traj), last_values=last_values)
        return finish_port(state, traj, last_values)

    monkeypatch.setattr(agent, "_finish_epoch", capture_port)
    state, pm = agent.make_train_fn()(state)
    traj = got["traj"]
    np.testing.assert_array_equal(traj["states"].numpy(), jtraj["states"])
    np.testing.assert_array_equal(traj["obses"].numpy(), jtraj["obses"]["obs"])
    for k in ("actions", "values", "neglogpacs", "rewards"):
        close(traj[k], jtraj[k], k)
    close(got["last_values"], seen["last_values"], "last values")
    if rnn:
        for key, snaps in (("rnn_snapshots", jsnaps[0]), ("cv_rnn_snapshots", jsnaps[1])):
            assert len(traj[key]) == len(snaps) and traj[key][0].shape[0] == 4
            for a, b in zip(traj[key], snaps):
                close(a, b, key)
        for a, b in zip(state.cv_rnn_states, jafter.cv_rnn_states):
            close(a, b, "cv states after")
    else:
        assert "rnn_snapshots" not in traj and state.rnn_states is None
    check_weights(agent, jafter, atol=5e-6)
    check_losses(pm, jm)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def small_asym_params(tmp_path, **config):
    params = asym_continuous_params(train_dir=str(tmp_path), max_epochs=1, print_stats=False, **config)
    params["config"].update(num_actors=4, minibatch_size=32)
    params["config"]["central_value_config"]["minibatch_size"] = 32
    return params


def test_checkpoint_carries_central_value_net_and_resumes(tmp_path):
    agent = PPOAgent("a", small_asym_params(tmp_path), device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    path = str(tmp_path / "a.pth")
    agent._save(path, state, {"epoch": 1})
    payload = ckpt.read_payload(path)
    assert sorted(payload[CV_SECTION]) == sorted(f"model.{k}" for k in agent.cv_model.state_dict())
    assert "model.running_mean_std.running_mean" in payload[CV_SECTION]  # its own input normalizer
    other = PPOAgent("b", small_asym_params(tmp_path, seed=99), device="cpu")
    other_state = other.init_state()
    other._load_sections(payload)
    resumed, _ = ckpt.load_checkpoint(path, other_state, payload=payload)
    for k, v in agent.cv_model.state_dict().items():
        assert torch.equal(v, other.cv_model.state_dict()[k]), k
    for a, b in zip(state.cv_rnn_states, resumed.cv_rnn_states):
        assert torch.equal(a, b)
    assert torch.equal(state.cv_opt.nu[0], resumed.cv_opt.nu[0]) and int(resumed.cv_opt.count) == 4
    full = agent.get_full_state_weights(state)
    assert CV_SECTION in full


def test_load_critic_only_round_trip(tmp_path):
    """restore_central_value_only takes the central net's weights, its
    normalizers and Adam moments from the file and leaves the actor as it
    was; the Runner's load_critic_only goes through it; without a central
    value net it is refused, as in the JAX package."""
    from rl_games_tpu_torch.runner import Runner

    agent = PPOAgent("a", small_asym_params(tmp_path), device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    path = str(tmp_path / "a.pth")
    agent._save(path, state, {"epoch": 1})
    fresh = PPOAgent("b", small_asym_params(tmp_path, seed=99), device="cpu")
    fresh_state = fresh.init_state()
    actor_before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    fresh_state = fresh.restore_central_value_only(path, fresh_state)
    for k, v in agent.cv_model.state_dict().items():
        assert torch.equal(v, fresh.cv_model.state_dict()[k]), k
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, actor_before[k]), k
    assert int(fresh_state.cv_opt.count) == int(state.cv_opt.count) and int(fresh_state.opt_state.count) == 0
    assert torch.equal(fresh_state.cv_opt.mu[0], state.cv_opt.mu[0])

    runner = Runner(device="cpu")
    runner.load({"params": small_asym_params(tmp_path / "runner", seed=99)})
    seen = []
    restore = PPOAgent.restore_central_value_only

    def spy(self, checkpoint, state, payload=None):
        seen.append(checkpoint)
        return restore(self, checkpoint, state, payload)

    PPOAgent.restore_central_value_only = spy
    try:
        assert runner.run({"train": True, "checkpoint": path, "load_critic_only": True})[1] == 1
    finally:
        PPOAgent.restore_central_value_only = restore
    assert seen == [path]
    plain = load("ref/test/test_discrete.yaml")
    plain["config"].update(num_actors=4, horizon_length=8, minibatch_size=32)
    with pytest.raises(ValueError, match="asymmetric actor critic"):
        PPOAgent("c", plain, device="cpu").restore_central_value_only(path, None)
