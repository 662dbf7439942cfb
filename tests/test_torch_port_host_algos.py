"""PPO, SAC and the players over host envs, the port against the JAX package.

- One PPO host epoch (``host_train_epoch``) on a deterministic fake host
  env (tests/test_host_envs.py's ``_FakeSameStepEnv``, with a
  step-dependent reward and time-outs on one env), from the JAX agent's
  weights, with the JAX rollout's action noise recovered as
  (actions − mus) / sigmas and injected, as
  test_torch_port_ppo.py::test_rollout_matches_jax does it; in both
  placements of the rollout's policy. Tolerances as in that file: what the
  policy computes at rtol = atol = 1e-5 (float32 in another summation
  order; the fake env's observations do not depend on the actions, so
  nothing compounds), observations, dones, shaped rewards and the episode
  meters exactly (at rtol 1e-6 where a time-out adds gamma times a value
  to a shaped reward), the advantages at 1e-5 and the weights after the epoch's
  4 Adam steps at rtol 1e-5 / atol 5e-6.
- One SAC host epoch in both autoreset modes on tests/test_sac_correctness.py's
  fake host env, with the actions the JAX agent sent to its env handed to
  the port's: the replay rows bit for bit, the normalizer at rtol 1e-6.
- The port's counterparts of the JAX host tests (tests/test_host_envs.py,
  tests/test_sac_correctness.py, tests/test_cpuenv.py's learning test) and
  the CLI over gymnasium's HalfCheetah and Ant on the CPU.

The two JAX programs here (the PPO host epoch, the SAC host step) compile
in a few seconds each on the CPU.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.algos.sac import SACAgent as JSACAgent
from rl_games_tpu.envs import spaces as jspaces
from rl_games_tpu_torch import __main__ as cli
from rl_games_tpu_torch.algos import sac as tsac
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.algos.sac import SACAgent
from rl_games_tpu_torch.common.host_inference import rollout_device
from rl_games_tpu_torch.common.player import PpoPlayer, SACPlayer
from rl_games_tpu_torch.envs import spaces as tspaces
from rl_games_tpu_torch.envs.host.gymnasium_env import GymnasiumVecEnv
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict, sac_jax_to_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# fake host envs (obs encode env, episode and step, so rows are checkable)
# ---------------------------------------------------------------------------


class FakeSameStepEnv:
    """tests/test_host_envs.py's _FakeSameStepEnv: obs = [env id, episode,
    step], staggered episode lengths, same-step autoreset; here the reward
    is 0.5 + 0.1·step and the episodes of the envs in ``truncate`` end as
    time-outs."""

    is_host_env = True
    autoreset_mode = "same_step"
    max_episode_steps = 100

    def __init__(self, lengths, spaces, truncate=()):
        self.lengths = np.asarray(lengths)
        self.n = len(lengths)
        self.spaces = spaces
        self.truncate = np.isin(np.arange(self.n), truncate)
        self.step_count = np.zeros(self.n, np.int64)
        self.episode = np.zeros(self.n, np.int64)
        self.actions = []

    def get_env_info(self):
        return self.spaces.EnvInfo(observation_space=self.spaces.Box(shape=(3,)),
                                   action_space=self.spaces.Box(shape=(1,), low=-1.0, high=1.0))

    def _obs(self):
        return np.stack([np.arange(self.n), self.episode, self.step_count], -1).astype(np.float32)

    def reset(self):
        return self._obs()

    def step(self, actions):
        self.actions.append(np.array(actions, copy=True))
        self.step_count += 1
        done = self.step_count >= self.lengths
        final = self._obs()
        rewards = (0.5 + 0.1 * self.step_count).astype(np.float32)
        self.episode[done] += 1
        self.step_count[done] = 0
        return self._obs(), rewards, done, {"time_outs": done & self.truncate, "final_observation": final}


class FakeHostEnv:
    """tests/test_sac_correctness.py's _FakeHostEnv: obs = [env id, episode,
    step]; reward = 100·id + step; both autoreset modes (next-step: the row
    after a done ignores its action, resets and rewards 0)."""

    is_host_env = True
    max_episode_steps = 1000

    def __init__(self, lengths, spaces, autoreset_mode="same_step", truncate=False):
        self.lengths = np.asarray(lengths)
        self.autoreset_mode = autoreset_mode
        self.truncate = truncate
        self.spaces = spaces
        self.n = len(lengths)
        self.step_count = np.zeros(self.n, np.int64)
        self.episode = np.zeros(self.n, np.int64)
        self.pending_reset = np.zeros(self.n, bool)
        self.actions = []

    def get_env_info(self):
        return self.spaces.EnvInfo(observation_space=self.spaces.Box(shape=(3,)),
                                   action_space=self.spaces.Box(shape=(1,), low=-1.0, high=1.0))

    def _obs(self):
        return np.stack([np.arange(self.n), self.episode, self.step_count], -1).astype(np.float32)

    def reset(self):
        return self._obs()

    def step(self, actions):
        self.actions.append(np.array(actions, copy=True))
        rewards = np.zeros(self.n, np.float32)
        if self.autoreset_mode == "next_step":
            resetting = self.pending_reset.copy()
            self.episode[resetting] += 1
            self.step_count[resetting] = 0
            self.pending_reset[resetting] = False
            stepping = ~resetting
        else:
            stepping = np.ones(self.n, bool)
        self.step_count[stepping] += 1
        rewards[stepping] = 100.0 * np.arange(self.n)[stepping] + self.step_count[stepping]
        done = (self.step_count >= self.lengths) & stepping
        final = self._obs()
        if self.autoreset_mode == "same_step":
            self.episode[done] += 1
            self.step_count[done] = 0
        else:
            self.pending_reset |= done
        return self._obs(), rewards, done, {"time_outs": done & self.truncate, "final_observation": final}


# ---------------------------------------------------------------------------
# PPO: one host epoch against the JAX package's
# ---------------------------------------------------------------------------


def continuous_params(**config):
    return {
        "algo": {"name": "a2c_continuous"},
        "model": {"name": "continuous_a2c_logstd"},
        "network": {
            "name": "actor_critic", "separate": False,
            "mlp": {"units": [16, 8], "activation": "elu", "initializer": {"name": "default"}},
            "space": {"continuous": {
                "mu_activation": "None", "sigma_activation": "None", "mu_init": {"name": "default"},
                "sigma_init": {"name": "const_initializer", "val": 0.0}, "fixed_sigma": True,
            }},
        },
        "config": {
            "env_name": "fake", "num_actors": 4, "horizon_length": 16, "minibatch_size": 32,
            "mini_epochs": 2, "learning_rate": 5e-4, "lr_schedule": "adaptive", "kl_threshold": 0.008,
            "e_clip": 0.2, "clip_value": False, "gamma": 0.99, "tau": 0.95, "critic_coef": 4.0,
            "entropy_coef": 0.0, "grad_norm": 1.0, "truncate_grads": True, "normalize_advantage": True,
            "normalize_input": True, "normalize_value": True, "value_bootstrap": True,
            "use_smooth_clamp": True, "reward_shaper": {"scale_value": 0.1}, "bounds_loss_coef": 0.0,
            "seed": 3, **config,
        },
    }


LENGTHS, TRUNCATE = [3, 5, 4, 7], (1,)


@pytest.fixture(scope="module")
def jax_ppo_epoch():
    """One JAX host epoch: its state before, the trajectory and bootstrap
    values its finish step got, its dataset, and the state after."""
    env = FakeSameStepEnv(LENGTHS, jspaces, TRUNCATE)
    jagent = JPPOAgent("jax", continuous_params(), vec_env=env)
    jstate = jagent.init_state()
    policy_step, finish = jagent._make_host_fns()
    seen = {}

    def capture(state, traj, last_values, rnn_snapshots):
        seen.update(state=state, traj=dict(traj), last_values=last_values)
        return finish(state, traj, last_values, rnn_snapshots)

    jagent._host_fns = (policy_step, capture)
    after, metrics = jagent.host_train_epoch(jstate)
    traj = {k: v for k, v in seen["traj"].items() if k != "env_rewards"}
    _, dataset, _ = jax.jit(jagent._prepare_dataset)(seen["state"], traj, seen["last_values"], None)
    return jstate, to_np(seen["traj"]), np.asarray(seen["last_values"]), to_np(dataset), after, to_np(metrics)


@pytest.mark.parametrize("placement", ["default", "cpu"])
def test_ppo_host_epoch_matches_jax(jax_ppo_epoch, placement, monkeypatch):
    jstate, jtraj, jlast, jdataset, jafter, jm = jax_ppo_epoch
    agent = PPOAgent("port", continuous_params(host_inference_device=placement), device="cpu",
                     vec_env=FakeSameStepEnv(LENGTHS, tspaces, TRUNCATE))
    if placement == "cpu":
        # on a CPU agent both placements are the CPU; a copy of the model
        # takes the rollout's forwards, as on a card, and must be handed the
        # weights below at the epoch's start
        agent._rollout_model = copy.deepcopy(agent.model)
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    noise = iter(torch.from_numpy((jtraj["actions"] - jtraj["mus"]) / jtraj["sigmas"]))
    monkeypatch.setattr(D, "normal_sample", lambda mean, std, generator=None: mean + std * next(noise))
    seen = {}
    finish, update = agent._finish_epoch, agent._update

    def capture_finish(state, traj, last_values):
        seen.update(traj={k: v.clone() for k, v in traj.items()}, last_values=last_values)
        return finish(state, traj, last_values)

    def capture_update(state, dataset):
        seen["dataset"] = {k: v.clone() for k, v in dataset.items()}
        return update(state, dataset)

    monkeypatch.setattr(agent, "_finish_epoch", capture_finish)
    monkeypatch.setattr(agent, "_update", capture_update)
    state, pm = agent.make_train_fn()(state)

    traj = {k: v.numpy() for k, v in seen["traj"].items()}
    for k in ("obses", "dones"):  # from the env: exactly
        np.testing.assert_array_equal(traj[k], jtraj[k], err_msg=k)
    # the shaped rewards exactly, but where a time-out adds gamma * value
    bootstrapped = jtraj["rewards"] != np.float32(0.1) * jtraj["env_rewards"]
    assert jtraj["dones"][1:].any() and bootstrapped.any()
    np.testing.assert_array_equal(traj["rewards"][~bootstrapped], jtraj["rewards"][~bootstrapped])
    for k in ("actions", "mus", "sigmas", "values", "neglogpacs", "rewards"):
        np.testing.assert_allclose(traj[k], jtraj[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(seen["last_values"].numpy(), jlast, rtol=1e-5, atol=1e-5)
    for k in ("advantages", "returns", "old_values"):
        np.testing.assert_allclose(seen["dataset"][k].numpy(), jdataset[k], rtol=1e-5, atol=1e-5, err_msg=k)
    expected = jax_to_state_dict(to_np(jafter.params), to_np(jafter.norm))
    for name, value in agent.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[name].numpy(), rtol=1e-5, atol=5e-6, err_msg=name)
    for k in ("a_loss", "c_loss", "kl", "entropy"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # the episode accounting and the meters exactly; the shaped sums carry
    # the time-outs' gamma * value, so at rtol 1e-6
    for k in ("current_rewards", "current_shaped_rewards", "current_lengths"):
        np.testing.assert_allclose(getattr(state, k).numpy(), np.asarray(getattr(jafter, k)), err_msg=k,
                                   rtol=1e-6 if "shaped" in k else 0, atol=0)
    for k in ("game_rewards", "game_shaped_rewards", "game_lengths"):
        got, want = getattr(state, k), getattr(jafter, k)
        np.testing.assert_allclose(got.buf[:-1].numpy(), np.asarray(want.buf), err_msg=k,
                                   rtol=1e-6 if "shaped" in k else 0, atol=0)
        assert int(got.ptr) == int(want.ptr) and int(got.count) == int(want.count) > 0
    np.testing.assert_array_equal(pm["mean_rewards"].numpy(), jm["mean_rewards"])
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(jafter.obs))
    assert int(state.frame) == int(jafter.frame) == 64
    timing = agent._last_timing
    assert 0 < timing["step_time"] < timing["play_time"]


def test_ppo_host_placements_agree():
    """host_inference_device cpu and default train alike (on a CPU agent both
    run on the CPU; cpu through a copy of the model, refreshed each epoch),
    over gymnasium's CartPole for 3 epochs (test_host_envs.py's
    test_ppo_host_inference_device_cpu_matches_default)."""
    def run(placement):
        params = discrete_params(num_actors=4, horizon_length=16, minibatch_size=32, mini_epochs=2, seed=3,
                                 env_config={"seed": 3}, host_inference_device=placement)
        agent = PPOAgent("t", params, device="cpu")
        if placement == "cpu":
            agent._rollout_model = copy.deepcopy(agent.model)
        state = agent.init_state()
        for _ in range(3):
            state, m = agent.make_train_fn()(state)
        return m, agent.model.state_dict()

    (m_cpu, w_cpu), (m_def, w_def) = run("cpu"), run("default")
    for k in ("mean_rewards", "a_loss", "c_loss", "entropy", "kl"):
        np.testing.assert_array_equal(m_cpu[k].numpy(), m_def[k].numpy(), err_msg=k)
    for k in w_cpu:
        assert torch.equal(w_cpu[k], w_def[k]), k


MLP = {"mlp": {"units": [128, 64, 32], "activation": "elu"}}
CNN = {"cnn": {"type": "conv2d", "convs": []}, "mlp": {"units": [512], "activation": "relu"}}
FUSED = {"mlp": {"units": [128, 64, 32], "activation": "elu", "fused": True}}


@pytest.mark.parametrize("preference, device, network, want", [
    ("auto", "cuda", MLP, "cpu"),  # an MLP policy: the CPU copy, faster at halfcheetah.yaml's geometry
    (None, "cuda", MLP, "cpu"),
    ("auto", "cuda", CNN, "cuda"),  # a conv torso: the card, faster at ref/atari's geometry
    ("auto", "cuda", FUSED, "cuda"),  # the fused kernel runs only on the card
    ("cpu", "cuda", FUSED, "cpu"),  # asked for: the CPU copy, on the plain chain
    ("cpu", "cuda", CNN, "cpu"),
    ("default", "cuda", MLP, "cuda"),
    ("auto", "cpu", MLP, "cpu"),  # a CPU agent: both placements are the CPU
    ("auto", "cpu", CNN, "cpu"),
], ids=["mlp", "mlp_none", "cnn", "fused", "fused_cpu", "cnn_cpu", "mlp_default", "cpu_agent_mlp", "cpu_agent_cnn"])
def test_auto_placement_follows_the_policy(preference, device, network, want):
    assert rollout_device(preference, torch.device(device), network).type == want


def test_unknown_placement_raises():
    with pytest.raises(ValueError, match="host_inference_device"):
        rollout_device("gpu", torch.device("cpu"), MLP)


def test_pixel_host_env_drives_host_epochs():
    """chip_smoke.py's PixelHostEnv (84x84x4 uint8 frames, no emulator)
    under ppo_breakout.yaml's nature-CNN, cut to 2 envs x 4 steps, in both
    placements: the frames reach the trajectory as float32, the episodes
    end on the host and the epochs train."""
    from chip_smoke import PixelHostEnv

    for placement in ("default", "cpu"):
        params = yaml.safe_load((ROOT / "rl_games_tpu/configs/ref/atari/ppo_breakout.yaml").read_text())["params"]
        params["config"].update(num_actors=2, horizon_length=4, minibatch_size=4, mini_epochs=1,
                                host_inference_device=placement)
        env = PixelHostEnv(2, seed=3)
        env.lengths = np.array([3, 5])
        agent = PPOAgent("t", params, device="cpu", vec_env=env)
        state = agent.init_state()
        torch.testing.assert_close(state.obs, torch.from_numpy(env.frames[0]).float())
        for _ in range(2):
            state, m = agent.make_train_fn()(state)
            assert all(np.isfinite(float(m[k])) for k in ("a_loss", "c_loss", "entropy"))
        assert int(state.game_lengths.count) == 3  # env 0 ended at steps 3 and 6, env 1 at step 5
        torch.testing.assert_close(state.obs, torch.from_numpy(env.frames[8 % len(env.frames)]).float())


def discrete_params(**config):
    return {
        "algo": {"name": "a2c_discrete"},
        "model": {"name": "discrete_a2c"},
        "network": {"name": "actor_critic", "separate": False,
                    "mlp": {"units": [32, 32], "activation": "elu", "initializer": {"name": "default"}},
                    "space": {"discrete": {}}},
        "config": {
            "env_name": "CartPole-v1", "vecenv_type": "GYMNASIUM", "num_actors": 16, "horizon_length": 32,
            "minibatch_size": 256, "mini_epochs": 4, "learning_rate": 3e-4, "lr_schedule": "adaptive",
            "kl_threshold": 0.008, "e_clip": 0.2, "clip_value": True, "gamma": 0.99, "tau": 0.95,
            "critic_coef": 1.0, "entropy_coef": 0.01, "grad_norm": 1.0, "truncate_grads": True,
            "normalize_advantage": True, "normalize_input": True, "normalize_value": True,
            "value_bootstrap": True, "seed": 7, **config,
        },
    }


@pytest.mark.parametrize("k", [3, 8, 21])
def test_meters_append_matches_one_row_updates(k):
    """The host path's meters take an epoch's finished episodes at once, as
    k one-row meters_update calls would, also past the ring's 8 rows."""
    from rl_games_tpu_torch.algos import ppo as tppo

    rows = torch.from_numpy(np.random.default_rng(k).normal(size=(k, 2)).astype(np.float32))
    bulk, single = tppo.meters_init(8, 2, "cpu"), tppo.meters_init(8, 2, "cpu")
    for m in (bulk, single):
        tppo.meters_update(m, torch.ones(3, 2), torch.tensor([True, False, True]))  # ptr 2
    tppo.meters_append(bulk, rows)
    for row in rows:
        tppo.meters_update(single, row[None], torch.tensor([True]))
    assert torch.equal(bulk.buf[:8], single.buf[:8])
    assert (int(bulk.ptr), int(bulk.count)) == (int(single.ptr), int(single.count))


def test_ppo_trains_on_native_env():
    """tests/test_cpuenv.py::test_ppo_trains_on_native_env: CartPole on the
    native stepper, above 60 after 60 epochs (a random policy scores about
    20)."""
    agent = PPOAgent("t", discrete_params(vecenv_type="CPUENV", env_config={"num_threads": 1}), device="cpu")
    assert agent.is_host_env and agent.rollout_device.type == "cpu"
    state = agent.init_state()
    train = agent.make_train_fn()
    for _ in range(60):
        state, m = train(state)
    assert float(m["mean_rewards"][0]) > 60.0
    assert int(m["frame"]) == 60 * 16 * 32


def test_ppo_host_dataset_has_no_garbage_rows(monkeypatch):
    """Every row after a done is a new episode's first row, and every row's
    reward is the env's (test_host_envs.py's counterpart)."""
    agent = PPOAgent("t", continuous_params(normalize_input=False, reward_shaper={}), device="cpu",
                     vec_env=FakeSameStepEnv(LENGTHS, tspaces))
    state = agent.init_state()
    seen = {}
    finish = agent._finish_epoch
    monkeypatch.setattr(agent, "_finish_epoch", lambda s, traj, lv: (seen.update(traj=traj), finish(s, traj, lv))[1])
    agent.host_train_epoch(state)
    obses, dones = seen["traj"]["obses"].numpy(), seen["traj"]["dones"].numpy()
    assert (obses[dones == 1.0][:, 2] == 0.0).all()
    assert obses[:, 0, 2].max() == 2.0  # env 0's episodes last 3 steps: 0, 1, 2
    np.testing.assert_allclose(seen["traj"]["rewards"].numpy()[..., 0], 0.5 + 0.1 * (obses[..., 2] + 1), rtol=1e-6)


def test_ppo_host_rejects_next_step_autoreset():
    env = GymnasiumVecEnv("CartPole-v1", 2, seed=0, autoreset_mode="next_step")
    with pytest.raises(ValueError, match="same_step"):
        PPOAgent("t", discrete_params(num_actors=2, horizon_length=8, minibatch_size=16), device="cpu", vec_env=env)
    env.close()


def test_ppo_host_observer_sees_every_step():
    class Observer:
        def __init__(self):
            self.calls = []

        def process_infos(self, infos, done_indices):
            self.calls.append(("infos", sorted(infos), list(done_indices)))

        def after_steps(self):
            self.calls.append(("after_steps",))

    observer = Observer()
    params = continuous_params()
    params["config"]["features"] = {"observer": observer}
    agent = PPOAgent("t", params, device="cpu", vec_env=FakeSameStepEnv(LENGTHS, tspaces))
    agent.host_train_epoch(agent.init_state())
    infos = [c for c in observer.calls if c[0] == "infos"]
    assert len(infos) == 16 and len(observer.calls) == 32
    assert infos[2] == ("infos", ["final_observation", "time_outs"], [0])  # env 0 ends after 3 steps


CV_CONFIG = {"learning_rate": 1e-3, "mini_epochs": 1, "minibatch_size": 16,
             "network": {"name": "actor_critic", "central_value": True, "mlp": {"units": [8], "activation": "elu"}}}


@pytest.mark.parametrize("config, item", [
    ({"vecenv_type": "MULTIWALKER"}, "A12"),
    ({"central_value_config": CV_CONFIG}, "A9"),
], ids=["config0-A12", "config1-A9"])
def test_ppo_host_refusals(config, item):
    """The host path refuses none of these now; ``item`` names the ROADMAP
    item that ported each: a central value net over a host env (A9) is
    built, and PPO over pettingzoo's multiwalker (A12's second part) trains
    a host epoch over its 2 envs x 3 walkers, 6 rows."""
    if item == "A9":
        assert PPOAgent("t", discrete_params(num_actors=2, horizon_length=8, minibatch_size=16, **config),
                        device="cpu").has_central_value
        return
    agent = PPOAgent("t", continuous_params(env_name="multiwalker_env", num_actors=2, horizon_length=8,
                                            minibatch_size=16, **config), device="cpu")
    assert agent.is_host_env and agent.num_agents == 3 and agent.batch_size == 8 * 6
    state, metrics = agent.host_train_epoch(agent.init_state())
    assert np.isfinite(float(metrics["a_loss"])) and state.current_rewards.shape == (6, 1)


def test_ppo_host_dict_observations_wait_for_a8():
    """Dict observations {'obs', 'goal'} from a host env under the
    actor_critic network, as the JAX package takes them: the network's
    input shape is the 'obs' entry, the whole dict reaches it, and it reads
    a dict only through an 'observation' entry, so both packages refuse the
    first forward (the JAX package in init_state, with an AttributeError
    from its trunk's reshape of the dict). A custom network reads such keys:
    test_torch_port_dict_obs.py::test_host_dict_rollout_matches_jax."""
    def env(spaces):
        e = FakeSameStepEnv(LENGTHS, spaces)
        e.get_env_info = lambda: spaces.EnvInfo(
            observation_space=spaces.DictSpace.create({"obs": spaces.Box(shape=(3,)), "goal": spaces.Box(shape=(2,))}),
            action_space=spaces.Box(shape=(1,), low=-1.0, high=1.0))
        obs = e._obs
        e._obs = lambda: {"obs": obs(), "goal": np.zeros((e.n, 2), np.float32)}
        return e

    with pytest.raises(AttributeError, match="'dict' object has no attribute 'reshape'"):
        JPPOAgent("t", continuous_params(), vec_env=env(jspaces)).init_state()
    agent = PPOAgent("t", continuous_params(), device="cpu", vec_env=env(tspaces))
    state = agent.init_state()
    assert set(state.obs) == {"obs", "goal"}
    with pytest.raises(ValueError, match=r"through its 'observation' entry .*; this one has the keys \['goal', 'obs'\]"):
        agent.host_train_epoch(state)


def test_ppo_host_masks_need_a_mask_source():
    """A host env must serve masks (ppo.py:371-385); one that does is taken."""
    params = continuous_params(use_action_masks=True)
    with pytest.raises(ValueError, match="get_action_masks"):
        PPOAgent("t", params, device="cpu", vec_env=FakeSameStepEnv(LENGTHS, tspaces))
    with pytest.raises(ValueError, match="cannot serve masks"):
        PPOAgent("t", discrete_params(num_actors=2, horizon_length=8, minibatch_size=16, use_action_masks=True),
                 device="cpu")
    masked = FakeSameStepEnv(LENGTHS, tspaces)
    masked.get_action_masks = lambda: np.ones((4, 2), bool)
    assert PPOAgent("t", params, device="cpu", vec_env=masked).use_action_masks


def test_ppo_player_runs_host_env():
    params = discrete_params(num_actors=2, seed=3, normalize_input=False, env_config={"seed": 3},
                             player={"games_num": 3, "max_steps": 300})
    player = PpoPlayer(params, device="cpu")
    assert player.is_host_env
    assert player.run() > 0.0  # CartPole always accrues reward


def test_host_player_inference_device_cpu(capsys):
    params = discrete_params(num_actors=2, seed=5, env_config={"seed": 5}, host_inference_device="cpu",
                             player={"games_num": 3, "deterministic": True})
    player = PpoPlayer(params, device="cpu")
    assert player.device.type == "cpu" and player.run(games_num=3) > 0.0
    assert "games played: 3" in capsys.readouterr().out  # two envs end together at most


def sac_host_params(**config):
    params = yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / "sac_pendulum.yaml").read_text())["params"]
    params["network"]["mlp"]["units"] = [32, 32]
    params["config"].update({"vecenv_type": "GYMNASIUM", "num_actors": 4, "num_steps_per_episode": 4,
                             "batch_size": 32, "replay_buffer_size": 10000, "num_warmup_steps": 1,
                             "utd_ratio": 0.5, "seed": 7, "env_config": {"seed": 7}, "print_stats": False,
                             **config})
    return params


def test_sac_player_runs_host_env():
    params = sac_host_params(num_actors=2, player={"games_num": 2, "max_steps": 450})
    player = SACPlayer(params, device="cpu")
    assert player.is_host_env
    assert player.run() < 0.0  # Pendulum's rewards are negative


def test_sac_host_path_runs():
    agent = SACAgent("t", sac_host_params(), device="cpu")
    assert agent.is_host_env
    state = agent.init_state()
    train = agent.make_train_fn()
    for _ in range(4):
        state, m = train(state)
    assert state.update_counter > 0 and np.isfinite(float(m["critic_loss"]))
    # one transition of the 16 env steps is still pending
    assert tsac.replay_size(state.replay) == (4 * 4 - 1) * 4


# ---------------------------------------------------------------------------
# SAC: one host epoch against the JAX package's, and the replay's contents
# ---------------------------------------------------------------------------


def sac_params(n, **over):
    cfg = {"env_name": "fake", "num_actors": n, "num_steps_per_episode": 1, "batch_size": 8,
           "replay_buffer_size": 4096, "num_warmup_steps": 10**9, "utd_ratio": None, "num_updates_per_step": 1,
           "gamma": 0.99, "init_alpha": 1.0, "alpha_lr": 1e-3, "actor_lr": 1e-3, "critic_lr": 1e-3,
           "critic_tau": 0.005, "learnable_temperature": True, "normalize_input": True, "value_bootstrap": True,
           "seed": 3, "print_stats": False, **over}
    return {"algo": {"name": "sac"}, "model": {"name": "soft_actor_critic"},
            "network": {"name": "soft_actor_critic", "separate": True,
                        "mlp": {"units": [16], "activation": "relu", "initializer": {"name": "default"}},
                        "log_std_bounds": [-5, 2]},
            "config": cfg}


def fake_sac(lengths=(3, 5, 4, 7), autoreset_mode="same_step", truncate=False, **over):
    env = FakeHostEnv(lengths, tspaces, autoreset_mode, truncate)
    return SACAgent("t", sac_params(env.n, **over), device="cpu", vec_env=env), env


def replay_rows(state):
    n, r = tsac.replay_size(state.replay), state.replay
    return (r.obses[:n].numpy(), r.next_obses[:n].numpy(), r.rewards[:n, 0].numpy(), r.dones[:n, 0].numpy(),
            r.truncated[:n, 0].numpy(), r.actions[:n].numpy())


def run_epochs(agent, state, n):
    train = agent.make_train_fn()
    for _ in range(n):
        state, m = train(state)
    return state, m


@pytest.mark.parametrize("autoreset_mode", ["same_step", "next_step"])
def test_sac_host_epochs_match_jax(autoreset_mode, monkeypatch):
    """Six epochs of two steps, the actions the JAX agent sent to its env
    handed to the port's: the replay rows bit for bit (the next-step reset
    rows skipped alike), the normalizer, meters and counters."""
    jenv = FakeHostEnv([3, 5, 4, 7], jspaces, autoreset_mode, truncate=False)
    jagent = JSACAgent("jax", sac_params(4, num_steps_per_episode=2), vec_env=jenv)
    jstate = jagent.init_state()
    jtrain = jagent.make_train_fn()
    for _ in range(6):
        jstate, _ = jtrain(jstate)
    agent, env = fake_sac(autoreset_mode=autoreset_mode, num_steps_per_episode=2)
    actions = iter(jenv.actions)
    monkeypatch.setattr(agent, "_act", lambda state, warmup: torch.from_numpy(next(actions)))
    state, m = run_epochs(agent, agent.init_state(), 6)
    for got, want in zip(replay_rows(state), (np.asarray(getattr(jstate.replay, k)) for k in
                                              ("obses", "next_obses", "rewards", "dones", "truncated", "actions"))):
        n = tsac.replay_size(state.replay)
        np.testing.assert_array_equal(got, want[:n].reshape(got.shape))
    assert (state.replay.idx, state.replay.full) == (int(jstate.replay.idx), bool(jstate.replay.full))
    assert tsac.replay_size(state.replay) < 4 * 11 if autoreset_mode == "next_step" else 4 * 11
    rms = agent.running_mean_std
    np.testing.assert_allclose(rms.running_mean.numpy(), np.asarray(jstate.obs_rms.mean), rtol=1e-6)
    np.testing.assert_allclose(rms.running_var.numpy(), np.asarray(jstate.obs_rms.var), rtol=1e-6)
    assert int(rms.count) == int(jstate.obs_rms.count)
    np.testing.assert_array_equal(state.game_rewards.buf[:-1].numpy(), np.asarray(jstate.game_rewards.buf))
    assert int(state.game_rewards.count) == int(jstate.game_rewards.count) > 0
    assert state.frame == int(jstate.frame) == 4 * 11 and state.epoch == int(jstate.epoch) == 6


def test_sac_host_updates_match_jax():
    """Host epochs of one env step each past warmup (2 updates a step, the
    actor on every second), from the JAX agent's initial weights and with
    its draws handed in (warmup uniforms, actor normals, sample indices,
    the updates' normals, from the key splits its host step makes,
    sac.py:661-752): after each step the actions the actor sent to the env
    and the epoch's losses, then the weights and Adam's moments, against
    the JAX agent's. The order the pipeline keeps is what this holds: step
    t-1's transition is written and its updates run before the actor acts
    at step t, so every action after warmup comes from the updated actor.
    Tolerances as tests/test_torch_port_sac.py's: rtol 1e-5 / atol 1e-6
    for what the networks compute, the weights at rtol 1e-5 / atol 1e-7."""
    over = dict(num_steps_per_episode=1, num_warmup_steps=2, num_updates_per_step=2)
    jenv = FakeHostEnv([3, 5, 4, 7], jspaces)
    jagent = JSACAgent("jax", sac_params(4, **over), vec_env=jenv)
    jstate = jagent.init_state()
    agent, env = fake_sac(**over)
    state = agent.init_state()
    js = to_np(jstate)
    sections = sac_jax_to_state_dict(js.actor_params, js.critic_params, js.critic_target_params, js.obs_rms)
    modules = {"actor": agent.actor, "critic": agent.critic, "critic_target": agent.critic_target,
               "running_mean_std": agent.running_mean_std}
    for name, module in modules.items():
        module.load_state_dict(sections[name])
    assert float(state.log_alpha) == float(js.log_alpha)

    rng = [jstate.rng]

    def next_key():  # rng, key = split(rng), as every draw of the host step
        rng[0], key = jax.random.split(rng[0])
        return key

    def normal(key, shape):
        return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))

    def act_keys():  # act(): k1 for the actor's normals, k2 for the warmup uniforms
        return jax.random.split(next_key())

    agent._normal = lambda state, shape: normal(act_keys()[0], shape)
    agent._uniform_actions = lambda state: torch.from_numpy(
        np.array(jax.random.uniform(act_keys()[1], (4, 1), jnp.float32, -1.0, 1.0)))
    update = agent._update

    def jax_update(state):  # sac.py:449: the sample indices and both updates' normals
        k_sample, k_critic, k_actor = jax.random.split(next_key(), 3)
        idx = jax.random.randint(k_sample, (8,), 0, max(tsac.replay_size(state.replay), 1))
        return update(state, torch.from_numpy(np.array(idx)).long(), normal(k_critic, (8, 1)),
                      normal(k_actor, (8, 1)))

    agent._update = jax_update
    jtrain, train = jagent.make_train_fn(), agent.make_train_fn()
    tol = dict(rtol=1e-5, atol=1e-6)
    for epoch in range(8):
        jstate, jm = jtrain(jstate)
        state, m = train(state)
        np.testing.assert_allclose(env.actions[-1], jenv.actions[-1], err_msg=f"actions, epoch {epoch}", **tol)
        assert int(m["actor_updated"]) == int(jm["actor_updated"]) == (1 if epoch >= 2 else 0)
        for k in ("critic_loss", "critic1_loss", "critic2_loss", "actor_loss", "entropy", "alpha_loss", "alpha"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=f"{k}, epoch {epoch}", **tol)
    assert state.update_counter == int(jstate.update_counter) == 12
    assert not np.array_equal(env.actions[2], env.actions[3])  # the actor's samples, not warmup's
    js = to_np(jstate)
    want = sac_jax_to_state_dict(js.actor_params, js.critic_params, js.critic_target_params, js.obs_rms)
    for name, module in modules.items():
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[name][k].numpy(), rtol=1e-5, atol=1e-7, err_msg=f"{name}.{k}")
    np.testing.assert_allclose(float(state.log_alpha), float(js.log_alpha), rtol=1e-6)


def check_rows(obs, nxt, rew):
    """Every row is a transition inside one episode with its own reward."""
    np.testing.assert_array_equal(nxt[:, :2], obs[:, :2])
    np.testing.assert_array_equal(nxt[:, 2], obs[:, 2] + 1)
    np.testing.assert_array_equal(rew, 100.0 * obs[:, 0] + obs[:, 2] + 1)


def test_same_step_replay_contents_exact():
    agent, env = fake_sac()
    state, _ = run_epochs(agent, agent.init_state(), 20)
    obs, nxt, rew, dones, _, _ = replay_rows(state)
    assert len(obs) == 4 * (20 - 1)  # one transition pending in the pipeline
    check_rows(obs, nxt, rew)
    for i in np.flatnonzero(dones):  # terminations at each env's episode length
        assert nxt[i][2] == env.lengths[int(obs[i][0])]


def test_staggered_next_step_skips_reset_rows():
    agent, _ = fake_sac(autoreset_mode="next_step")
    state, _ = run_epochs(agent, agent.init_state(), 24)
    obs, nxt, rew, _, _, _ = replay_rows(state)
    check_rows(obs, nxt, rew)
    assert 0 < len(obs) < 4 * 23


def test_truncation_rows_bootstrap_not_done():
    agent, _ = fake_sac(lengths=(3, 5), truncate=True)
    state, _ = run_epochs(agent, agent.init_state(), 12)
    _, _, _, dones, trunc, _ = replay_rows(state)
    assert trunc.sum() > 0 and dones.sum() == 0


def test_normalizer_counts_each_frame_once():
    agent, _ = fake_sac(lengths=(100, 100), num_steps_per_episode=2)
    state = agent.init_state()
    c0 = int(agent.running_mean_std.count)
    run_epochs(agent, state, 7)
    assert int(agent.running_mean_std.count) - c0 == 2 * (7 * 2 - 1)


def test_utd_accounting():
    agent, _ = fake_sac(lengths=(100,) * 4, num_warmup_steps=3, utd_ratio=0.5, batch_size=4)
    assert agent.num_updates_per_step == 2
    state, _ = run_epochs(agent, agent.init_state(), 10)
    # epoch e ingests epoch e-1's transition; warmup gates on the ingesting epoch
    assert state.update_counter == 2 * (10 - 3)


def test_resume_from_stripped_replay_pauses_updates(tmp_path):
    agent, _ = fake_sac(lengths=(1000, 1000), num_warmup_steps=2)
    state, _ = run_epochs(agent, agent.init_state(), 8)
    assert state.update_counter > 0
    path = str(tmp_path / "sac.pth")
    agent._save(path, state, {"has_replay": agent.save_replay_buffer})

    agent2, _ = fake_sac(lengths=(1000, 1000), num_warmup_steps=2, replay_resume_min_fill=8)
    state2, _ = agent2._restore(path, agent2.init_state())
    assert tsac.replay_size(state2.replay) == 0 and state2.epoch == state.epoch
    upd0 = state2.update_counter
    train = agent2.make_train_fn()
    # the first epoch primes the pipeline; the next three write 2, 4, 6 rows
    for _ in range(4):
        state2, _ = train(state2)
        assert state2.update_counter == upd0
    state2, _ = train(state2)  # 8 rows: the gate opens
    assert state2.update_counter > upd0


def test_set_param_preserves_pending_transition():
    """tests/test_sac_correctness.py::test_set_param_preserves_pending_transition:
    set_param between epochs keeps the pending transition, so every env
    step lands in replay exactly once: 10 epochs x 2 steps of 2 envs, one
    transition still pending, each row a transition inside one episode."""
    agent, _ = fake_sac(lengths=(100, 100), num_steps_per_episode=2)
    state, _ = run_epochs(agent, agent.init_state(), 5)
    pending = agent._pending
    state = agent.set_param("gamma", 0.95, state)
    assert agent._pending is pending and agent.get_param("gamma") == 0.95
    state, _ = run_epochs(agent, state, 5)
    obs, nxt, rew, _, _, _ = replay_rows(state)
    assert len(obs) == 2 * (10 * 2 - 1) == 38
    check_rows(obs, nxt, rew)


def test_sac_host_metrics_repeat_the_last_update_epoch():
    agent, _ = fake_sac(lengths=(100,) * 4, num_warmup_steps=1, batch_size=4, num_steps_per_episode=1)
    state, m1 = run_epochs(agent, agent.init_state(), 3)
    assert float(m1["critic_loss"]) > 0
    agent.num_warmup_steps = 10**9  # no more updates
    state, m2 = run_epochs(agent, state, 1)
    assert float(m2["critic_loss"]) == float(m1["critic_loss"])


# ---------------------------------------------------------------------------
# the CLI on the CPU over gymnasium's MuJoCo envs
# ---------------------------------------------------------------------------


def test_cli_halfcheetah_trains_and_plays(tmp_path, capsys):
    config = yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / "ref" / "mujoco" / "halfcheetah.yaml").read_text())
    cfg = config["params"]["config"]
    cfg.update(num_actors=2, horizon_length=8, minibatch_size=8, max_epochs=2, train_dir=str(tmp_path / "runs"),
               save_best_after=1, env_config={"seed": 5, "max_episode_steps": 10},
               player={"deterministic": True, "games_num": 2})
    path = tmp_path / "halfcheetah.yaml"
    path.write_text(yaml.safe_dump(config))
    cli.main(["--device", "cpu", "--train", "-f", str(path)])
    out = capsys.readouterr().out
    assert " epoch: 2/2 frames: 32" in out
    nn_dir = tmp_path / "runs" / "HalfCheetah-v5" / "nn"
    final = [p for p in nn_dir.iterdir() if "_rew_" in p.name]
    assert len(final) == 1
    payload = ckpt.read_payload(str(final[0]))
    assert payload["state"]["env_state"] is None and payload["meta"]["epoch"] == 2
    reward = cli.main(["--device", "cpu", "--play", "-f", str(path), "-c", str(final[0])])
    assert np.isfinite(reward) and "games played: 2" in capsys.readouterr().out


def test_cli_sac_ant_trains_and_plays(tmp_path, capsys):
    config = yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / "sac_ant.yaml").read_text())
    cfg = config["params"]["config"]
    cfg.update(num_actors=2, num_warmup_frames=8, batch_size=8, replay_buffer_size=256, max_frames=24,
               log_interval=4, train_dir=str(tmp_path / "runs"), save_best_after=1,
               env_config={**cfg["env_config"], "max_episode_steps": 6}, player={"deterministic": True, "games_num": 2})
    path = tmp_path / "sac_ant.yaml"
    path.write_text(yaml.safe_dump(config))
    cli.main(["--device", "cpu", "--train", "-f", str(path)])
    out = capsys.readouterr().out
    assert "epoch: 12 frames: 24" in out and "MAX FRAMES NUM!" in out
    last = tmp_path / "runs" / "Ant-v5_SAC" / "nn" / "last_Ant-v5_SAC_ep_12.pth"
    payload = ckpt.read_payload(str(last))
    # 12 epochs of 2 envs: 4 warmup epochs (8 frames), then utd_ratio 1 x 2
    # envs = 2 updates per env step from the epoch whose ingest brings the
    # ring to 8 rows (the fifth); one transition pending
    assert payload["state"]["update_counter"] == 2 * (12 - 4) and payload["state"]["frame"] == 22
    reward = cli.main(["--device", "cpu", "--play", "-f", str(path), "-c", str(last)])
    assert np.isfinite(reward) and "games played: 2" in capsys.readouterr().out
