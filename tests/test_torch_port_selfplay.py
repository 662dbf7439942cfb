"""The port's self-play against the JAX package.

- CompetitiveForage (envs/device/selfplay.py) reset and stepped from the JAX
  env's draws and actions: bit for bit but the 2-norm's last bit.
- The opponent's actions from the JAX package's per-env slots carried
  across (utils/jax_params.jax_slots_to_state_dict): 8 envs whose slots hold
  3 weight sets with normalized input, at rtol = atol = 1e-5; the same over
  ``mlp.fused``, whose vmapped chain is the registered operator's vmap rule
  (one grouped call over the slots; the JAX package's ``fused_mlp`` under
  ``jax.vmap`` takes ``plain_mlp`` off the TPU).
- ``set_weights(indices)`` changes those rows alone; the slots pass an
  autoreset unchanged; a checkpoint holds them, as the JAX package's holds
  its whole train state.
- A self-play rollout with the JAX rollout's normals and reset draws handed
  over, the slots carried: the trajectory at rtol = atol = 1e-5, the meters
  exactly.
- tests/test_services.py's self-play tests with their gates (the manager's
  trigger and rotation, the device env end to end, the manager's push).
- The player's mirror match through ``Runner.run`` after a shrunk
  benchruns/selfplay_forage.yaml trained through it with pushes.
- pettingzoo's connect four (envs/host/connect4_env.py): masks and weight
  push (tests/test_host_envs.py::test_connect4_selfplay_env_masks_and_weight_push),
  the games against the JAX package's env under one seed and the same
  moves, bit for bit before a push and, with ``deterministic_opponent``,
  after one; the masked player (tests/test_host_envs.py::test_ppo_player_masked_connect4);
  the manager's host protocol on a connect-four agent.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.envs.jax.selfplay import CompetitiveForage as JForage
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.envs import registry
from rl_games_tpu_torch.envs.device.selfplay import CATCH_RADIUS, CompetitiveForage, ForageState
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.jax_params import jax_slots_to_state_dict, jax_to_state_dict
from rl_games_tpu_torch.utils.self_play import SelfPlayManager
from test_torch_port_multiagent import close, inject_resets, reset_noise, step_reset_noise, t, to_np

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def forage_params(num_actors=8, horizon=16, minibatch=64, units=(16,), fused=False, **config):
    """tests/test_services.py's self-play config (its pushes-into-device-env
    test's), with normalized input and value."""
    cfg = {
        "env_name": "competitive_forage", "num_actors": num_actors, "horizon_length": horizon,
        "minibatch_size": minibatch, "mini_epochs": 1, "learning_rate": 5e-4, "e_clip": 0.2, "clip_value": True,
        "gamma": 0.99, "tau": 0.95, "critic_coef": 1.0, "entropy_coef": 0.005, "grad_norm": 1.0,
        "truncate_grads": True, "normalize_advantage": True, "normalize_input": True, "normalize_value": True,
        "value_bootstrap": True, "seed": 7, **config,
    }
    return {
        "algo": {"name": "a2c_continuous"},
        "model": {"name": "continuous_a2c_logstd"},
        "network": {
            "name": "actor_critic", "separate": False,
            "mlp": {"units": list(units), "activation": "elu", "initializer": {"name": "default"}, "fused": fused},
            "space": {"continuous": {
                "mu_activation": "None", "sigma_activation": "None", "mu_init": {"name": "default"},
                "sigma_init": {"name": "const_initializer", "val": 0.0}, "fixed_sigma": True,
            }},
        },
        "config": cfg,
    }


def forage_state(est):
    return ForageState(self_pos=t(est.self_pos), opp_pos=t(est.opp_pos), food=t(est.food))


# ---------------------------------------------------------------------------
# the env and its slots
# ---------------------------------------------------------------------------


def test_competitive_forage_matches_jax():
    """Reset from the JAX env's draws, then 40 steps of both seats, half
    the envs steering for the food (catches, and some races both win):
    states bit for bit (a position's multiply-add is one rounding in both);
    observations and rewards at rtol 1e-6, atol 1e-7 (XLA contracts the
    multiply-add where it writes the state and may not where it reads the
    position again; the port's 2-norm may differ from XLA's in its last
    bit); terminations and scores exactly, in every env whose distances to
    the food lie further than 1e-6 from CATCH_RADIUS (the last bit of a
    norm there decides a catch)."""
    n = 64
    jenv, env = JForage(), CompetitiveForage(device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    jest, jobs = jax.vmap(jenv.reset)(keys)
    est, obs = env.reset_from(t(reset_noise(keys, 3, (2,))))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(2)
    ends = near = 0
    for i in range(40):
        a = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        b = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
        a[::2] = (np.asarray(jest.food) - np.asarray(jest.self_pos))[::2] / 0.12
        b[::4] = (np.asarray(jest.food) - np.asarray(jest.opp_pos))[::4] / 0.12
        jest, jobs, jrew, jterm, jinfo = jstep(jest, jnp.asarray(a), keys, jnp.asarray(b))
        est, obs, rew, term, info = env.step(est, t(a), None, t(b))
        for name in ("self_pos", "opp_pos", "food"):
            np.testing.assert_array_equal(getattr(est, name).numpy(), np.asarray(getattr(jest, name)))
        close(obs, jobs, f"obs at step {i}", rtol=1e-6, atol=1e-7)
        close(rew, jrew, f"reward at step {i}", rtol=1e-6, atol=1e-7)
        dist = [np.linalg.norm(np.asarray(p, np.float64) - np.asarray(jest.food, np.float64), axis=-1)
                for p in (jest.self_pos, jest.opp_pos)]
        clear = (np.abs(dist[0] - CATCH_RADIUS) > 1e-6) & (np.abs(dist[1] - CATCH_RADIUS) > 1e-6)
        np.testing.assert_array_equal(term.numpy()[clear], np.asarray(jterm)[clear])
        np.testing.assert_array_equal(info["scores"].numpy()[clear], np.asarray(jinfo["scores"])[clear])
        ends += int(np.asarray(jterm).sum())
        near += int((~clear).sum())
    assert ends > 0 and near <= 2


def jax_slots(jenv, model, env_state, obs, seeds=(1, 2)):
    """A JAX self-play env state whose slots hold two more weight sets
    pushed in (at envs 1, 4, 6 and 2, 7), each with its own input
    statistics."""
    rng = np.random.default_rng(5)
    push = jax.jit(jenv.set_weights)
    for seed, idx in zip(seeds, ([1, 4, 6], [2, 7])):
        params, norm = jax.jit(model.init)(jax.random.PRNGKey(seed), obs)
        obs_norm = norm.obs.replace(mean=jnp.asarray(rng.normal(size=6), jnp.float32),
                                    var=jnp.asarray(rng.uniform(0.2, 3.0, 6), jnp.float32))
        env_state = push(jnp.asarray(idx), {"params": params, "norm": norm.replace(obs=obs_norm)}, env_state=env_state)
    return env_state


def opponent_actions_against_jax(fused):
    """The opponents' actions of the port's self-play env from the JAX
    env's slots carried across (8 envs, 3 weight sets, normalized input),
    against the JAX env's, at rtol = atol = 1e-5; the learner's own weights
    do not enter."""
    from rl_games_tpu.envs import registry as jregistry
    from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder

    params = forage_params(units=(32, 16), fused=fused)
    jmodel = JModelBuilder().load(params, actions_num=2, input_shape=(6,), value_size=1, normalize_input=True,
                                  normalize_value=True, obs_shape=(6,))
    jenv = jregistry.create_vec_env("competitive_forage", 8)
    jenv.bind_policy(jmodel)
    es, obs = jenv.reset(jax.random.PRNGKey(3))
    params0, norm0 = jax.jit(jmodel.init)(jax.random.PRNGKey(0), obs)
    es = jax.jit(jenv.init_opponent)(es, {"params": params0, "norm": norm0})
    es = jax_slots(jenv, jmodel, es, obs)
    want = np.asarray(jax.jit(jenv._opp_actions)(es))
    agent = PPOAgent("port", params, device="cpu")
    state = agent.init_state()
    state.env_state.estate = forage_state(es.estate)
    state.env_state.opp_weights = jax_slots_to_state_dict(to_np(es.opp_weights))
    assert sorted(state.env_state.opp_weights) == sorted(agent.model.state_dict())
    assert len({float(w[0, 0]) for w in state.env_state.opp_weights["a2c_network.mu.weight"]}) == 3
    got = agent.vec_env._opp_actions(state.env_state)
    close(got, want, "opponent actions", rtol=1e-5, atol=1e-5)
    # the slots hold the weights, not the learner's model: move its weights
    for p in agent.model.parameters():
        p.data.add_(1.0)
    close(agent.vec_env._opp_actions(state.env_state), want, "opponent actions", rtol=1e-5, atol=1e-5)
    return agent


def test_opponent_actions_match_jax():
    opponent_actions_against_jax(fused=False)


def test_fused_opponent_seat_refused():
    """Refused until the fused MLP took per-env weight sets: now the fused
    seat's actions from carried JAX slots (the JAX model with
    ``mlp.fused``, its ``fused_mlp`` under ``jax.vmap``) agree with the JAX
    env's at rtol = atol = 1e-5, through the operator's vmap rule: one
    grouped call of the chain over the 8 slots a step (``plain_mlp_grouped``
    on the CPU), none folded into the ordinary chain."""
    from rl_games_tpu_torch.models.layers import FusedMLP
    from rl_games_tpu_torch.ops import fused_mlp as fm

    calls = []
    grouped, ordinary = fm.plain_mlp_grouped, fm.plain_mlp

    def count(name, fn):
        def counted(x, *args):
            calls.append((name, tuple(x.shape)))
            return fn(x, *args)
        return counted

    fm.plain_mlp_grouped, fm.plain_mlp = count("grouped", grouped), count("plain", ordinary)
    try:
        agent = opponent_actions_against_jax(fused=True)
    finally:
        fm.plain_mlp_grouped, fm.plain_mlp = grouped, ordinary
    assert any(isinstance(m, FusedMLP) for m in agent.model.modules())
    assert calls == [("grouped", (8, 1, 6))] * 2, calls


def test_set_weights_changes_only_its_rows():
    agent = PPOAgent("port", forage_params(), device="cpu")
    state = agent.init_state()
    before = {k: v.clone() for k, v in state.env_state.opp_weights.items()}
    w = {k: v + 1.0 if v.is_floating_point() else v + 1 for k, v in agent.get_weights().items()}
    new = agent.vec_env.set_weights(np.array([2, 5]), w, env_state=state.env_state)
    rows = np.isin(np.arange(8), [2, 5])
    for k, v in new.opp_weights.items():
        assert torch.equal(v[torch.from_numpy(rows)], w[k][None].expand(2, *w[k].shape)), k
        assert torch.equal(v[torch.from_numpy(~rows)], before[k][torch.from_numpy(~rows)]), k
        assert torch.equal(state.env_state.opp_weights[k], before[k]), k  # the old state is left alone
    with pytest.raises(ValueError, match="env_state="):
        agent.vec_env.set_weights([0], w)


def test_slots_survive_autoreset():
    """Envs at their time limit reset in the step; every slot tensor passes
    through the step as it was."""
    agent = PPOAgent("port", forage_params(), device="cpu")
    state = agent.init_state()
    es = agent.vec_env.set_weights([3], {k: v * 2 for k, v in agent.get_weights().items()},
                                   env_state=state.env_state)
    es.steps = torch.tensor([63, 0, 63, 0, 63, 63, 0, 0], dtype=torch.int32)
    slots = dict(es.opp_weights)
    new, _, _, dones, _ = agent.vec_env.step(es, torch.zeros((8, 2)))
    assert dones[[0, 2, 4, 5]].all() and int(new.steps[0]) == 0
    assert new.opp_weights.keys() == slots.keys()
    assert all(new.opp_weights[k] is v for k, v in slots.items())


def test_checkpoint_holds_the_slots(tmp_path):
    """The checkpoint's train state holds the slots, as the JAX package's
    (its whole TrainState, env state included); a resume restores them."""
    agent = PPOAgent("port", forage_params(), device="cpu")
    state = agent.init_state()
    state.env_state = agent.vec_env.set_weights([1, 6], {k: v * 3 for k, v in agent.get_weights().items()},
                                                env_state=state.env_state)
    agent._save(str(tmp_path / "c.pth"), state, {"epoch": 0})
    fresh = agent.init_state()
    restored, _ = ckpt.load_checkpoint(str(tmp_path / "c.pth"), fresh)
    for k, v in state.env_state.opp_weights.items():
        assert torch.equal(restored.env_state.opp_weights[k], v), k


@pytest.fixture(scope="module")
def jax_run():
    """A JAX self-play agent with three weight sets in its slots and envs 0,
    3 near their 64-step limit, its state and one rollout (numpy)."""
    params = forage_params(units=(32, 16))
    jagent = JPPOAgent("jax", params)
    jstate = jax.jit(jagent.init_state)()
    es = jax_slots(jagent.vec_env, jagent.model, jstate.env_state, jstate.obs)
    jstate = jstate.replace(env_state=es)
    steps = np.zeros(8, np.int32)
    steps[[0, 3]] = [57, 60]
    jstate = jstate.replace(env_state=jstate.env_state.replace(steps=jnp.asarray(steps)))
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    return params, jagent, jstate, after, to_np(traj), np.asarray(last_values)


def test_rollout_matches_jax(jax_run, monkeypatch):
    params, _, jstate, after, traj, last_values = jax_run
    assert traj["dones"][1:].any()
    noise = iter(t((traj["actions"] - traj["mus"]) / traj["sigmas"]))
    monkeypatch.setattr(D, "normal_sample", lambda mean, std, generator=None: mean + std * next(noise))
    agent = PPOAgent("port", params, device="cpu")
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    es = state.env_state
    es.estate, es.steps = forage_state(jstate.env_state.estate), t(jstate.env_state.steps)
    es.opp_weights = jax_slots_to_state_dict(to_np(jstate.env_state.opp_weights))
    state.obs, state.dones, state.lr = t(jstate.obs), t(jstate.dones), t(jstate.lr)
    inject_resets(monkeypatch, agent.vec_env.env, step_reset_noise(jstate.env_state.key, 8, 16, 3, (2,)))
    ptraj, plast = agent._rollout(state)
    for k in ("obses", "actions", "mus", "sigmas", "values", "neglogpacs", "rewards"):
        close(ptraj[k], traj[k], k)
    np.testing.assert_array_equal(ptraj["dones"].numpy(), traj["dones"])
    close(plast, last_values, "last values")
    for m in ("game_rewards", "game_lengths", "game_scores"):
        got, want = getattr(state, m), getattr(after, m)
        assert int(got.count) == int(want.count) > 0 and int(got.ptr) == int(want.ptr), m
        close(got.buf[:-1], np.asarray(want.buf)[:got.capacity], m)


# ---------------------------------------------------------------------------
# tests/test_services.py's self-play tests
# ---------------------------------------------------------------------------


class FakeVecEnv:
    is_host_env = True  # the host protocol: set_weights(indices, weights)

    def __init__(self):
        self.set_weights_calls = []

    def set_weights(self, indices, weights):
        self.set_weights_calls.append((np.asarray(indices).copy(), weights))


class FakeSPAlgo:
    def __init__(self):
        self.vec_env = FakeVecEnv()
        self.num_actors = 4

    def get_weights(self):
        return {"w": 1}


def test_self_play_manager_triggers_and_rotates():
    mgr = SelfPlayManager({"update_score": 0.5, "games_to_check": 10, "env_update_num": 2})
    algo = FakeSPAlgo()
    # not enough games yet
    assert not mgr.update(algo, None, {"games_played": 5, "mean_rewards": [0.9]})[0]
    # low score
    assert not mgr.update(algo, None, {"games_played": 20, "mean_rewards": [0.2], "frame": 0})[0]
    # triggers
    assert mgr.update(algo, None, {"games_played": 20, "mean_rewards": [0.9], "frame": 0})[0]
    idx0 = algo.vec_env.set_weights_calls[0][0]
    np.testing.assert_array_equal(idx0, [0, 1])
    assert mgr.update(algo, None, {"games_played": 20, "mean_rewards": [0.9], "frame": 0})[0]
    idx1 = algo.vec_env.set_weights_calls[1][0]
    np.testing.assert_array_equal(idx1, [1, 2])  # rotated


def test_self_play_device_env_end_to_end():
    """The full self-play loop on the device env with its embedded opponent:
    train against the initial opponent, push the learner's weights into
    every slot, and the opponent forages too (the learner's zero-sum edge
    shrinks)."""
    params = forage_params(num_actors=32, horizon=32, minibatch=256, units=(32, 32), mini_epochs=2,
                           lr_schedule="adaptive", kl_threshold=0.008)
    agent = PPOAgent("t", params, device="cpu")
    state = agent.init_state()
    assert state.env_state.opp_weights is not None
    fn = agent.make_train_fn()
    m = None
    for _ in range(60):
        state, m = fn(state)
    pre_push_reward = float(m["mean_rewards"][0])
    # against an untrained opponent the learner wins the zero-sum race
    assert pre_push_reward > 0.3

    # push the current weights into every opponent slot
    state.env_state = agent.vec_env.set_weights(np.arange(32), agent.get_weights(), env_state=state.env_state)
    state = agent.clear_stats(state)
    for _ in range(25):
        state, m = fn(state)
    post_push_reward = float(m["mean_rewards"][0])
    # the opponent now forages too: the zero-sum edge shrinks measurably
    assert post_push_reward < pre_push_reward - 0.2, (pre_push_reward, post_push_reward)


def test_self_play_manager_pushes_into_device_env():
    params = forage_params(horizon=16, minibatch=64, clip_value=False, normalize_input=False,
                           normalize_value=False, truncate_grads=False)
    agent = PPOAgent("t", params, device="cpu")
    state = agent.init_state()
    mgr = SelfPlayManager({"update_score": -100.0, "games_to_check": 1, "env_update_num": 2})
    fn = agent.make_train_fn()
    for _ in range(5):
        state, m = fn(state)
    before = state.env_state.opp_weights["a2c_network.actor_mlp.0.weight"].clone()
    pushed, state = mgr.update(agent, state, {k: v.numpy() for k, v in m.items() if torch.is_tensor(v)})
    assert pushed
    after = state.env_state.opp_weights["a2c_network.actor_mlp.0.weight"]
    # rows 0, 1 changed, the rest did not
    assert not np.allclose(before[0].numpy(), after[0].numpy())
    np.testing.assert_array_equal(before[3].numpy(), after[3].numpy())
    np.testing.assert_array_equal(mgr.env_indexes, [1, 2])


def test_train_and_mirror_match_through_runner(tmp_path, capsys, monkeypatch):
    """benchruns/selfplay_forage.yaml shrunk to 16 envs x 64 (every env
    ends an episode an epoch), 4 epochs, the manager at update_score -100
    over 1 game and 8 envs a push: it pushes every epoch, with the JAX
    log's line, and the observer hears of each clear once; then the last checkpoint plays a mirror match through Runner.run,
    its weights in every opponent seat."""
    from rl_games_tpu_torch.envs.device.selfplay import SelfPlayVecEnv
    from rl_games_tpu_torch.utils.observers import AlgoObserver

    class Clears(AlgoObserver):
        count = 0

        def after_clear_stats(self):
            self.count += 1

    observer = Clears()
    doc = yaml.safe_load((ROOT / "benchruns/selfplay_forage.yaml").read_text())
    cfg = doc["params"]["config"]
    cfg.update(num_actors=16, horizon_length=64, minibatch_size=256, max_epochs=4, log_interval=1,
               save_frequency=0, train_dir=str(tmp_path), player={"games_num": 8, "max_steps": 200})
    cfg["self_play_config"].update(update_score=-100.0, games_to_check=1, env_update_num=8)
    runner = Runner(algo_observer=observer, device="cpu")
    runner.load(doc)
    runner.run({"train": True})
    out = capsys.readouterr().out
    assert out.count("self-play: mean mean_rewards") == 4 and out.count("updating opponent weights") == 4
    assert observer.count == 4
    nn_dir = tmp_path / "forage_selfplay" / "nn"
    final = [p for p in nn_dir.iterdir() if "_rew_" in p.name]
    assert len(final) == 1
    seats = []
    init_opponent = SelfPlayVecEnv.init_opponent

    def spy(self, env_state, weights):
        seats.append({k: v.clone() for k, v in weights.items()})
        return init_opponent(self, env_state, weights)

    monkeypatch.setattr(SelfPlayVecEnv, "init_opponent", spy)
    reward = runner.run({"play": True, "checkpoint": str(final[0])})
    assert np.isfinite(reward) and "games played: " in capsys.readouterr().out
    saved, _ = ckpt.load_checkpoint_weights(str(final[0]))
    assert len(seats) == 1 and sorted(seats[0]) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(seats[0][k], v), k


# ---------------------------------------------------------------------------
# connect four on the host
# ---------------------------------------------------------------------------


def connect4_params():
    return yaml.safe_load((ROOT / "rl_games_tpu/configs/ref/ma/ppo_connect4_self_play.yaml").read_text())["params"]


def test_connect4_selfplay_env_masks_and_weight_push():
    from rl_games_tpu_torch.envs.host.connect4_env import Connect4SelfPlayVecEnv
    from rl_games_tpu_torch.models import model_builder

    net_params = connect4_params()
    env = Connect4SelfPlayVecEnv(3, network_params=net_params, seed=11)
    info = env.get_env_info()
    assert info.observation_space.shape == (6, 7, 2)
    assert info.action_space.n == 7
    obs = env.reset()
    assert obs.shape == (3, 6, 7, 2)
    rng = np.random.default_rng(0)
    saw_done = False
    for _ in range(60):
        masks = env.get_action_masks()
        assert masks.shape == (3, 7) and masks.any(axis=1).all()
        acts = np.array([rng.choice(np.nonzero(m)[0]) for m in masks])
        obs, rewards, dones, infos = env.step(acts)
        assert set(np.unique(rewards)).issubset({-1.0, 0.0, 1.0})
        if dones.any():
            saw_done = True
            assert "final_observation" in infos
    assert saw_done, "random play must finish games within 60 plies"

    # push learner weights as the opponent (builds the model, batched forward)
    model = model_builder.ModelBuilder().load(net_params, actions_num=7, input_shape=(6, 7, 2), value_size=1,
                                              normalize_input=False, normalize_value=False, obs_shape=(6, 7, 2),
                                              device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    env.set_weights([0, 1], model.state_dict())
    assert env._opp_version[0] > 0 and env._opp_version[2] == 0
    # mixed random / policy opponents step without error
    for _ in range(8):
        masks = env.get_action_masks()
        acts = np.array([rng.choice(np.nonzero(m)[0]) for m in masks])
        obs, rewards, dones, infos = env.step(acts)
    env.close()


def test_connect4_games_match_jax():
    """Port and JAX env under seed 4, the learner's same legal moves: 60
    plies against the uniform opponent (bit for bit: boards, masks,
    rewards, dones, scores, final boards), then the JAX model's weights
    pushed into envs 0 and 1 of both (the port's carried by
    jax_to_state_dict) with deterministic_opponent: 60 more plies bit for
    bit, env 2 still against the uniform opponent."""
    from rl_games_tpu.envs import registry as jregistry
    from rl_games_tpu.models import model_builder as jmodel_builder

    params = connect4_params()
    kw = dict(seed=4, deterministic_opponent=True, network_params=params)
    port = registry.create_vec_env("connect4_env", 3, device="cpu", **kw)
    jenv = jregistry.create_vec_env("connect4_env", 3, **kw)
    np.testing.assert_array_equal(port.reset(), jenv.reset())
    rng = np.random.default_rng(3)

    def plies(count):
        dones = 0
        for i in range(count):
            masks = port.get_action_masks()
            np.testing.assert_array_equal(masks, jenv.get_action_masks())
            acts = np.array([rng.choice(np.nonzero(m)[0]) for m in masks])
            got, want = port.step(acts), jenv.step(acts)
            for j in range(3):
                np.testing.assert_array_equal(got[j], want[j], err_msg=f"ply {i}")
            assert sorted(got[3]) == sorted(want[3])
            for k in got[3]:
                np.testing.assert_array_equal(got[3][k], want[3][k], err_msg=k)
            dones += int(got[2].sum())
        return dones

    assert plies(60) > 0
    jmodel = jmodel_builder.ModelBuilder().load(params, actions_num=7, input_shape=(6, 7, 2), value_size=1,
                                                normalize_input=False, normalize_value=False, obs_shape=(6, 7, 2))
    jparams, jnorm = jax.jit(jmodel.init)(jax.random.PRNGKey(9), np.zeros((1, 6, 7, 2), np.float32))
    jenv.set_weights([0, 1], {"params": jparams, "norm": jnorm})
    port.set_weights([0, 1], jax_to_state_dict(to_np(jparams), to_np(jnorm), network=params["network"],
                                               input_shape=(6, 7, 2)))
    assert plies(60) > 0
    assert list(port._opp_version) == [1, 1, 0]


def test_ppo_player_masked_connect4():
    """--play on the masked connect-four env: the player samples only legal
    columns (an illegal move would crash pettingzoo) and finishes games."""
    from rl_games_tpu_torch.common.player import PpoPlayer

    params = connect4_params()
    cfg = params["config"]
    cfg["num_actors"] = 2
    cfg["player"] = {"games_num": 3, "max_steps": 200, "deterministic": False}
    player = PpoPlayer(params, device="cpu")
    assert player.is_host_env and player.use_action_masks
    reward = player.run()
    assert -1.0 <= reward <= 1.0


def test_connect4_agent_pushes_through_the_host_protocol():
    """ref/ma/ppo_connect4_self_play.yaml shrunk to 4 envs x 8: one host
    epoch, then the manager's push goes to the env's own slots (a new
    version at envs 0 and 1) and rotates; the train state is left as it
    was."""
    params = connect4_params()
    params["config"].update(num_actors=4, horizon_length=8, minibatch_size=32, mini_epochs=1)
    params["config"]["env_config"]["seed"] = 2
    agent = PPOAgent("t", params, device="cpu")
    state, m = agent.host_train_epoch(agent.init_state())
    assert np.isfinite(float(m["a_loss"]))
    mgr = SelfPlayManager({"update_score": -100.0, "games_to_check": 0, "env_update_num": 2})
    pushed, new = mgr.update(agent, state, {k: v.numpy() for k, v in m.items() if torch.is_tensor(v)})
    assert pushed and new is state and new.env_state is None
    assert list(agent.vec_env._opp_version) == [1, 1, 0, 0]
    for k, v in agent.model.state_dict().items():
        assert torch.equal(agent.vec_env._opp_weights[0][k], v), k
    state, m = agent.host_train_epoch(state)  # the pushed opponent plays
    assert np.isfinite(float(m["a_loss"]))
