"""The port's player (common/player.py) against the JAX PpoPlayer on a tiny
fused Ant2D config: deterministic actions and three env steps from a
carried-over state, the eval loop's step arithmetic, and the meter
accounting on synthetic dones."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rl_games_tpu.common.player import PpoPlayer as JPpoPlayer
from rl_games_tpu_torch.common.player import PpoPlayer, SACPlayer
from rl_games_tpu_torch.envs.device.ant2d import Ant2DState
from rl_games_tpu_torch.envs.device.base import VecEnvState
from rl_games_tpu_torch.utils.export import export_policy_fn, load_policy
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

from test_torch_port_ppo import flagship_params, t, to_np

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def player_params(**player_cfg):
    params = flagship_params(8)
    params["network"]["mlp"]["fused"] = True
    params["config"]["player"] = player_cfg
    return params


def test_play_actions_and_steps_match_jax():
    """Same weights, same env state: the deterministic env-space actions and
    the observations and rewards of three steps agree at rtol = atol = 2e-4
    (the rollout test's tolerance for what is computed from observations
    over a few steps of contact dynamics)."""
    params = player_params(num_actors=8, games_num=8, deterministic=True)
    jplayer = JPpoPlayer(params)
    player = PpoPlayer(params, device="cpu")
    player.model.load_state_dict(jax_to_state_dict(to_np(jplayer.net_params), to_np(jplayer.norm)))

    key = jax.random.PRNGKey(3)
    jstate, jobs = jplayer.vec_env.reset(key)
    est = jstate.estate
    state = VecEnvState(
        estate=Ant2DState(q=t(est.q), qd=t(est.qd), last_x=t(est.last_x)),
        generator=torch.Generator().manual_seed(0), steps=t(jstate.steps),
    )
    obs = t(jobs)
    tol = dict(rtol=2e-4, atol=2e-4)
    with torch.no_grad():
        for step in range(3):
            jact = jplayer._play_actions(key, jobs, jstate)
            act = player._play_actions(None, obs, state)
            np.testing.assert_allclose(act.numpy(), np.asarray(jact), err_msg=f"actions {step}", **tol)
            jstate, jobs, jrew, jdones, _ = jplayer.vec_env.step(jstate, jact)
            state, obs, rew, dones, _ = player.vec_env.step(state, act)
            assert not np.asarray(jdones).any()  # resets would draw different noise
            np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), err_msg=f"obs {step}", **tol)
            np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), err_msg=f"rewards {step}", **tol)
            np.testing.assert_array_equal(dones.numpy(), np.asarray(jdones))


@pytest.mark.parametrize("num_actors, games_num, max_steps", [
    (8, 8, 27000), (8, 50, 27000), (4, 3, 27000), (8, 8, 200),
])
def test_steps_needed(num_actors, games_num, max_steps):
    """min(max_steps, max_episode_steps * (games_num // n + 2)), as the JAX
    player computes it (player.py:294-298)."""
    params = player_params(num_actors=num_actors, games_num=games_num, max_steps=max_steps)
    player = PpoPlayer(params, device="cpu")
    limit = player.vec_env.max_episode_steps
    assert limit == JPpoPlayer(params).vec_env.max_episode_steps
    assert player.steps_needed(games_num) == min(max_steps, limit * (games_num // num_actors + 2))


def test_player_config_keys():
    player = PpoPlayer(player_params(num_actors=4, determenistic=False), device="cpu")
    assert player.num_actors == 4 and player.deterministic is False
    assert player.games_num == 200 and player.max_steps == 27000
    assert PpoPlayer(player_params(), device="cpu").num_actors == 8  # config.num_actors


class ScriptedEnv:
    """Every env finishes an episode each third step; env i earns i + 1 per
    step, so its episodes return 3 * (i + 1)."""

    max_episode_steps = 3

    def __init__(self, n, obs_dim):
        self.n, self.obs_dim, self.t = n, obs_dim, 0

    def reset(self, generator):
        return None, torch.zeros((self.n, self.obs_dim))

    def step(self, state, actions):
        self.t += 1
        rewards = torch.arange(1, self.n + 1, dtype=torch.float32)
        dones = torch.full((self.n,), self.t % 3 == 0)
        return state, torch.zeros((self.n, self.obs_dim)), rewards, dones, {}


def test_meter_accounting_on_synthetic_dones(capsys):
    """12 steps of 4 envs finish 16 games; the ring of games_num = 8 keeps
    the last 8, two full rounds of returns 3, 6, 9, 12: mean 7.5."""
    player = PpoPlayer(player_params(num_actors=4, games_num=8, max_steps=12), device="cpu")
    player.vec_env = ScriptedEnv(4, 26)
    assert player.steps_needed(8) == 12
    assert player.run() == pytest.approx(7.5)
    assert "av reward: 7.50 games played: 8" in capsys.readouterr().out
    # no episode finishes in 2 steps: zero games, mean 0
    player.vec_env = ScriptedEnv(4, 26)
    player.max_steps = 2
    assert player.run() == 0.0
    assert "games played: 0" in capsys.readouterr().out


def test_sigma_override():
    player = PpoPlayer(player_params(), device="cpu")
    player.override_sigma(-1.5)
    assert torch.all(player.model.a2c_network.sigma == -1.5)


@pytest.mark.parametrize("make, item", [
    (lambda: SACPlayer({**player_params(), "config": {**player_params()["config"], "vecenv_type": "CONNECT4"}},
                       device="cpu"), "SAC requires a continuous action space"),
    (lambda: PpoPlayer({**player_params(), "config": {**player_params()["config"], "vecenv_type": "JAX_SELFPLAY",
                                                      "env_name": "competitive_forage"}}, device="cpu"), "plays"),
    (lambda: PpoPlayer(player_params(), device="cpu").make_export_policy(), "export"),
    (lambda: resnet_catcher_params(), None),
], ids=["make0-A12", "make1-A12", "make2-A12", "make3-A8"])
def test_unported_player_paths_raise(make, item):
    """What the player refused until its item came: export (make2, A12's
    last part) now gives the deterministic policy module, whose exported
    program acts as the module does. The self-play envs came with A12's second part: SAC's player on the
    connect-four env stops at SAC's own ValueError, its actions being
    discrete (make0; the JAX SACPlayer has no action shape to read there
    either), and the PPO player on competitive_forage (JAX_SELFPLAY) plays
    a mirror match of its policy (make1), with the MLP fused (the
    opponents' forward one grouped call of the chain over the seats a step)
    and plain. The resnet builder's network,
    refused until A8 (b) (make3), plays: ppo_pixelcatcher.yaml with
    resnet_actor_critic (depths [4, 8], MLP [16]) on 16x16x1 frames, its
    deterministic actions for the JAX player's observations as the JAX
    player's with the same weights, step by step for 20 steps."""
    if item == "plays":
        from rl_games_tpu_torch.models.layers import FusedMLP

        player = make()
        assert any(isinstance(m, FusedMLP) for m in player.vec_env._policy.modules())
        assert np.isfinite(player.run(games_num=4))
        params = player_params()
        params["network"]["mlp"]["fused"] = False
        params["config"].update(vecenv_type="JAX_SELFPLAY", env_name="competitive_forage")
        player = PpoPlayer(params, device="cpu")
        assert player.vec_env._policy is not None and np.isfinite(player.run(games_num=4))
        return
    if item == "export":
        policy = make()
        obs = torch.randn((5, 26), generator=torch.Generator().manual_seed(3)) * 2  # Ant2D's observations
        exported = load_policy(export_policy_fn(policy, obs[:1]))
        with torch.no_grad():
            torch.testing.assert_close(exported(obs), policy(obs), rtol=0, atol=0)
        return
    if item is not None:
        with pytest.raises(ValueError, match=item):
            make()
        return
    params = make()
    jplayer, player = JPpoPlayer(params), PpoPlayer(params, device="cpu")
    player.model.load_state_dict(jax_to_state_dict(to_np(jplayer.net_params), to_np(jplayer.norm)))
    env_state, obs = jplayer.vec_env.reset(jax.random.PRNGKey(4))
    step = jax.jit(jplayer.vec_env.step)
    for _ in range(20):
        actions = jplayer._play_actions(None, obs, env_state)
        with torch.no_grad():
            np.testing.assert_array_equal(player._play_actions(None, t(obs)).numpy(), np.asarray(actions))
        env_state, obs, _, _, _ = step(env_state, actions)
    assert np.isfinite(player.run(games_num=4))


def resnet_catcher_params() -> dict:
    import yaml

    params = yaml.safe_load((ROOT / "rl_games_tpu/configs/ppo_pixelcatcher.yaml").read_text())["params"]
    params["network"] = {"name": "resnet_actor_critic", "separate": False, "space": {"discrete": {}},
                         "cnn": {"conv_depths": [4, 8]}, "mlp": {"units": [16], "activation": "relu"}}
    params["config"].update(num_actors=8, player={"games_num": 4, "deterministic": True})
    return params
