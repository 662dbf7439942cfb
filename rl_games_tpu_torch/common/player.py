"""Players: inference/evaluation loops.

Port of rl_games_tpu/common/player.py ``BasePlayer`` and ``PpoPlayer``
(:25-316; the reference's common/player.py BasePlayer.run :274-393 and
algos_torch/players.py) for device-resident envs: the evaluation loop steps
the vectorized env a fixed number of times with deterministic (or sampled)
actions and collects completed-episode returns in a ring meter of
``games_num`` entries. Nothing inside the loop reads a device value on the
host; the whole run is under ``torch.no_grad()``. Continuous actions are
the mean (deterministic) or a sample, clipped and rescaled to the env's
bounds; discrete ones the argmax of the logits (deterministic) or a sample,
passed as they are. With ``network.mlp.fused: true`` every step's policy
forward is one launch of the fused-MLP kernel.
"""

import glob
import os
from typing import Optional

import numpy as np
import torch

from rl_games_tpu_torch.algos.ppo import CHECKPOINT_EXT, meters_init, meters_mean, meters_update
from rl_games_tpu_torch.common import obs_utils
from rl_games_tpu_torch.common.tr_helpers import rescale_actions
from rl_games_tpu_torch.envs import registry as env_registry
from rl_games_tpu_torch.envs.spaces import Box, Discrete, actions_num_of, obs_shape_of
from rl_games_tpu_torch.models import model_builder
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.device import resolve_device, use_full_float32
from rl_games_tpu_torch.utils.unported import unported


class BasePlayer:
    def __init__(self, params, device=None):
        self.params = params
        config = params["config"]
        self.config = config
        self.device = resolve_device(device)
        use_full_float32(self.device)
        player_cfg = config.get("player", {}) or {}
        self.player_cfg = player_cfg
        self.num_actors = player_cfg.get("num_actors", config.get("num_actors", 16))
        self.games_num = player_cfg.get("games_num", 200)
        self.max_steps = player_cfg.get("max_steps", 27000)
        self.deterministic = player_cfg.get(
            "deterministic", player_cfg.get("determenistic", True)
        )
        self.seed = config.get("seed", 7)
        if config.get("use_action_masks", False):
            unported("masked-action inference (use_action_masks)", "A8")
        if config.get("vecenv_type") not in (None, "JAX", "DEVICE"):
            unported("the host-env evaluation loop (vecenv_type)", "A11")

        self.vec_env = env_registry.create_vec_env(
            config["env_name"], self.num_actors,
            vecenv_type=config.get("vecenv_type"), device=self.device,
            **config.get("env_config", {}),
        )
        if hasattr(self.vec_env, "bind_policy"):
            unported("self-play envs (bind_policy)", "A12")
        info = self.vec_env.get_env_info()
        self.env_info = info
        self.value_size = info.value_size
        self.obs_shape = obs_shape_of(info.observation_space)
        self.actions_num = actions_num_of(info.action_space)
        self.is_continuous = isinstance(info.action_space, Box)
        if not self.is_continuous and not isinstance(info.action_space, Discrete):
            unported(f"the action space {info.action_space}", "A8")

        self.model = model_builder.ModelBuilder().load(
            params,
            actions_num=self.actions_num,
            input_shape=self.obs_shape,
            value_size=self.value_size,
            normalize_input=config.get("normalize_input", False),
            normalize_value=config.get("normalize_value", False),
            obs_shape=self.obs_shape,
            device=self.device,
        )
        self.model.reset_parameters(self._generator(self.seed))
        if self.is_continuous:
            space = info.action_space
            self._rescale = bool(np.isfinite(space.low).all() and np.isfinite(space.high).all())
            self._action_low = torch.as_tensor(space.low, dtype=torch.float32, device=self.device)
            self._action_high = torch.as_tensor(space.high, dtype=torch.float32, device=self.device)
        self._last_ckpt = None

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def restore(self, checkpoint_path: str):
        """players.py:71-79 — load model weights from a training checkpoint
        (or any file with the reference's {'model': state_dict} layout)."""
        weights, _ = ckpt.load_checkpoint_weights(checkpoint_path)
        self.model.load_state_dict(weights)

    def make_export_policy(self):
        unported("policy export (make_export_policy, --export)", "A12")

    def override_sigma(self, sigma: float):
        """--sigma at play time (_override_sigma, torch_runner.py:52-60)."""
        blocked = obs_utils.sigma_override_blocked(
            self.is_continuous, self.params.get("network", {})
        )
        if blocked:
            print(blocked)
            return
        obs_utils.fill_sigma(self.model, sigma)

    def _env_actions(self, actions):
        if not self.is_continuous:
            return actions
        a = torch.clamp(actions, -1.0, 1.0)
        if self._rescale:
            return rescale_actions(self._action_low, self._action_high, a)
        return a

    # -- evaluation mode (player.py:119-156): watch a directory for fresh
    # training checkpoints and hot-reload weights between rollout chunks --
    def maybe_load_new_checkpoint(self):
        dir_to_monitor = self.player_cfg.get("dir_to_monitor")
        if not dir_to_monitor:
            return False
        ckpts = sorted(
            glob.glob(os.path.join(dir_to_monitor, "*" + CHECKPOINT_EXT)),
            key=os.path.getmtime,
        )
        if not ckpts:
            return False
        latest = ckpts[-1]
        mtime = os.path.getmtime(latest)
        if self._last_ckpt == (latest, mtime):
            return False
        try:
            # tolerate partial/corrupt files: retry logic inside, and any
            # failure leaves current weights in place (player.py:137-156)
            self.restore(latest)
            self._last_ckpt = (latest, mtime)
            print(f"evaluation: reloaded checkpoint {latest}")
            return True
        except Exception as e:
            print(f"evaluation: failed to load {latest}: {e}")
            return False

    def _host_run(self, games_num: int):
        unported("the host-env evaluation loop (_host_run)", "A11")

    def _play_actions(self, generator, obs, env_state=None):
        """env-space actions for the device eval loop; ``generator`` draws
        the action noise when the player is not deterministic."""
        res = self.model.forward_play(
            obs, generator=generator, deterministic=self.deterministic
        )
        return self._env_actions(res["actions"])

    def run(self, games_num: Optional[int] = None, **_):
        games_num = games_num or self.games_num
        if self.player_cfg.get("evaluation"):
            self.maybe_load_new_checkpoint()
        return self._device_run(games_num)

    def steps_needed(self, games_num: int) -> int:
        """Steps of the fixed-length eval loop (player.py:294-298)."""
        return min(
            self.max_steps,
            (self.vec_env.max_episode_steps or 1000) * (games_num // self.num_actors + 2),
        )

    @torch.no_grad()
    def _device_run(self, games_num: int):
        """Device eval: a fixed number of steps, meters on the device.
        Shared by every player; subclasses only override _play_actions."""
        env_seed, act_seed = (
            int(s) for s in np.random.SeedSequence(self.seed + 1).generate_state(2)
        )
        env_state, obs = self.vec_env.reset(self._generator(env_seed))
        act_generator = self._generator(act_seed)
        n = self.num_actors
        meters = meters_init(max(games_num, 1), self.value_size, self.device)
        cur_rew = torch.zeros((n, self.value_size), dtype=torch.float32, device=self.device)
        for _ in range(self.steps_needed(games_num)):
            env_state, obs, rewards, dones, infos = self.vec_env.step(
                env_state, self._play_actions(act_generator, obs, env_state)
            )
            if rewards.dim() == 1:
                rewards = rewards[:, None]
            cur_rew = cur_rew + rewards
            meters_update(meters, cur_rew, dones.to(torch.bool))
            cur_rew = cur_rew * (1.0 - dones.to(torch.float32))[:, None]
        games_played = int(meters.count)
        mean_reward = float(meters_mean(meters)[0]) if games_played else 0.0
        print(f"av reward: {mean_reward:.2f} games played: {games_played}")
        return mean_reward


class PpoPlayer(BasePlayer):
    pass


class SACPlayer(BasePlayer):
    def __init__(self, params, device=None):
        unported("the SAC player", "A10")
