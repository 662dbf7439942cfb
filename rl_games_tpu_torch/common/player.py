"""Players: inference/evaluation loops.

Port of rl_games_tpu/common/player.py ``BasePlayer`` and ``PpoPlayer``
(:25-316; the reference's common/player.py BasePlayer.run :274-393 and
algos_torch/players.py) for device-resident envs: the evaluation loop steps
the vectorized env a fixed number of times with deterministic (or sampled)
actions and collects completed-episode returns in a ring meter of
``games_num`` entries. Nothing inside the loop reads a device value on the
host; the whole run is under ``torch.no_grad()``. Continuous actions are
the mean (deterministic; tanh(mu) for the tanh policy) or a sample, clipped
and rescaled to the env's bounds; discrete and multi-discrete ones the
argmax of the (masked, with ``use_action_masks``) logits (deterministic) or
a sample, passed as they are. The policy sees the 'obs' entry of the
asymmetric envs' {'obs', 'states'} observations, and any other dict
observation whole (player.py:114-119). A recurrent policy
plays as the JAX package's does: every step's forward starts from zero
states (the JAX player passes no ``rnn_states``, player.py:230-255, so its
RNNCore starts from zeros; the reference's player would carry them). With
``network.mlp.fused: true`` every step's policy forward is one launch of
the fused-MLP kernel (two with ``network.separate``). ``SACPlayer`` plays a SAC
actor through the same loop. Over a host env (GYMNASIUM, CPUENV,
DMCONTROL) the loop is ``_host_run`` (player.py:183-228): the env steps on
the host until ``games_num`` episodes have ended, and the policy runs where
``host_inference_device`` puts it (common/host_inference.py), the player's
whole policy on that device. On a self-play device env the player plays a
mirror match: its restored weights fill every opponent seat (player.py:
271-277). Over a multi-agent env an episode counts once, at its env's first
agent row, as the trainer's meters count it; the JAX player's return
accumulator has one row an env and fails on the N · A rows.
"""

import glob
import os
from typing import Optional

import numpy as np
import torch

from rl_games_tpu_torch.algos.ppo import CHECKPOINT_EXT, actor_obs, meters_init, meters_mean, meters_update
from rl_games_tpu_torch.common import obs_utils
from rl_games_tpu_torch.common.host_inference import rollout_device
from rl_games_tpu_torch.common.tr_helpers import rescale_actions
from rl_games_tpu_torch.envs import registry as env_registry
from rl_games_tpu_torch.envs.spaces import Box, actions_num_of, obs_shape_of
from rl_games_tpu_torch.models import layers, model_builder
from rl_games_tpu_torch.models.sac import ActionRescale, SACActor, build_sac_networks, load_normalizer
from rl_games_tpu_torch.ops.running_stats import RunningMeanStd
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
        # masked-action inference (players.py get_masked_action)
        self.use_action_masks = config.get("use_action_masks", False)

        self.vec_env = env_registry.create_vec_env_from_config(config, self.num_actors, self.device)
        self.is_host_env = bool(getattr(self.vec_env, "is_host_env", False))
        if self.is_host_env:  # the policy goes where host_inference_device puts it
            self.device = rollout_device(config.get("host_inference_device", "auto"), self.device,
                                         params.get("network", {}))
        info = self.vec_env.get_env_info()
        self.env_info = info
        self.value_size = info.value_size
        # a multi-agent env's N envs x A agents are N * A rows; an episode
        # counts once, at its env's first agent row
        self.num_agents = info.agents
        self.num_rows = self.num_actors * self.num_agents
        self.obs_shape = obs_shape_of(info.observation_space)
        self.actions_num = actions_num_of(info.action_space)
        self.is_continuous = isinstance(info.action_space, Box)
        self._build_policy(params)
        # a self-play device env's opponent seat applies the player's own
        # architecture (player.py:79-83)
        if hasattr(self.vec_env, "bind_policy") and hasattr(self, "model"):
            self.vec_env.bind_policy(self.model)
        self._last_ckpt = None

    def _build_policy(self, params):
        """The A2C model, its weights drawn from the seed."""
        config = params["config"]
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
            space = self.env_info.action_space
            self._rescale = bool(np.isfinite(space.low).all() and np.isfinite(space.high).all())
            self._action_low = torch.as_tensor(space.low, dtype=torch.float32, device=self.device)
            self._action_high = torch.as_tensor(space.high, dtype=torch.float32, device=self.device)

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

    @torch.no_grad()
    def _host_run(self, games_num: int):
        """Host-env eval (player.py:183-228): step until ``games_num``
        episodes have ended or ``max_steps`` steps, the returns kept on the
        host; one read of the actions per step."""
        act_seed = int(np.random.SeedSequence(self.seed + 1).generate_state(2)[1])
        act_generator = self._generator(act_seed)
        upload = obs_utils.HostUpload(self.device)
        host_obs = self.vec_env.reset()
        n = self.num_rows
        first_rows = np.arange(n) % self.num_agents == 0
        cur = np.zeros((n, self.value_size), np.float32)
        returns, steps = [], 0
        while len(returns) < games_num and steps < self.max_steps:
            # the observations and, with use_action_masks, the masks in one copy
            obs, masks = obs_utils.upload_obs(upload, host_obs, *((self.vec_env.get_action_masks(),)
                                                                  if self.use_action_masks else ()))
            actions = self._play_actions(act_generator, obs, masks=masks[0] if masks else None).cpu().numpy()
            host_obs, rewards, dones, _ = self.vec_env.step(actions)
            cur += np.asarray(rewards, np.float32).reshape(n, -1)
            for i in np.flatnonzero(dones):
                if first_rows[i]:
                    returns.append(cur[i].copy())
                cur[i] = 0.0
            steps += 1
        mean_reward = float(np.mean([r[0] for r in returns])) if returns else 0.0
        print(f"av reward: {mean_reward:.2f} games played: {len(returns)}")
        return mean_reward

    def _play_actions(self, generator, obs, env_state=None, masks=None):
        """env-space actions for the eval loops; ``generator`` draws the
        action noise when the player is not deterministic. With
        ``use_action_masks`` the masks are ``masks`` (a host env's) or the
        device env's for ``env_state``."""
        kw = {}
        if self.use_action_masks:
            kw["action_masks"] = masks if masks is not None else self.vec_env.get_action_masks(env_state)
        res = self.model.forward_play(
            actor_obs(obs), generator=generator, deterministic=self.deterministic, **kw
        )
        return self._env_actions(res["actions"])

    def run(self, games_num: Optional[int] = None, **_):
        games_num = games_num or self.games_num
        if self.player_cfg.get("evaluation"):
            self.maybe_load_new_checkpoint()
        if self.is_host_env:
            return self._host_run(games_num)
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
        if hasattr(self.vec_env, "init_opponent"):
            # a mirror match: the restored weights fill every opponent seat
            # (player.py:271-277)
            env_state = self.vec_env.init_opponent(env_state, self.model.state_dict())
        act_generator = self._generator(act_seed)
        n = self.num_rows
        first_rows = torch.arange(n, device=self.device) % self.num_agents == 0
        meters = meters_init(max(games_num, 1), self.value_size, self.device)
        cur_rew = torch.zeros((n, self.value_size), dtype=torch.float32, device=self.device)
        for _ in range(self.steps_needed(games_num)):
            env_state, obs, rewards, dones, infos = self.vec_env.step(
                env_state, self._play_actions(act_generator, obs, env_state)
            )
            if rewards.dim() == 1:
                rewards = rewards[:, None]
            cur_rew = cur_rew + rewards
            meters_update(meters, cur_rew, dones.to(torch.bool) & first_rows)
            cur_rew = cur_rew * (1.0 - dones.to(torch.float32))[:, None]
        games_played = int(meters.count)
        mean_reward = float(meters_mean(meters)[0]) if games_played else 0.0
        print(f"av reward: {mean_reward:.2f} games played: {games_played}")
        return mean_reward


class PpoPlayer(BasePlayer):
    pass


class SACPlayer(BasePlayer):
    """SAC evaluation (player.py:319-448; players.py SACPlayer): the
    deterministic action is tanh(mu), the stochastic one a squashed-normal
    sample, each rescaled and clipped to the env's bounds. It restores the
    actor and the input normalizer from a SAC checkpoint's sections."""

    def _build_policy(self, params):
        if not self.is_continuous:
            raise ValueError(f"SAC requires a continuous action space, the env has {self.env_info.action_space}")
        if isinstance(self.obs_shape, dict) or len(self.obs_shape) != 1:
            unported(f"SAC over observations of shape {self.obs_shape}", "A8")
        self.actor, _ = build_sac_networks(params["network"], self.obs_shape[0], self.actions_num,
                                           device=self.device)
        layers.reset_parameters(self.actor, self._generator(self.seed))
        self.running_mean_std = (RunningMeanStd(self.obs_shape, device=self.device)
                                 if params["config"].get("normalize_input", False) else None)
        self._rescale_actions = ActionRescale(self.env_info.action_space, self.actions_num, self.device)

    def restore(self, checkpoint_path: str):
        """The actor and the normalizer from a SAC checkpoint (the port's,
        or a reference SAC .pth, its sections at the top or under 'model')."""
        payload = ckpt.read_payload(checkpoint_path)
        if "model" in payload and "actor" not in payload:
            payload = payload["model"]
        self.actor.load_state_dict(payload["actor"])
        if payload.get("running_mean_std") is not None:
            load_normalizer(self.running_mean_std, payload["running_mean_std"])

    def override_sigma(self, sigma: float):
        """The SAC actor has no sigma parameter to overwrite; the reference
        no-ops with a message (torch_runner.py:52-60)."""
        print("Cannot set new sigma: SAC policy has no fixed sigma parameter")

    def _play_actions(self, generator, obs, env_state=None, masks=None):
        if self.running_mean_std is not None:
            obs = self.running_mean_std.normalize(obs)
        mu, std = self.actor(obs)
        if self.deterministic:
            actions = torch.tanh(mu)
        else:
            noise = torch.randn(mu.shape, generator=generator, device=self.device)
            actions, _ = SACActor.sample(mu, std, noise)
        return self._rescale_actions(actions)
