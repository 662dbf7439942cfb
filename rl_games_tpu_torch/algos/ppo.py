"""PPO over device-resident envs, in PyTorch.

Port of the non-recurrent, single-agent subset of rl_games_tpu/algos/ppo.py,
continuous and discrete (the reference's a2c_common.py play_steps
:787-850 and train_epoch :1241-1307, a2c_continuous.py, a2c_discrete.py).
One epoch (``train_epoch``) is

    rollout  = horizon × (policy forward + sample + env step + autoreset)
    gae      = ops.gae.compute_gae (the CUDA kernel on the card)
    dataset  = value / advantage normalization
    updates  = mini_epochs × minibatches × (grad step + legacy adaptive LR)

with the JAX package's semantics: the value bootstrap at time-outs
(a2c_common.py:813-814), the two-step value-normalizer update
(:1325-1332), advantage normalization, the 'legacy' per-minibatch
adaptive LR with mu/sigma writeback for continuous actions
(datasets.py:33-43), episode meters and the epoch/frame counters. Discrete
actions are stored as integers and passed to the env as they are; their
adaptive-LR KL is 0.5 · mean((old neglogp − neglogp)²) (ppo.py:959-962).
The JAX package compiles the epoch into one
program over an immutable state; here it runs eagerly, the weights and
normalizer stats live in ``agent.model`` (an ``nn.Module``) and the rest of
the train state in a ``PPOTrainState`` that ``train_epoch`` updates in
place. Nothing in an epoch reads a device value on the host. The
trajectory is written into tensors allocated once per rollout (the
observations env-major, so that flattening them into the dataset is a
view, not a second copy of the largest tensor of the epoch).

``train`` is the host loop around it (ContinuousA2CBase.train,
a2c_common.py:1372-1492): run directories, resume from a checkpoint,
logging, the algo observer's hooks (``features.observer``), the three
kinds of checkpoint and the stop conditions. Metrics cross to the host only
on log epochs. With ``use_diagnostics`` an epoch also reports kl and the
clip fraction per mini-epoch and the normalizers' state (PpoDiagnostics,
diagnostics.py:18-60), and the rollout is timed once so that the step rate
is reported apart from the update.
"""

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rl_games_tpu_torch.common.obs_utils import fill_sigma, sigma_override_blocked
from rl_games_tpu_torch.common.tr_helpers import (
    build_reward_shaper,
    rescale_actions,
    swap_and_flatten01,
)
from rl_games_tpu_torch.envs import registry as env_registry
from rl_games_tpu_torch.envs.device.base import VecEnvState
from rl_games_tpu_torch.envs.spaces import Box, Discrete, actions_num_of, obs_shape_of
from rl_games_tpu_torch.models import model_builder
from rl_games_tpu_torch.ops import losses as L
from rl_games_tpu_torch.ops import masked as MK
from rl_games_tpu_torch.ops.gae import compute_gae
from rl_games_tpu_torch.ops.schedulers import build_scheduler
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.device import resolve_device, use_full_float32
from rl_games_tpu_torch.utils.unported import unported
from rl_games_tpu_torch.utils.writer import create_writer, write_ppo_stats

_METRIC_KEYS = ("a_loss", "c_loss", "entropy", "b_loss", "kl", "clip_frac")
# Checkpoints carry the reference's extension: their 'model' section has the
# reference's .pth layout, so the JAX package's importer reads them.
CHECKPOINT_EXT = ".pth"


# ---------------------------------------------------------------------------
# Episode meters (ppo.py:61-95, torch_ext.AverageMeter :319-345): a ring of
# the last `capacity` completed episodes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Meters:
    # [capacity + 1, width]: rows [0, capacity) are the ring; the extra last
    # row absorbs the scatter writes of rows that did not finish, so the
    # update needs no data-dependent indexing (and no device sync)
    buf: torch.Tensor
    ptr: torch.Tensor  # () int32
    count: torch.Tensor  # () int32, total filled, clamped to capacity

    @property
    def capacity(self) -> int:
        return self.buf.shape[0] - 1


def meters_init(capacity: int, width: int, device) -> Meters:
    return Meters(
        buf=torch.zeros((capacity + 1, width), dtype=torch.float32, device=device),
        ptr=torch.zeros((), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def meters_update(m: Meters, values, mask):
    """Scatter the rows where ``mask`` is set into the ring, in place. When
    more rows finish in one call than the ring holds, slots repeat and which
    write wins is unspecified, as in the JAX package."""
    cap = m.capacity
    mask_i = mask.to(torch.int32)
    slot = torch.cumsum(mask_i, dim=0) - 1  # position among the done rows
    pos = torch.remainder(m.ptr + slot, cap)
    pos = torch.where(mask, pos, torch.full_like(pos, cap)).to(torch.int64)
    m.buf.index_put_((pos,), values.to(torch.float32))
    n = mask_i.sum(dtype=torch.int32)
    m.ptr.copy_(torch.remainder(m.ptr + n, cap))
    m.count.copy_(torch.clamp(m.count + n, max=cap))


def meters_mean(m: Meters):
    cap = m.capacity
    idx = torch.arange(cap, device=m.buf.device)[:, None]
    valid = (idx < m.count).to(torch.float32)
    total = torch.clamp(m.count.to(torch.float32), min=1.0)
    return (m.buf[:cap] * valid).sum(0) / total


def _to_host(tree):
    """A metrics dict (nested dicts of tensors) as numpy values."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Optimizer: optax's clip_by_global_norm → add_decayed_weights → scale_by_adam
# → scale(-1), times the LR in the train state (ppo.py:436-447, 1011-1013),
# written out by hand. torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6;
# optax divides by the norm itself.
# ---------------------------------------------------------------------------

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # () int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params) -> AdamState:
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


@torch.no_grad()
def adam_step(params, grads, opt: AdamState, lr, max_norm: Optional[float] = None,
              weight_decay: float = 0.0):
    """One clip → weight decay → Adam step, updating params and opt in place
    (the moments and weights are rewritten where they lie)."""
    if max_norm is not None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        trigger = g_norm < max_norm
        grads = [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]
    if weight_decay > 0:
        grads = [g + weight_decay * p for g, p in zip(grads, params)]
    opt.count.add_(1)
    count_f = opt.count.to(torch.float32)
    bc1 = 1.0 - _B1 ** count_f
    bc2 = 1.0 - _B2 ** count_f
    for p, g, mu, nu in zip(params, grads, opt.mu, opt.nu):
        mu.copy_((1.0 - _B1) * g + _B1 * mu)
        nu.copy_((1.0 - _B2) * (g * g) + _B2 * nu)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + _ADAM_EPS)
        p.add_(-update * lr)


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PPOTrainState:
    opt_state: AdamState
    lr: torch.Tensor  # () f32
    entropy_coef: torch.Tensor  # () f32
    epoch: torch.Tensor  # () int32
    frame: torch.Tensor  # () int32
    generator: torch.Generator  # action noise
    env_state: VecEnvState
    obs: torch.Tensor
    dones: torch.Tensor  # [N] f32 — dones entering the next step
    current_rewards: torch.Tensor  # [N, value_size]
    current_shaped_rewards: torch.Tensor
    current_lengths: torch.Tensor  # [N]
    game_rewards: Meters
    game_shaped_rewards: Meters
    game_lengths: Meters


class PPOAgent:
    """PPO trainer for continuous or discrete actions over device envs.

    ``params`` is the reference YAML ``params:`` dict (algo / model /
    network / config). ``device`` defaults to CUDA; without CUDA that
    raises, and the CPU is taken only when asked for.
    """

    def __init__(self, base_name: str, params: dict, device=None):
        self.base_name = base_name
        self.full_params = params
        config = params["config"]
        self.config = config
        self.device = resolve_device(device)
        use_full_float32(self.device)
        self._refuse_unported(params)

        # --- env ------------------------------------------------------------
        self.num_actors = config["num_actors"]
        self.vec_env = env_registry.create_vec_env(
            config["env_name"], self.num_actors,
            vecenv_type=config.get("vecenv_type"), device=self.device,
            **config.get("env_config", {}),
        )
        info = self.vec_env.get_env_info()
        self.env_info = info
        self.value_size = info.value_size
        self.num_agents = info.agents
        if self.num_agents != 1:
            raise NotImplementedError("multi-agent envs are not ported yet (see ROADMAP.md)")
        self.observation_space = info.observation_space
        self.action_space = info.action_space
        self.obs_shape = obs_shape_of(info.observation_space)
        self.actions_num = actions_num_of(info.action_space)
        self.is_continuous = isinstance(info.action_space, Box)
        if not self.is_continuous and not isinstance(info.action_space, Discrete):
            unported(f"the action space {info.action_space}", "A8")

        # --- config (a2c_common.py:137-330) ---------------------------------
        self.horizon_length = config["horizon_length"]
        self.batch_size = self.horizon_length * self.num_actors
        if "minibatch_size" not in config and "minibatch_size_per_env" not in config:
            raise ValueError("Config must include 'minibatch_size' or 'minibatch_size_per_env'")
        self.minibatch_size = config.get(
            "minibatch_size", self.num_actors * config.get("minibatch_size_per_env", 0)
        )
        if self.minibatch_size <= 0:
            raise ValueError("'minibatch_size' must be > 0")
        if self.batch_size % self.minibatch_size != 0:
            raise ValueError(
                f"batch_size ({self.batch_size}) must be divisible by "
                f"minibatch_size ({self.minibatch_size})"
            )
        self.num_minibatches = self.batch_size // self.minibatch_size
        self.mini_epochs_num = config["mini_epochs"]
        self.e_clip = config["e_clip"]
        self.clip_value = config["clip_value"]
        self.gamma = config["gamma"]
        self.tau = config["tau"]
        self.ppo = config.get("ppo", True)
        self.critic_coef = config["critic_coef"]
        self.entropy_coef_init = config["entropy_coef"]
        self.bounds_loss_coef = config.get("bounds_loss_coef", None)
        self.bound_loss_type = config.get("bound_loss_type", "bound")
        self.grad_norm = config["grad_norm"]
        self.truncate_grads = config.get("truncate_grads", False)
        self.normalize_advantage = config["normalize_advantage"]
        self.normalize_input = config["normalize_input"]
        self.normalize_value = config.get("normalize_value", False)
        self.freeze_critic = config.get("freeze_critic", False)
        self.value_bootstrap = config.get("value_bootstrap", True)
        self.use_smooth_clamp = config.get("use_smooth_clamp", False)
        self.weight_decay = config.get("weight_decay", 0.0)
        self.learning_rate = float(config["learning_rate"])
        self.schedule_type = config.get("schedule_type", "legacy")
        self.max_epochs = config.get("max_epochs", -1)
        self.max_frames = max(config.get("max_frames", -1), config.get("max_steps", -1))
        self.games_to_track = config.get("games_to_track", 100)
        self.clip_actions = config.get("clip_actions", True)
        self.seed = config.get("seed", 7)
        self.save_freq = config.get("save_frequency", 0)
        self.save_best_after = config.get("save_best_after", 100)
        self.score_to_win = config.get("score_to_win", None)
        self.scheduler = build_scheduler(
            {**config, "max_epochs": self.max_epochs, "max_frames": self.max_frames},
            self.learning_rate,
        )
        if self.max_frames > 2**31 - 1:
            raise ValueError(
                f"max_frames {self.max_frames} exceeds the int32 frame counter"
            )
        self.rewards_shaper = build_reward_shaper(config)
        self.use_diagnostics = config.get("use_diagnostics", False)
        self.observer = (config.get("features") or {}).get("observer")
        self._rollout_time = None  # measured under use_diagnostics

        # --- model ----------------------------------------------------------
        self.model = model_builder.ModelBuilder().load(
            params,
            actions_num=self.actions_num,
            input_shape=self.obs_shape,
            value_size=self.value_size,
            normalize_input=self.normalize_input,
            normalize_value=self.normalize_value,
            obs_shape=self.obs_shape,
            device=self.device,
        )
        self.params = list(self.model.parameters())

        if self.is_continuous:
            space = self.action_space
            self._rescale = bool(np.isfinite(space.low).all() and np.isfinite(space.high).all())
            self._action_low = torch.as_tensor(space.low, dtype=torch.float32, device=self.device)
            self._action_high = torch.as_tensor(space.high, dtype=torch.float32, device=self.device)

    @staticmethod
    def _refuse_unported(params: dict):
        """Options the JAX PPOAgent has and this port does not yet."""
        config = params["config"]
        network = params.get("network", {})
        features = config.get("features") or {}
        options = {
            "an RNN torso (network.rnn; ROADMAP.md, item A9)": "rnn" in network,
            "a central value net (central_value_config; ROADMAP.md, item A9)": config.get("central_value_config") is not None,
            "RND curiosity (rnd_config; ROADMAP.md, item A9)": bool(config.get("rnd_config")),
            "soft augmentation (features.soft_augmentation; ROADMAP.md, item A9)": bool(features.get("soft_augmentation")),
            "host envs (vecenv_type; ROADMAP.md, item A11)": config.get("vecenv_type") not in (None, "JAX", "DEVICE"),
            "action masks (use_action_masks; ROADMAP.md, item A8)": config.get("use_action_masks", False),
            "mixed precision (mixed_precision)": config.get("mixed_precision", False),
            "minibatch permutation (permute_batches)": config.get("permute_batches", False),
            "RMS advantage normalization (normalize_rms_advantage; ROADMAP.md, item A2)":
                config.get("normalize_rms_advantage", False),
            "population based training (pbt; ROADMAP.md, item A12)": bool((config.get("pbt") or {}).get("enabled")),
            "self-play (self_play_config; ROADMAP.md, item A12)": bool(config.get("self_play_config")),
        }
        for what, asked in options.items():
            if asked:
                raise NotImplementedError(
                    f"{what} is not ported to rl_games_tpu_torch yet (see ROADMAP.md)"
                )

    # ------------------------------------------------------------------
    # state construction
    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> PPOTrainState:
        """Draw fresh weights into ``self.model``, reset its normalizers and
        the envs, and return the rest of the train state."""
        seed = self.seed if seed is None else seed
        model_seed, env_seed, act_seed = (
            int(s) for s in np.random.SeedSequence(seed).generate_state(3)
        )

        def generator(s):
            return torch.Generator(device=self.device).manual_seed(s)

        self.model.reset_parameters(generator(model_seed))
        env_state, obs = self.vec_env.reset(generator(env_seed))
        n, v = self.num_actors, self.value_size
        f32 = dict(dtype=torch.float32, device=self.device)
        return PPOTrainState(
            opt_state=adam_init(self.params),
            lr=torch.tensor(self.learning_rate, **f32),
            entropy_coef=torch.tensor(self.entropy_coef_init, **f32),
            epoch=torch.zeros((), dtype=torch.int32, device=self.device),
            frame=torch.zeros((), dtype=torch.int32, device=self.device),
            generator=generator(act_seed),
            env_state=env_state,
            obs=obs,
            dones=torch.ones(n, **f32),  # a2c_common: initial dones = ones
            current_rewards=torch.zeros((n, v), **f32),
            current_shaped_rewards=torch.zeros((n, v), **f32),
            current_lengths=torch.zeros(n, **f32),
            game_rewards=meters_init(self.games_to_track, v, self.device),
            game_shaped_rewards=meters_init(self.games_to_track, v, self.device),
            game_lengths=meters_init(self.games_to_track, 1, self.device),
        )

    # ------------------------------------------------------------------
    # pieces of the epoch
    # ------------------------------------------------------------------
    def _env_actions(self, actions):
        """Clip/rescale continuous actions for the env (a2c_common:1224-1234);
        discrete ones go as they are."""
        if not self.is_continuous:
            return actions
        a = torch.clamp(actions, -1.0, 1.0) if self.clip_actions else actions
        if self._rescale:
            return rescale_actions(self._action_low, self._action_high, a)
        return a

    def _trajectory_buffers(self):
        """Uninitialized [T, N, ...] trajectory tensors that the rollout fills
        step by step. The observations lie env-major ([N, T, ...] in memory,
        a transposed view here), so that swap_and_flatten01 of them is a
        view: at 512 envs × 64 steps of 84×84×2 frames they are 1.85 GB."""
        T, N, V = self.horizon_length, self.num_actors, self.value_size
        f32 = dict(dtype=torch.float32, device=self.device)
        traj = {
            "obses": torch.empty((N, T, *self.obs_shape), **f32).transpose(0, 1),
            "dones": torch.empty((T, N), **f32),
            "values": torch.empty((T, N, V), **f32),
            "neglogpacs": torch.empty((T, N), **f32),
            "rewards": torch.empty((T, N, V), **f32),
        }
        if self.is_continuous:
            for k in ("actions", "mus", "sigmas"):
                traj[k] = torch.empty((T, N, self.actions_num), **f32)
        else:
            traj["actions"] = torch.empty((T, N), dtype=torch.int64, device=self.device)
        return traj

    @torch.no_grad()
    def _rollout(self, state: PPOTrainState):
        """horizon_length policy + env steps (play_steps, a2c_common.py:787-850).
        Returns the trajectory (each entry [T, N, ...]) and the bootstrap
        values of the final observations; updates ``state``."""
        model = self.model
        env_state, obs, dones = state.env_state, state.obs, state.dones
        cur_r, cur_sr = state.current_rewards, state.current_shaped_rewards
        cur_len = state.current_lengths
        traj = self._trajectory_buffers()
        for t in range(self.horizon_length):
            res = model.forward_play(obs, generator=state.generator)
            env_state, next_obs, rewards, new_dones, infos = self.vec_env.step(
                env_state, self._env_actions(res["actions"])
            )
            if rewards.dim() == 1:
                rewards = rewards[:, None]
            rewards = rewards.to(torch.float32)
            shaped = self.rewards_shaper(rewards)
            values = res["values"]
            if self.value_bootstrap:
                shaped = shaped + self.gamma * values * infos["time_outs"].to(torch.float32)[:, None]

            # episode accounting (a2c_common.py:820-834)
            cur_r = cur_r + rewards
            cur_sr = cur_sr + shaped
            cur_len = cur_len + 1.0
            done_mask = new_dones.to(torch.bool)
            meters_update(state.game_rewards, cur_r, done_mask)
            meters_update(state.game_shaped_rewards, cur_sr, done_mask)
            meters_update(state.game_lengths, cur_len[:, None], done_mask)
            not_done = 1.0 - new_dones.to(torch.float32)
            cur_r = cur_r * not_done[:, None]
            cur_sr = cur_sr * not_done[:, None]
            cur_len = cur_len * not_done

            step = {**res, "obses": obs, "dones": dones, "values": values, "rewards": shaped}
            for k, buf in traj.items():
                buf[t] = step[k]
            obs, dones = next_obs, new_dones.to(torch.float32)

        # bootstrap values for the final obs (get_values, a2c_common:474-483);
        # they do not depend on the sample, so none is drawn
        last_values = model.forward_play(obs, deterministic=True)["values"]
        state.env_state, state.obs, state.dones = env_state, obs, dones
        state.current_rewards, state.current_shaped_rewards = cur_r, cur_sr
        state.current_lengths = cur_len
        return traj, last_values

    @torch.no_grad()
    def _prepare_dataset(self, state: PPOTrainState, traj, last_values):
        """GAE + dataset assembly (a2c_common.py:836-849, 1309-1370)."""
        mb_values = traj["values"]  # [T, N, V] (denormalized)
        mb_advs = compute_gae(
            traj["rewards"], mb_values, traj["dones"], last_values, state.dones,
            self.gamma, self.tau,
        )
        mb_returns = mb_advs + mb_values

        dataset = {k: swap_and_flatten01(v) for k, v in traj.items()}
        returns = swap_and_flatten01(mb_returns)
        values = dataset.pop("values")
        advantages = returns - values  # [B, V]

        model = self.model
        model.update_obs_stats(dataset["obses"])
        # value-normalizer parity: the reference runs TWO train-mode
        # forwards, value_mean_std(values) then value_mean_std(returns)
        # (a2c_common.py:1325-1332), so the stats advance from both batches
        # and returns normalize with the post-values stats
        if self.normalize_value:
            if not self.freeze_critic:
                model.update_value_stats(values)
            values = model.normalize_values(values)
            if not self.freeze_critic:
                model.update_value_stats(returns)
            returns = model.normalize_values(returns)

        advantages = advantages.sum(dim=1)  # [B] (a2c_common:1334)
        if self.normalize_advantage:
            advantages = L.normalize_advantage(advantages)
        dataset["old_values"] = values
        dataset["returns"] = returns
        dataset["advantages"] = advantages
        dataset["old_logp_actions"] = dataset.pop("neglogpacs")
        return dataset

    def _loss_and_kl(self, mb, entropy_coef):
        """Loss assembly (a2c_continuous.py:97-133, a2c_discrete.py:116-190).
        Returns the scalar loss and detached diagnostics."""
        res = self.model.forward_train(mb["obses"], mb["actions"])
        actor_loss_fn = L.smoothed_actor_loss if self.use_smooth_clamp else L.actor_loss
        a_loss = actor_loss_fn(
            mb["old_logp_actions"], res["prev_neglogp"], mb["advantages"], self.ppo, self.e_clip
        )
        c_loss = L.critic_loss(
            mb["old_values"], res["values"], self.e_clip, mb["returns"], self.clip_value
        )
        if self.is_continuous and self.bounds_loss_coef is not None:
            if self.bound_loss_type == "regularisation":
                b_loss = L.reg_loss(res["mus"])
            else:
                b_loss = L.bound_loss(res["mus"])
        else:
            b_loss = torch.zeros_like(a_loss)
        a_loss_m = a_loss.mean()
        c_loss_m = c_loss.mean()
        entropy_m = res["entropy"].mean()
        b_loss_m = b_loss.mean()
        total = (
            a_loss_m
            + 0.5 * self.critic_coef * c_loss_m
            - entropy_coef * entropy_m
            + (self.bounds_loss_coef or 0.0) * b_loss_m
        )
        with torch.no_grad():
            if self.is_continuous:
                kl = self.model.kl(res["mus"], res["sigmas"], mb["mus"], mb["sigmas"]).mean()
            else:
                kl = 0.5 * torch.square(mb["old_logp_actions"] - res["prev_neglogp"]).mean()
            clip_frac = MK.policy_clip_fraction(
                res["prev_neglogp"], mb["old_logp_actions"], self.e_clip
            )
        aux = {
            "a_loss": a_loss_m.detach(), "c_loss": c_loss_m.detach(),
            "entropy": entropy_m.detach(), "b_loss": b_loss_m.detach(),
            "kl": kl, "clip_frac": clip_frac,
        }
        if self.is_continuous:
            aux["mus"], aux["sigmas"] = res["mus"].detach(), res["sigmas"].detach()
        return total, aux

    def _update(self, state: PPOTrainState, dataset) -> Dict[str, torch.Tensor]:
        """Minibatch epochs over ordered contiguous slices (train_epoch,
        a2c_common.py:1269-1302; datasets.py)."""
        legacy = self.schedule_type == "legacy"
        lr, ec = state.lr, state.entropy_coef
        max_norm = self.grad_norm if self.truncate_grads else None
        metrics = {k: torch.zeros((), dtype=torch.float32, device=self.device) for k in _METRIC_KEYS}
        diag = {"kl": [], "clip_frac": []}
        for _ in range(self.mini_epochs_num):
            ms = {k: [] for k in _METRIC_KEYS}
            for i in range(self.num_minibatches):
                sl = slice(i * self.minibatch_size, (i + 1) * self.minibatch_size)
                mb = {k: v[sl] for k, v in dataset.items()}
                total, aux = self._loss_and_kl(mb, ec)
                grads = torch.autograd.grad(total, self.params)
                adam_step(self.params, grads, state.opt_state, lr, max_norm, self.weight_decay)
                if legacy:
                    if self.is_continuous:
                        # mu/sigma writeback (datasets.py:33-43), in place
                        # in the dataset rather than into a copy of it
                        dataset["mus"][sl] = aux["mus"]
                        dataset["sigmas"][sl] = aux["sigmas"]
                    lr, ec = self.scheduler.update(lr, ec, state.epoch, state.frame, aux["kl"])
                for k in _METRIC_KEYS:
                    ms[k].append(aux[k])
            ms = {k: torch.stack(v) for k, v in ms.items()}
            if not legacy:
                lr, ec = self.scheduler.update(lr, ec, state.epoch, state.frame, ms["kl"].mean())
            metrics = {k: metrics[k] + ms[k].mean() / self.mini_epochs_num for k in _METRIC_KEYS}
            if self.use_diagnostics:
                for k in diag:
                    diag[k].append(ms[k].mean())
        state.lr, state.entropy_coef = lr, ec
        if self.use_diagnostics:
            # per-mini-epoch kl and clip fraction (ppo.py:1060-1090)
            metrics["_diag"] = {k: torch.stack(v) for k, v in diag.items()}
        return metrics

    def _finish_epoch(self, state: PPOTrainState, traj, last_values):
        """prepare_dataset → minibatch updates → counters and metrics."""
        dataset = self._prepare_dataset(state, traj, last_values)
        metrics = self._update(state, dataset)
        # PpoDiagnostics explained variance (diagnostics.py:18-60)
        metrics["explained_variance"] = MK.explained_variance(
            dataset["old_values"].reshape(-1), dataset["returns"].reshape(-1)
        )
        if self.use_diagnostics:
            # the normalizers' state (ppo.py:1274-1282)
            model = self.model
            if self.normalize_input:
                metrics["_diag"]["obs_rms_mean"] = model.running_mean_std.running_mean.mean()
                metrics["_diag"]["obs_rms_var"] = model.running_mean_std.running_var.mean()
            if self.normalize_value:
                metrics["_diag"]["value_rms_mean"] = model.value_mean_std.running_mean.mean()
                metrics["_diag"]["value_rms_var"] = model.value_mean_std.running_var.mean()
        state.epoch = state.epoch + 1
        state.frame = state.frame + self.batch_size
        metrics["lr"] = state.lr
        metrics["e_clip"] = torch.full((), self.e_clip, dtype=torch.float32, device=self.device)
        metrics["entropy_coef"] = state.entropy_coef
        metrics["mean_rewards"] = meters_mean(state.game_rewards)
        metrics["mean_shaped_rewards"] = meters_mean(state.game_shaped_rewards)
        metrics["mean_lengths"] = meters_mean(state.game_lengths)[0]
        metrics["games_played"] = state.game_rewards.count.clone()
        metrics["frame"] = state.frame
        metrics["epoch"] = state.epoch
        return state, metrics

    def train_epoch(self, state: PPOTrainState):
        """One full PPO epoch: rollout → GAE → minibatch updates."""
        traj, last_values = self._rollout(state)
        return self._finish_epoch(state, traj, last_values)

    # ------------------------------------------------------------------
    # weights and checkpoints (a2c_common.py:645-710). The JAX package keeps
    # params and normalizer stats in the train state; here they live in
    # ``self.model``, so the weights calls take no state.
    # ------------------------------------------------------------------
    def clear_stats(self, state: PPOTrainState) -> PPOTrainState:
        """Reset episode meters + accumulators, then tell the observer
        (algo.clear_stats, a2c_common.py:645-648)."""
        n, v = self.num_actors, self.value_size
        f32 = dict(dtype=torch.float32, device=self.device)
        state.current_rewards = torch.zeros((n, v), **f32)
        state.current_shaped_rewards = torch.zeros((n, v), **f32)
        state.current_lengths = torch.zeros(n, **f32)
        state.game_rewards = meters_init(self.games_to_track, v, self.device)
        state.game_shaped_rewards = meters_init(self.games_to_track, v, self.device)
        state.game_lengths = meters_init(self.games_to_track, 1, self.device)
        if self.observer is not None:
            self.observer.after_clear_stats()
        return state

    def _calibrate_rollout_time(self, state: PPOTrainState):
        """The rollout's time alone, best of three after a warm-up, so that
        the step rate can be reported apart from the update
        (a2c_common.py:399-404; ppo.py:1543-1557). The state is put back as
        it was. Returns (seconds, state)."""
        saved = ckpt.tree_to_plain(state)
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            self._rollout(state)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times.append(time.perf_counter() - t0)
        return min(times[1:]), ckpt.tree_from_plain(state, saved)

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """Model weights + normalizer stats (a2c_common.py:690-710): a copy
        of ``model.state_dict()``, the reference checkpoint's 'model'."""
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def set_weights(self, weights):
        self.model.load_state_dict(weights)

    def get_full_state_weights(self, state: PPOTrainState,
                               last_mean_rewards: float = -100500.0) -> dict:
        """The full resumable training state (a2c_common.py:650-668) as
        plain containers of CPU tensors: weights, optimizer moments,
        counters, generators, env state and meters."""
        return {
            "state": ckpt.tree_to_plain(state),
            "weights": ckpt.tree_to_plain(self.get_weights()),
            "epoch": int(state.epoch),
            "frame": int(state.frame),
            "last_mean_rewards": last_mean_rewards,
        }

    def set_full_state_weights(self, state: PPOTrainState, full: dict,
                               set_epoch: bool = True) -> PPOTrainState:
        """a2c_common.py:670-688: restore everything into ``state``'s
        structure; ``set_epoch=False`` keeps the current counters."""
        epoch, frame = state.epoch, state.frame
        new = ckpt.tree_from_plain(state, full["state"])
        if not set_epoch:
            new.epoch, new.frame = epoch, frame
        self.set_weights(full["weights"])
        return new

    def override_sigma(self, sigma: float):
        """--sigma CLI override (_override_sigma, torch_runner.py:52-60)."""
        blocked = sigma_override_blocked(self.is_continuous, self.full_params.get("network", {}))
        if blocked:
            print(blocked)
            return
        fill_sigma(self.model, sigma)

    def _save(self, path: str, state: PPOTrainState, meta: dict):
        ckpt.save_checkpoint(path, state, meta, weights=self.model.state_dict())

    # ------------------------------------------------------------------
    # host train loop (ContinuousA2CBase.train, a2c_common.py:1372-1492)
    # ------------------------------------------------------------------
    def train(self, checkpoint: Optional[str] = None, stop_fn=None, writer=None,
              max_epochs: Optional[int] = None, sigma: Optional[float] = None):
        """Train until max_epochs / max_frames / score_to_win / stop_fn.
        Returns (last_mean_rewards, epoch_num); the final state stays in
        ``self.last_state``."""
        config = self.config
        experiment_name = config.get("name", config.get("full_experiment_name", self.base_name))
        experiment_dir = os.path.join(config.get("train_dir", "runs"), experiment_name)
        nn_dir = os.path.join(experiment_dir, "nn")
        os.makedirs(nn_dir, exist_ok=True)

        state = self.init_state()
        last_mean_rewards = -100500.0  # reference sentinel
        if checkpoint:
            payload = ckpt.read_payload(checkpoint)
            weights, meta = ckpt.load_checkpoint_weights(checkpoint, payload=payload)
            self.set_weights(weights)
            if "state" in payload:
                state, meta = ckpt.load_checkpoint(checkpoint, state, payload=payload)
                last_mean_rewards = meta.get("last_mean_rewards", last_mean_rewards)
            # else: a weights-only file (a reference .pth) is a warm start
        if sigma is not None:
            self.override_sigma(sigma)

        if writer is None:
            writer = create_writer(os.path.join(experiment_dir, "summaries"))
        self.writer = writer
        observer = self.observer
        if observer is not None:
            observer.before_init(self.base_name, config, experiment_name)
            observer.after_init(self)
        max_epochs = self.max_epochs if max_epochs is None else max_epochs
        if self.use_diagnostics and self._rollout_time is None:
            self._rollout_time, state = self._calibrate_rollout_time(state)

        # metrics reach the host only every ``log_interval`` epochs; loop
        # control stays host-side (epoch and frame advance deterministically)
        log_interval = max(1, int(config.get("log_interval", 1)))
        epoch_num = int(state.epoch)
        frame = epoch_num * self.batch_size

        start_time = time.perf_counter()
        t_last_log, ep_last_log = start_time, epoch_num
        best_path = os.path.join(nn_dir, experiment_name + CHECKPOINT_EXT)
        while True:
            state, metrics_dev = self.train_epoch(state)
            epoch_num += 1
            frame += self.batch_size
            will_exit = (
                (max_epochs > 0 and epoch_num >= max_epochs)
                or (self.max_frames > 0 and frame >= self.max_frames)
            )
            # stop_fn is consulted every epoch regardless of log cadence
            self.last_state = state
            stop_requested = stop_fn is not None and stop_fn(self)
            do_log = (epoch_num % log_interval == 0) or will_exit or stop_requested
            save_due = self.save_freq > 0 and epoch_num % self.save_freq == 0
            if not (do_log or save_due):
                continue
            meta = {"last_mean_rewards": last_mean_rewards, "epoch": epoch_num, "frame": frame}
            last_path = os.path.join(nn_dir, f"last_{experiment_name}_ep_{epoch_num}{CHECKPOINT_EXT}")
            if not do_log:
                self._save(last_path, state, meta)
                continue
            metrics = _to_host(metrics_dev)
            now = time.perf_counter()
            total_time = now - start_time
            # divide by the ACTUAL epochs since the last log: an early log
            # (will_exit / stop_fn) covers fewer than log_interval
            epoch_time = (now - t_last_log) / max(epoch_num - ep_last_log, 1)
            t_last_log, ep_last_log = now, epoch_num
            fps_total = self.batch_size / max(epoch_time, 1e-9)
            # with the rollout timed on its own (use_diagnostics) the step
            # rate leaves out the update; env and inference stay together
            fps_step = fps_total if self._rollout_time is None else self.batch_size / max(self._rollout_time, 1e-9)
            write_ppo_stats(writer, metrics, frame, epoch_num, total_time, fps_total,
                            fps_step, self.value_size)
            writer.add_scalar("info/explained_variance", float(metrics["explained_variance"]), frame)
            diag = metrics.get("_diag")
            if diag is not None:  # ppo.py:1933-1948
                for i in range(self.mini_epochs_num):
                    writer.add_scalar(f"diagnostics/kl/{i}", float(diag["kl"][i]), frame)
                    writer.add_scalar(f"diagnostics/clip_frac/{i}", float(diag["clip_frac"][i]), frame)
                for k in ("obs_rms_mean", "obs_rms_var", "value_rms_mean", "value_rms_var"):
                    if k in diag:
                        writer.add_scalar(f"diagnostics/{k}", float(diag[k]), frame)
            if observer is not None:
                observer.after_epoch(metrics)
                observer.after_print_stats(frame, epoch_num, total_time)
            games_played = int(metrics["games_played"])
            mean_rewards = float(metrics["mean_rewards"][0]) if games_played else None
            if config.get("print_stats", True):
                print(
                    f"fps total: {fps_total:.0f} epoch: {epoch_num}"
                    + (f"/{max_epochs}" if max_epochs > 0 else "")
                    + f" frames: {frame}"
                    + (f" rew: {mean_rewards:.2f}" if mean_rewards is not None else "")
                )

            if save_due:
                self._save(last_path, state, meta)
            if (
                mean_rewards is not None
                and epoch_num >= self.save_best_after
                and mean_rewards > last_mean_rewards
            ):
                last_mean_rewards = mean_rewards
                meta["last_mean_rewards"] = last_mean_rewards
                self._save(best_path, state, meta)
                if self.score_to_win is not None and mean_rewards > self.score_to_win:
                    print("Maximum reward achieved. Network won!")
                    break
            should_exit = will_exit
            if max_epochs > 0 and epoch_num >= max_epochs:
                print("MAX EPOCHS NUM!")
            if self.max_frames > 0 and frame >= self.max_frames:
                print("MAX FRAMES NUM!")
            if stop_requested:
                print("Custom stop condition met!")
                should_exit = True
            if should_exit:
                self._save(
                    os.path.join(
                        nn_dir,
                        f"last_{experiment_name}_ep_{epoch_num}_rew_"
                        f"{mean_rewards if mean_rewards is not None else 0:.2f}{CHECKPOINT_EXT}",
                    ),
                    state, meta,
                )
                break

        writer.flush()
        self.last_state = state
        return last_mean_rewards, epoch_num
