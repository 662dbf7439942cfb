"""PPO over device-resident envs, in PyTorch.

Port of the continuous, flat-observation subset of rl_games_tpu/algos/ppo.py
(the reference's a2c_common.py play_steps :787-850 and train_epoch
:1241-1307). One epoch (``train_epoch``) is

    rollout  = horizon × (policy forward + sample + env step + autoreset)
    gae      = ops.gae.compute_gae (the CUDA kernel on the card)
    dataset  = value / advantage normalization
    updates  = mini_epochs × minibatches × (grad step + legacy adaptive LR)

with the JAX package's semantics: the value bootstrap at time-outs
(a2c_common.py:813-814), the two-step value-normalizer update
(:1325-1332), advantage normalization, the 'legacy' per-minibatch
adaptive LR with mu/sigma writeback (datasets.py:33-43), episode meters
and the epoch/frame counters. The JAX package compiles the epoch into one
program over an immutable state; here it runs eagerly, the weights and
normalizer stats live in ``agent.model`` (an ``nn.Module``) and the rest of
the train state in a ``PPOTrainState`` that ``train_epoch`` updates in
place. Nothing in an epoch reads a device value on the host.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from rl_games_tpu_torch.common.tr_helpers import (
    build_reward_shaper,
    rescale_actions,
    swap_and_flatten01,
)
from rl_games_tpu_torch.envs import registry as env_registry
from rl_games_tpu_torch.envs.device.base import VecEnvState
from rl_games_tpu_torch.envs.spaces import Box, actions_num_of, obs_shape_of
from rl_games_tpu_torch.models import model_builder
from rl_games_tpu_torch.ops import losses as L
from rl_games_tpu_torch.ops import masked as MK
from rl_games_tpu_torch.ops.gae import compute_gae
from rl_games_tpu_torch.ops.schedulers import build_scheduler
from rl_games_tpu_torch.utils.device import resolve_device

_METRIC_KEYS = ("a_loss", "c_loss", "entropy", "b_loss", "kl", "clip_frac")


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
    """PPO trainer for continuous actions over device envs.

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
        if self.device.type == "cuda":
            # full-f32 products, as in the reference
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
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
        if not self.is_continuous:
            raise NotImplementedError("discrete action spaces are not ported yet (see ROADMAP.md)")

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
        self.scheduler = build_scheduler(
            {**config, "max_epochs": self.max_epochs, "max_frames": self.max_frames},
            self.learning_rate,
        )
        if self.max_frames > 2**31 - 1:
            raise ValueError(
                f"max_frames {self.max_frames} exceeds the int32 frame counter"
            )
        self.rewards_shaper = build_reward_shaper(config)

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
        unported = {
            "an RNN torso (network.rnn)": "rnn" in network,
            "a central value net (central_value_config)": config.get("central_value_config") is not None,
            "RND curiosity (rnd_config)": bool(config.get("rnd_config")),
            "soft augmentation (features.soft_augmentation)": bool(features.get("soft_augmentation")),
            "host envs (vecenv_type)": config.get("vecenv_type") not in (None, "JAX", "DEVICE"),
            "action masks (use_action_masks)": config.get("use_action_masks", False),
            "mixed precision (mixed_precision)": config.get("mixed_precision", False),
            "minibatch permutation (permute_batches)": config.get("permute_batches", False),
            "RMS advantage normalization (normalize_rms_advantage)": config.get("normalize_rms_advantage", False),
        }
        for what, asked in unported.items():
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
        """Clip/rescale continuous actions for the env (a2c_common:1224-1234)."""
        a = torch.clamp(actions, -1.0, 1.0) if self.clip_actions else actions
        if self._rescale:
            return rescale_actions(self._action_low, self._action_high, a)
        return a

    @torch.no_grad()
    def _rollout(self, state: PPOTrainState):
        """horizon_length policy + env steps (play_steps, a2c_common.py:787-850).
        Returns the trajectory (each entry stacked to [T, N, ...]) and the
        bootstrap values of the final observations; updates ``state``."""
        model = self.model
        env_state, obs, dones = state.env_state, state.obs, state.dones
        cur_r, cur_sr = state.current_rewards, state.current_shaped_rewards
        cur_len = state.current_lengths
        traj = {k: [] for k in ("obses", "dones", "actions", "values", "neglogpacs",
                                "rewards", "mus", "sigmas")}
        for _ in range(self.horizon_length):
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

            for k, x in (("obses", obs), ("dones", dones), ("actions", res["actions"]),
                         ("values", values), ("neglogpacs", res["neglogpacs"]),
                         ("rewards", shaped), ("mus", res["mus"]), ("sigmas", res["sigmas"])):
                traj[k].append(x)
            obs, dones = next_obs, new_dones.to(torch.float32)

        # bootstrap values for the final obs (get_values, a2c_common:474-483);
        # they do not depend on the sample, so none is drawn
        last_values = model.forward_play(obs, deterministic=True)["values"]
        state.env_state, state.obs, state.dones = env_state, obs, dones
        state.current_rewards, state.current_shaped_rewards = cur_r, cur_sr
        state.current_lengths = cur_len
        return {k: torch.stack(v) for k, v in traj.items()}, last_values

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
        """Loss assembly (a2c_continuous.py:97-133). Returns the scalar loss
        and detached diagnostics."""
        res = self.model.forward_train(mb["obses"], mb["actions"])
        actor_loss_fn = L.smoothed_actor_loss if self.use_smooth_clamp else L.actor_loss
        a_loss = actor_loss_fn(
            mb["old_logp_actions"], res["prev_neglogp"], mb["advantages"], self.ppo, self.e_clip
        )
        c_loss = L.critic_loss(
            mb["old_values"], res["values"], self.e_clip, mb["returns"], self.clip_value
        )
        if self.bounds_loss_coef is not None:
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
            kl = self.model.kl(res["mus"], res["sigmas"], mb["mus"], mb["sigmas"]).mean()
            clip_frac = MK.policy_clip_fraction(
                res["prev_neglogp"], mb["old_logp_actions"], self.e_clip
            )
        aux = {
            "a_loss": a_loss_m.detach(), "c_loss": c_loss_m.detach(),
            "entropy": entropy_m.detach(), "b_loss": b_loss_m.detach(),
            "kl": kl, "clip_frac": clip_frac,
            "mus": res["mus"].detach(), "sigmas": res["sigmas"].detach(),
        }
        return total, aux

    def _update(self, state: PPOTrainState, dataset) -> Dict[str, torch.Tensor]:
        """Minibatch epochs over ordered contiguous slices (train_epoch,
        a2c_common.py:1269-1302; datasets.py)."""
        legacy = self.schedule_type == "legacy"
        lr, ec = state.lr, state.entropy_coef
        max_norm = self.grad_norm if self.truncate_grads else None
        metrics = {k: torch.zeros((), dtype=torch.float32, device=self.device) for k in _METRIC_KEYS}
        for _ in range(self.mini_epochs_num):
            ms = {k: [] for k in _METRIC_KEYS}
            for i in range(self.num_minibatches):
                sl = slice(i * self.minibatch_size, (i + 1) * self.minibatch_size)
                mb = {k: v[sl] for k, v in dataset.items()}
                total, aux = self._loss_and_kl(mb, ec)
                grads = torch.autograd.grad(total, self.params)
                adam_step(self.params, grads, state.opt_state, lr, max_norm, self.weight_decay)
                if legacy:
                    # mu/sigma writeback (datasets.py:33-43), in place in
                    # the dataset rather than into a copy of it
                    dataset["mus"][sl] = aux["mus"]
                    dataset["sigmas"][sl] = aux["sigmas"]
                    lr, ec = self.scheduler.update(lr, ec, state.epoch, state.frame, aux["kl"])
                for k in _METRIC_KEYS:
                    ms[k].append(aux[k])
            ms = {k: torch.stack(v) for k, v in ms.items()}
            if not legacy:
                lr, ec = self.scheduler.update(lr, ec, state.epoch, state.frame, ms["kl"].mean())
            metrics = {k: metrics[k] + ms[k].mean() / self.mini_epochs_num for k in _METRIC_KEYS}
        state.lr, state.entropy_coef = lr, ec
        return metrics

    def _finish_epoch(self, state: PPOTrainState, traj, last_values):
        """prepare_dataset → minibatch updates → counters and metrics."""
        dataset = self._prepare_dataset(state, traj, last_values)
        metrics = self._update(state, dataset)
        # PpoDiagnostics explained variance (diagnostics.py:18-60)
        metrics["explained_variance"] = MK.explained_variance(
            dataset["old_values"].reshape(-1), dataset["returns"].reshape(-1)
        )
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
