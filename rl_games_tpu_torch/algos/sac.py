"""SAC over device-resident envs, in PyTorch.

Port of the device-env path of rl_games_tpu/algos/sac.py (the reference's
sac_agent.py). One epoch (``train_epoch``) is ``num_steps_per_episode``
times

    env step = actor sample (uniform U(-1, 1) actions during warmup)
               + rescale + vec-env step + replay write + normalizer update
    updates  = num_updates_per_step × ``_update`` once the epoch is past
               warmup and the ring holds ``_update_min_fill`` rows

with the JAX package's semantics: the twin-critic TD target
min(Q1', Q2') − α·log π with the value bootstrap at truncation (a
truncated row stores done = False and the true final observation), the
delayed actor and learnable-α step every ``policy_frequency`` critic
updates against the just-updated critic with α floored at ``min_alpha``,
the env-space log-prob (log π − Σ log action_scale), the Polyak update
after every critic update, and the observation normalizer fed once per
fresh frame, never from the replay.

The JAX package compiles the epoch into one program and decides on the
device whether to update and whether the actor runs. Here the epoch runs
eagerly and decides both on the host, from counters that are Python ints:
the replay's cursor and fill (deterministic, since the device path writes
every row) and the update counter, so an epoch reads no device value. The
weights and the normalizer live in ``agent.actor``, ``agent.critic``,
``agent.critic_target`` and ``agent.running_mean_std``; the rest of the
train state in a ``SACTrainState`` that ``train_epoch`` updates in place.
Over a host env (GYMNASIUM, CPUENV, DMCONTROL) the epoch is
``host_train_epoch`` (sac.py:660-843), pipelined as the JAX package's: an
env step's transition waits until the next step, which first writes it
into the replay and runs the updates, then acts on the new observations
with the updated actor, so exactly one transition is pending between
steps and across epochs. The rows keep the true final observation, a
truncation stores done = False, and under next-step autoreset the reset
row after each done is not written. Everything stays on the agent's
device, as in the JAX package: each step reads the actions back once and
sends the step's results up in one copy.

Every random number comes from the state's generator: the acting draws
through ``_normal`` and ``_uniform_actions``, each update's sample indices
and normals in ``_update``, which also takes them as tensors, so a test
can hand it the JAX package's draws.
"""

import copy
import dataclasses
import math
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from rl_games_tpu_torch.algos.ppo import (
    CHECKPOINT_EXT,
    AdamState,
    Meters,
    adam_from_named,
    adam_init,
    adam_step,
    meters_init,
    meters_mean,
    meters_update,
)
from rl_games_tpu_torch.common.obs_utils import HostUpload, to_device_obs
from rl_games_tpu_torch.common.tr_helpers import build_reward_shaper
from rl_games_tpu_torch.envs import registry as env_registry
from rl_games_tpu_torch.envs.device.base import VecEnvState
from rl_games_tpu_torch.envs.spaces import Box, obs_shape_of
from rl_games_tpu_torch.models.layers import reset_parameters
from rl_games_tpu_torch.models.sac import ActionRescale, SACActor, build_sac_networks, load_normalizer
from rl_games_tpu_torch.ops.running_stats import RunningMeanStd
from rl_games_tpu_torch.parallel.mesh import (
    _SAC_DATA_FIELDS,
    LOCAL,
    RowGenerator,
    all_reduce_mean_,
    draw_rows,
    gather_rows,
    shard_rows,
    unshard_rows,
)
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils import jax_checkpoint, jax_params
from rl_games_tpu_torch.utils.device import resolve_device, use_full_float32
from rl_games_tpu_torch.utils.unported import unported
from rl_games_tpu_torch.utils.writer import create_writer


# ---------------------------------------------------------------------------
# Ring replay buffer (sac.py:53-127; the reference's VectorizedReplayBuffer,
# experience.py:207-323). The rows lie on the device; the cursor and the
# fill flag are Python ints, so the gate on the fill needs no device read.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplayBuffer:
    obses: torch.Tensor  # [cap, *obs_shape]
    next_obses: torch.Tensor
    actions: torch.Tensor  # [cap, A]
    rewards: torch.Tensor  # [cap, 1]
    dones: torch.Tensor  # [cap, 1] bool, hard terminations only
    truncated: torch.Tensor  # [cap, 1] bool
    idx: int  # write cursor
    full: bool

    @property
    def capacity(self) -> int:
        return self.obses.shape[0]


def replay_init(capacity: int, obs_shape, action_dim: int, device) -> ReplayBuffer:
    f32 = dict(dtype=torch.float32, device=device)
    flag = dict(dtype=torch.bool, device=device)
    return ReplayBuffer(
        obses=torch.zeros((capacity, *obs_shape), **f32),
        next_obses=torch.zeros((capacity, *obs_shape), **f32),
        actions=torch.zeros((capacity, action_dim), **f32),
        rewards=torch.zeros((capacity, 1), **f32),
        dones=torch.zeros((capacity, 1), **flag),
        truncated=torch.zeros((capacity, 1), **flag),
        idx=0,
        full=False,
    )


def replay_add(buf: ReplayBuffer, obs, action, reward, next_obs, done, truncated, valid=None):
    """Write a batch of rows at the cursor with wraparound, in place
    (experience.py:237-262). Rows where ``valid`` is False neither take a
    slot nor advance the cursor (the next_step autoreset's garbage rows,
    sac_agent.py:601-662); the mask is read on the host, which is where a
    host env's mask comes from (numpy or a tensor)."""
    n, cap = obs.shape[0], buf.capacity
    if valid is None:
        n_written, keep = n, None
    else:
        keep = torch.nonzero(torch.as_tensor(valid, dtype=torch.bool).cpu()).squeeze(1).to(obs.device)
        n_written = keep.numel()
    pos = torch.remainder(torch.arange(buf.idx, buf.idx + n_written, device=obs.device), cap)
    for field, rows in (("obses", obs), ("next_obses", next_obs), ("actions", action),
                        ("rewards", reward.reshape(n, 1)), ("dones", done.reshape(n, 1)),
                        ("truncated", truncated.reshape(n, 1))):
        getattr(buf, field)[pos] = rows if keep is None else rows[keep]
    buf.full = buf.full or buf.idx + n_written >= cap
    buf.idx = (buf.idx + n_written) % cap


def replay_size(buf: ReplayBuffer) -> int:
    return buf.capacity if buf.full else buf.idx


def replay_indices(buf: ReplayBuffer, generator: torch.Generator, batch_size: int):
    """``batch_size`` uniform indices in [0, max(size, 1)) from ``generator``."""
    return torch.randint(0, max(replay_size(buf), 1), (batch_size,), generator=generator, device=buf.obses.device)


def replay_sample(buf: ReplayBuffer, generator: torch.Generator, batch_size: int, idx=None):
    """Uniform sample with replacement (experience.py:264-296): rows at
    ``idx``, or at ``replay_indices`` drawn from ``generator``. Returns
    (obs, action, reward, next_obs, done, truncated)."""
    if idx is None:
        idx = replay_indices(buf, generator, batch_size)
    return (buf.obses[idx], buf.actions[idx], buf.rewards[idx], buf.next_obses[idx],
            buf.dones[idx], buf.truncated[idx])


_CRITIC_KEYS = ("critic_loss", "critic1_loss", "critic2_loss")
_ACTOR_KEYS = ("actor_loss", "entropy", "alpha_loss")


# ---------------------------------------------------------------------------
# Train state (sac.py:145-165)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SACTrainState:
    log_alpha: torch.Tensor  # () f32
    actor_opt: AdamState
    critic_opt: AdamState
    alpha_opt: AdamState
    replay: ReplayBuffer
    env_state: Optional[VecEnvState]  # None for a host env
    obs: torch.Tensor
    generator: torch.Generator  # actions, warmup actions, replay indices, update noise
    epoch: int
    frame: int
    update_counter: int
    current_rewards: torch.Tensor  # [N, 1]
    current_lengths: torch.Tensor  # [N]
    game_rewards: Meters
    game_lengths: Meters


class SACAgent:
    """SAC trainer over device envs (sac.py:168; sac_agent.py:SACAgent).

    ``params`` is the reference YAML ``params:`` dict. ``device`` defaults
    to CUDA; without CUDA that raises, and the CPU is taken only when asked
    for. ``vec_env`` replaces the env the config names (a test's fake host
    env).
    """

    def __init__(self, base_name: str, params: dict, device=None, vec_env=None):
        self.base_name = base_name
        self.full_params = params
        config = params["config"]
        self.config = config
        self.device = resolve_device(device)
        use_full_float32(self.device)

        self.num_actors = config["num_actors"]
        if vec_env is None:
            vec_env = env_registry.create_vec_env_from_config(config, self.num_actors, self.device)
        self.vec_env = vec_env
        self.is_host_env = bool(getattr(vec_env, "is_host_env", False))
        # the host path's pipeline: the transition waiting for the next
        # step (never part of a checkpoint), the last step's dones (for
        # next-step autoreset), the last epoch's losses, the per-step upload
        self._pending = None
        self._host_prev_dones = np.zeros(self.num_actors, bool)
        self._last_host_metrics = None
        self._upload = HostUpload(self.device)
        self.mesh = LOCAL  # the data-parallel world, once make_train_fn(mesh=) is given one
        info = self.vec_env.get_env_info()
        self.env_info = info
        space = info.action_space
        if not isinstance(space, Box):
            raise ValueError(f"SAC requires a continuous action space, the env has {space}")
        if info.agents != 1:
            # the JAX package's SAC takes one row an env too: it reshapes a
            # multi-agent env's N * A rewards to [num_actors] and fails
            raise ValueError(f"SAC takes one agent an env; this env has {info.agents}")
        self.action_dim = space.shape[0]
        self.obs_shape = obs_shape_of(info.observation_space)
        if isinstance(self.obs_shape, dict) or len(self.obs_shape) != 1:
            unported(f"SAC over observations of shape {self.obs_shape}", "A8")

        # --- config (sac.py:194-264; sac_agent.py:20-120) --------------------
        self.gamma = config.get("gamma", 0.99)
        self.critic_tau = float(config.get("critic_tau", 0.005))
        self.num_steps_per_episode = config.get("num_steps_per_episode", 1)
        utd_ratio = config.get("utd_ratio", None)
        if utd_ratio is not None:
            self.num_updates_per_step = max(1, round(utd_ratio * self.num_actors))
        else:
            self.num_updates_per_step = config.get("num_updates_per_step", 1)
        self.num_frames_per_epoch = self.num_actors * self.num_steps_per_episode
        num_warmup_frames = config.get("num_warmup_frames", None)
        if num_warmup_frames is not None:
            self.num_warmup_steps = int(np.ceil(num_warmup_frames / self.num_frames_per_epoch))
        else:
            self.num_warmup_steps = config.get("num_warmup_steps", 1000)
        self.batch_size = config["batch_size"]
        self.init_alpha = float(config["init_alpha"])
        self.learnable_temperature = config["learnable_temperature"]
        self.replay_buffer_size = config["replay_buffer_size"]
        # updates wait for one batch of real rows; after a resume from a
        # checkpoint without the replay, for replay_resume_min_fill rows
        # (default 5 % of the ring): updating against a few hundred fresh,
        # correlated rows corrupts the critic (sac.py:215-233)
        self.replay_min_fill = min(self.batch_size, self.replay_buffer_size)
        self.replay_resume_min_fill = int(config.get(
            "replay_resume_min_fill", max(self.replay_min_fill, self.replay_buffer_size // 20)
        ))
        self._update_min_fill = self.replay_min_fill
        self.save_replay_buffer = config.get("replay_buffer_checkpoint", False)
        self.normalize_input = config.get("normalize_input", False)
        self.policy_frequency = config.get("policy_frequency", 2)
        self.critic_grad_clip = config.get("critic_grad_clip", 5.0)
        self.value_bootstrap = config.get("value_bootstrap", True)
        self.target_entropy = config.get("target_entropy_coef", 1.0) * (-self.action_dim)
        self.min_alpha = 0.01
        self.actor_lr = float(config["actor_lr"])
        self.critic_lr = float(config["critic_lr"])
        self.alpha_lr = float(config["alpha_lr"])
        self.max_epochs = config.get("max_epochs", -1)
        self.max_frames = max(config.get("max_frames", -1), config.get("max_steps", -1))
        if self.max_frames > 2**31 - 1:
            raise ValueError(
                f"max_frames {self.max_frames} exceeds 2^31-1, the limit of the JAX package's "
                "int32 frame counter, which the port keeps; split the run into resumed segments"
            )
        self.games_to_track = config.get("games_to_track", 100)
        self.save_freq = config.get("save_frequency", 0)
        self.save_best_after = config.get("save_best_after", 100)
        self.score_to_win = config.get("score_to_win", None)
        self.seed = config.get("seed", 7)
        self.rewards_shaper = build_reward_shaper(config)

        self._rescale = ActionRescale(space, self.action_dim, self.device)
        self.log_action_scale_sum = self._rescale.log_scale_sum

        # --- networks and normalizer ------------------------------------------
        obs_dim = self.obs_shape[0]
        self.actor, self.critic = build_sac_networks(params["network"], obs_dim, self.action_dim,
                                                     device=self.device)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)
        self.running_mean_std = RunningMeanStd(self.obs_shape, device=self.device) if self.normalize_input else None
        self.actor_params = list(self.actor.parameters())
        self.critic_params = list(self.critic.parameters())
        self._critic_max_norm = self.critic_grad_clip if self.critic_grad_clip > 0 else None

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> SACTrainState:
        """Draw fresh weights (the target a copy of the critic), reset the
        normalizer and the envs, and return the rest of the train state."""
        seed = self.seed if seed is None else seed
        model_seed, env_seed, act_seed = (
            int(s) for s in np.random.SeedSequence(seed).generate_state(3)
        )

        def generator(s):
            return torch.Generator(device=self.device).manual_seed(s)

        weights = generator(model_seed)
        reset_parameters(self.actor, weights)
        reset_parameters(self.critic, weights)
        self.critic_target.load_state_dict(self.critic.state_dict())
        if self.running_mean_std is not None:
            self.running_mean_std.reset()
        if self.is_host_env:
            env_state, obs = None, to_device_obs(self.vec_env.reset(), self.device)
        else:
            env_state, obs = self.vec_env.reset(generator(env_seed))
        f32 = dict(dtype=torch.float32, device=self.device)
        log_alpha = torch.tensor(math.log(self.init_alpha), **f32)
        return SACTrainState(
            log_alpha=log_alpha,
            actor_opt=adam_init(self.actor_params),
            critic_opt=adam_init(self.critic_params),
            alpha_opt=adam_init([log_alpha]),
            replay=replay_init(self.replay_buffer_size, self.obs_shape, self.action_dim, self.device),
            env_state=env_state,
            obs=obs,
            generator=generator(act_seed),
            epoch=0,
            frame=0,
            update_counter=0,
            current_rewards=torch.zeros((self.num_actors, 1), **f32),
            current_lengths=torch.zeros(self.num_actors, **f32),
            game_rewards=meters_init(self.games_to_track, 1, self.device),
            game_lengths=meters_init(self.games_to_track, 1, self.device),
        )

    # ------------------------------------------------------------------
    def _preproc_obs(self, obs):
        if self.running_mean_std is None:
            return obs
        return self.running_mean_std.normalize(obs)

    def _env_log_prob(self, logp_norm):
        """sac_agent.py:381-389."""
        return logp_norm - self.log_action_scale_sum

    def _normal(self, state: SACTrainState, shape):
        """Standard normals for an actor sample (a data-parallel rank's
        acting: its rows of the world's draw)."""
        return draw_rows(torch.randn, shape, state.generator, device=self.device)

    def _uniform_actions(self, state: SACTrainState):
        """Warmup actions, U(-1, 1), one row an env of ``state.obs`` (a
        data-parallel rank's of the world's draw)."""
        u = draw_rows(torch.rand, (state.obs.shape[0], self.action_dim), state.generator, device=self.device)
        return u * 2.0 - 1.0

    def _reduce(self, grads, scalars: dict):
        """A data-parallel rank's gradients and losses averaged over the
        world in one all-reduce; as they are in a single process."""
        keys = list(scalars)
        vals = torch.stack([scalars[k] for k in keys])
        all_reduce_mean_([*grads, vals], self.mesh)
        return grads, dict(zip(keys, vals.unbind()))

    # -- updates (sac.py:352-483) --------------------------------------------
    def _update_critic(self, state: SACTrainState, obs, action, reward, next_obs, not_done, noise):
        with torch.no_grad():
            obs_n = self._preproc_obs(obs)
            next_obs_n = self._preproc_obs(next_obs)
            mu, std = self.actor(next_obs_n)
            next_action, pre = SACActor.sample(mu, std, noise)
            log_prob = self._env_log_prob(SACActor.log_prob(next_action, mu, std, pre))[:, None]
            tq1, tq2 = self.critic_target(next_obs_n, self._rescale(next_action))
            target_v = torch.minimum(tq1, tq2) - torch.exp(state.log_alpha) * log_prob
            target_q = reward + not_done * self.gamma * target_v
        q1, q2 = self.critic(obs_n, action)
        c1 = torch.square(q1 - target_q).mean()
        c2 = torch.square(q2 - target_q).mean()
        c_loss = 0.5 * (c1 + c2)
        grads = torch.autograd.grad(c_loss, self.critic_params)
        grads, metrics = self._reduce(grads, {"critic_loss": c_loss.detach(), "critic1_loss": c1.detach(),
                                              "critic2_loss": c2.detach()})
        adam_step(self.critic_params, grads, state.critic_opt, self.critic_lr, self._critic_max_norm)
        return metrics

    def _update_actor_and_alpha(self, state: SACTrainState, obs, noise):
        """The actor step against the current critic, then the α step from
        the actor's pre-step log-probs. Gradients reach the actor's weights
        and log α only."""
        with torch.no_grad():
            obs_n = self._preproc_obs(obs)
            alpha = torch.clamp(torch.exp(state.log_alpha), min=self.min_alpha)
        mu, std = self.actor(obs_n)
        action, pre = SACActor.sample(mu, std, noise)
        log_prob = self._env_log_prob(SACActor.log_prob(action, mu, std, pre))[:, None]
        q1, q2 = self.critic(obs_n, self._rescale(action))
        a_loss = (alpha * log_prob - torch.minimum(q1, q2)).mean()
        grads = list(torch.autograd.grad(a_loss, self.actor_params))
        log_prob = log_prob.detach()
        metrics = {"actor_loss": a_loss.detach(), "entropy": -log_prob.mean()}
        if self.learnable_temperature:
            # α's gradient does not depend on the actor's step: it travels
            # in the actor's all-reduce
            target_term = -log_prob - self.target_entropy
            log_alpha = state.log_alpha.detach().requires_grad_(True)
            alpha_loss = (torch.exp(log_alpha) * target_term).mean()
            grads += torch.autograd.grad(alpha_loss, [log_alpha])
            metrics["alpha_loss"] = alpha_loss.detach()
        grads, metrics = self._reduce(grads, metrics)
        adam_step(self.actor_params, grads[:len(self.actor_params)], state.actor_opt, self.actor_lr)
        if self.learnable_temperature:
            adam_step([state.log_alpha], grads[len(self.actor_params):], state.alpha_opt, self.alpha_lr)
        else:
            metrics["alpha_loss"] = torch.zeros((), dtype=torch.float32, device=self.device)
        return metrics

    @torch.no_grad()
    def _soft_update(self):
        """Polyak lerp of the target toward the critic (sac_agent.py:463-474)."""
        torch._foreach_lerp_(list(self.critic_target.parameters()), self.critic_params, self.critic_tau)

    def _update(self, state: SACTrainState, idx=None, critic_noise=None, actor_noise=None):
        """One gradient update (sac.py:447-483): the critic step, the
        counter, every ``policy_frequency``-th update the actor and α steps
        against the just-updated critic, then the Polyak update. Returns
        the losses (tensors) and ``actor_updated`` (a bool). Unless given,
        the sample indices and the normals are drawn at the batch's shape
        from the state's generator; a data-parallel rank computes its block
        of the batch."""
        if idx is None:
            lo, hi = self.mesh.block(self.batch_size, "batch_size")
            shape, gen = (self.batch_size, self.action_dim), state.generator
            idx = replay_indices(state.replay, gen, self.batch_size)[lo:hi]
            critic_noise = torch.randn(shape, generator=gen, device=self.device)[lo:hi]
            if (state.update_counter + 1) % self.policy_frequency == 0:
                actor_noise = torch.randn(shape, generator=gen, device=self.device)[lo:hi]
        obs, action, reward, next_obs, done, _ = replay_sample(state.replay, None, self.batch_size, idx)
        not_done = 1.0 - done.to(torch.float32)
        metrics = self._update_critic(state, obs, action, reward, next_obs, not_done, critic_noise)
        state.update_counter += 1
        metrics["actor_updated"] = state.update_counter % self.policy_frequency == 0
        if metrics["actor_updated"]:
            metrics.update(self._update_actor_and_alpha(state, obs, actor_noise))
        self._soft_update()
        return metrics

    # -- epoch (sac.py:486-609) ---------------------------------------------
    @torch.no_grad()
    def _act(self, state: SACTrainState, warmup: bool):
        """The env's actions for ``state.obs``: U(-1, 1) during warmup, else
        an actor sample; rescaled to the env's bounds."""
        if warmup:
            return self._rescale(self._uniform_actions(state))
        mu, std = self.actor(self._preproc_obs(state.obs))
        return self._rescale(SACActor.sample(mu, std, self._normal(state, mu.shape))[0])

    @torch.no_grad()
    def _record(self, state: SACTrainState, obs, env_actions, rewards, dones, time_outs, final_obs, next_obs,
                valid=None):
        """One env step's transition: the replay rows, the normalizer, the
        episode meters and the frame counter. The replay row's next obs is
        the TRUE final obs, and a truncation stores done = False so that the
        TD target bootstraps."""
        hard_done = dones & ~time_outs if self.value_bootstrap else dones
        replay_add(state.replay, obs, env_actions, self.rewards_shaper(rewards), final_obs, hard_done,
                   time_outs, valid=valid)
        if self.running_mean_std is not None:  # each fresh frame once (:714-716)
            self.running_mean_std.update_from_batch(next_obs)
        cur_r = state.current_rewards + rewards[:, None]
        cur_len = state.current_lengths + 1.0
        meters_update(state.game_rewards, cur_r, dones)
        meters_update(state.game_lengths, cur_len[:, None], dones)
        not_done = 1.0 - dones.to(torch.float32)
        state.frame += self.num_actors
        state.current_rewards = cur_r * not_done[:, None]
        state.current_lengths = cur_len * not_done

    @torch.no_grad()
    def _env_step(self, state: SACTrainState, warmup: bool):
        """One device env step: act, step, record the transition. A
        data-parallel rank steps its block of the envs and records the
        world's transition, gathered, so every rank's replay ring, meters
        and normalizer are the single process's."""
        env_actions = self._act(state, warmup)
        env_state, next_obs, rewards, dones, infos = self.vec_env.step(state.env_state, env_actions)
        step = (state.obs, env_actions, rewards.reshape(-1).to(torch.float32), dones.to(torch.bool),
                infos["time_outs"], infos["final_observation"], next_obs)
        self._record(state, *(gather_rows(x, self.mesh) for x in step))
        state.env_state, state.obs = env_state, next_obs

    def _updates_due(self, state: SACTrainState, warmup: bool) -> list:
        """The UTD updates of one env step, once warmup is over and the ring
        holds ``_update_min_fill`` rows."""
        if warmup or replay_size(state.replay) < self._update_min_fill:
            return []
        return [self._update(state) for _ in range(self.num_updates_per_step)]

    def train_epoch(self, state: SACTrainState):
        """play_steps (sac_agent.py:664-745): env steps with the UTD updates
        inline. Returns (state, metrics): the critic's losses are means over
        every update of the epoch, the actor's, the entropy and α's over the
        updates where the actor ran (zeros where none did). A data-parallel
        rank's state is first cut to its block of the envs."""
        if self.mesh.size > 1 and not isinstance(state.generator, RowGenerator):
            state = self._shard_state(state)
        warmup = state.epoch < self.num_warmup_steps
        per_update = []
        for _ in range(self.num_steps_per_episode):
            self._env_step(state, warmup)
            per_update += self._updates_due(state, warmup)
        state.epoch += 1
        return state, self._epoch_metrics(state, self._loss_means(per_update))

    def host_train_epoch(self, state: SACTrainState):
        """The host-env epoch (sac.py:761-843): per env step, write the
        pending transition and run the updates, act on the current
        observations (the one read of the step), step the env and keep its
        transition pending. Returns (state, metrics) as ``train_epoch``;
        an epoch without updates repeats the last epoch's losses."""
        warmup = state.epoch < self.num_warmup_steps
        next_step = getattr(self.vec_env, "autoreset_mode", "same_step") == "next_step"
        per_update = []
        for _ in range(self.num_steps_per_episode):
            if self._pending is not None:
                self._record(state, *self._pending)
                per_update += self._updates_due(state, warmup)
            env_actions = self._act(state, warmup)
            next_obs, rewards, dones, infos = self.vec_env.step(env_actions.cpu().numpy())
            dones = np.asarray(dones, bool)
            time_outs = np.asarray(infos.get("time_outs", np.zeros_like(dones)), bool)
            final_obs = infos.get("final_observation", next_obs)
            # next-step autoreset: the row after a done is the reset row,
            # which the replay skips (sac_agent.py:601-662)
            valid = None
            if next_step:
                valid, self._host_prev_dones = ~self._host_prev_dones, dones
            next_obs, final_obs, flags = self._upload(
                next_obs, final_obs, np.stack([np.asarray(rewards, np.float32).reshape(-1), dones, time_outs]))
            self._pending = (state.obs, env_actions, flags[0], flags[1] > 0.5, flags[2] > 0.5, final_obs, next_obs,
                             valid)
            state.obs = next_obs
        state.epoch += 1
        if per_update or self._last_host_metrics is None:
            self._last_host_metrics = self._loss_means(per_update)
        return state, self._epoch_metrics(state, self._last_host_metrics)

    def make_train_fn(self, mesh=None):
        """The epoch function for this agent's env (sac.py:611-654). With a
        ``mesh`` the agent becomes one rank of a data-parallel world (beyond
        the reference, whose SAC is single-GPU): each rank steps its block
        of the envs, every rank holds the whole replay ring (the JAX package
        shards its capacity), and each update's batch is split evenly with
        the gradients all-reduced. A host env ignores the mesh, with a
        UserWarning, as the JAX package does."""
        if self.is_host_env:
            if mesh is not None:
                warnings.warn(
                    "make_train_fn(mesh=...) with a host-stepped env: the mesh is ignored; host envs run the "
                    "single-process path. Run one env pool per process instead.",
                    UserWarning, stacklevel=2)
            return self.host_train_epoch
        if mesh is not None:
            mesh.block(self.num_actors, "num_actors")
            mesh.block(self.batch_size, "batch_size")
            self.mesh = mesh
        return self.train_epoch

    def _world_state(self, state: SACTrainState) -> SACTrainState:
        """The single process's train state from a data-parallel rank's: its
        env state and observations gathered from every rank (a collective),
        so that a checkpoint holds the world's rows."""
        if not isinstance(state.generator, RowGenerator):
            return state
        return dataclasses.replace(state, **{f: unshard_rows(getattr(state, f), self.mesh) for f in _SAC_DATA_FIELDS})

    def _shard_state(self, state: SACTrainState) -> SACTrainState:
        """The rank's rows of a single-process train state (the counterpart of
        sac_state_shardings): the vec env and its state cut to the rank's
        block of envs, its observations, and the generator drawing the
        world's rows; the replay, the accumulators and the rest replicated."""
        lo, hi = self.mesh.block(self.num_actors, "num_actors")
        state.env_state = self.vec_env.take_rows(state.env_state, lo, hi)
        for f in _SAC_DATA_FIELDS[1:] + ("generator",):
            setattr(state, f, shard_rows(getattr(state, f), lo, hi, self.num_actors))
        return state

    def _loss_means(self, per_update: list) -> Dict[str, object]:
        """The critic's losses averaged over ``per_update``, the actor's,
        the entropy and α's over the updates where the actor ran (zeros
        where none did)."""
        actor_runs = [m for m in per_update if m["actor_updated"]]
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        out: Dict[str, object] = {}
        for keys, runs in ((_CRITIC_KEYS, per_update), (_ACTOR_KEYS, actor_runs)):
            for k in keys:
                out[k] = torch.stack([m[k] for m in runs]).mean() if runs else zero
        out["actor_updated"] = len(actor_runs)
        return out

    def _epoch_metrics(self, state: SACTrainState, losses: Dict[str, object]) -> Dict[str, object]:
        out = dict(losses)
        out["alpha"] = torch.exp(state.log_alpha)
        out["mean_rewards"] = meters_mean(state.game_rewards)
        out["mean_lengths"] = meters_mean(state.game_lengths)[0]
        out["games_played"] = state.game_rewards.count.clone()
        out["frame"] = state.frame
        out["epoch"] = state.epoch
        out["replay_size"] = replay_size(state.replay)
        return out

    # ------------------------------------------------------------------
    # weights, state I/O and parameters (sac.py:845-941)
    # ------------------------------------------------------------------
    def get_weights(self, state: SACTrainState) -> dict:
        """The reference SAC checkpoint's sections: the actor's, the
        critic's and the target's state_dicts, log α and, with an input
        normalizer, its state."""
        sections = {
            "actor": self.actor.state_dict(),
            "critic": self.critic.state_dict(),
            "critic_target": self.critic_target.state_dict(),
            "log_alpha": state.log_alpha,
        }
        if self.running_mean_std is not None:
            sections["running_mean_std"] = self.running_mean_std.state_dict()
        return {k: ckpt.tree_to_plain(v) for k, v in sections.items()}

    def set_weights(self, state: SACTrainState, weights: dict) -> SACTrainState:
        """Load the sections ``weights`` has (``get_weights``' layout, or a
        reference SAC checkpoint's); the target and log α stay as they are
        where it has none. Returns the state."""
        self.actor.load_state_dict(weights["actor"])
        self.critic.load_state_dict(weights["critic"])
        if weights.get("critic_target") is not None:
            self.critic_target.load_state_dict(weights["critic_target"])
        if weights.get("running_mean_std") is not None:
            load_normalizer(self.running_mean_std, weights["running_mean_std"])
        if weights.get("log_alpha") is not None:
            state.log_alpha.copy_(torch.as_tensor(weights["log_alpha"]).reshape(()))
        return state

    def _ckpt_state(self, state: SACTrainState) -> SACTrainState:
        """The state as checkpointed: the replay stripped to a 1-slot stub
        unless ``replay_buffer_checkpoint`` is on."""
        if self.save_replay_buffer:
            return state
        return dataclasses.replace(state, replay=replay_init(1, self.obs_shape, self.action_dim, self.device))

    def get_full_state_weights(self, state: SACTrainState, last_mean_rewards: float = -100500.0) -> dict:
        return {
            "state": ckpt.tree_to_plain(self._ckpt_state(state)),
            "weights": self.get_weights(state),
            "epoch": state.epoch,
            "frame": state.frame,
            "last_mean_rewards": last_mean_rewards,
        }

    def set_full_state_weights(self, state: SACTrainState, full: dict, set_epoch: bool = True) -> SACTrainState:
        """Restore into ``state``'s structure; a stripped replay keeps
        ``state``'s ring; ``set_epoch=False`` keeps the current counters."""
        plain = full["state"]
        stripped = tuple(plain["replay"]["obses"].shape) != tuple(state.replay.obses.shape)
        example = self._ckpt_state(state) if stripped else state
        new = ckpt.tree_from_plain(example, plain)
        if stripped:
            new.replay = state.replay
        if not set_epoch:
            new.epoch, new.frame = state.epoch, state.frame
        return self.set_weights(new, full["weights"])

    def get_param(self, param_name: str, state=None):
        if param_name in ("gamma", "critic_tau"):
            return getattr(self, param_name)
        if param_name == "tau":
            return self.critic_tau
        raise NotImplementedError(f"Can't get param {param_name}")

    def set_param(self, param_name: str, value, state=None):
        """gamma and critic_tau (sac.py:880-900). The epoch runs eagerly and
        reads both at each update, so a change takes effect at the next
        one; over a host env the pending transition (``_pending``) stays,
        so every env step lands in replay exactly once."""
        if param_name == "tau":
            param_name = "critic_tau"
        if param_name in ("gamma", "critic_tau"):
            setattr(self, param_name, float(value))
            return state
        raise NotImplementedError(f"No param found for {param_name}")

    def reset_optimizer(self, state: SACTrainState) -> SACTrainState:
        state.actor_opt = adam_init(self.actor_params)
        state.critic_opt = adam_init(self.critic_params)
        state.alpha_opt = adam_init([state.log_alpha])
        return state

    def _save(self, path: str, state: SACTrainState, meta: dict):
        ckpt.save_checkpoint(path, self._ckpt_state(state), meta, sections=self.get_weights(state))

    def _restore(self, checkpoint: str, state: SACTrainState, payload: Optional[dict] = None):
        """Resume from one of the port's SAC checkpoints; returns (state,
        meta). Without its replay (``has_replay: false``) the ring starts
        empty and the update gate rises to ``replay_resume_min_fill``, so
        that updates wait until the restored actor has refilled it."""
        if payload is None:
            payload = ckpt.read_payload(checkpoint)
        if payload.get("meta", {}).get("has_replay", True):
            state, meta = ckpt.load_checkpoint(checkpoint, state, payload=payload)
        else:
            self._update_min_fill = min(self.replay_resume_min_fill, self.replay_buffer_size)
            fresh = state.replay
            state, meta = ckpt.load_checkpoint(checkpoint, self._ckpt_state(state), payload=payload)
            state.replay = fresh
        return self.set_weights(state, payload), meta

    def restore_jax_checkpoint(self, checkpoint: str, state: SACTrainState):
        """Resume from a JAX package's SAC ``.ckpt`` (utils/jax_checkpoint.py,
        utils/jax_params.sac_jax_state): actor, critic, target, log α, the
        three Adam states, the input normalizer, epoch, frame and update
        counter, and the replay ring where the file holds it
        (``meta['has_replay']``) at the config's capacity (else it raises,
        naming both). Without it the ring starts empty and the update gate
        rises to ``replay_resume_min_fill`` (sac.py:921-945). The envs, the
        random stream and the meters stay ``state``'s own reset. Returns
        (state, meta)."""
        payload = jax_checkpoint.read_jax_checkpoint(checkpoint)
        meta = payload["meta"]
        carried = jax_params.sac_jax_state(payload["state"], self.full_params["network"])
        state = self.set_weights(state, carried["sections"])
        state.actor_opt = adam_from_named(carried["actor_opt"], self.actor, self.device)
        state.critic_opt = adam_from_named(carried["critic_opt"], self.critic, self.device)
        alpha = carried["alpha_opt"]
        state.alpha_opt = AdamState(count=alpha["count"].to(self.device),
                                    mu=[m.to(self.device) for m in alpha["mu"]],
                                    nu=[v.to(self.device) for v in alpha["nu"]])
        replay = carried["replay"]
        if meta.get("has_replay", True):
            if replay["obses"].shape[0] != self.replay_buffer_size:
                raise ValueError(f"{checkpoint}: its replay ring holds {replay['obses'].shape[0]} rows, the "
                                 f"config's replay_buffer_size is {self.replay_buffer_size}")
            state.replay = ReplayBuffer(**{k: v.to(self.device) if torch.is_tensor(v) else v
                                           for k, v in replay.items()})
        else:
            self._update_min_fill = min(self.replay_resume_min_fill, self.replay_buffer_size)
        state.epoch, state.frame, state.update_counter = carried["epoch"], carried["frame"], carried["update_counter"]
        return state, meta

    # ------------------------------------------------------------------
    # host train loop (sac.py:946-1124; sac_agent.py:753-852)
    # ------------------------------------------------------------------
    def train(self, checkpoint: Optional[str] = None, stop_fn=None, writer=None,
              max_epochs: Optional[int] = None, mesh=None):
        """Train until max_epochs / max_frames / score_to_win / stop_fn.
        Returns (last_mean_rewards, epoch_num); the final state stays in
        ``self.last_state``. ``checkpoint`` resumes from one of the port's
        SAC checkpoints, or warm-starts from a file of weights only (a
        reference SAC ``.pth``). With a ``mesh`` this process is one rank of
        a data-parallel world; the checkpoints, the summaries and the prints
        are rank 0's alone."""
        config = self.config
        main = mesh is None or mesh.rank == 0
        experiment_name = config.get("name", self.base_name)
        experiment_dir = os.path.join(config.get("train_dir", "runs"), experiment_name)
        nn_dir = os.path.join(experiment_dir, "nn")
        if main:
            os.makedirs(nn_dir, exist_ok=True)

        def save(path, state, meta):
            # every rank takes part in gathering the world's rows; rank 0 writes
            state = self._world_state(state)
            if main:
                self._save(path, state, meta)

        state = self.init_state()
        last_mean_rewards = -100500.0
        if checkpoint and jax_checkpoint.is_jax_checkpoint(checkpoint):
            state, meta = self.restore_jax_checkpoint(checkpoint, state)
            last_mean_rewards = meta.get("last_mean_rewards", last_mean_rewards)
        elif checkpoint:
            payload = ckpt.read_payload(checkpoint)
            if "state" in payload:
                state, meta = self._restore(checkpoint, state, payload)
                last_mean_rewards = meta.get("last_mean_rewards", last_mean_rewards)
            else:  # weights only: a warm start (sac.py:960-985)
                if "model" in payload and "actor" not in payload:
                    payload = payload["model"]
                state = self.set_weights(state, payload)
        if writer is None:
            writer = create_writer(os.path.join(experiment_dir, "summaries") if main else None)
        max_epochs = self.max_epochs if max_epochs is None else max_epochs

        # metrics reach the host only every log_interval epochs; the loop
        # runs on the host's counters. The frame count is the epochs' frames
        # (sac.py:1003), which a host epoch's state.frame trails by the
        # transition still pending
        log_interval = max(1, int(config.get("log_interval", 1)))
        epoch_num = state.epoch
        t_last_log, ep_last_log = time.perf_counter(), epoch_num
        best_path = os.path.join(nn_dir, experiment_name + CHECKPOINT_EXT)
        train_fn = self.make_train_fn(mesh)
        while True:
            state, metrics_dev = train_fn(state)
            epoch_num = state.epoch
            frame = epoch_num * self.num_frames_per_epoch
            self.last_state = state
            will_exit = ((max_epochs > 0 and epoch_num >= max_epochs)
                         or (self.max_frames > 0 and frame >= self.max_frames))
            stop_requested = stop_fn is not None and stop_fn(self)
            do_log = (epoch_num % log_interval == 0) or will_exit or stop_requested
            mean_rewards = None
            meta = {"last_mean_rewards": last_mean_rewards, "epoch": epoch_num, "frame": frame,
                    "has_replay": self.save_replay_buffer}
            if do_log:
                metrics = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                           for k, v in metrics_dev.items()}
                now = time.perf_counter()
                # divide by the epochs since the last log: an early log
                # (will_exit / stop_fn) covers fewer than log_interval
                fps = (epoch_num - ep_last_log) * self.num_frames_per_epoch / max(now - t_last_log, 1e-9)
                t_last_log, ep_last_log = now, epoch_num
                if int(metrics["games_played"]):
                    mean_rewards = float(metrics["mean_rewards"][0])
                for key in ("critic_loss", "actor_loss", "entropy", "alpha", "alpha_loss",
                            "critic1_loss", "critic2_loss"):
                    writer.add_scalar(f"losses/{key}", float(metrics[key]), frame)
                writer.add_scalar("performance/step_fps", fps, frame)
                if mean_rewards is not None:
                    writer.add_scalar("rewards/step", mean_rewards, frame)
                    writer.add_scalar("rewards/iter", mean_rewards, epoch_num)
                    writer.add_scalar("episode_lengths/step", float(metrics["mean_lengths"]), frame)
                if config.get("print_stats", True) and main:
                    print(f"fps: {fps:.0f} epoch: {epoch_num} frames: {frame}"
                          + (f" rew: {mean_rewards:.2f}" if mean_rewards is not None else ""), flush=True)

            last_path = os.path.join(nn_dir, f"last_{experiment_name}_ep_{epoch_num}{CHECKPOINT_EXT}")
            if self.save_freq > 0 and epoch_num % self.save_freq == 0:
                save(last_path, state, meta)
            if mean_rewards is not None and epoch_num >= self.save_best_after and mean_rewards > last_mean_rewards:
                last_mean_rewards = mean_rewards
                meta["last_mean_rewards"] = last_mean_rewards
                save(best_path, state, meta)
                if self.score_to_win is not None and mean_rewards > self.score_to_win:
                    print("Maximum reward achieved. Network won!")
                    break
            if max_epochs > 0 and epoch_num >= max_epochs:
                print("MAX EPOCHS NUM!")
            if self.max_frames > 0 and frame >= self.max_frames:
                print("MAX FRAMES NUM!")
            if stop_requested:
                print("Custom stop condition met!")
            if will_exit or stop_requested:
                save(last_path, state, meta)
                break

        writer.flush()
        self.last_state = state
        return last_mean_rewards, epoch_num
