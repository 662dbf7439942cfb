"""PPO over device-resident envs, in PyTorch.

Port of the single-agent rl_games_tpu/algos/ppo.py, continuous, discrete
and multi-discrete (the reference's a2c_common.py play_steps :787-939 and
train_epoch :1241-1307, a2c_continuous.py, a2c_discrete.py,
central_value.py). One epoch (``train_epoch``) is

    rollout  = horizon × (policy forward + sample + env step + autoreset)
    gae      = ops.gae.compute_gae (the CUDA kernel on the card)
    dataset  = value / advantage normalization
    updates  = mini_epochs × minibatches × (grad step + legacy adaptive LR)

with the JAX package's semantics: the value bootstrap at time-outs
(a2c_common.py:813-814), the two-step value-normalizer update
(:1325-1332), advantage normalization, the 'legacy' per-minibatch
adaptive LR with mu/sigma writeback for continuous actions
(datasets.py:33-43), episode meters and the epoch/frame counters. Discrete
actions are stored as integers ([N, heads] for MultiDiscrete) and passed to
the env as they are; their adaptive-LR KL is 0.5 · mean((old neglogp −
neglogp)²) (ppo.py:959-962). With ``use_action_masks`` each step reads the
env's masks before the policy samples, stores them in the trajectory and
the loss applies them (ppo.py:576-580, 654-655, 859-860). The actor sees
the 'obs' entry of the asymmetric envs' {'obs', 'states'} observations
(``actor_obs``); other dict observations (a custom network's, or the
resnet builder's extras) reach the model whole: the trajectory keeps a
[T, N, ...] tensor per key, in the key's own dtype, the minibatches slice
each key, the model's normalizer has one set of stats per key, and the
'aux_losses' a network reports join the loss (ppo.py:923-926). With
the two-hot value head the value loss, the actor-critic's and the central
value net's, is the negative two-hot log-prob of the symlog returns
(ppo.py:886-898, :1174-1186). A
multi-head value (``value_size`` > 1) keeps its
rewards, values, returns and value normalizer per head, and sums the
heads' advantages. The tanh policy's entropy is estimated from normals
drawn fresh for each minibatch (ppo.py:861-868). Envs that report
``infos['scores']`` feed a score meter at done rows, read as
``mean_scores`` (ppo.py:628-633, 1296-1297).

PPO's further options, as the JAX package has them:
- a recurrent torso (``network.rnn``): the rollout runs in windows of
  ``seq_length`` steps and keeps each window's first states; the dones
  entering a step zero the states before it (``zero_rnn_on_done``); the
  dataset's states lie [layers, N · W, units], sequence s = e · W + w,
  and a minibatch of whole sequences starts from its slice of them
  (ppo.py:562-726, 817-836, 993-1003);
- a central value net (``central_value_config``; ppo.py:319-370,
  1134-1202): its own model over the env's 'states', its own Adam and
  minibatches, its value normalizer and recurrent states; the actor's
  value head then carries no loss;
- RND curiosity (``rnd_config``; ppo.py:736-750, 1099-1132): the
  intrinsic reward joins the shaped reward before GAE and the predictor
  trains on the rollout's observations;
- soft augmentation (``features.soft_augmentation``; ppo.py:927-945), RMS
  advantage normalization (``normalize_rms_advantage``; :797-808),
  ``permute_batches`` (without an RNN; :982-1043) and ``mixed_precision``:
  the loss's forwards use the weights rounded to bfloat16 and compute in
  float32, as the JAX package's cast parameters do (:844-851), so the
  gradients are rounded alike.
The order of an epoch's updates is the JAX package's: the central value
net, then RND, then the policy (ppo.py:1259-1266).

The JAX package compiles the epoch into one
program over an immutable state; here it runs eagerly, the weights and
normalizer stats live in ``agent.model`` (an ``nn.Module``) and the rest of
the train state in a ``PPOTrainState`` that ``train_epoch`` updates in
place. Nothing in an epoch reads a device value on the host. The
trajectory is written into tensors allocated once per rollout (the
observations env-major, so that flattening them into the dataset is a
view, not a second copy of the largest tensor of the epoch).

Over a host env (GYMNASIUM, CPUENV, DMCONTROL: numpy vec envs stepped on
the host, the reference's Ray/envpool path) the rollout is
``host_train_epoch`` (ppo.py:1311-1490): each step runs the policy where
``host_inference_device`` puts it (common/host_inference.py), reads the
env's actions and the values back in one copy (the step's one
synchronisation), steps the env, keeps the episode accounting on the host
and sends the next observations, shaped rewards and dones up in one copy;
GAE and the updates are the device path's. The env must reset on done
(same-step autoreset).

``train`` is the host loop around it (ContinuousA2CBase.train,
a2c_common.py:1372-1492): run directories, resume from a checkpoint,
logging, the algo observer's hooks (``features.observer``), the three
kinds of checkpoint and the stop conditions; with ``pbt.enabled`` a
``utils/pbt.PbtManager`` steps after every epoch, through ``get_weights`` /
``set_weights``, ``reset_optimizer`` and ``set_param``. Metrics cross to the host only
on log epochs. With ``use_diagnostics`` an epoch also reports kl and the
clip fraction per mini-epoch and the normalizers' state (PpoDiagnostics,
diagnostics.py:18-60), and the rollout is timed once so that the step rate
is reported apart from the update.
"""

import copy
import dataclasses
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from rl_games_tpu_torch.common.host_inference import rollout_device
from rl_games_tpu_torch.common.obs_utils import (
    HostUpload,
    fill_sigma,
    sigma_override_blocked,
    to_device_obs,
    upload_obs,
)
from rl_games_tpu_torch.common.transforms import build_transform
from rl_games_tpu_torch.common.tr_helpers import (
    build_reward_shaper,
    rescale_actions,
    swap_and_flatten01,
)
from rl_games_tpu_torch.envs import registry as env_registry
from rl_games_tpu_torch.envs.device.base import VecEnvState
from rl_games_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete, actions_num_of, obs_shape_of
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models import model_builder
from rl_games_tpu_torch.models.rnd import RNDCuriosity
from rl_games_tpu_torch.ops import losses as L
from rl_games_tpu_torch.ops import masked as MK
from rl_games_tpu_torch.ops import running_stats as RS
from rl_games_tpu_torch.ops.gae import compute_gae
from rl_games_tpu_torch.ops.schedulers import build_scheduler
from rl_games_tpu_torch.parallel.mesh import (
    _PPO_DATA_FIELDS,
    _PPO_RNN_FIELDS,
    LOCAL,
    RowGenerator,
    all_reduce_mean_,
    gather_rows,
    shard_rows,
    unshard_rows,
)
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils import jax_checkpoint, jax_params
from rl_games_tpu_torch.utils.device import resolve_device, use_full_float32
from rl_games_tpu_torch.utils.pbt import PbtCfg, PbtManager
from rl_games_tpu_torch.utils.self_play import SelfPlayManager
from rl_games_tpu_torch.utils.writer import IntervalSummaryWriter, create_writer, write_ppo_stats

_METRIC_KEYS = ("a_loss", "c_loss", "entropy", "b_loss", "kl", "clip_frac")
# Checkpoints carry the reference's extension: their 'model' section has the
# reference's .pth layout, so the JAX package's importer reads them.
CHECKPOINT_EXT = ".pth"
# the sections of a checkpoint beside 'model': the central value net under
# the reference's name (a2c_common.py get_full_state_weights; its keys
# 'model.' + the model's), RND's target, predictor and normalizer
CV_SECTION, RND_SECTION = "assymetric_vf_nets", "rnd"


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
    more rows finish in one call than the ring holds, the last ``capacity``
    of them stay, as K one-row calls would leave them (the JAX package
    leaves which write wins unspecified): the earlier ones go to the spare
    row, so no slot is written twice and the result is the same on every
    device."""
    cap = m.capacity
    mask_i = mask.to(torch.int32)
    slot = torch.cumsum(mask_i, dim=0) - 1  # position among the done rows
    n = mask_i.sum(dtype=torch.int32)
    pos = torch.remainder(m.ptr + slot, cap)
    pos = torch.where(mask & (slot >= n - cap), pos, torch.full_like(pos, cap)).to(torch.int64)
    m.buf.index_put_((pos,), values.to(torch.float32))
    m.ptr.copy_(torch.remainder(m.ptr + n, cap))
    m.count.copy_(torch.clamp(m.count + n, max=cap))


def meters_append(m: Meters, values):
    """Write the rows of ``values`` [K, width] into the ring in order, in
    place, as K one-row ``meters_update`` calls would: when K exceeds the
    ring, only its last ``capacity`` rows stay."""
    cap, k = m.capacity, values.shape[0]
    kept = values[max(k - cap, 0):]
    pos = torch.remainder(m.ptr + (k - kept.shape[0]) + torch.arange(kept.shape[0], device=m.buf.device), cap)
    m.buf[pos.to(torch.int64)] = kept.to(torch.float32)
    m.ptr.copy_(torch.remainder(m.ptr + k, cap))
    m.count.copy_(torch.clamp(m.count + k, max=cap))


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


def adam_from_named(carried: dict, module: torch.nn.Module, device, prefix: str = "") -> AdamState:
    """An ``AdamState`` over ``module.parameters()`` from {'count', 'mu',
    'nu'} whose moments are keyed by parameter name (``prefix`` + the
    module's names), as ``utils/jax_params`` carries a JAX optimizer state."""
    named = [(prefix + n, p) for n, p in module.named_parameters()]
    for n, p in named:
        if n not in carried["mu"] or tuple(carried["mu"][n].shape) != tuple(p.shape):
            raise ValueError(f"the checkpoint's Adam moments have no {n} of shape {tuple(p.shape)}")
    return AdamState(count=carried["count"].to(device), mu=[carried["mu"][n].to(device) for n, _ in named],
                     nu=[carried["nu"][n].to(device) for n, _ in named])


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


def _value_loss(res, mb, e_clip, clip_value):
    """The clipped value loss on the normalized returns, or with the two-hot
    value head the negative two-hot log-prob of their symlog (the
    reference's TwoHotEncodedValue.loss, common/layers/value.py:33-38;
    ppo.py:886-898, :1174-1186)."""
    if "value_logits" in res:
        return -D.twohot_log_prob(res["value_logits"], D.symlog(mb["returns"][..., 0]))
    return L.critic_loss(mb["old_values"], res["values"], e_clip, mb["returns"], clip_value)


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
    generator: torch.Generator  # action noise, on the rollout's device
    env_state: Optional[VecEnvState]  # None for a host env
    obs: torch.Tensor
    dones: torch.Tensor  # [N] f32 — dones entering the next step
    current_rewards: torch.Tensor  # [N, value_size]
    current_shaped_rewards: torch.Tensor
    current_lengths: torch.Tensor  # [N]
    game_rewards: Meters
    game_shaped_rewards: Meters
    game_lengths: Meters
    game_scores: Meters  # infos['scores'] at episode ends
    rnn_states: Optional[tuple] = None  # the actor's, each [layers, N, units]
    cv_rnn_states: Optional[tuple] = None  # the central value net's own
    cv_opt: Optional[AdamState] = None
    adv_rms: Optional[RS.GeneralizedMovingStats] = None  # normalize_rms_advantage
    rnd_opt: Optional[AdamState] = None  # RND's predictor


def actor_obs(obs):
    """The actor's input: the 'obs' entry of the asymmetric envs'
    {'obs', 'states'} observations (ppo.py:541-547); any other dict
    observation passes whole."""
    if isinstance(obs, dict) and set(obs) <= {"obs", "states"}:
        return obs["obs"]
    return obs


def tree_map(fn, x):
    """``fn`` over a tensor, or over each entry of a dict observation."""
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


class PPOAgent:
    """PPO trainer for continuous or discrete actions over device envs.

    ``params`` is the reference YAML ``params:`` dict (algo / model /
    network / config). ``device`` defaults to CUDA; without CUDA that
    raises, and the CPU is taken only when asked for. ``vec_env`` replaces
    the env the config names (a test's fake host env).
    """

    def __init__(self, base_name: str, params: dict, device=None, vec_env=None):
        self.base_name = base_name
        self.full_params = params
        config = params["config"]
        self.config = config
        self.device = resolve_device(device)
        use_full_float32(self.device)

        # --- env ------------------------------------------------------------
        self.num_actors = config["num_actors"]
        if vec_env is None:
            vec_env = env_registry.create_vec_env_from_config(config, self.num_actors, self.device)
        self.vec_env = vec_env
        self.is_host_env = bool(getattr(vec_env, "is_host_env", False))
        self._check_env(config)
        info = self.vec_env.get_env_info()
        self.env_info = info
        self.value_size = info.value_size
        # a multi-agent env's N envs x A agents are N * A rows, agents-minor
        self.num_agents = info.agents
        self.num_rows = self.num_actors * self.num_agents
        self.observation_space = info.observation_space
        self.action_space = info.action_space
        self.obs_shape = obs_shape_of(info.observation_space)
        self.actions_num = actions_num_of(info.action_space)
        self.is_continuous = isinstance(info.action_space, Box)
        self.is_multi_discrete = isinstance(info.action_space, MultiDiscrete)
        if not isinstance(info.action_space, (Box, Discrete, MultiDiscrete)):
            raise ValueError(f"unsupported action space {info.action_space}")

        # --- config (a2c_common.py:137-330) ---------------------------------
        self.horizon_length = config["horizon_length"]
        self.batch_size = self.horizon_length * self.num_rows
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
        self.host_inference = config.get("host_inference_device", "auto")
        # where a host env's rollout runs its policy; a device env's is the device
        self.rollout_device = (rollout_device(self.host_inference, self.device, params.get("network", {}))
                               if self.is_host_env else self.device)
        self._last_timing = None  # the host path's step / play split
        self.mesh = LOCAL  # the data-parallel world, once make_train_fn(mesh=) is given one
        self._upload = HostUpload(self.rollout_device)  # the host path's per-step upload
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
        self.use_action_masks = config.get("use_action_masks", False)
        # multi-agent: the episode meters count each env once, at its first
        # agent row (env_done_indices = all_done_indices[::num_agents],
        # a2c_common.py:825-827; ppo.py:270-278)
        self._env_rows = (torch.arange(self.num_rows, device=self.device) % self.num_agents == 0
                          if self.num_agents > 1 else None)
        self._scores_seen = False  # set once the env has reported infos['scores']
        self.use_diagnostics = config.get("use_diagnostics", False)
        self.observer = (config.get("features") or {}).get("observer")
        self._rollout_time = None  # measured under use_diagnostics
        self.normalize_rms_advantage = config.get("normalize_rms_advantage", False)
        self.adv_rms_momentum = config.get("adv_rms_momentum", 0.5)
        self.mixed_precision = config.get("mixed_precision", False)
        self.seq_length = config.get("seq_length", 4)
        self.zero_rnn_on_done = config.get("zero_rnn_on_done", True)
        soft_aug_cfg = (config.get("features") or {}).get("soft_augmentation")
        self.soft_aug = build_transform(soft_aug_cfg.get("transform", {})) if soft_aug_cfg else None
        self.soft_aug_coef = float(soft_aug_cfg.get("aug_coef", 0.001)) if soft_aug_cfg else 0.0

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
        # a self-play device env applies the learner's own architecture on
        # the opponent seat (ppo.py:315-317)
        if hasattr(self.vec_env, "bind_policy"):
            self.vec_env.bind_policy(self.model)
        self.sampled_entropy = getattr(self.model, "sampled_entropy", False)
        self._build_central_value(config.get("central_value_config"), info)
        self._build_rnd(config.get("rnd_config"))

        # --- RNN wiring (ppo.py:401-428) ------------------------------------
        self.is_rnn = self.model.is_rnn()
        self.cv_is_rnn = self.has_central_value and self.cv_model.is_rnn()
        self.any_rnn = self.is_rnn or self.cv_is_rnn
        # the reference's minibatches are ordered unless asked; an RNN's always
        self.permute_batches = config.get("permute_batches", False) and not self.any_rnn
        if self.any_rnn:
            if self.horizon_length % self.seq_length != 0:
                raise ValueError("horizon_length must be divisible by seq_length")
            if self.minibatch_size % self.seq_length != 0:
                raise ValueError("minibatch_size must be divisible by seq_length")
            self.games_num = self.minibatch_size // self.seq_length
        if self.cv_is_rnn:
            if self.cv_minibatch_size % self.seq_length != 0:
                raise ValueError("central value minibatch_size must be divisible by seq_length")
            self.cv_games_num = self.cv_minibatch_size // self.seq_length

        # a host rollout on another device than the model's runs a copy of
        # it (and of the central value net) there, given the weights once
        # per epoch
        def rollout_copy(module):
            if module is None or self.rollout_device == self.device:
                return module
            return copy.deepcopy(module).to(self.rollout_device)

        self._rollout_model = rollout_copy(self.model)
        self._rollout_cv_model = rollout_copy(self.cv_model)

        if self.is_continuous:
            space = self.action_space
            self._rescale = bool(np.isfinite(space.low).all() and np.isfinite(space.high).all())
            self._action_low = torch.as_tensor(space.low, dtype=torch.float32, device=self.rollout_device)
            self._action_high = torch.as_tensor(space.high, dtype=torch.float32, device=self.rollout_device)

    def _build_central_value(self, cv_cfg: Optional[dict], info):
        """The asymmetric critic (ppo.py:319-370): a value-only model over
        the env's states, its own Adam (eps 1e-8, a fixed learning rate,
        the global-norm clip only with truncate_grads) and minibatches
        (batch // minibatch_size of them: the tail is dropped). With it the
        actor's value head carries no loss."""
        self.has_central_value = cv_cfg is not None
        self.has_value_loss = not self.has_central_value
        self.cv_model = None
        if not self.has_central_value:
            return
        self.state_shape = obs_shape_of(info.state_space or info.observation_space)
        net = dict(cv_cfg["network"], central_value=True)
        self.cv_model = model_builder.MODEL_REGISTRY["central_value"](
            net, actions_num=None, input_shape=self.state_shape, value_size=self.value_size,
            normalize_input=cv_cfg.get("normalize_input", False), normalize_value=self.normalize_value,
            obs_shape=self.state_shape, device=self.device,
        )
        self.cv_params = list(self.cv_model.parameters())
        self.cv_lr = float(cv_cfg["learning_rate"])
        self.cv_mini_epochs = cv_cfg["mini_epochs"]
        self.cv_minibatch_size = cv_cfg.get("minibatch_size",
                                            self.num_actors * cv_cfg.get("minibatch_size_per_env", 0))
        if self.cv_minibatch_size <= 0:
            raise ValueError("central_value_config needs 'minibatch_size' or 'minibatch_size_per_env' > 0 "
                             "(central_value.py:65-74)")
        self.cv_num_minibatches = max(1, self.batch_size // self.cv_minibatch_size)
        self.cv_clip_value = cv_cfg.get("clip_value", True)
        self.cv_e_clip = cv_cfg.get("e_clip", 0.2)
        self.cv_max_norm = cv_cfg.get("grad_norm", 1.0) if cv_cfg.get("truncate_grads", False) else None

    def _build_rnd(self, rnd_cfg: Optional[dict]):
        """RND curiosity (ppo.py:227-249): target, predictor and their own
        observation normalizer, the predictor's Adam at rnd_config's rate."""
        self.rnd = None
        if not rnd_cfg:
            return
        if isinstance(self.obs_shape, dict) or len(self.obs_shape) != 1:
            raise ValueError(f"rnd_config supports flat observation spaces, not {self.obs_shape}")
        self.rnd = RNDCuriosity(rnd_cfg["network"], self.obs_shape[0], device=self.device)
        self.rnd_scale = float(rnd_cfg.get("scale_value", 1.0))
        self.rnd_lr = float(rnd_cfg.get("learning_rate", 5e-4))
        self.rnd_mini_epochs = int(rnd_cfg.get("mini_epochs", 1))
        self.rnd_minibatch = int(rnd_cfg.get("minibatch_size") or self.minibatch_size)
        if rnd_cfg.get("episodic") or rnd_cfg.get("gamma"):
            print("rnd_config: 'episodic'/'gamma' accepted but folded — the intrinsic reward joins the shaped "
                  "reward before GAE (single advantage head) rather than getting a separate episodic return")

    def _check_env(self, config: dict):
        """What a vec env must offer (ppo.py:371-400): masks, where asked
        for, from an env that can serve them, and a host env that resets on
        done: next-step autoreset would put a row from after each episode's
        end into the dataset (the reference resets inside the worker,
        common/vecenv.py:70-178)."""
        if config.get("use_action_masks", False):
            if not self.is_host_env and not getattr(self.vec_env, "has_action_masks", False):
                raise ValueError("use_action_masks: this env serves no action masks (has_action_masks is False)")
            if self.is_host_env:
                if not hasattr(self.vec_env, "get_action_masks"):
                    raise ValueError("use_action_masks requires the host vec env to expose get_action_masks() "
                                     "(IVecEnv surface, common/ivecenv.py:24-26)")
                probe = getattr(self.vec_env, "supports_action_masks", None)
                if probe is not None and not probe():
                    raise ValueError("use_action_masks: this vec env cannot serve masks (async vectorization, "
                                     "or sub-envs without get_action_mask); see GymnasiumVecEnv.supports_action_masks")
        if self.is_host_env and getattr(self.vec_env, "autoreset_mode", "same_step") == "next_step":
            raise ValueError("PPO host rollout requires same_step autoreset (reset-on-done); construct the "
                             "vec env with autoreset_mode='same_step'")

    # ------------------------------------------------------------------
    # state construction
    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> PPOTrainState:
        """Draw fresh weights into ``self.model``, reset its normalizers and
        the envs, and return the rest of the train state."""
        seed = self.seed if seed is None else seed
        model_seed, env_seed, act_seed, cv_seed, rnd_seed = (
            int(s) for s in np.random.SeedSequence(seed).generate_state(5)
        )

        def generator(s):
            return torch.Generator(device=self.device).manual_seed(s)

        self.model.reset_parameters(generator(model_seed))
        if self.has_central_value:
            self.cv_model.reset_parameters(generator(cv_seed))
        if self.rnd is not None:
            self.rnd.reset_parameters(generator(rnd_seed))
        if self.is_host_env:
            env_state, obs = None, to_device_obs(self.vec_env.reset(), self.device)
        else:
            env_state, obs = self.vec_env.reset(generator(env_seed))
            if hasattr(self.vec_env, "init_opponent"):
                # the learner's initial weights into every opponent slot (ppo.py:479-483)
                env_state = self.vec_env.init_opponent(env_state, self.get_weights())
        n, v = self.num_rows, self.value_size
        f32 = dict(dtype=torch.float32, device=self.device)
        return PPOTrainState(
            opt_state=adam_init(self.params),
            lr=torch.tensor(self.learning_rate, **f32),
            entropy_coef=torch.tensor(self.entropy_coef_init, **f32),
            epoch=torch.zeros((), dtype=torch.int32, device=self.device),
            frame=torch.zeros((), dtype=torch.int32, device=self.device),
            generator=torch.Generator(device=self.rollout_device).manual_seed(act_seed),
            env_state=env_state,
            obs=obs,
            dones=torch.ones(n, **f32),  # a2c_common: initial dones = ones
            current_rewards=torch.zeros((n, v), **f32),
            current_shaped_rewards=torch.zeros((n, v), **f32),
            current_lengths=torch.zeros(n, **f32),
            game_rewards=meters_init(self.games_to_track, v, self.device),
            game_shaped_rewards=meters_init(self.games_to_track, v, self.device),
            game_lengths=meters_init(self.games_to_track, 1, self.device),
            game_scores=meters_init(self.games_to_track, 1, self.device),
            rnn_states=self.model.get_default_rnn_state(n) if self.is_rnn else None,
            cv_rnn_states=self.cv_model.get_default_rnn_state(n) if self.cv_is_rnn else None,
            cv_opt=adam_init(self.cv_params) if self.has_central_value else None,
            adv_rms=RS.generalized_moving_stats_init((), self.device) if self.normalize_rms_advantage else None,
            rnd_opt=adam_init(list(self.rnd.predictor.parameters())) if self.rnd is not None else None,
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

    def _trajectory_buffers(self, device, obs, mask_shape=None):
        """Uninitialized [T, N, ...] trajectory tensors on ``device`` that the
        rollout fills step by step; with ``mask_shape`` (one step's masks,
        [N, ...]) also the action masks. The actor's observations ``obs``
        (one step's) give the observations' buffer: float32 of the
        observation shape, or for a dict observation one buffer per key of
        the key's shape and dtype. The observations lie env-major ([N, T,
        ...] in memory, a transposed view here), so that swap_and_flatten01
        of them is a view: at 512 envs × 64 steps of 84×84×2 frames they are
        1.85 GB. The rows are ``obs``'s: a data-parallel rank's own."""
        T, V = self.horizon_length, self.value_size
        N = (next(iter(obs.values())) if isinstance(obs, dict) else obs).shape[0]
        f32 = dict(dtype=torch.float32, device=device)
        if isinstance(obs, dict):
            obses = {k: torch.empty((N, T, *v.shape[1:]), dtype=v.dtype, device=device).transpose(0, 1)
                     for k, v in obs.items()}
        else:
            obses = torch.empty((N, T, *self.obs_shape), **f32).transpose(0, 1)
        traj = {
            "obses": obses,
            "dones": torch.empty((T, N), **f32),
            "values": torch.empty((T, N, V), **f32),
            "neglogpacs": torch.empty((T, N), **f32),
            "rewards": torch.empty((T, N, V), **f32),
        }
        if self.is_continuous:
            for k in ("actions", "mus", "sigmas"):
                traj[k] = torch.empty((T, N, self.actions_num), **f32)
        elif self.is_multi_discrete:
            traj["actions"] = torch.empty((T, N, len(self.actions_num)), dtype=torch.int64, device=device)
        else:
            traj["actions"] = torch.empty((T, N), dtype=torch.int64, device=device)
        if mask_shape is not None:
            traj["action_masks"] = torch.empty((T, *mask_shape), dtype=torch.bool, device=device)
        if self.has_central_value:  # the central value net's input (ppo.py:649-650)
            traj["states"] = torch.empty((N, T, *self.state_shape), **f32).transpose(0, 1)
        return traj

    @staticmethod
    def _write_step(traj, t, step):
        """Step ``t``'s entries into the trajectory's buffers."""
        for k, buf in traj.items():
            if isinstance(buf, dict):
                for key, b in buf.items():
                    b[t] = step[k][key]
            else:
                buf[t] = step[k]

    def _rnn_kw(self, is_rnn: bool, states, dones):
        """A one-step forward's recurrent arguments: the running states and,
        with zero_rnn_on_done, the dones entering the step."""
        if not is_rnn:
            return {}
        return {"rnn_states": states, "dones": dones if self.zero_rnn_on_done else None, "seq_length": 1}

    def _stack_snapshots(self, traj, snaps, cv_snaps):
        """The windows' first states, each tensor [W, layers, N, units], into
        ``traj`` as 'rnn_snapshots' / 'cv_rnn_snapshots'."""
        if self.is_rnn:
            traj["rnn_snapshots"] = tuple(torch.stack(x) for x in zip(*snaps))
        if self.cv_is_rnn:
            traj["cv_rnn_snapshots"] = tuple(torch.stack(x) for x in zip(*cv_snaps))

    @torch.no_grad()
    def _rollout(self, state: PPOTrainState):
        """horizon_length policy + env steps (play_steps / play_steps_rnn,
        a2c_common.py:787-939). Returns the trajectory (each entry [T, N,
        ...]; with an RNN also each window's first states, see
        ``_stack_snapshots``) and the bootstrap values of the final
        observations; updates ``state`` and, after the last step, the
        meters (``_write_meters``)."""
        model = self.model
        env_state, obs, dones = state.env_state, state.obs, state.dones
        cur_r, cur_sr = state.current_rewards, state.current_shaped_rewards
        cur_len = state.current_lengths
        rnn, cv_rnn = state.rnn_states, state.cv_rnn_states
        snaps, cv_snaps = [], []
        masks = self.vec_env.get_action_masks if self.use_action_masks else None
        traj = self._trajectory_buffers(self.device, actor_obs(obs), masks(env_state).shape if masks else None)
        finished = []
        for t in range(self.horizon_length):
            if self.any_rnn and t % self.seq_length == 0:
                snaps.append(rnn)
                cv_snaps.append(cv_rnn)
            # get_masked_action_values (a2c_common.py:793-797)
            kw = {"action_masks": masks(env_state)} if masks else {}
            res = model.forward_play(actor_obs(obs), generator=state.generator, **kw,
                                     **self._rnn_kw(self.is_rnn, rnn, dones))
            rnn = res["rnn_states"]
            if self.has_central_value:
                # the values come from the central net, whose own states
                # advance in parallel (ppo.py:590-606)
                cv_res = self.cv_model.forward_play(obs["states"], **self._rnn_kw(self.cv_is_rnn, cv_rnn, dones))
                res["values"], cv_rnn = cv_res["values"], cv_res["rnn_states"]
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
            scores = infos["scores"].to(torch.float32).reshape(-1, 1) if "scores" in infos else None
            self._scores_seen = self._scores_seen or scores is not None
            finished.append((cur_r, cur_sr, cur_len, done_mask, scores))
            not_done = 1.0 - new_dones.to(torch.float32)
            cur_r = cur_r * not_done[:, None]
            cur_sr = cur_sr * not_done[:, None]
            cur_len = cur_len * not_done

            step = {**res, **kw, "obses": actor_obs(obs), "dones": dones, "values": values, "rewards": shaped}
            if self.has_central_value:
                step["states"] = obs["states"]
            self._write_step(traj, t, step)
            obs, dones = next_obs, new_dones.to(torch.float32)

        last_values = self._bootstrap_values(model, self.cv_model, obs, dones, rnn, cv_rnn)
        self._stack_snapshots(traj, snaps, cv_snaps)
        state.env_state, state.obs, state.dones = env_state, obs, dones
        state.current_rewards, state.current_shaped_rewards = cur_r, cur_sr
        state.current_lengths = cur_len
        state.rnn_states, state.cv_rnn_states = rnn, cv_rnn
        self._write_meters(state, finished)
        return traj, last_values

    def _write_meters(self, state: PPOTrainState, finished):
        """The rollout's episode accounting into the meters (a2c_common.py:820-834):
        ``finished`` holds each step's accumulators, dones and any scores;
        the world's rows are gathered (a collective) and the rows that
        finished are written in (step, global row) order, in one
        ``meters_update`` a meter, which leaves what one call a step would.
        An env counts once, at its first agent row; the score at each
        episode's end (algo_observer.py:29-92)."""
        cur_r, cur_sr, cur_len, done, scores = (
            None if x[0] is None else gather_rows(torch.stack(x), self.mesh, axis=1).flatten(0, 1)
            for x in zip(*finished))
        if self._env_rows is not None:
            done = done & self._env_rows.repeat(self.horizon_length)
        meters_update(state.game_rewards, cur_r, done)
        meters_update(state.game_shaped_rewards, cur_sr, done)
        meters_update(state.game_lengths, cur_len[:, None], done)
        if scores is not None:
            meters_update(state.game_scores, scores, done)

    def _bootstrap_values(self, model, cv_model, obs, dones, rnn, cv_rnn):
        """The values of the final observations (get_values,
        a2c_common:474-483; ppo.py:697-716), from the running states; they
        do not depend on the sample, so none is drawn."""
        if self.has_central_value:
            return cv_model.forward_play(obs["states"], **self._rnn_kw(self.cv_is_rnn, cv_rnn, dones))["values"]
        return model.forward_play(actor_obs(obs), deterministic=True,
                                  **self._rnn_kw(self.is_rnn, rnn, dones))["values"]

    @torch.no_grad()
    def _prepare_dataset(self, state: PPOTrainState, traj, last_values, last_dones=None):
        """RND's intrinsic reward, GAE + dataset assembly (a2c_common.py:836-849,
        1309-1370; ppo.py:728-836). With an RNN the dataset also holds the
        windows' first states as 'rnn_states' / 'cv_rnn_states'.
        ``last_dones``: the dones after the last step (``state.dones``
        unless given: a data-parallel rank gives the world's)."""
        traj = dict(traj)
        snaps, cv_snaps = traj.pop("rnn_snapshots", None), traj.pop("cv_rnn_snapshots", None)
        mb_values = traj["values"]  # [T, N, V] (denormalized)
        mb_rewards = traj["rewards"]
        if self.rnd is not None:
            # RND's normalizer takes this rollout first; the intrinsic reward
            # joins the shaped reward before GAE (ppo.py:736-750)
            flat = traj["obses"].reshape(-1, traj["obses"].shape[-1])
            self.rnd.running_mean_std.update_from_batch(flat)
            intrinsic = self.rnd.intrinsic(self.rnd.running_mean_std.normalize(flat))
            mb_rewards = mb_rewards + self.rnd_scale * intrinsic.reshape(mb_rewards.shape[:2])[..., None]
        mb_advs = compute_gae(
            mb_rewards, mb_values, traj["dones"], last_values, state.dones if last_dones is None else last_dones,
            self.gamma, self.tau,
        )
        mb_returns = mb_advs + mb_values

        dataset = {k: tree_map(swap_and_flatten01, v) for k, v in traj.items()}
        returns = swap_and_flatten01(mb_returns)
        values = dataset.pop("values")
        advantages = returns - values  # [B, V]

        self.model.update_obs_stats(dataset["obses"])
        # the value normalizer lives on the central value net where there is
        # one (a2c_continuous.py:73), whose input normalizer sees the states
        value_model = self.model
        if self.has_central_value:
            value_model = self.cv_model
            value_model.update_obs_stats(dataset["states"])
        # value-normalizer parity: the reference runs TWO train-mode
        # forwards, value_mean_std(values) then value_mean_std(returns)
        # (a2c_common.py:1325-1332), so the stats advance from both batches
        # and returns normalize with the post-values stats
        if self.normalize_value:
            if not self.freeze_critic:
                value_model.update_value_stats(values)
            values = value_model.normalize_values(values)
            if not self.freeze_critic:
                value_model.update_value_stats(returns)
            returns = value_model.normalize_values(returns)

        advantages = advantages.sum(dim=1)  # [B] (a2c_common:1334)
        if self.normalize_advantage:
            if self.normalize_rms_advantage:
                # GeneralizedMovingStats('mean_std', decay=momentum)
                # (a2c_common.py:342-344; ppo.py:797-808)
                state.adv_rms = RS.generalized_moving_stats_update(state.adv_rms, advantages,
                                                                    decay=self.adv_rms_momentum)
                advantages = RS.generalized_moving_stats_normalize(state.adv_rms, advantages,
                                                                   decay=self.adv_rms_momentum)
            else:
                advantages = L.normalize_advantage(advantages)
        dataset["old_values"] = values
        dataset["returns"] = returns
        dataset["advantages"] = advantages
        dataset["old_logp_actions"] = dataset.pop("neglogpacs")

        def to_dataset_states(snapshots):
            # [W, layers, N, units] -> [layers, N * W, units]: sequence
            # s = e * W + w, the env-major flatten's (ppo.py:817-827)
            return tuple(x.permute(1, 2, 0, 3).reshape(x.shape[1], x.shape[2] * x.shape[0], x.shape[3])
                         for x in snapshots)

        if snaps is not None:
            dataset["rnn_states"] = to_dataset_states(snaps)
        if cv_snaps is not None:
            dataset["cv_rnn_states"] = to_dataset_states(cv_snaps)
        return dataset

    def _minibatch(self, dataset, sel, size: Optional[int] = None, states_key: str = "rnn_states",
                   games: Optional[int] = None):
        """The rows of a minibatch: ``size`` rows from row ``sel`` (an int), or
        the rows ``sel`` (an index tensor, permute_batches). With the
        dataset's recurrent states under ``states_key``, the minibatch's
        sequences start from their slice of them, ``games`` sequences from
        sequence sel // seq_length (ppo.py:993-1003)."""
        size = self.minibatch_size if size is None else size

        def rows(v):
            return v[sel] if torch.is_tensor(sel) else v[sel:sel + size]

        mb = {k: tree_map(rows, v) for k, v in dataset.items() if k not in ("rnn_states", "cv_rnn_states")}
        if states_key in dataset:
            first = sel // self.seq_length
            games = self.games_num if games is None else games
            mb["rnn_states"] = tuple(x[:, first:first + games] for x in dataset[states_key])
        return mb

    def _forward_fn(self):
        """``forward(mode, ...)``: the model's forwards, on its weights or,
        under mixed_precision, on the weights rounded to bfloat16 (round to
        nearest even) and back to float32 through a differentiable cast, so
        that the gradients are rounded alike (ppo.py:844-851)."""
        if not self.mixed_precision:
            return self.model
        rounded = {name: p.to(torch.bfloat16).to(torch.float32) if p.dtype == torch.float32 else p
                   for name, p in self.model.named_parameters()}
        return lambda mode, *args, **kwargs: torch.func.functional_call(self.model, rounded, (mode, *args), kwargs)

    def _loss_and_kl(self, mb, entropy_coef, entropy_noise=None, aug_obs=None):
        """Loss assembly (a2c_continuous.py:97-133, a2c_discrete.py:116-190;
        ppo.py:838-969). ``entropy_noise``: the tanh policy's standard
        normals for its sampled entropy; ``aug_obs``: the minibatch's
        observations through the soft augmentation's transform. Returns the
        scalar loss and detached diagnostics."""
        kw = {}
        if self.use_action_masks:
            kw["action_masks"] = mb["action_masks"]
        if self.sampled_entropy:
            kw["entropy_noise"] = entropy_noise
        if self.is_rnn:
            kw.update(rnn_states=mb["rnn_states"], dones=mb["dones"] if self.zero_rnn_on_done else None,
                      seq_length=self.seq_length)
        forward = self._forward_fn()
        res = forward("forward_train", mb["obses"], mb["actions"], **kw)
        actor_loss_fn = L.smoothed_actor_loss if self.use_smooth_clamp else L.actor_loss
        a_loss = actor_loss_fn(
            mb["old_logp_actions"], res["prev_neglogp"], mb["advantages"], self.ppo, self.e_clip
        )
        if self.has_value_loss:
            c_loss = _value_loss(res, mb, self.e_clip, self.clip_value)
        else:
            # the central value net owns the value loss (a2c_continuous.py:75)
            c_loss = torch.zeros_like(res["values"])
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
        # a custom network's auxiliary losses (get_aux_loss,
        # a2c_continuous.py:194-202; ppo.py:923-926)
        for v in (res.get("aux_losses") or {}).values():
            total = total + v.mean()
        if self.soft_aug is not None and aug_obs is not None:
            # soft augmentation (soft_augmentation.py:18-31): the KL from the
            # detached policy on the observations to the policy on their
            # transform, and a value-consistency term
            q = forward("forward_train", aug_obs, mb["actions"], **kw)
            if self.is_continuous:
                aug_kl = self.model.kl(res["mus"].detach(), res["sigmas"].detach(), q["mus"], q["sigmas"])
            elif self.is_multi_discrete:
                aug_kl = self.model.kl(tuple(x.detach() for x in res["logits"]), q["logits"])
            else:
                aug_kl = self.model.kl(res["logits"].detach(), q["logits"])
            v_cons = (0.5 * torch.square(res["values"].detach() - q["values"])).sum(-1).mean()
            total = total + self.soft_aug_coef * (aug_kl.mean() + v_cons)
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

    def _reduce(self, grads, scalars: dict):
        """A data-parallel rank's gradients and the scalars beside them (the
        losses, kl, the clip fraction) averaged over the world in one
        all-reduce; as they are in a single process."""
        keys = list(scalars)
        vals = torch.stack([scalars[k] for k in keys])
        all_reduce_mean_([*grads, vals], self.mesh)
        return grads, {**scalars, **dict(zip(keys, vals.unbind()))}

    def _update(self, state: PPOTrainState, dataset) -> Dict[str, torch.Tensor]:
        """Minibatch epochs (train_epoch, a2c_common.py:1269-1302; datasets.py):
        ordered contiguous slices, whole sequences with an RNN, or with
        permute_batches a fresh permutation of the batch each mini-epoch.
        A data-parallel rank computes rows [lo, hi) of each minibatch (its
        draws taken at the minibatch's shape and sliced alike) and the
        world averages the gradients, kl and the metrics before the step."""
        legacy = self.schedule_type == "legacy"
        lr, ec = state.lr, state.entropy_coef
        max_norm = self.grad_norm if self.truncate_grads else None
        metrics = {k: torch.zeros((), dtype=torch.float32, device=self.device) for k in _METRIC_KEYS}
        diag = {"kl": [], "clip_frac": []}
        size = self.minibatch_size
        lo, hi = self.mesh.block(size, "minibatch_size")
        games = (hi - lo) // self.seq_length if self.any_rnn else None
        for _ in range(self.mini_epochs_num):
            perm = self._permutation(state) if self.permute_batches else None
            ms = {k: [] for k in _METRIC_KEYS}
            for i in range(self.num_minibatches):
                start = i * size
                sel = start if perm is None else perm[start:start + size]
                mb = self._minibatch(dataset, start + lo if perm is None else sel[lo:hi], hi - lo, games=games)
                # the draws at the whole minibatch's shape, this rank's rows of them
                noise, aug = self._entropy_noise(state), None
                if self.soft_aug is not None:
                    whole = tree_map(lambda v: v[start:start + size] if perm is None else v[sel], dataset["obses"])
                    aug = self._augment(state, whole)
                noise, aug = (None if x is None else tree_map(lambda v: v[lo:hi], x) for x in (noise, aug))
                total, aux = self._loss_and_kl(mb, ec, noise, aug)
                # with a central value net the actor's value head has no
                # gradient: zeros, as the JAX package's grad gives it
                grads = torch.autograd.grad(total, self.params, allow_unused=True, materialize_grads=True)
                grads, reduced = self._reduce(grads, {k: aux[k] for k in _METRIC_KEYS})
                aux = {**aux, **reduced}
                adam_step(self.params, grads, state.opt_state, lr, max_norm, self.weight_decay)
                if legacy:
                    if self.is_continuous:
                        # mu/sigma writeback (datasets.py:33-43), in place
                        # in the dataset rather than into a copy of it. A
                        # rank writes the rows it computed; under a
                        # permutation rows change rank, so every rank takes
                        # the whole minibatch's
                        mus, sigmas = aux["mus"], aux["sigmas"]
                        if perm is None:
                            rows = slice(start + lo, start + hi)
                        else:
                            rows = sel
                            mus, sigmas = gather_rows(mus, self.mesh), gather_rows(sigmas, self.mesh)
                        dataset["mus"][rows] = mus
                        dataset["sigmas"][rows] = sigmas
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

    def _permutation(self, state: PPOTrainState):
        """One mini-epoch's permutation of the batch (permute_batches), from
        the train state's generator."""
        gen = state.generator
        return torch.randperm(self.batch_size, generator=gen, device=gen.device).to(self.device)

    def _augment(self, state: PPOTrainState, obs):
        """One minibatch's observations through the soft augmentation's
        transform, drawn from the train state's generator; None without
        soft augmentation."""
        if self.soft_aug is None:
            return None
        return self.soft_aug(state.generator, obs)

    def _entropy_noise(self, state: PPOTrainState):
        """Fresh standard normals for one minibatch of the tanh policy's
        sampled entropy (ppo.py:861-868), from the train state's generator;
        None for every other model."""
        if not self.sampled_entropy:
            return None
        gen = state.generator
        noise = torch.randn((self.minibatch_size, self.actions_num), generator=gen, device=gen.device)
        return noise.to(self.device)

    def _update_central_value(self, state: PPOTrainState, dataset):
        """The central value net's epochs (central_value.py:246-339;
        ppo.py:1134-1202): cv mini_epochs x (batch // minibatch) ordered
        minibatches, whole sequences with an RNN; the clipped value loss on
        the normalized returns; its own Adam. Returns the mean loss."""
        size = self.cv_minibatch_size
        lo, hi = self.mesh.block(size, "central value minibatch_size")
        keys = ("states", "old_values", "returns") + (("dones",) if self.cv_is_rnn else ())
        cols = {k: dataset[k] for k in keys}
        if self.cv_is_rnn:
            cols["cv_rnn_states"] = dataset["cv_rnn_states"]
        losses = []
        for _ in range(self.cv_mini_epochs):
            for i in range(self.cv_num_minibatches):
                mb = self._minibatch(cols, i * size + lo, hi - lo, "cv_rnn_states",
                                     (hi - lo) // self.seq_length if self.cv_is_rnn else None)
                kw = {}
                if self.cv_is_rnn:
                    kw = dict(rnn_states=mb["rnn_states"], dones=mb["dones"] if self.zero_rnn_on_done else None,
                              seq_length=self.seq_length)
                res = self.cv_model.forward_train(mb["states"], **kw)
                loss = _value_loss(res, mb, self.cv_e_clip, self.cv_clip_value).mean()
                grads = torch.autograd.grad(loss, self.cv_params)
                # the central value net's own all-reduce (central_value.py:322-339)
                grads, reduced = self._reduce(grads, {"loss": loss.detach()})
                adam_step(self.cv_params, grads, state.cv_opt, self.cv_lr, self.cv_max_norm)
                losses.append(reduced["loss"])
        return torch.stack(losses).mean()

    def _update_rnd(self, state: PPOTrainState, dataset):
        """The RND predictor's epochs (ppo.py:1099-1132): rnd mini_epochs x
        (batch // minibatch) Adam steps over the rollout's observations,
        normalized with the stats _prepare_dataset updated (the tail rows
        are dropped). Returns the mean loss."""
        obs = dataset["obses"]
        with torch.no_grad():
            obs_n = self.rnd.running_mean_std.normalize(obs.reshape(-1, obs.shape[-1]))
        size = min(self.rnd_minibatch, obs_n.shape[0])
        lo, hi = self.mesh.block(size, "RND minibatch_size")
        params = list(self.rnd.predictor.parameters())
        losses = []
        for _ in range(self.rnd_mini_epochs):
            for i in range(max(obs_n.shape[0] // size, 1)):
                loss = self.rnd.loss(obs_n[i * size + lo:i * size + hi])
                grads = torch.autograd.grad(loss, params)
                grads, reduced = self._reduce(grads, {"loss": loss.detach()})
                adam_step(params, grads, state.rnd_opt, self.rnd_lr)
                losses.append(reduced["loss"])
        return torch.stack(losses).mean()

    def _finish_epoch(self, state: PPOTrainState, traj, last_values, last_dones=None):
        """prepare_dataset → central value → RND → minibatch updates →
        counters and metrics (ppo.py:1204-1300)."""
        dataset = self._prepare_dataset(state, traj, last_values, last_dones)
        # freeze_critic skips the central value net's training
        # (central_value.py:253-255)
        cval_loss = None
        if self.has_central_value and not self.freeze_critic:
            cval_loss = self._update_central_value(state, dataset)
        rnd_loss = self._update_rnd(state, dataset) if self.rnd is not None else None
        metrics = self._update(state, dataset)
        if rnd_loss is not None:
            metrics["rnd_loss"] = rnd_loss
        if cval_loss is not None:
            metrics["cval_loss"] = cval_loss
        # PpoDiagnostics explained variance (diagnostics.py:18-60)
        metrics["explained_variance"] = MK.explained_variance(
            dataset["old_values"].reshape(-1), dataset["returns"].reshape(-1)
        )
        if self.use_diagnostics:
            # the normalizers' state (ppo.py:1274-1282)
            model = self.model
            # a dict observation's stats are per key: none reported (ppo.py:1276)
            if self.normalize_input and not isinstance(model.running_mean_std, RS.RunningMeanStdObs):
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
        if self._scores_seen:
            metrics["mean_scores"] = meters_mean(state.game_scores)[0]
        metrics["frame"] = state.frame
        metrics["epoch"] = state.epoch
        return state, metrics

    def train_epoch(self, state: PPOTrainState):
        """One full PPO epoch: rollout → GAE → minibatch updates. A
        data-parallel rank steps its rows (the state is cut to them first,
        if it is not yet), the world gathers the trajectory, and every rank
        prepares the single process's dataset and computes its slice of
        each minibatch. In ``LOCAL`` the gathers return their input."""
        mesh = self.mesh
        if mesh.size > 1 and not isinstance(state.generator, RowGenerator):
            state = self._shard_state(state)
        traj, last_values = self._rollout(state)

        def rows(x, axis):
            return tree_map(lambda v: gather_rows(v, mesh, axis), x)

        out = {}
        for k, v in traj.items():
            if k in ("obses", "states"):  # env-major [n, T, ...] memory, kept so
                out[k] = tree_map(lambda x: gather_rows(x.movedim(1, 0), mesh).movedim(0, 1), v)
            elif k in ("rnn_snapshots", "cv_rnn_snapshots"):  # [W, layers, n, units]
                out[k] = gather_rows(v, mesh, axis=2)
            else:
                out[k] = rows(v, 1)
        return self._finish_epoch(state, out, rows(last_values, 0), rows(state.dones, 0))

    # ------------------------------------------------------------------
    # data parallelism (parallel/mesh.py; the reference's DDP path,
    # a2c_common.py:109, :362-378): each rank steps its block of the envs,
    # the world gathers the trajectory, every rank prepares the same global
    # dataset and computes its slice of each minibatch
    # ------------------------------------------------------------------
    def _check_world(self, mesh):
        """The sizes a world of ``mesh.size`` ranks must divide, checked
        before the first epoch (ValueError)."""
        mesh.block(self.num_actors, "num_actors")
        mesh.block(self.minibatch_size, "minibatch_size")
        if self.any_rnn:
            mesh.block(self.games_num, "minibatch_size // seq_length (a minibatch's sequences)")
        if self.has_central_value:
            mesh.block(self.cv_minibatch_size, "central value minibatch_size")
            if self.cv_is_rnn:
                mesh.block(self.cv_games_num, "central value minibatch_size // seq_length")
        if self.rnd is not None:
            mesh.block(min(self.rnd_minibatch, self.batch_size), "RND minibatch_size")

    def _shard_state(self, state: PPOTrainState) -> PPOTrainState:
        """The rank's rows of a single-process train state (the counterpart of
        ppo_state_shardings): the vec env and its state cut to the rank's
        block of envs, the row fields to its N·A rows (the recurrent states
        on their axis 1), the action noise's generator drawing the world's
        rows; the rest replicated. Every rank starts from the same state."""
        lo, hi = self.mesh.block(self.num_actors, "num_actors")
        a, rows = self.num_agents, self.num_rows
        state.env_state = self.vec_env.take_rows(state.env_state, lo, hi)
        for f in _PPO_DATA_FIELDS[1:] + ("generator",):
            setattr(state, f, shard_rows(getattr(state, f), lo * a, hi * a, rows))
        for f in _PPO_RNN_FIELDS:
            setattr(state, f, shard_rows(getattr(state, f), lo * a, hi * a, rows, axis=1))
        return state

    def _world_state(self, state: PPOTrainState) -> PPOTrainState:
        """The single process's train state from a data-parallel rank's: the
        row fields gathered from every rank (a collective: every rank calls
        it), so that a checkpoint holds the world's rows."""
        if not isinstance(state.generator, RowGenerator):
            return state
        rows = {f: unshard_rows(getattr(state, f), self.mesh) for f in _PPO_DATA_FIELDS}
        rows.update({f: unshard_rows(getattr(state, f), self.mesh, axis=1) for f in _PPO_RNN_FIELDS})
        return dataclasses.replace(state, **rows)

    # ------------------------------------------------------------------
    # the host-env rollout (ppo.py:1311-1490; the reference's Ray/envpool
    # path): the env on the host, GAE and the updates on the device
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _host_rollout(self, state: PPOTrainState):
        """horizon_length policy + host env steps. The policy (and the
        central value net) runs on ``rollout_device``; per step one copy
        brings the env's actions and the values to the host and one takes
        the next observations ({'obs', 'states'} of an asymmetric env
        both), shaped rewards and dones up. The episode accounting runs on
        the host, as the JAX package's update_meters pass does it
        (ppo.py:1208-1248), and its finished episodes reach the meters at
        the end. With an RNN the states are kept at every step t with t %
        seq_length == 0 (ppo.py:1390-1392). Returns the trajectory and the
        bootstrap values on the agent's device; updates ``state`` and
        ``_last_timing``."""
        dev, model, cv_model, observer = self.rollout_device, self._rollout_model, self._rollout_cv_model, self.observer
        if model is not self.model:
            model.load_state_dict(self.model.state_dict())  # this epoch's weights and stats
        if cv_model is not self.cv_model:
            cv_model.load_state_dict(self.cv_model.state_dict())
        T, N, V = self.horizon_length, self.num_rows, self.value_size
        first_rows = np.arange(N) % self.num_agents == 0  # each env's first agent row (ppo.py:1226-1228)

        def to_dev(x):
            return None if x is None else tuple(t.to(dev) for t in x)

        obs = ({k: v.to(dev) for k, v in state.obs.items()} if isinstance(state.obs, dict)
               else state.obs.to(dev))
        dones = state.dones.to(dev)
        rnn, cv_rnn = to_dev(state.rnn_states), to_dev(state.cv_rnn_states)
        snaps, cv_snaps = [], []
        kw = {}
        if self.use_action_masks:
            # the masks of the step's observations, read with them (ppo.py:1395-1399)
            kw["action_masks"] = self._upload(self.vec_env.get_action_masks())[0]
        traj = self._trajectory_buffers(dev, actor_obs(obs), kw["action_masks"].shape if kw else None)
        cur_r, cur_sr, cur_len = (x.cpu().numpy() for x in (
            state.current_rewards, state.current_shaped_rewards, state.current_lengths))
        finished = []  # (reward, shaped reward, length) of each episode that ended, in order
        step_time = 0.0  # the env's step alone (a2c_common.py:806-810)
        t_play0 = time.perf_counter()
        for t in range(T):
            if self.any_rnn and t % self.seq_length == 0:
                snaps.append(rnn)
                cv_snaps.append(cv_rnn)
            res = model.forward_play(actor_obs(obs), generator=state.generator, **kw,
                                     **self._rnn_kw(self.is_rnn, rnn, dones))
            rnn = res["rnn_states"]
            if self.has_central_value:
                cv_res = cv_model.forward_play(obs["states"], **self._rnn_kw(self.cv_is_rnn, cv_rnn, dones))
                res["values"], cv_rnn = cv_res["values"], cv_res["rnn_states"]
            env_actions = self._env_actions(res["actions"])
            host = torch.cat([env_actions.reshape(N, -1).to(torch.float32), res["values"]], dim=1).cpu().numpy()
            actions = host[:, :-V]
            if not self.is_continuous:
                actions = actions.astype(np.int64) if self.is_multi_discrete else actions[:, 0].astype(np.int64)
            t0 = time.perf_counter()
            next_obs, rewards, new_dones, infos = self.vec_env.step(actions)
            step_time += time.perf_counter() - t0
            new_dones = np.asarray(new_dones, bool)
            if observer is not None:  # where the infos are on the host (algo_observer.py:6-26)
                observer.process_infos(infos, np.flatnonzero(new_dones))
                observer.after_steps()
            rewards = np.asarray(rewards, np.float32).reshape(N, V)
            shaped = self.rewards_shaper(torch.from_numpy(rewards)).numpy()
            if self.value_bootstrap and "time_outs" in infos:
                shaped = shaped + self.gamma * host[:, -V:] * np.asarray(infos["time_outs"], np.float32)[:, None]
            cur_r, cur_sr, cur_len = cur_r + rewards, cur_sr + shaped, cur_len + 1.0
            finished += [(cur_r[i], cur_sr[i], cur_len[i]) for i in np.flatnonzero(new_dones & first_rows)]
            not_done = 1.0 - new_dones.astype(np.float32)
            cur_r, cur_sr, cur_len = cur_r * not_done[:, None], cur_sr * not_done[:, None], cur_len * not_done
            # the next step's masks go up in the same copy
            next_obs, uploaded = upload_obs(self._upload, next_obs, shaped, new_dones,
                                            *((self.vec_env.get_action_masks(),) if kw else ()))
            step = {**res, **kw, "obses": actor_obs(obs), "dones": dones, "rewards": uploaded[0]}
            if self.has_central_value:
                step["states"] = obs["states"]
            self._write_step(traj, t, step)
            obs, dones = next_obs, uploaded[1]
            if kw:
                kw["action_masks"] = uploaded[2]
        last_values = self._bootstrap_values(model, cv_model, obs, dones, rnn, cv_rnn)
        self._stack_snapshots(traj, snaps, cv_snaps)
        self._last_timing = {"step_time": step_time, "play_time": time.perf_counter() - t_play0}

        to_dev = dict(device=self.device, dtype=torch.float32)
        state.obs = ({k: v.to(self.device) for k, v in obs.items()} if isinstance(obs, dict)
                     else obs.to(self.device))
        state.dones = dones.to(self.device)
        state.rnn_states, state.cv_rnn_states = (None if x is None else tuple(t.to(self.device) for t in x)
                                                 for x in (rnn, cv_rnn))
        state.current_rewards, state.current_shaped_rewards, state.current_lengths = (
            torch.as_tensor(x, **to_dev) for x in (cur_r, cur_sr, cur_len))
        if finished:
            r, sr, length = (np.stack(x) for x in zip(*finished))
            meters_append(state.game_rewards, torch.as_tensor(r, **to_dev))
            meters_append(state.game_shaped_rewards, torch.as_tensor(sr, **to_dev))
            meters_append(state.game_lengths, torch.as_tensor(length[:, None], **to_dev))
        return ({k: (tuple(t.to(self.device) for t in v) if isinstance(v, tuple)
                     else tree_map(lambda x: x.to(self.device), v))
                 for k, v in traj.items()}, last_values.to(self.device))

    def host_train_epoch(self, state: PPOTrainState):
        """One PPO epoch over a host env: the host rollout, then GAE and the
        minibatch updates on the device."""
        traj, last_values = self._host_rollout(state)
        return self._finish_epoch(state, traj, last_values)

    def make_train_fn(self, mesh=None):
        """The epoch function for this agent's env (ppo.py:1489-1530). With
        a ``mesh`` (parallel/mesh.create_mesh) the agent becomes one rank of
        a data-parallel world: its epoch steps the rank's block of the envs
        and N ranks compute the single process's epoch at the same global
        batch. A host env ignores the mesh, with a UserWarning, as the JAX
        package does."""
        if self.is_host_env:
            if mesh is not None:
                warnings.warn(
                    "make_train_fn(mesh=...) with a host-stepped env: the mesh is ignored; host envs run the "
                    "single-process path. Run one env pool per process instead.",
                    UserWarning, stacklevel=2)
            return self.host_train_epoch
        if mesh is not None:
            self._check_world(mesh)
            self.mesh = mesh
        return self.train_epoch

    # ------------------------------------------------------------------
    # weights and checkpoints (a2c_common.py:645-710). The JAX package keeps
    # params and normalizer stats in the train state; here they live in
    # ``self.model``, so the weights calls take no state.
    # ------------------------------------------------------------------
    def clear_stats(self, state: PPOTrainState) -> PPOTrainState:
        """Reset episode meters + accumulators, then tell the observer
        (algo.clear_stats, a2c_common.py:645-648), e.g. after a self-play
        push, so that the manager's threshold re-arms on fresh games. The
        accumulators are one a row: N * A for a multi-agent env (ppo.py:1558-1570),
        a data-parallel rank's own rows."""
        n, v = state.dones.shape[0], self.value_size
        f32 = dict(dtype=torch.float32, device=self.device)
        state.current_rewards = torch.zeros((n, v), **f32)
        state.current_shaped_rewards = torch.zeros((n, v), **f32)
        state.current_lengths = torch.zeros(n, **f32)
        state.game_rewards = meters_init(self.games_to_track, v, self.device)
        state.game_shaped_rewards = meters_init(self.games_to_track, v, self.device)
        state.game_lengths = meters_init(self.games_to_track, 1, self.device)
        state.game_scores = meters_init(self.games_to_track, 1, self.device)
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

    def _sections(self) -> dict:
        """The checkpoint sections beside 'model': the central value net
        (its state_dict under 'model.', as the reference's
        CentralValueTrain holds it) and RND's target, predictor and
        normalizer."""
        out = {}
        if self.has_central_value:
            out[CV_SECTION] = {f"model.{k}": v.detach().clone() for k, v in self.cv_model.state_dict().items()}
        if self.rnd is not None:
            out[RND_SECTION] = {k: v.detach().clone() for k, v in self.rnd.state_dict().items()}
        return out

    def _load_sections(self, payload: dict, rnd: bool = True):
        """The central value net and (with ``rnd``) RND from a checkpoint's
        sections, where it has them."""
        if self.has_central_value and CV_SECTION in payload:
            self.cv_model.load_state_dict({k[len("model."):]: v for k, v in payload[CV_SECTION].items()})
        if rnd and self.rnd is not None and RND_SECTION in payload:
            self.rnd.load_state_dict(payload[RND_SECTION])

    def get_full_state_weights(self, state: PPOTrainState,
                               last_mean_rewards: float = -100500.0) -> dict:
        """The full resumable training state (a2c_common.py:650-668) as
        plain containers of CPU tensors: weights (the central value net's
        and RND's in their sections), optimizer moments, counters,
        generators, env state and meters."""
        out = {
            "state": ckpt.tree_to_plain(state),
            "weights": ckpt.tree_to_plain(self.get_weights()),
            "epoch": int(state.epoch),
            "frame": int(state.frame),
            "last_mean_rewards": last_mean_rewards,
            **ckpt.tree_to_plain(self._sections()),
        }
        if self.is_host_env and hasattr(self.vec_env, "get_env_state"):  # ppo.py:1594
            out["env_state"] = self.vec_env.get_env_state()
        return out

    def set_full_state_weights(self, state: PPOTrainState, full: dict,
                               set_epoch: bool = True) -> PPOTrainState:
        """a2c_common.py:670-688: restore everything into ``state``'s
        structure; ``set_epoch=False`` keeps the current counters."""
        epoch, frame = state.epoch, state.frame
        new = ckpt.tree_from_plain(state, full["state"])
        if not set_epoch:
            new.epoch, new.frame = epoch, frame
        if self.is_host_env and full.get("env_state") is not None and hasattr(self.vec_env, "set_env_state"):
            self.vec_env.set_env_state(full["env_state"])
        self.set_weights(full["weights"])
        self._load_sections(full)
        return new

    def restore_central_value_only(self, checkpoint: str, state: PPOTrainState,
                                   payload: Optional[dict] = None) -> PPOTrainState:
        """load_critic_only (torch_runner.py:46-49; ppo.py:1693-1708): the
        central value net's weights, normalizers and Adam moments from a
        checkpoint, nothing else."""
        if not self.has_central_value:
            raise ValueError("Loading critic only works only for asymmetric actor critic")
        if jax_checkpoint.is_jax_checkpoint(checkpoint):
            return self.restore_jax_checkpoint(checkpoint, state, critic_only=True)[0]
        payload = ckpt.read_payload(checkpoint) if payload is None else payload
        if CV_SECTION not in payload:
            raise ValueError(f"checkpoint {checkpoint} holds no central value net ('{CV_SECTION}')")
        self._load_sections(payload, rnd=False)
        saved_opt = (payload.get("state") or {}).get("cv_opt")
        if saved_opt is not None:
            state.cv_opt = ckpt.tree_from_plain(state.cv_opt, saved_opt)
        return state

    def restore_jax_checkpoint(self, checkpoint: str, state: PPOTrainState, critic_only: bool = False):
        """Resume from a JAX package's ``.ckpt`` (utils/jax_checkpoint.py,
        utils/jax_params.ppo_jax_state): the weights and normalizers, the Adam
        moments, lr, entropy_coef, epoch and frame, the RMS advantage stats,
        the central value net and RND with their Adam states; with
        ``critic_only`` the central value net's part alone. The envs, the
        action noise, the meters and the recurrent states stay ``state``'s
        own reset: the random streams differ. Returns (state, meta)."""
        payload = jax_checkpoint.read_jax_checkpoint(checkpoint)
        cv_cfg = self.config.get("central_value_config") or {}
        carried = jax_params.ppo_jax_state(payload["state"], self.full_params["network"], self.obs_shape,
                                           cv_cfg.get("network"), getattr(self, "state_shape", None))
        for part, here in (("cv_model", self.has_central_value), ("rnd", self.rnd is not None)):
            if (carried[part] is not None) != here:
                raise ValueError(f"{checkpoint}: the JAX train state {'has' if here is False else 'lacks'} "
                                 f"{part}, the config {'has' if here else 'lacks'} it")
        if self.has_central_value:
            self.cv_model.load_state_dict(carried["cv_model"])
            state.cv_opt = adam_from_named(carried["cv_opt"], self.cv_model, self.device)
        if critic_only:
            return state, payload["meta"]
        self.model.load_state_dict(carried["model"])
        state.opt_state = adam_from_named(carried["opt"], self.model, self.device)
        if self.rnd is not None:
            self.rnd.load_state_dict(carried["rnd"])
            state.rnd_opt = adam_from_named(carried["rnd_opt"], self.rnd.predictor, self.device, "predictor.")
        if state.adv_rms is not None and carried["adv_rms"] is not None:
            state.adv_rms = RS.GeneralizedMovingStats(**{k: v.to(self.device) for k, v in carried["adv_rms"].items()})
        state.lr = carried["lr"].to(self.device)
        state.entropy_coef = carried["entropy_coef"].to(self.device)
        state.epoch = torch.tensor(carried["epoch"], dtype=torch.int32, device=self.device)
        state.frame = torch.tensor(carried["frame"], dtype=torch.int32, device=self.device)
        return state, payload["meta"]

    def reset_optimizer(self, state: PPOTrainState) -> PPOTrainState:
        """Fresh Adam moments for the policy and the central value net
        (ppo.py:1710-1717)."""
        state.opt_state = adam_init(self.params)
        if self.has_central_value:
            state.cv_opt = adam_init(self.cv_params)
        return state

    # ------------------------------------------------------------------
    # get_param / set_param (a2c_common.py:725-772; ppo.py:1612-1700): the
    # PBT / external controller surface. lr and entropy_coef live in the
    # train state; the others are attributes that every epoch reads afresh
    # (the rollout's and GAE's gamma and tau, the loss's e_clip and
    # coefficients, _update's grad_norm and mini_epochs_num), so a change
    # takes effect at the next epoch. The central value net and RND keep
    # settings of their own (cv e_clip, grad_norm and lr; rnd lr), which no
    # name here reaches, as in the JAX package.
    # ------------------------------------------------------------------
    _STATIC_PARAMS = ("grad_norm", "critic_coef", "bounds_loss_coef", "gamma", "tau", "mini_epochs_num", "e_clip")

    def get_param(self, param_name: str, state: Optional[PPOTrainState] = None):
        if param_name in self._STATIC_PARAMS:
            return getattr(self, param_name)
        if param_name == "learning_rate":
            return float(state.lr) if state is not None else self.learning_rate
        if param_name == "entropy_coef":
            return float(state.entropy_coef) if state is not None else self.entropy_coef_init
        if param_name == "kl_threshold":
            return self.config.get("kl_threshold")
        raise NotImplementedError(f"Can't get param {param_name}")

    def set_param(self, param_name: str, value, state: Optional[PPOTrainState] = None):
        """Set one param; returns ``state`` (updated in place where the
        param lives in it)."""
        if param_name in self._STATIC_PARAMS:
            setattr(self, param_name, value)
            return state
        if param_name == "learning_rate":
            if self.config.get("lr_schedule") == "adaptive":
                raise NotImplementedError("Can't directly mutate LR on this schedule")
            self.learning_rate = float(value)
            if state is not None:
                state.lr = torch.tensor(value, dtype=torch.float32, device=self.device)
            return state
        if param_name == "entropy_coef":
            self.entropy_coef_init = float(value)
            if state is not None:
                state.entropy_coef = torch.tensor(value, dtype=torch.float32, device=self.device)
            return state
        if param_name == "kl_threshold":
            if self.config.get("lr_schedule") != "adaptive":
                raise NotImplementedError("Can't mutate kl threshold on this schedule")
            self.config["kl_threshold"] = float(value)
            self.scheduler = build_scheduler(
                {**self.config,
                 "max_epochs": self.max_epochs if self.max_epochs > 0 else self.config.get("max_epochs", 1000000)},
                self.learning_rate,
            )
            return state
        raise NotImplementedError(f"No param found for {param_name}")

    def override_sigma(self, sigma: float):
        """--sigma CLI override (_override_sigma, torch_runner.py:52-60)."""
        blocked = sigma_override_blocked(self.is_continuous, self.full_params.get("network", {}))
        if blocked:
            print(blocked)
            return
        fill_sigma(self.model, sigma)

    def _save(self, path: str, state: PPOTrainState, meta: dict):
        ckpt.save_checkpoint(path, state, meta, weights=self.model.state_dict(), sections=self._sections())

    # ------------------------------------------------------------------
    # host train loop (ContinuousA2CBase.train, a2c_common.py:1372-1492)
    # ------------------------------------------------------------------
    def train(self, checkpoint: Optional[str] = None, stop_fn=None, writer=None,
              max_epochs: Optional[int] = None, sigma: Optional[float] = None,
              load_critic_only: bool = False, mesh=None):
        """Train until max_epochs / max_frames / score_to_win / stop_fn.
        With ``load_critic_only`` the checkpoint gives the central value net
        alone. With a ``mesh`` this process is one rank of a data-parallel
        world (``make_train_fn``); the checkpoints, the summaries and the
        epoch prints are rank 0's alone (a2c_common.py:113-115). Returns
        (last_mean_rewards, epoch_num); the final state stays in
        ``self.last_state``."""
        config = self.config
        main = mesh is None or mesh.rank == 0
        experiment_name = config.get("name", config.get("full_experiment_name", self.base_name))
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
        last_mean_rewards = -100500.0  # reference sentinel
        if checkpoint and load_critic_only:
            state = self.restore_central_value_only(checkpoint, state)
        elif checkpoint and jax_checkpoint.is_jax_checkpoint(checkpoint):
            # a JAX package's train state: resumes at its epoch + 1 (ppo.py:1759-1775)
            state, meta = self.restore_jax_checkpoint(checkpoint, state)
            last_mean_rewards = meta.get("last_mean_rewards", last_mean_rewards)
        elif checkpoint:
            payload = ckpt.read_payload(checkpoint)
            weights, meta = ckpt.load_checkpoint_weights(checkpoint, payload=payload)
            self.set_weights(weights)
            self._load_sections(payload)
            if "state" in payload:
                state, meta = ckpt.load_checkpoint(checkpoint, state, payload=payload)
                last_mean_rewards = meta.get("last_mean_rewards", last_mean_rewards)
            # else: a weights-only file (a reference .pth) is a warm start
        if sigma is not None:
            self.override_sigma(sigma)

        if writer is None:
            writer = create_writer(os.path.join(experiment_dir, "summaries") if main else None)
        pbt_cfg_dict = config.get("pbt") or {}
        interval_writer = pbt_manager = None
        if pbt_cfg_dict.get("enabled"):
            # PBT-scale runs throttle their summaries (a2c_common.py:326-328;
            # the reference's keys summaries_interval_sec_min/max and
            # defer_summaries_sec in the top-level config), and a member
            # steps the filesystem protocol after each epoch (ppo.py:1782-1815)
            interval_writer = writer = IntervalSummaryWriter(writer, config)
            pbt_cfg = PbtCfg.from_dict(pbt_cfg_dict)
            if not pbt_cfg.directory:
                pbt_cfg.directory = config.get("train_dir", "runs")
            pbt_manager = PbtManager(pbt_cfg, {"learning_rate": self.learning_rate,
                                               "entropy_coef": self.entropy_coef_init}, mesh=mesh)
        self.writer = writer
        # self-play (a2c_common's has_self_play_config path; ppo.py:1799-1805)
        self_play_manager = (SelfPlayManager(config["self_play_config"], writer)
                             if config.get("self_play_config") else None)
        observer = self.observer
        if observer is not None:
            observer.before_init(self.base_name, config, experiment_name)
            observer.after_init(self)
        max_epochs = self.max_epochs if max_epochs is None else max_epochs
        # a host rollout times itself (_last_timing); a device rollout is
        # timed once, under use_diagnostics
        if self.use_diagnostics and self._rollout_time is None and not self.is_host_env:
            self._rollout_time, state = self._calibrate_rollout_time(state)
        train_fn = self.make_train_fn(mesh)

        # metrics reach the host only every ``log_interval`` epochs; loop
        # control stays host-side (epoch and frame advance deterministically)
        log_interval = max(1, int(config.get("log_interval", 1)))
        epoch_num = int(state.epoch)
        frame = epoch_num * self.batch_size

        start_time = time.perf_counter()
        t_last_log, ep_last_log = start_time, epoch_num
        best_path = os.path.join(nn_dir, experiment_name + CHECKPOINT_EXT)
        while True:
            # the curriculum hook of a host env, once per epoch (ppo.py:1846-1848)
            if self.is_host_env and hasattr(self.vec_env, "set_train_info"):
                self.vec_env.set_train_info(frame, self)
            state, metrics_dev = train_fn(state)
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
            # self-play and PBT decide every epoch, on fresh metrics
            every_epoch = self_play_manager is not None or pbt_manager is not None
            if not (do_log or save_due or every_epoch):
                continue
            meta = {"last_mean_rewards": last_mean_rewards, "epoch": epoch_num, "frame": frame}
            last_path = os.path.join(nn_dir, f"last_{experiment_name}_ep_{epoch_num}{CHECKPOINT_EXT}")
            metrics = _to_host(metrics_dev) if do_log or every_epoch else None
            if self_play_manager is not None:  # ppo.py:1966-1973
                pushed, state = self_play_manager.update(self, state, metrics)
                if pushed:  # re-arm the threshold on fresh games; clear_stats tells the observer
                    state = self.clear_stats(state)
                self.last_state = state
            if pbt_manager is not None:
                state = self.last_state = pbt_manager.step(self, state, metrics)
            if not do_log:
                if save_due:
                    save(last_path, state, meta)
                continue
            now = time.perf_counter()
            total_time = now - start_time
            # divide by the ACTUAL epochs since the last log: an early log
            # (will_exit / stop_fn) covers fewer than log_interval
            epoch_time = (now - t_last_log) / max(epoch_num - ep_last_log, 1)
            t_last_log, ep_last_log = now, epoch_num
            fps_total = self.batch_size / max(epoch_time, 1e-9)
            fps_inference = None
            if self._last_timing is not None:
                # a host rollout's own split (a2c_common.py:399-404): the env
                # alone, then env + inference
                fps_step = self.batch_size / max(self._last_timing["step_time"], 1e-9)
                fps_inference = self.batch_size / max(self._last_timing["play_time"], 1e-9)
            elif self._rollout_time is not None:
                # the device rollout timed on its own (use_diagnostics): the
                # step rate leaves out the update; env and inference together
                fps_step = self.batch_size / max(self._rollout_time, 1e-9)
            else:
                fps_step = fps_total
            write_ppo_stats(writer, metrics, frame, epoch_num, total_time, fps_total,
                            fps_step, self.value_size, fps_inference=fps_inference)
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
            if interval_writer is not None:
                interval_writer.tick()
            games_played = int(metrics["games_played"])
            mean_rewards = float(metrics["mean_rewards"][0]) if games_played else None
            if config.get("print_stats", True) and main:
                print(
                    f"fps total: {fps_total:.0f} epoch: {epoch_num}"
                    + (f"/{max_epochs}" if max_epochs > 0 else "")
                    + f" frames: {frame}"
                    + (f" rew: {mean_rewards:.2f}" if mean_rewards is not None else "")
                    + (f" score: {float(metrics['mean_scores']):.3f}"
                       if games_played and "mean_scores" in metrics else "")
                )

            if save_due:
                save(last_path, state, meta)
            if (
                mean_rewards is not None
                and epoch_num >= self.save_best_after
                and mean_rewards > last_mean_rewards
            ):
                last_mean_rewards = mean_rewards
                meta["last_mean_rewards"] = last_mean_rewards
                save(best_path, state, meta)
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
                save(
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
