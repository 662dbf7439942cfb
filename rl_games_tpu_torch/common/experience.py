"""Prioritized experience replay.

Port of rl_games_tpu/common/experience.py (the reference's
PrioritizedReplayBuffer, rl_games/common/experience.py:89-205): a dense
priority array in place of the reference's segment trees, one vector pass
per operation, on the tensors' device.

* ``prioritized_sample`` draws proportionally to priority^alpha, with
  replacement, by Gumbel-max over the log-priorities, as the JAX package's
  ``jax.random.categorical`` does: argmax over [batch, capacity] of Gumbel
  noise plus the logits. It holds that [batch, capacity] array, as the JAX
  package does; no trainer samples from this buffer (the SAC ring is
  ``algos/sac.py``'s), so it stays the simple form. ``noise=`` takes the
  Gumbel draws (a test hands in the JAX package's); else they come from the
  ``torch.Generator``. The importance weights are (N·P(i))^-beta over their
  largest, (N·P_min)^-beta.
* ``prioritized_update`` scatters new priorities, floored at 1e-6 (a zero
  would turn a live row into the empty-slot sentinel p_alpha = 0), and
  raises the max-priority watermark at which ``prioritized_add`` enters new
  rows.
* An empty buffer (no positive priority) samples uniformly over the first
  max(size, 1) rows with weights of 1, as the JAX package does.

The state's tensors are updated in place (each function also returns the
state, as the JAX package's pure functions return a new one); the write
cursor and the fill are Python ints, as the SAC ring keeps them, so no
operation reads the device on the host.
"""

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class PrioritizedReplayState:
    obses: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    next_obses: torch.Tensor
    dones: torch.Tensor
    p_alpha: torch.Tensor  # [capacity] priority ** alpha (0 = empty slot)
    max_priority: torch.Tensor  # () f32, the raw (pre-alpha) watermark
    idx: int  # next write position
    size: int  # current fill


def prioritized_init(capacity: int, obs_shape, action_shape, device=None) -> PrioritizedReplayState:
    """experience.py:93-117; the watermark starts at 1."""
    f32 = dict(dtype=torch.float32, device=device)
    return PrioritizedReplayState(
        obses=torch.zeros((capacity, *obs_shape), **f32),
        actions=torch.zeros((capacity, *action_shape), **f32),
        rewards=torch.zeros((capacity,), **f32),
        next_obses=torch.zeros((capacity, *obs_shape), **f32),
        dones=torch.zeros((capacity,), dtype=torch.bool, device=device),
        p_alpha=torch.zeros((capacity,), **f32),
        max_priority=torch.ones((), **f32),
        idx=0,
        size=0,
    )


def _rows(state: PrioritizedReplayState, x, tail, dtype=torch.float32):
    n = x.shape[0] if torch.is_tensor(x) else len(x)
    return torch.as_tensor(x, dtype=dtype, device=state.p_alpha.device).reshape(n, *tail)


def prioritized_add(state: PrioritizedReplayState, obs, action, reward, next_obs, done,
                    alpha: float = 0.6) -> PrioritizedReplayState:
    """A batch of rows (leading axis: actors) at the cursor, with wraparound;
    new rows enter at the watermark ** alpha, so each is sampled at least
    once in expectation (experience.py:119-124)."""
    obs = torch.as_tensor(obs, dtype=torch.float32, device=state.p_alpha.device)
    obs = obs.reshape(1, -1) if obs.dim() < 2 else obs
    n, capacity = obs.shape[0], state.p_alpha.shape[0]
    rows = torch.remainder(torch.arange(state.idx, state.idx + n, device=obs.device), capacity)
    state.obses[rows] = obs
    state.actions[rows] = _rows(state, action, state.actions.shape[1:])
    state.rewards[rows] = _rows(state, reward, ())
    state.next_obses[rows] = _rows(state, next_obs, state.next_obses.shape[1:])
    state.dones[rows] = _rows(state, done, (), torch.bool)
    state.p_alpha[rows] = state.max_priority ** alpha
    state.idx = (state.idx + n) % capacity
    state.size = min(state.size + n, capacity)
    return state


def gumbel_noise(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U in [tiny, 1), as
    ``jax.random.gumbel`` makes them."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def prioritized_sample(state: PrioritizedReplayState, generator: Optional[torch.Generator], batch_size: int,
                       beta: float, noise: Optional[torch.Tensor] = None) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """Proportional sample, importance weights and indexes
    (experience.py:136-182). Returns ({obs, action, reward, next_obs, done},
    weights, idxes); the weights are normalized so that the lowest-priority
    row has weight 1. ``noise`` [batch_size, capacity] replaces the Gumbel
    draws; the empty buffer's uniform indexes come from ``generator``
    (PyTorch's default generator where it is None)."""
    p = state.p_alpha
    device = p.device
    logits = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-30)), torch.full_like(p, -torch.inf))
    if noise is None:
        noise = gumbel_noise(generator, (batch_size, p.shape[0]), device)
    drawn = torch.argmax(noise.to(device) + logits, dim=-1)
    total = p.sum()
    any_mass = total > 0
    uniform = torch.randint(0, max(state.size, 1), (batch_size,), generator=generator, device=device)
    idxes = torch.where(any_mass, drawn, uniform)
    size_f = float(max(state.size, 1))
    p_total = torch.clamp(total, min=1e-30)
    p_sample = torch.clamp(p[idxes], min=1e-30) / p_total
    p_min = torch.min(torch.where(p > 0, p, torch.full_like(p, torch.inf))) / p_total
    max_weight = (p_min * size_f) ** (-beta)
    weights = torch.where(any_mass, (p_sample * size_f) ** (-beta) / max_weight, torch.ones_like(p_sample))
    batch = {"obs": state.obses[idxes], "action": state.actions[idxes], "reward": state.rewards[idxes],
             "next_obs": state.next_obses[idxes], "done": state.dones[idxes]}
    return batch, weights, idxes


def prioritized_update(state: PrioritizedReplayState, idxes, priorities, alpha: float = 0.6) -> PrioritizedReplayState:
    """Scatter new (TD-error) priorities, floored at 1e-6, and raise the
    watermark (experience.py:184-205)."""
    device = state.p_alpha.device
    priorities = torch.clamp(torch.as_tensor(priorities, dtype=torch.float32, device=device), min=1e-6)
    state.p_alpha[torch.as_tensor(idxes, device=device)] = priorities ** alpha
    state.max_priority = torch.maximum(state.max_priority, priorities.max())
    return state
