"""Running mean/std normalization.

Port of rl_games_tpu/ops/running_stats.py ``rms_*`` (the reference's
running_mean_std.py:20-115). As in the JAX package, and unlike the
reference's float64 buffers, the stats are float32 with an int32 count and
the merge is Chan's parallel form; variances are population variances
(``correction=0``).

The functions are pure over ``(mean, var, count)`` tensors and mirror the
JAX functions one for one. ``RunningMeanStd`` holds the three as buffers
named as in the reference checkpoint layout (``running_mean``,
``running_var``, ``count``) and updates them in place;
``RunningMeanStdObs`` holds one per key of a dict observation (``rms_*_obs``,
:121-131).

``generalized_moving_stats_*`` port the JAX package's exponential moving
stats (:180-279, the reference's moving_mean_std.py:50-126) that
``normalize_rms_advantage`` normalizes the advantages with.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

_EPS = 1e-05


def rms_update(mean, var, count, batch_mean, batch_var, batch_count):
    """Chan et al. parallel moment merge (reference :75-88).

    ``count`` is an int32 tensor; ``batch_count`` a number or tensor.
    Returns the new ``(mean, var, count)``.
    """
    count_f = count.to(torch.float32)
    if torch.is_tensor(batch_count):
        batch_count_f = batch_count.to(torch.float32)
        batch_count_i = batch_count.to(torch.int32)
    else:
        batch_count_f, batch_count_i = float(batch_count), int(batch_count)
    tot = count_f + batch_count_f
    delta = batch_mean - mean
    new_mean = mean + delta * batch_count_f / tot
    m_a = var * count_f
    m_b = batch_var * batch_count_f
    m2 = m_a + m_b + torch.square(delta) * count_f * batch_count_f / tot
    return new_mean, m2 / tot, count + batch_count_i


def _batch_dims(x, stat_ndim: int) -> Tuple[int, ...]:
    """Leading dims of x that are reduced into the stats."""
    return tuple(range(x.dim() - stat_ndim))


def rms_batch_moments(x, stat_ndim: int, mask: Optional[torch.Tensor] = None):
    """(batch_mean, batch_var, batch_count) of one batch, reduced over every
    leading dim (reference running_mean_std.py:89-97). Masked rows (mask has
    the batch dims' shape) do not count."""
    dims = _batch_dims(x, stat_ndim)
    x = x.to(torch.float32)
    if mask is None:
        count = 1
        for d in dims:
            count *= x.shape[d]
        return x.mean(dim=dims), x.var(dim=dims, correction=0), count
    m = mask.to(torch.float32)
    m_exp = m.reshape(m.shape + (1,) * stat_ndim)
    total = torch.clamp(m.sum(), min=1.0)
    batch_mean = (x * m_exp).sum(dim=dims) / total
    batch_var = (torch.square(x - batch_mean) * m_exp).sum(dim=dims) / total
    return batch_mean, batch_var, total


def rms_normalize(mean, var, x, *, norm_only: bool = False, clamp: float = 5.0):
    """(x - mean)/sqrt(var+eps), clamped to +-clamp (reference :104-114)."""
    std = torch.sqrt(var + _EPS)
    if norm_only:
        return x / std
    return torch.clamp((x - mean) / std, -clamp, clamp)


def rms_denormalize(mean, var, x, *, clamp: float = 5.0):
    """Denorm mode (reference :104-107): clamp, then y*sqrt(var+eps)+mean."""
    y = torch.clamp(x, -clamp, clamp)
    return torch.sqrt(var + _EPS) * y + mean


class RunningMeanStd(nn.Module):
    """Normalizer state as buffers, in the reference checkpoint layout."""

    def __init__(self, shape: Sequence[int], device=None):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.register_buffer("running_mean", torch.zeros(shape, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(shape, dtype=torch.float32, device=device))
        self.register_buffer("count", torch.ones((), dtype=torch.int32, device=device))

    def reset(self):
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.count.fill_(1)

    @torch.no_grad()
    def update_from_batch(self, x, mask=None):
        """Fold one batch into the stats, in place (the buffers are the
        state; no new tensors outlive the call)."""
        moments = rms_batch_moments(x, self.running_mean.dim(), mask)
        mean, var, count = rms_update(
            self.running_mean, self.running_var, self.count, *moments
        )
        self.running_mean.copy_(mean)
        self.running_var.copy_(var)
        self.count.copy_(count)

    def normalize(self, x, *, norm_only: bool = False, clamp: float = 5.0):
        return rms_normalize(
            self.running_mean, self.running_var, x, norm_only=norm_only, clamp=clamp
        )

    def denormalize(self, x, *, clamp: float = 5.0):
        return rms_denormalize(self.running_mean, self.running_var, x, clamp=clamp)


class RunningMeanStdObs(nn.Module):
    """One ``RunningMeanStd`` per key of a dict observation (``rms_init_obs``,
    ``rms_normalize_obs``, ``rms_update_obs``; the reference's
    RunningMeanStdObs, running_mean_std.py:117-128), in the ModuleDict
    ``running_mean_std``: a model's checkpoint names them
    ``running_mean_std.running_mean_std.<key>.{running_mean,running_var,count}``.
    Update and normalize go over the keys of the observation they are given,
    each key's stats over its own shape; a key of integers is taken as
    float32."""

    def __init__(self, shapes: dict, device=None):
        super().__init__()
        self.running_mean_std = nn.ModuleDict({k: RunningMeanStd(v, device=device) for k, v in shapes.items()})

    def reset(self):
        for rms in self.running_mean_std.values():
            rms.reset()

    @torch.no_grad()
    def update_from_batch(self, obs: dict, mask=None):
        for k, v in obs.items():
            self.running_mean_std[k].update_from_batch(v, mask)

    def normalize(self, obs: dict, *, norm_only: bool = False, clamp: float = 5.0) -> dict:
        return {k: self.running_mean_std[k].normalize(v, norm_only=norm_only, clamp=clamp) for k, v in obs.items()}


# ---------------------------------------------------------------------------
# Generalized moving stats (running_stats.py:180-279)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeneralizedMovingStats:
    low: torch.Tensor  # the mean for the mean_std impls; low / offset otherwise
    high: torch.Tensor  # E[x²] for the mean_std impls; high otherwise
    step: torch.Tensor  # () int32, drives the '_corr' zero-debias


def generalized_moving_stats_init(shape, device=None) -> GeneralizedMovingStats:
    """Zero stats; the step starts at 1 (moving_mean_std.py:25,29,39), so
    after k updates the '_corr' debias is 1 - decay^(k + 1)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    f32 = dict(dtype=torch.float32, device=device)
    return GeneralizedMovingStats(low=torch.zeros(shape, **f32), high=torch.zeros(shape, **f32),
                                  step=torch.ones((), dtype=torch.int32, device=device))


def generalized_moving_stats_update(state: GeneralizedMovingStats, x, impl: str = "mean_std",
                                    decay: float = 0.99, perclo: float = 0.05,
                                    perchi: float = 0.95) -> GeneralizedMovingStats:
    """_update_stats (moving_mean_std.py:107-126): one EMA step of the
    batch's statistics."""
    m = decay
    x = x.to(torch.float32)
    if impl == "off":
        return state
    if impl in ("mean_std", "mean_std_corr"):
        dims = _batch_dims(x, state.low.dim())
        low, high = x.mean(dim=dims), (x * x).mean(dim=dims)
        return GeneralizedMovingStats(low=m * state.low + (1 - m) * low, high=m * state.high + (1 - m) * high,
                                      step=state.step + 1)
    if impl == "min_max":
        low, high = x.min(), x.max()
        return GeneralizedMovingStats(low=m * state.low + (1 - m) * torch.minimum(state.low, low),
                                      high=m * state.high + (1 - m) * torch.maximum(state.high, high),
                                      step=state.step + 1)
    if impl in ("perc_ema", "perc_ema_corr"):
        flat = x.reshape(-1)
        low, high = torch.quantile(flat, perclo), torch.quantile(flat, perchi)
        return GeneralizedMovingStats(low=m * state.low + (1 - m) * low, high=m * state.high + (1 - m) * high,
                                      step=state.step + 1)
    raise NotImplementedError(impl)


def generalized_moving_stats_get(state: GeneralizedMovingStats, impl: str = "mean_std", decay: float = 0.99,
                                 max_scale: float = 1e5, eps: float = 0.0):
    """_get_stats (moving_mean_std.py:50-79): (offset, invscale)."""
    if impl == "off":
        return 0.0, 1.0
    corr = None
    if impl.endswith("_corr"):
        corr = torch.clamp(1.0 - decay ** state.step.to(torch.float32), min=1e-8)
    if impl in ("mean_std", "mean_std_corr"):
        mean, sqrs = (state.low, state.high) if corr is None else (state.low / corr, state.high / corr)
        var = sqrs - torch.square(mean)
        return mean, torch.sqrt(torch.clamp(var, min=1.0 / max_scale ** 2) + eps)
    if impl in ("min_max", "perc_ema", "perc_ema_corr"):
        lo, hi = (state.low, state.high) if corr is None else (state.low / corr, state.high / corr)
        return lo, torch.clamp(hi - lo, min=1.0 / max_scale)
    raise NotImplementedError(impl)


def generalized_moving_stats_normalize(state: GeneralizedMovingStats, x, impl: str = "mean_std",
                                       decay: float = 0.99, denorm: bool = False):
    """(x - offset) / invscale clamped to ±5, or with ``denorm`` its inverse."""
    offset, invscale = generalized_moving_stats_get(state, impl, decay)
    if denorm:
        return x * invscale + offset
    return torch.clamp((x - offset) / invscale, -5.0, 5.0)
