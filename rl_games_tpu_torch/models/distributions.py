"""Diagonal-Gaussian policy distribution.

Port of the normal part of rl_games_tpu/models/distributions.py (the
reference's models.py:227-230,345-348).
"""

import math

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)


def normal_neglogp(x, mean, std, logstd):
    """Exact reference formula (models.py:345-348), summed over action dim."""
    return (
        0.5 * torch.square((x - mean) / std).sum(dim=-1)
        + 0.5 * _LOG_2PI * x.shape[-1]
        + logstd.sum(dim=-1)
    )


def normal_entropy(logstd):
    """Gaussian entropy summed over action dim (models.py:227)."""
    return (0.5 + 0.5 * _LOG_2PI + logstd).sum(dim=-1)


def normal_sample(mean, std, generator=None):
    """mean + std * N(0, 1) noise drawn from ``generator``."""
    noise = torch.randn(
        mean.shape, generator=generator, device=mean.device, dtype=mean.dtype
    )
    return mean + std * noise


def apply_sigma_parametrization(raw, *, parametrization: str = "exp",
                                min_sigma: float = 0.0, logstd_bounds=None):
    """Map the sigma head's raw output to (sigma, logstd) (models.py:266-286):
    'exp' (optionally clamped / floored) or 'softplus' (+ floor); logstd is
    recomputed from the final sigma so log-probs stay consistent."""
    if parametrization == "softplus":
        sigma = F.softplus(raw) + min_sigma
        return sigma, torch.log(sigma)
    if logstd_bounds is not None:
        raw = torch.clamp(raw, logstd_bounds[0], logstd_bounds[1])
    sigma = torch.exp(raw)
    if min_sigma > 0:
        sigma = sigma + min_sigma
        return sigma, torch.log(sigma)
    return sigma, raw
