"""Policy distributions: the diagonal Gaussian and the categorical.

Port of the normal and categorical parts of
rl_games_tpu/models/distributions.py (the reference's
models.py:227-230,345-348 and distributions.py:27-44). The categorical
functions take an optional action mask, as the JAX ones do.
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


# ---------------------------------------------------------------------------
# Categorical (distributions.py:77-110), with an optional action mask
# ---------------------------------------------------------------------------

_MASK_FILL = -1e8  # the reference's fill for masked-out logits


def masked_logits(logits, mask=None):
    """Masked-out actions get a large negative logit (distributions.py:27-31)."""
    if mask is None:
        return logits
    return torch.where(mask.to(torch.bool), logits, torch.full_like(logits, _MASK_FILL))


def categorical_log_probs(logits, mask=None):
    return torch.log_softmax(masked_logits(logits, mask), dim=-1)


def categorical_neglogp(logits, actions, mask=None):
    logp = categorical_log_probs(logits, mask)
    return -torch.gather(logp, -1, actions.long()[..., None]).squeeze(-1)


def categorical_entropy(logits, mask=None):
    """Entropy; masked actions contribute zero (distributions.py:33-44)."""
    logp = categorical_log_probs(logits, mask)
    p_logp = torch.exp(logp) * logp
    if mask is not None:
        p_logp = torch.where(mask.to(torch.bool), p_logp, torch.zeros_like(p_logp))
    return -p_logp.sum(dim=-1)


def gumbel_max(logits, uniform, mask=None):
    """argmax(logits + Gumbel noise) with the noise -log(-log(u)) made from
    uniforms in (0, 1): the sampler of ``jax.random.categorical``, so a
    test can hand both the same draws."""
    tiny = torch.finfo(uniform.dtype).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(uniform, min=tiny)))
    return torch.argmax(masked_logits(logits, mask) + gumbel, dim=-1)


def categorical_sample(logits, generator=None, mask=None):
    """One action per row, drawn by Gumbel-max from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=logits.dtype)
    return gumbel_max(logits, u, mask)
