"""Policy distributions: the diagonal Gaussian, the categorical, SAC's
tanh-squashed normal, the Brax-style NormalTanh policy, the two-hot value
distribution and the straight-through one-hot categorical.

Port of rl_games_tpu/models/distributions.py (the reference's
models.py:227-230,345-348,486-562, distributions.py:27-93 and
sac_helper.py). The categorical functions take an optional action mask, as
the JAX ones do. The samplers take their random numbers as tensors
(``gumbel_max`` and ``OneHotDist.sample`` their uniforms,
``squashed_normal_sample`` and ``NormalTanhDistribution`` their standard
normals), so that a test can hand them the JAX package's draws.
"""

import math

import torch
import torch.nn.functional as F

from rl_games_tpu_torch.parallel.mesh import draw_rows

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
    """mean + std * N(0, 1) noise drawn from ``generator`` (a data-parallel
    rank's: its rows of the world's draw, parallel/mesh.py)."""
    noise = draw_rows(torch.randn, mean.shape, generator, device=mean.device, dtype=mean.dtype)
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
    """One action per row, drawn by Gumbel-max from ``generator`` (a
    data-parallel rank's: its rows of the world's draw)."""
    u = draw_rows(torch.rand, logits.shape, generator, device=logits.device, dtype=logits.dtype)
    return gumbel_max(logits, u, mask)


# ---------------------------------------------------------------------------
# Tanh-squashed Gaussian, SAC's policy (distributions.py:113-139; the
# reference's sac_helper.py TanhTransform)
# ---------------------------------------------------------------------------


def _atanh(x):
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def squashed_normal_sample(mu, std, noise):
    """rsample + tanh from standard normals ``noise``; returns (action,
    pre_tanh)."""
    pre = mu + std * noise
    return torch.tanh(pre), pre


def squashed_normal_logp(action, mu, std, pre_tanh=None, eps: float = 1e-6):
    """log pi(a) with the tanh change of variables, summed over the action
    dim. log|det J| = sum log(1 - tanh(u)^2), in the stable softplus form
    2 (log 2 - u - softplus(-2u)) that torch's TanhTransform uses."""
    if pre_tanh is None:
        pre_tanh = _atanh(torch.clamp(action, -1.0 + eps, 1.0 - eps))
    base = -(0.5 * torch.square((pre_tanh - mu) / std) + 0.5 * _LOG_2PI + torch.log(std))
    log_det = 2.0 * (math.log(2.0) - pre_tanh - F.softplus(-2.0 * pre_tanh))
    return (base - log_det).sum(dim=-1)


# ---------------------------------------------------------------------------
# NormalTanhDistribution, the Brax-style policy of continuous_a2c_tanh
# (distributions.py:146-170; the reference's models.py:486-562)
# ---------------------------------------------------------------------------


class NormalTanhDistribution:
    """A softplus-scaled std and a tanh bijector. ``sample`` and
    ``entropy`` take standard normals of ``loc``'s shape."""

    def __init__(self, loc, scale_raw, min_std: float = 0.001, var_scale: float = 1.0):
        self.loc = loc
        self.scale = (F.softplus(scale_raw) + min_std) * var_scale

    def sample(self, noise):
        """(action in [-1, 1], pre_tanh) from standard normals ``noise``."""
        pre = self.loc + self.scale * noise
        return torch.tanh(pre), pre

    def mode(self):
        return torch.tanh(self.loc)

    def log_prob(self, action, pre_tanh=None):
        return squashed_normal_logp(action, self.loc, self.scale, pre_tanh)

    def entropy(self, noise):
        """The entropy estimated from one sample, with the log-det
        correction (models.py:544-556), from standard normals ``noise``."""
        base_entropy = 0.5 + 0.5 * _LOG_2PI + torch.log(self.scale)
        pre = self.loc + self.scale * noise
        log_det = 2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))
        return (base_entropy + log_det).sum(dim=-1)


# ---------------------------------------------------------------------------
# Two-hot / symlog, the value targets of the two-hot value head
# (distributions.py:177-230; the reference's distributions.py:62-93)
# ---------------------------------------------------------------------------


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def twohot_encode(x, bins):
    """Scalars ``x`` as two-hot weight vectors over the sorted 1-D ``bins``:
    the mass splits between the two bins around each value."""
    x = torch.clamp(x, bins[0], bins[-1])
    idx_hi = torch.clamp(torch.searchsorted(bins, x.contiguous()), 1, len(bins) - 1)
    idx_lo = idx_hi - 1
    lo, hi = bins[idx_lo], bins[idx_hi]
    w_hi = (x - lo) / torch.clamp(hi - lo, min=1e-8)
    w_lo = 1.0 - w_hi
    n = len(bins)
    return F.one_hot(idx_lo, n).to(x.dtype) * w_lo[..., None] + F.one_hot(idx_hi, n).to(x.dtype) * w_hi[..., None]


def twohot_decode(logits, bins):
    """The expected bin under softmax(logits)."""
    return (torch.softmax(logits, dim=-1) * bins).sum(dim=-1)


def twohot_bins(device=None):
    """The reference TwoHotDist's fixed grid (distributions.py:72): 255 bins
    over [-20, 20] in symlog space. torch's float32 linspace rounds some
    interior bins one ulp away from jnp.linspace's (at most 1.9e-6)."""
    return torch.linspace(-20.0, 20.0, 255, device=device)


TWOHOT_BINS = twohot_bins()


def twohot_log_prob(logits, targets, bins=None):
    """TwoHotDist.log_prob (distributions.py:80-93): the log-prob of scalar
    ``targets`` interpolated between their two bins. As in the reference,
    the width is (hi - lo) / len(bins), not the bins' spacing, the position
    truncates toward zero and only the lower bin is clipped, to
    [0, len(bins) - 2]."""
    n = 255 if bins is None else len(bins)
    first, last = (-20.0, 20.0) if bins is None else (bins[0], bins[-1])
    width = (last - first) / n
    x = (targets - first) / width
    lo = torch.clamp(x.to(torch.int32), 0, n - 2).long()
    hi = lo + 1
    w_lo = torch.abs(x - hi)
    w_hi = torch.abs(x - lo)
    logp = torch.log_softmax(logits, dim=-1)
    lo_lp = torch.gather(logp, -1, lo[..., None])[..., 0]
    hi_lp = torch.gather(logp, -1, hi[..., None])[..., 0]
    return w_lo * lo_lp + w_hi * hi_lp


class OneHotDist:
    """Straight-through one-hot categorical (distributions.py:233-265; the
    reference's OneHotDist, distributions.py:47-58): a sample's gradient
    flows through the softmax probabilities, the mode's through the raw
    logits (the reference's ``_mode.detach() + logits - logits.detach()``),
    not the softmax."""

    def __init__(self, logits, unimix_ratio: float = 0.0):
        if unimix_ratio > 0.0:
            probs = torch.softmax(logits, dim=-1)
            probs = probs * (1.0 - unimix_ratio) + unimix_ratio / probs.shape[-1]
            logits = torch.log(probs)
        self.logits = logits

    def _straight_through(self, hard):
        probs = torch.softmax(self.logits, dim=-1)
        return (hard - probs).detach() + probs

    def mode(self):
        hard = F.one_hot(torch.argmax(self.logits, dim=-1), self.logits.shape[-1]).to(self.logits.dtype)
        return (hard - self.logits).detach() + self.logits

    def sample(self, uniform):
        """A one-hot draw by Gumbel-max from uniforms in (0, 1) of the
        logits' shape (``jax.random.categorical``'s sampler)."""
        hard = F.one_hot(gumbel_max(self.logits, uniform), self.logits.shape[-1]).to(self.logits.dtype)
        return self._straight_through(hard)

    def log_prob(self, one_hot):
        return (torch.log_softmax(self.logits, dim=-1) * one_hot).sum(dim=-1)
