"""Masked statistics and diagnostics.

Port of rl_games_tpu/ops/masked.py (the reference's torch_ext.py:157-220).
Variances here are population variances, as ``jnp.var`` computes them, so
every ``var`` call passes ``correction=0``.
"""

from typing import Optional

import torch


def masked_mean(x, mask):
    """Sum(x*mask)/sum(mask) (torch_ext.py:178-181)."""
    m = mask.to(torch.float32)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_mean_var(x, mask):
    """Per-feature masked mean and (biased) variance (torch_ext.py:178-188)."""
    m = mask.to(torch.float32)
    m_exp = m.reshape(m.shape + (1,) * (x.dim() - m.dim()))
    total = torch.clamp(m.sum(), min=1.0)
    mean = (x * m_exp).sum(dim=0) / total
    var = (torch.square(x - mean) * m_exp).sum(dim=0) / total
    return mean, var


def apply_masks(losses, mask: Optional[torch.Tensor] = None):
    """Mean each per-element loss under an optional mask (torch_ext.py:157-166)."""
    if mask is not None:
        m = mask.to(torch.float32)
        total = torch.clamp(m.sum(), min=1.0)
        return [(l * m).sum() / total for l in losses]
    return [l.mean() for l in losses]


def explained_variance(y_pred, y_true, mask: Optional[torch.Tensor] = None):
    """1 - Var[y-ypred]/Var[y] (torch_ext.py:190-208)."""
    if mask is not None:
        m = mask.to(torch.float32)
        total = torch.clamp(m.sum(), min=1.0)
        my = (y_true * m).sum() / total
        var_y = (torch.square(y_true - my) * m).sum() / total
        diff = y_true - y_pred
        md = (diff * m).sum() / total
        var_d = (torch.square(diff - md) * m).sum() / total
    else:
        var_y = y_true.var(correction=0)
        var_d = (y_true - y_pred).var(correction=0)
    return 1.0 - var_d / torch.clamp(var_y, min=1e-8)


def policy_clip_fraction(new_neglogp, old_neglogp, e_clip, mask=None):
    """Fraction of ratios clipped (torch_ext.py:210-220)."""
    ratio = torch.exp(old_neglogp - new_neglogp)
    clipped = (torch.abs(ratio - 1.0) > e_clip).to(torch.float32)
    if mask is not None:
        return masked_mean(clipped, mask)
    return clipped.mean()
