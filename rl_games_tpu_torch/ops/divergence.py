"""KL divergences for adaptive-LR scheduling.

Port of rl_games_tpu/ops/divergence.py (the reference's divergence.py).
"""

import torch


def d_kl_discrete(p_logits, q_logits):
    """Categorical KL(p||q) from log-probabilities (divergence.py:6-13)."""
    return (torch.exp(p_logits) * (p_logits - q_logits)).sum(-1)


def d_kl_normal(p, q):
    """Diagonal-Gaussian KL(p||q); p/q = (mean, sigma) (divergence.py:22-29)."""
    p_mean, p_sigma = p
    q_mean, q_sigma = q
    mean_diff = torch.square((q_mean - p_mean) / q_sigma)
    var_ratio = torch.square(p_sigma / q_sigma)
    d_kl = 0.5 * (var_ratio + mean_diff - 1.0 - torch.log(var_ratio))
    return d_kl.sum(-1)
