"""PPO loss functions on tensors.

Port of rl_games_tpu/ops/losses.py (the reference's common_losses.py and the
loss assembly of a2c_continuous.py:97-133,238-253).
"""

import math

import torch


def critic_loss(value_preds, values, e_clip: float, returns, clip_value: bool):
    """Clipped value loss (common_losses.py:7-29). Returns per-element loss."""
    if clip_value:
        delta = values - value_preds
        value_pred_clipped = value_preds + torch.clamp(delta, -e_clip, e_clip)
        value_losses = torch.square(values - returns)
        value_losses_clipped = torch.square(value_pred_clipped - returns)
        return torch.maximum(value_losses, value_losses_clipped)
    return torch.square(returns - values)


def smooth_clamp(x, mi: float, mx: float):
    """Sigmoid-smoothed clamp (common_losses.py:32-38)."""
    return 1.0 / (1.0 + torch.exp((-(x - mi) / (mx - mi) + 0.5) * 4.0)) * (mx - mi) + mi


def actor_loss(old_neglogp, neglogp, advantage, is_ppo: bool, e_clip: float):
    """PPO clipped surrogate (common_losses.py:64-82). Per-element loss."""
    if is_ppo:
        ratio = torch.exp(old_neglogp - neglogp)
        surr1 = advantage * ratio
        surr2 = advantage * torch.clamp(ratio, 1.0 - e_clip, 1.0 + e_clip)
        return torch.maximum(-surr1, -surr2)
    return neglogp * advantage


def smoothed_actor_loss(old_neglogp, neglogp, advantage, is_ppo: bool, e_clip: float):
    """Smooth-clamp surrogate variant (common_losses.py:41-61)."""
    if is_ppo:
        ratio = torch.exp(old_neglogp - neglogp)
        surr1 = advantage * ratio
        surr2 = advantage * smooth_clamp(ratio, 1.0 - e_clip, 1.0 + e_clip)
        return torch.maximum(-surr1, -surr2)
    return neglogp * advantage


def decoupled_actor_loss(behavior_neglogp, neglogp, proxy_neglogp, advantage,
                         e_clip: float):
    """Decoupled (proxy) PPO actor loss (common_losses.py:85-109)."""
    logratio = proxy_neglogp - neglogp
    pg1 = -advantage * torch.exp(behavior_neglogp - neglogp)
    clipped_logratio = torch.clamp(
        logratio, math.log(1.0 - e_clip), math.log(1.0 + e_clip)
    )
    pg2 = -advantage * torch.exp(clipped_logratio - proxy_neglogp + behavior_neglogp)
    return torch.maximum(pg1, pg2)


def bound_loss(mu, soft_bound: float = 1.1):
    """Action-bounds penalty on the raw mu (a2c_continuous.py:244-253):
    per-element squared excess beyond +-soft_bound, summed over actions."""
    mu_loss_high = torch.square(torch.clamp(mu - soft_bound, min=0.0))
    mu_loss_low = torch.square(torch.clamp(mu + soft_bound, max=0.0))
    return (mu_loss_high + mu_loss_low).sum(dim=-1)


def reg_loss(mu):
    """L2 regularization on mu (a2c_continuous.py:238-242)."""
    return torch.square(mu).sum(dim=-1)


def normalize_advantage(advantage):
    """(adv - mean) / (std + 1e-8) (common_losses.py:112-118), with the
    unbiased (ddof=1) std as torch's ``.std()`` gives it."""
    mean = advantage.mean()
    n = advantage.numel()
    std = torch.sqrt(advantage.var(correction=0) * n / max(n - 1, 1)) + 1e-8
    return (advantage - mean) / std


def ppo_total_loss(a_loss, c_loss, entropy, b_loss, critic_coef, entropy_coef,
                   bounds_loss_coef):
    """Scalar loss assembly (a2c_continuous.py:97-133):
    a + 0.5*critic_coef*c - entropy_coef*entropy + bounds_loss_coef*b."""
    return (
        a_loss
        + 0.5 * critic_coef * c_loss
        - entropy_coef * entropy
        + bounds_loss_coef * b_loss
    )
