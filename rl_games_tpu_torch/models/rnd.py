"""Random Network Distillation curiosity.

Port of rl_games_tpu/models/rnd.py: the ``rnd_config.network`` schema of
the reference's configs (configs/smac/v1/3m_torch_sparse.yaml:58-78) as a
frozen, randomly drawn target MLP (``mlp.rnd.units``, the last entry the
embedding size; every layer Dense → activation) and a trained predictor
(``mlp.net.units`` hidden layers and a linear head to the embedding). The
per-observation mean squared prediction error is the intrinsic reward the
PPO epoch adds to the shaped reward before GAE, and, averaged, the
predictor's loss (algos/ppo.py ``_update_rnd``). The module also holds
RND's own observation normalizer (``running_mean_std``).

Submodules: ``target`` (a Sequential of [Linear, activation] per unit),
``predictor`` (the hidden MLP at ``predictor.0``, the head at
``predictor.1``) and ``running_mean_std``.
"""

import torch
from torch import nn

from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.ops.running_stats import RunningMeanStd


class RNDCuriosity(nn.Module):
    """Target and predictor over ``obs_dim`` flat observations."""

    def __init__(self, network_cfg: dict, obs_dim: int, device=None):
        super().__init__()
        mlp = network_cfg["mlp"]
        rnd_units = list(mlp["rnd"]["units"])
        if not rnd_units:
            raise ValueError("rnd_config.network.mlp.rnd.units is empty")
        activation = mlp.get("activation", "elu")
        initializer = mlp.get("initializer")
        self.target = L.build_mlp(obs_dim, rnd_units, activation, initializer=initializer, device=device)
        net_units = list(mlp["net"]["units"])
        self.predictor = nn.Sequential(
            L.build_mlp(obs_dim, net_units, activation, initializer=initializer, device=device),
            L.make_dense(net_units[-1] if net_units else obs_dim, rnd_units[-1], initializer, device),
        )
        self.running_mean_std = RunningMeanStd((obs_dim,), device=device)
        for p in self.target.parameters():
            p.requires_grad_(False)

    def reset_parameters(self, generator=None):
        L.reset_parameters(self, generator)
        self.running_mean_std.reset()

    def intrinsic(self, obs_n):
        """Per-row mean squared prediction error [B] of normalized
        observations (no gradient reaches the target)."""
        with torch.no_grad():
            t = self.target(obs_n)
        return torch.mean(torch.square(self.predictor(obs_n) - t), dim=-1)

    def loss(self, obs_n):
        return torch.mean(self.intrinsic(obs_n))
