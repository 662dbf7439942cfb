"""SAC networks: the tanh-squashed diagonal-Gaussian actor and the twin Q critic.

Port of rl_games_tpu/models/sac.py (the reference's SACBuilder,
network_builder.py:919-1081):

* ``SACActor`` (DiagGaussianActor, :919-944): an MLP trunk whose last
  Linear is the head of 2A outputs, split into (mu, log_std); log_std is
  squashed by tanh into ``log_std_bounds`` and exponentiated.
* ``SACDoubleCritic`` (DoubleQCritic, :947-969): two independent MLPs on
  [obs, action].

The submodules carry the reference SAC checkpoint's names: ``trunk.{k}``
(the head is the trunk's last Linear; with ``mlp.d2rl`` the D2RL MLP is
``trunk.0`` and the head ``trunk.1``) and ``Q1.{k}`` / ``Q2.{k}``, so an
actor's or critic's ``state_dict`` is the reference's section. With
``network.normalization`` (``layer_norm``, or ``batch_norm``, a LayerNorm
stand-in in both packages) every unit of a plain trunk is Linear, activation,
LayerNorm, at indices 3i, 3i + 1, 3i + 2, and the head follows at 3n; a D2RL
trunk keeps its norms as ``trunk.0.norm_layers.{i}`` (sac.py:84-101,
layers.py:132-195). The JAX package's ``convert_sac_weights`` reads the
plain trunks without norms; it takes a LayerNorm's weight for a Linear's
(ROADMAP.md §3, fault 5). The MLPs are the plain sequential ones, as in the
JAX package, whose SAC never takes the fused kernel. ``ActionRescale`` maps the actor's [-1, 1] actions to the
env's bounds, for the trainer and the player alike.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models import layers as L


def _mlp_with_head(in_features: int, units: Sequence[int], activation, initializer,
                   out_features: int, device, d2rl: bool = False, norm_func_name=None) -> nn.Sequential:
    """Linear→activation[→LayerNorm] per unit, then a Linear head, in one
    Sequential; with ``d2rl`` the D2RL MLP at 0 and the head at 1."""
    mlp = L.build_mlp(in_features, units, activation, initializer, norm_func_name=norm_func_name, d2rl=d2rl,
                      device=device)
    head = L.make_dense(units[-1] if units else in_features, out_features, initializer, device=device)
    return nn.Sequential(mlp, head) if d2rl else nn.Sequential(*mlp, head)


class SACActor(nn.Module):
    """forward(obs) -> (mu, std)."""

    def __init__(self, obs_dim: int, actions_num: int, units: Sequence[int], activation,
                 log_std_bounds: Tuple[float, float] = (-5.0, 2.0), initializer: Optional[dict] = None,
                 device=None, d2rl: bool = False, norm_func_name=None):
        super().__init__()
        self.actions_num = actions_num
        self.log_std_bounds = tuple(float(b) for b in log_std_bounds)
        self.trunk = _mlp_with_head(obs_dim, units, activation, initializer, 2 * actions_num, device, d2rl,
                                    norm_func_name)

    def forward(self, obs):
        mu, log_std = torch.chunk(self.trunk(obs), 2, dim=-1)
        lo, hi = self.log_std_bounds
        log_std = lo + 0.5 * (hi - lo) * (torch.tanh(log_std) + 1.0)
        return mu, torch.exp(log_std)

    @staticmethod
    def sample(mu, std, noise):
        """rsample + tanh squash from standard normals; returns (action in
        [-1, 1], pre_tanh)."""
        return D.squashed_normal_sample(mu, std, noise)

    @staticmethod
    def log_prob(action, mu, std, pre_tanh=None):
        return D.squashed_normal_logp(action, mu, std, pre_tanh)


class SACDoubleCritic(nn.Module):
    """forward(obs, action) -> (q1, q2), each [B, 1]."""

    def __init__(self, obs_dim: int, actions_num: int, units: Sequence[int], activation,
                 initializer: Optional[dict] = None, device=None, d2rl: bool = False, norm_func_name=None):
        super().__init__()
        d = obs_dim + actions_num
        self.Q1 = _mlp_with_head(d, units, activation, initializer, 1, device, d2rl, norm_func_name)
        self.Q2 = _mlp_with_head(d, units, activation, initializer, 1, device, d2rl, norm_func_name)

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return self.Q1(x), self.Q2(x)


def build_sac_networks(net_params: dict, obs_dim: int, actions_num: int, device=None):
    """Map the reference SAC YAML network schema to (actor, critic) modules
    (sac.py:84-102). Their weights are drawn by ``layers.reset_parameters``."""
    mlp = net_params["mlp"]
    common = dict(units=tuple(mlp["units"]), activation=mlp["activation"],
                  initializer=mlp.get("initializer"), device=device, d2rl=bool(mlp.get("d2rl", False)),
                  norm_func_name=net_params.get("normalization"))
    actor = SACActor(obs_dim, actions_num,
                     log_std_bounds=tuple(net_params.get("log_std_bounds", (-5.0, 2.0))), **common)
    return actor, SACDoubleCritic(obs_dim, actions_num, **common)


class ActionRescale:
    """[-1, 1] → the env's action bounds, clamped to them (sac_agent.py:85-98,
    375-379). The bounds are taken one per action dim, also where the env
    gives them as scalars, so ``log_scale_sum`` (the env-space log-prob's
    Σ log action_scale, :381-389) counts every dim."""

    def __init__(self, space, actions_num: int, device=None):
        low = np.broadcast_to(np.asarray(space.low, np.float32), (actions_num,))
        high = np.broadcast_to(np.asarray(space.high, np.float32), (actions_num,))
        scale, bias = (high - low) / 2.0, (high + low) / 2.0
        self.log_scale_sum = float(np.log(np.maximum(scale, 1e-8)).sum())
        self.low, self.high, self.scale, self.bias = (
            torch.as_tensor(np.array(a), dtype=torch.float32, device=device) for a in (low, high, scale, bias)
        )

    def __call__(self, actions):
        return torch.clamp(actions * self.scale + self.bias, self.low, self.high)


def load_normalizer(running_mean_std, state_dict):
    """A SAC checkpoint's ``running_mean_std`` section into the input
    normalizer; a checkpoint with stats for a config without a normalizer
    raises (the JAX importer's check, torch_import.py:683-688)."""
    if running_mean_std is None:
        raise ValueError("the SAC checkpoint carries running_mean_std stats but this config has "
                         "normalize_input: False; the policy would see raw observations")
    running_mean_std.load_state_dict(state_dict)
