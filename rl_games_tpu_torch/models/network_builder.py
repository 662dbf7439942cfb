"""Config-driven actor-critic torso.

Port of rl_games_tpu/models/network_builder.py ``A2CNetwork`` (:41-323) for
its flat-observation continuous branch: a shared MLP trunk, a linear value
head, a mu head and a fixed (state-independent) sigma parameter. The
reference YAML ``network:`` schema is read as in the JAX package; the
branches not ported yet (RNN, CNN, separate critic, discrete heads, central
value, two-hot value head, state-dependent sigma) raise
NotImplementedError.

Submodules carry the reference checkpoint names (``actor_mlp``, ``mu``,
``sigma``, ``value``).
"""

from typing import Sequence

import torch
from torch import nn

from rl_games_tpu_torch.models import layers as L


def _unsupported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to rl_games_tpu_torch yet (see ROADMAP.md)"
    )


class A2CNetwork(nn.Module):
    """forward(obs) -> {'mu', 'sigma_raw', 'value'}.

    'sigma_raw' is the sigma parameter after sigma_activation, broadcast to
    mu's shape; the model applies the sigma parametrization to it.
    """

    def __init__(self, params: dict, actions_num: int, input_shape: Sequence[int],
                 value_size: int = 1, device=None):
        super().__init__()
        cfg = params
        for key in ("rnn", "cnn"):
            if key in cfg:
                _unsupported(f"network.{key}")
        if cfg.get("separate", False):
            _unsupported("network.separate: True")
        if cfg.get("central_value", False):
            _unsupported("a central value network")
        space = cfg.get("space", {})
        if "continuous" not in space:
            _unsupported(f"the action space {sorted(space)}")
        space_cfg = space["continuous"] or {}
        if not space_cfg.get("fixed_sigma", True):
            _unsupported("a state-dependent sigma head (fixed_sigma: False)")
        if cfg.get("value_head", cfg.get("value_type", "legacy")) not in ("legacy", "default"):
            _unsupported("the two-hot value head")
        if len(input_shape) != 1:
            _unsupported(f"observation shape {tuple(input_shape)}")

        mlp_cfg = cfg["mlp"]
        units = list(mlp_cfg["units"])
        self.actor_mlp = L.build_mlp(
            int(input_shape[0]), units, mlp_cfg["activation"],
            initializer=mlp_cfg.get("initializer"),
            norm_func_name=cfg.get("normalization", None),
            d2rl=mlp_cfg.get("d2rl", False),
            norm_only_first_layer=mlp_cfg.get("norm_only_first_layer", False),
            fused=mlp_cfg.get("fused", False),
            device=device,
        )
        out_size = units[-1] if units else int(input_shape[0])
        self.value = L.make_dense(out_size, value_size, mlp_cfg.get("initializer"), device)
        self.value_act = L.get_activation(cfg.get("value_activation", "None"))
        self.mu = L.make_dense(out_size, actions_num, space_cfg.get("mu_init"), device)
        self.mu_act = L.get_activation(space_cfg.get("mu_activation", "None"))
        self.sigma_act = L.get_activation(space_cfg.get("sigma_activation", "None"))
        sigma_init = space_cfg.get("sigma_init", {})
        self.sigma_init_val = float(sigma_init.get("val", sigma_init.get("value", 0.0)))
        self.sigma = nn.Parameter(
            torch.full((actions_num,), self.sigma_init_val, dtype=torch.float32, device=device)
        )

    def reset_parameters(self, generator=None):
        L.reset_parameters(self, generator)
        with torch.no_grad():
            self.sigma.fill_(self.sigma_init_val)

    def forward(self, obs):
        out = self.actor_mlp(obs)
        value = self.value_act(self.value(out))
        mu = self.mu_act(self.mu(out))
        # mu * 0.0 broadcasts sigma to mu's shape, as the JAX torso does
        sigma_raw = self.sigma_act(self.sigma) + mu * 0.0
        return {"mu": mu, "sigma_raw": sigma_raw, "value": value}
