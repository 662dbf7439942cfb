"""Config-driven actor-critic torso.

Port of rl_games_tpu/models/network_builder.py ``A2CNetwork`` (:41-323)
for a shared trunk: an optional conv stack (``cnn``, NHWC observations
permuted to NCHW as the reference torch builder's ``permute_input`` does,
and flattened in NCHW order, the reference checkpoint's), an MLP, a linear
value head, and either a continuous head (a mu head and a fixed,
state-independent sigma parameter) or a discrete one (``logits``). The
reference YAML ``network:`` schema is read as in the JAX package; the
branches not ported yet (RNN, impala, separate critic, multi-discrete
heads, central value, two-hot value head, state-dependent sigma) raise
NotImplementedError naming their ROADMAP.md item.

Submodules carry the reference checkpoint names (``actor_cnn``,
``actor_mlp``, ``mu``, ``sigma``, ``logits``, ``value``).
"""

from typing import Sequence

import torch
from torch import nn

from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.utils.unported import unported


class A2CNetwork(nn.Module):
    """forward(obs) -> {'mu', 'sigma_raw', 'value'} (continuous) or
    {'logits', 'value'} (discrete).

    'sigma_raw' is the sigma parameter after sigma_activation, broadcast to
    mu's shape; the model applies the sigma parametrization to it.
    """

    def __init__(self, params: dict, actions_num: int, input_shape: Sequence[int],
                 value_size: int = 1, device=None):
        super().__init__()
        cfg = params
        if "rnn" in cfg:
            unported("network.rnn", "A9")
        if cfg.get("separate", False):
            unported("network.separate: True", "A8")
        if cfg.get("central_value", False):
            unported("a central value network", "A9")
        space = cfg.get("space", {})
        if "continuous" in space:
            self.discrete = False
            space_cfg = space["continuous"] or {}
            if not space_cfg.get("fixed_sigma", True):
                unported("a state-dependent sigma head (fixed_sigma: False)", "A8")
        elif "discrete" in space:
            self.discrete = True
        else:
            unported(f"the action space {sorted(space)}", "A8")
        if cfg.get("value_head", cfg.get("value_type", "legacy")) not in ("legacy", "default"):
            unported("the two-hot value head", "A8")

        cnn_cfg = cfg.get("cnn")
        if cnn_cfg is not None:
            if cnn_cfg.get("type") == "impala":
                unported("the impala conv tower (cnn.type: impala)", "A8")
            conv1d = cnn_cfg.get("type") == "conv1d"
            if len(input_shape) != (2 if conv1d else 3):
                raise ValueError(f"a {cnn_cfg.get('type', 'conv2d')} torso takes channels-last "
                                 f"observations, not shape {tuple(input_shape)}")
            self.actor_cnn = L.CNN(
                int(input_shape[-1]), cnn_cfg["convs"], cnn_cfg["activation"],
                initializer=cnn_cfg.get("initializer"),
                norm_func_name=cfg.get("normalization", None),
                ctype=cnn_cfg.get("type", "conv2d"), device=device,
            )
            in_features = self.actor_cnn.output_size(input_shape[:-1])
        else:
            self.actor_cnn = None
            if len(input_shape) != 1:
                unported(f"observation shape {tuple(input_shape)} without a cnn", "A8")
            in_features = int(input_shape[0])

        mlp_cfg = cfg["mlp"]
        units = list(mlp_cfg["units"])
        self.actor_mlp = L.build_mlp(
            in_features, units, mlp_cfg["activation"],
            initializer=mlp_cfg.get("initializer"),
            norm_func_name=cfg.get("normalization", None),
            d2rl=mlp_cfg.get("d2rl", False),
            norm_only_first_layer=mlp_cfg.get("norm_only_first_layer", False),
            fused=mlp_cfg.get("fused", False),
            device=device,
        )
        out_size = units[-1] if units else in_features
        self.value = L.make_dense(out_size, value_size, mlp_cfg.get("initializer"), device)
        self.value_act = L.get_activation(cfg.get("value_activation", "None"))
        if self.discrete:
            self.logits = L.make_dense(out_size, actions_num, mlp_cfg.get("initializer"), device)
            return
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
        if not self.discrete:
            with torch.no_grad():
                self.sigma.fill_(self.sigma_init_val)

    def forward(self, obs):
        x = obs
        if self.actor_cnn is not None:
            # channels-last observations to channels-first (permute_input),
            # flattened in (c, h, w) order
            x = self.actor_cnn(x.movedim(-1, 1)).flatten(1)
        out = self.actor_mlp(x)
        value = self.value_act(self.value(out))
        if self.discrete:
            return {"logits": self.logits(out), "value": value}
        mu = self.mu_act(self.mu(out))
        # mu * 0.0 broadcasts sigma to mu's shape, as the JAX torso does
        sigma_raw = self.sigma_act(self.sigma) + mu * 0.0
        return {"mu": mu, "sigma_raw": sigma_raw, "value": value}
