"""Config-driven actor-critic torso.

Port of rl_games_tpu/models/network_builder.py ``A2CNetwork`` (:41-323):
one trunk, or with ``separate: True`` an actor trunk and a critic trunk
that the value head reads (:216-229); each trunk an optional conv stack
(``cnn``, NHWC observations permuted to NCHW as the reference torch
builder's ``permute_input`` does, and flattened in NCHW order, the
reference checkpoint's) and an MLP (plain, fused or D2RL); a linear value
head of ``value_size`` outputs; and a continuous head (mu, and sigma either
a fixed, state-independent parameter or a Linear of the actor's features),
a discrete one (``logits``) or a multi-discrete one (a ``logits`` Linear per
action head). The reference YAML ``network:`` schema is read as in the JAX
package; the branches not ported yet (RNN, impala, central value, two-hot
value head) raise NotImplementedError naming their ROADMAP.md item.

Submodules carry the reference checkpoint names (``actor_cnn``,
``actor_mlp``, ``critic_cnn``, ``critic_mlp``, ``mu``, ``sigma``,
``logits`` or ``logits.{i}``, ``value``).
"""

from typing import Sequence

import torch
from torch import nn

from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.utils.unported import unported


def action_space_of(cfg: dict):
    """(kind, its config): 'continuous', 'multi_discrete' or 'discrete'
    (network_builder.py:74-82)."""
    space = cfg.get("space", {})
    for kind in ("continuous", "multi_discrete", "discrete"):
        if kind in space:
            return kind, space[kind] or {}
    unported(f"a network without an action space ({sorted(space)}: a central value net)", "A9")


class A2CNetwork(nn.Module):
    """forward(obs) -> {'mu', 'sigma_raw', 'value'} (continuous),
    {'logits', 'value'} (discrete) or {'logits': tuple, 'value'}
    (multi-discrete).

    'sigma_raw' is the sigma parameter or head after sigma_activation,
    broadcast to mu's shape; the model applies the sigma parametrization to
    it.
    """

    def __init__(self, params: dict, actions_num, input_shape: Sequence[int],
                 value_size: int = 1, device=None):
        super().__init__()
        cfg = params
        if "rnn" in cfg:
            unported("network.rnn", "A9")
        if cfg.get("central_value", False):
            unported("a central value network", "A9")
        self.space, space_cfg = action_space_of(cfg)
        self.discrete = self.space != "continuous"
        self.separate = bool(cfg.get("separate", False))
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
        elif len(input_shape) != 1:
            unported(f"observation shape {tuple(input_shape)} without a cnn", "A8")

        mlp_cfg = cfg["mlp"]
        units = list(mlp_cfg["units"])
        for prefix in ("actor_", "critic_") if self.separate else ("actor_",):
            in_features = int(input_shape[0])
            cnn = None
            if cnn_cfg is not None:
                cnn = L.CNN(
                    int(input_shape[-1]), cnn_cfg["convs"], cnn_cfg["activation"],
                    initializer=cnn_cfg.get("initializer"),
                    norm_func_name=cfg.get("normalization", None),
                    ctype=cnn_cfg.get("type", "conv2d"), device=device,
                )
                in_features = cnn.output_size(input_shape[:-1])
            setattr(self, prefix + "cnn", cnn)
            setattr(self, prefix + "mlp", L.build_mlp(
                in_features, units, mlp_cfg["activation"],
                initializer=mlp_cfg.get("initializer"),
                norm_func_name=cfg.get("normalization", None),
                d2rl=mlp_cfg.get("d2rl", False),
                norm_only_first_layer=mlp_cfg.get("norm_only_first_layer", False),
                fused=mlp_cfg.get("fused", False),
                device=device,
            ))
        out_size = units[-1] if units else in_features
        self.value = L.make_dense(out_size, value_size, mlp_cfg.get("initializer"), device)
        self.value_act = L.get_activation(cfg.get("value_activation", "None"))
        if self.space == "discrete":
            self.logits = L.make_dense(out_size, actions_num, mlp_cfg.get("initializer"), device)
            return
        if self.space == "multi_discrete":
            self.logits = nn.ModuleList(L.make_dense(out_size, n, mlp_cfg.get("initializer"), device)
                                        for n in actions_num)
            return
        self.mu = L.make_dense(out_size, actions_num, space_cfg.get("mu_init"), device)
        self.mu_act = L.get_activation(space_cfg.get("mu_activation", "None"))
        self.sigma_act = L.get_activation(space_cfg.get("sigma_activation", "None"))
        sigma_init = space_cfg.get("sigma_init", {})
        self.fixed_sigma = bool(space_cfg.get("fixed_sigma", True))
        self.sigma_init_val = float(sigma_init.get("val", sigma_init.get("value", 0.0)))
        if self.fixed_sigma:
            self.sigma = nn.Parameter(
                torch.full((actions_num,), self.sigma_init_val, dtype=torch.float32, device=device)
            )
        elif sigma_init.get("name") == "const_initializer":
            # the state-dependent head's const init writes the bias, with
            # zero weights (network_builder.py:300-310)
            val = self.sigma_init_val
            self.sigma = L.make_dense(out_size, actions_num, None, device)
            self.sigma.weight_init = lambda w, generator=None: nn.init.zeros_(w)
            self.sigma.bias_init = lambda b: nn.init.constant_(b, val)
        else:
            self.sigma = L.make_dense(out_size, actions_num, sigma_init, device)

    def reset_parameters(self, generator=None):
        L.reset_parameters(self, generator)
        if self.space == "continuous" and self.fixed_sigma:
            with torch.no_grad():
                self.sigma.fill_(self.sigma_init_val)

    def _trunk(self, obs, prefix: str):
        x, cnn = obs, getattr(self, prefix + "cnn")
        if cnn is not None:
            # channels-last observations to channels-first (permute_input),
            # flattened in (c, h, w) order
            x = cnn(x.movedim(-1, 1)).flatten(1)
        return getattr(self, prefix + "mlp")(x)

    def forward(self, obs):
        a_out = self._trunk(obs, "actor_")
        c_out = self._trunk(obs, "critic_") if self.separate else a_out
        value = self.value_act(self.value(c_out))
        if self.space == "discrete":
            return {"logits": self.logits(a_out), "value": value}
        if self.space == "multi_discrete":
            return {"logits": tuple(head(a_out) for head in self.logits), "value": value}
        mu = self.mu_act(self.mu(a_out))
        if self.fixed_sigma:
            # mu * 0.0 broadcasts sigma to mu's shape, as the JAX torso does
            sigma_raw = self.sigma_act(self.sigma) + mu * 0.0
        else:
            sigma_raw = self.sigma_act(self.sigma(a_out))
        return {"mu": mu, "sigma_raw": sigma_raw, "value": value}
