"""Example custom network: dict observations and an auxiliary loss.

Port of rl_games_tpu/models/test_network.py (the reference's
rl_games/envs/test_network.py TestNet / TestNetWithAuxLoss). It shows the
port's network contract for a custom torso:

  * a network is an ``nn.Module`` with
      forward(obs, rnn_states=None, dones=None, seq_length=1) -> dict
    returning the head outputs ('logits' | 'mu'/'sigma_raw', 'value',
    'rnn_states') and optionally 'aux_losses': {name: tensor}, whose means
    the trainer adds to the loss; ``is_rnn()``, ``get_default_rnn_state``
    and ``reset_parameters(generator)``, which draws every weight from the
    generator;
  * a builder ``build(net_params, *, actions_num, input_shape,
    value_size=1, device=None, **kw)`` registered with
    ``models.model_builder.register_network(name, build)`` and selected with
    ``network.name`` in the YAML. A config's ``import_modules:
    [rl_games_tpu.models.test_network]`` imports this module in the port.

Registered as ``testnet_dict`` and ``testnet_aux_loss``.
"""

from typing import Sequence

import torch
from torch import nn

from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.models.model_builder import register_network


class TestDictObsNet(nn.Module):
    """Reads {'pos': [B, 2], 'info': [B, 4]} observations: their
    concatenation through a relu MLP (``mlp``), then the ``logits`` and
    ``value`` heads; with ``with_aux_loss`` an ``aux_head`` predicts the
    observation's 'aux_target' (zeros where it has none) and reports the
    mean squared error as 'aux_dist_loss' (TestNetWithAuxLoss,
    test_network.py:70-120)."""

    __test__ = False  # a network, not a pytest class

    def __init__(self, actions_num: int, input_shape: dict, units: Sequence[int] = (32, 32),
                 with_aux_loss: bool = False, device=None):
        super().__init__()
        in_features = int(input_shape["pos"][0]) + int(input_shape["info"][0])
        self.mlp = L.build_mlp(in_features, list(units), "relu", device=device)
        width = units[-1] if units else in_features
        self.logits = L.make_dense(width, actions_num, None, device)
        self.value = L.make_dense(width, 1, None, device)
        self.with_aux_loss = with_aux_loss
        if with_aux_loss:
            self.aux_head = L.make_dense(width, 1, None, device)

    def is_rnn(self) -> bool:
        return False

    def get_default_rnn_state(self, num_seqs: int, device=None):
        return None

    def reset_parameters(self, generator=None):
        L.reset_parameters(self, generator)

    def forward(self, obs, rnn_states=None, dones=None, seq_length: int = 1):
        x = self.mlp(torch.cat([obs["pos"], obs["info"]], dim=-1))
        out = {"logits": self.logits(x), "value": self.value(x), "rnn_states": None}
        if self.with_aux_loss:
            pred = self.aux_head(x)
            target = obs["aux_target"] if "aux_target" in obs else pred.new_zeros(pred.shape)
            out["aux_losses"] = {"aux_dist_loss": (pred - target).square().mean()}
        return out


def _build_test_dict_net(net_params, *, actions_num, input_shape, value_size=1, device=None, **kw):
    return TestDictObsNet(actions_num, input_shape,
                          units=tuple(net_params.get("mlp", {}).get("units", (32, 32))),
                          with_aux_loss=net_params.get("with_aux_loss", False), device=device)


def _build_testnet_aux_loss(net_params, **kw):
    """The reference's 'testnet_aux_loss' name (envs/test_network.py
    TestNetWithAuxLoss and its builder)."""
    return _build_test_dict_net({**net_params, "with_aux_loss": True}, **kw)


register_network("testnet_dict", _build_test_dict_net)
register_network("testnet_aux_loss", _build_testnet_aux_loss)
