"""Connect-four residual-tower network ('connect4net').

Port of rl_games_tpu/models/connect4_network.py (:22-71), the network that
ref/ma/ppo_connect4_self_play_resnet.yaml selects through
``import_modules`` (``rl_games_tpu.models.connect4_network``, which the
port's Runner maps to this module): a 3x3 conv stem, ``blocks``
pre-activation residual blocks (GroupNorm of 8 groups of contiguous
channels, relu, 3x3 conv, twice), a relu, and two 1x1-conv heads: the
policy's (2 channels, flattened, a Linear to the logits) and the value's
(1 channel, a relu Linear of ``channels`` units, a Linear to the value).
flax's GroupNorm takes epsilon 1e-6 (torch's default is 1e-5) and flax's
Conv and Dense their default init, lecun-normal weights and zero biases.

Observations are NHWC boards ([B, 6, 7, 2]); the convolutions run over
NCHW, so the policy head's flatten is in (c, h, w) order where the JAX
package's is (h, w, c): ``utils/jax_params`` permutes the ``policy`` rows.
Modules carry the JAX package's names (``stem``, ``n{b}a``, ``c{b}a``,
``n{b}b``, ``c{b}b``, ``policy_conv``, ``policy``, ``value_conv``,
``value_hidden``, ``value``).
"""

import torch
from torch import nn

from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.models.model_builder import register_network


def _conv(in_channels: int, channels: int, kernel: int, device=None) -> nn.Conv2d:
    return L.with_init(nn.Conv2d(in_channels, channels, kernel, padding=kernel // 2, device=device), L.lecun_normal)


class Connect4Net(nn.Module):
    """forward(obs [B, H, W, C], rnn_states=None, dones=None, seq_length=1)
    -> {'logits', 'value', 'rnn_states': None}."""

    def __init__(self, actions_num: int, input_shape, blocks: int = 5, channels: int = 128,
                 value_size: int = 1, device=None):
        super().__init__()
        height, width, in_channels = (int(d) for d in input_shape)
        self.blocks = blocks
        self.stem = _conv(in_channels, channels, 3, device)
        for b in range(blocks):
            for half in "ab":
                setattr(self, f"n{b}{half}", nn.GroupNorm(8, channels, eps=1e-6, device=device))
                setattr(self, f"c{b}{half}", _conv(channels, channels, 3, device))
        self.policy_conv = _conv(channels, 2, 1, device)
        self.policy = L.with_init(nn.Linear(2 * height * width, actions_num, device=device), L.lecun_normal)
        self.value_conv = _conv(channels, 1, 1, device)
        self.value_hidden = L.with_init(nn.Linear(height * width, channels, device=device), L.lecun_normal)
        self.value = L.with_init(nn.Linear(channels, value_size, device=device), L.lecun_normal)

    def is_rnn(self) -> bool:
        return False

    def get_default_rnn_state(self, num_seqs: int, device=None):
        return None

    def reset_parameters(self, generator=None):
        L.reset_parameters(self, generator)

    def forward(self, obs, rnn_states=None, dones=None, seq_length: int = 1):
        x = self.stem(obs.movedim(-1, 1))
        for b in range(self.blocks):
            y = getattr(self, f"c{b}a")(torch.relu(getattr(self, f"n{b}a")(x)))
            y = getattr(self, f"c{b}b")(torch.relu(getattr(self, f"n{b}b")(y)))
            x = x + y
        x = torch.relu(x)
        logits = self.policy(self.policy_conv(x).flatten(1))
        v = torch.relu(self.value_hidden(self.value_conv(x).flatten(1)))
        return {"logits": logits, "value": self.value(v), "rnn_states": None}


def _build_connect4net(net_params, *, actions_num, input_shape, value_size=1, device=None, **kw):
    return Connect4Net(actions_num, input_shape, blocks=int(net_params.get("blocks", 5)),
                       channels=int(net_params.get("channels", 128)), value_size=value_size, device=device)


register_network("connect4net", _build_connect4net)
