"""Building-block layers for the config-driven network builder.

Port of rl_games_tpu/models/layers.py :22-160, ``FusedMLP`` and
``build_mlp`` (:223-270; the reference's network_builder.py:50-73,110-135):
activation and initializer factories, the Linear init convention, the
sequential MLP and its fused form. Modules are named as the reference's ``nn.Sequential``
names them (Linear at 0, activation at 1, [LayerNorm at 2], ...), so a
port ``state_dict()`` has the reference checkpoint layout.
"""

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

# Activation factory (network_builder.py:50-59). ``gelu`` is the tanh
# approximation, as jax.nn.gelu computes it by default.
ACTIVATIONS = {
    "relu": nn.ReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
    "elu": nn.ELU,
    "selu": nn.SELU,
    "swish": nn.SiLU,
    "silu": nn.SiLU,
    "gelu": lambda: nn.GELU(approximate="tanh"),
    "softplus": nn.Softplus,
    "None": nn.Identity,
    None: nn.Identity,
}


def get_activation(name) -> nn.Module:
    return ACTIVATIONS[name]()


# ---------------------------------------------------------------------------
# Initializer factory (network_builder.py:61-73). Each initializer fills a
# torch [out, in] weight in place from an explicit generator; the JAX
# package's flax kernels are the transpose, [in, out].
# ---------------------------------------------------------------------------


def torch_default_kernel_init(weight, generator=None):
    """torch.nn.Linear default: kaiming_uniform(a=sqrt(5)) == U(±1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(weight.shape[1])
    nn.init.uniform_(weight, -bound, bound, generator=generator)


def _variance_scaling_truncated(weight, scale, generator):
    """flax variance_scaling(scale, 'fan_in', 'truncated_normal')."""
    stddev = math.sqrt(scale / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                          generator=generator)


def get_initializer(cfg: Optional[dict]) -> Callable:
    """Map a reference initializer config {'name': ..., **kw} to an in-place
    weight initializer ``init(weight, generator)``."""
    if not cfg:
        return torch_default_kernel_init
    name = cfg.get("name", "default")
    if name == "const_initializer":
        val = float(cfg.get("val", cfg.get("value", 0)))
        return lambda w, generator=None: nn.init.constant_(w, val)
    if name in ("orthogonal_initializer", "orthogonal"):
        gain = float(cfg.get("gain", 1.0))
        return lambda w, generator=None: nn.init.orthogonal_(w, gain, generator=generator)
    if name == "glorot_normal_initializer":
        return lambda w, generator=None: nn.init.xavier_normal_(w, generator=generator)
    if name == "glorot_uniform_initializer":
        return lambda w, generator=None: nn.init.xavier_uniform_(w, generator=generator)
    if name == "variance_scaling_initializer":
        scale = float(cfg.get("scale", 2.0))
        return lambda w, generator=None: _variance_scaling_truncated(w, scale, generator)
    if name == "random_uniform_initializer":
        lo = float(cfg.get("a", cfg.get("minval", 0.0)))
        hi = float(cfg.get("b", cfg.get("maxval", 1.0)))
        return lambda w, generator=None: nn.init.uniform_(w, lo, hi, generator=generator)
    if name == "kaiming_normal":
        # flax he_normal: truncated normal, fan_in, scale 2
        return lambda w, generator=None: _variance_scaling_truncated(w, 2.0, generator)
    return torch_default_kernel_init


def make_dense(in_features: int, out_features: int, init_cfg: Optional[dict],
               device=None) -> nn.Linear:
    """nn.Linear with the reference builders' init: the configured weight
    init ('default' = torch's kaiming-uniform) and an unconditional zero
    bias (network_builder.py:330-338). ``reset_dense`` draws the weights."""
    layer = nn.Linear(in_features, out_features, device=device)
    layer.weight_init = get_initializer(init_cfg)
    return layer


def reset_dense(layer: nn.Linear, generator=None):
    with torch.no_grad():
        layer.weight_init(layer.weight, generator=generator)
        layer.bias.zero_()


def reset_parameters(module: nn.Module, generator=None):
    """Redraw every Linear made by ``make_dense`` and reset LayerNorms, in
    module order, from one generator."""
    for m in module.modules():
        if isinstance(m, nn.Linear) and hasattr(m, "weight_init"):
            reset_dense(m, generator)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


def _dense_stack(in_features, units, activation, initializer, device, norm_for=None):
    """[Linear, activation[, norm]] per unit; ``norm_for(i, unit)`` gives the
    i-th unit's normalization module or None."""
    mods = []
    d = in_features
    for i, unit in enumerate(units):
        mods.append(make_dense(d, unit, initializer, device=device))
        mods.append(get_activation(activation))
        norm = norm_for(i, unit) if norm_for is not None else None
        if norm is not None:
            mods.append(norm)
        d = unit
    return mods


class FusedMLP(nn.Sequential):
    """Fully-fused sequential MLP, selected with ``network.mlp.fused: true``
    (rl_games_tpu/models/layers.py ``FusedMLP``). It holds the same modules
    as the plain MLP, so names, ``state_dict`` keys, init and
    ``reset_parameters`` order are the plain MLP's and fused and plain
    checkpoints interchange; the forward hands all weights to
    ``ops.fused_mlp`` (one CUDA kernel launch on the card, exact gradients
    through the plain chain)."""

    def __init__(self, in_features: int, units: Sequence[int], activation,
                 initializer=None, device=None):
        super().__init__(*_dense_stack(in_features, units, activation, initializer, device))
        self.activation = activation

    def forward(self, x):
        from rl_games_tpu_torch.ops.fused_mlp import fused_mlp

        linears = [m for m in self if isinstance(m, nn.Linear)]
        if not linears:
            return x
        # the kernel takes contiguous [B, D] rows; trajectory and minibatch
        # slices may be neither
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        out = fused_mlp(flat, [m.weight for m in linears], [m.bias for m in linears],
                        self.activation)
        return out.reshape(*x.shape[:-1], out.shape[-1])


def build_mlp(in_features: int, units: Sequence[int], activation,
              initializer=None, norm_func_name=None, d2rl=False,
              norm_only_first_layer=False, fused=False, device=None) -> nn.Sequential:
    """Sequential MLP (network_builder.py:110-135): Linear→act→[norm] per
    unit. ``batch_norm`` is a LayerNorm stand-in, as in the JAX package."""
    if fused:
        if d2rl or norm_func_name:
            raise ValueError(
                "mlp.fused: true supports the plain sequential MLP only "
                "(no d2rl, no normalization) — same restriction as the "
                "reference's tcnn net (networks/tcnn_mlp.py)."
            )
        return FusedMLP(in_features, units, activation, initializer, device=device)
    if d2rl:
        raise NotImplementedError("d2rl MLP torsos are not ported yet (ROADMAP.md, item A8)")

    def norm_for(i, unit):
        if norm_func_name not in ("layer_norm", "batch_norm"):
            return None
        if norm_only_first_layer and i > 0:
            return None
        return nn.LayerNorm(unit, eps=1e-5, device=device)

    return nn.Sequential(*_dense_stack(in_features, units, activation, initializer, device, norm_for))
