"""Building-block layers for the config-driven network builder.

Port of rl_games_tpu/models/layers.py :22-160 and the plain branch of
``build_mlp`` (the reference's network_builder.py:50-73,110-135):
activation and initializer factories, the Linear init convention, and the
sequential MLP. Modules are named as the reference's ``nn.Sequential``
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


def build_mlp(in_features: int, units: Sequence[int], activation,
              initializer=None, norm_func_name=None, d2rl=False,
              norm_only_first_layer=False, fused=False, device=None) -> nn.Sequential:
    """Sequential MLP (network_builder.py:110-135): Linear→act→[norm] per
    unit. ``batch_norm`` is a LayerNorm stand-in, as in the JAX package."""
    if fused:
        raise NotImplementedError(
            "network.mlp.fused: true needs the fused-MLP CUDA kernel, which "
            "is not ported yet (ROADMAP.md, item B2)"
        )
    if d2rl:
        raise NotImplementedError("d2rl MLP torsos are not ported yet (ROADMAP.md, item A8)")
    mods = []
    need_norm = True
    d = in_features
    for unit in units:
        mods.append(make_dense(d, unit, initializer, device=device))
        mods.append(get_activation(activation))
        if need_norm:
            if norm_only_first_layer and norm_func_name is not None:
                need_norm = False
            if norm_func_name in ("layer_norm", "batch_norm"):
                mods.append(nn.LayerNorm(unit, eps=1e-5, device=device))
        d = unit
    return nn.Sequential(*mods)
