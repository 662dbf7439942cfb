"""Building-block layers for the config-driven network builder.

Port of rl_games_tpu/models/layers.py :22-160, ``FusedMLP`` and
``build_mlp`` (:223-270), ``SpatialSoftArgmax`` and ``CNN`` (:279-363; the
reference's network_builder.py:50-73,110-209, spatial_softmax.py):
activation and initializer factories, the Linear/Conv init convention, the
sequential MLP and its fused form, and the conv stacks. Modules are named
as the reference's ``nn.Sequential`` names them (Linear or Conv at 0,
activation at 1, [LayerNorm at 2], ...), so a port ``state_dict()`` has the
reference checkpoint layout. The conv stacks run over NCHW (NCL for
conv1d), the layout of the reference's torch builder; the JAX package runs
them over NHWC.
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


def _flax_leading_dim(weight) -> int:
    """The first dim of the flax kernel that ``weight`` corresponds to:
    ``in`` for a Linear ([out, in] here, [in, out] in flax), the kernel
    height for a conv ([O, I, kH, kW] here, [kH, kW, I, O] in flax)."""
    return weight.shape[1] if weight.dim() == 2 else weight.shape[2]


def torch_default_kernel_init(weight, generator=None):
    """The JAX package's torch_default_kernel_init: U(±1/sqrt(shape[0])) of
    the flax kernel. For a Linear that is torch's kaiming_uniform(a=sqrt(5))
    = U(±1/sqrt(fan_in)); for a conv the JAX package reads the kernel
    height as the fan-in, and the port draws the same."""
    bound = 1.0 / math.sqrt(_flax_leading_dim(weight))
    nn.init.uniform_(weight, -bound, bound, generator=generator)


def _variance_scaling_truncated(weight, scale, generator):
    """flax variance_scaling(scale, 'fan_in', 'truncated_normal'); a conv's
    fan-in counts its receptive field, as flax's does."""
    stddev = math.sqrt(scale / weight[0].numel()) / 0.87962566103423978
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
    bias (network_builder.py:330-338). ``reset_layer`` draws the weights."""
    layer = nn.Linear(in_features, out_features, device=device)
    layer.weight_init = get_initializer(init_cfg)
    return layer


def reset_layer(layer: nn.Module, generator=None):
    """Draw a Linear's or conv's weight with its ``weight_init``; zero its bias."""
    with torch.no_grad():
        layer.weight_init(layer.weight, generator=generator)
        layer.bias.zero_()


def reset_parameters(module: nn.Module, generator=None):
    """Redraw every Linear and conv made by ``make_dense`` / ``CNN`` and
    reset LayerNorms, in module order, from one generator."""
    for m in module.modules():
        if hasattr(m, "weight_init"):
            reset_layer(m, generator)
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


# ---------------------------------------------------------------------------
# Conv stacks (layers.py:279-363; network_builder.py:160-209)
# ---------------------------------------------------------------------------


def _linspace(n: int, device) -> torch.Tensor:
    return torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)


class SpatialSoftArgmax(nn.Module):
    """Soft arg-max over each feature map (spatial_softmax.py:7-72): NCHW in,
    [B, C*2] out of (x, y) expected coordinates in [-1, 1]. The coordinate
    grids pair with the flattened map in the reference's (w, h) order, as
    the JAX package's do."""

    def forward(self, x):
        b, c, h, w = x.shape
        softmax = torch.softmax(x.reshape(b * c, h * w), dim=-1)
        xc = _linspace(w, x.device).repeat_interleave(h)
        yc = _linspace(h, x.device).repeat(w)
        x_mean = (softmax * xc).sum(-1)
        y_mean = (softmax * yc).sum(-1)
        return torch.stack([x_mean, y_mean], dim=-1).reshape(b, c * 2)


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channel dim of an NCHW (or NCL) map: what flax's
    LayerNorm over NHWC's last axis computes."""

    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


def _pair(v, n: int):
    return (v,) * n if isinstance(v, int) else tuple(v)


class CNN(nn.Sequential):
    """Conv stack from a ``convs`` config list (layers.py:307-363): per conv
    [Conv, activation, [ChannelLayerNorm]]; ``ctype`` is ``conv2d``,
    ``conv1d``, ``coord_conv2d`` (normalized x and y channels appended
    before each conv, torch_ext.py:223-240) or ``conv2d_spatial_softargmax``
    (a SpatialSoftArgmax after the stack). Input NCHW (NCL for conv1d)."""

    def __init__(self, in_channels: int, convs: Sequence[dict], activation,
                 initializer=None, norm_func_name=None, ctype: str = "conv2d", device=None):
        if ctype not in ("conv2d", "conv1d", "coord_conv2d", "conv2d_spatial_softargmax"):
            raise NotImplementedError(f"cnn.type {ctype!r} is not ported to rl_games_tpu_torch yet "
                                      "(ROADMAP.md, item A8)")
        self.ctype = ctype
        self.convs = [dict(c) for c in convs]
        n = 1 if ctype == "conv1d" else 2
        conv_cls = nn.Conv1d if n == 1 else nn.Conv2d
        extra = 2 if ctype == "coord_conv2d" else 0
        mods, c_in = [], in_channels
        for conv in self.convs:
            layer = conv_cls(c_in + extra, conv["filters"], _pair(conv["kernel_size"], n),
                             stride=_pair(conv["strides"], n), padding=_pair(conv["padding"], n),
                             device=device)
            layer.weight_init = get_initializer(initializer)
            mods.append(layer)
            mods.append(get_activation(activation))
            if norm_func_name in ("layer_norm", "batch_norm"):
                mods.append(ChannelLayerNorm(conv["filters"], eps=1e-5, device=device))
            c_in = conv["filters"]
        if ctype == "conv2d_spatial_softargmax":
            mods.append(SpatialSoftArgmax())
        super().__init__(*mods)

    def output_size(self, spatial: Sequence[int]) -> int:
        """Features per sample after the stack and its flatten, for an input
        of spatial extent ``spatial`` (H, W; or L)."""
        dims = list(spatial)
        for conv in self.convs:
            k, s, p = (_pair(conv[key], len(dims)) for key in ("kernel_size", "strides", "padding"))
            dims = [(d + 2 * p[i] - k[i]) // s[i] + 1 for i, d in enumerate(dims)]
        channels = self.convs[-1]["filters"]
        if self.ctype == "conv2d_spatial_softargmax":
            return 2 * channels
        return channels * math.prod(dims)

    def forward(self, x):
        for m in self:
            if self.ctype == "coord_conv2d" and isinstance(m, nn.Conv2d):
                b, _, h, w = x.shape
                xx = _linspace(w, x.device).view(1, 1, 1, w).expand(b, 1, h, w)
                yy = _linspace(h, x.device).view(1, 1, h, 1).expand(b, 1, h, w)
                x = torch.cat([x, xx, yy], dim=1)
            x = m(x)
        return x
