"""Building-block layers for the config-driven network builder.

Port of rl_games_tpu/models/layers.py :22-195, ``FusedMLP`` and
``build_mlp`` (:223-270), ``SpatialSoftArgmax`` and ``CNN`` (:279-363),
the Impala tower with its attention and frozen batch-norm blocks
(:366-515), the Noisy layers (:518-603), ``RNNCore`` and
``default_rnn_state`` (:605-703; the reference's network_builder.py:50-73,
110-209, 599-727, d2rl.py, spatial_softmax.py, recurrent.py,
algos_torch/layers.py): activation and initializer factories, the
Linear/Conv init convention, the sequential MLP, its fused form and the
D2RL dense-skip MLP, the conv stacks and the done-masked recurrent core.
Modules are named as the reference's ``nn.Sequential`` names them (Linear
or Conv at 0, activation at 1, [LayerNorm at 2], ...; a D2RL MLP's
``linears.{i}`` and ``norm_layers.{i}``; an Impala stage's ``conv.conv``,
``conv.bn``, ``res_block{1,2}.conv{1,2}`` and ``alpha``), so a port
``state_dict()`` has the reference checkpoint layout. The conv stacks run
over NCHW (NCL for conv1d), the layout of the reference's torch builder;
the JAX package runs them over NHWC.
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


def lecun_normal(weight, generator=None):
    """flax's default kernel init (Dense, Conv): variance_scaling(1,
    'fan_in', 'truncated_normal')."""
    _variance_scaling_truncated(weight, 1.0, generator)


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
    """Draw a Linear's or conv's weight with its ``weight_init``; zero its
    bias, or fill it with its ``bias_init`` where the layer has one."""
    with torch.no_grad():
        layer.weight_init(layer.weight, generator=generator)
        bias_init = getattr(layer, "bias_init", None)
        if layer.bias is None:
            return
        if bias_init is None:
            layer.bias.zero_()
        else:
            bias_init(layer.bias)


def with_init(layer: nn.Module, weight_init: Callable) -> nn.Module:
    """``layer`` with the weight init that ``reset_parameters`` draws."""
    layer.weight_init = weight_init
    return layer


def reset_parameters(module: nn.Module, generator=None):
    """Redraw every Linear and conv that carries a ``weight_init`` and every
    ``RNNCore``, and reset the norms and the residual scalars, in module
    order, from one generator."""
    for m in module.modules():
        if hasattr(m, "weight_init"):
            reset_layer(m, generator)
        elif isinstance(m, RNNCore):
            m.reset_parameters(generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm2d, ImpalaResidualBlock)):
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


class D2RLMLP(nn.Module):
    """Dense-skip MLP (layers.py:161-195; the reference's d2rl.py): the input
    is concatenated after the features before every layer but the first.
    The norm comes after the activation on layer 0 and before it on later
    layers, as in the reference."""

    def __init__(self, in_features: int, units: Sequence[int], activation,
                 initializer=None, norm_func_name=None, device=None):
        super().__init__()
        self.activations = nn.ModuleList(get_activation(activation) for _ in units)
        self.linears = nn.ModuleList()
        self.norm_layers = nn.ModuleList()
        d = in_features
        for unit in units:
            self.linears.append(make_dense(d, unit, initializer, device=device))
            self.norm_layers.append(nn.LayerNorm(unit, eps=1e-5, device=device)
                                    if norm_func_name in ("layer_norm", "batch_norm") else nn.Identity())
            d = unit + in_features

    def forward(self, inp):
        x = self.norm_layers[0](self.activations[0](self.linears[0](inp)))
        for linear, norm, act in zip(self.linears[1:], self.norm_layers[1:], self.activations[1:]):
            x = act(norm(linear(torch.cat([x, inp], dim=-1))))
        return x


def build_mlp(in_features: int, units: Sequence[int], activation,
              initializer=None, norm_func_name=None, d2rl=False,
              norm_only_first_layer=False, fused=False, device=None) -> nn.Sequential:
    """Sequential MLP (network_builder.py:110-135): Linear→act→[norm] per
    unit; the D2RL MLP with ``d2rl``. ``batch_norm`` is a LayerNorm
    stand-in, as in the JAX package."""
    if fused:
        if d2rl or norm_func_name:
            raise ValueError(
                "mlp.fused: true supports the plain sequential MLP only "
                "(no d2rl, no normalization) — same restriction as the "
                "reference's tcnn net (networks/tcnn_mlp.py)."
            )
        return FusedMLP(in_features, units, activation, initializer, device=device)
    if d2rl:
        return D2RLMLP(in_features, units, activation, initializer, norm_func_name, device=device)

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


def conv_output_dims(convs: Sequence[dict], spatial: Sequence[int]) -> list:
    """The spatial extent after a ``convs`` stack of an input of extent
    ``spatial`` (H, W; or L)."""
    dims = list(spatial)
    for conv in convs:
        k, s, p = (_pair(conv[key], len(dims)) for key in ("kernel_size", "strides", "padding"))
        dims = [(d + 2 * p[i] - k[i]) // s[i] + 1 for i, d in enumerate(dims)]
    return dims


def impala_output_dims(stages: int, spatial: Sequence[int]) -> list:
    """The spatial extent after ``stages`` Impala stages: each stage's pool
    (3, stride 2, padding 1) takes a side d to (d - 1) // 2 + 1."""
    dims = list(spatial)
    for _ in range(stages):
        dims = [(d - 1) // 2 + 1 for d in dims]
    return dims


class CNN(nn.Sequential):
    """Conv stack from a ``convs`` config list (layers.py:307-363): per conv
    [Conv, activation, [ChannelLayerNorm]]; ``ctype`` is ``conv2d``,
    ``conv1d``, ``coord_conv2d`` (normalized x and y channels appended
    before each conv, torch_ext.py:223-240) or ``conv2d_spatial_softargmax``
    (a SpatialSoftArgmax after the stack); any other type is a plain
    conv2d stack, as in the JAX package. Input NCHW (NCL for conv1d)."""

    def __init__(self, in_channels: int, convs: Sequence[dict], activation,
                 initializer=None, norm_func_name=None, ctype: str = "conv2d", device=None):
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
        channels = self.convs[-1]["filters"]
        if self.ctype == "conv2d_spatial_softargmax":
            return 2 * channels
        return channels * math.prod(conv_output_dims(self.convs, spatial))

    def forward(self, x):
        for m in self:
            if self.ctype == "coord_conv2d" and isinstance(m, nn.Conv2d):
                b, _, h, w = x.shape
                xx = _linspace(w, x.device).view(1, 1, 1, w).expand(b, 1, h, w)
                yy = _linspace(h, x.device).view(1, 1, h, 1).expand(b, 1, h, w)
                x = torch.cat([x, xx, yy], dim=1)
            x = m(x)
        return x


# ---------------------------------------------------------------------------
# The Impala tower (layers.py:366-515; network_builder.py:599-727)
# ---------------------------------------------------------------------------


class ChannelAttention(nn.Module):
    """The squeeze-and-excitation channel gate (layers.py:366-381):
    sigmoid(fc2(relu(fc1(avgpool))) + fc2(relu(fc1(maxpool)))), the two
    bias-free Linears shared by both pools, ``max(1, C // 16)`` hidden.
    Returns the gate [B, C, 1, 1] of an NCHW map."""

    def __init__(self, channels: int, reduction: int = 16, device=None):
        super().__init__()
        hidden = max(1, channels // reduction)
        self.fc1 = with_init(nn.Linear(channels, hidden, bias=False, device=device), lecun_normal)
        self.fc2 = with_init(nn.Linear(hidden, channels, bias=False, device=device), lecun_normal)

    def forward(self, x):
        avg = self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3)))))
        mx = self.fc2(torch.relu(self.fc1(x.amax(dim=(2, 3)))))
        return torch.sigmoid(avg + mx)[:, :, None, None]


class SpatialAttention(nn.Module):
    """The spatial gate (layers.py:384-398): sigmoid of a bias-free 7x7 SAME
    conv over [channel mean, channel max]. Returns [B, 1, H, W]."""

    def __init__(self, kernel_size: int = 7, device=None):
        super().__init__()
        self.conv = with_init(nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False, device=device),
                              lecun_normal)

    def forward(self, x):
        pooled = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv(pooled))


class FrozenBatchNorm2d(nn.Module):
    """A batch norm with frozen statistics (layers.py:400-427): (x - mean) ·
    rsqrt(var + eps) · weight + bias over NCHW channels, never the batch's
    statistics. As in the JAX package, ``running_mean`` and ``running_var``
    are parameters that take no gradient: Adam leaves them where they are,
    weight decay moves them. Named as the reference's BatchNorm2d
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``, which stays 0)."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, **f32))
        self.bias = nn.Parameter(torch.zeros(channels, **f32))
        self.running_mean = nn.Parameter(torch.zeros(channels, **f32))
        self.running_var = nn.Parameter(torch.ones(channels, **f32))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long, device=device))

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        inv = torch.rsqrt(self.running_var.detach() + self.eps) * self.weight
        return (x - self.running_mean.detach()[:, None, None]) * inv[:, None, None] + self.bias[:, None, None]


class ImpalaConvBlock(nn.Module):
    """A 3x3 SAME conv, stride 1 (layers.py:429-443); with ``use_bn`` it has
    no bias and a FrozenBatchNorm2d follows. flax's Conv init: lecun-normal
    weights, zero biases."""

    def __init__(self, in_channels: int, channels: int, use_bn: bool = False, device=None):
        super().__init__()
        self.conv = with_init(nn.Conv2d(in_channels, channels, 3, padding=1, bias=not use_bn, device=device),
                              lecun_normal)
        self.bn = FrozenBatchNorm2d(channels, device=device) if use_bn else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


class ImpalaResidualBlock(nn.Module):
    """relu → conv1 → relu → conv2, then the channel and spatial gates
    (``use_attention``, as ``ca`` and ``sa``), and the residual added, or
    with ``use_zero_init`` the block's output scaled by ``alpha`` (0 at
    init) first (layers.py:446-471)."""

    def __init__(self, channels: int, use_attention=False, use_bn=False, use_zero_init=False, device=None):
        super().__init__()
        self.conv1 = ImpalaConvBlock(channels, channels, use_bn, device)
        self.conv2 = ImpalaConvBlock(channels, channels, use_bn, device)
        self.ca = ChannelAttention(channels, device=device) if use_attention else None
        self.sa = SpatialAttention(device=device) if use_attention else None
        self.alpha = nn.Parameter(torch.zeros(1, device=device)) if use_zero_init else None

    def reset_parameters(self):
        if self.alpha is not None:
            with torch.no_grad():
                self.alpha.zero_()

    def forward(self, x):
        residual = x
        x = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        if self.ca is not None:
            x = self.ca(x) * x
            x = self.sa(x) * x
        if self.alpha is not None:
            return x * self.alpha + residual
        return x + residual


class ImpalaSequential(nn.Module):
    """conv → max pool 3/2 (padding 1, padded with -inf) → two residual
    blocks (layers.py:474-492)."""

    def __init__(self, in_channels: int, channels: int, use_attention=False, use_bn=False, use_zero_init=False,
                 device=None):
        super().__init__()
        self.conv = ImpalaConvBlock(in_channels, channels, use_bn, device)
        self.max_pool = nn.MaxPool2d(3, 2, padding=1)
        self.res_block1 = ImpalaResidualBlock(channels, use_attention, use_bn, use_zero_init, device)
        self.res_block2 = ImpalaResidualBlock(channels, use_attention, use_bn, use_zero_init, device)

    def forward(self, x):
        return self.res_block2(self.res_block1(self.max_pool(self.conv(x))))


class ImpalaCNN(nn.Sequential):
    """The Impala tower from ``conv_depths`` (layers.py:495-515): a stage a
    depth, then a relu; NCHW in, a map out that the torso flattens. It takes
    no ``cnn.initializer``, as the JAX package's takes none."""

    def __init__(self, in_channels: int, conv_depths: Sequence[int], use_attention=False, use_bn=False,
                 use_zero_init=False, device=None):
        stages, c = [], in_channels
        for depth in conv_depths:
            stages.append(ImpalaSequential(c, depth, use_attention, use_bn, use_zero_init, device))
            c = depth
        super().__init__(*stages)
        self.depths = list(conv_depths)

    def output_size(self, spatial: Sequence[int]) -> int:
        """Features per sample after the tower and its flatten."""
        return self.depths[-1] * math.prod(impala_output_dims(len(self.depths), spatial))

    def forward(self, x):
        return torch.relu(super().forward(x))


# ---------------------------------------------------------------------------
# NoisyNet layers (layers.py:518-603; the reference's algos_torch/layers.py)
# ---------------------------------------------------------------------------


class NoisyLinear(nn.Module):
    """A linear layer with independent Gaussian noise on every weight and
    bias (layers.py:518-560): w = weight + sigma_weight · ε, ε ~ N(0, 1) per
    element; sigma 0.017, weight and bias U(±sqrt(3 / fan_in)).
    ``forward(x, noise=None, generator=None)``: with neither, the
    mean-weight forward; ``noise`` is (ε_w [out, in], ε_b [out]), else
    drawn from ``generator``."""

    def __init__(self, in_features: int, out_features: int, sigma_init: float = 0.017, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.in_features, self.out_features, self.sigma_init = in_features, out_features, sigma_init
        self.weight = nn.Parameter(torch.empty((out_features, in_features), **f32))
        self.bias = nn.Parameter(torch.empty(out_features, **f32))
        self.sigma_weight = nn.Parameter(torch.empty((out_features, in_features), **f32))
        self.sigma_bias = nn.Parameter(torch.empty(out_features, **f32))
        self.reset_parameters()

    def mu_bound(self) -> float:
        return math.sqrt(3.0 / self.in_features)

    def reset_parameters(self, generator=None):
        bound = self.mu_bound()
        with torch.no_grad():
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)
            self.sigma_weight.fill_(self.sigma_init)
            self.sigma_bias.fill_(self.sigma_init)

    def forward(self, x, noise=None, generator=None):
        if noise is None and generator is None:
            return torch.nn.functional.linear(x, self.weight, self.bias)
        if noise is None:
            noise = (torch.randn(self.weight.shape, generator=generator, device=x.device),
                     torch.randn(self.bias.shape, generator=generator, device=x.device))
        eps_w, eps_b = noise
        return torch.nn.functional.linear(x, self.weight + self.sigma_weight * eps_w,
                                          self.bias + self.sigma_bias * eps_b)


class NoisyFactorizedLinear(NoisyLinear):
    """The factorized Gaussian variant (layers.py:563-603): w = weight +
    sigma_weight · f(ε_out) f(ε_in)ᵀ, b = bias + sigma_bias · f(ε_out),
    f(e) = sign(e) · sqrt(|e|); sigma sigma_zero / sqrt(fan_in), weight and
    bias torch's Linear init U(±1 / sqrt(fan_in)). ``noise`` is (ε_in [in],
    ε_out [out])."""

    def __init__(self, in_features: int, out_features: int, sigma_zero: float = 0.4, device=None):
        super().__init__(in_features, out_features, sigma_zero / math.sqrt(in_features), device)

    def mu_bound(self) -> float:
        return 1.0 / math.sqrt(self.in_features)

    def forward(self, x, noise=None, generator=None):
        if noise is None and generator is None:
            return torch.nn.functional.linear(x, self.weight, self.bias)
        if noise is None:
            noise = (torch.randn(self.in_features, generator=generator, device=x.device),
                     torch.randn(self.out_features, generator=generator, device=x.device))
        eps_in, eps_out = (torch.sign(e) * torch.sqrt(torch.abs(e)) for e in noise)
        return torch.nn.functional.linear(x, self.weight + self.sigma_weight * torch.outer(eps_out, eps_in),
                                          self.bias + self.sigma_bias * eps_out)


# ---------------------------------------------------------------------------
# Done-masked recurrent core (layers.py:605-703)
# ---------------------------------------------------------------------------

# gates per cell, in the row order of the reference checkpoint's tensors
# (torch's nn.LSTM: i, f, g, o; nn.GRU: r, z, n)
RNN_GATES = {"lstm": 4, "gru": 3}


def _no_gradient(grad):
    return torch.zeros_like(grad)


def _n_gate_gradient(grad):
    """A GRU bias_hh's gradient kept on its n block only."""
    return torch.cat([torch.zeros_like(grad[: 2 * grad.shape[0] // 3]), grad[2 * grad.shape[0] // 3:]])


class RNNWeights(nn.Module):
    """The cell tensors of a stack, named as the reference checkpoint names
    them (its nn.LSTM / nn.GRU): ``weight_ih_l{k}`` [G·units, in],
    ``weight_hh_l{k}`` [G·units, units], ``bias_ih_l{k}``, ``bias_hh_l{k}``
    [G·units].

    flax's cells keep one bias where torch's keep two: the LSTM's on the
    hidden side, the GRU's r and z biases on the input side (its n gate has
    both, b_in and b_hn). The other copy is kept in the reference's layout
    (the cells add the two) but takes no gradient, so that an update moves
    the sum as the JAX package moves its one bias; it stays at its value
    (0 unless loaded)."""

    def __init__(self, kind: str, in_features: int, units: int, num_layers: int, device=None):
        super().__init__()
        rows = RNN_GATES[kind] * units
        for k in range(num_layers):
            d = in_features if k == 0 else units
            f32 = dict(dtype=torch.float32, device=device)
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(torch.empty((rows, d), **f32)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(torch.empty((rows, units), **f32)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(torch.zeros(rows, **f32)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(torch.zeros(rows, **f32)))
            if kind == "lstm":
                getattr(self, f"bias_ih_l{k}").register_hook(_no_gradient)
            else:
                getattr(self, f"bias_hh_l{k}").register_hook(_n_gate_gradient)

    def layer(self, k: int):
        return tuple(getattr(self, f"{name}_l{k}") for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))


class RNNCore(nn.Module):
    """Multi-layer LSTM / GRU / identity unrolled over time with done masking
    (``RNNCore`` and ``_StackStep``, layers.py:605-703).

    forward(x [num_seqs, seq_len, F], states, dones [num_seqs, seq_len] or
    None) -> (out [num_seqs, seq_len, units], new_states). ``states`` is the
    reference's layout: (h, c) for an LSTM, (h,) for a GRU, each [layers,
    num_seqs, units]; None starts from zeros. A layer's carry is zeroed
    before a step whose done is set. The time loop is written out (one
    addmm over the gate blocks a step and layer): cuDNN's fused RNN cannot
    zero the carry in mid-sequence. The cells compute what flax's do: the
    LSTM's c' = σ(f)·c + σ(i)·tanh(g), h' = σ(o)·tanh(c'); the GRU's
    n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn)), h' = (1 − z)·n + z·h.
    The input projection of a layer is one product over every step;
    stacked layers run one after the other over the whole sequence."""

    def __init__(self, kind: str, in_features: int, units: int, num_layers: int = 1, device=None):
        super().__init__()
        if kind not in ("lstm", "gru", "identity"):
            raise ValueError(f"rnn.name must be lstm, gru or identity, got {kind!r}")
        self.kind, self.units, self.num_layers = kind, units, num_layers
        self.out_features = in_features if kind == "identity" else units
        self.rnn = None if kind == "identity" else RNNWeights(kind, in_features, units, num_layers, device)

    def reset_parameters(self, generator=None):
        """flax's cell init: lecun-normal input kernels, an orthogonal
        recurrent kernel per gate, zero biases."""
        if self.rnn is None:
            return
        with torch.no_grad():
            for k in range(self.num_layers):
                w_ih, w_hh, b_ih, b_hh = self.rnn.layer(k)
                _variance_scaling_truncated(w_ih, 1.0, generator)
                for block in w_hh.split(self.units):
                    nn.init.orthogonal_(block, generator=generator)
                b_ih.zero_()
                b_hh.zero_()

    def forward(self, x, states=None, dones=None):
        if self.kind == "identity":
            return x, states
        num_seqs, seq_len, _ = x.shape
        if states is None:
            states = default_rnn_state(self.kind, self.num_layers, num_seqs, self.units, x.device)
        keep = None if dones is None else (1.0 - dones.to(x.dtype)).t()[..., None]  # [L, S, 1]
        lstm = self.kind == "lstm"
        new_h, new_c = [], []
        seq = x
        for k in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self.rnn.layer(k)
            # the layer's input products for every step at once, time-major
            xw = torch.addmm(b_ih, seq.transpose(0, 1).reshape(seq_len * num_seqs, -1), w_ih.t())
            xw = xw.view(seq_len, num_seqs, -1)
            h = states[0][k]
            c = states[1][k] if lstm else None
            outs = []
            for t in range(seq_len):
                if keep is not None:
                    h = h * keep[t]
                    if lstm:
                        c = c * keep[t]
                hw = torch.addmm(b_hh, h, w_hh.t())
                if lstm:
                    i, f, g, o = (xw[t] + hw).chunk(4, dim=1)
                    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                    h = torch.sigmoid(o) * torch.tanh(c)
                else:
                    xr, xz, xn = xw[t].chunk(3, dim=1)
                    hr, hz, hn = hw.chunk(3, dim=1)
                    r = torch.sigmoid(xr + hr)
                    z = torch.sigmoid(xz + hz)
                    n = torch.tanh(xn + r * hn)
                    h = (1.0 - z) * n + z * h
                outs.append(h)
            seq = torch.stack(outs, dim=1)  # [S, L, units]
            new_h.append(h)
            if lstm:
                new_c.append(c)
        new_states = (torch.stack(new_h), torch.stack(new_c)) if lstm else (torch.stack(new_h),)
        return seq, new_states


def default_rnn_state(kind: str, num_layers: int, num_seqs: int, units: int, device=None):
    """Zero initial states in the reference layout (layers.py:697-703): (h, c)
    for an LSTM, (h,) otherwise, each [layers, num_seqs, units]; the
    identity core's are one unit wide."""
    if kind == "identity":
        units = 1
    shape = (num_layers, num_seqs, units)
    zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return (zeros(), zeros()) if kind == "lstm" else (zeros(),)
