"""Carry weights from the JAX package into the port.

``jax_to_state_dict`` converts the JAX package's A2C parameter tree (nested
dicts of numpy arrays, flax layout) and its ``NormState`` (numpy leaves)
into a ``state_dict`` of the port's A2C models, which use the reference
checkpoint layout:

    params/{actor,critic}_cnn/Conv_{i}/{kernel [kH,kW,I,O], bias}
        -> a2c_network.{actor,critic}_cnn.{k}.{weight [O,I,kH,kW], bias}
           (k counts the Sequential's modules: Conv, activation[, LayerNorm])
    params/{actor,critic}_cnn/LayerNorm_{i}/{scale, bias} -> ..._cnn.{k}.{weight, bias}
    params/actor_cnn/ImpalaSequential_{i}/...   (an Impala tower)
        -> a2c_network.cnn.{i}.conv.conv.*, .res_block{1,2}.conv{1,2}.conv.*
           (separate trunks: {actor,critic}_cnn.{i}...); each block's
           FrozenBatchNorm_0/{scale, bias, mean, var} -> .bn.{weight, bias,
           running_mean, running_var} (and a zero num_batches_tracked), a
           residual block's alpha -> .alpha, its ChannelAttention_0/fc{1,2}
           -> .ca.fc{1,2}, SpatialAttention_0/Conv_0 -> .sa.conv
    params/{actor,critic}_mlp/Dense_{i}/Dense_0/{kernel [in,out], bias}
        -> a2c_network.{actor,critic}_mlp.{k}.{weight [out,in], bias}
           (behind an Impala tower on a shared trunk: a2c_network.mlp; a
           D2RL MLP's go to ..._mlp.linears.{i})
    params/{actor,critic}_mlp/LayerNorm_{i}/{scale, bias}
        -> ..._mlp.{k}.{weight, bias} (a D2RL MLP's: ..._mlp.norm_layers.{i})
    params/{mu,value}/Dense_0/{kernel, bias}     -> a2c_network.{mu,value}.*
    params/value/{kernel, bias} (the two-hot head, a bare Dense of 255)
                                                 -> a2c_network.value.*
    params/Dense_0/Dense_0/{kernel, bias}        -> a2c_network.logits.* (discrete)
    params/logits_{i}/Dense_0/{kernel, bias}     -> a2c_network.logits.{i}.* (multi-discrete)
    params/sigma [A]                             -> a2c_network.sigma (fixed sigma)
    params/sigma/{kernel, bias}                  -> a2c_network.sigma.* (state-dependent)
    params/{actor,critic}_rnn/stack/{lstm,gru}_{k}/<gate Dense>
        -> a2c_network.{rnn | a_rnn, c_rnn}.rnn.{weight_ih,weight_hh,bias_ih,bias_hh}_l{k}
           (the shared trunk's core is 'rnn', separate trunks' 'a_rnn' and
           'c_rnn'; a gate's [in, units] kernel is its [units, in] block of
           rows, in the order i, f, g, o (LSTM) or r, z, n (GRU); the LSTM's
           bias, on flax's hidden side, goes to bias_hh; the GRU's r and z
           biases, on flax's input side, go to bias_ih, its n gate keeps
           'in' in bias_ih and 'hn' in bias_hh)
    params/{actor,critic}_rnn_ln/{scale, bias}
        -> a2c_network.{layer_norm | a_layer_norm, c_layer_norm}.{weight, bias}
    norm.obs / norm.value {mean, var, count}     -> running_mean_std.* /
        value_mean_std.{running_mean, running_var, count}
    norm.obs {key: {mean, var, count}} (a dict observation)
        -> running_mean_std.running_mean_std.<key>.*

Behind a conv stack, whatever reads its flatten has those input rows taken
from the JAX package's (h, w, c) order to the port's (c, h, w), and only
those: the first Dense of the MLP, every D2RL layer's skip columns, a core's
layer-0 input (``rnn.before_mlp``, or no MLP; ``concat_input``), the heads
(no MLP and no core; ``concat_output``). The resnet builder's extras after
the flatten stay where they are. Where the flatten feeds anything but the
MLP's first Dense, ``network=`` and ``input_shape=`` give the wiring and
its width.

A custom network converts by the same rules where its names are the
JAX package's: ``models/test_network.TestDictObsNet``'s

    params/mlp/Dense_{i}/Dense_0/*               -> a2c_network.mlp.{2i}.*
    params/{logits,value,aux_head}/Dense_0/*     -> a2c_network.{logits,value,aux_head}.*

and ``models/connect4_network.Connect4Net``'s params keep their names
(``stem``, ``n{b}a``, ``c{b}a``, ..., ``value``; the policy Linear's rows
permuted from the 2-channel conv's flatten); a NoisyLinear's or
NoisyFactorizedLinear's params (mu_w, mu_b, sigma_w, sigma_b) become the
port layer's (weight, bias, sigma_weight, sigma_bias).

The central value net's params and norm convert alike (the value head and
the trunks only). ``rnd_jax_to_state_dict`` converts RND's trees into the
port's ``RNDCuriosity`` state dict:

    target params/Dense_{i}/Dense_0/*           -> target.{2i}.*
    predictor params/MLP_0/Dense_{i}/Dense_0/*  -> predictor.0.{2i}.*
    predictor params/head/Dense_0/*             -> predictor.1.*
    rms {mean, var, count}                      -> running_mean_std.*

``sac_jax_to_state_dict`` converts the JAX package's SAC trees into the
sections of the reference SAC checkpoint, which the port's SAC networks use:

    actor  params/trunk/Dense_{i}/Dense_0/{kernel, bias} -> trunk.{2i}.*
           params/head/Dense_0/{kernel, bias}            -> trunk.{2n}.*
    critic params/Q{1,2}_trunk/Dense_{i}/Dense_0/*       -> Q{1,2}.{2i}.*
           params/Q{1,2}_head/Dense_0/*                  -> Q{1,2}.{2n}.*
    obs_rms {mean, var, count} -> running_mean_std.{running_mean, running_var, count}

and with ``network.normalization`` the trunks' LayerNorms too:

    params/trunk/LayerNorm_{i}/{scale, bias}       -> trunk.{3i + 2}.{weight, bias}
           (the Linears then at trunk.{3i}, the head at trunk.{3n}; the
           critic's Q{1,2}_trunk alike; a D2RL trunk's at
           trunk.0.norm_layers.{i})

``jax_slots_to_state_dict`` converts the JAX self-play env's opponent slots
({'params', 'norm'} with a leading env axis) into the port's stacked slots,
each env's by ``jax_to_state_dict``.

``ppo_jax_state`` and ``sac_jax_state`` map whole train states, as
``utils/jax_checkpoint`` decodes them from a JAX package's ``.ckpt``: the
weights and normalizers as above; optax's Adam state, found in its chain by
its fields (count, mu, nu), its moments through the same mapping as the
weights (Adam is elementwise); the counters, lr and entropy_coef, the RMS
advantage stats, the central value net and RND (PPO); log α, the three Adam
states and the replay ring (SAC). ``env_state``, ``rng``, ``obs``, the
meters and the recurrent carries are not carried: the random streams differ.

It reads only numpy arrays and plain attributes, so it needs neither JAX nor
the JAX package.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from rl_games_tpu_torch.models.layers import conv_output_dims, impala_output_dims
from rl_games_tpu_torch.models.network_builder import RNN_MODULE_NAMES, trunk_module_names


def _get(x, name):
    return x[name] if isinstance(x, dict) else getattr(x, name)


def _tensor(a, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _rms(stats, prefix: str = "") -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}running_mean": _tensor(_get(stats, "mean"), np.float32),
        f"{prefix}running_var": _tensor(_get(stats, "var"), np.float32),
        f"{prefix}count": _tensor(_get(stats, "count"), np.int32),
    }


def _numbered(tree, prefix: str):
    """Names in ``tree`` that start with ``prefix``, by their number."""
    return sorted((k for k in tree if k.startswith(prefix)), key=lambda s: int(s.rsplit("_", 1)[1]))


def _rows_as_is(i, kernel):
    return kernel


def _sequential(sd, tree, layer_prefix: str, port_prefix: str, rows_of=_rows_as_is):
    """Layers ``{layer_prefix}{i}`` and ``LayerNorm_{i}`` of a flax module
    into a port Sequential of [layer, activation[, LayerNorm]] per unit.
    ``rows_of(i, kernel)`` reorders the i-th flax Dense kernel's input rows
    (a conv's kernel is taken as it is); a Dense keeps its kernel and bias
    one level down (``Dense_0``)."""
    layers, norms = _numbered(tree, layer_prefix), _numbered(tree, "LayerNorm_")
    per_unit = 3 if norms else 2
    for i, name in enumerate(layers):
        layer = tree[name].get("Dense_0", tree[name])
        kernel = np.asarray(layer["kernel"])
        weight = _conv_weight(kernel) if kernel.ndim > 2 else rows_of(i, kernel).T
        sd[f"{port_prefix}.{per_unit * i}.weight"] = _tensor(weight, np.float32)
        sd[f"{port_prefix}.{per_unit * i}.bias"] = _tensor(layer["bias"], np.float32)
    for i, name in enumerate(norms):
        sd[f"{port_prefix}.{per_unit * i + 2}.weight"] = _tensor(tree[name]["scale"], np.float32)
        sd[f"{port_prefix}.{per_unit * i + 2}.bias"] = _tensor(tree[name]["bias"], np.float32)


def _conv_weight(kernel):
    """A flax conv kernel [kH, kW, I, O] (or [k, I, O]) as torch's [O, I, kH, kW]."""
    kernel = np.asarray(kernel)
    return kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.transpose(2, 1, 0)


def _d2rl(sd, tree, port_prefix: str, rows_of=_rows_as_is):
    """A flax D2RLMLP (``Dense_{i}/Dense_0``, ``LayerNorm_{i}``) into the
    port's ``linears.{i}`` and ``norm_layers.{i}``."""
    for i, name in enumerate(_numbered(tree, "Dense_")):
        layer = tree[name]["Dense_0"]
        sd[f"{port_prefix}.linears.{i}.weight"] = _tensor(rows_of(i, np.asarray(layer["kernel"])).T, np.float32)
        sd[f"{port_prefix}.linears.{i}.bias"] = _tensor(layer["bias"], np.float32)
    for i, name in enumerate(_numbered(tree, "LayerNorm_")):
        sd[f"{port_prefix}.norm_layers.{i}.weight"] = _tensor(tree[name]["scale"], np.float32)
        sd[f"{port_prefix}.norm_layers.{i}.bias"] = _tensor(tree[name]["bias"], np.float32)


def _dense(sd, layer, port_name: str, rows=None):
    """A flax Dense (bare, or a make_dense wrapper's ``Dense_0``) into a
    port Linear; ``rows`` reorders its kernel's input rows."""
    layer = layer.get("Dense_0", layer)
    kernel = np.asarray(layer["kernel"])
    sd[f"{port_name}.weight"] = _tensor((kernel if rows is None else rows(kernel)).T, np.float32)
    sd[f"{port_name}.bias"] = _tensor(layer["bias"], np.float32)


# flax's per-gate Dense names in the row order of the reference's tensors
_GATES = {"lstm": "ifgo", "gru": "rzn"}


def _rnn_core(sd, stack, port_prefix: str, input_rows=None):
    """A flax RNNCore's ``stack`` into the port's ``{port_prefix}.rnn.*``;
    ``input_rows`` reorders the rows of layer 0's input kernels."""
    for cell in _numbered(stack, ""):
        kind, k = cell.rsplit("_", 1)
        dense = stack[cell]
        gates = _GATES[kind]

        def rows(side):
            kernels = [np.asarray(dense[side + g]["kernel"]) for g in gates]
            if side == "i" and k == "0" and input_rows is not None:
                kernels = [input_rows(kernel) for kernel in kernels]
            return np.concatenate([kernel.T for kernel in kernels], axis=0)

        def biases(side, present):
            return np.concatenate([np.asarray(dense[side + g]["bias"]) if g in present
                                   else np.zeros(np.asarray(dense["h" + g]["kernel"]).shape[1], np.float32)
                                   for g in gates])

        base = f"{port_prefix}.rnn"
        sd[f"{base}.weight_ih_l{k}"] = _tensor(rows("i"), np.float32)
        sd[f"{base}.weight_hh_l{k}"] = _tensor(rows("h"), np.float32)
        if kind == "lstm":
            sd[f"{base}.bias_ih_l{k}"] = _tensor(biases("i", ""), np.float32)
            sd[f"{base}.bias_hh_l{k}"] = _tensor(biases("h", gates), np.float32)
        else:
            sd[f"{base}.bias_ih_l{k}"] = _tensor(biases("i", gates), np.float32)
            sd[f"{base}.bias_hh_l{k}"] = _tensor(biases("h", "n"), np.float32)


def _flatten_rows(kernel, channels: int, flat: int, offsets):
    """A kernel [in, out] whose rows at each of ``offsets`` hold a conv
    stack's flatten of ``flat`` features, those rows taken from the JAX
    package's (h, w, c) order to the port's (c, h, w): JAX row s·C + c is
    port row c·S + s. The other rows (an MLP's or a core's features, the
    resnet builder's extras) stay where they are."""
    kernel = np.array(kernel, copy=True)
    spatial = flat // channels
    for o in offsets:
        block = kernel[o:o + flat]
        kernel[o:o + flat] = block.reshape(spatial, channels, -1).transpose(1, 0, 2).reshape(block.shape)
    return kernel


def _impala(sd, tree, port_prefix: str):
    """A flax ImpalaCNN (``ImpalaSequential_{i}``) into the reference
    layout: ``{i}.conv.conv``, ``{i}.conv.bn``, ``{i}.res_block{1,2}.conv{1,2}``,
    ``.alpha``, and the attention gates ``.ca.fc{1,2}``, ``.sa.conv``."""
    def block(t, name):
        sd[f"{name}.conv.weight"] = _tensor(_conv_weight(t["Conv_0"]["kernel"]), np.float32)
        if "bias" in t["Conv_0"]:
            sd[f"{name}.conv.bias"] = _tensor(t["Conv_0"]["bias"], np.float32)
        if "FrozenBatchNorm_0" in t:
            bn = t["FrozenBatchNorm_0"]
            for jax_name, port_name in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                                        ("var", "running_var")):
                sd[f"{name}.bn.{port_name}"] = _tensor(bn[jax_name], np.float32)
            sd[f"{name}.bn.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    for i, stage in enumerate(_numbered(tree, "ImpalaSequential_")):
        t, name = tree[stage], f"{port_prefix}.{i}"
        block(t["ImpalaConvBlock_0"], f"{name}.conv")
        for r in (0, 1):
            res, res_name = t[f"ImpalaResidualBlock_{r}"], f"{name}.res_block{r + 1}"
            for c in (0, 1):
                block(res[f"ImpalaConvBlock_{c}"], f"{res_name}.conv{c + 1}")
            if "ChannelAttention_0" in res:
                ca = res["ChannelAttention_0"]
                for fc in ("fc1", "fc2"):
                    sd[f"{res_name}.ca.{fc}.weight"] = _tensor(np.asarray(ca[fc]["kernel"]).T, np.float32)
                sd[f"{res_name}.sa.conv.weight"] = _tensor(
                    _conv_weight(res["SpatialAttention_0"]["Conv_0"]["kernel"]), np.float32)
            if "alpha" in res:
                sd[f"{res_name}.alpha"] = _tensor(res["alpha"], np.float32)


def _flatten_size(cnn, network, input_shape, channels):
    """The conv stack's flatten width from the config and the observation
    shape, or None without them."""
    if network is None or input_shape is None:
        return None
    spatial = tuple(input_shape)[:-1]
    if "ImpalaSequential_0" in cnn:
        dims = impala_output_dims(len(_numbered(cnn, "ImpalaSequential_")), spatial)
    else:
        dims = conv_output_dims(network["cnn"]["convs"], spatial)
    return channels * math.prod(dims)


def _connect4(body) -> Dict[str, torch.Tensor]:
    """``models/connect4_network.Connect4Net``'s params, the names kept; the
    2-channel policy conv's flatten rows permuted into the policy Linear."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in body.items():
        if "kernel" not in tree:  # a GroupNorm
            sd[f"a2c_network.{name}.weight"] = _tensor(tree["scale"], np.float32)
            sd[f"a2c_network.{name}.bias"] = _tensor(tree["bias"], np.float32)
        elif np.asarray(tree["kernel"]).ndim == 4:
            sd[f"a2c_network.{name}.weight"] = _tensor(_conv_weight(tree["kernel"]), np.float32)
            sd[f"a2c_network.{name}.bias"] = _tensor(tree["bias"], np.float32)
        else:
            flat = np.asarray(tree["kernel"]).shape[0]
            rows = (lambda k: _flatten_rows(k, 2, flat, [0])) if name == "policy" else None
            _dense(sd, tree, f"a2c_network.{name}", rows)
    return sd


def _noisy(body) -> Dict[str, torch.Tensor]:
    """A flax NoisyLinear's or NoisyFactorizedLinear's params (mu_w [in, out],
    mu_b, sigma_w, sigma_b) as the port layer's (weight [out, in], bias,
    sigma_weight, sigma_bias)."""
    return {"weight": _tensor(np.asarray(body["mu_w"]).T, np.float32),
            "bias": _tensor(body["mu_b"], np.float32),
            "sigma_weight": _tensor(np.asarray(body["sigma_w"]).T, np.float32),
            "sigma_bias": _tensor(body["sigma_b"], np.float32)}


def _trunk_readers(body, trunk, rnn_cfg, units, flat, d2rl):
    """Where a trunk's flatten (``flat`` features) lies in the inputs of
    what reads it: {'mlp': offsets by MLP layer (a D2RL MLP's every layer),
    'rnn': offsets in the core's layer-0 input, 'head': offsets in the
    trunk's output}."""
    has_rnn = trunk + "rnn" in body or "name" in rnn_cfg
    before = bool(rnn_cfg.get("before_mlp", False))
    mlp_layers = len(units)

    def mlp_offsets(input_offsets):
        """Offsets per MLP layer when the MLP's input holds the flatten at
        ``input_offsets``: layer 0 reads the input, a D2RL layer i > 0 its
        features then the input."""
        later = [[units[i - 1] + o for o in input_offsets] if d2rl else [] for i in range(1, mlp_layers)]
        return [list(input_offsets)] + later

    readers = {"mlp": [[]] * mlp_layers, "rnn": [], "head": []}
    if not has_rnn:
        if mlp_layers:
            readers["mlp"] = mlp_offsets([0])
        else:
            readers["head"] = [0]
        return readers
    if body.get(trunk + "rnn") is None:
        raise ValueError(f"an identity core behind a conv stack ({trunk}) is not carried across")
    rnn_units = _rnn_units(body[trunk + "rnn"]["stack"])
    tail = [rnn_units] if rnn_cfg.get("concat_output", False) else []  # the core's output, then the flatten
    if before:
        readers["rnn"] = [0]
        if mlp_layers:
            readers["mlp"] = mlp_offsets(tail)
        else:
            readers["head"] = tail
        return readers
    if mlp_layers:
        readers["mlp"] = mlp_offsets([0])
        readers["rnn"] = [units[-1]] if rnn_cfg.get("concat_input", False) else []
    else:
        readers["rnn"] = [0, flat] if rnn_cfg.get("concat_input", False) else [0]
    readers["head"] = tail
    return readers


def _rnn_units(stack) -> int:
    cell = stack[_numbered(stack, "")[0]]
    return np.asarray(next(iter(cell.values()))["kernel"]).shape[1]


def jax_to_state_dict(params: Any, norm: Optional[Any] = None, network: Optional[dict] = None,
                      input_shape=None) -> Dict[str, torch.Tensor]:
    """State dict of the port's A2C model from JAX params/norm. ``network``
    is the config's ``network`` block where its options matter: its
    ``mlp.d2rl``; its ``cnn.type`` (a spatial soft arg-max flattens alike in
    both layouts, every other stack does not); and, with ``input_shape``
    (the observation's, channels last), where a conv stack's flatten feeds
    something other than the first Dense of an MLP: a recurrent core, the
    heads (no MLP), a D2RL MLP's skip columns, or a concatenation of the
    flatten (``rnn.concat_input`` / ``concat_output``). A connect4net's and
    a Noisy layer's params convert by their own names."""
    body = params["params"] if "params" in params else params
    if "mu_w" in body:
        return _noisy(body)
    if "stem" in body:
        return {**_connect4(body), **_norm_state(norm)}
    cnn_type = ((network or {}).get("cnn") or {}).get("type", "conv2d")
    d2rl = bool((network or {}).get("mlp", {}).get("d2rl", False))
    rnn_cfg = dict((network or {}).get("rnn") or {})
    sd: Dict[str, torch.Tensor] = {}
    separate = any(k.startswith("critic_") for k in body)
    head_rows = {}
    for trunk in ("actor_", "critic_"):
        cnn = body.get(trunk + "cnn")
        impala = cnn is not None and "ImpalaSequential_0" in cnn
        cnn_name, mlp_name = trunk_module_names(trunk, separate, impala)
        mlp = body.get(trunk + "mlp", {})
        readers, channels, flat = None, None, None
        if impala:
            _impala(sd, cnn, f"a2c_network.{cnn_name}")
            last = cnn[_numbered(cnn, "ImpalaSequential_")[-1]]
            channels = np.asarray(last["ImpalaConvBlock_0"]["Conv_0"]["kernel"]).shape[-1]
        elif cnn is not None:
            _sequential(sd, cnn, "Conv_", f"a2c_network.{cnn_name}")
            if cnn_type != "conv2d_spatial_softargmax":
                channels = np.asarray(cnn[_numbered(cnn, "Conv_")[-1]]["bias"]).shape[0]
        heads = ("mu", "value", "Dense_0", "logits_0", "sigma")
        read = mlp or trunk + "rnn" in body or any(h in body for h in heads)
        if channels is not None and read:
            units = [np.asarray(mlp[d]["Dense_0"]["kernel"]).shape[1] for d in _numbered(mlp, "Dense_")]
            flat = _flatten_size(cnn, network, input_shape, channels)
            known = network is not None or trunk + "rnn" not in body  # the core's wiring
            if flat is None and units and known and not rnn_cfg.get("before_mlp", False):
                # the MLP's first Dense reads the flatten alone
                flat = np.asarray(mlp[_numbered(mlp, "Dense_")[0]]["Dense_0"]["kernel"]).shape[0]
            if flat is None:
                raise ValueError(f"where the {trunk}cnn flatten goes depends on the config: pass network= and "
                                 "input_shape= to carry it across")
            readers = _trunk_readers(body, trunk, rnn_cfg, units, flat, d2rl)

        def rows_of(i, kernel, readers=readers, channels=channels, flat=flat):
            if readers is None or not readers["mlp"][i]:
                return kernel
            return _flatten_rows(kernel, channels, flat, readers["mlp"][i])

        if readers is not None and readers["head"]:
            head_rows[trunk] = lambda k, r=readers, c=channels, f=flat: _flatten_rows(k, c, f, r["head"])
        if trunk + "rnn" in body or trunk + "rnn_ln" in body:  # an identity core has no params
            core, norm_name = RNN_MODULE_NAMES[(trunk, separate)]
            if trunk + "rnn" in body:
                input_rows = None
                if readers is not None and readers["rnn"]:
                    input_rows = lambda k, r=readers, c=channels, f=flat: _flatten_rows(k, c, f, r["rnn"])  # noqa: E731
                _rnn_core(sd, body[trunk + "rnn"]["stack"], f"a2c_network.{core}", input_rows)
            if trunk + "rnn_ln" in body:
                ln = body[trunk + "rnn_ln"]
                sd[f"a2c_network.{norm_name}.weight"] = _tensor(ln["scale"], np.float32)
                sd[f"a2c_network.{norm_name}.bias"] = _tensor(ln["bias"], np.float32)
        if d2rl:
            _d2rl(sd, mlp, f"a2c_network.{mlp_name}", rows_of)
        else:
            _sequential(sd, mlp, "Dense_", f"a2c_network.{mlp_name}", rows_of)
    actor_rows = head_rows.get("actor_")
    critic_rows = head_rows.get("critic_" if separate else "actor_")
    for jax_name, port_name, rows in (("mu", "mu", actor_rows), ("value", "value", critic_rows),
                                      ("Dense_0", "logits", actor_rows)):
        if jax_name in body:
            _dense(sd, body[jax_name], f"a2c_network.{port_name}", rows)
    for i, name in enumerate(_numbered(body, "logits_")):
        _dense(sd, body[name], f"a2c_network.logits.{i}", actor_rows)
    if "sigma" in body:
        if isinstance(body["sigma"], dict):  # the state-dependent head, a bare nn.Dense
            _dense(sd, body["sigma"], "a2c_network.sigma", actor_rows)
        else:
            sd["a2c_network.sigma"] = _tensor(body["sigma"], np.float32)
    if "mlp" in body:  # a custom network's (TestDictObsNet)
        _sequential(sd, body["mlp"], "Dense_", "a2c_network.mlp")
    for name in ("logits", "aux_head"):
        if name in body:
            _dense(sd, body[name], f"a2c_network.{name}")
    sd.update(_norm_state(norm))
    return sd


def _norm_state(norm) -> Dict[str, torch.Tensor]:
    """The JAX NormState's input and value normalizers."""
    sd: Dict[str, torch.Tensor] = {}
    if norm is None:
        return sd
    obs_norm = _get(norm, "obs")
    # one set of stats per key of a dict observation (a checkpoint's decoded
    # RunningMeanStdState is itself a dict of its three fields)
    if isinstance(obs_norm, dict) and set(obs_norm) != {"mean", "var", "count"}:
        for key, stats in obs_norm.items():
            sd.update(_rms(stats, f"running_mean_std.running_mean_std.{key}."))
    elif obs_norm is not None:
        sd.update(_rms(obs_norm, "running_mean_std."))
    if _get(norm, "value") is not None:
        sd.update(_rms(_get(norm, "value"), "value_mean_std."))
    return sd


def _sac_sequential(body, trunk: str, head: str, prefix: str, d2rl: bool = False) -> Dict[str, torch.Tensor]:
    """A flax trunk (``Dense_{i}/Dense_0``, ``LayerNorm_{i}``) and head
    (``Dense_0``) as one Sequential of [Linear, activation[, LayerNorm]] per
    unit, then the head's Linear; a D2RL trunk as ``{prefix}0.linears.{i}``
    (and ``.norm_layers.{i}``) and the head as ``{prefix}1``."""
    sd: Dict[str, torch.Tensor] = {}
    if d2rl:
        _d2rl(sd, body[trunk], prefix + "0")
        _dense(sd, body[head]["Dense_0"], prefix + "1")
        return sd
    tree = body[trunk]
    _sequential(sd, tree, "Dense_", prefix[:-1])
    per_unit = 3 if _numbered(tree, "LayerNorm_") else 2
    _dense(sd, body[head]["Dense_0"], f"{prefix}{per_unit * len(_numbered(tree, 'Dense_'))}")
    return sd


def sac_jax_to_state_dict(actor_params: Any, critic_params: Any = None,
                          critic_target_params: Any = None,
                          obs_rms: Optional[Any] = None, d2rl: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference SAC checkpoint's sections ({'actor', 'critic',
    'critic_target', 'running_mean_std'}, each a state_dict) from the JAX
    package's SAC trees; a section whose tree is None is left out. Any tree
    of the params' structure converts alike (e.g. Adam's moments).
    ``d2rl`` is the config's ``mlp.d2rl``."""
    def body(tree):
        return tree["params"] if "params" in tree else tree

    def critic(tree):
        b = body(tree)
        return {**_sac_sequential(b, "Q1_trunk", "Q1_head", "Q1.", d2rl),
                **_sac_sequential(b, "Q2_trunk", "Q2_head", "Q2.", d2rl)}

    out = {"actor": _sac_sequential(body(actor_params), "trunk", "head", "trunk.", d2rl)}
    if critic_params is not None:
        out["critic"] = critic(critic_params)
    if critic_target_params is not None:
        out["critic_target"] = critic(critic_target_params)
    if obs_rms is not None:
        out["running_mean_std"] = _rms(obs_rms)
    return out


def rnd_jax_to_state_dict(target_params: Any, pred_params: Any, rms: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """The port's ``RNDCuriosity`` state dict from the JAX package's RND
    target and predictor params and RND's normalizer state."""
    def body(tree):
        return tree["params"] if "params" in tree else tree

    sd: Dict[str, torch.Tensor] = {}
    target, pred = body(target_params), body(pred_params)
    for i, name in enumerate(_numbered(target, "Dense_")):
        _dense(sd, target[name]["Dense_0"], f"target.{2 * i}")
    hidden = pred.get("MLP_0", {})
    for i, name in enumerate(_numbered(hidden, "Dense_")):
        _dense(sd, hidden[name]["Dense_0"], f"predictor.0.{2 * i}")
    _dense(sd, pred["head"]["Dense_0"], "predictor.1")
    if rms is not None:
        sd.update(_rms(rms, "running_mean_std."))
    return sd


def _index(tree, i: int):
    """Entry ``i`` of every leaf of a tree of dicts, dataclasses and arrays
    with a leading env axis."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _index(getattr(tree, f.name), i) for f in dataclasses.fields(tree)})
    return np.asarray(tree)[i]


def jax_slots_to_state_dict(opp_weights: Any, network: Optional[dict] = None,
                            input_shape=None) -> Dict[str, torch.Tensor]:
    """The JAX package's self-play opponent slots (``SelfPlayVecEnvState.
    opp_weights``: {'params', 'norm'}, each leaf with a leading env axis,
    numpy) as the port's (``envs/device/selfplay.SelfPlayVecEnvState.
    opp_weights``): each key of the model's ``state_dict`` stacked [N, ...],
    every env's slot converted as ``jax_to_state_dict`` converts one."""
    first = opp_weights["params"]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    per_env = [jax_to_state_dict(_index(opp_weights["params"], i), _index(opp_weights["norm"], i), network,
                                 input_shape) for i in range(np.asarray(first).shape[0])]
    return {k: torch.stack([sd[k] for sd in per_env]) for k in per_env[0]}


# ---------------------------------------------------------------------------
# Whole train states from a JAX package checkpoint (utils/jax_checkpoint.py
# decodes them into nested dicts of numpy arrays)
# ---------------------------------------------------------------------------


def find_adam_state(opt_tree):
    """optax's ScaleByAdamState inside an optimizer chain's state: the entry
    with the fields count, mu and nu, wherever the chain put it (its index
    depends on truncate_grads and weight_decay, ppo.py:436-447; optax.adam is
    itself a chain). None where there is none."""
    if isinstance(opt_tree, dict):
        if {"count", "mu", "nu"} <= set(opt_tree):
            return opt_tree
        for v in opt_tree.values():
            found = find_adam_state(v)
            if found is not None:
                return found
    return None


def jax_adam(opt_tree, convert) -> Dict[str, Any]:
    """{'count', 'mu', 'nu'} of the Adam state in an optax chain's state;
    ``convert`` maps a tree of the params' structure (a moment) to the
    port's names. Adam is elementwise, so a moment takes the same transposes
    and row permutations as the weights."""
    adam = find_adam_state(opt_tree)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam state (count, mu, nu)")
    return {"count": _tensor(adam["count"], np.int32), "mu": convert(adam["mu"]), "nu": convert(adam["nu"])}


def jax_weights_to_state_dict(weights, network: Optional[dict] = None, input_shape=None) -> Dict[str, torch.Tensor]:
    """The port's A2C ``state_dict`` from a checkpoint's weights section
    ({'params', 'norm'})."""
    return jax_to_state_dict(weights["params"], weights.get("norm"), network, input_shape)


def _gms(stats) -> Optional[Dict[str, torch.Tensor]]:
    if stats is None:
        return None
    return {"low": _tensor(stats["low"], np.float32), "high": _tensor(stats["high"], np.float32),
            "step": _tensor(stats["step"], np.int32)}


def ppo_jax_state(tree, network: Optional[dict] = None, input_shape=None, cv_network: Optional[dict] = None,
                  cv_input_shape=None) -> Dict[str, Any]:
    """What a ``PPOTrainState`` (rl_games_tpu/algos/ppo.py:104-132) carries
    into the port: {'model': the A2C state_dict, 'opt': its Adam state
    ({'count', 'mu', 'nu'}, the moments by parameter name), 'lr',
    'entropy_coef', 'epoch', 'frame', 'adv_rms' ({'low', 'high', 'step'}),
    'cv_model' / 'cv_opt' (the central value net's state_dict and Adam
    state), 'rnd' / 'rnd_opt' (RND's state_dict and its predictor's Adam
    state)}, None where the JAX state has none. ``env_state``, ``rng``,
    ``obs``, ``dones``, the meters and the recurrent carries stay behind:
    the random streams differ, so the port resets its own."""
    def model(t):
        return jax_to_state_dict(t, None, network, input_shape)

    out = {
        "model": jax_to_state_dict(tree["params"], tree.get("norm"), network, input_shape),
        "opt": jax_adam(tree["opt_state"], model),
        "lr": _tensor(tree["lr"], np.float32),
        "entropy_coef": _tensor(tree["entropy_coef"], np.float32),
        "epoch": int(tree["epoch"]),
        "frame": int(tree["frame"]),
        "adv_rms": _gms(tree.get("adv_rms")),
        "cv_model": None, "cv_opt": None, "rnd": None, "rnd_opt": None,
    }
    if tree.get("cv_params") is not None:
        def cv(t):
            return jax_to_state_dict(t, None, cv_network, cv_input_shape)

        out["cv_model"] = jax_to_state_dict(tree["cv_params"], tree.get("cv_norm"), cv_network, cv_input_shape)
        out["cv_opt"] = jax_adam(tree["cv_opt"], cv)
    if tree.get("rnd_pred") is not None:
        def predictor(t):
            return {k: v for k, v in rnd_jax_to_state_dict(tree["rnd_target"], t).items()
                    if k.startswith("predictor.")}

        out["rnd"] = rnd_jax_to_state_dict(tree["rnd_target"], tree["rnd_pred"], tree.get("rnd_rms"))
        out["rnd_opt"] = jax_adam(tree["rnd_opt"], predictor)
    return out


def sac_jax_weights_to_sections(weights, network: Optional[dict] = None) -> Dict[str, Any]:
    """The reference SAC checkpoint's sections ({'actor', 'critic',
    'running_mean_std'}) from a JAX SAC checkpoint's weights section
    ({'actor_params', 'critic_params', 'obs_rms'})."""
    d2rl = bool((network or {}).get("mlp", {}).get("d2rl", False))
    return sac_jax_to_state_dict(weights["actor_params"], weights["critic_params"],
                                 obs_rms=weights.get("obs_rms"), d2rl=d2rl)


def sac_jax_state(tree, network: Optional[dict] = None) -> Dict[str, Any]:
    """What a ``SACTrainState`` (rl_games_tpu/algos/sac.py:146-165) carries
    into the port: {'sections': the reference SAC checkpoint's sections
    ('actor', 'critic', 'critic_target', 'log_alpha', 'running_mean_std'),
    'actor_opt' / 'critic_opt' (Adam states, the moments by parameter name),
    'alpha_opt' (its moments as one-element lists), 'replay' (the ring's
    arrays as tensors, its cursor and fill flag as Python values), 'epoch',
    'frame', 'update_counter'}. ``env_state``, ``rng``, ``obs`` and the meters
    stay behind, as for PPO."""
    d2rl = bool((network or {}).get("mlp", {}).get("d2rl", False))
    actor = tree["actor_params"]
    sections = sac_jax_to_state_dict(actor, tree["critic_params"], tree["critic_target_params"],
                                     tree.get("obs_rms"), d2rl)
    sections["log_alpha"] = _tensor(tree["log_alpha"], np.float32)
    alpha = find_adam_state(tree["alpha_opt"])
    replay = tree["replay"]
    return {
        "sections": sections,
        "actor_opt": jax_adam(tree["actor_opt"], lambda t: sac_jax_to_state_dict(t, d2rl=d2rl)["actor"]),
        "critic_opt": jax_adam(tree["critic_opt"],
                               lambda t: sac_jax_to_state_dict(actor, t, d2rl=d2rl)["critic"]),
        "alpha_opt": {"count": _tensor(alpha["count"], np.int32), "mu": [_tensor(alpha["mu"], np.float32)],
                      "nu": [_tensor(alpha["nu"], np.float32)]},
        "replay": {**{k: _tensor(replay[k]) for k in ("obses", "next_obses", "actions", "rewards", "dones",
                                                     "truncated")},
                   "idx": int(replay["idx"]), "full": bool(replay["full"])},
        "epoch": int(tree["epoch"]),
        "frame": int(tree["frame"]),
        "update_counter": int(tree["update_counter"]),
    }
