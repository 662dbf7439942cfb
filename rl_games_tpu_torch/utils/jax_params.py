"""Carry weights from the JAX package into the port.

``jax_to_state_dict`` converts the JAX package's A2C parameter tree (nested
dicts of numpy arrays, flax layout) and its ``NormState`` (numpy leaves)
into a ``state_dict`` of the port's A2C models, which use the reference
checkpoint layout:

    params/{actor,critic}_cnn/Conv_{i}/{kernel [kH,kW,I,O], bias}
        -> a2c_network.{actor,critic}_cnn.{k}.{weight [O,I,kH,kW], bias}
           (k counts the Sequential's modules: Conv, activation[, LayerNorm])
    params/{actor,critic}_cnn/LayerNorm_{i}/{scale, bias} -> ..._cnn.{k}.{weight, bias}
    params/{actor,critic}_mlp/Dense_{i}/Dense_0/{kernel [in,out], bias}
        -> a2c_network.{actor,critic}_mlp.{k}.{weight [out,in], bias}
           (after a conv stack the first one's input rows go from the JAX
           package's (h, w, c) flatten to the port's (c, h, w) flatten;
           a D2RL MLP's go to ..._mlp.linears.{i})
    params/{actor,critic}_mlp/LayerNorm_{i}/{scale, bias}
        -> ..._mlp.{k}.{weight, bias} (a D2RL MLP's: ..._mlp.norm_layers.{i})
    params/{mu,value}/Dense_0/{kernel, bias}     -> a2c_network.{mu,value}.*
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

A custom network converts by the same rules where its names are the
JAX package's: ``models/test_network.TestDictObsNet``'s

    params/mlp/Dense_{i}/Dense_0/*               -> a2c_network.mlp.{2i}.*
    params/{logits,value,aux_head}/Dense_0/*     -> a2c_network.{logits,value,aux_head}.*

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

It reads only numpy arrays and plain attributes, so it needs neither JAX nor
the JAX package.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from rl_games_tpu_torch.models.network_builder import RNN_MODULE_NAMES


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


def _sequential(sd, tree, layer_prefix: str, port_prefix: str, weight_of):
    """Layers ``{layer_prefix}{i}`` and ``LayerNorm_{i}`` of a flax module
    into a port Sequential of [layer, activation[, LayerNorm]] per unit.
    ``weight_of(i, kernel)`` maps the i-th flax kernel to the port's weight;
    a Dense keeps its kernel and bias one level down (``Dense_0``)."""
    layers, norms = _numbered(tree, layer_prefix), _numbered(tree, "LayerNorm_")
    per_unit = 3 if norms else 2
    for i, name in enumerate(layers):
        layer = tree[name].get("Dense_0", tree[name])
        sd[f"{port_prefix}.{per_unit * i}.weight"] = _tensor(weight_of(i, np.asarray(layer["kernel"])), np.float32)
        sd[f"{port_prefix}.{per_unit * i}.bias"] = _tensor(layer["bias"], np.float32)
    for i, name in enumerate(norms):
        sd[f"{port_prefix}.{per_unit * i + 2}.weight"] = _tensor(tree[name]["scale"], np.float32)
        sd[f"{port_prefix}.{per_unit * i + 2}.bias"] = _tensor(tree[name]["bias"], np.float32)


def _d2rl(sd, tree, port_prefix: str):
    """A flax D2RLMLP (``Dense_{i}/Dense_0``, ``LayerNorm_{i}``) into the
    port's ``linears.{i}`` and ``norm_layers.{i}``."""
    for i, name in enumerate(_numbered(tree, "Dense_")):
        layer = tree[name]["Dense_0"]
        sd[f"{port_prefix}.linears.{i}.weight"] = _tensor(np.asarray(layer["kernel"]).T, np.float32)
        sd[f"{port_prefix}.linears.{i}.bias"] = _tensor(layer["bias"], np.float32)
    for i, name in enumerate(_numbered(tree, "LayerNorm_")):
        sd[f"{port_prefix}.norm_layers.{i}.weight"] = _tensor(tree[name]["scale"], np.float32)
        sd[f"{port_prefix}.norm_layers.{i}.bias"] = _tensor(tree[name]["bias"], np.float32)


def _dense(sd, layer, port_name: str):
    sd[f"{port_name}.weight"] = _tensor(np.asarray(layer["kernel"]).T, np.float32)
    sd[f"{port_name}.bias"] = _tensor(layer["bias"], np.float32)


# flax's per-gate Dense names in the row order of the reference's tensors
_GATES = {"lstm": "ifgo", "gru": "rzn"}


def _rnn_core(sd, stack, port_prefix: str):
    """A flax RNNCore's ``stack`` into the port's ``{port_prefix}.rnn.*``."""
    for cell in _numbered(stack, ""):
        kind, k = cell.rsplit("_", 1)
        dense = stack[cell]
        gates = _GATES[kind]

        def rows(side):
            return np.concatenate([np.asarray(dense[side + g]["kernel"]).T for g in gates], axis=0)

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


def jax_to_state_dict(params: Any, norm: Optional[Any] = None,
                      cnn_type: str = "conv2d", d2rl: bool = False) -> Dict[str, torch.Tensor]:
    """State dict of the port's A2C model from JAX params/norm. ``cnn_type``
    is the conv stack's ``cnn.type`` where there is one: a spatial soft
    arg-max flattens alike in both layouts, every other stack does not.
    ``d2rl`` is the config's ``mlp.d2rl``."""
    body = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for trunk in ("actor_", "critic_"):
        channels = None
        if trunk + "cnn" in body:
            cnn = body[trunk + "cnn"]
            _sequential(sd, cnn, "Conv_", f"a2c_network.{trunk}cnn", lambda i, kernel: (
                kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.transpose(2, 1, 0)))
            if cnn_type != "conv2d_spatial_softargmax":
                channels = np.asarray(cnn[_numbered(cnn, "Conv_")[-1]]["bias"]).shape[0]

        def dense_weight(i, kernel, channels=channels):  # kernel [in, out]
            if i == 0 and channels is not None:
                # JAX input row s * C + c (spatial-major) -> port column c * S + s
                spatial = kernel.shape[0] // channels
                kernel = kernel.reshape(spatial, channels, -1).transpose(1, 0, 2).reshape(kernel.shape)
            return kernel.T

        if trunk + "rnn" in body or trunk + "rnn_ln" in body:  # an identity core has no params
            separate = any(k.startswith("critic_") for k in body)
            core, norm_name = RNN_MODULE_NAMES[(trunk, separate)]
            if trunk + "rnn" in body:
                _rnn_core(sd, body[trunk + "rnn"]["stack"], f"a2c_network.{core}")
            if trunk + "rnn_ln" in body:
                ln = body[trunk + "rnn_ln"]
                sd[f"a2c_network.{norm_name}.weight"] = _tensor(ln["scale"], np.float32)
                sd[f"a2c_network.{norm_name}.bias"] = _tensor(ln["bias"], np.float32)
        mlp = body.get(trunk + "mlp", {})
        heads = ("mu", "value", "Dense_0", "logits_0")
        if channels is not None and not _numbered(mlp, "Dense_") and any(h in body for h in heads):
            raise NotImplementedError("a conv stack with no mlp after it: the flatten's permutation "
                                      "would land on a head")
        if d2rl:
            if channels is not None:
                # every layer's skip input is the flatten too
                raise NotImplementedError("a D2RL MLP after a conv stack: the flatten's permutation "
                                          "would apply to every layer's skip columns")
            _d2rl(sd, mlp, f"a2c_network.{trunk}mlp")
        else:
            _sequential(sd, mlp, "Dense_", f"a2c_network.{trunk}mlp", dense_weight)
    for jax_name, port_name in {"mu": "mu", "value": "value", "Dense_0": "logits"}.items():
        if jax_name in body:
            _dense(sd, body[jax_name]["Dense_0"], f"a2c_network.{port_name}")
    for i, name in enumerate(_numbered(body, "logits_")):
        _dense(sd, body[name]["Dense_0"], f"a2c_network.logits.{i}")
    if "sigma" in body:
        if isinstance(body["sigma"], dict):  # the state-dependent head, a bare nn.Dense
            _dense(sd, body["sigma"], "a2c_network.sigma")
        else:
            sd["a2c_network.sigma"] = _tensor(body["sigma"], np.float32)
    if "mlp" in body:  # a custom network's (TestDictObsNet)
        _sequential(sd, body["mlp"], "Dense_", "a2c_network.mlp", lambda i, kernel: kernel.T)
    for name in ("logits", "aux_head"):
        if name in body:
            _dense(sd, body[name]["Dense_0"], f"a2c_network.{name}")
    if norm is not None:
        obs_norm = _get(norm, "obs")
        if isinstance(obs_norm, dict):  # one set of stats per key of a dict observation
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
    _sequential(sd, tree, "Dense_", prefix[:-1], lambda i, kernel: kernel.T)
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
