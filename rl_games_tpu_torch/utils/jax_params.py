"""Carry weights from the JAX package into the port.

``jax_to_state_dict`` converts the JAX package's A2C parameter tree (nested
dicts of numpy arrays, flax layout) and its ``NormState`` (numpy leaves)
into a ``state_dict`` of the port's A2C models, which use the reference
checkpoint layout:

    params/actor_cnn/Conv_{i}/{kernel [kH,kW,I,O], bias}
        -> a2c_network.actor_cnn.{k}.{weight [O,I,kH,kW], bias}
           (k counts the Sequential's modules: Conv, activation[, LayerNorm])
    params/actor_cnn/LayerNorm_{i}/{scale, bias} -> actor_cnn.{k}.{weight, bias}
    params/actor_mlp/Dense_{i}/Dense_0/{kernel [in,out], bias}
        -> a2c_network.actor_mlp.{k}.{weight [out,in], bias}
           (after a conv stack the first one's input rows go from the JAX
           package's (h, w, c) flatten to the port's (c, h, w) flatten)
    params/actor_mlp/LayerNorm_{i}/{scale, bias} -> actor_mlp.{k}.{weight, bias}
    params/{mu,value}/Dense_0/{kernel, bias}     -> a2c_network.{mu,value}.*
    params/Dense_0/Dense_0/{kernel, bias}        -> a2c_network.logits.* (discrete)
    params/sigma [A]                             -> a2c_network.sigma
    norm.obs / norm.value {mean, var, count}     -> running_mean_std.* /
        value_mean_std.{running_mean, running_var, count}

It reads only numpy arrays and plain attributes, so it needs neither JAX nor
the JAX package.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch


def _get(x, name):
    return x[name] if isinstance(x, dict) else getattr(x, name)


def _tensor(a, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _rms(prefix: str, stats) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.running_mean": _tensor(_get(stats, "mean"), np.float32),
        f"{prefix}.running_var": _tensor(_get(stats, "var"), np.float32),
        f"{prefix}.count": _tensor(_get(stats, "count"), np.int32),
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


def jax_to_state_dict(params: Any, norm: Optional[Any] = None,
                      cnn_type: str = "conv2d") -> Dict[str, torch.Tensor]:
    """State dict of the port's A2C model from JAX params/norm. ``cnn_type``
    is the conv stack's ``cnn.type`` where there is one: a spatial soft
    arg-max flattens alike in both layouts, every other stack does not."""
    body = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    channels = None
    if "actor_cnn" in body:
        cnn = body["actor_cnn"]
        _sequential(sd, cnn, "Conv_", "a2c_network.actor_cnn",
                    lambda i, kernel: kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.transpose(2, 1, 0))
        if cnn_type != "conv2d_spatial_softargmax":
            channels = np.asarray(cnn[_numbered(cnn, "Conv_")[-1]]["bias"]).shape[0]

    def dense_weight(i, kernel):  # kernel [in, out]
        if i == 0 and channels is not None:
            # JAX input row s * C + c (spatial-major) -> port column c * S + s
            spatial = kernel.shape[0] // channels
            kernel = kernel.reshape(spatial, channels, -1).transpose(1, 0, 2).reshape(kernel.shape)
        return kernel.T

    mlp = body.get("actor_mlp", {})
    heads = {"mu": "mu", "value": "value", "Dense_0": "logits"}
    if channels is not None and not _numbered(mlp, "Dense_") and any(h in body for h in heads):
        raise NotImplementedError("a conv stack with no mlp after it: the flatten's permutation "
                                  "would land on a head")
    _sequential(sd, mlp, "Dense_", "a2c_network.actor_mlp", dense_weight)
    for jax_name, port_name in heads.items():
        if jax_name in body:
            layer = body[jax_name]["Dense_0"]
            sd[f"a2c_network.{port_name}.weight"] = _tensor(np.asarray(layer["kernel"]).T, np.float32)
            sd[f"a2c_network.{port_name}.bias"] = _tensor(layer["bias"], np.float32)
    if "sigma" in body:
        sd["a2c_network.sigma"] = _tensor(body["sigma"], np.float32)
    if norm is not None:
        if _get(norm, "obs") is not None:
            sd.update(_rms("running_mean_std", _get(norm, "obs")))
        if _get(norm, "value") is not None:
            sd.update(_rms("value_mean_std", _get(norm, "value")))
    return sd
