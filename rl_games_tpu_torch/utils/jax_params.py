"""Carry weights from the JAX package into the port.

``jax_to_state_dict`` converts the JAX package's A2C parameter tree (nested
dicts of numpy arrays, flax layout) and its ``NormState`` (numpy leaves)
into a ``state_dict`` of the port's ``ModelA2CContinuousLogStd``, which
uses the reference checkpoint layout:

    params/actor_mlp/Dense_{i}/Dense_0/{kernel [in,out], bias}
        -> a2c_network.actor_mlp.{k}.{weight [out,in], bias}
           (k counts the Sequential's modules: Linear, activation[, LayerNorm])
    params/actor_mlp/LayerNorm_{i}/{scale, bias} -> actor_mlp.{k}.{weight, bias}
    params/{mu,value}/Dense_0/{kernel, bias}     -> a2c_network.{mu,value}.*
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


def jax_to_state_dict(params: Any, norm: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """State dict of the port's continuous A2C model from JAX params/norm."""
    body = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    mlp = body.get("actor_mlp", {})
    dense = sorted((k for k in mlp if k.startswith("Dense_")), key=lambda s: int(s.split("_")[1]))
    norms = sorted((k for k in mlp if k.startswith("LayerNorm_")), key=lambda s: int(s.split("_")[1]))
    per_unit = 3 if norms else 2
    for i, name in enumerate(dense):
        layer = mlp[name]["Dense_0"]
        sd[f"a2c_network.actor_mlp.{per_unit * i}.weight"] = _tensor(np.asarray(layer["kernel"]).T, np.float32)
        sd[f"a2c_network.actor_mlp.{per_unit * i}.bias"] = _tensor(layer["bias"], np.float32)
    for i, name in enumerate(norms):
        sd[f"a2c_network.actor_mlp.{per_unit * i + 2}.weight"] = _tensor(mlp[name]["scale"], np.float32)
        sd[f"a2c_network.actor_mlp.{per_unit * i + 2}.bias"] = _tensor(mlp[name]["bias"], np.float32)
    for head in ("mu", "value"):
        layer = body[head]["Dense_0"]
        sd[f"a2c_network.{head}.weight"] = _tensor(np.asarray(layer["kernel"]).T, np.float32)
        sd[f"a2c_network.{head}.bias"] = _tensor(layer["bias"], np.float32)
    sd["a2c_network.sigma"] = _tensor(body["sigma"], np.float32)
    if norm is not None:
        if _get(norm, "obs") is not None:
            sd.update(_rms("running_mean_std", _get(norm, "obs")))
        if _get(norm, "value") is not None:
            sd.update(_rms("value_mean_std", _get(norm, "value")))
    return sd
