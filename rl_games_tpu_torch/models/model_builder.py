"""Model/network registries and builder.

Port of rl_games_tpu/models/model_builder.py (the reference's
model_builder.py:9-60) for the two models ported so far,
``continuous_a2c_logstd`` and ``discrete_a2c``, over the ``actor_critic``
torso.
``ModelBuilder.load(params)`` builds the torso from ``params['network']``
and wraps it with the model named by ``params['model']['name']``.
"""

from typing import Callable, Dict

from rl_games_tpu_torch.models import models
from rl_games_tpu_torch.models.network_builder import A2CNetwork

NETWORK_REGISTRY: Dict[str, Callable] = {}
MODEL_REGISTRY: Dict[str, Callable] = {}


def register_network(name: str, builder: Callable):
    NETWORK_REGISTRY[name] = builder


def register_model(name: str, builder: Callable):
    MODEL_REGISTRY[name] = builder


register_network("actor_critic", A2CNetwork)


def _model_factory(model_cls):
    """A builder of ``model_cls`` over the registered torso that
    ``network_params['name']`` names (model_builder.py ``_model_factory``)."""

    def build(network_params, *, actions_num, input_shape, value_size=1,
              normalize_input=False, normalize_value=False, obs_shape=None, device=None):
        name = network_params["name"]
        if name not in NETWORK_REGISTRY:
            raise NotImplementedError(f"network '{name}' is not ported yet (see ROADMAP.md)")
        network = NETWORK_REGISTRY[name](
            network_params, actions_num, input_shape, value_size, device=device
        )
        kwargs = {}
        if model_cls.is_continuous:
            kwargs["space_cfg"] = network_params.get("space", {}).get("continuous", {})
        return model_cls(
            network,
            obs_shape=obs_shape if obs_shape is not None else tuple(input_shape),
            normalize_input=normalize_input,
            normalize_value=normalize_value,
            value_size=value_size,
            device=device,
            **kwargs,
        )

    return build


register_model("continuous_a2c_logstd", _model_factory(models.ModelA2CContinuousLogStd))
register_model("discrete_a2c", _model_factory(models.ModelA2C))


class ModelBuilder:
    """model_builder.py:53-60."""

    def load(self, params: dict, **build_kwargs):
        model_name = params["model"]["name"]
        if model_name not in MODEL_REGISTRY:
            raise NotImplementedError(
                f"model '{model_name}' is not ported yet (see ROADMAP.md)"
            )
        return MODEL_REGISTRY[model_name](dict(params["network"]), **build_kwargs)
