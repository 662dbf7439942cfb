"""Model/network registries and builder.

Port of rl_games_tpu/models/model_builder.py (the reference's
model_builder.py:9-60) for the policy models over the registered torsos:
``continuous_a2c_logstd``, ``continuous_a2c``, ``continuous_a2c_tanh``,
``discrete_a2c``, ``multi_discrete_a2c`` and the value-only
``central_value``; the torsos ``actor_critic`` and ``resnet_actor_critic``
(the same ``A2CNetwork`` with ``cnn.type`` set to ``impala``, :31-38).
``network.name: rnd_curiosity`` raises the JAX package's ValueError (RND is
configured through ``rnd_config``, :41-51).
``ModelBuilder.load(params)`` builds the torso from ``params['network']``
and wraps it with the model named by ``params['model']['name']``. A network
builder is called in the JAX package's keyword form, ``build(net_params, *,
actions_num, input_shape, value_size, device)``, so a custom network
(``models/test_network.py``, ``models/connect4_network.py``) registers with
``register_network``. The torso's input shape is the 'obs' entry of a dict
observation that has one (algos/ppo.py:301-303, common/player.py:58-68);
the model's normalizer takes the whole observation shape. An unknown
network or model name is a KeyError, as in the JAX package.
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


def _build_resnet_network(net_params, **kwargs):
    """'resnet_actor_critic' (network_builder.py:691-916): A2CNetwork with
    cnn.type set to impala."""
    return A2CNetwork({**net_params, "cnn": {**(net_params.get("cnn") or {}), "type": "impala"}}, **kwargs)


def _build_rnd_curiosity(net_params, **kwargs):
    """'rnd_curiosity' names no policy torso, in the reference (its class is
    missing from its tree) or here: RND is configured through rnd_config."""
    raise ValueError(
        "'rnd_curiosity' is not a policy network: configure RND through "
        "config.rnd_config (whose network block models/rnd.RNDCuriosity "
        "consumes); see docs/CONFIG_PARAMETERS.md"
    )


register_network("actor_critic", A2CNetwork)
register_network("resnet_actor_critic", _build_resnet_network)
register_network("rnd_curiosity", _build_rnd_curiosity)


def _model_factory(model_cls):
    """A builder of ``model_cls`` over the registered torso that
    ``network_params['name']`` names (model_builder.py ``_model_factory``)."""

    def build(network_params, *, actions_num, input_shape, value_size=1,
              normalize_input=False, normalize_value=False, obs_shape=None, device=None):
        name = network_params["name"]
        net_shape = input_shape["obs"] if isinstance(input_shape, dict) and "obs" in input_shape else input_shape
        network = NETWORK_REGISTRY[name](network_params, actions_num=actions_num, input_shape=net_shape,
                                         value_size=value_size, device=device)
        kwargs = {}
        if model_cls in (models.ModelA2CContinuousLogStd, models.ModelA2CContinuousTanh):
            kwargs["space_cfg"] = network_params.get("space", {}).get("continuous", {})
        return model_cls(
            network,
            obs_shape=obs_shape if obs_shape is not None else input_shape,
            normalize_input=normalize_input,
            normalize_value=normalize_value,
            value_size=value_size,
            device=device,
            **kwargs,
        )

    return build


register_model("continuous_a2c_logstd", _model_factory(models.ModelA2CContinuousLogStd))
register_model("continuous_a2c", _model_factory(models.ModelA2CContinuous))
register_model("continuous_a2c_tanh", _model_factory(models.ModelA2CContinuousTanh))
register_model("discrete_a2c", _model_factory(models.ModelA2C))
register_model("multi_discrete_a2c", _model_factory(models.ModelA2CMultiDiscrete))
register_model("central_value", _model_factory(models.ModelCentralValue))


class ModelBuilder:
    """model_builder.py:53-60."""

    def load(self, params: dict, **build_kwargs):
        return MODEL_REGISTRY[params["model"]["name"]](dict(params["network"]), **build_kwargs)
