"""The readers of a conv stack's flatten, in the port against the JAX
package.

The JAX package flattens a conv stack's NHWC output in (h, w, c) order, the
port its NCHW output in (c, h, w) order, so ``jax_to_state_dict`` permutes
the rows of whatever reads the flatten, and only those rows: a core with
``rnn.before_mlp``, a core behind ``mlp.units: []``
(ref/minigrid/lava_rnn_img.yaml's wiring), the heads of a trunk without an
MLP or core (the critic's value head of separate trunks among them), every
layer of a D2RL MLP (its skip columns), ``concat_input`` and
``concat_output``; the resnet builder's extras after the flatten stay where
they are. With the weights carried across, each wiring's train dict at rtol
1e-5 / atol 1e-6 and the gradients of a loss over it at rtol 1e-4 with an
atol of 1e-5 of each tensor's largest entry (the helpers of
tests/test_torch_port_impala.py); lava_rnn_img.yaml's network as shipped at
atol 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict
from test_torch_port_impala import SHAPE, check_train_dict_and_grads, close, models, network, t, to_np

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


CONVS = [{"filters": 4, "kernel_size": 3, "strides": 2, "padding": 0},
         {"filters": 6, "kernel_size": 3, "strides": 1, "padding": 1}]
CONV = {"type": "conv2d", "activation": "relu", "convs": CONVS}
LSTM = {"name": "lstm", "units": 8, "layers": 1}
CONTINUOUS = {"continuous": {"fixed_sigma": False, "sigma_init": {"name": "default"}}}
READER_CASES = {
    # (network, model)
    "before_mlp": (network(cnn=CONV, mlp=(16,), rnn={**LSTM, "before_mlp": True}), "discrete_a2c"),
    "no_mlp_rnn": (network(cnn=CONV, mlp=(), rnn=LSTM), "discrete_a2c"),
    "no_mlp_heads": (network(cnn=CONV, mlp=(), space=CONTINUOUS), "continuous_a2c_logstd"),
    "separate_no_mlp_heads": (network(cnn=CONV, mlp=(), separate=True), "discrete_a2c"),
    "d2rl": (network(cnn=CONV, mlp=(16, 8), activation="elu", d2rl=True), "discrete_a2c"),
    "concat_input_output": (network(cnn=CONV, mlp=(16,), rnn={**LSTM, "concat_input": True,
                                                              "concat_output": True}), "discrete_a2c"),
    "before_mlp_concat_output_d2rl": (
        network(cnn=CONV, mlp=(16, 8), rnn={**LSTM, "before_mlp": True, "concat_output": True}, d2rl=True),
        "discrete_a2c"),
    "impala_before_mlp_extras": (
        {**network(cnn={"type": "impala", "conv_depths": [4, 8]}, mlp=(16,), rnn={**LSTM, "before_mlp": True}),
         "require_rewards": True}, "discrete_a2c"),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_flatten_readers_match_jax(case):
    """Each wiring in which a conv stack's flatten feeds a core, a head, a
    D2RL MLP's skip columns or a concatenation: jax_to_state_dict permutes
    those rows only, and the port computes what the JAX package computes
    (train dict and gradients; sequences of four steps with dones where
    there is a core)."""
    net, model = READER_CASES[case]
    extras = bool(net.get("require_rewards"))
    shape = {"observation": SHAPE, "reward": ()} if extras else SHAPE
    rng = np.random.default_rng(5)

    def draw(n):
        frames = rng.normal(size=(n, *SHAPE)).astype(np.float32)
        return {"observation": frames, "reward": rng.normal(size=n).astype(np.float32)} if extras else frames

    continuous = model == "continuous_a2c_logstd"
    jstates = None
    if "rnn" in net:
        jstates = JModelBuilder().load({"model": {"name": model}, "network": net}, actions_num=4,
                                       input_shape=shape).get_default_rnn_state(3)
    jmodel, jparams, jnorm, port = models(net, shape, example=draw(3), states=jstates, model=model)
    obs = draw(12)
    actions = rng.normal(size=(12, 4)).astype(np.float32) if continuous else rng.integers(0, 4, 12)
    rnn = {}
    if jstates is not None:
        rnn = dict(rnn_states=tuple(rng.normal(size=s.shape).astype(np.float32) for s in jstates),
                   dones=(rng.random(12) < 0.3).astype(np.float32), seq_length=4)
    keys = ("prev_neglogp", "values", "entropy", *(("mus", "sigmas") if continuous else ("logits",)))
    check_train_dict_and_grads(jmodel, jparams, jnorm, port, obs, actions, net, SHAPE, rnn, keys)


def test_lava_rnn_img_network_matches_jax():
    """ref/minigrid/lava_rnn_img.yaml's network as shipped (three convs, no
    MLP, an LSTM of 256 reading the 3136-wide flatten) over 84x84x3 frames:
    one forward from random states with dones."""
    params = yaml.safe_load((ROOT / "rl_games_tpu/configs/ref/minigrid/lava_rnn_img.yaml").read_text())["params"]
    net, shape = params["network"], (84, 84, 3)
    rng = np.random.default_rng(6)
    jstates = JModelBuilder().load(params, actions_num=3, input_shape=shape).get_default_rnn_state(2)
    jmodel, jparams, jnorm, port = models(net, shape, actions_num=3, states=jstates)
    obs = rng.normal(size=(4, *shape)).astype(np.float32)
    states = tuple(rng.normal(size=s.shape).astype(np.float32) for s in jstates)
    dones = np.array([0, 1, 0, 0], np.float32)
    jres = jmodel.forward_train(jparams, jnorm, obs, jnp.zeros(4, jnp.int32), rnn_states=states, dones=dones,
                                seq_length=2)
    with torch.no_grad():
        res = port.forward_train(t(obs), torch.zeros(4, dtype=torch.long), rnn_states=tuple(t(s) for s in states),
                                 dones=t(dones), seq_length=2)
    for k in ("logits", "values"):
        close(res[k], jres[k], k, atol=1e-5)


def test_flatten_reader_needs_the_config():
    """Without the config and the observation shape, a flatten that no MLP
    reads first cannot be carried across: a ValueError says what to pass."""
    net = READER_CASES["before_mlp"][0]
    jmodel = JModelBuilder().load({"model": {"name": "discrete_a2c"}, "network": net}, actions_num=4,
                                  input_shape=SHAPE)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), np.zeros((2, *SHAPE), np.float32),
                             rnn_states=jmodel.get_default_rnn_state(2))
    with pytest.raises(ValueError, match="pass network= and input_shape="):
        jax_to_state_dict(to_np(jparams))
