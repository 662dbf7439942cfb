"""Reading the JAX package's recurrent and central-value ``.ckpt`` files in
the port: ref/test/test_asymmetric_continuous.yaml (separate LSTM trunks, an
LSTM central value net with its own normalizer and Adam) and
ref/test/test_rnn.yaml (separate LSTM trunks over the memory env), each
shrunk and trained 2 epochs by the JAX package here. Every tensor the port
restores equals the mapping of flax's own decode exactly (the weights, the
normalizers, the Adam count and moments by parameter name, the central value
net's and its Adam's), the players' deterministic actions from zero states
agree (continuous at rtol 1e-5 / atol 1e-6, discrete equal), and
``load_critic_only`` takes the central value net alone. The recurrent
carries are not carried: the port starts them, as the envs, from its own
reset.
"""

import os
import sys

import pytest
import torch

from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils import jax_params as jp

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_jax_ckpt import (  # noqa: E402
    assert_adam,
    assert_players_agree,
    assert_tensors_equal,
    flax_decode,
    jax_train,
    load_cfg,
)

torch.set_num_threads(1)


def asymmetric_cfg():
    cfg = load_cfg("ref/test/test_asymmetric_continuous.yaml")
    c = cfg["params"]["config"]
    c.update(num_actors=4, horizon_length=16, minibatch_size=32, mini_epochs=1, use_diagnostics=False)
    c["central_value_config"].update(minibatch_size=32, mini_epochs=1)
    return cfg


def rnn_cfg():
    cfg = load_cfg("ref/test/test_rnn.yaml")
    cfg["params"]["config"].update(num_actors=4, horizon_length=32, seq_length=8, minibatch_size=64, mini_epochs=1)
    return cfg


@pytest.mark.parametrize("make_cfg, discrete", [(asymmetric_cfg, False), (rnn_cfg, True)],
                         ids=["asymmetric_continuous", "rnn"])
def test_recurrent_checkpoint_restores(tmp_path, make_cfg, discrete):
    from rl_games_tpu.runner import Runner as JRunner

    cfg = make_cfg()
    path, _ = jax_train(cfg, tmp_path)
    ref = flax_decode(path)
    runner = Runner(device="cpu")
    runner.load(cfg)
    agent = runner.create_agent()
    state, meta = agent.restore_jax_checkpoint(path, agent.init_state())
    assert meta == ref["meta"] and int(state.epoch) == 2
    cv_net = (cfg["params"]["config"].get("central_value_config") or {}).get("network")
    carried = jp.ppo_jax_state(ref["state"], cfg["params"]["network"], agent.obs_shape, cv_net,
                               getattr(agent, "state_shape", None))
    assert_tensors_equal(agent.model.state_dict(), carried["model"])
    assert_adam(state.opt_state, carried["opt"], agent.model)
    if agent.has_central_value:
        assert_tensors_equal(agent.cv_model.state_dict(), carried["cv_model"])
        assert_adam(state.cv_opt, carried["cv_opt"], agent.cv_model)
        # load_critic_only: the central value net alone, the policy as it was drawn
        fresh = runner.create_agent()
        fresh_state = fresh.init_state()
        drawn = {k: v.clone() for k, v in fresh.model.state_dict().items()}
        fresh_state = fresh.restore_central_value_only(path, fresh_state)
        assert_tensors_equal(fresh.cv_model.state_dict(), carried["cv_model"])
        assert_adam(fresh_state.cv_opt, carried["cv_opt"], fresh.cv_model)
        assert_tensors_equal(fresh.model.state_dict(), drawn)
        assert int(fresh_state.epoch) == 0
    assert_players_agree(cfg, path, JRunner(), discrete=discrete)
