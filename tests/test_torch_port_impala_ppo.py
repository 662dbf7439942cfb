"""PPO updates of Impala models in the port against the JAX package.

From the JAX rollout's trajectory on PixelCatcher (16 envs x 8 steps, 2
mini-epochs of 4 minibatches of 32), ``_finish_epoch`` of both agents with
the weights carried across: weights at 2e-6 absolute, the normalizer stats
at rtol 1e-5, the losses at rtol 1e-4.

- an Impala (depths [4, 8]) + MLP [16] + LSTM 16 model, seq_length 4;
- a ``use_bn`` + ``use_zero_init`` tower with ``weight_decay > 0``: the
  frozen statistics take no gradient, so the decay alone moves them, in the
  port as in the JAX package.
"""

import dataclasses

import jax
import numpy as np
import torch

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.envs.device.pixel import CatchState
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict
from test_torch_port_impala import catcher_params, jitter, positive_var, t, to_np

torch.set_num_threads(1)


def update_matches_jax(params, jitter_seed=None):
    """_finish_epoch of both agents from the JAX rollout's trajectory:
    weights at 2e-6 absolute, normalizer stats at rtol 1e-5, the losses at
    rtol 1e-4. Returns the port's weights before and after."""
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    if jitter_seed is not None:
        jstate = jstate.replace(params=positive_var(jitter(to_np(jstate.params), jitter_seed, 0.1)))
    after, traj, last_values, snapshots = jax.jit(jagent._rollout)(jstate)
    traj, last_values, snapshots = to_np(traj), np.asarray(last_values), to_np(snapshots)
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, snapshots)
    agent = PPOAgent("port", params, device="cpu")
    state = agent.init_state()
    convert = dict(network=params["network"], input_shape=(16, 16, 1))
    agent.model.load_state_dict(jax_to_state_dict(to_np(after.params), to_np(after.norm), **convert))
    est = after.env_state.estate
    state.env_state.estate = CatchState(**{f.name: t(getattr(est, f.name)) for f in dataclasses.fields(CatchState)})
    state.dones, state.lr = t(after.dones), t(after.lr)
    if agent.is_rnn:
        state.rnn_states = tuple(t(s) for s in after.rnn_states)
    ptraj = {k: t(v) for k, v in traj.items()}
    if snapshots is not None:
        ptraj["rnn_snapshots"] = tuple(t(s) for s in snapshots[0])
    before = {k: v.clone() for k, v in agent.model.state_dict().items()}
    state, pm = agent._finish_epoch(state, ptraj, t(last_values))
    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm), **convert)
    assert sorted(expected) == sorted(agent.model.state_dict())
    for name, got in agent.model.state_dict().items():
        tol = dict(rtol=0, atol=2e-6) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)
    jm = to_np(jm)
    for k in ("a_loss", "c_loss", "kl", "entropy"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    return before, agent.model.state_dict()


def test_impala_lstm_update_matches_jax():
    """An Impala (depths [4, 8]) + MLP [16] + LSTM 16 model on PixelCatcher,
    16 envs x 8 steps, seq_length 4, 2 x 4 minibatches of 32."""
    params = catcher_params({"rnn": {"name": "lstm", "units": 16, "layers": 1}}, seq_length=4)
    update_matches_jax(params)


def test_frozen_statistics_move_by_weight_decay_as_in_jax():
    """A use_bn + use_zero_init tower with weight_decay 0.01: the frozen
    statistics take no gradient, so only the decay moves them, in the port
    as in the JAX package (optax.add_decayed_weights before Adam)."""
    params = catcher_params({"cnn": {"conv_depths": [4, 8], "use_bn": True, "use_zero_init": True}},
                            weight_decay=0.01)
    before, after = update_matches_jax(params, jitter_seed=7)
    moved = [k for k in before if k.startswith("a2c_network") and k.endswith(("running_mean", "running_var"))
             and float((after[k] - before[k]).abs().max()) > 0]
    assert len(moved) == 2 * 2 * 5  # 5 conv blocks a stage, mean and var, 2 stages
