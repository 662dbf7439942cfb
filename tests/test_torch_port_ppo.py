"""The port's PPO slice against the JAX PPOAgent on the flagship config,
cut to 16 Ant2D envs, horizon 16, units [32, 16], minibatch 64 and 2
mini-epochs. Weights, normalizer stats and env states are carried from the
JAX agent to the port; the JAX rollout's action noise is recovered as
(actions - mus) / sigmas and fed to the port's rollout.

Tolerances (stated per comparison below) follow from float32 arithmetic in
another summation order, amplified by 16 steps of contact dynamics in the
rollout and by Adam's normalized steps in the full update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_games_tpu.algos import ppo as jppo
from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu_torch.algos import ppo as tppo
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.envs.device.ant2d import Ant2DState
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)

NUM_ACTORS = 16


def flagship_params(num_actors=NUM_ACTORS):
    """The flagship continuous PPO config (as __graft_entry__._flagship_params
    plus bench.py's Ant2D overrides), cut to a CPU test's size."""
    return {
        "algo": {"name": "a2c_continuous"},
        "model": {"name": "continuous_a2c_logstd"},
        "network": {
            "name": "actor_critic",
            "separate": False,
            "mlp": {"units": [32, 16], "activation": "elu", "initializer": {"name": "default"}},
            "space": {"continuous": {
                "mu_activation": "None", "sigma_activation": "None",
                "mu_init": {"name": "default"},
                "sigma_init": {"name": "const_initializer", "val": 0.0},
                "fixed_sigma": True,
            }},
        },
        "config": {
            "env_name": "Ant2D", "num_actors": num_actors, "horizon_length": 16,
            "minibatch_size": 64, "mini_epochs": 2, "learning_rate": 3e-4,
            "lr_schedule": "adaptive", "kl_threshold": 0.008, "e_clip": 0.2,
            "clip_value": True, "gamma": 0.99, "tau": 0.95, "critic_coef": 2.0,
            "entropy_coef": 0.0, "grad_norm": 1.0, "truncate_grads": True,
            "normalize_advantage": True, "normalize_input": True,
            "normalize_value": True, "bounds_loss_coef": 0.0001,
            "value_bootstrap": True, "seed": 7,
        },
    }


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_run():
    """A JAX agent, its initial state, and one rollout from it (numpy)."""
    jagent = JPPOAgent("jax", flagship_params())
    jstate = jagent.init_state()
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    return jagent, jstate, after, to_np(traj), np.asarray(last_values)


def port_agent(jstate):
    """A port agent (on the CPU) holding the JAX state's weights, normalizer
    stats, env state and LR."""
    agent = PPOAgent("port", flagship_params(), device="cpu")
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    est = jstate.env_state.estate
    state.env_state.estate = Ant2DState(q=t(est.q), qd=t(est.qd), last_x=t(est.last_x))
    state.env_state.steps = t(jstate.env_state.steps)
    state.obs, state.dones, state.lr = t(jstate.obs), t(jstate.dones), t(jstate.lr)
    return agent, state


def test_rollout_matches_jax(jax_run, monkeypatch):
    _, jstate, after, traj, last_values = jax_run
    # the seed is chosen so that no env terminates: resets draw from
    # different generators in the two frameworks
    assert not traj["dones"][1:].any() and not np.asarray(after.dones).any()
    noise = iter(t((traj["actions"] - traj["mus"]) / traj["sigmas"]))
    monkeypatch.setattr(D, "normal_sample", lambda mean, std, generator=None: mean + std * next(noise))
    agent, state = port_agent(jstate)
    ptraj, plast = agent._rollout(state)
    # after 16 steps of contact dynamics rounding differences reach ~1e-4;
    # what is computed from the observations (actions, values, neglogp,
    # rewards) is held at rtol = atol = 2e-4
    tol = dict(rtol=2e-4, atol=2e-4)
    for k in ("actions", "mus", "sigmas", "values", "neglogpacs", "rewards"):
        np.testing.assert_allclose(ptraj[k].numpy(), traj[k], err_msg=k, **tol)
    # observations: positions and angles (dims 0-10) at the same 2e-4;
    # velocities (11-21) at 5e-3, since in this seed one foot touches down
    # in the last step and the contact's stiffness multiplies a 1e-4
    # velocity difference about thirtyfold; contact flags (22-25) exactly
    obs, jobs = ptraj["obses"].numpy(), traj["obses"]
    np.testing.assert_allclose(obs[..., :11], jobs[..., :11], **tol)
    np.testing.assert_allclose(obs[..., 11:22], jobs[..., 11:22], rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(obs[..., 22:], jobs[..., 22:])
    np.testing.assert_array_equal(ptraj["dones"].numpy(), traj["dones"])
    np.testing.assert_allclose(plast.numpy(), last_values, **tol)
    np.testing.assert_array_equal(state.dones.numpy(), np.asarray(after.dones))
    assert int(state.game_rewards.count) == int(after.game_rewards.count) == 0


def finish_both(jax_run, one_minibatch: bool, schedule_type: str = "legacy"):
    """JAX and port _finish_epoch on the same JAX trajectory."""
    jagent, _, after, traj, last_values = jax_run
    agent, state = port_agent(after)
    if one_minibatch or schedule_type != "legacy":
        jagent = JPPOAgent("jax", flagship_params())
    for a in (jagent, agent):
        a.schedule_type = schedule_type
        if one_minibatch:
            a.mini_epochs_num, a.num_minibatches = 1, 1
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, None)
    ptraj = {k: t(v) for k, v in traj.items()}
    state, pm = agent._finish_epoch(state, ptraj, t(last_values))
    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm))
    return agent, state, pm, jnew, to_np(jm), expected


def test_one_minibatch_update_matches_jax(jax_run):
    agent, state, pm, jnew, jm, expected = finish_both(jax_run, one_minibatch=True)
    got = agent.model.state_dict()
    for name in agent.model.state_dict():
        if name.endswith("count"):
            assert int(got[name]) == int(expected[name]), name
        elif name.startswith("a2c_network"):
            # one Adam step moves each weight by ~lr; within 1e-6 absolute
            np.testing.assert_allclose(got[name].numpy(), expected[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
        else:  # normalizer statistics
            np.testing.assert_allclose(got[name].numpy(), expected[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(state.lr), float(jnew.lr), rtol=1e-5)
    # the loss terms are means over the minibatch: rtol 1e-5
    for k in ("kl", "a_loss", "c_loss"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-5, err_msg=k)
    assert int(state.epoch) == int(jnew.epoch) == 1
    assert int(state.frame) == int(jnew.frame) == 16 * NUM_ACTORS


@pytest.mark.parametrize("schedule_type", ["legacy", "standard"])
def test_full_update_matches_jax(jax_run, schedule_type):
    agent, state, pm, jnew, jm, expected = finish_both(jax_run, False, schedule_type)
    got = agent.model.state_dict()
    for name in got:
        # 8 Adam steps, each dividing a gradient by its running RMS, which
        # lifts float32 noise on near-zero gradient entries: params within
        # 5e-6 absolute, the normalizer stats at rtol 1e-5
        np.testing.assert_allclose(got[name].numpy(), expected[name].numpy(), rtol=1e-5, atol=5e-6, err_msg=name)
    np.testing.assert_allclose(float(state.lr), float(jnew.lr), rtol=1e-5)
    for k in ("a_loss", "c_loss", "kl", "explained_variance", "entropy"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(state.epoch) == int(jnew.epoch) == 1
    assert int(state.frame) == int(jnew.frame) == 16 * NUM_ACTORS


def test_default_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPOAgent("port", flagship_params(), device=None)


@pytest.mark.parametrize("key, value", [
    ("central_value_config", {"network": {}}),
    ("rnd_config", {"network": {}}),
    ("use_action_masks", True),
    ("mixed_precision", True),
    ("permute_batches", True),
    ("vecenv_type", "GYMNASIUM"),
])
def test_unported_options_raise(key, value):
    params = flagship_params()
    params["config"][key] = value
    with pytest.raises(NotImplementedError, match="not ported"):
        PPOAgent("port", params, device="cpu")


def test_meters_match_jax():
    """Ring-buffer episode meters, with fewer rows finishing per update than
    the ring holds (with more, which duplicate slot wins is unspecified in
    both frameworks); the pointer wraps around."""
    rng = np.random.default_rng(4)
    jm = jppo.meters_init(8, 2)
    tm = tppo.meters_init(8, 2, "cpu")
    for done_p in (0.3, 0.5, 0.2, 0.4):
        values = rng.normal(size=(16, 2)).astype(np.float32)
        mask = rng.random(16) < done_p
        mask[np.flatnonzero(mask)[7:]] = False  # at most 7 rows finish
        jm = jppo.meters_update(jm, values, mask)
        tppo.meters_update(tm, t(values), t(mask))
        np.testing.assert_array_equal(tm.buf[:8].numpy(), np.asarray(jm.buf))
        assert int(tm.ptr) == int(jm.ptr) and int(tm.count) == int(jm.count)
        np.testing.assert_allclose(tppo.meters_mean(tm).numpy(), np.asarray(jppo.meters_mean(jm)), rtol=1e-6)
    assert int(jm.count) == 8  # the ring filled and wrapped


@pytest.mark.parametrize("grad_scale, weight_decay", [(10.0, 0.0), (0.01, 0.0), (10.0, 1e-2)])
def test_adam_step_matches_optax(grad_scale, weight_decay):
    """The hand-written clip -> weight decay -> Adam -> scale(-lr) chain
    against optax's, over three steps with a changing LR; grad_scale 10
    makes the global-norm clip fire, 0.01 leaves it idle. Params within
    1e-7 absolute: each step moves them by about lr."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (3,), (2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    chain = [optax.clip_by_global_norm(1.0)]
    if weight_decay:
        chain.append(optax.add_decayed_weights(weight_decay))
    tx = optax.chain(*chain, optax.scale_by_adam(eps=1e-8), optax.scale(-1.0))
    jparams = [jnp.asarray(p) for p in params]
    opt = tx.init(jparams)
    tparams = [t(p) for p in params]
    topt = tppo.adam_init(tparams)
    for lr in (3e-4, 1e-3, 4.5e-4):
        grads = [(rng.normal(size=s) * grad_scale).astype(np.float32) for s in shapes]
        updates, opt = tx.update([jnp.asarray(g) for g in grads], opt, jparams)
        jparams = optax.apply_updates(jparams, [u * lr for u in updates])
        tppo.adam_step(tparams, [t(g) for g in grads], topt, torch.tensor(lr), 1.0, weight_decay)
        for a, b in zip(tparams, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
    assert int(topt.count) == 3
