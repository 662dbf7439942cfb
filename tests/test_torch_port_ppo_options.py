"""PPO's further options in the port against the JAX package: RND
curiosity, mixed precision, permute_batches, RMS advantage normalization,
soft augmentation, and the pieces they are built from.

- The generalized moving stats (every impl), ``random_shift`` from the
  offsets the JAX transform draws, ``gaussian_noise`` from its normals.
- bfloat16 rounding: round to nearest even in both packages, bit for bit,
  and the port's mixed-precision forward uses exactly the JAX package's
  rounded weights.
- One epoch's update of each option from the JAX rollout's trajectory (the
  JAX update's permutations and transform draws handed over; RND's target,
  predictor and normalizer carried across): weights at 2e-6 absolute, the
  normalizers at rtol 1e-5, the losses at rtol 1e-4
  (test_torch_port_test_envs.py's tolerances). RND runs with the config of
  tests/test_rnd.py::test_ppo_with_rnd_config_trains_and_reports_loss on
  the device CartPole; the others on ref/ppo_pendulum.yaml's network
  (separate trunks, a state-dependent sigma) on the device Pendulum, and
  soft augmentation on CartPole too (the categorical KL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.common import transforms as JT
from rl_games_tpu.ops import running_stats as JRS
from rl_games_tpu_torch.common import transforms as T
from rl_games_tpu_torch.ops import running_stats as RS
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict, rnd_jax_to_state_dict
from test_ppo import cartpole_params
from test_rnd import RND_NETWORK
from test_torch_port_test_envs import load, port_agent, t, to_np

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["mean_std", "mean_std_corr", "min_max", "perc_ema", "perc_ema_corr"])
def test_generalized_moving_stats_match_jax(impl):
    rng = np.random.default_rng(1)
    jstate, state = JRS.generalized_moving_stats_init(()), RS.generalized_moving_stats_init(())
    for i in range(4):
        x = (rng.normal(size=200) * (1 + i) + i).astype(np.float32)
        jstate = JRS.generalized_moving_stats_update(jstate, x, impl=impl, decay=0.5)
        state = RS.generalized_moving_stats_update(state, t(x), impl=impl, decay=0.5)
        for f in ("low", "high"):
            np.testing.assert_allclose(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)), rtol=1e-6,
                                       atol=1e-7, err_msg=f)
        assert int(state.step) == int(jstate.step) == i + 2
        np.testing.assert_allclose(RS.generalized_moving_stats_normalize(state, t(x), impl=impl, decay=0.5).numpy(),
                                   np.asarray(JRS.generalized_moving_stats_normalize(jstate, x, impl=impl, decay=0.5)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            RS.generalized_moving_stats_normalize(state, t(x), impl=impl, decay=0.5, denorm=True).numpy(),
            np.asarray(JRS.generalized_moving_stats_normalize(jstate, x, impl=impl, decay=0.5, denorm=True)),
            rtol=1e-5, atol=1e-6)


def test_random_shift_matches_jax():
    """The JAX transform's crop at the offsets its key draws (split into
    rows and columns, randint in [0, 2 · pad]); edge padding."""
    obs = np.random.default_rng(2).normal(size=(6, 9, 7, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JT.random_shift(key, obs, pad=3))
    k1, k2 = jax.random.split(key)
    ys, xs = (np.asarray(jax.random.randint(k, (6,), 0, 7)) for k in (k1, k2))
    assert len(set(ys.tolist())) > 1
    np.testing.assert_array_equal(T.random_shift(t(obs), t(ys), t(xs), pad=3).numpy(), want)
    # the built transform draws its own offsets, within the padding
    shifted = T.build_transform({"name": "random_shift", "pad": 2})(torch.Generator().manual_seed(0), t(obs))
    assert shifted.shape == obs.shape


def test_gaussian_noise_matches_jax():
    obs = np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(JT.gaussian_noise(key, obs, std=0.1))
    noise = np.asarray(jax.random.normal(key, obs.shape, jnp.float32))
    np.testing.assert_array_equal(T.gaussian_noise(t(obs), t(noise), std=0.1).numpy(), want)


def test_bfloat16_rounding_is_bit_equal():
    """Round to nearest, ties to even, in both packages: random values and
    values exactly between two bfloat16 neighbours."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096),
                        1.0 + np.arange(1, 64) * 2.0 ** -8, -(3.0 + np.arange(1, 64) * 2.0 ** -7)]).astype(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = t(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got, x)


# ---------------------------------------------------------------------------
# one update of each option from the JAX trajectory
# ---------------------------------------------------------------------------


def pendulum_params(**config):
    params = load("ref/ppo_pendulum.yaml")
    params["config"].pop("vecenv_type")
    params["config"].update(num_actors=16, horizon_length=8, minibatch_size=32, mini_epochs=2, **config)
    return params


def rnd_params():
    params = cartpole_params(num_actors=16, horizon_length=16, minibatch_size=64, mini_epochs=1)
    params["config"]["rnd_config"] = {"scale_value": 0.02, "mini_epochs": 2, "minibatch_size": 256,
                                      "learning_rate": 5e-4, "network": RND_NETWORK}
    return params


GAUSSIAN = {"transform": {"name": "gaussian_noise", "std": 0.1}, "aug_coef": 0.5}
OPTIONS = {
    "rnd": rnd_params,
    "mixed_precision": lambda: pendulum_params(mixed_precision=True),
    "permute_batches": lambda: pendulum_params(permute_batches=True),
    "normalize_rms_advantage": lambda: pendulum_params(normalize_rms_advantage=True, adv_rms_momentum=0.5),
    "soft_augmentation_continuous": lambda: pendulum_params(features={"soft_augmentation": GAUSSIAN}),
    "soft_augmentation_discrete": lambda: cartpole_params(num_actors=16, horizon_length=16, minibatch_size=64,
                                                          mini_epochs=2, features={"soft_augmentation": GAUSSIAN}),
}


def jax_update_draws(jagent, rng, obs_dim):
    """The JAX update's permutations and soft-augmentation normals, in its
    key schedule (ppo.py:1039-1050, 840-843)."""
    perms, noises = [], []
    for _ in range(jagent.mini_epochs_num):
        if jagent.permute_batches:
            rng, pkey = jax.random.split(rng)
            perms.append(np.asarray(jax.random.permutation(pkey, jagent.batch_size)))
        rng, mbk = jax.random.split(rng)
        for mb_key in jax.random.split(mbk, jagent.num_minibatches):
            aug_key, _ = jax.random.split(mb_key)
            noises.append(np.asarray(jax.random.normal(aug_key, (jagent.minibatch_size, obs_dim), jnp.float32)))
    return perms, noises


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_update_matches_jax(option, monkeypatch):
    params = OPTIONS[option]()
    jagent = JPPOAgent("jax", params)
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jagent.init_state())
    traj, last_values = to_np(traj), np.asarray(last_values)
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, None)
    agent, state = port_agent(OPTIONS[option](), after)
    if option == "rnd":
        agent.rnd.load_state_dict(rnd_jax_to_state_dict(to_np(after.rnd_target), to_np(after.rnd_pred),
                                                        to_np(after.rnd_rms)))
    if option == "normalize_rms_advantage":
        state.adv_rms = RS.GeneralizedMovingStats(*(t(getattr(after.adv_rms, f)) for f in ("low", "high", "step")))
    perms, noises = jax_update_draws(jagent, after.rng, traj["obses"].shape[-1])
    perms, noises = iter(perms), iter(noises)
    if agent.permute_batches:
        monkeypatch.setattr(agent, "_permutation", lambda state: t(next(perms)).long())
    if agent.soft_aug is not None:
        monkeypatch.setattr(agent, "_augment", lambda state, obs: T.gaussian_noise(obs, t(next(noises)), 0.1))
    rounded = []
    if option == "mixed_precision":
        call = torch.func.functional_call

        def recording(module, params, args, kwargs=None):
            rounded.append({k: v.detach().clone() for k, v in params.items()})
            return call(module, params, args, kwargs)

        monkeypatch.setattr(torch.func, "functional_call", recording)
    state, pm = agent._finish_epoch(state, {k: t(v) for k, v in traj.items()}, t(last_values))

    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm))
    for name, got in agent.model.state_dict().items():
        tol = dict(rtol=0, atol=2e-6) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)
    np.testing.assert_allclose(float(state.lr), float(jnew.lr), rtol=1e-5)
    jm = to_np(jm)
    keys = ["a_loss", "c_loss", "kl", "entropy", "explained_variance"] + (["rnd_loss"] if option == "rnd" else [])
    for k in keys:
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    if option == "rnd":
        want = rnd_jax_to_state_dict(to_np(jnew.rnd_target), to_np(jnew.rnd_pred), to_np(jnew.rnd_rms))
        for name, got in agent.rnd.state_dict().items():
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-5, atol=2e-6, err_msg=name)
        assert int(state.rnd_opt.count) == 2 * (16 * 16 // 256)
    if option == "normalize_rms_advantage":
        for f in ("low", "high"):
            np.testing.assert_allclose(getattr(state.adv_rms, f).numpy(), np.asarray(getattr(jnew.adv_rms, f)),
                                       rtol=1e-5, atol=1e-7, err_msg=f)
        assert int(state.adv_rms.step) == int(jnew.adv_rms.step) == 2
    if option == "mixed_precision":
        # the first forward's weights: the JAX package's bf16 cast, bit for bit
        cast = jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)),
                            to_np(after.params))
        want = {k[len("a2c_network."):]: v for k, v in jax_to_state_dict(cast).items()}
        assert len(rounded) == agent.mini_epochs_num * agent.num_minibatches
        for name, got in rounded[0].items():
            np.testing.assert_array_equal(got.numpy(), want[name[len("a2c_network."):]].numpy(), err_msg=name)
    # every permutation and every transform draw of the JAX update was used
    if agent.permute_batches:
        assert next(perms, None) is None
    if agent.soft_aug is not None:
        assert next(noises, None) is None
