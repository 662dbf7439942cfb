"""The port's losses, divergence, masked statistics, running stats and
schedulers against their JAX counterparts, on the same numpy inputs.

Tolerance: rtol 1e-5 / atol 1e-6 everywhere. Both sides compute in float32;
only the order of reductions differs, which moves results by a few ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.ops import divergence as jdiv
from rl_games_tpu.ops import losses as jL
from rl_games_tpu.ops import masked as jMK
from rl_games_tpu.ops import running_stats as jrs
from rl_games_tpu.ops import schedulers as jsch
from rl_games_tpu_torch.ops import divergence as tdiv
from rl_games_tpu_torch.ops import losses as tL
from rl_games_tpu_torch.ops import masked as tMK
from rl_games_tpu_torch.ops import running_stats as trs
from rl_games_tpu_torch.ops import schedulers as tsch

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
RNG = np.random.default_rng(11)


def arr(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def close(t, j):
    np.testing.assert_allclose(np.asarray(t.detach().numpy() if torch.is_tensor(t) else t),
                               np.asarray(j), **TOL)


T = torch.from_numpy


@pytest.mark.parametrize("clip_value", [True, False])
def test_critic_loss(clip_value):
    a, b, c = arr(64, 1), arr(64, 1), arr(64, 1)
    close(tL.critic_loss(T(a), T(b), 0.2, T(c), clip_value), jL.critic_loss(a, b, 0.2, c, clip_value))


@pytest.mark.parametrize("is_ppo", [True, False])
@pytest.mark.parametrize("smooth", [True, False])
def test_actor_losses(is_ppo, smooth):
    old, new, adv = arr(64, scale=0.3), arr(64, scale=0.3), arr(64)
    t_fn = tL.smoothed_actor_loss if smooth else tL.actor_loss
    j_fn = jL.smoothed_actor_loss if smooth else jL.actor_loss
    close(t_fn(T(old), T(new), T(adv), is_ppo, 0.2), j_fn(old, new, adv, is_ppo, 0.2))


def test_decoupled_actor_loss_and_smooth_clamp():
    b, n, p, adv = arr(32, scale=0.3), arr(32, scale=0.3), arr(32, scale=0.3), arr(32)
    close(tL.decoupled_actor_loss(T(b), T(n), T(p), T(adv), 0.2),
          jL.decoupled_actor_loss(b, n, p, adv, 0.2))
    x = arr(32)
    close(tL.smooth_clamp(T(x), 0.8, 1.2), jL.smooth_clamp(x, 0.8, 1.2))


def test_bound_reg_losses_and_total():
    mu = arr(64, 8, scale=2.0)
    close(tL.bound_loss(T(mu)), jL.bound_loss(mu))
    close(tL.reg_loss(T(mu)), jL.reg_loss(mu))
    a = mu[:, 0]
    close(tL.ppo_total_loss(T(a), 1.5, 2.0, 0.5, 2.0, 0.01, 1e-4),
          jL.ppo_total_loss(a, 1.5, 2.0, 0.5, 2.0, 0.01, 1e-4))


@pytest.mark.parametrize("n", [1, 2, 257])
def test_normalize_advantage_ddof1(n):
    adv = arr(n, scale=3.0) + 1.0
    close(tL.normalize_advantage(T(adv)), jL.normalize_advantage(adv))
    if n > 1:  # the unbiased std, as torch's .std() gives it
        expected = (adv - adv.mean()) / (adv.std(ddof=1) + 1e-8)
        np.testing.assert_allclose(tL.normalize_advantage(T(adv)).numpy(), expected, rtol=1e-4, atol=1e-5)


def test_d_kl_normal():
    m0, m1 = arr(32, 8), arr(32, 8)
    s0, s1 = np.exp(arr(32, 8, scale=0.3)), np.exp(arr(32, 8, scale=0.3))
    close(tdiv.d_kl_normal((T(m0), T(s0)), (T(m1), T(s1))), jdiv.d_kl_normal((m0, s0), (m1, s1)))


@pytest.mark.parametrize("masked", [False, True])
def test_masked_stats(masked):
    y, yp = arr(100), arr(100)
    mask = (RNG.random(100) < 0.6) if masked else None
    tmask = T(mask) if masked else None
    close(tMK.explained_variance(T(yp), T(y), tmask), jMK.explained_variance(yp, y, mask))
    close(tMK.policy_clip_fraction(T(yp * 0.2), T(y * 0.2), 0.2, tmask),
          jMK.policy_clip_fraction(yp * 0.2, y * 0.2, 0.2, mask))
    if masked:
        x = arr(100, 3)
        close(tMK.masked_mean(T(y), T(mask)), jMK.masked_mean(y, mask))
        for t, j in zip(tMK.masked_mean_var(T(x), T(mask)), jMK.masked_mean_var(x, mask)):
            close(t, j)
        for t, j in zip(tMK.apply_masks([T(y), T(yp)], T(mask)), jMK.apply_masks([y, yp], mask)):
            close(t, j)


def test_explained_variance_is_population_variance():
    y, yp = arr(10), arr(10)
    expected = 1.0 - np.var(y - yp) / np.var(y)
    np.testing.assert_allclose(tMK.explained_variance(T(yp), T(y)).numpy(), expected, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_running_stats_update_and_normalize(masked):
    """Two updates from the initial state, then normalize/denormalize."""
    shape = (5,)
    jstate = jrs.rms_init(shape)
    rms = trs.RunningMeanStd(shape)
    for step in range(2):
        x = arr(3, 40, 5, scale=2.0) + step
        mask = (RNG.random((3, 40)) < 0.7) if masked else None
        jstate = jrs.rms_update_from_batch(jstate, x, mask)
        rms.update_from_batch(T(x), T(mask) if masked else None)
    close(rms.running_mean, jstate.mean)
    close(rms.running_var, jstate.var)
    assert rms.count.dtype == torch.int32 and int(rms.count) == int(jstate.count)
    x = arr(7, 5, scale=4.0)
    close(rms.normalize(T(x)), jrs.rms_normalize(jstate, x))
    close(rms.normalize(T(x), norm_only=True), jrs.rms_normalize(jstate, x, norm_only=True))
    close(rms.denormalize(T(x)), jrs.rms_denormalize(jstate, x))


def test_rms_functions_population_variance():
    x = arr(64, 3)
    mean, var, count = trs.rms_batch_moments(T(x), 1)
    np.testing.assert_allclose(var.numpy(), x.var(axis=0), rtol=1e-5)
    assert count == 64
    m, v, c = trs.rms_update(torch.zeros(3), torch.ones(3), torch.ones((), dtype=torch.int32), mean, var, count)
    jm = jrs.rms_update(jrs.rms_init((3,)), jnp.asarray(mean.numpy()), jnp.asarray(var.numpy()), count)
    close(m, jm.mean)
    close(v, jm.var)
    assert c.dtype == torch.int32 and int(c) == int(jm.count) == 65


@pytest.mark.parametrize("cfg", [
    {"lr_schedule": "adaptive", "kl_threshold": 0.008},
    {"lr_schedule": "linear", "max_epochs": 50, "schedule_entropy": True},
    {"lr_schedule": "linear", "max_frames": 10000},
    {"lr_schedule": None},
])
def test_schedulers(cfg):
    t_s, j_s = tsch.build_scheduler(cfg, 3e-4), jsch.build_scheduler(cfg, 3e-4)
    lr_t = torch.tensor(3e-4)
    ec_t = torch.tensor(0.01)
    lr_j, ec_j = jnp.float32(3e-4), jnp.float32(0.01)
    for epoch, kl in enumerate([0.001, 0.02, 0.008, 0.0001, 0.05]):
        frame = epoch * 1024
        lr_t, ec_t = t_s.update(lr_t, ec_t, torch.tensor(epoch, dtype=torch.int32),
                                torch.tensor(frame, dtype=torch.int32), torch.tensor(kl))
        lr_j, ec_j = j_s.update(lr_j, ec_j, jnp.int32(epoch), jnp.int32(frame), jnp.float32(kl))
        close(lr_t, lr_j)
        close(ec_t, ec_j)
