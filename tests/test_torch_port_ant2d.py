"""The port's batched Ant2D against the JAX package's vmapped one.

States (q, qd) come from a short JAX rollout, so feet touch the ground and
the contact forces act; actions are drawn with numpy and include values
outside [-1, 1]. Tolerances: kinematics and the mass matrix at rtol 1e-5 /
atol 1e-5 (float32, sums in another order); the bias at atol 1e-4, since
it carries J̇q̇ (in closed form in the port, from a second-order autodiff
pass in the JAX package) times velocities up to 50; after a full control step
positions at atol 1e-5 and velocities at rtol = atol = 1e-4: the
JAX package factors M with an unrolled scalar Cholesky and the port with
LAPACK's, and four substeps of stiff contact forces at velocities up to 50
amplify that rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.envs.jax import ant2d as jant
from rl_games_tpu.envs.jax.base import JaxVecEnv
from rl_games_tpu.envs.jax.lagrangian import lagrangian_factors_2d as j_factors
from rl_games_tpu_torch.envs.device import ant2d as tant
from rl_games_tpu_torch.envs.device.base import DeviceVecEnv, VecEnvState
from rl_games_tpu_torch.envs.registry import create_vec_env

torch.set_num_threads(1)

N = 12
POS = dict(rtol=1e-5, atol=1e-5)
VEL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_states():
    """(q, qd, actions) as numpy, from a 20-step JAX rollout of N envs."""
    env = JaxVecEnv(jant.Ant2D(), num_envs=N)
    state, _ = jax.jit(env.reset)(jax.random.PRNGKey(3))
    step = jax.jit(env.step)
    rng = np.random.default_rng(0)
    for _ in range(20):
        state, *_ = step(state, jnp.asarray(rng.uniform(-1, 1, (N, 8)).astype(np.float32)))
    q = np.array(state.estate.q)
    qd = np.array(state.estate.qd)
    actions = rng.uniform(-1.3, 1.3, (N, 8)).astype(np.float32)
    return q, qd, actions


def test_link_frames_and_factors(jax_states):
    q, qd, _ = jax_states
    env = tant.Ant2D("cpu")
    tq, tqd = torch.from_numpy(q), torch.from_numpy(qd)
    coms, angles, feet = env.link_frames(tq)
    jcoms, jangles, jfeet = jax.vmap(jant._link_frames)(q)
    for t, j in ((coms, jcoms), (angles, jangles), (feet, jfeet)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **POS)

    # the closed-form kinematics agree with the plain link frames
    x, _, _ = env.kinematics(tq, tqd)
    flat = torch.cat([coms.reshape(N, -1), angles, feet.reshape(N, -1)], dim=-1)
    np.testing.assert_allclose(x.numpy(), flat.numpy(), rtol=1e-6, atol=1e-6)

    M, bias, feet_jac, feet0 = tant.lagrangian_factors_2d(
        env.kinematics, env.masses, env.inertias, tq, tqd, tant.GRAVITY
    )
    jM, jbias, jjac, jfeet0 = jax.jit(jax.vmap(
        lambda a, b: j_factors(jant._link_frames, jant._MASSES, jant._INERTIAS, a, b, jant.GRAVITY)
    ))(q, qd)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), **POS)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(feet_jac.numpy(), np.asarray(jjac), **POS)
    np.testing.assert_allclose(feet0.numpy(), np.asarray(jfeet0), **POS)
    assert (feet0[..., 1] < 0).any(), "no foot in contact: the step test would not cover contacts"


def test_step_matches_jax(jax_states):
    q, qd, actions = jax_states
    last_x = q[:, 0] - 0.01
    jstate = jant.Ant2DState(q=jnp.asarray(q), qd=jnp.asarray(qd), last_x=jnp.asarray(last_x))
    jnext, jobs, jrew, jterm, _ = jax.jit(jax.vmap(jant.Ant2D().step))(jstate, actions, jax.random.split(jax.random.PRNGKey(0), N))
    env = tant.Ant2D("cpu")
    tstate = tant.Ant2DState(q=torch.from_numpy(q), qd=torch.from_numpy(qd), last_x=torch.from_numpy(last_x))
    tnext, tobs, trew, tterm, _ = env.step(tstate, torch.from_numpy(actions))
    np.testing.assert_allclose(tnext.q.numpy(), np.asarray(jnext.q), **POS)
    np.testing.assert_allclose(tnext.qd.numpy(), np.asarray(jnext.qd), **VEL)
    np.testing.assert_allclose(tobs[:, :11].numpy(), np.asarray(jobs)[:, :11], **POS)
    np.testing.assert_allclose(tobs[:, 11:].numpy(), np.asarray(jobs)[:, 11:], **VEL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-5, atol=5e-4)  # fwd vel = Δx / 0.02
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))


def test_vec_env_autoreset_time_outs_final_obs(jax_states):
    """Rows 0-2 are forced to terminate (torso at 5 cm), rows 3-5 reach the
    time limit; the others step on. Done rows restart with fresh episodes,
    the rest must match the JAX vec env."""
    q, qd, _ = jax_states
    q = q.copy()
    q[:3, 1] = 0.05
    steps = np.full(N, 5, np.int32)
    steps[3:6] = 999
    actions = np.random.default_rng(1).uniform(-1, 1, (N, 8)).astype(np.float32)

    jenv = JaxVecEnv(jant.Ant2D(), num_envs=N)
    jstate, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    jstate = jstate.replace(
        estate=jant.Ant2DState(q=jnp.asarray(q), qd=jnp.asarray(qd), last_x=jnp.asarray(q[:, 0])),
        steps=jnp.asarray(steps),
    )
    _, jobs, jrew, jdone, jinfo = jax.jit(jenv.step)(jstate, jnp.asarray(actions))

    tenv = DeviceVecEnv(tant.Ant2D("cpu"), N)
    tstate = VecEnvState(
        estate=tant.Ant2DState(q=torch.from_numpy(q), qd=torch.from_numpy(qd), last_x=torch.from_numpy(q[:, 0].copy())),
        generator=torch.Generator().manual_seed(0),
        steps=torch.from_numpy(steps),
    )
    tnew, tobs, trew, tdone, tinfo = tenv.step(tstate, torch.from_numpy(actions))

    done = np.asarray(jdone)
    assert done[:6].all() and not done[6:].any()
    np.testing.assert_array_equal(tdone.numpy(), done)
    np.testing.assert_array_equal(tinfo["time_outs"].numpy(), np.asarray(jinfo["time_outs"]))
    assert tinfo["time_outs"].numpy().tolist() == [False] * 3 + [True] * 3 + [False] * (N - 6)
    final, jfinal = tinfo["final_observation"].numpy(), np.asarray(jinfo["final_observation"])
    np.testing.assert_allclose(final[3:], jfinal[3:], **VEL)
    # rows 0-2 start with the feet driven deep into the ground, where the
    # contact stiffness amplifies rounding about tenfold (JAX's own jitted
    # and eager steps differ there by 4e-4)
    np.testing.assert_allclose(final[:3], jfinal[:3], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-5, atol=5e-4)
    live = ~done
    np.testing.assert_allclose(tobs.numpy()[live], np.asarray(jobs)[live], **VEL)
    np.testing.assert_array_equal(tnew.steps.numpy(), np.where(done, 0, steps + 1))
    # done rows hold a fresh episode: torso at its start height, at rest-ish
    np.testing.assert_allclose(tnew.estate.q[:6, 1].numpy(), tant.LINK_L * 1.6)
    np.testing.assert_allclose(tnew.estate.q[:6, 0].numpy(), 0.0)
    assert np.abs(tnew.estate.qd[:6].numpy()).max() < 0.2


@pytest.mark.parametrize("make", [
    lambda: tant.Ant2D(),
    lambda: create_vec_env("Ant2D", 4),
], ids=["Ant2D", "create_vec_env"])
def test_default_device_never_falls_back_to_cpu(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
