"""The port's 3D device envs (Ant3D, Humanoid3D) and the 3D Lagrangian
factors against the JAX package's.

Inputs: states from a 15-step port rollout with numpy-drawn actions (so
feet touch the ground and the contact forces act), and actions drawn with
numpy that include values outside [-1, 1]. Each env's JAX side is ONE
jitted program (the vmapped ``lagrangian_factors`` beside the vec env's
step), compiled once per module: the 3D factors take 15-30 s to compile on
the CPU.

Tolerances: the factors M, bias, contact Jacobian and contact points at
rtol = atol = 1e-5 (the port takes J and J̇q̇ from one pass over jets, the
JAX package from nq linearize passes and a jvp of a jvp: float32 in another
order). After a control step positions at 1e-5 and velocities and
observations at rtol = atol = 1e-4, as for Ant2D, also for rows past every
joint limit: LAPACK's Cholesky against the JAX package's unrolled scalar
form, amplified by four substeps of stiff contacts. Rewards hold the
forward velocity Δx / 0.02, so atol 5e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rl_games_tpu.envs.jax import ant3d as jant
from rl_games_tpu.envs.jax import humanoid3d as jhum
from rl_games_tpu.envs.jax import lagrangian as jlag
from rl_games_tpu.envs.jax.base import JaxVecEnv
from rl_games_tpu_torch.envs.device import ant3d as tant
from rl_games_tpu_torch.envs.device import humanoid3d as thum
from rl_games_tpu_torch.envs.device import lagrangian as tlag
from rl_games_tpu_torch.envs.device.base import DeviceVecEnv, VecEnvState
from rl_games_tpu_torch.envs.registry import create_vec_env

torch.set_num_threads(1)

N = 10
POS = dict(rtol=1e-5, atol=1e-5)
VEL = dict(rtol=1e-4, atol=1e-4)
REW = dict(rtol=1e-5, atol=5e-4)
# name: (JAX module, JAX env class, port module, port env class, actions)
ENVS = {
    "Ant3D": (jant, jant.Ant3D, tant, tant.Ant3D, 8),
    "Humanoid3D": (jhum, jhum.Humanoid3D, thum, thum.Humanoid3D, 12),
}


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=list(ENVS))
def case(request):
    """The env's name, both envs, and the JAX program
    (q, qd, steps, actions) -> (factors, vec-env step outputs)."""
    name = request.param
    jm, jcls, tm, tcls, nu = ENVS[name]
    jvec = JaxVecEnv(jcls(), num_envs=N)
    template, _ = jax.jit(jvec.reset)(jax.random.PRNGKey(0))
    factors = jax.vmap(
        lambda q, qd: jlag.lagrangian_factors(jm._link_frames, jm._MASSES, jm._INERTIAS, q, qd, jm.GRAVITY)
    )
    state_cls = type(template.estate)

    @jax.jit
    def program(q, qd, last_x, steps, actions):
        state = template.replace(estate=state_cls(q=q, qd=qd, last_x=last_x), steps=steps)
        return factors(q, qd), jvec.step(state, actions)

    def run(q, qd, last_x, steps, actions):
        return jax.tree.map(np.asarray, program(q, qd, last_x, steps, actions))

    return name, jm, tm, tcls("cpu"), nu, run


def contact_states(tenv, nu, seed=0, steps=15):
    """(q, qd, rng) after some port steps from fresh episodes."""
    vec = DeviceVecEnv(tenv, N)
    state, _ = vec.reset(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        state, *_ = vec.step(state, torch.from_numpy(rng.uniform(-1, 1, (N, nu)).astype(np.float32)))
    return state.estate.q.numpy().copy(), state.estate.qd.numpy().copy(), rng


def port_step(tenv, q, qd, last_x, steps, actions, seed=0):
    vec = DeviceVecEnv(tenv, N)
    state = VecEnvState(
        estate=tlag.LocomotionState(q=t(q), qd=t(qd), last_x=t(last_x)),
        generator=torch.Generator().manual_seed(seed), steps=t(steps),
    )
    return vec.step(state, t(actions))


def test_factors_match_jax(case):
    name, jm, tm, tenv, nu, run = case
    q, qd, rng = contact_states(tenv, nu)
    (jM, jbias, jjac, jpts), _ = run(q, qd, q[:, 0], np.zeros(N, np.int32), np.zeros((N, nu), np.float32))
    M, bias, jac, pts = tlag.lagrangian_factors(tenv.kinematics, tenv.masses, tenv.inertias, t(q), t(qd), tm.GRAVITY)
    for got, want in ((M, jM), (bias, jbias), (jac, jjac), (pts, jpts)):
        np.testing.assert_allclose(got.numpy(), want, **POS)
    assert (jpts[..., 2] < 0).any(), "no contact point below the ground: contacts would go untested"


def test_link_frames_match_jax(case):
    name, jm, tm, tenv, nu, run = case
    q, _, _ = contact_states(tenv, nu, seed=1)
    for got, want in zip(tenv.link_frames(t(q)), jax.vmap(jm._link_frames)(q)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_step_matches_jax(case):
    name, jm, tm, tenv, nu, run = case
    q, qd, rng = contact_states(tenv, nu, seed=2)
    actions = rng.uniform(-1.3, 1.3, (N, nu)).astype(np.float32)
    last_x = q[:, 0] - 0.01
    steps = np.zeros(N, np.int32)
    _, (jstate, jobs, jrew, jdone, jinfo) = run(q, qd, last_x, steps, actions)
    tstate, tobs, trew, tdone, tinfo = port_step(tenv, q, qd, last_x, steps, actions)
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    live = ~jdone
    assert live.sum() >= N - 2, "most rows must step on for the comparison to say much"
    np.testing.assert_allclose(tstate.estate.q.numpy()[live], jstate.estate.q[live], **POS)
    np.testing.assert_allclose(tstate.estate.qd.numpy()[live], jstate.estate.qd[live], **VEL)
    np.testing.assert_allclose(tinfo["final_observation"].numpy(), jinfo["final_observation"], **VEL)
    np.testing.assert_allclose(trew.numpy(), jrew, **REW)


def limit_states(name, tm, q, qd):
    """Rows placed past each limit: joints above and below their soft
    limits, the torso below its termination height (level, legs spread so
    that no foot touches the ground: it falls freely), roll and pitch past
    their termination angles, velocities past the observation's clamp."""
    q, qd = q.copy(), qd.copy()
    lo, hi = np.asarray(tm.JOINT_LO), np.asarray(tm.JOINT_HI)
    q[0, 6:] = hi + 0.3
    q[1, 6:] = lo - 0.3
    q[2], qd[2] = 0.0, 0.0
    if name == "Ant3D":
        q[2, 2], q[2, 7::2] = 0.08, 0.25  # thighs level, knees at their least bend
    else:
        q[2, 2], q[2, [8, 11]] = 0.35, 1.5  # legs swung forward, knees straight
    q[3, 3] = 1.2
    q[4, 4] = -1.2
    qd[5, :] = 30.0 * np.sign(np.arange(qd.shape[1]) % 2 - 0.5)
    return q, qd


def test_limits_match_jax(case):
    name, jm, tm, tenv, nu, run = case
    q, qd, rng = contact_states(tenv, nu, seed=3)
    q, qd = limit_states(name, tm, q, qd)
    actions = rng.uniform(-1.3, 1.3, (N, nu)).astype(np.float32)
    steps = np.zeros(N, np.int32)
    _, (jstate, _, jrew, jdone, jinfo) = run(q, qd, q[:, 0], steps, actions)
    tstate, _, trew, tdone, tinfo = port_step(tenv, q, qd, q[:, 0], steps, actions)
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    assert jdone[2:5].all(), "the low and tipped rows must terminate"
    # the joints past their limits step on: the limit torques act
    assert not jdone[:2].any()
    np.testing.assert_allclose(tstate.estate.q.numpy()[:2], jstate.estate.q[:2], **POS)
    np.testing.assert_allclose(tstate.estate.qd.numpy()[:2], jstate.estate.qd[:2], **VEL)
    final, jfinal = tinfo["final_observation"].numpy(), jinfo["final_observation"]
    # velocities past the clamp are observed at ±10
    assert np.abs(final[5]).max() == 10.0 == np.abs(jfinal[5]).max()
    np.testing.assert_allclose(final, jfinal, **VEL)
    np.testing.assert_allclose(trew.numpy(), jrew, **REW)


def test_vec_env_autoreset_time_outs_final_obs(case):
    """Rows 0-2 are forced to terminate (rolled past the limit), rows 3-5
    reach the time limit; the others step on. Done rows restart with fresh
    episodes, the rest must match the JAX vec env."""
    name, jm, tm, tenv, nu, run = case
    q, qd, rng = contact_states(tenv, nu, seed=4, steps=5)  # all standing
    q[:3, 3] = 1.2
    steps = np.full(N, 5, np.int32)
    steps[3:6] = 999
    actions = rng.uniform(-1, 1, (N, nu)).astype(np.float32)
    _, (jstate, jobs, jrew, jdone, jinfo) = run(q, qd, q[:, 0], steps, actions)
    tstate, tobs, trew, tdone, tinfo = port_step(tenv, q, qd, q[:, 0], steps, actions)

    assert jdone[:6].all() and not jdone[6:].any()
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    np.testing.assert_array_equal(tinfo["time_outs"].numpy(), jinfo["time_outs"])
    assert tinfo["time_outs"].numpy().tolist() == [False] * 3 + [True] * 3 + [False] * (N - 6)
    np.testing.assert_allclose(tinfo["final_observation"].numpy(), jinfo["final_observation"], **VEL)
    np.testing.assert_allclose(trew.numpy(), jrew, **REW)
    live = ~jdone
    np.testing.assert_allclose(tobs.numpy()[live], jobs[live], **VEL)
    np.testing.assert_array_equal(tstate.steps.numpy(), np.where(jdone, 0, steps + 1))
    # done rows hold a fresh episode: at the start height, at rest-ish, and
    # their observation is that episode's first
    # the JAX reset's heights: no noise on z in either env
    np.testing.assert_allclose(tstate.estate.q[:6, 2].numpy(), jstate.estate.q[:6, 2], rtol=0, atol=2e-6)
    np.testing.assert_allclose(tstate.estate.q[:6, :2].numpy(), 0.0)
    assert np.abs(tstate.estate.qd[:6].numpy()).max() < 0.2
    np.testing.assert_allclose(tobs[:6].numpy(), tenv._obs(tstate.estate.q[:6], tstate.estate.qd[:6]).numpy())


@pytest.mark.parametrize("helper", ["rot_x", "rot_y", "rot_z", "euler_zyx"])
def test_rotations_match_jax(helper):
    rng = np.random.default_rng(5)
    angles = rng.uniform(-3, 3, (3, 16)).astype(np.float32)
    if helper == "euler_zyx":
        got = tlag.euler_zyx(*map(t, angles))
        want = jax.vmap(lambda r, p, y: jlag.stack_mat([jlag.euler_zyx(r, p, y)])[0])(*angles)
    else:
        got = getattr(tlag, helper)(t(angles[0]))
        want = jax.vmap(lambda a: jlag.stack_mat([getattr(jlag, helper)(a)])[0])(angles[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_humanoid_init_pose_matches_jax():
    np.testing.assert_allclose(thum.Humanoid3D("cpu").init_q.numpy(), np.asarray(jhum._init_q()), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["Ant3D", "Humanoid3D", "Arm2D"])
def test_jet_matches_autograd(name):
    """x, J and J̇q̇ from the jet pass against torch.func on the plain
    kinematics, in float64: J = jacfwd(x), J̇q̇ = d²/ds² x(q + s q̇)."""
    from torch.func import jacfwd, jvp

    from rl_games_tpu_torch.envs.device.arm2d import Arm2D

    env = {"Ant3D": tant.Ant3D, "Humanoid3D": thum.Humanoid3D, "Arm2D": Arm2D}[name](device="cpu")
    for k, v in vars(env).items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            setattr(env, k, v.double())
    frames = env.frames if name == "Arm2D" else env.link_frames
    rng = np.random.default_rng(6)
    nq = env.masses.shape[0] if name == "Arm2D" else {"Ant3D": 14, "Humanoid3D": 18}[name]
    q = torch.from_numpy(rng.normal(size=(4, nq)) * 0.4)
    qd = torch.from_numpy(rng.normal(size=(4, nq)))
    x, J, acc = env.kinematics(q, qd)

    def flat(qq):  # one env's flattened kinematics (the arm's: no end effector)
        parts = frames(qq[None])
        return torch.cat([p.reshape(-1) for p in (parts[:2] if name == "Arm2D" else parts)])

    for i in range(4):
        np.testing.assert_allclose(x[i].numpy(), flat(q[i]).numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(J[i].numpy(), jacfwd(flat)(q[i]).numpy(), rtol=1e-10, atol=1e-12)
        second = jvp(lambda qq: jvp(flat, (qq,), (qd[i],))[1], (q[i],), (qd[i],))[1]
        np.testing.assert_allclose(acc[i].numpy(), second.numpy(), rtol=1e-10, atol=1e-10)


def test_jet_products():
    """The jet rules on scalar functions of two variables, against their
    derivatives written out: f = sin(q0)·q1² + cos(q1) @ a matrix."""
    q = torch.tensor([[0.3, -0.7]], dtype=torch.float64)
    qd = torch.tensor([[1.5, 0.4]], dtype=torch.float64)
    v = tlag.Jet.variables(q, qd)
    s0, _ = tlag.sincos(v[:, 0])
    _, c1 = tlag.sincos(v[:, 1])
    f = s0 * v[:, 1] * v[:, 1] + 2.0 * c1 - 1.0
    a, b = float(q[0, 0]), float(q[0, 1])
    da, db = float(qd[0, 0]), float(qd[0, 1])
    grad = [np.cos(a) * b * b, 2 * np.sin(a) * b - 2 * np.sin(b)]
    hess = [[-np.sin(a) * b * b, 2 * np.cos(a) * b], [2 * np.cos(a) * b, 2 * np.sin(a) - 2 * np.cos(b)]]
    d = np.array([da, db])
    np.testing.assert_allclose(f.value.numpy(), [np.sin(a) * b * b + 2 * np.cos(b) - 1.0], rtol=1e-14)
    np.testing.assert_allclose(f.jacobian.numpy().reshape(-1), grad, rtol=1e-14)
    np.testing.assert_allclose(f.x[1].numpy(), [np.dot(grad, d)], rtol=1e-14)
    np.testing.assert_allclose(f.curvature.numpy(), [d @ np.array(hess) @ d], rtol=1e-13)
    # matrix products: (A(q) @ B(q)) against the product of the values
    A = tlag.rot_z(v[:, 0])
    B = tlag.rot_x(v[:, 1])
    np.testing.assert_allclose((A @ B).value.numpy(), (A.value @ B.value).numpy(), rtol=1e-14)


@pytest.mark.parametrize("name", ["Ant3D", "Humanoid3D"])
def test_default_device_never_falls_back_to_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_vec_env(name, 4)


def test_registry_state_is_a_dataclass_of_tensors():
    vec = create_vec_env("Humanoid3D", 3, device="cpu")
    state, obs = vec.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (3, 41) and dataclasses.is_dataclass(state.estate)
    assert vec.get_env_info().action_space.shape == (12,)
