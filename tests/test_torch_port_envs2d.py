"""The port's planar device envs (Walker2D, Cheetah2D, Arm2D, Grasp2D)
against the JAX package's.

Each env's JAX side is one jitted program per module (the vec env's step,
and for the walkers the vmapped ``lagrangian_factors_2d`` beside it). The
arm's mass matrix and bias are held against the JAX package's own form,
``jax.hessian`` of the kinetic energy and grads (arm2d.py:81-91), which the
port replaces by M = JᵀWJ and b = JᵀW·J̇q̇ + ∇V over a jet pass.

Tolerances, as for Ant2D (tests/test_torch_port_ant2d.py): factors at
rtol = atol = 1e-5 (the walkers' bias at atol 1e-4: J̇q̇ times velocities up
to 50); after a control step positions at 1e-5, velocities and
observations at 1e-4 (LAPACK's Cholesky against an unrolled scalar form,
over four substeps), rewards at atol 5e-4 (Δx / 0.02). The arm recomputes
its factors at every substep and has no contacts, so it keeps 1e-5 in
positions too.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rl_games_tpu.envs.jax import arm2d as jarm
from rl_games_tpu.envs.jax import locomotion2d as jloco
from rl_games_tpu.envs.jax.base import JaxVecEnv
from rl_games_tpu.envs.jax.lagrangian import lagrangian_factors_2d as j_factors
from rl_games_tpu_torch.envs.device import arm2d as tarm
from rl_games_tpu_torch.envs.device import locomotion2d as tloco
from rl_games_tpu_torch.envs.device.base import DeviceVecEnv, VecEnvState
from rl_games_tpu_torch.envs.device.lagrangian import lagrangian_factors_2d
from rl_games_tpu_torch.envs.registry import create_vec_env

torch.set_num_threads(1)

N = 10
POS = dict(rtol=1e-5, atol=1e-5)
VEL = dict(rtol=1e-4, atol=1e-4)
REW = dict(rtol=1e-5, atol=5e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def jax_program(jenv, with_factors):
    """(estate fields, steps, actions) -> ([walker factors], vec-env step),
    jitted once; outputs as numpy."""
    jvec = JaxVecEnv(jenv, num_envs=N)
    template, _ = jax.jit(jvec.reset)(jax.random.PRNGKey(0))
    state_cls = type(template.estate)
    factors = jax.vmap(lambda q, qd: j_factors(jenv._link_frames, jenv.masses, jenv.inertias, q, qd, 9.81))

    @jax.jit
    def program(fields, steps, actions):
        state = template.replace(estate=state_cls(**fields), steps=steps)
        out = jvec.step(state, actions)
        return (factors(fields["q"], fields["qd"]), out) if with_factors else (None, out)

    return lambda fields, steps, actions: jax.tree.map(np.asarray, program(fields, steps, actions))


def port_step(tenv, state_cls, fields, steps, actions, seed=0):
    vec = DeviceVecEnv(tenv, N)
    state = VecEnvState(
        estate=state_cls(**{k: t(v) for k, v in fields.items()}),
        generator=torch.Generator().manual_seed(seed), steps=t(steps),
    )
    return vec.step(state, t(actions))


# ---------------------------------------------------------------------------
# Walker2D, Cheetah2D
# ---------------------------------------------------------------------------

WALKERS = {"Walker2D": (jloco.Walker2D, tloco.Walker2D), "Cheetah2D": (jloco.Cheetah2D, tloco.Cheetah2D)}


@pytest.fixture(scope="module", params=list(WALKERS))
def walker(request):
    jcls, tcls = WALKERS[request.param]
    jenv, tenv = jcls(), tcls(device="cpu")
    return request.param, jenv, tenv, jax_program(jenv, with_factors=True)


def walker_states(tenv, seed, steps=15):
    """(q, qd, rng) after some port steps from fresh episodes."""
    vec = DeviceVecEnv(tenv, N)
    state, _ = vec.reset(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        state, *_ = vec.step(state, torch.from_numpy(rng.uniform(-1, 1, (N, 4)).astype(np.float32)))
    return state.estate.q.numpy().copy(), state.estate.qd.numpy().copy(), rng


def test_walker_factors_match_jax(walker):
    name, jenv, tenv, run = walker
    q, qd, _ = walker_states(tenv, seed=0)
    fields = dict(q=q, qd=qd, last_x=q[:, 0])
    (jM, jbias, jjac, jfeet), _ = run(fields, np.zeros(N, np.int32), np.zeros((N, 4), np.float32))
    M, bias, jac, feet = lagrangian_factors_2d(tenv.kinematics, tenv.masses, tenv.inertias, t(q), t(qd))
    np.testing.assert_allclose(M.numpy(), jM, **POS)
    np.testing.assert_allclose(bias.numpy(), jbias, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(jac.numpy(), jjac, **POS)
    np.testing.assert_allclose(feet.numpy(), jfeet, **POS)
    assert (jfeet[..., 1] < 0).any(), "no foot in contact: contacts would go untested"
    # the closed-form kinematics agree with the plain link frames
    coms, angles, feet_pts = tenv.link_frames(t(q))
    x, _, _ = tenv.kinematics(t(q), t(qd))
    flat = torch.cat([coms.reshape(N, -1), angles, feet_pts.reshape(N, -1)], dim=-1)
    np.testing.assert_allclose(x.numpy(), flat.numpy(), rtol=1e-6, atol=1e-6)
    for got, want in zip((coms, angles, feet_pts), jax.vmap(jenv._link_frames)(q)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **POS)


def test_walker_step_matches_jax(walker):
    name, jenv, tenv, run = walker
    q, qd, rng = walker_states(tenv, seed=1, steps=6)  # the upright walker falls within 15 random steps
    actions = rng.uniform(-1.3, 1.3, (N, 4)).astype(np.float32)
    fields = dict(q=q, qd=qd, last_x=q[:, 0] - 0.01)
    steps = np.zeros(N, np.int32)
    _, (jstate, _, jrew, jdone, jinfo) = run(fields, steps, actions)
    tstate, _, trew, tdone, tinfo = port_step(tenv, tloco.WalkerState, fields, steps, actions)
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    live = ~jdone
    assert live.sum() >= N - 2
    np.testing.assert_allclose(tstate.estate.q.numpy()[live], jstate.estate.q[live], **POS)
    np.testing.assert_allclose(tstate.estate.qd.numpy()[live], jstate.estate.qd[live], **VEL)
    np.testing.assert_allclose(tinfo["final_observation"].numpy(), jinfo["final_observation"], **VEL)
    np.testing.assert_allclose(trew.numpy(), jrew, **REW)


def test_walker_limits_match_jax(walker):
    """Joints past ±joint_limit, the torso below the crash height (legs
    level, so it falls freely), pitch past the crash pitch both ways, and
    velocities past the observation's clamp."""
    name, jenv, tenv, run = walker
    q, qd, rng = walker_states(tenv, seed=2, steps=5)
    q[0, 3:] = tenv.joint_limit + 0.3
    q[1, 3:] = -tenv.joint_limit - 0.3
    q[2], qd[2] = 0.0, 0.0
    q[2, 1], q[2, 3::2] = 0.5 * tenv.crash_height, np.pi / 2
    q[3, 2] = tenv.crash_pitch + 0.3
    q[4, 2] = -tenv.crash_pitch - 0.3
    qd[5] = 30.0 * np.sign(np.arange(qd.shape[1]) % 2 - 0.5)
    actions = rng.uniform(-1.3, 1.3, (N, 4)).astype(np.float32)
    fields = dict(q=q, qd=qd, last_x=q[:, 0])
    steps = np.zeros(N, np.int32)
    _, (jstate, _, jrew, jdone, jinfo) = run(fields, steps, actions)
    tstate, _, trew, tdone, tinfo = port_step(tenv, tloco.WalkerState, fields, steps, actions)
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    assert jdone[2:5].all() and not jdone[:2].any()
    np.testing.assert_allclose(tstate.estate.q.numpy()[:2], jstate.estate.q[:2], **POS)
    np.testing.assert_allclose(tstate.estate.qd.numpy()[:2], jstate.estate.qd[:2], **VEL)
    final, jfinal = tinfo["final_observation"].numpy(), jinfo["final_observation"]
    assert np.abs(final[5]).max() == 10.0 == np.abs(jfinal[5]).max()
    np.testing.assert_allclose(final, jfinal, **VEL)
    np.testing.assert_allclose(trew.numpy(), jrew, **REW)


def test_walker_vec_env_autoreset(walker):
    """Rows 0-2 pitched past the limit terminate, rows 3-5 time out; done
    rows restart at the start height."""
    name, jenv, tenv, run = walker
    q, qd, rng = walker_states(tenv, seed=3, steps=5)
    q[:3, 2] = tenv.crash_pitch + 0.3
    steps = np.full(N, 5, np.int32)
    steps[3:6] = 999
    actions = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
    fields = dict(q=q, qd=qd, last_x=q[:, 0])
    _, (jstate, jobs, jrew, jdone, jinfo) = run(fields, steps, actions)
    tstate, tobs, trew, tdone, tinfo = port_step(tenv, tloco.WalkerState, fields, steps, actions)
    assert jdone[:6].all() and not jdone[6:].any()
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    assert tinfo["time_outs"].numpy().tolist() == [False] * 3 + [True] * 3 + [False] * (N - 6)
    np.testing.assert_array_equal(tinfo["time_outs"].numpy(), jinfo["time_outs"])
    np.testing.assert_allclose(tinfo["final_observation"].numpy(), jinfo["final_observation"], **VEL)
    np.testing.assert_allclose(tobs.numpy()[6:], jobs[6:], **VEL)
    np.testing.assert_allclose(tstate.estate.q[:6, 1].numpy(), tenv.init_height)
    np.testing.assert_allclose(tstate.estate.q[:6, 1].numpy(), jstate.estate.q[:6, 1], rtol=1e-6)
    np.testing.assert_array_equal(tstate.steps.numpy(), np.where(jdone, 0, steps + 1))


# ---------------------------------------------------------------------------
# Arm2D, Grasp2D
# ---------------------------------------------------------------------------


def jax_hessian_factors(arm, q, qd):
    """M and bias as the JAX arm computes them inside ``_qdd``
    (arm2d.py:81-91): the kinetic energy's hessian and grads."""
    ke = arm._kinetic_energy
    M = jax.hessian(ke, argnums=1)(q, qd)
    coriolis = jax.jvp(lambda qq: jax.grad(ke, argnums=1)(qq, qd), (q,), (qd,))[1]
    bias = coriolis - jax.grad(ke, argnums=0)(q, qd) + jax.grad(arm._potential_energy)(q)
    return M, bias


@pytest.mark.parametrize("kwargs", [{}, {"n_links": 5, "gravity": False}, {"n_links": 2, "link_l": 0.5}],
                         ids=["default", "five_links_no_gravity", "two_long_links"])
def test_arm_factors_match_jax_hessian(kwargs):
    jenv, tenv = jarm.Arm2D(**kwargs), tarm.Arm2D(device="cpu", **kwargs)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(N, tenv.n)).astype(np.float32)
    qd = (2.0 * rng.normal(size=(N, tenv.n))).astype(np.float32)
    jM, jbias = jax.jit(jax.vmap(lambda a, b: jax_hessian_factors(jenv, a, b)))(q, qd)
    M, bias, jac, contacts = lagrangian_factors_2d(tenv.kinematics, tenv.masses, tenv.inertias, t(q), t(qd), tenv.g)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), **POS)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), **POS)
    assert jac.shape == (N, 0, 2, tenv.n) and contacts.shape == (N, 0, 2)  # the arm has no contacts
    np.testing.assert_allclose(tenv.frames(t(q))[2].numpy(), np.asarray(jax.vmap(jenv._frames)(q)[2]), **POS)
    # and the accelerations the JAX arm integrates
    action = rng.uniform(-1, 1, (N, tenv.n)).astype(np.float32)
    jqdd = jax.jit(jax.vmap(jenv._qdd))(q, qd, action)
    # M q̈ = rhs solved in float32: M's rounding times its condition number
    # (some hundreds for five links in folded poses) reaches 1e-4 relative
    np.testing.assert_allclose(tenv.qdd(t(q), t(qd), t(action)).numpy(), np.asarray(jqdd), rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def arm_programs():
    return {name: (jcls(), tcls(device="cpu"), jax_program(jcls(), with_factors=False))
            for name, jcls, tcls in (("Arm2D", jarm.Arm2D, tarm.Arm2D), ("Grasp2D", jarm.Grasp2D, tarm.Grasp2D))}


def arm_fields(name, tenv, rng):
    """Arm states with random poses and velocities; for Grasp2D rows that
    hold the object, rows whose gripper sits on a free object, objects in
    the air and on the table."""
    n = tenv.n
    q = rng.normal(size=(N, n)).astype(np.float32)
    fields = dict(q=q, qd=(2.0 * rng.normal(size=(N, n))).astype(np.float32),
                  target=rng.uniform(-0.8, 0.8, (N, 2)).astype(np.float32))
    if name == "Grasp2D":
        ee = tenv.frames(t(q))[2].numpy()
        obj = rng.uniform(-0.8, 0.8, (N, 2)).astype(np.float32)
        obj[:6] = ee[:6]  # held (rows 0-2) or under a gripper (rows 3-5)
        obj[8:, 1] = tenv.floor  # resting on the table
        objd = rng.normal(size=(N, 2)).astype(np.float32)
        objd[:3] = 0.0
        fields.update(obj=obj, objd=objd, held=np.arange(N) < 3)
    return fields


def arm_actions(name, tenv, rng):
    actions = rng.uniform(-1.3, 1.3, (N, tenv.env_info().action_space.shape[0])).astype(np.float32)
    if name == "Grasp2D":
        actions[:, -1] = np.where(np.arange(N) % 2 == 0, 0.7, -0.7)  # grip closed on even rows
    return actions


@pytest.mark.parametrize("name", ["Arm2D", "Grasp2D"])
def test_arm_step_matches_jax(arm_programs, name):
    jenv, tenv, run = arm_programs[name]
    rng = np.random.default_rng(5)
    fields, actions = arm_fields(name, tenv, rng), None
    actions = arm_actions(name, tenv, rng)
    steps = np.zeros(N, np.int32)
    _, (jstate, jobs, jrew, jdone, jinfo) = run(fields, steps, actions)
    state_cls = tarm.GraspState if name == "Grasp2D" else tarm.ArmState
    tstate, tobs, trew, tdone, tinfo = port_step(tenv, state_cls, fields, steps, actions)
    assert not jdone.any() and not tdone.numpy().any()
    for f in dataclasses.fields(state_cls):
        got, want = getattr(tstate.estate, f.name).numpy(), getattr(jstate.estate, f.name)
        if got.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, err_msg=f.name, **(VEL if f.name == "qd" else POS))
    np.testing.assert_allclose(tobs.numpy(), jobs, **VEL)
    np.testing.assert_allclose(trew.numpy(), jrew, **POS)
    if name == "Grasp2D":
        held = tstate.estate.held.numpy()
        # closed grippers keep or latch, open ones release
        assert held.tolist() == [True, False, True, False, True, False] + held[6:].tolist()


@pytest.mark.parametrize("name", ["Arm2D", "Grasp2D"])
def test_arm_vec_env_time_outs(arm_programs, name):
    """The arms never terminate; rows at the last step of the episode
    (150 / 200) time out and restart with a fresh target."""
    jenv, tenv, run = arm_programs[name]
    rng = np.random.default_rng(6)
    fields, actions = arm_fields(name, tenv, rng), arm_actions(name, tenv, rng)
    steps = np.zeros(N, np.int32)
    steps[:4] = tenv.max_episode_steps - 1
    _, (jstate, jobs, jrew, jdone, jinfo) = run(fields, steps, actions)
    tstate, tobs, trew, tdone, tinfo = port_step(tenv, tarm.GraspState if name == "Grasp2D" else tarm.ArmState,
                                                 fields, steps, actions)
    assert jdone.tolist() == [True] * 4 + [False] * (N - 4) == tdone.numpy().tolist()
    np.testing.assert_array_equal(tinfo["time_outs"].numpy(), jinfo["time_outs"])
    np.testing.assert_allclose(tinfo["final_observation"].numpy(), jinfo["final_observation"], **VEL)
    np.testing.assert_allclose(tobs.numpy()[4:], jobs[4:], **VEL)
    # fresh episodes: joints near zero, at rest, a target inside the reach
    assert np.abs(tstate.estate.q[:4].numpy()).max() < 0.5 and not tstate.estate.qd[:4].numpy().any()
    radius = np.linalg.norm(tstate.estate.target[:4].numpy(), axis=-1)
    assert (radius <= 0.95 * tenv.reach + 1e-6).all()


def test_grasp_reset_layout():
    env = tarm.Grasp2D(device="cpu")
    state, obs = env.reset(64, torch.Generator().manual_seed(0))
    assert obs.shape == (64, 3 * env.n + 9)
    np.testing.assert_allclose(state.obj[:, 1].numpy(), env.floor)
    assert (state.obj[:, 0].abs() <= 0.7 * env.reach).all() and (state.target[:, 1] >= 0).all()
    assert not state.held.any()


def test_env_config_reaches_the_constructor():
    vec = create_vec_env("Arm2D", 4, device="cpu", n_links=4, gravity=False)
    assert vec.env.n == 4 and vec.env.g == 0.0
    assert vec.get_env_info().observation_space.shape == (3 * 4 + 6,)
    assert create_vec_env("Grasp2D", 2, device="cpu").max_episode_steps == 200


@pytest.mark.parametrize("name", ["Walker2D", "Cheetah2D", "Arm2D", "Grasp2D"])
def test_default_device_never_falls_back_to_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_vec_env(name, 4)
