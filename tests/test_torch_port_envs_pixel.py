"""The port's pixel envs (DevicePong, DeviceBreakout, PixelCatcher) against
the JAX package's, from the same states and with the same random draws:
each step's draws are the uniforms ``jax.random.uniform`` gives for the
JAX env's per-env keys, handed to the port's step as its ``noise``.

Every field of the state, the reward, the termination and the rendered
frames are compared exactly: the port repeats the JAX package's float32
operations in its order, and maps a uniform to a range with one rounding,
as XLA's fused multiply-add does. One jitted JAX step per env and shape,
over a batch that holds every scenario (random mid-game states, points,
wins, lost lives, a cleared board), keeps the JAX compiles few.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.envs.jax.breakout import BreakoutState as JBreakoutState
from rl_games_tpu.envs.jax.breakout import DeviceBreakout as JDeviceBreakout
from rl_games_tpu.envs.jax.pixel import PixelCatcher as JPixelCatcher
from rl_games_tpu.envs.jax.pong import DevicePong as JDevicePong
from rl_games_tpu.envs.jax.pong import PongState as JPongState
from rl_games_tpu_torch.envs import registry
from rl_games_tpu_torch.envs.device.base import DeviceVecEnv, uniform
from rl_games_tpu_torch.envs.device.breakout import BreakoutState, DeviceBreakout
from rl_games_tpu_torch.envs.device.pixel import CatchState, PixelCatcher
from rl_games_tpu_torch.envs.device.pong import DevicePong, PongState

torch.set_num_threads(1)

N = 48
F32 = np.float32


def t(x):
    return torch.from_numpy(np.array(x))


def to_jax(cls, state: dict):
    return cls(**{k: jnp.asarray(v) for k, v in state.items()})


def assert_state_equal(port_state, jax_state):
    for f in dataclasses.fields(port_state):
        np.testing.assert_array_equal(getattr(port_state, f.name).numpy(),
                                      np.asarray(getattr(jax_state, f.name)), err_msg=f.name)


def assert_step_equal(got, want):
    assert_state_equal(got[0], want[0])
    for i, what in ((1, "obs"), (2, "reward"), (3, "terminated")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=what)


def substep_uniforms(keys, frame_skip, draws):
    """[N, frame_skip, draws] uniforms of the substeps' keys, as the JAX
    env's serve draws them (one key per draw split from the substep's key
    when it draws two)."""
    def per_env(key):
        def per_substep(k):
            ks = jax.random.split(k) if draws == 2 else [k]
            return jnp.stack([jax.random.uniform(x) for x in ks])
        return jax.vmap(per_substep)(jax.random.split(key, frame_skip))
    return t(jax.vmap(per_env)(keys))


KEYS = jax.random.split(jax.random.PRNGKey(3), N)
ACTIONS = np.random.default_rng(4).integers(0, 3, N).astype(np.int32)


# ---------------------------------------------------------------------------
# DevicePong
# ---------------------------------------------------------------------------


def pong_states():
    """Random mid-game states, then scenario rows."""
    rng = np.random.default_rng(0)
    s = dict(
        ball_x=rng.uniform(4, 79, N).astype(F32), ball_y=rng.uniform(0, 83, N).astype(F32),
        vel_x=(rng.choice([-1, 1], N) * rng.uniform(2, 3, N)).astype(F32),
        vel_y=rng.uniform(-3, 3, N).astype(F32),
        prev_bx=rng.uniform(1, 82, N).astype(F32), prev_by=rng.uniform(0, 83, N).astype(F32),
        prev_ay=rng.uniform(4, 79, N).astype(F32), prev_oy=rng.uniform(4, 79, N).astype(F32),
        agent_y=rng.uniform(4, 79, N).astype(F32), opp_y=rng.uniform(4, 79, N).astype(F32),
        agent_score=rng.integers(0, 20, N).astype(np.int32), opp_score=rng.integers(0, 20, N).astype(np.int32),
    )
    # 0-3: the agent scores in the first substep (the ball passes the
    # opponent, who is far away); rows 0-1 at 20 points: the win at 21
    s["ball_x"][0:4], s["vel_x"][0:4], s["ball_y"][0:4], s["opp_y"][0:4] = 1.0, -2.5, 10.0, 70.0
    s["agent_score"][0:2] = 20
    # 4-5: the agent scores in the second substep (a point inside the skip block)
    s["ball_x"][4:6], s["vel_x"][4:6], s["ball_y"][4:6], s["opp_y"][4:6] = 3.5, -2.5, 10.0, 70.0
    # 6-9: the opponent scores; rows 6-7 at 20: the loss at 21
    s["ball_x"][6:10], s["vel_x"][6:10], s["ball_y"][6:10], s["agent_y"][6:10] = 81.0, 2.5, 70.0, 10.0
    s["opp_score"][6:8] = 20
    # 10-13: the agent's paddle returns the ball off centre (spin)
    s["ball_x"][10:14], s["vel_x"][10:14] = 79.0, 2.0
    s["ball_y"][10:14] = s["agent_y"][10:14] + np.array([-4.5, -1.0, 2.0, 5.0], F32)
    s["agent_y"] = np.clip(s["agent_y"], 4.0, 79.0)
    return s


@pytest.fixture(scope="module")
def pong():
    jenv, env = JDevicePong(frame_skip=2), DevicePong(frame_skip=2, device="cpu")
    state = pong_states()
    want = jax.jit(jax.vmap(jenv.step))(to_jax(JPongState, state), jnp.asarray(ACTIONS), KEYS)
    got = env.step(PongState(**{k: t(v) for k, v in state.items()}), t(ACTIONS),
                   substep_uniforms(KEYS, 2, 1))
    return state, got, want


def test_pong_step_matches_jax_exactly(pong):
    _, got, want = pong
    assert_step_equal(got, want)


def test_pong_points_wins_and_the_frame_skip_latch(pong):
    state, (s, obs, reward, terminated, _), _ = pong
    r, term = reward.numpy(), terminated.numpy()
    # a point, then a re-serve from the centre toward the opponent (the loser receives)
    np.testing.assert_array_equal(r[0:6], 1.0)
    np.testing.assert_array_equal(s.agent_score.numpy()[0:6], state["agent_score"][0:6] + 1)
    assert (s.ball_x.numpy()[2:6] <= 42.0).all() and (s.vel_x.numpy()[2:6] < 0).all()
    np.testing.assert_array_equal(r[6:10], -1.0)
    # the win and the loss at 21 end the episode ...
    assert term[0:2].all() and term[6:8].all() and not term[2:6].any() and not term[8:10].any()
    # ... and freeze the second substep: the served ball stays at the centre
    np.testing.assert_array_equal(s.ball_x.numpy()[[0, 1, 6, 7]], 42.0)
    np.testing.assert_array_equal(s.ball_y.numpy()[[0, 1, 6, 7]], 42.0)
    # the returned balls head back at the opponent with spin
    assert (s.vel_x.numpy()[10:14] < 0).all() and len(set(s.vel_y.numpy()[10:14].tolist())) == 4
    # channel 1 is the previous decision's frame: the ball where it was
    np.testing.assert_array_equal(s.prev_bx.numpy(), state["ball_x"])
    assert obs.shape == (N, 84, 84, 2) and obs.dtype == torch.float32


def test_pong_reset_matches_jax_exactly():
    jenv, env = JDevicePong(), DevicePong(device="cpu")
    want = jax.jit(jax.vmap(jenv.reset))(KEYS)
    # reset: the serve's key, then the direction's (bernoulli) key
    u = jax.vmap(lambda k: jnp.stack([jax.random.uniform(x) for x in jax.random.split(k)]))(KEYS)
    got = env.reset_from(t(u))
    assert_state_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# DeviceBreakout
# ---------------------------------------------------------------------------


def breakout_states():
    rng = np.random.default_rng(1)
    s = dict(
        ball_x=rng.uniform(1, 82, N).astype(F32), ball_y=rng.uniform(3, 80, N).astype(F32),
        vel_x=rng.uniform(-1.8, 1.8, N).astype(F32),
        vel_y=(rng.choice([-1, 1], N) * rng.uniform(1.1, 2.2, N)).astype(F32),
        prev_bx=rng.uniform(1, 82, N).astype(F32), prev_by=rng.uniform(3, 83, N).astype(F32),
        prev_px=rng.uniform(6, 77, N).astype(F32), paddle_x=rng.uniform(6, 77, N).astype(F32),
        bricks=rng.random((N, 6, 12)) < 0.7, prev_bricks=rng.random((N, 6, 12)) < 0.7,
        lives=rng.integers(2, 6, N).astype(np.int32), score=rng.uniform(0, 600, N).astype(F32),
        serve_pending=rng.random(N) < 0.15,
    )
    s["serve_pending"][:12] = False
    # 0-3: the ball falls past the paddle: a life lost; rows 0-1 on the last life
    s["ball_x"][0:4], s["ball_y"][0:4], s["vel_x"][0:4], s["vel_y"][0:4] = 10.0, 82.0, 0.5, 2.0
    s["paddle_x"][0:4] = 70.0
    s["lives"][0:2] = 1
    # 4-5: the last brick of the board is hit: the board refills
    s["bricks"][4:6] = False
    s["bricks"][4:6, 5, 6] = True
    s["ball_x"][4:6], s["ball_y"][4:6], s["vel_x"][4:6], s["vel_y"][4:6] = 45.0, 35.5, 0.3, -1.5
    # 6-7: the paddle returns the ball, steering by the contact offset
    s["ball_x"][6:8], s["ball_y"][6:8], s["vel_x"][6:8], s["vel_y"][6:8] = 40.0, 77.0, 0.5, 2.0
    s["paddle_x"][6:8] = np.array([36.0, 44.0], F32)
    # 8-11: the ball enters the wall from above (ADVICE.md's case and kin)
    s["bricks"][8:12] = True
    s["ball_x"][8:12] = np.array([48.5, 20.5, 34.9, 62.0], F32)
    s["ball_y"][8:12] = np.array([12.8, 12.5, 13.0, 11.9], F32)
    s["vel_x"][8:12], s["vel_y"][8:12] = np.array([1.5, -1.2, 0.4, 1.0], F32), 1.6
    return s


@pytest.fixture(scope="module")
def breakout():
    jenv, env = JDeviceBreakout(frame_skip=2), DeviceBreakout(frame_skip=2, device="cpu")
    state = breakout_states()
    want = jax.jit(jax.vmap(jenv.step))(to_jax(JBreakoutState, state), jnp.asarray(ACTIONS), KEYS)
    got = env.step(BreakoutState(**{k: t(v) for k, v in state.items()}), t(ACTIONS),
                   substep_uniforms(KEYS, 2, 2))
    return state, got, want


def test_breakout_step_matches_jax_exactly(breakout):
    _, got, want = breakout
    assert_step_equal(got, want)


def test_breakout_lives_refill_and_paddle(breakout):
    state, (s, _, reward, terminated, _), _ = breakout
    np.testing.assert_array_equal(s.lives.numpy()[0:4], state["lives"][0:4] - 1)
    assert terminated.numpy()[0:2].all() and not terminated.numpy()[2:4].any()
    # the second substep served a fresh ball above the paddle, moving down
    assert not s.serve_pending.numpy()[2:4].any()
    assert (s.ball_y.numpy()[2:4] > 50.0).all() and (s.vel_y.numpy()[2:4] > 0).all()
    # the last brick, in a row worth 1: a point and a full board, whose
    # brick in the same cell the second substep breaks again
    np.testing.assert_array_equal(reward.numpy()[4:6], 2.0)
    np.testing.assert_array_equal(s.bricks.numpy()[4:6].sum(axis=(1, 2)), 71)
    assert not s.bricks.numpy()[4:6, 5, 6].any()
    # the ball right of the paddle goes right, left of it goes left
    assert (s.vel_y.numpy()[6:8] < 0).all() and s.vel_x.numpy()[7] < 0 < s.vel_x.numpy()[6]


def test_breakout_truncating_row_index_as_in_jax():
    """ADVICE.md:3: a ball at (48.5, 12.8) moving (1.5, 1.6) into a full
    wall. The JAX package reads its pre-step row 12.8 -> (12.8 - 14) / 4 =
    -0.3 -> int32 0, the same row as the brick it enters, so it takes the
    entry for a side face: brick (0, 7) breaks and vx flips, vy does not.
    The port keeps that truncation."""
    state = {k: v[8:9] for k, v in breakout_states().items()}
    jenv, env = JDeviceBreakout(frame_skip=1), DeviceBreakout(frame_skip=1, device="cpu")
    keys = KEYS[:1]
    want = jax.jit(jax.vmap(jenv.step))(to_jax(JBreakoutState, state), jnp.asarray([1]), keys)
    got = env.step(BreakoutState(**{k: t(v) for k, v in state.items()}), t(np.array([1])),
                   substep_uniforms(keys, 1, 2))
    assert_step_equal(got, want)
    s = got[0]
    broken = np.argwhere(~s.bricks.numpy()[0])
    np.testing.assert_array_equal(broken, [[0, 7]])
    assert float(s.vel_x[0]) == -1.5 and float(s.vel_y[0]) == F32(1.6)
    assert float(got[2][0]) == 7.0


def test_breakout_reset_matches_jax_exactly():
    jenv, env = JDeviceBreakout(), DeviceBreakout(device="cpu")
    want = jax.jit(jax.vmap(jenv.reset))(KEYS)
    u = jax.vmap(lambda k: jnp.stack([jax.random.uniform(x) for x in jax.random.split(k)]))(KEYS)
    got = env.reset_from(t(u))
    assert_state_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# PixelCatcher
# ---------------------------------------------------------------------------


def test_pixel_catcher_reset_and_steps_match_jax():
    jenv, env = JPixelCatcher(), PixelCatcher(device="cpu")
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(KEYS)
    # the JAX package draws the columns with randint; the port from
    # uniforms: hand it uniforms that land on the JAX columns
    u = np.stack([(np.asarray(jstate.ball_col) + 0.5) / 16,
                  (np.asarray(jstate.paddle_col) - 1 + 0.5) / 14], axis=-1).astype(F32)
    state, obs = env.reset_from(t(u))
    assert_state_equal(state, jstate)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(5)
    for _ in range(16):  # through the catch or miss at the bottom row
        actions = rng.integers(0, 3, N).astype(np.int32)
        want = jstep(jstate, jnp.asarray(actions), KEYS)
        got = env.step(state, t(actions))
        assert_step_equal(got, want)
        state, jstate = got[0], want[0]
    assert set(np.asarray(want[2]).tolist()) <= {-1.0, 0.0, 1.0}


# ---------------------------------------------------------------------------
# the vec env around them
# ---------------------------------------------------------------------------


def test_vec_env_autoreset_final_observation_and_time_outs():
    """Rows that end take a fresh episode in the same step and report the
    true last frame as final_observation; the step's and the reset's
    uniforms come from the state's generator, step first."""
    env = DevicePong(device="cpu")
    vec = DeviceVecEnv(env, 6, max_episode_steps=10)
    state, _ = vec.reset(torch.Generator().manual_seed(0))
    s = dict(pong_states())
    rows = [0, 1, 6, 7, 20, 21]  # a win, a loss, two mid-game rows
    state.estate = PongState(**{k: t(v[rows]) for k, v in s.items()})
    state.steps = torch.tensor([3, 3, 3, 3, 9, 2], dtype=torch.int32)  # row 4 reaches the limit
    actions = torch.ones(6, dtype=torch.int64)
    replay = torch.Generator().set_state(state.generator.get_state())
    step_u = uniform(6, env.step_noise_shape, replay, "cpu")
    reset_u = uniform(6, env.reset_noise_shape, replay, "cpu")
    _, want_obs, _, _, _ = env.step(state.estate, actions, step_u)
    _, reset_obs = env.reset_from(reset_u)

    new, obs, reward, dones, infos = vec.step(state, actions)
    np.testing.assert_array_equal(dones.numpy(), [True, True, True, True, True, False])
    np.testing.assert_array_equal(infos["time_outs"].numpy(), [False, False, False, False, True, False])
    torch.testing.assert_close(infos["final_observation"], want_obs, rtol=0, atol=0)
    torch.testing.assert_close(obs[:5], reset_obs[:5], rtol=0, atol=0)
    torch.testing.assert_close(obs[5], want_obs[5], rtol=0, atol=0)
    np.testing.assert_array_equal(new.steps.numpy(), [0, 0, 0, 0, 0, 3])
    np.testing.assert_array_equal(new.estate.agent_score.numpy()[:5], 0)


@pytest.mark.parametrize("name, frame_skip", [("DevicePong-v0", 4), ("DeviceBreakout-v0", 3)])
def test_registry_passes_env_config(name, frame_skip):
    vec = registry.create_vec_env(name, 2, device="cpu", frame_skip=frame_skip)
    assert vec.env.frame_skip == frame_skip and vec.env.step_noise_shape[0] == frame_skip
    assert vec.max_episode_steps == (8192 if name == "DevicePong-v0" else 16384) // frame_skip
    state, obs = vec.reset(torch.Generator().manual_seed(1))
    _, obs, *_ = vec.step(state, torch.zeros(2, dtype=torch.int64))
    assert obs.shape == (2, 84, 84, 2)
