"""DeviceBreakout: an ALE-Breakout-class brick game, batched over envs.

Port of rl_games_tpu/envs/jax/breakout.py (:66-296); the rules and
constants are the JAX module's: a 6 x 12 wall whose rows score 7/7/4/4/1/1
per brick (312 a board), the board refills when cleared, 5 lives, an
84x84x2 frame stack (channel 1 the previous decision's frame),
``frame_skip`` substeps per decision with the reward summed, the
termination latched and the substeps after a terminal one frozen on every
field, Discrete(3) {left, stay, right}.

The dynamics and the render repeat the JAX package's float32 operations
in its order. The row and column of the ball's cell are taken with a
conversion to int32, which truncates toward zero, as the JAX package's
``astype(int32)`` does (breakout.py:252,269): a ball up to 4 px above the
wall reads as row 0 there, and so it does here (not ``floor`` and not
``//``, which on float tensors floors). ``_serve`` runs in every substep
(breakout.py:210), so the step takes ``noise`` [N, frame_skip, 2]: the
serve's x and angle as uniforms in [0, 1) (``step_noise_shape``).
"""

import dataclasses

import numpy as np
import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv, uniform_between
from rl_games_tpu_torch.envs.spaces import Box, Discrete, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device

N_ROWS = 6
N_COLS = 12
ROW_VALUES = (7.0, 7.0, 4.0, 4.0, 1.0, 1.0)  # ALE row scoring, top row first
BOARD_SCORE = float(sum(v * N_COLS for v in ROW_VALUES))  # 312


@dataclasses.dataclass
class BreakoutState:
    ball_x: torch.Tensor  # [N] float32, pixels; y grows downward
    ball_y: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor
    prev_bx: torch.Tensor  # the previous decision's render state
    prev_by: torch.Tensor
    prev_px: torch.Tensor
    paddle_x: torch.Tensor
    bricks: torch.Tensor  # [N, N_ROWS, N_COLS] bool
    prev_bricks: torch.Tensor
    lives: torch.Tensor  # [N] int32
    score: torch.Tensor  # [N] float32
    serve_pending: torch.Tensor  # [N] bool: the ball is dead and serves next substep


class DeviceBreakout(DeviceEnv):
    """ALE-Breakout-class brick game on an 84x84x2 frame stack."""

    H = 84
    W = 84
    WALL_TOP = 14.0
    BRICK_H = 4.0
    BRICK_W = 7.0
    PADDLE_HALF = 6.0
    PADDLE_SPEED = 3.0
    PADDLE_PLANE = 78.0
    BALL_SPEED = 2.2
    VY_MIN = 1.1
    LIVES = 5

    reset_noise_shape = (2,)  # the serve's x and angle

    def __init__(self, frame_skip: int = 2, device=None):
        self.device = resolve_device(device)
        self.frame_skip = int(frame_skip)
        self.max_episode_steps = 16384 // self.frame_skip
        self.step_noise_shape = (self.frame_skip, 2)
        dev = self.device
        rows = torch.arange(self.H, dtype=torch.float32, device=dev)[:, None]
        cols = torch.arange(self.W, dtype=torch.float32, device=dev)[None, :]
        self._rows, self._cols = rows, cols
        # divisors that are not powers of two are device tensors: PyTorch's
        # CUDA kernels turn a division by a Python number into a product
        # with its reciprocal, a rounding the JAX package's division lacks
        self._brick_w, self._paddle_half, self._score_width = (
            torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (self.BRICK_W, self.PADDLE_HALF, 2.0 * BOARD_SCORE))
        # the wall's cell of every pixel (breakout.py:140-149)
        self._r_idx = torch.clamp(((rows - self.WALL_TOP) / self.BRICK_H).to(torch.int32), 0, N_ROWS - 1).long()
        self._c_idx = torch.clamp((cols / self._brick_w).to(torch.int32), 0, N_COLS - 1).long()
        self._in_wall = (rows >= self.WALL_TOP) & (rows < self.WALL_TOP + N_ROWS * self.BRICK_H)
        self._row_vals = torch.tensor(ROW_VALUES, dtype=torch.float32, device=dev)
        # jnp.sqrt of a Python float computes in float32
        self._vx_cap = float(np.sqrt(np.float32(self.BALL_SPEED**2 - self.VY_MIN**2)))

    def env_info(self):
        return EnvInfo(observation_space=Box(shape=(self.H, self.W, 2), low=0.0, high=1.0),
                       action_space=Discrete(n=3))

    # -- serve ----------------------------------------------------------------
    def _serve(self, u):
        """The ball above the paddle moving down at a random angle; ``u``
        [..., 2] gives its x and its vx."""
        bx = uniform_between(u[..., 0], 20.0, 64.0)
        vx = uniform_between(u[..., 1], -1.2, 1.2)
        vy = torch.sqrt(self.BALL_SPEED**2 - vx * vx)
        return bx, torch.full_like(bx, 50.0), vx, vy

    def reset_from(self, noise):
        bx, by, vx, vy = self._serve(noise)
        n = bx.shape[0]
        bricks = torch.ones((n, N_ROWS, N_COLS), dtype=torch.bool, device=bx.device)
        c = torch.full_like(bx, self.W / 2)
        state = BreakoutState(
            ball_x=bx, ball_y=by, vel_x=vx, vel_y=vy, prev_bx=bx, prev_by=by, prev_px=c,
            paddle_x=c, bricks=bricks, prev_bricks=bricks,
            lives=torch.full((n,), self.LIVES, dtype=torch.int32, device=bx.device),
            score=torch.zeros_like(bx), serve_pending=torch.zeros_like(bx, dtype=torch.bool),
        )
        return state, self._render(state)

    # -- render ---------------------------------------------------------------
    def _frame(self, ball_x, ball_y, paddle_x, bricks, lives, score):
        rows, cols = self._rows, self._cols

        def col(x):  # [N] -> [N, 1, 1]
            return x[:, None, None]

        img = torch.zeros((ball_x.shape[0], self.H, self.W), dtype=torch.float32, device=ball_x.device)
        # status strip: lives as 3-px blocks, the score bar on row 1
        img = torch.where((rows < 1.0) & (cols < col(3.0 * lives)), 0.25, img)
        img = torch.where((rows >= 1.0) & (rows < 2.0) & (cols < col(self.W * score / self._score_width)),
                          0.25, img)
        alive = bricks[:, self._r_idx, self._c_idx]  # [N, H, W]
        img = torch.where(self._in_wall & alive, 0.6, img)
        img = torch.where((torch.abs(rows - self.PADDLE_PLANE - 1.0) <= 1.0)
                          & (torch.abs(cols - col(paddle_x)) <= self.PADDLE_HALF), 0.8, img)
        img = torch.where((torch.abs(rows - col(ball_y)) <= 1.0) & (torch.abs(cols - col(ball_x)) <= 1.0),
                          1.0, img)
        return img

    def _render(self, s: BreakoutState):
        now = self._frame(s.ball_x, s.ball_y, s.paddle_x, s.bricks, s.lives, s.score)
        prev = self._frame(s.prev_bx, s.prev_by, s.prev_px, s.prev_bricks, s.lives, s.score)
        return torch.stack([now, prev], dim=-1)

    # -- dynamics -------------------------------------------------------------
    def step(self, s: BreakoutState, actions, noise):
        prev = (s.ball_x, s.ball_y, s.paddle_x, s.bricks)
        reward = torch.zeros_like(s.ball_x)
        terminated = torch.zeros_like(s.ball_x, dtype=torch.bool)
        for i in range(self.frame_skip):
            s2, r, t = self._substep(s, actions, noise[:, i])
            # substeps after a terminal one are frozen: no integration, no reward
            s = dataclasses.replace(s, **{
                f.name: _where_rows(terminated, getattr(s, f.name), getattr(s2, f.name))
                for f in dataclasses.fields(s)
            })
            reward = reward + torch.where(terminated, 0.0, r)
            terminated = terminated | t
        s = dataclasses.replace(s, prev_bx=prev[0], prev_by=prev[1], prev_px=prev[2], prev_bricks=prev[3])
        return s, self._render(s), reward, terminated, {}

    def _substep(self, s: BreakoutState, actions, u):
        move = (actions.to(torch.int32) - 1).to(torch.float32)
        paddle_x = torch.clamp(s.paddle_x + move * self.PADDLE_SPEED,
                               self.PADDLE_HALF, self.W - 1 - self.PADDLE_HALF)

        # a pending serve (after a life lost) places a fresh ball this substep
        sx, sy, svx, svy = self._serve(u)
        bx0 = torch.where(s.serve_pending, sx, s.ball_x)
        by0 = torch.where(s.serve_pending, sy, s.ball_y)
        vx = torch.where(s.serve_pending, svx, s.vel_x)
        vy = torch.where(s.serve_pending, svy, s.vel_y)
        bx = bx0 + vx
        by = by0 + vy

        # side walls, then the ceiling below the 2-row status strip
        hi = float(self.W - 1)
        bx = torch.where(bx < 0.0, -bx, bx)
        vx = torch.where(bx0 + vx < 0.0, -vx, vx)
        over_r = bx > hi
        bx = torch.where(over_r, 2.0 * hi - bx, bx)
        vx = torch.where(over_r, -vx, vx)
        hit_top = by < 2.0
        by = torch.where(hit_top, 2.0 * 2.0 - by, by)
        vy = torch.where(hit_top, -vy, vy)

        # paddle bounce: the contact offset steers, |vx| capped
        crossed = (by0 <= self.PADDLE_PLANE) & (by >= self.PADDLE_PLANE)
        hit_paddle = crossed & (vy > 0) & (torch.abs(bx - paddle_x) <= self.PADDLE_HALF + 1.0)
        offset = torch.clamp((bx - paddle_x) / self._paddle_half, -1.0, 1.0)
        new_vx = offset * self._vx_cap
        new_vy = -torch.sqrt(self.BALL_SPEED**2 - new_vx * new_vx)
        by = torch.where(hit_paddle, 2.0 * self.PADDLE_PLANE - by, by)
        vx = torch.where(hit_paddle, new_vx, vx)
        vy = torch.where(hit_paddle, new_vy, vy)

        # a brick at the ball's new cell; truncating indices, as in the JAX package
        r_idx = ((by - self.WALL_TOP) / self.BRICK_H).to(torch.int32)
        c_idx = (bx / self._brick_w).to(torch.int32)
        in_wall = (r_idx >= 0) & (r_idx < N_ROWS)
        c_idx = torch.clamp(c_idx, 0, N_COLS - 1).long()
        r_safe = torch.clamp(r_idx, 0, N_ROWS - 1).long()
        envs = torch.arange(bx.shape[0], device=bx.device)
        brick_alive = s.bricks[envs, r_safe, c_idx] & in_wall
        bricks = s.bricks.index_put((envs, r_safe, c_idx), s.bricks[envs, r_safe, c_idx] & ~brick_alive)
        brick_reward = torch.where(brick_alive, self._row_vals[r_safe], 0.0)
        # the reflection axis from the entry face: same row, another column
        # is a side face (flip vx); any row change flips vy
        r_prev = ((by0 - self.WALL_TOP) / self.BRICK_H).to(torch.int32)
        c_prev = (bx0 / self._brick_w).to(torch.int32)
        c_raw = (bx / self._brick_w).to(torch.int32)
        side_entry = brick_alive & (r_prev == r_idx) & (c_prev != c_raw)
        vx = torch.where(side_entry, -vx, vx)
        vy = torch.where(brick_alive & ~side_entry, -vy, vy)

        # a cleared board refills
        cleared = ~bricks.flatten(1).any(dim=1)
        bricks = bricks | cleared[:, None, None]

        # below the paddle line and not caught: a life lost
        lost_ball = (by > float(self.H - 1)) & ~hit_paddle
        lives = s.lives - lost_ball.to(torch.int32)
        terminated = lives <= 0
        state = dataclasses.replace(
            s,
            ball_x=torch.where(lost_ball, self.W / 2, bx),
            ball_y=torch.where(lost_ball, 50.0, by),
            vel_x=torch.where(lost_ball, 0.0, vx),
            vel_y=torch.where(lost_ball, 0.0, vy),
            paddle_x=paddle_x, bricks=bricks, lives=lives, score=s.score + brick_reward,
            serve_pending=lost_ball,  # served this substep: cleared; lost: set
        )
        return state, brick_reward, terminated


def _where_rows(cond, a, b):
    """where(cond, a, b) with cond [N] broadcast over a's trailing dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)
