"""PixelCatcher: the device-resident catch game behind the CNN path.

Port of rl_games_tpu/envs/jax/pixel.py (:34-88), batched over envs. A ball
falls one row per step from a random top column; a 3-pixel paddle on the
bottom row moves left/stay/right; the episode ends when the ball reaches
the paddle row, +1 if the paddle is under it, else -1. The observation is
an HxWx1 float image rendered each step.
"""

import dataclasses

import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv
from rl_games_tpu_torch.envs.spaces import Box, Discrete, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class CatchState:
    ball_row: torch.Tensor  # [N] int32
    ball_col: torch.Tensor
    paddle_col: torch.Tensor


class PixelCatcher(DeviceEnv):
    """Catch on an HxWx1 float image rendered on the device each step."""

    HEIGHT = 16
    WIDTH = 16
    PADDLE_HALF = 1  # the paddle spans paddle_col ± 1

    max_episode_steps = HEIGHT + 1
    reset_noise_shape = (2,)

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._rows = torch.arange(self.HEIGHT, device=self.device)[:, None]
        self._cols = torch.arange(self.WIDTH, device=self.device)[None, :]

    def env_info(self):
        return EnvInfo(observation_space=Box(shape=(self.HEIGHT, self.WIDTH, 1), low=0.0, high=1.0),
                       action_space=Discrete(n=3))

    def _render(self, s: CatchState):
        ball = (self._rows == s.ball_row[:, None, None]) & (self._cols == s.ball_col[:, None, None])
        paddle = (self._rows == self.HEIGHT - 1) & (
            torch.abs(self._cols - s.paddle_col[:, None, None]) <= self.PADDLE_HALF
        )
        img = torch.where(ball, 1.0, 0.0) + torch.where(paddle, 0.5, 0.0)
        return img[..., None]

    def reset_from(self, noise):
        """The ball's column uniform over [0, W), the paddle's over
        [PADDLE_HALF, W - PADDLE_HALF), from uniforms in [0, 1): the JAX
        package draws the same ranges with ``jax.random.randint``."""
        lo, hi = self.PADDLE_HALF, self.WIDTH - self.PADDLE_HALF
        state = CatchState(
            ball_row=torch.zeros(noise.shape[0], dtype=torch.int32, device=noise.device),
            ball_col=(noise[:, 0] * self.WIDTH).to(torch.int32),
            paddle_col=lo + (noise[:, 1] * (hi - lo)).to(torch.int32),
        )
        return state, self._render(state)

    def step(self, estate: CatchState, actions, noise=None):
        move = actions.to(torch.int32) - 1  # {0, 1, 2} -> {-1, 0, +1}
        paddle_col = torch.clamp(estate.paddle_col + move, self.PADDLE_HALF,
                                 self.WIDTH - 1 - self.PADDLE_HALF)
        ball_row = estate.ball_row + 1
        state = CatchState(ball_row=ball_row, ball_col=estate.ball_col, paddle_col=paddle_col)
        terminated = ball_row >= self.HEIGHT - 1
        caught = torch.abs(estate.ball_col - paddle_col) <= self.PADDLE_HALF
        reward = torch.where(terminated, torch.where(caught, 1.0, -1.0), 0.0)
        return state, self._render(state), reward, terminated, {}
