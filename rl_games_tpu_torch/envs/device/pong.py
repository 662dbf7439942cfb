"""DevicePong: first-to-21 Pong on an 84x84x2 frame stack, batched over envs.

Port of rl_games_tpu/envs/jax/pong.py (:65-325); the rules, constants and
calibration notes are the JAX module's. The agent's paddle is on the
right, a speed-limited scripted opponent on the left; Discrete(3) actions
{up, stay, down}; +1 / -1 per point; first to 21 ends the episode. A
decision is ``frame_skip`` physics substeps with the reward summed and the
termination latched; the substeps after a terminal one are frozen on every
field (pong.py:219-223). Channel 0 of the observation is the current
frame, channel 1 the previous decision's (``prev_*`` is set per decision).

The dynamics and the render repeat the JAX package's float32 operations
in its order (the same comparisons against ``arange``, the same order of
``where``s for score bars, paddles and ball), so that from the same
positions the frames are equal bit for bit. A re-serve may come in any
substep; the step takes its serve angles as ``noise`` [N, frame_skip, 1],
uniforms in [0, 1) (``step_noise_shape``).
"""

import dataclasses

import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv, uniform_between
from rl_games_tpu_torch.envs.spaces import Box, Discrete, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PongState:
    ball_x: torch.Tensor  # [N] float32, pixels
    ball_y: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor
    prev_bx: torch.Tensor  # the previous decision's positions (channel 1)
    prev_by: torch.Tensor
    prev_ay: torch.Tensor
    prev_oy: torch.Tensor
    agent_y: torch.Tensor  # paddle centres
    opp_y: torch.Tensor
    agent_score: torch.Tensor  # [N] int32
    opp_score: torch.Tensor


class DevicePong(DeviceEnv):
    """First-to-21 Pong on an 84x84x2 frame-stack image rendered on the device."""

    H = 84
    W = 84
    PADDLE_HALF = 4.0
    PADDLE_SPEED = 2.5
    OPP_SPEED = 1.0
    OPP_RETURN_SPEED = 0.5
    OPP_DEADZONE = 2.0
    OPP_VY_MAX = 2.0
    AGENT_PLANE = 80.0
    OPP_PLANE = 3.0
    BALL_VX0 = 2.0
    BALL_VX_MAX = 3.0
    BALL_VY_MAX = 3.0
    WIN_SCORE = 21

    reset_noise_shape = (2,)  # serve angle, serve direction

    def __init__(self, frame_skip: int = 2, device=None):
        self.device = resolve_device(device)
        self.frame_skip = int(frame_skip)
        self.max_episode_steps = 8192 // self.frame_skip
        self.step_noise_shape = (self.frame_skip, 1)
        self._rows = torch.arange(self.H, dtype=torch.float32, device=self.device)[:, None]
        self._cols = torch.arange(self.W, dtype=torch.float32, device=self.device)[None, :]

    def env_info(self):
        return EnvInfo(observation_space=Box(shape=(self.H, self.W, 2), low=0.0, high=1.0),
                       action_space=Discrete(n=3))

    # -- serve ---------------------------------------------------------------
    def _serve(self, u, direction):
        """Centre serve toward ``direction`` (+1 = at the agent), at the
        vertical speed ``u`` in [0, 1) maps to in [-1.5, 1.5)."""
        vy = uniform_between(u, -1.5, 1.5)
        return (torch.full_like(vy, self.W / 2), torch.full_like(vy, self.H / 2),
                direction * self.BALL_VX0, vy)

    def reset_from(self, noise):
        direction = torch.where(noise[:, 1] < 0.5, 1.0, -1.0)  # jax.random.bernoulli
        bx, by, vx, vy = self._serve(noise[:, 0], direction)
        c = torch.full_like(bx, self.H / 2)
        zero = torch.zeros(bx.shape, dtype=torch.int32, device=bx.device)
        state = PongState(ball_x=bx, ball_y=by, vel_x=vx, vel_y=vy,
                          prev_bx=bx, prev_by=by, prev_ay=c, prev_oy=c, agent_y=c, opp_y=c,
                          agent_score=zero, opp_score=zero)
        return state, self._render(state)

    # -- render --------------------------------------------------------------
    def _frame(self, ball_y, ball_x, agent_y, opp_y, agent_score, opp_score):
        rows, cols = self._rows, self._cols

        def blob(cy, cx, hr, hc):
            return (torch.abs(rows - cy) <= hr) & (torch.abs(cols - cx) <= hc)

        def col(x):  # [N] -> [N, 1, 1]
            return x[:, None, None] if torch.is_tensor(x) else x

        img = torch.zeros((ball_y.shape[0], self.H, self.W), dtype=torch.float32, device=ball_y.device)
        score_row = rows < 2
        img = torch.where(score_row & (cols < col(opp_score)), 0.25, img)
        img = torch.where(score_row & (cols >= col(self.W - agent_score)), 0.25, img)
        img = torch.where(blob(col(opp_y), self.OPP_PLANE - 1.0, self.PADDLE_HALF, 0.5), 0.75, img)
        img = torch.where(blob(col(agent_y), self.AGENT_PLANE + 1.0, self.PADDLE_HALF, 0.5), 0.75, img)
        img = torch.where(blob(col(ball_y), col(ball_x), 1.0, 1.0), 1.0, img)
        return img

    def _render(self, s: PongState):
        """[N, H, W, 2]: channel 0 now, channel 1 the previous decision's
        frame (score bars at the current scores in both)."""
        now = self._frame(s.ball_y, s.ball_x, s.agent_y, s.opp_y, s.agent_score, s.opp_score)
        prev = self._frame(s.prev_by, s.prev_bx, s.prev_ay, s.prev_oy, s.agent_score, s.opp_score)
        return torch.stack([now, prev], dim=-1)

    # -- dynamics ------------------------------------------------------------
    def step(self, s: PongState, actions, noise):
        prev = (s.ball_x, s.ball_y, s.agent_y, s.opp_y)
        reward = torch.zeros_like(s.ball_x)
        terminated = torch.zeros_like(s.ball_x, dtype=torch.bool)
        for i in range(self.frame_skip):
            s2, r, t = self._substep(s, actions, noise[:, i, 0])
            # substeps after a terminal one are frozen: no integration, no reward
            s = dataclasses.replace(s, **{
                f.name: torch.where(terminated, getattr(s, f.name), getattr(s2, f.name))
                for f in dataclasses.fields(s)
            })
            reward = reward + torch.where(terminated, 0.0, r)
            terminated = terminated | t
        s = dataclasses.replace(s, prev_bx=prev[0], prev_by=prev[1], prev_ay=prev[2], prev_oy=prev[3])
        return s, self._render(s), reward, terminated, {}

    def _paddle_bounce(self, crossed, plane, paddle_y, bx, by, vx, vy, vy_cap):
        hit = crossed & (torch.abs(by - paddle_y) <= self.PADDLE_HALF + 1.0)
        new_vx = -torch.sign(vx) * torch.clamp(torch.abs(vx) * 1.05, max=self.BALL_VX_MAX)
        new_vy = torch.clamp((by - paddle_y) / self.PADDLE_HALF * self.BALL_VY_MAX, -vy_cap, vy_cap)
        bx = torch.where(hit, 2.0 * plane - bx, bx)
        vx = torch.where(hit, new_vx, vx)
        vy = torch.where(hit, new_vy, vy)
        return bx, vx, vy

    def _substep(self, s: PongState, actions, u):
        move = (actions.to(torch.int32) - 1).to(torch.float32)
        agent_y = torch.clamp(s.agent_y + move * self.PADDLE_SPEED,
                              self.PADDLE_HALF, self.H - 1 - self.PADDLE_HALF)

        # scripted opponent: track the incoming ball, drift home otherwise
        inbound = s.vel_x < 0
        target = torch.where(inbound, s.ball_y, self.H / 2)
        speed = torch.where(inbound, self.OPP_SPEED, self.OPP_RETURN_SPEED)
        delta = target - s.opp_y
        step_y = torch.where(torch.abs(delta) <= self.OPP_DEADZONE, 0.0,
                             torch.minimum(torch.maximum(delta, -speed), speed))
        opp_y = torch.clamp(s.opp_y + step_y, self.PADDLE_HALF, self.H - 1 - self.PADDLE_HALF)

        # integrate the ball; bounce off the top and bottom walls
        x0 = s.ball_x
        bx = s.ball_x + s.vel_x
        by = s.ball_y + s.vel_y
        vx, vy = s.vel_x, s.vel_y
        by = torch.where(by < 0.0, -by, by)
        vy = torch.where(s.ball_y + s.vel_y < 0.0, -vy, vy)
        hi = float(self.H - 1)
        over = by > hi
        by = torch.where(over, 2.0 * hi - by, by)
        vy = torch.where(over, -vy, vy)

        crossed_agent = (x0 < self.AGENT_PLANE) & (bx >= self.AGENT_PLANE)
        bx, vx, vy = self._paddle_bounce(crossed_agent, self.AGENT_PLANE, agent_y, bx, by, vx, vy,
                                         self.BALL_VY_MAX)
        crossed_opp = (x0 > self.OPP_PLANE) & (bx <= self.OPP_PLANE)
        bx, vx, vy = self._paddle_bounce(crossed_opp, self.OPP_PLANE, opp_y, bx, by, vx, vy,
                                         self.OPP_VY_MAX)

        # a point: the ball reached a back wall
        agent_point = bx <= 0.0
        opp_point = bx >= float(self.W - 1)
        reward = agent_point.to(torch.float32) - opp_point.to(torch.float32)
        agent_score = s.agent_score + agent_point.to(torch.int32)
        opp_score = s.opp_score + opp_point.to(torch.int32)

        # re-serve after a point, toward the scorer (the loser receives)
        scored = agent_point | opp_point
        sx, sy, svx, svy = self._serve(u, torch.where(agent_point, -1.0, 1.0))
        bx = torch.where(scored, sx, bx)
        by = torch.where(scored, sy, by)
        vx = torch.where(scored, svx, vx)
        vy = torch.where(scored, svy, vy)

        state = dataclasses.replace(s, ball_x=bx, ball_y=by, vel_x=vx, vel_y=vy, agent_y=agent_y,
                                    opp_y=opp_y, agent_score=agent_score, opp_score=opp_score)
        terminated = (agent_score >= self.WIN_SCORE) | (opp_score >= self.WIN_SCORE)
        return state, reward, terminated
