"""Ant2D — a device-resident planar quadruped, batched over envs.

Port of rl_games_tpu/envs/jax/ant2d.py. A free-floating torso (x, z,
pitch) with 4 legs × 2 hinged links: 11 generalized coordinates, 8
actuated. It is the planar walker of locomotion2d.py at its default
morphology (the JAX package's PlanarWalker defaults are Ant2D's
constants): closed-form Jacobian and J̇q̇, penalty contacts, reward
forward velocity + 0.5 alive − 0.25 ctrl, termination when the torso falls
below 0.12 or pitches past 1.3 rad.

The JAX package unrolls an 11×11 Cholesky in scalar form to suit the TPU's
lanes; here the factorization and solves are batched library calls
(``torch.linalg.cholesky_ex`` without its error check, which would cost a
device sync per step, and ``torch.cholesky_solve``). As in the JAX package
the mass matrix and contact Jacobian are computed once per control step
and held across its integration substeps.
"""

from rl_games_tpu_torch.envs.device.lagrangian import LocomotionState, lagrangian_factors_2d  # noqa: F401
from rl_games_tpu_torch.envs.device.locomotion2d import PlanarWalker

LINK_L = 0.28
HIP_X = (-0.25, -0.08, 0.08, 0.25)  # hip attachment points along the torso
GRAVITY = 9.81

Ant2DState = LocomotionState


class Ant2D(PlanarWalker):
    """Planar quadruped locomotion. obs 26, act 8, episode 1000 steps."""

    OBS_DIM = 26  # z, pitch(sin,cos), 8 joints, 11 velocities, 4 contacts

    def __init__(self, device=None):
        super().__init__(HIP_X, link_l=LINK_L, device=device)
