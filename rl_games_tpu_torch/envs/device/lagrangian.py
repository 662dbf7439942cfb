"""Lagrangian dynamics factors for the device envs, batched.

Port of rl_games_tpu/envs/jax/lagrangian.py. For kinematics x(q) stacking
body COMs and orientations with kinetic energy T = ½ ẋᵀWẋ the
Euler-Lagrange equations are M(q) q̈ + b(q, q̇) = τ with

    M = Jᵀ W J,   b = Jᵀ (W J̇q̇ + g-weights),   J = ∂x/∂q,

where gravity's ∇V = g · (m-weighted vertical rows of J). Planar envs
(``lagrangian_factors_2d``) use x = [COMs (nb × 2), angles (nb)] with
weights [m, m per COM; I per angle]; the 3D envs (``lagrangian_factors``)
use x = [COMs (nb × 3), rotation entries (nb × 9)] with weights
[m, m, m per COM; I/2 per R entry] (‖Ṙ‖²_F = 2|ω|² for isotropic inertia).

The JAX package takes J and J̇q̇ by autodiff through scalar-form kinematics
(one ``jax.linearize`` tangent pass per coordinate and a jvp of a jvp), a
layout for the TPU's lanes. Here an env supplies them batched over envs:
the planar walkers in closed form (locomotion2d.py), the 3D envs and the
arm by evaluating their kinematics once on ``Jet``s of q, which carry each
value's gradient and its second derivative along q̇ through the same
batched tensor operations (``torch.func``'s jvp costs ~100× the kinematics
themselves in host time per call, and the rollout is bound by the host).

``LagrangianEnv`` is the integrator the locomotion envs share: factors and
the Cholesky factor of M once per control step, held across the substeps,
with the contact points advanced by contacts0 + J·(q − q0).
"""

import dataclasses
import functools

import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv


# ---------------------------------------------------------------------------
# Second-order jets
# ---------------------------------------------------------------------------


class Jet:
    """Values f(q) for a batch of envs, with their derivatives, in one
    tensor ``x`` of shape [3 + nq, *shape]:

        x[0] = f,   x[1] = ∇f·q̇,   x[2] = q̇ᵀ ∇²f q̇,   x[3 + i] = ∂f/∂q_i.

    x[2] is d²/ds² f(q + s q̇), so for the kinematics it is J̇q̇ (the
    acceleration at q̈ = 0). Products follow (uv)″ = u″v + 2u′v′ + uv″ and
    sin(u)″ = cos(u)·u″ − sin(u)·u′², so one pass over the kinematics
    written with +, −, ×, @, sin and cos gives x, J and J̇q̇. Plain tensors
    (no derivatives) combine with jets as constants, so the same kinematics
    code runs on tensors for the values alone.
    """

    __slots__ = ("x",)

    def __init__(self, x: torch.Tensor):
        self.x = x

    @staticmethod
    def variables(q: torch.Tensor, qd: torch.Tensor) -> "Jet":
        """The coordinates q [N, nq] as jets along the velocities qd."""
        n, nq = q.shape
        grad = torch.eye(nq, dtype=q.dtype, device=q.device)[:, None, :].expand(nq, n, nq)
        return Jet(torch.cat([q[None], qd[None], torch.zeros_like(q)[None], grad]))

    @property
    def value(self) -> torch.Tensor:
        return self.x[0]

    @property
    def curvature(self) -> torch.Tensor:
        """q̇ᵀ ∇²f q̇ [*shape]."""
        return self.x[2]

    @property
    def jacobian(self) -> torch.Tensor:
        """∂f/∂q as [*shape, nq]."""
        return self.x[3:].movedim(0, -1)

    # -- structure ----------------------------------------------------------
    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return Jet(self.x[(slice(None),) + idx])

    def reshape(self, *shape):
        return Jet(self.x.reshape(self.x.shape[0], *shape))

    def cumsum(self, dim: int):
        return Jet(self.x.cumsum(dim + 1 if dim >= 0 else dim))

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Jet):
            return Jet(self.x + other.x)
        value = self.x[0] + other
        return Jet(torch.cat([value[None], self.x[1:].expand(-1, *value.shape)]))

    __radd__ = __add__

    def __neg__(self):
        return Jet(-self.x)

    def __sub__(self, other):
        return self + (-other)

    def _product(self, other, op):
        u, w = self.x, other.x
        out = op(u[:1], w) + op(u, w[:1])  # first order; the value twice
        out[0].mul_(0.5)
        out[2].add_(op(u[1], w[1]), alpha=2.0)
        return Jet(out)

    def __mul__(self, other):
        if isinstance(other, Jet):
            return self._product(other, torch.mul)
        return Jet(self.x * other)

    __rmul__ = __mul__

    def __matmul__(self, other):
        if isinstance(other, Jet):
            return self._product(other, torch.matmul)
        return Jet(self.x @ other)

    def sincos(self):
        """(sin, cos) of the jet, sharing the trigonometry of its value."""
        v, t2 = self.x[0], torch.square(self.x[1])
        s, c = torch.sin(v), torch.cos(v)
        sin, cos = self.x * c, self.x * (-s)
        sin[0], cos[0] = s, c
        sin[2].sub_(s * t2)
        cos[2].sub_(c * t2)
        return Jet(sin), Jet(cos)


def sincos(a):
    """(sin a, cos a) for a tensor or a Jet."""
    if isinstance(a, Jet):
        return a.sincos()
    return torch.sin(a), torch.cos(a)


def cat(items, dim: int):
    """torch.cat over tensors, or over Jets (which all must be)."""
    if isinstance(items[0], Jet):
        return Jet(torch.cat([j.x for j in items], dim + 1 if dim >= 0 else dim))
    return torch.cat(items, dim)


def stack(items, dim: int):
    if isinstance(items[0], Jet):
        return Jet(torch.stack([j.x for j in items], dim + 1 if dim >= 0 else dim))
    return torch.stack(items, dim)


# ---------------------------------------------------------------------------
# Rotations (lagrangian.py:47-93), batched: [..., 3, 3] from angles [...]
# ---------------------------------------------------------------------------

# R(a) = FIXED + cos(a)·COS + sin(a)·SIN, entries as in the JAX package's
# tuples; the zero and unit terms add nothing to the rounding
_ROT = {
    "x": ((1, 0, 0, 0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 1, 0, 0, 0, 1), (0, 0, 0, 0, 0, -1, 0, 1, 0)),
    # the JAX package's rot_y: e_x maps to (cos a, 0, +sin a)
    "y": ((0, 0, 0, 0, 1, 0, 0, 0, 0), (1, 0, 0, 0, 0, 0, 0, 0, 1), (0, 0, -1, 0, 0, 0, 1, 0, 0)),
    "z": ((0, 0, 0, 0, 0, 0, 0, 0, 1), (1, 0, 0, 0, 1, 0, 0, 0, 0), (0, -1, 0, 1, 0, 0, 0, 0, 0)),
}


@functools.lru_cache(maxsize=None)
def _rot_terms(axis: str, dtype, device):
    # made once per device: a tensor copied from the host every call would
    # wait for the card
    return tuple(torch.tensor(m, dtype=dtype, device=device).reshape(3, 3) for m in _ROT[axis])


def _rot(axis: str, a):
    ref = a.x if isinstance(a, Jet) else a
    fixed, cos_m, sin_m = _rot_terms(axis, ref.dtype, ref.device)
    s, c = sincos(a)
    return c[..., None, None] * cos_m + s[..., None, None] * sin_m + fixed


def rot_x(a):
    return _rot("x", a)


def rot_y(a):
    return _rot("y", a)


def rot_z(a):
    return _rot("z", a)


def euler_zyx(roll, pitch, yaw):
    """World-from-body R = Rz(yaw) @ Ry(pitch) @ Rx(roll), the standard ZYX
    Euler matrix (lagrangian.py euler_zyx :68-78). The JAX package's rot_y
    turns the other way from the standard Ry, hence rot_y(-pitch)."""
    return rot_z(yaw) @ rot_y(-pitch) @ rot_x(roll)


def jet_kinematics(frames_fn, q, qd):
    """(x [N, K], J = ∂x/∂q [N, K, nq], J̇q̇ [N, K]) of the flattened
    frames_fn(q) = (coms, orientations, contacts), each [N, nb, ...],
    from one pass over jets of q along qd."""
    n = q.shape[0]
    parts = frames_fn(Jet.variables(q, qd))
    flat = cat([p.reshape(n, -1) for p in parts], dim=1)
    return flat.value, flat.jacobian, flat.curvature


# ---------------------------------------------------------------------------
# Factors
# ---------------------------------------------------------------------------


def _factors(kinematics_fn, q, qd, wvec, gvec, cdim):
    n, nq = q.shape
    nk = wvec.shape[0]
    x, J, acc = kinematics_fn(q, qd)
    nc = (x.shape[1] - nk) // cdim
    Jt = J[:, :nk].transpose(1, 2)  # [N, nq, nk]
    M = Jt @ (wvec[:, None] * J[:, :nk])
    bias = (Jt @ (wvec * acc[:, :nk] + gvec)[..., None]).squeeze(-1)
    contact_jac = J[:, nk:].reshape(n, nc, cdim, nq)
    return M, bias, contact_jac, x[:, nk:].reshape(n, nc, cdim)


def lagrangian_factors_2d(kinematics_fn, masses, inertias, q, qd, gravity=9.81):
    """M, bias, contact Jacobian and contact points for a batch of planar envs
    (lagrangian.py:168-214).

    kinematics_fn(q [N, nq], qd) -> (x [N, K], J [N, K, nq], a [N, K]): the
    flattened kinematics x = [COMs (nb × 2), angles (nb), contacts
    (nc × 2)], its Jacobian ∂x/∂q and J̇q̇. masses/inertias: [nb]. Returns
    (M [N, nq, nq], bias [N, nq], contact_jac [N, nc, 2, nq],
    contacts [N, nc, 2]); bias includes ∇V for gravity along -y.
    """
    nb = masses.shape[0]
    wvec = torch.cat([masses.repeat_interleave(2), inertias])
    gvec = torch.zeros(3 * nb, dtype=q.dtype, device=q.device)
    gvec[1:2 * nb:2] = gravity * masses
    return _factors(kinematics_fn, q, qd, wvec, gvec, 2)


def lagrangian_factors(kinematics_fn, masses, inertias, q, qd, gravity=9.81):
    """The 3D form (lagrangian.py:111-165): kinematics x = [COMs (nb × 3),
    rotation entries (nb × 9), contacts (nc × 3)], weights [m, m, m per
    COM; I/2 per R entry]. Returns (M [N, nq, nq], bias [N, nq],
    contact_jac [N, nc, 3, nq], contacts [N, nc, 3]); bias includes ∇V for
    gravity along -z."""
    nb = masses.shape[0]
    wvec = torch.cat([masses.repeat_interleave(3), (0.5 * inertias).repeat_interleave(9)])
    gvec = torch.zeros(12 * nb, dtype=q.dtype, device=q.device)
    gvec[2:3 * nb:3] = gravity * masses
    return _factors(kinematics_fn, q, qd, wvec, gvec, 3)


# ---------------------------------------------------------------------------
# The integrator of the locomotion envs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LocomotionState:
    q: torch.Tensor  # [N, nq]
    qd: torch.Tensor  # [N, nq]
    last_x: torch.Tensor  # [N]


class LagrangianEnv(DeviceEnv):
    """A free-floating body on penalty-contact ground, driven by joint
    torques: the step scheme of ant2d/ant3d/humanoid3d/locomotion2d.py.
    Subclasses set the constants below, ``masses``, ``inertias``,
    ``reg = 1e-6 I``, and define ``kinematics(q, qd)`` (the contract of the
    factors function), ``joint_torques(q, qd, action)``,
    ``terminated(q)`` and ``_obs(q, qd)``. Reward: forward_scale × forward
    velocity + alive_bonus − ctrl_cost × |action|²."""

    factors = staticmethod(lagrangian_factors)
    gravity = 9.81
    dt = 0.02
    substeps = 4
    k_ground = 900.0
    d_ground = 9.0
    mu_friction = 0.9
    forward_scale = 1.0

    def joint_torques(self, q, qd, action):
        raise NotImplementedError

    def terminated(self, q):
        raise NotImplementedError

    def step_factors(self, q, qd):
        """Cholesky factor of M(q), bias, contact Jacobian and contact points,
        once per control step (ant3d.py _step_factors)."""
        M, bias, jac, pts0 = self.factors(
            self.kinematics, self.masses, self.inertias, q, qd, self.gravity
        )
        # no error check: it would cost a device sync per step
        chol, _ = torch.linalg.cholesky_ex(M + self.reg)
        return chol, bias, jac, pts0

    def substep_qdd(self, q, qd, action, chol, bias, jac, pts):
        """Per-substep forces (torques, damping, limits, penalty contacts
        with Coulomb-style friction) and the solve M q̈ = rhs
        (ant3d.py _substep_qdd)."""
        vel = torch.einsum("nfcq,nq->nfc", jac, qd)  # [N, nc, dim]
        depth = torch.clamp(-pts[..., -1], min=0.0)
        in_contact = (depth > 0.0).to(q.dtype)
        fn_mag = self.k_ground * depth - self.d_ground * vel[..., -1] * in_contact
        fn_mag = torch.clamp(fn_mag, min=0.0) * in_contact
        ft = -self.mu_friction * fn_mag[..., None] * torch.tanh(vel[..., :-1] * 10.0)
        f_contact = torch.cat([ft, fn_mag[..., None]], dim=-1)
        tau_contact = torch.einsum("nfcq,nfc->nq", jac, f_contact)
        rhs = self.joint_torques(q, qd, action) + tau_contact - bias
        return torch.cholesky_solve(rhs[..., None], chol).squeeze(-1)

    def integrate(self, q, qd, action):
        """One control step of semi-implicit Euler substeps, the factors held."""
        h = self.dt / self.substeps
        q0 = q
        chol, bias, jac, pts0 = self.step_factors(q, qd)
        for _ in range(self.substeps):
            # contacts advance by the held Jacobian, not a fresh kinematics pass
            pts = pts0 + torch.einsum("nfcq,nq->nfc", jac, q - q0)
            qdd = self.substep_qdd(q, qd, action, chol, bias, jac, pts)
            qd = torch.clamp(qd + h * qdd, -50.0, 50.0)
            q = q + h * qd
        return q, qd

    def step(self, estate: LocomotionState, actions, noise=None):
        action = torch.clamp(actions, -1.0, 1.0)
        q, qd = self.integrate(estate.q, estate.qd, action)
        fwd_vel = (q[:, 0] - estate.last_x) / self.dt
        ctrl = self.ctrl_cost * torch.sum(torch.square(action), dim=-1)
        reward = self.forward_scale * fwd_vel + self.alive_bonus - ctrl
        state = LocomotionState(q=q, qd=qd, last_x=q[:, 0])
        return state, self._obs(q, qd), reward, self.terminated(q), {}


def soft_limit_force(joint_q, lo, hi, k):
    """-k · (how far each joint is past its limits)."""
    return -k * (torch.clamp(joint_q - hi, min=0.0) + torch.clamp(joint_q - lo, max=0.0))

