"""Lagrangian dynamics factors for the planar device envs, batched.

Port of rl_games_tpu/envs/jax/lagrangian.py ``lagrangian_factors_2d``
(:168-214). For kinematics x(q) = [body COMs, body angles] with kinetic
energy T = ½ ẋᵀWẋ (W = m, m per COM, I per angle) the Euler-Lagrange
equations are M(q) q̈ + b(q, q̇) = τ with

    M = Jᵀ W J,   b = Jᵀ (W J̇q̇ + g-weights),   J = ∂x/∂q,

where gravity's ∇V = g · (m-weighted y-rows of J). The JAX package takes J
and J̇q̇ by autodiff through scalar-form kinematics (a layout for the TPU's
lanes); here the env supplies them batched over envs, in closed form:
``torch.func``'s jvp costs ~100× the kinematics themselves in host time
per call, and the rollout is bound by the host.
"""

import torch


def lagrangian_factors_2d(kinematics_fn, masses, inertias, q, qd, gravity=9.81):
    """M, bias, contact Jacobian and contact points for a batch of envs.

    kinematics_fn(q [N, nq], qd) -> (x [N, K], J [N, K, nq], a [N, K]): the
    flattened kinematics x = [COMs (nb × 2), angles (nb), contacts
    (nc × 2)], its Jacobian ∂x/∂q and J̇q̇. masses/inertias: [nb]. Returns
    (M [N, nq, nq], bias [N, nq], contact_jac [N, nc, 2, nq],
    contacts [N, nc, 2]); bias includes ∇V for gravity along -y.
    """
    n, nq = q.shape
    nb = masses.shape[0]
    nk = 3 * nb  # 2 COM coordinates + 1 angle per body
    x, J, acc = kinematics_fn(q, qd)
    nc = (x.shape[1] - nk) // 2
    wvec = torch.cat([masses.repeat_interleave(2), inertias])
    gvec = torch.zeros(nk, dtype=q.dtype, device=q.device)
    gvec[1:2 * nb:2] = gravity * masses
    Jt = J[:, :nk].transpose(1, 2)  # [N, nq, nk]
    M = Jt @ (wvec[:, None] * J[:, :nk])
    bias = (Jt @ (wvec * acc[:, :nk] + gvec)[..., None]).squeeze(-1)
    contact_jac = J[:, nk:].reshape(n, nc, 2, nq)
    return M, bias, contact_jac, x[:, nk:].reshape(n, nc, 2)
