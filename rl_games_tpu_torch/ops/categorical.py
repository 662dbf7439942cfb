"""C51 categorical distributional-RL projection.

Port of rl_games_tpu/ops/categorical.py (the reference's
``CategoricalQ.distr_projection``, rl_games/common/categorical.py:4-51): the
Categorical Algorithm of "A Distributional Perspective on RL" (Bellemare et
al. 2017). As in the JAX package the projection is dense: every (sample,
source atom) pair splits its mass between its floor and ceil atoms, and the
scatter is a batched product with the one-hot projection weights. No
trainer uses it, in either package or the reference.
"""

import torch


class CategoricalQ:
    """Projection onto an ``n_atoms`` grid over [v_min, v_max]."""

    def __init__(self, n_atoms, v_min, v_max):
        self.n_atoms = int(n_atoms)
        self.v_min = float(v_min)
        self.v_max = float(v_max)
        self.delta_z = (self.v_max - self.v_min) / (self.n_atoms - 1)

    def _project_values(self, z):
        """Weights [..., A, A]: the mass that a unit at z[..., j] puts on atom
        k. u == l puts all of it on l; otherwise (u - b) goes to l and
        (b - l) to u (categorical.py:21-31)."""
        tz = torch.clamp(z, self.v_min, self.v_max)
        b = (tz - self.v_min) / self.delta_z
        lo = torch.floor(b)
        up = torch.ceil(b)
        atoms = torch.arange(self.n_atoms, dtype=b.dtype, device=b.device)
        onehot_l = (lo[..., None] == atoms).to(b.dtype)
        onehot_u = (up[..., None] == atoms).to(b.dtype)
        eq = (up == lo)[..., None]
        w_l = torch.where(eq, onehot_l, onehot_l * (up - b)[..., None])
        w_u = torch.where(eq, torch.zeros_like(onehot_u), onehot_u * (b - lo)[..., None])
        return w_l + w_u

    def distr_projection(self, next_distr, rewards, dones, gamma):
        """next_distr [B, A] probabilities, rewards [B], dones [B] (a done
        row is a delta at its clipped reward), scalar gamma -> the projected
        target distribution [B, A]."""
        next_distr = torch.as_tensor(next_distr, dtype=torch.float32)
        device = next_distr.device
        rewards = torch.as_tensor(rewards, dtype=torch.float32, device=device)
        dones = torch.as_tensor(dones, device=device).to(torch.bool)
        atoms = self.v_min + self.delta_z * torch.arange(self.n_atoms, dtype=torch.float32, device=device)
        # a non-terminal row's source atom j lands at r + gamma * z_j
        z = rewards[:, None] + gamma * atoms[None, :]
        proj = torch.einsum("ba,bak->bk", next_distr, self._project_values(z))
        return torch.where(dones[:, None], self._project_values(rewards), proj)
