"""Observation transforms for soft augmentation.

Port of rl_games_tpu/common/transforms.py (the reference's
common/transforms/transforms.py ImageDatasetTransform: replication-pad 4
and a random crop, DrQ's random shift) and its Gaussian variant for vector
observations. The transforms are pure over their draws (``random_shift``
takes each sample's offsets, ``gaussian_noise`` its standard normals);
``build_transform`` returns ``transform(generator, obs)``, which draws them
from the generator.
"""

import torch
import torch.nn.functional as F


def random_shift(obs, ys, xs, pad: int = 4):
    """[B, H, W, C] images edge-padded by ``pad`` and cropped back to H x W
    at each sample's offset (ys[b], xs[b]) in [0, 2 · pad]."""
    b, h, w, _ = obs.shape
    padded = F.pad(obs.movedim(-1, 1), (pad, pad, pad, pad), mode="replicate").movedim(1, -1)
    rows = ys.to(torch.int64)[:, None] + torch.arange(h, device=obs.device)  # [B, H]
    cols = xs.to(torch.int64)[:, None] + torch.arange(w, device=obs.device)  # [B, W]
    batch = torch.arange(b, device=obs.device)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


def gaussian_noise(obs, noise, std: float = 0.05):
    """Additive Gaussian noise: ``noise`` holds standard normals of obs's shape."""
    return obs + std * noise


def build_transform(cfg: dict):
    """The configured transform as ``transform(generator, obs)``."""
    name = cfg.get("name", "random_shift")
    if name in ("random_shift", "image"):
        pad = int(cfg.get("pad", 4))

        def shift(generator, obs):
            offsets = torch.randint(0, 2 * pad + 1, (2, obs.shape[0]), generator=generator,
                                    device=generator.device).to(obs.device)
            return random_shift(obs, offsets[0], offsets[1], pad)

        return shift
    if name == "gaussian_noise":
        std = float(cfg.get("std", 0.05))

        def noisy(generator, obs):
            noise = torch.randn(obs.shape, generator=generator, device=generator.device, dtype=obs.dtype)
            return gaussian_noise(obs, noise.to(obs.device), std)

        return noisy
    raise ValueError(f"unknown soft-augmentation transform: {name}")
