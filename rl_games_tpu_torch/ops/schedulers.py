"""Learning-rate / entropy-coefficient schedulers.

Port of rl_games_tpu/ops/schedulers.py (the reference's schedulers.py).
Each scheduler is ``update(lr, entropy_coef, epoch, frame, kl_dist) ->
(lr, entropy_coef)``. The LR is a 0-d tensor held in the train state, so an
update on the device needs no host read of the KL.
"""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class IdentityScheduler:
    """schedulers.py:10-16."""

    def update(self, lr, entropy_coef, epoch, frame, kl_dist):
        return lr, entropy_coef


@dataclass(frozen=True)
class AdaptiveScheduler:
    """KL-banded multiplicative LR (schedulers.py:19-33)."""

    kl_threshold: float = 0.008
    min_lr: float = 1e-6
    max_lr: float = 1e-2
    lr_multiplier: float = 1.5

    def update(self, lr, entropy_coef, epoch, frame, kl_dist):
        lr = torch.where(
            kl_dist > 2.0 * self.kl_threshold,
            torch.clamp(lr / self.lr_multiplier, min=self.min_lr),
            lr,
        )
        lr = torch.where(
            kl_dist < 0.5 * self.kl_threshold,
            torch.clamp(lr * self.lr_multiplier, max=self.max_lr),
            lr,
        )
        return lr, entropy_coef


@dataclass(frozen=True)
class LinearScheduler:
    """Linear anneal by epoch or frame, optional entropy anneal
    (schedulers.py:36-58)."""

    start_lr: float
    min_lr: float = 1e-6
    max_steps: int = 1000000
    use_epochs: bool = True
    apply_to_entropy: bool = False
    start_entropy_coef: float = 0.01
    min_entropy_coef: float = 0.0001

    def update(self, lr, entropy_coef, epoch, frame, kl_dist):
        steps = epoch if self.use_epochs else frame
        mul = torch.clamp((self.max_steps - steps).to(torch.float32), min=0.0) / self.max_steps
        lr = self.min_lr + (self.start_lr - self.min_lr) * mul
        if self.apply_to_entropy:
            entropy_coef = (
                self.min_entropy_coef
                + (self.start_entropy_coef - self.min_entropy_coef) * mul
            )
        return lr, entropy_coef


def build_scheduler(config: dict, base_lr: float):
    """Map a reference YAML config to a scheduler (a2c_common.py's parse of
    ``lr_schedule`` in {None/'identity', 'adaptive', 'linear'})."""
    name = config.get("lr_schedule", None)
    if name == "adaptive":
        return AdaptiveScheduler(
            kl_threshold=config.get("kl_threshold", 0.008),
            min_lr=float(config.get("min_lr", 1e-6)),
            max_lr=float(config.get("max_lr", 1e-2)),
            lr_multiplier=float(config.get("lr_multiplier", 1.5)),
        )
    if name == "linear":
        # reference rule (a2c_common.py:199-217): epoch-based over
        # max_epochs; max_epochs == -1 falls back to frame-based over
        # max_frames; neither set -> identity
        max_epochs = int(config.get("max_epochs", -1) or -1)
        max_frames = int(max(config.get("max_frames", -1), config.get("max_steps", -1)))
        if max_epochs <= 0 and max_frames <= 0:
            print(
                "Max epochs and max frames are not set. Linear learning "
                "rate schedule can't be used, switching to the constant "
                "(identity) one."
            )
            return IdentityScheduler()
        use_epochs = max_epochs > 0
        return LinearScheduler(
            start_lr=float(base_lr),
            min_lr=float(config.get("min_lr", 1e-6)),
            max_steps=max_epochs if use_epochs else max_frames,
            use_epochs=use_epochs,
            apply_to_entropy=config.get("schedule_entropy", False),
            start_entropy_coef=float(config.get("entropy_coef", 0.01)),
        )
    return IdentityScheduler()
