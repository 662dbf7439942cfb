"""The device that the port's entry points run on."""

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when it is None; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rl_games_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)
