"""The device that the port's entry points run on, and its float32 precision."""

import torch


def use_full_float32(device: torch.device):
    """On a CUDA device, float32 matrix products and convolutions in full
    float32, as the JAX reference computes them: PyTorch's default lets
    cuDNN run float32 convolutions in TF32 (about three decimal digits).
    The entry points that compute on a device (``PPOAgent``, ``BasePlayer``)
    call it with their device."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


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
