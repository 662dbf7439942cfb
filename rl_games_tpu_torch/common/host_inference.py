"""Where the policy of a host-env rollout runs.

Port of rl_games_tpu/common/host_inference.py (:1-79). A host env
(GYMNASIUM, CPUENV, DMCONTROL) is stepped on the host, so each env step of
a rollout or of the player takes one policy forward whose actions the host
needs before it can step. ``host_inference_device`` (the PPO host path and
the players) places that forward; its values are the JAX package's:

  default — on the agent's device: every step sends the observations up
            and reads the actions (and values) back, one synchronisation
            per step; the trajectory is written on the device.
  cpu     — on a CPU copy of the policy, its weights and normalizer stats
            copied from the device once per epoch; the trajectory is
            written on the host and goes up once per epoch, where GAE and
            the minibatch updates stay on the device.
  auto    — on a CUDA agent, ``auto_placement`` of the config's network:
            the CPU copy for a plain MLP policy, the card for a conv torso
            or a fused MLP; on a CPU agent the two are the same.

``auto`` follows what chip_smoke.py measures on an NVIDIA H100 (PERF.md
§5): at ref/mujoco/halfcheetah.yaml's geometry (64 envs, MLP [128, 64, 32])
the CPU copy's rollout is the faster ([host_ppo]); at ref/atari's
nature-CNN over 64 envs of 84x84x4 frames, about 0.6 G multiply-adds a
step, the card's is ([host_pixel]). Both phases fail when ``auto`` no
longer names the faster. A fused MLP stays on the card because its kernel
runs only there: the config asked for it, and ``cpu`` still moves it (onto
the plain chain). The JAX package's reason for the split (a remote
accelerator behind a relay) does not carry over. SAC keeps every forward
on the agent's device, as the JAX package does, since its updates run
between the env steps anyway.
"""

import torch

PLACEMENTS = ("auto", "cpu", "default")


def auto_placement(network: dict) -> str:
    """The placement ``auto`` takes on a card for a policy built from the
    config's ``network`` section."""
    if network.get("cnn") or (network.get("mlp") or {}).get("fused", False):
        return "default"
    return "cpu"


def rollout_device(preference, device: torch.device, network: dict) -> torch.device:
    """The device of a host-env rollout's policy for a
    ``host_inference_device`` value (None reads as auto)."""
    preference = "auto" if preference is None else preference
    if preference not in PLACEMENTS:
        raise ValueError(f"host_inference_device: unknown value {preference!r} (expected auto | cpu | default)")
    if preference == "auto":
        preference = auto_placement(network) if device.type == "cuda" else "default"
    return torch.device("cpu") if preference == "cpu" else device
