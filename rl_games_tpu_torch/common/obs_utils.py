"""The ``--sigma`` override helpers of rl_games_tpu/common/obs_utils.py
(:26-55); the observation helpers there belong to host envs and dict
observations, which are not ported yet."""

from typing import Optional

import torch


def sigma_override_blocked(is_continuous: bool,
                           network_cfg: dict) -> Optional[str]:
    """Why --sigma cannot apply, or None if it can (_override_sigma,
    torch_runner.py:52-60)."""
    if not is_continuous:
        return "Cannot set new sigma: action space is not continuous"
    fixed = (
        (network_cfg or {})
        .get("space", {})
        .get("continuous", {})
        .get("fixed_sigma", True)
    )
    if not fixed:
        return "Cannot set new sigma because fixed_sigma is False"
    return None


def fill_sigma(model, sigma: float):
    """Fill the fixed-sigma parameter with a constant, in place: the raw
    ``a2c_network.sigma`` is what the parametrization (exp/softplus)
    consumes, as in the reference's net.sigma.fill_()."""
    with torch.no_grad():
        model.a2c_network.sigma.fill_(float(sigma))
