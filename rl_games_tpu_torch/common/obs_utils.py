"""Small helpers shared by the trainers and the players.

Port of rl_games_tpu/common/obs_utils.py: ``to_device_obs`` (:13-24) and
``upload_obs``, through ``HostUpload``, take a host env's numpy
observations to the device (every key of a dict observation in the one
copy; a key of integers comes back as int64, the rest as float32);
``sigma_override_blocked`` and ``fill_sigma`` (:26-55) serve the
``--sigma`` override.
"""

from typing import List, Optional

import numpy as np
import torch


class HostUpload:
    """numpy arrays to float32 tensors on ``device``, several in one copy.

    On a CUDA device the arrays are packed into one pinned staging buffer
    and go up in one ``non_blocking`` copy (the buffer is written again only
    after that copy has read it); on the CPU each becomes a float32 copy.
    Booleans become 0/1 and uint8 frames float32, as the JAX package casts
    them (a2c_common.py:540-575)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._staging: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None

    def __call__(self, *arrays) -> List[torch.Tensor]:
        arrays = [np.asarray(a) for a in arrays]
        if self.device.type != "cuda":
            return [torch.tensor(a, dtype=torch.float32, device=self.device) for a in arrays]
        sizes = [a.size for a in arrays]
        total = sum(sizes)
        if self._staging is None or self._staging.numel() < total:
            self._staging = torch.empty(total, dtype=torch.float32, pin_memory=True)
            self._copied = torch.cuda.Event()
        else:
            self._copied.synchronize()  # the last copy has read the buffer
        host = self._staging.numpy()
        offset = 0
        for a, n in zip(arrays, sizes):
            host[offset:offset + n] = a.reshape(-1)
            offset += n
        flat = self._staging[:total].to(self.device, non_blocking=True)
        self._copied.record()
        out, offset = [], 0
        for a, n in zip(arrays, sizes):
            out.append(flat[offset:offset + n].view(a.shape))
            offset += n
        return out


def upload_obs(upload: HostUpload, obs, *arrays):
    """A host env's observations and further ``arrays`` to ``upload``'s
    device in one copy: (the observations, a tensor or a dict of tensors;
    the arrays' tensors, a list). The JAX package keeps each key's dtype
    (obs_utils.py:13-24); here the copy is float32 and a key of integers
    (a last action that a network one-hot encodes) is cast back to int64
    on the device, exact below 2**24. Floats, booleans and uint8 frames stay
    float32: every reader of them (the normalizer, a concatenation, a
    layer) computes in float32 in the JAX package too."""
    if isinstance(obs, dict):
        keys = list(obs)
        out = upload(*(obs[k] for k in keys), *arrays)
        tensors = {k: (t.to(torch.int64) if np.issubdtype(np.asarray(obs[k]).dtype, np.integer) else t)
                   for k, t in zip(keys, out)}
        return tensors, out[len(keys):]
    out = upload(obs, *arrays)
    return out[0], out[1:]


def to_device_obs(obs, device, upload: Optional[HostUpload] = None):
    """A host env's observations as float32 tensors on ``device`` (see
    ``upload_obs``), through ``upload`` (a new ``HostUpload`` when None)."""
    return upload_obs(upload or HostUpload(device), obs)[0]


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
