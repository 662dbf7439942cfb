"""GAE in the PyTorch port against the JAX package.

The port's ``compute_gae`` on CPU tensors (its plain loop) is held against
JAX ``gae_scan`` and against the Pallas kernel run in interpret mode, on
the matrix of tests/test_gae.py: V in {1, 2}, done probabilities from 0 to
1, and env counts that are not multiples of 128. Tolerance: atol = rtol =
1e-5, the bound tests/test_gae.py holds the JAX backends to; both sides
compute in float32 with sums in the same order.
"""

import numpy as np
import pytest
import torch

from rl_games_tpu.ops import gae as jgae
from rl_games_tpu_torch.ops import gae as tgae

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def make_case(T, N, V, seed, done_p):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, N, V)).astype(np.float32)
    values = rng.normal(size=(T, N, V)).astype(np.float32)
    dones = (rng.random((T, N)) < done_p).astype(np.float32)
    last_values = rng.normal(size=(N, V)).astype(np.float32)
    last_dones = (rng.random(N) < done_p).astype(np.float32)
    return rewards, values, dones, last_values, last_dones


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("done_p", [0.0, 0.15, 1.0])
@pytest.mark.parametrize("N", [7, 130])
def test_compute_gae_matches_jax(V, done_p, N):
    args = make_case(T=12, N=N, V=V, seed=N * 10 + V, done_p=done_p)
    before = tgae.gae_launches
    got = tgae.compute_gae(*_torch(args), 0.99, 0.95).numpy()
    assert tgae.gae_launches == before == 0  # the CPU never launches the kernel
    np.testing.assert_allclose(got, np.asarray(jgae.gae_scan(*args, 0.99, 0.95)), **TOL)
    pallas = jgae.gae_pallas(*args, 0.99, 0.95, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("V", [1, 2])
def test_discounted_returns_matches_jax(V):
    rewards, _, dones, last_values, last_dones = make_case(T=9, N=5, V=V, seed=3, done_p=0.2)
    args = (rewards, dones, last_values, last_dones)
    got = tgae.discounted_returns(*_torch(args), 0.9).numpy()
    np.testing.assert_allclose(got, np.asarray(jgae.discounted_returns(*args, 0.9)), **TOL)
    assert tgae.gae_launches == 0


def test_gae_cuda_refuses_cpu_tensors():
    args = _torch(make_case(T=4, N=3, V=1, seed=0, done_p=0.1))
    with pytest.raises(ValueError, match="must lie on"):
        tgae.gae_cuda(*args, 0.99, 0.95)
    assert tgae.gae_launches == 0
