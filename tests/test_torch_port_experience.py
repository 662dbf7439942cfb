"""Prioritized replay (rl_games_tpu_torch/common/experience.py) against the
JAX package's (rl_games_tpu/common/experience.py).

Port of tests/test_experience.py's five tests, the draws from
``torch.Generator``s (the frequencies within the same atol of 0.02 over
20,000 draws), and one test that hands the port the JAX package's Gumbel
draws (``jax.random.gumbel`` of the key that ``jax.random.categorical``
splits nothing from) and gets the JAX package's indexes, equal, and its
weights at rtol 1e-6: the same float32 formula, priorities raised to alpha
by each framework's pow.
"""

import jax
import numpy as np
import torch

from rl_games_tpu.common import experience as J
from rl_games_tpu_torch.common.experience import (
    prioritized_add,
    prioritized_init,
    prioritized_sample,
    prioritized_update,
)

torch.set_num_threads(1)


def _fill(state, n, alpha=0.6, start=0, add=prioritized_add):
    for i in range(start, start + n):
        state = add(state, np.full((1, 2), float(i)), np.zeros((1, 1)), np.asarray([float(i)]),
                    np.full((1, 2), float(i) + 0.5), np.asarray([False]), alpha=alpha)
    return state


def test_sampling_is_proportional_to_priority_alpha():
    """_sample_proportional draws index i with prob p_i^alpha / sum
    (experience.py:126-134)."""
    alpha = 1.0
    state = _fill(prioritized_init(4, (2,), (1,)), 4, alpha=alpha)
    state = prioritized_update(state, np.arange(4), np.asarray([1.0, 2.0, 4.0, 8.0]), alpha=alpha)
    _, _, idxes = prioritized_sample(state, torch.Generator().manual_seed(0), 20000, beta=0.4)
    freq = np.bincount(idxes.numpy(), minlength=4) / 20000
    np.testing.assert_allclose(freq, np.array([1, 2, 4, 8]) / 15, atol=0.02)


def test_importance_weights_formula_and_normalization():
    """weights = (N * P(i))^-beta / max_weight; the min-priority row has
    weight exactly 1 (experience.py:166-180)."""
    alpha, beta = 1.0, 0.5
    state = _fill(prioritized_init(4, (2,), (1,)), 4, alpha=alpha)
    ps = np.asarray([1.0, 2.0, 4.0, 8.0])
    state = prioritized_update(state, np.arange(4), ps, alpha=alpha)
    batch, weights, idxes = prioritized_sample(state, torch.Generator().manual_seed(1), 256, beta=beta)
    idxes, weights = idxes.numpy(), weights.numpy()
    p = ps / ps.sum()
    expected = (4 * p[idxes]) ** (-beta) / (4 * p[0]) ** (-beta)
    np.testing.assert_allclose(weights, expected, rtol=1e-5)
    assert weights.max() <= 1.0 + 1e-6
    # sampled rows decode to their stored transitions
    np.testing.assert_allclose(batch["obs"].numpy()[:, 0], idxes.astype(np.float32))
    np.testing.assert_allclose(batch["reward"].numpy(), idxes.astype(np.float32))


def test_new_rows_enter_at_max_priority_and_wrap():
    """add() assigns max_priority^alpha to fresh rows (experience.py:
    119-124); the ring overwrites the oldest rows on wraparound."""
    alpha = 0.6
    state = _fill(prioritized_init(4, (2,), (1,)), 4, alpha=alpha)
    state = prioritized_update(state, np.arange(4), np.asarray([0.1, 0.1, 0.1, 5.0]), alpha=alpha)
    assert float(state.max_priority) == 5.0
    state = _fill(state, 2, alpha=alpha, start=4)  # overwrite rows 0, 1
    np.testing.assert_allclose(state.p_alpha[:2].numpy(), np.full(2, 5.0 ** alpha), rtol=1e-6)
    np.testing.assert_allclose(state.obses[0].numpy(), [4.0, 4.0])
    assert state.size == 4 and state.idx == 2


def test_partial_fill_never_samples_empty_slots():
    """The JAX test also jits the sample; the port runs eagerly. An empty
    buffer samples uniformly over its first max(size, 1) rows with weights
    of 1, as the JAX package's fallback does."""
    state = _fill(prioritized_init(8, (2,), (1,)), 3)
    _, _, idxes = prioritized_sample(state, torch.Generator().manual_seed(2), 64, beta=0.4)
    assert int(idxes.max()) < 3
    _, weights, idxes = prioritized_sample(prioritized_init(8, (2,), (1,)), torch.Generator().manual_seed(2), 16,
                                           beta=0.4)
    assert torch.equal(idxes, torch.zeros(16, dtype=torch.int64)) and torch.equal(weights, torch.ones(16))


def test_zero_priority_update_keeps_row_sampleable():
    """A 0.0 TD-error priority must not turn a live row into the
    empty-slot sentinel (p_alpha == 0 is 'never sample'): the reference
    asserts priority > 0 (experience.py:199); prioritized_update clamps
    instead, so the row stays reachable."""
    state = _fill(prioritized_init(4, (2,), (1,)), 4)
    state = prioritized_update(state, np.arange(4), np.zeros(4))  # all-zero TD errors
    assert float(state.p_alpha.min()) > 0.0
    _, _, idxes = prioritized_sample(state, torch.Generator().manual_seed(0), 256, beta=0.4)
    # clamped rows sample uniformly; none became the empty sentinel
    assert set(idxes.tolist()) == {0, 1, 2, 3}


def test_jax_draws_give_jax_indexes_and_weights():
    """A capacity-16 buffer filled past its end (batched adds of 5, a wrap),
    priorities updated twice (a zero among them, the watermark raised):
    with the JAX key's Gumbel draws the port samples the JAX package's
    indexes and weights; its stored rows and priorities equal the JAX
    state's."""
    cap, batch, alpha, beta = 16, 64, 0.6, 0.4
    rng = np.random.default_rng(3)
    jstate, pstate = J.prioritized_init(cap, (3,), (2,)), prioritized_init(cap, (3,), (2,))
    for step in range(4):
        obs = rng.normal(size=(5, 3)).astype(np.float32)
        rows = (obs, rng.normal(size=(5, 2)), rng.normal(size=5), obs + 1.0, rng.random(5) < 0.3)
        jstate = J.prioritized_add(jstate, *rows, alpha=alpha)
        pstate = prioritized_add(pstate, *rows, alpha=alpha)
        if step in (1, 3):
            idx = rng.integers(0, cap, size=6)
            prio = np.abs(rng.normal(size=6)) * 3
            prio[0] = 0.0
            jstate = J.prioritized_update(jstate, idx, prio, alpha=alpha)
            pstate = prioritized_update(pstate, idx, prio, alpha=alpha)
    assert (int(jstate.idx), int(jstate.size)) == (pstate.idx, pstate.size) == (4, 16)
    np.testing.assert_array_equal(pstate.obses.numpy(), np.asarray(jstate.obses))
    np.testing.assert_allclose(pstate.p_alpha.numpy(), np.asarray(jstate.p_alpha), rtol=1e-6)
    assert float(pstate.max_priority) == float(jstate.max_priority)
    key = jax.random.PRNGKey(7)
    jbatch, jweights, jidx = J.prioritized_sample(jstate, key, batch, beta)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (batch, cap))))
    pbatch, pweights, pidx = prioritized_sample(pstate, None, batch, beta, noise=noise)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pweights.numpy(), np.asarray(jweights), rtol=1e-6)
    for k in ("obs", "action", "reward", "next_obs", "done"):
        np.testing.assert_array_equal(pbatch[k].numpy(), np.asarray(jbatch[k]))
