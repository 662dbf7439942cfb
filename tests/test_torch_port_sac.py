"""SAC in the port against the JAX SACAgent, and the port's own SAC tests.

Against the JAX package, on sac_pendulum.yaml cut to 4 envs, 4 steps per
epoch, MLP [32, 32], batch 16 and a ring of 64 rows (2 updates per env
step, policy_frequency 2): the replay functions, the squashed normal, the
networks with weights carried by ``sac_jax_to_state_dict``, one
``_update`` with and without the actor step, one ``train_epoch`` past
warmup, and one ``_update`` over sac_ant_tuned.yaml's layer-norm trunks,
plain and D2RL. The JAX programs' draws (sample indices, normals, uniforms) come
from the same key splits the JAX agent makes and are handed to the port.
The two JAX programs (the epoch and the update) compile in about 4 s and
2 s on the CPU.

Tolerances, stated per comparison: the replay functions bit for bit; what
a network computes at rtol 1e-5 (float32 in another summation order);
after one update and after the epoch, the weights at rtol 1e-5 / atol 1e-7
(one Adam step moves a weight by at most lr = 3e-4, so 1e-7 is 3e-4 of a
step) and Adam's moments at rtol 1e-5 / atol 1e-5 of each tensor's largest
entry. The epoch's replay rows and observations are held at rtol 1e-5 /
atol 1e-6, no looser than that: Pendulum's cos and sin differ in their last
bits between XLA and PyTorch (4.8e-7 at most here), which moves the
weights by 1.5e-8 at most after the epoch's 8 updates.

Then the port's counterparts of tests/test_sac.py and
tests/test_sac_correctness.py, on the port alone: warmup, Polyak, α,
epoch means, the replay-stripped resume gate, and replay rows, normalizer
counts and UTD accounting on a deterministic fake device env.
"""

import dataclasses
import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from rl_games_tpu.algos import sac as jsac
from rl_games_tpu.models import distributions as JD
from rl_games_tpu.models.sac import build_sac_networks as jbuild_sac_networks
from rl_games_tpu_torch.algos import sac as tsac
from rl_games_tpu_torch.algos.sac import SACAgent
from rl_games_tpu_torch.envs import registry
from rl_games_tpu_torch.envs.device.base import DeviceEnv
from rl_games_tpu_torch.envs.spaces import Box, EnvInfo
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models.sac import build_sac_networks
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.jax_params import sac_jax_to_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
N, A, OBS = 4, 1, 3  # Pendulum: 4 envs, 1 action, 3 observations
BATCH, CAP = 16, 64


def pendulum_params(**config):
    params = yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / "sac_pendulum.yaml").read_text())["params"]
    params["network"]["mlp"]["units"] = [32, 32]
    params["config"].update({"num_actors": N, "num_steps_per_episode": 4, "batch_size": BATCH,
                             "replay_buffer_size": CAP, "num_warmup_steps": 1, "utd_ratio": 0.5,
                             "print_stats": False, **config})
    return params


def t(x):
    return torch.from_numpy(np.array(x))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# replay: bit for bit
# ---------------------------------------------------------------------------


def replay_pair(cap, obs_dim=2):
    return jsac.replay_init(cap, (obs_dim,), 1), tsac.replay_init(cap, (obs_dim,), 1, "cpu")


def assert_same_replay(jbuf, buf):
    for f in ("obses", "next_obses", "actions", "rewards", "dones", "truncated"):
        np.testing.assert_array_equal(getattr(buf, f).numpy(), np.asarray(getattr(jbuf, f)), err_msg=f)
    assert (buf.idx, buf.full) == (int(jbuf.idx), bool(jbuf.full))
    assert tsac.replay_size(buf) == int(jsac.replay_size(jbuf))


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "valid_mask"])
def test_replay_add_matches_jax(masked):
    """Six adds of 3 rows into a ring of 10: the ring wraps and fills; with
    a mask, invalid rows take no slot and do not move the cursor."""
    rng = np.random.default_rng(0)
    jbuf, buf = replay_pair(10)
    for i in range(6):
        obs = rng.standard_normal((3, 2)).astype(np.float32)
        rows = dict(action=rng.standard_normal((3, 1)).astype(np.float32),
                    reward=rng.standard_normal(3).astype(np.float32),
                    next_obs=rng.standard_normal((3, 2)).astype(np.float32),
                    done=rng.random(3) < 0.3, truncated=rng.random(3) < 0.3)
        valid = (rng.random(3) < 0.6) if masked else None
        jbuf = jsac.replay_add(jbuf, obs, rows["action"], rows["reward"], rows["next_obs"], rows["done"],
                               rows["truncated"], valid=None if valid is None else jnp.asarray(valid))
        tsac.replay_add(buf, t(obs), t(rows["action"]), t(rows["reward"]), t(rows["next_obs"]), t(rows["done"]),
                        t(rows["truncated"]), valid=None if valid is None else t(valid))
        assert_same_replay(jbuf, buf)
    assert buf.full or masked


def test_replay_sample_matches_jax():
    """Sampling at the indices the JAX key draws gives the JAX rows; the
    port's own draws stay inside the filled rows."""
    rng = np.random.default_rng(1)
    jbuf, buf = replay_pair(100, obs_dim=1)
    obs = rng.standard_normal((5, 1)).astype(np.float32)
    args = (obs, np.ones((5, 1), np.float32), np.arange(5.0, dtype=np.float32), obs + 1,
            np.array([0, 1, 0, 0, 1], bool), np.array([1, 0, 0, 0, 0], bool))
    jbuf = jsac.replay_add(jbuf, *args)
    tsac.replay_add(buf, *(t(a) for a in args))
    key = jax.random.PRNGKey(3)
    idx = jax.random.randint(key, (64,), 0, 5)
    want = jsac.replay_sample(jbuf, key, 64)
    got = tsac.replay_sample(buf, None, 64, idx=t(idx).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    own = tsac.replay_sample(buf, torch.Generator().manual_seed(0), 64)
    assert own[0].shape == (64, 1) and own[2].shape == (64, 1)
    assert set(own[2].reshape(-1).tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}


# ---------------------------------------------------------------------------
# squashed normal and networks
# ---------------------------------------------------------------------------


def test_squashed_normal_matches_jax():
    rng = np.random.default_rng(2)
    mu = rng.standard_normal((64, 3)).astype(np.float32) * 2
    std = np.exp(rng.uniform(-5, 2, (64, 3))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jaction, jpre = JD.squashed_normal_sample(key, jnp.asarray(mu), jnp.asarray(std))
    noise = jax.random.normal(key, mu.shape, jnp.float32)
    action, pre = D.squashed_normal_sample(t(mu), t(std), t(noise))
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(action.numpy(), np.asarray(jaction), rtol=1e-6, atol=1e-7)
    # with the pre-tanh value, and recovered from the action by atanh (whose
    # clip at 1 - 1e-6 makes the large |u| rows agree only as far as the clip)
    for pre_arg in (t(np.asarray(jpre)), None):
        got = D.squashed_normal_logp(t(np.asarray(jaction)), t(mu), t(std), pre_arg)
        want = JD.squashed_normal_logp(jaction, jnp.asarray(mu), jnp.asarray(std),
                                       None if pre_arg is None else jpre)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_networks_match_jax():
    """Actor (mu, std) and critic (Q1, Q2) with the JAX weights carried."""
    net = pendulum_params()["network"]
    jactor, jcritic = jbuild_sac_networks(net, A)
    obs = np.random.default_rng(3).standard_normal((50, OBS)).astype(np.float32)
    action = np.tanh(np.random.default_rng(4).standard_normal((50, A))).astype(np.float32)
    ja = jactor.init(jax.random.PRNGKey(0), obs)
    jc = jcritic.init(jax.random.PRNGKey(1), obs, action)
    actor, critic = build_sac_networks(net, OBS, A)
    sd = sac_jax_to_state_dict(to_np(ja), to_np(jc))
    assert sorted(sd["actor"]) == sorted(actor.state_dict()) and sorted(sd["critic"]) == sorted(critic.state_dict())
    actor.load_state_dict(sd["actor"])
    critic.load_state_dict(sd["critic"])
    with torch.no_grad():
        got = (*actor(t(obs)), *critic(t(obs), t(action)))
    want = (*jactor.apply(ja, obs), *jcritic.apply(jc, obs, action))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# one update and one epoch against the JAX agent
# ---------------------------------------------------------------------------


def adam_of(opt):
    """The ScaleByAdamState inside an optax state."""
    return next(s for s in jax.tree_util.tree_leaves(opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState))


def moments_sd(opt):
    """Adam's count and moments of the JAX optimizer state ``opt`` as the
    port's AdamState for the module of ``agent`` they belong to."""
    adam = adam_of(opt)
    return int(adam.count), to_np(adam.mu), to_np(adam.nu)


def load_adam(port_opt, module, section, jopt, convert):
    count, mu, nu = moments_sd(jopt)
    names = [n for n, _ in module.named_parameters()]
    port_opt.count.fill_(count)
    for dst, tree in ((port_opt.mu, mu), (port_opt.nu, nu)):
        sd = convert(tree)[section]
        for i, name in enumerate(names):
            dst[i].copy_(sd[name])


def carry_state(jagent, jstate, params=None):
    """A port agent on the CPU (of ``params``, sac_pendulum.yaml's cut when
    None) and a state holding the JAX state: weights, normalizer, log α,
    optimizers, replay, env state, counters."""
    params = pendulum_params() if params is None else params
    agent = SACAgent("port", params, device="cpu")
    state = agent.init_state()
    js = to_np(jstate)
    sac_jax_to_state_dict = converter(params)
    sections = sac_jax_to_state_dict(js.actor_params, js.critic_params, js.critic_target_params, js.obs_rms)
    agent.actor.load_state_dict(sections["actor"])
    agent.critic.load_state_dict(sections["critic"])
    agent.critic_target.load_state_dict(sections["critic_target"])
    agent.running_mean_std.load_state_dict(sections["running_mean_std"])
    state.log_alpha.copy_(t(js.log_alpha))
    load_adam(state.actor_opt, agent.actor, "actor", js.actor_opt, lambda m: sac_jax_to_state_dict(m))
    load_adam(state.critic_opt, agent.critic, "critic", js.critic_opt,
              lambda m: sac_jax_to_state_dict(js.actor_params, m))
    alpha = adam_of(js.alpha_opt)
    state.alpha_opt.count.fill_(int(alpha.count))
    state.alpha_opt.mu[0].copy_(t(alpha.mu))
    state.alpha_opt.nu[0].copy_(t(alpha.nu))
    for f in ("obses", "next_obses", "actions", "rewards", "dones", "truncated"):
        getattr(state.replay, f).copy_(t(getattr(js.replay, f)))
    state.replay.idx, state.replay.full = int(js.replay.idx), bool(js.replay.full)
    state.env_state.estate.x = t(js.env_state.estate.x)
    state.env_state.steps = t(js.env_state.steps)
    state.obs = t(js.obs)
    state.epoch, state.frame, state.update_counter = int(js.epoch), int(js.frame), int(js.update_counter)
    state.current_rewards, state.current_lengths = t(js.current_rewards), t(js.current_lengths)
    for port_m, jm in ((state.game_rewards, js.game_rewards), (state.game_lengths, js.game_lengths)):
        port_m.buf[:-1] = t(jm.buf)
        port_m.ptr.fill_(int(jm.ptr))
        port_m.count.fill_(int(jm.count))
    return agent, state


def converter(params):
    """``sac_jax_to_state_dict`` for the trunks of ``params``."""
    return functools.partial(sac_jax_to_state_dict, d2rl=bool(params["network"]["mlp"].get("d2rl", False)))


def assert_matches(agent, state, jstate, weight_tol, adam_tol, params=None):
    """Weights, normalizer, log α and Adam's moments against the JAX state;
    the moments at rtol ``adam_tol`` and an atol of ``adam_tol`` times each
    tensor's largest entry (a gradient entry far below the largest carries
    the rounding of the largest)."""
    sac_jax_to_state_dict = converter(pendulum_params() if params is None else params)
    js = to_np(jstate)
    want = sac_jax_to_state_dict(js.actor_params, js.critic_params, js.critic_target_params, js.obs_rms)
    for name, module in (("actor", agent.actor), ("critic", agent.critic), ("critic_target", agent.critic_target),
                         ("running_mean_std", agent.running_mean_std)):
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[name][k].numpy(), err_msg=f"{name}.{k}", **weight_tol)
    np.testing.assert_allclose(float(state.log_alpha), float(js.log_alpha), rtol=1e-6)
    for port_opt, module, section, jopt, convert in (
            (state.actor_opt, agent.actor, "actor", js.actor_opt, lambda m: sac_jax_to_state_dict(m)),
            (state.critic_opt, agent.critic, "critic", js.critic_opt,
             lambda m: sac_jax_to_state_dict(js.actor_params, m))):
        count, mu, nu = moments_sd(jopt)
        assert int(port_opt.count) == count
        for moments, tree in ((port_opt.mu, mu), (port_opt.nu, nu)):
            sd = convert(tree)[section]
            for (name, _), got in zip(module.named_parameters(), moments):
                want_m = sd[name].numpy()
                np.testing.assert_allclose(got.numpy(), want_m, rtol=adam_tol, atol=adam_tol * np.abs(want_m).max(),
                                           err_msg=f"{section} {name}")
    alpha = adam_of(js.alpha_opt)
    assert int(state.alpha_opt.count) == int(alpha.count)
    np.testing.assert_allclose(state.alpha_opt.mu[0].numpy(), np.asarray(alpha.mu), rtol=adam_tol)
    np.testing.assert_allclose(state.alpha_opt.nu[0].numpy(), np.asarray(alpha.nu), rtol=adam_tol)
    assert state.update_counter == int(js.update_counter)


def update_draws(key, size):
    """The sample indices and normals of one JAX _update from ``key``
    (the split at sac.py:449)."""
    k_sample, k_critic, k_actor = jax.random.split(key, 3)
    idx = jax.random.randint(k_sample, (BATCH,), 0, max(size, 1))
    return (t(idx).long(), t(jax.random.normal(k_critic, (BATCH, A), jnp.float32)),
            t(jax.random.normal(k_actor, (BATCH, A), jnp.float32)))


@pytest.fixture(scope="module")
def jax_agent():
    """The JAX agent and its state after 3 epochs (1 of warmup, 2 with
    updates): 48 rows in the ring, Adam's moments warm."""
    jagent = jsac.SACAgent("jax", pendulum_params())
    epoch = jax.jit(jagent.train_epoch)
    jstate = jagent.init_state()
    for _ in range(3):
        jstate, _ = epoch(jstate)
    return jagent, epoch, jstate


@pytest.mark.parametrize("with_actor", [True, False], ids=["actor_step", "critic_only"])
def test_update_matches_jax(jax_agent, with_actor):
    jagent, _, jstate = jax_agent
    # policy_frequency 2: the actor runs when the incremented counter is even
    counter = int(jstate.update_counter) | 1 if with_actor else int(jstate.update_counter) & ~1
    jstate = jstate.replace(update_counter=jnp.asarray(counter, jnp.int32))
    agent, state = carry_state(jagent, jstate)
    key = jax.random.PRNGKey(11)
    jnew, jm = jax.jit(jagent._update)(jstate, key)
    m = agent._update(state, *update_draws(key, tsac.replay_size(state.replay)))
    assert m["actor_updated"] is with_actor and bool(jm["actor_updated"]) is with_actor
    keys = ("critic_loss", "critic1_loss", "critic2_loss") + (("actor_loss", "entropy", "alpha_loss")
                                                              if with_actor else ())
    for k in keys:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert_matches(agent, state, jnew, dict(rtol=1e-5, atol=1e-7), 1e-5)
    if not with_actor:  # the actor and α stay as they were
        np.testing.assert_array_equal(float(state.log_alpha), float(jstate.log_alpha))


def test_train_epoch_matches_jax(jax_agent):
    """One Pendulum epoch past warmup (16 rows that wrap the 64-row ring,
    8 updates, 4 actor steps) from the JAX state, with the JAX epoch's
    normals and sample indices handed in: the replay, the normalizer, the
    weights and the counters against the JAX epoch's."""
    jagent, epoch, jstate = jax_agent
    jstate, _ = epoch(jstate)  # a 4th epoch: the ring is full at the start
    agent, state = carry_state(jagent, jstate)
    jnew, jm = epoch(jstate)

    # the JAX epoch's draws, from the key splits it makes (sac.py:491, :556)
    rng, rows = jstate.rng, int(jstate.frame)
    step_normals, updates = [], []
    for _ in range(agent.num_steps_per_episode):
        rng, a_key, _u_key = jax.random.split(rng, 3)
        step_normals.append(t(jax.random.normal(a_key, (N, A), jnp.float32)))
        rows += N
        for _ in range(agent.num_updates_per_step):
            rng, k = jax.random.split(rng)
            updates.append(update_draws(k, min(rows, CAP)))
    normals, draws = iter(step_normals), iter(updates)
    agent._normal = lambda state, shape: next(normals)
    update = agent._update
    agent._update = lambda state: update(state, *next(draws))
    state, m = agent.train_epoch(state)
    assert next(normals, None) is None and next(draws, None) is None

    js = to_np(jnew)
    tol = dict(rtol=1e-5, atol=1e-6)
    assert (state.replay.idx, state.replay.full) == (int(js.replay.idx), bool(js.replay.full)) == (16, True)
    for f in ("obses", "next_obses", "actions", "rewards"):
        np.testing.assert_allclose(getattr(state.replay, f).numpy(), getattr(js.replay, f), err_msg=f, **tol)
    for f in ("dones", "truncated"):
        np.testing.assert_array_equal(getattr(state.replay, f).numpy(), getattr(js.replay, f))
    np.testing.assert_allclose(state.obs.numpy(), js.obs, **tol)
    assert (state.epoch, state.frame) == (int(js.epoch), int(js.frame))
    assert m["actor_updated"] == int(jm["actor_updated"]) == 4
    assert_matches(agent, state, jnew, dict(rtol=1e-5, atol=1e-7), 1e-5)
    for k in ("critic_loss", "actor_loss", "entropy", "alpha_loss", "alpha"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def tuned_params(d2rl: bool):
    """This file's Pendulum cut with ref/mujoco/sac_ant_tuned.yaml's
    networks: separate layer-norm [256, 256] relu trunks, log_std_bounds
    [-20, 2]; with ``d2rl`` their D2RL form."""
    params = pendulum_params()
    tuned = yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / "ref" / "mujoco" / "sac_ant_tuned.yaml").read_text())
    params["network"] = tuned["params"]["network"]
    params["network"]["mlp"]["d2rl"] = d2rl
    return params


@pytest.mark.parametrize("d2rl", [False, True], ids=["layer_norm", "layer_norm_d2rl"])
def test_layer_norm_update_matches_jax(d2rl):
    """One _update (critic, actor and α steps, Polyak) over sac_ant_tuned.yaml's
    layer-norm trunks, plain (LayerNorms at trunk.{3i + 2}, the head at
    trunk.6) and D2RL (trunk.0.norm_layers.{i}), from the JAX state after 3
    epochs, at the tolerances of test_update_matches_jax."""
    params = tuned_params(d2rl)
    jagent = jsac.SACAgent("jax", params)
    epoch = jax.jit(jagent.train_epoch)
    jstate = jagent.init_state()
    for _ in range(3):
        jstate, _ = epoch(jstate)
    jstate = jstate.replace(update_counter=jnp.asarray(int(jstate.update_counter) | 1, jnp.int32))
    agent, state = carry_state(jagent, jstate, params)
    norms = ("trunk.0.norm_layers.1.weight", "Q1.0.norm_layers.1.weight") if d2rl else ("trunk.5.weight",
                                                                                          "Q1.5.weight")
    assert norms[0] in agent.actor.state_dict() and norms[1] in agent.critic.state_dict()
    key = jax.random.PRNGKey(12)
    jnew, jm = jax.jit(jagent._update)(jstate, key)
    m = agent._update(state, *update_draws(key, tsac.replay_size(state.replay)))
    assert m["actor_updated"] and bool(jm["actor_updated"])
    for k in ("critic_loss", "critic1_loss", "critic2_loss", "actor_loss", "entropy", "alpha_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert_matches(agent, state, jnew, dict(rtol=1e-5, atol=1e-7), 1e-5, params)


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_sac.py
# ---------------------------------------------------------------------------


def small_params(**config):
    """test_sac.small_cfg, with the [32, 32] nets of this file."""
    return pendulum_params(**{"batch_size": 32, "replay_buffer_size": 1000, "num_warmup_steps": 2, **config})


def test_warmup_no_updates_then_updates():
    agent = SACAgent("t", small_params(num_warmup_steps=2), device="cpu")
    state = agent.init_state()
    state, m = agent.train_epoch(state)  # epoch 0 < 2: warmup
    assert state.update_counter == 0 and float(m["critic_loss"]) == 0.0
    state, m = agent.train_epoch(state)  # epoch 1 < 2: warmup
    assert state.update_counter == 0
    state, m = agent.train_epoch(state)  # epoch 2: updates begin
    assert state.update_counter == agent.num_updates_per_step * agent.num_steps_per_episode
    assert float(m["critic_loss"]) > 0.0


def test_target_network_polyak():
    agent = SACAgent("t", small_params(num_warmup_steps=0), device="cpu")
    state = agent.init_state()
    for a, b in zip(agent.critic.parameters(), agent.critic_target.parameters()):
        assert torch.equal(a, b)
    state, _ = agent.train_epoch(state)
    state, _ = agent.train_epoch(state)  # 2nd epoch: the ring reaches replay_min_fill (32 rows)
    critic = [p.detach() for p in agent.critic.parameters()]
    diffs = [float((a - b).abs().max()) for a, b in zip(critic, agent.critic_target.parameters())]
    assert max(diffs) > 0
    # one more update moves the target by critic_tau of the gap
    before = [p.clone() for p in agent.critic_target.parameters()]
    agent._update(state)
    for b, a, c in zip(before, agent.critic_target.parameters(), critic):
        torch.testing.assert_close(a, b + agent.critic_tau * (c - b), rtol=1e-6, atol=1e-7)


def test_alpha_learns():
    agent = SACAgent("t", small_params(num_warmup_steps=0, learnable_temperature=True), device="cpu")
    state = agent.init_state()
    la0 = float(state.log_alpha)
    for _ in range(5):
        state, m = agent.train_epoch(state)
    assert float(state.log_alpha) != la0
    assert float(m["alpha"]) > 0


@pytest.mark.parametrize("policy_frequency, actor_runs", [(2, 16), (1, 32)])
def test_epoch_metrics_are_epoch_means(policy_frequency, actor_runs):
    """utd 2.0 × 4 actors = 8 updates per env step × 4 steps = 32 updates;
    the actor runs every policy_frequency-th; the actor-side losses are
    means over those runs, the critic's over all 32."""
    agent = SACAgent("t", small_params(num_warmup_steps=0, utd_ratio=2.0, policy_frequency=policy_frequency),
                     device="cpu")
    state = agent.init_state()
    per_update = []
    update = agent._update
    agent._update = lambda s: per_update.append(update(s)) or per_update[-1]
    for _ in range(3):  # fill the ring past replay_min_fill (= batch_size)
        per_update.clear()
        state, m = agent.train_epoch(state)
    assert m["actor_updated"] == actor_runs and len(per_update) == 32
    runs = [u for u in per_update if u["actor_updated"]]
    for k in ("critic_loss", "critic1_loss", "critic2_loss"):
        torch.testing.assert_close(m[k], torch.stack([u[k] for u in per_update]).mean())
    for k in ("actor_loss", "entropy", "alpha_loss"):
        assert math.isfinite(float(m[k]))
        torch.testing.assert_close(m[k], torch.stack([u[k] for u in runs]).mean())


def test_stripped_resume_raises_update_gate(tmp_path):
    """A resume from a checkpoint without the replay keeps updates paused
    until the ring holds replay_resume_min_fill rows (sac.py _restore)."""
    params = small_params(num_warmup_steps=1, replay_buffer_size=1000, batch_size=32)
    agent = SACAgent("t", params, device="cpu")
    state = agent.init_state()
    for _ in range(4):
        state, _ = agent.train_epoch(state)
    assert state.update_counter > 0
    path = str(tmp_path / "sac_stripped.pth")
    agent._save(path, state, {"epoch": state.epoch, "frame": state.frame, "has_replay": agent.save_replay_buffer})
    assert ckpt.read_payload(path)["state"]["replay"]["obses"].shape[0] == 1

    fresh = SACAgent("t2", params, device="cpu")
    assert fresh._update_min_fill == fresh.replay_min_fill
    restored, _ = fresh._restore(path, fresh.init_state())
    assert fresh._update_min_fill == min(fresh.replay_resume_min_fill, fresh.replay_buffer_size) == 50
    assert fresh._update_min_fill >= fresh.replay_min_fill
    assert tsac.replay_size(restored.replay) == 0 and restored.replay.capacity == 1000
    assert restored.epoch == state.epoch and restored.update_counter == state.update_counter
    for a, b in zip(fresh.actor.parameters(), agent.actor.parameters()):
        assert torch.equal(a, b)

    before = restored.update_counter
    restored, _ = fresh.train_epoch(restored)  # 16 rows, under the raised gate of 50
    assert tsac.replay_size(restored.replay) < fresh._update_min_fill
    assert restored.update_counter == before
    while tsac.replay_size(restored.replay) < fresh._update_min_fill:
        restored, _ = fresh.train_epoch(restored)
    restored, _ = fresh.train_epoch(restored)
    assert restored.update_counter > before


def test_full_state_params_and_optimizer_reset():
    """get_full_state_weights / set_full_state_weights carry weights,
    optimizers and counters (the ring stays the receiver's when the file's
    is stripped); get_param / set_param take gamma, critic_tau and tau;
    reset_optimizer zeroes the three Adam states."""
    params = small_params(num_warmup_steps=0, batch_size=16)
    agent = SACAgent("t", params, device="cpu")
    state, _ = run_epochs(agent, agent.init_state(), 3)
    full = agent.get_full_state_weights(state, last_mean_rewards=-3.0)
    assert full["state"]["replay"]["obses"].shape[0] == 1 and full["last_mean_rewards"] == -3.0
    other = SACAgent("o", params, device="cpu")
    mine = other.init_state(seed=99)
    restored = other.set_full_state_weights(mine, full)
    assert restored.replay is mine.replay and (restored.epoch, restored.update_counter) == (3, state.update_counter)
    for a, b in ((agent.actor, other.actor), (agent.critic_target, other.critic_target)):
        for x, y in zip(a.parameters(), b.parameters()):
            assert torch.equal(x, y)
    assert torch.equal(restored.critic_opt.nu[0], state.critic_opt.nu[0])
    assert other.set_full_state_weights(other.init_state(), full, set_epoch=False).epoch == 0

    assert agent.set_param("tau", 0.01, state) is state
    assert agent.critic_tau == agent.get_param("tau") == agent.get_param("critic_tau") == 0.01
    agent.set_param("gamma", 0.9)
    assert agent.get_param("gamma") == 0.9
    with pytest.raises(NotImplementedError):
        agent.set_param("lr", 1.0)
    state = agent.reset_optimizer(state)
    assert int(state.actor_opt.count) == int(state.critic_opt.count) == int(state.alpha_opt.count) == 0
    assert all(not m.any() for m in state.critic_opt.mu)


def test_resume_min_fill_config_override():
    agent = SACAgent("t", small_params(replay_resume_min_fill=64, replay_buffer_size=1000), device="cpu")
    assert agent.replay_resume_min_fill == 64


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_sac_correctness.py, on a fake
# device env whose rows can be checked byte for byte
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FakeState:
    x: torch.Tensor  # [N, 2]: env id, step in the episode


class FakeEnv(DeviceEnv):
    """obs = [env id, step]; reward = 100·id + step; env e terminates after
    lengths[e] steps unless ``lengths`` is None (then only the vec env's
    time limit ends an episode)."""

    reset_noise_shape = ()

    def __init__(self, device=None, lengths=None):
        self.device = torch.device(device)
        self.lengths = None if lengths is None else torch.tensor(lengths, dtype=torch.float32)

    def env_info(self):
        return EnvInfo(observation_space=Box(shape=(2,)), action_space=Box(shape=(1,), low=-1.0, high=1.0))

    def reset_from(self, noise):
        x = torch.stack([torch.arange(noise.shape[0], dtype=torch.float32), torch.zeros(noise.shape[0])], -1)
        return FakeState(x=x), x

    def step(self, estate, actions, noise=None):
        x = estate.x + torch.tensor([0.0, 1.0])
        terminated = torch.zeros(x.shape[0], dtype=torch.bool) if self.lengths is None else x[:, 1] >= self.lengths
        return FakeState(x=x), x, 100.0 * x[:, 0] + x[:, 1], terminated, {}


def fake_agent(monkeypatch, lengths=None, max_episode_steps=None, **config):
    def create(device=None):
        return FakeEnv(device, lengths)

    monkeypatch.setitem(registry.ENV_CONFIGURATIONS, "fake_sac",
                        {"env_creator": create, "max_episode_steps": max_episode_steps})
    cfg = {"env_name": "fake_sac", "num_actors": 4, "num_steps_per_episode": 1, "batch_size": 8,
           "replay_buffer_size": 4096, "num_warmup_steps": 10**9, "utd_ratio": None,
           "num_updates_per_step": 1, "gamma": 0.99, "init_alpha": 1.0, "alpha_lr": 1e-3,
           "actor_lr": 1e-3, "critic_lr": 1e-3, "critic_tau": 0.005, "learnable_temperature": True,
           "normalize_input": True, "value_bootstrap": True, "seed": 3, **config}
    params = {"algo": {"name": "sac"}, "model": {"name": "soft_actor_critic"},
              "network": {"name": "soft_actor_critic", "separate": True,
                          "mlp": {"units": [16], "activation": "relu", "initializer": {"name": "default"}},
                          "log_std_bounds": [-5, 2]},
              "config": cfg}
    return SACAgent("t", params, device="cpu")


def replay_rows(state):
    n = tsac.replay_size(state.replay)
    r = state.replay
    return (r.obses[:n].numpy(), r.next_obses[:n].numpy(), r.rewards[:n, 0].numpy(), r.dones[:n, 0].numpy(),
            r.truncated[:n, 0].numpy())


def run_epochs(agent, state, n):
    for _ in range(n):
        state, m = agent.train_epoch(state)
    return state, m


@pytest.mark.parametrize("ending", ["terminate", "truncate"])
def test_truncation_rows_bootstrap_not_done(monkeypatch, ending):
    """Every row is a transition within one episode with the true final obs
    on its last row; a termination stores done = True, a truncation (the
    time limit) done = False and truncated = True."""
    lengths = [3, 5, 4, 7]
    agent = (fake_agent(monkeypatch, lengths=lengths) if ending == "terminate"
             else fake_agent(monkeypatch, max_episode_steps=3))
    state, _ = run_epochs(agent, agent.init_state(), 12)
    obs, nxt, rew, dones, trunc = replay_rows(state)
    assert len(obs) == 4 * 12
    np.testing.assert_array_equal(nxt[:, 0], obs[:, 0])  # same env
    np.testing.assert_array_equal(nxt[:, 1], obs[:, 1] + 1)  # the next step of the same episode
    np.testing.assert_array_equal(rew, 100.0 * obs[:, 0] + nxt[:, 1])
    if ending == "terminate":
        assert trunc.sum() == 0 and dones.sum() > 0
        np.testing.assert_array_equal(dones, nxt[:, 1] == np.asarray(lengths)[obs[:, 0].astype(int)])
    else:  # value_bootstrap: time limits never store done = True
        assert dones.sum() == 0 and trunc.sum() == 4 * 4
        np.testing.assert_array_equal(trunc, nxt[:, 1] == 3)


def test_normalizer_counts_each_frame_once(monkeypatch):
    """The normalizer sees each fresh frame once and never a replay row."""
    agent = fake_agent(monkeypatch, num_steps_per_episode=2, num_warmup_steps=1, batch_size=4)
    state = agent.init_state()
    c0 = int(agent.running_mean_std.count)
    state, _ = run_epochs(agent, state, 7)
    assert state.update_counter > 0  # updates ran, and read the replay
    assert int(agent.running_mean_std.count) - c0 == 4 * 7 * 2


def test_utd_accounting(monkeypatch):
    """update_counter advances by num_updates_per_step per env step once
    warmup ends and the ring holds a batch."""
    agent = fake_agent(monkeypatch, num_warmup_steps=3, utd_ratio=0.5, num_steps_per_episode=1, batch_size=4)
    assert agent.num_updates_per_step == 2  # 0.5 * 4 actors
    state, _ = run_epochs(agent, agent.init_state(), 10)
    assert state.update_counter == 2 * (10 - 3)


def test_log_action_scale_sum_counts_every_dim(monkeypatch):
    """An env whose Box gives its bounds as scalars: the env-space log-prob
    subtracts log(scale) once per action dim (Σ over the dims,
    sac_agent.py:381-389). The JAX package sums over the 0-d bounds array
    and subtracts it once (ROADMAP.md §3, fault 2); the shipped SAC configs
    do not meet the case (Ant2D's scale is 1, Pendulum has one dim)."""
    from rl_games_tpu.envs.spaces import Box as JBox, EnvInfo as JEnvInfo

    class TwoDims(FakeEnv):
        def env_info(self):
            return EnvInfo(observation_space=Box(shape=(2,)), action_space=Box(shape=(2,), low=-2.0, high=2.0))

    class JaxInfo:
        def get_env_info(self):
            return JEnvInfo(observation_space=JBox(shape=(2,)), action_space=JBox(shape=(2,), low=-2.0, high=2.0))

    monkeypatch.setitem(registry.ENV_CONFIGURATIONS, "fake_sac", {"env_creator": lambda device=None: TwoDims(device)})
    params = pendulum_params(env_name="fake_sac")
    agent = SACAgent("t", params, device="cpu")
    assert agent.log_action_scale_sum == pytest.approx(2 * math.log(2.0))
    assert jsac.SACAgent("j", params, vec_env=JaxInfo()).log_action_scale_sum == pytest.approx(math.log(2.0))
    # the two agree on the shipped configs' bounds
    for name, dims in (("Pendulum-v1", 1), ("Ant2D", 8)):
        port = SACAgent("t", {**params, "config": {**params["config"], "env_name": name}}, device="cpu")
        jax_agent = jsac.SACAgent("j", {**params, "config": {**params["config"], "env_name": name}})
        assert port.action_dim == dims and port.log_action_scale_sum == pytest.approx(jax_agent.log_action_scale_sum)
