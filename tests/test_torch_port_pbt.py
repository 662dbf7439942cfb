"""PBT in the port (utils/pbt.py, utils/multiseed.PopulationTrainer, PPO's
get_param / set_param) against the JAX package, on the same inputs.

Both packages draw from Python's ``random`` module in the same order, so
under the same ``random.seed`` they must pick the same leader and the same
mutations: floats are compared exactly. The CartPole members of the
population tests carry the JAX members' weights into the port through
``utils/jax_params``, so that both packages' leaders and laggards hold the
same weights before ``pbt_step``."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.utils import multiseed as jms
from rl_games_tpu.utils import pbt as jpbt
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.utils import multiseed as tms
from rl_games_tpu_torch.utils import pbt as tpbt
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

from test_ppo import cartpole_params

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# mutations, the band rule and the config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_mutations_draw_alike(seed):
    """mutate_float, mutate_discount and mutate give equal floats under the
    same random.seed, over several draws and change ranges."""
    def draws(mod):
        random.seed(seed)
        out = [mod.mutate_float(3e-4, 1.1, 2.0) for _ in range(20)]
        out += [mod.mutate_float(0.01) for _ in range(5)]
        out += [mod.mutate_discount(0.99) for _ in range(20)]
        rules = {"learning_rate": "mutate_float", "gamma": "mutate_discount", "e_clip": "mutate_float"}
        params = {"learning_rate": 3e-4, "gamma": 0.99, "e_clip": 0.2, "other": 5}
        for rate in (1.0, 0.5, 0.25, 0.0):
            out += list(mod.mutate(params, rules, rate, (1.1, 1.5)).values())
        return out

    want, got = draws(jpbt), draws(tpbt)
    assert got == want  # floats exactly
    assert got[-4:] == [3e-4, 0.99, 0.2, 5]  # rate 0: nothing mutates
    assert all(0.98 < g < 0.9951 for g in got[25:45])


def test_mutate_rules_and_unknown_function():
    random.seed(0)
    params = {"lr": 1e-4, "gamma": 0.99, "other": 5}
    out = tpbt.mutate(params, {"lr": "mutate_float", "gamma": "mutate_discount"}, 1.0, (1.1, 1.5))
    assert out["lr"] != 1e-4 and out["gamma"] != 0.99 and out["other"] == 5
    assert set(tpbt.MUTATION_FUNCS) == set(jpbt.MUTATION_FUNCS)
    for mod in (jpbt, tpbt):
        with pytest.raises(KeyError):
            mod.mutate({"x": 1.0}, {"x": "nope"}, 1.0, (1.1, 1.5))


@pytest.mark.parametrize("scores, k_std, k_abs", [
    ([0.0, 0.5, 1.0], 0.1, 0.05), ([200.0, 100.0, 10.0], 0.1, 0.05), ([1.0, 1.0], 0.0, 0.0),
    ([3.5, -2.0, 7.25, 0.0, 11.0], 0.25, 1.0),
])
def test_classify_matches(scores, k_std, k_abs):
    assert tpbt.classify(scores, k_std, k_abs) == jpbt.classify(scores, k_std, k_abs)


def test_pbt_cfg_from_dict(capsys):
    d = {"enabled": True, "num_policies": 3, "change_range": [1.2, 1.8], "interval_steps": 64,
         "mutation": {"gamma": "mutate_discount"}, "bogus": 1, "also_bogus": 2}
    want, got = jpbt.PbtCfg.from_dict(dict(d)), tpbt.PbtCfg.from_dict(dict(d))
    assert vars(got) == vars(want) and got.change_range == (1.2, 1.8)
    out = capsys.readouterr().out
    assert out.count("PbtCfg: ignoring unknown config keys ['also_bogus', 'bogus']") == 2


# ---------------------------------------------------------------------------
# PopulationTrainer.pbt_step on three CartPole members
# ---------------------------------------------------------------------------

SEEDS = [1, 2, 3]
LRS, ENTROPY = [3e-4, 2e-4, 1e-4], [0.01, 0.02, 0.005]


@pytest.fixture(scope="module")
def populations():
    """The JAX population and its stacked state, its lr and entropy_coef
    set per member."""
    jtr = jms.PopulationTrainer(JPPOAgent("jax", cartpole_params()), SEEDS, threshold_std=0.1,
                                threshold_abs=0.05, mutation_rate=1.0, change_range=(1.2, 1.2))
    jstacked = jtr.init_state().replace(lr=jnp.asarray(LRS, jnp.float32),
                                        entropy_coef=jnp.asarray(ENTROPY, jnp.float32))
    return jtr, jstacked


def port_population(jstacked):
    """A port population after one epoch (its meters hold games), holding
    the JAX members' weights, normalizers, lr and entropy_coef."""
    tr = tms.PopulationTrainer(PPOAgent("port", cartpole_params(), device="cpu"), SEEDS, threshold_std=0.1,
                               threshold_abs=0.05, mutation_rate=1.0, change_range=(1.2, 1.2))
    states, _ = tr.epoch(tr.init_state())
    for i, (agent, state) in enumerate(zip(tr.agents, states)):
        member = jax.tree.map(lambda x: np.asarray(x[i]), jstacked)
        agent.model.load_state_dict(jax_to_state_dict(member.params, member.norm))
        state.lr, state.entropy_coef = torch.tensor(LRS[i]), torch.tensor(ENTROPY[i])
    return tr, states


@pytest.mark.parametrize("case", ["adopt", "no_games", "no_laggard"])
def test_pbt_step_matches_jax(populations, case):
    jtr, jstacked = populations
    tr, states = port_population(jstacked)
    scores = {"adopt": [200.0, 100.0, 10.0], "no_games": [200.0, 100.0, 10.0], "no_laggard": [100.0] * 3}[case]
    fake = {"mean_rewards": np.asarray(scores)[:, None],
            "games_played": np.asarray([5, 0, 5] if case == "no_games" else [5, 5, 5])}
    before = [{k: v.clone() for k, v in a.model.state_dict().items()} for a in tr.agents]
    counts = [int(s.game_rewards.count) for s in states]
    random.seed(0)
    jout, jevents = jtr.pbt_step(jstacked, fake)
    random.seed(0)
    states, events = tr.pbt_step(states, fake)
    assert events == jevents  # dst, src and the float32 lr / entropy_coef, bit for bit
    if case != "adopt":
        assert events == []
        for agent, sd in zip(tr.agents, before):
            assert all(torch.equal(agent.model.state_dict()[k], v) for k, v in sd.items())
        return
    assert [(e["dst"], e["src"]) for e in events] == [(3, 1)]
    adopter, leader = tr.agents[2], tr.agents[0]
    jmember = jax.tree.map(lambda x: np.asarray(x[2]), jout)
    want = jax_to_state_dict(jmember.params, jmember.norm)
    for k, v in adopter.model.state_dict().items():
        assert torch.equal(v, leader.model.state_dict()[k]), k
        assert torch.equal(v, want[k]), k  # the JAX package's adopter holds the same
    assert all(float(torch.abs(t).max()) == 0.0 for t in states[2].opt_state.mu + states[2].opt_state.nu)
    assert int(states[2].opt_state.count) == 0
    assert float(states[2].lr) == float(jout.lr[2]) and float(states[2].entropy_coef) == float(jout.entropy_coef[2])
    assert float(states[2].lr) in (np.float32(LRS[0] * 1.2), np.float32(LRS[0] / 1.2))
    # meters reset on the adopter only; the others untouched
    assert int(states[2].game_rewards.count) == 0 and counts[2] > 0
    for i in (0, 1):
        assert int(states[i].game_rewards.count) == counts[i]
        assert float(states[i].lr) == np.float32(LRS[i])
        assert all(torch.equal(tr.agents[i].model.state_dict()[k], v) for k, v in before[i].items())
        assert float(torch.abs(states[i].opt_state.mu[0]).max()) > 0.0
    states, m = tr.epoch(states)  # the population trains on
    assert np.isfinite(m["a_loss"].numpy()).all() and m["a_loss"].shape == (3,)


# ---------------------------------------------------------------------------
# PbtManager: the filesystem protocol (tests/test_services.py:68-127, 299-379)
# ---------------------------------------------------------------------------


class JFakeAlgo:
    def get_weights(self, state):
        return {"w": state["w"]}

    def set_weights(self, state, weights):
        return {**state, "w": weights["w"]}


class FakeAlgo:
    """The port's surface: weights in the algo, not in the state."""

    def __init__(self, w):
        self.w = w

    def get_weights(self):
        return {"w": torch.tensor([self.w])}

    def set_weights(self, weights):
        self.w = float(weights["w"][0])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_manager_protocol_matches_jax(tmp_path, seed):
    """A laggard among a leader and a middling member adopts the same
    leader and mutates its params alike in both packages; its own record
    lands in the workspace."""
    kw = dict(enabled=True, policy_idx=2, num_policies=4, interval_steps=100, mutation_rate=0.7,
              mutation={"learning_rate": "mutate_float", "entropy_coef": "mutate_float"},
              threshold_std=0.1, threshold_abs=0.05)
    results = []
    for mod, algo, state, weight in ((jpbt, JFakeAlgo(), {"w": -1.0}, lambda w: w),
                                     (tpbt, FakeAlgo(-1.0), None, lambda w: torch.tensor([w]))):
        cfg = mod.PbtCfg(directory=str(tmp_path / mod.__name__), **kw)
        ws = os.path.join(cfg.directory, cfg.workspace)
        for idx, score in ((0, 10.0), (1, 9.5), (3, 5.0)):
            mod.save_member(ws, idx, score=score, frame=100, weights={"w": weight(float(idx))},
                            params={"learning_rate": 1e-3 * (idx + 1), "entropy_coef": 0.01})
        mgr = mod.PbtManager(cfg, {"learning_rate": 1e-4, "entropy_coef": 0.02})
        random.seed(seed)
        state = mgr.step(algo, state, {"frame": 250, "mean_rewards": np.asarray([0.1])})
        members = mod.load_population(ws, 4)
        assert members[2] is not None and members[2]["score"] == pytest.approx(0.1)
        adopted = state["w"] if mod is jpbt else algo.w
        results.append((adopted, mgr.mutable_params, mgr.last_interval))
    assert results[1] == results[0]
    assert results[0][0] in (0.0, 1.0)


def test_manager_keeps_a_competitive_member(tmp_path):
    for mod, algo, state in ((jpbt, JFakeAlgo(), {"w": "mine"}), (tpbt, FakeAlgo(7.0), None)):
        cfg = mod.PbtCfg(enabled=True, policy_idx=1, num_policies=2, interval_steps=100,
                         directory=str(tmp_path / mod.__name__))
        ws = os.path.join(cfg.directory, cfg.workspace)
        mod.save_member(ws, 0, score=1.0, frame=100, weights={"w": torch.tensor([3.0])}, params={})
        mgr = mod.PbtManager(cfg, {})
        # too early: no record, no decision
        assert mgr.step(algo, state, {"frame": 50, "mean_rewards": np.asarray([0.0])}) is state
        assert mod.load_population(ws, 2)[1] is None
        state = mgr.step(algo, state, {"frame": 150, "mean_rewards": np.asarray([0.99])})
        assert (state["w"] if mod is jpbt else algo.w) == ("mine" if mod is jpbt else 7.0)
        assert mod.load_population(ws, 2)[1]["score"] == pytest.approx(0.99)


def small_cartpole(seed):
    params = cartpole_params(num_actors=4, horizon_length=8, minibatch_size=16, mini_epochs=1,
                             lr_schedule=None, normalize_input=False, normalize_value=False, seed=seed)
    params["network"]["mlp"]["units"] = [16]
    return params


def test_manager_adoption_with_real_agents(tmp_path):
    """A laggard PPO agent adopts a leader's record: the leader's weights,
    fresh Adam moments and a gamma mutated through set_param, as the JAX
    package's manager mutates it under the same random.seed; the next epoch
    is finite."""
    cfg_dict = {"enabled": True, "policy_idx": 1, "num_policies": 2, "interval_steps": 1,
                "threshold_std": 0.0, "threshold_abs": 0.0, "restart_with_execv": False,
                "mutation_rate": 1.0, "mutation": {"gamma": "mutate_discount"}}
    mutated = []
    for mod, make in ((jpbt, lambda s: JPPOAgent("t", small_cartpole(s))),
                      (tpbt, lambda s: PPOAgent("t", small_cartpole(s), device="cpu"))):
        cfg = mod.PbtCfg.from_dict(dict(cfg_dict))
        cfg.directory = str(tmp_path / mod.__name__)
        ws = os.path.join(cfg.directory, cfg.workspace)
        leader, laggard = make(1), make(2)
        lstate, sstate = leader.init_state(), laggard.init_state()
        if mod is jpbt:
            mod.save_member(ws, 0, 100.0, 10, leader.get_weights(lstate), {"gamma": 0.99})
        else:
            lstate, _ = leader.train_epoch(lstate)
            sstate, _ = laggard.train_epoch(sstate)
            assert float(torch.abs(sstate.opt_state.mu[0]).max()) > 0
            mod.save_member(ws, 0, 100.0, 10, leader.get_weights(), {"gamma": 0.99})
        mgr = mod.PbtManager(cfg, {"gamma": 0.99})
        random.seed(5)
        sstate = mgr.step(laggard, sstate, {"frame": 10, "mean_rewards": np.asarray([0.0])})
        mutated.append(dict(mgr.mutable_params))
        assert laggard.get_param("gamma") == mgr.mutable_params["gamma"] != 0.99
    assert mutated[1] == mutated[0]
    for k, v in laggard.model.state_dict().items():
        assert torch.equal(v, leader.model.state_dict()[k]), k
    assert all(float(torch.abs(t).max()) == 0.0 for t in sstate.opt_state.mu + sstate.opt_state.nu)
    _, m = laggard.train_epoch(sstate)
    assert np.isfinite(float(m["a_loss"])) and np.isfinite(float(m["c_loss"]))


# ---------------------------------------------------------------------------
# PPO's get_param / set_param (ppo.py:1612-1700)
# ---------------------------------------------------------------------------

NAMES = ["grad_norm", "critic_coef", "bounds_loss_coef", "gamma", "tau", "mini_epochs_num", "e_clip",
         "learning_rate", "entropy_coef", "kl_threshold", "no_such_param"]


@pytest.fixture(scope="module")
def agent_pairs():
    """Per schedule, a JAX and a port agent with their states."""
    out = {}
    for schedule in ("adaptive", None):
        params = cartpole_params(lr_schedule=schedule)
        jagent, agent = JPPOAgent("jax", params), PPOAgent("port", cartpole_params(lr_schedule=schedule),
                                                           device="cpu")
        out[schedule] = (jagent, jagent.init_state(), agent, agent.init_state())
    return out


@pytest.mark.parametrize("schedule", ["adaptive", None])
@pytest.mark.parametrize("name", NAMES)
def test_get_set_param_agree(agent_pairs, name, schedule):
    """Each name reads alike before and after a set, or raises
    NotImplementedError in both packages on the same schedule."""
    jagent, jstate, agent, state = agent_pairs[schedule]
    value = {"mini_epochs_num": 2, "bounds_loss_coef": 0.01}.get(name, 0.123)

    def outcome(fn):
        try:
            return fn()
        except NotImplementedError:
            return NotImplementedError

    got = outcome(lambda: agent.get_param(name, state))
    assert got == outcome(lambda: jagent.get_param(name, jstate))
    assert outcome(lambda: agent.get_param(name)) == outcome(lambda: jagent.get_param(name))
    jset = outcome(lambda: jagent.set_param(name, value, jstate))
    pset = outcome(lambda: agent.set_param(name, value, state))
    assert (pset is NotImplementedError) == (jset is NotImplementedError)
    if pset is NotImplementedError:
        return
    assert pset is state
    after = agent.get_param(name, pset)
    assert after == jagent.get_param(name, jset) == pytest.approx(value)
    if name == "kl_threshold":
        assert agent.scheduler.kl_threshold == jagent.scheduler.kl_threshold == value
    if name in ("learning_rate", "entropy_coef"):
        assert agent.get_param(name) == jagent.get_param(name) == value


CONFIG_KEY = {"mini_epochs_num": "mini_epochs"}


@pytest.mark.parametrize("name, value", [
    ("gamma", 0.0), ("gamma", 0.95), ("tau", 0.5), ("e_clip", 0.1), ("grad_norm", 0.3), ("critic_coef", 0.5),
    ("mini_epochs_num", 2), ("learning_rate", 1e-3), ("entropy_coef", 0.05),
])
def test_set_param_equals_an_agent_built_with_it(name, value):
    """After one epoch, set_param(name, value) and the next epoch equal,
    exactly, the next epoch of an agent built with that value from the same
    state: the port caches none of these. gamma 0 changes c_loss against
    the unchanged agent (tests/test_ppo.py:109)."""
    schedule = None if name == "learning_rate" else "adaptive"
    agent = PPOAgent("a", cartpole_params(lr_schedule=schedule), device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    state = agent.set_param(name, value, state)
    full = agent.get_full_state_weights(state)
    state, m = agent.train_epoch(state)

    built = PPOAgent("b", cartpole_params(lr_schedule=schedule, **{CONFIG_KEY.get(name, name): value}),
                     device="cpu")
    bstate, bm = built.train_epoch(built.set_full_state_weights(built.init_state(), full))
    for k in ("a_loss", "c_loss", "entropy", "kl", "lr", "entropy_coef", "mean_rewards"):
        assert torch.equal(m[k], bm[k]), k
    for k, v in agent.model.state_dict().items():
        assert torch.equal(v, built.model.state_dict()[k]), k
    if name == "gamma" and value == 0.0:
        unchanged = PPOAgent("c", cartpole_params(), device="cpu")
        _, cm = unchanged.train_epoch(unchanged.set_full_state_weights(unchanged.init_state(), full))
        assert float(cm["c_loss"]) != float(m["c_loss"])


def test_reset_optimizer_zeroes_the_moments():
    """tests/test_ppo.py:158, with a central value net's moments too."""
    from test_central_value import asym_params

    agent = PPOAgent("t", asym_params(), device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    assert float(torch.abs(state.opt_state.mu[0]).max()) > 0 and int(state.cv_opt.count) > 0
    state = agent.reset_optimizer(state)
    for opt in (state.opt_state, state.cv_opt):
        assert int(opt.count) == 0 and all(float(torch.abs(t).max()) == 0.0 for t in opt.mu + opt.nu)


def test_real_members_mutate_only_lr_and_entropy(tmp_path, capsys):
    """ROADMAP §3 fault 7, pinned as the JAX package has it: PPOAgent.train
    hands PbtManager {learning_rate, entropy_coef} as the mutable params
    (ppo.py:1814-1820), so between real members a `mutation` rule for gamma
    never fires: mutate walks the leader's record, which holds only those."""
    def member(policy_idx):
        params = small_cartpole(policy_idx + 1)
        params["config"].update(name=f"member{policy_idx}", train_dir=str(tmp_path), max_epochs=1,
                                print_stats=False,
                                pbt={"enabled": True, "policy_idx": policy_idx, "num_policies": 2,
                                     "interval_steps": 1, "threshold_std": 0.0, "threshold_abs": 0.0,
                                     "mutation_rate": 1.0, "mutation": {"gamma": "mutate_discount",
                                                                        "learning_rate": "mutate_float"}})
        agent = PPOAgent("t", params, device="cpu")
        agent.train()
        return agent

    member(0)
    path = tmp_path / "pbt_workspace" / "policy_000.pbt"
    record = torch.load(path, weights_only=True)
    assert set(record["params"]) == {"learning_rate", "entropy_coef"}
    torch.save({**record, "score": 1e9}, path)  # member 0 leads
    random.seed(0)
    agent = member(1)
    assert "PBT: policy 1" in capsys.readouterr().out  # it adopted
    assert agent.get_param("gamma") == 0.99  # the rule for gamma did not fire
    assert agent.get_param("learning_rate") != record["params"]["learning_rate"]  # the one for lr did
    for k, v in agent.model.state_dict().items():
        assert torch.equal(v, record["weights"][k]), k
