"""The port's algo observers (utils/observers.py), experiment grids
(common/experiment.py) and ``use_diagnostics`` against the JAX package's.

Observers get the same hook calls in both packages and must write the same
scalars; a tiny training run of each package must call the hooks in the
same order; the per-mini-epoch diagnostics of one epoch are compared from
the same weights and trajectory (the JAX PPOAgent's ``_diag``) at the full
update's tolerances (tests/test_torch_port_ppo.py): rtol 1e-4, atol 1e-6.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.common.experiment import Experiment as JExperiment
from rl_games_tpu.utils import observers as jobs
from rl_games_tpu_torch.algos import ppo as tppo
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.common.experiment import Experiment
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils import observers as tobs

from test_torch_port_ppo import flagship_params, port_agent, t, to_np

torch.set_num_threads(1)


class ScalarLog:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def flush(self):
        pass

    def close(self):
        pass

    def tags(self):
        return {tag for tag, _, _ in self.rows}


class Algo:
    def __init__(self):
        self.writer = ScalarLog()


# ---------------------------------------------------------------------------
# Experiment
# ---------------------------------------------------------------------------

BASE = {"params": {"config": {"learning_rate": 3e-4, "gamma": 0.99}, "network": {"mlp": {"units": [8]}}}}


@pytest.mark.parametrize("axes", [
    [],
    [{"name": "params.config.learning_rate", "values": [1e-4, 3e-4, 1e-3]}],
    [{"name": "params.config.gamma", "values": [0.9, 0.99]},
     {"name": "params.network.mlp.units", "values": [[64], [32, 16]]},
     {"name": "params.config.seed", "values": [1, 2]}],
], ids=["no_axes", "one_axis", "three_axes"])
def test_experiment_grid_matches_jax(axes):
    port, ref = Experiment(copy.deepcopy(BASE), axes), JExperiment(copy.deepcopy(BASE), axes)
    assert len(port) == len(ref) == int(np.prod([len(a["values"]) for a in axes]))
    configs = list(port)
    assert configs == list(ref)
    assert port.get_next_config() is None and ref.get_next_config() is None
    assert BASE == {"params": {"config": {"learning_rate": 3e-4, "gamma": 0.99},
                               "network": {"mlp": {"units": [8]}}}}, "the base config is not mutated"


# ---------------------------------------------------------------------------
# Observers
# ---------------------------------------------------------------------------


def drive(mod, kind):
    """One fixed sequence of hook calls on the observer ``kind`` of package
    ``mod``; returns the scalars it wrote."""
    algo = Algo()
    if kind == "multi":
        obs = mod.MultiObserver([mod.DefaultAlgoObserver(), None, mod.IsaacAlgoObserver()])
    else:
        obs = {"default": mod.DefaultAlgoObserver, "isaac": mod.IsaacAlgoObserver}[kind]()
    obs.before_init("run", {}, "exp")
    obs.after_init(algo)
    for epoch in (1, 2):
        obs.process_infos({"episode": {"len": np.array([3.0, 4.0 * epoch]), "ret": np.float32(epoch)},
                           "direct": 1.5 * epoch, "scalar": np.float32(2.0), "vec": np.ones(3)}, None)
        obs.after_steps()
        obs.after_epoch({"mean_scores": np.float32(0.25 * epoch), "mean_rewards": np.ones(1)})
        obs.after_print_stats(128 * epoch, epoch, 3.7 * epoch)
    obs.after_clear_stats()
    obs.after_print_stats(512, 4, 9.0)
    return algo.writer.rows


@pytest.mark.parametrize("kind", ["default", "isaac", "multi"])
def test_observers_write_what_jax_writes(kind):
    rows = drive(tobs, kind)
    assert rows == drive(jobs, kind)
    assert rows, "the observer wrote nothing: the comparison says nothing"


def test_isaac_observer_refuses_non_dict_infos():
    with pytest.raises(ValueError, match="expected 'infos' as dict"):
        tobs.IsaacAlgoObserver().process_infos([1, 2], None)


# ---------------------------------------------------------------------------
# The hooks in a training run
# ---------------------------------------------------------------------------


class Recorder:
    """Records every hook call (and the metric keys it saw)."""

    def __init__(self):
        self.calls = []

    def before_init(self, base_name, config, experiment_name):
        self.calls.append(("before_init", experiment_name))

    def after_init(self, algo):
        self.calls.append(("after_init", type(algo).__name__))

    def process_infos(self, infos, done_indices):
        self.calls.append(("process_infos",))

    def after_steps(self):
        self.calls.append(("after_steps",))

    def after_epoch(self, metrics):
        self.calls.append(("after_epoch", "mean_rewards" in metrics, "a_loss" in metrics))

    def after_clear_stats(self):
        self.calls.append(("after_clear_stats",))

    def after_print_stats(self, frame, epoch_num, total_time):
        self.calls.append(("after_print_stats", frame, epoch_num))


def tiny_run_params(tmp_path, observer, **config):
    params = flagship_params(8)
    params["config"].update(name="obs", train_dir=str(tmp_path), max_epochs=3, minibatch_size=64,
                            log_interval=1, save_best_after=1, features={"observer": observer}, **config)
    return params


def test_hook_order_matches_jax(tmp_path):
    """Train both packages 3 epochs with a recording observer; the hooks
    fire in the same order with the same frames and epochs, and
    clear_stats tells the observer."""
    port_rec, jax_rec = Recorder(), Recorder()
    agent = PPOAgent("run", tiny_run_params(tmp_path / "port", port_rec), device="cpu")
    agent.train(writer=ScalarLog())
    JPPOAgent("run", tiny_run_params(tmp_path / "jax", jax_rec)).train(writer=ScalarLog())
    assert port_rec.calls == jax_rec.calls
    assert port_rec.calls[:2] == [("before_init", "obs"), ("after_init", "PPOAgent")]
    assert [c[0] for c in port_rec.calls[2:]] == ["after_epoch", "after_print_stats"] * 3
    assert [c[1:] for c in port_rec.calls[3::2]] == [(128, 1), (256, 2), (384, 3)]
    agent.clear_stats(agent.last_state)
    assert port_rec.calls[-1] == ("after_clear_stats",)


# ---------------------------------------------------------------------------
# use_diagnostics
# ---------------------------------------------------------------------------


def diag_params(num_actors=16):
    params = flagship_params(num_actors)
    params["config"]["use_diagnostics"] = True
    return params


@pytest.fixture(scope="module")
def jax_diag_run():
    jagent = JPPOAgent("jax", diag_params())
    jstate = jagent.init_state()
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    return jagent, after, to_np(traj), np.asarray(last_values)


@pytest.mark.parametrize("schedule_type", ["legacy", "standard"])
def test_diagnostics_match_jax(jax_diag_run, schedule_type):
    jagent, after, traj, last_values = jax_diag_run
    jagent.schedule_type = schedule_type
    _, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, None)
    jdiag = to_np(jm["_diag"])
    agent, state = port_agent(after)
    agent.use_diagnostics, agent.schedule_type = True, schedule_type
    _, pm = agent._finish_epoch(state, {k: t(v) for k, v in traj.items()}, t(last_values))
    pdiag = pm["_diag"]
    assert sorted(pdiag) == sorted(jdiag) == sorted(
        ["kl", "clip_frac", "obs_rms_mean", "obs_rms_var", "value_rms_mean", "value_rms_var"])
    assert pdiag["kl"].shape == (agent.mini_epochs_num,)
    for k in jdiag:
        np.testing.assert_allclose(pdiag[k].numpy(), jdiag[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_no_diagnostics_unless_asked(jax_diag_run):
    _, after, traj, last_values = jax_diag_run
    agent, state = port_agent(after)
    _, pm = agent._finish_epoch(state, {k: t(v) for k, v in traj.items()}, t(last_values))
    assert "_diag" not in pm


def test_train_writes_diagnostics_and_the_timed_step_rate(tmp_path):
    log = ScalarLog()
    agent = PPOAgent("run", tiny_run_params(tmp_path, None, use_diagnostics=True), device="cpu")
    agent.train(writer=log)
    tags = log.tags()
    for i in range(agent.mini_epochs_num):
        assert {f"diagnostics/kl/{i}", f"diagnostics/clip_frac/{i}"} <= tags
    assert {"diagnostics/obs_rms_mean", "diagnostics/obs_rms_var",
            "diagnostics/value_rms_mean", "diagnostics/value_rms_var"} <= tags
    assert sum(tag == "diagnostics/kl/0" for tag, _, _ in log.rows) == 3
    # the step rate comes from the timed rollout, not the whole epoch
    assert agent._rollout_time is not None and agent._rollout_time > 0
    step = [v for tag, v, _ in log.rows if tag == "performance/step_fps"]
    assert step == [pytest.approx(agent.batch_size / agent._rollout_time)] * 3


def test_rollout_timing_puts_the_state_back():
    agent = PPOAgent("run", diag_params(8), device="cpu")
    state = agent.init_state()
    before = dict(_leaves(ckpt.tree_to_plain(state)))
    seconds, state = agent._calibrate_rollout_time(state)
    after = dict(_leaves(ckpt.tree_to_plain(state)))
    assert seconds > 0 and sorted(before) == sorted(after)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    # and the next epoch is the one an agent that never timed would run
    other = PPOAgent("run", diag_params(8), device="cpu")
    other_state = other.init_state()
    _, m1 = agent.train_epoch(state)
    _, m2 = other.train_epoch(other_state)
    for k in ("a_loss", "c_loss", "kl"):
        assert torch.equal(m1[k], m2[k]), k


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is None:  # an option the train state does not use
        return
    else:
        yield prefix, tree


def test_metrics_reach_the_host_as_numpy():
    host = tppo._to_host({"a": torch.ones(2), "_diag": {"kl": torch.zeros(3)}})
    assert isinstance(host["a"], np.ndarray) and isinstance(host["_diag"]["kl"], np.ndarray)
