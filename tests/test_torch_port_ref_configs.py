"""Every shipped config through the port: the analogue of
tests/test_ref_configs.py for rl_games_tpu_torch.

Each YAML under rl_games_tpu/configs/ref/ and each top-level config in
rl_games_tpu/configs/ does one of three things on the CPU:

- runs one shrunk epoch through the port's ``Runner`` (its agent's train
  function), with finite losses;
- raises NotImplementedError naming the ROADMAP.md item that ports what it
  needs;
- needs a simulator this image lacks (ale_py, envpool, brax, SMAC,
  ManiSkill, mjlab, minigrid, MyoSuite), reported as an ImportError naming
  it; then its networks (the policy and, with ``central_value_config``,
  the central value net) are built on the CPU and run a forward at a
  representative observation shape, as tests/test_ref_configs.py's
  ``_build_only`` does for those families, or their refusal names a
  ROADMAP.md item.

The configs a slice unlocks must run (``MUST_RUN``); those whose simulator
is missing must build their networks (``MUST_BUILD``: since A8 (b) the
Impala configs and ref/minigrid/lava_rnn_img.yaml); the refusals named in
``REFUSED_AT`` name their item; and the only A8 refusal left is SAC over
observations that are not 1-D.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rl_games_tpu", "configs")
ALL_CONFIGS = sorted(glob.glob(os.path.join(CONFIGS, "ref", "**", "*.yaml"), recursive=True)
                     + glob.glob(os.path.join(CONFIGS, "*.yaml")))
IDS = [os.path.relpath(p, CONFIGS) for p in ALL_CONFIGS]

MUST_RUN = {
    "ref/ppo_cartpole.yaml", "ref/pufferlib/ppo_cartpole.yaml", "ref/ppo_pendulum.yaml",
    "ref/ppo_pendulum_torch.yaml", "ref/ppo_lunar.yaml", "ref/ppo_lunar_discrete.yaml", "ref/ppo_reacher.yaml",
    "ref/ppo_continuous.yaml", "ref/test/test_discrete.yaml", "ref/test/test_discrete_multidiscrete_mhv.yaml",
    # the recurrent torsos, the central value net (A9)
    "ref/test/test_rnn.yaml", "ref/test/test_rnn_multidiscrete.yaml", "ref/test/test_rnn_multidiscrete_mhv.yaml",
    "ref/test/test_asymmetric_discrete.yaml", "ref/test/test_asymmetric_discrete_mhv.yaml",
    "ref/test/test_asymmetric_continuous.yaml", "ref/ppo_cartpole_masked_velocity_rnn.yaml",
    "ref/ppo_continuous_lstm.yaml", "ref/ppo_lunar_continiuos_torch.yaml", "ref/ppo_walker_rnn.yaml",
    # dict observations, the custom test networks, normalized SAC torsos (A8 (a))
    "ref/test/test_asymmetric_discrete_mhv_mops.yaml", "ref/test/test_discrite_testnet_aux_loss.yaml",
    "ref/mujoco/sac_ant_tuned.yaml",
    # multi-agent PPO over pettingzoo's multiwalker, connect-four self-play (A12's second part)
    "ref/ppo_multiwalker.yaml", "ref/ma/ppo_connect4_self_play.yaml", "ref/ma/ppo_connect4_self_play_resnet.yaml",
}
# simulators missing: their networks must build (A8 (b): the Impala tower, a
# conv stack's flatten straight into an LSTM)
MUST_BUILD = {"ref/atari/ppo_breakout_torch_impala.yaml", "ref/atari/ppo_pong_envpool_resnet.yaml",
              "ref/atari/ppo_space_invaders_resnet.yaml", "ref/minigrid/lava_rnn_img.yaml"}
# the refusals that name a later item: none is left since the connect-four
# and multiwalker configs came with A12's second part
REFUSED_AT = {}
MISSING_SIMULATORS = ("ale_py", "envpool", "brax", "SMAC", "mani_skill", "mjlab", "minigrid", "myosuite")


def _shrink(params):
    """One short epoch: tests/test_ref_configs.py's _shrink, with 4 envs for
    SAC and 8 envs x 8 steps in one minibatch of 32 for PPO."""
    cfg = params["config"]
    cfg.pop("max_frames", None)
    cfg.pop("max_steps", None)
    cfg["max_epochs"] = 1
    cfg["save_frequency"] = 0
    cfg["print_stats"] = False
    if params["algo"]["name"] == "sac":
        cfg["num_actors"] = 4
        cfg["batch_size"] = 32
        cfg["replay_buffer_size"] = 1024
        cfg["num_warmup_steps"] = 1
        cfg.pop("num_warmup_frames", None)
        cfg["num_steps_per_episode"] = 2
        cfg["utd_ratio"] = 0.5
        cfg.pop("num_updates_per_step", None)
        cfg["log_interval"] = 1
    else:
        cfg["seq_length"] = 4 if "rnn" in params.get("network", {}) else 1
        cfg["num_actors"] = 8
        cfg["horizon_length"] = 8
        cfg["minibatch_size"] = 32
        cfg.pop("minibatch_size_per_env", None)
        cfg["mini_epochs"] = 1
        cv = cfg.get("central_value_config")
        if cv:
            cv["minibatch_size"] = 32
            cv.pop("minibatch_size_per_env", None)
            cv["mini_epochs"] = 1
    return params


def _build_only(params):
    """The networks of a config whose simulator is missing, at the
    observation shape tests/test_ref_configs.py's ``_build_only`` takes for
    its topology (conv2d or resnet: 84x84x4 frames; conv1d: 16 x 32; else
    96 flat), one forward from the default recurrent states: finite values."""
    from rl_games_tpu_torch.models.model_builder import ModelBuilder

    net, cfg = params.get("network", {}), params["config"]
    cnn_type = (net.get("cnn") or {}).get("type")
    if cnn_type == "conv1d":
        obs_shape = (16, 32)
    elif cnn_type == "conv2d" or net.get("name") == "resnet_actor_critic":
        obs_shape = (84, 84, 4)
    else:
        obs_shape = (96,)
    model_name = params.get("model", {}).get("name", "")
    actions_num = [3, 3] if "multi_discrete" in model_name else 8 if "continuous" in model_name else 6
    models = [ModelBuilder().load(params, actions_num=actions_num, input_shape=obs_shape,
                                  normalize_input=cfg.get("normalize_input", False),
                                  normalize_value=cfg.get("normalize_value", False), obs_shape=obs_shape,
                                  device="cpu")]
    cv = cfg.get("central_value_config")
    if cv:
        models.append(ModelBuilder().load({"model": {"name": "central_value"},
                                           "network": {**cv["network"], "central_value": True}},
                                          actions_num=None, input_shape=obs_shape,
                                          normalize_input=cv.get("normalize_input", False),
                                          normalize_value=cfg.get("normalize_value", False), obs_shape=obs_shape,
                                          device="cpu"))
    obs = torch.zeros((2, *obs_shape))
    for model in models:
        model.reset_parameters(torch.Generator().manual_seed(0))
        states = model.get_default_rnn_state(2) if model.is_rnn() else None
        with torch.no_grad():
            out = model.forward_play(obs, rnn_states=states)
        assert torch.isfinite(out["values"]).all()


def _only_sac_refused_for_a8(rel, refusal):
    """A8 has one refusal left: SAC over observations that are not 1-D."""
    if re.search(r"item A8\b", str(refusal)):
        assert "SAC over observations" in str(refusal), f"{rel}: an A8 refusal other than SAC's: {refusal}"


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=IDS)
def test_port_runs_or_names_its_item(path):
    from rl_games_tpu_torch.runner import Runner

    rel = os.path.relpath(path, CONFIGS)
    with open(path) as f:
        doc = yaml.safe_load(f)
    if "params" not in doc:  # smac v2's unit-distribution data files
        assert "env_configs" in rel
        return
    try:
        runner = Runner(device="cpu")
        runner.load(doc)
        _shrink(runner.params)
        agent = runner.create_agent()
        state, metrics = agent.make_train_fn()(agent.init_state())
    except NotImplementedError as e:
        assert rel not in MUST_RUN | MUST_BUILD, f"{rel} must run: {e}"
        assert re.search(r"ROADMAP\.md, item A\d+", str(e)), f"{rel}: the refusal names no ROADMAP.md item: {e}"
        _only_sac_refused_for_a8(rel, e)
        if rel in REFUSED_AT:
            assert f"item {REFUSED_AT[rel]}" in str(e), f"{rel}: {e}"
        return
    except ImportError as e:
        assert rel not in MUST_RUN, f"{rel} must run: {e}"
        assert any(sim in str(e) for sim in MISSING_SIMULATORS), f"{rel}: {e}"
        try:
            _build_only(runner.params)
        except NotImplementedError as refusal:
            assert rel not in MUST_BUILD, f"{rel} must build its networks: {refusal}"
            assert re.search(r"ROADMAP\.md, item A\d+", str(refusal)), f"{rel}: {refusal}"
            _only_sac_refused_for_a8(rel, refusal)
        return
    assert rel not in REFUSED_AT, f"{rel} runs where it should be refused at {REFUSED_AT[rel]}"
    for key in ("a_loss", "c_loss", "critic_loss", "actor_loss"):
        if key in metrics:
            assert np.isfinite(float(metrics[key])), (rel, key)
