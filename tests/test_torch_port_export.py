"""Policy export (rl_games_tpu_torch/utils/export.py, the players'
make_export_policy, Runner.run's --export) against the JAX package's.

Port of tests/test_export.py's five tests. Where the weights can be carried
across (``utils/jax_params``), the port's ``.pt2`` artifact is held to the
JAX package's own StableHLO artifact (``rl_games_tpu.utils.export``, run
here on the CPU) on the same numpy observations at batches 1, 4 and 9:
rtol 1e-5 / atol 1e-6, as tests/test_export.py holds the artifact to the
model (both run the same float32 products, in another summation order).
Discrete actions are equal (int64 in the port, int32 in JAX). Also the
registered fused-MLP operator under ``torch.library.opcheck``, and the
exported graph of a fused policy, which holds that operator once.
"""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.ops.running_stats import rms_update_from_batch
from rl_games_tpu.utils import export as jexport
from rl_games_tpu_torch.envs.spaces import Box
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.ops import fused_mlp as fm
from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils import export
from rl_games_tpu_torch.utils.checkpoint import save_checkpoint
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict, sac_jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from test_networks import mlp_params  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
BATCHES = (1, 4, 9)
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rl_games_tpu", "configs")


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def model_pair(network, model_name, actions_num, obs_dim, normalize=True, seed=0, rnn=False):
    """(JAX model, params, norm, port model) with the same weights and, with
    ``normalize``, non-trivial normalizer stats."""
    params = {"model": {"name": model_name}, "network": network}
    kw = dict(actions_num=actions_num, input_shape=(obs_dim,), normalize_input=normalize,
              normalize_value=normalize)
    jmodel = JModelBuilder().load(params, **kw)
    init_kw = {"rnn_states": jmodel.get_default_rnn_state(2)} if rnn else {}
    jparams, norm = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, obs_dim), jnp.float32), **init_kw)
    jparams, norm = to_np(jparams), to_np(norm)
    if normalize:
        rng = np.random.default_rng(seed)
        norm = to_np(norm.replace(
            obs=rms_update_from_batch(norm.obs, rng.normal(size=(64, obs_dim)).astype(np.float32) * 2 + 1),
            value=rms_update_from_batch(norm.value, rng.normal(size=(64, 1)).astype(np.float32) * 5)))
    pmodel = ModelBuilder().load(params, device="cpu", **kw)
    pmodel.load_state_dict(jax_to_state_dict(jparams, norm, network, (obs_dim,)))
    return jmodel, jparams, norm, pmodel


def both_artifacts(jmodel, jparams, norm, pmodel, obs_dim, action_space=None, seed=1):
    """[(the JAX artifact's actions, the port's)] at each batch of BATCHES,
    and the port's artifact."""
    example = np.zeros((1, obs_dim), np.float32)
    jpolicy = jexport.load_policy(jexport.export_policy(jmodel, jparams, norm, jnp.asarray(example), action_space))
    blob = export.export_policy(pmodel, example, action_space)
    ppolicy = export.load_policy(blob)
    rng = np.random.default_rng(seed)
    out = []
    for b in BATCHES:
        obs = (rng.normal(size=(b, obs_dim)) * 3).astype(np.float32)
        out.append((np.asarray(jpolicy(jnp.asarray(obs))), ppolicy(obs).numpy()))
    return out, blob


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_export_roundtrip_continuous(fused):
    """tests/test_export.py::test_export_roundtrip_continuous with finite
    bounds: normalizers, clip and rescale inside the artifact; one artifact
    serves batches 1, 4 and 9. With ``mlp.fused`` the chain is the
    registered operator (its CPU implementation, plain_mlp)."""
    network = mlp_params()
    network["mlp"]["fused"] = fused
    jmodel, jparams, norm, pmodel = model_pair(network, "continuous_a2c_logstd", 3, 8)
    space = Box((3,), low=np.array([-1.0, -2.0, 0.0], np.float32), high=np.array([1.0, 0.5, 4.0], np.float32))
    pairs, blob = both_artifacts(jmodel, jparams, norm, pmodel, 8, space)
    for jact, pact in pairs:
        assert pact.shape == jact.shape and pact.dtype == np.float32
        np.testing.assert_allclose(pact, jact, **TOL)
        assert np.all(pact >= space.low - 1e-6) and np.all(pact <= space.high + 1e-6)
    # with an infinite bound it neither clips nor rescales (export.py:31-36): mu as it is
    inf = Box((3,), low=np.array([-np.inf] * 3, np.float32), high=np.ones(3, np.float32))
    policy = export.load_policy(export.export_policy(pmodel, np.zeros((1, 8), np.float32), inf))
    obs = torch.randn((5, 8), generator=torch.Generator().manual_seed(3)) * 3
    with torch.no_grad():
        mu = pmodel.forward_play(obs, deterministic=True)["actions"]
    torch.testing.assert_close(policy(obs), mu, rtol=0, atol=0)
    if fused:
        program = torch.export.load(io.BytesIO(blob))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert targets.count("rl_games_tpu_torch.fused_mlp.default") == 1


def test_export_discrete():
    """tests/test_export.py::test_export_discrete: the argmax of the logits,
    one action a row; int64 here, int32 in the JAX artifact."""
    jmodel, jparams, norm, pmodel = model_pair(mlp_params(space="discrete"), "discrete_a2c", 5, 6, normalize=False)
    for jact, pact in both_artifacts(jmodel, jparams, norm, pmodel, 6)[0]:
        assert pact.shape == jact.shape and pact.dtype == np.int64 and jact.dtype == np.int32
        np.testing.assert_array_equal(pact, jact)


def test_rnn_forward_play_without_states():
    """tests/test_export.py::test_rnn_forward_play_without_states: the
    port's forward_play without states starts from zero states, and so does
    the exported recurrent policy, equal to the JAX artifact's."""
    network = {
        "name": "actor_critic", "separate": False,
        "mlp": {"units": [16], "activation": "relu", "initializer": {"name": "default"}},
        "rnn": {"name": "lstm", "units": 16, "layers": 1},
        "space": {"discrete": {}},
    }
    jmodel, jparams, norm, pmodel = model_pair(network, "discrete_a2c", 2, 3, normalize=False, rnn=True)
    obs = torch.randn((4, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = pmodel.forward_play(obs, deterministic=True)
        zero = pmodel.forward_play(obs, deterministic=True, rnn_states=pmodel.get_default_rnn_state(4))
    assert out["actions"].shape == (4,)
    torch.testing.assert_close(out["actions"], zero["actions"], rtol=0, atol=0)
    torch.testing.assert_close(out["logits"], zero["logits"], rtol=0, atol=0)
    for jact, pact in both_artifacts(jmodel, jparams, norm, pmodel, 3)[0]:
        np.testing.assert_array_equal(pact, jact)


def load_cfg(name):
    with open(os.path.join(CONFIGS, name)) as f:
        return yaml.safe_load(f)


def test_cli_export_verb(tmp_path):
    """tests/test_export.py::test_cli_export_verb: train 2 epochs, export the
    checkpoint through Runner.run({'export': True}), reload the artifact and
    hold it to the player's forward on the same observations. The default
    path is ``<checkpoint>.pt2``; without -c, and for a dict observation,
    --export raises a ValueError, as the JAX runner does."""
    cfg = load_cfg("ppo_cartpole.yaml")
    cfg["params"]["network"]["mlp"]["fused"] = True
    cfg["params"]["config"].update(num_actors=4, horizon_length=8, minibatch_size=16, mini_epochs=2, max_epochs=2,
                                   train_dir=str(tmp_path), print_stats=False)
    runner = Runner(device="cpu")
    runner.load(cfg)
    runner.run({"train": True})
    nn_dir = tmp_path / "cartpole_ppo" / "nn"
    ckpt = str(next(p for p in nn_dir.iterdir() if p.name.startswith("last_")))
    out = runner.run({"export": True, "checkpoint": ckpt})
    assert out == ckpt + ".pt2"  # the default path; export_path names another (test_cli_export_sac)
    with open(out, "rb") as f:
        policy = export.load_policy(f.read())
    player = runner.create_player()
    player.restore(ckpt)
    obs = torch.tensor(np.random.default_rng(2).normal(size=(5, 4)), dtype=torch.float32)
    with torch.no_grad():
        expected = player.model.forward_play(obs, deterministic=True)["actions"]
    torch.testing.assert_close(policy(obs), expected, rtol=0, atol=0)
    with pytest.raises(ValueError, match="requires -c"):
        runner.run({"export": True})

    dict_cfg = load_cfg("ref/test/test_discrite_testnet_aux_loss.yaml")
    dict_cfg["params"]["config"].update(num_actors=2, player={"games_num": 1})
    dict_runner = Runner(device="cpu")
    dict_runner.load(dict_cfg)
    dict_ckpt = str(tmp_path / "dict.pth")
    save_checkpoint(dict_ckpt, {}, weights=dict_runner.create_player().model.state_dict())
    with pytest.raises(ValueError, match="flat observation spaces"):
        dict_runner.run({"export": True, "checkpoint": dict_ckpt})


def test_cli_export_sac(tmp_path):
    """tests/test_export.py::test_cli_export_sac: --export of a SAC
    checkpoint (sac_pendulum.yaml, 2 epochs): tanh(mu) with the normalizer
    and the rescale inside, Pendulum's actions within [-2, 2], equal to the
    player's export module run eagerly."""
    cfg = load_cfg("sac_pendulum.yaml")
    cfg["params"]["config"].update(train_dir=str(tmp_path), max_epochs=2, num_actors=4, num_warmup_steps=1,
                                   print_stats=False)
    runner = Runner(device="cpu")
    runner.load(cfg)
    runner.run({"train": True})
    nn_dir = tmp_path / "pendulum_sac" / "nn"
    ckpt = str(next(p for p in nn_dir.iterdir() if p.name.startswith("last_")))
    out = str(tmp_path / "sac.pt2")
    assert runner.run({"export": True, "checkpoint": ckpt, "export_path": out}) == out
    with open(out, "rb") as f:
        policy = export.load_policy(f.read())
    obs = torch.tensor(np.random.default_rng(3).normal(size=(6, 3)), dtype=torch.float32)
    acts = policy(obs)
    assert acts.shape == (6, 1) and torch.all(acts.abs() <= 2.0 + 1e-6)
    player = runner.create_player()
    player.restore(ckpt)
    with torch.no_grad():
        torch.testing.assert_close(acts, player.make_export_policy()(obs), rtol=1e-5, atol=1e-6)


def test_sac_artifact_against_jax():
    """The port's SAC artifact against the JAX SACPlayer's
    (sac_pendulum.yaml; its actor and a non-trivial normalizer carried
    across by sac_jax_to_state_dict): batches 1, 4 and 9."""
    from rl_games_tpu.runner import Runner as JRunner

    cfg = load_cfg("sac_pendulum.yaml")
    cfg["params"]["config"]["num_actors"] = 2
    jrunner = JRunner()
    jrunner.load(cfg)
    jplayer = jrunner.create_player()
    rng = np.random.default_rng(4)
    jplayer.obs_rms = to_np(rms_update_from_batch(jplayer.obs_rms, (rng.normal(size=(32, 3)) * 2).astype(np.float32)))
    runner = Runner(device="cpu")
    runner.load(cfg)
    player = runner.create_player()
    sections = sac_jax_to_state_dict(to_np(jplayer.actor_params), obs_rms=jplayer.obs_rms)
    player.actor.load_state_dict(sections["actor"])
    player.running_mean_std.load_state_dict(sections["running_mean_std"])
    example = np.zeros((1, 3), np.float32)
    jpolicy = jexport.load_policy(jexport.export_policy_fn(jplayer.make_export_policy(), jnp.asarray(example)))
    ppolicy = export.load_policy(export.export_policy_fn(player.make_export_policy(), example))
    for b in BATCHES:
        obs = (rng.normal(size=(b, 3)) * 3).astype(np.float32)
        np.testing.assert_allclose(ppolicy(obs).numpy(), np.asarray(jpolicy(jnp.asarray(obs))), **TOL)


def test_fused_operator_opcheck():
    """torch.library.opcheck of rl_games_tpu_torch::fused_mlp on the CPU:
    its schema, its fake implementation against the real one, its autograd
    registration and AOT dispatch, with and without gradients wanted."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((6, 5), generator=gen)
    ws = [torch.randn((7, 5), generator=gen), torch.randn((3, 7), generator=gen)]
    bs = [torch.randn((7,), generator=gen), torch.randn((3,), generator=gen)]
    for args in ((x, ws, bs, "tanh"),
                 (x.clone().requires_grad_(), [w.clone().requires_grad_() for w in ws], bs, "elu")):
        torch.library.opcheck(fm.fused_mlp_op, args)
    y = torch.ops.rl_games_tpu_torch.fused_mlp(x, ws, bs, "None")
    torch.testing.assert_close(y, fm.plain_mlp(x, ws, bs, None), rtol=0, atol=0)
