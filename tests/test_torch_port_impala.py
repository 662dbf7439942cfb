"""The Impala tower in the port against the JAX package
(tests/test_torch_port_flatten.py holds the other readers of a conv stack's
flatten, tests/test_torch_port_impala_ppo.py the PPO updates).

On the same numpy-seeded inputs, with the weights carried across by
``jax_to_state_dict`` (and moved off their init by seeded noise, so that
the frozen batch-norm statistics and the residual scalars ``alpha`` are not
0 and 1):

- ``resnet_actor_critic`` (``cnn.type: impala``) with each of
  ``use_attention``, ``use_bn``, ``use_zero_init`` and all three: the train
  dict at rtol 1e-5 / atol 1e-6 and the gradients of a loss over it at rtol
  1e-4 with an atol of 1e-5 of each tensor's largest entry (the frozen
  statistics' gradients are 0 in both);
- tests/test_networks.py's impala cases (:152, :290): the torso's shapes,
  and the attention tower behind the resnet builder's extras (a reward and
  a one-hot last action joining a GRU's input), over sequences with dones;
- tests/test_torch_import.py's impala cases (:711, :868) as round trips: a
  port checkpoint read by the JAX package's ``convert_a2c_state_dict`` gives
  the port's forward in JAX (rtol 1e-5, atol 1e-5); the importer refuses a
  checkpoint with the attention gates, for which it has no destination.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.models import models as JM
from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.utils.torch_import import convert_a2c_state_dict, load_torch_state_dict
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SHAPE = (16, 16, 3)


def t(x):
    return torch.from_numpy(np.array(x))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, err_msg="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


def seeded_params(jmodel, example, states, seed):
    """The JAX model's param tree drawn from a numpy seed (the shapes from
    ``jax.eval_shape`` of its init, which compiles nothing): kernels
    N(0, 1 / fan_in), vectors and scalars N(0, 0.2), a FrozenBatchNorm's
    'var' in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.network.init, jax.random.PRNGKey(0), example, rnn_states=states)

    def draw(path, leaf):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.2
        return (scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jitter(tree, seed, scale=0.2):
    """Each vector and scalar leaf plus seeded normal noise: batch-norm
    statistics and scales, residual scalars and zero biases off their init
    (the kernels keep theirs)."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        return x + scale * rng.normal(size=x.shape).astype(np.float32) if x.ndim <= 1 else x

    return jax.tree.map(move, tree)


def positive_var(tree):
    """Every FrozenBatchNorm 'var' made positive again after ``jitter``."""
    if isinstance(tree, dict):
        return {k: (np.abs(v) + 0.5 if k == "var" else positive_var(v)) for k, v in tree.items()}
    return tree


def network(cnn=None, mlp=(32,), rnn=None, space=None, activation="relu", d2rl=False, **extra):
    net = {"name": "actor_critic", "separate": False,
           "mlp": {"units": list(mlp), "activation": activation, "d2rl": d2rl},
           "space": space or {"discrete": {}}, **extra}
    if cnn is not None:
        net["cnn"] = cnn
    if rnn is not None:
        net["rnn"] = rnn
    return net


def models(net, shape, actions_num=4, example=None, states=None, model="discrete_a2c", seed=0):
    """The JAX model, its params (``seeded_params``) and norm, and the port
    model with the weights carried across."""
    params = {"model": {"name": model}, "network": net}
    jmodel = JModelBuilder().load(params, actions_num=actions_num, input_shape=shape)
    if example is None:
        example = np.zeros((2, *shape), np.float32)
    jparams = seeded_params(jmodel, example, states, seed)
    jnorm = JM.init_norm_state(jmodel.obs_shape, jmodel.value_size, jmodel.normalize_input, jmodel.normalize_value)
    port = ModelBuilder().load(params, actions_num=actions_num, input_shape=shape, device="cpu")
    frames = shape["observation"] if isinstance(shape, dict) else shape
    sd = jax_to_state_dict(jparams, to_np(jnorm), network=net, input_shape=frames)
    assert sorted(sd) == sorted(port.state_dict())
    port.load_state_dict(sd)
    return jmodel, jparams, jnorm, port


def check_train_dict_and_grads(jmodel, jparams, jnorm, port, obs, actions, net, shape, rnn=None, keys=None):
    """The train dict and the gradients of a loss over it (and the new
    states), port against JAX."""
    rnn = rnn or {}
    keys = keys or ("prev_neglogp", "values", "entropy")

    def total(res):
        loss = res["prev_neglogp"].mean() + res["values"].mean() + 0.1 * res["entropy"].mean()
        for s in res.get("rnn_states") or ():
            loss = loss + s.mean()
        return loss

    def jtotal(p):
        jres = jmodel.forward_train(p, jnorm, obs, jnp.asarray(actions), **rnn)
        return total(jres), jres

    (_, jres), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jparams)
    prnn = {k: (tuple(t(s) for s in v) if isinstance(v, tuple) else t(v) if isinstance(v, np.ndarray) else v)
            for k, v in rnn.items()}
    res = port.forward_train(jax.tree.map(t, obs) if isinstance(obs, dict) else t(obs), t(actions), **prnn)
    for k in keys:
        close(res[k], jres[k], k)
    for a, b in zip(res.get("rnn_states") or (), jres.get("rnn_states") or ()):
        close(a, b, "rnn_states")
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(total(res), list(port.parameters()), allow_unused=True, materialize_grads=True)
    want = jax_to_state_dict(to_np(jgrads), network=net, input_shape=shape)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max() + 1e-12, err_msg=name)
    return res, grads, names


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

TOWER_CASES = {
    "plain": {}, "attention": {"use_attention": True}, "bn": {"use_bn": True},
    "zero_init": {"use_zero_init": True}, "all": {"use_attention": True, "use_bn": True, "use_zero_init": True},
}


@pytest.mark.parametrize("case", sorted(TOWER_CASES))
def test_impala_tower_matches_jax(case):
    """resnet_actor_critic over 16x16x3 frames, depths [8, 16], MLP [32]: the
    train dict and the gradients; the frozen statistics take none."""
    net = {**network(cnn={"conv_depths": [8, 16], **TOWER_CASES[case]}), "name": "resnet_actor_critic"}
    jmodel, jparams, jnorm, port = models(net, SHAPE)
    assert port.a2c_network.cnn is not None and hasattr(port.a2c_network, "mlp")
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(8, *SHAPE)).astype(np.float32)
    _, grads, names = check_train_dict_and_grads(jmodel, jparams, jnorm, port, obs, rng.integers(0, 4, 8), net,
                                                 SHAPE, keys=("prev_neglogp", "values", "entropy", "logits"))
    frozen = [g for n, g in zip(names, grads) if n.endswith(("running_mean", "running_var"))]
    assert len(frozen) == (2 * 2 * 5 if "bn" in case or case == "all" else 0)
    assert all(float(g.abs().max()) == 0.0 for g in frozen)


def test_impala_torso():
    """tests/test_networks.py::test_impala_torso: depths [4, 8] over 16x16x1,
    MLP [64], 5 actions: logits [2, 5], as the JAX torso's."""
    net = {**network(cnn={"type": "impala", "conv_depths": [4, 8]}, mlp=(64,))}
    jmodel, jparams, jnorm, port = models(net, (16, 16, 1), actions_num=5)
    obs = np.ones((2, 16, 16, 1), np.float32)
    jout = jmodel.network.apply(jparams, obs)
    out = port.a2c_network(t(obs))
    assert tuple(out["logits"].shape) == (2, 5)
    close(out["logits"], jout["logits"], "logits")
    close(out["value"], jout["value"], "value")


def test_impala_attention_and_extras():
    """tests/test_networks.py::test_impala_attention_and_extras: the
    attention tower (depths [8, 16]) behind the resnet builder's extras, a
    reward and an integer last action (one-hot) joining a GRU of 32 after
    the MLP; three sequences of four steps with dones, from random states."""
    net = {"name": "resnet_actor_critic", "separate": False,
           "cnn": {"type": "impala", "conv_depths": [8, 16], "use_attention": True},
           "mlp": {"units": [32], "activation": "relu", "initializer": {"name": "default"}},
           "rnn": {"name": "gru", "units": 32, "layers": 1}, "require_rewards": True,
           "require_last_actions": True, "space": {"discrete": {}}}
    shapes = {"observation": SHAPE, "reward": (), "last_action": ()}
    rng = np.random.default_rng(4)

    def draw(n):
        return {"observation": rng.normal(size=(n, *SHAPE)).astype(np.float32),
                "reward": rng.normal(size=n).astype(np.float32),
                "last_action": rng.integers(0, 4, n).astype(np.int32)}

    jstates = JModelBuilder().load({"model": {"name": "discrete_a2c"}, "network": net}, actions_num=4,
                                   input_shape=shapes).get_default_rnn_state(3)
    jmodel, jparams, jnorm, port = models(net, shapes, example=draw(3), states=jstates)
    assert "ChannelAttention_0" in str(jax.tree_util.tree_structure(jparams))
    assert port.a2c_network.rnn.rnn.weight_ih_l0.shape[1] == 32 + 1 + 4
    obs = draw(12)
    states = tuple(rng.normal(size=s.shape).astype(np.float32) for s in jstates)
    dones = (rng.random(12) < 0.3).astype(np.float32)
    rnn = dict(rnn_states=states, dones=dones, seq_length=4)
    check_train_dict_and_grads(jmodel, jparams, jnorm, port, obs, rng.integers(0, 4, 12), net, SHAPE, rnn)


def catcher_params(network_patch, **config):
    params = yaml.safe_load((ROOT / "rl_games_tpu/configs/ppo_pixelcatcher.yaml").read_text())["params"]
    params["network"] = {"name": "resnet_actor_critic", "separate": False, "space": {"discrete": {}},
                         "cnn": {"conv_depths": [4, 8]}, "mlp": {"units": [16], "activation": "relu"},
                         **network_patch}
    params["config"].update(num_actors=16, horizon_length=8, minibatch_size=32, mini_epochs=2, **config)
    return params


# ---------------------------------------------------------------------------
# checkpoints through the JAX package's importer
# ---------------------------------------------------------------------------

IMPORT_CASES = {"impala_resnet": {}, "impala_bn_zero_init": {"use_bn": True, "use_zero_init": True}}


@pytest.mark.parametrize("case", sorted(IMPORT_CASES))
def test_jax_importer_reads_port_impala_checkpoint(tmp_path, case):
    """tests/test_torch_import.py::test_import_impala_resnet and
    ::test_import_impala_bn_zero_init as round trips: a port checkpoint
    after one epoch on PixelCatcher (with the statistics and alphas off
    their init) holds the reference layout (a2c_network.cnn.{i}.conv.conv,
    .res_block{1,2}.conv{1,2}, .bn.*, .alpha, the resnet builder's
    a2c_network.mlp); convert_a2c_state_dict reads it, and the JAX model
    gives the port's forward."""
    params = catcher_params({"cnn": {"conv_depths": [4, 8], **IMPORT_CASES[case]}})
    agent = PPOAgent("a", params, device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    with torch.no_grad():
        gen = torch.Generator().manual_seed(9)
        for name, p in agent.model.named_parameters():
            if name.endswith(("running_mean", "alpha")):
                p.normal_(0.0, 0.5, generator=gen)
            elif name.endswith("running_var"):
                p.uniform_(0.5, 2.0, generator=gen)
    path = str(tmp_path / "p.pth")
    ckpt.save_checkpoint(path, state, {}, weights=agent.get_weights())
    sd = load_torch_state_dict(path)
    assert sorted(sd) == sorted(agent.model.state_dict())
    assert "a2c_network.cnn.1.res_block2.conv1.conv.weight" in sd and "a2c_network.mlp.0.weight" in sd
    if case == "impala_bn_zero_init":
        assert {"a2c_network.cnn.0.conv.bn.num_batches_tracked", "a2c_network.cnn.0.res_block1.alpha"} <= set(sd)
    shape = (16, 16, 1)
    jmodel = JModelBuilder().load(params, actions_num=3, input_shape=shape, normalize_input=agent.normalize_input,
                                  normalize_value=agent.normalize_value)
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), np.zeros((2, *shape), np.float32))
    jparams, norm = convert_a2c_state_dict(sd, jparams, norm, params["network"], shape)
    obs = np.random.default_rng(10).normal(size=(6, *shape)).astype(np.float32)
    jres = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True)
    with torch.no_grad():
        res = agent.model.forward_play(t(obs), deterministic=True)
    for k in ("logits", "values", "actions"):
        np.testing.assert_allclose(res[k].numpy(), np.asarray(jres[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def test_jax_importer_refuses_attention_checkpoints():
    """The JAX importer has no destination for the attention gates
    (torch_import.py fill_impala, :400-450): a port checkpoint of a
    use_attention tower is refused with its gate tensors named, not read
    with the gates left at their init."""
    net = {"name": "resnet_actor_critic", "separate": False, "space": {"discrete": {}},
           "cnn": {"conv_depths": [4], "use_attention": True}, "mlp": {"units": [8], "activation": "relu"}}
    params = {"model": {"name": "discrete_a2c"}, "network": net}
    port = ModelBuilder().load(params, actions_num=3, input_shape=(8, 8, 2), device="cpu")
    port.reset_parameters(torch.Generator().manual_seed(0))
    jmodel = JModelBuilder().load(params, actions_num=3, input_shape=(8, 8, 2))
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), np.zeros((2, 8, 8, 2), np.float32))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match=r"no destination.*res_block1\.ca\.fc1\.weight"):
        convert_a2c_state_dict(sd, jparams, norm, net, (8, 8, 2))
