"""Config-driven actor-critic torso.

Port of rl_games_tpu/models/network_builder.py ``A2CNetwork`` (:41-323):
one trunk, or with ``separate: True`` an actor trunk and a critic trunk
that the value head reads (:216-229); each trunk an optional conv stack
(``cnn``: the conv stacks of ``convs``, or with ``type: impala`` the Impala
tower of ``conv_depths``; NHWC observations permuted to NCHW as the
reference torch builder's ``permute_input`` does, and flattened in NCHW
order, the reference checkpoint's), an MLP (plain, fused or D2RL; none with
``units: []``) and an optional recurrent core (``rnn``: LSTM, GRU or
identity, after the MLP or with ``before_mlp`` in front of it,
``concat_input`` / ``concat_output`` of the flattened input, a LayerNorm of
its output with ``layer_norm``; :152-208); a value head: linear, of
``value_size`` outputs, or with ``value_head: twohot`` the 255-bin two-hot
head (:235-260: logits over ``distributions.TWOHOT_BINS``, the value
symexp of their expected bin, the logits as 'value_logits' for the loss);
and a continuous head (mu, and sigma either a fixed, state-independent
parameter or a Linear of the actor's features), a discrete one
(``logits``) or a multi-discrete one (a ``logits`` Linear per action head).
A central value net (``central_value: True``, or no action space) has the
value head only (:131, :264-270). The reference YAML ``network:`` schema is
read as in the JAX package.

The resnet builder's extras (:108-126, 173-174): a dict observation with an
'observation' key feeds that entry to the trunks, and with
``require_rewards`` its 'reward' ([B] or [B, 1]) and with
``require_last_actions`` its 'last_action' join the recurrent core's input,
after the features the core would read without them. An integer last action
is one-hot encoded over ``actions_num``, a float one is flattened as it is.
The core's width is fixed when it is built: a scalar last action (shape ())
is taken as an action index, one-hot encoded, as the JAX package's init
decides from an integer example; a forward checks that the tensor it gets
agrees. Behind the input normalizer the last action arrives as a float, and
both packages refuse it: the JAX package's apply with a shape error, the
port with a ValueError.

Submodules carry the reference checkpoint names (``actor_cnn``,
``actor_mlp``, ``critic_cnn``, ``critic_mlp``; an Impala tower on a shared
trunk, the resnet builder's, ``cnn`` and ``mlp``; the recurrent core ``rnn``
and its ``layer_norm`` on a shared trunk, ``a_rnn`` / ``c_rnn`` and
``a_layer_norm`` / ``c_layer_norm`` on separate ones, ``mu``, ``sigma``,
``logits`` or ``logits.{i}``, ``value``).
"""

import math
from typing import Sequence

import torch
from torch import nn

from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models import layers as L


def action_space_of(cfg: dict):
    """(kind, its config): 'continuous', 'multi_discrete' or 'discrete', or
    (None, {}) for a network without an action space (network_builder.py:74-82)."""
    space = cfg.get("space", {}) or {}
    for kind in ("continuous", "multi_discrete", "discrete"):
        if kind in space:
            return kind, space[kind] or {}
    return None, {}


_NO_OBSERVATION = ("the actor_critic network reads a dict observation through its 'observation' entry (the "
                   "resnet builder's extras); this one has the keys {}: a custom network reads others")

# the recurrent core's module names by trunk: a shared trunk's core is
# 'rnn', separate trunks' are 'a_rnn' and 'c_rnn' (the reference builder's)
RNN_MODULE_NAMES = {("actor_", False): ("rnn", "layer_norm"), ("actor_", True): ("a_rnn", "a_layer_norm"),
              ("critic_", True): ("c_rnn", "c_layer_norm")}

TWOHOT_HEADS = ("twohot", "twohot_encoded")


def trunk_module_names(prefix: str, separate: bool, impala: bool):
    """(the conv stack's, the MLP's) module names of a trunk: the resnet
    builder's ``cnn`` and ``mlp`` for an Impala tower on a shared trunk
    (the reference checkpoint's, network_builder.py:729-760), else
    ``{prefix}cnn`` and ``{prefix}mlp``."""
    if impala and not separate:
        return "cnn", "mlp"
    return prefix + "cnn", prefix + "mlp"


class A2CNetwork(nn.Module):
    """forward(obs, rnn_states=None, dones=None, seq_length=1) ->
    {'mu', 'sigma_raw', 'value', 'rnn_states'} (continuous),
    {'logits', 'value', 'rnn_states'} (discrete), {'logits': tuple, 'value',
    'rnn_states'} (multi-discrete) or {'value', 'rnn_states'} (central
    value); with the two-hot value head also 'value_logits' [B, 255].

    'sigma_raw' is the sigma parameter or head after sigma_activation,
    broadcast to mu's shape; the model applies the sigma parametrization to
    it. With an RNN, obs is [num_seqs · seq_length, ...] in sequence-major
    order, ``dones`` [num_seqs · seq_length] and ``rnn_states`` the tuple of
    ``get_default_rnn_state``'s layout (separate trunks: the actor's tensors,
    then the critic's); 'rnn_states' comes back alike (None without an RNN).
    """

    def __init__(self, params: dict, actions_num, input_shape: Sequence[int],
                 value_size: int = 1, device=None):
        super().__init__()
        cfg = params
        self.space, space_cfg = action_space_of(cfg)
        input_shape, extra = self._extras_of(cfg, actions_num, input_shape)
        self.central_value = bool(cfg.get("central_value", False)) or self.space is None
        self.discrete = self.space != "continuous"
        self.separate = bool(cfg.get("separate", False))
        self.twohot = cfg.get("value_head", cfg.get("value_type", "legacy")) in TWOHOT_HEADS

        cnn_cfg = cfg.get("cnn")
        impala = cnn_cfg is not None and cnn_cfg.get("type") == "impala"
        if cnn_cfg is not None:
            conv1d = cnn_cfg.get("type") == "conv1d"
            if len(input_shape) != (2 if conv1d else 3):
                raise ValueError(f"a {cnn_cfg.get('type', 'conv2d')} torso takes channels-last "
                                 f"observations, not shape {tuple(input_shape)}")
        elif len(input_shape) != 1:
            raise ValueError(f"an MLP torso takes flat observations, not shape {tuple(input_shape)}: "
                             "give the network a cnn")

        self.rnn_cfg = dict(cfg["rnn"]) if "rnn" in cfg else None
        rnn_cfg = self.rnn_cfg or {}
        mlp_cfg = cfg["mlp"]
        units = list(mlp_cfg["units"])
        self.trunk_names = {}
        for prefix in ("actor_", "critic_") if self.separate else ("actor_",):
            cnn_name, mlp_name = self.trunk_names[prefix] = trunk_module_names(prefix, self.separate, impala)
            flat = int(input_shape[0])
            cnn = None
            if impala:
                cnn = L.ImpalaCNN(
                    int(input_shape[-1]), cnn_cfg["conv_depths"], use_attention=cnn_cfg.get("use_attention", False),
                    use_bn=cnn_cfg.get("use_bn", False), use_zero_init=cnn_cfg.get("use_zero_init", False),
                    device=device,
                )
            elif cnn_cfg is not None:
                cnn = L.CNN(
                    int(input_shape[-1]), cnn_cfg["convs"], cnn_cfg["activation"],
                    initializer=cnn_cfg.get("initializer"),
                    norm_func_name=cfg.get("normalization", None),
                    ctype=cnn_cfg.get("type", "conv2d"), device=device,
                )
            if cnn is not None:
                flat = cnn.output_size(input_shape[:-1])
            setattr(self, cnn_name, cnn)

            def mlp(in_features):
                return L.build_mlp(
                    in_features, units, mlp_cfg["activation"],
                    initializer=mlp_cfg.get("initializer"),
                    norm_func_name=cfg.get("normalization", None),
                    d2rl=mlp_cfg.get("d2rl", False),
                    norm_only_first_layer=mlp_cfg.get("norm_only_first_layer", False),
                    fused=mlp_cfg.get("fused", False),
                    device=device,
                )

            def mlp_out(in_features):
                return units[-1] if units else in_features

            if self.rnn_cfg is None:
                setattr(self, mlp_name, mlp(flat))
                out_size = mlp_out(flat)
                continue
            core_name, ln_name = RNN_MODULE_NAMES[(prefix, self.separate)]
            before_mlp = rnn_cfg.get("before_mlp", False)
            if before_mlp:
                rnn_in = flat
            else:
                setattr(self, mlp_name, mlp(flat))
                rnn_in = mlp_out(flat) + (flat if rnn_cfg.get("concat_input", False) else 0)
            rnn_in += extra
            core = L.RNNCore(rnn_cfg["name"], rnn_in, rnn_cfg["units"], rnn_cfg["layers"], device=device)
            setattr(self, core_name, core)
            rnn_out = core.out_features
            if rnn_cfg.get("layer_norm", False):
                setattr(self, ln_name, nn.LayerNorm(rnn_out, eps=1e-5, device=device))
            if rnn_cfg.get("concat_output", False):
                rnn_out += flat
            if before_mlp:
                setattr(self, mlp_name, mlp(rnn_out))
                out_size = mlp_out(rnn_out)
            else:
                out_size = rnn_out
        if self.twohot:
            if value_size != 1:
                raise ValueError(f"the two-hot value head takes value_size 1, not {value_size}")
            self.value = L.with_init(nn.Linear(out_size, 255, device=device),
                                     lambda w, generator=None: nn.init.xavier_uniform_(w, 0.05, generator))
            self.register_buffer("twohot_bins", D.twohot_bins(device), persistent=False)
        else:
            self.value = L.make_dense(out_size, value_size, mlp_cfg.get("initializer"), device)
        self.value_act = L.get_activation(cfg.get("value_activation", "None"))
        if self.central_value:
            return
        if self.space == "discrete":
            self.logits = L.make_dense(out_size, actions_num, mlp_cfg.get("initializer"), device)
            return
        if self.space == "multi_discrete":
            self.logits = nn.ModuleList(L.make_dense(out_size, n, mlp_cfg.get("initializer"), device)
                                        for n in actions_num)
            return
        self.mu = L.make_dense(out_size, actions_num, space_cfg.get("mu_init"), device)
        self.mu_act = L.get_activation(space_cfg.get("mu_activation", "None"))
        self.sigma_act = L.get_activation(space_cfg.get("sigma_activation", "None"))
        sigma_init = space_cfg.get("sigma_init", {})
        self.fixed_sigma = bool(space_cfg.get("fixed_sigma", True))
        self.sigma_init_val = float(sigma_init.get("val", sigma_init.get("value", 0.0)))
        if self.fixed_sigma:
            self.sigma = nn.Parameter(
                torch.full((actions_num,), self.sigma_init_val, dtype=torch.float32, device=device)
            )
        elif sigma_init.get("name") == "const_initializer":
            # the state-dependent head's const init writes the bias, with
            # zero weights (network_builder.py:300-310)
            val = self.sigma_init_val
            self.sigma = L.make_dense(out_size, actions_num, None, device)
            self.sigma.weight_init = lambda w, generator=None: nn.init.zeros_(w)
            self.sigma.bias_init = lambda b: nn.init.constant_(b, val)
        else:
            self.sigma = L.make_dense(out_size, actions_num, sigma_init, device)

    def _extras_of(self, cfg: dict, actions_num, input_shape):
        """(the trunks' input shape, the width the extras add to the core's
        input) for ``input_shape``, which is a dict for a dict observation:
        its 'observation' entry and, where the config asks for them, its
        'reward' and 'last_action'."""
        self.require_rewards = bool(cfg.get("require_rewards", False))
        self.require_last_actions = bool(cfg.get("require_last_actions", False))
        self.actions_num = actions_num
        self.one_hot_last_action = False
        if not isinstance(input_shape, dict):
            return input_shape, 0
        if "observation" not in input_shape:
            raise ValueError(_NO_OBSERVATION.format(sorted(input_shape)))
        extra = 1 if self.require_rewards else 0
        if self.require_last_actions:
            shape = tuple(input_shape["last_action"])
            self.one_hot_last_action = shape == () and isinstance(actions_num, int)
            extra += actions_num if self.one_hot_last_action else math.prod(shape)
        return input_shape["observation"], extra

    def _split_obs(self, obs):
        """(the trunks' input, the extras for the core's input or None)."""
        if not isinstance(obs, dict):
            return obs, None
        if "observation" not in obs:
            raise ValueError(_NO_OBSERVATION.format(sorted(obs)))
        if self.rnn_cfg is None:  # the extras feed the core alone
            return obs["observation"], None
        parts = []
        if self.require_rewards:
            parts.append(obs["reward"].reshape(-1, 1).to(torch.float32))
        if self.require_last_actions:
            la = obs["last_action"]
            integer = not la.is_floating_point()
            if integer != self.one_hot_last_action:
                raise ValueError(f"the core was built for {'an integer' if self.one_hot_last_action else 'a float'} "
                                 f"last action and got a {la.dtype} one of shape {tuple(la.shape)}")
            if integer:
                la = torch.nn.functional.one_hot(la.long(), self.actions_num).to(torch.float32)
            parts.append(la.reshape(la.shape[0], -1))
        return obs["observation"], (torch.cat(parts, dim=-1) if parts else None)

    def reset_parameters(self, generator=None):
        L.reset_parameters(self, generator)
        if self.space == "continuous" and not self.central_value and self.fixed_sigma:
            with torch.no_grad():
                self.sigma.fill_(self.sigma_init_val)

    # -- the recurrent state (network_builder.py:91-101) ---------------------
    def is_rnn(self) -> bool:
        return self.rnn_cfg is not None

    def get_default_rnn_state(self, num_seqs: int, device=None):
        """Zero states for ``num_seqs`` sequences; separate trunks carry the
        actor's tensors, then the critic's."""
        if self.rnn_cfg is None:
            return None
        c = self.rnn_cfg
        states = L.default_rnn_state(c["name"], c["layers"], num_seqs, c["units"], device)
        if self.separate:
            return states + L.default_rnn_state(c["name"], c["layers"], num_seqs, c["units"], device)
        return states

    def _apply_rnn(self, x, flat, prefix, states, dones, seq_length, extra=None):
        """x [B, F] (and the extras after it) through the trunk's core as
        [B / seq_length, seq_length, F] sequences; returns ([B, F'],
        new_states)."""
        core_name, ln_name = RNN_MODULE_NAMES[(prefix, self.separate)]
        if extra is not None:
            x = torch.cat([x, extra], dim=-1)
        batch = x.shape[0]
        num_seqs = batch // seq_length
        d = None if dones is None else dones.reshape(num_seqs, seq_length)
        out, new_states = getattr(self, core_name)(x.reshape(num_seqs, seq_length, -1), states, d)
        out = out.reshape(batch, -1)
        if self.rnn_cfg.get("layer_norm", False):
            out = getattr(self, ln_name)(out)
        if self.rnn_cfg.get("concat_output", False):
            out = torch.cat([out, flat], dim=-1)
        return out, new_states

    def _trunk(self, obs, prefix: str, states=None, dones=None, seq_length: int = 1, extra=None):
        cnn_name, mlp_name = self.trunk_names[prefix]
        x, cnn = obs, getattr(self, cnn_name)
        if cnn is not None:
            # channels-last observations to channels-first (permute_input),
            # flattened in (c, h, w) order
            x = cnn(x.movedim(-1, 1)).flatten(1)
        mlp = getattr(self, mlp_name)
        if self.rnn_cfg is None:
            return mlp(x), None
        flat = x
        if self.rnn_cfg.get("before_mlp", False):
            out, states = self._apply_rnn(flat, flat, prefix, states, dones, seq_length, extra)
            return mlp(out), states
        out = mlp(flat)
        if self.rnn_cfg.get("concat_input", False):
            out = torch.cat([out, flat], dim=-1)
        return self._apply_rnn(out, flat, prefix, states, dones, seq_length, extra)

    def forward(self, obs, rnn_states=None, dones=None, seq_length: int = 1):
        obs, extra = self._split_obs(obs)
        if self.separate:
            half = None if rnn_states is None else len(rnn_states) // 2
            a_states = None if half is None else tuple(rnn_states[:half])
            c_states = None if half is None else tuple(rnn_states[half:])
            a_out, a_states = self._trunk(obs, "actor_", a_states, dones, seq_length, extra)
            c_out, c_states = self._trunk(obs, "critic_", c_states, dones, seq_length, extra)
            new_states = None if self.rnn_cfg is None else tuple(a_states) + tuple(c_states)
        else:
            a_out, new_states = self._trunk(obs, "actor_", rnn_states, dones, seq_length, extra)
            c_out = a_out
            new_states = None if new_states is None else tuple(new_states)
        out = {"rnn_states": new_states}
        if self.twohot:
            out["value_logits"] = self.value(c_out)
            out["value"] = D.symexp(D.twohot_decode(out["value_logits"], self.twohot_bins))[..., None]
        else:
            out["value"] = self.value_act(self.value(c_out))
        if self.central_value:
            return out
        if self.space == "discrete":
            out["logits"] = self.logits(a_out)
            return out
        if self.space == "multi_discrete":
            out["logits"] = tuple(head(a_out) for head in self.logits)
            return out
        out["mu"] = mu = self.mu_act(self.mu(a_out))
        if self.fixed_sigma:
            # mu * 0.0 broadcasts sigma to mu's shape, as the JAX torso does
            out["sigma_raw"] = self.sigma_act(self.sigma) + mu * 0.0
        else:
            out["sigma_raw"] = self.sigma_act(self.sigma(a_out))
        return out
