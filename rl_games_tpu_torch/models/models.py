"""Model wrappers: distribution head and normalizers over the network torso.

Port of rl_games_tpu/models/models.py ``NormState`` .. ``ModelCentralValue``
(:36-432; the reference's models.py:16-200,203-348,351-448): the discrete
model with its optional action masks, the multi-discrete one, the
continuous ones (log-std, std and the Brax-style tanh policy) and the
value-only central value model. Every forward takes the recurrent torso's
``rnn_states``, ``dones`` and ``seq_length`` (models.py:139-190) and
returns the new states as 'rnn_states'. The JAX
package passes ``(params, norm)`` through pure functions; here the model is
an ``nn.Module`` that owns both: the torso as ``a2c_network`` and the
normalizer states (the JAX ``NormState``) as ``running_mean_std`` and
``value_mean_std``, the reference checkpoint names. Normalizer updates stay
explicit calls, as in the JAX package, not a side effect of a forward. A
dict ``obs_shape`` gets one normalizer per key (``RunningMeanStdObs``):
every key is normalized, as in the JAX package. A network's optional
'aux_losses' (custom networks, ``models/test_network.py``) pass through
``forward_train`` to the loss, as do the two-hot value head's
'value_logits' (``passthrough_extras``, :93-101).
"""

from typing import Optional

import torch
from torch import nn

from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models.network_builder import A2CNetwork
from rl_games_tpu_torch.ops import divergence
from rl_games_tpu_torch.ops.running_stats import RunningMeanStd, RunningMeanStdObs
from rl_games_tpu_torch.parallel.mesh import draw_rows


def passthrough_extras(out, result):
    """A network's optional 'aux_losses' (the reference's get_aux_loss,
    a2c_continuous.py:194-202) and the two-hot value head's 'value_logits'
    (common/layers/value.py:33-38) into the train dict, for the loss
    (models.py:93-101)."""
    for k in ("aux_losses", "value_logits"):
        if k in out:
            result[k] = out[k]
    return result


class BaseModel(nn.Module):
    """The torso and the two normalizers (BaseModelNetwork, models.py:16-63);
    subclasses add the distribution head's forwards."""

    is_continuous = False

    def __init__(self, a2c_network: A2CNetwork, *, obs_shape, normalize_input: bool = False,
                 normalize_value: bool = False, value_size: int = 1, device=None):
        super().__init__()
        self.a2c_network = a2c_network
        self.normalize_input = normalize_input
        self.normalize_value = normalize_value
        self.value_size = value_size
        if normalize_input:
            self.running_mean_std = (RunningMeanStdObs(obs_shape, device=device) if isinstance(obs_shape, dict)
                                     else RunningMeanStd(obs_shape, device=device))
        if normalize_value:
            self.value_mean_std = RunningMeanStd((value_size,), device=device)

    def forward(self, mode: str, *args, **kwargs):
        """``model(mode, ...)`` is ``model.<mode>(...)``: the call that
        ``torch.func.functional_call`` makes, so that a forward can run on
        substituted parameters (mixed precision's rounded weights)."""
        return getattr(self, mode)(*args, **kwargs)

    # -- the recurrent state (models.py:139-145) -----------------------------
    def is_rnn(self) -> bool:
        return self.a2c_network.is_rnn()

    def get_default_rnn_state(self, num_seqs: int):
        return self.a2c_network.get_default_rnn_state(num_seqs, self.a2c_network.value.weight.device)

    def _net(self, obs, rnn_states=None, dones=None, seq_length: int = 1):
        return self.a2c_network(self.norm_obs(obs), rnn_states=rnn_states, dones=dones, seq_length=seq_length)

    # -- normalizer state (models.py:44-90) ----------------------------------
    def reset_parameters(self, generator=None):
        """Draw fresh torso weights and reset both normalizers."""
        self.a2c_network.reset_parameters(generator)
        if self.normalize_input:
            self.running_mean_std.reset()
        if self.normalize_value:
            self.value_mean_std.reset()

    def norm_obs(self, obs):
        return self.running_mean_std.normalize(obs) if self.normalize_input else obs

    def denorm_value(self, value):
        return self.value_mean_std.denormalize(value) if self.normalize_value else value

    def normalize_values(self, x):
        return self.value_mean_std.normalize(x) if self.normalize_value else x

    def update_obs_stats(self, obs, mask=None):
        if self.normalize_input:
            self.running_mean_std.update_from_batch(obs, mask)

    def update_value_stats(self, returns, mask=None):
        if self.normalize_value:
            self.value_mean_std.update_from_batch(returns, mask)


class ModelA2C(BaseModel):
    """'discrete_a2c' (models.py:291-333): a categorical head over the
    torso's logits, with optional action masks (a masked action gets the
    logit -1e8 and no entropy)."""

    def forward_train(self, obs, prev_actions, action_masks=None, rnn_states=None, dones=None,
                      seq_length: int = 1):
        """The reference's train dict (models.py:95-125); ``logits`` are the
        log-probabilities, values stay normalized."""
        out = self._net(obs, rnn_states, dones, seq_length)
        logits = out["logits"]
        return passthrough_extras(out, {
            "prev_neglogp": D.categorical_neglogp(logits, prev_actions, action_masks),
            "values": out["value"],
            "entropy": D.categorical_entropy(logits, action_masks),
            "logits": D.categorical_log_probs(logits, action_masks),
            "rnn_states": out["rnn_states"],
        })

    def forward_play(self, obs, generator=None, deterministic: bool = False, action_masks=None,
                     rnn_states=None, dones=None, seq_length: int = 1):
        """Sampled (or, deterministic, the argmax of the masked logits)
        actions with their neglogp and denormalized values."""
        out = self._net(obs, rnn_states, dones, seq_length)
        logits = out["logits"]
        if deterministic:
            actions = torch.argmax(D.masked_logits(logits, action_masks), dim=-1)
        else:
            actions = D.categorical_sample(logits, generator, action_masks)
        return {
            "neglogpacs": D.categorical_neglogp(logits, actions, action_masks),
            "values": self.denorm_value(out["value"]),
            "actions": actions,
            "logits": D.categorical_log_probs(logits, action_masks),
            "rnn_states": out["rnn_states"],
        }

    @staticmethod
    def kl(old_logp, new_logp):
        """Categorical KL from log-probs (models.py:90-93)."""
        return divergence.d_kl_discrete(old_logp, new_logp)


def _split_masks(action_masks, n_heads):
    """One mask per head from None, a tuple, or a stacked [B, heads, n]
    tensor (models.py:336-349)."""
    if action_masks is None:
        return (None,) * n_heads
    if isinstance(action_masks, (tuple, list)):
        return tuple(action_masks)
    if action_masks.dim() >= 3 and action_masks.shape[-2] == n_heads:
        return tuple(action_masks[..., i, :] for i in range(n_heads))
    return (action_masks,) * n_heads if n_heads == 1 else tuple(action_masks[i] for i in range(n_heads))


class ModelA2CMultiDiscrete(BaseModel):
    """'multi_discrete_a2c' (models.py:351-412): one categorical head per
    action dim; the heads' log-probabilities and entropies sum. Actions
    are [B, heads] integers."""

    def forward_train(self, obs, prev_actions, action_masks=None, rnn_states=None, dones=None,
                      seq_length: int = 1):
        out = self._net(obs, rnn_states, dones, seq_length)
        logits_list = out["logits"]
        masks = _split_masks(action_masks, len(logits_list))
        return passthrough_extras(out, {
            "prev_neglogp": sum(D.categorical_neglogp(l, prev_actions[..., i], masks[i])
                                for i, l in enumerate(logits_list)),
            "values": out["value"],
            "entropy": sum(D.categorical_entropy(l, masks[i]) for i, l in enumerate(logits_list)),
            "logits": tuple(D.categorical_log_probs(l, masks[i]) for i, l in enumerate(logits_list)),
            "rnn_states": out["rnn_states"],
        })

    def forward_play(self, obs, generator=None, deterministic: bool = False, action_masks=None,
                     rnn_states=None, dones=None, seq_length: int = 1):
        out = self._net(obs, rnn_states, dones, seq_length)
        logits_list = out["logits"]
        masks = _split_masks(action_masks, len(logits_list))
        actions, neglogp = [], 0.0
        for i, l in enumerate(logits_list):
            if deterministic:
                a = torch.argmax(D.masked_logits(l, masks[i]), dim=-1)
            else:
                a = D.categorical_sample(l, generator, masks[i])
            neglogp = neglogp + D.categorical_neglogp(l, a, masks[i])
            actions.append(a)
        return {
            "neglogpacs": neglogp,
            "values": self.denorm_value(out["value"]),
            "actions": torch.stack(actions, dim=-1),
            "logits": tuple(D.categorical_log_probs(l, masks[i]) for i, l in enumerate(logits_list)),
            "rnn_states": out["rnn_states"],
        }

    @staticmethod
    def kl(old_logp_list, new_logp_list):
        return divergence.d_kl_discrete_list(old_logp_list, new_logp_list)


class ModelA2CContinuousLogStd(BaseModel):
    """'continuous_a2c_logstd' (models.py:289-348): the raw sigma head is the
    log-std; apply_sigma_parametrization maps it to (sigma, logstd)."""

    is_continuous = True

    def __init__(self, a2c_network: A2CNetwork, *, space_cfg: Optional[dict] = None, **kwargs):
        super().__init__(a2c_network, **kwargs)
        sc = space_cfg or {}
        self.min_sigma = float(sc.get("min_sigma", 0.0))
        self.logstd_bounds = sc.get("logstd_bounds", None)
        self.sigma_parametrization = sc.get("sigma_parametrization", "exp")

    def _dist_params(self, out):
        sigma, logstd = D.apply_sigma_parametrization(
            out["sigma_raw"],
            parametrization=self.sigma_parametrization,
            min_sigma=self.min_sigma,
            logstd_bounds=self.logstd_bounds,
        )
        return out["mu"], sigma, logstd

    def forward_train(self, obs, prev_actions, rnn_states=None, dones=None, seq_length: int = 1):
        """The reference's train dict (models.py:313-343); values stay in the
        normalized space the value loss works in."""
        out = self._net(obs, rnn_states, dones, seq_length)
        mu, sigma, logstd = self._dist_params(out)
        return passthrough_extras(out, {
            "prev_neglogp": D.normal_neglogp(prev_actions, mu, sigma, logstd),
            "values": out["value"],
            "entropy": D.normal_entropy(logstd),
            "mus": mu,
            "sigmas": sigma,
            "rnn_states": out["rnn_states"],
        })

    def forward_play(self, obs, generator=None, deterministic: bool = False, rnn_states=None, dones=None,
                     seq_length: int = 1):
        """Sampled (or, deterministic, mean) actions with their neglogp and
        denormalized values."""
        out = self._net(obs, rnn_states, dones, seq_length)
        mu, sigma, logstd = self._dist_params(out)
        actions = mu if deterministic else D.normal_sample(mu, sigma, generator)
        return {
            "neglogpacs": D.normal_neglogp(actions, mu, sigma, logstd),
            "values": self.denorm_value(out["value"]),
            "actions": actions,
            "mus": mu,
            "sigmas": sigma,
            "rnn_states": out["rnn_states"],
        }

    @staticmethod
    def kl(mu0, sigma0, mu1, sigma1):
        """Analytic Gaussian KL for adaptive LR (a2c_continuous.py:214-218)."""
        return divergence.d_kl_normal((mu0, sigma0), (mu1, sigma1))


class ModelA2CContinuous(ModelA2CContinuousLogStd):
    """'continuous_a2c' (models.py:208-221): the sigma head's output (after
    sigma_activation, e.g. softplus) is the std itself."""

    def _dist_params(self, out):
        sigma = out["sigma_raw"]
        return out["mu"], sigma, torch.log(sigma)


class ModelA2CContinuousTanh(BaseModel):
    """'continuous_a2c_tanh' (models.py:223-289): the Brax-style NormalTanh
    policy, a softplus-scaled std and a tanh bijector with log-det-corrected
    log-probs; its entropy is estimated from one sample, so ``forward_train``
    takes standard normals ``entropy_noise``, fresh for every minibatch."""

    is_continuous = True
    sampled_entropy = True

    def __init__(self, a2c_network: A2CNetwork, *, space_cfg: Optional[dict] = None, **kwargs):
        super().__init__(a2c_network, **kwargs)
        self.min_std = float((space_cfg or {}).get("min_std", 0.001))

    def _dist(self, obs, rnn_states=None, dones=None, seq_length: int = 1):
        out = self._net(obs, rnn_states, dones, seq_length)
        return out, D.NormalTanhDistribution(out["mu"], out["sigma_raw"], min_std=self.min_std)

    def forward_train(self, obs, prev_actions, entropy_noise=None, rnn_states=None, dones=None,
                      seq_length: int = 1):
        if entropy_noise is None:
            # a fixed draw would bias the entropy's gradient the same way in
            # every minibatch
            raise ValueError("ModelA2CContinuousTanh.forward_train needs entropy_noise, standard normals "
                             "drawn fresh for every minibatch")
        out, dist = self._dist(obs, rnn_states, dones, seq_length)
        return passthrough_extras(out, {
            "prev_neglogp": -dist.log_prob(prev_actions),
            "values": out["value"],
            "entropy": dist.entropy(entropy_noise),
            "mus": dist.loc,
            "sigmas": dist.scale,
            "rnn_states": out["rnn_states"],
        })

    def forward_play(self, obs, generator=None, deterministic: bool = False, rnn_states=None, dones=None,
                     seq_length: int = 1):
        """tanh(mu) (deterministic) or a squashed sample, in [-1, 1]."""
        out, dist = self._dist(obs, rnn_states, dones, seq_length)
        if deterministic:
            actions, pre = dist.mode(), dist.loc
        else:
            noise = draw_rows(torch.randn, dist.loc.shape, generator, device=dist.loc.device,
                              dtype=dist.loc.dtype)
            actions, pre = dist.sample(noise)
        return {
            "neglogpacs": -dist.log_prob(actions, pre_tanh=pre),
            "values": self.denorm_value(out["value"]),
            "actions": actions,
            "mus": dist.loc,
            "sigmas": dist.scale,
            "rnn_states": out["rnn_states"],
        }

    # the Gaussian KL before the tanh, which the bijector leaves as it is
    kl = staticmethod(ModelA2CContinuousLogStd.kl)


class ModelCentralValue(BaseModel):
    """'central_value' (models.py:414-432): the value-only forward of the
    asymmetric critic, over the env's states."""

    def forward_train(self, obs, rnn_states=None, dones=None, seq_length: int = 1):
        """Normalized values and the new recurrent states."""
        out = self._net(obs, rnn_states, dones, seq_length)
        return passthrough_extras(out, {"values": out["value"], "rnn_states": out["rnn_states"]})

    def forward_play(self, obs, rnn_states=None, dones=None, seq_length: int = 1):
        """Denormalized values and the new recurrent states."""
        out = self._net(obs, rnn_states, dones, seq_length)
        return {"values": self.denorm_value(out["value"]), "rnn_states": out["rnn_states"]}
