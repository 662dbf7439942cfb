"""Model wrappers: distribution head and normalizers over the network torso.

Port of rl_games_tpu/models/models.py ``NormState`` .. ``ModelA2C`` and
``ModelA2CContinuousLogStd`` (:36-333; the reference's
models.py:16-125,289-348). The JAX package passes ``(params, norm)``
through pure functions; here the model is an ``nn.Module`` that owns both:
the torso as ``a2c_network`` and the normalizer states (the JAX
``NormState``) as ``running_mean_std`` and ``value_mean_std``, the
reference checkpoint names. Normalizer updates stay explicit calls, as in
the JAX package, not a side effect of a forward.
"""

from typing import Optional

import torch
from torch import nn

from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models.network_builder import A2CNetwork
from rl_games_tpu_torch.ops import divergence
from rl_games_tpu_torch.ops.running_stats import RunningMeanStd


class BaseModel(nn.Module):
    """The torso and the two normalizers (BaseModelNetwork, models.py:16-63);
    subclasses add the distribution head's forwards."""

    is_continuous = False

    def __init__(self, a2c_network: A2CNetwork, *, obs_shape, normalize_input: bool = False,
                 normalize_value: bool = False, value_size: int = 1, device=None):
        super().__init__()
        if isinstance(obs_shape, dict):
            raise NotImplementedError("dict observations are not ported yet (see ROADMAP.md)")
        self.a2c_network = a2c_network
        self.normalize_input = normalize_input
        self.normalize_value = normalize_value
        self.value_size = value_size
        if normalize_input:
            self.running_mean_std = RunningMeanStd(obs_shape, device=device)
        if normalize_value:
            self.value_mean_std = RunningMeanStd((value_size,), device=device)

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
    torso's logits."""

    def forward_train(self, obs, prev_actions):
        """The reference's train dict (models.py:95-125); ``logits`` are the
        log-probabilities, values stay normalized."""
        out = self.a2c_network(self.norm_obs(obs))
        logits = out["logits"]
        return {
            "prev_neglogp": D.categorical_neglogp(logits, prev_actions),
            "values": out["value"],
            "entropy": D.categorical_entropy(logits),
            "logits": D.categorical_log_probs(logits),
        }

    def forward_play(self, obs, generator=None, deterministic: bool = False):
        """Sampled (or, deterministic, argmax) actions with their neglogp and
        denormalized values."""
        out = self.a2c_network(self.norm_obs(obs))
        logits = out["logits"]
        if deterministic:
            actions = torch.argmax(logits, dim=-1)
        else:
            actions = D.categorical_sample(logits, generator)
        return {
            "neglogpacs": D.categorical_neglogp(logits, actions),
            "values": self.denorm_value(out["value"]),
            "actions": actions,
            "logits": D.categorical_log_probs(logits),
        }

    @staticmethod
    def kl(old_logp, new_logp):
        """Categorical KL from log-probs (models.py:90-93)."""
        return divergence.d_kl_discrete(old_logp, new_logp)


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

    def _dist_params(self, obs):
        out = self.a2c_network(self.norm_obs(obs))
        sigma, logstd = D.apply_sigma_parametrization(
            out["sigma_raw"],
            parametrization=self.sigma_parametrization,
            min_sigma=self.min_sigma,
            logstd_bounds=self.logstd_bounds,
        )
        return out, out["mu"], sigma, logstd

    def forward_train(self, obs, prev_actions):
        """The reference's train dict (models.py:313-343); values stay in the
        normalized space the value loss works in."""
        out, mu, sigma, logstd = self._dist_params(obs)
        return {
            "prev_neglogp": D.normal_neglogp(prev_actions, mu, sigma, logstd),
            "values": out["value"],
            "entropy": D.normal_entropy(logstd),
            "mus": mu,
            "sigmas": sigma,
        }

    def forward_play(self, obs, generator=None, deterministic: bool = False):
        """Sampled (or, deterministic, mean) actions with their neglogp and
        denormalized values."""
        out, mu, sigma, logstd = self._dist_params(obs)
        actions = mu if deterministic else D.normal_sample(mu, sigma, generator)
        return {
            "neglogpacs": D.normal_neglogp(actions, mu, sigma, logstd),
            "values": self.denorm_value(out["value"]),
            "actions": actions,
            "mus": mu,
            "sigmas": sigma,
        }

    @staticmethod
    def kl(mu0, sigma0, mu1, sigma1):
        """Analytic Gaussian KL for adaptive LR (a2c_continuous.py:214-218)."""
        return divergence.d_kl_normal((mu0, sigma0), (mu1, sigma1))
