"""Connect-four self-play host env (pettingzoo.classic).

Port of rl_games_tpu/envs/host/connect4_env.py (:1-256). The reference's
ma/ppo_connect4_self_play*.yaml configs bind an out-of-tree ``connect4_env``;
this env makes the family run: the learner plays one seat of
``connect_four_v3``, the other seat is an embedded opponent policy that the
SelfPlayManager feeds through the RayWorker-style ``set_weights(indices,
weights)`` (common/vecenv.py:141-152, algos_torch/self_play_manager.py).

- The learner sees the current player's (6, 7, 2) board planes (pettingzoo
  puts the own pieces in plane 0, so both seats share one network);
  ``get_action_masks()`` gives the legal columns (``use_action_masks``).
- The learner's seat alternates every episode, and each reset is seeded
  ``seed + i + 1000003 · episode`` (:113-127).
- The opponent moves a masked-categorical sample of the pushed policy (the
  argmax with ``deterministic_opponent``), batched over the envs of one
  weight version (:133-171); until the first push, a uniform legal column
  from ``np.random.default_rng(seed)``, drawn in the JAX package's order,
  so the games before a push are the JAX package's move for move.
- Same-step autoreset with ``infos['final_observation']``; rewards
  win +1 / loss -1 / draw 0 from pettingzoo's scoring.

The opponent's model is built from the training config's ``params``
(``network_params``) by the port's ModelBuilder on ``device`` (where the host
path puts the policy, ``common/host_inference.rollout_device``); a push
stores a copy of the learner's ``state_dict``, which the forward reads
through ``torch.func.functional_call``.
"""

from typing import Optional

import numpy as np
import torch

from rl_games_tpu_torch.envs.spaces import Box, Discrete, EnvInfo


class Connect4SelfPlayVecEnv:
    is_host_env = True
    autoreset_mode = "same_step"

    def __init__(self, num_actors: int, *, network_params: dict = None, seed: Optional[int] = None,
                 deterministic_opponent: bool = False, device=None, **_):
        from pettingzoo.classic import connect_four_v3

        self.num_envs = num_actors
        self.seed = seed
        self.deterministic_opponent = deterministic_opponent
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.envs = [connect_four_v3.env() for _ in range(num_actors)]
        self.ep_count = np.zeros(num_actors, np.int64)
        self.learner_seat = [None] * num_actors  # 'player_0' / 'player_1'
        self._obs = np.zeros((num_actors, 6, 7, 2), np.float32)
        self._masks = np.ones((num_actors, 7), np.bool_)
        # the opponents: a weight slot and its version per env (0: uniform legal moves)
        self._opp_weights = [None] * num_actors
        self._opp_version = np.zeros(num_actors, np.int64)
        self._next_version = 1
        self._network_params = network_params
        self._model = None
        self._rng = np.random.default_rng(seed)
        self._generator = None

    def _ensure_model(self):
        """The opponent's model, built at the first push's first move."""
        if self._model is not None:
            return
        from rl_games_tpu_torch.models import model_builder

        if self._network_params is None:
            raise ValueError("connect4 opponent needs env_config['network_params'] "
                             "(the training config's params dict) to build its policy")
        self._model = model_builder.ModelBuilder().load(
            self._network_params, actions_num=7, input_shape=(6, 7, 2), value_size=1,
            normalize_input=self._network_params["config"].get("normalize_input", False),
            normalize_value=False, obs_shape=(6, 7, 2), device=self.device,
        )
        self._generator = torch.Generator(device=self.device).manual_seed(0 if self.seed is None else self.seed)

    # -- per-env helpers ----------------------------------------------------
    def _observe(self, i):
        od = self.envs[i].observe(self.learner_seat[i])
        self._obs[i] = np.asarray(od["observation"], np.float32)
        self._masks[i] = np.asarray(od["action_mask"], bool)

    def _opponent_of(self, i):
        return "player_1" if self.learner_seat[i] == "player_0" else "player_0"

    def _reset_one(self, i):
        env = self.envs[i]
        env.reset(seed=None if self.seed is None else int(self.seed + i + 1000003 * self.ep_count[i]))
        self.learner_seat[i] = "player_0" if self.ep_count[i] % 2 == 0 else "player_1"
        self.ep_count[i] += 1
        if env.agent_selection != self.learner_seat[i]:
            self._opponent_move([i])  # the learner moves second: the opponent opens
        self._observe(i)

    def _random_action(self, mask):
        return int(self._rng.choice(np.nonzero(mask)[0]))

    @torch.no_grad()
    def _opponent_move(self, idxs):
        """Move the opponent seat in every env of ``idxs`` (live games waiting
        on the opponent), one batched forward per weight version."""
        by_version = {}
        for i in idxs:
            by_version.setdefault(int(self._opp_version[i]), []).append(i)
        for version, group in by_version.items():
            if version == 0:
                for i in group:
                    od = self.envs[i].observe(self._opponent_of(i))
                    self.envs[i].step(self._random_action(np.asarray(od["action_mask"], bool)))
                continue
            self._ensure_model()
            views = [self.envs[i].observe(self._opponent_of(i)) for i in group]
            obs = torch.as_tensor(np.stack([np.asarray(v["observation"], np.float32) for v in views]),
                                  device=self.device)
            masks = torch.as_tensor(np.stack([np.asarray(v["action_mask"], bool) for v in views]),
                                    device=self.device)
            res = torch.func.functional_call(
                self._model, self._opp_weights[group[0]], ("forward_play", obs),
                {"generator": self._generator, "action_masks": masks, "deterministic": self.deterministic_opponent})
            for i, a in zip(group, res["actions"].cpu().numpy()):
                self.envs[i].step(int(a))

    @staticmethod
    def _game_over(env):
        return not env.agents or all(env.terminations.values()) or all(env.truncations.values())

    # -- the vec-env surface ------------------------------------------------
    def get_env_info(self) -> EnvInfo:
        return EnvInfo(observation_space=Box(shape=(6, 7, 2), low=0.0, high=1.0), action_space=Discrete(n=7))

    def get_action_masks(self):
        return self._masks.copy()

    def reset(self):
        for i in range(self.num_envs):
            self._reset_one(i)
        return self._obs.copy()

    def step(self, actions):
        actions = np.asarray(actions).reshape(-1)
        rewards = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, bool)
        final_obs = np.array(self._obs, copy=True)

        # 1) the learner moves everywhere
        for i, env in enumerate(self.envs):
            env.step(int(actions[i]))
            if self._game_over(env):
                rewards[i] = float(env.rewards.get(self.learner_seat[i], 0.0))
                dones[i] = True

        # 2) the opponent answers in the live games, batched
        live = [i for i in range(self.num_envs) if not dones[i]]
        if live:
            self._opponent_move(live)
            for i in live:
                env = self.envs[i]
                if self._game_over(env):
                    rewards[i] = float(env.rewards.get(self.learner_seat[i], 0.0))
                    dones[i] = True

        # 3) observe, or autoreset
        for i in range(self.num_envs):
            if dones[i]:
                od = self.envs[i].observe(self.learner_seat[i])
                final_obs[i] = np.asarray(od["observation"], np.float32)
                self._reset_one(i)
            else:
                self._observe(i)

        infos = {"time_outs": np.zeros(self.num_envs, bool), "scores": rewards.copy()}
        if dones.any():
            infos["final_observation"] = final_obs
        return self._obs.copy(), rewards, dones, infos

    def set_weights(self, indices, weights):
        """The self-play manager's push (RayWorker.set_weights): a copy of
        the learner's ``state_dict`` becomes the opponent of the envs
        ``indices``, as one new version."""
        w = {k: v.detach().to(self.device).clone() for k, v in weights.items()}
        version = self._next_version
        self._next_version += 1
        for i in np.asarray(indices).reshape(-1):
            i = int(i) % self.num_envs
            self._opp_weights[i] = w
            self._opp_version[i] = version

    def close(self):
        for env in self.envs:
            env.close()
