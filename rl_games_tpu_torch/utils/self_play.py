"""Self-play manager.

Port of rl_games_tpu/utils/self_play.py (:12-64; the reference's
algos_torch/self_play_manager.py:3-32): once the agent's recent mean reward
(or score, ``check_scores``) beats ``update_score`` over at least
``games_to_check`` games, the learner's weights go into the opponents of
``env_update_num`` envs, which then rotate by one env, and the caller
clears the episode stats.

A device self-play env (``envs/device/selfplay.SelfPlayVecEnv``) keeps its
opponents in the train state's env state, so a push returns a new env
state; a host env (``envs/host/connect4_env``) keeps them itself. The
protocol follows the env's kind (``is_host_env``).
"""

import numpy as np


class SelfPlayManager:
    def __init__(self, config: dict, writer=None):
        self.config = config
        self.writer = writer
        self.update_score = config["update_score"]
        self.games_to_check = config["games_to_check"]
        self.check_scores = config.get("check_scores", False)
        self.env_update_num = config.get("env_update_num", 1)
        self.env_indexes = np.arange(self.env_update_num)
        self.updates_num = 0

    def update(self, algo, state, metrics):
        """Returns (pushed, state): whether the weights were pushed (the
        stats are then to be cleared), and the train state, whose env
        state a device env's push replaces."""
        self.updates_num += 1
        key = "mean_scores" if self.check_scores else "mean_rewards"
        games = int(metrics.get("games_played", 0))
        if games < self.games_to_check:
            return False, state
        value = metrics.get(key)
        if value is None:
            return False, state
        mean_score = float(np.asarray(value).reshape(-1)[0])
        if mean_score <= self.update_score:
            return False, state
        print(f"self-play: mean {key} {mean_score:.3f} > {self.update_score} — updating opponent weights")
        if self.writer is not None:
            self.writer.add_scalar("selfplay/iters_update_weigths", self.updates_num, int(metrics["frame"]))
        weights = algo.get_weights()
        if getattr(algo.vec_env, "is_host_env", False):
            # the env owns its opponents (RayWorker.set_weights, common/vecenv.py:141-152)
            algo.vec_env.set_weights(self.env_indexes, weights)
        else:
            state.env_state = algo.vec_env.set_weights(self.env_indexes, weights, env_state=state.env_state)
        self.env_indexes = (self.env_indexes + 1) % algo.num_actors
        self.updates_num = 0
        return True, state
