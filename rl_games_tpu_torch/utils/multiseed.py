"""Multi-seed training in one process, and the on-device population of PBT.

Port of rl_games_tpu/utils/multiseed.py. The JAX package stacks k train
states and runs ``jit(vmap(train_epoch))`` over them. Here the weights, the
normalizers and the central value and RND nets live in each agent's
modules, not in its train state, so the trainer keeps one agent per member,
built from the given agent's ``params``, and one train state per member; an
epoch runs each member's epoch in turn. No module, generator, env or
normalizer is shared between members, so member i trains exactly as a solo
agent seeded with ``seeds[i]`` would. The metrics of an epoch gain a
leading [k] axis, as the JAX package's do.

Device envs only (a host env steps outside the epoch function, as in the
JAX package); PPO and SAC (each SAC member keeps its own replay ring, so
device memory scales by k). ``state_for_seed`` returns one member's train
state, which that member's agent (``agents[i]``) checkpoints and the
standard player restores unchanged.

Over a data-parallel world (``make_train_fn(mesh=...)``, parallel/mesh.py)
whole members go to the ranks in contiguous blocks, the seed axis over
'data' as in the JAX package: a rank runs its members' epochs, with no
collective inside them, and the stacked metrics are gathered so that every
rank sees the single process's [k] metrics. The states of the other
ranks' members stay as they were given. Running the members' launches as
one stream (a grouped forward over k weight sets, GAE once at
[T, k * N, V]) is perf work for later; the members run one after another.
"""

import copy
import random
from typing import Sequence

import numpy as np
import torch

from rl_games_tpu_torch.parallel.mesh import LOCAL, broadcast_, gather_rows
from rl_games_tpu_torch.utils.pbt import classify, mutate_float


def stack_metrics(per_member: list):
    """The members' metrics dicts as one dict whose leaves gain a leading
    [k] axis: tensors stacked (on their device), Python numbers as a CPU
    tensor, nested dicts leaf by leaf."""
    first = per_member[0]
    if isinstance(first, dict):
        return {k: stack_metrics([m[k] for m in per_member]) for k in first}
    if torch.is_tensor(first):
        return torch.stack(per_member)
    return torch.tensor(per_member)


class MultiSeedTrainer:
    """k members of a device-env agent (PPO or SAC, any agent whose epoch is
    state -> (state, metrics)), one per seed."""

    def __init__(self, agent, seeds: Sequence[int]):
        if getattr(agent, "is_host_env", False):
            raise ValueError(
                "multi-seed training needs a device env; host envs step "
                "outside the epoch function (use one process per seed there, "
                "like the reference's benchmark harness)."
            )
        self.agent = agent
        self.seeds = list(seeds)
        if len(self.seeds) < 1:
            raise ValueError("need at least one seed")
        # the algo observer is the one object the members share: the copy
        # of the params keeps it as it is
        observer = (agent.config.get("features") or {}).get("observer")
        self.agents = [
            type(agent)(agent.base_name, copy.deepcopy(agent.full_params, {id(observer): observer}),
                        device=agent.device)
            for _ in self.seeds
        ]
        self._fn = None
        self.mesh = LOCAL  # the data-parallel world, once make_train_fn(mesh=) is given one

    def owner(self, index: int) -> int:
        """The rank that trains member ``index`` (0 in a single process)."""
        return index // (len(self.seeds) // self.mesh.size)

    def init_state(self) -> list:
        """Each member's train state; member i is seeded with ``seeds[i]``."""
        return [a.init_state(seed=s) for a, s in zip(self.agents, self.seeds)]

    def make_train_fn(self, mesh=None):
        """The epoch of every member, in turn: states -> (states, metrics)
        with each metric stacked on a leading [k] axis. With a ``mesh`` this
        rank runs its block of the members (``len(seeds)`` must divide by
        the world's size, else ValueError) and the metrics are gathered."""
        if mesh is not None:
            mesh.block(len(self.seeds), "the number of seeds")
            self.mesh = mesh
        fns = [a.make_train_fn() for a in self.agents]
        mine = [i for i in range(len(self.seeds)) if self.owner(i) == self.mesh.rank]

        def run(states):
            out, metrics = list(states), []
            for i in mine:
                out[i], m = fns[i](states[i])
                metrics.append(m)
            # every rank's members' metrics, concatenated on the seed axis
            return out, gather_rows(stack_metrics(metrics), self.mesh)

        return run

    def train_fn(self, mesh=None):
        if self._fn is None:
            self._fn = self.make_train_fn(mesh)
        return self._fn

    def epoch(self, states):
        """One epoch for every member; metrics leaves gain a [k] axis."""
        return self.train_fn()(states)

    def state_for_seed(self, states, index: int):
        """Member ``index``'s train state (a single-seed state of
        ``agents[index]``)."""
        return states[index]

    def frames_per_epoch(self) -> int:
        """One member's frames an epoch."""
        a = self.agent
        steps = getattr(a, "horizon_length", None) or getattr(a, "num_steps_per_episode", 1)
        return a.num_actors * getattr(a, "num_agents", 1) * steps


class PopulationTrainer(MultiSeedTrainer):
    """On-device population-based training: the population is the members.
    The reference's PBT (common/pbt/) coordinates N OS processes through
    checkpoint files and os.execv restarts; here exploit/explore works on
    the members in this process: a laggard (below the band rule,
    utils/pbt.classify) adopts a random leader's weights and normalizers
    (and its central value net's) with fresh Adam moments, and mutates the
    hyperparameters that live in the train state (lr, entropy_coef) with
    the reference's mutate_float steps (pbt/mutation.py:35-54). Its meters
    reset (clear_stats), so that the band re-evaluates on fresh games.
    """

    def __init__(self, agent, seeds: Sequence[int], *,
                 threshold_std: float = 0.10, threshold_abs: float = 0.05,
                 mutation_rate: float = 0.8,
                 change_range=(1.1, 1.5)):
        super().__init__(agent, seeds)
        self.threshold_std = float(threshold_std)
        self.threshold_abs = float(threshold_abs)
        self.mutation_rate = float(mutation_rate)
        self.change_range = tuple(change_range)

    def _maybe_mutate(self, value: float) -> float:
        if random.random() > self.mutation_rate:
            return value
        return mutate_float(value, *self.change_range)

    def pbt_step(self, states, metrics):
        """One exploit/explore pass over ``metrics`` on the host (numpy,
        each leaf [k, ...]). Updates the laggards' agents and states in
        place and returns (states, events); events is a list of
        {'dst', 'src', 'lr', 'entropy_coef'} adoption records, by seed.
        What the JAX package leaves alone stays: RND's nets and optimizer,
        adv_rms, the recurrent states and the env state."""
        games = metrics.get("games_played")
        scores = np.asarray(metrics["mean_rewards"])[:, 0]
        if games is not None and (np.asarray(games) <= 0).any():
            return states, []  # some member has no completed games
        leader_cut, laggard_cut = classify(scores, self.threshold_std, self.threshold_abs)
        leaders = np.where(scores >= leader_cut)[0]
        laggards = np.where(scores <= laggard_cut)[0]
        if len(leaders) == 0 or len(laggards) == 0:
            return states, []
        events = []
        for dst in laggards.tolist():
            src = int(random.choice(leaders.tolist()))
            donor, adopter, member = self.agents[src], self.agents[dst], states[dst]
            # the leader's weights, lr and entropy_coef travel from its rank
            # to every rank; every rank draws the mutations, so that Python's
            # random stream stays the same on all of them
            self._broadcast_member(src, states)
            f32 = dict(dtype=torch.float32, device=adopter.device)
            # mutated from the leader's values, rounded to float32 as the
            # JAX package's jnp.asarray(..., float32) rounds them
            lr = torch.tensor(self._maybe_mutate(float(states[src].lr)), **f32)
            entropy_coef = torch.tensor(self._maybe_mutate(float(states[src].entropy_coef)), **f32)
            if self.owner(dst) == self.mesh.rank:
                adopter.model.load_state_dict(donor.model.state_dict())
                if adopter.has_central_value:
                    adopter.cv_model.load_state_dict(donor.cv_model.state_dict())
                member = adopter.reset_optimizer(member)  # both nets' moments
                member.lr, member.entropy_coef = lr, entropy_coef
                states[dst] = adopter.clear_stats(member)
            events.append({"dst": self.seeds[dst], "src": self.seeds[src],
                           "lr": float(lr), "entropy_coef": float(entropy_coef)})
        return states, events

    def _broadcast_member(self, src: int, states):
        """Member ``src``'s weights (and its central value net's), lr and
        entropy_coef from the rank that trains it into every rank's copy."""
        agent = self.agents[src]
        tensors = [*agent.model.state_dict().values()]
        if agent.has_central_value:
            tensors += [*agent.cv_model.state_dict().values()]
        states[src].lr, states[src].entropy_coef = states[src].lr.clone(), states[src].entropy_coef.clone()
        broadcast_(tensors + [states[src].lr, states[src].entropy_coef], self.owner(src), self.mesh)
