"""Count the top-level torch ops of the port's hot loops on the CPU.

    python3 tools/torch_op_count.py

For DevicePong, DeviceBreakout, PixelCatcher and CartPole: one vec-env
step at 64 envs; for ppo_pong_device.yaml, ppo_breakout_device.yaml (cut to
16 envs, horizon 8, minibatch 32) and ppo_cartpole.yaml: the policy
forward, one rollout (and its mean per step) and one minibatch step (loss,
backward, clip, Adam, scheduler); for the flagship (chip_smoke.py's, cut to
64 envs): one rollout and one whole epoch; for sac_ant2d.yaml (cut to 16 envs,
batch 64, ring 4096): one env step during warmup and after it, one update
with the actor step and one without. Each op on the host is a kernel launch
on a card, so the counts predict the host's share of a step; they are
counts, not times, and need no card.
"""

import os
import sys

import torch
import yaml
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rl_games_tpu_torch.algos.ppo import PPOAgent, adam_step  # noqa: E402
from rl_games_tpu_torch.algos.sac import SACAgent  # noqa: E402
from rl_games_tpu_torch.envs import registry  # noqa: E402

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rl_games_tpu", "configs")


def top_level_ops(fn) -> int:
    """Ops recorded at the top of the call tree in one call of fn (after a warm-up)."""
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.cpu_parent is None)


def main():
    torch.set_num_threads(1)
    for name in ("DevicePong-v0", "DeviceBreakout-v0", "PixelCatcher-v0", "CartPole-v1"):
        vec = registry.create_vec_env(name, 64, device="cpu")
        state, _ = vec.reset(torch.Generator().manual_seed(0))
        actions = torch.ones(64, dtype=torch.int64)
        print(f"{name}: {top_level_ops(lambda: vec.step(state, actions))} ops per vec-env step")
    for config, cut in (("ppo_pong_device.yaml", dict(num_actors=16, horizon_length=8, minibatch_size=32)),
                        ("ppo_breakout_device.yaml", dict(num_actors=16, horizon_length=8, minibatch_size=32)),
                        ("ppo_cartpole.yaml", {})):
        with open(os.path.join(CONFIGS, config)) as f:
            params = yaml.safe_load(f)["params"]
        params["config"].update(cut)
        agent = PPOAgent("count", params, device="cpu")
        state = agent.init_state()
        with torch.no_grad():
            forward = top_level_ops(lambda: agent.model.forward_play(state.obs, generator=state.generator))
        rollout = top_level_ops(lambda: agent._rollout(state))
        dataset = agent._prepare_dataset(state, *agent._rollout(state))
        mb = {k: v[:agent.minibatch_size] for k, v in dataset.items()}

        def minibatch_step():
            total, aux = agent._loss_and_kl(mb, state.entropy_coef)
            grads = torch.autograd.grad(total, agent.params)
            adam_step(agent.params, grads, state.opt_state, state.lr, agent.grad_norm)
            agent.scheduler.update(state.lr, state.entropy_coef, state.epoch, state.frame, aux["kl"])

        print(f"{config}: policy forward {forward} ops, rollout {rollout} ops "
              f"({rollout / agent.horizon_length:.1f} per step), minibatch step {top_level_ops(minibatch_step)} ops")

    # the flagship (chip_smoke.flagship_params: Ant2D, horizon 16), cut to 64 envs
    from chip_smoke import flagship_params

    agent = PPOAgent("count", flagship_params(64), device="cpu")
    state = agent.init_state()
    rollout = top_level_ops(lambda: agent._rollout(state))
    epoch = top_level_ops(lambda: agent.train_epoch(state))
    print(f"flagship: rollout {rollout} ops ({rollout / agent.horizon_length:.1f} per step), "
          f"epoch {epoch} ops")

    with open(os.path.join(CONFIGS, "sac_ant2d.yaml")) as f:
        params = yaml.safe_load(f)["params"]
    params["config"].update(num_actors=16, batch_size=64, replay_buffer_size=4096)
    agent = SACAgent("count", params, device="cpu")
    state = agent.init_state()
    for _ in range(8):  # rows for the updates to sample
        agent._env_step(state, True)
    steps = {warmup: top_level_ops(lambda: agent._env_step(state, warmup)) for warmup in (True, False)}

    def update(with_actor):
        state.update_counter = 1 if with_actor else 0  # policy_frequency 2: the actor runs at 2
        agent._update(state)

    updates = {with_actor: top_level_ops(lambda: update(with_actor)) for with_actor in (True, False)}
    print(f"sac_ant2d.yaml: env step {steps[True]} ops during warmup, {steps[False]} after it; "
          f"update {updates[True]} ops with the actor step, {updates[False]} without")


if __name__ == "__main__":
    main()
