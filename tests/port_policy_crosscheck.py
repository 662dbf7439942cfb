"""Play one policy trained by the port in the port's env and in the JAX
package's env, from the same start states, and compare the episode returns.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port_policy_crosscheck.py \
        rl_games_tpu/configs/ppo_ant3d.yaml runs/ant3d_ppo/nn/ant3d_ppo.pth

A tool beside the parity tests (pytest does not collect it): the tests hold
one control step of each env to the JAX package; this holds whole episodes
of a trained gait. Both envs run on the CPU in float32 with the checkpoint's
deterministic (mean) actions for up to one episode per env; each env's
return counts its rewards up to its first termination. The dynamics are
chaotic over hundreds of contact steps, so single trajectories part; the
two distributions of returns should not.
"""

import argparse

import jax
import numpy as np
import torch
import yaml

from rl_games_tpu.envs.jax import ant3d as jant
from rl_games_tpu.envs.jax import humanoid3d as jhum
from rl_games_tpu_torch.common.player import PpoPlayer
from rl_games_tpu_torch.envs.device import ant3d as tant
from rl_games_tpu_torch.envs.device import humanoid3d as thum

# env name: (JAX env class, JAX state class, port env class)
ENVS = {
    "Ant3D": (jant.Ant3D, jant.Ant3DState, tant.Ant3D),
    "Humanoid3D": (jhum.Humanoid3D, jhum.Humanoid3DState, thum.Humanoid3D),
}


def episode_returns(step, state, obs, x0, act, steps):
    """Returns up to each env's first termination, the step it ended at
    (``steps`` when it did not) and the torso's x travel until then."""
    n = obs.shape[0]
    total, ended = np.zeros(n), np.full(n, steps)
    alive = np.ones(n, dtype=bool)
    x_end = x0
    for i in range(steps):
        state, obs, reward, done, x = step(state, act(obs))
        x_end = np.where(alive, x, x_end)
        total += np.where(alive, reward, 0.0)
        ended = np.where(alive & done, i + 1, ended)
        alive &= ~done
    return total, ended, x_end - x0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(4)

    with open(args.config) as f:
        params = yaml.safe_load(f)["params"]
    config = params["config"]
    config["player"] = {**(config.get("player") or {}), "num_actors": args.envs, "deterministic": True}
    player = PpoPlayer(params, device="cpu")
    player.restore(args.checkpoint)
    jcls, jstate_cls, tcls = ENVS[config["env_name"]]

    @torch.no_grad()
    def act(obs):
        return player._play_actions(None, torch.as_tensor(np.array(obs), dtype=torch.float32))

    tenv, jenv = tcls(device="cpu"), jcls()
    tstate, tobs = tenv.reset(args.envs, torch.Generator().manual_seed(args.seed))
    start = {f: getattr(tstate, f).numpy() for f in ("q", "qd", "last_x")}

    def port_step(state, action):
        state, obs, reward, done, _ = tenv.step(state, action)
        return state, obs, reward.numpy(), done.numpy(), state.q[:, 0].numpy()

    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, None)))
    key = jax.random.PRNGKey(0)
    jstate = jstate_cls(**{f: jax.numpy.asarray(v) for f, v in start.items()})
    jobs = jax.vmap(jenv._obs)(jstate)
    np.testing.assert_allclose(np.asarray(jobs), tobs.numpy(), rtol=1e-5, atol=1e-5)

    def jax_step(state, action):
        state, obs, reward, done, _ = jstep(state, jax.numpy.asarray(action.numpy()), key)
        return state, obs, np.asarray(reward), np.asarray(done), np.asarray(state.q[:, 0])

    rows = {}
    for name, step, state, obs in (("port", port_step, tstate, tobs), ("jax", jax_step, jstate, jobs)):
        total, ended, travel = episode_returns(step, state, obs, start["q"][:, 0], act, args.steps)
        rows[name] = total
        print(f"[{name}] {config['env_name']} {args.envs} envs, {args.steps} steps, deterministic: return "
              f"mean {total.mean():.2f} (std {total.std():.2f}, min {total.min():.2f}, max {total.max():.2f}); "
              f"terminated {int((ended < args.steps).sum())}; mean x travel {travel.mean():.3f}, "
              f"mean episode length {ended.mean():.1f}")
    diff = rows["port"].mean() - rows["jax"].mean()
    se = np.sqrt((rows["port"].var() + rows["jax"].var()) / args.envs)
    print(f"[compare] port - jax mean return {diff:.2f} ({diff / max(se, 1e-9):.2f} standard errors)")


if __name__ == "__main__":
    main()
