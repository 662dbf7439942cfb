"""The PyTorch port stands alone: no module of rl_games_tpu_torch and not
chip_smoke.py imports jax, flax, optax or the JAX package, and the port
builds a CPU PPOAgent in a process where importing jax fails."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rl_games_tpu"}
SOURCES = sorted((ROOT / "rl_games_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    """Top-level package names imported anywhere in the file."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_in_sources(path):
    # exact names: rl_games_tpu_torch shares rl_games_tpu's prefix
    assert not imported_roots(path) & FORBIDDEN


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'rl_games_tpu'):\n"
        "    sys.modules[name] = None  # any import of these now raises\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from rl_games_tpu_torch.algos.ppo import PPOAgent\n"
        "params = {'model': {'name': 'continuous_a2c_logstd'},\n"
        "  'network': {'name': 'actor_critic', 'mlp': {'units': [8], 'activation': 'elu'},\n"
        "              'space': {'continuous': {'fixed_sigma': True}}},\n"
        "  'config': {'env_name': 'Ant2D', 'num_actors': 2, 'horizon_length': 2,\n"
        "             'minibatch_size': 4, 'mini_epochs': 1, 'learning_rate': 3e-4,\n"
        "             'e_clip': 0.2, 'clip_value': True, 'gamma': 0.99, 'tau': 0.95,\n"
        "             'critic_coef': 2.0, 'entropy_coef': 0.0, 'grad_norm': 1.0,\n"
        "             'normalize_advantage': True, 'normalize_input': True}}\n"
        "agent = PPOAgent('iso', params, device='cpu')\n"
        "state, metrics = agent.train_epoch(agent.init_state())\n"
        "assert int(metrics['epoch']) == 1\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', 'rl_games_tpu')\n"
        "               for m, mod in sys.modules.items() if mod is not None)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
