"""The PyTorch port stands alone: no module of rl_games_tpu_torch and not
chip_smoke.py imports jax, flax, optax or the JAX package, and the port
trains, checkpoints and plays a fused-MLP policy, and a config whose
import_modules names the JAX package's test network, through its Runner on
the CPU in a process where importing jax fails. Importing the port, its host
envs' bridges included, needs none of gymnasium, dm_control and pettingzoo: only the
modules that step their envs import them, when they are used."""

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


def test_port_runs_with_jax_blocked(tmp_path):
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'rl_games_tpu'):\n"
        "    sys.modules[name] = None  # any import of these now raises\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import rl_games_tpu_torch.__main__\n"
        "from rl_games_tpu_torch.runner import Runner\n"
        "params = {'algo': {'name': 'a2c_continuous'}, 'model': {'name': 'continuous_a2c_logstd'},\n"
        "  'network': {'name': 'actor_critic', 'mlp': {'units': [8], 'activation': 'elu', 'fused': True},\n"
        "              'space': {'continuous': {'fixed_sigma': True}}},\n"
        "  'config': {'env_name': 'Ant2D', 'num_actors': 2, 'horizon_length': 2,\n"
        "             'minibatch_size': 4, 'mini_epochs': 1, 'learning_rate': 3e-4,\n"
        "             'e_clip': 0.2, 'clip_value': True, 'gamma': 0.99, 'tau': 0.95,\n"
        "             'critic_coef': 2.0, 'entropy_coef': 0.0, 'grad_norm': 1.0,\n"
        "             'normalize_advantage': True, 'normalize_input': True,\n"
        "             'name': 'iso', 'train_dir': sys.argv[1], 'max_epochs': 1,\n"
        "             'player': {'games_num': 2, 'max_steps': 3}}}\n"
        "runner = Runner(device='cpu')\n"
        "runner.load({'params': params})\n"
        "assert runner.run({'train': True})[1] == 1\n"
        "runner.run({'play': True, 'checkpoint': sys.argv[1] + '/iso/nn/last_iso_ep_1_rew_0.00.pth'})\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', 'rl_games_tpu')\n"
        "               for m, mod in sys.modules.items() if mod is not None)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_testnet_config_runs_with_jax_blocked(tmp_path):
    """ref/test/test_discrite_testnet_aux_loss.yaml, whose import_modules
    names rl_games_tpu.models.test_network, trains 2 epochs and plays
    through Runner.run in a process where importing jax, flax, optax or
    rl_games_tpu fails: the name maps to the port's module. The connect4
    self-play config's network module (rl_games_tpu.models.connect4_network)
    maps to the port's as well and registers connect4net; the config, shrunk
    to 2 envs x 8, trains an epoch over its connect-four env, again without
    importing the JAX package."""
    code = (
        "import sys, glob, yaml\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'rl_games_tpu'):\n"
        "    sys.modules[name] = None  # any import of these now raises\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from rl_games_tpu_torch.runner import Runner\n"
        "doc = yaml.safe_load(open('rl_games_tpu/configs/ref/test/test_discrite_testnet_aux_loss.yaml'))\n"
        "doc['params']['config'].update(num_actors=4, horizon_length=8, minibatch_size=16, mini_epochs=1,\n"
        "    max_epochs=2, train_dir=sys.argv[1], print_stats=False, player={'games_num': 2, 'deterministic': True})\n"
        "runner = Runner(device='cpu')\n"
        "runner.load(doc)\n"
        "assert runner.run({'train': True})[1] == 2\n"
        "ckpt = glob.glob(sys.argv[1] + '/test_md_multi_obs/nn/last_*_ep_2_rew_*.pth')[0]\n"
        "runner.run({'play': True, 'checkpoint': ckpt})\n"
        "doc = yaml.safe_load(open('rl_games_tpu/configs/ref/ma/ppo_connect4_self_play_resnet.yaml'))\n"
        "runner = Runner(device='cpu')\n"
        "runner.load(doc)\n"
        "from rl_games_tpu_torch.models.model_builder import NETWORK_REGISTRY\n"
        "assert NETWORK_REGISTRY['connect4net'].__module__ == 'rl_games_tpu_torch.models.connect4_network'\n"
        "runner.params['config'].update(num_actors=2, horizon_length=8, minibatch_size=16, mini_epochs=1)\n"
        "agent = runner.create_agent()\n"
        "state, metrics = agent.make_train_fn()(agent.init_state())\n"
        "assert torch.isfinite(metrics['a_loss']) and type(agent.vec_env).__name__ == 'Connect4SelfPlayVecEnv'\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', 'rl_games_tpu')\n"
        "               for m, mod in sys.modules.items() if mod is not None)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_host_modules_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"rl_games_tpu_torch/envs/host/{m}.py" for m in ("cpuenv", "gymnasium_env", "wrappers",
                                                           "dm_control_env", "connect4_env", "pettingzoo_env")} <= names
    # the self-play and multi-agent modules
    assert {"rl_games_tpu_torch/envs/device/selfplay.py", "rl_games_tpu_torch/envs/device/multiagent.py",
            "rl_games_tpu_torch/utils/self_play.py"} <= names
    assert {"rl_games_tpu_torch/common/host_inference.py", "rl_games_tpu_torch/utils/native_build.py"} <= names


def test_port_import_needs_neither_gymnasium_nor_dm_control():
    code = (
        "import sys\n"
        "for name in ('gymnasium', 'dm_control', 'pettingzoo'):\n"
        "    sys.modules[name] = None  # any import of these now raises\n"
        "import rl_games_tpu_torch, rl_games_tpu_torch.__main__, rl_games_tpu_torch.runner\n"
        "import rl_games_tpu_torch.algos.ppo, rl_games_tpu_torch.algos.sac, rl_games_tpu_torch.common.player\n"
        "import rl_games_tpu_torch.envs.registry, rl_games_tpu_torch.common.host_inference\n"
        "import rl_games_tpu_torch.envs.host.cpuenv, rl_games_tpu_torch.envs.host.gymnasium_env\n"
        "import rl_games_tpu_torch.envs.host.connect4_env, rl_games_tpu_torch.envs.host.pettingzoo_env\n"
        "import rl_games_tpu_torch.envs.device.selfplay, rl_games_tpu_torch.utils.self_play\n"
        "import chip_smoke\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
