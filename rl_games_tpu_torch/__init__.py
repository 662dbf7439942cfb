"""rl_games_tpu_torch — the PyTorch/CUDA port of rl_games_tpu.

The package mirrors the JAX package's layout module for module, so each
piece's counterpart sits at the same path (the device envs live under
``envs/device/`` instead of ``envs/jax/``). The JAX package stays the
reference the port is tested against; nothing here imports it or JAX.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``. Every TPU kernel on a ported path is a hand-written CUDA
kernel under ``csrc/``, built at first use with ``nvcc`` into ``build/``
(``utils/cuda_build.py``); on CPU tensors each kernel's plain PyTorch
version runs instead.
"""

__version__ = "0.1.0"
