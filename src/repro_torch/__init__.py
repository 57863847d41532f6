"""PyTorch/CUDA port of the DB-PIM reproduction.

Mirrors the JAX package ``repro`` module for module
(``repro/X/Y.py`` -> ``repro_torch/X/Y.py``) and imports neither ``jax``
nor anything of ``repro``. Params are nested dicts with the same keys and
layouts as the JAX params; the one TPU kernel on the serving path,
``joint_sparse_matmul``, is a hand-written CUDA kernel
(``kernels/csrc/joint_sparse_matmul.cu``) with a plain PyTorch twin.
"""
