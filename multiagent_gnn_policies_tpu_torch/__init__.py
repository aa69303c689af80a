"""PyTorch/CUDA port of ``multiagent_gnn_policies_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package so each counterpart is easy to find.
The port imports ``torch`` and never ``jax`` or the JAX package; the three
cell-sweep kernels live in ``csrc/cells.cu`` and are built with ``nvcc`` on
first use (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version.
"""
