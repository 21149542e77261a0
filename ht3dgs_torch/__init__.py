"""ht3dgs in PyTorch for one NVIDIA H100.

The counterpart of the JAX package `ht3dgs`, module for module, with the
same layouts (fixed capacity plus `live` mask, quats `[x, y, z, w]`, packed
entry rows `[T, K, 16]`) so the two can be held against each other. The
per-tile alpha blend, forward and backward, runs as hand-written CUDA
kernels (`csrc/`) on a CUDA tensor and as plain PyTorch on a CPU tensor.

Entry points take a `device` argument that defaults to "cuda".
"""
