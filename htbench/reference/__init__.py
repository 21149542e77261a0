"""The plain reference the benchmark holds the port to.

Plain PyTorch (and NumPy, and SciPy's KD-tree for the init sizes) written
from the published 3D Gaussian splatting method and the trainer's recipe:
no kernel, no fixed capacity, no entry lists of the port. It imports
neither `jax` nor the JAX package nor anything of `ht3dgs_torch`, and it
takes nothing the port computed: it makes its own models from the frames
and depths the benchmark made, and its own tile lists, images, losses,
gradients and Adam steps.
"""
