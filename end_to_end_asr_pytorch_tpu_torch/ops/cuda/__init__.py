"""Hand-written Hopper kernels (sources in ``csrc/``) and their wrappers.

Each wrapper runs its kernel's plain PyTorch version for a CPU tensor and
launches the kernel (or raises) for a CUDA tensor. ``USE_KERNELS = False``
makes the callers in ``ops/`` route CUDA tensors to the plain versions
instead; it exists so one run on the card can be compared with the other.
"""
USE_KERNELS = True
