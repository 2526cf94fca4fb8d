"""PyTorch + CUDA port of the end-to-end ASR system (serving path).

The JAX package ``end_to_end_asr_pytorch_tpu`` is the reference this package
is held against; nothing here imports it or JAX. Module paths mirror the
JAX package (``models/attention.py`` here is the counterpart of
``models/attention.py`` there). Hand-written Hopper kernels live in
``csrc/`` and are bound in ``ops/cuda/``; each has a plain PyTorch version
beside it that CPU tensors take.
"""
