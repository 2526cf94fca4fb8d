"""The benchmark of the PyTorch + CUDA port (``end_to_end_asr_pytorch_tpu_torch``): see README.md."""
