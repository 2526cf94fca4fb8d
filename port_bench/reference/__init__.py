"""The plain reference: plain PyTorch, float32 with TF32 off, nothing of the program."""
