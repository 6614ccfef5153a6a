"""The three kernels of the main path, each with its plain PyTorch version."""
