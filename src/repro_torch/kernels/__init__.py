"""Hand-written CUDA kernels for the hot spots of the port, each with a
plain PyTorch version beside it (`ref.py`) that CPU tensors run."""
