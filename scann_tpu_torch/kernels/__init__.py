"""Hand-written CUDA kernels of the PyTorch port and their wrappers."""
