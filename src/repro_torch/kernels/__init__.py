"""Hand-written CUDA kernels for the aggregation hot path, each with its
plain PyTorch version beside it."""
