"""Hand-written CUDA kernels, their plain twins and the split compositions."""
