"""Hand-written CUDA kernels and the scalar L-BFGS machinery."""
