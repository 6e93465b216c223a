"""Hand-written CUDA kernels (csrc/*.cu), their wrappers, plain versions and build."""
