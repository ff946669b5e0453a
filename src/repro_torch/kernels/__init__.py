"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; ``build`` compiles ``repro_torch/csrc`` at first use."""
