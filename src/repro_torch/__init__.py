"""PyTorch port of the Hybrid LLM routing and serving system, for one NVIDIA
H100. It mirrors the layout of the JAX package ``repro`` module for module,
imports neither JAX nor ``repro``, and runs its paged attention in CUDA
kernels written for Hopper (``csrc/``). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``."""
