"""PyTorch / CUDA port of the ``repro`` package for one NVIDIA H100.

It mirrors ``repro`` file for file and imports neither ``jax`` nor
``repro``. Entry points run on the CUDA device unless the caller asks for
``device="cpu"``; on the CUDA device the MoE expert FFN and prefill
attention run hand-written Hopper kernels (``repro_torch.kernels``).
"""
