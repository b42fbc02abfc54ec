"""Causal (sliding-window) flash-attention prefill: CUDA kernel
``flash_prefill.cu``."""
