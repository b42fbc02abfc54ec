"""Fused SOCKET paged decode attention: CUDA kernel ``paged_attention.cu``."""
