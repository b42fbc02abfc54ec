"""SOCKET soft-collision scoring: CUDA kernel ``socket_score.cu``."""
