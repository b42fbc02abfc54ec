"""Hand-written Hopper kernels, each package with a plain PyTorch version
(``ref.py``), the kernel source and a wrapper (``ops.py``) that runs the
plain version on CPU tensors and the kernel on CUDA tensors:
``socket_score``, ``flash_decode``, ``flash_prefill`` and
``paged_attention`` (SOCKET, hard LSH, Quest, ring), all CUDA."""

__all__ = ["socket_score", "flash_decode", "flash_prefill",
           "paged_attention"]
