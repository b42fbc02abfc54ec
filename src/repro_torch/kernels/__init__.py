"""Hand-written Hopper kernels, each package with a plain PyTorch version
(``ref.py``), the kernel source and a wrapper (``ops.py``) that runs the
plain version on CPU tensors and the kernel on CUDA tensors:
``socket_score`` (CUDA), ``flash_decode`` (Triton), ``flash_prefill``
(CUDA) and ``paged_attention`` (CUDA: SOCKET, hard LSH, Quest, ring)."""

__all__ = ["socket_score", "flash_decode", "flash_prefill",
           "paged_attention"]
