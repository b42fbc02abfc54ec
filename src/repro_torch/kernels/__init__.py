"""Hand-written Hopper kernels, each package with a plain PyTorch version
(``ref.py``), the kernel source and a wrapper (``ops.py``) that runs the
plain version on CPU tensors and the kernel on CUDA tensors."""
