"""PyTorch/CUDA port of the SOCKET serving system (``repro``) for NVIDIA
Hopper.  It imports ``torch``, never ``jax``, and nothing of the JAX
package; see README.md for what is ported and how it is checked."""
