"""Flash decode over the selected KV subset: CUDA kernel."""
