"""Flash decode over the selected KV subset: Triton kernel."""
