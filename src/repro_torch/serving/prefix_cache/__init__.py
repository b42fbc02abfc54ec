"""Cross-request KV prefix reuse: radix-indexed, refcounted, copy-on-write.

Copies of ``repro.serving.prefix_cache``; see
:mod:`repro_torch.serving.prefix_cache.cache` for the subsystem contract.
"""

from repro_torch.serving.prefix_cache.cache import PrefixCache
from repro_torch.serving.prefix_cache.radix import RadixIndex
from repro_torch.serving.prefix_cache.workloads import (chatbot_prompts,
                                                        rag_prompts)

__all__ = ["PrefixCache", "RadixIndex", "chatbot_prompts", "rag_prompts"]
