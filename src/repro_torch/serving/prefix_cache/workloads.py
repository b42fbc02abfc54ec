"""Synthetic high-prefix-overlap workloads for the prefix cache.

A copy of ``repro.serving.prefix_cache.workloads`` (numpy only): the same
seed gives the same token lists.

Two generators modeling the traffic patterns where cross-request reuse
pays (both deterministic given a seed, emitting token-id lists directly —
the engine is tokenizer-free):

* **chatbot** — multi-turn sessions: every session shares one system
  prompt, and turn ``t``'s prompt is the full conversation so far plus a
  new user turn, so consecutive turns overlap on everything but the new
  turn.  Requests are submitted in round-robin turn order (turn 0 of all
  sessions, then turn 1, ...), the order a live chat service sees.
* **rag** — shared-template retrieval: every request starts with the same
  ``overlap``-fraction template (system prompt + retrieval scaffold) and
  ends with a unique query/context, giving a directly tunable overlap
  knob for benchmarking hit-rate vs TTFT curves.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["chatbot_prompts", "rag_prompts"]


def _tokens(rng: np.random.Generator, n: int, vocab_size: int) -> List[int]:
    return rng.integers(0, vocab_size, size=n).tolist()


def chatbot_prompts(num_requests: int, *, sessions: int = 2,
                    system_len: int = 16, turn_len: int = 12,
                    max_prompt_len: int = 0, vocab_size: int = 256,
                    seed: int = 0) -> List[List[int]]:
    """Multi-turn chat prompts (see module docstring).  ``max_prompt_len``
    > 0 truncates long conversations keep-first, which preserves the
    shared prefix (late turns of a long session degenerate to identical
    prompts — still realistic cache traffic)."""
    rng = np.random.default_rng(seed)
    system = _tokens(rng, system_len, vocab_size)
    histories = [list(system) for _ in range(sessions)]
    turns = -(-num_requests // sessions)
    prompts: List[List[int]] = []
    for _ in range(turns):
        for s in range(sessions):
            if len(prompts) >= num_requests:
                break
            histories[s] = histories[s] + _tokens(rng, turn_len, vocab_size)
            prompt = histories[s]
            if max_prompt_len > 0:
                prompt = prompt[:max_prompt_len]
            prompts.append(list(prompt))
    return prompts


def rag_prompts(num_requests: int, *, prompt_len: int = 48,
                overlap: float = 0.6, vocab_size: int = 256,
                seed: int = 0) -> List[List[int]]:
    """Shared-template prompts: the first ``round(overlap * prompt_len)``
    tokens are identical across requests, the rest unique per request."""
    if not 0.0 <= overlap <= 1.0:
        raise ValueError(f"overlap must be in [0, 1], got {overlap}")
    rng = np.random.default_rng(seed)
    shared_len = int(round(overlap * prompt_len))
    template = _tokens(rng, shared_len, vocab_size)
    return [template + _tokens(rng, prompt_len - shared_len, vocab_size)
            for _ in range(num_requests)]
