"""Temperature + nucleus (top-p) sampling for the continuous engine.

Port of ``repro.serving.sampling``.  Greedy (``temperature == 0``) stays
``torch.argmax`` in the engine, bit for bit the pre-sampling engine.

The JAX sampler draws with ``jax.random.categorical`` from threefry keys,
whose bits torch cannot reproduce.  So the port splits the sampler from
its noise (a difference by design):

* :func:`sample_tokens` is a pure function of the logits and one row of
  standard Gumbel noise per logits row.  It applies the JAX semantics
  exactly — padded-vocab ids masked to ``-1e30``, logits divided by the
  temperature, the top-p keep ``(cumsum - p) < top_p`` over the sorted
  softmax with every exact tie at the cutoff logit kept — and returns
  ``argmax(logits + gumbel)``, which is what ``categorical`` computes
  (the Gumbel-max trick).  Fed JAX's own Gumbel noise for the same keys,
  it gives JAX's tokens.
* :class:`GumbelStream` is a request's noise: an explicit
  ``torch.Generator`` on the engine's device, seeded from ``(seed,
  submission index)`` at first submission.  The engine restarts it at
  every admission and draws once for each token the request's slot
  consumes (replayed tokens after a preemption included), so the draw for
  token ``t`` is a pure function of (seed, submission index, t): batch
  composition and preemption cannot change it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["NEG_INF", "sample_tokens", "gumbel_noise", "stream_seed",
           "GumbelStream"]

NEG_INF = -1e30


def sample_tokens(logits: torch.Tensor, gumbel: torch.Tensor, *,
                  temperature: float, top_p: float,
                  vocab_size: int) -> torch.Tensor:
    """One token per row of ``logits`` (B, V), with standard Gumbel noise
    ``gumbel`` (B, V).  Ids at or past ``vocab_size`` (the padded vocab
    tail) are never drawn.  ``top_p`` keeps the smallest prefix of the
    sorted distribution whose mass reaches ``top_p`` (the top token is
    always kept; exact ties at the cutoff logit are all kept).  Returns
    (B,) int64."""
    assert temperature > 0.0, "temperature 0 is greedy — use argmax"
    logits = logits.float()
    v = logits.shape[-1]
    if vocab_size < v:
        pad = torch.arange(v, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        keep = (csum - probs) < top_p           # mass strictly before token
        cutoff = torch.where(keep, sorted_l, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits, NEG_INF)
    return torch.argmax(logits + gumbel.float(), dim=-1)


def gumbel_noise(uniform: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in [0, 1), as
    ``jax.random.gumbel`` forms it: ``-log(-log(u))`` with ``u`` clamped
    up to the smallest normal float32."""
    u = uniform.float().clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def stream_seed(seed: int, submission: int) -> int:
    """The 64-bit generator seed of the request submitted ``submission``-th
    to an engine seeded with ``seed``."""
    mask = (1 << 64) - 1
    ss = np.random.SeedSequence([seed & mask, submission & mask])
    return int(ss.generate_state(1, np.uint64)[0])


class GumbelStream:
    """One request's sampling noise (see the module docstring).

    ``draws`` counts the draws since the latest :meth:`restart`, so the
    draw for the request's token ``t`` has index ``t``; ``emitted`` holds,
    for each token the request emitted, the index of the draw it was
    sampled with (the engine appends it).  A subclass may override
    :meth:`noise` (tests feed the JAX package's key chain through it)."""

    def __init__(self, seed: int, submission: int, device):
        self.submission = submission
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(stream_seed(seed, submission))
        self._start = self.generator.get_state()
        self.draws = 0
        self.emitted: List[int] = []

    def restart(self) -> None:
        """Back to the first draw (at every admission)."""
        self.generator.set_state(self._start)
        self.draws = 0

    def draw(self, n: int) -> torch.Tensor:
        """The next draw: (n,) float32 Gumbel noise."""
        t, self.draws = self.draws, self.draws + 1
        return self.noise(t, n)

    def noise(self, t: int, n: int) -> torch.Tensor:
        """Draw ``t`` of the stream; the generator's next uniforms."""
        return gumbel_noise(torch.rand(n, generator=self.generator,
                                       device=self.generator.device))
