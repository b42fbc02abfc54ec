"""Deterministic, resumable, host-sharded LM data pipeline.

A copy of ``repro.data.pipeline`` (numpy only; the port imports nothing
of the JAX package): its batches equal the JAX package's bit for bit.
The loader yields numpy batches; the train loop moves them to the card.

Two sources behind one iterator interface:

* :class:`SyntheticLMSource` — an infinite deterministic token stream
  (mixture of Zipf-distributed unigrams + embedded copy/retrieval spans so
  models have something learnable; the retrieval spans also make the
  long-context benchmarks non-trivial).
* :class:`MemmapLMSource` — pre-tokenized ``uint32`` flat files (memmap) cut
  into sequences, shuffled by a seeded permutation per epoch.

The iterator state is two integers (epoch, step) + the seed — trivially
checkpointable and exactly resumable (``state_dict`` / ``load_state_dict``),
which the fault-tolerance tests rely on.  Each host materializes only its
shard: ``global_batch`` rows are split by (process_index, num_processes);
within a host the per-device split is the train step's.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import queue
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLMSource", "MemmapLMSource",
           "HostDataLoader"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32000
    seed: int = 0
    zipf_a: float = 1.2
    copy_span: int = 32          # length of embedded retrieval spans
    copy_prob: float = 0.5       # fraction of sequences with a span
    prefetch: int = 2


class SyntheticLMSource:
    """Deterministic synthetic LM batches.

    Every (epoch, step, row) is generated from a counter-based RNG, so any
    batch can be regenerated independently of iteration order — exact
    resume after preemption is free.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # precomputed zipf-ish unigram distribution over a capped alphabet
        v = min(cfg.vocab_size, 32768)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = (probs / probs.sum()).astype(np.float64)
        self._alphabet = np.arange(v, dtype=np.uint32)

    def row(self, epoch: int, step: int, row_idx: int) -> np.ndarray:
        cfg = self.cfg
        seed = (hash((cfg.seed, epoch, step, row_idx)) & 0x7FFFFFFF)
        rng = np.random.default_rng(seed)
        toks = rng.choice(self._alphabet, size=cfg.seq_len + 1,
                          p=self._probs).astype(np.int32)
        if rng.random() < cfg.copy_prob and cfg.seq_len > 4 * cfg.copy_span:
            # plant span twice: learnable long-range copy structure
            span = toks[8:8 + cfg.copy_span]
            dst = int(rng.integers(cfg.seq_len // 2,
                                   cfg.seq_len - cfg.copy_span))
            toks[dst:dst + cfg.copy_span] = span
        return toks

    def batch(self, epoch: int, step: int, rows: range) -> Dict[str, np.ndarray]:
        data = np.stack([self.row(epoch, step, r) for r in rows])
        return {"tokens": data[:, :-1].astype(np.int32),
                "labels": data[:, 1:].astype(np.int32)}


class MemmapLMSource:
    """Flat pre-tokenized uint32 file -> shuffled fixed-length sequences."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self._data = np.memmap(path, dtype=np.uint32, mode="r")
        self.num_seqs = (len(self._data) - 1) // cfg.seq_len
        if self.num_seqs <= 0:
            raise ValueError(f"{path} too small for seq_len={cfg.seq_len}")

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, epoch))
        return rng.permutation(self.num_seqs)

    def batch(self, epoch: int, step: int, rows: range) -> Dict[str, np.ndarray]:
        perm = self._perm(epoch)
        out_t, out_l = [], []
        for r in rows:
            idx = perm[(step * self.cfg.global_batch + r) % self.num_seqs]
            lo = idx * self.cfg.seq_len
            chunk = np.asarray(self._data[lo:lo + self.cfg.seq_len + 1],
                               dtype=np.int64)
            out_t.append(chunk[:-1])
            out_l.append(chunk[1:])
        return {"tokens": np.stack(out_t).astype(np.int32),
                "labels": np.stack(out_l).astype(np.int32)}


class HostDataLoader:
    """Host-sharded, prefetching, exactly-resumable loader."""

    def __init__(self, cfg: DataConfig, source=None, process_index: int = 0,
                 num_processes: int = 1):
        self.cfg = cfg
        self.source = source or SyntheticLMSource(cfg)
        if cfg.global_batch % num_processes:
            raise ValueError("global_batch must divide across hosts")
        per_host = cfg.global_batch // num_processes
        self._rows = range(process_index * per_host,
                           (process_index + 1) * per_host)
        self._epoch = 0
        self._step = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=max(cfg.prefetch, 1))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- state
    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self._epoch, "step": self._step,
                "seed": self.cfg.seed}

    def load_state_dict(self, state: Dict[str, int]):
        self._drain()
        self._epoch = int(state["epoch"])
        self._step = int(state["step"])

    # ---------------------------------------------------------- iteration
    def _produce(self):
        epoch, step = self._epoch, self._step
        while not self._stop.is_set():
            batch = self.source.batch(epoch, step, self._rows)
            # blocking put with timeout so shutdown is prompt
            while not self._stop.is_set():
                try:
                    self._q.put((epoch, step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1
            epoch_len = getattr(self.source, "num_seqs", 0)
            if epoch_len and step * self.cfg.global_batch >= epoch_len:
                epoch, step = epoch + 1, 0

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._produce,
                                            daemon=True)
            self._thread.start()

    def _drain(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._thread = None
        while not self._q.empty():
            self._q.get_nowait()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        self._ensure_thread()
        epoch, step, batch = self._q.get()
        self._epoch, self._step = epoch, step + 1
        return batch

    def close(self):
        self._drain()
