"""Training data pipeline (numpy): deterministic synthetic corpus
generation, sequence packing and host-side prefetch, the port's copy of
the reference package's ``data/pipeline.py``.

Deterministic-by-step: ``batch_at(step)`` is a pure function of (seed,
step), so a restarted run reproduces the exact stream, and both packages
give the same arrays bit for bit.  The reference's ``shard_batch`` places
a batch on a device mesh; the port trains on one card (ROADMAP queue 1,
item 3e (ii) for more).  ``DataConfig`` leaves out the reference's
``prefetch`` field, which nothing reads there either: the prefetch depth
is :class:`PrefetchIterator`'s own argument.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from .tokenizer import HashTokenizer, synthetic_document


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2    # realistic token frequency skew


class SyntheticLMStream:
    """Packs synthetic documents (BOS-delimited) into fixed-length rows."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tok = HashTokenizer(cfg.vocab)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """``{"tokens", "labels"}``, int32 (global_batch, seq_len), labels
        the tokens shifted by one within each packed row."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        rows = []
        for _ in range(cfg.global_batch):
            toks: list[int] = []
            while len(toks) < cfg.seq_len + 1:
                toks.extend(synthetic_document(rng, self.tok, alpha=cfg.zipf_alpha))
            rows.append(np.asarray(toks[: cfg.seq_len + 1], np.int32))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Host-side background prefetch (overlaps data generation with compute)."""

    def __init__(self, stream: SyntheticLMStream, start_step: int = 0,
                 prefetch: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            batch["step"] = step
            try:
                self.q.put(batch, timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __next__(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
