"""Training data pipeline (numpy): deterministic synthetic corpus
generation, sequence packing and host-side prefetch, the port's copy of
the reference package's ``data/pipeline.py``.

Deterministic-by-step: ``batch_at(step)`` is a pure function of (seed,
step), so a restarted run reproduces the exact stream, and both packages
give the same arrays bit for bit.  :func:`shard_batch` places a batch on a
device mesh as DTensors, for the sharded steps.  ``DataConfig`` leaves out
the reference's ``prefetch`` field, which nothing reads there either: the
prefetch depth is :class:`PrefetchIterator`'s own argument.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

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


def shard_batch(batch: dict, mesh, batch_axes=("data",)) -> dict:
    """Place a host batch onto the mesh with the batch dim sharded: each
    array becomes a DTensor on ``mesh``'s device type, ``Shard(0)`` over
    the mesh dims named in ``batch_axes`` and replicated over the others.
    ``"step"`` is dropped, as the reference drops it."""
    names = tuple(mesh.mesh_dim_names)
    missing = set(batch_axes) - set(names)
    if missing:
        raise ValueError(f"batch axes {sorted(missing)} are not in the mesh's {names}")
    pl = [Shard(0) if n in batch_axes else Replicate() for n in names]
    out = {}
    for k, v in batch.items():
        if k == "step":
            continue
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        out[k] = distribute_tensor(t.to(mesh.device_type), mesh, pl)
    return out
