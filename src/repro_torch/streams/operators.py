"""Real stream-operator bodies, in eager PyTorch.

The simulator models *costs*; these functions are the actual computations the
DAG nodes perform, used by the executor (:mod:`repro_torch.streams.executor`)
to process real tuple batches on the device and to calibrate per-ktuple
costs.

A tuple batch is a dict of equal-length tensors (column format), with int32
keys and counts, float32 values and bool ``valid`` / ``anomaly`` masks.
Every operator is ``(state, batch) -> (state, batch)`` and leaves its inputs
untouched; stateless operators return their state unchanged.  A source's
state is a ``torch.Generator`` on the run's device, and its batches land on
that device.  Each stateful operator's ``init(device)`` builds its state
there; constant tables are built on the batch's device at first use, so a
DAG is built with no device at all.
"""
from __future__ import annotations

import torch

Batch = dict


# -- WordCount ---------------------------------------------------------------


def make_word_producer(vocab_size: int = 4096, batch: int = 2048):
    """Emits (word_id, 1) tuples drawn uniformly from a finite vocabulary."""

    def step(gen: torch.Generator, _batch_unused=None):
        dev = gen.device
        words = torch.randint(0, vocab_size, (batch,), generator=gen, device=dev,
                              dtype=torch.int32)
        return gen, {"key": words, "value": torch.ones(batch, dtype=torch.int32, device=dev)}

    return step


def make_counting_consumer(vocab_size: int = 4096):
    """Maintains running counts per word (fields-grouped key-value store)."""

    def step(counts, batch: Batch):
        counts = counts.index_add(0, batch["key"], batch["value"])
        return counts, {"key": batch["key"], "value": counts[batch["key"]]}

    def init(device):
        return torch.zeros(vocab_size, dtype=torch.int32, device=device)

    step.init = init  # type: ignore[attr-defined]
    return step


# -- Yahoo AdAnalytics (fig. 5) ----------------------------------------------

EVENT_TYPES = 3  # view / click / purchase


def make_ad_source(n_campaigns: int = 100, n_ads: int = 1000, batch: int = 2048):
    def step(gen: torch.Generator, _unused=None):
        dev = gen.device
        ad_id = torch.randint(0, n_ads, (batch,), generator=gen, device=dev, dtype=torch.int32)
        ev_type = torch.randint(0, EVENT_TYPES, (batch,), generator=gen, device=dev,
                                dtype=torch.int32)
        ts = torch.rand(batch, generator=gen, device=dev) * 1e6
        return gen, {"ad_id": ad_id, "event_type": ev_type, "ts": ts}

    return step


def event_deserializer(state, batch: Batch):
    # byte-level "parse": cheap transformation of the raw columns
    return state, {
        "ad_id": batch["ad_id"].to(torch.int32),
        "event_type": batch["event_type"].to(torch.int32),
        "ts": batch["ts"].to(torch.float32),
    }


def event_filter(state, batch: Batch):
    """Keep only 'view' events — about a third of the stream (γ ≈ 0.32)."""
    keep = batch["event_type"] == 0
    # column-format filtering with a validity mask (static shapes)
    return state, {**batch, "valid": keep}


def event_projection(state, batch: Batch):
    """Re-represent the event (γ = 1.0): drop ts, keep join key."""
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones_like(batch["ad_id"], dtype=torch.bool)
    return state, {"ad_id": batch["ad_id"], "valid": valid}


def make_redis_join(n_ads: int = 1000, n_campaigns: int = 100):
    """Join ad_id -> campaign_id against an in-memory table (Redis stand-in).
    The table is built on each batch device at its first batch there."""
    tables: dict[torch.device, torch.Tensor] = {}

    def step(state, batch: Batch):
        ad_id = batch["ad_id"]
        table = tables.get(ad_id.device)
        if table is None:
            table = torch.arange(n_ads, dtype=torch.int32, device=ad_id.device) % n_campaigns
            tables[ad_id.device] = table
        return state, {"campaign_id": table[ad_id], "valid": batch["valid"]}

    return step


def make_campaign_processor(n_campaigns: int = 100):
    """Windowed per-campaign counters (fields-grouped)."""

    def step(counts, batch: Batch):
        inc = batch["valid"].to(torch.int32)
        counts = counts.index_add(0, batch["campaign_id"], inc)
        return counts, {"campaign_id": batch["campaign_id"], "count": counts[batch["campaign_id"]]}

    def init(device):
        return torch.zeros(n_campaigns, dtype=torch.int32, device=device)

    step.init = init  # type: ignore[attr-defined]
    return step


# -- Mobile-network user analytics (fig. 12) ----------------------------------


def make_mobile_source(n_cells: int = 3000, n_users: int = 100_000, batch: int = 2048):
    """Users, cells, exponential byte counts and Gamma(2)-distributed
    latencies.  Gamma(2, 1) is drawn as the sum of two Exp(1) draws, which
    is the same distribution with no rejection loop."""

    def step(gen: torch.Generator, _unused=None):
        dev = gen.device
        user = torch.randint(0, n_users, (batch,), generator=gen, device=dev, dtype=torch.int32)
        cell = torch.randint(0, n_cells, (batch,), generator=gen, device=dev, dtype=torch.int32)
        exp = torch.empty(3, batch, device=dev).exponential_(generator=gen)
        return gen, {
            "user": user,
            "cell": cell,
            "bytes": exp[0] * 1500.0,
            "latency_ms": (exp[1] + exp[2]) * 10.0,
        }

    return step


def log_parser(state, batch: Batch):
    return state, {**batch, "kb": batch["bytes"] / 1024.0}


def make_session_tracker(n_users: int = 100_000):
    def step(sessions, batch: Batch):
        sessions = sessions.index_add(0, batch["user"], batch["kb"])
        return sessions, {**batch, "session_kb": sessions[batch["user"]]}

    def init(device):
        return torch.zeros(n_users, dtype=torch.float32, device=device)

    step.init = init  # type: ignore[attr-defined]
    return step


_F32_001 = 0.009999999776482582   # float32(0.01), exact in float64


def make_cell_kpi(n_cells: int = 3000):
    """Per-cell EWMA of latency — the RAN KPI aggregation stage.

    A batch repeats cells; as in the reference, each cell keeps the update
    of its last position in the batch.  That winner is picked explicitly
    (the largest position per cell), because a CUDA scatter with repeated
    indices leaves it unspecified.

    The reference's compiler (XLA on the CPU) contracts ``0.99 * cur +
    0.01 * latency`` into one fused multiply-add, ``fma(0.01, latency,
    0.99 * cur)``.  Here that product and the sum are taken in float64 (the
    product of two float32 values is exact there) and rounded once to
    float32, which gives the same bits on the card and the host; it could
    differ from a true fused multiply-add only where the float64 sum lands
    exactly on a float32 rounding midpoint."""

    def step(ewma, batch: Batch):
        cell = batch["cell"]
        cur = ewma[cell]
        upd = ((0.99 * cur).double() + batch["latency_ms"].double() * _F32_001).float()
        pos = torch.arange(cell.shape[0], device=cell.device)
        last = torch.full((ewma.shape[0],), -1, dtype=pos.dtype, device=cell.device)
        last = last.scatter_reduce(0, cell.long(), pos, "amax")
        # a gather per cell, not a masked scatter: no host sync, no repeats
        ewma = torch.where(last >= 0, upd[last.clamp(min=0)], ewma)
        return ewma, {"cell": cell, "kpi": upd}

    def init(device):
        return torch.zeros(n_cells, dtype=torch.float32, device=device)

    step.init = init  # type: ignore[attr-defined]
    return step


def anomaly_detector(state, batch: Batch):
    """Flag sessions 3σ above a running mean (cheap z-score filter)."""
    mean, var, n = state
    x = batch["session_kb"]
    n_new = n + x.shape[0]
    delta = x.mean() - mean
    mean_new = mean + delta * x.shape[0] / n_new
    var_new = var + ((x - mean) * (x - mean_new)).sum()
    z = (x - mean_new) / torch.sqrt(torch.clamp(var_new / n_new, min=1e-6))
    return (mean_new, var_new, n_new), {**batch, "anomaly": z > 3.0}


def anomaly_detector_init(device):
    """The running ``(mean, var, n)`` of :func:`anomaly_detector`, as
    float32 scalars on ``device``."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in (0.0, 1.0, 1.0))


_U32 = 0xFFFFFFFF


def geo_mapper(state, batch: Batch):
    """Map cell -> geohash bucket (integer mixing, pure map).

    The reference mixes in uint32 with wraparound; this computes the same
    bits in int64, masking to 32 bits after each multiply."""
    h = batch["cell"].to(torch.int64) & _U32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _U32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _U32
    return state, {**batch, "geo": (h % 1024).to(torch.int32)}


def make_report_sink(n_buckets: int = 1024):
    def step(acc, batch: Batch):
        w = batch.get("anomaly")
        if w is None:
            w = torch.ones_like(batch["geo"], dtype=torch.bool)
        acc = acc.index_add(0, batch["geo"], w.to(torch.float32))
        return acc, {"geo": batch["geo"]}

    def init(device):
        return torch.zeros(n_buckets, dtype=torch.float32, device=device)

    step.init = init  # type: ignore[attr-defined]
    return step
