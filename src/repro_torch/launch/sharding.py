"""Parallelism plans: logical-axis → mesh-axis rules per (arch, mode).

The port's copy of the reference's ``launch/sharding.py``: the same plans,
rules and specs, entry for entry.  The default plan composes:

* **DP**   — batch over ('pod','data')
* **FSDP** — every weight's d_model-side axis ("embed_w") over 'data'
             (+'pod' for the 398B hybrid)
* **TP**   — heads / ff / vocab over 'model'
* **SP**   — activation seq over 'model' between blocks (train/prefill)
* **EP**   — expert axis over 'model' when n_experts % tp == 0, else
             expert-TP (per-expert ff over 'model')
* decode   — KV-cache time axis over 'model' (the decode step combines the
             softmax over the sharded axis as flash-decoding does);
             long_500k additionally spreads the cache time axis over
             ('data','model') since batch=1 leaves 'data' idle.

Divisibility is checked per arch — axes that don't divide (e.g. minicpm3's
40 heads on tp=16, xlstm's 4 heads) fall back to replication for the
*activation* while the flattened weight dim stays TP-sharded.

A spec is :class:`P`, one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of names (the dim split over several mesh axes, the
first the slowest).  :func:`placements` turns a spec into the DTensor
placements of a ``DeviceMesh``, one per mesh dim.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ModelConfig, ShapeConfig
from ..models.ssm import mlstm_inner_dim


class P(tuple):
    """A partition spec: a tuple of mesh-axis entries, one per tensor dim,
    printed as the reference's ``PartitionSpec`` prints.  As there, a
    one-name tuple entry is the name itself."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(repr(e) for e in self)})"


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    multi_pod: bool = False
    tp: int = 16
    dp: int = 16
    fsdp: bool = True
    fsdp_over_pod: bool = False     # ZeRO across pods too (398B-class models)
    sp: bool = True                 # sequence-parallel activations
    ep: bool | None = None          # None = auto (divisibility)
    seqshard_cache: bool = True     # shard decode KV cache time axis on 'model'


def _div(n: int, k: int) -> bool:
    return n % k == 0


def make_rules(cfg: ModelConfig, shape: ShapeConfig, plan: PlanConfig) -> dict[str, Any]:
    """Logical axis name -> mesh axis (or tuple, or None)."""
    tp = plan.tp
    data_axes = ("pod", "data") if plan.multi_pod else ("data",)
    fsdp_axes = None
    if plan.fsdp:
        fsdp_axes = ("pod", "data") if (plan.multi_pod and plan.fsdp_over_pod) else "data"

    mode = shape.kind
    B = shape.global_batch
    dp_total = plan.dp * (2 if plan.multi_pod else 1)

    rules: dict[str, Any] = {
        # ---- weights ----
        "layers": None,
        "embed_w": fsdp_axes,
        "heads_w": "model" if _div(cfg.n_heads * cfg.head_dim, tp) else None,
        "kv_w": "model" if _div(cfg.n_kv_heads * cfg.head_dim, tp) else None,
        "ff": "model" if cfg.d_ff and _div(cfg.d_ff, tp) else None,
        "vocab": "model",   # configs pad the table; see padded_vocab()
        "rank": None,
        "conv": None,
        # ---- activations ----
        "act_batch": data_axes if _div(B, dp_total) else None,
        "act_seq": "model" if (plan.sp and mode != "decode" and _div(shape.seq_len, tp)) else None,
        "act_heads": "model" if _div(cfg.n_heads, tp) else None,
        "act_kv": "model" if _div(cfg.n_kv_heads, tp) else None,
        "act_ff": "model" if cfg.d_ff and _div(cfg.d_ff, tp) else None,
        "act_vocab": "model",
    }

    # MLA: heads_w carries H*(nope+rope) and H*v_head flattened dims
    if cfg.attention == "mla" and cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        ok = _div(cfg.n_heads * qk, tp) and _div(cfg.n_heads * m.v_head_dim, tp)
        rules["heads_w"] = "model" if ok else None

    # SSM inner dims
    if cfg.family in ("ssm", "hybrid"):
        ssm = cfg.ssm
        di_mamba = (ssm.expand if ssm else 2) * cfg.d_model
        di_mlstm = mlstm_inner_dim(cfg)
        inner_ok = _div(di_mamba, tp) if "mamba" in cfg.pattern() else True
        if any(k in cfg.pattern() for k in ("mlstm", "slstm")):
            inner_ok = inner_ok and _div(2 * di_mlstm, tp) and _div(4 * cfg.d_model, tp)
        rules["inner"] = "model" if inner_ok else None
        rules["act_inner"] = rules["inner"]
        rules["heads"] = "model" if _div(cfg.n_heads, tp) else None
        # mlstm per-head q/k/v head-dim sharding was tried and refuted in
        # the reference: sharding the contracted dh axis makes every
        # block-diagonal matmul a partial sum and re-gathers the operands.
        # Keep the axis unmapped.
        rules["act_headdim"] = None
    else:
        rules["inner"] = None
        rules["act_inner"] = None
        rules["heads"] = None
        rules["act_headdim"] = None

    # MoE: EP when experts divide tp, else expert-TP
    if cfg.is_moe:
        use_ep = plan.ep if plan.ep is not None else _div(cfg.n_experts, tp)
        if use_ep:
            rules["experts"] = "model"
            rules["experts_act"] = "model"
            rules["expert_ff"] = None
            rules["expert_act_ff"] = None
        else:
            rules["experts"] = None
            rules["experts_act"] = None
            rules["expert_ff"] = "model" if _div(cfg.expert_ff, tp) else None
            rules["expert_act_ff"] = rules["expert_ff"]
    return rules


def cache_rules(cfg: ModelConfig, shape: ShapeConfig, plan: PlanConfig) -> dict[str, Any]:
    """Extra logical axes used only by decode caches."""
    data_axes = ("pod", "data") if plan.multi_pod else ("data",)
    B = shape.global_batch
    dp_total = plan.dp * (2 if plan.multi_pod else 1)
    batch_ok = B % dp_total == 0
    t = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    rules: dict[str, Any] = {
        "cache_batch": data_axes if batch_ok else None,
        "cache_t": None,
        "cache_kv": None,
    }
    if plan.seqshard_cache and cfg.attention != "mla":
        if not batch_ok and t % (dp_total * plan.tp) == 0:
            # batch=1 long-context: spread the cache over every axis we have
            rules["cache_t"] = data_axes + ("model",) if plan.multi_pod else ("data", "model")
        elif t % plan.tp == 0:
            rules["cache_t"] = "model"
    elif cfg.attention == "mla":
        # compressed cache: no head axis; shard time over model
        if t % plan.tp == 0:
            rules["cache_t"] = "model"
    return rules


def _leaf_spec(name: str, ndim: int, rules: dict[str, Any], crules: dict[str, Any]) -> P:
    """The spec of one cache leaf, by its name and rank (the reference's
    ``spec_for``)."""
    if name in ("k", "v"):               # (nper, B, T, KV, hd)
        return P(None, crules["cache_batch"], crules["cache_t"], None, None)
    if name in ("c_kv", "k_rope"):       # (nper, B, T, r)
        return P(None, crules["cache_batch"], crules["cache_t"], None)
    if name == "h" and ndim == 4:        # mamba (nper, B, di, N)
        return P(None, crules["cache_batch"], rules.get("inner"), None)
    if name == "conv":                   # (nper, B, d_conv-1, di)
        return P(None, crules["cache_batch"], None, rules.get("inner"))
    if name == "C":                      # mlstm (nper, B, nh, dh, dh)
        return P(None, crules["cache_batch"], rules.get("heads"), None, None)
    if name == "n" and ndim == 4:
        return P(None, crules["cache_batch"], rules.get("heads"), None)
    # slstm scalars (nper, B, d) and anything else
    return P(*([None] * (ndim - 2) + [crules["cache_batch"], None])) if ndim >= 2 else P()


def cache_specs(cache_struct: Any, cfg: ModelConfig, rules: dict[str, Any],
                crules: dict[str, Any]) -> Any:
    """A spec tree matching ``Model.cache_struct(...)`` (nested dicts of
    tensors) by leaf name."""

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else _leaf_spec(k, v.ndim, rules, crules)
                for k, v in node.items()}

    return walk(cache_struct)


def batch_specs(batch_struct: Any, rules: dict[str, Any]) -> Any:
    """Specs for the input batch (a dict of tensors by input name)."""
    b = rules.get("act_batch")

    def spec_for(name: str) -> P:
        if name in ("tokens", "labels"):
            return P(b, None)
        if name == "frontend":
            return P(b, None, None)
        if name == "token":
            return P(b, None)
        return P()  # pos scalar

    return {k: spec_for(k) for k in batch_struct}


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d`` names that mesh axis, else
    ``Replicate()``.  A tuple entry shards its dim over each of its mesh
    axes, which must come in the mesh's order (the first the slowest, as
    the reference lays them out).  A mesh axis that two tensor dims name,
    or an axis the mesh lacks, raises ``ValueError``."""
    names = tuple(mesh.mesh_dim_names)
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec!r}: mesh axis {a!r} is not one of {names}")
            if a in owner:
                raise ValueError(f"{spec!r}: mesh axis {a!r} shards both tensor dim "
                                 f"{owner[a]} and tensor dim {d}")
            owner[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec!r}: the axes {axes} of tensor dim {d} are not in the "
                             f"mesh's order {names}")
    return [Shard(owner[n]) if n in owner else Replicate() for n in names]
