"""Model-layer foundations: parameter definitions with logical sharding
axes, initialisation, activation-sharding helpers, RoPE, norms.

Parameters are declared through :class:`ParamDef`, as in the reference
package, with the same shapes, logical axis names and init rules, so that
both packages count the same parameters and a reference parameter tree maps
onto the port's modules one to one (:func:`repro_torch.interop.
model_params_from_numpy`).  The launch layer maps logical axes to mesh
axes (:mod:`repro_torch.launch.sharding`); model code never mentions the
mesh.

``axis_rules(...)`` installs the active logical→mesh mapping;
``shard_act(x, axes)`` redistributes a DTensor activation to the
placements the rules give its logical axes, and is a no-op without rules
or on a plain tensor, so a single-device run is what it is without them.
Under the sharded steps (:mod:`repro_torch.launch.steps`) parameters and
activations are DTensors: every hand-written kernel then runs on each
rank's local shards through ``local_map`` (:func:`on_shards`), with the
axis it reduces over whole on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.rmsnorm import add_rmsnorm

# ---------------------------------------------------------------------------
# Logical axis rules
# ---------------------------------------------------------------------------

_STATE = threading.local()


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, Any] | None):
    """Install logical→mesh axis rules for the duration of a step."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = dict(rules) if rules is not None else None
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> dict[str, Any] | None:
    return getattr(_STATE, "rules", None)


def logical_to_spec(axes: tuple[str | None, ...], rules: Mapping[str, Any]):
    """The :class:`~repro_torch.launch.sharding.P` of ``axes`` under ``rules``."""
    from ..launch.sharding import P

    return P(*[rules.get(a) if a is not None else None for a in axes])


def shard_act(x: torch.Tensor, axes: tuple[str | None, ...]) -> torch.Tensor:
    """Redistribute a DTensor activation to the placements of its logical
    axes under the installed rules; a no-op without rules or on a plain
    tensor."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    from ..launch.sharding import placements

    assert len(axes) == x.ndim, (axes, x.shape)
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(logical_to_spec(axes, rules), mesh))


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor every rank computes whole (positions, masks, RoPE
    frequencies), as a replicated DTensor on ``ref``'s mesh when ``ref``
    is a DTensor; else ``t`` itself."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, d) DTensor activation with its sequence axis gathered whole,
    its other placements kept (sequence parallelism hands off here, as
    Megatron's does before a column-parallel matmul); ``x`` itself
    otherwise.  A matmul flattens (B, S) into its rows, which a DTensor
    sharded on both cannot do without this."""
    if not isinstance(x, DTensor) or x.ndim != 3 or Shard(1) not in x.placements:
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if p == Shard(1) else p for p in x.placements])


def input_whole(w: torch.Tensor) -> torch.Tensor:
    """A weight (in, out) with its input axis gathered whole where a mesh dim
    shards it (FSDP's all-gather before use), its output axis as it lies;
    ``w`` itself otherwise.  A one-token decode step then multiplies each
    rank's own batch rows by it, where DTensor, meeting the sharded input
    axis, would gather the rows instead and run the whole batch on every
    rank."""
    if not isinstance(w, DTensor):
        return w
    pl = [Replicate() if p == Shard(0) else p for p in w.placements]
    return w.redistribute(w.device_mesh, pl) if pl != list(w.placements) else w


def _head_cuts(t: DTensor, heads: int) -> list[int]:
    """The mesh dims sharding ``t``'s last axis, if their shards would cut
    one of its ``heads`` (else none)."""
    last = t.ndim - 1
    split = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == last]
    return split if split and heads % math.prod(t.device_mesh.size(i) for i in split) else []


def _whole_heads(t: DTensor, heads: int) -> DTensor:
    """``t`` with its last axis gathered where its shards would cut a head."""
    cut = _head_cuts(t, heads)
    if not cut:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if i in cut else p
                                          for i, p in enumerate(t.placements)])


def split_heads(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(*shape)``, whose last two entries split ``t``'s last axis
    into (heads, head width).  A DTensor whose last axis is sharded over
    mesh dims that do not divide the heads (llama3-8b's 8 kv heads at tp
    16: a shard boundary inside a head) is gathered on that axis first,
    as GSPMD reshards there; the plan then leaves those heads whole."""
    if isinstance(t, DTensor):
        t = _whole_heads(t, shape[-2])
    return t.reshape(*shape)


class _WholeHeadsGrad(torch.autograd.Function):
    """The identity, whose backward gathers a DTensor gradient's last axis
    where its shards would cut a head (:func:`merge_heads`)."""

    @staticmethod
    def forward(ctx, t, heads: int):
        ctx.heads = heads
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (_whole_heads(g, ctx.heads) if isinstance(g, DTensor) else g), None


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., heads, width) with its last two axes merged.  Its
    gradient comes back through the projection after it sharded like the
    projection's input rows, which may cut a head (minicpm3-4b's 40 heads
    at tp 16); such a gradient is gathered before it splits back into
    heads, as :func:`split_heads` gathers."""
    heads = t.shape[-2]
    out = t.reshape(*t.shape[:-2], heads * t.shape[-1])
    if isinstance(out, DTensor) and out.requires_grad:
        out = _WholeHeadsGrad.apply(out, heads)
    return out


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A sharded table (vocab over 'model', d over
    'data') is gathered whole first and each rank looks up its own tokens
    on its shard of them (``local_map``); the table's gradient is then a
    partial sum over the ranks that split the tokens."""
    if not isinstance(table, DTensor):
        return table[tokens]
    tokens = replicated_like(tokens, table)
    pl = list(tokens.placements)
    rep = [Replicate()] * len(pl)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    return on_shards(lambda t, i: t[i], (table, tokens), (rep, pl), pl, (grad, pl))


def take_along_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index]`` element by element: ``torch.gather`` over the last
    axis of ``x`` with one index per row (``index`` has ``x``'s shape but
    the last axis).  A DTensor ``x`` is read on each rank's rows, its last
    axis whole."""
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, index[..., None])[..., 0]
    rows = _row_placements(x)
    index = replicated_like(index, x)
    return on_shards(lambda xl, il: torch.gather(xl, -1, il[..., None])[..., 0], (x, index),
                     (rows, rows), rows)


def vocab_split(logits: torch.Tensor) -> bool:
    """Whether ``logits`` is a DTensor whose last (vocabulary) axis is split
    over a mesh dim of more than one rank."""
    if not isinstance(logits, DTensor):
        return False
    last, mesh = logits.ndim - 1, logits.device_mesh
    return any(p == Shard(last) and mesh.size(i) > 1 for i, p in enumerate(logits.placements))


def _all_reduce(t: torch.Tensor, op: str, groups: list) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    for group in groups:
        t = funcol.all_reduce(t, op, group)
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _VocabParallelCE(torch.autograd.Function):
    """logsumexp(x) - x[target] per row of a rank's vocabulary columns
    ``x`` (rows, V/tp), its first column ``lo``: the row max, Σ exp(x -
    max) and the gold logit (from the rank whose columns hold the target)
    all-reduced over ``groups``, in fp32.  The backward is softmax(x -
    logz) less the one-hot, on the local columns, with no collective."""

    @staticmethod
    def forward(ctx, x, targets, lo: int, groups: list):
        width = x.shape[-1]
        local = targets - lo
        own = (local >= 0) & (local < width)
        local = local.clamp(0, width - 1)
        gold = torch.gather(x, -1, local[..., None])[..., 0].float()
        gold = _all_reduce(torch.where(own, gold, torch.zeros_like(gold)), "sum", groups)
        mx = _all_reduce(x.amax(-1).float(), "max", groups)
        e = x.float() - mx[..., None]
        logz = mx + torch.log(_all_reduce(e.exp_().sum(-1), "sum", groups))
        ctx.save_for_backward(x, local, own, logz)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        x, local, own, logz = ctx.saved_tensors
        p = (x.float() - logz[..., None]).exp_()
        p.scatter_add_(-1, local[..., None], -own.to(p.dtype)[..., None])
        return p.mul_(g[..., None]).to(x.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: DTensor, targets: torch.Tensor) -> DTensor:
    """The cross-entropy logsumexp(logits) - logits[target] per row, fp32,
    of ``logits`` (..., V) whose vocabulary axis is split over mesh dims
    (:func:`vocab_split`): each rank reduces its own (rows, V/tp) columns
    and all-reduces three row vectors over those dims, as Megatron's
    vocab-parallel loss does, so no rank gathers the vocabulary.  Returns
    the rows as ``targets`` lies (its batch shards kept, replicated over
    the vocabulary's dims)."""
    last, mesh = logits.ndim - 1, logits.device_mesh
    dims = [i for i, p in enumerate(logits.placements) if p == Shard(last)]
    idx, count = shard_index(mesh, dims)
    lo = idx * -(-logits.shape[-1] // count)        # DTensor's (ceil) chunk size
    groups = [mesh.get_group(i) for i in dims if mesh.size(i) > 1]
    cols = [p if isinstance(p, Shard) else Replicate() for p in logits.placements]
    rows = _row_placements(logits)
    return on_shards(lambda xl, tl: _VocabParallelCE.apply(xl, tl, lo, groups),
                     (logits, replicated_like(targets, logits)), (cols, rows), rows)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    DTensor's reshape is a view of its local shard, which a strided
    gradient (a plain version's einsum output) cannot take."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_shards(fn: Callable, args: tuple, in_placements: tuple, out_placements,
              in_grad_placements: tuple | None = None):
    """``fn`` on each rank's local shards of the DTensors ``args``, each
    first redistributed to its ``in_placements``; the outputs become
    DTensors with ``out_placements``.  ``in_grad_placements`` says how an
    input's local gradient adds up (``Partial`` where each rank holds a
    part of the sum), as ``local_map`` takes it."""
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh

    def local(*ts):
        return fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t for t in ts))

    return local_map(local, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def rule_dims(mesh, logical: str) -> list[int]:
    """The mesh dims that the installed rules map the logical axis
    ``logical`` to (none without rules)."""
    rule = (current_rules() or {}).get(logical)
    axes = () if rule is None else rule if isinstance(rule, tuple) else (rule,)
    return [i for i, name in enumerate(mesh.mesh_dim_names) if name in axes]


def shard_index(mesh, dims: list[int]) -> tuple[int, int]:
    """This rank's index among the shards that the mesh dims ``dims`` cut
    one tensor dim into (the first mesh dim the slowest, as DTensor lays a
    dim sharded on several mesh dims out), and their count."""
    idx, count = 0, 1
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        count *= mesh.size(i)
    return idx, count


def split_last(t: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """``t.split(t.shape[-1] // n, dim=-1)``.  On a DTensor whose last axis
    is sharded, each of the ``n`` parts comes out sharded the same way
    (rank r holding the r-th shard of every part), so a fused projection's
    halves (Mamba's ``xs``/``z``, mLSTM's ``u``/``z``, sLSTM's four gates)
    keep their channels on the same ranks.  The axis is gathered whole and
    each rank cuts its shards out of every part (``local_map``); the
    input's gradient is then a partial sum over those mesh dims.  A part
    whose width the shards do not divide comes out whole."""
    m = t.shape[-1] // n
    if not isinstance(t, DTensor):
        return t.split(m, dim=-1)
    last = t.ndim - 1
    dims = [i for i, p in enumerate(t.placements) if p == Shard(last)]
    idx, count = shard_index(t.device_mesh, dims)
    whole = [Replicate() if p == Shard(last) else p for p in t.placements]
    if not dims or m % count:
        return on_shards(lambda tl: tuple(tl.split(m, dim=-1)), (t,), (whole,), (whole,) * n)
    w = m // count
    grad = [Partial() if p == Shard(last) else p for p in t.placements]
    return on_shards(
        lambda tl: tuple(tl[..., j * m + idx * w: j * m + (idx + 1) * w] for j in range(n)),
        (t,), (whole,), (list(t.placements),) * n, (grad,))


def _row_placements(x: DTensor) -> list:
    """``x``'s placements with its last axis whole on every rank: a shard
    of another axis kept, anything else replicated."""
    last = x.ndim - 1
    return [p if isinstance(p, Shard) and p.dim != last else Replicate() for p in x.placements]


def _norm_placements(x: DTensor) -> tuple[list, list, list]:
    """A norm's rows of ``x`` (:func:`_row_placements`), its gain
    replicated, and the gain's gradient: a partial sum over the mesh dims
    that split the rows."""
    rows = _row_placements(x)
    gain_grad = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    return rows, [Replicate()] * len(rows), gain_grad


def call_norm(norm: Callable, x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """``norm(x, gain, eps)``: the RMSNorm kernel ``norm`` on ``x``, or on
    each rank's rows of a DTensor ``x`` (its last axis gathered whole, the
    gain replicated; the gain's gradient a partial sum over the ranks that
    split the rows)."""
    if not isinstance(x, DTensor):
        return norm(x, gain, eps)
    rows, rep, gain_grad = _norm_placements(x)
    return on_shards(lambda xl, gl: norm(xl.contiguous(), gl, eps), (x, gain),
                     (rows, rep), rows, (rows, gain_grad))


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"       # normal | zeros | ones | embed | small
    scale: float = 1.0         # extra multiplier on the init std

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


ParamTree = dict  # nested dict[str, ParamDef | ParamTree]


def tree_defs_map(fn: Callable[[ParamDef], Any], defs: ParamTree) -> dict:
    out = {}
    for k, v in defs.items():
        out[k] = fn(v) if isinstance(v, ParamDef) else tree_defs_map(fn, v)
    return out


def init_params(defs: ParamTree, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> dict:
    """A nested dict of tensors for ``defs``, drawn from ``generator`` leaf by
    leaf in sorted path order with the reference's rules: zeros, ones,
    ``N(0, 0.02·scale)`` for embeddings and ``N(0, scale / fan_in)`` (std
    ``scale / sqrt(fan_in)``) otherwise.  The draws happen in place on
    ``device`` (which must match the generator's), so an 8B-parameter tree
    never holds a second copy."""
    leaves: list[tuple[tuple[str, ...], ParamDef]] = []

    def walk(d, path):
        for k, v in sorted(d.items()):
            if isinstance(v, ParamDef):
                leaves.append((path + (k,), v))
            else:
                walk(v, path + (k,))

    walk(defs, ())

    def make(pd: ParamDef) -> torch.Tensor:
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=device)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=device)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        std = pd.scale / max(fan_in, 1) ** 0.5
        if pd.init == "embed":
            std = pd.scale * 0.02
        t = torch.empty(pd.shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=generator).to(dtype)

    out: dict = {}
    for path, pd in leaves:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = make(pd)
    return out


def param_specs(defs: ParamTree, rules: Mapping[str, Any]) -> dict:
    return tree_defs_map(lambda pd: logical_to_spec(pd.axes, rules), defs)


def param_logical_axes(defs: ParamTree) -> dict:
    return tree_defs_map(lambda pd: pd.axes, defs)


def count_params(defs: ParamTree) -> int:
    total = 0

    def walk(d):
        nonlocal total
        for v in d.values():
            if isinstance(v, ParamDef):
                n = 1
                for s in v.shape:
                    n *= s
                total += n
            else:
                walk(v)

    walk(defs)
    return total


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor | None, gain: torch.Tensor,
                 eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the RMSNorm after it: returns ``(x + delta,
    rmsnorm(x + delta))``, or ``(x, rmsnorm(x))`` when ``delta`` is None.
    One CUDA launch on the card, the plain versions on the CPU
    (:func:`repro_torch.kernels.rmsnorm.add_rmsnorm`); on each rank's rows
    of a DTensor ``x`` (``delta`` brought to ``x``'s row placements), as
    :func:`call_norm` runs the norm alone."""
    if not isinstance(x, DTensor):
        return add_rmsnorm(x, delta, gain, eps)
    if delta is None:
        return x, call_norm(lambda xl, gl, e: add_rmsnorm(xl, None, gl, e)[1], x, gain, eps)
    rows, rep, gain_grad = _norm_placements(x)
    return on_shards(lambda xl, dl, gl: add_rmsnorm(xl.contiguous(), dl.contiguous(), gl, eps),
                     (x, delta, gain), (rows, rows, rep), (rows, rows), (rows, rows, gain_grad))


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32) / half))


def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs`, computed on the host (so every device rotates by
    the same frequencies) and copied once to ``device``.  Under a fake mode
    (a dry run) they are made anew, kept out of the cache, and their ops
    left out of a count, as a step on the card finds them cached."""
    from ..kernels import _cost

    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
        with _cost.quiet():
            return rope_freqs(head_dim, theta).to(device)
    return _rope_freqs_cached(head_dim, theta, device)


@functools.lru_cache(maxsize=32)
def _rope_freqs_cached(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return rope_freqs(head_dim, theta).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.

    The reference's half-split layout: the first and second halves of the
    head dimension form the rotated pairs."""
    hd = x.shape[-1]
    freqs = replicated_like(_rope_freqs_on(hd, float(theta), x.device), x)  # (hd/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    x = seq_whole(x)
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def softmax_fp32(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(scores.to(torch.float32), dim=dim)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                window: int | None = None, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask; True = attend.  ``q_offset`` positions the
    query block inside the kv sequence (for decode/chunked prefill); ``window``
    enables sliding-window attention."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m
