"""Counting one step as one device runs it: FLOPs, bytes, collective bytes
and memory, op by op, for a dry run on fake tensors and for a real step
alike.

:class:`StepCounter` is a ``TorchDispatchMode``.  It returns
``NotImplemented`` for an op on DTensors, so DTensor turns the op into the
ops on this rank's local shards and the collectives between ranks, and
those are what it counts: per device, as the reference's
``cost_analysis`` counts.  The hand-written kernels report their own
FLOPs and bytes per launch (:mod:`repro_torch.kernels._cost`), on the card
and in the stand-ins a dry run or a CPU run takes in their place, and the
ops of a plain version standing in for a kernel are left out.  So a dry
run on fake tensors, a step on gloo ranks and a step on the card count
alike, entry for entry.

- ``flops``: the ops that ``torch.utils.flop_counter`` prices (matmuls,
  convolutions, attention), plus each kernel's own count.
- ``bytes``: each op's tensor inputs read and outputs written, views left
  out, plus each kernel's bytes.  Nothing is fused, so this is an upper
  bound beside XLA's fused ``bytes accessed``.
- ``collectives``: the output bytes of each collective by the reference's
  kinds (``COLLECTIVE_KINDS``), as ``collective_bytes_from_hlo`` takes the
  output type; one outside those five is keyed by its op's name.
- ``peak_bytes``: the most bytes of storage that ops made inside the count
  held at once (a storage is freed when its last tensor goes), i.e. the
  step's temporaries above what lived before it, as
  ``torch.cuda.max_memory_allocated`` less the memory allocated before a
  step reads on the card (without the allocator's rounding).

Left out of every figure: what DTensor makes to propagate shardings.  To
learn an op's output layout it runs the op, or its decomposition, on
stand-ins of the *global* shape: fake tensors on the step's device
(``_propagate_tensor_meta_non_cached``), meta tensors once for each
candidate placement (``propagate_strategy`` through
``torch/distributed/tensor/_decompositions.py``), a one-rank fake mesh.  No
rank holds them and the card's allocator never sees them, and a dry run
on a fresh process meets more of them than one whose sharding cache is
warm.  Counted, softplus's backward at jamba-398b's train_4k cell alone
made 336 GiB of them.  The counter hides all of DTensor's propagation by
name (:func:`_eager_dtensor`): ``propagate_op_sharding``, cached or not,
and the tensor-meta probe, wherever it is called from.  That covers
whatever path a torch version takes beneath those entry points; a guard
on the meta device would cover only the decompositions (the probe's
stand-ins are fake tensors on the step's device, the fake mesh's a CPU
tensor).
"""
from __future__ import annotations

import contextlib
import functools
import sys
import threading
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import _cost

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_KIND_OF = {
    **dict.fromkeys(("all_gather_into_tensor", "all_gather_into_tensor_coalesced",
                     "all_gather_into_tensor_out", "allgather_", "_allgather_base_",
                     "allgather_coalesced_", "allgather_into_tensor_coalesced_"), "all-gather"),
    **dict.fromkeys(("all_reduce", "all_reduce_coalesced", "allreduce_",
                     "allreduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                     "reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_"), "reduce-scatter"),
    **dict.fromkeys(("all_to_all_single", "alltoall_", "alltoall_base_"), "all-to-all"),
    **dict.fromkeys(("permute_tensor",), "collective-permute"),
}
#: Ops that move no tensor data (a collective's wait, a barrier).
_NO_DATA = ("wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier_")
#: Ops that read no tensor data: allocations (no bytes) and fills (their
#: output written).
_FILLS = ("zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros",
          "new_ones", "new_full", "scalar_tensor", "arange")


_HIDDEN = [0]


class _Hidden:
    """``fn`` with every op it dispatches left out of the counts, as a
    method of the class it is set on or as an attribute of an object
    (whose other attributes, such as an LRU cache's ``cache_info``, it
    passes through)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *args, **kwargs):
        _HIDDEN[0] += 1
        try:
            return self._fn(*args, **kwargs)
        finally:
            _HIDDEN[0] -= 1

    def __get__(self, obj, owner=None):
        return self if obj is None else functools.partial(self, obj)

    def __getattr__(self, name):
        return getattr(self._fn, name)


@contextlib.contextmanager
def _eager_dtensor():
    """DTensor as an eager step runs it, also on fake tensors.  Under a fake
    mode DTensor takes itself to be tracing (``_are_we_tracing``): it then
    skips its sharding caches and wraps collectives otherwise, so a dry run
    would dispatch other local ops than the real step; inside, that check
    is False.  And DTensor's sharding propagation (the cached and uncached
    ``propagate_op_sharding`` and the tensor-meta probe) is no part of the
    step: inside, counters ignore every op it dispatches."""
    from torch.distributed import _functional_collectives as fc
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    original = fc._are_we_tracing
    patched = [m for m in list(sys.modules.values())
               if getattr(m, "__name__", "").startswith("torch.distributed")
               and getattr(m, "_are_we_tracing", None) is original]
    # the propagator's cache holds the method it was built with, so the
    # singleton's cached entry point is hidden where it lies: on the object
    prop = DTensor._op_dispatcher.sharding_propagator
    hidden = [(ShardingPropagator, "_propagate_tensor_meta_non_cached"),
              (ShardingPropagator, "propagate_op_sharding_non_cached"),
              (prop if "propagate_op_sharding" in vars(prop) else ShardingPropagator,
               "propagate_op_sharding")]
    kept = [(owner, name, vars(owner)[name]) for owner, name in hidden]

    for m in patched:
        m._are_we_tracing = lambda: False
    for owner, name, fn in kept:
        setattr(owner, name, _Hidden(fn))
    try:
        yield
    finally:
        for owner, name, fn in kept:
            setattr(owner, name, fn)
        for m in patched:
            m._are_we_tracing = original


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepCounter(TorchDispatchMode):
    """Counts what runs inside ``with StepCounter() as c:`` on this rank
    (see the module's docstring); ``kernels`` holds each hand-written
    kernel's launches, FLOPs and bytes by name."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, float] = {}
        self.kernels: dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._lock = threading.RLock()
        self._storages: dict[int, weakref.ref] = {}
        self._fresh: dict = {}
        self._context = None

    def __enter__(self):
        self._context = contextlib.ExitStack()
        self._context.enter_context(_cost.registered(self))
        self._context.enter_context(_eager_dtensor())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._context.close()

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One launch of a hand-written kernel (reported by its wrapper)."""
        with self._lock:
            self.flops += flops
            self.bytes += nbytes
            k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            k["launches"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes

    def figures(self) -> dict:
        """The counts as plain numbers."""
        return {"flops": self.flops, "bytes": self.bytes, "collectives": dict(self.collectives),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_bytes": self.peak_bytes}

    def _makes_storage(self, func) -> bool:
        """Whether ``func``'s outputs are new tensors (no view, no in-place
        or out= result)."""
        fresh = self._fresh.get(func)
        if fresh is None:
            fresh = not func.is_view and all(r.alias_info is None for r in func._schema.returns)
            self._fresh[func] = fresh
        return fresh

    def _track(self, outs: list) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            with self._lock:
                if key in self._storages and self._storages[key]() is st:
                    continue
                n = st.nbytes()
                self._storages[key] = weakref.ref(st, self._freed(key, n))
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key: int, n: int):
        def done(ref):
            with self._lock:
                self.live_bytes -= n
                if self._storages.get(key) is ref:
                    del self._storages[key]
        return done

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented         # DTensor runs first; its local ops come back here
        out = func(*args, **kwargs)
        if _HIDDEN[0] or func.namespace == "prim":      # sharding propagation; metadata
            return out
        outs = _tensors(out)
        fresh = self._makes_storage(func)
        if fresh:
            self._track(outs)
        if _cost.is_quiet():
            return out
        name = func._opname
        if name in _NO_DATA and func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        with self._lock:
            if func.namespace in _COLLECTIVE_NAMESPACES:
                kind = _KIND_OF.get(name, name)
                self.collectives[kind] = (self.collectives.get(kind, 0.0)
                                          + sum(_nbytes(t) for t in outs))
                return out
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if func.is_view or "empty" in name:
                return out
            written = sum(_nbytes(t) for t in outs)
            read = 0 if name in _FILLS else sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += read + written
        return out
