"""Step builders: the train, prefill and decode steps on a device mesh, with
the reference's sharding plans (``launch/steps.py``).

PyTorch's own counterpart of GSPMD carries them: a ``DeviceMesh`` for the
JAX mesh, DTensor placements for the reference's ``NamedSharding``s (from
:mod:`.sharding`'s rules and specs), the activations redistributed where
the reference constrains them (:func:`~repro_torch.models.common.
shard_act`), and every hand-written kernel run on each rank's local shards
through ``local_map``.  A step is a plain callable on DTensors, not a
compiled program: ``bundle.step_fn(*real_args)`` runs it, and ``args``
holds meta-device tensors of the reference's abstract shapes and dtypes.
A step places its batch and caches with the plan's specs, as the
reference's ``in_shardings`` do: full tensors are distributed, DTensors
placed otherwise redistributed, and DTensors so placed passed through (a
decode step's caches are then written in place).  The optimizer state
comes from ``optim.init_opt_state`` on the placed parameters, each
moment and master copy sharded as its parameter (ZeRO).

Parameters are distributed from the full tensors that the port's own init
(``dict(build_model(...).named_parameters())``) or
:func:`repro_torch.interop.model_params_from_numpy` makes
(:meth:`StepBundle.place_params`), so a sharded run starts from exactly a
single-device run's values.  ``remat="full"`` recomputes each block in the
backward (``torch.utils.checkpoint``); ``scan_layers`` is accepted for the
reference's signature and has no counterpart in eager torch, whose layers
run in a Python loop either way.

The bundles execute every registered architecture: decoders of GQA or
MLA attention, Mamba, mLSTM and sLSTM blocks with dense or MoE
feed-forwards (MoE under EP or expert-TP), decoders behind a frontend's
tokens and encoder-decoder models.  A decode step combines the partial
softmaxes of a cache whose time axis the plan splits (GQA's K/V, MLA's
compressed ``c_kv``/``k_rope``, and an encoder-decoder model's
``cross_kv``, whose frames split by the decode shape's ``cache_t``,
unevenly where they do not divide it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.func import functional_call

from ..configs.base import ModelConfig, ShapeConfig
from ..interop import unstack_tree
from ..models.common import axis_rules, param_specs, tree_defs_map
from ..models.model import Model
from ..models.transformer import decoder_defs
from ..optim.optimizer import AdamWConfig, adamw_update
from . import sharding as shlib
from .sharding import P, placements


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one (arch × shape × mesh) cell."""

    model: Model              # on the meta device: names, shapes and dtypes
    cfg: ModelConfig
    shape: ShapeConfig
    plan: shlib.PlanConfig
    rules: dict[str, Any]
    step_fn: Any              # a plain callable on DTensors
    args: tuple               # meta-device stand-ins of the step's arguments
    kind: str                 # train | prefill | decode
    mesh: Any = None
    param_specs: dict = dataclasses.field(default_factory=dict)   # by parameter name

    def place_params(self, state: Mapping[str, torch.Tensor]) -> dict[str, DTensor]:
        """The step's parameters from full tensors by parameter name: each
        cast to the bundle's parameter dtype and distributed onto the mesh
        with its spec's placements (every rank passes the same values), a
        train bundle's with gradients on.  A train step updates its
        parameters in place, so a train bundle's local shard that would
        share ``state``'s storage (a replicated leaf, or any leaf on a
        one-rank mesh) is a copy."""
        out = {}
        for name, meta in self.model.named_parameters():
            full = state[name].detach().to(meta.dtype)
            t = _place(full, self.param_specs[name], self.mesh)
            if self.kind == "train":
                local = t.to_local()
                if local.untyped_storage().data_ptr() == full.untyped_storage().data_ptr():
                    t = DTensor.from_local(local.clone(), self.mesh, t.placements,
                                           run_check=False, shape=t.shape, stride=t.stride())
                t.requires_grad_(True)
            out[name] = t
        return out


def opt_state_specs(pspecs: Any, use_master: bool = True) -> dict:
    """Optimizer state shards exactly like params (ZeRO)."""
    out = {"step": P(), "m": pspecs, "v": pspecs}
    if use_master:
        out["master"] = pspecs
    return out


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _place(t: torch.Tensor, spec: tuple, mesh) -> DTensor:
    """``t`` with ``spec``'s placements on ``mesh``: a DTensor already so
    placed is passed through, another redistributed, a full tensor
    distributed."""
    pl = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh, pl)
    return distribute_tensor(t.to(mesh.device_type), mesh, pl)


def _map2(fn, tree: dict, specs: dict) -> dict:
    return {k: _map2(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in tree.items()}


def _whole(t):
    """A DTensor result as the full tensor every rank agrees on."""
    return t.full_tensor() if isinstance(t, DTensor) else t


class _With(nn.Module):
    """``fn(model)`` as a module call, for ``functional_call``."""

    def __init__(self, model: Model):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn(self.model)


def _call(model: Model, params: dict, fn):
    """``fn(model)`` with ``params`` (by parameter name) in place of the
    model's meta parameters, the backward included if ``fn`` runs it (a
    block recomputed there reads the same parameters)."""
    return functional_call(_With(model), {f"model.{n}": t for n, t in params.items()}, (fn,))


def _meta_model(cfg: ModelConfig, param_dtype: torch.dtype, remat: str) -> Model:
    defs = decoder_defs(cfg)
    model = Model(cfg, tree_defs_map(
        lambda pd: torch.empty(pd.shape, dtype=param_dtype, device="meta"), defs))
    model.remat = remat
    return model


def _name_specs(cfg: ModelConfig, rules: dict) -> dict[str, P]:
    """Each parameter's spec by the port's parameter name: a stacked leaf's
    spec without its period entry ("layers", never sharded)."""
    return unstack_tree(param_specs(decoder_defs(cfg), rules), cfg,
                        lambda name, spec, layer, n: _once(spec if layer is None
                                                           else P(*spec[1:])))


def _once(spec: P) -> P:
    """``spec`` with each mesh axis kept on the first dim that names it.
    The rules name 'model' twice for mLSTM's gate maps (di, H) where both
    the inner axis and the heads divide tp (xlstm-1.3b@smoke at tp = 2);
    neither JAX nor a DeviceMesh lays a tensor out so, and the inner axis
    keeps the split that its matmul with the up-projection's half needs."""
    used: set = set()
    out = []
    for entry in spec:
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        keep = tuple(a for a in axes if a not in used)
        used.update(keep)
        out.append(keep if len(keep) > 1 else keep[0] if keep else None)
    return P(*out)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Meta-device stand-ins for every model input (the reference's
    ``Model.input_specs(shape, abstract=True)``)."""
    B, S = shape.global_batch, shape.seq_len

    def mk(s, d):
        return torch.empty(s, dtype=d, device="meta")

    fe = (B, cfg.frontend_tokens, cfg.d_model)
    if shape.kind == "train":
        if cfg.is_encdec:
            return {"tokens": mk((B, S), torch.int32), "labels": mk((B, S), torch.int32),
                    "frontend": mk(fe, compute_dtype)}
        s_text = S - (cfg.frontend_tokens if cfg.frontend else 0)
        batch = {"tokens": mk((B, s_text), torch.int32), "labels": mk((B, s_text), torch.int32)}
        if cfg.frontend is not None:
            batch["frontend"] = mk(fe, compute_dtype)
        return batch
    if shape.kind == "prefill":
        s_text = S if cfg.is_encdec else S - (cfg.frontend_tokens if cfg.frontend else 0)
        batch = {"tokens": mk((B, s_text), torch.int32)}
        if cfg.frontend is not None:
            batch["frontend"] = mk(fe, compute_dtype)
        return batch
    # decode: one new token against a ctx_len cache
    return {"token": mk((B, 1), torch.int32), "pos": mk((), torch.int32)}


def _long(batch: dict) -> dict:
    return {k: v if v.is_floating_point() else v.long() for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------


def make_train_bundle(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    plan: shlib.PlanConfig,
    opt_cfg: AdamWConfig | None = None,
    param_dtype=torch.bfloat16,
    remat: str = "full",
    scan_layers: bool = True,
    device_type: str = "cuda",
) -> StepBundle:
    """The training step ``step_fn(params, opt_state, batch) -> (params,
    opt_state, metrics)``: :func:`repro_torch.launch.train.make_step`'s
    semantics on DTensors (the loss, its gradients by autograd, the AdamW
    update in place, the gradient norm over every shard).  ``metrics``
    holds ``loss``, ``ce``, ``lr`` and ``grad_norm`` as full 0-d tensors."""
    _check_mesh(mesh, device_type)
    opt_cfg = opt_cfg or AdamWConfig()
    model = _meta_model(cfg, param_dtype, remat)
    rules = shlib.make_rules(cfg, shape, plan)
    pspecs = _name_specs(cfg, rules)
    batch_abs = input_specs(cfg, shape, param_dtype)
    bspecs = shlib.batch_specs(batch_abs, rules)

    def train_step(params: dict, opt_state: dict, batch: dict):
        batch = _long({k: _place(v, bspecs[k], mesh) for k, v in batch.items()})
        with axis_rules(rules):
            for p in params.values():
                p.grad = None

            def loss_and_backward(m: Model):
                loss, metrics = m.loss_fn(batch)
                loss = _whole(loss)
                loss.backward()
                return loss, metrics

            loss, metrics = _call(model, params, loss_and_backward)
            grads = {}
            for n, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
                    g = g.redistribute(p.device_mesh, p.placements)
                grads[n] = g
            params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
            for p in params.values():
                p.grad = None
        metrics = {k: _whole(v).detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **om}

    abstract_p = {n: p for n, p in model.named_parameters()}
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[opt_cfg.moments_dtype]
    abstract_opt = {
        "step": torch.empty((), dtype=torch.int32, device="meta"),
        "m": {n: torch.empty_like(p, dtype=mdt) for n, p in abstract_p.items()},
        "v": {n: torch.empty_like(p, dtype=mdt) for n, p in abstract_p.items()},
    }
    if opt_cfg.use_master:
        abstract_opt["master"] = {n: torch.empty_like(p, dtype=torch.float32)
                                  for n, p in abstract_p.items()}
    return StepBundle(model, cfg, shape, plan, rules, train_step,
                      (abstract_p, abstract_opt, batch_abs), "train", mesh, pspecs)


def make_prefill_bundle(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    plan: shlib.PlanConfig,
    param_dtype=torch.bfloat16,
    remat: str = "full",
    scan_layers: bool = True,
    device_type: str = "cuda",
) -> StepBundle:
    """The prefill step ``step_fn(params, batch) -> (logits, caches)``: the
    model's ``forward_prefill`` on DTensors; the logits are the last
    position's (B, 1, V), the caches stacked along the period axis."""
    _check_mesh(mesh, device_type)
    model = _meta_model(cfg, param_dtype, remat)
    rules = shlib.make_rules(cfg, shape, plan)
    pspecs = _name_specs(cfg, rules)
    batch_abs = input_specs(cfg, shape, param_dtype)
    bspecs = shlib.batch_specs(batch_abs, rules)

    def prefill_step(params: dict, batch: dict):
        batch = _long({k: _place(v, bspecs[k], mesh) for k, v in batch.items()})
        with axis_rules(rules):
            return _call(model, params,
                         lambda m: m.forward_prefill(batch["tokens"], batch.get("frontend")))

    return StepBundle(model, cfg, shape, plan, rules, prefill_step,
                      (dict(model.named_parameters()), batch_abs), "prefill", mesh, pspecs)


def make_decode_bundle(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    plan: shlib.PlanConfig,
    param_dtype=torch.bfloat16,
    scan_layers: bool = True,
    device_type: str = "cuda",
) -> StepBundle:
    """The decode step ``step_fn(params, caches, token, pos) -> (logits,
    caches)``: one token (B, 1) at the shared position ``pos`` (an int or
    a 0-d tensor, as the model's ``forward_decode`` takes it) against
    caches of ``shape.seq_len`` positions (``Model.cache_struct``'s tree),
    placed with the plan's cache specs and returned."""
    _check_mesh(mesh, device_type)
    model = _meta_model(cfg, param_dtype, "none")
    rules = shlib.make_rules(cfg, shape, plan)
    crules = shlib.cache_rules(cfg, shape, plan)
    pspecs = _name_specs(cfg, rules)
    cache_abs = model.cache_struct(shape.global_batch, shape.seq_len, dtype=param_dtype)
    cspecs = shlib.cache_specs(cache_abs, cfg, rules, crules)
    batch_abs = input_specs(cfg, shape, param_dtype)
    bspecs = shlib.batch_specs(batch_abs, rules)

    def decode_step(params: dict, caches: dict, token: torch.Tensor, pos):
        caches = _map2(lambda t, s: _place(t, s, mesh), caches, cspecs)
        token = _place(token, bspecs["token"], mesh).long()
        with axis_rules(rules):
            return _call(model, params, lambda m: m.forward_decode(token, caches, int(pos)))

    return StepBundle(model, cfg, shape, plan, rules, decode_step,
                      (dict(model.named_parameters()), cache_abs, batch_abs["token"],
                       batch_abs["pos"]), "decode", mesh, pspecs)


def make_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: shlib.PlanConfig,
                **kw) -> StepBundle:
    if shape.kind == "train":
        return make_train_bundle(cfg, shape, mesh, plan, **kw)
    if shape.kind == "prefill":
        return make_prefill_bundle(cfg, shape, mesh, plan, **kw)
    return make_decode_bundle(cfg, shape, mesh, plan, **kw)


def _check_mesh(mesh, device_type: str) -> None:
    if mesh.device_type != device_type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the bundle asks for "
                         f"{device_type!r}")
