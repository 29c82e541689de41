"""Carrying learned state and data into the port from plain Python and numpy.

Nothing here reads the reference package's objects: its node models arrive
as the dicts ``dataclasses.asdict`` makes of them, padded structures as
dicts of numpy arrays, and model parameters as nested dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.node_model import LinearFit, NodeModel, ResourceClass
from .kernels.stream_flow.ops import index_dtype
from .models.transformer import BLOCK_KINDS, period_tree


def node_models_from_state(states: Mapping[str, Mapping]) -> dict[str, NodeModel]:
    """The port's :class:`NodeModel`\\ s from per-node field dicts.

    ``states[name]`` holds a model's fields (``name``, ``cpu`` and ``cap``
    as dicts of :class:`LinearFit` fields, ``gamma``, ``gamma_r2``,
    ``mem_base_mb``, ``mem_slope_mb_per_ktps``, ``resource_class`` and
    optionally ``n_samples``).  ``resource_class`` may be the class's value
    (``"cpu"``) or any enum member carrying that value.
    """
    out: dict[str, NodeModel] = {}
    for key, st in states.items():
        rc = st["resource_class"]
        out[key] = NodeModel(
            name=st["name"],
            cpu=LinearFit(**st["cpu"]),
            cap=LinearFit(**st["cap"]),
            gamma=st["gamma"],
            gamma_r2=st["gamma_r2"],
            mem_base_mb=st["mem_base_mb"],
            mem_slope_mb_per_ktps=st["mem_slope_mb_per_ktps"],
            resource_class=ResourceClass(getattr(rc, "value", rc)),
            n_samples=st.get("n_samples", 0),
        )
    return out


def stage_padded(arrays: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A padded structure dict (one configuration's or a stacked batch's) as
    contiguous tensors on ``device``: floats as float32, booleans as bool,
    integers as the index type the flow step takes there
    (:func:`~repro_torch.kernels.stream_flow.ops.index_dtype`)."""
    device = torch.device(device)
    idx = index_dtype(device)
    out: dict[str, torch.Tensor] = {}
    for k, v in arrays.items():
        v = np.ascontiguousarray(v)
        if v.dtype == np.bool_:
            dtype = torch.bool
        elif np.issubdtype(v.dtype, np.integer):
            dtype = idx
        else:
            dtype = torch.float32
        out[k] = torch.as_tensor(v, device=device).to(dtype).contiguous()
    return out


def model_params_from_numpy(tree: Mapping, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The port's model state dict from a reference parameter tree.

    ``tree`` is the reference ``Model.init`` pytree as nested dicts of numpy
    arrays, its block leaves stacked along the period axis
    (``tree["blocks"]["b0_attn"]["attn"]["wq"]`` is (P, d, H·hd)).  The
    result unstacks them into per-period names, as
    :class:`repro_torch.models.Model` names its parameters:
    ``blocks.<i>.attn.wq`` for the ``("attn",)`` pattern, and with the block
    key for longer ones (``blocks.<i>.b0_mamba.mamba.in_proj``).  An
    encoder-decoder tree's encoder layers and per-period cross-attention
    unstack the same way (``encoder.blocks.<i>.attn.wq``,
    ``encoder.final_norm``, ``cross.<i>.norm``, ``cross.<i>.attn.wq``);
    ``frontend_proj`` is carried as it is.  MoE leaves (``moe.router``,
    ``moe.w1``/``w3``/``w2`` with their expert axis), MLA leaves
    (``attn.wq_down`` ... ``attn.wo``) and xLSTM leaves
    (``mlstm.up`` ... ``mlstm.down``, ``slstm.w_gates`` ... ``slstm.ff_down``)
    unstack along the period axis like any other.  Load it with
    ``model.load_state_dict``.  A block kind the port does not know raises
    ``ValueError``, and so does a leaf whose period count is not the
    config's.
    """
    def take(name: str, value, layer: int | None, n_layers: int) -> torch.Tensor:
        arr = np.asarray(value)
        if layer is not None:
            if arr.shape[0] != n_layers:
                raise ValueError(f"{name}: {arr.shape[0]} layers, config has {n_layers}")
            arr = arr[layer]
        return torch.from_numpy(np.array(arr, copy=True))

    return unstack_tree(tree, cfg, take)


def unstack_tree(tree: Mapping, cfg: ModelConfig, take) -> dict:
    """A tree shaped as the reference's parameter tree (block leaves stacked
    along the period axis), flattened to the port's parameter names as
    :func:`model_params_from_numpy` names them.  ``take(name, leaf, layer,
    n_layers)`` gives each name's entry: ``layer`` is the period (or
    encoder layer) of a stacked leaf, None for an unstacked one."""
    kinds = {key.split("_", 1)[1] for key in tree["blocks"]}
    if not kinds <= set(BLOCK_KINDS):
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(kinds - set(BLOCK_KINDS))}")
    n_periods = cfg.n_periods()
    out: dict = {}

    def walk(node: Mapping, prefix: str, layer: int | None, n_layers: int = n_periods) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.", layer, n_layers)
                continue
            out[f"{prefix}{key}"] = take(f"{prefix}{key}", value, layer, n_layers)

    for key, value in tree.items():
        if key == "encoder":
            walk({"final_norm": value["final_norm"]}, "encoder.", None)
            for i in range(cfg.enc_layers):
                walk(value["blocks"]["b0_attn"], f"encoder.blocks.{i}.", i, cfg.enc_layers)
        elif key == "cross":
            for i in range(n_periods):
                walk(value, f"cross.{i}.", i)
        elif key != "blocks":
            walk({key: value}, "", None)
    blocks = period_tree(cfg, tree["blocks"])
    for i in range(n_periods):
        walk(blocks, f"blocks.{i}.", i)
    return out
