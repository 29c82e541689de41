"""Carrying learned state and data into the port from plain Python and numpy.

Nothing here reads the reference package's objects: its node models arrive
as the dicts ``dataclasses.asdict`` makes of them, and padded structures as
dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.node_model import LinearFit, NodeModel, ResourceClass
from .kernels.stream_flow.ops import index_dtype


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
