"""Trevor-for-LM: the paper's model-based allocation applied to GPU
capacity: a host-side copy of the reference package's
``core/lm_bridge.py`` with the H100's published rates in place of the
TPU's.

The mapping, as in the reference:

* a training/serving step is a stream DAG — ``data → embed → L×block →
  head``,
* the collectives are the **stream managers**: a tensor resharded across
  cards pays link bandwidth on both ends exactly like a tuple crossing
  containers pays two stream managers,
* per-stage cost models are per-token FLOPs, device-memory bytes and
  collective bytes — the same linear models, a different sensor,
* the balanced-container allocator becomes: rate-match tensor-core seconds
  per token against link seconds and memory seconds per token, and
  replicate cards until the declared tokens/sec is met.

Declare a target token rate, get back (card count, predicted step time,
bottleneck) in closed form — fig. 2 of the paper, for serving and training
capacity.  :mod:`repro_torch.runtime.elastic` drives it online.

The names keep the reference's (``ICI_BW``, ``StageCost.ici_s``) so that
both packages answer to one interface; on the H100 the link is NVLink.
"""
from __future__ import annotations

import dataclasses
import math

from .dag import DagSpec, EdgeSpec, Grouping, NodeSpec
from .metrics import STREAM_MANAGER
from .node_model import LinearFit, NodeModel, ResourceClass

#: Dense BF16 tensor-core peak of one H100 SXM, FLOP/s (NVIDIA H100 Tensor
#: Core GPU data sheet, SXM column, without sparsity).  The reference's TPU
#: figure was 197e12.
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM, bytes/s (the same data sheet: 3.35 TB/s).
HBM_BW = 3.35e12
#: NVLink 4 bandwidth of one H100 SXM, bytes/s each way (the same data
#: sheet: 900 GB/s bidirectional over 18 links, so 450 GB/s per direction);
#: it takes the place of the TPU's ICI (50e9 in the reference).
ICI_BW = 450e9


@dataclasses.dataclass(frozen=True)
class StageCost:
    """Per-token cost of one pipeline stage on ONE card."""

    name: str
    flops_per_token: float
    hbm_bytes_per_token: float
    coll_bytes_per_token: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_token / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_token / HBM_BW

    @property
    def chip_s(self) -> float:
        """Card-busy seconds per token (max of the tensor-core and memory
        terms — they overlap)."""
        return max(self.compute_s, self.memory_s)

    @property
    def ici_s(self) -> float:
        """Link seconds per token (NVLink on the H100)."""
        return self.coll_bytes_per_token / ICI_BW


@dataclasses.dataclass
class LMWorkloadModel:
    """Learned per-stage model of one (arch × shape) cell."""

    arch: str
    shape: str
    stages: list[StageCost]
    chips_measured: int          # card count the costs were taken at

    @classmethod
    def from_roofline(cls, row, shape=None) -> "LMWorkloadModel":
        """Build from a roofline row (any object with ``arch``, ``shape``,
        ``flops_total``, ``bytes_total``, ``coll_bytes_total`` and
        ``chips``, e.g. a ``SimpleNamespace`` of a roofline JSON record):
        whole-step totals → one fused per-token stage, which is what the
        allocator's rate-matching point depends on.  ``shape`` (a
        ``ShapeConfig``) stands for a row whose shape is not one of
        ``SHAPES``."""
        from ..configs import SHAPES, get_config

        shape = shape or SHAPES[row.shape]
        get_config(row.arch)                     # an unknown arch raises
        tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
        stage = StageCost(
            name="step",
            flops_per_token=row.flops_total / tokens,
            hbm_bytes_per_token=row.bytes_total / tokens,
            coll_bytes_per_token=row.coll_bytes_total / tokens,
        )
        return cls(arch=row.arch, shape=row.shape, stages=[stage],
                   chips_measured=row.chips)

    # -- Trevor mapping ------------------------------------------------------
    def to_dag(self) -> DagSpec:
        """The step pipeline as a stream DAG: tuple = kilotoken."""
        nodes = []
        edges = []
        prev = None
        for i, st in enumerate(self.stages):
            # card-seconds per ktoken; γ=1 (every token flows through)
            nodes.append(
                NodeSpec(
                    st.name,
                    cpu_cost_per_ktuple=st.chip_s * 1e3,
                    gamma=1.0 if i < len(self.stages) - 1 else 0.0,
                    tuple_bytes=st.coll_bytes_per_token,
                    is_source=(i == 0),
                )
            )
            if prev is not None:
                edges.append(EdgeSpec(prev, st.name, Grouping.SHUFFLE))
            prev = st.name
        return DagSpec(f"lm:{self.arch}:{self.shape}", tuple(nodes), tuple(edges))

    def node_models(self) -> dict[str, NodeModel]:
        """Trevor node models: cards are 'instances', the link is the SM."""
        out: dict[str, NodeModel] = {}
        total_ici = sum(st.ici_s for st in self.stages)
        for i, st in enumerate(self.stages):
            cost = st.chip_s * 1e3  # busy-seconds per ktoken
            out[st.name] = NodeModel(
                name=st.name,
                cpu=LinearFit(cost, 0.0, 1.0, 0.0, 1e9),
                cap=LinearFit(cost, 0.0, 1.0, 0.0, 1e9),
                gamma=1.0 if i < len(self.stages) - 1 else 0.0,
                gamma_r2=1.0,
                mem_base_mb=0.0,
                mem_slope_mb_per_ktps=0.0,
                resource_class=ResourceClass.CPU_BOUND,
            )
        out[STREAM_MANAGER] = NodeModel(
            name=STREAM_MANAGER,
            cpu=LinearFit(max(total_ici, 1e-15) * 1e3, 0.0, 1.0, 0.0, 1e9),
            cap=LinearFit(max(total_ici, 1e-15) * 1e3, 0.0, 1.0, 0.0, 1e9),
            gamma=1.0,
            gamma_r2=1.0,
            mem_base_mb=0.0,
            mem_slope_mb_per_ktps=0.0,
            resource_class=ResourceClass.CPU_BOUND,
        )
        return out

    # -- predictions -----------------------------------------------------------
    def step_seconds(self, tokens: int, chips: int, overlap: float = 0.0) -> float:
        """Predicted wall time of one step on ``chips`` cards.

        ``overlap``∈[0,1]: fraction of collective time hidden under compute
        (0 = fully exposed, Trevor-conservative).  Per-card work scales
        1/chips; collectives scale with the per-card shard too (ring
        collectives move bytes/chips per link).
        """
        comp = sum(st.chip_s for st in self.stages) * tokens / chips
        coll = sum(st.ici_s for st in self.stages) * tokens / chips
        return comp + (1.0 - overlap) * coll

    def tokens_per_second(self, tokens: int, chips: int, overlap: float = 0.0) -> float:
        return tokens / self.step_seconds(tokens, chips, overlap)

    def bottleneck(self) -> str:
        comp = sum(st.compute_s for st in self.stages)
        mem = sum(st.memory_s for st in self.stages)
        coll = sum(st.ici_s for st in self.stages)
        return max(
            {"compute": comp, "memory": mem, "collective": coll}.items(),
            key=lambda kv: kv[1],
        )[0]


@dataclasses.dataclass
class LMAllocation:
    chips: int
    predicted_tokens_per_s: float
    predicted_step_s: float
    bottleneck: str
    target_tokens_per_s: float

    @property
    def meets_target(self) -> bool:
        return self.predicted_tokens_per_s >= self.target_tokens_per_s * 0.999


def allocate_chips(
    model: LMWorkloadModel,
    target_tokens_per_s: float,
    tokens_per_step: int,
    overlap: float = 0.0,
    overprovision: float = 1.0,
    max_chips: int = 65536,
) -> LMAllocation:
    """Closed-form Trevor allocation for the LM pipeline: the per-token
    card-seconds and link-seconds rate-match when every card is busy, so
    the card count follows directly.  It is then rounded up to the next
    power of two, the reference's semantics (the TPU slice granularity),
    kept as they are: a GPU deployment could take any count, but the port
    answers as the reference does."""
    target = target_tokens_per_s * overprovision
    per_tok = sum(st.chip_s for st in model.stages) + (1 - overlap) * sum(
        st.ici_s for st in model.stages
    )
    chips = max(1, math.ceil(per_tok * target))
    chips = min(1 << (chips - 1).bit_length(), max_chips)  # power-of-two granularity
    return LMAllocation(
        chips=chips,
        predicted_tokens_per_s=model.tokens_per_second(tokens_per_step, chips, overlap),
        predicted_step_s=model.step_seconds(tokens_per_step, chips, overlap),
        bottleneck=model.bottleneck(),
        target_tokens_per_s=target_tokens_per_s,
    )
