"""Config system: model architectures × input shapes.

Every assigned architecture is a :class:`ModelConfig` registered under its id
(``--arch <id>``); each has a reduced sibling (``<id>@smoke``) used by the CPU
smoke tests.  Input shapes are the four assignment-wide LM shape points.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (MiniCPM3 / DeepSeek-style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2          # mamba d_inner = expand * d_model
    chunk: int = 128         # chunked-scan block length
    # xLSTM (block-diagonal q/k/v per head, as in the reference impl)
    mlstm_proj_factor: float = 4.0 / 3.0
    slstm_ff_factor: float = 4.0 / 3.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # attention flavor
    attention: str = "gqa"   # gqa | mla
    sliding_window: int | None = None
    rope_theta: float = 10_000.0
    mla: MLAConfig | None = None
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int | None = None      # per-expert hidden dim (defaults to d_ff)
    moe_every: int = 1               # MoE on layers where (i % moe_every == moe_every-1)
    capacity_factor: float = 1.25
    moe_groups: int = 16             # dispatch groups (= data shards; §Perf iter 2)
    # block pattern for ssm/hybrid: tuple like ("mamba",)*3+("attn",) repeated
    block_pattern: tuple[str, ...] | None = None
    ssm: SSMConfig | None = None
    # encoder-decoder
    enc_layers: int = 0
    # modality frontend stub: None | "vit" | "audio"
    frontend: str | None = None
    frontend_tokens: int = 256       # patches/frames emitted by the stub
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    notes: str = ""

    def __post_init__(self) -> None:
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads must be divisible by n_kv_heads")
        if self.family in ("ssm", "hybrid") and self.block_pattern is None:
            raise ValueError(f"{self.name}: ssm/hybrid needs a block_pattern")
        if self.block_pattern is not None and self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(f"{self.name}: n_layers must be a multiple of the pattern")

    # -- derived -----------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a multiple of 128 so the vocab axis
        tiles evenly over tp=16 (and MXU lanes); logits at padded positions
        are masked to -inf before the softmax."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid recurrence or sliding-window
        attention (windowed KV cache => O(w) per decoded token)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def pattern(self) -> tuple[str, ...]:
        """Per-layer block kinds for one scan period."""
        if self.block_pattern is not None:
            return self.block_pattern
        return ("attn",)

    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern())

    # -- parameter counting (for 6ND roofline term) -------------------------
    def param_count(self) -> tuple[int, int]:
        """(total_params, active_params_per_token)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd

        def attn_params() -> int:
            if self.attention == "mla":
                m = self.mla or MLAConfig()
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                return (
                    d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                )
            return d * q + 2 * d * kv + q * d

        def dense_mlp() -> int:
            return 3 * d * ff  # SwiGLU

        def moe_mlp() -> int:
            return self.n_experts * 3 * d * self.expert_ff + d * self.n_experts

        def mamba_params() -> int:
            s = self.ssm or SSMConfig()
            di = s.expand * d
            # in_proj (x,z), conv, x_proj(dt,B,C), dt_proj, out_proj, A, D
            return (
                d * 2 * di + di * s.d_conv + di * (s.d_state * 2 + di // 16)
                + (di // 16) * di + di * d + di * s.d_state + di
            )

        def mlstm_params() -> int:
            s = self.ssm or SSMConfig()
            nh = max(self.n_heads, 1)
            di = ((int(s.mlstm_proj_factor * d) + nh - 1) // nh) * nh
            dh = di // nh
            # up (2 branches), block-diagonal q/k/v per head, gates, down
            return d * 2 * di + 3 * self.n_heads * dh * dh + 3 * di + di * d

        def slstm_params() -> int:
            s = self.ssm or SSMConfig()
            dh = d // self.n_heads
            rec = 4 * self.n_heads * dh * dh
            ffp = int(2 * d * d * s.slstm_ff_factor)
            return 4 * d * d + rec + ffp

        per_layer = []
        pat = self.pattern() * self.n_periods()
        for i, kind in enumerate(pat):
            p = 0
            if kind == "attn":
                p += attn_params()
                if self.is_moe and (i % self.moe_every == self.moe_every - 1):
                    p += moe_mlp()
                elif self.d_ff > 0:
                    p += dense_mlp()
            elif kind == "mamba":
                p += mamba_params()
                if self.is_moe and (i % self.moe_every == self.moe_every - 1):
                    p += moe_mlp()
                elif self.d_ff > 0:
                    p += dense_mlp()
            elif kind == "mlstm":
                p += mlstm_params()
            elif kind == "slstm":
                p += slstm_params()
            per_layer.append(p)
        body = sum(per_layer)
        emb = V * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encdec:
            # encoder self-attn + mlp, plus decoder cross-attn already in body? no:
            # decoder layers get an extra cross-attention block
            enc = self.enc_layers * (attn_params() + dense_mlp())
            body += self.n_layers * attn_params()  # cross-attn in each dec layer
        total = body + emb + enc

        active = total
        if self.is_moe:
            moe_layers = sum(
                1 for i in range(self.n_layers) if i % self.moe_every == self.moe_every - 1
            )
            inactive_fraction = (self.n_experts - self.experts_per_token) / self.n_experts
            active = total - moe_layers * int(moe_mlp() * inactive_fraction)
        return int(total), int(active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def register_smoke(name: str, fn: Callable[[], ModelConfig]) -> None:
    _SMOKE[name] = fn


def get_config(name: str) -> ModelConfig:
    if name.endswith("@smoke"):
        return _SMOKE[name.removesuffix("@smoke")]()
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def cell_is_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a defined cell; reason when skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md §4)"
    return True, ""
