"""The Model: parameters built from the reference's parameter tables,
train, prefill and decode forward passes, the training loss, and decode
caches.

Weights keep the reference's (in, out) orientation (``x @ w``), and the
state dict names follow its parameter tree with the period axis unstacked:
``embed``, ``final_norm``, ``lm_head``, ``blocks.<i>.norm1``,
``blocks.<i>.attn.wq`` ... ``blocks.<i>.mlp.w2`` for ``("attn",)`` models,
and with the block key for longer patterns:
``blocks.<i>.b0_mamba.mamba.in_proj`` ... ``blocks.<i>.b3_attn.attn.wq``.
An MoE layer holds ``moe.router`` and ``moe.w1``/``w3``/``w2`` (the expert
axis first) where a dense one holds ``mlp``; an MLA layer ``attn.wq_down``,
``attn.q_norm`` ... ``attn.wo``; xLSTM blocks hold
``blocks.<i>.b0_mlstm.mlstm.up`` ... and ``blocks.<i>.b7_slstm.slstm.w_gates`` ...
An encoder-decoder model adds ``encoder.blocks.<i>.norm1`` ...
``encoder.blocks.<i>.mlp.w2``, ``encoder.final_norm`` and, per decoder
period, ``cross.<i>.norm`` and ``cross.<i>.attn.wq`` ... ``.wo``; a model
with a frontend adds ``frontend_proj``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import make_cache_struct
from .common import (
    add_rms_norm,
    count_params,
    embed_lookup,
    init_params,
    replicated_like,
    seq_whole,
    shard_act,
    take_along_last,
    vocab_parallel_cross_entropy,
    vocab_split,
)
from .frontends import apply_frontend_proj
from .ssm import mamba_state_struct, mlstm_state_struct, slstm_state_struct
from .transformer import (
    ParamModule,
    block_keys,
    decoder_defs,
    period_tree,
    run_decoder_stack,
    run_encoder_stack,
)

#: Weights of the MoE aux losses in the training loss, as the reference's.
LB_LOSS_WEIGHT, Z_LOSS_WEIGHT = 0.01, 0.001


class Model(nn.Module):
    """An LM of attention (GQA or MLA) and Mamba blocks, each with a dense
    SwiGLU MLP or an MoE feed-forward, and of mLSTM and sLSTM blocks, in
    periods of ``cfg.pattern()``:
    decoder-only, decoder-only behind a
    modality frontend's tokens (``cfg.frontend``), or encoder-decoder
    (``cfg.is_encdec``: a bidirectional encoder over the frontend's frames,
    read by a cross-attention sub-block in every decoder period).

    ``params`` is the reference-shaped tree of tensors (block leaves stacked
    along the period axis), as :func:`~.common.init_params` makes it; each
    period's parameters are views of the stacked tensors, so building the
    model copies nothing.  The parameters are built without gradients,
    for serving; :meth:`trainable` turns them on in place.  Serving runs
    under ``torch.no_grad()`` either way.
    """

    #: "full" recomputes each block in the training backward
    #: (``torch.utils.checkpoint``); "none" keeps every activation.
    remat = "none"

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for name, value in params.items():
            if name not in ("blocks", "encoder", "cross"):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
        stacked = period_tree(cfg, params["blocks"])
        self.blocks = nn.ModuleList(
            ParamModule(_tree_index(stacked, i)) for i in range(cfg.n_periods())
        )
        self.encoder = self.cross = None
        if cfg.is_encdec:
            enc = params["encoder"]
            self.encoder = ParamModule({"final_norm": enc["final_norm"]})
            self.encoder.blocks = nn.ModuleList(
                ParamModule(_tree_index(enc["blocks"]["b0_attn"], i))
                for i in range(cfg.enc_layers)
            )
            self.cross = nn.ModuleList(
                ParamModule(_tree_index(params["cross"], i)) for i in range(cfg.n_periods())
            )

    def n_params(self) -> int:
        return count_params(decoder_defs(self.cfg))

    def trainable(self) -> "Model":
        """Turns gradients on for every parameter, in place: each stays the
        view of its stacked tensor that it was built as, so training keeps
        serving's memory, and an optimizer writing into the parameters
        writes into those tensors."""
        for p in self.parameters():
            p.requires_grad_(True)
        return self

    # -- embedding / head ----------------------------------------------------
    def _head(self, x: torch.Tensor) -> torch.Tensor:
        w = self.lm_head if hasattr(self, "lm_head") else self.embed.T
        logits = seq_whole(x) @ w
        if self.cfg.padded_vocab != self.cfg.vocab:
            # mask padded vocabulary rows out of the softmax
            valid = torch.arange(self.cfg.padded_vocab, device=x.device) < self.cfg.vocab
            logits = logits.masked_fill(replicated_like(~valid, logits), -1e9)
        return shard_act(logits, ("act_batch", None, "act_vocab"))

    def _assemble_inputs(self, tokens: torch.Tensor, frontend: torch.Tensor | None):
        """Token embeddings, behind the projected frontend tokens for a
        decoder-only model with a frontend; and their positions (B, S).
        DTensor halves are brought to one layout before they are joined."""
        x = embed_lookup(self.embed, tokens)
        if self.cfg.frontend is not None and not self.cfg.is_encdec:
            fe = apply_frontend_proj(self.frontend_proj, frontend.to(x.dtype))
            # the projection may come out split over d, the lookup not
            whole = ("act_batch", None, None)
            x = torch.cat([shard_act(fe, whole), shard_act(x, whole)], dim=1)
        x = shard_act(x, ("act_batch", "act_seq", None))
        B, S, _ = x.shape
        return x, replicated_like(torch.arange(S, device=x.device).expand(B, S), x)

    def _check_frontend(self, frontend) -> None:
        if (frontend is None) != (self.cfg.frontend is None):
            raise ValueError(f"{self.cfg.name}: frontend embeddings are "
                             f"{'required' if frontend is None else 'not taken'}")

    def _encode(self, frontend: torch.Tensor | None, mode: str):
        """The encoder's output over the frontend's frames for an
        encoder-decoder model, else None; a "train" encoder recomputes its
        layers in the backward under ``remat="full"``."""
        if not self.cfg.is_encdec:
            return None
        enc_in = apply_frontend_proj(self.frontend_proj, frontend.to(self.embed.dtype))
        return run_encoder_stack(self.encoder, enc_in, self.cfg, mode, self.remat)

    # -- forward passes ------------------------------------------------------
    def forward_train(self, tokens: torch.Tensor, frontend: torch.Tensor | None = None):
        """Causal forward over every position, with no caches built (the
        reference's ``forward_train``).  Returns (logits (B, S', V), aux):
        S' counts a decoder-only model's frontend tokens too, and ``aux``
        holds the MoE layers' ``lb_loss``, ``z_loss`` and ``dropped_frac``,
        summed over the layers (empty without MoE)."""
        cfg = self.cfg
        self._check_frontend(frontend)
        enc_out = self._encode(frontend, "train")
        x, positions = self._assemble_inputs(tokens, frontend)
        aux: dict = {}
        x, delta, _ = run_decoder_stack(self.blocks, x, cfg, "train", positions=positions,
                                        cross=self.cross, enc_out=enc_out, aux=aux,
                                        remat=self.remat)
        _, h = add_rms_norm(x, delta, self.final_norm, cfg.norm_eps)
        return self._head(h), aux

    def loss_fn(self, batch: dict):
        """Cross-entropy in fp32 over ``batch`` (``tokens``, ``labels``
        (B, S) and, for a model with a frontend, ``frontend``) of the
        logits at position t against ``labels[:, t + 1]``, plus 0.01 ×
        ``lb_loss`` and 0.001 × ``z_loss`` for an MoE model.  A
        decoder-only model with a frontend takes the loss over the text
        positions only.  Returns (loss, metrics): ``ce`` and the aux
        values.

        This is the reference's ``loss_fn`` as it stands.  Its labels
        shift once more on top of ``repro_torch.data.SyntheticLMStream``'s, whose
        ``labels`` are already the tokens shifted by one, so with that
        stream the objective is the token two positions ahead (ROADMAP
        queue 3, note n)."""
        cfg = self.cfg
        logits, aux = self.forward_train(batch["tokens"], batch.get("frontend"))
        if cfg.frontend is not None and not cfg.is_encdec:
            logits = logits[:, cfg.frontend_tokens:, :]
        logits, targets = logits[:, :-1, :], batch["labels"][:, 1:].long()
        if vocab_split(logits):
            # each rank reduces its vocabulary shard, as the reference's plan
            ce = vocab_parallel_cross_entropy(logits, targets).mean()
        else:
            # a plain tensor, or a vocab axis on one rank: the rows read whole
            logits = shard_act(logits, ("act_batch", None, None)).float()
            gold = take_along_last(logits, targets)
            ce = (torch.logsumexp(logits, dim=-1) - gold).mean()
        loss = ce
        if "lb_loss" in aux:
            loss = loss + LB_LOSS_WEIGHT * aux["lb_loss"] + Z_LOSS_WEIGHT * aux["z_loss"]
        return loss, {"ce": ce, **aux}

    @torch.no_grad()
    def forward_prefill(self, tokens: torch.Tensor, frontend: torch.Tensor | None = None):
        """Causal forward over ``tokens`` (B, S) that also builds the decode
        caches.  Returns the last position's logits (B, 1, V) and the caches,
        one entry per block of the period stacked along the period axis
        (``{"b0_attn": {"k": (P, B, S', KV, hd), "v": ...}}``, S' = S or the
        sliding window; ``{"b1_mamba": {"h": (P, B, di, N), "conv": ...}}``).

        A model with a frontend takes its embeddings ``frontend`` (B, T, d)
        and raises without them: an encoder-decoder model encodes them and
        adds ``"cross_kv"`` ``{"k": (P, B, T, KV, hd), "v": ...}`` to the
        caches; a decoder-only one prepends them to the tokens, so its
        caches and positions count T + S.

        An MLA model's caches are ``{"c_kv": (P, B, S, rank), "k_rope":
        (P, B, S, rope)}``; xLSTM blocks' are their states (``{"C", "n"}``,
        ``{"h", "c", "n", "m"}``).  The MoE layers' aux values are dropped,
        as the reference's serving drops them."""
        cfg = self.cfg
        self._check_frontend(frontend)
        enc_out = self._encode(frontend, "prefill")
        x, positions = self._assemble_inputs(tokens, frontend)
        x, delta, caches = run_decoder_stack(self.blocks, x, cfg, "prefill",
                                             positions=positions, cross=self.cross,
                                             enc_out=enc_out)
        _, h = add_rms_norm(x, delta, self.final_norm, cfg.norm_eps)
        return self._head(h[:, -1:, :]), caches

    @torch.no_grad()
    def forward_decode(self, token: torch.Tensor, caches: dict, pos: int):
        """One decode step: ``token`` (B, 1) at the shared position ``pos``.
        Writes the new K/V (or MLA latents) and recurrent states into ``caches``
        in place and returns (logits (B, 1, V), caches).  An
        encoder-decoder model's cross-attention reads
        ``caches["cross_kv"]``."""
        x = embed_lookup(self.embed, token)
        x, delta, caches = run_decoder_stack(self.blocks, x, self.cfg, "decode",
                                             caches=caches, positions=int(pos),
                                             cross=self.cross)
        _, h = add_rms_norm(x, delta, self.final_norm, self.cfg.norm_eps)
        return self._head(h), caches

    # -- caches ----------------------------------------------------------------
    def cache_struct(self, batch: int, ctx_len: int, dtype: torch.dtype | None = None) -> dict:
        """Start decode caches, stacked along the period axis, on the
        model's device: zero K/V caches for GQA blocks, ``c_kv`` (P, batch,
        ctx_len, rank) and ``k_rope`` (P, batch, ctx_len, rope) for MLA
        blocks, zero Mamba states (``h`` fp32, ``conv`` in ``dtype``), mLSTM
        states (``C``, ``n``, fp32 zeros) and sLSTM states (``h``, ``c``,
        ``n`` zeros and the stabiliser ``m`` at -1e30, fp32, as the
        reference's ``cache_struct(abstract=False)``), and for an
        encoder-decoder model the cross-attention K/V ``"cross_kv"`` of
        shape (P, batch, T, KV, hd), T the frontend's frames."""
        dtype = dtype or self.embed.dtype
        device = self.embed.device
        P = self.cfg.n_periods()
        caches = {}
        for key, kind in block_keys(self.cfg):
            if kind == "attn":
                one = make_cache_struct(self.cfg, batch, ctx_len, dtype, device)
            elif kind == "mamba":
                one = mamba_state_struct(self.cfg, batch, dtype, device)
            elif kind == "mlstm":
                one = mlstm_state_struct(self.cfg, batch, device)
            else:
                one = slstm_state_struct(self.cfg, batch, device)
            caches[key] = {n: t.expand(P, *t.shape).clone() for n, t in one.items()}
        if self.cfg.is_encdec:
            shape = (P, batch, self.cfg.frontend_tokens, self.cfg.n_kv_heads, self.cfg.head_dim)
            caches["cross_kv"] = {n: torch.zeros(shape, dtype=dtype, device=device)
                                  for n in ("k", "v")}
        return caches


def _tree_index(tree: dict, i: int) -> dict:
    return {k: _tree_index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def build_model(cfg: ModelConfig, *, device=None, dtype: torch.dtype = torch.float32,
                seed: int = 0) -> Model:
    """A :class:`Model` for ``cfg`` on ``device`` (``None`` means the CUDA
    card), its weights drawn from a ``torch.Generator`` on that device
    seeded with ``seed``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, init_params(decoder_defs(cfg), generator, dtype, device))
