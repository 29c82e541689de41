"""The batched LM server: slots of active requests, prefill into a slot's KV
cache, one batched greedy decode step per tick.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b@smoke \\
        --device cpu --requests 16 --max-new 24

Without ``--device`` the server runs on the CUDA card and raises where
there is none.  It keeps the reference server's semantics
(``repro/launch/serve.py``), quirks included, so both give the same tokens
from the same weights:

- every active slot decodes at one shared position, the largest of the
  active slots' positions (the "conservative" shared position);
- a prefill's K/V cache (an MLA block's ``c_kv`` and ``k_rope``) is
  padded with zeros to the slot's full length, and a recurrent block's
  state (Mamba's ``h`` and ``conv``, mLSTM's ``C`` and ``n``, sLSTM's
  ``h``, ``c``, ``n`` and ``m``) is copied whole;
- a model with a frontend prefills behind a batch of zero frontend
  embeddings (requests carry no frontend): an encoder-decoder model's
  encoder then sees zeros, and its ``cross_kv`` is inserted into the slot
  as the K/V caches are; a decoder-only model's prompt sits behind the
  ``frontend_tokens`` positions, which its position counts;
- every slot decodes on every tick, active or not, so an idle slot's
  recurrent state drifts until the next prefill into it overwrites it
  (from the start state ``cache_struct`` gives: zeros, an sLSTM's ``m``
  at -1e30);
- greedy decoding takes the first maximum;
- a request completes after ``max_new_tokens`` tokens or when its position
  reaches ``max_ctx - 1``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import build_model
from ..models.frontends import frontend_embed_shape


#: Cache entries with a sequence axis (axis 2 of the stacked cache), which
#: a prefill fills only up to its length: GQA and cross-attention K/V, and
#: MLA's latent and shared RoPE key.  Every other entry is a recurrent
#: state, copied whole (Mamba's ``h``, ``conv``; mLSTM's ``C``, ``n``;
#: sLSTM's ``h``, ``c``, ``n``, ``m``).
SEQUENCE_CACHES = ("k", "v", "c_kv", "k_rope")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int
    arrived: float = 0.0
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_s: float = float("nan")
    finished_s: float = float("nan")


class BatchedServer:
    """Static-batch continuous server: slots hold active requests; prefill
    admits new requests into free slots; one batched decode step advances
    every slot per tick.

    ``arch`` is a registered architecture name or a :class:`ModelConfig`
    (for instance one cut with ``dataclasses.replace``, which is served
    without registering it)."""

    def __init__(self, arch: str | ModelConfig, batch_slots: int = 4, max_ctx: int = 256,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = get_config(arch) if isinstance(arch, str) else arch
        self.model = build_model(self.cfg, device=self.device, dtype=torch.float32, seed=seed)
        self.slots: list[Request | None] = [None] * batch_slots
        self.max_ctx = max_ctx
        self.queue: deque[Request] = deque()
        self.caches = self.model.cache_struct(batch_slots, max_ctx, dtype=torch.float32)
        self.positions = np.zeros(batch_slots, np.int32)
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.completed: list[Request] = []
        self.decode_steps = 0

    # -- request intake ------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrived = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        for slot, cur in enumerate(self.slots):
            if cur is not None or not self.queue:
                continue
            req = self.queue.popleft()
            self._prefill_into_slot(slot, req)

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        S = len(req.prompt)
        tokens = torch.as_tensor(req.prompt[None, :].astype(np.int64), device=self.device)
        if self.cfg.frontend is None:
            logits, caches1 = self.model.forward_prefill(tokens)
        else:
            # the reference server's stand-in frontend: zero embeddings
            frontend = torch.zeros(frontend_embed_shape(self.cfg, 1), dtype=torch.float32,
                                   device=self.device)
            logits, caches1 = self.model.forward_prefill(tokens, frontend)
        offset = self.cfg.frontend_tokens if (
            self.cfg.frontend is not None and not self.cfg.is_encdec) else 0
        # copy the single-row caches into this slot of the batched caches:
        # K/V (cross_kv, MLA latents) zero-padded to the slot's length along
        # axis 2, recurrent states whole
        for key, layer in caches1.items():
            for name, small in layer.items():
                big = self.caches[key][name]              # (P, B, T, ...) for K/V
                if name not in SEQUENCE_CACHES:
                    big[:, slot] = small[:, 0]
                    continue
                T = small.shape[2]
                if T > big.shape[2]:
                    raise ValueError(f"a {S}-token prompt behind {offset} frontend tokens "
                                     f"does not fit max_ctx {self.max_ctx}")
                big[:, slot].zero_()
                big[:, slot, :T] = small[:, 0]
        next_tok = int(torch.argmax(logits[0, -1]))
        req.tokens_out.append(next_tok)
        req.first_token_s = time.perf_counter() - req.arrived
        self.slots[slot] = req
        self.positions[slot] = S + offset
        self.tokens[slot, 0] = next_tok

    # -- decode tick -----------------------------------------------------------
    def step(self) -> int:
        """One server tick: admit + one batched decode step.  Returns the
        number of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        pos = int(self.positions[active].max())  # conservative shared position
        token = torch.as_tensor(self.tokens.astype(np.int64), device=self.device)
        logits, self.caches = self.model.forward_decode(token, self.caches, pos)
        self.decode_steps += 1
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy().astype(np.int32)
        for i in active:
            req = self.slots[i]
            req.tokens_out.append(int(nxt[i]))
            self.tokens[i, 0] = int(nxt[i])
            self.positions[i] += 1
            if (len(req.tokens_out) >= req.max_new_tokens
                    or self.positions[i] >= self.max_ctx - 1):
                req.done = True
                req.finished_s = time.perf_counter() - req.arrived
                self.completed.append(req)
                self.slots[i] = None
        return len(active)

    def drain(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(s is None for s in self.slots):
                return
            self.step()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b@smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the host)")
    args = ap.parse_args()

    server = BatchedServer(args.arch, batch_slots=args.slots, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        prompt = rng.integers(4, server.cfg.vocab, size=rng.integers(8, 32))
        server.submit(Request(rid, prompt.astype(np.int32), args.max_new))
    server.drain()
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens_out) for r in server.completed)
    print(f"served {len(server.completed)} requests, {toks} tokens on {server.device} "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s, {server.decode_steps} decode steps)")


if __name__ == "__main__":
    main()
