"""The vocabulary-parallel training loss (``models/common.py::
vocab_parallel_cross_entropy``, called by ``Model.loss_fn`` where the logits'
vocabulary axis is split over a mesh dim of more than one rank).

- On one shard with no group to reduce over, its cross-entropy and its
  hand-written backward equal ``logsumexp - gather`` under autograd, with
  the padded vocabulary's ``-1e9`` columns, in fp32 and bf16.
- On a fake process group (``launch/dryrun.py``'s, fake tensors) of a
  (1, 4) ``("data", "model")`` mesh, llama3-8b@smoke's train step with its
  vocabulary cut to 1,000 tokens (1,024 padded, 256 a rank, wider than any
  other axis of the model) makes no tensor wider than a rank's 256
  vocabulary columns, where the loss that gathers the vocabulary makes
  (B, S - 1, 1,024) ones; it counts the same FLOPs as that loss, its
  all-reduce bytes grow by exactly three fp32 row vectors (the max, the
  sum of exponentials and the gold logit), and its peak is lower.
- A (4, 1) mesh, whose 'model' dim is one rank, keeps the gathered loss.

The loss and gradients on gloo ranks against the gathered loss and the
reference are in ``tests/test_torch_distributed.py``, whose four ranks
run them.
"""
import dataclasses

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import counting
from repro_torch.launch.counting import StepCounter
from repro_torch.launch.dryrun import fake_process_group, placed_args
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.sharding import PlanConfig
from repro_torch.launch.steps import make_bundle
from repro_torch.models import common
from repro_torch.models import model as model_module

VOCAB = 1000                      # padded to 1,024: 256 columns on each of 4 ranks
SHAPE = ShapeConfig("train", 32, 4, "train")


def _cfg():
    cfg = dataclasses.replace(get_config("llama3-8b@smoke"), vocab=VOCAB)
    # no other axis of the model or the batch reaches a rank's columns
    widest = max(cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim, SHAPE.seq_len)
    assert widest < cfg.padded_vocab // 4 < cfg.padded_vocab
    return cfg


class _WidthRecorder(StepCounter):
    """A step counter that also keeps every op output wider than
    ``limit`` in its last axis (two or more axes), by op and shape."""

    def __init__(self, limit: int):
        super().__init__()
        self.limit = limit
        self.wide: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or counting._HIDDEN[0]:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.ndim >= 2 and t.shape[-1] > self.limit:
                self.wide.append((func._opname, tuple(t.shape)))
        return out


def _count_step(monkeypatch, mesh_shape, gathered=False, limit=None):
    """The train step of ``_cfg()`` on a fake group of four ranks and a
    ``mesh_shape`` (data, model) mesh, counted on rank 0; ``gathered``
    takes the loss that gathers the vocabulary whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if gathered:
        monkeypatch.setattr(model_module, "vocab_split", lambda logits: False)
    calls = [0]
    split_ce = model_module.vocab_parallel_cross_entropy

    def counted(*args):
        calls[0] += 1
        return split_ce(*args)

    monkeypatch.setattr(model_module, "vocab_parallel_cross_entropy", counted)
    dp, tp = mesh_shape
    with fake_process_group(4):
        mesh = make_debug_mesh(dp, tp, device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            bundle = make_bundle(_cfg(), SHAPE, mesh, PlanConfig(tp=tp, dp=dp),
                                 device_type="cpu")
            args = placed_args(bundle)
            counter = _WidthRecorder(limit if limit is not None else 1 << 62)
            with counter:
                bundle.step_fn(*args)
    monkeypatch.undo()
    return counter, calls[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_shard_cross_entropy_and_backward_equal_autograd(dtype):
    """With no group to reduce over (the whole vocabulary on one shard),
    the rows' cross-entropy and the hand-written backward equal
    ``logsumexp(x) - x[target]`` in fp32 under autograd: loss rel 1e-6,
    the gradient within 1e-6 of its largest entry, plus one ulp of the
    dtype where bf16 rounds it."""
    g = torch.Generator().manual_seed(0)
    rows, V, pad = (3, 7), 136, 8
    x = (3 * torch.randn(*rows, V, generator=g)).to(dtype)
    x[..., V - pad:] = -1e9                     # the padded vocabulary, masked
    targets = torch.randint(0, V - pad, rows, generator=g)
    upstream = torch.rand(*rows, generator=g)

    got_x = x.clone().requires_grad_(True)
    got = common._VocabParallelCE.apply(got_x, targets, 0, [])
    (got * upstream).sum().backward()
    want_x = x.clone().requires_grad_(True)
    xf = want_x.float()
    want = torch.logsumexp(xf, -1) - torch.gather(xf, -1, targets[..., None])[..., 0]
    (want * upstream).sum().backward()

    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=0.0)
    assert got_x.grad.dtype == dtype
    w = want_x.grad.float()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got_x.grad.float(), w, rtol=ulp,
                               atol=1e-6 * float(w.abs().max()))


def test_no_step_tensor_holds_more_than_a_rank_of_vocabulary_columns(monkeypatch):
    """On a (1, 4) mesh each rank's logits, their fp32 copies and their
    gradient are (B, S - 1, V/4): no op of the step outputs a wider last
    axis.  The gathered loss makes (B, S - 1, V) tensors, which the
    recorder sees (the check can fail)."""
    V = _cfg().padded_vocab
    split, calls = _count_step(monkeypatch, (1, 4), limit=V // 4)
    assert calls == 1
    assert split.wide == [], split.wide[:8]
    gathered, calls = _count_step(monkeypatch, (1, 4), gathered=True, limit=V // 4)
    assert calls == 0
    assert any(shape[-1] == V for _, shape in gathered.wide), gathered.wide[:8]


def test_split_loss_counts_the_same_flops_three_row_all_reduces_and_a_lower_peak(
        monkeypatch):
    """The split loss adds no FLOPs the counter prices, all-reduces three
    fp32 vectors of the rank's rows (B (S - 1) each; its batch is whole on
    a one-rank 'data' dim) and gathers no logits, so the step's peak falls."""
    split, _ = _count_step(monkeypatch, (1, 4))
    gathered, _ = _count_step(monkeypatch, (1, 4), gathered=True)
    rows = SHAPE.global_batch * (SHAPE.seq_len - 1)
    assert split.flops == gathered.flops
    assert (split.collectives["all-reduce"] - gathered.collectives["all-reduce"]
            == 3 * rows * 4)
    V = _cfg().padded_vocab
    bf16 = 2
    assert (gathered.collectives["all-gather"] - split.collectives["all-gather"]
            >= rows * V * bf16)
    assert split.peak_bytes < gathered.peak_bytes


def test_a_one_rank_model_dim_keeps_the_gathered_loss(monkeypatch):
    """A (4, 1) mesh holds the whole vocabulary on each rank: the loss reads
    its rows whole, as a plain tensor's, and the split loss never runs."""
    _, calls = _count_step(monkeypatch, (4, 1))
    assert calls == 0
    assert not common.vocab_split(torch.zeros(2, 3))
