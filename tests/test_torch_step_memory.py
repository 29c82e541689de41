"""What a sharded step holds, counted on fake process groups on the CPU
(``launch/dryrun.py``'s fake group and fake tensors, ``launch/counting.py``'s
counter).

- The counter leaves DTensor's sharding propagation out.  To learn an op's
  output layout DTensor runs the op, or its decomposition, on stand-ins of
  the global shape (``softplus_backward`` on meta tensors once for each
  candidate placement); no rank holds them.  Counted, softplus's backward
  at jamba-398b's train_4k cell made 336 GiB of a 414 GiB peak.  Here the
  same op on a DTensor counts no more than on the rank's plain shard, and
  jamba@smoke's train step makes no tensor of the Mamba block's whole
  inner width.
- Each block hands its update on as the reference lays out its stream,
  ``("act_batch", "act_seq", None)``: on a (1, 4) mesh every block's
  update is reduced and holds S/4 of the sequence, and so does every
  activation a block's checkpoint keeps under remat "full" (the update
  went whole and unreduced before, 1 GiB a block at jamba-398b's cell).

  On four gloo ranks ((2, 2) and (1, 4) meshes, ``tests/
  torch_step_memory_worker.py``) the train step's loss and gradients are
  bit for bit those of the same step with each update reduced by the next
  norm instead: the same reduce-scatter, moved.

Loss and gradients on gloo ranks against the reference are held in
``tests/test_torch_distributed.py`` (llama3-8b@smoke) and
``tests/test_torch_distributed_blocks.py`` (jamba@smoke).
"""
import contextlib
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.counting import StepCounter
from repro_torch.launch.dryrun import fake_process_group, placed_args
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.sharding import PlanConfig
from repro_torch.launch.steps import make_bundle
from repro_torch.models import model as model_module
from repro_torch.models import transformer

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: The ranks' limit and their process groups' timeout: at least three times
#: the worker's wall under the suite's load (25 s alone), so a slow run
#: finishes and a hang still fails.
LIMIT_S = 300
TP = 4
B, S = 4, 32
JAMBA, LLAMA = "jamba-1.5-large-398b@smoke", "llama3-8b@smoke"


class _Tracked(StepCounter):
    """A step counter that also keeps the shape and device of every
    storage it counts."""

    def __init__(self):
        super().__init__()
        self.tracked: list = []

    def _track(self, outs: list) -> None:
        self.tracked += [(tuple(t.shape), t.device.type) for t in outs]
        super()._track(outs)


def _count(fn) -> _Tracked:
    counter = _Tracked()
    with counter:
        fn()
    return counter


def _step(arch: str, kind: str, counter=None):
    """``arch``'s ``kind`` step on a (1, 4) ("data", "model") mesh of a fake
    group of four ranks, run once (under ``counter`` if given)."""
    with fake_process_group(TP):
        mesh = make_debug_mesh(1, TP, device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            bundle = make_bundle(get_config(arch), ShapeConfig(kind, S, B, kind), mesh,
                                 PlanConfig(tp=TP, dp=1), device_type="cpu")
            args = placed_args(bundle)
            with counter if counter is not None else contextlib.nullcontext():
                bundle.step_fn(*args)


# A shape no other test gives softplus, so DTensor's sharding caches are cold.
SOFTPLUS_SHAPE = (3, 24, 40)
PLACED = {"last axis": Shard(2), "sequence": Shard(1)}


@pytest.mark.parametrize("case", list(PLACED))
def test_softplus_backward_on_a_dtensor_counts_what_its_local_shard_counts(case):
    """``F.softplus(x)`` and its backward on a DTensor split over 'model'
    on a fake group of four ranks: the counter's peak and bytes are at
    most those of the same two ops on the rank's plain shard, and no
    storage it counts has the global shape (the decomposition DTensor runs
    to place softplus's backward made (3, 24, 40) meta tensors, and counted
    several times the local peak)."""
    shape = SOFTPLUS_SHAPE
    with fake_process_group(TP):
        mesh = make_debug_mesh(1, TP, device_type="cpu")
        placements = [Replicate(), PLACED[case]]
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = distribute_tensor(torch.empty(shape), mesh, placements,
                                  src_data_rank=None).requires_grad_(True)
            g = distribute_tensor(torch.empty(shape), mesh, placements, src_data_rank=None)
            sharded = _count(lambda: F.softplus(x).backward(g))
            xl = torch.empty(x.to_local().shape, requires_grad=True)
            gl = torch.empty(xl.shape)
            local = _count(lambda: F.softplus(xl).backward(gl))
    assert local.peak_bytes > 0 and local.bytes > 0
    assert sharded.peak_bytes <= local.peak_bytes
    assert sharded.bytes <= local.bytes
    assert sharded.flops == local.flops
    assert shape not in [s for s, _ in sharded.tracked], sharded.tracked
    assert sorted(sharded.tracked) == sorted(local.tracked)


def test_a_mamba_train_step_makes_no_tensor_of_the_whole_inner_width():
    """jamba@smoke's train step (Mamba and attention blocks, MoE) on a
    (1, 4) fake group: the Mamba inner width is split over 'model', so no
    storage the counter counts is (B, S, d_inner) with the whole width.
    DTensor's propagation of softplus's backward made 224 of them on the
    meta device, counted."""
    cfg = get_config(JAMBA)
    d_inner = cfg.ssm.expand * cfg.d_model
    counter = _Tracked()
    _step(JAMBA, "train", counter)
    assert counter.peak_bytes > 0
    whole = [(s, dev) for s, dev in counter.tracked if s == (B, S, d_inner)]
    assert whole == []
    assert not any(dev == "meta" for _, dev in counter.tracked)


def _sequence_shard(t) -> bool:
    """``t`` a (B, S, d) DTensor reduced and split over 'model' on its
    sequence (its batch on the one-rank 'data' dim): S/4 rows a rank."""
    return (isinstance(t, DTensor) and t.ndim == 3
            and tuple(t.placements) == (Shard(0), Shard(1))
            and tuple(t.to_local().shape) == (B, S // TP, t.shape[2]))


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", [LLAMA, JAMBA])
def test_every_block_hands_on_its_update_as_a_sequence_shard(monkeypatch, arch, kind):
    """Every block returns its update as the reference lays its stream out
    after a block: reduced, S/4 of the sequence a rank; so the update that
    reaches the final norm is one too.  (The blocks handed on a partial
    sum over 'model' of the whole sequence, which the next norm reduced.)"""
    updates, finals = [], []
    apply_block, run_stack = transformer.apply_block, model_module.run_decoder_stack

    def recorded_block(*args, **kwargs):
        out = apply_block(*args, **kwargs)
        updates.append(out[1])
        return out

    def recorded_stack(*args, **kwargs):
        out = run_stack(*args, **kwargs)
        finals.append(out[1])
        return out

    monkeypatch.setattr(transformer, "apply_block", recorded_block)
    monkeypatch.setattr(model_module, "run_decoder_stack", recorded_stack)
    _step(arch, kind)
    # (a train step's recompute of a block stops once it has remade what
    # the backward needs, before the block returns)
    assert len(updates) == get_config(arch).n_layers
    bad = [(tuple(u.placements), tuple(u.to_local().shape)) for u in updates
           if not _sequence_shard(u)]
    assert bad == []
    assert len(finals) == 1 and _sequence_shard(finals[0])


@pytest.mark.parametrize("arch", [LLAMA, JAMBA])
def test_every_block_checkpoint_keeps_sequence_shards(monkeypatch, arch):
    """Under remat "full" each block is a checkpoint whose inputs the train
    step keeps until the backward: the stream ``x`` and the previous
    block's update, each S/4 of the sequence a rank on a (1, 4) mesh (the
    update was kept whole and unreduced: 31 (65536, 4096) of them, 15.5 of
    llama3-8b's 22 GiB train_4k peak, at 16 x 16).  The positions, an int
    (B, S) table every rank makes whole, are the only other tensor."""
    kept = []
    checkpoint = transformer.checkpoint

    def recorded(fn, *args, **kwargs):
        kept.append([a for a in args if isinstance(a, torch.Tensor)])
        return checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(transformer, "checkpoint", recorded)
    _step(arch, "train")
    assert len(kept) == get_config(arch).n_layers
    for i, tensors in enumerate(kept):
        stream = [t for t in tensors if t.is_floating_point()]
        assert len(stream) == (1 if i == 0 else 2)          # x, and the update after block 0
        assert all(_sequence_shard(t) for t in stream), [
            (tuple(t.placements), tuple(t.to_local().shape)) for t in stream]
        rest = [t for t in tensors if not t.is_floating_point()]
        assert [tuple(t.shape) for t in rest] == [(B, S)]


def test_the_update_reduced_at_the_blocks_end_changes_no_value_on_gloo_ranks(tmp_path):
    """Four gloo ranks, llama3-8b@smoke and jamba@smoke, (2, 2) and (1, 4)
    meshes, remat "full": the train step's loss and every gradient are bit
    for bit the same whether each block's update is reduce-scattered at the
    block's end or, as before, by the next norm."""
    (tmp_path / "meta.json").write_text(json.dumps({"limit_s": LIMIT_S}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    started = time.monotonic()
    ranks = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_step_memory_worker.py"),
                              str(tmp_path)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = ranks.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(ranks.pid, signal.SIGKILL)
        log, _ = ranks.communicate()
        pytest.fail(f"the ranks did not finish within {LIMIT_S} s "
                    f"({time.monotonic() - started:.0f} s):\n{log[-4000:]}")
    finally:
        if ranks.poll() is None:
            os.killpg(ranks.pid, signal.SIGKILL)
    assert ranks.returncode == 0, log[-6000:]
    got = json.loads((tmp_path / "results.json").read_text())
    assert sorted(got) == sorted(f"{a}/{m}" for a in (LLAMA, JAMBA) for m in ("2x2", "1x4"))
    for case, r in got.items():
        assert r["n_grads"] > 0, case
        assert r["loss"][0] == r["loss"][1], (case, r["loss"])
        assert r["grads_bitwise"] and r["grad_max_abs_diff"] == 0.0, (case, r)
