"""The four-card tool's parameter gate (``tools/sharded_multi_card.py``,
``classify_entries``), on the figures of the entries that defeated its
earlier gate.

The earlier gate held every entry to 1e-4 of its leaf's largest entry plus
2% of the steps' summed learning rate.  On four H100s it failed
seamless-m4t-large-v2 at three entries of ``encoder.blocks.0.mlp.w2``
whose clipped first-step gradients were 0.03–0.31 of Adam's eps (1e-8) in
both runs, the runs 2.29e-4 of the leaf's largest entry apart, 9.6% of the
summed lr (1.5e-4), moving the same way.  The gate now classes each entry
by that gradient: from 10 eps in both runs, 1e-4 of the leaf's largest
entry with no lr share (stricter); under it, at most the summed lr apart
(looser for those entries alone), the direction of the move counted but
not held: such a gradient's sign lies within the backward's rounding (on
four H100s hundreds of such entries moved the opposite ways by a few fp32
ulps while every other check held)."""
import importlib.util
import pathlib
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPS, CLIP, LR = 1e-8, 1.0, (5e-5, 1e-4)


def _tool():
    spec = importlib.util.spec_from_file_location("sharded_multi_card",
                                                  ROOT / "tools" / "sharded_multi_card.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def tool():
    return _tool()


OPT = types.SimpleNamespace(eps=EPS, clip_norm=CLIP)
LEAF_MAX = 0.0629          # the leaf's largest entry: 1.44e-5 is 2.29e-4 of it


def _leaf(grads_in_eps, gaps, moves=None):
    """A leaf of ``len(gaps)`` entries plus one at the leaf's largest:
    each entry's clipped first-step gradient (in eps, bundle's and
    make_step's), the two runs' gap, and make_step's move from the start
    (the bundle moves by move + gap)."""
    n = len(gaps)
    moves = moves or [-1.2e-4] * n
    start = torch.zeros(n + 1)
    want = torch.tensor(list(moves) + [LEAF_MAX])
    got = want + torch.tensor(list(gaps) + [0.0])
    g_b = torch.tensor([b * EPS for b, _ in grads_in_eps] + [1.0])
    g_m = torch.tensor([m * EPS for _, m in grads_in_eps] + [1.0])
    return got, want, start, (g_b, g_m), (0.5, 0.5)     # norms under clip: no scaling


SEAMLESS = [(0.03, 0.031), (0.17, 0.16), (0.31, 0.30)]   # the measured range, in eps
GAP = 2.29e-4 * LEAF_MAX                                  # 1.44e-5, 9.6% of the summed lr


def test_seamless_entries_fall_under_ten_eps_and_pass(tool):
    got, want, start, grads, norms = _leaf(SEAMLESS, [GAP] * 3)
    summary, failed = tool.classify_entries(got, want, start, grads, norms, OPT, sum(LR))
    assert summary["below"]["entries"] == 3
    assert summary["above"]["entries"] == 1                # the leaf's largest entry
    assert summary["ok"] and not failed.any()
    assert summary["below"]["max_gap_of_lr_sum"] == pytest.approx(GAP / sum(LR))
    # the earlier gate (1e-4 of the leaf's largest entry + 2% of the summed lr) failed them
    assert GAP > 1e-4 * LEAF_MAX + 0.02 * sum(LR)


def test_an_entry_at_a_hundred_eps_is_held_to_the_leaf_tolerance(tool):
    """At 100 eps the same gap fails: 1e-4 of the leaf's largest entry and
    no lr share, stricter than the earlier gate."""
    got, want, start, grads, norms = _leaf([(100.0, 100.0)], [GAP])
    summary, failed = tool.classify_entries(got, want, start, grads, norms, OPT, sum(LR))
    assert summary["above"]["entries"] == 2 and summary["below"]["entries"] == 0
    assert not summary["ok"] and failed[0]
    got, want, start, grads, norms = _leaf([(100.0, 100.0)], [0.9e-4 * LEAF_MAX])
    assert tool.classify_entries(got, want, start, grads, norms, OPT, sum(LR))[0]["ok"]


@pytest.mark.parametrize("grads_in_eps", [(0.2, 50.0), (50.0, 0.2), (9.9, 9.9)])
def test_an_entry_under_ten_eps_in_either_run_is_classed_below(tool, grads_in_eps):
    got, want, start, grads, norms = _leaf([grads_in_eps], [GAP])
    summary, _ = tool.classify_entries(got, want, start, grads, norms, OPT, sum(LR))
    assert summary["below"]["entries"] == 1 and summary["ok"]


def test_below_ten_eps_a_gap_over_the_summed_lr_or_an_opposite_move_fails(tool):
    """Under ten eps a gap over the summed lr fails; an opposite move
    within it no longer fails (the move's sign is the gradient's rounding)
    but is counted."""
    got, want, start, grads, norms = _leaf(SEAMLESS[:1], [1.01 * sum(LR)])
    summary, failed = tool.classify_entries(got, want, start, grads, norms, OPT, sum(LR))
    assert not summary["ok"] and failed[0]
    # make_step moved down by 1e-5, the bundle up by 4e-6: opposite moves
    got, want, start, grads, norms = _leaf(SEAMLESS[:1], [1.4e-5], moves=[-1e-5])
    summary, failed = tool.classify_entries(got, want, start, grads, norms, OPT, sum(LR))
    assert summary["below"]["opposite_moves"] == 1 and summary["ok"] and not failed.any()
    # and an opposite move over the summed lr fails on its gap
    got, want, start, grads, norms = _leaf(SEAMLESS[:1], [1.2 * sum(LR)], moves=[-1e-5])
    summary, failed = tool.classify_entries(got, want, start, grads, norms, OPT, sum(LR))
    assert summary["below"]["opposite_moves"] == 1 and not summary["ok"] and failed[0]


def test_the_clip_scales_the_gradients_before_they_are_classed(tool):
    """A raw gradient of 20 eps under a global norm of 4 (clip 1): 5 eps
    after the clip, so below ten."""
    got, want, start, (g_b, g_m), _ = _leaf([(20.0, 20.0)], [GAP])
    summary, _ = tool.classify_entries(got, want, start, (g_b, g_m), (4.0, 4.0), OPT, sum(LR))
    assert summary["below"]["entries"] == 1
