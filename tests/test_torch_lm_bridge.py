"""The port's LM bridge (``core/lm_bridge.py``) against the reference
package's on the CPU.  The port carries the H100's published rates where
the reference carries the TPU's, so every parity test first puts the
port's three constants on ``repro.core.lm_bridge`` (``monkeypatch``);
with the same constants both packages must give the same stages, DAGs,
node models, predictions and allocations, to the last bit (the same
Python float arithmetic in the same order).  A separate test pins the
port's constants to the H100 SXM data sheet."""
import dataclasses
import types

import pytest

import repro.core.lm_bridge as ref_bridge
import repro_torch.core.lm_bridge as port_bridge

CONSTANTS = ("PEAK_FLOPS", "HBM_BW", "ICI_BW")


@pytest.fixture
def same_constants(monkeypatch):
    for name in CONSTANTS:
        monkeypatch.setattr(ref_bridge, name, getattr(port_bridge, name))


def _stages(B):
    """Three stages: memory-, compute- and link-bound on the H100."""
    return [B.StageCost("embed", 1.0e6, 4.0e9, 0.0),
            B.StageCost("blocks", 2.0e13, 1.0e9, 1.0e8),
            B.StageCost("head", 1.0e9, 1.0e6, 4.0e9)]


def _model(B, stages=None):
    return B.LMWorkloadModel(arch="llama3-8b", shape="decode_32k",
                             stages=stages or _stages(B), chips_measured=8)


def _serve_lm(B):
    """``examples/serve_lm.py``'s llama3-8b decode model."""
    stage = B.StageCost("decode_step", flops_per_token=2 * 8.0e9,
                        hbm_bytes_per_token=8.0e9 * 2 / 128, coll_bytes_per_token=2.5e6)
    return B.LMWorkloadModel(arch="llama3-8b", shape="decode_32k", stages=[stage],
                             chips_measured=256)


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


def test_constants_are_the_h100_sxm_data_sheet_figures():
    assert port_bridge.PEAK_FLOPS == 989e12        # dense BF16 tensor cores
    assert port_bridge.HBM_BW == 3.35e12           # HBM3
    assert port_bridge.ICI_BW == 450e9             # NVLink 4, each way
    # the reference keeps the TPU's
    assert (ref_bridge.PEAK_FLOPS, ref_bridge.HBM_BW, ref_bridge.ICI_BW) == (197e12, 819e9, 50e9)


def test_stage_costs_match_reference(same_constants):
    for p, r in zip(_stages(port_bridge), _stages(ref_bridge)):
        assert _fields(p) == _fields(r)
        for prop in ("compute_s", "memory_s", "chip_s", "ici_s"):
            assert getattr(p, prop) == getattr(r, prop), prop
    bound = [max(("compute", s.compute_s), ("memory", s.memory_s), key=lambda kv: kv[1])[0]
             for s in _stages(port_bridge)]
    assert bound == ["memory", "compute", "compute"]
    assert _stages(port_bridge)[2].ici_s > _stages(port_bridge)[2].chip_s


def test_to_dag_matches_reference(same_constants):
    p, r = _model(port_bridge).to_dag(), _model(ref_bridge).to_dag()
    assert p.name == r.name
    assert [_fields(n) for n in p.nodes] == [_fields(n) for n in r.nodes]
    assert [(e.src, e.dst, e.grouping.value) for e in p.edges] == [
        (e.src, e.dst, e.grouping.value) for e in r.edges]


def test_node_models_match_reference(same_constants):
    p, r = _model(port_bridge).node_models(), _model(ref_bridge).node_models()
    assert list(p) == list(r)
    for name in p:
        got, want = _fields(p[name]), _fields(r[name])
        assert got.pop("resource_class").value == want.pop("resource_class").value
        assert got == want, name


@pytest.mark.parametrize("tokens,chips,overlap", [(128, 1, 0.0), (128, 8, 0.5), (4096, 64, 1.0),
                                                  (4, 1, 0.0)])
def test_step_seconds_and_bottleneck_match_reference(same_constants, tokens, chips, overlap):
    for build in (_model, _serve_lm):
        p, r = build(port_bridge), build(ref_bridge)
        assert p.step_seconds(tokens, chips, overlap) == r.step_seconds(tokens, chips, overlap)
        assert p.tokens_per_second(tokens, chips, overlap) == r.tokens_per_second(
            tokens, chips, overlap)
        assert p.bottleneck() == r.bottleneck()


@pytest.mark.parametrize("target", [1e4, 1e5, 1e6, 3.3e7])
@pytest.mark.parametrize("overprovision,max_chips", [(1.0, 65536), (1.3, 64)])
def test_allocate_chips_matches_reference(same_constants, target, overprovision, max_chips):
    for build in (_model, _serve_lm):
        p = port_bridge.allocate_chips(build(port_bridge), target, 128,
                                       overprovision=overprovision, max_chips=max_chips)
        r = ref_bridge.allocate_chips(build(ref_bridge), target, 128,
                                      overprovision=overprovision, max_chips=max_chips)
        assert _fields(p) == _fields(r)
        assert p.meets_target == r.meets_target
        assert p.chips & (p.chips - 1) == 0          # a power of two, as the reference rounds


def test_allocation_rounds_up_to_a_power_of_two():
    m = _serve_lm(port_bridge)
    per_tok = m.stages[0].chip_s + m.stages[0].ici_s
    exact = [port_bridge.allocate_chips(m, k / per_tok, 128).chips for k in (3, 5, 9, 17)]
    assert exact == [4, 8, 16, 32]


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k", "prefill_32k"])
def test_from_roofline_is_duck_typed_as_the_reference(same_constants, shape):
    """``examples/allocate_lm.py`` feeds a ``SimpleNamespace`` of a roofline
    record."""
    row = types.SimpleNamespace(arch="llama3-8b", shape=shape, flops_total=3.2e15,
                                bytes_total=6.4e12, coll_bytes_total=1.0e11, chips=256,
                                bottleneck="compute")
    p = port_bridge.LMWorkloadModel.from_roofline(row)
    r = ref_bridge.LMWorkloadModel.from_roofline(row)
    assert (p.arch, p.shape, p.chips_measured) == (r.arch, r.shape, r.chips_measured)
    assert [_fields(s) for s in p.stages] == [_fields(s) for s in r.stages]
    unknown = types.SimpleNamespace(**{**vars(row), "arch": "no-such-model"})
    for B in (port_bridge, ref_bridge):
        with pytest.raises(KeyError):
            B.LMWorkloadModel.from_roofline(unknown)
