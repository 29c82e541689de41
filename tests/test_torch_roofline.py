"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's on the CPU.  The port carries the H100 SXM's rates where the
reference carries the TPU's, so the parity tests first put the port's
three rates on ``repro.launch.roofline`` (``monkeypatch``); then both give
the same row from the same dry-run report, field for field, but
``fits_hbm``, which the port holds to the card's 80 GB (the reference's
16 GiB is a literal).  The calibration from 1 and 2 periods is held to a
3-period count on a fake group (a subprocess), and the rows to what
``LMWorkloadModel.from_roofline`` and ``examples/allocate_lm.py`` read."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import pytest

import repro.launch.roofline as ref_roofline
import repro_torch.core.lm_bridge as port_bridge
import repro_torch.launch.roofline as port_roofline
from repro_torch.configs import SHAPES

ROOT = pathlib.Path(__file__).resolve().parents[1]
RATES = ("PEAK_FLOPS", "HBM_BW", "ICI_BW")


@pytest.fixture
def same_rates(monkeypatch):
    for name in RATES:
        monkeypatch.setattr(ref_roofline, name, getattr(port_roofline, name))


def _report(arch, shape, mesh, scale=1.0, peak=3.0 * 2**30, args=5.0 * 2**30):
    return {"arch": arch, "shape": shape, "mesh": mesh, "ok": True, "error": "",
            "compile_seconds": 1.0, "flops": 3.1e14 * scale, "hlo_bytes": 2.2e12 * scale,
            "peak_bytes_per_device": peak, "argument_bytes": args, "output_bytes": args,
            "collectives": {"all-gather": 4.0e10 * scale, "reduce-scatter": 3.0e9 * scale,
                            "all-reduce": 1.0e6 * scale},
            "n_params": 0, "notes": ""}


CELLS = [("llama3-8b", "train_4k", "16x16", 1.0), ("olmoe-1b-7b", "decode_32k", "2x16x16", 1e-4),
         ("jamba-1.5-large-398b", "prefill_32k", "16x16", 3.0),
         ("xlstm-1.3b", "long_500k", "16x16", 1e-5), ("seamless-m4t-large-v2", "train_4k",
                                                      "2x16x16", 0.2)]


@pytest.mark.parametrize("arch, shape, mesh, scale", CELLS)
def test_analyze_cell_equals_reference(same_rates, arch, shape, mesh, scale):
    rep = _report(arch, shape, mesh, scale)
    got = dataclasses.asdict(port_roofline.analyze_cell(rep, calibrate=False))
    want = dataclasses.asdict(ref_roofline.analyze_cell(rep, calibrate=False))
    for key in ("fits_hbm", "notes"):
        got.pop(key), want.pop(key)
    assert got == want


def test_rates_are_the_h100_sxm_data_sheet_figures_and_the_bridges():
    assert (port_roofline.PEAK_FLOPS, port_roofline.HBM_BW, port_roofline.ICI_BW) == (
        989e12, 3.35e12, 450e9)
    assert (port_roofline.PEAK_FLOPS, port_roofline.HBM_BW, port_roofline.ICI_BW) == (
        port_bridge.PEAK_FLOPS, port_bridge.HBM_BW, port_bridge.ICI_BW)
    assert port_roofline.HBM_BYTES == 80e9
    # the reference keeps the TPU's
    assert (ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW, ref_roofline.ICI_BW) == (
        197e12, 819e9, 50e9)


@pytest.mark.parametrize("peak, args, fits", [
    (40e9, 40e9 - 1, True), (40e9, 40e9, False), (20 * 2**30, 10 * 2**30, True),
    (70e9, 11e9, False)])
def test_fits_hbm_is_the_cards_80_gb(peak, args, fits):
    """80 GB of HBM on the H100, where the reference holds a cell to 16
    GiB: 30 GiB a device fits the card and not the TPU."""
    rep = _report("llama3-8b", "decode_32k", "16x16", peak=peak, args=args)
    assert port_roofline.analyze_cell(rep, calibrate=False).fits_hbm is fits
    if peak + args == 30 * 2**30:
        assert not ref_roofline.analyze_cell(rep, calibrate=False).fits_hbm


@pytest.mark.parametrize("mesh, chips", [("16x16", 256), ("2x16x16", 512), ("1x1", 1),
                                         ("2x2", 4)])
def test_mesh_chips(mesh, chips):
    assert port_roofline.mesh_chips(mesh) == chips
    row = port_roofline.analyze_cell(_report("stablelm-1.6b", "train_4k", mesh), calibrate=False)
    assert row.chips == chips
    assert row.flops_total == 3.1e14 * chips
    assert row.t_compute == pytest.approx(3.1e14 / 989e12)


@pytest.mark.parametrize("arch, shape, mesh, scale", CELLS)
def test_rows_feed_the_lm_bridge(arch, shape, mesh, scale):
    """``from_roofline`` takes a row's JSON record as ``allocate_lm.py``
    reads it, and the bridge's step time is the row's terms."""
    row = port_roofline.analyze_cell(_report(arch, shape, mesh, scale), calibrate=False)
    record = json.loads(json.dumps(dataclasses.asdict(row)))
    wl = port_bridge.LMWorkloadModel.from_roofline(types.SimpleNamespace(**record))
    assert wl.chips_measured == row.chips
    cell = SHAPES[shape]
    tokens = cell.tokens if cell.kind != "decode" else cell.global_batch
    st = wl.stages[0]
    assert st.flops_per_token * tokens == pytest.approx(row.flops_total, rel=1e-12)
    assert st.coll_bytes_per_token * tokens == pytest.approx(row.coll_bytes_total, rel=1e-12)
    assert wl.tokens_per_second(tokens, row.chips) > 0


def test_main_writes_single_pod_rows_of_the_ok_reports(tmp_path):
    """By default ``main`` takes the reports' counts as they are (no fake
    group, no recount)."""
    reports = tmp_path / "dry"
    reports.mkdir()
    for name, rep in {"a": _report("llama3-8b", "train_4k", "16x16"),
                      "b": _report("llama3-8b", "train_4k", "2x16x16"),
                      "c": dict(_report("mixtral-8x7b", "decode_32k", "16x16"), ok=False)}.items():
        (reports / f"{name}.json").write_text(json.dumps(rep))
    out = tmp_path / "rows" / "roofline.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dryrun-dir",
                           str(reports), "--out", str(out)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["mesh"]) for r in rows] == [("llama3-8b", "16x16")]
    assert set(rows[0]) == {f.name for f in dataclasses.fields(port_roofline.RooflineRow)}
    assert {f.name for f in dataclasses.fields(port_roofline.RooflineRow)} == {
        f.name for f in dataclasses.fields(ref_roofline.RooflineRow)}


_CALIBRATION = """
    import dataclasses, json, sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_module, roofline
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_debug_mesh

    # a 3-period llama3-8b@smoke on a (2, 2) mesh, as the production cell
    base = configs.get_config("llama3-8b@smoke")
    three = dataclasses.replace(base, n_layers=3 * len(base.pattern()))
    configs.get_config = lambda arch: three
    configs.SHAPES["train_4k"] = ShapeConfig("train_4k", 32, 4, "train")
    mesh_module.make_production_mesh = lambda multi_pod=False, device_type="cuda": \\
        make_debug_mesh(2, 2, device_type=device_type)
    overrides = {"tp": 2, "dp": 2}
    with fake_process_group(4):
        carried = roofline.calibrated_totals("x", "train_4k", False, overrides, "cpu")
        direct = roofline._measure_depth("x", "train_4k", False, 3, overrides, "cpu")
    print(json.dumps({"carried": carried, "direct": direct}))
"""


def test_extrapolation_is_exact_and_keeps_every_key():
    """The one depth extrapolation (dry run and roofline): exact rationals,
    nested dicts key by key, a key missing at one depth taken as 0, and a
    falling count left as it comes (no clamp)."""
    from repro_torch.launch.dryrun import extrapolate

    one = {"flops": 3.0, "coll": {"all-gather": 10.0, "all-reduce": 5.0}}
    two = {"flops": 5.0, "coll": {"all-gather": 13.0, "reduce-scatter": 1.0}}
    assert extrapolate([one, two], (1, 2), 40) == {
        "flops": 81.0, "coll": {"all-gather": 127.0, "all-reduce": -190.0,
                                "reduce-scatter": 39.0}}
    assert extrapolate([1e15 + 1, 2e15 + 3], (1, 2), 10**6) == float(10**21 + 1_999_999)


def test_calibration_from_one_and_two_periods_equals_a_three_period_count():
    """The reference's extrapolation, F(1) + 2·(F(2) − F(1)), on the port's
    eager counts: exact, as a period adds the same ops."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_CALIBRATION)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["carried"]["flops"] == res["direct"]["flops"] > 0
    assert res["carried"]["bytes"] == res["direct"]["bytes"]
    assert res["carried"]["coll"] == res["direct"]["coll"]
