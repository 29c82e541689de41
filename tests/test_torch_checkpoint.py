"""The port's checkpointer, controller checkpoints and fault-injection
runtime against the reference package on the CPU: the same layout on disk
(read across the packages both ways for fp32, fp64 and integer leaves),
torch tensors and bf16 leaves round-tripped bit for bit, the atomic commit
and ``keep``; ``ModelStore``, Holt-Winters and ``FleetLoop`` controller
state round-tripped bit for bit, and a port loop restored from the
reference's checkpoint continuing the reference's day identically; and
``runtime/fault.py``'s four names behaving as the reference's."""
import json
import os

import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.runtime as ref_runtime
import repro_torch.checkpoint as port_ckpt
import repro_torch.runtime as port_runtime
from test_torch_fleet import PORT, REF, FleetStub, dim
from test_torch_fleet_loop import event_sig

SM_COST = 1.0 / 724.0


def trees_equal(a, b) -> bool:
    """Same keys, and every leaf the same dtype, shape and bits."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and set(a) == set(b)
                and all(trees_equal(a[k], b[k]) for k in a))
    xa, xb = np.asarray(a), np.asarray(b)
    return (xa.dtype == xb.dtype and xa.shape == xb.shape
            and xa.tobytes() == xb.tobytes())


def sample_tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "opt": {"m": rng.standard_normal(5), "count": np.arange(6, dtype=np.int64),
                "flags": np.array([1, 0, 1], dtype=np.int32)},
        "step": np.int64(7),
        "lr": 3e-4,
    }


@pytest.mark.parametrize("writer,reader", [(port_ckpt, ref_ckpt), (ref_ckpt, port_ckpt),
                                           (port_ckpt, port_ckpt)],
                         ids=["port-to-reference", "reference-to-port", "port-to-port"])
def test_checkpoints_read_across_packages(tmp_path, writer, reader):
    tree = sample_tree()
    writer.Checkpointer(str(tmp_path)).save(5, tree, blocking=True)
    step, back = reader.Checkpointer(str(tmp_path)).restore_latest()
    assert step == 5 and trees_equal(back, tree)
    with open(tmp_path / "step_00000005" / "MANIFEST.json") as f:
        manifest = json.load(f)
    assert sorted(manifest) == ["leaves", "step", "time"]
    assert manifest["leaves"]["opt/m"] == {"file": "opt__m.npy", "shape": [5], "dtype": "float64"}


def test_checkpointer_takes_torch_tensors_and_bf16(tmp_path):
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))
    h = x.to(torch.bfloat16)
    tree = {"fp32": x, "fp64": x.double(), "int": torch.arange(5), "bf16": h,
            "grad_view": x.requires_grad_(True)[1:]}
    ck = port_ckpt.Checkpointer(str(tmp_path))
    ck.save(1, tree, blocking=True)
    with open(tmp_path / "step_00000001" / "MANIFEST.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["bf16"]["dtype"] == "bfloat16" and leaves["fp32"]["dtype"] == "float32"
    assert np.load(tmp_path / "step_00000001" / "bf16.npy").dtype == np.int16
    _, host = ck.restore(1)
    assert isinstance(host["fp32"], np.ndarray) and host["fp32"].dtype == np.float32
    np.testing.assert_array_equal(host["fp32"], x.detach().numpy())
    np.testing.assert_array_equal(host["grad_view"], x.detach().numpy()[1:])
    assert host["bf16"].dtype == torch.bfloat16 and torch.equal(host["bf16"], h)
    _, dev = ck.restore(1, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in dev.values())
    assert dev["fp64"].dtype == torch.float64 and torch.equal(dev["fp64"], x.detach().double())
    assert dev["int"].dtype == torch.int64 and torch.equal(dev["int"], torch.arange(5))
    assert torch.equal(dev["bf16"].view(torch.int16), h.view(torch.int16))
    # the reference reads the bf16 leaf as its int16 bit pattern, never as floats
    _, ref = ref_ckpt.Checkpointer(str(tmp_path)).restore(1)
    assert ref["bf16"].dtype == np.int16
    np.testing.assert_array_equal(ref["bf16"], h.view(torch.int16).numpy())


@pytest.mark.parametrize("pkg", [port_ckpt, ref_ckpt], ids=["port", "reference"])
def test_atomic_commit_keep_and_background_writes(tmp_path, pkg):
    ck = pkg.Checkpointer(str(tmp_path), keep=2)
    for s in range(5):
        ck.save(s, {"x": np.full(3, s, np.float32)})
    ck.wait()
    assert ck.list_steps() == [3, 4]
    # a partial write (no manifest, or still .tmp) is invisible
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008")
    np.save(tmp_path / "step_00000008" / "x.npy", np.zeros(3))
    assert ck.list_steps() == [3, 4]
    step, tree = ck.restore_latest()
    assert step == 4 and tree["x"].tolist() == [4.0] * 3
    assert pkg.Checkpointer(str(tmp_path / "empty")).restore_latest() is None


def test_background_write_errors_surface_on_wait(tmp_path):
    ck = port_ckpt.Checkpointer(str(tmp_path))
    (tmp_path / "step_00000001.tmp").write_text("a file where the writer wants a directory")
    ck.save(1, {"x": np.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                   # the error is raised once


def _store(P, cfg_parallelism=(2, 1)):
    d = P.streams.wordcount()
    store = P.control.ModelStore(P.core.oracle_models(d, SM_COST))
    cfg = P.core.round_robin_configuration(d, {"W": cfg_parallelism[0], "C": cfg_parallelism[1]},
                                           2, dim(P))
    return store, cfg


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_modelstore_round_trips_bit_for_bit_across_packages(tmp_path, writer):
    (ps, pc), (rs, rc) = _store(PORT), _store(REF)
    for s, c in ((ps, pc), (rs, rc)):
        s.observe(c, 123.456)
        s.observe(c, 119.25)
    assert trees_equal(ps.state_dict(), rs.state_dict())
    src, Ck = (ps, port_ckpt) if writer == "port" else (rs, ref_ckpt)
    Ck.Checkpointer(str(tmp_path)).save(0, src.state_dict(), blocking=True)
    for store_of, Reader in ((PORT, port_ckpt), (REF, ref_ckpt)):
        other, cfg = _store(store_of)
        _step, tree = Reader.Checkpointer(str(tmp_path)).restore_latest()
        other.load_state_dict(tree)
        assert other.version == 2
        assert trees_equal(other.state_dict(), src.state_dict())
        assert other.overprovision_factor == src.overprovision_factor
        other.observe(cfg, 120.0)
        assert other.version == 3


def test_holt_winters_round_trips_bit_for_bit_across_packages(tmp_path):
    fr, fp = REF.control.HoltWintersForecaster(season=4), PORT.control.HoltWintersForecaster(season=4)
    for x in [100.0, 120.0, 90.0, 110.0, 105.0, 126.0, 94.0, 116.0]:
        fr.observe(x)
        fp.observe(x)
    ref_ckpt.Checkpointer(str(tmp_path / "r")).save(0, fr.state_dict(), blocking=True)
    port_ckpt.Checkpointer(str(tmp_path / "p")).save(0, fp.state_dict(), blocking=True)
    for d in ("r", "p"):
        _s, tree = port_ckpt.Checkpointer(str(tmp_path / d)).restore_latest()
        fresh = PORT.control.HoltWintersForecaster(season=4)
        fresh.load_state_dict(tree)
        np.testing.assert_array_equal(fresh.forecast(6), fr.forecast(6))
        fresh.observe(108.0)
        fr2 = REF.control.HoltWintersForecaster(season=4)
        fr2.load_state_dict(ref_ckpt.Checkpointer(str(tmp_path / d)).restore_latest()[1])
        fr2.observe(108.0)
        np.testing.assert_array_equal(fresh.forecast(3), fr2.forecast(3))
    with pytest.raises(ValueError):
        PORT.control.HoltWintersForecaster(season=7).load_state_dict(tree)


def _warm_loop(P, evaluator=None):
    d = P.streams.wordcount()
    spec = P.fleet.TenantSpec(
        name="a", dag=d, target_ktps=120.0, qos=P.fleet.QosTier.GUARANTEED,
        models=P.control.ModelStore(P.core.oracle_models(d, SM_COST)),
        guards=P.control.GuardBands(headroom=1.2, deadband=0.15), preferred_dim=dim(P),
        forecaster=P.control.HoltWintersForecaster(season=3), horizon=2)
    slow = P.fleet.Cluster([P.fleet.MachineClass("slow", count=4, cores=8.0, mem_mb=65536.0,
                                                 speed=0.6)])
    return P.fleet.FleetLoop([spec], slow, evaluator)


def test_loop_checkpoint_restore_resumes_warm(tmp_path):
    loop = _warm_loop(PORT)
    loop.run({"a": [100.0, 120.0, 140.0, 130.0]})
    ck = port_ckpt.Checkpointer(str(tmp_path))
    assert loop.checkpoint(ck) == 4
    restored = _warm_loop(PORT)
    assert restored.restore(ck) == 4
    assert restored._last_target == loop._last_target
    assert restored._breached == loop._breached
    assert trees_equal(loop.tenants[0].models.state_dict(),
                       restored.tenants[0].models.state_dict())
    np.testing.assert_array_equal(loop.tenants[0].forecaster.forecast(4),
                                  restored.tenants[0].forecaster.forecast(4))
    assert restored.plan is None and restored.events == []
    assert _warm_loop(PORT).restore(port_ckpt.Checkpointer(str(tmp_path / "empty"))) is None
    twin = _warm_loop(REF)
    twin.run({"a": [100.0, 120.0, 140.0, 130.0]})
    assert trees_equal(port_ckpt.controller_state(loop), ref_ckpt.controller_state(twin))


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference"])
def test_restored_loop_continues_the_other_package_day(tmp_path, direction):
    """A controller checkpointed by one package after 4 steps of a day under
    the stub, restored into a fresh loop of the other package that takes over
    the deployment it finds, continues the day with the events of the
    uninterrupted run, field for field (its step numbers count from the
    restore)."""
    day = [100.0, 120.0, 140.0, 130.0, 150.0, 95.0, 160.0, 170.0]
    src, dst = (REF, PORT) if direction == "reference-to-port" else (PORT, REF)
    whole = _warm_loop(src, FleetStub(src))
    whole.run({"a": day})
    want = [event_sig(e) for e in whole.events[4:]]

    first = _warm_loop(src, FleetStub(src))
    first.run({"a": day[:4]})
    ckpt = {"port": port_ckpt, "reference": ref_ckpt}
    first.checkpoint(ckpt[src.name].Checkpointer(str(tmp_path)))
    # the deployment the cluster runs, as the other package sees it: its own
    # loop over the same first steps (plans are equal, test_torch_fleet)
    twin = _warm_loop(dst, FleetStub(dst))
    twin.run({"a": day[:4]})
    assert [event_sig(e) for e in twin.events] == [event_sig(e) for e in first.events]

    resumed = _warm_loop(dst, FleetStub(dst))
    assert resumed.restore(ckpt[dst.name].Checkpointer(str(tmp_path))) == 4
    resumed.plan = twin.plan
    resumed.run({"a": day[4:]})
    got = [dict(event_sig(e), step=e.step + 4) for e in resumed.events]
    assert got == want
    # without the checkpoint the same hand-over continues differently
    cold = _warm_loop(dst, FleetStub(dst))
    cold.plan = twin.plan
    cold.run({"a": day[4:]})
    assert [dict(event_sig(e), step=e.step + 4) for e in cold.events] != want


# ------------------------------------------------------------ runtime/fault.py

def test_runtime_exports_the_four_fault_names():
    """The four fault names, and since the elastic runtime was ported, the
    rest of the reference's exports beside them."""
    assert sorted(port_runtime.__all__) == sorted(ref_runtime.__all__)
    assert {"FailurePlan", "InjectedFailure", "StragglerMonitor",
            "run_with_restarts"} <= set(port_runtime.__all__)
    assert issubclass(port_runtime.InjectedFailure, RuntimeError)


@pytest.mark.parametrize("R", [port_runtime, ref_runtime], ids=["port", "reference"])
def test_failure_plan_and_restarts_behave_as_reference(R):
    def trace(R):
        plan = R.FailurePlan(fail_after_steps=(2, 5))
        log = []

        def run(attempt):
            start = {0: 0, 1: 3, 2: 6}[attempt]
            for step in range(start, 8):
                log.append((attempt, step))
                plan.maybe_fail(step)
            return len(log)

        return R.run_with_restarts(run), log, sorted(plan.triggered)

    assert trace(R) == trace(port_runtime) == trace(ref_runtime)
    result, _log, _trig = trace(R)
    assert result == (8, 2)

    def always(_attempt):
        raise R.InjectedFailure("down")

    with pytest.raises(R.InjectedFailure):
        R.run_with_restarts(always, max_restarts=3)

    def other(_attempt):
        raise ValueError("not injected")

    with pytest.raises(ValueError):
        R.run_with_restarts(other)


def test_straggler_monitor_flags_the_same_steps():
    rng = np.random.default_rng(3)
    times = list(1.0 + 0.02 * rng.standard_normal(60))
    for i in (12, 30, 31, 47):
        times[i] *= 3.0
    seen = {}
    for name, R in (("port", port_runtime), ("reference", ref_runtime)):
        hits = []
        mon = R.StragglerMonitor(window=16, k=6.0, min_samples=8,
                                 on_straggler=lambda s, t, d: hits.append((s, t, d)))
        flags = [mon.observe(i, t) for i, t in enumerate(times)]
        seen[name] = (flags, mon.stragglers, hits)
    assert seen["port"] == seen["reference"]
    assert [s for s, _t, _d in seen["port"][1]] == [12, 30, 31, 47]
    # one sample swept across the deadline after a fixed window: the
    # verdict flips at the same value in both packages
    base = list(1.0 + 0.02 * rng.standard_normal(20))
    verdicts = {}
    for name, R in (("port", port_runtime), ("reference", ref_runtime)):
        row = []
        for v in np.linspace(1.0, 1.3, 301):
            mon = R.StragglerMonitor(window=16)
            for i, t in enumerate(base):
                mon.observe(i, t)
            row.append(mon.observe(len(base), float(v)))
        verdicts[name] = row
    assert verdicts["port"] == verdicts["reference"]
    assert 0 < sum(verdicts["port"]) < len(verdicts["port"])
