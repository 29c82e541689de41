"""The port's control plane against the reference package on the CPU: the
numpy parts (forecasters, scenario traces, calibration, the reactive
scaler, the autoscaler) bit for bit; ``ControlLoop`` under every ported
policy, driven by one deterministic stub evaluator, with equal event logs;
and a diurnal adanalytics day on each package's own ``SimulatorEvaluator``
with the same actions and achieved rates."""
import dataclasses
import math

import numpy as np
import pytest

import repro.control as ref_control
import repro.core as ref_core
import repro.streams as ref
import repro_torch.control as port_control
import repro_torch.core as port_core
import repro_torch.streams as port

REF = (ref_core, ref, ref_control)
PORT = (port_core, port, port_control)
SM_COST = 1.0 / 724.0


def _dim(pkg):
    return pkg[0].ContainerDim(3.0, 4096.0)


def _models(pkg, dag):
    return pkg[0].oracle_models(dag, SM_COST)


class FlowStub:
    """A deterministic evaluator over one package: a configuration achieves
    ``min(load, solve_flow capacity)``; the bottleneck is the node with the
    highest capacity utilization at the solved rates when the load reaches
    the capacity.  Returns the package's own ``EvalResult`` with
    ``sim=None``."""

    def __init__(self, pkg, models):
        self.core, self.streams = pkg[0], pkg[1]
        self.models = models
        self.calls = 0

    def _one(self, cfg, load):
        sol = self.core.solve_flow(cfg, self.models)
        cap = float(sol.rate_ktps) if sol.feasible else 0.0
        load = float(np.max(load))
        bottleneck = None
        if load >= cap and sol.instance_rates:
            util: dict = {}
            for (nm, _c, _s), rate in sol.instance_rates.items():
                util[nm] = max(util.get(nm, 0.0), rate * self.models[nm].cap.slope)
            bottleneck = max(util.items(), key=lambda kv: kv[1])[0]
        return self.streams.EvalResult(config=cfg, achieved_ktps=min(load, cap),
                                       bottleneck=bottleneck, sim=None)

    def evaluate(self, config, offered_ktps=1e6):
        self.calls += 1
        return self._one(config, offered_ktps)

    def evaluate_batch(self, configs, offered_ktps=1e6):
        self.calls += 1
        configs = list(configs)
        loads = ([offered_ktps] * len(configs) if np.isscalar(offered_ktps)
                 else list(offered_ktps))
        return [self._one(c, o) for c, o in zip(configs, loads)]

    def evaluate_grid(self, configs, rates_ktps):
        self.calls += 1
        return [[self._one(c, r) for r in rates_ktps] for c in configs]


def _event_rows(loop):
    rows = []
    for ev in loop.events:
        d = dataclasses.asdict(ev)
        d.pop("plan_seconds")
        rows.append({k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
                     for k, v in d.items()})
    return rows


# ----------------------------------------------------------- numpy parts


def _forecaster(pkg, name):
    kw = {"holt-winters": dict(season=12), "replay": dict(period=12)}.get(name, {})
    return pkg[2].make_forecaster(name, **kw)


@pytest.mark.parametrize("name", sorted(ref_control.FORECASTERS))
def test_forecasters_match_reference_bit_for_bit(name):
    assert sorted(port_control.FORECASTERS) == sorted(ref_control.FORECASTERS)
    trace = ref_control.make_trace("diurnal", 40, base_ktps=300.0, seed=2)
    fr, ft = _forecaster(REF, name), _forecaster(PORT, name)
    assert ft.name == fr.name
    for x in trace:
        fr.observe(float(x))
        ft.observe(float(x))
        np.testing.assert_array_equal(ft.forecast(6), fr.forecast(6))
    sr, st = fr.state_dict(), ft.state_dict()
    assert sorted(st) == sorted(sr)
    for k in sr:
        np.testing.assert_array_equal(np.asarray(st[k]), np.asarray(sr[k]), err_msg=k)
    fresh = _forecaster(PORT, name)
    fresh.load_state_dict(st)
    np.testing.assert_array_equal(fresh.forecast(6), ft.forecast(6))
    tr, tt = ref_control.ForecastTracker(window=8), port_control.ForecastTracker(window=8)
    for p, a in zip(trace[:-1], trace[1:]):
        tr.observe(p, a)
        tt.observe(p, a)
    assert (tt.factor(), tt.bias(), tt.mean_abs_pct_error(), len(tt)) == (
        tr.factor(), tr.bias(), tr.mean_abs_pct_error(), len(tr))


@pytest.mark.parametrize("name", sorted(ref_control.SCENARIOS))
def test_scenario_traces_match_reference_bit_for_bit(name):
    assert sorted(port_control.SCENARIOS) == sorted(ref_control.SCENARIOS)
    a = ref_control.make_trace(name, 64, base_ktps=250.0, seed=5)
    b = port_control.make_trace(name, 64, base_ktps=250.0, seed=5)
    np.testing.assert_array_equal(b, a)
    for x, y in zip(ref_control.make_trace(name, 32, seed=1, split=0.75),
                    port_control.make_trace(name, 32, seed=1, split=0.75)):
        np.testing.assert_array_equal(y, x)
    np.testing.assert_array_equal(port_control.replay(a, n=48, base_ktps=100.0),
                                  ref_control.replay(a, n=48, base_ktps=100.0))
    if name in ref_control.GUARD_PRESETS:
        assert port_control.GuardBands.for_scenario(name) == port_control.GuardBands(
            **dataclasses.asdict(ref_control.GuardBands.for_scenario(name)))
    with pytest.raises(KeyError):
        port_control.make_trace("nope", 8)


def test_failure_traces_and_sources_match_reference():
    assert port_control.GUARD_PRESETS == ref_control.GUARD_PRESETS
    for name, kw in (("single_host", dict(host="h1", recover_after=3)),
                     ("rack", dict(rack="r0")), ("flapping", dict(host="h2", period=3))):
        assert port_control.make_failure_trace(name, 24, **kw) == \
            ref_control.make_failure_trace(name, 24, **kw)
    for fn, kw in (("diurnal", dict(period=48)), ("spike", {}), ("weekly", dict(day_period=24))):
        np.testing.assert_array_equal(getattr(port.sources, fn)(96, seed=4, **kw),
                                      getattr(ref.sources, fn)(96, seed=4, **kw))


def _adanalytics_configs(pkg):
    dag = pkg[1].adanalytics()
    return dag, [
        pkg[0].round_robin_configuration(dag, {n: p for n in dag.node_names}, k, _dim(pkg))
        for p, k in ((1, 2), (2, 3), (3, 4), (2, 2))
    ]


def test_calibrator_matches_reference_bit_for_bit():
    outs = []
    for pkg in (REF, PORT):
        dag, cfgs = _adanalytics_configs(pkg)
        models = _models(pkg, dag)
        cal = pkg[0].Calibrator(window=4)
        seen = []
        for i, cfg in enumerate(cfgs * 2):
            measured = pkg[0].solve_flow(cfg, models).rate_ktps * (0.7 + 0.1 * i)
            rec = cal.observe(cfg, models, measured)
            seen.append((rec.config_desc, rec.predicted_ktps, rec.ratio,
                         cal.overprovision_factor, cal.mean_abs_error, cal.drift_detected()))
        cal.observe_many(cfgs[:2], models, [10.0, 20.0])
        cal.observe_prediction(5.0, 4.0)
        seen.append((cal.overprovision_factor, cal.drift_detected()))
        state = cal.state_dict()
        cal.mark_retrained()
        seen.append((cal.retrain_count, len(cal.records), state["retrain_count"],
                     state["predicted"].tolist(), state["measured"].tolist(),
                     state["descs"].tolist()))
        outs.append(seen)
    assert outs[1] == outs[0]


def test_reactive_scale_matches_reference():
    outs = []
    for pkg in (REF, PORT):
        dag = pkg[1].adanalytics()
        models = _models(pkg, dag)

        def measure(cfg, pkg=pkg, models=models):
            return min(pkg[0].solve_flow(cfg, models).rate_ktps, 1e6), None

        classic = pkg[0].reactive_scale(dag, 900.0, measure=measure, dim=_dim(pkg))
        spec = pkg[0].reactive_scale(dag, 900.0, evaluator=FlowStub(pkg, models),
                                     dim=_dim(pkg), speculative_k=4)
        outs.append([
            ([dataclasses.astuple(s) for s in r.steps], r.converged, r.iterations,
             r.convergence_seconds, r.final_config.describe())
            for r in (classic, spec)
        ])
    assert outs[1] == outs[0]
    with pytest.raises(ValueError):
        port_core.reactive_scale(port.adanalytics(), 100.0)


def test_autoscaler_matches_reference():
    outs = []
    for pkg in (REF, PORT):
        dag, cfgs = _adanalytics_configs(pkg)
        models = _models(pkg, dag)
        scaler = pkg[0].AutoScaler(dag, models, headroom=1.2, deadband=0.15,
                                   preferred_dim=_dim(pkg))
        scaler.configure_for(400.0)
        for load in (380.0, 500.0, 300.0, 900.0):
            scaler.observe_load(load)
        drift = scaler.observe_measurements(cfgs, [100.0, 120.0, 90.0, 60.0])
        calibrated = scaler.calibrate_with(FlowStub(pkg, models), cfgs[:2])
        trace = pkg[2].make_trace("diurnal", 12, base_ktps=200.0, seed=3)
        run = pkg[0].run_against_trace(scaler, trace, evaluator=FlowStub(pkg, models))
        outs.append((
            [(e.load_ktps, e.target_ktps, e.n_containers, e.total_cpus, e.reason)
             for e in scaler.events],
            drift, calibrated, scaler.calibrator.overprovision_factor, run,
            scaler.reconfigurations, scaler.current.config.describe(),
        ))
    assert outs[1] == outs[0]


# ----------------------------------------------------------- the loop


def _policy(pkg, name, dag, models):
    c = pkg[2]
    if name == "declarative":
        return c.DeclarativePolicy(dag, models, preferred_dim=_dim(pkg))
    if name == "reactive":
        return c.ReactivePolicy(dag, dim=_dim(pkg), max_cycles_per_plan=6)
    if name == "hybrid":
        return c.HybridPolicy(dag, models, preferred_dim=_dim(pkg))
    return c.PredictivePolicy(dag, models, preferred_dim=_dim(pkg))


@pytest.mark.parametrize("name", ["declarative", "reactive", "hybrid", "predictive"])
def test_control_loop_event_logs_match_reference_with_a_stub(name):
    """Field by field except ``plan_seconds``: guards, causes, forecast
    peaks, containers, achieved rates, drift and retrain flags."""
    logs = []
    for pkg in (REF, PORT):
        dag = pkg[1].adanalytics()
        models = _models(pkg, dag)
        c = pkg[2]
        loop = c.ControlLoop(
            _policy(pkg, name, dag, models),
            guards=c.GuardBands(headroom=1.1, deadband=0.15),
            evaluator=FlowStub(pkg, models),
            learner=c.ModelStore(models),
            forecaster=(c.HoltWintersForecaster(season=12)
                        if name in ("predictive", "hybrid") else None),
            horizon=4,
            saturation_threshold=0.95,
            calibration_batch=2,
        )
        trace = c.make_trace("diurnal", 24, base_ktps=250.0, seed=3)
        records = loop.run(trace)
        loop.declare(700.0)
        logs.append((_event_rows(loop), [dataclasses.astuple(r) for r in records],
                     loop.action.config.describe(), loop.learner.version))
    assert logs[1] == logs[0]
    assert any(e["acted"] for e in logs[1][0])


POLICIES_ON_SIMULATOR = ["hybrid", "predictive"]


@pytest.mark.parametrize("name", POLICIES_ON_SIMULATOR)
def test_diurnal_day_on_each_packages_simulator(name):
    """12 steps of a diurnal adanalytics day on each package's own
    ``SimulatorEvaluator`` (noise on): the same actions each step and the
    same achieved rate to rel 1e-5.  The simulated stream managers cost 2.5x
    what the oracle models assume, so some steps saturate; the predictive
    loop learns from them, refetching each saturated row's trajectory for
    the retrain pool and bumping the version that keys the result cache."""
    runs = []
    port.clear_transfer_stats()
    for pkg in (REF, PORT):
        dag = pkg[1].adanalytics()
        models = _models(pkg, dag)
        c = pkg[2]
        kw = dict(device="cpu") if pkg is PORT else {}
        params = pkg[1].SimParams(sm_cost_per_ktuple=2.5 * SM_COST)
        ev = pkg[1].SimulatorEvaluator(params=params, duration_s=2.0, **kw)
        store = c.ModelStore(models)
        policy = _policy(pkg, name, dag, store)
        loop = c.ControlLoop(
            policy,
            guards=c.GuardBands(headroom=1.0, deadband=0.2),
            evaluator=ev,
            learner=store if name == "predictive" else None,
            forecaster=c.HoltWintersForecaster(season=6) if name == "predictive" else None,
            horizon=4,
            saturation_threshold=0.95,
            calibration_batch=2,
        )
        steps = []
        for load in c.make_trace("diurnal", 12, base_ktps=150.0, seed=3):
            ev_ = loop.step(float(load))
            steps.append((ev_.acted, ev_.guard, ev_.cause, ev_.containers, ev_.provisioned,
                          loop.action.config.describe(), loop.action.reason,
                          ev_.achieved, ev_.bottleneck))
        runs.append((steps, store.version, len(store.metrics)))
    (a, va, na), (b, vb, nb) = runs
    assert (vb, nb) == (va, na)
    if name == "hybrid":
        assert any(x[6] == "allocate+trim" for x in b)
    else:
        assert any(x[1] == "breach" for x in b)
        assert vb > 0 and nb > 0
        assert port.transfer_info()["refetches"] > 0
        assert ev.version_source is store
    for x, y in zip(a, b):
        assert y[:7] == x[:7]
        assert y[7] == pytest.approx(x[7], rel=1e-5)
        assert y[8] == x[8]
