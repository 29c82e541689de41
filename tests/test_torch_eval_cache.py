"""The port's cache-first evaluation path on the CPU: in-batch dedup, the
result cache, device-resident batches and batch padding are bit for bit
transparent against the escape hatch; the dedup counters, the result
cache's eviction order and ``cache_stats`` match the reference's; a
``version_source`` bump makes entries unreachable; a summary-backed row
refetches its trajectory bit for bit and counts it."""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.streams as ref
import repro_torch.control as port_control
import repro_torch.core as port_core
import repro_torch.streams as port
from repro_torch.streams import simulator as port_sim

DIM_R = ref_core.ContainerDim(3.0, 4096.0)
DIM_T = port_core.ContainerDim(3.0, 4096.0)


def _wc(pkg_core, pkg, dim, w=1, c=1):
    return pkg_core.Configuration(pkg.wordcount(), packing=(("W",) * w, ("C",) * c),
                                  dims=(dim, dim))


def _port_cfgs():
    dag = port.diamond()
    return [
        port_core.round_robin_configuration(dag, {n: p for n in dag.node_names}, k, DIM_T)
        for p, k in ((1, 2), (2, 2), (2, 3))
    ]


def _rows_equal(a, b, mode):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.achieved_ktps == y.achieved_ktps
        got, want = (x.samples, y.samples) if mode == "full" else (x.summary, y.summary)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


#: (configuration index, load, seed) rows with duplicates mixed in
ROWS = [(0, 300.0, 7), (1, 1e6, 7), (0, 300.0, 7), (2, 250.0, 8), (1, 1e6, 7),
        (0, 300.0, 9), (2, 250.0, 8)]


@pytest.mark.parametrize("kernel", ["dense", "sparse"])
@pytest.mark.parametrize("mode", ["full", "summary"])
def test_every_tier_is_bitwise_transparent(mode, kernel):
    cfgs = _port_cfgs()
    configs = [cfgs[i] for i, _, _ in ROWS]
    loads = [l for _, l, _ in ROWS]
    seeds = [s for _, _, s in ROWS]
    kw = dict(duration_s=0.5, seeds=seeds, tick_kernel=kernel, samples=mode, device="cpu")
    plain = port.simulate_batch(configs, loads, dedup=False, **kw)
    deduped = port.simulate_batch(configs, loads, **kw)
    assert deduped[0] is deduped[2] and deduped[3] is deduped[6]
    rc = port.ResultCache()
    cached = port.simulate_batch(configs, loads, cache=rc, resident=True, **kw)
    again = port.simulate_batch(configs, loads, cache=rc, resident=True, **kw)
    assert all(x is y for x, y in zip(cached, again))
    rc.clear()
    port.clear_resident_cache()
    staged = port.simulate_batch(configs, loads, cache=rc, resident=True, **kw)
    hit = port.simulate_batch(configs, loads, dedup=False, resident=True,
                              min_batch_bucket=8, min_inst_bucket=32, **kw)
    port.simulate_batch(configs, loads, dedup=False, resident=True,
                        min_batch_bucket=8, min_inst_bucket=32, **kw)
    assert port.resident_cache_info()["hits"] >= 1
    for got in (deduped, cached, again, staged, hit):
        _rows_equal(got, plain, mode)


def test_dedup_counters_equal_the_reference():
    ref.clear_dedup_stats()
    port.clear_dedup_stats()
    cr, ct = _wc(ref_core, ref, DIM_R), _wc(port_core, port, DIM_T)
    trace = np.full(8, 220.0)
    submissions = [
        ([300.0, 200.0, 300.0, 250.0, 200.0, 300.0], [7] * 6, False),
        ([300.0, 300.0, trace, np.array(trace), trace + 1.0], [1, 2, 7, 7, 7], False),
        ([300.0, 200.0, 300.0], [7, 7, 7], True),
        ([300.0, 200.0, 300.0], [7, 7, 7], True),
        ([400.0, 200.0], [7, 7], True),
    ]
    rc_r, rc_t = ref.ResultCache(), port.ResultCache()
    for loads, seeds, cached in submissions:
        ref.simulate_batch([cr] * len(loads), loads, duration_s=0.5, seeds=seeds,
                           cache=rc_r if cached else None)
        port.simulate_batch([ct] * len(loads), loads, duration_s=0.5, seeds=seeds,
                            cache=rc_t if cached else None, device="cpu")
        assert port.dedup_info() == ref.dedup_info()
    info_r, info_t = rc_r.info(), rc_t.info()
    for k in ("size", "hits", "misses", "evictions"):
        assert info_t[k] == info_r[k], k
    assert rc_t.batch_floor == rc_r.batch_floor
    port.clear_dedup_stats()
    port.simulate_batch([ct, ct], 300.0, duration_s=0.5, dedup=False, device="cpu")
    assert port.dedup_info()["batches"] == 0


def test_result_cache_eviction_order_equals_the_reference():
    caches = [ref.ResultCache(max_entries=3, max_bytes=1000),
              port.ResultCache(max_entries=3, max_bytes=1000)]
    ops = [("put", "a", 300), ("put", "b", 300), ("get", "a", 0), ("put", "c", 300),
           ("put", "d", 200), ("get", "b", 0), ("put", "a", 100), ("put", "huge", 2000),
           ("get", "huge", 0), ("put", "e", 500), ("get", "c", 0), ("get", "a", 0)]
    seen = [[], []]
    for cache, log in zip(caches, seen):
        for op, key, nbytes in ops:
            if op == "put":
                cache.put(key, key.upper(), nbytes)
            else:
                log.append(cache.get(key))
            log.append((tuple(cache._data), cache.info()["bytes"], cache.info()["evictions"]))
    assert seen[1] == seen[0]
    assert caches[1].info() == {**caches[0].info(), "name": "result"}
    caches[1].clear()
    assert len(caches[1]) == 0 and caches[1].info()["hits"] == 0


def test_version_bump_makes_entries_unreachable():
    ct = _wc(port_core, port, DIM_T)
    store = port_control.ModelStore(port_core.oracle_models(port.wordcount(), 1 / 724.0))
    ev = port.SimulatorEvaluator(duration_s=0.5, version_source=store, device="cpu")
    port.clear_dedup_stats()
    first = ev.evaluate(ct, 300.0)
    assert ev.evaluate(ct, 300.0).sim is first.sim
    assert ev.result_cache.info()["hits"] == 1
    assert port.dedup_info()["rows_executed"] == 1
    store.observe(ct, 290.0)                     # version bump: stale keys
    again = ev.evaluate(ct, 300.0)
    info = ev.result_cache.info()
    assert (info["hits"], info["misses"]) == (1, 2)
    assert port.dedup_info()["rows_executed"] == 2
    assert again.sim is not first.sim and again.achieved_ktps == first.achieved_ktps
    # the control loop wires its learner in when the evaluator has none
    ev2 = port.SimulatorEvaluator(duration_s=0.5, device="cpu")
    port_control.ControlLoop(
        port_control.DeclarativePolicy(port.wordcount(), store), evaluator=ev2, learner=store)
    assert ev2.version_source is store


def test_summary_refetch_is_full_mode_bit_for_bit_and_counted():
    cfgs = _port_cfgs()
    port.clear_transfer_stats()
    ev = port.SimulatorEvaluator(duration_s=1.0, tick_kernel="sparse", device="cpu")
    rows = ev.evaluate_batch(cfgs, [1e6, 200.0, 1e6])
    moved = port.transfer_info()
    assert moved["batches"] == 1 and moved["bytes_summary"] > 0 and moved["bytes_full"] == 0
    samples = rows[1].sim.samples
    assert rows[1].sim.samples is samples        # refetched once, then kept
    refetched = port.transfer_info()
    assert refetched["refetches"] == 1 and refetched["batches"] == 2
    full = port.simulate_batch([cfgs[1]], 200.0, duration_s=1.0, tick_kernel="sparse",
                               device="cpu")[0]
    for k in full.samples:
        np.testing.assert_array_equal(samples[k], full.samples[k], err_msg=k)
    after = port.transfer_info()
    assert after["bytes_full"] == 2 * refetched["bytes_full"] > 0
    store = rows[1].sim.to_metrics_store()
    assert len(store) == rows[1].sim.structure.n_inst + rows[1].sim.structure.n_cont


def test_cache_stats_has_the_references_sections_and_keys():
    cr, ct = _wc(ref_core, ref, DIM_R), _wc(port_core, port, DIM_T)
    rc_r, rc_t = ref.ResultCache(), port.ResultCache()
    ref.simulate_batch([cr], [300.0], duration_s=0.5, seeds=[7], cache=rc_r)
    port.simulate_batch([ct], [300.0], duration_s=0.5, seeds=[7], cache=rc_t, device="cpu")
    a, b = ref.cache_stats(), port.cache_stats()
    assert sorted(b) == sorted(a)
    for section in a:
        assert sorted(b[section]) == sorted(a[section]), section
    info = port.structure_cache_info()
    assert info["structures"] >= 1 and info["structure_bytes"] > 0
    port.clear_structure_cache()
    assert port.structure_cache_info()["structures"] == 0
    port.clear_result_caches()
    assert rc_t.info()["size"] == 0


def test_structure_memo_shares_equal_configurations():
    port.clear_structure_cache()
    a = _wc(port_core, port, DIM_T, w=2)
    b = _wc(port_core, port, DIM_T, w=2)
    assert a is not b and a == b
    params = port.SimParams()
    assert port.structure_for(a, params) is port.structure_for(b, params)
    assert port.structure_for(a, dataclasses.replace(params, seed=1)) is not \
        port.structure_for(a, params)
    info = port.structure_cache_info()
    assert (info["hits"], info["misses"], info["structures"]) == (2, 2, 2)
    st = port.structure_for(a, params)
    dense = port_sim._padded_for(st, params, 8, 8)
    np.testing.assert_array_equal(dense["rowsum"], port_sim.padded_rowsum(st, 8))
    assert port_sim._padded_for(st, params, 8, 8) is dense
    assert "rowsum" not in port.pad_structure(st, 8, 8)


def test_resident_cache_is_bounded():
    cfgs = _port_cfgs()
    port.clear_resident_cache()
    for i in range(port_sim._RESIDENT_CACHE_MAX_ENTRIES + 3):
        port.simulate_batch(cfgs[:1], 1e6, duration_s=0.25, seeds=[i], resident=True,
                            min_inst_bucket=8 * (1 + i % 2), dedup=False, device="cpu")
    info = port.resident_cache_info()
    assert info["size"] <= 2 and info["hits"] >= 1    # keyed by layout, not seed
    port.clear_resident_cache()
    assert port.resident_cache_info() == {"size": 0, "hits": 0, "misses": 0, "bytes": 0}
