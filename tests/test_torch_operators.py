"""The port's stream operators against the reference's jitted bodies on the
CPU: every operator on the same seeded numpy batches (ints and bools bit
for bit, floats to rel 1e-6), ``cell_kpi``'s last-writer semantics on
repeated cells, ``geo_mapper`` over the whole int32 range, and the sources'
shapes, dtypes, ranges and seeding (their bits are not jax's: parity is on
everything downstream of them)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.streams.operators as ref
import repro_torch.streams.operators as ops

FLOAT_RTOL = 1e-6
B = 512


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _same(got: dict, want: dict):
    """Same columns; ints and bools bit for bit, floats to FLOAT_RTOL."""
    assert sorted(got) == sorted(want)   # jit returns dicts in key order
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _state_same(got, want):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(g, w)


def _ad_batch(rng, n=B):
    return {
        "ad_id": rng.integers(0, 1000, n).astype(np.int32),
        "event_type": rng.integers(0, 3, n).astype(np.int32),
        "ts": (rng.random(n) * 1e6).astype(np.float32),
    }


def _mobile_batch(rng, n=B, n_users=5000, n_cells=300):
    return {
        "user": rng.integers(0, n_users, n).astype(np.int32),
        "cell": rng.integers(0, n_cells, n).astype(np.int32),
        "bytes": (rng.exponential(size=n) * 1500.0).astype(np.float32),
        "latency_ms": (rng.gamma(2.0, size=n) * 10.0).astype(np.float32),
    }


STATELESS = {
    "event_deserializer": _ad_batch,
    "event_filter": _ad_batch,
    "log_parser": _mobile_batch,
    "geo_mapper": _mobile_batch,
}


@pytest.mark.parametrize("name", sorted(STATELESS))
@pytest.mark.parametrize("seed", [0, 1])
def test_stateless_operator_matches_reference(name, seed):
    batch = STATELESS[name](np.random.default_rng(seed))
    _, want = getattr(ref, name)(None, _j(batch))
    st, got = getattr(ops, name)(None, _t(batch))
    assert st is None
    _same(got, want)


@pytest.mark.parametrize("with_valid", [True, False])
def test_projection_and_join_match_reference(with_valid):
    rng = np.random.default_rng(3)
    batch = _ad_batch(rng)
    if with_valid:
        batch["valid"] = batch["event_type"] == 0
    _, want = ref.event_projection(None, _j(batch))
    _, got = ops.event_projection(None, _t(batch))
    _same(got, want)
    _, want_j = ref.make_redis_join()(None, want)
    _, got_j = ops.make_redis_join()(None, got)
    _same(got_j, want_j)


def _run_stateful(ref_step, port_step, ref_state, port_state, batches):
    for batch in batches:
        ref_state, want = ref_step(ref_state, _j(batch))
        port_state, got = port_step(port_state, _t(batch))
        _same(got, want)
    return ref_state, port_state


def test_counting_consumer_matches_reference():
    rng = np.random.default_rng(4)
    batches = [{"key": rng.integers(0, 64, B).astype(np.int32),
                "value": np.ones(B, np.int32)} for _ in range(3)]
    r, p = ref.make_counting_consumer(64), ops.make_counting_consumer(64)
    rs, ps = _run_stateful(r, p, r.init(), p.init("cpu"), batches)
    _state_same(ps, rs)
    assert int(ps.sum()) == 3 * B


def test_campaign_processor_matches_reference():
    rng = np.random.default_rng(5)
    batches = [{"campaign_id": rng.integers(0, 100, B).astype(np.int32),
                "valid": rng.random(B) < 0.33} for _ in range(3)]
    r, p = ref.make_campaign_processor(), ops.make_campaign_processor()
    rs, ps = _run_stateful(r, p, r.init(), p.init("cpu"), batches)
    _state_same(ps, rs)


def test_session_tracker_matches_reference():
    rng = np.random.default_rng(6)
    batches = [ops_batch | {"kb": ops_batch["bytes"] / np.float32(1024.0)}
               for ops_batch in (_mobile_batch(rng) for _ in range(3))]
    r, p = ref.make_session_tracker(5000), ops.make_session_tracker(5000)
    rs, ps = _run_stateful(r, p, r.init(), p.init("cpu"), batches)
    _state_same(ps, rs)


def test_cell_kpi_keeps_the_last_writer_bit_for_bit():
    """300 cells under a 512-tuple batch repeat cells; each cell keeps its
    last position's update, bit for bit with the reference's."""
    rng = np.random.default_rng(7)
    batches = [_mobile_batch(rng) for _ in range(3)]
    assert len(np.unique(batches[0]["cell"])) < B
    r, p = ref.make_cell_kpi(300), ops.make_cell_kpi(300)
    rs, ps = r.init(), p.init("cpu")
    for batch in batches:
        rs, want = r(rs, _j(batch))
        ps, got = p(ps, _t(batch))
        np.testing.assert_array_equal(got["kpi"].numpy(), np.asarray(want["kpi"]))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    # the winner is the last position, not the first
    cells = np.array([1, 1, 1, 2], np.int32)
    lat = np.array([100.0, 200.0, 300.0, 400.0], np.float32)
    ewma, _ = ops.make_cell_kpi(3)(torch.zeros(3), {"cell": torch.as_tensor(cells),
                                                    "latency_ms": torch.as_tensor(lat)})
    want, _ = ref.make_cell_kpi(3)(jnp.zeros(3), {"cell": cells, "latency_ms": lat})
    np.testing.assert_array_equal(ewma.numpy(), np.asarray(want))
    assert ewma[1] == np.float32(0.01) * np.float32(300.0)


def test_anomaly_detector_matches_reference():
    rng = np.random.default_rng(8)
    rs = ref.anomaly_detector_init()
    ps = ops.anomaly_detector_init("cpu")
    flagged = 0
    for _ in range(4):
        batch = _mobile_batch(rng)
        batch["session_kb"] = (rng.pareto(2.5, B) * 3.0).astype(np.float32)
        rs, want = ref.anomaly_detector(rs, _j(batch))
        ps, got = ops.anomaly_detector(ps, _t(batch))
        _same(got, want)
        for g, w in zip(ps, rs):
            assert g.dtype == torch.float32 and g.ndim == 0
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FLOAT_RTOL)
        flagged += int(got["anomaly"].sum())
    assert flagged > 0


def test_geo_mapper_is_bit_exact_over_the_int32_range():
    cells = np.concatenate([
        np.array([0, 1, 65535, 65536, 2**24 + 7, 2**31 - 2, 2**31 - 1], np.int64),
        np.random.default_rng(9).integers(0, 2**31, 4096),
    ]).astype(np.int32)
    batch = {"cell": cells}
    _, want = ref.geo_mapper(None, _j(batch))
    _, got = ops.geo_mapper(None, _t(batch))
    _same(got, want)
    assert got["geo"].min() >= 0 and got["geo"].max() < 1024


@pytest.mark.parametrize("with_anomaly", [True, False])
def test_report_sink_matches_reference(with_anomaly):
    rng = np.random.default_rng(10)
    batches = []
    for _ in range(3):
        b = {"geo": rng.integers(0, 1024, B).astype(np.int32)}
        if with_anomaly:
            b["anomaly"] = rng.random(B) < 0.1
        batches.append(b)
    r, p = ref.make_report_sink(), ops.make_report_sink()
    rs, ps = _run_stateful(r, p, r.init(), p.init("cpu"), batches)
    _state_same(ps, rs)


def _draw(factory, seed, n=2):
    step = factory()
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for _ in range(n):
        g, batch = step(g)
        out.append(batch)
    return out


def test_sources_shapes_dtypes_ranges_and_seeding():
    for factory, cols in (
        (lambda: ops.make_word_producer(4096, 300), {"key": torch.int32, "value": torch.int32}),
        (lambda: ops.make_ad_source(batch=300),
         {"ad_id": torch.int32, "event_type": torch.int32, "ts": torch.float32}),
        (lambda: ops.make_mobile_source(batch=300),
         {"user": torch.int32, "cell": torch.int32, "bytes": torch.float32,
          "latency_ms": torch.float32}),
    ):
        a, b = _draw(factory, 5), _draw(factory, 5)
        c = _draw(factory, 6)
        for x, y in zip(a, b):
            assert {k: v.dtype for k, v in x.items()} == cols
            assert all(v.shape == (300,) for v in x.values())
            assert all(torch.equal(x[k], y[k]) for k in x)
        assert not all(torch.equal(a[0][k], c[0][k]) for k in cols)
        assert not all(torch.equal(a[0][k], a[1][k]) for k in cols)   # the generator moves on
    (w,) = _draw(lambda: ops.make_word_producer(64, 4000), 0, 1)
    assert int(w["key"].min()) == 0 and int(w["key"].max()) == 63 and bool((w["value"] == 1).all())
    (ad,) = _draw(lambda: ops.make_ad_source(batch=4000), 0, 1)
    assert 0 <= int(ad["ad_id"].min()) and int(ad["ad_id"].max()) < 1000
    assert set(ad["event_type"].tolist()) == {0, 1, 2}
    assert 0.0 <= float(ad["ts"].min()) and float(ad["ts"].max()) < 1e6
    (mob,) = _draw(lambda: ops.make_mobile_source(batch=4000), 0, 1)
    assert int(mob["user"].max()) < 100_000 and int(mob["cell"].max()) < 3000
    assert float(mob["bytes"].min()) >= 0.0 and float(mob["latency_ms"].min()) >= 0.0


def test_mobile_source_latency_is_gamma_two():
    """latency_ms / 10 is Gamma(2, 1): mean 2, variance 2."""
    (mob,) = _draw(lambda: ops.make_mobile_source(batch=200_000), 11, 1)
    g = mob["latency_ms"].double() / 10.0
    assert float(g.mean()) == pytest.approx(2.0, rel=0.02)
    assert float(g.var()) == pytest.approx(2.0, rel=0.05)
    e = mob["bytes"].double() / 1500.0
    assert float(e.mean()) == pytest.approx(1.0, rel=0.02)


def test_stateful_inits_take_the_device():
    for factory, n, dtype in ((ops.make_counting_consumer, 4096, torch.int32),
                              (ops.make_campaign_processor, 100, torch.int32),
                              (ops.make_session_tracker, 100_000, torch.float32),
                              (ops.make_cell_kpi, 3000, torch.float32),
                              (ops.make_report_sink, 1024, torch.float32)):
        st = factory().init(torch.device("cpu"))
        assert st.shape == (n,) and st.dtype == dtype and st.device.type == "cpu"
        assert not bool(st.any())
    mean, var, n = ops.anomaly_detector_init("cpu")
    assert (float(mean), float(var), float(n)) == (0.0, 1.0, 1.0)
