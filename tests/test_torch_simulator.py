"""The port's simulator against the reference package on the CPU: padded
arrays exactly equal, trajectories and summaries equal to float tolerance
at ``noise_std=0`` on both tick backends, and the port's sparse tick equal
to its dense tick."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.streams as ref
import repro_torch.core as port_core
import repro_torch.streams as port
from repro.streams import simulator as ref_sim
from repro_torch.interop import stage_padded
from repro_torch.streams import simulator as port_sim

WORKLOADS = list(ref.WORKLOADS)
REF_PARAMS = ref.SimParams(noise_std=0.0)
PORT_PARAMS = port.SimParams(noise_std=0.0)


def _configs(name, par_of=lambda i: 1 + i % 2, n_cont=3):
    dag_r, dag_t = ref.WORKLOADS[name](), port.WORKLOADS[name]()
    par = {n: par_of(i) for i, n in enumerate(dag_r.node_names)}
    return (
        ref_core.round_robin_configuration(dag_r, par, n_cont, ref_core.ContainerDim(3.0, 4096.0)),
        port_core.round_robin_configuration(dag_t, par, n_cont, port_core.ContainerDim(3.0, 4096.0)),
    )


def _metrics_close(a: dict, b: dict, rtol=5e-4, atol=5e-4):
    """The reference's own trajectory tolerance (tests/test_tick_kernel.py)."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        scale = max(float(np.abs(x).max()), 1.0)
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol * scale, err_msg=f"metric {k}")


# ----------------------------------------------------------- host half

def test_params_and_ladders_match_reference():
    assert dataclasses.asdict(ref.SimParams()) == dataclasses.asdict(port.SimParams())
    for fn in ("bucket_size", "batch_bucket_size", "edge_bucket_size", "degree_bucket_size"):
        for n in (0, 1, 3, 8, 9, 33, 200, 511, 513, 5000, 9000, 20000):
            for floor in (0, 16, 700):
                assert getattr(ref_sim, fn)(n, floor) == getattr(port_sim, fn)(n, floor), (fn, n, floor)
    for n, e in ((16, 32), (16, 33), (574, 41852), (60, 448)):
        for sel in ("auto", "dense", "sparse"):
            assert ref.resolve_tick_kernel(n, e, sel) == port.resolve_tick_kernel(n, e, sel)
    with pytest.raises(ValueError):
        port.resolve_tick_kernel(4, 4, "csr")


@pytest.mark.parametrize("name", WORKLOADS)
def test_structures_and_padded_arrays_equal(name):
    for par_of, n_cont in ((lambda i: 1 + i % 2, 3), (lambda i: 2, 4)):
        cr, ct = _configs(name, par_of, n_cont)
        sr = ref_sim.build_structure(cr, REF_PARAMS)
        st = port_sim.build_structure(ct, PORT_PARAMS)
        for f in ("n_inst", "n_cont", "node_names", "n_edges", "d_out", "d_in"):
            assert getattr(sr, f) == getattr(st, f), f
        for f in ("node_of", "cont_of", "is_source", "busy_cost", "cpu_cost", "W",
                  "remote", "sm_cost_eff", "edge_src", "edge_dst", "edge_w", "edge_remote"):
            np.testing.assert_array_equal(getattr(sr, f), getattr(st, f), err_msg=f)
        I, K = port.bucket_size(st.n_inst), port.bucket_size(st.n_cont)
        E = port.edge_bucket_size(st.n_edges)
        for layout in ((I, K), (I, K, E), (2 * I, 2 * K, 4 * E, 64, 16)):
            a = ref.pad_structure(sr, *layout)
            b = port.pad_structure(st, *layout)
            assert sorted(a) == sorted(b), layout
            for k in a:
                assert a[k].dtype == b[k].dtype, (layout, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{layout} {k}")


def test_stage_padded_types():
    _, ct = _configs("deep_pipeline")
    arrays = port.pad_structure(port.structure_for(ct, PORT_PARAMS), 32, 8, 32)
    staged = stage_padded(arrays, "cpu")
    assert staged["ell_src"].dtype == torch.int64
    assert staged["is_source"].dtype == torch.bool
    assert staged["edge_share"].dtype == torch.float32
    assert all(t.is_contiguous() for t in staged.values())
    np.testing.assert_array_equal(staged["ell_dst"].numpy(), arrays["ell_dst"])


# ----------------------------------------------------------- device half

CASES = [
    (name, kernel, load)
    for name in ("deep_pipeline", "diamond")
    for kernel in ("dense", "sparse")
    for load in (1e6, 150.0)
]


@pytest.mark.parametrize("name,kernel,load", CASES)
def test_full_mode_matches_reference(name, kernel, load):
    cr, ct = _configs(name)
    a = ref.simulate(cr, load, duration_s=6.0, params=REF_PARAMS, tick_kernel=kernel)
    b = port.simulate(ct, load, duration_s=6.0, params=PORT_PARAMS, tick_kernel=kernel,
                      device="cpu")
    _metrics_close(a.samples, b.samples)
    assert b.achieved_ktps == pytest.approx(a.achieved_ktps, rel=1e-4)
    assert b.bottleneck_node() == a.bottleneck_node()
    assert b.bottleneck_node(0.5, 0.5) == a.bottleneck_node(0.5, 0.5)
    np.testing.assert_allclose(b.offered_ktps, a.offered_ktps, rtol=1e-12)


@pytest.mark.parametrize("kernel", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["deep_pipeline", "diamond", "wordcount"])
def test_summary_mode_matches_reference_summary_mode(name, kernel):
    cr, ct = _configs(name)
    a = ref.simulate(cr, 1e6, duration_s=6.0, params=REF_PARAMS, tick_kernel=kernel,
                     samples="summary")
    b = port.simulate(ct, 1e6, duration_s=6.0, params=PORT_PARAMS, tick_kernel=kernel,
                      samples="summary", device="cpu")
    assert sorted(a.summary) == sorted(b.summary)
    for k in a.summary:
        x, y = np.asarray(a.summary[k]), np.asarray(b.summary[k])
        scale = max(float(np.abs(x).max()), 1.0)
        np.testing.assert_allclose(y, x, rtol=5e-4, atol=5e-4 * scale, err_msg=k)
    assert b.achieved_ktps == pytest.approx(a.achieved_ktps, rel=1e-4)
    assert b.bottleneck_node() == a.bottleneck_node()
    # trajectory access refetches the row in full mode, as the reference does
    full = port.simulate(ct, 1e6, duration_s=6.0, params=PORT_PARAMS, tick_kernel=kernel,
                         device="cpu")
    for k in full.samples:
        np.testing.assert_array_equal(b.samples[k], full.samples[k], err_msg=k)
    bare = port.SimResult(b.structure, b.params, b.offered_ktps, summary=b.summary,
                          mode="summary")
    with pytest.raises(port.TrajectoryUnavailable):
        bare.samples


@pytest.mark.parametrize("name", WORKLOADS)
def test_port_sparse_matches_port_dense(name):
    _, ct = _configs(name)
    d = port.simulate(ct, 1e6, duration_s=4.0, params=port.SimParams(),
                      tick_kernel="dense", device="cpu")
    s = port.simulate(ct, 1e6, duration_s=4.0, params=port.SimParams(),
                      tick_kernel="sparse", device="cpu")
    assert s.achieved_ktps == pytest.approx(d.achieved_ktps, rel=1e-4)
    _metrics_close(d.samples, s.samples)


def test_summary_equals_reductions_of_full_mode():
    _, ct = _configs("deep_pipeline")
    full = port.simulate(ct, 1e6, duration_s=4.0, device="cpu")
    summ = port.simulate(ct, 1e6, duration_s=4.0, samples="summary", device="cpu")
    for k in full.summary:
        np.testing.assert_allclose(summ.summary[k], full.summary[k], rtol=1e-6, atol=1e-6)
    assert summ.achieved_ktps == pytest.approx(full.achieved_ktps, rel=1e-6)


def test_batch_rows_match_single_runs_and_buckets_do_not_move_results():
    """A row's trajectory is bit for bit the same alone, inside a padded
    batch and in larger buckets, with noise on, on both ticks: the noise is
    drawn per row from its seed over the padded instances, and every
    container sum runs in instance order."""
    cfgs = [_configs("deep_pipeline", lambda i, p=p: p, 2 + p)[1] for p in (1, 2)]
    for kernel in ("dense", "sparse"):
        single = [port.simulate(c, 300.0, duration_s=4.0, tick_kernel=kernel, device="cpu")
                  for c in cfgs]
        batch = port.simulate_batch(cfgs, 300.0, duration_s=4.0, seeds=[0, 0],
                                    min_inst_bucket=64, min_batch_bucket=8,
                                    tick_kernel=kernel, min_edge_bucket=512,
                                    device="cpu")
        assert len(batch) == 2
        for a, b in zip(single, batch):
            assert sorted(a.samples) == sorted(b.samples)
            for k in a.samples:
                np.testing.assert_array_equal(b.samples[k], a.samples[k], err_msg=f"{kernel} {k}")
            assert b.achieved_ktps == a.achieved_ktps


# The inputs at which the port's results moved with the buckets while the
# reference's did not: its container sums were a one-hot ``torch.bmm``,
# whose summation order BLAS picks from the shape.  Summary mode adds the
# epilogue's source sum over the padded instances.
BUCKET_CASES = [
    (par, kernel, buckets, samples)
    for par in ({"W": 3, "C": 2}, {"W": 4, "C": 4})
    for kernel in ("dense", "sparse")
    for buckets in ((32, 32), (128, 32))
    for samples in ("full", "summary")
]


@pytest.mark.parametrize("par,kernel,buckets,samples", BUCKET_CASES)
def test_buckets_leave_results_bitwise_equal(par, kernel, buckets, samples):
    dag = port.WORKLOADS["wordcount"]()
    cfg = port_core.round_robin_configuration(dag, par, 1, port_core.ContainerDim(3.0, 4096.0))
    base = port.simulate_batch([cfg], 1e6, duration_s=2.0, tick_kernel=kernel,
                               samples=samples, device="cpu")[0]
    padded = port.simulate_batch([cfg], 1e6, duration_s=2.0, tick_kernel=kernel,
                                 min_inst_bucket=buckets[0], min_cont_bucket=buckets[1],
                                 samples=samples, device="cpu")[0]
    assert padded.achieved_ktps == base.achieved_ktps
    assert padded.bottleneck_node() == base.bottleneck_node()
    got, want = ((padded.samples, base.samples) if samples == "full"
                 else (padded.summary, base.summary))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dense_tick_takes_the_sparse_ticks_row_sums(monkeypatch):
    """Both ticks derive each edge's share from :func:`padded_rowsum`, the
    real rows' float32 sums staged from the host, so no padded ``W.sum``
    runs on the device."""
    _, ct = _configs("diamond")
    st = port.structure_for(ct, PORT_PARAMS)
    rowsum = port_sim.padded_rowsum(st, 32)
    np.testing.assert_array_equal(rowsum[: st.n_inst], st.W.astype(np.float32).sum(axis=1))
    assert not rowsum[st.n_inst:].any()
    sparse = port.pad_structure(st, 32, 8, 32)
    np.testing.assert_array_equal(sparse["rowsum"], rowsum)
    staged = []
    real_core = port_sim._simulate_core

    def core(arrays, *args, **kwargs):
        staged.append(arrays["rowsum"].clone())
        return real_core(arrays, *args, **kwargs)

    monkeypatch.setattr(port_sim, "_simulate_core", core)
    port.simulate_batch([ct], 1e6, duration_s=0.5, params=PORT_PARAMS, tick_kernel="dense",
                        min_inst_bucket=32, device="cpu")
    np.testing.assert_array_equal(staged[0][0].numpy(), rowsum)


#: Port against reference with noise on.  The noise bits are the
#: reference's exactly; torch's ``erfinv`` differs from XLA's by a few
#: float32 ulps (normals within 3e-6 relative, ``test_torch_prng.py``), and
#: the two packages' float sums differ in order, so the trajectories agree
#: to within 1e-5 of each series' largest value (measured: 2.2e-7 on the
#: CPU) and the achieved rate to rel 1e-5 (measured: 9.4e-8).
NOISY_RTOL = 1e-5


@pytest.mark.parametrize("kernel", ["dense", "sparse"])
@pytest.mark.parametrize("par", [{"W": 2, "C": 1}, {"W": 3, "C": 2}])
def test_noise_on_matches_reference(par, kernel):
    """At the default ``noise_std`` (0.03), the same seed gives the same
    run in both packages: with ``{"W": 2, "C": 1}`` in one 3-CPU container
    both measure 649.233 ktps (a ``torch.Generator`` per row gave 670.129,
    3.2% off)."""
    dag_r, dag_t = ref.WORKLOADS["wordcount"](), port.WORKLOADS["wordcount"]()
    cr = ref_core.round_robin_configuration(dag_r, par, 1, ref_core.ContainerDim(3.0, 4096.0))
    ct = port_core.round_robin_configuration(dag_t, par, 1, port_core.ContainerDim(3.0, 4096.0))
    a = ref.simulate(cr, 1e6, duration_s=2.0, tick_kernel=kernel)
    b = port.simulate(ct, 1e6, duration_s=2.0, tick_kernel=kernel, device="cpu")
    assert b.achieved_ktps == pytest.approx(a.achieved_ktps, rel=NOISY_RTOL)
    if par == {"W": 2, "C": 1}:
        assert b.achieved_ktps == pytest.approx(649.233, abs=1e-3)
    assert sorted(a.samples) == sorted(b.samples)
    for k in a.samples:
        x, y = np.asarray(a.samples[k]), np.asarray(b.samples[k])
        scale = max(float(np.abs(x).max()), 1e-30)
        np.testing.assert_allclose(y, x, rtol=NOISY_RTOL, atol=NOISY_RTOL * scale, err_msg=k)
    assert b.bottleneck_node() == a.bottleneck_node()


def test_noise_is_seeded_and_per_row():
    _, ct = _configs("diamond")
    a = port.simulate_batch([ct, ct], 1e6, duration_s=2.0, seeds=[1, 2], device="cpu")
    b = port.simulate_batch([ct], 1e6, duration_s=2.0, seeds=[1], device="cpu")
    np.testing.assert_array_equal(a[0].samples["caputil"], b[0].samples["caputil"])
    assert not np.array_equal(a[0].samples["caputil"], a[1].samples["caputil"])


# normals per pass: one window, or three windows of (B 2, 25 ticks, I 8)
@pytest.mark.parametrize("per_pass", [1, 3 * 2 * 25 * 8])
def test_noise_drawn_windows_at_a_time_equals_one_window_per_pass(monkeypatch, per_pass):
    """By default the run's 40 windows of noise come in one pass; one
    window per pass, or three (a short last pass), give the same run bit
    for bit."""
    _, ct = _configs("diamond")
    base = port.simulate_batch([ct, ct], 1e6, duration_s=10.0, seeds=[1, 2], device="cpu")
    monkeypatch.setattr(port_sim, "NOISE_DRAW_ELEMENTS", per_pass)
    small = port.simulate_batch([ct, ct], 1e6, duration_s=10.0, seeds=[1, 2], device="cpu")
    for a, b in zip(base, small):
        for k in a.samples:
            np.testing.assert_array_equal(b.samples[k], a.samples[k], err_msg=k)


def test_metrics_store_matches_reference():
    cr, ct = _configs("diamond")
    a = ref.simulate(cr, 200.0, duration_s=4.0, params=REF_PARAMS).to_metrics_store()
    b = port.simulate(ct, 200.0, duration_s=4.0, params=PORT_PARAMS,
                      device="cpu").to_metrics_store()
    assert len(a) == len(b) and a.nodes() == b.nodes()
    for x, y in zip(a.samples, b.samples):
        assert (x.node, x.container, x.slot) == (y.node, y.container, y.slot)
        scale = max(float(np.abs(x.rate_in_ktps).max()), 1.0)
        np.testing.assert_allclose(y.rate_in_ktps, x.rate_in_ktps, rtol=5e-4, atol=5e-4 * scale)


def test_grid_and_training_sweep_shapes():
    _, ct = _configs("wordcount")
    grid = port.simulate_grid([ct, ct], [100.0, 200.0, 300.0], duration_s=2.0,
                              samples="summary", device="cpu")
    assert [len(r) for r in grid] == [3, 3]
    assert grid[0][2].achieved_ktps > grid[0][0].achieved_ktps
    store = port.training_sweep(ct, [100.0, 200.0], seconds_per_rate=2.0, device="cpu")
    n_rows = port.structure_for(ct, port.SimParams())
    assert len(store) == 2 * (n_rows.n_inst + n_rows.n_cont)


def test_bad_arguments_raise():
    _, ct = _configs("wordcount")
    with pytest.raises(ValueError):
        port.simulate_batch([ct], 100.0, samples="trajectory", device="cpu")
    with pytest.raises(ValueError):
        port.simulate_batch([ct, ct], [1.0], device="cpu")
    with pytest.raises(ValueError):
        port.simulate_batch([ct], [np.array([])], device="cpu")
    assert port.simulate_batch([], 100.0, device="cpu") == []
