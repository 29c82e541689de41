"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the simulator's ticks running through the stream kernels (bit for
bit the same at any bucket), and
the models' prefill and decode running through the RMSNorm, flash and
selective-scan kernels, the backward kernels of RMSNorm, flash attention
and the selective scan, and training on the card.

This file imports no JAX, so it runs on a machine that has only the port's
dependencies.  Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import ContainerDim, round_robin_configuration
from repro_torch.interop import stage_padded
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
    flash_attention_with_lse,
)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import (
    add_rmsnorm,
    add_rmsnorm_backward,
    add_rmsnorm_backward_reference,
    add_rmsnorm_reference,
    rmsnorm,
    rmsnorm_backward,
    rmsnorm_backward_reference,
    rmsnorm_reference,
)
from repro_torch.kernels.ssm_scan import (
    ssm_scan,
    ssm_scan_backward,
    ssm_scan_backward_reference,
    ssm_scan_reference,
    ssm_scan_with_checkpoints,
)
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.stream_flow import (
    container_members,
    container_sum,
    container_sum_reference,
    ell_rows,
    ordered_sum,
    ordered_sum_reference,
    stream_flow_ell,
    stream_flow_ell_reference,
)
from repro_torch.launch.serve import SEQUENCE_CACHES
from repro_torch.models import build_model
from repro_torch.streams import (
    SimParams,
    deep_pipeline,
    degree_bucket_size,
    measure_capacity,
    simulate_batch,
    wordcount,
)

pytestmark = pytest.mark.cuda

ELL_ARGS = ("qout", "edge_src", "edge_share", "edge_remote", "edge_src_cont",
            "edge_dst_cont", "ell_src", "ell_dst", "cont_of", "sm_budget")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return resolve_device("cuda")


def _problem(rng, batch, n_inst, n_cont, n_edges, device):
    """Random flow steps in the simulator's layout: the last tenth of the
    edges padded with zero share, ELL rows over the real edges."""
    n_real = n_edges - n_edges // 10
    rows = []
    for _ in range(batch):
        src = np.sort(rng.integers(0, n_inst, n_real)).astype(np.int32)
        dst = rng.integers(0, n_inst, n_real).astype(np.int32)
        cont_of = rng.integers(0, n_cont, n_inst).astype(np.int32)
        rows.append((src, dst, cont_of))
    d_out = degree_bucket_size(max(np.bincount(r[0]).max() for r in rows))
    d_in = degree_bucket_size(max(np.bincount(r[1]).max() for r in rows))

    def pad(x, fill, dtype):
        out = np.full(n_edges, fill, dtype)
        out[: x.shape[0]] = x
        return out

    arrays = []
    for src, dst, cont_of in rows:
        arrays.append(dict(
            qout=rng.uniform(0.0, 5.0, n_inst).astype(np.float32),
            edge_src=pad(src, n_inst - 1, np.int32),
            edge_share=pad(rng.uniform(0.0, 1.0, n_real).astype(np.float32), 0.0, np.float32),
            edge_remote=pad((cont_of[src] != cont_of[dst]).astype(np.float32), 0.0, np.float32),
            edge_src_cont=pad(cont_of[src], n_cont - 1, np.int32),
            edge_dst_cont=pad(cont_of[dst], n_cont - 1, np.int32),
            ell_src=ell_rows(src, n_inst, d_out, n_edges),
            ell_dst=ell_rows(dst, n_inst, d_in, n_edges),
            cont_of=cont_of,
            sm_budget=rng.uniform(0.5, 4.0, n_cont).astype(np.float32),
        ))
    return stage_padded({k: np.stack([a[k] for a in arrays]) for k in arrays[0]}, device)


@pytest.mark.parametrize("shape", [(1, 32, 8, 100), (4, 1024, 512, 49152)])
def test_stream_flow_kernel_matches_plain_version(cuda, shape):
    batch, n_inst, n_cont, n_edges = shape
    p = _problem(np.random.default_rng(n_edges), batch, n_inst, n_cont, n_edges, cuda)
    before = stream_flow_ell.launches
    got = stream_flow_ell(*[p[k] for k in ELL_ARGS])
    want = stream_flow_ell_reference(*[p[k] for k in ELL_ARGS])
    torch.cuda.synchronize()
    assert stream_flow_ell.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))
    # deterministic: no atomics, fixed summation order
    again = stream_flow_ell(*[p[k] for k in ELL_ARGS])
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_stream_flow_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    p = _problem(np.random.default_rng(1), 1, 32, 8, 100, cuda)
    args = [p[k] for k in ELL_ARGS]
    wrong_index = list(args)
    wrong_index[1] = args[1].long()
    with pytest.raises(ValueError, match="edge_src"):
        stream_flow_ell(*wrong_index)
    strided = list(args)
    strided[6] = args[6].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        stream_flow_ell(*strided)
    mixed = list(args)
    mixed[9] = args[9].cpu()
    with pytest.raises(ValueError, match="sm_budget"):
        stream_flow_ell(*mixed)


def test_sparse_tick_runs_the_kernel_and_matches_dense(cuda):
    dag = deep_pipeline()
    cfg = round_robin_configuration(dag, {n: 2 for n in dag.node_names}, 4,
                                    ContainerDim(3.0, 4096.0))
    params = SimParams()
    before = stream_flow_ell.launches
    sparse = measure_capacity(cfg, params, duration_s=4.0, tick_kernel="sparse", device=cuda)
    assert stream_flow_ell.launches - before == int(4.0 / params.dt)
    dense = measure_capacity(cfg, params, duration_s=4.0, tick_kernel="dense", device=cuda)
    assert sparse == pytest.approx(dense, rel=1e-4)
    host = measure_capacity(cfg, params, duration_s=4.0, tick_kernel="sparse", device="cpu")
    # both devices draw the reference's threefry noise from the seed; only
    # erfinv's last bits and the summation orders differ
    assert sparse == pytest.approx(host, rel=1e-4)


def _pad_rows(p, n_inst, n_cont, n_edges, degree):
    """``p`` padded to larger I/K/E/D as the simulator pads: new instances
    in the last container with zero qout and empty ELL rows, new edges with
    zero share, every padding id moved to the new E."""
    B, I = p["qout"].shape
    K, E = p["sm_budget"].shape[1], p["edge_src"].shape[1]

    def grow(x, shape, fill):
        out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return out

    def ell(x):
        x = torch.where(x >= E, n_edges, x)
        return grow(x, (B, n_inst, degree), n_edges)

    return dict(
        qout=grow(p["qout"], (B, n_inst), 0.0),
        edge_src=grow(p["edge_src"], (B, n_edges), n_inst - 1),
        edge_share=grow(p["edge_share"], (B, n_edges), 0.0),
        edge_remote=grow(p["edge_remote"], (B, n_edges), 0.0),
        edge_src_cont=grow(p["edge_src_cont"], (B, n_edges), n_cont - 1),
        edge_dst_cont=grow(p["edge_dst_cont"], (B, n_edges), n_cont - 1),
        ell_src=ell(p["ell_src"]),
        ell_dst=ell(p["ell_dst"]),
        cont_of=grow(p["cont_of"], (B, n_inst), n_cont - 1),
        sm_budget=grow(p["sm_budget"], (B, n_cont), 1.0),
    )


def _with_members(p):
    return [p[k] for k in ELL_ARGS] + [*container_members(p["cont_of"], p["sm_budget"].shape[1])]


@pytest.mark.parametrize("shape", [(6, 8, 4, 30), (1, 1024, 512, 57344), (2, 4096, 2048, 196608)])
def test_stream_flow_kernel_matches_plain_version_up_to_large_rows(cuda, shape):
    """I = 4096, K = 2048 needs 81,924 bytes per CTA, over the 48 KB that a
    block gets without opting in."""
    batch, n_inst, n_cont, n_edges = shape
    p = _problem(np.random.default_rng(n_inst + 15), batch, n_inst, n_cont, n_edges, cuda)
    before = stream_flow_ell.launches
    got = stream_flow_ell(*_with_members(p))
    want = stream_flow_ell_reference(*[p[k] for k in ELL_ARGS])
    torch.cuda.synchronize()
    assert stream_flow_ell.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))


def test_stream_flow_kernel_is_bitwise_invariant_to_batch_padding_and_cluster_size(cuda):
    """The fixed summation order makes a row's result independent of the
    rows beside it, of the padding and of how many CTAs share the row."""
    p = _problem(np.random.default_rng(21), 4, 1024, 512, 49152, cuda)
    batch = stream_flow_ell(*_with_members(p))
    single = {k: v[1:2].contiguous() for k, v in p.items()}
    padded = _pad_rows(single, 1536, 1024, 65536, 512)
    runs = [stream_flow_ell(*_with_members(single), cluster_size=n) for n in (1, 2, 8, 16)]
    runs.append(stream_flow_ell(*_with_members(padded)))
    runs.append(stream_flow_ell(*_with_members(padded), cluster_size=4))
    torch.cuda.synchronize()
    sizes = (1024, 1024, 512)
    for run in runs:
        for got, want, n in zip(run, batch, sizes):
            assert torch.equal(got[0, :n], want[1, :n])


def test_stream_flow_wrapper_rejects_bad_member_lists(cuda):
    p = _problem(np.random.default_rng(2), 2, 32, 8, 100, cuda)
    args = [p[k] for k in ELL_ARGS]
    ptr, members = container_members(p["cont_of"], 8)
    with pytest.raises(ValueError, match="cont_ptr"):
        stream_flow_ell(*args, ptr.long(), members)
    with pytest.raises(ValueError, match="cont_ptr"):
        stream_flow_ell(*args, ptr[:, :-1].contiguous(), members)
    with pytest.raises(ValueError, match="cont_members"):
        stream_flow_ell(*args, ptr, members.float())
    with pytest.raises(ValueError, match="cont_members"):
        stream_flow_ell(*args, ptr, members[:1].contiguous())
    with pytest.raises(ValueError, match="neither"):
        stream_flow_ell(*args, ptr, None)
    with pytest.raises(ValueError, match="cluster_size"):
        stream_flow_ell(*args, ptr, members, cluster_size=32)


def test_stream_flow_row_over_the_shared_memory_limit_raises(cuda):
    """(4 I + 2 K + 1) words per CTA: 16,384 instances and 8,192 containers
    need 327,684 bytes, over the card's 232,448."""
    n_inst, n_cont = 16384, 8192
    i32 = dict(dtype=torch.int32, device=cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    args = [
        torch.zeros(1, n_inst, **f32), torch.zeros(1, 1, **i32),
        torch.zeros(1, 1, **f32), torch.zeros(1, 1, **f32),
        torch.zeros(1, 1, **i32), torch.zeros(1, 1, **i32),
        torch.ones(1, n_inst, 4, **i32), torch.ones(1, n_inst, 4, **i32),
        torch.zeros(1, n_inst, **i32), torch.ones(1, n_cont, **f32),
    ]
    before = stream_flow_ell.launches
    with pytest.raises(ValueError, match="327684 bytes of shared memory"):
        stream_flow_ell(*args)
    assert stream_flow_ell.launches == before


# ------------------------------------------------------------ container sums
# Bit for bit the plain version: both add each container's members in
# instance order from 0.


@pytest.mark.parametrize("batch,n_inst,n_cont", [
    (1, 8, 4), (6, 32, 8), (32, 1024, 512), (2, 4096, 2048),
    (1, 20000, 64),   # 80,000 bytes of shared memory per block: over the 48 KB default
])
def test_container_sum_kernel_is_bitwise_plain_across_padding(cuda, batch, n_inst, n_cont):
    rng = np.random.default_rng(n_inst + batch)
    cont_of = torch.from_numpy(rng.integers(0, n_cont, (batch, n_inst)).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.uniform(0.0, 5.0, (batch, n_inst)).astype(np.float32)).to(cuda)
    want = container_sum_reference(vals.cpu(), cont_of.cpu(), n_cont)
    for extra_i, extra_k in ((0, 0), (5, 0), (512, 512)):
        K = n_cont + extra_k
        padded_of = torch.cat([cont_of, torch.full((batch, extra_i), K - 1, dtype=torch.int32,
                                                   device=cuda)], dim=1)
        padded = torch.cat([vals, torch.zeros(batch, extra_i, device=cuda)], dim=1)
        before = container_sum.launches
        got = container_sum(padded, padded_of, *container_members(padded_of, K))
        torch.cuda.synchronize()
        assert container_sum.launches == before + 1
        assert torch.equal(got[:, :n_cont].cpu(), want)
        assert not bool(got[:, n_cont:].any())


@pytest.mark.parametrize("batch,n_inst,n_cont,n_real,n_real_cont", [
    (1, 1024, 512, 642, 321), (3, 1024, 512, 642, 321), (32, 1024, 512, 642, 321),
    (1, 4096, 2048, 4096, 2048), (3, 4096, 2048, 3000, 1500),
])
def test_container_sum_kernel_at_the_simulators_layout(cuda, batch, n_inst, n_cont, n_real,
                                                       n_real_cont):
    """The simulator's layout: real instances dealt over the real
    containers, every padded instance (a zero) in the last container; some
    real values are +0.0 or -0.0, which the kernel skips.  Bit for bit the
    host's plain version, real and padded containers alike."""
    rng = np.random.default_rng(n_inst + batch + n_real)
    cont_of = np.full((batch, n_inst), n_cont - 1, np.int32)
    cont_of[:, :n_real] = rng.integers(0, n_real_cont, (batch, n_real))
    vals = np.zeros((batch, n_inst), np.float32)
    vals[:, :n_real] = rng.uniform(-1.0, 5.0, (batch, n_real))
    vals[:, :n_real][rng.random((batch, n_real)) < 0.1] = 0.0
    vals[:, :n_real][rng.random((batch, n_real)) < 0.05] = -0.0
    cont_of, vals = torch.from_numpy(cont_of).to(cuda), torch.from_numpy(vals).to(cuda)
    want = container_sum_reference(vals.cpu(), cont_of.cpu(), n_cont)
    before = container_sum.launches
    got = container_sum(vals, cont_of, *container_members(cont_of, n_cont))
    torch.cuda.synchronize()
    assert container_sum.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_container_sum_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cont_of = torch.zeros(2, 16, dtype=torch.int32, device=cuda)
    vals = torch.ones(2, 16, device=cuda)
    ptr, members = container_members(cont_of, 4)
    before = container_sum.launches
    with pytest.raises(ValueError, match="cont_ptr"):
        container_sum(vals, cont_of, ptr.long(), members)
    with pytest.raises(ValueError, match="vals"):
        container_sum(vals.double(), cont_of, ptr, members)
    with pytest.raises(ValueError, match="vals"):
        container_sum(vals[:, ::2], cont_of[:, ::2], ptr, members[:, :8].contiguous())
    with pytest.raises(ValueError, match="cont_members"):
        container_sum(vals, cont_of, ptr, members[:, :8].contiguous())
    with pytest.raises(ValueError, match="cont_ptr is on cpu"):
        container_sum(vals, cont_of, ptr.cpu(), members)
    assert container_sum.launches == before
    # no row-wide staging: a row over shared memory's 58,112 values sums too
    wide = torch.zeros(1, 60000, dtype=torch.int32, device=cuda)
    got = container_sum(torch.ones(1, 60000, device=cuda), wide, *container_members(wide, 4))
    assert got.cpu().tolist() == [[60000.0, 0.0, 0.0, 0.0]]


# ------------------------------------------------------------- ordered sums
# Bit for bit the plain version (lane-strided adds, a fixed butterfly), and
# so bit for bit the same at any zero padding of B, R and L.


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 5, 70), (1, 1024, 1024), (32, 80, 1024),
                                   (3, 643, 641), (1, 4096, 300)])
def test_ordered_sum_kernel_is_bitwise_plain_across_padding(cuda, shape, dim, masked):
    rng = np.random.default_rng(sum(shape) + dim)
    x = torch.from_numpy(rng.uniform(-5.0, 5.0, shape).astype(np.float32))
    mask = torch.from_numpy(rng.random(shape) < 0.5) if masked else None
    want = ordered_sum_reference(x, dim, mask)
    B, R, L = shape
    for extra in ((0, 0, 0), (2, 0, 0), (0, 31, 0), (0, 0, 33), (1, 512, 512)):
        big = torch.zeros(B + extra[0], R + extra[1], L + extra[2])
        big[:B, :R, :L] = x
        big_mask = None
        if masked:
            big_mask = torch.zeros(big.shape, dtype=torch.bool)
            big_mask[:B, :R, :L] = mask
            big_mask = big_mask.to(cuda)
        before = ordered_sum.launches
        got = ordered_sum(big.to(cuda), dim, big_mask)
        torch.cuda.synchronize()
        assert ordered_sum.launches == before + 1
        n = R if dim == 2 else L
        got = got.cpu()
        assert torch.equal(got[:B, :n], want), extra
        assert not bool(got[B:].any()) and not bool(got[:, n:].any())
    # the plain version on the card: elementwise adds, the same bits
    on_card = ordered_sum_reference(x.to(cuda), dim, None if mask is None else mask.to(cuda))
    assert torch.equal(on_card.cpu(), want)


def test_ordered_sum_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.ones(2, 8, 16, device=cuda)
    mask = torch.ones(2, 8, 16, dtype=torch.bool, device=cuda)
    before = ordered_sum.launches
    with pytest.raises(ValueError, match="dim"):
        ordered_sum(x, 0)
    with pytest.raises(ValueError, match="x must"):
        ordered_sum(x.double(), 2)
    with pytest.raises(ValueError, match="x must"):
        ordered_sum(x[0], 1)
    with pytest.raises(ValueError, match="x must be contiguous"):
        ordered_sum(x.transpose(1, 2), 2)
    with pytest.raises(ValueError, match="mask"):
        ordered_sum(x, 2, mask.float())
    with pytest.raises(ValueError, match="mask"):
        ordered_sum(x, 2, mask[:, :4])
    with pytest.raises(ValueError, match="mask"):
        ordered_sum(x, 2, mask.cpu())
    assert ordered_sum.launches == before


@pytest.mark.parametrize("samples", ["full", "summary"])
@pytest.mark.parametrize("kernel", ["dense", "sparse"])
def test_tick_on_card_against_buckets_and_host(cuda, kernel, samples):
    """Both ticks' samples, and their summaries, are bit for bit the same
    at any bucket on the card: every sum over the padded instances runs in
    a fixed order (the flow kernel, container_sum, ordered_sum).  Both stay
    within 1e-4 of the host's run of the same seed."""
    dag = wordcount()
    cfg = round_robin_configuration(dag, {"W": 3, "C": 2}, 1, ContainerDim(3.0, 4096.0))
    before = ordered_sum.launches
    runs = [simulate_batch([cfg], 1e6, duration_s=2.0, tick_kernel=kernel, device=cuda,
                           min_inst_bucket=i, min_cont_bucket=k, samples=samples)[0]
            for i, k in ((0, 0), (32, 32), (128, 32))]
    per_run = (5 * 200 if kernel == "dense" else 0) + (samples == "summary")
    assert ordered_sum.launches == before + 3 * per_run
    host = simulate_batch([cfg], 1e6, duration_s=2.0, tick_kernel=kernel, device="cpu")[0]
    for r in runs[1:]:
        got, want = (r.samples, runs[0].samples) if samples == "full" else (r.summary, runs[0].summary)
        for key, base in want.items():
            np.testing.assert_array_equal(got[key], base, err_msg=key)
    assert runs[0].achieved_ktps == pytest.approx(host.achieved_ktps, rel=1e-4)


# ------------------------------------------------------------------ rmsnorm
# fp32: within 1e-6 (rtol and atol; the sum of squares runs in another
# order); bf16: within one bf16 ulp of the plain version.


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    a = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("shape", [(1, 150, 4096), (4, 1, 4096), (300, 96), (7, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_version(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    before = rmsnorm.launches
    got = rmsnorm(x, gain, 1e-5)
    want = rmsnorm_reference(x, gain, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert bool(((got.float() - want.float()).abs() <= _bf16_ulp(want)).all())
    assert torch.equal(got, rmsnorm(x, gain, 1e-5))   # fixed summation order


def test_rmsnorm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rmsnorm(x.half(), torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match="gain"):
        rmsnorm(x, torch.ones(32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x.t(), torch.ones(4, device=cuda))


def _add_norm_inputs(cuda, shape, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + shape[-1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    delta = (0.5 * torch.randn(shape, generator=g, device=cuda)).to(dtype)
    gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    return x, delta, gain


def _assert_norm_close(got, want):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert bool(((got.float() - want.float()).abs() <= _bf16_ulp(want)).all())


@pytest.mark.parametrize("shape", [(4, 1, 4096), (1, 168, 4096), (4, 1, 8192), (1, 168, 8192),
                                   (300, 4096), (300, 96), (7, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_kernel_matches_plain_version(cuda, shape, dtype):
    x, delta, gain = _add_norm_inputs(cuda, shape, dtype)
    before = (rmsnorm.launches, add_rmsnorm.launches)
    s, h = add_rmsnorm(x, delta, gain, 1e-5)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, add_rmsnorm.launches) == (before[0], before[1] + 1)
    assert s.dtype == h.dtype == dtype and s.shape == h.shape == x.shape
    want_s, want_h = add_rmsnorm_reference(x, delta, gain, 1e-5)
    assert torch.equal(s, want_s)                        # x + delta, rounded as torch rounds
    _assert_norm_close(h, want_h)
    assert torch.equal(h, rmsnorm(x + delta, gain, 1e-5))   # one summation order
    s2, h2 = add_rmsnorm(x, delta, gain, 1e-5)
    assert torch.equal(s2, s) and torch.equal(h2, h)     # run to run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4096, 4097, 130])
def test_add_rmsnorm_generic_path_keeps_the_order(cuda, dtype, d):
    """Unaligned views (one element into a buffer) and odd widths take the
    generic path; its norm is bit for bit the register path's on the same
    values, and both are the plain version's within tolerance."""
    rows = 6
    x, delta, _ = _add_norm_inputs(cuda, (rows * d + 1,), dtype, seed=3)
    gain = 1.0 + 0.1 * torch.randn(d, generator=torch.Generator(device=cuda).manual_seed(d),
                                   device=cuda)
    xv, dv = x[1:].view(rows, d), delta[1:].view(rows, d)
    s, h = add_rmsnorm(xv, dv, gain, 1e-5)
    want_s, want_h = add_rmsnorm_reference(xv, dv, gain, 1e-5)
    assert torch.equal(s, want_s)
    _assert_norm_close(h, want_h)
    aligned = (xv + dv).contiguous()                     # a fresh, aligned tensor
    assert torch.equal(h, rmsnorm(aligned, gain, 1e-5))
    assert torch.equal(rmsnorm(xv, gain, 1e-5), rmsnorm(xv.clone(), gain, 1e-5))


@pytest.mark.parametrize("d", [4096, 8192, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_rows_do_not_depend_on_the_batch(cuda, d, dtype):
    """A row's bits are the same alone, among 4 rows (decode) and among 40
    (prefill): nothing in the launch depends on the row count."""
    x, delta, gain = _add_norm_inputs(cuda, (40, d), dtype, seed=7)
    s, h = add_rmsnorm(x, delta, gain, 1e-5)
    for lo, hi in ((0, 4), (36, 40), (17, 18)):
        s_part, h_part = add_rmsnorm(x[lo:hi].contiguous(), delta[lo:hi].contiguous(), gain, 1e-5)
        assert torch.equal(s_part, s[lo:hi]) and torch.equal(h_part, h[lo:hi])
        alone = rmsnorm(x[lo:hi].contiguous(), gain, 1e-5)
        assert torch.equal(alone, rmsnorm(x, gain, 1e-5)[lo:hi])


def test_add_rmsnorm_without_delta_runs_the_plain_norm_kernel(cuda):
    x, _, gain = _add_norm_inputs(cuda, (4, 1, 4096), torch.float32)
    before = (rmsnorm.launches, add_rmsnorm.launches)
    s, h = add_rmsnorm(x, None, gain, 1e-5)
    assert s is x
    assert (rmsnorm.launches, add_rmsnorm.launches) == (before[0] + 1, before[1])
    assert torch.equal(h, rmsnorm(x, gain, 1e-5))


def test_add_rmsnorm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, delta, gain = _add_norm_inputs(cuda, (4, 64), torch.float32)
    before = add_rmsnorm.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        add_rmsnorm(x.half(), delta.half(), gain)
    with pytest.raises(ValueError, match="delta must match"):
        add_rmsnorm(x, delta.bfloat16(), gain)
    with pytest.raises(ValueError, match="delta must match"):
        add_rmsnorm(x, delta[:, :32], gain)
    with pytest.raises(ValueError, match="delta is on"):
        add_rmsnorm(x, delta.cpu(), gain)
    with pytest.raises(ValueError, match="delta must be contiguous"):
        add_rmsnorm(x, delta.t().contiguous().t(), gain)
    with pytest.raises(ValueError, match="gain"):
        add_rmsnorm(x, delta, gain[:32])
    with pytest.raises(ValueError, match="x must be contiguous"):
        add_rmsnorm(x.t(), delta.t(), torch.ones(4, device=cuda))
    assert add_rmsnorm.launches == before


# ---------------------------------------------------------- flash attention
# fp32: within 2e-5 (rtol and atol; online softmax over tiles against one
# softmax over the row).


def _qkv(cuda, S, H, KV, hd, dtype=torch.float32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(1, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(1, S, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, S, KV, hd, generator=g, device=cuda).to(dtype)
    return q, k, v


@pytest.mark.parametrize("S", [1, 7, 128, 130, 192])
def test_flash_kernel_matches_plain_version_at_llama_shapes(cuda, S):
    q, k, v = _qkv(cuda, S, 32, 8, 128, seed=S)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, scale=1.0 / 128 ** 0.5)
    want = flash_attention_reference(q, k, v, causal=True, scale=1.0 / 128 ** 0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, flash_attention(q, k, v, causal=True, scale=1.0 / 128 ** 0.5))


@pytest.mark.parametrize("S,H,KV,hd,causal,window", [
    (130, 32, 8, 128, True, 32),      # sliding window
    (130, 32, 8, 128, False, None),   # non-causal, S not a tile multiple
    (100, 32, 8, 120, True, None),    # h2o-danube's head_dim
    (70, 4, 4, 16, False, 9),         # smoke head_dim, window without causal
    (50, 4, 2, 18, True, None),       # head_dim not a multiple of 4: scalar loads
])
def test_flash_kernel_matches_plain_version_masks_and_head_dims(cuda, S, H, KV, hd, causal, window):
    q, k, v = _qkv(cuda, S, H, KV, hd, seed=hd)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S", [34, 168])
def test_flash_kernel_matches_plain_version_at_jamba_heads(cuda, S):
    """jamba-1.5-large's attention block: 64 query heads over 8 kv heads,
    so a block's heads share a K/V tile among a group of 8."""
    q, k, v = _qkv(cuda, S, 64, 8, 128, seed=S + 64)
    got = flash_attention(q, k, v, causal=True, scale=1.0 / 128 ** 0.5)
    want = flash_attention_reference(q, k, v, causal=True, scale=1.0 / 128 ** 0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("H,KV", [(3, 1), (5, 5), (6, 2)])
def test_flash_kernel_takes_odd_head_groups(cuda, H, KV):
    """A group of an odd number of query heads leaves one warp of a block
    without a head; it must neither write nor disturb its neighbour."""
    q, k, v = _qkv(cuda, 45, H, KV, 64, seed=H)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("S,H,KV,hd,causal,window", [
    (45, 3, 1, 64, True, None),       # odd group: a two-head block's second head is idle
    (45, 6, 2, 64, True, None),
    (34, 32, 8, 128, True, None),     # llama3-8b's shortest serving prompt
    (168, 64, 8, 128, True, None),    # jamba's longest
    (130, 32, 8, 128, True, 32),
    (130, 32, 8, 128, False, None),
    (50, 4, 2, 18, True, None),
])
def test_flash_kernel_at_one_and_two_heads_per_block(cuda, heads, S, H, KV, hd, causal, window):
    """The wrapper picks one or two query heads per block from the grid
    size; both layouts hold the plain version's tolerance at any shape.
    In bf16 the output is the rounding of an fp32 result within that
    tolerance: near zero the fp32 gap can exceed a bf16 ulp of the value,
    so the bound is the fp32 tolerance plus one ulp of the plain fp32
    result on the same bf16 inputs."""
    q, k, v = _qkv(cuda, S, H, KV, hd, seed=S + H)
    got = flash_attention(q, k, v, causal=causal, window=window, heads_per_block=heads)
    want = flash_attention_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    got = flash_attention(*bf, causal=causal, window=window, heads_per_block=heads)
    want = flash_attention_reference(*[t.float() for t in bf], causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    bound = 2e-5 + 2e-5 * want.abs() + _bf16_ulp(want)
    assert bool(((got.float() - want).abs() <= bound).all())


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("S,Sk,H,KV,hd", [
    (1, 512, 16, 16, 64),       # seamless cross-attention, one query
    (34, 512, 16, 16, 64),      # seamless cross-attention at a serving prompt
    (168, 512, 16, 16, 64),
    (130, 7, 6, 2, 64),         # fewer keys than queries, a ragged key tile
    (45, 100, 3, 1, 120),       # odd group, head_dim 120
])
def test_flash_kernel_with_keys_of_their_own_length(cuda, heads, S, Sk, H, KV, hd):
    """Non-causal calls whose k and v hold Sk != S keys (the decoder's
    cross-attention over the encoder's frames) against the plain version,
    fp32 and bf16 as the equal-length cases are held."""
    g = torch.Generator(device=cuda).manual_seed(S * 7 + Sk)
    q = torch.randn(2, S, H, hd, generator=g, device=cuda)
    k = torch.randn(2, Sk, KV, hd, generator=g, device=cuda)
    v = torch.randn(2, Sk, KV, hd, generator=g, device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False, heads_per_block=heads)
    want = flash_attention_reference(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    got = flash_attention(*bf, causal=False, heads_per_block=heads)
    want = flash_attention_reference(*[t.float() for t in bf], causal=False)
    torch.cuda.synchronize()
    bound = 2e-5 + 2e-5 * want.abs() + _bf16_ulp(want)
    assert bool(((got.float() - want).abs() <= bound).all())


def test_flash_kernel_refuses_keys_of_their_own_length_when_causal_or_windowed(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, 16, 4, 16, generator=g, device=cuda)
    k = torch.randn(1, 24, 2, 16, generator=g, device=cuda)
    before = flash_attention.launches
    for causal, window in ((True, None), (False, 8)):
        with pytest.raises(ValueError, match="as many keys as queries"):
            flash_attention(q, k, k, causal=causal, window=window)
    with pytest.raises(ValueError, match="no keys"):
        flash_attention(q, k[:, :0], k[:, :0], causal=False)
    assert flash_attention.launches == before


def test_flash_kernel_takes_unaligned_tensors(cuda):
    """A tensor that starts one element into its storage is contiguous but
    not 16-byte aligned: the kernel reads it element by element."""
    q, k, v = _qkv(cuda, 40, 8, 2, 64, seed=4)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    got = flash_attention(shifted, k, v)
    want = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_kernel_bf16_within_bf16_rounding(cuda):
    q, k, v = _qkv(cuda, 96, 8, 2, 64, dtype=torch.bfloat16, seed=3)
    got = flash_attention(q, k, v)
    want = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs() <= _bf16_ulp(want)).all())


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 16, 4, 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*_qkv(cuda, 16, 4, 2, 160))
    with pytest.raises(ValueError, match="k is"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="group"):
        flash_attention(*_qkv(cuda, 16, 4, 3, 16))
    with pytest.raises(ValueError, match="heads_per_block"):
        flash_attention(q, k, v, heads_per_block=4)


# -------------------------------------------------------------------- model


@pytest.mark.parametrize("arch", ["llama3-8b@smoke", "h2o-danube-3-4b@smoke"])
def test_model_on_card_runs_the_kernels_and_matches_the_host(cuda, arch):
    cfg = get_config(arch)
    host = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=cuda, seed=0)
    card.load_state_dict(host.state_dict())
    tokens = torch.arange(4, 44).reshape(1, 40) % cfg.vocab
    before = (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches)
    got, _ = card.forward_prefill(tokens.to(cuda))
    want, _ = host.forward_prefill(tokens)
    torch.cuda.synchronize()
    L = cfg.n_layers
    # the first norm alone, every other norm fused with the residual add
    assert (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches) == (
        before[0] + 1, before[1] + 2 * L, before[2] + L)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("S", [1, 34, 168])
def test_flash_kernel_at_mla_widths_with_padded_v(cuda, S):
    """minicpm3's prefill: 40 heads, q and k ``[nope ‖ rope]`` at 96, v at 64
    zero-padded to 96, scale 1/sqrt(96), causal.  The kernel is within 2e-5
    of its plain version on the padded inputs, its padded output columns
    are exactly zero, and the first 64 columns are attention with v at its
    own width."""
    H, qk, vd = 40, 96, 64
    q, k, v = _qkv(cuda, S, H, H, qk, seed=S + 96)
    v = v[..., :vd]
    vpad = torch.nn.functional.pad(v, (0, qk - vd)).contiguous()
    scale = 1.0 / qk ** 0.5
    got = flash_attention(q, k, vpad, causal=True, scale=scale)
    want = flash_attention_reference(q, k, vpad, causal=True, scale=scale)
    scores = torch.einsum("bshd,bthd->bhst", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=cuda).tril()
    narrow = torch.einsum("bhst,bthd->bshd",
                          torch.softmax(torch.where(mask, scores, -1e30), dim=-1), v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got[..., vd:], torch.zeros_like(got[..., vd:]))
    torch.testing.assert_close(got[..., :vd], narrow, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b@smoke", "mixtral-8x7b@smoke", "minicpm3-4b@smoke",
                                  "jamba-1.5-large-398b@smoke"])
def test_moe_and_mla_models_on_card_run_the_kernels_and_match_the_host(cuda, arch):
    """Per forward: 1 + 2·(MLA layers) ``rmsnorm`` (the embedding's norm and
    MLA's two latent norms a layer), 2L ``add_rmsnorm`` (an MoE layer's norm
    fused as a dense MLP's is); per prefill one flash launch per attention
    block.  Logits within rtol 1e-4, atol 1e-4·max of the host's, prefill
    and one decode step."""
    cfg = get_config(arch)
    host = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=cuda, seed=0)
    card.load_state_dict(host.state_dict())
    tokens = torch.arange(4, 44).reshape(1, 40) % cfg.vocab
    L = cfg.n_layers
    attn = cfg.n_periods() * cfg.pattern().count("attn")
    mla = attn if cfg.attention == "mla" else 0
    before = (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches)
    got, gc = card.forward_prefill(tokens.to(cuda))
    want, hc = host.forward_prefill(tokens)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(
        (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches), before)) == (
        1 + 2 * mla, 2 * L, attn)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    caches = {"card": card.cache_struct(1, 48), "host": host.cache_struct(1, 48)}
    for name, c1 in (("card", gc), ("host", hc)):
        for key, layer in c1.items():
            for n, t in layer.items():
                if n in SEQUENCE_CACHES:
                    caches[name][key][n][:, :, :t.shape[2]] = t
                else:
                    caches[name][key][n].copy_(t)
    before = (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches)
    gd, _ = card.forward_decode(torch.tensor([[7]], device=cuda), caches["card"], 40)
    wd, _ = host.forward_decode(torch.tensor([[7]]), caches["host"], 40)
    torch.cuda.synchronize()
    assert (rmsnorm.launches - before[0], add_rmsnorm.launches - before[1],
            flash_attention.launches - before[2]) == (1 + 2 * mla, 2 * L, 0)
    torch.testing.assert_close(gd.cpu(), wd, rtol=1e-4, atol=1e-4 * float(wd.abs().max()))
    for key, layer in caches["host"].items():
        for n, w in layer.items():
            torch.testing.assert_close(caches["card"][key][n].cpu(), w, rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()))


# ----------------------------------------------------------------- ssm scan
# fp32: rtol 1e-5, atol 1e-5·max|y| (the sum over the state width runs in
# another order); bf16 inputs: 3e-2, as the reference holds its Pallas
# kernel to its oracle.


def _scan_inputs(cuda, B, S, D, N, dtype=torch.float32, seed=0, strided=False):
    """Seeded inputs in the Mamba block's ranges, non-zero h0; with
    ``strided`` B and C are slices of one projection, as the block makes
    them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, device=cuda)
    dt = torch.nn.functional.softplus(r(B, S, D)) * 0.1
    x = r(B, S, D)
    if strided:
        proj = r(B, S, 3 + 2 * N) * 0.5
        _, bm, cm = proj.split([3, N, N], dim=-1)
    else:
        bm, cm = r(B, S, N) * 0.5, r(B, S, N) * 0.5
    a = -torch.exp(r(D, N) * 0.3)
    h0 = r(B, D, N) * 0.1
    return dt.to(dtype), x.to(dtype), bm.to(dtype), cm.to(dtype), a, h0


def _scan_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
        else:
            torch.testing.assert_close(g, w, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("shape", [
    (1, 168, 16384, 16),   # jamba's longest serving prompt
    (1, 7, 16384, 16),
    (1, 130, 16384, 16),   # S not a multiple of the kernel's 32-step ranges
    (4, 1, 16384, 16),     # decode
    (2, 100, 48, 4),       # the reference kernel tests' odd shape
    (3, 33, 200, 8),       # D not a multiple of the 128-channel block
])
def test_ssm_scan_kernel_matches_plain_version(cuda, shape):
    B, S, D, N = shape
    args = _scan_inputs(cuda, B, S, D, N, seed=S + N, strided=True)
    before = ssm_scan.launches
    got = ssm_scan(*args)
    want = ssm_scan_reference(*args)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    _scan_close(got, want, torch.float32)
    again = ssm_scan(*args)
    assert all(torch.equal(g, a) for g, a in zip(got, again))   # fixed order


@pytest.mark.parametrize("shape", [
    (1, 168, 16384, 16), (1, 34, 16384, 16), (4, 1, 16384, 16),   # jamba's prefill and decode
    (3, 33, 200, 8), (2, 100, 48, 4),                              # N below 16: lanes masked
])
def test_ssm_scan_kernel_state_is_bitwise_plain(cuda, shape):
    """The recurrence rounds each product and sum on its own and uses expf,
    as the plain version's tensor operations do, so hT is bit for bit the
    plain version's; only y's sum over the state width takes another
    order."""
    B, S, D, N = shape
    args = _scan_inputs(cuda, B, S, D, N, seed=S * 3 + N, strided=True)
    got = ssm_scan(*args)
    want = ssm_scan_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    _scan_close(got, want, torch.float32)


def test_ssm_scan_kernel_takes_an_unaligned_state(cuda):
    """h0 one float into its storage: contiguous, not 16-byte aligned, so
    each lane moves its states one float at a time."""
    args = list(_scan_inputs(cuda, 2, 20, 96, 16, seed=9))
    shifted = torch.empty(args[5].numel() + 1, device=cuda)[1:].view(args[5].shape)
    shifted.copy_(args[5])
    args[5] = shifted
    got = ssm_scan(*args)
    want = ssm_scan_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    _scan_close(got, want, torch.float32)


def test_ssm_scan_kernel_bf16_inputs(cuda):
    args = _scan_inputs(cuda, 2, 75, 1000, 16, dtype=torch.bfloat16, seed=2)
    got = ssm_scan(*args)
    want = ssm_scan_reference(*args)
    torch.cuda.synchronize()
    _scan_close(got, want, torch.bfloat16)


def test_ssm_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    dt, x, bm, cm, a, h0 = _scan_inputs(cuda, 1, 8, 64, 16)
    with pytest.raises(ValueError, match="state width"):
        ssm_scan(*_scan_inputs(cuda, 1, 8, 64, 17))
    with pytest.raises(ValueError, match="x is"):
        ssm_scan(dt, x.bfloat16(), bm, cm, a, h0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssm_scan(*(t.half() for t in (dt, x, bm, cm)), a, h0)
    with pytest.raises(ValueError, match="h0 is on"):
        ssm_scan(dt, x, bm, cm, a, h0.cpu())
    with pytest.raises(ValueError, match="bmat must have shape"):
        ssm_scan(dt, x, bm[:, :4], cm, a, h0)


def test_hybrid_model_on_card_runs_the_kernels_and_matches_the_host(cuda):
    import dataclasses

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b@smoke"), n_experts=0,
                              experts_per_token=0)
    host = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=cuda, seed=0)
    card.load_state_dict(host.state_dict())
    tokens = torch.arange(4, 44).reshape(1, 40) % cfg.vocab
    before = (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches,
              ssm_scan.launches)
    got, gc = card.forward_prefill(tokens.to(cuda))
    want, hc = host.forward_prefill(tokens)
    caches = {"card": card.cache_struct(1, 48), "host": host.cache_struct(1, 48)}
    for name, c1 in (("card", gc), ("host", hc)):
        caches[name]["b1_attn"]["k"][:, :, :40] = c1["b1_attn"]["k"]
        caches[name]["b1_attn"]["v"][:, :, :40] = c1["b1_attn"]["v"]
        for n in ("h", "conv"):
            caches[name]["b0_mamba"][n].copy_(c1["b0_mamba"][n])
    gd, _ = card.forward_decode(torch.tensor([[7]], device=cuda), caches["card"], 40)
    wd, _ = host.forward_decode(torch.tensor([[7]]), caches["host"], 40)
    torch.cuda.synchronize()
    P = cfg.n_periods()                 # one Mamba and one attention block per period
    assert (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches,
            ssm_scan.launches) == (before[0] + 2, before[1] + 2 * 2 * cfg.n_layers,
                                   before[2] + P, before[3] + 2 * P)
    for g, w in ((got, want), (gd, wd)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
    for n in ("h", "conv"):
        w = caches["host"]["b0_mamba"][n]
        torch.testing.assert_close(caches["card"]["b0_mamba"][n].cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2@smoke", "internvl2-26b@smoke"])
def test_frontend_models_on_card_run_the_kernels_and_match_the_host(cuda, arch):
    """Seeded non-zero frames: per prefill, an encoder-decoder model runs
    one flash launch per encoder layer (non-causal), per decoder layer
    (causal) and per cross sub-block (non-causal, the frames as keys), and
    its norms are 2 ``rmsnorm`` (encoder, decoder) and 2E + 3L
    ``add_rmsnorm``; a decode step, 1 and 3L.  The decoder-only frontend
    model runs L causal launches over frontend + prompt positions."""
    cfg = get_config(arch)
    host = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=cuda, seed=0)
    card.load_state_dict(host.state_dict())
    g = torch.Generator().manual_seed(3)
    frames = torch.randn(1, cfg.frontend_tokens, cfg.d_model, generator=g)
    tokens = torch.arange(4, 24).reshape(1, 20) % cfg.vocab
    before = (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches)
    got, gc = card.forward_prefill(tokens.to(cuda), frames.to(cuda))
    want, hc = host.forward_prefill(tokens, frames)
    torch.cuda.synchronize()
    L, E = cfg.n_layers, cfg.enc_layers
    if cfg.is_encdec:
        expect = (2, 2 * E + 3 * L, E + 2 * L)
    else:
        expect = (1, 2 * L, L)
    assert tuple(a - b for a, b in zip(
        (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches), before)) == expect
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    for key in hc:
        for n in ("k", "v"):
            w = hc[key][n]
            torch.testing.assert_close(gc[key][n].cpu(), w, rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()))
    T = hc["b0_attn"]["k"].shape[2]
    caches = {"card": card.cache_struct(1, T + 4), "host": host.cache_struct(1, T + 4)}
    for name, c1 in (("card", gc), ("host", hc)):
        for n in ("k", "v"):
            caches[name]["b0_attn"][n][:, :, :T] = c1["b0_attn"][n]
            if cfg.is_encdec:
                caches[name]["cross_kv"][n].copy_(c1["cross_kv"][n])
    before = (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches)
    gd, _ = card.forward_decode(torch.tensor([[7]], device=cuda), caches["card"], T)
    wd, _ = host.forward_decode(torch.tensor([[7]]), caches["host"], T)
    torch.cuda.synchronize()
    norms = 3 * L if cfg.is_encdec else 2 * L
    assert (rmsnorm.launches - before[0], add_rmsnorm.launches - before[1],
            flash_attention.launches - before[2]) == (1, norms, 0)
    torch.testing.assert_close(gd.cpu(), wd, rtol=1e-4, atol=1e-4 * float(wd.abs().max()))


# ------------------------------------------------------------------ backward
# The RMSNorm backward kernels against autograd through the plain forward
# versions: fp32 dx rtol 1e-5, atol 1e-5·max (the row's two sums run in
# another order), bf16 dx within one bf16 ulp plus the fp32 atol (plus one
# ulp of the norm's part in the fused form, see _assert_backward_close),
# dgain (fp32) rtol 1e-5,
# atol 1e-5·max; and bit for bit the same on a second run (no atomics).
# The shapes run every register-path instantiation (one or two vectors a
# thread, 16-byte vectors and bf16's 8-byte ones at 2732) and the generic
# path (odd widths), at row counts of one CTA a row (1, 7, 133), several
# rows a CTA (1,001: the last CTA's run shorter) and more rows than CTAs.

BACKWARD_SHAPES = [(4, 1, 2048), (1, 168, 2048), (4, 1, 2732), (1, 256, 2732), (1024, 2048),
                   (7, 130), (3, 4097), (3, 256), (2, 768), (4, 1024), (2, 2560), (3, 3840),
                   (2, 4096), (3, 6144), (2, 8192), (1, 2048), (7, 2732), (133, 2048),
                   (1001, 2732), (600, 8192), (4, 2049)]


def _grads_through_plain(fn, inputs, grads):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])


def _assert_backward_close(got, want, norm_part=None):
    """fp32 within rtol 1e-5, atol 1e-5·max; bf16 within one ulp of the
    result plus atol 1e-5·max (dx's two fp32 terms can nearly cancel, and
    their rounding then moves the bf16 rounding of a small result by more
    than its ulp), and for the fused form one more ulp of the norm's
    rounded part ``norm_part``: both sides round that part to bf16 before
    adding the residual gradient, and where the two nearly cancel, one ulp
    of the part is many of the sum."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    else:
        tol = (_bf16_ulp(want) + 1e-5 * float(want.float().abs().max())
               + (0 if norm_part is None else _bf16_ulp(norm_part)))
        assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernel_matches_autograd(cuda, shape, dtype):
    x, dy, gain = _add_norm_inputs(cuda, shape, dtype, seed=40)
    before = rmsnorm_backward.launches
    dx, dgain = rmsnorm_backward(x, dy, gain, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm_backward.launches == before + 1
    want_dx, want_dg = _grads_through_plain(lambda x, g: rmsnorm_reference(x, g, 1e-5),
                                            (x, gain), (dy,))
    assert dx.dtype == dtype and dgain.dtype == gain.dtype
    _assert_backward_close(dx, want_dx)
    torch.testing.assert_close(dgain, want_dg, rtol=1e-5, atol=1e-5 * float(want_dg.abs().max()))
    again = rmsnorm_backward(x, dy, gain, 1e-5)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dgain)
    plain = rmsnorm_backward_reference(x, dy, gain, 1e-5)
    _assert_backward_close(dx, plain[0])


@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ds", [True, False])
def test_add_rmsnorm_backward_kernel_matches_autograd(cuda, shape, dtype, with_ds):
    x, delta, gain = _add_norm_inputs(cuda, shape, dtype, seed=41)
    g = torch.Generator(device=cuda).manual_seed(42)
    dh = torch.randn(shape, generator=g, device=cuda).to(dtype)
    ds = torch.randn(shape, generator=g, device=cuda).to(dtype) if with_ds else None
    s = x + delta
    before = add_rmsnorm_backward.launches
    dx, dgain = add_rmsnorm_backward(s, ds, dh, gain, 1e-5)
    torch.cuda.synchronize()
    assert add_rmsnorm_backward.launches == before + 1
    want_dx, want_dd, want_dg = _grads_through_plain(
        lambda x, d, g: add_rmsnorm_reference(x, d, g, 1e-5), (x, delta, gain), (ds, dh))
    norm_part = rmsnorm_backward_reference(s, dh, gain, 1e-5)[0]
    _assert_backward_close(dx, want_dx, norm_part)
    _assert_backward_close(dx, want_dd, norm_part)
    torch.testing.assert_close(dgain, want_dg, rtol=1e-5, atol=1e-5 * float(want_dg.abs().max()))
    again = add_rmsnorm_backward(s, ds, dh, gain, 1e-5)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dgain)


def _shifted(t):
    """``t``'s values in a view one element into a buffer: contiguous, but
    off every vector alignment."""
    if t is None:
        return None
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("shape", [(3, 2048), (2, 2732), (5, 8192), (2, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
def test_norm_backward_unaligned_view_gives_the_aligned_bits(cuda, shape, dtype, fused):
    """An unaligned view takes the generic path, which keeps the register
    path's grouping and summation order: the same bits as an aligned
    copy, both within the gates of autograd through the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(44 + shape[-1])
    x, dy, ds = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    ds = ds if fused else None
    gain = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    run = ((lambda x, dy, ds: add_rmsnorm_backward(x, ds, dy, gain, 1e-5)) if fused
           else (lambda x, dy, ds: rmsnorm_backward(x, dy, gain, 1e-5)))
    dx, dgain = run(x, dy, ds)
    sx, sdy, sds = _shifted(x), _shifted(dy), _shifted(ds)
    assert sx.data_ptr() % 16 != 0
    ux, ugain = run(sx, sdy, sds)
    torch.cuda.synchronize()
    assert torch.equal(ux, dx) and torch.equal(ugain, dgain)
    want_dx, want_dg = rmsnorm_backward_reference(x, dy, gain, 1e-5, dres=ds)
    part = rmsnorm_backward_reference(x, dy, gain, 1e-5)[0] if fused else None
    _assert_backward_close(ux, want_dx, part)
    torch.testing.assert_close(ugain, want_dg, rtol=1e-5, atol=1e-5 * float(want_dg.abs().max()))


@pytest.mark.parametrize("shape,path", [
    ((1024, 2048), "regs<float, 4, 1,"), ((4, 2732), "regs<float, 4, 1,"),
    ((4, 8192), "regs<float, 4, 2,"), ((4, 6144), "regs<float, 4, 2,"),
    ((4, 2049), "any<float,"),
])
@pytest.mark.parametrize("fused", [False, True])
def test_norm_backward_runs_two_kernels_and_no_memset(cuda, shape, path, fused):
    """One call of each backward wrapper runs two CUDA kernels, the rows
    pass on the path its width takes and the finish, and no memset or
    copy, by the profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, dy, gain = _add_norm_inputs(cuda, shape, torch.float32, seed=45)
    ds = torch.randn_like(x) if fused else None
    run = ((lambda: add_rmsnorm_backward(x, ds, dy, gain, 1e-5)) if fused
           else (lambda: rmsnorm_backward(x, dy, gain, 1e-5)))
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 2, names
    assert any(f"rmsnorm_bwd_{path}" in n and f"{str(fused).lower()}>" in n for n in names), names
    assert any("rmsnorm_bwd_finish" in n for n in names), names


def test_norm_wrappers_under_grad_run_both_kernels(cuda):
    """Under grad mode a CUDA input that requires grad leaves the wrappers
    with a ``grad_fn``, and ``backward`` runs the backward kernels; the
    gradients are autograd's through the plain versions.  Without grad
    they launch the forward alone."""
    x, delta, gain = _add_norm_inputs(cuda, (2, 9, 2048), torch.float32, seed=43)
    x, delta, gain = (t.requires_grad_(True) for t in (x, delta, gain))
    counts = lambda: (rmsnorm.launches, add_rmsnorm.launches, rmsnorm_backward.launches,
                      add_rmsnorm_backward.launches)
    before = counts()
    s, h = add_rmsnorm(x, delta, gain, 1e-5)
    out = rmsnorm(h, gain, 1e-5)
    assert s.grad_fn is not None and h.grad_fn is not None and out.grad_fn is not None
    ((out * out).sum() + s.sum()).backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, delta, gain)]
    s2, h2 = add_rmsnorm_reference(*leaves, 1e-5)
    out2 = rmsnorm_reference(h2, leaves[2], 1e-5)
    ((out2 * out2).sum() + s2.sum()).backward()
    for got, want in zip((x.grad, delta.grad, gain.grad), (t.grad for t in leaves)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    with torch.no_grad():
        before = counts()
        s, h = add_rmsnorm(x, delta, gain, 1e-5)
        assert s.grad_fn is None and h.grad_fn is None
        assert tuple(a - b for a, b in zip(counts(), before)) == (0, 1, 0, 0)


def test_flash_and_scan_raise_rather_than_drop_a_gradient(cuda):
    """Under grad a CUDA input that requires grad leaves flash attention
    and the selective scan with a ``grad_fn``, and ``backward`` runs each
    backward kernel once: gradients arrive, none is dropped.  Without grad
    they launch the forward alone."""
    q = torch.randn(1, 8, 4, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 8, 4, 64, device=cuda)
    before = (flash_attention.launches, flash_attention_backward.launches)
    out = flash_attention(q, k, k, causal=True)
    assert out.grad_fn is not None
    out.sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0],
            flash_attention_backward.launches - before[1]) == (1, 1)
    assert q.grad is not None and q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    with torch.no_grad():
        assert flash_attention(q, k, k, causal=True).grad_fn is None
    B, S, D, N = 1, 5, 32, 16
    dt = torch.rand(B, S, D, device=cuda, requires_grad=True)
    x = torch.randn(B, S, D, device=cuda)
    bm, cm = torch.randn(B, S, N, device=cuda), torch.randn(B, S, N, device=cuda)
    a, h0 = -torch.rand(D, N, device=cuda), torch.zeros(B, D, N, device=cuda)
    before = (ssm_scan.launches, ssm_scan_backward.launches)
    y, hT = ssm_scan(dt, x, bm, cm, a, h0)
    assert y.grad_fn is not None and hT.grad_fn is not None
    y.sum().backward()
    torch.cuda.synchronize()
    assert (ssm_scan.launches - before[0], ssm_scan_backward.launches - before[1]) == (1, 1)
    assert dt.grad is not None and dt.grad.shape == dt.shape and torch.isfinite(dt.grad).all()
    with torch.no_grad():
        y, hT = ssm_scan(dt, x, bm, cm, a, h0)
    assert y.shape == (B, S, D) and y.grad_fn is None


def test_xlstm_model_on_card_serves_and_trains_as_the_host(cuda):
    """xlstm-1.3b@smoke on card and host from the same weights: prefill
    logits and every state (rtol 1e-4, atol 1e-4·max), the launch counts
    per forward (1 + L ``rmsnorm``: block 0's first norm and each block's
    inner norm; L ``add_rmsnorm``), then
    one training step's loss (rel 1e-5) and every gradient (within 1e-4 of
    its leaf's largest host entry), the backward running the norm
    kernels."""
    from repro_torch.launch.train import check_trainable

    cfg = get_config("xlstm-1.3b@smoke")
    check_trainable(cfg, "cuda")
    host = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=cuda, seed=0)
    card.load_state_dict(host.state_dict())
    tokens = torch.arange(4, 68).reshape(2, 32) % cfg.vocab
    before = (rmsnorm.launches, add_rmsnorm.launches)
    got, gc = card.forward_prefill(tokens.to(cuda))
    want, hc = host.forward_prefill(tokens)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (rmsnorm.launches - before[0], add_rmsnorm.launches - before[1]) == (1 + L, L)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    for key in hc:
        for n, w in hc[key].items():
            torch.testing.assert_close(gc[key][n].cpu(), w, rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()))
    batch = {"tokens": tokens, "labels": (tokens + 1) % cfg.vocab}
    losses = {}
    for name, model in (("host", host.trainable()), ("card", card.trainable())):
        dev = model.embed.device
        loss, _ = model.loss_fn({k: v.to(dev) for k, v in batch.items()})
        before = (rmsnorm_backward.launches, add_rmsnorm_backward.launches)
        loss.backward()
        losses[name] = float(loss.detach())
    torch.cuda.synchronize()
    assert (rmsnorm_backward.launches - before[0],
            add_rmsnorm_backward.launches - before[1]) == (1 + L, L)
    assert losses["card"] == pytest.approx(losses["host"], rel=1e-5)
    hp = dict(host.named_parameters())
    for n, p in card.named_parameters():
        w = hp[n].grad
        torch.testing.assert_close(p.grad.cpu(), w, rtol=0.0, atol=1e-4 * float(w.abs().max()),
                                   msg=lambda m: f"d{n}: {m}")


# ------------------------------------------------- flash and scan backward
# Each backward kernel against its plain version (the contract the CPU
# tests hold to jax.vjp of the reference's oracles): fp32 within 1e-4 of
# each gradient's largest entry (the kernels' sums run in other orders
# than the plain version's einsums over up to 512 keys or 16,384
# channels), bf16 within one bf16 ulp of that entry plus the same; a
# second launch bit for bit the first (no atomics).

BWD_ATOL_REL = 1e-4


def _bf16_ulp_of_max(want):
    a = want.float().abs().max().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return float(torch.exp2(torch.floor(torch.log2(a)) - 7))


def _grads_close(got, want, names):
    for g, w, name in zip(got, want, names):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        scale = float(w.float().abs().max())
        tol = BWD_ATOL_REL * scale + (_bf16_ulp_of_max(w) if g.dtype == torch.bfloat16 else 0.0)
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol, f"{name}: max|kernel-plain| {err:.3e} over {tol:.3e}"


def _flash_bwd_inputs(cuda, B, S, Sk, H, KV, hd, dtype, seed, v_width=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, device=cuda)
    q, k, v = r(B, S, H, hd), r(B, Sk, KV, hd), r(B, Sk, KV, hd)
    if v_width is not None:    # MLA: v zero-padded from its own width
        v[..., v_width:] = 0.0
    return q.to(dtype), k.to(dtype), v.to(dtype), r(B, S, H, hd).to(dtype)


@pytest.mark.parametrize("B,S,Sk,H,KV,hd,causal,window,v_width,dtype", [
    (4, 256, 256, 32, 32, 64, True, None, None, torch.float32),    # stablelm-1.6b training
    (1, 256, 256, 64, 8, 128, True, None, None, torch.float32),    # jamba's attention, GQA 8
    (2, 130, 130, 8, 2, 128, True, 32, None, torch.float32),       # a window narrower than S
    (1, 168, 512, 16, 16, 64, False, None, None, torch.float32),   # seamless's cross-attention
    (1, 512, 512, 16, 16, 64, False, None, None, torch.float32),   # seamless's encoder
    (1, 75, 75, 40, 40, 96, True, None, 64, torch.float32),        # MLA: qk 96, v padded
    (2, 37, 37, 6, 3, 40, True, None, None, torch.float32),        # odd S and head_dim
    (2, 1, 9, 4, 2, 64, False, None, None, torch.float32),         # S = 1 over 9 keys
    (2, 256, 256, 32, 32, 64, True, None, None, torch.bfloat16),
    (1, 130, 130, 64, 8, 128, True, 48, None, torch.bfloat16),
    # the 16-row blocks and 32-row tiles' edges: G = 8 and 1, S and Sk not
    # multiples of either, head_dim 32 / 64 / 96 / 128, windows, keys of
    # their own length on both sides of S, bf16
    (2, 100, 100, 16, 2, 128, True, None, None, torch.float32),    # G = 8, S % 32 = 4
    (1, 77, 77, 8, 8, 64, True, None, None, torch.float32),        # G = 1, S % 16 = 13
    (2, 45, 45, 8, 1, 96, True, 20, None, torch.float32),          # hd 96, G = 8, window 20
    (1, 50, 83, 4, 4, 128, False, None, None, torch.float32),      # Sk > S, neither a tile
    (1, 83, 50, 4, 2, 64, False, None, None, torch.float32),       # Sk < S
    (3, 17, 17, 2, 2, 32, True, None, None, torch.float32),        # hd 32 on 64-wide rows
    (2, 70, 70, 16, 2, 128, True, 9, None, torch.float32),         # window under a tile
    (2, 100, 100, 16, 2, 128, True, None, None, torch.bfloat16),   # G = 8
    (1, 40, 40, 8, 8, 96, True, None, 64, torch.bfloat16),         # MLA's padded v
    (1, 61, 29, 8, 4, 64, False, None, None, torch.bfloat16),      # Sk != S
])
def test_flash_backward_kernel_matches_plain_version(cuda, B, S, Sk, H, KV, hd, causal, window,
                                                     v_width, dtype):
    q, k, v, dout = _flash_bwd_inputs(cuda, B, S, Sk, H, KV, hd, dtype, seed=S + H + hd,
                                      v_width=v_width)
    scale = 1.0 / hd ** 0.5
    out = flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, dout, causal=causal, window=window, scale=scale)
    want = flash_attention_backward_reference(q, k, v, out, dout, causal=causal, window=window,
                                              scale=scale)
    again = flash_attention_backward(q, k, v, out, dout, causal=causal, window=window,
                                     scale=scale)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 2
    _grads_close(got, want, ("dq", "dk", "dv"))
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_takes_unaligned_tensors(cuda, dtype):
    """q, k, v, out and dout one element into their buffers (no 16-byte
    alignment: the tiles arrive through registers, not cp.async) give the
    bits of aligned copies."""
    B, S, H, KV, hd = 2, 70, 8, 2, 64
    q, k, v, dout = _flash_bwd_inputs(cuda, B, S, S, H, KV, hd, dtype, seed=21)
    out = flash_attention(q, k, v, causal=True)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    moved = [unaligned(t) for t in (q, k, v, out, dout)]
    assert moved[0].data_ptr() % 16 != 0
    got = flash_attention_backward(*moved, causal=True)
    want = flash_attention_backward(q, k, v, out, dout, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("B,S,Sk,H,KV,hd,causal,window,v_width,dtype", [
    (4, 256, 256, 32, 32, 64, True, None, None, torch.float32),    # stablelm-1.6b training
    (1, 256, 256, 64, 8, 128, True, None, None, torch.float32),    # jamba's attention, GQA 8
    (2, 100, 100, 8, 1, 128, True, None, None, torch.float32),     # G = 8 at an odd tile edge
    (2, 70, 70, 16, 2, 128, True, 9, None, torch.float32),         # window under a tile
    (1, 50, 83, 4, 4, 96, False, None, None, torch.float32),       # Sk > S, hd 96
    (1, 75, 75, 40, 40, 96, True, None, 64, torch.float32),        # MLA: qk 96, v padded
    (3, 17, 17, 2, 2, 32, True, None, None, torch.float32),        # hd 32 on 64-wide rows
    (2, 100, 100, 16, 2, 128, True, None, None, torch.bfloat16),
    (1, 61, 29, 8, 4, 64, False, None, None, torch.bfloat16),
])
def test_flash_backward_from_the_forward_statistics(cuda, B, S, Sk, H, KV, hd, causal, window,
                                                     v_width, dtype):
    """The forward with row statistics (as training runs it) gives serving's
    output bit for bit and each row's log-sum-exp (within fp32 rounding of
    the plain one); the backward from them matches the plain version,
    repeats bit for bit, and is the wrapper's without them (which runs the
    forward for them first) bit for bit."""
    q, k, v, dout = _flash_bwd_inputs(cuda, B, S, Sk, H, KV, hd, dtype, seed=S + Sk + hd,
                                      v_width=v_width)
    kw = dict(causal=causal, window=window, scale=1.0 / hd ** 0.5)
    served = flash_attention(q, k, v, **kw)
    out, lse = flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, served)
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float().repeat_interleave(H // KV, dim=2)) * kw["scale"]
    s_idx = torch.arange(S, device=cuda)[:, None]
    t_idx = torch.arange(Sk, device=cuda)[None, :]
    mask = torch.ones(S, Sk, dtype=torch.bool, device=cuda)
    if causal:
        mask &= t_idx <= s_idx
    if window is not None:
        mask &= t_idx > s_idx - window
    want_lse = torch.logsumexp(torch.where(mask, scores, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5 * float(want_lse.abs().max()))
    got = flash_attention_backward(q, k, v, out, dout, lse=lse, **kw)
    again = flash_attention_backward(q, k, v, out, dout, lse=lse, **kw)
    alone = flash_attention_backward(q, k, v, out, dout, **kw)
    want = flash_attention_backward_reference(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    _grads_close(got, want, ("dq", "dk", "dv"))
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert all(torch.equal(g, a) for g, a in zip(got, alone))


class _Calls:
    """Counts the calls of one C entry point of a kernel library."""

    def __init__(self, lib, name):
        self.lib, self.name, self.fn, self.n = lib, name, getattr(lib, name), 0

    def __enter__(self):
        def counted(*args):
            self.n += 1
            return self.fn(*args)
        setattr(self.lib, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.lib, self.name, self.fn)


def test_forward_outputs_for_the_backward_only_under_grad(cuda):
    """Without grad flash attention and the selective scan run serving's
    launch and write no row statistics or range-start states; under grad
    the forward writes them, once a call."""
    q = torch.randn(1, 40, 4, 64, device=cuda)
    k = torch.randn(1, 40, 2, 64, device=cuda)
    B, S, D, N = 1, 20, 64, 16
    dt = torch.rand(B, S, D, device=cuda)
    x = torch.randn(B, S, D, device=cuda)
    bm, cm = torch.randn(B, S, N, device=cuda), torch.randn(B, S, N, device=cuda)
    a, h0 = -torch.rand(D, N, device=cuda), torch.zeros(B, D, N, device=cuda)
    flash_lib, scan_lib = flash_ops.LIBRARY.load(), scan_ops.LIBRARY.load()
    with _Calls(flash_lib, "flash_attention_lse_launch") as stats, \
            _Calls(scan_lib, "ssm_scan_ckpt_launch") as states:
        with torch.no_grad():
            flash_attention(q.requires_grad_(True), k, k, causal=True)
            ssm_scan(dt.requires_grad_(True), x, bm, cm, a, h0)
        flash_attention(q.detach(), k, k, causal=True)
        ssm_scan(dt.detach(), x, bm, cm, a, h0)
        assert (stats.n, states.n) == (0, 0)
        flash_attention(q, k, k, causal=True).sum().backward()
        ssm_scan(dt, x, bm, cm, a, h0)[0].sum().backward()
        torch.cuda.synchronize()
        assert (stats.n, states.n) == (1, 1)


def test_flash_backward_under_grad_is_autograd_through_the_plain_version(cuda):
    """Through the autograd Function the forward is serving's, bit for bit,
    and the gradients are autograd's through the plain forward (within
    1e-4 of each gradient's largest entry)."""
    q, k, v, dout = _flash_bwd_inputs(cuda, 2, 67, 67, 8, 2, 64, torch.float32, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, window=40)
    with torch.no_grad():
        assert torch.equal(out, flash_attention(q, k, v, causal=True, window=40))
    out.backward(dout)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention_reference(*plain, causal=True, window=40).backward(dout)
    _grads_close([t.grad for t in leaves], [t.grad for t in plain], ("dq", "dk", "dv"))


@pytest.mark.parametrize("B,S,D,N,dtype,strided,with_dhT", [
    (4, 256, 16384, 16, torch.float32, True, False),   # jamba's training shape
    (1, 128, 16384, 16, torch.float32, True, True),
    (2, 100, 50, 16, torch.float32, True, True),       # a masked channel tail, S % 32 != 0
    (3, 33, 200, 8, torch.float32, False, True),
    (2, 64, 40, 4, torch.float32, False, False),
    (2, 45, 70, 7, torch.float32, True, True),          # N not a power of two
    (1, 1, 96, 16, torch.float32, True, True),          # S = 1
    (2, 130, 1024, 16, torch.bfloat16, True, True),
    # the 8-step ranges' and 32-channel blocks' edges
    (2, 13, 70, 16, torch.float32, True, True),         # S % 8 = 5, a 6-channel tail
    (3, 17, 1000, 16, torch.float32, False, False),     # S % 8 = 1, an 8-channel tail
    (1, 8, 33, 16, torch.float32, True, False),         # one whole range, a 1-channel tail
    (2, 40, 64, 3, torch.float32, True, True),          # N = 3 on four lanes of one state
    (1, 31, 33, 16, torch.bfloat16, True, False),
    (2, 9, 96, 8, torch.bfloat16, False, True),
])
def test_ssm_scan_backward_kernel_matches_plain_version(cuda, B, S, D, N, dtype, strided,
                                                        with_dhT):
    args = _scan_inputs(cuda, B, S, D, N, dtype=dtype, seed=S + D + N, strided=strided)
    g = torch.Generator(device=cuda).manual_seed(B + S)
    dy = torch.randn(B, S, D, generator=g, device=cuda)
    dhT = torch.randn(B, D, N, generator=g, device=cuda) if with_dhT else None
    before = ssm_scan_backward.launches
    got = ssm_scan_backward(*args, dy, dhT)
    want = ssm_scan_backward_reference(*args, dy, dhT)
    again = ssm_scan_backward(*args, dy, dhT)
    torch.cuda.synchronize()
    assert ssm_scan_backward.launches == before + 2
    _grads_close(got, want, ("ddt", "dx", "dB", "dC", "dA", "dh0"))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,S,D,N,dtype,strided,with_dhT", [
    (4, 256, 16384, 16, torch.float32, True, False),   # jamba's training shape
    (2, 13, 70, 16, torch.float32, True, True),         # S % 8 = 5, a 6-channel tail
    (3, 17, 1000, 16, torch.float32, False, False),
    (2, 45, 70, 7, torch.float32, True, True),          # N not a power of two
    (1, 8, 33, 4, torch.float32, True, True),
    (1, 31, 33, 16, torch.bfloat16, True, False),
])
def test_ssm_scan_backward_from_the_forward_states(cuda, B, S, D, N, dtype, strided, with_dhT):
    """The forward with range-start states (as training runs it) gives
    serving's y and hT bit for bit and the states of the plain recurrence
    bit for bit at every range start; the backward from them matches the
    plain version and is the wrapper's without them (which runs the
    forward for them first) bit for bit."""
    args = _scan_inputs(cuda, B, S, D, N, dtype=dtype, seed=S + D + 1, strided=strided)
    g = torch.Generator(device=cuda).manual_seed(B + S + 1)
    dy = torch.randn(B, S, D, generator=g, device=cuda)
    dhT = torch.randn(B, D, N, generator=g, device=cuda) if with_dhT else None
    served = ssm_scan(*args)
    y, hT, ckpt = ssm_scan_with_checkpoints(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, served[0]) and torch.equal(hT, served[1])
    steps = scan_ops.LIBRARY.load().ssm_scan_ckpt_steps()
    assert ckpt.shape == (B, -(-S // steps), D, N)
    dt, x, bm, cm, a, h0 = args
    for r in range(ckpt.shape[1]):
        _, h_r = ssm_scan_reference(dt[:, :r * steps], x[:, :r * steps], bm[:, :r * steps],
                                    cm[:, :r * steps], a, h0)
        assert torch.equal(ckpt[:, r], h_r), f"range {r}"
    got = ssm_scan_backward(*args, dy, dhT, ckpt=ckpt)
    alone = ssm_scan_backward(*args, dy, dhT)
    want = ssm_scan_backward_reference(*args, dy, dhT)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(got, alone))
    _grads_close(got, want, ("ddt", "dx", "dB", "dC", "dA", "dh0"))


def test_ssm_scan_under_grad_is_autograd_through_the_plain_version(cuda):
    """Through the autograd Function y and hT are serving's, bit for bit,
    and the gradients of every input are autograd's through the plain
    forward (within 1e-4 of each gradient's largest entry)."""
    args = _scan_inputs(cuda, 2, 70, 96, 16, seed=11, strided=True)
    g = torch.Generator(device=cuda).manual_seed(12)
    dy, dhT = torch.randn(2, 70, 96, generator=g, device=cuda), torch.randn(2, 96, 16,
                                                                              generator=g,
                                                                              device=cuda)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    y, hT = ssm_scan(*leaves)
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip((y, hT), ssm_scan(*args)))
    torch.autograd.backward((y, hT), (dy, dhT))
    plain = [t.detach().clone().requires_grad_(True) for t in args]
    torch.autograd.backward(ssm_scan_reference(*plain), (dy, dhT))
    _grads_close([t.grad for t in leaves], [t.grad for t in plain],
                 ("ddt", "dx", "dB", "dC", "dA", "dh0"))


def test_ssm_scan_backward_takes_unaligned_projections(cuda):
    """B and C as views one element into a buffer (no 16-byte alignment,
    a step stride of 2N + 1) give the bits of contiguous copies."""
    B, S, D, N = 2, 70, 96, 16
    dt, x, _, _, a, h0 = _scan_inputs(cuda, B, S, D, N, seed=9)
    g = torch.Generator(device=cuda).manual_seed(10)
    buf = torch.randn(B, S, 2 * N + 1, generator=g, device=cuda)
    bm, cm = buf[..., 1:N + 1], buf[..., N + 1:]
    assert bm.data_ptr() % 16 != 0
    dy = torch.randn(B, S, D, generator=g, device=cuda)
    got = ssm_scan_backward(dt, x, bm, cm, a, h0, dy, None)
    want = ssm_scan_backward(dt, x, bm.contiguous(), cm.contiguous(), a, h0, dy, None)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(got, want))


@pytest.mark.parametrize("arch", ["stablelm-1.6b@smoke", "jamba-1.5-large-398b@smoke",
                                  "minicpm3-4b@smoke", "seamless-m4t-large-v2@smoke"])
def test_attention_and_mamba_models_train_on_card_as_the_host(cuda, arch):
    """One training forward and backward at @smoke widths on card and host
    from the same weights: loss within rel 1e-5, every gradient within 1e-4
    of its leaf's largest host entry, the backward through the flash and
    scan backward kernels (one launch per forward launch)."""
    import dataclasses

    from repro_torch.launch.train import check_trainable, frontend_noise

    cfg = get_config(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, n_experts=0, experts_per_token=0)
    check_trainable(cfg, "cuda")
    host = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=cuda, seed=0)
    card.load_state_dict(host.state_dict())
    tokens = torch.arange(4, 68).reshape(2, 32) % cfg.vocab
    batch = {"tokens": tokens, "labels": (tokens + 1) % cfg.vocab}
    if cfg.frontend is not None:
        batch["frontend"] = frontend_noise(cfg, 2, 0, "cpu")
    losses = {}
    for name, model in (("host", host.trainable()), ("card", card.trainable())):
        before = (flash_attention.launches, flash_attention_backward.launches,
                  ssm_scan.launches, ssm_scan_backward.launches)
        loss, _ = model.loss_fn({k: v.to(model.embed.device) for k, v in batch.items()})
        loss.backward()
        losses[name] = float(loss.detach())
        after = (flash_attention.launches, flash_attention_backward.launches,
                 ssm_scan.launches, ssm_scan_backward.launches)
    torch.cuda.synchronize()
    n = [a - b for a, b in zip(after, before)]
    assert n[0] == n[1] and n[2] == n[3] and n[0] + n[2] > 0, n
    assert losses["card"] == pytest.approx(losses["host"], rel=1e-5)
    hp = dict(host.named_parameters())
    for name, p in card.named_parameters():
        w = hp[name].grad
        torch.testing.assert_close(p.grad.cpu(), w, rtol=0.0, atol=1e-4 * float(w.abs().max()),
                                   msg=lambda m: f"d{name}: {m}")


# ------------------------------------------------ wrappers refuse DTensors


@pytest.fixture(scope="module")
def card_mesh(tmp_path_factory):
    """A (1, 1) ("data", "model") mesh on the card over a NCCL group of one
    rank (a ``FileStore``, no network), taken down after the module."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield make_debug_mesh(1, 1, device_type="cuda")
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["rmsnorm", "add_rmsnorm", "rmsnorm_backward",
                                  "add_rmsnorm_backward", "flash_attention",
                                  "flash_attention_with_lse", "flash_attention_backward",
                                  "ssm_scan", "ssm_scan_with_checkpoints", "ssm_scan_backward"])
def test_kernel_wrappers_refuse_dtensors_on_the_card(cuda, card_mesh, name):
    """A DTensor's ``data_ptr()`` is not its local shard's: every wrapper
    raises ``TypeError`` on a DTensor argument, before any launch."""
    from torch.distributed.tensor import DTensor, Replicate

    x, g, dy = (torch.randn(2, 3, 64, device=cuda), torch.ones(64, device=cuda),
                torch.randn(2, 3, 64, device=cuda))
    q = torch.randn(1, 16, 2, 64, device=cuda)
    dt, bm = torch.rand(1, 16, 32, device=cuda), torch.randn(1, 16, 16, device=cuda)
    a, h0 = -torch.ones(32, 16, device=cuda), torch.zeros(1, 32, 16, device=cuda)
    fn, args = {
        "rmsnorm": (rmsnorm, (x, g)),
        "add_rmsnorm": (add_rmsnorm, (x, dy, g)),
        "rmsnorm_backward": (rmsnorm_backward, (x, dy, g)),
        "add_rmsnorm_backward": (add_rmsnorm_backward, (x, dy, dy, g)),
        "flash_attention": (flash_attention, (q, q, q)),
        "flash_attention_with_lse": (flash_attention_with_lse, (q, q, q)),
        "flash_attention_backward": (flash_attention_backward, (q, q, q, q, q)),
        "ssm_scan": (ssm_scan, (dt, dt, bm, bm, a, h0)),
        "ssm_scan_with_checkpoints": (ssm_scan_with_checkpoints, (dt, dt, bm, bm, a, h0)),
        "ssm_scan_backward": (ssm_scan_backward, (dt, dt, bm, bm, a, h0, dt)),
    }[name]
    before = getattr(fn, "launches", 0)
    for i in range(len(args)):
        dargs = list(args)
        dargs[i] = DTensor.from_local(args[i], card_mesh, [Replicate(), Replicate()],
                                      run_check=False)
        with pytest.raises(TypeError, match="local_map"):
            fn(*dargs)
    assert getattr(fn, "launches", 0) == before
