"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the simulator's sparse tick running through the flow kernel, and
the models' prefill and decode running through the RMSNorm, flash and
selective-scan kernels.

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
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_reference
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_reference
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_reference
from repro_torch.kernels.stream_flow import (
    container_members,
    container_sum,
    container_sum_reference,
    ell_rows,
    stream_flow_ell,
    stream_flow_ell_reference,
)
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


def test_container_sum_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cont_of = torch.zeros(2, 16, dtype=torch.int32, device=cuda)
    vals = torch.ones(2, 16, device=cuda)
    ptr, members = container_members(cont_of, 4)
    with pytest.raises(ValueError, match="cont_ptr"):
        container_sum(vals, cont_of, ptr.long(), members)
    with pytest.raises(ValueError, match="vals"):
        container_sum(vals.double(), cont_of, ptr, members)
    with pytest.raises(ValueError, match="cont_members"):
        container_sum(vals, cont_of, ptr, members[:, :8].contiguous())
    # a row's values live in shared memory: 60,000 instances need 240,000 bytes
    wide = torch.zeros(1, 60000, dtype=torch.int32, device=cuda)
    before = container_sum.launches
    with pytest.raises(ValueError, match="240000 bytes of shared memory"):
        container_sum(torch.ones(1, 60000, device=cuda), wide, *container_members(wide, 4))
    assert container_sum.launches == before


@pytest.mark.parametrize("kernel", ["dense", "sparse"])
def test_tick_on_card_against_buckets_and_host(cuda, kernel):
    """The sparse tick's samples are bit for bit the same at any bucket on
    the card; the dense tick's padded (I, I) sums are torch reductions whose
    order may follow the padded length, so it is held to rel 1e-6.  Both
    stay within 1e-4 of the host's run of the same seed."""
    dag = wordcount()
    cfg = round_robin_configuration(dag, {"W": 3, "C": 2}, 1, ContainerDim(3.0, 4096.0))
    runs = [simulate_batch([cfg], 1e6, duration_s=2.0, tick_kernel=kernel, device=cuda,
                           min_inst_bucket=i, min_cont_bucket=k)[0]
            for i, k in ((0, 0), (32, 32), (128, 32))]
    host = simulate_batch([cfg], 1e6, duration_s=2.0, tick_kernel=kernel, device="cpu")[0]
    for r in runs[1:]:
        for key, base in runs[0].samples.items():
            if kernel == "sparse":
                np.testing.assert_array_equal(r.samples[key], base, err_msg=key)
            else:
                np.testing.assert_allclose(r.samples[key], base, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(base).max()), err_msg=key)
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
    before = (rmsnorm.launches, flash_attention.launches)
    got, _ = card.forward_prefill(tokens.to(cuda))
    want, _ = host.forward_prefill(tokens)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (rmsnorm.launches, flash_attention.launches) == (before[0] + 2 * L + 1, before[1] + L)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


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
    before = (rmsnorm.launches, flash_attention.launches, ssm_scan.launches)
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
    assert (rmsnorm.launches, flash_attention.launches, ssm_scan.launches) == (
        before[0] + 2 * (2 * cfg.n_layers + 1), before[1] + P, before[2] + 2 * P)
    for g, w in ((got, want), (gd, wd)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
    for n in ("h", "conv"):
        w = caches["host"]["b0_mamba"][n]
        torch.testing.assert_close(caches["card"]["b0_mamba"][n].cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))
