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
    # the two devices draw different noise streams: same distribution only
    assert sparse == pytest.approx(host, rel=0.05)


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
