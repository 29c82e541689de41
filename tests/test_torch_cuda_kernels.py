"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the simulator's sparse tick running through the kernel.

This file imports no JAX, so it runs on a machine that has only the port's
dependencies.  Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ContainerDim, round_robin_configuration
from repro_torch.interop import stage_padded
from repro_torch.kernels.stream_flow import (
    ell_rows,
    stream_flow_ell,
    stream_flow_ell_reference,
)
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
    return torch.device("cuda")


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
