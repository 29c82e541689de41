"""The port's sparse flow step: its segment-sum form against the reference
package's jnp oracle and Pallas kernel (interpret mode), its ELL form
against its segment-sum form, and the wrapper's CPU path.  The CUDA
kernel's own tests are in ``test_torch_cuda_kernels.py``, which imports no
JAX so that it runs on the card's machine."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream_flow import stream_flow as jax_stream_flow
from repro.kernels.stream_flow import stream_flow_reference as jax_stream_flow_reference
from repro_torch.kernels.stream_flow import (
    ell_rows,
    stream_flow_ell,
    stream_flow_ell_reference,
    stream_flow_reference,
)
from repro_torch.streams import degree_bucket_size

SHAPES = [(4, 2, 7), (16, 4, 40), (32, 8, 100), (11, 5, 513)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _random_flow_problem(rng, n_inst, n_cont, n_edges):
    """The reference tests' generator: random edges, shares and budgets."""
    qout = rng.uniform(0.0, 5.0, n_inst).astype(np.float32)
    src = rng.integers(0, n_inst, n_edges).astype(np.int32)
    dst = rng.integers(0, n_inst, n_edges).astype(np.int32)
    share = rng.uniform(0.0, 1.0, n_edges).astype(np.float32)
    cont_of = rng.integers(0, n_cont, n_inst).astype(np.int32)
    src_c, dst_c = cont_of[src], cont_of[dst]
    remote = (src_c != dst_c).astype(np.float32)
    budget = rng.uniform(0.5, 4.0, n_cont).astype(np.float32)
    return qout, src, dst, share, remote, src_c, dst_c, budget, cont_of


def _ell_batch(rng, batch, n_inst, n_cont, n_edges, n_pad=3):
    """A batch of problems in the simulator's layout: ``n_pad`` trailing
    padded edges (zero share), ELL rows over the real edges."""
    probs = [_random_flow_problem(rng, n_inst, n_cont, n_edges) for _ in range(batch)]
    n_real = n_edges - n_pad
    d_out = degree_bucket_size(max(np.bincount(p[1][:n_real]).max() for p in probs))
    d_in = degree_bucket_size(max(np.bincount(p[2][:n_real]).max() for p in probs))
    rows = []
    for qout, src, dst, share, remote, src_c, dst_c, budget, cont_of in probs:
        share = share.copy()
        share[n_real:] = 0.0
        rows.append(dict(
            qout=qout, edge_src=src, edge_dst=dst, edge_share=share,
            edge_remote=remote, edge_src_cont=src_c, edge_dst_cont=dst_c,
            ell_src=ell_rows(src[:n_real], n_inst, d_out, n_edges),
            ell_dst=ell_rows(dst[:n_real], n_inst, d_in, n_edges),
            cont_of=cont_of, sm_budget=budget,
        ))
    return {k: torch.from_numpy(np.stack([r[k] for r in rows])) for k in rows[0]}


ELL_ARGS = ("qout", "edge_src", "edge_share", "edge_remote", "edge_src_cont",
            "edge_dst_cont", "ell_src", "ell_dst", "cont_of", "sm_budget")
SEG_ARGS = ("qout", "edge_src", "edge_dst", "edge_share", "edge_remote",
            "edge_src_cont", "edge_dst_cont", "sm_budget")


@pytest.mark.parametrize("shape", SHAPES)
def test_segment_sum_form_matches_jax_reference_and_pallas(shape):
    n_inst, n_cont, n_edges = shape
    rng = np.random.default_rng(sum(shape))
    args = _random_flow_problem(rng, n_inst, n_cont, n_edges)[:8]
    jargs = [jnp.asarray(a) for a in args]
    want = jax_stream_flow_reference(*jargs, n_inst=n_inst, n_cont=n_cont)
    pallas = jax_stream_flow(*jargs, block_edges=64, interpret=True)
    got = stream_flow_reference(
        *[torch.from_numpy(a) for a in args], n_inst=n_inst, n_cont=n_cont
    )
    for g, w, p, name in zip(got, want, pallas, ("delivered", "arrivals", "trav_c")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=name, **TOL)


def test_segment_sum_form_batches_rows_independently():
    rng = np.random.default_rng(5)
    p = _ell_batch(rng, 3, 16, 4, 40)
    batched = stream_flow_reference(*[p[k] for k in SEG_ARGS], n_inst=16, n_cont=4)
    for b in range(3):
        single = stream_flow_reference(*[p[k][b] for k in SEG_ARGS], n_inst=16, n_cont=4)
        for x, y in zip(batched, single):
            torch.testing.assert_close(x[b], y, rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_ell_form_matches_segment_sum_form(shape):
    n_inst, n_cont, n_edges = shape
    rng = np.random.default_rng(7 + sum(shape))
    p = _ell_batch(rng, 3, n_inst, n_cont, n_edges)
    got = stream_flow_ell_reference(*[p[k] for k in ELL_ARGS])
    want = stream_flow_reference(*[p[k] for k in SEG_ARGS], n_inst=n_inst, n_cont=n_cont)
    for g, w, name in zip(got, want, ("delivered", "arrivals", "trav_c")):
        torch.testing.assert_close(g, w, msg=name, **TOL)


def test_ell_padding_and_padded_edges_are_inert():
    """ELL ids >= E read zero; zero-share padded edges move nothing."""
    rng = np.random.default_rng(11)
    p = _ell_batch(rng, 2, 16, 4, 40, n_pad=8)
    base = stream_flow_ell_reference(*[p[k] for k in ELL_ARGS])
    wider = dict(p)
    E = p["edge_src"].shape[1]
    wider["ell_src"] = torch.cat(
        [p["ell_src"], torch.full_like(p["ell_src"], E + 5)], dim=2
    )
    again = stream_flow_ell_reference(*[wider[k] for k in ELL_ARGS])
    for x, y in zip(base, again):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_ell_rows_layout():
    keys = np.array([2, 0, 2, 1, 0], np.int32)
    out = ell_rows(keys, 4, 3, 99)
    assert out.tolist() == [[1, 4, 99], [3, 99, 99], [0, 2, 99], [99, 99, 99]]
    assert out.dtype == np.int32


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    p = _ell_batch(rng, 2, 32, 8, 100)
    before = stream_flow_ell.launches
    got = stream_flow_ell(*[p[k] for k in ELL_ARGS])
    want = stream_flow_ell_reference(*[p[k] for k in ELL_ARGS])
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert stream_flow_ell.launches == before
