"""The port's sparse flow step: its segment-sum form against the reference
package's jnp oracle and Pallas kernel (interpret mode), its ELL form
against its segment-sum form, the container member lists the CUDA kernel
sums through, its cluster-size choice, and the wrapper's CPU path; and the
fixed-order axis sums of the dense tick against a plain loop.  The CUDA
kernels' own tests are in ``test_torch_cuda_kernels.py``, which imports no
JAX so that it runs on the card's machine."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream_flow import stream_flow as jax_stream_flow
from repro.kernels.stream_flow import stream_flow_reference as jax_stream_flow_reference
from repro_torch.kernels.stream_flow import (
    cluster_size_for,
    container_members,
    container_sum,
    container_sum_reference,
    ell_rows,
    ordered_sum,
    ordered_sum_reference,
    stream_flow_ell,
    stream_flow_ell_reference,
    stream_flow_reference,
)
from repro_torch.kernels.stream_flow.ops import threads_for
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


# ---------------------------------------------------------- member lists
# The CUDA kernel sums containers through member lists (container_members),
# one thread per container adding its members in instance order.


def _sequential_container_sums(vals, cont_ptr, cont_members):
    """Each container's members summed one by one in list order, in float32:
    the order and rounding of the kernel's per-container sums."""
    vals = vals.numpy()
    out = np.zeros((vals.shape[0], cont_ptr.shape[1] - 1), np.float32)
    for b in range(vals.shape[0]):
        for k in range(out.shape[1]):
            acc = np.float32(0.0)
            for i in cont_members[b, cont_ptr[b, k]:cont_ptr[b, k + 1]].tolist():
                acc = np.float32(acc + vals[b, i])
            out[b, k] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("batch,n_inst,n_cont", [(1, 8, 4), (3, 40, 7), (2, 513, 64)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_container_members_list_each_container_in_instance_order(batch, n_inst, n_cont, dtype):
    rng = np.random.default_rng(n_inst + n_cont)
    cont_of = torch.from_numpy(rng.integers(0, n_cont, (batch, n_inst))).to(dtype)
    cont_ptr, members = container_members(cont_of, n_cont)
    assert cont_ptr.dtype == members.dtype == dtype
    assert cont_ptr.shape == (batch, n_cont + 1) and members.shape == (batch, n_inst)
    for b in range(batch):
        assert cont_ptr[b, 0] == 0 and cont_ptr[b, -1] == n_inst
        for k in range(n_cont):
            got = members[b, cont_ptr[b, k]:cont_ptr[b, k + 1]].tolist()
            assert got == np.flatnonzero(cont_of[b].numpy() == k).tolist()


def test_container_members_take_padded_instances():
    """The simulator pads instances at the end into the last container; they
    are listed after that container's real members, in instance order."""
    cont_of = torch.tensor([[1, 0, 2, 1, 0, 3, 3, 3], [0, 0, 1, 1, 1, 1, 1, 1]])
    cont_ptr, members = container_members(cont_of, 4)
    assert cont_ptr.tolist() == [[0, 2, 4, 5, 8], [0, 2, 8, 8, 8]]
    assert members.tolist() == [[1, 4, 0, 3, 2, 5, 6, 7], [0, 1, 2, 3, 4, 5, 6, 7]]


@pytest.mark.parametrize("shape", SHAPES)
def test_to_containers_equals_sums_through_member_lists(shape):
    """The plain container sum (the simulator's ``to_containers``) adds each
    container's members in instance order: bit for bit the member-list walk
    of the CUDA kernel."""
    n_inst, n_cont, _ = shape
    rng = np.random.default_rng(31 + n_inst)
    cont_of = torch.from_numpy(rng.integers(0, n_cont, (3, n_inst)))
    vals = torch.from_numpy(rng.uniform(0.0, 5.0, (3, n_inst)).astype(np.float32))
    got = _sequential_container_sums(vals, *container_members(cont_of, n_cont))
    assert torch.equal(got, container_sum_reference(vals, cont_of, n_cont))


@pytest.mark.parametrize("batch,n_inst,n_cont", [(1, 8, 4), (3, 40, 7), (2, 513, 64), (4, 1024, 512)])
def test_container_sum_is_bitwise_invariant_to_padding(batch, n_inst, n_cont):
    """Padded instances (zero values, in the last container) and padded
    containers leave every real container's sum bit for bit unchanged, and
    the CPU wrapper takes the plain version without a launch."""
    rng = np.random.default_rng(batch + n_inst)
    cont_of = torch.from_numpy(rng.integers(0, n_cont, (batch, n_inst)))
    vals = torch.from_numpy(rng.uniform(0.0, 5.0, (batch, n_inst)).astype(np.float32))
    base = container_sum_reference(vals, cont_of, n_cont)
    for extra_i, extra_k in ((0, 0), (3, 0), (24, 24), (n_inst, 2 * n_cont)):
        K = n_cont + extra_k
        padded_of = torch.cat([cont_of, torch.full((batch, extra_i), K - 1)], dim=1)
        padded = torch.cat([vals, torch.zeros(batch, extra_i)], dim=1)
        before = container_sum.launches
        got = container_sum(padded, padded_of, *container_members(padded_of, K))
        assert container_sum.launches == before
        assert torch.equal(got[:, :n_cont], base)
        assert torch.equal(got[:, n_cont:], torch.zeros(batch, extra_k))


def test_container_sum_is_not_a_matmul():
    """Values whose float32 sum depends on the order: the plain version
    adds them in instance order, the one-hot product (the old
    ``torch.bmm``) need not."""
    vals = torch.tensor([[1e8, 1.0, -1e8, 1.0]], dtype=torch.float32)
    cont_of = torch.zeros(1, 4, dtype=torch.int64)
    got = container_sum_reference(vals, cont_of, 1)
    assert got.item() == ((np.float32(1e8) + np.float32(1.0)) - np.float32(1e8)) + np.float32(1.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_takes_member_lists_and_equals_plain_version(shape):
    n_inst, n_cont, n_edges = shape
    rng = np.random.default_rng(41 + sum(shape))
    p = _ell_batch(rng, 2, n_inst, n_cont, n_edges)
    args = [p[k] for k in ELL_ARGS]
    before = stream_flow_ell.launches
    got = stream_flow_ell(*args, *container_members(p["cont_of"], n_cont), cluster_size=2)
    assert stream_flow_ell.launches == before
    for x, y in zip(got, stream_flow_ell_reference(*args)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("batch,n_inst,n_sms,want", [
    (1, 1024, 132, 16), (32, 1024, 132, 8), (6, 8, 132, 1), (1, 8, 132, 1),
    (1, 32, 132, 1), (1, 4096, 132, 16), (64, 1024, 132, 4), (256, 1024, 132, 1),
    (1, 256, 132, 4), (1, 1024, 16, 16), (2, 1024, 16, 8),
])
def test_cluster_size_fills_the_card_and_keeps_a_warp_per_row(batch, n_inst, n_sms, want):
    n = cluster_size_for(batch, n_inst, n_sms)
    assert n == want
    threads = threads_for(n_inst, n)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert threads // 32 <= max(1, -(-n_inst // n))


def test_sparse_tick_builds_member_lists_once_per_run(monkeypatch):
    """The member lists are built before the tick loop (on either tick, for
    the container sums), and every sparse tick passes them to the flow
    step, whose result still equals the dense tick's."""
    from repro_torch.core import ContainerDim, round_robin_configuration
    from repro_torch.streams import SimParams, deep_pipeline, measure_capacity
    from repro_torch.streams import simulator

    built, calls = [], []
    real_members, real_flow = simulator.container_members, simulator.stream_flow_ell

    def members(cont_of, n_cont):
        built.append(n_cont)
        return real_members(cont_of, n_cont)

    def flow(*args, **kwargs):
        calls.append(len(args))
        return real_flow(*args, **kwargs)

    monkeypatch.setattr(simulator, "container_members", members)
    monkeypatch.setattr(simulator, "stream_flow_ell", flow)
    dag = deep_pipeline()
    cfg = round_robin_configuration(dag, {n: 2 for n in dag.node_names}, 4, ContainerDim(3.0, 4096.0))
    params = SimParams()
    sparse = measure_capacity(cfg, params, duration_s=1.0, tick_kernel="sparse", device="cpu")
    # the containers' lists (K = 8), and the whole row as one container for
    # the sources' capacity
    assert built == [8, 1]
    assert len(calls) == int(1.0 / params.dt) and set(calls) == {12}
    dense = measure_capacity(cfg, params, duration_s=1.0, tick_kernel="dense", device="cpu")
    assert built == [8, 1, 8, 1] and len(calls) == int(1.0 / params.dt)
    assert sparse == pytest.approx(dense, rel=1e-4)


# --------------------------------------------------------- ordered sums
# The dense tick's sums over the padded instance axis: lane j % 32 adds
# element j in index order from +0.0, then a halving tree over the lanes.


def _loop_ordered_sum(x, dim, mask=None):
    """The stated order, one float32 add at a time."""
    x = x.numpy()
    if mask is not None:
        x = x * mask.numpy()
    if dim == 1:
        x = x.transpose(0, 2, 1)
    B, R, L = x.shape
    out = np.zeros((B, R), np.float32)
    for b in range(B):
        for r in range(R):
            lanes = [np.float32(0.0)] * 32
            for j in range(L):
                lanes[j % 32] = np.float32(lanes[j % 32] + x[b, r, j])
            width = 16
            while width:
                lanes = [np.float32(lanes[l] + lanes[l + width]) for l in range(width)]
                width //= 2
            out[b, r] = lanes[0]
    return torch.from_numpy(out)


def _ordered_inputs(shape, seed, signed=False):
    rng = np.random.default_rng(seed)
    low = -5.0 if signed else 0.0
    x = torch.from_numpy(rng.uniform(low, 5.0, shape).astype(np.float32))
    mask = torch.from_numpy(rng.random(shape) < 0.5)
    return x, mask


ORDERED_SHAPES = [(1, 1, 1), (2, 5, 70), (1, 33, 33), (3, 4, 1), (2, 64, 100)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("shape", ORDERED_SHAPES)
def test_ordered_sum_reference_is_the_stated_loop(shape, dim, masked):
    x, mask = _ordered_inputs(shape, sum(shape) + dim, signed=True)
    mask = mask if masked else None
    got = ordered_sum_reference(x, dim, mask)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[0], shape[3 - dim])
    assert torch.equal(got, _loop_ordered_sum(x, dim, mask))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("shape", [(1, 8, 8), (2, 40, 33), (3, 130, 97)])
def test_ordered_sum_is_bitwise_invariant_to_trailing_zero_padding(shape, dim, masked):
    """Zeros after the real entries of B, R and L (the simulator's padding)
    leave every real sum bit for bit as it was, and the CPU wrapper takes
    the plain version without a launch."""
    x, mask = _ordered_inputs(shape, 7 * sum(shape) + dim)
    base = ordered_sum_reference(x, dim, mask if masked else None)
    B, R, L = shape
    for extra in ((0, 0, 0), (1, 0, 0), (0, 5, 31), (2, 32, 64), (0, 200, 1)):
        big = torch.zeros(B + extra[0], R + extra[1], L + extra[2])
        big[:B, :R, :L] = x
        big_mask = torch.ones(big.shape, dtype=torch.bool)
        big_mask[:B, :R, :L] = mask
        before = ordered_sum.launches
        got = ordered_sum(big, dim, big_mask if masked else None)
        assert ordered_sum.launches == before
        n = R if dim == 2 else L
        assert torch.equal(got[:B, :n], base), extra
        assert not bool(got[B:].any()) and not bool(got[:, n:].any())


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1024, 1024), (4, 80, 1024), (2, 300, 7)])
def test_ordered_sum_is_close_to_torch_sum(shape, dim):
    x, mask = _ordered_inputs(shape, 3 + dim)
    for m in (None, mask):
        want = (x if m is None else x * m).double().sum(dim=dim)
        got = ordered_sum(x, dim, m).double()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        torch.testing.assert_close(got.float(), (x if m is None else x * m).sum(dim=dim),
                                   rtol=1e-6, atol=0)


def test_ordered_sum_adds_by_lane_not_in_sequence():
    """Values whose float32 sum depends on the grouping: lane 0 holds the
    cancelling pair and lane 1 the two ones, so the lanes give 2, where
    adding in index order loses a one to rounding at 1e8."""
    x = torch.zeros(1, 1, 64)
    x[0, 0, [0, 1, 32, 33]] = torch.tensor([1e8, 1.0, -1e8, 1.0])
    in_sequence = np.float32(0.0)
    for v in (1e8, 1.0, -1e8, 1.0):
        in_sequence = np.float32(in_sequence + np.float32(v))
    assert in_sequence == 1.0
    assert ordered_sum_reference(x, 2).item() == 2.0


def test_ordered_sum_rejects_bad_arguments():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="dim"):
        ordered_sum(x, 0)
