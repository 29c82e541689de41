"""The rank side of ``tests/test_torch_call_flash_heads.py``: four gloo ranks
on the CPU run ``models.attention.call_flash`` on DTensors placed as a
sharded step places attention's q, k and v, forward and backward, and rank
0 writes the gathered outputs and gradients beside the plain version's on
the whole tensors.

    python tests/torch_call_flash_worker.py <workdir>

``<workdir>/meta.json`` names the cases (mesh, heads, kv heads, window);
the ranks meet through a ``FileStore`` in ``<workdir>``, the group timing
out after the test's limit (``meta["limit_s"]``), and rank 0 writes ``<workdir>/results.json``: per case the
largest differences and the (q heads, kv heads) each rank's kernel call
took.  Nothing here imports JAX or the reference package.
"""
from __future__ import annotations

import datetime
import json
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
B, S, HD = 4, 16, 8


def one_case(case: dict) -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.attention import call_flash

    n_data, n_model = case["mesh"]
    mesh = make_debug_mesh(n_data, n_model, device_type="cpu")
    H, KV = case["heads"], case["kv_heads"]
    g = torch.Generator().manual_seed(case["seed"])
    q, k, v = (torch.randn(shape, generator=g) for shape in ((B, S, H, HD), (B, S, KV, HD),
                                                             (B, S, KV, HD)))
    dout = torch.randn((B, S, H, HD), generator=g)
    opts = dict(causal=True, window=case["window"], scale=HD ** -0.5)

    # q's heads over 'model' (they divide it), k's and v's only where theirs do
    q_pl = [Shard(0), Shard(2)]
    kv_pl = [Shard(0), Shard(2) if KV % n_model == 0 else Replicate()]
    qd, kd, vd = (distribute_tensor(t, mesh, pl, src_data_rank=None).requires_grad_(True)
                  for t, pl in ((q, q_pl), (k, kv_pl), (v, kv_pl)))
    calls = []

    def kernel(ql, kl, vl, **kw):
        calls.append([ql.shape[2], kl.shape[2]])
        return flash_attention(ql, kl, vl, **kw)

    out = call_flash(kernel, qd, kd, vd, **opts)
    (out.full_tensor() * dout).sum().backward()
    got = [out.full_tensor()] + [t.grad.full_tensor() for t in (qd, kd, vd)]

    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    want_out = flash_attention(qr, kr, vr, **opts)
    (want_out * dout).sum().backward()
    want = [want_out, qr.grad, kr.grad, vr.grad]
    errs = {name: float((a - b).abs().max() / b.abs().max())
            for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    per_rank = [None] * WORLD
    dist.all_gather_object(per_rank, calls)
    return {"errs": errs, "calls": per_rank, "out_placements": [str(p) for p in out.placements]}


def run(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "meta.json")) as f:
        meta = json.load(f)
    cases = meta["cases"]
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=meta["limit_s"]))
    try:
        results = {name: one_case(case) for name, case in cases.items()}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=WORLD, join=True)
