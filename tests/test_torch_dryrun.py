"""The port's dry run (``repro_torch.launch.dryrun``) and its counter
(``launch/counting.py``), at smoke size on the CPU.

- A cell on a fake (2, 2, 2) pod/data/model group runs and reports FLOPs,
  collectives and a peak, with JAX and the reference blocked: the port's
  counterpart of the reference's ``test_dryrun_cell_on_debug_mesh``.
- The dry run's per-device FLOPs, collective bytes by kind and kernel
  launches equal those of one real step counted on each of four gloo ranks
  (``tests/torch_dryrun_worker.py``), for a dense, an MoE, a Mamba and an
  MLA model, each train, prefill and decode.
- Per device against figures worked out without the counter: a product
  of two DTensors on a fake 16 × 16 group counts 2·m·k·n of the local
  shards that meet, and its collectives the bytes each rank writes; a cell
  that replicates nothing on a (4, 1) data-parallel group counts a quarter
  of what ``FlopCounterMode`` counts for the single-device model.
- A cell with an sLSTM token loop, counted at 1 and 2 periods and carried
  to its depth, equals a direct count.
- Each kernel wrapper's stand-in on fake or meta inputs launches nothing,
  leaves ``.launches`` as it was, returns the real path's shapes and dtypes
  and reports the same cost on CPU and CUDA fake tensors; a real CPU
  tensor still takes the plain version.
- ``main`` writes one JSON report per cell and skips the documented cells.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_reference,
)
from repro_torch.kernels.flash_attention.cost import flash_backward_cost, flash_cost
from repro_torch.kernels.rmsnorm import (
    add_rmsnorm, add_rmsnorm_backward, add_rmsnorm_reference, rmsnorm, rmsnorm_backward,
    rmsnorm_reference,
)
from repro_torch.kernels.rmsnorm.cost import add_rmsnorm_cost, norm_backward_cost, rmsnorm_cost
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_backward, ssm_scan_reference
from repro_torch.kernels.ssm_scan.cost import ssm_scan_backward_cost, ssm_scan_cost
from repro_torch.launch.counting import StepCounter

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: The ranks' limit and their process groups' timeout: at least three times
#: the fixture's wall under the suite's own load (``-n 6 --dist loadfile``,
#: 43-121 s), so a slow run finishes and a hang still fails.
LIMIT_S = 400
BLOCK = 'import sys\nsys.modules["jax"] = None\nsys.modules["repro"] = None\n'
NO_JAX = """
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not loaded, loaded
"""

#: The gloo cases: a dense, an MoE, a Mamba and an MLA model, each step kind.
ARCHS = ("llama3-8b@smoke", "olmoe-1b-7b@smoke", "jamba-1.5-large-398b@smoke",
         "minicpm3-4b@smoke")
CASES = {f"{arch}/{kind}": {"arch": arch, "kind": kind, "batch": 4,
                            "seq": 32 if kind != "decode" else 48, "seed": i}
         for i, (arch, kind) in enumerate((a, k) for a in ARCHS
                                          for k in ("train", "prefill", "decode"))}


def _python(code: str, timeout: float = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", BLOCK + textwrap.dedent(code) + NO_JAX],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)


def _last_json(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_dryrun_cell_on_debug_mesh():
    """The whole dry run (fake group, fake arguments, the counted step) of
    llama3-8b@smoke's train cell on a (2, 2, 2) pod/data/model mesh: the
    mesh is really sharded, so the step communicates."""
    res = _last_json(_python("""
        import json
        import torch
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.launch.dryrun import count_step, fake_process_group
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.sharding import PlanConfig

        with fake_process_group(8):
            mesh = make_debug_mesh(2, 2, multi_pod=True, device_type="cpu")
            fig = count_step(get_config("llama3-8b@smoke"), ShapeConfig("t", 128, 8, "train"),
                             mesh, PlanConfig(multi_pod=True, tp=2, dp=2))
        print(json.dumps(fig))
    """))
    assert res["flops"] > 0
    assert sum(res["collectives"].values()) > 0       # a sharded program communicates
    assert res["peak_bytes"] > 0
    assert res["argument_bytes"] > 0 and res["output_bytes"] > 0
    assert set(res["collectives"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                       "all-to-all", "collective-permute"}
    # the kernels' stand-ins reported launches (forward, the remat's
    # recompute and the backward), and nothing launched
    assert res["kernels"]["flash_attention"]["launches"] > 0
    assert res["kernels"]["flash_attention_backward"]["launches"] > 0
    assert res["kernels"]["add_rmsnorm_backward"]["launches"] > 0


@pytest.fixture(scope="module")
def gloo_and_dry(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun_ranks")
    (work / "meta.json").write_text(json.dumps({"cases": CASES, "limit_s": LIMIT_S}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    started = time.monotonic()
    ranks = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dryrun_worker.py"),
                              str(work)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = ranks.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(ranks.pid, signal.SIGKILL)
        log, _ = ranks.communicate()
        pytest.fail(f"the ranks did not finish within {LIMIT_S} s "
                    f"({time.monotonic() - started:.0f} s):\n{log[-4000:]}")
    finally:
        if ranks.poll() is None:
            os.killpg(ranks.pid, signal.SIGKILL)
    assert ranks.returncode == 0, log[-6000:]
    return json.loads((work / "results.json").read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_dry_run_counts_equal_gloo_ranks(gloo_and_dry, case):
    """Per device, the dry run on fake tensors counts what one real step
    counts on each of four gloo ranks: FLOPs, collective bytes by kind,
    and each kernel's launches, FLOPs and bytes."""
    dry = gloo_and_dry["dry"][case]
    assert dry["flops"] > 0
    for rank, real in enumerate(gloo_and_dry["real"][case]):
        assert real["flops"] == dry["flops"], rank
        assert real["collectives"] == dry["collectives"], rank
        assert real["kernels"] == dry["kernels"], rank


#: Products of two DTensors on a fake 16 × 16 group: name -> (a's shape,
#: a's placements, whether a is gathered whole first, b's shape, b's
#: placements, whether a is transposed, the output's placements after the
#: product (None: as it comes)).  One placement per mesh dim ("data",
#: "model"): "S0" Shard(0), "S1" Shard(1), "R" Replicate.
PRODUCTS = {
    # (4096 × 1024)ᵀ @ (4096 × 4096) with the contraction over 'data'
    "contraction over data": ((4096, 1024), ("S0", "R"), False, (4096, 4096), ("S0", "R"), True,
                              None),
    "rows over data, columns over model": ((512, 1024), ("S0", "R"), False, (1024, 2048),
                                           ("R", "S1"), False, None),
    "contraction over model, summed": ((512, 1024), ("R", "S1"), False, (1024, 256), ("R", "S0"),
                                       False, ("R", "R")),
    "contraction over model, scattered": ((512, 1024), ("R", "S1"), False, (1024, 256),
                                          ("R", "S0"), False, ("R", "S0")),
    "rows gathered first": ((512, 1024), ("S0", "R"), True, (1024, 64), ("R", "R"), False, None),
}

_PRODUCTS = """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.counting import StepCounter
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_production_mesh

    PL = {{"S0": Shard(0), "S1": Shard(1), "R": Replicate()}}
    WHOLE = [Replicate(), Replicate()]
    out = {{}}
    with fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            for name, (sa, pa, gather, sb, pb, transposed, after) in {cases!r}.items():
                a = distribute_tensor(torch.empty(sa), mesh, [PL[p] for p in pa],
                                      src_data_rank=None)
                b = distribute_tensor(torch.empty(sb), mesh, [PL[p] for p in pb],
                                      src_data_rank=None)
                with StepCounter() as counter, FlopCounterMode(display=False) as dtensor_level:
                    if gather:
                        a = a.redistribute(mesh, WHOLE)
                    c = (a.t() if transposed else a) @ b
                    if after is not None:
                        c = c.redistribute(mesh, [PL[p] for p in after])
                out[name] = dict(counter.figures(), dtensor_level=dtensor_level.get_total_flops())
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def products():
    return _last_json(_python(_PRODUCTS.format(cases=PRODUCTS)))


def _local_shape(shape, placements, mesh=(16, 16)):
    """A tensor's shard on one rank: each dim split by the mesh dims that
    shard it (counted by hand, not by DTensor)."""
    out = list(shape)
    for p, n in zip(placements, mesh):
        if p in ("S0", "S1"):
            out[int(p[1])] //= n
    return out


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_a_sharded_product_counts_its_local_shards_product(products, name):
    """Per device means the rank's own product: 2·m·k·n of the local shards
    that meet (worked out here from the placements), where
    ``FlopCounterMode`` over the DTensors counts the global product (3.44e10
    for the first case against the local 2.15e9); and a collective counts
    the bytes it writes on the rank: an all-reduce or an all-gather the
    whole output, a reduce-scatter the rank's shard."""
    sa, pa, gather, sb, pb, transposed, after = PRODUCTS[name]
    got = products[name]
    la = list(sa) if gather else _local_shape(sa, pa)
    lb = _local_shape(sb, pb)
    m, k = (la[1], la[0]) if transposed else (la[0], la[1])
    assert k == lb[0]
    n = lb[1]
    assert got["flops"] == 2 * m * k * n
    M, K = (sa[1], sa[0]) if transposed else sa
    assert got["dtensor_level"] == 2 * M * K * sb[1]
    if name == "contraction over data":
        assert (got["flops"], got["dtensor_level"]) == (2147483648, 34359738368)
    fp32 = 4
    want = {
        "contraction over data": {},            # left a Partial sum: nothing moves yet
        "rows over data, columns over model": {},
        "contraction over model, summed": {"all-reduce": m * n * fp32},
        "contraction over model, scattered": {"reduce-scatter": m * n // 16 * fp32},
        "rows gathered first": {"all-gather": sa[0] * sa[1] * fp32},
    }[name]
    assert got["collectives"] == want


#: The cells that replicate nothing on a (4, 1) data-parallel mesh: each of
#: four ranks runs a quarter of every op.  MLA's decode gathers its
#: FSDP-sharded down-projections, so each rank projects and norms its own
#: batch rows (DTensor gathered the one-token rows instead: 1.234x a
#: quarter at minicpm3@smoke before).
SPLIT_CELLS = ("llama3-8b@smoke/train", "llama3-8b@smoke/prefill", "llama3-8b@smoke/decode",
               "olmoe-1b-7b@smoke/train", "jamba-1.5-large-398b@smoke/train",
               "minicpm3-4b@smoke/train", "minicpm3-4b@smoke/prefill",
               "minicpm3-4b@smoke/decode", "xlstm-1.3b@smoke/train")

_SPLIT = """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import _cost
    from repro_torch.launch.dryrun import count_step, fake_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig
    from repro_torch.models.common import tree_defs_map
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import decoder_defs


    class Kernels:
        # the hand-written kernels' own FLOPs, as their wrappers report them
        flops = 0.0

        def kernel(self, name, flops, nbytes):
            self.flops += flops


    def unsharded(cfg, shape):
        # the single-device model on fake tensors, no process group, counted
        # by torch's own FlopCounterMode
        B, S = shape.global_batch, shape.seq_len
        with FakeTensorMode():
            model = Model(cfg, tree_defs_map(
                lambda pd: torch.empty(pd.shape, dtype=torch.float32), decoder_defs(cfg)))
            kernels = Kernels()
            with _cost.registered(kernels), FlopCounterMode(display=False) as fc:
                if shape.kind == "train":
                    model.remat = "full"
                    model.trainable()
                    batch = {{"tokens": torch.zeros((B, S), dtype=torch.long),
                              "labels": torch.zeros((B, S), dtype=torch.long)}}
                    model.loss_fn(batch)[0].backward()
                elif shape.kind == "prefill":
                    model.forward_prefill(torch.zeros((B, S), dtype=torch.long))
                else:
                    caches = model.cache_struct(B, S, dtype=torch.float32)
                    model.forward_decode(torch.zeros((B, 1), dtype=torch.long), caches, S - 1)
        return fc.get_total_flops() + kernels.flops


    out = {{}}
    for case in {cells!r}:
        arch, kind = case.split("/")
        cfg = get_config(arch)
        shape = ShapeConfig(kind, 48 if kind == "decode" else 32, 4, kind)
        total = unsharded(cfg, shape)
        with fake_process_group(4):
            rank = count_step(cfg, shape, make_debug_mesh(4, 1, device_type="cpu"),
                              PlanConfig(tp=1, dp=4), param_dtype=torch.float32)
        out[case] = {{"unsharded": total, "per_device": rank["flops"]}}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def split_cells():
    return _last_json(_python(_SPLIT.format(cells=SPLIT_CELLS)))


@pytest.mark.parametrize("case", SPLIT_CELLS)
def test_a_data_parallel_cell_counts_a_quarter_of_the_unsharded_step(split_cells, case):
    """Nothing replicated, four ranks: the dry run's per-device FLOPs are the
    single-device step's (the model on fake tensors with no mesh, counted
    by ``FlopCounterMode``, plus the kernels' own) over four, exactly."""
    got = split_cells[case]
    assert got["per_device"] > 0
    assert 4 * got["per_device"] == got["unsharded"]


_KEY_SPLIT = """
    import dataclasses, json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import _cost
    from repro_torch.launch.dryrun import count_step, fake_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig, make_rules
    from repro_torch.models.common import tree_defs_map
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import decoder_defs


    class Kernels:
        # each hand-written kernel's FLOPs, as its wrapper reports them
        def __init__(self):
            self.flops = {{}}

        def kernel(self, name, flops, nbytes):
            self.flops[name] = self.flops.get(name, 0.0) + flops


    cfg = dataclasses.replace(get_config("minicpm3-4b@smoke"), n_heads=6, n_kv_heads=6)
    out = {{}}
    for kind in ("prefill", "train"):
        shape = ShapeConfig(kind, 32, 2, kind)
        plan = PlanConfig(tp=4, dp=1)
        with FakeTensorMode():
            model = Model(cfg, tree_defs_map(
                lambda pd: torch.empty(pd.shape, dtype=torch.float32), decoder_defs(cfg)))
            kernels = Kernels()
            with _cost.registered(kernels):
                tokens = torch.zeros((2, 32), dtype=torch.long)
                if kind == "train":
                    model.remat = "full"
                    model.trainable()
                    model.loss_fn({{"tokens": tokens, "labels": tokens}})[0].backward()
                else:
                    model.forward_prefill(tokens)
        with fake_process_group(4):
            rank = count_step(cfg, shape, make_debug_mesh(1, 4, device_type="cpu"), plan,
                              param_dtype=torch.float32)
        rules = make_rules(cfg, shape, plan)
        out[kind] = {{"unsharded": kernels.flops,
                      "per_device": {{k: v["flops"] for k, v in rank["kernels"].items()}},
                      "rules": [rules["act_heads"], rules["act_seq"]]}}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def key_split():
    return _last_json(_python(_KEY_SPLIT.format()))


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_backward"])
def test_mla_attention_split_over_the_keys_counts_a_quarter_a_rank(key_split, kind, kernel):
    """MLA whose heads tp does not divide (minicpm3@smoke with 6 heads, tp
    4 on a (1, 4) fake group, 32 tokens) splits its attention over the
    keys, as the reference's score tensors split on the key axis: each
    rank's flash kernels count exactly a quarter of the single-device
    step's FLOPs (each rank's two key chunks, the first and the mirrored
    last, see as many (query, key) pairs as any other's), where gathering
    the heads gave every rank all of them."""
    got = key_split[kind]
    assert got["rules"] == [None, "model"]
    if kind == "prefill" and kernel == "flash_attention_backward":
        assert kernel not in got["per_device"] and kernel not in got["unsharded"]
        return
    assert got["per_device"][kernel] > 0
    assert 4 * got["per_device"][kernel] == got["unsharded"][kernel]


_MOE_GROUPS = """
    import dataclasses, json
    from types import SimpleNamespace
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.counting import StepCounter
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig, make_rules
    from repro_torch.models.common import axis_rules
    from repro_torch.models.moe import moe_ffn

    cfg = dataclasses.replace(get_config("olmoe-1b-7b@smoke"), moe_groups={groups})
    B, S, d = 8, 32, cfg.d_model
    shapes = {{"router": (d, cfg.n_experts), "w1": (cfg.n_experts, d, cfg.expert_ff),
               "w3": (cfg.n_experts, d, cfg.expert_ff), "w2": (cfg.n_experts, cfg.expert_ff, d)}}
    with FakeTensorMode():
        p = {{n: torch.empty(s) for n, s in shapes.items()}}
        with FlopCounterMode(display=False) as fc:
            moe_ffn(SimpleNamespace(**p), torch.empty(B, S, d), cfg, need_aux=False)
    with fake_process_group(8):
        mesh = make_debug_mesh(4, 1, multi_pod=True, device_type="cpu")
        rules = make_rules(cfg, ShapeConfig("t", S, B, "prefill"),
                           PlanConfig(multi_pod=True, tp=1, dp=4))
        with FakeTensorMode(allow_non_fake_inputs=True):
            pd = {{n: distribute_tensor(t, mesh, [Replicate()] * 3, src_data_rank=None)
                   for n, t in p.items()}}
            x = distribute_tensor(torch.empty(B, S, d), mesh,
                                  [Shard(0), Shard(0), Replicate()], src_data_rank=None)
            with axis_rules(rules), StepCounter() as counter:
                moe_ffn(SimpleNamespace(**pd), x, cfg, need_aux=False)
    print(json.dumps({{"unsharded": fc.get_total_flops(), "per_device": counter.figures()["flops"],
                       "act_batch": rules["act_batch"]}}))
"""


@pytest.mark.parametrize("groups", [4, 1])
def test_moe_groups_split_unevenly_over_the_data_ranks(groups):
    """olmoe@smoke's MoE layer on a (pod 2, data 4, model 1) fake group
    with 4 dispatch groups, or 1, which the 8 data ranks do not divide:
    the groups are split over 'pod' and 'data' unevenly (GSPMD's padding),
    so rank 0 routes and runs one group and counts exactly one group's
    share of the single-device layer's FLOPs (with 4 groups it ran its
    pod's 2 when 'data' replicated them)."""
    got = _last_json(_python(_MOE_GROUPS.format(groups=groups)))
    assert got["act_batch"] == ["pod", "data"]
    assert got["per_device"] > 0
    assert groups * got["per_device"] == got["unsharded"]


_LOOP = """
    import dataclasses, json
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.dryrun import count_cell, count_step, fake_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import PlanConfig

    cfg = get_config("xlstm-1.3b@smoke")
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern()) * 3)
    shape = ShapeConfig("t", 48, 4, "{kind}")
    with fake_process_group(4):
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        plan = PlanConfig(tp=2, dp=2)
        direct = count_step(cfg, shape, mesh, plan)
        carried, note = count_cell(cfg, shape, mesh, plan)
    print(json.dumps({{"direct": direct, "carried": carried, "note": note}}))
"""


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_token_loop_cells_carried_to_their_depth_equal_a_direct_count(kind):
    """xlstm@smoke at 3 periods (an sLSTM block each) counted at 1 and 2
    periods and carried on a line: every count equals the direct count's."""
    res = _last_json(_python(_LOOP.format(kind=kind)))
    assert "sLSTM token loop" in res["note"]
    for key in ("flops", "bytes", "collectives", "kernels", "argument_bytes", "output_bytes"):
        assert res["carried"][key] == res["direct"][key], key


def _fake_inputs(device, make):
    """``make``'s inputs as fake tensors on ``device`` (no CUDA needed)."""
    real = make("cpu")
    with FakeTensorMode():
        return tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in real)


def _norm_inputs(device):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 16), generator=g).to(device)
    return x, torch.randn((2, 5, 16), generator=g).to(device), torch.randn(16, generator=g).to(device)


def _flash_inputs(device):
    g = torch.Generator().manual_seed(1)
    return tuple(torch.randn(s, generator=g).to(device) for s in ((2, 9, 4, 8), (2, 9, 2, 8),
                                                                  (2, 9, 2, 8)))


def _scan_inputs(device):
    g = torch.Generator().manual_seed(2)
    B, S, D, N = 2, 11, 6, 4
    dt = torch.rand((B, S, D), generator=g) * 0.1
    return tuple(t.to(device) for t in (
        dt, torch.randn((B, S, D), generator=g), torch.randn((B, S, N), generator=g),
        torch.randn((B, S, N), generator=g), -torch.rand((D, N), generator=g),
        torch.randn((B, D, N), generator=g)))


#: name -> (inputs, call, plain version, forward cost, backward cost)
WRAPPERS = {
    "rmsnorm": (_norm_inputs, lambda x, d, g: rmsnorm(x, g), lambda x, d, g: rmsnorm_reference(x, g),
                rmsnorm_cost(10, 16), norm_backward_cost(10, 16, False)),
    "add_rmsnorm": (_norm_inputs, lambda x, d, g: add_rmsnorm(x, d, g),
                    lambda x, d, g: add_rmsnorm_reference(x, d, g), add_rmsnorm_cost(10, 16),
                    norm_backward_cost(10, 16, True)),
    "flash_attention": (_flash_inputs, lambda q, k, v: flash_attention(q, k, v),
                        lambda q, k, v: flash_attention_reference(q, k, v),
                        None, None),
    "ssm_scan": (_scan_inputs, ssm_scan, ssm_scan_reference, ssm_scan_cost(2, 11, 6, 4), None),
}


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


def _launches():
    fns = (rmsnorm, add_rmsnorm, flash_attention, ssm_scan, rmsnorm_backward,
           add_rmsnorm_backward, flash_attention_backward, ssm_scan_backward)
    return [f.launches for f in fns]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_fake_branch_launches_nothing_and_counts_alike_on_every_device(name, grad):
    make, call, plain, _, _ = WRAPPERS[name]
    want = _flat(plain(*make("cpu")))
    before = _launches()
    costs = []
    # a backward through fake CUDA tensors needs a CUDA build of torch (the
    # autograd engine's device threads): the card's dry run runs it
    for device in ("cpu", "meta") if grad else ("cpu", "cuda", "meta"):
        inputs = (tuple(torch.empty_like(t, device="meta") for t in make("cpu"))
                  if device == "meta" else _fake_inputs(device, make))
        if grad:
            inputs = tuple(t.requires_grad_(t.is_floating_point()) for t in inputs)
        with StepCounter() as counter:
            out = _flat(call(*inputs))
            if grad:
                sum(o.sum() for o in out).backward()
        assert [(o.shape, o.dtype) for o in out] == [(w.shape, w.dtype) for w in want], device
        if grad:       # rmsnorm takes x and the gain, not delta
            used = [t for t in inputs if t.grad is not None]
            assert len(used) == len(inputs) - (name == "rmsnorm"), device
            assert all(t.grad.shape == t.shape and t.grad.dtype == t.dtype for t in used), device
        costs.append(counter.figures()["kernels"])
    assert _launches() == before                      # nothing launched, nothing counted
    assert all(c == costs[0] for c in costs)
    kernels = costs[0]
    assert kernels[name]["launches"] == 1
    backward = name + "_backward"
    assert (kernels.get(backward, {}).get("launches", 0)) == (1 if grad else 0)


def test_stand_in_costs_are_the_kernel_formulas():
    """Each stand-in reports its package's cost formula (fp32, the shapes
    above); under grad the forward adds what it keeps for the backward."""
    for name in ("rmsnorm", "add_rmsnorm", "ssm_scan"):
        make, call, _, fwd, _ = WRAPPERS[name]
        with StepCounter() as counter:
            call(*_fake_inputs("cpu", make))
        got = counter.figures()["kernels"][name]
        assert (got["flops"], got["bytes"]) == fwd, name
    q, k, v = _fake_inputs("cpu", _flash_inputs)
    for t in (q, k, v):
        t.requires_grad_(True)
    with StepCounter() as counter:
        flash_attention(q, k, v).sum().backward()
    got = counter.figures()["kernels"]
    mm, soft, nbytes = flash_cost(2, 9, 9, 4, 2, 8, lse=True)
    assert (got["flash_attention"]["flops"], got["flash_attention"]["bytes"]) == (mm + soft, nbytes)
    mm, soft, nbytes = flash_backward_cost(2, 9, 9, 4, 2, 8)
    assert (got["flash_attention_backward"]["flops"],
            got["flash_attention_backward"]["bytes"]) == (mm + soft, nbytes)
    dt = _fake_inputs("cpu", _scan_inputs)
    with StepCounter() as counter:
        ssm_scan_backward(*dt, torch.empty_like(dt[0]))
    got = counter.figures()["kernels"]["ssm_scan_backward"]
    assert (got["flops"], got["bytes"]) == ssm_scan_backward_cost(2, 11, 6, 4)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_real_cpu_tensors_take_the_plain_version(name):
    """Without a counter the wrapper is the plain version; with one it
    returns the same bits (in the kernel's layout) and reports one launch,
    and neither launches anything."""
    make, call, plain, _, _ = WRAPPERS[name]
    inputs = make("cpu")
    want = _flat(plain(*inputs))
    before = _launches()
    got = _flat(call(*inputs))
    with StepCounter() as counter:
        counted = _flat(call(*inputs))
    for a, b, w in zip(got, counted, want):
        assert torch.equal(a, w) and torch.equal(b, w)
        assert b.is_contiguous()
    assert counter.figures()["kernels"][name]["launches"] == 1
    assert counter.figures()["flops"] == counter.figures()["kernels"][name]["flops"]
    assert _launches() == before


def test_main_writes_a_report_per_cell_and_skips_the_documented_ones(tmp_path):
    """A full-attention model's 500k decode is no cell (``cell_is_supported``):
    reported as a skip, no model built, exit 0."""
    proc = _python(f"""
        sys.argv = ["dryrun", "--arch", "llama3-8b", "--shape", "long_500k",
                    "--multi-pod", "both", "--device-type", "cpu", "--out", {str(tmp_path)!r}]
        from repro_torch.launch.dryrun import main
        main()
    """)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 ok, 2 skipped (documented), 0 FAILED" in proc.stdout
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["llama3-8b__long_500k__16x16.json", "llama3-8b__long_500k__2x16x16.json"]
    rep = json.loads((tmp_path / names[0]).read_text())
    assert rep["ok"] is False and rep["notes"] == "skip" and rep["error"].startswith("skipped")
    assert set(rep) == {"arch", "shape", "mesh", "ok", "error", "compile_seconds", "flops",
                        "hlo_bytes", "peak_bytes_per_device", "argument_bytes", "output_bytes",
                        "collectives", "n_params", "notes"}


def test_a_checkpointed_block_is_recomputed_under_the_steps_rules():
    """Autograd runs a CUDA backward on a device thread of its own, where
    the step's thread-local axis rules are not installed; a block under
    remat carries them into its recompute (a backward run from another
    thread stands in for the device thread)."""
    import threading

    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.common import axis_rules, current_rules
    from repro_torch.models.transformer import _with_rules

    seen = []

    def block(x):
        seen.append(current_rules())
        return (x * 2.0).sin()

    rules = {"act_batch": "data"}
    x = torch.ones(3, requires_grad=True)
    with axis_rules(rules):
        y = checkpoint(_with_rules(block, current_rules()), x, use_reentrant=False).sum()
    backward = threading.Thread(target=y.backward)
    backward.start()
    backward.join(timeout=60)
    assert not backward.is_alive()
    assert seen == [rules, rules]          # the forward and its recompute
    assert x.grad is not None and current_rules() is None
