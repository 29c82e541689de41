"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, and its entry points run on the card unless told otherwise."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.kernels.stream_flow import stream_flow_ell

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(?!\w)|from\s+repro(?!\w))",
    re.M,
)

_BLOCKED_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
from repro_torch.core import round_robin_configuration
from repro_torch.streams import deep_pipeline, measure_capacity
dag = deep_pipeline()
cfg = round_robin_configuration(dag, {n: 1 for n in dag.node_names}, 2)
cap = measure_capacity(cfg, duration_s=2.0, device="cpu")
assert cap > 0, cap
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("capacity", cap)
"""

_BLOCKED_SERVE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch.models
import repro_torch.kernels.flash_attention
import repro_torch.kernels.rmsnorm
import repro_torch.launch.mesh
import repro_torch.launch.sharding
import repro_torch.launch.steps
import repro_torch.optim.compression
from repro_torch.launch.serve import BatchedServer, Request
server = BatchedServer("llama3-8b@smoke", batch_slots=2, max_ctx=64, device="cpu")
server.submit(Request(0, np.arange(4, 13, dtype=np.int32), 4))
server.submit(Request(1, np.arange(4, 21, dtype=np.int32), 3))
server.drain()
assert sorted(len(r.tokens_out) for r in server.completed) == [3, 4], server.completed
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("served", server.decode_steps)
"""


def _run_blocked(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300,
    )


def test_port_runs_with_jax_and_reference_blocked():
    proc = _run_blocked(_BLOCKED_RUN)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "capacity" in proc.stdout


def test_port_serves_with_jax_and_reference_blocked():
    proc = _run_blocked(_BLOCKED_SERVE)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served" in proc.stdout


def test_port_sources_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files[:-1]}
    assert {"fleet/cluster.py", "fleet/scheduler.py", "fleet/loop.py",
            "checkpoint/checkpointer.py", "checkpoint/control_state.py",
            "runtime/fault.py", "streams/operators.py", "streams/executor.py",
            "streams/engine.py", "control/learning.py", "core/lp.py",
            "core/node_model.py", "core/lm_bridge.py", "runtime/elastic.py",
            "control/policies.py", "models/frontends.py", "models/attention.py",
            "models/transformer.py", "models/model.py", "models/moe.py",
            "launch/serve.py", "interop.py"} <= names
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders


def test_forbidden_pattern_tells_port_from_reference():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import dag")
    assert FORBIDDEN.search("import repro")
    assert not FORBIDDEN.search("import repro_torch")
    assert not FORBIDDEN.search("from repro_torch.core import dag")


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_model_kernels_count_only_kernel_launches():
    """The model's RMSNorm and prefill core take the plain versions on CPU
    tensors, which are not launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import build_model

    model = build_model(get_config("llama3-8b@smoke"), device="cpu")
    before = (rmsnorm.launches, flash_attention.launches)
    logits, _ = model.forward_prefill(torch.arange(4, 12).reshape(1, 8))
    assert torch.isfinite(logits).all()
    assert (rmsnorm.launches, flash_attention.launches) == before


def test_flow_wrapper_counts_only_kernel_launches():
    """CPU tensors take the plain version, which is not a launch."""
    before = stream_flow_ell.launches
    B, I, K, E, D = 1, 4, 2, 3, 4
    q = torch.ones(B, I)
    idx = torch.zeros(B, E, dtype=torch.int64)
    f = torch.ones(B, E)
    ell = torch.full((B, I, D), E, dtype=torch.int64)
    out = stream_flow_ell(q, idx, f, f, idx, idx, ell, ell,
                          torch.zeros(B, I, dtype=torch.int64), torch.ones(B, K))
    assert [tuple(o.shape) for o in out] == [(B, I), (B, I), (B, K)]
    assert all(float(o.abs().sum()) == 0.0 for o in out)   # empty ELL rows
    assert stream_flow_ell.launches == before


def test_kernel_libraries_build_into_one_directory_named_by_source():
    """Every kernel builds through the shared helper into ``build/kernels``
    under a name that carries its source's hash; ``stream_flow.build``
    keeps its module-level names."""
    from repro_torch.kernels.flash_attention.ops import LIBRARY as flash
    from repro_torch.kernels.rmsnorm.ops import LIBRARY as rms
    from repro_torch.kernels.stream_flow import build

    paths = [lib.library_path() for lib in (flash, rms, build.LIBRARY)]
    assert {p.parent for p in paths} == {ROOT / "build" / "kernels"}
    assert [p.name.rsplit("-", 1)[0] for p in paths] == ["flash_attention", "rmsnorm", "stream_flow"]
    assert len({p.name.rsplit("-", 1)[1] for p in paths}) == 3
    assert build.library_path() == paths[2]
    assert build.build_log == build.LIBRARY.build_log


_BLOCKED_SERVE_HYBRID = """
import dataclasses
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch.kernels.ssm_scan
from repro_torch.configs import get_config
from repro_torch.launch.serve import BatchedServer, Request
cfg = dataclasses.replace(get_config("jamba-1.5-large-398b@smoke"), n_experts=0,
                          experts_per_token=0)
server = BatchedServer(cfg, batch_slots=2, max_ctx=64, device="cpu")
server.submit(Request(0, np.arange(4, 13, dtype=np.int32), 4))
server.submit(Request(1, np.arange(4, 21, dtype=np.int32), 3))
server.submit(Request(2, np.arange(4, 30, dtype=np.int32), 2))
server.drain()
assert sorted(len(r.tokens_out) for r in server.completed) == [2, 3, 4], server.completed
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("served", server.decode_steps)
"""


def test_port_serves_the_dense_hybrid_with_jax_and_reference_blocked():
    proc = _run_blocked(_BLOCKED_SERVE_HYBRID)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served" in proc.stdout


def test_hybrid_model_kernels_count_only_kernel_launches():
    """A hybrid model's Mamba blocks take the plain scan on CPU tensors, in
    prefill and decode, which are not launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b@smoke"), n_experts=0,
                              experts_per_token=0)
    model = build_model(cfg, device="cpu")
    before = (rmsnorm.launches, flash_attention.launches, ssm_scan.launches)
    logits, _ = model.forward_prefill(torch.arange(4, 12).reshape(1, 8))
    logits2, _ = model.forward_decode(torch.tensor([[5]]), model.cache_struct(1, 16), 8)
    assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
    assert (rmsnorm.launches, flash_attention.launches, ssm_scan.launches) == before


def test_ssm_scan_library_builds_beside_the_others():
    """The selective scan builds through the shared helper into
    ``build/kernels`` under its own name and source hash."""
    from repro_torch.kernels.flash_attention.ops import LIBRARY as flash
    from repro_torch.kernels.rmsnorm.ops import LIBRARY as rms
    from repro_torch.kernels.ssm_scan.ops import LIBRARY as scan
    from repro_torch.kernels.stream_flow import build

    path = scan.library_path()
    assert path.parent == ROOT / "build" / "kernels"
    assert path.name.rsplit("-", 1)[0] == "ssm_scan"
    assert scan.source == ROOT / "src" / "repro_torch" / "kernels" / "ssm_scan" / "csrc" / "ssm_scan.cu"
    others = {lib.library_path().name.rsplit("-", 1)[1] for lib in (flash, rms, build.LIBRARY)}
    assert path.name.rsplit("-", 1)[1] not in others


_BLOCKED_CONTROL = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.control import (
    ControlLoop, GuardBands, HoltWintersForecaster, ModelStore, PredictivePolicy, make_trace,
)
from repro_torch.core import ContainerDim, oracle_models
from repro_torch.streams import SimulatorEvaluator, adanalytics, cache_stats
dag = adanalytics()
store = ModelStore(oracle_models(dag, 1.0 / 724.0))
loop = ControlLoop(
    PredictivePolicy(dag, store, preferred_dim=ContainerDim(3.0, 4096.0)),
    guards=GuardBands(headroom=1.0, deadband=0.2),
    evaluator=SimulatorEvaluator(duration_s=1.0, device="cpu"),
    learner=store, forecaster=HoltWintersForecaster(season=4), horizon=2,
    saturation_threshold=0.95,
)
records = loop.run(make_trace("diurnal", 4, base_ktps=150.0, seed=3))
assert len(records) == 4 and all(r.achieved > 0 for r in records), records
assert all(e.policy == "predictive" for e in loop.events)
assert cache_stats()["dedup"]["rows_executed"] > 0
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("controlled", [e.containers for e in loop.events])
"""


def test_port_control_loop_runs_with_jax_and_reference_blocked():
    proc = _run_blocked(_BLOCKED_CONTROL)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "controlled" in proc.stdout


def test_evaluator_runs_on_the_card_or_raises():
    """``SimulatorEvaluator()`` resolves its device when it is built: the
    card, or an error without one, never the CPU unless asked for."""
    from repro_torch.streams import SimulatorEvaluator

    if torch.cuda.is_available():
        assert SimulatorEvaluator().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SimulatorEvaluator()
    assert SimulatorEvaluator(device="cpu").device.type == "cpu"


_BLOCKED_FLEET = """
import sys, tempfile
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.checkpoint
import repro_torch.fleet
import repro_torch.runtime
from repro_torch.checkpoint import Checkpointer
from repro_torch.control import GuardBands
from repro_torch.core import ContainerDim, oracle_models
from repro_torch.fleet import Cluster, FleetLoop, MachineClass, QosTier, TenantSpec
from repro_torch.runtime import FailurePlan, run_with_restarts
from repro_torch.streams import SimulatorEvaluator, adanalytics, wordcount
tenants = [
    TenantSpec(name=n, dag=d, target_ktps=t, qos=q, models=oracle_models(d, 1.0 / 724.0),
               guards=GuardBands(headroom=1.2, deadband=0.15),
               preferred_dim=ContainerDim(3.0, 4096.0))
    for n, d, t, q in (("ads", adanalytics(), 200.0, QosTier.GUARANTEED),
                       ("wc", wordcount(), 300.0, QosTier.BEST_EFFORT))
]
cluster = Cluster([MachineClass("std", count=4, cores=4.0, mem_mb=16384.0)])
loop = FleetLoop(tenants, cluster, SimulatorEvaluator(duration_s=1.0, device="cpu"))
plan = FailurePlan(fail_after_steps=(0,))
with tempfile.TemporaryDirectory() as tmp:
    ckpt = Checkpointer(tmp)

    def run(attempt):
        if attempt:
            assert loop.restore(ckpt) == 1
        e = loop.step({"ads": 200.0 + 50.0 * attempt, "wc": 300.0})
        loop.checkpoint(ckpt)
        plan.maybe_fail(0)
        return e

    last, restarts = run_with_restarts(run)
assert restarts == 1 and len(loop.events) == 2, (restarts, loop.events)
assert all(t.achieved_ktps > 0 for e in loop.events for t in e.tenants), loop.events
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("scheduled", [e.cause for e in loop.events])
"""


def test_port_fleet_runs_with_jax_and_reference_blocked():
    proc = _run_blocked(_BLOCKED_FLEET)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "scheduled" in proc.stdout


_BLOCKED_EXECUTOR = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
from repro_torch.control import fold_executor_timings
from repro_torch.core import round_robin_configuration
from repro_torch.core.lp import linprog, torch_linprog
from repro_torch.core.node_model import fit_many_torch
from repro_torch.streams import ExecutorEvaluator, mobile_analytics, wordcount
from repro_torch.streams.executor import run_dag
report = run_dag(mobile_analytics(), n_batches=2, device="cpu")
assert report.tuples_processed == 2 * 2048, report.tuples_processed
assert report.outputs["report_sink"]["geo"].dtype == torch.int32
ev = ExecutorEvaluator(n_batches=2, device="cpu")
dag = wordcount()
cfg = round_robin_configuration(dag, {"W": 1, "C": 1}, 2)
assert ev.evaluate(cfg).achieved_ktps > 0
cal, params = fold_executor_timings(dag, ev)
assert params.sm_cost_per_ktuple > 0
rng = np.random.default_rng(0)
c, A = rng.normal(size=6), np.abs(rng.normal(size=(4, 6))) + 0.1
b = rng.uniform(1.0, 3.0, size=(8, 4))
x, fun, status = torch_linprog(c, A, b, np.zeros((0, 6)), np.zeros((8, 0)), device="cpu")
assert (status == 0).all(), status
assert abs(float(fun[0]) - linprog(c, A_ub=A, b_ub=b[0]).fun) < 1e-4
slope, _, _ = fit_many_torch(rng.random((3, 16)), rng.random((3, 16)), device="cpu")
assert slope.shape == (3,)
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("executed", report.tuples_processed, float(fun[0]))
"""


def test_port_executor_and_batched_lp_run_with_jax_and_reference_blocked():
    proc = _run_blocked(_BLOCKED_EXECUTOR)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "executed" in proc.stdout


_BLOCKED_ENCDEC_AND_ELASTIC = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch.core.lm_bridge
import repro_torch.models.frontends
import repro_torch.runtime.elastic
from repro_torch.core.lm_bridge import LMWorkloadModel, StageCost
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.runtime import ElasticController
server = BatchedServer("seamless-m4t-large-v2@smoke", batch_slots=2, max_ctx=64, device="cpu")
server.submit(Request(0, np.arange(4, 13, dtype=np.int32), 4))
server.submit(Request(1, np.arange(4, 21, dtype=np.int32), 3))
server.submit(Request(2, np.arange(4, 30, dtype=np.int32), 2))
server.drain()
assert sorted(len(r.tokens_out) for r in server.completed) == [2, 3, 4], server.completed
assert tuple(server.caches["cross_kv"]["k"].shape) == (2, 2, 16, 4, 16)
stage = StageCost("decode_step", 2 * 8.0e9, 8.0e9 * 2 / 128, 2.5e6)
ctl = ElasticController(LMWorkloadModel("llama3-8b", "decode_32k", [stage], 256),
                        tokens_per_step=128, min_chips=8, max_chips=2048)
for load in (3e4, 3e4, 4.5e5, 4.5e5, 3e4, 3e4):
    ctl.observe(load)
assert ctl.events and ctl.events[0].chips_after > 8, ctl.events
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("served", server.decode_steps, "remeshed", [e.chips_after for e in ctl.events])
"""


_BLOCKED_MOE_MLA = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import repro_torch.models.moe
from repro_torch.configs import get_config
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import build_model
for arch in ("olmoe-1b-7b@smoke", "minicpm3-4b@smoke"):
    server = BatchedServer(arch, batch_slots=2, max_ctx=64, device="cpu")
    server.submit(Request(0, np.arange(4, 13, dtype=np.int32), 4))
    server.submit(Request(1, np.arange(4, 21, dtype=np.int32), 3))
    server.drain()
    assert sorted(len(r.tokens_out) for r in server.completed) == [3, 4], server.completed
model = build_model(get_config("jamba-1.5-large-398b@smoke"), device="cpu")
logits, _ = model.forward_prefill(torch.arange(4, 20).reshape(1, 16))
assert logits.shape[:2] == (1, 1) and bool(torch.isfinite(logits).all()), logits.shape
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("served", sorted(server.caches["b0_attn"]))
"""


def test_port_serves_moe_and_mla_with_jax_and_reference_blocked():
    proc = _run_blocked(_BLOCKED_MOE_MLA)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served ['c_kv', 'k_rope']" in proc.stdout


def test_moe_and_mla_models_count_only_kernel_launches():
    """The MLA latent norms and the MoE layer's norm take the plain
    versions on CPU tensors, which are not launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import add_rmsnorm, rmsnorm
    from repro_torch.models import build_model

    for arch in ("olmoe-1b-7b@smoke", "minicpm3-4b@smoke"):
        model = build_model(get_config(arch), device="cpu")
        before = (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches)
        logits, _ = model.forward_prefill(torch.arange(4, 12).reshape(1, 8))
        logits2, _ = model.forward_decode(torch.tensor([[5]]), model.cache_struct(1, 16), 8)
        assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
        assert (rmsnorm.launches, add_rmsnorm.launches, flash_attention.launches) == before


def test_port_serves_encoder_decoder_and_plans_cards_with_jax_and_reference_blocked():
    proc = _run_blocked(_BLOCKED_ENCDEC_AND_ELASTIC)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served" in proc.stdout and "remeshed" in proc.stdout


_BLOCKED_TRAIN = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import tempfile
import numpy as np
import repro_torch.optim
import repro_torch.data
import repro_torch.launch.train as train_mod
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.runtime import FailurePlan, run_with_restarts
base = dict(arch="xlstm-1.3b@smoke", steps=6, seq_len=16, global_batch=2, ckpt_every=2,
            log_every=0)
ref = train_mod.train(train_mod.TrainConfig(**base), device="cpu")
assert np.isfinite(ref["losses"]).all(), ref["losses"]
plan = FailurePlan(fail_after_steps=(3,))
seen = {}
with tempfile.TemporaryDirectory() as d:
    def run(attempt):
        return train_mod.train(train_mod.TrainConfig(**base, ckpt_dir=d), failure_plan=plan,
                               on_step=lambda s, l, m, dt: seen.__setitem__(s, l),
                               device="cpu")["start_step"]
    start, restarts = run_with_restarts(run)
assert (start, restarts) == (4, 1), (start, restarts)
assert [seen[s] for s in range(6)] == ref["losses"], (seen, ref["losses"])
server = BatchedServer("xlstm-1.3b@smoke", batch_slots=2, max_ctx=32, device="cpu")
server.submit(Request(0, np.arange(4, 13, dtype=np.int32), 4))
server.submit(Request(1, np.arange(4, 21, dtype=np.int32), 3))
server.submit(Request(2, np.arange(4, 30, dtype=np.int32), 2))
server.drain()
assert sorted(len(r.tokens_out) for r in server.completed) == [2, 3, 4], server.completed
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print("trained", ref["losses"][-1], "served", server.decode_steps)
"""


def test_port_trains_and_serves_xlstm_with_jax_and_reference_blocked():
    """``optim``, ``data`` and ``launch.train`` import with ``jax`` and
    ``repro`` blocked: xlstm-1.3b@smoke trains on the CPU, restarts from a
    checkpoint with the same losses, and serves."""
    proc = _run_blocked(_BLOCKED_TRAIN)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "trained" in proc.stdout and "served" in proc.stdout


def test_training_entry_points_default_to_the_card():
    """``build_state``, ``train`` and the backward library follow the
    device rule: no device means the card, which raises without one, and
    the backward kernel builds beside the forward."""
    from repro_torch.kernels.rmsnorm.ops import BACKWARD_LIBRARY, LIBRARY
    from repro_torch.launch.train import TrainConfig, build_state, train

    assert BACKWARD_LIBRARY.library_path().parent == LIBRARY.library_path().parent
    assert BACKWARD_LIBRARY.library_path().name.startswith("rmsnorm_bwd-")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tc = TrainConfig(arch="xlstm-1.3b@smoke", steps=1)
    for fn in (build_state, train):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(tc)
