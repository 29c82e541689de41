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


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "capacity" in proc.stdout


def test_port_sources_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
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
