"""The port's sharding plans against the reference's, entry for entry, and
the DTensor machinery that needs no second process: placements of a spec
on a mesh, the meshes themselves (on PyTorch's fake process group, which
needs no peers), ``shard_act`` without rules, and every kernel wrapper
refusing a DTensor.

- ``make_rules`` and ``cache_rules`` for every registered config × every
  entry of ``SHAPES`` × four plans; ``param_specs`` for every config ×
  plan (specs compared as tuples); ``cache_specs`` over every leaf of
  every arch's cache (the reference's ``test_decode_cache_specs_cover_
  every_leaf``, the port's cache built on the meta device);
  ``batch_specs`` for every config × shape; the logical axes and
  ``opt_state_specs`` for every config; ``shard_batch`` on a mesh.
"""
import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JaxP
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jshlib
from repro.launch.steps import opt_state_specs as jax_opt_state_specs
from repro.models import build_model as jax_build_model
from repro.models.common import param_logical_axes as jax_param_logical_axes
from repro.models.common import param_specs as jax_param_specs
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.data.pipeline import shard_batch
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_with_lse,
)
from repro_torch.kernels.rmsnorm import (
    add_rmsnorm,
    add_rmsnorm_backward,
    rmsnorm,
    rmsnorm_backward,
)
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_backward, ssm_scan_with_checkpoints
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import _meta_model, input_specs, opt_state_specs
from repro_torch.models.common import (
    axis_rules,
    logical_to_spec,
    param_logical_axes,
    param_specs,
    shard_act,
)
from repro_torch.models.transformer import decoder_defs

ARCHS = list_archs()
PLANS = {
    "default": dict(),
    "multi_pod": dict(multi_pod=True),
    "multi_pod_fsdp_over_pod": dict(multi_pod=True, fsdp_over_pod=True),
    "tp2_dp2": dict(tp=2, dp=2),
}


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _flat_specs(tree) -> dict:
    """Leaf specs by path, as tuples."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = tuple(v)

    walk(tree, "")
    return out


@pytest.fixture
def fake_world():
    """Initialises PyTorch's fake process group of a given size (no peers,
    no communication) and takes it down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n,
                                timeout=datetime.timedelta(seconds=60))

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------- rules


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_the_reference(arch, shape, plan):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    p, jp = shlib.PlanConfig(**PLANS[plan]), jshlib.PlanConfig(**PLANS[plan])
    s, js = SHAPES[shape], JAX_SHAPES[shape]
    assert shlib.make_rules(cfg, s, p) == jshlib.make_rules(jcfg, js, jp)
    assert shlib.cache_rules(cfg, s, p) == jshlib.cache_rules(jcfg, js, jp)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, plan):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    rules = shlib.make_rules(cfg, SHAPES["train_4k"], shlib.PlanConfig(**PLANS[plan]))
    got = _flat_specs(param_specs(decoder_defs(cfg), rules))
    want = _flat_specs(jax_param_specs(jax_build_model(jcfg).defs(), rules))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_and_opt_state_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    defs, jdefs = decoder_defs(cfg), jax_build_model(jcfg).defs()
    axes = {k: v for k, v in _walk(param_logical_axes(defs))}
    assert axes == {k: v for k, v in _walk(jax_param_logical_axes(jdefs))}
    rules = shlib.make_rules(cfg, SHAPES["train_4k"], shlib.PlanConfig())
    for use_master in (True, False):
        got = opt_state_specs(param_specs(defs, rules), use_master)
        want = jax_opt_state_specs(jax_param_specs(jdefs, rules), use_master)
        assert set(got) == set(want)
        assert tuple(got["step"]) == tuple(want["step"])
        for k in set(got) - {"step"}:
            assert _flat_specs(got[k]) == _flat_specs(want[k]), k


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_cover_every_leaf_and_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    plan = shlib.PlanConfig(tp=2, dp=2)
    rules = shlib.make_rules(cfg, SHAPES[shape], plan)
    crules = shlib.cache_rules(cfg, SHAPES[shape], plan)
    cache = _meta_model(cfg, torch.float32, "none").cache_struct(4, 64)
    got = _flat_specs(shlib.cache_specs(cache, cfg, rules, crules))
    assert set(got) == {path for path, _ in _walk(cache)}
    jcache = jax_build_model(jcfg).cache_struct(4, 64, abstract=True)
    want = jshlib.cache_specs(jcache, jcfg, rules, crules)
    leaves = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JaxP))[0]
    want = {".".join(p.key for p in path): tuple(spec) for path, spec in leaves}
    assert got == want
    for path, leaf in _walk(cache):
        assert len(got[path]) == leaf.ndim, path


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    rules = shlib.make_rules(cfg, SHAPES[shape], shlib.PlanConfig(tp=2, dp=2))
    batch = input_specs(cfg, SHAPES[shape])
    jbatch = jax_build_model(jcfg).input_specs(JAX_SHAPES[shape], abstract=True)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in jbatch.items()}
    want = jshlib.batch_specs(jbatch, rules)
    assert {k: tuple(v) for k, v in shlib.batch_specs(batch, rules).items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_specs_print_like_the_reference():
    spec = logical_to_spec(("act_batch", None, "embed_w"),
                           {"act_batch": ("pod", "data"), "embed_w": "data"})
    assert repr(spec) == repr(JaxP(("pod", "data"), None, "data"))
    assert repr(shlib.P()) == repr(JaxP())


# ----------------------------------------------------------------- placements


def test_placements_map_each_mesh_axis_to_its_tensor_dim(fake_world):
    fake_world(8)
    mesh = make_debug_mesh(2, 2, multi_pod=True, device_type="cpu")
    P = shlib.P
    assert shlib.placements(P(None, "model", "data"), mesh) == [Replicate(), Shard(2), Shard(1)]
    assert shlib.placements(P(), mesh) == [Replicate()] * 3
    # a tuple entry shards its dim over each of its axes, in mesh order
    assert shlib.placements(P(("pod", "data"), None), mesh) == [Shard(0), Shard(0), Replicate()]
    assert shlib.placements(P(None, ("data", "model")), mesh) == [Replicate(), Shard(1), Shard(1)]


@pytest.mark.parametrize("spec, match", [
    (("data", None, "data"), "shards both tensor dim 0 and tensor dim 2"),
    ((("pod", "data"), "data"), "shards both tensor dim 0 and tensor dim 1"),
    ((("data", "pod"), None), "not in the mesh's order"),
    (("expert", None), "is not one of"),
])
def test_placements_refuse_what_has_no_layout(fake_world, spec, match):
    fake_world(8)
    mesh = make_debug_mesh(2, 2, multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match=match):
        shlib.placements(shlib.P(*spec), mesh)


def test_meshes_take_the_reference_shapes_and_names(fake_world):
    fake_world(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh.mesh.shape == (2, 16, 16)
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    mesh = make_debug_mesh(4, 64, multi_pod=True, device_type="cpu")
    assert mesh.mesh.shape == (2, 4, 64)


def test_meshes_need_a_process_group_of_their_size(fake_world):
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_debug_mesh(device_type="cpu")
    fake_world(256)
    assert make_production_mesh(device_type="cpu").mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_debug_mesh(2, 2, device_type="cpu")


def test_shard_act_is_the_identity_without_rules_or_on_plain_tensors(fake_world):
    x = torch.randn(2, 3, 4)
    assert shard_act(x, ("act_batch", "act_seq", None)) is x
    with axis_rules({"act_batch": "data", "act_seq": "model"}):
        assert shard_act(x, ("act_batch", "act_seq", None)) is x
    fake_world(1)
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
    assert shard_act(dx, ("act_batch", "act_seq", None)) is dx


def test_shard_batch_shards_the_batch_dim_and_drops_the_step(fake_world):
    fake_world(1)
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    batch = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
             "labels": torch.ones(3, 4, dtype=torch.int32), "step": 7}
    out = shard_batch(batch, mesh)
    assert set(out) == {"tokens", "labels"}
    for k, t in out.items():
        assert isinstance(t, DTensor) and t.placements == (Shard(0), Replicate()), k
    assert torch.equal(out["tokens"].to_local(), torch.from_numpy(batch["tokens"]))
    with pytest.raises(ValueError, match="not in the mesh"):
        shard_batch(batch, mesh, batch_axes=("pod", "data"))


# ------------------------------------------------- kernels refuse a DTensor


def _wrapper_calls():
    x, g, dy = torch.randn(2, 3, 8), torch.ones(8), torch.randn(2, 3, 8)
    q = torch.randn(1, 4, 2, 8)
    dt, bm = torch.rand(1, 4, 8), torch.randn(1, 4, 4)
    a, h0 = -torch.ones(8, 4), torch.zeros(1, 8, 4)
    return {
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
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_dtensors(fake_world, name):
    fake_world(1)
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    fn, args = _wrapper_calls()[name]
    for i in range(len(args)):
        dargs = list(args)
        dargs[i] = DTensor.from_local(args[i], mesh, [Replicate(), Replicate()],
                                      run_check=False)
        with pytest.raises(TypeError, match="local_map"):
            fn(*dargs)
