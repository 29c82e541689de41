"""The port's training loss and every gradient against the reference's
``jax.value_and_grad(model.loss_fn)``, for every architecture at smoke
widths: the case of ``tests/test_models.py::test_arch_smoke_train_step``
(batch 2, 64 positions, the reference's ``input_specs`` shapes), on the
reference's initial weights carried across by ``model_params_from_numpy``
and the same seeded numpy batch (tokens, labels and, where the model has a
frontend, its embeddings).

The port differentiates its CPU path, the kernels' plain versions, with
autograd; the reference differentiates plain jnp (with remat, which
changes memory, not numbers).  Tolerances: the loss and each aux value rel
1e-5; each gradient within 1e-4 of its leaf's largest reference entry
(float32 rounding of other summation orders, compounded through the
backward pass)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig, list_archs
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import build_model

SMOKE_TRAIN = ShapeConfig("smoke_train", seq_len=64, global_batch=2, kind="train")
LOSS_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4


def _batch(jm, cfg, seed=0):
    """The reference's train inputs for SMOKE_TRAIN, filled from numpy."""
    shapes = jm.input_specs(SMOKE_TRAIN, abstract=True)
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in shapes.items():
        if name == "frontend":
            out[name] = (0.02 * rng.standard_normal(spec.shape)).astype(np.float32)
        else:
            out[name] = rng.integers(0, cfg.vocab, size=spec.shape).astype(np.int32)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_every_gradient_match_reference(arch):
    jcfg = jax_get_config(arch + "@smoke")
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    batch = _batch(jm, jcfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    tm = build_model(get_config(arch + "@smoke"), device="cpu", seed=1)
    tm.load_state_dict(model_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                               tm.cfg))
    tm.trainable()
    loss, metrics = tm.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()

    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in metrics.items():
        assert float(v) == pytest.approx(float(jmetrics[k]), rel=LOSS_RTOL, abs=1e-7), k
    want = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jgrads), tm.cfg)
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(want)
    assert any(float(w.abs().max()) > 0 for w in want.values())
    for name, p in named.items():
        w = want[name]
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, w, rtol=0.0,
                                   atol=GRAD_ATOL_REL * float(w.abs().max()) + 1e-30,
                                   msg=lambda m: f"{arch} d{name}: {m}")
