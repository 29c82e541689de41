"""The port's gradient compression against the reference's, in one process:
top-k with error feedback bit for bit (values, indices, residual) on
seeded inputs without ties; int8 quantization fed the reference's own
noise, and dequantization, bit for bit; and the port's own noise from a
``torch.Generator`` (the reference's distribution, other numbers).  The
collectives over four ranks are in ``test_torch_distributed.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import Int8Config as JaxInt8Config
from repro.optim.compression import TopKConfig as JaxTopKConfig
from repro.optim.compression import int8_dequantize as jax_int8_dequantize
from repro.optim.compression import int8_quantize as jax_int8_quantize
from repro.optim.compression import topk_compress as jax_topk_compress
from repro.optim.compression import topk_decompress as jax_topk_decompress
from repro_torch.optim.compression import (
    Int8Config,
    TopKConfig,
    _int8_quantize_with_noise,
    int8_dequantize,
    int8_quantize,
    topk_compress,
    topk_decompress,
)

TOPK_CASES = {
    "matrix-1pct": ((64, 48), dict(density=0.01)),
    "vector-min_k": ((100,), dict(density=0.01, min_k=16)),
    "tensor-half": ((4, 8, 16), dict(density=0.5)),
    "all": ((7, 3), dict(density=1.0)),
}
INT8_CASES = {"padded": ((3000,), 2048), "whole-blocks": ((64, 64), 1024),
              "small-block": ((5, 7, 9), 16)}


def _seeded(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_compress_and_decompress_equal_the_reference(case):
    shape, kw = TOPK_CASES[case]
    g, err = _seeded(shape, 1), 0.1 * _seeded(shape, 2)
    assert len(np.unique(np.abs(g + err))) == g.size      # no ties
    (vals, idx), new_err = topk_compress(torch.from_numpy(g), torch.from_numpy(err),
                                         TopKConfig(**kw))
    (jvals, jidx), jnew = jax_topk_compress(jnp.asarray(g), jnp.asarray(err), JaxTopKConfig(**kw))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jnew))
    dense = topk_decompress((vals, idx), shape)
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jax_topk_decompress((jvals, jidx), shape)))
    # nothing is lost: kept entries plus the residual are g + err
    np.testing.assert_array_equal((dense + new_err).numpy(), g + err)


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_with_the_reference_noise_equals_the_reference(case):
    shape, block = INT8_CASES[case]
    g = _seeded(shape, 3)
    key = jax.random.PRNGKey(4)
    q_ref, s_ref = jax_int8_quantize(jnp.asarray(g), key, JaxInt8Config(block=block))
    n_blocks = -(-g.size // block)
    noise = np.array(jax.random.uniform(key, (n_blocks, block)) - 0.5)
    q, s = _int8_quantize_with_noise(torch.from_numpy(g), torch.from_numpy(noise),
                                     Int8Config(block=block))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(int8_dequantize(q, s, shape).numpy(),
                                  np.asarray(jax_int8_dequantize(q_ref, s_ref, shape)))


def test_int8_noise_from_a_generator():
    """The port's own noise: the same generator seed gives the same bits,
    another seed other bits; every value rounds to a neighbour (within one
    scale step of g)."""
    g = torch.from_numpy(_seeded((3000,), 5))
    cfg = Int8Config(block=512)
    q1, s1 = int8_quantize(g, torch.Generator().manual_seed(0), cfg)
    q2, _ = int8_quantize(g, torch.Generator().manual_seed(0), cfg)
    q3, _ = int8_quantize(g, torch.Generator().manual_seed(1), cfg)
    assert torch.equal(q1, q2) and not torch.equal(q1, q3)
    back = int8_dequantize(q1, s1, g.shape)
    step = s1.expand(-1, cfg.block).reshape(-1)[: g.numel()]
    assert bool(((back - g).abs() <= step * (1 + 1e-6)).all())
