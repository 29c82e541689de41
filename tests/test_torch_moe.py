"""The port's MoE feed-forward against the reference's ``moe_ffn`` on the
same numpy-seeded inputs and weights: the output ``y`` (rtol 1e-4, atol
1e-4·max|y|), the three aux values (rtol 1e-5), the capacity and the
router's expert ids equal.

The groups G = 1, 2 and 4 come from token counts that 16 does not divide
(G halves from ``moe_groups`` = 16 until it divides T).  Expert ids are
compared only where the router's margin (the k-th minus the (k+1)-th
probability) is above 1e-5, and every case here asserts that its smallest
margin is: the ids are decided by the inputs, not by float rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import ParamModule

RTOL, ATOL_REL = 1e-4, 1e-4
AUX_RTOL = 1e-5
MARGIN = 1e-5


def _cfgs(**changes):
    base = "mixtral-8x7b@smoke"
    return (dataclasses.replace(jax_get_config(base), **changes),
            dataclasses.replace(get_config(base), **changes))


def _weights(cfg, seed, router_std=1.0):
    """The reference's (d, E) router and (E, d, ff) / (E, ff, d) experts for
    one layer, seeded numpy; the router's std is ``router_std/sqrt(d)``."""
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.expert_ff, cfg.n_experts
    w = {"router": rng.normal(0, router_std / d ** 0.5, (d, E)),
         "w1": rng.normal(0, 1 / d ** 0.5, (E, d, ff)),
         "w3": rng.normal(0, 1 / d ** 0.5, (E, d, ff)),
         "w2": rng.normal(0, 1 / ff ** 0.5, (E, ff, d))}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _run_both(jcfg, tcfg, B, S, seed, router_std=1.0):
    w = _weights(jcfg, seed, router_std)
    x = np.random.default_rng(seed + 1).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    p = ParamModule({k: torch.from_numpy(v) for k, v in w.items()})
    ty, taux = tmoe.moe_ffn(p, torch.from_numpy(x), tcfg)
    return w, x, (np.array(jy), {k: float(v) for k, v in jaux.items()}), (ty, taux)


def _reference_routing(cfg, w, x):
    """lax.top_k's expert ids and the margins, grouped as the reference
    groups the tokens."""
    B, S, d = x.shape
    G = jmoe._moe_groups(cfg, B * S)
    xt = jnp.asarray(x.reshape(G, -1, d))
    probs = jax.nn.softmax((xt @ jnp.asarray(w["router"])).astype(jnp.float32), axis=-1)
    top, ids = jax.lax.top_k(probs, cfg.experts_per_token + 1)
    top = np.array(top)
    return np.array(ids)[..., :-1], top[..., -2] - top[..., -1], G


def _check(jcfg, tcfg, B, S, seed, router_std=1.0):
    w, x, (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, B, S, seed, router_std)
    torch.testing.assert_close(ty, torch.from_numpy(jy), rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(jy).max()))
    assert sorted(taux) == sorted(jaux)
    for k, v in jaux.items():
        assert float(taux[k]) == pytest.approx(v, rel=AUX_RTOL, abs=1e-7), k
    want_ids, margin, G = _reference_routing(jcfg, w, x)
    assert margin.min() > MARGIN, margin.min()
    p = ParamModule({k: torch.from_numpy(v) for k, v in w.items()})
    _, _, _, ids = tmoe.route(p, torch.from_numpy(x).reshape(G, -1, jcfg.d_model), tcfg)
    assert np.array_equal(ids.numpy(), want_ids)
    return jaux, G


@pytest.mark.parametrize("B,S,groups", [(1, 7, 1), (1, 10, 2), (2, 6, 4), (1, 36, 4)])
def test_moe_ffn_matches_reference_for_each_group_count(B, S, groups):
    jcfg, tcfg = _cfgs()
    assert tmoe._moe_groups(tcfg, B * S) == jmoe._moe_groups(jcfg, B * S) == groups
    _check(jcfg, tcfg, B, S, seed=B * 100 + S)


def test_moe_ffn_drops_tokens_as_the_reference_does():
    """A capacity factor of 0.5 over 40 tokens: 8 groups of 5, each expert
    one slot a group (round(5·2/4·0.5) = 1) for about 2.5 choices, so
    more than a tenth of the choices are dropped."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    jaux, G = _check(jcfg, tcfg, 1, 40, seed=3)
    assert G == 8 and jaux["dropped_frac"] > 0.1


@pytest.mark.parametrize("Tg,k,E,cf,want", [(4, 2, 4, 1.25, 2), (6, 2, 4, 1.5, 4),
                                            (7, 2, 4, 1.0, 4), (1, 2, 4, 1.0, 1),
                                            (10, 2, 8, 1.0, 2)])
def test_capacity_rounds_half_to_even_as_the_reference_does(Tg, k, E, cf, want):
    """Tg·k/E·cf lands exactly on 2.5, 4.5, 3.5, 0.5 and 2.5: Python's round
    takes the even neighbour (2, 4, 4, 0 raised to the floor of 1, 2)."""
    jcfg, tcfg = _cfgs(experts_per_token=k, n_experts=E, capacity_factor=cf, moe_groups=1)
    assert tmoe.capacity(tcfg, Tg) == want
    # the reference computes the capacity inline: outputs and dropped_frac
    # equal at the same Tg
    jaux, G = _check(jcfg, tcfg, 1, Tg, seed=Tg * 10 + k)
    assert G == 1


def test_capacity_exactly_on_a_half_drops_as_the_reference_does():
    """Tg = 4, k = 2, E = 4, cf = 1.25: the capacity is round(2.5) = 2 slots;
    a router that sends every token to experts 0 and 1 fills them and
    drops half the choices in both packages."""
    jcfg, tcfg = _cfgs(n_experts=4, experts_per_token=2, capacity_factor=1.25, moe_groups=1)
    w = _weights(jcfg, 9)
    x = np.abs(np.random.default_rng(10).normal(size=(1, 4, jcfg.d_model))).astype(np.float32)
    w["router"][:, :2] = np.abs(w["router"][:, :2]) + 0.5
    w["router"][:, 2:] = -np.abs(w["router"][:, 2:]) - 0.5
    jy, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jcfg)
    p = ParamModule({k: torch.from_numpy(v) for k, v in w.items()})
    ty, taux = tmoe.moe_ffn(p, torch.from_numpy(x), tcfg)
    assert float(jaux["dropped_frac"]) == float(taux["dropped_frac"]) == 0.5
    jy = np.array(jy)
    torch.testing.assert_close(ty, torch.from_numpy(jy), rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(jy).max()))


def test_equal_probabilities_pick_the_lower_expert_first():
    """A zero router gives every expert the same probability: ``lax.top_k``
    returns experts 0..k-1 in order, and so must the port."""
    jcfg, tcfg = _cfgs(n_experts=8, experts_per_token=3)
    w = _weights(jcfg, 4)
    w["router"][:] = 0.0
    x = np.random.default_rng(5).normal(size=(1, 6, jcfg.d_model)).astype(np.float32)
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x[0] @ w["router"]), axis=-1), 3)
    p = ParamModule({k: torch.from_numpy(v) for k, v in w.items()})
    _, _, gates, ids = tmoe.route(p, torch.from_numpy(x[0])[None], tcfg)
    assert np.array_equal(ids[0].numpy(), np.array(jids))
    assert np.array_equal(ids[0].numpy(), np.tile([0, 1, 2], (6, 1)))
    torch.testing.assert_close(gates, torch.full_like(gates, 1 / 3))
    jy, _ = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jcfg)
    ty, _ = tmoe.moe_ffn(p, torch.from_numpy(x), tcfg)
    torch.testing.assert_close(ty, torch.from_numpy(np.array(jy)), rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(np.array(jy)).max()))


def test_moe_ffn_without_aux_returns_the_same_output():
    _, tcfg = _cfgs()
    w = _weights(tcfg, 6)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 5, tcfg.d_model))
                         .astype(np.float32))
    p = ParamModule({k: torch.from_numpy(v) for k, v in w.items()})
    y, aux = tmoe.moe_ffn(p, x, tcfg)
    y2, none = tmoe.moe_ffn(p, x, tcfg, need_aux=False)
    assert none is None and sorted(aux) == ["dropped_frac", "lb_loss", "z_loss"]
    assert torch.equal(y, y2)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b@smoke", "jamba-1.5-large-398b@smoke"])
def test_moe_ffn_matches_reference_at_the_smoke_widths(arch):
    """olmoe@smoke (8 experts, top-2) and jamba@smoke (4, top-2) at the
    router scale the models initialise (0.1/sqrt(d)) would sit near ties;
    a unit-scale router keeps the margins above 1e-5."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    _check(jcfg, tcfg, 2, 9, seed=len(arch))
