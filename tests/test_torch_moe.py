"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same seeded numpy inputs, through
``apply_moe`` of both packages.

Tolerances: float32 out within 1e-5 of its scale (max |want|), aux within
1e-6 relative; the gradient of sum(out * g) + aux with respect to x, the
router and the expert weights within 1e-5 of each leaf's scale; bfloat16
out within 2e-2 of its scale and aux within 1e-6 relative (the router
runs in float32 in both: the same top-k). Routing is held exactly: the
top-k indices where router probabilities tie, and the (token, slot)
entries that drop at ``"factor"`` capacity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe

from _torch_parity import np_

B, S, D, E, K, F = 2, 16, 32, 8, 2, 24
ACTS = ("swiglu", "squared_relu", "gelu")


def _inputs(seed, act, dtype=np.float32, **moe_kw):
    """(numpy params, numpy x, port MoEConfig, reference MoEConfig)."""
    rng = np.random.default_rng(seed)
    p = {"router": (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32),
         "w_in": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(dtype),
         "w_out": (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(dtype)}
    if act == "swiglu":
        p["w_gate"] = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(dtype)
    x = rng.normal(size=(B, S, D)).astype(dtype)
    kw = dict(num_experts=E, top_k=K, d_ff_expert=F, **moe_kw)
    return p, x, MoEConfig(**kw), JMoE(**kw)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _reference(p, x, jcfg, act, mode):
    out, aux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg, act, None,
                                                   mode))(p, x)
    return np.asarray(out, np.float32), float(aux)


def _port(p, x, cfg, act, mode):
    out, aux = moe.apply_moe({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                             act, None, mode)
    return np_(out.float()), float(aux)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("mode", ["full", "factor"])
def test_apply_moe_matches_the_reference_float32(act, mode):
    p, x, cfg, jcfg = _inputs(1, act)
    want, aux_want = _reference(p, x, jcfg, act, mode)
    got, aux_got = _port(p, x, cfg, act, mode)
    assert got.shape == (B, S, D)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(aux_got, aux_want, rtol=1e-6)


def _reference_entries(p, x, jcfg, cap):
    """The reference's top-k (``jax.lax.top_k`` of its own router
    probabilities) and, from its flat (token, slot) stream, which entries
    fit their expert's queue of ``cap``."""
    x2 = jnp.asarray(x).reshape(-1, D).astype(jnp.float32)
    probs = jax.nn.softmax(x2 @ jnp.asarray(p["router"]), axis=-1)
    _, topi = jax.lax.top_k(probs, jcfg.top_k)
    flat_e = np.asarray(topi).reshape(-1)
    onehot = np.eye(E, dtype=np.int64)[flat_e]
    pos = np.cumsum(onehot, axis=0) - onehot
    return np.asarray(topi), pos[np.arange(len(flat_e)), flat_e] < cap


def _spy(monkeypatch):
    """Record the port's top-k indices and fitted entries."""
    seen = {}
    route, dispatch = moe._route, moe._dispatch

    def spy_route(*a):
        out = route(*a)
        seen["topi"] = np_(out[2])
        return out

    def spy_dispatch(*a):
        out = dispatch(*a)
        seen["mine"] = np_(out[1])
        return out

    monkeypatch.setattr(moe, "_route", spy_route)
    monkeypatch.setattr(moe, "_dispatch", spy_dispatch)
    return seen


@pytest.mark.parametrize("act", ACTS)
def test_the_same_entries_drop_at_factor_capacity(act, monkeypatch):
    """capacity_factor 0.5 at B x S = 32 tokens, top-2 of 8: C = 8 slots
    an expert for 64 entries, so the busier experts drop some."""
    p, x, cfg, jcfg = _inputs(2, act, capacity_factor=0.5)
    cap = moe._capacity(cfg, B * S, "factor")
    assert cap == jmoe._capacity(jcfg, B * S, "factor") == 8
    seen = _spy(monkeypatch)
    got, aux_got = _port(p, x, cfg, act, "factor")
    topi, kept = _reference_entries(p, x, jcfg, cap)
    np.testing.assert_array_equal(seen["topi"], topi)
    np.testing.assert_array_equal(seen["mine"], kept)
    assert 0 < (~kept).sum() < kept.size
    want, aux_want = _reference(p, x, jcfg, act, "factor")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(aux_got, aux_want, rtol=1e-6)


@pytest.mark.parametrize("mode", ["full", "factor"])
def test_router_ties_pick_the_lower_expert_first(mode, monkeypatch):
    """Experts 2..7 have zero router columns: their logits are exactly 0,
    so every token with negative logits for experts 0 and 1 meets a
    six-way tie, which ``jax.lax.top_k`` breaks toward the lower index."""
    p, x, cfg, jcfg = _inputs(3, "swiglu", capacity_factor=1.0)
    p["router"][:, 2:] = 0.0
    seen = _spy(monkeypatch)
    got, aux_got = _port(p, x, cfg, "swiglu", mode)
    topi, kept = _reference_entries(p, x, jcfg, moe._capacity(cfg, B * S,
                                                              mode))
    np.testing.assert_array_equal(seen["topi"], topi)
    np.testing.assert_array_equal(seen["mine"], kept)
    assert (topi == [2, 3]).all(axis=1).sum() >= 4  # ties decided
    want, aux_want = _reference(p, x, jcfg, "swiglu", mode)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(aux_got, aux_want, rtol=1e-6)


@pytest.mark.parametrize("E_,k,T,cap", [(8, 2, 33, 8), (32, 8, 512, 160),
                                        (4, 2, 64, 64)])
def test_queue_positions_are_the_one_hot_cumsum(E_, k, T, cap):
    """Each entry's queue position (by the stable sort) is the
    reference's one-hot cumsum down the flat (token, slot) stream."""
    rng = np.random.default_rng(E_ + T)
    topi = np.stack([rng.permutation(E_)[:k] for _ in range(T)])
    flat = topi.reshape(-1)
    onehot = np.eye(E_, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, axis=0) - onehot)[np.arange(flat.size), flat]
    _, mine, slot_c, pos_c = moe._dispatch(torch.as_tensor(topi), E_, cap, 0,
                                           E_)
    np.testing.assert_array_equal(np_(mine), pos < cap)
    np.testing.assert_array_equal(np_(pos_c), np.clip(pos, 0, cap - 1))
    np.testing.assert_array_equal(np_(slot_c), flat)


def test_a_dropped_entry_leaves_kept_ones_alone():
    """Every dropped entry adds an exact 0 at its clipped slot (the last
    queue position of its expert), which a kept entry may hold: the
    buffer equals the kept entries placed one by one."""
    p, x, cfg, _ = _inputs(2, "gelu", capacity_factor=0.5)
    xt = _t(x).reshape(-1, D)
    _, _, topi = moe._route(xt, _t(p["router"]), K)
    cap = moe._capacity(cfg, B * S, "factor")
    _, mine, slot_c, pos_c = moe._dispatch(topi, E, cap, 0, E)
    updates = xt.repeat_interleave(K, dim=0) * mine[:, None].float()
    buf = torch.zeros((E, cap, D)).index_put((slot_c, pos_c), updates,
                                             accumulate=True)
    want = torch.zeros((E, cap, D))
    full = 0
    for i in range(len(mine)):
        if mine[i]:
            want[slot_c[i], pos_c[i]] = updates[i]
            full += int(pos_c[i] == cap - 1)
    assert full > 0 and not bool(mine.all())
    assert torch.equal(buf, want)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("mode", ["full", "factor"])
def test_gradient_matches_jax_grad(act, mode):
    """d/d(x, router, w_*) of sum(out * g) + aux."""
    p, x, cfg, jcfg = _inputs(4, act, capacity_factor=0.5)
    g = np.random.default_rng(5).normal(size=(B, S, D)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.apply_moe(p, x, jcfg, act, None, mode)
        return jnp.sum(out * g) + aux

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    out, aux = moe.apply_moe(tp, tx, cfg, act, None, mode)
    (torch.sum(out * _t(g)) + aux).backward()
    pairs = [("x", tx.grad, jg_x)] + [(k, tp[k].grad, jg_p[k]) for k in p]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert np.abs(np_(got) - want).max() <= 1e-5 * max(
            np.abs(want).max(), 1e-30), name


@pytest.mark.parametrize("act", ACTS)
def test_apply_moe_matches_the_reference_bfloat16(act):
    import ml_dtypes

    p, x, cfg, jcfg = _inputs(6, act, dtype=ml_dtypes.bfloat16)
    assert p["router"].dtype == np.float32
    want, aux_want = _reference(p, x, jcfg, act, "full")
    got, aux_got = _port(p, x, cfg, act, "full")
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(aux_got, aux_want, rtol=1e-6)


def test_init_shapes_and_the_mesh_refusal():
    cfg = MoEConfig(num_experts=E, top_k=K, d_ff_expert=F)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, D, "swiglu",
                     "cpu", torch.bfloat16)
    assert p["router"].dtype == torch.float32 and p["router"].shape == (D, E)
    assert p["w_in"].shape == p["w_gate"].shape == (E, D, F)
    assert p["w_out"].shape == (E, F, D) and p["w_out"].dtype == torch.bfloat16
    assert "w_gate" not in moe.moe_init(torch.Generator(), cfg, D, "gelu",
                                        "meta", torch.float32)
    for t, mode in ((10, "factor"), (1000, "factor"), (7, "full")):
        assert moe._capacity(cfg, t, mode) == jmoe._capacity(
            JMoE(num_experts=E, top_k=K, d_ff_expert=F), t, mode)

    @dataclasses.dataclass
    class Meshed:
        mesh: object = "mesh"

    # a mesh context comes from sharding.rules.make_context; another
    # object that carries a mesh is refused
    with pytest.raises(TypeError, match="make_context"):
        moe.apply_moe(p, torch.zeros(1, 2, D, dtype=torch.bfloat16), cfg,
                      "swiglu", Meshed())
