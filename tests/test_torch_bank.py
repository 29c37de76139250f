"""Port filter bank against the JAX package on the same random banks:
predict/update (pass-through and the None recompute), spawn packing and
ids, prune, and the IMM predict/update (atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jb
from repro.core import filters as jf
from repro_torch.core import bank as tb
from repro_torch.convert import bank_from_numpy
from repro_torch.core import filters as tf

from _torch_inputs import spd
from _torch_parity import np_, t32

ATOL = 1e-5


def _random_bank(kind, seed, C=12):
    rng = np.random.default_rng(seed)
    jm, tm = jf.get_filter(kind), tf.get_filter(kind)
    n = jm.n
    x = rng.normal(size=(C, n)).astype(np.float32)
    P = spd(rng, (C,), n)
    active = rng.random(C) < 0.6
    hits = rng.integers(0, 5, C).astype(np.int32)
    misses = rng.integers(0, 7, C).astype(np.int32)
    age = rng.integers(0, 9, C).astype(np.int32)
    ids = np.where(active, np.arange(C), -1).astype(np.int32)
    fields = dict(x=x, P=P, active=active, hits=hits, misses=misses, age=age,
                  track_id=ids, next_id=np.int32(C))
    jbank = jb.BankState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jm, tm, jbank, bank_from_numpy(fields, device="cpu"), rng


def _assert_bank(tbank, jbank, atol=ATOL):
    for name in jbank._fields:
        a, b = np.asarray(getattr(jbank, name)), np_(getattr(tbank, name))
        assert b.dtype == a.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kind", ["lkf", "ekf", "cv9"])
@pytest.mark.parametrize("recompute", [False, True])
def test_predict_update_bank_match(kind, recompute):
    jm, tm, jbank, tbank, rng = _random_bank(kind, 3)
    jp, jzp, jS, jSi, jPHt = jb.predict_bank(jm, jbank)
    tp, tzp, tS, tSi, tPHt = tb.predict_bank(tm, tbank)
    _assert_bank(tp, jp)
    for a, b in ((jzp, tzp), (jS, tS), (jSi, tSi), (jPHt, tPHt)):
        np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL)
    M = 5
    z = rng.normal(size=(M, jm.m)).astype(np.float32)
    assoc = rng.integers(-1, M, jbank.x.shape[0]).astype(np.int32)
    kw_j = {} if recompute else dict(PHt=jPHt, Sinv=jSi)
    kw_t = {} if recompute else dict(PHt=tPHt, Sinv=tSi)
    ju = jb.update_bank(jm, jp, jnp.asarray(z), jnp.asarray(assoc), **kw_j)
    tu = tb.update_bank(tm, tp, t32(z), torch.as_tensor(assoc), **kw_t)
    _assert_bank(tu, ju)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spawn_and_prune_match(seed):
    jm, tm, jbank, tbank, rng = _random_bank("lkf", seed, C=10)
    M = 8
    z = rng.normal(size=(M, jm.m)).astype(np.float32)
    unassigned = rng.random(M) < 0.6
    js = jb.spawn_tracks(jm, jbank, jnp.asarray(z), jnp.asarray(unassigned))
    ts = tb.spawn_tracks(tm, tbank, t32(z), torch.as_tensor(unassigned))
    _assert_bank(ts, js, atol=0)
    jp = jb.prune_bank(js, 4)
    tp = tb.prune_bank(ts, 4)
    _assert_bank(tp, jp, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_lifecycle_counters_match(seed):
    jm, tm, jbank, tbank, rng = _random_bank("ekf", seed)
    assoc = rng.integers(-1, 4, jbank.x.shape[0]).astype(np.int32)
    for a, b in zip(jb.lifecycle_counters(jbank, jnp.asarray(assoc)),
                    tb.lifecycle_counters(tbank, torch.as_tensor(assoc))):
        np.testing.assert_array_equal(np_(b), np.asarray(a))


@pytest.mark.parametrize("recompute", [False, True])
def test_imm_predict_update_match(recompute):
    rng = np.random.default_rng(9)
    jimm, timm = jf.make_imm(), tf.make_imm()
    K, C, n, m = jimm.K, 10, jimm.n, jimm.m
    fields = dict(
        x=rng.normal(size=(K, C, n)).astype(np.float32),
        P=spd(rng, (K, C), n),
        mu=rng.dirichlet(np.ones(K), size=C).astype(np.float32),
        active=rng.random(C) < 0.7,
        hits=np.ones(C, np.int32), misses=np.zeros(C, np.int32),
        age=np.ones(C, np.int32), track_id=np.arange(C, dtype=np.int32),
        next_id=np.int32(C))
    jbank = jb.IMMBankState(**{k: jnp.asarray(v) for k, v in fields.items()})
    tbank = bank_from_numpy(fields, device="cpu")
    jout = jb.predict_imm_bank(jimm, jbank)
    tout = tb.predict_imm_bank(timm, tbank)
    _assert_bank(tout[0], jout[0])
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL)
    z = rng.normal(size=(6, m)).astype(np.float32)
    assoc = rng.integers(-1, 6, C).astype(np.int32)
    jp, tp = jout[0], tout[0]
    if recompute:
        ju = jb.update_imm_bank(jimm, jp, jnp.asarray(z), jnp.asarray(assoc))
        tu = tb.update_imm_bank(timm, tp, t32(z), torch.as_tensor(assoc))
    else:
        names = ("z_pred", "S", "Sinv", "PHt", "cbar")
        ju = jb.update_imm_bank(jimm, jp, jnp.asarray(z), jnp.asarray(assoc),
                                **dict(zip(names, jout[1:])))
        tu = tb.update_imm_bank(timm, tp, t32(z), torch.as_tensor(assoc),
                                **dict(zip(names, tout[1:])))
    _assert_bank(tu, ju)


def test_spawn_imm_and_init_match():
    jimm, timm = jf.make_imm(), tf.make_imm()
    jbank = jb.init_imm_bank(jimm, 8)
    tbank = tb.init_imm_bank(timm, 8, device="cpu")
    _assert_bank(tbank, jbank, atol=0)
    _assert_bank(tb.init_bank(tf.get_filter("ekf"), 8, device="cpu"),
                 jb.init_bank(jf.get_filter("ekf"), 8), atol=0)
    z = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    un = np.array([True, False, True, True, False])
    js = jb.spawn_imm_tracks(jimm, jbank, jnp.asarray(z), jnp.asarray(un))
    ts = tb.spawn_imm_tracks(timm, tbank, t32(z), torch.as_tensor(un))
    _assert_bank(ts, js, atol=0)
    assert int(ts.next_id) == 3
