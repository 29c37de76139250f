"""The port's LM layers, configs and prompt pipeline against the JAX
package on the same seeded numpy inputs: norms, embeddings, rotary
positions and the three MLP variants (float32 within 2e-5/2e-4, as
tests/test_attention_impls.py; bfloat16 within 2e-2), the config copies
and the token streams (equal)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.data.lm import LMDataPipeline as JPipeline
from repro.models import layers as JL
from repro_torch import configs as tcfgs
from repro_torch.data.lm import LMDataPipeline
from repro_torch.models import layers as TL

from _torch_parity import np_

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _both(a, dtype):
    """(jax array, torch tensor) of one numpy array in ``dtype``."""
    return (jnp.asarray(a, JNP[dtype]),
            torch.as_tensor(np.asarray(a, np.float32)).to(TORCH[dtype]))


def _close(j, t, dtype):
    np.testing.assert_allclose(np_(t.float()), np.asarray(j, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)) * 3 + 1
    p = {"scale": rng.normal(size=24), "bias": rng.normal(size=24)}
    if kind == "rmsnorm":
        del p["bias"]
    jp = {k: _both(v, dtype)[0] for k, v in p.items()}
    tp = {k: _both(v, dtype)[1] for k, v in p.items()}
    jx, tx = _both(x, dtype)
    out = TL.apply_norm(tp, tx, kind)
    assert out.dtype == TORCH[dtype]
    _close(JL.apply_norm(jp, jx, kind), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16))
    pos = np.arange(7) + 11
    jx, tx = _both(x, dtype)
    out = TL.rope(tx, torch.as_tensor(pos), 10000.0)
    assert out.dtype == TORCH[dtype]
    _close(JL.rope(jx, jnp.asarray(pos), 10000.0), out, dtype)


def test_apply_embed_with_positions():
    rng = np.random.default_rng(2)
    p = {"tokens": rng.normal(size=(50, 8)), "positions": rng.normal(
        size=(20, 8))}
    toks, pos = rng.integers(0, 50, (3, 6)), np.arange(6) + 4
    want = JL.apply_embed({k: jnp.asarray(v, jnp.float32)
                           for k, v in p.items()}, jnp.asarray(toks),
                          jnp.asarray(pos))
    got = TL.apply_embed({k: torch.as_tensor(v, dtype=torch.float32)
                          for k, v in p.items()}, torch.as_tensor(toks),
                         torch.as_tensor(pos))
    _close(want, got, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_apply_mlp(act, dtype):
    rng = np.random.default_rng(3)
    d, f = 16, 40
    p = {"w_in": rng.normal(size=(d, f)) / 4, "w_out": rng.normal(
        size=(f, d)) / 6, "w_gate": rng.normal(size=(d, f)) / 4}
    if act != "swiglu":
        del p["w_gate"]
    x = rng.normal(size=(2, 5, d))
    jx, tx = _both(x, dtype)
    want = JL.apply_mlp({k: _both(v, dtype)[0] for k, v in p.items()}, jx,
                        act)
    got = TL.apply_mlp({k: _both(v, dtype)[1] for k, v in p.items()}, tx,
                       act)
    _close(want, got, dtype)


def test_config_copies_equal_the_reference():
    """Every registered config, its reduced form and the shape cells are
    field for field the reference's."""
    assert tcfgs.list_archs() == jcfgs.list_archs()
    for arch in jcfgs.list_archs():
        j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert dataclasses.asdict(tcfgs.reduced(t, seq=64)) == \
            dataclasses.asdict(jcfgs.reduced(j, seq=64)), arch
        assert t.layer_kinds() == j.layer_kinds()
        assert [s[1:] for s in tcfgs.cells_for(t)] == \
            [s[1:] for s in jcfgs.cells_for(j)]
    assert [dataclasses.asdict(s) for s in tcfgs.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jcfgs.ALL_SHAPES]
    with pytest.raises(KeyError, match="unknown arch"):
        tcfgs.get_config("nope")


def test_lm_pipeline_gives_the_reference_stream():
    a, b = LMDataPipeline(97, 33, 3, seed=5), JPipeline(97, 33, 3, seed=5)
    for _ in range(2):
        x, y = a.next_batch(), b.next_batch()
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert a.state_dict() == b.state_dict() == {"step": 2}
