"""The gradient of the port's ``flash_attention`` (``FlashAttention``, its
backward ``flash_attention_bwd``) on the CPU, where the forward is the
plain version.

Against ``jax.vjp`` of the reference's ``flash_attention`` (its Pallas
forward in interpret mode and its ``custom_vjp`` backward), with k and v
broadcast to the H query heads as ``repro/models/attention.py:280-285``
calls it, so the reference's dk and dv are summed over each group of
H / KH heads by the broadcast's transpose: causal, windowed, non-causal
and GQA cases at S a multiple of the query block, float32, within 2e-5.
Against a dense float64 oracle (autograd of the masked softmax
attention) where S is not a multiple of the block: within 2e-5 + 1e-4
relative. The reference's backward loops over ``Sq // block_q`` blocks
and drops the ragged tail's rows; ``test_reference_drops_the_ragged_tail``
asserts that gap, as ``test_torch_flash_ops.py::
test_noncausal_unaligned_keys_match_the_oracle`` does for its forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels.flash_attention import ops

TOL = dict(atol=2e-5, rtol=0)
ORACLE_TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(seed, B, S, H, KH, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, h, d)).astype(np.float32)
               for h in (H, KH, KH))
    do = rng.normal(size=(B, S, H, d)).astype(np.float32)
    return q, k, v, do


def _port_grads(q, k, v, do, scale, causal, window, block):
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = ops.flash_attention(*t, scale, causal, window, block, block)
    return [g.numpy() for g in torch.autograd.grad(o, t, torch.tensor(do))]


def _reference_grads(q, k, v, do, scale, causal, window, block):
    G = q.shape[2] // k.shape[2]

    def f(q, k, v):
        kb, vb = (jnp.repeat(t, G, axis=2) for t in (k, v))
        return j_flash(q, kb, vb, scale, causal, window, block, block, True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _oracle_grads(q, k, v, do, scale, causal, window):
    """Autograd of dense masked softmax attention in float64."""
    G = q.shape[2] // k.shape[2]
    t = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
         for a in (q, k, v)]
    qq, kk, vv = t
    kb, vb = (x.repeat_interleave(G, dim=2) for x in (kk, vv))
    s = torch.einsum("bqhd,bkhd->bhqk", qq, kb) * scale
    S, Sk = q.shape[1], k.shape[1]
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(Sk)[None, :]
    ok = torch.ones((S, Sk), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    p = torch.softmax(s.masked_fill(~ok, -1e30), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vb)
    grads = torch.autograd.grad(o, t, torch.tensor(do, dtype=torch.float64))
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("B,S,H,KH,d,causal,window,block", [
    (1, 64, 2, 2, 16, True, None, 32),
    (2, 96, 4, 2, 8, True, 40, 32),
    (1, 64, 4, 1, 16, True, 24, 16),
    (1, 64, 2, 2, 8, False, None, 32),
    (1, 128, 8, 2, 16, True, None, 128),
])
def test_gradient_matches_the_reference(B, S, H, KH, d, causal, window,
                                        block):
    q, k, v, do = _inputs(S + H, B, S, H, KH, d)
    scale = 1.0 / np.sqrt(d)
    got = _port_grads(q, k, v, do, scale, causal, window, block)
    want = _reference_grads(q, k, v, do, scale, causal, window, block)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("B,S,H,KH,d,causal,window,block", [
    (1, 600, 1, 1, 8, True, None, 512),
    (1, 100, 4, 2, 16, True, 30, 32),
    (2, 70, 2, 1, 8, False, None, 32),
])
def test_ragged_gradient_matches_the_oracle(B, S, H, KH, d, causal, window,
                                            block):
    q, k, v, do = _inputs(S, B, S, H, KH, d)
    scale = 0.3
    got = _port_grads(q, k, v, do, scale, causal, window, block)
    want = _oracle_grads(q, k, v, do, scale, causal, window)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **ORACLE_TOL, err_msg=f"d{name}")


def test_reference_drops_the_ragged_tail():
    """B = 1, S = 600, H = 1, d = 8, causal, scale 0.3, blocks of 512: the
    reference's backward gives rows 512-599 of dq no gradient (0 where
    the oracle's reach ~0.2) and dk, dv lose the tail's share (gaps of
    ~0.38 and ~0.33); the port covers them (above)."""
    q, k, v, do = _inputs(600, 1, 600, 1, 1, 8)
    want = _oracle_grads(q, k, v, do, 0.3, True, None)
    got = _reference_grads(q, k, v, do, 0.3, True, None, 512)
    assert np.all(got[0][:, 512:] == 0)
    assert np.abs(want[0][:, 512:]).max() > 0.1
    np.testing.assert_allclose(got[0][:, :512], want[0][:, :512],
                               **ORACLE_TOL)
    assert np.abs(got[1] - want[1]).max() > 0.1
    assert np.abs(got[2] - want[2]).max() > 0.1


def test_serving_goes_through_the_function_without_saving():
    """Under no_grad the Function's forward is the plain forward, bit for
    bit, and the output carries no graph."""
    q, k, v, _ = _inputs(1, 1, 40, 4, 2, 8)
    t = [torch.tensor(a) for a in (q, k, v)]
    with torch.no_grad():
        o = ops.flash_attention(*t, 0.25, True, 16)
    assert o.grad_fn is None
    assert torch.equal(o, ops.flash_attention_fwd(*t, 0.25, True, 16))
