"""The port's attention module against the JAX package on the same seeded
numpy inputs and parameters: the full, chunked, banded-window and flash
lowerings, the decode step (dense and flash_decode), the prefill cache
cut to the window, and the decode slot of a cache without a window
(float32 within 2e-5/2e-4, as tests/test_attention_impls.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAcfg
from repro.models import attention as JA
from repro_torch.configs.base import AttentionConfig
from repro_torch.models import attention as TA

from _torch_parity import np_

TOL = dict(atol=2e-5, rtol=2e-4)


def _setup(S=64, B=2, H=4, K=2, hd=16, d=32, window=None, causal=True,
           seed=0):
    kw = dict(n_heads=H, n_kv_heads=K, head_dim=hd, causal=causal,
              sliding_window=window)
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(d)
    p = {"wq": rng.normal(size=(d, H, hd)) * s,
         "wk": rng.normal(size=(d, K, hd)) * s,
         "wv": rng.normal(size=(d, K, hd)) * s,
         "wo": rng.normal(size=(H, hd, d)) / np.sqrt(H * hd)}
    x = rng.normal(size=(B, S, d))
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}
    return (JAcfg(**kw), AttentionConfig(**kw), jp, tp,
            jnp.asarray(x, jnp.float32), torch.as_tensor(x,
                                                         dtype=torch.float32))


def _close(t, j):
    np.testing.assert_allclose(np_(t), np.asarray(j), **TOL)


@pytest.mark.parametrize("impl,window,causal",
                         [("full", None, True), ("full", 24, True),
                          ("full", None, False), ("chunked", 24, True),
                          ("swa", 16, True), ("flash", 24, True),
                          ("flash", None, False)])
def test_prefill_lowerings_match_the_reference(impl, window, causal):
    ja, ta, jp, tp, jx, tx = _setup(window=window, causal=causal)
    pos = np.arange(jx.shape[1])
    want, jc = JA.apply_attention(jp, jx, ja, jnp.asarray(pos), "prefill",
                                  impl=impl, q_chunk=16)
    got, tc = TA.apply_attention(tp, tx, ta, torch.as_tensor(pos), "prefill",
                                 impl=impl, q_chunk=16)
    _close(got, want)
    if window:  # the prefill cache keeps the last `window` positions
        assert tc.k.shape[1] == window
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


@pytest.mark.parametrize("impl", ["full", "flash"])
@pytest.mark.parametrize("window", [None, 24])
def test_decode_steps_match_the_reference(window, impl):
    """Three decode steps after a prefill: outputs and caches, the
    window's ring slot and the non-SWA slot (clip(pos, 0, T - 1): the last
    slot, every step) as the reference writes them."""
    ja, ta, jp, tp, jx, tx = _setup(S=40, window=window)
    pos = np.arange(40)
    _, jc = JA.apply_attention(jp, jx, ja, jnp.asarray(pos), "prefill",
                               impl="full")
    _, tc = TA.apply_attention(tp, tx, ta, torch.as_tensor(pos), "prefill",
                               impl="full")
    rng = np.random.default_rng(7)
    for i in range(3):
        xn = rng.normal(size=(2, 1, 32))
        want, jc = JA.apply_attention(
            jp, jnp.asarray(xn, jnp.float32), ja, jnp.asarray([40 + i]),
            "decode", cache=jc, cache_pos=jnp.asarray(40 + i))
        got, tc = TA.apply_attention(
            tp, torch.as_tensor(xn, dtype=torch.float32), ta,
            torch.as_tensor([40 + i]), "decode", cache=tc, cache_pos=40 + i,
            impl=impl)
        _close(got, want)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    T = tc.k.shape[1]
    if window is None:  # every step overwrote the last slot only
        before = TA.apply_attention(tp, tx, ta, torch.as_tensor(pos),
                                    "prefill", impl="full")[1]
        assert torch.equal(tc.k[:, :T - 1], before.k[:, :T - 1])
        assert not torch.equal(tc.k[:, T - 1], before.k[:, T - 1])


def test_decode_attention_masks_like_the_reference():
    """valid_len below the cache length, with a window, masks entries."""
    ja, ta, *_ = _setup(window=8)
    rng = np.random.default_rng(4)
    q, kn, vn = (rng.normal(size=(2, 1, n, 16)) for n in (4, 2, 2))
    kc, vc = (rng.normal(size=(2, 20, 2, 16)) for _ in range(2))
    want = JA.decode_attention(*(jnp.asarray(a, jnp.float32) for a in (q,)),
                               JA.KVCache(jnp.asarray(kc, jnp.float32),
                                          jnp.asarray(vc, jnp.float32)),
                               jnp.asarray(kn, jnp.float32),
                               jnp.asarray(vn, jnp.float32), ja,
                               valid_len=jnp.asarray(15))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    got = TA.decode_attention(t(q), TA.KVCache(t(kc), t(vc)), t(kn), t(vn),
                              ta, valid_len=15)
    _close(got, want)
