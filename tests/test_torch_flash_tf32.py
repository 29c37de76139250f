"""The float32 forward kernel's arithmetic on the CPU:
``ref.flash_attention_tf32x3_plain`` (q k^T and p v by 3xTF32, each
operand split into two TF32 terms, as ``csrc/flash_attention.cu``'s
``flash_fwd_tf32x3`` forms them on the tensor cores) against

- ``ref.flash_attention_plain``, the CPU route, within 2e-5 (the float32
  kernel's check on the card);
- the JAX package's Pallas ``flash_attention`` in interpret mode, fed the
  repeated kv heads, within 2e-5 absolute and relative (as
  tests/test_torch_flash_ops.py holds the CPU route);
- a float64 oracle: at most 2x ``flash_attention_plain``'s distance from
  it (the "<= 2x that route's error" rule of PERF.md §2).

The cases cover causal and non-causal attention, windows ending inside a
64-key tile, G = H / KH = 1, 2 and 4, lengths that are not multiples of
64, and d = 8, 64, 80 and 128. A non-causal case keeps its length a
multiple of the Pallas op's 32-key blocks: past that the op lets its
zero-padded keys into the softmax (ROADMAP.md §3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels.flash_attention import ref as fa_ref

from _torch_parity import np_

CASES = [  # (B, S, H, KH, d, causal, window)
    (2, 150, 4, 4, 8, True, None),    # G 1, d 8, a ragged causal tail
    (1, 333, 4, 2, 64, True, 70),     # G 2, a window ending inside a tile
    (1, 160, 8, 2, 80, False, None),  # G 4, non-causal, S not a 64-multiple
    (1, 130, 8, 2, 128, True, None),  # G 4, d 128, a ragged causal tail
    (2, 96, 4, 4, 128, False, 40),    # non-causal, a window inside a tile
    (1, 100, 4, 1, 64, True, 20),     # G 4, a narrow window
]


def _inputs(B, S, H, KH, d):
    rng = np.random.default_rng(S * d + H)
    return [rng.normal(size=(B, S, h, d)) for h in (H, KH, KH)]


def _torch(*arrays):
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrays]


def _oracle64(q, k, v, scale, causal, window):
    """Dense attention in float64 (numpy inputs), the kv heads repeated."""
    G = q.shape[2] // k.shape[2]
    qd = torch.as_tensor(q, dtype=torch.float64).transpose(1, 2)
    kd, vd = (torch.as_tensor(np.repeat(a, G, axis=2),
                              dtype=torch.float64).transpose(1, 2)
              for a in (k, v))
    s = (qd @ kd.transpose(2, 3)) * scale
    ok = fa_ref.mask(q.shape[1], k.shape[1], causal, window, "cpu")
    return (torch.softmax(s.masked_fill(~ok, -1e30), -1) @ vd).transpose(1, 2)


@pytest.mark.parametrize("B,S,H,KH,d,causal,window", CASES)
def test_tf32x3_plain_matches_the_float32_route(B, S, H, KH, d, causal,
                                                window):
    """Within 2e-5 of ``flash_attention_plain`` (float32 products)."""
    q, k, v = _torch(*_inputs(B, S, H, KH, d))
    got = fa_ref.flash_attention_tf32x3_plain(q, k, v, d ** -0.5, causal,
                                              window)
    want = fa_ref.flash_attention_plain(q, k, v, d ** -0.5, causal, window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("B,S,H,KH,d,causal,window", CASES)
def test_tf32x3_plain_matches_the_pallas_op(B, S, H, KH, d, causal, window):
    """Within 2e-5 (absolute and relative) of the JAX package's Pallas
    flash_attention in interpret mode, float32, 32 x 32 blocks."""
    q, k, v = _inputs(B, S, H, KH, d)
    rep = lambda a: np.repeat(a, H // KH, axis=2)  # noqa: E731
    want = j_flash(*(jnp.asarray(a, jnp.float32) for a in (q, rep(k),
                                                            rep(v))),
                   d ** -0.5, causal, window, 32, 32, True)
    got = fa_ref.flash_attention_tf32x3_plain(*_torch(q, k, v), d ** -0.5,
                                              causal, window)
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,H,KH,d,causal,window", CASES)
def test_tf32x3_plain_within_twice_the_float32_route_of_float64(
        B, S, H, KH, d, causal, window):
    """The 3xTF32 products' largest distance from float64 is at most 2x
    that of the float32 route (``flash_attention_plain``)."""
    q, k, v = _inputs(B, S, H, KH, d)
    oracle = _oracle64(q, k, v, d ** -0.5, causal, window)
    tq, tk, tv = _torch(q, k, v)
    e3 = float((fa_ref.flash_attention_tf32x3_plain(
        tq, tk, tv, d ** -0.5, causal, window).double() - oracle).abs().max())
    e32 = float((fa_ref.flash_attention_plain(
        tq, tk, tv, d ** -0.5, causal, window).double() - oracle).abs().max())
    assert e3 <= 2 * e32, (e3, e32)
