"""The port's flash_attention and flash_decode ops (their plain versions on
the CPU) against the JAX package's Pallas ops in interpret mode, as
tests/test_kernels.py runs them: flash_attention within 2e-5 (float32)
and 2e-2 (bfloat16), flash_decode and lse_merge within 1e-5/1e-4. Also
the kv heads read in place (GQA) and the non-causal unaligned case,
which the port masks by the true key length, against the reference's
oracle ``attention_ref``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_oracle
from repro.kernels.flash_decode.kernel import flash_decode_partial as j_part
from repro.kernels.flash_decode.ops import flash_decode as j_decode
from repro.kernels.flash_decode.ops import lse_merge as j_merge
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_decode import ops as fd

from _torch_parity import np_

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype="float32"):
    return (jnp.asarray(a, JNP[dtype]),
            torch.as_tensor(np.asarray(a, np.float32)).to(TORCH[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 32)])
def test_flash_attention_matches_the_pallas_op(dtype, causal, window):
    rng = np.random.default_rng(0)
    B, S, H, d = 2, 128, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng.normal(size=(B, S, H, d)),
                                          dtype) for _ in range(3))
    want = j_flash(jq, jk, jv, d ** -0.5, causal, window, 32, 32, True)
    fa.reset_launches()
    got = fa.flash_attention(tq, tk, tv, d ** -0.5, causal, window, 32, 32)
    assert fa.LAUNCHES["flash_attention"] == 0  # the CPU runs the plain one
    assert got.dtype == TORCH[dtype]
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(np_(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_flash_attention_reads_kv_heads_in_place():
    """k/v at KH = H / 4 heads equal the reference fed the repeated heads."""
    rng = np.random.default_rng(1)
    B, S, H, KH, d = 1, 96, 8, 2, 16
    q = rng.normal(size=(B, S, H, d))
    k, v = (rng.normal(size=(B, S, KH, d)) for _ in range(2))
    rep = lambda a: np.repeat(a, H // KH, axis=2)  # noqa: E731
    want = j_flash(*(jnp.asarray(a, jnp.float32) for a in (q, rep(k),
                                                            rep(v))),
                   0.25, True, 40, 32, 32, True)
    got = fa.flash_attention(*(torch.as_tensor(a, dtype=torch.float32)
                               for a in (q, k, v)), 0.25, True, 40)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_noncausal_unaligned_keys_match_the_oracle():
    """Sk = 100, not a multiple of the reference's 32-key blocks: the port
    masks by the true length and matches ``attention_ref``; the Pallas op
    lets its zero-padded keys into the softmax (ROADMAP.md §3)."""
    rng = np.random.default_rng(2)
    B, S, H, d = 1, 100, 2, 16
    q, k, v = (rng.normal(size=(B, S, H, d)) for _ in range(3))
    bh = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, d)  # noqa
    oracle = np.asarray(j_oracle(*(jnp.asarray(bh(a), jnp.float32)
                                   for a in (q, k, v)),
                                 scale=0.25, causal=False))
    got = fa.flash_attention(*(torch.as_tensor(a, dtype=torch.float32)
                               for a in (q, k, v)), 0.25, False, None, 32,
                             32)
    np.testing.assert_allclose(bh(np_(got)), oracle, atol=2e-5, rtol=2e-5)
    plain_ref = fa_ref.attention_ref(*(torch.as_tensor(bh(a),
                                                       dtype=torch.float32)
                                       for a in (q, k, v)), scale=0.25,
                                     causal=False)
    np.testing.assert_allclose(np_(plain_ref), oracle, atol=2e-5, rtol=2e-5)
    pallas = np.asarray(j_flash(*(jnp.asarray(a, jnp.float32)
                                  for a in (q, k, v)), 0.25, False, None, 32,
                                32, True))
    assert np.abs(bh(pallas) - oracle).max() > 1e-2  # the reference defect


@pytest.mark.parametrize("K", [1, 2, 4])
def test_flash_decode_matches_the_pallas_op(K):
    rng = np.random.default_rng(K)
    B, T, H, d, bk = 2, 128, 4, 32, 32
    (jq, tq), (jkc, tkc), (jvc, tvc), (jkn, tkn), (jvn, tvn) = (
        _both(rng.normal(size=s)) for s in ((B, 1, H, d), (B, T, K, d),
                                            (B, T, K, d), (B, 1, K, d),
                                            (B, 1, K, d)))
    want = j_decode(jq, jkc, jvc, jkn, jvn, scale=d ** -0.5, block_k=bk)
    got = fd.flash_decode(tq, tkc, tvc, tkn, tvn, scale=d ** -0.5,
                          block_k=bk)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="block_k"):
        fd.flash_decode(tq, tkc, tvc, tkn, tvn, scale=1.0, block_k=48)


def test_partials_and_lse_merge_match_the_reference():
    rng = np.random.default_rng(9)
    B, H, d, T = 1, 2, 16, 128
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng.normal(size=s)) for s in (
        (B, H, d), (B, T, H, d), (B, T, H, d)))
    whole = j_part(jq, jk, jv, scale=0.25, block_k=32)
    parts_j = [j_part(jq, jk[:, s], jv[:, s], scale=0.25, block_k=32)
               for s in (slice(0, 64), slice(64, None))]
    parts_t = [fd.flash_decode_partial(tq, tk[:, s], tv[:, s], scale=0.25,
                                       block_k=32)
               for s in (slice(0, 64), slice(64, None))]
    for pj, pt in zip(parts_j, parts_t):
        np.testing.assert_allclose(np_(pt[1]), np.asarray(pj[1]), atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(np_(pt[0] / pt[2]),
                                   np.asarray(pj[0] / pj[2]), atol=1e-5,
                                   rtol=1e-4)
    merged = fd.lse_merge(parts_t)
    np.testing.assert_allclose(np_(merged), np.asarray(j_merge(parts_j)),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np_(merged), np.asarray(whole[0] / whole[2]),
                               atol=1e-5, rtol=1e-4)


def test_wrappers_refuse_bad_shapes():
    x = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="KH dividing H"):
        fa.flash_attention(x, torch.zeros(1, 8, 2, 16),
                           torch.zeros(1, 8, 2, 16), 1.0)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(x, x, x, 1.0, True, 0)
    with pytest.raises(ValueError, match="KH dividing H"):
        fd.flash_decode_partial(torch.zeros(1, 3, 16),
                                torch.zeros(1, 8, 2, 16),
                                torch.zeros(1, 8, 2, 16), scale=1.0,
                                block_k=8)
