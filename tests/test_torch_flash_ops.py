"""The port's flash_attention and flash_decode ops (their plain versions on
the CPU) against the JAX package's Pallas ops in interpret mode, as
tests/test_kernels.py runs them: flash_attention within 2e-5 (float32)
and 2e-2 (bfloat16), flash_decode and lse_merge within 1e-5/1e-4. Also
the kv heads read in place (GQA) and the non-causal unaligned case,
which the port masks by the true key length, against the reference's
oracle ``attention_ref``. And the arithmetic of the redesigned kernels:
flash_decode cut into splits and merged (ragged and single splits)
against the Pallas op within 1e-5/1e-4; p carried as bf16 hi + lo
(2^-16 of p) keeps the bf16 attention within one bf16 ulp of the float32
p, where p rounded to bf16 once leaves it on rows with 2-4 keys."""
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
from repro_torch.kernels.flash_decode import ref as fd_ref

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


@pytest.mark.parametrize("T,split,KH,bk", [
    (200, 64, 2, 40),   # splits of 64 keys, the last 8
    (128, 256, 1, 32),  # T below one split
    (96, 20, 2, 32),    # splits of 20, the last 16
    (64, 1, 1, 16)])    # a key a split
def test_split_partials_match_the_pallas_op(T, split, KH, bk):
    """The kernel's cut: per-split partials merged as its second pass
    merges them, against the Pallas kernel on the repeated kv heads."""
    rng = np.random.default_rng(T + split)
    B, H, d = 2, 4, 16
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng.normal(size=s)) for s in (
        (B, H, d), (B, T, KH, d), (B, T, KH, d)))
    rep = lambda a: jnp.repeat(a, H // KH, axis=2)  # noqa: E731
    acc_j, m_j, l_j = j_part(jq, rep(jk), rep(jv), scale=0.25, block_k=bk)
    acc, m, l = fd_ref.flash_decode_partial_split_plain(tq, tk, tv, 0.25,
                                                        split)
    np.testing.assert_allclose(np_(acc / l), np.asarray(acc_j / l_j),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np_(m), np.asarray(m_j), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(np_(l), np.asarray(l_j), atol=0, rtol=1e-4)
    fd.reset_launches()
    got = fd._partial_split(tq, tk, tv, 0.25, split)
    assert fd.LAUNCHES["flash_decode"] == 0  # the CPU runs the plain one
    for a, b in zip(got, (acc, m, l)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,split,bounds", [
    (200, 64, (0, 64, 128, 192, 200)),
    (256, 160, (0, 160, 256)),
    (100, 100, (0, 100))])
def test_split_plain_cuts_where_the_kernel_does(T, split, bounds):
    """Splits of ``split`` keys from t = 0, the last one ragged, as the
    kernel's first pass cuts them (``decode_split``: block s takes the
    keys from t0 = s * split, min(split, T - t0) of them): the same merge
    over those slices, bit for bit."""
    rng = np.random.default_rng(T + split)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((2, 4, 16), (2, T, 2, 16), (2, T, 2, 16)))
    parts = [fd_ref.flash_decode_partial_plain(q, k[:, a:b], v[:, a:b], 0.25)
             for a, b in zip(bounds, bounds[1:])]
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    w = [torch.exp(p[1] - m) for p in parts]
    want = (sum(p[0] * ws for p, ws in zip(parts, w)), m,
            sum(p[2] * ws for p, ws in zip(parts, w)))
    got = fd_ref.flash_decode_partial_split_plain(q, k, v, 0.25, split)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_choose_split_fills_the_card():
    # danube's decode: 8 splits of 512 keys x 8 kv heads x 4 = 256 blocks
    assert fd.choose_split(4, 8, 4096, 4, 132) == 512
    # one prompt of it: halved to 256 keys, 128 blocks
    assert fd.choose_split(1, 8, 4096, 4, 132) == 256
    # one batch, one kv head: halved to 64 keys, 64 blocks
    assert fd.choose_split(1, 1, 4096, 8, 132) == 64
    # 48 query heads a kv head: the scores stay under MAX_OUTPUTS
    split = fd.choose_split(2, 1, 8192, 48, 132)
    assert 48 * split <= fd.MAX_OUTPUTS and split % 16 == 0


def test_split_bf16_carries_p_to_2_16():
    p = torch.as_tensor(np.random.default_rng(4).uniform(1e-6, 1.0, 4096),
                        dtype=torch.float32)
    hi, lo = fa_ref.split_bf16(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert bool(((hi.float() - p).abs() <= 2.0 ** -8 * p).all())
    assert bool(((hi.float() + lo.float() - p).abs()
                 <= 2.0 ** -16 * p).all())


def _ulp_excess(a, b):
    """|a - b| in bf16 ulps of max(|a|, |b|), values under 2^-6 judged at
    2^-6 (as tests/test_torch_gpu.py holds the kernel)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()).clamp_min(2 ** -6))
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)


def test_hilo_p_keeps_one_ulp_where_single_rounding_leaves_it():
    """bf16 q, k, v, causal: rows 1-3 see 2-4 keys. p = p_hi + p_lo
    stays within one bf16 ulp of the float32-p attention (the port's
    plain version and the Pallas op); p rounded once does not."""
    rng = np.random.default_rng(6)
    B, S, H, d = 2, 64, 4, 32
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng.normal(size=(B, S, H, d)),
                                          "bfloat16") for _ in range(3))
    scale = d ** -0.5
    plain = fa_ref.flash_attention_plain(tq, tk, tv, scale, True)
    pallas = torch.as_tensor(np.asarray(
        j_flash(jq, jk, jv, scale, True, None, 32, 32, True), np.float32))
    hilo = fa_ref.flash_attention_hilo_plain(tq, tk, tv, scale, True)
    once = fa_ref.flash_attention_hilo_plain(tq, tk, tv, scale, True,
                                             lo=False)
    assert hilo.dtype == once.dtype == torch.bfloat16
    for want in (plain, pallas):
        assert float(_ulp_excess(hilo, want).max()) <= 1.0
    early = _ulp_excess(once, plain)[:, 1:4]
    assert float(early.max()) > 1.0
    assert torch.equal(once[:, 0], plain[:, 0])  # one key: p = 1 exactly
