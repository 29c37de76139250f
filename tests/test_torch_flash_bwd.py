"""The plain version of the flash_attention backward kernel
(``ref.flash_attention_bwd_plain``: the kernel's three passes, exp and
roundings in torch ops) on the CPU, and which backward ``FlashAttention``
runs there.

Against ``jax.vjp`` of the reference's ``flash_attention`` (its Pallas
forward in interpret mode, its ``custom_vjp`` backward), k and v broadcast
to the H query heads as ``repro/models/attention.py:280-285`` calls it:
causal, windowed, non-causal and GQA at S a multiple of the query block,
float32, within 2e-5. Against a dense float64 oracle (autograd of the
masked softmax attention) at a ragged S, within 2e-5 + 1e-4 relative.
In bfloat16 (the inputs rounded to bfloat16 first, the oracle on those
values), each of dq, dk, dv lies within twice the float64 distance of
the torch-op backward ``flash_attention_bwd`` on the same inputs: the
plain version rounds P to bfloat16 and splits dS into two bfloat16 terms
where the kernel feeds the tensor cores, the torch-op backward rounds its
own products.
On the CPU, ``FlashAttention``'s backward is ``flash_attention_bwd`` and
counts no launch; ``flash_attention_bwd_kernel`` runs the plain version.
``ref.split_tf32``, the float32 kernel's TF32 split (3xTF32): big and
small keep TF32's 10 mantissa bits, big + small is x to 2^-22, ties
round away from zero, and a value TF32 holds splits into itself and 0.
``ref.bwd_excess``, the rule the kernel is held to against the plain
version on the card: two bf16 ulps pass and three do not; dV's allowance
for P's bf16 roundings covers a P that differs in its last float32 bits
and still refuses a dropped query tile, a wrong dO row and a P that
enters dV unrounded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels.flash_attention import ops, ref

TOL = dict(atol=2e-5, rtol=0)
ORACLE_TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(seed, B, S, H, KH, d, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    q = rng.normal(size=(B, S, H, d)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, KH, d)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, S, H, d)).astype(np.float32)
    return q, k, v, do


def _plain(q, k, v, do, scale, causal, window, dtype=torch.float32):
    return ref.flash_attention_bwd_plain(
        *(torch.tensor(a).to(dtype) for a in (q, k, v, do)), scale, causal,
        window)


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
    kb, vb = (x.repeat_interleave(G, dim=2) for x in t[1:])
    s = torch.einsum("bqhd,bkhd->bhqk", t[0], kb) * scale
    ok = ref.mask(q.shape[1], k.shape[1], causal, window, "cpu")
    p = torch.softmax(s.masked_fill(~ok, -1e30), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vb)
    return torch.autograd.grad(o, t, torch.tensor(do, dtype=torch.float64))


@pytest.mark.parametrize("B,S,H,KH,d,causal,window,block", [
    (1, 64, 2, 2, 16, True, None, 32),     # causal
    (2, 96, 4, 2, 8, True, 40, 32),        # windowed, GQA
    (1, 64, 2, 2, 8, False, None, 32),     # non-causal
    (1, 128, 8, 2, 16, True, None, 64),    # GQA, G = 4
])
def test_plain_matches_the_reference(B, S, H, KH, d, causal, window, block):
    q, k, v, do = _inputs(S + H, B, S, H, KH, d)
    scale = 1.0 / np.sqrt(d)
    got = _plain(q, k, v, do, scale, causal, window)
    want = _reference_grads(q, k, v, do, scale, causal, window, block)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("B,S,Sk,H,KH,d,causal,window", [
    (1, 600, 600, 2, 1, 8, True, None),    # 9 tiles of 64 and 24 rows
    (1, 100, 100, 4, 2, 16, True, 30),
    (2, 70, 70, 2, 1, 8, False, None),
    (1, 50, 90, 2, 2, 8, False, 20),       # Sq != Sk
])
def test_plain_ragged_matches_the_oracle(B, S, Sk, H, KH, d, causal, window):
    q, k, v, do = _inputs(S + Sk, B, S, H, KH, d, Sk)
    got = _plain(q, k, v, do, 0.3, causal, window)
    want = _oracle_grads(q, k, v, do, 0.3, causal, window)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(),
                                   **ORACLE_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("B,S,H,KH,d,causal,window", [
    (1, 200, 4, 1, 32, True, 64),
    (2, 96, 4, 2, 16, False, None),
])
def test_plain_bf16_within_twice_the_torch_ops_distance(B, S, H, KH, d,
                                                        causal, window):
    """Inputs rounded to bfloat16; the float64 oracle on the rounded
    values; max |d| of each gradient at most 2x the torch-op backward's."""
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _inputs(S * d, B, S, H, KH, d))
    scale = d ** -0.5
    want = _oracle_grads(*(t.float().numpy() for t in (q, k, v, do)), scale,
                         causal, window)
    got = ref.flash_attention_bwd_plain(q, k, v, do, scale, causal, window)
    ops_route = ops.flash_attention_bwd(q, k, v, do, scale, causal, window,
                                        64)
    for name, a, b, w in zip("qkv", got, ops_route, want):
        assert a.dtype == torch.bfloat16, name
        e_plain = float((a.double() - w).abs().max())
        e_ops = float((b.double() - w).abs().max())
        assert e_plain <= 2 * e_ops, (name, e_plain, e_ops)


def test_a_row_with_no_visible_key_gets_no_gradient():
    """Sq > Sk + window - 1: the last query rows see no key; lse = inf,
    D = 0, so their dq is zero and they add nothing to dk, dv."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(3, 1, 40, 2, 1, 8, 10))
    dq, dk, dv = ref.flash_attention_bwd_plain(q, k, v, do, 0.3, True, 4)
    assert bool((dq[:, 13:] == 0).all()) and bool(dq[:, :13].abs().sum() > 0)
    # the same from the rows that see keys alone
    sub = ref.flash_attention_bwd_plain(q[:, :13], k, v, do[:, :13], 0.3,
                                        True, 4)
    torch.testing.assert_close(dk, sub[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(dv, sub[2], atol=1e-6, rtol=0)


def test_cpu_backward_is_flash_attention_bwd_and_counts_no_launch(
        monkeypatch):
    q, k, v, do = (torch.tensor(a) for a in _inputs(5, 1, 48, 4, 2, 8))
    calls = []
    real = ops.flash_attention_bwd

    def spy(*args):
        calls.append(args[0].device.type)
        return real(*args)

    monkeypatch.setattr(ops, "flash_attention_bwd", spy)
    ops.reset_launches()
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ops.flash_attention(*t, 0.25, True, 16, 32)
    got = torch.autograd.grad(o, t, do)
    assert calls == ["cpu"]
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    want = real(q, k, v, do, 0.25, True, 16, 32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_wrapper_on_the_cpu_is_the_plain_version():
    q, k, v, do = (torch.tensor(a) for a in _inputs(7, 2, 70, 4, 2, 16))
    got = ops.flash_attention_bwd_kernel(q, k, v, do, 0.25, True, 30)
    want = ref.flash_attention_bwd_plain(q, k, v, do, 0.25, True, 30)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ops.LAUNCHES["flash_attention_bwd"] == 0


@pytest.mark.parametrize("bad", ["do", "kv", "window"])
def test_kernel_wrapper_refuses_a_bad_shape(bad):
    q, k, v, do = (torch.tensor(a) for a in _inputs(9, 1, 16, 4, 2, 8))
    window = 8
    if bad == "do":
        do = do[:, :8]
    elif bad == "kv":
        k = k[:, :, :1]
    else:
        window = 0
    with pytest.raises(ValueError):
        ops.flash_attention_bwd_kernel(q, k, v, do, 0.25, True, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_excess_is_the_stated_tolerance(dtype):
    """float32: 2e-5 + 1e-4 |want|; bfloat16: two ulps of the larger
    magnitude, magnitudes under 2^-6 of the largest judged there."""
    want = torch.tensor([1.0, -0.75, 3.0, 0.01]).to(dtype)
    if dtype == torch.float32:
        room = 2e-5 + 1e-4 * want.abs()
    else:  # two ulps of 1, 0.75, 3 and of the 2^-6 * 3 floor
        room = torch.tensor([2 ** -6, 2 ** -7, 2 ** -5, 2 ** -11])
    near, far = (want.float() + f * room for f in (0.5, 1.5))
    assert ref.bwd_excess(near.to(dtype), want) <= 1.0
    assert ref.bwd_excess(far.to(dtype), want) > 1.0


def _dv_case():
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _inputs(0, 1, 300, 4, 2, 32))
    return q, k, v, do, 32 ** -0.5


def test_dv_allowance_covers_a_p_that_differs_in_its_last_bits():
    """The scale 2^-20 apart moves P by up to ~2^-17 relative, about what
    the kernel's tensor-core scores and ex2.approx do: dV then differs by
    P's bf16 roundings falling the other way, which two ulps alone do not
    cover and the allowance does."""
    q, k, v, do, scale = _dv_case()
    *want, flip = ref.flash_attention_bwd_plain(q, k, v, do, scale, True,
                                                100, flips=True)
    got = ref.flash_attention_bwd_plain(q, k, v, do, scale * (1 + 2 ** -20),
                                        True, 100)
    for a, b, f in zip(got, want, (0.0, 0.0, flip)):
        assert ref.bwd_excess(a, b, f) <= 1.0
    assert ref.bwd_excess(got[2], want[2]) > 1.0
    assert float(flip.max()) > 0
    f32 = ref.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, do)),
                                        scale, True, 100, flips=True)[3]
    assert not bool(f32.any())


@pytest.mark.parametrize("fault", ["dropped query tile", "one dO row",
                                   "P unrounded"])
def test_dv_allowance_refuses_a_dv_fault(fault):
    q, k, v, do, scale = _dv_case()
    *want, flip = ref.flash_attention_bwd_plain(q, k, v, do, scale, True,
                                                100, flips=True)
    if fault == "P unrounded":
        dv = ref.flash_attention_bwd_plain(
            *(t.float() for t in (q, k, v, do)), scale, True, 100)[2]
    else:
        bad = do.clone()
        if fault == "dropped query tile":
            bad[:, 64:128] = 0
        else:
            bad[:, 200] = -bad[:, 200]
        dv = ref.flash_attention_bwd_plain(q, k, v, bad, scale, True, 100)[2]
    assert ref.bwd_excess(dv.bfloat16(), want[2], flip) > 1.0


@pytest.mark.parametrize("rule", ["low 13 bits zero", "big + small is x",
                                  "ties away from zero",
                                  "exact on TF32 values"])
def test_split_tf32(rule):
    """``ref.split_tf32`` rounds as cvt.rna.tf32.f32 does: (bits + 0x1000)
    & ~0x1fff on the int32 view, to nearest, ties away from zero."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(size=4096) * np.exp2(
        rng.integers(-40, 40, size=4096)), dtype=torch.float32)
    big, small = ref.split_tf32(x)
    if rule == "low 13 bits zero":
        for t in (big, small):
            assert not bool((t.view(torch.int32) & 0x1fff).any())
    elif rule == "big + small is x":
        err = (big.double() + small.double() - x.double()).abs()
        assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
        assert float((big.double() - x.double()).abs().max()) > 0
    elif rule == "ties away from zero":
        # 1 + 2^-11 and 1 + 3 2^-11 lie halfway between TF32 neighbours
        t = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11)],
                         dtype=torch.float32)
        want = torch.tensor([1 + 2 ** -10, 1 + 4 * 2 ** -11, -(1 + 2 ** -10)],
                            dtype=torch.float32)
        assert torch.equal(ref.split_tf32(t)[0], want)
    else:
        held = big  # already TF32
        b2, s2 = ref.split_tf32(held)
        assert torch.equal(b2, held) and not bool(s2.any())
