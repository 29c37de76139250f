"""The port's Mamba-2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the same parameters (the reference's
``ssm_init`` tree carried over as numpy): ``apply_ssm`` prefill (through
ssd_scan, its plain version on the CPU) and the decode steps after it,
the output and the whole cache (state and the three conv tails), float32
within 1e-4/1e-3; bfloat16 within 2e-2 of the values' scale. Also the
init's leaves, shapes and dtypes, the conv and norm helpers, the
decode's in-place cache write, and the train mode with its gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ssm as j_ssm
from repro_torch.configs.base import SSMConfig
from repro_torch.convert import _tensor
from repro_torch.models import ssm

from _torch_parity import np_

TOL = dict(atol=1e-4, rtol=1e-3)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
D_MODEL = 32


def _cfgs(chunk=16):
    kw = dict(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=chunk)
    return JSSMConfig(**kw), SSMConfig(**kw)


def _params(jcfg, dtype):
    tree = jax.tree.map(np.asarray, j_ssm.ssm_init(jax.random.key(1), jcfg,
                                                   D_MODEL, JNP[dtype]))
    return tree, {k: _tensor(v, "cpu") for k, v in tree.items()}


def _x(seed, B, S, dtype):
    a = np.random.default_rng(seed).normal(size=(B, S, D_MODEL))
    return jnp.asarray(a, JNP[dtype]), torch.as_tensor(
        np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _close(got, want, dtype):
    got = np_(got.float()) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 32), (8, 16)])
def test_apply_ssm_prefill_then_decode_matches(dtype, S, chunk):
    jcfg, cfg = _cfgs(chunk)
    tree, p = _params(jcfg, dtype)
    jx, tx = _x(S, 2, S, dtype)
    jout, jcache = j_ssm.apply_ssm(tree, jx, jcfg, "prefill")
    out, cache = ssm.apply_ssm(p, tx, cfg, "prefill")
    _close(out, jout, dtype)
    for got, want in zip(cache, jcache):
        assert got.dtype == (torch.float32 if want.dtype == jnp.float32
                             else getattr(torch, dtype))
        _close(got, want, dtype)
    for i in range(3):
        jx, tx = _x(100 + i, 2, 1, dtype)
        jout, jcache = j_ssm.apply_ssm(tree, jx, jcfg, "decode", jcache)
        out, cache = ssm.apply_ssm(p, tx, cfg, "decode", cache)
        _close(out, jout, dtype)
        for got, want in zip(cache, jcache):
            _close(got, want, dtype)


def test_decode_writes_the_cache_in_place():
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg, "float32")
    _, tx = _x(0, 2, 32, "float32")
    _, cache = ssm.apply_ssm(p, tx, cfg, "prefill")
    before = [t.clone() for t in cache]
    ptrs = [t.data_ptr() for t in cache]
    _, tx1 = _x(1, 2, 1, "float32")
    _, new = ssm.apply_ssm(p, tx1, cfg, "decode", cache)
    assert new is cache and [t.data_ptr() for t in new] == ptrs
    # the tails shifted by one: the old last two rows are now the first two
    for old, t in zip(before[1:], new[1:]):
        assert torch.equal(t[:, :2], old[:, 1:])
    assert not torch.equal(new.state, before[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_matches_the_reference_tree(dtype):
    jcfg, cfg = _cfgs()
    tree, _ = _params(jcfg, dtype)
    p = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, D_MODEL, "cpu",
                     getattr(torch, dtype))
    assert set(p) == set(tree)
    for k, v in tree.items():
        assert tuple(p[k].shape) == v.shape, k
        want = torch.float32 if v.dtype == np.float32 else getattr(torch,
                                                                  dtype)
        assert p[k].dtype == want, k
    for k in ("A_log", "D", "norm_scale"):  # the deterministic leaves
        np.testing.assert_allclose(np_(p[k].float()),
                                   np.asarray(tree[k], np.float32), rtol=1e-6)
    # dt_bias = log(expm1(dt)) with dt log-uniform in [1e-3, 1e-1]
    dt = np_(torch.nn.functional.softplus(p["dt_bias"]))
    assert (dt >= 1e-3 * (1 - 1e-5)).all() and (dt <= 1e-1 * (1 + 1e-5)).all()
    meta = ssm.ssm_init(None, cfg, D_MODEL, "meta", torch.float32)
    assert {k: tuple(v.shape) for k, v in meta.items()} == {
        k: tuple(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv_and_norm_match(tail):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 3, 5)).astype(np.float32)
    w = rng.normal(size=(4, 3, 5)).astype(np.float32)
    t = rng.normal(size=(2, 3, 3, 5)).astype(np.float32) if tail else None
    want = j_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if t is None else jnp.asarray(t))
    got = ssm._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                           None if t is None else torch.as_tensor(t))
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)
    scale = rng.normal(size=(3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        np_(ssm._per_head_norm(torch.as_tensor(x), torch.as_tensor(scale))),
        np.asarray(j_ssm._per_head_norm(jnp.asarray(x), jnp.asarray(scale))),
        **TOL)


def test_train_mode_raises():
    """Training is ported: mode "train" runs ``ssd_chunked`` under autograd
    and matches the reference's train mode (float32, 1e-4/1e-3), output
    and input gradient; only an unknown mode raises."""
    jcfg, cfg = _cfgs()
    tree, p = _params(jcfg, "float32")
    jx, tx = _x(7, 2, 32, "float32")
    jout, jcache = j_ssm.apply_ssm(tree, jx, jcfg, "train")
    jgrad = jax.grad(lambda x: j_ssm.apply_ssm(tree, x, jcfg, "train")[0]
                     .sum())(jx)
    tx.requires_grad_()
    out, cache = ssm.apply_ssm(p, tx, cfg, "train")
    assert jcache is None and cache is None
    _close(out.detach(), jout, "float32")
    (grad,) = torch.autograd.grad(out.sum(), tx)
    _close(grad, jgrad, "float32")
    with pytest.raises(ValueError, match="mode"):
        ssm.apply_ssm(p, torch.zeros(1, 16, D_MODEL), cfg, "serve")


def test_full_chunk_gradient_stays_finite():
    """At mamba2-130m's chunk of 256, exp(cum_i - cum_j) above the
    diagonal overflows (here dt * A = -0.5 a step: cum reaches -128).
    The reference's ``ssd_chunked`` masks it after the exp, so its
    gradient is 0 * inf = NaN; the port masks the exponent first: the
    same forward (float32, 1e-4/1e-3 of the reference's), and a finite
    gradient that matches its own chunk-16 gradient (where nothing
    overflows) within 1e-4/1e-3."""
    rng = np.random.default_rng(8)
    B_, S_, H, P, N = 1, 256, 2, 4, 4
    x, Bm, Cm = (rng.normal(size=s).astype(np.float32)
                 for s in ((B_, S_, H, P), (B_, S_, N), (B_, S_, N)))
    dt = np.full((B_, S_, H), 0.05, np.float32)
    A = np.array([-10.0, -1.0], np.float32)
    args = [x, dt, Bm, Cm]
    jgrads = jax.grad(
        lambda *a: j_ssm.ssd_chunked(*a, jnp.asarray(A), 256)[0].sum(),
        argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in args))
    # the reference's gradients in dt, Bm and Cm are NaN
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)
    grads = {}
    for chunk in (256, 16):
        t = [torch.tensor(a, requires_grad=True) for a in args]
        y, _ = ssm.ssd_chunked(*t, torch.as_tensor(A), chunk)
        if chunk == 256:
            _close(y.detach(), j_ssm.ssd_chunked(
                *(jnp.asarray(a) for a in args), jnp.asarray(A), 256)[0],
                "float32")
        grads[chunk] = torch.autograd.grad(y.sum(), t)
    for g256, g16 in zip(grads[256], grads[16]):
        assert torch.isfinite(g256).all()
        _close(g256, np_(g16), "float32")
