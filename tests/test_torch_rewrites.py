"""Port small-matrix and IMM algebra against the JAX package on the
same inputs (rtol 1e-5, float32), and the posterior stays normalized
under extreme log-likelihoods."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import rewrites as jr
from repro_torch.core import rewrites as tr

from _torch_inputs import spd
from _torch_parity import np_, t32


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_small_inv_det_match(m, seed):
    S = spd(np.random.default_rng(seed), (16,), m, scale=0.8)
    np.testing.assert_allclose(np_(tr.small_inv(t32(S), m)),
                               np.asarray(jr.small_inv(jnp.asarray(S), m)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(tr.small_det(t32(S), m)),
                               np.asarray(jr.small_det(jnp.asarray(S), m)),
                               rtol=1e-5)
    np.testing.assert_allclose(np_(tr.small_inv(t32(S), m)) @ S,
                               np.broadcast_to(np.eye(m), S.shape), atol=1e-4)


@pytest.mark.parametrize("n", [3, 6, 9])
def test_triu_pack_sym_unpack(n):
    rj, cj, mj = jr.triu_pack(n)
    rt, ct, mt = tr.triu_pack(n)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(mt, mj)
    tri = np.random.default_rng(n).normal(size=(5, n * (n + 1) // 2))
    np.testing.assert_array_equal(np_(tr.sym_unpack(t32(tri), n)),
                                  np.asarray(jr.sym_unpack(
                                      jnp.asarray(tri, jnp.float32), n)))


def _imm_inputs(seed, K=4, B=12, n=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, B, n)).astype(np.float32)
    P = spd(rng, (K, B), n)
    mu = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
    Pi = np.full((K, K), 0.05 / (K - 1))
    np.fill_diagonal(Pi, 0.95)
    return x, P, mu, Pi.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_imm_mix_combine_match(seed):
    x, P, mu, Pi = _imm_inputs(seed)
    outs_j = jr.imm_mix(jnp.asarray(x), jnp.asarray(P), jnp.asarray(mu),
                        jnp.asarray(Pi))
    outs_t = tr.imm_mix(t32(x), t32(P), t32(mu), t32(Pi))
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(jr.imm_combine(jnp.asarray(x), jnp.asarray(P),
                                   jnp.asarray(mu)),
                    tr.imm_combine(t32(x), t32(P), t32(mu))):
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_posterior_and_loglik_match(seed):
    rng = np.random.default_rng(seed)
    K, B, m = 4, 10, 3
    cbar = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
    ll = (rng.normal(size=(K, B)) * 5).astype(np.float32)
    np.testing.assert_allclose(
        np_(tr.imm_mode_posterior(t32(cbar), t32(ll))),
        np.asarray(jr.imm_mode_posterior(jnp.asarray(cbar), jnp.asarray(ll))),
        rtol=1e-5, atol=1e-7)
    S = spd(rng, (B,), m, scale=0.8)
    y = rng.normal(size=(B, m)).astype(np.float32)
    Sinv = np.linalg.inv(S).astype(np.float32)
    logdet = np.log(np.linalg.det(S)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tr.gaussian_loglik(t32(y), t32(Sinv), t32(logdet), m)),
        np.asarray(jr.gaussian_loglik(jnp.asarray(y), jnp.asarray(Sinv),
                                      jnp.asarray(logdet), m)), rtol=1e-5)


@pytest.mark.parametrize("scale", [1e4, -1e4])
def test_posterior_normalized_under_extreme_logliks(scale):
    rng = np.random.default_rng(3)
    cbar = rng.dirichlet(np.ones(4), size=8).astype(np.float32)
    ll = (rng.normal(size=(4, 8)) * scale).astype(np.float32)
    mu = np_(tr.imm_mode_posterior(t32(cbar), t32(ll)))
    assert np.isfinite(mu).all() and (mu >= 0).all()
    np.testing.assert_allclose(mu.sum(axis=1), 1.0, atol=1e-6)
