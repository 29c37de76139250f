"""The port's replay scans and per-frame bank steps (what a CPU tensor
runs: the kernels' plain versions) against the JAX package's ops of the
same names, run in interpret mode as the package's own tests run them:
states, log-likelihoods and mode probabilities within 1e-5 by
|d| / max(1, |ref|), on streams of the reference tests' scale (positions
within ±1). Further out the two float32 implementations part by more
than float32 rounding alone explains at that scale: XLA on the CPU
contracts a*b + c into fused multiply-adds and the port does not (its
op order is the CUDA kernels'), and the filter's velocity, recovered
over dt = 1/30 s, amplifies the difference. So at positions within ±20
each is held to the float64 oracle instead: the port within 1e-5 or
twice the reference's own error. Inside the port, the properties the
reference asserts bit for bit: the K=1 IMM replay is the single-model
scan, a stream split into time chunks equals one call, and the scan's
final state equals T ``katana_bank`` calls."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as jf
from repro.kernels.katana_bank import ops as jops
from repro_torch.core import filters as tf
from repro_torch.core import ref as oref
from repro_torch.kernels.katana_bank import ops as tops

from _torch_inputs import replay_inputs
from _torch_parity import models, np_

TOL = 1e-5
T = 24
EXTENT = 1.0  # the reference tests' stream scale
SLACK = 2.0


def rel_err(got, want):
    got, want = np_(got).astype(np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def assert_rel(got, want, tol=TOL):
    assert tuple(np_(got).shape) == tuple(np.shape(want))
    err = rel_err(got, want) if np.size(want) else 0.0
    assert err <= tol, err


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("kind,N", [("lkf", 130), ("ekf", 5), ("lkf", 1)])
def test_bank_sequence_matches_reference(kind, N):
    jm, tm, _, _ = models(kind)
    x0, P0, zs, _ = replay_inputs(np.random.default_rng(N), tm, N, T,
                                  extent=EXTENT)
    want, jfin = jops.katana_bank_sequence(jm, *_j(zs, x0, P0),
                                           return_final=True)
    got, tfin = tops.katana_bank_sequence(tm, *_t(zs, x0, P0),
                                          return_final=True)
    for a, b in zip((got,) + tfin, (want,) + tuple(jfin)):
        assert_rel(a, b)


def _imm_seeds(rng, imm, N, extent=EXTENT):
    """Mode-conditioned seeds (K, N, n) / (K, N, n, n) and per-track mode
    probabilities (N, K)."""
    K, n = imm.K, imm.n
    x0, P0, zs, valid = replay_inputs(rng, imm, N, T, drop=0.1,
                                      extent=extent)
    xK = (x0[None] + 0.05 * rng.normal(size=(K, N, n))).astype(np.float32)
    PK = (P0[None] * rng.uniform(0.5, 1.5, (K, N, 1, 1))).astype(np.float32)
    mu0 = rng.dirichlet(np.ones(K), size=N).astype(np.float32)
    return x0, P0, xK, PK, mu0, zs, valid


def test_imm_sequence_valid_nan_and_mu0_match_reference():
    """NaN measurements on invalid frames coast without reaching the
    carry; per-track mu0; the finals match too."""
    jimm, timm, _, _ = models("imm")
    x0, P0, _, _, mu0, zs, valid = _imm_seeds(np.random.default_rng(1), timm,
                                              130)
    assert np.isnan(zs).any()
    want, jfin = jops.katana_imm_sequence(jimm, *_j(zs, x0, P0, mu0, valid),
                                          return_final=True)
    got, tfin = tops.katana_imm_sequence(timm, *_t(zs, x0, P0, mu0, valid),
                                         return_final=True)
    assert bool(torch.isfinite(got).all())
    for a, b in zip((got,) + tfin, (want,) + tuple(jfin)):
        assert_rel(a, b)


def test_imm_sequence_resumes_mode_conditioned_seeds():
    jimm, timm, _, _ = models("imm")
    _, _, xK, PK, mu0, zs, _ = _imm_seeds(np.random.default_rng(2), timm, 5)
    zs = np.nan_to_num(zs)
    want, jfin = jops.katana_imm_sequence(jimm, *_j(zs, xK, PK, mu0),
                                          return_final=True)
    got, tfin = tops.katana_imm_sequence(timm, *_t(zs, xK, PK, mu0),
                                         return_final=True)
    for a, b in zip((got,) + tfin, (want,) + tuple(jfin)):
        assert_rel(a, b)


def test_imm_bank_sequence_matches_reference():
    jimm, timm, _, _ = models("imm")
    x0, P0, zs, _ = replay_inputs(np.random.default_rng(3), timm, 5, T,
                                  extent=EXTENT)
    want, jfin = jops.imm_bank_sequence(jimm, *_j(zs, x0, P0),
                                        return_final=True)
    got, tfin = tops.imm_bank_sequence(timm, *_t(zs, x0, P0),
                                       return_final=True)
    for a, b in zip((got,) + tfin, (want,) + tuple(jfin)):
        assert_rel(a, b)
    # the per-frame driver tracks the fused scan (test_imm_scan.py:58)
    np.testing.assert_allclose(
        np_(got), np_(tops.katana_imm_sequence(timm, *_t(zs, x0, P0))),
        atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("kind,N", [("lkf", 130), ("ekf", 5)])
def test_katana_bank_matches_reference(kind, N):
    jm, tm, _, _ = models(kind)
    x0, P0, zs, _ = replay_inputs(np.random.default_rng(4), tm, N, 1,
                                  extent=EXTENT)
    want = jops.katana_bank(jm, *_j(x0, P0, zs[0]))
    got = tops.katana_bank(tm, *_t(x0, P0, zs[0]))
    for a, b in zip(got, want):
        assert_rel(a, b)
    soa = tops.katana_bank_soa(tm, *_t(x0.T.copy(), P0.transpose(1, 2, 0)
                                       .copy(), zs[0].T.copy()))
    assert torch.equal(soa[0], got[0].T)
    assert torch.equal(soa[1], got[1].permute(1, 2, 0))


@pytest.mark.parametrize("kind,N", [("imm", 130), ("ekf", 5)])
def test_katana_bank_imm_matches_reference(kind, N):
    if kind == "imm":
        jimm, timm, _, _ = models("imm")
    else:
        jimm, timm = jf.as_imm(jf.get_filter(kind)), tf.as_imm(
            tf.get_filter(kind))
    rng = np.random.default_rng(5)
    x0, P0, zs, _ = replay_inputs(rng, timm, N, 1, extent=EXTENT)
    K = timm.K
    x = (x0[None] + 0.05 * rng.normal(size=(K, N, timm.n))).astype(np.float32)
    P = np.broadcast_to(P0, (K,) + P0.shape).copy()
    want = jops.katana_bank_imm(jimm, *_j(x, P, zs[0]))
    got = tops.katana_bank_imm(timm, *_t(x, P, zs[0]))
    for a, b in zip(got, want):
        assert_rel(a, b)


def test_scans_at_scale_as_close_to_float64_as_the_reference():
    """Positions within ±20 (the shapes of the tests above, so the
    reference's kernels are already built): the port's single-model and
    IMM scans are within 1e-5 of the float64 oracle, or at most twice as
    far from it as the reference."""
    jm, tm, _, _ = models("lkf")
    x0, P0, zs, _ = replay_inputs(np.random.default_rng(130), tm, 130, T)
    want, _ = jops.katana_bank_sequence(jm, *_j(zs, x0, P0),
                                        return_final=True)
    got, _ = tops.katana_bank_sequence(tm, *_t(zs, x0, P0),
                                       return_final=True)
    exact = oref.run_batched(tm, zs.astype(np.float64), x0, P0)[0]
    e_t, e_j = rel_err(got, exact), rel_err(want, exact)
    assert e_t <= max(TOL, SLACK * e_j), (e_t, e_j)

    jimm, timm, _, _ = models("imm")
    x0, P0, _, _, mu0, zs, valid = _imm_seeds(np.random.default_rng(1), timm,
                                              130, extent=20.0)
    want, _ = jops.katana_imm_sequence(jimm, *_j(zs, x0, P0, mu0, valid),
                                       return_final=True)
    got, _ = tops.katana_imm_sequence(timm, *_t(zs, x0, P0, mu0, valid),
                                      return_final=True)
    exact = np.stack([oref.run_imm(timm, zs[:, k].astype(np.float64),
                                   x0=x0[k], P0=P0[k], mu0=mu0[k],
                                   valid=valid[:, k])[0]
                      for k in range(130)], axis=1)
    e_t, e_j = rel_err(got, exact), rel_err(want, exact)
    assert e_t <= max(TOL, SLACK * e_j), (e_t, e_j)


# ---------------------------------------------------------------- in the port

@pytest.mark.parametrize("kind", ["cv9", "ekf"])
def test_imm_k1_is_the_single_model_scan(kind):
    model = tf.get_filter(kind)
    x0, P0, zs, _ = _t(*replay_inputs(np.random.default_rng(6), model, 7, T))
    a, fa = tops.katana_imm_sequence(tf.as_imm(model), zs, x0, P0,
                                     return_final=True)
    b, fb = tops.katana_bank_sequence(model, zs, x0, P0, return_final=True)
    assert torch.equal(a, b)
    assert torch.equal(fa[0][0], fb[0]) and torch.equal(fa[1][0], fb[1])
    assert torch.equal(fa[2], torch.ones(7, 1))


def test_time_chunks_equal_one_call():
    imm, ekf = tf.make_imm(), tf.get_filter("ekf")
    rng = np.random.default_rng(7)
    x0, P0, zs, valid = _t(*replay_inputs(rng, imm, 6, T, drop=0.1))
    one = tops.katana_imm_sequence(imm, zs, x0, P0, valid=valid,
                                   return_final=True)
    many = tops.katana_imm_sequence(imm, zs, x0, P0, valid=valid,
                                    return_final=True, time_chunk=7)
    assert torch.equal(one[0], many[0])
    assert all(torch.equal(a, b) for a, b in zip(one[1], many[1]))
    x0, P0, zs, _ = _t(*replay_inputs(rng, ekf, 6, T))
    one = tops.katana_bank_sequence(ekf, zs, x0, P0, return_final=True)
    many = tops.katana_bank_sequence(ekf, zs, x0, P0, return_final=True,
                                     time_chunk=7)
    assert torch.equal(one[0], many[0])
    assert all(torch.equal(a, b) for a, b in zip(one[1], many[1]))


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_scan_equals_per_step_calls(kind):
    model = tf.get_filter(kind)
    x0, P0, zs, _ = _t(*replay_inputs(np.random.default_rng(8), model, 9, T))
    _, (xf, Pf) = tops.katana_bank_sequence(model, zs, x0, P0,
                                            return_final=True)
    x, P = x0, P0
    for t in range(T):
        x, P = tops.katana_bank(model, x, P, zs[t])
    assert torch.equal(x, xf) and torch.equal(P, Pf)


def test_multi_model_nonlinear_members_raise():
    ekf = tf.get_filter("ekf")
    imm = tf.IMMModel(name="ekf2", models=(ekf, ekf),
                      trans=np.array([[0.9, 0.1], [0.1, 0.9]]),
                      mu0=np.array([0.5, 0.5]))
    x0, P0, zs, _ = _t(*replay_inputs(np.random.default_rng(9), ekf, 3, 2))
    with pytest.raises(NotImplementedError, match="linear"):
        tops.katana_imm_sequence(imm, zs, x0, P0)
    with pytest.raises(NotImplementedError, match="linear"):
        tops.katana_bank_imm(imm, x0[None].expand(2, 3, 8).contiguous(),
                             P0[None].expand(2, 3, 8, 8).contiguous(), zs[0])
