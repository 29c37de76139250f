"""The full-square contract (``symmetrize=False``) of the live frames and
of the IMM replay scan at K > 1: the port's plain versions (what a CPU
tensor runs) against the JAX package's ops, run as the package's own
tests run them, on the same numpy inputs with a seed P that is not
symmetric to the bit (P + 1e-3 noise).

  * ``katana_frame`` (lkf, ekf) and ``katana_imm_frame`` (K = 1 and
    K = 4): assoc identical, states within 1e-5;
  * ``katana_imm_sequence`` at K = 4 with a NaN-coasting ``valid``
    stream and per-track ``mu0``, within 1e-5 by |d| / max(1, |ref|);
    chunked, bit for bit with one call;
  * ``rewrites.run_sequence(make_imm(), "imm_scan", ...)`` at its
    default ``symmetrize=False`` against the reference's;
  * in both packages some P'[i][j] != P'[j][i], so the full-square route
    ran, and the two contracts part;
  * a fleet frame (a leading sensor axis) at ``symmetrize=False`` raises:
    the reference has no fleet frame of its own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as jf
from repro.core import rewrites as jr
from repro.kernels.katana_bank import ops as jops
from repro_torch.core import filters as tf
from repro_torch.core import rewrites as tr
from repro_torch.kernels.katana_bank import ops as tops

from _torch_inputs import random_frame_inputs, replay_inputs
from _torch_parity import models, np_, t32
from test_torch_scan import TOL, assert_rel

STATE_ATOL = 1e-5  # tests/test_torch_frame_ops.py's bar for the frames
T = 24


def _asym(rng, P):
    """P plus noise of 1e-3: not symmetric to the bit."""
    return (P + 1e-3 * rng.normal(size=P.shape)).astype(np.float32)


def _j(*a):
    return [jnp.asarray(v) for v in a]


def _t(*a):
    return [torch.as_tensor(v) for v in a]


def _asymmetric_out(P) -> bool:
    """Some P[..., i, j] != P[..., j, i]: the full square was computed."""
    P = np.asarray(np_(P))
    return bool((P != np.swapaxes(P, -1, -2)).any())


def _frame_inputs(kind, seed, K=None, C=24, M=12):
    n, m, obs = ((8, 4, [0, 1, 2, 4]) if kind == "ekf"
                 else (6, 3, [0, 1, 2]) if kind == "lkf" else (9, 3, [0, 1, 2]))
    rng = np.random.default_rng(seed)
    arrays = list(random_frame_inputs(rng, n, m, C, M, obs, K=K))
    arrays[1] = _asym(rng, arrays[1])
    return arrays


@pytest.mark.parametrize("kind,seed", [("lkf", 0), ("lkf", 1), ("ekf", 2),
                                       ("ekf", 3)])
def test_full_square_frame_matches_reference(kind, seed):
    jm, tm, _, _ = models(kind)
    x, P, z, zv, act = _frame_inputs(kind, seed)
    gate = 11.34 if jm.m == 3 else 13.28
    jx, jP, ja = jops.katana_frame(jm, *_j(x, P, z, zv, act), gate=gate,
                                   rounds=12, symmetrize=False)
    before = dict(tops.LAUNCHES)
    tx, tP, ta = tops.katana_frame(tm, t32(x), t32(P), t32(z),
                                   torch.as_tensor(zv), torch.as_tensor(act),
                                   gate, 12, symmetrize=False)
    assert tops.LAUNCHES == before  # the CPU runs no kernel
    np.testing.assert_array_equal(np_(ta), np.asarray(ja))
    assert (np_(ta) >= 0).sum() >= 3  # the gate passed some pairs
    np.testing.assert_allclose(np_(tx), np.asarray(jx), atol=STATE_ATOL)
    np.testing.assert_allclose(np_(tP), np.asarray(jP), atol=STATE_ATOL)
    assert _asymmetric_out(tP) and _asymmetric_out(jP)
    sym = tops.katana_frame(tm, t32(x), t32(P), t32(z), torch.as_tensor(zv),
                            torch.as_tensor(act), gate, 12)
    assert not torch.equal(sym[1], tP)


@pytest.mark.parametrize("kind", ["imm", "lkf", "ekf"])
def test_full_square_imm_frame_matches_reference(kind):
    """K = 4 (imm: the full-square mixing, predict, update and coasting
    select) and K = 1 (lkf, ekf: the single-model frame, mu passed
    through)."""
    if kind == "imm":
        jimm, timm = jf.make_imm(), tf.make_imm()
    else:
        jimm = jf.as_imm(jf.get_filter(kind))
        timm = tf.as_imm(tf.get_filter(kind))
    x, P, mu, z, zv, act = _frame_inputs(kind, 5, K=timm.K, C=20, M=10)
    gate = 11.34 if timm.m == 3 else 13.28
    jout = jops.katana_imm_frame(jimm, *_j(x, P, mu, z, zv, act), gate=gate,
                                 rounds=10, symmetrize=False)
    tout = tops.katana_imm_frame(timm, t32(x), t32(P), t32(mu), t32(z),
                                 torch.as_tensor(zv), torch.as_tensor(act),
                                 gate, 10, symmetrize=False)
    np.testing.assert_array_equal(np_(tout[4]), np.asarray(jout[4]))
    assert (np_(tout[4]) >= 0).sum() >= 3
    for a, b in zip(jout[:4], tout[:4]):
        np.testing.assert_allclose(np_(b), np.asarray(a), atol=STATE_ATOL)
    assert _asymmetric_out(tout[1]) and _asymmetric_out(jout[1])


def _imm_stream(rng, imm, N, extent=1.0):
    """Mode-conditioned asymmetric seeds, per-track mu0 and a stream with
    NaN on its invalid frames."""
    K, n = imm.K, imm.n
    x0, P0, zs, valid = replay_inputs(rng, imm, N, T, drop=0.1,
                                      extent=extent)
    xK = (x0[None] + 0.05 * rng.normal(size=(K, N, n))).astype(np.float32)
    PK = _asym(rng, P0[None] * rng.uniform(0.5, 1.5, (K, N, 1, 1)))
    mu0 = rng.dirichlet(np.ones(K), size=N).astype(np.float32)
    return xK, PK, mu0, zs, valid


def test_full_square_imm_sequence_matches_reference():
    """K = 4 at symmetrize=False: NaN measurements on invalid frames
    coast without reaching the carry, per-track mu0, the finals too."""
    jimm, timm = jf.make_imm(), tf.make_imm()
    xK, PK, mu0, zs, valid = _imm_stream(np.random.default_rng(7), timm, 130)
    assert np.isnan(zs).any()
    want, jfin = jops.katana_imm_sequence(jimm, *_j(zs, xK, PK, mu0, valid),
                                          return_final=True,
                                          symmetrize=False)
    got, tfin = tops.katana_imm_sequence(timm, *_t(zs, xK, PK, mu0, valid),
                                         return_final=True, symmetrize=False)
    assert bool(torch.isfinite(got).all())
    for a, b in zip((got,) + tfin, (want,) + tuple(jfin)):
        assert_rel(a, b)
    assert _asymmetric_out(tfin[1]) and _asymmetric_out(jfin[1])
    sym = tops.katana_imm_sequence(timm, *_t(zs, xK, PK, mu0, valid))
    assert not torch.equal(sym, got)


@pytest.mark.parametrize("chunk", [1, 7])
def test_full_square_imm_sequence_chunks_equal_one_call(chunk):
    timm = tf.make_imm()
    xK, PK, mu0, zs, valid = _imm_stream(np.random.default_rng(8), timm, 33,
                                         extent=20.0)
    one = tops.katana_imm_sequence(timm, *_t(zs, xK, PK, mu0, valid),
                                   return_final=True, symmetrize=False,
                                   time_chunk=T)
    many = tops.katana_imm_sequence(timm, *_t(zs, xK, PK, mu0, valid),
                                    return_final=True, symmetrize=False,
                                    time_chunk=chunk)
    assert torch.equal(one[0], many[0])
    assert all(torch.equal(a, b) for a, b in zip(one[1], many[1]))


def test_imm_scan_rung_runs_the_multi_model_imm():
    """The stage ladder's imm_scan rung on make_imm() at its default
    symmetrize=False (the K = 4 IMM scan's full square), against the
    reference's run_sequence."""
    jimm, timm = jf.make_imm(), tf.make_imm()
    x0, P0, zs, _ = replay_inputs(np.random.default_rng(9), timm, 9, T,
                                  extent=1.0)
    P0 = _asym(np.random.default_rng(10), P0)
    want = jr.run_sequence(jimm, "imm_scan", *_j(zs, x0, P0))
    got = tr.run_sequence(timm, "imm_scan", zs, x0, P0, device="cpu")
    assert_rel(got, want)
    assert not torch.equal(got, tr.run_sequence(
        timm, "imm_scan", zs, x0, P0, symmetrize=True, device="cpu"))
    step, meta = tr.build_stage(timm, "imm_scan", N=9, device="cpu")
    assert meta["K"] == timm.K == 4


@pytest.mark.parametrize("imm", [False, True])
def test_full_square_fleet_frame_raises(imm):
    """A leading sensor axis at symmetrize=False raises and names the
    ROADMAP entry; the default runs."""
    S, C, M = 2, 6, 4
    rng = np.random.default_rng(11)
    if imm:
        timm = tf.make_imm()
        x, P, mu, z, zv, act = random_frame_inputs(rng, 9, 3, C, M,
                                                   [0, 1, 2], K=4)
        args = [t32(np.stack([x] * S, 1)), t32(np.stack([P] * S, 1)),
                t32(np.stack([mu] * S)), t32(np.stack([z] * S)),
                torch.as_tensor(np.stack([zv] * S)),
                torch.as_tensor(np.stack([act] * S))]
        call = lambda **kw: tops.katana_imm_frame(timm, *args, 11.34, M,  # noqa
                                                  **kw)
    else:
        tm = tf.get_filter("lkf")
        x, P, z, zv, act = random_frame_inputs(rng, 6, 3, C, M, [0, 1, 2])
        args = [t32(np.stack([a] * S)) for a in (x, P, z)] + [
            torch.as_tensor(np.stack([a] * S)) for a in (zv, act)]
        call = lambda **kw: tops.katana_frame(tm, *args, 11.34, M, **kw)  # noqa
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(symmetrize=False)
    assert call()[0].shape == args[0].shape
