"""The IMM scan on a lane whose float32 arithmetic decides its fate.

``tests/data/imm_scan_lane.npz`` holds one lane of the imm fleet replay
(``scripts/fleet_nan_probe.py --frames 100``): a mode-conditioned bank
seed (x0 (4, 1, 9), P0 (4, 1, 9, 9), mu0 (4,)) with three modes' P down
to 1e-9 and |x| near 190, then 300 frames of an unrelated replay lane,
30% of them coasting. The lane runs far from its measurements (|x|
reaches about 2,800 by frame 10), the modes' means drift ~10^3 apart,
and the mixing's spread term sum_i w x~x~^T - m~m~^T then cancels terms
of ~10^6 whose float32 ulp (0.06) dwarfs P.

The port's plain version goes non-finite there from frame 53. The tests
below show that this is the reference's own float32 order and not a
departure of the port: a float32 numpy replica that runs the reference
kernel's emitters (``repro/kernels/katana_bank/kernel.py``:
``_emit_imm_mix``, ``_emit_matvec``, ``_emit_predict_cov``,
``_emit_update``, ``_emit_mode_posterior``) with numpy in jnp's place and
the scan body of ``_imm_scan_kernel`` written out gives the port's
combined estimates bit for bit over all 300 frames, the NaNs from frame
53 included; and one ulp moved in one entry of the seed sends that same
arithmetic finite through all 300 frames, or non-finite from frame 16
(where the kernel on the card goes), or from frame 46. The reference's
``katana_imm_sequence`` on the CPU stays finite because XLA contracts
a*b + c into fused multiply-adds, which round differently (a gap the
port keeps on purpose: its kernels build with ``--fmad=false`` to stay
bit for bit with their plain versions).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import filters as rf
from repro.kernels.katana_bank import kernel as rk
from repro_torch.core import filters as tf
from repro_torch.kernels.katana_bank import ops

LANE = Path(__file__).resolve().parent / "data" / "imm_scan_lane.npz"


def _lane():
    d = np.load(LANE)
    return {k: d[k] for k in ("x0", "P0", "mu0", "zs", "valid")}


class _NumpyWithTorchTranscendentals:
    """numpy in jnp's place, with exp and log taken from torch (the port's
    plain version's last bits): the replica then differs from the port
    only where the order of operations differs."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def exp(a):
        return torch.exp(torch.from_numpy(np.asarray(a))).numpy()

    @staticmethod
    def log(a):
        return torch.log(torch.from_numpy(np.asarray(a))).numpy()


def _replica(x0, P0, mu0, zs, valid):
    """The reference's IMM scan (K > 1, symmetrize=True, with a valid
    stream) in float32 numpy, through the reference kernel's own
    emitters. x0 (K, N, n), P0 (K, N, n, n), mu0 (N, K), zs (T, N, m),
    valid (T, N) bool. Returns the combined estimates (T, N, n)."""
    imm = rf.make_imm()
    models = imm.models
    K, N, n = x0.shape
    m = models[0].m
    obs = rk._check_selector(models[0])
    entries, V = rk.plan_imm_tables(models)
    Pi = [[float(v) for v in row] for row in np.asarray(imm.trans)]
    f32 = np.float32
    L = K * N
    # ops.py: an invalid frame's measurement is zeroed before the kernel
    zs = np.where(valid[:, :, None], zs, 0.0).astype(f32)
    mu = mu0.T.reshape(L).astype(f32)
    xv = [x0[:, :, i].reshape(L).astype(f32) for i in range(n)]
    P = [[P0[:, :, i, j].reshape(L).astype(f32) for j in range(n)]
         for i in range(n)]
    tabv = [np.concatenate([np.full((N,), float(v), f32) for v in row])
            for row in V]
    Ft, Qt, Rt = (rk._resolve_mat(entries[nm], tabv)
                  for nm in ("F", "Q", "R"))
    out = []
    for t in range(zs.shape[0]):
        z = [np.concatenate([zs[t, :, r]] * K) for r in range(m)]
        x_mix, P_mix, cbar = rk._emit_imm_mix(xv, P, mu, Pi, n, K, N, True)
        xp = rk._emit_matvec(Ft, x_mix, n)
        Pp = rk._emit_predict_cov(Ft, P_mix, Qt, n, True)
        xn, Pn, ll = rk._emit_update(xp, Pp, z, Rt, obs, n, m, True, True)
        mu_parts = rk._emit_mode_posterior(cbar, ll, K, N)
        # the coasting select and the combined estimate of kernel.py's
        # scan body, as written there
        v = valid[t].astype(f32)
        vL = np.concatenate([v] * K)
        nvL = 1.0 - vL
        xn = [vL * a + nvL * b for a, b in zip(xn, xp)]
        Pc = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(i, n):
                Pc[i][j] = Pc[j][i] = vL * Pn[i][j] + nvL * Pp[i][j]
        nv = 1.0 - v
        mu_parts = [v * a + nv * b for a, b in zip(mu_parts, cbar)]
        xv = [rk._bc(u, mu) for u in xn]
        P = [[rk._bc(u, mu) for u in row] for row in Pc]
        mu = np.concatenate(mu_parts)
        xc = [rk._emit_dot(mu_parts, [u[k * N:(k + 1) * N]
                                      for k in range(K)], K) for u in xv]
        out.append(np.stack([np.asarray(c) for c in xc], -1))
    return np.stack(out)


@pytest.fixture
def reference_order(monkeypatch):
    """_replica with numpy (and torch's exp / log) in the reference
    kernel's jnp."""
    monkeypatch.setattr(rk, "jnp", _NumpyWithTorchTranscendentals())

    def run(x0, P0, mu0, zs, valid):
        with np.errstate(all="ignore"):
            return _replica(x0, P0, mu0[None], zs[:, None],
                            valid[:, None])[:, 0]

    return run


def _first_non_finite(xs):
    bad = np.nonzero(~np.isfinite(xs).all(-1))[0]
    return int(bad[0]) if len(bad) else None


def _port(x0, P0, mu0, zs, valid):
    imm = tf.as_imm(tf.make_imm())
    xs = ops.katana_imm_sequence(
        imm, torch.from_numpy(zs[:, None].copy()), torch.from_numpy(x0),
        torch.from_numpy(P0), mu0=torch.from_numpy(mu0[None].copy()),
        valid=torch.from_numpy(valid[:, None].copy()))
    return xs.numpy()[:, 0]


def test_reference_order_is_the_port_bit_for_bit(reference_order):
    """Tolerance: none. The reference's order in float32 is the port's
    plain version bit for bit over all 300 frames, both non-finite from
    frame 53."""
    lane = _lane()
    port = _port(**lane)
    replica = reference_order(**lane)
    np.testing.assert_array_equal(replica, port)
    assert _first_non_finite(port) == 53
    assert _first_non_finite(replica) == 53


@pytest.mark.parametrize("mode,entry,first", [
    (0, 0, None), (2, 1, None), (1, 1, 16), (3, 0, 16), (1, 0, 46)])
def test_reference_order_fate_turns_on_one_ulp(reference_order, mode, entry,
                                               first):
    """One ulp up in one entry of x0 (mode, entry) sends the reference's
    float32 order finite through all 300 frames, or non-finite from
    another frame: the lane's fate is set by rounding, not by an op the
    port computes differently."""
    lane = _lane()
    x0 = lane["x0"].copy()
    x0[mode, 0, entry] = np.nextafter(x0[mode, 0, entry], np.float32(np.inf))
    xs = reference_order(**{**lane, "x0": x0})
    assert _first_non_finite(xs) == first
