"""Offline replay in the port against the JAX package:
``TrackingEngine(..., device="cpu").replay`` equals the JAX engine's
``replay`` (lkf, ekf, imm), a reference ``IMMBankState`` carried across
(``convert``) replays through ``bank.replay_imm_bank`` as the reference
does, and inside the port a bank reseeded from a half-stream's finals
resumes the stream bit for bit. Replay leaves the live frames' stats and
the live bank alone. Tolerance as in ``test_torch_scan.py``: 1e-5 by
|d| / max(1, |ref|) on streams of the reference tests' scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jb
from repro.core import tracker as jtr
from repro.serving.engine import TrackingEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import bank as tb
from repro_torch.core import tracker as ttr
from repro_torch.kernels.katana_bank import ops as tops
from repro_torch.serving.engine import TrackingEngine

from _torch_inputs import replay_inputs
from _torch_parity import models, np_
from test_torch_scan import EXTENT, assert_rel

CFG_J = jtr.TrackerConfig(capacity=16, max_meas=8)
CFG_T = ttr.TrackerConfig(capacity=16, max_meas=8)


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_engine_replay_matches_jax(kind):
    jm, tm, _, _ = models(kind)
    _, _, zs, _ = replay_inputs(np.random.default_rng(12), tm, 5, 24,
                                extent=EXTENT)
    ej = JaxEngine(jm, CFG_J)
    et = TrackingEngine(tm, CFG_T, device="cpu")
    et.submit(zs[0, :3])
    frames, bank_x = et.stats.frames, et.bank.x.clone()
    want = ej.replay(zs)
    got = et.replay(zs)
    assert got.shape == (24, 5, tm.n) and got.dtype == np.float32
    assert_rel(got, want)
    assert et.stats.replay_frames == 24 and et.stats.replay_fps > 0
    assert et.stats.frames == frames == 1
    assert torch.equal(et.bank.x, bank_x)
    # explicit seeds go through unchanged
    x0 = np.tile(tm.x0, (5, 1)).astype(np.float32) + 0.5
    P0 = np.tile(tm.P0, (5, 1, 1)).astype(np.float32)
    assert_rel(et.replay(zs, x0, P0), ej.replay(zs, x0, P0))
    assert et.stats.replay_frames == 48


def _mode_bank(rng, imm, C):
    """Mode-conditioned numpy bank contents: x (K, C, n), P (K, C, n, n),
    mu (C, K)."""
    K, n = imm.K, imm.n
    x = (np.tile(imm.x0, (K, C, 1)) + 0.3 * rng.normal(size=(K, C, n)))
    P = np.tile(imm.P0, (K, C, 1, 1)) * rng.uniform(0.5, 2.0, (K, C, 1, 1))
    mu = rng.dirichlet(np.ones(K), size=C)
    return (x.astype(np.float32), P.astype(np.float32),
            mu.astype(np.float32))


def test_reference_bank_replays_through_replay_imm_bank():
    """A JAX IMMBankState converted to the port replays (with a coasting
    mask) as the reference's replay_imm_bank does, and the live bank is
    unchanged."""
    jimm, timm, _, _ = models("imm")
    C, T = 3, 12
    rng = np.random.default_rng(13)
    x, P, mu = _mode_bank(rng, timm, C)
    _, _, zs, valid = replay_inputs(rng, timm, C, T, drop=0.2, extent=EXTENT)
    jbank = jb.init_imm_bank(jimm, C)._replace(
        x=jnp.asarray(x), P=jnp.asarray(P), mu=jnp.asarray(mu))
    tbank = convert.bank_from_numpy(jbank, device="cpu")
    want, jfin = jb.replay_imm_bank(jimm, jbank, jnp.asarray(zs),
                                    jnp.asarray(valid), return_final=True)
    got, tfin = tb.replay_imm_bank(timm, tbank, torch.as_tensor(zs),
                                   torch.as_tensor(valid), return_final=True)
    for a, b in zip((got,) + tfin, (want,) + tuple(jfin)):
        assert_rel(a, b)
    assert torch.equal(tbank.x, torch.as_tensor(x))
    assert torch.equal(tbank.mu, torch.as_tensor(mu))


def test_replay_imm_bank_resumes_bitwise():
    """Half a stream, a bank reseeded from its finals, then the rest
    through replay_imm_bank: the same bits as the whole stream in one
    call (as test_imm_scan.py:178 holds the reference)."""
    imm = models("imm")[1]
    C, T = 4, 24
    x0, P0, zs, valid = (torch.as_tensor(a) for a in replay_inputs(
        np.random.default_rng(14), imm, C, T, drop=0.1))
    whole = tops.katana_imm_sequence(imm, zs, x0, P0, valid=valid)
    _, (xh, Ph, muh) = tops.katana_imm_sequence(
        imm, zs[:T // 2], x0, P0, valid=valid[:T // 2], return_final=True)
    bank = tb.init_imm_bank(imm, C, device="cpu")._replace(x=xh, P=Ph,
                                                          mu=muh)
    rest = tb.replay_imm_bank(imm, bank, zs[T // 2:], valid[T // 2:])
    assert torch.equal(rest, whole[T // 2:])
    assert np.isfinite(np_(rest)).all()


@pytest.mark.parametrize("kind", ["lkf", "imm"])
def test_replay_span_ends_before_the_copy_back(kind, monkeypatch):
    """``stats.replay_latency_s`` spans the copy of zs in and the stream,
    as the reference's span ends at ``block_until_ready``; the copy of
    the states back to the host comes after it. A patched clock moves 1 s
    inside the stream and 100 s inside the copy back."""
    from repro_torch.serving import engine as eng_mod

    now = [0.0]
    monkeypatch.setattr(eng_mod.time, "perf_counter", lambda: now[0])

    class Out:
        def __init__(self, t):
            self.t = t

        def cpu(self):
            now[0] += 100.0
            return self.t

    name = "katana_imm_sequence" if kind == "imm" else "katana_bank_sequence"
    real = getattr(eng_mod, name)

    def stream(*args, **kw):
        now[0] += 1.0
        return Out(real(*args, **kw))

    monkeypatch.setattr(eng_mod, name, stream)
    tm = models(kind)[1]
    _, _, zs, _ = replay_inputs(np.random.default_rng(15), tm, 3, 6,
                                extent=EXTENT)
    et = TrackingEngine(tm, CFG_T, device="cpu")
    got = et.replay(zs)
    assert got.shape == (6, 3, tm.n) and got.dtype == np.float32
    assert et.stats.replay_latency_s == 1.0
    assert et.stats.replay_fps == 6.0
