"""The port's float64 oracle (``repro_torch.core.ref``) and its stream
generators against the JAX package's on the same inputs: the generators
give the same arrays bit for bit, the oracles agree within 1e-12."""
import numpy as np
import pytest

from repro.core import ref as jref
from repro.data import trajectories as jtraj
from repro_torch.core import ref as tref
from repro_torch.data import trajectories as ttraj

from _torch_parity import models

TOL = 1e-12


@pytest.mark.parametrize("kind", ["lkf", "ekf", "cv9"])
@pytest.mark.parametrize("N", [1, 5])
def test_batched_targets_bitwise(kind, N):
    from repro.core.filters import get_filter as jget
    from repro_torch.core.filters import get_filter as tget

    want = jtraj.batched_targets(jget(kind), 24, N, seed=3)
    got = ttraj.batched_targets(tget(kind), 24, N, seed=3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_maneuvering_generators_bitwise(seed):
    for a, b in zip(ttraj.maneuvering_target(40, seed=seed),
                    jtraj.maneuvering_target(40, seed=seed)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttraj.maneuvering_batch(24, 5, seed=seed, seg_len=10),
                    jtraj.maneuvering_batch(24, 5, seed=seed, seg_len=10)):
        np.testing.assert_array_equal(a, b)


def _stream(kind, T, N, seed):
    jm, tm, _, _ = models(kind)
    rng = np.random.default_rng(seed)
    zs = rng.normal(size=(T, N, jm.m)) * 0.5
    x0 = np.tile(jm.x0, (N, 1)) + 0.1 * rng.normal(size=(N, jm.n))
    P0 = np.tile(jm.P0, (N, 1, 1))
    return jm, tm, zs, x0, P0


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_filter_oracle_matches_reference(kind):
    jm, tm, zs, x0, P0 = _stream(kind, 24, 5, seed=1)
    got = tref.run_batched(tm, zs, x0, P0)
    want = jref.run_batched(jm, zs, x0, P0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    for a, b in zip(tref.run(tm, zs[:, 0]), jref.run(jm, zs[:, 0])):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    xp, Pp = tref.predict(tm, x0[0], P0[0])
    for a, b in zip(tref.update(tm, xp, Pp, zs[0, 0]),
                    jref.step(jm, x0[0], P0[0], zs[0, 0])):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_imm_oracle_matches_reference_with_coasting():
    jm, tm, zs, x0, P0 = _stream("imm", 24, 5, seed=2)
    valid = np.random.default_rng(3).random((24, 5)) > 0.2
    for v in (None, valid):
        got = tref.run_imm_batched(tm, zs, x0, P0, valid=v)
        want = jref.run_imm_batched(jm, zs, x0, P0, valid=v)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    K = tm.K
    xs = np.tile(x0[0], (K, 1)) + 0.05 * np.arange(K)[:, None]
    Ps = np.tile(P0[0], (K, 1, 1))
    mu = np.array([0.4, 0.3, 0.2, 0.1])
    for has_z in (True, False):
        for a, b in zip(tref.imm_step(tm, xs, Ps, mu, zs[0, 0], has_z),
                        jref.imm_step(jm, xs, Ps, mu, zs[0, 0], has_z)):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_float32_oracle_stays_near_float64():
    """The oracle run in float32 (the yardstick of the kernels' own
    float32 error) returns float32 and stays within float32 rounding of
    the float64 run on a short stream."""
    _, tm, zs, x0, P0 = _stream("lkf", 24, 3, seed=4)
    x64 = tref.run_batched(tm, zs, x0, P0)[0]
    x32 = tref.run_batched(tm, zs, x0, P0, dtype=np.float32)[0]
    assert x32.dtype == np.float32
    np.testing.assert_allclose(x32, x64, rtol=0, atol=1e-5)
    _, tm, zs, x0, P0 = _stream("imm", 24, 3, seed=5)
    c64, mu64 = tref.run_imm_batched(tm, zs, x0, P0)
    c32, mu32 = tref.run_imm_batched(tm, zs, x0, P0, dtype=np.float32)
    assert c32.dtype == np.float32 and mu32.dtype == np.float32
    np.testing.assert_allclose(c32, c64, rtol=0, atol=1e-4)
    np.testing.assert_allclose(mu32, mu64, rtol=0, atol=1e-4)
