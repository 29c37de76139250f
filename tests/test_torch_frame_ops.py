"""The kernel wrappers' plain versions (what a CPU tensor runs) against
the JAX package: the greedy assignment equals ``tracker.greedy_assign``
exactly, ties and invalid padding included; the candidate-list greedy
(``ref.greedy_candidates``, the kernels' schedule) gives the tile
schedule's (``ref.greedy_waves``) assoc and wave count and the JAX
greedy_assign_step's assoc; and the fused frames match
``ops.katana_frame`` / ``katana_imm_frame`` (identical assoc, states
within 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tracker as jtr
from repro.kernels.katana_bank import ops as jops
from repro_torch.kernels.katana_bank import ops as tops
from repro_torch.kernels.katana_bank import ref as tref

from _torch_inputs import random_frame_inputs
from _torch_parity import models, np_, t32


@pytest.mark.parametrize("seed", range(25))
def test_greedy_matches_reference_with_ties(seed):
    rng = np.random.default_rng(seed)
    C, M = int(rng.integers(1, 10)), int(rng.integers(1, 10))
    cost = (np.round(rng.uniform(0, 10, (C, M)) * 2) / 2).astype(np.float32)
    valid = rng.random((C, M)) > 0.3
    gate = float(rng.integers(2, 9))
    rounds = min(C, M)
    ref = np.asarray(jtr.greedy_assign(jnp.asarray(cost), jnp.asarray(valid),
                                       jnp.asarray(gate), rounds))
    got = tops.katana_greedy_assign(t32(cost), torch.as_tensor(valid), gate,
                                    rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), ref)


@pytest.mark.parametrize("seed", range(25))
def test_greedy_invalid_padding(seed):
    rng = np.random.default_rng(1000 + seed)
    C, M = int(rng.integers(1, 7)), int(rng.integers(1, 7))
    pad_c, pad_m = int(rng.integers(0, 6)), int(rng.integers(0, 6))
    gate = 8.0
    cost = rng.uniform(0, 10, (C, M)).astype(np.float32)
    valid = rng.random((C, M)) > 0.3
    ref = np.asarray(jtr.greedy_assign(jnp.asarray(cost), jnp.asarray(valid),
                                       jnp.asarray(gate), min(C, M)))
    cost_p = rng.uniform(0, 1, (C + pad_c, M + pad_m)).astype(np.float32)
    cost_p[:C, :M] = cost
    valid_p = np.zeros((C + pad_c, M + pad_m), bool)
    valid_p[:C, :M] = valid
    got = np_(tops.katana_greedy_assign(t32(cost_p), torch.as_tensor(valid_p),
                                        gate, min(C + pad_c, M + pad_m)))
    np.testing.assert_array_equal(got[:C], ref)
    assert (got[C:] == -1).all()


def test_greedy_nan_cost_is_gated_out():
    cost = np.array([[np.nan, 1.0], [0.5, np.nan]], np.float32)
    valid = np.ones((2, 2), bool)
    ref = np.asarray(jtr.greedy_assign(jnp.asarray(cost), jnp.asarray(valid),
                                       jnp.asarray(5.0), 2))
    got = np_(tops.katana_greedy_assign(t32(cost), torch.as_tensor(valid),
                                        5.0, 2))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [1, 0])


def _greedy_case(name):
    """(cost (C, M) float32, valid (C, M) bool, gate, rounds) of a named
    edge case of the candidate-list greedy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    C, M = 9, 7
    cost = (np.round(rng.uniform(0, 10, (C, M)) * 2) / 2).astype(np.float32)
    valid = rng.random((C, M)) > 0.3
    gate, rounds = 6.0, min(C, M)
    if name == "nan":
        cost[rng.random((C, M)) < 0.3] = np.nan
    elif name == "signed_zero":
        cost = np.where(rng.random((C, M)) < 0.5, 0.0,
                        rng.choice([-1.0, 1.0], (C, M))).astype(np.float32)
        cost[rng.random((C, M)) < 0.4] *= -1.0  # -0.0 among the zeros
        assert np.signbit(cost[cost == 0]).any()
    elif name == "padding":
        valid[:, 5:] = False  # measurements past the real ones
        valid[6:] = False     # inactive slots
        cost[6:] = 0.0        # the cheapest entries, none of them valid
    elif name == "nothing_gated":
        cost += 7.0
    elif name == "dense":
        C, M = 40, 30
        cost = rng.uniform(0, 10, (C, M)).astype(np.float32)
        valid = np.ones((C, M), bool)
        gate, rounds = 1e30, min(C, M)
    elif name == "rounds_cut":
        rounds = 2
    return cost, valid, gate, rounds


@pytest.mark.parametrize("name", ["ties", "nan", "signed_zero", "padding",
                                  "nothing_gated", "dense", "rounds_cut"])
def test_candidate_greedy_matches_the_tile_schedule_and_the_pallas_step(
        name):
    cost, valid, gate, rounds = _greedy_case(name)
    masked = tref.gate_mask(t32(cost).T, torch.as_tensor(valid).T, gate)
    got, waves = tref.greedy_candidates(masked, rounds)
    want, want_waves = tref.greedy_waves(masked, rounds)
    assert torch.equal(got, want) and waves == want_waves
    pallas = np.asarray(jops.katana_greedy_assign(
        jnp.asarray(cost), jnp.asarray(valid), gate=gate, rounds=rounds))
    np.testing.assert_array_equal(np_(got), pallas)
    plain, plain_waves = tops.katana_greedy_assign(
        t32(cost), torch.as_tensor(valid), gate, rounds, return_waves=True)
    assert torch.equal(plain, got) and plain_waves == waves
    if name == "nothing_gated":
        assert (np_(got) == -1).all() and waves == 1
    if name == "rounds_cut":
        assert waves == 2 and tref.greedy_waves(masked, 7)[1] > 2
    if name == "dense":
        assert (np_(got) >= 0).sum() == 30


@pytest.mark.parametrize("kind,seed", [("lkf", 0), ("lkf", 1), ("ekf", 2),
                                       ("ekf", 3)])
def test_plain_frame_matches_reference(kind, seed):
    jm, tm, _, _ = models(kind)
    rng = np.random.default_rng(seed)
    obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
    x, P, z, zv, act = random_frame_inputs(rng, jm.n, jm.m, 24, 12, obs)
    gate = 11.34 if jm.m == 3 else 13.28
    jx, jP, ja = jops.katana_frame(jm, jnp.asarray(x), jnp.asarray(P),
                                   jnp.asarray(z), jnp.asarray(zv),
                                   jnp.asarray(act), gate=gate, rounds=12)
    before = dict(tops.LAUNCHES)
    tx, tP, ta = tops.katana_frame(tm, t32(x), t32(P), t32(z),
                                   torch.as_tensor(zv), torch.as_tensor(act),
                                   gate, 12)
    assert tops.LAUNCHES == before  # the CPU runs no kernel
    np.testing.assert_array_equal(np_(ta), np.asarray(ja))
    assert (np_(ta) >= 0).sum() >= 3  # the gate really passed some pairs
    np.testing.assert_allclose(np_(tx), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(np_(tP), np.asarray(jP), atol=1e-5)


@pytest.mark.parametrize("seed", [0])
def test_plain_imm_frame_matches_reference(seed):
    jimm, timm, _, _ = models("imm")
    rng = np.random.default_rng(seed)
    x, P, mu, z, zv, act = random_frame_inputs(rng, 9, 3, 20, 10, [0, 1, 2],
                                               K=4)
    args = (jnp.asarray(x), jnp.asarray(P), jnp.asarray(mu), jnp.asarray(z),
            jnp.asarray(zv), jnp.asarray(act))
    jout = jops.katana_imm_frame(jimm, *args, gate=11.34, rounds=10)
    tout = tops.katana_imm_frame(timm, t32(x), t32(P), t32(mu), t32(z),
                                 torch.as_tensor(zv), torch.as_tensor(act),
                                 11.34, 10)
    np.testing.assert_array_equal(np_(tout[4]), np.asarray(jout[4]))
    assert (np_(tout[4]) >= 0).sum() >= 3
    for a, b in zip(jout[:4], tout[:4]):
        np.testing.assert_allclose(np_(b), np.asarray(a), atol=1e-5)


def test_plain_imm_frame_k1_is_the_single_frame():
    from repro_torch.core.filters import as_imm, get_filter

    ekf = get_filter("ekf")
    rng = np.random.default_rng(4)
    x, P, z, zv, act = random_frame_inputs(rng, 8, 4, 16, 8, [0, 1, 2, 4])
    a = tops.katana_frame(ekf, t32(x), t32(P), t32(z), torch.as_tensor(zv),
                          torch.as_tensor(act), 13.28, 8)
    b = tops.katana_imm_frame(as_imm(ekf), t32(x)[None], t32(P)[None],
                              torch.ones(16, 1), t32(z), torch.as_tensor(zv),
                              torch.as_tensor(act), 13.28, 8)
    assert torch.equal(b[0][0], a[0]) and torch.equal(b[1][0], a[1])
    assert torch.equal(b[4], a[2]) and torch.equal(b[3], a[0])
    assert torch.equal(b[2], torch.ones(16, 1))


def test_wrappers_refuse_unsupported_models_and_devices():
    from repro_torch.core.filters import make_cv_lkf
    import dataclasses

    lkf = make_cv_lkf()
    H = np.asarray(lkf.H).copy()
    H[0, 3] = 0.5
    general = dataclasses.replace(lkf, H=H)
    assert not tops.frame_kernel_supported(general)
    assert tops.frame_kernel_supported(lkf)
    with pytest.raises(NotImplementedError):
        tops._check_model(general)
    x = torch.zeros(4, 6, device="meta")
    with pytest.raises(ValueError, match="device"):
        tops.katana_frame(lkf, x, x, x, x, x, 1.0, 1)
