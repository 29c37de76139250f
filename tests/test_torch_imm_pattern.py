"""The compile-time constant patterns of the tracking kernels, on the host.

``ops.instantiated_patterns`` reads the patterns that imm_step.cu (the
IMM and single-model bank steps), scan.cu, imm_scan.cu, frame.cu and
imm_frame.cu are built for from csrc/pruned.cuh; ``ops.imm_pattern``
derives a model set's pattern as the plain version folds its constants
(``ref.plan_imm_tables``); ``ops.pick_pattern`` chooses the
instantiation a launch runs. The kernel may skip only terms the plain
version skips, so the chosen pattern's pruned zeros and elided 1.0s must
lie inside the model set's. All numpy: no card needed.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import filters as jfilters
from repro.kernels.katana_bank import kernel as jkernel
from repro_torch.core import filters
from repro_torch.kernels import build
from repro_torch.kernels.katana_bank import ops, ref


def _shared(entries, name, value):
    """Where the folded table holds the float ``value`` (not a varying
    ("var", e) entry)."""
    return np.array([[isinstance(c, float) and c == value for c in row]
                     for row in entries[name]], bool)


def _by_name():
    return {p.name: p for p in ops.instantiated_patterns()}


def _other_imm():
    """make_imm() with a CV9 whose acceleration rows are not zero, one of
    them in a slot (F[6][0]) that every make_imm() member has zero."""
    cv9 = filters.make_cv9_lkf(dt=0.05)
    F = cv9.F.copy()
    F[6:9, 6:9] = 0.9 * np.eye(3)
    F[6, 0] = 0.01
    imm = filters.make_imm()
    return filters.IMMModel(
        name="imm-other", models=(dataclasses.replace(cv9, F=F),)
        + imm.models[1:], trans=imm.trans, mu0=imm.mu0)


def test_instantiated_patterns_parse():
    pats = ops.instantiated_patterns()
    assert [p.id for p in pats] == list(range(len(pats)))
    assert len({p.name for p in pats}) == len(pats)
    shapes = {(p.n, p.m) for p in pats}
    assert shapes == {(6, 3), (8, 4), (9, 3)}
    for p in pats:
        assert p.masks["fz"].shape == p.masks["f1"].shape == (p.n, p.n)
        assert p.masks["qz"].shape == (p.n, p.n)
        assert p.masks["rz"].shape == (p.m, p.m)
        # a 1.0 that is elided is not a zero that is pruned, and every
        # row of F keeps a term (pruned.cuh's static_assert)
        assert not np.any(p.masks["fz"] & p.masks["f1"])
        assert not np.any(p.masks["fz"].all(axis=1))


@pytest.mark.parametrize("shape", [(6, 3), (8, 4), (9, 3)])
def test_every_shape_has_a_dense_instantiation(shape):
    dense = [p for p in ops.instantiated_patterns()
             if (p.n, p.m) == shape and not any(v.any()
                                                 for v in p.masks.values())]
    assert len(dense) == 1


def test_make_imm_pattern_is_the_plain_versions_shared_constants():
    entries, _ = ref.plan_imm_tables(filters.make_imm().models)
    imm9 = _by_name()["imm9"]
    for mask, name, value in (("fz", "F", 0.0), ("f1", "F", 1.0),
                              ("qz", "Q", 0.0), ("rz", "R", 0.0)):
        np.testing.assert_array_equal(imm9.masks[mask],
                                      _shared(entries, name, value))
    # 22 of F's 81 entries kept, as the kernels' source notes say
    assert int((~imm9.masks["fz"]).sum()) == 22


def test_make_imm_pattern_is_the_jax_references_folding():
    """The JAX package folds its make_imm() the same way
    (repro.kernels.katana_bank.kernel.plan_imm_tables)."""
    entries, _ = jkernel.plan_imm_tables(jfilters.make_imm().models)
    imm9 = _by_name()["imm9"]
    for mask, name, value in (("fz", "F", 0.0), ("f1", "F", 1.0),
                              ("qz", "Q", 0.0), ("rz", "R", 0.0)):
        np.testing.assert_array_equal(imm9.masks[mask],
                                      _shared(entries, name, value))


def test_make_imm_runs_its_own_pattern():
    imm = filters.make_imm()
    pick = ops.pick_pattern(imm.models)
    assert pick.name == "imm9"
    want = ops.imm_pattern(imm.models)
    for k in ops.MASKS:
        np.testing.assert_array_equal(pick.masks[k], want[k])


@pytest.mark.parametrize("omega,dt", [(0.7, 1 / 30), (0.3, 0.05),
                                      (-1.2, 0.1)])
def test_other_turn_rates_and_steps_keep_the_pattern(omega, dt):
    """Other values in the same slots: the same zeros, the same pattern."""
    imm = filters.make_imm(dt=dt, omega=omega)
    assert ops.pick_pattern(imm.models).name == "imm9"


def test_a_nonzero_in_a_pruned_slot_selects_the_dense_instantiation():
    imm = _other_imm()
    want = ops.imm_pattern(imm.models)
    assert not want["fz"][6, 0]
    assert _by_name()["imm9"].masks["fz"][6, 0]
    assert ops.pick_pattern(imm.models).name == "dense9"


def test_a_shared_one_that_differs_selects_the_dense_instantiation():
    """imm9 elides F[5][5]: a member with another value there is not
    covered, though every zero still is."""
    imm = filters.make_imm()
    ca9 = imm.models[1]
    F = ca9.F.copy()
    F[5, 5] = 0.99
    models = (imm.models[0], dataclasses.replace(ca9, F=F)) + imm.models[2:]
    want = ops.imm_pattern(models)
    assert not want["f1"][5, 5] and not want["fz"][5, 5]
    assert ops.pick_pattern(models).name == "dense9"


@pytest.mark.parametrize("kind", ["lkf", "cv9", "ca9"])
def test_single_linear_models_map_to_their_own_pattern(kind):
    """K = 1: every entry is shared, so the pattern is the model's own
    zeros and ones."""
    mdl = filters.get_filter(kind)
    want = ops.imm_pattern((mdl,))
    F, Q, R = (np.asarray(getattr(mdl, nm)) for nm in ("F", "Q", "R"))
    np.testing.assert_array_equal(want["fz"], F == 0)
    np.testing.assert_array_equal(want["f1"], F == 1)
    np.testing.assert_array_equal(want["qz"], Q == 0)
    np.testing.assert_array_equal(want["rz"], R == 0)
    pick = ops.pick_pattern((mdl,))
    for k in ops.MASKS:
        assert np.all(pick.masks[k] <= want[k]), (kind, k)
    assert pick.name == {"lkf": "cv6", "cv9": "imm9", "ca9": "imm9"}[kind]


def test_cv6_parses():
    """The CV6 LKF's pattern: the identity and dt at (0,3), (1,4), (2,5)
    kept, the six 1.0s elided, Q's diagonal and (i, i+3) pairs, R's
    diagonal."""
    cv6 = _by_name()["cv6"]
    assert (cv6.n, cv6.m) == (6, 3)
    kept = np.eye(6, dtype=bool)
    for i in range(3):
        kept[i, i + 3] = True
    np.testing.assert_array_equal(cv6.masks["fz"], ~kept)
    np.testing.assert_array_equal(cv6.masks["f1"], np.eye(6, dtype=bool))
    np.testing.assert_array_equal(cv6.masks["qz"], ~(kept | kept.T))
    np.testing.assert_array_equal(cv6.masks["rz"], ~np.eye(3, dtype=bool))


def test_the_cv6_lkf_runs_its_own_pattern():
    """pick_pattern((lkf,)) is cv6, whose masks are CV6's F == 0, F == 1,
    Q == 0 and R == 0, and the JAX reference's folding of its lkf."""
    lkf = filters.get_filter("lkf")
    pick = ops.pick_pattern((lkf,))
    assert pick.name == "cv6"
    F, Q, R = (np.asarray(getattr(lkf, nm)) for nm in ("F", "Q", "R"))
    for mask, want in (("fz", F == 0), ("f1", F == 1), ("qz", Q == 0),
                       ("rz", R == 0)):
        np.testing.assert_array_equal(pick.masks[mask], want)
    entries, _ = jkernel.plan_imm_tables((jfilters.get_filter("lkf"),))
    for mask, name, value in (("fz", "F", 0.0), ("f1", "F", 1.0),
                              ("qz", "Q", 0.0), ("rz", "R", 0.0)):
        np.testing.assert_array_equal(pick.masks[mask],
                                      _shared(entries, name, value))


def test_the_ctra8_ekf_maps_to_its_jacobians_pattern():
    ekf = filters.get_filter("ekf")
    want = ops.imm_pattern((ekf,))
    n = ekf.n
    kept = np.eye(n, dtype=bool)
    for i, j in ops.CTRA8_JACOBIAN:
        kept[i, j] = True
    np.testing.assert_array_equal(want["fz"], ~kept)
    np.testing.assert_array_equal(want["f1"], np.eye(n, dtype=bool))
    np.testing.assert_array_equal(want["qz"], np.asarray(ekf.Q) == 0)
    pick = ops.pick_pattern((ekf,))
    assert pick.name == "ctra8"
    for k in ops.MASKS:
        np.testing.assert_array_equal(pick.masks[k], want[k])


def test_the_jacobian_slots_are_the_plain_versions():
    """ops.CTRA8_JACOBIAN names the non-zero slots that
    ref._predict_single builds besides the identity."""
    ekf = filters.get_filter("ekf")
    import torch
    xv = [torch.full((1,), 0.3 + 0.1 * i) for i in range(ekf.n)]
    P = [[torch.zeros(1) for _ in range(ekf.n)] for _ in range(ekf.n)]
    F_seen = {}
    real = ref._predict_cov

    def spy(F, P_, Q, n, *rest):
        F_seen["F"] = F
        return real(F, P_, Q, n, *rest)

    ref._predict_cov = spy
    try:
        ref._predict_single(ekf, xv, P)
    finally:
        ref._predict_cov = real
    F = F_seen["F"]
    slots = {(i, j) for i in range(ekf.n) for j in range(ekf.n)
             if i != j and not ref._is_zero(F[i][j])}
    assert slots == set(ops.CTRA8_JACOBIAN)


def test_an_unbuilt_shape_raises():
    mdl = filters.get_filter("lkf")
    big = dataclasses.replace(mdl, n=7, F=np.eye(7), Q=np.eye(7),
                              H=np.eye(3, 7), x0=np.zeros(7), P0=np.eye(7))
    with pytest.raises(NotImplementedError):
        ops.pick_pattern((big,))


class _RecordingLib:
    """Stands in for a kernel library: records each C entry's arguments
    and returns success without launching."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.mark.parametrize("kind", ["lkf", "ekf", "cv9"])
def test_the_frame_and_the_scan_launch_their_models_pattern(kind,
                                                            monkeypatch):
    """katana_frame and katana_bank_sequence hand their C entries (csrc/
    frame.cu, scan.cu) the id of ``pick_pattern((model,))``, the model's
    F, Q, R as float32 in host memory (copied into the launches'
    parameters) and its nonlinear flag and dt: the wrappers' host side,
    against a library that records its arguments."""
    mdl = filters.get_filter(kind)
    lib = _RecordingLib()
    monkeypatch.setattr(build, "load", lambda source: lib)
    monkeypatch.setattr(build, "on_cuda", lambda t: True)
    monkeypatch.setattr(build, "stream_of", lambda device: 0)
    n, m, C, M, T = mdl.n, mdl.m, 5, 3, 4
    ops.katana_frame(mdl, torch.zeros(C, n), torch.zeros(C, n, n),
                     torch.zeros(M, m), torch.ones(M, dtype=torch.bool),
                     torch.ones(C, dtype=torch.bool), 9.0, 3)
    ops.katana_bank_sequence(mdl, torch.zeros(T, C, m), torch.zeros(C, n),
                             torch.zeros(C, n, n))
    pattern = ops.pick_pattern((mdl,))
    assert (pattern.n, pattern.m) == (n, m)
    frame = lib.calls["katana_frame_run"]
    scan = lib.calls["katana_bank_scan_run"]
    assert frame[:5] == (n, m, pattern.id, C, M)
    assert scan[:5] == (n, m, pattern.id, C, T)
    want = np.concatenate([np.asarray(getattr(mdl, nm), np.float32).ravel()
                           for nm in ("F", "Q", "R")])
    for consts, flags in ((frame[10], frame[11:13]),
                          (scan[9], scan[10:12])):
        got = np.ctypeslib.as_array(
            (ctypes.c_float * want.size).from_address(consts))
        np.testing.assert_array_equal(got, want)
        assert flags == (int(not mdl.is_linear), float(mdl.dt))
