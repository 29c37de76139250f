"""The paper's stage ladder in the port (``repro_torch.core.rewrites``)
against the JAX package's (``repro.core.rewrites``), on the CPU.

Every stage of ``STAGES`` on lkf and ekf at the sizes of
``tests/test_rewrites.py`` (T = 50; N = 1 or 8): the port's
``run_sequence`` within 1e-5 of the reference's by |d| / max(1, |ref|),
or at most twice as far from the float64 oracle as the reference is (the
rule of ``test_torch_scan.py``: XLA on the CPU contracts a*b + c into
fused multiply-adds, the port does not), and within the reference test's
2e-4 of the oracle. The reference's Pallas stages run as its own tests
run them. Beside them: the block-diagonal stage equals the lanes stage,
the layout adapters round-trip, ``build_stage``'s meta and the katana
configs equal the reference's, and the plain versions of the bank
kernels at ``symmetrize=False`` (the stages' default) equal the
reference's ops there on a seed P that is not symmetric to the bit."""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import katana as jcfg
from repro.core import filters as jf
from repro.core import rewrites as jr
from repro.kernels.katana_bank import ops as jops
from repro_torch.configs import katana as tcfg
from repro_torch.core import filters as tf
from repro_torch.core import ref as oref
from repro_torch.core import rewrites as tr
from repro_torch.kernels.katana_bank import ops as tops

from _torch_inputs import replay_inputs, spd
from test_torch_scan import SLACK, TOL, rel_err

ORACLE_TOL = 2e-4  # tests/test_rewrites.py: float32 vs float64, 50 steps
SINGLE = ("baseline", "opt1", "opt2")


def _stream(model, stage, seed=0, T=50):
    """test_rewrites.py's inputs: zs (T, N, m), x0, P0 in float64."""
    rng = np.random.default_rng(seed)
    N = 1 if stage in SINGLE else 8
    zs = rng.normal(size=(T, N, model.m)) * 0.5
    x0 = np.tile(model.x0, (N, 1)) + rng.normal(size=(N, model.n)) * 0.1
    P0 = np.tile(model.P0, (N, 1, 1))
    return zs, x0, P0


def test_stage_list_and_defaults_match_reference():
    assert tr.STAGES == jr.STAGES
    for name in ("build_stage", "run_sequence", "build_baseline",
                 "build_opt1", "build_opt2", "build_batched_blockdiag",
                 "build_batched_lanes", "build_fused_scan", "build_imm_bank",
                 "build_imm_scan"):
        jp = inspect.signature(getattr(jr, name)).parameters
        tp = inspect.signature(getattr(tr, name)).parameters
        assert tp["symmetrize"].default == jp["symmetrize"].default, name
        assert list(tp)[:len(jp)] == list(jp), name
        assert tp["device"].default == "cuda", name


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
@pytest.mark.parametrize("stage", jr.STAGES)
def test_stage_matches_reference(kind, stage):
    jm, tm = jf.get_filter(kind), tf.get_filter(kind)
    zs, x0, P0 = _stream(tm, stage)
    want = np.asarray(jr.run_sequence(jm, stage, zs, x0, P0))
    got = tr.run_sequence(tm, stage, zs, x0, P0, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    exact = oref.run_batched(tm, zs, x0, P0)[0]
    e_t, e_j = rel_err(got, exact), rel_err(want, exact)
    assert rel_err(got, want) <= TOL or e_t <= SLACK * e_j, (e_t, e_j)
    np.testing.assert_allclose(got.numpy(), exact, atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_blockdiag_equals_lanes(kind):
    """The paper's batching and the lanes batching are numerical twins
    (tests/test_rewrites.py::test_blockdiag_equals_lanes)."""
    model = tf.get_filter(kind)
    rng = np.random.default_rng(1)
    T, N = 30, 16
    zs = rng.normal(size=(T, N, model.m)) * 0.5
    x0 = np.tile(model.x0, (N, 1)) + rng.normal(size=(N, model.n)) * 0.1
    P0 = np.tile(model.P0, (N, 1, 1))
    bd = tr.run_sequence(model, "batched_blockdiag", zs, x0, P0,
                         device="cpu")
    ln = tr.run_sequence(model, "batched_lanes", zs, x0, P0, device="cpu")
    np.testing.assert_allclose(bd.numpy(), ln.numpy(), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("stage", jr.STAGES)
def test_layout_adapters_round_trip(stage):
    """canonical_to_stage then stage_to_canonical gives back x and P,
    and both adapters lay the state out as the reference's do."""
    n, m = 6, 3
    N = 1 if stage in SINGLE else 5
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, n)).astype(np.float32)
    P = spd(rng, (N,), n)
    z = rng.normal(size=(N, m)).astype(np.float32)
    got = tr.canonical_to_stage(stage, *map(torch.as_tensor, (x, P, z)), n, m)
    want = jr.canonical_to_stage(stage, *map(jnp.asarray, (x, P, z)), n, m)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    back = tr.stage_to_canonical(stage, got[0], got[1], n, m, N)
    assert np.array_equal(back[0].numpy().reshape(N, n), x)
    assert np.array_equal(back[1].numpy(), P)


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
@pytest.mark.parametrize("stage", jr.STAGES)
def test_build_stage_meta_matches_reference(kind, stage):
    N = None if stage in SINGLE else 8
    _, want = jr.build_stage(jf.get_filter(kind), stage, N=N)
    step, got = tr.build_stage(tf.get_filter(kind), stage, N=N,
                               device="cpu")
    assert got == want and callable(step)


def test_unknown_stage_lists_the_stages():
    with pytest.raises(KeyError, match="batched_lanes"):
        tr.build_stage(tf.get_filter("lkf"), "opt3", N=1, device="cpu")


def test_katana_configs_match_reference():
    assert list(tcfg.ALL) == list(jcfg.ALL)
    for name, c in tcfg.ALL.items():
        assert dataclasses.asdict(c) == dataclasses.asdict(jcfg.ALL[name])
    assert tcfg.LKF_BATCHED.batch == 200 and tcfg.EKF_POD.batch == 131072


def _asym(rng, P):
    """P plus noise of 1e-3: symmetric only to rounding, not to the bit."""
    return (P + 1e-3 * rng.normal(size=P.shape)).astype(np.float32)


def _j(*a):
    return [jnp.asarray(v) for v in a]


def _t(*a):
    return [torch.as_tensor(v) for v in a]


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_full_square_bank_step_and_scan_match_reference(kind):
    """katana_bank and katana_bank_sequence at symmetrize=False, seeded
    with an asymmetric P, against the reference's ops there; the
    asymmetry is carried (False and True part)."""
    jm, tm = jf.get_filter(kind), tf.get_filter(kind)
    rng = np.random.default_rng(31)
    x0, P0, zs, _ = replay_inputs(rng, tm, 9, 12, extent=1.0)
    P0 = _asym(rng, P0)
    want = jops.katana_bank(jm, *_j(x0, P0, zs[0]), symmetrize=False)
    got = tops.katana_bank(tm, *_t(x0, P0, zs[0]), symmetrize=False)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= TOL
    assert not torch.equal(got[1], got[1].transpose(1, 2))
    sym = tops.katana_bank(tm, *_t(x0, P0, zs[0]))
    assert torch.equal(sym[1], sym[1].transpose(1, 2))
    want, jfin = jops.katana_bank_sequence(jm, *_j(zs, x0, P0),
                                           symmetrize=False,
                                           return_final=True)
    got, tfin = tops.katana_bank_sequence(tm, *_t(zs, x0, P0),
                                          symmetrize=False,
                                          return_final=True)
    for a, b in zip((got,) + tfin, (want,) + tuple(jfin)):
        assert rel_err(a, b) <= TOL
    # the struct-of-arrays layout runs symmetrize=True only
    soa = tops.katana_bank_soa(tm, *_t(x0.T, P0.transpose(1, 2, 0), zs[0].T))
    assert torch.equal(soa[0].T, sym[0])
    assert torch.equal(soa[1].permute(2, 0, 1), sym[1])


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_full_square_imm_step_matches_reference(kind):
    """katana_bank_imm at symmetrize=False, K = 1 (lkf, ekf) and K = 4
    (imm), on asymmetric P, against the reference's op there."""
    if kind == "imm":
        jimm, timm = jf.make_imm(), tf.make_imm()
    else:
        jimm = jf.as_imm(jf.get_filter(kind))
        timm = tf.as_imm(tf.get_filter(kind))
    rng = np.random.default_rng(32)
    N, K = 7, timm.K
    x0, P0, zs, _ = replay_inputs(rng, timm, N, 1, extent=1.0)
    x = (x0[None] + 0.05 * rng.normal(size=(K, N, timm.n))).astype(np.float32)
    P = _asym(rng, np.broadcast_to(P0, (K,) + P0.shape))
    want = jops.katana_bank_imm(jimm, *_j(x, P, zs[0]), symmetrize=False)
    got = tops.katana_bank_imm(timm, *_t(x, P, zs[0]), symmetrize=False)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= TOL
    assert not torch.equal(got[1], got[1].transpose(2, 3))


def test_imm_sequence_full_square_at_k1_is_the_single_model_scan():
    """K = 1 runs the single-model scan's full square (the K > 1 full
    square: tests/test_torch_full_square.py)."""
    lkf = tf.get_filter("lkf")
    x0, P0, zs, _ = _t(*replay_inputs(np.random.default_rng(34), lkf, 3, 4))
    a = tops.katana_imm_sequence(tf.as_imm(lkf), zs, x0, P0,
                                 symmetrize=False)
    b = tops.katana_bank_sequence(lkf, zs, x0, P0, symmetrize=False)
    assert torch.equal(a, b)


def test_torch_quickstart_runs_on_the_cpu():
    """examples/torch_quickstart.py with device='cpu': every stage and the
    katana_bank bank within its 1e-4 of the float64 oracle."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main("cpu") <= mod.TOL
