"""The CUDA kernels against their plain PyTorch versions on the card, on
the same CUDA tensors: identical assoc (and greedy wave count), states
within 1e-4 (IMM 5e-4), at small shapes and at the serving size
C=1024, M=256; the engine's fused route on the card against its einsum
route. Needs an NVIDIA GPU; run with

    python -m pytest -m gpu -q tests/test_torch_gpu.py
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the card's machine runs this file without PYTHONPATH=src
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import tracker as ttr  # noqa: E402
from repro_torch.core.filters import as_imm, get_filter, make_imm  # noqa: E402
from repro_torch.data.trajectories import SceneConfig, mot_scene  # noqa: E402
from repro_torch.kernels.katana_bank import ops, ref  # noqa: E402
from repro_torch.serving.engine import TrackingEngine  # noqa: E402

from _torch_inputs import random_frame_inputs  # noqa: E402

pytestmark = pytest.mark.gpu

SHAPES = [(24, 12), (200, 64), (1024, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _dev(arrays, dev):
    return [torch.as_tensor(a).to(dev) for a in arrays]


@pytest.mark.parametrize("C,M", SHAPES + [(1500, 64)])
def test_greedy_kernel_matches_plain(cuda, C, M):
    rng = np.random.default_rng(C + M)
    cost = (np.round(rng.uniform(0, 10, (C, M)) * 2) / 2).astype(np.float32)
    valid = rng.random((C, M)) > 0.3
    cost_t, valid_t = _dev((cost, valid), cuda)
    a, w = ops.katana_greedy_assign(cost_t, valid_t, 6.0, min(C, M),
                                    return_waves=True)
    b, wb = ref.greedy_assign_plain(cost_t, valid_t, 6.0, min(C, M),
                                    return_waves=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert int(w) == wb


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
@pytest.mark.parametrize("C,M", SHAPES)
def test_frame_kernel_matches_plain(cuda, kind, C, M):
    model = get_filter(kind)
    obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
    rng = np.random.default_rng(C)
    x, P, z, zv, act = _dev(random_frame_inputs(rng, model.n, model.m, C, M,
                                                obs, spread=20.0), cuda)
    gate = ttr.CHI2_99[model.m]
    got = ops.katana_frame(model, x, P, z, zv, act, gate, min(C, M))
    want = ref.katana_frame_plain(model, x, P, z, zv, act, gate, min(C, M))
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    assert int((got[2] >= 0).sum()) > 0
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("C,M", SHAPES)
def test_imm_frame_kernel_matches_plain(cuda, C, M):
    imm = make_imm()
    rng = np.random.default_rng(C + 1)
    x, P, mu, z, zv, act = _dev(random_frame_inputs(
        rng, 9, 3, C, M, [0, 1, 2], K=4, spread=20.0), cuda)
    got = ops.katana_imm_frame(imm, x, P, mu, z, zv, act, 11.34, min(C, M))
    want = ref.katana_imm_frame_plain(imm, x, P, mu, z, zv, act, 11.34,
                                      min(C, M))
    torch.cuda.synchronize()
    assert torch.equal(got[4], want[4])
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=0)


def test_imm_k1_kernel_is_the_frame_kernel(cuda):
    ekf = get_filter("ekf")
    rng = np.random.default_rng(5)
    x, P, z, zv, act = _dev(random_frame_inputs(rng, 8, 4, 300, 64,
                                                [0, 1, 2, 4]), cuda)
    a = ops.katana_frame(ekf, x, P, z, zv, act, 13.28, 64)
    b = ops.katana_imm_frame(as_imm(ekf), x[None].contiguous(),
                             P[None].contiguous(),
                             torch.ones(300, 1, device=cuda), z, zv, act,
                             13.28, 64)
    assert torch.equal(b[0][0], a[0]) and torch.equal(b[1][0], a[1])
    assert torch.equal(b[4], a[2])


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_engine_fused_route_on_card(cuda, kind):
    model = make_imm() if kind == "imm" else get_filter(kind)
    smodel = get_filter("cv9") if kind == "imm" else model
    cfg = ttr.TrackerConfig(capacity=128, max_meas=64)
    z, valid, _ = mot_scene(smodel, SceneConfig(T=40, max_targets=20,
                                                clutter_rate=3.0,
                                                max_meas=64), seed=2)
    eng = TrackingEngine(model, cfg, device="cuda")
    ops.reset_launches()
    step = ttr.imm_frame_step if kind == "imm" else ttr.frame_step
    cfg_e = dataclasses.replace(cfg, fused_frame=False)
    bank_e = eng.bank
    name = "katana_imm_frame" if kind == "imm" else "katana_frame"
    for t in range(40):
        eng.submit(z[t][valid[t]].astype(np.float32))
        vt = torch.zeros(64, dtype=torch.bool, device=cuda)
        zt = torch.zeros(64, model.m, device=cuda)
        k = int(valid[t].sum())
        zt[:k] = torch.as_tensor(z[t][valid[t]], dtype=torch.float32)
        vt[:k] = True
        res = step(model, cfg_e, bank_e, zt, vt)
        bank_e = res.bank
        assert torch.equal(eng.last.assoc, res.assoc)
        assert torch.equal(eng.bank.track_id, bank_e.track_id)
        torch.testing.assert_close(eng.bank.x, bank_e.x, rtol=0,
                                   atol=5e-4 if kind == "imm" else 1e-4)
    assert ops.LAUNCHES[name] == 40 and ops.LAUNCHES["greedy_assign"] == 40
