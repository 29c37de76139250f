"""The CUDA kernels against their plain PyTorch versions on the card, on
the same CUDA tensors: identical assoc (and greedy wave count, also on
tiles with C > 1024, M = 0, nothing gated, dense, sparse, signed zeros
and NaN, and a rounds cut); the single-model and the IMM frames bit for
bit, at small shapes and at the serving size C=1024, M=256 (also C not
a multiple of a block's tracks, every track inactive, no valid
measurement, one measurement, the IMM frame's dense instantiation), and
the events they record around each launch; the engine's fused route on
the card against its einsum route; the jitted trackers' CUDA graphs (one
capture, every frame bit for bit with the eager frame step, launches
counted a replay, results not overwritten by the next replay). The frames over S stacked sensors
(S = 1, 3, 8 and a ragged C = 13 at S = 3; K = 4 and K = 1 for the IMM
frame) bit for bit with their plain versions and with S single-sensor
calls, one launch count a call; ``ShardedBankEngine`` on the card (one
shard, and two shards on the one card) against the CPU fleet. The replay scans and the per-frame
bank steps against their plain versions bit for bit at (N, T) = (5, 17)
and (1024, 300), at ragged N and with a valid stream (the steps in both
layouts), the properties that hold bit for bit (K=1 IMM = single-model
scan, time chunks = one launch, T steps = the scan), and
``TrackingEngine.replay`` on the card against the CPU. The same scans
and steps at symmetrize=False (the full square, csrc's Sym = false) bit
for bit with their plain versions on asymmetric seeds, and every stage
of the paper's ladder (``core/rewrites.py``) on the card against the
CPU. The LM kernels (flash_attention, flash_decode) against their plain
versions in float32 (2e-5; 1e-5/1e-4) and bfloat16 (one bf16 ulp of the
output), and a reduced h2o-danube-1.8b served on the card through both
kernels against the torch-op routes; the bf16 tensor-core attention at
every head dim and at the tile, window and ragged edges, each type
running its own kernel; flash_decode at chosen splits (one, several,
ragged, T below a split, 2048 blocks) against the plain version cut the
same way, and at every register grouping of the query heads. The ssd_scan kernel against its
plain version (float32 1e-5 + 1e-4|x|; bf16 y within one bf16 ulp of
both the plain version and the one that rounds as the tensor cores do,
the float32 state within 1e-4 of its scale; chunks 16-256, d_state 4-128,
head_dim 16-128, state0, large decays, views off 16 bytes), each type
running its own kernels, and a reduced mamba2-130m
served on the card through it against the CPU. flash_attention and
flash_decode at the MoE and frontend archs' head dims and GQA groups
(d 64 and 128 over G = 2, hubert's non-causal d 80 at an unaligned S),
and reduced granite-moe and jamba prefilled on the card against the CPU
(identical top-k in every MoE layer). The streaming front end
(``serving/stream.py``) on the card: a shard killed mid-run resumes bit
for bit with the uninterrupted run, one frame launch a dispatch or a
replayed WAL frame. flash_attention's gradient through the kernel's
forward bit for bit with the plain forward's (and the float64 oracle in
float32, a ragged tail included); the backward kernel
(``flash_attention_bwd_kernel``: bf16 on wgmma, float32 by 3xTF32)
against its plain version at d 8-128, G = 1, 2, 4, causal, windowed and
non-causal, ragged and unequal lengths at every tile's edge, one launch a
backward, bit for bit from call to call, and
within 2x the torch-op backward's float64 distance in both dtypes; the
IMM scan on the saved lane of
tests/data/imm_scan_lane.npz bit for bit with its plain version. The mesh
paths on 2 ranks of a ``gloo`` world on the one card
(``tests/_torch_mesh_worker.py:card_job``): ``apply_moe`` with the experts
split over 'model' and in "tp2d" mode on a 'data' axis of 2, reduced
granite-moe decoded on flash_decode over a cache whose sequence is split
over 'model' (and, for a batch of 1, over 'data'), reduced mamba2 with
ssd_scan on each rank's heads, each against the same call in one process
on the card; ``compressed_psum`` bit for bit with its plain version. The
tile table's launch choices: every instantiated tile of scan.cu,
imm_step.cu (both layouts) and imm_scan.cu bit for bit with the plain
version at ragged N, both symmetrize values, with and without a valid
stream and with one asymmetric seed P among symmetric ones; every raced
(tile, time chunk) bit for bit with one launch; a tile that is not
instantiated refused by the wrappers and the C entries. Needs an NVIDIA
GPU; run with

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

from repro_torch import profiling  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tracker as ttr  # noqa: E402
from repro_torch.core.rewrites import STAGES, run_sequence  # noqa: E402
from repro_torch.core.filters import IMMModel, as_imm, get_filter  # noqa: E402
from repro_torch.core.filters import make_ca9_lkf, make_ct9_lkf  # noqa: E402
from repro_torch.core.filters import make_imm  # noqa: E402
from repro_torch.data.trajectories import SceneConfig, mot_scene  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as fd_ref  # noqa: E402
from repro_torch.kernels.katana_bank import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.sharding.rules import ShardingContext  # noqa: E402
from repro_torch.serving.engine import TrackingEngine  # noqa: E402

from _torch_inputs import random_frame_inputs, replay_inputs, spd  # noqa: E402

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


def _greedy_tile(name, rng):
    """(cost (C, M), valid (C, M), gate, rounds) of an edge tile."""
    C, M, gate = 1500, 64, 6.0
    cost = np.round(rng.uniform(0, 10, (C, M)) * 2) / 2
    valid = rng.random((C, M)) > 0.3
    rounds = None
    if name == "meas0":
        C, M = 1200, 0
        cost, valid = cost[:C, :0], valid[:C, :0]
    elif name == "none_gated":
        cost += 6.5
    elif name == "dense":
        C, M, gate = 1100, 300, 1e30
        cost = rng.uniform(0, 10, (C, M))
        valid = np.ones((C, M), bool)
    elif name == "sparse":
        C, M = 2048, 256
        cost = rng.uniform(0, 10, (C, M))
        valid = rng.random((C, M)) < 0.01
    elif name == "signed_zero_nan":
        C, M = 1030, 40
        cost = np.where(rng.random((C, M)) < 0.5, 0.0,
                        rng.choice([-1.0, 1.0, np.nan], (C, M)))
        cost[rng.random((C, M)) < 0.5] *= -1.0
        valid = rng.random((C, M)) > 0.3
    elif name == "rounds_cut":
        rounds = 3
    rounds = min(C, M) if rounds is None else rounds
    return cost.astype(np.float32), valid, gate, rounds


@pytest.mark.parametrize("name", ["meas0", "none_gated", "dense", "sparse",
                                  "signed_zero_nan", "rounds_cut"])
def test_greedy_kernel_edge_tiles(cuda, name):
    """assoc and the wave count equal the plain version's (which follows
    the kernel's candidate list) and the tile schedule's."""
    cost, valid, gate, rounds = _greedy_tile(name, np.random.default_rng(3))
    cost_t, valid_t = _dev((cost, valid), cuda)
    a, w = ops.katana_greedy_assign(cost_t, valid_t, gate, rounds,
                                    return_waves=True)
    b, wb = ref.greedy_assign_plain(cost_t, valid_t, gate, rounds,
                                    return_waves=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and int(w) == wb, (name, int(w), wb)
    if cost.shape[1]:
        c, wc = ref.greedy_waves(ref.gate_mask(cost_t.T, valid_t.T, gate),
                                 rounds)
        assert torch.equal(a, c) and wc == wb
    if name in ("meas0", "none_gated"):  # one wave, none with no rounds
        assert bool((a == -1).all()) and wb == min(1, rounds)
    if name == "rounds_cut":
        assert wb == 3


def test_greedy_events_time_the_frames_greedy(cuda):
    """The events a frame records around its greedy: the same result as
    without them, and a positive device time inside the frame."""
    model = get_filter("lkf")
    rng = np.random.default_rng(11)
    x, P, z, zv, act = _dev(random_frame_inputs(rng, 6, 3, 1024, 256,
                                                [0, 1, 2], spread=20.0), cuda)
    evs = (torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
    got = ops.katana_frame(model, x, P, z, zv, act, 11.34, 256,
                           greedy_events=evs)
    want = ops.katana_frame(model, x, P, z, zv, act, 11.34, 256)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert evs[0].elapsed_time(evs[1]) > 0


# (C, M, case): the serving shapes; C not a multiple of a block's tracks;
# every track inactive; no valid measurement; one measurement
FRAME_CASES = [(C, M, "") for C, M in SHAPES] + [
    (37, 12, ""), (1029, 256, ""), (200, 64, "inactive"),
    (200, 64, "no_valid_z"), (200, 1, ""), (1029, 1, "")]


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
@pytest.mark.parametrize("C,M,case", FRAME_CASES)
def test_frame_kernel_matches_plain(cuda, kind, C, M, case):
    """assoc, the wave count, x' and P' bit for bit, on the model's own
    pattern (cv6, ctra8)."""
    model = get_filter(kind)
    assert ops.pick_pattern((model,)).name == {"lkf": "cv6",
                                               "ekf": "ctra8"}[kind]
    obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
    rng = np.random.default_rng(C + M)
    x, P, z, zv, act = _dev(random_frame_inputs(rng, model.n, model.m, C, M,
                                                obs, spread=20.0), cuda)
    if case == "inactive":
        act = torch.zeros_like(act)
    if case == "no_valid_z":
        zv = torch.zeros_like(zv)
    gate = ttr.CHI2_99[model.m]
    args = (model, x, P, z, zv, act, gate, min(C, M))
    got = ops.katana_frame(*args, return_waves=True)
    want = ref.katana_frame_plain(*args, return_waves=True)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2]) and int(got[3]) == want[3]
    if case in ("inactive", "no_valid_z"):
        assert bool((got[2] == -1).all())
    elif M > 1:
        assert int((got[2] >= 0).sum()) > 0
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_frame_launch_events_time_each_launch(cuda, kind):
    """The five events the single-model frame records around its
    launches: the same result as without them, and a positive device time
    for each of the predict, the cost tile, the greedy and the update."""
    model = get_filter(kind)
    obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
    rng = np.random.default_rng(17)
    x, P, z, zv, act = _dev(random_frame_inputs(rng, model.n, model.m, 1024,
                                                256, obs, spread=20.0), cuda)
    args = (model, x, P, z, zv, act, ttr.CHI2_99[model.m], 256)
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    got = ops.katana_frame(*args, launch_events=evs)
    want = ops.katana_frame(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(evs[i].elapsed_time(evs[i + 1]) > 0 for i in range(4))


# the single-model frame's cases, and a model set that runs the dense
# instantiation
IMM_FRAME_CASES = FRAME_CASES + [(200, 64, "other")]


@pytest.mark.parametrize("C,M,case", IMM_FRAME_CASES)
def test_imm_frame_kernel_matches_plain(cuda, C, M, case):
    """assoc, the wave count, x', P', mu' and x_c bit for bit."""
    imm = _other_imm() if case == "other" else make_imm()
    assert ops.pick_pattern(imm.models).name == (
        "dense9" if case == "other" else "imm9")
    rng = np.random.default_rng(C + M + 1)
    x, P, mu, z, zv, act = _dev(random_frame_inputs(
        rng, 9, 3, C, M, [0, 1, 2], K=4, spread=20.0), cuda)
    if case == "inactive":
        act = torch.zeros_like(act)
    if case == "no_valid_z":
        zv = torch.zeros_like(zv)
    args = (imm, x, P, mu, z, zv, act, 11.34, min(C, M))
    got = ops.katana_imm_frame(*args, return_waves=True)
    want = ref.katana_imm_frame_plain(*args, return_waves=True)
    torch.cuda.synchronize()
    assert torch.equal(got[4], want[4]) and int(got[5]) == want[5]
    if case in ("inactive", "no_valid_z"):
        assert bool((got[4] == -1).all())
    elif M > 1:
        assert int((got[4] >= 0).sum()) > 0
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b), float((a - b).abs().max())


def test_imm_frame_launch_events_time_each_launch(cuda):
    """The five events the IMM frame records around its launches: the
    same result as without them, and a positive device time for each of
    the predict, the cost tile, the greedy and the update."""
    imm = make_imm()
    rng = np.random.default_rng(13)
    x, P, mu, z, zv, act = _dev(random_frame_inputs(
        rng, 9, 3, 1024, 256, [0, 1, 2], K=4, spread=20.0), cuda)
    args = (imm, x, P, mu, z, zv, act, 11.34, 256)
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    got = ops.katana_imm_frame(*args, launch_events=evs)
    want = ops.katana_imm_frame(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(evs[i].elapsed_time(evs[i + 1]) > 0 for i in range(4))


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


def _jitted(kind, C=64, M=16, T=30):
    """A captured tracker of ``kind``, the eager frame step it captures
    and a T-frame scene at (C, M) as CUDA tensors."""
    model = make_imm() if kind == "imm" else get_filter(kind)
    smodel = get_filter("cv9") if kind == "imm" else model
    cfg = ttr.TrackerConfig(capacity=C, max_meas=M)
    z, valid, _ = mot_scene(smodel, SceneConfig(T=T, max_targets=8,
                                                clutter_rate=3.0,
                                                birth_rate=0.3, max_meas=M),
                            seed=4)
    make = (ttr.make_jitted_imm_tracker if kind == "imm"
            else ttr.make_jitted_tracker)
    eager = ttr.imm_frame_step if kind == "imm" else ttr.frame_step
    init, step = make(model, cfg, device="cuda")
    frames = [(torch.as_tensor(z[t], dtype=torch.float32, device="cuda"),
               torch.as_tensor(valid[t], device="cuda")) for t in range(T)]
    return init, step, lambda b, zt, vt: eager(model, cfg, b, zt, vt), frames


def _result_tensors(res):
    return [t for t in list(res.bank) + list(res[1:]) if t is not None]


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_jitted_tracker_captures_once(cuda, kind):
    """One CUDA-graph capture for 30 frames, and one frame launch (and
    one greedy) counted a frame: the capture's own count is taken back,
    each replay adds it."""
    init, step, _, frames = _jitted(kind)
    ops.reset_launches()
    bank = init()
    for zt, vt in frames:
        bank = step(bank, zt, vt).bank
    torch.cuda.synchronize()
    name = "katana_imm_frame" if kind == "imm" else "katana_frame"
    assert (step.captures, step.replays) == (1, len(frames) - 1)
    assert ops.LAUNCHES[name] == len(frames)
    assert ops.LAUNCHES["greedy_assign"] == len(frames)


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_jitted_tracker_matches_eager_bit_for_bit(cuda, kind):
    """Every field of every frame (assoc, unassigned, confirmed, the
    bank's x, P, mu and lifecycle, mode_probs, x_est) of the replayed
    graph equals the eager frame step's, C = 64, M = 16, 30 frames."""
    init, step, eager, frames = _jitted(kind)
    bank_g = bank_e = init()
    spawned = 0
    for t, (zt, vt) in enumerate(frames):
        rg, re = step(bank_g, zt, vt), eager(bank_e, zt, vt)
        for a, b in zip(_result_tensors(rg), _result_tensors(re)):
            assert torch.equal(a, b), t
        spawned += int(re.unassigned.sum())
        bank_g, bank_e = rg.bank, re.bank
    assert spawned > 0 and int(bank_e.active.sum()) > 0


def test_jitted_tracker_result_is_not_overwritten(cuda):
    """A result held from frame t is unchanged after frame t + 1: the
    step hands out clones of the graph's static outputs."""
    init, step, _, frames = _jitted("imm")
    bank = init()
    for zt, vt in frames[:5]:
        bank = step(bank, zt, vt).bank
    held = step(bank, *frames[5])
    saved = [t.clone() for t in _result_tensors(held)]
    nxt = step(held.bank, *frames[6])
    torch.cuda.synchronize()
    for a, b in zip(_result_tensors(held), saved):
        assert torch.equal(a, b)
    assert not torch.equal(nxt.bank.x, held.bank.x)
    assert step.replays == 6


SCAN_SHAPES = [(5, 17), (1024, 300)]


def _close(a, b, tol):
    """max |a - b| / max(1, |b|) <= tol."""
    d = ((a.double() - b.double()).abs() / b.double().abs().clamp_min(1.0))
    assert float(d.max()) <= tol, float(d.max())


# (N, T, valid stream): the scan's shapes, ragged last blocks of its 128
# tracks, and the K = 1 IMM replay's valid stream
SCAN_CASES = [(N, T, False) for N, T in SCAN_SHAPES] + [
    (1, 17, True), (31, 40, False), (33, 40, True), (129, 20, False),
    (4097, 20, True), (1024, 300, True)]


@pytest.mark.parametrize("kind", ["lkf", "ekf", "cv9"])
@pytest.mark.parametrize("N,T,valid", SCAN_CASES)
def test_scan_kernel_matches_plain(cuda, kind, N, T, valid):
    """xs, x_T and P_T bit for bit, on the model's own pattern; with a
    valid stream through the K = 1 IMM replay, whose False frames keep
    the prediction."""
    model = get_filter(kind)
    assert ops.pick_pattern((model,)).name == {
        "lkf": "cv6", "ekf": "ctra8", "cv9": "imm9"}[kind]
    x0, P0, zs, vs = _dev(replay_inputs(np.random.default_rng(N + T), model,
                                        N, T, drop=0.1 if valid else 0.0),
                          cuda)
    ops.reset_launches()
    if valid:
        one = as_imm(model)
        xs, (xf, Pf, _) = ops.katana_imm_sequence(one, zs, x0, P0, valid=vs,
                                                  return_final=True)
        _, _, _, zz, vv = ops.imm_sequence_inputs(one, zs, x0, P0, None, vs)
        want = ref.katana_bank_scan_plain(model, x0, P0, zz, vv)
        xf, Pf = xf[0], Pf[0]
        launches = ops.LAUNCHES["katana_imm_sequence"]
    else:
        xs, (xf, Pf) = ops.katana_bank_sequence(model, zs, x0, P0,
                                                return_final=True)
        want = ref.katana_bank_scan_plain(model, x0, P0, zs)
        launches = ops.LAUNCHES["katana_bank_sequence"]
    torch.cuda.synchronize()
    assert launches == _chunks_of(
        "katana_imm_sequence" if valid else "katana_bank_sequence", T)
    assert bool(torch.isfinite(xs).all())
    for a, b in zip((xs, xf, Pf), want):
        assert torch.equal(a, b), float((a - b).abs().max())


def _chunks_of(name, T):
    """Launches of wrapper ``name``'s last call over T frames: one a time
    chunk, the chunk the tile table (or the caller) chose."""
    return -(-T // ops.LAST_CONFIG[name]["time_chunk"])


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
@pytest.mark.parametrize("valid", [False, True])
def test_scan_kernel_reads_an_asymmetric_seed_whole(cuda, kind, valid):
    """A seed P that is symmetric only to rounding on some lanes: the
    scan's first frame reads those lanes' P whole (first_frame, for their
    blocks of 128), as the plain version and katana_bank do; bit for bit,
    also in time chunks of one frame, and T katana_bank calls (no valid
    stream) equal the scan's final state."""
    model = get_filter(kind)
    rng = np.random.default_rng(23)
    x0, P0, zs, vs = _dev(replay_inputs(rng, model, 300, 9,
                                        drop=0.2 if valid else 0.0), cuda)
    noise = torch.as_tensor(1e-3 * rng.normal(size=tuple(P0.shape)),
                            dtype=torch.float32, device=cuda)
    P0 = (P0 + noise).contiguous()
    # symmetric: every other lane and the first block of 128 lanes
    P0[::2] = (P0[::2] + P0[::2].transpose(1, 2)) / 2
    P0[:128] = (P0[:128] + P0[:128].transpose(1, 2)) / 2
    if valid:
        one = as_imm(model)
        xs, (xf, Pf, _) = ops.katana_imm_sequence(one, zs, x0, P0, valid=vs,
                                                  return_final=True)
        _, _, _, zz, vv = ops.imm_sequence_inputs(one, zs, x0, P0, None, vs)
        want = ref.katana_bank_scan_plain(model, x0, P0, zz, vv)
        xf, Pf = xf[0], Pf[0]
    else:
        xs, (xf, Pf) = ops.katana_bank_sequence(model, zs, x0, P0,
                                                return_final=True)
        want = ref.katana_bank_scan_plain(model, x0, P0, zs)
        x, P = x0, P0
        for t in range(zs.shape[0]):
            x, P = ops.katana_bank(model, x, P, zs[t])
        assert torch.equal(x, xf) and torch.equal(P, Pf)
        one = ops.katana_bank_sequence(model, zs, x0, P0, return_final=True,
                                       time_chunk=1)
        assert torch.equal(one[0], xs)
        assert torch.equal(one[1][0], xf) and torch.equal(one[1][1], Pf)
    torch.cuda.synchronize()
    for a, b in zip((xs, xf, Pf), want):
        assert torch.equal(a, b), float((a - b).abs().max())


def _other_imm():
    """An IMM set whose constants differ from make_imm()'s: another dt
    and other turn rates, and a CV9 whose acceleration rows are not zero,
    one of them in a slot every make_imm() member has zero (F[6][0]), so
    the kernels run their dense instantiation."""
    cv9 = get_filter("cv9", dt=0.05)
    F = cv9.F.copy()
    F[6:9, 6:9] = 0.9 * np.eye(3)
    F[6, 0] = 0.01
    imm = make_imm()
    return IMMModel(name="imm-other", models=(
        dataclasses.replace(cv9, F=F), make_ca9_lkf(dt=0.05),
        make_ct9_lkf(0.4, dt=0.05), make_ct9_lkf(-0.9, dt=0.05)),
        trans=imm.trans, mu0=imm.mu0)


IMM_SETS = {"imm": (make_imm, "imm9"), "other": (_other_imm, "dense9")}
# (model set, N, T, valid stream, time_chunk: 0 the default, T one launch)
IMM_SCAN_CASES = [
    ("imm", 5, 17, True, 0), ("imm", 1024, 300, True, 0),
    ("imm", 1, 17, False, 0), ("imm", 31, 40, True, 7),
    ("imm", 33, 40, False, 40), ("imm", 4097, 20, True, 0),
    ("imm", 4097, 20, False, 20), ("other", 1, 17, True, 0),
    ("other", 31, 17, False, 17), ("other", 33, 40, True, 7),
    ("other", 4097, 20, True, 20)]


@pytest.mark.parametrize("kind,N,T,valid,chunk", IMM_SCAN_CASES)
def test_imm_scan_kernel_matches_plain(cuda, kind, N, T, valid, chunk):
    make, pattern = IMM_SETS[kind]
    imm = make()
    assert ops.pick_pattern(imm.models).name == pattern
    rng = np.random.default_rng(N + T + 1)
    x0, P0, zs, vs = _dev(replay_inputs(rng, imm, N, T,
                                        drop=0.1 if valid else 0.0), cuda)
    vs = vs if valid else None
    mu0 = torch.as_tensor(rng.dirichlet(np.ones(4), size=N),
                          dtype=torch.float32, device=cuda)
    ops.reset_launches()
    xs, fin = ops.katana_imm_sequence(imm, zs, x0, P0, mu0, vs,
                                      return_final=True, time_chunk=chunk)
    want = ref.katana_bank_imm_scan_plain(
        imm, *ops.imm_sequence_inputs(imm, zs, x0, P0, mu0, vs))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["katana_imm_sequence"] == _chunks_of(
        "katana_imm_sequence", T)
    assert ops.LAST_CONFIG["katana_imm_sequence"]["time_chunk"] == (
        chunk or ops.LAST_CONFIG["katana_imm_sequence"]["time_chunk"])
    assert bool(torch.isfinite(xs).all())
    for a, b in zip((xs,) + fin, want):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("kind", ["cv9", "ekf"])
def test_imm_scan_k1_is_the_scan_kernel(cuda, kind):
    model = get_filter(kind)
    x0, P0, zs, _ = _dev(replay_inputs(np.random.default_rng(3), model, 200,
                                       40), cuda)
    a = ops.katana_imm_sequence(as_imm(model), zs, x0, P0)
    b = ops.katana_bank_sequence(model, zs, x0, P0)
    assert torch.equal(a, b)


def test_chunked_scans_equal_one_launch(cuda):
    imm, ekf = make_imm(), get_filter("ekf")
    rng = np.random.default_rng(4)
    x0, P0, zs, valid = _dev(replay_inputs(rng, imm, 300, 50, drop=0.1),
                             cuda)
    one = ops.katana_imm_sequence(imm, zs, x0, P0, valid=valid,
                                  return_final=True, time_chunk=64)
    many = ops.katana_imm_sequence(imm, zs, x0, P0, valid=valid,
                                   return_final=True, time_chunk=7)
    assert torch.equal(one[0], many[0])
    assert all(torch.equal(a, b) for a, b in zip(one[1], many[1]))
    x0, P0, zs, _ = _dev(replay_inputs(rng, ekf, 300, 50), cuda)
    one = ops.katana_bank_sequence(ekf, zs, x0, P0, return_final=True)
    many = ops.katana_bank_sequence(ekf, zs, x0, P0, return_final=True,
                                    time_chunk=7)
    assert torch.equal(one[0], many[0])
    assert all(torch.equal(a, b) for a, b in zip(one[1], many[1]))


# the scan's shapes, then ragged last blocks of the step's 128 lanes
STEP_SHAPES = SCAN_SHAPES + [(N, 3) for N in (1, 31, 33, 127, 129, 4097)]


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
@pytest.mark.parametrize("N,T", STEP_SHAPES)
def test_step_kernel_matches_plain_and_scan(cuda, kind, N, T):
    """Both layouts bit for bit against the plain version (each on its
    model's pattern: cv6, ctra8), and T steps equal the scan's final
    state."""
    model = get_filter(kind)
    assert ops.pick_pattern((model,)).name == {"lkf": "cv6",
                                               "ekf": "ctra8"}[kind]
    x0, P0, zs, _ = _dev(replay_inputs(np.random.default_rng(N), model, N,
                                       T), cuda)
    ops.reset_launches()
    a = ops.katana_bank(model, x0, P0, zs[0])
    want = ref.katana_bank_step_plain(model, x0, P0, zs[0])
    assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
    soa = ops.katana_bank_soa(model, x0.T.contiguous(),
                              P0.permute(1, 2, 0).contiguous(),
                              zs[0].T.contiguous())
    assert ops.LAUNCHES["katana_bank"] == ops.LAUNCHES["katana_bank_soa"] == 1
    assert torch.equal(soa[0].T, a[0])
    assert torch.equal(soa[1].permute(2, 0, 1), a[1])
    _, (xf, Pf) = ops.katana_bank_sequence(model, zs, x0, P0,
                                           return_final=True)
    x, P = x0, P0
    for t in range(T):
        x, P = ops.katana_bank(model, x, P, zs[t])
    assert torch.equal(x, xf) and torch.equal(P, Pf)


@pytest.mark.parametrize("kind", ["imm", "other", "ekf"])
@pytest.mark.parametrize("N", [1, 5, 31, 33, 1024, 4097])
def test_imm_step_kernel_matches_plain(cuda, kind, N):
    """Bit for bit, with a P that is symmetric only to rounding (the
    mixing's output), every lane count of a ragged last block, each
    instantiation: make_imm()'s pattern, the dense one, the CTRA-8
    Jacobian's."""
    if kind == "ekf":
        imm, pattern = as_imm(get_filter(kind)), "ctra8"
    else:
        make, pattern = IMM_SETS[kind]
        imm = make()
    assert ops.pick_pattern(imm.models).name == pattern
    rng = np.random.default_rng(N + 7)
    x0, _, zs, _ = replay_inputs(rng, imm, N, 1)
    K, n = imm.K, imm.n
    x = torch.as_tensor(np.tile(x0, (K, 1, 1)) + 0.05 * rng.normal(
        size=(K, N, n)), dtype=torch.float32, device=cuda)
    P = spd(rng, (K, N), n) + 1e-6 * rng.normal(size=(K, N, n, n))
    P = torch.as_tensor(P.astype(np.float32), device=cuda)
    z = torch.as_tensor(zs[0], device=cuda)
    ops.reset_launches()
    got = ops.katana_bank_imm(imm, x, P, z)
    want = ref.katana_bank_imm_step_plain(imm, x, P, z)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["katana_bank_imm"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("N", [33, 1024])
def test_imm_bank_sequence_tracks_the_imm_scan(cuda, N):
    imm = make_imm()
    x0, P0, zs, _ = _dev(replay_inputs(np.random.default_rng(9), imm, N,
                                       300), cuda)
    ops.reset_launches()
    drv = ops.imm_bank_sequence(imm, zs, x0, P0)
    fused = ops.katana_imm_sequence(imm, zs, x0, P0)
    assert ops.LAUNCHES["katana_bank_imm"] == 300
    torch.testing.assert_close(drv, fused, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_engine_replay_on_card_matches_cpu(cuda, kind):
    model = make_imm() if kind == "imm" else get_filter(kind)
    _, _, zs, _ = replay_inputs(np.random.default_rng(11), model, 64, 60)
    cfg = ttr.TrackerConfig(capacity=16, max_meas=8)
    gpu = TrackingEngine(model, cfg, device="cuda")
    cpu = TrackingEngine(model, cfg, device="cpu")
    ops.reset_launches()
    a = gpu.replay(zs)
    name = "katana_imm_sequence" if kind == "imm" else "katana_bank_sequence"
    assert ops.LAUNCHES[name] == 1
    b = cpu.replay(zs)
    assert gpu.stats.replay_frames == 60 and gpu.stats.frames == 0
    _close(torch.as_tensor(a), torch.as_tensor(b), 1e-4)


# ------------------------------------------ symmetrize=False and the stages

FULL_SQUARE_CASES = [(1, 17, False), (31, 40, True), (129, 20, False),
                     (1024, 300, False), (4097, 20, True)]


def _asymmetric(rng, P):
    """P plus 1e-3 noise: symmetric only to rounding, not to the bit."""
    noise = torch.as_tensor(1e-3 * rng.normal(size=tuple(P.shape)),
                            dtype=torch.float32, device=P.device)
    return (P + noise).contiguous()


@pytest.mark.parametrize("kind", ["lkf", "ekf", "cv9"])
@pytest.mark.parametrize("N,T,valid", FULL_SQUARE_CASES)
def test_full_square_scan_and_step_match_plain(cuda, kind, N, T, valid):
    """scan.cu's and imm_step.cu's Sym = false route (symmetrize=False)
    bit for bit with the plain version on an asymmetric seed P: the scan
    (with a valid stream through the K = 1 IMM replay), the step in both
    layouts, and T steps equal to the scan's final state; the route is
    not the symmetric one."""
    model = get_filter(kind)
    rng = np.random.default_rng(N + T + 1)
    x0, P0, zs, vs = _dev(replay_inputs(rng, model, N, T,
                                        drop=0.1 if valid else 0.0), cuda)
    P0 = _asymmetric(rng, P0)
    ops.reset_launches()
    if valid:
        one = as_imm(model)
        xs, (xf, Pf, _) = ops.katana_imm_sequence(
            one, zs, x0, P0, valid=vs, return_final=True, symmetrize=False)
        _, _, _, zz, vv = ops.imm_sequence_inputs(one, zs, x0, P0, None, vs)
        want = ref.katana_bank_scan_plain(model, x0, P0, zz, vv,
                                          symmetrize=False)
        xf, Pf = xf[0], Pf[0]
        assert ops.LAUNCHES["katana_imm_sequence"] == _chunks_of(
            "katana_imm_sequence", T)
    else:
        xs, (xf, Pf) = ops.katana_bank_sequence(
            model, zs, x0, P0, return_final=True, symmetrize=False)
        want = ref.katana_bank_scan_plain(model, x0, P0, zs,
                                          symmetrize=False)
        assert ops.LAUNCHES["katana_bank_sequence"] == _chunks_of(
            "katana_bank_sequence", T)
        x, P = x0, P0
        for t in range(T):
            x, P = ops.katana_bank(model, x, P, zs[t], symmetrize=False)
        assert torch.equal(x, xf) and torch.equal(P, Pf)
        sym = ops.katana_bank_sequence(model, zs, x0, P0)
        assert not torch.equal(sym, xs)
    torch.cuda.synchronize()
    for a, b in zip((xs, xf, Pf), want):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert not torch.equal(Pf, Pf.transpose(1, 2))
    z0 = torch.nan_to_num(zs[0])  # the valid streams write NaN
    a = ops.katana_bank(model, x0, P0, z0, symmetrize=False)
    b = ref.katana_bank_step_plain(model, x0, P0, z0, symmetrize=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the struct-of-arrays layout at both contracts
    for sym in (True, False):
        soa = ops.katana_bank_soa(model, x0.T.contiguous(),
                                  P0.permute(1, 2, 0).contiguous(),
                                  z0.T.contiguous(), symmetrize=sym)
        c = ops.katana_bank(model, x0, P0, z0, symmetrize=sym)
        assert torch.equal(soa[0].T, c[0])
        assert torch.equal(soa[1].permute(2, 0, 1), c[1])


@pytest.mark.parametrize("kind", ["imm", "other", "ekf", "lkf"])
@pytest.mark.parametrize("N", [1, 33, 4097])
def test_full_square_imm_step_matches_plain(cuda, kind, N):
    """imm_step.cu's Sym = false route at K = 4 (imm9, dense9) and K = 1
    (ctra8, cv6) bit for bit with the plain version on an asymmetric P."""
    if kind in ("ekf", "lkf"):
        imm = as_imm(get_filter(kind))
    else:
        imm = IMM_SETS[kind][0]()
    rng = np.random.default_rng(N + 11)
    x0, _, zs, _ = replay_inputs(rng, imm, N, 1)
    K, n = imm.K, imm.n
    x = torch.as_tensor(np.tile(x0, (K, 1, 1)) + 0.05 * rng.normal(
        size=(K, N, n)), dtype=torch.float32, device=cuda)
    P = _asymmetric(rng, torch.as_tensor(spd(rng, (K, N), n), device=cuda))
    z = torch.as_tensor(zs[0], device=cuda)
    got = ops.katana_bank_imm(imm, x, P, z, symmetrize=False)
    want = ref.katana_bank_imm_step_plain(imm, x, P, z, symmetrize=False)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())


# (C, M): small, a ragged C, the serving size
FULL_SQUARE_FRAMES = [(24, 12), (37, 12), (1029, 256), (1024, 256)]


@pytest.mark.parametrize("kind", ["lkf", "ekf", "cv9"])
@pytest.mark.parametrize("C,M", FULL_SQUARE_FRAMES)
def test_full_square_frame_matches_plain(cuda, kind, C, M):
    """frame.cu at both symmetrize values (Sym = false: the predict's and
    the update's full square) bit for bit with the plain version on a P
    that is not symmetric to the bit: assoc, waves, x', P'; the two
    contracts part."""
    model = get_filter(kind)
    obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
    rng = np.random.default_rng(C + M + 7)
    x, P, z, zv, act = _dev(random_frame_inputs(rng, model.n, model.m, C, M,
                                                obs, spread=20.0), cuda)
    P = _asymmetric(rng, P)
    outs = {}
    for sym in (True, False):
        args = (model, x, P, z, zv, act, ttr.CHI2_99[model.m], min(C, M))
        ops.reset_launches()
        got = ops.katana_frame(*args, return_waves=True, symmetrize=sym)
        assert ops.LAUNCHES["katana_frame"] == 1
        want = ref.katana_frame_plain(*args, return_waves=True,
                                      symmetrize=sym)
        torch.cuda.synchronize()
        assert torch.equal(got[2], want[2]) and int(got[3]) == want[3]
        assert int((got[2] >= 0).sum()) > 0
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b), (sym, float((a - b).abs().max()))
        outs[sym] = got
    assert not torch.equal(outs[False][1], outs[False][1].transpose(1, 2))
    assert not torch.equal(outs[False][1], outs[True][1])


@pytest.mark.parametrize("kind", ["imm", "other"])
@pytest.mark.parametrize("C,M", FULL_SQUARE_FRAMES)
def test_full_square_imm_frame_matches_plain(cuda, kind, C, M):
    """imm_frame.cu at both symmetrize values (Sym = false: the mixing,
    the predict, the update and the coasting select over the full square)
    bit for bit with the plain version on a P that is not symmetric to
    the bit: assoc, waves, x', P', mu', x_c; K = 1 through frame.cu."""
    imm = IMM_SETS[kind][0]()
    rng = np.random.default_rng(C + M + 9)
    x, P, mu, z, zv, act = _dev(random_frame_inputs(
        rng, 9, 3, C, M, [0, 1, 2], K=4, spread=20.0), cuda)
    P = _asymmetric(rng, P)
    outs = {}
    for sym in (True, False):
        args = (imm, x, P, mu, z, zv, act, 11.34, min(C, M))
        got = ops.katana_imm_frame(*args, return_waves=True, symmetrize=sym)
        want = ref.katana_imm_frame_plain(*args, return_waves=True,
                                          symmetrize=sym)
        torch.cuda.synchronize()
        assert torch.equal(got[4], want[4]) and int(got[5]) == want[5]
        for a, b in zip(got[:4], want[:4]):
            assert torch.equal(a, b), (sym, float((a - b).abs().max()))
        outs[sym] = got
    assert not torch.equal(outs[False][1], outs[False][1].transpose(2, 3))
    assert not torch.equal(outs[False][1], outs[True][1])
    ekf = as_imm(get_filter("ekf"))
    x1, P1, z1, zv1, act1 = _dev(random_frame_inputs(
        rng, 8, 4, C, M, [0, 1, 2, 4], spread=20.0), cuda)
    P1 = _asymmetric(rng, P1)
    args = (ekf, x1[None].contiguous(), P1[None].contiguous(),
            torch.ones(C, 1, device=cuda), z1, zv1, act1, 13.28, min(C, M))
    got = ops.katana_imm_frame(*args, symmetrize=False)
    want = ref.katana_imm_frame_plain(*args, symmetrize=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_full_square_fleet_frame_is_refused(cuda):
    """A fleet frame at symmetrize=False raises in the wrapper and the C
    entry refuses it (cudaErrorInvalidValue)."""
    model = get_filter("lkf")
    rng = np.random.default_rng(2)
    x, P, z, zv, act = _dev(random_frame_inputs(rng, 6, 3, 16, 8,
                                                [0, 1, 2]), cuda)
    st = [torch.stack([a, a]).contiguous() for a in (x, P, z, zv, act)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.katana_frame(model, *st, 11.34, 8, symmetrize=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.katana_imm_frame(
            make_imm(), torch.zeros(4, 2, 16, 9, device=cuda),
            torch.eye(9, device=cuda).expand(4, 2, 16, 9, 9).contiguous(),
            torch.full((2, 16, 4), 0.25, device=cuda), st[2], st[3], st[4],
            11.34, 8, symmetrize=False)


# (model set, N, T, valid stream, time_chunk: 0 the table's, T one launch)
FULL_SQUARE_IMM_SCANS = [
    ("imm", 5, 17, True, 0), ("imm", 70, 40, True, 7),
    ("imm", 131, 40, False, 40), ("imm", 1024, 300, True, 0),
    ("imm", 4097, 20, True, 20), ("other", 33, 17, True, 0),
    ("other", 1000, 40, False, 7)]


@pytest.mark.parametrize("kind,N,T,valid,chunk", FULL_SQUARE_IMM_SCANS)
def test_full_square_imm_scan_matches_plain(cuda, kind, N, T, valid,
                                            chunk):
    """imm_scan.cu's Sym = false route (the full square at K = 4) at both
    tiles (32, 64 tracks a block), chunked and in one launch, bit for bit
    with the plain version on mode-conditioned seeds whose P is not
    symmetric to the bit, ragged N, with a NaN-coasting valid stream;
    the two contracts part."""
    imm = IMM_SETS[kind][0]()
    rng = np.random.default_rng(N + T + 3)
    x0, P0, zs, vs = _dev(replay_inputs(rng, imm, N, T,
                                        drop=0.3 if valid else 0.0), cuda)
    vs = vs if valid else None
    K = imm.K
    xK = (x0[None] + torch.as_tensor(0.05 * rng.normal(size=(K, N, 9)),
                                     dtype=torch.float32, device=cuda))
    PK = _asymmetric(rng, P0[None].expand(K, N, 9, 9))
    mu0 = torch.as_tensor(rng.dirichlet(np.ones(4), size=N),
                          dtype=torch.float32, device=cuda)
    want = ref.katana_bank_imm_scan_plain(
        imm, *ops.imm_sequence_inputs(imm, zs, xK.contiguous(), PK, mu0, vs),
        symmetrize=False)
    for tile in ops.LANE_TILES["katana_imm_sequence"]:
        ops.reset_launches()
        xs, fin = ops.katana_imm_sequence(
            imm, zs, xK.contiguous(), PK, mu0, vs, return_final=True,
            time_chunk=chunk, symmetrize=False, lane_tile=tile)
        assert ops.LAUNCHES["katana_imm_sequence"] == _chunks_of(
            "katana_imm_sequence", T)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(xs).all())
        for a, b in zip((xs,) + fin, want):
            assert torch.equal(a, b), (tile, float((a - b).abs().max()))
    assert not torch.equal(fin[1], fin[1].transpose(2, 3))
    sym = ops.katana_imm_sequence(imm, zs, xK.contiguous(), PK, mu0, vs)
    assert not torch.equal(sym, xs)


def test_imm_scan_rung_on_card_matches_cpu(cuda):
    """The stage ladder's imm_scan rung on make_imm() at its default
    symmetrize=False: one launch of the K = 4 full square, bit for bit
    with its plain version on the card, and within 1e-4 of the same rung
    on the CPU (the CPU's exp and log)."""
    imm = make_imm()
    x0, P0, zs, _ = replay_inputs(np.random.default_rng(6), imm, 200, 50,
                                  extent=1.0)
    ops.reset_launches()
    a = run_sequence(imm, "imm_scan", zs, x0, P0)
    assert ops.LAUNCHES["katana_imm_sequence"] == 1
    want = ref.katana_bank_imm_scan_plain(
        imm, *ops.imm_sequence_inputs(imm, *_dev((zs, x0, P0), cuda)),
        symmetrize=False)[0]
    assert torch.equal(a, want)
    _close(a.cpu(), run_sequence(imm, "imm_scan", zs, x0, P0, device="cpu"),
           1e-4)


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
@pytest.mark.parametrize("stage", STAGES)
def test_stage_on_card_matches_cpu(cuda, kind, stage):
    """Every rewrite stage on the card against the same stage on the CPU,
    on streams of the reference tests' scale: the lkf kernel stages bit
    for bit (the plain versions' op stream), the others within 1e-4 by
    |d| / max(1, |ref|) as the engine's replay (the CPU's sin/cos, cuBLAS's
    order of summation); the kernel stages' launches."""
    model = get_filter(kind)
    rng = np.random.default_rng(3)
    N = 1 if stage in ("baseline", "opt1", "opt2") else 200
    x0, P0, zs, _ = replay_inputs(rng, model, N, 50, extent=1.0)
    ops.reset_launches()
    a = run_sequence(model, stage, zs, x0, P0)
    name, want = {"fused_scan": ("katana_bank_sequence", 1),
                  "imm_bank": ("katana_bank_imm", 50),
                  "imm_scan": ("katana_imm_sequence", 1)}.get(
                      stage, ("katana_bank", 0))
    assert ops.LAUNCHES[name] == want
    b = run_sequence(model, stage, zs, x0, P0, device="cpu")
    assert a.device.type == "cuda" and a.shape == b.shape
    if stage in ("fused_scan", "imm_bank", "imm_scan") and kind == "lkf":
        assert torch.equal(a.cpu(), b)
    else:
        _close(a.cpu(), b, 1e-4)


# ---------------------------------------------------------------- LM kernels

def _within_bf16_ulp(a, b):
    """|a - b| at most one bfloat16 ulp of the larger magnitude, values
    under 2^-6 judged at 2^-6: near zero the two float32 sums differ by
    ~1e-8, more than a bf16 ulp of the value itself."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()).clamp_min(2 ** -6))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    bad = (a - b).abs() > ulp
    assert not bool(bad.any()), (int(bad.sum()), a[bad][:5].tolist(),
                                 b[bad][:5].tolist())


def _qkv(rng, B, Sq, Sk, H, KH, d, dtype, dev):
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32  # noqa: E731
                                    ).to(dev, dtype)
    return mk(B, Sq, H, d), mk(B, Sk, KH, d), mk(B, Sk, KH, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (False, 40)])
@pytest.mark.parametrize("S,H,KH,d", [(128, 4, 4, 32), (200, 8, 2, 80),
                                      (77, 4, 1, 128), (300, 2, 2, 8)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, causal, window, S,
                                              H, KH, d):
    rng = np.random.default_rng(S + d)
    q, k, v = _qkv(rng, 2, S, S, H, KH, d, dtype, cuda)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, d ** -0.5, causal, window)
    assert fa_ops.LAUNCHES["flash_attention"] == 1
    want = fa_ref.flash_attention_plain(q, k, v, d ** -0.5, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        _within_bf16_ulp(got, want)


def test_flash_attention_kernel_unaligned_noncausal_matches_oracle(cuda):
    """Keys masked by the true length: Sk = 100 with no padding."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 100, 100, 2, 2, 16, torch.float32, cuda)
    got = fa_ops.flash_attention(q, k, v, 0.25, False, None, 32, 32)
    bh = lambda t: t.transpose(1, 2).reshape(2, 100, 16)  # noqa: E731
    want = fa_ref.attention_ref(bh(q), bh(k), bh(v), scale=0.25,
                                causal=False)
    torch.testing.assert_close(bh(got), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KH,T,d", [(4, 2, 128, 32), (32, 8, 4096, 80),
                                      (48, 1, 256, 128), (8, 8, 200, 16)])
def test_flash_decode_kernel_matches_plain(cuda, dtype, H, KH, T, d):
    rng = np.random.default_rng(H + T)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32  # noqa: E731
                                    ).to(cuda, dtype)
    q, k, v = mk(2, H, d), mk(2, T, KH, d), mk(2, T, KH, d)
    fd_ops.reset_launches()
    got = fd_ops.flash_decode_partial(q, k, v, scale=d ** -0.5, block_k=T)
    assert fd_ops.LAUNCHES["flash_decode"] == 1
    want = fd_ref.flash_decode_partial_plain(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    # acc and l are sums over T: held as the normalised output acc / l
    # and l relative
    torch.testing.assert_close(got[0] / got[2], want[0] / want[2],
                               atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)


def test_flash_decode_on_card_matches_decode_attention(cuda):
    rng = np.random.default_rng(3)
    B, T, H, KH, d = 2, 256, 8, 2, 32
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32  # noqa: E731
                                    ).to(cuda)
    q, kc, vc, kn, vn = (mk(B, 1, H, d), mk(B, T, KH, d), mk(B, T, KH, d),
                         mk(B, 1, KH, d), mk(B, 1, KH, d))
    got = fd_ops.flash_decode(q, kc, vc, kn, vn, scale=d ** -0.5, block_k=64)
    want = fd_ref.flash_decode_ref(q, kc, vc, kn, vn, scale=d ** -0.5)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,T,d,split", [
    (2, 4, 2, 128, 32, 256),      # T below one split: one block a head
    (2, 32, 8, 4096, 80, 256),    # the serving cut: 16 splits
    (2, 8, 8, 200, 16, 64),       # ragged: the fourth split holds 8 keys
    (1, 48, 1, 256, 128, 160),    # G = 48 in groups of 8, splits 160 + 96
    (3, 6, 2, 100, 24, 32),       # G = 3 in a group of 4, d = 24
    (16, 32, 8, 1024, 80, 64)])   # 2048 blocks
def test_flash_decode_split_kernel_matches_plain(cuda, dtype, B, H, KH, T, d,
                                                 split):
    """The two-pass kernel at a given split against the plain version cut
    at the same boundaries (splits of ``split`` keys, the last ragged) and
    against the uncut one."""
    rng = np.random.default_rng(T + split)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32  # noqa: E731
                                    ).to(cuda, dtype)
    q, k, v = mk(B, H, d), mk(B, T, KH, d), mk(B, T, KH, d)
    fd_ops.reset_launches()
    got = fd_ops._partial_split(q, k, v, d ** -0.5, split)
    assert fd_ops.LAUNCHES["flash_decode"] == 1
    cut = fd_ref.flash_decode_partial_split_plain(q, k, v, d ** -0.5, split)
    whole = fd_ref.flash_decode_partial_plain(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    for want in (cut, whole):
        torch.testing.assert_close(got[0] / got[2], want[0] / want[2],
                                   atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,KH,d,causal,window", [
    (2, 77, 4, 1, 16, True, None),     # one query tile, ragged keys, KH = 1
    (1, 200, 4, 2, 80, True, 64),      # window on a tile edge
    (1, 300, 2, 1, 8, True, 1),        # only the diagonal: d padded to 16
    (2, 256, 2, 2, 128, False, 128),
    (1, 300, 4, 4, 80, True, 129),     # window one past a tile edge
    (1, 200, 8, 1, 80, False, None),   # every key, 8 heads on one kv head
    (1, 130, 2, 2, 48, True, None),    # d = 48 runs N = 64: a box all past d
    (1, 1, 2, 1, 80, True, None)])
def test_flash_attention_bf16_tensor_core_edges(cuda, B, S, H, KH, d, causal,
                                                window):
    rng = np.random.default_rng(S * d + H)
    q, k, v = _qkv(rng, B, S, S, H, KH, d, torch.bfloat16, cuda)
    got = fa_ops.flash_attention(q, k, v, d ** -0.5, causal, window)
    want = fa_ref.flash_attention_plain(q, k, v, d ** -0.5, causal, window)
    hilo = fa_ref.flash_attention_hilo_plain(q, k, v, d ** -0.5, causal,
                                             window)
    torch.cuda.synchronize()
    _within_bf16_ulp(got, want)
    _within_bf16_ulp(got, hilo)


def test_flash_attention_bf16_refuses_a_scale_not_above_zero(cuda):
    """The bf16 kernel's running max is taken on the unscaled q.k."""
    q, k, v = _qkv(np.random.default_rng(0), 1, 64, 64, 2, 2, 16,
                   torch.bfloat16, cuda)
    fa_ops.reset_launches()
    for scale in (-0.25, 0.0):
        with pytest.raises(NotImplementedError, match="scale > 0"):
            fa_ops.flash_attention(q, k, v, scale, True, None)
    assert fa_ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_flash_attention_bf16_every_head_dim(cuda, d):
    """Every head dim the wrapper takes: the PV wgmma's N is d rounded up
    to 16, 32, 64, 80 or 128, the boxes past d zero-filled by TMA."""
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, 1, 150, 150, 4, 2, d, torch.bfloat16, cuda)
    got = fa_ops.flash_attention(q, k, v, d ** -0.5, True, 100)
    want = fa_ref.flash_attention_plain(q, k, v, d ** -0.5, True, 100)
    torch.cuda.synchronize()
    _within_bf16_ulp(got, want)


def _within_tf32x3_plain(got, q, k, v, scale, causal, window):
    """The float32 kernel against its own arithmetic
    (``ref.flash_attention_tf32x3_plain``, 3xTF32 products in another
    order): |d| <= 2e-5 + 1e-4 |x|."""
    want = fa_ref.flash_attention_tf32x3_plain(q, k, v, scale, causal,
                                               window)
    excess = ((got - want).abs() / (2e-5 + 1e-4 * want.abs())).max()
    assert float(excess) <= 1.0, float(excess)


@pytest.mark.parametrize("B,Sq,Sk,H,KH,d,causal,window", [
    (2, 1, 1, 2, 1, 64, True, None),      # one query, one key
    (2, 63, 63, 4, 4, 16, True, None),    # one ragged tile, G 1
    (1, 65, 65, 4, 2, 48, False, None),   # one row past a tile, G 2
    (2, 150, 150, 8, 2, 80, True, 100),   # a window ending inside a tile
    (1, 333, 333, 4, 1, 128, True, 70),   # G 4, d 128, a window
    (1, 1000, 1000, 4, 2, 64, True, 300),
    (1, 1000, 1000, 2, 2, 8, False, None),
    (2, 150, 150, 2, 1, 104, False, 33),  # non-causal, a window inside
    (1, 333, 333, 8, 8, 24, True, None),
    (1, 200, 77, 4, 2, 32, False, None),  # fewer keys than queries
    (1, 100, 333, 4, 4, 80, True, None),  # more keys than queries
    (1, 1000, 1000, 4, 1, 128, False, 129)])
def test_flash_attention_f32_tensor_core_edges(cuda, B, Sq, Sk, H, KH, d,
                                               causal, window):
    """The float32 kernel (3xTF32 on the tensor cores) at tile edges
    against both plain versions: ``flash_attention_plain`` within 2e-5,
    ``flash_attention_tf32x3_plain`` within 2e-5 + 1e-4 |x|; and two calls
    bit for bit."""
    rng = np.random.default_rng(Sq * d + H)
    q, k, v = _qkv(rng, B, Sq, Sk, H, KH, d, torch.float32, cuda)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, d ** -0.5, causal, window)
    again = fa_ops.flash_attention(q, k, v, d ** -0.5, causal, window)
    assert fa_ops.LAUNCHES["flash_attention"] == 2
    want = fa_ref.flash_attention_plain(q, k, v, d ** -0.5, causal, window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    _within_tf32x3_plain(got, q, k, v, d ** -0.5, causal, window)


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_flash_attention_f32_every_head_dim(cuda, d):
    """Every head dim the wrapper takes in float32: the tiles' width is d
    rounded up to 16, 32, 64, 80 or 128, the columns past d zero."""
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, 1, 150, 150, 4, 2, d, torch.float32, cuda)
    got = fa_ops.flash_attention(q, k, v, d ** -0.5, True, 100)
    want = fa_ref.flash_attention_plain(q, k, v, d ** -0.5, True, 100)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    _within_tf32x3_plain(got, q, k, v, d ** -0.5, True, 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KH,d", [(5, 5, 8), (10, 2, 40), (9, 1, 96),
                                    (16, 2, 128), (7, 1, 56)])
def test_flash_decode_head_groups_and_dims(cuda, dtype, H, KH, d):
    """G = 1, 5, 9, 8 and 7 query heads a kv head (register groups of 1,
    8 with guards, two groups), head dims 8 to 128, at the default split."""
    rng = np.random.default_rng(H * d)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32  # noqa: E731
                                    ).to(cuda, dtype)
    q, k, v = mk(3, H, d), mk(3, 640, KH, d), mk(3, 640, KH, d)
    got = fd_ops.flash_decode_partial(q, k, v, scale=d ** -0.5, block_k=64)
    want = fd_ref.flash_decode_partial_plain(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0] / got[2], want[0] / want[2],
                               atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)


def test_lm_kernels_take_views_off_16_bytes(cuda):
    """Inputs that start 2 bytes past an aligned address (TMA and the
    16-byte loads need 16): the wrappers copy them, the results hold."""
    rng = np.random.default_rng(8)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32  # noqa: E731
                                    ).to(cuda, torch.bfloat16)
    off = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(  # noqa: E731
        t.shape)
    q, k, v = mk(1, 100, 4, 80), mk(1, 100, 2, 80), mk(1, 100, 2, 80)
    assert off(q).data_ptr() % 16 != 0
    _within_bf16_ulp(fa_ops.flash_attention(off(q), off(k), off(v), 0.1),
                     fa_ref.flash_attention_plain(q, k, v, 0.1))
    qd = mk(1, 4, 80)
    got = fd_ops.flash_decode_partial(off(qd), off(k), off(v), scale=0.1,
                                      block_k=100)
    want = fd_ref.flash_decode_partial_plain(qd, k, v, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0] / got[2], want[0] / want[2],
                               atol=1e-5, rtol=1e-4)


def _fresh_kernel_events(fn, args, kwargs=None):
    """{kernel name: events} of one profiled call of ``fn``
    ("module:function") on ``args`` in a fresh process
    (``repro_torch.profiling``): later sessions of one long process lose
    kernel events (PERF.md §7), even with acc_events=True."""
    return profiling.fresh("repro_torch.profiling:call_events",
                           (args, kwargs or {}), fn=fn, timeout=600)


def _randn(g, *shape):
    return torch.randn(shape, generator=g, device="cuda")


def test_flash_attention_runs_the_kernel_of_its_type(cuda):
    """bf16 launches its wgmma kernel, float32 its 3xTF32 tensor-core
    one, each and only it (torch.profiler's kernel names, each profile in
    a fresh process)."""
    for dtype, name in fa_ops.KERNELS.items():
        g = torch.Generator("cuda").manual_seed(0)
        q, k, v = (_randn(g, 1, 128, 2, 32).to(dtype) for _ in range(3))
        events = _fresh_kernel_events(
            "repro_torch.kernels.flash_attention.ops:flash_attention",
            (q, k, v, 0.25))
        assert any(name in n for n in events), (dtype, events)
        others = [o for o in fa_ops.KERNELS.values() if o != name]
        assert not any(o in n for o in others for n in events), (dtype,
                                                                 events)


def test_flash_bwd_runs_the_kernels_of_its_type(cuda):
    """The backward launches its type's three kernels (bf16 on wgmma with
    a TMA ring, float32 on the tensor cores by 3xTF32), each once and none
    of the other type's (torch.profiler's kernel names in a fresh
    process)."""
    for dtype, names in fa_ops.BWD_KERNELS.items():
        g = torch.Generator("cuda").manual_seed(0)
        q, k, v, do = (_randn(g, 1, 128, 2, 32).to(dtype) for _ in range(4))
        events = _fresh_kernel_events(
            "repro_torch.kernels.flash_attention.ops:"
            "flash_attention_bwd_kernel", (q, k, v, do, 0.25))
        for name in names:
            assert [c for n, c in events.items() if name in n] == [1], (
                dtype, name, events)
        others = [o for t, os_ in fa_ops.BWD_KERNELS.items() if t != dtype
                  for o in os_]
        assert not any(o in n for o in others for n in events), (dtype,
                                                                 events)


def test_reduced_danube_served_on_card(cuda):
    """Prefill through flash_attention == the banded swa route; 8 decode
    steps through flash_decode == decode_attention (float32)."""
    cfg = reduced(get_config("h2o-danube-1.8b"), seq=128)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda,
                         torch.float32)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)), device=cuda)
    fa_ops.reset_launches()
    lf, cf = make_prefill_step(cfg, ShardingContext(attn_impl="flash"))(
        params, {"tokens": toks})
    assert fa_ops.LAUNCHES["flash_attention"] == cfg.n_layers
    ls, cs = make_prefill_step(cfg, ShardingContext(attn_impl="swa"))(
        params, {"tokens": toks})
    torch.testing.assert_close(lf, ls, atol=1e-4, rtol=1e-3)
    for name in cf:
        torch.testing.assert_close(cf[name].k, cs[name].k, atol=1e-5,
                                   rtol=1e-5)
    steps = {impl: make_decode_step(cfg, ShardingContext(attn_impl=impl))
             for impl in ("flash", "swa")}
    tok = lf[:, -1].argmax(-1, keepdim=True)
    fd_ops.reset_launches()
    for i in range(8):
        batch = {"token": tok, "cache_pos": 128 + i}
        a, cf = steps["flash"](params, batch, cf)
        b, cs = steps["swa"](params, batch, cs)
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)
        tok = a[:, -1].argmax(-1, keepdim=True)
    assert fd_ops.LAUNCHES["flash_decode"] == 8 * cfg.n_layers


# ------------------------------------------------------------- ssd_scan

def _ssd_inputs(rng, B, S, H, P, N, dtype, dev, dt_scale=0.5, state=False):
    """x, dt (softplus of a normal, times dt_scale), Bm, Cm, A (H,)
    negative, state0 (or None) as the model hands them to ssd_scan."""
    mk = lambda *s: torch.as_tensor(rng.normal(size=s),  # noqa: E731
                                    dtype=torch.float32).to(dev)
    dt = torch.nn.functional.softplus(mk(B, S, H)) * dt_scale
    A = -torch.exp(mk(H))
    state0 = mk(B, H, P, N) if state else None
    return (mk(B, S, H, P).to(dtype), dt, mk(B, S, N).to(dtype),
            mk(B, S, N).to(dtype), A, state0)


SSD_SHAPES = [  # (B, S, H, P, N, chunk, state0)
    (2, 512, 4, 64, 128, 256, False), (1, 100, 2, 16, 16, 256, True),
    (2, 96, 3, 32, 64, 32, True), (1, 384, 2, 128, 32, 128, False),
    (2, 48, 2, 16, 4, 16, True), (1, 256, 2, 16, 128, 64, True),
    (2, 256, 3, 128, 16, 128, True), (1, 512, 2, 64, 64, 256, True),
    (1, 192, 2, 48, 8, 64, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,state", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, dtype, B, S, H, P, N, chunk,
                                       state):
    rng = np.random.default_rng(S + N)
    args = _ssd_inputs(rng, B, S, H, P, N, dtype, cuda, state=state)
    ssd_ops.reset_launches()
    y, st = ssd_ops.ssd_scan(*args[:5], chunk=chunk, state0=args[5])
    assert ssd_ops.LAUNCHES["ssd_scan"] == 1
    y_p, st_p = ssd_ref.ssd_scan_plain(*args[:5], chunk, args[5])
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == args[0].shape
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-4)
    else:
        _within_bf16_ulp(y, y_p)
        # and the plain version that rounds as the tensor cores do
        y_h, st_h = ssd_ref.ssd_scan_hilo_plain(*args[:5], chunk, args[5])
        _within_bf16_ulp(y, y_h)
        assert float((st - st_h).abs().max()) <= 1e-4 * float(
            st_h.abs().max())
    torch.testing.assert_close(st, st_p, atol=1e-4 * float(
        st_p.abs().max()), rtol=1e-4)


def test_ssd_scan_kernel_large_decay_stays_finite(cuda):
    """dt A of about -40 a step: exp(cum_i - cum_j) above the diagonal
    would overflow to inf; the kernel never computes it."""
    rng = np.random.default_rng(7)
    args = _ssd_inputs(rng, 2, 128, 2, 16, 16, torch.float32, cuda,
                       dt_scale=20.0, state=True)
    y, st = ssd_ops.ssd_scan(*args[:5], chunk=64, state0=args[5])
    y_p, st_p = ssd_ref.ssd_scan_plain(*args[:5], 64, args[5])
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(st, st_p, atol=1e-5, rtol=1e-4)


def test_ssd_scan_kernel_large_decay_stays_finite_bf16(cuda):
    """The bf16 tensor-core route at dt A of about -40 a step: finite,
    within one bf16 ulp of both plain versions."""
    rng = np.random.default_rng(7)
    args = _ssd_inputs(rng, 2, 128, 2, 16, 16, torch.bfloat16, cuda,
                       dt_scale=20.0, state=True)
    y, st = ssd_ops.ssd_scan(*args[:5], chunk=64, state0=args[5])
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    for plain in (ssd_ref.ssd_scan_plain, ssd_ref.ssd_scan_hilo_plain):
        y_p, st_p = plain(*args[:5], 64, args[5])
        _within_bf16_ulp(y, y_p)
        torch.testing.assert_close(st, st_p, atol=1e-4 * float(
            st_p.abs().max()), rtol=1e-4)


def test_ssd_scan_block_widths_agree_bitwise(cuda):
    """16, 32 or 64 columns of p a block (float32) or a pass (bf16):
    every output entry is the same sum in the same order."""
    rng = np.random.default_rng(5)
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, Bm, Cm, A, s0 = _ssd_inputs(rng, 2, 256, 3, 64, 64, dtype,
                                           cuda, state=True)
        outs = [ssd_ops._launch(x, dt, Bm, Cm, A, 128, s0, pb)
                for pb in (16, 32, 64)]
        for y, st in outs[1:]:
            assert torch.equal(y, outs[0][0]) and torch.equal(st, outs[0][1])


def test_ssd_scan_takes_views_off_16_bytes(cuda):
    """bf16 inputs that start 2 bytes past an aligned address (the
    kernels read 16 bytes at a time): the wrapper copies them."""
    rng = np.random.default_rng(9)
    args = _ssd_inputs(rng, 1, 128, 2, 32, 16, torch.bfloat16, cuda,
                       state=True)
    off = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(  # noqa: E731
        t.shape)
    moved = [off(t) for t in args[:5]] + [off(args[5])]
    assert moved[0].data_ptr() % 16 != 0 and moved[2].data_ptr() % 16 != 0
    y, st = ssd_ops.ssd_scan(*moved[:5], chunk=64, state0=moved[5])
    y_p, st_p = ssd_ref.ssd_scan_hilo_plain(*args[:5], 64, args[5])
    torch.cuda.synchronize()
    _within_bf16_ulp(y, y_p)
    torch.testing.assert_close(st, st_p, atol=1e-4 * float(
        st_p.abs().max()), rtol=1e-4)


def test_ssd_scan_runs_the_kernels_of_its_type(cuda):
    """bf16 launches the tensor-core schedule, float32 the CUDA-core
    kernel, each and only it (torch.profiler's kernel names, each profile
    in a fresh process: ``_fresh_kernel_events``)."""
    kinds = {torch.bfloat16: ("ssd_chunk_out", "ssd_scan_fwd"),
             torch.float32: ("ssd_scan_fwd", "ssd_chunk_out")}
    for dtype, (name, other) in kinds.items():
        g = torch.Generator("cuda").manual_seed(0)
        x = _randn(g, 1, 128, 2, 16).to(dtype)
        dt = torch.nn.functional.softplus(_randn(g, 1, 128, 2)) * 0.5
        Bm, Cm = (_randn(g, 1, 128, 16).to(dtype) for _ in range(2))
        A = -torch.exp(_randn(g, 2))
        events = _fresh_kernel_events(
            "repro_torch.kernels.ssd_scan.ops:ssd_scan", (x, dt, Bm, Cm, A),
            {"chunk": 64})
        assert any(name in n for n in events), (dtype, events)
        assert not any(other in n for n in events), (dtype, events)


def test_ssd_scan_kernel_raises_on_what_it_does_not_take(cuda):
    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.bfloat16):
        for (S, P, N, chunk), match in [((64, 16, 24, 64), "d_state"),
                                        ((64, 8, 16, 64), "head_dim"),
                                        ((1024, 16, 16, 512), "chunk")]:
            args = _ssd_inputs(rng, 1, S, 2, P, N, dtype, cuda)
            with pytest.raises(NotImplementedError, match=match):
                ssd_ops.ssd_scan(*args[:5], chunk=chunk)
    args = _ssd_inputs(rng, 1, 96, 2, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple"):
        ssd_ops.ssd_scan(*args[:5], chunk=64)


def test_reduced_mamba2_served_on_card(cuda):
    """Prefill through ssd_scan (n_layers launches) and 8 greedy decode
    steps (no launch) on the card == the CPU's plain route (float32)."""
    cfg = reduced(get_config("mamba2-130m"), seq=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    on_card = {k: _to(v, cuda) for k, v in params.items()}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    ssd_ops.reset_launches()
    lg, cg = prefill(on_card, {"tokens": toks.to(cuda)})
    assert ssd_ops.LAUNCHES["ssd_scan"] == cfg.n_layers
    lc, cc = prefill(params, {"tokens": toks})
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-3)
    tok = lc[:, -1].argmax(-1, keepdim=True)
    for i in range(8):
        a, cg = decode(on_card, {"token": tok.to(cuda), "cache_pos": 128 + i},
                       cg)
        b, cc = decode(params, {"token": tok, "cache_pos": 128 + i}, cc)
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3)
        assert torch.equal(a.cpu()[:, -1].argmax(-1), b[:, -1].argmax(-1))
        tok = b[:, -1].argmax(-1, keepdim=True)
    assert ssd_ops.LAUNCHES["ssd_scan"] == cfg.n_layers
    for name in cc:
        for got, want in zip(cg[name], cc[name]):
            torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return {k: _to(v, dev) for k, v in tree.items()}


# ------------------------------------- the MoE and frontend archs' shapes

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KH,d,causal", [
    (256, 16, 8, 64, True),      # granite-moe-1b-a400m's layer
    (300, 16, 8, 128, True),     # internvl2-2b's, a ragged query tile
    (250, 16, 16, 80, False)])   # hubert-xlarge's: non-causal, S unaligned
def test_flash_attention_at_the_moe_and_frontend_shapes(cuda, dtype, S, H,
                                                        KH, d, causal):
    rng = np.random.default_rng(S + d)
    q, k, v = _qkv(rng, 2, S, S, H, KH, d, dtype, cuda)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, d ** -0.5, causal, None)
    assert fa_ops.LAUNCHES["flash_attention"] == 1
    want = fa_ref.flash_attention_plain(q, k, v, d ** -0.5, causal, None)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        _within_bf16_ulp(got, want)
        _within_bf16_ulp(got, fa_ref.flash_attention_hilo_plain(
            q, k, v, d ** -0.5, causal, None))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_decode_at_the_moe_and_frontend_shapes(cuda, dtype, d):
    """16 query heads over 8 kv heads (G = 2), a cache with no window."""
    rng = np.random.default_rng(d)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32  # noqa: E731
                                    ).to(cuda, dtype)
    q, k, v = mk(2, 16, d), mk(2, 320, 8, d), mk(2, 320, 8, d)
    fd_ops.reset_launches()
    got = fd_ops.flash_decode_partial(q, k, v, scale=d ** -0.5, block_k=320)
    assert fd_ops.LAUNCHES["flash_decode"] == 1
    want = fd_ref.flash_decode_partial_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(got[0] / got[2], want[0] / want[2],
                               atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_reduced_moe_prefill_on_card_matches_cpu(cuda, arch, monkeypatch):
    """float32 prefill through flash_attention (and ssd_scan in jamba's
    Mamba layers) on the card == the CPU's plain route: logits 1e-4 +
    1e-3|x|, caches 1e-5 + 1e-4|x|, every MoE layer's top-k identical."""
    cfg = reduced(get_config(arch), seq=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    topi = []
    route = moe_lib._route

    def spy(*a):
        out = route(*a)
        topi.append(out[2].cpu())
        return out

    monkeypatch.setattr(moe_lib, "_route", spy)
    prefill = make_prefill_step(cfg, ShardingContext(attn_impl="flash"))
    fa_ops.reset_launches()
    lg, cg = prefill(_to(params, cuda), {"tokens": toks.to(cuda)})
    assert fa_ops.LAUNCHES["flash_attention"] == cfg.layer_kinds().count(
        "attn")
    card = topi[:]
    topi.clear()
    lc, cc = prefill(params, {"tokens": toks})
    assert len(card) == len(topi) > 0
    for a, b in zip(card, topi):
        assert torch.equal(a, b)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-3)
    for name in cc:
        for got, want in zip(cg[name], cc[name]):
            torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)


# ------------------------------------------------- multi-sensor fleet frames

# (S, C, M): one sensor as a fleet, three, the reference's eight at the
# serving shape, and a ragged C (13: predict blocks of 8 tracks and cost
# blocks of 128 straddle sensors)
FLEET_CASES = [(1, 200, 64), (3, 200, 64), (8, 1024, 256), (3, 13, 12)]


def _fleet_inputs(kind, S, C, M, dev):
    """S sensors' random frame inputs (each its own seed), stacked on the
    sensor axis: x (K, S, C, n) for the IMM, a leading S elsewhere."""
    if kind == "imm":
        n, m, obs, K = 9, 3, [0, 1, 2], 4
    else:
        model = get_filter(kind)
        n, m, K = model.n, model.m, None
        obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
    per = [random_frame_inputs(np.random.default_rng(100 * S + C + s), n, m,
                               C, M, obs, K=K, spread=20.0)
           for s in range(S)]
    axis = [1, 1] if K else [0, 0]
    out = [np.stack([p[i] for p in per],
                    axis=axis[i] if i < len(axis) else 0)
           for i in range(len(per[0]))]
    return _dev(out, dev)


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
@pytest.mark.parametrize("S,C,M", FLEET_CASES)
def test_fleet_frame_kernel_matches_plain_and_single(cuda, kind, S, C, M):
    """katana_frame over S stacked sensors: one launch count, assoc (S, C),
    waves (S,), x' and P' bit for bit with the plain version and with S
    single-sensor calls."""
    model = get_filter(kind)
    x, P, z, zv, act = _fleet_inputs(kind, S, C, M, cuda)
    gate, rounds = ttr.CHI2_99[model.m], min(C, M)
    ops.reset_launches()
    got = ops.katana_frame(model, x, P, z, zv, act, gate, rounds,
                           return_waves=True)
    assert ops.LAUNCHES["katana_frame"] == 1
    assert ops.LAUNCHES["greedy_assign"] == 1
    want = ref.katana_frame_plain(model, x, P, z, zv, act, gate, rounds,
                                  return_waves=True)
    torch.cuda.synchronize()
    assert got[2].shape == (S, C) and len(got[3]) == S
    assert torch.equal(got[2], want[2])
    assert [int(w) for w in got[3]] == want[3]
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert int((got[2] >= 0).sum()) > 0
    for s in range(S):
        one = ops.katana_frame(model, x[s], P[s], z[s], zv[s], act[s], gate,
                               rounds, return_waves=True)
        assert int(one[3]) == int(got[3][s])
        for a, b in zip(one[:3], got[:3]):
            assert torch.equal(a, b[s])


@pytest.mark.parametrize("k1", [False, True])
@pytest.mark.parametrize("S,C,M", FLEET_CASES)
def test_fleet_imm_frame_kernel_matches_plain_and_single(cuda, k1, S, C, M):
    """katana_imm_frame over S stacked sensors (K = 4 on imm_frame.cu;
    K = 1 on frame.cu): one launch count, every output bit for bit with the
    plain version and with S single-sensor calls."""
    if k1:
        imm = as_imm(get_filter("ekf"))
        x, P, z, zv, act = _fleet_inputs("ekf", S, C, M, cuda)
        x, P = x[None].contiguous(), P[None].contiguous()
        mu = torch.ones((S, C, 1), device=cuda)
        gate = 13.28
    else:
        imm = make_imm()
        x, P, mu, z, zv, act = _fleet_inputs("imm", S, C, M, cuda)
        gate = 11.34
    rounds = min(C, M)
    ops.reset_launches()
    got = ops.katana_imm_frame(imm, x, P, mu, z, zv, act, gate, rounds,
                               return_waves=True)
    assert ops.LAUNCHES["katana_imm_frame"] == 1
    assert ops.LAUNCHES["greedy_assign"] == 1
    want = ref.katana_imm_frame_plain(imm, x, P, mu, z, zv, act, gate,
                                      rounds, return_waves=True)
    torch.cuda.synchronize()
    assert got[4].shape == (S, C) and got[3].shape == (S, C, x.shape[-1])
    assert [int(w) for w in got[5]] == want[5]
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b), float((a.double() - b.double()).abs().max())
    for s in range(S):
        one = ops.katana_imm_frame(imm, x[:, s].contiguous(),
                                   P[:, s].contiguous(), mu[s], z[s], zv[s],
                                   act[s], gate, rounds, return_waves=True)
        assert int(one[5]) == int(got[5][s])
        for i, (a, b) in enumerate(zip(one[:5], got[:5])):
            assert torch.equal(a, b[:, s] if i < 2 else b[s])


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_fleet_engine_on_card_matches_cpu(cuda, kind):
    """ShardedBankEngine on the card (one shard, and two shards on the one
    card) against the CPU fleet over a scene in which the sensors
    disagree: one launch count a shard a frame, identical assoc and ids,
    the two card fleets bit for bit, states within 1e-4 (imm 5e-4) of the
    CPU's."""
    from repro_torch.serving.engine import ShardedBankEngine

    model = make_imm() if kind == "imm" else get_filter(kind)
    S, T = 4, 20
    cfg = ttr.TrackerConfig(capacity=32, max_meas=16)
    rng = np.random.default_rng(31)
    pos = rng.normal(size=(S, 5, model.m)) * 5
    gpu = ShardedBankEngine(model, S, cfg)
    two = ShardedBankEngine(model, S, cfg, devices=("cuda", "cuda"))
    cpu = ShardedBankEngine(model, S, cfg, devices=("cpu",))
    name = "katana_imm_frame" if kind == "imm" else "katana_frame"
    tol = 5e-4 if kind == "imm" else 1e-4
    ops.reset_launches()
    for t in range(T):
        pos = pos + 0.05
        z = np.zeros((S, cfg.max_meas, model.m), np.float32)
        v = np.zeros((S, cfg.max_meas), bool)
        z[:, :5] = pos + rng.normal(size=pos.shape) * 0.05
        v[:, :5] = True
        v[1] = v[1] & (t < 6)  # sensor 1 goes dark
        v[2] = v[2] & (t >= 4)       # sensor 2 spawns late
        a, b, c = gpu.frame(z, v), two.frame(z, v), cpu.frame(z, v)
        assert torch.equal(a.assoc.cpu(), c.assoc)
        assert torch.equal(a.bank.track_id.cpu(), c.bank.track_id)
        for f, g in zip(a.bank, b.bank):
            assert torch.equal(f, g)
        _close(a.bank.x.cpu(), c.bank.x, tol)
        if kind == "imm":
            assert torch.equal(a.x_est, b.x_est)
            _close(a.x_est.cpu(), c.x_est, tol)
    assert ops.LAUNCHES[name] == 3 * T
    assert ops.LAUNCHES["greedy_assign"] == 3 * T
    zs = rng.normal(size=(12, S, cfg.capacity, model.m)).astype(np.float32)
    valid = rng.random((12, S, cfg.capacity)) > 0.3
    ops.reset_launches()
    r1, r2 = gpu.replay(zs, valid), two.replay(zs, valid)
    assert ops.LAUNCHES["katana_imm_sequence"] == 3
    np.testing.assert_array_equal(r1, r2)
    _close(torch.as_tensor(r1), torch.as_tensor(cpu.replay(zs, valid)), tol)


# ------------------------------------------------- the streaming front end

@pytest.mark.parametrize("kind", ["imm", "lkf"])
def test_stream_failover_bitwise_on_card(cuda, tmp_path, kind):
    """``StreamFrontEnd`` on the card (two shards of four lanes on the one
    card, C = 64, three tenants): shard 0 killed at cycle 7 of 16, and
    every tenant's stream is bit for bit the uninterrupted run's on the
    card; one frame launch (and one greedy) a dispatch or a replayed WAL
    frame, no dispatch error, no breaker trip; ids, hits and ages equal to
    the CPU front end's, states within 1e-4 (imm 5e-4)."""
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.stream import StreamConfig, StreamFrontEnd

    from test_torch_chaos import (TENANTS, FakeClock,
                                  assert_streams_bitwise, drive)

    model = make_imm() if kind == "imm" else get_filter(kind)
    name = "katana_imm_frame" if kind == "imm" else "katana_frame"
    cfg = ttr.TrackerConfig(capacity=64, max_meas=8)
    scfg = StreamConfig(n_shards=2, lanes_per_shard=4, queue_depth=8,
                        checkpoint_every=4, degrade_at=5.0, coast_at=6.0,
                        reject_at=7.0)
    runs = {}
    for tag, dev, plan in (("ref", "cuda", FaultPlan()),
                           ("kill", "cuda", FaultPlan(kill_shards={7: 0})),
                           ("cpu", "cpu", FaultPlan(kill_shards={7: 0}))):
        front = StreamFrontEnd(model, scfg, cfg,
                               ckpt_dir=str(tmp_path / tag),
                               clock=FakeClock(), devices=(dev,))
        wal = [0]
        restore = front._restore_tenant

        def counted(t, s, lane, _restore=restore, _wal=wal):
            _wal[0] += len(t.wal)
            return _restore(t, s, lane)

        front._restore_tenant = counted
        ops.reset_launches()
        rep = drive(front, plan, cycles=16)
        torch.cuda.synchronize()
        assert rep.exceptions == []
        assert front.stats.dispatch_errors == 0
        assert front.breaker.trips == 0
        if dev == "cuda":
            want = front.stats.dispatches + wal[0]
            assert ops.LAUNCHES[name] == want
            assert ops.LAUNCHES["greedy_assign"] == want
            assert all(sh.banks.x.device.type == "cuda"
                       for sh in front.shards if sh.alive)
        runs[tag] = (front, rep)
    kill_front, kill = runs["kill"]
    assert kill_front.stats.failovers == 2
    assert kill_front.shards_alive() == ["shard1"]
    assert_streams_bitwise(runs["ref"][1], kill)
    tol = 5e-4 if kind == "imm" else 1e-4
    cpu = runs["cpu"][1]
    for t in TENANTS:
        for g, c in zip(kill.updates[t], cpu.updates[t], strict=True):
            assert (g.frame, g.seq, g.kind, g.shard) == \
                (c.frame, c.seq, c.kind, c.shard)
            assert [(s.track_id, s.hits, s.age) for s in g.snapshots] == \
                [(s.track_id, s.hits, s.age) for s in c.snapshots]
            for gs, cs in zip(g.snapshots, c.snapshots):
                np.testing.assert_allclose(gs.state, cs.state, atol=tol,
                                           rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,d,window", [(1, 600, 4, 2, 80, None),
                                               (2, 256, 8, 2, 32, 64)])
def test_flash_gradient_is_the_plain_forwards(cuda, dtype, B, S, H, KH, d,
                                              window):
    """Tolerance: none. dq, dk, dv through ``FlashAttention`` with the
    kernel's forward equal those with the plain forward on the card (the
    backward reads q, k, v, not the output); one launch; and in float32
    the gradient lies within 2e-5 + 1e-4 relative of the float64 oracle
    (a ragged S = 600 covers the 512-row block's tail)."""
    rng = np.random.default_rng(S + H)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, S, h, d)),
                                   dtype=torch.float32).to(cuda, dtype)
                   for h in (H, KH, KH, H))
    scale = d ** -0.5

    def grads(forward):
        t = [x.detach().requires_grad_() for x in (q, k, v)]
        o = fa_ops.FlashAttention.apply(*t, scale, True, window, 512,
                                        forward)
        return torch.autograd.grad(o, t, do)

    fa_ops.reset_launches()
    got = grads(fa_ops.flash_attention_fwd)
    assert fa_ops.LAUNCHES["flash_attention"] == 1
    want = grads(fa_ref.flash_attention_plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if dtype == torch.float32:
        G = H // KH
        t = [x.detach().double().requires_grad_() for x in (q, k, v)]
        kb, vb = (x.repeat_interleave(G, dim=2) for x in t[1:])
        s = torch.einsum("bqhd,bkhd->bhqk", t[0], kb) * scale
        ok = fa_ref.mask(S, S, True, window, cuda)
        o = torch.einsum("bhqk,bkhd->bqhd",
                         torch.softmax(s.masked_fill(~ok, -1e30), -1), vb)
        for a, b in zip(got, torch.autograd.grad(o, t, do.double())):
            torch.testing.assert_close(a.double(), b, atol=2e-5, rtol=1e-4)


def _bwd_close(got, want, flip=0.0):
    """The backward kernel against its plain version by the rule of
    ``ref.bwd_excess``: float32 2e-5 + 1e-4 relative; bfloat16 two bf16
    ulps, plus for dV ``flip``, the bf16 spacing at each P near a rounding
    midpoint times |dO| (``flash_attention_bwd_plain(..., flips=True)``)."""
    excess = fa_ref.bwd_excess(got, want, flip)
    assert excess <= 1.0, excess


def _bwd_inputs(seed, B, Sq, Sk, H, KH, d, dtype, dev):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32  # noqa: E731
                                    ).to(dev, dtype)
    return mk(B, Sq, H, d), mk(B, Sk, KH, d), mk(B, Sk, KH, d), mk(B, Sq, H, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, d, causal, window, G):
    """B = 2, a ragged S = 150 (two tiles of 64 and 22 rows), KH = 2 kv
    heads of G query heads each: dq, dk, dv of the backward kernel against
    ``flash_attention_bwd_plain`` (``_bwd_close``); one launch."""
    q, k, v, do = _bwd_inputs(d + G, 2, 150, 150, 2 * G, 2, d, dtype, cuda)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention_bwd_kernel(q, k, v, do, d ** -0.5, causal,
                                            window)
    assert fa_ops.LAUNCHES["flash_attention_bwd"] == 1
    *want, flip = fa_ref.flash_attention_bwd_plain(
        q, k, v, do, d ** -0.5, causal, window, flips=True)
    torch.cuda.synchronize()
    for a, b, x, flip in zip(got, want, (q, k, v), (0.0, 0.0, flip)):
        assert a.dtype == dtype and a.shape == x.shape
        _bwd_close(a, b, flip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,causal,window,G,d", [
    (333, 333, True, 100, 4, 80),     # a window ending inside a tile
    (1000, 1000, True, None, 2, 64),  # 15 tiles of 64 and 40 rows
    (150, 333, False, 70, 1, 8),      # d 8: half a 16-column box
    (333, 150, True, 45, 2, 128),     # dkdv's 32-query tiles at d 128
    (1000, 1000, True, 300, 4, 16),
    (200, 333, False, None, 1, 128),
    (333, 1000, True, 129, 4, 8),     # Sq < Sk, a window of 2 tiles + 1
])
def test_flash_bwd_kernel_matches_plain_at_tile_edges(cuda, dtype, Sq, Sk,
                                                      causal, window, G, d):
    """Lengths that are no multiple of the query side's 128 rows, of the
    key tiles of 64 or of dkdv's 128 keys and 64 (32 at d 128) queries,
    windows that end inside a tile, G = 1, 2, 4 and d from 8 to 128: dq,
    dk, dv against ``flash_attention_bwd_plain`` (``_bwd_close``), and
    two calls bit for bit."""
    q, k, v, do = _bwd_inputs(Sq + Sk + d, 2, Sq, Sk, 2 * G, 2, d, dtype,
                              cuda)
    got = fa_ops.flash_attention_bwd_kernel(q, k, v, do, d ** -0.5, causal,
                                            window)
    again = fa_ops.flash_attention_bwd_kernel(q, k, v, do, d ** -0.5,
                                              causal, window)
    *want, flip = fa_ref.flash_attention_bwd_plain(
        q, k, v, do, d ** -0.5, causal, window, flips=True)
    for a, b, c, flip in zip(got, want, again, (0.0, 0.0, flip)):
        assert torch.equal(a, c)
        _bwd_close(a, b, flip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,causal,window", [(100, 130, False, None),
                                                 (130, 100, True, 50),
                                                 (1, 70, False, None),
                                                 (70, 1, True, None)])
def test_flash_bwd_unequal_lengths_match_plain(cuda, dtype, Sq, Sk, causal,
                                               window):
    """Sq != Sk, one query or one key: every row and key masked by the
    true lengths (rows that see no key get no gradient in both)."""
    q, k, v, do = _bwd_inputs(Sq + Sk, 1, Sq, Sk, 4, 2, 32, dtype, cuda)
    got = fa_ops.flash_attention_bwd_kernel(q, k, v, do, 0.2, causal, window)
    *want, flip = fa_ref.flash_attention_bwd_plain(q, k, v, do, 0.2, causal,
                                                   window, flips=True)
    for a, b, flip in zip(got, want, (0.0, 0.0, flip)):
        _bwd_close(a, b, flip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KH,d,window", [(1024, 8, 2, 64, None),
                                             (1000, 8, 2, 80, 300)])
def test_flash_bwd_kernel_within_twice_the_torch_ops_distance(
        cuda, dtype, S, H, KH, d, window):
    """Causal, G = 4, sums over up to 4,096 (query, head) terms a key: max
    |d| of each of the kernel's dq, dk, dv from the float64 oracle (on the
    inputs as given) at most 2x that of the torch-op backward
    ``flash_attention_bwd`` on the same inputs, in both dtypes."""
    q, k, v, do = _bwd_inputs(S + d, 1, S, S, H, KH, d, dtype, cuda)
    scale = d ** -0.5
    got = fa_ops.flash_attention_bwd_kernel(q, k, v, do, scale, True, window)
    ops_route = fa_ops.flash_attention_bwd(q, k, v, do, scale, True, window,
                                           512)
    G = H // KH
    t = [x.detach().double().requires_grad_() for x in (q, k, v)]
    kb, vb = (x.repeat_interleave(G, dim=2) for x in t[1:])
    s = torch.einsum("bqhd,bkhd->bhqk", t[0], kb) * scale
    ok = fa_ref.mask(S, S, True, window, cuda)
    o = torch.einsum("bhqk,bkhd->bqhd",
                     torch.softmax(s.masked_fill(~ok, -1e30), -1), vb)
    oracle = torch.autograd.grad(o, t, do.double())
    for name, a, b, w in zip("qkv", got, ops_route, oracle):
        e_kernel = float((a.double() - w).abs().max())
        e_ops = float((b.double() - w).abs().max())
        assert e_kernel <= 2 * e_ops, (name, e_kernel, e_ops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_one_launch_a_backward_bit_for_bit(cuda, dtype):
    """Tolerance: none. A backward through ``FlashAttention`` on the card
    launches the kernel once and never calls ``flash_attention_bwd``; two
    calls of the kernel agree to the bit (no atomics); views off 16 bytes
    give the same bits as contiguous copies."""
    from unittest import mock

    q, k, v, do = _bwd_inputs(3, 2, 333, 333, 8, 2, 80, dtype, cuda)
    t = [x.detach().requires_grad_() for x in (q, k, v)]
    fa_ops.reset_launches()
    with mock.patch.object(fa_ops, "flash_attention_bwd",
                           side_effect=AssertionError("torch-op backward")):
        o = fa_ops.flash_attention(*t, 80 ** -0.5, True, 128)
        got = torch.autograd.grad(o, t, do)
    assert fa_ops.LAUNCHES == {"flash_attention": 1, "flash_attention_bwd": 1}
    again = fa_ops.flash_attention_bwd_kernel(q, k, v, do, 80 ** -0.5, True,
                                              128)
    off = [torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
           for x in (q, k, v, do)]
    assert off[0].data_ptr() % 16
    views = fa_ops.flash_attention_bwd_kernel(*off, 80 ** -0.5, True, 128)
    for a, b, c in zip(got, again, views):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_on_a_thread_with_no_current_context(cuda, dtype):
    """Tolerance: none. The bf16 kernels encode their TMA tensor maps with a
    driver call, which needs a current context; autograd's device thread
    may have none when the caching allocator serves all its allocations
    (no runtime call has bound it). From a fresh thread whose allocations
    all come from the cache, the backward equals the main thread's."""
    import threading

    q, k, v, do = _bwd_inputs(6, 1, 256, 256, 4, 2, 64, dtype, cuda)
    want = fa_ops.flash_attention_bwd_kernel(q, k, v, do, 0.125, True, None)
    spare = [torch.empty_like(t) for t in (q, k, v) + want]  # cached blocks
    del spare
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = fa_ops.flash_attention_bwd_kernel(q, k, v, do, 0.125,
                                                           True, None)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            out["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert "error" not in out, out.get("error")
    for a, b in zip(out["got"], want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_refuses_what_the_kernel_does_not_take(cuda, dtype):
    q, k, v, do = _bwd_inputs(4, 1, 64, 64, 2, 1, 24, dtype, cuda)
    with pytest.raises(NotImplementedError):
        fa_ops.flash_attention_bwd_kernel(q[..., :20].contiguous(),
                                          k[..., :20].contiguous(),
                                          v[..., :20].contiguous(),
                                          do[..., :20].contiguous(), 0.2)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd_kernel(q, k, v, do.cpu(), 0.2)
    if dtype == torch.bfloat16:
        with pytest.raises(NotImplementedError):
            fa_ops.flash_attention_bwd_kernel(q, k, v, do, -0.2)


def test_imm_scan_lane_kernel_is_its_plain_version(cuda):
    """Tolerance: none. The lane of tests/data/imm_scan_lane.npz through
    the IMM scan kernel and through its plain version on the card: bit
    for bit, NaNs included (the lane's float32 fate is the reference's
    order, tests/test_torch_imm_scan_lane.py)."""
    from unittest import mock

    from repro_torch.kernels import build

    d = np.load(Path(__file__).resolve().parent / "data"
                / "imm_scan_lane.npz")
    imm = as_imm(make_imm())
    zs, x0, P0 = (torch.as_tensor(a.copy()).to(cuda)
                  for a in (d["zs"][:, None], d["x0"], d["P0"]))
    kw = dict(mu0=torch.as_tensor(d["mu0"][None].copy()).to(cuda),
              valid=torch.as_tensor(d["valid"][:, None].copy()).to(cuda))
    ops.reset_launches()
    kern = ops.katana_imm_sequence(imm, zs, x0, P0, **kw)
    assert ops.LAUNCHES["katana_imm_sequence"] == _chunks_of(
        "katana_imm_sequence", zs.shape[0])
    with mock.patch.object(build, "on_cuda", lambda t: False):
        plain = ops.katana_imm_sequence(imm, zs, x0, P0, **kw)
    same = (kern == plain) | (torch.isnan(kern) & torch.isnan(plain))
    assert bool(same.all())


# -- the mesh paths on 2 ranks of one card ---------------------------------

@pytest.fixture(scope="module")
def mesh_on_card(tmp_path_factory):
    """Every case of ``card_job`` in one 2-rank ``gloo`` world on the card
    (a deadline of 300 s), and the inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from _torch_mesh_worker import make_inputs
    from repro_torch.launch import local_world

    d = tmp_path_factory.mktemp("card_mesh")
    inp = make_inputs(np.random.default_rng(0))
    np.savez(d / "inputs.npz", **inp)
    ranks = local_world.run("_torch_mesh_worker:card_job", 2,
                            dict(inputs=str(d / "inputs.npz")),
                            path=Path(__file__).resolve().parent,
                            deadline=300)
    return inp, ranks


def _card_params(inp, prefix):
    from _mesh_cases import unflat

    return {k: (_card_params(v, "") if isinstance(v, dict)
                else torch.as_tensor(v).cuda())
            for k, v in (unflat(inp, prefix) if prefix else inp).items()}


@pytest.mark.parametrize("cap", ["full", "factor"])
@pytest.mark.parametrize("act", ["swiglu", "squared_relu"])
@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_mesh_moe_on_card_matches_one_process(mesh_on_card, mesh, act, cap):
    """Tolerance: 1e-5 + 1e-4|x| (the experts' partial sums add in another
    order). Experts split over 'model' (1 x 2, "gather"): with one data
    block the capacity is the whole batch's, so one process's output;
    "tp2d" on a model axis of one rank (2 x 1) is the reference's one-device
    path on the gathered batch."""
    from _mesh_cases import MOE_CFG
    from repro_torch.configs.base import MoEConfig

    inp, ranks = mesh_on_card
    p = _card_params(inp, f"moe/{act}/p/")
    x = torch.as_tensor(inp[f"moe/{act}/x"]).cuda()
    want, aux = moe_lib.apply_moe(p, x, MoEConfig(**MOE_CFG), act, None, cap)
    for r in ranks:
        key = f"moe/{mesh}/{act}/{cap}"
        torch.testing.assert_close(r[key], want.cpu(), atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(r[key + "/aux"], aux.cpu(), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("mesh,B", [("1x2", 4), ("2x1", 1)])
def test_mesh_decode_on_card_matches_one_process(mesh_on_card, mesh, B):
    """Tolerance: 1e-5 + 1e-5|x|. Reduced granite-moe in float32 on
    attn_impl "flash": the prefill and 3 teacher-forced decode steps over
    the sequence-split cache (each rank's flash_decode_partial on its
    block, the partials merged) against one process on the card; each
    rank launches flash_decode once a layer a step."""
    from _mesh_cases import LM_REDUCE

    inp, ranks = mesh_on_card
    cfg = reduced(get_config("granite-moe-1b-a400m"), **LM_REDUCE)
    params = _card_params(inp, "lm/granite-moe-1b-a400m/p/")
    tokens = torch.as_tensor(inp[f"card/{B}/tokens"]).long().cuda()
    forced = torch.as_tensor(inp[f"card/{B}/forced"]).long().cuda()
    ctx = ShardingContext(attn_impl="flash")
    logits, caches = make_prefill_step(cfg, ctx)(params, {"tokens": tokens})
    want = [logits]
    for i in range(forced.shape[1]):
        logits, caches = make_decode_step(cfg, ctx)(
            params, {"token": forced[:, i:i + 1],
                     "cache_pos": tokens.shape[1] + i}, caches)
        want.append(logits)
    names = ["prefill"] + [f"decode{i}" for i in range(forced.shape[1])]
    for r in ranks:
        for name, w in zip(names, want):
            torch.testing.assert_close(r[f"lm/{mesh}/{name}"], w.cpu(),
                                       atol=1e-5, rtol=1e-5)
        assert r[f"lm/{mesh}/flash_decode"] == cfg.n_layers * len(names[1:])


def test_mesh_ssm_on_card_matches_one_process(mesh_on_card):
    """Tolerance: 1e-5 + 1e-5|x|. Reduced mamba2 in float32 on ('data' 1,
    'model' 2): the prefill (each rank's ssd_scan on its 4 of 8 heads,
    w_out's parts summed over 'model') and 3 teacher-forced decode steps
    on each rank's block of the SSM state, against one process on the
    card; one ssd_scan launch a layer in the prefill, none in a decode
    step."""
    from _mesh_cases import LM_REDUCE

    inp, ranks = mesh_on_card
    cfg = reduced(get_config("mamba2-130m"), **LM_REDUCE)
    params = _card_params(inp, "lm/mamba2-130m/p/")
    tokens = torch.as_tensor(inp["card/4/tokens"]).long().cuda()
    forced = torch.as_tensor(inp["card/4/forced"]).long().cuda()
    logits, caches = make_prefill_step(cfg)(params, {"tokens": tokens})
    want = [logits]
    for i in range(forced.shape[1]):
        logits, caches = make_decode_step(cfg)(
            params, {"token": forced[:, i:i + 1],
                     "cache_pos": tokens.shape[1] + i}, caches)
        want.append(logits)
    names = ["prefill"] + [f"decode{i}" for i in range(forced.shape[1])]
    G, B, H, P, N = caches["layer0"].state.shape
    for r in ranks:
        for name, w in zip(names, want):
            torch.testing.assert_close(r[f"ssm/{name}"], w.cpu(), atol=1e-5,
                                       rtol=1e-5)
        assert r["ssm/prefill_ssd_scan"] == r["ssm/ssd_scan"] == cfg.n_layers
        assert r["ssm/state_block"] == (G, B, H // 2, P, N)


def test_mesh_compressed_psum_on_card(mesh_on_card):
    """Tolerance: none. compressed_psum over 2 ranks of the card equals
    its plain version (the int8 codes summed on one rank, times the
    scale); the ranks' CUDA tensors went through host buffers."""
    inp, ranks = mesh_on_card
    x = torch.as_tensor(inp["psum/x"])
    rows = x.shape[0] // 2
    smax = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / smax), -127, 127).to(torch.int8)
    plain = (q[:rows].float() + q[rows:].float()) * smax
    for r in ranks:
        assert torch.equal(r["psum"], plain.repeat(2, 1))
        assert r["staged_bytes"] > 0


# -- the tile table's launch choices ----------------------------------------

TILE_NS = [5, 131, 1000]


def _one_asymmetric(rng, P0):
    """P0 with one track (the middle one) whose P is symmetric only to
    rounding, among tracks symmetric to the bit."""
    P0 = P0.clone()
    c = P0.shape[0] // 2
    P0[c] = _asymmetric(rng, P0[c:c + 1])[0]
    return P0.contiguous()


def _every_tile(name, call, want):
    """call(lane_tile) at every instantiated tile of ``name`` (and at 0,
    the table's) bit for bit with ``want`` (the plain version) and with
    each other."""
    ref_out = None
    for tile in (0,) + ops.LANE_TILES[name]:
        got = call(tile)
        assert ops.LAST_CONFIG[name]["lane_tile"] == (
            tile or ops.LAST_CONFIG[name]["lane_tile"])
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (name, tile,
                                       float((a - b).abs().max()))
        ref_out = ref_out or got
        for a, b in zip(got, ref_out):
            assert torch.equal(a, b), (name, tile)


@pytest.mark.parametrize("kind", ["lkf", "ekf", "cv9"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("N", TILE_NS)
def test_scan_every_tile_is_bitwise(cuda, kind, sym, valid, N):
    """scan.cu at every instantiated tile (64, 128, 256 tracks a block)
    bit for bit with the plain version and with each other, at ragged N,
    with and without a valid stream (the K = 1 IMM replay), at both
    symmetrize values, with one track whose seed P is not symmetric to
    the bit among symmetric ones: the tile regroups which lanes run frame
    0 ahead (first_frame marks a block), never a lane's bits."""
    model = get_filter(kind)
    rng = np.random.default_rng(N + 3)
    x0, P0, zs, vs = _dev(replay_inputs(rng, model, N, 17,
                                        drop=0.1 if valid else 0.0), cuda)
    P0 = _one_asymmetric(rng, P0)
    if valid:
        one = as_imm(model)
        _, _, _, zz, vv = ops.imm_sequence_inputs(one, zs, x0, P0, None, vs)
        want = ref.katana_bank_scan_plain(model, x0, P0, zz, vv,
                                          symmetrize=sym)

        def call(tile):
            xs, (xf, Pf, _) = ops.katana_imm_sequence(
                one, zs, x0, P0, valid=vs, return_final=True,
                symmetrize=sym, lane_tile=tile)
            return xs, xf[0], Pf[0]
        name = "katana_imm_sequence"
    else:
        want = ref.katana_bank_scan_plain(model, x0, P0, zs, symmetrize=sym)

        def call(tile):
            xs, (xf, Pf) = ops.katana_bank_sequence(
                model, zs, x0, P0, return_final=True, symmetrize=sym,
                lane_tile=tile)
            return xs, xf, Pf
        name = "katana_bank_sequence"
    outs = []
    # the K = 1 replay runs scan.cu, at its tiles
    for tile in ops.LANE_TILES["katana_bank_sequence"]:
        got = call(tile)
        assert ops.LAST_CONFIG[name]["lane_tile"] == tile
        outs.append(got)
    outs.append(call(0))
    torch.cuda.synchronize()
    for got in outs:
        for a, b in zip(got, want):
            assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm"])
def test_every_chunk_and_tile_is_one_launch(cuda, kind):
    """Every (tile, chunk) the tuner races (tune.candidates) bit for bit
    with the whole stream in one launch at the static tile, T = 300."""
    from repro_torch.kernels.katana_bank import tune

    model = make_imm() if kind == "imm" else get_filter(kind)
    rng = np.random.default_rng(31)
    x0, P0, zs, _ = _dev(replay_inputs(rng, model, 1000, 300), cuda)
    if kind == "imm":
        name, seq = "katana_imm_sequence", ops.katana_imm_sequence
    else:
        name, seq = "katana_bank_sequence", ops.katana_bank_sequence
    static = tune.static_config(name)
    one = seq(model, zs, x0, P0, return_final=True,
              lane_tile=static["lane_tile"], time_chunk=300)
    for cfg in tune.candidates(name):
        ops.reset_launches()
        got = seq(model, zs, x0, P0, return_final=True, **cfg)
        assert ops.LAUNCHES[name] == -(-300 // cfg["time_chunk"])
        torch.cuda.synchronize()
        assert torch.equal(got[0], one[0]), cfg
        assert all(torch.equal(a, b) for a, b in zip(got[1], one[1])), cfg


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("N", TILE_NS)
def test_imm_scan_every_tile_is_bitwise(cuda, valid, N):
    """imm_scan.cu at 32 and 64 tracks a block (K = 4 threads each) bit
    for bit with the plain version, ragged N, with and without a valid
    stream."""
    imm = make_imm()
    rng = np.random.default_rng(N + 5)
    x0, P0, zs, vs = _dev(replay_inputs(rng, imm, N, 17,
                                        drop=0.1 if valid else 0.0), cuda)
    vs = vs if valid else None
    mu0 = torch.as_tensor(rng.dirichlet(np.ones(4), size=N),
                          dtype=torch.float32, device=cuda)
    want = ref.katana_bank_imm_scan_plain(
        imm, *ops.imm_sequence_inputs(imm, zs, x0, P0, mu0, vs))
    _every_tile("katana_imm_sequence", lambda tile: (
        lambda r: (r[0],) + r[1])(ops.katana_imm_sequence(
            imm, zs, x0, P0, mu0, vs, return_final=True, lane_tile=tile)),
        want)


@pytest.mark.parametrize("kind", ["lkf", "ekf", "imm", "other"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("N", TILE_NS)
def test_step_every_tile_is_bitwise(cuda, kind, sym, N):
    """imm_step.cu at 64, 128 and 256 lanes a block: ``katana_bank`` and
    ``katana_bank_soa`` (K = 1; cv6, ctra8) and ``katana_bank_imm``
    (K = 4; imm9, dense9) bit for bit with the plain version at both
    symmetrize values, on a P that is not symmetric to the bit, at ragged
    N (the 16-byte staging of a ragged last block included)."""
    rng = np.random.default_rng(N + 13)
    if kind in ("lkf", "ekf"):
        model = get_filter(kind)
        x0, P0, zs, _ = _dev(replay_inputs(rng, model, N, 1), cuda)
        P0 = _asymmetric(rng, P0)
        z = zs[0]
        want = ref.katana_bank_step_plain(model, x0, P0, z, sym)
        _every_tile("katana_bank", lambda tile: ops.katana_bank(
            model, x0, P0, z, symmetrize=sym, lane_tile=tile), want)
        xT, PT, zT = (x0.T.contiguous(), P0.permute(1, 2, 0).contiguous(),
                      z.T.contiguous())
        for tile in ops.LANE_TILES["katana_bank"]:
            soa = ops.katana_bank_soa(model, xT, PT, zT, symmetrize=sym,
                                      lane_tile=tile)
            assert ops.LAST_CONFIG["katana_bank_soa"]["lane_tile"] == tile
            torch.cuda.synchronize()
            assert torch.equal(soa[0].T, want[0]), tile
            assert torch.equal(soa[1].permute(2, 0, 1), want[1]), tile
        return
    imm = IMM_SETS[kind][0]()
    x0, _, zs, _ = replay_inputs(rng, imm, N, 1)
    K, n = imm.K, imm.n
    x = torch.as_tensor(np.tile(x0, (K, 1, 1)) + 0.05 * rng.normal(
        size=(K, N, n)), dtype=torch.float32, device=cuda)
    P = _asymmetric(rng, torch.as_tensor(spd(rng, (K, N), n), device=cuda))
    z = torch.as_tensor(zs[0], device=cuda)
    want = ref.katana_bank_imm_step_plain(imm, x, P, z, sym)
    _every_tile("katana_bank_imm", lambda tile: ops.katana_bank_imm(
        imm, x, P, z, symmetrize=sym, lane_tile=tile), want)


def test_a_tile_not_instantiated_is_refused(cuda):
    """The wrappers raise ValueError naming the instantiated set; the C
    entries return cudaErrorInvalidValue without launching."""
    from repro_torch.kernels import build

    model, imm = get_filter("lkf"), make_imm()
    x0, P0, zs, _ = _dev(replay_inputs(np.random.default_rng(1), model, 40,
                                       5), cuda)
    with pytest.raises(ValueError, match="64, 128, 256"):
        ops.katana_bank_sequence(model, zs, x0, P0, lane_tile=32)
    with pytest.raises(ValueError, match="32, 64"):
        ops.katana_imm_sequence(imm, zs.new_zeros(5, 40, 3),
                                x0.new_zeros(40, 9),
                                torch.eye(9, device=cuda).expand(
                                    40, 9, 9).contiguous(), lane_tile=128)
    with pytest.raises(ValueError, match="64, 128, 256"):
        ops.katana_bank(model, x0, P0, zs[0], lane_tile=96)
    xs = torch.empty((5, 40, 6), device=cuda)
    out = [torch.empty_like(t) for t in (x0, P0)]
    first = torch.empty((40,), dtype=torch.uint8, device=cuda)
    lib = build.load("scan.cu")
    code = lib.katana_bank_scan_run(
        6, 3, ops.pick_pattern((model,)).id, 40, 5, x0.data_ptr(),
        P0.data_ptr(), zs.data_ptr(), None, ops._host_consts(model).ctypes.data,
        0, float(model.dt), xs.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), first.data_ptr(), 1, 96, build.stream_of(cuda))
    assert code == 1  # cudaErrorInvalidValue
    step = build.load("imm_step.cu")
    for fn, args in (
            (step.katana_imm_step_run, (1, 6, 3, ops.pick_pattern(
                (model,)).id, 40, x0.data_ptr(), P0.data_ptr(),
                zs.data_ptr(), None, 0, 0.1, 0.0, out[0].data_ptr(),
                out[1].data_ptr(), None, 1, 32, build.stream_of(cuda))),
            (step.katana_bank_soa_run, (6, 3, ops.pick_pattern(
                (model,)).id, 40, x0.data_ptr(), P0.data_ptr(),
                zs.data_ptr(), None, 0, 0.1, out[0].data_ptr(),
                out[1].data_ptr(), 0, 512, build.stream_of(cuda)))):
        assert fn(*args) == 1
    torch.cuda.synchronize()
