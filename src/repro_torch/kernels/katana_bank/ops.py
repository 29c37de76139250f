"""Wrappers of the katana_bank kernels, canonical layouts in and out.

  ``katana_frame``          the single-model live frame: predict, gated
        Mahalanobis cost, greedy assignment, update (csrc/frame.cu: a
        thread per track for the predict and the update, a 2-D grid for
        the cost tile).
  ``katana_imm_frame``      the IMM live frame: + mixing, per-model
        log-likelihoods, mode posterior and combined estimate
        (csrc/imm_frame.cu: a thread per (model, track) for the predict
        and the update, a 2-D grid for the cost tile; K=1 runs frame.cu
        with mu passed through).
  ``katana_greedy_assign``  the frames' greedy assignment on its own
        (csrc/greedy.cu), the test surface against
        ``tracker.greedy_assign``.
  ``katana_bank_sequence``  offline replay of a pre-associated (T, N, m)
        stream, one launch per time chunk with x and P's triangle resident
        (csrc/scan.cu: katana_bank's lane code, z and xs staged through
        shared memory).
  ``katana_imm_sequence``   the IMM replay: mixing, K predict+updates,
        mode posterior and combined estimate inside the time loop, with
        an optional validity mask (csrc/imm_scan.cu; K=1 runs scan.cu).
  ``katana_bank`` / ``katana_bank_soa``  one predict+update per track,
        canonical or struct-of-arrays layout: csrc/imm_step.cu's step at
        K = 1 without the log-likelihood, on the model's own pattern (the
        canonical lanes staged through shared memory, the SoA ones read
        in place).
  ``katana_bank_imm``       one predict+update + loglik per (model,
        track) lane (csrc/imm_step.cu).
  ``imm_bank_sequence``     the per-frame IMM driver: ``rewrites.imm_mix``
        -> ``katana_bank_imm`` -> mode posterior -> combination, the
        independently built oracle of ``katana_imm_sequence``.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a
tensor on a CUDA device launches the kernel on the current stream or
raises — nothing falls back. ``LAUNCHES`` counts the kernel launches of
each wrapper (the frames also count their greedy launch under
``greedy_assign``; ``imm_bank_sequence`` launches through
``katana_bank_imm``). The kernels take the canonical layouts directly
(x (C, n), P (C, n, n), z (M, m); a stream zs (T, N, m)) and mask by
the track count, so nothing is padded or transposed here.

Every wrapper that predicts (the frames, the scans, the bank steps) takes
``symmetrize`` as the reference's ops do: True (their default) computes
the covariance's upper triangle, mirrors aliased; False (the default of
the rewrite stages, ``core/rewrites.py``) every entry, each kernel's
compile-time ``Sym = false`` route. A fleet frame (a leading sensor axis)
runs True only: the reference has no fleet frame of its own (its
``make_multi_sensor_step`` maps the default over the sensors).

The bank steps and the scans take ``lane_tile`` (tracks or lanes a block;
for the K > 1 IMM scan tracks a block, K threads each) and the scans
``time_chunk`` (frames a launch), as the reference's ops do: 0 looks the
launch up in the tile table (``autotune.py``, ``tuned.json``: the row of
this device and the nearest bank size), and without a row takes
``autotune.STATIC_DEFAULTS``. Neither changes a bit of the result. A tile
outside the kernel's instantiations (``LANE_TILES``) raises ValueError,
on the CPU too, where the plain versions ignore the tile and honour the
chunk. ``LAST_CONFIG[name]`` holds the configuration of each wrapper's
last call.

Every tracking kernel that predicts (the frames, the scans, the bank
steps) is instantiated for compile-time constant patterns
(csrc/pruned.cuh): which entries of F, Q and R every member model (or the
one model) shares as 0 (pruned) or 1.0 (elided).
``pick_pattern`` gives each launch the instantiation that prunes the
most among those the model set's shared constants cover; the dense one
covers every set.
"""
from __future__ import annotations

import ctypes
import re
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import rewrites
from repro_torch.core.filters import FilterModel, IMMModel, device_const
from repro_torch.core.filters import model_consts
from repro_torch.kernels import build
from repro_torch.kernels.katana_bank import autotune, ref

LAUNCHES: Dict[str, int] = {
    "katana_frame": 0, "katana_imm_frame": 0, "greedy_assign": 0,
    "katana_bank_sequence": 0, "katana_imm_sequence": 0, "katana_bank": 0,
    "katana_bank_soa": 0, "katana_bank_imm": 0}

# (n, m) of the single-model instantiations (frame, scan, steps), (K, n, m)
# of the IMM frame and scan
FRAME_SHAPES = ((6, 3), (8, 4), (9, 3))
IMM_FRAME_SHAPES = ((4, 9, 3),)
IMM_SCAN_SHAPES = ((4, 9, 3),)
# the tiles each wrapper's kernel is instantiated for (csrc: scan.cu's
# KATANA_SCAN_TILES, imm_step.cu's KATANA_STEP_TILES, imm_scan.cu's
# KATANA_IMM_SCAN_TILES); katana_imm_sequence at K = 1 runs scan.cu and
# takes its tiles. The static time chunk, 4096 frames, is a whole stream:
# the reference's IMM scan falls back to 64, a bound of the TPU's VMEM.
LANE_TILES: Dict[str, Tuple[int, ...]] = {
    "katana_bank": (64, 128, 256), "katana_bank_imm": (64, 128, 256),
    "imm_bank_sequence": (64, 128, 256),
    "katana_bank_sequence": (64, 128, 256), "katana_imm_sequence": (32, 64)}
# wrapper -> {lane_tile, time_chunk, key, N, table}: its last call's launch
# shape, the table key it looked up, the bank size and the table's kernel
LAST_CONFIG: Dict[str, dict] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_config(name: str, N: int, device, lane_tile: int = 0,
                  time_chunk: int = 0, table: str = None):
    """(tile, chunk) of a call of wrapper ``name`` at bank size ``N``: an
    explicit ``lane_tile`` / ``time_chunk`` wins, 0 takes the tile table's
    row of ``table`` (default ``name``) for ``device`` (autotune.py), then
    ``autotune.STATIC_DEFAULTS``; chunk None for the steps. Raises
    ValueError for a tile the kernel is not instantiated for (the set of
    ``table``); records the choice in ``LAST_CONFIG[name]``."""
    table = table or name
    key = autotune.device_key(device)
    static = autotune.STATIC_DEFAULTS[table]
    row = autotune.best_config(table, N, key)
    tile = lane_tile or int(row.get("lane_tile", 0)) or static["lane_tile"]
    if tile not in LANE_TILES[table]:
        raise ValueError(f"{name}: lane_tile {tile} is not instantiated; "
                         f"the kernel takes {LANE_TILES[table]}")
    chunk = None
    if "time_chunk" in static:
        chunk = (time_chunk or int(row.get("time_chunk", 0))
                 or static["time_chunk"])
    LAST_CONFIG[name] = dict(lane_tile=tile, time_chunk=chunk, key=key, N=N,
                             table=table)
    return tile, chunk


def frame_kernel_supported(model) -> bool:
    """True when the fused frame can serve this model: selector H, and
    for a K>1 IMM linear member models. The tracker takes the einsum
    route otherwise."""
    if ref.selector_rows(np.asarray(model.H)) is None:
        return False
    if isinstance(model, IMMModel):
        return model.K == 1 or all(mdl.is_linear for mdl in model.models)
    return True


def _expected_obs(n: int, m: int):
    return [0, 1, 2, 4] if (n, m) == (8, 4) else list(range(m))


def _check_model(model: FilterModel):
    """The single-model kernels are instantiated for the repo's models:
    raise for any shape or selector they were not built for."""
    n, m = model.n, model.m
    if (n, m) not in FRAME_SHAPES:
        raise NotImplementedError(
            f"no kernel for (n, m)={(n, m)}; built for {FRAME_SHAPES}")
    if ref.selector_rows(model.H) != _expected_obs(n, m):
        raise NotImplementedError(
            f"kernel (n, m)={(n, m)} observes state rows "
            f"{_expected_obs(n, m)}; H selects {ref.selector_rows(model.H)}")
    if not model.is_linear and (n, m) != (8, 4):
        raise NotImplementedError(
            "the nonlinear kernel path is the CTRA-8 model (n=8, m=4)")


def _host_consts(owner) -> np.ndarray:
    """The constants of ``owner`` (a FilterModel or an IMMModel) as one
    float32 array: per model F, Q, R (row major), then the Markov matrix
    (1 for a single model). Cached with the model
    (``filters.model_consts``)."""
    cache = model_consts(owner)
    t = cache.get("host consts")
    if t is None:
        if isinstance(owner, IMMModel):
            models, trans = owner.models, owner.trans
        else:
            models, trans = (owner,), np.ones((1, 1))
        parts = [np.asarray(getattr(mdl, nm), np.float64).ravel()
                 for mdl in models for nm in ("F", "Q", "R")]
        parts.append(np.asarray(trans, np.float64).ravel())
        t = np.ascontiguousarray(np.concatenate(parts), dtype=np.float32)
        cache["host consts"] = t
    return t


def _consts(owner, device) -> torch.Tensor:
    """``_host_consts`` on ``device``, made once per model and device."""
    return device_const(owner, "consts", lambda: _host_consts(owner),
                        torch.float32, device)


# ---------------------------------------------------------------------------
# Compile-time constant patterns of the IMM bank kernels (csrc/pruned.cuh).
# ---------------------------------------------------------------------------

_PRUNED_H = Path(__file__).resolve().parent / "csrc" / "pruned.cuh"
# the non-zero slots of the CTRA-8 Jacobian besides its unit diagonal
# (ref._predict_single; pruned.cuh: CtraJacobian)
CTRA8_JACOBIAN = ((0, 3), (0, 4), (1, 3), (1, 4), (2, 7), (3, 6), (4, 5))
MASKS = ("fz", "f1", "qz", "rz")


class ImmPattern(NamedTuple):
    """One instantiated pattern: its id in the kernels' dispatch, its
    name, (n, m), and boolean masks fz / f1 / qz (n, n) and rz (m, m):
    F's pruned zeros, F's elided 1.0s, Q's and R's pruned zeros."""
    id: int
    name: str
    n: int
    m: int
    masks: Dict[str, np.ndarray]


def _mask(word: int, rows: int, cols: int) -> np.ndarray:
    return np.array([(word >> b) & 1 for b in range(rows * cols)],
                    bool).reshape(rows, cols)


_PATTERNS: list = []


def instantiated_patterns():
    """The patterns the kernels are built for, in the order of
    KATANA_IMM_PATTERNS in csrc/pruned.cuh, read from that file."""
    if not _PATTERNS:
        text = _PRUNED_H.read_text()
        body = text[text.index("#define KATANA_IMM_PATTERNS"):]
        body = body[:body.index("\n\n")].replace("\\\n", " ")
        for args in re.findall(r"X\(([^)]*)\)", body):
            f = [a.strip() for a in args.split(",")]
            n, m = int(f[2]), int(f[3])
            w = [int(a.rstrip("ul"), 0) for a in f[4:]]
            masks = dict(fz=_mask(w[0] | w[1] << 64, n, n),
                         f1=_mask(w[2] | w[3] << 64, n, n),
                         qz=_mask(w[4] | w[5] << 64, n, n),
                         rz=_mask(w[6], m, m))
            _PATTERNS.append(ImmPattern(int(f[0]), f[1], n, m, masks))
    return list(_PATTERNS)


def imm_pattern(models) -> Dict[str, np.ndarray]:
    """The constants the plain version's op stream folds for this model
    set (``ref.plan_imm_tables``: an entry every member shares stays a
    float, pruned when 0 and elided when 1.0): masks fz / f1 / qz / rz as
    in ``ImmPattern``. A nonlinear member (the K = 1 CTRA-8) has the
    fixed pattern of the Jacobian the kernel builds."""
    entries, _ = ref.plan_imm_tables(models)

    def shared(name, value):
        return np.array([[isinstance(c, float) and c == value for c in row]
                         for row in entries[name]], bool)

    fz, f1 = shared("F", 0.0), shared("F", 1.0)
    if not models[0].is_linear:
        f1 = np.eye(models[0].n, dtype=bool)
        fz = ~f1
        for i, j in CTRA8_JACOBIAN:
            fz[i, j] = False
    return dict(fz=fz, f1=f1, qz=shared("Q", 0.0), rz=shared("R", 0.0))


_PICKED: Dict[Tuple[object, ...], ImmPattern] = {}


def pick_pattern(models) -> ImmPattern:
    """The instantiation a model set runs: of the patterns of its (n, m)
    whose pruned zeros and elided 1.0s the set's shared ones cover (so
    the kernel skips only terms the plain version skips too), the one
    that prunes the most. Cached per model set. Raises
    NotImplementedError for a shape without an instantiation."""
    key = tuple(models)
    if key not in _PICKED:
        _PICKED[key] = _pick(models)
    return _PICKED[key]


def _pick(models) -> ImmPattern:
    want = imm_pattern(models)
    n, m = models[0].n, models[0].m
    best = None
    for p in instantiated_patterns():
        if (p.n, p.m) != (n, m) or not all(
                np.all(p.masks[k] <= want[k]) for k in MASKS):
            continue
        if best is None or (sum(int(v.sum()) for v in p.masks.values())
                            > sum(int(v.sum()) for v in best.masks.values())):
            best = p
    if best is None:
        raise NotImplementedError(f"no IMM bank kernel for (n, m)={(n, m)}")
    return best


def _require(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _greedy_scratch(C: int, M: int, device, S: int = 1) -> torch.Tensor:
    """The greedy's candidate lists of S sensors (csrc/greedy.cuh): S*C*M
    8-byte keys, S*C*M 4-byte tracks and S counts."""
    return torch.empty(((12 * C * M + 4) * S,), dtype=torch.uint8,
                       device=device)


def _event_handles(events):
    """The handles of ``torch.cuda.Event``s for the kernel to record."""
    for ev in events:
        if not ev.cuda_event:
            ev.record()  # the event is created at its first record
    return tuple(ev.cuda_event for ev in events)


def _fleet_shape(x, track_dims: int, axis: int = 0):
    """(S, lead): a sensor-stacked x (one more axis than ``track_dims``,
    the sensor axis at ``axis``) serves S sensors; an unstacked one S = 1.
    ``lead`` is the sensor axis to put in front of per-track shapes."""
    if x.dim() == track_dims + 1:
        S = x.shape[axis]
        if S == 0:
            raise ValueError("a sensor-stacked frame needs S >= 1 sensors")
        return S, (S,)
    if x.dim() == track_dims:
        return 1, ()
    raise ValueError(f"x has {x.dim()} dims, expected {track_dims} or "
                     f"{track_dims + 1} (sensor-stacked)")


def _check_fleet_symmetrize(S: int, lead, symmetrize: bool, what: str):
    """A fleet frame runs the upper-triangle contract only."""
    if lead and not symmetrize:
        raise NotImplementedError(
            f"{what}: symmetrize=False on a fleet of {S} sensors is not in "
            "the reference (its multi-sensor step maps the default); "
            "ROADMAP §2 item S")


def _launch_frame(model: FilterModel, x, P, z, z_valid, active, gate: float,
                  rounds: int, greedy_events=None, launch_events=None,
                  symmetrize: bool = True):
    """The launches of the single-model frame (csrc/frame.cu), on the
    model's compile-time pattern, for one sensor (x (C, n)) or a fleet of
    S (x (S, C, n), every other input with a leading S)."""
    _check_model(model)
    dev = x.device
    S, lead = _fleet_shape(x, 2)
    C, n = x.shape[-2:]
    M, m = z.shape[-2:]
    f32 = torch.float32
    _require(x, "x", f32, lead + (C, n), dev)
    _require(P, "P", f32, lead + (C, n, n), dev)
    _require(z, "z", f32, lead + (M, m), dev)
    _require(z_valid, "z_valid", torch.bool, lead + (M,), dev)
    _require(active, "active", torch.bool, lead + (C,), dev)
    consts = _host_consts(model)
    x_out, P_out = torch.empty_like(x), torch.empty_like(P)
    assoc = torch.empty(lead + (C,), dtype=torch.int32, device=dev)
    waves = torch.empty((S,), dtype=torch.int32, device=dev)
    # the (S, M, C) cost tile
    cost = torch.empty((S * M * C,), dtype=f32, device=dev)
    # S^-1 and z_pred of every track, from the predict to the cost tile
    # and the update
    inno = torch.empty((m * m + m, S * C), dtype=f32, device=dev)
    scratch = _greedy_scratch(C, M, dev, S)
    events = _frame_events(greedy_events, launch_events)
    lib = build.load("frame.cu")
    code = lib.katana_frame_run(
        n, m, pick_pattern((model,)).id, C, M, x.data_ptr(), P.data_ptr(),
        z.data_ptr(), z_valid.data_ptr(), active.data_ptr(),
        consts.ctypes.data, int(not model.is_linear), float(model.dt),
        float(gate), int(rounds), S, x_out.data_ptr(), P_out.data_ptr(),
        assoc.data_ptr(), cost.data_ptr(), inno.data_ptr(),
        scratch.data_ptr(), waves.data_ptr(), int(symmetrize),
        build.stream_of(dev), events)
    build.check(lib, code, "katana_frame")
    LAUNCHES["greedy_assign"] += 1
    return x_out, P_out, assoc, waves


def _frame_events(greedy_events, launch_events):
    """The five event handles a frame records (before its predict, after
    it, after the cost tile, after the greedy, after the update) as a C
    array: ``launch_events`` fills all five, ``greedy_events`` the
    greedy's pair."""
    events = ([None] * 5 if launch_events is None
              else list(_event_handles(launch_events)))
    if greedy_events is not None:
        events[2:4] = _event_handles(greedy_events)
    return (ctypes.c_void_p * 5)(*events)


def katana_frame(model: FilterModel, x, P, z, z_valid, active, gate: float,
                 rounds: int, return_waves: bool = False, greedy_events=None,
                 launch_events=None, symmetrize: bool = True):
    """The fused live tracking frame. x (C, n); P (C, n, n); z (M, m);
    z_valid (M,) bool; active (C,) bool; ``gate``/``rounds`` are the
    tracker's chi-square gate and assignment-round bound. Returns
    (x' (C, n), P' (C, n, n), assoc (C,) int32): the updated state where
    a slot got a measurement, the predicted state elsewhere. With
    ``return_waves`` also the number of greedy waves run (a device
    int32 tensor (1,) on CUDA, an int on the CPU). A fleet of S sensors
    takes every input with a leading S (x (S, C, n), P (S, C, n, n),
    z (S, M, m), z_valid (S, M), active (S, C)) and returns x', P' and
    assoc (S, C) so stacked, and waves (S,) (a list of ints on the CPU):
    one call, the same launches, each sensor bit for bit its own
    single-sensor call. ``greedy_events``: a
    (start, end) pair of ``torch.cuda.Event(enable_timing=True)`` that
    the kernel records just before and after the greedy's launches, for
    its device time inside the frame; ``launch_events``: five such
    events that it records before its predict, after it, after the cost
    tile, after the greedy and after the update, for each launch's
    device time (CUDA tensors only). ``symmetrize=False`` predicts and
    updates the covariance's full square (one sensor only: a fleet
    raises NotImplementedError)."""
    _check_fleet_symmetrize(*_fleet_shape(x, 2), symmetrize, "katana_frame")
    if not build.on_cuda(x):
        return ref.katana_frame_plain(model, x, P, z, z_valid, active, gate,
                                      rounds, return_waves=return_waves,
                                      symmetrize=symmetrize)
    x2, P2, assoc, waves = _launch_frame(model, x, P, z, z_valid, active,
                                         gate, rounds, greedy_events,
                                         launch_events, symmetrize)
    LAUNCHES["katana_frame"] += 1
    return (x2, P2, assoc, waves) if return_waves else (x2, P2, assoc)


def katana_imm_frame(imm: IMMModel, x, P, mu, z, z_valid, active,
                     gate: float, rounds: int, return_waves: bool = False,
                     greedy_events=None, launch_events=None,
                     symmetrize: bool = True):
    """The fused live IMM frame. x (K, C, n); P (K, C, n, n); mu (C, K);
    z (M, m); z_valid (M,) bool; active (C,) bool. Returns
    (x' (K, C, n), P' (K, C, n, n), mu' (C, K), x_c (C, n), assoc (C,)):
    coasting slots keep x̂/P̂ and take mu <- cbar. K=1 is the
    single-model frame with mu passed through. ``greedy_events`` and
    ``launch_events`` as in ``katana_frame``. A fleet of S sensors takes
    x (K, S, C, n), P (K, S, C, n, n), mu (S, C, K) and z, z_valid,
    active with a leading S, and returns every output so stacked (x_c
    (S, C, n), assoc (S, C), waves (S,)), as ``katana_frame`` does.
    ``symmetrize=False`` mixes, predicts, updates and coasts the
    covariance's full square (one sensor only, as ``katana_frame``)."""
    S, lead = _fleet_shape(x, 3, axis=1)
    _check_fleet_symmetrize(S, lead, symmetrize, "katana_imm_frame")
    if not build.on_cuda(x):
        return ref.katana_imm_frame_plain(imm, x, P, mu, z, z_valid, active,
                                          gate, rounds,
                                          return_waves=return_waves,
                                          symmetrize=symmetrize)
    K, n = x.shape[0], x.shape[-1]
    C = x.shape[-2]
    M, m = z.shape[-2:]
    dev = x.device
    _require(mu, "mu", torch.float32, lead + (C, K), dev)
    if K == 1:
        x2, P2, assoc, waves = _launch_frame(imm.models[0], x[0], P[0], z,
                                             z_valid, active, gate, rounds,
                                             greedy_events, launch_events,
                                             symmetrize)
        LAUNCHES["katana_imm_frame"] += 1
        out = (x2[None], P2[None], mu.clone(), x2.clone(), assoc)
        return out + (waves,) if return_waves else out
    if (K, n, m) not in IMM_FRAME_SHAPES:
        raise NotImplementedError(
            f"no IMM frame kernel for (K, n, m)={(K, n, m)}; built for "
            f"{IMM_FRAME_SHAPES}")
    for mdl in imm.models:
        if not mdl.is_linear:
            raise NotImplementedError(
                "multi-model katana_imm_frame requires linear member models")
        _check_model(mdl)
    f32 = torch.float32
    _require(x, "x", f32, (K,) + lead + (C, n), dev)
    _require(P, "P", f32, (K,) + lead + (C, n, n), dev)
    _require(z, "z", f32, lead + (M, m), dev)
    _require(z_valid, "z_valid", torch.bool, lead + (M,), dev)
    _require(active, "active", torch.bool, lead + (C,), dev)
    x_out, P_out = torch.empty_like(x), torch.empty_like(P)
    mu_out = torch.empty_like(mu)
    xc = torch.empty(lead + (C, n), dtype=f32, device=dev)
    assoc = torch.empty(lead + (C,), dtype=torch.int32, device=dev)
    waves = torch.empty((S,), dtype=torch.int32, device=dev)
    consts = _consts(imm, dev)
    # the (S, M, C) cost tile
    cost = torch.empty((S * M * C,), dtype=f32, device=dev)
    # S^-1, z_pred and cbar of every (model, track), from the predict to
    # the cost tile and the update
    inno = torch.empty((m * m + m + 1, K, S * C), dtype=f32, device=dev)
    scratch = _greedy_scratch(C, M, dev, S)
    lib = build.load("imm_frame.cu")
    code = lib.katana_imm_frame_run(
        K, n, m, pick_pattern(imm.models).id, C, M, x.data_ptr(),
        P.data_ptr(), mu.data_ptr(), z.data_ptr(), z_valid.data_ptr(),
        active.data_ptr(), consts.data_ptr(), float(gate), int(rounds), S,
        float(np.float32(m * ref.LOG_2PI)), x_out.data_ptr(),
        P_out.data_ptr(), mu_out.data_ptr(), xc.data_ptr(), assoc.data_ptr(),
        cost.data_ptr(), inno.data_ptr(), scratch.data_ptr(),
        waves.data_ptr(), int(symmetrize), build.stream_of(dev),
        _frame_events(greedy_events, launch_events))
    build.check(lib, code, "katana_imm_frame")
    LAUNCHES["katana_imm_frame"] += 1
    LAUNCHES["greedy_assign"] += 1
    out = (x_out, P_out, mu_out, xc, assoc)
    return out + (waves,) if return_waves else out


def katana_greedy_assign(cost, valid, gate: float, rounds: int,
                         return_waves: bool = False):
    """The frames' greedy assignment standalone, canonical layout:
    cost (C, M) float32; valid (C, M) bool. Returns assoc (C,) int32."""
    if not build.on_cuda(cost):
        return ref.greedy_assign_plain(cost, valid, gate, rounds,
                                       return_waves=return_waves)
    C, M = cost.shape
    dev = cost.device
    _require(cost, "cost", torch.float32, (C, M), dev)
    _require(valid, "valid", torch.bool, (C, M), dev)
    assoc = torch.empty((C,), dtype=torch.int32, device=dev)
    waves = torch.empty((1,), dtype=torch.int32, device=dev)
    scratch = _greedy_scratch(C, M, dev)
    lib = build.load("greedy.cu")
    code = lib.greedy_assign_run(C, M, cost.data_ptr(), valid.data_ptr(),
                                 float(gate), int(rounds), scratch.data_ptr(),
                                 assoc.data_ptr(), waves.data_ptr(),
                                 build.stream_of(dev), None, None)
    build.check(lib, code, "greedy_assign")
    LAUNCHES["greedy_assign"] += 1
    return (assoc, waves) if return_waves else assoc


# ---------------------------------------------------------------------------
# Per-frame bank steps and replay scans.
# ---------------------------------------------------------------------------

def _chunks(T: int, time_chunk: int):
    return [(t0, min(T, t0 + time_chunk)) for t0 in range(0, T, time_chunk)]


def _check_imm_scan_members(imm: IMMModel):
    """K>1 kernels take linear members of one instantiated shape."""
    for mdl in imm.models:
        if not mdl.is_linear:
            raise NotImplementedError(
                "the multi-model IMM kernels require linear member models")
        _check_model(mdl)


def _check_imm_scan(imm: IMMModel):
    K, n, m = imm.K, imm.n, imm.m
    if (K, n, m) not in IMM_SCAN_SHAPES:
        raise NotImplementedError(
            f"no IMM scan kernel for (K, n, m)={(K, n, m)}; built for "
            f"{IMM_SCAN_SHAPES}")
    _check_imm_scan_members(imm)


def _launch_scan(model: FilterModel, x, P, zs, valid, xs,
                 symmetrize: bool, tile: int):
    """One chunk of the single-model scan (csrc/scan.cu), on the model's
    compile-time pattern, ``tile`` tracks a block: xs (T, N, n) is
    written in place; returns (x_T, P_T)."""
    _check_model(model)
    dev = x.device
    N, n = x.shape
    T, _, m = zs.shape
    f32 = torch.float32
    _require(x, "x", f32, (N, n), dev)
    _require(P, "P", f32, (N, n, n), dev)
    _require(zs, "zs", f32, (T, N, m), dev)
    _require(xs, "xs", f32, (T, N, n), dev)
    if valid is not None:
        _require(valid, "valid", torch.bool, (T, N), dev)
    x_fin, P_fin = torch.empty_like(x), torch.empty_like(P)
    if N == 0:
        return x_fin, P_fin
    consts = _host_consts(model)
    # the blocks whose first frame runs ahead of the scan (a seed P that
    # is not symmetric to the bit): a byte a block, N bytes at any tile
    first = torch.empty((N,), dtype=torch.uint8, device=dev)
    lib = build.load("scan.cu")
    code = lib.katana_bank_scan_run(
        n, m, pick_pattern((model,)).id, N, T, x.data_ptr(), P.data_ptr(),
        zs.data_ptr(), None if valid is None else valid.data_ptr(),
        consts.ctypes.data, int(not model.is_linear), float(model.dt),
        xs.data_ptr(), x_fin.data_ptr(), P_fin.data_ptr(), first.data_ptr(),
        int(symmetrize), tile, build.stream_of(dev))
    build.check(lib, code, "katana_bank_sequence")
    return x_fin, P_fin


def _launch_imm_scan(imm: IMMModel, x, P, mu, zs, valid, xs,
                     symmetrize: bool, tile: int):
    """One chunk of the K>1 IMM scan (csrc/imm_scan.cu), ``tile`` tracks a
    block: xs (T, N, n) is written in place; returns (x_T, P_T, mu_T)."""
    _check_imm_scan(imm)
    dev = x.device
    K, N, n = x.shape
    T, _, m = zs.shape
    f32 = torch.float32
    _require(x, "x", f32, (K, N, n), dev)
    _require(P, "P", f32, (K, N, n, n), dev)
    _require(mu, "mu", f32, (N, K), dev)
    _require(zs, "zs", f32, (T, N, m), dev)
    _require(xs, "xs", f32, (T, N, n), dev)
    if valid is not None:
        _require(valid, "valid", torch.bool, (T, N), dev)
    x_fin, P_fin, mu_fin = (torch.empty_like(x), torch.empty_like(P),
                            torch.empty_like(mu))
    if N == 0:
        return x_fin, P_fin, mu_fin
    consts = _host_consts(imm)
    lib = build.load("imm_scan.cu")
    code = lib.katana_imm_scan_run(
        K, n, m, pick_pattern(imm.models).id, N, T, x.data_ptr(),
        P.data_ptr(), mu.data_ptr(), zs.data_ptr(),
        None if valid is None else valid.data_ptr(),
        consts.ctypes.data, float(np.float32(m * ref.LOG_2PI)),
        xs.data_ptr(), x_fin.data_ptr(), P_fin.data_ptr(), mu_fin.data_ptr(),
        int(symmetrize), tile, build.stream_of(dev))
    build.check(lib, code, "katana_imm_sequence")
    return x_fin, P_fin, mu_fin


def katana_bank_sequence(model: FilterModel, zs, x0, P0,
                         return_final: bool = False, time_chunk: int = 0,
                         symmetrize: bool = True, lane_tile: int = 0):
    """Filter a pre-associated measurement stream: zs (T, N, m), the bank
    seeded by x0 (N, n), P0 (N, n, n). Returns xs (T, N, n), the filtered
    state after every frame; with ``return_final`` also (x_T (N, n),
    P_T (N, n, n)) to carry the bank into the next stream. The stream
    runs as ceil(T / time_chunk) launches of ``lane_tile`` tracks a block
    with (x, P) carried between them, which gives the same bits as one
    launch; 0 looks either up in the tile table."""
    T, N, m = zs.shape
    tile, chunk = launch_config("katana_bank_sequence", N, zs.device,
                                lane_tile, time_chunk)
    chunks = _chunks(T, chunk)
    x, P = x0, P0
    if build.on_cuda(zs):
        out = torch.empty((T, N, model.n), dtype=zs.dtype, device=zs.device)
        for t0, t1 in chunks:
            x, P = _launch_scan(model, x, P, zs[t0:t1], None, out[t0:t1],
                                symmetrize, tile)
            LAUNCHES["katana_bank_sequence"] += 1
    else:
        parts = []
        for t0, t1 in chunks:
            xs, x, P = ref.katana_bank_scan_plain(model, x, P, zs[t0:t1],
                                                  symmetrize=symmetrize)
            parts.append(xs)
        out = (torch.cat(parts) if parts
               else zs.new_empty((0, N, model.n)))
    return (out, (x, P)) if return_final else out


def imm_sequence_inputs(imm: IMMModel, zs, x0, P0, mu0=None, valid=None):
    """The IMM replay's seeds and stream in the scan's layouts: x0/P0 of
    (N, n)/(N, n, n) seed every mode alike, (K, N, n)/(K, N, n, n) resume
    a mode-conditioned bank; mu0 (N, K) defaults to ``imm.mu0``; where
    ``valid`` (T, N) is False the measurement is zeroed, so a NaN "no
    detection" cannot reach the carry through 0·NaN. Returns contiguous
    (x (K, N, n), P (K, N, n, n), mu (N, K), zs, valid bool or None)."""
    K, n = imm.K, imm.n
    T, N, m = zs.shape
    if x0.dim() == 2:
        x0 = x0[None].expand(K, N, n)
    if P0.dim() == 3:
        P0 = P0[None].expand(K, N, n, n)
    mu = (torch.as_tensor(np.asarray(imm.mu0), dtype=zs.dtype,
                          device=zs.device).expand(N, K)
          if mu0 is None else mu0)
    if valid is not None:
        valid = valid.to(device=zs.device, dtype=torch.bool).contiguous()
        zs = torch.where(valid[:, :, None], zs, torch.zeros((), dtype=zs.dtype,
                                                            device=zs.device))
    return (x0.contiguous(), P0.contiguous(), mu.contiguous(),
            zs.contiguous(), valid)


def katana_imm_sequence(imm: IMMModel, zs, x0, P0, mu0=None, valid=None,
                        return_final: bool = False, time_chunk: int = 0,
                        symmetrize: bool = True, lane_tile: int = 0):
    """IMM-filter a pre-associated stream zs (T, N, m). x0/P0 seed the
    bank, (N, n)/(N, n, n) for fresh tracks or (K, N, n)/(K, N, n, n) to
    resume a mode-conditioned bank; mu0 (N, K) defaults to ``imm.mu0``;
    ``valid`` (T, N) bool: a False frame coasts the track (time update
    only, mu <- the Markov-predicted cbar). Returns xs (T, N, n), the
    combined estimates; with ``return_final`` also (x (K, N, n),
    P (K, N, n, n), mu (N, K)). One launch per ``time_chunk`` frames,
    (x, P, mu) carried between them with the same bits as one launch;
    ``lane_tile`` tracks a block; 0 looks either up in the tile table.
    K=1 is the single-model scan with mu passed through (its tiles and
    table rows ``katana_bank_sequence``'s)."""
    K = imm.K
    x, P, mu, zs, valid = imm_sequence_inputs(imm, zs, x0, P0, mu0, valid)
    T, N, _ = zs.shape
    tile, chunk = launch_config(
        "katana_imm_sequence", N, zs.device, lane_tile, time_chunk,
        table="katana_bank_sequence" if K == 1 else None)
    chunks = _chunks(T, chunk)
    if build.on_cuda(zs):
        out = torch.empty((T, N, imm.n), dtype=zs.dtype, device=zs.device)
        for t0, t1 in chunks:
            vt = None if valid is None else valid[t0:t1]
            if K == 1:
                x1, P1 = _launch_scan(imm.models[0], x[0], P[0], zs[t0:t1],
                                      vt, out[t0:t1], symmetrize, tile)
                x, P = x1[None], P1[None]
            else:
                x, P, mu = _launch_imm_scan(imm, x, P, mu, zs[t0:t1], vt,
                                            out[t0:t1], symmetrize, tile)
            LAUNCHES["katana_imm_sequence"] += 1
        if K == 1:
            mu = mu.clone()
    else:
        parts = []
        for t0, t1 in chunks:
            vt = None if valid is None else valid[t0:t1]
            xs, x, P, mu = ref.katana_bank_imm_scan_plain(
                imm, x, P, mu, zs[t0:t1], vt, symmetrize)
            parts.append(xs)
        out = (torch.cat(parts) if parts
               else zs.new_empty((0, N, imm.n)))
    return (out, (x, P, mu)) if return_final else out


def _launch_step(model: FilterModel, x, P, z, soa: bool, symmetrize: bool,
                 tile: int):
    _check_model(model)
    dev = x.device
    n, m = model.n, model.m
    N = x.shape[-1] if soa else x.shape[0]
    f32 = torch.float32
    shapes = (((n, N), (n, n, N), (m, N)) if soa
              else ((N, n), (N, n, n), (N, m)))
    for t, name, shape in zip((x, P, z), ("x", "P", "z"), shapes):
        _require(t, name, f32, shape, dev)
    x_out, P_out = torch.empty_like(x), torch.empty_like(P)
    if N == 0:
        return x_out, P_out
    consts = _consts(model, dev)
    pattern = pick_pattern((model,)).id
    lib = build.load("imm_step.cu")
    common = (x.data_ptr(), P.data_ptr(), z.data_ptr(), consts.data_ptr(),
              int(not model.is_linear), float(model.dt))
    if soa:
        code = lib.katana_bank_soa_run(n, m, pattern, N, *common,
                                       x_out.data_ptr(), P_out.data_ptr(),
                                       int(symmetrize), tile,
                                       build.stream_of(dev))
    else:
        code = lib.katana_imm_step_run(1, n, m, pattern, N, *common, 0.0,
                                       x_out.data_ptr(), P_out.data_ptr(),
                                       None, int(symmetrize), tile,
                                       build.stream_of(dev))
    build.check(lib, code, "katana_bank_soa" if soa else "katana_bank")
    return x_out, P_out


def katana_bank(model: FilterModel, x, P, z, symmetrize: bool = True,
                lane_tile: int = 0):
    """One predict+update per track: x (N, n), P (N, n, n), z (N, m)
    -> (x', P'), ``lane_tile`` tracks a block (0: the tile table's)."""
    tile, _ = launch_config("katana_bank", x.shape[0], x.device, lane_tile)
    if not build.on_cuda(x):
        return ref.katana_bank_step_plain(model, x, P, z, symmetrize)
    out = _launch_step(model, x, P, z, False, symmetrize, tile)
    LAUNCHES["katana_bank"] += 1
    return out


def katana_bank_soa(model: FilterModel, x, P, z, symmetrize: bool = True,
                    lane_tile: int = 0):
    """``katana_bank`` for callers that keep the struct-of-arrays layout:
    x (n, N), P (n, n, N), z (m, N) -> (x', P') in the same layout. The
    kernel reads this layout directly. ``lane_tile=0`` takes
    ``katana_bank``'s static tile: the tuner races the canonical layout
    only, and the reference's SoA entry consults no table either."""
    tile, _ = launch_config(
        "katana_bank_soa", x.shape[-1], x.device,
        lane_tile or autotune.STATIC_DEFAULTS["katana_bank"]["lane_tile"],
        table="katana_bank")
    if not build.on_cuda(x):
        x2, P2 = ref.katana_bank_step_plain(model, x.T, P.permute(2, 0, 1),
                                            z.T, symmetrize)
        return x2.T.contiguous(), P2.permute(1, 2, 0).contiguous()
    out = _launch_step(model, x, P, z, True, symmetrize, tile)
    LAUNCHES["katana_bank_soa"] += 1
    return out


def katana_bank_imm(imm: IMMModel, x, P, z, symmetrize: bool = True,
                    lane_tile: int = 0):
    """One IMM bank step: every (model, track) lane takes a predict+update
    of its model with the track's measurement. x (K, N, n) (typically the
    mixed states), P (K, N, n, n), z (N, m). Returns (x' (K, N, n),
    P' (K, N, n, n), loglik (K, N)). K>1 needs linear member models.
    ``lane_tile`` lanes a block; 0 looks it up at the K * N lanes."""
    tile, _ = launch_config("katana_bank_imm", x.shape[0] * x.shape[1],
                            x.device, lane_tile)
    if not build.on_cuda(x):
        return ref.katana_bank_imm_step_plain(imm, x, P, z, symmetrize)
    K, N, n = x.shape
    m = imm.m
    if K > 1:
        _check_imm_scan_members(imm)
    else:
        _check_model(imm.models[0])
    dev = x.device
    f32 = torch.float32
    _require(x, "x", f32, (K, N, n), dev)
    _require(P, "P", f32, (K, N, n, n), dev)
    _require(z, "z", f32, (N, m), dev)
    x_out, P_out = torch.empty_like(x), torch.empty_like(P)
    ll = torch.empty((K, N), dtype=f32, device=dev)
    if N == 0:
        return x_out, P_out, ll
    consts = _consts(imm, dev)
    mdl0 = imm.models[0]
    lib = build.load("imm_step.cu")
    code = lib.katana_imm_step_run(
        K, n, m, pick_pattern(imm.models).id, N, x.data_ptr(),
        P.data_ptr(), z.data_ptr(), consts.data_ptr(),
        int(not mdl0.is_linear), float(mdl0.dt),
        float(np.float32(m * ref.LOG_2PI)), x_out.data_ptr(),
        P_out.data_ptr(), ll.data_ptr(), int(symmetrize), tile,
        build.stream_of(dev))
    build.check(lib, code, "katana_bank_imm")
    LAUNCHES["katana_bank_imm"] += 1
    return x_out, P_out, ll


def imm_bank_sequence(imm: IMMModel, zs, x0, P0, mu0=None,
                      return_final: bool = False, symmetrize: bool = True,
                      lane_tile: int = 0):
    """IMM-filter a stream zs (T, N, m) frame by frame: ``rewrites.imm_mix``
    -> ``katana_bank_imm`` -> mode posterior -> combined estimate, x/P
    through device memory every frame. Seeds as ``katana_imm_sequence``.
    Returns xs (T, N, n); with ``return_final`` also (x, P, mu). Built
    independently of the fused scan, it is that scan's oracle.
    ``lane_tile`` goes to every ``katana_bank_imm``; 0 looks it up at the
    K * N lanes, as the reference's does."""
    tile, _ = launch_config("imm_bank_sequence", imm.K * zs.shape[1],
                            zs.device, lane_tile)
    x, P, mu, zs, _ = imm_sequence_inputs(imm, zs, x0, P0, mu0)
    Pi = torch.as_tensor(np.asarray(imm.trans), dtype=zs.dtype,
                         device=zs.device)
    out = []
    for t in range(zs.shape[0]):
        x_mix, P_mix, cbar = rewrites.imm_mix(x, P, mu, Pi)
        x, P, ll = katana_bank_imm(imm, x_mix.contiguous(),
                                   P_mix.contiguous(), zs[t], symmetrize,
                                   tile)
        mu = rewrites.imm_mode_posterior(cbar, ll)
        out.append(rewrites.imm_combine(x, P, mu)[0])
    xs = (torch.stack(out) if out
          else zs.new_empty((0, zs.shape[1], imm.n)))
    return (xs, (x, P, mu)) if return_final else xs
