"""MOT association + track lifecycle on top of the filter bank.

One frame step with static shapes: predict every slot (yielding the
innovation quantities S, S^{-1}, P·Hᵀ once), gate with the squared
Mahalanobis distance against that S^{-1}, greedy globally-ordered
assignment, update the associated slots, spawn tentative tracks for the
unassigned measurements, prune coasted tracks.

Under ``TrackerConfig.fused_frame`` (the default) the measurement cycle
is one call of the ``katana_frame`` / ``katana_imm_frame`` kernels;
plain torch keeps the lifecycle counters, spawn and prune. The einsum
route (``fused_frame=False``) is the port's own equivalence oracle and
the route for models the kernels do not serve.

``make_jitted_tracker`` / ``make_jitted_imm_tracker`` are the
reference's jitted trackers. On a card their step is the frame captured
once in a ``torch.cuda.CUDAGraph`` and replayed (``JittedStep``); on the
CPU it is the frame step itself.

``make_multi_sensor_step`` serves S independent sensors over banks
stacked on a sensor axis (``bank.bank_sensor_axes``). On the fused route
the fleet frame is the single-sensor frame step itself: one kernel call
for all S sensors and the same torch glue over a leading sensor axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import bank as bank_lib
from repro_torch.core.bank import BankState, IMMBankState
from repro_torch.core.filters import FilterModel, IMMModel
from repro_torch.core.rewrites import imm_combine
from repro_torch.kernels.katana_bank.ops import (LAUNCHES,
                                                 frame_kernel_supported,
                                                 katana_frame,
                                                 katana_imm_frame)
from repro_torch.kernels.katana_bank.ref import F32_MAX, first_argmin

# 99% chi-square quantiles by dof
CHI2_99 = {1: 6.63, 2: 9.21, 3: 11.34, 4: 13.28, 5: 15.09, 6: 16.81}


@dataclass(frozen=True)
class TrackerConfig:
    capacity: int = 256
    max_meas: int = 64
    gate: float = 0.0         # 0 => chi2_99[m]
    max_misses: int = 5
    min_hits: int = 3         # confirmations before a track is "real"
    dtype: str = "float32"
    # route the measurement cycle through the fused frame kernels; the
    # einsum route stays the oracle and serves models outside
    # ``frame_kernel_supported``
    fused_frame: bool = True
    # multiplies the chi-square gate (1.0 = nominal)
    gate_scale: float = 1.0
    # a z row with NaN/inf is treated as "no detection": its valid bit is
    # cleared and the row zeroed before either route sees it
    nan_guard: bool = True


class FrameResult(NamedTuple):
    """One frame's result; a fleet's leaves lead with the sensor axis S
    (the bank's as ``bank.bank_sensor_axes`` places it)."""
    bank: BankState           # BankState or IMMBankState
    assoc: torch.Tensor       # (C,) measurement index per slot or -1
    unassigned: torch.Tensor  # (M,) bool — measurements that spawned
    confirmed: torch.Tensor   # (C,) bool — active & hits >= min_hits
    mode_probs: Optional[torch.Tensor] = None  # (C, K) IMM mode probs
    x_est: Optional[torch.Tensor] = None       # (C, n) IMM combined means


def mahalanobis_cost(z_pred: torch.Tensor, Sinv: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """(C, m), (C, m, m) precomputed S^{-1}, (M, m) -> (C, M) squared
    Mahalanobis."""
    y = z[None, :, :] - z_pred[:, None, :]        # (C, M, m)
    return torch.einsum("cMm,cmn,cMn->cM", y, Sinv, y)


def greedy_assign(cost: torch.Tensor, valid: torch.Tensor, gate,
                  rounds: int) -> torch.Tensor:
    """Globally-ordered greedy assignment: each of ``rounds`` rounds
    commits the global minimum of the masked (C, M) cost (first
    occurrence, slot-major) and masks its row and column. Returns assoc
    (C,) int32, measurement index or -1."""
    C, M = cost.shape
    dev = cost.device
    # fills, not copies from the host: a CUDA graph can capture them
    big = torch.full((), F32_MAX, dtype=cost.dtype, device=dev)
    gate = (gate.to(cost.dtype, device=dev) if isinstance(gate, torch.Tensor)
            else torch.full((), gate, dtype=cost.dtype, device=dev))
    masked = torch.where(valid & (cost <= gate), cost, big)
    assoc = torch.full((C,), -1, dtype=torch.int32, device=dev)
    iC = torch.arange(C, device=dev)
    iM = torch.arange(M, device=dev)
    for _ in range(rounds):
        flat = masked.reshape(-1)
        mn, idx = first_argmin(flat, 0)
        c, mm = idx // M, idx % M
        ok = mn < big
        assoc = torch.where(ok & (iC == c), mm.to(torch.int32), assoc)
        kill = (iC == c)[:, None] | (iM == mm)[None, :]
        masked = torch.where(ok & kill, big, masked)
    return assoc


def _use_fused_frame(model, cfg: TrackerConfig) -> bool:
    return cfg.fused_frame and frame_kernel_supported(model)


def _frame_inputs(model, cfg: TrackerConfig, z: torch.Tensor,
                  z_valid: torch.Tensor):
    """The scaled gate, the assignment round bound, the cast
    measurements and the (NaN-guarded) validity mask — applied before
    the route split, so both routes see identical inputs. z (M, m) or a
    fleet's (S, M, m)."""
    dtype = getattr(torch, cfg.dtype)
    gate = (cfg.gate or CHI2_99.get(model.m, 16.0)) * cfg.gate_scale
    rounds = min(cfg.capacity, cfg.max_meas)
    zt = z.to(dtype)
    if cfg.nan_guard:
        finite = torch.isfinite(zt).all(dim=-1)
        z_valid = z_valid & finite
        zt = torch.where(finite[..., None], zt,
                         torch.zeros((), dtype=dtype, device=zt.device))
    return dtype, float(gate), rounds, zt, z_valid


def _unassigned(assoc, z_valid, max_meas: int):
    """The valid measurements no slot took: assoc (C,) and z_valid (M,),
    or a fleet's (S, C) and (S, M)."""
    taken = torch.zeros(assoc.shape[:-1] + (max_meas,), dtype=torch.int32,
                        device=assoc.device)
    taken = taken.scatter_reduce(-1, assoc.clamp(0, max_meas - 1).long(),
                                 (assoc >= 0).to(torch.int32), reduce="amax")
    return z_valid & ~taken.bool()


def frame_step(model: FilterModel, cfg: TrackerConfig, bank: BankState,
               z: torch.Tensor, z_valid: torch.Tensor) -> FrameResult:
    """One tracking frame. z: (max_meas, m); z_valid: (max_meas,) bool."""
    dtype, gate, rounds, zt, z_valid = _frame_inputs(model, cfg, z, z_valid)
    if _use_fused_frame(model, cfg):
        x2, P2, assoc = katana_frame(model, bank.x, bank.P, zt, z_valid,
                                     bank.active, gate=gate, rounds=rounds)
        hits, misses, age = bank_lib.lifecycle_counters(bank, assoc)
        bank_u = bank._replace(x=x2, P=P2, hits=hits, misses=misses,
                               age=age)
    else:
        bank_p, z_pred, _S, Sinv, PHt = bank_lib.predict_bank(model, bank,
                                                              dtype)
        cost = mahalanobis_cost(z_pred, Sinv, zt)
        valid = bank_p.active[:, None] & z_valid[None, :]
        assoc = greedy_assign(cost, valid, gate, rounds)
        bank_u = bank_lib.update_bank(model, bank_p, zt, assoc, PHt, Sinv,
                                      dtype)
    unassigned = _unassigned(assoc, z_valid, cfg.max_meas)
    bank_s = bank_lib.spawn_tracks(model, bank_u, zt, unassigned, dtype)
    bank_f = bank_lib.prune_bank(bank_s, cfg.max_misses)
    confirmed = bank_f.active & (bank_f.hits >= cfg.min_hits)
    return FrameResult(bank_f, assoc, unassigned, confirmed)


def imm_frame_step(imm: IMMModel, cfg: TrackerConfig, bank: IMMBankState,
                   z: torch.Tensor, z_valid: torch.Tensor) -> FrameResult:
    """One IMM tracking frame: mixing, K predicts, the cbar-weighted gate
    sum_k cbar_k d_k, assignment, K updates and the mode posterior.
    ``x_est`` is the moment-matched combined state; a slot spawned this
    frame takes its seed state (all modes seeded identically)."""
    dtype, gate, rounds, zt, z_valid = _frame_inputs(imm, cfg, z, z_valid)
    fused = _use_fused_frame(imm, cfg)
    if fused:
        x2, P2, mu2, x_c, assoc = katana_imm_frame(
            imm, bank.x, bank.P, bank.mu, zt, z_valid, bank.active,
            gate=gate, rounds=rounds)
        hits, misses, age = bank_lib.lifecycle_counters(bank, assoc)
        bank_u = bank._replace(x=x2, P=P2, mu=mu2, hits=hits,
                               misses=misses, age=age)
    else:
        bank_p, z_pred, S, Sinv, PHt, cbar = bank_lib.predict_imm_bank(
            imm, bank, dtype)
        cost = sum(cbar[:, k, None] * mahalanobis_cost(z_pred[k], Sinv[k],
                                                       zt)
                   for k in range(imm.K))
        valid = bank_p.active[:, None] & z_valid[None, :]
        assoc = greedy_assign(cost, valid, gate, rounds)
        bank_u = bank_lib.update_imm_bank(imm, bank_p, zt, assoc, z_pred,
                                          PHt, Sinv, S, cbar, dtype)
    unassigned = _unassigned(assoc, z_valid, cfg.max_meas)
    bank_s = bank_lib.spawn_imm_tracks(imm, bank_u, zt, unassigned, dtype)
    bank_f = bank_lib.prune_bank(bank_s, cfg.max_misses)
    confirmed = bank_f.active & (bank_f.hits >= cfg.min_hits)
    if fused:
        spawned = bank_s.active & ~bank_u.active
        x_est = torch.where(spawned[..., None], bank_f.x[0], x_c)
    else:
        x_est, _ = imm_combine(bank_f.x, bank_f.P, bank_f.mu)
    return FrameResult(bank_f, assoc, unassigned, confirmed,
                       mode_probs=bank_f.mu, x_est=x_est)


def make_multi_sensor_step(model, cfg: TrackerConfig, device="cuda"):
    """The S-sensor frame step of ``frame_step`` (FilterModel) or
    ``imm_frame_step`` (IMMModel). Returns ``(bank, axes, step)``:
    ``bank`` one empty single-sensor bank on ``device``, ``axes`` its
    sensor-axis positions (``bank.bank_sensor_axes``), and ``step(banks,
    z (S, max_meas, m), valid (S, max_meas))`` the stacked
    ``FrameResult`` of S independent sensors (assoc, confirmed (S, C),
    unassigned (S, M); IMM mode_probs (S, C, K) and x_est (S, C, n)).

    On the fused route the step is the single-sensor step over the
    stacked banks: one ``katana_frame`` / ``katana_imm_frame`` call for
    the fleet and the torch glue on a leading sensor axis, with no loop
    over sensors. Association, spawn, prune and the track ids stay per
    sensor, each bit for bit its own single-sensor frame. The einsum
    route (``fused_frame=False``, the oracle) runs the single-sensor step
    per sensor and stacks the results."""
    is_imm = isinstance(model, IMMModel)
    one = (bank_lib.init_imm_bank if is_imm else bank_lib.init_bank)(
        model, cfg.capacity, getattr(torch, cfg.dtype), resolve_device(device))
    axes = bank_lib.bank_sensor_axes(one)
    base = imm_frame_step if is_imm else frame_step

    def step(banks, z, valid):
        if _use_fused_frame(model, cfg):
            return base(model, cfg, banks, z, valid)
        res = [base(model, cfg, bank_lib.slice_sensor_bank(banks, s), z[s],
                    valid[s])
               for s in range(z.shape[0])]
        bank = type(banks)(*(torch.stack(leaves, dim=a) for a, leaves in
                             zip(axes, zip(*(r.bank for r in res)))))
        return FrameResult(bank, *(
            None if f[0] is None else torch.stack(f)
            for f in zip(*(r[1:] for r in res))))

    return one, axes, step


def _clone(res: FrameResult) -> FrameResult:
    """The same FrameResult in fresh tensors."""
    return FrameResult(type(res.bank)(*(t.clone() for t in res.bank)),
                       *(None if t is None else t.clone() for t in res[1:]))


class _Capture(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple             # static (bank, z, z_valid)
    out: FrameResult          # static outputs, rewritten by each replay
    launches: dict            # LAUNCHES a replay adds


class JittedStep:
    """``step(bank, z, z_valid) -> FrameResult`` of ``make_jitted_tracker``
    and ``make_jitted_imm_tracker``: the counterpart of ``jax.jit`` over
    one frame.

    On a CUDA device the first call for a signature (the shapes and
    dtypes of bank, z, valid; a new one captures anew, as ``jax.jit``
    retraces) runs the frame eagerly on a side stream, which warms up the
    kernels and gives that call's result, then captures the frame once
    into a ``torch.cuda.CUDAGraph`` on static copies of its inputs. Every
    later call copies bank, z and valid into those buffers, replays the
    graph and returns clones of its outputs, so a result is never
    overwritten by a later call (the reference's step is a pure
    function). ``ops.LAUNCHES`` counts the launches the frame makes: the
    capture's own count is taken back and each replay adds it, so the
    counts stay those of the kernels run. A capture that fails raises;
    nothing falls back to eager frames.

    On the CPU (the caller asked for it) a call is the frame step itself.
    ``captures`` counts the graphs captured, ``replays`` their replays."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = device
        self.captures = 0
        self.replays = 0
        self._graphs = {}

    def __call__(self, bank, z, z_valid) -> FrameResult:
        z = torch.as_tensor(z, device=self.device)
        z_valid = torch.as_tensor(z_valid, device=self.device)
        if self.device.type != "cuda":
            return self.fn(bank, z, z_valid)
        inputs = (*bank, z, z_valid)
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)
        cap = self._graphs.get(key)
        if cap is None:
            res, self._graphs[key] = self._capture(bank, z, z_valid)
            return res
        bank_s, z_s, valid_s = cap.inputs
        for static, t in zip((*bank_s, z_s, valid_s), inputs):
            static.copy_(t)
        cap.graph.replay()
        self.replays += 1
        for k, n in cap.launches.items():
            LAUNCHES[k] += n
        return _clone(cap.out)

    def _capture(self, bank, z, z_valid):
        static = (type(bank)(*(t.clone() for t in bank)), z.clone(),
                  z_valid.clone())
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            res = self.fn(*static)
        main.wait_stream(side)
        for t in (*res.bank, *res[1:]):
            if t is not None:
                t.record_stream(main)
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(*static)
        launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        for k, n in launches.items():
            LAUNCHES[k] -= n
        self.captures += 1
        return res, _Capture(graph, static, out, launches)


def make_jitted_tracker(model: FilterModel, cfg: TrackerConfig,
                        device="cuda"):
    """Returns ``(init, step)``: ``init()`` an empty bank on ``device``,
    ``step(bank, z, z_valid)`` the frame step, captured once into a CUDA
    graph on a card (``JittedStep``)."""
    dev = resolve_device(device)

    def init():
        return bank_lib.init_bank(model, cfg.capacity,
                                  getattr(torch, cfg.dtype), dev)

    return init, JittedStep(
        lambda bank, z, v: frame_step(model, cfg, bank, z, v), dev)


def make_jitted_imm_tracker(imm: IMMModel, cfg: TrackerConfig,
                            device="cuda"):
    """IMM twin of ``make_jitted_tracker``: ``(init, step)`` over an
    IMMBankState, one captured frame per call on a card."""
    dev = resolve_device(device)

    def init():
        return bank_lib.init_imm_bank(imm, cfg.capacity,
                                      getattr(torch, cfg.dtype), dev)

    return init, JittedStep(
        lambda bank, z, v: imm_frame_step(imm, cfg, bank, z, v), dev)
