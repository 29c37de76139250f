"""KATANA tracking engine: the paper's serving workload as a batched
request server.

One frame step (predict -> gate -> associate -> update -> spawn ->
prune) serves every measurement of a frame with a fixed-capacity bank.
Under ``TrackerConfig.fused_frame`` (the default) the measurement cycle
is the ``katana_frame`` / ``katana_imm_frame`` kernels, so the
closed-loop FPS the engine reports is the fused-kernel number. Requests
are padded into the static measurement slots. ``replay`` filters a
pre-associated stream offline through the replay scans
(``katana_bank_sequence`` / ``katana_imm_sequence``), accounted apart
from the live frames.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bank import init_bank, init_imm_bank
from repro_torch.core.filters import IMMModel
from repro_torch.core.tracker import (TrackerConfig, frame_step,
                                      imm_frame_step)
from repro_torch.kernels.katana_bank.ops import (katana_bank_sequence,
                                                 katana_imm_sequence)


@dataclass
class TrackSnapshot:
    track_id: int
    state: np.ndarray
    hits: int
    age: int
    # IMM engines only: per-mode probabilities (K,), aligned with
    # model.models; None for single-model engines
    mode_probs: Optional[np.ndarray] = None


@dataclass
class EngineStats:
    frames: int = 0
    total_latency_s: float = 0.0
    measurements: int = 0
    # offline replay, counted apart so that it never dilutes the live fps
    replay_frames: int = 0
    replay_latency_s: float = 0.0

    @property
    def fps(self) -> float:
        return self.frames / self.total_latency_s if self.total_latency_s else 0.0

    @property
    def replay_fps(self) -> float:
        return (self.replay_frames / self.replay_latency_s
                if self.replay_latency_s else 0.0)


class TrackingEngine:
    """Single-sensor engine: submit measurements per frame, get confirmed
    tracks back. Accepts a FilterModel or an IMMModel (an IMM engine
    reports the combined state and the mode probabilities). Runs on
    ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, model, cfg: Optional[TrackerConfig] = None,
                 device="cuda"):
        self.model = model
        self.cfg = cfg or TrackerConfig()
        self.device = resolve_device(device)
        self.is_imm = isinstance(model, IMMModel)
        dtype = getattr(torch, self.cfg.dtype)
        if self.is_imm:
            self.bank = init_imm_bank(model, self.cfg.capacity, dtype,
                                      self.device)
            self._step_fn = imm_frame_step
        else:
            self.bank = init_bank(model, self.cfg.capacity, dtype,
                                  self.device)
            self._step_fn = frame_step
        self.stats = EngineStats()
        # FrameResult of the last submitted frame (assoc, unassigned, ...)
        self.last = None
        # one throwaway frame builds and loads the kernels, so serving
        # latency excludes the build
        z0 = torch.zeros((self.cfg.max_meas, model.m), device=self.device)
        v0 = torch.zeros((self.cfg.max_meas,), dtype=torch.bool,
                         device=self.device)
        self._step(z0, v0).bank.x.cpu()

    def _step(self, z, valid):
        return self._step_fn(self.model, self.cfg, self.bank, z, valid)

    def submit(self, measurements: np.ndarray) -> List[TrackSnapshot]:
        """measurements: (k, m) this frame (k <= max_meas)."""
        mm = np.zeros((self.cfg.max_meas, self.model.m), np.float32)
        vv = np.zeros((self.cfg.max_meas,), bool)
        k = min(len(measurements), self.cfg.max_meas)
        if k:
            mm[:k] = measurements[:k]
            vv[:k] = True
        t0 = time.perf_counter()
        res = self._step(torch.from_numpy(mm).to(self.device),
                         torch.from_numpy(vv).to(self.device))
        conf = res.confirmed.cpu().numpy()  # waits for the frame
        self.stats.total_latency_s += time.perf_counter() - t0
        self.stats.frames += 1
        self.stats.measurements += int(k)
        self.bank = res.bank
        self.last = res
        ids = self.bank.track_id.cpu().numpy()
        # IMM: report the combined (moment-matched) state
        xs = (res.x_est if res.x_est is not None else self.bank.x)
        xs = xs.cpu().numpy()
        mus = (res.mode_probs.cpu().numpy() if res.mode_probs is not None
               else None)
        hits = self.bank.hits.cpu().numpy()
        age = self.bank.age.cpu().numpy()
        return [TrackSnapshot(int(ids[i]), xs[i].copy(), int(hits[i]),
                              int(age[i]),
                              mus[i].copy() if mus is not None else None)
                for i in np.nonzero(conf)[0]]

    def replay(self, zs: np.ndarray, x0: Optional[np.ndarray] = None,
               P0: Optional[np.ndarray] = None) -> np.ndarray:
        """Filter a pre-associated (T, N, m) measurement stream offline
        (log replay, re-scoring): the whole stream goes through the
        replay scan (``katana_bank_sequence``; IMM engines
        ``katana_imm_sequence``, combined estimates out) with no gating or
        assignment. x0 (N, n) / P0 (N, n, n) default to the model's prior.
        Returns the (T, N, n) filtered states. The live bank is not
        touched; the time (host clock from the copy of ``zs`` to the card
        until the stream is done on it, as the reference's
        ``block_until_ready``; the copy of the states back to the host
        comes after) counts under the ``replay_*`` stats."""
        zs = np.asarray(zs, np.float32)
        T, N, _ = zs.shape
        if x0 is None:
            x0 = np.tile(self.model.x0, (N, 1))
        if P0 is None:
            P0 = np.tile(self.model.P0, (N, 1, 1))
        seq = katana_imm_sequence if self.is_imm else katana_bank_sequence
        dev = self.device
        x0 = torch.as_tensor(np.asarray(x0, np.float32), device=dev)
        P0 = torch.as_tensor(np.asarray(P0, np.float32), device=dev)
        t0 = time.perf_counter()
        out = seq(self.model, torch.from_numpy(zs).to(dev), x0, P0)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        self.stats.replay_latency_s += time.perf_counter() - t0
        self.stats.replay_frames += T
        return out.cpu().numpy()
