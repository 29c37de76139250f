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

``ShardedBankEngine`` serves S independent sensors: their banks stacked
on a sensor axis, split into contiguous blocks over a list of devices
(shards), each shard's frame one call of the fused frame kernels for all
its sensors.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bank as bank_lib
from repro_torch.core.bank import init_bank, init_imm_bank
from repro_torch.core.filters import IMMModel, as_imm
from repro_torch.core.tracker import (FrameResult, TrackerConfig,
                                      frame_step, imm_frame_step,
                                      make_multi_sensor_step)
from repro_torch.kernels.katana_bank.ops import (katana_bank_sequence,
                                                 katana_imm_sequence)
from repro_torch.sharding.rules import sensor_blocks


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


def _on(dev):
    """The device context a shard's launches run under."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _wait(devices) -> None:
    """Block until the current stream of every CUDA device is done."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


class ShardedBankEngine:
    """S independent sensors, their banks stacked on a sensor axis
    (``bank.bank_sensor_axes``: the (K, S, C, ...) layout of the IMM x, P,
    a leading S elsewhere). Accepts a FilterModel or an IMMModel, as
    ``TrackingEngine``; every ``frame`` returns the stacked per-sensor
    ``FrameResult`` (IMM: with the mode probabilities and the combined
    estimates).

    Shards: device i of ``devices`` holds the contiguous block i of the
    sensors (``sharding.rules.sensor_blocks``) and runs their frame as
    one ``make_multi_sensor_step`` call, one fused frame kernel call for
    the block. A device may appear more than once: two shards on one card
    test the split. Sensors are independent, so every shard's sensors are
    bit for bit the single-sensor frames, whatever the split. Runs on
    the card unless ``devices`` names "cpu"."""

    def __init__(self, model, n_sensors: int,
                 cfg: Optional[TrackerConfig] = None,
                 devices: Sequence = ("cuda",)):
        self.model = model
        self.cfg = cfg or TrackerConfig(capacity=64, max_meas=32)
        self.n = n_sensors
        self.is_imm = isinstance(model, IMMModel)
        self._blocks = sensor_blocks(
            n_sensors, [resolve_device(d) for d in devices])
        self.devices = [dev for dev, _ in self._blocks]
        self._banks = []
        for dev, sl in self._blocks:
            one, self._axes, self._step = make_multi_sensor_step(
                model, self.cfg, dev)
            self._banks.append(bank_lib.stack_sensor_banks(
                one, sl.stop - sl.start))
        self.stats = EngineStats()
        # one throwaway frame (its result dropped) builds and loads the
        # kernels, so serving latency excludes the build
        z0 = np.zeros((n_sensors, self.cfg.max_meas, model.m), np.float32)
        v0 = np.zeros((n_sensors, self.cfg.max_meas), bool)
        self._frame(z0, v0)
        _wait(self.devices)

    @property
    def banks(self):
        """The stacked fleet: with one shard its stack itself; with more,
        the shards' stacks joined on the sensor axis on the first
        shard's device."""
        if len(self._banks) == 1:
            return self._banks[0]
        dev = self.devices[0]
        return type(self._banks[0])(*(
            torch.cat([leaf.to(dev) for leaf in leaves], dim=a)
            for a, leaves in zip(self._axes, zip(*self._banks))))

    def _frame(self, z: np.ndarray, valid: np.ndarray):
        """Every shard's inputs copied in, then every shard's step
        launched, none waited on. Returns the shards' FrameResults; the
        banks are not advanced."""
        inputs = [(torch.from_numpy(z[sl]).to(dev),
                   torch.from_numpy(valid[sl]).to(dev))
                  for dev, sl in self._blocks]
        out = []
        for (dev, _), banks, (zt, vt) in zip(self._blocks, self._banks,
                                             inputs):
            with _on(dev):
                out.append(self._step(banks, zt, vt))
        return out

    def frame(self, z: np.ndarray, valid: np.ndarray) -> FrameResult:
        """z: (S, max_meas, m); valid: (S, max_meas). Returns the stacked
        per-sensor FrameResult (for IMM engines ``mode_probs (S, C, K)``
        and ``x_est (S, C, n)``). The host clock runs from the copy of z
        to the cards until every shard's stream is done."""
        z = np.ascontiguousarray(z, np.float32)
        valid = np.ascontiguousarray(valid, bool)
        t0 = time.perf_counter()
        parts = self._frame(z, valid)
        _wait(self.devices)
        self.stats.total_latency_s += time.perf_counter() - t0
        self._banks = [r.bank for r in parts]
        self.stats.frames += 1
        self.stats.measurements += int(valid.sum())
        if len(parts) == 1:
            return parts[0]
        dev = self.devices[0]
        return FrameResult(self.banks, *(
            None if f[0] is None else torch.cat([t.to(dev) for t in f])
            for f in zip(*(r[1:] for r in parts))))

    def snapshots(self, res: FrameResult) -> List[List[TrackSnapshot]]:
        """Per-sensor confirmed-track snapshots of a ``frame`` result, the
        fleet version of ``TrackingEngine.submit``'s return (IMM engines
        report the combined state and the mode probabilities)."""
        conf = res.confirmed.cpu().numpy()
        ids = res.bank.track_id.cpu().numpy()
        hits = res.bank.hits.cpu().numpy()
        age = res.bank.age.cpu().numpy()
        if self.is_imm:
            xs = res.x_est.cpu().numpy()
            mus = res.mode_probs.cpu().numpy()
        else:
            xs, mus = res.bank.x.cpu().numpy(), None
        return [[TrackSnapshot(int(ids[s, i]), xs[s, i].copy(),
                               int(hits[s, i]), int(age[s, i]),
                               mus[s, i].copy() if mus is not None else None)
                 for i in np.nonzero(conf[s])[0]]
                for s in range(self.n)]

    def replay(self, zs: np.ndarray,
               valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Re-filter per-sensor pre-associated streams, seeded from the
        LIVE banks. zs: (T, S, C, m), row c of sensor s feeding slot c
        (C = the bank capacity; ``replay_imm_bank``'s contract per
        sensor); valid: optional (T, S, C) coasting mask (False: time
        update only, mu <- the Markov-predicted cbar). Each shard runs
        ONE ``katana_imm_sequence`` over its sensors flattened onto the
        track axis, resuming the mode-conditioned (x, P, mu); a
        single-model fleet runs the K = 1 IMM (``as_imm``: the
        single-model scan). Returns the (T, S, C, n) combined estimates.
        The live banks are untouched; the time (host clock from the copy
        of zs to the cards until every stream is done; the copy back
        comes after) counts under the ``replay_*`` stats."""
        zs = np.asarray(zs, np.float32)
        T, S, C, m = zs.shape
        if S != self.n or C != self.cfg.capacity:
            raise ValueError(f"zs {zs.shape}: expected (T, {self.n}, "
                             f"{self.cfg.capacity}, m)")
        imm = as_imm(self.model)
        K, n = imm.K, imm.n
        v = None if valid is None else np.asarray(valid, bool)
        t0 = time.perf_counter()
        outs = []
        for (dev, sl), banks in zip(self._blocks, self._banks):
            L = (sl.stop - sl.start) * C
            if self.is_imm:
                x0 = banks.x.reshape(K, L, n)
                P0 = banks.P.reshape(K, L, n, n)
                mu0 = banks.mu.reshape(L, K)
            else:
                x0, P0, mu0 = banks.x.reshape(L, n), banks.P.reshape(
                    L, n, n), None
            zt = torch.from_numpy(np.ascontiguousarray(
                zs[:, sl]).reshape(T, L, m)).to(dev)
            vt = (None if v is None else torch.from_numpy(
                np.ascontiguousarray(v[:, sl]).reshape(T, L)).to(dev))
            with _on(dev):
                outs.append(katana_imm_sequence(imm, zt, x0, P0, mu0=mu0,
                                                valid=vt))
        _wait(self.devices)
        self.stats.replay_latency_s += time.perf_counter() - t0
        self.stats.replay_frames += T
        return np.concatenate([o.cpu().numpy().reshape(T, -1, C, n)
                               for o in outs], axis=1)
