"""Fixed-capacity filter bank: KATANA's "one inference call, N filters".

A static-shape array of ``capacity`` filter slots (state, covariance,
lifecycle counters); slots are (de)activated by masks, never by
reshaping. ``IMMBankState`` carries K model-conditioned (x, P) pairs
per slot plus the mode probabilities mu; the lifecycle fields stay per
slot, shared by the K hypotheses.

Dtypes follow the reference: float state, int32 counters and ids, bool
masks. Functions return new NamedTuples and never modify their inputs.

A fleet of S sensors stacks S banks on a sensor axis
(``bank_sensor_axes``): position 1 of the model-conditioned IMM x, P (the
(K, S, C, ...) layout, so a fleet's x is (K, S*C, n) to the kernels), 0 of
every other leaf. The lifecycle glue (``lifecycle_counters``, spawn,
prune) takes such a leading sensor axis as it is: its ops run along the
last axes, so a fleet costs the same op count as one sensor.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.filters import FilterModel, IMMModel, device_const
from repro_torch.core.rewrites import (gaussian_loglik, imm_mix,
                                       imm_mode_posterior, small_det,
                                       small_inv, stage_constants,
                                       sym_unpack, triu_index)
from repro_torch.kernels.katana_bank.ops import katana_imm_sequence


class BankState(NamedTuple):
    x: torch.Tensor        # (C, n) state means
    P: torch.Tensor        # (C, n, n) covariances
    active: torch.Tensor   # (C,) bool
    hits: torch.Tensor     # (C,) int32 — consecutive associations
    misses: torch.Tensor   # (C,) int32 — consecutive misses
    age: torch.Tensor      # (C,) int32 — frames since spawn
    track_id: torch.Tensor  # (C,) int32 — stable external id (-1 = free)
    next_id: torch.Tensor  # () int32 — id counter


class IMMBankState(NamedTuple):
    x: torch.Tensor        # (K, C, n) model-conditioned state means
    P: torch.Tensor        # (K, C, n, n) model-conditioned covariances
    mu: torch.Tensor       # (C, K) mode probabilities (rows sum to 1)
    active: torch.Tensor   # (C,) bool
    hits: torch.Tensor     # (C,) int32
    misses: torch.Tensor   # (C,) int32
    age: torch.Tensor      # (C,) int32
    track_id: torch.Tensor  # (C,) int32 (-1 = free)
    next_id: torch.Tensor  # () int32


def _lifecycle_init(capacity: int, device):
    i32 = dict(dtype=torch.int32, device=device)
    return dict(active=torch.zeros((capacity,), dtype=torch.bool,
                                   device=device),
                hits=torch.zeros((capacity,), **i32),
                misses=torch.zeros((capacity,), **i32),
                age=torch.zeros((capacity,), **i32),
                track_id=torch.full((capacity,), -1, **i32),
                next_id=torch.zeros((), **i32))


def init_bank(model: FilterModel, capacity: int, dtype=torch.float32,
              device="cuda") -> BankState:
    device = resolve_device(device)
    n = model.n
    return BankState(
        x=torch.zeros((capacity, n), dtype=dtype, device=device),
        P=device_const(model, "P0", model.P0, dtype, device).expand(
            capacity, n, n).clone(),
        **_lifecycle_init(capacity, device))


def init_imm_bank(imm: IMMModel, capacity: int, dtype=torch.float32,
                  device="cuda") -> IMMBankState:
    device = resolve_device(device)
    n, K = imm.n, imm.K
    return IMMBankState(
        x=torch.zeros((K, capacity, n), dtype=dtype, device=device),
        P=device_const(imm, "P0", imm.P0, dtype, device).expand(
            K, capacity, n, n).clone(),
        mu=device_const(imm, "mu0", imm.mu0, dtype, device).expand(
            capacity, K).clone(),
        **_lifecycle_init(capacity, device))


def _predict_lanes(model: FilterModel, x: torch.Tensor, P: torch.Tensor,
                   dtype=torch.float32):
    """Batched-lanes time update + innovation quantities for (C, n)
    states: (x_pred, P_pred, z_pred, S, Sinv, PHt). Only the upper
    triangle of F·P·Fᵀ + Q is computed; the mirrors alias it."""
    n = model.n
    iu, ju = triu_index(n, x.device)
    C = stage_constants(model, dtype, x.device)
    Qtri = C.Q[iu, ju]
    if model.is_linear:
        x_pred = torch.einsum("ij,kj->ki", C.F, x)
        FP = torch.einsum("ij,kjl->kil", C.F, P)
        tri = torch.einsum("ktl,tl->kt", FP[:, iu, :], C.F[ju, :]) + Qtri
    else:
        x_pred = model.predict_mean(x)
        Fk = model.jacobian(x)
        FP = torch.einsum("kij,kjl->kil", Fk, P)
        tri = torch.einsum("ktl,ktl->kt", FP[:, iu, :], Fk[:, ju, :]) + Qtri
    P_pred = sym_unpack(tri, n)
    z_pred = torch.einsum("mi,ki->km", C.H, x_pred)
    PHt = torch.einsum("kij,mj->kim", P_pred, C.H)
    S = torch.einsum("mi,kij,nj->kmn", C.H, P_pred, C.H) + C.R
    Sinv = small_inv(S, model.m)
    return x_pred, P_pred, z_pred, S, Sinv, PHt


def _kalman_update_lanes(model: FilterModel, x_pred, P_pred, zk, PHt, Sinv,
                         dtype=torch.float32):
    """Subtract-free batched measurement update consuming the
    precomputed P·Hᵀ and S^{-1}; the posterior covariance is emitted
    upper-triangle-only with aliased mirrors."""
    n = model.n
    iu, ju = triu_index(n, x_pred.device)
    C = stage_constants(model, dtype, x_pred.device)
    y = zk + torch.einsum("mi,ki->km", C.H_neg, x_pred)
    K = torch.einsum("kim,kmn->kin", PHt, Sinv)
    x_new = x_pred + torch.einsum("kin,kn->ki", K, y)
    HnP = torch.einsum("mi,kij->kmj", C.H_neg, P_pred)
    tri = (P_pred[:, iu, ju]
           + torch.einsum("ktm,kmt->kt", K[:, iu, :], HnP[:, :, ju]))
    return x_new, sym_unpack(tri, n)


def predict_bank(model: FilterModel, bank: BankState, dtype=torch.float32):
    """Time-update every slot. Returns (bank', z_pred (C, m), S, Sinv
    (C, m, m), PHt (C, n, m)) — the innovation quantities computed once
    per frame for the gate and the update."""
    x_pred, P_pred, z_pred, S, Sinv, PHt = _predict_lanes(
        model, bank.x, bank.P, dtype)
    return bank._replace(x=x_pred, P=P_pred), z_pred, S, Sinv, PHt


def _gather_assigned(z, assoc):
    return z[torch.clamp(assoc, 0, z.shape[0] - 1).long()]


def update_bank(model: FilterModel, bank: BankState, z: torch.Tensor,
                assoc: torch.Tensor, PHt: Optional[torch.Tensor] = None,
                Sinv: Optional[torch.Tensor] = None,
                dtype=torch.float32) -> BankState:
    """Measurement-update associated slots (assoc (C,) index into z or
    -1). PHt/Sinv pass through from ``predict_bank``; None recomputes
    them from the predicted bank."""
    C = stage_constants(model, dtype, bank.x.device)
    has_z = assoc >= 0
    zk = _gather_assigned(z, assoc)  # garbage where -1, masked below
    x_pred, P_pred = bank.x, bank.P
    if PHt is None:
        PHt = torch.einsum("kij,mj->kim", P_pred, C.H)
    if Sinv is None:
        S = torch.einsum("mi,kij,nj->kmn", C.H, P_pred, C.H) + C.R
        Sinv = small_inv(S, model.m)
    x_new, P_new = _kalman_update_lanes(model, x_pred, P_pred, zk, PHt, Sinv,
                                        dtype)
    upd = has_z & bank.active
    x_out = torch.where(upd[:, None], x_new, x_pred)
    P_out = torch.where(upd[:, None, None], P_new, P_pred)
    hits, misses, age = lifecycle_counters(bank, assoc)
    return bank._replace(x=x_out, P=P_out, hits=hits, misses=misses, age=age)


def lifecycle_counters(bank, assoc: torch.Tensor):
    """The per-slot hit/miss/age advance for one frame from assoc (C,)
    (or (S, C) for a fleet). Returns (hits, misses, age)."""
    one = torch.ones((), dtype=torch.int32, device=assoc.device)
    zero = torch.zeros((), dtype=torch.int32, device=assoc.device)
    upd = (assoc >= 0) & bank.active
    hits = torch.where(upd, bank.hits + one, bank.hits)
    misses = torch.where(upd, zero, torch.where(bank.active,
                                                bank.misses + one,
                                                bank.misses))
    age = torch.where(bank.active, bank.age + one, bank.age)
    return hits, misses, age


def _spawn_plan(active: torch.Tensor, unassigned: torch.Tensor):
    """Deterministic free-slot packing: the j-th unassigned measurement
    claims the j-th free slot (cumsum ranks). Returns (take (Cap, M)
    bool, takes_any (Cap,), free_rank (Cap,) int32), each with the
    inputs' leading sensor axis if they have one."""
    free = ~active
    free_rank = torch.cumsum(free.to(torch.int32), -1, dtype=torch.int32) - 1
    meas_rank = torch.cumsum(unassigned.to(torch.int32), -1,
                             dtype=torch.int32) - 1
    take = (free[..., :, None] & unassigned[..., None, :]
            & (free_rank[..., :, None] == meas_rank[..., None, :]))
    return take, take.any(dim=-1), free_rank


def _spawn_init_state(model: FilterModel, take: torch.Tensor,
                      z: torch.Tensor, dtype=torch.float32):
    """Measurement-seeded initial state per claiming slot: z mapped
    through Hᵀ, the unobserved components at the model defaults. A slot
    claims at most one measurement, so the selection is a gather
    (exact). take (..., Cap, M), z (..., M, m)."""
    j = take.to(torch.int32).argmax(dim=-1)
    zj = torch.take_along_dim(z, j.long()[..., None], dim=-2)
    zsel = torch.where(take.any(dim=-1)[..., None], zj,
                       torch.zeros((), dtype=z.dtype, device=z.device))
    Ht = device_const(model, "H^T", lambda: np.asarray(model.H).T, dtype,
                      z.device)                               # (n, m)
    unobs = 1.0 - Ht.sum(dim=1)                               # (n,)
    return zsel @ Ht.T + device_const(model, "x0", model.x0, dtype,
                                      z.device) * unobs


def _spawn_fields(bank, takes_any, free_rank):
    i32 = dict(dtype=torch.int32, device=takes_any.device)
    new_ids = bank.next_id[..., None] + free_rank
    return dict(
        active=bank.active | takes_any,
        hits=torch.where(takes_any, torch.ones((), **i32), bank.hits),
        misses=torch.where(takes_any, torch.zeros((), **i32), bank.misses),
        age=torch.where(takes_any, torch.zeros((), **i32), bank.age),
        track_id=torch.where(takes_any, new_ids, bank.track_id),
        next_id=bank.next_id + takes_any.sum(dim=-1, dtype=torch.int32),
    )


def spawn_tracks(model: FilterModel, bank: BankState, z: torch.Tensor,
                 unassigned: torch.Tensor, dtype=torch.float32) -> BankState:
    """Open new tracks for unassigned measurements (M,) in free slots
    (a fleet: z (S, M, m), unassigned (S, M))."""
    take, takes_any, free_rank = _spawn_plan(bank.active, unassigned)
    x_init = _spawn_init_state(model, take, z, dtype)
    P_init = device_const(model, "P0", model.P0, dtype, z.device)
    return bank._replace(
        x=torch.where(takes_any[..., None], x_init, bank.x),
        P=torch.where(takes_any[..., None, None], P_init, bank.P),
        **_spawn_fields(bank, takes_any, free_rank))


def spawn_imm_tracks(imm: IMMModel, bank: IMMBankState, z: torch.Tensor,
                     unassigned: torch.Tensor,
                     dtype=torch.float32) -> IMMBankState:
    """IMM spawn: every mode starts from the same measurement-seeded
    state, covariance P0 and the prior mode distribution ``imm.mu0``
    (a fleet: z (S, M, m), unassigned (S, M))."""
    take, takes_any, free_rank = _spawn_plan(bank.active, unassigned)
    x_init = _spawn_init_state(imm.models[0], take, z, dtype)  # shared H
    P_init = device_const(imm, "P0", imm.P0, dtype, z.device)
    mu_init = device_const(imm, "mu0", imm.mu0, dtype, z.device)
    return bank._replace(
        x=torch.where(takes_any[None, ..., None], x_init[None], bank.x),
        P=torch.where(takes_any[None, ..., None, None], P_init, bank.P),
        mu=torch.where(takes_any[..., None], mu_init, bank.mu),
        **_spawn_fields(bank, takes_any, free_rank))


def prune_bank(bank, max_misses: int = 5):
    """Retire tracks that coasted too long (BankState or IMMBankState,
    one sensor's or a fleet's)."""
    dead = bank.active & (bank.misses > max_misses)
    zero = torch.zeros((), dtype=torch.int32, device=dead.device)
    return bank._replace(
        active=bank.active & ~dead,
        track_id=torch.where(dead, -torch.ones_like(zero), bank.track_id),
        hits=torch.where(dead, zero, bank.hits),
        misses=torch.where(dead, zero, bank.misses),
    )


def bank_sensor_axes(bank):
    """Per-leaf sensor-axis positions for stacking this bank over S
    independent sensors: 1 for the model-conditioned x, P of an
    ``IMMBankState`` (the (K, S, C, ...) layout: one contiguous (sensor,
    slot) block per model slab, which the fleet's kernels and its replay
    flatten onto their track axis), 0 for every other leaf."""
    if isinstance(bank, IMMBankState):
        return IMMBankState(x=1, P=1, mu=0, active=0, hits=0, misses=0,
                            age=0, track_id=0, next_id=0)
    return BankState(x=0, P=0, active=0, hits=0, misses=0, age=0,
                     track_id=0, next_id=0)


def _map_sensor_axes(fn, bank, *rest):
    axes = bank_sensor_axes(bank)
    return type(bank)(*(fn(a, leaf, *more)
                        for a, leaf, *more in zip(axes, bank, *rest)))


def stack_sensor_banks(bank, n_sensors: int):
    """Broadcast one bank into an S-sensor stack along
    ``bank_sensor_axes`` (every sensor starts from the same bank); each
    leaf is a new contiguous tensor. BankState and IMMBankState alike."""
    def put(a, x):
        x = x.unsqueeze(a)
        shape = x.shape[:a] + (n_sensors,) + x.shape[a + 1:]
        return x.expand(shape).contiguous()

    return _map_sensor_axes(put, bank)


def slice_sensor_bank(banks, s: int):
    """Sensor ``s`` of a stacked bank as a single-sensor bank (the
    inverse of one lane of ``stack_sensor_banks``): the checkpoint and
    failover surface. Each leaf is a new contiguous tensor, so the
    result shares no memory with the fleet."""
    return _map_sensor_axes(lambda a, x: x.select(a, s).clone(), banks)


def place_sensor_bank(banks, s: int, one):
    """Write a single-sensor bank into lane ``s`` of a stacked bank, the
    other lanes untouched: the restore half of ``slice_sensor_bank``.
    Returns a new stacked bank; neither input is modified."""
    def put(a, full, x):
        x = torch.as_tensor(x, dtype=full.dtype, device=full.device)
        idx = torch.tensor([s], device=full.device)
        return full.index_copy(a, idx, x.unsqueeze(a))

    return _map_sensor_axes(put, banks, one)


def predict_imm_bank(imm: IMMModel, bank: IMMBankState, dtype=torch.float32):
    """IMM mixing + K model-conditioned time updates. Returns (bank',
    z_pred (K, C, m), S, Sinv (K, C, m, m), PHt (K, C, n, m),
    cbar (C, K))."""
    Pi = device_const(imm, "trans", imm.trans, dtype, bank.x.device)
    x_mix, P_mix, cbar = imm_mix(bank.x, bank.P, bank.mu, Pi)
    outs = [_predict_lanes(model, x_mix[k], P_mix[k], dtype)
            for k, model in enumerate(imm.models)]
    x_pred, P_pred, z_pred, S, Sinv, PHt = (
        torch.stack([o[i] for o in outs]) for i in range(6))
    return (bank._replace(x=x_pred, P=P_pred), z_pred, S, Sinv, PHt, cbar)


def update_imm_bank(imm: IMMModel, bank: IMMBankState, z: torch.Tensor,
                    assoc: torch.Tensor,
                    z_pred: Optional[torch.Tensor] = None,
                    PHt: Optional[torch.Tensor] = None,
                    Sinv: Optional[torch.Tensor] = None,
                    S: Optional[torch.Tensor] = None,
                    cbar: Optional[torch.Tensor] = None,
                    dtype=torch.float32) -> IMMBankState:
    """K model-conditioned measurement updates + the mode posterior.
    ``bank`` is the post-predict state; missing innovation quantities
    recompute from it. Associated slots get mu ∝ cbar·N(y; 0, S),
    coasting slots keep cbar."""
    m = imm.m
    dev = bank.x.device
    consts = ([stage_constants(model, dtype, dev) for model in imm.models]
              if z_pred is None or PHt is None or S is None else None)
    if z_pred is None:
        z_pred = torch.stack([torch.einsum("mi,ki->km", Ck.H, bank.x[k])
                              for k, Ck in enumerate(consts)])
    if PHt is None:
        PHt = torch.stack([torch.einsum("kij,mj->kim", bank.P[k], Ck.H)
                           for k, Ck in enumerate(consts)])
    if S is None:
        S = torch.stack([torch.einsum("mi,kij,nj->kmn", Ck.H, bank.P[k],
                                      Ck.H) + Ck.R
                         for k, Ck in enumerate(consts)])
    if Sinv is None:
        Sinv = small_inv(S, m)
    if cbar is None:
        cbar = bank.mu @ device_const(imm, "trans", imm.trans, dtype, dev)
    has_z = assoc >= 0
    zk = _gather_assigned(z, assoc)
    x_new, P_new, loglik = [], [], []
    for k, model in enumerate(imm.models):
        xk, Pk = _kalman_update_lanes(model, bank.x[k], bank.P[k], zk,
                                      PHt[k], Sinv[k], dtype)
        x_new.append(xk)
        P_new.append(Pk)
        y = zk - z_pred[k]
        loglik.append(gaussian_loglik(y, Sinv[k],
                                      torch.log(small_det(S[k], m)), m))
    x_new, P_new = torch.stack(x_new), torch.stack(P_new)
    mu_post = imm_mode_posterior(cbar, torch.stack(loglik))

    upd = has_z & bank.active
    x_out = torch.where(upd[None, :, None], x_new, bank.x)
    P_out = torch.where(upd[None, :, None, None], P_new, bank.P)
    mu_out = torch.where(upd[:, None], mu_post, cbar)
    hits, misses, age = lifecycle_counters(bank, assoc)
    return bank._replace(x=x_out, P=P_out, mu=mu_out, hits=hits,
                         misses=misses, age=age)


def replay_imm_bank(imm: IMMModel, bank: IMMBankState, zs: torch.Tensor,
                    valid: Optional[torch.Tensor] = None, **kw):
    """Re-filter a pre-associated (T, C, m) stream seeded from the bank's
    mode-conditioned state (x, P, mu): the IMM replay scan
    (``ops.katana_imm_sequence``). ``valid`` (T, C) bool: a False frame
    coasts the slot (time update only, mu <- cbar), as ``update_imm_bank``
    treats an unassociated slot. Returns the (T, C, n) combined
    estimates; ``return_final=True`` in ``kw`` also returns the final
    (x, P, mu). The bank is not modified."""
    return katana_imm_sequence(imm, zs, bank.x, bank.P, mu0=bank.mu,
                               valid=valid, **kw)
