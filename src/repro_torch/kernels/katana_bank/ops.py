"""Wrappers of the live-frame kernels, canonical layouts in and out.

  ``katana_frame``          the single-model live frame: predict, gated
        Mahalanobis cost, greedy assignment, update (csrc/frame.cu).
  ``katana_imm_frame``      the IMM live frame: + mixing, per-model
        log-likelihoods, mode posterior and combined estimate
        (csrc/imm_frame.cu; K=1 runs frame.cu with mu passed through).
  ``katana_greedy_assign``  the frames' greedy assignment on its own
        (csrc/greedy.cu), the test surface against
        ``tracker.greedy_assign``.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a
tensor on a CUDA device launches the kernel on the current stream or
raises — nothing falls back. ``LAUNCHES`` counts the kernel launches of
each wrapper (the frames also count their greedy launch under
``greedy_assign``). The kernels take the canonical layouts directly
(x (C, n), P (C, n, n), z (M, m)) and mask by C, so nothing is padded
or transposed here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.filters import FilterModel, IMMModel
from repro_torch.kernels import build
from repro_torch.kernels.katana_bank import ref

LAUNCHES: Dict[str, int] = {"katana_frame": 0, "katana_imm_frame": 0,
                            "greedy_assign": 0}

# (n, m) of the single-model frame instantiations, (K, n, m) of the IMM
FRAME_SHAPES = ((6, 3), (8, 4), (9, 3))
IMM_FRAME_SHAPES = ((4, 9, 3),)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    """The kernels are instantiated for the repo's models: raise for any
    shape or selector they were not built for."""
    n, m = model.n, model.m
    if (n, m) not in FRAME_SHAPES:
        raise NotImplementedError(
            f"no frame kernel for (n, m)={(n, m)}; built for {FRAME_SHAPES}")
    if ref.selector_rows(model.H) != _expected_obs(n, m):
        raise NotImplementedError(
            f"frame kernel (n, m)={(n, m)} observes state rows "
            f"{_expected_obs(n, m)}; H selects {ref.selector_rows(model.H)}")
    if not model.is_linear and (n, m) != (8, 4):
        raise NotImplementedError(
            "the nonlinear frame path is the CTRA-8 model (n=8, m=4)")


_CONSTS: Dict[Tuple[object, str], torch.Tensor] = {}


def _consts(models, trans, device) -> torch.Tensor:
    """Device table of the model constants: per model F, Q, R (row
    major), then the Markov matrix. Cached per model set and device."""
    key = (tuple(models), str(device))
    t = _CONSTS.get(key)
    if t is None:
        parts = [np.asarray(getattr(mdl, nm), np.float64).ravel()
                 for mdl in models for nm in ("F", "Q", "R")]
        parts.append(np.asarray(trans, np.float64).ravel())
        t = torch.as_tensor(np.concatenate(parts).astype(np.float32),
                            device=device)
        _CONSTS[key] = t
    return t


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


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _launch_frame(model: FilterModel, x, P, z, z_valid, active, gate: float,
                  rounds: int):
    """The three launches of the single-model frame (csrc/frame.cu)."""
    _check_model(model)
    dev = x.device
    C, n = x.shape
    M, m = z.shape
    f32 = torch.float32
    _require(x, "x", f32, (C, n), dev)
    _require(P, "P", f32, (C, n, n), dev)
    _require(z, "z", f32, (M, m), dev)
    _require(z_valid, "z_valid", torch.bool, (M,), dev)
    _require(active, "active", torch.bool, (C,), dev)
    consts = _consts((model,), np.ones((1, 1)), dev)
    x_out, P_out = torch.empty_like(x), torch.empty_like(P)
    assoc = torch.empty((C,), dtype=torch.int32, device=dev)
    cost = torch.empty((M, C), dtype=f32, device=dev)
    waves = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = build.load("frame.cu")
    code = lib.katana_frame_run(
        n, m, C, M, x.data_ptr(), P.data_ptr(), z.data_ptr(),
        z_valid.data_ptr(), active.data_ptr(), consts.data_ptr(),
        int(not model.is_linear), float(model.dt), float(gate), int(rounds),
        x_out.data_ptr(), P_out.data_ptr(), assoc.data_ptr(),
        cost.data_ptr(), waves.data_ptr(), _stream(dev))
    build.check(lib, code, "katana_frame")
    LAUNCHES["greedy_assign"] += 1
    return x_out, P_out, assoc, waves


def katana_frame(model: FilterModel, x, P, z, z_valid, active, gate: float,
                 rounds: int, return_waves: bool = False):
    """The fused live tracking frame. x (C, n); P (C, n, n); z (M, m);
    z_valid (M,) bool; active (C,) bool; ``gate``/``rounds`` are the
    tracker's chi-square gate and assignment-round bound. Returns
    (x' (C, n), P' (C, n, n), assoc (C,) int32): the updated state where
    a slot got a measurement, the predicted state elsewhere. With
    ``return_waves`` also the number of greedy waves run (a device
    int32 tensor on CUDA, an int on the CPU)."""
    if not _on_cuda(x):
        return ref.katana_frame_plain(model, x, P, z, z_valid, active, gate,
                                      rounds, return_waves=return_waves)
    x2, P2, assoc, waves = _launch_frame(model, x, P, z, z_valid, active,
                                         gate, rounds)
    LAUNCHES["katana_frame"] += 1
    return (x2, P2, assoc, waves) if return_waves else (x2, P2, assoc)


def katana_imm_frame(imm: IMMModel, x, P, mu, z, z_valid, active,
                     gate: float, rounds: int, return_waves: bool = False):
    """The fused live IMM frame. x (K, C, n); P (K, C, n, n); mu (C, K);
    z (M, m); z_valid (M,) bool; active (C,) bool. Returns
    (x' (K, C, n), P' (K, C, n, n), mu' (C, K), x_c (C, n), assoc (C,)):
    coasting slots keep x̂/P̂ and take mu <- cbar. K=1 is the
    single-model frame with mu passed through."""
    if not _on_cuda(x):
        return ref.katana_imm_frame_plain(imm, x, P, mu, z, z_valid, active,
                                          gate, rounds,
                                          return_waves=return_waves)
    K, C, n = x.shape
    M, m = z.shape
    dev = x.device
    _require(mu, "mu", torch.float32, (C, K), dev)
    if K == 1:
        x2, P2, assoc, waves = _launch_frame(imm.models[0], x[0], P[0], z,
                                             z_valid, active, gate, rounds)
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
    _require(x, "x", f32, (K, C, n), dev)
    _require(P, "P", f32, (K, C, n, n), dev)
    _require(z, "z", f32, (M, m), dev)
    _require(z_valid, "z_valid", torch.bool, (M,), dev)
    _require(active, "active", torch.bool, (C,), dev)
    consts = _consts(imm.models, imm.trans, dev)
    x_out, P_out = torch.empty_like(x), torch.empty_like(P)
    mu_out = torch.empty_like(mu)
    xc = torch.empty((C, n), dtype=f32, device=dev)
    assoc = torch.empty((C,), dtype=torch.int32, device=dev)
    cost = torch.empty((M, C), dtype=f32, device=dev)
    waves = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = build.load("imm_frame.cu")
    code = lib.katana_imm_frame_run(
        K, n, m, C, M, x.data_ptr(), P.data_ptr(), mu.data_ptr(),
        z.data_ptr(), z_valid.data_ptr(), active.data_ptr(),
        consts.data_ptr(), float(gate), int(rounds),
        float(np.float32(m * ref.LOG_2PI)), x_out.data_ptr(),
        P_out.data_ptr(), mu_out.data_ptr(), xc.data_ptr(), assoc.data_ptr(),
        cost.data_ptr(), waves.data_ptr(), _stream(dev))
    build.check(lib, code, "katana_imm_frame")
    LAUNCHES["katana_imm_frame"] += 1
    LAUNCHES["greedy_assign"] += 1
    out = (x_out, P_out, mu_out, xc, assoc)
    return out + (waves,) if return_waves else out


def katana_greedy_assign(cost, valid, gate: float, rounds: int,
                         return_waves: bool = False):
    """The frames' greedy assignment standalone, canonical layout:
    cost (C, M) float32; valid (C, M) bool. Returns assoc (C,) int32."""
    if not _on_cuda(cost):
        return ref.greedy_assign_plain(cost, valid, gate, rounds,
                                       return_waves=return_waves)
    C, M = cost.shape
    dev = cost.device
    _require(cost, "cost", torch.float32, (C, M), dev)
    _require(valid, "valid", torch.bool, (C, M), dev)
    assoc = torch.empty((C,), dtype=torch.int32, device=dev)
    waves = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = build.load("greedy.cu")
    code = lib.greedy_assign_run(C, M, cost.data_ptr(), valid.data_ptr(),
                                 float(gate), int(rounds), assoc.data_ptr(),
                                 waves.data_ptr(), _stream(dev))
    build.check(lib, code, "greedy_assign")
    LAUNCHES["greedy_assign"] += 1
    return (assoc, waves) if return_waves else assoc
