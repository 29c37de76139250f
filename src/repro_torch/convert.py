"""Carry tracker state across to the port.

A tracking system has no weights: what carries over is the bank (state,
covariance, mode probabilities, lifecycle counters, ids) and the model
constants. Banks travel as numpy arrays, one per field of
``BankState`` / ``IMMBankState`` (``np.asarray`` of each leaf of the
reference bank); models as their numpy constants. Dtypes are kept:
float32 state, int32 counters and ids, bool masks.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bank import BankState, IMMBankState
from repro_torch.core.filters import FilterModel, IMMModel, make_ctra_ekf

_DTYPES = {"x": np.float32, "P": np.float32, "mu": np.float32,
           "active": np.bool_, "hits": np.int32, "misses": np.int32,
           "age": np.int32, "track_id": np.int32, "next_id": np.int32}

# nonlinear models rebuilt from their name: the dynamics are code
_NONLINEAR = {"ekf-ctra8": make_ctra_ekf}


def _fields(src) -> Dict[str, object]:
    if isinstance(src, Mapping):
        return dict(src)
    if hasattr(src, "_asdict"):
        return dict(src._asdict())
    return dict(vars(src))


def bank_from_numpy(fields, device="cuda"):
    """A BankState (or IMMBankState when ``mu`` is present) from numpy
    arrays keyed by field name (a mapping or a NamedTuple)."""
    device = resolve_device(device)
    f = _fields(fields)
    cls = IMMBankState if "mu" in f else BankState
    return cls(**{name: torch.as_tensor(
        np.asarray(f[name]).astype(_DTYPES[name]), device=device)
        for name in cls._fields})


def bank_to_numpy(bank) -> Dict[str, np.ndarray]:
    """The bank's fields as numpy arrays."""
    return {name: getattr(bank, name).cpu().numpy() for name in bank._fields}


def filter_model_from_numpy(src) -> FilterModel:
    """Rebuild a FilterModel from its constants (a mapping or any object
    with the attributes name, n, m, is_linear, F, H, Q, R, x0, P0, dt).
    A nonlinear model is rebuilt by name (its dynamics are code) and its
    constants must match the rebuilt ones."""
    f = _fields(src)
    arr = {k: np.asarray(f[k], np.float64)
           for k in ("F", "H", "Q", "R", "x0", "P0")}
    if not bool(f["is_linear"]):
        make = _NONLINEAR.get(f["name"])
        if make is None:
            raise KeyError(f"unknown nonlinear model {f['name']!r}")
        model = make(dt=float(f["dt"]))
        for k, v in arr.items():
            if not np.array_equal(getattr(model, k), v):
                raise ValueError(f"{f['name']}: {k} differs from the "
                                 "rebuilt model's")
        return model
    return FilterModel(name=str(f["name"]), n=int(f["n"]), m=int(f["m"]),
                       is_linear=True, dt=float(f["dt"]), **arr)


def imm_model_from_numpy(name: str, models: Sequence, trans,
                         mu0) -> IMMModel:
    """Rebuild an IMMModel from its member models' constants and the
    Markov chain (trans (K, K), mu0 (K,))."""
    return IMMModel(name=str(name),
                    models=tuple(filter_model_from_numpy(m) for m in models),
                    trans=np.asarray(trans, np.float64),
                    mu0=np.asarray(mu0, np.float64))
