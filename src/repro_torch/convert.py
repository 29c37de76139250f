"""Carry tracker state and LM parameters across to the port.

The tracking system has no weights: what carries over is the bank (state,
covariance, mode probabilities, lifecycle counters, ids) and the model
constants. Banks travel as numpy arrays, one per field of
``BankState`` / ``IMMBankState`` (``np.asarray`` of each leaf of the
reference bank); models as their numpy constants. Dtypes are kept:
float32 state, int32 counters and ids, bool masks. An LM's parameter
tree carries over leaf by leaf (``lm_params_from_numpy``), and so does a
training state (``train_state_from_numpy``).
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


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_numpy(tree, cfg, device="cuda"):
    """The port's LM parameters from the reference's parameter tree as
    numpy arrays (``jax.tree.map(np.asarray, params)``). The port keeps
    the reference's tree and layouts (``groups`` stacked on a leading
    layer-group axis, ``wq`` (d, H, hd), ``wo`` (H, hd, d), ...), so this
    is a copy; every leaf is checked against the shapes
    ``init_params(cfg)`` makes, the MoE layers' (``moe``: router, w_in,
    w_gate, w_out) and the frontend stub's (``frontend``: proj, norm)
    included. Dtypes are kept (bfloat16 included; a float32 router stays
    float32 in a bfloat16 tree)."""
    from repro_torch.models.model import init_params

    device = resolve_device(device)
    want = init_params(cfg, torch.Generator(), device="meta",
                       dtype=torch.float32)

    def conv(src, shapes, path):
        if isinstance(shapes, torch.Tensor):
            t = _tensor(src, device)
            if tuple(t.shape) != tuple(shapes.shape):
                raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                                 f"{tuple(shapes.shape)}")
            return t
        if set(src) != set(shapes):
            raise KeyError(f"{path or 'params'}: keys {sorted(src)}, "
                           f"expected {sorted(shapes)}")
        return {k: conv(src[k], shapes[k], f"{path}/{k}") for k in shapes}

    return conv(tree, want, "")


def train_state_from_numpy(state, cfg, device="cuda"):
    """The port's ``TrainState`` from the reference's as numpy leaves
    (``jax.tree.map(np.asarray, state)``; a NamedTuple or a mapping of
    step, master, m, v and ef): the same fields and trees, each tree
    checked against ``cfg``'s parameter shapes, dtypes kept (float32
    trees, an int32 step), so both packages can start from the same
    master weights."""
    from repro_torch.optim.adamw import TrainState

    device = resolve_device(device)
    f = _fields(state)
    trees = {k: None if f.get(k) is None
             else lm_params_from_numpy(f[k], cfg, device)
             for k in ("master", "m", "v", "ef")}
    step = torch.as_tensor(np.array(f["step"], np.int32), device=device)
    return TrainState(step=step, **trees)
