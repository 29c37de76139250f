"""KATANA core: filters, the rewrite stages, filter bank, tracker, and the
IMM multi-model estimator.

The reference's exports, resolved on first access: ``kernels.katana_bank.ops``
imports ``core.rewrites`` and ``core.bank`` imports ``ops``, so importing
them all here would close an import cycle."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "filters": ("FilterModel", "IMMModel", "as_imm", "get_filter",
                "make_ca9_lkf", "make_ct9_lkf", "make_ctra_ekf",
                "make_cv9_lkf", "make_cv_lkf", "make_imm"),
    "rewrites": ("STAGES", "build_stage", "imm_combine", "imm_mix",
                 "imm_mode_posterior", "run_sequence", "small_det",
                 "small_inv"),
    "bank": ("BankState", "IMMBankState", "init_bank", "init_imm_bank"),
    "tracker": ("TrackerConfig", "frame_step", "imm_frame_step",
                "make_jitted_imm_tracker", "make_jitted_tracker"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
