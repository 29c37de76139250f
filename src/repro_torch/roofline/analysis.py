"""Three-term roofline: machine peaks + the compute/memory/collective
time terms.

A copy of ``repro/roofline/analysis.py`` for the port: the same
``Machine``, ``RooflineTerms``, ``terms_on``, ``extrapolate`` and
``model_flops_total``, float for float, with an H100 preset in place of
the reference's TPU chip. ``terms_from`` uses the H100 preset;
``chip_smoke.py`` reads its bounds from ``MACHINES["h100"]``.

  * ``extrapolate``: linear depth extrapolation of a cost dict measured
    at p and 2p periods: per_period = c(2p) - c(p); total(L) = c(p) +
    per_period * (L - p) / p.
  * Collective bytes are the wire (ring) estimate per device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# --- NVIDIA H100 SXM5 80GB peaks (NVIDIA H100 Tensor Core GPU data
# sheet) ---
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 dense tensor cores (no sparsity)
HBM_BW = 3.35e12              # B/s, HBM3
# NVLink 4: the data sheet's 900 GB/s is the sum of both directions over
# 18 links; a device injects half of it, 450 GB/s, in each direction,
# which is what a ring collective's wire bytes per device cross.
NVLINK_BW_BOTH_WAYS = 900e9   # B/s
ICI_BW = NVLINK_BW_BOTH_WAYS / 2  # B/s per direction


@dataclass(frozen=True)
class Machine:
    """Per-backend roofline peaks. The cpu entry is an order-of-
    magnitude reference for a few AVX2 cores (enough to classify a
    program compute- vs memory-bound; not a calibrated model of any
    particular host), the h100 entry the card the port runs on."""
    name: str
    peak_flops: float   # FLOP/s
    mem_bw: float       # B/s
    ici_bw: float       # B/s (collective injection; ~0 disables the term)


MACHINES = {
    "h100": Machine("h100", PEAK_FLOPS_BF16, HBM_BW, ICI_BW),
    "cpu": Machine("cpu", 1.0e11, 2.0e10, 1.0e9),
}


def machine_for_backend(backend: str) -> Machine:
    """Map a torch device type to its roofline Machine ("cuda" to the
    H100, anything unknown to the cpu reference)."""
    if backend.startswith("cuda"):
        return MACHINES["h100"]
    return MACHINES.get(backend, MACHINES["cpu"])


@dataclass
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    model_flops_dev: float = 0.0
    peak_flops: float = PEAK_FLOPS_BF16  # the machine the terms used

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / executed FLOPs: how much executed compute is
        useful."""
        return self.model_flops_dev / self.flops_dev if self.flops_dev else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU at the roofline bound: useful FLOPs / (bound x
        peak). =useful_fraction when compute-bound; lower when memory/
        collective-bound."""
        if self.bound <= 0:
            return 0.0
        return self.model_flops_dev / (self.bound * self.peak_flops)


def terms_from(flops_dev: float, bytes_dev: float, coll_wire_bytes_dev: float,
               model_flops_dev: float = 0.0,
               ici_bw: float = ICI_BW) -> RooflineTerms:
    """The terms on the H100 preset (``ici_bw`` overrides its NVLink
    rate)."""
    return RooflineTerms(
        t_compute=flops_dev / PEAK_FLOPS_BF16,
        t_memory=bytes_dev / HBM_BW,
        t_collective=coll_wire_bytes_dev / ici_bw,
        flops_dev=flops_dev, bytes_dev=bytes_dev,
        coll_bytes_dev=coll_wire_bytes_dev,
        model_flops_dev=model_flops_dev,
    )


def terms_on(machine: Machine, flops_dev: float, bytes_dev: float,
             coll_wire_bytes_dev: float = 0.0,
             model_flops_dev: float = 0.0) -> RooflineTerms:
    """``terms_from`` against an explicit ``Machine``."""
    return RooflineTerms(
        t_compute=flops_dev / machine.peak_flops,
        t_memory=bytes_dev / machine.mem_bw,
        t_collective=(coll_wire_bytes_dev / machine.ici_bw
                      if machine.ici_bw else 0.0),
        flops_dev=flops_dev, bytes_dev=bytes_dev,
        coll_bytes_dev=coll_wire_bytes_dev,
        model_flops_dev=model_flops_dev,
        peak_flops=machine.peak_flops,
    )


def extrapolate(c_p: Dict[str, float], c_2p: Dict[str, float], p: int,
                L: int) -> Dict[str, float]:
    """Linear depth extrapolation of a cost dict (keys -> floats)."""
    out = {}
    for k in c_p:
        per_period = c_2p.get(k, 0.0) - c_p[k]
        out[k] = c_p[k] + per_period * (L - p) / p
    return out


def model_flops_total(n_params_active: float, tokens: float,
                      kind: str) -> float:
    """6·N·D for train, 2·N·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens
