"""KATANA's own workload configs: the paper's filter dimensions.

LKF: n=6 (3-D position + velocity), m=3 (position measurements).
EKF: n=8 (constant-turn-rate with acceleration), m=4.
Batched: N=200 filters per inference call (paper Table I);
``katana_pod`` scales the filter bank to N=131,072 tracks on one card.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class KatanaConfig:
    name: str
    filter_kind: str  # "lkf" | "ekf"
    state_dim: int
    meas_dim: int
    batch: int  # N filters per inference call
    dt: float = 1.0 / 30.0  # 30 FPS camera cadence (paper Fig. 5)
    dtype: str = "float32"


LKF_SINGLE = KatanaConfig("katana-lkf", "lkf", state_dim=6, meas_dim=3, batch=1)
EKF_SINGLE = KatanaConfig("katana-ekf", "ekf", state_dim=8, meas_dim=4, batch=1)
LKF_BATCHED = KatanaConfig("katana-lkf-batched", "lkf", 6, 3, batch=200)
EKF_BATCHED = KatanaConfig("katana-ekf-batched", "ekf", 8, 4, batch=200)
# Pod-scale MOT: the whole replay bank of one card.
LKF_POD = KatanaConfig("katana-lkf-pod", "lkf", 6, 3, batch=131072)
EKF_POD = KatanaConfig("katana-ekf-pod", "ekf", 8, 4, batch=131072)

ALL = {c.name: c for c in
       (LKF_SINGLE, EKF_SINGLE, LKF_BATCHED, EKF_BATCHED, LKF_POD, EKF_POD)}
