"""Filter models: the paper's two workloads plus the IMM model set.

LKF — constant-velocity, n=6 state [px,py,pz,vx,vy,vz], m=3 position
measurements. EKF — constant-turn-rate-with-acceleration, n=8 state
[px,py,pz,v,theta,omega,a,vz], m=4 measurements [px,py,pz,theta]; the
dynamics are nonlinear, the measurement map stays linear.

The IMM model set runs K motion hypotheses per track on one shared
9-dim state [p, v, a] with the m=3 position-selector H: CV9 (constant
velocity), CA9 (Wiener-process acceleration) and CT9 (coordinated turn
at a fixed rate about z, one model per turn direction).

Every constant is a float64 numpy array built once at construction time;
the EKF's ``f`` / ``F_jac`` act on torch tensors, ``f_np`` / ``F_jac_np``
on float64 numpy vectors (the scene generator uses them).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# model -> {key: constant}, dropped with the model; see model_consts
_MODEL_CONSTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# key -> constant, for constants that belong to no model
_SHARED_CONSTS: Dict[tuple, object] = {}


def model_consts(owner) -> dict:
    """The cache of ``owner``'s constants: a dict that lives as long as
    the model ``owner`` (hashed by identity), or, for ``owner=None``, the
    constants that belong to no model (a few shapes' index tensors)."""
    if owner is None:
        return _SHARED_CONSTS
    return _MODEL_CONSTS.setdefault(owner, {})


def device_const(owner, name: str, value, dtype, device) -> torch.Tensor:
    """``value`` (an array, or a callable returning one) as a tensor of
    ``dtype`` on ``device``, made at the first call for (owner, name,
    dtype, device) and returned by every later one while ``owner``
    lives (``model_consts``). A frame then copies nothing from the host,
    which is what lets ``torch.cuda.graph`` capture it (a copy from
    pageable host memory fails under capture). The tensor is shared:
    callers never write into it."""
    cache = model_consts(owner)
    key = (name, dtype, torch.device(device))
    t = cache.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(value() if callable(value) else value),
                            dtype=dtype, device=device)
        cache[key] = t
    return t


@dataclass(frozen=True, eq=False)  # identity hash: usable as a cache key
class FilterModel:
    """A (possibly nonlinear-dynamics) filter with linear measurements."""

    name: str
    n: int  # state dim
    m: int  # measurement dim
    is_linear: bool
    F: np.ndarray  # (n,n) — LKF transition (EKF: linearization point 0)
    H: np.ndarray  # (m,n) — measurement matrix (linear for both workloads)
    Q: np.ndarray  # (n,n) process noise
    R: np.ndarray  # (m,m) measurement noise
    x0: np.ndarray  # (n,) default initial state
    P0: np.ndarray  # (n,n) default initial covariance
    dt: float = 1.0 / 30.0
    # Nonlinear dynamics (EKF): f(x)->x', jac(x)->(n,n) on tensors.
    f: Optional[Callable] = None
    F_jac: Optional[Callable] = None
    # float64 numpy mirrors (scene generation)
    f_np: Optional[Callable] = None
    F_jac_np: Optional[Callable] = None

    def predict_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Propagate the state mean (batched or not)."""
        if self.is_linear:
            return x @ device_const(self, "F", self.F, x.dtype, x.device).T
        return self.f(x)

    def jacobian(self, x: torch.Tensor) -> torch.Tensor:
        """(.., n, n) transition Jacobian at x."""
        if self.is_linear:
            F = device_const(self, "F", self.F, x.dtype, x.device)
            return F.expand(x.shape[:-1] + (self.n, self.n))
        return self.F_jac(x)


def make_cv_lkf(dt: float = 1.0 / 30.0, q: float = 1e-2, r: float = 1e-1,
                p0: float = 1.0) -> FilterModel:
    """3-D constant-velocity LKF (n=6, position measurements, WNA
    process noise)."""
    n, m = 6, 3
    F = np.eye(n)
    F[:3, 3:] = dt * np.eye(3)
    H = np.zeros((m, n))
    H[:, :3] = np.eye(3)
    G = np.zeros((n, 3))
    G[:3] = 0.5 * dt * dt * np.eye(3)
    G[3:] = dt * np.eye(3)
    Q = q * (G @ G.T) + 1e-9 * np.eye(n)
    R = r * np.eye(m)
    return FilterModel(
        name="lkf-cv6", n=n, m=m, is_linear=True, F=F, H=H, Q=Q, R=R,
        x0=np.zeros(n), P0=p0 * np.eye(n), dt=dt,
    )


def make_ctra_ekf(dt: float = 1.0 / 30.0, q: float = 1e-2, r: float = 1e-1,
                  p0: float = 1.0) -> FilterModel:
    """Constant-turn-rate + acceleration EKF (n=8): state
    [px, py, pz, v, theta, omega, a, vz], first-order discretized."""
    n, m = 8, 4

    def f(x):
        px, py, pz, v, th, om, a, vz = [x[..., i] for i in range(n)]
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack(
            [px + v * c * dt, py + v * s * dt, pz + vz * dt, v + a * dt,
             th + om * dt, om, a, vz], dim=-1)

    def F_jac(x):
        v, th = x[..., 3], x[..., 4]
        c, s = torch.cos(th), torch.sin(th)
        F = torch.eye(n, dtype=x.dtype, device=x.device).expand(
            x.shape[:-1] + (n, n)).clone()
        F[..., 0, 3] = c * dt
        F[..., 0, 4] = -v * s * dt
        F[..., 1, 3] = s * dt
        F[..., 1, 4] = v * c * dt
        F[..., 2, 7] = dt
        F[..., 3, 6] = dt
        F[..., 4, 5] = dt
        return F

    def f_np(x):
        x = np.asarray(x, np.float64)
        px, py, pz, v, th, om, a, vz = x
        c, s = np.cos(th), np.sin(th)
        return np.array(
            [px + v * c * dt, py + v * s * dt, pz + vz * dt, v + a * dt,
             th + om * dt, om, a, vz], np.float64)

    def F_jac_np(x):
        x = np.asarray(x, np.float64)
        v, th = x[3], x[4]
        c, s = np.cos(th), np.sin(th)
        F = np.eye(n)
        F[0, 3] = c * dt
        F[0, 4] = -v * s * dt
        F[1, 3] = s * dt
        F[1, 4] = v * c * dt
        F[2, 7] = dt
        F[3, 6] = dt
        F[4, 5] = dt
        return F

    H = np.zeros((m, n))
    H[0, 0] = H[1, 1] = H[2, 2] = 1.0  # position
    H[3, 4] = 1.0  # heading
    Q = q * np.eye(n)
    Q[5, 5] = Q[6, 6] = q * 0.1  # slowly-varying turn-rate / accel
    R = r * np.eye(m)
    x0 = np.zeros(n)
    x0[3] = 1.0  # unit speed so the Jacobian is non-degenerate at init
    F0 = np.eye(n)
    F0[0, 3] = dt
    F0[1, 4] = dt
    F0[2, 7] = dt
    F0[3, 6] = dt
    F0[4, 5] = dt
    return FilterModel(
        name="ekf-ctra8", n=n, m=m, is_linear=False, F=F0, H=H, Q=Q, R=R,
        x0=x0, P0=p0 * np.eye(n), dt=dt, f=f, F_jac=F_jac,
        f_np=f_np, F_jac_np=F_jac_np,
    )


IMM_STATE = ("px", "py", "pz", "vx", "vy", "vz", "ax", "ay", "az")


def _pos_selector_H(n: int) -> np.ndarray:
    H = np.zeros((3, n))
    H[:, :3] = np.eye(3)
    return H


def make_cv9_lkf(dt: float = 1.0 / 30.0, q: float = 1e-2, r: float = 1e-1,
                 p0: float = 1.0) -> FilterModel:
    """Constant velocity on the 9-dim IMM state (acceleration rows of F
    are zero)."""
    n, m = 9, 3
    F = np.zeros((n, n))
    F[:6, :6] = np.eye(6)
    F[:3, 3:6] = dt * np.eye(3)
    G = np.zeros((n, 3))
    G[:3] = 0.5 * dt * dt * np.eye(3)
    G[3:6] = dt * np.eye(3)
    Q = q * (G @ G.T) + 1e-9 * np.eye(n)
    return FilterModel(
        name="lkf-cv9", n=n, m=m, is_linear=True, F=F, H=_pos_selector_H(n),
        Q=Q, R=r * np.eye(m), x0=np.zeros(n), P0=p0 * np.eye(n), dt=dt,
    )


def make_ca9_lkf(dt: float = 1.0 / 30.0, q: float = 0.5, r: float = 1e-1,
                 p0: float = 1.0) -> FilterModel:
    """Constant (Wiener-process) acceleration on the 9-dim state, white
    jerk process noise."""
    n, m = 9, 3
    F = np.eye(n)
    F[:3, 3:6] = dt * np.eye(3)
    F[:3, 6:9] = 0.5 * dt * dt * np.eye(3)
    F[3:6, 6:9] = dt * np.eye(3)
    G = np.zeros((n, 3))
    G[:3] = (dt ** 3 / 6.0) * np.eye(3)
    G[3:6] = 0.5 * dt * dt * np.eye(3)
    G[6:9] = dt * np.eye(3)
    Q = q * (G @ G.T) + 1e-9 * np.eye(n)
    return FilterModel(
        name="lkf-ca9", n=n, m=m, is_linear=True, F=F, H=_pos_selector_H(n),
        Q=Q, R=r * np.eye(m), x0=np.zeros(n), P0=p0 * np.eye(n), dt=dt,
    )


def make_ct9_lkf(omega: float, dt: float = 1.0 / 30.0, q: float = 1e-2,
                 r: float = 1e-1, p0: float = 1.0) -> FilterModel:
    """Coordinated turn at the fixed rate ``omega`` about z on the 9-dim
    state (exact linear discretization)."""
    if omega == 0.0:
        raise ValueError("omega must be nonzero; use make_cv9_lkf for w=0")
    n, m = 9, 3
    w = omega
    s, c = np.sin(w * dt), np.cos(w * dt)
    F = np.zeros((n, n))
    F[:3, :3] = np.eye(3)
    F[0, 3], F[0, 4] = s / w, -(1 - c) / w
    F[1, 3], F[1, 4] = (1 - c) / w, s / w
    F[2, 5] = dt
    F[3, 3], F[3, 4] = c, -s
    F[4, 3], F[4, 4] = s, c
    F[5, 5] = 1.0
    G = np.zeros((n, 3))
    G[:3] = 0.5 * dt * dt * np.eye(3)
    G[3:6] = dt * np.eye(3)
    Q = q * (G @ G.T) + 1e-9 * np.eye(n)
    return FilterModel(
        name=f"lkf-ct9({omega:+.2f})", n=n, m=m, is_linear=True, F=F,
        H=_pos_selector_H(n), Q=Q, R=r * np.eye(m), x0=np.zeros(n),
        P0=p0 * np.eye(n), dt=dt,
    )


@dataclass(frozen=True, eq=False)  # identity hash: usable as a cache key
class IMMModel:
    """K filter hypotheses + the Markov mode chain. Members share (n, m)
    and H. trans[i, j] = P(mode i -> mode j), rows sum to 1; mu0 is the
    spawn mode distribution."""

    name: str
    models: Tuple[FilterModel, ...]
    trans: np.ndarray  # (K, K) row-stochastic mode transition matrix
    mu0: np.ndarray    # (K,) initial mode probabilities

    def __post_init__(self):
        K = len(self.models)
        assert K >= 1
        n, m = self.models[0].n, self.models[0].m
        for mdl in self.models:
            assert (mdl.n, mdl.m) == (n, m), "IMM models must share (n, m)"
            assert np.array_equal(mdl.H, self.models[0].H), \
                "IMM models must share H"
        assert self.trans.shape == (K, K)
        np.testing.assert_allclose(self.trans.sum(axis=1), 1.0, atol=1e-12)
        np.testing.assert_allclose(self.mu0.sum(), 1.0, atol=1e-12)

    @property
    def K(self) -> int:
        return len(self.models)

    @property
    def n(self) -> int:
        return self.models[0].n

    @property
    def m(self) -> int:
        return self.models[0].m

    @property
    def H(self) -> np.ndarray:
        return self.models[0].H

    @property
    def x0(self) -> np.ndarray:
        return self.models[0].x0

    @property
    def P0(self) -> np.ndarray:
        return self.models[0].P0

    @property
    def dt(self) -> float:
        return self.models[0].dt


def as_imm(model) -> IMMModel:
    """Wrap a single FilterModel as a degenerate K=1 IMM (identity mode
    chain)."""
    if isinstance(model, IMMModel):
        return model
    return IMMModel(name=f"imm1-{model.name}", models=(model,),
                    trans=np.ones((1, 1)), mu0=np.ones((1,)))


def make_imm(dt: float = 1.0 / 30.0, omega: float = 0.7,
             p_stay: float = 0.95, q_cv: float = 1e-2, q_ca: float = 0.5,
             r: float = 1e-1, p0: float = 1.0) -> IMMModel:
    """The default maneuvering-target IMM: CV9 + CA9 + CT9(±omega)."""
    models = (
        make_cv9_lkf(dt=dt, q=q_cv, r=r, p0=p0),
        make_ca9_lkf(dt=dt, q=q_ca, r=r, p0=p0),
        make_ct9_lkf(omega, dt=dt, r=r, p0=p0),
        make_ct9_lkf(-omega, dt=dt, r=r, p0=p0),
    )
    K = len(models)
    trans = np.full((K, K), (1.0 - p_stay) / (K - 1))
    np.fill_diagonal(trans, p_stay)
    return IMMModel(name="imm-cv-ca-ct9", models=models, trans=trans,
                    mu0=np.full((K,), 1.0 / K))


def get_filter(kind: str, dt: float = 1.0 / 30.0) -> FilterModel:
    if kind == "lkf":
        return make_cv_lkf(dt=dt)
    if kind == "ekf":
        return make_ctra_ekf(dt=dt)
    if kind == "cv9":
        return make_cv9_lkf(dt=dt)
    if kind == "ca9":
        return make_ca9_lkf(dt=dt)
    raise KeyError(f"unknown filter kind {kind!r}")
