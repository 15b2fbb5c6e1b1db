"""Linear-Gaussian Kalman filtering, batched.

Twin of ``sara_tpu/tracking/kalman.py`` (reference:
cpp/src/DO/Sara/KalmanFilter/ObservationEquation.hpp,
StateTransitionModel.hpp, DistributionConcepts.hpp). States and models are
NamedTuples of tensors; every function broadcasts over leading batch dims,
so a fleet of tracks predicts and updates as one batched program. The
model is float32 (the twin's ``jnp.eye`` is float64 under x64). The
inverses are ``inv_ex`` / ``solve_ex``, which check nothing and so never
wait for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sara_tpu_torch import resolve_device


class GaussianState(NamedTuple):
    x: torch.Tensor   # (..., n) mean
    P: torch.Tensor   # (..., n, n) covariance


class KalmanModel(NamedTuple):
    F: torch.Tensor   # (n, n) state transition
    Q: torch.Tensor   # (n, n) process noise
    H: torch.Tensor   # (m, n) observation
    R: torch.Tensor   # (m, m) observation noise


def kf_predict(state: GaussianState, model: KalmanModel) -> GaussianState:
    x = torch.einsum("ij,...j->...i", model.F, state.x)
    P = model.F @ state.P @ model.F.T + model.Q
    return GaussianState(x, P)


def kf_update(state: GaussianState, model: KalmanModel, z: torch.Tensor):
    """Returns (posterior state, innovation, innovation covariance)."""
    Hx = torch.einsum("ij,...j->...i", model.H, state.x)
    y = z - Hx
    S = model.H @ state.P @ model.H.T + model.R
    K = state.P @ model.H.T @ torch.linalg.inv_ex(S).inverse
    x = state.x + torch.einsum("...ij,...j->...i", K, y)
    n = state.x.shape[-1]
    eye = torch.eye(n, dtype=state.P.dtype, device=state.P.device)
    P = (eye - K @ model.H) @ state.P
    return GaussianState(x, P), y, S


def mahalanobis2(y: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance of innovation(s)."""
    sol = torch.linalg.solve_ex(S, y[..., None]).result[..., 0]
    return torch.sum(y * sol, dim=-1)


def constant_velocity_box_model(dt: float = 1.0, q: float = 1.0,
                                r: float = 1.0,
                                device: str | torch.device | None = None
                                ) -> KalmanModel:
    """8-state constant-velocity box model (cx, cy, w, h, vx, vy, vw, vh) —
    the standard MOT state (reference: MultipleObjectTracking observation /
    process noise models), float32 on ``device`` (None: the card)."""
    dev = resolve_device(device)
    n = 8
    f32 = dict(dtype=torch.float32, device=dev)
    F = torch.eye(n, **f32)
    F[torch.arange(4), torch.arange(4, 8)] = dt
    Q = torch.diag(torch.tensor([q, q, q, q, 4 * q, 4 * q, 4 * q, 4 * q],
                                **f32)) * dt
    H = torch.eye(4, n, **f32)
    R = torch.eye(4, **f32) * r
    return KalmanModel(F, Q, H, R)
