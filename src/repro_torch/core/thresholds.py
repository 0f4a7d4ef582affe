"""Detection-threshold model for fp32 ABFT (twin of repro.core.thresholds).

    noise(S - C) ~ eps_out * sqrt(sum O^2)
                 + eps_f32 * sqrt(K) * sqrt(sum O^2)
                 + eps_f32 * absdot

tau is that estimate times a safety factor. The model prices IEEE fp32
accumulation, which is why the port runs protected ops with TF32 off.
"""
from __future__ import annotations

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def out_eps(dtype) -> float:
    return float(torch.finfo(dtype).eps) if dtype.is_floating_point \
        else _F32_EPS


def tau_scalar_coeffs(k_dim: int, o_dtype, factor: float):
    """(a, b) of tau_scalar's affine form
    tau5 = a * sqrt(sumsq) + b * absdot + 1e-30."""
    eps = out_eps(o_dtype)
    return (factor * (eps + _F32_EPS * (float(k_dim) ** 0.5)),
            factor * _F32_EPS)


def tau_scalar(sumsq, k_dim: int, o_dtype, factor: float, absdot=None):
    """Threshold for scalar invariants (s5/s6/s7 vs c5/c6/c7); sumsq may
    be any shape (per chunk) and the result matches it."""
    a, b = tau_scalar_coeffs(k_dim, o_dtype, factor)
    scale = torch.sqrt(torch.clamp(sumsq.to(torch.float32), min=0.0))
    tau = a * scale
    if absdot is not None:
        tau = tau + b * absdot
    # absolute floor so exactly-zero chunks never flag on denormal dust
    return tau + 1e-30


def tau_weighted(tau5, n_or_m: int):
    """Threshold for index-weighted invariants: weights up to (n-1)
    amplify the rounding noise by at most the index range."""
    return tau5 * float(max(n_or_m - 1, 1))


def mismatch(c, s, tau):
    """Elementwise |c - s| > tau, NaN/Inf-safe (non-finite -> mismatch)."""
    c = c.to(torch.float32)
    s = s.to(torch.float32)
    bad = ~(torch.isfinite(c) & torch.isfinite(s))
    return bad | (torch.abs(c - s) > tau)
