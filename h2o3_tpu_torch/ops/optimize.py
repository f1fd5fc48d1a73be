"""Optimization primitives: ADMM (L1 quadratic), Cholesky solve, L-BFGS,
coordinate descent.

Reference: h2o3_tpu/ops/optimize.py (hex/optimization/ADMM.java,
hex/optimization/L_BFGS.java, hex/glm/GLM.java fitCOD). The port keeps
its own copy of each, in float32 torch on the problem's device except
L-BFGS, whose small history lives on the host in float64 as the
reference keeps it.

A Cholesky factor of a matrix that is not positive definite is NaN, as
the reference's ``cho_factor`` returns it (``torch.linalg.cholesky``
would raise): separated or collinear designs reach this, and the NaNs
then flow into the caller's objective. The reference runs ADMM as a
device ``while_loop``; here its steps run in chunks of ``ADMM_CHUNK``
under a device-side "done" flag that freezes the state once the
reference's condition fails, with one host sync a chunk, so the iterates
are exactly the loop's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.core.job import job_update

ADMM_CHUNK = 16


def soft_threshold(x, k):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - k, 0.0)


def cho_factor(A):
    """Lower Cholesky factor of A ([P, P], or [M, P, P] factored each);
    NaN where a matrix is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def cho_solve(L, b):
    """L⁻ᵀL⁻¹b for b [P] (or [M, P] against [M, P, P] factors)."""
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def admm_l1_quadratic(A, q, l1, penalize_mask, rho: float = 1.0,
                      iters: int = 200, tol: float = 1e-6):
    """min_b ½ b'Ab - q'b + l1·|b∘mask|₁ via ADMM (ADMM.java L1Solver):
    one Cholesky of (A + ρI), then up to ``iters`` steps while the
    largest change of the sparse iterate exceeds ``tol``. Returns it.
    With ``A`` [M, P, P], ``q`` [M, P] and ``l1`` [M] it solves M
    problems at once (a batched GLM bucket), each lane freezing once its
    own condition fails."""
    P = A.shape[-1]
    dev = A.device
    L = cho_factor(A + rho * torch.eye(P, dtype=A.dtype, device=dev))
    kappa = torch.as_tensor(l1, device=dev)[..., None] / rho * penalize_mask
    z = torch.zeros(q.shape, dtype=A.dtype, device=dev)
    u = torch.zeros_like(z)
    it = torch.zeros(q.shape[:-1], dtype=torch.int32, device=dev)
    delta = torch.ones(q.shape[:-1], dtype=torch.float32, device=dev)
    tol_t = torch.tensor(tol, dtype=torch.float32, device=dev)
    for _ in range(0, iters, ADMM_CHUNK):
        for _ in range(ADMM_CHUNK):
            live = (it < iters) & (delta > tol_t)
            b_new = cho_solve(L, q + rho * (z - u))
            z_new = soft_threshold(b_new + u, kappa)
            u_new = u + b_new - z_new
            d_new = torch.abs(z_new - z).amax(-1)
            z = torch.where(live[..., None], z_new, z)
            u = torch.where(live[..., None], u_new, u)
            delta = torch.where(live, d_new, delta)
            it = it + live.to(torch.int32)
        if not bool(((it < iters) & (delta > tol_t)).any()):
            break
    return z


def cholesky_solve_regularized(XtWX, XtWz, l2, penalize_mask,
                               ridge_boost: float = 1e-6):
    """Solve (XtWX + l2·diag(mask) + ridge·I) b = XtWz: the tiny ridge
    stands in for the reference's collinear-column dropping
    (Gram.java:229)."""
    reg = l2 * penalize_mask + ridge_boost
    return cho_solve(cho_factor(XtWX + torch.diag(reg)), XtWz)


def lbfgs(value_and_grad: Callable, x0: np.ndarray, max_iter: int = 100,
          m: int = 10, gtol: float = 1e-5,
          ls_max: int = 20) -> Tuple[np.ndarray, float, int]:
    """Host-orchestrated L-BFGS (L_BFGS.java) with Armijo backtracking.

    ``value_and_grad(x)`` takes the float64 host iterate and returns
    (f, g) (tensors or numbers); the two-loop recursion runs on the host
    in float64."""
    x = np.asarray(x0, np.float64)
    f, g = value_and_grad(x)
    f, g = float(f), _host64(g)
    S, Y, rhos = [], [], []
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        job_update(0.0, f"L-BFGS iteration {n_iter}")
        if np.max(np.abs(g)) < gtol:
            break
        qd = g.copy()
        alphas = []
        for s, yv, r in zip(reversed(S), reversed(Y), reversed(rhos)):
            a = r * s.dot(qd)
            alphas.append(a)
            qd -= a * yv
        if Y:
            qd *= S[-1].dot(Y[-1]) / max(Y[-1].dot(Y[-1]), 1e-12)
        for s, yv, r, a in zip(S, Y, rhos, reversed(alphas)):
            qd += (a - r * yv.dot(qd)) * s
        d = -qd
        gd = g.dot(d)
        if gd > 0:  # not a descent direction; reset
            d, gd = -g, -g.dot(g)
            S, Y, rhos = [], [], []
        step = 1.0
        for _ in range(ls_max):
            xn = x + step * d
            fn, gn = value_and_grad(xn)
            fn = float(fn)
            if np.isfinite(fn) and fn <= f + 1e-4 * step * gd:
                break
            step *= 0.5
        else:
            break
        gn = _host64(gn)
        s, yv = xn - x, gn - g
        sy = s.dot(yv)
        if sy > 1e-10:
            S.append(s)
            Y.append(yv)
            rhos.append(1.0 / sy)
            if len(S) > m:
                S.pop(0)
                Y.pop(0)
                rhos.pop(0)
        x, f, g = xn, fn, gn
    return x, f, n_iter


def _host64(g) -> np.ndarray:
    if isinstance(g, torch.Tensor):
        g = g.detach().cpu().numpy()
    return np.asarray(g, np.float64)


def coordinate_descent_quadratic(A, q, l1, l2, penalize_mask, lower=None,
                                 upper=None, sweeps: int = 100):
    """Cyclic coordinate descent on the elastic-net quadratic

        min_b  1/2 b'Ab - q'b + l1*||m.b||_1 + l2/2*||m.b||^2
        s.t.   lower <= b <= upper          (optional box)

    (GLM.java fitCOD; with a box, the beta_constraints / non_negative
    projected update). ``sweeps`` x P serial coordinate updates in plain
    torch on A's device, a few small launches each: the soft threshold
    sign(g)·max(|g| - t, 0) is taken as g - clamp(g, -t, t), the same
    float32 value."""
    P = A.shape[0]
    dev = A.device
    Ad = torch.clamp_min(torch.diagonal(A) + l2 * penalize_mask, 1e-12)
    t = l1 * penalize_mask
    inf = torch.full((P,), torch.inf, dtype=A.dtype, device=dev)
    lo = -inf if lower is None else torch.as_tensor(lower).to(A)
    hi = inf if upper is None else torch.as_tensor(upper).to(A)
    b = torch.zeros((P,), dtype=A.dtype, device=dev)
    for _ in range(sweeps):
        for j in range(P):
            g = q[j] - torch.dot(A[j], b) + A[j, j] * b[j]
            bj = (g - torch.clamp(g, -t[j], t[j])) / Ad[j]
            b[j] = torch.clamp(bj, lo[j], hi[j])
    return b
