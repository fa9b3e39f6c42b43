"""Conjugate-gradient least squares: min ||A x - b||^2 + shift ||x||^2
(counterpart of ``prost_tpu/backend/cgls.py``).

``apply_a`` / ``apply_at`` are arbitrary closures (the ADMM backend passes
the preconditioned operator Sigma^{1/2} K Tau^{1/2}).

The JAX package leaves its ``lax.while_loop`` on the data.  The port reads
nothing from the device inside a solve, so the loop is a fixed trip of
``maxit`` steps with every update predicated on the device ``done`` flag:
a step after convergence leaves the iterate as it was, which is exactly
where the while-loop stops.
"""

from __future__ import annotations

import torch


def cgls_solve(apply_a, apply_at, b, x0, shift, tol, maxit: int):
    """Returns (x, iterations), ``iterations`` a 0-d int32 device tensor.
    Mirrors cgls::Solve semantics: warm start from x0, stop when
    ||s|| <= tol * ||s0|| or ||x|| * tol >= 1, or at maxit.  ``tol`` is a
    float or a 0-d tensor."""
    dt = b.dtype
    eps = torch.finfo(dt).eps
    # below ~10 eps the normal-equations residual is roundoff noise and CG
    # recurrences drift; clamp so an unreachable tol can't push past that
    tol = torch.clamp(torch.as_tensor(tol, dtype=dt, device=b.device),
                      min=10.0 * eps)

    r = b - apply_a(x0)
    s = apply_at(r) - shift * x0
    p = s
    gamma = torch.sum(s * s)
    norms0 = torch.sqrt(gamma)
    x = x0
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    done = norms0 < eps
    for _ in range(int(maxit)):
        q = apply_a(p)
        delta = torch.sum(q * q) + shift * torch.sum(p * p)
        delta = torch.where(delta <= 0, torch.full_like(delta, eps), delta)
        alpha = gamma / delta
        x_n = x + alpha * p
        r_n = r - alpha * q
        s = apply_at(r_n) - shift * x_n
        gamma_n = torch.sum(s * s)
        beta = gamma_n / torch.where(gamma > 0, gamma,
                                     torch.ones_like(gamma))
        p_n = s + beta * p
        normx = torch.linalg.vector_norm(x_n)
        conv = (torch.sqrt(gamma_n) <= norms0 * tol) | (normx * tol >= 1.0)
        # every update predicated on the pre-step flag
        x = torch.where(done, x, x_n)
        r = torch.where(done, r, r_n)
        p = torch.where(done, p, p_n)
        gamma = torch.where(done, gamma, gamma_n)
        k = torch.where(done, k, k + 1)
        done = done | conv
    return x, k
