"""Problem: linear operator + prox lists + diagonal preconditioners
(counterpart of ``prost_tpu/problem.py``).

``Problem.create`` validates the prox domains, fills gaps with zero proxes
and computes the preconditioners on the CPU, then moves the finished
problem to the configured device in one explicit step (``Problem.to``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ._native import host
from .common import tree_to
from .config import ProstError, device as config_device, dtype as config_dtype
from .linop.base import DualLinearOperator, LinearOperator
from .prox.base import Prox, check_domain
from .prox.standalone import ProxZero

SCALING_IDENTITY = "identity"
SCALING_ALPHA = "alpha"
SCALING_CUSTOM = "custom"


def _fill_with_zero_prox(proxs: list[Prox], n: int, name: str) -> list[Prox]:
    """Fill uncovered index ranges with ProxZero (AddZeroProx)."""
    if not proxs:
        return proxs
    try:
        gaps = host.prox_gaps([p.index for p in proxs],
                              [p.size for p in proxs], n)
    except ValueError:
        raise ProstError(f"{name}: prox operators overlap.")
    return list(proxs) + [ProxZero(index=start, size=size)
                          for start, size in gaps]


@dataclasses.dataclass(eq=False)
class Problem:
    nrows: int
    ncols: int
    linop: LinearOperator = None
    prox_g: tuple = ()
    prox_f: tuple = ()
    prox_gstar: tuple = ()
    prox_fstar: tuple = ()
    scaling_left: torch.Tensor = None   # Sigma diagonal, (nrows,)
    scaling_right: torch.Tensor = None  # Tau diagonal, (ncols,)

    # ------------------------------------------------------------------
    @staticmethod
    def create(
        linop,
        prox_g=(),
        prox_f=(),
        prox_gstar=(),
        prox_fstar=(),
        nrows=None,
        ncols=None,
        scaling: str = SCALING_ALPHA,
        scaling_alpha: float = 1.0,
        scaling_left=None,
        scaling_right=None,
        device=None,
    ) -> "Problem":
        """Validate, fill zero proxes, compute preconditioners on the CPU,
        then move to ``device`` (default: ``config.device()``)."""
        if not isinstance(linop, LinearOperator):
            linop = LinearOperator.create(linop)
        nrows = linop.nrows if nrows is None else nrows
        ncols = linop.ncols if ncols is None else ncols

        prox_g, prox_f = list(prox_g), list(prox_f)
        prox_gstar, prox_fstar = list(prox_gstar), list(prox_fstar)

        if not prox_f and not prox_fstar:
            raise ProstError("No proximal operator for f or fstar specified.")
        if not prox_g and not prox_gstar:
            raise ProstError("No proximal operator for g or gstar specified.")
        if prox_f and prox_fstar:
            raise ProstError("Prox for f AND fstar specified. Only set one!")
        if prox_g and prox_gstar:
            raise ProstError("Prox for g AND gstar specified. Only set one!")

        prox_f = _fill_with_zero_prox(prox_f, nrows, "prox_f")
        prox_g = _fill_with_zero_prox(prox_g, ncols, "prox_g")
        prox_fstar = _fill_with_zero_prox(prox_fstar, nrows, "prox_fstar")
        prox_gstar = _fill_with_zero_prox(prox_gstar, ncols, "prox_gstar")

        check_domain(prox_g, ncols, "prox_g")
        check_domain(prox_f, nrows, "prox_f")
        check_domain(prox_gstar, ncols, "prox_gstar")
        check_domain(prox_fstar, nrows, "prox_fstar")

        dt = config_dtype()
        cpu = torch.device("cpu")
        # coefficient arrays become CPU tensors of the working dtype here
        prox_g, prox_f, prox_gstar, prox_fstar = (
            [tree_to(p, cpu, dt) for p in ps]
            for ps in (prox_g, prox_f, prox_gstar, prox_fstar))

        if scaling == SCALING_ALPHA:
            # Pock-Chambolle alpha preconditioner:
            #   Sigma_jj = 1 / sum_k |K_jk|^alpha
            #   Tau_kk   = 1 / sum_j |K_jk|^(2-alpha)
            rs = linop.row_sum(scaling_alpha)
            cs = linop.col_sum(2.0 - scaling_alpha)
            one_r, one_c = torch.ones_like(rs), torch.ones_like(cs)
            left = torch.where(rs > 0, 1.0 / torch.where(rs > 0, rs, one_r),
                               one_r)
            right = torch.where(cs > 0, 1.0 / torch.where(cs > 0, cs, one_c),
                                one_c)
        elif scaling == SCALING_IDENTITY:
            left = torch.ones(nrows, dtype=dt)
            right = torch.ones(ncols, dtype=dt)
        elif scaling == SCALING_CUSTOM:
            # the user passes the *square root* diagonals; they enter squared
            left = torch.as_tensor(np.asarray(scaling_left), dtype=dt) ** 2
            right = torch.as_tensor(np.asarray(scaling_right), dtype=dt) ** 2
            if left.shape[0] != nrows or right.shape[0] != ncols:
                raise ProstError("Custom scaling vectors have wrong size.")
        else:
            raise ProstError(f"Unknown scaling '{scaling}'.")

        # average preconditioner entries where the prox can't handle
        # diagonal steps (AveragePreconditioners)
        right = _average_preconditioner(right,
                                        prox_g if prox_g else prox_gstar)
        left = _average_preconditioner(left,
                                       prox_f if prox_f else prox_fstar)

        problem = Problem(
            nrows=nrows,
            ncols=ncols,
            linop=linop,
            prox_g=tuple(prox_g),
            prox_f=tuple(prox_f),
            prox_gstar=tuple(prox_gstar),
            prox_fstar=tuple(prox_fstar),
            scaling_left=left.to(dt),
            scaling_right=right.to(dt),
        )
        return problem.to(config_device() if device is None else device)

    def to(self, device) -> "Problem":
        """Copy of the problem with every tensor on ``device``."""
        return tree_to(self, torch.device(device))

    # ------------------------------------------------------------------
    def dualize(self) -> "Problem":
        """Swap to the dual problem: g<->f*, f<->g*, K<->-K^T."""
        linop = self.linop
        dual_linop = (linop.child if isinstance(linop, DualLinearOperator)
                      else DualLinearOperator(child=linop))
        return Problem(
            nrows=self.ncols,
            ncols=self.nrows,
            linop=dual_linop,
            prox_g=self.prox_fstar,
            prox_f=self.prox_gstar,
            prox_gstar=self.prox_f,
            prox_fstar=self.prox_g,
            scaling_left=self.scaling_right,
            scaling_right=self.scaling_left,
        )

    # ------------------------------------------------------------------
    def normest(self, tol: float = 1e-6, max_iters: int = 100, seed: int = 0):
        """Power-iteration estimate of ||Sigma^{1/2} K Tau^{1/2}||_2.

        The start vector is numpy's ``RandomState(seed).rand`` like the
        JAX package's, so both pick the same step sizes.  Runs before the
        solve; the loop test reads one scalar from the device per pass."""
        rng = np.random.RandomState(seed)
        x = torch.as_tensor(rng.rand(self.ncols),
                            dtype=self.scaling_right.dtype,
                            device=self.scaling_right.device)
        sqrt_l = torch.sqrt(self.scaling_left)
        sqrt_r = torch.sqrt(self.scaling_right)
        norm = torch.zeros((), dtype=x.dtype, device=x.device)
        norm_prev = torch.full((), math.inf, dtype=x.dtype, device=x.device)
        i = 0
        while i < max_iters and bool(torch.abs(norm_prev - norm)
                                     >= tol * norm):
            ax = sqrt_l * self.linop.apply(sqrt_r * x)
            norm_ax = torch.linalg.vector_norm(ax)
            x_new = sqrt_r * self.linop.apply_adjoint(sqrt_l * ax)
            norm_x = torch.linalg.vector_norm(x_new)
            x, norm, norm_prev = x_new / norm_x, norm_x / norm_ax, norm
            i += 1
        return norm


def _average_preconditioner(precond, proxs):
    precond = precond.clone()
    for p in proxs:
        if not p.diagsteps:
            lo, hi = p.index, p.index + p.size
            precond[lo:hi] = p.average_precond(precond[lo:hi])
    return precond
