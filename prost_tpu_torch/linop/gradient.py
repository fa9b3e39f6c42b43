"""Gradient stencil blocks, forward differences (counterpart of
``prost_tpu/linop/gradient.py``).

Layout contract (the JAX package's, kept at every public function):

* label_first=False: flat index = y + ny*x + nx*ny*l  -> view (L, nx, ny)
* label_first=True:  flat index = l + L*y + L*ny*x    -> view (nx, ny, L)

Forward output = [gx ; gy (; gl)] halves/thirds, each of input size; gx and
gy use Neumann boundaries (zero last difference).  The 3D block's third
axis is the label axis with a Dirichlet boundary: gl_{L-1} = -u_{L-1}.
The adjoint is minus the divergence.  The preconditioner sums are the
reference's constants: gradient2d row_sum = 2, col_sum = 4; gradient3d
row_sum = 2, col_sum = 6.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import Block


def fwd_diff(u, axis):
    """Forward difference with Neumann boundary (zero at the end)."""
    d = torch.diff(u, dim=axis)
    shape = list(u.shape)
    shape[axis] = 1
    return torch.cat([d, u.new_zeros(shape)], dim=axis)


def fwd_diff_adjoint(p, axis):
    """Adjoint of fwd_diff: (D^T p)_i = p_{i-1}[i>0] - p_i[i<n-1]."""
    body = torch.narrow(p, axis, 0, p.shape[axis] - 1)
    shape = list(p.shape)
    shape[axis] = 1
    z = p.new_zeros(shape)
    lead = torch.cat([z, body], dim=axis)
    trail = torch.cat([body, z], dim=axis)
    return lead - trail


def fwd_diff_dirichlet(u, axis):
    """Forward difference with Dirichlet boundary: last entry = -u_last."""
    shape = list(u.shape)
    shape[axis] = 1
    shifted = torch.cat([torch.narrow(u, axis, 1, u.shape[axis] - 1),
                         u.new_zeros(shape)], dim=axis)
    return shifted - u


def fwd_diff_dirichlet_adjoint(p, axis):
    """Adjoint of fwd_diff_dirichlet: (D^T p)_i = p_{i-1}[i>0] - p_i."""
    shape = list(p.shape)
    shape[axis] = 1
    lead = torch.cat([p.new_zeros(shape),
                      torch.narrow(p, axis, 0, p.shape[axis] - 1)], dim=axis)
    return lead - p


@dataclasses.dataclass(eq=False)
class BlockGradient2D(Block):
    row: int
    col: int
    nx: int
    ny: int
    L: int
    label_first: bool = False

    @property
    def nrows(self):
        return 2 * self.nx * self.ny * self.L

    @property
    def ncols(self):
        return self.nx * self.ny * self.L

    def _view(self, x):
        if self.label_first:
            return x.reshape(self.nx, self.ny, self.L)
        return x.reshape(self.L, self.nx, self.ny)

    def _axes(self):
        # (x axis, y axis) in the 3D view
        return (0, 1) if self.label_first else (1, 2)

    def apply(self, x_seg):
        u = self._view(x_seg)
        ax, ay = self._axes()
        return torch.cat([fwd_diff(u, ax).reshape(-1),
                          fwd_diff(u, ay).reshape(-1)])

    def apply_adjoint(self, y_seg):
        n = self.ncols
        px = self._view(y_seg[:n])
        py = self._view(y_seg[n:])
        ax, ay = self._axes()
        return (fwd_diff_adjoint(px, ax)
                + fwd_diff_adjoint(py, ay)).reshape(-1)

    def row_sum(self, alpha: float):
        from ..config import dtype

        return torch.full((self.nrows,), 2.0, dtype=dtype())

    def col_sum(self, alpha: float):
        from ..config import dtype

        return torch.full((self.ncols,), 4.0, dtype=dtype())


@dataclasses.dataclass(eq=False)
class BlockGradient3D(Block):
    """Gradient with an additional label-direction difference (Dirichlet at
    the far label boundary)."""

    row: int
    col: int
    nx: int
    ny: int
    L: int
    label_first: bool = False

    @property
    def nrows(self):
        return 3 * self.nx * self.ny * self.L

    @property
    def ncols(self):
        return self.nx * self.ny * self.L

    def _view(self, x):
        if self.label_first:
            return x.reshape(self.nx, self.ny, self.L)
        return x.reshape(self.L, self.nx, self.ny)

    def _axes(self):
        # (x, y, label) axes in the 3D view
        return (0, 1, 2) if self.label_first else (1, 2, 0)

    def apply(self, x_seg):
        u = self._view(x_seg)
        ax, ay, al = self._axes()
        return torch.cat([fwd_diff(u, ax).reshape(-1),
                          fwd_diff(u, ay).reshape(-1),
                          fwd_diff_dirichlet(u, al).reshape(-1)])

    def apply_adjoint(self, y_seg):
        n = self.ncols
        px = self._view(y_seg[:n])
        py = self._view(y_seg[n:2 * n])
        pl = self._view(y_seg[2 * n:])
        ax, ay, al = self._axes()
        return (fwd_diff_adjoint(px, ax) + fwd_diff_adjoint(py, ay)
                + fwd_diff_dirichlet_adjoint(pl, al)).reshape(-1)

    def row_sum(self, alpha: float):
        from ..config import dtype

        return torch.full((self.nrows,), 2.0, dtype=dtype())

    def col_sum(self, alpha: float):
        from ..config import dtype

        return torch.full((self.ncols,), 6.0, dtype=dtype())
