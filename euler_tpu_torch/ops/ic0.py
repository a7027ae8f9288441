"""The incomplete-Cholesky IC(0) preconditioner (`euler_tpu/ops/ic0.py`,
apply_preconditioner main.c:580-627), as plain PyTorch ops: the plain
version of P2 (`ops/cuda/pcg_general_kernel.py`).

The E_inv recurrence and the forward and back solves couple a cell only
to its left and lower (forward) or right and upper (back) neighbours, so
the cells of one anti-diagonal x + y = d are independent given diagonal
d - 1 (d + 1 going back): Y + X - 1 dependent steps each.  The JAX
package steps a masked dense update per diagonal; here each step updates
only the diagonal's fluid cells, which is the same arithmetic cell for
cell (the other cells keep their zeros), on a plane padded by one zero
cell on every side so that every neighbour read is in range:

  E_inv:  e = a - pl^2 - pd^2 (pl, pd the left and lower E_inv), guarded
          e < 0.25 a -> (a != 0 ? a : 1), E_inv = rsqrt(e);
  fwd:    q = (r + pl ql + pd qd) E_inv, diagonals ascending;
  back:   z = (q + E_inv zr + E_inv zu) E_inv, diagonals descending.

E_inv is rebuilt from zeros for every solve, the JAX package's deliberate
departure from the reference's never-cleared global (ic0.py:12-18).

`BlockIc0` is the same three sweeps on one block of a grid cut into
("y", "x") blocks (the plain version of P6's sweeps, `parallel/
spatial_ic0.py`): the block's plane is padded as above, but its west and
south pads hold the E_inv and q of the neighbour blocks' edge column and
row, and for the back solve its east and north pads their z.  A cell's
arithmetic is then the whole grid's, operand for operand, so the blocks'
E_inv and z put together are `make_ic0_preconditioner`'s bit for bit.
"""

from __future__ import annotations

import torch


def _diagonals(fluid):
    """Padded flat indices of the fluid cells, one tensor per
    anti-diagonal d = y + x in ascending d (empty diagonals left out),
    and the padded width."""
    Y, X = fluid.shape
    W = X + 2
    ys, xs = torch.nonzero(fluid, as_tuple=True)
    d = ys + xs
    order = torch.argsort(d, stable=True)
    flat = ((ys + 1) * W + xs + 1)[order]
    counts = torch.bincount(d, minlength=Y + X - 1).tolist()
    return [g for g in torch.split(flat, counts) if g.numel()], W


def make_ic0_preconditioner(a_diag, fluid, dtype):
    """z = M^-1 r of main.c:580-627 (the JAX `make_ic0_preconditioner`):
    E_inv built here, each call one forward and one back solve."""
    Y, X = fluid.shape
    dev = fluid.device
    groups, W = _diagonals(fluid)
    a = torch.zeros(((Y + 2) * W,), dtype=dtype, device=dev)
    a.view(Y + 2, W)[1:-1, 1:-1] = a_diag.to(dtype)

    pre = torch.zeros_like(a)
    for g in groups:
        b = pre[g - 1]
        c = pre[g - W]
        ag = a[g]
        e = ag - b * b - c * c
        e = torch.where(e < 0.25 * ag, torch.where(ag != 0, ag, 1.0), e)
        pre[g] = torch.rsqrt(e)

    def apply(r):
        rp = torch.zeros_like(a)
        rp.view(Y + 2, W)[1:-1, 1:-1] = r
        q = torch.zeros_like(a)
        for g in groups:
            t = rp[g] + pre[g - 1] * q[g - 1] + pre[g - W] * q[g - W]
            q[g] = t * pre[g]
        z = torch.zeros_like(a)
        for g in reversed(groups):
            p = pre[g]
            t = q[g] + p * z[g + 1] + p * z[g + W]
            z[g] = t * p
        return z.view(Y + 2, W)[1:-1, 1:-1].clone()

    apply.e_inv = pre.view(Y + 2, W)[1:-1, 1:-1]
    return apply


class BlockIc0:
    """`make_ic0_preconditioner`'s sweeps on one block (see the top of this
    module): `build`, then per application `forward` and `back`, each run
    once the neighbours it reads have run theirs.  An edge not given (at
    the grid's edges) is zeros.  The neighbours' indices, and after the
    build their E_inv, are gathered once, not once a sweep."""

    def __init__(self, a_diag, fluid, dtype):
        Y, X = fluid.shape
        self.groups, W = _diagonals(fluid)
        self.W = W
        self.counts = [len(g) for g in self.groups]
        self.flat = (torch.cat(self.groups) if self.groups else
                     torch.zeros(0, dtype=torch.long, device=fluid.device))
        self.a = torch.zeros(((Y + 2) * W,), dtype=dtype,
                             device=fluid.device)
        self._plane(self.a)[1:-1, 1:-1] = a_diag.to(dtype)
        self.pre = torch.zeros_like(self.a)
        self.west = [g - 1 for g in self.groups]
        self.south = [g - W for g in self.groups]
        self.east = [g + 1 for g in self.groups]
        self.north = [g + W for g in self.groups]

    def _plane(self, flat):
        return flat.view(-1, self.W)

    def _split(self, flat):
        """`flat` at the fluid cells, one tensor per diagonal."""
        return flat[self.flat].split(self.counts)

    def _padded(self, interior=None, before=(None, None), after=(None, None)):
        """A zero padded plane with `interior` inside, its west and south
        pads `before` = (west [Y], south [X]) and its east and north pads
        `after` = (east, north)."""
        flat = torch.zeros_like(self.a)
        v = self._plane(flat)
        if interior is not None:
            v[1:-1, 1:-1] = interior
        for edge, at in zip(before + after, ((slice(1, -1), 0),
                                             (0, slice(1, -1)),
                                             (slice(1, -1), -1),
                                             (-1, slice(1, -1)))):
            if edge is not None:
                v[at] = edge
        return flat

    @property
    def e_inv(self):
        """The block's E_inv, [Y, X] (a view)."""
        return self._plane(self.pre)[1:-1, 1:-1]

    def build(self, west=None, south=None):
        """E_inv, from the west neighbour's last column and the south
        neighbour's last row of E_inv."""
        pre = self._padded(None, (west, south))
        for g, w, s, ag in zip(self.groups, self.west, self.south,
                               self._split(self.a)):
            b = pre[w]
            c = pre[s]
            e = ag - b * b - c * c
            e = torch.where(e < 0.25 * ag, torch.where(ag != 0, ag, 1.0), e)
            pre[g] = torch.rsqrt(e)
        self.pre = pre
        self.pre_w = [pre[w] for w in self.west]
        self.pre_s = [pre[s] for s in self.south]
        self.pre_g = list(self._split(pre))

    def forward(self, r, west=None, south=None):
        """q of L q = r, from the west and south neighbours' edges of q
        (their E_inv edges are the build's).  Returns q, [Y, X]."""
        q = self._padded(None, (west, south))
        for g, w, s, rg, pl, pd, p in zip(
                self.groups, self.west, self.south,
                self._split(self._padded(r)), self.pre_w, self.pre_s,
                self.pre_g):
            t = rg + pl * q[w] + pd * q[s]
            q[g] = t * p
        return self._plane(q)[1:-1, 1:-1].clone()

    def back(self, q, east=None, north=None):
        """z of L^T z = q, from the east and north neighbours' edges of z.
        Returns z, [Y, X]."""
        z = self._padded(None, after=(east, north))
        for g, e, n, qg, p in reversed(list(zip(
                self.groups, self.east, self.north,
                self._split(self._padded(q)), self.pre_g))):
            t = qg + p * z[e] + p * z[n]
            z[g] = t * p
        return self._plane(z)[1:-1, 1:-1].clone()
