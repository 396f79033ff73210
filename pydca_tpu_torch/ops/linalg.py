"""Dense linear algebra for the mean-field solve.

Port of ``pydca_tpu/ops/linalg.py``.  Two routes to the inverse of the
symmetric positive-definite correlation matrix ``C``:

- the one-card engine's, :func:`spd_inverse` with neither ``chol_block``
  nor a model axis: the library's Cholesky factorisation and Cholesky
  inverse;
- the JAX package's, ``C^{-1} = W^T W`` with ``W = L^{-1}``: the
  GEMM-rich blocked Cholesky (:func:`cholesky_blocked`), the divide and
  conquer triangular inverse (:func:`tri_inv_lower`) and one SYRK
  (:func:`syrk_sharded`), on one device or on the row slabs of a mesh's
  model axis.

On a model axis of ``P`` ranks every (n, n) matrix is cut into ``P`` equal
row slabs: model rank ``k`` holds rows ``[k s, (k+1) s)``, ``s = n / P``,
of ``C``, of the factor, of ``W`` and of the result, and no rank ever
holds an (n, n) buffer.  Where JAX's GSPMD inserts the collectives behind
row-sharding constraints, here they are explicit: a rank multiplies its
own rows by a row-sharded matrix whose row blocks it receives one at a
time, each broadcast by its owner (:meth:`_Slabs.stream`), and the SYRK
reduce-scatters its (n, block) partials into the row slabs.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from ..profiling import synced_stage

__all__ = ["cholesky_blocked", "spd_inverse", "syrk_sharded", "tri_inv_lower"]

# Base-case size of the divide-and-conquer triangular inverse
# (``pydca_tpu/ops/linalg.py:36``), and the SYRK's column block.
_BASE_BLOCK = 2048


class _Slabs:
    """The row layout of an (n, n) matrix over a mesh's model axis: rank
    ``me`` holds rows ``[r0, r0 + s)``.  Without a mesh, or with a model
    axis of 1, one slab holds every row."""

    def __init__(self, n: int, mesh=None):
        self.mesh = mesh if mesh is not None and mesh.model_size > 1 else None
        self.p = 1 if self.mesh is None else mesh.model_size
        if n % self.p:
            raise ValueError(f"{n} rows do not split into {self.p} equal slabs")
        self.s = n // self.p
        self.me = 0 if self.mesh is None else mesh.model_rank
        self.r0 = self.me * self.s

    def owners(self, a: int, b: int) -> range:
        """The ranks that hold rows of ``[a, b)``."""
        return range(a // self.s, (b - 1) // self.s + 1) if b > a else range(0)

    def mine(self, a: int, b: int) -> slice:
        """This rank's rows of ``[a, b)``, as a slice of its slab."""
        lo = min(max(a, self.r0), self.r0 + self.s)
        return slice(lo - self.r0, max(min(b, self.r0 + self.s), lo) - self.r0)

    def stream(self, local, a: int, b: int, ncols: int, need: range, like: torch.Tensor,
               name: str) -> Iterator[Tuple[int, int, torch.Tensor]]:
        """``(lo, hi, rows)`` for each owner's rows ``[lo, hi)`` of ``[a,
        b)`` of a row-sharded (., ncols) matrix, in row order, to the ranks
        of ``need``; ``local(lo, hi)`` gives this rank's own.  An owner
        broadcasts its rows when a rank of ``need`` other than itself needs
        them; every rank of the axis takes part in each broadcast."""
        for k in self.owners(a, b):
            lo, hi = max(a, k * self.s), min(b, (k + 1) * self.s)
            if any(r != k for r in need):
                if k == self.me:
                    rows = local(lo, hi).contiguous()
                else:
                    rows = torch.empty((hi - lo, ncols), dtype=like.dtype, device=like.device)
                self.mesh.broadcast_(rows, k, name)
            elif k == self.me:
                rows = local(lo, hi)
            else:
                continue
            if self.me in need:
                yield lo, hi, rows

    def gather(self, local, a: int, b: int, ncols: int, need: range, like: torch.Tensor,
               name: str) -> Optional[torch.Tensor]:
        """Rows ``[a, b)`` of a row-sharded (., ncols) matrix, whole, on the
        ranks of ``need`` (``None`` elsewhere); a view of this rank's slab
        when it holds them all."""
        out = None
        for lo, hi, rows in self.stream(local, a, b, ncols, need, like, name):
            if lo == a and hi == b:
                return rows
            if out is None:
                out = torch.empty((b - a, ncols), dtype=like.dtype, device=like.device)
            out[lo - a : hi - a] = rows
        return out


def _replicated_factor(c: torch.Tensor, lay: _Slabs):
    """``(rows of L, info)``: ``cholesky_ex`` of the whole ``C``, gathered
    over the model axis when it is sharded; each rank keeps its rows."""
    if lay.mesh is None:
        return torch.linalg.cholesky_ex(c)
    full = lay.mesh.gather_rows(c, "chol_gather", axis="model")
    chol, info = torch.linalg.cholesky_ex(full)
    del full
    return chol[lay.r0 : lay.r0 + lay.s].clone(), info


def cholesky_blocked(c: torch.Tensor, block: int = 2048, mesh=None):
    """Lower Cholesky factor with the O(n^3) work in GEMMs; returns
    ``(factor, info)``, ``info`` a 0-d int32 tensor, 0 when every panel
    factorisation succeeded (``pydca_tpu/ops/linalg.py:124-167``).

    Left-looking column slabs: for each ``block``-wide panel ``k`` the
    update ``S = C[:, k:k+b] - L[:, :k] @ L[k:k+b, :k]^T``, the (b, b)
    panel factor ``L_kk`` of ``S[k:k+b]`` and the scaling ``S @
    inv(L_kk)^T`` (``inv`` by :func:`tri_inv_lower`).  Rows above the
    panel are zero in the factor; JAX computes them and masks them, here
    they are not computed.  The entries above the diagonal inside a panel
    are set to zero.

    ``mesh`` with a model axis above 1: ``c`` is this rank's row slab
    ``(s, n)`` and so is the factor.  Rows ``k:k+b`` of the factor and of
    ``S`` are broadcast by the ranks that hold them to the ranks that hold
    rows at or below the panel; each of those factors the (b, b) panel,
    the one replicated piece, and its ``info`` counts on that rank only
    (sum it over the model axis).
    """
    n = c.shape[1]
    lay = _Slabs(n, mesh)
    if n <= block:
        return _replicated_factor(c, lay)
    fac = torch.zeros_like(c)
    info = torch.zeros((), dtype=torch.int32, device=c.device)
    for k in range(0, n, block):
        b = min(block, n - k)
        need = lay.owners(k, n)
        rows = lay.mine(k, n)
        o0 = lay.r0 + rows.start  # global index of this rank's first row at or below k
        s = c[rows, k : k + b].clone()
        if k:
            for lo, hi, lk in lay.stream(lambda lo, hi: fac[lo - lay.r0 : hi - lay.r0, :k],
                                         k, k + b, k, need, c, "chol_rows_bcast"):
                s[:, lo - k : hi - k] -= fac[rows, :k] @ lk.mT
        panel = lay.gather(lambda lo, hi: s[lo - o0 : hi - o0], k, k + b, b, need, c,
                           "chol_panel_bcast")
        if panel is None:  # this rank holds no row at or below the panel
            continue
        lkk, ok = torch.linalg.cholesky_ex(panel)
        info += (ok != 0).to(torch.int32)
        linv_t = tri_inv_lower(lkk).mT
        # rows k:k+b of s are L_kk L_kk^T, so s @ linv_t restores L_kk there
        fac[rows, k : k + b] = torch.tril(s @ linv_t, diagonal=o0 - k)
    return fac, info


def _split(n: int) -> int:
    """The lane-aligned midpoint of an n-row block (``pydca_tpu/ops/linalg.py:185``)."""
    return min(max(((n // 2) + 127) // 128 * 128, 128), n - 128)


def _tri_inv_into(m: torch.Tensor, w: torch.Tensor, a: int, b: int, block: int,
                  lay: _Slabs) -> None:
    """Write the inverse of ``m[a:b, a:b]`` into ``w[a:b, a:b]`` (global
    rows; this rank's rows of both)."""
    n = b - a
    need = lay.owners(a, b)
    out = lay.mine(a, b)
    if n <= block or n < 256:
        # n < 256 cannot produce a valid lane-aligned split: solve directly
        mab = lay.gather(lambda lo, hi: m[lo - lay.r0 : hi - lay.r0, a:b], a, b, n, need, m,
                         "tri_inv_base_bcast")
        if mab is not None:
            eye = torch.eye(n, dtype=m.dtype, device=m.device)
            inv = torch.linalg.solve_triangular(mab, eye, upper=False)
            w[out, a:b] = inv[lay.r0 + out.start - a : lay.r0 + out.stop - a]
        return
    k = _split(n)
    _tri_inv_into(m, w, a, a + k, block, lay)
    _tri_inv_into(m, w, a + k, b, block, lay)
    # [A 0; B C]^{-1} = [A^{-1} 0; -C^{-1} B A^{-1}, C^{-1}]: rows a+k:b
    need = lay.owners(a + k, b)
    out = lay.mine(a + k, b)
    o0 = lay.r0 + out.start
    t = None  # B A^{-1}, this rank's rows
    for lo, hi, rows in lay.stream(lambda lo, hi: w[lo - lay.r0 : hi - lay.r0, a : a + k],
                                   a, a + k, k, need, m, "tri_inv_bcast"):
        prod = m[out, lo:hi] @ rows
        t = prod if t is None else t.add_(prod)
    acc = None  # C^{-1} (B A^{-1})
    for lo, hi, rows in lay.stream(lambda lo, hi: t[lo - o0 : hi - o0], a + k, b, k, need, m,
                                   "tri_inv_bcast"):
        prod = w[out, lo:hi] @ rows
        acc = prod if acc is None else acc.add_(prod)
    if acc is not None:
        w[out, a : a + k] = acc.neg_()


def tri_inv_lower(m: torch.Tensor, block: int = _BASE_BLOCK, mesh=None) -> torch.Tensor:
    """Inverse of a lower-triangular matrix by divide and conquer
    (``pydca_tpu/ops/linalg.py:170-191``): split at a lane-aligned
    midpoint ``k``, invert the two diagonal blocks, then
    ``-C^{-1} (B A^{-1})``; blocks of at most ``block`` rows (or under
    256) are solved directly.

    ``mesh`` with a model axis above 1: ``m`` is this rank's row slab and
    so is the result.  Each rank writes its own rows of every block: the
    two products stream the rows of ``A^{-1}`` and then of ``B A^{-1}``
    from the ranks that hold them, and a diagonal block that spans ranks
    is gathered to each of them and solved there.
    """
    lay = _Slabs(m.shape[1], mesh)
    w = torch.zeros_like(m)
    _tri_inv_into(m, w, 0, m.shape[1], block, lay)
    return w


def syrk_sharded(w: torch.Tensor, block: int = _BASE_BLOCK, mesh=None) -> torch.Tensor:
    """``W^T @ W`` for square ``W`` (``pydca_tpu/ops/linalg.py:77-121``).

    ``mesh`` with a model axis above 1: ``w`` is this rank's row slab and
    so is the result.  For each ``block``-wide column block of the result
    the rank's (n, block) partial ``W_r^T W_r[:, cols]`` is reduce-scattered
    into the row slabs; the last block is clamped to end at n (the overlap
    recomputes the same values).
    """
    lay = _Slabs(w.shape[1], mesh)
    if lay.mesh is None:
        return w.mT @ w
    n = w.shape[1]
    blk = min(block, n)
    out = torch.empty_like(w)
    for i in range(-(-n // blk)):
        start = min(i * blk, n - blk)
        part = w.mT @ w[:, start : start + blk]
        out[:, start : start + blk] = lay.mesh.reduce_scatter_rows(part, "syrk_reduce_scatter")
    return out


def _symmetrise(x: torch.Tensor, lay: _Slabs, block: int = _BASE_BLOCK) -> torch.Tensor:
    """``(x + x^T) / 2``; on a model axis, the transpose's row slab comes
    from an all-to-all of ``block`` rows at a time (rank k sends rank j the
    transpose of its rows' columns ``[j s, (j+1) s)``)."""
    if lay.mesh is None:
        return (x + x.mT).mul_(0.5)
    out = torch.empty_like(x)
    s = lay.s
    for i0 in range(0, s, block):
        i1 = min(i0 + block, s)
        got = lay.mesh.all_to_all_rows(x[i0:i1].mT, "sym_all_to_all").view(lay.p, s, i1 - i0)
        for k in range(lay.p):
            cols = slice(k * s + i0, k * s + i1)
            out[:, cols] = (x[:, cols] + got[k]).mul_(0.5)
    return out


def spd_inverse(c: torch.Tensor, block: int = _BASE_BLOCK, chol_block: Optional[int] = None,
                mesh=None, timers=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of a symmetric positive-definite matrix, and the factor's ``info``.

    With neither ``chol_block`` nor a model axis above 1 (the one-card
    engine): ``C = L L^T`` by ``torch.linalg.cholesky_ex``, ``C^{-1}`` by
    ``torch.cholesky_inverse``, then symmetrised as
    ``pydca_tpu/ops/linalg.py:216`` does.

    Otherwise the JAX package's ``spd_inverse(c, block, chol_block)``
    (``pydca_tpu/ops/linalg.py:194-216``): the factor by
    :func:`cholesky_blocked` when ``chol_block`` is set and below n, else
    by ``cholesky_ex`` (of the whole C, gathered over the model axis),
    then ``W = L^{-1}`` by :func:`tri_inv_lower`, ``W^T W`` by
    :func:`syrk_sharded`, symmetrised; ``block`` is the triangular
    inverse's base block and the SYRK's and the symmetrisation's column
    block (JAX's SYRK keeps its own default of 2048, which ``block``
    defaults to).  With ``mesh`` (a model axis above
    1) ``c`` is this rank's row slab (n / P, n) and so is the result.
    ``timers`` (a :class:`~pydca_tpu_torch.profiling.StageTimers`) times the
    stages ``cholesky``, ``tri_inv`` and ``syrk``, each ended by a device
    synchronise.

    Returns ``(inverse, info)``: ``info`` is a 0-d int32 tensor on
    ``c.device``, 0 when the factorisation succeeded (on a model axis, this
    rank's count of failed panels: sum it over the axis).  A failed
    factorisation raises nothing; the caller reads ``info`` (with its other
    results, in one fetch) and then discards the inverse.
    """
    lay = _Slabs(c.shape[1], mesh)
    if chol_block is None and lay.mesh is None:
        chol, info = torch.linalg.cholesky_ex(c)
        # A failed factor may hold a zero pivot, on which cholesky_inverse
        # raises on the CPU; set its diagonal to ones (O(D), no host sync) so
        # the call completes and returns the garbage the caller discards.
        diag = chol.diagonal()
        diag.copy_(torch.where(info == 0, diag, torch.ones_like(diag)))
        inv = torch.cholesky_inverse(chol)
        del chol
        # symmetrise: removes accumulation-order asymmetry
        return (inv + inv.mT).mul_(0.5), info
    with synced_stage(timers, "cholesky", c.device):
        if chol_block is not None and c.shape[1] > chol_block:
            chol, info = cholesky_blocked(c, chol_block, mesh)
        else:
            chol, info = _replicated_factor(c, lay)
    with synced_stage(timers, "tri_inv", c.device):
        w = tri_inv_lower(chol, block, mesh)
        del chol
    with synced_stage(timers, "syrk", c.device):
        inv = syrk_sharded(w, block, mesh)
        del w
        inv = _symmetrise(inv, lay, block)
    return inv, info
