"""Pairwise local sequence alignment (Smith-Waterman-Gotoh).

Port of ``pydca_tpu/align.py``.  The reference delegates to Biopython
``pairwise2.align.localds`` (``pydca/sequence_backmapper/sequence_backmapper.py:219-228``),
a pure-Python O(len^2) dynamic program run against *every* MSA sequence
during the template search (``sequence_backmapper.py:231-286``).

:func:`local_align` (the single ref-vs-template alignment with its
traceback) and :func:`aligned_strings` are host copies in numpy.  The
search, :func:`batch_local_align_scores`, runs on the device it is given:
a score-only affine-gap local alignment of one reference against all N
padded templates at once, one step of plain torch ops per reference
residue, each step updating (N, W) float32 rows.  The horizontal-gap
recurrence is a running maximum (``torch.cummax``) along the template.

Gap cost model (pairwise2 ``localds`` semantics): a gap of length k costs
``open + (k-1)*extend`` (both negative).  Every score is an integer (integer
matrices and penalties) far below 2^24, so float32 holds them exactly and
the device's scores equal the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["local_align", "aligned_strings", "batch_local_align_scores"]

_NEG = -1.0e9


def local_align(
    a: np.ndarray, b: np.ndarray, submat: np.ndarray, gap_open: float, gap_extend: float
) -> Tuple[float, int, int, List[Tuple[int, int]]]:
    """Best local alignment of int-encoded sequences ``a`` and ``b``.

    Returns ``(score, a_start, b_start, path)`` where ``path`` is the list of
    per-column operations ``(da, db)`` with ``da, db in {0, 1}`` indicating
    whether the alignment column consumes a residue of ``a`` and/or ``b``
    (1,1 = match/mismatch; 1,0 = gap in b; 0,1 = gap in a), and
    ``a_start``/``b_start`` are the 0-based indices of the first aligned
    residues.
    """
    la, lb = len(a), len(b)
    H = np.zeros((la + 1, lb + 1))
    Ix = np.full((la + 1, lb + 1), _NEG)  # gap in b (vertical, consumes a)
    Iy = np.full((la + 1, lb + 1), _NEG)  # gap in a (horizontal, consumes b)
    sub = submat[np.asarray(a)[:, None], np.asarray(b)[None, :]]

    for i in range(1, la + 1):
        Ix[i, 1:] = np.maximum(H[i - 1, 1:] + gap_open, Ix[i - 1, 1:] + gap_extend)
        diag = np.maximum(np.maximum(H[i - 1, :-1], Ix[i - 1, :-1]), Iy[i - 1, :-1])
        h_row = np.maximum(0.0, diag + sub[i - 1])
        # horizontal prefix-scan: Iy[i,j] = max_k<j H[i,k] + open + (j-1-k)ext
        # H[i, j] depends on row i-1 only, so compute H first, then Iy.
        H[i, 1:] = h_row
        u = H[i, :-1] - np.arange(lb) * gap_extend
        Iy[i, 1:] = gap_open + np.arange(lb) * gap_extend + np.maximum.accumulate(u)

    score = H.max()
    i, j = np.unravel_index(np.argmax(H), H.shape)
    end_i, end_j = int(i), int(j)
    path: List[Tuple[int, int]] = []
    # traceback through H/Ix/Iy until H hits 0
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            if H[i, j] <= 0:
                break
            diag_best = max(H[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1])
            path.append((1, 1))
            if Ix[i - 1, j - 1] == diag_best and H[i - 1, j - 1] != diag_best:
                state = "Ix"
            elif (
                Iy[i - 1, j - 1] == diag_best
                and H[i - 1, j - 1] != diag_best
                and Ix[i - 1, j - 1] != diag_best
            ):
                state = "Iy"
            else:
                state = "H"
            i, j = i - 1, j - 1
        elif state == "Ix":
            path.append((1, 0))
            if Ix[i, j] == H[i - 1, j] + gap_open:
                state = "H"
            i -= 1
        else:  # Iy
            path.append((0, 1))
            if Iy[i, j] == H[i, j - 1] + gap_open:
                state = "H"
            j -= 1
    path.reverse()
    a_start, b_start = int(i), int(j)
    return float(score), a_start, b_start, path


def aligned_strings(
    a_str: str, b_str: str, a_start: int, b_start: int, path
) -> Tuple[str, str]:
    """Render the aligned middle portions of both sequences with '-' gaps."""
    ai, bi = a_start, b_start
    sa, sb = [], []
    for da, db in path:
        sa.append(a_str[ai] if da else "-")
        sb.append(b_str[bi] if db else "-")
        ai += da
        bi += db
    return "".join(sa), "".join(sb)


# ------------------------------------------------------------- batched search
def _batch_scores(ref: torch.Tensor, temps: torch.Tensor, submat_ext: torch.Tensor,
                  gap_open: float, gap_extend: float) -> torch.Tensor:
    """Best local score of ``ref`` (L_ref,) against each row of ``temps``
    (N, W), on their device: ``pydca_tpu/align.py:117-148`` (a ``lax.scan``
    over the reference) as a loop of in-place torch ops with no host sync.

    Column 0 of the three (N, W + 1) planes is the DP's j = 0 border (H 0,
    Ix and Iy NEG), so the diagonal predecessor of template position c is
    column c of their maximum, 0 at c = 0, with no shifted copy.
    """
    n, w = temps.shape
    dev, f32 = temps.device, torch.float32
    flat = temps.reshape(-1)
    ext_j = torch.arange(w, dtype=f32, device=dev) * gap_extend
    iy_off = gap_open + ext_j[:-1]  # open + (j - 1) * extend, j = 1 .. W - 1
    rows = submat_ext[ref]  # (L_ref, q + 1): the substitution row of each residue
    h_all = torch.zeros((n, w + 1), dtype=f32, device=dev)
    ix_all = torch.full((n, w + 1), _NEG, dtype=f32, device=dev)
    iy_all = torch.full((n, w + 1), _NEG, dtype=f32, device=dev)
    h, ix, iy = h_all[:, 1:], ix_all[:, 1:], iy_all[:, 1:]
    best = torch.zeros(n, dtype=f32, device=dev)
    diag = torch.empty((n, w), dtype=f32, device=dev)
    tmp = torch.empty((n, w), dtype=f32, device=dev)
    sub = torch.empty(n * w, dtype=f32, device=dev)
    cm = torch.empty((n, w), dtype=f32, device=dev)
    cm_at = torch.empty((n, w), dtype=torch.int64, device=dev)
    for i in range(ref.shape[0]):
        torch.maximum(h_all[:, :-1], ix_all[:, :-1], out=diag)
        torch.maximum(diag, iy_all[:, :-1], out=diag)
        # Ix: a gap in the template, from the previous row
        torch.add(h, gap_open, out=tmp)
        ix.add_(gap_extend).clamp_min_(tmp)
        torch.index_select(rows[i], 0, flat, out=sub)
        torch.add(diag, sub.view(n, w), out=h)
        h.clamp_min_(0.0)
        torch.maximum(best, h.amax(dim=1), out=best)
        # Iy[j] = open + (j - 1) * extend + max_{k <= j - 1} (H[k] - k * extend)
        torch.sub(h, ext_j, out=tmp)
        torch.cummax(tmp, 1, out=(cm, cm_at))
        torch.add(cm[:, :-1], iy_off, out=iy[:, 1:])
    return best


def batch_local_align_scores(
    ref,
    templates_padded,
    submat: np.ndarray,
    gap_open: float,
    gap_extend: float,
    pad_value: int,
    device="cuda",
) -> np.ndarray:
    """Score-only local alignment of ``ref`` against N padded templates.

    ``templates_padded`` is (N, W) int (numpy or torch) with ``pad_value``
    marking padding; padded positions score NEG so no optimal local path
    touches them.  Runs on ``device`` (the card unless the caller asks for
    the CPU; a CUDA request without a card raises) and returns the (N,)
    float32 scores on the host.  Replaces the reference's per-sequence
    Biopython ``localds(score_only=True)`` loop
    (``sequence_backmapper.py:261-271``).
    """
    dev = resolve_device(device)
    q = submat.shape[0]
    submat_ext = torch.full((q + 1, q + 1), _NEG, dtype=torch.float32, device=dev)
    submat_ext[:q, :q] = torch.as_tensor(np.asarray(submat, np.float32), device=dev)
    temps = torch.as_tensor(templates_padded, device=dev)
    temps = torch.where(temps == pad_value, q, temps).to(torch.int32)
    ref = torch.as_tensor(np.asarray(ref, np.int64), device=dev)
    return _batch_scores(ref, temps, submat_ext, float(gap_open), float(gap_extend)).cpu().numpy()
