"""The plain reference's search: the paper's Algorithm 2 in dense form.

Plain PyTorch in float64, the semantics of the port's host oracle
(``WLSHIndex.search_dense``): per (row, table) the first level at which
the row's bucket id equals the query's after virtual rehashing
(``code // c**j``); a row is frequent at level j once at least ``mu`` of
the member's first ``beta`` tables agree; the stop level is the first at
which ``k`` frequent rows lie within ``c * r_min * c**j`` or the frequent
rows reach the budget; the answers are the ``k`` nearest frequent rows at
the stop level by exact distance.  Codes are computed here from the
reference planner's families in float64; nothing comes from the program.
Rows are processed in blocks so that the whole fits beside nothing else
on the card once the program's state is freed.

A bucket id is ``floor(u) + b_int``, worked out in int64.  The search
holds the ids at the width the deployment stores (the configuration's
``code_bits``): at 32 wrapped to int32 (two's complement, as the port's
``hash_codes_np`` stores them), at 64 kept whole through the virtual
rehash's floor divisions.  Beyond 2**53 an id is float64's ``floor(u)``
as the program's float64 host path computes it, not the real number's
(about 0.06% of ids at p = 0.5, none at p = 1 or 2).  At 64 a group's
ids take 8 bytes each (about 3.8 GB for 400,000 rows and 1,176 tables),
held one group at a time; the blocks of the level matching are sized by
their (query, row, table) comparisons, one byte each at either width.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


DTYPE = {32: torch.int32, 64: torch.int64}  # stored width -> ids' dtype
INT32 = (-(1 << 31), (1 << 31) - 1)


@dataclasses.dataclass
class RefAnswers:
    group: np.ndarray  # (Q,) int64
    stop: np.ndarray  # (Q,) int64
    n_checked: np.ndarray  # (Q,) int64
    ids: np.ndarray  # (Q, k) int64, -1 = missing
    dists: np.ndarray  # (Q, k) float64, inf = missing
    ids_counted: int = 0  # corpus bucket ids of the answered groups
    ids_outside_int32: int = 0  # of those, ids that a 32-bit store wraps


def codes(points: torch.Tensor, fam: dict, bits: int = 32,
          block: int = 65536):
    """(n, beta) bucket ids, float64: floor((W o x) a / w + b_frac)
    + b_int, as Eq. 7 with the exact split of b*; int64, or at ``bits``
    32 wrapped to int32."""
    dev = points.device
    cw = torch.as_tensor(fam["center_weight"], device=dev).double()
    proj = torch.as_tensor(fam["proj"], device=dev).double()
    b_frac = torch.as_tensor(fam["b_frac"], device=dev).double()
    b_int = torch.as_tensor(fam["b_int"], device=dev).long()
    out = torch.empty((points.shape[0], proj.shape[1]), dtype=DTYPE[bits],
                      device=dev)
    for lo in range(0, points.shape[0], block):
        x = points[lo:lo + block].double() * cw
        u = x @ proj / fam["width"] + b_frac
        out[lo:lo + block] = (torch.floor(u).long() + b_int).to(out.dtype)
    return out


def distances(points: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
              p: float) -> torch.Tensor:
    """Exact weighted l_p distances, float64, of ``points`` (m, d) to
    ``q`` (d,) under ``w`` (d,)."""
    diff = torch.abs((points.double() - q.double()) * w.double())
    if abs(p - 2.0) < 1e-9:
        return torch.sqrt(torch.sum(diff * diff, dim=-1))
    if abs(p - 1.0) < 1e-9:
        return torch.sum(diff, dim=-1)
    return torch.sum(diff**p, dim=-1) ** (1.0 / p)


def _first_frequent(codes_g, qcodes, beta, mu, n_levels, c, block):
    """(Q, n) int16: the first level at which each row is frequent for
    each query, ``n_levels + 1`` where it never is."""
    n, nq = codes_g.shape[0], qcodes.shape[0]
    lf = torch.full((nq, n), n_levels + 1, dtype=torch.int16,
                    device=codes_g.device)
    if mu > beta:
        return lf
    b0 = qcodes[:, :beta]
    for lo in range(0, n, block):
        a = codes_g[lo:lo + block, :beta]
        b = b0
        out = lf[:, lo:lo + block]
        for j in range(n_levels + 1):
            cnt = (a[None, :, :] == b[:, None, :]).sum(-1, dtype=torch.int16)
            out = torch.where((cnt >= mu) & (out > n_levels), j, out)
            a = torch.div(a, c, rounding_mode="floor")
            b = torch.div(b, c, rounding_mode="floor")
        lf[:, lo:lo + block] = out
    return lf


def answer(ref, fams, points: torch.Tensor, queries: np.ndarray,
           weight_ids: np.ndarray, k: int, code_bits: int = 32,
           block_elems: int = 1 << 28):
    """``RefAnswers`` for ``queries`` (Q, d) under ``weight_ids`` (Q,),
    with bucket ids held at ``code_bits``.

    ``points`` is the corpus on the device where the reference runs.
    """
    dev = points.device
    nq = len(queries)
    out = RefAnswers(group=ref.group_of[weight_ids].astype(np.int64),
                     stop=np.zeros(nq, np.int64),
                     n_checked=np.zeros(nq, np.int64),
                     ids=np.full((nq, k), -1, np.int64),
                     dists=np.full((nq, k), np.inf))
    budget = k + ref.budget_extra
    q_all = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    for gi in np.unique(out.group):
        sel = np.where(out.group == gi)[0]
        g = ref.groups[gi]
        codes_g = codes(points, fams[gi], 64)
        out.ids_counted += codes_g.numel()
        out.ids_outside_int32 += int(((codes_g < INT32[0])
                                      | (codes_g > INT32[1])).sum())
        codes_g = codes_g.to(DTYPE[code_bits])
        qcodes = codes(q_all[sel], fams[gi], code_bits)
        slots = ref.member_slot[weight_ids[sel]]
        for slot in np.unique(slots):
            rows_q = sel[slots == slot]
            wid = int(g.member_ids[slot])
            beta, mu = int(g.betas[slot]), int(g.mus[slot])
            n_lev, r_min = int(g.n_levels[slot]), float(g.r_min[slot])
            block = max(1, block_elems // (len(rows_q) * beta))
            lf = _first_frequent(codes_g, qcodes[slots == slot], beta, mu,
                                 n_lev, ref.c, block)
            _stop_and_top(out, rows_q, lf, points, q_all[rows_q],
                          torch.as_tensor(ref.weights[wid], device=dev),
                          r_min, n_lev, ref.c, k, budget, ref.p)
        del codes_g
    return out


def _stop_and_top(out, rows_q, lf, points, q, w, r_min, n_levels, c, k,
                  budget, p):
    """The stop rule and the top-k of the queries ``rows_q`` of one member,
    from their first-frequent levels ``lf`` (Q, n)."""
    nf_cum = torch.stack([(lf <= j).sum(1) for j in range(n_levels + 1)],
                         1).cpu().numpy()  # (Q, L+1) frequent rows a level
    # the stop level is at most the first level that fills the budget
    full = nf_cum >= budget
    j_cap = np.where(full.any(1), full.argmax(1), n_levels)
    pairs = torch.nonzero(lf <= torch.as_tensor(j_cap, device=lf.device)
                          [:, None].to(lf.dtype))  # sorted by query
    qi, row = pairs[:, 0], pairs[:, 1]
    step = 1 << 18  # pairs a block: a few GB of float64 temporaries
    d_all = np.concatenate([np.zeros(0)] + [
        distances(points[row[lo:lo + step]], q[qi[lo:lo + step]], w,
                  p).cpu().numpy() for lo in range(0, len(row), step)])
    lev_all = lf[qi, row].cpu().numpy().astype(np.int64)
    row = row.cpu().numpy()
    cuts = np.searchsorted(qi.cpu().numpy(), np.arange(len(rows_q) + 1))
    # a row is good at level j once it is frequent and d <= c * r_min * c^j
    radius = c * (r_min * (c ** np.arange(n_levels + 1)))
    for i, dst in enumerate(rows_q):
        sl = slice(cuts[i], cuts[i + 1])
        rows, lev, d = row[sl], lev_all[sl], d_all[sl]
        good = np.maximum(lev, np.searchsorted(radius, d, side="left"))
        ng_cum = np.cumsum(np.bincount(good, minlength=n_levels + 2))
        n_chk = np.minimum(nf_cum[i], budget)
        hit = (ng_cum[:n_levels + 1] >= k) | (n_chk >= budget)
        stop = int(hit.argmax()) if hit.any() else n_levels
        cand = np.where(lev <= stop)[0]
        if len(cand) > k:  # the k nearest, ties to the lower row
            kth = np.partition(d[cand], k - 1)[k - 1]
            cand = cand[d[cand] <= kth]
        top = cand[np.lexsort((rows[cand], d[cand]))][:k]
        out.stop[dst], out.n_checked[dst] = stop, int(n_chk[stop])
        out.ids[dst, :len(top)] = rows[top]
        out.dists[dst, :len(top)] = d[top]


def distances_of(points: torch.Tensor, queries: np.ndarray,
                 weights: np.ndarray, ids: np.ndarray, p: float):
    """(Q, k) exact float64 distances of the rows ``ids`` (-1 = missing,
    +inf) to each query under its own weight vector."""
    dev = points.device
    nq, k = ids.shape
    safe = torch.as_tensor(np.clip(ids, 0, points.shape[0] - 1),
                           device=dev).long()
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    w = torch.as_tensor(np.asarray(weights, np.float64), device=dev)
    d = distances(points[safe.flatten()].view(nq, k, -1), q[:, None, :],
                  w[:, None, :], p).cpu().numpy()
    return np.where((ids >= 0) & (ids < points.shape[0]), d, math.inf)
