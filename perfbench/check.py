"""The comparison that decides ``correct``.

For every checked query, the program's answer (its serving group, stop
level, ``n_checked``, top-k ids and re-ranked distances) is set beside
the plain reference's (``reference.search``).  Two numbers come out:

* ``answers_off_pct``: the share of checked queries, in percent, whose
  group, stop level, ``n_checked`` or set of k ids differs from the
  reference's: the routing, both fused passes and the top-k at once;
* ``dist_err_max``: the largest relative gap between a distance the
  program returned and the exact float64 distance of the row it named:
  the re-rank.  A row id out of range, or a non-finite distance beside a
  valid id, reads +inf.

Each is held to the upper limit of the cell's ``checks/<cell>.json``;
``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import math

import numpy as np


def compare(got: dict, ref, exact: np.ndarray) -> tuple[dict, dict]:
    """(numbers, detail) for the program's answers ``got`` (arrays
    ``group``, ``stop``, ``n_checked``, ``ids``, ``dists``, one row a
    query), the reference's ``ref`` (``search.RefAnswers``) and ``exact``,
    the reference's distances of the rows that ``got`` named."""
    nq = len(got["ids"])
    group_off = got["group"] != ref.group
    stop_off = got["stop"] != ref.stop
    chk_off = got["n_checked"] != ref.n_checked
    ids_off = np.array([set(a[a >= 0].tolist()) != set(b[b >= 0].tolist())
                        or int(np.sum(a >= 0)) != int(np.sum(b >= 0))
                        for a, b in zip(got["ids"], ref.ids)], dtype=bool)
    off = group_off | stop_off | chk_off | ids_off
    valid = got["ids"] >= 0
    d = np.asarray(got["dists"], np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(d - exact) / np.maximum(exact, 1e-30)
    rel = np.where(np.isfinite(rel), rel, math.inf)[valid]
    numbers = {"answers_off_pct": 100.0 * float(off.sum()) / max(nq, 1),
               "dist_err_max": float(rel.max()) if rel.size else 0.0}
    detail = {"checked": nq, "group_off": int(group_off.sum()),
              "stop_off": int(stop_off.sum()),
              "n_checked_off": int(chk_off.sum()),
              "ids_off": int(ids_off.sum())}
    return numbers, detail


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    names = sorted(set(numbers) | set(limits))
    table = {n: {"value": numbers.get(n), "limit": limits.get(n)}
             for n in names}
    ok = all(v["value"] is not None and v["limit"] is not None
             and v["value"] <= v["limit"] for v in table.values())
    return ok, table
