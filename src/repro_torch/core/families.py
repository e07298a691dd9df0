"""Weighted LSH families (paper Sec. 3.1) for the l_p distance, numpy.

The C2LSH-style family used by WLSH (Eq. 7):

    h_{a,b*,W}(x)   = floor((a . (W o x) + b*) / w)
    h^l_{a,b*,W}(x) = floor(h_{a,b*,W}(x) / l),   l in {c, c^2, ...}

``a`` has i.i.d. p-stable entries, ``w`` is the bucket width (set to
r_min^{W_center} in practice), and ``b*`` is uniform on [0, f*w] with
f = c^ceil(log_c r^S_max/min) so that virtual rehashing stays valid at all
levels (Lemma 1).

Numerical-exactness note: f*w can exceed float32's integer resolution,
which would corrupt bucket ids.  ``b*/w = b_int + b_frac`` is therefore
sampled with ``b_int`` an exact int32 uniform on [0, f) and ``b_frac``
uniform on [0, 1), and

    h = b_int + floor((a . (W o x)) / w + b_frac)

equals floor((a.(W o x) + b*)/w) exactly (b_int is an integer shift of
bucket ids) while keeping every float intermediate small.  Level-l ids are
then exact integer divisions of int32 codes.

Hamming / angular weighted families (Appendix B) are provided for
completeness; the WLSH index itself targets l_p per the paper.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .pstable import sample_pstable_np

__all__ = [
    "LpFamilyParams",
    "sample_lp_family",
    "hash_codes_np",
    "sample_hamming_family",
    "hamming_codes_np",
    "sample_angular_family",
    "angular_codes_np",
]


@dataclasses.dataclass(frozen=True)
class LpFamilyParams:
    """beta sampled functions from H_{a,b*,W_center}."""

    proj: np.ndarray  # (d, beta) p-stable projection matrix
    b_int: np.ndarray  # (beta,) int32 exact part of b*/w
    b_frac: np.ndarray  # (beta,) float32 fractional part of b*/w
    width: float  # bucket width w
    p: float
    center_weight: np.ndarray  # (d,) W_center the tables were built for
    levels_cap: int  # f = c^ceil(log_c r^S_max/min)

    @property
    def beta(self) -> int:
        return self.proj.shape[1]

    @property
    def d(self) -> int:
        return self.proj.shape[0]

    def folded(self) -> dict[str, np.ndarray]:
        """Center weight + width folded into the projection (device form).

        The fold runs in float64 and casts once to float32; with the
        folded projection both data and queries hash at unit weight and
        width: codes = floor(x @ proj_folded + b_frac) + b_int.
        """
        proj = (
            self.proj.astype(np.float64)
            * self.center_weight[:, None].astype(np.float64)
            / self.width
        )
        return dict(
            proj=proj.astype(np.float32),
            b_int=self.b_int.astype(np.int32),
            b_frac=self.b_frac.astype(np.float32),
            width=np.float32(1.0),
        )


def sample_lp_family(
    d: int,
    beta: int,
    p: float,
    width: float,
    center_weight: np.ndarray,
    ratio_cap: float,
    c: float,
    seed: int = 0,
) -> LpFamilyParams:
    """Sample beta functions from H_{a,b*,W_center}.

    ``ratio_cap`` is r^{S_deg}_max/min — the largest r_max/r_min ratio over
    the weight vectors this table group must serve (Lemma 1 requires
    b* ~ U[0, c^ceil(log_c ratio_cap) * w]).
    """
    rng = np.random.default_rng(seed)
    f = int(
        round(c ** math.ceil(math.log(max(ratio_cap, 1.0 + 1e-9), c)))
    )
    f = max(f, 1)
    proj = sample_pstable_np(rng, p, (d, beta)).astype(np.float32)
    b_int = rng.integers(0, f, size=(beta,), dtype=np.int64).astype(np.int32)
    b_frac = rng.uniform(0.0, 1.0, size=(beta,)).astype(np.float32)
    return LpFamilyParams(
        proj=proj,
        b_int=b_int,
        b_frac=b_frac,
        width=float(width),
        p=p,
        center_weight=np.asarray(center_weight, dtype=np.float32),
        levels_cap=f,
    )


def hash_codes_np(points: np.ndarray, fam: LpFamilyParams) -> np.ndarray:
    """Level-1 bucket ids, (n, beta) int32, exact float64 host path."""
    x = np.asarray(points, dtype=np.float64) * fam.center_weight.astype(np.float64)
    u = x @ fam.proj.astype(np.float64) / fam.width + fam.b_frac.astype(np.float64)
    return (np.floor(u).astype(np.int64) + fam.b_int.astype(np.int64)).astype(
        np.int32
    )


# ----------------------------------------------------------------------------
# Appendix B families (Hamming / angular), host-side reference forms.
# ----------------------------------------------------------------------------


def sample_hamming_family(
    d: int, beta: int, weight: np.ndarray, seed: int = 0
) -> np.ndarray:
    """Indices k drawn with PMF w_k / sum(w); h(x) = w_k x_k (App. B)."""
    rng = np.random.default_rng(seed)
    w = np.asarray(weight, np.float64)
    return rng.choice(d, size=beta, p=w / w.sum())


def hamming_codes_np(points, ks, weight):
    """(n, beta) codes w_k x_k of the sampled indices ``ks``."""
    return np.asarray(points)[:, ks] * np.asarray(weight)[ks]


def sample_angular_family(
    d: int, beta: int, seed: int = 0
) -> np.ndarray:
    """(d, beta) standard Gaussian directions u (App. B)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d, beta))


def angular_codes_np(points, us, weight):
    """sign(u . (W o x)) in {0, 1}."""
    return (np.asarray(points) * np.asarray(weight) @ us >= 0).astype(np.int8)
