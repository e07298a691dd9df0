"""Serializable per-group serving plans: the core -> engine handoff.

`WLSHIndex` plans groups with host-side internals (`GroupPlan`,
`LpFamilyParams`, float64 math).  The device layers (``repro.index``,
``repro.serving``) must not reach into those; instead the planner exports a
``ServingPlan`` — a flat, numpy-only, npz-serializable description of every
table group:

  * routing:    ``group_of`` / ``member_slot`` (weight id -> group, slot)
  * per member: beta_{W_i}, effective integer mu_{W_i} (threshold reduction
                already applied), r_min^{W_i}, n_levels
  * per group:  the sampled family (raw projection + exact b* split) plus
                the *folded* form (center weight and bucket width folded
                into the projection) consumed by the sharded builder
  * optionally the host-computed bucket codes, so an engine can serve with
    bit-identical candidate sets to the host oracle (float32 re-encoding
    on device flips ~0.5% of codes at floor boundaries)

Everything downstream of this module treats the plan as the source of
truth; nothing imports `WLSHIndex` internals.  The npz layout is the JAX
package's, byte for byte, so a plan saved by either package loads in the
other with every array dtype- and bit-equal; ``ServingPlan.from_arrays``
takes the same fields as plain numpy arrays and scalars.
"""

from __future__ import annotations

import dataclasses
import json
import typing

import numpy as np

from .families import LpFamilyParams, hash_codes_np

__all__ = ["GroupServingPlan", "MemberParams", "ServingPlan"]


class MemberParams(typing.NamedTuple):
    """Resolved query-time parameters for one weight vector."""

    group: int
    slot: int
    beta: int  # beta_{W_i}: tables this member probes
    mu: int  # effective integer collision threshold
    r_min: float  # radius base r_min^{W_i}
    n_levels: int  # virtual-rehashing levels for this member


@dataclasses.dataclass(frozen=True)
class GroupServingPlan:
    """One table group, self-contained (family + per-member parameters)."""

    group_id: int
    center_id: int  # weight id of the group's center W_center
    beta_group: int  # tables materialized (max member beta)
    width: float  # bucket width w = r_min^{W_center}
    levels_cap: int  # f = c^ceil(log_c ratio_cap) (Lemma 1 b* range)
    member_ids: np.ndarray  # (m,) int64 weight ids, ascending beta
    beta_members: np.ndarray  # (m,) int32
    mu_members: np.ndarray  # (m,) int32 effective integer thresholds
    r_min_members: np.ndarray  # (m,) float64
    n_levels_members: np.ndarray  # (m,) int32
    proj: np.ndarray  # (d, beta_group) f32 raw p-stable projection
    b_int: np.ndarray  # (beta_group,) int32 exact part of b*/w
    b_frac: np.ndarray  # (beta_group,) f32 fractional part of b*/w
    center_weight: np.ndarray  # (d,) f32
    p: float
    codes: np.ndarray | None = None  # (n, beta_group) int32 host codes

    @property
    def n_members(self) -> int:
        """Number of weight vectors served by this group."""
        return len(self.member_ids)

    @property
    def n_levels_max(self) -> int:
        """Largest member level cap (the group's compiled loop bound)."""
        return int(np.max(self.n_levels_members))

    @property
    def d(self) -> int:
        """Dimensionality of the indexed points."""
        return self.proj.shape[0]

    def family(self) -> LpFamilyParams:
        """Reconstruct the sampled family (for host-exact re-encoding)."""
        return LpFamilyParams(
            proj=self.proj,
            b_int=self.b_int,
            b_frac=self.b_frac,
            width=self.width,
            p=self.p,
            center_weight=self.center_weight,
            levels_cap=self.levels_cap,
        )

    def folded(self) -> dict[str, np.ndarray]:
        """Center weight + width folded into the projection (device form,
        ``LpFamilyParams.folded``)."""
        return self.family().folded()

    def encode_host(self, points: np.ndarray) -> np.ndarray:
        """(n, beta_group) int32 bucket codes, host-exact (float64) path."""
        return hash_codes_np(np.atleast_2d(points), self.family())


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Every group of a WLSH index, plus the weight -> group routing.

    ``version`` and ``corpus_epoch`` track the plan's streaming lineage:
    a freshly exported plan is version 0 at epoch ``n``; every compaction
    of delta segments into a group state bumps ``version`` and advances
    ``corpus_epoch`` to the total number of rows ever absorbed into the
    serving corpus (base rows plus compacted inserts).  The fields ride
    through the npz round-trip, so a persisted plan records how far its
    index has drifted from the base export.
    """

    n: int  # data-set size the plan was derived for
    d: int
    p: float
    c: int
    gamma_n: float  # gamma * n (query budget = k + ceil(gamma_n))
    tau: float
    weights: np.ndarray  # (|S|, d) float64 — the weight vector set S
    group_of: np.ndarray  # (|S|,) int64
    member_slot: np.ndarray  # (|S|,) int64
    groups: tuple[GroupServingPlan, ...]
    version: int = 0  # bumped once per delta compaction
    corpus_epoch: int = 0  # total rows absorbed (0 = base export, == n)

    @property
    def n_groups(self) -> int:
        """Number of table groups in the plan."""
        return len(self.groups)

    @property
    def n_weights(self) -> int:
        """Size of the weight vector set S the plan covers."""
        return len(self.group_of)

    @property
    def beta_total(self) -> int:
        """Total hash tables materialized across all groups."""
        return int(sum(g.beta_group for g in self.groups))

    def member_params(self, weight_id: int) -> MemberParams:
        """Resolve one weight id to its (group, slot) query parameters."""
        gi = int(self.group_of[weight_id])
        slot = int(self.member_slot[weight_id])
        g = self.groups[gi]
        return MemberParams(
            group=gi,
            slot=slot,
            beta=int(g.beta_members[slot]),
            mu=int(g.mu_members[slot]),
            r_min=float(g.r_min_members[slot]),
            n_levels=int(g.n_levels_members[slot]),
        )

    def bumped(self, n_absorbed: int) -> "ServingPlan":
        """Copy of the plan after one compaction of ``n_absorbed`` rows.

        ``version`` increments by one; ``corpus_epoch`` advances by the
        absorbed row count (from ``n`` when the plan was still at its
        base export).  The group parameters themselves are untouched —
        compaction re-hashes with the original family seeds.
        """
        base = self.corpus_epoch if self.corpus_epoch else self.n
        return dataclasses.replace(
            self,
            version=self.version + 1,
            corpus_epoch=base + int(n_absorbed),
        )

    # ------------------------------------------------------------- serialize

    _META_FIELDS = ("n", "d", "p", "c", "gamma_n", "tau", "version",
                    "corpus_epoch")
    _GROUP_SCALARS = (
        "group_id", "center_id", "beta_group", "width", "levels_cap", "p",
    )
    _GROUP_ARRAYS = (
        "member_ids", "beta_members", "mu_members", "r_min_members",
        "n_levels_members", "proj", "b_int", "b_frac", "center_weight",
    )

    def save_npz(self, path: str) -> None:
        """Write the plan to ``path`` as a flat compressed npz archive.

        Arrays are stored verbatim (dtypes preserved exactly — the
        round-trip regression test pins this, it is what makes a reloaded
        plan serve bit-identically); scalars travel in an embedded JSON
        blob.  Per-group host codes are included only when present.
        """
        meta = {f: getattr(self, f) for f in self._META_FIELDS}
        meta["n_groups"] = self.n_groups
        payload: dict[str, np.ndarray] = {
            "meta_json": np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8
            ),
            "weights": self.weights,
            "group_of": self.group_of,
            "member_slot": self.member_slot,
        }
        for g in self.groups:
            pre = f"g{g.group_id}."
            for f in self._GROUP_SCALARS:
                payload[pre + f] = np.asarray(getattr(g, f))
            for f in self._GROUP_ARRAYS:
                payload[pre + f] = getattr(g, f)
            if g.codes is not None:
                payload[pre + "codes"] = g.codes
        np.savez_compressed(path, **payload)

    @classmethod
    def from_arrays(cls, fields: typing.Mapping) -> "ServingPlan":
        """Build a plan from its fields as plain numpy arrays and scalars.

        ``fields`` maps every ``ServingPlan`` field name to its value, with
        ``groups`` a sequence of mappings of ``GroupServingPlan`` field
        names.  Arrays are taken as they are (no copy, no cast), so a plan
        exported elsewhere crosses over dtype- and bit-equal.
        """
        fields = dict(fields)
        groups = tuple(
            GroupServingPlan(**{
                f.name: g[f.name]
                for f in dataclasses.fields(GroupServingPlan)
                if f.name in g
            })
            for g in fields.pop("groups")
        )
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(groups=groups,
                   **{k: v for k, v in fields.items() if k in known})

    @classmethod
    def load_npz(cls, path: str) -> "ServingPlan":
        """Rebuild a ``ServingPlan`` saved by ``save_npz``, bit-exactly."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
            groups = []
            for gi in range(int(meta.pop("n_groups"))):
                pre = f"g{gi}."
                kw = {f: z[pre + f].item() for f in cls._GROUP_SCALARS}
                kw.update({f: z[pre + f] for f in cls._GROUP_ARRAYS})
                if pre + "codes" in z.files:
                    kw["codes"] = z[pre + "codes"]
                groups.append(GroupServingPlan(**kw))
            return cls(
                n=int(meta["n"]),
                d=int(meta["d"]),
                p=float(meta["p"]),
                c=int(meta["c"]),
                gamma_n=float(meta["gamma_n"]),
                tau=float(meta["tau"]),
                weights=z["weights"],
                group_of=z["group_of"],
                member_slot=z["member_slot"],
                groups=tuple(groups),
                # absent in archives written before the streaming layer
                version=int(meta.get("version", 0)),
                corpus_epoch=int(meta.get("corpus_epoch", 0)),
            )
