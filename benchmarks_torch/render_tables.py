"""Render the EXPERIMENTS.md §Roofline table from experiments/dryrun/*.json.

    PYTHONPATH=src python -m benchmarks_torch.render_tables   # prints markdown

Reads the dry-run artifacts (plain JSON, one per architecture, shape and
mesh) and prints the same markdown as the JAX package's renderer.
"""

from __future__ import annotations

import glob
import json
import os

DRYRUN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments", "dryrun",
)

_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def rows(mesh: str):
    out = []
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("mesh") != mesh:
            continue
        out.append(r)
    out.sort(key=lambda r: (r.get("arch", ""),
                            _SHAPE_ORDER.index(r.get("shape", "train_4k"))
                            if r.get("shape") in _SHAPE_ORDER else 9))
    return out


def markdown(mesh: str = "single") -> str:
    lines = [
        f"**{'Single pod (16,16)=256 chips' if mesh == 'single' else 'Multi-pod (2,16,16)=512 chips'}** — terms in seconds/step; bound = argmax term; useful = MODEL_FLOPS/HLO_FLOPS.",  # noqa: E501
        "",
        "| arch | shape | GB/chip | fits | compute_s | memory_s | collective_s | bound | useful | roofline_frac |",  # noqa: E501
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows(mesh):
        arch, shape = r.get("arch", "?"), r.get("shape", "?")
        if r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | — | skip | — | — | — | — | — "
                         f"| {r['reason'][:48]} |")
            continue
        if r["status"] == "error":
            lines.append(f"| {arch} | {shape} | — | ERR | — | — | — | — | — "
                         f"| {r['error'][:48]} |")
            continue
        lines.append(
            f"| {arch} | {shape} | {r['hbm_gb']:.1f} "
            f"| {'yes' if r['fits_hbm'] else 'NO*'} "
            f"| {r['compute_s']:.2e} | {r['memory_s']:.2e} "
            f"| {r['collective_s']:.2e} | {r['bottleneck']} "
            f"| {r['useful_fraction']:.2f} | {r['roofline_fraction']:.3f} |"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown("single"))
    print()
    print(markdown("multi"))
