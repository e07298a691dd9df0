"""The paper's own technique as a dry-run architecture: pod-scale WLSH
table group (1B points, SIFT-like d=128, beta=128).

beta=128 is a post-bound-relaxation table-group size (tau=500 caps groups;
relaxed Eq. 11 betas land in the tens-to-hundreds, Table 6).  The first-cut
config used beta=512 with q_batch=2048 -- both the (q, block, beta) scoring
working set (533 GB/chip measured at compile) and the Q*n*beta*L compare
work are infeasible at that point; see EXPERIMENTS.md Sec Perf for the
iteration.

Shapes map to index operations instead of LM steps:
  train_4k    -> build step (hash-encode 2^30 points)   [the Preprocess]
  prefill_32k -> query step, q_batch=64                 [the Search]
  decode_32k / long_500k -> skipped (no decode semantics for an index).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="wlsh-index",
    family="index",
    n_layers=0,
    d_model=128,  # point dimensionality
    n_heads=0,
    n_kv_heads=0,
    d_ff=128,  # beta (hash tables in the group)
    vocab=1 << 30,  # n points
)
