"""Logical-axis sharding rules over ``torch.distributed.tensor``; one
table group's rows sharded across devices, driven by one process; the
training fault stack (preemption, stragglers, restarts)."""

from .fault import PreemptionHandler, RestartSupervisor, StragglerMonitor
from .group_sharding import (
    HostShardedState,
    ShardedQueryState,
    build_group_state_per_host,
    host_row_ranges,
    merge_histograms,
    merge_shard_topk,
    offload_state_sharded,
    serving_devices,
)
from .sharding import named_sharding, shard, spec, with_rules

__all__ = [
    "HostShardedState",
    "PreemptionHandler",
    "RestartSupervisor",
    "ShardedQueryState",
    "StragglerMonitor",
    "build_group_state_per_host",
    "host_row_ranges",
    "merge_histograms",
    "merge_shard_topk",
    "named_sharding",
    "offload_state_sharded",
    "serving_devices",
    "shard",
    "spec",
    "with_rules",
]
