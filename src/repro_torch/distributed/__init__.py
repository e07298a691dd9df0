"""One table group's rows sharded across devices, driven by one process;
the training fault stack (preemption, stragglers, restarts)."""

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
    "offload_state_sharded",
    "serving_devices",
]
