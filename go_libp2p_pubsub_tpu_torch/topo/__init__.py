"""Topology generators, publish-burst workloads and the mutable overlay (the
port's own copy of the JAX package's ``topo/``)."""

from .dynamics import (
    PAD_SLOT,
    MutationSchedule,
    ScheduleError,
    apply_mutation,
    churn_storm,
    written_edge_mask,
)
from .generators import (
    EdgeList,
    attach_latency_classes,
    build_nets,
    geo_clusters,
    link_delay_plane,
    powerlaw,
    small_world,
    to_topology,
)
from .workloads import publish_bursts

__all__ = ["PAD_SLOT", "EdgeList", "MutationSchedule", "ScheduleError", "apply_mutation",
           "attach_latency_classes", "build_nets", "churn_storm", "geo_clusters",
           "link_delay_plane", "powerlaw", "publish_bursts", "small_world", "to_topology",
           "written_edge_mask"]
