"""Topology generators and the mutable overlay (the port's own copy of the
JAX package's ``topo/``)."""

from .dynamics import (
    PAD_SLOT,
    MutationSchedule,
    ScheduleError,
    apply_mutation,
    churn_storm,
    written_edge_mask,
)
from .generators import EdgeList, build_nets, powerlaw, to_topology

__all__ = ["PAD_SLOT", "EdgeList", "MutationSchedule", "ScheduleError", "apply_mutation",
           "build_nets", "churn_storm", "powerlaw", "to_topology", "written_edge_mask"]
