"""Topology generators (the port's own copy of the JAX package's
``topo/``)."""

from .generators import EdgeList, build_nets, powerlaw, to_topology

__all__ = ["EdgeList", "build_nets", "powerlaw", "to_topology"]
