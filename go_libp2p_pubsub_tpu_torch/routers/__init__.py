"""routers/: the post-v1.1 protocol frontier (the port's copy of the JAX
package's ``routers/``).

Static variants layered on the per-round GossipSub step: GossipSub v1.2
IDONTWANT duplicate suppression (the libp2p gossipsub-v1.2 spec,
gossipsub.go handleIDontWant), the episub-style lazy-choke router (Topiary,
arXiv:2312.06800), and the per-edge latency ring that makes delivery order
heterogeneous enough for choking to learn from (``topo.link_delay_plane``
consumed as a delayed-commit ring).

Everything here is word and mask algebra over the existing state planes; a
build with ``router=None`` is the step without the plane, op for op, leaf
for leaf.
"""

from .choke import choke_decide, choke_guard, choke_lateness_update, choke_suppression
from .config import RouterConfig, RouterConfigError
from .idontwant import dontwant_announcements, dontwant_suppression, idontwant_sent_count
from .latency import ring_commit, ring_init, ring_keep

__all__ = [
    "RouterConfig",
    "RouterConfigError",
    "dontwant_announcements",
    "dontwant_suppression",
    "idontwant_sent_count",
    "choke_decide",
    "choke_guard",
    "choke_lateness_update",
    "choke_suppression",
    "ring_commit",
    "ring_init",
    "ring_keep",
]
