"""Protocol negotiation and custom protocol matching.

The reference maps negotiated protocol IDs to router *features* —
GossipSubFeatureMesh (speaks meshsub control: GRAFT/PRUNE/IHAVE/IWANT)
and GossipSubFeaturePX (understands prune peer-exchange) — through a
feature function (gossipsub_feat.go:11-36), and lets embedders accept
custom protocol IDs via WithProtocolMatchFn (exercised by
gossipsub_matchfn_test.go: a prefix matcher admits "/meshsub/1.1.0-beta"
as meshsub). The vectorized engine consumes the packed feature level
(`Net.protocol`: 0 = no features/floodsub, 1 = mesh, 2 = mesh+px), so a
custom protocol plugs in by declaring its feature set here — the engine
itself never changes.
"""

from __future__ import annotations

from collections.abc import Callable

FEATURE_MESH = 1  # GossipSubFeatureMesh (gossipsub_feat.go:13)
FEATURE_PX = 2    # GossipSubFeaturePX (gossipsub_feat.go:15)

# the default protocol stack (gossipsub_feat.go:22-33; GossipSubDefaultProtocols)
DEFAULT_FEATURES: dict[str, int] = {
    "/floodsub/1.0.0": 0,
    "/meshsub/1.0.0": FEATURE_MESH,
    "/meshsub/1.1.0": FEATURE_MESH | FEATURE_PX,
}


class ProtocolError(ValueError):
    pass


class ProtocolMatcher:
    """Protocol id -> feature set, with a custom-match seam.

    ``features`` extends/overrides the default table with custom protocol
    ids (an embedder's "/my-app/gossip/2.0.0" can declare MESH|PX and the
    router treats its speakers as full v1.1 peers). ``match_fn`` is the
    WithProtocolMatchFn analogue: called for ids absent from the table,
    it returns the table key the observed id matches (or None to reject)
    — e.g. a prefix matcher admitting versioned variants.
    """

    def __init__(
        self,
        features: dict[str, int] | None = None,
        match_fn: Callable[[str], str | None] | None = None,
    ) -> None:
        self.features = dict(DEFAULT_FEATURES)
        if features:
            for pid, bits in features.items():
                if (bits & FEATURE_PX) and not (bits & FEATURE_MESH):
                    raise ProtocolError(
                        f"protocol {pid!r}: PX requires the mesh feature "
                        "(a peer that can't be grafted can't be PX'd; "
                        "gossipsub_feat.go:22-33)"
                    )
                self.features[pid] = int(bits)
        self.match_fn = match_fn

    def feature_bits(self, protocol_id: str) -> int:
        if protocol_id in self.features:
            return self.features[protocol_id]
        if self.match_fn is not None:
            base = self.match_fn(protocol_id)
            if base is not None and base in self.features:
                return self.features[base]
        raise ProtocolError(
            f"unknown protocol {protocol_id!r}: not in the feature table "
            "and not accepted by the match function (WithProtocolMatchFn)"
        )

    def supports(self, protocol_id: str, feature: int) -> bool:
        """The feature-function surface (gossipsub_feat.go:11-20)."""
        return bool(self.feature_bits(protocol_id) & feature)

    def level(self, protocol_id: str) -> int:
        """The engine's packed encoding (state.Net.protocol)."""
        bits = self.feature_bits(protocol_id)
        if bits & FEATURE_PX:
            return 2
        return 1 if bits & FEATURE_MESH else 0


def prefix_match(*bases: str) -> Callable[[str], str | None]:
    """A match function admitting any id that starts with one of the base
    protocol ids — the shape gossipsub_matchfn_test.go exercises
    ("/meshsub/1.1.0-beta" negotiates as "/meshsub/1.1.0")."""

    def fn(protocol_id: str) -> str | None:
        for base in bases:
            if protocol_id.startswith(base):
                return base
        return None

    return fn
