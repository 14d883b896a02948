"""Message signing and peer identity (reference sign.go:13-138).

Policies (sign.go:13-34):
  STRICT_SIGN    — outgoing messages carry from/seqno/signature; incoming
                   must verify.
  STRICT_NO_SIGN — nothing is signed; incoming messages must NOT carry
                   signature/key, and from/seqno are dropped/ignored.
  LAX_SIGN       — (legacy) sign ours, verify theirs only when present.
  LAX_NO_SIGN    — (legacy) don't sign, verify only when present.

Signature = ed25519_sign(key, b"libp2p-pubsub:" || marshal(msg)) where the
marshal excludes signature+key (sign.go:109-134). Verification recovers the
public key from the `from` peer id when it is an identity-encoded key, else
from the attached `key` field, and cross-checks that the key matches `from`
(sign.go:77-107).

Peer ids here are identity-multihash-style: 0x00 (identity code), length,
then a tiny key envelope {0x01=ed25519}||pubkey — enough to round-trip keys
through ids the way small libp2p keys do. Ids are opaque bytes to the rest
of the framework.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric import ed25519

from .pb import rpc_pb2

SIGN_PREFIX = b"libp2p-pubsub:"
_KEY_ED25519 = 0x01


class SignPolicy(enum.Enum):
    STRICT_SIGN = enum.auto()
    STRICT_NO_SIGN = enum.auto()
    LAX_SIGN = enum.auto()
    LAX_NO_SIGN = enum.auto()

    @property
    def signs(self) -> bool:
        return self in (SignPolicy.STRICT_SIGN, SignPolicy.LAX_SIGN)

    @property
    def verifies(self) -> bool:
        # strict policies enforce; lax verify opportunistically
        return self is not SignPolicy.LAX_NO_SIGN


class SignError(ValueError):
    pass


def _key_envelope(pub_bytes: bytes) -> bytes:
    return bytes([_KEY_ED25519]) + pub_bytes


def peer_id_from_pubkey(pub: ed25519.Ed25519PublicKey) -> bytes:
    raw = pub.public_bytes_raw()
    env = _key_envelope(raw)
    return bytes([0x00, len(env)]) + env


def pubkey_from_peer_id(pid: bytes) -> ed25519.Ed25519PublicKey | None:
    """Recover an identity-encoded key from a peer id; None if the id does
    not embed one (sign.go:88-95's ExtractPublicKey path)."""
    if len(pid) < 3 or pid[0] != 0x00 or pid[1] != len(pid) - 2:
        return None
    env = pid[2:]
    if env[0] != _KEY_ED25519 or len(env) != 33:
        return None
    try:
        return ed25519.Ed25519PublicKey.from_public_bytes(env[1:])
    except ValueError:
        return None


@dataclass(frozen=True)
class Identity:
    """A node's keypair + derived peer id."""

    key: ed25519.Ed25519PrivateKey
    peer_id: bytes

    @classmethod
    def generate(cls, seed: bytes | int | None = None) -> "Identity":
        if seed is None:
            key = ed25519.Ed25519PrivateKey.generate()
        else:
            if isinstance(seed, int):
                seed = seed.to_bytes(8, "big")
            seed = (seed * ((31 // len(seed)) + 1))[:32]
            key = ed25519.Ed25519PrivateKey.from_private_bytes(seed)
        return cls(key=key, peer_id=peer_id_from_pubkey(key.public_key()))


def _signable_bytes(msg: rpc_pb2.Message) -> bytes:
    clone = rpc_pb2.Message()
    clone.CopyFrom(msg)
    clone.ClearField("signature")
    clone.ClearField("key")
    return SIGN_PREFIX + clone.SerializeToString()


def sign_message(msg: rpc_pb2.Message, ident: Identity) -> None:
    """Attach a signature in place (sign.go:109-134). The `key` field is
    omitted when `from` embeds the key (small-key rule, sign.go:128-131)."""
    if getattr(msg, "from") != ident.peer_id:
        raise SignError("message.from does not match signing identity")
    msg.signature = ident.key.sign(_signable_bytes(msg))
    if pubkey_from_peer_id(ident.peer_id) is None:
        msg.key = _key_envelope(ident.key.public_key().public_bytes_raw())


def verify_message(msg: rpc_pb2.Message) -> None:
    """Raise SignError unless the signature verifies under the key bound to
    `from` (sign.go:47-107)."""
    if not msg.HasField("signature"):
        raise SignError("missing signature")
    frm = getattr(msg, "from")
    pub = pubkey_from_peer_id(frm)
    if pub is None:
        if not msg.HasField("key"):
            raise SignError("no key embedded in from and no key field")
        env = msg.key
        if not env or env[0] != _KEY_ED25519:
            raise SignError("unsupported key type")
        try:
            pub = ed25519.Ed25519PublicKey.from_public_bytes(env[1:])
        except ValueError as e:
            raise SignError("bad key bytes") from e
        if peer_id_from_pubkey(pub) != frm and frm:
            # the attached key must actually hash to `from`
            # (sign.go:96-103's id/key match check)
            raise SignError("key does not match from")
    try:
        pub.verify(msg.signature, _signable_bytes(msg))
    except InvalidSignature as e:
        raise SignError("invalid signature") from e


def check_signing_policy(policy: SignPolicy, msg: rpc_pb2.Message) -> None:
    """Ingress enforcement (pubsub.go:1092-1122): strict-sign requires a
    verifying signature; strict-no-sign rejects any signature/key presence
    (and requires absent seqno/from per the spec's anonymous mode)."""
    if policy is SignPolicy.STRICT_NO_SIGN:
        if msg.HasField("signature") or msg.HasField("key"):
            raise SignError("unexpected signature under StrictNoSign")
        if msg.HasField("seqno") or msg.HasField("from"):
            raise SignError("unexpected seqno/from under StrictNoSign")
        return
    if policy is SignPolicy.STRICT_SIGN:
        verify_message(msg)
        return
    # lax: verify only when a signature is present
    if msg.HasField("signature"):
        verify_message(msg)


# ---------------------------------------------------------------------------
# signed peer records (PX payloads)
#
# PRUNE peer exchange carries a signed peer record per suggested peer
# (pb/rpc.proto:55-57 PeerInfo.signedPeerRecord); the pruned peer validates
# the envelope before dialing — a record whose payload identity doesn't
# match the advertised peer, or whose signature doesn't verify against that
# identity's key, is discarded (pxConnect, gossipsub.go:877-895). The
# record here is the sim's envelope analogue: (peer_id, seqno) signed by
# the subject's key, with the key recoverable from the ed25519
# key-in-peer-id encoding (peer_id_from_pubkey above).

PEER_RECORD_DOMAIN = b"libp2p-peer-record:"


@dataclass(frozen=True)
class SignedPeerRecord:
    peer_id: bytes
    seqno: int
    signature: bytes


def _record_payload(peer_id: bytes, seqno: int) -> bytes:
    return PEER_RECORD_DOMAIN + peer_id + int(seqno).to_bytes(8, "big")


def make_peer_record(ident: Identity, seqno: int = 0) -> SignedPeerRecord:
    """Self-signed peer record (the certified addr-book entry the reference
    attaches in makePrune, gossipsub.go:1827-1845)."""
    return SignedPeerRecord(
        peer_id=ident.peer_id,
        seqno=seqno,
        signature=ident.key.sign(_record_payload(ident.peer_id, seqno)),
    )


def validate_peer_record(rec: "SignedPeerRecord | None",
                         expected_peer_id: bytes) -> bool:
    """The pxConnect envelope checks (gossipsub.go:877-895): the record's
    identity must match the advertised peer and the signature must verify
    against the key embedded in that identity. Returns False — discard,
    don't dial — on any mismatch or forgery."""
    if rec is None:
        return False
    if rec.peer_id != expected_peer_id:
        return False
    pub = pubkey_from_peer_id(rec.peer_id)
    if pub is None:
        return False
    try:
        pub.verify(rec.signature, _record_payload(rec.peer_id, rec.seqno))
        return True
    except InvalidSignature:
        return False
