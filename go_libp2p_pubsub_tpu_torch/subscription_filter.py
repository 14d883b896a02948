"""Subscription filters (reference subscription_filter.go:24-149).

A filter caps which topic subscriptions a node accepts — both its own Join
calls (pubsub.go:1164) and subscription announcements arriving in RPCs
(pubsub.go:974-981). Three shapes, same as the reference:

  AllowlistSubscriptionFilter — explicit topic set
  RegexSubscriptionFilter     — regex on topic names
  LimitSubscriptionFilter     — wrapper bounding subs-per-RPC (DoS guard,
                                subscription_filter.go:104-149)
"""

from __future__ import annotations

import re
from typing import Iterable, Protocol, Sequence


class TooManySubscriptions(ValueError):
    pass


class SubscriptionFilter(Protocol):
    def can_subscribe(self, topic: str) -> bool: ...

    def filter_incoming_subscriptions(
        self, peer: bytes, subs: Sequence[tuple[bool, str]]
    ) -> list[tuple[bool, str]]: ...


class _BaseFilter:
    def can_subscribe(self, topic: str) -> bool:
        raise NotImplementedError

    def filter_incoming_subscriptions(self, peer, subs):
        """Keep only subscriptions for topics of interest, deduplicated
        (subscription_filter.go:66-101)."""
        seen: set[tuple[bool, str]] = set()
        out: list[tuple[bool, str]] = []
        for sub, topic in subs:
            if not self.can_subscribe(topic):
                continue
            if (sub, topic) in seen:
                continue
            seen.add((sub, topic))
            out.append((sub, topic))
        return out


class AllowlistSubscriptionFilter(_BaseFilter):
    def __init__(self, topics: Iterable[str]):
        self.allow = frozenset(topics)

    def can_subscribe(self, topic: str) -> bool:
        return topic in self.allow


class RegexSubscriptionFilter(_BaseFilter):
    def __init__(self, pattern: str | re.Pattern):
        self.rx = re.compile(pattern)

    def can_subscribe(self, topic: str) -> bool:
        return bool(self.rx.match(topic))


class LimitSubscriptionFilter(_BaseFilter):
    """Wrap another filter; reject whole RPCs announcing more than `limit`
    subscriptions outright (counted before inner filtering, matching
    WrapLimitSubscriptionFilter semantics)."""

    def __init__(self, inner: SubscriptionFilter, limit: int):
        self.inner = inner
        self.limit = limit

    def can_subscribe(self, topic: str) -> bool:
        return self.inner.can_subscribe(topic)

    def filter_incoming_subscriptions(self, peer, subs):
        if len(subs) > self.limit:
            raise TooManySubscriptions(
                f"{len(subs)} subscriptions exceed limit {self.limit}"
            )
        return self.inner.filter_incoming_subscriptions(peer, subs)
