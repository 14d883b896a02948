"""Publish-burst workloads (the port's copy of the JAX package's
``topo/workloads.py``): the ``(pub_origin[R, P], pub_topic[R, P],
pub_valid[R, P])`` rows every window already takes (``driver.make_window``'s
publish rows), so attestation storms and flash crowds compose with chaos,
churn and attacks with no new engine code. Patterns (seed-deterministic):

  steady             ``base_rate`` publishes per round, uniform origins
                     and topics — the bench's historical shape.
  attestation_storm  committee waves (the ETH2 attestation cadence): a
                     quiet baseline, then every ``period`` rounds a
                     ``burst_len``-round burst at full width — the slot
                     boundary pattern that stresses slot recycling and
                     mcache turnover.
  flash_crowd        one hot topic: quiet baseline publishing across
                     all topics, then from ``onset`` every publish
                     lands on topic 0 at full width for ``duration``
                     rounds — the viral-object pattern.
"""

from __future__ import annotations

import numpy as np

PATTERNS = ("steady", "attestation_storm", "flash_crowd")


def publish_bursts(pattern: str, rounds: int, width: int, n_peers: int,
                   n_topics: int = 1, seed: int = 0, *,
                   base_rate: int = 1, period: int = 8, burst_len: int = 2,
                   onset: int | None = None, duration: int | None = None,
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build one workload's publish xs (module docstring). Returns
    ``(pub_origin, pub_topic, pub_valid)`` as [rounds, width] numpy
    arrays (-1-padded origins; all publishes valid)."""
    if pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}; one of {PATTERNS}")
    if not 0 <= base_rate <= width:
        raise ValueError(f"base_rate {base_rate} outside [0, {width}]")
    rng = np.random.default_rng(seed)
    po = np.full((rounds, width), -1, np.int32)
    pt = np.zeros((rounds, width), np.int32)
    pv = np.ones((rounds, width), bool)

    def fill(r: int, count: int, topic: int | None = None):
        count = min(count, width)
        if count <= 0:
            return
        po[r, :count] = rng.integers(0, n_peers, size=count)
        pt[r, :count] = (rng.integers(0, n_topics, size=count)
                         if topic is None else topic)

    if pattern == "steady":
        for r in range(rounds):
            fill(r, base_rate)
    elif pattern == "attestation_storm":
        for r in range(rounds):
            in_burst = period > 0 and (r % period) < burst_len
            fill(r, width if in_burst else base_rate)
    else:  # flash_crowd
        t0 = rounds // 3 if onset is None else onset
        dur = max(rounds // 4, 1) if duration is None else duration
        for r in range(rounds):
            if t0 <= r < t0 + dur:
                fill(r, width, topic=0)
            else:
                fill(r, base_rate)
    return po, pt, pv
