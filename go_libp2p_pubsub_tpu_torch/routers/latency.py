"""Per-edge link latency as a delayed-commit ring (the port's copy of the
JAX package's ``routers/latency.py``).

Each edge carries a static integer delay in rounds (its latency class,
normalised so the fastest class is 0, the v1.1 one-round hop:
``topo.link_delay_plane``), and the data-plane commit of a send decision
lands that many rounds later. ``inflight`` holds L pending edge-word
planes, relative-indexed: slot 0 commits this round, slot d-1 receives the
decisions with delay d.

Store-and-forward: the whole transmission resolves at send time (mesh and
fanout membership, suppression masks, the sender's one-round fwd window,
the echo exclusion) and the ring carries the resolved words. Arrivals
commit through the extra-transmission merge (``merge_extra_tx``), so the
receiver dedups against its then-current seen-cache. The ring is masked by
the recycle's keep words, so a ride on a freed slot cannot resurrect as the
slot's next message, and a dead edge drops its in-flight words.

Shapes: dense ``[N, K, L, W]`` with delay ``[N, K]``; CSR-resident
``[E, L, W]`` (``state.CSR_RESIDENT_RING_PLANES``).
"""

from __future__ import annotations

import torch


def ring_init(edge_shape: tuple, latency_rounds: int, device=None) -> torch.Tensor:
    """Zero ring from an edge word-plane shape, (N, K, W) dense or (E, W)
    flat; the L axis goes before the word axis."""
    *lead, w = edge_shape
    return torch.zeros((*lead, latency_rounds, w), dtype=torch.int32, device=device)


def ring_commit(inflight: torch.Tensor, edge_mask: torch.Tensor, delay: torch.Tensor):
    """Advance the ring one round. ``edge_mask`` [..., W] is this round's
    send decision: delay-0 edges commit now, delay d > 0 lands in slot
    d-1. Returns ``(arriving, inflight')``; ``arriving`` replaces the edge
    mask as the delivery round's effective one. The shift is the
    reference's unrolled OR over the L axis, done as one shifted copy and
    one one-hot placement: the same words."""
    l_dim = inflight.shape[-2]
    arriving = inflight[..., 0, :] | torch.where((delay == 0)[..., None], edge_mask, 0)
    slot_of = torch.arange(1, l_dim + 1, dtype=delay.dtype, device=delay.device)
    sent = torch.where((delay[..., None] == slot_of)[..., None], edge_mask[..., None, :], 0)
    shifted = torch.cat([inflight[..., 1:, :], torch.zeros_like(inflight[..., :1, :])],
                        dim=-2)
    return arriving, shifted | sent


def ring_keep(inflight: torch.Tensor, keep_words: torch.Tensor) -> torch.Tensor:
    """The recycled message slots masked out of every pending plane (the
    keep-words recycle every per-edge word plane gets)."""
    return inflight & keep_words[..., None, :]
