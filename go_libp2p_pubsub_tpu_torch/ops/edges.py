"""Edge-permutation gathers and topic-bit packing.

Every cross-peer read of the protocol has the shape "receiver j reads the
sender's per-edge outbox at [nbr[j,k], rev[j,k]]". (n,k) -> (nbr, rev) is
an involution of the N*K edge-slot space, so such a read is one flat row
gather through ``perm = nbr*K + rev``; on a banded-regular topology it is K
static rolls.

Topic-slot payloads ([N,S,K] per-slot bools) cross an edge packed into
topic-id bit positions of 32-bit words and are re-extracted at the
receiver's own slot->topic mapping, so only topic ids cross the wire.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitset import to_word

WORD = 32


def n_topic_words(n_topics: int) -> int:
    return (n_topics + WORD - 1) // WORD


def build_edge_perm(nbr: np.ndarray, rev: np.ndarray,
                    nbr_ok: np.ndarray) -> np.ndarray:
    """[N,K] i32 flat index into the edge-slot space; self-pointing where
    no edge exists (callers mask with nbr_ok)."""
    n, k = nbr.shape
    own = np.arange(n * k, dtype=np.int32).reshape(n, k)
    perm = np.clip(nbr, 0, None).astype(np.int32) * k + rev.astype(np.int32)
    return np.where(nbr_ok, perm, own)


def detect_banded(nbr: np.ndarray, rev: np.ndarray, nbr_ok: np.ndarray):
    """(offsets, rev_slots) when the topology is banded-regular: every edge
    present, slot k of every node holding ring offset off[k] with a constant
    reverse slot; None otherwise."""
    n, k = nbr.shape
    if k == 0 or not nbr_ok.all():
        return None
    off = (nbr.astype(np.int64) - np.arange(n)[:, None]) % n
    if not (off == off[0]).all() or not (rev == rev[0]).all():
        return None
    return tuple(int(o) for o in off[0]), tuple(int(r) for r in rev[0])


def involution_wf(nbr: torch.Tensor, rev: torch.Tensor, nbr_ok: torch.Tensor,
                  edge_perm: torch.Tensor, ar: torch.Tensor | None = None) -> torch.Tensor:
    """0-d bool tensor: the (nbr, rev, nbr_ok, edge_perm) planes form a
    well-formed capacity-bounded edge pool, the contract ``build_edge_perm``
    and ``ops/csr.build_csr`` establish and the dynamic overlay
    (``topo/dynamics.py``) must keep under every mutation batch:

      * edge_perm is a self-inverse permutation of [0, N*K);
      * absent slots self-point;
      * present slots agree with their partner: partner present, the
        partner's nbr points back, perm == nbr*K + rev, no self-edges,
        nbr and rev in range.

    Device ops only (no host read), so it runs inside a captured window.
    ``edge_perm`` may be int32 (the state's ``TopoState`` leaf) or int64
    (``Net.edge_perm``): the arithmetic is int64, so both give one verdict.
    ``ar`` is an int64 ``arange(N*K)`` built beforehand (made here when
    None)."""
    n, k = nbr.shape
    e = n * k
    if ar is None:
        ar = torch.arange(e, dtype=torch.int64, device=nbr.device)
    pf = edge_perm.reshape(e).long()
    okf = nbr_ok.reshape(e)
    nbrf = nbr.reshape(e).long()
    revf = rev.reshape(e).long()
    in_range = ((pf >= 0) & (pf < e)).all()
    ps = pf.clamp(0, max(e - 1, 0))
    invol = (pf[ps] == ar).all()
    absent_self = (okf | (pf == ar)).all()
    partner_ok = (~okf | okf[ps]).all()
    owner = ar // k
    back = (~okf | (nbrf[ps] == owner)).all()
    agree = (~okf | (pf == nbrf * k + revf)).all()
    no_self = (~okf | (nbrf != owner)).all()
    bounds = (~okf | ((nbrf >= 0) & (nbrf < n) & (revf >= 0) & (revf < k))).all()
    return in_range & invol & absent_self & partner_ok & back & agree & no_self & bounds


def edge_permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x[N, K, ...] -> x[nbr[j,k], rev[j,k], ...] as a flat row gather."""
    n, k = perm.shape
    flat = x.reshape((n * k,) + tuple(x.shape[2:]))
    return flat[perm.reshape(-1)].reshape(x.shape)


def edge_permute_banded(x: torch.Tensor, off: tuple, rev: tuple) -> torch.Tensor:
    """Banded-regular edge_permute: out[j,k] = x[(j+off[k]) % N, rev[k]]."""
    cols = [torch.roll(x[:, r], -o, dims=0) for o, r in zip(off, rev)]
    return torch.stack(cols, dim=1)


def peer_gather_banded(v: torch.Tensor, off: tuple) -> torch.Tensor:
    """Banded-regular v[nbr]: out[j,k] = v[(j+off[k]) % N]."""
    return torch.stack([torch.roll(v, -o, dims=0) for o in off], dim=1)


def topic_pack(x: torch.Tensor, my_topics: torch.Tensor,
               n_topics: int) -> torch.Tensor:
    """x[N,S,K] bool -> [N,K,Wt] int32 words with bit t set on edge k iff
    the sender's slot for topic t has x true."""
    wt = n_topic_words(n_topics)
    t = my_topics
    tc = t.clamp(min=0)
    live = (t >= 0)[:, :, None]
    shift = (tc % WORD).to(torch.int64)[:, :, None]
    val = torch.where(x & live, torch.ones_like(shift) << shift, 0)  # [N,S,K]
    words = []
    for w in range(wt):
        in_word = ((tc // WORD) == w)[:, :, None]
        contrib = torch.where(in_word, val, 0)
        acc = contrib[:, 0]
        for s in range(1, contrib.shape[1]):
            acc = acc | contrib[:, s]
        words.append(to_word(acc))
    return torch.stack(words, dim=-1)


def topic_unpack(words: torch.Tensor, my_topics: torch.Tensor) -> torch.Tensor:
    """[N,K,Wt] int32 -> [N,S,K] bool at the receiver's slot->topic map."""
    t = my_topics
    tc = t.clamp(min=0)
    shift = (tc % WORD).to(torch.int32)[:, :, None]
    out = torch.zeros(tuple(t.shape) + (words.shape[1],), dtype=torch.int32,
                      device=words.device)
    for w in range(words.shape[-1]):
        sel = ((tc // WORD) == w)[:, :, None]
        out = out | torch.where(sel, words[..., w][:, None, :], 0)
    bits = (out >> shift) & 1
    return bits.bool() & (t >= 0)[:, :, None]
