"""Capacity-bounded CSR edge layout: the sparse data plane (the port's
copy of the JAX package's ``ops/csr.py``, without the edge-sharding
padding).

On a capacity-padded ragged topology (power-law or random graphs padded to
the max degree K) most of the dense ``[N, K]`` slot space is dead. This
layout packs the E present edges flat in row-major ``(owner, slot)`` order
with a row pointer — a *capacity-bounded* CSR: every row holds at most K
entries.

Layout (host-built once per topology, ``build_csr``):

  row_ptr[N+1]   edges of peer n are ``[row_ptr[n], row_ptr[n+1])``
  col[E]         neighbor peer id of each edge
  row[E]         owner peer id (sorted)
  slot[E]        dense slot k of each edge
  e2nk[E]        flat ``n*K + k`` dense-slot address of each edge
  e_of_nk[N,K]   flat edge id of each dense slot, -1 where absent
  eperm[E]       the edge involution in flat edge space:
                 ``eperm[e_of_nk[n,k]] == e_of_nk[nbr[n,k], rev[n,k]]``

Cross-peer movement is E-sized: ``edge_permute_flat`` (the involution)
and ``peer_gather_flat`` (the neighbor view) are row gathers over
``[E, ...]``. Reductions back to peers: ``segment_sum_edges`` for
arithmetic, ``segment_or_scan`` / ``segment_or_words`` for packed words
(a segmented prefix OR; bitwise OR has no exact sum decomposition).

Integer reductions pass ``dtype=`` explicitly: torch widens an integer
``sum``/``cumsum`` to int64 where jnp keeps the input type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .edges import build_edge_perm


@dataclasses.dataclass(frozen=True)
class CsrTopology:
    """Host-side CSR build of one padded adjacency (see module doc)."""

    row_ptr: np.ndarray   # [N+1] i32
    col: np.ndarray       # [E] i32
    row: np.ndarray       # [E] i32 (sorted ascending)
    slot: np.ndarray      # [E] i32 — dense slot k of each edge
    e2nk: np.ndarray      # [E] i32 — flat n*K + k
    e_of_nk: np.ndarray   # [N, K] i32, -1 absent
    eperm: np.ndarray     # [E] i32 — flat involution

    @property
    def n_peers(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def max_degree(self) -> int:
        return self.e_of_nk.shape[1]

    @property
    def n_edges(self) -> int:
        return self.col.shape[0]

    @property
    def n_real_edges(self) -> int:
        """Present edge count (every edge of this build is real)."""
        return int((self.e_of_nk >= 0).sum())

    @property
    def density(self) -> float:
        """E / (N*K): the fraction of padded slots that hold an edge."""
        return self.n_real_edges / float(self.n_peers * self.max_degree)

    @property
    def seg_start(self) -> np.ndarray:
        """[E] bool: True at the first edge of each row segment — the
        segmented-scan reset flags."""
        s = np.ones(self.n_edges, bool)
        if self.n_edges:
            s[1:] = self.row[1:] != self.row[:-1]
        return s

    @property
    def row_last(self) -> np.ndarray:
        """[N] i32: flat index of each row's last edge (clip-safe junk for
        empty rows — pair with ``row_nonempty``)."""
        return np.maximum(
            np.searchsorted(self.row, np.arange(self.n_peers),
                            side="right") - 1, 0).astype(np.int32)

    @property
    def row_nonempty(self) -> np.ndarray:
        """[N] bool: rows owning at least one edge."""
        return (self.e_of_nk >= 0).any(axis=1)


def build_csr(nbr: np.ndarray, rev: np.ndarray,
              nbr_ok: np.ndarray) -> CsrTopology:
    """Build the CSR layout from the padded adjacency (graph.Topology
    fields). Requires a symmetric topology (every present edge's reverse
    present); raises otherwise, because the flat involution would have
    nowhere to point."""
    nbr = np.asarray(nbr)
    rev = np.asarray(rev)
    nbr_ok = np.asarray(nbr_ok, bool)
    n, k = nbr.shape
    rows, slots = np.nonzero(nbr_ok)  # row-major: sorted by (n, k)
    e = rows.shape[0]
    if e == 0:
        raise ValueError("build_csr: topology has no edges")
    e_of_nk = np.full((n, k), -1, np.int32)
    e_of_nk[rows, slots] = np.arange(e, dtype=np.int32)
    col = nbr[rows, slots].astype(np.int32)
    eperm = e_of_nk[col, rev[rows, slots]]
    if (eperm < 0).any():
        bad = int(np.flatnonzero(eperm < 0)[0])
        raise ValueError(
            f"build_csr: edge {int(rows[bad])}->{int(col[bad])} has no "
            "present reverse edge — the topology is not symmetric")
    if not (eperm[eperm] == np.arange(e)).all():
        raise ValueError("build_csr: rev mapping is not an involution")
    counts = nbr_ok.sum(axis=1).astype(np.int64)
    row_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return CsrTopology(
        row_ptr=row_ptr,
        col=col,
        row=rows.astype(np.int32),
        slot=slots.astype(np.int32),
        e2nk=(rows * k + slots).astype(np.int32),
        e_of_nk=e_of_nk,
        eperm=eperm.astype(np.int32),
    )


def build_csr_full(nbr: np.ndarray, rev: np.ndarray,
                   nbr_ok: np.ndarray) -> tuple[CsrTopology, np.ndarray]:
    """The full-capacity identity layout of the mutable overlay: every
    padded ``[N, K]`` slot, present or absent, owns a flat edge, E = N*K in
    row-major slot order, so the flat structure is a function of the
    capacity alone and a rewire changes only ``col``/``eperm``/``e_valid``
    (``state.Net.with_overlay``). Returns (layout, ``e_valid`` = ``nbr_ok``
    flat): absent slots are inert, their ``eperm`` self-points."""
    nbr = np.asarray(nbr)
    rev = np.asarray(rev)
    nbr_ok = np.asarray(nbr_ok, bool)
    n, k = nbr.shape
    e = n * k
    ar = np.arange(e, dtype=np.int32)
    perm = build_edge_perm(nbr, rev, nbr_ok).reshape(e)
    if not (perm[perm] == ar).all():
        raise ValueError("build_csr_full: rev mapping is not an involution")
    okf = nbr_ok.reshape(e)
    nbrf = nbr.reshape(e)
    row = (ar // k).astype(np.int32)
    if not (okf[perm] == okf).all() or not (nbrf[perm][okf] == row[okf]).all():
        raise ValueError("build_csr_full: topology is not symmetric")
    ct = CsrTopology(
        row_ptr=(np.arange(n + 1, dtype=np.int64) * k).astype(np.int32),
        col=np.clip(nbrf, 0, None).astype(np.int32),
        row=row,
        slot=(ar % k).astype(np.int32),
        e2nk=ar.copy(),
        e_of_nk=ar.reshape(n, k).copy(),
        eperm=perm.astype(np.int32),
    )
    return ct, okf.copy()


# ---------------------------------------------------------------------------
# local relayouts


def pack_edges(x: torch.Tensor, row: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[N, K, ...] dense plane -> [E, ...] flat edge plane: ``x[row[e],
    slot[e]]`` (the present slots in row-major order). Indexing by (row,
    slot) rather than the flat ``e2nk`` reads a broadcast view such as a
    per-receiver edge mask without first copying it to [N*K, ...]."""
    return x[row, slot]


def unpack_edges(x_e: torch.Tensor, e_of_nk: torch.Tensor,
                 fill=None) -> torch.Tensor:
    """[E, ...] flat edge plane -> [N, K, ...] dense plane; absent slots
    take ``fill`` (default: zero)."""
    n, k = e_of_nk.shape
    got = x_e[e_of_nk.clamp(min=0).reshape(-1)].reshape((n, k) + tuple(x_e.shape[1:]))
    present = (e_of_nk >= 0).reshape((n, k) + (1,) * (x_e.dim() - 1))
    if fill is None:
        fill = torch.zeros((), dtype=x_e.dtype, device=x_e.device)
    return torch.where(present, got, fill)


# ---------------------------------------------------------------------------
# cross-peer gathers


def edge_permute_flat(x_e: torch.Tensor, eperm: torch.Tensor) -> torch.Tensor:
    """The edge involution in flat space: out[e] = x_e[eperm[e]]."""
    return x_e[eperm]


def peer_gather_flat(v: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Flat neighbor view: out[e] = v[col[e]] ([N, ...] -> [E, ...])."""
    return v[col]


# ---------------------------------------------------------------------------
# segment reductions over the sorted row ids


def segment_sum_edges(x_e: torch.Tensor, row: torch.Tensor,
                      n_peers: int) -> torch.Tensor:
    """Arithmetic per-peer reduction of a flat edge plane: out[n] = the
    sum of x_e over peer n's edges, in x_e's dtype."""
    out = torch.zeros((n_peers,) + tuple(x_e.shape[1:]), dtype=x_e.dtype,
                      device=x_e.device)
    return out.index_add(0, row, x_e)


def segment_or_scan(words_e: torch.Tensor, seg_start: torch.Tensor,
                    cap: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Segmented prefix-OR over a flat ``[E, W]`` packed-word plane.

    Returns ``(inclusive, exclusive)`` prefix ORs within each row segment;
    ``exclusive`` is the OR of the same row's earlier edges (zero at row
    starts), so ``x & ~exclusive`` keeps each bit's first carrying edge.

    Hillis–Steele over the segmented monoid: element e folds in element
    e-d unless a segment start lies in (e-d, e], for d = 1, 2, 4, ...
    With ``cap`` (every segment has length <= cap, as ``build_csr``
    guarantees for cap=K) the lookback stops at ceil(log2 cap) levels;
    without it, at log2(E) levels, like the reference's associative scan.
    Both give the same bits for any legal ``cap``."""
    flags = seg_start.bool()
    e = words_e.shape[0]
    limit = e if cap is None else cap
    inc, started = words_e, flags
    d = 1
    while d < limit:
        prev_inc = torch.cat([torch.zeros_like(inc[:d]), inc[:-d]], dim=0)
        prev_started = torch.cat([torch.ones_like(started[:d]), started[:-d]], dim=0)
        inc = torch.where(started[:, None], inc, inc | prev_inc)
        started = started | prev_started
        d *= 2
    shifted = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]], dim=0)
    exc = torch.where(flags[:, None], torch.zeros_like(shifted), shifted)
    return inc, exc


def segment_or_words(words_e: torch.Tensor, seg_start: torch.Tensor,
                     row_last: torch.Tensor, row_nonempty: torch.Tensor,
                     cap: int | None = None) -> torch.Tensor:
    """[E, W] -> [N, W] per-peer word-OR via the segmented scan (equal to
    ``unpack_edges`` + ``bitset.word_or_reduce``); empty rows give 0."""
    inc, _ = segment_or_scan(words_e, seg_start, cap=cap)
    out = inc[row_last.clamp(min=0)]
    return torch.where(row_nonempty.bool()[:, None], out, torch.zeros_like(out))
