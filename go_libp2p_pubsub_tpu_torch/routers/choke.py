"""Episub-style lazy choking (Topiary, arXiv:2312.06800; the port's copy of
the JAX package's ``routers/choke.py``).

A choked mesh link keeps its mesh membership (GRAFT/PRUNE are untouched)
but is demoted to lazy: the receiver suppresses the link's eager data push
as an IDONTWANT for every id would, and the sender, who learns it is
choked through one edge gather a heartbeat, folds the link into its IHAVE
gossip targets, so the link still carries ids and serves IWANT.

The decision signal is the per-edge lateness EMA: the share of an edge's
arrivals that were not the first copy of a message, folded at
``choke_ema_alpha`` on rounds where the edge carried traffic; the
first-arrival isolation ``dlv.fe_words`` gives the numerator.

Decisions keep at least Dlo unchoked mesh links in every topic slot, and
the guard (choked within the mesh, every choke of a slot whose unchoked
degree fell below Dlo cleared) runs at every mesh mutation site: the
GRAFT/PRUNE ingest, the heartbeat's maintenance and peer churn.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitset
from ..ops.fnum import flush_subnormals, fma_f32
from ..ops.select import count_true, masked_width_topk
from .config import RouterConfig


def _f32(x: float) -> float:
    """A Python float's float32 value: a threshold compared with a float32
    plane as the JAX package's weak-typed literal is."""
    return float(np.float32(x))


def choke_lateness_update(router: RouterConfig, choke_ema: torch.Tensor,
                          trans: torch.Tensor, fe_words: torch.Tensor,
                          new_words: torch.Tensor) -> torch.Tensor:
    """This round's per-edge lateness folded into the EMA ([N, K] f32).

    ``trans`` is the round's transmission plane, ``fe_words`` the
    post-round first-edge isolation and ``new_words`` the round's new
    receipts, so ``fe & new`` are the arrivals that won this round's
    first-copy race; everything else the edge carried was late. Edges with
    no traffic keep their EMA. The float form is XLA:CPU's: ``(1 - a) *
    ema`` contracts into the add of ``a * frac`` (one rounding), results
    flushed of subnormals (held against the jitted reference on random
    counters, ``tests/test_torch_router.py``)."""
    arrivals = bitset.popcount(trans)                                   # [N, K]
    first = bitset.popcount(trans & fe_words & new_words[:, None, :])   # [N, K]
    late = (arrivals - first).to(torch.float32)
    frac = late / arrivals.clamp(min=1).to(torch.float32)
    a = np.float32(router.choke_ema_alpha)
    folded = fma_f32(choke_ema, float(np.float32(1.0) - a),
                     flush_subnormals(frac * float(a)))
    return torch.where(arrivals > 0, flush_subnormals(folded), choke_ema)


def choke_decide(router: RouterConfig, Dlo, mesh: torch.Tensor, choked: torch.Tensor,
                 choke_ema: torch.Tensor):
    """The heartbeat's choke/unchoke decision: ``(choked, n_choke,
    n_unchoke)``. Unchoke first (the EMA fell below the hysteresis
    floor), then choke up to ``choke_max_per_hb`` worst-EMA eligible links
    a topic slot, budgeted so the slot's unchoked mesh degree never drops
    below Dlo; equal EMAs rank by slot index (no tie-break noise)."""
    ema3 = choke_ema[:, None, :]                                        # [N, 1, K]
    unchoke = choked & mesh & (ema3 < _f32(router.unchoke_threshold))
    choked = (choked & mesh) & ~unchoke
    unchoked_deg = count_true(mesh & ~choked)                           # [N, S]
    budget = (unchoked_deg - Dlo).clamp(0, router.choke_max_per_hb)
    cand = mesh & ~choked & (ema3 > _f32(router.choke_threshold))
    newly = masked_width_topk(ema3.expand(cand.shape), cand, budget, cand.shape[-1])
    choked = choked | newly
    return choked, newly.sum(dtype=torch.int32), unchoke.sum(dtype=torch.int32)


def choke_guard(Dlo, mesh: torch.Tensor, choked: torch.Tensor) -> torch.Tensor:
    """The choke contract after a mesh mutation: choked within the mesh,
    and a slot whose unchoked degree fell below Dlo (a PRUNE or a peer's
    death took an unchoked link) drops all its chokes (fail open)."""
    choked = choked & mesh
    ok = count_true(mesh & ~choked) >= Dlo                              # [N, S]
    return choked & ok[:, :, None]


def choke_suppression(choked: torch.Tensor) -> torch.Tensor:
    """[N, K] edges whose eager push the receiver suppresses: any topic
    slot choked the link (edge-granular, exact on single-topic builds)."""
    return choked.any(1)
