"""Harness-level fault injection (the JAX package's ``serve/faults.py``):
faults in the machinery around the simulation, not in the simulated
network (``chaos/`` does that).

It drives the supervised service loop's recovery tests and
``chip_smoke.py`` phase 45:

  * **SIGKILL crash points** (:meth:`FaultPlan.maybe_kill` and the
    checkpoint store's ``write_hook``): die at a segment boundary,
    mid-checkpoint-write (the tmp file written, then truncated, the final
    not yet in place) or after the snapshot's rename but before the
    manifest commit. A resumed run must finish bit-exact against an
    uninterrupted one.
  * **transient dispatch failures** (:meth:`FaultPlan.before_dispatch`):
    raise :class:`TransientDispatchError` on the first k attempts of a
    segment's dispatch, before the window starts, which exercises the
    supervisor's retry, backoff and degradation ladder.
  * **state corruption** (:meth:`FaultPlan.corrupt_state`): a NaN in one
    element of a named floating-point leaf, an event counter driven below
    zero, or a broken edge involution, after a chosen dispatch. It fires
    on the windowed pass and once more on the rollback replay (so the
    localiser sees it at the same dispatch), then stops; raise
    ``corrupt_max_fires`` for persistent damage. A corruption writes a
    new tensor (a clone with one element changed) and never writes in
    place: on the card a window returns its capture's own state buffers,
    which its next replay reads.
  * **checkpoint file damage** (module helpers): truncate a snapshot, flip
    a byte, or rewrite one leaf member under an unchanged CRC vector.

Everything is deterministic given the plan (no clock, no ambient
randomness), so a killed child and its resumed sibling, and a windowed
pass and its replay, see the same faults.
"""

from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import torch

from ..driver import _core_of


class TransientDispatchError(RuntimeError):
    """A dispatch failed in a way worth retrying (the injected stand-in for
    a transport or allocator hiccup that fails before launch)."""


#: write_hook stages (serve/store.py) a kill_site may name
KILL_SITES = ("post-segment", "mid-write", "post-rename")


@dataclasses.dataclass
class FaultPlan:
    """One run's fault schedule. Segment indices are the supervisor's loop
    ordinals (0-based); ``corrupt_dispatch`` is the dispatch index within
    the segment (-1: the segment's last dispatch)."""

    #: SIGKILL this process when the site is reached for the segment
    kill_segment: int | None = None
    kill_site: str = "post-segment"
    #: segment -> number of transient dispatch failures to inject
    fail_dispatches: dict = dataclasses.field(default_factory=dict)
    #: corrupt a state leaf after (segment, dispatch)
    corrupt_segment: int | None = None
    corrupt_dispatch: int = -1
    corrupt_leaf: str = "scores"
    corrupt_kind: str = "nan"          # "nan" | "events" | "topo"
    corrupt_max_fires: int = 2         # windowed pass + rollback replay

    def __post_init__(self):
        if self.kill_site not in KILL_SITES:
            raise ValueError(
                f"kill_site must be one of {KILL_SITES}, got {self.kill_site!r}")
        self._fails_left = {int(k): int(v) for k, v in self.fail_dispatches.items()}
        self._corrupt_fires = 0

    # -- crash points ---------------------------------------------------

    def maybe_kill(self, site: str, segment: int) -> None:
        """SIGKILL, not an exception: nothing downstream runs, as after a
        power loss."""
        if self.kill_segment is not None and site == self.kill_site \
                and segment == self.kill_segment:
            os.kill(os.getpid(), signal.SIGKILL)

    def store_hook(self, segment_fn):
        """A ``serve/store.py`` ``write_hook`` bound to this plan;
        ``segment_fn()`` gives the supervisor's current segment.
        ``mid-write`` truncates the tmp file first, so the crash really
        leaves a partial write."""

        def hook(stage: str, path: str) -> None:
            seg = segment_fn()
            if stage == "tmp-written" and self.kill_site == "mid-write" \
                    and self.kill_segment == seg:
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(max(1, size // 2))
                os.kill(os.getpid(), signal.SIGKILL)
            if stage == "renamed":
                self.maybe_kill("post-rename", seg)

        return hook

    # -- transient dispatch failures --------------------------------------

    def before_dispatch(self, segment: int) -> None:
        """The dispatch seam: raises while this segment's budget of
        transient failures lasts (the window never starts, so the state
        stays usable for the retry)."""
        left = self._fails_left.get(int(segment), 0)
        if left > 0:
            self._fails_left[int(segment)] = left - 1
            raise TransientDispatchError(
                f"injected transient dispatch failure (segment {segment}, "
                f"{left - 1} more to come)")

    # -- state corruption -------------------------------------------------

    def wants_corruption(self, segment: int) -> bool:
        return (self.corrupt_segment == segment
                and self._corrupt_fires < self.corrupt_max_fires)

    def resolved_dispatch(self, segment_len: int) -> int:
        """The segment-local dispatch index the corruption targets."""
        return (self.corrupt_dispatch if self.corrupt_dispatch >= 0
                else segment_len - 1)

    def corrupt_state(self, state, segment: int, dispatch: int, segment_len: int):
        """Apply the scheduled corruption after dispatch ``dispatch`` of
        ``segment`` (both loop-local). Returns the state, with the one
        corrupted leaf a new tensor; counts a fire only when it applied."""
        if not self.wants_corruption(segment) or dispatch != self.resolved_dispatch(
                segment_len):
            return state
        self._corrupt_fires += 1
        core = _core_of(state)
        if self.corrupt_kind == "events":
            ev = core.events.clone()
            ev[0] = -1                     # counters are born >= 0
            return _with_core(state, dataclasses.replace(core, events=ev))
        if self.corrupt_kind == "topo":
            # a bad mutation: re-aim one edge's reverse pointer at its flat
            # neighbour, so the plane is no longer a self-inverse
            # permutation (what the edge-involution-wf invariant trips on)
            t = getattr(core, "topo", None)
            if t is None:
                raise ValueError(
                    "corrupt_kind='topo' needs a dynamic-overlay state "
                    "(state.core.topo is None: build with dynamic_topo)")
            perm = t.edge_perm.clone()
            flat = perm.view(-1)
            flat[0] = (flat[0] + 1) % flat.shape[0]
            return _with_core(state, dataclasses.replace(
                core, topo=dataclasses.replace(t, edge_perm=perm)))
        return _nan_leaf(state, self.corrupt_leaf)

    @property
    def corrupt_fires(self) -> int:
        return self._corrupt_fires


def _with_core(st, core):
    return dataclasses.replace(st, core=core) if hasattr(st, "core") else core


def state_paths(state, prefix: str = ""):
    """(path, tensor) of every leaf of a state tree, in the JAX tree's
    flatten order and with its key paths (``.scores``, ``.core.dlv.have``:
    ``convert``'s naming), None leaves skipped."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        p = f"{prefix}.{f.name}"
        if dataclasses.is_dataclass(v):
            yield from state_paths(v, p)
        elif isinstance(v, torch.Tensor):
            yield p, v


def _replace_at(obj, parts, value):
    if not parts:
        return value
    return dataclasses.replace(obj, **{parts[0]: _replace_at(getattr(obj, parts[0]),
                                                             parts[1:], value)})


def _nan_leaf(state, needle: str):
    """The state with element 0 of the first floating-point leaf whose path
    contains ``needle`` set to NaN, in a new tensor."""
    flat = list(state_paths(state))
    hit = next((p for p, leaf in flat if needle in p and leaf.is_floating_point()), None)
    if hit is None:
        raise ValueError(
            f"no floating-point state leaf matches {needle!r}; float leaves: "
            f"{[p for p, leaf in flat if leaf.is_floating_point()]}")
    bad = dict(flat)[hit].clone()
    bad.view(-1)[0] = float("nan")
    return _replace_at(state, hit.split(".")[1:], bad)


# ---------------------------------------------------------------------------
# checkpoint file damage


def truncate_file(path: str, frac: float = 0.5) -> None:
    """Cut a file to ``frac`` of its size (a partial write or copy)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * frac)))


def flip_bit(path: str, offset: int | None = None, seed: int = 0) -> None:
    """XOR one byte; by default at a seeded offset in the middle half of
    the file."""
    size = os.path.getsize(path)
    if offset is None:
        rng = np.random.default_rng(seed)
        offset = int(rng.integers(size // 4, max(size // 4 + 1, 3 * size // 4)))
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def corrupt_leaf_member(path: str, leaf_idx: int) -> None:
    """Rewrite ``leaf_<idx>``'s bytes while keeping the envelope's CRC
    vector: a valid zip whose content lies, which the per-leaf CRC (not the
    container's) must catch and name."""
    with np.load(path) as data:
        members = {k: data[k] for k in data.files}
    name = f"leaf_{leaf_idx}"
    if name not in members:
        raise ValueError(f"{path} has no member {name}")
    arr = np.array(members[name])
    if arr.size == 0:
        raise ValueError(f"{name} is empty: nothing to corrupt")
    flat = arr.reshape(-1).view(np.uint8)
    flat[0] ^= 0xFF
    members[name] = arr
    np.savez_compressed(path, **members)
