"""Rolling checkpoint store: the supervised loop's durability plane.

One directory holds numbered, checksummed v6 snapshots plus a
``MANIFEST.json`` that is the source of truth for what exists and what
is trustworthy. Every mutation is crash-ordered so a ``kill -9`` at ANY
point leaves a loadable store:

  1. the snapshot is written to a ``.tmp.npz`` sibling and ``os.replace``d
     into place (a crash mid-write leaves only the tmp, which init
     sweeps);
  2. the manifest is rewritten the same way AFTER the snapshot rename
     (a crash between the two leaves an orphan snapshot the manifest
     does not know about — the previous entry is still valid, and the
     orphan is overwritten by the next save at that ordinal).

Retention is the :class:`RetentionPolicy` pair the ISSUE's durability
story names: ``keep_last`` trailing snapshots always survive, and with
``keep_every = m`` every m-th snapshot (by ordinal) is retained
permanently — the cheap long-horizon audit trail. Pruned files are
deleted eagerly.

Reads are defensive end to end: :meth:`CheckpointStore.restore_latest`
walks the manifest newest-first, and a snapshot that fails the
checkpoint's integrity layer (``checkpoint.CheckpointCorrupt`` —
truncation, bit flips, CRC mismatch) or is simply missing is logged,
dropped from the manifest, and replaced by the next-older entry — the
corrupted-latest fallback. A corrupt or missing manifest is rebuilt by
globbing the snapshot files themselves. The files are the JAX package's
store's: both packages read either's.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import re
import time

from .. import checkpoint as _ckpt

_log = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
_SNAP_RE = re.compile(r"^ckpt_(\d+)_t(\d+)\.npz$")


def write_json_atomic(path: str, doc: dict) -> None:
    """Crash-ordered JSON write (tmp sibling + ``os.replace``) — the one
    atomic-write discipline shared by the manifest, the heartbeat and
    the incremental report (a reader never sees a torn file)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """``keep_last`` trailing snapshots always kept; ``keep_every = m``
    (0 = off) additionally pins every m-th snapshot by ordinal forever.
    ``keep_last=1, keep_every=0`` degenerates to the single-snapshot
    overwrite ``api.Network.run``'s default auto-snapshots do."""

    keep_last: int = 3
    keep_every: int = 0

    def __post_init__(self):
        if self.keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {self.keep_last}")
        if self.keep_every < 0:
            raise ValueError(
                f"keep_every must be >= 0, got {self.keep_every}")

    def keeps(self, ordinal: int, last_ordinals) -> bool:
        if ordinal in last_ordinals:
            return True
        return self.keep_every > 0 and ordinal % self.keep_every == 0


class CheckpointStore:
    """Rolling checksummed snapshots + manifest in one directory.

    ``write_hook(stage, path)`` is the fault-injection seam: called with ``"tmp-written"`` (tmp file complete,
    final not yet in place), ``"renamed"`` (snapshot durable, manifest
    not yet updated) and ``"manifest"`` (fully committed) — the three
    crash windows the SIGKILL recovery tests aim into."""

    def __init__(self, root: str, policy: RetentionPolicy | None = None,
                 *, write_hook=None):
        self.root = str(root)
        self.policy = policy or RetentionPolicy()
        self.write_hook = write_hook
        os.makedirs(self.root, exist_ok=True)
        # a crash mid-save leaves a tmp sibling; it is dead weight
        for tmp in glob.glob(os.path.join(self.root, "*.tmp.npz")):
            try:
                os.unlink(tmp)
            except OSError:  # pragma: no cover — racing cleaner
                pass
        self._entries = self._load_manifest()

    # -- manifest -------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    def _load_manifest(self) -> list:
        try:
            with open(self._manifest_path()) as f:
                doc = json.load(f)
            entries = list(doc.get("entries", []))
            entries.sort(key=lambda e: int(e["ordinal"]))
            return entries
        except FileNotFoundError:
            pass
        except (OSError, ValueError, KeyError, TypeError) as e:
            _log.warning(
                "checkpoint store %s: unreadable manifest (%s) — "
                "rebuilding from snapshot files", self.root, e)
        # no/corrupt manifest: reconstruct from the files themselves
        entries = []
        for path in glob.glob(os.path.join(self.root, "ckpt_*.npz")):
            m = _SNAP_RE.match(os.path.basename(path))
            if m:
                entries.append({"ordinal": int(m.group(1)),
                                "tick": int(m.group(2)),
                                "file": os.path.basename(path)})
        entries.sort(key=lambda e: e["ordinal"])
        return entries

    def _write_manifest(self) -> None:
        write_json_atomic(self._manifest_path(), {
            "schema": 1,
            "policy": dataclasses.asdict(self.policy),
            "entries": self._entries,
        })

    def entries(self) -> list:
        """Manifest entries, oldest first (copies)."""
        return [dict(e) for e in self._entries]

    def latest(self) -> dict | None:
        return dict(self._entries[-1]) if self._entries else None

    def _hook(self, stage: str, path: str) -> None:
        if self.write_hook is not None:
            self.write_hook(stage, path)

    # -- writes ---------------------------------------------------------

    def save(self, state, tick: int, meta: dict | None = None) -> dict:
        """Write one snapshot: atomic file, then retention prune, then
        atomic manifest update. Returns the new manifest entry."""
        ordinal = self._entries[-1]["ordinal"] + 1 if self._entries else 0
        fname = f"ckpt_{ordinal:06d}_t{int(tick):010d}.npz"
        final = os.path.join(self.root, fname)
        tmp = final + ".tmp.npz"
        # uncompressed: snapshot cadence is the hot path of a supervised
        # run and the envelope's CRCs carry integrity without zlib
        _ckpt.save(tmp, state, compress=False)
        self._hook("tmp-written", tmp)
        os.replace(tmp, final)
        self._hook("renamed", final)
        entry = {"ordinal": ordinal, "tick": int(tick), "file": fname,
                 "written_at": time.time()}
        if meta:
            entry["meta"] = dict(meta)
        self._entries.append(entry)
        drop = self._prune_entries()
        self._write_manifest()
        self._hook("manifest", self._manifest_path())
        # unlink pruned files only AFTER the manifest commit: a crash
        # between an earlier unlink and the manifest rewrite would leave
        # the (stale, valid) manifest pointing at deleted files while
        # the newest snapshot is a manifest-orphan — restore_latest
        # would then cold-start despite a perfectly good snapshot on
        # disk. Post-commit, a crash mid-unlink merely leaves orphan
        # files the next prune re-collects.
        for e in drop:
            try:
                os.unlink(os.path.join(self.root, e["file"]))
            except FileNotFoundError:
                pass
        return dict(entry)

    def _prune_entries(self) -> list:
        """Apply retention to the in-memory manifest; returns the
        dropped entries (files NOT yet unlinked — see save())."""
        last = {e["ordinal"] for e in self._entries[-self.policy.keep_last:]}
        keep, drop = [], []
        for e in self._entries:
            (keep if self.policy.keeps(e["ordinal"], last) else drop).append(e)
        self._entries = keep
        return drop

    # -- reads ----------------------------------------------------------

    def restore_latest(self, template):
        """Restore the newest trustworthy snapshot.

        Walks the manifest newest-first; an entry whose file is missing,
        truncated, bit-flipped or CRC-mismatched
        (:class:`checkpoint.CheckpointCorrupt`) is logged and dropped,
        and the previous entry is tried — the supervisor's fallback
        story. Returns ``(state, entry)``, or ``(None, None)`` when no
        loadable snapshot remains. Template-mismatch ValueErrors
        propagate: a wrong template is a caller bug, not file damage."""
        dropped = False
        while self._entries:
            entry = self._entries[-1]
            path = os.path.join(self.root, entry["file"])
            try:
                state = _ckpt.restore(path, template)
                if dropped:
                    self._write_manifest()
                return state, dict(entry)
            except (_ckpt.CheckpointCorrupt, FileNotFoundError) as e:
                _log.warning(
                    "checkpoint store %s: snapshot ordinal %d unusable "
                    "(%s) — falling back to the previous manifest entry",
                    self.root, entry["ordinal"], e)
                self._entries.pop()
                dropped = True
        if dropped:
            self._write_manifest()
        return None, None
