"""Checkpoint / resume of a simulation state, in the JAX package's v6 npz
container, so a state moves between the two packages either way: a JAX
checkpoint resumes in the port and a port checkpoint in the JAX package.

The container: one .npz (compressed or not) holding the state's leaves as
``leaf_0 .. leaf_{n-1}`` in the JAX tree's flatten order (the port walks
its dataclasses in field order, nested states in place, None leaves and
absent nested states skipped: ``convert.leaf_specs``), each with the JAX
package's dtype (word planes ``uint32``, the port's int32 bits; int16
counters stay int16); the PRNG key as its two ``uint32`` words beside a
``leaf_i__is_key`` flag; and the header ``__version__`` (6),
``__n_leaves__``, ``__crc32__`` (one CRC32 per leaf over its raw bytes),
``__header_len__`` (the member count written, so a truncated member table
is found before any leaf is read) and ``__header_crc__`` (CRC32 of the
canonical header and the CRC vector). A file without ``__crc32__``
predates that integrity layer: it loads unverified with a logged "no
checksum" note. Damage raises ``CheckpointCorrupt`` naming the failing
section; a template that does not match raises a plain ValueError naming
the leaf paths.

The JAX package's orbax backend (``save_orbax``/``restore_orbax``, sharded
and asynchronous) belongs with peer-axis sharding (ROADMAP §1, item 7).
"""

from __future__ import annotations

import logging
import zlib

import numpy as np

from . import convert

_log = logging.getLogger(__name__)

#: the JAX package's container version (its ``checkpoint.py`` history)
_FORMAT_VERSION = 6


class CheckpointCorrupt(ValueError):
    """A checkpoint file failed an integrity check (truncated container,
    bit-flipped member, CRC mismatch). ``section`` names what failed —
    ``"container"``, ``"header"``, ``"member table"`` or the path of the
    damaged leaf — so a caller can tell corruption apart from a template
    mismatch, which stays a plain ValueError."""

    def __init__(self, path, section: str, detail: str = ""):
        self.path = str(path)
        self.section = section
        msg = f"corrupt checkpoint {self.path}: {section}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def _crc(arr) -> int:
    """CRC32 over a numpy array's raw bytes (the unit of the envelope's
    per-leaf integrity vector)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _header_crc(version: int, n_leaves: int, header_len: int,
                crcs: np.ndarray) -> int:
    canon = f"v{version};n{n_leaves};m{header_len};".encode()
    return zlib.crc32(canon + np.ascontiguousarray(crcs).tobytes()) & 0xFFFFFFFF


def _npz_path(path) -> str:
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def save(path: str, state, *, compress: bool = True) -> None:
    """Write a port state to an .npz in the v6 container (copied to the
    host leaf by leaf). ``compress=False`` trades disk for write time; the
    per-leaf CRCs carry the integrity either way."""
    leaves = convert.state_leaves(state)
    out = {"__version__": np.int64(_FORMAT_VERSION),
           "__n_leaves__": np.int64(len(leaves))}
    crcs = np.zeros(len(leaves), np.uint32)
    for i, (p, arr) in enumerate(leaves.items()):
        out[f"leaf_{i}"] = arr
        if p in convert.KEY_LEAVES:
            out[f"leaf_{i}__is_key"] = np.bool_(True)
        crcs[i] = _crc(arr)
    out["__crc32__"] = crcs
    # member count INCLUDING the two integrity entries below
    header_len = len(out) + 2
    out["__header_len__"] = np.int64(header_len)
    out["__header_crc__"] = np.uint32(
        _header_crc(_FORMAT_VERSION, len(leaves), header_len, crcs))
    (np.savez_compressed if compress else np.savez)(path, **out)


def _open_envelope(path: str):
    """np.load with container-level failures mapped to the typed error
    (a missing file stays FileNotFoundError — absence is not damage)."""
    try:
        return np.load(path)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            path, "container", f"{type(e).__name__}: {e}") from e


def _read_member(data, name: str, path: str, section: str):
    """One npz member, with decompression/CRC failures (a bit-flipped
    or truncated member) mapped to CheckpointCorrupt naming ``section``."""
    try:
        return data[name]
    except KeyError:
        raise CheckpointCorrupt(
            path, "member table", f"missing member {name}") from None
    except Exception as e:
        raise CheckpointCorrupt(
            path, section, f"{type(e).__name__}: {e}") from e


def _validate_header(data, path: str):
    """Shared header validation for :func:`restore` / :func:`verify`.

    Returns ``(version, n_leaves, crcs_or_None)``; ``crcs`` is None for
    files predating the integrity layer (a "no checksum" note is logged —
    they load unverified)."""
    if "__version__" not in data.files or "__n_leaves__" not in data.files:
        raise ValueError(f"{path} is not a go_libp2p_pubsub_tpu checkpoint")
    version = int(_read_member(data, "__version__", path, "header"))
    if version != _FORMAT_VERSION:
        if version < _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format v{version} predates the current "
                f"v{_FORMAT_VERSION} (state leaves changed shape/meaning — "
                "see the version history of the JAX package's checkpoint.py); "
                "re-create the checkpoint from source state — no migration "
                "path is provided")
        raise ValueError(
            f"checkpoint format v{version} is newer than this build's "
            f"v{_FORMAT_VERSION}")
    n = int(_read_member(data, "__n_leaves__", path, "header"))
    if "__header_len__" in data.files:
        want = int(_read_member(data, "__header_len__", path, "header"))
        if len(data.files) != want:
            raise CheckpointCorrupt(
                path, "member table",
                f"{len(data.files)} members on disk != {want} written "
                "(truncated container)")
    if "__crc32__" not in data.files:
        _log.info(
            "checkpoint %s predates the integrity layer (no checksum) — "
            "loading unverified", path)
        return version, n, None
    crcs = np.asarray(
        _read_member(data, "__crc32__", path, "header"), np.uint32)
    if crcs.shape != (n,):
        raise CheckpointCorrupt(
            path, "header",
            f"crc vector covers {crcs.shape[0] if crcs.ndim else '?'} "
            f"leaves, header says {n}")
    if "__header_crc__" in data.files:
        want = int(_read_member(data, "__header_crc__", path, "header"))
        hl = int(_read_member(data, "__header_len__", path, "header"))
        if _header_crc(version, n, hl, crcs) != want:
            raise CheckpointCorrupt(path, "header", "header CRC32 mismatch")
    return version, n, crcs


def verify(path: str) -> dict:
    """Template-free integrity pass over a checkpoint envelope: header
    consistency, member-table completeness, and every leaf's CRC32.
    Raises :class:`CheckpointCorrupt` on damage (ValueError when the
    file is not a checkpoint at all); returns ``{"version", "n_leaves",
    "checksummed", "members"}`` on success."""
    fpath = _npz_path(path)
    with _open_envelope(fpath) as data:
        version, n, crcs = _validate_header(data, fpath)
        for i in range(n):
            arr = _read_member(data, f"leaf_{i}", fpath, f"leaf_{i}")
            if crcs is not None and _crc(arr) != int(crcs[i]):
                raise CheckpointCorrupt(
                    fpath, f"leaf_{i}", "CRC32 mismatch")
        return {"version": version, "n_leaves": n,
                "checksummed": crcs is not None,
                "members": len(data.files)}


def restore(path: str, template):
    """A port state from ``path`` with ``template``'s structure, on the
    template's device.

    The template (a port state built from the same configs and topology)
    gives the leaf paths, shapes and JAX dtypes; its values are ignored.
    Raises ValueError on any mismatch, naming the path of every leaf that
    differs (``.core.dlv.fe_words (leaf 11): ...``); file damage raises
    :class:`CheckpointCorrupt` naming the failing section."""
    fpath = _npz_path(path)
    specs = convert.leaf_specs(template)
    device = getattr(template, "core", template).tick.device
    with _open_envelope(fpath) as data:
        _, n, crcs = _validate_header(data, fpath)
        if n != len(specs):
            raise ValueError(
                f"checkpoint has {n} leaves, template has {len(specs)} "
                "(different configs/topology? optional planes — the "
                "validation pipeline, the exact-trace plane, chaos_ge, telemetry, "
                f"the mutable overlay — change the leaf count); template leaves: "
                f"{', '.join(specs)}")
        leaves = {}
        errors = []
        for i, (p, (shape, dtype)) in enumerate(specs.items()):
            where = f"{p} (leaf {i})"
            arr = _read_member(data, f"leaf_{i}", fpath, where)
            if crcs is not None and _crc(arr) != int(crcs[i]):
                raise CheckpointCorrupt(fpath, where, "CRC32 mismatch")
            is_key = f"leaf_{i}__is_key" in data.files
            if is_key and p not in convert.KEY_LEAVES:
                errors.append(f"{where}: checkpoint holds a PRNG key, template does not")
                continue
            if not is_key and p in convert.KEY_LEAVES:
                errors.append(f"{where}: template expects a PRNG key, checkpoint "
                              "holds a plain array")
                continue
            what = "key data shape" if is_key else "shape"
            if tuple(arr.shape) != shape:
                errors.append(f"{where}: {what} {tuple(arr.shape)} != template {shape}")
                continue
            if arr.dtype != dtype:
                errors.append(f"{where}: dtype {arr.dtype} != {dtype}")
                continue
            leaves[p] = arr
        if errors:
            raise ValueError(
                "checkpoint/template mismatch at "
                f"{len(errors)} leaf path(s): " + "; ".join(errors))
    return convert.state_from_reference(leaves, device=device)
