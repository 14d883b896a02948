"""The port's checkpoint (``checkpoint.py``, the JAX package's v6 npz
container) against the JAX package's, both ways.

The port writes a state's leaves in the JAX tree's flatten order with the
JAX dtypes, so the two packages read each other's files: here the order
equals the JAX tree's for every engine and option the port runs (and
STATE_SCHEMA.json's), a JAX checkpoint restores in the port and a port
checkpoint in the JAX package, at r = 1 and at r = 8 mid-run with the
coalesced and the per-plane wire, and each continuation equals the other
package's run and the uninterrupted run on every leaf. The integrity
cases of the JAX package's ``tests/test_checkpoint.py`` (truncated,
bit-flipped, a corrupt leaf named by its path, a pre-integrity file with
its note, a template mismatch as a plain ValueError, uncompressed) run on
the port's, and a key of another JAX PRNG implementation is refused with
the key's path named."""

from __future__ import annotations

import functools
import json
import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bench_builds, diff_leaves, jinit, phase_schedule, reference_leaves

from go_libp2p_pubsub_tpu import checkpoint as jck
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake_phase
from go_libp2p_pubsub_tpu.serve import corrupt_leaf_member
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import checkpoint as tck
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 64

#: option -> (bench_builds keywords, JAX GossipSubState.init keywords)
OPTIONS = {
    "default": ({}, {}),
    "csr": (dict(edge_layout="csr", fused=True), {}),
    "pipeline": (dict(validation_delay_rounds=2), {}),
    "trace_exact": (dict(options=dict(trace_exact=True)), {}),
    "narrow_counters": (dict(options=dict(narrow_counters=True)), {}),
    "dynamic_topo": (dict(dynamic=True), dict(dynamic_topo=True)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_leaf_order_is_the_jax_tree_order(option):
    """``convert.leaf_specs`` walks the port's dataclasses in the JAX
    tree's flatten order, with each leaf's shape and JAX dtype; the
    GossipSub default is STATE_SCHEMA.json's order."""
    kw, init_kw = OPTIONS[option]
    b = bench_builds(n=N, d=4, **kw)
    jst = jinit(JState.init, b[1], 64, b[0], score_params=b[2], seed=0, **init_kw)
    ref = reference_leaves(jst)
    specs = convert.leaf_specs(convert.state_from_reference(ref, device="cpu"))
    assert list(specs) == list(ref)
    assert specs == {p: (a.shape, a.dtype) for p, a in ref.items()}
    tst = TState.init(b[4], 64, b[3], score_params=b[5], seed=0,
                      dynamic_topo=bool(init_kw))
    assert convert.leaf_specs(tst) == specs
    if option == "default":
        schema = json.loads((ROOT / "STATE_SCHEMA.json").read_text())["engines"]
        assert [leaf["path"] for leaf in schema["gossipsub"]["leaves"]] == list(specs)


@pytest.mark.parametrize("val_delay", [0, 2])
def test_sim_state_leaf_order_is_the_jax_tree_order(val_delay):
    jst = jinit(JSim.init, N, 64, seed=0, k=8, val_delay=val_delay)
    ref = reference_leaves(jst)
    tst = TSim.init(N, 64, seed=0, k=8, device="cpu", val_delay=val_delay)
    assert convert.leaf_specs(tst) == {p: (a.shape, a.dtype) for p, a in ref.items()}
    if not val_delay:
        schema = json.loads((ROOT / "STATE_SCHEMA.json").read_text())["engines"]
        assert [leaf["path"] for leaf in schema["floodsub"]["leaves"]] == list(ref)


@functools.lru_cache(maxsize=None)
def _engine(engine: str):
    """(builds, JAX step, port step, r) of one engine: the per-round step
    (r = 1) or the phase engine at r = 8 with the coalesced or the
    per-plane wire, bench parameters on the lattice."""
    if engine == "round":
        b = bench_builds(n=N, d=4)
        return b, jmake(b[0], b[1], score_params=b[2]), tmake(b[3], b[4], score_params=b[5]), 1
    b = bench_builds(n=N, d=4, heartbeat_every=8,
                     options=dict(wire_coalesced=engine == "phase-coalesced"))
    return (b, jmake_phase(b[0], b[1], 8, score_params=b[2]),
            make_gossipsub_phase_step(b[3], b[4], 8, score_params=b[5]), 8)


def _drive(step, st, r, first, count, lib):
    """``count`` dispatches of ``step`` from dispatch ``first`` of the
    phase schedule: rounds at r = 1, phases of r with a heartbeat each."""
    po, pt, pv = phase_schedule(N, 8 * 12)
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    kw = {} if r == 1 else dict(do_heartbeat=True)
    for i in range(first, first + count):
        sl = i if r == 1 else slice(i * r, (i + 1) * r)
        st = step(st, conv(po[sl]), conv(pt[sl]), conv(pv[sl]), **kw)
    return st


@pytest.mark.parametrize("engine", ["round", "phase-coalesced", "phase-per-plane"])
@pytest.mark.parametrize("origin", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, origin, engine):
    """A checkpoint written mid-run by one package restores in both; every
    continuation (the other package's from its restore, the writer's own
    from its restore, the writer's uninterrupted run) is equal on every
    leaf. At r = 8 the file is written at a phase boundary (tick 16)."""
    b, jstep, tstep, r = _engine(engine)
    first, more = (6, 6) if r == 1 else (2, 2)
    path = str(tmp_path / f"{origin}.npz")
    jfresh = lambda: jinit(JState.init, b[1], 64, b[0], score_params=b[2], seed=0)
    tfresh = lambda: convert.state_from_reference(reference_leaves(jfresh()), device="cpu")
    if origin == "jax":
        mid = _drive(jstep, jfresh(), r, 0, first, "jax")
        jck.save(path, mid)
        want = reference_leaves(_drive(jstep, mid, r, first, more, "jax"))
        writer_again = reference_leaves(_drive(jstep, jck.restore(path, jfresh()), r, first,
                                               more, "jax"))
        other = convert.state_leaves(_drive(tstep, tck.restore(path, tfresh()), r, first,
                                            more, "port"))
    else:
        mid = _drive(tstep, tfresh(), r, 0, first, "port")
        tck.save(path, mid, compress=False)
        want = convert.state_leaves(_drive(tstep, mid, r, first, more, "port"))
        writer_again = convert.state_leaves(_drive(tstep, tck.restore(path, tfresh()), r,
                                                   first, more, "port"))
        other = reference_leaves(_drive(jstep, jck.restore(path, jfresh()), r, first, more,
                                        "jax"))
    assert int(want[".core.tick"]) == (first + more) * r
    diff_leaves(want, writer_again, "the writer's resumed run")
    diff_leaves(want, other, "the other package's resumed run")


def _small(seed=3):
    return TSim.init(8, 16, seed=seed, k=4, device="cpu")


def _same(a, b):
    diff_leaves(convert.state_leaves(a), convert.state_leaves(b))


def test_envelope_carries_the_integrity_layer(tmp_path):
    path = str(tmp_path / "crc.npz")
    tck.save(path, _small())
    info = tck.verify(path)
    assert info == jck.verify(path)
    assert info["checksummed"] is True and info["n_leaves"] == len(convert.leaf_specs(_small()))
    with np.load(path) as data:
        assert {"__crc32__", "__header_len__", "__header_crc__"} <= set(data.files)
        assert int(data["__header_len__"]) == len(data.files)


@pytest.mark.parametrize("damage", ["truncated", "bitflip", "leaf"])
def test_damage_raises_the_typed_error(tmp_path, damage):
    """A truncated container or a flipped byte is ``CheckpointCorrupt``;
    a valid zip whose leaf bytes were rewritten under the committed CRC
    vector is caught by the per-leaf CRC, which names the leaf's path."""
    path = str(tmp_path / f"{damage}.npz")
    tck.save(path, _small())
    if damage == "leaf":
        corrupt_leaf_member(path, 2)
    else:
        raw = bytearray(open(path, "rb").read())
        if damage == "truncated":
            raw = raw[: len(raw) // 2]
        else:
            raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))
    with pytest.raises(tck.CheckpointCorrupt) as ei:
        tck.restore(path, _small(0))
    if damage == "leaf":
        assert ".msgs.topic (leaf 2)" in str(ei.value) and "CRC32 mismatch" in str(ei.value)
    if damage == "truncated":
        with pytest.raises(tck.CheckpointCorrupt):
            tck.verify(path)


def test_pre_integrity_file_loads_with_a_note(tmp_path, caplog):
    st = _small()
    legacy = {"__version__": np.int64(6)}
    leaves = convert.state_leaves(st)
    legacy["__n_leaves__"] = np.int64(len(leaves))
    for i, (p, a) in enumerate(leaves.items()):
        legacy[f"leaf_{i}"] = a
        if p in convert.KEY_LEAVES:
            legacy[f"leaf_{i}__is_key"] = np.bool_(True)
    path = str(tmp_path / "legacy.npz")
    np.savez_compressed(path, **legacy)
    with caplog.at_level(logging.INFO, logger="go_libp2p_pubsub_tpu_torch.checkpoint"):
        back = tck.restore(path, _small(0))
    _same(st, back)
    assert any("no checksum" in r.message for r in caplog.records)
    assert tck.verify(path)["checksummed"] is False


@pytest.mark.parametrize("case", ["peers", "version"])
def test_template_mismatch_stays_a_plain_value_error(tmp_path, case):
    """A template of another size names the mismatching paths; an older
    container version is refused. Neither is ``CheckpointCorrupt``."""
    path = str(tmp_path / f"{case}.npz")
    tck.save(path, _small())
    if case == "version":
        with np.load(path) as data:
            stale = {k: data[k] for k in data.files}
        stale["__version__"] = np.int64(5)
        np.savez_compressed(path, **stale)
    template = TSim.init(12, 16, seed=0, k=4, device="cpu") if case == "peers" else _small(0)
    with pytest.raises(ValueError) as ei:
        tck.restore(path, template)
    assert not isinstance(ei.value, tck.CheckpointCorrupt)
    assert ("v5 predates" in str(ei.value) if case == "version"
            else ".dlv.have (leaf 8): shape (8, 1) != template (12, 1)" in str(ei.value))


@pytest.mark.parametrize("compress", [True, False])
def test_save_roundtrips(tmp_path, compress):
    st = _small(5)
    path = str(tmp_path / "raw")
    tck.save(path, st, compress=compress)
    assert tck.verify(path)["checksummed"] is True
    back = tck.restore(path, _small(0))
    _same(st, back)
    assert back.key.dtype == torch.int64


def test_key_of_another_impl_is_refused(tmp_path):
    """A JAX checkpoint whose key is an ``unsafe_rbg`` key (4 words) does
    not fit the port's threefry key (2 words): refused, the key's path
    named."""
    jst = jinit(JSim.init, 8, 16, seed=0, k=4)
    jst = jst.replace(key=jax.random.key(0, impl="unsafe_rbg"))
    path = str(tmp_path / "rbg.npz")
    jck.save(path, jst)
    with pytest.raises(ValueError, match=r"\.key \(leaf 1\): key data shape \(4,\)"):
        tck.restore(path, _small(0))
