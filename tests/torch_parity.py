"""Shared helpers of the port's parity tests: the JAX package's state as
schema-path leaves, the bench-default GossipSub builds of both packages on
the same small topology (the banded lattice by default), the phase engines
of both run side by side (``phases_against_reference``), and the hazard
inputs of the redesigned kernels (``hazard_rows`` for select_topk,
``hazard_graph`` for csr_delivery, ``hazard_bands`` with
``hazard_exchange_args`` / ``hazard_fused_args`` / ``hazard_banded_args``
for edge_exchange, fused_delivery and delivery_banded), made with numpy
from a seed.

Importing this module imports no JAX: the card-only kernel tests and
chip_smoke.py use the hazard builders on machines without the JAX stack.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

if "pytest" in sys.modules:
    # one torch thread a test process: the parity tensors are small, and
    # six xdist workers each running torch's default pool (a thread a core)
    # on the same cores spend more time waiting than computing; scripts
    # that import this module (chip_smoke.py) keep torch's default. No test
    # takes a gradient, so autograd's bookkeeping is off too (a step's ops
    # dispatch about 15% faster on the CPU)
    import torch

    torch.set_num_threads(1)
    torch.set_grad_enabled(False)

#: the widths the select_topk hazard tests cover: the one-lane, sub-warp,
#: warp and multi-slot layouts and both sides of each boundary
HAZARD_K = (1, 16, 17, 32, 33, 64, 65, 256)

#: (M, W) pairs of the csr_delivery hazard graph: W = 1, 2, 3 and an M
#: that is not a multiple of 32
HAZARD_M = (20, 64, 96)

#: the slots of the banded hazard tests: HAZARD_M and W = 10, past the 8
#: words a block of the banded kernels takes (grid.y splits the row)
HAZARD_BAND_M = HAZARD_M + (300,)

#: the words a slot of the edge_exchange hazard tests: one word, the phase
#: engine's data words (W = 2: one 8-byte vector), an odd count (4-byte
#: words), one 16-byte vector, the phase engine's control head at W = 2
#: (three 8-byte vectors), and the PX widths at W = 2 (``PX_C``)
HAZARD_C = (1, 2, 3, 4, 5, 6, 7)

#: the control widths with the px lane at one topic and W = 2: the
#: per-round step's graft | prune | ihave | px (5) and the phase head's
#: graft | prune | ihave | px | window (7), odd (4-byte words); their
#: hazard live masks are symmetric over the involution, as PX's are
PX_C = (5, 7)

#: score parameters under which the GossipSub step makes float32
#: subnormals (tests/test_torch_subnormal.py, chip_smoke.py): overrides of
#: the bench's TopicScoreParams (``topic``), PeerScoreParams (``peer``) and
#: PeerScoreThresholds (``thresholds``), and the peers of one P6 ip group
_NEGATIVE = dict(
    topic=dict(time_in_mesh_weight=0.0, first_message_deliveries_weight=0.0,
               mesh_message_deliveries_weight=-1e-42, mesh_failure_penalty_weight=-1e-42,
               invalid_message_deliveries_weight=-1e-42),
    peer=dict(ip_colocation_factor_weight=-1e-42, behaviour_penalty_weight=-1e-42),
    ip_group_size=3)
SUBNORMAL_CELLS = {
    # P1 and P2 weights of 1e-40, the other topic terms as the bench has them
    "positive": dict(topic=dict(time_in_mesh_weight=1e-40,
                                first_message_deliveries_weight=1e-40)),
    # P3, P3b, P4, P6 and P7 weights of -1e-42, P1 and P2 off
    "negative": _NEGATIVE,
    # decay_to_zero 1e-40 and counter decays of 1e-20: a counter is
    # subnormal at its second decay
    "decay": dict(topic=dict(first_message_deliveries_decay=1e-20,
                             mesh_message_deliveries_weight=-1.0,
                             mesh_message_deliveries_decay=1e-20,
                             mesh_failure_penalty_weight=-1.0,
                             mesh_failure_penalty_decay=1e-20),
                  peer=dict(decay_to_zero=1e-40, behaviour_penalty_decay=1e-20)),
    # a topic score cap and P2 and P3 counter caps of 1e-40, which clamp at
    # zero: P1's positive scores to 0.0, fmd and mmd to 0.0 (P3 on, so its
    # deficit passes the cap as a negative score)
    "caps": dict(topic=dict(first_message_deliveries_cap=1e-40,
                            mesh_message_deliveries_weight=-1.0,
                            mesh_message_deliveries_cap=1e-40),
                 peer=dict(topic_score_cap=1e-40)),
    # the negative weights at gossip, publish, graylist and
    # opportunistic-graft thresholds of 0.0
    "zero_thresholds": dict(_NEGATIVE, thresholds=dict(
        gossip_threshold=0.0, publish_threshold=0.0, graylist_threshold=0.0,
        opportunistic_graft_threshold=0.0)),
}


def subnormal_overrides(cell: str, n: int) -> dict:
    """``SUBNORMAL_CELLS[cell]`` as ``bench_builds`` keywords for N peers
    (the ip groups as an [N] array)."""
    ov = dict(SUBNORMAL_CELLS[cell])
    size = ov.pop("ip_group_size", None)
    ov["ip_group"] = None if size is None else np.arange(n, dtype=np.int32) // size
    return ov


#: (score_enabled, want_cohorts, retrans_cap) under which fused_delivery's
#: hazard checks run: every cap 0-3, the cohort planes and scores on and off
FUSED_CONFIGS = ((True, True, 0), (True, False, 1), (False, True, 2), (False, False, 3),
                 (True, True, 3), (False, True, 0))


def hazard_rows(seed: int, r: int, k: int):
    """select_topk arguments as numpy arrays (values f32, mask bool, k_rows
    i32, noise f32) holding the hazards of its order: masked +-inf and NaN
    values, NaN noise, subnormal values and noise of both signs (which rank
    as zeros), ties and signed zeros; a row with no slot
    masked, one with every slot masked, one whose slots are all equal, one
    of masked -inf values only and one with a single masked -inf beside
    unmasked slots; masks from empty to full; widths from -1 to K + 1
    (every one of them on the first rows)."""
    rng = np.random.default_rng(seed)
    pool = np.array([-np.inf, np.inf, np.nan, -0.0, 0.0, 1e-45, -1e-45, 1e-40,
                     -1e-38, 0.5, -1.5, 2.0], np.float32)
    values = rng.choice(pool, size=(r, k)).astype(np.float32)
    noise = rng.choice(np.array([-0.0, 0.0, 0.25, 0.5, np.nan, 1e-45, -1e-45, 1e-39],
                                np.float32), size=(r, k)).astype(np.float32)
    mask = rng.random((r, k)) < rng.random((r, 1))
    # every other row NaN-free: the kernel ranks those by ordered keys
    calm = np.arange(r) % 2 == 0
    values[calm] = np.where(np.isnan(values[calm]), np.float32(0.5), values[calm])
    noise[calm] = np.where(np.isnan(noise[calm]), np.float32(0.25), noise[calm])
    special = [
        (np.zeros(k, bool), None, None),                      # none masked
        (np.ones(k, bool), None, None),                       # all masked
        (np.ones(k, bool), np.float32(1.0), np.float32(0.0)),  # all equal
        (np.ones(k, bool), np.float32(-np.inf), None),        # masked -inf only
    ]
    for i, (mk, v, q) in enumerate(special[:r]):
        mask[i] = mk
        if v is not None:
            values[i] = v
        if q is not None:
            noise[i] = q
    if r > 4:   # one masked -inf among unmasked slots
        mask[4] = False
        mask[4, k // 2] = True
        values[4, k // 2] = -np.inf
    k_rows = rng.integers(-1, k + 2, size=(r,)).astype(np.int32)
    widths = np.arange(-1, k + 2)
    room = max(0, r - 5)
    if len(widths) > room:   # too few rows for every width: both ends
        widths = np.concatenate([widths[:room // 2], widths[len(widths) - (room - room // 2):]])
    k_rows[5:5 + len(widths)] = widths
    return values, mask, k_rows, noise


def hazard_graph(seed: int = 0, n: int = 300, long_row: int = 0) -> dict:
    """A CSR edge space (numpy, the fields ``ops/csr.build_csr`` gives)
    holding the hazards of csr_delivery: empty rows (the first, the last and
    runs of them), rows of exactly 1, 31, 32, 33 and 64 edges, a run of
    64-edge rows longer than one batch of the kernel, rows on both sides of
    every 32-row warp boundary, and N not a multiple of 32 or 128. With
    ``long_row`` one row has that many edges. E is a multiple of 64, so the
    JAX package's three-call Pallas form takes it with blocks of 64 or
    more. ``col`` is random and ``eperm`` a random involution of the flat
    edges (the kernels only gather through them)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, size=n)
    deg[0] = deg[n - 1] = 0
    deg[1:8] = (1, 31, 32, 33, 64, 0, 0)
    deg[40:45] = 64                                    # > one batch of a warp
    for b in range(32, n, 32):                         # warp boundaries
        deg[b - 1], deg[b] = rng.choice([0, 1, 33, 64], size=2)
    if long_row:
        deg[100] = long_row
    cap = int(deg.max())
    deg[n - 2] = (-int(deg.sum()) - 64 + int(deg[n - 2])) % 64 or 64
    # the last row but one may exceed cap by the rounding; spread it
    while deg[n - 2] > cap:
        i = int(rng.integers(8, 32))
        if deg[i] < cap:
            deg[i] += 1
            deg[n - 2] -= 1
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(row_ptr[-1])
    row = np.repeat(np.arange(n), deg).astype(np.int32)
    perm = rng.permutation(e)
    eperm = np.empty(e, np.int64)
    eperm[perm[0::2][: e // 2]] = perm[1::2][: e // 2]
    eperm[perm[1::2][: e // 2]] = perm[0::2][: e // 2]
    if e % 2:
        eperm[perm[-1]] = perm[-1]
    seg_start = np.ones(e, bool)
    seg_start[1:] = row[1:] != row[:-1]
    return {
        "n": n, "e": e, "cap": cap, "row_ptr": row_ptr,
        "col": rng.integers(0, n, size=e).astype(np.int32), "row": row,
        "eperm": eperm.astype(np.int32), "seg_start": seg_start,
        "row_last": np.maximum(np.searchsorted(row, np.arange(n), side="right") - 1,
                               0).astype(np.int32),
        "row_nonempty": deg > 0,
    }


def hazard_planes(seed: int, n: int, e: int, m: int) -> dict:
    """Random words for one csr_delivery round on an edge space of E edges
    (numpy, uint32 words; the padding bits of the last word random too)."""
    rng = np.random.default_rng(seed)
    w = (m + 31) // 32
    u32 = lambda *shape: rng.integers(0, 1 << 32, size=shape,
                                      dtype=np.uint64).astype(np.uint32)
    return {
        "fwd": u32(n, w), "fe_e": u32(e, w), "mask_e": u32(e, w), "not_mine": u32(n, w),
        "have": u32(n, w), "first_round": rng.integers(-1, 50, size=(n, m)).astype(np.int32),
        "valid_row": u32(1, w), "tick": np.int32(9),
        "link_ok_e": rng.random(e) < 0.7,
    }


def _band(name: str, n: int, steps) -> dict:
    """A banded topology from signed ring steps: offsets mod N and each
    edge's reverse slot (the slot holding the opposite step)."""
    off = tuple(int(s) % n for s in steps)
    return {"name": name, "n": n, "offsets": off,
            "revs": tuple(off.index((n - o) % n) for o in off)}


def _ring(n: int, d: int) -> dict:
    return _band(f"ring N={n} K={2 * d}", n, [s for i in range(1, d + 1) for s in (i, -i)])


def hazard_bands() -> list:
    """The banded topologies of the hazard tests of fused_delivery and
    delivery_banded: ring lattices with K = 2, 6, 16, 24 and 40 (K = 24
    and 40 are past fused_delivery's K <= 16; K = 40 is past one 32-edge
    chunk of delivery_banded), N not a multiple of the kernels' 64-row
    block, an N smaller than the staged window (N=17 at K=16: a block's
    window of 17 + 16 rows wraps past N), and a symmetric circulant on
    N=1000 with steps +-1, +-333 and 500 = N/2 (its own reverse), whose wide
    steps lie beyond any block's halo. Pair each with ``HAZARD_BAND_M``."""
    return [_ring(100, 1), _ring(300, 3), _ring(1000, 8), _ring(17, 8), _ring(250, 12),
            _ring(200, 20),
            _band("circulant N=1000 steps 1, 333, 500", 1000, (1, -1, 333, -333, 500))]


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def hazard_exchange_args(seed: int, band: dict, c: int) -> list:
    """edge_exchange's array arguments on ``band`` (numpy, in the wrapper's
    order: wire_pack [N, K*C], scores [N, K], live [N, K]), C words a
    slot: random words, a fifth of the edges dead (at the ``PX_C`` widths
    an edge dead at either end, so the mask is symmetric over the
    involution), and scores that hold -0.0, subnormals of both signs (which
    the exchange copies bit for bit) and NaN."""
    rng = np.random.default_rng(seed)
    n, k = band["n"], len(band["offsets"])
    score = rng.normal(0.0, 20.0, size=(n, k)).astype(np.float32)
    pick = rng.integers(0, 10, size=(n, k))
    for i, v in enumerate((-0.0, 1e-45, -1e-45, 1e-40, -1e-39, np.nan)):
        score[pick == i] = v
    wire = _u32(rng, n, k * c)
    live = rng.random((n, k)) < 0.8
    if c in PX_C:
        sender = (np.arange(n)[:, None] + np.asarray(band["offsets"])[None, :]) % n
        live = live & live[sender, np.asarray(band["revs"])[None, :]]
    return [wire, score, live.astype(np.uint32)]


def dead_peers_live(seed: int, band: dict, frac: float = 0.1) -> np.ndarray:
    """[N, K] uint32 live words of ``band`` with whole peers dead, as a
    churn round leaves them: a ``frac`` of the peers are down, so their
    rows and the mirrored columns (every edge whose far end is down) are 0,
    and every other edge is live."""
    rng = np.random.default_rng(seed)
    n = band["n"]
    down = np.zeros(n, bool)
    down[rng.choice(n, max(1, int(frac * n)), replace=False)] = True
    far = (np.arange(n)[:, None] + np.asarray(band["offsets"])[None, :]) % n
    return (~down[:, None] & ~down[far]).astype(np.uint32)


def with_dead_peers(seed: int, band: dict, flags: np.ndarray) -> np.ndarray:
    """fused_delivery's [N, K] flag words with F_LIVE (bit 4) cleared on
    the edges of ``dead_peers_live``'s down peers, rows and columns."""
    return np.where(dead_peers_live(seed, band) == 0, flags & ~np.int32(1 << 4),
                    flags).astype(np.int32)


def hazard_fused_args(seed: int, band: dict, m: int) -> list:
    """fused_delivery's array arguments on ``band`` (numpy, in the
    wrapper's order: carry_out .. valid_row), M slots a row: random words
    (fe, served_hi, have and origin sparse, joined dense), every pattern of
    the five flag bits, and neighbour scores that sit on the bench
    thresholds (-10, -50), at -0.0 and at subnormals of both signs."""
    rng = np.random.default_rng(seed)
    n, k, w = band["n"], len(band["offsets"]), (m + 31) // 32
    sparse = lambda *sh: _u32(rng, *sh) & _u32(rng, *sh) & _u32(rng, *sh)
    score = rng.normal(0.0, 20.0, size=(n, k)).astype(np.float32)
    pick = rng.integers(0, 8, size=(n, k))
    for i, v in enumerate((-10.0, -50.0, -0.0, 1e-45, -1e-45)):
        score[pick == i] = v
    return [_u32(rng, n, k * w), sparse(n, k * w), _u32(rng, n, w), _u32(rng, n, w), score,
            _u32(rng, n, k * w), _u32(rng, n, k * w), sparse(n, k * w),
            rng.integers(0, 32, size=(n, k)).astype(np.int32), sparse(n, w), sparse(n, w),
            ~sparse(n, w), _u32(rng, 1, w)]


def hazard_banded_args(seed: int, band: dict, m: int, first_edge=None) -> list:
    """delivery_banded's array arguments on ``band`` (numpy, in the
    wrapper's order: fwd, fe, emask, not_mine, have, first_round,
    valid_row, tick), M slots a row, the padding bits of the last word
    clear. ``first_edge(int8 [N, M]) -> fe words [N, K*W]`` builds fe as
    the one-hot form a round leaves (the JAX kernel's int8 first-edge
    plane); without it fe is random words."""
    rng = np.random.default_rng(seed)
    n, k, w = band["n"], len(band["offsets"]), (m + 31) // 32
    pad = np.uint32((1 << (m % 32)) - 1) if m % 32 else np.uint32(0xFFFFFFFF)

    def words(*sh):
        x = _u32(rng, *sh, w)
        x[..., -1] &= pad
        return x.reshape(sh[:-1] + (sh[-1] * w,)) if len(sh) > 1 else x

    fe8 = rng.integers(-1, k, size=(n, m)).astype(np.int8)
    fe = words(n, k) if first_edge is None else np.asarray(first_edge(fe8))
    return [words(n), fe, words(n, k), words(n), words(n),
            rng.integers(-1, 50, size=(n, m)).astype(np.int32), words(1), np.int32(11)]


def package_modules(side: str, names) -> "types.SimpleNamespace":
    """One package's modules by dotted name under its root (``"api"``,
    ``"trace.sinks"``), keyed by their last component, for a script
    written once against both packages; ``side`` is "jax" or "port", and
    ``net_kw`` the keywords the package's ``api.Network`` takes to run on
    the CPU."""
    import importlib
    import types

    root = "go_libp2p_pubsub_tpu" if side == "jax" else "go_libp2p_pubsub_tpu_torch"
    mods = {m.split(".")[-1]: importlib.import_module(f"{root}.{m}") for m in names}
    return types.SimpleNamespace(side=side, net_kw={} if side == "jax" else {"device": "cpu"},
                                 **mods)


def reference_leaves(jst) -> dict:
    """{schema path: numpy array} of a JAX state tree (keys as key_data)."""
    import jax
    import jax.numpy as jnp

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jst)[0]:
        if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


def diff_leaves(ref: dict, got: dict, where: str = "") -> None:
    """Assert the two leaf dicts hold the same paths, dtypes, shapes and
    bits (float leaves compared bitwise, so -0.0 != 0.0)."""
    assert sorted(ref) == sorted(got), (sorted(set(ref) ^ set(got)), where)
    for p in ref:
        a, b = ref[p], got[p]
        assert a.dtype == b.dtype and a.shape == b.shape, (p, a.dtype, b.dtype,
                                                           a.shape, b.shape, where)
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        if not np.array_equal(a, b):
            bad = np.argwhere(a != b)
            raise AssertionError(
                f"{where}: leaf {p} differs at {len(bad)} entries, first "
                f"{bad[:3].tolist()}: {a[tuple(bad[0])]} vs {b[tuple(bad[0])]}")


#: JAX runs shared between the cases of a test file: the reference's leaves
#: after every dispatch, densified, by the key its cases pass as ``share``
_TRAILS: dict = {}


def dense_reference_leaves(jnet, jst) -> dict:
    """``reference_leaves`` of a JAX GossipSub state in its dense form (a
    CSR-resident state's flat planes unpacked)."""
    if jnet.edge_layout == "csr":
        from go_libp2p_pubsub_tpu.state import densify_edge_planes as jdensify

        jst = jdensify(jnet, jst)
    return reference_leaves(jst)


def dense_port_leaves(tnet, tst) -> dict:
    """``convert.state_leaves`` of a port GossipSub state in its dense form.
    The unpacking is injective (each flat entry lands on its own slot), so
    equal dense forms mean equal flat planes."""
    from go_libp2p_pubsub_tpu_torch import convert
    from go_libp2p_pubsub_tpu_torch.state import densify_edge_planes

    if tnet.edge_layout == "csr":
        tst = densify_edge_planes(tnet, tst)
    return convert.state_leaves(tst)


def jinit(init, *args, **kw):
    """``init(*args, **kw)`` (a JAX package's state init:
    ``GossipSubState.init``, ``SimState.init``) jitted: one compile of the
    whole init instead of an eager compile per op for every new shape. The
    same leaves: an init fills, copies and keys, and its one float op (the
    colocation square) has nothing to fuse with."""
    import jax

    return jax.jit(lambda: init(*args, **kw))()


def reference_trail(share, run) -> list:
    """``run()`` (a JAX run's list of leaves after every dispatch), once a
    key: the cases of a test file that pass one ``share`` key run the same
    JAX config, net and schedule up to the layout (a CSR build's run
    densified equals the dense build's, the JAX package's own CSR parity),
    so the first case's run serves them all. ``share=None`` runs it."""
    if share is None:
        return run()
    if share not in _TRAILS:
        _TRAILS[share] = run()
    return _TRAILS[share]


def phase_schedule(n: int, rounds: int, codes: bool = False, my_topics=None,
                   n_topics: int = 0):
    """The phase parity tests' publish schedule (numpy, seed 0): 4
    publishes a round from random origins, one of them invalid and one slot
    empty, on topic 0, or with ``my_topics`` (the [N, S] slot table) on a
    random topic of the origin's own. With ``n_topics`` as well, the last
    two publishes of every round go to a uniform topic of the universe
    instead (mostly one the origin has not joined: fanout). With ``codes``
    the verdicts are int32 verdict codes (0 accept, 1 reject, 2 ignore) and
    one more publish is ignored."""
    rng = np.random.default_rng(0)
    po = rng.integers(0, n, size=(rounds, 4)).astype(np.int32)
    pt = np.zeros((rounds, 4), np.int32)
    if my_topics is not None:
        slots = (my_topics >= 0).sum(1)
        pick = (rng.random((rounds, 4)) * slots[po]).astype(np.int64)
        pt = my_topics[po, pick].astype(np.int32)
        if n_topics:
            pt[:, 2:] = rng.integers(0, n_topics, size=(rounds, 2))
    pv = np.ones((rounds, 4), bool)
    pv[5, 1] = False   # one invalid publish
    po[9, 3] = -1      # and one empty publish slot
    if codes:
        pv = np.where(pv, 0, 1).astype(np.int32)
        pv[7, 2] = 2   # an ignored publish
    return po, pt, pv


def phases_against_reference(builds, r: int, he: int, rounds: int, codes: bool = False,
                             fanout_topics: bool = False, schedule=None, observe=None,
                             dormant=None, up=None, blacklist=None, plane=None,
                             wire_block: bool = False, deny=None, telemetry=None, share=None,
                             **kw):
    """Run the JAX package's phase step and the port's (on the CPU) over
    ``rounds`` rounds of ``phase_schedule`` in phases of ``r`` from the same
    state, heartbeats as ``heartbeat_schedule(he, r)`` flags them, every
    leaf compared bit for bit after every phase. ``builds`` is
    ``bench_builds``' tuple; ``codes`` takes int verdict codes;
    ``fanout_topics`` sends half the publishes to any topic of the universe
    (``phase_schedule``'s ``n_topics``); ``schedule`` replaces the schedule
    with (po, pt, pv); ``observe(state)`` sees the port's state after every
    phase; ``dormant`` marks the [N, K] dormant edges of both initial
    states. ``up`` ([rounds, N] bool) is a ``dynamic_peers`` step's
    liveness schedule (a phase takes the row of its first round) and
    ``blacklist`` ({phase: [N] bool}) sets both states' blacklist before
    that phase. ``plane`` is a lifted step's (JAX plane, port plane) pair,
    or a function of the phase index giving one, passed last to every call.
    ``wire_block`` gives both initial states the transmit-block plane.
    ``deny`` ([rounds, N, K] bool) is a scheduled chaos step's deny plane (a
    phase takes its head's row). ``telemetry`` is a (JAX, port)
    TelemetryConfig pair: both initial states carry the panel and both
    steps record it. ``kw`` goes to both packages'
    make_gossipsub_phase_step, beside the builds' own step options (an
    attack plane rides those: ``builds.jkw``/``builds.tkw``). ``share`` (a
    key) lets the cases of a file that differ only in the layout share one
    JAX run (``reference_trail``): the leaves are compared dense. Returns
    the port's final state."""
    import jax.numpy as jnp
    import torch

    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
    from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake

    from go_libp2p_pubsub_tpu_torch import convert
    from go_libp2p_pubsub_tpu_torch.driver import heartbeat_schedule
    from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step

    from go_libp2p_pubsub_tpu.models.gossipsub import set_blacklist as jset

    from go_libp2p_pubsub_tpu_torch.models.gossipsub import set_blacklist as tset

    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    # a fresh JAX state: the JAX step donates its buffers
    jt, tt = telemetry or (None, None)
    jst = jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=0, dormant=dormant,
                wire_block=wire_block, telemetry=jt)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    diff_leaves(reference_leaves(jst), convert.state_leaves(tst), "init")
    jkw, tkw = step_options(builds)
    if telemetry is not None:
        jkw, tkw = dict(jkw, telemetry=jt), dict(tkw, telemetry=tt)
    tstep = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp, **tkw, **kw)
    my_topics = tnet.my_topics.numpy() if tnet.n_topics > 1 else None
    po, pt, pv = schedule or phase_schedule(
        tnet.n_peers, rounds, codes, my_topics, tnet.n_topics if fanout_topics else 0)
    flags = heartbeat_schedule(he, r)

    def rows(p):
        jx, tx = (), ()
        if up is not None:
            jx, tx = (jnp.asarray(up[p * r]),), (torch.from_numpy(up[p * r]),)
        if deny is not None:
            jx, tx = jx + (jnp.asarray(deny[p * r]),), tx + (torch.from_numpy(deny[p * r]),)
        if plane is not None:
            jp, tp = plane(p) if callable(plane) else plane
            jx, tx = jx + (jp,), tx + (tp,)
        return jx, tx

    def jax_run(jst=jst):
        jstep = jmake(jcfg, jnet, r, score_params=jsp, **jkw, **kw)
        trail = []
        for p in range(rounds // r):
            sl = slice(p * r, (p + 1) * r)
            if blacklist is not None and p in blacklist:
                jst = jset(jst, blacklist[p])
            jst = jstep(jst, jnp.asarray(po[sl]), jnp.asarray(pt[sl]), jnp.asarray(pv[sl]),
                        *rows(p)[0], do_heartbeat=flags[p % len(flags)])
            trail.append(dense_reference_leaves(jnet, jst))
        return trail

    trail = reference_trail(share, jax_run)
    for p in range(rounds // r):
        sl = slice(p * r, (p + 1) * r)
        if blacklist is not None and p in blacklist:
            tst = tset(tst, blacklist[p])
        tst = tstep(tst, torch.from_numpy(po[sl]), torch.from_numpy(pt[sl]),
                    torch.from_numpy(pv[sl]), *rows(p)[1], do_heartbeat=flags[p % len(flags)])
        diff_leaves(trail[p], dense_port_leaves(tnet, tst), f"phase {p}")
        if observe is not None:
            observe(tst)
    return tst


class Builds(tuple):
    """``bench_builds``' 6-tuple, carrying the step options of each
    package (``step_options``) as attributes."""


def step_options(builds) -> tuple:
    """(JAX kwargs, port kwargs) of both packages' step builders: the
    gater parameters and the adversary vector of the builds."""
    return getattr(builds, "jkw", {}), getattr(builds, "tkw", {})


def bench_builds(n=96, d=4, msg_slots=64, heartbeat_every=1,
                 count_events=True, seed=0, topologies=None,
                 edge_layout="dense", fused=False, topic=None, peer=None,
                 thresholds=None, ip_group=None, subscriptions=None,
                 config="default", fanout_slots=0, fanout_ttl=None, gater=None,
                 validation_capacity=0, adversary=None, queue_cap=0,
                 validation_delay_rounds=0, validation_delay_topic=None,
                 params=None, options=None, direct=None, dynamic=False, chaos=None,
                 router=None):
    """(jax_cfg, jax_net, sp, torch_cfg, torch_net, torch_sp) for the
    bench's params on ring_lattice(n, d), or on ``topologies``, a
    (JAX Topology, port Topology) pair of the same graph, in
    ``edge_layout`` with the ``fused`` flag on both the net and the
    config. ``topic``, ``peer`` and ``thresholds`` are field overrides of
    the bench's TopicScoreParams, PeerScoreParams and PeerScoreThresholds,
    and ``ip_group`` the nets' [N] P6 colocation groups, on both sides.
    ``subscriptions`` is the JAX package's Subscriptions (default: every
    peer in one topic); a topic universe of T scores T bench topics.
    ``config`` picks the bench config's score parameters; ``fanout_slots``
    and ``fanout_ttl`` (seconds) size the fanout plane; ``gater`` (a dict
    of PeerGaterParams overrides, {} for the defaults) turns the peer gater
    on; ``validation_capacity`` the throttle; ``adversary`` ([N] bool) the
    no-forward vector; ``queue_cap``, ``validation_delay_rounds`` and
    ``validation_delay_topic`` the delivery core's options. ``params``
    overrides GossipSubParams fields (``do_px``, ``direct_connect_ticks``,
    the degrees), ``options`` config fields after the build
    (``edge_liveness``, ``trace_exact``, ``narrow_counters``), and
    ``direct`` is the nets' [N, K] direct edges; ``dynamic`` builds both
    nets for the mutable overlay; ``chaos`` (a dict of ChaosConfig fields)
    turns each package's link-fault plane on, ``router`` (a dict of
    RouterConfig fields) its router plane. The step options ride the
    result (``step_options``)."""
    from go_libp2p_pubsub_tpu import config as jconfig
    from go_libp2p_pubsub_tpu import graph as jgraph
    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
    from go_libp2p_pubsub_tpu.perf.sweep import bench_score_params as jbsp
    from go_libp2p_pubsub_tpu.state import Net as JNet

    from go_libp2p_pubsub_tpu_torch import config as tconfig
    from go_libp2p_pubsub_tpu_torch import graph as tgraph
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg
    from go_libp2p_pubsub_tpu_torch.perf.sweep import bench_score_params as tbsp
    from go_libp2p_pubsub_tpu_torch.state import Net as TNet

    if topologies is None:
        topologies = jgraph.ring_lattice(n, d=d), tgraph.ring_lattice(n, d=d)
    layout = dict(edge_layout=edge_layout, fused=fused)
    core = dict(queue_cap=queue_cap, validation_delay_rounds=validation_delay_rounds,
                validation_delay_topic=validation_delay_topic)

    def score(sp):
        topics = {t: dataclasses.replace(tp, **(topic or {})) for t, tp in sp.topics.items()}
        return dataclasses.replace(sp, topics=topics, **(peer or {}))

    if chaos is not None:
        from go_libp2p_pubsub_tpu.chaos import ChaosConfig as JChaos

        from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig as TChaos

        jcore, tcore = dict(core, chaos=JChaos(**chaos)), dict(core, chaos=TChaos(**chaos))
    else:
        jcore = tcore = core
    if router is not None:
        from go_libp2p_pubsub_tpu.routers import RouterConfig as JRouter

        from go_libp2p_pubsub_tpu_torch.routers import RouterConfig as TRouter

        jcore, tcore = dict(jcore, router=JRouter(**router)), dict(tcore, router=TRouter(**router))
    if subscriptions is None:
        subscriptions = jgraph.subscribe_all(n, 1)
    n_topics = subscriptions.subscribed.shape[1]
    tsubs = tgraph.Subscriptions(*(np.asarray(getattr(subscriptions, f)) for f in (
        "subscribed", "my_topics", "slot_of")))
    params = {"flood_publish": False, **(params or {})}
    if fanout_ttl is not None:
        params["fanout_ttl"] = fanout_ttl
    jgp = None if gater is None else jconfig.PeerGaterParams(**gater)
    tgp = None if gater is None else tconfig.PeerGaterParams(**gater)
    jnet = JNet.build(topologies[0], subscriptions, ip_group=ip_group, direct=direct,
                      dynamic=dynamic, **layout)
    jcfg = JCfg.build(dataclasses.replace(jconfig.GossipSubParams(), **params),
                      jconfig.PeerScoreThresholds(**(thresholds or {})), score_enabled=True,
                      heartbeat_every=heartbeat_every, gater_params=jgp,
                      validation_capacity=validation_capacity, **layout, **jcore)
    jcfg = dataclasses.replace(jcfg, count_events=count_events, fanout_slots=fanout_slots,
                               **(options or {}))
    jsp = score(jbsp(config, n_topics)[1])
    tnet = TNet.build(topologies[1], tsubs, ip_group=ip_group, direct=direct,
                      device="cpu", dynamic=dynamic, **layout)
    tcfg = TCfg.build(dataclasses.replace(tconfig.GossipSubParams(), **params),
                      tconfig.PeerScoreThresholds(**(thresholds or {})), score_enabled=True,
                      heartbeat_every=heartbeat_every, gater_params=tgp,
                      validation_capacity=validation_capacity, **layout, **tcore)
    tcfg = dataclasses.replace(tcfg, count_events=count_events, fanout_slots=fanout_slots,
                               **(options or {}))
    tsp = score(tbsp(config, n_topics)[1])
    out = Builds((jcfg, jnet, jsp, tcfg, tnet, tsp))
    out.jkw, out.tkw = {}, {}
    if gater is not None:
        out.jkw["gater_params"], out.tkw["gater_params"] = jgp, tgp
    if adversary is not None:
        out.jkw["adversary_no_forward"] = out.tkw["adversary_no_forward"] = np.asarray(
            adversary, bool)
    return out


def rounds_against_reference(builds, rounds: int, codes: bool = False,
                             fanout_topics: bool = False, schedule=None,
                             static_heartbeat: bool = False, observe=None, dormant=None,
                             up=None, writes=None, blacklist=None, step_kw=None,
                             dynamic_topo: bool = False, plane=None,
                             wire_block: bool = False, deny=None, app_score=None,
                             telemetry=None, seed: int = 0, msg_slots: int = 64,
                             share=None):
    """The per-round counterpart of ``phases_against_reference``: both
    packages' per-round steps from the same state over ``rounds`` rounds,
    every leaf compared bit for bit after every round. ``up`` ([rounds, N]
    bool) and ``writes`` ([rounds, B, 4] int32) are the liveness and
    mutation rows of a ``dynamic_peers`` / ``dynamic_topo`` step (both
    packages' states then carry the overlay), ``blacklist`` ({round: [N]
    bool}) sets both blacklists before that round, ``step_kw`` goes to both
    step builders, ``plane`` is a lifted step's (JAX plane, port plane)
    pair or a function of the round giving one, ``wire_block`` gives both
    initial states the transmit-block plane, ``deny`` ([rounds, N, K] bool)
    is a scheduled chaos step's deny plane (its row rides between ``up`` and
    ``writes``), ``app_score`` ([N] f32) both initial states' P5 plane,
    ``telemetry`` a (JAX, port) TelemetryConfig pair both states and steps
    record with, ``seed`` and ``msg_slots`` the initial states', ``share``
    a key of a JAX run the cases of a file share (``reference_trail``;
    leaves compared dense). Returns the port's final state."""
    import jax.numpy as jnp
    import torch

    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
    from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake

    from go_libp2p_pubsub_tpu_torch import convert
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step

    from go_libp2p_pubsub_tpu.models.gossipsub import set_blacklist as jset

    from go_libp2p_pubsub_tpu_torch.models.gossipsub import set_blacklist as tset

    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    jt, tt = telemetry or (None, None)
    jst = jinit(JState.init, jnet, msg_slots, jcfg, score_params=jsp, seed=seed,
                dormant=dormant, dynamic_topo=dynamic_topo, wire_block=wire_block,
                app_score=app_score, telemetry=jt)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    jkw, tkw = step_options(builds)
    if telemetry is not None:
        jkw, tkw = dict(jkw, telemetry=jt), dict(tkw, telemetry=tt)
    step_kw = step_kw or {}
    tstep = make_gossipsub_step(tcfg, tnet, score_params=tsp,
                                static_heartbeat=static_heartbeat, **tkw, **step_kw)
    my_topics = tnet.my_topics.numpy() if tnet.n_topics > 1 else None
    po, pt, pv = schedule or phase_schedule(
        tnet.n_peers, rounds, codes, my_topics, tnet.n_topics if fanout_topics else 0)
    he = tcfg.heartbeat_every
    hb = lambda t: {"do_heartbeat": t % he == 0} if static_heartbeat and he > 1 else {}
    extra = lambda t: [a[t] for a in (up, deny, writes) if a is not None]
    planes = lambda t: ((), ()) if plane is None else tuple(
        (x,) for x in (plane(t) if callable(plane) else plane))

    def jax_run(jst=jst):
        jstep = jmake(jcfg, jnet, score_params=jsp, static_heartbeat=static_heartbeat, **jkw,
                      **step_kw)
        trail = []
        for t in range(rounds):
            if blacklist is not None and t in blacklist:
                jst = jset(jst, blacklist[t])
            jst = jstep(jst, jnp.asarray(po[t]), jnp.asarray(pt[t]), jnp.asarray(pv[t]),
                        *(jnp.asarray(a) for a in extra(t)), *planes(t)[0], **hb(t))
            trail.append(dense_reference_leaves(jnet, jst))
        return trail

    trail = reference_trail(share, jax_run)
    for t in range(rounds):
        if blacklist is not None and t in blacklist:
            tst = tset(tst, blacklist[t])
        tst = tstep(tst, torch.from_numpy(po[t]), torch.from_numpy(pt[t]),
                    torch.from_numpy(pv[t]), *(torch.from_numpy(a) for a in extra(t)),
                    *planes(t)[1], **hb(t))
        diff_leaves(trail[t], dense_port_leaves(tnet, tst), f"round {t}")
        if observe is not None:
            observe(tst)
    return tst


class FanoutLog:
    """An ``observe`` callback that counts fanout-slot events across a run:
    ``expired`` slots (a topic, then none), ``refilled`` slots (the same
    topic, more peers) and ``fresh`` ones (a new topic)."""

    def __init__(self):
        self.prev = None
        self.expired = self.refilled = self.fresh = 0

    def __call__(self, st):
        topic, peers = st.fanout_topic.clone(), st.fanout_peers.sum(-1)
        if self.prev is not None:
            t0, p0 = self.prev
            self.expired += int(((t0 >= 0) & (topic < 0)).sum())
            self.refilled += int(((t0 >= 0) & (topic == t0) & (peers > p0)).sum())
            self.fresh += int(((topic >= 0) & (topic != t0)).sum())
        self.prev = (topic, peers)


def graph_replay_equals_eager(fn) -> int:
    """Call ``fn()`` (a kernel wrapper on CUDA tensors) eagerly, then capture
    the same call alone in a CUDA graph (after a warm-up call on a side
    stream, as ``torch.cuda.graphs`` asks), clear its outputs and replay it.
    Raises unless the replay writes the eager outputs bit for bit; returns
    the wrapper launches counted during the capture."""
    import torch

    from go_libp2p_pubsub_tpu_torch.driver import launch_counts

    def flat(out):
        if isinstance(out, dict):
            return [out[k] for k in sorted(out)]
        if isinstance(out, (tuple, list)):
            return [t for t in out if t is not None]
        return [out]

    want = [t.clone() for t in flat(fn())]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = sum(launch_counts().values())
    with torch.cuda.graph(graph):
        got = flat(fn())
    launched = sum(launch_counts().values()) - before
    for t in got:   # cleared to what the kernel would not write
        t.fill_(True if t.dtype == torch.bool else 0)
    graph.replay()
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"the replay returned {len(got)} outputs, eager {len(want)}")
    for i, (a, b) in enumerate(zip(want, got)):
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"output {i} of the replayed graph differs from the eager call")
    return launched


#: the JAX lift test's ``second_plane`` moves (tests/test_score_lift.py):
#: TopicScoreParams, PeerScoreParams and PeerScoreThresholds overrides that
#: move every lifted surface away from the bench's values
SECOND_PLANE = dict(
    topic=dict(first_message_deliveries_weight=2.0, mesh_message_deliveries_weight=-0.25,
               time_in_mesh_weight=0.5, invalid_message_deliveries_weight=-0.5),
    peer=dict(behaviour_penalty_weight=-2.0, topic_score_cap=50.0),
    thresholds=dict(gossip_threshold=-4.0, publish_threshold=-20.0, graylist_threshold=-40.0,
                    accept_px_threshold=5.0, opportunistic_graft_threshold=10.0))


def lifted_planes(builds, mesh: bool = False, moves=None, degrees=None):
    """(JAX plane, port plane) for a lifted step of ``bench_builds``' tuple:
    the builds' own values (``from_config``, what the static build
    computes), or with ``moves`` (``SECOND_PLANE``'s form) the builds'
    parameters moved by those overrides; ``mesh`` makes it a
    ``CandidateParams`` of the config's degrees, ``degrees`` ({"D": 8,
    ...}) moved. The port's plane is ``convert.score_plane_from_reference``
    of the JAX plane's leaves."""
    import jax.numpy as jnp

    from go_libp2p_pubsub_tpu import config as jconfig
    from go_libp2p_pubsub_tpu.score import params as jparams

    from go_libp2p_pubsub_tpu_torch import convert

    jcfg, jnet, jsp = builds[0], builds[1], builds[2]
    n_topics = int(jnet.subscribed.shape[1])
    if moves is None:
        plane = jparams.ScoreParams.from_config(jcfg, jsp, n_topics)
    else:
        topics = {t: dataclasses.replace(tp, **moves.get("topic", {}))
                  for t, tp in jsp.topics.items()}
        sp = dataclasses.replace(jsp, topics=topics, **moves.get("peer", {}))
        thr = jconfig.PeerScoreThresholds(**moves.get("thresholds", {}))
        plane = jparams.ScoreParams.build(sp, thr, n_topics)
    if mesh:
        msh = jparams.MeshParams.from_config(jcfg)
        if degrees:
            msh = msh.replace(**{k: jnp.int32(v) for k, v in degrees.items()})
        plane = jparams.CandidateParams(score=plane, mesh=msh)
    return plane, convert.score_plane_from_reference(
        reference_leaves(plane), device="cpu", app_specific_weight=plane.app_specific_weight)

# ---------------------------------------------------------------------------
# the invariant oracle's seeded violations (tests/test_invariants.py's,
# applied to a state's leaves as ``convert.state_leaves`` gives them, so the
# same corruption builds both packages' states, or a card and a CPU state):
# one leaf (plus a doctored net, a due row or a counters snapshot where the
# property is about a relation), tripping exactly its property on a clean
# lived-in state


def _core(leaves) -> str:
    return ".core" if ".core.tick" in leaves else ""


def _valid_slot(L) -> int:
    return int(np.argwhere(L[_core(L) + ".msgs.valid"])[0][0])


def _bit(i: int):
    return i // 32, np.uint32(1) << np.uint32(i % 32)


def _capacity(L) -> int:
    return L[_core(L) + ".dlv.first_round"].shape[1]


def _clear_bit(row, m) -> int:
    bits = np.unpackbits(np.asarray(row, np.uint32).view(np.uint8), bitorder="little")
    return next(i for i in range(m) if not bits[i])


def _mesh_edge(L):
    idx = np.argwhere(L[".mesh"])
    assert idx.size, "lived-in state has an empty mesh"
    return tuple(int(v) for v in idx[0])


def _copy(L, *paths):
    out = dict(L)
    for p in paths:
        out[p] = np.array(L[p], copy=True)
    return out


def corrupt_msgtable(c, L):
    p = _core(L) + ".msgs.ignored"
    L = _copy(L, p)
    L[p][_valid_slot(L)] = True
    return L, {}, {}


def corrupt_fwd(c, L):
    core = _core(L)
    L = _copy(L, core + ".dlv.fwd")
    w, b = _bit(_clear_bit(L[core + ".dlv.have"][0], _capacity(L)))
    L[core + ".dlv.fwd"][0, w] |= b
    return L, {}, {}


def corrupt_first_edge(c, L):
    # two first-arrival edges for one (peer, msg), both in have: only the
    # at-most-one clause trips
    core = _core(L)
    L = _copy(L, core + ".dlv.have", core + ".dlv.fe_words")
    w, b = _bit(_valid_slot(L))
    L[core + ".dlv.have"][0, w] |= b
    L[core + ".dlv.fe_words"][0, 0, w] |= b
    L[core + ".dlv.fe_words"][0, 1, w] |= b
    return L, {}, {}


def corrupt_events(c, L):
    return L, {}, {"prev_events": L[_core(L) + ".events"] + 1}


def corrupt_delivery(c, L):
    # un-deliver one validated, subscribed, non-origin receipt under the
    # quiet due row
    core = _core(L)
    slot = _valid_slot(L)
    peer = (int(L[core + ".msgs.origin"][slot]) + 1) % L[core + ".dlv.first_round"].shape[0]
    L = _copy(L, core + ".dlv.first_round")
    L[core + ".dlv.first_round"][peer, slot] = -1
    return L, {}, {"due": c.quiet}


def corrupt_self_graft(c, L):
    i, s, k = _mesh_edge(L)
    nbr = np.array(c.nbr)
    nbr[i, k] = i
    L = _copy(L, ".graft_out")
    L[".graft_out"][i, s, k] = True
    return L, {"nbr": nbr}, {}


def corrupt_topology(c, L):
    i, s, k = _mesh_edge(L)
    L = _copy(L, ".up")
    L[".up"][int(c.nbr[i, k])] = False
    return L, {}, {}


def corrupt_subscription(c, L):
    i, s, k = _mesh_edge(L)
    protocol = np.array(c.protocol)
    protocol[int(c.nbr[i, k])] = 0
    return L, {"protocol": protocol}, {}


def corrupt_degree(c, L):
    L = _copy(L, ".mesh")
    L[".mesh"][0] = False
    return L, {}, {}


def corrupt_graft_backoff(c, L):
    i, s, k = _mesh_edge(L)
    tick = int(L[".core.tick"])
    L = _copy(L, ".graft_out", ".backoff_present", ".backoff_expire")
    L[".graft_out"][i, s, k] = True
    L[".backoff_present"][i, s, k] = True
    L[".backoff_expire"][i, s, k] = tick + 10
    return L, {}, {}


def corrupt_graylist(c, L):
    i, s, k = _mesh_edge(L)
    L = _copy(L, ".scores")
    L[".scores"][i, k] = -5.0
    return L, {}, {}


def corrupt_mcache(c, L):
    L = _copy(L, ".mcache")
    w, b = _bit(_clear_bit(L[".core.dlv.have"][0], _capacity(L)))
    L[".mcache"][0, 0, w] |= b
    return L, {}, {}


def corrupt_score_counter(c, L):
    L = _copy(L, ".score.fmd")
    L[".score.fmd"][0, 0, 0] = -1.0
    return L, {}, {}


def corrupt_backoff_presence(c, L):
    i, s, k = _mesh_edge(L)
    tick = int(L[".core.tick"])
    L = _copy(L, ".backoff_present", ".backoff_expire")
    L[".backoff_expire"][i, s, k] = tick + 50
    L[".backoff_present"][i, s, k] = False
    return L, {}, {}


def corrupt_backoff_stuck(c, L):
    i, s, k = _mesh_edge(L)
    L = _copy(L, ".backoff_present", ".backoff_expire")
    L[".backoff_expire"][i, s, k] = 1
    L[".backoff_present"][i, s, k] = True
    return L, {}, {}


def corrupt_promise(c, L):
    L = _copy(L, ".promise_mid")
    L[".promise_mid"][0, 0] = _capacity(L) + 3
    return L, {}, {}


def corrupt_reform(c, L):
    # post-heal deadline passed, a mesh emptied with candidates left; grace
    # keeps the degree property suspended so only the heal clause trips
    tick = int(L[".core.tick"])
    L = _copy(L, ".mesh")
    L[".mesh"][0] = False
    due = np.array(c.quiet)
    due[:] = -1
    due[2:5] = (0, 5, tick - 1)      # recover: born in [0, 5], due from tick - 1
    due[5], due[6] = 1, 0            # grace on
    return L, {}, {"due": due}


def _choked(L):
    """``L`` with a copy of its choke plane to corrupt: a router state's
    own, or an all-clear one beside a v1.1 state's leaves (a state with
    the router's ``choked`` plane and nothing choked)."""
    if ".choked" in L:
        return _copy(L, ".choked")
    return dict(L, **{".choked": np.zeros_like(L[".mesh"])})


def corrupt_choke_outside_mesh(c, L):
    # a choked bit on a non-mesh edge
    L = _choked(L)
    i, s, k = (int(v) for v in np.argwhere(~L[".mesh"])[0])
    L[".choked"][i, s, k] = True
    return L, {}, {}


def corrupt_choke_starvation(c, L):
    # every mesh link of one slot choked: choked stays within the mesh
    deg = L[".mesh"].sum(-1)
    i, s = (int(v) for v in np.argwhere(deg >= c.dlo)[0])
    L = _choked(L)
    L[".choked"][i, s] = L[".mesh"][i, s]
    return L, {}, {}


CORE_CORRUPTIONS = {
    "msgtable-wf": corrupt_msgtable,
    "fwd-subset-have": corrupt_fwd,
    "first-edge-wf": corrupt_first_edge,
    "events-monotone": corrupt_events,
    "eventual-delivery": corrupt_delivery,
}
GOSSIP_CORRUPTIONS = {
    "no-self-mesh": corrupt_self_graft,
    "mesh-in-topology": corrupt_topology,
    "mesh-subscribed": corrupt_subscription,
    "mesh-degree-bounds": corrupt_degree,
    "no-graft-under-backoff": corrupt_graft_backoff,
    "graylist-not-in-mesh": corrupt_graylist,
    "mcache-subset-seen": corrupt_mcache,
    "score-counters-wf": corrupt_score_counter,
    "backoff-wf": corrupt_backoff_presence,
    "backoff-clears": corrupt_backoff_stuck,
    "promise-wf": corrupt_promise,
    "mesh-reform-after-heal": corrupt_reform,
    "choke-wf": corrupt_choke_outside_mesh,
    "no-choke-below-dlo": corrupt_choke_starvation,
}
SEEDED = ([(name, e) for name in CORE_CORRUPTIONS
           for e in ("gossipsub", "phase", "floodsub", "randomsub")]
          + [(name, e) for name in GOSSIP_CORRUPTIONS for e in ("gossipsub", "phase")])


def seeded_violation(name: str, c, leaves: dict):
    """``name``'s seeded violation on the state of ``leaves``: (leaves, net
    field overrides, check keywords). ``c`` carries the net's ``nbr`` and
    ``protocol`` (numpy), the ``quiet`` due row the clean state passes and
    ``dlo``."""
    return {**CORE_CORRUPTIONS, **GOSSIP_CORRUPTIONS}[name](c, leaves)


def corrupt_word_padding(leaves: dict) -> dict:
    """A set padding bit (bit 49: word 1, bit 17) in peer 0's seen-cache of
    a state whose capacity leaves padding bits (M = 48)."""
    have = _core(leaves) + ".dlv.have"
    L = _copy(leaves, have)
    L[have][0, 1] |= np.uint32(1) << np.uint32(17)
    return L


def corrupt_perm_self_point(leaves: dict) -> dict:
    """A present overlay slot whose edge_perm points at itself."""
    i, k = (int(v) for v in np.argwhere(leaves[".core.topo.nbr_ok"])[0])
    ep = np.array(leaves[".core.topo.edge_perm"])
    ep[i, k] = i * ep.shape[1] + k
    return dict(leaves, **{".core.topo.edge_perm": ep})


def corrupt_negative_epoch(leaves: dict) -> dict:
    ep = np.array(leaves[".core.topo.epoch"])
    ep[0, 0] = -1
    return dict(leaves, **{".core.topo.epoch": ep})


def oracle_state(leaves: dict, device):
    """The port state of ``leaves`` (``convert.state_from_reference``): a
    ``.choked`` leaf rides the state's router plane, as in the reference."""
    from go_libp2p_pubsub_tpu_torch import convert

    return convert.state_from_reference(leaves, device=device)


def oracle_net(net, device=None, **over):
    """``net`` with numpy field overrides at its dtypes (on ``device``)."""
    import torch

    from go_libp2p_pubsub_tpu_torch.state import replace

    return replace(net, **{k: torch.as_tensor(np.asarray(v), dtype=getattr(net, k).dtype,
                                              device=device or net.device)
                           for k, v in over.items()})
