"""The port's supervised loop against the JAX package's when dispatches
fail and when the event counters drain (the rest of the twins of
tests/test_serve.py:155-395 and :454-606; ``test_torch_serve.py`` has the
cell, the helpers and the clean, resumed and NaN-recovered runs).

The retried, degraded and drained runs run in both packages and end in
equal states (every leaf, through ``convert``), equal ``state_digest``s
and equal reports (retries, the ladder's rungs, the drained totals)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
from test_torch_serve import (
    ROUNDS,
    SEG,
    assert_twins,
    both,
    cell,
    jax_gold,
    supervisor,
)
from torch_parity import diff_leaves

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import ensemble as tensemble
from go_libp2p_pubsub_tpu_torch import serve as tserve
from go_libp2p_pubsub_tpu_torch.serve.supervisor import _with_events


def test_transient_dispatch_failures_retried_as_reference(tmp_path):
    jrep, trep = both(tmp_path, "retry", plan=dict(fail_dispatches={1: 2}))
    assert_twins(jrep, trep, "retried")
    assert trep.retries == 2 and trep.recoveries == 0
    assert tserve.state_digest(trep.states) == jax_gold()[1]


def test_degradation_recovers_as_reference(tmp_path):
    """Failures past the retry budget that then stop: one rung down (the
    segment halved), every round run, the bare window's state."""
    jrep, trep = both(tmp_path, "degrade", max_retries=1, plan=dict(fail_dispatches={0: 3}))
    assert_twins(jrep, trep, "degraded")
    assert trep.degradations == ["shrink-segment:2"]
    assert set(trep.window_compiles) == {"L4", "L2"}
    assert tserve.state_digest(trep.states) == jax_gold()[1]


def test_dispatch_failure_degrades_then_halts(tmp_path):
    """Failures that never stop walk the ladder to one dispatch, then halt,
    leaving a 'halted' heartbeat."""
    sup = supervisor("port", tmp_path, max_retries=1, plan=dict(fail_dispatches={0: 10 ** 6}))
    with pytest.raises(tserve.ServiceHalted, match="degradation ladder is exhausted"):
        sup.run()
    assert [d for d in sup._degradations if d.startswith("shrink-segment")] == [
        "shrink-segment:2", "shrink-segment:1"]
    assert json.load(open(sup.heartbeat_path))["status"] == "halted"


def test_supervised_observations_surfaced(tmp_path):
    """``observe`` results reach the caller: the stacked per-dispatch tree
    over every committed dispatch."""
    step, make_args, template_fn, _net, _cfg = cell("port")
    sup = tserve.Supervisor(step, make_args, template_fn, str(tmp_path),
                            tserve.ServiceConfig(n_dispatches=ROUNDS, segment_len=SEG,
                                                 report_name=None),
                            observe=lambda st: st.core.tick.clone())
    rep = sup.run()
    assert rep.observations.shape == (ROUNDS,)
    assert list(rep.observations) == list(range(1, ROUNDS + 1))
    assert set(rep.window_compiles) == {"L4+obs"}
    assert tserve.state_digest(rep.states) == jax_gold()[1]


def test_store_manifest_never_references_deleted_files(tmp_path):
    """Pruned files are unlinked only after the manifest commit: at every
    commit the manifest on disk names only files that exist."""
    store = tserve.CheckpointStore(str(tmp_path / "s"), tserve.RetentionPolicy(keep_last=1))
    seen = []

    def hook(stage, path):
        if stage == "manifest":
            seen.extend(os.path.exists(os.path.join(store.root, e["file"]))
                        for e in json.load(open(path))["entries"])

    store.write_hook = hook
    for i in range(4):
        store.save(cell("port")[2](), tick=i)
    assert seen and all(seen)


# ---------------------------------------------------------------------------
# the event-counter drain


def _bare_events() -> np.ndarray:
    """The counters the JAX bare window ends with, as int64."""
    return np.asarray(jax_gold()[0][".core.events"], np.int64)


def test_ev_drain_equals_reference(tmp_path):
    """With the drain on, the device counters restart at 0 at every
    committed boundary and the host's int64 totals end equal to the bare
    window's counters, in both packages; the rest of the state is the bare
    window's."""
    jrep, trep = both(tmp_path, "drain", drain_event_counters=True)
    assert_twins(jrep, trep, "drained")
    assert trep.ev_totals.dtype == np.int64
    np.testing.assert_array_equal(trep.ev_totals, _bare_events())
    assert not trep.states.core.events.any()
    gold = dict(jax_gold()[0])
    gold[".core.events"] = np.zeros_like(gold[".core.events"])
    zeroed = _with_events(trep.states, trep.states.core.events.clone().zero_())
    diff_leaves(gold, convert.state_leaves(zeroed), "drained")


def test_ev_drain_totals_survive_resume(tmp_path):
    """The drained totals ride the checkpoint's meta: a run stopped halfway
    and driven on by a fresh supervisor loses no count."""
    root = tmp_path / "r"
    supervisor("port", root, n_dispatches=ROUNDS // 2, drain_event_counters=True).run()
    rep = supervisor("port", root, drain_event_counters=True).run()
    assert rep.resumed_from == ROUNDS // 2
    np.testing.assert_array_equal(rep.ev_totals, _bare_events())


def test_bare_reference_run_is_the_gold():
    """The JAX bare window the port's runs are held to equals the port's
    own bare window on every leaf."""
    step, make_args, template_fn, _net, _cfg = cell("port")
    run = tensemble.WindowRunner(step, ROUNDS).run(template_fn(), make_args)
    diff_leaves(jax_gold()[0], convert.state_leaves(run.states), "bare window")
