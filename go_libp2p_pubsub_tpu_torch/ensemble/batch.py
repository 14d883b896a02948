"""Batched-simulation state builders and the vmap lift of engine steps
(the JAX package's ``ensemble/batch.py``).

The lifting contract:

* **state**: every tensor leaf of the state dataclasses grows a leading S
  axis. The PRNG key leaves (``convert.KEY_LEAVES``: ``.key`` and
  ``.core.key``, found by path, never by dtype or shape) are not tiled:
  sim ``i`` gets ``fold_in(sim_key, i)``, ``sim_key`` the unbatched
  state's key. Everything that derives randomness from the state key (the
  chaos plane's counter-mode fault hashes, the heartbeat shuffle,
  RandomSub's fanout draw, the gater and fanout streams) is so independent
  per sim with no per-subsystem plumbing.
* **config and topology are shared**: the lifted step closes over the same
  config, net and score tables as the unbatched step, and a CSR net's flat
  index arrays are shared as the dense ``offrev`` is.
* **per-sim inputs grow a leading S axis**: publish schedules, churn
  ``up`` rows, ``link_deny`` masks, so one dispatch can run S different
  scenarios; ``tile`` gives S copies of a shared input.
* **bit-exactness**: the port's generator is threefry on integer tensors,
  and every op a step runs is elementwise across the vmapped sims, so sim
  ``i`` of a batched run equals the unbatched run built with
  ``with_sim_key(state, sim_key, i)`` bit for bit, at any S.
* **the card**: ``torch.func.vmap`` hands each kernel wrapper batched
  tensors; its batching rule (``ops/kernels.sim_launch``) launches the
  kernel once for all S sims over a grid with a sim dimension, so an S-sim
  dispatch launches each kernel as often as a one-sim dispatch does.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import prng
from ..convert import KEY_LEAVES
from ..driver import _leaves, _rebuild


def _map_paths(tree, fn, prefix: str = ""):
    """A state (nested dataclasses) with every tensor leaf ``x`` at schema
    path ``p`` (the ``convert`` paths: ``.core.dlv.have``) replaced by
    ``fn(p, x)``; None leaves and non-tensor fields stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_paths(getattr(tree, f.name), fn, f"{prefix}.{f.name}")
            for f in dataclasses.fields(tree)})
    return tree


def sim_keys(base_key: torch.Tensor, n_sims: int) -> torch.Tensor:
    """``[S, 2]`` per-sim keys: row i is ``fold_in(base_key, i)``, all rows
    in one call."""
    idx = torch.arange(int(n_sims), dtype=torch.int64, device=base_key.device)
    return prng.fold_in_rows(base_key, idx)


def with_sim_key(state, base_key: torch.Tensor, sim_idx: int):
    """The unbatched state whose run sim ``sim_idx`` of a batched run
    reproduces bit for bit: every key leaf replaced by ``fold_in(base_key,
    sim_idx)`` (a state carries exactly one)."""
    folded = prng.fold_in(base_key, int(sim_idx))
    return _map_paths(state, lambda p, x: folded.clone() if p in KEY_LEAVES else x)


def tile(x, n_sims: int) -> torch.Tensor:
    """One shared per-sim input tiled to the leading S axis (``[...]`` ->
    ``[S, ...]``, a contiguous copy), for schedules every sim shares;
    per-sim scenarios build the ``[S, ...]`` tensor directly."""
    x = torch.as_tensor(x)
    return x.unsqueeze(0).expand((int(n_sims),) + tuple(x.shape)).contiguous()


def batch_states(state, n_sims: int, base_key: torch.Tensor | None = None):
    """One state lifted to S sims: every leaf tiled to a leading S axis but
    the key leaves, which become ``fold_in(base_key, i)`` per sim
    (``base_key`` defaults to the state's own key, so the unbatched state
    is the source of its sims' keys)."""

    def lift(path, x):
        if path in KEY_LEAVES:
            return sim_keys(x if base_key is None else base_key, n_sims)
        return tile(x, n_sims)

    return _map_paths(state, lift)


def stack_planes(planes):
    """Stack a list of lifted planes (``score.params.ScoreParams``, or the
    combined ``CandidateParams``) along a new leading S axis: the
    configs-by-sims sweep input, passed as the lifted step's trailing
    argument so one dispatch runs S parameterisations (sim i equals the
    one-sim run with plane i). The host ``app_specific_weight`` is a build
    constant, not a sweepable value: every plane must share it."""
    first = planes[0]
    for p in planes[1:]:
        if getattr(p, "app_specific_weight", None) != getattr(
                first, "app_specific_weight", None):
            raise ValueError(
                "stack_planes: app_specific_weight is a STATIC (SHAPE) "
                "field — every plane in a sweep must share it")
    cols = zip(*(_leaves(p) for p in planes))
    return _rebuild(first, iter([torch.stack(c) for c in cols]))


def unbatch(states, sim_idx: int):
    """Sim ``sim_idx`` of a batched state (the analysis view, and the
    per-sim checkpoint: the slice is a plain unbatched state)."""
    i = int(sim_idx)
    return _map_paths(states, lambda p, x: x[i])


def lift_step(step, *, net=None, static_kwargs: dict | None = None, donate: bool = True):
    """Lift an engine step to an S-leading-axis ensemble step.

    ``step`` is anything the ``make_*_step`` factories (or ``perf.sweep``'s
    builds) return, or ``models.floodsub.floodsub_step`` with ``net``:
    ``net`` is an unbatched leading positional (FloodSub's calling form
    ``step(net, state, ...)``), shared by the sims, not mapped.
    ``static_kwargs`` go to every per-sim call as they are (FloodSub's
    ``chaos=cfg``). A ``do_heartbeat`` keyword passes through to steps that
    take one.

    The lifted step maps every positional argument at dim 0 with
    ``torch.func.vmap``: the state and every per-dispatch tensor carry the
    leading S axis (``tile``). The state dataclasses cross the vmap
    boundary as their flat tensor leaves (``driver._leaves``). ``donate``
    is kept for the reference's signature and has nothing to do here: the
    step is functional and a captured window reuses its own buffers
    anyway. The step's ``rows`` attribute (the drivers read it) is kept."""
    sk = dict(static_kwargs or {})
    del donate

    def ens(states, *args, do_heartbeat=None):
        kw = dict(sk)
        if do_heartbeat is not None:
            kw["do_heartbeat"] = do_heartbeat
        out_tree = {}

        def one(flat, *a):
            s = _rebuild(states, iter(flat))
            out = step(net, s, *a, **kw) if net is not None else step(s, *a, **kw)
            out_tree["tree"] = out
            return _leaves(out)

        flat = torch.func.vmap(one)(_leaves(states), *args)
        return _rebuild(out_tree["tree"], iter(flat))

    if hasattr(step, "rows"):
        ens.rows = step.rows
    return ens


def lift_floodsub(net, chaos=None, queue_cap: int = 0, adversary=None,
                  lift_scores: bool = False):
    """The lift of the FloodSub round (a module-level function taking
    ``net`` first, unlike the factories). A scheduled chaos run passes the
    per-round ``link_deny`` mask as a trailing positional, routed to
    FloodSub's keyword, so it maps with the other per-sim tensors.
    ``lift_scores=True``: the last trailing positional is a score plane
    (``stack_planes``), routed to FloodSub's ``score_plane`` seam, which
    FloodSub ignores; it gives every router one call form in a
    configs-by-sims sweep. ``adversary`` (a ``chaos.Adversary`` or an
    ``AttackScenario``) is built once against ``net``
    (``adversary.build_consts``), so a captured window copies nothing to
    the card."""
    from ..chaos import adversary as adversary_mod
    from ..models.floodsub import floodsub_step

    adv = adversary_mod.build_consts(adversary, net)

    def adapter(net_, s, po, pt, pv, *rest):
        kw = {"queue_cap": queue_cap}
        if chaos is not None:
            kw["chaos"] = chaos
        if adv is not None:
            kw["adversary"] = adv
        rest = list(rest)
        if lift_scores:
            kw["score_plane"] = rest.pop()
        if rest:
            kw["link_deny"] = rest[0]
        return floodsub_step(net_, s, po, pt, pv, **kw)

    return lift_step(adapter, net=net)
