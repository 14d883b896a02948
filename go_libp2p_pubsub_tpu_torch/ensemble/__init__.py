"""The ensemble plane: S independent simulations as one program (the JAX
package's ``ensemble/``).

One simulation at a time leaves statistical power on the table: every
delivery ratio, latency CDF and recovery figure is a one-seed sample,
while the GossipSub evaluation methodology (arxiv 2007.02754) reports its
attack and recovery results as distributions over many randomized trials.
A leading sim axis lifted with ``torch.func.vmap`` gets that power on the
card: the S sims share the config and topology, each has its own key
``fold_in(sim_key, i)``, and every hand-written kernel takes the sim axis,
so an S-sim dispatch launches each kernel as often as a one-sim dispatch
does (``ops/kernels.sim_launch``).

  batch   — the vmap lift of engine steps, and batched state builders:
            tiled states with per-sim keys, so the chaos plane's fault
            hashes and every sampler stream are independent per sim
  stats   — cross-sim reductions on the device (delivery ratios, latency
            histograms, quantile bands) and host bootstrap CIs over the
            per-sim summaries
  runner  — the sweep / Monte Carlo driver: S sims a dispatch, eagerly or
            through one captured run window a segment, with the invariant
            oracle hooked or folded in
"""

from .batch import (  # noqa: F401
    batch_states,
    lift_floodsub,
    lift_step,
    sim_keys,
    stack_planes,
    tile,
    unbatch,
    with_sim_key,
)
from .runner import (  # noqa: F401
    EnsembleRun,
    WindowRunner,
    run_rounds,
    run_window,
    shard_ensemble_state,
)
from .stats import (  # noqa: F401
    batched_iwant_shares,
    bootstrap_ci,
    cdf_bands,
    latency_cdf_counts,
    quantile_band,
    sim_delivery_ratios,
)
