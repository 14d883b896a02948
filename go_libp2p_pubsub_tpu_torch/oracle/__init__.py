"""Oracle package: the golden models the port's engines are checked
against (the JAX package's ``oracle/``).

  * scalar oracles (the gossipsub, floodsub, randomsub and score modules):
    per-node transcriptions of the reference call stacks, host Python;
  * the invariant oracle plane (``invariants.py``): the verification
    literature's safety and liveness properties as tensor predicates,
    checked every k dispatches, eagerly or folded into a run window;
  * the health-probe plane (``probes.py``): shallow engine-agnostic
    segment-boundary predicates (NaN/Inf sweep, events-monotone,
    delivery-floor).
"""

from .invariants import (  # noqa: F401
    ENGINES,
    REGISTRY,
    InvariantConfig,
    InvariantHook,
    InvariantReport,
    ScanInvariants,
    check_state,
    due_vector,
    invariant_names,
    make_checker,
)
from .probes import (  # noqa: F401
    PROBE_NAMES,
    HealthConfig,
    health_check,
    make_health_probe,
)
