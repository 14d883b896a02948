"""The supervised service loop (the JAX package's ``serve/``):

  supervisor — the segment pipeline over ``ensemble.WindowRunner``: a
               window a segment, boundary health probes and folded
               invariants, rollback-and-replay localisation, retry with
               backoff and the degradation ladder, the heartbeat and an
               incremental report
  store      — rolling checksummed v6 checkpoints: atomic writes,
               keep-last/keep-every retention, a manifest with
               corrupted-snapshot fallback (``api.Network.run``'s retention
               mode and ``load_checkpoint`` use it too)
  faults     — fault injection around the simulation (SIGKILL crash points,
               mid-checkpoint-write included; transient dispatch failures;
               NaN, counter and topology corruption; checkpoint file
               damage), which drives the recovery tests and
               ``chip_smoke.py`` phase 45

Entry point: ``python -m go_libp2p_pubsub_tpu_torch.serve._child`` (the
subprocess cell crash-recovery runs SIGKILL and resume).
"""

from .faults import (  # noqa: F401
    KILL_SITES,
    FaultPlan,
    TransientDispatchError,
    corrupt_leaf_member,
    flip_bit,
    truncate_file,
)
from .store import (  # noqa: F401
    MANIFEST_NAME,
    CheckpointStore,
    RetentionPolicy,
    write_json_atomic,
)
from .supervisor import (  # noqa: F401
    ServiceConfig,
    ServiceError,
    ServiceHalted,
    ServiceReport,
    Supervisor,
    state_digest,
)
