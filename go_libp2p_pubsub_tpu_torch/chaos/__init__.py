"""Chaos plane: link-fault injection, partition and crash schedules, and
recovery metrics, and the attack plane (the JAX package's ``chaos/``).

  faults    — ChaosConfig and the i.i.d. / Gilbert–Elliott link-flap
              generators (symmetric per-link masks drawn from the state's
              PRNG stream; checkpoint-exact resume)
  scenario  — declarative partition and crash-storm schedules compiled to
              per-round or per-phase mask arguments
  metrics   — recovery metrics: delivery ratio under loss, IWANT-recovery
              share, mesh-repair latency, time to recover
  adversary — the v1.1 attack suite: per-peer sybil and behaviour planes
              driving lie-in-IHAVE, drop-on-forward, graft spam,
              self-promotion and censorship as masked variants of the step
              math, and declarative AttackScenario schedules
"""

from .adversary import (  # noqa: F401
    BEHAVIORS,
    Adversary,
    AdversaryError,
    AttackScenario,
)
from .faults import ChaosConfig, ChaosConfigError, resolve  # noqa: F401
from .metrics import (  # noqa: F401
    DeliveryStats,
    batched_cross_group_mesh_counts,
    batched_iwant_shares,
    cross_group_mesh_count,
    delivery_stats,
    expected_receivers,
    iwant_recovery_share,
    links_down_total,
    make_cross_mesh_observer,
    mesh_reform_latency,
    mesh_repair_latency,
    time_to_recover,
)
from .scenario import (  # noqa: F401
    CrashStorm,
    Partition,
    Scenario,
    halves,
    two_group_partition,
)
