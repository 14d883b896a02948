"""The durability plane of the service loop: rolling checksummed v6
checkpoints (``store``: atomic writes, keep-last/keep-every retention, a
manifest with corrupted-snapshot fallback), which ``api.Network.run``'s
retention mode and ``load_checkpoint`` use. The supervisor and the fault
injection of the JAX package's ``serve/`` are not ported yet (ROADMAP §1,
item 7)."""

from .store import (  # noqa: F401
    MANIFEST_NAME,
    CheckpointStore,
    RetentionPolicy,
    write_json_atomic,
)
