"""The constants of the bench line (the JAX package's ``perf/artifacts.py``
names them; the port keeps its own copy): the schema version the line
declares, the north-star denominator of ``vs_baseline``, and the explicit
off blocks a lossless, static-parameter, v1.1 line carries in its
fingerprint."""

SCHEMA_VERSION = 3

#: the north-star denominator of every ``vs_baseline``: 10k simulated
#: delivery rounds (heartbeat ticks at r=1) per wall second
NORTH_STAR_RATE = 10_000.0

#: the bench wire is lossless
CHAOS_OFF = {"generator": "off", "loss_rate": 0.0, "scheduled": False, "scenario": None}

def params_fingerprint(lifted: bool) -> dict:
    """The ``fingerprint["params"]`` block: whether the build reads its
    score parameters from a lifted plane, and which config fields it then
    reads there (``score.params.LIFTED_FIELD_NAMES``; none when every
    parameter is static)."""
    traced = ()
    if lifted:
        from ..score.params import LIFTED_FIELD_NAMES as traced
    return {"recorded": True, "lifted": bool(lifted), "traced": sorted(traced)}

#: the v1.1 router: no IDONTWANT, no choking, no latency ring
ROUTER_V11 = {"enabled": False, "protocol": "v1.1", "idontwant": False,
              "idontwant_threshold": None, "choke": False, "choke_ema_alpha": None,
              "choke_threshold": None, "unchoke_threshold": None,
              "choke_max_per_hb": None, "latency_rounds": 0}


def execution_fingerprint(*, segment_rounds: int, unroll: int | None) -> dict:
    """The ``fingerprint["execution"]`` block of a bench line: one window a
    segment of ``segment_rounds`` rounds, on one device."""
    return {"scan": True, "segment_rounds": int(segment_rounds), "dispatches_per_window": 1,
            "rounds_per_dispatch": int(segment_rounds), "mesh_shape": None,
            "unroll": None if unroll is None else int(unroll), "check_every": None}
