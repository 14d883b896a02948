from .events import EV, N_EVENTS, event_name, zero_counters  # noqa: F401


def __getattr__(name):  # lazy: sinks/drain pull in protobuf
    if name in ("sinks", "drain"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
