"""The port imports neither JAX nor the JAX package: importing it and
every submodule in a fresh interpreter leaves ``jax``, ``flax`` and
``go_libp2p_pubsub_tpu`` out of ``sys.modules`` (matched by exact name —
``go_libp2p_pubsub_tpu_torch`` shares the prefix), and no source file of
the port or of chip_smoke.py imports them."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "go_libp2p_pubsub_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "go_libp2p_pubsub_tpu"}


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_fresh_interpreter_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), line, root)
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert bad == []


def test_prefix_is_not_mistaken_for_the_jax_package():
    roots = {r for r, _ in _imported_roots(PORT / "convert.py")}
    assert "go_libp2p_pubsub_tpu" not in roots
    assert "go_libp2p_pubsub_tpu_torch".split(".")[0] not in FORBIDDEN


def test_router_and_workload_modules_are_the_ports_own():
    """The router plane and the workloads are copies of their own: each
    module is among those the two checks above import and read, and its
    file lives in the port."""
    mods = _modules()
    for name in ("routers", "routers.config", "routers.idontwant", "routers.latency",
                 "routers.choke", "topo.workloads", "topo.generators"):
        assert f"go_libp2p_pubsub_tpu_torch.{name}" in mods, name
        rel = name.replace(".", "/")
        path = PORT / (rel + ".py") if (PORT / (rel + ".py")).exists() else PORT / rel / "__init__.py"
        assert not [r for r, _ in _imported_roots(path) if r in FORBIDDEN], name


def test_service_and_artifact_modules_are_the_ports_own():
    """The supervised service loop and the bench artifacts are copies of
    their own: ``serve/supervisor.py``, ``serve/faults.py``,
    ``serve/_child.py`` and ``perf/artifacts.py`` are among the modules the
    checks above import and read, and none imports JAX or the JAX
    package."""
    mods = _modules()
    for rel in ("serve/supervisor.py", "serve/faults.py", "serve/_child.py",
                "perf/artifacts.py"):
        name = "go_libp2p_pubsub_tpu_torch." + rel[:-3].replace("/", ".")
        assert name in mods, name
        assert not [r for r, _ in _imported_roots(PORT / rel) if r in FORBIDDEN], rel
