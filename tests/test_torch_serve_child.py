"""The port's subprocess cell (``serve/_child.py``) on the CPU: the twin
of tests/test_serve.py:410. A control run of the JAX package's
``_child`` and of the port's with the same arguments write equal
``FINAL.json`` digests; a port child SIGKILLed while its segment-1
checkpoint's tmp file is half written, then run again with the same
arguments, resumes from its last committed snapshot and ends in the JAX
control's digest. (The reference's randomized-site test is in its slow
tier and has no twin.)"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

N, ROUNDS, SEG = 32, 16, 4
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_child(package: str, root, *extra, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SERVE_CHILD_CACHE=os.path.join(_REPO, ".jax_cache"))
    cmd = [sys.executable, "-m", f"{package}.serve._child", "--root", str(root),
           "--n", str(N), "--rounds", str(ROUNDS), "--segment", str(SEG), "--probes", *extra]
    if package.endswith("_torch"):
        cmd += ["--device", "cpu"]
    return subprocess.run(cmd, cwd=_REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _final(root) -> dict:
    with open(os.path.join(root, "FINAL.json")) as f:
        return json.load(f)


def test_sigkill_mid_checkpoint_write_resumes_to_the_reference_digest(tmp_path):
    jctrl = _run_child("go_libp2p_pubsub_tpu", tmp_path / "jax", "--fresh")
    assert jctrl.returncode == 0, jctrl.stderr[-800:]
    tctrl = _run_child("go_libp2p_pubsub_tpu_torch", tmp_path / "port", "--fresh")
    assert tctrl.returncode == 0, tctrl.stderr[-800:]
    want, got = _final(tmp_path / "jax"), _final(tmp_path / "port")
    assert got["status"] == want["status"] == "done"
    for key in ("digest", "segments", "recoveries", "retries", "resumed_from", "checkpoints",
                "service"):
        assert got[key] == want[key], key
    assert got["window_compiles"] == {"L4": 0}

    crashed = _run_child("go_libp2p_pubsub_tpu_torch", tmp_path / "kill", "--fresh",
                         "--kill-segment", "1", "--kill-site", "mid-write")
    assert crashed.returncode in (-signal.SIGKILL, 128 + signal.SIGKILL), (
        crashed.returncode, crashed.stderr[-800:])
    # the kill left a half-written tmp beside the one committed snapshot
    ckpts = os.listdir(tmp_path / "kill" / "checkpoints")
    assert any(f.endswith(".tmp.npz") for f in ckpts), ckpts
    assert not os.path.exists(tmp_path / "kill" / "FINAL.json")
    resumed = _run_child("go_libp2p_pubsub_tpu_torch", tmp_path / "kill")
    assert resumed.returncode == 0, resumed.stderr[-800:]
    final = _final(tmp_path / "kill")
    assert final["resumed_from"] == SEG
    assert final["digest"] == want["digest"]
    assert final["service"]["resumes"] == 1


def test_child_refuses_without_a_card(tmp_path):
    """``--device`` defaults to the card; without one the cell raises
    rather than run on the CPU."""
    import torch

    if torch.cuda.is_available():
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.serve._child",
                           "--root", str(tmp_path), "--n", "16", "--rounds", "4",
                           "--segment", "4"], cwd=_REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "FINAL.json")
