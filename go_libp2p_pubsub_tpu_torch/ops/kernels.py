"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/torch_kernels/`` at the
repository root (named by a hash of its source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header rebuilds), then
loaded with ``ctypes``. Building happens at first
use, never at import: the package imports on machines with no toolkit.

The sim axis (the ensemble plane, ``ensemble/``): every kernel takes S
simulations in one launch (``csrc/sims.cuh``). A wrapper hands its tensors
to ``sim_launch``, whose batching rule under ``torch.func.vmap`` moves each
batched tensor's sim axis to the front, gives an unbatched one sim stride
0, allocates ``[S, ...]`` outputs and launches the kernel once for all S
sims; outside vmap the same function launches the one-sim kernel. Each
kernel has one C entry point, ``{name}_sims``; S = 1 with null strides is
the one-sim launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_CONSTS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def source_tag(csrc: pathlib.Path, name: str) -> str:
    """A hash of ``csrc/<name>.cu``, the headers beside it and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{source_tag(CSRC, name)}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library is current. Returns
    the build's seconds (0.0 when the library was already current) and the
    compiler's output (ptxas registers and spills per kernel)."""
    lib = library_path(name)
    if lib.exists():
        return {"seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, lib)
    return {"seconds": time.perf_counter() - t0, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first when
    needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def bind_sims(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int):
    """``lib.fn`` of a ``*_sims`` entry point with its ctypes signature set:
    ``n_ptr`` pointers, ``n_int`` ints, then S, the host array of the
    pointers' sim strides and the stream."""
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def strides_arg(strides):
    """The host array of sim strides a ``*_sims`` entry point takes."""
    return (ctypes.c_longlong * len(strides))(*strides)


def check(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype and shape on
    ``device``: the kernels take exactly that."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t):
    """A tensor's device address for ctypes (None passes a null pointer)."""
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``: kernels launch
    there and never synchronise."""
    return torch.cuda.current_stream(device).cuda_stream


def const(key, make):
    """A small device tensor made once per ``key`` and kept (kernel
    arguments that are fixed per topology or config)."""
    got = _CONSTS.get(key)
    if got is None:
        got = _CONSTS[key] = make()
    return got


def offrev(offsets, revs, device):
    """The banded kernels' int32 ``[2K]`` array: ring offsets, then the
    reverse slots."""
    return const(("offrev", tuple(offsets), tuple(revs), str(device)),
                 lambda: torch.tensor(list(offsets) + list(revs),
                                      dtype=torch.int32, device=device))


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# the sim axis: one launch for the S sims of a vmapped call


class _SimLaunch(torch.autograd.Function):
    """A kernel wrapper's launch as a function torch.func.vmap can batch:
    ``run(args, dims, s)`` launches the kernel on ``args`` and returns its
    output tensors. Outside vmap ``dims`` is None and ``s`` 1 (the one-sim
    launch); the batching rule passes the vmap's ``in_dims`` and batch
    size, and ``run`` launches once for all S sims with ``[S, ...]``
    outputs at out_dims 0."""

    @staticmethod
    def forward(run, *args):
        return run(args, None, 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, run, *args):
        out = run(args, in_dims[1:], info.batch_size)
        return out, (0,) * len(out)


def _batched(x) -> bool:
    return isinstance(x, torch.Tensor) and torch._C._functorch.is_batchedtensor(x)


def sim_launch(run, *args) -> tuple:
    """``run``'s outputs for ``args`` (a kernel wrapper's tensors and None
    for an absent optional one): through ``_SimLaunch`` when vmap batched
    one of them, so the batching rule launches once for the S sims;
    straight to the one-sim launch otherwise."""
    if any(_batched(a) for a in args):
        return _SimLaunch.apply(run, *args)
    return run(args, None, 1)


def sim_views(args, dims, s: int):
    """(tensors, batched flags, sim strides) of a launch's arguments: with
    ``dims`` (a batched launch) each batched tensor has its sim axis moved
    to the front and is made contiguous, its stride its per-sim element
    count; an unbatched tensor, an absent one (None) and every tensor of a
    one-sim launch have stride 0."""
    out, flags, strides = [], [], []
    for i, x in enumerate(args):
        d = None if dims is None else dims[i]
        if x is None or d is None:
            out.append(x)
            flags.append(False)
            strides.append(0)
            continue
        x = x.movedim(d, 0).contiguous()
        if x.shape[0] != s:
            raise ValueError(f"sim axis of {x.shape[0]} != the vmap's batch size {s}")
        out.append(x)
        flags.append(True)
        strides.append(x[0].numel())
    return out, flags, strides


def sim_shape(batched: bool, s: int, shape) -> tuple:
    """A tensor's shape in a launch: ``[S, *shape]`` when batched."""
    return ((s,) if batched else ()) + tuple(shape)


def launch(lib, name: str, tensors, ints, *, s: int, batched: bool, strides, device) -> None:
    """Launch kernel ``name`` of ``lib`` on ``tensors`` (its pointers in
    order, None for a null one) and ``ints`` through its one C entry point,
    ``{name}_sims``: with ``batched`` over S sims with the tensors' sim
    strides, else with S = 1 and null strides, which launches the kernel's
    one-sim instantiation (``csrc/sims.cuh``)."""
    ptrs = [ptr(t) for t in tensors]
    err = getattr(lib, f"{name}_sims")(*ptrs, *ints, s if batched else 1,
                                       strides_arg(strides) if batched else None,
                                       stream(device))
    raise_on(err, name)


def out_strides(outs, batched: bool) -> list:
    """The sim strides of a launch's outputs (each ``[S, ...]`` when
    batched; None, an absent output, 0)."""
    return [x[0].numel() if batched and x is not None else 0 for x in outs]
