"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`. No
PyTorch header is included, so a build takes seconds. The library lands
in ``paddle_tpu_torch/_build/`` under a name that carries a hash of the
source, the ``csrc/*.cuh`` headers and the flags, so an edited source or
header rebuilds and an unchanged one is reused. Nothing is built when the
package is imported: the first launch builds, or :func:`build` builds
several sources at once, one ``nvcc`` process per source, all started
together. :func:`launch` calls a kernel's C entry point, raises on a
refused launch and counts it; :func:`check_cuda` and :func:`check_dtype`
are the wrappers' operand checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

__all__ = ["build", "check_cuda", "check_dtype", "launch", "load",
           "stream_ptr", "CSRC", "BUILD_DIR", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "are built from source at first use")
    return found


def _target(name: str, csrc: Optional[Path] = None) -> Path:
    csrc = CSRC if csrc is None else csrc
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):    # included by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str],
          csrc: Optional[Path] = None) -> Dict[str, Dict[str, object]]:
    """Compile every named source of ``csrc`` (default :data:`CSRC`) that
    has no current library, all ``nvcc`` processes at once. Returns per
    source ``{"seconds", "log"}``
    (the log holds ``ptxas``'s register and spill report, kept beside the
    library; a source that was already built reports 0 seconds and the
    log of its build). Raises with the compiler's output if any build
    fails. A name given twice builds once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    report: Dict[str, Dict[str, object]] = {}
    t0 = time.perf_counter()
    csrc = CSRC if csrc is None else csrc
    for name in dict.fromkeys(names):
        out = _target(name, csrc)
        if out.exists():
            saved = out.with_suffix(".log")
            report[name] = {"seconds": 0.0, "log": saved.read_text()
                            if saved.exists() else ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def launch(counts: Dict[str, int], name: str, source: str,
           argtypes: Sequence, *args) -> None:
    """Call ``<name>_f32`` of ``csrc/<source>.cu``'s library with ``args``
    (typed by ``argtypes``; it returns a ``cudaError_t``): raise if the
    launch was refused, else add one to ``counts[name]``."""
    fn = getattr(load(source), f"{name}_f32")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    counts[name] += 1


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, device, **tensors) -> None:
    """Raise unless every tensor lies on ``device`` and is contiguous."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_dtype(name: str, dtype, **tensors) -> None:
    """Raise unless every tensor has ``dtype``."""
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, the "
                             f"kernel takes {dtype}")
