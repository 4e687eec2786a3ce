"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes its own
shared library ``lib<name>.so``, loaded with ``ctypes``. No PyTorch header
is compiled, so a build takes seconds, not minutes. Libraries go to
``<repo>/build/kernels-<hash>/`` (ignored by git), keyed by a hash of every
source under ``csrc/`` and of the flags: an edited source builds anew, an
unchanged tree reuses what is there.

Builds happen at first use, inside the call that launches a kernel, never
at import (CPU-only hosts import every module). ``build_all`` compiles
every source with one ``nvcc`` process each, all started together.

Every launcher in ``csrc`` returns the ``cudaError_t`` of its launches as an
int (``cudaGetLastError`` right after the launch), and ``check`` raises on a
nonzero code — a refused launch never runs and a later synchronize would
not report it.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / f"kernels-{_digest()}"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))  # toolkit default
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build_all(names=None) -> dict:
    """Compile the given sources (default: all) that are not built yet, one
    ``nvcc`` per source, all in parallel. Returns ``{"seconds": wall time,
    "built": [names]}``; the compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is kept as ``<name>.log``."""
    names = sources() if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = out_dir / f"lib{n}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            log, _ = p.communicate()
            (out_dir / f"{n}.log").write_text(log)
            if p.returncode != 0:
                failed.append(f"{n}.cu (rc={p.returncode}):\n{log}")
            else:
                os.replace(tmp, out_dir / f"lib{n}.so")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": todo}


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if missing. Thread-safe."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.error_string(code).decode()})")


def stream_ptr(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
