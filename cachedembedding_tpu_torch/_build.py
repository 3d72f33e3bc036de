"""Build-at-first-use for the port's native code.

Two kinds of shared library are built from the sources in the checkout into
``cachedembedding_tpu_torch/build/`` (listed in ``.gitignore``):

  * ``libhostops`` — the host C++ (directory, row staging, canonical init,
    overlay table, sort plan), with g++;
  * one library per CUDA source under ``csrc/``, with ``nvcc`` for ``sm_90a``
    and a plain C interface, loaded with ctypes.

The output name carries a hash of the sources and the command, so an edited
source never loads a stale build. A file lock serializes concurrent builds
(test workers, threads); the compiler writes to a temporary name that is
renamed into place, so a reader never sees a half-written library. A failed
build raises: nothing falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR / "build"


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or the first ``nvcc`` on PATH."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def gxx_command(sources: Sequence[Path], out: Path) -> List[str]:
    return [
        "g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread",
        "-o", str(out), *map(str, sources),
    ]


def nvcc_command(sources: Sequence[Path], out: Path) -> List[str]:
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), *map(str, sources),
    ]


def _host_cpu() -> str:
    """The host CPU's model line: ``-march=native`` builds are only valid on it."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return ""


def build(name: str, sources: Sequence[Path], command) -> Tuple[Path, float, str]:
    """Build ``sources`` into ``BUILD_DIR/<name>-<hash>.so`` unless that file
    exists. ``command(sources, out)`` returns the compiler's argv. The hash
    covers the sources, the command and the host CPU. Returns (library path,
    seconds spent compiling in this call, compiler output)."""
    sources = [Path(s) for s in sources]
    h = hashlib.sha256(_host_cpu().encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(command(sources, Path("OUT"))[1:]).encode())
    lib = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # another process built it while we waited
                return lib, 0.0, ""
            tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                command(sources, tmp), capture_output=True, text=True
            )
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building {name} failed (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, lib)
            return lib, secs, proc.stdout + proc.stderr
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
