"""Build the CUDA kernels of this package and bind them through ctypes.

Each ``<name>.cu`` beside this file is compiled on first use into a shared
library with a plain C interface:

    nvcc -O3 -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC

The sources include only CUDA headers (and the shared ``*.cuh`` beside
them), so a cold build takes seconds and needs neither ``ninja`` nor
PyTorch's headers.  Libraries land in ``kernels/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source, the shared
headers and the flags; a build writes a temporary file and renames it into
place, so a concurrent or interrupted build never leaves a torn library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Set

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fused_decode_cluster", "fused_decode", "fused_beam_grid", "grid_sample",
           "bn_backward", "gemm_probe")

_loaded: Dict[str, ctypes.CDLL] = {}
_running: Set[subprocess.Popen] = set()  # compilers in flight, for kill_running


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels of this package are built from source on first use")
    return found


def library_path(name: str) -> Path:
    src = (KERNEL_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(KERNEL_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temporary path, final path)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _running.add(proc)
    return proc, tmp, out


def build(names: Iterable[str] = SOURCES, timeout: float = 300.0) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all at once (one
    ``nvcc`` per source, started together).  Returns the compiler output of
    each build (``-Xptxas -v`` register and shared-memory report); raises
    if any build failed, after all have ended."""
    started = {n: _start(n) for n in names}
    logs: Dict[str, str] = {}
    errors = []
    for name, (proc, tmp, out) in started.items():
        if proc is None:
            logs[name] = "cached"
            continue
        try:
            logs[name], _ = proc.communicate(timeout=timeout)
            failure = None if proc.returncode == 0 else (
                f"nvcc exited {proc.returncode}:\n{logs[name]}")
        except subprocess.TimeoutExpired:
            proc.kill()
            logs[name], _ = proc.communicate()
            failure = f"nvcc timed out after {timeout} s"
        finally:
            _running.discard(proc)
        if failure is None:
            os.replace(tmp, out)
        else:
            errors.append(f"{name}: {failure}")
            tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def kill_running() -> None:
    """Kill every compiler this process still has running (for a caller
    that must exit at once, e.g. on a watchdog)."""
    for proc in list(_running):
        proc.kill()


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, compiling it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
