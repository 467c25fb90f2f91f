"""Building the host C++ libraries of ``native/`` beside this package at
first use (JAX counterpart: utils/native.py, which runs ``make``).

A library is compiled with ``g++`` into ``native/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of its source and flags,
through a temporary file renamed into place, so that processes building it
together never load a torn file.  A failed build raises: there is no quiet
fallback."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = NATIVE_DIR / "_build"


def library_path(source: Path, flags: Sequence[str], build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    return build_dir / f"{source.stem}-{digest[:16]}.so"


def load_library(source: Path, flags: Sequence[str], what: str,
                 build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """``source`` built with ``flags`` (once; later calls find the file) and
    loaded.  Raises RuntimeError naming ``what`` where there is no ``g++``
    or the build fails."""
    out = library_path(source, flags, build_dir)
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: {what} is built from {source} on first use")
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {source} failed ({cxx} exited {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
