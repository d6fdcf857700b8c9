"""Builds the port's CUDA kernels from ``csrc/*.cu`` on first use.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes`; :func:`build_all` runs one
``nvcc`` per source, all at once. Libraries go to ``_build/``
beside the package (listed in ``.gitignore``), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.

:func:`load_host` does the same for host C++ (the JSON-lines parser of
``native/src/``) with the host compiler (``$CXX``, else ``g++``), into the
same directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of ikea_recommender_tpu_torch cannot be built"
    )


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library is up to date;
    returns (process, temporary output, final output) or None."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> Optional[str]:
    if started is None:
        return None
    proc, tmp, out = started
    report = proc.communicate()[0]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"kernel build failed: {name}.cu (nvcc exit {proc.returncode}):\n{report}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return report


def build_all(names) -> Dict[str, Optional[str]]:
    """Compile the named sources, one ``nvcc`` each, all started together.
    Returns each compiler's output (its ``-Xptxas=-v`` register and
    shared-memory report), or None for a library that was up to date."""
    started = {name: _start(name) for name in names}
    try:
        return {name: _finish(name, started[name]) for name in names}
    finally:  # a failed build leaves no compiler running and no temporary
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
                s[1].unlink(missing_ok=True)


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless its library is up to date; see
    :func:`build_all`."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def host_library_path(source: Path) -> Path:
    """The library of the host C++ ``source``, named by a hash of the source,
    the compiler and the flags."""
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join((os.environ.get("CXX", "g++"),) + HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def load_host(source: Path) -> ctypes.CDLL:
    """The loaded library of the host C++ ``source``, compiled first if
    needed. Raises where it cannot be built or loaded."""
    key = f"host:{source}"
    lib = _LIBS.get(key)
    if lib is None:
        out = host_library_path(source)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *HOST_FLAGS, "-o", str(tmp), str(source)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise RuntimeError(f"host build failed: {source}: {exc}") from exc
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"host build failed: {source} (exit {proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        lib = ctypes.CDLL(str(out))
        _LIBS[key] = lib
    return lib
