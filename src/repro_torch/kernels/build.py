"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Builds happen at first use, all sources at once (one
``nvcc`` process each), into ``build/repro_torch_kernels/<key>/`` at the root
of the checkout, where ``<key>`` hashes the sources and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("xorshift_proj", "oselm_update", "plan_rows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def build_dir() -> Path:
    """The directory this set of sources and flags builds into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that is not built yet, all in parallel.

    Returns ``{name: path of lib<name>.so}``; raises with ``nvcc``'s output
    if any build fails.  Each library is written under a temporary name and
    renamed into place, so a cut build never leaves a broken one behind.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: out / f"lib{name}.so" for name in SOURCES}
    todo = [name for name in SOURCES if not libs[name].is_file()]
    if not todo:
        return libs
    compiler = nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


@functools.cache
def _load_all() -> dict[str, ctypes.CDLL]:
    return {name: ctypes.CDLL(str(path)) for name, path in build_all().items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every source first if needed."""
    return _load_all()[name]


def build_logs() -> dict[str, str]:
    """``nvcc``'s output (``-Xptxas -v`` resource lines) of each source built so far."""
    d = build_dir()
    return {n: (d / f"{n}.log").read_text() for n in SOURCES if (d / f"{n}.log").is_file()}
