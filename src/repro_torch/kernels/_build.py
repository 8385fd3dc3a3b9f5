"""Build the port's CUDA sources into shared libraries at first use.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/repro_torch_kernels/`` at the root of the checkout, one library per
source, all sources at once. A library's name holds a hash of its source and
the compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Each library exposes plain C functions, loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built on a "
        "machine with the CUDA toolkit"
    )


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Returns {source stem: library path};
    the compiler's output (with ``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``.log``. Raises if any fails."""
    libs = {src.stem: library_path(src) for src in sources()}
    todo = [src for src in sources() if not libs[src.stem].is_file()]
    if not todo:
        return libs
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        lib = libs[src.stem]
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode:
            failed.append(f"nvcc failed on {src.name}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _loaded:
            libs = build_all()
            if name not in libs:
                raise KeyError(f"no CUDA source csrc/{name}.cu")
            _loaded[name] = ctypes.CDLL(str(libs[name]))
        return _loaded[name]
