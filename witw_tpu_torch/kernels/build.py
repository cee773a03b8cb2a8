"""Build and load the port's CUDA kernels.

Each library is one ``csrc/<name>.cu`` (which may include ``csrc/*.cuh``)
with a plain C interface, compiled by
``nvcc`` for sm_90a into ``witw_tpu_torch/_build/`` at first use and loaded
with ``ctypes``. The file name carries a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_libraries(names: Sequence[str]) -> Dict[str, Tuple[Path, str]]:
    """Compile ``csrc/<name>.cu`` for each name whose hashed library does not
    exist, one nvcc process per source, all started together. Returns
    {name: (library path, compiler log)}; the log (ptxas' registers and
    spills) is kept beside the library, so a library built earlier returns
    its log too."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Tuple[Path, str]] = {}
    running = []
    try:
        for name in names:
            path = library_path(name)
            if path.exists():
                log = path.with_suffix(".log")
                done[name] = (path, log.read_text() if log.exists() else "")
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((name, path, tmp, proc))
        for name, path, tmp, proc in running:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n{out}")
            path.with_suffix(".log").write_text(out)
            os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
            done[name] = (path, out)
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return done


def build_library(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists. Returns
    (library path, compiler log)."""
    return build_libraries([name])[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    path, _ = build_library(name)
    return ctypes.CDLL(str(path))
