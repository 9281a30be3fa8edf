"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Every ``csrc/*.cu`` file has a plain C interface.  At first use each is
compiled to an object by its own ``nvcc`` process, all started together, and
the objects are linked into one shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu

The library goes into ``build/`` at the root of the checkout (git-ignored),
named by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  ``ptxas`` reports (registers, shared
memory, spills per kernel) are kept beside it in a ``.log`` file.

Nothing here runs at import time: the CPU tests import every module of the
package on a host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["CSRC", "BUILD_DIR", "library", "check", "build_info"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from csrc/ on a machine with the "
        "CUDA toolkit")


def _sources() -> list:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _tag(srcs) -> str:
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(srcs, lib_path: Path, log_path: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} (exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        log_path.write_text("\n".join(logs))
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builders agree


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source tree has not
    been built yet."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            srcs = _sources()
            tag = _tag(srcs)
            lib_path = BUILD_DIR / f"repro_torch_kernels-{tag}.so"
            log_path = lib_path.with_suffix(".log")
            t0 = time.perf_counter()
            built = not lib_path.exists()
            if built:
                _compile(srcs, lib_path, log_path)
            lib = ctypes.CDLL(str(lib_path))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _INFO.update(path=str(lib_path), built=built,
                         seconds=time.perf_counter() - t0,
                         sources=[p.name for p in srcs],
                         ptxas_log=(log_path.read_text()
                                    if log_path.exists() else ""))
            _LIB = lib
        return _LIB


def build_info() -> dict:
    """Path, build time and ptxas report of the loaded library (empty
    before the first :func:`library` call)."""
    return dict(_INFO)


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = library().cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
