"""Build and load the CUDA kernels of this package.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` — a source that
includes no PyTorch header builds in seconds.  Libraries go to
``build/repro_torch_kernels/`` under the repository root (or the directory
named by ``REPRO_TORCH_BUILD_DIR``), keyed by a hash of the source, of
every header it includes from ``csrc/`` (``#include "..."``, followed
recursively) and of the flags, so an edit to a source or to a shared header
rebuilds every library that uses it and an unchanged one is reused.

Nothing here runs at import time: the first launch of a kernel (or an
explicit ``build_all()``, which starts one ``nvcc`` per source in parallel)
triggers the build.  A failed build raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"

# library name -> source file under csrc/ (one wrapper module of the same
# name binds its entry points: quant_matmul.cu also holds abfp_matmul and
# abfp_matmul_int8)
SOURCES: dict[str, str] = {
    "quant_matmul": "quant_matmul.cu",
    "flash_attention_quant": "flash_attention_quant.cu",
    "abfp_qdq": "abfp_qdq.cu",
    "flash_attention": "flash_attention.cu",
}

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# No fast-math: the kernels divide and round where the reference pins bits.
NVCC_FLAGS: tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    # src/repro_torch/kernels/build.py -> repository root
    root = Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME / "
        "/usr/local/cuda): the CUDA kernels cannot be built on this machine")


def local_headers(path: Path) -> list[Path]:
    """The headers ``path`` includes with ``#include "..."``, and theirs,
    in first-seen order (each once)."""
    seen: list[Path] = []
    todo = [path]
    while todo:
        cur = todo.pop(0)
        for inc in _LOCAL_INCLUDE.findall(cur.read_text()):
            hdr = (cur.parent / inc).resolve()
            if hdr not in seen:
                seen.append(hdr)
                todo.append(hdr)
    return seen


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives for the current source
    and the headers it includes."""
    src = CSRC_DIR / SOURCES[name]
    h = hashlib.sha1(src.read_bytes())
    for hdr in local_headers(src):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str, extra_flags: tuple[str, ...] = ()):
    """Start ``nvcc`` for one kernel unless its library is already built.
    Returns (process, temporary output, final output) or None."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC_DIR / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for kernel {name!r} "
            f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build wins or loses whole
    return log


def build_all(extra_flags: tuple[str, ...] = ()) -> dict[str, str]:
    """Build every kernel, one ``nvcc`` per source, all started together.
    Returns the compiler's output per kernel (e.g. with ``-Xptxas -v``)."""
    started = {name: _start_build(name, extra_flags) for name in SOURCES}
    return {name: _finish_build(name, s) for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
