"""Build and load the port's CUDA library.

``nvcc`` compiles every ``csrc/*.cu`` of the package, one process per
source, all started together, and links the objects into one shared library
with a plain C interface, which ``ctypes`` loads.  The build runs at first
use, from the package's own sources only, into ``_build/`` beside them (git
ignores it).  The library's name carries a hash of the sources, so an edit
rebuilds it.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",  # registers, shared memory and spills per kernel, into the build log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (argtypes, restype); every pointer and the stream is a
# c_void_p, or ctypes would pass them as 32-bit ints and cut them
SIGNATURES = {
    "flix_apply_smem_bytes": ([_I, _I], _I),
    "flix_smem_optin_bytes": ([], _I),
    "flix_apply_launch": ([_P] * 23 + [_I, _I, _I, _P], _I),
    "flix_apply_grid": ([_I, _I], _I),
    "flix_apply_staged_smem_bytes": ([_I, _I, _I], _I),
    "flix_apply_staged_blocks_per_sm": ([_I, _I, _I], _I),
    "flix_apply_staged_launch": ([_P] * 24 + [_I] * 4 + [_P], _I),
    "flix_apply_inplace_launch": ([_P] * 26 + [_I] * 6 + [_P], _I),
    "flix_apply_read_launch": ([_P] * 11 + [_I] * 4 + [_P], _I),
    "flix_range_count_launch": ([_P] * 10 + [_I] * 4 + [_P], _I),
    "flix_range_gather_launch": ([_P] * 7 + [_I, _I, _I, _I, _P], _I),
    "flix_query_launch": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "flix_successor_launch": ([_P] * 9 + [_I] * 4 + [_P], _I),
    "flix_fence_rows_scratch_ints": ([_I], ctypes.c_longlong),
    "flix_fence_rows_launch": ([_P] * 7 + [_I] * 3 + [_P], _I),
    "flix_insert_smem_bytes": ([_I, _I], _I),
    "flix_insert_launch": ([_P] * 13 + [_I] * 3 + [_P], _I),
    "flix_delete_smem_bytes": ([_I, _I], _I),
    "flix_delete_launch": ([_P] * 10 + [_I] * 3 + [_P], _I),
    "grouped_matmul_launch": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "grouped_matmul_variant": ([_P, _P] + [_I] * 5, _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: building the kernels needs the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libflix_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; return their outputs, or raise with the
    output of the first that fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet.  Returns its path and
    nvcc's output (empty when it was already built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"
    obj_dir.mkdir(exist_ok=True)
    nvcc = _nvcc()
    cus = [f for f in sources() if f.suffix == ".cu"]
    objs = [str(obj_dir / f"{f.stem}.o") for f in cus]
    try:
        logs = _run_all(
            [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(f)] for f, o in zip(cus, objs)]
        )
        logs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]])
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    os.replace(tmp, out)
    return out, "".join(logs)


def load_library() -> ctypes.CDLL:
    """The built library, with every entry point's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
