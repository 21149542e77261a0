"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled by `nvcc` for sm_90a, with its own flags, into its
own shared library with a plain C interface, loaded with ctypes. Libraries go
into `_build/` next to this file, named by a hash of the source, the headers
of `csrc/` and the flags, so an edited source is rebuilt and an unchanged one
is built once. Nothing is built when the module is imported: `load` builds at
first use, and `build` starts one `nvcc` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("blend_fwd", "blend_bwd")
_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# blend_fwd's termination test must round as the plain version's separate
# multiplies and adds, so it contracts nothing; blend_bwd keeps its gate
# uncontracted with _rn intrinsics and may contract the rest (source notes)
NVCC_FLAGS = {
    "blend_fwd": _COMMON_FLAGS + ("-fmad=false",),
    "blend_bwd": _COMMON_FLAGS,
}

_p, _i = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "blend_fwd": {
        "ht3dgs_blend_fwd": ([_p] * 6 + [_i] * 4 + [_p], ctypes.c_int),
        "ht3dgs_blend_chunk": ([], ctypes.c_int),
    },
    "blend_bwd": {
        "ht3dgs_blend_bwd": ([_p] * 8 + [_i] * 4 + [_p], ctypes.c_int),
        "ht3dgs_blend_chunk": ([], ctypes.c_int),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _cuda_tool(tool: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", tool), shutil.which(tool)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{tool} not found (set CUDA_HOME or put it on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once.
    Returns {name: nvcc's output} (the -Xptxas -v register, shared-memory
    and spill report); an already built source maps to ''."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS[name], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it if needed."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return _LIBS[name]


def sass(name: str) -> str:
    """`cuobjdump -sass` of the built library of csrc/<name>.cu."""
    path = _lib_path(name)
    if not path.exists():
        build([name])
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
