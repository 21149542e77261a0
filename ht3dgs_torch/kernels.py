"""Build and load the native code of `csrc/`: the hand-written CUDA kernels
and the host-side image decoder.

Each CUDA source (`*.cu`) is compiled by `nvcc` for sm_90a, with its own
flags; each host source (`*.cc`) by the host compiler `c++`, with one set of
flags on every machine. Every source becomes a shared
library of its own with a plain C interface, loaded with ctypes. Libraries go
into `_build/` next to this file, named by a hash of the source, the headers
of `csrc/`, the compiler and the flags, so an edited source is rebuilt and an
unchanged one is built once. Nothing is built when the module is imported:
`load` builds at first use, and `build` starts one compiler per source at
once. Builds hold an `fcntl` lock on `_build/`, so processes that start at
once (test workers) build a library once and never load a partial one.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("blend_fwd", "blend_bwd")   # CUDA kernels, for the card
HOST_SOURCES = ("imgdec",)              # host code, for every device
_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# blend_fwd's termination test must round as the plain version's separate
# multiplies and adds, so it contracts nothing; blend_bwd keeps its gate
# uncontracted with _rn intrinsics and may contract the rest (source notes)
NVCC_FLAGS = {
    "blend_fwd": _COMMON_FLAGS + ("-fmad=false",),
    "blend_bwd": _COMMON_FLAGS,
}
_HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

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
    "imgdec": {
        "ht3dgs_jpeg_info": ([_p, ctypes.c_int64, _p, _p, _i], ctypes.c_int),
        "ht3dgs_jpeg_decode": ([_p, ctypes.c_int64, _p, ctypes.c_int64, _p,
                                _i], ctypes.c_int),
        "ht3dgs_png_unfilter": ([_p, ctypes.c_int64, ctypes.c_int64, _i, _p],
                                ctypes.c_int64),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _cuda_tool(tool: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", tool), shutil.which(tool)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{tool} not found (set CUDA_HOME or put it on PATH)")


def _command(name: str):
    """The compiler command for csrc/<name>, without its output path."""
    if name not in HOST_SOURCES:
        return [_cuda_tool("nvcc"), *NVCC_FLAGS[name],
                str(CSRC / f"{name}.cu")]
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"c++ not found (put it on PATH) to build {name}")
    return [cxx, *_HOST_FLAGS, str(CSRC / f"{name}.cc")]


def _lib_path(name: str) -> Path:
    cmd = _command(name)
    h = hashlib.sha1(Path(cmd[-1]).read_bytes())
    if name not in HOST_SOURCES:
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
    h.update(" ".join([os.path.basename(cmd[0])] + cmd[1:-1]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once.
    Returns {name: the compiler's output} (for a kernel, the -Xptxas -v
    register, shared-memory and spill report); an already built source
    maps to ''."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {name: "" for name in names}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        procs = {}
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = _command(name)
            cmd[-1:-1] = ["-o", str(tmp)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}:\n{logs[name]}")
                continue
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>, building it if needed."""
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
