"""Build and load the port's CUDA kernels (route: `nvcc` into a shared
library with a plain C interface, loaded with `ctypes`).

Each `csrc/<name>.cu` compiles, at first use, to
`_build/lib<name>-<hash>.so`, where the hash covers the source, every
shared header `csrc/*.cuh` and the flags, so an edited source or header
rebuilds and an unchanged one is reused.
`build()` starts one `nvcc` per source, all at once, and waits for them
together.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("raft_tick", "leader_fanout", "ae_sync", "group_digest",
           "flash_attention", "decode_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, in parallel.
    Returns {name: library path}; raises with nvcc's output on failure.
    The ptxas report (registers, shared memory, spills) is kept beside
    each library as `<lib>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(names)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first when
    needed (once per process)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return _LOADED[name]


def bind(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int):
    """Declare `fn(ptr * n_ptr, int * n_int, stream) -> int` and return
    it; every pointer and the stream pass as `c_void_p` so none is cut
    to 32 bits."""
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int +
                  [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f
