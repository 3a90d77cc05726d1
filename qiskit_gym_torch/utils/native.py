"""ctypes loader for the port's C++ host runtime (`csrc/vf2.cpp`).

The extension speeds up construction-time host work: the graph automorphism
enumeration of the symmetry ("twists") subsystem. It is built at first use
with the host C++ compiler (`$CXX`, else `c++` or `g++`) into `csrc/build/`,
named by a content hash of the source and the flags, and loaded with ctypes.
Where no compiler exists, `graph_automorphisms` returns None and
`spec/symmetry.py` takes its pure-Python enumerator; a compiler that fails
on the source raises, with its diagnostics. Each call that the native
enumerator answered adds one to `graph_automorphisms.calls`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
# up to CAP // n permutations come back; more is an overflow, and the caller
# falls back to the pure-Python enumerator
CAP = 4_000_000

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _compiler() -> Optional[str]:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((CSRC / "vf2.cpp").read_bytes())
    return BUILD_DIR / f"libqgt_native-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """The built library, compiled now if it is missing; None without a
    compiler. A failed compile raises RuntimeError with the compiler's
    output."""
    out = lib_path()
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                           str(CSRC / "vf2.cpp")],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {CSRC / 'vf2.cpp'} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds all end with one file
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        path = build()
        if path is not None:
            lib = ctypes.CDLL(str(path))
            lib.qgt_automorphisms.restype = ctypes.c_longlong
            lib.qgt_automorphisms.argtypes = [
                ctypes.c_int,                      # n
                ctypes.POINTER(ctypes.c_uint8),    # adjacency n*n
                ctypes.POINTER(ctypes.c_int),      # out perms buffer
                ctypes.c_longlong,                 # out capacity (ints)
            ]
            _LIB = lib
    return _LIB


def graph_automorphisms(num_qubits: int, adj: List[set]
                        ) -> Optional[List[List[int]]]:
    """All automorphisms of the graph `adj` (sorted), enumerated by the C++
    extension; None if it is unavailable or overflows its buffer."""
    lib = _load()
    if lib is None:
        return None
    n = num_qubits
    flat = (ctypes.c_uint8 * (n * n))()
    for i, nbrs in enumerate(adj):
        for j in nbrs:
            flat[i * n + j] = 1
    out = (ctypes.c_int * CAP)()
    count = lib.qgt_automorphisms(n, flat, out, CAP)
    if count < 0:  # overflow or error: let the caller fall back
        return None
    graph_automorphisms.calls += 1
    perms = [[out[k * n + j] for j in range(n)] for k in range(count)]
    perms.sort()
    return perms or [list(range(n))]


graph_automorphisms.calls = 0
