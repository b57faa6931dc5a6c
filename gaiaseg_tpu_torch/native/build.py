"""Build the native packio reader with g++ at first use, load it with ctypes.

``packio.cc`` compiles into ``gaiaseg_tpu_torch/_build/libpackio_<digest>.so``;
the digest covers the source and the flags, so an edited source rebuilds.
The compiler writes a name of its own (the process id in it) and the result
is renamed into place with ``os.replace``: processes that build at once
(test workers) each finish a whole library, and none loads a half-written
one. A failed build raises; nothing falls back to a Python reader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "packio.cc"
BUILD_DIR = NATIVE_DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libpackio_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """The built library's path, compiling it first if it is missing.
    Raises ``RuntimeError`` with the compiler's output when g++ is missing
    or fails."""
    path = library_path()
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"packio build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"packio build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    u8p, i64p = c.POINTER(c.c_uint8), c.POINTER(c.c_int64)
    sigs = {
        "packio_open": (c.c_void_p, [c.c_char_p]),
        "packio_close": (None, [c.c_void_p]),
        "packio_len": (c.c_int64, [c.c_void_p]),
        "packio_shape": (c.c_int, [c.c_void_p, i64p]),
        "packio_read_batch": (c.c_int, [c.c_void_p, i64p, c.c_int64, u8p,
                                        c.POINTER(c.c_int32), c.c_int]),
        "packio_read_batch_u8": (c.c_int, [c.c_void_p, i64p, c.c_int64, u8p,
                                           u8p, c.c_int]),
        "packio_create": (c.c_void_p, [c.c_char_p, c.c_uint64, c.c_uint32,
                                       c.c_uint32, c.c_uint32, c.c_uint32]),
        "packio_append": (c.c_int, [c.c_void_p, u8p, u8p, c.c_uint64,
                                    c.c_uint64]),
        "packio_finish": (c.c_int, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_packio() -> ctypes.CDLL:
    """The loaded library, built first if needed (once a process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _declare(ctypes.CDLL(str(build())))
        return _LIB
