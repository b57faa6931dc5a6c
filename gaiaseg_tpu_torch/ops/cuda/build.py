"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>_<digest>.so`` (the digest covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds). Nothing is built when a module is imported: a kernel's wrapper
calls ``load`` at its first launch, and ``build()`` builds every source at
once, one nvcc process each, all started together. The build directory is
inside the package and listed in ``.gitignore``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

from ...utils.tracing import counters

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNEL_SOURCES = ("resize_ce", "flash_attention", "crop_counts")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


# launches of each kernel since the last reset, counted by its wrapper where
# it launches: the tracer's counter group ``launch``
LAUNCHES = counters("launch", ("resize_ce_fwd", "resize_ce_bwd", "flash_fwd",
                               "flash_bwd_dkv", "flash_bwd_dq",
                               "crop_counts"))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use")


# the kernels' builtin-type template arguments, by their mangled letter (any
# other letter is printed as it is)
BUILTIN_TYPES = {"h": "unsigned char", "i": "int", "x": "long long",
                 "f": "float"}


def kernel_name(mangled: str) -> str:
    """A device function's name, with its integer and builtin-type template
    arguments, out of the mangled name ptxas prints:
    ``_ZN12_GLOBAL__N_18fwd_tileILi19EE..`` -> ``fwd_tile<19>``,
    ``..12bwd_tile_anyILi8ELi20ELi2EEEv..`` -> ``bwd_tile_any<8, 20, 2>``,
    ``..13window_countsIhEEv..`` -> ``window_counts<unsigned char>``."""
    rest, parts = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], []
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        end = len(digits) + int(digits)
        parts.append(rest[len(digits):end])
        rest = rest[end:]
    args = re.match(r"I((?:Li\d+E|[a-z])+)E", rest)
    return (parts[-1] if parts else mangled) + (
        "<" + ", ".join(value or BUILTIN_TYPES.get(letter, letter)
                        for value, letter in
                        re.findall(r"Li(\d+)E|([a-z])", args.group(1))) + ">"
        if args else "")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the digest covers the source,
    every shared header ``csrc/*.cuh`` (by name and content) and the
    flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, Dict]:
    """Compile every missing library in ``names`` concurrently.

    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0 and
    ``log`` empty for a library that was already built. Raises
    ``RuntimeError`` with nvcc's output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.is_file():
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)  # atomic: concurrent builders never see halves
        out[name] = {"path": str(path),
                     "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
