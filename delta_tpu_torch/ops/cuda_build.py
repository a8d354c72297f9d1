"""Build and load the package's hand-written native code.

Each CUDA source in `delta_tpu_torch/csrc/` has a plain C interface and is
compiled on its own by `nvcc` for Hopper (`sm_90a`) into a shared library,
then loaded with `ctypes`: seconds per kernel, where a build that includes
PyTorch's headers takes minutes. The host library `parquet_host.cpp`
(snappy, ZSTD, the PLAIN BYTE_ARRAY walk and DELTA_BYTE_ARRAY's prefix
chain of the Parquet readers) is built
the same way by the host C++ compiler, so it also builds where there is
no CUDA toolkit. Libraries land in `build/delta_tpu_torch/` beside the
package (listed in `.gitignore`), named by a digest of source and flags,
so an edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import: a library is built the first time its
wrapper calls it, or ahead of time by `build()`, which starts one
compiler per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "delta_tpu_torch"
SOURCES = {
    "byte_class": "byte_class.cu",
    "winner_pack": "winner_pack.cu",
    "hybrid_extract": "hybrid_extract.cu",
    "interleave_bits": "interleave_bits.cu",
    "unpack_bitpacked": "unpack_bitpacked.cu",
    "segmented_minmax": "segmented_minmax.cu",
    "skip_mask": "skip_mask.cu",
    "dv_bits": "dv_bits.cu",
    "merge_join": "merge_join.cu",
    "seg_agg": "seg_agg.cu",
    "window_scan": "window_scan.cu",
    "parquet_host": "parquet_host.cpp",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA toolkit is needed to build the package's kernels")
    return path


def _cxx() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH; "
                           "the Parquet readers' codecs need one")
    return path


def _is_host(name: str) -> bool:
    return not SOURCES[name].endswith(".cu")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    flags = HOST_FLAGS if _is_host(name) else NVCC_FLAGS
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named libraries (all when None) that are not built yet,
    one compiler process per source, all started together. Returns
    {name: {"seconds": wall seconds of its build (0.0 if reused),
    "log": the compiler's output (nvcc's with -Xptxas=-v's register and
    spill report)}}. Raises RuntimeError naming the source when a build
    fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "log": "reused " + target.name}
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        if _is_host(name):
            cmd = [_cxx(), *HOST_FLAGS]
        else:
            cmd = [_nvcc(), *NVCC_FLAGS]
        cmd += ["-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       time.perf_counter(), tmp, target)
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (exit {proc.returncode}):\n"
                          f"{text}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        out[name] = {"seconds": seconds, "log": text}
    if failed:
        raise RuntimeError("native build failed: " + "\n".join(failed))
    return out


def function(name: str, symbol: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of library `name`, built on first use
    (RuntimeError when it cannot be built or loaded). Every kernel entry
    point returns the CUDA error code of its launch."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            try:
                build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                # a library that cannot be built or loaded is a failure of
                # the program, not of the bytes it reads: a RuntimeError,
                # which no fallback of the snapshot load absorbs
                raise RuntimeError(f"native library {name}: {e}") from e
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FUNCS[(name, symbol)] = fn
    return fn


def check_launch(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")
