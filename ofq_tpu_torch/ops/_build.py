"""Build and load the CUDA kernels of `ofq_tpu_torch/csrc/`.

Each `.cu` source exports a plain C launcher and is compiled by `nvcc` into
its own shared library, loaded with `ctypes`: no PyTorch headers, so a
source compiles in seconds.  Libraries go to `ofq_tpu_torch/_build/`
under a name that hashes the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  `build_all()` starts one `nvcc`
per source, all at once.

Nothing here runs at import: a kernel's library is built at its first
launch (or by an explicit `build_all()`), and a build failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -O3, sm_90a, IEEE division and sqrt; no --use_fast_math (it makes `/`
# approximate and flushes denormals, either of which moves a value across
# a rounding boundary).  The kernels use the __f*_rn intrinsics wherever
# an FMA contraction would change a rounding decision.
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
SOURCES = ("fused_qlinear", "fused_attention")

# name -> loaded library; a process-wide cache of immutable handles
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        p = Path(root) / "bin" / "nvcc"
        if root and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of ofq_tpu_torch cannot be built")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns each `nvcc`'s
    compiler report (registers, shared memory, spills) by name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports, failed = {}, []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        reports[name] = log
        if p.returncode != 0:
            failed.append(f"--- {name}.cu (exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a CUDA error code returned by one of `lib`'s launchers."""
    if err != 0:
        fn = lib.ofq_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what}: CUDA error {err} at launch: {fn(err).decode()}")
