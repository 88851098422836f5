"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc (from PATH, else $CUDA_HOME/bin) compiles every source under csrc/ for
sm_90a, one nvcc process per source, all started together, and links the
objects into one shared library with a plain C interface, loaded with
ctypes. The library is named by a hash of the sources and flags, so a stale
build is never loaded; it lands in <repo>/build/kernels/ (git-ignored), with
the compiler's per-kernel register and spill report beside it
(``<library>.log``, from ``-Xptxas -v``). Nothing here runs at import time:
the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (csrc/*.cu, extern "C"); all return a
# cudaError_t as int
_STRIDES = [_L] * 9   # q, k, v: batch, sequence and head strides
SIGNATURES = {
    "vr2_flash_attention_fwd": [_P] * 7 + [_I] * 6 + _STRIDES + [_I, _I, _F, _I, _P],
    "vr2_flash_attention_fwd_layout": [_I, _P],
    "vr2_flash_attention_bwd_dq": [_P] * 9 + [_I] * 6 + _STRIDES + [_I, _I, _F, _I, _P],
    "vr2_flash_attention_bwd_dkv": [_P] * 10 + [_I] * 6 + _STRIDES + [_I, _I, _F, _I, _P],
    "vr2_flash_attention_bwd_layout": [_I, _I, _P],
    "vr2_window_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I,
                                 _L, _L, _L, _L, _L, _L, _F, _I, _P],
    "vr2_window_attention_bwd": [_P] * 8 + [_I, _I, _I] + [_L] * 6 + [_F, _I, _P],
    "vr2_paged_decode_attention": [_P] * 8 + [_I] * 11 + [_F, _P, _P, _P],
    "vr2_moe_ffn": [_P] * 14 + [_I] * 11 + [_P],
    "vr2_moe_gmm_bwd_dx": [_P] * 11 + [_I] * 8 + [_P],
    "vr2_moe_gmm_bwd_dw": [_P] * 7 + [_I] * 7 + [_P],
    "vr2_moe_gmm_bwd_dw_layout": [_I] * 5 + [_P],
    "vr2_int4_matmul": [_P] * 4 + [_I] * 5 + [_P] * 2 + [_I, _P],
    "vr2_int4_matmul_f32": [_P] * 4 + [_I] * 4 + [_P],
    "vr2_int4_matmul_layout": [_P],
    "vr2_decode_attention": [_P] * 5 + [_I] * 11 + [_F, _P, _P, _P],
    "vr2_int8_matmul": [_P] * 4 + [_I] * 3 + [_P],
    "vr2_int8_matmul_stacked": [_P] * 4 + [_I] * 5 + [_P],
    "vr2_int8_matmul_all_layers": [_P] * 4 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "port's CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvr2_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj, log = Path(tmp) / f"{src.stem}.o", Path(tmp) / f"{src.stem}.log"
            with open(log, "w") as f:
                proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                         str(src)], stdout=f, stderr=subprocess.STDOUT)
            jobs.append((src, obj, log, proc))
        failed = [f"{src.name} (nvcc {proc.wait()}):\n{log.read_text()}"
                  for src, _, log, proc in jobs if proc.wait() != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = Path(tmp) / out.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(lib),
                               *(str(obj) for _, obj, _, _ in jobs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(
            "".join(log.read_text() for _, _, log, _ in jobs))
        os.replace(lib, out)
    return out


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
