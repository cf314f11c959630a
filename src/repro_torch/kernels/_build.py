"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` (H100) into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, one ``nvcc`` per source started together, and lands in
``src/repro_torch/_build/<hash>/``, keyed by a hash of the sources and the
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
PTXAS_LOG = "ptxas.log"   # nvcc's -Xptxas -v output, beside the library
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no FMA contraction, so each kernel is bitwise equal to its
# plain PyTorch version (every operation is rounded on its own)
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
SIGNATURES = {
    "repro_spmv_ell_batched": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_cheby_step": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                         _F, _F, _P],
    "repro_cheby_smooth_zero": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                _F, _P],
    "repro_cheby_prolong_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _F, _P],
    "repro_restrict_residual": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _P],
    "repro_similarity_mark": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _P, _I, _I, _P],
    "repro_spmv_ell": [_P, _P, _P, _P, _I, _I, _P],
    "repro_ssm_scan": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P, _P, _I,
                       _I, _I, _I, _I, _P],
    "repro_ssm_scan_bwd": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P],
    "repro_ssm_scan_bwd_run": [],
    "repro_laplacian_residual": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_laplacian_residual_fold": [_P, _P, _I, _I, _I, _P],
    "repro_laplacian_residual_rows": [],
}

_lib: Optional[ctypes.CDLL] = None
_lib_made = threading.Lock()   # one thread runs nvcc on first use
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path.  The compiler's output (``-Xptxas -v``: each
    kernel's registers, shared memory and spills) lands in
    :data:`PTXAS_LOG` beside the library, so a cached build can be
    checked too (:mod:`repro_torch.analysis.cuda_check`).  Raises with
    the compiler's output on failure."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "librepro_torch_kernels.so"
    log_path = out_dir / PTXAS_LOG
    if lib_path.exists() and log_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True,
                          log=log_path.read_text())
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for src, obj, proc in procs:
            text = proc.communicate()[0].decode(errors="replace")
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" +
                               "\n".join(logs))
        tmp_log = Path(tmp) / PTXAS_LOG
        tmp_log.write_text("\n".join(logs))
        os.replace(tmp_log, log_path)
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" +
                               link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds agree
    build_info.update(path=str(lib_path),
                      seconds=time.perf_counter() - t0, cached=False,
                      log="\n".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_made:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {status}")
