"""Build and load the port's CUDA kernels at first use.

Every source under ``csrc/`` exposes a plain C interface (no PyTorch
headers), so ``nvcc`` compiles each into an object, all sources at once in
parallel, links them into one shared library and ``ctypes`` loads it.  The
library file is named by a hash of the sources and the flags: an edited
source builds a new library, a stale one is never loaded.  Nothing here runs at import time — the CPU test suite imports this
module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stamp_tpu_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills per kernel, into the build log
]  # fmt: skip

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C entry points: name → argtypes (pointers and the stream as c_void_p, so
# ctypes never truncates a 64-bit address).  Each returns a cudaError_t.
_SIGNATURES = {
    # qkv, out, batch, n, heads, head_dim, device, stream
    "stamp_fused_qkv_attn": [_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR],
    # the same, for n > 272 (fused_qkv_long.cu)
    "stamp_fused_qkv_long": [_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR],
    # x, gamma, beta, weight, dense_bias|NULL, scratch, out, m, n, k, eps,
    # device, stream
    "stamp_ln_dense": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
        ctypes.c_float, _INT, _PTR,
    ],
    # x, gamma, beta, s_x, weight_q, w_scale, dense_bias|NULL, scratch, out, m,
    # n, k, eps, device, stream
    "stamp_ln_quant_dense": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT,
        _INT, ctypes.c_float, _INT, _PTR,
    ],
    # q, k, v, coords, slopes, workspace, out, bh, n, head_dim, scale,
    # exempt_first, device, stream
    "stamp_flash_alibi2d_fwd": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
        ctypes.c_float, _INT, _INT, _PTR,
    ],
    # bh, n, head_dim, bytes (an int64 out)
    "stamp_flash_alibi2d_workspace": [_INT, _INT, _INT, _PTR],
    # q, k, v, mask, workspace, o, lse, bh, tq, tk, head_dim, scale, device,
    # stream
    "stamp_flash_attn_fwd": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
        ctypes.c_float, _INT, _PTR,
    ],
    # bh, tq, tk, head_dim, bytes (an int64 out)
    "stamp_flash_attn_fwd_workspace": [_INT, _INT, _INT, _INT, _PTR],
    # q, k, v, mask, cq, ck, dist_scale, workspace, o, dacc, out, lse, bh, tq,
    # tk, head_dim, scale, device, stream
    "stamp_flash_alibi_fwd": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _PTR, _INT, _INT, _INT, _INT, ctypes.c_float, _INT, _PTR,
    ],
    # bh, tq, tk, head_dim, bytes (an int64 out)
    "stamp_flash_alibi_fwd_workspace": [_INT, _INT, _INT, _INT, _PTR],
    # q, k, v, mask, dout, out, lse, workspace, dq, dk, dv, bh, tq, tk,
    # head_dim, scale, device, stream
    "stamp_flash_attn_bwd": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _INT, _INT, _INT, _INT, ctypes.c_float, _INT, _PTR,
    ],
    # bh, tq, tk, head_dim, bytes (an int64 out)
    "stamp_flash_attn_bwd_workspace": [_INT, _INT, _INT, _INT, _PTR],
    # ca, cb, val, b_mask|NULL, a_mask|NULL, workspace, out, bh, ta, tb,
    # head_dim, device, stream
    "stamp_dist_weighted_sum": [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
        _INT, _PTR,
    ],
    # bh, ta, tb, head_dim, bytes (an int64 out)
    "stamp_dist_weighted_sum_workspace": [_INT, _INT, _INT, _INT, _PTR],
}  # fmt: skip
# entry points that return something else than a cudaError_t: name → (argtypes, restype)
_OTHER_SIGNATURES = {"stamp_cuda_error_string": ([_INT], ctypes.c_char_p)}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libstamp_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled at first use and "
            "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link.

    The ptxas report goes to ``<library>.log``.  A failed build raises with
    nvcc's stderr."""
    lib_path = library_path()
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(out + err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{err}")
    objs = [obj for _, obj, _ in jobs]
    tmp = lib_path.with_name(f"{tag}.tmp.so")
    try:
        if failed:
            raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"linking the CUDA kernels failed ({' '.join(cmd)}):\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    lib_path.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            entry_points = {name: (argtypes, ctypes.c_int) for name, argtypes in _SIGNATURES.items()}
            for name, (argtypes, restype) in (entry_points | _OTHER_SIGNATURES).items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().stamp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
