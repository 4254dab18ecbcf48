"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ``ctypes``.  The library goes into
``build/kernels/`` at the root of the checkout, named by a hash of its
source, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built when a module is imported: the first call of a
kernel on a CUDA tensor builds it, or ``build_all()`` builds every kernel
at once, one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
_PL = ctypes.POINTER(ctypes.c_longlong)
# the q8 scatter's ring: inputs, outputs, stages, order, n, chunks, dtype,
# blocks per rank, flags, credits, epoch, the stream
_RING = [_P, _P, _P, _P, _I, _L, _I, _I, _P, _P, _P, _P]
# the broadcast gathers: inputs and outputs of each payload, n, bytes
# (row 1) or chunks (row 9) of a shard, blocks per rank, the stream
_BCAST = [_P, _P, _I, _L, _I, _P]
# the chained rings: inputs, outputs, order, n, c, element size (gather) or
# dtype code (scatter), layers; the launch plan (slice, tile bytes, own and
# first slots, recv slots per hop, blocks per rank); the per-layer signal
# words (gather: done; scatter: reverse, accumulate, ready, ready value);
# the stream
_CHAIN = [_P, _P, _P, _I, _L, _I, _I, _L, _I, _I, _I, _I, _I]
_GATHER_LAYERS = _CHAIN + [_P, _P]
_SCATTER_LAYERS = _CHAIN + [_I, _I, _P, ctypes.c_uint, _P]

# C entry points of each kernel library and their argument types
SIGNATURES = {
    "flash_attention": {
        "repro_flash_attention_fwd": [_P] * 8 + [_I] * 7 + [_L] * 12
                                     + [_I, _I, _F, _F, _P],
        "repro_flash_attention_state": [_P] * 10 + [_I] * 7 + [_L] * 9
                                       + [_I, _I, _F, _F, _P],
        # B, S, T, H, KH, hd, dtype, state -> the launch shape
        "repro_flash_attention_plan": [_I] * 8 + [_PI]},
    "odc_gather": {"repro_odc_gather": _BCAST,
                   "repro_odc_gather_capacity": [_PI],
                   "repro_odc_gather_layers": _GATHER_LAYERS,
                   # n, dynamic shared memory -> clusters
                   "repro_odc_gather_layers_capacity": [_I, _I, _PI]},
    # the pull scatter: inputs, outputs, order, n, c, dtype, blocks per
    # rank, the stream
    "odc_scatter": {"repro_odc_scatter": [_P, _P, _P, _I, _L, _I, _I, _P],
                    "repro_odc_scatter_capacity": [_I, _PI],
                    "repro_odc_scatter_layers": _SCATTER_LAYERS,
                    "repro_odc_scatter_layers_capacity": [_I, _I, _I,
                                                          _PI]},
    "quant": {"repro_quantize": [_P, _P, _P, _L, _P],
              "repro_dequantize": [_P, _P, _P, _L, _P]},
    # the q8 gather: codes in and out, then scales in and out
    "odc_q8": {"repro_odc_gather_q8": [_P, _P] + _BCAST,
               "repro_odc_gather_q8_capacity": [_PI],
               "repro_odc_scatter_q8": _RING,
               "repro_odc_scatter_q8_capacity": [_PI]},
    # x, dt, A, B, C, y, state, workspace, its bytes; b, s, h, p, g, n, Q,
    # dtype; the stream
    "ssd_scan": {"repro_ssd_scan": [_P] * 8 + [_L] + [_I] * 8 + [_P],
                 # b, s, h, p, g, n, Q -> the four launches, workspace bytes
                 "repro_ssd_scan_plan": [_I] * 7 + [_PL]},
    # the ranks' x, shard and output pointer tables; n, m, k, f (the
    # CUDA-core route: dtype); the stream
    "gather_matmul": {"repro_gather_matmul_tc": [_P] * 3 + [_I] * 4 + [_P],
                      "repro_gather_matmul_simt": [_P] * 3 + [_I] * 5
                                                  + [_P],
                      # n, m, k, f, dtype, route, aligned -> the launch
                      "repro_gather_matmul_plan": [_I] * 7 + [_PI]},
}

_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def _target(name: str) -> Path:
    """The library of ``name``, keyed by its source and the shared
    headers it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names=tuple(SIGNATURES)) -> dict:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all running at once.  Returns
    ``{name: {"seconds": wall time, "ptxas": nvcc's output}}`` of the
    kernels it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    logs = {}
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        logs[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str):
    """The loaded library of kernel ``name``, built on first use; its C
    entry points (``SIGNATURES[name]``) are attributes with their argument
    types set, each returning a CUDA error code."""
    lib = _libs.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(target))
        for symbol, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib
