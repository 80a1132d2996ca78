"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for Hopper (``sm_90a``) and linked into one shared library with a
plain C interface; nothing here includes PyTorch's headers, so a build
takes seconds. The library lands in ``build/kernels-<hash>/`` beside the
package, keyed on a hash of the sources and flags, so an edited source
builds anew and an unchanged one is loaded as it is.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.

The host's k-means solver (``csrc/host/nuq_kmeans.cpp``) is a library of
its own, built at first use by the host's ``g++`` into
``build/host-<hash>/`` (:func:`host_lib`), so the CPU needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build")
LIB_NAME = "libsqueezellm_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point (csrc/*.cu); all return int (cudaError_t)
SIGNATURES = {
    # x, x_bf16, xt, qweight, lut, rowptr, cols, vals, y0, y0_bf16, y, ws,
    # counters, M, in, out, bits, bf16_mode, variant, row_tile, splits,
    # words_per_split, folds, stream
    "slt_lut_matmul": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_new, v_new, q_bstride, kv_bstride, in_bf16, cos, sin, ck, cv,
    # cache_bf16, lengths, out, ws_acc, ws_ml, counters, B, S, Hkv, g, hd,
    # window, scale, chunk, stream
    "slt_decode_attn": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                        _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                        _I, _P],
    # q, k, v, out, 9 strides, q_bf16, kv_bf16, tensor_cores, B, H, Hkv,
    # Sq, Sk, hd, offset (an int32 on the card), window, scale, stream
    "slt_flash_attn": [_P, _P, _P, _P] + [_I] * 9 + [_I] * 3 + [_I] * 6
                      + [_P, _I, _F, _P],
    # qweight, lut, rowptr, cols, vals, w, in, out, bits, w_bf16, stream
    "slt_dequant_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, x_bf16, xt, qweight, A, d, rowptr, cols, vals, y0, y0_bf16, y,
    # ws, counters, M, in, out, bf16_mode, variant, row_tile, splits,
    # words_per_split, folds, stream
    "slt_lut_matmul_struct": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    # x, x_bf16, qweight_t, lut, y, ws, counters, M, in, out, bf16_mode,
    # splits, words_per_split, stream
    "slt_lut_matmul_t": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _P],
    # x, x_bf16, mt, xt, xt_bytes, rowptr, cols, vals, y0, y0_bf16, y,
    # accumulate, B, in, out, group, stream
    "slt_spmv": [_P, _I, _I, _P, ctypes.c_size_t, _P, _P, _P, _P, _I, _P,
                 _I, _I, _I, _I, _I, _P],
    # slt_decode_attn's, with the scale sidecars sk, sv after ck, cv and no
    # cache_bf16
    "slt_decode_attn_q8": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _I, _P],
    # x, x_bf16, xt, qweight, lut, rowptr, cols, vals, topx_w, topx_idx,
    # topx, offsets, tiles, ntiles, y, ws, counters, P, in, out, bits,
    # variant, row_tile, splits, words_per_split, folds, stream
    "slt_moe_lut_matmul": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                           _P, _I, _P, _P, _P] + [_I] * 9 + [_P],
    # d, inv, w, res, out, rows, k, n, bf16, stream
    "slt_moe_combine": [_P] * 5 + [_I] * 4 + [_P],
}
# q, k_new, v_new, 3 q strides, 3 k/v strides, in_bf16, cos, sin, then the
# pool (pk, pv, cache_bf16; or pk, pv, sk, sv for the int8 twins), then
# page_tables, lengths or starts, out, ws_acc, ws_ml, counters, B, W, ps,
# maxp, Hkv, g, hd, window, scale, chunk, stream
_PAGED_HEAD = [_P, _P, _P] + [_I] * 6 + [_I, _P, _P]
_PAGED_TAIL = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
for _name in ("slt_paged_decode_attn", "slt_paged_verify_attn"):
    SIGNATURES[_name] = _PAGED_HEAD + [_P, _P, _I] + _PAGED_TAIL
    SIGNATURES[_name + "_q8"] = _PAGED_HEAD + [_P, _P, _P, _P] + _PAGED_TAIL

_lib: Optional[ctypes.CDLL] = None

HOST_SOURCE = os.path.join(CSRC_DIR, "host", "nuq_kmeans.cpp")
HOST_LIB_NAME = "libsqueezellm_torch_host.so"
HOST_CXX = "g++"
# no -march=native: with these flags the copy gives the JAX package's
# committed library's bits (tests/test_torch_quantize.py holds them equal)
HOST_FLAGS = ["-O3", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]
_host_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR,
                                                           "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source hash has no library yet.

    Returns the library's path. The compiler's output (``-Xptxas -v``:
    registers, shared memory and spills of each kernel) and each source's
    seconds from the common start are kept beside it in ``build.log``."""
    out_dir = os.path.join(BUILD_ROOT, f"kernels-{_source_hash()}")
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    tmp = tempfile.mkdtemp(dir=out_dir)
    try:
        procs = []
        t0 = time.perf_counter()
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            with open(obj + ".log", "w") as out:
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=out, stderr=subprocess.STDOUT)))
        seconds = {}
        while len(seconds) < len(procs):
            for src, _, p in procs:
                if src not in seconds and p.poll() is not None:
                    seconds[src] = time.perf_counter() - t0
            time.sleep(0.05)
        logs, failed = [], []
        for src, obj, p in procs:
            with open(obj + ".log") as f:
                out = f.read()
            logs.append(f"== {os.path.basename(src)} (rc {p.returncode}, "
                        f"{seconds[src]:.1f} s)\n{out}")
            if p.returncode != 0:
                failed.append(os.path.basename(src))
        log = "\n".join(logs)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log[-8000:]}")
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_lib, *[o for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.slt_error_string.argtypes = [ctypes.c_int]
        handle.slt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def build_host() -> str:
    """Compile the host solver if this source and flag hash has no library
    yet; returns its path. Raises RuntimeError when ``g++`` is missing or
    fails."""
    h = hashlib.sha256(" ".join([HOST_CXX, *HOST_FLAGS]).encode())
    with open(HOST_SOURCE, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, f"host-{h.hexdigest()[:16]}")
    lib_path = os.path.join(out_dir, HOST_LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    cxx = shutil.which(HOST_CXX)
    if cxx is None:
        raise RuntimeError(f"{HOST_CXX} not found on PATH")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=out_dir)
    try:
        tmp_lib = os.path.join(tmp, HOST_LIB_NAME)
        res = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp_lib, HOST_SOURCE],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{HOST_CXX} failed on "
                               f"{os.path.basename(HOST_SOURCE)}:\n"
                               f"{res.stdout[-4000:]}")
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def host_lib() -> ctypes.CDLL:
    """The loaded host solver library (built on first call)."""
    global _host_lib
    if _host_lib is None:
        handle = ctypes.CDLL(build_host())
        fn = handle.nuq_weighted_kmeans_batched
        # values, weights, C, N, k, max_iter, seed, tol, centroids, labels
        fn.argtypes = [_P, _P, _I, _I, _I, _I, ctypes.c_uint32,
                       ctypes.c_double, _P, _P]
        fn.restype = None
        _host_lib = handle
    return _host_lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().slt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
