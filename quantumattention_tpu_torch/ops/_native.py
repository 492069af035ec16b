"""Build and load the hand-written CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, into ``build/kernels/<hash>/`` beside the package (a
directory ``.gitignore`` lists), keyed by a hash of the sources and flags,
so a fresh checkout builds everything on its first kernel call.  A build
failure raises; nothing falls back.

Each C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when that is not 0 (a launch refused for its
resources never runs, and a later synchronize does not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: argtypes of every C entry point (pointers and the stream as c_void_p).
_SIGNATURES = {
    # q, k, v, scale_q, scale_k, out, B, Hq, Hkv, Sq, Skv, D,
    # q_code, k_code, v_code, out_code, scaling, causal, score_scale,
    # q_offset, kv_offset, window left, window right (1 << 30: unbounded),
    # m_out, l_out, tiles (the tile configuration), scale_v, q_seg, kv_seg,
    # tile_count, tile_list, list_stride, granules, granule_cols, stream
    "qa_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P, _P, _I,
                     _P, _P, _P, _P, _P, _I, _P, _I, _P],
    # W, QK code, tiles -> K1's shared-memory bytes (0: no such configuration)
    "qa_flash_fwd_smem": [_I, _I, _I],
    # x, partial, codes, block_scale, row_scale, BH, S, D, W, code,
    # block_rows, stream (the per-block quantizer, csrc/block_quant.cu)
    "qa_block_quant": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # BH, S, block_rows -> fp32 scratch entries of qa_block_quant
    "qa_block_quant_partials": [_I, _I, _I],
    # q, k, v, dout, stats, dq, B, Hq, Hkv, Sq, Sq_pad, Skv, D, code, causal,
    # window left, window right (1 << 30: unbounded), score_scale, sm_scale,
    # stream
    "qa_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _F, _F, _P],
    # q, k, v, dout, stats, dk, dv, B, Hq, Hkv, Sq, Sq_pad, Skv, D, code,
    # causal, window left, window right, score_scale, sm_scale, stream
    "qa_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _F, _F, _P],
    # q, k, v, k_scale, v_scale, lengths, out, part_acc, part_ml,
    # B, Hq, Hkv, Smax, D, T, kind (ops/decode.KINDS), window_left (-1:
    # none), score_scale, stream (K4)
    "qa_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _I, _I, _F, _P],
    # kind, B, Hq, Hkv, D, T, smax, ps (0 for K4), out (int[8]: CTAs, query
    # splits, column splits, rows and columns of a split, segments a slot,
    # TMA, width) -> the plan of qa_decode / qa_paged_decode (the split-KV
    # core, csrc/decode_attn.cuh)
    "qa_decode_attn_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # M, N, K, requested (0 = the card's rule) -> K ranges of qa_qmm_f32
    "qa_qmm_splits": [_I, _I, _I, _I],
    # x (fp32), w, scale, out (fp32), partial, M, N, K, int4, splits, stream
    "qa_qmm_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, scale, out, partial, M, N, K, int4, stream (K5, K6 and K7 over
    # bf16 rows, csrc/qgemm.cu)
    "qa_qgemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # M, N, K, out (int[7]: whole, row tiles, column tiles, k-blocks, CTAs,
    # base, rem) -> activation width
    "qa_qgemm_schedule": [_I, _I, _I, _P],
    # M, N, K -> fp32 partial-sum entries of qa_qgemm
    "qa_qgemm_workspace": [_I, _I, _I],
    # x, attn, wo (q, s, int4), norm, w_gate_up (q, s, int4),
    # w_down (q, s, int4), next_norm, w_qkv (q, s, int4), out, qkv_out,
    # x1, h, act, partial, M, E, Q, I, F, eps, n_launches (int*), stream
    "qa_layer_tail": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I,
                      _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _F, _P, _P],
    # M, E, Q, I, F -> fp32 partial-sum entries qa_layer_tail needs
    "qa_layer_tail_workspace": [_I, _I, _I, _I, _I],
    # x, q, k, v, k_scale, v_scale, lengths, window_left, wo (q, s), norm,
    # w_gate_up (q, s), w_down (q, s), next_norm, w_qkv (q, s), out,
    # qkv_out, attn, x1, h, act, partial, B, Hq, Hkv, S, D, E, I, F,
    # score_scale, eps, n_launches (int*), stream
    "qa_decode_layer": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P],
    # B, Q (= Hq * D), E, I, F -> fp32 scratch entries qa_decode_layer needs
    "qa_decode_layer_workspace": [_I, _I, _I, _I, _I],
    # M, N, K, out (int[5]: CTAs, base, rem, tiles, k-blocks) -> width
    "qa_tail_schedule": [_I, _I, _I, _P],
    # M, N, K -> fp32 partial-sum entries of one tail product
    "qa_tail_workspace": [_I, _I, _I],
    # x, w, scale, int4, out, partial, M, N, K, stream
    "qa_tail_matmul": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    # q, k_pages, v_pages, k_scale, v_scale, lengths, page_indices, out,
    # part_acc, part_ml, B, Hq, Hkv, num_pages, page_size, pages_per_seq, D,
    # T, kind (ops/decode.KINDS), window_left (-1: none), score_scale, stream
    "qa_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _F, _P],
}


class _State:
    lib = None
    build_seconds = None
    build_log = ""


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension

    if cpp_extension.CUDA_HOME:
        cand = Path(cpp_extension.CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build() -> Path:
    cus, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cus + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libqa_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"tmp-{os.getpid()}"
    objs = [out_dir / f"{cu.stem}.{tag}.o" for cu in cus]
    t0 = time.perf_counter()
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in (
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)]
            for cu, obj in zip(cus, objs)
        )
    ]
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    tmp = out_dir / f"{tag}.so"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append((link, proc.stdout, proc.returncode))
    _State.build_seconds = time.perf_counter() - t0
    _State.build_log = "".join(out for _, out, _ in logs)
    failed = [(cmd, out, rc) for cmd, out, rc in logs if rc != 0]
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}" for cmd, out, rc in failed
        ))
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()
    return lib_path


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    if _State.lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.qa_qgemm_columns.argtypes = [_P]  # out (int[128]): the column permutation
        lib.qa_qgemm_columns.restype = None
        lib.qa_error_string.argtypes = [ctypes.c_int]
        lib.qa_error_string.restype = ctypes.c_char_p
        _State.lib = lib
    return _State.lib


def build_info() -> dict:
    """Seconds the last build in this process took (None when the library
    was already built) and the compiler's output (registers, spills)."""
    return {"seconds": _State.build_seconds, "log": _State.build_log}


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().qa_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


#: Element-type codes shared with the C sources (csrc/common.cuh).
DTYPE_CODES = {
    torch.bfloat16: 0,
    torch.float16: 1,
    torch.float8_e4m3fn: 2,
    torch.int8: 3,
}
#: fp32 as an output code only (K1 stores fp32 outputs); no kernel reads it.
F32_OUT_CODE = 4


def dtype_code(dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"no kernel element type for {dtype}")
    return DTYPE_CODES[dtype]
