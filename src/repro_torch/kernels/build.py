"""Build and load the port's hand-written CUDA kernels.

The sources under ``src/repro_torch/csrc/`` have a plain C interface and
are compiled by ``nvcc`` for ``sm_90a`` into one shared library, loaded
with ``ctypes``. Each ``.cu`` compiles to its own object in a separate
``nvcc`` process, all started together, and one link step joins them.
The library lands in ``build/kernels/`` at the repository root, named by
a hash of the sources and flags, so a process builds at most once and a
changed source never loads a stale library; each source's compiler
output (ptxas's registers and spills per kernel) lands beside it.

Nothing is built when this module is imported: ``load()`` builds on the
first kernel launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
REPO_ROOT = _PKG.parents[1]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
SOURCES = ("paged_decode_attention.cu", "chunked_prefill_attention.cu",
           "fused_swiglu.cu", "decode_attention.cu",
           "decode_attention_quant.cu", "paged_decode_attention_quant.cu",
           "selective_scan.cu", "rglru_scan.cu")
HEADERS = ("common.cuh", "decode_split.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "acar_paged_decode_attention":
        [_VP] * 6 + [_I] * 7 + [_VP],
    "acar_chunked_prefill_attention":
        [_VP] * 6 + [_I] * 9 + [_VP],
    "acar_fused_swiglu":
        [_VP] * 5 + [_I] * 3 + [_VP],
    "acar_swiglu_gate_up":
        [_VP] * 4 + [_I] * 3 + [_VP],
    "acar_swiglu_down":
        [_VP] * 3 + [_I] * 3 + [_VP],
    "acar_decode_attention":
        [_VP] * 4 + [_I] * 7 + [_VP],
    "acar_decode_attention_quant":
        [_VP] * 6 + [_I] * 7 + [_VP],
    "acar_paged_decode_attention_quant":
        [_VP] * 8 + [_I] * 7 + [_VP],
    "acar_decode_split_ctas": [],
    "acar_decode_split_start": [_I] * 2,
    "acar_selective_scan_chunk": [],
    "acar_selective_scan_plan": [_I] * 3,
    "acar_selective_scan_fwd":
        [_VP] * 8 + [_I] * 5 + [_VP],
    "acar_selective_scan_bwd":
        [_VP] * 16 + [_I] * 5 + [_VP],
    "acar_rglru_scan_plan": [_I] * 2,
    "acar_rglru_scan_fwd":
        [_VP] * 4 + [_I] * 5 + [_VP],
    "acar_rglru_scan_bwd":
        [_VP] * 6 + [_I] * 5 + [_VP],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# the wave scheduler launches from its prefetch thread beside the main
# thread, so a wrapper's count is read, added to and stored under a lock
_count_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels need the CUDA "
            "toolkit (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libacar_kernels_{_digest()}.so"


def log_path(source: str) -> Path:
    """nvcc's output for one source of this build: ptxas's registers,
    shared memory and spills for each kernel (``-Xptxas=-v``)."""
    return BUILD_DIR / f"{library_path().stem}_{Path(source).stem}.log"


def build() -> Path:
    """Compile the kernels (if this exact build is not there yet) and
    return the shared library's path. Raises with nvcc's output on a
    failed compile."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    tag = so.stem
    procs = []
    objs: List[Path] = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{tag}_{Path(name).stem}.o"
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode})\n{out}")
        else:
            log_path(name).write_text(out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [compiler, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"kernel link failed:\n{link.stdout}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.acar_error_string.argtypes = [ctypes.c_int]
            lib.acar_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().acar_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``: each wrapper calls this where it
    launches its kernel, and nowhere else."""
    with _count_lock:
        wrapper.launches += 1


def dtype_code(dtype: torch.dtype, kernel: str) -> int:
    """The C interface's dtype tag (common.cuh ``acar::DType``)."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"{kernel}: takes float32 or bfloat16, got {dtype}")


def check_cuda(kernel: str, **tensors: torch.Tensor) -> torch.device:
    """Validate that every tensor is a contiguous CUDA tensor on one
    device; return that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return dev


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C interface's
    ``void*``."""
    return torch.cuda.current_stream(device).cuda_stream
