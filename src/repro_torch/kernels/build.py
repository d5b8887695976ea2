"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<source>.cu`` is compiled at first use by its own ``nvcc``
(all started together) into
``build/repro_torch_kernels/lib<source>-<hash>.so`` under the repository
root, with a plain C interface, and loaded with ``ctypes``; a source may
hold several C entry points (``ENTRIES``).  The hash covers the source,
the shared headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as built.  A failed build raises with nvcc's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# each C entry point: (source, symbol, argtypes); every entry returns the
# cudaError_t of its launch
ENTRIES = {
    "dyad_mm": ("dyad_mm", "repro_dyad_mm_blocks",
                [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _P]),
    "flash_prefill": ("flash_prefill", "repro_flash_prefill",
                      [_P, _P, _P, _P, _P, _P, _I, _P, _I]
                      + [_I] * 6 + [_LL] * 10 + [_I, _I, _F, _I, _P]),
    "flash_decode": ("flash_decode", "repro_flash_decode",
                     [_P] * 5 + [_I, _P, _P] + [_I] * 6 + [_LL] * 10
                     + [_I, _F, _I, _I, _I, _P]),
    "flash_decode_occupancy": ("flash_decode", "repro_flash_decode_occupancy",
                               [_I] * 5 + [_P]),
    "dyad_dgrad": ("dyad_dgrad", "repro_dyad_mm_dgrad_two",
                   [_P] * 6 + [_I] * 4 + [_LL] * 12 + [_I, _P]),
    "dyad_wgrad": ("dyad_wgrad", "repro_dyad_mm_wgrad",
                   [_P] * 7 + [_I] * 7 + [_LL] * 12 + [_I, _I, _P]),
    "flash_bwd": ("flash_bwd", "repro_flash_prefill_grads",
                  [_P] * 9 + [_P, _I, _P, _I] + [_I] * 6 + [_LL] * 14
                  + [_I, _I, _F, _I, _P]),
    "dyad_mm_two": ("dyad_mm_two", "repro_dyad_mm_blocks_two",
                    [_P] * 6 + [_I] * 4 + [_LL] * 12 + [_I, _P]),
    "dyad_dgrad_fused": ("dyad_dgrad_fused", "repro_dyad_mm_dgrad",
                         [_P] * 5 + [_I] * 4 + [_LL] * 9 + [_I, _P]),
    "dyad_ff": ("dyad_ff", "repro_dyad_ff_fused",
                [_P] * 12 + [_I] * 7 + [_LL] * 12 + [_I] * 4 + [_P]),
    "flash_decode_paged": ("flash_decode_paged", "repro_flash_decode_paged",
                           [_P] * 10 + [_I] * 8 + [_LL] * 4
                           + [_I, _F, _I, _I, _P]),
    "flash_decode_paged_occupancy": (
        "flash_decode_paged", "repro_flash_decode_paged_occupancy",
        [_I] * 5 + [_P]),
    "dyad_mm_q": ("dyad_mm_q", "repro_dyad_mm_blocks_q",
                  [_P] * 8 + [_I] * 6 + [_LL] * 9 + [_I] * 3 + [_P]),
    "dyad_mm_two_q": ("dyad_mm_q", "repro_dyad_mm_blocks_two_q",
                      [_P] * 9 + [_I] * 6 + [_LL] * 12 + [_I] * 3 + [_P]),
    "dyad_ff_q": ("dyad_ff", "repro_dyad_ff_fused_q",
                  [_P] * 17 + [_I] * 7 + [_LL] * 12 + [_I] * 4 + [_P]),
}
SOURCES = sorted({src for src, _, _ in ENTRIES.values()})

_lock = threading.Lock()
_entries: dict = {}     # loaded C entry points
_libs: dict = {}        # loaded libraries, one per source


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every stale source, one nvcc each, all in parallel.
    Returns {name: seconds} for the sources built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed, seconds = [], {}
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, path)
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def entry(name: str):
    """The ctypes function of C entry point ``name``, its source built on
    first use."""
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            source, symbol, argtypes = ENTRIES[name]
            lib = _libs.get(source)
            if lib is None:
                path = _lib_path(source)
                if not path.exists():
                    build_all()
                lib = _libs[source] = ctypes.CDLL(str(path))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[name] = fn
        return fn


def sass(source: str) -> str:
    """The SASS of ``source``'s library (``cuobjdump -sass``, from nvcc's
    toolkit), built first if it is not: which instructions each route
    compiled to."""
    path = _lib_path(source)
    if not path.exists():
        build_all()
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
