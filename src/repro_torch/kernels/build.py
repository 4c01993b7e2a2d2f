"""Build, load and count the port's hand-written Hopper kernels.

The CUDA C++ sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, bound with ``ctypes``:
one ``nvcc -c`` per source, all started together, then one link. The build
runs at first use, into ``_build/<hash>/`` beside this file (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a checkout
builds once per source change. A failed build raises; nothing falls back.

Each wrapper that launches a kernel adds one to its entry in
:data:`LAUNCHES` at the launch and nowhere else, so a run can show which
kernels its main path went through (``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libreprokernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: kernel name -> launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {
    "canonical_check": 0,
    "expand_canonical": 0,
    "stream_compact": 0,
    "seg_unique": 0,
    "radix_hist": 0,
    "radix_scatter": 0,
    "canonical_refine": 0,
    "gather_rows": 0,
    "canonical_check_tiles": 0,
    "rmsnorm": 0,
    "flash_attention": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C entry point -> argument types (every entry returns cudaGetLastError()).
_SIGNATURES = {
    "repro_canonical_check": [_P, _P, _P, _P, _L, _I, _L, _L, _P, _P],
    "repro_expand_stage_bytes": [],
    "repro_expand_canonical": [_P, _P, _P, _P, _L, _I, _L, _L, _L, _I, _P, _P,
                               _P, _P],
    "repro_stream_compact": [_P, _L, _I, _P, _P, _P, _P],
    "repro_seg_unique": [_P, _P, _L, _I, _P, _P, _P, _P],
    "repro_seg_unique_tile": [],
    "repro_radix_tile": [],
    "repro_radix_hist": [_P, _P, _L, _P, _P, _P, _P, _P],
    "repro_radix_scatter": [_I, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P],
    "repro_canonical_refine": [_P, _P, _L, _I, _P, _P, _I, _P, _P, _P, _P],
    "repro_gather_rows": [_P, _L, _L, _P, _L, _I, _P, _P],
    "repro_canonical_check_tiles": [_P, _P, _P, _P, _P, _L, _I, _L, _L, _P,
                                    _P],
    "repro_rmsnorm": [_P, _P, _P, _L, _I, _F, _I, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                              _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last build in this process took (0.0 when it was cached).
last_build_seconds = 0.0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's standard install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source at first use"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr((ARCH_FLAGS, NVCC_FLAGS)).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the library path. Raises ``RuntimeError`` with the compiler's
    output when a compile or the link fails."""
    global last_build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    procs = []
    for src in sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(work / LIB_NAME),
               *(str(o) for _, o, _ in procs)]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (work / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"kernel build failed ({', '.join(failed)}):\n" + "\n".join(log)
        )
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    try:
        os.replace(work, out_dir)
    except OSError:
        # another process finished the same build first
        shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    return lib


def build_log() -> str:
    """The compiler output of the current build (``-Xptxas=-v`` register
    and shared-memory report), or '' when none is on disk."""
    p = BUILD_ROOT / source_hash() / "build.log"
    return p.read_text() if p.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


#: ``raw_stream(device)``: the raw handle of PyTorch's current stream on
#: CUDA device ``device`` (an index), read without building a
#: ``torch.cuda.Stream``: the private call behind ``torch._inductor``'s
#: ``get_raw_stream`` (None in a PyTorch built without CUDA).
#: tests/test_torch_cuda.py holds it equal to
#: ``torch.cuda.current_stream(device).cuda_stream``, on a non-default
#: stream too.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch(name: str, fn, device: int, *args) -> None:
    """Count one launch of kernel ``name`` and call its C entry point
    ``fn(*args, stream)`` on PyTorch's current stream of CUDA device
    ``device`` (an index), under a device guard only when that device is
    not the current one; raise on a non-zero status. One Python frame and
    no ``torch.cuda.Stream``: the wrappers whose host time counts
    (rmsnorm, stream_compact, expand_canonical) launch through it."""
    LAUNCHES[name] += 1
    stream = raw_stream(device)
    if device == torch.cuda.current_device():
        status = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            status = fn(*args, stream)
    if status:
        check(status, name)
