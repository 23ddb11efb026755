"""Build and load the CUDA kernels of this package.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, from the sources in the repository and nothing
else, into ``build/repro_torch/`` at the repository root; the library's file
name carries a hash of the sources and flags, so an edit rebuilds.  Each
source is compiled by its own ``nvcc`` process, all started together, and
the objects are linked in one last step.

Nothing here runs at import time: a machine without ``nvcc`` can import the
package and use the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# C entry point -> argument types (every pointer and the stream is c_void_p:
# without argtypes ctypes would cut a 64-bit pointer to 32 bits)
SIGNATURES = {
    "mcq_probe_find": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mcq_slab_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "mcq_oddeven": [_P, _P, _P, _P, _LL, _I, _I, _P],
    "mcq_cdf_query_fused": [_P, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P,
                            _I, _I, _I, _P],
    "mcq_slow_path": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                      _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "mcq_cdf_query": [_P, _P, _P, _F, _I, _P, _P, _P, _I, _I, _I, _P],
    "mcq_draft_walk": [_P, _LL, _I, _P, _P, _I, _P, _P, _P, _LL, _I, _I, _I,
                       _I, _P, _P, _I, _P],
    "mcq_decay_sort": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I,
                       _P, _P, _I, _P, _P],
    "mcq_copy_dirty_rows": [_P, _P],
    "mcq_dh_rebuild": [_P] * 7 + [_LL, _I, _I, _I, _I, _P],
    "mcq_topn_merge": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "mcq_topn_merge_windows": [_P, _P] + [_I] * 6 + [_P] * 8,
    "mcq_topn_label": [_P, _P, _I, _I, _I, _P, _I, _P, _P],
    "mcq_topn_windows": [_P] * 3 + [_I] * 6 + [_P] * 3,
    "mcq_topn_windows_blocks": [_I] * 6,
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # None until built in this process
build_log: str = ""                     # nvcc's output (-Xptxas -v) when built


def sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for group in sources():
        for path in group:
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            candidates.append(str(Path(root) / "bin" / "nvcc"))
    for cand in candidates:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of repro_torch cannot be built on this machine")


def _compile(lib_path: Path) -> None:
    global build_seconds, build_log
    nvcc = find_nvcc()
    cu_files, _ = sources()
    if not cu_files:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{lib_path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu_files]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(cu_files, objects)
    ]
    logs, failed = [], []
    for src, proc in zip(cu_files, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = BUILD_DIR / f"{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib_path)   # atomic: a reader never sees half a file
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if this source tree's build
    is not there yet: under an exclusive lock on ``build.lock``, so that
    processes starting together build it once (the rename in ``_compile``
    alone keeps a reader from half a file, not two builds from running).
    Raises when it cannot be built or loaded."""
    global _lib
    if _lib is None:
        lib_path = BUILD_DIR / f"libmcq_{source_hash()}.so"
        if not lib_path.exists():
            # one build at a time across processes (soak workers start
            # together): the first builds, the others find its library
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / "build.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not lib_path.exists():
                    _compile(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, device: Optional[torch.device], *args,
           stream: Optional[int] = None) -> None:
    """Call C entry point ``name`` with ``args`` + the current stream of
    ``device``, or + ``stream`` (a stream handle the caller keeps; the entry
    point then makes its device current itself); raise if it reports a
    CUDA error at launch."""
    fn = getattr(load(), name)
    if stream is not None:
        status = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer for ctypes; None (a null pointer) for an
    optional argument left out."""
    return None if x is None else x.data_ptr()


def require_flags(name: str, dirty: Optional[torch.Tensor], rows: int) -> None:
    """``dirty`` is None or one uint8 flag per row (its type, device and
    contiguity are checked with the other tensors)."""
    if dirty is not None and dirty.shape != (rows,):
        raise ValueError(f"{name}: dirty must be uint8[{rows}], one flag per "
                         f"row, got {tuple(dirty.shape)}")


def require_row_hashes(name: str, dh_keys: Optional[torch.Tensor],
                       dh_vals: Optional[torch.Tensor], rows: int) -> int:
    """The per-row dst hashes ``dh_keys/dh_vals`` are both None, or both
    ``[rows, H]`` with H a power of two (their type, device and contiguity
    are checked with the other tensors).  Returns H, 0 for None."""
    if dh_keys is None and dh_vals is None:
        return 0
    if dh_keys is None or dh_vals is None or dh_keys.dim() != 2 \
            or dh_keys.shape != dh_vals.shape or dh_keys.shape[0] != rows:
        raise ValueError(f"{name}: dh_keys/dh_vals must both be [{rows}, H]")
    h = dh_keys.shape[1]
    if h < 1 or h & (h - 1):
        raise ValueError(f"{name}: H must be a power of two, got {h}")
    return h


def require_cuda_int32(name: str, *, strided=(), bools=(), flags=(),
                       floats=(), **tensors) -> None:
    """Every kernel takes contiguous int32 tensors on one CUDA device, but
    the arguments named in ``bools``, which are torch.bool, those named in
    ``flags`` (per-row dirty flags), which are torch.uint8, and those named
    in ``floats``, which are torch.float32.  The arguments
    named in ``strided`` may have a strided leading dimension (the wrapper
    passes that stride to its kernel) but must be unit-stride along their
    last.  An argument given as None (an optional one left out) is
    skipped."""
    device = None
    for arg, x in tensors.items():
        if x is None:
            continue
        if not x.is_cuda:
            raise ValueError(
                f"{name}: {arg} is on {x.device}; the CUDA kernel takes CUDA "
                f"tensors (use impl='ref' or 'auto' for CPU tensors)")
        want = (torch.bool if arg in bools else
                torch.uint8 if arg in flags else
                torch.float32 if arg in floats else torch.int32)
        if x.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {x.dtype}")
        if arg in strided:
            if x.dim() > 1 and x.shape[-1] > 1 and x.stride(-1) != 1:
                raise ValueError(f"{name}: {arg} must be unit-stride along "
                                 f"its last dim")
        elif not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if device is None:
            device = x.device
        elif x.device != device:
            raise ValueError(f"{name}: {arg} is on {x.device}, not {device}")
