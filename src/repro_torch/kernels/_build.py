"""Build, load and count the port's CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and linked into one shared library
with a plain C interface, ``build/repro_torch_kernels/libpqdtw.so`` at the
repository root.  The library is rebuilt when a source or the flags
change (a SHA-256 stamp beside it) and loaded with :mod:`ctypes`.
A rebuild holds an exclusive ``flock`` on ``build.lock`` in the build
directory, so processes that start together (test workers on one card
machine) compile once and never load a half-written library.
Pointers and the stream go in as ``c_void_p``, sizes as ``c_int``.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` never builds.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.  :data:`LAUNCHES` counts each
kernel's launches (one per successful wrapper call on a CUDA tensor), so a
run can show that its path went through the kernels.  Counting and the
first load take a thread lock, since a server's threads launch kernels
concurrently.  Launches made inside :func:`counted_apart` (the tuner's
measurements) count in the dict it is given, never in :data:`LAUNCHES`.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["LAUNCHES", "reset_launches", "count_launch", "counted_apart",
           "build", "lib", "check", "kernel_device", "ptr", "stream",
           "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "libpqdtw.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# --fmad=false: every product and sum rounds on its own, as in the
# reference, so distances and lerp positions match it to the bit.
FLAGS = ("-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC", ARCH,
         "-Xptxas=-v")

# dtw_band_adaptive's wdtw, erp and msm launches count under their own
# ``op[measure]`` names (the dispatch ledger's key form), its dtw launches
# under the bare name.  A pq_attn launch over a window (start > 0) counts
# under ``pq_attn`` and also under ``pq_attn[window]``.
KERNELS = ("dtw_band", "dtw_band_cdist", "adc_sym", "adc_lookup",
           "prealign_encode", "lb_refine", "dtw_band_adaptive",
           "lb_refine_adaptive", "adc_sym_quant", "adc_lookup_quant",
           "pq_attn", "dtw_band_full", "dtw_band_adaptive[erp]",
           "dtw_band_adaptive[msm]", "dtw_band_adaptive[wdtw]",
           "pq_attn[window]")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_lib: Optional[ctypes.CDLL] = None
_launch_lock = threading.Lock()
_lib_lock = threading.Lock()
_apart = threading.local()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pq_dtw_band": [_P] * 5 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "pq_dtw_band_cdist": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                          _I, _P],
    "pq_adc_sym": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pq_adc_lookup": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "pq_prealign_encode": [_P] * 5 + [_I] * 9 + [_F] + [_I] * 2 + [_P],
    "pq_lb_refine": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _P],
    "pq_lb_refine_warp": [_P] * 7 + [_I] * 6 + [_P],
    "pq_dtw_band_cdist_reg": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    "pq_dtw_band_adaptive": [_P] * 8 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "pq_lb_refine_adaptive": [_P] * 10 + [_I] * 5 + [_P],
    "pq_lb_refine_adaptive_warp": [_P] * 9 + [_I] * 7 + [_P],
    "pq_adc_sym_quant": [_P] * 6 + [_I] * 6 + [_P],
    "pq_adc_sym_rows": [_P] * 6 + [_I] * 9 + [_P],
    "pq_adc_lookup_quant": [_P] * 5 + [_I] * 8 + [_P],
    "pq_adc_lookup_rows": [_P] * 5 + [_I] * 9 + [_P],
    "pq_attn": [_P] * 8 + [_I] * 12 + [_F] + [_I] * 3 + [_P],
    "pq_dtw_band_full": [_P] * 4 + [_I] * 6 + [_P],
}


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    counts = getattr(_apart, "counts", None)
    with _launch_lock:
        if counts is None:
            LAUNCHES[name] += 1
        else:
            counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def counted_apart(counts: Dict[str, int]):
    """This thread's launches inside the block count in ``counts``."""
    saved = getattr(_apart, "counts", None)
    _apart.counts = counts
    try:
        yield counts
    finally:
        _apart.counts = saved


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernels")
    return str(cand)


def _stamp() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless the stamp says
    it is current.  Returns the library's path; raises on a failed build
    (the compiler's output, with ptxas's register and shared-memory report,
    is kept in ``nvcc.log`` beside the library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp_path = BUILD_DIR / (LIB_NAME + ".sha256")
    stamp = _stamp()

    def current() -> bool:
        return (lib_path.exists() and stamp_path.exists()
                and stamp_path.read_text() == stamp)

    if current():
        return lib_path
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not current():  # else another process built it while we waited
            _compile_and_link(lib_path)
            stamp_path.write_text(stamp)
    return lib_path


def _compile_and_link(lib_path: Path) -> None:
    nvcc = _nvcc()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib_path)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use; one thread loads it
    while the others wait)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.pq_error_string.argtypes = [ctypes.c_int]
        handle.pq_error_string.restype = ctypes.c_char_p
        handle.pq_attn_smem_bytes.argtypes = [ctypes.c_int] * 7
        handle.pq_attn_smem_bytes.restype = ctypes.c_size_t
        for name in ("pq_adc_sym_rows_smem_bytes",
                     "pq_adc_lookup_rows_smem_bytes"):
            getattr(handle, name).argtypes = [ctypes.c_int] * 4
            getattr(handle, name).restype = ctypes.c_size_t
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = lib().pq_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status} ({msg})")


def kernel_device(*tensors: torch.Tensor) -> Optional[torch.device]:
    """Where a wrapper's inputs say to run: ``None`` when all lie on the CPU
    (the plain version runs), their CUDA device when all lie on one (the
    kernel runs).  Anything else raises: there is no fallback."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return None
    dev = next(iter(devs))
    if len(devs) != 1 or dev.type != "cuda":
        raise ValueError(f"kernel inputs must all lie on one CUDA device or "
                         f"all on the CPU, got {sorted(map(str, devs))}")
    return dev


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
