"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use they
are compiled with ``nvcc`` for ``sm_90a`` (one process per source, all
started together, then one link) into a shared library under
``build/torch_kernels/`` at the repository root, named by a hash of the
sources so an edited kernel never loads a stale build.  The library is
bound with ``ctypes``: every pointer and the stream travel as
``c_void_p``.  Every C entry returns ``cudaGetLastError()`` right after its
launch, and ``launch`` raises when that is not 0.

Nothing here runs at import: the CPU-only tests import every module.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

# launches per kernel, counted where each wrapper launches its kernel
KERNEL_LAUNCHES: collections.Counter = collections.Counter()
# "build" per nvcc build and "load" per library load, in this process
LIBRARY_EVENTS: collections.Counter = collections.Counter()

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bitset_matmul.cu", "way_filter.cu", "block_sparse.cu",
           "lane_matmul.cu", "block_sparse_lane.cu", "popcount.cu")
HEADERS = ("lane_ops.cuh",)   # included by sources; part of the build hash
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_ARGTYPES = {
    "tdr_bitset_matmul": [_P, _P, _P, _I, _I, _I, _P],
    "tdr_way_filter": [_P] * 11 + [_I] * 8 + [_P],
    "tdr_block_sparse_matmul": [_P] * 8 + [_I] * 11 + [_P],
    "tdr_lane_matmul": [_P, _P, _P] + [_I] * 5 + [_U, _P],
    "tdr_block_sparse_lane_matmul": [_P] * 8 + [_I] * 13 + [_U, _P],
    "tdr_popcount_rows": [_P, _P, _I, _I, _I, _P],
}


class KernelLibrary:
    """The loaded shared library plus how it was built."""

    def __init__(self, cdll: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.cdll = cdll
        self.path = path
        self.build_seconds = seconds   # 0.0 when an existing build loaded
        self.log = log                 # nvcc's -Xptxas -v report
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        cdll.tdr_error_string.argtypes = [ctypes.c_int]
        cdll.tdr_error_string.restype = ctypes.c_char_p


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, else ``PATH``)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (set CUDA_HOME)")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """Compile every source in parallel, link into ``out``; returns the
    compiler's resource report."""
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [cc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        for name, proc in zip(SOURCES, procs):
            text, _ = proc.communicate()
            logs.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([cc, "-shared", "-o", str(tmp_lib), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp_lib, out)   # atomic: concurrent builders agree
    return "\n".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libtdr_kernels_{_source_hash()}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        t0 = time.perf_counter()
        log = _compile(path)
        seconds = time.perf_counter() - t0
        LIBRARY_EVENTS["build"] += 1
    lib = KernelLibrary(ctypes.CDLL(str(path)), path, seconds, log)
    LIBRARY_EVENTS["load"] += 1
    return lib


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Count one launch of ``kernel`` and call C ``entry`` on the current
    stream of ``device``; raise if the launch was refused."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        KERNEL_LAUNCHES[kernel] += 1
        rc = getattr(lib.cdll, entry)(*args, stream)
    if rc != 0:
        msg = lib.cdll.tdr_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")
