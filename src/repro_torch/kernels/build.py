"""Builds the port's CUDA kernels with nvcc and binds them with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own nvcc process, all
started together, and one more nvcc call links the objects into
``build/repro_torch/<digest>/libkernels.so`` at the repository root.  The
digest covers the sources and the flags, so an edited source builds anew
and an unchanged one loads what is there.  Nothing is built at import
time: the first kernel launch builds and loads the library.

The library has a plain C interface.  Every pointer and the CUDA stream
go in as ``c_void_p``; every entry point returns ``cudaGetLastError()``
right after its launch, and `call` raises if that is not 0, because a
launch that CUDA refuses (too many threads, too much shared memory) never
runs, and no later synchronise reports it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v reports each kernel's registers, shared memory and spills
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long

_lib: ctypes.CDLL | None = None
_fns: dict = {}
# the first launches may come from several threads at once (the pipeline's
# workers): one builds and loads the library, the others wait for it
_lock = threading.Lock()
_count_lock = threading.Lock()


def count(fn, attr: str = "launches") -> None:
    """Add one to the counter ``attr`` of wrapper ``fn``.  Wrappers count
    their launches so: the pipeline's worker threads launch at once, and
    ``fn.launches += 1`` alone can lose an update between two threads."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compiles and links the kernels unless this digest is built already.

    Returns the library's path.  The compiler's output, with ptxas's
    report for every kernel, is kept beside it in ``build.log``."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libkernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        t0 = time.perf_counter()
        compiler = nvcc()
        sources = sorted(CSRC.glob("*.cu"))
        procs = [(src, subprocess.Popen(
            [compiler, *FLAGS, "-c", str(src), "-o", str(work / f"{src.stem}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        log, failed = [], []
        for src, proc in procs:          # waits for every process it started
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n" + "\n".join(log))
        link = subprocess.run(
            [compiler, *ARCH, "-shared", "-o", str(work / "libkernels.so"),
             *(str(work / f"{s.stem}.o") for s in sources)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
        log.append(f"== built in {time.perf_counter() - t0:.3f} s")
        (work / "build.log").write_text("\n".join(log))
        # publish the log, then the library: a library on disk always has its log
        os.replace(work / "build.log", out_dir / "build.log")
        os.replace(work / "libkernels.so", lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """The compiler's output for the library `build` made or found."""
    return (build().parent / "build.log").read_text()


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [I]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _entry(name: str, argtypes: list):
    lib = library()
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
            _fns[name] = fn
    return fn


def call(name: str, argtypes: list, *args) -> None:
    """Launches C entry point ``name`` with ``args`` on the current stream
    (the caller passes it last) and raises on the CUDA error it returns."""
    fn = _fns.get(name)
    if fn is None:
        fn = _entry(name, argtypes)
    err = fn(*args)
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


DTYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raises unless every tensor is contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on the same CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
