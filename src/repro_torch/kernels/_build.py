"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/<name>-<hash>.so``
at the root of the checkout, compiled for ``sm_90a`` with a plain C
interface.  The hash covers the sources of ``csrc/`` and the flags, so an
edited source is rebuilt and a stale library is never loaded.  All sources
build at first use, one ``nvcc`` process each, started together.  A missing
``nvcc`` or a failed build raises; nothing falls back.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises if
it is not 0.  Pointers and the stream are passed as ``ctypes.c_void_p``
(without argtypes ctypes would cut them to 32 bits).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fingerprint", "fused_ingest", "fused_pairs", "fused_query", "sample_weights",
           "sketch_moments", "sketch_update", "flash_attention_f32", "flash_attention_tc",
           "flash_attention_bwd")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p.
SIGNATURES = {
    "fingerprint": ("sjpc_fingerprint", [P, P, P, P, P, P, I64, I32, I32, I32, P]),
    "fused_ingest": ("sjpc_fused_ingest",
                     [P, P, P, P, P, P, P, P, P, I64, I32, I32, I32, I32, I32, I32, I64,
                      I32, P]),
    "fused_pairs": ("sjpc_fused_pairs", [P, P, P, I64, I32, I32, I32, P]),
    "fused_query": ("sjpc_fused_query", [P, P, P, I64, I32, I32, P]),
    "sample_weights": ("sjpc_sample_weights", [P, P, P, P, P, P, P, I64, I32, I32, I32, P]),
    "sketch_moments": ("sjpc_sketch_moments", [P, P, P, I32, I32, I32, P]),
    "sketch_update": ("sjpc_sketch_update", [P, P, P, P, P, P, P, I64, I32, I32, I32, P]),
    "flash_attention_f32": ("flash_attention_f32_fwd",
                            [P, P, P, P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32,
                             I32, P]),
    "flash_attention_tc": ("flash_attention_tc_fwd",
                           [P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, I32, P]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            [P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I32, I32, I32, I32,
                             I32, I32, I32, I32, I32, I32, P]),
}

_lock = threading.Lock()
_functions: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", NVCC_DEFAULT]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.
    Returns the library paths; the ptxas report of each build is kept
    beside its library as ``<name>-<hash>.log``."""
    digest = _digest()
    paths = {name: BUILD_DIR / f"{name}-{digest}.so" for name in SOURCES}
    missing = [name for name, path in paths.items() if not path.exists()]
    if not missing:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        tmp = paths[name].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return paths


def function(name: str):
    """The C entry point of kernel ``name``, building every kernel at the
    first call."""
    fn = _functions.get(name)
    if fn is not None:
        return fn
    with _lock:
        if not _functions:
            for lib_name, path in build_all().items():
                symbol, argtypes = SIGNATURES[lib_name]
                f = getattr(ctypes.CDLL(str(path)), symbol)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _functions[lib_name] = f
    return _functions[name]


def check(name: str, status: int) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def require_cuda(name: str, device) -> None:
    """Raise unless ``device`` is a CUDA device: a kernel wrapper never
    runs anything else."""
    if device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on cuda tensors, not {device}")


def require(arg: str, tensor, dtype, shape, device) -> None:
    """Raise unless ``tensor`` has the dtype, shape and device a kernel
    takes and is contiguous."""
    if tensor.dtype != dtype:
        raise TypeError(f"{arg}: expected {dtype}, got {tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{arg}: expected shape {tuple(shape)}, got {tuple(tensor.shape)}")
    if tensor.device != device:
        raise ValueError(f"{arg}: expected device {device}, got {tensor.device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{arg}: must be contiguous")


def launch(name: str, device, *args) -> None:
    """Call kernel ``name``'s C entry point on ``device`` with ``args``
    followed by the device index and PyTorch's current stream, and raise
    on a CUDA error."""
    import torch
    fn = function(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(name, fn(*args, device.index, stream))
