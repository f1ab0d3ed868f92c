"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface and includes none of
PyTorch's headers, so ``nvcc`` compiles it in seconds. A source is built at
first use into ``build/`` inside the package (git-ignored), under a name keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the compiler
flags, and loaded once per process.
There is no other way to a kernel: if the build fails, the caller gets the
compiler's message as an exception.

    python3 -m self_attention_tacotron_torch.utils.cuda_build SOURCE.cu [SOURCE.cu ...]

prints what ``ptxas`` reports for every kernel of each source (registers, stack
frame, spill stores and loads), compiled with the flags of the build; any
checkout's sources can be named, so two trees' kernels can be set side by side.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

KERNEL_SOURCES: Tuple[str, ...] = (
    "bigru", "mha_full", "fused_decode", "bigru_bwd", "fused_teacher", "bilstm",
)

_libraries: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    hashed = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            hashed.update(f.read())
    digest = hashed.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str, out: str) -> Tuple[subprocess.Popen, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc: subprocess.Popen, tmp: str, out: str) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Build every missing library, one ``nvcc`` per source, all started together.

    Returns the seconds it took (0.0 when nothing had to be built).
    """
    start = time.perf_counter()
    with _lock:
        pending = []
        for name in names:
            out = library_path(name)
            if not os.path.exists(out):
                pending.append((name, out, *_start_build(name, out)))
        for name, out, proc, tmp in pending:
            _finish_build(name, proc, tmp, out)
    return time.perf_counter() - start if pending else 0.0


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if it is not there."""
    lib = _libraries.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            _libraries[name] = lib
    return lib


def resource_usage(source: str) -> str:
    """``ptxas``'s report on the kernels of one ``.cu`` file, built as ``build_all``
    builds a source; the library it makes is removed again."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"resource-usage.{os.getpid()}.so")
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", out, source],
            capture_output=True, text=True,
        )
    finally:
        if os.path.exists(out):
            os.remove(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stderr}")
    return proc.stderr


def main() -> None:
    parser = argparse.ArgumentParser(description="ptxas's report on the kernels of CUDA sources")
    parser.add_argument("sources", nargs="+", help="paths of .cu files")
    for source in parser.parse_args().sources:
        print(f"== {source}\n{resource_usage(source)}", flush=True)


if __name__ == "__main__":
    main()
