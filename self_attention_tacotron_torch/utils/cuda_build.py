"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface and includes none of
PyTorch's headers, so ``nvcc`` compiles it in seconds. A source is built at
first use into ``build/`` inside the package (git-ignored), under a name keyed
by a hash of the source, the shared headers (``csrc/*.cuh``), the compiler
flags and its parts, and loaded once per process. The sources with many kernel
instantiations (``KERNEL_PARTS``) are compiled as several translation units at
once, each with its share of the instantiations (``csrc/parts.cuh``), and linked
into one library; every ``nvcc`` of every source is started together.
There is no other way to a kernel: if the build fails, the caller gets the
compiler's message as an exception.

    python3 -m self_attention_tacotron_torch.utils.cuda_build [--parts N] SOURCE.cu [...]

prints what ``ptxas`` reports for every kernel of each source (registers, stack
frame, spill stores and loads), compiled with the flags and parts of the build
(``--parts 1``: as one translation unit), then one line per kernel sorted by
name; any checkout's sources can be named, so two trees' kernels, or one source
built whole and in parts, can be set side by side.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Tuple

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

# the translation units a source is compiled in (1 where it is not named)
KERNEL_PARTS: Dict[str, int] = {"fused_decode": 4, "fused_teacher": 4}

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


def parts_of(name: str) -> int:
    return KERNEL_PARTS.get(name, 1)


def library_path(name: str) -> str:
    hashed = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    hashed.update(f"parts={parts_of(name)}".encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            hashed.update(f.read())
    digest = hashed.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _commands(source: str, out: str, parts: int, extra: Tuple[str, ...] = ()) -> List[List[str]]:
    """The ``nvcc`` commands of one source: one that builds the library ``out``, or
    one per part that compiles an object ``<out>.part<i>.o`` (linked by ``_link``)."""
    nvcc = find_nvcc()
    if parts == 1:
        return [[nvcc, *NVCC_FLAGS, *extra, "-o", out, source]]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return [[nvcc, *flags, *extra, f"-DSATT_PARTS={parts}", f"-DSATT_PART={i}", "-c",
             "-o", f"{out}.part{i}.o", source] for i in range(parts)]


def _objects(out: str, parts: int) -> List[str]:
    return [f"{out}.part{i}.o" for i in range(parts)] if parts > 1 else []


def _link(out: str, parts: int) -> subprocess.CompletedProcess:
    return subprocess.run([find_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", out,
                           *_objects(out, parts)], capture_output=True, text=True)


def _remove(*paths: str) -> None:
    for path in paths:
        if os.path.exists(path):
            os.remove(path)


def _start_build(name: str, out: str) -> Tuple[List[subprocess.Popen], str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in _commands(source_path(name), tmp, parts_of(name))]
    return procs, tmp


def _finish_build(name: str, procs: List[subprocess.Popen], tmp: str, out: str) -> None:
    logs = [proc.communicate()[0] for proc in procs]
    parts = parts_of(name)
    failed = [(proc.returncode, log) for proc, log in zip(procs, logs) if proc.returncode != 0]
    if not failed and parts > 1:
        linked = _link(tmp, parts)
        if linked.returncode != 0:
            failed.append((linked.returncode, linked.stdout + linked.stderr))
    _remove(*_objects(tmp, parts))
    if failed:
        _remove(tmp)
        code, log = failed[0]
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {code}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Build every missing library, every ``nvcc`` of every source (one per part)
    started together.

    Under a process group of more than one rank, rank 0 builds and the others wait
    at a barrier, so that N ranks do not start N sets of ``nvcc`` on a cold tree;
    every rank must call it. Returns the seconds this process spent building (0.0
    when it built nothing).
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        spent = _build_missing(names) if dist.get_rank() == 0 else 0.0
        dist.barrier()
        return spent
    return _build_missing(names)


def _build_missing(names: Iterable[str]) -> float:
    start = time.perf_counter()
    with _lock:
        pending = []
        for name in names:
            out = library_path(name)
            if not os.path.exists(out):
                pending.append((name, out, *_start_build(name, out)))
        for name, out, procs, tmp in pending:
            _finish_build(name, procs, tmp, out)
    return time.perf_counter() - start if pending else 0.0


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if it is not there."""
    lib = _libraries.get(name)
    if lib is not None:
        return lib
    _build_missing([name])
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            _libraries[name] = lib
    return lib


def resource_usage(source: str, parts: int = 0) -> str:
    """``ptxas``'s report on the kernels of one ``.cu`` file, built as ``build_all``
    builds a source (in its parts, or in ``parts`` translation units where given);
    the objects and the library it makes are removed again."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    parts = parts or parts_of(stem)
    out = os.path.join(BUILD_DIR, f"resource-usage.{os.getpid()}.so")
    reports, procs = [], []
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in _commands(source, out, parts, ("-Xptxas", "-v"))]
        for proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{err}")
            reports.append(err)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        _remove(out, *_objects(out, parts))
    return "".join(reports)


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
# a kernel in a translation unit's anonymous namespace, whose name nvcc makes per unit
_UNIT = re.compile(r"_ZN(\d+)_GLOBAL__N_")


def _without_unit(name: str) -> str:
    """A mangled name without its anonymous namespace (``_ZN<length><namespace>...``)."""
    unit = _UNIT.match(name)
    return name if unit is None else "_ZN" + name[unit.end(1) + int(unit.group(1)):]
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def kernel_table(report: str) -> Dict[str, Tuple[int, int, int, int]]:
    """Each kernel's (registers, stack frame, spill stores, spill loads) in bytes, from
    a ``resource_usage`` report; a kernel of an anonymous namespace is named without
    its translation unit's hashes, so that a file built whole and in parts compare."""
    table: Dict[str, List[int]] = {}
    kernel = None
    for line in report.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            kernel = _without_unit(entry.group(1))
            table[kernel] = [0, 0, 0, 0]
        elif kernel is not None and _STACK.search(line):
            table[kernel][1:] = [int(v) for v in _STACK.search(line).groups()]
        elif kernel is not None and _REGS.search(line):
            table[kernel][0] = int(_REGS.search(line).group(1))
    return {k: tuple(v) for k, v in table.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description="ptxas's report on the kernels of CUDA sources")
    parser.add_argument("sources", nargs="+", help="paths of .cu files")
    parser.add_argument("--parts", type=int, default=0,
                        help="translation units (default: the build's; 1: the file whole)")
    args = parser.parse_args()
    for source in args.sources:
        report = resource_usage(source, args.parts)
        print(f"== {source}\n{report}", flush=True)
        for kernel, (regs, stack, stores, loads) in sorted(kernel_table(report).items()):
            print(f"kernel {kernel} registers {regs} stack {stack} spill_stores {stores} "
                  f"spill_loads {loads}", flush=True)


if __name__ == "__main__":
    main()
