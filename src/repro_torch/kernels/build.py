"""Build and load the port's CUDA C++ kernels.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Builds happen at first use, from the
sources in the checkout, into ``build/`` next to this file (git-ignored);
the library's file name carries a hash of its source, of every header under
``csrc/`` and of the flags, so an edited source or header rebuilds and an
unchanged one is reused.  ``build`` starts one ``nvcc`` per missing library,
all at once, and keeps the compiler's report (``-Xptxas -v``: registers,
shared memory and spills of each kernel) beside the library, where
``ptxas_report`` reads it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("ragged_paged_attention", "flash_attention", "ssd",
           "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the wall
    seconds spent; raises with the compiler's output if any build fails."""
    t0 = time.monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> list[dict]:
    """What ``ptxas -v`` said of each kernel of source ``name`` (built
    first if needed): the mangled kernel name, registers a thread, shared
    memory bytes, its stack frame, and spill stores and loads in bytes."""
    build((name,))
    log = _lib_path(name).with_suffix(".log").read_text()
    kernels, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = {"kernel": m.group(1)}
            kernels.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current["stack_frame_bytes"] = int(m.group(1))
            current["spill_store_bytes"] = int(m.group(2))
            current["spill_load_bytes"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            current["smem_bytes"] = int(s.group(1)) if s else 0
    return kernels


def sass_count(name: str, opcode: str) -> dict[str, int] | None:
    """How many ``opcode`` instructions each kernel of source ``name`` has
    in its SASS, by ``cuobjdump``; None where the toolkit has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    build((name,))
    sass = subprocess.run([tool, "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current is not None and re.search(rf"\b{opcode}\b", line):
            counts[current] += 1
    return counts
