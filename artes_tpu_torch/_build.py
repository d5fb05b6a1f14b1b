"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``build/artes_tpu_torch/lib<name>-<hash>.so`` beside the package (the build
directory is ignored by git); the hash covers the source, the ``csrc``
headers it includes and the flags, so an edited kernel or header rebuilds
and an unchanged one loads from disk. The compiler
is ``nvcc`` on ``PATH``, else ``$CUDA_HOME/bin/nvcc`` (PyTorch's lookup of
the toolkit). A missing compiler or a failed build raises with nvcc's
output: there is no fallback.

:data:`VARIANT_BUILDS` names libraries built from a source with extra
defines: the instrumented build of ``pool_radial.cu`` whose phase clocks
``python -m artes_tpu_torch.measure clocks`` reads. The main path never
loads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "artes_tpu_torch")

# Hopper only (sm_90a). No --use_fast_math: the f32 guards need IEEE
# expf/logf/sqrtf and denormals. nvcc's default FMA contraction stays on.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> (source under csrc/ without .cu, extra nvcc flags)
VARIANT_BUILDS = {
    "pool_radial_clocks": ("pool_radial", ("-DARTES_POOL_CLOCKS",)),
}

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_bytes(filename: str, seen: set[str]) -> bytes:
    """``csrc/<filename>`` followed by the ``csrc`` headers it includes with
    quotes, each once, recursively."""
    if filename in seen:
        return b""
    seen.add(filename)
    with open(os.path.join(CSRC_DIR, filename), "rb") as fh:
        text = fh.read()
    return text + b"".join(_source_bytes(inc.decode(), seen) for inc in _INCLUDE.findall(text))


def _spec(name: str) -> tuple[str, tuple[str, ...]]:
    """The source and the nvcc flags of a library name."""
    source, extra = VARIANT_BUILDS.get(name, (name, ()))
    return source, NVCC_FLAGS + extra


def library_path(name: str) -> str:
    """Where library ``name`` (``csrc/<name>.cu``, or a variant build)
    builds to (addressed by the content of the source, its headers and the
    flags)."""
    source, flags = _spec(name)
    digest = hashlib.sha256(_source_bytes(source + ".cu", set())
                            + " ".join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(name: str) -> str:
    """Compile library ``name`` unless it is already built; returns the
    library path. nvcc's ``-Xptxas -v`` report (registers, spills) is kept
    beside the library as ``<lib>.log``."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    source, flags = _spec(name)
    cmd = [find_nvcc(), *flags, "-o", tmp, os.path.join(CSRC_DIR, source + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(out + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build(name))
    return _LIBS[name]
