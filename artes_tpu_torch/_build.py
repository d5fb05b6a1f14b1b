"""Build the package's CUDA sources with nvcc, and its host programs with
g++, and load the libraries with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``build/artes_tpu_torch/lib<name>-<hash>.so`` beside the package (the build
directory is ignored by git); the hash covers the source, the ``csrc``
headers it includes and the flags, so an edited kernel or header rebuilds
and an unchanged one loads from disk. The compiler
is ``nvcc`` on ``PATH``, else ``$CUDA_HOME/bin/nvcc`` (PyTorch's lookup of
the toolkit). A missing compiler or a failed build raises with nvcc's
output: there is no fallback. :data:`SOURCE_FLAGS` adds a source's own
flags.

:data:`VARIANT_BUILDS` names libraries built from a source with extra
defines: the instrumented build of ``pool_radial.cu`` whose phase clocks
``python -m artes_tpu_torch.measure clocks`` reads, and the one that also
sums the scatter peels in float32 over :data:`TPU_LANES` lanes, as the TPU
kernel does, for ``baselines.record_sums``. The main path never loads them.

:data:`HOST_BUILDS` are the host programs under ``native/``, built with
``g++`` with the flags of the JAX package's Makefiles: the Mie/DHS solver
``computepart`` (``native/mie/mie.cc``, an executable that
``opacity.mie`` runs) and the FITS reader ``libartesfits`` (``native/fits/
fitsread.cc``, a shared library that ``io.fitsio.read_fits_native`` loads).
They build on first use into the same directory, named by a hash of the
source and the flags; a missing compiler or a failed build raises with the
command and g++'s output.
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
# expf/logf/sqrtf and denormals. nvcc's default FMA contraction stays on,
# but in the sources of SOURCE_FLAGS (every pool kernel).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source under csrc/ (without .cu) -> nvcc flags of its own, in every library
# built from it. The pool kernels contract nothing: each float32 expression
# rounds op by op, as the plain version's do, but the chains they write with
# __fmaf_rn, which the plain version writes with geometry.fmadd. Contracted,
# their Stokes algebra, sampling and walks strayed from the plain version's
# by ulps from a photon's first scattering on, enough to part rare
# trajectories: on BASELINE #2's cloud deck seen at 177.5 deg (the crescent's
# grazing entries, cells.KERNEL_CELLS "hg_crescent") pool_radial's counts
# parted by 8.8e-4, past pool_cuda.AGREE. Without contraction every gate
# cell's gaps fell, at 8-17% of pool_radial's time on the flagship and at most
# 7% of pool_march's on lambert_tau05, by the reading (PERF.md, python -m
# artes_tpu_torch.measure contraction).
SOURCE_FLAGS = {"pool_radial": ("-fmad=false",), "pool_grid3d": ("-fmad=false",),
                "pool_march": ("-fmad=false",)}

# library name -> (source under csrc/ without .cu, extra nvcc flags)
# the TPU kernel's pool width on radial grids (artes_tpu/runner.py PALLAS_WIDTH)
TPU_LANES = 8192
VARIANT_BUILDS = {
    "pool_radial_clocks": ("pool_radial", ("-DARTES_POOL_CLOCKS",)),
    "pool_radial_lanes": ("pool_radial", (f"-DARTES_F32_LANES={TPU_LANES}",)),
}

NATIVE_DIR = os.path.join(PACKAGE_DIR, "native")
GXX_FLAGS = ("-O2", "-std=c++17", "-Wall")
# host program -> (source under native/, extra g++ flags, output suffix)
HOST_BUILDS = {
    "computepart": ("mie/mie.cc", (), ""),
    "libartesfits": ("fits/fitsread.cc", ("-fPIC", "-shared"), ".so"),
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
    return source, NVCC_FLAGS + SOURCE_FLAGS.get(source, ()) + extra


def library_path(name: str) -> str:
    """Where library ``name`` (``csrc/<name>.cu``, or a variant build)
    builds to (addressed by the content of the source, its headers and the
    flags)."""
    source, flags = _spec(name)
    digest = hashlib.sha256(_source_bytes(source + ".cu", set())
                            + " ".join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def _compile(cmd: list[str], out: str, what: str) -> subprocess.CompletedProcess:
    """Run compiler command ``cmd``, which writes ``out`` + a temporary
    suffix, and move its output into place; raises with the compiler's
    output when it fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed (exit {proc.returncode}) "
                           f"building {what}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc


def build(name: str) -> str:
    """Compile library ``name`` unless it is already built; returns the
    library path. nvcc's ``-Xptxas -v`` report (registers, spills) is kept
    beside the library as ``<lib>.log``."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    source, flags = _spec(name)
    proc = _compile([find_nvcc(), *flags, os.path.join(CSRC_DIR, source + ".cu")], out, name)
    with open(out + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build(name))
    return _LIBS[name]


def host_path(name: str) -> str:
    """Where host program ``name`` of :data:`HOST_BUILDS` builds to
    (addressed by the content of its source and the flags)."""
    source, extra, suffix = HOST_BUILDS[name]
    with open(os.path.join(NATIVE_DIR, source), "rb") as fh:
        text = fh.read()
    digest = hashlib.sha256(text + " ".join(GXX_FLAGS + extra).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}{suffix}")


def build_host(name: str) -> str:
    """Compile host program ``name`` with g++ unless it is already built;
    returns its path."""
    out = host_path(name)
    if os.path.isfile(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: it builds the host programs under native/")
    source, extra, _ = HOST_BUILDS[name]
    _compile([gxx, *GXX_FLAGS, *extra, os.path.join(NATIVE_DIR, source)], out, name)
    return out


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name`` of :data:`HOST_BUILDS`, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build_host(name))
    return _LIBS[name]
