"""Build and load the port's CUDA kernels (``pcmi_tpu_torch/csrc/*.cu``,
with the headers ``*.cuh`` they share).

Each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with :mod:`ctypes` (``kernels.SIGNATURES``
declares its entry points; those of K1, K2, K3, K5, K6 and K7 take the
element type, float32 or bfloat16, as an argument). The build runs at
first use, from the sources in the checkout only, into ``build/pcmi_tpu_torch/``
beside the package; the file name carries a hash of the sources, headers
and flags, so an edited source or header rebuilds and an unchanged tree
loads the library already there.

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions compute them; there is no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "pcmi_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: ctypes.CDLL | None = None


class KernelError(RuntimeError):
    """The kernels could not be built or loaded, or a launch failed. Never
    a fault of one input: callers that skip failed inputs let it through."""


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (from their own directory)."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    """``nvcc`` on PATH, else ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise KernelError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin:"
        " the CUDA toolkit is needed to build the pcmi_tpu_torch kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpcmi_kernels_{h.hexdigest()[:16]}.so"


def nvcc_commands(out: Path, nvcc: str = "nvcc"):
    """One compile command per source (each writes ``<out>.<name>.o``) and
    the link command that joins the objects into ``out``."""
    objs = [out.with_name(f"{out.name}.{src.stem}.o") for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
    link = [nvcc, "-shared", "-o", str(out), *map(str, objs)]
    return compiles, link


def build() -> Path:
    """Compile the library unless a build of these sources exists.

    The compiler's output (``-Xptxas -v``: registers and shared memory per
    kernel) is kept beside the library as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    compiles, link = nvcc_commands(tmp, find_nvcc())
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    outs = [p.communicate()[0] for p in procs]
    log, failed = [], False
    for cmd, p, out in zip(compiles, procs, outs):
        log.append(" ".join(cmd) + "\n" + out)
        failed |= p.returncode != 0
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        failed = proc.returncode != 0
    for cmd in compiles:
        Path(cmd[cmd.index("-o") + 1]).unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelError("nvcc failed:\n" + "\n".join(log))
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The built library, loaded once (its entry points are declared by
    :func:`pcmi_tpu_torch.ops.stereo.kernels.bind`)."""
    global _LIB
    if _LIB is None:
        try:
            _LIB = ctypes.CDLL(str(build()))
        except OSError as exc:
            raise KernelError(f"cannot load the kernel library: {exc}") from exc
    return _LIB
