"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` source becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). All
sources build at once, one ``nvcc`` process each, on the first kernel call of
a process; the libraries land in ``build/kernels/`` at the repository root,
named by a hash of every ``csrc`` file and the compiler flags, so an edited
source rebuilds and an unchanged one is reused. ``nvcc``'s own report
(``-Xptxas -v``: registers, shared memory, spills per kernel) is kept beside
each library as ``<name>.log``.

Launch entry points take pointers and the stream as ``c_void_p`` and sizes as
``c_int``, and return ``cudaGetLastError()``; :func:`check` turns a non-zero
code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built "
            "from src/repro_torch/csrc at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel, and
    return each source stem's library path.

    Each ``nvcc`` writes to a private temporary name that is renamed into
    place, so concurrent processes never load a half-written library.
    Raises RuntimeError with the compiler's output if any build fails.
    """
    tag = _digest()
    paths = {src.stem: BUILD_DIR / f"{src.stem}-{tag}.so"
             for src in sorted(CSRC.glob("*.cu"))}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = []
    for stem, out in paths.items():
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{out.name} (rc={proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use;
    loaded once per process)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            path = build_all()[stem]
            lib = ctypes.CDLL(str(path))
            lib.usec_error_string.argtypes = [ctypes.c_int]
            lib.usec_error_string.restype = ctypes.c_char_p
            _LIBS[stem] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if code != 0:
        name = lib.usec_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name})")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the C entry points take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
