"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, on its own,
into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so csrc/<name>.cu

The hash is of the source text and of every shared header ``csrc/*.cuh``, so
an edited source or header never loads a stale library. Nothing is built when a module is imported: a kernel's wrapper calls
:func:`load` at its first launch, and :func:`build_all` starts one ``nvcc``
per source, all at once. ``--use_fast_math`` is deliberately absent: the
encoding's phases reach ``2^9 |x|`` and need the accurate ``sinf``/``cosf``.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ[k], "bin", "nvcc")
             for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names) -> dict[str, str]:
    """Compile every missing library in parallel; return each compiler log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    return logs


def load(name: str, argtypes) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use. Its
    launch functions (``<name>_launch(*argtypes) -> int``, or each
    ``{function: argtypes}`` of a dict) and ``<name>_error_string(int)`` get
    their signatures once, here."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fns = argtypes if isinstance(argtypes, dict) else \
            {f"{name}_launch": argtypes}
        for fn, types in fns.items():
            launch = getattr(lib, fn)
            launch.restype, launch.argtypes = ctypes.c_int, list(types)
        err = getattr(lib, f"{name}_error_string")
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by ``<name>_launch``;
    each source exports ``<name>_error_string`` to name it."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
