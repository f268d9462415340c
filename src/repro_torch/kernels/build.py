"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source ``csrc/<name>.cu`` exposes a plain C interface and compiles on
its own into ``build/lib<name>-<digest>.so`` at the repository root, where
``<digest>`` hashes the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source rebuilds and an unchanged one is loaded as it
is.  Nothing is compiled at import:
the first launch builds what it needs, and :func:`build` starts one
``nvcc`` per source, all at once, for callers that want every kernel ready.

:func:`count_launch` is how every wrapper counts its launches: one lock
for all of them, since the serving tier steps its replicas on threads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("aaren_scan", "aaren_scan_bwd", "flash_fwd", "flash_bwd")
_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.n_launches`` under the process-wide launch lock
    (an unlocked ``+= 1`` from two threads can lose an update)."""
    with _LAUNCH_LOCK:
        wrapper.n_launches += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every missing library of ``names`` in parallel.

    Returns {name: compiler output} for the sources it compiled (``-Xptxas
    -v`` prints registers and spills); raises if any compile fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        # Compile to a private name, then rename: concurrent builds of the
        # same source never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if missing."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
