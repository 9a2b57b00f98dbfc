"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``ops/csrc/*.cu`` file has a plain C interface (no PyTorch headers),
so ``nvcc`` compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<stem>-<hash>.so ops/csrc/<stem>.cu

The library lands under ``build/`` at the checkout root, named by a hash
of the source, the shared headers and the flags, so an edited source
never loads a stale library. A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source at first use")


def library_path(stem: str) -> Path:
    """Where ``csrc/<stem>.cu`` builds to (named by a hash of the source,
    the shared ``csrc/*.cuh`` headers and the flags)."""
    digest = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(stem: str) -> Path:
    """Compile ``csrc/<stem>.cu`` unless its hashed library exists. The
    compiler's report (``-Xptxas -v``: registers, shared memory and spills
    of each kernel) is kept beside the library as ``<name>.log``."""
    out = library_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}.cu (exit "
                           f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, out)   # atomic: a concurrent build never loads a torn file
    return out


def build_all(stems) -> Dict[str, Path]:
    """Build several sources at once, one ``nvcc`` process each."""
    stems = list(stems)
    with ThreadPoolExecutor(max_workers=len(stems)) as pool:
        return dict(zip(stems, pool.map(build, stems)))


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)))
            _loaded[stem] = lib
        return lib
