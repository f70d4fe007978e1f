"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one shared library.

Counterpart of the JAX package's compilation-cache compartment
(``cache_machine_fingerprint`` / ``enable_compilation_cache`` in
``tpu_operator/validator/workloads.py``).  At first use every source is
compiled with ``nvcc`` for ``sm_90a`` (one process per source, all started
together, then one link) into

    build/kernels/<fingerprint>/libtpu_operator_torch_kernels.so

under the checkout's root, where the fingerprint is the device name, its
compute capability and a hash of the sources and flags; later loads reuse
it.  The library has a plain C interface and is bound with ``ctypes``.

Unlike the JAX cache, a failed build or an unwritable build directory
raises: without the kernels there is no validation path to degrade to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libtpu_operator_torch_kernels.so"
# built for sm_90a (the target where Hopper's wgmma and setmaxnreg exist),
# whose code loads only on compute capability 9.0
TARGET_CAPABILITY = (9, 0)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# every entry point returns a cudaError_t; pointers and the stream are c_void_p
# so ctypes never truncates them to 32 bits
SIGNATURES = {
    "tot_matmul_bf16_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # a, b, scale, n, blocks, threads, stream
    "tot_triad_inplace": (_P, _P, _F, _LL, _I, _I, _P),
    "tot_fma_relu": (_P, _P, _P, _P, _LL, _P),
}


class KernelBuildError(RuntimeError):
    pass


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def fingerprint(name: str, capability: Tuple[int, int]) -> str:
    """Build-directory key: device name, capability, hash of sources+flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    slug = "".join(c if c.isalnum() else "-" for c in name.lower())
    return f"{slug}-sm{capability[0]}{capability[1]}-{h.hexdigest()[:16]}"


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelBuildError(f"nvcc not found on PATH or at {path}")
    return path


def build(index: int) -> Path:
    """Compile the library for CUDA device ``index`` unless already built;
    return its path."""
    name = torch.cuda.get_device_name(index)
    capability = torch.cuda.get_device_capability(index)
    if tuple(capability) != TARGET_CAPABILITY:
        raise KernelBuildError(
            f"kernels target sm_90a; {name} is sm_{capability[0]}{capability[1]}")
    out_dir = BUILD_ROOT / fingerprint(name, capability)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a private directory and rename into place: a concurrent
    # build never sees (or loads) a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / f"{src.stem}.o"
            log = Path(tmp) / f"{src.stem}.log"
            with open(log, "w") as f:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=f, stderr=subprocess.STDOUT)
            jobs.append((src, obj, log, proc))
        failed = [f"{src.name}:\n{log.read_text()}"
                  for src, _obj, log, proc in jobs if proc.wait() != 0]
        if failed:
            raise KernelBuildError("nvcc failed\n" + "\n".join(failed))
        staged = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *(str(obj) for _s, obj, _l, _p in jobs),
             "-o", str(staged)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed\n{link.stdout}")
        os.replace(staged, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _load_index(index: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(index)))
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    lib.tot_error_string.argtypes = (_I,)
    lib.tot_error_string.restype = ctypes.c_char_p
    return lib


def load(device: torch.device) -> ctypes.CDLL:
    """The kernel library for a CUDA ``device``, built on first use."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels run on a cuda device, not {device}")
    index = torch.cuda.current_device() if device.index is None else device.index
    return _load_index(index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib.tot_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
