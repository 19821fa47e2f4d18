"""Build, load and call the port's CUDA kernels.

The kernels live in ``csrc/*.cu`` behind a plain C interface. Each source
is compiled with its own ``nvcc`` for Hopper (``sm_90a``), all started
together, and the objects are linked into one shared library loaded with
``ctypes``; no PyTorch header is compiled, so a build takes seconds. The library goes to
``build/tomojax_torch/`` beside the package,
named by a hash of the sources and flags, so an unchanged tree reuses it.

Nothing here runs at import: the first kernel launch builds and loads.
Every C entry returns the ``cudaError_t`` of its launch; `check` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tomojax_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# argtypes of every C entry (pointers and the stream as c_void_p, so that
# ctypes does not truncate them to 32-bit ints)
_SIGNATURES = {
    "tj_fp": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P],
    "tj_fp_resid": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _P],
    "tj_fp_resid_partials": [_I, _I, _I],
    "tj_bp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tj_bp_ab": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tj_smem_limit": [],
    "tj_fgp_iter": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _F, _F, _P],
    "tj_fgp_iter2": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _F, _F, _P],
    "tj_fgp_grad": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "tj_fgp_iter_halo": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _F, _F, _P],
    "tj_fgp_obj": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _F, _P],
    "tj_fgp_obj_halo": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _P],
    "tj_tv_value": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tj_tv_value_partials": [_I, _I, _I, _I],
    "tj_tv_grad": [_P, _P, _P, _P, _I, _I, _I, _P],
    "tj_tv_grad_halo": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tj_tv_grad_partials": [_I, _I, _I],
    "tj_tv_step": [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P],
    "tj_sart_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                      _I, _I, _I, _I, _P],
    "tj_sart_resident_phases": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                _I, _I, _I, _I, _P, _P],
    "tj_sart_route": [_I, _I],
    "tj_sart_active_clusters": [_I, _I, _I, _IP],
    "tj_exp_fp": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I,
                  _I, _P],
    "tj_exp_bp": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "tj_exp_sart_sweep": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                          _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tj_exp_sart_resident": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                             _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of the nvcc run; 0.0 when reused
    log: str  # nvcc's output, -Xptxas -v register and spill report


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need a CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> BuildInfo:
    """Compile csrc/*.cu into one shared library in build_dir unless it
    exists: one nvcc per source, run in parallel, then one link. (Another
    csrc: a copy of the sources with other tuning constants.)"""
    sources = sorted(csrc.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(csrc.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = build_dir / f"libtomojax_torch_{h.hexdigest()[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return BuildInfo(lib, 0.0,
                         log_path.read_text() if log_path.exists() else "")
    build_dir.mkdir(parents=True, exist_ok=True)
    objs = lib.with_name(f"{lib.stem}.{os.getpid()}.objs")
    objs.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", str(src), "-o",
                 str(objs / f"{src.stem}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        try:
            outs = [(src, p.communicate()[0], p.returncode)
                    for src, p in procs]
        finally:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        log = "".join(out for _, out, _ in outs)
        failed = [f"{src.name} ({rc})" for src, _, rc in outs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
        proc = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp),
             *(str(objs / f"{src.stem}.o") for src in sources)],
            capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    return BuildInfo(lib, seconds, log)


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return load(build().path)


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library with every C entry's argument types set."""
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.tj_error_string.argtypes = [ctypes.c_int]
    cdll.tj_error_string.restype = ctypes.c_char_p
    return cdll


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = lib().tj_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain-version path),
    False when all lie on the current CUDA device (the kernel path)."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types != {"cuda"}:
        raise ValueError(f"operands on mixed or unsupported devices: "
                         f"{sorted(str(t.device) for t in tensors)}")
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.device.index != dev:
            raise ValueError(f"operand on {t.device}, current device is "
                             f"cuda:{dev}")
    return False


def check_operand(t: torch.Tensor, name: str, shape, dtype) -> None:
    """Raise unless `t` is a contiguous tensor of `shape` and `dtype`."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream() -> int:
    """PyTorch's current CUDA stream as a raw handle."""
    return torch.cuda.current_stream().cuda_stream
