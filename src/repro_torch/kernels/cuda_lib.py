"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  At first use each
``.cu`` there is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` and the objects are linked into one shared library under
``build/repro_torch_kernels/<hash of the .cu and .cuh files>/`` in the
checkout, which is then loaded with ``ctypes``.  A later process finds the
library by the same hash and does not build again.  Nothing here runs at
import time: this module must import on a machine without ``nvcc`` or a
card.

Every kernel wrapper adds one to its entry in :data:`launches` where it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = {"expand_score": 0, "expand_score_bf16": 0, "expand_score_q": 0,
            "expand_score_pq": 0, "beam_merge": 0, "prune_sweep": 0,
            "pairwise_sq_dist": 0, "filtered_topk": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "repro_expand_score": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    "repro_expand_score_bf16": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    "repro_expand_score_q": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    "repro_expand_score_pq": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    "repro_beam_merge": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_prune_sweep": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "repro_prune_sweep_smem": (_I, _I, _I),
    "repro_pairwise_sq_dist": (_P, _P, _P, _I, _I, _I, _P),
    "repro_pairwise_sq_dist_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "repro_filtered_topk": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_filtered_topk_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}
_RESTYPES = {"repro_prune_sweep_smem": _L}   # every other entry returns a cudaError_t

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def source_hash(csrc: pathlib.Path = CSRC) -> str:
    h = hashlib.sha256()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(csrc: pathlib.Path = CSRC, root: pathlib.Path = BUILD_ROOT,
          info: dict | None = None) -> pathlib.Path:
    """Compile the ``.cu`` files of ``csrc`` into the hashed build directory
    under ``root`` (if not there yet) and return the library's path.
    Records the build seconds and the ``-Xptxas -v`` report (kept beside the
    library, so a cached build has it too) in ``info`` (:data:`build_info` by
    default)."""
    info = build_info if info is None else info
    out_dir = root / source_hash(csrc)
    lib_path = out_dir / "librepro_torch_kernels.so"
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        info.setdefault("seconds", 0.0)
        info["log"] = log_path.read_text() if log_path.exists() else ""
        info["cached"] = True
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sorted(csrc.glob("*.cu")):
            obj = pathlib.Path(tmp) / (src.name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        failed = []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        log_path.write_text(log)
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent reader never sees half a file
    info.update(seconds=time.perf_counter() - t0, log=log, cached=False)
    return lib_path


def load(path: pathlib.Path) -> ctypes.CDLL:
    """Load a library that :func:`build` made and declare its entry points."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a launch the runtime refused (it would never run, and a
    later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_ptr(t) -> int:
    """The current PyTorch stream on ``t``'s device, as the C entry takes it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, dtype, shape: tuple, name: str) -> None:
    """Validate a tensor before its pointer crosses into C."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
