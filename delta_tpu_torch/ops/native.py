"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. All sources build in parallel, one ``nvcc`` each,
into ``build/kernels/`` at the repository root, named by a hash of the
source, at first use. Nothing here runs at import: the CPU tests import
every module on hosts with no ``nvcc`` and no card.

The kernels launch on PyTorch's current stream; each C entry point returns
``cudaGetLastError()``, and :func:`call` raises when it is not 0.

``launches`` counts the launches of each kernel. The wrappers beside the
plain PyTorch versions (``ops/state_cache``, ``ops/replay_kernel``,
``expr/device_eval``) add one where they launch, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

__all__ = ["launches", "reset_launches", "build_all", "call"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: kernel -> (source stem, C symbol, argument types); every symbol takes the
#: CUDA stream last and returns a cudaError_t
_KERNELS = {
    "block_cull": ("block_cull", "dtt_block_cull",
                   [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P]),
    "scatter_bool": ("tail_scatter", "dtt_scatter_bool",
                     [_P, _P, _I, ctypes.c_ubyte, _L, _P]),
    "scatter_cols": ("tail_scatter", "dtt_scatter_cols",
                     [_P, _P, _P, _I, _I, _L, _P]),
    "winner_bits": ("winner_bits", "dtt_winner_bits",
                    [_P, _L, _P, _I, _P, _P, _P]),
    "replay": ("replay", "dtt_replay",
               [_P, _P, _P, _P, _P, _L, _P, _I, _P, _L, _P, _P, _P, _P]),
    "expr_eval": ("expr_eval", "dtt_expr_eval",
                  [_P, _I, _I, _I, _I, _I, _I, _L, _P, _P, _P, _I, _I, _P]),
}

launches: Dict[str, int] = {k: 0 for k in _KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from csrc/ on the machine with the card")
    return nvcc


#: nvcc flags of every kernel library. No --use_fast_math / -ftz: the f32
#: lanes hold subnormals, and flushing them would change comparisons.
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _target(stem: str) -> Path:
    """The library's path, named by a hash of its source and the flags, so
    a change to either builds anew."""
    h = hashlib.sha256((_CSRC / f"{stem}.cu").read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"{stem}-{h.hexdigest()[:16]}.so"


def _compile_all(stems: List[str]) -> None:
    """One nvcc per source, all started together; each writes to a temp
    name and is renamed into place, so concurrent builders never see a
    half-written library."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for stem in stems:
        out = _target(stem)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(_BUILD / f"{stem}.log", "w")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{stem}.cu")]
        procs.append((stem, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for stem, out, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(f"{stem} (rc {rc}):\n{(_BUILD / f'{stem}.log').read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build_all() -> float:
    """Build (if needed) and load every kernel library; returns the seconds
    it took."""
    t0 = time.perf_counter()
    with _lock:
        stems = sorted({s for s, _, _ in _KERNELS.values()})
        missing = [s for s in stems if not _target(s).exists()]
        if missing:
            _compile_all(missing)
        for stem in stems:
            if stem not in _libs:
                _libs[stem] = ctypes.CDLL(str(_target(stem)))
        for name, (stem, symbol, argtypes) in _KERNELS.items():
            fn = getattr(_libs[stem], symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return time.perf_counter() - t0


def call(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on the current CUDA stream (building the
    libraries at first use); raises if the launch was refused. The kernels
    launch on the CUDA runtime's current device, so the tensors' ``device``
    must be it. The stream argument is appended here."""
    stem, symbol, _ = _KERNELS[name]
    if device.index is not None and device.index != torch.cuda.current_device():
        raise RuntimeError(f"{name}: tensors on {device}, but the current CUDA device "
                           f"is {torch.cuda.current_device()}; launch under "
                           f"torch.cuda.device({device.index})")
    if stem not in _libs:
        build_all()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(_libs[stem], symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
