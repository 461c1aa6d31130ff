"""Build the port's CUDA kernels at first use and load them with ctypes.

Every source under ``paddle_tpu_torch/csrc/`` has a plain C interface (no
PyTorch headers), so each compiles with one ``nvcc`` call into its own
shared library in seconds; the libraries are loaded with ctypes, and the
wrappers pass device pointers and the current CUDA stream as integers.
Binding through ``torch.utils.cpp_extension`` would include PyTorch's
headers and take minutes per build, and every fresh machine builds anew.

The build goes to ``build/torch_kernels/`` at the repository root (listed
in .gitignore). Library names carry a hash of the source, the shared
``*.cuh`` headers beside it and the flags, so an edited source is rebuilt
and an unchanged one is reused. All
sources compile in parallel: one nvcc process each, started together.
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
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "fused_lstm.cu", "fused_gru.cu", "fused_conv.cu",
           "block_megakernel.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes())
    # the shared headers a source may include
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> Dict[str, Dict]:
    """Compile every source that has no up-to-date library, all in
    parallel. Returns {source: {"path", "seconds", "log"}}: seconds and
    nvcc's output (ptxas register and shared-memory report included)
    are None for a library that was already built. Raises with nvcc's
    output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in sources}
    out = {s: {"path": paths[s], "seconds": None, "log": None}
           for s in sources}
    todo = [s for s in sources if not paths[s].exists()]
    procs = {}
    t0 = time.perf_counter()
    for s in todo:
        tmp = paths[s].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for s, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out[s].update(log=log, seconds=time.perf_counter() - t0)
        if proc.returncode != 0:
            failed.append(f"{s}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[s])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built at first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build([source])[source]["path"]))
            _libs[source] = lib
        return lib


def launch_planned(lib, entry, error_string, fields, who, device, *args):
    """Call the C entry point `entry` of `lib` with `args`, a host plan
    buffer of len(fields) ints and `device`'s current CUDA stream (the
    persistent recurrent kernels' convention); raise with the CUDA error
    (`error_string(err)`) and the launch plan (grid, blocks per SM, shared
    memory: a grid that cannot be co-resident is refused, and nothing
    falls back) unless it returns 0. Returns the plan as a dict."""
    import torch
    plan = (ctypes.c_int * len(fields))()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, ctypes.addressof(plan), stream)
    plan = dict(zip(fields, plan))
    if err != 0:
        raise RuntimeError(
            f"{who} kernel launch failed: {error_string(err).decode()} (grid "
            f"{plan['grid']} for {plan['tiles']} tiles, "
            f"{plan['blocks_per_sm']} blocks per SM on {plan['sms']} SMs "
            f"at {plan['smem_bytes']} bytes of shared memory a block)")
    return plan
