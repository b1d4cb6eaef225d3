"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc into
``build/<name>-<hash>.so`` (the directory is git-ignored), cached by a hash
of the source and the flags.  Several sources build in parallel, one nvcc
each, and every build compiles the ``COMPANIONS`` beside what it was asked
for.  No ``--use_fast_math``: it changes expf, sqrtf and division, and
the kernels are held to their plain versions at f32 tolerances.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: compiled (not loaded) by every build: the tracer's stamp
#: (utils/profiling.py) is then on disk wherever a kernel was built, and a
#: traced block loads it without running nvcc inside the block
COMPANIONS = ("trace_stamp",)

_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory / spill report) per kernel
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> str:
    """The library's path, keyed by the source, the headers it may include
    (every ``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) whatever of ``names`` and ``COMPANIONS`` is
    not cached, then load ``names``.  Raises with nvcc's output if a build
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in list(names) + [c for c in COMPANIONS if c not in names]:
        if name in _loaded or os.path.isfile(_target(name)):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, _target(name))
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in names:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(_target(name))
    return {name: _loaded[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    return _loaded[name] if name in _loaded else build([name])[name]
