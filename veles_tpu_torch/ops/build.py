"""Build the CUDA kernels of :mod:`veles_tpu_torch.csrc` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface and loaded with ``ctypes``; the
wrappers pass pointers and the stream as ``c_void_p``.  Libraries land
in ``build/veles_tpu_torch/`` beside the package, named by a hash of
the source, the headers of ``csrc/`` (``mma.cuh``: the tensor-core
building blocks; ``act.cuh``: the GEMM epilogues' activations) and the
flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.  ``build_all()``
starts one ``nvcc`` per source, all at once.  Nothing here runs at
import time, and the CPU path never imports this module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "veles_tpu_torch"
#: every kernel source of the package (``csrc/<name>.cu``)
SOURCES = ("flash_fwd", "flash_bwd", "decode_attn", "gemm", "gemm_bf16",
           "gather", "qgemm", "reduce", "random")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libraries = {}
#: name -> {"seconds": compile wall time (0.0 when cached),
#:          "ptxas": the compiler's register / spill report}
build_log = {}


def nvcc():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    every header of ``csrc/`` (a source may include any of them) and the
    flags, so an edit to any of them builds a new library."""
    digest = hashlib.sha256((CSRC_DIR / (name + ".cu")).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def _start(name, target):
    """Start ``nvcc`` for one source into a private temporary file."""
    tmp = target.with_name("%s.tmp%d" % (target.name, os.getpid()))
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / (name + ".cu"))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name, target, proc, tmp, tic):
    out, _ = proc.communicate()
    seconds = time.perf_counter() - tic
    if proc.returncode:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError("nvcc failed on csrc/%s.cu (exit %d):\n%s"
                           % (name, proc.returncode, out))
    os.replace(tmp, target)       # atomic: a reader never sees half a file
    build_log[name] = {"seconds": seconds, "ptxas": out}


def build_all(names=SOURCES):
    """Compile every stale source in parallel (one ``nvcc`` each) and
    load all of them.  Returns ``{name: seconds}``, 0.0 for a library
    that was already built from the same source."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = {}
        for name in names:
            target = library_path(name)
            if name in _libraries:
                continue
            if target.exists():
                build_log.setdefault(name, {"seconds": 0.0, "ptxas": ""})
            else:
                running[name] = (target,) + _start(name, target)
        try:
            for name, (target, proc, tmp, tic) in running.items():
                _finish(name, target, proc, tmp, tic)
        finally:
            for _target, proc, _tmp, _tic in running.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name in names:
            if name not in _libraries:
                _libraries[name] = ctypes.CDLL(str(library_path(name)))
    return {name: build_log[name]["seconds"] for name in names}


def library(name):
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libraries.get(name)
    if lib is None:
        build_all((name,))
        lib = _libraries[name]
    return lib
