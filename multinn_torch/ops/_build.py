"""Build and load the port's CUDA kernels (``multinn_torch/csrc``).

The kernels compile at first use into ``multinn_torch/_build/<hash>/``
(git-ignored), cached by a hash of the sources, the flags and the torch
build. The binding registers them as ``torch.ops.multinn_torch.*``
(TORCH_LIBRARY in csrc/ops.cpp) and the library is loaded with
``torch.ops.load_library`` — no pybind, no Python.h.

Two ways to build: ``torch.utils.cpp_extension.load`` where ninja is
installed (as on the H100 machine the port is checked on), else one direct
``nvcc`` call whose ``build.log`` keeps the ptxas register report.
Both target ``sm_90a`` and neither uses fast-math, so the kernels stay
close to their plain versions. A failed build raises; nothing falls back.

Every kernel wrapper counts its launches in ``launches`` (name -> count),
incremented where the kernel is launched and nowhere else, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
_SOURCES = ("threefry.cu", "gibbs_chain.cu", "gen_fused_rbm.cu",
            "nade_sample.cu", "gen_fused_nade.cu", "nade_ll.cu",
            "lstm_scan.cu", "ops.cpp")
_HEADERS = ("threefry.cuh", "sigmoid.cuh", "reduce.cuh", "gen_cluster.cuh",
            "launchers.h")
_LIB = "multinn_torch_ops.so"
_CUDA_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3",
               "-Xptxas=-v"]

launches: collections.Counter = collections.Counter()
build_info: dict = {}          # how the library was obtained (chip_smoke)
_lock = threading.Lock()
_loaded = False


def impl_for(impl, x: torch.Tensor) -> str:
    """The implementation a kernel wrapper runs: ``"cuda"`` (the kernel)
    for CUDA tensors and ``"plain"`` (its PyTorch version) for CPU tensors
    when ``impl`` is None; an explicit ``impl`` overrides, and asking for the
    kernel on a CPU tensor raises."""
    if impl is None:
        return "cuda" if x.is_cuda else "plain"
    if impl not in ("cuda", "plain"):
        raise ValueError(f"impl must be 'cuda' or 'plain', got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def stream_of(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as the ops take it."""
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(x: torch.Tensor) -> int:
    """The streaming multiprocessors of ``x``'s card (launch plans)."""
    return _sm_count(x.device.index if x.device.index is not None
                     else torch.cuda.current_device())


def ops():
    """``torch.ops.multinn_torch``, building and loading the kernels on the
    first call."""
    global _loaded
    with _lock:
        if not _loaded:
            _build_and_load()
            _loaded = True
    return torch.ops.multinn_torch


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(_CUDA_FLAGS).encode())
    h.update(f"{torch.__version__} {torch.version.cuda}".encode())
    return h.hexdigest()[:16]


def _build_and_load() -> None:
    from torch.utils import cpp_extension
    out_dir = BUILD_ROOT / _digest()
    t0 = time.perf_counter()
    if cpp_extension.is_ninja_available():
        out_dir.mkdir(parents=True, exist_ok=True)
        # load() caches by content itself and loads the library into
        # torch.ops (is_python_module=False)
        cpp_extension.load(
            name="multinn_torch_ops",
            sources=[str(CSRC / s) for s in _SOURCES],
            extra_cuda_cflags=_CUDA_FLAGS,
            build_directory=str(out_dir), is_python_module=False)
        build_info.update(tool="torch.utils.cpp_extension.load",
                          dir=str(out_dir))
    else:
        lib = out_dir / _LIB
        if not lib.exists():
            _nvcc_build(out_dir)
        torch.ops.load_library(str(lib))
        build_info.update(tool="nvcc", dir=str(out_dir))
    build_info["seconds"] = time.perf_counter() - t0


def _nvcc_build(out_dir: Path) -> None:
    """One nvcc call compiles the kernels and the binding into a shared
    library, in a temporary directory renamed into place when done."""
    from torch.utils import cpp_extension
    cuda_home = cpp_extension.CUDA_HOME
    nvcc = (os.path.join(cuda_home, "bin", "nvcc") if cuda_home
            else shutil.which("nvcc"))
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("cannot build the multinn_torch kernels: nvcc "
                           "not found (CUDA_HOME unset and not on PATH)")
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=BUILD_ROOT))
    cmd = [nvcc, *_CUDA_FLAGS, "-std=c++17", "-Xcompiler", "-fPIC",
           "-shared", "--cudart", "shared",
           f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
           *[f"-I{p}" for p in cpp_extension.include_paths()],
           *[str(CSRC / s) for s in _SOURCES],
           f"-L{torch_lib}", "-lc10", "-ltorch", "-ltorch_cpu",
           "-ltorch_cuda", "-lc10_cuda", f"-Xlinker=-rpath,{torch_lib}",
           "-o", str(tmp / _LIB)]
    # nvcc's own temporaries stay inside the build directory
    env = dict(os.environ, TMPDIR=str(tmp))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    (tmp / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}); log in "
                           f"{tmp / 'build.log'}:\n{proc.stderr[-6000:]}")
    try:
        os.replace(tmp, out_dir)
    except OSError:                  # another process finished first
        shutil.rmtree(tmp, ignore_errors=True)

