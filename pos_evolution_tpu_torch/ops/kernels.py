"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface (one or more entry points, each a kernel name here), compiled by
``nvcc`` for ``sm_90a`` at first use into
``build/torch_kernels/`` at the repository root and loaded with
``ctypes``. A library's file name carries a hash of its source, the
shared headers and the flags, so an edited source is always rebuilt, and
processes may share one directory (``set_build_dir``).
``build_all`` starts one ``nvcc`` per source, all at once.

``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else, under a lock, so
the count stays exact while a checkpoint writer thread launches K2 beside
the run's loop. ``build_listeners`` are called with each source's build
seconds (``telemetry/torchrt.py`` charges them to the active span). Each entry point is
bound once (``entry``); ``launch_on`` is the field kernels' lean launch: the
raw current stream, and no device switch when the tensor is on the current
device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# kernel name -> (source file, C entry point, its argtypes)
KERNELS = {
    "agg_sig": ("agg_sig.cu", "agg_sig_launch",
                [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]),
    "merkle_level": ("merkle_level.cu", "merkle_level_launch",
                     [_P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, ctypes.c_int, _P]),
    "fp_modmul": ("fp_modmul.cu", "fp_modmul_launch",
                  [_P, _LL, _LL, _P, _LL, _LL, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "fp_pow": ("fp_modmul.cu", "fp_pow_launch",
               [_P, _LL, _LL, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
                _P]),
    "fp_addsub": ("fp_addsub.cu", "fp_addsub_launch",
                  [_P, ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, _P]),
    "alg_mul": ("alg_mul.cu", "alg_mul_launch",
                [_P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int,
                 _P]),
    "sha256_blocks": ("sha256_blocks.cu", "sha256_blocks_launch",
                      [_P, _LL, ctypes.c_int, _P, ctypes.c_int, _P]),
    # K6 with its design named (threads 0: the warp-specialized chains; 32-128:
    # one thread a message in blocks of that many): only the measuring hook
    # for the constants that pick the design (bench_k67 --designs) and for
    # holding each design to the plain version; no wrapper launches it
    "sha256_blocks_design": ("sha256_blocks.cu", "sha256_blocks_design_launch",
                             [_P, _LL, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P]),
    "gf256_matmul": ("gf256_matmul.cu", "gf256_matmul_launch",
                     [_P, _LL, _P, _LL, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _P]),
    # K10: a pass of up to 8 (the first) or 9 NTT stages in shared memory,
    # and Fr's elementwise ops
    "fr_ntt": ("fr_ntt.cu", "fr_ntt_launch",
               [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _P]),
    "fr_ew": ("fr_ntt.cu", "fr_ew_launch", [ctypes.c_int, _P, _LL, _P, _LL, _P, _LL, _P]),
    # K11: the G1 MSM's ladders (with the first fold round), and a fold round
    "g1_msm": ("g1_msm.cu", "g1_msm_launch",
               [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _P]),
    "g1_fold": ("g1_msm.cu", "g1_fold_launch", [_P, _P, ctypes.c_int, ctypes.c_int, _P]),
    # K11's bucket route over a setup's window tables: the tables' doublings
    # (once a setup), then six launches an MSM
    "g1_bucket_tables": ("g1_bucket.cu", "g1_bucket_tables_launch",
                         [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "g1_bucket_recode": ("g1_bucket.cu", "g1_bucket_recode_launch",
                         [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "g1_bucket_scan": ("g1_bucket.cu", "g1_bucket_scan_launch",
                       [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "g1_bucket_scatter": ("g1_bucket.cu", "g1_bucket_scatter_launch",
                          [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           _P]),
    "g1_bucket_fill": ("g1_fill.cu", "g1_bucket_fill_launch",
                       [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "g1_bucket_totals": ("g1_totals.cu", "g1_bucket_totals_launch",
                         [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "g1_bucket_reduce": ("g1_reduce.cu", "g1_bucket_reduce_launch",
                         [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P]),
}

launches = {name: 0 for name in KERNELS}
_LAUNCH_LOCK = threading.Lock()
_THREAD = threading.local()            # .counts: this thread's launches, while counted
build_seconds: dict[str, float] = {}   # source -> its last nvcc's wall seconds
build_listeners: list = []             # fn(source, seconds), after each build
_LIBS: dict[str, ctypes.CDLL] = {}     # source file -> its loaded library
_ENTRIES: dict = {}          # kernel name -> its bound C entry point


@contextmanager
def thread_launches():
    """Count the launches this thread makes inside the block, apart from
    every other thread's: yields the dict it fills, by kernel name."""
    prev = getattr(_THREAD, "counts", None)
    counts: dict[str, int] = {}
    _THREAD.counts = counts
    try:
        yield counts
    finally:
        _THREAD.counts = prev


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in launches:
            launches[name] = 0


def set_build_dir(path) -> None:
    """Build and load kernel libraries under ``path`` from now on, for the
    whole process (``Simulation(compile_cache=...)``): processes that share
    it build each library once. Libraries already loaded stay loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return str(path)


def _library_path(name: str) -> Path:
    source = KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [_CSRC / source, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel not yet built, one ``nvcc`` per source, all
    started together. Returns each kernel's ptxas report (registers,
    shared memory, spills), from its build log when it was built before.
    Kernels of one source share its report; ``build_seconds`` gets each
    compiled source's wall time. Raises with the compiler's output on
    failure."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, by_source = {}, {}
    t0 = time.perf_counter()
    for name in names:
        source = KERNELS[name][0]
        if source in by_source:
            continue
        target = _library_path(name)
        if target.exists():
            log = target.with_suffix(".log")
            by_source[source] = log.read_text() if log.exists() else ""
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / source)]
        jobs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, target)
        by_source[source] = None

    def finish(proc):
        out, _ = proc.communicate()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        done = dict(zip(jobs, pool.map(finish, [job[0] for job in jobs.values()])))
    failed = []
    for source, (proc, tmp, target) in jobs.items():
        out, build_seconds[source] = done[source]
        by_source[source] = out
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{source}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, target)   # atomic: a reader sees a whole library
            for fn in build_listeners:
                try:
                    fn(source, build_seconds[source])
                except Exception:
                    pass  # a listener is telemetry: it never fails a build
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: by_source[KERNELS[name][0]] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (its source's), built first
    if needed, with every entry point of that source typed."""
    source = KERNELS[name][0]
    lib = _LIBS.get(source)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for kname, (ksource, entry, argtypes) in KERNELS.items():
            if ksource != source:
                continue
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{kname}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


def entry(name: str):
    """Kernel ``name``'s C entry point, bound once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(library(name), KERNELS[name][1])
    return fn


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point, raise if CUDA refused the
    launch, and count it."""
    rc = (_ENTRIES.get(name) or entry(name))(*args)
    if rc != 0:
        msg = getattr(library(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    with _LAUNCH_LOCK:
        launches[name] += 1
    counts = getattr(_THREAD, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1


def launch_on(device: torch.device, name: str, *args) -> None:
    """``launch`` on ``device``'s current stream (the stream is the last
    argument), switching devices only where ``device`` is not current."""
    index = device.index
    if index == torch.cuda.current_device():
        launch(name, *args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            launch(name, *args, torch._C._cuda_getCurrentRawStream(index))
