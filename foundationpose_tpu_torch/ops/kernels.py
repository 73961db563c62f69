"""The port's hand-written card kernels: one table, one build, one launch path.

Each CUDA library is one row of ``LIBRARIES``: its source under ``csrc/``,
its extra nvcc flags, its C launch function's name and ctypes types, and the
span its launch call runs in. A wrapper (``ops/raster_cuda.py``: K1s, K1r;
``ops/depth_cuda.py``: K2) checks the arguments, keeps the plain version for
CPU tensors and calls ``launch``; a new kernel is a source, a row and such a
wrapper. The first launch in a process builds every row at once, one nvcc
per source side by side, content-hashed into ``_build/``
(``native.compile_libraries``), and loads them all. A build, load or launch
failure raises; nothing falls back. ``LAUNCHES`` counts each kernel's
launches and nothing else (``engine/graphs.py`` keeps it true across a
capture and its replays); ``launched_libraries()`` names the files whose
code those launches called.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from foundationpose_tpu_torch import native
from foundationpose_tpu_torch.utils.profiling import span

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Library:
    """A card library: ``source`` built with ``NVCC_FLAGS`` + ``flags``; its C
    launch function ``entry`` takes ``argtypes`` (the stream last) and returns
    ``restype``, a CUDA error (0: none); its launch call is the span
    ``span``."""

    source: str
    flags: tuple
    entry: str
    argtypes: tuple
    span: str
    restype: type = _ci


# K1s and K2 round a*b+c twice, as the eager tensor ops of their plain
# versions do (see the notes in their sources)
LIBRARIES = {
    "K1s": Library(os.path.join(_CSRC, "raster_setup.cu"), ("-fmad=false",),
                   "fp_raster_setup_launch", (_vp,) * 6 + (_ci,) * 6 + (_cf,) * 3 + (_vp,) * 4,
                   "raster.K1s"),
    "K1r": Library(os.path.join(_CSRC, "raster.cu"), (), "fp_raster_launch",
                   (_vp,) * 6 + (_ci,) * 9 + (_cf,) * 2 + (_vp,) * 8, "raster.K1r"),
    "K2": Library(os.path.join(_CSRC, "depth_preprocess.cu"), ("-fmad=false",),
                  "fp_depth_preprocess_launch", (_vp, _vp, _ci, _ci, _vp, _vp, _vp), "depth.K2"),
}
LAUNCHES = dict.fromkeys(LIBRARIES, 0)  # one more per launch of that kernel
BUILD_LOG = {}  # library -> compiler output (ptxas register / shared memory report)
_paths = None
_fns = None
_LAUNCHED_FNS = {name: {} for name in LIBRARIES}  # kernel -> {id: launch function called}


def nvcc():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's default
    place, else whatever the PATH gives (a missing compiler raises)."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.exists(cand):
            return cand
    return "nvcc"


def spec(name):
    """(source, nvcc flags) of the library ``name`` of ``LIBRARIES``."""
    lib = LIBRARIES[name]
    return lib.source, NVCC_FLAGS + list(lib.flags)


def library_paths():
    """Build every library of ``LIBRARIES`` into ``_build/`` once per
    process, the compilers running side by side, so a checkout's first call
    pays one build. Returns {kernel: library path}. Raises on any failure."""
    global _paths
    if _paths is None:
        _paths = native.compile_libraries(nvcc(), {name: spec(name) for name in LIBRARIES},
                                          BUILD_LOG)
    return _paths


def load(name, path):
    """The typed launch function of kernel ``name`` in the library ``path``
    (a build of its source, with or without further flags)."""
    lib = LIBRARIES[name]
    fn = getattr(ctypes.CDLL(path), lib.entry)
    fn.argtypes = list(lib.argtypes)
    fn.restype = lib.restype
    return fn


def build():
    """Build (``library_paths``) and load every kernel of the table. Returns
    {kernel: launch function}. Raises on any failure."""
    global _fns
    if _fns is None:
        _fns = {name: load(name, path) for name, path in library_paths().items()}
    return _fns


def launch(name, device, *args):
    """Launch kernel ``name`` on ``device``'s current stream with ``args``
    (its launch function's arguments before the stream), inside its span;
    raises on a CUDA error and counts the launch."""
    fn = build()[name]
    with torch.cuda.device(device), span(LIBRARIES[name].span):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    _LAUNCHED_FNS[name][id(fn)] = fn  # ctypes functions do not hash


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", ctypes.c_void_p)]


def library_file(fn):
    """The file of the shared library that holds the code of the ctypes
    function ``fn``, as the dynamic loader resolves its address
    (``dladdr``), with links resolved."""
    dladdr = ctypes.CDLL(None).dladdr
    dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    info = _DlInfo()
    if not dladdr(ctypes.cast(fn, ctypes.c_void_p), ctypes.byref(info)) or not info.dli_fname:
        raise RuntimeError(f"the dynamic loader places {fn} in no library")
    return os.path.realpath(info.dli_fname.decode())


def launched_libraries():
    """{kernel: set of library files} that this process's kernel launches
    called into, since it started."""
    return {name: {library_file(fn) for fn in fns.values()}
            for name, fns in _LAUNCHED_FNS.items()}
