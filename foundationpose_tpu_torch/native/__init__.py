"""The port's host C++ code, built with ``g++`` at first use and bound with ctypes.

``cluster.cpp`` holds the greedy symmetric pose clustering that
``core/poses.cluster_poses`` calls when it builds a rotation grid. The library
is compiled into ``foundationpose_tpu_torch/_build/`` (git-ignored) under a
name keyed by a hash of the source and the flags, the first time a process
needs it; later processes load it from there. A build or load failure raises:
nothing gives way to the numpy version, which stays in ``core/poses.py`` as
``cluster_poses_plain``, the plain version the library is held against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCE = os.path.join(_DIR, "cluster.cpp")
# no fused multiply-add: the library rounds like the numpy version
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]
CALLS = {"fp_cluster_poses": 0}  # one more per call into the library
_lib = None


def build():
    """Compile ``cluster.cpp`` (unless this source and these flags were built
    before) and load it. Raises when there is no ``g++`` or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libfp_cluster_{key}.so")
    if not os.path.exists(so_path):
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the port's host library "
                               "(native/cluster.cpp) is built with it at first use")
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"  # processes building at once never share a file
        out = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{out.stdout}{out.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    fn = lib.fp_cluster_poses
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    _lib = lib
    return lib


def cluster_poses_native(angle_diff_deg, dist_diff, poses, symmetry_tfs):
    """Greedy pose clustering in C++: (N,4,4) poses -> the kept (M,4,4), in
    input order (see ``core/poses.cluster_poses_plain``)."""
    lib = build()
    poses = np.ascontiguousarray(poses, dtype=np.float64)
    sym = np.ascontiguousarray(symmetry_tfs, dtype=np.float64)
    keep = np.zeros(len(poses), dtype=np.uint8)
    lib.fp_cluster_poses(float(angle_diff_deg), float(dist_diff), poses.ctypes.data, len(poses),
                         sym.ctypes.data, len(sym), keep.ctypes.data)
    CALLS["fp_cluster_poses"] += 1
    return poses[keep.astype(bool)]
