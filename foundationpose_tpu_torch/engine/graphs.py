"""CUDA graphs of a tracked frame's refine and score calls.

A tracked frame refines 8 hypotheses for 2 iterations (K1s + K1r, the
observed warp and gate, RefineNet, the delta update) and scores them
(ScoreNet and the hybrid's geometric term): ~1,700 eager kernels whose shapes
are the same frame after frame. On an H100 the host's Python and launch calls
for them took ~60 ms a frame for ~7 ms of device work. ``GraphCache`` turns
each of the two calls into one ``cudaGraphLaunch`` of the same kernels, in
the same order, on the same data.

Per key (everything the captured work reads that is not a device buffer it
is given; the callers build it, see ``PoseRefiner.refine`` and
``PoseScorer.score``, and the cache adds the inputs' shapes and dtypes):

- the first call runs eagerly: it builds the kernels through nvcc if need be,
  lets cuDNN pick its algorithms and warms the allocator;
- the second call copies its inputs into static buffers and runs eagerly once
  more on a side stream — the warm-up ``torch.cuda.graphs`` asks for, so that
  per-stream state such as cuBLAS's workspace exists before the capture — and
  returns that result; then the same work is captured from the static buffers
  into a graph, which records it and runs nothing;
- every later call copies the caller's tensors into the static inputs,
  replays the graph and returns a copy of its static output. So a returned
  tensor is never written by a later frame, and the caller's tensors are
  neither kept nor written. The copies and the replay are queued on the
  caller's stream in call order, so a frame enqueued before the last one has
  run (``track_one(sync=False)``) reads the right inputs.

A key names a device buffer by its address, shape and dtype: weights loaded
in place are read by the next replay; a parameter or mesh tensor replaced by
another tensor changes the key, and the call captures anew.

All graphs of a cache share one memory pool: they run one after another on
one stream, and each one's static output stays allocated while the cache
holds it. The hand kernels' launch counter (``ops/kernels.LAUNCHES``) counts
what a call really launches: a capture's recording is taken back out of it,
and each replay adds what the graph launches. A capture is the span
``graph.capture`` (``n``: the kernels captured), a replay ``graph.replay``
(``n``: the kernels it runs).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from typing import Callable

import torch

from foundationpose_tpu_torch.ops import kernels
from foundationpose_tpu_torch.utils.profiling import span

_EAGER = object()  # a key whose first call ran eagerly
_CU_GRAPH_NODE_TYPE_KERNEL = 0
_libcuda = None


@dataclasses.dataclass
class Graph:
    """A captured call: ``replay()`` runs it on the ``inputs`` buffers into the
    ``output`` buffer; ``kernels`` is the number of kernels it runs and
    ``launches`` the hand kernels' launches among them, as (kernel, count)
    pairs."""

    replay: Callable[[], None]
    inputs: tuple
    output: torch.Tensor
    kernels: int
    launches: tuple


def tensors_key(tensors):
    """The part of a key that names a dict of device tensors the captured
    work reads without being given them: each one's address, shape and
    dtype."""
    return tuple((k, v.data_ptr(), v.shape, v.dtype) for k, v in tensors.items()
                 if isinstance(v, torch.Tensor))


def module_key(module):
    """The part of a key that names a net: its identity and where each of
    its parameters and buffers lives."""
    return (id(module), *((t.data_ptr(), t.shape, t.dtype)
                          for t in itertools.chain(module.parameters(), module.buffers())))


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def captured_kernels(stream):
    """The kernel nodes of the graph that ``stream`` is capturing, asked of
    ``libcuda`` before the capture ends."""
    global _libcuda
    if _libcuda is None:
        _libcuda = ctypes.CDLL("libcuda.so.1")
    cu, vp = _libcuda, ctypes.c_void_p
    status, graph = ctypes.c_int(), vp()
    _check(cu.cuStreamGetCaptureInfo_v2(vp(stream.cuda_stream), ctypes.byref(status), None,
                                        ctypes.byref(graph), None, None),
           "cuStreamGetCaptureInfo")
    n = ctypes.c_size_t()
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, n_kernels = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        _check(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        n_kernels += kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
    return n_kernels


class GraphCache:
    """The captured refine and score calls of one estimator's tracking, by
    key (see the module docstring). ``clear()`` drops them all."""

    def __init__(self):
        self._graphs = {}
        self._pool = None  # shared by every graph of the cache

    def clear(self):
        self._graphs.clear()

    def run(self, key, fn, inputs):
        """``fn(*inputs)``, a tensor: eagerly on the key's first call, eagerly
        and captured on its second, replayed from then on. ``inputs`` are
        device tensors; ``key`` names everything else ``fn`` reads."""
        key = (key, *((t.shape, t.dtype, t.device) for t in inputs))
        graph = self._graphs.get(key)
        if graph is None:
            self._graphs[key] = _EAGER
            return fn(*inputs)
        if graph is _EAGER:
            out, self._graphs[key] = self._capture(fn, tuple(t.clone() for t in inputs))
            return out
        for static, t in zip(graph.inputs, inputs):
            static.copy_(t)
        with span("graph.replay", graph.kernels):
            graph.replay()
        for kernel, n in graph.launches:
            kernels.LAUNCHES[kernel] += n
        return graph.output.clone()

    def _capture(self, fn, inputs):
        """Warm ``fn`` up on a side stream on the static ``inputs`` (its result
        is returned), then capture it there. Returns (result, ``Graph``)."""
        caller = torch.cuda.current_stream(inputs[0].device)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            out = fn(*inputs)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            before = dict(kernels.LAUNCHES)
            with span("graph.capture") as rec:
                graph.capture_begin(pool=self._pool)
                try:
                    output = fn(*inputs)
                    n_kernels = captured_kernels(side)
                finally:
                    graph.capture_end()
                if rec is not None:
                    rec["n"] = n_kernels
        caller.wait_stream(side)
        counts = kernels.LAUNCHES
        launches = tuple((k, counts[k] - n) for k, n in before.items() if counts[k] != n)
        counts.update(before)  # the recording launched nothing
        return out, Graph(graph.replay, inputs, output, n_kernels, launches)
