"""What the port's CUDA graphs share: the one capture stream a device, the
capture itself, the key a graph is kept under, and the nodes a captured
graph holds, read back from the graph.

The reference compiles its prefill, its decode step and its train step
with ``jax.jit``; the port captures each of them as a CUDA graph on the
card (``serve.engine.PrefillGraph`` and ``DecodeGraph``,
``train.step.TrainGraph``), all through :func:`_captured` on the stream
:func:`_capture_stream` gives.
"""
from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree


def _kernel_nodes(cu, graph: "torch.cuda.CUDAGraph") -> Tuple[int, list]:
    """(nodes, the kernel nodes' handles) of a graph captured with
    ``keep_graph=True``, read from its ``cudaGraph_t``."""
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(0), []
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value == 0:                         # CU_GRAPH_NODE_TYPE_KERNEL
            kernels.append(node)
    return n.value, kernels


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> Tuple[int, int]:
    """(nodes, kernel nodes) of a graph captured with ``keep_graph=True``,
    read with ``libcuda``'s ``cuGraphGetNodes``."""
    n, kernels = _kernel_nodes(ctypes.CDLL("libcuda.so.1"), graph)
    return n, len(kernels)


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def graph_kernel_names(graph: "torch.cuda.CUDAGraph") -> Tuple[int, List[str]]:
    """(nodes, the mangled function name of each kernel node) of a graph
    captured with ``keep_graph=True``: what the graph launches, read from
    the graph itself (``cuGraphKernelNodeGetParams`` and
    ``cuFuncGetName``, or ``cuKernelGetName`` for a node that holds a
    ``CUkernel``)."""
    cu = ctypes.CDLL("libcuda.so.1")
    n, kernels = _kernel_nodes(cu, graph)
    names = []
    for node in kernels:
        p, name = _KernelNodeParams(), ctypes.c_char_p()
        if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                            ctypes.byref(p)) != 0:
            raise RuntimeError("cuGraphKernelNodeGetParams failed")
        if p.func:
            err = cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(p.func))
        else:
            err = cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(p.kern))
        if err != 0 or name.value is None:
            raise RuntimeError(f"no name for a kernel node (CUDA error "
                               f"{err})")
        names.append(name.value.decode())
    return n, names


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The one side stream on which every graph of ``dev`` (prefill,
    decode and train step) warms up and is captured.  cuBLAS keeps a
    workspace (32 MiB on an H100) for each stream it has run on, for the
    life of the process: a stream a graph would leave one behind with
    every server."""
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


def _spec(tree) -> tuple:
    """The key of a dict of tensors: its names, shapes and types, as
    jit's cache keys a call's arguments."""
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted(tree.items()))


def _warmed(stream: "torch.cuda.Stream", fn):
    """``fn()`` run eagerly on ``stream``, a graph's warm-up before its
    capture there: cuBLAS, the allocator and autograd set up what a
    capture cannot, on the capturing stream, and that call is a real one.
    It starts after the current stream's queued work and the current
    stream waits for it; the tensors it returns are recorded on the
    current stream, where the caller uses them.  Returns what ``fn``
    returned."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor):
            t.record_stream(cur)
    return out


def _captured(stream: "torch.cuda.Stream", fn, pool=None):
    """``fn()`` captured on ``stream`` into a new graph (in ``pool`` if
    given), kept for :func:`graph_nodes` and instantiated.  Returns (graph,
    what ``fn`` returned, the seconds taken).  An op that cannot be
    captured raises its own error.  The capture is thread-local: the
    autograd engine's device thread, which runs a train step's backward,
    queues its kernels on the capturing stream and is captured too."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:        # the error above invalidated it
                pass
            raise
        graph.capture_end()
    graph.instantiate()
    return graph, out, time.perf_counter() - t0
