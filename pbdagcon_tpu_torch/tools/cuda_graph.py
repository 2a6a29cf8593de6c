"""CUDA graphs on the card: `graph_ms` times work replayed from a graph
(device time, without the host's launches), and `node_counts` counts a
captured graph's nodes by type (kernel, memset, ...) through
`libcuda.so.1`, which `chip_smoke.py` and the card tests read to show
that each histogram or scatter call is one kernel node and no memset
node. For `node_counts` the graph must be captured with
`torch.cuda.CUDAGraph(keep_graph=True)`, which keeps its `cudaGraph_t`
(`raw_cuda_graph()`).
"""

from __future__ import annotations

import ctypes

# CUgraphNodeType (cuda.h), the types a captured stream can hold.
_NODE_TYPES = {
    0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
    6: "wait_event", 7: "event_record", 10: "mem_alloc", 11: "mem_free",
}


def graph_ms(fn, reps: int, copies: int = 1) -> float:
    """Device ms of `fn` captured `copies` times in one CUDA graph and
    replayed `reps` times, per copy (no host launch cost in the time;
    with copies > 1 no gap between replays either, which bounds the
    reading of a call of a few microseconds)."""
    import torch

    fn()  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            fn()
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps / copies


def node_counts(raw_graph: int) -> dict[str, int]:
    """{node type: count} of the graph `raw_graph` (a cudaGraph_t as an
    int). Raises if `libcuda` refuses the query."""
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    graph = ctypes.c_void_p(raw_graph)
    rc = cuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    nodes = (ctypes.c_void_p * n.value)()
    rc = cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    counts: dict[str, int] = {}
    for node in nodes[: n.value]:
        t = ctypes.c_int(-1)
        rc = cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        if rc != 0:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {rc}")
        name = _NODE_TYPES.get(t.value, f"type {t.value}")
        counts[name] = counts.get(name, 0) + 1
    return counts
