"""Shortest-path search with Dijkstra's algorithm on the TNS SIM engine
(paper §3.1 / S13, Algorithm S1).

The paper stores all neighbor distances as 16-bit floats in the 1T1R array
(1 sign + 5 exponent + 10 fraction cells, Fig. 5c), then repeatedly uses
TNS min-search (k=2) to pick the nearest unvisited node.  We reproduce the
experiment on a 16-station Beijing-subway-like graph: 16 nodes on 6 lines,
each node with 3-4 neighbors, 54 directed distances (27 edges), and report
the paper's observables: DRs per sorted number (~3, Fig. 5e) and the
CPU-vs-SIM throughput/energy comparison (Fig. 5f) via the cost model.

Node names follow Fig. 5a's example (subset of real Beijing stations); the
distances are representative km values.

The engines run on ``device`` (``None``: the card; ``"cpu"`` runs them on
the host).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch import sort as sort_engine
from repro_torch.core import bitplane as bp

STATIONS = [
    "XiZhiMen", "DaZhongSi", "ZhiChunLu", "WuDaoKou", "XiTuCheng",
    "MuDanYuan", "JiShuiTan", "GuLouDaJie", "AnDingMen", "YongHeGong",
    "DongZhiMen", "DongSiShiTiao", "ChaoYangMen", "JianGuoMen",
    "ChongWenMen", "QianMen",
]

# (u, v, km): 27 bidirectional edges -> 54 stored neighbor distances, each
# node having 3-4 neighbors as in Fig. 5a.
EDGES = [
    (0, 1, 1.7), (1, 2, 1.1), (2, 3, 1.2), (3, 4, 2.4), (4, 5, 1.1),
    (0, 6, 1.8), (6, 7, 1.4), (7, 8, 1.6), (8, 9, 1.2), (9, 10, 2.2),
    (10, 11, 1.0), (11, 12, 1.1), (12, 13, 1.4), (13, 14, 1.3),
    (14, 15, 1.2), (0, 4, 2.9), (5, 7, 2.1), (2, 8, 3.4), (3, 9, 3.9),
    (4, 7, 2.6), (9, 13, 3.3), (10, 13, 3.0), (6, 15, 4.1), (8, 11, 2.7),
    (1, 5, 2.0), (12, 14, 1.9), (15, 14, 1.1),
]


def adjacency(n: int = 16) -> Dict[int, List[Tuple[int, float]]]:
    adj: Dict[int, List[Tuple[int, float]]] = {i: [] for i in range(n)}
    for u, v, w in EDGES:
        adj[u].append((v, w))
        adj[v].append((u, w))
    return adj


@dataclasses.dataclass
class DijkstraResult:
    dist: np.ndarray
    prev: np.ndarray
    path: List[int]
    total_drs: int
    total_cycles: int
    numbers_sorted: int
    fig5e_drs: int = 0           # DRs spent sorting neighbor lists
    fig5e_numbers: int = 0

    @property
    def drs_per_number(self) -> float:
        return self.total_drs / max(1, self.numbers_sorted)

    @property
    def fig5e_drs_per_number(self) -> float:
        """Fig. 5e metric: DRs per number when sorting each station's
        neighbor distances (paper: ~3 with k=2)."""
        return self.fig5e_drs / max(1, self.fig5e_numbers)


# "tns" is the cycle-faithful machine (the reference package's "jax"),
# "oracle" the event-driven oracle
_ENGINE_ALIAS = {"tns": "tns", "oracle": "tns-oracle"}


def _tns_argmin(values: np.ndarray, k: int = 2, engine: str = "tns",
                device=None) -> Tuple[int, int, int]:
    """Index of the min of a float16 array via one TNS min-search on the
    sort-engine facade.  Returns (argmin, cycles, drs)."""
    arr = np.asarray(values, dtype=np.float16)
    res = sort_engine.sort(arr, engine=_ENGINE_ALIAS.get(engine, engine),
                           fmt=bp.FLOAT, width=16, k=k, stop_after=1,
                           device=device)
    return (int(res.indices[0]), int(np.asarray(res.cycles)),
            int(np.asarray(res.drs)))


def shortest_path(src: int, dst: int, k: int = 2, engine: str = "oracle",
                  full_sort_stats: bool = True,
                  device=None) -> DijkstraResult:
    """Algorithm S1 with the min-selection on the SIM engine.

    ``full_sort_stats``: additionally run a full TNS sort of each node's
    neighbor distances (the Fig. 5e experiment sorts each node's neighbor
    list) to accumulate the DR statistics the paper reports."""
    adj = adjacency()
    n = len(STATIONS)
    INF = np.float16(np.inf)
    dist = np.full(n, np.inf)
    prev = np.full(n, -1, dtype=np.int64)
    dist[src] = 0.0
    in_q = np.ones(n, dtype=bool)
    total_drs = total_cycles = numbers = 0

    # Fig. 5e: per-node neighbor-sort statistics — every node's neighbor
    # list is an independent dataset, so the batched engine sorts the
    # lists of one length in one call
    fig5e_drs = fig5e_numbers = 0
    if full_sort_stats:
        ename = _ENGINE_ALIAS.get(engine, engine)
        if ename == "tns":
            # group nodes by neighbor count so each group is a rectangular
            # (B, N) batch — cycle counts stay exactly per-list (no
            # sentinel padding, which would distort the DR statistics)
            by_len: Dict[int, List[int]] = {}
            for i in range(n):
                by_len.setdefault(len(adj[i]), []).append(i)
            for ln, nodes in by_len.items():
                batch = np.array([[w for _, w in adj[i]] for i in nodes],
                                 dtype=np.float16)
                res = sort_engine.sort(batch, engine="tns", fmt=bp.FLOAT,
                                       width=16, k=k, device=device)
                fig5e_drs += int(np.sum(np.asarray(res.drs)))
                total_cycles += int(np.sum(np.asarray(res.cycles)))
                fig5e_numbers += ln * len(nodes)
        else:
            for i in range(n):
                dvals = np.array([w for _, w in adj[i]], dtype=np.float16)
                res = sort_engine.sort(dvals, engine=ename, fmt=bp.FLOAT,
                                       width=16, k=k, device=device)
                fig5e_drs += int(np.asarray(res.drs))
                total_cycles += int(np.asarray(res.cycles))
                fig5e_numbers += len(dvals)
        total_drs += fig5e_drs
        numbers += fig5e_numbers

    for _ in range(n):
        # select the nearest unvisited node with a TNS min-search over the
        # candidate distance vector (the paper's iterative min selection)
        cand = np.where(in_q, dist, np.inf).astype(np.float16)
        if not np.isfinite(cand).any():
            break
        u, cyc, drs = _tns_argmin(cand, k=k,
                                  engine="oracle" if engine == "oracle"
                                  else "tns", device=device)
        total_cycles += cyc
        total_drs += drs
        numbers += 1
        in_q[u] = False
        if u == dst:
            break
        for v, w in adj[u]:
            if in_q[v] and dist[u] + w < dist[v]:
                dist[v] = dist[u] + w
                prev[v] = u

    path = []
    node = dst
    while node != -1:
        path.append(node)
        node = int(prev[node]) if node != src else -1
    path.reverse()
    return DijkstraResult(dist=dist, prev=prev, path=path,
                          total_drs=total_drs, total_cycles=total_cycles,
                          numbers_sorted=numbers, fig5e_drs=fig5e_drs,
                          fig5e_numbers=fig5e_numbers)


def reference_shortest_path(src: int, dst: int) -> Tuple[float, List[int]]:
    """numpy/comparison-based Dijkstra oracle."""
    import heapq
    adj = adjacency()
    n = len(STATIONS)
    dist = [float("inf")] * n
    prev = [-1] * n
    dist[src] = 0.0
    pq = [(0.0, src)]
    seen = set()
    while pq:
        d, u = heapq.heappop(pq)
        if u in seen:
            continue
        seen.add(u)
        for v, w in adj[u]:
            if d + w < dist[v]:
                dist[v] = d + w
                prev[v] = u
                heapq.heappush(pq, (dist[v], v))
    path = []
    node = dst
    while node != -1:
        path.append(node)
        node = prev[node]
    path.reverse()
    return dist[dst], path
