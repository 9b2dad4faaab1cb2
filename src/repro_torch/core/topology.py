"""Worker topologies: connected bipartite graphs, their head/tail 2-coloring,
a proper edge coloring into matchings, and the directed-edge index of the
trainer's O(E) state.

The port's own copy of ``repro/core/topology.py`` (numpy only; the port
imports nothing of ``repro``): ``Topology``, ``_edge_coloring``,
``_two_color``, ``EdgeIndex``, ``edge_index``, ``edge_schedule``, the
chain / ring / star / 2d-torus / two-tier (cluster-of-stars, federated) /
explicit-edge-list builders, and the worker placement of the paper's energy
model (``Placement``, ``random_placement``, ``head_tail_split``).
``tests/test_torch_topology.py`` and ``tests/test_torch_gadmm.py`` hold them
against the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# ----------------------------------------------------------- edge coloring --
def _edge_coloring(n: int, edges: np.ndarray) -> np.ndarray:
    """Proper edge coloring of a bipartite multigraph-free graph.

    Koenig's theorem: a bipartite graph with maximum degree C is C-edge-
    colorable; this is the classic constructive proof.  For each edge (u, v)
    take colors a free at u and b free at v; if they differ, flip the
    maximal alternating a/b path starting at v (it cannot reach u in a
    bipartite graph), freeing a at v.

    Returns ``port``: an (n, C) int array, ``port[i, c]`` = the neighbor
    matched to worker i in color class c, or -1.  Each color class is a
    matching — directly usable as one exchange permutation.
    """
    if len(edges) == 0:
        return -np.ones((n, 0), np.int64)
    deg = np.bincount(np.asarray(edges).ravel(), minlength=n)
    c_max = int(deg.max())
    port = -np.ones((n, c_max), np.int64)

    def first_free(x: int) -> int:
        for c in range(c_max):
            if port[x, c] < 0:
                return c
        raise AssertionError("edge coloring needs more colors than max degree"
                             " — graph is not simple/bipartite")

    for u, v in np.asarray(edges):
        u, v = int(u), int(v)
        a, b = first_free(u), first_free(v)
        if a != b:
            # walk the alternating a/b path from v and flip its colors
            path = []
            x, c = v, a
            while port[x, c] >= 0:
                y = int(port[x, c])
                path.append((x, y, c))
                x, c = y, (b if c == a else a)
            for x, y, c in path:
                port[x, c] = port[y, c] = -1
            for x, y, c in path:
                o = b if c == a else a
                port[x, o] = y
                port[y, o] = x
        port[u, a] = v
        port[v, a] = u
    return port


def _two_color(n: int, edges: np.ndarray) -> np.ndarray:
    """BFS head/tail 2-coloring; raises if the graph is not bipartite or not
    connected (GADMM needs both: phases alternate colors, consensus needs
    connectivity)."""
    adj: list[list[int]] = [[] for _ in range(n)]
    for u, v in np.asarray(edges):
        adj[int(u)].append(int(v))
        adj[int(v)].append(int(u))
    color = -np.ones(n, np.int8)
    color[0] = 0
    queue = [0]
    while queue:
        x = queue.pop()
        for y in adj[x]:
            if color[y] < 0:
                color[y] = 1 - color[x]
                queue.append(y)
            elif color[y] == color[x]:
                raise ValueError("topology is not bipartite: edge "
                                 f"({x}, {y}) joins two color-{color[x]} "
                                 "workers — no head/tail split exists")
    if n and (color < 0).any():
        raise ValueError("topology is not connected: workers "
                         f"{np.flatnonzero(color < 0).tolist()} are "
                         "unreachable from worker 0")
    return color


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """Connected bipartite worker graph with a head/tail coloring.

    edges: (E, 2) int, canonically oriented head -> tail (edges[:, 0] is the
           head endpoint).  One GADMM dual variable lives on each edge.
    color: (N,) int8 node coloring; heads = 0 transmit in phase one, tails =
           1 in phase two.
    port:  (N, C) int edge coloring, C = max degree: ``port[i, c]`` is i's
           neighbor via the color-c matching (or -1).  Color classes are the
           exchange rounds of a multi-device trainer.
    """

    kind: str
    n: int
    edges: np.ndarray
    color: np.ndarray
    port: np.ndarray

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    @property
    def num_ports(self) -> int:
        return self.port.shape[1]

    @property
    def head_mask(self) -> np.ndarray:
        return self.color == 0

    @property
    def degree(self) -> np.ndarray:
        return (self.port >= 0).sum(axis=1)

    def adjacency(self) -> np.ndarray:
        a = np.zeros((self.n, self.n), bool)
        if len(self.edges):
            a[self.edges[:, 0], self.edges[:, 1]] = True
            a[self.edges[:, 1], self.edges[:, 0]] = True
        return a

    def matchings(self) -> list[np.ndarray]:
        """Edge color classes, each a (Mc, 2) array of (u, v) with u < v."""
        out = []
        for c in range(self.num_ports):
            pairs = [(i, int(p)) for i, p in enumerate(self.port[:, c])
                     if 0 <= p and i < p]
            out.append(np.asarray(pairs, np.int64).reshape(-1, 2))
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeIndex:
    """Directed-edge view of a Topology — the O(E) state layout.

    Every undirected edge (h, t) appears twice, once per direction
    ``src -> dst``; a directed edge d is the slot where worker ``dst[d]``
    stores what it knows about ``src[d]`` (the neighbor-hat reconstruction
    and its mirror of the shared edge dual).  Directed edges are sorted by
    ``(dst, src)``: each worker's incoming slots are contiguous, and a
    ``segment_sum`` over ``dst`` adds a worker's neighbor terms in
    ascending-neighbor order.

    src, dst: (2E,) worker ids (payloads flow src -> dst).
    edge:     (2E,) undirected edge id into ``topo.edges``.
    color:    (2E,) edge color of that edge (Koenig matching index).
    slot:     (N, C) int: ``slot[w, c]`` = the directed edge with dst=w
              whose color is c, or -1 where w has no color-c edge — the
              port-dense <-> edge-indexed projection table.
    sign_dst: (2E,) float32: +1.0 where dst is the head endpoint, -1.0
              where it is the tail (the dual's canonical head -> tail
              orientation, seen from the storing endpoint).
    """

    src: np.ndarray
    dst: np.ndarray
    edge: np.ndarray
    color: np.ndarray
    slot: np.ndarray
    sign_dst: np.ndarray

    @property
    def num_directed(self) -> int:
        return len(self.src)


def edge_index(topo: Topology) -> EdgeIndex:
    """Build the directed-edge tables for a topology (W=1 / E=0 safe:
    every array is empty and ``slot`` is all -1)."""
    n, c_max = topo.port.shape
    e = topo.edges
    if len(e) == 0:
        z = np.zeros((0,), np.int64)
        return EdgeIndex(src=z, dst=z, edge=z, color=z.copy(),
                         slot=-np.ones((n, c_max), np.int64),
                         sign_dst=np.zeros((0,), np.float32))
    # color of each undirected edge from the port table
    ecolor = np.empty(len(e), np.int64)
    for i, (h, t) in enumerate(e):
        ecolor[i] = int(np.flatnonzero(topo.port[h] == t)[0])
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    eid = np.concatenate([np.arange(len(e))] * 2)
    order = np.lexsort((src, dst))
    src, dst, eid = src[order], dst[order], eid[order]
    color = ecolor[eid]
    slot = -np.ones((n, c_max), np.int64)
    slot[dst, color] = np.arange(len(dst))
    sign_dst = np.where(topo.head_mask[dst], 1.0, -1.0).astype(np.float32)
    return EdgeIndex(src=src, dst=dst, edge=eid, color=color, slot=slot,
                     sign_dst=sign_dst)


def edge_schedule(topo: Topology) -> list[list[tuple[int, int]]]:
    """One (src, dst) permutation per edge color, derived from the graph.

    Color class c is a matching, so sending BOTH directions of each of its
    edges is still a valid (partial) permutation: every worker appears at
    most once as source and once as destination."""
    perms = []
    for m in topo.matchings():
        perms.append([(int(u), int(v)) for u, v in m]
                     + [(int(v), int(u)) for u, v in m])
    return perms


def _make(kind: str, n: int, raw_edges,
          prefer_head: int | None = None) -> Topology:
    edges = np.asarray(sorted({(min(int(u), int(v)), max(int(u), int(v)))
                               for u, v in raw_edges if int(u) != int(v)}),
                       np.int64).reshape(-1, 2)
    color = _two_color(n, edges)
    if prefer_head is not None and color[prefer_head] == 1:
        color = (1 - color).astype(np.int8)  # global flip: coloring is
        # unique up to swapping heads/tails on a connected bipartite graph
    # canonical head -> tail orientation
    if len(edges):
        flip = color[edges[:, 0]] == 1
        edges = np.where(flip[:, None], edges[:, ::-1], edges)
        edges = edges[np.lexsort((edges[:, 1], edges[:, 0]))]
    port = _edge_coloring(n, edges)
    return Topology(kind=kind, n=n, edges=edges, color=color, port=port)


def chain_topology(n: int) -> Topology:
    """The paper's chain: worker i <-> i+1; heads at even positions."""
    if n < 1:
        raise ValueError(f"chain needs at least one worker, got {n}")
    return _make("chain", n, [(i, i + 1) for i in range(n - 1)])


def ring_topology(n: int) -> Topology:
    """Chain closed into a cycle.  n must be even (odd cycles are not
    2-colorable); n == 2 degenerates to the 2-chain."""
    if n < 2 or n % 2:
        raise ValueError("ring needs an even worker count (odd cycles are "
                         f"not bipartite), got {n}")
    return _make("ring", n, [(i, (i + 1) % n) for i in range(n)])


def star_topology(n: int, hub: int = 0) -> Topology:
    """PS-like star: every worker connects only to the hub.  The hub is the
    single head (transmits alone in phase one, like a PS downlink); leaves
    are tails."""
    if n < 2 or not 0 <= hub < n:
        raise ValueError(f"star needs n >= 2 and a hub in range, got {n}, {hub}")
    edges = [(hub, i) for i in range(n) if i != hub]
    return _make("star", n, edges, prefer_head=hub)


def torus2d_topology(rows: int, cols: int) -> Topology:
    """2D torus (rows x cols grid with wraparound).  Both dims must be even
    for 2-colorability; dim == 2 degenerates gracefully (the wrap edge
    coincides with the direct edge and is deduplicated)."""
    if rows < 2 or cols < 2 or rows % 2 or cols % 2:
        raise ValueError(f"2d-torus needs even dims >= 2, got {rows}x{cols}")
    edges = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            edges.append((i, r * cols + (c + 1) % cols))
            edges.append((i, ((r + 1) % rows) * cols + c))
    return _make("torus2d", rows * cols, edges)


def bipartite_topology(n: int, edges) -> Topology:
    """Arbitrary connected bipartite graph from an explicit edge list; the
    head/tail coloring is recovered by BFS (raises if none exists)."""
    return _make("bipartite", n, edges)


def _cluster_bounds(n: int, clusters: int) -> tuple[np.ndarray, np.ndarray]:
    """Split n workers into ``clusters`` contiguous id ranges, sizes as
    equal as possible (first ``n % clusters`` ranges get one extra)."""
    sizes = np.full(clusters, n // clusters, np.int64)
    sizes[: n % clusters] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return starts, sizes


def default_clusters(n: int) -> int:
    """Cluster count of the two-tier builders: ~sqrt(n) leaders balances
    backbone depth against per-leader fan-out (n = 10^4 -> 100 clusters of
    100)."""
    return max(1, int(round(np.sqrt(n))))


def cluster_of_stars_topology(n: int, clusters: int | None = None,
                              backbone: str = "chain") -> Topology:
    """Two-tier graph: per-cluster stars joined by a leader backbone.

    Workers split into ``clusters`` contiguous id ranges; the first id of
    each range leads it and the rest are its leaves (a star).  The leaders
    are joined by a chain (``backbone='chain'``, kind ``cluster_of_stars``)
    or all to leader 0 (``'star'``, kind ``federated``).  Both are trees of
    stars, so connected and bipartite.  ``clusters=None`` picks
    ``default_clusters(n)``."""
    if n < 2:
        raise ValueError(f"a two-tier graph needs n >= 2, got {n}")
    c = default_clusters(n) if clusters is None else int(clusters)
    if not 1 <= c <= n:
        raise ValueError(f"need 1 <= clusters <= n, got {c} for n={n}")
    if backbone not in ("chain", "star"):
        raise ValueError(f"unknown backbone {backbone!r}")
    starts, sizes = _cluster_bounds(n, c)
    edges: list[tuple[int, int]] = []
    for s, sz in zip(starts.tolist(), sizes.tolist()):
        edges.extend((s, s + j) for j in range(1, sz))
    if backbone == "chain":
        kind = "cluster_of_stars"
        edges.extend((int(starts[j]), int(starts[j + 1]))
                     for j in range(c - 1))
    else:
        kind = "federated"
        edges.extend((int(starts[0]), int(starts[j])) for j in range(1, c))
    return _make(kind, n, edges, prefer_head=0)


def _torus_dims(n: int) -> tuple[int, int]:
    """Most-square even x even factorization of n (requires n % 4 == 0)."""
    if n % 4:
        raise ValueError(f"2d-torus needs num_workers % 4 == 0, got {n}")
    best = (2, n // 2)
    r = 2
    while r * r <= n:
        if n % r == 0 and r % 2 == 0 and (n // r) % 2 == 0:
            best = (r, n // r)
        r += 2
    return best


TOPOLOGY_KINDS = ("chain", "ring", "star", "torus2d",
                  "cluster_of_stars", "federated")


def build_topology(kind_or_topo, n: int) -> Topology:
    """Resolve a topology spec (a kind name or an explicit Topology) for n
    workers."""
    if isinstance(kind_or_topo, Topology):
        if kind_or_topo.n != n:
            raise ValueError(f"topology has {kind_or_topo.n} workers, not {n}")
        return kind_or_topo
    kind = str(kind_or_topo)
    if kind == "chain":
        return chain_topology(n)
    if kind == "ring":
        return ring_topology(n)
    if kind == "star":
        return star_topology(n)
    if kind == "torus2d":
        return torus2d_topology(*_torus_dims(n))
    if kind == "cluster_of_stars":
        return cluster_of_stars_topology(n)
    if kind == "federated":
        return cluster_of_stars_topology(n, backbone="star")
    raise ValueError(f"unknown topology {kind!r}; expected one of "
                     f"{TOPOLOGY_KINDS} or a Topology instance")


# --------------------------------------------------------------- placement --
# Above this worker count the placement helpers switch from the paper's
# O(N^2) heuristics (nearest-neighbor chain walk, full pairwise matrix) to
# O(N) equivalents.
DENSE_PLACEMENT_MAX = 1024


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """Workers dropped on a plane, for the paper's energy model (Sec. V-A)."""

    positions: np.ndarray       # (N, 2) worker coordinates in meters
    chain: np.ndarray           # (N,) permutation: chain order of worker ids
    ps_index: int               # worker id acting as parameter server
    chain_hop_dist: np.ndarray  # (N-1,) distance between chain neighbors
    ps_dist: np.ndarray         # (N,) distance of every worker to the PS
    topology: Topology | None = None  # None = legacy chain placement

    @property
    def n(self) -> int:
        return len(self.positions)

    def resolved_topology(self) -> Topology:
        if self.topology is not None:
            return self.topology
        order = self.chain
        return _make("chain", self.n,
                     [(int(order[j]), int(order[j + 1]))
                      for j in range(self.n - 1)],
                     prefer_head=int(order[0]) if self.n else None)

    def edge_dists(self) -> np.ndarray:
        """(E,) meters per undirected topology edge, in ``topo.edges``
        order."""
        e = self.resolved_topology().edges
        if not len(e):
            return np.zeros((0,))
        return np.linalg.norm(self.positions[e[:, 0]] - self.positions[e[:, 1]],
                              axis=1)

    def broadcast_dist(self) -> np.ndarray:
        """Per-worker transmit distance, in worker-id order: the farthest
        topology neighbor (one broadcast reaches all of them)."""
        topo = self.resolved_topology()
        out = np.zeros(self.n)
        if topo.num_edges:
            d = self.edge_dists()
            np.maximum.at(out, topo.edges[:, 0], d)
            np.maximum.at(out, topo.edges[:, 1], d)
        return out


def random_placement(n: int, seed: int, grid: float = 250.0,
                     topology: str = "chain") -> Placement:
    """Drop n workers uniformly in the grid and connect them.

    'chain' is the paper's nearest-neighbor chain heuristic; 'ring' closes
    it into a cycle (even n); 'star' uses the min-sum-distance worker as
    hub (the PS baselines' server); 'torus2d' lays the chain order onto the
    most-square even torus grid; 'cluster_of_stars' and 'federated' are the
    two-tier graphs over worker ids (``cluster_of_stars_topology``)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, grid, size=(n, 2))
    if n > DENSE_PLACEMENT_MAX:
        # chain = id order; PS = the worker nearest the centroid
        chain = np.arange(n)
        ps = int(np.argmin(np.linalg.norm(pos - pos.mean(axis=0), axis=1)))
        ps_dist = np.linalg.norm(pos - pos[ps], axis=1)
    else:
        start = int(np.argmin(pos.sum(axis=1)))
        unvisited = set(range(n)) - {start}
        chain = [start]
        while unvisited:
            last = pos[chain[-1]]
            nxt = min(unvisited,
                      key=lambda j: float(np.sum((pos[j] - last) ** 2)))
            chain.append(nxt)
            unvisited.remove(nxt)
        chain = np.asarray(chain)
        dmat = np.linalg.norm(pos[None, :, :] - pos[:, None, :], axis=-1)
        ps = int(np.argmin(dmat.sum(axis=1)))
        ps_dist = dmat[ps]
    hop = np.linalg.norm(pos[chain[1:]] - pos[chain[:-1]], axis=1)

    if topology == "chain":
        topo = _make("chain", n, [(int(chain[j]), int(chain[j + 1]))
                                  for j in range(n - 1)],
                     prefer_head=int(chain[0]))
    elif topology == "ring":
        if n < 2 or n % 2:
            raise ValueError("ring needs an even worker count (odd cycles "
                             f"are not bipartite), got {n}")
        topo = _make("ring", n, [(int(chain[j]), int(chain[(j + 1) % n]))
                                 for j in range(n)],
                     prefer_head=int(chain[0]))
    elif topology == "star":
        topo = star_topology(n, hub=ps)
    elif topology == "torus2d":
        rows, cols = _torus_dims(n)
        grid_ids = chain.reshape(rows, cols)
        edges = []
        for r in range(rows):
            for c in range(cols):
                edges.append((int(grid_ids[r, c]),
                              int(grid_ids[r, (c + 1) % cols])))
                edges.append((int(grid_ids[r, c]),
                              int(grid_ids[(r + 1) % rows, c])))
        topo = _make("torus2d", n, edges)
    elif topology in ("cluster_of_stars", "federated"):
        topo = cluster_of_stars_topology(
            n, backbone="chain" if topology == "cluster_of_stars" else "star")
    else:
        raise ValueError(f"unknown topology {topology!r}")
    return Placement(positions=pos, chain=chain, ps_index=ps,
                     chain_hop_dist=hop, ps_dist=ps_dist, topology=topo)


def head_tail_split(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Chain positions 0, 2, 4, ... are heads; 1, 3, 5, ... are tails."""
    idx = np.arange(n)
    return idx[idx % 2 == 0], idx[idx % 2 == 1]
