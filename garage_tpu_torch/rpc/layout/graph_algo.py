"""Flow algorithms for partition assignment.

The reference (src/rpc/layout/graph_algo.rs) uses Dinic max-flow for the
feasibility dichotomy and cycle-cancelling to minimize rebalance moves.
This implementation keeps Dinic for feasibility but computes the final
assignment as a min-cost max-flow via successive shortest augmenting paths
(SPFA): with the 0/1 move costs used here both approaches yield a
maximum flow of minimum total cost, and successive-shortest-paths is far
better suited to Python (few hundred augmentations of near-linear SPFA).
"""

from __future__ import annotations

from collections import deque

INF = float("inf")


class FlowGraph:
    """Directed flow network with per-edge capacity and cost."""

    def __init__(self, n: int):
        self.n = n
        # edge arrays; edge i's reverse is i^1
        self.to: list[int] = []
        self.cap: list[int] = []
        self.cost: list[int] = []
        self.adj: list[list[int]] = [[] for _ in range(n)]

    def add_edge(self, u: int, v: int, cap: int, cost: int = 0) -> int:
        eid = len(self.to)
        self.to.append(v)
        self.cap.append(cap)
        self.cost.append(cost)
        self.adj[u].append(eid)
        self.to.append(u)
        self.cap.append(0)
        self.cost.append(-cost)
        self.adj[v].append(eid + 1)
        return eid

    def flow_on(self, eid: int) -> int:
        """Flow pushed through forward edge eid = capacity of its reverse."""
        return self.cap[eid ^ 1]

    # --- Dinic max-flow (feasibility checks) --------------------------------

    def max_flow(self, s: int, t: int) -> int:
        flow = 0
        while True:
            level = self._bfs_levels(s, t)
            if level[t] < 0:
                return flow
            it = [0] * self.n
            while True:
                pushed = self._dfs_push(s, t, INF, level, it)
                if not pushed:
                    break
                flow += pushed

    def _bfs_levels(self, s: int, t: int) -> list[int]:
        level = [-1] * self.n
        level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for eid in self.adj[u]:
                v = self.to[eid]
                if self.cap[eid] > 0 and level[v] < 0:
                    level[v] = level[u] + 1
                    q.append(v)
        return level

    def _dfs_push(self, u: int, t: int, f, level, it) -> int:
        if u == t:
            return int(f)
        while it[u] < len(self.adj[u]):
            eid = self.adj[u][it[u]]
            v = self.to[eid]
            if self.cap[eid] > 0 and level[v] == level[u] + 1:
                pushed = self._dfs_push(v, t, min(f, self.cap[eid]), level, it)
                if pushed:
                    self.cap[eid] -= pushed
                    self.cap[eid ^ 1] += pushed
                    return pushed
            it[u] += 1
        return 0

    # --- min-cost max-flow (final assignment) -------------------------------

    def min_cost_max_flow(self, s: int, t: int) -> tuple[int, int]:
        """Successive shortest augmenting paths (SPFA).  Costs must be
        non-negative on original edges.  Returns (flow, cost)."""
        flow = cost = 0
        while True:
            dist = [INF] * self.n
            in_q = [False] * self.n
            prev_edge = [-1] * self.n
            dist[s] = 0
            q = deque([s])
            in_q[s] = True
            while q:
                u = q.popleft()
                in_q[u] = False
                du = dist[u]
                for eid in self.adj[u]:
                    if self.cap[eid] <= 0:
                        continue
                    v = self.to[eid]
                    nd = du + self.cost[eid]
                    if nd < dist[v]:
                        dist[v] = nd
                        prev_edge[v] = eid
                        if not in_q[v]:
                            q.append(v)
                            in_q[v] = True
            if dist[t] == INF:
                return flow, cost
            # bottleneck along the path
            push = INF
            v = t
            while v != s:
                eid = prev_edge[v]
                push = min(push, self.cap[eid])
                v = self.to[eid ^ 1]
            v = t
            while v != s:
                eid = prev_edge[v]
                self.cap[eid] -= push
                self.cap[eid ^ 1] += push
                v = self.to[eid ^ 1]
            flow += int(push)
            cost += int(push) * int(dist[t])
