"""A* route search and path stitching on the padded road graph (counterpart
of ``emplanner_carla_tpu/routing/astar.py``; the reference's ``_A_star`` /
``_route_search`` / ``search_path_way``, ``planner/global_planning.py:153-272``).

Two engines over the same RoadGraph, each held against its own twin in the
JAX package (they break ties differently, so never against each other):

* ``astar_host``, ``stitch_route`` and ``plan_route``: NumPy on the host,
  for scenario construction (routing is setup, not the hot loop);
* ``astar_device``, ``route_nodes_device`` and ``stitch_route_device``:
  batch-first torch for thousands of (start, goal) queries at once. The
  open set becomes fixed (B, N) tensors and the "until the goal is popped"
  loop a fixed N iterations with no host synchronisation inside; pops and
  relaxations are gathers and a scatter-min where the JAX package contracts
  one-hot masks (the same values).

Both use the metric edge length as cost and the Euclidean heuristic
(``global_planning.py:180-184``).
"""

from __future__ import annotations

import numpy as np
import torch

from emplanner_carla_tpu_torch.routing.graph import RoadGraph
from emplanner_carla_tpu_torch.types import Tensor, hypot

_INF = 1e30


def astar_host(g: RoadGraph, start: int, goal: int) -> list[int] | None:
    """Host A*: returns node-id route (or None if unreachable). Ties in f
    go to the first node in the open set's insertion order."""
    xy = g.nodes_xy
    h = lambda n: float(np.hypot(*(xy[n] - xy[goal])))  # noqa: E731
    open_set = {start: (0.0, -1)}
    closed: dict[int, tuple[float, int]] = {}
    while open_set:
        c = min(open_set, key=lambda n: open_set[n][0] + h(n))
        if c == goal:
            closed[c] = open_set.pop(c)
            break
        g_c, parent = open_set.pop(c)
        closed[c] = (g_c, parent)
        for k in range(g.adj.shape[1]):
            suc = int(g.adj[c, k])
            if suc < 0 or suc in closed:
                continue
            cost = g_c + float(g.edge_len[g.adj_edge[c, k]])
            if suc not in open_set or cost < open_set[suc][0]:
                open_set[suc] = (cost, c)
    else:
        return None
    route = [goal]
    while closed[route[-1]][1] != -1:
        route.append(closed[route[-1]][1])
    return list(reversed(route))


def stitch_route(g: RoadGraph, route: list[int], with_options: bool = False):
    """Concatenate the edge polylines along a node route into one (M, 2)
    global path (``search_path_way``'s stitching), dropping duplicated
    junction points. With ``with_options`` also the per-point RoadOption."""
    pts: list[np.ndarray] = []
    opts: list[np.ndarray] = []
    for a, b in zip(route[:-1], route[1:]):
        e = g.edge_between(a, b)
        if e < 0:
            raise ValueError(f"no edge {a}->{b}")
        path = g.edge_path[e, : g.edge_n[e]]
        if pts:
            path = path[1:]  # junction point already emitted
        pts.append(path)
        opts.append(np.full(len(path), g.edge_option[e], np.int32))
    path = np.concatenate(pts, axis=0)
    if with_options:
        return path, np.concatenate(opts, axis=0)
    return path


def plan_route(g: RoadGraph, origin_xy, destination_xy, pad_to: int | None = None,
               with_options: bool = False):
    """origin/destination positions -> (x, y, n_valid[, options]) arrays:
    locate both on the graph, A*, stitch, and optionally truncate or pad (by
    repeating the final point and its option) to ``pad_to`` points."""
    start = g.nearest_node(*origin_xy)
    goal = g.nearest_node(*destination_xy)
    route = astar_host(g, start, goal)
    if route is None:
        raise ValueError(f"node {goal} not reachable from {start}")
    if len(route) == 1:
        path = g.nodes_xy[route[0]][None, :]
        options = np.zeros(1, np.int32)
    else:
        path, options = stitch_route(g, route, with_options=True)
    n = len(path)
    if pad_to is not None:
        if n > pad_to:
            path = path[:pad_to]
            options = options[:pad_to]
            n = pad_to
        else:
            pad = np.repeat(path[-1:], pad_to - n, axis=0)
            path = np.concatenate([path, pad], axis=0)
            options = np.concatenate(
                [options, np.repeat(options[-1:], pad_to - n)], axis=0
            )
    if with_options:
        return path[:, 0], path[:, 1], n, options
    return path[:, 0], path[:, 1], n


def graph_tensors(g: RoadGraph, device) -> dict:
    """The graph's arrays as tensors on ``device``, made once per graph and
    device: adjacency and edge ids (N, D) int64, each row's step costs
    (N, D) float32 (+1e30 on padded slots), node positions (N, 2), edge
    polylines (E, P, 2) with the NaN padding zeroed, point counts and
    options (E,)."""
    cache = g.__dict__.setdefault("_tensors", {})
    key = str(torch.device(device))
    if key not in cache:
        f32 = dict(dtype=torch.float32, device=device)
        adj_edge = torch.as_tensor(g.adj_edge, dtype=torch.int64, device=device)
        edge_len = torch.as_tensor(g.edge_len, **f32)
        cache[key] = dict(
            adj=torch.as_tensor(g.adj, dtype=torch.int64, device=device),
            adj_edge=adj_edge,
            step_cost=torch.where(adj_edge >= 0, edge_len[adj_edge.clamp(min=0)],
                                  torch.full_like(edge_len[:1], _INF)),
            xy=torch.as_tensor(g.nodes_xy, **f32),
            edge_path=torch.nan_to_num(torch.as_tensor(g.edge_path, **f32)),
            edge_n=torch.as_tensor(g.edge_n, dtype=torch.int32, device=device),
            edge_option=torch.as_tensor(g.edge_option, dtype=torch.int32,
                                        device=device),
        )
    return cache[key]


def _first_true(mask: Tensor) -> Tensor:
    """Index of the first True along the last axis (0 where none), int64."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def astar_device(g: RoadGraph, start: Tensor, goal: Tensor):
    """Batched A* over fixed tensors: start, goal (B,) int node ids on the
    device the search runs on. Returns (parent (B, N) int32, the
    backtracking table; found (B,) bool).

    N iterations, each a pop and a relaxation for every lane at once: the
    pop is the first node attaining the least f over the open set of a lane
    that is still searching (goal not closed, open set not empty), and
    relaxes each successor whose candidate cost beats its current cost
    while it is not closed, the least candidate winning where a row's
    successors repeat a node."""
    t = graph_tensors(g, start.device)
    adj, step_cost, xy = t["adj"], t["step_cost"], t["xy"]
    n = xy.shape[0]
    B = start.shape[0]
    dev = start.device
    start = start.to(torch.int64)
    goal = goal.to(torch.int64)
    gxy = xy[goal]                                            # (B, 2)
    heur = hypot(xy[None, :, 0] - gxy[:, :1], xy[None, :, 1] - gxy[:, 1:])
    iota = torch.arange(n, device=dev)
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    g_cost = torch.where(iota[None, :] == start[:, None], 0.0, inf)
    parent = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    in_open = iota[None, :] == start[:, None]
    closed = torch.zeros((B, n), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    for _ in range(n):
        # a lane still searching has an open node of finite f, so it pops
        live = in_open.any(1) & ~closed[rows, goal]
        f = torch.where(in_open & live[:, None], g_cost + heur, inf)
        is_min = (f == f.min(1, keepdim=True).values) & in_open & live[:, None]
        c = torch.where(live, _first_true(is_min), 0)         # popped node
        pop = live[:, None] & (iota[None, :] == c[:, None])
        in_open = in_open & ~pop
        closed = closed | pop
        # a lane that popped nothing relaxes nothing: its candidates are inf
        succ = adj[c]                                         # (B, D)
        cand = torch.where(live[:, None], g_cost[rows, c][:, None] + step_cost[c], inf)
        tgt = succ.clamp(min=0)
        relax = (succ >= 0) & (cand < torch.gather(g_cost, 1, tgt)) \
            & ~torch.gather(closed, 1, tgt)
        # the scatter's extra column n takes the candidates that relax nothing
        new_cost = torch.full((B, n + 1), _INF, dtype=torch.float32, device=dev)
        new_cost.scatter_reduce_(1, torch.where(relax, tgt, n),
                                 torch.where(relax, cand, inf), "amin")
        new_cost = new_cost[:, :n]
        improved = new_cost < g_cost
        g_cost = torch.where(improved, new_cost, g_cost)
        parent = torch.where(improved, c[:, None].to(torch.int32), parent)
        in_open = in_open | improved
    return parent, closed[rows, goal]


def route_nodes_device(g: RoadGraph, start: Tensor, goal: Tensor,
                       max_route: int | None = None):
    """Batched A* and backtracking: (start, goal) (B,) -> (route (B, R) int32
    node ids ordered start to goal, valid (B, R) slot mask, reached (B,)),
    R = ``max_route`` (the node count by default)."""
    n = g.n_nodes
    if max_route is None:
        max_route = n
    parent, found = astar_device(g, start, goal)
    start = start.to(torch.int32)
    node = goal.to(torch.int64)
    rev = []
    for _ in range(max_route):
        # rev = [goal, parent(goal), ...], holding at start (parent -1)
        rev.append(node)
        nxt = torch.gather(parent, 1, node[:, None])[:, 0].to(torch.int64)
        node = torch.where(nxt >= 0, nxt, node)
    rev = torch.stack(rev, 1).to(torch.int32)                 # (B, R)
    is_start = rev == start[:, None]
    reached = found & is_start.any(1)
    length = torch.where(reached, _first_true(is_start) + 1, 0)
    slot = torch.arange(max_route, device=rev.device)
    idx = torch.clamp(length[:, None] - 1 - slot[None, :], 0, max_route - 1)
    route = torch.gather(rev, 1, idx)
    return route, slot[None, :] < length[:, None], reached


def stitch_route_device(g: RoadGraph, route: Tensor, valid: Tensor, pad_to: int):
    """Batched ``stitch_route``: node routes (B, R) with their slot masks ->
    (x, y (B, pad_to) float32, n_valid (B,) int32, options (B, pad_to)
    int32). Between two route nodes the lowest matching edge id is taken
    (parallel edges); each edge adds its points 1..n-1 at cumulative
    offsets, truncated at ``pad_to``; row 0 is point 0 of the first valid
    edge; the tail repeats the last valid point and its option. Positions
    are unique, so the scatter is exact: x and y are copies of graph
    points."""
    t = graph_tensors(g, route.device)
    adj, adj_edge = t["adj"], t["adj_edge"]
    edge_path, edge_n, edge_option = t["edge_path"], t["edge_n"], t["edge_option"]
    E, P, _ = edge_path.shape
    B, dev = route.shape[0], route.device
    a, b = route[:, :-1].to(torch.int64), route[:, 1:].to(torch.int64)
    pair_ok = valid[:, :-1] & valid[:, 1:]
    adj_a, adje_a = adj[a], adj_edge[a]                       # (B, R-1, D)
    hit = (adj_a == b[..., None]) & (adj_a >= 0)
    eid = torch.where(hit, adje_a, E).min(-1).values          # (B, R-1)
    has = pair_ok & hit.any(-1)
    found = eid < E
    e = eid.clamp(max=E - 1)
    en = torch.where(found, edge_n[e], 0)
    eopt = torch.where(found, edge_option[e], 0)
    pts = torch.where(found[..., None, None], edge_path[e], 0.0)  # (B, R-1, P, 2)

    n_pts = torch.where(has, en - 1, 0)
    csum = torch.cumsum(n_pts, 1)
    off = csum - n_pts + 1                                    # output start per edge
    n_valid = torch.clamp(1 + n_pts.sum(1), max=pad_to).to(torch.int32)
    p_idx = torch.arange(1, P, device=dev)
    pos = off[..., None] + (p_idx - 1)                        # (B, R-1, P-1)
    keep = has[..., None] & (p_idx < en[..., None]) & (pos < pad_to)
    pos = torch.where(keep, pos, pad_to).reshape(B, -1).to(torch.int64)
    xy = torch.zeros((B, pad_to + 1, 2), dtype=torch.float32, device=dev)
    xy.scatter_(1, pos[..., None].expand(-1, -1, 2), pts[:, :, 1:].reshape(B, -1, 2))
    opt = torch.zeros((B, pad_to + 1), dtype=torch.int32, device=dev)
    opt.scatter_(1, pos, eopt[..., None].expand_as(keep).reshape(B, -1))
    xy, opt = xy[:, :pad_to], opt[:, :pad_to]
    # row 0: point 0 of the first valid edge
    first = _first_true(has)[:, None]
    has_f = torch.gather(has, 1, first)[:, 0]
    pt0 = torch.gather(pts[:, :, 0], 1, first[..., None].expand(-1, -1, 2))[:, 0]
    xy[:, 0] = torch.where(has_f[:, None], pt0, 0.0)
    opt[:, 0] = torch.where(has_f, torch.gather(eopt, 1, first)[:, 0], 0)
    # the padded tail repeats the last valid point
    last = torch.clamp(n_valid.to(torch.int64) - 1, min=0)[:, None]
    in_route = torch.arange(pad_to, device=dev)[None, :] < n_valid[:, None]
    xy = torch.where(in_route[..., None], xy,
                     torch.gather(xy, 1, last[..., None].expand(-1, -1, 2)))
    opt = torch.where(in_route, opt, torch.gather(opt, 1, last))
    return xy[..., 0].contiguous(), xy[..., 1].contiguous(), n_valid, opt
