"""Road graph on padded arrays (counterpart of
``emplanner_carla_tpu/routing/graph.py``; NumPy, host side, a copy kept by
the port so that it imports nothing of the JAX package).

CARLA's topology becomes a ``RoadGraph`` of fixed-width arrays: node
positions, a padded adjacency list, and per-edge waypoint polylines
resampled at a fixed resolution (the reference walks ``waypoint.next(2 m)``
per segment). Procedural town generators stand in for
``carla.Map.get_topology``. Graph construction is per-scenario setup; the
route queries run on the host (``routing.astar.astar_host``) or batched on
the card (``routing.astar.astar_device``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class RoadOption(IntEnum):
    """Topological maneuver tag per edge (``global_planning.py:13-24``)."""

    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANE_FOLLOW = 4
    CHANGE_LANE_LEFT = 5
    CHANGE_LANE_RIGHT = 6


@dataclass
class RoadGraph:
    """Directed road graph with padded adjacency and edge polylines.

    nodes_xy:    (N, 2) node positions
    adj:         (N, max_deg) successor node ids, -1 padded
    adj_edge:    (N, max_deg) edge ids aligned with adj, -1 padded
    edge_len:    (E,) polyline length (metres)
    edge_path:   (E, P, 2) resampled waypoints incl. both endpoints,
                 NaN-padded beyond edge_n[e]
    edge_n:      (E,) valid waypoint count per edge
    edge_option: (E,) RoadOption tag
    resolution:  waypoint resample spacing the graph was built at (metres);
                 consumers converting point counts to metric route length
                 (``scenario.routed_scenarios*``) read it from here instead
                 of assuming the 2 m default
    """

    nodes_xy: np.ndarray
    adj: np.ndarray
    adj_edge: np.ndarray
    edge_len: np.ndarray
    edge_path: np.ndarray
    edge_n: np.ndarray
    edge_option: np.ndarray
    resolution: float = 2.0

    @property
    def n_nodes(self) -> int:
        return len(self.nodes_xy)

    @property
    def n_edges(self) -> int:
        return len(self.edge_len)

    def nearest_node(self, x: float, y: float) -> int:
        """Locate a query position on the graph (the array analogue of
        ``_find_location_edge``, ``global_planning.py:136-151``)."""
        d = np.hypot(self.nodes_xy[:, 0] - x, self.nodes_xy[:, 1] - y)
        return int(np.argmin(d))

    def edge_between(self, n1: int, n2: int) -> int:
        row = self.adj[n1]
        hit = np.where(row == n2)[0]
        return int(self.adj_edge[n1][hit[0]]) if len(hit) else -1


def build_graph(
    segments: list[tuple[np.ndarray, RoadOption]],
    resolution: float = 2.0,
    max_degree: int = 4,
    snap: float = 0.5,
) -> RoadGraph:
    """Assemble a RoadGraph from raw segment polylines.

    Mirrors ``_build_topology`` + ``_build_graph``
    (``global_planning.py:43-134``): each segment is resampled at
    ``resolution``; endpoints are deduplicated into nodes by snapping to a
    grid (the reference rounds coordinates to 2 decimals,
    ``global_planning.py:103-105``); edges carry their waypoint paths and
    lengths (the reference's edge cost is the waypoint count,
    ``global_planning.py:130`` — we use true metric length, the intended
    cost).
    """
    node_ids: dict[tuple[int, int], int] = {}
    nodes: list[tuple[float, float]] = []

    def node_of(p) -> int:
        key = (int(round(p[0] / snap)), int(round(p[1] / snap)))
        if key not in node_ids:
            node_ids[key] = len(nodes)
            nodes.append((float(p[0]), float(p[1])))
        return node_ids[key]

    resampled = [(_resample(path, resolution), opt) for path, opt in segments]
    max_p = max(len(p) for p, _ in resampled)

    E = len(resampled)
    edge_path = np.full((E, max_p, 2), np.nan)
    edge_n = np.zeros(E, np.int32)
    edge_len = np.zeros(E, np.float64)
    edge_option = np.full(E, int(RoadOption.LANE_FOLLOW), np.int32)
    heads = []
    tails = []
    for e, (path, opt) in enumerate(resampled):
        edge_path[e, : len(path)] = path
        edge_n[e] = len(path)
        edge_len[e] = np.sum(np.hypot(*np.diff(path, axis=0).T))
        edge_option[e] = int(opt)
        heads.append(node_of(path[0]))
        tails.append(node_of(path[-1]))

    N = len(nodes)
    adj = np.full((N, max_degree), -1, np.int32)
    adj_edge = np.full((N, max_degree), -1, np.int32)
    deg = np.zeros(N, np.int32)
    for e, (h, t) in enumerate(zip(heads, tails)):
        if deg[h] >= max_degree:
            raise ValueError(f"node {h} exceeds max_degree={max_degree}")
        adj[h, deg[h]] = t
        adj_edge[h, deg[h]] = e
        deg[h] += 1

    return RoadGraph(
        np.asarray(nodes), adj, adj_edge, edge_len, edge_path, edge_n,
        edge_option, resolution=float(resolution),
    )


def _resample(path: np.ndarray, resolution: float) -> np.ndarray:
    """Resample a polyline at fixed arc-length spacing, keeping endpoints."""
    path = np.asarray(path, np.float64)
    seg = np.hypot(*np.diff(path, axis=0).T)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    n = max(int(np.floor(total / resolution)) + 1, 2)
    sq = np.linspace(0.0, total, n)
    x = np.interp(sq, s, path[:, 0])
    y = np.interp(sq, s, path[:, 1])
    return np.stack([x, y], axis=1)


def grid_town(
    blocks: int = 3, block_size: float = 80.0, resolution: float = 2.0
) -> RoadGraph:
    """A Manhattan-grid town: bidirectional straight streets + simple
    intersection connections. The procedural stand-in for CARLA's Town05."""
    segs: list[tuple[np.ndarray, RoadOption]] = []
    n = blocks + 1
    for i in range(n):
        for j in range(n):
            x0, y0 = i * block_size, j * block_size
            if i + 1 < n:
                a = np.array([[x0, y0], [x0 + block_size, y0]])
                segs.append((a, RoadOption.LANE_FOLLOW))
                segs.append((a[::-1], RoadOption.LANE_FOLLOW))
            if j + 1 < n:
                a = np.array([[x0, y0], [x0, y0 + block_size]])
                segs.append((a, RoadOption.LANE_FOLLOW))
                segs.append((a[::-1], RoadOption.LANE_FOLLOW))
    return build_graph(segs, resolution)


def grid_town_curved(
    blocks: int = 3,
    block_size: float = 80.0,
    radius: float = 15.0,
    resolution: float = 2.0,
) -> RoadGraph:
    """A Manhattan grid with *filleted* intersections: streets are trimmed
    by ``radius`` and junctions carry explicit connector edges — straight-
    through (STRAIGHT) and quarter-arc turns (LEFT/RIGHT) — the same
    junction topology CARLA's map exposes (arc connectors between lane
    segments, ``global_planning.py:57-76`` walks them) and the structure
    that makes RoadOption tags meaningful. Max curvature 1/radius keeps
    the Frenet validity margin (|kappa| * corridor halfwidth < 1) for
    closed-loop driving through turns, unlike ``grid_town``'s sharp
    corners (kept for pure-routing tests).
    """
    segs: list[tuple[np.ndarray, RoadOption]] = []
    n = blocks + 1
    r = radius
    bs = block_size

    def street(p0, p1):
        a = np.array([p0, p1], np.float64)
        segs.append((a, RoadOption.LANE_FOLLOW))
        segs.append((a[::-1], RoadOption.LANE_FOLLOW))

    # trimmed streets between adjacent intersections
    for i in range(n):
        for j in range(n):
            x0, y0 = i * bs, j * bs
            if i + 1 < n:
                street((x0 + r, y0), (x0 + bs - r, y0))
            if j + 1 < n:
                street((x0, y0 + r), (x0, y0 + bs - r))

    # junction connectors. Incoming direction d (unit vector pointing INTO
    # the junction); the entry point is c - r*d. For each outgoing
    # direction o (pointing OUT), the exit point is c + r*o.
    dirs = {
        "E": np.array([1.0, 0.0]),
        "W": np.array([-1.0, 0.0]),
        "N": np.array([0.0, 1.0]),
        "S": np.array([0.0, -1.0]),
    }

    def cross2(a, b):
        return float(a[0] * b[1] - a[1] * b[0])

    def arc(p_in, d_in, p_out, d_out):
        """Quarter arc from p_in (heading d_in) to p_out (heading d_out)."""
        # centre is perpendicular-offset r from both endpoints
        turn_left = cross2(d_in, d_out) > 0
        normal = np.array([-d_in[1], d_in[0]]) * (1.0 if turn_left else -1.0)
        centre = p_in + r * normal
        a0 = np.arctan2(*(p_in - centre)[::-1])
        a1 = np.arctan2(*(p_out - centre)[::-1])
        if turn_left:
            while a1 <= a0:
                a1 += 2 * np.pi
        else:
            while a1 >= a0:
                a1 -= 2 * np.pi
        t = np.linspace(a0, a1, 16)
        return np.stack(
            [centre[0] + r * np.cos(t), centre[1] + r * np.sin(t)], axis=1
        )

    for i in range(n):
        for j in range(n):
            c = np.array([i * bs, j * bs])
            exists = {
                "E": i + 1 < n, "W": i > 0, "N": j + 1 < n, "S": j > 0,
            }
            for d_name, d in dirs.items():
                # traffic arriving while travelling in direction d enters
                # the junction from the side -d; that street exists iff the
                # opposite-name street exists
                opp = {"E": "W", "W": "E", "N": "S", "S": "N"}[d_name]
                if not exists[opp]:
                    continue
                p_in = c - r * d
                for o_name, o in dirs.items():
                    if o_name == opp or not exists[o_name]:
                        continue  # no U-turns; must have an exit street
                    p_out = c + r * o
                    if o_name == d_name:
                        seg = np.array([p_in, p_out])
                        opt = RoadOption.STRAIGHT
                    else:
                        seg = arc(p_in, d, p_out, o)
                        opt = (
                            RoadOption.LEFT
                            if cross2(d, o) > 0
                            else RoadOption.RIGHT
                        )
                    segs.append((seg, opt))
    return build_graph(segs, resolution, max_degree=6)


def multilane_highway(
    n_lanes: int = 3,
    lane_width: float = 3.5,
    length: float = 400.0,
    seg_len: float = 50.0,
    resolution: float = 2.0,
) -> RoadGraph:
    """A one-way multi-lane highway with lane-change links.

    The reference's upstream ``GlobalRoutePlanner`` models lane changes as
    explicit graph edges between laterally adjacent waypoints, tagged
    CHANGELANELEFT/RIGHT
    (``agents/navigation/global_route_planner.py:185-229``);
    the author's simplified L2 dropped them. This generator restores the
    capability: each lane is a chain of ``seg_len`` segments (LANE_FOLLOW),
    and every interior node also connects to the next station of each
    adjacent lane via a smoothstep diagonal ramp (CHANGE_LANE_LEFT toward
    +y, CHANGE_LANE_RIGHT toward -y; heading is +x, so +y is the left-hand
    side). The ramp's true metric length exceeds ``seg_len``, which acts as
    the natural lane-change penalty in A* — routes change lanes only when
    the origin/destination demand it.

    Lane ``k`` sits at y = k * lane_width; stations at x = i * seg_len.
    """
    if seg_len <= 2.0 * lane_width:
        raise ValueError("seg_len must comfortably exceed lane_width")
    segs: list[tuple[np.ndarray, RoadOption]] = []
    n_seg = max(int(round(length / seg_len)), 1)
    n_ramp = max(int(np.ceil(seg_len / resolution)) + 1, 8)
    t = np.linspace(0.0, 1.0, n_ramp)
    smooth = t * t * (3.0 - 2.0 * t)  # C1 lateral blend for the ramp

    for lane in range(n_lanes):
        y0 = lane * lane_width
        for i in range(n_seg):
            x0 = i * seg_len
            a = np.array([[x0, y0], [x0 + seg_len, y0]])
            segs.append((a, RoadOption.LANE_FOLLOW))
            for dlane, opt in (
                (+1, RoadOption.CHANGE_LANE_LEFT),
                (-1, RoadOption.CHANGE_LANE_RIGHT),
            ):
                if not 0 <= lane + dlane < n_lanes:
                    continue
                ramp = np.stack(
                    [x0 + t * seg_len, y0 + dlane * lane_width * smooth],
                    axis=1,
                )
                segs.append((ramp, opt))
    return build_graph(segs, resolution, max_degree=4)


# --- Recorded test_9 fixture (Town05 sub-network) -------------------------
#
# The reference pins its headline scenario to CARLA Town05: ego spawn 259,
# destination spawn 48, three parked cars and one BehaviorAgent NPC at
# hard-coded world coordinates (test_9.py:242,259-291).
# The spawn-point coordinates live inside CARLA's map binary, but every
# obstacle pose and the NPC spawn are pinned in the code itself; this
# fixture records the sub-network of Town05 those coordinates imply so at
# least one parity claim is *scenario-identical* (pinned world coordinates)
# rather than distribution-level: a north-bound spawn road through the NPC
# spawn (192.31, 10) (placed at the ego's own rotation, i.e. ON the ego's
# road, test_9.py:284-288), a junction turn exiting at parked car 1
# (174.01, 147.61, yaw 30 deg — askew at the junction exit), a connecting
# road, and the destination road through parked cars 2/3
# (105.86, 189.11/194.11, yaw 90 -> road heading +y, test_9.py:259-281).

TEST9_EGO_SPAWN = (192.31, -20.0)        # spawn-259 stand-in, heading +y
TEST9_DESTINATION = (105.86, 235.0)      # spawn-48 stand-in
TEST9_STATICS = (                        # (x, y, yaw_deg), test_9.py:262-281
    (174.01, 147.61, 30.0),
    (105.86, 189.11, 90.0),
    (105.86, 194.11, 90.0),
)
TEST9_NPC = (192.31, 10.0, 30.0 / 3.6)   # (x, y, speed m/s), test_9.py:284-291


def town05_test9(resolution: float = 2.0) -> RoadGraph:
    """The recorded Town05 sub-network around the test_9 route.

    Two routes connect the spawn to the destination — the main route
    (spawn road -> left junction arc exiting at parked car 1 -> west
    connector -> right arc -> destination road past parked cars 2/3,
    ~328 m) and a longer decoy (straight north, then west, ~341 m) — so
    A* exercises a real choice on the recorded geometry.
    """
    segs: list[tuple[np.ndarray, RoadOption]] = []
    xa = TEST9_EGO_SPAWN[0]              # spawn road column, 192.31
    xe = TEST9_STATICS[1][0]             # destination road column, 105.86
    yc = TEST9_STATICS[0][1]             # west connector row, 147.61
    y_dest = TEST9_DESTINATION[1]

    def arc(centre, r, a0, a1, n=16):
        t = np.linspace(a0, a1, n)
        return np.stack(
            [centre[0] + r * np.cos(t), centre[1] + r * np.sin(t)], axis=1
        )

    # spawn road A: through the NPC spawn, up to the junction entry
    r1 = 18.0
    y_j1 = yc - r1                       # 129.61
    segs.append((np.array([[xa, TEST9_EGO_SPAWN[1]], [xa, y_j1]]),
                 RoadOption.LANE_FOLLOW))
    # J1 left quarter-arc: heading +y -> heading -x; exits 0.3 m east of
    # parked car 1 (the car blocks the junction exit lane)
    segs.append((arc((xa - r1, y_j1), r1, 0.0, 0.5 * np.pi),
                 RoadOption.LEFT))
    # west connector C along y = 147.61
    x_j2 = xe + 14.0                     # 119.86
    segs.append((np.array([[xa - r1, yc], [x_j2, yc]]),
                 RoadOption.LANE_FOLLOW))
    # J2 right quarter-arc: heading -x -> heading +y
    segs.append((arc((x_j2, yc + 14.0), 14.0, -0.5 * np.pi, -np.pi),
                 RoadOption.RIGHT))
    # destination road E through parked cars 2/3
    segs.append((np.array([[xe, yc + 14.0], [xe, y_dest]]),
                 RoadOption.LANE_FOLLOW))

    # decoy branch: straight through J1 northbound, then west to the
    # destination (longer; A* must reject it)
    segs.append((np.array([[xa, y_j1], [xa, y_dest]]), RoadOption.STRAIGHT))
    segs.append((np.array([[xa, y_dest], [xe, y_dest]]),
                 RoadOption.LANE_FOLLOW))
    return build_graph(segs, resolution)


def ring_town(
    radius: float = 120.0, n_spokes: int = 4, resolution: float = 2.0
) -> RoadGraph:
    """A ring road with spokes — exercises curved edges and merges."""
    segs: list[tuple[np.ndarray, RoadOption]] = []
    n_arc = n_spokes
    ang = np.linspace(0, 2 * np.pi, n_arc, endpoint=False)
    for k in range(n_arc):
        a0, a1 = ang[k], ang[(k + 1) % n_arc]
        if a1 <= a0:
            a1 += 2 * np.pi
        t = np.linspace(a0, a1, 40)
        arc = np.stack([radius * np.cos(t), radius * np.sin(t)], axis=1)
        segs.append((arc, RoadOption.LANE_FOLLOW))
        spoke = np.stack(
            [
                np.linspace(0.3 * radius, radius, 20) * np.cos(a0),
                np.linspace(0.3 * radius, radius, 20) * np.sin(a0),
            ],
            axis=1,
        )
        segs.append((spoke, RoadOption.STRAIGHT))
        segs.append((spoke[::-1], RoadOption.STRAIGHT))
    return build_graph(segs, resolution)
