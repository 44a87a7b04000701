"""Typed configuration tree of the PyTorch port.

A copy of the JAX package's ``emplanner_carla_tpu/config.py``: the same
frozen dataclasses with identical field names and defaults, so that
``dataclasses.asdict`` of one builds the other (``convert.config_from_dict``).
The port keeps its own copy because it imports nothing from the JAX package.
Defaults mirror the reference's literals, each field citing its source
``file:line`` in the reference implementation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _tuple(*xs):
    return dataclasses.field(default_factory=lambda: tuple(xs))


@dataclass(frozen=True)
class RefLineConfig:
    """Local reference-line sampling + QP smoothing.

    Sources: sampling window ``planning_utils.py:231-259`` (back 10 /
    forward 40 + 1 = 51 points, hardcoded — quirk Q9); smoother weights and
    box bounds ``planning_utils.py:262-264``.
    """

    n_points: int = 51          # back + forward + 1
    back_length: int = 10
    forward_length: int = 40
    w_smooth: float = 0.4
    w_length: float = 0.3
    w_ref: float = 0.3
    xy_bound: float = 0.2       # +- box around the raw polyline, metres
    # box-QP solve = one direct unconstrained matmul + this many warm,
    # over-relaxed ADMM polish iterations for box-binding points
    # (reference_line.smooth_xy; accuracy sweep in its docstring)
    admm_iters: int = 12
    admm_rho: float = 3.0


@dataclass(frozen=True)
class PathPlanConfig:
    """S-L path planning: DP grid + convex corridor + piecewise-jerk QP.

    Sources: DP grid & weights ``path_planning.py:276-279`` (row=12, col=6,
    sample_s=15, sample_l=1.5, w_collision=1e12, w_smooth=[300,1000,5000],
    w_ref=20); keep-right penalty ``path_planning.py:317,341-342``; obstacle
    cost bands ``path_planning.py:588-609`` (danger 4 m, safe 6 m, 5000/d^2);
    corridor ``path_planning.py:222-273`` (base +-10, index offset 2);
    QP weights ``path_planning.py:78-81`` and vehicle geometry d1=d2=3, w=3
    ``path_planning.py:81``.
    """

    # DP grid
    rows: int = 12
    cols: int = 6
    sample_s: float = 15.0
    sample_l: float = 1.5
    n_edge_samples: int = 10    # samples per quintic edge, path_planning.py:492
    w_collision: float = 1e12
    w_dl: float = 300.0
    w_ddl: float = 1000.0
    w_dddl: float = 5000.0
    w_ref: float = 20.0
    keep_right_penalty: float = 10000.0
    danger_dist: float = 4.0
    safe_dist: float = 6.0
    danger_cost_num: float = 5000.0  # cost = 5000 / d^2 in the danger band
    # densify resolution on the quintic edges, path_planning.py:278 (=2 m)
    sampling_res: float = 2.0
    # corridor
    corridor_halfwidth: float = 10.0
    corridor_index_offset: int = 2
    obs_length: float = 5.0     # test_9.py:192
    obs_width: float = 5.0
    # QP (piecewise jerk), path_planning.py:79-81
    w_qp_l: float = 1000.0
    w_qp_dl: float = 10000.0
    w_qp_ddl: float = 3000.0
    w_qp_dddl: float = 150.0
    w_qp_centre: float = 250.0
    w_qp_end_l: float = 40.0
    w_qp_end_dl: float = 40.0
    w_qp_end_ddl: float = 40.0
    host_d1: float = 3.0
    host_d2: float = 3.0
    host_w: float = 3.0
    # quadratic penalty on the per-station corridor slack (soft constraints;
    # the reference's hard corridor goes infeasible mid-avoidance)
    w_slack: float = 1e4
    # DP path is downsampled ::2 before the QP (test_9.py:187-188): with
    # cols*sample_s = 90 m enriched at 2 m this yields n_qp stations.
    qp_downsample: int = 2
    admm_iters: int = 120
    admm_rho: float = 1.0
    admm_sigma: float = 1e-6
    # total warm-start ADMM iterations (split over the 3 rho phases) when
    # warm-started from the previous cycle's carried state (closed loops
    # only; cold solves use the admm_iters ladder). 45 passes the
    # float64-oracle fidelity suite; 30 and below start costing mean speed
    # (under-converged path QP).
    warm_admm_iters: int = 45
    # dot implementation of the JAX package's fused warm-QP kernel. Kept
    # for config compatibility (convert.config_from_dict); the port's
    # warm-QP kernel always runs its dots in float32 FMA.
    warm_kernel_matmul: str = "bf16x3"
    # obstacle slots kept for the DP's distance tensors (linear in
    # slots). Slots outside the DP's s
    # window [s0 - safe_dist, s0 + cols*sample_s + safe_dist] contribute
    # exactly zero cost and are pruned first (exact); of the remainder the
    # nearest-|s - s0| dp_top_m are kept. With <= dp_top_m relevant
    # obstacles (every bench/fidelity scenario: <= 3 gated statics + 4
    # virtual points) the DP is bit-identical to the uncompressed one;
    # beyond that, drops are surfaced through PathPlanResult.obs_dropped
    # -> TickMetrics.segments_dropped (same observability contract as
    # st_top_m). Raise to n_static_obs + 4 + n_dynamic_obs to disable.
    dp_top_m: int = 8

    @property
    def n_enriched(self) -> int:
        """Number of densified DP samples (uniform grid, see path_dp.py)."""
        return int(self.cols * self.sample_s / self.sampling_res) + 1  # 46

    @property
    def n_qp(self) -> int:
        n = self.n_enriched
        return (n + self.qp_downsample - 1) // self.qp_downsample  # 23


@dataclass(frozen=True)
class SpeedPlanConfig:
    """S-T speed planning: ST graph + DP + convex space + QP + densify.

    Sources: ST gating ``speed_planning_test.py:38-98`` (|l_dot|>=0.3,
    |l|<=2 band, t window [1, 8]); DP grids ``speed_planning_test.py:114-117``
    (40 non-uniform s x 16 uniform t); DP weights ``speed_planning_test.py:102``
    (ref 4000, accel 100, obs 1e7) and accel box (-6, 4)
    ``speed_planning_test.py:222``; convex space ``speed_planning_test.py:308``
    (a_lat_max = 0.2*9.8); QP weights ``speed_planning_test.py:404``
    (s_dot2 10, v_ref 50, jerk 500); densify to 401 points
    ``speed_planning_test.py:542``.
    """

    n_s: int = 40
    n_t: int = 16
    t_step: float = 0.5
    horizon: float = 8.0
    reference_speed: float = 50.0 / 3.6  # reference uses km/h magnitude on a
    # m/s axis (speed_planning_test.py:102 passes 50 with s in metres); we use
    # proper m/s. Set to 50/3.6 to mean "50 km/h".
    w_ref_speed: float = 4000.0
    w_accel: float = 100.0
    w_obs: float = 1e7
    accel_max: float = 4.0
    accel_min: float = -6.0
    accel_penalty: float = 1e5
    n_edge_samples: int = 5     # speed_planning_test.py:246
    obs_collision_dist: float = 0.5
    obs_danger_dist: float = 1.5
    lateral_gate: float = 2.0   # |l| band for the ST graph
    l_dot_gate: float = 0.3
    t_min_gate: float = 1.0
    t_max_gate: float = 8.0
    max_lateral_accel: float = 0.2 * 9.8
    # QP
    w_qp_s_dot2: float = 10.0
    w_qp_v_ref: float = 50.0
    w_qp_jerk: float = 500.0
    n_dense: int = 401
    admm_iters: int = 120
    admm_rho: float = 1.0
    # per-phase warm-start iterations. Unlike the path QP, 60 here fails
    # the float64-oracle fidelity bar (longitudinal divergence >1 m on the
    # full-EM NPC regressions): the speed QP needs the full 120 to match
    # scipy-exact solves (90 re-measured failing the re-anchored per-cycle
    # certification in round 4 — 1.4 m divergence by cycle 14).
    warm_admm_iters: int = 120
    # fused warm-QP kernel dots (see PathPlanConfig.warm_kernel_matmul)
    warm_kernel_matmul: str = "bf16x3"
    # ST segments kept per cycle (valid-first, earliest t_in): the DP's
    # obstacle-distance tensor is the full-EM cycle's largest term and
    # scales linearly in segments; the reference never handles more than
    # one crossing obstacle at a time (test_9.py spawns one NPC). Raise to
    # n_dynamic_obs to disable compression.
    st_top_m: int = 2
    # (a "grid" obstacle-cost mode — bilinear interpolation of a
    # precomputed (S, T) cost field — was no faster than the
    # fused exact distances at K=8 while flipping DP decisions in 2/6
    # regression regimes, and was removed in round 2; exact per-sample
    # distances are the only mode)

    @property
    def s_grid(self) -> tuple:
        """Non-uniform s sampling, speed_planning_test.py:114."""
        import numpy as np

        s = np.concatenate(
            (
                np.arange(0, 5, 0.5),
                np.arange(5.5, 15, 1.0),
                np.arange(16, 30, 1.5),
                np.arange(32, 55, 2.5),
            )
        )
        assert len(s) == self.n_s
        return tuple(float(v) for v in s)


@dataclass(frozen=True)
class VehicleParams:
    """Dynamic bicycle parameters.

    The reference passes ``(1.015, 2.910-1.015, 1412, -148970, -82204, 1537)``
    (``test_9.py:316``) but the controllers unpack ``(a, b, Cf, Cr, m, Iz)``
    (``controller.py:131``) — quirk Q7 (mass/stiffness swap). We use the
    intended ordering: a, b front/rear axle-to-CG distances; Cf, Cr cornering
    stiffnesses (negative, per the lecture-series convention); m mass; Iz yaw
    inertia.
    """

    a: float = 1.015
    b: float = 2.910 - 1.015
    cf: float = -148970.0
    cr: float = -82204.0
    mass: float = 1412.0
    iz: float = 1537.0
    # plant-only extras (CARLA's UE4 plant is not reproducible — SURVEY §7.3;
    # these define our ground truth)
    max_steer_rad: float = 0.6109  # 35 deg: full steer command = 1.0
    max_accel: float = 4.0         # throttle=1 -> +4 m/s^2
    max_brake_decel: float = 8.0   # brake=1 -> -8 m/s^2
    # steering actuator (CARLA's UE4 vehicle applies steering with lag; an
    # ideal zero-lag actuator makes the reference's 100 Hz LQR/MPC loop
    # oscillate at the Nyquist rate — observed empirically on the arc test)
    steer_tau: float = 0.05        # first-order lag time constant (s)
    steer_rate: float = 4.0        # max |d steer/dt| in normalized units/s


@dataclass(frozen=True)
class ControlConfig:
    """LQR / MPC / PID gains.

    Sources: LQR Q=diag(200,1,50,1), R=1, Riccati tol 0.1 / max 5000
    ``controller.py:457-482,594-599``; MPC N=6, P=2, Q=diag(250,1,50,1), F=I,
    R=1 ``controller.py:72-73,322-328``; PID K_P=1.15, K_I=0, K_D=0, dt=0.01,
    60-deep buffer, integral-separation threshold 1 km/h
    ``controller.py:622-638``; discretization ts=0.1 ``controller.py:160,470``;
    prediction ts=0.1 ``controller.py:331``; steer clamp +-1
    ``controller.py:705-710``.
    """

    kind: str = "LQR"           # "LQR" | "MPC"
    # LQR
    lqr_q: tuple = _tuple(200.0, 1.0, 50.0, 1.0)
    lqr_r: float = 1.0
    riccati_iters: int = 80     # fixed trip count replacing tol-0.1/5000 loop
    # MPC
    mpc_q: tuple = _tuple(250.0, 1.0, 50.0, 1.0)
    mpc_f: tuple = _tuple(1.0, 1.0, 1.0, 1.0)
    mpc_r: float = 1.0
    mpc_n: int = 6              # prediction horizon
    mpc_p: int = 2              # control horizon
    mpc_admm_iters: int = 40
    # per-tick iterations when the box ADMM is warm-started from the
    # previous tick's (z, u_d) (carried in ControllerState.mpc, reset each
    # replan like the reference's fresh controller). The unconstrained
    # fast path u* = -inv(2H) f is exact whenever |u*|inf <= 1 (the common
    # tracking regime), so the ADMM only has to polish saturated ticks —
    # 10 warm iterations match the cold 40-iteration solve on the
    # closed-loop fidelity bar (tests/test_fidelity.py) while cutting the
    # MPC tick's serial depth 4x.
    mpc_warm_admm_iters: int = 10
    # shared lateral
    ts_discretize: float = 0.1
    ts_predict: float = 0.1
    min_vx: float = 0.005       # Vx singularity guard, controller.py:103-109
    # (the reference's 50-point windowed match search, controller.py:198, is
    # a CPU-latency trick; the TPU rebuild does a full branch-free argmin —
    # see lateral.tracking_error)
    # PID
    kp: float = 1.15
    ki: float = 0.0
    kd: float = 0.0
    pid_dt: float = 0.01
    pid_buffer: int = 60
    integral_sep_threshold: float = 1.0  # km/h
    steer_limit: float = 1.0
    # Heading-error convention: the main controllers use sin(phi - theta_r)
    # against angle multivaluedness (``controller.py:555,892`` — the
    # commented alternative); the experimental
    # Lateral_MPC__with_feedforward_controller keeps the raw difference
    # ``e_fi = fi - theta_r`` (``controller.py:891``). True reproduces the
    # variant's raw error; the tick kernel takes it as a parameter.
    raw_heading_error: bool = False


def mpc_feedforward_variant(base: "ControlConfig" = None) -> "ControlConfig":
    """The reference's experimental ``Lateral_MPC__with_feedforward_controller``
    (``controller.py:727-990``): N=4, P=2, Q=diag(200,1,1,1), F=10I, and the
    un-approximated heading error ``e_fi = fi - theta_r``
    (``controller.py:891`` — the main path sin()s it, :555). Its other
    structural difference from the main MPC — the affine Cc feedforward term
    in the cost — is already part of control/lateral.mpc_steer."""
    base = base or ControlConfig()
    return dataclasses.replace(
        base, kind="MPC", mpc_n=4,
        mpc_q=(200.0, 1.0, 1.0, 1.0), mpc_f=(10.0, 10.0, 10.0, 10.0),
        raw_heading_error=True,
    )


@dataclass(frozen=True)
class PlantConfig:
    """Simulated plant replacing CARLA (SURVEY §2.4).

    Reference operating points: sync tick 0.05 s (20 Hz)
    ``simulation_2.py:357``; the closed-loop drivers run CARLA async with a
    100:1 control:plan ratio ``test_9.py:333``. We default to a 0.01 s control
    tick x 100 = 1 s replan period scaled to the same ratio.
    """

    kind: str = "kinematic"     # "kinematic" | "dynamic"
    dt: float = 0.01            # control/plant tick
    substeps: int = 1


@dataclass(frozen=True)
class LoopConfig:
    """Closed-loop pacing (test_9.py:333-335)."""

    plan_every: int = 100       # control ticks per replan, plan_count=100
    n_plans: int = 20           # outer scan length
    pred_ts: float = 0.2        # plan-start prediction horizon, test_9.py:335
    target_speed_kmh: float = 50.0  # test_9.py:327
    arrival_dist: float = 2.0   # emergency-brake radius, test_9.py:441
    perception_range: float = 50.0  # test_9.py:377
    lateral_gate: float = 5.0   # get_actor_from_world |l| gate, test_9.py:77
    behind_gate: float = -10.0  # longitudinal gate, test_9.py:78
    dynamic_speed_gate: float = 1.0  # speed > 1 m/s => dynamic, test_9.py:81


@dataclass(frozen=True)
class EMConfig:
    """Top-level bundle."""

    refline: RefLineConfig = RefLineConfig()
    path: PathPlanConfig = PathPlanConfig()
    speed: SpeedPlanConfig = SpeedPlanConfig()
    vehicle: VehicleParams = VehicleParams()
    control: ControlConfig = ControlConfig()
    plant: PlantConfig = PlantConfig()
    loop: LoopConfig = LoopConfig()
    n_static_obs: int = 8       # fixed obstacle slots (masked)
    n_dynamic_obs: int = 4
