"""PyTorch/CUDA port of emplanner_carla_tpu: the path-planning closed loop
(``sim.closed_loop.simulate``), the full EM loop (``simulate_full``) with
every control and plant variant and traffic lights, the agent-traffic loop
(``simulate_traffic``, NPC agents from ``sim.npc``), the open-loop
planning entries with their cold QPs, routing (``routing.graph``, the host
and batched device A* of ``routing.astar``) with routed fleets and the
test_9 scenario (``sim.scenario``), and the loop driven by pixels
(``sim.pixel_loop.simulate_pixels`` on ``sim.camera`` and ``sim.detector``;
``sim.sensors``), fleets split over ``torch.distributed`` ranks
(``parallel.fleet``), checkpoint and resume, tracing and run reports
(``utils.checkpoint``, ``utils.profiling``, ``utils.report``).

The package mirrors the JAX package's module paths and function names
(``ops/``, ``planner/``, ``control/``, ``routing/``, ``sim/``,
``parallel/``, ``utils/``) on batch-first tensors; of the JAX package it
leaves out only the TPU's ``*_pallas.py`` kernels (their counterparts are
the CUDA kernels) and the float64 ``oracle/``, which the tests import. It
imports ``torch`` and NumPy, never JAX and nothing of the JAX package. Its
entry points (``sim.closed_loop.simulate`` / ``simulate_full`` /
``simulate_traffic``, ``sim.pixel_loop.simulate_pixels``,
``sim.scenario.batch_scenarios`` / ``make_scenario`` / ``routed_scenarios``
/ ``routed_scenarios_device`` / ``test9_scenario``, ``parallel.fleet``,
``utils.checkpoint.resume_simulation``) run on the card unless the caller
passes ``device="cpu"`` (the fleet: ``make_mesh("cpu")``).

Precision: float32 throughout, TF32 off; the solver sites check it
(``precision.require_fp32_matmul``). The hand-written CUDA kernels under
``csrc/`` are built with ``nvcc`` at first use (``cuda.py``).
"""
