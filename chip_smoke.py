#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``exaadmm_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--solve]

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or /usr/local/cuda) and
``nvidia-smi``; imports neither jax nor ``exaadmm_tpu``. It builds the nine
CUDA sources of the main paths from ``exaadmm_tpu_torch/csrc`` (one nvcc
process per source, all at once) and runs, in order:

0. the card's name and power limit, and the kernels' build (seconds and the
   ``-Xptxas -v`` report); the CUDA driver's version, which must have
   conditional graph nodes (12.4 or later), and torch's
   ``CUDAGraph(keep_graph=True)`` and ``raw_cuda_graph`` (the fused
   drivers raise without them);
1. the bus-scatter kernel against its plain version (``index_add_``) on the
   synthetic 9241-bus grid, fp64 and fp32: max relative difference per
   channel (difference over the channel's largest magnitude) <= 1e-13 in
   fp64 and <= 1e-6 in fp32, two kernel runs bit-identical; the device
   time per launch of both (the host queues every rep before the device
   starts, ``utils/timing.py``) beside their host enqueue time per call and
   the kernel's bound (``ops/bounds.py``);
1d. the same scatter at the shapes phase 9b's two ranks give it: each
   rank's arc values over its ``local_grid`` CSR (its half of the lines
   against all 9,241 buses, some of them with no local arc), fp64 and fp32,
   with phase 1's thresholds;
1b. the same scatter over 8 periods folded into the channel axis (the
   multi-period bus update, synthetic 2869 buses), on the arc values and on
   the generator values with the ramp terms blended in: bit-identical to 8
   single-period kernel calls, and within phase 1's thresholds of
   ``index_add_``;
1c. the MPEC bus update's three scatters on phase 7's model (arc sums,
   generator sums with vg's two channels, storage sums over the bus ->
   storage CSR), fp64, with phase 1's thresholds;
2. the branch TRON/ALM kernel against its plain version on that grid's
   15,710-line batch at the first inner iteration, prox targets perturbed
   from a numpy seed, both at step_cap 50: iteration counts equal on
   >= 99.5 % of lanes and |dx| <= 1e-8 on those lanes in fp64; >= 95 %,
   1e-3 on the agreeing lanes and 5e-3 on all lanes in fp32 (two compilers'
   fp32 rounding may flip a TRON branch decision on a few lanes); then the
   same on the multi-period path's branch batch, the 39,016 lines of
   synthetic 2869 buses tiled over 8 periods. Each TRON line gives the
   lanes that differ, those whose x is not bit-identical, max |dx|, the mean,
   p99 and max minor iterations, the kernel's device time, the us per step
   of the slowest lane (device time over the max minor iterations), its
   host enqueue time and its bound;
2e. the branch TRON/ALM kernel at the shapes phase 9b's two ranks give
   it: phase 2's batch cut to each rank's 7,855-lane window
   (``local_model``, ``local_solution``), with phase 2's thresholds;
2b. the ramp TRON/ALM kernel against its plain version on the 3,010-lane
   ramp batch of synthetic 2869 buses over 8 periods, at the first inner
   iteration, generator prox targets perturbed from a numpy seed, step_cap
   50, with phase 2's thresholds;
2c. the QP-subproblem TRON/ALM kernel against its plain version on the
   15,710-lane batch of the synthetic 9241-bus QP (linearized at the case's
   own operating point) at the first iteration, from ``init_solution`` and
   ``one_level_reset``, l and v of the lines perturbed by N(0, 0.05) from a
   numpy seed, step_cap 50, with phase 2's thresholds; then the same without
   line limits;
2d. the polar TRON kernel (the branch without line limits, no
   constraints) against its plain version on phase 2's grid and setup;
2f. the branch update's pack, unpack and stats kernels
   (``csrc/branch_io.cu``) against their plain versions, every output bit
   for bit and each kernel twice, on phase 2's state with u and the ALM
   state drawn from a numpy seed (line limits and polar; fp64, fp32 and
   mixed precision; inner iteration 1 as an int and 3 as a 0-d tensor),
   the 39,016-lane batch of synthetic 2869 x 8 periods, a random line
   order with inactive lanes, and each of 2e's rank windows; each kernel's
   device ms, enqueue ms and bound, the plain versions' device ms, the
   pack and unpack together eager and in a graph, plain and kernels, and
   ``branch_update`` captured whole: exactly 4 kernel nodes (the pack,
   the TRON kernel, the unpack, the stats);
3. case9 end to end through ``solve_acopf(..., device="cuda")``, fp64:
   Solved, objective and dispatch in the known bands, outer/cumul beside the
   pins 25/1087 (within 1 outer and 2 %), one TRON launch per inner
   iteration;
3b. case9 over 3 periods, no warm start, through
   ``solve_mpacopf(..., device="cuda")``, fp64: Solved, outer/cumul within
   1 outer and 2 % of the pins 20/1007, objective within 1e-6 relative of
   16015.6958770167, ramp violation <= 1e-3, one ramp and one branch launch
   per inner iteration; and a one-period run of the same entry point, which
   has no ramp batch and must launch no ramp kernel;
3c. the case9 QP (linearized at the base point of
   ``tests/qpsub_fixture.py``) through ``solve_qpsub(..., device="cuda")``,
   fp64, rho (4e3, 4e3), scale 1e-4, outer_eps 2e-6: Solved, outer and
   cumul within 2 % of the pin 5107, objective within 1e-6 relative of
   -21.92744641968529, the SQP outputs' shapes and signs, one QP-subproblem
   TRON launch and two bus launches per iteration;
3d. case9 without line limits through ``solve_acopf(..., use_linelimit=
   False)``: Solved within 1 outer and 2 % of the pins 20/973, one polar
   launch and no branch launch per inner iteration;
3e. case9 MPEC through ``solve_acopf_mpec``, without storage and with
   storage at 30 % of the buses: Solved within 1 outer and 2 % of the pins
   23/1401 and 12/1073, objective within 1e-6 relative, one branch launch
   and two (three with storage) bus launches per inner iteration;
3f. case9 rolling horizon, periods 1-3, through ``solve_acopf_rolling``:
   every period Solved within 1 outer and 2 % of its pin; then case9 with
   ``use_projection=True``: power-flow residual <= 1e-6 and every line copy
   of a bus's w equal;
3g. case118 end to end through ``solve_acopf`` at the reference's settings
   (rho (4e2, 4e4), outer_eps 2e-5): Solved within 1 outer and 2 % cumul of
   the port's own CPU result 20 / 1281, objective within 1e-6 relative of
   129638.3553876704 and within 1e-4 of the reference's 129645.676;
3h. checkpoint on the card: case9, 5 outer iterations, ``save_solution``,
   ``load_solution`` into a fresh ``init_solution`` on the card with every
   leaf bit-equal, then a resume with the saved beta to Solved, the
   objective in 5296-5304.5;
4h. the ACOPF hook kernels (``csrc/acopf_hooks.cu``: generator; bus
   values, per-bus solve, writeback; z, l, lz; the residual's two passes)
   against their plain versions on phase 4's model after 3 inner
   iterations, fp64 (z in fp32 too, and with beta by value): every
   elementwise output bit-identical to the plain version and to a rerun;
   the residual's block sums and scalars bit-identical to the torch
   reproduction of the kernels' fixed tree and to a rerun, and within
   1e-13 of the terms' magnitudes (1e-12 relative on the square roots) of
   ``torch.sum``'s; each kernel's device ms per launch beside its plain
   version's and its bound, each hook's plain and kernel forms eager and
   captured as a graph, and an empty kernel's device ms (the launch
   floor);
4. the single-period main path at full size: synthetic 9241 buses, fp64,
   flat start at rho (3e3, 3e5), 3 outer iterations of at most 100 inner
   (each outer ends when primres reaches its eps, about 20 inner): inner
   iterations per second of the ADMM loop (``info.time_overall``, after the
   model is built) and of the whole call, the final mismatch and the peak
   device memory; each hook kernel launched once an inner iteration and
   ``acopf_lz`` once an outer round, plus the warm-up's pass (so in every
   single-period ACOPF solve below);
5. the multi-period main path at full width: synthetic 2869 buses (4,877
   lines, 430 generators), 8 periods of the load profile
   ``synthetic_load_profile``, fp64, flat start at rho (4e2, 4e4), 3 outer
   iterations of at most 50 inner with outer_eps 0: the same rates as phase 4, the
   final mismatch, the ramp violation and the peak device memory; each
   multi-period hook kernel (``csrc/mpacopf_hooks.cu``) launched once an
   inner iteration and ``mp_lz`` once an outer round, plus the warm-up's
   pass, and none of the plain hooks called (so in 3b too, whose
   one-period run launches no ramp pack);
5h. (run after phase 5) the multi-period hook kernels (ramp pack;
   generator and ramp unpack; bus values, per-bus solve, writeback; z, l,
   lz; the residual's two passes) against their plain versions, each
   twice, on 7 batches: phase 5's model after 3 inner iterations with the
   generator rows and the ramp's u and s perturbed from a numpy seed so
   the clamps bind (fp64 with inner_iter a 0-d tensor and an int, and
   fp32), case9 x 3 periods, case9 x 1 period, and each of two rank
   windows of phase 5's model padded to an even line count: every
   elementwise output bit-identical to the plain version and to a rerun;
   the residual's block sums and scalars bit-identical to the torch
   reproduction of the kernels' per-period tree and to a rerun, and (fp64)
   within 1e-13 of the terms' magnitudes (1e-13 relative on the square
   roots) of ``torch.sum``'s; each kernel's device ms per launch beside
   its plain version's and its bound, each hook's plain and kernel forms
   eager and captured as a graph, and an empty kernel's device ms;
6. the one-level QP-subproblem path at full width: the synthetic 9241-bus
   QP of phase 2c through ``solve_qpsub``, fp64, rho (4e3, 4e3),
   tron_step_cap 24, outer_eps 0, 200 iterations: iterations per second of
   the ADMM loop and of the whole call, the final mismatch, the peak device
   memory and the launch counts;
7. the MPEC path at full width: synthetic 9241 buses with storage at a
   tenth of the buses (925 units, charge limit 0.1), droop 0.04, fp64, rho
   (3e3, 3e5), 10 outer iterations of at most 100 inner, outer_eps 0:
   phase 4's rates and figures;
8. phase 4's configuration without line limits (the polar kernel), over
   10 outer iterations like phase 7: the same report;
9a. the lines-split-across-ranks path (``parallel/``) at world size 1 over
   NCCL, phase 4's configuration through ``solve_acopf(mesh=...)`` at
   verbose 0: the fused driver, its collectives captured into the loop's
   graph as NCCL work. The same status, outer and cumul and a bit-equal
   objective as phase 4 in the same call; the loop bodies' nodes all of a
   kind a conditional body holds (event nodes, if any, made edges, and
   counted); exactly 4 all-reduces per inner iteration (bus sums, residual
   partials, branch effort sums, max_cviol), counted on the device; then
   the host loop over the same mesh, every solution tensor bit-identical;
   the inner it/s of both beside phase 4's fused rate, the build ms and the
   pool MiB;
9b. two ranks on the one card over gloo (the all-reduce payloads staged
   through pinned host memory, ``parallel/sharding.py``): case9, 6 outer
   iterations, against the one-process card run (the same cumul, objective
   within 1e-8 relative); then phase 4's configuration on the two ranks:
   cumul within 2 % of phase 4's, the inner it/s beside it (two host loops
   share one card: a correctness phase, not a speed claim). Gloo on the
   card runs the host loop by rule: it stages every collective through
   pinned host memory, which a CUDA graph cannot hold. A rank that
   hangs fails the phase: every collective and the join have a time limit.
   NCCL between cards is not run here: the machine has one card;
10a. mixed precision (an fp64 solve with the branch batch in fp32): phase
   2's fp64 batch cast down as the mixed path casts it, the f32 branch
   kernel against its f32 plain version with phase 2's fp32 thresholds,
   its device time beside the f64 kernel's on the same batch and its f32
   bound; ``solve_acopf(mixed_precision=True)`` at phase 4's configuration:
   phase 4's outer count, the objective within 1e-3 relative of phase 4's,
   the state fp64, every branch launch the f32 instance; case9 with and
   without line limits to Solved at outer_eps 2e-4, within 1e-3 of the
   fp64 objectives 5286.652017310178 and 5286.651807890947 (at 2e-5 which
   side of the tolerance a mixed case9 solve lands on is fp32 rounding:
   ROADMAP's Queue 3, tests/torch_mixed_trace.py);
10b. line sorting: phase 4's configuration with ``Parameters(sort_lines=
   True)`` through the model and the driver, first the host loop, then the
   fused driver (the driver's choice at verbose 0): the same counts and
   info and every solution tensor bit-identical, the fused loop's last line
   order the host loop's last; phase 4's outer count, cumul
   within 2 %, the objective within 1e-6 relative, the rows back in
   canonical order (every line copy of a bus's w equal); the device ms of
   the fused loop's outer prestep with the sort (captured alone and
   replayed) per outer round; the scatter
   over the CSR derived for every sorted round's order, against its plain
   version and the canonical order's sums (1e-13 relative); the branch
   kernel's device time at steady state (the batch after the sorted
   solve) in canonical order and sorted by its lanes' steps; then the same
   sort on phase 2's 15,710-lane batch and on the 39,016-lane multi-period
   batch at it1, the sorted run bit-identical to the unsorted one and to
   the plain version;
11. the fused drivers (every solve at verbose 0 above ran them): first the
   set-condition kernel of ``csrc/graph_loop.cu`` against its plain
   version, a loop of 2000 trips run by the graph and by the host (both
   stop at 2000; device ms per trip, the kernel's own from the profiler,
   the host loop's per trip); then, on the configurations of phases 4-8,
   10a's mixed solve, 10b's sorted solve, 9a's mesh of one rank and the
   case9 pins of phase 3 (3, 3b, 3c, 3d, both of
   3e, 3f), the entry point's fused solve against its host loop: the same
   status, outer, cumul and info scalars, every solution tensor
   bit-identical, the host loop's counted launches of every kernel plus
   the warm-up's one pass of the inner body, and 1 + 2 outer + cumul
   set-condition launches (1 + iterations one-level); inner it/s of both,
   the wall time of both entry-point calls (the fused one's with its
   build), the graph's build ms and its pool MiB;
11t. the port's tracer (``utils/tracing.py``) on phase 4's solve: with it
   on and off the same solution bit for bit, the same info and the same
   launches of every kernel; on, the spans' tree under one
   ``entry.solve``, ``tron_steps`` (the step counter that ``branch_stats``
   adds to) equal to the sums of the host loop's branch stats over its
   inner iterations, ``device_s`` (CUDA events around the graph's launch)
   inside ``time_overall``, and a kept driver's second solve rooted at
   ``loop.solve`` with nothing built.

Every fused solve on the card starts (the buffers' reset and the graph's
launch) under ``torch.cuda.set_sync_debug_mode("error")``
(``graph_loop.no_syncs``), so a synchronization before the final
read-back fails its phase.

The kernels' launch counters are zeroed just before phases 4, 5, 6, 7, 8,
9a and 9b's full-size run (there on rank 0, which reports them), 10a's
mixed solve and 10b's sorted solve at phase 4's configuration, and read just
after each; the ``launches`` of a kernel in the JSON line are the sum over
those nine runs. Phases 4-8, 9a, 10a and 10b run the fused driver: a
wrapper called while its loop body is captured counts on the device, once
per replay, and the solve reads those counters back with its scalars; the
warm-up before the capture counts as any launch (``ops/graph_loop.py``).
9b runs the host loop. Every phase that solves with line subproblems
checks one pack, one unpack and one stats launch (``csrc/branch_io.cu``)
per branch or polar TRON launch.

Phase 2f also checks, on every batch, that the stats kernel given a step
counter adds the two sums to it and leaves its outputs as they were.

``--profile`` adds a breakdown of one iteration of the configurations of
phases 4 to 8 (host time per hook, device time by kernel, idle share) and
``utils/profiling.py::profile_iteration``'s device time per hook of phase
4's model, then each of those phases' fused solve (phase 8's right after
phase 4's), 10b's sorted one and 9a's over a mesh of one rank, from its
launch to its last device activity (device busy time, idle share and
device activities per iteration);
``--solve`` adds the time to tolerance of phase 4's configuration.

Each phase prints one line of numbers; any failure raises, so the script
exits non-zero and prints no result. The line before the last is one JSON
object with each kernel's numbers (phase 1's fp64 scatter and phase 2's,
2b's, 2c's and 2d's fp64 batches, phase 11's set-condition loop, phase
4h's hook kernels, phase 2f's branch I/O kernels and phase 5h's
multi-period hook kernels):
``ms`` and ``device_ms`` the device time per launch, ``enqueue_ms`` the host's time per call, ``plain_ms`` the plain
version's, ``bound_ms`` and ``bound_by`` the least time for the bytes and
operations of that launch, and ``library_ms`` ``index_add_``'s device time
for the scatter (null for the TRON instances, which no library call
computes; the polar one's ``replaces`` names the JAX line that runs it as
plain XLA, since no TPU kernel does, each hook kernel's the JAX hook
whose XLA fusions it stands for, and each branch I/O kernel's the JAX
code around the solver call whose fusions it stands for); the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CASE9 = os.path.join(ROOT, "data", "case9.m")
DEMAND9 = os.path.join(ROOT, "data", "case9_demand")
PIN_OUTER, PIN_CUMUL = 25, 1087
POLAR_PIN_OUTER, POLAR_PIN_CUMUL = 20, 973
# (outer, cumul, objective) of the JAX package on the CPU, fp64
MPEC_PINS = {"without storage": (23, 1401, 5329.132434858213),
             "with storage": (12, 1073, 4936.875393666981)}
ROLLING_PINS = ((20, 973, 5286.652017310178), (9, 166, 5403.734908384519),
                (7, 91, 5355.780080975317))
# the fp64 pins of case9 at outer_eps 2e-4, rho (4e2, 4e4), of the JAX
# package on the CPU: with line limits (ROLLING_PINS' first period is the
# same solve) and without; phase 10a holds the mixed solves to 1e-3 of them
MIXED9_PINS = {"with line limits": ROLLING_PINS[0][2],
               "without line limits": 5286.651807890947}
# the MPEC storage of phase 7 and --profile
MPEC_STORAGE = dict(storage_ratio=0.1, storage_charge_max=0.1, droop=0.04)
MP_PIN_OUTER, MP_PIN_CUMUL, MP_PIN_OBJ = 20, 1007, 16015.6958770167
QP_PIN_ITERS, QP_PIN_OBJ = 5107, -21.92744641968529
CASE118 = os.path.join(ROOT, "data", "case118.m")
# (outer, cumul, objective) of the port on the CPU, fp64; the reference's
# objective beside it
CASE118_PIN = (20, 1281, 129638.3553876704)
CASE118_REFERENCE_OBJ = 129645.676
# the two-rank case9 run of phase 9b (tests/test_torch_sharding.py's)
RANKS = 2
SHARD9_KW = dict(rho_pq=4e2, rho_va=4e4, outer_eps=2e-5, outer_iterlim=6,
                 verbose=0)
# phase 4's solve, which phases 9a and 9b repeat over a mesh
MAIN_KW = dict(rho_pq=3e3, rho_va=3e5, outer_iterlim=3, inner_iterlim=100,
               outer_eps=0.0, verbose=0)
QP_ITERS = 200
KERNEL_SOURCES = {
    "tron_alm_branch": ("exaadmm_tpu_torch/csrc/tron_alm_branch.cu",
                        "exaadmm_tpu/ops/tron_pallas.py:42"),
    "tron_alm_ramp": ("exaadmm_tpu_torch/csrc/tron_alm_ramp.cu",
                      "exaadmm_tpu/ops/tron_pallas.py:42"),
    "tron_alm_qpsub": ("exaadmm_tpu_torch/csrc/tron_alm_qpsub.cu",
                       "exaadmm_tpu/ops/tron_pallas.py:42"),
    "bus_scatter": ("exaadmm_tpu_torch/csrc/bus_scatter.cu",
                    "exaadmm_tpu/ops/bus_pallas.py:42"),
    # no TPU kernel: the JAX package runs this batch as plain XLA
    "tron_alm_polar": ("exaadmm_tpu_torch/csrc/tron_alm_polar.cu",
                       "exaadmm_tpu/models/acopf/branch.py:480 "
                       "(tron_batched; no Pallas)"),
    # no TPU kernel: the fused drivers' loops, which XLA compiles
    "graph_loop": ("exaadmm_tpu_torch/csrc/graph_loop.cu",
                   "exaadmm_tpu/algorithms/admm_two_level.py:387 "
                   "(lax.while_loop; no Pallas)"),
    # no TPU kernel: the ACOPF hooks, which XLA fuses (``HOOK_KERNELS``)
    "acopf_hooks": ("exaadmm_tpu_torch/csrc/acopf_hooks.cu",
                    "exaadmm_tpu/models/acopf/kernels.py:27 "
                    "(generator_update ... residual_update; no Pallas)"),
    # no TPU kernel: the branch update around the solver call, which XLA
    # fuses (``BRANCH_IO_KERNELS``)
    "branch_io": ("exaadmm_tpu_torch/csrc/branch_io.cu",
                  "exaadmm_tpu/models/acopf/branch.py:297 "
                  "(branch_update around the solver call; no Pallas)"),
    # no TPU kernel: the multi-period hooks, which XLA fuses
    # (``MP_HOOK_KERNELS``)
    "mpacopf_hooks": ("exaadmm_tpu_torch/csrc/mpacopf_hooks.cu",
                      "exaadmm_tpu/models/mpacopf/model.py:162 "
                      "(_ramp_alm_update ... update_residual; no Pallas)"),
}
# the kernels of csrc/acopf_hooks.cu, each with the JAX hook whose XLA
# fusions it stands for (no TPU kernel)
_JK = "exaadmm_tpu/models/acopf/kernels.py"
HOOK_KERNELS = {
    "acopf_generator": f"{_JK}:27 (generator_update; XLA fusions, no "
                       "Pallas)",
    "acopf_bus_values": f"{_JK}:221 (bus_update: the arc and generator "
                        "values; XLA fusions, no Pallas)",
    "acopf_bus_solve": f"{_JK}:221 (bus_update: the per-bus 2x2 solve; XLA "
                       "fusions, no Pallas)",
    "acopf_bus_writeback": f"{_JK}:221 (bus_update: the writeback; XLA "
                           "fusions, no Pallas)",
    "acopf_z": f"{_JK}:395 (z_update; XLA fusions, no Pallas)",
    "acopf_l": f"{_JK}:403 (l_update; XLA fusions, no Pallas)",
    "acopf_lz": f"{_JK}:408 (lz_update; XLA fusions, no Pallas)",
    "acopf_residual_partials": f"{_JK}:426 (residual_update with "
                               "compute_objval: rp, rd, the block sums; XLA "
                               "fusions, no Pallas)",
    "acopf_residual_final": f"{_JK}:426 (residual_update: the six scalars; "
                            "XLA fusions, no Pallas)",
}


# the kernels of csrc/branch_io.cu, each with the JAX code whose XLA
# fusions it stands for (no TPU kernel)
_JB = "exaadmm_tpu/models/acopf/branch.py"
BRANCH_IO_KERNELS = {
    "branch_pack": f"{_JB}:255 (_branch_params, with _warm_start_x0 :270, "
                   "the ALM start :366-368 and mixed precision's casts :335; "
                   "XLA fusions, no Pallas)",
    "branch_unpack": f"{_JB}:297 (branch_update after the solver call: the "
                     "casts :342, the flows and the masked writeback "
                     ":490-505, the stats' terms :508-536; XLA fusions, no "
                     "Pallas)",
    "branch_stats": f"{_JB}:297 (branch_update: the stats' sums and maximum "
                    ":508-529; XLA fusions, no Pallas)",
}


# the kernels of csrc/mpacopf_hooks.cu, each with the JAX multi-period hook
# whose XLA fusions it stands for (no TPU kernel)
_JM = "exaadmm_tpu/models/mpacopf/model.py"
MP_HOOK_KERNELS = {
    "mp_ramp_pack": f"{_JM}:162 (_ramp_alm_update: the ramp batch's x0, "
                    "bounds, parameters and ALM start :162-244; XLA "
                    "fusions, no Pallas)",
    "mp_generator_unpack": f"{_JM}:246 (update_x: qg, pg of period 1 and "
                           "the ramp unpack :246-323; XLA fusions, no "
                           "Pallas)",
    "mp_bus_values": f"{_JM}:326 (update_xbar, vmapped with the ramp "
                     "blend: the arc and generator values; XLA fusions, no "
                     "Pallas)",
    "mp_bus_solve": f"{_JM}:326 (update_xbar: the per-bus 2x2 solve; XLA "
                    "fusions, no Pallas)",
    "mp_bus_writeback": f"{_JM}:326 (update_xbar: the writeback; XLA "
                        "fusions, no Pallas)",
    "mp_z": f"{_JM}:370 (update_z with the ramp block; XLA fusions, no "
            "Pallas)",
    "mp_l": f"{_JM}:379 (update_l with the ramp block; XLA fusions, no "
            "Pallas)",
    "mp_lz": f"{_JM}:385 (update_lz with the ramp block; XLA fusions, no "
             "Pallas)",
    "mp_residual_partials": f"{_JM}:393 (update_residual: rp, rd and the "
                            "per-period block sums; XLA fusions, no "
                            "Pallas)",
    "mp_residual_final": f"{_JM}:393 (update_residual: the maximum over "
                         "periods of the 2-norms, the objective; XLA "
                         "fusions, no Pallas)",
}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def _zero_launches():
    """Set every kernel's launch count to 0."""
    from exaadmm_tpu_torch.ops import acopf_cuda, branch_cuda, bus_cuda, \
        graph_loop, mpacopf_cuda, tron_cuda
    tron_cuda.launches.clear()
    acopf_cuda.launches.clear()
    branch_cuda.launches.clear()
    mpacopf_cuda.launches.clear()
    bus_cuda.launches = 0
    graph_loop.launches = 0


def _launches() -> dict:
    """Every kernel's launch count, by kernel name; ``graph_loop`` counts
    the fused loops' set-condition kernel (1 + 2 outer + cumul in a
    two-level solve, 1 + iterations in a one-level one)."""
    from exaadmm_tpu_torch.ops import acopf_cuda, branch_cuda, bus_cuda, \
        graph_loop, mpacopf_cuda, tron_cuda
    n = {inst.name: tron_cuda.instance_launches(inst)
         for inst in (tron_cuda.BRANCH, tron_cuda.RAMP, tron_cuda.QPSUB,
                      tron_cuda.POLAR)}
    n.update({k: acopf_cuda.launches.get(k, 0) for k in HOOK_KERNELS})
    n.update({k: branch_cuda.launches.get(k, 0) for k in BRANCH_IO_KERNELS})
    n.update({k: mpacopf_cuda.launches.get(k, 0) for k in MP_HOOK_KERNELS})
    return dict(n, bus_scatter=bus_cuda.launches,
                graph_loop=graph_loop.launches)


# a solve that builds a fused solver runs its loop bodies once before the
# capture (``GraphLoop``'s warm-up, on a copy of the state), so on the card
# each kernel of the inner iteration launches once more than the solve's
# iterations; the host loop has no warm-up
WARMUP = 1


def _loop_trips(info, two_level: bool = True) -> int:
    """The set-condition launches a fused solve of ``info`` must count."""
    return 1 + (2 * info.outer + info.cumul if two_level else info.cumul)


def _hooks_held(label: str, launches: dict, cumul: int, outer: int,
                warm: int = WARMUP) -> None:
    """The hook kernels of a single-period ACOPF solve (or of solves with
    ``cumul`` inner iterations and ``outer`` outer rounds in all) on a fused
    solver built once: each once an inner iteration, ``acopf_lz`` once an
    outer round (the loop's tail runs it every round), and the warm-up's
    pass once more."""
    want = {k: cumul + warm for k in HOOK_KERNELS}
    want["acopf_lz"] = outer + warm
    got = {k: launches[k] for k in HOOK_KERNELS}
    _check(got == want, f"{label}: hook kernel launches {got}, expected "
                        f"{want}")


def _mp_hooks_held(label: str, launches: dict, cumul: int, outer: int,
                   T: int, warm: int = WARMUP) -> None:
    """The multi-period hook kernels of a ``solve_mpacopf`` on a fused
    solver built once: each once an inner iteration (the ramp pack none
    with one period), ``mp_lz`` once an outer round, and the warm-up's
    pass once more; and no single-period hook kernel."""
    want = {k: cumul + warm for k in MP_HOOK_KERNELS}
    want["mp_lz"] = outer + warm
    if T == 1:
        want["mp_ramp_pack"] = 0
    got = {k: launches[k] for k in MP_HOOK_KERNELS}
    acopf = {k: launches[k] for k in HOOK_KERNELS if launches[k]}
    _check(got == want and not acopf,
           f"{label}: multi-period hook kernel launches {got}, expected "
           f"{want}; single-period hook kernels {acopf}")


@contextlib.contextmanager
def _no_plain_mp_hooks(on_card: bool):
    """On the card, the multi-period hooks' plain versions made to raise:
    a solve in this block must run every hook on its kernels. On the CPU
    (a rehearsal) the plain versions are the route, and nothing changes."""
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.models.mpacopf import ramp as R
    from exaadmm_tpu_torch.ops import mpacopf_cuda as MC
    if not on_card:
        yield
        return

    def never(*a, **k):
        raise AssertionError("a multi-period hook ran its plain version on "
                             "the card")

    saved = []
    for mod, names in ((MP, ("generator_unpack_plain", "bus_update_plain",
                             "z_update_plain", "l_update_plain",
                             "lz_update_plain", "residual_update_plain")),
                       (R, ("ramp_pack_plain",)),
                       (MC, ("bus_values_plain", "bus_solve_plain",
                             "residual_partials_plain",
                             "residual_final_plain"))):
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, never)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _branch_io_launches(label: str, launches: dict) -> None:
    """The branch update's kernels: one pack, one unpack and one stats pass
    for each launch of the branch or polar TRON kernel, and at least one
    (the plain path of ``branch_update`` launches none of them)."""
    tron = launches["tron_alm_branch"] + launches["tron_alm_polar"]
    got = {k: launches[k] for k in BRANCH_IO_KERNELS}
    _check(tron > 0 and got == {k: tron for k in BRANCH_IO_KERNELS},
           f"{label}: branch I/O launches {got} for {tron} branch TRON "
           f"launches")


def phase0_device(dev, on_card: bool) -> dict:
    from exaadmm_tpu_torch.ops import _build, acopf_cuda, branch_cuda, \
        bus_cuda, graph_loop, mpacopf_cuda, tron_cuda
    info = {"name": str(dev)}
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[dev.index or 0]
        info = {"name": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count(), "smi": card}
        print(card)
        print(f"phase 0: device {info['name']!r} count {info['count']} "
              f"torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        _build.build(KERNEL_SOURCES)
        tron_cuda.library(tron_cuda.BRANCH)
        tron_cuda.library(tron_cuda.RAMP)
        tron_cuda.library(tron_cuda.QPSUB)
        tron_cuda.library(tron_cuda.POLAR)
        bus_cuda.library()
        acopf_cuda.library()
        branch_cuda.library()
        mpacopf_cuda.library()
        # keep_graph, raw_cuda_graph and a driver with conditional nodes
        graph_loop.check_support()
        version = ctypes.c_int(0)
        graph_loop.library().driver_version(ctypes.byref(version))
        info["driver"] = version.value
        print(f"phase 0: CUDA driver {version.value}, "
              f"torch.cuda.CUDAGraph(keep_graph=True) and raw_cuda_graph "
              f"present")
        print(f"phase 0: built {len(KERNEL_SOURCES)} kernels in parallel in "
              f"{time.perf_counter() - t0:.1f} s")
        for name in KERNEL_SOURCES:
            log = [ln.strip() for ln in _build.build_logs[name].splitlines()
                   if "Compiling entry" in ln or "registers" in ln
                   or "spill" in ln]
            print(f"phase 0: built {name} in "
                  f"{_build.build_seconds[name]:.1f} s")
            for ln in log:
                print(f"  {ln}")
    return info


def _hold_scatter(sums, tol: float, label: str):
    """Run the scatter kernel twice and its plain version once on each
    (values, ids, ptr, idx) of ``sums``: the two runs bit-identical, the
    max relative difference per channel (over the channel's largest
    magnitude) <= ``tol``. Returns (max relative, max absolute) difference."""
    from exaadmm_tpu_torch.ops import bus_cuda

    worst_rel, worst_abs = 0.0, 0.0
    for vals, ids, ptr, idx in sums:
        got = bus_cuda.bus_scatter(vals, ids, ptr, idx)
        again = bus_cuda.bus_scatter(vals, ids, ptr, idx)
        ref = bus_cuda.bus_scatter_plain(vals, ids, ptr.shape[0] - 1)
        _check(bool(torch.equal(got, again)), f"{label}: two runs differ")
        diff = (got - ref).abs()
        scale = ref.abs().amax(dim=0).clamp_min(torch.finfo(vals.dtype).tiny)
        worst_rel = max(worst_rel, float((diff.amax(dim=0) / scale).max()))
        worst_abs = max(worst_abs, float(diff.max()))
    _check(worst_rel <= tol,
           f"{label}: rel diff {worst_rel:.3e} > {tol:.0e}")
    return worst_rel, worst_abs


def _rank_views(model, sol, nranks: int = RANKS):
    """What each of ``nranks`` ranks of the lines-split-across-ranks path
    runs on: (rank, its local model, its local state), cut from the whole
    padded ``model`` and ``sol`` as ``run_sharded`` cuts them. No process
    group is needed: nothing here reduces across ranks."""
    from exaadmm_tpu_torch.parallel import sharding
    for rank in range(nranks):
        mesh = sharding.Mesh(group=None, rank=rank, size=nranks)
        yield (rank, sharding.local_model(model, mesh),
               sharding.local_solution(sol, mesh))


def phase1_bus(dev, data, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.acopf import kernels
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.ops import bounds, bus_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters
    from exaadmm_tpu_torch.utils.timing import time_pair

    out = {}
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        model = M.build_model(data, Parameters(verbose=0),
                              pad_lines_to=RANKS, dtype=dtype, device=dev)
        sol = M.init_solution(model, 3e3, 3e5)
        gd = model.grid
        arcs = kernels.bus_arc_values(sol.v, sol.z, sol.l, sol.rho, gd)
        gens = kernels.bus_gen_values(sol.v, sol.z, sol.l, sol.rho)
        worst_rel, worst_abs = _hold_scatter(
            ((arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx),
             (gens, gd.gen_bus, gd.gen_ptr, gd.gen_idx)),
            tol, f"bus_scatter {dtype}")
        (ms, enq), (lib_ms, lib_enq) = time_pair(
            lambda: bus_cuda.bus_scatter(arcs, gd.arc_bus, gd.arc_ptr,
                                         gd.arc_idx),
            lambda: bus_cuda.bus_scatter_plain(arcs, gd.arc_bus, gd.nbus),
            dev, reps=100)
        nb = bounds.scatter_bytes(arcs.shape[0], gd.nbus, arcs.shape[1],
                                  arcs.element_size())
        bound_ms, bound_by = bounds.bound(
            nb["total"], bounds.scatter_ops(arcs.shape[0], arcs.shape[1]),
            arcs.element_size())
        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = dict(rel=worst_rel, abs=worst_abs, ms=ms, enqueue_ms=enq,
                        plain_ms=lib_ms, library_ms=lib_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        print(f"phase 1: bus_scatter {key} arcs {tuple(arcs.shape)} -> "
              f"{gd.nbus} buses: max rel diff {worst_rel:.3e} (tol {tol:.0e}),"
              f" max abs diff {worst_abs:.3e}, bit-identical reruns; device "
              f"ms per launch: kernel {ms:.5f}, index_add_ with its zeros "
              f"{lib_ms:.5f}, bound {bound_ms:.5f} ({bound_by}, "
              f"{nb['total']} B); host enqueue ms per call: kernel "
              f"{enq:.5f}, index_add_ {lib_enq:.5f}")
        for rank, local, lsol in _rank_views(model, sol):
            lg = local.grid
            larcs = kernels.bus_arc_values(lsol.v, lsol.z, lsol.l, lsol.rho,
                                           lg)
            empty = int((lg.arc_ptr[1:] == lg.arc_ptr[:-1]).sum())
            rel, worst = _hold_scatter(
                ((larcs, lg.arc_bus, lg.arc_ptr, lg.arc_idx),), tol,
                f"bus_scatter {dtype} rank {rank} of {RANKS}")
            out[key]["abs"] = max(out[key]["abs"], worst)
            print(f"phase 1d: bus_scatter {key} rank {rank} of {RANKS}: "
                  f"arcs {tuple(larcs.shape)} over {lg.arc_idx.shape[0]} CSR "
                  f"entries -> {lg.nbus} buses ({empty} with no local arc): "
                  f"max rel diff {rel:.3e} (tol {tol:.0e}), max abs diff "
                  f"{worst:.3e}, bit-identical reruns")
    return out


def _tron_vs_plain(label: str, name: str, kernel, plain, act, dtype,
                   dev) -> dict:
    """Run the TRON/ALM kernel ``name`` and its plain version on the same
    batch, hold them to phase 2's thresholds, time both and bound the
    kernel (``ops/bounds.py``, from this batch's iteration counts)."""
    from exaadmm_tpu_torch.ops import bounds
    from exaadmm_tpu_torch.utils.timing import time_ms
    rk = kernel()
    rp = plain()
    _sync(dev)
    a = act.cpu().numpy()
    mk_all = rk.minor_iters.cpu().numpy()
    ak_all = rk.alm_iters.cpu().numpy()
    mk = mk_all[a]
    mp = rp.minor_iters.cpu().numpy()[a]
    ak = ak_all[a]
    ap = rp.alm_iters.cpu().numpy()[a]
    same = (mk == mp) & (ak == ap)
    dx = (rk.x - rp.x).abs().amax(dim=0).cpu().numpy()[a]
    frac = float(same.mean())
    dx_same = float(dx[same].max()) if same.any() else 0.0
    dx_all = float(dx.max())
    _check(bool(np.isfinite(rk.x.cpu().numpy()).all()),
           f"{label}: non-finite x")
    if dtype == torch.float64:
        _check(frac >= 0.995, f"{label} f64: only {frac:.4%} lanes agree")
        _check(dx_same <= 1e-8, f"{label} f64: |dx| {dx_same:.3e} > 1e-8")
    else:
        _check(frac >= 0.95, f"{label} f32: only {frac:.4%} lanes agree")
        _check(dx_same <= 1e-3, f"{label} f32: |dx| {dx_same:.3e} > 1e-3")
        _check(dx_all <= 5e-3, f"{label} f32: |dx| {dx_all:.3e} > 5e-3")
    ms, enq = time_ms(kernel, dev, reps=5, warmup=1)
    plain_ms, _ = time_ms(plain, dev, reps=1, warmup=0, ahead=False)
    B = rk.x.shape[1]
    isz = rk.x.element_size()
    nb = bounds.tron_bytes(name, B, isz)
    ops = bounds.tron_ops(name, mk_all.sum(), ak_all.sum(), B)
    bound_ms, bound_by = bounds.bound(nb["total"], ops, isz)
    max_minor = int(mk.max()) if mk.size else 0
    us_per_step = ms * 1e3 / max(max_minor, 1)
    key = "f64" if dtype == torch.float64 else "f32"
    print(f"{label} {key} B={same.size} step_cap=50: {int((~same).sum())} of "
          f"{same.size} lanes differ in minor/alm iterations ({frac:.4%} "
          f"agree), {int((dx > 0).sum())} lanes with x not bit-identical, max "
          f"|dx| agreeing {dx_same:.3e}, all {dx_all:.3e}; minor iters mean "
          f"{mk.mean():.2f} p99 {np.percentile(mk, 99):.0f} max {max_minor}; "
          f"kernel device {ms:.4f} ms ({us_per_step:.2f} us per step of the "
          f"slowest lane), host enqueue {enq:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {nb['total']} B, {ops:.4g} ops); plain "
          f"{plain_ms:.1f} ms")
    return dict(frac=frac, dx_same=dx_same, dx_all=dx_all, ms=ms,
                enqueue_ms=enq, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _it1_state(dev, data, dtype, par, pad: int = RANKS,
               use_linelimit: bool = True):
    """Phase 2's setup: the model of ``data`` (lines padded to a multiple
    of ``pad``) and its flat start at rho (4e2, 4e4) with the line prox
    targets perturbed by N(0, 0.05) from numpy seed 0, so the lanes spread
    in difficulty; phase 2d's without line limits."""
    from exaadmm_tpu_torch.models.acopf import model as M
    model = M.build_model(data, par, use_linelimit=use_linelimit,
                          pad_lines_to=pad, dtype=dtype, device=dev)
    sol = M.init_solution(model, 4e2, 4e4)
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.normal(0, 0.05, tuple(sol.v.line.shape)))
    return model, sol.replace(v=sol.v.replace(
        line=sol.v.line + noise.to(device=dev, dtype=dtype)))


def _take_lanes(batch, order):
    """A TRON batch (x0, xl, xu, params, lam0, mu0, active0) with its lanes
    (the last axis of every tensor) reordered by ``order``."""
    def take(a):
        return a.index_select(a.dim() - 1, order).contiguous()
    x0, xl, xu, params, lam0, mu0, act = batch
    return (take(x0), take(xl), take(xu),
            {k: take(v) for k, v in params.items()}, take(lam0), take(mu0),
            take(act))


def phase2_tron(dev, data, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    out = {}
    for dtype in (torch.float64, torch.float32):
        par = Parameters(verbose=0, tron_step_cap=50)
        model, sol = _it1_state(dev, data, dtype, par)
        opts = branch.branch_tolerances(par, dtype)
        key = "f64" if dtype == torch.float64 else "f32"

        def hold(label, sol, gd):
            x0, xl, xu, params, lam0, mu0, act = branch.branch_inputs(
                sol, gd, par, 1)

            def kernel():
                return tron_cuda.tron_alm_branch(
                    x0, xl, xu, params, lam0, mu0, active0=act, **opts)

            def plain():
                return tron_cuda.tron_alm_branch_plain(
                    x0, xl, xu, params, lam0, mu0, active0=act, **opts)

            return _tron_vs_plain(label, "tron_alm_branch", kernel, plain,
                                  act, dtype, dev)

        out[key] = hold("phase 2: tron_alm_branch", sol, model.grid)
        for rank, local, lsol in _rank_views(model, sol):
            r = hold(f"phase 2e: tron_alm_branch rank {rank} of {RANKS}",
                     lsol, local.grid)
            out[key]["dx_all"] = max(out[key]["dx_all"], r["dx_all"])
    return out


def phase2d_polar(dev, data, on_card: bool) -> dict:
    """Phase 2's check on the polar batch (no line limits) of the same
    grid: 4 variables a line, no constraints."""
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    out = {}
    for dtype in (torch.float64, torch.float32):
        par = Parameters(verbose=0, tron_step_cap=50)
        model, sol = _it1_state(dev, data, dtype, par, pad=1,
                                use_linelimit=False)
        x0, xl, xu, params, lam0, mu0, act = branch.polar_inputs(
            sol, model.grid, par)
        opts = branch.polar_tolerances(par, dtype)

        def kernel():
            return tron_cuda.tron_alm_polar(x0, xl, xu, params, lam0, mu0,
                                            active0=act, **opts)

        def plain():
            return tron_cuda.tron_alm_polar_plain(
                x0, xl, xu, params, lam0, mu0, active0=act, **opts)

        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = _tron_vs_plain("phase 2d: tron_alm_polar",
                                  "tron_alm_polar", kernel, plain, act,
                                  dtype, dev)
    return out


def _branch_io_state(sol, seed: int = 1):
    """``sol`` with its line rows of u perturbed by N(0, 0.2) and its ALM
    state drawn (lam1, lam2 N(0, 1), mu uniform in [10, 1000]) from numpy
    seed ``seed``, so the warm start's clamps bind on both sides and every
    input of the pack matters."""
    rng = np.random.default_rng(seed)
    u = sol.u.line
    B = u.shape[0]

    def t(a):
        return torch.as_tensor(a, dtype=u.dtype, device=u.device)

    alm = sol.branch_alm
    return sol.replace(
        u=sol.u.replace(line=u + t(rng.normal(0, 0.2, (B, 8)))),
        branch_alm=alm.replace(lam1=t(rng.normal(0, 1, B)),
                               lam2=t(rng.normal(0, 1, B)),
                               mu=t(rng.uniform(10, 1e3, B))))


def _branch_io_held(label: str, sol, gd, par, it, use_linelimit: bool,
                    dev) -> dict:
    """The pack, the TRON kernel on its batch, the unpack and the stats on
    one batch: the three branch I/O kernels twice each against their plain
    versions (``branch_pack_plain``, ``branch_unpack_plain``), every output
    bit-identical to the plain version's and to the rerun's."""
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.ops import branch_cuda, tron_cuda

    out_dtype = sol.u.line.dtype
    mixed = par.mixed_precision and out_dtype == torch.float64
    solve = torch.float32 if mixed else out_dtype
    args = (sol, gd, par, it, use_linelimit, solve)
    got, again = branch_cuda.branch_pack(*args), branch_cuda.branch_pack(*args)
    ref = branch.branch_pack_plain(*args)
    *batch, act = got
    if use_linelimit:
        inst, opts = tron_cuda.BRANCH, branch.branch_tolerances(par, solve)
    else:
        inst, opts = tron_cuda.POLAR, branch.polar_tolerances(par, solve)
    res = tron_cuda.tron_alm_packed(inst, *batch, active0=act, **opts)
    uargs = (res, sol, gd, act, use_linelimit, out_dtype)

    def flat(r):
        return [r[0], r[1].lam1, r[1].lam2, r[1].mu, r[2], r[3]]

    ugot = flat(branch_cuda.branch_unpack(*uargs))
    # the second run with a TRON step counter: the same outputs, and the
    # counter holds the two sums of both steps' stats (the plain version's)
    steps = torch.full((), 7, dtype=torch.int64, device=sol.u.line.device)
    steps_ref = steps.clone()
    uagain = flat(branch_cuda.branch_unpack(*uargs, steps))
    uref = flat(branch.branch_unpack_plain(*uargs, steps_ref))

    def carried():
        # as a fused loop's carry passes it, on a fresh copy of the state:
        # the line rows over u_old, the ALM state over the state's own,
        # the stats into an fp64 (5,) buffer
        alm = sol.branch_alm
        s = sol.replace(u=sol.u.replace(line=sol.u.line.clone()),
                        branch_alm=alm.replace(lam1=alm.lam1.clone(),
                                               lam2=alm.lam2.clone(),
                                               mu=alm.mu.clone()))
        st = torch.zeros(len(branch_cuda.STATS), dtype=torch.float64,
                         device=sol.u.line.device)
        r = branch_cuda.branch_unpack(
            res, s, gd, act, use_linelimit, out_dtype,
            out=(s.u.line, s.branch_alm, None, st))
        dsts = [s.u.line, s.branch_alm.lam1, s.branch_alm.lam2,
                s.branch_alm.mu, None, st]
        _check(all(d is None or a is d for a, d in zip(flat(r), dsts)),
               f"phase 2f: {label}: the unpack given out returned other "
               f"tensors")
        return flat(r)

    cref = uref[:5] + [uref[5].to(torch.float64)]
    _sync(dev)
    pairs = {"pack": (got, again, ref), "unpack": (ugot, uagain, uref),
             "unpack into the state's buffers": (carried(), carried(),
                                                 cref)}
    for what, (a, b, r) in pairs.items():
        same = all(x.dtype == y.dtype and bool(torch.equal(x, y))
                   for x, y in zip(a, r))
        rerun = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
        _check(same and rerun, f"phase 2f: {label}: {what} bit-identical to "
                               f"the plain version {same}, to a rerun {rerun}")
    want = 7 + int(uref[-1][0]) + int(uref[-1][1])
    _check(int(steps) == int(steps_ref) == want,
           f"phase 2f: {label}: TRON step counter {int(steps)}, plain "
           f"{int(steps_ref)}, the stats' sums {want}")
    inactive = int((act == 0).sum())
    B = sol.u.line.shape[0]
    print(f"phase 2f: {label}: B={B} ({inactive} inactive), pack, unpack "
          f"and stats bit-identical to their plain versions and to a rerun, "
          f"the unpack also into the state's own buffers; "
          f"stats {[float(x) for x in ugot[-1]]}; step counter +"
          f"{want - 7}")
    floats = list(zip([*got[:-1], *ugot[:4]], [*ref[:-1], *uref[:4]]))
    return dict(err=_max_abs(floats), stats_err=_max_abs([(ugot[5],
                                                           uref[5])]),
                res=res, act=act, inactive=inactive)


def phase2f_branch_io(dev, data, mp_data, mp_loads, T: int,
                      on_card: bool) -> dict:
    """The branch update's pack, unpack and stats kernels
    (``csrc/branch_io.cu``) against their plain versions, every output bit
    for bit, each kernel twice: synthetic 9241's first-iteration state
    (phase 2's, with u and the ALM state drawn from numpy seed 1 so the
    warm start's clamps bind), with and without line limits, fp64, fp32
    and mixed precision, at inner iteration 1 (an int) and 3 (a 0-d
    tensor); the 39,016-lane batch of synthetic 2869 x 8 periods; a random
    line order of the grid padded to 15,712 lines (2 inactive lanes); each
    of phase 2e's rank windows. Then, fp64 with line limits: each kernel's
    device ms per launch and the host's enqueue ms, the bound of
    ``ops/bounds.py``, the plain versions' device ms, the pack and unpack
    together eager and captured as a graph, plain and kernels, and the
    nodes of ``branch_update`` captured whole (on the card: exactly the
    pack, the TRON kernel, the unpack and the stats, no other node)."""
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.ops import bounds, branch_cuda, graph_loop
    from exaadmm_tpu_torch.utils.environment import (Parameters,
                                                     permute_solution_lines)
    from exaadmm_tpu_torch.utils.timing import time_ms

    f64, f32 = torch.float64, torch.float32
    it3 = torch.tensor(3, dtype=torch.int64, device=dev)
    types = {"f64": (f64, False), "f32": (f32, False), "mixed": (f64, True)}
    n = 0
    err = stats_err = 0.0

    def held(*a):
        nonlocal n, err, stats_err
        r = _branch_io_held(*a, dev)
        n += 1
        err, stats_err = max(err, r["err"]), max(stats_err, r["stats_err"])
        return r

    base = None
    for key, (dtype, mixed) in types.items():
        par = Parameters(verbose=0, tron_step_cap=50, mixed_precision=mixed)
        for ll in (True, False):
            model, sol = _it1_state(dev, data, dtype, par, use_linelimit=ll)
            sol = _branch_io_state(sol)
            inst = "line limits" if ll else "polar"
            for it in (1, it3):
                r = held(f"{data.case} {key} {inst} inner_iter {int(it)}"
                         f"{' (a tensor)' if torch.is_tensor(it) else ''}",
                         sol, model.grid, par, it, ll)
            if key == "f64" and ll:
                base = (model, sol, par, r)
        mp_model = _mp_model(dev, mp_data, mp_loads, T, dtype, par)
        flat = _branch_io_state(mp_model.flat_lines(MP.init_solution(
            mp_model, 4e2, 4e4).acopf))
        held(f"{mp_data.case} x {T} periods {key} line limits", flat,
             mp_model.grid_T, par, it3, True)
    par = Parameters(verbose=0, tron_step_cap=50)
    model, sol = _it1_state(dev, data, f64, par, pad=32)
    ids = torch.as_tensor(np.random.default_rng(2).permutation(
        model.grid.nline_padded), device=dev)
    sorted_model = model.with_line_order(ids)
    sorted_sol = permute_solution_lines(_branch_io_state(sol), ids)
    for ll in (True, False):
        held(f"{data.case} f64 {'line limits' if ll else 'polar'} in a "
             f"random line order", sorted_sol, sorted_model.grid, par, it3,
             ll)
    model, sol, par, r = base
    for rank, local, lsol in _rank_views(model, sol):
        held(f"{data.case} f64 line limits rank {rank} of {RANKS}", lsol,
             local.grid, par, it3, True)

    # the kernels' device ms at synthetic 9241, fp64 with line limits
    reps, plain_reps = (200, 10) if on_card else (2, 1)
    gd, res, act = model.grid, r["res"], r["act"]
    B = gd.nline_padded
    args = (sol, gd, par, it3, True, f64)
    uargs = (res, sol, gd, act, True, f64)
    part = branch_cuda.unpack_partials(*uargs)[3] if on_card else None
    act_b = act != 0
    kernels = {
        "branch_pack": (lambda: branch_cuda.branch_pack(*args),
                        lambda: branch.branch_pack_plain(*args)),
        "branch_unpack": (lambda: branch_cuda.unpack_partials(*uargs),
                          lambda: branch.branch_unpack_plain(*uargs)),
        "branch_stats": (lambda: branch_cuda.branch_stats(part, gd.nline),
                         lambda: branch.branch_stats_plain(res, gd, act_b)),
    }
    out = {}
    for name, (kern, plain) in kernels.items():
        if not on_card:   # the kernels' own launches need the card
            kern = plain
        ms, enq = time_ms(kern, dev, reps)
        plain_ms, plain_enq = time_ms(plain, dev, plain_reps)
        nbytes = bounds.branch_io_bytes(name, B, 6, 8,
                                        inactive=r["inactive"])
        bound_ms, bound_by = bounds.bound(
            nbytes["total"], bounds.branch_io_ops(name, B, 6))
        out[name] = dict(ms=ms, enqueue_ms=enq, plain_ms=plain_ms,
                         plain_enqueue_ms=plain_enq, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes["total"],
                         max_abs_err=stats_err if name == "branch_stats"
                         else err)
        print(f"phase 2f: {name}: device ms per launch {ms:.5f} (plain "
              f"{plain_ms:.5f}), bound {bound_ms:.5f} ({bound_by}, "
              f"{nbytes['total']} B); host enqueue ms per call {enq:.5f} "
              f"(plain {plain_enq:.5f})")

    def plain_io():
        branch.branch_pack_plain(*args)
        branch.branch_unpack_plain(*uargs)

    def kernel_io():
        branch_cuda.branch_pack(*args)
        branch_cuda.branch_unpack(*uargs)

    io = dict(plain_eager=time_ms(plain_io, dev, plain_reps)[0],
              plain_graph=_graph_ms(dev, plain_io, reps),
              kernel_eager=time_ms(kernel_io, dev, reps)[0],
              kernel_graph=_graph_ms(dev, kernel_io, reps))
    out["io"] = io
    print(f"phase 2f: pack and unpack together, device ms: plain "
          f"{io['plain_eager']:.5f} eager, {io['plain_graph']:.5f} in a "
          f"graph; kernels {io['kernel_eager']:.5f} eager, "
          f"{io['kernel_graph']:.5f} in a graph")
    census = {}
    if on_card:
        for label, ll, mixed in (("line limits", True, False),
                                 ("polar", False, False),
                                 ("mixed line limits", True, True)):
            p = Parameters(verbose=0, tron_step_cap=50,
                           mixed_precision=mixed)
            branch.branch_update(sol, gd, p, it3, ll)   # loads the kernels
            _sync(dev)
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(g):
                branch.branch_update(sol, gd, p, it3, ll)
            census[label] = graph_loop.node_types(g)
            _check(census[label] == {"kernel": 4},
                   f"phase 2f: branch_update ({label}) captured as "
                   f"{census[label]}, not the 4 kernels")
        print(f"phase 2f: branch_update captured whole: {census} (the pack, "
              f"the TRON kernel, the unpack, the stats)")
    out.update(cases=n, census=census)
    print(f"phase 2f: {n} batches held; max |diff| {err!r}, stats "
          f"{stats_err!r}")
    return out


def _mp_model(dev, data, loads, T: int, dtype, par):
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    return MP.build_model(data, par, *loads, end_period=T, dtype=dtype,
                          device=dev)


def _periods_batch(dev, data, loads, T: int, dtype, par):
    """The multi-period path's branch batch at the first inner iteration:
    the T * nline lines over the tiled grid, as ``update_x`` builds it,
    with the prox targets perturbed by N(0, 0.05) from numpy seed 0 so the
    lanes (and periods) differ."""
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    model = _mp_model(dev, data, loads, T, dtype, par)
    ac = MP.init_solution(model, 4e2, 4e4).acopf
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.normal(0, 0.05, tuple(ac.v.line.shape)))
    ac = ac.replace(v=ac.v.replace(
        line=ac.v.line + noise.to(device=dev, dtype=dtype)))
    return branch.branch_inputs(model.flat_lines(ac), model.grid_T, par, 1)


def phase2_branch_periods(dev, data, loads, T: int, on_card: bool) -> dict:
    """Phase 2's check on the multi-period path's branch batch."""
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    out = {}
    for dtype in (torch.float64, torch.float32):
        par = Parameters(verbose=0, tron_step_cap=50)
        x0, xl, xu, params, lam0, mu0, act = _periods_batch(
            dev, data, loads, T, dtype, par)
        opts = branch.branch_tolerances(par, dtype)

        def kernel():
            return tron_cuda.tron_alm_branch(x0, xl, xu, params, lam0, mu0,
                                             active0=act, **opts)

        def plain():
            return tron_cuda.tron_alm_branch_plain(
                x0, xl, xu, params, lam0, mu0, active0=act, **opts)

        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = _tron_vs_plain(
            f"phase 2: tron_alm_branch x {T} periods", "tron_alm_branch",
            kernel, plain, act, dtype, dev)
    return out


def phase1b_bus_periods(dev, data, loads, T: int, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.acopf import kernels
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.ops import bounds, bus_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters
    from exaadmm_tpu_torch.utils.timing import time_ms, time_pair

    out = {}
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        model = _mp_model(dev, data, loads, T, dtype, Parameters(verbose=0))
        gd = model.grid
        sol = MP.init_solution(model, 4e2, 4e4)
        ac = sol.acopf
        # periods that differ: the line and generator values perturbed per
        # period; the generator values blend in the next period's ramp terms
        # as the bus update does
        rng = np.random.default_rng(1)

        def perturb(a):
            return a + torch.as_tensor(rng.normal(0, 0.05, tuple(
                a.shape))).to(device=dev, dtype=dtype)

        u = ac.u.replace(line=perturb(ac.v.line), gen=perturb(ac.u.gen))
        arcs = kernels.bus_arc_values(u, ac.z, ac.l, ac.rho, gd)
        gens = kernels.bus_gen_values(u, ac.z, ac.l, ac.rho,
                                      model.next_ramp(sol.ramp))
        rel, worst_abs = 0.0, 0.0
        for what, vals, ids, ptr, idx in (
                ("arcs", arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx),
                ("gens", gens, gd.gen_bus, gd.gen_ptr, gd.gen_idx)):
            folded = bus_cuda.bus_scatter_periods(vals, ids, ptr, idx)
            single = torch.stack([bus_cuda.bus_scatter(vals[t], ids, ptr,
                                                       idx)
                                  for t in range(T)])
            ref = torch.stack([bus_cuda.bus_scatter_plain(vals[t], ids,
                                                          gd.nbus)
                               for t in range(T)])
            _check(bool(torch.equal(folded, single)),
                   f"bus_scatter_periods {what}: differs from single-period "
                   f"calls")
            diff = (folded - ref).abs()
            scale = ref.abs().amax(dim=1).clamp_min(torch.finfo(dtype).tiny)
            rel = max(rel, float((diff.amax(dim=1) / scale).max()))
            worst_abs = max(worst_abs, float(diff.max()))
        _check(rel <= tol, f"bus_scatter_periods {dtype}: rel diff "
                           f"{rel:.3e} > {tol:.0e}")
        folded_vals = arcs.permute(1, 0, 2).reshape(arcs.shape[1], -1)
        (ms, enq), (lib_ms, lib_enq) = time_pair(
            lambda: bus_cuda.bus_scatter_periods(arcs, gd.arc_bus, gd.arc_ptr,
                                                 gd.arc_idx),
            lambda: bus_cuda.bus_scatter_plain(folded_vals, gd.arc_bus,
                                               gd.nbus),
            dev, reps=100)
        loop_ms, loop_enq = time_ms(lambda: [bus_cuda.bus_scatter(
            arcs[t], gd.arc_bus, gd.arc_ptr, gd.arc_idx) for t in range(T)],
            dev, reps=100)
        nb = bounds.scatter_bytes(folded_vals.shape[0], gd.nbus,
                                  folded_vals.shape[1], arcs.element_size())
        bound_ms, bound_by = bounds.bound(
            nb["total"], bounds.scatter_ops(*folded_vals.shape),
            arcs.element_size())
        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = dict(rel=rel, abs=worst_abs, ms=ms, enqueue_ms=enq,
                        loop_ms=loop_ms, plain_ms=lib_ms, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
        print(f"phase 1b: bus_scatter_periods {key} {T} periods, arcs "
              f"{tuple(arcs.shape)} and gens {tuple(gens.shape)} -> "
              f"{gd.nbus} buses: both bit-identical to "
              f"{T} single-period calls, max rel diff to index_add_ "
              f"{rel:.3e} (tol {tol:.0e}); device ms: arcs folded "
              f"{ms:.5f}, {T} calls {loop_ms:.5f}, index_add_ with its zeros "
              f"on the folded rows {lib_ms:.5f}, bound {bound_ms:.5f} "
              f"({bound_by}, {nb['total']} B); host enqueue ms per call: "
              f"folded {enq:.5f}, {T} calls {loop_enq:.5f}, index_add_ "
              f"{lib_enq:.5f}")
    return out


def phase1c_bus_mpec(dev, data, on_card: bool) -> dict:
    """The MPEC bus update's three scatters on phase 7's model: the arc
    sums, the generator sums with vg's two channels and the storage sums
    over the bus -> storage CSR, from ``init_solution`` with u and l
    perturbed from a numpy seed, fp64, with phase 1's thresholds."""
    from exaadmm_tpu_torch.interface.solve_mpec import build_model
    from exaadmm_tpu_torch.models.acopf.kernels import bus_arc_values
    from exaadmm_tpu_torch.models.mpec import model as MM
    from exaadmm_tpu_torch.utils.environment import Parameters

    model = build_model(data, Parameters(verbose=0), **MPEC_STORAGE,
                        device=dev)
    gd, st = model.grid, model.storage
    sol = MM.init_solution(model, 3e3, 3e5)
    rng = np.random.default_rng(2)

    def perturb(a):
        return a + torch.as_tensor(rng.normal(0, 0.05, tuple(a.shape))).to(
            device=dev, dtype=a.dtype)

    u, l = MM.mpec_map(perturb, sol.u), MM.mpec_map(perturb, sol.l)
    sums = {
        "arcs": (bus_arc_values(u, sol.z, l, sol.rho, gd), gd.arc_bus,
                 gd.arc_ptr, gd.arc_idx),
        "gens": (MM.gen_values(u, sol.z, l, sol.rho), gd.gen_bus, gd.gen_ptr,
                 gd.gen_idx),
        "storage": (MM.storage_values(u, sol.z, l, sol.rho), st.bus, st.ptr,
                    st.idx),
    }
    rel, worst_abs = _hold_scatter(sums.values(), 1e-13,
                                   "bus_scatter MPEC f64")
    print("phase 1c: bus_scatter MPEC f64 "
          + ", ".join(f"{k} {tuple(v[0].shape)}" for k, v in sums.items())
          + f" -> {gd.nbus} buses: max rel diff {rel:.3e} (tol 1e-13), max "
          f"abs diff {worst_abs:.3e}, bit-identical reruns")
    return {"f64": dict(rel=rel, abs=worst_abs)}


def phase2b_ramp(dev, data, loads, T: int, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.models.mpacopf import ramp
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    out = {}
    for dtype in (torch.float64, torch.float32):
        par = Parameters(verbose=0, tron_step_cap=50)
        model = _mp_model(dev, data, loads, T, dtype, par)
        sol = MP.init_solution(model, 4e2, 4e4)
        # perturb the generator prox targets so the lanes spread
        rng = np.random.default_rng(0)
        v = sol.acopf.v
        noise = torch.as_tensor(rng.normal(0, 0.05, tuple(v.gen.shape)))
        sol = sol.replace(acopf=sol.acopf.replace(v=v.replace(
            gen=v.gen + noise.to(device=dev, dtype=dtype))))
        x0, xl, xu, params, lam0, mu0 = ramp.ramp_inputs(sol, model, 1)
        opts = ramp.ramp_tolerances(par, dtype)
        act = torch.ones(x0.shape[1], dtype=torch.bool, device=dev)

        def kernel():
            return tron_cuda.tron_alm_ramp(x0, xl, xu, params, lam0, mu0,
                                           **opts)

        def plain():
            return tron_cuda.tron_alm_ramp_plain(x0, xl, xu, params, lam0,
                                                 mu0, **opts)

        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = _tron_vs_plain("phase 2b: tron_alm_ramp", "tron_alm_ramp",
                                  kernel, plain, act, dtype, dev)
    return out


def qp_inputs(data, base=None) -> dict:
    """The QP of ``data`` linearized at ``base`` (an ``SqpBasePoint``), by
    default at the case's own operating point (the JAX package's qpsub
    benchmark, tools/model_bench.py)."""
    from exaadmm_tpu_torch.models.qpsub.sqp import (SqpBasePoint,
                                                    build_qp_inputs)
    from exaadmm_tpu_torch.utils.grid_data import build_grid_data
    if base is None:
        base = SqpBasePoint(pg=data.Pg0, qg=data.Qg0, vm=data.Vm, va=data.Va)
    return build_qp_inputs(data, build_grid_data(data), base)


def phase2c_qpsub(dev, data, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.qpsub import model as Q
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    qp = qp_inputs(data)
    out = {}
    for use_linelimit in (True, False):
        for dtype in (torch.float64, torch.float32):
            par = Parameters(verbose=0, tron_step_cap=50)
            model = Q.build_model(data, par, qp, use_linelimit=use_linelimit,
                                  dtype=dtype, device=dev)
            sol = model.one_level_reset(Q.init_solution(model, 4e3, 4e3))
            # perturb l and v of the lines so the lanes spread in difficulty
            rng = np.random.default_rng(0)
            b = sol.base

            def noise():
                return torch.as_tensor(rng.normal(
                    0, 0.05, tuple(b.l.line.shape))).to(device=dev,
                                                        dtype=dtype)

            sol = sol.replace(base=b.replace(
                l=b.l.replace(line=b.l.line + noise()),
                v=b.v.replace(line=b.v.line + noise())))
            x0, xl, xu, params, lam0, mu0, act = Q.qpsub_inputs(model, sol, 1)
            opts = Q.qpsub_tolerances(par, dtype, use_linelimit)

            def kernel():
                return tron_cuda.tron_alm_qpsub(x0, xl, xu, params, lam0, mu0,
                                                active0=act, **opts)

            def plain():
                return tron_cuda.tron_alm_qpsub_plain(
                    x0, xl, xu, params, lam0, mu0, active0=act, **opts)

            key = ("f64" if dtype == torch.float64 else "f32") + (
                "" if use_linelimit else "_nolimit")
            label = "phase 2c: tron_alm_qpsub" + (
                "" if use_linelimit else " without line limits")
            out[key] = _tron_vs_plain(label, "tron_alm_qpsub", kernel, plain,
                                      act, dtype, dev)
    return out


def phase3_case9(dev, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E

    _zero_launches()
    t0 = time.perf_counter()
    res = E.solve_acopf(CASE9, rho_pq=4e2, rho_va=4e4, outer_eps=2e-5,
                        outer_iterlim=25, verbose=0, device=dev)
    _sync(dev)
    launched = _launches()
    secs = time.perf_counter() - t0
    info = res.info
    pg = (res.solution.u.gen[:, 0] * 100.0).cpu().numpy()
    print(f"phase 3: case9 {info.status} outer {info.outer} (pin "
          f"{PIN_OUTER}) cumul {info.cumul} (pin {PIN_CUMUL}) obj "
          f"{info.objval!r} pg {np.round(pg, 3).tolist()} in {secs:.2f} s; "
          f"launches tron {launched['tron_alm_branch']} bus "
          f"{launched['bus_scatter']}")
    _check(info.status == "Solved", f"case9: status {info.status}")
    _check(5296.0 <= info.objval <= 5304.5, f"case9: obj {info.objval}")
    _check(bool(np.all(np.abs(pg - np.array([89.8, 134.32, 94.19])) <= 1.0)),
           f"case9: pg {pg}")
    _check(abs(info.outer - PIN_OUTER) <= 1, f"case9: outer {info.outer}")
    _check(abs(info.cumul - PIN_CUMUL) <= 0.02 * PIN_CUMUL,
           f"case9: cumul {info.cumul}")
    if on_card:
        _check(launched['tron_alm_branch'] == info.cumul + WARMUP,
               f"case9: {launched['tron_alm_branch']} TRON launches for "
               f"{info.cumul} inner iterations and the warm-up")
        _check(launched['bus_scatter'] >= info.cumul,
               f"case9: {launched['bus_scatter']} bus launches")
        _hooks_held("case9", launched, info.cumul, info.outer)
        _branch_io_launches("case9", launched)
    return dict(outer=info.outer, cumul=info.cumul, obj=info.objval,
                seconds=secs)


def _graph_ms(dev, fn, reps: int) -> float:
    """Device ms per replay of ``fn`` captured alone as a CUDA graph (the
    way a fused driver's body runs it); on the CPU the host's ms per
    call."""
    from exaadmm_tpu_torch.utils.timing import time_ms
    if dev.type != "cuda":
        return time_ms(fn, dev, reps)[0]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, dev, reps)[0]


def _max_abs(pairs) -> float:
    """The largest |a - b| over the pairs; equal entries (infinities among
    them) differ by 0."""
    return max(float((a - b).abs().masked_fill(a == b, 0).max())
               if a.numel() else 0.0 for a, b in pairs)


def _hook_state(model, iters: int):
    """``model``'s flat start after ``iters`` inner iterations and the next
    prestep and x update, through its own hooks at beta 1e3: every block
    of the state set."""
    from exaadmm_tpu_torch.models.acopf import model as M
    sol = M.init_solution(model, MAIN_KW["rho_pq"], MAIN_KW["rho_va"])
    for it in range(1, iters + 1):
        sol, _ = model.update_x(model.inner_prestep(sol), it)
        sol = model.update_xbar(sol)
        sol = model.update_z(sol, 1e3)
        sol = model.update_l(sol, 1e3)
        sol, _ = model.update_residual(sol, 1e3)
        if it == 2:
            sol = model.update_lz(sol, 1e3)
    sol, _ = model.update_x(model.inner_prestep(sol), iters + 1)
    return sol


def phase4h_hooks(dev, data, on_card: bool, iters: int = 3) -> dict:
    """The ACOPF hook kernels (``csrc/acopf_hooks.cu``) against their plain
    versions on phase 4's model after ``iters`` inner iterations, fp64:
    every elementwise kernel (generator; bus values, solve, writeback; z
    with beta as a device scalar and as a float, l, lz; the residual's rp
    and rd) bit-identical to its plain version and to itself on a second
    run; the residual's block sums and six scalars bit-identical to the
    torch reproduction of the kernels' fixed tree
    (``acopf_cuda.residual_partials_plain``, ``residual_final_plain``), to
    a second run, and to ``torch.sum``'s within 1e-13 of the sum of the
    terms' magnitudes (objective, auglag) and 1e-12 relative (the square
    roots); z in fp32 too. Device ms per launch of each kernel and of its
    plain version (the host kept ahead), each hook's plain and kernel
    forms eager and captured as a graph, the bounds of ``ops/bounds.py``,
    and the device ms of an empty kernel."""
    from exaadmm_tpu_torch.models.acopf import kernels as K
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.ops import acopf_cuda as A
    from exaadmm_tpu_torch.ops import bounds, bus_cuda
    from exaadmm_tpu_torch.utils.environment import Blocks, Parameters
    from exaadmm_tpu_torch.utils.timing import time_ms

    # the host queues every timed rep before the device starts them
    # (``utils/timing.py``), and the card's launch queue holds about a
    # thousand: a plain version, which launches up to ~120 kernels a call,
    # is timed over 4 reps, a kernels' hook (at most 5) over 100
    reps, hook_reps, plain_reps = (200, 100, 4) if on_card else (2, 2, 1)
    model = M.build_model(data, Parameters(verbose=0), device=dev)
    gd = model.grid
    sol = _hook_state(model, iters)
    dtype = gd.pgmin.dtype
    bt = torch.tensor(1e3, dtype=dtype, device=dev)
    ngen, nline, nbus = gd.ngen, gd.nline_padded, gd.nbus
    nb = A.residual_blocks(ngen, nline)
    u, v, z, l, rho, lz = sol.u, sol.v, sol.z, sol.l, sol.rho, sol.lz

    def gen_plain():
        return K.generator_update(u.gen, v.gen, z.gen, l.gen, rho.gen,
                                  model.pgmin_curr, model.pgmax_curr,
                                  gd.qgmin, gd.qgmax, model.c2_eff,
                                  model.c1_eff, gd.baseMVA)

    def gen_kernel():
        return A.generator_update(u.gen, v.gen, z.gen, l.gen, rho.gen,
                                  model.pgmin_curr, model.pgmax_curr,
                                  gd.qgmin, gd.qgmax, gd.c2, gd.c1,
                                  gd.baseMVA, obj_scale=model.par.obj_scale)

    arcs_p = K.bus_arc_values(u, z, l, rho, gd)
    gens_p = K.bus_gen_values(u, z, l, rho)
    agg = bus_cuda.bus_scatter(arcs_p, gd.arc_bus, gd.arc_ptr, gd.arc_idx)
    gsum = bus_cuda.bus_scatter(gens_p, gd.gen_bus, gd.gen_ptr, gd.gen_idx)
    wtm_p = K.bus_solve(agg, gsum, gd, gd.Pd, gd.Qd)
    rp_p, rd_p, sc_p = K.residual_update(sol, gd, bt)
    _, _, part_p = A.residual_partials_plain(sol, gd)

    def blocks_of(b):
        return [b.gen, b.line]

    # (kernel, plain, its outputs as a list of tensors)
    cases = {
        "acopf_generator": (gen_kernel, gen_plain, lambda r: [r]),
        "acopf_bus_values": (
            lambda: A.bus_values(u, z, l, rho, gd),
            lambda: (K.bus_arc_values(u, z, l, rho, gd),
                     K.bus_gen_values(u, z, l, rho)), list),
        "acopf_bus_solve": (lambda: A.bus_solve(agg, gsum, gd, gd.Pd, gd.Qd),
                            lambda: K.bus_solve(agg, gsum, gd, gd.Pd, gd.Qd),
                            lambda r: [r]),
        "acopf_bus_writeback": (
            lambda: A.bus_writeback(u, z, l, rho, wtm_p, gd),
            lambda: K.bus_writeback(u, z, l, rho, wtm_p, gd), blocks_of),
        "acopf_z": (lambda: A.z_update(u, v, l, rho, lz, bt),
                    lambda: K.z_update(u, v, l, rho, lz, bt), blocks_of),
        "acopf_l": (lambda: A.l_update(z, lz, bt),
                    lambda: K.l_update(z, lz, bt), blocks_of),
        "acopf_lz": (lambda: A.lz_update(z, lz, bt, 1e12),
                     lambda: K.lz_update(z, lz, bt, 1e12), blocks_of),
        "acopf_residual_partials": (
            lambda: A.residual_partials(sol, gd),
            lambda: A.residual_partials_plain(sol, gd),
            lambda r: blocks_of(r[0]) + blocks_of(r[1]) + [r[2]]),
        "acopf_residual_final": (
            lambda: A.residual_final(part_p[:A.LINE_SUMS],
                                     part_p[A.LINE_SUMS:], bt),
            lambda: A.residual_final_plain(part_p[:A.LINE_SUMS],
                                           part_p[A.LINE_SUMS:], bt),
            lambda r: [r]),
    }
    # beta by value (the host loop's float) and the fp32 instance of z
    sol32 = sol.to(torch.float32)
    extra = {
        "acopf_z, beta a float": (
            lambda: A.z_update(u, v, l, rho, lz, 1e3),
            lambda: K.z_update(u, v, l, rho, lz, 1e3), blocks_of),
        "acopf_z f32": (
            lambda: A.z_update(sol32.u, sol32.v, sol32.l, sol32.rho,
                               sol32.lz, bt.float()),
            lambda: K.z_update(sol32.u, sol32.v, sol32.l, sol32.rho,
                               sol32.lz, bt.float()), blocks_of),
        "acopf_bus_update (the hook)": (
            lambda: A.bus_update(u, z, l, rho, gd),
            lambda: K.bus_update(u, z, l, rho, gd), blocks_of),
    }

    # each hook into the buffers a fused loop's carry passes it (fresh
    # copies of the state's, generator's over its own input u.gen), which
    # it must return; the residual's scalars into an fp64 (6,) buffer, and
    # from fp32 block sums too
    def copy_of(t):
        if isinstance(t, tuple):
            return tuple(copy_of(x) for x in t)
        if isinstance(t, Blocks):
            return Blocks(gen=t.gen.clone(), line=t.line.clone())
        return t.clone()

    def into(hook, dst):
        def run():
            d = copy_of(dst)
            r = hook(d)
            if isinstance(r, tuple):   # rp, rd, the scalars' views of d[2]
                ok = (r[0] is d[0] and r[1] is d[1]
                      and r[2]["primres"].data_ptr() == d[2].data_ptr())
            else:
                ok = r is d
            _check(ok, "phase 4h: a hook given out returned other tensors")
            return r
        return run

    def scalars_of(r):
        return blocks_of(r[0]) + blocks_of(r[1]) + [
            torch.stack([r[2][k] for k in A.SCALARS])]

    six = torch.zeros(len(A.SCALARS), dtype=torch.float64, device=dev)
    p32 = part_p.float()
    extra.update({
        "acopf_generator into u.gen": (
            into(lambda d: A.generator_update(
                d, v.gen, z.gen, l.gen, rho.gen, model.pgmin_curr,
                model.pgmax_curr, gd.qgmin, gd.qgmax, gd.c2, gd.c1,
                gd.baseMVA, obj_scale=model.par.obj_scale, out=d), u.gen),
            gen_plain, lambda r: [r]),
        "acopf_bus_update into v": (
            into(lambda d: A.bus_update(u, z, l, rho, gd, out=d), v),
            lambda: K.bus_update(u, z, l, rho, gd), blocks_of),
        "acopf_z into z": (
            into(lambda d: A.z_update(u, v, l, rho, lz, bt, out=d), z),
            lambda: K.z_update(u, v, l, rho, lz, bt), blocks_of),
        "acopf_l into l": (
            into(lambda d: A.l_update(z, lz, bt, out=d), l),
            lambda: K.l_update(z, lz, bt), blocks_of),
        "acopf_residual_final f32 into an fp64 buffer": (
            into(lambda d: A.residual_final(
                p32[:A.LINE_SUMS], p32[A.LINE_SUMS:], bt.float(), out=d),
                six),
            lambda: A.residual_final_plain(
                p32[:A.LINE_SUMS], p32[A.LINE_SUMS:], bt.float()).double(),
            lambda r: [r]),
        "acopf_residual_update into rp, rd and an fp64 buffer": (
            into(lambda d: A.residual_update(sol, gd, bt, out=d),
                 (sol.rp, sol.rd, six)),
            lambda: A.residual_update(sol, gd, bt), scalars_of),
    })
    out = {}
    for name, (kern, plain, outs) in {**cases, **extra}.items():
        got, again, ref = outs(kern()), outs(kern()), outs(plain())
        _sync(dev)
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, ref))
        rerun = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        _check(same and rerun, f"phase 4h: {name}: bit-identical to the "
                               f"plain version {same}, to a rerun {rerun}")
        if name not in cases:
            print(f"phase 4h: {name}: bit-identical to its plain version "
                  f"and to a rerun")
            continue
        ms, enq = time_ms(kern, dev, reps)
        plain_ms, plain_enq = time_ms(plain, dev, plain_reps)
        nbytes = bounds.hook_bytes(
            name, ngen, nline, nbus, 8, nb,
            scalar_tensor=name in ("acopf_z", "acopf_l", "acopf_lz",
                                   "acopf_residual_final"))
        bound_ms, bound_by = bounds.bound(
            nbytes["total"], bounds.hook_ops(name, ngen, nline, nbus, nb))
        out[name] = dict(ms=ms, enqueue_ms=enq, plain_ms=plain_ms,
                         plain_enqueue_ms=plain_enq, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes["total"],
                         max_abs_err=_max_abs(zip(got, ref)))
        print(f"phase 4h: {name}: bit-identical to its plain version and to "
              f"a rerun; device ms per launch {ms:.5f} (plain "
              f"{plain_ms:.5f}), bound {bound_ms:.5f} ({bound_by}, "
              f"{nbytes['total']} B); host enqueue ms per call {enq:.5f} "
              f"(plain {plain_enq:.5f})")

    # the residual's scalars against torch.sum: 1e-12 relative on the
    # square roots; objval and auglag within 1e-13 of their terms'
    # magnitudes
    sc_k = A.residual_update(sol, gd, bt)[2]
    m = gd.line_mask[:, None]
    rp = rp_p
    pg = u.gen[:, 0] * gd.baseMVA
    obj_mag = torch.sum((gd.c2 * (pg * pg)).abs() + (gd.c1 * pg).abs()
                        + gd.c0.abs())

    def mag(a, b):
        return (torch.sum((a.gen * b.gen).abs())
                + torch.sum((a.line * b.line * m).abs()))

    rr = Blocks(gen=rp.gen * rp.gen, line=rp.line * rp.line)
    aug_mag = (obj_mag + mag(lz, z) + 0.5 * bt * mag(z, z) + mag(l, rp)
               + 0.5 * mag(rho, rr))
    worst = {}
    for k in A.SCALARS:
        a, b = float(sc_k[k]), float(sc_p[k])
        if k == "objval":
            err, lim = abs(a - b), 1e-13 * float(obj_mag)
        elif k == "auglag":
            err, lim = abs(a - b), 1e-13 * float(aug_mag)
        else:
            err, lim = abs(a - b), 1e-12 * abs(b)
        _check(err <= lim, f"phase 4h: residual {k} {a!r} against torch.sum's"
                           f" {b!r}: {err:.3e} > {lim:.3e}")
        worst[k] = err
    out["acopf_residual_final"]["max_abs_err"] = max(worst.values())
    print("phase 4h: residual scalars against torch.sum's: "
          + ", ".join(f"{k} {worst[k]:.3e}" for k in A.SCALARS)
          + f" (objval within 1e-13 x {float(obj_mag):.4e}, auglag within "
          f"1e-13 x {float(aug_mag):.4e}, the square roots 1e-12 relative)")

    # each hook whole: the plain form (the old hook) and the kernels' form,
    # eager and captured as a graph
    hooks = {
        "x (generator)": (gen_plain, gen_kernel),
        "xbar": (lambda: K.bus_update(u, z, l, rho, gd),
                 lambda: A.bus_update(u, z, l, rho, gd)),
        "z": (lambda: K.z_update(u, v, l, rho, lz, bt),
              lambda: A.z_update(u, v, l, rho, lz, bt)),
        "l": (lambda: K.l_update(z, lz, bt),
              lambda: A.l_update(z, lz, bt)),
        "lz": (lambda: K.lz_update(z, lz, bt, 1e12),
               lambda: A.lz_update(z, lz, bt, 1e12)),
        "residual": (lambda: K.residual_update(sol, gd, bt),
                     lambda: A.residual_update(sol, gd, bt)),
    }
    out["hooks"] = {}
    for name, (plain, kern) in hooks.items():
        r = dict(plain_eager=time_ms(plain, dev, plain_reps)[0],
                 plain_graph=_graph_ms(dev, plain, reps),
                 kernel_eager=time_ms(kern, dev, hook_reps)[0],
                 kernel_graph=_graph_ms(dev, kern, reps))
        out["hooks"][name] = r
        print(f"phase 4h: hook {name}: device ms plain {r['plain_eager']:.5f}"
              f" eager, {r['plain_graph']:.5f} in a graph; kernels "
              f"{r['kernel_eager']:.5f} eager, {r['kernel_graph']:.5f} in a "
              f"graph")
    floor = None
    if on_card:
        floor = time_ms(lambda: A.launch_floor(dev), dev, reps)[0]
    out["floor_ms"] = floor
    print(f"phase 4h: {data.case} ({nbus} buses, {nline} lines, {ngen} gens),"
          f" {iters} inner iterations in; an empty kernel's device ms per "
          f"launch: {'not measured on the CPU' if floor is None else f'{floor:.5f}'}")
    return out


def phase4_main(dev, data, on_card: bool, use_linelimit: bool = True,
                label: str = "phase 4", outer_iterlim: int = 3) -> dict:
    """The single-period path at full size; without line limits (phase 8)
    every line is a lane of the polar kernel instead of the branch one."""
    import exaadmm_tpu_torch as E

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    with _loops_built() as built:
        res = E.solve_acopf(data.case, data=data,
                            use_linelimit=use_linelimit, device=dev,
                            **dict(MAIN_KW, outer_iterlim=outer_iterlim))
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = _launches()
    info = res.info
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rate = info.cumul / info.time_overall
    what = "" if use_linelimit else ", no line limits"
    print(f"{label}: {data.case} ({data.nbus} buses, {data.nline} lines, "
          f"{data.ngen} gens{what}) fp64: {info.outer} outer, {info.cumul} "
          f"inner; ADMM loop {info.time_overall:.3f} s = {rate:.2f} inner "
          f"it/s, whole call with setup {secs:.3f} s = "
          f"{info.cumul / secs:.2f} inner it/s; mismatch "
          f"{info.mismatch!r} primres {info.primres!r} obj {info.objval!r}; "
          f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    for name in ("mismatch", "primres", "dualres", "objval", "norm_z_curr"):
        _check(bool(np.isfinite(getattr(info, name))),
               f"{label}: {name} not finite")
    _check(bool(torch.isfinite(res.solution.u.line).all()),
           f"{label}: u not finite")
    if on_card:
        lane = "tron_alm_branch" if use_linelimit else "tron_alm_polar"
        _check(launches[lane] == info.cumul + WARMUP
               and sum(launches.values()) == launches[lane]
               + launches["bus_scatter"] + launches["graph_loop"]
               + sum(launches[k] for k in HOOK_KERNELS)
               + sum(launches[k] for k in BRANCH_IO_KERNELS),
               f"{label}: TRON launches {launches}")
        _hooks_held(label, launches, info.cumul, info.outer)
        _branch_io_launches(label, launches)
        _check(launches["graph_loop"] == _loop_trips(info),
               f"{label}: loop launches {launches}")
        _check(launches["bus_scatter"] == 2 * (info.cumul + WARMUP),
               f"{label}: bus launches {launches}")
        # the hooks write into the loop's carry: the inner body's only
        # copies are z_prev's two blocks and the new line rows of u
        _check(len(built) == 1, f"{label}: {len(built)} loops built")
        inner_nodes = built[0].node_types()[1]
        print(f"{label}: the inner body's nodes {inner_nodes}")
        _check(inner_nodes.get("memcpy", 0) <= 3,
               f"{label}: the inner body holds "
               f"{inner_nodes.get('memcpy', 0)} memcpy nodes, more than "
               f"z_prev's 2 and u's line rows: {inner_nodes}")
    return dict(launches=launches, rate=rate, seconds=secs,
                mismatch=info.mismatch, peak=peak, outer=info.outer,
                cumul=info.cumul, obj=info.objval, status=info.status)


def phase3g_case118(dev, on_card: bool, outer_iterlim: int = 25) -> dict:
    """case118 at the reference's settings; a rehearsal may cut
    ``outer_iterlim``, and then only finiteness is held."""
    import exaadmm_tpu_torch as E

    _zero_launches()
    t0 = time.perf_counter()
    res = E.solve_acopf(CASE118, outer_iterlim=outer_iterlim, rho_pq=4e2,
                        rho_va=4e4, outer_eps=2e-5, verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    info = res.info
    launches = _launches()
    outer, cumul, obj = CASE118_PIN
    print(f"phase 3g: case118 ({res.data.nbus} buses, {res.data.nline} "
          f"lines, {res.data.ngen} gens) {info.status} outer {info.outer} "
          f"(CPU {outer}) cumul {info.cumul} (CPU {cumul}) obj "
          f"{info.objval!r} (rel diff to the CPU's "
          f"{abs(info.objval - obj) / obj:.2e}, to the reference's "
          f"{abs(info.objval - CASE118_REFERENCE_OBJ) / CASE118_REFERENCE_OBJ:.2e}"
          f") in {secs:.2f} s ({info.cumul / info.time_overall:.1f} inner "
          f"it/s in the ADMM loop); launches {launches}")
    _check(bool(np.isfinite(info.objval))
           and bool(torch.isfinite(res.solution.u.line).all()),
           "case118: not finite")
    if outer_iterlim >= 25:
        _near_pin("case118", info, outer, cumul, obj)
        _check(abs(info.objval - CASE118_REFERENCE_OBJ)
               <= 1e-4 * CASE118_REFERENCE_OBJ,
               f"case118: obj {info.objval!r} against the reference")
    if on_card:
        _check(launches["tron_alm_branch"] == info.cumul + WARMUP
               and launches["bus_scatter"] == 2 * (info.cumul + WARMUP),
               f"case118: launches {launches} for {info.cumul} inner "
               f"iterations")
        _branch_io_launches("case118", launches)
    return dict(outer=info.outer, cumul=info.cumul, obj=info.objval,
                seconds=secs)


def phase3h_checkpoint(dev, on_card: bool) -> dict:
    """Save after 5 outer iterations of case9, load into a fresh flat start
    on ``dev`` (every leaf bit-equal) and resume to Solved."""
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.algorithms.admm_two_level import admm_two_level
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.utils.checkpoint import _leaves
    from exaadmm_tpu_torch.utils.environment import Parameters

    data = E.opf_loaddata(CASE9, verbose=0)
    par = Parameters(verbose=0, outer_iterlim=5, outer_eps=2e-5)
    model = M.build_model(data, par, device=dev)
    sol5, info5 = admm_two_level(model, M.init_solution(model, 4e2, 4e4))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        E.save_solution(path, sol5, meta={"outer": info5.outer,
                                          "beta": par.beta})
        size = os.path.getsize(path)
        restored, meta = E.load_solution(path,
                                         M.init_solution(model, 4e2, 4e4))
    pairs = list(zip(_leaves(sol5), _leaves(restored)))
    for (name, a), (_, b) in pairs:
        _check(b.device == a.device and b.dtype == a.dtype
               and bool(torch.equal(a, b)), f"checkpoint: leaf {name}")
    _check(meta["outer"] == 5, f"checkpoint: meta {meta}")
    par2 = Parameters(verbose=0, outer_iterlim=20, outer_eps=2e-5,
                      initial_beta=meta["beta"])
    model2 = M.build_model(data, par2, device=dev)
    _, info = admm_two_level(model2, restored)
    print(f"phase 3h: checkpoint of case9 after {info5.outer} outer / "
          f"{info5.cumul} inner: {len(pairs)} leaves, {size} B, every leaf "
          f"bit-equal on {restored.u.line.device}; resumed with beta "
          f"{meta['beta']:.3e}: {info.status} after {info.outer} more outer "
          f"/ {info.cumul} inner, obj {info.objval!r}")
    _check(info.status == "Solved", f"checkpoint resume: {info.status}")
    _check(5296.0 <= info.objval <= 5304.5,
           f"checkpoint resume: obj {info.objval}")
    return dict(leaves=len(pairs), outer=info.outer, cumul=info.cumul,
                obj=info.objval)


@contextlib.contextmanager
def _one_rank_mesh(dev, on_card: bool):
    """A process group of this one process (NCCL on the card, gloo on the
    CPU) and its mesh, its communicator set up by a first collective."""
    from exaadmm_tpu_torch.parallel import distributed, sharding

    distributed.initialize(f"tcp://127.0.0.1:{distributed.free_port()}",
                           world_size=1, rank=0, device=dev, timeout=120.0)
    try:
        mesh = sharding.make_mesh()
        _check(mesh.size == 1 and mesh.group is not None
               and mesh.backend == ("nccl" if on_card else "gloo"),
               f"mesh of one rank: {mesh}")
        sharding.all_reduce_sum(torch.zeros(8, device=dev), mesh)
        _sync(dev)
        yield mesh
    finally:
        distributed.shutdown()


@contextlib.contextmanager
def _loops_built():
    """The ``GraphLoop``s built inside the block, in a list."""
    from exaadmm_tpu_torch.ops import graph_loop
    built = []
    init = graph_loop.GraphLoop.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    graph_loop.GraphLoop.__init__ = recorded
    try:
        yield built
    finally:
        graph_loop.GraphLoop.__init__ = init


#: the node types a conditional WHILE body holds (CUDA 12.4+); the loop
#: graph holds a body's event nodes as edges (``csrc/graph_loop.cu``)
BODY_NODES = {"kernel", "memcpy", "memset", "empty", "graph", "conditional"}
EVENT_NODES = {"wait_event", "event_record"}


def phase9a_mesh_one_rank(dev, data, on_card: bool, base: dict) -> dict:
    """Phase 4's solve through the mesh path at world size 1 (NCCL on the
    card, gloo on the CPU), against phase 4's result ``base``: the fused
    driver (the collectives captured into its graph on the card), then the
    host loop over the same mesh, bit-identical."""
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.algorithms.carry import leaves
    from exaadmm_tpu_torch.parallel import sharding

    warm = WARMUP if on_card else 0
    with _one_rank_mesh(dev, on_card) as mesh:
        _zero_launches()
        sharding.reset_counts()
        sharding.log = []
        t0 = time.perf_counter()
        with _loops_built() as built:
            res = E.solve_acopf(data.case, data=data, mesh=mesh, device=dev,
                                **MAIN_KW)
        _sync(dev)
        secs = time.perf_counter() - t0
        log, sharding.log = sharding.log, None
        launches = _launches()
        counts = dict(sharding.counts)
        with _host_loop():
            host = E.solve_acopf(data.case, data=data, mesh=mesh, device=dev,
                                 **MAIN_KW)
        _sync(dev)
    info = res.info
    reduces = counts["all_reduce_sum"] + counts["all_reduce_max"]
    # the warm-up's collectives run on the host before the capture
    per_it = (reduces - 4 * warm) / info.cumul
    one_it = [e for e in log if e[0] != "all_gather"][:4]
    nbytes = sum(b for _, _, b in one_it)
    rate = info.cumul / info.time_overall
    rate_host = host.info.cumul / host.info.time_overall
    pairs = list(zip(leaves(res.solution), leaves(host.solution),
                     strict=True))
    same = all(bool(torch.equal(a, b)) for a, b in pairs)
    nodes, rewritten, device_reduces = "not built (CPU)", 0, None
    if on_card:
        _check(len(built) == 1, f"mesh of one rank: {len(built)} loops built")
        loop = built[0]
        nodes, rewritten = loop.node_types(), loop.rewritten
        slots = loop.counts.adds
        device_reduces = {k: int(loop.counts.values[slots[k][0]])
                          for k in ("all_reduce_sum", "all_reduce_max")}
        found = set().union(*nodes)
        _check(found - EVENT_NODES <= BODY_NODES
               and rewritten == sum(n.get(k, 0) for n in nodes
                                    for k in EVENT_NODES),
               f"mesh of one rank: body nodes {nodes}, {rewritten} event "
               f"nodes made edges")
    print(f"phase 9a: {data.case} over a mesh of 1 rank ({mesh.backend}), "
          f"fused: {info.outer} outer, {info.cumul} inner (phase 4: "
          f"{base['outer']} / {base['cumul']}), obj {info.objval!r} (phase "
          f"4: {base['obj']!r}); {per_it:.2f} all-reduces per inner "
          f"iteration (on the device: {device_reduces}), {nbytes} B each "
          f"iteration, {counts['all_gather']} gathers after the loop; loop "
          f"bodies' nodes {nodes}, {rewritten} event nodes made edges; "
          f"ADMM loop {info.time_overall:.3f} s = {rate:.2f} inner it/s "
          f"(phase 4 fused: {base['rate']:.2f}; this mesh's host loop: "
          f"{rate_host:.2f}), build {info.time_build * 1e3:.1f} ms, pool "
          f"{info.graph_pool_bytes / 2**20:.1f} MiB, whole call {secs:.3f} "
          f"s; host loop {host.info.outer} / {host.info.cumul}, "
          f"{len(pairs)} solution tensors bit-identical: {same}; launches "
          f"{launches}")
    _check((info.status, info.outer, info.cumul) == (
        base["status"], base["outer"], base["cumul"]),
        f"mesh of one rank: {info.status} {info.outer} / {info.cumul}")
    _check(info.objval == base["obj"],
           f"mesh of one rank: obj {info.objval!r} != {base['obj']!r}")
    _check(reduces == 4 * (info.cumul + warm),
           f"mesh of one rank: {reduces} all-reduces for {info.cumul} inner "
           f"iterations")
    _check([k for k, _, _ in one_it] == ["all_reduce_sum", "all_reduce_max",
                                         "all_reduce_sum", "all_reduce_sum"],
           f"mesh of one rank: collectives {one_it}")
    _check(same and (host.info.outer, host.info.cumul, host.info.objval) == (
        info.outer, info.cumul, info.objval),
        "mesh of one rank: the fused solve differs from the host loop's")
    _check(res.solution.u.line.shape[0] == data.nline,
           "mesh of one rank: line count")
    if on_card:
        _check(device_reduces == {"all_reduce_sum": 3 * info.cumul,
                                  "all_reduce_max": info.cumul},
               f"mesh of one rank: device counts {device_reduces}")
        _check(launches["tron_alm_branch"] == info.cumul + WARMUP
               and launches["bus_scatter"] == 2 * (info.cumul + WARMUP)
               and launches["graph_loop"] == _loop_trips(info),
               f"mesh of one rank: launches {launches}")
        _hooks_held("mesh of one rank", launches, info.cumul, info.outer)
        _branch_io_launches("mesh of one rank", launches)
    return dict(launches=launches, rate=rate, rate_host=rate_host,
                outer=info.outer, cumul=info.cumul, obj=info.objval,
                per_it=per_it, bytes_per_it=nbytes,
                build_ms=info.time_build * 1e3,
                pool_mib=info.graph_pool_bytes / 2**20, nodes=nodes,
                rewritten=rewritten)


def _two_rank_solves(mesh, dev, data):
    """What a rank of phase 9b runs: case9 over the mesh, then phase 4's
    configuration; rank 0's numbers go back."""
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.parallel import sharding

    small = E.solve_acopf(CASE9, mesh=mesh, device=dev, **SHARD9_KW)
    _sync(dev)
    _zero_launches()
    sharding.reset_counts()
    t0 = time.perf_counter()
    res = E.solve_acopf(data.case, data=data, mesh=mesh, device=dev,
                        **MAIN_KW)
    _sync(dev)
    secs = time.perf_counter() - t0

    def summary(r):
        i = r.info
        return dict(status=i.status, outer=i.outer, cumul=i.cumul,
                    obj=i.objval, loop=i.time_overall,
                    lines=tuple(r.solution.u.line.shape),
                    finite=bool(torch.isfinite(r.solution.u.line).all()))

    return dict(small=summary(small), big=summary(res), seconds=secs,
                launches=_launches(), counts=dict(sharding.counts),
                backend=mesh.backend, device=str(dev))


def phase9b_two_ranks(dev, data, on_card: bool, base: dict) -> dict:
    """Two ranks sharing ``dev`` over gloo against the one-process runs:
    case9 (computed here) and phase 4's result ``base``."""
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.parallel.distributed import spawn_ranks

    one = E.solve_acopf(CASE9, device=dev, **SHARD9_KW).info
    t0 = time.perf_counter()
    got = spawn_ranks(_two_rank_solves, (data,), nprocs=RANKS,
                      device=str(dev),
                      timeout=120.0, join_timeout=600.0,
                      threads=torch.get_num_threads())
    secs = time.perf_counter() - t0
    small, big = got["small"], got["big"]
    rel = abs(small["obj"] - one.objval) / abs(one.objval)
    rate = big["cumul"] / big["loop"]
    reduces = got["counts"]["all_reduce_sum"] + got["counts"]["all_reduce_max"]
    print(f"phase 9b: 2 ranks on {got['device']} over {got['backend']} in "
          f"{secs:.1f} s with their start: case9 {small['outer']} outer / "
          f"{small['cumul']} inner (one process {one.outer} / {one.cumul}), "
          f"obj {small['obj']!r} (rel diff {rel:.2e}), lines "
          f"{small['lines']}; {data.case} {big['outer']} outer / "
          f"{big['cumul']} inner (phase 4: {base['outer']} / "
          f"{base['cumul']}), obj {big['obj']!r} (phase 4: {base['obj']!r}),"
          f" ADMM loop {big['loop']:.3f} s = {rate:.2f} inner it/s (phase "
          f"4: {base['rate']:.2f}), {reduces / big['cumul']:.2f} all-reduces"
          f" per inner iteration; rank 0's launches {got['launches']}")
    _check(got["backend"] == "gloo", f"two ranks: backend {got['backend']}")
    _check((small["outer"], small["cumul"]) == (one.outer, one.cumul),
           f"two ranks, case9: {small['outer']} / {small['cumul']}")
    _check(rel <= 1e-8, f"two ranks, case9: obj {small['obj']!r}")
    _check(small["lines"] == (10, 8) and small["finite"],
           f"two ranks, case9: lines {small['lines']}")
    _check(abs(big["cumul"] - base["cumul"]) <= 0.02 * base["cumul"]
           and big["outer"] == base["outer"],
           f"two ranks, {data.case}: {big['outer']} / {big['cumul']}")
    _check(abs(big["obj"] - base["obj"]) <= 1e-6 * abs(base["obj"])
           and big["finite"], f"two ranks, {data.case}: obj {big['obj']!r}")
    _check(reduces == 4 * big["cumul"],
           f"two ranks: {reduces} all-reduces for {big['cumul']} inner "
           f"iterations")
    if on_card:
        _check(got["launches"]["tron_alm_branch"] == big["cumul"]
               and got["launches"]["bus_scatter"] == 2 * big["cumul"],
               f"two ranks: launches {got['launches']}")
        _branch_io_launches("two ranks", got["launches"])
    return dict(launches=got["launches"], rate=rate, cumul=big["cumul"],
                obj=big["obj"], case9=small)


def phase3d_case9_polar(dev, on_card: bool) -> dict:
    """case9 without line limits: the polar kernel, once per inner
    iteration, and no branch kernel."""
    import exaadmm_tpu_torch as E

    _zero_launches()
    t0 = time.perf_counter()
    res = E.solve_acopf(CASE9, rho_pq=4e2, rho_va=4e4, outer_eps=2e-4,
                        outer_iterlim=25, use_linelimit=False, verbose=0,
                        device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    info = res.info
    launches = _launches()
    print(f"phase 3d: case9 without line limits {info.status} outer "
          f"{info.outer} (pin {POLAR_PIN_OUTER}) cumul {info.cumul} (pin "
          f"{POLAR_PIN_CUMUL}) obj {info.objval!r} in {secs:.2f} s; launches "
          f"{launches}")
    _check(info.status == "Solved", f"case9 polar: status {info.status}")
    _check(abs(info.outer - POLAR_PIN_OUTER) <= 1,
           f"case9 polar: outer {info.outer}")
    _check(abs(info.cumul - POLAR_PIN_CUMUL) <= 0.02 * POLAR_PIN_CUMUL,
           f"case9 polar: cumul {info.cumul}")
    _check(info.max_cviol == 0.0, f"case9 polar: cviol {info.max_cviol}")
    if on_card:
        _check(launches["tron_alm_polar"] == info.cumul + WARMUP
               and launches["tron_alm_branch"] == 0,
               f"case9 polar: launches {launches} for {info.cumul} inner "
               f"iterations")
        _hooks_held("case9 polar", launches, info.cumul, info.outer)
        _branch_io_launches("case9 polar", launches)
    return dict(outer=info.outer, cumul=info.cumul, obj=info.objval,
                seconds=secs)


def phase3b_case9_mpacopf(dev, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E

    _zero_launches()
    t0 = time.perf_counter()
    with _no_plain_mp_hooks(on_card):
        res = E.solve_mpacopf(CASE9, DEMAND9, start_period=1, end_period=3,
                              rho_pq=4e2, rho_va=4e4, outer_iterlim=30,
                              outer_eps=2e-4, warm_start=False, verbose=0,
                              device=dev)
    _sync(dev)
    launched = _launches()
    secs = time.perf_counter() - t0
    info = res.info
    rel = abs(info.objval - MP_PIN_OBJ) / MP_PIN_OBJ
    print(f"phase 3b: case9 x 3 periods {info.status} outer {info.outer} "
          f"(pin {MP_PIN_OUTER}) cumul {info.cumul} (pin {MP_PIN_CUMUL}) obj "
          f"{info.objval!r} (rel diff {rel:.2e}) err_ramp {res.err_ramp:.3e} "
          f"in {secs:.2f} s; launches branch {launched['tron_alm_branch']} "
          f"ramp {launched['tron_alm_ramp']} bus {launched['bus_scatter']}")
    _check(info.status == "Solved", f"case9 mp: status {info.status}")
    _check(abs(info.outer - MP_PIN_OUTER) <= 1, f"case9 mp: outer {info.outer}")
    _check(abs(info.cumul - MP_PIN_CUMUL) <= 0.02 * MP_PIN_CUMUL,
           f"case9 mp: cumul {info.cumul}")
    _check(rel <= 1e-6, f"case9 mp: obj {info.objval}")
    _check(res.err_ramp <= 1e-3, f"case9 mp: err_ramp {res.err_ramp}")
    if on_card:
        _check(launched['tron_alm_branch'] == info.cumul + WARMUP
               and launched['tron_alm_ramp'] == info.cumul + WARMUP,
               f"case9 mp: {launched['tron_alm_branch']} branch and "
               f"{launched['tron_alm_ramp']} ramp launches for {info.cumul} "
               f"inner iterations")
        _check(launched['bus_scatter'] == 2 * (info.cumul + WARMUP),
               f"case9 mp: {launched['bus_scatter']} bus launches")
        _branch_io_launches("case9 mp", launched)
        _mp_hooks_held("case9 mp", launched, info.cumul, info.outer, 3)

    # one period: no ramp batch, so no ramp launch
    _zero_launches()
    with _no_plain_mp_hooks(on_card):
        one = E.solve_mpacopf(CASE9, DEMAND9, end_period=1, outer_iterlim=1,
                              inner_iterlim=5, warm_start=False, verbose=0,
                              device=dev)
    _sync(dev)
    launched = _launches()
    print(f"phase 3b: case9 x 1 period, {one.info.cumul} inner: launches "
          f"branch {launched['tron_alm_branch']} ramp "
          f"{launched['tron_alm_ramp']} bus {launched['bus_scatter']}")
    _check(bool(torch.isfinite(one.solution.acopf.u.gen).all()),
           "case9 x 1 period: u not finite")
    if on_card:
        _check(launched['tron_alm_ramp'] == 0
               and launched['tron_alm_branch'] == one.info.cumul + WARMUP,
               f"case9 x 1 period: {launched['tron_alm_branch']} branch "
               f"and "
               f"{launched['tron_alm_ramp']} ramp launches for "
               f"{one.info.cumul} inner iterations")
        _mp_hooks_held("case9 x 1 period", launched, one.info.cumul,
                       one.info.outer, 1)
    return dict(outer=info.outer, cumul=info.cumul, obj=info.objval,
                err_ramp=res.err_ramp, seconds=secs)


def phase5_mpacopf(dev, data, loads, T: int, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    with _no_plain_mp_hooks(on_card):
        res = E.solve_mpacopf(data.case, data=data, loads=loads,
                              end_period=T, rho_pq=4e2, rho_va=4e4,
                              outer_iterlim=3, inner_iterlim=50,
                              outer_eps=0.0, warm_start=False, verbose=0,
                              device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = _launches()
    info = res.info
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rate = info.cumul / info.time_overall
    print(f"phase 5: {data.case} ({data.nbus} buses, {data.nline} lines, "
          f"{data.ngen} gens) x {T} periods fp64: {info.outer} outer, "
          f"{info.cumul} inner; ADMM loop {info.time_overall:.3f} s = "
          f"{rate:.2f} inner it/s, whole call with setup {secs:.3f} s = "
          f"{info.cumul / secs:.2f} inner it/s; mismatch {info.mismatch!r} primres {info.primres!r} obj "
          f"{info.objval!r} err_ramp {res.err_ramp!r}; peak device memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}")
    for name in ("mismatch", "primres", "dualres", "objval", "norm_z_curr"):
        _check(bool(np.isfinite(getattr(info, name))),
               f"multi-period path: {name} not finite")
    _check(bool(np.isfinite(res.err_ramp)), "multi-period path: err_ramp")
    _check(bool(torch.isfinite(res.solution.acopf.u.line).all()),
           "multi-period path: u not finite")
    if on_card:
        _check(launches["tron_alm_branch"] == info.cumul + WARMUP
               and launches["tron_alm_ramp"] == info.cumul + WARMUP
               and launches["tron_alm_qpsub"] == 0,
               f"multi-period path: TRON launches {launches}")
        _check(launches["bus_scatter"] == 2 * (info.cumul + WARMUP)
               and launches["graph_loop"] == _loop_trips(info),
               f"multi-period path: bus and loop launches {launches}")
        _branch_io_launches("multi-period path", launches)
        _mp_hooks_held("multi-period path", launches, info.cumul, info.outer,
                       T)
    return dict(launches=launches, rate=rate, seconds=secs,
                mismatch=info.mismatch, err_ramp=res.err_ramp, peak=peak)


def _mp_hook_state(model, iters: int, seed: int = 3):
    """``model``'s flat start after ``iters`` inner iterations and the next
    prestep and x update, through its own hooks at beta 1e3 (every block of
    the state and the ramp state set), then the generator rows of u and v
    and the ramp's u perturbed by N(0, 0.5) and its s by N(0, 0.05) from
    numpy seed ``seed``, so the pack's and the unpack's clamps bind on both
    sides."""
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    sol = MP.init_solution(model, 4e2, 4e4)
    for it in range(1, iters + 1):
        sol, _ = model.update_x(model.inner_prestep(sol), it)
        sol = model.update_xbar(sol)
        sol = model.update_z(sol, 1e3)
        sol = model.update_l(sol, 1e3)
        sol, _ = model.update_residual(sol, 1e3)
        if it == 2:
            sol = model.update_lz(sol, 1e3)
    sol, _ = model.update_x(model.inner_prestep(sol), iters + 1)
    rng = np.random.default_rng(seed)

    def noisy(x, sd):
        return x + torch.as_tensor(rng.normal(0, sd, tuple(x.shape)),
                                   dtype=x.dtype, device=x.device)

    ac, rp = sol.acopf, sol.ramp
    return sol.replace(
        acopf=ac.replace(u=ac.u.replace(gen=noisy(ac.u.gen, 0.5)),
                         v=ac.v.replace(gen=noisy(ac.v.gen, 0.5))),
        ramp=rp.replace(u=noisy(rp.u, 0.5), s=noisy(rp.s, 0.05)))


def _mp_hook_cases(model, sol, it):
    """Every multi-period hook kernel's (kernel, plain) calls on one batch,
    by kernel name, and the whole bus update; the unpack reads the ramp
    kernel's result on the pack's batch, the solve and the writeback the
    plain version's sums and rows, the final pass the plain tree's block
    sums. With one period there is no ramp pack."""
    from exaadmm_tpu_torch.models.acopf import kernels as K
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.models.mpacopf import ramp as R
    from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda
    from exaadmm_tpu_torch.ops import mpacopf_cuda as MC

    gd, ac = model.grid, sol.acopf
    dtype, dev = ac.u.gen.dtype, ac.u.gen.device
    bt = torch.tensor(1e3, dtype=dtype, device=dev)
    res = None
    if model.T > 1:
        *batch, act = MC.ramp_pack(sol, model, it)
        res = tron_cuda.tron_alm_packed(
            tron_cuda.RAMP, *batch, active0=act,
            **R.ramp_tolerances(model.par, dtype))
    arcs, gens = MC.bus_values_plain(sol, model)
    agg = bus_cuda.bus_scatter(arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx)
    gsum = bus_cuda.bus_scatter(gens, gd.gen_bus, gd.gen_ptr, gd.gen_idx)
    wtm = MC.bus_solve_plain(agg, gsum, gd, model.Pd, model.Qd)
    _, _, part = MC.residual_partials_plain(sol, model)
    line, rest = part[:MC.LINE_SUMS], part[MC.LINE_SUMS:]
    cases = {
        "mp_ramp_pack": (lambda: MC.ramp_pack(sol, model, it),
                         lambda: R.ramp_pack_plain(sol, model, it)),
        "mp_generator_unpack": (
            lambda: MC.generator_unpack(sol, model, res),
            lambda: MP.generator_unpack_plain(sol, model, res)),
        "mp_bus_values": (lambda: MC.bus_values(sol, model),
                          lambda: MC.bus_values_plain(sol, model)),
        "mp_bus_solve": (
            lambda: MC.bus_solve(agg, gsum, gd, model.Pd, model.Qd),
            lambda: MC.bus_solve_plain(agg, gsum, gd, model.Pd, model.Qd)),
        "mp_bus_writeback": (
            lambda: MC.bus_writeback(sol, model, wtm),
            lambda: K.bus_writeback(ac.u, ac.z, ac.l, ac.rho, wtm, gd,
                                    model.next_ramp(sol.ramp))),
        "mp_z": (lambda: MC.z_update(sol, model, bt),
                 lambda: MP.z_update_plain(sol, model, bt)),
        "mp_l": (lambda: MC.l_update(sol, model, bt),
                 lambda: MP.l_update_plain(sol, model, bt)),
        "mp_lz": (lambda: MC.lz_update(sol, model, bt),
                  lambda: MP.lz_update_plain(sol, model, bt)),
        "mp_residual_partials": (
            lambda: MC.residual_partials(sol, model),
            lambda: MC.residual_partials_plain(sol, model)),
        "mp_residual_final": (lambda: MC.residual_final(line, rest),
                              lambda: MC.residual_final_plain(line, rest)),
        "mp_z, beta a float": (lambda: MC.z_update(sol, model, 1e3),
                               lambda: MP.z_update_plain(sol, model, 1e3)),
        "bus update (the hook)": (
            lambda: MC.bus_update(sol, model, model.Pd, model.Qd),
            lambda: MP.bus_update_plain(sol, model, model.Pd, model.Qd)),
    }
    if model.T == 1:
        del cases["mp_ramp_pack"]
    return cases


def _mp_flat(x) -> list:
    """The tensors of a hook's output, in order."""
    from exaadmm_tpu_torch.utils.environment import (RAMP_FIELDS, Blocks,
                                                     RampState)
    if isinstance(x, Blocks):
        return [x.gen, x.line]
    if isinstance(x, RampState):
        return [getattr(x, k) for k in RAMP_FIELDS]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _mp_flat(y)]
    return [x]


def _mp_scalars_held(label: str, model, sol) -> float:
    """The residual's six scalars through the kernels against the plain
    hook's ``torch.sum``: bit-identical on a rerun; in fp64 the square
    roots within 1e-13 relative and the objective within 1e-13 of its
    terms' magnitudes, in fp32 1e-5 (the same terms in another order).
    Returns the largest difference."""
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.ops import mpacopf_cuda as MC
    ac, gd = sol.acopf, model.grid
    got = MC.residual_update(sol, model, 1e3)[2]
    again = MC.residual_update(sol, model, 1e3)[2]
    ref = MP.residual_update_plain(sol, model)[2]
    tol = 1e-13 if ac.u.gen.dtype == torch.float64 else 1e-5
    pg = gd.baseMVA * ac.u.gen[..., 0]
    obj_mag = float(torch.sum((gd.c2 * (pg * pg)).abs()
                              + (gd.c1 * pg).abs() + gd.c0.abs()))
    worst = 0.0
    for k in MC.SCALARS:
        a, b = float(got[k]), float(ref[k])
        _check(bool(torch.equal(got[k], again[k])),
               f"phase 5h: {label}: residual {k} differs on a rerun")
        lim = tol * (obj_mag if k in ("objval", "auglag") else abs(b))
        _check(abs(a - b) <= lim, f"phase 5h: {label}: residual {k} {a!r} "
                                  f"against torch.sum's {b!r}: "
                                  f"{abs(a - b):.3e} > {lim:.3e}")
        worst = max(worst, abs(a - b))
    return worst


def _bits(t):
    """``t``'s bit patterns (a float tensor viewed as integers of its
    width), so that equal NaNs compare equal."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _bit_equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(_bits(a), _bits(b))))


def _mp_hooks_bits(label: str, model, sol, it, dev) -> dict:
    """Every case of ``_mp_hook_cases`` twice against its plain version:
    every output bit for bit the plain version's and the rerun's (a rank
    window's bus solve meets buses whose lines are all on the other rank,
    whose sums a mesh completes first: there both give the same infinities
    and NaNs); then the scalars (``_mp_scalars_held``). Returns each
    kernel's largest |difference| (0: bit-identical) and the scalars'
    (``scalars`` in fp64, ``scalars f32``)."""
    errs = {}
    for name, (kern, plain) in _mp_hook_cases(model, sol, it).items():
        got, again, ref = (_mp_flat(kern()), _mp_flat(kern()),
                           _mp_flat(plain()))
        _sync(dev)
        same = len(got) == len(ref) and all(
            _bit_equal(a, b) for a, b in zip(got, ref))
        rerun = all(_bit_equal(a, b) for a, b in zip(got, again))
        _check(same and rerun, f"phase 5h: {label}: {name}: bit-identical "
                               f"to the plain version {same}, to a rerun "
                               f"{rerun}")
        errs[name] = 0.0
    f64 = sol.acopf.u.gen.dtype == torch.float64
    errs["scalars" if f64 else "scalars f32"] = _mp_scalars_held(label, model,
                                                                 sol)
    T, ngen = model.T, model.grid.ngen
    print(f"phase 5h: {label}: T={T}, {ngen} gens, "
          f"{sol.acopf.u.line.shape[1]} lines: {len(errs) - 1} kernels and "
          f"hooks bit-identical to their plain versions and to a rerun; "
          f"residual scalars against torch.sum's within "
          f"{errs['scalars' if f64 else 'scalars f32']:.3e}")
    return errs


def phase5h_mp_hooks(dev, data, loads, T: int, on_card: bool,
                     iters: int = 3) -> dict:
    """The multi-period hook kernels (``csrc/mpacopf_hooks.cu``) against
    their plain versions, each twice, every output bit for bit, on phase
    5's model after ``iters`` inner iterations (``_mp_hook_state``: fp64
    with inner_iter a 0-d tensor and an int, and fp32), case9 x 3 periods,
    case9 x 1 period and each of two rank windows of phase 5's model padded
    to an even line count; the residual's scalars against ``torch.sum``.
    Then, on the fp64 batch: each kernel's device ms per launch and its
    plain version's (the host kept ahead), the bounds of ``ops/bounds.py``,
    each hook's plain and kernel forms eager and captured as a graph, and
    an empty kernel's device ms."""
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.ops import acopf_cuda, bounds
    from exaadmm_tpu_torch.ops import mpacopf_cuda as MC
    from exaadmm_tpu_torch.utils.environment import Parameters
    from exaadmm_tpu_torch.utils.opfdata import load_time_series, \
        opf_loaddata
    from exaadmm_tpu_torch.utils.timing import time_ms

    reps, hook_reps, plain_reps = (200, 100, 4) if on_card else (2, 2, 1)
    par = Parameters(verbose=0)
    model = _mp_model(dev, data, loads, T, torch.float64, par)
    sol = _mp_hook_state(model, iters)
    it_t = torch.tensor(iters + 1, dtype=torch.int64, device=dev)
    out = {"errs": {}}
    batches = [(f"{data.case} x {T} fp64, inner_iter a tensor", model, sol,
                it_t),
               (f"{data.case} x {T} fp64, inner_iter 1", model, sol, 1)]
    m32 = _mp_model(dev, data, loads, T, torch.float32, par)
    batches.append((f"{data.case} x {T} fp32", m32, sol.to(torch.float32),
                    it_t))
    data9 = opf_loaddata(CASE9, verbose=0)
    loads9 = load_time_series(DEMAND9)
    for T9 in (3, 1):
        m9 = _mp_model(dev, data9, loads9, T9, torch.float64, par)
        batches.append((f"case9 x {T9}", m9, _mp_hook_state(m9, iters),
                        iters + 1))
    padded = MP.build_model(data, par, *loads, end_period=T,
                            pad_lines_to=RANKS, device=dev)
    psol = _mp_hook_state(padded, iters)
    for rank, lm, ls in _rank_views(padded, psol):
        batches.append((f"{data.case} x {T} rank {rank} of {RANKS}", lm, ls,
                        it_t))
    for label, m, s_, it in batches:
        errs = _mp_hooks_bits(label, m, s_, it, dev)
        for k, v in errs.items():
            out["errs"][k] = max(out["errs"].get(k, 0.0), v)
    out["cases"] = len(batches)

    gd = model.grid
    ngen, nline, nbus = gd.ngen, sol.acopf.u.line.shape[1], gd.nbus
    nb = MC.residual_blocks(ngen, nline)
    cases = _mp_hook_cases(model, sol, it_t)
    for name in MP_HOOK_KERNELS:
        kern, plain = cases[name]
        ms, enq = time_ms(kern, dev, reps)
        plain_ms, plain_enq = time_ms(plain, dev, plain_reps)
        nbytes = bounds.mpacopf_hook_bytes(
            name, T, ngen, nline, nbus, 8, nb,
            scalar_tensor=name in ("mp_ramp_pack", "mp_z", "mp_l", "mp_lz"))
        bound_ms, bound_by = bounds.bound(
            nbytes["total"], bounds.mpacopf_hook_ops(name, T, ngen, nline,
                                                     nbus, nb))
        err = out["errs"][name]
        if name == "mp_residual_final":
            err = max(err, out["errs"]["scalars"])
        out[name] = dict(ms=ms, enqueue_ms=enq, plain_ms=plain_ms,
                         plain_enqueue_ms=plain_enq, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes["total"],
                         max_abs_err=err)
        print(f"phase 5h: {name}: device ms per launch {ms:.5f} (plain "
              f"{plain_ms:.5f}), bound {bound_ms:.5f} ({bound_by}, "
              f"{nbytes['total']} B); host enqueue ms per call {enq:.5f} "
              f"(plain {plain_enq:.5f})")

    # each hook whole: the plain form and the kernels' form, eager and
    # captured as a graph (x: the ramp pack and the unpack, around the
    # TRON kernels, which neither form changes)
    unpack_k, unpack_p = cases["mp_generator_unpack"]
    pack_k, pack_p = cases["mp_ramp_pack"]
    kz, pz = cases["mp_z"]
    kl, pl = cases["mp_l"]
    klz, plz = cases["mp_lz"]
    hooks = {
        "x (ramp pack, unpack)": (lambda: (pack_p(), unpack_p()),
                                  lambda: (pack_k(), unpack_k())),
        "xbar": cases["bus update (the hook)"][::-1],
        "z": (pz, kz), "l": (pl, kl), "lz": (plz, klz),
        "residual": (lambda: MP.residual_update_plain(sol, model),
                     lambda: MC.residual_update(sol, model, 1e3)),
    }
    out["hooks"] = {}
    for name, (plain, kern) in hooks.items():
        r = dict(plain_eager=time_ms(plain, dev, plain_reps)[0],
                 plain_graph=_graph_ms(dev, plain, reps),
                 kernel_eager=time_ms(kern, dev, hook_reps)[0],
                 kernel_graph=_graph_ms(dev, kern, reps))
        out["hooks"][name] = r
        print(f"phase 5h: hook {name}: device ms plain {r['plain_eager']:.5f}"
              f" eager, {r['plain_graph']:.5f} in a graph; kernels "
              f"{r['kernel_eager']:.5f} eager, {r['kernel_graph']:.5f} in a "
              f"graph")
    floor = None
    if on_card:
        floor = time_ms(lambda: acopf_cuda.launch_floor(dev), dev, reps)[0]
    out["floor_ms"] = floor
    print(f"phase 5h: {data.case} x {T} ({nbus} buses, {nline} lines, {ngen}"
          f" gens), {iters} inner iterations in, {out['cases']} batches "
          f"held; an empty kernel's device ms per launch: "
          f"{'not measured on the CPU' if floor is None else f'{floor:.5f}'}")
    return out


def phase3c_case9_qpsub(dev, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
    from exaadmm_tpu_torch.models.qpsub.sqp import SqpBasePoint
    from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
    from tests import qpsub_fixture as fx

    # the reference test's base point: vm = sqrt(bus_w), va from the lines
    data = opf_loaddata(CASE9, verbose=0)
    va = np.zeros(data.nbus)
    va[data.line_from] = fx.line_var[4]
    va[data.line_to] = fx.line_var[5]
    qp = qp_inputs(data, SqpBasePoint(pg=fx.pg, qg=fx.qg,
                                      vm=np.sqrt(fx.bus_w), va=va))
    _zero_launches()
    t0 = time.perf_counter()
    res = E.solve_qpsub(CASE9, *[qp[k] for k in QP_KEYS], 1e5,
                        outer_iterlim=10000, inner_iterlim=1, scale=1e-4,
                        rho_pq=4000.0, rho_va=4000.0, outer_eps=2e-6,
                        verbose=0, device=dev)
    _sync(dev)
    launched = _launches()
    secs = time.perf_counter() - t0
    info = res.info
    lam = res.sqp_out["lambda"]
    rel = abs(info.objval - QP_PIN_OBJ) / abs(QP_PIN_OBJ)
    print(f"phase 3c: case9 QP {info.status} outer {info.outer} cumul "
          f"{info.cumul} (pin {QP_PIN_ITERS}) obj {info.objval!r} (rel diff "
          f"{rel:.2e}) in {secs:.2f} s ({info.cumul / info.time_overall:.1f} "
          f"it/s in the ADMM loop); dual_infeas "
          f"{res.sqp_out['dual_infeas'].shape} lambda {lam.shape}, max "
          f"lambda[2:] {lam[2:].max():.3e}; launches qpsub "
          f"{launched['tron_alm_qpsub']} bus {launched['bus_scatter']}")
    _check(info.status == "Solved", f"case9 QP: status {info.status}")
    for name in ("outer", "cumul"):
        n = getattr(info, name)
        _check(abs(n - QP_PIN_ITERS) <= 0.02 * QP_PIN_ITERS,
               f"case9 QP: {name} {n}")
    _check(rel <= 1e-6, f"case9 QP: obj {info.objval}")
    _check(res.sqp_out["dual_infeas"].shape == (3 + 6 * 9,),
           "case9 QP: dual_infeas shape")
    _check(lam.shape == (4, 9), "case9 QP: lambda shape")
    _check(bool(np.all(lam[2:] <= 1e-12)), "case9 QP: lambda[2:] > 1e-12")
    if on_card:
        _check(launched['tron_alm_qpsub'] == info.cumul + WARMUP,
               f"case9 QP: {launched['tron_alm_qpsub']} qpsub launches for "
               f"{info.cumul} iterations and the warm-up")
        _check(launched['bus_scatter'] == 2 * (info.cumul + WARMUP),
               f"case9 QP: {launched['bus_scatter']} bus launches")
    return dict(outer=info.outer, cumul=info.cumul, obj=info.objval,
                seconds=secs)


def phase6_qpsub(dev, data, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS

    qp = qp_inputs(data)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    res = E.solve_qpsub(data.case, *[qp[k] for k in QP_KEYS], 1e5, data=data,
                        outer_iterlim=QP_ITERS, scale=1e-4, rho_pq=4e3,
                        rho_va=4e3, outer_eps=0.0, tron_step_cap=24,
                        verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = _launches()
    info = res.info
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rate = info.cumul / info.time_overall
    print(f"phase 6: {data.case} QP ({data.nbus} buses, {data.nline} lines, "
          f"{data.ngen} gens) fp64: {info.cumul} one-level iterations; ADMM "
          f"loop {info.time_overall:.3f} s = {rate:.2f} it/s, whole call "
          f"with setup {secs:.3f} s = {info.cumul / secs:.2f} it/s; mismatch "
          f"{info.mismatch!r} dualres {info.dualres!r} obj {info.objval!r}; "
          f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    for name in ("mismatch", "primres", "dualres", "objval", "auglag"):
        _check(bool(np.isfinite(getattr(info, name))),
               f"qpsub path: {name} not finite")
    _check(info.cumul == QP_ITERS, f"qpsub path: {info.cumul} iterations")
    _check(bool(torch.isfinite(res.solution.base.u.line).all()),
           "qpsub path: u not finite")
    for k, v in res.sqp_out.items():
        _check(bool(np.isfinite(v).all()), f"qpsub path: sqp_out {k}")
    if on_card:
        _check(launches["tron_alm_qpsub"] == info.cumul + WARMUP
               and launches["tron_alm_branch"] == 0
               and launches["tron_alm_ramp"] == 0,
               f"qpsub path: TRON launches {launches}")
        _check(launches["bus_scatter"] == 2 * (info.cumul + WARMUP)
               and launches["graph_loop"] == _loop_trips(info, False),
               f"qpsub path: bus and loop launches {launches}")
    return dict(launches=launches, rate=rate, seconds=secs,
                mismatch=info.mismatch, peak=peak)


def _near_pin(label: str, info, outer: int, cumul: int, obj=None):
    """Solved, within 1 outer and 2 % cumul of the pin, the objective
    within 1e-6 relative."""
    _check(info.status == "Solved", f"{label}: status {info.status}")
    _check(abs(info.outer - outer) <= 1, f"{label}: outer {info.outer}")
    _check(abs(info.cumul - cumul) <= 0.02 * cumul,
           f"{label}: cumul {info.cumul}")
    if obj is not None:
        _check(abs(info.objval - obj) <= 1e-6 * abs(obj),
               f"{label}: obj {info.objval!r}")


def phase3e_case9_mpec(dev, on_card: bool) -> dict:
    """case9 MPEC without and with storage (storage_ratio 0.3): the branch
    kernel once per inner iteration, the scatter two times (three with
    storage)."""
    import exaadmm_tpu_torch as E

    out = {}
    for label, extra in (("without storage", {}),
                         ("with storage", dict(storage_ratio=0.3,
                                               storage_charge_max=0.1))):
        outer, cumul, obj = MPEC_PINS[label]
        _zero_launches()
        t0 = time.perf_counter()
        res = E.solve_acopf_mpec(CASE9, rho_pq=4e2, rho_va=4e4,
                                 outer_iterlim=40, outer_eps=2e-4, verbose=0,
                                 device=dev, **extra)
        _sync(dev)
        secs = time.perf_counter() - t0
        info = res.info
        launches = _launches()
        print(f"phase 3e: case9 MPEC {label} {info.status} outer "
              f"{info.outer} (pin {outer}) cumul {info.cumul} (pin {cumul}) "
              f"obj {info.objval!r} (rel diff "
              f"{abs(info.objval - obj) / obj:.2e}) freq_change "
              f"{res.freq_change!r} vm_dev {res.vm_dev!r} in {secs:.2f} s; "
              f"launches {launches}")
        _near_pin(f"case9 MPEC {label}", info, outer, cumul, obj)
        if on_card:
            per_it = 3 if extra else 2
            _check(launches["tron_alm_branch"] == info.cumul + WARMUP
                   and launches["bus_scatter"]
                   == per_it * (info.cumul + WARMUP),
                   f"case9 MPEC {label}: launches {launches} for "
                   f"{info.cumul} inner iterations")
            _branch_io_launches(f"case9 MPEC {label}", launches)
        out[label] = dict(outer=info.outer, cumul=info.cumul,
                          obj=info.objval, seconds=secs)
    return out


def phase3f_case9_rolling_projection(dev, on_card: bool) -> dict:
    """case9 rolling horizon over periods 1-3, then case9 with the
    power-flow projection."""
    import exaadmm_tpu_torch as E

    _zero_launches()
    t0 = time.perf_counter()
    _, infos = E.solve_acopf_rolling(CASE9, DEMAND9, rho_pq=4e2, rho_va=4e4,
                                     outer_iterlim=25, outer_eps=2e-4,
                                     end_period=3, tight_factor=1.0,
                                     verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = _launches()
    print(f"phase 3f: case9 rolling, periods 1-3 in {secs:.2f} s: "
          + "; ".join(f"{i.status} {i.outer} / {i.cumul} (pin {o} / {c}) "
                      f"obj {i.objval!r}"
                      for i, (o, c, _) in zip(infos, ROLLING_PINS))
          + f"; launches {launches}")
    _check(len(infos) == 3, "case9 rolling: periods")
    for t, (info, (outer, cumul, obj)) in enumerate(zip(infos, ROLLING_PINS)):
        _near_pin(f"case9 rolling period {t + 1}", info, outer, cumul, obj)
    total = sum(i.cumul for i in infos)
    if on_card:
        # one fused solver for the three periods: one warm-up
        _check(launches["tron_alm_branch"] == total + WARMUP,
               f"case9 rolling: launches {launches} for {total} inner "
               f"iterations and the warm-up")
        _hooks_held("case9 rolling", launches, total,
                    sum(i.outer for i in infos))
        _branch_io_launches("case9 rolling", launches)

    res = E.solve_acopf(CASE9, rho_pq=4e2, rho_va=4e4, outer_eps=2e-5,
                        outer_iterlim=25, use_projection=True, verbose=0,
                        device=dev)
    info = res.info
    v = res.solution.v.line.cpu().numpy()
    data = res.data
    spread = max(float(np.ptp(np.concatenate([v[data.line_from == b, 4],
                                              v[data.line_to == b, 5]])))
                 for b in range(data.nbus))
    print(f"phase 3f: case9 with projection {info.status} outer {info.outer} "
          f"cumul {info.cumul} obj {info.objval!r} pf_residual "
          f"{info.pf_residual!r} in {info.time_projection:.4f} s of "
          f"projection; largest spread of a bus's w copies {spread:.3e}")
    _near_pin("case9 projection", info, PIN_OUTER, PIN_CUMUL)
    _check(info.pf_residual <= 1e-6, f"case9 projection: pf residual "
                                     f"{info.pf_residual}")
    _check(spread < 1e-12, f"case9 projection: w spread {spread}")
    return dict(periods=[(i.outer, i.cumul, i.objval) for i in infos],
                seconds=secs, pf_residual=info.pf_residual)


def phase7_mpec(dev, data, on_card: bool) -> dict:
    """The MPEC path at full width: ``data`` with storage at a tenth of its
    buses, 10 outer iterations of at most 100 inner, outer_eps 0."""
    import exaadmm_tpu_torch as E

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    res = E.solve_acopf_mpec(data.case, data=data, rho_pq=3e3, rho_va=3e5,
                             outer_iterlim=10, inner_iterlim=100,
                             outer_eps=0.0, verbose=0, device=dev,
                             **MPEC_STORAGE)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = _launches()
    info = res.info
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rate = info.cumul / info.time_overall
    nsto = res.model.storage.nstorage
    print(f"phase 7: {data.case} MPEC ({data.nbus} buses, {data.nline} "
          f"lines, {data.ngen} gens, {nsto} storage units) fp64: "
          f"{info.outer} outer, {info.cumul} inner; ADMM loop "
          f"{info.time_overall:.3f} s = {rate:.2f} inner it/s, whole call "
          f"with setup {secs:.3f} s = {info.cumul / secs:.2f} inner it/s; "
          f"mismatch {info.mismatch!r} primres {info.primres!r} obj "
          f"{info.objval!r} freq_change {res.freq_change!r}; peak device "
          f"memory {peak / 2**20:.1f} MiB; launches {launches}")
    for name in ("mismatch", "primres", "dualres", "objval", "norm_z_curr"):
        _check(bool(np.isfinite(getattr(info, name))),
               f"MPEC path: {name} not finite")
    _check(bool(torch.isfinite(res.solution.u.line).all())
           and bool(torch.isfinite(res.solution.u.sto).all()),
           "MPEC path: u not finite")
    if on_card:
        _check(launches["tron_alm_branch"] == info.cumul + WARMUP
               and launches["bus_scatter"] == 3 * (info.cumul + WARMUP)
               and launches["graph_loop"] == _loop_trips(info)
               and sum(launches.values()) == 7 * (info.cumul + WARMUP)
               + launches["graph_loop"],
               f"MPEC path: launches {launches}")
        _branch_io_launches("MPEC path", launches)
    return dict(launches=launches, rate=rate, seconds=secs,
                mismatch=info.mismatch, peak=peak, nstorage=nsto)


def _w_spread(sol, grid) -> float:
    """The largest spread, over the buses, of the w copies that the line
    rows of ``sol`` hold (v rows 4 and 5, written from the bus update):
    0 when every row sits where ``grid`` says its line is."""
    v = sol.v.line.cpu().numpy()
    fr, to = grid.line_from.cpu().numpy(), grid.line_to.cpu().numpy()
    real = grid.line_mask.cpu().numpy() > 0.5
    w = np.concatenate([v[real, 4], v[real, 5]])
    bus = np.concatenate([fr[real], to[real]])
    lo = np.full(grid.nbus, np.inf)
    hi = np.full(grid.nbus, -np.inf)
    np.minimum.at(lo, bus, w)
    np.maximum.at(hi, bus, w)
    has = np.isfinite(lo)
    return float((hi[has] - lo[has]).max())


def phase10a_mixed(dev, data, on_card: bool, base: dict,
                   case9_outer: int = 30) -> dict:
    """Mixed precision: an fp64 solve whose branch batch runs in fp32.

    Phase 2's fp64 batch goes through the mixed path's cast
    (``branch.cast_down``) and the f32 branch kernel is held against its
    f32 plain version with phase 2's fp32 thresholds, timed beside the f64
    kernel on the uncast batch; then ``solve_acopf(mixed_precision=True)``
    at phase 4's configuration against phase 4's ``base`` (objective within
    1e-3, the state fp64, every branch launch the f32 instance); then case9
    with and without line limits to Solved at outer_eps 2e-4, within 1e-3
    of the fp64 pins. A rehearsal may cut ``case9_outer``, and then only
    finiteness is held there."""
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters
    from exaadmm_tpu_torch.utils.timing import time_ms

    par = Parameters(verbose=0, tron_step_cap=50, mixed_precision=True)
    model, sol = _it1_state(dev, data, torch.float64, par)
    batch = branch.branch_inputs(sol, model.grid, par, 1)
    x0, xl, xu, params, lam0, mu0, act = batch
    down = branch.cast_down(x0, xl, xu, params, lam0, mu0)
    opts32 = branch.branch_tolerances(par, torch.float32)
    opts64 = branch.branch_tolerances(par, torch.float64)

    def kernel():
        return tron_cuda.tron_alm_branch(*down, active0=act, **opts32)

    def plain():
        return tron_cuda.tron_alm_branch_plain(*down, active0=act, **opts32)

    r = _tron_vs_plain("phase 10a: tron_alm_branch f32 in an fp64 solve",
                       "tron_alm_branch", kernel, plain, act, torch.float32,
                       dev)
    ms64, _ = time_ms(lambda: tron_cuda.tron_alm_branch(
        x0, xl, xu, params, lam0, mu0, active0=act, **opts64), dev, reps=5,
        warmup=1)
    print(f"phase 10a: branch batch of {x0.shape[1]} lanes at it1, device ms "
          f"per launch: f32 (cast down) {r['ms']:.4f}, f64 {ms64:.4f} "
          f"({r['ms'] / ms64:.3f}x); f32 bound {r['bound_ms']:.5f} "
          f"({r['bound_by']})")
    out = {"kernel": dict(r, ms64=ms64)}

    # the same for the polar batch (no line limits) of phase 2d's setup
    pmodel, psol = _it1_state(dev, data, torch.float64, par, pad=1,
                              use_linelimit=False)
    px0, pxl, pxu, pparams, plam0, pmu0, pact = branch.polar_inputs(
        psol, pmodel.grid, par)
    pdown = branch.cast_down(px0, pxl, pxu, pparams, plam0, pmu0)
    popts32 = branch.polar_tolerances(par, torch.float32)
    rp = _tron_vs_plain(
        "phase 10a: tron_alm_polar f32 in an fp64 solve", "tron_alm_polar",
        lambda: tron_cuda.tron_alm_polar(*pdown, active0=pact, **popts32),
        lambda: tron_cuda.tron_alm_polar_plain(*pdown, active0=pact,
                                               **popts32),
        pact, torch.float32, dev)
    pms64, _ = time_ms(lambda: tron_cuda.tron_alm_polar(
        px0, pxl, pxu, pparams, plam0, pmu0, active0=pact,
        **branch.polar_tolerances(par, torch.float64)), dev, reps=5,
        warmup=1)
    print(f"phase 10a: polar batch of {px0.shape[1]} lanes at it1, device ms "
          f"per launch: f32 (cast down) {rp['ms']:.4f}, f64 {pms64:.4f} "
          f"({rp['ms'] / pms64:.3f}x); f32 bound {rp['bound_ms']:.5f} "
          f"({rp['bound_by']})")
    out["polar_kernel"] = dict(rp, ms64=pms64)

    _sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    res = E.solve_acopf(data.case, data=data, device=dev,
                        mixed_precision=True, **MAIN_KW)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = _launches()
    entries = dict(tron_cuda.launches)
    info = res.info
    rate = info.cumul / info.time_overall
    rel = abs(info.objval - base["obj"]) / abs(base["obj"])
    dtype = res.solution.u.line.dtype
    print(f"phase 10a: {data.case} mixed precision: {info.outer} outer, "
          f"{info.cumul} inner (phase 4: {base['outer']} / {base['cumul']});"
          f" obj {info.objval!r} (rel diff to phase 4's {rel:.2e}); state "
          f"{dtype}; ADMM loop {info.time_overall:.3f} s = {rate:.2f} inner "
          f"it/s (phase 4: {base['rate']:.2f}), whole call {secs:.3f} s; "
          f"launches {launches}, by entry {entries}")
    _check(bool(np.isfinite(info.objval))
           and bool(torch.isfinite(res.solution.u.line).all()),
           "mixed path: not finite")
    _check(dtype == torch.float64 and res.solution.branch_alm.mu.dtype
           == torch.float64, f"mixed path: state {dtype}")
    _check(info.outer == base["outer"], f"mixed path: outer {info.outer}")
    _check(rel <= 1e-3, f"mixed path: obj {info.objval!r}")
    if on_card:
        _check(entries.get("tron_alm_branch_f32", 0)
               == info.cumul + WARMUP
               and "tron_alm_branch_f64" not in entries
               and launches["bus_scatter"] == 2 * (info.cumul + WARMUP),
               f"mixed path: launches {entries} {launches}")
        _hooks_held("mixed path", launches, info.cumul, info.outer)
        _branch_io_launches("mixed path", launches)
    out["main"] = dict(launches=launches, rate=rate, outer=info.outer,
                       cumul=info.cumul, obj=info.objval)

    for label, pin in MIXED9_PINS.items():
        limits = label == "with line limits"
        _zero_launches()
        t0 = time.perf_counter()
        res = E.solve_acopf(CASE9, rho_pq=4e2, rho_va=4e4, outer_eps=2e-4,
                            outer_iterlim=case9_outer, use_linelimit=limits,
                            mixed_precision=True, verbose=0, device=dev)
        _sync(dev)
        secs = time.perf_counter() - t0
        info = res.info
        entries = dict(tron_cuda.launches)
        rel = abs(info.objval - pin) / pin
        print(f"phase 10a: case9 {label}, mixed precision: {info.status} "
              f"outer {info.outer} cumul {info.cumul} obj {info.objval!r} "
              f"(rel diff to the fp64 pin {pin!r}: {rel:.2e}) in "
              f"{secs:.2f} s; launches by entry {entries}")
        _check(bool(np.isfinite(info.objval)), f"case9 mixed {label}: obj")
        if case9_outer >= 30:
            _check(info.status == "Solved",
                   f"case9 mixed {label}: {info.status}")
            _check(rel <= 1e-3, f"case9 mixed {label}: obj {info.objval!r}")
        if on_card:
            entry = "tron_alm_branch_f32" if limits else "tron_alm_polar_f32"
            _check(entries == {entry: info.cumul + WARMUP},
                   f"case9 mixed {label}: launches {entries}")
        out[label] = dict(status=info.status, outer=info.outer,
                          cumul=info.cumul, obj=info.objval)
    return out


def _time_pre(dev, run, reps: int = 20) -> float:
    """The device ms of a sorting fused solver's outer prestep (``run._pre``:
    the sort of the last iteration's steps, the state's line rows and the
    grid's line arrays gathered in the new order, the arc CSR derived
    again), captured alone on a copy of the solver's carry and replayed
    ``reps`` times; on the CPU the host's ms of the eager prestep."""
    w = run.carry.clone()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run._pre(w)
        return (time.perf_counter() - t0) * 1e3 / reps
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run._pre(w)
    cur.wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        run._pre(w)
    g.replay()
    _sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    _sync(dev)
    return start.elapsed_time(end) / reps


def _sorted_solve(dev, model, label: str, base: dict,
                  on_card: bool) -> dict:
    """Phase 4's solve of ``model`` with line sorting on: the host loop,
    which records the line order of every sorted round (``ids``), then the
    driver's choice at verbose 0, the fused loop, which keeps only the last
    order. The fused solve must equal the host loop's (the same counts and
    info, every solution tensor bit-identical, the same last order) and hold
    phase 4's ``base``: the same outer count, cumul within 2 %, the
    objective within 1e-6 relative, the rows back in canonical order. Then
    the device ms of the fused loop's outer prestep with the sort."""
    from exaadmm_tpu_torch.algorithms import admm_two_level as two
    from exaadmm_tpu_torch.algorithms.carry import leaves
    from exaadmm_tpu_torch.models.acopf import model as M

    rho = MAIN_KW["rho_pq"], MAIN_KW["rho_va"]
    ids = []
    reorder = M.ModelAcopf.with_line_order

    def recorded(self, line_ids):
        ids.append(line_ids.clone())
        return reorder(self, line_ids)

    M.ModelAcopf.with_line_order = recorded
    try:
        host_sol, host = two.admm_two_level(model,
                                            M.init_solution(model, *rho))
        _sync(dev)
    finally:
        M.ModelAcopf.with_line_order = reorder
    driver = two.two_level_driver(model)
    _check(driver.func is two.admm_two_level_fused,
           f"{label}: the driver at verbose 0 is not the fused one")
    _zero_launches()
    sol, info = driver(model, M.init_solution(model, *rho))
    _sync(dev)
    launches = _launches()
    run = driver.keywords["run"]
    last = run.carry.v["line_ids"]
    pairs = list(zip(leaves(sol), leaves(host_sol), strict=True))
    same = all(bool(torch.equal(a, b)) for a, b in pairs)
    rate = info.cumul / info.time_overall
    rate_host = host.cumul / host.time_overall
    spread = _w_spread(sol, model.grid)
    pre_ms = _time_pre(dev, run)
    round_ms = info.time_overall * 1e3 / info.outer
    print(f"phase 10b: {label}, fused: {info.outer} outer, {info.cumul} "
          f"inner (phase 4: {base['outer']} / {base['cumul']}), obj "
          f"{info.objval!r} (rel diff to phase 4's "
          f"{abs(info.objval - base['obj']) / abs(base['obj']):.2e}); host "
          f"loop {host.outer} / {host.cumul} with {len(ids)} sorted rounds, "
          f"{len(pairs)} solution tensors bit-identical: {same}, the same "
          f"last line order: {bool(torch.equal(last, ids[-1]))}; rows in "
          f"the grid's order (largest spread of a bus's w copies "
          f"{spread:.3e}); ADMM loop {info.time_overall:.3f} s = {rate:.2f} "
          f"inner it/s (phase 4 fused: {base['rate']:.2f}; sorted host "
          f"loop: {rate_host:.2f}), build {info.time_build * 1e3:.1f} ms, "
          f"pool {info.graph_pool_bytes / 2**20:.1f} MiB; outer prestep "
          f"with the sort {pre_ms:.4f} "
          f"{'device' if on_card else 'host'} ms per round (an outer round "
          f"{round_ms:.3f} ms); launches {launches}")
    for k in _INFO_FIELDS:
        _check(getattr(info, k) == getattr(host, k),
               f"{label}: {k} fused {getattr(info, k)!r} host "
               f"{getattr(host, k)!r}")
    _check(same, f"{label}: the fused solution differs from the host's")
    _check(len(ids) == info.outer - 1, f"{label}: a round was not sorted")
    _check(bool(torch.equal(last, ids[-1])),
           f"{label}: the fused loop's last line order differs")
    _check(info.outer == base["outer"], f"{label}: outer {info.outer}")
    _check(abs(info.cumul - base["cumul"]) <= 0.02 * base["cumul"],
           f"{label}: cumul {info.cumul}")
    _check(abs(info.objval - base["obj"]) <= 1e-6 * abs(base["obj"]),
           f"{label}: obj {info.objval!r}")
    _check(spread < 1e-12, f"{label}: rows out of order ({spread})")
    if on_card:
        _check(launches["tron_alm_branch"] == info.cumul + WARMUP
               and launches["bus_scatter"] == 2 * (info.cumul + WARMUP)
               and launches["graph_loop"] == _loop_trips(info),
               f"{label}: launches {launches}")
        _hooks_held(label, launches, info.cumul, info.outer)
        _branch_io_launches(label, launches)
    return dict(launches=launches, rate=rate, rate_host=rate_host,
                outer=info.outer, cumul=info.cumul, obj=info.objval,
                ids=ids, sol=sol, pre_ms=pre_ms, round_ms=round_ms,
                build_ms=info.time_build * 1e3,
                pool_mib=info.graph_pool_bytes / 2**20)


def _time_sorted(dev, label: str, batch, opts, check_plain: bool) -> dict:
    """One branch batch timed in its own lane order and sorted by the
    steps its lanes take (``minor_iters + alm_iters``, stable ascending,
    the driver's order): the sorted run bit-identical to the unsorted one
    lane for lane and, with ``check_plain``, to the plain version."""
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.timing import time_ms

    act = batch[6]
    first = tron_cuda.tron_alm_branch(*batch[:6], active0=act, **opts)
    steps = first.minor_iters + first.alm_iters
    order = torch.argsort(steps, stable=True)
    sbatch = _take_lanes(batch, order)
    again = tron_cuda.tron_alm_branch(*sbatch[:6], active0=sbatch[6],
                                      **opts)
    _check(bool(torch.equal(again.x, first.x[:, order]))
           and bool(torch.equal(again.minor_iters, first.minor_iters[order])),
           f"{label}: the sorted batch differs from the unsorted one")
    if check_plain:
        plain = tron_cuda.tron_alm_branch_plain(*sbatch[:6],
                                                active0=sbatch[6], **opts)
        _check(bool(torch.equal(again.x, plain.x))
               and bool(torch.equal(again.minor_iters, plain.minor_iters)),
               f"{label}: the kernel differs from its plain version on the "
               f"sorted batch")
    ms, _ = time_ms(lambda: tron_cuda.tron_alm_branch(
        *batch[:6], active0=act, **opts), dev, reps=5, warmup=1)
    ms_sorted, _ = time_ms(lambda: tron_cuda.tron_alm_branch(
        *sbatch[:6], active0=sbatch[6], **opts), dev, reps=5, warmup=1)
    s = steps[act].cpu().numpy()
    print(f"phase 10b: {label}, {act.shape[0]} lanes (steps p50 "
          f"{np.percentile(s, 50):.0f} p99 {np.percentile(s, 99):.0f} max "
          f"{s.max()}): device ms per launch unsorted {ms:.4f}, sorted "
          f"{ms_sorted:.4f} ({ms_sorted / ms:.3f}x); sorted bit-identical "
          f"to unsorted" + (" and to the plain version" if check_plain
                            else ""))
    return dict(ms=ms, ms_sorted=ms_sorted)


def phase10b_sort(dev, data, mp_data, mp_loads, T: int, on_card: bool,
                  base: dict) -> dict:
    """Line sorting: phase 4's configuration with ``sort_lines=True``,
    fused against the sorted host loop and phase 4's ``base``
    (``_sorted_solve``); the scatter held against its plain version
    over the CSR of every sorted round's line order; the branch kernel's
    steady-state time in the driver's order and sorted; then the kernel
    alone on phase 2's batch and on the multi-period path's, each sorted by
    its own steps."""
    from exaadmm_tpu_torch.models.acopf import branch, kernels
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.utils.environment import (Parameters,
                                                     permute_solution_lines)
    from exaadmm_tpu_torch.utils.grid_data import permute_lines

    kw = {k: MAIN_KW[k] for k in ("outer_iterlim", "inner_iterlim",
                                  "outer_eps", "verbose")}
    out = {}
    par = Parameters(sort_lines=True, **kw)
    model = M.build_model(data, par, device=dev)
    out["sorted"] = _sorted_solve(dev, model, "sort_lines=True", base,
                                  on_card)

    # the scatter over each sorted round's CSR, on phase 2's perturbed
    # state moved into that round's order, against its plain version and
    # against the sums of the canonical order
    _, state = _it1_state(dev, data, torch.float64, Parameters(verbose=0),
                          pad=1)
    gd = model.grid
    canon = kernels.bus_arc_values(state.v, state.z, state.l, state.rho, gd)
    ref = _hold_scatter(((canon, gd.arc_bus, gd.arc_ptr, gd.arc_idx),),
                        1e-13, "bus_scatter canonical order")
    worst = 0.0
    from exaadmm_tpu_torch.ops import bus_cuda
    base_sums = bus_cuda.bus_scatter(canon, gd.arc_bus, gd.arc_ptr,
                                     gd.arc_idx)
    for k, ids in enumerate(out["sorted"]["ids"]):
        gp = permute_lines(gd, ids)
        sp = permute_solution_lines(state, ids)
        vals = kernels.bus_arc_values(sp.v, sp.z, sp.l, sp.rho, gp)
        rel, _ = _hold_scatter(((vals, gp.arc_bus, gp.arc_ptr, gp.arc_idx),),
                               1e-13, f"bus_scatter sorted round {k + 2}")
        got = bus_cuda.bus_scatter(vals, gp.arc_bus, gp.arc_ptr, gp.arc_idx)
        scale = base_sums.abs().amax(dim=0).clamp_min(1e-300)
        moved = float(((got - base_sums).abs().amax(dim=0) / scale).max())
        _check(moved <= 1e-13, f"sorted round {k + 2}: sums moved {moved}")
        worst = max(worst, rel, moved)
        print(f"phase 10b: bus_scatter over sorted round {k + 2}'s CSR "
              f"({gp.arc_idx.shape[0]} arcs): max rel diff to the plain "
              f"version {rel:.3e}, to the canonical order's sums "
              f"{moved:.3e} (tol 1e-13), bit-identical reruns")
    out["scatter_rel"] = max(worst, ref[0])

    # the branch kernel at steady state: the batch of the next inner
    # iteration from the sorted solve's final state, in canonical order
    # and sorted by its lanes' steps
    fin = out["sorted"].pop("sol")
    batch = branch.branch_inputs(fin, gd, par, 2)
    out["steady"] = _time_sorted(dev, "branch kernel at steady state",
                                 batch,
                                 branch.branch_tolerances(par,
                                                          torch.float64),
                                 check_plain=False)

    p2 = Parameters(verbose=0, tron_step_cap=50)
    opts = branch.branch_tolerances(p2, torch.float64)
    m2, s2 = _it1_state(dev, data, torch.float64, p2)
    out["it1"] = _time_sorted(
        dev, "branch kernel at it1 (phase 2's batch)",
        branch.branch_inputs(s2, m2.grid, p2, 1), opts, check_plain=True)
    out["it1_periods"] = _time_sorted(
        dev, f"branch kernel at it1, {T} periods",
        _periods_batch(dev, mp_data, mp_loads, T, torch.float64, p2), opts,
        check_plain=True)
    out["sorted"].pop("ids")
    return out


@contextlib.contextmanager
def _host_loop():
    """The entry points with their host loops at verbose 0: phase 11's
    reference runs (each interface module's driver choice, swapped)."""
    from exaadmm_tpu_torch.algorithms import admm_one_level, admm_two_level
    saved = []
    for name in ("solve_acopf", "solve_acopf_rolling", "solve_mpacopf",
                 "solve_mpec", "solve_qpsub"):
        mod = importlib.import_module(f"exaadmm_tpu_torch.interface.{name}")
        if name == "solve_qpsub":
            attr, host = "one_level_driver", admm_one_level.admm_one_level
        else:
            attr, host = "two_level_driver", admm_two_level.admm_two_level
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, lambda model, mesh=None, _host=host: _host)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


_INFO_FIELDS = ("status", "outer", "inner", "cumul", "objval", "auglag",
                "primres", "dualres", "mismatch", "norm_z_curr",
                "norm_z_prev", "max_cviol", "eps_pri")


def _fused_pair(dev, label: str, call, periods, on_card: bool,
                two_level: bool = True) -> dict:
    """``call()`` (an entry point at verbose 0) with the fused driver, then
    in ``_host_loop``: the same status, counts and info scalars, every
    solution tensor bit-identical, and on the card the host loop's counted
    launches of every kernel plus the warm-up's one pass of the inner body
    (``WARMUP``), with the fused run's set-condition launches besides.
    ``periods(res)`` gives a result's (info, solution or None) pairs, whose
    first info is the call that built the fused solver."""
    from exaadmm_tpu_torch.algorithms.carry import leaves

    _sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    fused = periods(call())
    _sync(dev)
    wall_f = time.perf_counter() - t0
    lf = _launches()
    _zero_launches()
    t0 = time.perf_counter()
    with _host_loop():
        host = periods(call())
    _sync(dev)
    wall_h = time.perf_counter() - t0
    lh = _launches()
    bits = 0
    for (i_f, s_f), (i_h, s_h) in zip(fused, host, strict=True):
        for k in _INFO_FIELDS:
            _check(getattr(i_f, k) == getattr(i_h, k),
                   f"phase 11 {label}: {k} fused {getattr(i_f, k)!r} host "
                   f"{getattr(i_h, k)!r}")
        if s_f is not None:
            pairs = list(zip(leaves(s_f), leaves(s_h), strict=True))
            for n, (a, b) in enumerate(pairs):
                _check(a.dtype == b.dtype and bool(torch.equal(a, b)),
                       f"phase 11 {label}: solution tensor {n} differs")
            bits += len(pairs)
    cumul = sum(i.cumul for i, _ in fused)
    trips = sum(_loop_trips(i, two_level) for i, _ in fused)
    _check(lh["graph_loop"] == 0, f"phase 11 {label}: host loop launched "
                                  f"the set-condition kernel: {lh}")
    if on_card:
        # every kernel of the host loop launches a fixed number of times
        # an inner iteration, which the warm-up launches once more; but
        # ``acopf_lz``, which the host loop launches in every outer round
        # that did not solve and the fused loop's tail in every round
        outers = sum(i.outer for i, _ in fused)
        solved = sum(i.status == "Solved" for i, _ in fused)
        want = {k: n + WARMUP * n // cumul for k, n in lh.items()}
        want["graph_loop"] = trips
        per_outer = {"acopf_lz": "acopf_z", "mp_lz": "mp_z"}
        for lz, z in per_outer.items():
            ran = lh[z] > 0
            want[lz] = outers + WARMUP if ran else 0
            _check(lh[lz] == (outers - solved if ran else 0),
                   f"phase 11 {label}: host loop {lz} launches {lh}")
        _check(all(n % cumul == 0 for k, n in lh.items()
                   if k not in per_outer)
               and lf == want,
               f"phase 11 {label}: launches fused {lf}, host {lh}, "
               f"expected fused {want}")
        if lh["tron_alm_branch"] + lh["tron_alm_polar"]:
            _branch_io_launches(f"phase 11 {label} fused", lf)
            _branch_io_launches(f"phase 11 {label} host", lh)
    rate_f = cumul / sum(i.time_overall for i, _ in fused)
    rate_h = cumul / sum(i.time_overall for i, _ in host)
    first, last = fused[0][0], fused[-1][0]
    print(f"phase 11: {label}: {last.status} {last.outer} / {last.cumul}"
          f"{' (' + str(len(fused)) + ' solves)' if len(fused) > 1 else ''}"
          f", fused == host ({bits} solution tensors bit-identical, info "
          f"equal); inner it/s of the ADMM loop fused {rate_f:.2f} host "
          f"{rate_h:.2f} ({rate_f / rate_h:.2f}x); entry point's wall "
          f"fused {wall_f:.3f} s (build {first.time_build * 1e3:.1f} ms) "
          f"host {wall_h:.3f} s; graph pool "
          f"{first.graph_pool_bytes / 2**20:.1f} MiB; launches {lf}")
    return dict(rate=rate_f, rate_host=rate_h, launches=lf,
                wall=wall_f, wall_host=wall_h,
                build_ms=first.time_build * 1e3,
                pool_mib=first.graph_pool_bytes / 2**20,
                outer=last.outer, cumul=last.cumul, obj=last.objval)


def phase11t_tracing(dev, big, on_card: bool) -> dict:
    """The port's tracer (``utils/tracing.py``) on phase 4's solve: off and
    on give bit-identical solutions, the same info and the same launches
    (a loop built with tracing on has the same nodes); on, the spans form
    the entry point's tree, ``tron_steps`` equals the host loop's branch
    stats (the sums of ALM and minor iterations of every inner iteration,
    read back as integers) and, on the card, ``device_s`` (the graph's
    CUDA events) lies inside ``time_overall``; a second solve of a kept
    driver is a tree rooted at ``loop.solve`` that builds nothing."""
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.algorithms.carry import leaves
    from exaadmm_tpu_torch.interface import solve_acopf as iface
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.ops import branch_cuda
    from exaadmm_tpu_torch.utils import tracing
    from exaadmm_tpu_torch.utils.environment import (IterationInformation,
                                                     Parameters)

    def call():
        return E.solve_acopf(big.case, data=big, device=dev, **MAIN_KW)

    _sync(dev)
    _zero_launches()
    off = call()
    _sync(dev)
    l_off = _launches()
    _zero_launches()
    tracing.take()
    tracing.enable()
    try:
        on = call()
        _sync(dev)
    finally:
        tracing.disable()
    spans = tracing.take()
    l_on = _launches()
    for k in _INFO_FIELDS:
        _check(getattr(on.info, k) == getattr(off.info, k),
               f"phase 11t: {k} on {getattr(on.info, k)!r} off "
               f"{getattr(off.info, k)!r}")
    pairs = list(zip(leaves(on.solution), leaves(off.solution), strict=True))
    _check(all(bool(torch.equal(a, b)) for a, b in pairs),
           "phase 11t: the solution differs with tracing on")
    _check(l_on == l_off, f"phase 11t: launches on {l_on} off {l_off}")
    roots = [x for x in spans if x.parent is None]
    _check([x.name for x in roots] == ["entry.solve"]
           and {x.root for x in spans} == {roots[0].id},
           f"phase 11t: roots {[x.name for x in roots]}")
    (solve,) = [x for x in spans if x.name == "loop.solve"]
    kids = [x.name for x in spans if x.parent == solve.id]
    _check(kids == ["loop.build", "loop.inputs", "loop.reset", "loop.launch",
                    "loop.clone", "loop.read_back"],
           f"phase 11t: loop.solve's children {kids}")
    a = solve.attrs
    info = on.info
    _check((a["cumul"], a["outer"], a["status"], a["built"])
           == (info.cumul, info.outer, info.status, True),
           f"phase 11t: the solve's record {a}")
    if on_card:
        _check(0.0 < a["device_s"] <= info.time_overall,
               f"phase 11t: device_s {a['device_s']!r} against "
               f"time_overall {info.time_overall!r}")
    # the host loop's branch stats, read back in every inner iteration
    sums = []
    unpack = branch_cuda.branch_unpack

    def spy(*args, **kwargs):
        out = unpack(*args, **kwargs)
        x, y = out[3][0].item(), out[3][1].item()
        _check(x == int(x) and y == int(y), f"phase 11t: sums {x}, {y}")
        sums.append(int(x) + int(y))
        return out
    branch_cuda.branch_unpack = spy
    try:
        with _host_loop():
            host = call()
    finally:
        branch_cuda.branch_unpack = unpack
    _check(host.info.cumul == info.cumul == len(sums)
           and a["tron_steps"] == sum(sums),
           f"phase 11t: tron_steps {a['tron_steps']} against the host "
           f"loop's {sum(sums)} over {len(sums)} iterations")
    # a kept driver: its second solve builds nothing
    par = Parameters(**{k: MAIN_KW[k] for k in (
        "outer_iterlim", "inner_iterlim", "outer_eps", "verbose")})
    tracing.enable()
    try:
        model = M.build_model(big, par, device=dev)
        drive = iface.two_level_driver(model)
        sol = M.init_solution(model, MAIN_KW["rho_pq"], MAIN_KW["rho_va"])
        drive(model, sol, IterationInformation())
        tracing.take()
        _, again = drive(model, sol, IterationInformation())
        _sync(dev)
    finally:
        tracing.disable()
    spans2 = tracing.take()
    roots2 = [x for x in spans2 if x.parent is None]
    _check([x.name for x in roots2] == ["loop.solve"]
           and roots2[0].attrs["built"] is False
           and "loop.build" not in {x.name for x in spans2}
           and roots2[0].attrs["tron_steps"] > 0,
           f"phase 11t: the kept driver's spans "
           f"{[(x.name, x.parent) for x in spans2]}")
    ms = {x.name: x.seconds * 1e3 for x in spans if x.parent == solve.id}
    dev_s = a.get("device_s")
    print(f"phase 11t: tracing on == off (solution bit-identical, info "
          f"equal, launches equal); {len(spans)} spans; tron_steps "
          f"{a['tron_steps']} == the host loop's stats over {len(sums)} "
          f"iterations ({a['tron_steps'] / (a['nline'] * info.cumul):.3f} "
          f"a lane an iteration); time_overall {info.time_overall * 1e3:.3f}"
          f" ms, device_s "
          f"{'none' if dev_s is None else f'{dev_s * 1e3:.3f} ms'}; "
          f"loop spans ms {ms}; kept driver: root loop.solve, built False")
    return dict(spans=len(spans), tron_steps=a["tron_steps"],
                device_s=dev_s, time_overall=info.time_overall,
                cumul=info.cumul)


def _loop_vs_plain(dev, on_card: bool, trips: int = 2000) -> dict:
    """The set-condition kernel against its plain version: a loop whose
    body adds one to a counter and sets the flag to (counter < trips), run
    by ``GraphLoop`` (one WHILE node) and by ``run_on_host`` (the host
    reads the flag back every trip). Both must stop at ``trips``; ``ms`` is
    the loop's device time per trip (the kernel's own where the profiler
    names it), ``plain_ms`` the host loop's per trip."""
    from exaadmm_tpu_torch.ops import bounds, graph_loop

    x = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.ones((), dtype=torch.int32, device=dev)

    def body(x=x, flag=flag):
        x.add_(1)
        flag.copy_(x < trips)

    def reset():
        x.zero_()
        flag.fill_(1)

    reset()
    graph_loop.run_on_host((body,), (flag,))
    _sync(dev)
    t0 = time.perf_counter()
    reset()
    graph_loop.run_on_host((body,), (flag,))
    plain_ms = (time.perf_counter() - t0) * 1e3 / trips
    n_host = int(x)
    if not on_card:
        ms, n_dev, kernel_ms = plain_ms, n_host, None
    else:
        w = torch.zeros((), dtype=torch.int64, device=dev)
        wflag = torch.ones((), dtype=torch.int32, device=dev)
        loop = graph_loop.GraphLoop((body,), (flag,),
                                    warmup=lambda: body(w, wflag))
        reset()
        loop.launch()
        _sync(dev)
        # the set-condition kernel's own device counter: 1 + trips runs
        n_set = int(loop.counts.values[loop.counts.adds["graph_loop"][0]])
        _check(n_set == trips + 1,
               f"set-condition loop: {n_set} counted launches for {trips} "
               f"trips")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset()
        start.record()
        loop.launch()
        end.record()
        _sync(dev)
        ms = start.elapsed_time(end) / trips
        n_dev = int(x)
        reset()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            loop.launch()
            _sync(dev)
        kernel_ms = None
        for e in prof.key_averages():
            if "set_condition" in e.key:
                t = getattr(e, "self_device_time_total", None)
                if t is None:
                    t = e.self_cuda_time_total
                kernel_ms = t / 1e3 / max(e.count, 1)
    err = abs(n_dev - trips) + abs(n_host - trips)
    # the flag read, the 8-byte counter read and written, one add
    bound_ms, bound_by = bounds.bound(4 + 8 + 8, 1)
    print(f"phase 11: set-condition loop of {trips} trips: device stops at "
          f"{n_dev}, host at {n_host}; device ms per trip {ms:.5f} (the "
          f"set-condition kernel alone "
          f"{'not named by the profiler' if kernel_ms is None else f'{kernel_ms:.5f}'}"
          f"), host loop ms per trip {plain_ms:.5f}; bound {bound_ms:.2e} "
          f"({bound_by})")
    _check(err == 0, f"set-condition loop: {n_dev} / {n_host} trips")
    return dict(ms=kernel_ms if kernel_ms is not None else ms,
                loop_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, dx_all=float(err), library_ms=None,
                enqueue_ms=None)


def main_runs(dev, big, mp_data, mp_loads, T: int) -> dict:
    """The main paths' solves of phases 4-8 and 10a, by phase, each a call
    of its entry point at verbose 0 (the fused driver)."""
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS

    qp = qp_inputs(big)
    return {
        "phase 4": lambda: E.solve_acopf(big.case, data=big, device=dev,
                                         **MAIN_KW),
        "phase 5": lambda: E.solve_mpacopf(
            mp_data.case, data=mp_data, loads=mp_loads, end_period=T,
            rho_pq=4e2, rho_va=4e4, outer_iterlim=3, inner_iterlim=50,
            outer_eps=0.0, warm_start=False, verbose=0, device=dev),
        "phase 6": lambda: E.solve_qpsub(
            big.case, *[qp[k] for k in QP_KEYS], 1e5, data=big,
            outer_iterlim=QP_ITERS, scale=1e-4, rho_pq=4e3, rho_va=4e3,
            outer_eps=0.0, tron_step_cap=24, verbose=0, device=dev),
        "phase 7": lambda: E.solve_acopf_mpec(
            big.case, data=big, rho_pq=3e3, rho_va=3e5, outer_iterlim=10,
            inner_iterlim=100, outer_eps=0.0, verbose=0, device=dev,
            **MPEC_STORAGE),
        "phase 8": lambda: E.solve_acopf(
            big.case, data=big, use_linelimit=False, device=dev,
            **dict(MAIN_KW, outer_iterlim=10)),
        "phase 10a mixed": lambda: E.solve_acopf(
            big.case, data=big, device=dev, mixed_precision=True,
            **MAIN_KW),
    }


def phase11_fused(dev, big, mp_data, mp_loads, T: int, on_card: bool,
                  case9_outer=None, qp_iters=None) -> dict:
    """The fused drivers against the host loops on the configurations of
    phases 4-8, 10a's mixed solve, 10b's sorted solve, 9a's mesh of one
    rank and the case9 pins of phase 3 (a
    rehearsal may cut the case9 solves to ``case9_outer`` outer iterations
    and the case9 QP to ``qp_iters``)."""
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
    from exaadmm_tpu_torch.models.qpsub.sqp import SqpBasePoint
    from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
    from tests import qpsub_fixture as fx

    def one(res):
        return [(res.info, res.solution)]

    def pin(n):
        return n if case9_outer is None else min(n, case9_outer)

    out = {"loop": _loop_vs_plain(dev, on_card)}
    for label, call in main_runs(dev, big, mp_data, mp_loads, T).items():
        out[label] = _fused_pair(dev, label, call, one, on_card,
                                 two_level=label != "phase 6")
    # 10b's sorted solve, whose driver the interface module chooses, and
    # 9a's solve over a mesh of one rank
    from exaadmm_tpu_torch.interface import solve_acopf as iface
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.utils.environment import Parameters

    smodel = M.build_model(big, Parameters(sort_lines=True, **{
        k: MAIN_KW[k] for k in ("outer_iterlim", "inner_iterlim",
                                "outer_eps", "verbose")}), device=dev)

    def sorted_call():
        return iface.two_level_driver(smodel)(smodel, M.init_solution(
            smodel, MAIN_KW["rho_pq"], MAIN_KW["rho_va"]))

    out["phase 10b sorted"] = _fused_pair(
        dev, "phase 10b sorted", sorted_call, lambda r: [(r[1], r[0])],
        on_card)
    with _one_rank_mesh(dev, on_card) as mesh:
        out["phase 9a mesh"] = _fused_pair(
            dev, "phase 9a mesh", lambda: E.solve_acopf(
                big.case, data=big, mesh=mesh, device=dev, **MAIN_KW),
            one, on_card)
    data9 = opf_loaddata(CASE9, verbose=0)
    va = np.zeros(data9.nbus)
    va[data9.line_from] = fx.line_var[4]
    va[data9.line_to] = fx.line_var[5]
    qp9 = qp_inputs(data9, SqpBasePoint(pg=fx.pg, qg=fx.qg,
                                         vm=np.sqrt(fx.bus_w), va=va))
    kw9 = dict(rho_pq=4e2, rho_va=4e4, verbose=0, device=dev)
    pins = {
        "case9 (3)": (lambda: E.solve_acopf(
            CASE9, outer_eps=2e-5, outer_iterlim=pin(25), **kw9),
            one, (PIN_OUTER, PIN_CUMUL)),
        "case9 x 3 periods (3b)": (lambda: E.solve_mpacopf(
            CASE9, DEMAND9, end_period=3, outer_iterlim=pin(30),
            warm_start=False, **kw9), one, (MP_PIN_OUTER, MP_PIN_CUMUL)),
        "case9 QP (3c)": (lambda: E.solve_qpsub(
            CASE9, *[qp9[k] for k in QP_KEYS], 1e5,
            outer_iterlim=qp_iters or 10000, scale=1e-4, rho_pq=4000.0,
            rho_va=4000.0, outer_eps=2e-6, verbose=0, device=dev),
            one, (QP_PIN_ITERS, QP_PIN_ITERS)),
        "case9 no line limits (3d)": (lambda: E.solve_acopf(
            CASE9, outer_eps=2e-4, outer_iterlim=pin(25),
            use_linelimit=False, **kw9), one,
            (POLAR_PIN_OUTER, POLAR_PIN_CUMUL)),
        "case9 MPEC (3e)": (lambda: E.solve_acopf_mpec(
            CASE9, outer_iterlim=pin(40), outer_eps=2e-4, **kw9), one,
            MPEC_PINS["without storage"][:2]),
        "case9 MPEC with storage (3e)": (lambda: E.solve_acopf_mpec(
            CASE9, outer_iterlim=pin(40), outer_eps=2e-4, storage_ratio=0.3,
            storage_charge_max=0.1, **kw9), one,
            MPEC_PINS["with storage"][:2]),
        "case9 rolling (3f)": (lambda: E.solve_acopf_rolling(
            CASE9, DEMAND9, outer_iterlim=pin(25), outer_eps=2e-4,
            end_period=3, tight_factor=1.0, **kw9),
            lambda r: [(i, None) for i in r[1][:-1]]
            + [(r[1][-1], r[0].solution)], ROLLING_PINS[0][:2]),
    }
    for label, (call, periods, (outer, cumul)) in pins.items():
        r = _fused_pair(dev, label, call, periods, on_card,
                        two_level="QP" not in label)
        if case9_outer is None and qp_iters is None:
            # the first period for the rolling horizon
            got = r["outer"], r["cumul"]
            if "rolling" not in label:
                _check(abs(got[0] - outer) <= 1
                       and abs(got[1] - cumul) <= 0.02 * cumul,
                       f"phase 11 {label}: {got} against the pin "
                       f"{(outer, cumul)}")
        out[label] = r
    return out


def profile_fused(dev, label: str, call) -> dict:
    """Where a fused solve's time goes: ``call()`` under torch.profiler,
    with the port's tracer on; from the graph's launch (its ``loop.launch``
    span) to the last device activity, the device's busy time and idle
    share, per inner iteration."""
    from exaadmm_tpu_torch.utils import tracing
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    tracing.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            res = call()
            _sync(dev)
    finally:
        tracing.disable()
        tracing.take()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the host's range (the profiler also puts the spans' ranges on the
    # device's timeline)
    marks = [e for e in events if e.name == "loop.launch"
             and getattr(e, "device_type", None) != cuda]
    _check(len(marks) == 1, f"profile {label}: {len(marks)} launches")
    t0 = marks[0].time_range.start
    dev_ev = [e for e in events
              if getattr(e, "device_type", None) == cuda
              and not e.name.startswith(("loop.", "entry."))
              and e.time_range.start >= t0]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_ev)
    span_us = max(e.time_range.end for e in dev_ev) - t0
    n = res.info.cumul
    print(f"profile {label} fused: {n} inner iterations, from the launch "
          f"to the last device activity {span_us / 1e3:.3f} ms "
          f"({span_us / 1e3 / n:.4f} ms per iteration), device busy "
          f"{busy_us / 1e3 / n:.4f} ms per iteration, idle share "
          f"{1 - busy_us / span_us:.3f}; {len(dev_ev) / n:.1f} device "
          f"activities and 0 host calls per iteration (1 launch per solve)")
    return dict(span_ms=span_us / 1e3, busy_ms=busy_us / 1e3, iters=n,
                idle=1 - busy_us / span_us)


def two_level_hooks(model, beta: float = 1e3):
    """The two-level driver's inner iteration, hook by hook: (name,
    fn(sol, iteration)); the last returns (sol, scalars)."""
    return (
        ("x", lambda s, it: model.update_x(model.inner_prestep(s), it)[0]),
        ("xbar", lambda s, it: model.update_xbar(s)),
        ("z", lambda s, it: model.update_z(s, beta)),
        ("l", lambda s, it: model.update_l(s, beta)),
        ("residual", lambda s, it: model.update_residual(s, beta)),
    )


def one_level_hooks(model):
    """The one-level driver's iteration, hook by hook, as
    ``two_level_hooks``; ``model`` is the driver's (``solve_prep``'s)."""
    return (
        ("x", lambda s, it: model.update_x(s, it)[0]),
        ("xbar", lambda s, it: model.update_xbar(s)),
        ("l", lambda s, it: model.update_l_single(s)),
        ("residual", lambda s, it: model.update_residual(s, 0.0)),
    )


def profile_main(dev, label: str, hooks, sol, readback, warmup: int = 5,
                 iters: int = 20) -> dict:
    """Where an iteration's time goes for ``hooks`` from ``sol``: host time
    per hook with a synchronize after each hook; the wall time per
    iteration without them; and, from torch.profiler over the same
    unsynchronized iterations, the device time by kernel and the device's
    idle share. ``readback`` names the scalars the driver reads back each
    iteration."""
    state = {"sol": sol, "inner": 0}

    def step(times=None):
        state["inner"] += 1
        sol = state["sol"]
        for name, fn in hooks:
            t0 = time.perf_counter()
            sol = fn(sol, state["inner"])
            if name == "residual":
                sol, scalars = sol
                # the driver's one read-back
                torch.stack([scalars[k] for k in readback]).tolist()
            if times is not None:
                _sync(dev)
                times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        state["sol"] = sol

    for _ in range(warmup):
        step()
    times = {}
    for _ in range(iters):
        step(times)
    hook_ms = {k: v * 1e3 / iters for k, v in times.items()}
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            step()
        _sync(dev)
    kernels = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            kernels[e.key] = (t / 1e3 / iters, e.count / iters)
    busy_ms = sum(t for t, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    print(f"profile {label}: per iteration {wall_ms:.3f} ms wall; with "
          f"a synchronize after each hook: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in hook_ms.items()))
    print(f"profile {label}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {launches:.1f} device "
          f"activities per iteration")
    # the 12 largest, then the port's own kernels wherever they rank
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    own = [kv for kv in ranked[12:]
           if "tron_alm" in kv[0] or "bus_scatter" in kv[0]
           or "_kernel<" in kv[0]]
    for name, (t, n) in ranked[:12] + own:
        print(f"profile {label}:   {t:9.4f} ms x{n:5.1f}  {name[:100]}")
    return dict(wall_ms=wall_ms, hook_ms=hook_ms, busy_ms=busy_ms,
                launches=launches)


def solve_to_tolerance(dev, data) -> dict:
    """Time to tolerance: the full solve of ``data`` in fp64 at rho (3e3,
    3e5) and the default outer_eps 2e-4, 20 outer iterations at most (the
    kernels are already built)."""
    import exaadmm_tpu_torch as E

    _sync(dev)
    t0 = time.perf_counter()
    res = E.solve_acopf(data.case, data=data, rho_pq=3e3, rho_va=3e5,
                        outer_iterlim=20, verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    info = res.info
    print(f"solve: {data.case} fp64 {info.status} in {secs:.3f} s: "
          f"{info.outer} outer, {info.cumul} inner ({info.cumul / secs:.2f} "
          f"it/s), mismatch {info.mismatch!r}, obj {info.objval!r}, max "
          f"line-limit violation {info.max_cviol!r}")
    return dict(status=info.status, seconds=secs, cumul=info.cumul)


def run(device, big_data, mp_data, mp_loads, T: int,
        case118_outer: int = 25, case9_mixed_outer: int = 30,
        case9_fused_outer=None, qp_fused_iters=None) -> dict:
    """All phases on ``device``; ``big_data`` is the single-period grid,
    ``mp_data`` with ``mp_loads`` ((Pd, Qd), (nbus, T) each) the
    multi-period one. On a CPU device (a rehearsal) the wrappers run their
    plain versions, so the kernel comparisons and launch counts are not
    meaningful there; a rehearsal may cut the depth of case118, of phase
    10a's case9 solves and of phase 11's case9 pairs."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mp = (mp_data, mp_loads, T, on_card)
    results = {"device": phase0_device(dev, on_card)}
    results["bus"] = phase1_bus(dev, big_data, on_card)
    results["bus_periods"] = phase1b_bus_periods(dev, *mp)
    results["bus_mpec"] = phase1c_bus_mpec(dev, big_data, on_card)
    results["tron"] = phase2_tron(dev, big_data, on_card)
    results["tron_mp"] = phase2_branch_periods(dev, *mp)
    results["ramp"] = phase2b_ramp(dev, *mp)
    results["qpsub"] = phase2c_qpsub(dev, big_data, on_card)
    results["polar"] = phase2d_polar(dev, big_data, on_card)
    results["branch_io"] = phase2f_branch_io(dev, big_data, mp_data,
                                             mp_loads, T, on_card)
    results["case9"] = phase3_case9(dev, on_card)
    results["case9_mp"] = phase3b_case9_mpacopf(dev, on_card)
    results["case9_qp"] = phase3c_case9_qpsub(dev, on_card)
    results["case9_polar"] = phase3d_case9_polar(dev, on_card)
    results["case9_mpec"] = phase3e_case9_mpec(dev, on_card)
    results["case9_rolling"] = phase3f_case9_rolling_projection(dev, on_card)
    results["case118"] = phase3g_case118(dev, on_card, case118_outer)
    results["checkpoint"] = phase3h_checkpoint(dev, on_card)
    results["hooks"] = phase4h_hooks(dev, big_data, on_card)
    results["main"] = phase4_main(dev, big_data, on_card)
    results["main_mp"] = phase5_mpacopf(dev, *mp)
    results["mp_hooks"] = phase5h_mp_hooks(dev, *mp)
    results["main_qp"] = phase6_qpsub(dev, big_data, on_card)
    results["main_mpec"] = phase7_mpec(dev, big_data, on_card)
    results["main_polar"] = phase4_main(dev, big_data, on_card,
                                        use_linelimit=False, label="phase 8",
                                        outer_iterlim=10)
    results["main_mesh1"] = phase9a_mesh_one_rank(dev, big_data, on_card,
                                                  results["main"])
    results["main_2ranks"] = phase9b_two_ranks(dev, big_data, on_card,
                                               results["main"])
    results["mixed"] = phase10a_mixed(dev, big_data, on_card,
                                      results["main"], case9_mixed_outer)
    results["sort"] = phase10b_sort(dev, big_data, *mp, results["main"])
    results["fused"] = phase11_fused(dev, big_data, mp_data, mp_loads, T,
                                     on_card, case9_fused_outer,
                                     qp_fused_iters)
    results["tracing"] = phase11t_tracing(dev, big_data, on_card)
    results["main_mixed"] = results["mixed"]["main"]
    results["main_sorted"] = results["sort"]["sorted"]
    main_runs = ("main", "main_mp", "main_qp", "main_mpec", "main_polar",
                 "main_mesh1", "main_2ranks", "main_mixed", "main_sorted")
    kern = []
    for name, key in (("tron_alm_branch", "tron"), ("tron_alm_ramp", "ramp"),
                      ("tron_alm_qpsub", "qpsub"), ("bus_scatter", "bus"),
                      ("tron_alm_polar", "polar"), ("graph_loop", "fused")):
        r = (results[key]["loop"] if key == "fused"
             else results[key]["f64"])
        if key == "bus":
            err = max(r["abs"], results["bus_periods"]["f64"]["abs"],
                      results["bus_mpec"]["f64"]["abs"])
        elif key == "tron":
            err = max(r["dx_all"], results["tron_mp"]["f64"]["dx_all"])
        elif key == "qpsub":
            err = max(r["dx_all"], results["qpsub"]["f64_nolimit"]["dx_all"])
        else:
            err = r["dx_all"]
        kern.append({"name": name, "route": "cuda",
                     "source": KERNEL_SOURCES[name][0],
                     "replaces": KERNEL_SOURCES[name][1],
                     "launches": sum(results[m]["launches"][name]
                                     for m in main_runs),
                     "max_abs_err": err, "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "device_ms": r["ms"], "enqueue_ms": r["enqueue_ms"]})
    for name, replaces, key, src in (
            [(k, v, "hooks", "acopf_hooks") for k, v in HOOK_KERNELS.items()]
            + [(k, v, "branch_io", "branch_io")
               for k, v in BRANCH_IO_KERNELS.items()]
            + [(k, v, "mp_hooks", "mpacopf_hooks")
               for k, v in MP_HOOK_KERNELS.items()]):
        r = results[key][name]
        kern.append({"name": name, "route": "cuda",
                     "source": KERNEL_SOURCES[src][0],
                     "replaces": replaces,
                     "launches": sum(results[m]["launches"][name]
                                     for m in main_runs),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "device_ms": r["ms"], "enqueue_ms": r["enqueue_ms"]})
    results["kernels"] = kern
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.interface.solve_mpec import \
        build_model as build_mpec
    from exaadmm_tpu_torch.models.mpec import model as MM
    from exaadmm_tpu_torch.models.qpsub import model as Q
    from exaadmm_tpu_torch.utils.environment import Parameters
    from exaadmm_tpu_torch.utils.profiling import profile_iteration
    from exaadmm_tpu_torch.utils.synthetic import (synthetic_case,
                                                   synthetic_load_profile)

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    big = synthetic_case(9241, seed=0, line_ratio=1.7)
    T = 8
    mp_data = synthetic_case(2869, seed=0, line_ratio=1.7)
    mp_loads = synthetic_load_profile(mp_data, T, seed=0)
    results = run("cuda", big, mp_data, mp_loads, T)
    if "--profile" in sys.argv[1:]:
        model = M.build_model(big, Parameters(verbose=0), device=dev)
        profile_main(dev, "phase 4", two_level_hooks(model),
                     M.init_solution(model, 3e3, 3e5), ("primres",))
        hooks = profile_iteration(model, M.init_solution(model, 3e3, 3e5),
                                  1e3, iters=10)
        print("profile phase 4: profile_iteration, device ms per hook: "
              + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in hooks.items()))
        model = _mp_model(dev, mp_data, mp_loads, T, torch.float64,
                          Parameters(verbose=0))
        profile_main(dev, "phase 5", two_level_hooks(model),
                     MP.init_solution(model, 4e2, 4e4), ("primres",))
        model = Q.build_model(big, Parameters(verbose=0, tron_step_cap=24),
                              qp_inputs(big), device=dev)
        sol = model.one_level_reset(Q.init_solution(model, 4e3, 4e3))
        profile_main(dev, "phase 6", one_level_hooks(model.solve_prep(sol)),
                     sol, ("mismatch", "dualres"))
        model = build_mpec(big, Parameters(verbose=0), **MPEC_STORAGE,
                           device=dev)
        profile_main(dev, "phase 7", two_level_hooks(model),
                     MM.init_solution(model, 3e3, 3e5), ("primres",))
        model = M.build_model(big, Parameters(verbose=0), use_linelimit=False,
                              device=dev)
        profile_main(dev, "phase 8", two_level_hooks(model),
                     M.init_solution(model, 3e3, 3e5), ("primres",))
        # phase 4's solve fused and phase 8's, then phase 4's sorted (10b)
        # and over a mesh of one rank (9a), then phases 5-7: a long
        # profiled run can leave the profiler's later sessions short of
        # device activities
        runs = main_runs(dev, big, mp_data, mp_loads, T)
        profile_fused(dev, "phase 4", runs["phase 4"])
        profile_fused(dev, "phase 8", runs["phase 8"])
        import exaadmm_tpu_torch as E
        from exaadmm_tpu_torch.algorithms.admm_two_level import \
            two_level_driver
        model = M.build_model(big, Parameters(sort_lines=True, **{
            k: MAIN_KW[k] for k in ("outer_iterlim", "inner_iterlim",
                                    "outer_eps", "verbose")}), device=dev)
        driver = two_level_driver(model)
        profile_fused(dev, "phase 10b sorted", lambda: E.SolveResult(
            big, model, *driver(model, M.init_solution(
                model, MAIN_KW["rho_pq"], MAIN_KW["rho_va"]))))
        with _one_rank_mesh(dev, True) as mesh:
            profile_fused(dev, "phase 9a mesh", lambda: E.solve_acopf(
                big.case, data=big, mesh=mesh, device=dev, **MAIN_KW))
        for label in ("phase 5", "phase 6", "phase 7"):
            profile_fused(dev, label, runs[label])
    if "--solve" in sys.argv[1:]:
        solve_to_tolerance(dev, big)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": results["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
