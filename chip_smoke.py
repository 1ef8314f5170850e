#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training steps on one CUDA card: the WTA
step, the 104-column stochastic-adaptive parity step (--fused-pass), the
deterministic fused-dopri5 parity step and its 104-column fused-split2
tier, the XOR task's deterministic, stochastic and stochastic-adaptive
steps, the Hopf task's step, the 13-column fixed-grid and adaptive stochastic parity steps,
bench.py's 104-column stochastic-adaptive configuration, the 104-column
fixed-grid stochastic parity step (outer mode), the exact three-term
stochastic-adaptive step at 104 columns with the 32-column kernel-mode
steps, the f32-exact deterministic engine past one block (32 columns in
kernel mode, 104 in outer mode), the two-term split's kernel-mode
sweeps and exact outer pass (32 and 104 columns), and the Hopf MLP in outer
mode (the reference width, and a 3-512-512-512-2 MLP past the 1 MiB rule).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero without printing a result. The CPU half of every card-vs-CPU check
below runs in one of two worker processes, on a few CPU threads each, while
the script goes on driving the card; each path's checks print their line,
``<path>_cpu_check``, at the end, beside the command lines.

0. card: name and power limit (nvidia-smi), TF32 off.
1. build: the CUDA kernels, compiled by nvcc from columnflow_torch/kernels/csrc
   (one nvcc per source, in parallel), with their register and spill report.
WTA (T = 1500 grid points, 15 and 60 lanes):
2. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes.
3. main path: 5 training steps at batch 16 (15 rollout lanes) and one with
   4 noise repetitions (60 lanes), targets from make_wta_dataset; the launch
   counters must show one forward and one backward kernel per step, and the
   first step must agree with the same step run on the CPU.
   Evaluation path: the trained model's held-out rollout and its drift at
   the end state, through the public fused_drift.
4. times: each kernel's device time and its plain version's time with CUDA
   events, the train step's wall time and a profile of it.
Parity (104 columns = 832 populations, state 2496, 4 lanes, 1000 grid
points over 1 s, max_steps 16384, the flagship's flags):
5. kernel vs plain: the selection's attempt entry on 64 states of a
   full-horizon replay; the whole selection over 25 grid points; the
   replay and its reverse sweep on 64-half-step windows early, in the middle
   and late in the full-horizon replay.
6. main path: 1 training step through the kernels, the launch counters
   asserted per step; a step repeated on the CPU with the plain versions on
   the card's frozen grid and lane words: at 104 columns over 5 grid points
   (every gradient) and 25 (the output weights), at 13 columns over 100.
7. times: each kernel's device time in the main path's step (CUDA events
   around its call), its bound and ns per serial step, the kernel and its
   plain version over 25 grid points, the train step's wall time, and a
   profile of a step over 100 points.
Deterministic parity (13 columns = 104 populations, state 312, batch 4 under
one controller, 1000 grid points over 1 s, max_steps 3072 -> 3078, dopri5 at
rtol 1e-7 / atol 1e-9: the reference network at its full width):
8. kernel vs plain: the whole selection against its plain loop over 100
   grid points (its common accepted prefix), single attempts from states
   along the replay, the replay and its reverse sweep on 64-step windows
   early, in the middle and late in the full replay; the sweep (the
   kernel-mode sweep's cluster team for the batch) bit for bit against its
   plain version and against B8, the one-block kernel it replaced.
9. main path: 5 training steps through the kernels, one launch of each per
   step (the sweep's team, never B8); the first step's weights over 100 grid points on the card and
   again on the CPU with the plain versions on the card's frozen grid
   (loss, gradients and the gradients' own spread under a 1e-7 nudge of
   the weights).
10. times: each kernel's device time, ns per accepted step, its bound, its
   plain version's time on the first 64 steps, the train step's wall time
   and a profile of it; the sweep's team against B8 on a 256-step window
   (team_routes, CUDA events on the same call, bit for bit).
Deterministic parity, fused-split2 tier (104 columns = 832 populations,
state 2496, batch 4 under one controller, 1000 grid points over 1 s,
max_steps 16384, dopri5 at rtol 1e-7 / atol 1e-9; selection on the
three-term split, values and gradients on the two-term one, the weight
gradients outside the kernels):
11. kernel vs plain: the whole selection over 12 grid points (the full
   second needs ~1.3e4 attempts), single attempts from states along
   the replay, the replay (bit for bit) and the emit-mode sweep on 64-step
   windows early, in the middle and late; 16 lanes through the selection
   and the replay (bit for bit, clusters of 8).
12. main path: 1 training step through make_train_step(task, split2=True),
   one launch of each of the tier's three kernels per step.
13. card vs CPU: one step over 5 grid points on the card's frozen grid
   (loss, gradients and the CPU's own spread under a 1e-7 nudge), and one
   at 13 columns over 50 points; the gradient's norm over 50 and 200
   points.
14. times: each kernel and the outer weight-gradient pass in the main
   path's step (CUDA events around each call), ns per serial step, its
   bound, its plain version on a short window, the train step, and a
   profile of a step over 100 points; the cluster teams' routes against
   team8 (B6, B7 split2 on a 256-step window, B8').
15. the command line: python -m columnflow_torch.tasks.parity
   --columns-per-area 64,32,8 --smoke --max-steps 4096 trains the tier on
   the card.
XOR (3 columns = 24 populations, state 72, the four conditions as one batch,
1000 grid points over 1 s, max_steps 3072 -> 3135; deterministic dopri5 at
rtol 1e-7 / atol 1e-9, and SRA1 on the uniform grid with sigma = 10 on the
membrane block):
16. kernel vs plain, bit for bit: 16 single attempts, the replay and the
   kernel-mode sweep on 64-step windows early, in the middle and late in
   the card's grid, the SDE and its sweep over the first 250 steps; the
   whole selection over 250 points (0.25 s) by its counts (within 1%) and
   its first 10 accepted times, and reported as bit for bit or not.
17. main path: 3 deterministic and 3 stochastic train steps through
   make_train_step, one launch of each of their kernels per step and none of
   anything else; the evaluation of the four conditions.
18. card vs CPU: each engine's first step again on the CPU with the plain
   versions on the card's grid and noise (loss, gradients), beside the
   card's own gradient spread under a 1e-7 nudge of the weights.
19. times: each kernel's device time, ns per serial step, its bound, its
   plain version's time; both train steps' times and profiles.
Hopf (the MLP 3 -> 100 -> 100 -> 100 -> 2, batch 32 as one (32, 2) state
under one controller, 1000 grid points over 25 s, max_steps 1024, dopri5 at
rtol 1e-7 / atol 1e-9, targets from make_hopf_dataset):
20. kernel vs plain, bit for bit: the whole selection (by its counts within
   1% and its first 10 accepted times where the grids part, and reported as
   bit for bit or not), 16 single attempts along the replay, the replay and
   the kernel-mode sweep over the whole grid.
21. main path: 3 train steps through make_train_step, one launch of each of
   the three kernels per step and none of anything else, and the validation
   forward; the first step again on the CPU with the plain versions on the
   card's grid: the loss within 1e-5, each gradient within the larger of
   1e-5 and ten times the card's own spread under a 1e-7 nudge of the
   weights.
22. times: each kernel's device time, ns per serial step, its bound, its
   plain version's time; the train step's time and profile (each timed step
   from the seed weights).
23. the command line: python -m columnflow_torch.tasks.bifurcation --smoke.
Stochastic parity at 13 columns (104 populations, state 312, 4 lanes, 1000
grid points over 1 s, the three-term split in kernel mode): the fixed-grid
SDE step (--stochastic: SRA1 on the uniform grid, 999 steps, B3t and B4't)
and the adaptive step with the XLA selection (--stochastic --adaptive: the
jax.random tree, the float32 drift, max_steps 3072, then B3t and B4't on
the lanes' grids):
24. kernel vs plain, bit for bit: the selection over 25 grid points, 16
   attempts along the replay, B3t and B4't on 64-half-step windows of the
   lane-batched replay early, in the middle and late, and both over the
   first 250 steps of the uniform grid.
25. main path: 3 train steps of each through make_train_step, one launch of
   each of their kernels per step and none of anything else; each first
   step again on the CPU on the card's grid and noise (the fixed grid over
   the full second, the adaptive step over 100 points): the loss within
   1e-5, each gradient within the larger of 1e-3 and ten times the card's
   own spread under a 1e-7 nudge of the weights.
26. times: each kernel's device time, ns per serial step, its bound, its
   plain version's time; both steps' times and profiles.
27. the command lines: --smoke --stochastic and --smoke --stochastic
   --adaptive.
bench.py's primary configuration (104 columns, 4 lanes, 1000 grid points,
max_steps 16384, --stochastic --adaptive under --engine auto: the jax.random
tree's selection on the select16 drift, then B3 lanes, B4 emit and the outer
gradbf16 pass; bptt 32, clip 1.0, loss scale 1e-6):
28. main path: 1 train step at full width, one launch of each of the three
   kernels per step; one step over 5 grid points again on the CPU on the
   card's grid.
29. kernel vs plain: the selection of two lanes over 12 grid points (bit for
   bit, or its counts within 1%), 8 attempts along the first step's replay.
30. times: the selection's device time, bound and ns per attempt, the step's
   time and a profile over 100 points; the command line (--smoke
   --stochastic --adaptive --columns-per-area 64,32,8 and the bench flags).
The fixed-grid stochastic parity step at 104 columns (--stochastic
--columns-per-area 64,32,8: 4 lanes, SRA1 on the 999-step uniform grid,
the three-term split, the weight gradients outside the sweep: B3t-team,
B4t, the outer pass):
31. kernel vs plain, bit for bit: B3t-team and B4t on three 64-step windows
   (early, middle, late) of the uniform grid, on a 16-step window of
   per-lane grids from a lanes replay (bench.py's selection over 25
   points), and on an 8-step window at 312 columns.
32. main path: 2 train steps through make_train_step(task, stochastic=True),
   one launch of B3t-team and of B4t per step and of nothing else.
33. card vs CPU: the first step again on the CPU with the plain versions on
   the card's noise over 5 points (every gradient) and 50 (the output
   weights), within the larger of 3e-2 and ten times the card's own spread
   under a 1e-7 nudge; SRA1 at h = 1 ms runs off at this width from the
   fourth step (as in the JAX package), and a gradient that is not finite
   on the CPU must not be finite on the card either.
34. times: each kernel's device time over the whole grid, ns per step, its
   bound, its plain version's time on a window; the outer pass; the train
   step's time and a profile with its idle share; the command line
   (--smoke --stochastic --columns-per-area 64,32,8).
The exact three-term stochastic-adaptive step at 104 columns (--stochastic
--adaptive --engine fused --columns-per-area 64,32,8 with bench.py's bptt
32, clip 1.0, loss scale 1e-6: the jax.random tree's selection on the
float32 drift, B3t-team and B4t in lanes mode, the exact outer pass on the
lanes' own step times), with --fused-pass (B5t) and --grad-bf16, and the
kernel-mode steps at 32 columns (B4't-team):
35. kernel vs plain, bit for bit: the f32 selection of 4 lanes over 25
   grid points and 8 attempts along its replay; B3t-team and B4t over that
   selection's whole lanes grid; B4t lanes at 13 columns. The cluster
   teams' routes (team_routes): B3t-team and B4t on a 256-half-step window
   of that lanes grid on the shape's route, the other one and team8 (the
   8-block teams they replaced), CUDA events on the same call.
36. B5t against its plain version, bit for bit: the whole selection at 13
   columns over 25 points of the second, at 104 columns over 25 points
   and 8 attempts.
37. B4't-team against its plain version, bit for bit, at 32 and 63 columns
   on a 64-step uniform window and a lanes window; against B4't at 13.
   B3t-team at 32 columns on that uniform window against its plain
   version, bit for bit; the teams' routes at 32 columns on a 256-step
   uniform window.
38. main path: one exact step over the full second, one launch each of the
   selection, B3t-team and B4t; card against CPU over 5 points (the loss
   within the larger of 1e-5 and ten times its nudge spread, each gradient
   within the larger of 3e-2 and ten times its, a limit of at most 0.25);
   the step's profile over 100 points; each kernel and the outer pass
   timed in the step (CUDA events around each call).
39. --fused-pass and --grad-bf16 over 100 points: one step each, launches
   counted, card against CPU over 5 points; B5t's time.
40. 32 columns over the full second: one --stochastic and one --stochastic
   --adaptive step through B4't-team, card against CPU over 5 points;
   B4't-team's time over the fixed grid.
41. the five command lines of this path (run with the others at the end).
The XOR stochastic-adaptive step (--stochastic --adaptive, and --fused
--fused-pass; run after phase 19): 4 lanes of state 72, 1000 grid points
over 1 s, each lane's step-doubling SRA1 selection (max_steps 2048) on the
jax.random tree (the XLA selection as a kernel) or the krng tree (B5x),
the lanes' replay (B3xl) and its kernel-mode sweep (B4'xl):
42. kernel vs plain, bit for bit: each tree's whole selection over 12 grid
   points, 16 attempts along each tree's full replay, B3xl and B4'xl on
   64-half-step windows early, in the middle and late of the full grid.
43. main path: 3 steps of each tree's step through make_train_step, one
   launch of the selection, B3xl and B4'xl per step and of nothing else;
   each lane's accepted and rejected counts and the time it reached.
44. card vs CPU: each tree's first step over 100 grid points (the stimulus
   on from point 50, inside the budget) on the card, and again on the CPU
   with the plain versions on the card's grid and keys: the loss and the
   rows' gradients within the larger of 1e-4 and ten times the card's own
   spread under a 1e-7 nudge, capped at 0.25.
45. times: each kernel's device time at full width, ns per serial step,
   its bound, its plain version's time; each step's time and profile.
46. the two command lines (run with the others at the end).
The f32-exact deterministic engine past one block (the parity command line
with no engine flag from 18 through 103 columns, --engine fused from 104
through 312; batch 4 under one controller, 1000 grid points over 1 s,
max_steps 16384, dopri5 at rtol 1e-7 / atol 1e-9; run after phase 41):
47. kernel vs plain: the selection at 32 columns against its plain loop
   over 50 grid points (its common accepted prefix); bit for bit, B7t-team
   at 24, 32 and 104 columns on 64-step (104: 16-step) windows of the
   kernel's own full replay (early, in the middle and late at 32 and 104
   columns, the middle at 24), and on an 8-step window at 312 columns;
   the kernel-mode sweep's cluster team at 18, 32 and 63 columns the same
   way (three windows at 32), against its plain version and against
   B8t-team (route "team8"), the kernel it replaced there; B8't at 104.
   The 104-column grid is the split2 phase's (both tiers select on the
   three-term drift).
48. main path: one full step at 32 columns (kernel mode: one launch each of
   the selection, B7t-team and the sweep's team) and one at 104 on the split2
   phase's frozen grid (outer mode: one launch each of B7t-team and B8't,
   then the outer pass); each kernel's device time from CUDA events around
   its call in that step.
49. card vs CPU on the card's grid, over 50 grid points at 32 columns and
   5 at 104: the loss within the larger of 1e-5 and ten times its nudge
   spread, each gradient within the larger of 1e-3 and ten times the
   card's own spread under a 1e-7 nudge, a limit of at most 0.25 (as phase
   38). Over 5 points at 32 columns the network has barely answered the
   stimulus and a 1e-7 nudge moves the lateral gradient by ~9%.
50. times: each kernel's bound and ns per accepted step, the plain
   versions on a middle window, both steps' profiles over 100 points;
   B7t-team's routes against team8 on 256-step windows of the full
   replays at 104 and 32 columns; the sweep's team against B8t-team on a
   256-step window at 32 columns (bit for bit).
51. the two command lines (--columns-per-area 16,8,8 and --engine fused
   --columns-per-area 64,32,8 --max-steps 16384, with --smoke), each step's
   selection reaching the last grid point.
The two-term split with its exact weight gradients (run after phase 51):
the deterministic fused-split2 tier in kernel mode (``--engine
fused-split2`` through 63 columns: B6, B7 split2, B8s), the
stochastic-adaptive split2 replay in kernel mode (``--stochastic --adaptive
--engine fused-split2`` through 63 columns: the f32 selection on the
jax.random tree, B3, B4s) and with the exact outer pass from 64 columns
(B3, B4, ``outer_arg_grads_split2``); batch 4, 1000 grid points over 1 s:
52. kernel vs plain, bit for bit, at 13, 32 and 63 columns: B7 split2 and
   B8s on 32-step windows of the deterministic selection's grid over 100
   points (early, middle and late at 32 columns, the middle elsewhere), B3
   and B4s the same way on 32-half-step windows of the f32 selection's
   lanes grid over 100 points.
53. main path: one deterministic split2 step at 32 columns over the full
   second (max_steps 16384), one stochastic-adaptive split2 step there
   (max_steps 3072, the command line's default: it ends before 1 s, as at
   13 columns), one exact split2 stochastic-adaptive step at 104 columns
   over 100 points (max_steps 16384); one launch of each kernel of the path
   and of nothing else; each kernel's and the outer pass's device time
   from CUDA events around its call.
54. card vs CPU on the card's grid (32 columns over 50 points, 104 over
   25): the loss within the larger of 1e-5 and ten times its nudge spread,
   each gradient within the larger of 1e-3 (deterministic) or 3e-2
   (stochastic) and ten times the card's own spread under a 1e-7 nudge, a
   limit of at most 0.25.
55. times: each kernel's bound and ns per serial step, the plain versions
   on a middle window, the three steps' profiles over 100 points.
56. the three command lines (--engine fused-split2 at 16,8,8; with
   --stochastic --adaptive there; and at 64,32,8 with --max-steps 16384).
The Hopf MLP in outer mode (run after phase 56; batch 32, 1000 grid points
over 25 s, max_steps 1024, the seed-5 batch of phase 20): the emit-mode
sweep B8ho with the parameter gradients outside it
(``hopf_outer_arg_grads``), at the reference width with arg_grads="outer"
and at the 3-512-512-512-2 MLP (init std 0.1 sqrt(100/512)), whose 2.1 MB
of parameters send "auto" there, through B6h-wide, B7h-wide and B8ho-wide:
57. B8ho against its plain version over phase 20's whole grid, bit for bit
   in ybar0 and every ybar_steps row; its ybar0 against B8h's.
58. at width 512: the whole selection against its plain loop (bit for bit
   up to where the grids part, the counts within 1%, as phase 20), 8
   attempts along the replay, the replay and the emit-mode sweep over the
   whole grid, bit for bit.
59. main paths, launches counted, no plain version reached: the
   reference-width outer step (one launch each of B6h, B7h and B8ho), its
   gradients against the kernel-mode step on the same frozen grid within
   the larger of 1e-5 and ten times the card's own spread under a 1e-7
   nudge; the wide make_train_step at full depth (one launch each of the
   three wide kernels); the wide step over 10 points (0.25 s) again on the
   CPU on the card's grid: the loss within 1e-5, each gradient within the
   larger of 1e-5 and ten times the card's nudge spread.
60. times: each new kernel and both outer passes from CUDA events around
   their calls in the main-path steps, bounds and ns per serial step, the
   plain versions' times, both steps' profiles and idle shares over 100
   points.
The SDE selection as cluster teams (csrc/sde_select_team.cu; the other
phases hold it where their paths run it):
61. kernel vs plain, bit for bit: the whole selection over 12 grid points
   at 13 and 32 columns (4 lanes) and at 104 columns with 8 lanes
   (clusters of 8), for select16 on both trees and f32 on the jax.random
   tree; 16 attempts a width (13, 32, 104) from extreme states (v - a over
   the rates' whole range) for those and the three-term split, on the
   shape's route and the streamed ring, against the plain body as the
   single-attempt card test holds them (the decision, steps and W(t + h)
   equal; err, h_next and the new state within 1e-5, 1e-6, 1e-5), each
   value's differing elements from the plain body and from the one-block
   kernel counted (three float64 orders of the products).
62. times: every route (the team's, the ring forced, the one-block kernel)
   on a 25-point window at 3, 13, 32 and 104 columns (4 lanes, and 8 at
   104), the team's routes bit for bit with each other, the one-block
   kernel's grid held beside them (where it parts, if it does); µs per
   attempt, the plan, and the card's cluster capacity at 104 columns.
Then every path's command lines at once (each in its own process; they
are latency-bound and share the card; each run's selection counts per
step are recorded beside its last line), the kernels line (every kernel of
the fourteen paths; the selection's and the replays' entries name the
team's source and carry its routes' times), the card's name and power limit, and the result
line.

It needs a CUDA device and the repository beside it; without either it
fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T = 1500            # grid points: 1499 SRA1 steps (0.15 s of model time)
BATCH = 16          # samples per batch, one held out -> 15 rollout lanes
NOISE_REPS = 4      # the README's full-training recipe -> 60 lanes
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
N_POPS, N_STATE = 16, 48
SOURCE = "columnflow_torch/kernels/csrc/column_step.cu"
# The 104-column flagship (bench.py:321-333): columns (64, 32, 8), 4 inputs,
# batch 4, 1000 grid points over 1 s, max_steps 16384, rtol = atol = 1e-3.
PARITY_CPA = (64, 32, 8)
PARITY_T = 1000
PARITY_B = 4
PARITY_MAX_STEPS = 16384
SHORT_T = 100       # grid points of the CPU step check and the plain versions' times
# Full-width train steps of the flagship, split2 and bench main paths (6-7 s
# for the flagship and bench, ~18 s for split2 on the H100): one, to keep the
# whole script well under its time limit.
FULL_STEPS = 1
GRAD_T = 5          # grid points (5 ms) of the CPU step check holding every gradient
OUT_T = 50          # grid points of the 104-column CPU step check holding the output weights
# The flagship's output-weight check over 12 points (over 50 its two CPU
# steps took ~40 s, over 25 ~16 s; cut in depth to keep the script under its
# time limit).
FLAGSHIP_OUT_T = 12
# The flagship's whole selection against its plain loop, and its kernels and
# plain versions timed on a short horizon, over 12 points (over SHORT_T the
# plain versions took ~30 s, over 25 ~9 s; cut in depth to keep the script
# under its limit).
FLAGSHIP_SEL_T = 12
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate
SDE_SOURCE = "columnflow_torch/kernels/csrc/network_sde.cu"
TEAM2_SOURCE = "columnflow_torch/kernels/csrc/replay2_team.cuh"  # B3, B4: cluster teams
# B3t-team, B4t: cluster teams per lane on ode_team.cuh
SDE3_TEAM_SOURCE = "columnflow_torch/kernels/csrc/sde3_replay_team.cu"
# Every window on which B3 and B4 are held against their plain versions, by
# width: (max abs error, bit for bit, differing elements); the kernels line
# reports the largest error over all of them.
REPLAY2_CHECKS = {"sde_replay_fwd": {}, "sde_replay_bwd": {}}


def record_replay2(name, columns, got, want):
    """Record one B3 (``sde_replay_fwd``) or B4 (``sde_replay_bwd``) window
    against its plain version at ``columns`` columns; returns its entry."""
    import torch

    if torch.is_tensor(got):
        got, want = (got,), (want,)
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    entry = REPLAY2_CHECKS[name].setdefault(columns, {"max_abs_err": 0.0, "bit_for_bit": True,
                                                     "differing": 0, "windows": 0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["bit_for_bit"] = entry["bit_for_bit"] and differ == 0
    entry["differing"] += differ
    entry["windows"] += 1
    return {"max_abs_err": err, "differing": differ}
# The flagship's step settings; its solver flags (--stochastic --adaptive
# --fused --fused-pass --select-bf16 --grad-bf16 --split2) select the port's
# stochastic step.
FLAGSHIP = dict(stochastic=True, adaptive=True, fused_pass=True, select_bf16=True,
                grad_bf16=True, split2=True, bptt_every=32, clip_grad_norm=1.0, loss_scale=1e-6)
# The deterministic parity step (columnflow/tasks/parity.py defaults): the
# reference's own network, nothing cut.
ODE_CPA = (8, 4, 1)
ODE_T = 1000
ODE_B = 4
ODE_MAX_STEPS = 3072
ODE_WINDOW = 64     # steps of a kernel-vs-plain replay window
ODE_SOURCE = "columnflow_torch/kernels/csrc/network_ode.cu"
# B6, B7t-team, B7 split2, B8', B8't and the kernel-mode sweep (B8, B8t-team)
# as cluster teams (csrc/ode_team.cuh) have sources of their own.
ODE_KSWEEP_SOURCE = "columnflow_torch/kernels/csrc/ode_ksweep_team.cu"
ODE_TEAM_SOURCES = {"ode_select": "columnflow_torch/kernels/csrc/ode_select_team.cu",
                    "ode_replay_bwd": ODE_KSWEEP_SOURCE, "ode_replay_bwd_team": ODE_KSWEEP_SOURCE,
                    "ode_replay_fwd_team": "columnflow_torch/kernels/csrc/ode_replay_team.cu",
                    "ode_replay_fwd_split2": "columnflow_torch/kernels/csrc/ode_replay_team.cu",
                    "ode_replay_bwd_emit": "columnflow_torch/kernels/csrc/ode_emit_team.cu",
                    "ode_replay_bwd_emit_split3":
                        "columnflow_torch/kernels/csrc/ode_emit_team.cu"}
ROUTE_W = 256       # accepted steps of the window on which the replays' routes are timed
ODE_LOSS_TOL = 1e-5
ODE_GRAD_TOL = 1e-3  # rel L2 of each gradient, card against CPU
# The 104-column deterministic tier (columnflow/tasks/parity.py resolve_engine:
# fused-split2 from 104 through 312 columns): the flagship's network, batch 4
# under one controller, 1000 grid points over 1 s, dopri5 at rtol 1e-7 / atol
# 1e-9, selection on the three-term split, values and gradients on the
# two-term one, the weight gradients outside the kernels. max_steps 16384:
# the command line's default of 3072 accepted steps reaches t = 0.42 s of
# the 1 s at this width (--max-steps raises it, as here).
S2_CPA = (64, 32, 8)
S2_T = 1000
S2_B = 4
S2_MAX_STEPS = 16384
S2_GRAD_T = 5       # grid points (5 ms) of the card-vs-CPU step
S2_SEL_T = 12       # grid points of the whole selection held against its plain loop (over
                    # 100 the plain loop took 12 s, over 25 11 s on a slow host; cut in
                    # depth for the time limit)
S2_PROFILE_T = 100  # grid points of the profiled step
S2_PLAIN_W = 16     # steps of the window on which the plain replay and sweep are timed


_START = time.perf_counter()


def emit(phase, **fields):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - _START, 1),
                      **fields}), flush=True)


def scaled_err(got, want):
    """Largest |got - want| over each state component's largest |want|."""
    scale = want.abs().flatten(0, -2).amax(dim=0).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# The command lines of every path: ``defer_command_line`` records them and
# ``run_command_lines`` runs them all at once at the end, after every timed
# phase, each in its own process on the card.
COMMAND_LINES = []


def defer_command_line(phase, task, argv, timeout=600, finite=False, reach=False):
    """``python -m columnflow_torch.tasks.<task>`` with argv, to be run by
    ``run_command_lines`` and reported under ``phase``; it must exit 0 with
    its "final loss" line (with ``finite``, every number there finite; with
    ``reach``, every step's selection reached the last grid point: its
    "step" lines all say success True, for every lane where there are
    lanes)."""
    COMMAND_LINES.append((phase, task, list(argv), timeout, finite, reach))


def run_command_lines(meanwhile=None):
    """Start every deferred command line at once (they are latency-bound:
    each uses a few of the card's SMs), call ``meanwhile()`` if given, and
    wait for all; one JSON line per phase with each run's last line and wall
    seconds. A failure stops every process still running and raises."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    threads = max(1, (os.cpu_count() or 8) // max(1, len(COMMAND_LINES)))
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    runs = []
    try:
        for phase, task, argv, timeout, finite, reach in COMMAND_LINES:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            proc = subprocess.Popen([sys.executable, "-m", f"columnflow_torch.tasks.{task}", *argv],
                                    stdout=out, stderr=err, text=True, cwd=root, env=env)
            runs.append(dict(phase=phase, task=task, argv=argv, timeout=timeout, finite=finite,
                             reach=reach, out=out, err=err, proc=proc, t0=time.perf_counter(),
                             seconds=None))
        if meanwhile is not None:
            meanwhile()
        while any(r["seconds"] is None for r in runs):
            for r in runs:
                if r["seconds"] is not None:
                    continue
                secs = time.perf_counter() - r["t0"]
                if r["proc"].poll() is not None:
                    r["seconds"] = secs
                elif secs > r["timeout"]:
                    raise AssertionError(f"{r['task']} {' '.join(r['argv'])}: over {r['timeout']} s")
            time.sleep(0.2)
        by_phase = {}
        for r in runs:
            r["out"].seek(0)
            r["err"].seek(0)
            stdout, stderr = r["out"].read(), r["err"].read()
            last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
            ok = r["proc"].returncode == 0 and last.startswith("final loss")
            if ok and r["finite"]:
                nums = [float(x) for x in last.replace("|", " ").split() if x[:1].isdigit()
                        or x[:1] == "-" or x in ("nan", "inf")]
                ok = all(x == x and abs(x) != float("inf") for x in nums)
            steps = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
            if ok and r["reach"]:  # "success True", or per lane "success [True, ...]"
                ok = bool(steps) and all("True" in ln.split("success")[-1]
                                         and "False" not in ln.split("success")[-1]
                                         for ln in steps)
            check(ok, f"{r['task']} {' '.join(r['argv'])}: rc {r['proc'].returncode}\n"
                      f"{stdout[-2000:]}\n{stderr[-4000:]}")
            by_phase.setdefault(r["phase"], []).append(
                {"argv": " ".join(r["argv"]), "seconds": r["seconds"], "result": last,
                 "selection": steps})
        for phase, lines in by_phase.items():
            emit(phase, concurrent_runs=len(runs), runs=lines)
    finally:
        for r in runs:
            if r["proc"].poll() is None:
                r["proc"].kill()
                r["proc"].wait()


# The CPU halves of the card-vs-CPU checks run in CPU_SLOTS worker processes
# (``cpu_later``) while this process goes on driving the card; their
# comparisons run here at the end (``finish_cpu_checks``). The workers are
# spawned, not forked: autograd cannot run in a child forked after its
# parent ran a backward pass.
CPU_SLOTS = 2
CPU_THREADS = max(1, (os.cpu_count() or 8) // 4)
CPU_TIMEOUT = 900   # seconds the last check may still take at the end
CPU_POOL = []
CPU_JOBS = []


def _cpu_worker_init(threads):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # a worker never touches the card
    os.nice(10)  # the host-timed steps beside it come first
    import torch

    torch.set_num_threads(threads)


def start_cpu_workers():
    import multiprocessing

    CPU_POOL.append(multiprocessing.get_context("spawn").Pool(
        CPU_SLOTS, initializer=_cpu_worker_init, initargs=(CPU_THREADS,)))


def host(x):
    """``x`` with every tensor in it (through tuples, lists and dicts) on the CPU."""
    import torch

    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, (tuple, list)):
        return type(x)(host(v) for v in x)
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    return x


def cpu_step(kind, cfg, build, flags, args, kwargs, params_list, outer_arg_bytes=None):
    """The CPU half of a card-vs-CPU check, in a worker process: for each
    parameter set of ``params_list``, the task of ``kind`` built on the CPU
    from seed 0 with ``build``, those parameters copied in, and one train
    step of ``flags`` on ``args`` and ``kwargs`` (the plain versions run:
    every tensor is on the CPU); [(loss, gradients, seconds)], the Hopf
    MLP's gradients named "<layer>.<w or b>"."""
    import torch

    from columnflow_torch.models.hopf import build_hopf_mlp
    from columnflow_torch.solvers import fused
    from columnflow_torch.tasks import bifurcation as bt
    from columnflow_torch.tasks import parity, wta
    from columnflow_torch.tasks import xor as xt
    from columnflow_torch.tasks.wta import linspace
    from columnflow_torch.train.optim import torch_rmsprop

    saved = fused.OUTER_ARG_BYTES
    if outer_arg_bytes is not None:
        fused.OUTER_ARG_BYTES = outer_arg_bytes
    out = []
    try:
        for params in params_list:
            gen = torch.Generator().manual_seed(0)
            if kind == "hopf_wide":
                layers = build_hopf_mlp(gen, sizes=build["sizes"], init_std=build["init_std"],
                                        device="cpu")
                for layer in layers:
                    for v in layer.values():
                        v.requires_grad_(True)
                ts = linspace(0.0, build["span"], build["T"], device="cpu")
                opt, _ = torch_rmsprop([v for layer in layers for v in layer.values()],
                                       lr=1e-3, alpha=0.99)
                t = bt.HopfTask(layers, ts, float((ts[1] - ts[0]).item()), opt,
                                build["max_steps"])
            elif kind == "hopf":
                t = bt.build_task(gen, device="cpu", **build)
            else:
                t = {"parity": parity, "xor": xt, "wta": wta}[kind].build_task(
                    cfg, gen, device="cpu", **build)
            with torch.no_grad():
                if kind.startswith("hopf"):
                    for layer, src in zip(t.params, params):
                        for k, p in layer.items():
                            p.copy_(src[k])
                else:
                    for k, p in t.params.items():
                        p.copy_(params[k])
            mod = {"parity": parity, "xor": xt, "wta": wta}.get(kind, bt)
            t0 = time.perf_counter()
            rec = mod.make_train_step(t, **flags)(*args, **kwargs)
            seconds = time.perf_counter() - t0
            if kind.startswith("hopf"):
                grads = {f"{i}.{k}": p.grad.detach().clone() for i, layer in enumerate(t.params)
                         for k, p in layer.items()}
            else:
                grads = {k: p.grad.detach().clone() for k, p in t.params.items()}
            out.append((float(rec[0] if isinstance(rec, tuple) else rec["loss"]), grads, seconds))
    finally:
        fused.OUTER_ARG_BYTES = saved
    return out


def cpu_later(phase, key, compare, kind, cfg, build, flags, args=(), kwargs=None,
              params_list=(), outer_arg_bytes=None):
    """Queue the CPU half of one card-vs-CPU check (``cpu_step``, its inputs
    taken to the CPU here) on the workers; at the end ``compare`` gets its
    [(loss, gradients, seconds)], raises where the check fails and returns
    the check's JSON entry."""
    job = (kind, cfg, build, flags, host(tuple(args)), host(kwargs or {}),
           host(list(params_list)), outer_arg_bytes)
    CPU_JOBS.append(dict(phase=phase, key=key, compare=compare,
                         result=CPU_POOL[0].apply_async(cpu_step, job)))


def finish_cpu_checks():
    """Wait for every queued CPU half and run its comparison; one JSON line
    per phase with each check's entry (``cpu_seconds``: the CPU step in its
    worker, on CPU_THREADS threads)."""
    by_phase = {}
    deadline = time.perf_counter() + CPU_TIMEOUT
    for job in CPU_JOBS:
        res = job["result"].get(timeout=max(1.0, deadline - time.perf_counter()))
        entry = job["compare"](res)
        by_phase.setdefault(job["phase"], {})[job["key"]] = {
            **entry, "cpu_seconds": [r[2] for r in res]}
    for phase, entries in by_phase.items():
        emit(phase, cpu_threads=CPU_THREADS, cpu_check=entries)


def stop_cpu_workers():
    for pool in CPU_POOL:
        pool.terminate()
        pool.join()


def event_timed(module, names, log):
    """Replace ``module.<name>`` for each name by a wrapper that records a
    CUDA event pair around every call into ``log`` (name, start, end), so a
    train step yields each kernel's device time without a second run;
    returns the function that puts the originals back."""
    import torch

    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed_call(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            log.append((name, start, end))
            return out
        return timed_call

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def cuda_ms(fn, reps, warmup=1, device_time=False):
    """Mean ms per call of ``fn`` between two CUDA events. With
    ``device_time`` the stream first sleeps for longer than the host takes
    to enqueue the calls, so the launches run back to back and the events
    measure the device's time rather than the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if device_time:
        torch.cuda._sleep(int(2e6) * reps)  # ~1 ms of cycles per call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def team_routes(run, serial, plan_route):
    """B6, B7t-team, B7 split2, B8' and B8't as cluster teams
    (csrc/ode_team.cuh) against the 8-block team they replaced ("team8", the
    yardstick) on the same call: CUDA-event ms of ``run(route)`` on the
    shape's own route (and on "streamed" where the slice is resident), on
    team8, and us per serial step (attempt or accepted step)."""
    routes = [plan_route] + (["streamed"] if plan_route == "resident" else []) + ["team8"]
    out = {"weights": plan_route}
    for route in routes:
        ms = cuda_ms(lambda: run(route), reps=1, warmup=1)
        out[route] = {"ms": ms, "us_per_serial_step": ms * 1e3 / max(serial, 1)}
    out["team8_over_team"] = out["team8"]["ms"] / out[plan_route]["ms"]
    return out


def sweep_routes(run, serial, route, yardstick):
    """The kernel-mode sweep's cluster team (csrc/ode_ksweep_team.cu) on the
    shape's route, on "streamed" where that is "resident", and the kernel it
    replaced on the shape (``yardstick``: "block", B8's one block, or
    "team8", B8t-team) on the same call: CUDA-event ms of ``run(route)`` and
    us per accepted step; every route's ybar0, d wT and d iwT must equal the
    team's on its own route bit for bit (the elements that part are
    counted)."""
    import torch

    ref = run(route)
    out = {"weights": route, "yardstick": yardstick}
    for r in [route] + (["streamed"] if route == "resident" else []) + [yardstick]:
        got = run(r)
        parted = [int((g != w).sum()) for g, w in zip(got, ref)]
        check(not any(parted), f"sweep route {r} parts from {route}: {parted} elements")
        ms = cuda_ms(lambda: run(r), reps=1, warmup=0)
        out[r] = {"ms": ms, "us_per_serial_step": ms * 1e3 / max(serial, 1),
                  "elements_parted": parted}
    out[f"{yardstick}_over_team"] = out[yardstick]["ms"] / out[route]["ms"]
    torch.cuda.synchronize()
    return out


def ptxas_of(fragment):
    """Registers and spills of each compiled instance of the kernel
    template ``fragment``, from the build's ``-Xptxas -v`` report:
    {"<template arguments>": {"registers", "spill_store_bytes",
    "spill_load_bytes"}}."""
    import re

    from columnflow_torch.kernels import _build

    out, inst = {}, None
    for ln in _build.build_log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(re.escape(fragment) + r"I((?:L[a-z]+\d+E)+)E", ln)
            inst = None
            if m:
                args = re.findall(r"L([a-z]+)(\d+)E", m.group(1))
                inst = "<" + ", ".join(("true" if v == "1" else "false") if t == "b" else v
                                       for t, v in args) + ">"
                out[inst] = {}
        elif inst is not None and "spill stores" in ln:
            nums = [int(t) for t in re.findall(r"(\d+) bytes", ln)]
            out[inst].update(spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif inst is not None and "Used" in ln and "registers" in ln:
            out[inst]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            inst = None
    return out


def device_profile(run, n):
    """Device time by kernel (ms per call) of ``run(i)`` for i < n under
    torch.profiler, and the profiled wall time per call. One call before
    them is traced and dropped (the profiler's warm-up): the card's first
    ~0.1 s under a newly started profiler can go unrecorded, which took the
    first step's earlier kernels out of the sums. Only the card's activity is
    traced: the host's operators are not read here."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    traced = []  # the key averages of the n active calls, taken when their cycle ends
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        run(0)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
            torch.cuda.synchronize()
            prof.step()
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_kernel = {}
    for ev in (traced[0] if traced else []):
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if (dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            key = ev.key[:80]
            by_kernel[key] = by_kernel.get(key, 0.0) + dev_us / 1e3 / n
    return wall, by_kernel


def short_profile(step, args):
    """(step_ms, profiled_wall_ms, device ms by kernel) of one step over a
    short horizon: a warm-up, one timed step, one profiled step. The
    full-width steps of the flagship and of the split2 tier take 15-18 s on
    the H100, and the profiler's own cost on one of them up to 137 s there; a
    100-point horizon keeps every kernel and launch of the step, ten times
    fewer of each."""
    import torch

    step(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    wall, by_kernel = device_profile(lambda i: step(*args), 1)
    return step_ms, wall, by_kernel


def rel_l2_rows(got, want):
    """Largest relative L2 error of a row (one step, every lane)."""
    diff = (got - want).flatten(1).norm(dim=1)
    return float((diff / want.flatten(1).norm(dim=1).clamp_min(1e-30)).max())


# Work and traffic of each kernel, from its shapes (see PERF.md). FLOPs follow
# bench.py's WTA accounting: one drift evaluation = 2 n^2 + 35 n per lane, an
# SRA1 step = 2 drifts + 12 S; a VJP of the drift = 4 n^2 + 35 n (transposed
# product and w_bar outer product); a reverse step = recomputed drift
# + 2 VJPs + 12 S.
DRIFT_FLOPS = 2 * N_POPS * N_POPS + 35 * N_POPS
VJP_FLOPS = 4 * N_POPS * N_POPS + 35 * N_POPS
FWD_STEP_FLOPS = 2 * DRIFT_FLOPS + 12 * N_STATE
BWD_STEP_FLOPS = DRIFT_FLOPS + 2 * VJP_FLOPS + 12 * N_STATE
PARAM_BYTES = 4 * (N_POPS * N_POPS + 3 * N_POPS + N_STATE)


def bound(kernel, B, steps):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FLOPs over the float32 peak; each input read once, each output written
    once."""
    if kernel == "wta_drift":
        nbytes = PARAM_BYTES + 4 * B * (N_STATE + N_POPS + N_STATE)
        flops = B * DRIFT_FLOPS
    elif kernel == "wta_rollout_fwd":
        nbytes = PARAM_BYTES + 4 * B * (N_STATE + (steps + 1) * N_POPS + 2 * steps
                                        + (steps + 1) * N_STATE)
        flops = B * steps * FWD_STEP_FLOPS
    elif kernel == "wta_rollout_bwd":
        # stim rows 0..K-1 (row K is not read), i10, ys, ysbar, cin in;
        # cout and the (B, 16, 16) partials out.
        nbytes = PARAM_BYTES + 4 * B * (steps * N_POPS + steps + 2 * steps * N_STATE
                                        + 2 * N_STATE + N_POPS * N_POPS)
        flops = B * steps * BWD_STEP_FLOPS
    else:  # wta_wbar_reduce
        nbytes = 4 * (B + 1) * N_POPS * N_POPS
        flops = B * N_POPS * N_POPS
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def wta_phases(dev, cfg):
    """Phases 2-4 for the WTA step; returns its kernels' entries of the
    kernels line."""
    import torch

    from columnflow_torch.data import make_wta_dataset, sample_wta_mus, wta_stim_three_phases
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import column_step as cs
    from columnflow_torch.ops.losses import huber_trajectory_loss_wta
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import wta

    ts = wta.linspace(0.0, T * wta.DT, T, device=dev)
    h = cs._grid_step(ts)

    def inputs(B, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params, area = wta.build_wta(cfg, gen, device=dev)
        consts, scalars = cs._area_consts(area)
        stim_tb = wta_stim_three_phases(sample_wta_mus(gen, B, device=dev), T)
        stim_tb = stim_tb.transpose(0, 1).contiguous()
        _, i1, i10, _, _ = brownian_pack(gen, ts, (B,))
        g = cs._diffusion_row(100.0, False, dev)
        y0 = torch.zeros(B, N_STATE, device=dev)
        fwd = (h, scalars, params["recurrent_weights"], consts, g, y0, stim_tb, i1, i10)
        ys = cs._rollout_fwd_plain(*fwd)
        ys_req = ys.transpose(0, 1).requires_grad_(True)
        true = torch.rand(B, T, 2, device=dev, generator=gen)
        loss = huber_trajectory_loss_wta(ys_req, true, params["output_weights"])
        ysbar = torch.autograd.grad(loss, ys_req)[0].transpose(0, 1).contiguous()
        bwd = (h, scalars, params["recurrent_weights"], consts, g, stim_tb, i10,
               ys[:-1].contiguous(), ysbar[:-1].contiguous(), ysbar[-1].contiguous())
        y = ys[T // 2].clone()
        y[0, 4], y[0, 20] = 20.4375, 0.0  # lane 0, population 4 at the singularity
        drift = (scalars, y, stim_tb[T // 2].contiguous(), params["recurrent_weights"], consts)
        return dict(fwd=fwd, bwd=bwd, drift=drift, ys=ys)

    # -- 2. kernel vs plain on the card ---------------------------------------
    widths = (BATCH - 1, (BATCH - 1) * NOISE_REPS)
    data = {B: inputs(B, seed=B) for B in widths}
    errs = {}
    for B, d in data.items():
        got = cs.drift(*d["drift"])
        want = cs._drift_plain(*d["drift"])
        torch.cuda.synchronize()
        e_drift = float(((got - want).abs()
                         / cs._drift_abs_terms(*d["drift"]).clamp_min(1e-30)).max())
        check(torch.isfinite(got).all() and e_drift < 1e-6, f"wta_drift B={B}: {e_drift}")
        ys = cs.rollout_fwd(*d["fwd"])
        torch.cuda.synchronize()
        e_fwd = scaled_err(ys, d["ys"])
        check(torch.isfinite(ys).all() and e_fwd < 1e-4, f"wta_rollout_fwd B={B}: {e_fwd}")
        cout, wbar = cs.rollout_bwd(*d["bwd"])
        cout_p, wbar_p = cs._rollout_bwd_plain(*d["bwd"])
        torch.cuda.synchronize()
        e_cout = scaled_err(cout, cout_p)
        e_wbar = float((wbar - wbar_p).norm() / wbar_p.norm())
        check(torch.isfinite(cout).all() and torch.isfinite(wbar).all()
              and e_cout < 1e-4 and e_wbar < 1e-4,
              f"wta_rollout_bwd B={B}: cout {e_cout}, wbar {e_wbar}")
        errs[B] = {
            "wta_drift": float((got - want).abs().max()),
            "wta_rollout_fwd": float((ys - d["ys"]).abs().max()),
            "wta_rollout_bwd": float((cout - cout_p).abs().max()),
            "wta_wbar_reduce": float((wbar - wbar_p).abs().max()),
        }
        emit("kernel_vs_plain", lanes=B, T=T,
             drift_scaled_err=e_drift, drift_tol=1e-6,
             fwd_scaled_err=e_fwd, fwd_tol=1e-4,
             bwd_cout_scaled_err=e_cout, bwd_wbar_rel_l2=e_wbar, bwd_tol=1e-4,
             max_abs_err=errs[B])
    check(all(v > 0 for v in cs.LAUNCHES.values()), f"launch counters: {cs.LAUNCHES}")

    # -- 3. the main path at full width ---------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    states, stims = make_wta_dataset(gen, 64, T, device=dev)
    states = states / 20.0
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    check(tuple(states.shape) == (64, T, 2) and bool(torch.isfinite(states).all()),
          "dataset")
    task = wta.build_task(cfg, gen, lr=0.01, time_steps=T, device=dev)
    step = wta.make_train_step(task)
    mask = task.grad_mask["recurrent_weights"].bool()

    def batch(reps):
        idx = torch.randperm(64, generator=gen, device=dev)[:BATCH]
        bs, bst = states[idx[:-1]], stims[idx[:-1]]
        return bs.repeat(reps, 1, 1), bst.repeat(reps, 1)

    # The first step's inputs and parameters, kept to repeat the step on the
    # CPU with the plain versions.
    bs0, bst0 = batch(1)
    _, i1_0, i10_0, _, _ = brownian_pack(gen, ts, (BATCH - 1,))
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}

    for k in cs.LAUNCHES:
        cs.LAUNCHES[k] = 0
    history = []
    for i in range(6):
        if i == 0:
            loss, gnorm = step(bs0, bst0, noise=(i1_0, i10_0))
            grad0 = task.params["recurrent_weights"].grad.detach().cpu().clone()
        else:
            loss, gnorm = step(*batch(1 if i < 5 else NOISE_REPS), generator=gen)
        grad = task.params["recurrent_weights"].grad
        check(bool(torch.isfinite(loss)), f"step {i}: loss {loss}")
        check(bool((grad[~mask] == 0).all()) and bool((grad[mask] != 0).any()),
              f"step {i}: gradient off the mask")
        history.append({"loss": float(loss), "grad_norm": float(gnorm)})
    torch.cuda.synchronize()
    main_launches = dict(cs.LAUNCHES)
    check(main_launches["rollout_fwd"] == 6 and main_launches["rollout_bwd"] == 6
          and main_launches["wbar_reduce"] == 6,
          f"main path launches {main_launches}, expected 6 forward and 6 backward")

    # The first step again on the CPU, plain versions, same inputs.
    def compare(res, loss0=history[0]["loss"], grad0=grad0):
        loss_cpu, grads_cpu, _ = res[0]
        grad_cpu = grads_cpu["recurrent_weights"]
        loss_rel = abs(loss0 - loss_cpu) / abs(loss_cpu)
        grad_rel = float((grad0 - grad_cpu).norm() / grad_cpu.norm())
        check(loss_rel < 1e-4 and grad_rel < 1e-3,
              f"card vs CPU step: loss rel {loss_rel}, grad rel L2 {grad_rel}")
        return {"loss_rel": loss_rel, "grad_rel_l2": grad_rel, "tol": {"loss": 1e-4, "grad": 1e-3}}

    cpu_later("wta_cpu_check", "first_step", compare, "wta", cfg,
              dict(lr=0.01, time_steps=T), dict(use_fused=True),
              args=(bs0, bst0), kwargs=dict(noise=(i1_0, i10_0)), params_list=[params0])
    emit("main_path", lanes=[BATCH - 1] * 5 + [(BATCH - 1) * NOISE_REPS], T=T,
         dataset_seconds=round(t_data, 3), history=history, launches=main_launches,
         cpu_check="wta_cpu_check")

    # Evaluation path: held-out rollout with the trained weights, and the
    # drift at its end state through the public fused_drift.
    for k in cs.LAUNCHES:
        cs.LAUNCHES[k] = 0
    held = stims[-(BATCH - 1):]
    tables = wta_stim_three_phases(held, T)
    _, i1, i10, _, _ = brownian_pack(gen, ts, (BATCH - 1,))
    with torch.no_grad():
        ys = cs.wta_rollout_fused(task.params, task.area, tables, ts, i1, i10)
        f_end = cs.fused_drift(ys[:, -1].contiguous(), tables[:, -1].contiguous(),
                               task.params, task.area)
    torch.cuda.synchronize()
    eval_launches = dict(cs.LAUNCHES)
    check(tuple(ys.shape) == (BATCH - 1, T, N_STATE) and bool(torch.isfinite(ys).all())
          and bool(torch.isfinite(f_end).all()), "evaluation path")
    check(eval_launches["rollout_fwd"] == 1 and eval_launches["drift"] == 1,
          f"evaluation launches {eval_launches}")
    emit("eval_path", lanes=BATCH - 1, launches=eval_launches,
         end_drift_abs_max=float(f_end.abs().max()))

    # -- 4. times -------------------------------------------------------------
    kernels = {
        "wta_drift": (lambda d: cs.drift(*d["drift"]), lambda d: cs._drift_plain(*d["drift"])),
        "wta_rollout_fwd": (lambda d: cs.rollout_fwd(*d["fwd"]),
                            lambda d: cs._rollout_fwd_plain(*d["fwd"])),
        "wta_rollout_bwd": (lambda d: cs.rollout_bwd(*d["bwd"]),
                            lambda d: cs._rollout_bwd_plain(*d["bwd"])),
    }
    lib, stream = _build.library(), torch.cuda.current_stream().cuda_stream
    times = {}
    for B, d in data.items():
        for kname, (kern, plain) in kernels.items():
            times[(kname, B)] = [cuda_ms(lambda: kern(d), reps=20, warmup=3, device_time=True),
                                 cuda_ms(lambda: plain(d), reps=1, warmup=0), None]
        # The reverse sweep alone (the wrapper also launches the reduction),
        # and the reduction alone on this width's partials.
        hh, sc, w, consts, g, stim_tb, i10, ys_k, ysbar_k, cin = d["bwd"]
        cout = torch.empty(B, N_STATE, device=dev)
        wpart = torch.empty(B, N_POPS, N_POPS, device=dev)
        wbar = torch.empty(N_POPS, N_POPS, device=dev)

        def sweep_kernel():
            cs._check(lib.cf_wta_rollout_bwd(
                T - 1, B, hh, *sc, w.data_ptr(), consts.data_ptr(), g.data_ptr(),
                stim_tb.data_ptr(), i10.data_ptr(), ys_k.data_ptr(), ysbar_k.data_ptr(),
                cin.data_ptr(), cout.data_ptr(), wpart.data_ptr(), stream),
                "wta_rollout_bwd")

        def reduce_kernel():
            cs._check(lib.cf_wta_wbar_reduce(B, wpart.data_ptr(), wbar.data_ptr(), stream),
                      "wta_wbar_reduce")

        def reduce_plain():  # the kernel's arithmetic: lanes summed in order
            acc = torch.zeros(N_POPS, N_POPS, device=dev)
            for b in range(B):
                acc = acc + wpart[b]
            return acc

        times[("wta_rollout_bwd", B)][0] = cuda_ms(sweep_kernel, reps=20, warmup=3,
                                                   device_time=True)
        times[("wta_wbar_reduce", B)] = [
            cuda_ms(reduce_kernel, reps=100, warmup=3, device_time=True),
            cuda_ms(reduce_plain, reps=100, warmup=3),
            cuda_ms(lambda: wpart.sum(0), reps=100, warmup=3, device_time=True)]
    for B, d in data.items():
        emit("kernel_times", lanes=B, ms={k: v[0] for (k, b), v in times.items() if b == B},
             plain_ms={k: v[1] for (k, b), v in times.items() if b == B},
             library_ms={k: v[2] for (k, b), v in times.items() if b == B},
             ns_per_serial_step={k: v[0] * 1e6 / (T - 1)
                                 for (k, b), v in times.items()
                                 if b == B and k.startswith("wta_rollout")})

    step_ms = {}
    for reps in (1, NOISE_REPS):
        batches = [batch(reps) for _ in range(10)]
        step(*batches[0], generator=gen)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bs, bst in batches:
            step(bs, bst, generator=gen)
        torch.cuda.synchronize()
        step_ms[(BATCH - 1) * reps] = (time.perf_counter() - t0) * 1e3 / len(batches)
    emit("train_step", ms_per_step={str(k): v for k, v in step_ms.items()},
         iters_per_s={str(k): 1e3 / v for k, v in step_ms.items()})

    # Where a 15-lane step's time goes: device time by kernel over 5 steps.
    # The idle share is held against the step time measured above without
    # the profiler, whose own cost lengthens the profiled wall time.
    batches = [batch(1) for _ in range(5)]
    wall, by_kernel = device_profile(lambda i: step(*batches[i], generator=gen), len(batches))
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    emit("step_profile", lanes=BATCH - 1, profiled_wall_ms_per_step=wall,
         step_ms=step_ms[BATCH - 1],
         device_busy_ms_per_step=busy if busy else "not measured",
         idle_share=1.0 - busy / step_ms[BATCH - 1] if busy else "not measured",
         device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    replaces = {
        "wta_rollout_fwd": "columnflow/kernels/column_step.py:102",
        "wta_rollout_bwd": "columnflow/kernels/column_step.py:315",
        "wta_wbar_reduce": "columnflow/kernels/column_step.py:315",
        "wta_drift": "columnflow/kernels/column_step.py:59",
    }
    counts = {"wta_rollout_fwd": main_launches["rollout_fwd"],
              "wta_rollout_bwd": main_launches["rollout_bwd"],
              "wta_wbar_reduce": main_launches["wbar_reduce"],
              "wta_drift": eval_launches["drift"]}
    B15, B60 = widths
    line = []
    for kname in ("wta_rollout_fwd", "wta_rollout_bwd", "wta_wbar_reduce", "wta_drift"):
        steps = T - 1
        b15, by = bound(kname, B15, steps)
        b60, _ = bound(kname, B60, steps)
        line.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces[kname],
            "launches": counts[kname], "max_abs_err": max(errs[B][kname] for B in widths),
            "ms": times[(kname, B15)][0], "plain_ms": times[(kname, B15)][1],
            "bound_ms": b15, "bound_by": by, "library_ms": times[(kname, B15)][2],
            "lanes": B15,
            "at_60_lanes": {"ms": times[(kname, B60)][0], "plain_ms": times[(kname, B60)][1],
                            "bound_ms": b60, "library_ms": times[(kname, B60)][2]},
        })
    return line


def sde_bound(kernel, P, B, n_in, K, work, n=0, M=0):
    """(bound_ms, bound_by) of a network SDE kernel. ``work`` is what this
    run's data needed: the controller attempts of all lanes (selection) or
    their real half steps (replay). Each (P,) x (P, P) product counts
    2 P^2 operations at the bf16 tensor rate (select16: 1 product per
    drift; split2: 3; a split2 VJP: 2), the elementwise float32 work at
    the float32 rate. Bytes: each input read once, each output written
    once. The replays read the grid, noise, states and cotangents of the
    real half steps only (padding rows are no-ops with zero cotangents)
    and write their outputs whole ((n + 1) rows of ys, n rows of seeds);
    the weights count once (the bf16 select16 copy, or the two split2
    halves)."""
    S = 3 * P
    prod = 2 * P * P
    drift_f32 = 30 * P + 8 * S           # rates, stimulus, currents, tail
    consts = 4 * (2 * P + K * B * n_in)  # bg, adapt, knot values
    if kernel == "sde_select":
        # 5 drifts, 3 SRA1 updates and the error norm per attempt; 2 tree
        # walks of 21 normals and 2 interval normals (~150 operations each)
        flops16 = work * 5 * prod
        flops32 = work * (5 * drift_f32 + 3 * 10 * S + 6 * S + 44 * 150)
        nbytes = (2 * P * P + 2 * n_in * P + consts + 4 * B * S + 16 * B
                  + 4 * B * (M + 1) + 12 * B)
    elif kernel == "sde_replay_fwd":
        flops16 = work * 2 * 3 * prod
        flops32 = work * (2 * drift_f32 + 10 * S)
        nbytes = (4 * P * P + 4 * n_in * P + consts + 4 * B * S + 16 * work
                  + 4 * (n + 1) * B * S)
    else:  # sde_replay_bwd: a recomputed drift and two VJPs per half step
        flops16 = work * 7 * prod
        flops32 = work * (drift_f32 + 2 * (20 * P + 10 * S) + 12 * S)
        nbytes = (4 * P * P + 4 * n_in * P + consts + 12 * work + 2 * 4 * work * S
                  + 4 * n * B * S + 4 * B * S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops16 / BF16_FLOPS + flops32 / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def parity_phases(dev, cfg):
    """Phases 5-7 for the parity step; returns its kernels' entries of the
    kernels line."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.models.network import premix_select16, prepare_premixed_split2
    from columnflow_torch.solvers import fused
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.solvers.fused import truncation_stride
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(1)

    def make_task(time_steps, device=dev, params=None, cpa=PARITY_CPA):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=4,
                                 time_steps=time_steps, max_steps=PARITY_MAX_STEPS,
                                 device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def lane_words(n):
        return torch.randint(0, 2**32, (n, 2), generator=gen, device=dev, dtype=torch.int64)

    def kernel_inputs(task, stims, keys):
        """What the step hands the kernels: the model, split2 and select16
        weights, the lanes' tree words, the selection's settings."""
        model = parity.sde_model(task.params, task, stims)
        pw = {k: v.detach() for k, v in model.pw.items()}
        w2 = {k: v.contiguous() for k, v in prepare_premixed_split2(pw, model.sc.fc)[0].items()}
        return (model, w2, premix_select16(pw), sa._sde_key_words(keys),
                sa.select_config(task.ts, max_steps=task.max_steps))

    def replay_inputs(st, words, scfg):
        ht, dw, i10 = sa._replay_grid(st, words, scfg.t_start, scfg.t_end, scfg.depth)
        return tuple(x.T.contiguous() for x in (ht[:, :-1], ht[:, 1:] - ht[:, :-1], dw, i10))

    # -- 5. kernel vs plain -------------------------------------------------
    task = make_task(PARITY_T)
    P, B = task.net.num_pops, PARITY_B
    S, n_in, K = 3 * P, 4, 4
    stims, keys = make_parity_batch(gen, n_in, B, device=dev), lane_words(B)
    model, w2, w16, words, scfg = kernel_inputs(task, stims, keys)
    y0 = torch.zeros(B, S, device=dev)
    st, na, nr, ok = ns.select_pass(y0, words, w16, model.sc, model.kv, scfg)
    check(bool(ok.all()), f"full-horizon selection failed: naccept {na.tolist()}")
    grid = replay_inputs(st, words, scfg)        # t0s, hs, dw, i10: (2M, B)
    n_real = 2 * int(na.max())
    ys = ns.replay_fwd(y0, *grid, n_real, w2, model.sc, model.kv)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(ys).all()), "full-horizon replay is not finite")

    # One controller attempt on 64 states of that replay: each at an
    # accepted time of its lane, with 1, 1.5 and 2 times the accepted step.
    N = 64
    lanes = [r % B for r in range(N)]
    rows = [2 * int((r // B) / (N // B) * (int(na[b]) - 1)) for r, b in zip(range(N), lanes)]
    li = torch.tensor(lanes, device=dev)
    ri = torch.tensor(rows, device=dev)
    y1 = ys[ri, li].contiguous()
    t1 = st[li, ri // 2][:, None].contiguous()
    fac = torch.tensor([1.0 + 0.5 * ((r // B) % 3) for r in range(N)], device=dev)[:, None]
    h = ((st[li, ri // 2 + 1][:, None] - t1) * fac).contiguous()
    err_prev = torch.full((N, 1), 0.7, device=dev)
    w_r, kv_r = words[li].contiguous(), model.kv[:, li].contiguous()
    w_t1 = ns._tree(w_r, scfg).evaluate(t1).contiguous()
    att = ns.select_attempt(t1, y1, h, err_prev, w_t1, w_r, w16, model.sc, kv_r, scfg)
    att_p = ns._attempt_plain(t1, y1, h, err_prev, w_t1, w_r, w16, model.sc, kv_r, scfg)
    torch.cuda.synchronize()
    e_err = float(((att.err - att_p.err).abs() / att_p.err.clamp_min(1e-30)).max())
    e_hn = float(((att.h_next - att_p.h_next).abs() / att_p.h_next).max())
    same = bool(torch.equal(att.accept, att_p.accept))
    att_bit = all(torch.equal(g, w) for g, w in zip(att, att_p))
    check(same and att_bit and e_err < 1e-5 and e_hn < 1e-6,
          f"sde_attempt: accept equal {same}, bit for bit {att_bit}, err rel {e_err}, "
          f"h_next rel {e_hn}")
    n_acc = int(att.accept.sum())

    # The whole selection over FLAGSHIP_SEL_T grid points, kernel and plain loop.
    task_s = make_task(FLAGSHIP_SEL_T, params=task.params)
    model_s, w2_s, w16_s, words_s, scfg_s = kernel_inputs(task_s, stims, keys)
    st_k, na_k, nr_k, ok_k = ns.select_pass(y0, words_s, w16_s, model_s.sc, model_s.kv, scfg_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, na_p, nr_p, ok_p = ns._select_plain(y0, words_s, w16_s, model_s.sc, model_s.kv,
                                              scfg_s)
    torch.cuda.synchronize()
    plain_ms = {"sde_select": (time.perf_counter() - t0) * 1e3}
    e_t10 = float(((st_k[:, :11] - st_p[:, :11]).abs() / st_p[:, :11].clamp_min(1e-30)).max())
    e_na = float(((na_k - na_p).abs().float() / na_p.float()).max())
    # The largest difference of accepted times over each lane's common
    # accepted prefix, and the first accepted index where the grids part.
    common = torch.minimum(na_k, na_p).long()[:, None]
    idx = torch.arange(st_k.shape[1], device=dev)[None]
    d_st = torch.where(idx <= common, (st_k - st_p).abs(), 0.0)
    part = [int(torch.nonzero(r).min()) if bool(r.any()) else None for r in d_st > 0]
    sel_bit = all(torch.equal(g, w) for g, w in zip((st_k, na_k, nr_k, ok_k),
                                                    (st_p, na_p, nr_p, ok_p)))
    check(bool(ok_k.all()) and bool(ok_p.all()) and sel_bit and e_t10 < 1e-6 and e_na < 0.1,
          f"sde_select over {FLAGSHIP_SEL_T} points: success {ok_k.tolist()} {ok_p.tolist()}, "
          f"bit for bit {sel_bit}, first 10 times rel {e_t10}, naccept {na_k.tolist()} vs "
          f"{na_p.tolist()}")

    # The replay and its reverse sweep on one truncation window (64 half
    # steps) early, in the middle and late, from the kernel's state there.
    W = 64
    errs = {"sde_select": float(d_st.max()), "sde_replay_fwd": 0.0, "sde_replay_bwd": 0.0}
    windows = []
    for k0 in (0, (n_real // 2) & ~1, n_real - W):
        win = tuple(x[k0:k0 + W].contiguous() for x in grid)
        ys_k = ns.replay_fwd(ys[k0].contiguous(), *win, W, w2, model.sc, model.kv)
        ys_p = ns._replay_fwd_plain(ys[k0].contiguous(), *win, W, w2, model.sc, model.kv)
        ysbar = torch.randn(W, B, S, generator=gen, device=dev)
        bwd = (ys_p[:-1].contiguous(), ysbar, win[0], win[1], win[3], W, 0, w2, model.sc,
               model.kv)
        yb, seeds = ns.replay_bwd(*bwd)
        yb_p, seeds_p = ns._replay_bwd_plain(*bwd)
        torch.cuda.synchronize()
        e = {"fwd_scaled": scaled_err(ys_k, ys_p), "seeds_rel_l2": rel_l2_rows(seeds, seeds_p),
             "carry_rel_l2": rel_l2_rows(yb[None], yb_p[None])}
        check(all(torch.isfinite(x).all() for x in (ys_k, seeds, yb))
              and e["fwd_scaled"] < 1e-4 and e["seeds_rel_l2"] < 1e-4
              and e["carry_rel_l2"] < 1e-4, f"replay window at {k0}: {e}")
        errs["sde_replay_fwd"] = max(errs["sde_replay_fwd"], float((ys_k - ys_p).abs().max()))
        errs["sde_replay_bwd"] = max(errs["sde_replay_bwd"], float((seeds - seeds_p).abs().max()))
        e["fwd"] = record_replay2("sde_replay_fwd", sum(PARITY_CPA), ys_k, ys_p)
        e["bwd"] = record_replay2("sde_replay_bwd", sum(PARITY_CPA), (seeds, yb), (seeds_p, yb_p))
        windows.append({"start": k0, **e})
    emit("parity_kernel_vs_plain", columns=sum(PARITY_CPA), P=P, lanes=B, T=PARITY_T,
         naccept=na.tolist(), nreject=nr.tolist(), n_real=n_real,
         attempt={"records": N, "accepted": n_acc, "err_rel": e_err, "err_tol": 1e-5,
                  "h_next_rel": e_hn, "h_next_tol": 1e-6, "accept_equal": same,
                  "bit_for_bit": att_bit},
         selection={"T": FLAGSHIP_SEL_T, "bit_for_bit": sel_bit,
                    "naccept": na_k.tolist(), "naccept_plain": na_p.tolist(),
                    "nreject": nr_k.tolist(), "nreject_plain": nr_p.tolist(),
                    "first10_rel": e_t10, "first10_tol": 1e-6, "naccept_rel": e_na,
                    "naccept_tol": 0.1, "common_prefix_max_abs": float(d_st.max()),
                    "first_parted_index": part},
         attempt_y_new_max_abs=float((att.y_new - att_p.y_new).abs().max()),
         windows=windows, tol={"fwd_scaled": 1e-4, "seeds_rel_l2": 1e-4, "carry_rel_l2": 1e-4},
         max_abs_err=errs)

    # -- 6. the main path: FULL_STEPS training steps at full width (its first
    # step's kernels timed with CUDA events around each call) ---------------------
    step = parity.make_train_step(task, **FLAGSHIP)
    masks = {k: v.bool() for k, v in task.grad_mask.items()}
    params_first = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    for k in ns.LAUNCHES:
        ns.LAUNCHES[k] = 0
    history, step_s, log = [], [], []
    for i in range(FULL_STEPS):
        stims_i, keys_i = make_parity_batch(gen, n_in, B, device=dev), lane_words(B)
        before = dict(ns.LAUNCHES)
        restore = ([event_timed(sa, ("select_pass",), log),
                    event_timed(fused, ("replay_fwd", "replay_bwd", "outer_arg_grads"), log)]
                   if i == 0 else [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            rec = step(stims_i, keys_i)
            torch.cuda.synchronize()
        finally:
            for r in restore:
                r()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            first_stats = rec["stats"]
        launched = {k: ns.LAUNCHES[k] - before[k] for k in ns.LAUNCHES}
        check(launched == {**dict.fromkeys(ns.LAUNCHES, 0), "sde_select": 1,
                           "sde_replay_fwd": 1, "sde_replay_bwd": 1},
              f"step {i}: launches {launched}")
        stats = rec["stats"]
        check(bool(stats.success.all()) and bool(torch.isfinite(rec["loss"])),
              f"step {i}: success {stats.success.tolist()}, loss {rec['loss']}")
        for k, p in task.params.items():
            check(bool((p.grad[~masks[k]] == 0).all()), f"step {i}: {k} gradient off its mask")
        history.append({"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                        "update_applied": bool(rec["ok"]), "naccept": stats.naccept.tolist(),
                        "nreject": stats.nreject.tolist(), "seconds": step_s[-1]})
    main_launches = dict(ns.LAUNCHES)

    # A step on the card from the parameters of the main path's first step,
    # and the same step on the CPU with the plain versions on the card's
    # frozen grid and lane words (unclipped, so that both gradients are
    # compared as computed). Over GRAD_T grid points
    # (5 ms) every gradient is held at 104 columns, so the reverse sweep and
    # the weight-gradient contraction at P = 832 are compared through the
    # step. Over FLAGSHIP_OUT_T points the solver's weight gradients are
    # ill-conditioned at 104 columns: the CPU's own gradient moves by O(1)
    # when the weights move by one part in 1e7 ("spread"), so the loss and
    # the output-weight gradient are held there; at 13 columns over SHORT_T
    # points every gradient.
    check_flags = {**FLAGSHIP, "clip_grad_norm": None}

    def step_grads(cpa, T_check, params):
        t = make_task(T_check, device=dev, params=params, cpa=cpa)
        rec = parity.make_train_step(t, **check_flags)(stims, keys)
        return rec, {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}

    def rel_l2(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in a}

    def compare(res, cpa, T_check, held_keys, loss_k, grad_k, naccept):
        (loss_c, grad_c, _), nudged = res[0], res[1:]
        loss_rel = abs(loss_k - loss_c) / abs(loss_c)
        grad_rel = rel_l2(grad_k, grad_c)
        entry = {"T": T_check, "naccept": naccept, "loss_rel": loss_rel,
                 "grad_rel_l2": grad_rel, "held": held_keys or "all",
                 "tol": {"loss": 1e-4, "grad": 1e-3}}
        if nudged:
            entry["spread"] = rel_l2(nudged[0][1], grad_c)
        held = max(grad_rel[k] for k in (held_keys or grad_rel))
        check(loss_rel < 1e-4 and held < 1e-3,
              f"card vs CPU parity step at columns {cpa}: {entry}")
        return entry

    for cpa, T_check, held_keys in ((PARITY_CPA, GRAD_T, None),
                                    (PARITY_CPA, FLAGSHIP_OUT_T, ("output_weights",)),
                                    ((8, 4, 1), SHORT_T, None)):
        src = make_task(T_check, cpa=cpa).params if cpa != PARITY_CPA else params_first
        params0 = {k: p.detach().cpu().clone() for k, p in src.items()}
        rec_k, grad_k = step_grads(cpa, T_check, params0)
        sk = rec_k["stats"]
        plist = [params0]
        if cpa == PARITY_CPA:
            plist.append({k: v if k == "output_weights" else v * (1.0 + 1e-7)
                          for k, v in params0.items()})
        cpu_later("parity_cpu_check", f"{sum(cpa)}_columns_{T_check}_points",
                  lambda res, a=(cpa, T_check, held_keys, float(rec_k["loss"]), grad_k,
                                 sk.naccept.tolist()): compare(res, *a),
                  "parity", cfg, dict(columns_per_area=cpa, n_inputs=4, time_steps=T_check,
                                      max_steps=PARITY_MAX_STEPS), check_flags,
                  args=(stims, keys),
                  kwargs=dict(grid=(sk.step_times, sk.naccept, sk.nreject)), params_list=plist)
    emit("parity_main_path", columns=sum(PARITY_CPA), lanes=B, T=PARITY_T,
         max_steps=PARITY_MAX_STEPS, history=history, launches=main_launches,
         cpu_check="parity_cpu_check")

    # -- 7. times -----------------------------------------------------------
    # Each kernel's time on the main path: its CUDA events in the first step.
    main_ms = {}
    for name, start, end in log:
        main_ms[name] = main_ms.get(name, 0.0) + start.elapsed_time(end)
    grid_s = replay_inputs(st_k, words_s, scfg_s)
    n_real_s = 2 * int(na_k.max())
    ys_s = ns.replay_fwd(y0, *grid_s, n_real_s, w2_s, model_s.sc, model_s.kv)
    ysbar_s = torch.randn(ys_s.shape[0] - 1, B, S, generator=gen, device=dev)
    stride = truncation_stride((B, S), 2 * PARITY_MAX_STEPS, 2 * FLAGSHIP["bptt_every"])
    calls = {  # (the main path's call, FLAGSHIP_SEL_T shapes, the plain version there)
        "sde_select": (
            "select_pass",
            lambda: ns.select_pass(y0, words_s, w16_s, model_s.sc, model_s.kv, scfg_s), None),
        "sde_replay_fwd": (
            "replay_fwd",
            lambda: ns.replay_fwd(y0, *grid_s, n_real_s, w2_s, model_s.sc, model_s.kv),
            lambda: ns._replay_fwd_plain(y0, *grid_s, n_real_s, w2_s, model_s.sc,
                                         model_s.kv)),
        "sde_replay_bwd": (
            "replay_bwd",
            lambda: ns.replay_bwd(ys_s[:-1], ysbar_s, grid_s[0], grid_s[1], grid_s[3],
                                  n_real_s, stride, w2_s, model_s.sc, model_s.kv),
            lambda: ns._replay_bwd_plain(ys_s[:-1], ysbar_s, grid_s[0], grid_s[1], grid_s[3],
                                         n_real_s, stride, w2_s, model_s.sc, model_s.kv)),
    }
    times = {}
    for name, (main_call, short, plain) in calls.items():
        times[name] = {"ms": main_ms[main_call], "ms_short": cuda_ms(short, reps=3, warmup=1)}
        if plain is not None:
            plain_ms[name] = cuda_ms(plain, reps=1, warmup=0)
    # B3 and B4 on each route of the same FLAGSHIP_SEL_T grid: the cluster teams
    # with their slices resident (the route the shape picks here) or streamed,
    # and the stepping stone (B3t-team's and B4t's bodies on the two-term split,
    # teams of 8 blocks, the terms in L2).
    t_yard = time.perf_counter()
    yardstick = {}
    for route in ("resident", "streamed", "team8"):
        f_ms = cuda_ms(lambda: ns.replay_fwd(y0, *grid_s, n_real_s, w2_s, model_s.sc,
                                             model_s.kv, route=route), reps=3, warmup=1)
        b_ms = cuda_ms(lambda: ns.replay_bwd(ys_s[:-1], ysbar_s, grid_s[0], grid_s[1],
                                             grid_s[3], n_real_s, stride, w2_s, model_s.sc,
                                             model_s.kv, route=route), reps=3, warmup=1)
        yardstick[route] = {"sde_replay_fwd_us_per_half_step": f_ms * 1e3 / n_real_s,
                            "sde_replay_bwd_us_per_half_step": b_ms * 1e3 / n_real_s}
    plan = ns.sde2_replay_plan(P, n_in)
    emit("replay2_teams", columns=sum(PARITY_CPA), P=P, lanes=B, half_steps=n_real_s,
         T=FLAGSHIP_SEL_T, route=ns.sde2_replay_route(P, n_in), plan=plan._asdict(),
         max_active_clusters={"sde_replay_fwd": ns.sde2_max_clusters(P, n_in, False, False),
                              "sde_replay_bwd": ns.sde2_max_clusters(P, n_in, False, True)},
         us_per_half_step=yardstick, seconds=time.perf_counter() - t_yard)
    na_m, nr_m = first_stats.naccept, first_stats.nreject
    n_real_m = 2 * int(na_m.max())
    attempts, half_steps = int((na_m + nr_m).sum()), int(2 * na_m.sum())
    serial = {"sde_select": int((na_m + nr_m).max()), "sde_replay_fwd": n_real_m,
              "sde_replay_bwd": n_real_m}
    work = {"sde_select": attempts, "sde_replay_fwd": half_steps, "sde_replay_bwd": half_steps}
    bounds = {name: sde_bound(name, P, B, n_in, K, work[name], n=2 * PARITY_MAX_STEPS,
                              M=PARITY_MAX_STEPS) for name in calls}
    emit("parity_kernel_times", lanes=B, T=PARITY_T, attempts=attempts,
         real_half_steps=half_steps, bwd_truncation_stride=stride,
         ms={k: v["ms"] for k, v in times.items()},
         ms_at_short_horizon={k: v["ms_short"] for k, v in times.items()},
         plain_ms_at_short_horizon=plain_ms,
         ns_per_serial_step={k: times[k]["ms"] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()})

    step_ms = step_s[-1] * 1e3
    # The first step's device time inside the four solver calls' CUDA events
    # (the selection, B3, B4, the outer pass): the step's other device work
    # counts as idle, so 1 - events / step bounds its idle share from above.
    in_events = sum(main_ms.values())
    emit("parity_train_step", ms_per_step=step_ms, samples_per_s=B * 1e3 / step_ms,
         step_seconds=step_s, device_ms_in_solver_events=main_ms,
         idle_share_at_most=1.0 - in_events / (step_s[0] * 1e3))
    short_ms, wall, by_kernel = short_profile(
        parity.make_train_step(make_task(SHORT_T), **FLAGSHIP),
        (make_parity_batch(gen, n_in, B, device=dev), lane_words(B)))
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("parity_step_profile", lanes=B, T=SHORT_T, profiled_wall_ms_per_step=wall,
         step_ms=short_ms, device_busy_ms_per_step=busy if busy else "not measured",
         idle_share=1.0 - busy / short_ms if busy else "not measured",
         device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    replaces = {"sde_select": "columnflow/solvers/sde_adaptive.py:509",
                "sde_replay_fwd": "columnflow/solvers/fused.py:845",
                "sde_replay_bwd": "columnflow/solvers/fused.py:920"}
    sources = {"sde_select": SDE_SOURCE, "sde_replay_fwd": TEAM2_SOURCE,
               "sde_replay_bwd": TEAM2_SOURCE}
    return [{"name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
             "launches": main_launches[name], "max_abs_err": errs[name],
             "ms": times[name]["ms"], "plain_ms": plain_ms[name],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
             "lanes": B,
             "plain_ms_at": f"{FLAGSHIP_SEL_T} grid points (ms_short: the kernel there)",
             "ms_short": times[name]["ms_short"],
             "ns_per_serial_step": times[name]["ms"] * 1e6 / serial[name]}
            for name in calls]


def ode_bound(kernel, P, B, n_in, K, work, M=0):
    """(bound_ms, bound_by) of a dopri5 kernel of the f32-exact engine.
    ``work`` is what this run's data needed: the controller attempts
    (selection) or the accepted steps (replay, sweeps, outer pass). A drift
    evaluation of the batch is six bf16 (B, P) x (P, P) products (2 B P^2
    operations each, at the bf16 tensor rate) and its elementwise float32
    work; a drift VJP three transposed products and three (P, B) x (B, P)
    weight-cotangent products (the emit-mode sweep the transposed ones
    only, the outer pass the weight-side ones of every step again after a
    recomputed drift). Bytes: each input read once, each output written
    once; the float32 weights count once. The teams (B7t-team, B8t-team)
    compute the functions of B7 and B8."""
    kernel = {"ode_replay_fwd_team": "ode_replay_fwd",
              "ode_replay_bwd_team": "ode_replay_bwd"}.get(kernel, kernel)
    S, N = 3 * P, 3 * P * B
    prod = 2 * B * P * P
    drift_f32 = B * (40 * P + 8 * S)      # rates, three-term split, stimulus, tail
    vjp_f32 = B * (30 * P + 10 * S)
    consts = 4 * (P * P + n_in * P + 2 * P + K * B * n_in)
    if kernel == "ode_replay_bwd_emit_split3":  # 6 drifts, 7 state VJPs, the step cotangents out
        flops16 = work * (6 * 6 * prod + 7 * 3 * prod)
        flops32 = work * (6 * drift_f32 + 7 * vjp_f32 + (3 * 21 + 3 * 21 + 40) * N)
        nbytes = consts + 4 * (work + 1) + 4 * work * N * 7 + 4 * N
    elif kernel == "ode_outer_split3":  # per step 7 drifts, 7 state VJPs, 7 weight cotangents
        flops16 = work * 7 * (6 + 3 + 3) * prod
        flops32 = work * (7 * (drift_f32 + vjp_f32 + 12 * P * P) + 3 * P * P)
        nbytes = consts + 4 * (P * P + n_in * P) + 4 * (work + 1) + 4 * work * N * 7
    elif kernel == "ode_select":
        # 6 drifts, the stage sums (21 weighted terms) and the error norm
        flops16 = work * 6 * 6 * prod
        flops32 = work * (6 * drift_f32 + (3 * 21 + 3 * 6 + 8) * N)
        nbytes = consts + 4 * N + 4 * (M + 1) + 12
    elif kernel == "ode_replay_fwd":
        # 7 drifts (stage 0 recomputed), the stage sums, the five dense rows
        flops16 = work * 7 * 6 * prod
        flops32 = work * (7 * drift_f32 + (3 * 21 + 3 * 6 + 8) * N)
        nbytes = consts + 4 * N + 4 * (work + 1) + 4 * work * N * 6
    else:  # ode_replay_bwd: 6 drifts, 7 drift VJPs, the cotangent sums
        flops16 = work * (6 * 6 * prod + 7 * 6 * prod)
        flops32 = work * (6 * drift_f32 + 7 * (B * (60 * P + 10 * S) + 30 * P * P)
                          + (3 * 21 + 3 * 21 + 40) * N + 8 * P * P)
        nbytes = (consts + 4 * (work + 1) + 4 * work * N * 6 + 4 * N
                  + 4 * (P * P + n_in * P))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops16 / BF16_FLOPS + flops32 / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ode_phases(dev, cfg):
    """Phases 8-10 for the deterministic parity step; returns its kernels'
    entries of the kernels line."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.solvers.fused import round_max_steps
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(2)

    def make_task(device=dev, params=None, time_steps=ODE_T):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=ODE_CPA, n_inputs=4, time_steps=time_steps,
                                 max_steps=ODE_MAX_STEPS, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def max_abs(a, b):
        return float((a - b).abs().max())

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    # -- 8. kernel vs plain -------------------------------------------------
    task = make_task()
    P, B = task.net.num_pops, ODE_B
    S, n_in, K = 3 * P, 4, 4
    stims = make_parity_batch(gen, n_in, B, device=dev)
    model = parity.sde_model(task.params, task, stims)
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    sc, kv = model.sc, model.kv.contiguous()
    w3 = no._w3(pw, sc)
    M = round_max_steps((B, S), ODE_MAX_STEPS)
    scfg = no.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]), max_steps=M)
    y0 = torch.zeros(B, S, device=dev)
    st, stats = no.ode_select(y0, pw, sc, kv, scfg)
    na, nr, ok = (int(x) for x in stats)
    check(ok == 1 and M == 3078, f"ode_select: stats {stats.tolist()}, max_steps {M}")
    # The whole selection against its plain loop over the first SHORT_T grid
    # points (the full second's plain loop took 30 s on the card: cut in depth
    # to keep the script under its time limit; the kernel is timed over the
    # whole second).
    cfg_s = scfg._replace(t_end=float(task.ts[SHORT_T - 1]))
    st_k, stats_k = no.ode_select(y0, pw, sc, kv, cfg_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, stats_p = no._ode_select_plain(y0, w3, sc, kv, cfg_s)
    torch.cuda.synchronize()
    plain_ms = {"ode_select": (time.perf_counter() - t0) * 1e3}
    na_k, nr_k, ok_k = (int(x) for x in stats_k)
    na_p, nr_p, ok_p = (int(x) for x in stats_p)
    common = min(na_k, na_p)
    d_st = (st_k[:common + 1] - st_p[:common + 1]).abs()
    parted = int(torch.nonzero(d_st).min()) if bool((d_st > 0).any()) else None
    check(ok_k == 1 and ok_p == 1 and abs(na_k - na_p) <= 0.1 * na_p
          and max_abs(st_k[:11], st_p[:11]) == 0.0,
          f"ode_select over {SHORT_T} points: stats {stats_k.tolist()} vs plain "
          f"{stats_p.tolist()}, first parted index {parted}")
    n = na
    stn = st[:n + 1].contiguous()
    ys, coeffs = no.ode_replay_fwd(y0, stn, pw, sc, kv)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(ys).all()) and bool(torch.isfinite(coeffs).all()),
          "full replay is not finite")

    # Single attempts from 16 states along the replay, with 1, 1.5 and 2.5
    # times the accepted step.
    att = {"ratio_rel": 0.0, "h_next_rel": 0.0, "y1_max_abs": 0.0, "accepted": 0, "equal": True,
           "bit_for_bit": True}
    for r in range(16):
        k = int(r / 16 * (n - 1))
        t, y = st[k].clone(), ys[k].contiguous()
        h = ((st[k + 1] - st[k]) * (1.0, 1.5, 2.5)[r % 3]).clone()
        f0 = no.ode_drift(t, y, w3, sc, kv).contiguous()
        a = no.ode_attempt(t, y, f0, h, pw, sc, kv, scfg)
        a_p = no._ode_attempt_plain(t, y, f0, h, w3, sc, kv, scfg)
        att["ratio_rel"] = max(att["ratio_rel"], float((a.ratio - a_p.ratio).abs() / a_p.ratio))
        att["h_next_rel"] = max(att["h_next_rel"],
                                float((a.h_next - a_p.h_next).abs() / a_p.h_next))
        att["y1_max_abs"] = max(att["y1_max_abs"], max_abs(a.y1, a_p.y1), max_abs(a.f1, a_p.f1))
        att["accepted"] += int(a.ratio <= 1.0)
        att["equal"] &= bool((a.ratio <= 1.0) == (a_p.ratio <= 1.0))
        att["bit_for_bit"] &= all(torch.equal(g, w) for g, w in zip(a, a_p))
    check(att["equal"] and att["bit_for_bit"] and att["ratio_rel"] < 1e-5
          and att["h_next_rel"] < 1e-6,
          f"ode_attempt: {att}")

    # The replay and its reverse sweep on windows early, in the middle and
    # late, each from the kernel's state there.
    W = ODE_WINDOW
    errs = {"ode_select": float(d_st.max()), "ode_replay_fwd": 0.0, "ode_replay_bwd": 0.0}
    windows = []
    for k0 in (0, n // 2, n - W):
        stw = st[k0:k0 + W + 1].contiguous()
        ys_k, co_k = no.ode_replay_fwd(ys[k0].contiguous(), stw, pw, sc, kv)
        ys_p, co_p = no._ode_replay_fwd_plain(ys[k0].contiguous(), stw, w3, sc, kv)
        cobar = torch.randn(W, 5, B, S, generator=gen, device=dev)
        yb, dw, diw = no.ode_replay_bwd(ys_p.contiguous(), cobar, stw, pw, sc, kv)
        yb_p, dw_p, diw_p = no._ode_replay_bwd_plain(ys_p, cobar, stw, w3, sc, kv)
        # B8, the one-block kernel the cluster team replaced on this path
        old = no.ode_replay_bwd(ys_p.contiguous(), cobar, stw, pw, sc, kv, route="block")
        torch.cuda.synchronize()
        e = {"ys_scaled": scaled_err(ys_k, ys_p), "coeffs_max_abs": max_abs(co_k, co_p),
             "ybar_rel_l2": rel_l2(yb, yb_p), "d_wT_rel_l2": rel_l2(dw, dw_p),
             "d_iwT_rel_l2": rel_l2(diw, diw_p),
             "sweep_elements_parted_from_plain": [int((g != w).sum()) for g, w in
                                                  zip((yb, dw, diw), (yb_p, dw_p, diw_p))],
             "sweep_elements_parted_from_block": [int((g != w).sum()) for g, w in
                                                  zip((yb, dw, diw), old)]}
        check(all(bool(torch.isfinite(x).all()) for x in (ys_k, co_k, yb, dw, diw))
              and e["ys_scaled"] < 1e-6 and e["ybar_rel_l2"] < 1e-5
              and e["d_wT_rel_l2"] < 1e-5 and e["d_iwT_rel_l2"] < 1e-5
              and not any(e["sweep_elements_parted_from_plain"])
              and not any(e["sweep_elements_parted_from_block"]),
              f"ode replay window at {k0}: {e}")
        errs["ode_replay_fwd"] = max(errs["ode_replay_fwd"], max_abs(ys_k, ys_p),
                                     max_abs(co_k, co_p))
        errs["ode_replay_bwd"] = max(errs["ode_replay_bwd"], max_abs(yb, yb_p),
                                     max_abs(dw, dw_p), max_abs(diw, diw_p))
        windows.append({"start": k0, **e})
    emit("ode_kernel_vs_plain", columns=sum(ODE_CPA), P=P, lanes=B, T=ODE_T, max_steps=M,
         selection={"stats": [na, nr, ok], "T": SHORT_T, "stats_at_T": [na_k, nr_k, ok_k],
                    "stats_plain_at_T": [na_p, nr_p, ok_p],
                    "equal": bool(torch.equal(st_k, st_p)
                                  and stats_k.tolist() == stats_p.tolist()),
                    "common_prefix_max_abs": float(d_st.max()), "first_parted_index": parted,
                    "first10_max_abs": max_abs(st_k[:11], st_p[:11])},
         attempt={"records": 16, **att, "ratio_tol": 1e-5, "h_next_tol": 1e-6},
         windows=windows, tol={"ys_scaled": 1e-6, "rel_l2": 1e-5}, max_abs_err=errs)

    # -- 9. the main path: 5 training steps at full width ---------------------
    step = parity.make_train_step(task)
    masks = {k: v.bool() for k, v in task.grad_mask.items()}
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    for k in no.LAUNCHES:
        no.LAUNCHES[k] = 0
    history, step_s = [], []
    for i in range(5):
        stims_i = stims if i == 0 else make_parity_batch(gen, n_in, B, device=dev)
        before = dict(no.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = step(stims_i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launched = {k: no.LAUNCHES[k] - before[k] for k in no.LAUNCHES}
        check(launched == {**{k: 0 for k in no.LAUNCHES}, "ode_select": 1, "ode_replay_fwd": 1,
                           "ode_replay_bwd_ksweep": 1}, f"ode step {i}: launches {launched}")
        sk = rec["stats"]
        check(bool(sk.success) and bool(torch.isfinite(rec["loss"])),
              f"ode step {i}: success {bool(sk.success)}, loss {rec['loss']}")
        for k, p in task.params.items():
            check(bool(torch.isfinite(p.grad).all()) and bool((p.grad[~masks[k]] == 0).all()),
                  f"ode step {i}: {k} gradient not finite or off its mask")
        history.append({"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                        "update_applied": bool(rec["ok"]), "naccept": int(sk.naccept),
                        "nreject": int(sk.nreject), "seconds": step_s[-1]})
    main_launches = dict(no.LAUNCHES)

    # The first step's weights again over SHORT_T grid points on the card and
    # on the CPU with the plain versions on the card's frozen grid (the full
    # second took 36 s of CPU for the two steps: cut in depth to keep the
    # script under its time limit); then the CPU once more with every
    # solver weight nudged by one part in 1e7, which shows how far the
    # gradient itself is determined: the reverse sweep rounds every
    # transposed product to bf16 (the rounding points of jax.vjp through the
    # three-term split), so a last-bit change of an input flips roundings
    # 2^-9 apart.
    t_s = make_task(params=params0, time_steps=SHORT_T)
    rec_k = parity.make_train_step(t_s)(stims)
    grad_k = {k: p.grad.detach().cpu().clone() for k, p in t_s.params.items()}
    grid_k = (rec_k["stats"].step_times.cpu(), int(rec_k["stats"].naccept))

    def compare(res, loss_k=float(rec_k["loss"]), grad_k=grad_k, naccept=grid_k[1]):
        (loss_c, grad_c, _), (_, grad_n, _) = res
        loss_rel = abs(loss_k - loss_c) / abs(loss_c)
        grad_rel = {k: rel_l2(grad_k[k], grad_c[k]) for k in grad_k}
        spread = {k: rel_l2(grad_n[k], grad_c[k]) for k in grad_k}
        entry = {"T": SHORT_T, "naccept": naccept, "loss_rel": loss_rel,
                 "grad_rel_l2": grad_rel, "spread_under_1e-7_nudge": spread,
                 "tol": {"loss": ODE_LOSS_TOL, "grad": ODE_GRAD_TOL}}
        check(loss_rel < ODE_LOSS_TOL and max(grad_rel.values()) < ODE_GRAD_TOL,
              f"card vs CPU deterministic step: {entry}")
        return entry

    nudged = {k: v if k == "output_weights" else v * (1.0 + 1e-7) for k, v in params0.items()}
    cpu_later("ode_cpu_check", f"{SHORT_T}_points", compare, "parity", cfg,
              dict(columns_per_area=ODE_CPA, n_inputs=4, time_steps=SHORT_T,
                   max_steps=ODE_MAX_STEPS), {}, args=(stims,), kwargs=dict(grid=grid_k),
              params_list=[params0, nudged])
    emit("ode_main_path", columns=sum(ODE_CPA), lanes=B, T=ODE_T, max_steps=M,
         history=history, launches=main_launches, cpu_check="ode_cpu_check")

    # -- 10. times ----------------------------------------------------------
    cobar = torch.randn(n, 5, B, S, generator=gen, device=dev)
    # The plain versions are timed on the first W steps (the kernels there too).
    stw, ysw, cobw = st[:W + 1].contiguous(), ys[:W].contiguous(), cobar[:W].contiguous()
    calls = {
        "ode_select": (lambda: no.ode_select(y0, pw, sc, kv, scfg), None, None),
        "ode_replay_fwd": (lambda: no.ode_replay_fwd(y0, stn, pw, sc, kv),
                           lambda: no.ode_replay_fwd(y0, stw, pw, sc, kv),
                           lambda: no._ode_replay_fwd_plain(y0, stw, w3, sc, kv)),
        "ode_replay_bwd": (lambda: no.ode_replay_bwd(ys, cobar, stn, pw, sc, kv),
                           lambda: no.ode_replay_bwd(ysw, cobw, stw, pw, sc, kv),
                           lambda: no._ode_replay_bwd_plain(ysw, cobw, stw, w3, sc, kv)),
    }
    times, window_ms = {}, {}
    for name, (kern, short, plain) in calls.items():
        times[name] = cuda_ms(kern, reps=3, warmup=1)
        if plain is not None:
            window_ms[name] = cuda_ms(short, reps=3, warmup=1)
            plain_ms[name] = cuda_ms(plain, reps=1, warmup=0)
    serial = {"ode_select": na + nr, "ode_replay_fwd": n, "ode_replay_bwd": n}
    bounds = {name: ode_bound(name, P, B, n_in, K, serial[name], M=M) for name in calls}
    # B6's cluster team against team8 over the short horizon of phase 8; the
    # sweep's against B8 (route "block") on a ROUTE_W-step window in the
    # middle of the full grid.
    sel_routes = team_routes(lambda r: no.ode_select(y0, pw, sc, kv, cfg_s, route=r),
                             na_k + nr_k, no.ode_team_route(P, n_in, B, 3, False))
    kr = max(0, min(n - ROUTE_W, n // 2))
    str_, ysr = st[kr:kr + ROUTE_W + 1].contiguous(), ys[kr:kr + ROUTE_W].contiguous()
    cobr = cobar[kr:kr + ROUTE_W].contiguous()
    W_r = str_.shape[0] - 1
    bwd_routes = {"steps": W_r, "start": kr, **sweep_routes(
        lambda r: no.ode_replay_bwd(ysr, cobr, str_, pw, sc, kv, route=r), W_r,
        no.ode_bwd_route(P, n_in, B), "block")}
    emit("ode_kernel_times", lanes=B, T=ODE_T, naccept=na, nreject=nr, ms=times,
         team_routes={"ode_select": {"T": SHORT_T, **sel_routes}, "ode_replay_bwd": bwd_routes},
         plain_ms=plain_ms, plain_window_steps=W, kernel_ms_on_plain_window=window_ms,
         ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()})
    step_ms = sum(step_s[1:]) * 1e3 / len(step_s[1:])
    emit("ode_train_step", ms_per_step=step_ms, samples_per_s=B * 1e3 / step_ms,
         step_seconds=step_s)
    batches = [make_parity_batch(gen, n_in, B, device=dev) for _ in range(2)]
    wall, by_kernel = device_profile(lambda i: step(batches[i]), len(batches))
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("ode_step_profile", lanes=B, profiled_wall_ms_per_step=wall, step_ms=step_ms,
         device_busy_ms_per_step=busy if busy else "not measured",
         idle_share=1.0 - busy / step_ms if busy else "not measured",
         device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    replaces = {"ode_select": "columnflow/solvers/fused.py:238",
                "ode_replay_fwd": "columnflow/solvers/fused.py:294",
                "ode_replay_bwd": "columnflow/solvers/fused.py:327"}
    sweep = {"kernel": "ode_ksweep16_kernel (cf_ode_replay_bwd_ksweep): one cluster team "
                       "for the batch", "launch_key": "ode_replay_bwd_ksweep",
             "weights": bwd_routes["weights"],
             "registers": ptxas_of("ode_ksweep16_kernel"), "team_routes": bwd_routes}
    return [{"name": name, "route": "cuda", "source": ODE_TEAM_SOURCES.get(name, ODE_SOURCE),
             "replaces": replaces[name],
             "launches": main_launches["ode_replay_bwd_ksweep" if name == "ode_replay_bwd"
                                       else name],
             "max_abs_err": errs[name], "ms": times[name],
             "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None, "lanes": B,
             "path": f"deterministic f32-exact, {sum(ODE_CPA)} columns",
             "ns_per_serial_step": times[name] * 1e6 / serial[name],
             **({"team_routes": {"T": SHORT_T, **sel_routes}} if name == "ode_select" else {}),
             **(sweep if name == "ode_replay_bwd" else {}),
             **({"plain_ms_at": f"{W} steps (ms_window: the kernel there)",
                 "ms_window": window_ms[name]} if name in window_ms
                else {"plain_ms_at": f"the whole selection over {SHORT_T} grid points"})}
            for name in calls]


def split2_bound(kernel, P, B, n_in, K, work, M=0):
    """(bound_ms, bound_by) of the split2 tier's kernels and its outer
    weight-gradient pass. ``work``: the controller attempts (selection) or
    accepted steps. A three-term drift evaluation of the batch is six bf16
    (B, P) x (P, P) products, a two-term one three, a two-term state VJP two
    transposed products and, in the outer pass, two (P, B) x (B, P) weight
    products; each 2 B P^2 operations at the bf16 tensor rate, the
    elementwise work at the float32 rate. Bytes: each input read once, each
    output written once; the weights count once."""
    S, N = 3 * P, 3 * P * B
    prod = 2 * B * P * P
    drift_f32 = B * (40 * P + 8 * S)
    vjp_f32 = B * (30 * P + 10 * S)
    consts = 4 * (n_in * P + 2 * P + K * B * n_in)
    if kernel == "ode_select":
        flops16 = work * 6 * 6 * prod
        flops32 = work * (6 * drift_f32 + (3 * 21 + 3 * 6 + 8) * N)
        nbytes = 2 * 3 * P * P + consts + 4 * N + 4 * (M + 1) + 12
    elif kernel == "ode_replay_fwd_split2":
        flops16 = work * 7 * 3 * prod
        flops32 = work * (7 * drift_f32 + (3 * 21 + 3 * 6 + 8) * N)
        nbytes = 2 * 2 * P * P + consts + 4 * N + 4 * (work + 1) + 4 * work * N * 6
    elif kernel == "ode_replay_bwd_emit":  # 6 drifts, 7 state VJPs
        flops16 = work * (6 * 3 * prod + 7 * 2 * prod)
        flops32 = work * (6 * drift_f32 + 7 * vjp_f32 + (3 * 21 + 3 * 21 + 40) * N)
        nbytes = 4 * 2 * P * P + consts + 4 * (work + 1) + 4 * work * N * 7 + 4 * N
    else:  # the outer pass: per step 7 drifts, 7 state VJPs, 7 weight cotangents
        flops16 = work * 7 * (3 * prod + 2 * prod + 2 * prod)
        flops32 = work * (7 * (drift_f32 + vjp_f32 + 8 * P * P) + 2 * P * P)
        nbytes = 2 * 4 * (P * P + n_in * P) + consts + 4 * (work + 1) + 4 * work * N * 7
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops16 / BF16_FLOPS + flops32 / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split2_phases(dev, cfg, frozen):
    """Phases 11-15 for the 104-column deterministic split2 tier; returns
    its kernels' entries of the kernels line, and leaves its frozen
    104-column grid, batch and weights in ``frozen``."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.models.network import prepare_premixed_split, prepare_premixed_split2
    from columnflow_torch.solvers import fused
    from columnflow_torch.solvers.fused import round_max_steps
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(3)

    def make_task(time_steps=S2_T, device=dev, params=None, cpa=S2_CPA):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=4, time_steps=time_steps,
                                 max_steps=S2_MAX_STEPS, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def max_abs(a, b):
        return float((a - b).abs().max())

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def split(pw, sc):
        w3 = {k: v.contiguous() for k, v in prepare_premixed_split(pw, sc.fc)[0].items()}
        w2 = {k: v.contiguous() for k, v in prepare_premixed_split2(pw, sc.fc)[0].items()}
        return w3, w2

    # -- 11. kernel vs plain -------------------------------------------------
    task = make_task()
    P, B = task.net.num_pops, S2_B
    S, n_in, K = 3 * P, 4, 4
    stims = make_parity_batch(gen, n_in, B, device=dev)
    model = parity.sde_model(task.params, task, stims)
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    sc, kv = model.sc, model.kv.contiguous()
    w3, w2 = split(pw, sc)
    M = round_max_steps((B, S), S2_MAX_STEPS)
    scfg = no.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]), max_steps=M)
    y0 = torch.zeros(B, S, device=dev)
    st, stats = no.ode_select(y0, pw, sc, kv, scfg)
    na, nr, ok = (int(x) for x in stats)
    check(ok == 1 and M == S2_MAX_STEPS, f"ode_select (split2 tier): stats {stats.tolist()}")
    # Both tiers select on the three-term drift: the exact engine's phases
    # replay this grid at 104 columns (the same weights and batch).
    frozen.update(step_times=st, naccept=na, stims=stims,
                  params={k: p.detach().clone() for k, p in task.params.items()})
    # The whole selection against its plain loop over the first S2_SEL_T grid
    # points: the plain loop launches a few hundred PyTorch kernels per
    # attempt, and the full second takes ~1.3e4 attempts.
    cfg_s = scfg._replace(t_end=float(task.ts[S2_SEL_T - 1]))
    st_k, stats_k = no.ode_select(y0, pw, sc, kv, cfg_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, stats_p = no._ode_select_plain(y0, w3, sc, kv, cfg_s)
    torch.cuda.synchronize()
    plain_ms = {"ode_select": (time.perf_counter() - t0) * 1e3}
    na_k, nr_k, ok_k = (int(x) for x in stats_k)
    na_p, nr_p, ok_p = (int(x) for x in stats_p)
    common = min(na_k, na_p)
    d_st = (st_k[:common + 1] - st_p[:common + 1]).abs()
    parted = int(torch.nonzero(d_st).min()) if bool((d_st > 0).any()) else None
    check(ok_k == 1 and ok_p == 1 and abs(na_k - na_p) <= 0.1 * na_p
          and max_abs(st_k[:11], st_p[:11]) == 0.0,
          f"ode_select over {S2_SEL_T} points: stats {stats_k.tolist()} vs plain "
          f"{stats_p.tolist()}, first parted index {parted}")
    n = na
    stn = st[:n + 1].contiguous()
    ys, coeffs = no.ode_replay_fwd_split2(y0, stn, w2, sc, kv)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(ys).all()) and bool(torch.isfinite(coeffs).all()),
          "full split2 replay is not finite")

    # Single attempts from 16 states along the replay, with 1, 1.5 and 2.5
    # times the accepted step.
    att = {"ratio_rel": 0.0, "h_next_rel": 0.0, "y1_max_abs": 0.0, "accepted": 0, "equal": True,
           "bit_for_bit": True}
    for r in range(16):
        k = int(r / 16 * (n - 1))
        t, y = st[k].clone(), ys[k].contiguous()
        h = ((st[k + 1] - st[k]) * (1.0, 1.5, 2.5)[r % 3]).clone()
        f0 = no.ode_drift(t, y, w3, sc, kv).contiguous()
        a = no.ode_attempt(t, y, f0, h, pw, sc, kv, scfg)
        a_p = no._ode_attempt_plain(t, y, f0, h, w3, sc, kv, scfg)
        att["ratio_rel"] = max(att["ratio_rel"], float((a.ratio - a_p.ratio).abs() / a_p.ratio))
        att["h_next_rel"] = max(att["h_next_rel"],
                                float((a.h_next - a_p.h_next).abs() / a_p.h_next))
        att["y1_max_abs"] = max(att["y1_max_abs"], max_abs(a.y1, a_p.y1), max_abs(a.f1, a_p.f1))
        att["accepted"] += int(a.ratio <= 1.0)
        att["equal"] &= bool((a.ratio <= 1.0) == (a_p.ratio <= 1.0))
        att["bit_for_bit"] &= all(torch.equal(g, w) for g, w in zip(a, a_p))
    check(att["equal"] and att["bit_for_bit"] and att["ratio_rel"] < 1e-5
          and att["h_next_rel"] < 1e-6,
          f"ode_attempt (split2 tier): {att}")

    # The replay and the emit sweep on windows early, in the middle and
    # late, each from the kernel's state there.
    W = ODE_WINDOW
    errs = {"ode_select": float(d_st.max()), "ode_replay_fwd_split2": 0.0,
            "ode_replay_bwd_emit": 0.0}
    windows = []
    for k0 in (0, n // 2, n - W):
        stw = st[k0:k0 + W + 1].contiguous()
        ys_k, co_k = no.ode_replay_fwd_split2(ys[k0].contiguous(), stw, w2, sc, kv)
        ys_p, co_p = no._ode_replay_fwd_plain(ys[k0].contiguous(), stw, w2, sc, kv)
        cobar = torch.randn(W, 5, B, S, generator=gen, device=dev)
        yb, ybs = no.ode_replay_bwd_emit(ys_p.contiguous(), cobar, stw, w2, sc, kv)
        yb_p, ybs_p = no._ode_replay_bwd_emit_plain(ys_p, cobar, stw, w2, sc, kv)
        torch.cuda.synchronize()
        e = {"ys_scaled": scaled_err(ys_k, ys_p), "coeffs_max_abs": max_abs(co_k, co_p),
             "ybar_rel_l2": rel_l2(yb, yb_p), "ybar_steps_rel_l2": rel_l2(ybs, ybs_p),
             "replay_differing": int((ys_k != ys_p).sum() + (co_k != co_p).sum()),
             "equal": bool(torch.equal(ys_k, ys_p) and torch.equal(co_k, co_p)
                           and torch.equal(yb, yb_p) and torch.equal(ybs, ybs_p))}
        # the replay (B7 split2) bit for bit; the sweep within its limits
        check(all(bool(torch.isfinite(x).all()) for x in (ys_k, co_k, yb, ybs))
              and e["replay_differing"] == 0 and e["ybar_rel_l2"] < 1e-5
              and e["ybar_steps_rel_l2"] < 1e-5, f"split2 window at {k0}: {e}")
        errs["ode_replay_fwd_split2"] = max(errs["ode_replay_fwd_split2"], max_abs(ys_k, ys_p),
                                            max_abs(co_k, co_p))
        errs["ode_replay_bwd_emit"] = max(errs["ode_replay_bwd_emit"], max_abs(yb, yb_p),
                                          max_abs(ybs, ybs_p))
        windows.append({"start": k0, **e})
    # Sixteen lanes (every 4-bit pattern) through the selection's team and
    # sixteen replay teams: 20 grid points, the first 8 steps.
    from columnflow_torch.data import parity_combinations

    stims16 = torch.as_tensor(parity_combinations(n_in, fixed_position=False), device=dev)
    model16 = parity.sde_model(task.params, task, stims16)
    kv16, y16 = model16.kv.contiguous(), torch.zeros(16, S, device=dev)
    cfg16 = scfg._replace(t_end=float(task.ts[19]))
    st16, stats16 = no.ode_select(y16, pw, sc, kv16, cfg16)
    st16_p, stats16_p = no._ode_select_plain(y16, w3, sc, kv16, cfg16)
    st16w = st16[:9].contiguous()
    ys16, co16 = no.ode_replay_fwd_split2(y16, st16w, w2, sc, kv16)
    ys16_p, co16_p = no._ode_replay_fwd_plain(y16, st16w, w2, sc, kv16)
    torch.cuda.synchronize()
    lanes16 = {"stats": stats16.tolist(), "stats_plain": stats16_p.tolist(),
               "replay_route": list(no._replay_team(None, P, n_in, 16, 2)[1][:2]),
               "replay_differing": int((ys16 != ys16_p).sum() + (co16 != co16_p).sum()),
               "equal": bool(torch.equal(st16, st16_p) and torch.equal(ys16, ys16_p)
                             and torch.equal(co16, co16_p))}
    check(int(stats16[2]) == 1 and stats16.tolist() == stats16_p.tolist()
          and lanes16["replay_differing"] == 0, f"16 lanes: {lanes16}")
    emit("split2_kernel_vs_plain", columns=sum(S2_CPA), P=P, lanes=B, T=S2_T, max_steps=M,
         sixteen_lanes=lanes16,
         selection={"stats": [na, nr, ok], "T": S2_SEL_T, "stats_at_T": [na_k, nr_k, ok_k],
                    "stats_plain_at_T": [na_p, nr_p, ok_p],
                    "equal": bool(torch.equal(st_k, st_p)
                                  and stats_k.tolist() == stats_p.tolist()),
                    "common_prefix_max_abs": float(d_st.max()), "first_parted_index": parted},
         attempt={"records": 16, **att, "ratio_tol": 1e-5, "h_next_tol": 1e-6},
         windows=windows, tol={"ys_scaled": 1e-6, "rel_l2": 1e-5}, max_abs_err=errs)

    # -- 12. the main path: FULL_STEPS training steps at full width (its first
    # step's kernels and outer pass timed with CUDA events around each call) ---
    step = parity.make_train_step(task, split2=True)
    masks = {k: v.bool() for k, v in task.grad_mask.items()}
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    want = {k: 0 for k in no.LAUNCHES}
    want.update(ode_select=1, ode_replay_fwd_split2=1, ode_replay_bwd_emit=1)
    for k in no.LAUNCHES:
        no.LAUNCHES[k] = 0
    history, step_s, log = [], [], []
    for i in range(FULL_STEPS):
        stims_i = stims if i == 0 else make_parity_batch(gen, n_in, B, device=dev)
        before = dict(no.LAUNCHES)
        prev = {k: p.detach().clone() for k, p in task.params.items()}
        restore = event_timed(fused, ("ode_select", "ode_replay_fwd_split2", "ode_replay_bwd_emit",
                                      "ode_outer_arg_grads"), log if i == 0 else [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            rec = step(stims_i)
            torch.cuda.synchronize()
        finally:
            restore()
        step_s.append(time.perf_counter() - t0)
        launched = {k: no.LAUNCHES[k] - before[k] for k in no.LAUNCHES}
        sk = rec["stats"]
        finite = {k: bool(torch.isfinite(p.grad).all()) for k, p in task.params.items()}
        history.append({"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                        "update_applied": bool(rec["ok"]), "grads_finite": finite,
                        "naccept": int(sk.naccept), "nreject": int(sk.nreject),
                        "success": bool(sk.success), "launches": launched,
                        "seconds": step_s[-1]})
        check(launched == want, f"split2 step {i}: launches {launched}")
        check(bool(sk.success) and bool(torch.isfinite(rec["loss"])),
              f"split2 step {i}: success {bool(sk.success)}, loss {rec['loss']}")
        # As in the JAX package, a step whose gradient is not finite (or, without
        # clipping, larger than 1e4) leaves the parameters as they were.
        for k, p in task.params.items():
            check(bool((p.grad[~masks[k]].nan_to_num(0.0, 0.0, 0.0) == 0).all()),
                  f"split2 step {i}: {k} gradient off its mask")
            check(rec["ok"] or torch.equal(p.detach(), prev[k]),
                  f"split2 step {i}: skipped update moved {k}")
        check(rec["ok"] == (all(finite.values()) and float(rec["gnorm"]) < 1e4),
              f"split2 step {i}: ok {rec['ok']}, finite {finite}, gnorm {float(rec['gnorm'])}")
    main_launches = dict(no.LAUNCHES)
    emit("split2_main_path", columns=sum(S2_CPA), lanes=B, T=S2_T, max_steps=M,
         history=history, launches=main_launches)

    # -- 13. card against CPU: one step over S2_GRAD_T grid points from the
    # first main-path step's weights, the CPU on the card's frozen grid; then
    # the CPU once more with every solver weight nudged by one part in 1e7.
    def grad_step(device, params, grid=None, time_steps=S2_GRAD_T, cpa=S2_CPA):
        t = make_task(time_steps, device=device, params=params, cpa=cpa)
        t0 = time.perf_counter()
        rec = parity.make_train_step(t, split2=True)(stims, grid=grid)
        return (rec, {k: p.grad.detach().cpu().clone() for k, p in t.params.items()},
                time.perf_counter() - t0)

    # The tier's gradient is bf16-grade: its state VJP rounds both
    # transposed products to bf16, so a flipped rounding moves it, and at 104
    # columns the stiff network amplifies that even over 5 ms (a 1e-7 change
    # of the weights moves the CPU's own gradient by ~0.1). So each gradient
    # is held within twice that spread, or 1e-3 where the spread is smaller;
    # also at 13 columns over 50 points (outer mode forced there: "auto"
    # takes kernel mode at that size).
    from columnflow_torch.solvers import fused

    def compare(res, cpa, T_c, loss_k, grad_k, naccept):
        (loss_c, grad_c, _), (_, grad_n, _) = res
        loss_rel = abs(loss_k - loss_c) / abs(loss_c)
        grad_rel = {k: rel_l2(grad_k[k], grad_c[k]) for k in grad_k}
        spread = {k: rel_l2(grad_n[k], grad_c[k]) for k in grad_k}
        entry = {"T": T_c, "naccept": naccept, "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                 "spread_under_1e-7_nudge": spread,
                 "tol": {"loss": ODE_LOSS_TOL, "grad": "max(1e-3, 2 x spread)"}}
        tol = {k: max(ODE_GRAD_TOL, 2.0 * spread[k]) for k in grad_k}
        check(loss_rel < ODE_LOSS_TOL and all(grad_rel[k] < tol[k] for k in grad_k),
              f"card vs CPU split2 step at {sum(cpa)} columns: {entry}")
        return entry

    for cpa, T_c in ((S2_CPA, S2_GRAD_T), ((8, 4, 1), 50)):
        small = cpa != S2_CPA
        saved = fused.OUTER_ARG_BYTES
        fused.OUTER_ARG_BYTES = 0 if small else saved
        try:
            src = make_task(T_c, cpa=cpa).params if small else params0
            p0 = {k: v.detach().cpu().clone() for k, v in src.items()}
            rec_k, grad_k, _ = grad_step(dev, p0, time_steps=T_c, cpa=cpa)
            grid_k = (rec_k["stats"].step_times.cpu(), int(rec_k["stats"].naccept))
        finally:
            fused.OUTER_ARG_BYTES = saved
        nudged = {k: v if k == "output_weights" else v * (1.0 + 1e-7) for k, v in p0.items()}
        cpu_later("split2_cpu_check", f"{sum(cpa)}_columns_{T_c}_points",
                  lambda res, a=(cpa, T_c, float(rec_k["loss"]), grad_k, grid_k[1]):
                  compare(res, *a),
                  "parity", cfg, dict(columns_per_area=cpa, n_inputs=4, time_steps=T_c,
                                      max_steps=S2_MAX_STEPS), dict(split2=True),
                  args=(stims,), kwargs=dict(grid=grid_k), params_list=[p0, nudged],
                  outer_arg_bytes=0 if small else None)
    # How the gradient grows with the horizon, on the card from the same
    # weights: the reverse sweep carries the cotangent back over every step.
    horizon = {}
    for T_h in (50, 200):
        rec_h, grad_h, _ = grad_step(dev, params0, time_steps=T_h)
        horizon[T_h] = {"naccept": int(rec_h["stats"].naccept), "grad_norm": float(rec_h["gnorm"]),
                        "grads_finite": all(bool(torch.isfinite(g).all()) for g in grad_h.values())}
    emit("split2_card_vs_cpu", columns=sum(S2_CPA), lanes=B, cpu_check="split2_cpu_check",
         grad_norm_by_horizon={**{f"{k}_points": v for k, v in horizon.items()},
                               f"{S2_T}_points": {"grad_norm": history[0]["grad_norm"],
                                                  "grads_finite": history[0]["grads_finite"]}})

    # -- 14. times: each kernel's CUDA events in the main path's first step
    # (the same grid: that step's batch and weights are this phase's); the
    # plain versions on a Wp-step window -------------------------------------
    main_ms = {}
    for name, start, end in log:
        main_ms[name] = main_ms.get(name, 0.0) + start.elapsed_time(end)
    Wp = S2_PLAIN_W
    cobw = torch.randn(Wp, 5, B, S, generator=gen, device=dev)
    stw, ysw = st[:Wp + 1].contiguous(), ys[:Wp].contiguous()
    calls = {  # (the Wp-step window, the plain version on it)
        "ode_select": (None, None),
        "ode_replay_fwd_split2": (
            lambda: no.ode_replay_fwd_split2(y0, stw, w2, sc, kv),
            lambda: no._ode_replay_fwd_plain(y0, stw, w2, sc, kv)),
        "ode_replay_bwd_emit": (
            lambda: no.ode_replay_bwd_emit(ysw, cobw, stw, w2, sc, kv),
            lambda: no._ode_replay_bwd_emit_plain(ysw, cobw, stw, w2, sc, kv)),
    }
    times, window_ms = {}, {}
    for name, (short, plain) in calls.items():  # warm from the main path
        times[name] = main_ms[name]
        if plain is not None:
            window_ms[name] = cuda_ms(short, reps=2, warmup=1)
            plain_ms[name] = cuda_ms(plain, reps=1, warmup=0)
    outer_ms = main_ms["ode_outer_arg_grads"]
    n, na, nr = history[0]["naccept"], history[0]["naccept"], history[0]["nreject"]
    serial = {"ode_select": na + nr, "ode_replay_fwd_split2": n, "ode_replay_bwd_emit": n}
    bounds = {name: split2_bound(name, P, B, n_in, K, serial[name], M=M) for name in calls}
    outer_bound = split2_bound("outer", P, B, n_in, K, n)
    # The cluster teams against team8: B6 over the S2_SEL_T points of phase
    # 11, B7 split2 on a ROUTE_W-step window in the middle of the full
    # replay, B8' on the Wp-step window.
    kr = max(0, min(ys.shape[0] - ROUTE_W, ys.shape[0] // 2))
    str_, yr = st[kr:kr + ROUTE_W + 1].contiguous(), ys[kr].contiguous()
    routes = {
        "ode_select": {"T": S2_SEL_T, **team_routes(
            lambda r: no.ode_select(y0, pw, sc, kv, cfg_s, route=r), na_k + nr_k,
            no.ode_team_route(P, n_in, B, 3, False))},
        "ode_replay_fwd_split2": {"steps": ROUTE_W, "start": kr, **team_routes(
            lambda r: no.ode_replay_fwd_split2(yr, str_, w2, sc, kv, route=r), ROUTE_W,
            no._replay_team(None, P, n_in, B, 2)[0])},
        "ode_replay_bwd_emit": {"steps": Wp, **team_routes(
            lambda r: no.ode_replay_bwd_emit(ysw, cobw, stw, w2, sc, kv, route=r), Wp,
            no.ode_team_route(P, n_in, 1, 2, True))}}
    emit("split2_kernel_times", lanes=B, T=S2_T, naccept=na, nreject=nr, ms=times,
         team_routes=routes,
         ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()},
         plain_ms=plain_ms, plain_window_steps=Wp, kernel_ms_on_plain_window=window_ms,
         outer_arg_grads={"ms": outer_ms, "ms_per_step": outer_ms / n,
                          "bound_ms": outer_bound[0], "bound_by": outer_bound[1]})
    step_ms = step_s[-1] * 1e3
    emit("split2_train_step", ms_per_step=step_ms, samples_per_s=B * 1e3 / step_ms,
         step_seconds=step_s)
    short_ms, wall, by_kernel = short_profile(
        parity.make_train_step(make_task(time_steps=S2_PROFILE_T), split2=True),
        (make_parity_batch(gen, n_in, B, device=dev),))
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("split2_step_profile", lanes=B, T=S2_PROFILE_T, profiled_wall_ms_per_step=wall,
         step_ms=short_ms, device_busy_ms_per_step=busy if busy else "not measured",
         idle_share=1.0 - busy / short_ms if busy else "not measured",
         device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    # -- 15. the command line trains the tier on the card ----------------------
    argv = ["--columns-per-area", "64,32,8", "--smoke", "--max-steps", "4096"]
    defer_command_line("split2_command_line", "parity", argv, timeout=900)

    replaces = {"ode_select": "columnflow/solvers/fused.py:238",
                "ode_replay_fwd_split2": "columnflow/solvers/fused.py:294",
                "ode_replay_bwd_emit": "columnflow/solvers/fused.py:327"}
    return [{"name": name, "route": "cuda", "source": ODE_TEAM_SOURCES.get(name, ODE_SOURCE),
             "replaces": replaces[name],
             "launches": main_launches[name], "max_abs_err": errs[name], "ms": times[name],
             "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None, "lanes": B,
             "path": f"deterministic fused-split2, {sum(S2_CPA)} columns",
             "ns_per_serial_step": times[name] * 1e6 / serial[name],
             **({"team_routes": routes[name]} if name in routes else {}),
             **({"plain_ms_at": f"{Wp} steps (ms_window: the kernel there)",
                 "ms_window": window_ms[name]} if name in window_ms else {})}
            for name in calls]

# The XOR task (columnflow/tasks/xor.py build_task defaults, the reference's
# scripts/xor_ode.py): 3 columns = 24 populations, state 72, the four
# conditions as one (4, 72) batch, 1000 grid points over 1 s, max_steps 3072
# (rounded to 3135); deterministic dopri5 at rtol 1e-7 / atol 1e-9, or SRA1 on
# the uniform grid (999 steps) with sigma = 10 on the membrane block.
XOR_T = 1000
XOR_MAX_STEPS = 3072
XOR_SOURCES = {"ode": "columnflow_torch/kernels/csrc/xor_ode.cu",
               "sde": "columnflow_torch/kernels/csrc/xor_sde.cu"}
XOR_P, XOR_S, XOR_B, XOR_K = 24, 72, 4, 4
XOR_LOSS_TOL, XOR_GRAD_TOL = 1e-5, 1e-3
XOR_WINDOW = 64     # steps of each kernel-vs-plain window of the dopri5 sweep (256 before PR 10)
XOR_SEL_T = 250     # grid points of the whole selection held against its plain loop (over
                    # the second it took 19.8 s; cut in depth for the time limit)
XOR_SDE_W = 250     # steps of the uniform-grid SDE and its sweep held against their plain
                    # versions (all 999 took 10.9 s of plain loop)


def xor_bound(kernel, work, M=0, tree="jax", n=0, n_real=0):
    """(bound_ms, bound_by) of an XOR kernel; ``work`` is what this run's
    data needed: the controller attempts (selection; of all lanes for the
    adaptive step's per-lane selection), the accepted steps (replay, sweep),
    the grid's steps (SDE) or the lanes' real half steps (the adaptive
    replay and sweep: lanes x half steps, of n_real per lane at most on a
    grid of n). A drift evaluation of the batch: the 24 x 24 recurrent
    product (2 P^2 per lane) and ~35 P elementwise operations per lane; a
    drift VJP: the transposed product, the rows' contraction over the lanes
    and ~40 P elementwise; an adaptive attempt of one lane: 5 drift
    evaluations, 3 SRA1 updates, the error norm and 44 normals of its tree
    (two tree walks of 21 and two interval normals). All float32-rate
    operations. Bytes: each input read once, each output written once (the
    adaptive sweeps read the grid, noise and states of n_real steps)."""
    B, P, N, S = XOR_B, XOR_P, XOR_B * XOR_S, XOR_S
    drift = B * (2 * P * P + 35 * P)
    vjp = B * (2 * P * P + 40 * P) + 4 * B * 48
    consts = 4 * (P * P + 2 * P + 48 + XOR_K * B * 32)
    if kernel == "xor_sde_select":
        normal = JAX_NORMAL_OPS if tree == "jax" else KRNG_NORMAL_OPS
        flops = work * (5 * drift / B + 3 * 16 * S + 5 * S + 44 * normal)
        nbytes = consts + 4 * N + 16 * B + 4 * B * (M + 1) + 12 * B
    elif kernel == "xor_sde_replay_fwd":  # per lane-half-step: 2 drifts and the SRA1 update
        flops = work * (2 * drift / B + 16 * S)
        nbytes = consts + 16 * n_real * B + 4 * N + 4 * (n + 1) * N
    elif kernel == "xor_sde_replay_bwd":  # a drift, 2 VJPs and the step's cotangent sums
        flops = work * ((drift + 2 * vjp) / B + 16 * S)
        nbytes = consts + 12 * n_real * B + 8 * (n_real + 1) * N + 4 * N + 4 * 48
    elif kernel == "xor_select":  # 6 drifts, the stage sums, the error norm
        flops = work * (6 * drift + (2 * 21 + 2 * 6 + 8) * N)
        nbytes = consts + 4 * N + 4 * (M + 1) + 12
    elif kernel == "xor_replay_fwd":  # 7 drifts, the stage sums, the five rows
        flops = work * (7 * drift + (2 * 21 + 2 * 6 + 20) * N)
        nbytes = consts + 4 * N + 4 * (work + 1) + 4 * work * N * 6
    elif kernel == "xor_replay_bwd":  # 6 drifts, 7 VJPs, the cotangent sums
        flops = work * (6 * drift + 7 * vjp + (2 * 21 + 2 * 21 + 40) * N)
        nbytes = consts + 4 * (work + 1) + 4 * work * N * 6 + 4 * N + 4 * 48
    elif kernel == "xor_sde_fwd":  # 2 drifts and the SRA1 combination
        flops = work * (2 * drift + 16 * N)
        nbytes = consts + 4 * work * (1 + 2 * B) + 4 * N + 4 * (work + 1) * N
    else:  # xor_sde_bwd: 1 drift, 2 VJPs and the step's cotangent sums
        flops = work * (drift + 2 * vjp + 16 * N)
        nbytes = consts + 4 * work * (1 + B) + 8 * (work + 1) * N + 4 * N + 4 * 48
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def xor_phases(dev, cfg):
    """Phases 16-19 for the XOR task's two train steps; returns their
    kernels' entries of the kernels line."""
    import torch

    from columnflow_torch.data import xor_conditions
    from columnflow_torch.kernels import column_step as cs
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.kernels import xor_ode as xo
    from columnflow_torch.kernels import xor_sde as xs
    from columnflow_torch.models.xor import split_xor_params
    from columnflow_torch.solvers.fused import round_max_steps, uniform_step_times
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import xor as xt

    counters = {"xor_ode": xo.LAUNCHES, "xor_sde": xs.LAUNCHES, "network_ode": no.LAUNCHES,
                "network_sde": ns.LAUNCHES, "column_step": cs.LAUNCHES}

    def make_task(device=dev, params=None):
        task = xt.build_task(cfg, torch.Generator(device=device).manual_seed(0), time_steps=XOR_T,
                             max_steps=XOR_MAX_STEPS, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def max_abs(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def rows_err(got, want):
        return max(max_abs(got[k], want[k]) for k in got)

    def equal(got, want):
        if isinstance(got, dict):
            return all(torch.equal(got[k], want[k]) for k in got)
        return torch.equal(got, want)

    # -- 16. kernels vs plain versions at full width --------------------------
    gen = torch.Generator(device=dev).manual_seed(3)
    task = make_task()
    conds = torch.as_tensor(xor_conditions(), device=dev)
    sc, kv = xt.drift_inputs(task, conds)
    # Copies: the main path below trains task.params in place.
    pf = {k: v.detach().clone() for k, v in split_xor_params(task.params).items()}
    B, S = XOR_B, XOR_S
    M = round_max_steps((B, S), XOR_MAX_STEPS)
    scfg = xo.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]), max_steps=M)
    y0 = torch.zeros(B, S, device=dev)
    plain_ms = {}
    st, stats = xo.xor_select(y0, pf, sc, kv, scfg)  # the second: the replay's grid below
    na, nr, ok = (int(x) for x in stats)
    check(ok == 1 and M == 3135, f"xor_select: stats {stats.tolist()}, max_steps {M}")
    # The whole selection over the first XOR_SEL_T points, kernel and plain loop.
    # The error norm's float64 sum runs in thread order in the kernel and in
    # PyTorch's order in the plain version: at rtol 1e-7 one float32 ulp of
    # a norm can move the grid, so the selection is held bit for bit only up
    # to where the grids part, and by its counts.
    scfg_s = xo.ODESelectConfig(float(task.ts[0]), float(task.ts[XOR_SEL_T - 1]), max_steps=M)
    st_s, stats_s = xo.xor_select(y0, pf, sc, kv, scfg_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, stats_p = xo._xor_select_plain(y0, pf, sc, kv, scfg_s)
    torch.cuda.synchronize()
    plain_ms["xor_select"] = (time.perf_counter() - t0) * 1e3
    na_s, na_p = int(stats_s[0]), int(stats_p[0])
    sel_equal = stats_s.tolist() == stats_p.tolist() and equal(st_s, st_p)
    d_st = (st_s[:min(na_s, na_p) + 1] - st_p[:min(na_s, na_p) + 1]).abs()
    parted = int(torch.nonzero(d_st).min()) if bool((d_st > 0).any()) else None
    check(int(stats_s[2]) == 1 and int(stats_p[2]) == 1 and abs(na_s - na_p) <= 0.01 * na_p + 1
          and equal(st_s[:11], st_p[:11]),
          f"xor_select over {XOR_SEL_T} points: stats {stats_s.tolist()} vs plain "
          f"{stats_p.tolist()}, first parted index {parted}")
    stn = st[:na + 1].contiguous()
    ys, co = xo.xor_replay_fwd(y0, stn, pf, sc, kv)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(co).all()), "xor_replay_fwd over the whole grid is not finite")
    errs = {"xor_select": float(d_st.max()), "xor_replay_fwd": 0.0}
    W = XOR_WINDOW
    starts = (0, na // 2, na - W)
    # The replay and the sweep against their plain versions on windows early,
    # in the middle and late in the card's grid, each from the kernel's state
    # there.
    for k0 in starts:
        t0 = time.perf_counter()
        ys_p, co_p = xo._xor_replay_fwd_plain(ys[k0].contiguous(), stn[k0:k0 + W + 1].contiguous(),
                                              pf, sc, kv)
        torch.cuda.synchronize()
        plain_ms.setdefault("xor_replay_fwd", (time.perf_counter() - t0) * 1e3)
        sw = slice(k0, k0 + W)
        check(equal(ys[sw], ys_p) and equal(co[sw], co_p),
              f"xor_replay_fwd window at {k0}: ys {max_abs(ys[sw], ys_p)}")
        errs["xor_replay_fwd"] = max(errs["xor_replay_fwd"], max_abs(ys[sw], ys_p),
                                     max_abs(co[sw], co_p))

    att = {"equal": True, "accepted": 0}
    for r in range(16):
        k = int(r / 16 * (na - 1))
        t, y = st[k].clone(), ys[k].contiguous()
        h = ((st[k + 1] - st[k]) * (1.0, 1.5, 2.5)[r % 3]).clone()
        f0 = xo.xor_ode_drift(t, y, pf, sc, kv).contiguous()
        a = xo.xor_attempt(t, y, f0, h, pf, sc, kv, scfg)
        a_p = xo._xor_attempt_plain(t, y, f0, h, pf, sc, kv, scfg)
        att["equal"] &= all(equal(g, w) for g, w in zip(a, a_p))
        att["accepted"] += int(a.ratio <= 1.0)
    check(att["equal"], f"xor_attempt: {att}")

    cobar = torch.randn(co.shape, generator=gen, device=dev)
    ybar, rows = xo.xor_replay_bwd(ys, cobar, stn, pf, sc, kv)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(ybar).all()) and all(bool(torch.isfinite(v).all())
                                                   for v in rows.values()),
          "xor_replay_bwd over the whole grid is not finite")
    windows, errs["xor_replay_bwd"] = [], 0.0
    for k0 in starts:
        sw = slice(k0, k0 + W)
        stw = stn[k0:k0 + W + 1].contiguous()
        yb, rw = xo.xor_replay_bwd(ys[sw].contiguous(), cobar[sw].contiguous(), stw, pf, sc, kv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yb_p, rw_p = xo._xor_replay_bwd_plain(ys[sw], cobar[sw], stw, pf, sc, kv)
        torch.cuda.synchronize()
        plain_ms.setdefault("xor_replay_bwd_window", (time.perf_counter() - t0) * 1e3)
        same = equal(yb, yb_p) and equal(rw, rw_p)
        check(same, f"xor_replay_bwd window at {k0}: ybar {rel_l2(yb, yb_p)}")
        errs["xor_replay_bwd"] = max(errs["xor_replay_bwd"], max_abs(yb, yb_p), rows_err(rw, rw_p))
        windows.append({"start": k0, "bit_for_bit": same})

    t0s, h = uniform_step_times(task.ts, (B, S))
    _, i1, i10, _, _ = brownian_pack(gen, task.ts, (B,))
    i1, i10 = i1.contiguous(), i10.contiguous()
    yss = xs.xor_sde_fwd(y0, t0s, h, i1, i10, pf, sc, kv)
    ysbar = torch.randn(yss.shape, generator=gen, device=dev)
    ybs, rws = xs.xor_sde_bwd(yss, ysbar, t0s, h, i10, pf, sc, kv)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(yss).all()) and bool(torch.isfinite(ybs).all()),
          "xor_sde over the whole grid is not finite")
    # Both against their plain versions over the first XOR_SDE_W steps.
    Ws = XOR_SDE_W
    t0 = time.perf_counter()
    yss_p = xs._xor_sde_fwd_plain(y0, t0s[:Ws], h, i1[:Ws], i10[:Ws], pf, sc, kv)
    torch.cuda.synchronize()
    plain_ms["xor_sde_fwd"] = (time.perf_counter() - t0) * 1e3
    check(equal(yss[:Ws + 1], yss_p), f"xor_sde_fwd: {max_abs(yss[:Ws + 1], yss_p)}")
    ybs, rws = xs.xor_sde_bwd(yss[:Ws + 1], ysbar[:Ws + 1], t0s[:Ws], h, i10[:Ws], pf, sc, kv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ybs_p, rws_p = xs._xor_sde_bwd_plain(yss[:Ws + 1], ysbar[:Ws + 1], t0s[:Ws], h, i10[:Ws],
                                         pf, sc, kv)
    torch.cuda.synchronize()
    plain_ms["xor_sde_bwd"] = (time.perf_counter() - t0) * 1e3
    check(equal(ybs, ybs_p) and equal(rws, rws_p), f"xor_sde_bwd: ybar {rel_l2(ybs, ybs_p)}")
    errs["xor_sde_fwd"] = max_abs(yss[:Ws + 1], yss_p)
    errs["xor_sde_bwd"] = max(max_abs(ybs, ybs_p), rows_err(rws, rws_p))
    emit("xor_kernel_vs_plain", P=XOR_P, lanes=B, T=XOR_T, max_steps=M,
         selection={"stats": [na, nr, ok], "held_against_plain_over_points": XOR_SEL_T,
                    "stats_there": stats_s.tolist(), "stats_plain": stats_p.tolist(),
                    "bit_for_bit": sel_equal, "first_parted_index": parted},
         attempt={"records": 16, **att}, sweep_windows=windows, window_steps=W,
         sde_steps=XOR_T - 1, sde_steps_held_against_plain=XOR_SDE_W, tol="bit for bit",
         max_abs_err=errs)

    # -- 17. the main path: 3 deterministic and 3 stochastic train steps ------
    # As in the JAX package, the XOR step applies its update whatever the
    # gradient holds. After training, SRA1 at h = 1 ms can leave the stable
    # region once the stimulus is on (the state runs off to |v - a| ~ 1e4-1e6
    # in both packages), and the pathwise gradient then reaches float32's
    # limit. A step whose gradient is not finite is repeated on the CPU with
    # the plain versions, whose gradient must be beyond 1e30 or not finite
    # too (at the edge of float32's range the two round apart).
    history, step_s, first = {False: [], True: []}, {False: [], True: []}, {}
    masks = {k: v.bool().expand_as(task.params[k]) for k, v in task.grad_mask.items()}
    main_launches, nonfinite = {}, []

    def cpu_step(params, conds_i, noise, grid, stochastic):
        t = make_task(device="cpu", params=params)
        t0 = time.perf_counter()
        rec = xt.make_train_step(t, stochastic=stochastic)(
            conds_i.cpu(), noise=None if noise is None else tuple(x.cpu() for x in noise),
            grid=grid)
        return (float(rec["loss"]), {k: p.grad.detach().clone() for k, p in t.params.items()},
                time.perf_counter() - t0)

    for stochastic in (False, True):
        step = xt.make_train_step(task, stochastic=stochastic)
        for c in counters.values():
            for k in c:
                c[k] = 0
        for i in range(3):
            conds_i = conds[torch.randperm(4, generator=gen, device=dev)]
            noise = None
            if stochastic:
                _, n1, n10, _, _ = brownian_pack(gen, task.ts, (B, 1))
                noise = (n1, n10)
            params_i = {k: p.detach().cpu().clone() for k, p in task.params.items()}
            before = {m: dict(c) for m, c in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = step(conds_i, noise=noise)
            torch.cuda.synchronize()
            step_s[stochastic].append(time.perf_counter() - t0)
            launched = {k: c[k] - before[m][k] for m, c in counters.items() for k in c
                        if c[k] != before[m][k]}
            want = ({"xor_sde_fwd": 1, "xor_sde_bwd": 1} if stochastic
                    else {"xor_select": 1, "xor_replay_fwd": 1, "xor_replay_bwd": 1})
            check(launched == want, f"xor step {i} (stochastic {stochastic}): launches {launched}")
            check(bool(torch.isfinite(rec["loss"])), f"xor step {i}: loss {rec['loss']}")
            grid = None
            if not stochastic:
                sk = rec["stats"]
                check(bool(sk.success), f"xor step {i}: the selection did not reach 1 s")
                grid = (sk.step_times.cpu(), int(sk.naccept))
            finite = all(bool(torch.isfinite(p.grad).all()) for p in task.params.values())
            entry = {"loss": float(rec["loss"]), "seconds": step_s[stochastic][-1],
                     "grad_finite": finite}
            if grid is not None:
                entry.update(naccept=grid[1], nreject=int(rec["stats"].nreject))
            if finite:
                for k, p in task.params.items():
                    check(bool((p.grad[~masks[k]] == 0).all()), f"xor step {i}: {k} off its mask")
            else:
                _, grads_c, _ = cpu_step(params_i, conds_i, noise, grid, stochastic)
                cpu_max = max(float(g.abs().max()) for g in grads_c.values())
                nonfinite.append({"stochastic": stochastic, "step": i, "cpu_grad_max_abs": cpu_max})
                check(not cpu_max < 1e30, f"xor step {i}: the kernels' gradient is not finite, "
                                          f"the plain versions' is at most {cpu_max}")
            history[stochastic].append(entry)
            if i == 0:
                first[stochastic] = dict(conds=conds_i, noise=noise, grid=grid, params=params_i,
                                         loss=float(rec["loss"]),
                                         grads={k: p.grad.detach().cpu().clone()
                                                for k, p in task.params.items()})
        main_launches.update({k: v for m in ("xor_ode", "xor_sde")
                              for k, v in counters[m].items() if v})
        if not stochastic:  # the training run's evaluation, after the deterministic steps
            final_c, test_loss = xt.evaluate(task, conds)
            check(bool(torch.isfinite(final_c).all()), "xor evaluation not finite")

    # -- 18. the card against the CPU on the card's grid and noise ------------
    # Each engine's first step of the main path, and the stochastic step from
    # the seed weights. After training, the stochastic loss is ill-conditioned
    # (float32 against float64 rounding moves it by up to 1e-3 on the CPU), so
    # the trained step is held within twice the card's own spread under a 1e-7
    # nudge of the weights, beside the stated tolerances.
    def card_step(params, f, stochastic):
        t = make_task(params=params)
        grid = None if f["grid"] is None else (f["grid"][0].to(dev), f["grid"][1])
        rec = xt.make_train_step(t, stochastic=stochastic)(f["conds"], noise=f["noise"], grid=grid)
        return float(rec["loss"]), {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}

    seed_params = {k: p.detach().cpu().clone() for k, p in make_task().params.items()}
    cases = {"deterministic": (False, first[False]), "stochastic": (True, first[True]),
             "stochastic_from_seed_weights": (True, dict(first[True], params=seed_params))}

    def compare(res, name, f, loss_n, grads_n):
        loss_c, grads_c, _ = res[0]
        rec = {"loss_rel": abs(f["loss"] - loss_c) / abs(loss_c),
               "grad_rel_l2": {k: rel_l2(f["grads"][k], grads_c[k]) for k in grads_c},
               "card_loss_spread_under_1e-7_nudge": abs(loss_n - f["loss"]) / abs(f["loss"]),
               "card_grad_spread_under_1e-7_nudge": {k: rel_l2(grads_n[k], f["grads"][k])
                                                     for k in grads_c}}
        loss_tol, grad_tol = XOR_LOSS_TOL, XOR_GRAD_TOL
        if name == "stochastic":
            loss_tol += 2 * rec["card_loss_spread_under_1e-7_nudge"]
            grad_tol += 2 * max(rec["card_grad_spread_under_1e-7_nudge"].values())
        rec["tol"] = {"loss": loss_tol, "grad": grad_tol}
        finite = all(bool(torch.isfinite(g).all()) for g in grads_c.values())
        check(rec["loss_rel"] < loss_tol and (not finite or max(rec["grad_rel_l2"].values())
                                              < grad_tol),
              f"card vs CPU XOR step ({name}): {rec}")
        return rec

    for name, (stochastic, f) in cases.items():
        if name == "stochastic_from_seed_weights":
            f["loss"], f["grads"] = card_step(f["params"], f, stochastic)
        loss_n, grads_n = card_step({k: v * (1.0 + 1e-7) for k, v in f["params"].items()}, f,
                                    stochastic)
        cpu_later("xor_cpu_check", name,
                  lambda res, a=(name, dict(f), loss_n, grads_n): compare(res, *a),
                  "xor", cfg, dict(time_steps=XOR_T, max_steps=XOR_MAX_STEPS),
                  dict(stochastic=stochastic), args=(f["conds"],),
                  kwargs=dict(noise=f["noise"], grid=f["grid"]), params_list=[f["params"]])
    emit("xor_main_path", lanes=B, T=XOR_T, max_steps=M, history={
        "deterministic": history[False], "stochastic": history[True]},
        nonfinite_gradient_steps=nonfinite, launches=main_launches,
        eval={"final_fr_C": final_c.tolist(), "loss": float(test_loss)},
        cpu_check="xor_cpu_check")

    # -- 19. times -------------------------------------------------------------
    calls = {
        "xor_select": lambda: xo.xor_select(y0, pf, sc, kv, scfg),
        "xor_replay_fwd": lambda: xo.xor_replay_fwd(y0, stn, pf, sc, kv),
        "xor_replay_bwd": lambda: xo.xor_replay_bwd(ys, cobar, stn, pf, sc, kv),
        "xor_sde_fwd": lambda: xs.xor_sde_fwd(y0, t0s, h, i1, i10, pf, sc, kv),
        "xor_sde_bwd": lambda: xs.xor_sde_bwd(yss, ysbar, t0s, h, i10, pf, sc, kv),
    }
    times = {name: cuda_ms(fn, reps=5, warmup=1, device_time=True) for name, fn in calls.items()}
    swin = slice(0, W)
    window_ms = {
        "xor_replay_fwd": cuda_ms(lambda: xo.xor_replay_fwd(y0, stn[:W + 1].contiguous(), pf,
                                                            sc, kv),
                                  reps=5, warmup=1, device_time=True),
        "xor_replay_bwd": cuda_ms(lambda: xo.xor_replay_bwd(ys[swin].contiguous(),
                                                            cobar[swin].contiguous(),
                                                            stn[:W + 1].contiguous(), pf, sc, kv),
                                  reps=5, warmup=1, device_time=True)}
    serial = {"xor_select": na + nr, "xor_replay_fwd": na, "xor_replay_bwd": na,
              "xor_sde_fwd": XOR_T - 1, "xor_sde_bwd": XOR_T - 1}
    bounds = {name: xor_bound(name, serial[name], M=M) for name in calls}
    plain_ms["xor_replay_bwd"] = plain_ms.pop("xor_replay_bwd_window")
    emit("xor_kernel_times", lanes=B, T=XOR_T, naccept=na, nreject=nr, ms=times,
         plain_ms=plain_ms, plain_ms_at={k: f"{W} steps (kernel there: {v} ms)"
                                         for k, v in window_ms.items()},
         ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()})
    step_ms = {}
    task = make_task()  # from the seed weights again
    for stochastic in (False, True):
        step = xt.make_train_step(task, stochastic=stochastic)
        noises = [None] * 5
        if stochastic:
            noises = [brownian_pack(gen, task.ts, (B, 1))[1:3] for _ in range(5)]
        step(conds, noise=noises[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(5):
            step(conds, noise=noises[i])
        torch.cuda.synchronize()
        key = "stochastic" if stochastic else "deterministic"
        step_ms[key] = (time.perf_counter() - t0) * 1e3 / 5
        wall, by_kernel = device_profile(lambda i: step(conds, noise=noises[i]), 3)
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        emit("xor_step_profile", engine=key, lanes=B, step_ms=step_ms[key],
             samples_per_s=B * 1e3 / step_ms[key], profiled_wall_ms_per_step=wall,
             device_busy_ms_per_step=busy if busy else "not measured",
             idle_share=1.0 - busy / step_ms[key] if busy else "not measured",
             device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    replaces = {"xor_select": "columnflow/solvers/fused.py:238",
                "xor_replay_fwd": "columnflow/solvers/fused.py:294",
                "xor_replay_bwd": "columnflow/solvers/fused.py:327",
                "xor_sde_fwd": "columnflow/solvers/fused.py:845",
                "xor_sde_bwd": "columnflow/solvers/fused.py:920"}
    path = {"xor_select": "XOR deterministic", "xor_replay_fwd": "XOR deterministic",
            "xor_replay_bwd": "XOR deterministic", "xor_sde_fwd": "XOR stochastic (fixed grid)",
            "xor_sde_bwd": "XOR stochastic (fixed grid)"}
    return [{"name": name, "route": "cuda",
             "source": XOR_SOURCES["sde" if "sde" in name else "ode"],
             "replaces": replaces[name], "launches": main_launches[name],
             "max_abs_err": errs[name], "ms": times[name], "plain_ms": plain_ms[name],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
             "lanes": B, "path": path[name],
             "ns_per_serial_step": times[name] * 1e6 / serial[name],
             **({"plain_ms_at": f"{W} steps (ms_window: the kernel there)",
                 "ms_window": window_ms[name]} if name in window_ms else {}),
             **({"plain_ms_at": f"the whole selection over {XOR_SEL_T} points"}
                if name == "xor_select" else {}),
             **({"plain_ms_at": f"the first {XOR_SDE_W} steps"} if "sde" in name else {})}
            for name in calls]


# The XOR stochastic-adaptive step (columnflow/tasks/xor.py:69-75, 110-172):
# the four conditions as 4 lanes of state 72, 1000 grid points over 1 s, each
# lane's step-doubling SRA1 (PI controller, rtol = atol = 1e-3, max_steps
# 2048, tree depth 20) on the jax.random tree (the XLA selection as a kernel)
# or, with --fused-pass, the krng tree (B5x); then the lanes' replay (B3xl)
# and its kernel-mode sweep (B4'xl) over at most 4096 half steps. Nothing cut.
XA_MAX_STEPS = 2048
XA_TREES = {"jax": False, "kernel": True}  # tree -> fused_pass
XA_SEL_T = 12       # grid points of the whole selections held against their plain loop
                    # (over 25 they took 14 s on a slow host)
XA_CPU_T = 100      # grid points of the card-vs-CPU steps (the stimulus comes on at 50)
XA_W = 64           # half steps of each kernel-vs-plain window of the replay and its sweep
XA_TOL = 1e-4       # card against CPU: the floor of each limit (loss and gradients)


def xor_adaptive_phases(dev, cfg):
    """Phases 42-46 for the XOR task's stochastic-adaptive step (the
    jax.random tree's selection, and --fused --fused-pass's krng tree);
    returns their kernels' entries of the kernels line."""
    import torch

    from columnflow_torch.data import xor_conditions
    from columnflow_torch.kernels import column_step as cs
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.kernels import xor_ode as xo
    from columnflow_torch.kernels import xor_sde as xs
    from columnflow_torch.models.xor import split_xor_params
    from columnflow_torch.solvers.fused import sweep_chunk
    from columnflow_torch.solvers.sde_adaptive import _replay_grid, _sde_key_words, select_config
    from columnflow_torch.tasks import xor as xt

    counters = {"xor_ode": xo.LAUNCHES, "xor_sde": xs.LAUNCHES, "network_ode": no.LAUNCHES,
                "network_sde": ns.LAUNCHES, "column_step": cs.LAUNCHES}

    def make_task(device=dev, params=None):
        task = xt.build_task(cfg, torch.Generator(device=device).manual_seed(0), time_steps=XOR_T,
                             max_steps=XOR_MAX_STEPS, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    same, errs, plain_ms, plain_at = {}, {}, {}, {}

    def tensors(x):
        """The tensors of a kernel's output (a tensor, tuple or dict), in order."""
        if isinstance(x, dict):
            x = tuple(x.values())
        return [t for v in x for t in tensors(v)] if isinstance(x, tuple) else [x]

    def compare(name, got, want):
        pairs = list(zip(tensors(got), tensors(want)))
        ok = all(torch.equal(g, w) for g, w in pairs)
        same[name] = same.get(name, True) and ok
        errs[name] = max(errs.get(name, 0.0),
                         max(float((g.float() - w.float()).abs().max()) for g, w in pairs))
        check(ok, f"{name} against its plain version: max abs {errs[name]}")

    # -- 42. kernels vs plain versions at full width ----------------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    task = make_task()
    conds = torch.as_tensor(xor_conditions(), device=dev)
    sc, kv = xt.drift_inputs(task, conds)
    pf = {k: v.detach().clone() for k, v in split_xor_params(task.params).items()}
    B, S = XOR_B, XOR_S
    y0 = torch.zeros(B, S, device=dev)
    keys = torch.randint(0, 2**32, (B, 2), generator=gen, device=dev, dtype=torch.int64)
    grids, records = {}, {}
    for tree in XA_TREES:
        name = f"xor_sde_select_{tree}"
        words = _sde_key_words(keys, tree).to(dev)
        cfg_s = select_config(task.ts[:XA_SEL_T], max_steps=XA_MAX_STEPS, brownian=tree,
                              drift="f32")
        got = xs.xor_sde_select(y0, words, pf, sc, kv, cfg_s)
        want, plain_ms[name] = timed(lambda: xs._xor_select_plain(y0, words, pf, sc, kv, cfg_s))
        plain_at[name] = f"the whole selection over {XA_SEL_T} points"
        compare(name, got, want)
        check(bool(got[3].all()), f"{name}: a lane did not reach {XA_SEL_T} points")
        records[tree] = {"stats_short": [got[1].tolist(), got[2].tolist()]}
        cfg_f = select_config(task.ts, max_steps=XA_MAX_STEPS, brownian=tree, drift="f32")
        st, na, nr, ok = xs.xor_sde_select(y0, words, pf, sc, kv, cfg_f)
        ht, dw, i10 = _replay_grid(st, words, cfg_f.t_start, cfg_f.t_end, 20, tree)
        t0s, hs = ht[:, :-1].T.contiguous(), (ht[:, 1:] - ht[:, :-1]).T.contiguous()
        i1, i10 = dw.T.contiguous(), i10.T.contiguous()
        n_real = 2 * int(na.max())
        grids[tree] = dict(words=words, cfg=cfg_f, st=st, na=na, nr=nr, ok=ok, t0s=t0s, hs=hs,
                           i1=i1, i10=i10, n_real=n_real)
        # Single attempts along the replay of the full grid, one record per lane.
        ys = xs.xor_sde_replay_fwd(y0, t0s, hs, i1, i10, n_real, pf, sc, kv)
        tree_w = ns.lane_noise(words, cfg_f.t_start, cfg_f.t_end, 20, tree)[0]
        for k, stretch in ((0, 1.0), (n_real // 5, 2.5), (n_real // 2, 1.5), (n_real - 4, 4.0)):
            t1 = t0s[k][:, None].contiguous()
            h = (hs[k][:, None] * stretch + 1e-6).contiguous()
            args = (t1, ys[k].contiguous(), h, torch.full_like(t1, 0.7),
                    tree_w.evaluate(t1).contiguous(), words, pf, sc, kv, cfg_f)
            compare("xor_sde_attempt", xs.xor_sde_attempt(*args), xs._xor_attempt_plain(*args))
    # The replay and its sweep on the jax.random tree's grid: the whole grid by
    # the kernels, and windows early, in the middle and late against the plain
    # versions from the kernel's state there.
    g = grids["jax"]
    n, n_real = g["t0s"].shape[0], g["n_real"]
    chunk = sweep_chunk((B, S), n)
    ys = xs.xor_sde_replay_fwd(y0, g["t0s"], g["hs"], g["i1"], g["i10"], n_real, pf, sc, kv)
    ysbar = torch.randn(ys.shape, generator=gen, device=dev)
    ybar, rows = xs.xor_sde_replay_bwd(ys, ysbar, g["t0s"], g["hs"], g["i10"], n_real, chunk, pf,
                                       sc, kv)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(ys).all()) and bool(torch.isfinite(ybar).all())
          and torch.equal(ys[n_real + 1:], ys[n_real].expand_as(ys[n_real + 1:])),
          "the XOR lanes' replay over the whole grid is not finite or does not carry its state")
    windows = []
    for k0 in (0, n_real // 2, n_real - XA_W):
        w = slice(k0, k0 + XA_W)
        wg = tuple(x[w].contiguous() for x in (g["t0s"], g["hs"], g["i1"], g["i10"]))
        fwd = (ys[k0].contiguous(), *wg, XA_W, pf, sc, kv)
        got = xs.xor_sde_replay_fwd(*fwd)
        want, ms = timed(lambda: xs._xor_replay_fwd_plain(*fwd))
        plain_ms.setdefault("xor_sde_replay_fwd", ms)
        compare("xor_sde_replay_fwd", got, want)
        check(torch.equal(got, ys[k0:k0 + XA_W + 1]), "B3xl window against its whole sweep")
        wys = slice(k0, k0 + XA_W + 1)
        bwd = (ys[wys].contiguous(), ysbar[wys].contiguous(), wg[0], wg[1], wg[3], XA_W, chunk,
               pf, sc, kv)
        got = xs.xor_sde_replay_bwd(*bwd)
        want, ms = timed(lambda: xs._xor_replay_bwd_plain(*bwd))
        plain_ms.setdefault("xor_sde_replay_bwd", ms)
        compare("xor_sde_replay_bwd", got, want)
        windows.append(k0)
    plain_at["xor_sde_replay_fwd"] = plain_at["xor_sde_replay_bwd"] = f"{XA_W} half steps"
    emit("xor_adaptive_kernel_vs_plain", lanes=B, T=XOR_T, max_steps=XA_MAX_STEPS,
         whole_selection_points=XA_SEL_T, selections=records,
         full_grids={t: {"naccept": v["na"].tolist(), "nreject": v["nr"].tolist(),
                         "success": v["ok"].tolist(), "n_real": v["n_real"]}
                     for t, v in grids.items()},
         attempt_records=4 * B * len(XA_TREES), windows=windows, window_half_steps=XA_W,
         chunk=chunk, bit_for_bit=same, max_abs_err=errs)

    # -- 43. the main path: 3 steps of each tree's step at full width ---------
    history, launches, first, step_s = {}, {}, {}, {}
    for tree, fused_pass in XA_TREES.items():
        task = make_task()
        step = xt.make_train_step(task, stochastic=True, adaptive=True, fused_pass=fused_pass)
        for c in counters.values():
            for k in c:
                c[k] = 0
        history[tree] = []
        for i in range(3):
            conds_i = conds[torch.randperm(4, generator=gen, device=dev)]
            keys_i = torch.randint(0, 2**32, (B, 2), generator=gen, device=dev, dtype=torch.int64)
            params_i = {k: p.detach().cpu().clone() for k, p in task.params.items()}
            before = {m: dict(c) for m, c in counters.items()}
            rec, ms = timed(lambda: step(conds_i, keys=keys_i))
            launched = {k: c[k] - before[m][k] for m, c in counters.items() for k in c
                        if c[k] != before[m][k]}
            want = {"xor_sde_select": 1, "xor_sde_replay_fwd": 1, "xor_sde_replay_bwd": 1}
            check(launched == want, f"XOR adaptive step {i} ({tree} tree): launches {launched}")
            check(bool(torch.isfinite(rec["loss"])), f"XOR adaptive step {i}: loss {rec['loss']}")
            st = rec["stats"]
            reached = torch.gather(st.step_times, 1, st.naccept.long()[:, None])[:, 0]
            finite = all(bool(torch.isfinite(p.grad).all()) for p in task.params.values())
            history[tree].append({"loss": float(rec["loss"]), "ms": ms, "grad_finite": finite,
                                  "naccept": st.naccept.tolist(), "nreject": st.nreject.tolist(),
                                  "success": st.success.tolist(),
                                  "reached_s": reached.tolist()})
            if i == 0:
                first[tree] = dict(conds=conds_i, keys=keys_i, params=params_i)
        launches[tree] = {k: v for m in ("xor_sde",) for k, v in counters[m].items() if v}

    # -- 44. the card against the CPU on the card's grid ------------------------
    # Over XA_CPU_T points: at the full width the budget ends each lane near
    # 0.29 s, before the stimulus, and the plain replay of ~3500 half steps
    # takes ~12 s on the CPU; over 100 points the stimulus is on from point
    # 50 and every lane reaches the end.
    def one_step(device, params, f, fused_pass, grid=None):
        t = xt.build_task(cfg, torch.Generator(device=device).manual_seed(0), time_steps=XA_CPU_T,
                          max_steps=XOR_MAX_STEPS, device=device)
        with torch.no_grad():
            for k, p in t.params.items():
                p.copy_(params[k])
        grid = None if grid is None else tuple(x.to(device) for x in grid)
        rec = xt.make_train_step(t, stochastic=True, adaptive=True, fused_pass=fused_pass)(
            f["conds"].to(device), grid=grid, keys=f["keys"].to(device))
        st = rec["stats"]
        return (float(rec["loss"]), {k: p.grad.detach().cpu().clone() for k, p in t.params.items()},
                tuple(x.detach().clone() for x in (st.step_times, st.naccept, st.nreject)),
                bool(st.success.all()))

    def compare(res, tree, loss_k, grads_k, naccept, ok_k, loss_n, grads_n):
        loss_c, grads_c, _ = res[0]
        spread_l = abs(loss_n - loss_k) / abs(loss_k)
        spread_g = {k: rel_l2(grads_n[k], grads_k[k]) for k in grads_c}
        lim_l = min(max(XA_TOL, 10 * spread_l), GRAD_TOL_CAP)
        lim_g = {k: min(max(XA_TOL, 10 * v), GRAD_TOL_CAP) for k, v in spread_g.items()}
        rec = {"T": XA_CPU_T, "success": ok_k, "naccept": naccept,
               "loss_rel": abs(loss_k - loss_c) / abs(loss_c),
               "grad_rel_l2": {k: rel_l2(grads_k[k], grads_c[k]) for k in grads_c},
               "card_loss_spread_under_1e-7_nudge": spread_l,
               "card_grad_spread_under_1e-7_nudge": spread_g,
               "limits": {"loss": lim_l, "grad": lim_g}}
        check(ok_k and rec["loss_rel"] < lim_l
              and all(rec["grad_rel_l2"][k] < lim_g[k] for k in lim_g)
              and all(float(g.abs().sum()) > 0 for g in grads_k.values()),
              f"card vs CPU XOR adaptive step ({tree} tree, {XA_CPU_T} points): {rec}")
        return rec

    for tree, fused_pass in XA_TREES.items():
        f = first[tree]
        loss_k, grads_k, grid_k, ok_k = one_step(dev, f["params"], f, fused_pass)
        loss_n, grads_n, _, _ = one_step(dev, {k: v * (1.0 + 1e-7) for k, v in f["params"].items()},
                                         f, fused_pass, grid_k)
        cpu_later("xor_adaptive_cpu_check", tree,
                  lambda res, a=(tree, loss_k, grads_k, grid_k[1].tolist(), ok_k, loss_n,
                                 grads_n): compare(res, *a),
                  "xor", cfg, dict(time_steps=XA_CPU_T, max_steps=XOR_MAX_STEPS),
                  dict(stochastic=True, adaptive=True, fused_pass=fused_pass),
                  args=(f["conds"],), kwargs=dict(grid=grid_k, keys=f["keys"]),
                  params_list=[f["params"]])
    emit("xor_adaptive_main_path", lanes=B, T=XOR_T, max_steps=XA_MAX_STEPS, history=history,
         launches=launches, cpu_check="xor_adaptive_cpu_check")

    # -- 45. times -------------------------------------------------------------
    pf = {k: v.detach().clone() for k, v in split_xor_params(make_task().params).items()}
    times, serial, bounds = {}, {}, {}
    for tree in XA_TREES:
        g, name = grids[tree], f"xor_sde_select_{tree}"
        times[name] = cuda_ms(lambda: xs.xor_sde_select(y0, g["words"], pf, sc, kv, g["cfg"]),
                              reps=3, warmup=1, device_time=True)
        attempts = g["na"] + g["nr"]
        serial[name] = int(attempts.max())
        bounds[name] = xor_bound("xor_sde_select", int(attempts.sum()), M=XA_MAX_STEPS,
                                 tree=tree)
    g = grids["jax"]
    n, n_real = g["t0s"].shape[0], g["n_real"]
    real_half_steps = int(2 * g["na"].sum())
    times["xor_sde_replay_fwd"] = cuda_ms(
        lambda: xs.xor_sde_replay_fwd(y0, g["t0s"], g["hs"], g["i1"], g["i10"], n_real, pf, sc,
                                      kv), reps=3, warmup=1, device_time=True)
    times["xor_sde_replay_bwd"] = cuda_ms(
        lambda: xs.xor_sde_replay_bwd(ys, ysbar, g["t0s"], g["hs"], g["i10"], n_real, chunk, pf,
                                      sc, kv), reps=3, warmup=1, device_time=True)
    for name in ("xor_sde_replay_fwd", "xor_sde_replay_bwd"):
        serial[name] = n_real
        bounds[name] = xor_bound(name, real_half_steps, n=n, n_real=n_real)
    emit("xor_adaptive_kernel_times", lanes=B, T=XOR_T, ms=times, plain_ms=plain_ms,
         plain_ms_at=plain_at, serial_steps=serial,
         ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()},
         library_ms="n/a: no single PyTorch call computes a controller loop or a serial SDE "
                    "sweep")
    for tree, fused_pass in XA_TREES.items():
        task = make_task()
        step = xt.make_train_step(task, stochastic=True, adaptive=True, fused_pass=fused_pass)
        keys_s = [torch.randint(0, 2**32, (B, 2), generator=gen, device=dev, dtype=torch.int64)
                  for _ in range(5)]
        step(conds, keys=keys_s[0])
        _, ms = timed(lambda: [step(conds, keys=k) for k in keys_s])
        wall, by_kernel = device_profile(lambda i: step(conds, keys=keys_s[i]), 3)
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv_: -kv_[1])[:6]
        emit("xor_adaptive_step_profile", tree=tree, fused_pass=fused_pass, lanes=B,
             step_ms=ms / 5, samples_per_s=B * 1e3 / (ms / 5), profiled_wall_ms_per_step=wall,
             device_busy_ms_per_step=busy if busy else "not measured",
             idle_share=1.0 - busy / (ms / 5) if busy else "not measured",
             device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    # -- 46. the command lines (run with the others at the end) ----------------
    for argv in (["--smoke", "--stochastic", "--adaptive"],
                 ["--smoke", "--stochastic", "--adaptive", "--fused", "--fused-pass"]):
        defer_command_line("xor_adaptive_command_lines", "xor", argv, finite=True)

    replaces = {"xor_sde_select_jax": "columnflow/solvers/sde_adaptive.py:314",
                "xor_sde_select_kernel": "columnflow/solvers/sde_adaptive.py:509",
                "xor_sde_replay_fwd": "columnflow/solvers/fused.py:845",
                "xor_sde_replay_bwd": "columnflow/solvers/fused.py:920"}
    path = {"xor_sde_select_jax": "XOR stochastic-adaptive (the XLA selection, jax.random tree)",
            "xor_sde_select_kernel": "XOR stochastic-adaptive --fused-pass (B5x, krng tree)",
            "xor_sde_replay_fwd": "XOR stochastic-adaptive (B3xl, both trees)",
            "xor_sde_replay_bwd": "XOR stochastic-adaptive (B4'xl, both trees)"}
    launched = {"xor_sde_select_jax": launches["jax"].get("xor_sde_select", 0),
                "xor_sde_select_kernel": launches["kernel"].get("xor_sde_select", 0)}
    for name in ("xor_sde_replay_fwd", "xor_sde_replay_bwd"):
        launched[name] = launches["jax"].get(name, 0) + launches["kernel"].get(name, 0)
    err_of = {"xor_sde_select_jax": errs["xor_sde_select_jax"],
              "xor_sde_select_kernel": errs["xor_sde_select_kernel"],
              "xor_sde_replay_fwd": errs["xor_sde_replay_fwd"],
              "xor_sde_replay_bwd": errs["xor_sde_replay_bwd"]}
    return [{"name": name, "route": "cuda", "source": XOR_SOURCES["sde"],
             "replaces": replaces[name], "launches": launched[name], "max_abs_err": err_of[name],
             "ms": times[name], "plain_ms": plain_ms[name], "plain_ms_at": plain_at[name],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
             "lanes": B, "path": path[name],
             "ns_per_serial_step": times[name] * 1e6 / serial[name]}
            for name in replaces]


# The Hopf task (columnflow/tasks/bifurcation.py build_task / train_bifurcation
# defaults, scripts/bifurcation_ode.py:179-210): the MLP 3 -> 100 -> 100 ->
# 100 -> 2 (20,802 parameters), batch 32 as one (32, 2) state under one
# controller, 1000 grid points over 25 s, max_steps 1024, dopri5 at rtol 1e-7
# / atol 1e-9, SmoothL1, RMSprop(lr 1e-3, alpha 0.99). Nothing cut.
HOPF_T, HOPF_SPAN, HOPF_B, HOPF_MAX_STEPS = 1000, 25.0, 32, 1024
HOPF_SOURCE = "columnflow_torch/kernels/csrc/hopf_ode.cu"
# Card against CPU: the loss within HOPF_LOSS_TOL, each gradient within
# HOPF_GRAD_TOL or ten times the card's own spread under a 1e-7 nudge of the
# weights, whichever is larger (the replay and sweep need no exp or log: only
# the grid's float32 times and the dense output's division round apart).
HOPF_LOSS_TOL, HOPF_GRAD_TOL = 1e-5, 1e-5


def hopf_bound(kernel, work, T=HOPF_T, M=0, H=None):
    """(bound_ms, bound_by) of a Hopf kernel or outer pass at hidden width H
    (the reference's by default; the wide kernels' names end in ``_wide``);
    ``work`` is what this run's data needed: the controller attempts
    (selection) or the accepted steps (replay, sweeps, outer pass). A drift
    evaluation of the batch is the MLP's products, 2 B (3 H + 2 H^2 + 2 H)
    float32 operations, plus ~4 B H for the biases and ReLUs; a drift VJP's
    products are twice that (the transposed products and the weight
    cotangents contracted over the lanes), its state part alone once. The
    selection takes 6 drifts per attempt, the replay 7 per step, the
    kernel-mode sweep 7 drifts (the stage states and each stage's
    activations) and 7 VJPs per step, the emit-mode sweep 7 drifts and 7
    state VJPs, the outer pass 7 drifts and 7 VJPs per step. All
    float32-rate operations. Bytes: each input read once, each output
    written once."""
    from columnflow_torch.models.hopf import MLP_SIZES

    B, H = HOPF_B, H or MLP_SIZES[1]
    sizes = (3, H, H, H, 2)
    N = 2 * B
    n_params = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    drift = 2 * B * (3 * H + 2 * H * H + 2 * H) + 4 * B * H
    inputs = 4 * (n_params + T * B)
    kernel = kernel.removesuffix("_wide")
    if kernel == "hopf_select":
        flops = work * (6 * drift + (2 * 21 + 2 * 6 + 8) * N)
        nbytes = inputs + 4 * N + 4 * (M + 1) + 12
    elif kernel == "hopf_replay_fwd":
        flops = work * (7 * drift + (2 * 21 + 2 * 6 + 20) * N)
        nbytes = inputs + 4 * N + 4 * (work + 1) + 4 * work * N * 6
    elif kernel == "hopf_replay_bwd_emit":
        flops = work * (7 * drift + 7 * drift + (2 * 21 + 2 * 21 + 40) * N)
        nbytes = inputs + 4 * (work + 1) + 4 * work * N * 6 + 4 * N + 4 * work * N
    elif kernel == "hopf_outer_arg_grads":
        flops = work * (7 * drift + 7 * 2 * drift + (2 * 21 + 2 * 21 + 40) * N)
        nbytes = inputs + 4 * (work + 1) + 4 * work * N * 7 + 4 * n_params
    else:  # hopf_replay_bwd
        flops = work * (7 * drift + 7 * 2 * drift + (2 * 21 + 2 * 21 + 40) * N)
        nbytes = inputs + 4 * (work + 1) + 4 * work * N * 6 + 4 * N + 4 * n_params
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hopf_phases(dev, cfg):
    """Phases 20-23 for the Hopf task's train step; returns its kernels'
    entries of the kernels line."""
    import torch

    from columnflow_torch.data import make_hopf_dataset
    from columnflow_torch.kernels import column_step as cs
    from columnflow_torch.kernels import hopf_ode as ho
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.kernels import xor_ode as xo
    from columnflow_torch.kernels import xor_sde as xs
    from columnflow_torch.solvers.fused import round_max_steps
    from columnflow_torch.tasks import bifurcation as bt

    counters = {"hopf_ode": ho.LAUNCHES, "xor_ode": xo.LAUNCHES, "xor_sde": xs.LAUNCHES,
                "network_ode": no.LAUNCHES, "network_sde": ns.LAUNCHES,
                "column_step": cs.LAUNCHES}
    B = HOPF_B

    def make_task(device=dev, params=None):
        task = bt.build_task(torch.Generator(device=device).manual_seed(0), time_points=HOPF_T,
                             total_time=HOPF_SPAN, max_steps=HOPF_MAX_STEPS, device=device)
        if params is not None:
            with torch.no_grad():
                for layer, src in zip(task.params, params):
                    for k, p in layer.items():
                        p.copy_(src[k])
        return task

    def leaves(params):
        return {f"{i}.{k}": layer[k] for i, layer in enumerate(params) for k in ("w", "b")}

    def max_abs(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def equal(got, want):
        if isinstance(got, list):
            return all(torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in g)
        return torch.equal(got, want)

    # -- 20. kernels vs plain versions at full width --------------------------
    gen = torch.Generator(device=dev).manual_seed(5)
    task = make_task()
    ds = make_hopf_dataset(gen, 2 * B, task.ts, device=dev)  # two batches
    batch = ds[:, :B]
    mu = ho.MuTable(batch[:, :, 2].contiguous(), 0.0, task.dt)
    y0 = batch[0, :, :2].contiguous()
    # Copies: the main path below trains task.params in place.
    params = [{k: v.detach().clone() for k, v in layer.items()} for layer in task.params]
    M = round_max_steps((B, 2), HOPF_MAX_STEPS)
    scfg = ho.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]), max_steps=M)
    plain_ms = {}
    st, stats = ho.hopf_select(y0, params, mu, scfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, stats_p = ho._hopf_select_plain(y0, params, mu, scfg)
    torch.cuda.synchronize()
    plain_ms["hopf_select"] = (time.perf_counter() - t0) * 1e3
    na, nr, ok = (int(x) for x in stats)
    na_p = int(stats_p[0])
    sel_equal = stats.tolist() == stats_p.tolist() and equal(st, st_p)
    # The error norm's float64 sum runs in the kernel's warp order and in
    # PyTorch's order in the plain version: one float32 ulp of a norm can
    # move the grid at rtol 1e-7, so the selection is held bit for bit up to
    # where the grids part, and by its counts.
    d_st = (st[:min(na, na_p) + 1] - st_p[:min(na, na_p) + 1]).abs()
    parted = int(torch.nonzero(d_st).min()) if bool((d_st > 0).any()) else None
    check(ok == 1 and int(stats_p[2]) == 1 and M == 1024 and abs(na - na_p) <= 0.01 * na_p + 1
          and equal(st[:11], st_p[:11]),
          f"hopf_select: stats {stats.tolist()} vs plain {stats_p.tolist()}, max_steps {M}, "
          f"first parted index {parted}")
    stn = st[:na + 1].contiguous()
    ys, co = ho.hopf_replay_fwd(y0, stn, params, mu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys_p, co_p = ho._hopf_replay_fwd_plain(y0, stn, params, mu)
    torch.cuda.synchronize()
    plain_ms["hopf_replay_fwd"] = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(co).all()) and equal(ys, ys_p) and equal(co, co_p),
          f"hopf_replay_fwd over the whole grid: ys {max_abs(ys, ys_p)}, rows {max_abs(co, co_p)}")
    errs = {"hopf_select": float(d_st.max()), "hopf_replay_fwd": max(max_abs(ys, ys_p),
                                                                     max_abs(co, co_p))}
    att = {"equal": True, "accepted": 0}
    for r in range(16):
        k = int(r / 16 * (na - 1))
        t, y = st[k].clone(), ys[k].contiguous()
        h = ((st[k + 1] - st[k]) * (1.0, 1.5, 2.5)[r % 3]).clone()
        f0 = ho.hopf_ode_drift(t, y, params, mu).contiguous()
        a = ho.hopf_attempt(t, y, f0, h, params, mu, scfg)
        a_p = ho._hopf_attempt_plain(t, y, f0, h, params, mu, scfg)
        att["equal"] &= all(equal(g, w) for g, w in zip(a, a_p))
        att["accepted"] += int(a.ratio <= 1.0)
    check(att["equal"], f"hopf_attempt: {att}")
    cobar = torch.randn(co.shape, generator=gen, device=dev)
    ybar, grads = ho.hopf_replay_bwd(ys, cobar, stn, params, mu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ybar_p, grads_p = ho._hopf_replay_bwd_plain(ys, cobar, stn, params, mu)
    torch.cuda.synchronize()
    plain_ms["hopf_replay_bwd"] = (time.perf_counter() - t0) * 1e3
    bwd_equal = equal(ybar, ybar_p) and equal(grads, grads_p)
    check(bool(torch.isfinite(ybar).all()) and bwd_equal,
          f"hopf_replay_bwd over the whole grid: ybar {rel_l2(ybar, ybar_p)}")
    errs["hopf_replay_bwd"] = max([max_abs(ybar, ybar_p)] + [
        max_abs(g[k], w[k]) for g, w in zip(grads, grads_p) for k in g])
    emit("hopf_kernel_vs_plain", lanes=B, T=HOPF_T, max_steps=M,
         selection={"stats": [na, nr, ok], "stats_plain": stats_p.tolist(),
                    "bit_for_bit": sel_equal, "first_parted_index": parted},
         attempt={"records": 16, **att}, replay_steps=na, sweep_steps=na,
         tol="bit for bit", max_abs_err=errs)

    # -- 21. the main path: 3 train steps from make_hopf_dataset --------------
    step = bt.make_train_step(task)
    for c in counters.values():
        for k in c:
            c[k] = 0
    history, first = [], None
    for i in range(3):
        true_y = ds[:, torch.randperm(2 * B, generator=gen, device=dev)[:B]]
        params_i = [{k: p.detach().cpu().clone() for k, p in layer.items()}
                    for layer in task.params]
        before = {m: dict(c) for m, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = step(true_y)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: c[k] - before[m][k] for m, c in counters.items() for k in c
                    if c[k] != before[m][k]}
        want = {"hopf_select": 1, "hopf_replay_fwd": 1, "hopf_replay_bwd": 1}
        check(launched == want, f"hopf step {i}: launches {launched}")
        sk = rec["stats"]
        check(bool(torch.isfinite(rec["loss"])) and bool(sk.success),
              f"hopf step {i}: loss {rec['loss']}, success {bool(sk.success)}")
        check(all(bool(torch.isfinite(p.grad).all()) for layer in task.params
                  for p in layer.values()), f"hopf step {i}: gradient not finite")
        history.append({"loss": float(rec["loss"]), "seconds": seconds,
                        "naccept": int(sk.naccept), "nreject": int(sk.nreject)})
        if i == 0:
            first = dict(true_y=true_y, params=params_i, loss=float(rec["loss"]),
                         grid=(sk.step_times.cpu(), int(sk.naccept)),
                         grads=leaves([{k: p.grad.detach().cpu().clone()
                                        for k, p in layer.items()} for layer in task.params]))
    main_launches = {k: v for k, v in ho.LAUNCHES.items() if v}
    val_loss = bt.validation_loss(task, ds[:, B:B + 1])
    check(bool(torch.isfinite(val_loss)), f"hopf validation loss {val_loss}")

    # The first step again on the CPU with the plain versions on the card's
    # frozen grid, beside the card's own gradient spread when the weights
    # move by one part in 1e7.
    def one_step(device, params_src, grid):
        t = make_task(device=device, params=params_src)
        rec = bt.make_train_step(t)(first["true_y"], grid=(grid[0].to(device), grid[1]))
        grads = leaves([{k: p.grad.detach().cpu().clone() for k, p in layer.items()}
                        for layer in t.params])
        return float(rec["loss"]), grads

    nudged = [{k: v * (1.0 + 1e-7) for k, v in layer.items()} for layer in first["params"]]
    loss_n, grads_n = one_step(dev, nudged, first["grid"])

    def compare(res, first=first, grads_n=grads_n):
        loss_c, grads_c, _ = res[0]
        spread = {k: rel_l2(grads_n[k], first["grads"][k]) for k in grads_c}
        grad_tol = {k: max(HOPF_GRAD_TOL, 10.0 * spread[k]) for k in grads_c}
        entry = {"naccept": first["grid"][1],
                 "loss_rel": abs(first["loss"] - loss_c) / abs(loss_c),
                 "grad_rel_l2": {k: rel_l2(first["grads"][k], grads_c[k]) for k in grads_c},
                 "card_grad_spread_under_1e-7_nudge": spread,
                 "tol": {"loss": HOPF_LOSS_TOL, "grad": grad_tol}}
        check(entry["loss_rel"] < HOPF_LOSS_TOL
              and all(entry["grad_rel_l2"][k] < grad_tol[k] for k in grads_c),
              f"card vs CPU Hopf step: {entry}")
        return entry

    cpu_later("hopf_cpu_check", "first_step", compare, "hopf", None,
              dict(time_points=HOPF_T, total_time=HOPF_SPAN, max_steps=HOPF_MAX_STEPS), {},
              args=(first["true_y"],), kwargs=dict(grid=first["grid"]),
              params_list=[first["params"]])
    emit("hopf_main_path", lanes=B, T=HOPF_T, max_steps=M, history=history,
         launches=main_launches, val_loss=float(val_loss), cpu_check="hopf_cpu_check")

    # -- 22. times -------------------------------------------------------------
    calls = {
        "hopf_select": lambda: ho.hopf_select(y0, params, mu, scfg),
        "hopf_replay_fwd": lambda: ho.hopf_replay_fwd(y0, stn, params, mu),
        "hopf_replay_bwd": lambda: ho.hopf_replay_bwd(ys, cobar, stn, params, mu),
    }
    times = {name: cuda_ms(fn, reps=5, warmup=1, device_time=True) for name, fn in calls.items()}
    serial = {"hopf_select": na + nr, "hopf_replay_fwd": na, "hopf_replay_bwd": na}
    bounds = {name: hopf_bound(name, serial[name], M=M) for name in calls}
    emit("hopf_kernel_times", lanes=B, T=HOPF_T, naccept=na, nreject=nr, ms=times,
         plain_ms=plain_ms, ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()})
    # Every timed step starts from the seed weights again, so that each one
    # replays the same grid: a training run's steps grow with the accepted
    # count (the main path's three steps above).
    task = make_task()
    step = bt.make_train_step(task)
    seed_params = [{k: p.detach().clone() for k, p in layer.items()} for layer in task.params]

    def seed_step(i=0):
        with torch.no_grad():
            for layer, src in zip(task.params, seed_params):
                for k, p in layer.items():
                    p.copy_(src[k])
        return step(batch)

    rec0 = seed_step()
    step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seed_step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_ms = sum(step_s) * 1e3 / len(step_s)
    wall, by_kernel = device_profile(seed_step, 3)
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    emit("hopf_step_profile", lanes=B, naccept=int(rec0["stats"].naccept),
         nreject=int(rec0["stats"].nreject), step_ms=step_ms, samples_per_s=B * 1e3 / step_ms,
         profiled_wall_ms_per_step=wall,
         device_busy_ms_per_step=busy if busy else "not measured",
         idle_share=1.0 - busy / step_ms if busy else "not measured",
         device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    # -- 23. the command line ---------------------------------------------------
    defer_command_line("hopf_command_line", "bifurcation", ["--smoke"], timeout=300,
                       finite=True)

    replaces = {"hopf_select": "columnflow/solvers/fused.py:238",
                "hopf_replay_fwd": "columnflow/solvers/fused.py:294",
                "hopf_replay_bwd": "columnflow/solvers/fused.py:327"}
    return [{"name": name, "route": "cuda", "source": HOPF_SOURCE, "replaces": replaces[name],
             "launches": main_launches[name], "max_abs_err": errs[name], "ms": times[name],
             "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None, "lanes": B, "path": "Hopf",
             "ns_per_serial_step": times[name] * 1e6 / serial[name]}
            for name in calls]


# Stochastic parity at 13 columns (the reference's topology): the fixed-grid
# SDE step (--stochastic) and the XLA selection's adaptive step
# (--stochastic --adaptive), both on the three-term split in kernel mode.
S13_CPA = (8, 4, 1)
S13_T = 1000
S13_B = 4
S13_MAX_STEPS = 3072  # the command line's default, task.max_steps
S13_W = 64            # half steps of each lanes window of B3t and B4't held against plain
S13_UNIFORM_W = 250   # steps of the uniform grid B3t and B4't are held against plain on
                      # (all 999 took 11.9 s of plain loop)
S13_LOSS_TOL = 1e-5
S13_GRAD_TOL = 1e-3   # rel L2 of each gradient, card against CPU (or ten times the card's spread)
# bench.py's primary configuration: the 104-column step without --fused-pass.
BENCH = dict(stochastic=True, adaptive=True, select_bf16=True, grad_bf16=True, split2=True,
             bptt_every=32, clip_grad_norm=1.0, loss_scale=1e-6)
JAX_NORMAL_OPS = 300  # a jax.random normal: two Threefry-2x32 hashes and an erf_inv
BENCH_SEL_T = 25      # grid points of the whole jax-tree selections held against their plain loop
BENCH104_SEL_T = 12   # ... in phase 29 (two lanes on the select16 drift; 25 took 13 s of plain loop)


def jax_select_bound(P, B, n_in, K, attempts, M, f32: bool):
    """(bound_ms, bound_by) of the selection on the jax.random tree: per
    attempt 5 drift evaluations (one (P, P) product each: float32 weights at
    the float32 rate, or select16's bf16 at the bf16 rate), 3 SRA1 updates,
    the error norm, and 44 normals (two tree walks of 21 and two interval
    normals). Bytes: the weights once, y0, the key words and the grids."""
    S, prod = 3 * P, 2 * P * P
    ops32 = attempts * (5 * (30 * P + 8 * S) + 36 * S + 44 * JAX_NORMAL_OPS)
    ops16 = 0.0
    if f32:
        ops32 += attempts * 5 * prod
    else:
        ops16 = attempts * 5 * prod
    wbytes = (4 if f32 else 2) * (P * P + n_in * P)
    nbytes = wbytes + 4 * (2 * P + K * B * n_in) + 4 * B * S + 16 * B + 4 * B * (M + 1) + 12 * B
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops16 / BF16_FLOPS + ops32 / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sde3_bound(kernel, P, B, n_in, K, steps, n):
    """(bound_ms, bound_by) of the three-term sweeps for ``steps`` real
    steps of all lanes (lanes x steps): a forward step is 2 drift
    evaluations of six bf16 products (2 P^2 each); a kernel-mode reverse
    step one drift and two VJPs of three state-side and three weight-side
    products, and the fold of the weight cotangents (~10 P^2 operations);
    an emit-mode step (``sde3_bwd_emit``) the drift and the state-side
    products only, with its seeds written. Bytes: wT and iwT (float32)
    once, the grid and noise of the real steps, the states (and cotangents)
    written or read once."""
    S, prod = 3 * P, 2 * P * P
    consts = 4 * (2 * P + K * B * n_in) + 4 * (P * P + n_in * P)
    if kernel == "sde3_fwd":
        ops16 = steps * 2 * 6 * prod
        ops32 = steps * (2 * (30 * P + 8 * S) + 10 * S)
        nbytes = consts + 4 * B * S + 16 * steps + 4 * (n + 1) * B * S
    elif kernel == "sde3_bwd_emit":  # no weight cotangents: a drift and two state VJPs
        ops16 = steps * 12 * prod
        ops32 = steps * (30 * P + 2 * (20 * P + 10 * S) + 12 * S)
        nbytes = consts + 12 * steps + 3 * 4 * steps * S + 4 * B * S
    else:
        ops16 = steps * 18 * prod
        ops32 = steps * (30 * P + 2 * (20 * P + 10 * S) + 12 * S) + (steps / B) * 10 * P * P
        nbytes = consts + 12 * steps + 2 * 4 * steps * S + 4 * B * S + 4 * (P * P + n_in * P)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops16 / BF16_FLOPS + ops32 / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stochastic13_phases(dev, cfg):
    """Phases 24-27: the fixed-grid SDE step and the XLA selection's
    adaptive step at 13 columns; returns their kernels' entries of the
    kernels line."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.solvers.fused import sweep_chunk, uniform_step_times
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(7)
    B = S13_B

    def make_task(time_steps=S13_T, device=dev, params=None):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=S13_CPA, time_steps=time_steps,
                                 max_steps=S13_MAX_STEPS, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def lane_keys(n=B):
        return torch.randint(0, 2**32, (n, 2), generator=gen, device=dev, dtype=torch.int64)

    def noise_pack(ts):
        _, i1, i10, _, _ = brownian_pack(gen, ts, (B, 1))
        return i1, i10

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def equal(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    # -- 24. kernel vs plain -----------------------------------------------------
    task = make_task()
    P = task.net.num_pops
    S, n_in, K = 3 * P, 4, 4
    stims = make_parity_batch(gen, n_in, B, device=dev)
    model = parity.sde_model(task.params, task, stims)
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    scfg = sa.select_config(task.ts, max_steps=S13_MAX_STEPS, brownian="jax", drift="f32")
    words = sa._sde_key_words(lane_keys(), "jax")
    y0 = torch.zeros(B, S, device=dev)
    st, na, nr, ok = ns.select_pass(y0, words, pw, model.sc, model.kv, scfg)
    ht, dw, i10 = sa._replay_grid(st, words, scfg.t_start, scfg.t_end, scfg.depth, "jax")
    lanes_grid = (ht[:, :-1].T.contiguous(), (ht[:, 1:] - ht[:, :-1]).T.contiguous(),
                  dw.T.contiguous(), i10.T.contiguous())
    n_real = 2 * int(na.max())
    plain_ms, errs, same = {}, {}, {}
    # B3t over the whole lanes grid, held against its plain version on
    # S13_W-half-step windows early, in the middle and late, from the
    # kernel's state there (the whole replay's plain version took 19 s: cut
    # in depth in PR 10).
    ys_l = ns.replay3_fwd(y0, *lanes_grid, n_real, pw, model.sc, model.kv)
    errs["sde3_fwd_lanes"], same["sde3_fwd_lanes"] = 0.0, True
    for k0 in (0, n_real // 2, n_real - S13_W):
        win = tuple(x[k0:k0 + S13_W].contiguous() for x in lanes_grid)
        got = ns.replay3_fwd(ys_l[k0].contiguous(), *win, S13_W, pw, model.sc, model.kv)
        want, ms = timed(lambda: ns._replay3_fwd_plain(ys_l[k0].contiguous(), *win, S13_W, pw,
                                                       model.sc, model.kv))
        plain_ms.setdefault("sde3_fwd_lanes", ms)
        errs["sde3_fwd_lanes"] = max(errs["sde3_fwd_lanes"], float((got - want).abs().max()))
        same["sde3_fwd_lanes"] &= bool(torch.equal(got, want)) and bool(
            torch.equal(got, ys_l[k0:k0 + S13_W + 1]))
    check(bool(torch.isfinite(ys_l).all()) and same["sde3_fwd_lanes"],
          f"B3t lanes against its plain version: max abs {errs['sde3_fwd_lanes']}")

    # The whole selection over BENCH_SEL_T grid points, kernel and plain loop.
    task_s = make_task(BENCH_SEL_T, params=task.params)
    model_s = parity.sde_model(task_s.params, task_s, stims)
    scfg_s = sa.select_config(task_s.ts, max_steps=S13_MAX_STEPS, brownian="jax", drift="f32")
    sel_k = ns.select_pass(y0, words, pw, model_s.sc, model_s.kv, scfg_s)
    sel_p, plain_ms["sde_select_jax_f32"] = timed(
        lambda: ns._select_plain(y0, words, pw, model_s.sc, model_s.kv, scfg_s))
    same["sde_select_jax_f32"] = equal(sel_k, sel_p)
    errs["sde_select_jax_f32"] = float((sel_k[0] - sel_p[0]).abs().max())
    check(same["sde_select_jax_f32"] and bool(sel_k[3].all()),
          f"jax-tree selection (f32) over {BENCH_SEL_T} points: naccept {sel_k[1].tolist()} "
          f"vs {sel_p[1].tolist()}, nreject {sel_k[2].tolist()} vs {sel_p[2].tolist()}")
    # 16 attempts from states along the full replay, at 1, 1.5 and 2 times the accepted step.
    N = 16
    li = torch.arange(N, device=dev) % B
    ri = torch.tensor([2 * int((r // B) / (N // B) * (int(na[r % B]) - 1)) for r in range(N)],
                      device=dev)
    fac = torch.tensor([1.0 + 0.5 * ((r // B) % 3) for r in range(N)], device=dev)[:, None]
    t1 = st[li, ri // 2][:, None].contiguous()
    h = ((st[li, ri // 2 + 1][:, None] - t1) * fac).contiguous()
    w_r, kv_r = words[li].contiguous(), model.kv[:, li].contiguous()
    w_t1 = ns._tree(w_r, scfg).evaluate(t1).contiguous()
    att_args = (t1, ys_l[ri, li].contiguous(), h, torch.full((N, 1), 0.7, device=dev), w_t1, w_r,
                pw, model.sc, kv_r, scfg)
    att, att_p = ns.select_attempt(*att_args), ns._attempt_plain(*att_args)
    same["sde_attempt_jax_f32"] = equal(att, att_p)
    check(same["sde_attempt_jax_f32"], "jax-tree attempts (f32) against the plain body")

    # The reverse sweep on windows early, in the middle and late of the replay.
    chunk = sweep_chunk((B, S), lanes_grid[0].shape[0])
    errs["sde3_bwd_lanes"], same["sde3_bwd_lanes"], bwd_lanes_plain = 0.0, True, []
    for k0 in (0, (n_real // 2) & ~1, n_real - S13_W):
        win = tuple(x[k0:k0 + S13_W].contiguous() for x in lanes_grid)
        ysbar = torch.randn(S13_W, B, S, generator=gen, device=dev)
        bwd = (ys_l[k0:k0 + S13_W].contiguous(), ysbar, win[0], win[1], win[3], S13_W, 0,
               chunk, pw, model.sc, model.kv)
        got = ns.replay3_bwd(*bwd)
        want, ms = timed(lambda: ns._replay3_bwd_plain(*bwd))
        bwd_lanes_plain.append(ms)
        errs["sde3_bwd_lanes"] = max(errs["sde3_bwd_lanes"],
                                     max(float((g - w).abs().max()) for g, w in zip(got, want)))
        same["sde3_bwd_lanes"] &= equal(got, want)
    plain_ms["sde3_bwd_lanes"] = sum(bwd_lanes_plain) / len(bwd_lanes_plain)
    check(same["sde3_bwd_lanes"], f"B4't lanes windows: max abs {errs['sde3_bwd_lanes']}")

    # The uniform grid: the kernels over all 999 steps (timed below), held
    # against their plain versions over the first S13_UNIFORM_W.
    t0u, hu = uniform_step_times(task.ts, (B, S))
    t0u = t0u.to(dev)
    hs_u = torch.full_like(t0u, hu)
    n_u = t0u.shape[0]
    i1u, i10u = (x.reshape(n_u, B).contiguous() for x in noise_pack(task.ts))
    fwd_u = (t0u, hs_u, i1u, i10u, n_u, pw, model.sc, model.kv)
    ysbar_u = torch.randn(n_u, B, S, generator=gen, device=dev)
    ys_full = ns.replay3_fwd(y0, *fwd_u)
    bwd_u = (ys_full[:-1].contiguous(), ysbar_u, t0u, hs_u, i10u, n_u, 0,
             sweep_chunk((B, S), n_u), pw, model.sc, model.kv)
    Wu = S13_UNIFORM_W
    fwd_w = (t0u[:Wu], hs_u[:Wu], i1u[:Wu], i10u[:Wu], Wu, pw, model.sc, model.kv)
    ys_u = ns.replay3_fwd(y0, *fwd_w)
    ys_up, plain_ms["sde3_fwd_uniform"] = timed(lambda: ns._replay3_fwd_plain(y0, *fwd_w))
    bwd_w = (ys_u[:-1].contiguous(), ysbar_u[:Wu].contiguous(), t0u[:Wu], hs_u[:Wu], i10u[:Wu],
             Wu, 0, sweep_chunk((B, S), Wu), pw, model.sc, model.kv)
    got_u = ns.replay3_bwd(*bwd_w)
    want_u, plain_ms["sde3_bwd_uniform"] = timed(lambda: ns._replay3_bwd_plain(*bwd_w))
    errs["sde3_fwd_uniform"] = float((ys_u - ys_up).abs().max())
    errs["sde3_bwd_uniform"] = max(float((g - w).abs().max()) for g, w in zip(got_u, want_u))
    same["sde3_fwd_uniform"] = bool(torch.equal(ys_u, ys_up))
    same["sde3_bwd_uniform"] = equal(got_u, want_u)
    check(same["sde3_fwd_uniform"] and same["sde3_bwd_uniform"],
          f"B3t/B4't uniform against their plain versions: {errs}")
    emit("stochastic13_kernel_vs_plain", columns=sum(S13_CPA), P=P, lanes=B, T=S13_T,
         max_steps=S13_MAX_STEPS, selection={"naccept": na.tolist(), "nreject": nr.tolist(),
                                             "success": ok.tolist(), "n_real": n_real,
                                             "short_T": BENCH_SEL_T,
                                             "short_naccept": sel_k[1].tolist(),
                                             "short_nreject": sel_k[2].tolist()},
         attempts=N, sweep_windows=S13_W, chunk=chunk, bit_for_bit=same, max_abs_err=errs,
         plain_ms=plain_ms)

    # -- 25. main path: 3 fixed-grid and 3 adaptive train steps --------------------
    history, main_launches, first, step_s = {}, {}, {}, {}
    for name, flags in (("fixed_grid", dict(stochastic=True)),
                        ("xla_selection", dict(stochastic=True, adaptive=True))):
        task = make_task()
        step = parity.make_train_step(task, **flags)
        for k in ns.LAUNCHES:
            ns.LAUNCHES[k] = 0
        history[name], step_s[name] = [], []
        for i in range(3):
            stims_i = make_parity_batch(gen, n_in, B, device=dev)
            keys_i = lane_keys() if "adaptive" in flags else None
            noise_i = None if keys_i is not None else noise_pack(task.ts)
            params_i = {k: p.detach().cpu().clone() for k, p in task.params.items()}
            before = dict(ns.LAUNCHES)
            rec, ms = timed(lambda: step(stims_i, keys_i, noise=noise_i))
            step_s[name].append(ms / 1e3)
            launched = {k: ns.LAUNCHES[k] - before[k] for k in ns.LAUNCHES
                        if ns.LAUNCHES[k] != before[k]}
            want = {"sde3_fwd": 1, "sde3_bwd": 1}
            if keys_i is not None:
                want["sde_select"] = 1
            check(launched == want, f"{name} step {i}: launches {launched}")
            check(bool(torch.isfinite(rec["loss"])), f"{name} step {i}: loss {rec['loss']}")
            entry = {"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                     "update_applied": bool(rec["ok"]), "seconds": ms / 1e3}
            if rec["stats"] is not None:
                entry.update(naccept=rec["stats"].naccept.tolist(),
                             nreject=rec["stats"].nreject.tolist(),
                             success=rec["stats"].success.tolist())
            history[name].append(entry)
            if i == 0:
                first[name] = dict(stims=stims_i, keys=keys_i, noise=noise_i, params=params_i)
        main_launches[name] = {k: v for k, v in ns.LAUNCHES.items() if v}

    # The card against the CPU: the fixed-grid step over the full second, the
    # adaptive step over SHORT_T points (its replay on the CPU takes ~4 s per
    # 100 points), each on the card's grid and noise, beside the card's own
    # spread under a 1e-7 nudge of the weights.
    for name, flags, T_check in (("fixed_grid", dict(stochastic=True), S13_T),
                                 ("xla_selection", dict(stochastic=True, adaptive=True),
                                  SHORT_T)):
        f = first[name]

        def one(device, params, grid=None):
            t = make_task(T_check, device=device, params=params)
            noise = None if f["noise"] is None else tuple(x.to(device) for x in f["noise"])
            keys = None if f["keys"] is None else f["keys"].to(device)
            t0 = time.perf_counter()
            rec = parity.make_train_step(t, **flags)(f["stims"].to(device), keys, noise=noise,
                                                     grid=grid)
            grads = {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}
            return rec, grads, time.perf_counter() - t0

        rec_k, grads_k, _ = one(dev, f["params"])
        grid = None
        if rec_k["stats"] is not None:
            sk = rec_k["stats"]
            grid = tuple(x.cpu() for x in (sk.step_times, sk.naccept, sk.nreject))
        nudged = {k: v * (1.0 + 1e-7) for k, v in f["params"].items()}
        _, grads_n, _ = one(dev, nudged, None if grid is None
                            else tuple(x.to(dev) for x in grid))

        def compare(res, name=name, T_check=T_check, loss_k=float(rec_k["loss"]),
                    grads_k=grads_k, grads_n=grads_n):
            loss_c, grads_c, _ = res[0]
            spread = {k: rel_l2(grads_n[k], grads_k[k]) for k in grads_k}
            grad_tol = {k: max(S13_GRAD_TOL, 10.0 * spread[k]) for k in grads_k}
            entry = {"T": T_check, "loss_rel": abs(loss_k - loss_c) / abs(loss_c),
                     "grad_rel_l2": {k: rel_l2(grads_k[k], grads_c[k]) for k in grads_k},
                     "card_grad_spread_under_1e-7_nudge": spread,
                     "tol": {"loss": S13_LOSS_TOL, "grad": grad_tol}}
            check(entry["loss_rel"] < S13_LOSS_TOL
                  and all(entry["grad_rel_l2"][k] < grad_tol[k] for k in grads_k),
                  f"card vs CPU {name} step: {entry}")
            return entry

        cpu_later("stochastic13_cpu_check", name, compare, "parity", cfg,
                  dict(columns_per_area=S13_CPA, time_steps=T_check, max_steps=S13_MAX_STEPS),
                  flags, args=(f["stims"], f["keys"]),
                  kwargs=dict(noise=f["noise"], grid=grid), params_list=[f["params"]])
    emit("stochastic13_main_path", columns=sum(S13_CPA), lanes=B, T=S13_T,
         max_steps=S13_MAX_STEPS, history=history, launches=main_launches,
         cpu_check="stochastic13_cpu_check")

    # -- 26. times -----------------------------------------------------------------
    ysbar_l = torch.randn(lanes_grid[0].shape[0], B, S, generator=gen, device=dev)
    calls = {
        "sde_select_jax_f32": lambda: ns.select_pass(y0, words, pw, model.sc, model.kv, scfg),
        "sde3_fwd_lanes": lambda: ns.replay3_fwd(y0, *lanes_grid, n_real, pw, model.sc, model.kv),
        "sde3_bwd_lanes": lambda: ns.replay3_bwd(ys_l[:-1], ysbar_l, lanes_grid[0],
                                                 lanes_grid[1], lanes_grid[3], n_real, 0, chunk,
                                                 pw, model.sc, model.kv),
        "sde3_fwd_uniform": lambda: ns.replay3_fwd(y0, *fwd_u),
        "sde3_bwd_uniform": lambda: ns.replay3_bwd(*bwd_u),
    }
    times = {name: cuda_ms(fn, reps=3, warmup=1, device_time=True) for name, fn in calls.items()}
    attempts = int((na + nr).sum())
    serial = {"sde_select_jax_f32": int((na + nr).max()), "sde3_fwd_lanes": n_real,
              "sde3_bwd_lanes": n_real, "sde3_fwd_uniform": n_u, "sde3_bwd_uniform": n_u}
    real_steps = int(2 * na.sum())
    bounds = {"sde_select_jax_f32": jax_select_bound(P, B, n_in, K, attempts, S13_MAX_STEPS,
                                                     True),
              "sde3_fwd_lanes": sde3_bound("sde3_fwd", P, B, n_in, K, real_steps,
                                           lanes_grid[0].shape[0]),
              "sde3_bwd_lanes": sde3_bound("sde3_bwd", P, B, n_in, K, real_steps,
                                           lanes_grid[0].shape[0]),
              "sde3_fwd_uniform": sde3_bound("sde3_fwd", P, B, n_in, K, B * n_u, n_u),
              "sde3_bwd_uniform": sde3_bound("sde3_bwd", P, B, n_in, K, B * n_u, n_u)}
    plain_ms["sde_select_jax_f32_at"] = f"{BENCH_SEL_T} grid points"
    plain_ms["sde3_bwd_lanes_at"] = f"{S13_W} half steps"
    emit("stochastic13_kernel_times", lanes=B, T=S13_T, attempts=attempts,
         real_half_steps=real_steps, ms=times, plain_ms=plain_ms,
         ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()})
    profiles = {}
    for name, flags in (("fixed_grid", dict(stochastic=True)),
                        ("xla_selection", dict(stochastic=True, adaptive=True))):
        task = make_task()
        step = parity.make_train_step(task, **flags)
        seed = {k: p.detach().clone() for k, p in task.params.items()}
        f = first[name]

        def seed_step(i=0, step=step, task=task, seed=seed, f=f):
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(seed[k])
            return step(f["stims"], f["keys"], noise=f["noise"])

        seed_step()
        step_ms = sum(timed(seed_step)[1] for _ in range(3)) / 3
        wall, by_kernel = device_profile(seed_step, 2)
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        profiles[name] = {"step_ms": step_ms, "samples_per_s": B * 1e3 / step_ms,
                          "profiled_wall_ms_per_step": wall,
                          "device_busy_ms_per_step": busy if busy else "not measured",
                          "idle_share": 1.0 - busy / step_ms if busy else "not measured",
                          "top_ms_per_step": dict(top)}
    emit("stochastic13_step_profile", lanes=B, T=S13_T, **profiles)

    # -- 27. the command lines -------------------------------------------------------
    for argv in (["--smoke", "--stochastic"], ["--smoke", "--stochastic", "--adaptive"]):
        defer_command_line("stochastic13_command_lines", "parity", argv)

    launches = {"sde_select_jax_f32": main_launches["xla_selection"]["sde_select"],
                "sde3_fwd_lanes": main_launches["xla_selection"]["sde3_fwd"],
                "sde3_bwd_lanes": main_launches["xla_selection"]["sde3_bwd"],
                "sde3_fwd_uniform": main_launches["fixed_grid"]["sde3_fwd"],
                "sde3_bwd_uniform": main_launches["fixed_grid"]["sde3_bwd"]}
    paths = {"sde_select_jax_f32": "parity13 --stochastic --adaptive",
             "sde3_fwd_lanes": "parity13 --stochastic --adaptive",
             "sde3_bwd_lanes": "parity13 --stochastic --adaptive",
             "sde3_fwd_uniform": "parity13 --stochastic", "sde3_bwd_uniform": "parity13 --stochastic"}
    replaces = {"sde_select_jax_f32": "columnflow/solvers/sde_adaptive.py:314",
                "sde3_fwd_lanes": "columnflow/solvers/fused.py:845",
                "sde3_bwd_lanes": "columnflow/solvers/fused.py:920",
                "sde3_fwd_uniform": "columnflow/solvers/fused.py:845",
                "sde3_bwd_uniform": "columnflow/solvers/fused.py:920"}
    return [{"name": name, "route": "cuda", "source": SDE_SOURCE, "replaces": replaces[name],
             "launches": launches[name], "max_abs_err": errs[name], "ms": times[name],
             "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None, "lanes": B, "path": paths[name],
             "bit_for_bit": same[name],
             "ns_per_serial_step": times[name] * 1e6 / serial[name],
             **({"plain_ms_at": f"{S13_W} half steps"} if name == "sde3_fwd_lanes" else {}),
             **({"plain_ms_at": f"the first {S13_UNIFORM_W} steps"} if "uniform" in name
                else {})}
            for name in calls]


def bench104_phases(dev, cfg):
    """Phases 28-30: bench.py's primary configuration, the 104-column
    stochastic-adaptive step without --fused-pass (the jax.random tree's
    selection with the select16 drift, then B3, B4 emit and the outer
    weight-gradient pass); returns the selection's entry of the kernels
    line."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.models.network import premix_select16, prepare_premixed_split2
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(11)
    B, n_in, K = PARITY_B, 4, 4

    def make_task(time_steps=PARITY_T, device=dev, params=None):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=PARITY_CPA, time_steps=time_steps,
                                 max_steps=PARITY_MAX_STEPS, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def lane_keys(n=B):
        return torch.randint(0, 2**32, (n, 2), generator=gen, device=dev, dtype=torch.int64)

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    # -- 28. main path: FULL_STEPS train steps at full width -----------------------
    task = make_task()
    P = task.net.num_pops
    S = 3 * P
    step = parity.make_train_step(task, **BENCH)
    for k in ns.LAUNCHES:
        ns.LAUNCHES[k] = 0
    history, step_s, first = [], [], None
    for i in range(FULL_STEPS):
        stims_i, keys_i = make_parity_batch(gen, n_in, B, device=dev), lane_keys()
        params_i = {k: p.detach().cpu().clone() for k, p in task.params.items()}
        before = dict(ns.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = step(stims_i, keys_i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launched = {k: ns.LAUNCHES[k] - before[k] for k in ns.LAUNCHES
                    if ns.LAUNCHES[k] != before[k]}
        check(launched == {"sde_select": 1, "sde_replay_fwd": 1, "sde_replay_bwd": 1},
              f"bench step {i}: launches {launched}")
        st = rec["stats"]
        check(bool(st.success.all()) and bool(torch.isfinite(rec["loss"])),
              f"bench step {i}: success {st.success.tolist()}, loss {rec['loss']}")
        history.append({"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                        "update_applied": bool(rec["ok"]), "naccept": st.naccept.tolist(),
                        "nreject": st.nreject.tolist(), "seconds": step_s[-1]})
        if i == 0:
            first = dict(stims=stims_i, keys=keys_i, params=params_i, stats=st)
    main_launches = dict(ns.LAUNCHES)

    # The card against the CPU over GRAD_T grid points (every gradient), on
    # the card's grid and lane keys, beside the card's own nudge spread.
    bench_flags = {**BENCH, "clip_grad_norm": None}

    def one(params, grid=None):
        t = make_task(GRAD_T, params=params)
        rec = parity.make_train_step(t, **bench_flags)(first["stims"], first["keys"], grid=grid)
        return rec, {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}

    rec_k, grads_k = one(first["params"])
    sk = rec_k["stats"]
    grid = (sk.step_times, sk.naccept, sk.nreject)
    _, grads_n = one({k: v * (1.0 + 1e-7) for k, v in first["params"].items()}, grid)

    def compare(res, loss_k=float(rec_k["loss"]), grads_k=grads_k, grads_n=grads_n,
                naccept=sk.naccept.tolist()):
        loss_c, grads_c, _ = res[0]
        spread = {k: rel_l2(grads_n[k], grads_k[k]) for k in grads_k}
        grad_tol = {k: max(1e-3, 10.0 * spread[k]) for k in grads_k}
        entry = {"T": GRAD_T, "naccept": naccept, "loss_rel": abs(loss_k - loss_c) / abs(loss_c),
                 "grad_rel_l2": {k: rel_l2(grads_k[k], grads_c[k]) for k in grads_k},
                 "card_grad_spread_under_1e-7_nudge": spread,
                 "tol": {"loss": 1e-4, "grad": grad_tol}}
        check(entry["loss_rel"] < 1e-4
              and all(entry["grad_rel_l2"][k] < grad_tol[k] for k in grads_k),
              f"card vs CPU bench step: {entry}")
        return entry

    cpu_later("bench104_cpu_check", f"{GRAD_T}_points", compare, "parity", cfg,
              dict(columns_per_area=PARITY_CPA, time_steps=GRAD_T, max_steps=PARITY_MAX_STEPS),
              bench_flags, args=(first["stims"], first["keys"]), kwargs=dict(grid=grid),
              params_list=[first["params"]])
    emit("bench104_main_path", columns=sum(PARITY_CPA), lanes=B, T=PARITY_T,
         max_steps=PARITY_MAX_STEPS, flags=BENCH, history=history, launches=main_launches,
         cpu_check="bench104_cpu_check")

    # -- 29. kernel vs plain: the selection (select16) --------------------------------
    model = parity.sde_model(task.params, task, first["stims"])
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    w16 = premix_select16(pw)
    words = sa._sde_key_words(first["keys"], "jax")
    scfg = sa.select_config(task.ts, max_steps=PARITY_MAX_STEPS, brownian="jax",
                            drift="select16")
    y0 = torch.zeros(B, S, device=dev)
    # The whole selection of two lanes over BENCH104_SEL_T grid points.
    task_s = make_task(BENCH104_SEL_T, params=task.params)
    model_s = parity.sde_model(task_s.params, task_s, first["stims"][:2])
    scfg_s = sa.select_config(task_s.ts, max_steps=PARITY_MAX_STEPS, brownian="jax",
                              drift="select16")
    sel_k = ns.select_pass(y0[:2], words[:2].contiguous(), w16, model_s.sc, model_s.kv, scfg_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel_p = ns._select_plain(y0[:2], words[:2].contiguous(), w16, model_s.sc, model_s.kv, scfg_s)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(g, w) for g, w in zip(sel_k, sel_p))
    e_na = float(((sel_k[1] - sel_p[1]).abs().float() / sel_p[1].float()).max())
    e_t10 = float(((sel_k[0][:, :11] - sel_p[0][:, :11]).abs()
                   / sel_p[0][:, :11].clamp_min(1e-30)).max())
    check(bool(sel_k[3].all()) and same and e_na < 0.01 and e_t10 < 1e-6,
          f"jax-tree selection (select16) over {BENCH104_SEL_T} points: {sel_k[1].tolist()} vs "
          f"{sel_p[1].tolist()}, bit for bit {same}")
    # 8 attempts from states along the main path's first replay.
    st = first["stats"].step_times
    na0 = first["stats"].naccept
    ht, dw, i10 = sa._replay_grid(st, words, scfg.t_start, scfg.t_end, scfg.depth, "jax")
    w2 = {k: v.contiguous() for k, v in
          prepare_premixed_split2(pw, model.sc.fc)[0].items()}
    grid_f = (ht[:, :-1].T.contiguous(), (ht[:, 1:] - ht[:, :-1]).T.contiguous(),
              dw.T.contiguous(), i10.T.contiguous())
    ys = ns.replay_fwd(y0, *grid_f, 2 * int(na0.max()), w2, model.sc, model.kv)
    # B3 and B4 on 16 half steps in the middle of that grid, from the kernel's
    # state there, against their plain versions (phase 5's limits).
    W, k0 = 16, int(na0.max()) & ~1
    win = tuple(x[k0:k0 + W].contiguous() for x in grid_f)
    fwd = (ys[k0].contiguous(), *win, W, w2, model.sc, model.kv)
    ys_k, ys_p = ns.replay_fwd(*fwd), ns._replay_fwd_plain(*fwd)
    ysbar_w = torch.randn(W, B, S, generator=torch.Generator(device=dev).manual_seed(13),
                          device=dev)
    bwd = (ys_p[:-1].contiguous(), ysbar_w, win[0], win[1], win[3], W, 0, w2, model.sc,
           model.kv)
    (yb_k, seeds_k), (yb_p, seeds_p) = ns.replay_bwd(*bwd), ns._replay_bwd_plain(*bwd)
    replay_window = {"start": k0, "half_steps": W, "fwd_scaled": scaled_err(ys_k, ys_p),
                     "seeds_rel_l2": rel_l2_rows(seeds_k, seeds_p),
                     "carry_rel_l2": rel_l2_rows(yb_k[None], yb_p[None]),
                     "fwd": record_replay2("sde_replay_fwd", sum(PARITY_CPA), ys_k, ys_p),
                     "bwd": record_replay2("sde_replay_bwd", sum(PARITY_CPA), (seeds_k, yb_k),
                                           (seeds_p, yb_p))}
    check(all(bool(torch.isfinite(x).all()) for x in (ys_k, seeds_k, yb_k))
          and replay_window["fwd_scaled"] < 1e-4 and replay_window["seeds_rel_l2"] < 1e-4
          and replay_window["carry_rel_l2"] < 1e-4, f"bench replay window: {replay_window}")
    N = 8
    li = torch.arange(N, device=dev) % B
    ri = torch.tensor([2 * int((r // B) / 2 * (int(na0[r % B]) - 1)) for r in range(N)],
                      device=dev)
    t1 = st[li, ri // 2][:, None].contiguous()
    h = (st[li, ri // 2 + 1][:, None] - t1).contiguous()
    w_r, kv_r = words[li].contiguous(), model.kv[:, li].contiguous()
    att_args = (t1, ys[ri, li].contiguous(), h, torch.full((N, 1), 0.7, device=dev),
                ns._tree(w_r, scfg).evaluate(t1).contiguous(), w_r, w16, model.sc, kv_r, scfg)
    att, att_p = ns.select_attempt(*att_args), ns._attempt_plain(*att_args)
    att_same = all(torch.equal(g, w) for g, w in zip(att, att_p))
    e_err = float(((att.err - att_p.err).abs() / att_p.err.clamp_min(1e-30)).max())
    check(bool(torch.equal(att.accept, att_p.accept)) and att_same and e_err < 1e-5,
          f"jax-tree attempts (select16): err rel {e_err}, bit for bit {att_same}")
    emit("bench104_kernel_vs_plain", selection={"T": BENCH104_SEL_T, "lanes": 2,
                                                "naccept": sel_k[1].tolist(),
                                                "naccept_plain": sel_p[1].tolist(),
                                                "nreject": sel_k[2].tolist(),
                                                "nreject_plain": sel_p[2].tolist(),
                                                "bit_for_bit": same, "first10_rel": e_t10},
         attempts={"records": N, "bit_for_bit": att_same, "err_rel": e_err},
         replay_window=replay_window, replay_tol={"fwd_scaled": 1e-4, "seeds_rel_l2": 1e-4,
                                                  "carry_rel_l2": 1e-4},
         plain_ms_at_short_horizon=plain_ms)

    # -- 30. times, profile and the command line --------------------------------------
    ms = cuda_ms(lambda: ns.select_pass(y0, words, w16, model.sc, model.kv, scfg), reps=1,
                 warmup=0)
    attempts = int((first["stats"].naccept + first["stats"].nreject).sum())
    bound = jax_select_bound(P, B, n_in, K, attempts, PARITY_MAX_STEPS, False)
    serial = int((first["stats"].naccept + first["stats"].nreject).max())
    step_ms = step_s[-1] * 1e3
    short_ms, wall, by_kernel = short_profile(
        parity.make_train_step(make_task(SHORT_T), **BENCH),
        (make_parity_batch(gen, n_in, B, device=dev), lane_keys()))
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("bench104_step", ms_per_step=step_ms, samples_per_s=B * 1e3 / step_ms,
         select_ms=ms, attempts=attempts, select_bound_ms=bound[0], select_bound_by=bound[1],
         select_ns_per_attempt=ms * 1e6 / serial,
         profile={"T": SHORT_T, "step_ms": short_ms, "profiled_wall_ms_per_step": wall,
                  "device_busy_ms_per_step": busy if busy else "not measured",
                  "idle_share": 1.0 - busy / short_ms if busy else "not measured",
                  "top_ms_per_step": dict(top)})
    argv = ["--smoke", "--stochastic", "--adaptive", "--columns-per-area", "64,32,8",
            "--bptt-every", "32", "--clip-grad-norm", "1.0", "--loss-scale", "1e-6",
            "--max-steps", "16384"]
    defer_command_line("bench104_command_line", "parity", argv, timeout=900)
    return [{"name": "sde_select_jax_select16", "route": "cuda", "source": SDE_SOURCE,
             "replaces": "columnflow/solvers/sde_adaptive.py:314",
             "launches": main_launches["sde_select"],
             "max_abs_err": float((sel_k[0] - sel_p[0]).abs().max()), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None, "lanes": B, "path": "parity104 bench (--stochastic --adaptive)",
             "bit_for_bit": same, "plain_ms_at": f"{BENCH104_SEL_T} grid points, 2 lanes",
             "ns_per_serial_step": ms * 1e6 / serial}]


# The fixed-grid stochastic parity step at bench.py's width (columns (64, 32,
# 8), columnflow/tasks/parity.py:197-231, 771-788): SRA1 on the 999-step
# uniform grid of 1 s, one scalar Brownian per lane, the three-term split;
# from 64 columns the weights hold more than 1 MiB, so the weight gradients
# are taken outside the reverse sweep (B3t-team, B4t, the outer pass).
FG_CPA = (64, 32, 8)
FG_WIDE_CPA = (192, 96, 24)  # 312 columns, the widest the fused engine takes
FG_W = 64           # steps of each uniform kernel-vs-plain window at 104 columns
FG_LANES_W = 16     # steps of the per-lane window
FG_WIDE_W = 8       # steps of the 312-column window
FG_SOURCE = SDE3_TEAM_SOURCE


def outer_bound(P, B, n_in, K, steps):
    """(bound_ms, bound_by) of the outer weight-gradient pass over ``steps``
    steps: per step one drift (six products) and two drift VJPs (three
    state-side and three weight-side products each), 18 products of
    2 B P^2 operations, counted at the float32 rate; bytes: the states and
    seeds read once, the weights and the two gradients once."""
    S = 3 * P
    ops = steps * 18 * 2 * B * P * P
    nbytes = 2 * 4 * steps * B * S + 8 * (P * P + n_in * P) + 4 * (2 * P + K * B * n_in)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fixedgrid104_phases(dev, cfg):
    """Phases 31-34: the fixed-grid stochastic parity step at 104 columns
    (``--stochastic --columns-per-area 64,32,8``, outer mode); returns the
    entries of B3t-team and B4t for the kernels line."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import column_step, hopf_ode, network_ode, xor_ode, xor_sde
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.models.network import premix_select16
    from columnflow_torch.solvers import fused as sf
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(13)
    B, n_in, K = PARITY_B, 4, 4
    counters = (column_step.LAUNCHES, ns.LAUNCHES, network_ode.LAUNCHES, xor_ode.LAUNCHES,
                xor_sde.LAUNCHES, hopf_ode.LAUNCHES)

    def make_task(time_steps=PARITY_T, device=dev, params=None, cpa=FG_CPA):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=cpa, time_steps=time_steps, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def uniform(task, noise=None):
        t0s, h = sf.uniform_step_times(task.ts, (B, 3 * task.net.num_pops))
        t0s = t0s.to(dev)
        n = t0s.shape[0]
        if noise is None:
            _, i1, i10, _, _ = brownian_pack(gen, task.ts, (B, 1))
            noise = (i1, i10)
        i1, i10 = (x.reshape(n, B).contiguous() for x in noise)
        return t0s, torch.full_like(t0s, h), i1, i10

    def win(x, k0, w):
        return x[k0:k0 + w].contiguous()

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def compare(name, got, want):
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        same[name] = all(torch.equal(g, w) for g, w in zip(got, want))
        errs[name] = max(errs.get(name, 0.0), max(float((g - w).abs().max())
                                                  for g, w in zip(got, want)))
        check(same[name] and all(bool(torch.isfinite(g).all()) for g in got),
              f"{name} against its plain version: max abs {errs[name]}")

    # -- 31. kernel vs plain, bit for bit --------------------------------------------
    task = make_task()
    P = task.net.num_pops
    S = 3 * P
    stims = make_parity_batch(gen, n_in, B, device=dev)
    model = parity.sde_model(task.params, task, stims)
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    grid_u = uniform(task)
    n = grid_u[0].shape[0]
    y0 = torch.zeros(B, S, device=dev)
    check(ns.sde3_fwd_route(P, n_in) == "team", "104 columns must take B3t-team")
    ys = ns.replay3_fwd(y0, *grid_u, n, pw, model.sc, model.kv)
    ysbar = torch.randn(n, B, S, generator=gen, device=dev)
    same, errs, plain_ms, windows = {}, {}, {}, []
    for k0 in (0, (n // 2) & ~7, n - FG_W):
        g = tuple(win(x, k0, FG_W) for x in grid_u)
        fwd = (g[0], g[1], g[2], g[3], FG_W, pw, model.sc, model.kv)
        got = ns.replay3_fwd(ys[k0].contiguous(), *fwd)
        want, ms_f = timed(lambda: ns._replay3_fwd_plain(ys[k0].contiguous(), *fwd))
        compare("sde3_fwd_team", got, want)
        check(torch.equal(got, ys[k0:k0 + FG_W + 1]), "B3t-team window against its whole sweep")
        bwd = (win(ys, k0, FG_W), win(ysbar, k0, FG_W), g[0], g[1], g[3], FG_W, 0, pw, model.sc,
               model.kv)
        got = ns.replay3_bwd_emit(*bwd)
        want, ms_b = timed(lambda: ns._replay3_bwd_emit_plain(*bwd))
        compare("sde3_bwd_emit", got, want)
        windows.append(k0)
        plain_ms["sde3_fwd_team"], plain_ms["sde3_bwd_emit"] = ms_f, ms_b
    # Per-lane grids from a lanes replay: bench.py's selection over
    # BENCH_SEL_T points, its half-step grid and noise, one window of it.
    task_s = make_task(BENCH_SEL_T, params=task.params)
    model_s = parity.sde_model(task_s.params, task_s, stims)
    scfg = sa.select_config(task_s.ts, max_steps=PARITY_MAX_STEPS, brownian="jax",
                            drift="select16")
    words = sa._sde_key_words(torch.randint(0, 2**32, (B, 2), generator=gen, device=dev,
                                            dtype=torch.int64), "jax")
    st, na, _, _ = ns.select_pass(y0, words, premix_select16(pw), model_s.sc, model_s.kv, scfg)
    ht, dw, i10 = sa._replay_grid(st, words, scfg.t_start, scfg.t_end, scfg.depth, "jax")
    n_l = 2 * int(na.max())
    grid_l = tuple(x.contiguous() for x in (ht[:, :n_l].T, (ht[:, 1:n_l + 1] - ht[:, :n_l]).T,
                                            dw[:, :n_l].T, i10[:, :n_l].T))
    ys_l = ns.replay3_fwd(y0, *grid_l, n_l, pw, model_s.sc, model_s.kv)
    k0 = (n_l // 2) & ~1
    g = tuple(win(x, k0, FG_LANES_W) for x in grid_l)
    fwd = (g[0], g[1], g[2], g[3], FG_LANES_W, pw, model_s.sc, model_s.kv)
    compare("sde3_fwd_team", ns.replay3_fwd(ys_l[k0].contiguous(), *fwd),
            ns._replay3_fwd_plain(ys_l[k0].contiguous(), *fwd))
    ysbar_l = torch.randn(FG_LANES_W, B, S, generator=gen, device=dev)
    bwd = (win(ys_l, k0, FG_LANES_W), ysbar_l, g[0], g[1], g[3], FG_LANES_W, 0, pw, model_s.sc,
           model_s.kv)
    compare("sde3_bwd_emit", ns.replay3_bwd_emit(*bwd), ns._replay3_bwd_emit_plain(*bwd))
    # 312 columns: one window from states in the rates' working range.
    task_w = make_task(cpa=FG_WIDE_CPA)
    P_w = task_w.net.num_pops
    model_w = parity.sde_model(task_w.params, task_w, stims)
    pw_w = {k: v.detach().contiguous() for k, v in model_w.pw.items()}
    grid_w = tuple(win(x, n // 2, FG_WIDE_W) for x in uniform(task_w))
    a = 5.0 * torch.rand(B, P_w, generator=gen, device=dev)
    y_w = torch.cat([a + 80.0 * torch.rand(B, P_w, generator=gen, device=dev) - 40.0, a,
                     40.0 * torch.rand(B, P_w, generator=gen, device=dev)], dim=1)
    fwd = (*grid_w, FG_WIDE_W, pw_w, model_w.sc, model_w.kv)
    ys_w = ns.replay3_fwd(y_w, *fwd)
    compare("sde3_fwd_team_312", ys_w, ns._replay3_fwd_plain(y_w, *fwd))
    bwd = (ys_w[:-1].contiguous(), torch.randn(FG_WIDE_W, B, 3 * P_w, generator=gen, device=dev),
           grid_w[0], grid_w[1], grid_w[3], FG_WIDE_W, 0, pw_w, model_w.sc, model_w.kv)
    compare("sde3_bwd_emit_312", ns.replay3_bwd_emit(*bwd), ns._replay3_bwd_emit_plain(*bwd))
    emit("fixedgrid104_kernel_vs_plain", columns=sum(FG_CPA), P=P, lanes=B, T=PARITY_T,
         steps=n, uniform_windows={"start": windows, "steps": FG_W},
         lanes_window={"selection_T": BENCH_SEL_T, "naccept": na.tolist(), "n_real": n_l,
                       "start": k0, "steps": FG_LANES_W},
         wide={"columns": sum(FG_WIDE_CPA), "P": P_w, "steps": FG_WIDE_W},
         bit_for_bit=same, max_abs_err=errs, plain_ms_per_window=plain_ms)
    del task_w, model_w, pw_w, ys_w

    # -- 32. main path: 2 train steps through make_train_step --------------------------
    task = make_task()
    step = parity.make_train_step(task, stochastic=True)
    for c in counters:
        for k in c:
            c[k] = 0
    history, step_s, first = [], [], None
    for i in range(2):
        stims_i = make_parity_batch(gen, n_in, B, device=dev)
        _, i1, i10, _, _ = brownian_pack(gen, task.ts, (B, 1))
        params_i = {k: p.detach().cpu().clone() for k, p in task.params.items()}
        before = [dict(c) for c in counters]
        rec, ms = timed(lambda: step(stims_i, noise=(i1, i10)))
        step_s.append(ms / 1e3)
        moved = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c if c[k] != b[k]}
        check(moved == {"sde3_fwd_team": 1, "sde3_bwd_emit": 1}, f"fixed-grid step {i}: {moved}")
        check(bool(torch.isfinite(rec["loss"])), f"fixed-grid step {i}: loss {rec['loss']}")
        history.append({"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                        "update_applied": bool(rec["ok"]), "seconds": ms / 1e3})
        if i == 0:
            first = dict(stims=stims_i, params=params_i)
    main_launches = {k: v for c in counters for k, v in c.items() if v}

    # -- 33. card against CPU over short horizons --------------------------------------
    # At 104 columns the gradients are ill-conditioned (a 1e-7 nudge of the
    # weights moves them by O(1) over 100 points), so every gradient is
    # held over GRAD_T points and the output weights' over OUT_T, each
    # against the card's own spread under such a nudge; the noise is the
    # card's pack for that grid. SRA1 at h = 1 ms runs off at this width
    # from the fourth step, in the JAX package too (RESULTS.md: max|y|
    # 2.9e10): a gradient that is not finite on the CPU must not be finite
    # on the card either, and is reported; the loss is held within the
    # larger of 1e-5 and ten times its own nudge spread.
    def one(params, T_check, noise):
        t = make_task(T_check, params=params)
        rec = parity.make_train_step(t, stochastic=True)(first["stims"], noise=noise)
        return rec, {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}

    def finite(x):
        return bool(torch.isfinite(x).all())

    def compare(res, T_check, held, loss_k, gnorm_k, grads_k, loss_n, grads_n):
        loss_c, grads_c, _ = res[0]
        keys = [k for k in (held or grads_k) if finite(grads_c[k])]
        not_finite = [k for k in (held or grads_k) if not finite(grads_c[k])]
        spread = {k: rel_l2(grads_n[k], grads_k[k]) for k in keys}
        tol = {k: max(3e-2, 10.0 * spread[k]) for k in keys}
        loss_tol = max(1e-5, 10.0 * abs(loss_n - loss_k) / abs(loss_k))
        entry = {"T": T_check, "held": keys, "not_finite_on_either": not_finite,
                 "loss": loss_k, "loss_rel": abs(loss_k - loss_c) / abs(loss_c),
                 "loss_tol": loss_tol, "grad_norm": gnorm_k,
                 "grad_rel_l2": {k: rel_l2(grads_k[k], grads_c[k]) for k in keys},
                 "card_grad_spread_under_1e-7_nudge": spread, "tol": tol}
        check(entry["loss_rel"] < loss_tol
              and all(entry["grad_rel_l2"][k] < tol[k] <= GRAD_TOL_CAP for k in keys)
              and not any(finite(grads_k[k]) for k in not_finite),
              f"card vs CPU fixed-grid step at 104 columns: {entry}")
        return entry

    for T_check, held in ((GRAD_T, None), (OUT_T, ("output_weights",))):
        _, i1, i10, _, _ = brownian_pack(gen, make_task(T_check).ts, (B, 1))
        rec_k, grads_k = one(first["params"], T_check, (i1, i10))
        rec_n, grads_n = one({k: v * (1.0 + 1e-7) for k, v in first["params"].items()},
                             T_check, (i1, i10))
        cpu_later("fixedgrid104_cpu_check", f"{T_check}_points",
                  lambda res, a=(T_check, held, float(rec_k["loss"]), float(rec_k["gnorm"]),
                                 grads_k, float(rec_n["loss"]), grads_n): compare(res, *a),
                  "parity", cfg, dict(columns_per_area=FG_CPA, time_steps=T_check),
                  dict(stochastic=True), args=(first["stims"],),
                  kwargs=dict(noise=(i1, i10)), params_list=[first["params"]])
    emit("fixedgrid104_main_path", columns=sum(FG_CPA), lanes=B, T=PARITY_T, history=history,
         launches=main_launches, cpu_check="fixedgrid104_cpu_check")

    # -- 34. times, profile and the command line -----------------------------------
    model = parity.sde_model(task.params, task, first["stims"])
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    ys = ns.replay3_fwd(y0, *grid_u, n, pw, model.sc, model.kv)
    _, seeds = ns.replay3_bwd_emit(ys[:-1], ysbar, grid_u[0], grid_u[1], grid_u[3], n, 0, pw,
                                   model.sc, model.kv)
    t0o, ho = sf.outer_step_times(task.ts)
    t0o = t0o.to(dev)
    calls = {
        "sde3_fwd_team": lambda: ns.replay3_fwd(y0, *grid_u, n, pw, model.sc, model.kv),
        "sde3_bwd_emit": lambda: ns.replay3_bwd_emit(ys[:-1], ysbar, grid_u[0], grid_u[1],
                                                     grid_u[3], n, 0, pw, model.sc, model.kv),
        "outer_arg_grads_split3": lambda: sf.outer_arg_grads_split3(
            ys[:-1], seeds, t0o, torch.full_like(t0o, ho), grid_u[3], pw, model.sc, model.kv),
    }
    times = {name: cuda_ms(fn, reps=2, warmup=1) for name, fn in calls.items()}
    bounds = {"sde3_fwd_team": sde3_bound("sde3_fwd", P, B, n_in, K, B * n, n),
              "sde3_bwd_emit": sde3_bound("sde3_bwd_emit", P, B, n_in, K, B * n, n),
              "outer_arg_grads_split3": outer_bound(P, B, n_in, K, n)}
    step_ms = step_s[-1] * 1e3
    seed = {k: p.detach().clone() for k, p in task.params.items()}
    _, i1p, i10p, _, _ = brownian_pack(gen, task.ts, (B, 1))

    def seed_step(i=0):
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(seed[k])
        return step(first["stims"], noise=(i1p, i10p))

    seed_step()
    seed_ms = timed(seed_step)[1]
    wall, by_kernel = device_profile(seed_step, 1)
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("fixedgrid104_times", lanes=B, T=PARITY_T, steps=n, ms=times,
         ns_per_step={k: v * 1e6 / n for k, v in times.items()},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()},
         plain_ms={**plain_ms, "at": f"{FG_W} steps"},
         step={"ms": step_ms, "samples_per_s": B * 1e3 / step_ms, "seconds": step_s},
         profile={"step_ms": seed_ms, "profiled_wall_ms_per_step": wall,
                  "device_busy_ms_per_step": busy if busy else "not measured",
                  "idle_share": 1.0 - busy / seed_ms if busy else "not measured",
                  "top_ms_per_step": dict(top)})
    argv = ["--smoke", "--stochastic", "--columns-per-area", "64,32,8"]
    defer_command_line("fixedgrid104_command_line", "parity", argv)
    path = "parity104 --stochastic (fixed grid, outer mode)"
    return [{"name": name, "route": "cuda", "source": FG_SOURCE,
             "replaces": ("columnflow/solvers/fused.py:845" if name == "sde3_fwd_team"
                          else "columnflow/solvers/fused.py:920"),
             "launches": main_launches[name], "max_abs_err": errs[name], "ms": times[name],
             "plain_ms": plain_ms[name], "plain_ms_at": f"{FG_W} steps",
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
             "lanes": B, "path": path, "bit_for_bit": same[name],
             "bit_for_bit_312_columns": same[name + "_312"],
             "ns_per_serial_step": times[name] * 1e6 / n}
            for name in ("sde3_fwd_team", "sde3_bwd_emit")]

# The exact three-term stochastic-adaptive step at bench.py's width
# (--stochastic --adaptive --engine fused --columns-per-area 64,32,8: the
# jax.random tree's selection on the float32 drift, the replay on the
# three-term split, its weight gradients outside the sweep on the lanes'
# own step times), with --fused-pass (B5t: the selection on the three-term
# split, krng tree) and --grad-bf16 (the gradbf16 substitute); and the
# kernel-mode step past one block's capacity at 32 columns (B4't-team).
EXACT = dict(stochastic=True, adaptive=True, bptt_every=32, clip_grad_norm=1.0,
             loss_scale=1e-6)
EX_CPA = (64, 32, 8)
EX_13_CPA = (8, 4, 1)
EX_32_CPA = (16, 8, 8)   # 32 columns: B4't-team on the command line's path
EX_63_CPA = (32, 24, 7)  # 63 columns: the widest kernel-mode width
EX_W = 64                # half steps of each kernel-mode sweep window
# Grid points of B5t's whole selection at 13 columns held against its plain
# loop (the full second's plain loop took 101.6 s on the card, 200 points
# 69 s: cut in depth in PR 10 to keep the script under 1000 s; the kernel is
# timed over the whole second).
EX_B5T13_T = 25     # (over 50 points its plain loop took 10 s)
GRAD_TOL_CAP = 0.25      # no gradient limit of a card-vs-CPU step may exceed this rel L2
KRNG_NORMAL_OPS = 150    # a krng normal: one Threefry-2x32 hash and ndtri


def split3_select_bound(P, B, n_in, K, attempts, M):
    """(bound_ms, bound_by) of the selection on the three-term split (B5t):
    per attempt 5 drift evaluations of six bf16 (P, P) products at the bf16
    rate, the elementwise work and 44 krng normals at the float32 rate;
    bytes: the three bf16 terms and iwT once, y0, the key words and the
    grids."""
    S, prod = 3 * P, 2 * P * P
    ops16 = attempts * 5 * 6 * prod
    ops32 = attempts * (5 * (30 * P + 8 * S) + 36 * S + 44 * KRNG_NORMAL_OPS)
    nbytes = (6 * P * P + 4 * n_in * P + 4 * (2 * P + K * B * n_in) + 4 * B * S + 16 * B
              + 4 * B * (M + 1) + 12 * B)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops16 / BF16_FLOPS + ops32 / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exact104_phases(dev, cfg):
    """Phases 35-41: the exact three-term stochastic-adaptive step at 104
    columns (and with --fused-pass, --grad-bf16), the kernel-mode step at
    32 columns; returns the entries of the f32 selection at 104 columns,
    B3t-team and B4t in lanes mode, B5t and B4't-team."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import column_step, hopf_ode, network_ode, xor_ode, xor_sde
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.solvers import fused as sf
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(17)
    B, n_in, K = PARITY_B, 4, 4
    counters = (column_step.LAUNCHES, ns.LAUNCHES, network_ode.LAUNCHES, xor_ode.LAUNCHES,
                xor_sde.LAUNCHES, hopf_ode.LAUNCHES)

    def make_task(time_steps=PARITY_T, device=dev, params=None, cpa=EX_CPA, max_steps=None):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=cpa, time_steps=time_steps,
                                 max_steps=max_steps or (PARITY_MAX_STEPS if sum(cpa) >= 64
                                                         else S13_MAX_STEPS), device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def lane_keys(n=B):
        return torch.randint(0, 2**32, (n, 2), generator=gen, device=dev, dtype=torch.int64)

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    same, errs, plain_ms = {}, {}, {}

    def compare(name, got, want):
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        same[name] = same.get(name, True) and ok
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        errs[name] = max(errs.get(name, 0.0), err)
        check(ok and all(bool(torch.isfinite(g).all()) for g in got if g.is_floating_point()),
              f"{name} against its plain version: max abs {err}")

    def lanes_grid(sel, words, scfg, brownian):
        """The half-step grid of a selection (step_times, naccept, ...), its
        first 2 x max(naccept) steps: (t0s, hs, dw, i10) each (n, B), and n."""
        st, na = sel[0], sel[1]
        ht, dw, i10 = sa._replay_grid(st, words, scfg.t_start, scfg.t_end, scfg.depth, brownian)
        n = 2 * int(na.max())
        return tuple(x.contiguous() for x in (ht[:, :n].T, (ht[:, 1:n + 1] - ht[:, :n]).T,
                                              dw[:, :n].T, i10[:, :n].T)), n

    def attempts(ys, sel, words, n_rec, w, sc, kv, scfg):
        """n_rec attempts from states along a lanes replay ys of the
        selection sel, at 1, 1.5 and 2 times the accepted step there: the
        arguments of select_attempt."""
        st, na = sel[0], sel[1]
        li = torch.arange(n_rec, device=dev) % B
        ri = torch.tensor([2 * int((r // B) / max(1, n_rec // B) * (int(na[r % B]) - 1))
                           for r in range(n_rec)], device=dev)
        fac = torch.tensor([1.0 + 0.5 * ((r // B) % 3) for r in range(n_rec)], device=dev)[:, None]
        t1 = st[li, ri // 2][:, None].contiguous()
        h = ((st[li, ri // 2 + 1][:, None] - t1) * fac).contiguous()
        w_r, kv_r = words[li].contiguous(), kv[:, li].contiguous()
        w_t1 = ns._tree(w_r, scfg).evaluate(t1).contiguous()
        return (t1, ys[ri, li].contiguous(), h, torch.full((n_rec, 1), 0.7, device=dev), w_t1,
                w_r, w, sc, kv_r, scfg)

    # -- 35. kernel vs plain: the f32 jax-tree selection at 104 columns, B3t-team
    # and B4t in lanes mode on its grid, B4t lanes at 13 columns -------------------
    task = make_task()
    P = task.net.num_pops
    S = 3 * P
    y0 = torch.zeros(B, S, device=dev)
    stims = make_parity_batch(gen, n_in, B, device=dev)
    task_s = make_task(BENCH_SEL_T, params=task.params)
    model_s = parity.sde_model(task_s.params, task_s, stims)
    pw = {k: v.detach().contiguous() for k, v in model_s.pw.items()}
    words_j = sa._sde_key_words(lane_keys(), "jax")
    scfg_j = sa.select_config(task_s.ts, max_steps=PARITY_MAX_STEPS, brownian="jax", drift="f32")
    sel_k = ns.select_pass(y0, words_j, pw, model_s.sc, model_s.kv, scfg_j)
    sel_p, plain_ms["sde_select_jax_f32_104"] = timed(
        lambda: ns._select_plain(y0, words_j, pw, model_s.sc, model_s.kv, scfg_j))
    compare("sde_select_jax_f32_104", sel_k, sel_p)
    check(bool(sel_k[3].all()), f"f32 selection at 104 columns: success {sel_k[3].tolist()}")
    grid_l, n_l = lanes_grid(sel_k, words_j, scfg_j, "jax")
    ys_l = ns.replay3_fwd(y0, *grid_l, n_l, pw, model_s.sc, model_s.kv)
    ys_lp, plain_ms["sde3_fwd_team_lanes"] = timed(
        lambda: ns._replay3_fwd_plain(y0, *grid_l, n_l, pw, model_s.sc, model_s.kv))
    compare("sde3_fwd_team_lanes", ys_l, ys_lp)
    ysbar_l = torch.randn(n_l, B, S, generator=gen, device=dev)
    bwd = (ys_l[:-1].contiguous(), ysbar_l, grid_l[0], grid_l[1], grid_l[3], n_l, 64, pw,
           model_s.sc, model_s.kv)
    got = ns.replay3_bwd_emit(*bwd)
    want, plain_ms["sde3_bwd_emit_lanes"] = timed(lambda: ns._replay3_bwd_emit_plain(*bwd))
    compare("sde3_bwd_emit_lanes", got, want)
    att_args = attempts(ys_l, sel_k, words_j, 8, pw, model_s.sc, model_s.kv, scfg_j)
    compare("sde_select_jax_f32_104", ns.select_attempt(*att_args), ns._attempt_plain(*att_args))
    # B3t-team's and B4t's routes on a window of the lanes grid (the shape's
    # route, the other one, team8; the same call).
    sde3_routes = {"sde3_fwd_team": {}, "sde3_bwd_emit": {}}

    def route_times(key, y, grid, w, ybar_w, pw_r, sc_r, kv_r, lanes):
        n_in_r, Pr = kv_r.shape[2], y.shape[-1] // 3
        for name, bwd in (("sde3_fwd_team", False), ("sde3_bwd_emit", True)):
            plan = ns._sde3_team(None, Pr, n_in_r, B, bwd)
            if bwd:
                def run(r):
                    return ns.replay3_bwd_emit(y[:w].contiguous(), ybar_w, grid[0], grid[1],
                                               grid[3], w, 64 if lanes else 0, pw_r, sc_r, kv_r,
                                               route=r)
            else:
                def run(r):
                    return ns.replay3_fwd(y[0].contiguous(), *grid, w, pw_r, sc_r, kv_r, route=r)
            sde3_routes[name][key] = {"P": Pr, "C": plan.C, "f32": plan.f32,
                                      **team_routes(run, w, "streamed" if plan.stream
                                                    else "resident")}

    w_r = min(ROUTE_W, n_l)
    route_times("104_lanes", ys_l, tuple(x[:w_r].contiguous() for x in grid_l), w_r,
                ysbar_l[:w_r].contiguous(), pw, model_s.sc, model_s.kv, True)
    # 13 columns: B4t lanes at P = 104 (the --grad-bf16 path at the default width).
    task13 = make_task(BENCH_SEL_T, cpa=EX_13_CPA)
    P13 = task13.net.num_pops
    model13 = parity.sde_model(task13.params, task13, stims)
    pw13 = {k: v.detach().contiguous() for k, v in model13.pw.items()}
    y0_13 = torch.zeros(B, 3 * P13, device=dev)
    scfg13 = sa.select_config(task13.ts, max_steps=S13_MAX_STEPS, brownian="jax", drift="f32")
    sel13 = ns.select_pass(y0_13, words_j, pw13, model13.sc, model13.kv, scfg13)
    grid13, n13 = lanes_grid(sel13, words_j, scfg13, "jax")
    ys13 = ns.replay3_fwd(y0_13, *grid13, n13, pw13, model13.sc, model13.kv)
    bwd13 = (ys13[:-1].contiguous(), torch.randn(n13, B, 3 * P13, generator=gen, device=dev),
             grid13[0], grid13[1], grid13[3], n13, 0, pw13, model13.sc, model13.kv)
    compare("sde3_bwd_emit_lanes_13", ns.replay3_bwd_emit(*bwd13),
            ns._replay3_bwd_emit_plain(*bwd13))
    emit("exact104_kernel_vs_plain", columns=sum(EX_CPA), P=P, lanes=B,
         selection={"T": BENCH_SEL_T, "naccept": sel_k[1].tolist(),
                    "nreject": sel_k[2].tolist(), "attempts": 8},
         lanes_replay={"n_real": n_l, "stride": 64}, lanes_13={"P": P13, "n_real": n13},
         bit_for_bit=dict(same), max_abs_err=dict(errs), plain_ms=dict(plain_ms))

    # -- 36. B5t against its plain version: 13 columns over EX_B5T13_T points of
    # the second (timed over the whole second in phase 39), 104 columns over
    # BENCH_SEL_T points and 8 attempts -----------------------------------------------
    words_k = sa._sde_key_words(lane_keys(), "kernel")
    task13f = make_task(PARITY_T, params=task13.params, cpa=EX_13_CPA)
    model13f = parity.sde_model(task13f.params, task13f, stims)
    w3_13 = ns.select_weights_split3(pw13, model13f.sc)
    scfg_k13 = sa.select_config(task13f.ts, max_steps=S13_MAX_STEPS, brownian="kernel",
                                drift="split3")
    scfg_k13w = sa.select_config(task13f.ts[:EX_B5T13_T], max_steps=S13_MAX_STEPS,
                                 brownian="kernel", drift="split3")
    b5t_13 = ns.select_pass(y0_13, words_k, w3_13, model13f.sc, model13f.kv, scfg_k13w)
    want, plain_ms["sde_select_krng_split3_13"] = timed(
        lambda: ns._select_plain(y0_13, words_k, w3_13, model13f.sc, model13f.kv, scfg_k13w))
    compare("sde_select_krng_split3", b5t_13, want)
    w3 = ns.select_weights_split3(pw, model_s.sc)
    scfg_k = sa.select_config(task_s.ts, max_steps=PARITY_MAX_STEPS, brownian="kernel",
                              drift="split3")
    b5t = ns.select_pass(y0, words_k, w3, model_s.sc, model_s.kv, scfg_k)
    want, plain_ms["sde_select_krng_split3"] = timed(
        lambda: ns._select_plain(y0, words_k, w3, model_s.sc, model_s.kv, scfg_k))
    compare("sde_select_krng_split3", b5t, want)
    check(bool(b5t[3].all()), f"B5t over {BENCH_SEL_T} points: success {b5t[3].tolist()}")
    att_args = attempts(ys_l, sel_k, words_k, 8, w3, model_s.sc, model_s.kv, scfg_k)
    compare("sde_select_krng_split3", ns.select_attempt(*att_args), ns._attempt_plain(*att_args))
    emit("exact104_b5t_vs_plain", window_13={"T": EX_B5T13_T, "naccept": b5t_13[1].tolist(),
                                              "nreject": b5t_13[2].tolist(),
                                              "success": b5t_13[3].tolist()},
         window_104={"T": BENCH_SEL_T, "naccept": b5t[1].tolist(),
                     "nreject": b5t[2].tolist(), "attempts": 8},
         bit_for_bit=same["sde_select_krng_split3"],
         max_abs_err=errs["sde_select_krng_split3"],
         plain_ms={k: v for k, v in plain_ms.items() if "split3" in k})

    # -- 37. B4't-team against its plain version at 32 and 63 columns (the
    # uniform grid and a lanes window), and against B4't at 13 columns -----------------
    team_windows = {}
    for cpa in (EX_32_CPA, EX_63_CPA):
        t_w = make_task(PARITY_T, cpa=cpa)
        Pw = t_w.net.num_pops
        check(ns.sde3_bwd_route(Pw, n_in, B) == "team", f"{sum(cpa)} columns must take the team")
        m_w = parity.sde_model(t_w.params, t_w, stims)
        pw_w = {k: v.detach().contiguous() for k, v in m_w.pw.items()}
        y0_w = torch.zeros(B, 3 * Pw, device=dev)
        t0u, hu = sf.uniform_step_times(t_w.ts, (B, 3 * Pw))
        t0u = t0u.to(dev)
        _, i1u, i10u, _, _ = brownian_pack(gen, t_w.ts, (B, 1))
        nu = t0u.shape[0]
        grid_u = (t0u, torch.full_like(t0u, hu), i1u.reshape(nu, B).contiguous(),
                  i10u.reshape(nu, B).contiguous())
        ys_u = ns.replay3_fwd(y0_w, *grid_u, nu, pw_w, m_w.sc, m_w.kv)
        k0 = (nu // 2) & ~7
        win = tuple(x[k0:k0 + EX_W].contiguous() for x in grid_u)
        if cpa == EX_32_CPA:  # B3t-team at 32 columns (kernel mode's replay)
            fwd32 = (ys_u[k0].contiguous(), *win, EX_W, pw_w, m_w.sc, m_w.kv)
            got = ns.replay3_fwd(*fwd32)
            want, plain_ms["sde3_fwd_team_32"] = timed(lambda: ns._replay3_fwd_plain(*fwd32))
            compare("sde3_fwd_team_32", got, want)
            route_times("32_uniform", ys_u, tuple(x[:ROUTE_W].contiguous() for x in grid_u),
                        ROUTE_W, torch.randn(ROUTE_W, B, 3 * Pw, generator=gen, device=dev),
                        pw_w, m_w.sc, m_w.kv, False)
        chunk = sf.sweep_chunk((B, 3 * Pw), EX_W, 32)
        bwd = (ys_u[k0:k0 + EX_W].contiguous(),
               torch.randn(EX_W, B, 3 * Pw, generator=gen, device=dev), win[0], win[1], win[3],
               EX_W, 16, chunk, pw_w, m_w.sc, m_w.kv)
        got = ns.replay3_bwd(*bwd)
        want, ms = timed(lambda: ns._replay3_bwd_plain(*bwd))
        compare("sde3_bwd_team", got, want)
        plain_ms[f"sde3_bwd_team_{sum(cpa)}"] = ms
        t_sw = make_task(BENCH_SEL_T, params=t_w.params, cpa=cpa)
        m_sw = parity.sde_model(t_sw.params, t_sw, stims)
        scfg_w = sa.select_config(t_sw.ts, max_steps=PARITY_MAX_STEPS, brownian="jax",
                                  drift="f32")
        sel_w = ns.select_pass(y0_w, words_j, pw_w, m_sw.sc, m_sw.kv, scfg_w)
        grid_w, n_w = lanes_grid(sel_w, words_j, scfg_w, "jax")
        ys_w = ns.replay3_fwd(y0_w, *grid_w, n_w, pw_w, m_sw.sc, m_sw.kv)
        w_n = min(EX_W, n_w)
        k0 = max(0, min((n_w // 2) & ~1, n_w - w_n))
        win = tuple(x[k0:k0 + w_n].contiguous() for x in grid_w)
        bwd = (ys_w[k0:k0 + w_n].contiguous(),
               torch.randn(w_n, B, 3 * Pw, generator=gen, device=dev), win[0], win[1], win[3],
               w_n, 16, chunk, pw_w, m_sw.sc, m_sw.kv)
        compare("sde3_bwd_team", ns.replay3_bwd(*bwd), ns._replay3_bwd_plain(*bwd))
        team_windows[sum(cpa)] = {"P": Pw, "uniform_start": (nu // 2) & ~7, "steps": EX_W,
                                  "lanes_start": k0, "lanes_steps": w_n, "chunk": chunk}
    w_n = min(EX_W, n13)
    k0 = max(0, min((n13 // 2) & ~1, n13 - w_n))
    win = tuple(x[k0:k0 + w_n].contiguous() for x in grid13)
    bwd = (ys13[k0:k0 + w_n].contiguous(), torch.randn(w_n, B, 3 * P13, generator=gen, device=dev),
           win[0], win[1], win[3], w_n, 16, 10, pw13, model13.sc, model13.kv)
    by_shape = ns.sde3_bwd_route
    ns.sde3_bwd_route = lambda *a: "team"  # both fit at 13 columns: force the team
    try:
        team13 = ns.replay3_bwd(*bwd)
    finally:
        ns.sde3_bwd_route = by_shape
    compare("sde3_bwd_team", team13, ns.replay3_bwd(*bwd))
    compare("sde3_bwd_team", team13, ns._replay3_bwd_plain(*bwd))
    emit("exact104_team_routes", sde3_fwd_team_32={
        "start": team_windows[sum(EX_32_CPA)]["uniform_start"], "steps": EX_W,
        "bit_for_bit": same["sde3_fwd_team_32"], "max_abs_err": errs["sde3_fwd_team_32"]},
        team_routes=sde3_routes)
    emit("exact104_b4t_team_vs_plain", windows=team_windows,
         against_one_block_13={"P": P13, "start": k0, "steps": w_n},
         bit_for_bit=same["sde3_bwd_team"], max_abs_err=errs["sde3_bwd_team"],
         plain_ms={k: v for k, v in plain_ms.items() if k.startswith("sde3_bwd_team")})

    # -- 38. main path: one exact step at 104 columns over the full second -------------
    def zero_counters():
        for c in counters:
            for k in c:
                c[k] = 0

    def read_counters():
        return {k: v for c in counters for k, v in c.items() if v}

    def drive(flags, T=PARITY_T, cpa=EX_CPA, fixed=False, log=None):
        """One train step of ``flags`` with the counters zeroed just before
        it and read just after: (record, launches, seconds, what to repeat it).
        With ``log``, CUDA events around each call of the selection, the
        replay, its sweep and the outer pass go there (``event_timed``)."""
        t = make_task(T, cpa=cpa)
        step = parity.make_train_step(t, **flags)
        stims_i = make_parity_batch(gen, n_in, B, device=dev)
        keys, noise = None, None
        if fixed:
            _, i1, i10, _, _ = brownian_pack(gen, t.ts, (B, 1))
            noise = (i1, i10)
        else:
            keys = lane_keys()
        params_i = {k: p.detach().cpu().clone() for k, p in t.params.items()}
        restore = [] if log is None else [
            event_timed(sa, ("select_pass",), log),
            event_timed(sf, ("replay3_fwd", "replay3_bwd_emit", "outer_arg_grads_split3"), log)]
        zero_counters()
        try:
            rec, ms = timed(lambda: step(stims_i, keys, noise=noise))
        finally:
            for r in restore:
                r()
        launched = read_counters()
        return rec, launched, ms / 1e3, dict(stims=stims_i, keys=keys, params=params_i,
                                             fixed=fixed)

    def card_vs_cpu(flags, first, T_check, key, cpa=EX_CPA, floor=3e-2):
        """The step again on the CPU with the plain versions on the card's
        grid (and noise) over T_check points, beside the card's own spread
        under a 1e-7 nudge: the loss within the larger of 1e-5 and ten times
        its nudge spread, each finite gradient within the larger of ``floor``
        and ten times its spread, a limit that must stay at most
        GRAD_TOL_CAP (a larger one would pass a wrong step); a gradient not
        finite on the CPU must not be finite on the card either. The CPU
        half runs on the workers (``cpu_later``) under ``key``; returns where
        its entry is reported."""
        flags = {**flags, "clip_grad_norm": None}
        noise = None
        if first["fixed"]:
            _, i1, i10, _, _ = brownian_pack(gen, make_task(T_check, cpa=cpa).ts, (B, 1))
            noise = (i1, i10)

        def one(params, grid=None):
            t = make_task(T_check, params=params, cpa=cpa)
            rec = parity.make_train_step(t, **flags)(first["stims"], first["keys"], grid=grid,
                                                     noise=noise)
            return rec, {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}

        rec_k, grads_k = one(first["params"])
        grid = None
        if rec_k["stats"] is not None:
            sk = rec_k["stats"]
            grid = (sk.step_times, sk.naccept, sk.nreject)
        rec_n, grads_n = one({k: v * (1.0 + 1e-7) for k, v in first["params"].items()}, grid)
        loss_k, loss_n = float(rec_k["loss"]), float(rec_n["loss"])
        naccept = None if grid is None else grid[1].tolist()

        def finite(x):
            return bool(torch.isfinite(x).all())

        def compare(res):
            loss_c, grads_c, _ = res[0]
            keys = [k for k in grads_k if finite(grads_c[k])]
            not_finite = [k for k in grads_k if not finite(grads_c[k])]
            spread = {k: rel_l2(grads_n[k], grads_k[k]) for k in keys}
            tol = {k: max(floor, 10.0 * spread[k]) for k in keys}
            loss_tol = max(1e-5, 10.0 * abs(loss_n - loss_k) / abs(loss_k))
            entry = {"T": T_check, "held": keys, "not_finite_on_either": not_finite,
                     "loss": loss_k, "loss_rel": abs(loss_k - loss_c) / abs(loss_c),
                     "loss_tol": loss_tol,
                     "grad_rel_l2": {k: rel_l2(grads_k[k], grads_c[k]) for k in keys},
                     "card_grad_spread_under_1e-7_nudge": spread, "tol": tol}
            if naccept is not None:
                entry["naccept"] = naccept
            check(entry["loss_rel"] < loss_tol
                  and all(entry["grad_rel_l2"][k] < tol[k] <= GRAD_TOL_CAP for k in keys)
                  and not any(finite(grads_k[k]) for k in not_finite),
                  f"card vs CPU {flags}: {entry}")
            return entry

        max_steps = PARITY_MAX_STEPS if sum(cpa) >= 64 else S13_MAX_STEPS
        cpu_later("exact104_cpu_check", key, compare, "parity", cfg,
                  dict(columns_per_area=cpa, time_steps=T_check, max_steps=max_steps), flags,
                  args=(first["stims"], first["keys"]), kwargs=dict(grid=grid, noise=noise),
                  params_list=[first["params"]])
        return f"exact104_cpu_check: {key}"

    log = []
    rec, launched, secs, first = drive(EXACT, log=log)
    check(launched == {"sde_select": 1, "sde3_fwd_team": 1, "sde3_bwd_emit": 1},
          f"exact step at 104 columns: launches {launched}")
    st = rec["stats"]
    check(bool(st.success.all()) and bool(torch.isfinite(rec["loss"])),
          f"exact step: success {st.success.tolist()}, loss {rec['loss']}")
    main_launches = {"exact": launched}
    history = {"exact": {"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                         "update_applied": bool(rec["ok"]), "naccept": st.naccept.tolist(),
                         "nreject": st.nreject.tolist(), "seconds": secs}}
    cpu_check = {"exact": card_vs_cpu(EXACT, first, GRAD_T, "exact")}
    short_ms, wall, by_kernel = short_profile(
        parity.make_train_step(make_task(SHORT_T), **EXACT),
        (make_parity_batch(gen, n_in, B, device=dev), lane_keys()))
    busy = sum(by_kernel.values())
    profile = {"T": SHORT_T, "step_ms": short_ms, "profiled_wall_ms_per_step": wall,
               "device_busy_ms_per_step": busy if busy else "not measured",
               "idle_share": 1.0 - busy / short_ms if busy else "not measured",
               "top_ms_per_step": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])}
    emit("exact104_main_path", columns=sum(EX_CPA), lanes=B, T=PARITY_T,
         max_steps=PARITY_MAX_STEPS, flags=EXACT, history=history["exact"],
         launches=launched, cpu_check=cpu_check["exact"], profile=profile)

    # Each kernel of the main path: its CUDA events in that step (one launch each).
    n_f = 2 * int(st.naccept.max())  # the replay's half steps (lanes_grid)
    main_ms = {}
    for name, start, end in log:
        main_ms[name] = main_ms.get(name, 0.0) + start.elapsed_time(end)
    times = {"sde_select_jax_f32_104": main_ms["select_pass"],
             "sde3_fwd_team_lanes": main_ms["replay3_fwd"],
             "sde3_bwd_emit_lanes": main_ms["replay3_bwd_emit"],
             "outer_arg_grads_split3_lanes": main_ms["outer_arg_grads_split3"]}
    n_att = int((st.naccept + st.nreject).sum())
    real = int(2 * st.naccept.sum())
    bounds = {"sde_select_jax_f32_104": jax_select_bound(P, B, n_in, K, n_att, PARITY_MAX_STEPS,
                                                         True),
              "sde3_fwd_team_lanes": sde3_bound("sde3_fwd", P, B, n_in, K, real, n_f),
              "sde3_bwd_emit_lanes": sde3_bound("sde3_bwd_emit", P, B, n_in, K, real, n_f),
              "outer_arg_grads_split3_lanes": outer_bound(P, B, n_in, K, n_f)}
    serial = {"sde_select_jax_f32_104": int((st.naccept + st.nreject).max()),
              "sde3_fwd_team_lanes": n_f, "sde3_bwd_emit_lanes": n_f,
              "outer_arg_grads_split3_lanes": n_f}
    emit("exact104_times", lanes=B, T=PARITY_T, attempts=n_att, real_half_steps=real,
         n_real=n_f, ms=times, ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()}, step_seconds=secs)

    # -- 39. --fused-pass (B5t) and --grad-bf16 at 104 columns over SHORT_T points -----
    for name, flags, want in (
            ("fused_pass", dict(EXACT, fused_pass=True),
             {"sde_select": 1, "sde3_fwd_team": 1, "sde3_bwd_emit": 1}),
            ("grad_bf16", dict(EXACT, grad_bf16=True),
             {"sde_select": 1, "sde3_fwd_team": 1, "sde3_bwd_emit": 1})):
        rec, launched, secs, first_i = drive(flags, T=SHORT_T)
        check(launched == want and bool(torch.isfinite(rec["loss"])),
              f"{name} step at 104 columns: launches {launched}, loss {rec['loss']}")
        main_launches[name] = launched
        history[name] = {"T": SHORT_T, "loss": float(rec["loss"]),
                         "grad_norm": float(rec["gnorm"]), "update_applied": bool(rec["ok"]),
                         "naccept": rec["stats"].naccept.tolist(), "seconds": secs}
        cpu_check[name] = card_vs_cpu(flags, first_i, GRAD_T, name)
        if name == "fused_pass":
            fp = first_i
    task_fp = make_task(SHORT_T, params=fp["params"])
    model_fp = parity.sde_model(task_fp.params, task_fp, fp["stims"])
    pw_fp = {k: v.detach().contiguous() for k, v in model_fp.pw.items()}
    w3_fp = ns.select_weights_split3(pw_fp, model_fp.sc)
    words_fp = sa._sde_key_words(fp["keys"], "kernel")
    scfg_fp = sa.select_config(task_fp.ts, max_steps=PARITY_MAX_STEPS, brownian="kernel",
                               drift="split3")
    b5t_fp = ns.select_pass(y0, words_fp, w3_fp, model_fp.sc, model_fp.kv, scfg_fp)
    times["sde_select_krng_split3"] = cuda_ms(
        lambda: ns.select_pass(y0, words_fp, w3_fp, model_fp.sc, model_fp.kv, scfg_fp), reps=1,
        warmup=0)
    n_att_fp = int((b5t_fp[1] + b5t_fp[2]).sum())
    bounds["sde_select_krng_split3"] = split3_select_bound(P, B, n_in, K, n_att_fp,
                                                           PARITY_MAX_STEPS)
    serial["sde_select_krng_split3"] = int((b5t_fp[1] + b5t_fp[2]).max())
    times["sde_select_krng_split3_13"] = cuda_ms(
        lambda: ns.select_pass(y0_13, words_k, w3_13, model13f.sc, model13f.kv, scfg_k13),
        reps=1, warmup=0)
    emit("exact104_tiers", history={k: history[k] for k in ("fused_pass", "grad_bf16")},
         launches={k: main_launches[k] for k in ("fused_pass", "grad_bf16")},
         cpu_check={k: cpu_check[k] for k in ("fused_pass", "grad_bf16")},
         b5t={"T": SHORT_T, "attempts": n_att_fp, "ms": times["sde_select_krng_split3"],
              "bound_ms": bounds["sde_select_krng_split3"][0],
              "ns_per_attempt": times["sde_select_krng_split3"] * 1e6
              / serial["sde_select_krng_split3"],
              "full_second_13_columns_ms": times["sde_select_krng_split3_13"]})

    # -- 40. 32 columns over the full second: --stochastic and --stochastic
    # --adaptive through B4't-team ---------------------------------------------------
    team = {}
    for name, flags, fixed in (("fixed_grid", dict(stochastic=True), True),
                               ("adaptive", dict(stochastic=True, adaptive=True), False)):
        rec, launched, secs, first_i = drive(flags, cpa=EX_32_CPA, fixed=fixed)
        want = {"sde3_fwd_team": 1, "sde3_bwd_team": 1}
        if not fixed:
            want["sde_select"] = 1
        check(launched == want and bool(torch.isfinite(rec["loss"])),
              f"{name} step at 32 columns: launches {launched}, loss {rec['loss']}")
        entry = {"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                 "update_applied": bool(rec["ok"]), "seconds": secs, "launches": launched,
                 "cpu_check": card_vs_cpu(flags, first_i, GRAD_T, f"32_columns_{name}",
                                          cpa=EX_32_CPA)}
        if rec["stats"] is not None:
            entry.update(naccept=rec["stats"].naccept.tolist(),
                         success=rec["stats"].success.tolist())
        team[name] = entry
        main_launches[f"32_{name}"] = launched
        if fixed:
            first32 = first_i
    # B4't-team's time over the 32-column fixed grid's 999 steps.
    t32 = make_task(cpa=EX_32_CPA, params=first32["params"])
    P32 = t32.net.num_pops
    m32 = parity.sde_model(t32.params, t32, first32["stims"])
    pw32 = {k: v.detach().contiguous() for k, v in m32.pw.items()}
    t0u, hu = sf.uniform_step_times(t32.ts, (B, 3 * P32))
    t0u = t0u.to(dev)
    nu = t0u.shape[0]
    _, i1u, i10u, _, _ = brownian_pack(gen, t32.ts, (B, 1))
    grid32 = (t0u, torch.full_like(t0u, hu), i1u.reshape(nu, B).contiguous(),
              i10u.reshape(nu, B).contiguous())
    ys32 = ns.replay3_fwd(torch.zeros(B, 3 * P32, device=dev), *grid32, nu, pw32, m32.sc, m32.kv)
    bwd32 = (ys32[:-1].contiguous(), torch.randn(nu, B, 3 * P32, generator=gen, device=dev),
             grid32[0], grid32[1], grid32[3], nu, 0, sf.sweep_chunk((B, 3 * P32), nu), pw32,
             m32.sc, m32.kv)
    times["sde3_bwd_team"] = cuda_ms(lambda: ns.replay3_bwd(*bwd32), reps=2, warmup=1)
    bounds["sde3_bwd_team"] = sde3_bound("sde3_bwd", P32, B, n_in, K, B * nu, nu)
    serial["sde3_bwd_team"] = nu
    emit("exact32_main_path", columns=sum(EX_32_CPA), P=P32, lanes=B, T=PARITY_T, steps=team,
         b4t_team={"steps": nu, "ms": times["sde3_bwd_team"],
                   "bound_ms": bounds["sde3_bwd_team"][0],
                   "ns_per_step": times["sde3_bwd_team"] * 1e6 / nu})

    # -- 41. the command lines (run with the others at the end) --------------------------
    bench = ["--columns-per-area", "64,32,8", "--max-steps", "16384", "--bptt-every", "32",
             "--clip-grad-norm", "1.0", "--loss-scale", "1e-6"]
    for argv in (["--smoke", "--stochastic", "--adaptive", "--engine", "fused", *bench],
                 ["--smoke", "--stochastic", "--adaptive", "--fused", "--fused-pass", *bench],
                 ["--smoke", "--stochastic", "--adaptive", "--fused", "--grad-bf16", *bench],
                 ["--smoke", "--stochastic", "--columns-per-area", "16,8,8"],
                 ["--smoke", "--stochastic", "--adaptive", "--columns-per-area", "16,8,8"]):
        defer_command_line("exact104_command_lines", "parity", argv, timeout=900)

    entries = {
        "sde_select_jax_f32_104": ("columnflow/solvers/sde_adaptive.py:314",
                                   main_launches["exact"].get("sde_select", 0),
                                   "parity104 --stochastic --adaptive --engine fused",
                                   f"{BENCH_SEL_T} grid points"),
        "sde3_fwd_team_lanes": ("columnflow/solvers/fused.py:845",
                                main_launches["exact"].get("sde3_fwd_team", 0),
                                "parity104 --stochastic --adaptive --engine fused (lanes)",
                                f"{n_l} half steps"),
        "sde3_bwd_emit_lanes": ("columnflow/solvers/fused.py:920",
                                main_launches["exact"].get("sde3_bwd_emit", 0),
                                "parity104 --stochastic --adaptive --engine fused (lanes)",
                                f"{n_l} half steps"),
        "sde_select_krng_split3": ("columnflow/solvers/sde_adaptive.py:509",
                                   main_launches["fused_pass"].get("sde_select", 0),
                                   "parity104 --stochastic --adaptive --fused --fused-pass",
                                   f"{BENCH_SEL_T} grid points"),
        "sde3_bwd_team": ("columnflow/solvers/fused.py:920",
                          main_launches["32_fixed_grid"].get("sde3_bwd_team", 0)
                          + main_launches["32_adaptive"].get("sde3_bwd_team", 0),
                          "parity32 --stochastic, --stochastic --adaptive (kernel mode)",
                          f"{EX_W} steps at 32 columns"),
    }
    plain_of = {"sde_select_jax_f32_104": plain_ms["sde_select_jax_f32_104"],
                "sde3_fwd_team_lanes": plain_ms["sde3_fwd_team_lanes"],
                "sde3_bwd_emit_lanes": plain_ms["sde3_bwd_emit_lanes"],
                "sde_select_krng_split3": plain_ms["sde_select_krng_split3"],
                "sde3_bwd_team": plain_ms[f"sde3_bwd_team_{sum(EX_32_CPA)}"]}
    teams = {"sde3_fwd_team_lanes": {"team_routes": sde3_routes["sde3_fwd_team"],
                                     "bit_for_bit_32_columns": same["sde3_fwd_team_32"]},
             "sde3_bwd_emit_lanes": {"team_routes": sde3_routes["sde3_bwd_emit"],
                                     "bit_for_bit_13_columns": same["sde3_bwd_emit_lanes_13"]}}
    return [{"name": name, "route": "cuda",
             "source": SDE3_TEAM_SOURCE if name in teams else SDE_SOURCE, "replaces": rep,
             "launches": launches, "max_abs_err": errs[name], "ms": times[name],
             "plain_ms": plain_of[name], "plain_ms_at": at, "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None, "lanes": B, "path": path,
             "bit_for_bit": same[name], "ns_per_serial_step": times[name] * 1e6 / serial[name],
             **teams.get(name, {})}
            for name, (rep, launches, path, at) in entries.items()]


# The f32-exact deterministic engine past one block (the parity command line
# with no engine flag from 18 through 103 columns, --engine fused from 104
# through 312): batch 4 under one controller, 1000 grid points over 1 s,
# dopri5 at rtol 1e-7 / atol 1e-9, max_steps 16384 (the default 3072 ends
# the 104-column selection early).
EO_T = 1000
EO_B = 4
EO_MAX_STEPS = 16384
EO_FWD_CPA = ((16, 6, 2), (16, 8, 8), (64, 32, 8))  # B7t-team windows: 24, 32, 104 columns
EO_BWD_CPA = ((12, 4, 2), (16, 8, 8), (32, 24, 7))  # B8t-team windows: 18, 32, 63 columns
EO_32_CPA = (16, 8, 8)   # kernel mode's full width for this slice (P = 256)
EO_104_CPA = (64, 32, 8)  # outer mode's (P = 832)
EO_W = 64                # steps of each kernel-vs-plain window below 104 columns
EO_W104 = 16             # at 104 columns
EO_WIDE_W = 8            # steps of the 312-column window (FG_WIDE_CPA)
EO_SEL_T = 50            # grid points of the 32-column selection held against its plain loop
EO_GRAD_T32 = 50         # grid points of the 32-column card-vs-CPU step (104 columns: GRAD_T)


def exactode_phases(dev, cfg, frozen):
    """Phases 47-51: the f32-exact deterministic parity engine past one
    block: B7t-team, B8t-team, B8't and the three-term outer pass, at 104
    columns on the split2 phase's frozen grid (``frozen``; the selection
    runs here when it is empty); returns the new kernels' entries of the
    kernels line."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.solvers import fused as sf
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(23)
    B, n_in, K = EO_B, 4, 4
    c32, c104 = sum(EO_32_CPA), sum(EO_104_CPA)

    def make_task(cpa, T=EO_T, device=dev, params=None):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=n_in, time_steps=T,
                                 max_steps=EO_MAX_STEPS, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k].to(device))
        return task

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    same, errs, plain_ms, window_ms = {}, {}, {}, {}

    def compare(name, got, want):
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        same[name] = same.get(name, True) and ok
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        errs[name] = max(errs.get(name, 0.0), err)
        check(ok and all(bool(torch.isfinite(g).all()) for g in got),
              f"{name} against its plain version: max abs {err}")

    def setting(cpa, T=EO_T, stims=None, params=None, grid=None):
        """The engine's inputs at a width and a full replay of its frozen
        grid (the kernel's own selection, or the given one)."""
        task = make_task(cpa, T, params=params)
        stims = make_parity_batch(gen, n_in, B, device=dev) if stims is None else stims
        model = parity.sde_model(task.params, task, stims)
        pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
        P = task.net.num_pops
        y0 = torch.zeros(B, 3 * P, device=dev)
        scfg = no.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]),
                                  max_steps=sf.round_max_steps((B, 3 * P), EO_MAX_STEPS))
        if grid is None:
            st, stats = no.ode_select(y0, pw, model.sc, model.kv.contiguous(), scfg)
            grid = (st, int(stats[0]))
        n = grid[1]
        stn = grid[0][:n + 1].contiguous()
        ys, co = no.ode_replay_fwd(y0, stn, pw, model.sc, model.kv.contiguous())
        w3 = {k: v.contiguous() for k, v in no._w3(pw, model.sc).items()}
        return dict(task=task, stims=stims, pw=pw, sc=model.sc, kv=model.kv.contiguous(), P=P,
                    y0=y0, st=grid[0], n=n, stn=stn, ys=ys, w3=w3, scfg=scfg)

    def starts(n, W, cols=None):
        """Early, middle and late windows at the main paths' widths (32 and
        104 columns); the middle one elsewhere (the plain versions' time)."""
        if cols is not None and cols not in (c32, c104):
            return [max(0, n // 2 - W // 2)]
        return sorted({0, max(0, n // 2 - W // 2), max(0, n - W)})

    # -- 47. kernel vs plain, bit for bit -------------------------------------------
    windows = {"ode_replay_fwd_team": {}, "ode_replay_bwd_team": {},
               "ode_replay_bwd_emit_split3": {}}
    settings = {}
    if frozen:
        settings[c104] = setting(EO_104_CPA, stims=frozen["stims"], params=frozen["params"],
                                 grid=(frozen["step_times"], frozen["naccept"]))
    else:  # the split2 phase did not run: select here
        settings[c104] = setting(EO_104_CPA)
    for cpa in EO_FWD_CPA + EO_BWD_CPA:
        if sum(cpa) not in settings:
            settings[sum(cpa)] = setting(cpa)
    for cols, d in sorted(settings.items()):
        check(d["n"] > EO_W and bool(torch.isfinite(d["ys"]).all()),
              f"{cols} columns: {d['n']} accepted steps, replay finite")
    # B6 at 32 columns (the kernel-mode path's width) against its plain loop
    # over the first EO_SEL_T grid points, as phase 8 holds it at 13.
    d = settings[c32]
    cfg_s = d["scfg"]._replace(t_end=float(d["task"].ts[EO_SEL_T - 1]))
    st_k, stats_k = no.ode_select(d["y0"], d["pw"], d["sc"], d["kv"], cfg_s)
    (st_p, stats_p), sel_plain_ms = timed(lambda: no._ode_select_plain(d["y0"], d["w3"], d["sc"],
                                                                       d["kv"], cfg_s))
    na_k, na_p = int(stats_k[0]), int(stats_p[0])
    common = min(na_k, na_p)
    d_st = (st_k[:common + 1] - st_p[:common + 1]).abs()
    selection_32 = {"T": EO_SEL_T, "stats": stats_k.tolist(), "stats_plain": stats_p.tolist(),
                    "common_prefix_max_abs": float(d_st.max()),
                    "first_parted_index": (int(torch.nonzero(d_st).min())
                                           if bool((d_st > 0).any()) else None),
                    "plain_ms": sel_plain_ms}
    check(int(stats_k[2]) == 1 and int(stats_p[2]) == 1 and abs(na_k - na_p) <= 0.1 * na_p
          and float((st_k[:11] - st_p[:11]).abs().max()) == 0.0,
          f"ode_select at 32 columns over {EO_SEL_T} points: {selection_32}")
    # B7t-team: 24, 32 and 104 columns, the states from the kernel's own replay.
    for cpa in EO_FWD_CPA:
        d = settings[sum(cpa)]
        check(no.ode_fwd_route(d["P"], n_in) == "team", f"{sum(cpa)} columns: replay route")
        W = EO_W104 if sum(cpa) == c104 else EO_W
        for k0 in starts(d["n"], W, sum(cpa)):
            stw, y_k = d["stn"][k0:k0 + W + 1].contiguous(), d["ys"][k0].contiguous()
            got, kern = timed(lambda: no.ode_replay_fwd(y_k, stw, d["pw"], d["sc"], d["kv"]))
            want, pl_ms = timed(lambda: no._ode_replay_fwd_plain(y_k, stw, d["w3"], d["sc"],
                                                                  d["kv"]))
            compare("ode_replay_fwd_team", got, want)
            windows["ode_replay_fwd_team"].setdefault(sum(cpa), []).append(
                {"start": k0, "steps": W, "ms": kern, "plain_ms": pl_ms})
    # ... and one 8-step window at 312 columns, on the first steps of its selection.
    task_w = make_task(FG_WIDE_CPA, T=EO_T)
    stims_w = make_parity_batch(gen, n_in, B, device=dev)
    m_w = parity.sde_model(task_w.params, task_w, stims_w)
    pw_w = {k: v.detach().contiguous() for k, v in m_w.pw.items()}
    P_w = task_w.net.num_pops
    y0_w = torch.zeros(B, 3 * P_w, device=dev)
    cfg_w = no.ODESelectConfig(0.0, float(task_w.ts[4]), max_steps=sf.round_max_steps(
        (B, 3 * P_w), EO_MAX_STEPS))
    st_w, stats_w = no.ode_select(y0_w, pw_w, m_w.sc, m_w.kv.contiguous(), cfg_w)
    check(int(stats_w[0]) >= EO_WIDE_W, f"312 columns: stats {stats_w.tolist()}")
    stw = st_w[:EO_WIDE_W + 1].contiguous()
    got, kern = timed(lambda: no.ode_replay_fwd(y0_w, stw, pw_w, m_w.sc, m_w.kv.contiguous()))
    want, pl_ms = timed(lambda: no._ode_replay_fwd_plain(y0_w, stw, no._w3(pw_w, m_w.sc), m_w.sc,
                                                          m_w.kv.contiguous()))
    compare("ode_replay_fwd_team", got, want)
    windows["ode_replay_fwd_team"][sum(FG_WIDE_CPA)] = [
        {"start": 0, "steps": EO_WIDE_W, "ms": kern, "plain_ms": pl_ms}]
    # B6 and B8't at 312 columns on the same window (their own generator:
    # a draw from this phase's would move its later inputs): four single
    # attempts with 1, 1.5 and 2.5 times the accepted step, and the emit
    # sweep, bit for bit against the plain versions.
    gen_w = torch.Generator(device=dev).manual_seed(31)
    kv_w, ys_w = m_w.kv.contiguous(), got[0].contiguous()
    w3_w = {k: v.contiguous() for k, v in no._w3(pw_w, m_w.sc).items()}
    for r in range(4):
        k = r * (EO_WIDE_W - 1) // 3
        t, y = st_w[k].clone(), ys_w[k].contiguous()
        h = ((st_w[k + 1] - st_w[k]) * (1.0, 1.5, 2.5)[r % 3]).clone()
        f0 = no.ode_drift(t, y, w3_w, m_w.sc, kv_w).contiguous()
        compare("ode_attempt_312", tuple(no.ode_attempt(t, y, f0, h, pw_w, m_w.sc, kv_w, cfg_w)),
                tuple(no._ode_attempt_plain(t, y, f0, h, w3_w, m_w.sc, kv_w, cfg_w)))
    cob_w = torch.randn(EO_WIDE_W, 5, B, 3 * P_w, generator=gen_w, device=dev)
    got, kern = timed(lambda: no.ode_replay_bwd_emit(ys_w, cob_w, stw, w3_w, m_w.sc, kv_w))
    want, pl_ms = timed(lambda: no._ode_replay_bwd_emit_plain(ys_w, cob_w, stw, w3_w, m_w.sc,
                                                               kv_w))
    compare("ode_replay_bwd_emit_split3", got, want)
    windows["ode_replay_bwd_emit_split3"][sum(FG_WIDE_CPA)] = [
        {"start": 0, "steps": EO_WIDE_W, "ms": kern, "plain_ms": pl_ms,
         "weights": no.ode_team_route(P_w, n_in, 1, 3, True)}]
    # The kernel-mode sweep past one block (B8t-team's widths, now the cluster
    # team for the batch): 18, 32 and 63 columns, on the kernel's states and
    # random cotangents of the dense rows, against the plain version and
    # against B8t-team (route "team8", the kernel it replaced there).
    for cpa in EO_BWD_CPA:
        d = settings[sum(cpa)]
        route = no.ode_bwd_route(d["P"], n_in, B)
        check(route in ("resident", "streamed"), f"{sum(cpa)} columns: sweep route {route}")
        for k0 in starts(d["n"], EO_W, sum(cpa)):
            stw, ysw = d["stn"][k0:k0 + EO_W + 1].contiguous(), d["ys"][k0:k0 + EO_W].contiguous()
            cob = torch.randn(EO_W, 5, B, 3 * d["P"], generator=gen, device=dev)
            got, kern = timed(lambda: no.ode_replay_bwd(ysw, cob, stw, d["pw"], d["sc"], d["kv"]))
            want, pl_ms = timed(lambda: no._ode_replay_bwd_plain(ysw, cob, stw, d["w3"], d["sc"],
                                                                  d["kv"]))
            compare("ode_replay_bwd_team", got, want)
            compare("ode_replay_bwd_team_vs_team8", got,
                    no.ode_replay_bwd(ysw, cob, stw, d["pw"], d["sc"], d["kv"], route="team8"))
            windows["ode_replay_bwd_team"].setdefault(sum(cpa), []).append(
                {"start": k0, "steps": EO_W, "ms": kern, "plain_ms": pl_ms, "route": route})
    # B8't: 104 columns.
    d = settings[c104]
    for k0 in starts(d["n"], EO_W104):
        stw, ysw = d["stn"][k0:k0 + EO_W104 + 1].contiguous(), d["ys"][k0:k0 + EO_W104].contiguous()
        cob = torch.randn(EO_W104, 5, B, 3 * d["P"], generator=gen, device=dev)
        got, kern = timed(lambda: no.ode_replay_bwd_emit(ysw, cob, stw, d["w3"], d["sc"], d["kv"]))
        want, pl_ms = timed(lambda: no._ode_replay_bwd_emit_plain(ysw, cob, stw, d["w3"], d["sc"],
                                                                   d["kv"]))
        compare("ode_replay_bwd_emit_split3", got, want)
        windows["ode_replay_bwd_emit_split3"].setdefault(c104, []).append(
            {"start": k0, "steps": EO_W104, "ms": kern, "plain_ms": pl_ms})
    # The cluster teams against team8: B8't on a middle 104-column window,
    # B6 over the 32-column selection's EO_SEL_T points.
    k0 = max(0, d["n"] // 2 - EO_W104 // 2)
    stw, ysw = d["stn"][k0:k0 + EO_W104 + 1].contiguous(), d["ys"][k0:k0 + EO_W104].contiguous()
    cob = torch.randn(EO_W104, 5, B, 3 * d["P"], generator=gen_w, device=dev)
    d32 = settings[c32]
    routes = {
        "ode_replay_bwd_emit_split3": {"steps": EO_W104, **team_routes(
            lambda r: no.ode_replay_bwd_emit(ysw, cob, stw, d["w3"], d["sc"], d["kv"], route=r),
            EO_W104, no.ode_team_route(d["P"], n_in, 1, 3, True))},
        "ode_select_32": {"T": EO_SEL_T, **team_routes(
            lambda r: no.ode_select(d32["y0"], d32["pw"], d32["sc"], d32["kv"], cfg_s, route=r),
            int(stats_k[0]) + int(stats_k[1]), no.ode_team_route(d32["P"], n_in, B, 3, False))}}
    for name, by_cols in windows.items():
        # The plain version's time on the main path's width: a middle window.
        cols = c32 if name == "ode_replay_bwd_team" else c104
        mid = by_cols[cols][len(by_cols[cols]) // 2]
        plain_ms[name], window_ms[name] = mid["plain_ms"], mid["ms"]
        plain_ms[f"{name}_at"] = f"{mid['steps']} steps at {cols} columns"
    emit("exactode_kernel_vs_plain", lanes=B, T=EO_T, max_steps=EO_MAX_STEPS,
         accepted={c: d["n"] for c, d in sorted(settings.items())},
         grid_104="the split2 phase's" if frozen else "its own selection",
         selection_32=selection_32, windows=windows, bit_for_bit=same, max_abs_err=errs,
         team_routes=routes)

    # -- 48. main path: one full step at 32 columns (kernel mode) and at 104
    # (outer mode, on the split2 phase's frozen grid) --------------------------------
    names = ("ode_select", "ode_replay_fwd", "ode_replay_bwd", "ode_replay_bwd_emit",
             "ode_outer_arg_grads")
    main, dev_ms, firsts = {}, {}, {}
    for cols, cpa in ((c32, EO_32_CPA), (c104, EO_104_CPA)):
        d = settings[cols]
        task = make_task(cpa, params={k: p.detach() for k, p in d["task"].params.items()})
        step = parity.make_train_step(task)
        grid = None
        want = {"ode_select": 1, "ode_replay_fwd_team": 1, "ode_replay_bwd_ksweep": 1}
        if cols == c104:
            grid = (d["st"], d["n"])
            want = {"ode_replay_fwd_team": 1, "ode_replay_bwd_emit_split3": 1}
        params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
        masks = {k: v.bool() for k, v in task.grad_mask.items()}
        log = []
        restore = event_timed(sf, names, log)
        try:
            for k in no.LAUNCHES:
                no.LAUNCHES[k] = 0
            rec, ms = timed(lambda: step(d["stims"], grid=grid))
            launched = {k: v for k, v in no.LAUNCHES.items() if v}
        finally:
            restore()
        dev_ms[cols] = {}
        for name, start, end in log:
            dev_ms[cols][name] = dev_ms[cols].get(name, 0.0) + start.elapsed_time(end)
        sk = rec["stats"]
        finite = {k: bool(torch.isfinite(p.grad).all()) for k, p in task.params.items()}
        main[cols] = {"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                      "update_applied": bool(rec["ok"]), "grads_finite": finite,
                      "naccept": int(sk.naccept), "nreject": int(sk.nreject),
                      "success": bool(sk.success), "launches": launched, "seconds": ms / 1e3,
                      "device_ms": dev_ms[cols]}
        check(launched == want, f"exact step at {cols} columns: launches {launched}")
        check(bool(sk.success) and bool(torch.isfinite(rec["loss"])),
              f"exact step at {cols} columns: success {bool(sk.success)}, loss {rec['loss']}")
        for k, p in task.params.items():
            check(bool((p.grad[~masks[k]].nan_to_num(0.0, 0.0, 0.0) == 0).all()),
                  f"exact step at {cols} columns: {k} gradient off its mask")
        check(rec["ok"] == (all(finite.values()) and float(rec["gnorm"]) < 1e4),
              f"exact step at {cols} columns: ok {rec['ok']}, finite {finite}")
        firsts[cols] = (params0, d["stims"])
    emit("exactode_main_path", lanes=B, T=EO_T, max_steps=EO_MAX_STEPS,
         steps={f"{c}_columns": v for c, v in main.items()},
         grid_104="the split2 phase's frozen grid (the same three-term selection)")

    # -- 49. card against CPU: every gradient within the larger of 1e-3 and
    # ten times the card's own spread under a 1e-7 nudge of the weights, a
    # limit that must stay at most GRAD_TOL_CAP (as exact104_phases holds
    # its step): 104 columns over GRAD_T points, 32 over EO_GRAD_T32. The
    # exact engine's gradient is bf16-grade (the sweep rounds every
    # transposed product); over 5 points at 32 columns the network has
    # barely answered the stimulus (gradients ~1e-5) and the nudge moved
    # the lateral gradient by 8.6e-2, over 50 points by ~6e-4 (CPU) --------
    def one(cols, cpa, params, T_c, grid=None):
        t = make_task(cpa, T_c, params=params)
        rec = parity.make_train_step(t)(firsts[cols][1], grid=grid)
        return rec, {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}

    def compare(res, cols, T_c, loss_k, grads_k, naccept, loss_n, grads_n):
        loss_c, grads_c, _ = res[0]
        spread = {k: rel_l2(grads_n[k], grads_k[k]) for k in grads_k}
        tol = {k: max(ODE_GRAD_TOL, 10.0 * spread[k]) for k in grads_k}
        loss_tol = max(ODE_LOSS_TOL, 10.0 * abs(loss_n - loss_k) / abs(loss_k))
        entry = {"T": T_c, "naccept": naccept, "loss_rel": abs(loss_k - loss_c) / abs(loss_c),
                 "loss_tol": loss_tol,
                 "grad_rel_l2": {k: rel_l2(grads_k[k], grads_c[k]) for k in grads_k},
                 "card_grad_spread_under_1e-7_nudge": spread, "tol": tol}
        check(entry["loss_rel"] < loss_tol
              and all(entry["grad_rel_l2"][k] < tol[k] <= GRAD_TOL_CAP for k in grads_k),
              f"card vs CPU exact step at {cols} columns: {entry}")
        return entry

    for cols, cpa, T_c in ((c32, EO_32_CPA, EO_GRAD_T32), (c104, EO_104_CPA, GRAD_T)):
        p0 = firsts[cols][0]
        rec_k, grads_k = one(cols, cpa, p0, T_c)
        grid = (rec_k["stats"].step_times, int(rec_k["stats"].naccept))
        rec_n, grads_n = one(cols, cpa, {k: v * (1.0 + 1e-7) for k, v in p0.items()}, T_c, grid)
        cpu_later("exactode_cpu_check", f"{cols}_columns",
                  lambda res, a=(cols, T_c, float(rec_k["loss"]), grads_k, grid[1],
                                 float(rec_n["loss"]), grads_n): compare(res, *a),
                  "parity", cfg, dict(columns_per_area=cpa, n_inputs=n_in, time_steps=T_c,
                                      max_steps=EO_MAX_STEPS), {},
                  args=(firsts[cols][1],), kwargs=dict(grid=grid), params_list=[p0])
    emit("exactode_card_vs_cpu", lanes=B, cpu_check="exactode_cpu_check",
         tol={"loss": "max(1e-5, 10 x spread)", "grad": "max(1e-3, 10 x spread) <= "
              f"{GRAD_TOL_CAP}"})

    # -- 50. times: each kernel from the main-path steps' CUDA events, its bound
    # and ns per accepted step; the plain versions on a middle window; the
    # steps' profiles over SHORT_T points --------------------------------------------
    n32, n104 = main[c32]["naccept"], main[c104]["naccept"]
    P32, P104 = settings[c32]["P"], settings[c104]["P"]
    times = {"ode_replay_fwd_team": dev_ms[c104]["ode_replay_fwd"],
             "ode_replay_fwd_team_32": dev_ms[c32]["ode_replay_fwd"],
             "ode_replay_bwd_team": dev_ms[c32]["ode_replay_bwd"],
             "ode_replay_bwd_emit_split3": dev_ms[c104]["ode_replay_bwd_emit"],
             "ode_outer_split3": dev_ms[c104]["ode_outer_arg_grads"],
             "ode_select_32": dev_ms[c32]["ode_select"]}
    serial = {"ode_replay_fwd_team": n104, "ode_replay_fwd_team_32": n32,
              "ode_replay_bwd_team": n32, "ode_replay_bwd_emit_split3": n104,
              "ode_outer_split3": n104,
              "ode_select_32": main[c32]["naccept"] + main[c32]["nreject"]}
    bounds = {"ode_replay_fwd_team": ode_bound("ode_replay_fwd_team", P104, B, n_in, K, n104),
              "ode_replay_fwd_team_32": ode_bound("ode_replay_fwd_team", P32, B, n_in, K, n32),
              "ode_replay_bwd_team": ode_bound("ode_replay_bwd_team", P32, B, n_in, K, n32),
              "ode_replay_bwd_emit_split3": ode_bound("ode_replay_bwd_emit_split3", P104, B,
                                                      n_in, K, n104),
              "ode_outer_split3": ode_bound("ode_outer_split3", P104, B, n_in, K, n104),
              "ode_select_32": ode_bound("ode_select", P32, B, n_in, K, serial["ode_select_32"],
                                         M=EO_MAX_STEPS)}
    profiles = {}
    for cols, cpa in ((c32, EO_32_CPA), (c104, EO_104_CPA)):
        short_ms, wall, by_kernel = short_profile(
            parity.make_train_step(make_task(cpa, SHORT_T)),
            (make_parity_batch(gen, n_in, B, device=dev),))
        busy = sum(by_kernel.values())
        profiles[f"{cols}_columns"] = {
            "T": SHORT_T, "step_ms": short_ms, "profiled_wall_ms_per_step": wall,
            "device_busy_ms_per_step": busy if busy else "not measured",
            "idle_share": 1.0 - busy / short_ms if busy else "not measured",
            "top_ms_per_step": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])}
    # B7t-team against team8 on ROUTE_W-step windows in the middle of the
    # full replays at 104 and 32 columns (the shape's route, "streamed"
    # where resident, team8).
    replay_routes = {}
    for cols in (c104, c32):
        dr = settings[cols]
        kr = max(0, min(dr["n"] - ROUTE_W, dr["n"] // 2))
        str_, yr = dr["stn"][kr:kr + ROUTE_W + 1].contiguous(), dr["ys"][kr].contiguous()
        W_r = str_.shape[0] - 1
        route, plan = no._replay_team(None, dr["P"], n_in, B, 3)
        replay_routes["ode_replay_fwd_team" + ("" if cols == c104 else f"_{cols}")] = {
            "steps": W_r, "start": kr, "columns": cols, "C": plan.C, "f32": plan.f32,
            **team_routes(lambda r: no.ode_replay_fwd(yr, str_, dr["pw"], dr["sc"], dr["kv"],
                                                      w3=dr["w3"], route=r), W_r, route)}
    # The kernel-mode sweep's cluster team against B8t-team on a ROUTE_W-step
    # window in the middle of the full 32-column replay.
    d32 = settings[c32]
    kr = max(0, min(d32["n"] - ROUTE_W, d32["n"] // 2))
    str_ = d32["stn"][kr:kr + ROUTE_W + 1].contiguous()
    ysr = d32["ys"][kr:kr + ROUTE_W].contiguous()
    W_r = str_.shape[0] - 1
    cobr = torch.randn(W_r, 5, B, 3 * d32["P"], generator=gen_w, device=dev)
    replay_routes["ode_replay_bwd_team"] = {"steps": W_r, "start": kr, "columns": c32,
                                            **sweep_routes(
        lambda r: no.ode_replay_bwd(ysr, cobr, str_, d32["pw"], d32["sc"], d32["kv"], route=r),
        W_r, no.ode_bwd_route(d32["P"], n_in, B), "team8")}
    routes.update(replay_routes)
    emit("exactode_times", lanes=B, T=EO_T, naccept={c32: n32, c104: n104}, ms=times,
         ns_per_accepted_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()},
         plain_ms=plain_ms, kernel_ms_on_plain_window=window_ms, team_routes=replay_routes,
         step_seconds={c: main[c]["seconds"] for c in main}, profiles=profiles)

    # -- 51. the command lines (run with the others at the end) ----------------------
    for argv in (["--smoke", "--columns-per-area", "16,8,8"],
                 ["--smoke", "--engine", "fused", "--columns-per-area", "64,32,8",
                  "--max-steps", "16384"]):
        defer_command_line("exactode_command_lines", "parity", argv, timeout=900, finite=True,
                           reach=True)

    entries = {
        "ode_replay_fwd_team": ("columnflow/solvers/fused.py:294",
                                "deterministic f32-exact, 104 columns (outer mode; also 32)"),
        "ode_replay_bwd_team": ("columnflow/solvers/fused.py:327",
                                "deterministic f32-exact, 32 columns (kernel mode)"),
        "ode_replay_bwd_emit_split3": ("columnflow/solvers/fused.py:327",
                                       "deterministic f32-exact, 104 columns (outer mode)"),
    }
    key = {"ode_replay_bwd_team": "ode_replay_bwd_ksweep"}  # its launch counter
    return [{"name": name, "route": "cuda", "source": ODE_TEAM_SOURCES.get(name, ODE_SOURCE),
             "replaces": rep,
             "launches": sum(main[c]["launches"].get(key.get(name, name), 0) for c in main),
             "launches_by_path": {f"{c}_columns": main[c]["launches"].get(key.get(name, name), 0)
                                  for c in main},
             "max_abs_err": errs[name], "bit_for_bit": same[name], "ms": times[name],
             "plain_ms": plain_ms[name], "plain_ms_at": plain_ms[f"{name}_at"],
             "ms_window": window_ms[name], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None, "lanes": B, "path": path,
             "ns_per_serial_step": times[name] * 1e6 / serial[name],
             **({"team_routes": routes[name]} if name in routes else {}),
             **({"kernel": "ode_ksweep16_kernel (cf_ode_replay_bwd_ksweep): one cluster team "
                           "for the batch", "launch_key": "ode_replay_bwd_ksweep",
                 "weights": routes[name]["weights"],
                 "registers": ptxas_of("ode_ksweep16_kernel"),
                 "bit_for_bit_with_team8": same["ode_replay_bwd_team_vs_team8"]}
                if name == "ode_replay_bwd_team" else {})}
            for name, (rep, path) in entries.items()]


S2K_WIN_CPA = ((8, 4, 1), (16, 8, 8), (32, 24, 7))  # B8s and B4s windows: 13, 32, 63 columns
S2K_32_CPA = (16, 8, 8)   # the kernel-mode steps' width (P = 256)
S2K_104_CPA = (64, 32, 8)  # the exact split2 outer pass's (P = 832)
S2K_SEL_T = 100           # grid points of the selections whose grids the windows run on
S2K_W = 32                # steps (half steps) of each B8s (B4s) window
S2K_T104 = 100            # grid points of the exact split2 stochastic step at 104 columns
S2K_GRAD_T32 = 50         # grid points of the 32-column card-vs-CPU steps
# ... and of the 104-column one: over 5 points (GRAD_T) the card's nudge
# spread of its feedforward gradient was 2.7e-2, a limit past GRAD_TOL_CAP
S2K_GRAD_T104 = 25


def split2_kernel_bound(kernel, P, B, n_in, K, work, n=0):
    """(bound_ms, bound_by) of the two-term kernel-mode sweeps and the
    exact split2 outer pass. B8s (``work``: accepted steps): per step 6
    two-term drift evaluations of the batch (three bf16 (B, P) x (P, P)
    products, 2 B P^2 operations each, at the bf16 rate) and 7 drift VJPs
    (two transposed and two weight-side products each), the elementwise and
    fold work at the float32 rate. B4s (``work``: real half steps of all
    lanes): per lane step a drift (three products of 2 P^2) and two VJPs
    (two state-side and two weight-side products each). The outer pass
    (``work``: half steps, n): per step one drift and two VJPs of the batch,
    11 products of 2 B P^2 at the float32 rate (PyTorch's float64 and
    float32 matmuls, as ``outer_bound`` counts). Bytes: each input read
    once (the two bf16 terms of wT), each output written once."""
    S, N = 3 * P, 3 * P * B
    consts = 4 * (n_in * P + 2 * P + K * B * n_in)
    wout = 4 * (P * P + n_in * P)
    if kernel == "ode_replay_bwd_split2":
        prod = 2 * B * P * P
        flops16 = work * (6 * 3 * prod + 7 * 4 * prod)
        flops32 = work * (6 * B * (40 * P + 8 * S) + 7 * (B * (60 * P + 10 * S) + 20 * P * P)
                          + (3 * 21 + 3 * 21 + 40) * N + 6 * P * P)
        nbytes = 2 * 2 * P * P + consts + 4 * (work + 1) + 4 * work * N * 6 + 4 * N + wout
    elif kernel == "sde2_bwd":
        prod = 2 * P * P
        flops16 = work * 7 * prod
        flops32 = work * (30 * P + 2 * (20 * P + 10 * S) + 12 * S) + (work / B) * 6 * P * P
        nbytes = 2 * 2 * P * P + consts + 12 * work + 2 * 4 * work * S + 4 * B * S + wout
    else:  # outer_arg_grads_split2
        flops16 = 0.0
        flops32 = work * 11 * 2 * B * P * P
        nbytes = 2 * 4 * work * B * S + 2 * wout + consts
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops16 / BF16_FLOPS + flops32 / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split2kernel_phases(dev, cfg):
    """Phases 52-56: the two-term split with its exact weight gradients:
    B8s (the deterministic fused-split2 tier in kernel mode), B4s (the
    stochastic-adaptive split2 replay in kernel mode) and the exact split2
    outer pass (from 64 columns); returns the entries of B8s and B4s."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import column_step, hopf_ode, xor_ode, xor_sde
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.models import network as nw
    from columnflow_torch.solvers import fused as sf
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(29)
    B, n_in, K = 4, 4, 4
    counters = (column_step.LAUNCHES, ns.LAUNCHES, no.LAUNCHES, xor_ode.LAUNCHES,
                xor_sde.LAUNCHES, hopf_ode.LAUNCHES)

    def make_task(cpa, T=EO_T, device=dev, params=None, max_steps=EO_MAX_STEPS):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=n_in, time_steps=T,
                                 max_steps=max_steps, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k].to(device))
        return task

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    same, errs, windows = {}, {}, {"ode_replay_fwd_split2": {}, "ode_replay_bwd_split2": {},
                                   "sde_replay_fwd": {}, "sde2_bwd": {}, "sde_replay_bwd": {}}

    def compare(name, got, want):
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        same[name] = same.get(name, True) and ok
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        errs[name] = max(errs.get(name, 0.0), err)
        check(ok and all(bool(torch.isfinite(g).all()) for g in got),
              f"{name} against its plain version: max abs {err}")

    def w2_of(pw, sc):
        return {k: v.contiguous() for k, v in nw.prepare_premixed_split2(pw, sc.fc)[0].items()}

    # -- 52. kernel vs plain, bit for bit: B7 split2 and B8s on the deterministic
    # selection's grid, B3 and B4s on the f32 jax-tree selection's lanes grid, at
    # 13, 32 and 63 columns (three windows at 32, the main path's width) -------------
    accepted = {}
    for cpa in S2K_WIN_CPA:
        cols = sum(cpa)
        task = make_task(cpa, S2K_SEL_T)
        stims = make_parity_batch(gen, n_in, B, device=dev)
        model = parity.sde_model(task.params, task, stims)
        pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
        sc, kv, P = model.sc, model.kv.contiguous(), task.net.num_pops
        w2 = w2_of(pw, sc)
        y0 = torch.zeros(B, 3 * P, device=dev)
        check(no.ode_bwd_route(P, n_in, B, terms=2) == "team"
              and ns.sde3_bwd_route(P, n_in, B, terms=2) == "team", f"{cols} columns: routes")
        scfg = no.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]),
                                  max_steps=sf.round_max_steps((B, 3 * P), EO_MAX_STEPS))
        st, stats = no.ode_select(y0, pw, sc, kv, scfg)
        n = int(stats[0])
        check(n > S2K_W, f"{cols} columns: {n} accepted steps over {S2K_SEL_T} points")
        stn = st[:n + 1].contiguous()
        ys, co = no.ode_replay_fwd_split2(y0, stn, w2, sc, kv)
        starts = sorted({0, n // 2 - S2K_W // 2, n - S2K_W}) if cpa == S2K_32_CPA else [n // 2]
        for k0 in starts:
            stw, y_k = stn[k0:k0 + S2K_W + 1].contiguous(), ys[k0].contiguous()
            got, kern = timed(lambda: no.ode_replay_fwd_split2(y_k, stw, w2, sc, kv))
            want, pl_ms = timed(lambda: no._ode_replay_fwd_plain(y_k, stw, w2, sc, kv))
            compare("ode_replay_fwd_split2", got, want)
            windows["ode_replay_fwd_split2"].setdefault(cols, []).append(
                {"start": k0, "steps": S2K_W, "ms": kern, "plain_ms": pl_ms})
            ysw = ys[k0:k0 + S2K_W].contiguous()
            cob = torch.randn(S2K_W, 5, B, 3 * P, generator=gen, device=dev)
            got, kern = timed(lambda: no.ode_replay_bwd_split2(ysw, cob, stw, w2, sc, kv))
            want, pl_ms = timed(lambda: no._ode_replay_bwd_plain(ysw, cob, stw, w2, sc, kv))
            compare("ode_replay_bwd_split2", got, want)
            windows["ode_replay_bwd_split2"].setdefault(cols, []).append(
                {"start": k0, "steps": S2K_W, "ms": kern, "plain_ms": pl_ms})
        # The stochastic replay: the f32 selection on the jax.random tree, its
        # lanes grid, B3 over the whole grid, B4s on windows of it.
        keys = torch.randint(0, 2**32, (B, 2), generator=gen, device=dev, dtype=torch.int64)
        words = sa._sde_key_words(keys, "jax")
        ccfg = sa.select_config(task.ts, max_steps=S13_MAX_STEPS, brownian="jax", drift="f32")
        sel = ns.select_pass(y0, words, pw, sc, kv, ccfg)
        ht, dw, i10 = sa._replay_grid(sel[0], words, ccfg.t_start, ccfg.t_end, ccfg.depth, "jax")
        nl = 2 * int(sel[1].max())
        check(nl > S2K_W, f"{cols} columns: {nl} half steps over {S2K_SEL_T} points")
        grid = tuple(x.contiguous() for x in (ht[:, :nl].T, (ht[:, 1:nl + 1] - ht[:, :nl]).T,
                                              dw[:, :nl].T, i10[:, :nl].T))
        ys_l = ns.replay_fwd(y0, *grid, nl, w2, sc, kv)
        starts = (sorted({0, nl // 2 - S2K_W // 2, nl - S2K_W}) if cpa == S2K_32_CPA
                  else [nl // 2])
        for k0 in starts:
            sl = slice(k0, k0 + S2K_W)
            fwd = (tuple(x[sl].contiguous() for x in grid), S2K_W, w2, sc, kv)
            y_k = ys_l[k0].contiguous()
            got, kern = timed(lambda: ns.replay_fwd(y_k, *fwd[0], *fwd[1:]))
            want, pl_ms = timed(lambda: ns._replay_fwd_plain(y_k, *fwd[0], *fwd[1:]))
            compare("sde_replay_fwd", got, want)
            ys_fwd_k, ys_fwd_p = got, want
            windows["sde_replay_fwd"].setdefault(cols, []).append(
                {"start": k0, "steps": S2K_W, "ms": kern, "plain_ms": pl_ms})
            bwd = (ys_l[sl].contiguous(), torch.randn(S2K_W, B, 3 * P, generator=gen, device=dev),
                   grid[0][sl].contiguous(), grid[1][sl].contiguous(), grid[3][sl].contiguous(),
                   S2K_W, 0, sf.sweep_chunk((B, 3 * P), S2K_W), w2, sc, kv)
            got, kern = timed(lambda: ns.replay2_bwd(*bwd))
            want, pl_ms = timed(lambda: ns._replay2_bwd_plain(*bwd))
            compare("sde2_bwd", got, want)
            windows["sde2_bwd"].setdefault(cols, []).append(
                {"start": k0, "steps": S2K_W, "ms": kern, "plain_ms": pl_ms})
            record_replay2("sde_replay_fwd", cols, ys_fwd_k, ys_fwd_p)
            # B4 (emit mode) on the same window and cotangents, truncating every
            # 5 steps: phase 5's limits, bit for bit recorded
            ebwd = (*bwd[:6], 5, w2, sc, kv)
            (yb_k, sd_k), (yb_p, sd_p) = ns.replay_bwd(*ebwd), ns._replay_bwd_plain(*ebwd)
            e4 = {"seeds_rel_l2": rel_l2_rows(sd_k, sd_p),
                  "carry_rel_l2": rel_l2_rows(yb_k[None], yb_p[None]),
                  **record_replay2("sde_replay_bwd", cols, (sd_k, yb_k), (sd_p, yb_p))}
            check(bool(torch.isfinite(sd_k).all()) and e4["seeds_rel_l2"] < 1e-4
                  and (e4["carry_rel_l2"] < 1e-4 or not bool(yb_p.any())),
                  f"sde_replay_bwd at {cols} columns, window {k0}: {e4}")
            windows["sde_replay_bwd"].setdefault(cols, []).append({"start": k0, **e4})
        accepted[cols] = {"deterministic": n, "lanes_half_steps": nl}
    # B3 and B4 at 312 columns (streamed through the ring): one 8-half-step
    # window of per-lane grids (0.2-1 ms steps) from states in the rates'
    # working range, truncating every 5 steps; phase 5's limits. Its own
    # generator: the phase's later draws stay what they were.
    t_wide = time.perf_counter()
    gen_w = torch.Generator(device=dev).manual_seed(31)
    task_w = make_task(FG_WIDE_CPA, S2K_SEL_T)
    model_w = parity.sde_model(task_w.params, task_w,
                               make_parity_batch(gen_w, n_in, B, device=dev))
    P_w = task_w.net.num_pops
    pw_w = {k: v.detach().contiguous() for k, v in model_w.pw.items()}
    w2_w, sc_w, kv_w = w2_of(pw_w, model_w.sc), model_w.sc, model_w.kv.contiguous()
    hs_w = (2e-4 + 8e-4 * torch.rand(FG_WIDE_W, B, generator=gen_w, device=dev)).contiguous()
    t0_w = (torch.cumsum(hs_w, 0) - hs_w + 0.3).contiguous()
    dw_w = (torch.randn(FG_WIDE_W, B, generator=gen_w, device=dev) * hs_w.sqrt()).contiguous()
    i10_w = (hs_w * (0.5 * dw_w + (hs_w / 12.0).sqrt()
                     * torch.randn(FG_WIDE_W, B, generator=gen_w, device=dev))).contiguous()
    a = 5.0 * torch.rand(B, P_w, generator=gen_w, device=dev)
    y_w = torch.cat([a + 80.0 * torch.rand(B, P_w, generator=gen_w, device=dev) - 40.0, a,
                     40.0 * torch.rand(B, P_w, generator=gen_w, device=dev)], dim=1)
    fwd = (y_w, t0_w, hs_w, dw_w, i10_w, FG_WIDE_W, w2_w, sc_w, kv_w)
    ys_w, ys_wp = ns.replay_fwd(*fwd), ns._replay_fwd_plain(*fwd)
    bwd = (ys_wp[:-1].contiguous(), torch.randn(FG_WIDE_W, B, 3 * P_w, generator=gen_w, device=dev),
           t0_w, hs_w, i10_w, FG_WIDE_W, 5, w2_w, sc_w, kv_w)
    (yb_w, sd_w), (yb_wp, sd_wp) = ns.replay_bwd(*bwd), ns._replay_bwd_plain(*bwd)
    wide = {"columns": sum(FG_WIDE_CPA), "P": P_w, "half_steps": FG_WIDE_W,
            "route": ns.sde2_replay_route(P_w, n_in), "fwd_scaled": scaled_err(ys_w, ys_wp),
            "seeds_rel_l2": rel_l2_rows(sd_w, sd_wp),
            "fwd": record_replay2("sde_replay_fwd", sum(FG_WIDE_CPA), ys_w, ys_wp),
            "bwd": record_replay2("sde_replay_bwd", sum(FG_WIDE_CPA), (sd_w, yb_w),
                                  (sd_wp, yb_wp))}
    check(all(bool(torch.isfinite(x).all()) for x in (ys_w, sd_w)) and wide["fwd_scaled"] < 1e-4
          and wide["seeds_rel_l2"] < 1e-4, f"B3/B4 at {sum(FG_WIDE_CPA)} columns: {wide}")
    wide["seconds"] = time.perf_counter() - t_wide
    del task_w, model_w, pw_w, w2_w, ys_w, ys_wp, sd_w, sd_wp
    c32 = sum(S2K_32_CPA)
    plain_ms, window_ms = {}, {}
    for name, by_cols in windows.items():
        if name == "sde_replay_bwd":
            continue
        mid = by_cols[c32][len(by_cols[c32]) // 2]
        plain_ms[name], window_ms[name] = mid["plain_ms"], mid["ms"]
        plain_ms[f"{name}_at"] = f"{mid['steps']} steps at {c32} columns"
    emit("split2kernel_kernel_vs_plain", lanes=B, T=S2K_SEL_T, accepted=accepted,
         windows=windows, bit_for_bit=same, max_abs_err=errs, replay2_wide=wide,
         replay2_tol={"fwd_scaled": 1e-4, "seeds_rel_l2": 1e-4, "carry_rel_l2": 1e-4})

    # -- 53. main path: the deterministic split2 step at 32 columns over the full
    # second (B6, B7 split2, B8s), the stochastic-adaptive one (the f32 selection,
    # B3, B4s), and the exact split2 stochastic-adaptive step at 104 columns over
    # S2K_T104 points (the f32 selection, B3, B4 emit, outer_arg_grads_split2) ------
    paths = {
        "deterministic_32": (S2K_32_CPA, EO_T, EO_MAX_STEPS, dict(split2=True),
                             {"ode_select": 1, "ode_replay_fwd_split2": 1,
                              "ode_replay_bwd_split2": 1}),
        "adaptive_32": (S2K_32_CPA, EO_T, S13_MAX_STEPS,
                        dict(stochastic=True, adaptive=True, split2=True),
                        {"sde_select": 1, "sde_replay_fwd": 1, "sde2_bwd": 1}),
        "adaptive_104": (S2K_104_CPA, S2K_T104, PARITY_MAX_STEPS,
                         dict(stochastic=True, adaptive=True, split2=True),
                         {"sde_select": 1, "sde_replay_fwd": 1, "sde_replay_bwd": 1}),
    }
    timed_sf = ("ode_select", "ode_replay_fwd_split2", "ode_replay_bwd_split2", "replay_fwd",
                "replay2_bwd", "replay_bwd", "outer_arg_grads_split2")
    main, dev_ms, firsts = {}, {}, {}
    for name, (cpa, T, max_steps, flags, want) in paths.items():
        task = make_task(cpa, T, max_steps=max_steps)
        step = parity.make_train_step(task, **flags)
        stims = make_parity_batch(gen, n_in, B, device=dev)
        keys = (torch.randint(0, 2**32, (B, 2), generator=gen, device=dev, dtype=torch.int64)
                if flags.get("stochastic") else None)
        params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
        masks = {k: v.bool() for k, v in task.grad_mask.items()}
        log = []
        restore = [event_timed(sf, timed_sf, log), event_timed(sa, ("select_pass",), log)]
        try:
            for c in counters:
                for k in c:
                    c[k] = 0
            rec, ms = timed(lambda: step(stims, keys))
            launched = {k: v for c in counters for k, v in c.items() if v}
        finally:
            for r in restore:
                r()
        dev_ms[name] = {}
        for fn, start, end in log:
            dev_ms[name][fn] = dev_ms[name].get(fn, 0.0) + start.elapsed_time(end)
        sk = rec["stats"]
        finite = {k: bool(torch.isfinite(p.grad).all()) for k, p in task.params.items()}
        main[name] = {"columns": sum(cpa), "T": T, "max_steps": max_steps, "flags": flags,
                      "loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                      "update_applied": bool(rec["ok"]), "grads_finite": finite,
                      "naccept": sk.naccept.tolist(), "nreject": sk.nreject.tolist(),
                      "success": sk.success.tolist(), "launches": launched,
                      "seconds": ms / 1e3, "device_ms": dev_ms[name]}
        check(launched == want, f"split2 {name}: launches {launched}")
        check(bool(torch.isfinite(rec["loss"])), f"split2 {name}: loss {rec['loss']}")
        if name != "adaptive_32":  # 3072 attempts end before 1 s at 32 columns, as at 13
            check(bool(sk.success.all()), f"split2 {name}: success {sk.success.tolist()}")
        for k, p in task.params.items():
            check(bool((p.grad[~masks[k]].nan_to_num(0.0, 0.0, 0.0) == 0).all()),
                  f"split2 {name}: {k} gradient off its mask")
        firsts[name] = (params0, stims, keys)
    emit("split2kernel_main_path", lanes=B, steps=main)

    # -- 54. card against CPU on the card's grid, the capped rule of phases 38 and
    # 49: the loss within the larger of 1e-5 and ten times its nudge spread, each
    # finite gradient within the larger of a floor (1e-3 deterministic, 3e-2
    # stochastic) and ten times the card's own spread under a 1e-7 nudge, a limit
    # of at most GRAD_TOL_CAP; a gradient not finite on the CPU must not be finite
    # on the card either --------------------------------------------------------------
    def one(name, params, T_c, grid=None):
        cpa, _, max_steps, flags, _ = paths[name]
        t = make_task(cpa, T_c, params=params, max_steps=max_steps)
        rec = parity.make_train_step(t, **flags)(*firsts[name][1:], grid=grid)
        return rec, {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}

    def compare(res, name, floor, T_c, loss_k, grads_k, loss_n, grads_n):
        loss_c, grads_c, _ = res[0]
        held = [k for k in grads_k if bool(torch.isfinite(grads_c[k]).all())]
        not_finite = [k for k in grads_k if k not in held]
        spread = {k: rel_l2(grads_n[k], grads_k[k]) for k in held}
        tol = {k: max(floor, 10.0 * spread[k]) for k in held}
        loss_tol = max(ODE_LOSS_TOL, 10.0 * abs(loss_n - loss_k) / abs(loss_k))
        entry = {"T": T_c, "held": held, "not_finite_on_either": not_finite,
                 "loss_rel": abs(loss_k - loss_c) / abs(loss_c), "loss_tol": loss_tol,
                 "grad_rel_l2": {k: rel_l2(grads_k[k], grads_c[k]) for k in held},
                 "card_grad_spread_under_1e-7_nudge": spread, "tol": tol}
        check(entry["loss_rel"] < loss_tol
              and all(entry["grad_rel_l2"][k] < tol[k] <= GRAD_TOL_CAP for k in held)
              and not any(bool(torch.isfinite(grads_k[k]).all()) for k in not_finite),
              f"card vs CPU split2 {name}: {entry}")
        return entry

    for name, T_c, floor in (("deterministic_32", S2K_GRAD_T32, ODE_GRAD_TOL),
                             ("adaptive_32", S2K_GRAD_T32, 3e-2),
                             ("adaptive_104", S2K_GRAD_T104, 3e-2)):
        p0 = firsts[name][0]
        rec_k, grads_k = one(name, p0, T_c)
        sk = rec_k["stats"]
        if paths[name][3].get("stochastic"):
            grid = (sk.step_times, sk.naccept, sk.nreject)
        else:
            grid = (sk.step_times, int(sk.naccept))
        rec_n, grads_n = one(name, {k: v * (1.0 + 1e-7) for k, v in p0.items()}, T_c, grid)
        cpa, _, max_steps, flags, _ = paths[name]
        cpu_later("split2kernel_cpu_check", name,
                  lambda res, a=(name, floor, T_c, float(rec_k["loss"]), grads_k,
                                 float(rec_n["loss"]), grads_n): compare(res, *a),
                  "parity", cfg, dict(columns_per_area=cpa, n_inputs=n_in, time_steps=T_c,
                                      max_steps=max_steps), flags,
                  args=firsts[name][1:], kwargs=dict(grid=grid), params_list=[p0])
    emit("split2kernel_card_vs_cpu", lanes=B, cpu_check="split2kernel_cpu_check",
         tol={"loss": "max(1e-5, 10 x spread)", "grad": "max(floor, 10 x spread) <= "
              f"{GRAD_TOL_CAP}; floor 1e-3 deterministic, 3e-2 stochastic"})

    # -- 55. times: each kernel and the outer pass from the main-path steps' CUDA
    # events, bounds, ns per serial step, the plain versions on a middle window,
    # the steps' profiles over SHORT_T points (the 104-column step's own) --------------
    P32, P104 = 8 * c32, 8 * sum(S2K_104_CPA)
    d32, a32, a104 = main["deterministic_32"], main["adaptive_32"], main["adaptive_104"]
    n_d = d32["naccept"]
    n_a32 = 2 * max(a32["naccept"])
    n_a104 = 2 * max(a104["naccept"])
    real32, real104 = 2 * sum(a32["naccept"]), 2 * sum(a104["naccept"])
    times = {"ode_replay_bwd_split2": dev_ms["deterministic_32"]["ode_replay_bwd_split2"],
             "ode_replay_fwd_split2_32": dev_ms["deterministic_32"]["ode_replay_fwd_split2"],
             "ode_select_32": dev_ms["deterministic_32"]["ode_select"],
             "sde2_bwd": dev_ms["adaptive_32"]["replay2_bwd"],
             "sde_replay_fwd_32": dev_ms["adaptive_32"]["replay_fwd"],
             "sde_select_jax_f32_32": dev_ms["adaptive_32"]["select_pass"],
             "outer_arg_grads_split2": dev_ms["adaptive_104"]["outer_arg_grads_split2"],
             "sde_replay_fwd_104": dev_ms["adaptive_104"]["replay_fwd"],
             "sde_replay_bwd_104": dev_ms["adaptive_104"]["replay_bwd"],
             "sde_select_jax_f32_104": dev_ms["adaptive_104"]["select_pass"]}
    serial = {"ode_replay_bwd_split2": n_d, "ode_replay_fwd_split2_32": n_d,
              "ode_select_32": n_d + d32["nreject"], "sde2_bwd": n_a32,
              "sde_replay_fwd_32": n_a32,
              "sde_select_jax_f32_32": max(a + r for a, r in zip(a32["naccept"], a32["nreject"])),
              "outer_arg_grads_split2": n_a104, "sde_replay_fwd_104": n_a104,
              "sde_replay_bwd_104": n_a104,
              "sde_select_jax_f32_104": max(a + r for a, r in zip(a104["naccept"],
                                                                  a104["nreject"]))}
    att32 = sum(a + r for a, r in zip(a32["naccept"], a32["nreject"]))
    att104 = sum(a + r for a, r in zip(a104["naccept"], a104["nreject"]))
    bounds = {
        "ode_replay_bwd_split2": split2_kernel_bound("ode_replay_bwd_split2", P32, B, n_in, K,
                                                     n_d),
        "ode_replay_fwd_split2_32": split2_bound("ode_replay_fwd_split2", P32, B, n_in, K, n_d),
        "ode_select_32": split2_bound("ode_select", P32, B, n_in, K, serial["ode_select_32"],
                                      M=EO_MAX_STEPS),
        "sde2_bwd": split2_kernel_bound("sde2_bwd", P32, B, n_in, K, real32, n_a32),
        "sde_replay_fwd_32": sde_bound("sde_replay_fwd", P32, B, n_in, K, real32, n_a32),
        "sde_select_jax_f32_32": jax_select_bound(P32, B, n_in, K, att32, S13_MAX_STEPS, True),
        "outer_arg_grads_split2": split2_kernel_bound("outer_arg_grads_split2", P104, B, n_in,
                                                      K, n_a104),
        "sde_replay_fwd_104": sde_bound("sde_replay_fwd", P104, B, n_in, K, real104, n_a104),
        "sde_replay_bwd_104": sde_bound("sde_replay_bwd", P104, B, n_in, K, real104, n_a104),
        "sde_select_jax_f32_104": jax_select_bound(P104, B, n_in, K, att104, PARITY_MAX_STEPS,
                                                   True)}
    profiles = {}
    for name, (cpa, T, max_steps, flags, _) in paths.items():
        T_p = min(T, SHORT_T)
        keys = (torch.randint(0, 2**32, (B, 2), generator=gen, device=dev, dtype=torch.int64)
                if flags.get("stochastic") else None)
        short_ms, wall, by_kernel = short_profile(
            parity.make_train_step(make_task(cpa, T_p, max_steps=max_steps), **flags),
            (make_parity_batch(gen, n_in, B, device=dev), keys))
        busy = sum(by_kernel.values())
        profiles[name] = {
            "T": T_p, "step_ms": short_ms, "profiled_wall_ms_per_step": wall,
            "device_busy_ms_per_step": busy if busy else "not measured",
            "idle_share": 1.0 - busy / short_ms if busy else "not measured",
            "top_ms_per_step": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])}
    emit("split2kernel_times", lanes=B, ms=times,
         ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         serial_steps=serial, bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()}, plain_ms=plain_ms,
         kernel_ms_on_plain_window=window_ms,
         step_seconds={k: v["seconds"] for k, v in main.items()}, profiles=profiles,
         outer_pass={"name": "outer_arg_grads_split2", "route": "PyTorch ops (XLA in the JAX "
                     "package, no Pallas kernel)", "replaces": "columnflow/solvers/fused.py:1373",
                     "ms": times["outer_arg_grads_split2"], "half_steps": n_a104,
                     "bound_ms": bounds["outer_arg_grads_split2"][0],
                     "bound_by": bounds["outer_arg_grads_split2"][1]})

    # -- 56. the command lines (run with the others at the end) ----------------------
    for argv, reach in ((["--smoke", "--engine", "fused-split2", "--columns-per-area", "16,8,8"],
                         True),
                        (["--smoke", "--stochastic", "--adaptive", "--engine", "fused-split2",
                          "--columns-per-area", "16,8,8"], False),
                        (["--smoke", "--stochastic", "--adaptive", "--engine", "fused-split2",
                          "--columns-per-area", "64,32,8", "--max-steps", "16384"], True)):
        defer_command_line("split2kernel_command_lines", "parity", argv, timeout=900,
                           finite=True, reach=reach)

    entries = {
        "ode_replay_bwd_split2": (ODE_SOURCE, "columnflow/solvers/fused.py:327",
                                  "deterministic fused-split2, 32 columns (kernel mode)",
                                  main["deterministic_32"]["launches"]),
        "sde2_bwd": (SDE_SOURCE, "columnflow/solvers/fused.py:920",
                     "parity32 --stochastic --adaptive --engine fused-split2 (kernel mode)",
                     main["adaptive_32"]["launches"]),
    }
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launched.get(name, 0), "max_abs_err": errs[name],
             "bit_for_bit": same[name], "ms": times[name], "plain_ms": plain_ms[name],
             "plain_ms_at": plain_ms[f"{name}_at"], "ms_window": window_ms[name],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
             "lanes": B, "path": path, "ns_per_serial_step": times[name] * 1e6 / serial[name]}
            for name, (src, rep, path, launched) in entries.items()]


# The Hopf MLP in outer mode (phases 57-60). The wide configuration: the
# task's own (batch 32, 1000 grid points over 25 s, max_steps 1024, rtol 1e-7
# / atol 1e-9, RMSprop) on the MLP 3-512-512-512-2, the smallest
# power-of-two width whose parameters (2,113,544 B) pass the 1 MiB past
# which the JAX package's arg_grads="auto" takes the parameter gradients
# outside the reverse sweep (columnflow/solvers/fused.py:571-574), at init
# std 0.1 sqrt(100/512): the reference's std scaled by the fan-in, so each
# layer's gain is the reference's (at 0.1 the state runs off). Built by hand
# around build_hopf_mlp(sizes=..., init_std=...), as a user of the JAX
# package would (its build_task takes no width).
HOPF_WIDE_SIZES = (3, 512, 512, 512, 2)
HOPF_WIDE_STD = 0.1 * (100 / 512) ** 0.5
HOPF_OUTER_SOURCE = "columnflow_torch/kernels/csrc/hopf_outer.cu"
HOPF_WIDE_ATTEMPTS = 8                    # attempts along the wide replay held against plain
HOPF_WIDE_STEPS = 1   # full-depth wide steps: the seed step takes 166 accepted steps (6.4 s
                      # on the H100), the next one 492 (18.7 s)
HOPF_CPU_T, HOPF_CPU_SPAN = 10, 0.25      # the wide card-vs-CPU step (~4 accepted steps)


def hopf_outer_phases(dev, cfg):
    """Phases 57-60: the Hopf MLP in outer mode, at the reference width
    (B8ho and the outer pass) and at width 512 (B6h-wide, B7h-wide,
    B8ho-wide and the outer pass); returns the new kernels' entries of the
    kernels line."""
    import torch

    from columnflow_torch.data import make_hopf_dataset
    from columnflow_torch.kernels import column_step as cs
    from columnflow_torch.kernels import hopf_ode as ho
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.kernels import xor_ode as xo
    from columnflow_torch.kernels import xor_sde as xs
    from columnflow_torch.models.hopf import build_hopf_mlp
    from columnflow_torch.ops.losses import smooth_l1
    from columnflow_torch.solvers import fused as sf
    from columnflow_torch.tasks import bifurcation as bt
    from columnflow_torch.tasks.wta import linspace
    from columnflow_torch.train.optim import torch_rmsprop

    counters = (ho.LAUNCHES, xo.LAUNCHES, xs.LAUNCHES, no.LAUNCHES, ns.LAUNCHES, cs.LAUNCHES)
    B, Hw = HOPF_B, HOPF_WIDE_SIZES[1]
    timed_fns = ("hopf_select", "hopf_replay_fwd", "hopf_replay_bwd_emit", "hopf_outer_arg_grads")

    def copy_into(task, params):
        with torch.no_grad():
            for layer, src in zip(task.params, params):
                for k, p in layer.items():
                    p.copy_(src[k])
        return task

    def ref_task(device=dev, params=None, T=HOPF_T, span=HOPF_SPAN):
        task = bt.build_task(torch.Generator(device=device).manual_seed(0), time_points=T,
                             total_time=span, max_steps=HOPF_MAX_STEPS, device=device)
        return task if params is None else copy_into(task, params)

    def wide_task(device=dev, params=None, T=HOPF_T, span=HOPF_SPAN):
        p = build_hopf_mlp(torch.Generator(device=device).manual_seed(0), sizes=HOPF_WIDE_SIZES,
                           init_std=HOPF_WIDE_STD, device=device)
        for layer in p:
            for v in layer.values():
                v.requires_grad_(True)
        ts = linspace(0.0, span, T, device=device)
        opt, _ = torch_rmsprop([v for layer in p for v in layer.values()], lr=1e-3, alpha=0.99)
        task = bt.HopfTask(p, ts, float((ts[1] - ts[0]).item()), opt, HOPF_MAX_STEPS)
        return task if params is None else copy_into(task, params)

    def outer_step(task):
        """make_train_step's step with arg_grads="outer" given:
        hopf_odeint_dopri5_fused, SmoothL1, backward, RMSprop."""
        def step(true_y, grid=None):
            task.optimizer.zero_grad(set_to_none=True)
            pred, stats = sf.hopf_odeint_dopri5_fused(
                task.params, true_y[:, :, 2], task.dt, true_y[0, :, :2], task.ts,
                max_steps=task.max_steps, grid=grid, return_stats=True, arg_grads="outer")
            loss = smooth_l1(pred, true_y[:, :, :2])
            loss.backward()
            task.optimizer.step()
            return {"loss": loss.detach(), "stats": stats}
        return step

    def grads_of(task):
        return {f"{i}.{k}": p.grad.detach().cpu().clone() for i, layer in enumerate(task.params)
                for k, p in layer.items()}

    def max_abs(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def counted(fn):
        """fn() with every launch counter at 0 before and read after, and a
        CUDA event pair around each kernel and outer-pass call of the step."""
        for c in counters:
            for k in c:
                c[k] = 0
        log = []
        restore = event_timed(sf, timed_fns, log)
        try:
            out, ms = timed(fn)
        finally:
            restore()
        dev_ms = {}
        for name, start, end in log:
            dev_ms[name] = dev_ms.get(name, 0.0) + start.elapsed_time(end)
        return out, ms, {k: v for c in counters for k, v in c.items() if v}, dev_ms

    # -- 57. B8ho against its plain version over phase 20's whole grid -------------------
    gen = torch.Generator(device=dev).manual_seed(5)
    task = ref_task()
    ds = make_hopf_dataset(gen, 2 * B, task.ts, device=dev)  # phase 20's two batches
    batch = ds[:, :B]
    mu = ho.MuTable(batch[:, :, 2].contiguous(), 0.0, task.dt)
    y0 = batch[0, :, :2].contiguous()
    params = [{k: v.detach().clone() for k, v in layer.items()} for layer in task.params]
    M = sf.round_max_steps((B, 2), HOPF_MAX_STEPS)
    scfg = ho.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]), max_steps=M)
    st, stats = ho.hopf_select(y0, params, mu, scfg)
    na = int(stats[0])
    stn = st[:na + 1].contiguous()
    ys, co = ho.hopf_replay_fwd(y0, stn, params, mu)
    cobar = torch.randn(co.shape, generator=gen, device=dev)
    yb, steps = ho.hopf_replay_bwd_emit(ys, cobar, stn, params, mu)
    (yb_p, steps_p), emit_plain_ms = timed(
        lambda: ho._hopf_replay_bwd_emit_plain(ys, cobar, stn, params, mu))
    yb_k, _ = ho.hopf_replay_bwd(ys, cobar, stn, params, mu)
    torch.cuda.synchronize()
    emit_same = torch.equal(yb, yb_p) and torch.equal(steps, steps_p)
    errs = {"hopf_replay_bwd_emit": max(max_abs(yb, yb_p), max_abs(steps, steps_p))}
    check(bool(torch.isfinite(steps).all()) and emit_same and torch.equal(yb, yb_k),
          f"hopf_replay_bwd_emit over the whole grid: ybar0 {max_abs(yb, yb_p)}, steps "
          f"{max_abs(steps, steps_p)}, ybar0 against B8h's {max_abs(yb, yb_k)}")
    emit("hopf_outer_emit_vs_plain", lanes=B, T=HOPF_T, max_steps=M, sweep_steps=na,
         tol="bit for bit", bit_for_bit=emit_same, ybar0_equals_kernel_mode=True,
         max_abs_err=errs, plain_ms=emit_plain_ms)

    # -- 58. the wide kernels against their plain versions ------------------------------------
    wtask = wide_task()
    wparams = [{k: v.detach().clone() for k, v in layer.items()} for layer in wtask.params]
    check(sf.hopf_arg_grads(wparams) == "outer" and ho._kernel_ready(wparams, B) == Hw,
          "the wide MLP's mode")
    plain_ms = {"hopf_replay_bwd_emit": emit_plain_ms}
    wst, wstats = ho.hopf_select(y0, wparams, mu, scfg)
    (wst_p, wstats_p), plain_ms["hopf_select_wide"] = timed(
        lambda: ho._hopf_select_plain(y0, wparams, mu, scfg))
    wna, wnr, wok = (int(x) for x in wstats)
    wna_p = int(wstats_p[0])
    sel_equal = wstats.tolist() == wstats_p.tolist() and torch.equal(wst, wst_p)
    d_st = (wst[:min(wna, wna_p) + 1] - wst_p[:min(wna, wna_p) + 1]).abs()
    parted = int(torch.nonzero(d_st).min()) if bool((d_st > 0).any()) else None
    check(wok == 1 and int(wstats_p[2]) == 1 and abs(wna - wna_p) <= 0.01 * wna_p + 1
          and torch.equal(wst[:11], wst_p[:11]),
          f"hopf_select_wide: stats {wstats.tolist()} vs plain {wstats_p.tolist()}, "
          f"first parted index {parted}")
    errs["hopf_select_wide"] = float(d_st.max())
    wstn = wst[:wna + 1].contiguous()
    wys, wco = ho.hopf_replay_fwd(y0, wstn, wparams, mu)
    (wys_p, wco_p), plain_ms["hopf_replay_fwd_wide"] = timed(
        lambda: ho._hopf_replay_fwd_plain(y0, wstn, wparams, mu))
    check(bool(torch.isfinite(wco).all()) and torch.equal(wys, wys_p) and torch.equal(wco, wco_p),
          f"hopf_replay_fwd_wide: ys {max_abs(wys, wys_p)}, rows {max_abs(wco, wco_p)}")
    errs["hopf_replay_fwd_wide"] = max(max_abs(wys, wys_p), max_abs(wco, wco_p))
    att = {"equal": True, "accepted": 0}
    for r in range(HOPF_WIDE_ATTEMPTS):
        k = int(r / HOPF_WIDE_ATTEMPTS * (wna - 1))
        t, y = wstn[k].clone(), wys[k].contiguous()
        h = ((wstn[k + 1] - wstn[k]) * (1.0, 1.5, 2.5)[r % 3]).clone()
        f0 = ho.hopf_ode_drift(t, y, wparams, mu).contiguous()
        a = ho.hopf_attempt(t, y, f0, h, wparams, mu, scfg)
        a_p = ho._hopf_attempt_plain(t, y, f0, h, wparams, mu, scfg)
        att["equal"] &= all(torch.equal(g, w) for g, w in zip(a, a_p))
        att["accepted"] += int(a.ratio <= 1.0)
    check(att["equal"], f"hopf_attempt_wide: {att}")
    wcobar = torch.randn(wco.shape, generator=gen, device=dev)
    wyb, wsteps = ho.hopf_replay_bwd_emit(wys, wcobar, wstn, wparams, mu)
    (wyb_p, wsteps_p), plain_ms["hopf_replay_bwd_emit_wide"] = timed(
        lambda: ho._hopf_replay_bwd_emit_plain(wys, wcobar, wstn, wparams, mu))
    check(bool(torch.isfinite(wsteps).all()) and torch.equal(wyb, wyb_p)
          and torch.equal(wsteps, wsteps_p),
          f"hopf_replay_bwd_emit_wide: ybar0 {max_abs(wyb, wyb_p)}, steps "
          f"{max_abs(wsteps, wsteps_p)}")
    errs["hopf_replay_bwd_emit_wide"] = max(max_abs(wyb, wyb_p), max_abs(wsteps, wsteps_p))
    emit("hopf_wide_kernel_vs_plain", lanes=B, sizes=HOPF_WIDE_SIZES, init_std=HOPF_WIDE_STD,
         param_bytes=4 * sum(v.numel() for layer in wparams for v in layer.values()),
         T=HOPF_T, max_steps=M,
         selection={"stats": [wna, wnr, wok], "stats_plain": wstats_p.tolist(),
                    "bit_for_bit": sel_equal, "first_parted_index": parted},
         attempt={"records": HOPF_WIDE_ATTEMPTS, **att}, replay_steps=wna, sweep_steps=wna,
         tol="bit for bit", max_abs_err=errs, plain_ms=plain_ms)

    # -- 59. the main paths ---------------------------------------------------------------------
    # (a) the reference-width step in outer mode, from the seed weights.
    p0 = host(task.params)
    rec_a, ms_a, launched_a, dev_a = counted(lambda: outer_step(task)(batch))
    check(launched_a == {"hopf_select": 1, "hopf_replay_fwd": 1, "hopf_replay_bwd_emit": 1},
          f"hopf outer step: launches {launched_a}")
    ska = rec_a["stats"]
    check(bool(torch.isfinite(rec_a["loss"])) and bool(ska.success),
          f"hopf outer step: loss {rec_a['loss']}, success {bool(ska.success)}")
    g_outer = grads_of(task)
    grid_a = (ska.step_times, int(ska.naccept))
    t_k = ref_task(params=p0)
    rec_k = bt.make_train_step(t_k)(batch, grid=grid_a)
    g_kernel = grads_of(t_k)
    t_n = ref_task(params=[{k: v * (1.0 + 1e-7) for k, v in layer.items()} for layer in p0])
    outer_step(t_n)(batch, grid=grid_a)
    g_nudged = grads_of(t_n)
    spread = {k: rel_l2(g_nudged[k], g_outer[k]) for k in g_outer}
    tol = {k: max(HOPF_GRAD_TOL, 10.0 * spread[k]) for k in g_outer}
    vs_kernel = {"loss_equal": float(rec_a["loss"]) == float(rec_k["loss"]),
                 "grad_rel_l2": {k: rel_l2(g_outer[k], g_kernel[k]) for k in g_outer},
                 "card_grad_spread_under_1e-7_nudge": spread, "tol": tol}
    check(vs_kernel["loss_equal"] and all(vs_kernel["grad_rel_l2"][k] < tol[k] for k in tol),
          f"hopf outer step against kernel mode: {vs_kernel}")
    ref_main = {"loss": float(rec_a["loss"]), "naccept": int(ska.naccept),
                "nreject": int(ska.nreject), "success": bool(ska.success), "seconds": ms_a / 1e3,
                "launches": launched_a, "device_ms": dev_a, "against_kernel_mode": vs_kernel}

    # (b) the wide make_train_step at full depth.
    wp0 = host(wtask.params)
    wstep = bt.make_train_step(wtask)
    wide_main = []
    for i in range(HOPF_WIDE_STEPS):
        rec_b, ms_b, launched_b, dev_b = counted(lambda: wstep(batch))
        check(launched_b == {"hopf_select_wide": 1, "hopf_replay_fwd_wide": 1,
                             "hopf_replay_bwd_emit_wide": 1},
              f"wide hopf step {i}: launches {launched_b}")
        skb = rec_b["stats"]
        check(bool(torch.isfinite(rec_b["loss"])) and bool(skb.success)
              and all(bool(torch.isfinite(p.grad).all()) for layer in wtask.params
                      for p in layer.values()),
              f"wide hopf step {i}: loss {rec_b['loss']}, success {bool(skb.success)}")
        wide_main.append({"loss": float(rec_b["loss"]), "naccept": int(skb.naccept),
                          "nreject": int(skb.nreject), "success": bool(skb.success),
                          "seconds": ms_b / 1e3, "launches": launched_b, "device_ms": dev_b})

    # The wide step over HOPF_CPU_T points on the card and again on the CPU with
    # the plain versions on the card's grid, beside the card's nudge spread.
    short_y = make_hopf_dataset(torch.Generator(device=dev).manual_seed(5), 2 * B,
                                linspace(0.0, HOPF_CPU_SPAN, HOPF_CPU_T, device=dev),
                                device=dev)[:, :B]

    def wide_short(params, grid=None):
        t = wide_task(dev, params, T=HOPF_CPU_T, span=HOPF_CPU_SPAN)
        rec = bt.make_train_step(t)(short_y, grid=grid)
        return rec, grads_of(t)

    rec_s, g_s = wide_short(wp0)
    sks = rec_s["stats"]
    grid_s = (sks.step_times, int(sks.naccept))
    rec_n, g_n = wide_short([{k: v * (1.0 + 1e-7) for k, v in layer.items()} for layer in wp0],
                            grid_s)

    def compare(res, loss_s=float(rec_s["loss"]), g_s=g_s, g_n=g_n, naccept=grid_s[1]):
        loss_c, g_c, _ = res[0]
        wspread = {k: rel_l2(g_n[k], g_s[k]) for k in g_s}
        wtol = {k: max(HOPF_GRAD_TOL, 10.0 * wspread[k]) for k in g_s}
        entry = {"T": HOPF_CPU_T, "span": HOPF_CPU_SPAN, "naccept": naccept,
                 "loss_rel": abs(loss_s - loss_c) / abs(loss_c),
                 "grad_rel_l2": {k: rel_l2(g_s[k], g_c[k]) for k in g_s},
                 "card_grad_spread_under_1e-7_nudge": wspread,
                 "tol": {"loss": HOPF_LOSS_TOL, "grad": wtol}}
        check(entry["loss_rel"] < HOPF_LOSS_TOL
              and all(entry["grad_rel_l2"][k] < wtol[k] for k in g_s),
              f"card vs CPU wide hopf step: {entry}")
        return entry

    cpu_later("hopf_outer_cpu_check", "wide", compare, "hopf_wide", None,
              dict(sizes=HOPF_WIDE_SIZES, init_std=HOPF_WIDE_STD, T=HOPF_CPU_T,
                   span=HOPF_CPU_SPAN, max_steps=HOPF_MAX_STEPS), {},
              args=(short_y,), kwargs=dict(grid=grid_s), params_list=[wp0])
    emit("hopf_outer_main_path", lanes=B, T=HOPF_T, max_steps=M, reference_outer=ref_main,
         wide=wide_main, wide_cpu_check="hopf_outer_cpu_check")

    # -- 60. times --------------------------------------------------------------------------
    wide0 = wide_main[0]
    times = {"hopf_replay_bwd_emit": dev_a["hopf_replay_bwd_emit"],
             "hopf_select_wide": wide0["device_ms"]["hopf_select"],
             "hopf_replay_fwd_wide": wide0["device_ms"]["hopf_replay_fwd"],
             "hopf_replay_bwd_emit_wide": wide0["device_ms"]["hopf_replay_bwd_emit"],
             "hopf_outer_arg_grads": dev_a["hopf_outer_arg_grads"],
             "hopf_outer_arg_grads_wide": wide0["device_ms"]["hopf_outer_arg_grads"],
             "hopf_select_in_outer_step": dev_a["hopf_select"],
             "hopf_replay_fwd_in_outer_step": dev_a["hopf_replay_fwd"]}
    n_a, n_b = ref_main["naccept"], wide0["naccept"]
    serial = {"hopf_replay_bwd_emit": n_a, "hopf_select_wide": n_b + wide0["nreject"],
              "hopf_replay_fwd_wide": n_b, "hopf_replay_bwd_emit_wide": n_b,
              "hopf_outer_arg_grads": n_a, "hopf_outer_arg_grads_wide": n_b,
              "hopf_select_in_outer_step": n_a + ref_main["nreject"],
              "hopf_replay_fwd_in_outer_step": n_a}
    bounds = {name: hopf_bound(name.removesuffix("_in_outer_step"), serial[name], M=M,
                               H=Hw if name.endswith("_wide") else None) for name in times}

    def seed_steps(make_task, make_step, true_y):
        t = make_task()
        seed = host(t.params)
        step = make_step(t)

        def run(i=0):
            copy_into(t, seed)
            return step(true_y)
        return run

    def profile(run, T, n):
        """A warm-up, n timed steps and n profiled ones, each from the seed
        weights (a trained step would replay another grid)."""
        run()
        step_ms = sum(timed(run)[1] for _ in range(n)) / n
        wall, by_kernel = device_profile(run, n)
        busy = sum(by_kernel.values())
        return {"T": T, "step_ms": step_ms, "profiled_wall_ms_per_step": wall,
                "device_busy_ms_per_step": busy if busy else "not measured",
                "idle_share": 1.0 - busy / step_ms if busy else "not measured",
                "top_ms_per_step": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])}

    # Both profiled over the first SHORT_T points of the grid (the profiler's
    # own cost on the outer pass's launches is ~4 s a full-horizon step).
    short_span = float(task.ts[SHORT_T - 1])
    profiles = {"reference_outer": profile(seed_steps(lambda: ref_task(T=SHORT_T, span=short_span),
                                                      outer_step, ds[:SHORT_T, :B]), SHORT_T, 1),
                "wide": profile(seed_steps(lambda: wide_task(T=SHORT_T, span=short_span),
                                           bt.make_train_step, ds[:SHORT_T, :B]), SHORT_T, 1)}
    emit("hopf_outer_times", lanes=B, ms=times, serial_steps=serial,
         ns_per_serial_step={k: times[k] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()}, plain_ms=plain_ms,
         step_seconds={"reference_outer": ref_main["seconds"],
                       "wide": [w["seconds"] for w in wide_main]},
         profiles=profiles,
         outer_passes={name: {"route": "PyTorch ops (XLA in the JAX package, no Pallas kernel)",
                              "replaces": "columnflow/solvers/fused.py:645",
                              "ms": times[name], "steps": serial[name],
                              "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
                       for name in ("hopf_outer_arg_grads", "hopf_outer_arg_grads_wide")})

    entries = {
        "hopf_replay_bwd_emit": (HOPF_OUTER_SOURCE, "columnflow/solvers/fused.py:620", launched_a,
                                 "Hopf, arg_grads='outer' (reference width)"),
        "hopf_select_wide": (HOPF_OUTER_SOURCE, "columnflow/solvers/fused.py:590",
                             wide0["launches"], "Hopf, 3-512-512-512-2 MLP"),
        "hopf_replay_fwd_wide": (HOPF_OUTER_SOURCE, "columnflow/solvers/fused.py:606",
                                 wide0["launches"], "Hopf, 3-512-512-512-2 MLP"),
        "hopf_replay_bwd_emit_wide": (HOPF_OUTER_SOURCE, "columnflow/solvers/fused.py:620",
                                      wide0["launches"], "Hopf, 3-512-512-512-2 MLP"),
    }
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launched.get(name, 0), "max_abs_err": errs[name], "bit_for_bit": True,
             "ms": times[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None, "lanes": B, "path": path,
             "ns_per_serial_step": times[name] * 1e6 / serial[name]}
            for name, (src, rep, launched, path) in entries.items()]


# The selection as cluster teams (csrc/sde_select_team.cu): the instances the
# main paths run (select16 on both trees, f32 on the jax.random tree) at the
# widths and lane counts the other phases do not hold against their plain
# loop (phases 5, 24, 29, 35 and 52 hold 104-column select16 krng, 13-column
# f32, 104-column select16 jax, 104-column f32 and 32-column f32; 35-36 the
# three-term split (B5t) at 13 and 104 columns), the split's attempts, and
# every team route timed beside the one-block kernel.
ST_CPA = {3: (2, 1), 13: (8, 4, 1), 32: (16, 8, 8), 104: (64, 32, 8)}
ST_T = 25           # grid points of the timing windows
ST_PLAIN_T = 12     # grid points of the 13- and 32-column selections held against their plain
                    # loops (over 25 the six plain loops took 49 s: cut in depth for the time
                    # limit)
ST_T104 = 12        # grid points of the 8-lane selections at 104 columns (plain loop ~6 s each)
ST_INSTANCES = (("select16", "jax"), ("select16", "kernel"), ("f32", "jax"))
SELECT_TEAM_SOURCE = "columnflow_torch/kernels/csrc/sde_select_team.cu"
# The kernels line's selection entries and the (columns, lanes, drift, tree)
# of their team_routes timing.
SELECT_TEAM_ENTRIES = {"sde_select": (104, 4, "select16", "kernel"),
                       "sde_select_jax_select16": (104, 4, "select16", "jax"),
                       "sde_select_jax_f32_104": (104, 4, "f32", "jax"),
                       "sde_select_jax_f32": (13, 4, "f32", "jax"),
                       "sde_select_jax_f32_32": (32, 4, "f32", "jax"),
                       "sde_select_krng_split3": (104, 4, "split3", "kernel")}
SELECT_TEAMS = {}   # filled by select_team_phases: team_routes of each timed shape


def select_team_phases(dev, cfg):
    """Phases 61-62: the selection teams against their plain versions where
    no other phase holds them, and every route timed."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.models.network import premix_select16
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(61)

    def inputs(columns, lanes, T):
        task = parity.build_task(cfg, torch.Generator(device=dev).manual_seed(0),
                                 columns_per_area=ST_CPA[columns], n_inputs=4, time_steps=T,
                                 max_steps=PARITY_MAX_STEPS, device=dev)
        stims = make_parity_batch(gen, 4, lanes, device=dev)
        keys = torch.randint(0, 2**32, (lanes, 2), generator=gen, device=dev, dtype=torch.int64)
        model = parity.sde_model(task.params, task, stims)
        pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
        return task, model, {"select16": premix_select16(pw), "f32": pw,
                             "split3": ns.select_weights_split3(pw, model.sc)}, keys

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # -- 61. kernel vs plain, bit for bit ----------------------------------------
    t_phase = time.perf_counter()
    held, attempts_held = {}, {}
    for columns, lanes, T in ((13, 4, ST_PLAIN_T), (32, 4, ST_PLAIN_T), (104, 8, ST_T104)):
        task, model, ws, keys = inputs(columns, lanes, T)
        P = task.net.num_pops
        y0 = torch.zeros(lanes, 3 * P, device=dev)
        for drift, tree in ST_INSTANCES:
            name = f"{columns}_{lanes}_{drift}_{tree}"
            scfg = sa.select_config(task.ts, max_steps=PARITY_MAX_STEPS, brownian=tree,
                                    drift=drift)
            words = sa._sde_key_words(keys, tree)
            before = dict(ns.LAUNCHES)
            got = ns.select_pass(y0, words, ws[drift], model.sc, model.kv, scfg)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
            t0 = time.perf_counter()
            want = ns._select_plain(y0, words, ws[drift], model.sc, model.kv, scfg)
            plain_s = time.perf_counter() - t0
            route, plan = ns._select_team(None, P, 4, lanes, scfg)
            held[name] = {"T": T, "route": route, "C": plan.C, "bit_for_bit": equal(got, want),
                          "naccept": got[1].tolist(), "naccept_plain": want[1].tolist(),
                          "nreject": got[2].tolist(), "nreject_plain": want[2].tolist(),
                          "max_abs_err": float((got[0] - want[0]).abs().max()),
                          "launches": launched, "plain_seconds": plain_s}
            check(held[name]["bit_for_bit"] and bool(got[3].all())
                  and launched == {"sde_select": 1},
                  f"selection team {name} against its plain loop: {held[name]}")
    # 16 attempts a shape from states in the rates' regimes, steps 1e-6 to 1e-3.
    for columns in (13, 32, 104):
        task, model, ws, keys = inputs(columns, 4, ST_T)
        P, N = task.net.num_pops, 16
        lane = torch.arange(N, device=dev) % 4
        a = 5.0 * torch.rand(N, P, generator=gen, device=dev)
        y1 = torch.cat([a + 80.0 * torch.rand(N, P, generator=gen, device=dev) - 40.0, a,
                        40.0 * torch.rand(N, P, generator=gen, device=dev)], dim=1)
        t1 = (0.9 * float(task.ts[-1]) * torch.rand(N, 1, generator=gen, device=dev)).contiguous()
        h = (1e-6 * 10.0 ** (torch.arange(N, device=dev)[:, None] % 4)).contiguous()
        kv = model.kv[:, lane].contiguous()
        for drift, tree in ST_INSTANCES + (("split3", "kernel"),):
            scfg = sa.select_config(task.ts, max_steps=PARITY_MAX_STEPS, brownian=tree,
                                    drift=drift)
            words = sa._sde_key_words(keys, tree)[lane].contiguous()
            args = (t1, y1, h, torch.full((N, 1), 0.7, device=dev),
                    ns._tree(words, scfg).evaluate(t1).contiguous(), words, ws[drift],
                    model.sc, kv, scfg)
            want = ns._attempt_plain(*args)
            block = ns.select_attempt(*args, route="block")
            for route in (None, "streamed"):
                name = f"{columns}_{drift}_{tree}_{route or 'default'}"
                got = ns.select_attempt(*args, route=route)
                # From these extreme states (large, cancelling rate terms) the
                # three float64 orders (the team's butterfly, the one-block
                # kernel's rows in order, cuBLAS's under the plain body) can
                # round a rec to different float32: held as the single-attempt
                # card test holds them (the decision, h, t_new and W(t + h)
                # equal; err rel 1e-5, h_next rel 1e-6, y_new 1e-5 of each
                # component's largest magnitude), and every differing element
                # counted.
                e = {"err_rel": float(((got.err - want.err).abs()
                                       / want.err.clamp_min(1e-30)).max()),
                     "h_next_rel": float(((got.h_next - want.h_next).abs()
                                          / want.h_next).max()),
                     "y_new_scaled": scaled_err(got.y_new, want.y_new)}
                attempts_held[name] = {
                    "bit_for_bit": equal(got, want), **e,
                    "differing_from_plain": {f: int((g != w).sum()) for f, g, w in
                                             zip(got._fields, got, want)},
                    "block_differing_from_plain": sum(int((b != w).sum())
                                                      for b, w in zip(block, want)),
                    "differing_from_block": sum(int((g != b).sum())
                                                for g, b in zip(got, block))}
                check(all(torch.equal(g, w) for g, w in
                          zip((got.accept, got.h, got.t_new, got.w1),
                              (want.accept, want.h, want.t_new, want.w1)))
                      and e["err_rel"] < 1e-5 and e["h_next_rel"] < 1e-6
                      and e["y_new_scaled"] < 1e-5,
                      f"attempt team {name}: {attempts_held[name]}")
    emit("select_team_vs_plain", selections=held, attempts=attempts_held,
         seconds=time.perf_counter() - t_phase)

    # -- 62. every route timed (CUDA events) on a ST_T-point window ----------------
    t_phase = time.perf_counter()
    timed = {}
    caps = {}
    for columns, lanes in ((3, 4), (13, 4), (32, 4), (104, 4), (104, 8)):
        task, model, ws, keys = inputs(columns, lanes, ST_T)
        P = task.net.num_pops
        y0 = torch.zeros(lanes, 3 * P, device=dev)
        for drift, tree in ST_INSTANCES + (("split3", "kernel"), ("f32", "kernel")):
            scfg = sa.select_config(task.ts, max_steps=PARITY_MAX_STEPS, brownian=tree,
                                    drift=drift)
            words = sa._sde_key_words(keys, tree)
            run = lambda r: ns.select_pass(y0, words, ws[drift], model.sc, model.kv, scfg,
                                           route=r)
            ref = run(None)
            serial = int((ref[1] + ref[2]).max())
            default, plan = ns._select_team(None, P, 4, lanes, scfg)
            routes = [default] + (["streamed"] if default == "resident" else []) + ["block"]
            entry = {"route": default, "C": plan.C, "plan": plan._asdict(),
                     "serial_attempts": serial}
            for r in routes:
                got = run(r)
                if r == "block":
                    # the one-block kernel sums in another float64 order: the
                    # first accepted index where its grid parts, if any
                    d = (got[0] != ref[0]).any(dim=0)
                    entry["block_bit_for_bit"] = equal(got, ref)
                    entry["block_first_parted_index"] = (int(torch.nonzero(d).min())
                                                         if bool(d.any()) else None)
                else:  # the team's routes sum in one order
                    check(equal(got, ref), f"route {r} at {columns} columns ({drift}, {tree}) "
                                           "parts from the team's default route")
                entry[f"{r}_us_per_attempt"] = cuda_ms(lambda: run(r), reps=3,
                                                       warmup=1) * 1e3 / serial
            timed[f"{columns}_{lanes}_{drift}_{tree}"] = entry
            SELECT_TEAMS[columns, lanes, drift, tree] = entry
        if columns == 104 and lanes == 4:
            for drift in ("select16", "f32", "split3"):
                for C in (c for c in (8, 16) if P % c == 0):
                    stream = ns.sde_select_plan(P, 4, drift, C).stream
                    caps[f"{drift}_C{C}"] = ns.sde_select_max_clusters(
                        P, 4, "kernel" if drift == "split3" else "jax", drift, C, stream)
    emit("select_team_routes", T=ST_T, us_per_attempt=timed,
         max_active_clusters_at_104_columns=caps, seconds=time.perf_counter() - t_phase)
    return []


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.kernels import _build

    dev = torch.device("cuda")

    # -- 0. card --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cudnn is on")
    emit("card", nvidia_smi=smi, device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)

    cfg = ColumnConfig.load()
    frozen = {}  # the split2 phase's 104-column grid, replayed by the exact engine's phases
    start_cpu_workers()
    try:
        line = (wta_phases(dev, cfg) + parity_phases(dev, cfg) + ode_phases(dev, cfg)
                + split2_phases(dev, cfg, frozen) + xor_phases(dev, cfg)
                + xor_adaptive_phases(dev, cfg)
                + hopf_phases(dev, cfg)
                + stochastic13_phases(dev, cfg) + bench104_phases(dev, cfg)
                + fixedgrid104_phases(dev, cfg) + exact104_phases(dev, cfg)
                + exactode_phases(dev, cfg, frozen) + split2kernel_phases(dev, cfg)
                + hopf_outer_phases(dev, cfg) + select_team_phases(dev, cfg))
        run_command_lines(meanwhile=finish_cpu_checks)
    finally:
        stop_cpu_workers()
    for entry in line:
        if entry["name"] in SELECT_TEAM_ENTRIES:
            entry["source"] = SELECT_TEAM_SOURCE
            entry["kernel"] = "sde_select_team_kernel (a cluster team per lane)"
            entry["team_routes"] = SELECT_TEAMS.get(SELECT_TEAM_ENTRIES[entry["name"]])
        if entry["name"] in REPLAY2_CHECKS:
            by_cols = REPLAY2_CHECKS[entry["name"]]
            entry["max_abs_err"] = max([entry["max_abs_err"]]
                                       + [c["max_abs_err"] for c in by_cols.values()])
            entry["held_by_columns"] = by_cols
    emit("replay2_checks", **REPLAY2_CHECKS)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
