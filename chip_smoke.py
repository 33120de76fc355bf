#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit.  It drives every arm of the JAX package's ``bench.py``, fifteen
runs of the model zoo, the output layer, MAP, SMC and the profiling tools
through the port's public entry points (``mcmc``, ``advi``,
``summarystats``, ``rhat_rank``, ``ess_bulk``, ``forward_sample``,
``gelmandiag``, ``dic``, ``predict``, ``write_chains``/``read_chains``,
``plot``/``draw``, ``optim_over``, ``smc``, ``utils.profiling``,
``utils.roofline``), in these phases:

1. device: the card's name, power limit and SM clocks;
2. build: ``mamba_tpu_torch/csrc/fused_glmm.cu`` and
   ``mamba_tpu_torch/csrc/threefry.cu`` with nvcc (sm_90a), one nvcc each,
   started together;
3. kernel: the fused GLMM kernel against its plain torch version in five
   cases (``KERNEL_CASES``): full width, where both are timed; a ragged
   edge; one chain; a shape that takes the generic kernel; and full width
   near a posterior mode, where ``grad_beta`` cancels;
3a. threefry: the keyed-draw kernel (``ops/random.py``) against its plain
   torch version on 1024 chain keys: folded keys, splits, 32- and 64-bit
   bits, float32 and float64 uniforms (scaled too), a draw at a rank's
   counters, one folded with a device tensor, one from a view of a split
   and one from an expanded key, all identical; float32 and float64
   normals within ``THREEFRY_NORMAL_ULPS``; then timed at a rats NUTS
   momentum draw (1024 x 62) and a GLMM ChEES one (1024 x 10,005), folded
   as the samplers draw them, beside the plain version and ``torch.randn``
   of the same shape, with its bound;
3b. graphs: the engine replays its samplers' steps from CUDA graphs
   (``utils/graphs.py``); rats NUTS with its Gibbs block, GLMM ChEES and
   the centered GLMM (NUTS through the fused kernel, then a Gibbs draw of
   s2) at full width, and the
   zoo's samplers at 1024 chains (``GRAPH_ZOO_ARMS``: univariate Slice on
   pumps, AMWG with both forms of Slice on inhalers, AMWG with univariate
   Slice on magnesium, SliceSimplex on asthma, BHMC, BIA, BMC3 and BMG on
   pollution, AMM on seeds, HMC, MALA and RWM on line, ABC on line_abc and
   gk, MISS on mice, bones and kidney), 3 iterations (2 burnin) each, run
   through those graphs and through the samplers' plain loops
   (``graphs.disabled()``) from one seed, held bit-identical (draws, tunes,
   final state and every chain's key, NUTS's tree depths), with the fused
   kernel's launches counted through the replays at least the gradient
   evaluations, and every Gibbs block (rats', the centered GLMM's and
   pollution's two) replayed once an iteration;
4. GLMM recovery: ``glmm.build(G=64, fused=True)`` under NUTS, 4 chains,
   ``z`` monitored for the post phase;
5. GLMM NUTS at full width: G = 10,000, 1024 chains, a short run;
6. rats NUTS, the bench's headline: ``rats.build("nuts")``, 1024 chains,
   cut from 1500 to 30 iterations (15 burnin), gated on the golden
   mu_beta mean (rank R-hat and bulk ESS printed; they are gated only for
   runs of 500 kept draws or more, and ``scripts/rats_headline.py`` runs
   the full 1500/500 under them);
7. rats ChEES: ADVI warm start (``RATS_CHEES_ADVI_STEPS``, longer than
   bench.py's 1500 steps, whose q has not converged), then ChEES-HMC with
   the conjugate Gibbs block, 1024 chains x 1500 iterations (500 burnin),
   gated on the golden mu_beta mean, rank R-hat < 1.01 and bulk ESS > 400;
8. zoo: pumps, surgical, seeds (its reference scheme) and mice (NaN inits,
   MISS) with the schemes their ``build()`` gives, 1024 chains each, gated
   on the golden means of the JAX package's golden tests with those tests'
   tolerances (``ZOO_RUNS``), on finite draws, and on no draw having come
   from the global generator; each run prints its CUDA graphs, their
   capture seconds, replays, host tests and peak device memory;
9. zoo_mv, the multivariate half of the zoo (``ZOO_MV_RUNS``), 1024 chains
   each: eyes (DGS on 48 indicators, its sweep replayed from a CUDA graph
   and held equal to the eager sweep; SliceSimplex), jaws (BDiagNormal,
   InverseWishart under AMWG) and line_abc (ABC) under the golden gates of
   the JAX package's tests; pollution under each of its five binary
   schemes (DGS gated on gamma[9] > 0.8 and gamma[2] < 0.6, BHMC's wall
   hits per trajectory printed and held below ``max_hits``); short runs of
   asthma (Multinomial, row simplexes), birats (MvNormal rows and an
   InverseWishart under NUTS) and gk (a user distribution fit by ABC).
   Every run is held to finite draws inside the support and draws
   posterior-predictive data through ``forward_sample``; no draw may come
   from a global generator; each run prints what zoo's runs print;
10. GLMM ChEES at full width: ADVI on the generic build, then ChEES-HMC
    through the fused kernel, 1024 chains, bench.py's 1300 iterations (300
    burnin), under bench.py's gates: every beta mean within 0.05 of the
    truth, s2's within 0.1, rank R-hat < 1.01 and bulk ESS > 400;
11. post: the output layer on the 1024-chain pumps and jaws runs of phases
    8 and 9 (``gelmandiag`` with MPSRF on the link scale, ``dic``,
    ``logpdf_chains`` against ``compiled.logpdf``, ``predict`` inside the
    data's support, a restart from a chain file bit-identical to the
    restart from memory, SVG plots), the per-chain diagnostics on rats
    ChEES's first 8 chains, and ``logpdf_chains``/``dic`` of the recovery
    run through the kernel against the generic build;
12. map: ``optim_over`` (L-BFGS) on the full-width GLMM through the kernel,
    against the truth, the inits and the generic build; a MAP warm start
    of line;
13. smc: the conjugate model and line under the gates of
    tests/test_infer.py, and the G = 64 GLMM through the kernel's ``vmap``
    rule over 1024 particles;
14. profile: one ``torch.profiler`` trace of full-width gradients, which
    must name the kernel, and of two more iterations of phase 6's rats
    NUTS run, the device's busy share over them; ``time_compiled``
    against phase 3's CUDA events, the card's peaks and the kernel's bound
    from ``utils/roofline.py``, its ``roofline`` reading and the
    elementwise ceiling;
15. mesh (``parallel/``, after phase 10): (a) ``graft_entry.dryrun_multichip(1)``;
    (b) the GLMM ChEES run of phase 10, cut to ``MESH_CHEES_RUN``, through
    ``mcmc(mesh=)`` on a one-rank NCCL mesh in this process, its (epsilon,
    traj) path equal to phase 10's over the warmup iterations both share;
    (c) that run in two processes over gloo on
    this one card, 512 chains each, their draws gathered on both and their
    step size and trajectory equal after every iteration; (d) in the same
    two processes, a (1, 2) data mesh: the GLMM's block density and
    gradient at 1024 chains from the kernel over each rank's 5,000 groups,
    summed over the data group, against one launch over all groups, under
    phase 3's gates; (e) in the same two processes, local views: y, the
    covariates xt and z named on the data axis (``LOCAL_SPECS``), so each
    rank holds y (1024, 10, 5,000), xt (4, 10, 5,000) and z (1024, 5,000),
    its ChEES block the rank's 5,005 coordinates (z's slice, beta and s2);
    (b)'s run on that mesh (finite draws, equal on both ranks), its peak
    memory rise against the same steps without a mesh (at least
    ``LOCAL_MEM_SAVED_MIN`` lower; printed beside the rise when z was whole,
    ``LOCAL_RISE_Z_WHOLE``), the block density and gradient at the warm
    starts completed over the ranks against the whole under phase 3's
    gates (the slice coordinates against the whole gradient's slice) with
    one launch per call over the rank's 5,000 groups, the block's
    all-reduce of one call timed ((1024, 6): the value and the whole
    coordinates' gradient); in this process, the device ms of a
    density and gradient whole and as a rank holds it, fused and generic;
    (f) a sharded run's chain file: both ranks of (c) and of (e) call
    ``write_chains``, and this process reads each file on the card
    (``read_chains``: y is the data, z (1024, 10,000), the draws (c)'s and
    (e)'s) and runs ``POST_RESTART`` more iterations on one device,
    bit-identical to the restart from the same whole state built here from
    the ranks' own, with rank 0's tunes and every chain's key; (g) in the
    same two processes, models whose data-axis layout needs the
    compiler's resolved cases, on the (1, 2) data mesh: the GLMM with
    z ~ Normal(w, 1), w (10,000,) named
    (a sampled site whose prior reads a slice, held as the rank's slice),
    its density and gradient
    at the warm starts against the whole (one launch over 5,000 groups), a
    short run and its peak memory rise; birats with Y and beta named (a
    law per row) and line with mean(y) and ss = sum((y - mu)**2) monitored
    (a constant and a node computed again from whole values), each held
    to the unsharded model at its inits (density, monitored rows) and run
    a few iterations, draws finite and equal on both ranks; (h) in the same
    two processes, the rats NUTS headline cut to ``RATS_DATA_MESH_RUN`` at
    1024 chains on the (1, 2) data mesh with y, alpha and beta named (the
    JAX package's own data-mesh setup, __graft_entry__.py:57): each rank
    holds 15 rats of each, draws finite and equal on both ranks, phase 6's
    mu_beta gate, its wall per leapfrog; (i) in the same two processes,
    phase 6's rats NUTS run on the (2, 1) chain mesh, 512 chains a rank, each chain keyed by its
    global index: the gathered draws held chain by chain to phase 6's
    (``RATS_CHAIN_IDENTICAL_MIN``, ``RATS_CHAIN_MAX_DIFF``), the share of
    bit-identical chains and the largest difference printed; (j) in the
    same two processes, the GLMM with only its data named (y and xt, or y
    and x for the generic form: ``DATA_SPECS``), so z and b stay whole and
    y reads the rank's slice of b: both forms' block density and gradient
    at phase 10's warm starts against the whole under phase 3's gates (the
    fused kernel once per call over the rank's 5,000 groups), the fused
    form under ChEES cut to ``MESH_CHEES_RUN`` (draws finite and equal on
    both ranks, its wall per gradient, its all-reduce of (1024,) and
    (1024, 10,005) timed, its kernel launches counted in the kernels
    line), then small fixtures (``_fixture_models``: line with a prior on
    ss = sum((y - mu)**2), gathered per density call; mean(y) under MISS,
    gathered per step; line's own five points padded to six; the rows of
    v ~ MvNormal(stack([w, w]), I); birats' law recycled over its rows)
    at their inits against the unsharded model (density, a block's
    density and gradient, monitored rows; 1024 chains) and run a few
    iterations at ``FIXTURE_CHAINS``, draws finite and equal on both
    ranks; then the
    kernel at a rank's shares (C = 512; G = 5,000;
    C = 513, G = 5,000, not a multiple of its 4-chain tile) against its
    plain version, the first two timed with their bounds; (k) in the same
    two processes, three arms on the (1, 2) data mesh for
    ``MESH_GRAPH_RUN``, each through the engine's captured steps and under
    ``graphs.disabled()`` from one seed: (h)'s rats NUTS layout, (e)'s
    GLMM ChEES and (j)'s fused data-only GLMM under ChEES; equal bit for
    bit (draws, tunes, final state, keys, tree depths or trajectory
    lengths), the captured draws equal on both ranks, each way's wall per
    leapfrog or gradient, the segments replayed and collectives run per
    leapfrog or gradient and their host ms, the fused kernel's launches
    inside the captured segments (counted in the kernels line).  Since
    the data axis replays, (e), (g), (h) and (j) run captured too: a body
    that reaches a collective is cut there, and the collective runs
    between the segments' replays (``utils/graphs.py``); a block that
    cannot capture fails its phase.  Both ranks share the one card: no
    number of (c)-(k) is a scaling figure.  (l) several data axes, as the
    JAX package's PartitionSpecs name them, in four gloo processes of one
    ``run_ranks`` call on the one card: rats NUTS on a (1, 2, 2) chains x
    data x week mesh (``RATS_AXES_SPECS``: y cut by rat and by week, the
    five weeks padded to six, Xm by week, alpha and beta by rat and so
    replicated over week, their gradient summed over it), cut to
    ``RATS_DATA_MESH_RUN`` under phase 6's mu_beta gate, then
    ``MESH_GRAPH_RUN`` captured against plain, equal bit for bit; on a
    (1, 2, 2) chains x data x obs mesh the fused GLMM with its groups over
    the tuple ("data", "obs") (``GLMM_TUPLE_SPECS``: each rank launches the
    kernel over its 2,500 groups) and the generic GLMM cut by groups and
    observations (``GLMM_TWO_DIM_SPECS``), each block density and gradient
    at the warm starts against the whole under phase 3's gates, then the
    fused form under ChEES at ``MESH_CHEES_RUN``, captured, draws finite
    and equal on every rank; in this process the kernel timed at a rank's
    share (C = 1024, G = 2,500).  Four processes share the card: no number
    of (l) is a scaling figure.

    python3 chip_smoke.py --mesh-rank <init_method> <rank> <dir>

runs one rank of (c), (d), (e), (g), (h), (i), (j) and (k), and writes
(f)'s files;

    python3 chip_smoke.py --axes-rank <init_method> <rank> <dir>

one of (l)'s four.

The kernel's paths (phases 3b's ChEES and centered GLMM arms, 5, 10, 12, 13 and 15's runs) each set its launch
count to 0 just before they run and read it just after; a launch captured
in a CUDA graph counts once per replay.  So does the threefry kernel's
count around every phase from 3b on that draws (all but map), and the
script fails if one of them launched it no time.  Every phase raises on
failure.  The engine's loop runs on the host, so the time follows the
host's CPU, and each phase's wall is printed.  The
last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it lists the two kernels; the fused one with its launches on the main paths, its
error, its time, the plain version's, and the least time the card could take
(``bound_ms``, from ``ops.fused_glmm.glmm_bound_ms``: the floors set by
memory, float32 arithmetic and the special-function pipe are in
``floors_ms``, for the kernel's arithmetic and for the form with a polynomial
logarithm; ``bound_floor`` names the one that sets the bound); the threefry
kernel with its launches on the main paths, its largest normal error, its
time, the plain version's and ``torch.randn``'s at the GLMM ChEES momentum
draw, and its bound (the keys read and the numbers written over 3.35 TB/s,
or the hash's integer operations over the card's int32 lanes, whichever
is larger).  With no CUDA device the script exits with status 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: phase-3 cases: C chains, G groups, and unless given n = 10 observations
#: and P = 4 effects, which is the shape the register kernel is compiled for;
#: P = 3, n = 7 takes the generic kernel.  ``near_mode`` takes the GLMM's own
#: data with every chain close to the truth, where grad_beta cancels.
KERNEL_CASES = (
    {"C": 1024, "G": 10_000},
    {"C": 1000, "G": 9_999},
    {"C": 1, "G": 37},
    {"C": 33, "G": 300, "P": 3, "n": 7},
    {"C": 1024, "G": 10_000, "near_mode": True},
)
#: lp relative error: a sum of 100k negative terms has no cancellation
LP_RTOL = 1e-5
#: gradient error max|d| / max|g_ref| over (grad_beta, grad_b): every
#: contraction is float32 FMA
GRAD_RTOL = 1e-4

CHAINS = 1024
#: GLMM NUTS at full width (phase 5): iterations, burnin
GLMM_NUTS_RUN = (10, 5)
#: rats NUTS headline (phase 6), cut from bench.py's 1500/500
#: (bench.py:39-46) and gated on the golden mu_beta mean.  The engine now
#: runs the full 1500/500 in about two minutes, but there bench.py's rank
#: R-hat gate fails at the default seed: one of the 1024 chains from the
#: over-dispersed second init is still far from the posterior when warmup
#: ends (R-hat 1.0108 on an H100; the JAX package on the CPU at the same
#: seed: 1.0156, five such chains).  ``python3 -m mamba_tpu_torch.scripts.rats_headline``
#: runs the full headline under its three gates (PERF.md §6)
RATS_NUTS_RUN = (30, 15)
#: mesh part (h), rats NUTS on the (1, 2) data mesh, captured: its leaf
#: cut at the density's all-reduce and at the leaf's sums, both staged
#: through the host under gloo (on the plain loops, before the data axis
#: replayed, 10.38-15.8 ms per leapfrog; 0.35-0.46 captured without a
#: mesh).  Cut from phase 6's 30/15 to the least depth at which its mu_beta gate
#: held at every seed probed: ``scripts/gate_probe.py rats-nuts`` on an
#: H100 at seeds 123 and 1-4, without a mesh, gave margins 0.029-0.076 at
#: 12/6 (0.072 at this script's seed 123); at 10/5 seed 1 failed by 0.041
#: and at 8/4 three seeds failed (PERF.md §6)
RATS_DATA_MESH_RUN = (12, 6)
#: the graphs phase: iterations and burnin of the rats NUTS and GLMM ChEES
#: runs made with the engine's captured steps and with the plain loops
GRAPH_CHECK_RUN = (3, 2)
#: mesh part (k): the same for each data-mesh arm, in the mesh processes,
#: and its ChEES arms' initial trajectory length: long enough that each
#: iteration replays the leapfrog several times (at the graphs phase's 0.2
#: the first iterations take one or two)
MESH_GRAPH_RUN = (3, 2)
MESH_GRAPH_CHEES_TRAJ = 2.0
#: the graphs phase's initial ChEES trajectory length
GRAPH_CHEES_TRAJ = 0.2
#: the graphs phase's zoo arms: model, scheme (for line, the samplers of
#: tests/test_torch_samplers_extra.py's schemes), each run captured and plain
GRAPH_ZOO_ARMS = (("pumps", None), ("inhalers", None), ("magnesium", None),
                  ("asthma", None), ("pollution", "bhmc"),
                  ("seeds", "reference"), ("line", "hmc_slice"),
                  ("line", "mala_slice"), ("line", "rwm_slice_uni"),
                  ("pollution", "bia"), ("pollution", "bmc3"),
                  ("pollution", "bmg"), ("line_abc", None), ("gk", None),
                  ("mice", None), ("bones", None), ("kidney", None))
#: iterations that continue phase 6's run inside the profile phase's trace,
#: over which the device's busy share is read
BUSY_ITERS = 2
#: rats ChEES (phase 7): bench.py:63-98's run, 1024 chains
RATS_CHEES_RUN = (1500, 500)
#: its ADVI warm start's steps, where bench.py takes 1500 (nmc 4, seed 1):
#: after 1500 steps q has not converged (its means of s2_c and s2_beta are
#: 202.4 and 0.103, after 5000 steps 38.4 and 0.297; s2_c's posterior mean
#: is 37.25), and a chain drawn from its tail can fall into the funnel where
#: s2_beta and the spread of beta shrink together and ChEES's shared step
#: no longer moves it.  The JAX package on the CPU in float32 left one to
#: four such chains in 6 of 9 runs at 1500 steps (rank R-hat over 1.01 in
#: 2), in 6 of 8 with 32 draws a step in place of 4, and none in 8 after
#: 5000 steps (R-hat 1.0040-1.0045); on the card this phase's R-hat at
#: 1500 steps was 1.0166 (ROADMAP Queue 3, PERF.md §6)
RATS_CHEES_ADVI_STEPS = 5000
#: GLMM ChEES at full width (phase 10): bench.py's 1300/300, under its
#: gates (bench.py:154-156): every beta mean within ``GLMM_BETA_TOL`` of the
#: truth, the s2 mean within ``GLMM_S2_TOL``, rank R-hat and bulk ESS
GLMM_CHEES_RUN = (1300, 300)
GLMM_BETA_TOL, GLMM_S2_TOL = 0.05, 0.1
#: the mesh phase's runs of the same arm ((b), (c), (e)): a data rank's
#: gradient costs 65-77 ms of wall through gloo, so they stay short; (b)
#: is held to phase 10's (epsilon, traj) path over the warmup iterations
#: the two runs share
MESH_CHEES_RUN = (20, 10)
#: zoo (phase 8): model, scheme, iterations, burnin, and the gates of the JAX
#: package's golden test of that model, {label: (golden mean, tolerance)}
#: (tests/test_models_golden.py).  Those tests run 2 chains for 6,000-8,000
#: iterations; with 1024 chains the kept draws can be few, and the depth is
#: what the over-dispersed second init needs to reach the posterior under
#: the reference's proposal widths.  No run keeps ``MIN_KEPT`` draws, so rank
#: R-hat is printed and not gated: seeds' AMM + AMWG scheme is far from it at
#: this depth in the JAX package too (its s2 collapses from b = 0 and takes
#: about 8,000 iterations to come back).  pumps was cut from 300/250,
#: surgical from 400/350 and mice from 600/500, each where a CPU run at 64
#: chains still cleared every gate (PERF.md §4); seeds and the zoo_mv runs
#: keep their depths, their gates' margins being thin.
ZOO_RUNS = (
    ("pumps", None, 280, 250, {"alpha": (0.6968, 0.08), "beta": (0.9304, 0.16),
                               "theta[1]": (0.0599, 0.01)}),
    ("surgical", None, 300, 250, {"mu": (-2.550, 0.12),
                                  "pop_mean": (0.0731, 0.01),
                                  "p[1]": (0.0536, 0.012)}),
    ("seeds", "reference", 2000, 1600, {"alpha0": (-0.5562, 0.15),
                                        "alpha12": (-0.7464, 0.3),
                                        "s2": (0.0857, 0.07)}),
    ("mice", None, 450, 400, {"r": (3.27, 0.45), "median[1]": (22.8, 1.5),
                              "median[2]": (26.5, 1.8)}),
)
#: zoo_mv (phase 9): the models of the multivariate half of the zoo, each
#: with its ``build()`` scheme and both inits, at 1024 chains: model, scheme,
#: iterations, burnin, and the gates {label: (golden mean, tolerance)} of the
#: JAX package's golden test of that model (tests/test_models_golden.py).
#: Runs with no gates are short runs, held to finite draws inside their
#: support, their means printed beside ``GOLDEN``; pollution's DGS run is held
#: to gamma[9] > 0.8 and gamma[2] < 0.6 instead.  Depths are what the
#: over-dispersed inits need (CPU runs at 64 chains in both packages): eyes'
#: lam[2] clears its gate after ~1,000 iterations, jaws' Sigma[4,4] after
#: ~250, line_abc's beta[1] after ~150.
ZOO_MV_RUNS = (
    ("eyes", None, 1100, 1050, {"P[1]": (0.6036, 0.08), "lam[1]": (536.753, 1.5),
                                "lam[2]": (548.987, 1.5)}),
    ("jaws", None, 400, 300, {"beta1": (1.8743, 0.1), "Sigma[1,1]": (6.7916, 1.5),
                              "Sigma[4,4]": (8.0594, 1.8)}),
    ("pollution", "dgs", 300, 200, {}),
    ("pollution", "bhmc", 6, 3, {}),
    ("pollution", "bmc3", 40, 20, {}),
    ("pollution", "bmg", 40, 20, {}),
    ("pollution", "bia", 40, 20, {}),
    ("line_abc", None, 300, 200, {"beta[1]": (0.7235, 0.4),
                                  "beta[2]": (0.7747, 0.15),
                                  "s2": (1.3074, 0.9)}),
    ("asthma", None, 40, 20, {}),
    ("birats", None, 4, 2, {}),
    ("gk", None, 60, 30, {}),
)
#: GLMM recovery (phase 4): iterations, burnin; cut from 400/150:
#: the beta gate is 0.35, and the error was 0.194 at 200/100 on the card and
#: 0.198 at 150/75 on the CPU (the posterior mean of this data lies ~0.17
#: from the truth; PERF.md §4)
RECOVERY_RUN = (150, 75)
#: the post phase's runs, reused from the zoo and zoo_mv phases: models whose
#: sampled nodes are all monitored (dic and predict need their draws)
POST_ZOO = ("pumps", "jaws")
#: iterations of each restart in the post phase (from the file, from memory)
POST_RESTART = 20
#: stored draws at which logpdf_chains is held against compiled.logpdf, and
#: the relative tolerance (float32 sums of tens of terms)
POST_DIRECT_DRAWS, POST_DIRECT_RTOL = 16, 1e-5
#: fused against generic modelstats on the recovery run (float32 GLMM
#: likelihoods over 640 observations, summed in another order)
POST_FUSED_RTOL = 1e-4
#: rats ChEES chains the per-chain diagnostics run on (host loops)
POST_DIAG_CHAINS = 8
#: the map phase: the largest error of the MAP beta at G = 10,000 against the
#: truth, and of the fused build's (float32, through the kernel) against the
#: generic build's in float64.  On the CPU both packages give a MAP beta
#: 0.1304 from the truth at this G in float64 (the joint mode of a logistic
#: model with 10 observations per group lies farther from zero than the
#: truth), and the port's fused float32 MAP lies 5e-5 from the float64 one
#: (PERF.md §6)
MAP_BETA_TOL = 0.15
MAP_FUSED_TOL = 1e-3
#: the smc phase's particles; the GLMM's beta gate is the recovery gate, and
#: its run takes 20 RWM steps per stage: with the default 10, four seeds
#: gave beta 0.17-0.28 from the truth in float32 on the CPU (the posterior
#: mean lies 0.17 from it), with 20 0.16-0.22 (PERF.md §6)
SMC_PARTICLES, SMC_GLMM_PARTICLES, SMC_BETA_TOL = 4096, 1024, 0.35
SMC_GLMM_STEPS = 20
#: the profile phase: full-width gradients traced, and how far
#: time_compiled's time may lie from phase 3's CUDA-event time
PROFILE_GRADIENTS, PROFILE_TIME_RTOL = 5, 0.2
#: the mesh phase: the two processes of (c)-(j) must end within this
#: many seconds, and a collective may wait this many
MESH_RANKS_TIMEOUT, MESH_GROUP_TIMEOUT = 700, 120
#: the mesh phase's model width (phase 10's)
MESH_G = 10_000
#: convergence gates of bench.py:48-52
RHAT_MAX = 1.01
ESS_MIN = 400.0
#: kept draws below which a cut run is not held to R-hat and ESS
MIN_KEPT = 500
#: rats golden mu_beta (doc/examples/rats.rst:42-47) and the gate on it
MU_BETA, MU_BETA_TOL = 6.1831, 0.1
#: where the main paths run
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


def sm_clocks_mhz():
    """The card's SM clock now and at its most, in MHz."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    now, most = smi.stdout.strip().splitlines()[0].split(",")
    return float(now), float(most)


def phase_build(fg, rnd):
    """Both kernels' sources compiled at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for lib in [pool.submit(m.build_library) for m in (fg, rnd)]:
            lib.result()
    fg._lib()
    rnd._lib()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for report in (fg.BUILD_LOG, rnd._lib_path().with_name("libthreefry.build.log")):
        for line in report.read_text().splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line):
                log("  " + line.strip())


def _event_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_case(torch, fg, glmm_cases, C, G, n=10, P=4, seed=0, near_mode=False,
                time_reps=0):
    """Kernel (float32) against the plain version in float64 on the same
    inputs, with the float32 plain version's own errors beside it; with
    ``time_reps`` also ms per call of the kernel and of the float32 plain
    version."""
    arrays = (glmm_cases.near_mode_inputs(G, C, seed, n=n) if near_mode
              else glmm_cases.random_inputs(P, n, G, C, seed))
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                 for a in arrays)
    plan = fg.kernel_plan(P, n, G, C)
    lp, gbeta, gb = fg.glmm_loglik_grads(*args)
    torch.cuda.synchronize()
    ref = fg.glmm_loglik_grads_plain(*(a.double() for a in args))
    out = {"C": C, "G": G, "n": n, "P": P, "near_mode": near_mode, **plan,
           **glmm_cases.glmm_errors((lp, gbeta, gb), ref)}
    plain32 = glmm_cases.glmm_errors(fg.glmm_loglik_grads_plain(*args), ref)
    out["plain_float32"] = {k: plain32[k] for k in ("grad_rel_err",
                                                     "gbeta_rel_err")}
    del ref
    # bit-for-bit reproducible: no float atomics in the reduction
    lp2, gbeta2, gb2 = fg.glmm_loglik_grads(*args)
    out["reproducible"] = bool(torch.equal(lp, lp2) and torch.equal(gbeta, gbeta2)
                               and torch.equal(gb, gb2))
    if time_reps:
        kern = lambda: fg.glmm_loglik_grads(*args)           # noqa: E731
        plain = lambda: fg.glmm_loglik_grads_plain(*args)    # noqa: E731
        for fn in (kern, plain):
            fn()
        # alternate plain, kernel, kernel, plain on one card
        p1 = _event_ms(torch, plain, time_reps)
        k1 = _event_ms(torch, kern, time_reps)
        k2 = _event_ms(torch, kern, time_reps)
        p2 = _event_ms(torch, plain, time_reps)
        out.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                   ms_runs=[k1, k2], plain_ms_runs=[p1, p2])
        clock_now, clock_max = sm_clocks_mhz()
        bound = fg.glmm_bound_ms(P, n, G, C, 1e6 * clock_max)
        out.update(bound=bound, sm_clock_mhz=clock_now,
                   sm_clock_max_mhz=clock_max,
                   pct_of_bound=100 * bound["bound_ms"] / out["ms"])
    log("kernel vs plain: " + json.dumps(out))
    if not (out["lp_rel_err"] <= LP_RTOL and out["grad_rel_err"] <= GRAD_RTOL):
        raise AssertionError(f"fused GLMM kernel disagrees with its plain "
                             f"version at C={C}, G={G}: {out}")
    if not out["reproducible"]:
        raise AssertionError(f"fused GLMM kernel is not reproducible at C={C}, G={G}")
    want = "glmm_reg_kernel" if (P, n) == (4, 10) else "glmm_generic_kernel"
    if plan["kernel"] != want:
        raise AssertionError(f"P={P}, n={n} ran {plan['kernel']}, not {want}")
    return out


def phase_kernels(torch, fg, glmm_cases):
    return [kernel_case(torch, fg, glmm_cases, **case, time_reps=20 if i == 0 else 0)
            for i, case in enumerate(KERNEL_CASES)]


#: phase 3's threefry draws: the rats NUTS momentum and a GLMM ChEES one
#: (1024 chains x the block's coordinates), float32 and folded as the
#: samplers draw them (``coords.randn(key, x, fold=0)``)
THREEFRY_SHAPES = {"rats_nuts_momentum": 62, "glmm_chees_momentum": 10_005}
#: a normal may differ from the plain version's by this many float32 ulp
#: (CUDA's erfinvf in both, so 0 is expected; the uniforms are bit-identical)
THREEFRY_NORMAL_ULPS = 2
#: integer operations of one threefry2x32 (20 rounds of add, rotate and
#: xor; 5 key injections of two adds; the key schedule), and the card's
#: int32 lanes an SM a clock (half its 128 float32 lanes)
THREEFRY_INT_OPS, INT32_LANES = 78, 64


def _threefry_bound(keys, n, dtype, sm_mhz):
    """(bound_ms, bound_by, bytes, int ops) of one draw of ``n`` numbers a
    key, folded once a key as the main path draws: the keys read and the
    numbers written once over 3.35 TB/s, and the hashes' integer operations
    (one a number, and one a key for the fold) over 132 SMs' int32 lanes at
    ``sm_mhz``."""
    rows = keys.shape[0]
    nbytes = rows * 16 + rows * n * dtype.itemsize
    ops = rows * (n + 1) * THREEFRY_INT_OPS
    byte_ms = 1e3 * nbytes / 3.35e12
    op_ms = 1e3 * ops / (132 * INT32_LANES * sm_mhz * 1e6)
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations",
            nbytes, ops)


def phase_threefry(torch, rnd):
    """The threefry kernel against its plain version on the card, on chain
    keys: bits, uniforms (float32 and float64, scaled too), folded keys,
    splits, draws at a rank's counters, with a fold tensor, from a view of a
    split and from one expanded key, identical; normals within
    ``THREEFRY_NORMAL_ULPS``.  Then its time at the two momentum draws as
    the samplers make them (folded with 0) beside the plain version's and
    ``torch.randn``'s of the same shape, and its bound."""
    keys = rnd.chain_keys(7, range(CHAINS), DEVICE)
    plain = rnd.threefry_plain
    idx = torch.tensor([3, 0, 61, 17, 40], device=DEVICE)
    fold = torch.full((1,), 9, dtype=torch.int64, device=DEVICE)
    sub = rnd.split(keys)[1]                   # rows 2 * 2 words apart
    one = rnd.key(11, DEVICE).expand(CHAINS, 2)
    same = {
        "folded": (rnd.fold_in(keys, 5), plain("folded", keys, fold=5)),
        "split": (rnd.split(keys, 3),
                  plain("words", keys, (3,)).movedim(1, 0)),
        "bits32": (rnd.bits(keys, (62,)), plain("bits32", keys, (62,))),
        "bits64": (rnd.bits(keys, (62,), 64), plain("bits64", keys, (62,))),
        "uniform32": (rnd.uniform(keys, (2, 31), torch.float32),
                      plain("uniform", keys, (2, 31), torch.float32)),
        "uniform64": (rnd.uniform(keys, (62,), torch.float64, fold=4),
                      plain("uniform", keys, (62,), torch.float64, fold=4)),
        "uniform_scaled": (rnd.uniform(keys, (62,), torch.float32, -2.5, 3.0),
                           plain("uniform", keys, (62,), torch.float32,
                                 minval=-2.5, maxval=3.0)),
        "index": (rnd.uniform(keys, (62,), torch.float32, index=idx),
                  plain("uniform", keys, (62,), torch.float32, index=idx)),
        "fold_tensor": (rnd.uniform(keys, (62,), torch.float32, fold=fold),
                        plain("uniform", keys, (62,), torch.float32, fold=9)),
        "split_view": (rnd.uniform(sub, (62,), torch.float32, fold=0),
                       plain("uniform", sub.contiguous(), (62,),
                             torch.float32, fold=0)),
        "expanded": (rnd.fold_in(one, torch.arange(CHAINS, device=DEVICE)),
                     plain("folded", one.contiguous(),
                           fold=torch.arange(CHAINS, device=DEVICE))),
    }
    torch.cuda.synchronize()
    res = {"identical": {k: bool(torch.equal(a, b)) for k, (a, b) in same.items()}}
    ulps, errs = {}, {}
    for dtype in (torch.float32, torch.float64):
        for name, n in THREEFRY_SHAPES.items():
            a = rnd.normal(keys, (n,), dtype, fold=0)
            b = plain("normal", keys, (n,), dtype, fold=0)
            d = (a - b).abs()
            spacing = torch.finfo(dtype).eps * b.abs().clamp(min=1e-3)
            tag = f"{dtype}:{name}"
            ulps[tag] = float((d / spacing).max())
            errs[tag] = float(d.max())
    res["normal_ulps"], res["normal_max_abs_err"] = ulps, errs
    _, sm_mhz = sm_clocks_mhz()
    res["timed"] = {}
    for name, n in THREEFRY_SHAPES.items():
        reps = 200
        kernel_ms = _event_ms(torch, lambda: rnd.normal(keys, (n,), fold=0),
                              reps)
        plain_ms = _event_ms(torch, lambda: plain("normal", keys, (n,),
                                                  torch.float32, fold=0), 5)
        randn_ms = _event_ms(torch, lambda: torch.randn(
            (CHAINS, n), device=DEVICE), reps)
        bound_ms, bound_by, nbytes, ops = _threefry_bound(
            keys, n, torch.float32, sm_mhz)
        res["timed"][name] = {"shape": [CHAINS, n], "fold": 0,
                              "ms": kernel_ms, "plain_ms": plain_ms,
                              "randn_ms": randn_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "bytes": nbytes,
                              "int_ops": ops, "sm_mhz": sm_mhz,
                              "max_abs_err": errs[f"torch.float32:{name}"]}
    log("threefry: " + json.dumps(res))
    bad = [k for k, v in res["identical"].items() if not v]
    bad += [k for k, v in ulps.items() if v > THREEFRY_NORMAL_ULPS]
    if bad:
        raise AssertionError(f"threefry kernel disagrees with its plain "
                             f"version: {bad}")
    return res


def _recording(module, name, pick):
    """Wrap ``module.name`` so every call's ``pick(output)`` is appended to a
    list (the smoke test's own instrument; the sampler is unchanged).
    Returns the list and a function that restores the original."""
    seen = []
    inner = getattr(module, name)

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(pick(out))
        return out

    setattr(module, name, recording)
    return seen, lambda: setattr(module, name, inner)


def _record_depths(nuts):
    """Every NUTS transition's per-chain tree depth."""
    return _recording(nuts, "nuts_sub", lambda out: out[3].detach().cpu())


def _nuts_work(torch, depths):
    """Mean and max tree depth, and the leapfrog steps the lockstep chains
    evaluated: an iteration costs the deepest chain's 2**depth - 1."""
    d = torch.stack(depths)                    # (iterations, chains)
    return {"mean_tree_depth": float(d.float().mean()),
            "max_tree_depth": int(d.max()),
            "leapfrog_steps": int((2 ** d.max(dim=1).values.long() - 1).sum())}


def _timing(sim, chains, iters):
    t = sim.timing
    return {"setup_s": t["setup_s"], "sample_s": t["sample_s"],
            "fetch_s": t["fetch_s"],
            "chain_iters_per_s": chains * iters / t["sample_s"],
            # graphs captured in the run (one per segment of a body cut at
            # its collectives), their capture time (inside sample_s), graph
            # replays (one per segment), host tests of a device flag, and
            # the collectives run between replays with their host seconds;
            # reported on a CUDA device
            "graphs": t.get("graphs", 0), "capture_s": t.get("capture_s", 0.0),
            "replays": t.get("replays", 0), "host_tests": t.get("host_tests", 0),
            "collectives": t.get("collectives", 0),
            "collective_s": t.get("collective_s", 0.0)}


def _monitor(model, name):
    """``model`` with node ``name`` monitored (its draws stored)."""
    import dataclasses
    model.nodes[name] = dataclasses.replace(model.nodes[name], monitor=True)
    return model


def _tunes_equal(torch, ta, tb):
    """Every block's tune equal, field by field."""
    def same(u, v):
        if isinstance(u, torch.Tensor):
            return isinstance(v, torch.Tensor) and torch.equal(u, v)
        if isinstance(u, tuple):
            return (isinstance(v, tuple) and len(u) == len(v)
                    and all(same(a, b) for a, b in zip(u, v)))
        return u == v
    return same(tuple(ta), tuple(tb))


def _graph_pair(torch, mt, graphs, run):
    """``run()`` twice from one seed: through the engine's captured steps
    and under ``graphs.disabled()``, the samplers' plain loops as the
    stand-alone ``nuts_step`` and ``chees_step`` run them.  Returns both
    results and walls."""
    out = {}
    for way in ("graphed", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if way == "plain":
            with graphs.disabled():
                res = run()
        else:
            res = run()
        torch.cuda.synchronize()
        out[way] = (res, time.perf_counter() - t0)
    return out


def _same_run(torch, a, b):
    return bool(np.array_equal(a.value, b.value)
                and _tunes_equal(torch, a.states["tunes"], b.states["tunes"])
                and all(torch.equal(a.states["state"][k], b.states["state"][k])
                        for k in a.states["state"])
                and torch.equal(a.states["key"], b.states["key"]))


def _zoo_build(mt, name, scheme):
    """A zoo model with its scheme; for line, one of the schemes of
    tests/test_torch_samplers_extra.py."""
    import importlib
    if name == "line":
        from mamba_tpu_torch.models import line
        model, inputs, inits = line.build()
        model.set_samplers({
            "hmc_slice": [mt.HMC("beta", 0.2, 4), mt.Slice("s2", 1.0, transform=True)],
            "mala_slice": [mt.MALA("beta", 0.05), mt.Slice("s2", 3.0)],
            "rwm_slice_uni": [mt.RWM("beta", np.array([1.0, 0.3])),
                              mt.Slice("s2", 3.0, form="univariate")]}[scheme])
        return model, inputs, inits
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    return mod.build() if scheme is None else mod.build(scheme)


def _graph_zoo(torch, mt, graphs):
    """``GRAPH_ZOO_ARMS``, each captured and plain from one seed at 1024
    chains: whether the two runs are equal, their walls and the captured
    run's graphs, capture seconds, replays and host tests."""
    iters, burnin = GRAPH_CHECK_RUN
    out = {}
    for name, scheme in GRAPH_ZOO_ARMS:
        def run(name=name, scheme=scheme):
            model, inputs, inits = _zoo_build(mt, name, scheme)
            return _gibbs_replayed(mt, model, lambda: mt.mcmc(
                model, inputs, inits, iters, burnin=burnin, chains=CHAINS,
                verbose=False, device=DEVICE))
        pair = _graph_pair(torch, mt, graphs, run)
        (g_sim, g_gibbs), g_s = pair["graphed"]
        (p_sim, p_gibbs), p_s = pair["plain"]
        label = name if scheme is None else f"{name}:{scheme}"
        out[label] = {
            "equal": _same_run(torch, g_sim, p_sim),
            "graphed_s": g_s, "plain_s": p_s,
            **{k: g_sim.timing.get(k, 0)
               for k in ("graphs", "capture_s", "replays", "host_tests")},
            "plain_host_tests": p_sim.timing.get("host_tests", 0),
            **_gibbs_gate(g_gibbs, p_gibbs, iters)}
        log(f"graphs: zoo {label}, captured against plain: "
            + json.dumps(out[label]))
    return out


def _gibbs_replayed(mt, model, run):
    """``run()`` with every captured Gibbs step recorded
    (``samplers.custom.drawing``): its result, and the model's Gibbs blocks
    with the replays of their captured steps (a plain run makes none)."""
    from mamba_tpu_torch.samplers import custom
    caps, restore = _recording(custom, "drawing", lambda cap: cap)
    try:
        res = run()
    finally:
        restore()
    blocks = sum(isinstance(s, mt.Gibbs) for s in model.samplers)
    return res, {"blocks": blocks, "captured": len(caps),
                 "replays": sum(c.replays for c in caps)}


def _gibbs_gate(graphed, plain, iters):
    """The Gibbs keys of a graphs-phase arm: its blocks, their replays in
    the captured run, and whether every block replayed once an iteration
    there and captured nothing in the plain run."""
    return {"gibbs_blocks": graphed["blocks"],
            "gibbs_replays": graphed["replays"],
            "gibbs_replayed": (graphed["captured"] == graphed["blocks"]
                               and graphed["replays"] == graphed["blocks"] * iters
                               and plain["captured"] == 0)}


def phase_graphs(torch, mt, rats, glmm, fg, nuts, chees):
    """The engine's captured steps against the samplers' plain loops, from
    one seed at full width: rats NUTS (draws, tunes, final state and every
    transition's tree depths), GLMM ChEES through the fused kernel
    (draws, tunes, final state; the kernel's launches counted through the
    graph's replays at least the gradient evaluations, and at least the
    plain loop's, which launches once per evaluation), the centered GLMM
    (``_graph_glmm_centered``) and the zoo's samplers
    (``GRAPH_ZOO_ARMS``: draws, tunes, final state and every chain's key).
    Bit-identical, every zoo arm replayed and every Gibbs block replayed
    once an iteration, or the phase fails."""
    from mamba_tpu_torch.utils import graphs
    iters, burnin = GRAPH_CHECK_RUN
    res = {}

    model, inputs, inits = rats.build("nuts")

    def rats_run():
        depths, restore = _record_depths(nuts)
        try:
            sim, gibbs = _gibbs_replayed(mt, model, lambda: mt.mcmc(
                model, inputs, inits, iters, burnin=burnin, chains=CHAINS,
                verbose=False, device=DEVICE))
        finally:
            restore()
        return sim, depths, gibbs

    pair = _graph_pair(torch, mt, graphs, rats_run)
    (g_sim, g_d, g_gibbs), g_s = pair["graphed"]
    (p_sim, p_d, p_gibbs), p_s = pair["plain"]
    work = _nuts_work(torch, g_d)
    res["rats_nuts"] = {
        "equal": _same_run(torch, g_sim, p_sim) and len(g_d) == len(p_d)
        and all(torch.equal(a, b) for a, b in zip(g_d, p_d)),
        **work, "graphed_s": g_s, "plain_s": p_s,
        "graphed_ms_per_leapfrog": 1e3 * g_s / work["leapfrog_steps"],
        "plain_ms_per_leapfrog": 1e3 * p_s / work["leapfrog_steps"],
        **{k: g_sim.timing.get(k, 0) for k in ("graphs", "capture_s", "replays")},
        **_gibbs_gate(g_gibbs, p_gibbs, iters)}
    log("graphs: rats NUTS, captured against plain: "
        + json.dumps(res["rats_nuts"]))
    res["glmm_centered"] = _graph_glmm_centered(torch, mt, glmm, fg, nuts,
                                                graphs)

    model, inputs, inits, _ = glmm.build(MESH_G, fused=True)
    # a trajectory of 0.2 from the start (phase 10's grows from one step),
    # so that an iteration replays the leapfrog several times
    model = _chees_block(mt, model, max_steps=256, mass_window=40,
                         traj=GRAPH_CHEES_TRAJ)

    def glmm_run():
        steps, restore = _recording(chees, "_steps", lambda L: L)
        fg.glmm_loglik_grads.launches = 0          # count this path only
        try:
            sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                          chains=CHAINS, verbose=False, device=DEVICE)
        finally:
            restore()
        return sim, steps, fg.glmm_loglik_grads.launches

    pair = _graph_pair(torch, mt, graphs, glmm_run)
    (g_sim, g_steps, g_launch), g_s = pair["graphed"]
    (p_sim, p_steps, p_launch), p_s = pair["plain"]
    need = sum(L + 1 for L in g_steps)     # logfgrad at x, then L steps
    res["glmm_chees"] = {
        "equal": _same_run(torch, g_sim, p_sim) and g_steps == p_steps,
        "steps_per_iteration": g_steps, "gradient_evaluations": need,
        "launches_graphed": g_launch, "launches_plain": p_launch,
        "graphed_s": g_s, "plain_s": p_s,
        **{k: g_sim.timing.get(k, 0) for k in ("graphs", "capture_s", "replays")}}
    log("graphs: GLMM ChEES at full width, captured against plain: "
        + json.dumps(res["glmm_chees"]))
    zoo = _graph_zoo(torch, mt, graphs)
    failed = [k for k, v in {**res, **zoo}.items() if not v["equal"]]
    failed += [f"{k}: no replay" for k, v in zoo.items() if not v["replays"] > 0]
    failed += [f"{k}: Gibbs blocks not replayed"
               for k, v in {**res, **zoo}.items()
               if "gibbs_replayed" in v and not v["gibbs_replayed"]]
    res["zoo"] = zoo
    if not (g_launch >= need and g_launch >= p_launch and g_launch > 0):
        failed.append("GLMM ChEES: fused kernel launches through replays")
    centered = res["glmm_centered"]
    if not centered["launches_graphed"] >= centered["leapfrog_steps"] > 0:
        failed.append("centered GLMM: fused kernel launches through replays")
    if failed:
        raise AssertionError(f"graphs: captured steps against plain loops "
                             f"failed: {failed}: {res}")
    return res


def _graph_glmm_centered(torch, mt, glmm, fg, nuts, graphs):
    """The centered GLMM at full width (``glmm.build(MESH_G, fused=True,
    centered=True)``): NUTS over beta and b through the fused kernel, then
    the conjugate Gibbs draw of s2, ``GRAPH_CHECK_RUN`` at 1024 chains,
    captured and plain from one seed.  Equal bit for bit (draws, tunes,
    final state, keys, every transition's tree depths), the kernel's
    launches counted through the replays, the Gibbs block's replays, both
    walls."""
    iters, burnin = GRAPH_CHECK_RUN
    model, inputs, inits, _ = glmm.build(MESH_G, fused=True, centered=True)

    def run():
        depths, restore = _record_depths(nuts)
        fg.glmm_loglik_grads.launches = 0          # count this path only
        try:
            sim, gibbs = _gibbs_replayed(mt, model, lambda: mt.mcmc(
                model, inputs, inits, iters, burnin=burnin, chains=CHAINS,
                verbose=False, device=DEVICE))
        finally:
            restore()
        return sim, depths, gibbs, fg.glmm_loglik_grads.launches

    pair = _graph_pair(torch, mt, graphs, run)
    (g_sim, g_d, g_gibbs, g_launch), g_s = pair["graphed"]
    (p_sim, p_d, p_gibbs, p_launch), p_s = pair["plain"]
    work = _nuts_work(torch, g_d)
    out = {"equal": _same_run(torch, g_sim, p_sim) and len(g_d) == len(p_d)
           and all(torch.equal(a, b) for a, b in zip(g_d, p_d)),
           **work, "launches_graphed": g_launch, "launches_plain": p_launch,
           "graphed_s": g_s, "plain_s": p_s,
           "graphed_ms_per_iteration": 1e3 * g_s / iters,
           "plain_ms_per_iteration": 1e3 * p_s / iters,
           **{k: g_sim.timing.get(k, 0)
              for k in ("graphs", "capture_s", "replays")},
           **_gibbs_gate(g_gibbs, p_gibbs, iters)}
    log(f"graphs: centered GLMM at full width (NUTS through the fused "
        f"kernel, s2 by Gibbs), captured against plain: " + json.dumps(out))
    return out


def phase_recovery(mt, glmm):
    iters, burnin = RECOVERY_RUN
    model, inputs, inits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                             mass_window=50)
    # z stored too, so that the post phase can rebuild every draw's state
    model = _monitor(model, "z")
    sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=4,
                  verbose=False, device=DEVICE)
    s = mt.summarystats(sim).to_dict()
    est = np.array([s[f"beta[{i + 1}]"]["Mean"] for i in range(4)])
    err = float(np.abs(est - truth["beta"]).max())
    log(f"recovery (G=64, 4 chains, {iters} iters, {burnin} burnin): beta means "
        f"{est.round(4).tolist()} vs truth {truth['beta'].tolist()}, max error "
        f"{err:.4f}; sample_s {sim.timing['sample_s']:.2f}")
    if not err < 0.35:
        raise AssertionError(f"beta not recovered: max error {err}")
    return sim


def _check_glmm_draws(sim, iters, burnin, chains):
    v = sim.value
    if v.shape != (iters - burnin, 5, chains) or not np.isfinite(v).all():
        raise AssertionError(f"kept draws: shape {v.shape}, finite "
                             f"{np.isfinite(v).all()}")
    if not (v[:, sim.names.index("s2"), :] > 0).all():
        raise AssertionError("s2 left its support")


def phase_glmm_nuts(torch, mt, glmm, fg, nuts):
    iters, burnin = GLMM_NUTS_RUN
    model, inputs, inits, _ = glmm.build(G=10_000, n=10, seed=0, fused=True)
    depths, restore = _record_depths(nuts)
    fg.glmm_loglik_grads.launches = 0          # count this path only
    try:
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    launches = fg.glmm_loglik_grads.launches
    res = {**_timing(sim, CHAINS, iters), **_nuts_work(torch, depths),
           "kernel_launches": launches,
           # the run's peak: mcmc resets the peak statistics at its start
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    log(f"GLMM NUTS at full width (G=10000, n=10, P=4, {CHAINS} chains, "
        f"{iters} iters, {burnin} burnin): " + json.dumps(res))
    _check_glmm_draws(sim, iters, burnin, CHAINS)
    if launches < res["leapfrog_steps"] or launches == 0:
        raise AssertionError(f"the fused kernel ran {launches} times for "
                             f"{res['leapfrog_steps']} leapfrog steps")
    return res


def _rats_gates(mt, rats, sim, name):
    """bench.py's gates on a rats run; raises on any failure.  A run cut
    below ``MIN_KEPT`` kept draws cannot reach rank R-hat < 1.01
    (bench.py:41-46), so there R-hat and bulk ESS are printed, not gated."""
    v = sim.value
    converge = v.shape[0] >= MIN_KEPT
    s = mt.summarystats(sim).to_dict()
    rhat = float(np.max(mt.rhat_rank(v)))
    ess = mt.ess_bulk(v)
    ess_s = np.array([s[k]["ESS"] for k in sim.names]) / sim.timing["sample_s"]
    state = sim.states["state"]
    variances = {k: bool((state[k] > 0).all()) for k in ("s2_c", "s2_alpha",
                                                         "s2_beta")}
    out = {"mu_beta_mean": s["mu_beta"]["Mean"],
           "s2_c_mean": s["s2_c"]["Mean"], "alpha0_mean": s["alpha0"]["Mean"],
           "rhat_rank_max": rhat, "ess_bulk_min": float(np.min(ess)),
           "ess_per_s_total": float(ess_s.sum()),
           "ess_per_s_min": float(ess_s.min()),
           "finite": bool(np.isfinite(v).all()),
           "kept_s2_c_positive": bool((v[:, sim.names.index("s2_c"), :] > 0).all()),
           "final_variances_positive": variances,
           "kept_draws": v.shape[0], "convergence_gated": converge}
    log(f"{name} gates: " + json.dumps(out))
    failed = []
    if not abs(out["mu_beta_mean"] - MU_BETA) < MU_BETA_TOL:
        failed.append("golden mu_beta")
    if converge and not rhat < RHAT_MAX:
        failed.append("rank R-hat")
    if converge and not out["ess_bulk_min"] > ESS_MIN:
        failed.append("bulk ESS")
    if not (out["finite"] and out["kept_s2_c_positive"] and all(variances.values())):
        failed.append("finite draws and positive variances")
    if failed:
        raise AssertionError(f"{name}: gates failed: {failed}: {out}")
    return out


def phase_rats_nuts(torch, mt, rats, nuts):
    iters, burnin = RATS_NUTS_RUN
    model, inputs, inits = rats.build("nuts")
    depths, restore = _record_depths(nuts)
    try:
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    res = {**_timing(sim, CHAINS, iters), **_nuts_work(torch, depths)}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    log(f"rats NUTS ({CHAINS} chains, {iters} iters, {burnin} burnin): "
        + json.dumps(res))
    res.update(_rats_gates(mt, rats, sim, "rats NUTS"))
    return res, sim


def _continuation(torch, sim):
    """A function that runs ``n`` more iterations of ``sim`` with one set of
    built kernels (a restart would build them again and capture its graphs
    inside the window), after one iteration that captures them."""
    from mamba_tpu_torch.model.mcmc import _build_kernels, _run
    cm, st = sim.compiled, sim.states
    kernels = _build_kernels(cm)
    carry = [st["key"], st["state"], st["tunes"]]

    def run(n):
        carry[:] = _run(cm, kernels, *carry, 0, n, 1, None)[:3]

    run(1)
    return run


def _busy_share(events, span):
    """The device's busy share inside the host span named ``span`` of a
    Chrome trace (its ``user_annotation``; the trace also draws the span on
    the device's timeline): the union of the kernel, copy and fill
    intervals over the span's length (graph replays' kernels included)."""
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == span and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"span_ms": 1e-3 * (hi - lo), "device_busy_ms": 1e-3 * busy,
            "device_events": len(spans), "device_busy_share": busy / (hi - lo)}


def _advi_warm_inits(torch, mt, model, inputs, init, steps, chains):
    """bench.py's ADVI warm start: fit, then one draw from q per chain."""
    t0 = time.perf_counter()
    res = mt.advi(model, inputs, init, steps=steps, nmc=4, seed=1, device=DEVICE)
    from mamba_tpu_torch.ops import random as R
    draws = {k: v.cpu().numpy()
             for k, v in res.sample(R.key(5, DEVICE), chains).items()}
    advi_s = time.perf_counter() - t0
    inits = [dict(init, **{k: d[i] for k, d in draws.items()})
             for i in range(chains)]
    trace = res.elbo_trace
    log(f"ADVI ({steps} steps, nmc 4): {advi_s:.2f} s, ELBO first/last "
        f"{trace[0]:.2f} / {trace[-1]:.2f}")
    if not np.isfinite(trace[-1]):
        raise AssertionError("ADVI ELBO is not finite")
    return inits, advi_s


def _chees_block(mt, model, **kw):
    """The model's gradient block (its first) as ChEES-HMC, as bench.py
    sets it; later blocks stay."""
    model.set_samplers([mt.ChEESHMC(model.samplers[0].params, **kw),
                        *model.samplers[1:]])
    return model


def phase_rats_chees(torch, mt, rats, chees):
    iters, burnin = RATS_CHEES_RUN
    model, inputs, inits = rats.build("nuts")
    model = _chees_block(mt, model, mass_window=50)
    warm, advi_s = _advi_warm_inits(torch, mt, model, inputs, inits[0],
                                    RATS_CHEES_ADVI_STEPS, CHAINS)
    steps, restore = _recording(chees, "_steps", lambda L: L)
    try:
        sim = mt.mcmc(model, inputs, warm, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    res = {**_timing(sim, CHAINS, iters), "advi_s": advi_s,
           "leapfrog_steps": sum(steps), "mean_L": float(np.mean(steps)),
           "max_L": max(steps)}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    log(f"rats ChEES ({CHAINS} chains, {iters} iters, {burnin} burnin): "
        + json.dumps(res))
    res.update(_rats_gates(mt, rats, sim, "rats ChEES"))
    return res, sim


def zoo_run(torch, mt, name, scheme, iters, burnin, gates):
    """One zoo model at 1024 chains under its golden gates; raises on any
    failure."""
    import importlib
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    model, inputs, inits = mod.build() if scheme is None else mod.build(scheme)
    sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=CHAINS,
                  verbose=False, device=DEVICE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30    # since mcmc's start
    v = sim.value
    s = mt.summarystats(sim).to_dict()
    kept = iters - burnin
    converge = kept >= MIN_KEPT
    res = {"model": name, "blocks": [repr(b) for b in model.samplers],
           "iterations": iters, "burnin": burnin, **_timing(sim, CHAINS, iters),
           "wall_ms_per_iteration": 1e3 * sim.timing["sample_s"] / iters,
           "peak_allocated_gib": peak,
           "means": {k: s[k]["Mean"] for k in gates},
           "golden": {k: g[0] for k, g in gates.items()},
           "rhat_rank_max": float(np.max(mt.rhat_rank(v))),
           "convergence_gated": converge,
           "finite": bool(np.isfinite(v).all())}
    # posterior-predictive draws of the data nodes on the card (Poisson,
    # Binomial, truncated Weibull), from keys of the script's own: finite
    # and inside their support (outside it the density is -inf)
    from mamba_tpu_torch.ops import random as R
    cm = sim.compiled
    state = sim.states["state"]
    gen = R.chain_keys(11, range(next(iter(state.values())).shape[0]), DEVICE)
    sampled = {p for b in model.samplers if not isinstance(b, mt.MISS)
               for p in b.params}
    data = tuple(n for n in cm.stochastic if n not in sampled)
    drawn = cm.forward_sample(gen, state, names=data)
    res["predictive_nodes"] = list(data)
    res["forward_sample_ok"] = bool(data) and all(
        tuple(drawn[n].shape) == tuple(state[n].shape)
        and bool(torch.isfinite(drawn[n]).all()) for n in data
    ) and bool(torch.isfinite(torch.func.vmap(
        lambda st: cm.logpdf(st, data))(drawn)).all())
    log(f"zoo {name}: " + json.dumps(res))
    failed = [k for k, (mean, tol) in gates.items()
              if not abs(res["means"][k] - mean) < tol]
    if v.shape != (kept, len(sim.names), CHAINS) or not res["finite"]:
        failed.append("finite draws of the expected shape")
    if converge and not res["rhat_rank_max"] < RHAT_MAX:
        failed.append("rank R-hat")
    if not res["forward_sample_ok"]:
        failed.append("forward_sample")
    if failed:
        raise AssertionError(f"zoo {name}: gates failed: {failed}: {res}")
    return res, sim


def phase_zoo(torch, mt):
    """The zoo's runs; returns their results and the chains of the runs the
    post phase reuses (``POST_ZOO``)."""
    # no draw may come from the global generators: their states must not move
    before = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    out, sims = [], {}
    for run in ZOO_RUNS:
        res, sim = zoo_run(torch, mt, *run)
        out.append(res)
        if run[0] in POST_ZOO:
            sims[run[0]] = sim
    after = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("zoo: a draw came from a global generator")
    return out, sims


def _predictive(torch, mt, cm, model, state):
    """Posterior-predictive draws of the data nodes through
    ``forward_sample``, from keys of the script's own: the names, and
    whether every draw has its node's shape, is finite and (where the node
    has a density) inside its support."""
    from mamba_tpu_torch.ops import random as R
    gen = R.chain_keys(11, range(next(iter(state.values())).shape[0]), DEVICE)
    sampled = {p for b in model.samplers if not isinstance(b, mt.MISS)
               for p in b.params}
    data = tuple(n for n in cm.stochastic if n not in sampled)
    drawn = cm.forward_sample(gen, state, names=data)
    ok = bool(data) and all(
        tuple(drawn[n].shape) == tuple(state[n].shape)
        and bool(torch.isfinite(drawn[n]).all()) for n in data)
    try:
        lp = torch.func.vmap(lambda st: cm.logpdf(st, data))(drawn)
        ok = ok and bool(torch.isfinite(lp).all())
    except NotImplementedError:     # gk's data node has no density
        pass
    return list(data), ok


def _in_support(torch, name, sim):
    """The support checks of the zoo_mv table: kept simplex rows inside the
    simplex, final covariance matrices positive definite, binary draws in
    {0, 1}; every draw finite."""
    v, names = sim.value, sim.names
    state = sim.states["state"]
    ok = bool(np.isfinite(v).all())
    if name == "eyes":
        P = v[:, [names.index("P[1]"), names.index("P[2]")], :]
        ok = ok and bool(((P > 0) & (P < 1)).all())
        ok = ok and bool((torch.abs(state["P"].sum(-1) - 1) < 1e-5).all())
    if name == "asthma":
        q = state["q"]
        ok = ok and bool(((q > 0) & (q < 1)).all()
                         and (torch.abs(q.sum(-1) - 1) < 1e-5).all())
    if name in ("jaws", "birats"):
        ok = ok and bool((torch.linalg.eigvalsh(state["Sigma"].double()) > 0).all())
    if name == "pollution":
        ok = ok and set(np.unique(v).tolist()) <= {0.0, 1.0}
    return ok


def zoo_mv_run(torch, mt, binary, name, scheme, iters, burnin, gates):
    """One model of the multivariate half of the zoo at 1024 chains under
    its gates; raises on any failure."""
    import importlib
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    model, inputs, inits = mod.build() if scheme is None else mod.build(scheme)
    hits, restore = _recording(binary, "bhmc_step",
                               lambda out: out[1].wallhits.detach().cpu())
    try:
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30    # since mcmc's start
    v = sim.value
    means = v.mean(axis=(0, 2))
    golden = getattr(mod, "GOLDEN", {})
    label = name if scheme is None else f"{name}:{scheme}"
    res = {"model": label, "blocks": [repr(b) for b in model.samplers],
           "iterations": iters, "burnin": burnin, **_timing(sim, CHAINS, iters),
           "wall_ms_per_iteration": 1e3 * sim.timing["sample_s"] / iters,
           "peak_allocated_gib": peak,
           "means": {k: float(means[sim.names.index(k)]) for k in golden
                     if k in sim.names},
           "golden": {k: g["Mean"] for k, g in golden.items()},
           "in_support": _in_support(torch, name, sim)}
    if gates:
        s = mt.summarystats(sim).to_dict()
        res["gated_means"] = {k: s[k]["Mean"] for k in gates}
    if hits:                                   # BHMC: hits per trajectory
        per = torch.diff(torch.stack([torch.zeros_like(hits[0])] + hits), dim=0)
        res["bhmc_wall_hits_per_trajectory"] = {
            "mean": float(per.float().mean()), "max": int(per.max()),
            "max_hits": binary.MAX_HITS}
    if name == "pollution" and scheme == "dgs":
        res["alphabeta_float32_error_sd"] = _alphabeta_float32_error(
            torch, sim.compiled, sim.states["state"])
    if any(isinstance(b, mt.DGS) for b in model.samplers):
        res["dgs_sweep"] = _dgs_graph_check(torch, mt, sim.compiled, model,
                                            sim.states["state"])
    res["predictive_nodes"], res["forward_sample_ok"] = _predictive(
        torch, mt, sim.compiled, model, sim.states["state"])
    log(f"zoo_mv {label}: " + json.dumps(res))
    failed = [k for k, (mean, tol) in gates.items()
              if not abs(res["gated_means"][k] - mean) < tol]
    if v.shape != (iters - burnin, len(sim.names), CHAINS) or not res["in_support"]:
        failed.append("finite draws of the expected shape inside the support")
    if name == "pollution" and scheme == "dgs":
        g = res["means"]
        if not (g["gamma[9]"] > 0.8 and g["gamma[2]"] < 0.6):
            failed.append("gamma[9] > 0.8 and gamma[2] < 0.6")
    if "dgs_sweep" in res and not res["dgs_sweep"]["graph_equals_eager"]:
        failed.append("the DGS sweep replayed from its CUDA graph")
    if hits and not res["bhmc_wall_hits_per_trajectory"]["max"] < binary.MAX_HITS:
        failed.append("a BHMC trajectory reached max_hits")
    if not res["forward_sample_ok"]:
        failed.append("forward_sample")
    if failed:
        raise AssertionError(f"zoo_mv {label}: gates failed: {failed}: {res}")
    return res, sim


def _dgs_graph_check(torch, mt, cm, model, state, reps=5):
    """The model's DGS block at the run's final state, replayed from its
    CUDA graph by the engine's kernel and run eagerly by the stand-alone
    ``dgs_step`` from the same keys: whether the draws are equal, and the
    wall ms per sweep of each."""
    from mamba_tpu_torch.samplers import dgs
    from mamba_tpu_torch.samplers.base import candidate_logf
    (name,) = next(b for b in model.samplers if isinstance(b, mt.DGS)).params
    from mamba_tpu_torch.ops import random as R
    kern = mt.DGS(name).build(cm)
    tune = kern.init(None, state)
    chains = next(iter(state.values())).shape[0]
    pack, _, _, logf = cm.block_functions((name,), False)
    x = torch.func.vmap(pack)(state)
    f = candidate_logf(torch.func.vmap(logf), state)
    # the engine's block splits one key off per node: the stand-alone step
    # takes that key
    runs = {"graph": lambda gen: kern.step(gen, state, tune, False)[0][name],
            "eager": lambda gen: dgs.dgs_step(R.split(gen, 1)[0], x, tune[0],
                                              f)[0]}
    out, ms = {}, {}
    for which, run in runs.items():
        gen = R.chain_keys(3, range(chains), DEVICE)
        out[which] = run(gen).reshape(x.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run(gen)
        torch.cuda.synchronize()
        ms[which] = 1e3 * (time.perf_counter() - t0) / reps
    return {"graph_equals_eager": bool(torch.equal(out["graph"], out["eager"])),
            "graph_ms": ms["graph"], "eager_ms": ms["eager"]}


def _alphabeta_float32_error(torch, cm, state):
    """pollution's conjugate (alpha, beta) mean solved in float32 against the
    float64 solve the model uses, at the run's final state: the largest
    error over chains and coordinates, in posterior standard deviations."""
    from mamba_tpu_torch.models import pollution
    env = {**cm.inputs, **torch.func.vmap(cm.eval_logicals)(state)}
    mu64, L64 = pollution.alphabeta_moments(env, torch.float64)
    mu32, _ = pollution.alphabeta_moments(env, torch.float32)
    eye = torch.eye(L64.shape[-1], dtype=torch.float64, device=L64.device)
    sd = torch.sqrt(torch.diagonal(torch.cholesky_solve(eye.expand_as(L64), L64),
                                   dim1=-2, dim2=-1))
    return float(torch.nan_to_num((mu32.double() - mu64).abs() / sd,
                                  nan=float("inf")).max())


def phase_zoo_mv(torch, mt):
    from mamba_tpu_torch.samplers import binary
    before = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    out, sims = [], {}
    for run in ZOO_MV_RUNS:
        res, sim = zoo_mv_run(torch, mt, binary, *run)
        out.append(res)
        if run[0] in POST_ZOO and run[1] is None:
            sims[run[0]] = sim
    after = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("zoo_mv: a draw came from a global generator")
    return out, sims


def _glmm_chees_run(torch, mt, glmm, fg, chees, warm, label,
                    run=MESH_CHEES_RUN, build=None, **mesh_kw):
    """The GLMM at full width under ChEES-HMC from the ADVI draws ``warm``
    for ``run``'s iterations and burnin, on ``mesh_kw``'s mesh if given
    (``build() -> (model, inputs)``: another form of it, (m)'s).
    Gated on finite draws of the run's shape and on kernel launches >=
    gradient evaluations; returns its numbers, the run and (epsilon, traj)
    after every iteration."""
    iters, burnin = run
    model, inputs = (build() if build else glmm.build(MESH_G, fused=True)[:2])
    model = _chees_block(mt, model, max_steps=256, mass_window=40)
    steps, restore_steps = _recording(chees, "_steps", lambda L: L)
    tunes, restore_tunes = _recording(
        chees, "chees_step",
        lambda out: [float(out[1].epsilon), float(out[1].traj)])
    fg.glmm_loglik_grads.launches = 0          # count this path only
    try:
        sim = mt.mcmc(model, inputs, warm, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE, **mesh_kw)
    finally:
        restore_steps()
        restore_tunes()
    launches = fg.glmm_loglik_grads.launches
    need = sum(L + 1 for L in steps)           # logfgrad at x, then L steps
    res = {**_timing(sim, CHAINS, iters),
           "steps_per_iteration": steps, "leapfrog_steps": sum(steps),
           "kernel_launches": launches,
           "peak_rise_bytes": sim.timing["peak_rise_bytes"]}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    res["wall_ms_per_gradient"] = 1e3 * res["sample_s"] / need
    log(f"{label} (G={MESH_G}, {CHAINS} chains, {iters} iters, {burnin} "
        f"burnin): " + json.dumps(res))
    _check_glmm_draws(sim, iters, burnin, CHAINS)
    if launches < need or launches == 0:
        raise AssertionError(f"{label}: the fused kernel ran {launches} times "
                             f"for {need} gradient evaluations")
    return res, sim, tunes


def _glmm_warm_inits(torch, mt, glmm):
    """bench.py's warm start of the GLMM: ADVI on the generic build (the
    same posterior and sites), one draw per chain, y from the fused build."""
    _, _, inits, _ = glmm.build(MESH_G, fused=True)
    model_g, inputs_g, inits_g, _ = glmm.build(MESH_G, fused=False)
    warm, advi_s = _advi_warm_inits(torch, mt, model_g, inputs_g, inits_g[0],
                                    1000, CHAINS)
    return [dict(inits[0], **{k: w[k] for k in ("beta", "z", "s2")})
            for w in warm], advi_s


def phase_glmm_chees(torch, mt, glmm, fg, chees):
    """bench.py's GLMM arm at its depth (``GLMM_CHEES_RUN``) from its ADVI
    warm start, under its four gates."""
    warm, advi_s = _glmm_warm_inits(torch, mt, glmm)
    res, sim, tunes = _glmm_chees_run(torch, mt, glmm, fg, chees, warm,
                                      "GLMM ChEES at full width",
                                      run=GLMM_CHEES_RUN)
    truth = glmm.build(MESH_G, fused=True)[3]
    s = mt.summarystats(sim).to_dict()
    beta = np.array([s[f"beta[{i + 1}]"]["Mean"] for i in range(4)])
    gates = {"beta_err_max": float(np.abs(beta - truth["beta"]).max()),
             "s2_err": abs(s["s2"]["Mean"] - float(truth["s2"])),
             "rhat_rank_max": float(np.max(mt.rhat_rank(sim.value))),
             "ess_bulk_min": float(np.min(mt.ess_bulk(sim.value))),
             "mean_L": float(np.mean(res["steps_per_iteration"])),
             "max_L": max(res["steps_per_iteration"])}
    log("GLMM ChEES gates: " + json.dumps(gates))
    failed = [k for k, ok in (
        ("beta", gates["beta_err_max"] < GLMM_BETA_TOL),
        ("s2", gates["s2_err"] < GLMM_S2_TOL),
        ("rank R-hat", gates["rhat_rank_max"] < RHAT_MAX),
        ("bulk ESS", gates["ess_bulk_min"] > ESS_MIN)) if not ok]
    if failed:
        raise AssertionError(f"GLMM ChEES: gates failed: {failed}: {gates}")
    res = {k: v for k, v in res.items() if k != "steps_per_iteration"}
    return {**res, **gates, "advi_s": advi_s}, warm, tunes


def _split_density_check(torch, mt, glmm, fg, mesh, warm):
    """(d): the GLMM's (beta, z, s2) block density and gradient at every
    warm start, from the kernel over this rank's range of groups summed
    over the data group, against one launch over all groups."""
    from mamba_tpu_torch.parallel.mesh import MeshComm
    from mamba_tpu_torch.model.mcmc import _chain_inits
    model, inputs, inits, _ = glmm.build(MESH_G, fused=True)
    whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
    split = mt.compile_model(model, inputs, inits[0], device=DEVICE,
                             comm=MeshComm(mesh), site_specs={"y": (None, "data")})
    state = _chain_inits(whole, warm, CHAINS)
    res = _split_against_whole(torch, fg, whole, split, state)
    res["groups"] = [split._local_plans["y"][1], split._local_plans["y"][2]]
    if not (res["lp_rel_err"] <= LP_RTOL and res["grad_rel_err"] <= GRAD_RTOL
            and res["launches_split"] == 1 and res["launches_whole"] == 1):
        raise AssertionError(f"(d) the group split disagrees: {res}")
    return res


def _split_against_whole(torch, fg, whole, split, state):
    """The (beta, z, s2) block density and gradient of ``split`` (a data
    rank's compiled GLMM) from the rank's local view of the whole state
    ``state``, completed over the data group (``block_sum``), against
    ``whole``'s: their errors and each one's kernel launches.  Where the
    rank holds z as its slice (``_held``) its gradient has the rank's
    coordinates (``block_coords``): the slice coordinates are held against
    the whole gradient's slice, the whole coordinates against the whole."""
    params = ("beta", "z", "s2")
    out = {}
    for name, cm in (("whole", whole), ("split", split)):
        local = cm.cut_state(state)
        _, _, _, logf = cm.block_functions(params, True)
        x = cm.block_maps(params, True)[0](local)
        fg.glmm_loglik_grads.launches = 0
        g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, local)
        launches = fg.glmm_loglik_grads.launches
        v, g = cm.block_sum(params)(v, g)
        out[name] = (v.double(), g.double(), launches)
    (v, g, n_split), (vw, gw, n_whole) = out["split"], out["whole"]
    coords = split.block_coords(params)
    if coords.index is not None:
        gw = gw[:, coords.index]
    return {"lp_rel_err": float(((v - vw).abs() / vw.abs()).max()),
            "grad_rel_err": float((g - gw).abs().max() / gw.abs().max()),
            "launches_split": n_split, "launches_whole": n_whole,
            "held": sorted(split._held), "part_sites": sorted(split._part_sites),
            "grad_shape": list(g.shape)}


#: (e)'s layout: y, the covariates and the random effects' z split by
#: groups (a spec indexes the site's own dims: y (n, G), xt (P, n, G), z (G,))
LOCAL_SPECS = {"y": (None, "data"), "xt": (None, None, "data"), "z": ("data",)}
#: the generic GLMM's sites for the same split: y (G, n), x (G, n, P), z (G,)
LOCAL_SPECS_GENERIC = {"y": ("data", None), "x": ("data", None, None),
                       "z": ("data",)}
#: (e) gates: a rank's peak memory rise at least this many bytes below the
#: same steps without a mesh (most of the half of y a rank does not hold)
LOCAL_MEM_SAVED_MIN = 180e6
#: a data rank's peak memory rise in (e) when z was whole in the state (an
#: H100 80GB HBM3 at 700 W, PERF.md §6): printed beside this run's
LOCAL_RISE_Z_WHOLE = 748.0e6
#: all-reduces timed for (e)'s figure of the block's completion of a call
DATA_SUM_REPS = 5


def _local_views(torch, mt, glmm, fg, chees, warm, mesh, rank, outdir):
    """(e): the GLMM at full width on a (1, 2) data mesh with local views
    (``LOCAL_SPECS``): each rank holds its half of y's and the covariates'
    groups.  (b)'s run on the mesh, then (rank 0) the same steps
    without one, captured as the mesh run's are, each's peak memory
    rise; the block density and gradient at the warm starts against
    the whole, with the kernel's launches and groups per call; the gloo
    all-reduce of a density's value and gradient, timed."""
    from mamba_tpu_torch.model.mcmc import _chain_inits
    from mamba_tpu_torch.parallel.mesh import MeshComm
    res, sim, tunes = _glmm_chees_run(
        torch, mt, glmm, fg, chees, warm,
        f"(e) rank {rank}, local views on a (1, 2) data mesh", mesh=mesh,
        site_specs=LOCAL_SPECS)
    state = sim.states["state"]
    res["shapes"] = {k: list(state[k].shape) for k in ("y", "z", "beta", "s2")}
    res["shapes"]["xt"] = list(sim.compiled.inputs["xt"].shape)
    res["minv_shape"] = list(sim.states["tunes"][0].minv.shape)
    res["tunes"] = tunes
    np.save(Path(outdir) / f"local_draws{rank}.npy", sim.value)
    res["write_s"] = _write_sharded(torch, mt, sim, outdir, "local", rank)
    del sim, state
    if rank == 0:
        whole, _, _ = _glmm_chees_run(
            torch, mt, glmm, fg, chees, warm,
            "(e) the same steps without a mesh (captured)")
        res["whole_peak_rise_bytes"] = whole["peak_rise_bytes"]
    model, inputs, inits, _ = glmm.build(MESH_G, fused=True)
    whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
    split = mt.compile_model(model, inputs, inits[0], device=DEVICE,
                             comm=MeshComm(mesh), site_specs=LOCAL_SPECS)
    res["density"] = _split_against_whole(
        torch, fg, whole, split, _chain_inits(whole, warm, CHAINS))
    # the split's launch runs over the arrays the rank holds
    res["density"]["groups_split"] = split.inputs["xt"].shape[-1]
    # the block's completion of one density call: one all-reduce of the
    # value and the whole coordinates' gradient, staged through the host
    # under gloo (the slice coordinates' gradient stays the rank's own)
    params = ("beta", "z", "s2")
    total, coords = split.block_sum(params), split.block_coords(params)
    v = torch.zeros(CHAINS, device=DEVICE)
    g = torch.zeros(CHAINS, len(coords.index), device=DEVICE)
    shapes = []
    inner = MeshComm.data_sum

    def counted(comm, *tensors):
        shapes.append([list(t.shape) for t in tensors])
        return inner(comm, *tensors)
    MeshComm.data_sum = counted
    try:
        total(v, g)
    finally:
        MeshComm.data_sum = inner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DATA_SUM_REPS):
        total(v, g)
    torch.cuda.synchronize()
    res["data_sum_ms"] = 1e3 * (time.perf_counter() - t0) / DATA_SUM_REPS
    (res["data_sum_shape"],) = shapes[0]
    res["rank_dim"], res["whole_dim"] = len(coords.index), coords.dim
    return res


def _write_sharded(torch, mt, sim, outdir, label, rank):
    """(f): the run's one chain file (``write_chains`` on every rank), and
    the rank's own resume state beside it for the one-device restart
    built in memory: its sampled sites, tunes and chain keys.  The seconds
    ``write_chains`` took."""
    t0 = time.perf_counter()
    mt.write_chains(str(Path(outdir) / f"{label}.pkl"), sim)
    seconds = time.perf_counter() - t0
    st = sim.states
    coords = sim.compiled.block_coords(("beta", "z", "s2"))
    torch.save({"state": {k: st["state"][k] for k in ("beta", "z", "s2")},
                "tunes": st["tunes"], "key": st["key"], "burnin": st["burnin"],
                "index": coords.index, "dim": coords.dim},
               Path(outdir) / f"{label}_rank{rank}.pt")
    return seconds


def _joined_tunes(torch, own):
    """The ChEES tunes of (e)'s two data ranks as one device holds them:
    each per-coordinate leaf (``COORD_LEAVES``) put back into the unsharded
    flat order from each rank's coordinates (``index``), every other leaf
    rank 0's."""
    tune = own[0]["tunes"][0]
    joined = {}
    for f in type(tune).COORD_LEAVES:
        leaf = getattr(tune, f)
        out = leaf.new_zeros(leaf.shape[:-1] + (own[0]["dim"],))
        for o in own:
            out.index_copy_(-1, o["index"].to(leaf.device),
                            getattr(o["tunes"][0], f))
        joined[f] = out
    return (tune._replace(**joined),) + tuple(own[0]["tunes"][1:])


#: (g)(i)'s layout: LOCAL_SPECS with z's prior mean w (G,) named too
W_SPECS = {**LOCAL_SPECS, "w": ("data",)}
#: (g): the GLMM run with w, and the birats and line runs (iterations, burnin)
GW_RUN, RESOLVED_RUN = (6, 3), (4, 2)
#: (g)(ii)'s and (g)(iii)'s layouts
BIRATS_SPECS = {"Y": ("data", None), "beta": ("data", None)}
LINE6_SPECS = {"y": ("data",), "xmat": ("data", None)}


def _glmm_w(mt, glmm):
    """(g)(i): the GLMM of (e) with z's prior mean read from a per-group
    input w, which W_SPECS names on the data axis: z ~ Normal(w, 1)."""
    model, inputs, inits, _ = glmm.build(MESH_G, fused=True)
    w = 0.1 * np.random.default_rng(5).normal(size=MESH_G)
    model = mt.Model(**{**model.nodes, "z": mt.Stochastic(
        1, lambda w: mt.Normal(w, 1.0), monitor=False)})
    model.set_samplers([mt.ChEESHMC(("beta", "z", "s2"), max_steps=256,
                                    mass_window=40)])
    return model, dict(inputs, w=w), inits


def _line6(mt, torch):
    """(g)(iii): line on six points with mean(y) (a constant) and
    ss = sum((y - mu)**2) (computed from the state and slices) monitored."""
    from mamba_tpu_torch.models import line
    model, inputs, inits = line.build()
    model = mt.Model(**{**model.nodes,
                        "ybar": mt.Logical(lambda y: torch.mean(y)),
                        "ss": mt.Logical(lambda y, mu: torch.sum((y - mu) ** 2))})
    model.set_samplers([mt.NUTS("beta"), mt.Slice("s2", 3.0)])
    y = np.array([1.0, 3.0, 3.0, 3.0, 5.0, 6.0])
    inputs = {"xmat": np.stack([np.ones(6), np.arange(1.0, 7.0)], 1)}
    return model, inputs, [dict(i, y=y) for i in inits]


def _at_inits(torch, mt, mesh, model, inputs, inits, specs):
    """The unsharded model's log density and monitored rows at the inits,
    against this rank's parts summed over the data group and its rows
    gathered: their relative errors."""
    from mamba_tpu_torch.model.mcmc import _chain_inits
    from mamba_tpu_torch.parallel.mesh import MeshComm
    whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
    split = mt.compile_model(model, inputs, inits[0], device=DEVICE,
                             comm=MeshComm(mesh), site_specs=specs)
    state = _chain_inits(whole, inits, CHAINS)
    lp = torch.func.vmap(whole.logpdf)(state).double()
    (part,) = split.comm.data_sum(torch.func.vmap(split.logpdf_part)(
        split.cut_state(state)))
    rows = whole.monitor_rows()(state).T[None].double()
    got = split.gather_monitored(
        split.monitor_rows()(split.cut_state(state)).T[None]).double()
    return {"lp_rel_err": float(((part.double() - lp).abs() / lp.abs()).max()),
            "rows_rel_err": float((got - rows).abs().max()
                                  / rows.abs().max().clamp_min(1.0)),
            "mixed": sorted(split.mixed)}


def _resolved_cases(torch, mt, glmm, fg, warm, mesh, rank, outdir):
    """(g): data-axis cases the compiler resolves, on a (1, 2) data mesh
    in this rank: (i) the GLMM with w (``_glmm_w``) at full width, its density and
    gradient at the warm starts against the whole (one launch over the
    rank's groups), a short run and its peak memory rise; (ii) birats with
    Y and beta named, (iii) line with mean(y) and ss monitored, each at the
    inits against the unsharded model and a short run.  Each run's draws
    are saved for the parent's check that both ranks agree."""
    from mamba_tpu_torch.model.mcmc import _chain_inits
    from mamba_tpu_torch.models import birats
    from mamba_tpu_torch.parallel.mesh import MeshComm
    res = {}
    model, inputs, inits = _glmm_w(mt, glmm)
    whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
    split = mt.compile_model(model, inputs, inits[0], device=DEVICE,
                             comm=MeshComm(mesh), site_specs=W_SPECS)
    d = _split_against_whole(torch, fg, whole, split,
                             _chain_inits(whole, warm, CHAINS))
    d["groups_split"] = split.inputs["xt"].shape[-1]
    del whole, split
    iters, burnin = GW_RUN
    fg.glmm_loglik_grads.launches = 0
    sim = mt.mcmc(model, inputs, warm, iters, burnin=burnin, chains=CHAINS,
                  verbose=False, device=DEVICE, mesh=mesh, site_specs=W_SPECS)
    res["glmm_w"] = {"density": d, "kernel_launches": fg.glmm_loglik_grads.launches,
                     "sample_s": sim.timing["sample_s"],
                     "peak_rise_bytes": sim.timing["peak_rise_bytes"],
                     "z_shape": list(sim.states["state"]["z"].shape)}
    np.save(Path(outdir) / f"glmm_w_draws{rank}.npy", sim.value)
    del sim
    for name, (model, inputs, inits), specs in (
            ("birats", birats.build(), BIRATS_SPECS),
            ("line_ss", _line6(mt, torch), LINE6_SPECS)):
        out = _at_inits(torch, mt, mesh, model, inputs, inits, specs)
        iters, burnin = RESOLVED_RUN if name == "birats" else (20, 10)
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE, mesh=mesh,
                      site_specs=specs)
        out["sample_s"] = sim.timing["sample_s"]
        np.save(Path(outdir) / f"{name}_draws{rank}.npy", sim.value)
        res[name] = out
    return res


#: (j)'s layouts: the GLMM with only its data named (y and the
#: covariates), so z and b stay whole, as GSPMD replicates them
DATA_SPECS = {"y": (None, "data"), "xt": (None, None, "data")}
DATA_SPECS_GENERIC = {"y": ("data", None), "x": ("data", None, None)}
#: (j)'s small fixtures' runs (iterations, burnin; birats' is RESOLVED_RUN)
#: and their chains: a split block's leapfrog is cut at its all-reduce, a
#: per-call gather adds an all-gather to each leapfrog, and the deepest of
#: 1024 chains' NUTS trees sets an iteration's leapfrogs, so the runs are
#: cut
FIXTURE_RUN, FIXTURE_CHAINS = (10, 5), 64
#: the whole coordinates of the GLMM's (beta, z, s2) block: z's, beta's, s2's
GLMM_WHOLE_DIM = MESH_G + 5


def _data_only(torch, mt, glmm, fg, chees, warm, mesh, rank, outdir):
    """(j): the GLMM at full width with only its data named
    (``DATA_SPECS``, ``DATA_SPECS_GENERIC``): y reads the rank's slice of
    the whole b.  Both forms' (beta, z, s2) block density and gradient at
    the warm starts against the whole; the fused form under ChEES on the
    mesh (``MESH_CHEES_RUN``), its wall per gradient and one call's
    all-reduce of the value and the whole gradient, timed; then the small
    fixtures (``_fixtures``)."""
    from mamba_tpu_torch.model.mcmc import _chain_inits
    from mamba_tpu_torch.parallel.mesh import MeshComm
    res = {}
    for fused, specs in ((True, DATA_SPECS), (False, DATA_SPECS_GENERIC)):
        model, inputs, inits, _ = glmm.build(MESH_G, fused=fused)
        starts = [dict(w, y=inits[0]["y"]) for w in warm]
        whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
        split = mt.compile_model(model, inputs, inits[0], device=DEVICE,
                                 comm=MeshComm(mesh), site_specs=specs)
        d = _split_against_whole(torch, fg, whole, split,
                                 _chain_inits(whole, starts, CHAINS))
        d["cuts"] = split._cuts
        d["groups_split"] = (split.inputs["xt"].shape[-1] if fused
                             else split.inputs["x"].shape[0])
        res["fused" if fused else "generic"] = d
        del whole, split
    run, sim, tunes = _glmm_chees_run(
        torch, mt, glmm, fg, chees, warm,
        f"(j) rank {rank}, the GLMM with only its data named", mesh=mesh,
        site_specs=DATA_SPECS)
    np.save(Path(outdir) / f"data_only_draws{rank}.npy", sim.value)
    run["tunes"] = tunes
    run["z_shape"] = list(sim.states["state"]["z"].shape)
    params = ("beta", "z", "s2")
    run["data_sum_shape"], run["data_sum_ms"] = _data_sum_timed(
        torch, sim.compiled, params, GLMM_WHOLE_DIM)
    res["chees"] = run
    del sim
    res["fixtures"] = _fixtures(torch, mt, mesh, rank, outdir)
    return res


def _data_sum_timed(torch, cm, params, dim):
    """The shapes of the tensors of the one all-reduce that completes a
    density call of the block on ``cm`` (the value and the gradient of
    ``dim`` coordinates), and its ms, staged through the host under gloo."""
    from mamba_tpu_torch.parallel.mesh import MeshComm
    v = torch.zeros(CHAINS, device=DEVICE)
    g = torch.zeros(CHAINS, dim, device=DEVICE)
    shapes = []
    inner = MeshComm.data_sum

    def counted(comm, *tensors):
        shapes.append([list(t.shape) for t in tensors])
        return inner(comm, *tensors)
    MeshComm.data_sum = counted
    try:
        cm.block_sum(params)(v, g)
    finally:
        MeshComm.data_sum = inner
    total = cm.block_sum(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DATA_SUM_REPS):
        total(v, g)
    torch.cuda.synchronize()
    return shapes[0], 1e3 * (time.perf_counter() - t0) / DATA_SUM_REPS


def _fixture_models(mt, torch):
    """(j)'s small fixtures: name -> ((model, inputs, inits), site_specs,
    the gradient block held to the whole, the run).  Line with a prior on
    ss = sum((y - mu)**2) (gathered per density call of beta's block),
    with a prior on mean(y) under MISS (gathered once per step of tau's),
    on its own five points padded to six (mean(y) a constant from the
    five, a monitored ss computed whole from them), the rows of v ~
    MvNormal(stack([w, w]), I) with w and v named, and birats with one
    law recycled over its rows."""
    from mamba_tpu_torch.models import birats, line
    six = np.array([1.0, 3.0, 3.0, 3.0, 5.0, 6.0])

    def line_with(extra, sampled, y=six, miss=False):
        model, inputs, inits = line.build()
        model = mt.Model(**{**model.nodes, **extra})
        model.set_samplers([mt.NUTS("beta"), mt.Slice("s2", 3.0)]
                           + [mt.Slice(n, 1.0) for n in sampled]
                           + ([mt.MISS("y")] if miss else []))
        if y is not None:
            inputs = {"xmat": np.stack([np.ones(6), np.arange(1.0, 7.0)], 1),
                      "w": np.linspace(-0.6, 0.9, 6)}
        return model, inputs, [dict(i, tau=0.5, v=np.linspace(
            -1.0, 1.2, 12).reshape(6, 2), **({} if y is None else {"y": y}))
            for i in inits]

    def ss(monitor=False):
        return mt.Logical(lambda y, mu: torch.sum((y - mu) ** 2),
                          monitor=monitor)

    def ybar():
        return mt.Logical(lambda y: torch.mean(y), monitor=False)

    model, inputs, inits = birats.build()
    nodes = dict(model.nodes, beta=mt.Stochastic(
        2, lambda mu_beta, Sigma: mt.MvNormal(mu_beta, Sigma), monitor=False))
    recycled = mt.Model(**nodes)
    recycled.set_samplers(model.samplers)
    line_block = ("beta", "s2", "tau")
    return {
        "line_ss_tau": (line_with(
            {"ss": ss(), "tau": mt.Stochastic(
                lambda ss: mt.Normal(0.1 * ss, 1.0))}, ["tau"]),
            LINE6_SPECS, line_block, FIXTURE_RUN),
        "line_miss_ybar": (line_with(
            {"ybar": ybar(), "tau": mt.Stochastic(
                lambda ybar: mt.Normal(ybar, 1.0))}, ["tau"],
            y=np.array([1.0, np.nan, 3.0, 3.0, np.nan, 6.0]), miss=True),
            LINE6_SPECS, line_block, FIXTURE_RUN),
        "line_pad": (line_with(
            {"ybar": ybar(), "ss": ss(True), "tau": mt.Stochastic(
                lambda ybar: mt.Normal(ybar, 1.0))}, ["tau"], y=None),
            LINE6_SPECS, line_block, FIXTURE_RUN),
        "line_v": (line_with(
            {"v": mt.Stochastic(2, lambda w: mt.MvNormal(
                torch.stack([w, w], 1), torch.eye(2, dtype=w.dtype)),
                monitor=False)}, ["v"]),
            {**LINE6_SPECS, "w": ("data",), "v": ("data", None)},
            ("beta", "s2", "v"), FIXTURE_RUN),
        "birats_recycled": ((recycled, inputs, inits), BIRATS_SPECS,
                            ("beta", "mu_beta", "Sigma"), RESOLVED_RUN),
    }


def _fixture_at_inits(torch, mt, mesh, model, inputs, inits, specs, block):
    """A fixture at its inits: the unsharded model's log density, its
    ``block`` density and gradient and its monitored rows, against this
    rank's parts completed over the data group (the arrays padded as
    ``mcmc`` pads them) and its rows gathered: their relative errors."""
    from mamba_tpu_torch.model.mcmc import _chain_inits, _pad_sharded
    from mamba_tpu_torch.parallel.mesh import MeshComm
    whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
    p_in, p_inits, masks, pads = _pad_sharded(model, mesh, specs, inputs,
                                              inits)
    split = mt.compile_model(model, p_in, p_inits[0], device=DEVICE,
                             masks=masks, comm=MeshComm(mesh),
                             site_specs=specs, pads=pads)
    state = _chain_inits(whole, inits, CHAINS)
    local = _chain_inits(split, p_inits, CHAINS)
    lp = torch.func.vmap(whole.logpdf)(state).double()
    (part,) = split.comm.data_sum(torch.func.vmap(split.logpdf_part)(
        split.with_wholes(local)))
    rows = whole.monitor_rows()(state).T[None].double()
    got = split.gather_monitored(
        split.monitor_rows()(local).T[None]).double()
    pack, _, _, logf = whole.block_functions(block, True)
    gw, vw = torch.func.vmap(torch.func.grad_and_value(logf))(
        torch.func.vmap(pack)(state), state)
    st = split.block_prepare(block)(local)
    x = split.block_maps(block, True)[0](st)
    v, g = split.block_density(block, True, grad=True)(x, st)
    coords = split.block_coords(block)
    if coords.index is not None:
        gw = gw[:, coords.index]
    vw, gw, v, g = vw.double(), gw.double(), v.double(), g.double()
    return {"lp_rel_err": float(((part.double() - lp).abs() / lp.abs()).max()),
            "block_lp_rel_err": float(((v - vw).abs() / vw.abs()).max()),
            "grad_rel_err": float((g - gw).abs().max()
                                  / gw.abs().max().clamp_min(1e-30)),
            "rows_rel_err": float((got - rows).abs().max()
                                  / rows.abs().max().clamp_min(1.0)),
            "gathers": split.block_gathers(block),
            "gathered": sorted(split._gathered), "mixed": sorted(split.mixed),
            "cuts": split._cuts, "pads": split.pads}


def _fixtures(torch, mt, mesh, rank, outdir):
    """(j)'s fixtures on the (1, 2) data mesh in this rank: each at its
    inits against the unsharded model (1024 chains), then a short run
    (``FIXTURE_CHAINS``) whose draws are saved for the parent's check that
    both ranks agree."""
    out = {}
    for name, ((model, inputs, inits), specs, block, run) in _fixture_models(
            mt, torch).items():
        res = _fixture_at_inits(torch, mt, mesh, model, inputs, inits, specs,
                                block)
        iters, burnin = run
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=FIXTURE_CHAINS, verbose=False, device=DEVICE,
                      mesh=mesh, site_specs=specs)
        res["sample_s"] = sim.timing["sample_s"]
        np.save(Path(outdir) / f"fixture_{name}_draws{rank}.npy", sim.value)
        out[name] = res
    return out


#: (j)'s fixtures, in order
FIXTURES = ("line_ss_tau", "line_miss_ybar", "line_pad", "line_v",
            "birats_recycled")
#: what each fixture's block must do with gathered nodes (``block_gathers``)
FIXTURE_GATHERS = {"line_ss_tau": "call", "line_miss_ybar": "step",
                   "line_pad": "", "line_v": "", "birats_recycled": ""}


def _data_only_gates(data_only, chees_draws, fixture_draws, failed):
    """(j)'s gates on both ranks' results (``_data_only``): both forms'
    density and gradient against the whole, y reading the rank's slice of
    b (the fused kernel once per call over the rank's G/2 groups); the
    ChEES run's draws finite and equal on both ranks and its all-reduce
    of (C, 1 + whole dim); each fixture against the unsharded model, its
    draws finite and equal on both ranks.  Appends what fails to
    ``failed``."""
    half = MESH_G // 2
    a, b = chees_draws
    iters, burnin = MESH_CHEES_RUN
    if not (np.array_equal(a, b) and np.isfinite(a).all()
            and a.shape == (iters - burnin, 5, CHAINS)):
        failed.append("(j) ChEES: finite draws, equal on both ranks")
    if data_only[0]["chees"]["tunes"] != data_only[1]["chees"]["tunes"]:
        failed.append("(j) ChEES: (epsilon, traj) equal on both ranks")
    for r, res in enumerate(data_only):
        for form in ("fused", "generic"):
            d = res[form]
            if not (d["lp_rel_err"] <= LP_RTOL and d["grad_rel_err"] <= GRAD_RTOL
                    and d["cuts"] == {"y": {"b": {"0": ["data"]}}}
                    and d["held"] == []
                    and d["groups_split"] == half
                    and d["launches_split"] == (1 if form == "fused" else 0)):
                failed.append(f"(j) rank {r} {form}: {d}")
        run = res["chees"]
        if (run["data_sum_shape"] != [[CHAINS], [CHAINS, GLMM_WHOLE_DIM]]
                or run["z_shape"] != [CHAINS, MESH_G]):
            failed.append(f"(j) rank {r}: all-reduce {run['data_sum_shape']}, "
                          f"z {run['z_shape']}")
        for name in FIXTURES:
            f = res["fixtures"][name]
            if not (f["lp_rel_err"] <= LP_RTOL and f["block_lp_rel_err"] <= LP_RTOL
                    and f["grad_rel_err"] <= GRAD_RTOL
                    and f["rows_rel_err"] <= LP_RTOL
                    and f["gathers"] == FIXTURE_GATHERS[name]):
                failed.append(f"(j) rank {r} {name}: {f}")
    for name, (a, b) in fixture_draws.items():
        if not (np.array_equal(a, b) and np.isfinite(a).all()):
            failed.append(f"(j) {name}: finite draws, equal on both ranks")
    return {"fused": [r["fused"] for r in data_only],
            "generic": [r["generic"] for r in data_only],
            "chees": [{k: v for k, v in r["chees"].items() if k != "tunes"}
                      for r in data_only],
            "fixtures": [r["fixtures"] for r in data_only],
            "wall_s": [r["wall_s"] for r in data_only]}


#: (h)'s layout: the JAX package's own data-mesh setup of rats
#: (__graft_entry__.py:57)
RATS_SPECS = {"y": ("data",), "alpha": ("data",), "beta": ("data",)}


def _rats_data_mesh(torch, mt, nuts, mesh, rank, outdir, specs=RATS_SPECS,
                    label="(h)", tag="rats"):
    """(h): the rats NUTS headline, cut to ``RATS_DATA_MESH_RUN``, at
    1024 chains on a (1, 2) data mesh with y, alpha and beta named: each
    rank holds 15 of the 30 rats' y, alpha and beta, and its NUTS block
    sums over its coordinates across the two ranks (its captured leaf cut
    at the density's all-reduce and at the leaf's sums).  The
    golden mu_beta gate of phase 6; its wall per leapfrog; the draws saved
    for the parent's check that both ranks agree.  (l) runs it on its own
    mesh and ``specs`` (``tag`` names its files)."""
    from mamba_tpu_torch.models import rats
    iters, burnin = RATS_DATA_MESH_RUN
    model, inputs, inits = rats.build("nuts")
    depths, restore = _record_depths(nuts)
    try:
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE, mesh=mesh,
                      site_specs=specs)
    finally:
        restore()
    res = {**_timing(sim, CHAINS, iters), **_nuts_work(torch, depths)}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    res["peak_rise_bytes"] = sim.timing["peak_rise_bytes"]
    state = sim.states["state"]
    res["shapes"] = {k: list(state[k].shape) for k in ("y", "alpha", "beta")}
    res["held"] = sorted(sim.compiled._held)
    res["group_collectives"] = sim.timing.get("group_collectives", {})
    shape = tuple(mesh.mesh.shape)
    log(f"{label} rank {rank}, rats NUTS on a {shape} data mesh ({CHAINS} "
        f"chains, {iters} iters, {burnin} burnin): " + json.dumps(res))
    res.update(_rats_gates(mt, rats, sim, f"{label} rank {rank}"))
    np.save(Path(outdir) / f"{tag}_draws{rank}.npy", sim.value)
    return res


def _rats_chain_mesh(torch, mt, mesh, rank, outdir):
    """(i): phase 6's rats NUTS run (``RATS_NUTS_RUN``, 1024 chains) on the
    (2, 1) chain mesh, 512 chains a rank, each chain keyed by its global
    index: the gathered draws saved for the parent, which holds them chain
    by chain to phase 6's (the captured steps: a chain mesh replays)."""
    from mamba_tpu_torch.models import rats
    iters, burnin = RATS_NUTS_RUN
    model, inputs, inits = rats.build("nuts")
    sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=CHAINS,
                  verbose=False, device=DEVICE, mesh=mesh)
    res = {"sample_s": sim.timing["sample_s"],
           "local_chains": int(sim.states["key"].shape[0])}
    log(f"(i) rank {rank}, rats NUTS on a (2, 1) chain mesh: " + json.dumps(res))
    np.save(Path(outdir) / f"rats_chain_draws{rank}.npy", sim.value)
    return res


#: (i): of phase 6's 1024 chains run on the (2, 1) chain mesh, the share
#: whose draws must be bit-identical, and the largest absolute difference
#: of any draw (float32).  Measured: every chain bit-identical, 512 chains
#: a rank against 1024 in one process (measured on one H100, two ranks;
#: PERF.md §6): a chain's numbers are its key's, and the leaf's arithmetic
#: runs per chain, so the gate is exact
RATS_CHAIN_IDENTICAL_MIN, RATS_CHAIN_MAX_DIFF = 1.0, 0.0


def _rats_chains_gates(draws, want, failed):
    """(i)'s gates: both ranks hold the same draws, and each chain's draws
    against phase 6's, chain by chain."""
    if not np.array_equal(draws[0], draws[1]):
        failed.append("(i) both ranks hold every chain's draws")
    a, b = draws[0], want
    if a.shape != b.shape or not np.isfinite(a).all():
        failed.append("(i) finite draws of phase 6's shape")
        return {"shape": list(a.shape)}
    same = np.all(a == b, axis=(0, 1))
    diff = np.abs(a.astype(np.float64) - b)
    res = {"chains": int(a.shape[2]), "identical_share": float(same.mean()),
           "max_abs_diff": float(diff.max()),
           "max_rel_diff": float((diff / np.maximum(np.abs(b), 1e-30)).max()),
           "gate_identical_min": RATS_CHAIN_IDENTICAL_MIN,
           "gate_max_abs_diff": RATS_CHAIN_MAX_DIFF}
    if res["identical_share"] < RATS_CHAIN_IDENTICAL_MIN:
        failed.append("(i) bit-identical chains")
    if res["max_abs_diff"] > RATS_CHAIN_MAX_DIFF:
        failed.append("(i) largest difference")
    return res


def _mesh_graph_arms(mt, glmm, warm):
    """(k)'s arms, each ``() -> (model, inputs, inits, site_specs, work)``
    (``work``: "leapfrogs" for NUTS, "gradients" for ChEES, whose
    gradient at the start of an iteration is eager and outside the
    capture): (h)'s rats NUTS layout, (e)'s GLMM ChEES with y, xt and z
    named, and (j)'s fused GLMM with only its data named, from (e)'s warm
    starts."""
    from mamba_tpu_torch.models import rats

    def rats_nuts():
        model, inputs, inits = rats.build("nuts")
        return model, inputs, inits, RATS_SPECS, "leapfrogs"

    def glmm_chees(specs):
        def build():
            model, inputs, _, _ = glmm.build(MESH_G, fused=True)
            model = _chees_block(mt, model, max_steps=256, mass_window=40,
                                 traj=MESH_GRAPH_CHEES_TRAJ)
            return model, inputs, warm, specs, "gradients"
        return build
    return {"rats_nuts": rats_nuts, "glmm_chees_local": glmm_chees(LOCAL_SPECS),
            "glmm_chees_data": glmm_chees(DATA_SPECS)}


def _mesh_graphs(torch, mt, glmm, fg, nuts, chees, warm, mesh, rank, outdir,
                 arms=None, label="(k)"):
    """(k): each of ``_mesh_graph_arms`` (or ``arms``, (l)'s) on the
    (1, 2) data mesh (or ``mesh``) for
    ``MESH_GRAPH_RUN``, through the engine's captured steps (each body cut
    at its collectives, which run between the segments' replays) and under
    ``graphs.disabled()`` (the plain loops), from one seed: draws, tunes,
    final state and keys equal bit for bit, and every transition's tree
    depths or trajectory lengths; each way's wall per leapfrog or
    gradient, with the capture and without it, the segments replayed and
    the collectives run per leapfrog or gradient and their host ms; the
    fused kernel's launches, through the segments' replays.  The captured
    draws are saved for the parent's check that both ranks agree."""
    import contextlib
    from mamba_tpu_torch.utils import graphs
    iters, burnin = MESH_GRAPH_RUN
    res = {}
    arms = arms or _mesh_graph_arms(mt, glmm, warm)
    for name, build in arms.items():
        out, sims, seen = {}, {}, {}
        for way in ("captured", "plain"):
            model, inputs, inits, specs, unit = build()
            if unit == "leapfrogs":
                record, restore = _record_depths(nuts)
            else:
                record, restore = _recording(chees, "_steps", lambda L: L)
            fg.glmm_loglik_grads.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                with (graphs.disabled() if way == "plain"
                      else contextlib.nullcontext()):
                    sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                                  chains=CHAINS, verbose=False, device=DEVICE,
                                  mesh=mesh, site_specs=specs)
            finally:
                restore()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            work = (_nuts_work(torch, record)["leapfrog_steps"]
                    if unit == "leapfrogs" else sum(L + 1 for L in record))
            t = _timing(sim, CHAINS, iters)
            out[way] = {
                "wall_s": wall, "sample_s": t["sample_s"], unit: work,
                f"wall_ms_per_{unit[:-1]}": 1e3 * t["sample_s"] / work,
                f"net_ms_per_{unit[:-1]}":
                    1e3 * (t["sample_s"] - t["capture_s"]) / work,
                "capture_s": t["capture_s"], "graphs": t["graphs"],
                f"replays_per_{unit[:-1]}": t["replays"] / work,
                f"collectives_per_{unit[:-1]}": t["collectives"] / work,
                "collective_ms": 1e3 * t["collective_s"],
                f"collective_ms_per_{unit[:-1]}":
                    1e3 * t["collective_s"] / work,
                "kernel_launches": fg.glmm_loglik_grads.launches}
            sims[way], seen[way] = sim, [
                r.tolist() if hasattr(r, "tolist") else r for r in record]
        cap, plain = out["captured"], out["plain"]
        cap["equal"] = (_same_run(torch, sims["captured"], sims["plain"])
                        and seen["captured"] == seen["plain"])
        if not cap["equal"]:
            raise AssertionError(f"{label} rank {rank} {name}: the captured "
                                 f"run differs from the plain loops")
        u = unit[:-1]
        if not (cap["graphs"] > 0 and cap[f"collectives_per_{u}"] > 0
                and plain["graphs"] == 0):
            raise AssertionError(f"{label} rank {rank} {name}: not captured, "
                                 f"or no collective between replays: {out}")
        cap["group_collectives"] = sims["captured"].timing.get(
            "group_collectives", {})
        np.save(Path(outdir) / f"graph_{name}_draws{rank}.npy",
                sims["captured"].value)
        del sims
        log(f"{label} rank {rank}, {name} captured against plain on a "
            f"{tuple(mesh.mesh.shape)} data mesh ({CHAINS} chains, {iters} "
            f"iters, {burnin} burnin): " + json.dumps(out))
        res[name] = out
    return res


#: (m)'s jaws run, on the mesh and without it (iterations, burnin), at
#: ``FIXTURE_CHAINS``; and the float32 bound of their draws' difference,
#: relative to the draws' scale
JAWS_MESH_RUN, JAWS_DRAWS_RTOL = (40, 20), 1e-4


def _glmm_sum0(mt, glmm, torch):
    """(m)'s full-width arm: (g)(i)'s GLMM (z ~ Normal(w, 1), w named, so
    a rank holds z in part) with the sum-to-zero random effect b =
    sqrt(s2) * (z - mean(z)), which every rank computes whole from z
    gathered in each density call of the (beta, z, s2) block: each rank's
    y reads its 5,000 groups of it through the fused kernel, and the
    block sums its gradient in z over the two ranks before each rank
    pulls its slice back."""
    base, inputs, inits = _glmm_w(mt, glmm)
    model = mt.Model(**{**base.nodes, "b": mt.Logical(
        1, lambda s2, z: torch.sqrt(s2) * (z - torch.mean(z)),
        monitor=False)})
    model.set_samplers(base.samplers)
    return model, inputs, inits


def _per_call_against_whole(torch, fg, whole, split, state):
    """The (beta, z, s2) block density and gradient of ``split``, a data
    rank's compiled model that gathers per call, completed by
    ``block_density`` (the all-gather of z, the all-reduce of the gradient
    in it, the density's all-reduce), against ``whole``'s at the whole
    state ``state``: their errors, each one's launches and the ms of one
    call's gather and gradient sum at this size, staged under gloo."""
    params = ("beta", "z", "s2")
    pack, _, _, logf = whole.block_functions(params, True)
    fg.glmm_loglik_grads.launches = 0
    gw, vw = torch.func.vmap(torch.func.grad_and_value(logf))(
        torch.func.vmap(pack)(state), state)
    n_whole = fg.glmm_loglik_grads.launches
    local = split.block_prepare(params)(split.cut_state(state))
    x = split.block_maps(params, True)[0](local)
    density = split.block_density(params, True, grad=True)
    fg.glmm_loglik_grads.launches = 0
    v, g = density(x, local)
    n_split = fg.glmm_loglik_grads.launches
    coords = split.block_coords(params)
    gw = gw[:, coords.index]
    vw, gw, v, g = vw.double(), gw.double(), v.double(), g.double()
    z = local["z"]
    wz = torch.zeros(CHAINS, MESH_G, device=DEVICE)
    ms = {}
    for name, fn in (("gather_ms", lambda: split.comm.gather_data_many([z])),
                     ("grad_sum_ms", lambda: split.comm.data_sum(wz))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DATA_SUM_REPS):
            fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0) / DATA_SUM_REPS
    return {"lp_rel_err": float(((v - vw).abs() / vw.abs()).max()),
            "grad_rel_err": float((g - gw).abs().max() / gw.abs().max()),
            "launches_split": n_split, "launches_whole": n_whole,
            "held": sorted(split._held), "gathered": {
                k: sorted(v) for k, v in split._gathered.items()},
            "cuts": split._cuts, "groups_split": split.inputs["xt"].shape[-1],
            "grad_shape": list(g.shape), **ms}


def _gathered_fixture_models(mt, torch):
    """(m)'s small layouts: name -> ((model, inputs, inits), site_specs,
    the gradient block held to the whole, the run).  Line's y2, named,
    reading ss = sum((y - mu)**2), which beta's block gathers per call
    (item 11); v ~ MvNormal(stack([w, w]), I) named on its event dim
    (item 10); tau's prior on g2 = sum(h**2), h = mu - mean(mu) a slice
    computed from a gathered node (item 12); line's own five points, which
    the axis pads to six, beside w and u of six as given, tau's prior on
    mean(y) (item 13)."""
    from mamba_tpu_torch.models import line
    six = np.array([1.0, 3.0, 3.0, 3.0, 5.0, 6.0])

    def line_with(extra, sampled, y=six):
        model, inputs, inits = line.build()
        model = mt.Model(**{**model.nodes, **extra})
        model.set_samplers([mt.NUTS("beta"), mt.Slice("s2", 3.0)]
                           + [mt.Slice(n, 1.0) for n in sampled])
        w = np.linspace(-0.6, 0.9, 6)
        if y is None:
            return model, dict(inputs, w=w), [dict(
                i, tau=0.5, u=np.zeros(6)) for i in inits]
        inputs = {"xmat": np.stack([np.ones(6), np.arange(1.0, 7.0)], 1),
                  "w": w}
        return model, inputs, [dict(i, y=y, y2=y + 0.5, tau=0.5, v=np.linspace(
            -1.0, 1.2, 12).reshape(6, 2)) for i in inits]

    ss = mt.Logical(lambda y, mu: torch.sum((y - mu) ** 2), monitor=False)
    block = ("beta", "s2", "tau")
    return {
        "named_reader": (line_with({
            "ss": ss, "tau": mt.Stochastic(lambda ss: mt.Normal(0.1 * ss, 1.0)),
            "y2": mt.Stochastic(1, lambda mu, ss: mt.Normal(mu + 0.01 * ss, 1.0),
                                monitor=False)}, ["tau"]),
            {**LINE6_SPECS, "y2": ("data",)}, block, FIXTURE_RUN),
        "v_event": (line_with({"v": mt.Stochastic(2, lambda w: mt.MvNormal(
            torch.stack([w, w], 1), torch.eye(2, dtype=w.dtype)),
            monitor=False)}, ["v"]),
            {**LINE6_SPECS, "w": ("data",), "v": (None, "data")},
            ("beta", "s2", "v"), FIXTURE_RUN),
        "nested": (line_with({
            "g1": mt.Logical(lambda mu: torch.mean(mu), monitor=False),
            "h": mt.Logical(1, lambda mu, g1: mu - g1, monitor=False),
            "g2": mt.Logical(lambda h: torch.sum(h ** 2), monitor=False),
            "tau": mt.Stochastic(lambda g2: mt.Normal(0.1 * g2, 1.0))},
            ["tau"]), LINE6_SPECS, block, FIXTURE_RUN),
        "padded": (line_with({
            "ybar": mt.Logical(lambda y: torch.mean(y), monitor=False),
            "tau": mt.Stochastic(lambda ybar: mt.Normal(ybar, 1.0)),
            "u": mt.Stochastic(1, lambda w: mt.Normal(w, 1.0), monitor=False)},
            ["tau", "u"], y=None),
            {**LINE6_SPECS, "w": ("data",), "u": ("data",)},
            ("beta", "s2", "tau", "u"), FIXTURE_RUN),
    }


#: what each of (m)'s small layouts' blocks does with gathered nodes
GATHERED_FIXTURE_GATHERS = {"named_reader": "call", "v_event": "",
                            "nested": "call", "padded": ""}


def _gathered_terms(torch, mt, glmm, fg, nuts, chees, warm, mesh, rank,
                    outdir):
    """(m): the last layouts the data axis refused, on the (1, 2) data
    mesh in this rank.  The full-width arm (``_glmm_sum0``): its density
    and gradient at the warm starts against the whole, ChEES at
    ``MESH_CHEES_RUN``, and 3/2 captured against plain (``_mesh_graphs``,
    its cuts per gradient); jaws with y and x named by boy under its
    Slice + AMWG scheme, against the whole at its inits and its run against
    the same run without a mesh; then the small layouts
    (``_gathered_fixture_models``), each against the unsharded model at its
    inits and a short run.  Draws saved for the parent's check that both
    ranks agree."""
    from mamba_tpu_torch.model.mcmc import _chain_inits
    from mamba_tpu_torch.models import jaws
    from mamba_tpu_torch.parallel.mesh import MeshComm
    res = {}
    model, inputs, inits = _glmm_sum0(mt, glmm, torch)
    starts = [dict(w, y=inits[0]["y"]) for w in warm]
    whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
    split = mt.compile_model(model, inputs, inits[0], device=DEVICE,
                             comm=MeshComm(mesh), site_specs=W_SPECS)
    res["density"] = _per_call_against_whole(
        torch, fg, whole, split, _chain_inits(whole, starts, CHAINS))
    del whole, split
    log(f"(m) rank {rank}, the sum-to-zero GLMM's density against the "
        f"whole: " + json.dumps(res["density"]))
    run, sim, tunes = _glmm_chees_run(
        torch, mt, glmm, fg, chees, warm,
        f"(m) rank {rank}, the sum-to-zero GLMM, b gathered per call",
        build=lambda: _glmm_sum0(mt, glmm, torch)[:2], mesh=mesh,
        site_specs=W_SPECS)
    np.save(Path(outdir) / f"sum0_draws{rank}.npy", sim.value)
    run["tunes"] = tunes
    run["z_shape"] = list(sim.states["state"]["z"].shape)
    res["chees"] = run
    del sim

    def sum0_graphs():
        model, inputs, _ = _glmm_sum0(mt, glmm, torch)
        model = _chees_block(mt, model, max_steps=256, mass_window=40,
                             traj=MESH_GRAPH_CHEES_TRAJ)
        return model, inputs, warm, W_SPECS, "gradients"
    res["graphs"] = _mesh_graphs(torch, mt, glmm, fg, nuts, chees, warm,
                                 mesh, rank, outdir, arms={"sum0": sum0_graphs},
                                 label="(m)")["sum0"]
    model, inputs, inits = jaws.build()
    specs = {"y": ("data",), "x": ("data",)}
    res["jaws"] = _fixture_at_inits(torch, mt, mesh, model, inputs, inits,
                                    specs, ("beta0", "beta1"))
    iters, burnin = JAWS_MESH_RUN
    sims = [mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                    chains=FIXTURE_CHAINS, verbose=False, device=DEVICE,
                    **kw) for kw in ({"mesh": mesh, "site_specs": specs}, {})]
    diff = np.abs(sims[0].value.astype(np.float64) - sims[1].value)
    res["jaws"].update({
        "whole_terms": sorted(sims[0].compiled._whole_terms),
        "y_shape": list(sims[0].states["state"]["y"].shape),
        "draws_max_abs_diff": float(diff.max()),
        "draws_rel_diff": float(diff.max() / np.abs(sims[1].value).max()),
        "sample_s": [s.timing["sample_s"] for s in sims]})
    np.save(Path(outdir) / f"gfix_jaws_draws{rank}.npy", sims[0].value)
    del sims
    fixtures = {}
    for name, ((model, inputs, inits), specs, block, run) in (
            _gathered_fixture_models(mt, torch).items()):
        out = _fixture_at_inits(torch, mt, mesh, model, inputs, inits, specs,
                                block)
        iters, burnin = run
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=FIXTURE_CHAINS, verbose=False, device=DEVICE,
                      mesh=mesh, site_specs=specs)
        out["sample_s"] = sim.timing["sample_s"]
        out["whole_terms"] = sorted(sim.compiled._whole_terms)
        np.save(Path(outdir) / f"gfix_{name}_draws{rank}.npy", sim.value)
        fixtures[name] = out
    res["fixtures"] = fixtures
    log(f"(m) rank {rank}: " + json.dumps(
        {k: v for k, v in res.items() if k != "graphs"}))
    return res


#: (m)'s small layouts' draws, saved by name
GATHERED_DRAWS = ("sum0", "gfix_jaws", *(f"gfix_{n}" for n in
                                         GATHERED_FIXTURE_GATHERS))


def _gathered_gates(gathered, draws, graph_draws, failed):
    """(m)'s gates on both ranks' results (``_gathered_terms``; its
    captured run already raised where it differs from its plain loops):
    the full-width arm's density and gradient against the whole, one
    launch per call over each rank's G/2 groups, z held and gathered, the
    gradient in it summed; its ChEES draws finite and equal on both ranks;
    jaws against the whole and its run against the run without a mesh;
    each small layout against the unsharded model; every run's draws
    finite and equal on both ranks.  Appends what fails to ``failed``."""
    half = MESH_G // 2
    iters, burnin = MESH_CHEES_RUN
    for name in (*GATHERED_DRAWS, "graph_sum0"):
        a, b = (graph_draws if name == "graph_sum0" else draws[name])
        if not (np.array_equal(a, b) and np.isfinite(a).all()):
            failed.append(f"(m) {name}: finite draws, equal on both ranks")
    if draws["sum0"][0].shape != (iters - burnin, 5, CHAINS):
        failed.append(f"(m) ChEES draws shaped {draws['sum0'][0].shape}")
    if gathered[0]["chees"]["tunes"] != gathered[1]["chees"]["tunes"]:
        failed.append("(m) ChEES: (epsilon, traj) equal on both ranks")
    for r, res in enumerate(gathered):
        d = res["density"]
        if not (d["lp_rel_err"] <= LP_RTOL and d["grad_rel_err"] <= GRAD_RTOL
                and d["launches_split"] == 1 and d["groups_split"] == half
                and d["held"] == ["z"] and d["gathered"] == {"b": ["z"]}
                and res["chees"]["z_shape"] == [CHAINS, half]):
            failed.append(f"(m) rank {r} the sum-to-zero GLMM: {d}, z "
                          f"{res['chees']['z_shape']}")
        j = res["jaws"]
        if not (j["lp_rel_err"] <= LP_RTOL and j["block_lp_rel_err"] <= LP_RTOL
                and j["grad_rel_err"] <= GRAD_RTOL
                and j["whole_terms"] == ["y"] and j["y_shape"][1:] == [40]
                and j["draws_rel_diff"] <= JAWS_DRAWS_RTOL):
            failed.append(f"(m) rank {r} jaws: {j}")
        for name, want in GATHERED_FIXTURE_GATHERS.items():
            f = res["fixtures"][name]
            if not (f["lp_rel_err"] <= LP_RTOL
                    and f["block_lp_rel_err"] <= LP_RTOL
                    and f["grad_rel_err"] <= GRAD_RTOL
                    and f["rows_rel_err"] <= LP_RTOL
                    and f["gathers"] == want):
                failed.append(f"(m) rank {r} {name}: {f}")
    return {"density": [r["density"] for r in gathered],
            "chees": [{k: v for k, v in r["chees"].items() if k != "tunes"}
                      for r in gathered],
            "graphs": [r["graphs"] for r in gathered],
            "jaws": [r["jaws"] for r in gathered],
            "fixtures": [r["fixtures"] for r in gathered],
            "wall_s": [r["wall_s"] for r in gathered]}


def mesh_rank(init, rank, outdir):
    """One rank of the mesh phase's (c), (d), (e), (g), (h), (i), (j), (k)
    and (m): two processes over gloo, both on this process's card."""
    import torch
    import torch.distributed as dist
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm
    from mamba_tpu_torch.ops import fused_glmm as fg
    from mamba_tpu_torch.parallel import distributed_init, make_mesh
    from mamba_tpu_torch.samplers import chees, nuts
    outdir = Path(outdir)
    with np.load(outdir / "warm.npz") as f:
        warm_arrays = {k: f[k] for k in f.files}
    _, _, inits, _ = glmm.build(MESH_G, fused=True)
    warm = [dict(inits[0], **{k: v[i] for k, v in warm_arrays.items()})
            for i in range(CHAINS)]
    distributed_init(init, 2, rank, device_type="cpu",
                     timeout=MESH_GROUP_TIMEOUT)
    try:
        mesh = make_mesh({"chains": 2}, "cpu")
        res, sim, tunes = _glmm_chees_run(
            torch, mt, glmm, fg, chees, warm,
            f"(c) rank {rank} of a 2-rank gloo chain mesh", mesh=mesh)
        res["tunes"] = tunes
        res["draws_shape"] = list(sim.value.shape)
        np.save(outdir / f"draws{rank}.npy", sim.value)
        res["write_s"] = _write_sharded(torch, mt, sim, outdir, "chain_mesh",
                                        rank)
        del sim
        data_mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
        res["split"] = _split_density_check(torch, mt, glmm, fg, data_mesh,
                                            warm)
        res["local"] = _local_views(torch, mt, glmm, fg, chees, warm,
                                    data_mesh, rank, outdir)
        t0 = time.perf_counter()
        res["resolved"] = _resolved_cases(torch, mt, glmm, fg, warm,
                                          data_mesh, rank, outdir)
        res["resolved"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["rats"] = _rats_data_mesh(torch, mt, nuts, data_mesh, rank, outdir)
        res["rats"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["rats_chains"] = _rats_chain_mesh(torch, mt, mesh, rank, outdir)
        res["rats_chains"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["data_only"] = _data_only(torch, mt, glmm, fg, chees, warm,
                                      data_mesh, rank, outdir)
        res["data_only"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["graphs"] = _mesh_graphs(torch, mt, glmm, fg, nuts, chees, warm,
                                     data_mesh, rank, outdir)
        res["graphs"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["gathered"] = _gathered_terms(torch, mt, glmm, fg, nuts, chees,
                                          warm, data_mesh, rank, outdir)
        res["gathered"]["wall_s"] = time.perf_counter() - t0
        (outdir / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


#: (l)'s layouts, as the JAX package's PartitionSpecs name them: rats cut by
#: rat and by week (the five weeks padded to six), the fused GLMM's groups
#: over a tuple of axes, the generic GLMM cut on two dims (y (G, n), x
#: (G, n, P), z (G,), z's gradient summed over obs)
RATS_AXES_SPECS = {"y": ("data", "week"), "Xm": ("week",), "alpha": ("data",),
                   "beta": ("data",)}
GLMM_TUPLE_SPECS = {"y": (None, ("data", "obs")),
                    "xt": (None, None, ("data", "obs")),
                    "z": (("data", "obs"),)}
GLMM_TWO_DIM_SPECS = {"y": ("data", "obs"), "x": ("data", "obs", None),
                      "z": ("data",)}
#: (l)'s ranks: four gloo processes on the one card, a (1, 2, 2) mesh
AXES_RANKS = 4


def _axes_glmm(torch, mt, glmm, fg, chees, warm, mesh, rank, outdir):
    """(l)'s GLMM arms on the (1, 2, 2) chains x data x obs mesh: the
    fused form with its groups over ("data", "obs") (each rank 2,500 of
    the 10,000) and the generic form cut by groups and observations, each
    block density and gradient at the warm starts completed over the
    group against the whole; then the fused form under ChEES at
    ``MESH_CHEES_RUN``, captured, its kernel launches counted through the
    segments' replays."""
    from mamba_tpu_torch.model.mcmc import _chain_inits
    from mamba_tpu_torch.parallel.mesh import MeshComm
    res = {}
    for fused, specs in ((True, GLMM_TUPLE_SPECS), (False, GLMM_TWO_DIM_SPECS)):
        model, inputs, inits, _ = glmm.build(MESH_G, fused=fused)
        starts = [dict(w, y=inits[0]["y"]) for w in warm]
        whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
        split = mt.compile_model(model, inputs, inits[0], device=DEVICE,
                                 comm=MeshComm(mesh), site_specs=specs)
        d = _split_against_whole(torch, fg, whole, split,
                                 _chain_inits(whole, starts, CHAINS))
        d["layouts"] = {k: {str(i): list(a) for i, a in v.items()}
                        for k, v in split._held.items()}
        d["block_shape"] = list(split.inputs["xt" if fused else "x"].shape)
        res["fused" if fused else "generic"] = d
        del whole, split
    run, sim, tunes = _glmm_chees_run(
        torch, mt, glmm, fg, chees, warm,
        f"(l) rank {rank}, the fused GLMM's groups over (data, obs)",
        mesh=mesh, site_specs=GLMM_TUPLE_SPECS)
    np.save(Path(outdir) / f"axes_glmm_draws{rank}.npy", sim.value)
    run["tunes"] = tunes
    run["z_shape"] = list(sim.states["state"]["z"].shape)
    run["group_collectives"] = sim.timing.get("group_collectives", {})
    res["chees"] = run
    return res


def axes_rank(init, rank, outdir):
    """One of the four ranks of the mesh phase's (l): several data axes."""
    import torch
    import torch.distributed as dist
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm, rats
    from mamba_tpu_torch.ops import fused_glmm as fg
    from mamba_tpu_torch.parallel import distributed_init, make_mesh
    from mamba_tpu_torch.samplers import chees, nuts
    outdir = Path(outdir)
    with np.load(outdir / "warm.npz") as f:
        warm_arrays = {k: f[k] for k in f.files}
    _, _, inits, _ = glmm.build(MESH_G, fused=True)
    warm = [dict(inits[0], **{k: v[i] for k, v in warm_arrays.items()})
            for i in range(CHAINS)]
    distributed_init(init, AXES_RANKS, rank, device_type="cpu",
                     timeout=MESH_GROUP_TIMEOUT)
    try:
        weeks = make_mesh({"chains": 1, "data": 2, "week": 2}, "cpu")
        obs = make_mesh({"chains": 1, "data": 2, "obs": 2}, "cpu")
        res = {}
        t0 = time.perf_counter()
        res["rats"] = _rats_data_mesh(torch, mt, nuts, weeks, rank, outdir,
                                      specs=RATS_AXES_SPECS, label="(l)",
                                      tag="axes_rats")
        res["rats"]["wall_s"] = time.perf_counter() - t0

        def rats_axes():
            model, inputs, inits = rats.build("nuts")
            return model, inputs, inits, RATS_AXES_SPECS, "leapfrogs"
        t0 = time.perf_counter()
        res["graphs"] = _mesh_graphs(torch, mt, glmm, fg, nuts, chees, warm,
                                     weeks, rank, outdir,
                                     arms={"rats_axes": rats_axes}, label="(l)")
        res["graphs"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["glmm"] = _axes_glmm(torch, mt, glmm, fg, chees, warm, obs, rank,
                                 outdir)
        res["glmm"]["wall_s"] = time.perf_counter() - t0
        (outdir / f"axes{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _axes_gates(ranks, rats_draws, graph_draws, glmm_draws, failed):
    """(l)'s gates on the four ranks' results (``axes_rank``, whose rats
    run raised on the mu_beta gate and whose captured rats run raised
    where it differed from its plain loops already): the draws finite and
    equal on every rank; each rank holding 15 rats of alpha and beta and
    15 x 3 of y; the fused GLMM's ranks each over 2,500 groups, its
    kernel launched in the run, both forms' density and gradient against
    the whole under phase 3's gates.  Appends what fails to ``failed``."""
    for label, draws in (("rats", rats_draws), ("graphs", graph_draws),
                         ("glmm", glmm_draws)):
        if not (all(np.array_equal(d, draws[0]) for d in draws)
                and np.isfinite(draws[0]).all()):
            failed.append(f"(l) {label}: finite draws, equal on every rank")
    iters, burnin = MESH_CHEES_RUN
    if glmm_draws[0].shape != (iters - burnin, 5, CHAINS):
        failed.append(f"(l) glmm: draws shaped {glmm_draws[0].shape}")
    quarter = MESH_G // AXES_RANKS
    for r, res in enumerate(ranks):
        rats_ = res["rats"]
        if (rats_["shapes"] != {"y": [CHAINS, 15, 3], "alpha": [CHAINS, 15],
                                "beta": [CHAINS, 15]}
                or rats_["held"] != ["alpha", "beta"]):
            failed.append(f"(l) rank {r}: holds {rats_['shapes']}, held "
                          f"{rats_['held']}")
        g = res["glmm"]
        for form, held, shape in (
                ("fused", {"z": {"0": ["data", "obs"]}}, [4, 10, quarter]),
                ("generic", {"z": {"0": ["data"]}}, [MESH_G // 2, 5, 4])):
            d = g[form]
            if not (d["lp_rel_err"] <= LP_RTOL and d["grad_rel_err"] <= GRAD_RTOL
                    and d["layouts"] == held and d["block_shape"] == shape
                    and d["launches_split"] == (1 if form == "fused" else 0)):
                failed.append(f"(l) rank {r} {form}: {d}")
        run = g["chees"]
        if run["z_shape"] != [CHAINS, quarter] or run["kernel_launches"] <= 0:
            failed.append(f"(l) rank {r} ChEES: z {run['z_shape']}, "
                          f"{run['kernel_launches']} launches")
    if any(res["glmm"]["chees"]["tunes"] != ranks[0]["glmm"]["chees"]["tunes"]
           for res in ranks):
        failed.append("(l) ChEES: (epsilon, traj) equal on every rank")
    keys = ("sample_s", "wall_s", "leapfrog_steps", "wall_ms_per_leapfrog",
            "mu_beta_mean", "group_collectives")
    return {"rats": {k: [res["rats"][k] for res in ranks] for k in keys},
            "graphs": [res["graphs"] for res in ranks],
            "glmm": [{form: res["glmm"][form] for form in ("fused", "generic")}
                     for res in ranks],
            "chees": [{k: v for k, v in res["glmm"]["chees"].items()
                       if k not in ("tunes", "steps_per_iteration")}
                      for res in ranks],
            "wall_s": [res["rats"]["wall_s"] + res["graphs"]["wall_s"]
                       + res["glmm"]["wall_s"] for res in ranks]}


def _local_views_gates(local, draws, failed):
    """(e)'s gates on both ranks' results (``_local_views``): finite draws
    equal on both ranks, each rank's density and gradient against the
    whole, one launch per call over its G/2 groups, the shapes it holds,
    and its peak memory rise at least ``LOCAL_MEM_SAVED_MIN`` below the
    same steps without a mesh.  Appends what fails to ``failed``."""
    iters, burnin = MESH_CHEES_RUN
    half = MESH_G // 2
    if not (np.array_equal(draws[0], draws[1]) and np.isfinite(draws[0]).all()
            and draws[0].shape == (iters - burnin, 5, CHAINS)):
        failed.append("(e) finite draws, equal on both ranks")
    if local[0]["tunes"] != local[1]["tunes"]:
        failed.append("(e) (epsilon, traj) equal on both ranks")
    for r, res in enumerate(local):
        d = res["density"]
        if not (d["lp_rel_err"] <= LP_RTOL and d["grad_rel_err"] <= GRAD_RTOL):
            failed.append(f"(e) rank {r}: the density against the whole")
        if d["launches_split"] != 1 or d["groups_split"] != half:
            failed.append(f"(e) rank {r}: one launch per call over {half} groups")
        if (res["shapes"]["y"] != [CHAINS, 10, half]
                or res["shapes"]["xt"] != [4, 10, half]
                or res["shapes"]["z"] != [CHAINS, half]
                or res["minv_shape"] != [half + 5]
                or d["held"] != ["z"]):
            failed.append(f"(e) rank {r}: the shapes it holds {res['shapes']}, "
                          f"minv {res['minv_shape']}, held {d['held']}")
        if res["data_sum_shape"] != [CHAINS, 6]:
            failed.append(f"(e) rank {r}: a call's all-reduce carries "
                          f"{res['data_sum_shape']}, not [{CHAINS}, 6]")
    whole = local[0]["whole_peak_rise_bytes"]
    saved = [whole - res["peak_rise_bytes"] for res in local]
    if min(saved) < LOCAL_MEM_SAVED_MIN:
        failed.append(f"(e) peak memory saved per rank {saved} bytes, "
                      f"< {LOCAL_MEM_SAVED_MIN:.0f}")
    return {"peak_rise_bytes": [res["peak_rise_bytes"] for res in local],
            "whole_peak_rise_bytes": whole, "saved_bytes": saved,
            "rise_below_z_whole_bytes": [LOCAL_RISE_Z_WHOLE - res["peak_rise_bytes"]
                                         for res in local],
            "shapes": local[0]["shapes"],
            "density": [res["density"] for res in local],
            "data_sum_ms": [res["data_sum_ms"] for res in local],
            "data_sum_shape": local[0]["data_sum_shape"],
            "rank_dim": local[0]["rank_dim"], "whole_dim": local[0]["whole_dim"],
            "sample_s": [res["sample_s"] for res in local],
            "leapfrog_steps": local[0]["leapfrog_steps"],
            "wall_ms_per_gradient": [res["wall_ms_per_gradient"]
                                     for res in local]}


class _RankView:
    """Data rank ``rank`` of a (1, 2) chains x data mesh as one process
    holds it, for timing its part of a density (no collective is called)."""
    chain_axis, data_axis, data_axes = "chains", "data", ("data",)
    chain_rank, chain_size, data_size = 0, 1, 2

    def __init__(self, rank):
        self.data_rank = rank

    @property
    def data_shape(self):
        return (self.data_size,)


#: density calls timed per figure of ``_rank_density_ms``
DENSITY_REPS = 10


def _rank_density_ms(torch, mt, glmm, warm):
    """Ms per (beta, z, s2) block density and gradient of 1024 chains at
    the warm starts, whole and as data rank 0 of two holds it under local
    views, on the fused and the generic GLMM: CUDA events around eager
    calls (``eager``: the host's dispatch, where it is the slower) and
    around replays of the call captured in a CUDA graph (``device``)."""
    from mamba_tpu_torch.model.mcmc import _chain_inits
    from mamba_tpu_torch.utils.graphs import Captured
    params = ("beta", "z", "s2")
    out = {}
    for fused, specs in ((True, LOCAL_SPECS), (False, LOCAL_SPECS_GENERIC)):
        model, inputs, inits, _ = glmm.build(MESH_G, fused=fused)
        starts = [dict(w, y=inits[0]["y"]) for w in warm]
        whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
        state = _chain_inits(whole, starts, CHAINS)
        for name, cm in (("whole", whole), ("rank", mt.compile_model(
                model, inputs, inits[0], device=DEVICE, comm=_RankView(0),
                site_specs=specs))):
            local = cm.cut_state(state)
            pack, _, _, logf = cm.block_functions(params, True)
            f = torch.func.vmap(torch.func.grad_and_value(logf))
            cap = Captured(lambda bufs, st: f(bufs["x"], st))
            cap.load(x=torch.func.vmap(pack)(local))
            cap.load_state(local)
            cap.run()                                   # captured here
            torch.cuda.synchronize()
            key = f"{'fused' if fused else 'generic'}_{name}"
            out[key] = {
                "eager": _event_ms(torch, lambda: f(cap.bufs["x"], local),
                                   DENSITY_REPS),
                "device": _event_ms(torch, cap.run, DENSITY_REPS)}
            del cap
        del whole, state
    return out


def phase_mesh(torch, mt, glmm, fg, chees, glmm_cases, warm, tunes_10,
               rats_draws_6):
    """(a)-(e) of the mesh phase, then the kernel at a rank's shares."""
    import tempfile
    import torch.distributed as dist
    from mamba_tpu_torch.graft_entry import dryrun_multichip
    from mamba_tpu_torch.parallel import make_mesh
    from mamba_tpu_torch.parallel.launch import run_ranks
    res = {}
    t0 = time.perf_counter()
    dryrun_multichip(1, device=DEVICE)                            # (a)
    res["dryrun_s"] = time.perf_counter() - t0
    mesh = make_mesh({"chains": 1})                               # (b)
    probe = torch.full((4,), 2.0, device=DEVICE)
    dist.all_reduce(probe)
    res["backend"] = dist.get_backend()
    want = "nccl" if DEVICE == "cuda" else "gloo"
    if res["backend"] != want or not bool((probe == 2.0).all()):
        raise AssertionError(f"(b) the one-rank mesh: backend "
                             f"{res['backend']}, all_reduce {probe.tolist()}")
    one, _, tunes_b = _glmm_chees_run(torch, mt, glmm, fg, chees, warm,
                                      "(b) one-rank NCCL mesh", mesh=mesh)
    dist.destroy_process_group()
    res["one_rank"] = {k: one[k] for k in ("sample_s", "kernel_launches",
                                           "leapfrog_steps")}
    # a one-rank mesh replays the run without one: chain rank 0 takes the
    # run's seed and an axis of size one takes no collective.  Phase 10 runs
    # longer, so the two share their warmup's first iterations (both adapt)
    shared = MESH_CHEES_RUN[1]
    same = tunes_b[:shared] == tunes_10[:shared]
    res["one_rank"]["tunes_equal_phase_10"] = same
    res["one_rank"]["iterations_compared"] = shared
    if not same:
        raise AssertionError("(b) the one-rank mesh's (eps, traj) path "
                             "differs from phase 10's")
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:      # (c)-(e)
        keys = ("beta", "z", "s2")
        np.savez(Path(tmp) / "warm.npz",
                 **{k: np.stack([np.asarray(w[k], np.float64) for w in warm])
                    for k in keys})
        t0 = time.perf_counter()
        run_ranks(lambda r, init: [sys.executable, str(Path(__file__).resolve()),
                                   "--mesh-rank", init, r, tmp],
                  2, timeout=MESH_RANKS_TIMEOUT)
        res["two_ranks_s"] = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
        draws = [np.load(Path(tmp) / f"draws{r}.npy") for r in range(2)]
        local_draws = [np.load(Path(tmp) / f"local_draws{r}.npy")
                       for r in range(2)]
        resolved_draws = {k: [np.load(Path(tmp) / f"{k}_draws{r}.npy")
                              for r in range(2)]
                          for k in ("glmm_w", "birats", "line_ss")}
        rats_draws = [np.load(Path(tmp) / f"rats_draws{r}.npy")
                      for r in range(2)]
        rats_chain_draws = [np.load(Path(tmp) / f"rats_chain_draws{r}.npy")
                            for r in range(2)]
        data_only_draws = [np.load(Path(tmp) / f"data_only_draws{r}.npy")
                           for r in range(2)]
        fixture_draws = {k: [np.load(Path(tmp) / f"fixture_{k}_draws{r}.npy")
                             for r in range(2)] for k in FIXTURES}
        graph_draws = {k: [np.load(Path(tmp) / f"graph_{k}_draws{r}.npy")
                           for r in range(2)] for k in MESH_GRAPH_ARMS}
        gathered_draws = {k: [np.load(Path(tmp) / f"{k}_draws{r}.npy")
                              for r in range(2)] for k in GATHERED_DRAWS}
        graph_sum0_draws = [np.load(Path(tmp) / f"graph_sum0_draws{r}.npy")
                            for r in range(2)]
        failed = []
        t0 = time.perf_counter()                                  # (f)
        res["restart"] = {
            "chain_mesh": _file_restart(torch, mt, glmm, fg, tmp, "chain_mesh",
                                        draws[0], failed),
            "local": _file_restart(torch, mt, glmm, fg, tmp, "local",
                                   local_draws[0], failed)}
        res["restart"]["wall_s"] = time.perf_counter() - t0
        res["restart"]["write_s"] = {
            "chain_mesh": [r["write_s"] for r in ranks],
            "local": [r["local"]["write_s"] for r in ranks]}
        t0 = time.perf_counter()                                  # (l)
        run_ranks(lambda r, init: [sys.executable, str(Path(__file__).resolve()),
                                   "--axes-rank", init, r, tmp],
                  AXES_RANKS, timeout=MESH_RANKS_TIMEOUT)
        res["four_ranks_s"] = time.perf_counter() - t0
        axes = [json.loads((Path(tmp) / f"axes{r}.json").read_text())
                for r in range(AXES_RANKS)]
        axes_draws = {k: [np.load(Path(tmp) / f"{k}_draws{r}.npy")
                          for r in range(AXES_RANKS)]
                      for k in ("axes_rats", "graph_rats_axes", "axes_glmm")}
    log("mesh (f), a sharded run's file restarted on one device: "
        + json.dumps(res["restart"]))
    iters, burnin = MESH_CHEES_RUN
    if not np.array_equal(draws[0], draws[1]) or draws[0].shape != (
            iters - burnin, 5, CHAINS):
        failed.append("(c) both ranks hold every chain's draws")
    if ranks[0]["tunes"] != ranks[1]["tunes"] or len(ranks[0]["tunes"]) != iters:
        failed.append("(c) (epsilon, traj) equal on both ranks")
    res["two_ranks"] = [{k: r[k] for k in ("sample_s", "kernel_launches",
                                            "leapfrog_steps", "draws_shape",
                                            "split")} for r in ranks]
    res["tunes_first_last"] = [ranks[0]["tunes"][0], ranks[0]["tunes"][-1]]
    local = [r["local"] for r in ranks]
    res["resolved"] = _resolved_gates([r["resolved"] for r in ranks],
                                      resolved_draws, failed)
    log("mesh (g), data-axis cases the compiler resolves: "
        + json.dumps(res["resolved"]))
    res["data_only"] = _data_only_gates([r["data_only"] for r in ranks],
                                        data_only_draws, fixture_draws, failed)
    log("mesh (j), the GLMM with only its data named and the fixtures: "
        + json.dumps(res["data_only"]))
    log("mesh (j), fused ChEES: " + json.dumps([{k: r[k] for k in (
        "sample_s", "leapfrog_steps", "wall_ms_per_gradient", "kernel_launches",
        "data_sum_shape", "data_sum_ms")} for r in res["data_only"]["chees"]]))
    res["launches"] = one["kernel_launches"] + sum(
        r["kernel_launches"] + r["local"]["kernel_launches"]
        + r["resolved"]["glmm_w"]["kernel_launches"]
        + r["data_only"]["chees"]["kernel_launches"] for r in ranks) + sum(
        res["restart"][k]["kernel_launches"] for k in ("chain_mesh", "local"))
    res["launches_j"] = sum(r["data_only"]["chees"]["kernel_launches"]
                            for r in ranks)
    res["graphs"] = _mesh_graphs_gates([r["graphs"] for r in ranks],
                                       graph_draws, failed)
    log("mesh (k), captured against plain on the data mesh: "
        + json.dumps(res["graphs"]))
    # the fused kernel inside (k)'s captured segments (its plain runs are
    # the comparison), through the segments' replays
    res["launches_k"] = sum(r["graphs"][k]["captured"]["kernel_launches"]
                            for r in ranks for k in ("glmm_chees_local",
                                                     "glmm_chees_data"))
    res["launches"] += res["launches_k"]
    res["gathered"] = _gathered_gates([r["gathered"] for r in ranks],
                                      gathered_draws, graph_sum0_draws, failed)
    log("mesh (m), named terms on gathered nodes, events cut, nested gathers "
        "and padded lengths: " + json.dumps(res["gathered"]))
    # the fused kernel in (m)'s ChEES run and its captured 3/2 run, each
    # rank over its 5,000 groups, through the segments' replays
    res["launches_m"] = sum(
        r["gathered"]["chees"]["kernel_launches"]
        + r["gathered"]["graphs"]["captured"]["kernel_launches"]
        for r in ranks)
    res["launches"] += res["launches_m"]
    if res["launches_m"] <= 0:
        failed.append("(m) the fused kernel's launches")
    if res["launches_k"] <= 0:
        failed.append("(k) the fused kernel's launches in captured segments")
    if res["launches_j"] <= 0:
        failed.append("(j) the fused kernel's launches")
    res["axes"] = _axes_gates(axes, axes_draws["axes_rats"],
                              axes_draws["graph_rats_axes"],
                              axes_draws["axes_glmm"], failed)
    res["axes"]["four_ranks_s"] = res["four_ranks_s"]
    # the fused kernel in (l)'s captured ChEES run, each rank over 2,500
    # groups, through the segments' replays
    res["launches_l"] = sum(r["glmm"]["chees"]["kernel_launches"] for r in axes)
    res["launches"] += res["launches_l"]
    if res["launches_l"] <= 0:
        failed.append("(l) the fused kernel's launches")
    log("mesh (l), several data axes on a (1, 2, 2) mesh: "
        + json.dumps(res["axes"]))
    res["rats"] = _rats_gates_h([r["rats"] for r in ranks], rats_draws, failed)
    log("mesh (h), rats NUTS on a (1, 2) data mesh: " + json.dumps(res["rats"]))
    res["rats_chains"] = _rats_chains_gates(rats_chain_draws, rats_draws_6,
                                            failed)
    res["rats_chains"]["sample_s"] = [r["rats_chains"]["sample_s"]
                                      for r in ranks]
    log("mesh (i), rats NUTS on a (2, 1) chain mesh against phase 6, chain "
        "by chain: " + json.dumps(res["rats_chains"]))
    res["local_views"] = _local_views_gates(local, local_draws, failed)
    res["local_views"]["density_ms"] = _rank_density_ms(torch, mt, glmm, warm)
    log("mesh (e): " + json.dumps(res["local_views"]))
    # the kernel at a rank's shares: C = 512 and G = 5,000 timed with their
    # bounds; 513 chains (1026 over two ranks), not a multiple of 4
    res["kernel"] = [kernel_case(torch, fg, glmm_cases, C=C, G=G,
                                 time_reps=20 if timed else 0)
                     for C, G, timed in ((512, 10_000, True),
                                         (1024, 5_000, True),
                                         (513, 5_000, False),
                                         (1024, MESH_G // AXES_RANKS, True))]
    log("mesh: " + json.dumps({k: v for k, v in res.items() if k != "kernel"}))
    for case in (res["kernel"][i] for i in (0, 1, 3)):
        log(f"mesh: kernel at C={case['C']}, G={case['G']}: {case['ms']:.4f} ms, "
            f"bound {case['bound']['bound_ms']:.4f} ms "
            f"({case['pct_of_bound']:.1f}%), plain {case['plain_ms']:.3f} ms")
    if failed:
        raise AssertionError(f"mesh: gates failed: {failed}")
    return res


def _file_restart(torch, mt, glmm, fg, tmp, label, draws, failed):
    """(f): the chain file that both ranks of (c) or (e) wrote
    (``label``), read on the card and run ``POST_RESTART`` more iterations
    on one device, against the one-device restart from the same whole
    state built here from the ranks' own (the chains of (c)'s two ranks
    joined; (e)'s sampled sites, whole on each data rank, from rank 0)
    with rank 0's tunes and every chain's key.  Appends what fails to
    ``failed``."""
    from mamba_tpu_torch.output.chains import ModelChains
    model, inputs, inits, _ = glmm.build(MESH_G, fused=True)
    model = _chees_block(mt, model, max_steps=256, mass_window=40)
    t0 = time.perf_counter()
    mc = mt.read_chains(str(Path(tmp) / f"{label}.pkl"), model, inputs,
                        device=DEVICE)
    out = {"read_s": time.perf_counter() - t0}
    state = mc.states["state"]
    y = torch.as_tensor(inits[0]["y"], dtype=state["y"].dtype, device=DEVICE)
    out["y_is_the_data"] = bool((state["y"] == y).all())
    out["z_shape"] = list(state["z"].shape)
    out["draws_equal"] = bool(np.array_equal(mc.value, draws))
    # the sites and keys come back on the card; a chain mesh's ranks hold
    # their chains' keys, a data mesh's ranks the same keys
    own = [torch.load(Path(tmp) / f"{label}_rank{r}.pt", weights_only=False)
           for r in range(2)]
    whole = {"y": y.expand(CHAINS, *y.shape).contiguous()}
    for k in ("beta", "z", "s2"):
        whole[k] = (torch.cat([o["state"][k] for o in own])
                    if label == "chain_mesh" else own[0]["state"][k])
    keys = (torch.cat([o["key"] for o in own]) if label == "chain_mesh"
            else own[0]["key"])
    tunes = own[0]["tunes"]
    if own[0]["index"] is not None:
        # (e)'s data ranks hold z's slices and their coordinates' tunes
        whole["z"] = torch.cat([o["state"]["z"] for o in own], 1)
        tunes = _joined_tunes(torch, own)
    cm = mt.compile_model(model, inputs, inits[0], device=DEVICE)
    memory = ModelChains(draws, start=mc.start, thin=mc.thin, names=mc.names,
                         chains=mc.chains, model=model, compiled=cm,
                         states={"state": whole, "tunes": tunes,
                                 "key": keys,
                                 "burnin": own[0]["burnin"]}, iter=mc.iter)
    fg.glmm_loglik_grads.launches = 0
    t0 = time.perf_counter()
    more = mt.mcmc(mc, POST_RESTART, verbose=False)
    out["restart_s"] = time.perf_counter() - t0
    out["kernel_launches"] = fg.glmm_loglik_grads.launches
    want = mt.mcmc(memory, POST_RESTART, verbose=False)
    rng = more.range
    out["bit_identical"] = bool(np.array_equal(more.value, want.value))
    out["contiguous"] = bool(np.array_equal(rng, want.range)
                             and np.all(np.diff(rng) == mc.thin)
                             and rng[mc.niter] == mc.iter + mc.thin)
    out["finite"] = bool(np.isfinite(more.value).all())
    for k in ("y_is_the_data", "draws_equal", "bit_identical", "contiguous",
              "finite"):
        if not out[k]:
            failed.append(f"(f) {label}: {k}")
    if out["z_shape"] != [CHAINS, MESH_G] or out["kernel_launches"] == 0:
        failed.append(f"(f) {label}: z {out['z_shape']}, "
                      f"{out['kernel_launches']} launches")
    return out


def _resolved_gates(resolved, draws, failed):
    """(g)'s gates on both ranks' results (``_resolved_cases``): finite
    draws, equal on both ranks; (i)'s density and gradient against the
    whole with one launch per call over the rank's G/2 groups; (ii)'s and
    (iii)'s density and monitored rows at the inits against the unsharded
    model.  Appends what fails to ``failed``."""
    for k, (a, b) in draws.items():
        if not (np.array_equal(a, b) and np.isfinite(a).all()):
            failed.append(f"(g) {k}: finite draws, equal on both ranks")
    for r, res in enumerate(resolved):
        d = res["glmm_w"]["density"]
        if not (d["lp_rel_err"] <= LP_RTOL and d["grad_rel_err"] <= GRAD_RTOL
                and d["launches_split"] == 1
                and d["groups_split"] == MESH_G // 2
                and d["held"] == ["z"] and d["part_sites"] == []):
            failed.append(f"(g)(i) rank {r}: {d}")
        for k in ("birats", "line_ss"):
            if not (res[k]["lp_rel_err"] <= LP_RTOL
                    and res[k]["rows_rel_err"] <= LP_RTOL):
                failed.append(f"(g) {k} rank {r}: {res[k]}")
    if resolved[0]["line_ss"]["mixed"] != ["ss"]:
        failed.append(f"(g)(iii) mixed nodes {resolved[0]['line_ss']['mixed']}")
    return {"glmm_w": [r["glmm_w"] for r in resolved],
            "birats": [r["birats"] for r in resolved],
            "line_ss": [r["line_ss"] for r in resolved],
            "wall_s": [r["wall_s"] for r in resolved]}


#: (k)'s arms (``_mesh_graph_arms``)
MESH_GRAPH_ARMS = ("rats_nuts", "glmm_chees_local", "glmm_chees_data")


def _mesh_graphs_gates(graph_res, draws, failed):
    """(k)'s gates on both ranks' results (``_mesh_graphs``, which raised
    on a captured run that differs from its plain loops already): each
    arm's captured draws finite and equal on both ranks.  Returns each
    arm's numbers, rank by rank."""
    out = {}
    for name in MESH_GRAPH_ARMS:
        a, b = draws[name]
        if not (np.array_equal(a, b) and np.isfinite(a).all()):
            failed.append(f"(k) {name}: finite draws, equal on both ranks")
        out[name] = [r[name] for r in graph_res]
    out["wall_s"] = [r["wall_s"] for r in graph_res]
    return out


def _rats_gates_h(rats_res, draws, failed):
    """(h)'s gates on both ranks' results (``_rats_data_mesh``, which
    raised on the mu_beta gate already): finite draws, equal on both
    ranks, of the run's shape; each rank holding 15 rats of y, alpha and
    beta.  Appends what fails to ``failed``."""
    iters, burnin = RATS_DATA_MESH_RUN
    if not (np.array_equal(draws[0], draws[1]) and np.isfinite(draws[0]).all()
            and draws[0].shape[0] == iters - burnin
            and draws[0].shape[2] == CHAINS):
        failed.append("(h) finite draws, equal on both ranks")
    for r, res in enumerate(rats_res):
        if (res["shapes"] != {"y": [CHAINS, 15, 5], "alpha": [CHAINS, 15],
                              "beta": [CHAINS, 15]}
                or res["held"] != ["alpha", "beta"]):
            failed.append(f"(h) rank {r}: holds {res['shapes']}, "
                          f"held {res['held']}")
    keys = ("sample_s", "wall_s", "leapfrog_steps", "mean_tree_depth",
            "max_tree_depth", "wall_ms_per_leapfrog", "peak_rise_bytes",
            "mu_beta_mean", "rhat_rank_max", "ess_bulk_min")
    return {k: [res[k] for res in rats_res] for k in keys} | {
        "shapes": rats_res[0]["shapes"]}


def _direct_logpdf(sim, chain, draw):
    """``compiled.logpdf`` at stored draw ``draw`` of chain ``chain``, the
    state rebuilt by hand: the chain's final state with every stored
    stochastic site's columns (column-major, Julia ``vec``) put back."""
    cm = sim.compiled
    state = {k: v[chain] for k, v in sim.states["state"].items()}
    for n in cm.stochastic:
        cols = [i for i, lbl in enumerate(sim.names)
                if lbl == n or lbl.startswith(n + "[")]
        if not cols:
            continue
        shape = cm.sites[n].shape
        vals = sim.value[draw, cols, chain].reshape(shape, order="F")
        state[n] = cm.tensor(np.ascontiguousarray(vals))
    return float(cm.logpdf(state))


def _restart_check(mt, sim, build, tmpdir, label):
    """write_chains -> read_chains on the card -> ``POST_RESTART`` more
    iterations, against the same restart from the chains in memory."""
    path = os.path.join(tmpdir, f"{label}.pkl")
    mt.write_chains(path, sim)
    model, inputs, _ = build()
    mc = mt.read_chains(path, model, inputs, device=DEVICE)
    from_file = mt.mcmc(mc, POST_RESTART, verbose=False)
    from_memory = mt.mcmc(sim, POST_RESTART, verbose=False)
    rng = from_file.range
    return {"bit_identical": bool(np.array_equal(from_file.value, from_memory.value)
                                  and np.array_equal(rng, from_memory.range)),
            "contiguous": bool(rng[sim.niter] == sim.iter + sim.thin
                               and np.all(np.diff(rng) == sim.thin)
                               and np.array_equal(from_file.value[:sim.niter],
                                                  sim.value)),
            "iter": from_file.iter}


def post_run(torch, mt, name, sim, tmpdir):
    """The output layer on one zoo run's 1024 chains; raises on failure."""
    import importlib
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    t0 = time.perf_counter()
    g = mt.gelmandiag(sim, mpsrf=True, transform=True)
    d = mt.dic(sim)
    lp = mt.logpdf_chains(sim)
    rng = np.random.default_rng(0)
    picks = [(int(rng.integers(sim.nchains)), int(rng.integers(sim.niter)))
             for _ in range(POST_DIRECT_DRAWS)]
    direct = np.array([_direct_logpdf(sim, c, i) for c, i in picks])
    stored = np.array([lp.value[i, 0, c] for c, i in picks])
    pr = mt.predict(sim, seed=3)
    cm = sim.compiled
    (data,) = sim.model.keys("observed")
    # the predictive draw of each chain's last stored draw, at that draw's
    # own parameters (the chain's final state): finite density = support
    last = {k: v.clone() for k, v in sim.states["state"].items()}
    shape = cm.sites[data].shape
    ys = np.stack([pr.value[-1, :, c].reshape(shape, order="F")
                   for c in range(sim.nchains)])
    last[data] = cm.tensor(ys)
    lp_pred = torch.func.vmap(lambda st: cm.logpdf(st, (data,)))(last)
    restart = _restart_check(mt, sim, mod.build, tmpdir, name)
    files = mt.draw(mt.plot(sim[:, sim.names[:4], list(range(POST_DIAG_CHAINS))]),
                    fmt="svg", filename=os.path.join(tmpdir, name), nrow=2, ncol=2)
    res = {"model": name, "draws": list(sim.value.shape),
           "psrf_max": float(np.nanmax(g.value[:-1, 0, 0])),
           "mpsrf": float(g.value[-1, 0, 0]),
           "dic": d.value[:, 0, 0].tolist(), "pD": float(d.value[0, 1, 0]),
           "pV": float(d.value[1, 1, 0]),
           "logpdf_direct_rel_err": float(np.max(np.abs(stored - direct)
                                                 / np.abs(direct))),
           "predict_shape": list(pr.value.shape),
           "predict_finite": bool(np.isfinite(pr.value).all()),
           "predict_in_support": bool(torch.isfinite(lp_pred).all()),
           "restart": restart, "svg_files": len(files),
           "svg_bytes": sum(os.path.getsize(f) for f in files),
           "wall_s": time.perf_counter() - t0}
    log(f"post {name}: " + json.dumps(res))
    failed = []
    if g.value.shape[0] != sim.nparams + 1 or not np.isfinite(g.value[:-1, 0, 0]).all():
        failed.append("gelmandiag")
    if not (np.isfinite(d.value).all() and res["pD"] > 0):
        failed.append("dic finite with pD > 0")
    if not res["logpdf_direct_rel_err"] <= POST_DIRECT_RTOL:
        failed.append("logpdf_chains against compiled.logpdf")
    if not (res["predict_finite"] and res["predict_in_support"]):
        failed.append("predict inside the support")
    if not (restart["bit_identical"] and restart["contiguous"]):
        failed.append("restart from the file")
    if not (files and all(os.path.getsize(f) > 0 for f in files)):
        failed.append("plot and draw")
    if failed:
        raise AssertionError(f"post {name}: gates failed: {failed}: {res}")
    return res


def _post_fused(torch, mt, glmm, fg, sim):
    """logpdf_chains and dic of the fused recovery run, through the kernel's
    vmap rule over chains x draws, against the same draws on the generic
    build."""
    from mamba_tpu_torch.utils import convert
    fg.glmm_loglik_grads.launches = 0
    lp, d = mt.logpdf_chains(sim), mt.dic(sim)
    launches = fg.glmm_loglik_grads.launches
    model, inputs, _, _ = glmm.build(G=64, n=10, seed=2, fused=False,
                                     mass_window=50)
    model = _monitor(model, "z")
    state = {k: v.cpu().numpy() for k, v in sim.states["state"].items()}
    state["y"] = np.swapaxes(state["y"], 1, 2)      # (n, G) -> (G, n)
    plain = convert.model_chains(sim.value, model, inputs, state,
                                 start=sim.start, thin=sim.thin, names=sim.names,
                                 chains=sim.chains, iter=sim.iter, device=DEVICE)
    lp_g, d_g = mt.logpdf_chains(plain), mt.dic(plain)
    res = {"kernel_launches": launches,
           "logpdf_rel_err": float(np.max(np.abs(lp.value - lp_g.value)
                                          / np.abs(lp_g.value))),
           "dic_rel_err": float(np.max(np.abs(d.value - d_g.value)
                                       / np.abs(d_g.value))),
           "dic": d.value[:, :, 0].tolist()}
    log("post GLMM recovery run, fused against generic: " + json.dumps(res))
    if launches < 1 or not (res["logpdf_rel_err"] <= POST_FUSED_RTOL
                            and res["dic_rel_err"] <= POST_FUSED_RTOL):
        raise AssertionError(f"post: fused modelstats disagree: {res}")
    return res


def phase_post(torch, mt, glmm, fg, zoo_sims, rats_chees_sim, recovery_sim):
    """The output layer on chains the earlier phases made: ``POST_ZOO``'s
    1024-chain runs, the rats ChEES chains and the GLMM recovery run."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmpdir:
        out = {name: post_run(torch, mt, name, zoo_sims[name], tmpdir)
               for name in POST_ZOO}
    c = rats_chees_sim[:, :, list(range(POST_DIAG_CHAINS))]
    tables = {"geweke": mt.gewekediag(c), "heidel": mt.heideldiag(c),
              # the default q = 0.025, r = 0.005 need 3,746 draws
              "raftery": mt.rafterydiag(c, q=0.5, r=0.05)}
    out["rats_chees"] = {k: {"shape": list(t.value.shape),
                             "finite": bool(np.isfinite(t.value[:, :2, :]).all())}
                         for k, t in tables.items()}
    log("post rats ChEES diagnostics (first 8 chains): "
        + json.dumps(out["rats_chees"]))
    if not all(v["finite"] and v["shape"][2] == POST_DIAG_CHAINS
               for v in out["rats_chees"].values()):
        raise AssertionError(f"post: rats ChEES diagnostics: {out['rats_chees']}")
    out["glmm_fused"] = _post_fused(torch, mt, glmm, fg, recovery_sim)
    return out


def _logpdf_at_inits(mt, model, inputs, init):
    cm = mt.compile_model(model, inputs, init, device=DEVICE)
    state = {n: cm.tensor(np.broadcast_to(np.asarray(init[n], dtype=np.float64),
                                          cm.sites[n].shape))
             for n in cm.stochastic}
    return float(cm.logpdf(state))


def phase_map(torch, mt, glmm, fg):
    """MAP by L-BFGS on the full-width GLMM through the kernel, against the
    truth and the generic build; a warm start of line from its MAP."""
    from mamba_tpu_torch.models import line
    t0 = time.perf_counter()
    model, inputs, inits, truth = glmm.build(G=10_000, fused=True)
    lp0 = _logpdf_at_inits(mt, model, inputs, inits[0])
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fg.glmm_loglik_grads.launches = 0          # count this path only
    r = mt.optim_over(model, inputs, inits[0], device=DEVICE)
    torch.cuda.synchronize()
    launches = fg.glmm_loglik_grads.launches
    map_s = time.perf_counter() - t0
    model_g, inputs_g, inits_g, _ = glmm.build(G=10_000, fused=False)
    t0 = time.perf_counter()
    r_g = mt.optim_over(model_g, inputs_g, inits_g[0], device=DEVICE,
                        dtype=torch.float64)
    generic_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lmodel, linputs, linits = line.build()
    r_line = mt.optim_over(lmodel, linputs, linits[0], device=DEVICE)
    warm = mt.mcmc(lmodel, linputs, [r_line.as_inits({"y": linits[0]["y"]})], 20,
                   chains=4, verbose=False, device=DEVICE)
    res = {"beta": r.params["beta"].tolist(), "truth": truth["beta"].tolist(),
           "beta_err": float(np.abs(r.params["beta"] - truth["beta"]).max()),
           "s2": float(r.params["s2"]), "logpdf": r.logpdf,
           "logpdf_inits": lp0, "converged": r.converged, "niter": r.niter,
           "map_s": map_s, "kernel_launches": launches,
           "generic_beta": r_g.params["beta"].tolist(),
           "fused_vs_generic": float(np.abs(r.params["beta"]
                                            - r_g.params["beta"]).max()),
           "generic_niter": r_g.niter, "generic_s": generic_s,
           "line_beta": r_line.params["beta"].tolist(),
           "warm_start_finite": bool(np.isfinite(warm.value).all()),
           "setup_s": setup_s, "line_s": time.perf_counter() - t0}
    log("map (G=10000, fused float32 against generic float64, lbfgs): "
        + json.dumps(res))
    failed = []
    if launches < 1:
        failed.append("the kernel ran")
    if not res["beta_err"] < MAP_BETA_TOL:
        failed.append("beta against the truth")
    if not r.logpdf >= lp0:
        failed.append("logpdf at the optimum >= at the inits")
    if not res["fused_vs_generic"] < MAP_FUSED_TOL:
        failed.append("fused against generic")
    if not res["warm_start_finite"]:
        failed.append("warm start")
    if failed:
        raise AssertionError(f"map: gates failed: {failed}: {res}")
    return res


def _conjugate_model(mt):
    """tests/test_infer.py's conjugate normal model: (model, y, exact
    posterior mean, sd, log-evidence)."""
    from scipy import stats
    y = np.array([1.1, 0.7, 1.4, 0.9, 1.2, 1.0, 0.8, 1.3])
    model = mt.Model(
        y=mt.Stochastic(1, lambda mu: mt.Normal(mu.expand(8), 1.0),
                        monitor=False),
        mu=mt.Stochastic(lambda: mt.Normal(0.0, np.sqrt(2.0))))
    model.set_samplers([mt.NUTS("mu")])
    v = 1 / (8 + 0.5)
    S = np.eye(8) + 2.0 * np.ones((8, 8))
    return (model, y, v * y.sum(), np.sqrt(v),
            float(stats.multivariate_normal(np.zeros(8), S).logpdf(y)))


def phase_smc(torch, mt, glmm, fg):
    """SMC under the gates of tests/test_infer.py, and on the G = 64 GLMM
    through the kernel's vmap rule over the particles."""
    from mamba_tpu_torch.models import line
    model, y, m_exact, sd_exact, logz = _conjugate_model(mt)
    r = mt.smc(model, {}, {"y": y, "mu": 0.0}, n_particles=SMC_PARTICLES,
               seed=2, device=DEVICE)
    mu = r.particles["mu"]
    conj = {"mean_err": float(abs(mu.mean() - m_exact)),
            "sd_err": float(abs(mu.std() - sd_exact)),
            "log_evidence_err": abs(r.log_evidence - logz), "stages": r.n_stages}
    lmodel, linputs, linits = line.build()
    r = mt.smc(lmodel, linputs, linits[0], n_particles=SMC_PARTICLES,
               rejuvenation_steps=50, seed=3, device=DEVICE)
    b = r.particles["beta"].mean(0)
    line_res = {"beta": b.tolist(), "stages": r.n_stages}
    gmodel, ginputs, ginits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                                mass_window=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fg.glmm_loglik_grads.launches = 0          # count this path only
    r = mt.smc(gmodel, ginputs, ginits[0], n_particles=SMC_GLMM_PARTICLES,
               rejuvenation_steps=SMC_GLMM_STEPS, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    launches = fg.glmm_loglik_grads.launches
    gb = r.particles["beta"].mean(0)
    glmm_res = {"beta": gb.tolist(), "beta_err": float(np.abs(gb - truth["beta"]).max()),
                "log_evidence": r.log_evidence, "stages": r.n_stages,
                "kernel_launches": launches, "smc_s": time.perf_counter() - t0}
    res = {"conjugate": conj, "line": line_res, "glmm": glmm_res}
    log(f"smc ({SMC_PARTICLES} particles; GLMM G=64, {SMC_GLMM_PARTICLES}): "
        + json.dumps(res))
    failed = []
    if not (conj["mean_err"] < 0.03 and conj["sd_err"] < 0.04
            and conj["log_evidence_err"] < 0.3 and conj["stages"] <= 5):
        failed.append("conjugate")
    if not (abs(b[0] - 0.60) < 0.35 and abs(b[1] - 0.80) < 0.12
            and 1 <= line_res["stages"] <= 30):
        failed.append("line")
    if launches < 1:
        failed.append("the kernel ran")
    if not (glmm_res["beta_err"] < SMC_BETA_TOL and np.isfinite(r.log_evidence)):
        failed.append("GLMM beta")
    if failed:
        raise AssertionError(f"smc: gates failed: {failed}: {res}")
    return res


def phase_profile(torch, fg, glmm_cases, kernel_ms, rats_sim):
    """One torch.profiler trace (a process's later traces may see no device
    activity once CUDA graphs have been replayed under an earlier one): of
    full-width gradients, which must name the kernel, and of
    ``BUSY_ITERS`` iterations that continue phase 6's rats NUTS run, whose
    device busy share it reports; time_compiled against phase 3's CUDA
    events; the card's peaks and the kernel's bound read from
    utils/roofline.py."""
    import tempfile
    from mamba_tpu_torch.utils import profiling, roofline
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                 for a in glmm_cases.random_inputs(4, 10, 10_000, 1024, 0))
    fg.glmm_loglik_grads(*args)
    rats_iterations = _continuation(torch, rats_sim)
    with tempfile.TemporaryDirectory() as tmpdir:
        with profiling.trace(tmpdir) as path:
            for _ in range(PROFILE_GRADIENTS):
                with profiling.annotate("glmm_gradient"):
                    fg.glmm_loglik_grads(*args)
            torch.cuda.synchronize()
            with profiling.annotate("rats_nuts_iterations"):
                rats_iterations(BUSY_ITERS)
                torch.cuda.synchronize()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    busy = {"iterations": BUSY_ITERS,
            **_busy_share(events, "rats_nuts_iterations")}
    log("rats NUTS, device busy share over traced iterations: "
        + json.dumps(busy))
    s = profiling.time_compiled(fg.glmm_loglik_grads, *args, iters=20)
    work = fg.glmm_work(4, 10, 10_000, 1024)
    roof = roofline.roofline(fg.glmm_loglik_grads, *args, flops=work["flops"],
                             bytes=work["bytes"])
    ceiling = roofline.elementwise_ceiling()
    _, clock_max = sm_clocks_mhz()
    name = torch.cuda.get_device_name(0)
    peaks = roofline.device_peaks()
    want = roofline.peaks_for(name)
    bound = fg.glmm_bound_ms(4, 10, 10_000, 1024, 1e6 * clock_max)
    res = {"trace_kernels": kernels, "rats_busy": busy,
           "trace_spans": sum(e.get("name") == "glmm_gradient" for e in events),
           "time_compiled_ms": 1e3 * s, "phase3_ms": kernel_ms,
           "roofline": roof, "elementwise_ceiling": ceiling,
           "device_peaks": list(peaks), "bound_ms": bound["bound_ms"],
           "sm_clock_max_mhz": clock_max}
    log("profile: " + json.dumps(res))
    failed = []
    if not any("glmm_reg_kernel" in k for k in kernels):
        failed.append("the trace names glmm_reg_kernel")
    if not busy["device_events"] > 0:
        failed.append("the trace holds the rats iterations' device work")
    if not abs(1e3 * s - kernel_ms) <= PROFILE_TIME_RTOL * kernel_ms:
        failed.append("time_compiled against phase 3")
    if "H100" not in name or want is None or peaks != (want.fp32_flops,
                                                       want.bytes_per_s):
        failed.append("device_peaks")
    if round(bound["bound_ms"], 4) != 0.0642:
        failed.append("glmm_bound_ms")
    if roof["bound"] == "unknown" or not ceiling["gbytes_s"] > 0:
        failed.append("roofline and the elementwise ceiling")
    if failed:
        raise AssertionError(f"profile: gates failed: {failed}: {res}")
    return res


def _threefry_line(res, launches):
    """The threefry kernel's entry of the ``kernels`` line: timed at the
    GLMM ChEES momentum draw as ChEES makes it (1024 x 10,005 float32
    normals, folded with 0), the rats NUTS one beside it; ``library_ms`` is
    ``torch.randn`` of the same shape."""
    full = res["timed"]["glmm_chees_momentum"]
    return {
        "name": "threefry_draw", "route": "cuda",
        "source": "mamba_tpu_torch/csrc/threefry.cu",
        "replaces": "none: XLA fuses jax.random's threefry into the TPU "
                    "programs (keys at mamba_tpu/model/mcmc.py:428)",
        "launches": launches,
        "max_abs_err": full["max_abs_err"],
        "normal_ulps": res["normal_ulps"],
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["randn_ms"],
        "rats_nuts_momentum": res["timed"]["rats_nuts_momentum"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm, rats
    from mamba_tpu_torch.ops import fused_glmm as fg
    from mamba_tpu_torch.ops import random as rnd
    from mamba_tpu_torch.samplers import chees, nuts
    from mamba_tpu_torch.scripts import glmm_cases
    from mamba_tpu_torch.utils import graphs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    walls = {}
    #: threefry launches of each main-path phase: the count is set to 0
    #: just before the phase and read just after (phase 3b's comparisons
    #: come before and are not counted)
    draws = {}

    def timed(name, fn, *args, path=False):
        rnd.threefry_draw.launches = 0
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        if path:
            draws[name] = rnd.threefry_draw.launches
        log(f"phase {name}: {walls[name]:.1f} s")
        return out

    card = phase_device(torch)
    timed("build", phase_build, fg, rnd)
    cases = timed("kernel", phase_kernels, torch, fg, glmm_cases)
    threefry = timed("threefry", phase_threefry, torch, rnd)
    graph_res = timed("graphs", phase_graphs, torch, mt, rats, glmm, fg,
                      nuts, chees, path=True)
    recovery_sim = timed("glmm_recovery", phase_recovery, mt, glmm, path=True)
    glmm_nuts = timed("glmm_nuts", phase_glmm_nuts, torch, mt, glmm, fg, nuts,
                      path=True)
    rats_nuts, rats_nuts_sim = timed("rats_nuts", phase_rats_nuts, torch, mt,
                                     rats, nuts, path=True)
    rats_chees, rats_chees_sim = timed("rats_chees", phase_rats_chees, torch,
                                       mt, rats, chees, path=True)
    _, zoo_sims = timed("zoo", phase_zoo, torch, mt, path=True)
    _, zoo_mv_sims = timed("zoo_mv", phase_zoo_mv, torch, mt, path=True)
    glmm_chees, glmm_warm, glmm_tunes = timed(
        "glmm_chees", phase_glmm_chees, torch, mt, glmm, fg, chees, path=True)
    mesh_res = timed("mesh", phase_mesh, torch, mt, glmm, fg, chees,
                     glmm_cases, glmm_warm, glmm_tunes, rats_nuts_sim.value,
                     path=True)
    del glmm_warm
    timed("post", phase_post, torch, mt, glmm, fg, {**zoo_sims, **zoo_mv_sims},
          rats_chees_sim, recovery_sim, path=True)
    del zoo_sims, zoo_mv_sims, rats_chees_sim, recovery_sim
    map_res = timed("map", phase_map, torch, mt, glmm, fg)
    smc_res = timed("smc", phase_smc, torch, mt, glmm, fg, path=True)
    profile = timed("profile", phase_profile, torch, fg, glmm_cases,
                    cases[0]["ms"], rats_nuts_sim, path=True)
    log(f"threefry launches on the main paths (graph replays counted): "
        f"{json.dumps(draws)}")
    idle = [k for k, v in draws.items() if v == 0]
    if idle:
        raise AssertionError(f"the threefry kernel was not launched in {idle}")
    launches = {"graphs": graph_res["glmm_chees"]["launches_graphed"]
                + graph_res["glmm_centered"]["launches_graphed"],
                "glmm_nuts": glmm_nuts["kernel_launches"],
                "glmm_chees": glmm_chees["kernel_launches"],
                "map": map_res["kernel_launches"],
                "smc": smc_res["glmm"]["kernel_launches"],
                "mesh": mesh_res["launches"]}
    arms = {"glmm_nuts": glmm_nuts, "rats_nuts": rats_nuts,
            "rats_chees": rats_chees, "glmm_chees": glmm_chees}
    log(f"fused kernel launches on the main paths (graph replays counted): "
        f"{json.dumps(launches)}")
    log("gradient arms, wall ms per leapfrog: " + json.dumps(
        {k: v["wall_ms_per_leapfrog"] for k, v in arms.items()}))
    log("CUDA graphs: " + json.dumps(
        {**{k: {"graphs": v["graphs"], "capture_s": v["capture_s"]}
            for k, v in arms.items()}, "process": graphs.STATS}))
    log("rats NUTS (cut): " + json.dumps(
        {k: rats_nuts[k] for k in ("sample_s", "leapfrog_steps",
                                   "wall_ms_per_leapfrog", "ess_per_s_total",
                                   "ess_per_s_min", "rhat_rank_max",
                                   "ess_bulk_min", "mu_beta_mean")}
        | {"device_busy_share": profile["rats_busy"]["device_busy_share"]}))
    log(f"new phases (post, map, smc, profile): "
        f"{sum(walls[k] for k in ('post', 'map', 'smc', 'profile')):.1f} s")
    log(f"phase walls (s): {json.dumps(walls)}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log("mesh (e), local views: " + json.dumps(mesh_res["local_views"]))
    log("mesh (h), rats NUTS on a data mesh: " + json.dumps(mesh_res["rats"]))
    slice_case = cases[0]
    bound = slice_case["bound"]
    log(f"card: {card}")
    # no single PyTorch call computes lp, grad_beta and grad_b together, so
    # there is no library time.  bound_by says whether bytes or operations
    # set the bound; bound_floor names the floor: "memory", "fp32" or "sfu"
    print(json.dumps({"kernels": [{
        "name": "fused_glmm_loglik_grads", "route": "cuda",
        "source": "mamba_tpu_torch/csrc/fused_glmm.cu",
        "replaces": "mamba_tpu/ops/fused_glmm.py:59",
        "launches": sum(launches.values()),
        "max_abs_err": slice_case["grad_max_abs_err"],
        "lp_rel_err": slice_case["lp_rel_err"],
        "grad_rel_err": slice_case["grad_rel_err"],
        "ms": slice_case["ms"], "plain_ms": slice_case["plain_ms"],
        "bound_ms": bound["bound_ms"],
        "bound_by": "bytes" if bound["bound_by"] == "memory" else "operations",
        "bound_floor": bound["bound_by"],
        "floors_ms": {k[:-3]: v for k, v in bound.items() if k.endswith("_ms")
                      and k != "bound_ms"},
        "pct_of_bound": slice_case["pct_of_bound"],
        "library_ms": None,
        # a data rank's launch at 1024 chains over its share of the groups:
        # (e)/(j)'s 5,000 of two ranks, (l)'s 2,500 of four
        "rank_ms": {str(c["G"]): c["ms"] for c in mesh_res["kernel"]
                    if c["C"] == CHAINS and "ms" in c},
        "rank_bound_ms": {str(c["G"]): c["bound"]["bound_ms"]
                          for c in mesh_res["kernel"]
                          if c["C"] == CHAINS and "ms" in c},
        "launches_l": mesh_res["launches_l"],
        "launches_m": mesh_res["launches_m"]},
        _threefry_line(threefry, sum(draws.values()))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--axes-rank"]:
        axes_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
