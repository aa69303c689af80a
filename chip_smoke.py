#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py

Phases, one progress line each (``# phase ...``, with wall seconds), in
the order 1-5, 20, 6-8, 10-16, 18, 19, 21, 17; a phase's larger sub-steps
print their seconds too (``#   step ...``), to see where the run's time
goes. The run must end within BUDGET_S: a phase that outgrows it is cut
in depth, never given more time, and each cut is written below where its
phase is ("cut in depth: X, not Y", with why the check still holds).

Launches. On one card the large-N entry points run each episode's steps
as the episode program's CUDA graph (``parallel/large_n.py``), whose
replay calls no kernel wrapper: the wrappers' counters count the eager
launches and those a capture records. So the runs whose launches the
``kernels`` line reports or that hold the graph to its count (phases 4,
13 (b) at N = 32,768, 16 (b), 18 (b) and 20) go under torch.profiler, and their launches
are the kernels the device ran, read from the trace's kernel names
(``cells_cuda.device_launches``, which checks that the trace is whole):
per K = 3 episode K1 201 times and K2 and K3 200 times each, plus, for
each program captured in the run, its warm-up's WARMUP_STEPS = 2 steps
on scratch copies. The other counted runs (phases 10-12, 13 (a) and (b)
at N = 4,096, 19 (c)) check the counters: per episode the reset's K1,
and per capture its warm-up and its 200 recorded steps (the captures
are counted).

Graph against eager. Where a phase below prints ms, busy ms, idle share
and device ops per step "of each loop" (phases 14 (d), 16, 18, 19, 20,
21), the eager loop's ms is the wall of an eager run the phase made
anyway (its twin's episode, round or Adam updates), and its busy ms,
idle share and device ops read "not measured" (tracing an eager loop of
~10^5 launches took up to 14 s of the run; PERF.md section 5 has the
eager loops' traces). The graph's come from one run under the profiler
(its ms under it): a run the phase made anyway where one was traced
(phase 14's profiled episode), TRACE_UPDATES replays of an Adam update
program, or a short episode; where the phase traced a replay for its
launches (phases 16 (b) and 20), that replay's ms alone, the rest "not
measured". Cut in depth: one more episode or round of updates of each
loop, run only to time it (13 of them, ~25 s of the run).

1. device: fails without ``torch.cuda.is_available()``; prints nvidia-smi's
   name and power limit and ``torch.cuda.get_device_name(0)``;
2. build: the one ``nvcc`` call of ``ops/_build.py``, with its seconds and
   the ``-Xptxas -v`` register and shared-memory lines, run in a thread;
   beside it, in the main thread, the profiler's start-up (a device-only
   window around one small operation: CUPTI's first start, 8-12 s on the
   H100, which the first traced window, phase 4's, paid before), with its
   seconds;
3. kernels: a lattice reset at N = 32,768 and 3 policy steps (so the
   history and the delayed graphs are non-trivial), then each kernel at
   this slice's shapes against its plain PyTorch version on the card
   (tolerance 1e-5 of each channel's largest magnitude: same arithmetic,
   other summation order; degrees and min r^2 exact), and against the
   O(N²) blocked oracle at N = 4,096 and on a dense swarm whose tiles need
   several shared-memory chunks and block passes, there also K2 at 18
   columns and K3 at 12 on a row-strided view, K = 4's widths, which
   ``csrc/cells.cu`` sweeps with ops of their own (tolerance 1e-4: the
   oracle sums through float32 matrix products); the grid build under
   CUDA's sync debug mode, which raises on any host synchronisation; then
   each kernel timed with CUDA events over 50 launches beside its plain
   version and a launch floor (an empty sleep kernel timed the same way),
   and all three at several tile widths. K3 runs on the main path's own
   inputs: the historical positions, grid and degrees, and the columns as
   the row-strided view of the pre-applied output that the delayed stack
   passes;
4. episode: one greedy 200-step N = 32,768 K = 3 episode through the
   port's evaluate entry point with the in-repo n32k checkpoint, counted.
   Its steps run as the entry point's default, the episode program's CUDA
   graph, captured in this episode (the cached programs are dropped
   before it). The device must run K1 203 times and K2 and K3 202 times
   each (the reset, the warm-up and the replay), the wrappers' calls (the
   reset, the warm-up and the recorded steps) must equal them, overflow
   0, and the reward land within -458.8 +- 15 (the JAX package's
   10-episode eval of this checkpoint at this N is -458.8 +- 2.0,
   RESULTS.md section 8);
5. trace: TRACE_STEPS steady steps of the same rollout as the eager loop,
   timed by the host clock, then again under torch.profiler with each
   layer of the step annotated: the top 10 device operations, device
   operations per step, device-busy against wall ms per step (the idle
   share), and each layer's host and device ms per step ("not measured"
   when the profiler records no device activity); then the same steps as
   one CUDA graph (no layer ranges inside a replay): ms per step, busy,
   idle share and device operations per step;
6. dense eval: the dense N = 100 path (no cell kernel: its (K, N, N)
   products are float32 cuBLAS matmuls; its episodes' steps and its Adam
   updates run as the entry points' default, the programs of
   ``algos/imitation.py``, CUDA graphs, phases 6-8 and 11). The in-repo
   ``models/actor_FlockingRelative-v0_dagger_k3.npz``, read by the port's
   loader into the DAGGER learner of ``cfg/dagger.cfg [test]``, scores 20
   greedy episodes at N = 100, K = 3 as one batch; the mean must land in
   -635.2 +- 54.1 (the JAX package's final eval of the run that wrote the
   file, RESULTS.md section 1). Then one batched DAGGER episode with that
   policy (4 envs, 50 steps) from a drawn state and coins, on the card and
   on the CPU: samples and rewards must agree within 1e-4 of each
   channel's largest magnitude (the tests' episode tolerance; lost strict
   fp32 fails it), and the same episode with TF32 allowed is printed
   beside it;
7. baseline: the ``cfg/baseline.cfg`` sections through the port's
   baseline trainer; the centralized expert within -501.3 +- 47.9 and the
   decentralized one within -980.4 +- 78.9 (RESULTS.md section 1);
8. dagger: ``cfg/dagger.cfg [test]`` at full width for 3 rounds through
   the learner's ``train``: the eval at episode 0, finite losses with the
   third round's sum below the first's, rollout ms per env step, ms per
   Adam update and env steps per second; the run stops after 2 rounds
   with its state saved (a stop and a later call are one uninterrupted
   run; cut in depth: a second learner that reran 2 rounds to save it),
   and a fresh learner that resumes it for the third round: its params
   must equal the uninterrupted run's (the max difference is printed;
   bit for bit is expected); the actor export
   read back by the port's loader gives the same actions; then one more
   round under torch.profiler, read as phase 5 reads its steps (per env
   step with its Adam update). Files go to a temporary directory only.
   The cell kernels' counters, zeroed before phases 6-8, must read 0
   after them;
10. expert: one 200-step N = 32,768 episode of the analytic expert
    through the evaluate entry point's ``--expert`` path, centralized
    within -443.4 +- 15 and decentralized within -849.6 +- 25 (RESULTS.md
    section 8: -443.4 +- 3.1, -849.6 +- 4.9), overflow 0, the counters
    as an expert episode and its capture leave them (K2 and K3 none);
11. large dagger, this slice's main path: ``cfg/dagger_n32k.cfg [n32k]``
    at full width (N = 32,768, K = 3, hidden 32x2, store_agents 4,096,
    batch 20, 200 updates a round) for LARGE_ROUNDS rounds through the
    large-N learner's ``train``. Cut in depth: the buffer from 10,000 to
    LARGE_BUFFER records and the eval from 10 episodes to 1 (at episode
    0 only). Each round's counters as its episodes leave them (a
    collection episode; round 1 also its eval episode, and the captures
    of the programs not yet cached);
    finite loss sums with the third below the first; collection ms per
    env step and ms per Adam update; the run's state after 2 rounds,
    saved to a temporary directory as phase 8 saves it, resumed by a
    fresh learner for the third round: its params and buffer must equal
    the uninterrupted run's bit for bit; then one more round under
    torch.profiler, read as
    phase 8 reads its round (per collection step with its Adam update);
12. variants: one greedy episode of each in-repo
    ``models/actor_Flocking{Leader,Stochastic,AirsimAccel,TwoFlocks}-v0_dagger_*_n32k.npz``
    under its ``cfg/dagger_variants_n32k.cfg`` section at N = 32,768:
    overflow 0, the counters as a policy episode and its capture leave
    them, the first three within +-15 of
    RESULTS.md section 8 (-458.5, -521.4, -391.4), TwoFlocks (cell_margin
    1.6, cell_cap 32) finite with its reward printed. Then the TwoFlocks
    gate: TWOFLOCKS_PAIRS episodes of that policy and of the centralized
    expert on the same draws (the evaluate entry point's
    ``episode_generator(seed, episode)``), each policy reward within +-10
    of 1.503 x its expert's + 210.3 (RESULTS.md section 8b's per-draw fit
    of this checkpoint over 24 paired JAX episodes, residual std 1.8; the
    band is over 5 stds), overflow 0, the counters as the policy's and the
    expert's episodes (and the expert's capture) leave them;
13. transfer, this slice's main path: the in-repo
    ``models/actor_FlockingStochastic-v0_transfer2_stoch{1..4}`` policies
    of ``cfg/transfer_stoch.cfg`` (hidden 32x2, K = 4, 3, 2, 1).
    (a) A K = 4 lattice reset at N = 32,768 under the section made
    noiseless (FlockingRelative), 4 policy steps, then the build's
    ``-Xptxas -v`` lines of every instantiation, and on that step's own
    inputs K2 at 18 columns (and at 6, K = 2's width) and K3 at 12 on the
    row-strided view the delayed stack passes, each against its plain
    version (1e-5) and timed beside it with its bound and the launch
    floor; K2 at 18 and K3 at 12 (``RowApplyDegOp``, ``RowApplyOp``)
    each equal bit for bit to its 6-column slices launched alone through
    the 6-column kernels; 24 columns in two counted chunks (18 + 6) of K2
    and of K3 against the plain versions (1e-5); and at N = 4,096 the
    whole K = 4 stack of ystack_pre against the O(N²) delayed_ystack
    (1e-4).
    (b) ``evaluate cfg/transfer_stoch.cfg --actor-base ... --n-agents
    32768 --episodes 1`` through the CLI's main, each section traced:
    overflow 0, finite rewards, K1/K2/K3 launches on the device
    201/200/400, 201/200/200, 201/200/0 and 201/0/0 for K = 4, 3, 2, 1
    (and each capture's warm-up); rewards and ms per step (under the
    profiler) printed, and K = 4's rewards at N = 32,768 and 4,096 to
    every digit (K2 at 18 and K3 at 12 carry every K = 4 step, so a
    change in any of their sums shows there). No JAX number exists at
    this N, so the same
    evaluation at N = 4,096 with 3 episodes per section must land within
    +-1.5 of the JAX package's means there (-25.05, -25.71, -26.55,
    -28.62), overflow 0; then the CLI on section [4] alone, 1 episode at
    N = 4,096 with ``--save-trajectory``: the file's keys and shapes
    checked (cut in depth: the file from every section's first episode,
    each recorded through a program of its own, captured for it). (c) One
    20-step K = 4 and one K = 1
    episode at N = 4,096 (noiseless, x0 drawn on the card) on the card
    and through the plain versions on the CPU: rewards and final states
    within 1e-4. (d) The dense route (no ``--n-agents``): N = 50, 20
    episodes per section, each mean within the JAX package's mean +- std
    (-39.44 +- 4.33, -39.75 +- 4.38, -40.79 +- 4.81, -44.29 +- 5.95), no
    cell kernel launched; then the ``--save-trajectory`` dump of section
    [4] three times: through its program (``algos/imitation.py``
    ``TrajectoryProgram``, a CUDA graph: a capture, then a replay) and
    eagerly, each file's keys and shapes checked and the files equal bit
    for bit, one program captured; its capture, instantiate seconds and
    nodes, and each dump's ms per step printed;
14. ddpg (no cell kernel on its paths; the counters, zeroed before,
    must read 0 after). Its evals and training episodes run as the
    entry points' default, the CUDA graphs of ``algos/ddpg.py`` and
    ``algos/ddpg_large.py`` (an eval's steps as its episode program, a
    training episode's steps with its gradient steps as one graph per
    step at which the update gate opens). (a) The in-repo DDPG checkpoints through the
    evaluate CLI's DDPG route, 100 greedy episodes as one batch each:
    ``ddpg_toy_k2`` under ``cfg/ddpg_toy.cfg [test]`` within -23.45 +-
    6.4, ``ddpg_k2`` under ``cfg/ddpg.cfg [test]`` within -1302.7 +- 39.0
    and ``ddpg_unbounded_k2`` under ``[test_unbounded]`` within -1302.3 +-
    38.3 (the JAX package's 200-episode means on a CPU, bands 3 std /
    sqrt(100)); then the CLI's ``main`` on ``cfg/ddpg.cfg`` with its own
    10 episodes: finite rows. (b) One gradient step from the in-repo actor
    and critic (targets their copies) on a numpy-drawn batch, on the card
    and on the CPU, for the dense learner under ``ddpg_toy.cfg`` (toy
    files) and ``ddpg.cfg`` (``ddpg_k2`` files, GroupNorm) and the
    positions-record learner under ``ddpg_n4k.cfg`` cut to N = 1,024 (toy
    files): both losses and every updated tensor within 1e-4 of its
    largest magnitude (GroupNorm-cancelled critic biases within two of
    Adam's largest steps);
    the same step with TF32 allowed printed beside it. (c) Training at
    full width through the learner's ``train``, routed as the train CLI
    routes, DDPG_TRAIN's episodes (cut in depth there, with why):
    ``ddpg_toy.cfg [test]`` 3 episodes (gradient steps from episode 3),
    ``ddpg.cfg [test]`` 3 of 50 steps, not 200, ``ddpg_n4k.cfg [n4k]`` 2
    of 25 steps (N = 4,096, positions record); finite rewards, losses
    and evals, ms per env step with its gradient step; for toy (n4k's
    resume, a 750 MiB state file, is cut in depth;
    tests/test_torch_ddpg_large.py resumes the large learner) the state
    of the eager twin (d) stopped one episode early, saved to a temporary
    directory, resumed by the learner that captured (no new capture) and
    by a fresh learner: each must equal the uninterrupted run's training
    state bit for bit (cut in depth: a third learner that reran those
    episodes to save the state); then one more episode under
    torch.profiler, read as phase 8 reads its round (a replay calls none
    of the step's functions: the layers are the program's run and the
    eager reset). (d) Each of those learners against an eager twin
    (``graph=False``) that ran the same episodes, which cover every gate
    step of the config (toy and ``ddpg.cfg``: the gate opens after
    episodes 0 and 1 and at episode 2's first step; n4k: at step 8, then
    0): the training state and the summed reward
    and losses bit for bit; each program's capture and instantiate
    seconds and pool MB; ms per env step with its gradient steps of each
    loop (the eager twin's last episode; (c)'s profiled episode, with the
    graph's busy ms, idle share and device ops per step); the eval's wall
    through its program and eagerly, bit for bit (the program's rewards
    are (c)'s eval after training; cut in depth: a second eval); last,
    one more episode's replay behind its eager reset under CUDA's sync
    debug mode "error" (finite sums, no new capture);
15. tools: each measurement tool's ``main(argv)`` in-process on the
    card, its output printed indented; a non-zero exit, a ``[FAIL]`` or a
    SUSPECT line fails the phase. Cut in depth: ``bench --reps 1 --chains
    1 --steps 10 --no-large-n`` (one timed call of the single-env and
    128-env figures and one sustained chain of 8 batches, not 5, 5 and 2,
    of 10-step episodes, not 200, cut from 50 to hold the run's budget;
    no large-N detail; the one-thread baseline in its subprocess as
    always; its JSON line must parse with the four keys); ``smoke_env
    --episodes 1`` (all five envs, 1 episode each, not 2); ``bench_large_n
    --n 4096 --paths blocked cells binned pcells --steps 5 --repeats 1
    --episodes 1`` (5-step episodes, not 25: a first one, 1 timed chain
    of 1, not 3 of 2, and one profiled, eagerly and through the graphs on
    every path; N cut from 10,000, where the O(N^2) blocked path's step
    took ~27 ms, to hold the run's budget: its rows are the same at any
    N) and ``--n 1000000 --paths pcells --steps 25 --edge-mult 2 --cap 32
    --repeats 1 --episodes 1`` (25-step episodes: a first one, 1 timed
    chain of 1, not 3 of 2, and one profiled); ``verify_cells --quick``
    (no N = 100,000 size; the 1M geometry kept); ``run_1m --steps 100``
    at its full N = 1,000,000, edge_mult 2, cap 32, T = 100, not 200 (two
    episodes and the second again under torch.profiler; it exits 1 unless
    overflow 0, finite rewards and, in the trace, launches 101/100/100);
    and ``profile_large_n --n 100000 --steps 5`` (not 25), its trace in a
    temporary directory. Each cut holds the run's budget as the slices'
    phases join;
16. mesh, the agent-sharded path (every rank sweeps its band of grid
    rows and a collective completes the tables; the card is one, so D
    ranks' bands run one after another). (a) A perturbed lattice at N =
    100,000 (edge 1, cap 16, ``make_pcell_spec(n_dev=4)``): for D = 2 and
    4, each of the D bands of K1, K2 at 12 columns and K3 at 6 (the
    row-strided view) against its plain band version (phase 3's
    tolerance, degrees and min r^2 exact), and the D bands' sum equal to
    the full launch bit for bit. (b) A one-rank NCCL process group
    (``tcp://127.0.0.1:<free port>``) and ``make_mesh(1, 1)``: phase 4's
    episode through the evaluate entry point with that mesh, its steps
    one CUDA graph with the band's collectives captured in it (the
    sharded grid build's gathers, the all_reduce completions, the sharded
    actor's all_gather): overflow 0 and the reward equal phase 4's bit
    for bit; then the same episode through ``rollout_large(mesh=)``
    replayed under CUDA's sync debug mode "error", replayed under the
    profiler, and eagerly (``graph=False``): rewards, final state and
    overflow bit for bit, launches as phase 20 (a) wants them
    (203/202/202 counted for the capturing episode, 201/200/200 in the
    device's trace of the replay and counted for the eager loop); capture
    and instantiate seconds, the pool's growth, and ms per step of each
    loop (the eager episode's, the traced replay's); then a program of
    that setup whose step
    waits for the device (a read on the host, before its first
    collective): its capture must raise and leave no graph, nothing
    falling back to the eager loop. (c) On that mesh,
    ``rollout_large(force_n_dev=4)`` at N = 100,000 for 10 steps (cut from
    25 when phase 19's programs joined; and the real one-rank mesh beside
    it), each through its graph (the emulated rank holds no collective),
    captured and then replayed under the profiler, and eagerly, timed:
    bit for bit, and ms per step of each loop and the graph's busy ms,
    idle share and device ops per step printed, not gated;
    the emulated run's results are not valid by design. The programs are
    dropped and the group destroyed after; any failure raises;
18. dp training, this slice's main path (data-parallel imitation
    training) on a one-rank NCCL process group and ``make_mesh(1, 1)``, as
    phase 16 (b) builds them. (a) ``cfg/dagger.cfg [test]`` at full width,
    cut in depth as phase 21 is (ROUND_STEPS-step episodes, ROUND_UPDATES
    updates a round, not 200 and 200: the dense N = 100 learner holds no
    cell kernel, and the check, sharded against one process, is the same
    at any depth), 1 round through ``ShardedImitationLearner``'s programs
    (its slice of
    the envs through the dense episode program, each Adam update with its
    gradient all_reduce through the update program) against the
    one-process learner's first round from the same seed: parameters
    within 1e-6 (bit for bit expected; the max difference printed), and
    against its eager twin (``graph=False``) bit for bit; no cell kernel
    launched; ms per update of each loop's sharded Adam updates (the eager
    twin's round's, TRACE_UPDATES replays traced) and the graph's busy
    ms, idle share and device ops per update. (b) ``cfg/dagger_n32k.cfg
    [n32k]`` at full width, cut in depth as phase 11 is (LARGE_BUFFER
    records, 1 eval episode), 1 round of
    ``LargeNImitationLearner`` on that ``("env", "agents")`` mesh through
    its programs (the banded collection and eval episodes as CUDA graphs
    with their collectives), under the profiler: the device's trace must
    show 203/202/202 for each of its collection and eval episodes (each
    captured: the reset, the 2 warm-up steps, the 200 replayed steps),
    overflow 0 (the gates raise otherwise); the training state equal to
    its eager twin's and the parameters and buffer to the no-mesh
    learner's first round bit for bit; collection ms per env step and ms
    per Adam update of the three printed beside phase 11's; then ms per
    step (per update) of each loop's collection episode and Adam updates
    (the eager twin's round's; one more collection episode and
    TRACE_UPDATES updates through the graphs, traced) and the graph's busy
    ms, idle share and device ops per step (per update). (c) The same
    learner with one slot per cell (``cell_cap`` 1): the round's overflow
    gate raises on
    the rank within DP_OVERFLOW_S, nothing stored. The programs are
    dropped and the group destroyed after;
19. backends: the blocked, cells and binned graph backends
    (``ops/blocked.py``, ``ops/cells.py``, ``ops/binned.py``; plain
    PyTorch, no cell kernel) and their episode programs. (a) A lattice
    reset at N = 32,768 and BACKEND_STEPS policy steps on the pcells path,
    as phase 3; on that step's own inputs the cells and binned frames
    against the pcells frame (values and expert within 1e-5, degrees and
    min r^2 exact, overflow 0), their applies at 12 columns (the delayed
    columns) against the pcells apply, and their delayed stacks against
    ``ystack_pre`` (1e-5). (b) A greedy K = 3 episode of the n32k
    checkpoint from phase 4's reset through ``rollout_large(path=)`` on
    each path (blocked at N = BLOCKED_N, the JAX package's default path
    there, cut to BLOCKED_STEPS steps; cells at BACKEND_CELL_CAP slots per
    cell and binned at its 32, both at N = 32,768 for 200 steps): through
    its episode program (its CUDA graphs, a chunk of steps each where the
    episode's graph would exceed ``graphs.GRAPH_NODES`` nodes) capturing
    and replaying its chunks under CUDA's sync debug mode "error":
    overflow 0, one program captured, K1-K3 counters 0, cells' and
    binned's rewards within -458.8 +- 15 (phase 4's band); blocked's and
    binned's then eagerly, bit for bit; then a BACKEND_TRACE_STEPS-step
    episode of each path through its graph under the profiler and
    eagerly, timed, bit for bit. Cut in depth: cells' 200-step eager twin
    (~5 s of device time: the cells step at cap 16 is device-bound) and
    the cells episode at its default cap 12 (~5 s; its overflow, 1 agent
    in a 200-step episode, was printed, never checked, and is why cells
    runs at BACKEND_CELL_CAP). Cells' graph against eager rests on the
    short episodes (the capture, a replay after a reset); the hand-off
    between chunks, one loop for every path, on blocked's 2 chunks and
    binned's 2, each against its 200- or 50-step eager twin. Printed per
    path: steps per graph, nodes a graph, capture and instantiate
    seconds, pool MB, the long episodes' walls; per loop of the short
    episodes: ms per step, and the graph's busy ms, idle share and device
    ops per step (cut in depth: the eager short episode is timed, not
    traced). Then BACKEND_PARITY_STEPS-step episodes from one x0 on
    pcells, cells and binned, eagerly: rewards and final states within
    1e-4 of pcells'. (c) One round of ``cfg/dagger_n32k.cfg [n32k]`` with
    ``graph_path = cells`` and ``cell_cap = BACKEND_CELL_CAP``, cut in
    depth as phase 11 (LARGE_BUFFER records, 1 eval episode), to
    BACKEND_LEARNER_STEPS steps per episode, not 200 (the cells step at
    cap 16 takes ~24 ms; 25 records exceed a batch of 20, so the round
    updates), and to ROUND_UPDATES Adam updates, not 200, through the
    programs and through a ``graph=False`` twin: the training states bit
    for bit, finite loss sum, overflow 0 (the gate raises otherwise), no
    cell kernel launched (counted); each learner's collection ms per env
    step and ms per Adam update printed. (d) On a one-rank NCCL group and
    ``make_mesh(1, 1)``, built as phase 18 builds them: a
    BACKEND_MESH_STEPS-step episode of each path (blocked at BLOCKED_N;
    cut from 10 steps, the K = 3 stack full from step 3) on the mesh
    through its graphs (captured and replayed: the frames' gathers, the
    applies' collectives and the state gather in them) and eagerly, each
    equal to the same episode eagerly with no mesh, bit for bit. The
    programs are dropped and the group destroyed after;
20. graph, run after phase 5: the episode program
    (``parallel/large_n.py``) against the eager loop (``graph=False``),
    the oracle of phases 4 and 10-13. (a) Phase 4's episode (its section,
    generator and grid) through the graph: phase 4's capturing episode is
    its first, its program still cached (capture and instantiate seconds,
    the pool's growth; cut in depth: the programs dropped and the episode
    captured again), a second replaying under CUDA's sync debug mode
    "error" (no host synchronisation from the eager reset to the
    generator's hand-back), a third replaying, counted, and eagerly,
    counted: rewards, final state and overflow of the replays and the
    eager episode bit for bit, their reward equal to phase 4's; launches
    on the device (the replay's read from its trace) 201/200/200 for the
    replay and the eager episode and 203/202/202 for the capturing one
    (its warm-up), the wrappers' calls equal to them eagerly and at the
    capture and the reset's K1 alone for the replay; ms per step of each
    loop. (b) One DAGGER collection episode of the ``[n32k]`` learner's
    setup (S = 4,096, beta 0.5) through the graph (capture, then replay)
    and eagerly, each counted: records, reward and overflow bit for bit,
    the launches as (a)'s; the same numbers as (a);
21. round: the compiled imitation round (``algos/imitation.py``: the
    update program and the dense episode program) against the eager
    loops (``graph=False``), the oracle of phases 6-8 and 11. For
    ``cfg/dagger.cfg [test]`` (N = 100) and ``cfg/dagger_n32k.cfg
    [n32k]`` cut as phase 11 (LARGE_BUFFER records, 1 eval episode), and
    both cut in depth to ROUND_STEPS-step episodes and ROUND_UPDATES Adam
    updates a round, not 200 and 200 (both rounds still update, the eval
    at episode 0 still runs, and the captures, the replays after a reset
    and the resume are the same at any depth): two DAGGER rounds, the
    eval at episode 0 included, through the programs and eagerly: the
    whole training state bit for bit (parameters, Adam's state, buffer,
    generator, best eval) and the loss sums; then round 1's state file,
    saved by the eager learner, loaded into the learner whose programs
    were captured, and its round 2 run again: bit for bit again, with no
    new capture. Printed: the update program's capture, instantiate
    seconds and pool (and the dense DAGGER episode program's), each
    learner's rollout ms per env step and ms per Adam update, and ms per
    update (the eager learner's rounds', TRACE_UPDATES replays traced)
    and per dense DAGGER episode step (reset included; one episode
    eagerly, timed, and one through the graph, traced, bit for bit) of
    each loop, with the graph's device busy ms, idle share and device ops
    (its top 5 device operations); a one-env reset's and the batched
    eval's walls (graph and eager, 3 calls each). Then each
    ``cfg/baseline.cfg`` section's expert episode through the program and
    eagerly, bit for bit, and the baseline trainer's stats (its wall
    printed) equal to the eager rewards';
17. budget, run last: the run, build included, must finish in BUDGET_S; a
    watchdog ends it with a non-zero exit after WATCHDOG_S.

Then, before the last line: the card's nvidia-smi line and one JSON object
``{"kernels": [...]}``, one entry per kernel and column width the run
launched (K1; K2 at 6, 12 and 18; K3 at 6 and 12): launches on the main
paths (phase 13 (b), every K at N = 32,768 through the graph, and phase
18 (b), the mesh training round through its graphs, at K = 3's widths,
each read from the device's trace of the run), max abs error
against the plain version, ms, plain ms, the bound worked out from this
run's bytes and operations, and the PyTorch library time, null: no
PyTorch call computes these sweeps. K1, K2 at 12 and K3 at 6 are timed
in phase 3 (K = 3's inputs), the others in phase 13 (a). The last line is
the JSON contract ``{"ok": true, "device": {...}}``. Any failure is an
uncaught exception and a non-zero exit, as is a run outside a checkout of
the repository.
"""

import concurrent.futures
import copy
import dataclasses
import faulthandler
import functools
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import typing

T_START = time.perf_counter()
sys.dont_write_bytecode = True   # write nothing outside the build directory

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from multiagent_gnn_policies_tpu_torch.scripts.verify_cells import (  # noqa
    apply_work, frame_work, neighbour_bytes, pair_counts)
from multiagent_gnn_policies_tpu_torch.utils.profiling import (  # noqa: E402
    bound_ms, device_ms, summarize_trace, trace_events)

BUDGET_S = 300.0
WATCHDOG_S = 480
SEED = 20261017
DEVICE = "cuda"
N = 32768
N_ORACLE = 4096
TILES = (8, 12, 16, 24, 32)    # tile widths timed beside the default
TRACE_STEPS = 20
REL_PLAIN = 1e-5
REL_ORACLE = 1e-4
REWARD_REF, REWARD_BAND = -458.8, 15.0
# RESULTS.md section 1 (the JAX package's runs at N = 100): the DAGGER K = 3
# final eval and the two expert baselines, mean and std over 20 episodes
DAGGER_BAND = (-635.2, 54.1)
BASELINE_BANDS = {True: (-501.3, 47.9), False: (-980.4, 78.9)}
DENSE_ROUNDS = 3
DENSE_PARITY_ENVS = 4          # the card-vs-CPU dense episode: envs, steps
DENSE_PARITY_STEPS = 50
REL_EPISODE = 1e-4
CHECKPOINT = os.path.join(ROOT, "models",
                          "actor_FlockingRelative-v0_dagger_n32k.npz")
CONFIG = os.path.join(ROOT, "cfg", "dagger_n32k.cfg")
DAGGER_K3 = os.path.join(ROOT, "models",
                         "actor_FlockingRelative-v0_dagger_k3.npz")
DAGGER_CONFIG = os.path.join(ROOT, "cfg", "dagger.cfg")
BASELINE_CONFIG = os.path.join(ROOT, "cfg", "baseline.cfg")
VARIANTS_CONFIG = os.path.join(ROOT, "cfg", "dagger_variants_n32k.cfg")
# RESULTS.md section 8 (the JAX package's runs at N = 32,768): the experts
# (10 episodes) and the variant checkpoints (5 episodes), mean; the band
# half-widths are this script's
EXPERT_BANDS = {True: (-443.4, 15.0), False: (-849.6, 25.0)}
VARIANT_BANDS = {"leader": (-458.5, 15.0), "stoch": (-521.4, 15.0),
                 "airsim": (-391.4, 15.0), "twoflocks": None}
# RESULTS.md section 8b: on the same draw, the in-repo TwoFlocks n32k
# policy scores 1.503 x the centralized expert + 210.3, residual std 1.8
# (24 paired JAX episodes at N = 32,768). The band is 10, over 5 residual
# stds: the fit is per draw, so it needs no shared random stream, and the
# port's float32 sums differ from the JAX package's only in order
TWOFLOCKS_FIT = (1.503, 210.3)
TWOFLOCKS_BAND = 10.0
TWOFLOCKS_PAIRS = 3
LARGE_ROUNDS = 3
LARGE_BUFFER = 600             # records: 3 rounds of 200 steps
TRANSFER_CONFIG = os.path.join(ROOT, "cfg", "transfer_stoch.cfg")
TRANSFER_BASE = os.path.join(
    ROOT, "models", "actor_FlockingStochastic-v0_transfer2_stoch")
TRANSFER_STEPS = 4             # K = 4 policy steps before the width checks
TRANSFER_EPISODES = 3          # per section at N_ORACLE
PARITY_STEPS = 20
# per K: K1, K2 and K3 launches of one 200-step episode
TRANSFER_LAUNCHES = {4: (201, 200, 400), 3: (201, 200, 200),
                     2: (201, 200, 0), 1: (201, 0, 0)}
# the JAX package on a CPU, `evaluate.py cfg/transfer_stoch.cfg
# --actor-base ...`: with --n-agents 4096 --episodes 3 (its blocked path),
# the mean per K, band +-1.5 (about three episode stds); and the dense
# route at N = 50 (20 episodes), mean and std
TRANSFER_LARGE_BANDS = {4: (-25.05, 1.5), 3: (-25.71, 1.5),
                        2: (-26.55, 1.5), 1: (-28.62, 1.5)}
TRANSFER_DENSE_BANDS = {4: (-39.44, 4.33), 3: (-39.75, 4.38),
                        2: (-40.79, 4.81), 1: (-44.29, 5.95)}
DDPG_CONFIGS = {name: os.path.join(ROOT, "cfg", f"{name}.cfg")
                for name in ("ddpg_toy", "ddpg", "ddpg_n4k")}
# the in-repo DDPG checkpoints under their sections: the JAX package's
# 200-episode eval on a CPU (`DDPG._eval` of `cfg/<config>.cfg
# [section]` with the file's actor), mean and band 3 * std / sqrt(100)
DDPG_EVALS = (("ddpg_toy", "test", "ddpg_toy_k2", (-23.45, 6.4)),
              ("ddpg", "test", "ddpg_k2", (-1302.7, 39.0)),
              ("ddpg", "test_unbounded", "ddpg_unbounded_k2",
               (-1302.3, 38.3)))
DDPG_EVAL_EPISODES = 100
# (config, section, training episodes, resume checked, episode steps: None
# the section's). Cut in depth: the n4k learner's resume (a 750 MiB state
# file written and read three times, ~14 s; the toy learner's resume holds
# the mechanism, tests/test_torch_ddpg_large.py the large learner's), its
# episodes from 3 to 2 and from 50 steps to 25 (both gate steps, 8 and 0,
# met), ddpg.cfg's from 200 steps to 50, 3 of them (gate steps T, T and
# 0, as toy's; a batch of 100 records fills after 2 episodes; n4k's holds
# a gate inside an episode), and toy's from 4 to 3 (gate steps T, T and
# 0: the gate-0 program's replay after a reset is the resumed episode's,
# the sync-debug episode's and the profiled one's)
DDPG_TRAIN = (("ddpg_toy", "test", 3, True, None),
              ("ddpg", "test", 3, False, 50),
              ("ddpg_n4k", "n4k", 2, False, 25))
DDPG_PARITY_N = 1024           # the large step's depth cut (its CPU side)
REL_STEP = 1e-4
# Adam's largest step, in units of lr: |m_hat| / sqrt(v_hat) is at most
# (1 - beta1) / sqrt(1 - beta2) with torch's default betas
ADAM_STEP_MAX = (1 - 0.9) / math.sqrt(1 - 0.999)
MESH_N = 100_000              # phase 16: bands, and force_n_dev timing
MESH_DEVS = (2, 4)
MESH_FORCE = 4
MESH_STEPS = 10
# updates of an Adam update program replayed under the profiler for its
# ms, busy ms, idle share and device ops per update (phases 18 and 21)
TRACE_UPDATES = 20
# phase 21's learners and phase 18 (a)'s, cut in depth (graph against
# eager, bit for bit; 50 records a round exceed a batch of 20, so both
# rounds update): episodes of 50 steps and 50 Adam updates a round, not
# 200 and 200; phase 19 (c)'s 50 updates a round
ROUND_STEPS = 50
ROUND_UPDATES = 50
DP_DENSE_TOL = 1e-6           # phase 18 (a): sharded vs one-process params
DP_OVERFLOW_S = 60.0          # phase 18 (c): the gate raises within this
BACKEND_PATHS = ("cells", "binned")   # phase 19: the other graph backends
BACKEND_STEPS = 3             # (a): policy steps before the checks
BACKEND_PARITY_STEPS = 20     # (b): pcells, cells, binned from one x0
BACKEND_MESH_STEPS = 5        # (d): mesh vs no mesh
BACKEND_LEARNER_STEPS = 25    # (c): the cells learner's episodes
# (b), (d): the blocked path at the JAX package's default N below 32,768,
# its episode cut from 200 steps (~27 ms a step eagerly)
BLOCKED_N = 10_000
BLOCKED_STEPS = 50
BACKEND_TRACE_STEPS = 10      # (b): the short episodes (the graph's traced)
# (b)-(d): the cells grid's slots per cell for the n32k policy. At the
# module's default of 12 one agent of a 200-step episode overflowed (a
# cell of 13); 16 is the pcells grid's capacity
BACKEND_CELL_CAP = 16
KERNEL_SOURCE = "multiagent_gnn_policies_tpu_torch/csrc/cells.cu"
TPU_SOURCE = "multiagent_gnn_policies_tpu/ops/pallas_cells.py"

T0 = time.perf_counter()
_LAP = [T0]     # the end of the last phase or sub-step


def phase(name, t_start, **info):
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"# phase {name}: {time.perf_counter() - t_start:.2f} s {extra}",
          flush=True)
    _LAP[0] = time.perf_counter()


def lap(step):
    """Prints the wall seconds since the last phase line or ``lap``, as
    ``#   step <step>: <s> s``: the sub-steps of a phase, to see where
    its time goes."""
    now = time.perf_counter()
    print(f"#   step {step}: {now - _LAP[0]:.2f} s", flush=True)
    _LAP[0] = now


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def profiler_start_up(torch, dev):
    """A device-only torch.profiler window around one small operation:
    the profiler's first start (CUPTI's, ~8 s on the H100), which the
    first traced window of the run would pay otherwise. Returns its
    seconds."""
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    trace_events(prof)
    return time.perf_counter() - t


def check_close(what, got, want, rel, exact_channels=()):
    """Per-channel max abs and max rel error; raises past ``rel`` of the
    channel's largest magnitude (and on any difference in the exact
    channels). Returns the max abs error over all channels."""
    import torch

    got2 = got.reshape(got.shape[0], -1).double()
    want2 = want.reshape(want.shape[0], -1).double()
    if not torch.isfinite(got2).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got2 - want2).abs().amax(0)
    scale = want2.abs().amax(0).clamp_min(1e-30)
    rel_err = err / scale
    print(f"#   {what}: max abs err per channel "
          f"{[float(f'{e:.3g}') for e in err.tolist()]}, max rel "
          f"{float(rel_err.max()):.3g} (tolerance {rel})", flush=True)
    if (rel_err > rel).any():
        raise AssertionError(f"{what}: rel error {rel_err.tolist()} > {rel}")
    for q in exact_channels:
        if float(err[q]) != 0.0:
            raise AssertionError(f"{what}: channel {q} differs by {err[q]}")
    return float(err.max())


def ptxas_summary(lines):
    """One line per kernel instantiation from nvcc's ``-Xptxas -v`` output:
    its name and what ptxas used (registers, barriers, shared memory,
    stack and spills)."""
    name, frame = None, ""
    for line in lines:
        m = re.search(r"entry function .*?((?:frame|apply_deg|apply)_kernel)"
                      r"(?:ILi(\d+)E(?:Li(\d+)E)?)?", line)
        if m:
            args = ", ".join(a for a in m.group(2, 3) if a)
            name = m.group(1) + (f"<{args}>" if args else "")
        elif "bytes stack frame" in line:
            frame = "; " + line.strip()
        elif "Used" in line and name:
            yield f"{name}: {line.split(':', 1)[1].strip()}{frame}"
            name, frame = None, ""


def dense_tile_case(torch, cc, bl, FlockingParams, gen, dev):
    """A swarm of ~32 agents per 2 x 2 cell (cap 64, no overflow) swept in
    tiles a whole grid row wide (8 columns): each tile holds several
    blocks' worth of agents (several passes) and a halo of several
    staging chunks. K1, K2 at 12 and 18 columns and K3 at 6 and 12
    against their plain versions and the blocked oracle; K3 on row-strided
    views of the columns, as the delayed stack passes them."""
    n, tile = 2048, 8
    p = FlockingParams(n_agents=n)
    spec = cc.PCellSpec(cx=8, cy=8, cap=64, cell=2.0)
    x = torch.rand((n, 4), generator=gen, device=dev) * 16.0
    grid = cc.build_pcell_grid(x[:, :2], spec)
    row_n = torch.diff(grid.cell_start.cpu()[::spec.cy])
    halo = int((row_n[:-2] + row_n[1:-1] + row_n[2:]).max())
    if int(grid.overflow) or (
            halo <= max(cc.FRAME_CHUNK, cc.APPLY_DEG_CHUNK)) or (
            int(row_n.max()) <= cc.BLOCK_THREADS):
        raise AssertionError(f"dense case: overflow {int(grid.overflow)}, "
                             f"halo {halo}, row {int(row_n.max())}")
    cols = torch.randn((n, 18), generator=gen, device=dev)
    per = cc.frame_sweep(x, grid, spec, 1.0, True, tile=tile)
    deg = per[:, 6].contiguous()
    pos = x[:, :2].contiguous()
    check_close("K1 vs plain, dense tiles", per,
                cc.frame_sweep_plain(x, grid, spec, 1.0, True), REL_PLAIN,
                exact_channels=(6, 9))
    ref = bl.blocked_frame(x, p, True, block=512)
    check_close("K1 vs blocked oracle, dense tiles", per[:, :6], ref.values,
                REL_ORACLE)
    check_close("K1 degree vs blocked oracle, dense tiles", deg[:, None],
                ref.degree[:, None], 0.0, exact_channels=(0,))
    if float(per[:, 9].min()) != float(ref.min_r2):
        raise AssertionError("dense tiles: min r^2 differs from the oracle")
    # K2 on contiguous columns, K3 on the views (row stride 18) that the
    # delayed stack passes at K = 3 (6 columns) and K = 4 (12)
    for c in (12, 18):
        k2_cols = cols[:, :c].contiguous()
        applied = cc.apply_deg_sweep(x, k2_cols, deg, grid, spec, 1.0,
                                     tile=tile)
        check_close(f"K2 C={c} vs plain, dense tiles", applied,
                    cc.apply_deg_sweep_plain(x, k2_cols, deg, grid, spec,
                                             1.0), REL_PLAIN)
        check_close(f"K2 C={c} vs blocked oracle, dense tiles", applied,
                    bl.blocked_apply_adjT(pos, k2_cols, p, 512, deg=deg),
                    REL_ORACLE)
    for c in (6, 12):
        view = cols[:, 18 - c:]
        applied3 = cc.apply_sweep(pos, view, deg, grid, spec, 1.0,
                                  tile=tile)
        check_close(f"K3 C={c} vs plain, dense tiles", applied3,
                    cc.apply_sweep_plain(pos, view, deg, grid, spec, 1.0),
                    REL_PLAIN)
        check_close(f"K3 C={c} vs blocked oracle, dense tiles", applied3,
                    bl.blocked_apply_adjT(pos, view, p, 512, deg=deg),
                    REL_ORACLE)
    return halo


class _Annotated:
    """Wraps module functions in torch.profiler.record_function ranges for
    the duration of a ``with`` block, so a trace attributes host and device
    time to the step's layers; restores them on exit."""

    def __init__(self, record_function, targets):
        self.rf, self.targets, self.saved = record_function, targets, []

    def __enter__(self):
        for module, attr, label in self.targets:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))
            setattr(module, attr, self._wrap(f"layer: {label}", fn))
        return self

    def _wrap(self, label, fn):
        def call(*args, **kwargs):
            with self.rf(label):
                return fn(*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)


def trace_steps(torch, ln, cc, cfg, actor, state, gen, steps):
    """Host-clock ms per step of ``steps`` steady steps of the eager loop,
    then the same steps under torch.profiler with the step's layers
    annotated. Prints the top 10 device operations, device operations per
    step, device-busy against wall ms per step, and per-layer host and
    device ms per step; then the same of the steps as one CUDA graph, less
    the layers. Returns both ms per step ``(eager, graph)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = ln._scan_steps(cfg, actor, state, steps, gen)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t) / steps

    def annotated_actor(y):
        with record_function("layer: actor"):
            return actor(y)

    layers = _Annotated(record_function, (
        (cc, "build_pcell_grid", "grid build"),
        (cc, "frame_apply", "frame_apply (K1, K2)"),
        (cc, "ystack_pre", "ystack_pre (K3)"),
        (ln, "_dynamics", "dynamics"),
        (ln, "_s0_cols", "s0 columns"),
        (ln, "delay_carry_update", "delay carry"),
        (ln, "_reward", "reward"),
    ))
    with layers, profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        ln._scan_steps(cfg, annotated_actor, state, steps, gen)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t) / steps
    summarize_trace(trace_events(prof), steps, wall_ms, prof_wall_ms)
    # the same steps as the episode program's CUDA graph (no layer ranges
    # inside a replay): captured by a first run, then timed and traced
    acfg = actor.cfg
    prog = ln.episode_program(cfg, acfg, steps, DEVICE)
    prog.run(state, actor, gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    prog.run(state, actor, gen)
    torch.cuda.synchronize()
    graph_ms = 1e3 * (time.perf_counter() - t) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prog.run(state, actor, gen)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t) / steps
    print(f"#   trace: the same {steps} steps as one CUDA graph: "
          f"{graph_ms:.4f} ms/step", flush=True)
    summarize_trace(trace_events(prof), steps, graph_ms, prof_wall_ms)
    return wall_ms, graph_ms



class _Events:
    """A metrics logger that keeps the learner's events in a list."""

    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


def _in_band(what, value, band):
    ref, width = band
    if not math.isfinite(value) or abs(value - ref) > width:
        raise AssertionError(f"{what} {value} outside {ref} +- {width}")


def dense_eval_phase(torch, im, tfl, load_actor_npz, actor_params_from_numpy,
                     dcfg):
    """Phase 6: the in-repo dagger_k3 checkpoint, 20 greedy episodes at
    N = 100 as one batch, through the learner's evaluate."""
    icfg = im.ImitationConfig.from_experiment(dcfg)
    learner = im.ImitationLearner(icfg, device=DEVICE)
    learner.actor.load_state_dict(actor_params_from_numpy(
        load_actor_npz(DAGGER_K3, icfg.actor)))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tfl.reset(gen, icfg.env, (icfg.n_test_episodes,))
    torch.cuda.synchronize()
    reset_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    mean, std = learner.evaluate()          # ends in a copy to the host
    eval_s = time.perf_counter() - t
    steps = icfg.env.episode_steps
    print(f"#   dense eval: dagger_k3, {icfg.n_test_episodes} episodes at "
          f"N = {icfg.env.n_agents}, K = {icfg.actor.k}: {mean} +- {std}; "
          f"{eval_s:.3f} s, {1e3 * eval_s / steps:.4f} ms per batched step "
          f"(its reset included; a reset alone {reset_ms:.2f} ms)",
          flush=True)
    _in_band("dagger_k3 eval mean", mean, DAGGER_BAND)
    err = dense_parity(torch, im, tfl, learner, icfg)
    return mean, std, 1e3 * eval_s / steps, err


def _dense_episode(im, env, actor, acfg, x0, coins, graph=None):
    samples, rewards = im.rollout_episode(actor, None, 0.5, env, acfg,
                                          mode="dagger", x0=x0, coins=coins,
                                          graph=graph)
    return {"agg": samples["agg"].reshape(-1, samples["agg"].shape[-1]),
            "act": samples["act"].reshape(-1, samples["act"].shape[-1]),
            "reward": rewards.reshape(-1, 1)}


def dense_parity(torch, im, tfl, learner, icfg):
    """One batched DAGGER episode (DENSE_PARITY_ENVS envs of
    DENSE_PARITY_STEPS steps, the dagger_k3 policy) on the card from a
    drawn x0 and coins, held against the same episode on the CPU: samples
    (agg, act) and rewards within REL_EPISODE of each channel's largest
    magnitude, the tests' tolerance for episodes. The same episode with
    TF32 allowed is printed beside it (not checked), to show what the
    check would see if strict fp32 were lost."""
    params = dataclasses.replace(icfg.env, episode_steps=DENSE_PARITY_STEPS)
    env = tfl.make_env(icfg.env_name, params)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    state, _ = env.reset(gen, (DENSE_PARITY_ENVS,))
    coins = torch.rand((DENSE_PARITY_STEPS, DENSE_PARITY_ENVS),
                       generator=gen, device=DEVICE) < 0.5
    cpu_actor = copy.deepcopy(learner.actor).cpu()
    want = _dense_episode(im, env, cpu_actor, icfg.actor,
                          state.x.cpu(), coins.cpu())
    got = _dense_episode(im, env, learner.actor, icfg.actor, state.x,
                         coins)
    errs = {k: check_close(f"dense episode card vs CPU, {k}", got[k].cpu(),
                           want[k], REL_EPISODE) for k in want}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:   # eagerly: a graph replays the kernels it captured under fp32
        tf32 = _dense_episode(im, env, learner.actor, icfg.actor,
                              state.x, coins, graph=False)
    finally:
        tfl.strict_fp32()
    rel = max(float(((tf32[k].cpu().double() - want[k].double()).abs()
                     .amax(0) / want[k].double().abs().amax(0)
                     .clamp_min(1e-30)).max()) for k in want)
    print(f"#   dense episode with TF32 allowed (not checked): max rel "
          f"error against the CPU {rel:.3g}", flush=True)
    return max(errs.values())


def baseline_phase(ExperimentConfig, load_ini, train_baseline):
    """Phase 7: the cfg/baseline.cfg sections on the card."""
    ini = load_ini(BASELINE_CONFIG)
    out = {}
    for name in ini.sections():
        bcfg = ExperimentConfig.from_section(ini[name])
        t = time.perf_counter()
        stats = train_baseline(bcfg, device=DEVICE)
        wall = time.perf_counter() - t
        print(f"#   baseline [{name}]: centralized={bcfg.centralized}, "
              f"N = {bcfg.n_agents}, {bcfg.n_test_episodes} episodes: "
              f"{stats['mean']} +- {stats['std']} ({wall:.3f} s)", flush=True)
        _in_band(f"baseline [{name}] mean", stats["mean"],
                 BASELINE_BANDS[bcfg.centralized])
        out[bcfg.centralized] = stats["mean"]
    return out


def dagger_phase(torch, im, load_actor_npz, actor_params_from_numpy, Actor,
                 dcfg):
    """Phase 8: DENSE_ROUNDS DAGGER rounds of cfg/dagger.cfg [test] at full
    width, a state save and resume, and the actor export."""
    icfg = im.ImitationConfig.from_experiment(dcfg, mode="dagger")
    log = _Events()
    full = im.ImitationLearner(icfg, log, device=DEVICE)
    losses = []
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.npz")
        for r in range(1, DENSE_ROUNDS + 1):
            # stopped after round DENSE_ROUNDS - 1 with its state saved,
            # then on: a stop and a later call are one uninterrupted run
            # (cut in depth: no second learner reruns those rounds to save
            # the state)
            saving = r == DENSE_ROUNDS - 1
            stopped = full.train(state_path=state if saving else None,
                                 stop_after=r)
            if saving:
                if not stopped["interrupted"]:
                    raise AssertionError("the stopped run did not stop")
                stop_beta = full._beta
            losses.append(float(full.last_loss_sum))
        evals = [f for e, f in log.events if e == "eval"]
        if [f["episode"] for f in evals] != [0] or not math.isfinite(
                evals[0]["reward_mean"]):
            raise AssertionError(f"evals {evals}")
        print(f"#   dagger: eval at episode 0 {evals[0]['reward_mean']} +- "
              f"{evals[0]['reward_std']}; loss sums per round {losses}",
              flush=True)
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"loss sums {losses}")
        timing = full.timing_summary()
        print(f"#   dagger: rollout {timing['rollout_ms_per_step']:.4f} ms "
              f"per env step, {timing['update_ms_per_update']:.4f} ms per "
              f"Adam update, {timing['env_steps_per_s']:.1f} env steps/s "
              f"({full.timing['rollout_steps']} steps, "
              f"{full.timing['updates']} updates)", flush=True)
        log2 = _Events()
        rest = im.ImitationLearner(icfg, log2, device=DEVICE)
        rest.train(state_path=state, stop_after=DENSE_ROUNDS)
        if log2.events[0] != ("resume", {"round": DENSE_ROUNDS - 1,
                                         "beta": stop_beta}):
            raise AssertionError(f"resume events {log2.events[:1]}")
        got, want = rest.actor.state_dict(), full.actor.state_dict()
        diff = max(float((got[k] - want[k]).abs().max()) for k in want)
        scale = max(float(v.abs().max()) for v in want.values())
        same = all(torch.equal(got[k], want[k]) for k in want)
        print(f"#   dagger: resumed round {DENSE_ROUNDS} against the "
              f"uninterrupted run: max param difference {diff} (largest "
              f"param {scale:.4g}), bit for bit {same}", flush=True)
        if diff > 1e-6 * scale:
            raise AssertionError(f"resume differs by {diff}")
        path = os.path.join(tmp, "actor")
        full.export_actor(path)
        back = Actor(icfg.actor)
        back.load_state_dict(actor_params_from_numpy(load_actor_npz(
            path + ".npz", icfg.actor)))
        back = back.to(DEVICE)
        with torch.no_grad():
            y = full.buffer.sample(full.gen, icfg.batch_size)["agg"]
            if not torch.equal(back(y), full.actor(y)):
                raise AssertionError("the exported actor acts differently")
    # one more round under torch.profiler, its two halves annotated
    from torch.profiler import ProfilerActivity, profile, record_function

    steps = icfg.env.episode_steps
    wall_ms = 1e3 * (full.timing["rollout_s"] + full.timing["update_s"]) / (
        full.timing["rollout_steps"])
    layers = _Annotated(record_function, (
        (im, "rollout_episode", "rollout"),
        (im.UpdateProgram, "run", "Adam updates")))
    with layers, profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        full.train(stop_after=DENSE_ROUNDS + 1)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t) / steps
    print(f"#   dagger trace: one round, per env step with its Adam update",
          flush=True)
    summarize_trace(trace_events(prof), steps, wall_ms, prof_wall_ms)
    return losses, timing, same


class Launched(typing.NamedTuple):
    """The kernels' launches in one run (:func:`_counted`)."""

    host: dict       # wrapper -> the wrappers' calls (the counters)
    captures: int    # episode programs captured in the run
    seconds: float   # the run's wall, synchronised
    device: dict     # wrapper -> launches the device ran (traced runs)
    by_cols: dict    # wrapper -> {columns: launches}, of the same


def _counted(cc, fn, traced=False):
    """``fn()`` with the kernel counters zeroed just before and read just
    after: ``(result, Launched)``. A CUDA graph's replay calls no wrapper,
    so the counters count the eager launches and those a capture records
    (``host``). ``traced``: the run goes under torch.profiler
    (``cells_cuda.device_launches``), and ``device`` and ``by_cols`` are
    the launches the device ran, read from the trace's kernel names (its
    wall then includes the profiler); else they are the counters'."""
    import torch

    from multiagent_gnn_policies_tpu_torch.parallel.large_n import (
        EpisodeProgram)

    def timed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    captures = EpisodeProgram.captures
    cc.reset_launch_counts()
    if traced:
        (out, seconds), by_cols = cc.device_launches(timed)
    else:
        out, seconds = timed()
        by_cols = cc.launch_counts_by_cols()
    return out, Launched(
        cc.launch_counts(), EpisodeProgram.captures - captures, seconds,
        {w: sum(by.values()) for w, by in by_cols.items()}, by_cols)


def _launches(episodes, policy=True, t=200, captures=0, per_step=None,
              host=False):
    """What ``episodes`` episodes of ``t`` steps launch on the device: K1
    T+1 times each (the reset and each step), K2 and K3 T times each for a
    K = 3 policy, never for the expert (``per_step``: each wrapper's
    launches per step, for another K); plus, for each of ``captures``
    episode programs captured, the WARMUP_STEPS steps its warm-up ran on
    scratch copies before capture. ``host``: the wrappers' calls instead,
    a replay making none: the resets' K1, and per capture its warm-up and
    its T recorded steps."""
    from multiagent_gnn_policies_tpu_torch.parallel.large_n import (
        WARMUP_STEPS)

    per_step = per_step or {"frame_sweep": 1,
                            "apply_deg_sweep": int(policy),
                            "apply_sweep": int(policy)}
    if host:
        return {w: episodes * (w == "frame_sweep")
                + captures * (WARMUP_STEPS + t) * n
                for w, n in per_step.items()}
    return {w: episodes * (n * t + (w == "frame_sweep"))
            + captures * WARMUP_STEPS * n for w, n in per_step.items()}


def expert_phase(ev, cc, load_ini, n_agents):
    """Phase 10: one 200-step episode of the analytic expert at
    ``n_agents`` through the evaluate entry point's ``--expert`` path,
    centralized and decentralized (the ``[n32k]`` section with
    ``centralized`` set): each in its RESULTS.md section 8 band, overflow 0
    (the entry point exits 3 otherwise), K1 201 launches, K2 and K3 none."""
    out = {}
    for centralized in (True, False):
        section = load_ini(CONFIG)["n32k"]
        section["centralized"] = str(centralized)
        stats, launches = _counted(cc, lambda: ev.evaluate_blocked(
            section, None, n_agents=n_agents, n_episodes=1, expert=True,
            device=DEVICE))
        wall = launches.seconds
        print(f"#   expert: centralized={centralized}, N = {n_agents}: "
              f"{stats['mean']}, overflow {stats['overflow']}, launches "
              f"{launches}, {wall:.3f} s ({1e3 * wall / 200:.4f} ms per step, "
              f"reset and capture included)",
              flush=True)
        _in_band(f"expert centralized={centralized}", stats["mean"],
                 EXPERT_BANDS[centralized])
        if launches.host != _launches(1, False, captures=launches.captures,
                                      host=True):
            raise AssertionError(f"expert launches {launches}")
        out[centralized] = stats["mean"]
    return out


def large_dagger_phase(torch, im, il, cc, ExperimentConfig, load_ini,
                       n_agents):
    """Phase 11: ``cfg/dagger_n32k.cfg [n32k]`` at full width (N, K = 3,
    hidden 32x2, S = 4,096, batch 20) for LARGE_ROUNDS rounds through the
    large-N learner's ``train``. Cut in depth: the buffer to LARGE_BUFFER
    records, one eval episode (at episode 0 only, as test_interval 40
    gives). Each round's launches (zeroed before it): a collection episode
    and, in round 1, the eval episode, 201/200/200 each. Finite loss sums,
    the third below the first; the run's state after 2 rounds (a
    temporary directory), resumed by a fresh learner, equals the
    uninterrupted run bit for bit; one more round under torch.profiler,
    read as phase 8 reads its round."""
    import dataclasses as dc

    canon = ExperimentConfig.from_section(load_ini(CONFIG)["n32k"])
    xcfg = dc.replace(canon, n_agents=n_agents, buffer_size=LARGE_BUFFER,
                      n_test_episodes=1)
    lcfg = il.LargeNImitationConfig.from_experiment(xcfg, mode="dagger")
    log = _Events()
    full = il.LargeNImitationLearner(lcfg, log, device=DEVICE)
    losses, total = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.npz")
        for r in range(1, LARGE_ROUNDS + 1):
            # stopped after round LARGE_ROUNDS - 1 with its state saved,
            # then on, as phase 8's run
            saving = r == LARGE_ROUNDS - 1
            stopped, launches = _counted(cc, lambda: full.train(
                state_path=state if saving else None, stop_after=r))
            if saving and not stopped["interrupted"]:
                raise AssertionError("the stopped run did not stop")
            losses.append(float(full.last_loss_sum))
            want = _launches(2 if r == 1 else 1, captures=launches.captures,
                             host=True)
            if launches.host != want:
                raise AssertionError(f"round {r}: launches {launches} != "
                                     f"{want}")
            total = {k: total.get(k, 0) + v for k, v in launches.host.items()}
        evals = [f for e, f in log.events if e == "eval"]
        if [f["episode"] for f in evals] != [0] or not math.isfinite(
                evals[0]["reward_mean"]):
            raise AssertionError(f"evals {evals}")
        timing = full.timing_summary()
        print(f"#   large dagger: N = {n_agents}, S = {lcfg.store_agents}, "
              f"buffer {LARGE_BUFFER} records (cut from {canon.buffer_size}),"
              f" 1 eval episode (from {canon.n_test_episodes}): eval at "
              f"episode 0 {evals[0]['reward_mean']}; loss sums per round "
              f"{losses}; collection {timing['rollout_ms_per_step']:.4f} ms "
              f"per env step, {timing['update_ms_per_update']:.4f} ms per "
              f"Adam update, {timing['env_steps_per_s']:.1f} env steps/s; "
              f"launches over the {LARGE_ROUNDS} rounds {total}", flush=True)
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"loss sums {losses}")
        state_mb = os.path.getsize(state) / 2**20
        rest = il.LargeNImitationLearner(lcfg, device=DEVICE)
        rest.train(state_path=state, stop_after=LARGE_ROUNDS)
        got, want = rest.actor.state_dict(), full.actor.state_dict()
        same = all(torch.equal(got[k], want[k]) for k in want) and all(
            torch.equal(rest.buffer.data[k], full.buffer.data[k])
            for k in full.buffer.data)
        diff = max(float((got[k] - want[k]).abs().max()) for k in want)
        print(f"#   large dagger: resumed round {LARGE_ROUNDS} against the "
              f"uninterrupted run: max param difference {diff}, params and "
              f"buffer bit for bit {same} (state file {state_mb:.1f} MiB)",
              flush=True)
        if not same:
            raise AssertionError(f"resume differs by {diff}")
        del rest
    from torch.profiler import ProfilerActivity, profile, record_function

    steps = lcfg.env.episode_steps
    wall_ms = 1e3 * (full.timing["rollout_s"] + full.timing["update_s"]) / (
        full.timing["rollout_steps"])
    layers = _Annotated(record_function, (
        (il, "collect_episode", "collection"),
        (im.UpdateProgram, "run", "Adam updates")))
    with layers, profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        full.train(stop_after=LARGE_ROUNDS + 1)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t) / steps
    print("#   large dagger trace: one round, per collection step with its "
          "Adam update", flush=True)
    summarize_trace(trace_events(prof), steps, wall_ms, prof_wall_ms)
    return losses, timing, same, total


def variants_phase(ev, cc, load_ini, n_agents):
    """Phase 12: one greedy episode of each in-repo variant checkpoint
    ``models/actor_{env}_{fname}.npz`` under its
    ``cfg/dagger_variants_n32k.cfg`` section (TwoFlocks with its
    ``cell_margin 1.6``, ``cell_cap 32``): overflow 0, 201/200/200
    launches, and the leader, stochastic and drag variants within +-15 of
    RESULTS.md section 8; TwoFlocks finite, its reward printed."""
    ini = load_ini(VARIANTS_CONFIG)
    out = {}
    for name in ini.sections():
        section = ini[name]
        path = os.path.join(ROOT, "models", f"actor_{section['env']}_"
                            f"{section['fname']}.npz")
        stats, launches = _counted(cc, lambda: ev.evaluate_blocked(
            section, path, n_agents=n_agents, n_episodes=1, device=DEVICE))
        print(f"#   variant [{name}] {section['env']}: {stats['mean']}, "
              f"overflow {stats['overflow']}, launches {launches}",
              flush=True)
        if (launches.host != _launches(1, captures=launches.captures,
                                       host=True)
                or not math.isfinite(stats["mean"])):
            raise AssertionError(f"variant {name}: {stats}, {launches}")
        if VARIANT_BANDS[name] is not None:
            _in_band(f"variant [{name}]", stats["mean"], VARIANT_BANDS[name])
        out[name] = stats["mean"]
    return out


def twoflocks_gate(ev, cc, load_ini, n_agents):
    """Phase 12's TwoFlocks gate: TWOFLOCKS_PAIRS episodes of the in-repo
    ``dagger_twoflocks_n32k`` policy and of the centralized expert on the
    same draws (``episode_generator(seed, episode)`` of the evaluate entry
    point), under its ``[twoflocks]`` section at ``n_agents``: each policy
    reward within TWOFLOCKS_BAND of RESULTS.md section 8b's fit of the
    expert's, overflow 0, launches 201/200/200 per policy episode and 201
    per expert episode. Returns the largest residual."""
    section = load_ini(VARIANTS_CONFIG)["twoflocks"]
    section["centralized"] = "True"
    path = os.path.join(ROOT, "models", f"actor_{section['env']}_"
                        f"{section['fname']}.npz")
    run = lambda **kw: _counted(cc, lambda: ev.evaluate_blocked(
        section, path, n_agents=n_agents, n_episodes=TWOFLOCKS_PAIRS,
        device=DEVICE, **kw))
    (pol, lp), (exp, le) = run(), run(expert=True)
    if (lp.host != _launches(TWOFLOCKS_PAIRS, captures=lp.captures,
                             host=True)
            or le.host != _launches(TWOFLOCKS_PAIRS, False,
                                    captures=le.captures, host=True)):
        raise AssertionError(f"twoflocks launches {lp}, {le}")
    slope, icpt = TWOFLOCKS_FIT
    worst = 0.0
    for ep, (r_p, r_e) in enumerate(zip(pol["rewards"], exp["rewards"])):
        resid = r_p - (slope * r_e + icpt)
        print(f"#   twoflocks pair {ep}: policy {r_p}, expert {r_e}, "
              f"policy - ({slope} x expert + {icpt}) = {resid:.4f} (band "
              f"+-{TWOFLOCKS_BAND})", flush=True)
        if not math.isfinite(resid) or abs(resid) > TWOFLOCKS_BAND:
            raise AssertionError(f"twoflocks pair {ep}: residual {resid}")
        worst = max(worst, abs(resid))
    return worst


def _tool(main, argv):
    """A tool's ``main(argv)`` in-process, its standard output captured
    and printed indented: ``(stdout text, seconds)``. A non-zero exit, or
    any exception, propagates."""
    import contextlib
    import io

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"#     {line}", flush=True)
    name = main.__module__.rsplit(".", 1)[-1]
    print(f"#   tool {name} {' '.join(argv)}: rc {rc}, {wall:.2f} s",
          flush=True)
    if rc:
        raise AssertionError(f"{name} {argv} exited {rc}")
    return text, wall


def tools_phase(cc):
    """Phase 15: the measurement tools' ``main`` in-process, on the card,
    each at the depth the module docstring's phase 15 states."""
    from multiagent_gnn_policies_tpu_torch import bench
    from multiagent_gnn_policies_tpu_torch.scripts import (
        bench_large_n, profile_large_n, run_1m, smoke_env, verify_cells)

    out = {}
    text, out["bench_s"] = _tool(bench.main, ["--reps", "1", "--chains", "1",
                                              "--steps", "10",
                                              "--no-large-n"])
    line = json.loads(text.strip())
    if (set(line) != {"metric", "value", "unit", "vs_baseline"}
            or line["metric"] != "rollout_steps_per_s"
            or not line["value"] > 0):
        raise AssertionError(f"bench line {line}")
    out["bench_steps_per_s"] = line["value"]
    text, out["smoke_env_s"] = _tool(smoke_env.main, ["--episodes", "1"])
    if "SUSPECT" in text or text.count(" ok\n") != 5:
        raise AssertionError("smoke_env: a SUSPECT or missing episode")
    _, out["bench_large_n_s"] = _tool(bench_large_n.main, [
        "--n", "4096", "--paths", "blocked", "cells", "binned", "pcells",
        "--steps", "5", "--repeats", "1", "--episodes", "1"])
    _, s = _tool(bench_large_n.main, [
        "--n", "1000000", "--paths", "pcells", "--edge-mult", "2", "--cap",
        "32", "--steps", "25", "--repeats", "1", "--episodes", "1"])
    out["bench_large_n_s"] += s
    text, out["verify_cells_s"] = _tool(verify_cells.main, ["--quick"])
    if "[FAIL]" in text or "ALL PASSED" not in text:
        raise AssertionError("verify_cells --quick failed")
    text, out["run_1m_s"] = _tool(run_1m.main, ["--steps", "100"])
    out["run_1m_ms_per_step"] = float(
        re.search(r"steady: ([0-9.]+) ms/step", text).group(1))
    with tempfile.TemporaryDirectory() as tmp:
        _, out["profile_large_n_s"] = _tool(profile_large_n.main, [
            "--n", "100000", "--steps", "5", "--out", tmp])
    cc.reset_launch_counts()
    return out


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _param_diff(torch, a, b):
    """Max abs difference of two learners' actor parameters, and whether
    they are equal bit for bit."""
    got, want = a.actor.state_dict(), b.actor.state_dict()
    return (max(float((got[k] - want[k]).abs().max()) for k in want),
            all(torch.equal(got[k], want[k]) for k in want))


def mesh_phase(torch, ev, ln, cc, FlockingParams, ExperimentConfig,
               _init_candidate, load_ini, reward):
    """Phase 16: the agent-sharded path on the card (module docstring):
    (a) the bands of K1-K3 against the full launches and their plain band
    versions at N = MESH_N, (b) a one-rank NCCL mesh through the evaluate
    entry point and its CUDA graph against the eager loop and phase 4's
    reward, (c) force_n_dev band timing, graph and eager. Returns what the
    phase line prints."""
    from multiagent_gnn_policies_tpu_torch.parallel import distributed
    from multiagent_gnn_policies_tpu_torch.parallel import mesh as pm

    dev = torch.device(DEVICE)
    out = {}
    # (a) D bands of the grid rows sum to the whole grid bit for bit
    p = FlockingParams(n_agents=MESH_N)
    spec = cc.make_pcell_spec(p, n_dev=max(MESH_DEVS))
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = _init_candidate(gen, p, dev)
    x[:, :2] += 0.05 * torch.randn((MESH_N, 2), generator=gen, device=dev)
    grid = cc.build_pcell_grid(x[:, :2], spec)
    if int(grid.overflow):
        raise AssertionError(f"overflow at N={MESH_N}")
    deg = cc.frame_sweep(x, grid, spec, 1.0, True)[:, 6].contiguous()
    cols = torch.randn((MESH_N, 12), generator=gen, device=dev)
    pos = x[:, :2].contiguous()
    sweeps = {
        "K1": (lambda b: cc.frame_sweep(x, grid, spec, 1.0, True, band=b),
               lambda b: cc.frame_sweep_plain(x, grid, spec, 1.0, True,
                                              band=b), (6, 9)),
        "K2 C=12": (lambda b: cc.apply_deg_sweep(x, cols, deg, grid, spec,
                                                 1.0, band=b),
                    lambda b: cc.apply_deg_sweep_plain(
                        x, cols, deg, grid, spec, 1.0, band=b), ()),
        "K3 C=6": (lambda b: cc.apply_sweep(pos, cols[:, 6:], deg, grid,
                                            spec, 1.0, band=b),
                   lambda b: cc.apply_sweep_plain(pos, cols[:, 6:], deg,
                                                  grid, spec, 1.0, band=b),
                   ()),
    }
    band_err = 0.0
    for name, (kernel, plain, exact) in sweeps.items():
        full = kernel(None)
        for d in MESH_DEVS:
            total = torch.zeros_like(full)
            for r in range(d):
                band = cc.row_band(spec, d, r)
                got = kernel(band)
                band_err = max(band_err, check_close(
                    f"{name} band {band} of D={d} vs plain", got,
                    plain(band), REL_PLAIN, exact_channels=exact))
                total += got
            torch.cuda.synchronize()
            if not torch.equal(total, full):
                raise AssertionError(f"{name}: the {d} bands do not sum to "
                                     f"the full launch")
            print(f"#   {name}: {d} bands sum to the full launch bit for "
                  f"bit", flush=True)
    out["band_max_abs_err"] = band_err
    lap("16 (a) bands")

    # (b) a one-rank NCCL mesh: phase 4's episode through the evaluate
    # entry point (its program captured with the band's collectives), a
    # replay under sync debug mode "error", a replay and the eager loop
    distributed.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = pm.make_mesh(1, 1)
        section = load_ini(CONFIG)["n32k"]
        # the capture's launches are the wrappers' calls (the reset, the
        # warm-up, the recorded steps); the replay's come from the trace
        stats, captured = _counted(cc, lambda: ev.evaluate_blocked(
            section, CHECKPOINT, n_agents=N, n_episodes=1, device=DEVICE,
            mesh=mesh))
        lap("16 (b) capturing episode")
        if stats["overflow"] != 0 or stats["mean"] != reward:
            raise AssertionError(f"mesh episode: reward {stats['mean']!r}, "
                                 f"overflow {stats['overflow']} (phase 4: "
                                 f"{reward!r})")
        p, xcfg = _section_params(ExperimentConfig, section, N)
        acfg = _section_actor_config(xcfg)
        actor = ev.load_actor(CHECKPOINT, acfg, dev)
        kw = dict(centralized_expert=xcfg.centralized, return_overflow=True,
                  cell_margin=xcfg.cell_margin, cap=xcfg.cell_cap or None,
                  cell_edge_mult=xcfg.cell_edge_mult, device=DEVICE,
                  mesh=mesh)

        def episode(graph):
            return ln.rollout_large(
                actor, acfg, ev.episode_generator(xcfg.seed, 0, DEVICE), p,
                graph=graph, **kw)

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            synced = episode(True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        lap("16 (b) sync debug replay")
        graphed, replayed = _counted(cc, lambda: episode(True), traced=True)
        lap("16 (b) traced replay")
        eager, eagerly = _counted(cc, lambda: episode(False))
        lap("16 (b) eager episode")
        same = all(torch.equal(a, b) for run in (synced, graphed)
                   for a, b in zip(run, eager))
        prog = ln.episode_program(ln.make_config(
            p, cap=kw["cap"], cell_margin=kw["cell_margin"],
            cell_edge_mult=kw["cell_edge_mult"],
            centralized=xcfg.centralized, mesh=mesh), acfg, p.episode_steps,
            DEVICE)
        total = float(graphed[0].sum())
        print(f"#   mesh: phase 4's episode on a one-rank NCCL mesh through "
              f"its CUDA graph (the collectives captured): reward {total}, "
              f"eager {float(eager[0].sum())}, phase 4 {reward}; bit for "
              f"bit {same}, a replay under sync debug mode \"error\"; "
              f"launches: capture episode {captured}, replay {replayed}, "
              f"eager {eagerly}; capture {prog.capture_s:.3f} s, instantiate "
              f"{prog.instantiate_s:.3f} s, pool {prog.pool_mb:.1f} MB",
              flush=True)
        if not same or total != reward or int(graphed[2]):
            raise AssertionError("the mesh graph episode differs from the "
                                 "eager loop or phase 4")
        _check_graph_launches(captured, replayed, eagerly)
        out.update(mesh_reward=repr(total), mesh_bit_for_bit=same,
                   mesh_launches=json.dumps(replayed.device,
                                            separators=(",", ":")),
                   mesh_capture_s=f"{prog.capture_s:.3f}",
                   mesh_instantiate_s=f"{prog.instantiate_s:.3f}",
                   mesh_pool_mb=f"{prog.pool_mb:.1f}")
        # each loop's ms per step: the eager episode's wall and the traced
        # replay's (under the profiler)
        steps = p.episode_steps
        out.update(_loop_stats("mesh", 1e3 * eagerly.seconds / steps, (
            None, None, None, 1e3 * replayed.seconds / steps)))
        out["mesh_capture_failure"] = _mesh_capture_failure(
            torch, ev, ln, prog.cfg, acfg, actor, xcfg.seed)
        lap("16 (b) failed capture")

        # (c) force_n_dev: one rank's program of a MESH_FORCE-rank mesh,
        # and the real one-rank mesh, each eagerly and through its graph
        p100 = FlockingParams(n_agents=MESH_N, episode_steps=MESH_STEPS)
        for d in (1, MESH_FORCE):
            def run(graph):
                g = torch.Generator(device=dev).manual_seed(SEED)
                return ln.rollout_large(actor, acfg, g, p100, device=dev,
                                        mesh=mesh, force_n_dev=d,
                                        return_overflow=True, graph=graph)

            # the capture, the eager loop timed, a replay traced
            first = run(True)
            eager, e_s = _wall(torch, lambda: run(False))
            replayed, *g_stats = _traced(torch, lambda: run(True),
                                         MESH_STEPS)
            same = all(torch.equal(a, b) for r in (first, replayed)
                       for a, b in zip(r, eager))
            prog = ln.episode_program(ln.make_config(
                p100, mesh=mesh, force_n_dev=d), acfg, MESH_STEPS, dev)
            note = ("the real one-rank mesh, its collectives captured" if
                    d == 1 else "emulated rank 0 of 4, collectives replaced "
                    "by local operations: its rewards are not valid by "
                    "design")
            print(f"#   force_n_dev={d} at N={MESH_N}, {MESH_STEPS} steps "
                  f"({note}): graph against eager bit for bit {same}; "
                  f"capture {prog.capture_s:.3f} s, instantiate "
                  f"{prog.instantiate_s:.3f} s, pool {prog.pool_mb:.1f} MB",
                  flush=True)
            if not same:
                raise AssertionError(f"force_n_dev={d}: the graph differs "
                                     f"from the eager loop")
            out.update(_loop_stats(f"D{d}", 1e3 * e_s / MESH_STEPS,
                                   g_stats, "step"))
            lap(f"16 (c) force_n_dev={d}")
    finally:
        # the programs' graphs name the group's communicator
        ln.clear_programs()
        torch.distributed.destroy_process_group()
    cc.reset_launch_counts()
    return out


def _syncing_step(cfg, actor, state, gen=None):
    """The episode's step after a read of the overflow on the host: a
    wait for the device, which a capture cannot hold."""
    float(state.overflow)
    import multiagent_gnn_policies_tpu_torch.parallel.large_n as ln

    return ln._step(cfg, actor, state, gen)


def _mesh_capture_failure(torch, ev, ln, cfg, acfg, actor, seed):
    """A mesh program whose step waits for the device (before its first
    collective): its capture must raise, leave no graph and return no
    result (nothing falls back to the eager loop). Returns the error's
    first words."""
    prog = ln.EpisodeProgram(cfg, acfg, 2, DEVICE, step=_syncing_step)
    start = ln._episode_init(cfg, acfg, ev.episode_generator(seed, 0, DEVICE),
                             DEVICE)
    try:
        prog.run(start, actor)
    except RuntimeError as e:
        message = str(e).splitlines()[0][:80]
    else:
        raise AssertionError("a mesh capture that waits for the device did "
                             "not raise")
    if prog.captured:
        raise AssertionError("the failed capture left a graph")
    print(f"#   mesh: a capture whose step waits for the device raised: "
          f"{message}", flush=True)
    return message


def dp_phase(torch, im, il, cc, ExperimentConfig, load_ini, n_agents,
             large_speed):
    """Phase 18: data-parallel training on a one-rank NCCL mesh (module
    docstring): (a) the dense round through ShardedImitationLearner, (b)
    the large-N round on the ("env", "agents") mesh with its launches, (c)
    a forced overflow. Returns what the phase line prints and (b)'s
    launches by wrapper and width."""
    import dataclasses as dc

    from multiagent_gnn_policies_tpu_torch.parallel import distributed
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as ln
    from multiagent_gnn_policies_tpu_torch.parallel import mesh as pm
    from multiagent_gnn_policies_tpu_torch.parallel.sharded import (
        ShardedImitationLearner)

    out = {}
    distributed.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = pm.make_mesh(1, 1)
        # (a) the dense round, sharded and not, cut in depth as phase 21's
        icfg = im.ImitationConfig.from_experiment(dc.replace(
            ExperimentConfig.from_section(load_ini(DAGGER_CONFIG)["test"]),
            episode_steps=ROUND_STEPS, updates_per_step=ROUND_UPDATES),
            mode="dagger")
        dense = (ShardedImitationLearner(icfg, mesh, device=DEVICE),
                 im.ImitationLearner(icfg, device=DEVICE),
                 ShardedImitationLearner(icfg, mesh, device=DEVICE,
                                         graph=False))
        cc.reset_launch_counts()
        for lrn in dense:
            lrn.train(stop_after=1)
        torch.cuda.synchronize()
        lap("18 (a) three dense rounds")
        diff, same = _param_diff(torch, *dense[:2])
        same_twin = _same_training_state(torch, dense[0], dense[2])
        speed, eager = (lrn.timing_summary() for lrn in dense[::2])
        print(f"#   dp dense: cfg/dagger.cfg [test], 1 round through "
              f"ShardedImitationLearner's programs on a one-rank NCCL mesh "
              f"(its slice of the envs, each update with its all_reduce) "
              f"against the one-process learner: max param difference "
              f"{diff} (bit for bit {same}); against its eager twin: "
              f"training state bit for bit {same_twin}; rollout "
              f"{speed['rollout_ms_per_step']:.4f} ms per env step (eager "
              f"{eager['rollout_ms_per_step']:.4f}), "
              f"{speed['update_ms_per_update']:.4f} ms per Adam update "
              f"(eager {eager['update_ms_per_update']:.4f}); update capture "
              f"{dense[0]._updates.capture_s:.3f} s", flush=True)
        if diff > DP_DENSE_TOL or not same_twin:
            raise AssertionError(f"dense sharded round differs by {diff} "
                                 f"(eager twin equal: {same_twin})")
        if any(cc.launch_counts().values()):
            raise AssertionError(f"the dense path launched cell kernels: "
                                 f"{cc.launch_counts()}")
        out.update(dense_max_param_diff=diff, dense_bit_for_bit=same,
                   dense_twin_bit_for_bit=same_twin)
        # each loop's sharded updates (the all_reduce in each): the eager
        # twin's round's, and TRACE_UPDATES more replays traced
        _, *g_stats = _traced(torch, lambda: dense[0]._updates.run(
            TRACE_UPDATES, dense[0].gen), TRACE_UPDATES)
        out.update(_loop_stats("dp_dense_adam", eager["update_ms_per_update"],
                               g_stats, "update"))
        lap("18 (a) more updates, traced")
        del dense

        # (b) the large-N round on the mesh through its programs (the
        # banded collection and eval episodes as CUDA graphs with their
        # collectives, the update program), against its eager twin and
        # the no-mesh round
        canon = ExperimentConfig.from_section(load_ini(CONFIG)["n32k"])
        lcfg = il.LargeNImitationConfig.from_experiment(dc.replace(
            canon, n_agents=n_agents, buffer_size=LARGE_BUFFER,
            n_test_episodes=1), mode="dagger")
        meshed = il.LargeNImitationLearner(lcfg, device=DEVICE, mesh=mesh)
        twin = il.LargeNImitationLearner(lcfg, device=DEVICE, mesh=mesh,
                                         graph=False)
        plain = il.LargeNImitationLearner(lcfg, device=DEVICE)
        # a replay calls no wrapper: the launches come from the trace
        _, launched = _counted(cc, lambda: meshed.train(stop_after=1),
                               traced=True)
        lap("18 (b) mesh round, traced")
        launches = launched.device
        by_cols = {(fn, c): v for fn, cols in launched.by_cols.items()
                   for c, v in cols.items()}
        if launches != _launches(2, captures=2) or launched.captures != 2:
            raise AssertionError(f"mesh round launches {launched}: not "
                                 f"203/202/202 for each of its captured "
                                 f"collection and eval episodes")
        twin.train(stop_after=1)
        lap("18 (b) eager twin round")
        plain.train(stop_after=1)
        torch.cuda.synchronize()
        lap("18 (b) no-mesh round")
        same_twin = _same_training_state(torch, meshed, twin)
        diff, same = _param_diff(torch, meshed, plain)
        same_buffer = all(torch.equal(meshed.buffer.data[k],
                                      plain.buffer.data[k])
                          for k in plain.buffer.data)
        sm, st, sp = (lrn.timing_summary() for lrn in (meshed, twin, plain))
        print(f"#   dp large: cfg/dagger_n32k.cfg [n32k] at N = {n_agents} "
              f"(buffer {LARGE_BUFFER} records, 1 eval episode), 1 round on "
              f"the one-rank (env, agents) mesh through its programs: "
              f"launches on the device {launches} (collection + eval "
              f"episode, each captured), overflow 0; against the eager "
              f"twin: training state bit for bit {same_twin}; against the "
              f"no-mesh round: max param difference {diff}, params bit for "
              f"bit {same}, buffer bit for bit {same_buffer}; collection "
              f"{sm['rollout_ms_per_step']:.4f} ms per env step on the mesh "
              f"(capture included), {st['rollout_ms_per_step']:.4f} eager, "
              f"{sp['rollout_ms_per_step']:.4f} without a mesh (phase 11 "
              f"{large_speed['rollout_ms_per_step']:.4f}); "
              f"{sm['update_ms_per_update']:.4f} ms per Adam update on the "
              f"mesh, {st['update_ms_per_update']:.4f} eager, "
              f"{sp['update_ms_per_update']:.4f} without (phase 11 "
              f"{large_speed['update_ms_per_update']:.4f})", flush=True)
        if not (same and same_buffer and same_twin):
            raise AssertionError(f"the mesh round differs from its eager "
                                 f"twin ({same_twin}) or the no-mesh round "
                                 f"by {diff} (buffer equal: {same_buffer})")
        out.update(large_launches=json.dumps(launches, separators=(",", ":")),
                   large_bit_for_bit=same and same_buffer and same_twin,
                   mesh_collection_ms_per_step=(
                       f"{sm['rollout_ms_per_step']:.4f}"),
                   plain_collection_ms_per_step=(
                       f"{sp['rollout_ms_per_step']:.4f}"),
                   mesh_update_ms=f"{sm['update_ms_per_update']:.4f}",
                   plain_update_ms=f"{sp['update_ms_per_update']:.4f}")
        # each loop's collection episode and Adam updates: the eager
        # twin's round's, and one more collection episode and
        # TRACE_UPDATES updates through the graphs, traced
        steps = lcfg.env.episode_steps
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
        _, *g_stats = _traced(torch, lambda: il.collect_episode(
            meshed._lcfg, meshed.actor, lcfg.actor, "dagger",
            meshed.store_agents, gen, 0.5, DEVICE, graph=True), steps)
        out.update(_loop_stats("mesh_collection", st["rollout_ms_per_step"],
                               g_stats))
        lap("18 (b) one more collection, traced")
        _, *g_stats = _traced(torch, lambda: meshed._updates.run(
            TRACE_UPDATES, meshed.gen), TRACE_UPDATES)
        out.update(_loop_stats("mesh_adam", st["update_ms_per_update"],
                               g_stats, "update"))
        lap("18 (b) more updates, traced")
        del meshed, twin, plain

        # (c) a forced overflow (one slot per cell) raises on the rank
        bad = il.LargeNImitationLearner(dc.replace(lcfg, cell_cap=1),
                                        device=DEVICE, mesh=mesh)
        t = time.perf_counter()
        try:
            bad.train(stop_after=1)
        except RuntimeError as e:
            if "overflow=" not in str(e):
                raise
            message = str(e)
        else:
            raise AssertionError("the forced overflow did not raise")
        raised_s = time.perf_counter() - t
        print(f"#   dp overflow: cell_cap 1 on the mesh raised after "
              f"{raised_s:.2f} s: {message[:72]}...", flush=True)
        if raised_s > DP_OVERFLOW_S or bad.buffer.size:
            raise AssertionError(f"the overflow gate took {raised_s} s or "
                                 f"stored {bad.buffer.size} records")
        out["overflow_raised_s"] = f"{raised_s:.2f}"
        lap("18 (c) forced overflow")
        del bad
    finally:
        # the programs' graphs name the group's communicator
        ln.clear_programs()
        torch.distributed.destroy_process_group()
    cc.reset_launch_counts()
    return out, by_cols


def _section_params(ExperimentConfig, section, n_agents, steps=None):
    """The env of ``section`` at ``n_agents`` as the evaluate entry point
    builds it (``episode_steps`` cut to ``steps`` when given), and the
    section's config."""
    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        ENV_REGISTRY, FlockingParams)

    cfg = ExperimentConfig.from_section(section)
    p = FlockingParams(n_agents=n_agents, comm_radius=cfg.comm_radius,
                       dt=cfg.dt, v_max=cfg.v_max,
                       episode_steps=steps or cfg.episode_steps)
    return ENV_REGISTRY[cfg.env](p), cfg


def backends_phase(torch, ev, ln, cc, il, ExperimentConfig, load_ini,
                   n_agents, reward):
    """Phase 19: the blocked, cells and binned graph backends on the card
    (module docstring): (a) the cells and binned frames, applies and
    stacks against the pcells path's on a K = 3 step's own inputs, (b)
    each path's episode through its graphs and eagerly
    (:func:`backend_graphs`) and 20-step episodes of pcells, cells and
    binned from one x0, (c) a cells learner round against its eager twin,
    (d) a one-rank NCCL mesh's graphs against no mesh. Returns what the
    phase line prints."""
    import dataclasses as dc

    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        _init_candidate)
    from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig
    from multiagent_gnn_policies_tpu_torch.ops import binned as bn
    from multiagent_gnn_policies_tpu_torch.ops import cells as cl
    from multiagent_gnn_policies_tpu_torch.parallel import distributed
    from multiagent_gnn_policies_tpu_torch.parallel import mesh as pm

    dev = torch.device(DEVICE)
    section = load_ini(CONFIG)["n32k"]
    p, xcfg = _section_params(ExperimentConfig, section, n_agents)
    acfg = ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=3)
    actor = ev.load_actor(CHECKPOINT, acfg, dev)
    out = {}
    err = 0.0
    # (a) a lattice reset and K = 3 policy steps on the pcells path, then
    # every backend on that step's inputs
    spec = cc.make_pcell_spec(p)
    cfg = ln.LargeNConfig(params=p, cell_spec=spec, centralized=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    with torch.no_grad():
        state = ln._episode_init(cfg, acfg, gen, dev)
        state, _ = ln._scan_steps(cfg, actor, state, BACKEND_STEPS, gen)
        x, carry = state.x, state.carry
        fq = cc.frame(x, state.grid, spec, p, True, need_expert=True)
        deg = fq.degree.contiguous()
        cols = ln._s0_cols(carry).contiguous()                  # (N, 12)
        want = {
            "frame": torch.cat([fq.values, deg[:, None], fq.expert], 1),
            "apply": cc.apply_adjT(x[:, :2], deg, cols, spec, p,
                                   grid=state.grid),
            "ystack": cc.ystack_pre(carry, state.s0, spec, p,
                                    grid_hist=state.grid_hist),
        }
        cspec = cl.make_cell_spec(p)
        cgrid = cl.build_cell_grid(x[:, :2], cspec)
        nl = bn.build_neighbor_list(x[:, :2], p.comm_radius)
        cfq = cl.cells_frame(x, cgrid, cspec, p, True)
        bfq = bn.binned_frame(x, nl, p, True)
        got = {
            "cells": {
                "frame": cfq,
                "apply": cl.cells_apply_adjT(x[:, :2], fq.degree, cols, cspec,
                                             p, grid=cgrid),
                "ystack": cl.cells_ystack(carry, cgrid, x, fq.degree, cspec,
                                          p),
                "overflow": int(cgrid.overflow)},
            "binned": {
                "frame": bfq,
                "apply": bn.binned_apply_adjT(nl, cols, deg=fq.degree),
                "ystack": bn.binned_ystack(carry, nl, p),
                "overflow": int(nl.overflow)},
        }
        torch.cuda.synchronize()
    for path, g in got.items():
        if g["overflow"]:
            raise AssertionError(f"{path}: overflow {g['overflow']}")
        f = g["frame"]
        err = max(err, check_close(
            f"{path} frame vs pcells, N={n_agents}",
            torch.cat([f.values, f.degree[:, None], f.expert], 1),
            want["frame"], REL_PLAIN, exact_channels=(6,)))
        if float(f.min_r2) != float(fq.min_r2):
            raise AssertionError(f"{path} min r^2 {float(f.min_r2)} != "
                                 f"{float(fq.min_r2)}")
        err = max(err, check_close(f"{path} apply C=12 vs pcells (K3)",
                                   g["apply"], want["apply"], REL_PLAIN))
        err = max(err, check_close(
            f"{path} ystack vs ystack_pre", g["ystack"].transpose(0, 1),
            want["ystack"].transpose(0, 1), REL_PLAIN))
    out["max_abs_err"] = f"{err:.3g}"
    lap("19 (a) one step's inputs")

    # (b) each path's episode through its program (CUDA graphs) and its
    # eager loop: blocked at BLOCKED_N, cells and binned at N, phase 4's
    # reset
    out.update(backend_graphs(torch, ev, ln, cc, ExperimentConfig, section,
                              actor, acfg, xcfg, n_agents, reward))
    # then BACKEND_PARITY_STEPS-step episodes of pcells, cells and binned,
    # eagerly (the programs are (b)'s and (d)'s)
    cap = {"cells": BACKEND_CELL_CAP, "binned": None, "blocked": None}
    p20, _ = _section_params(ExperimentConfig, section, n_agents,
                             BACKEND_PARITY_STEPS)
    x0 = _init_candidate(torch.Generator(device=dev).manual_seed(SEED + 20),
                         p20, dev)
    ends = {}
    with torch.no_grad():
        for path in ("pcells", *BACKEND_PATHS):
            r, xf, ovf = ln.rollout_large(actor, acfg, None, p20, x0=x0,
                                          return_overflow=True, device=dev,
                                          path=path, cap=cap.get(path),
                                          graph=False)
            if int(ovf):
                raise AssertionError(f"{path} 20-step episode: overflow")
            ends[path] = (r, xf)
    for path in BACKEND_PATHS:
        check_close(f"{path} {BACKEND_PARITY_STEPS}-step final state vs "
                    f"pcells", ends[path][1], ends["pcells"][1], REL_EPISODE)
        check_close(f"{path} {BACKEND_PARITY_STEPS}-step rewards vs pcells",
                    ends[path][0][:, None], ends["pcells"][0][:, None],
                    REL_EPISODE)
    lap("19 (b) 20-step parity")
    ln.clear_programs()

    # (c) one round of the n32k section on the cells path, cut in depth as
    # phase 11, through the programs and eagerly
    lcfg = il.LargeNImitationConfig.from_experiment(dc.replace(
        xcfg, n_agents=n_agents, buffer_size=LARGE_BUFFER, n_test_episodes=1,
        graph_path="cells", cell_cap=BACKEND_CELL_CAP,
        episode_steps=BACKEND_LEARNER_STEPS,
        updates_per_step=ROUND_UPDATES), mode="dagger")
    learners = {}
    for name, graph in (("graph", None), ("eager", False)):
        lrn = learners[name] = il.LargeNImitationLearner(
            lcfg, device=DEVICE, graph=graph)
        _, launches = _counted(cc, lambda: lrn.train(stop_after=1))
        torch.cuda.synchronize()
        if any(launches.host.values()):
            raise AssertionError(f"cells learner ({name}): launches "
                                 f"{launches}")
        lap(f"19 (c) cells learner, {name}")
    lrn = learners["graph"]
    same = _same_training_state(torch, lrn, learners["eager"])
    loss = float(lrn.last_loss_sum)
    speed = {name: learners[name].timing_summary() for name in learners}
    print(f"#   cells learner: cfg/dagger_n32k.cfg [n32k] with graph_path = "
          f"cells at N = {n_agents} (buffer {LARGE_BUFFER} records, 1 eval "
          f"episode, {BACKEND_LEARNER_STEPS}-step episodes), 1 round "
          f"through its programs against graph=False: training state bit "
          f"for bit {same}, loss sum {loss}; collection "
          + ", ".join(f"{n} {sp['rollout_ms_per_step']:.4f}"
                      for n, sp in speed.items())
          + " ms per env step (first capture included), Adam update "
          + ", ".join(f"{n} {sp['update_ms_per_update']:.4f}"
                      for n, sp in speed.items()) + " ms", flush=True)
    if not same or not math.isfinite(loss):
        raise AssertionError(f"cells learner: bit for bit {same}, loss "
                             f"{loss}")
    out.update(cells_learner_loss=loss, cells_learner_bit_for_bit=same,
               cells_collection_ms_per_step=(
                   f"{speed['graph']['rollout_ms_per_step']:.4f}"),
               cells_update_ms=f"{speed['graph']['update_ms_per_update']:.4f}")
    del lrn, learners
    ln.clear_programs()

    # (d) a one-rank NCCL mesh through its graphs against its eager loop
    # and no mesh, bit for bit
    distributed.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = pm.make_mesh(1, 1)
        for path, n in (("blocked", BLOCKED_N), ("cells", n_agents),
                        ("binned", n_agents)):
            pm_steps, _ = _section_params(ExperimentConfig, section, n,
                                          BACKEND_MESH_STEPS)
            runs = {}
            for name, m, graph in (("mesh graph", mesh, None),
                                   ("mesh eager", mesh, False),
                                   ("no mesh", None, False)):
                with torch.no_grad():
                    runs[name] = ln.rollout_large(
                        actor, acfg, torch.Generator(device=dev).manual_seed(
                            SEED + 21), pm_steps, return_overflow=True,
                        device=dev, path=path, cap=cap[path], mesh=m,
                        graph=graph)
            want = runs["no mesh"]
            same = int(want[2]) == 0 and all(
                all(torch.equal(a, b) for a, b in zip(run, want))
                for run in runs.values())
            prog = ln.episode_program(ln.make_config(
                pm_steps, path=path, cap=cap[path], mesh=mesh), acfg,
                BACKEND_MESH_STEPS, dev)
            print(f"#   {path}: {BACKEND_MESH_STEPS}-step episode at N = {n} "
                  f"on a one-rank NCCL mesh through its graphs (captured "
                  f"and replayed) and eagerly vs no mesh: bit for bit {same}; "
                  f"{prog.steps_per_graph} steps per graph, {prog.nodes} "
                  f"nodes a graph, capture {prog.capture_s:.3f} s",
                  flush=True)
            if not same or not prog.captured:
                raise AssertionError(f"{path}: the mesh episode differs")
            out[f"{path}_mesh_bit_for_bit"] = same
            lap(f"19 (d) {path} on the mesh")
    finally:
        ln.clear_programs()
        torch.distributed.destroy_process_group()
    cc.reset_launch_counts()
    return out


def _traced(torch, run, steps, ms=None, top=0):
    """``run()`` once under torch.profiler (its ``top`` device operations
    printed): ``(its result, busy ms per step, idle share against ``ms``
    per step, device ops per step)``, the three None when the profiler
    records no device activity; with ``ms`` None the idle share is
    against the run's own wall under the profiler, and that ms per step
    comes last."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t) / steps
    summary = summarize_trace(trace_events(prof), steps, ms or prof_ms,
                              prof_ms, top=top)
    stats = ((None, None, None) if summary is None else (
        summary["busy_ms"], summary["idle"], summary["ops_per_step"]))
    return (res, *stats) + (() if ms else (prof_ms,))


def _wall(torch, run):
    """``run()`` and its wall seconds, synchronised."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def backend_graphs(torch, ev, ln, cc, ExperimentConfig, section, actor,
                   acfg, xcfg, n_agents, reward):
    """Phase 19 (b): each path's greedy episode of the n32k checkpoint from
    phase 4's reset (blocked at BLOCKED_N for BLOCKED_STEPS steps, cells at
    BACKEND_CELL_CAP and binned at N for 200) through its episode program:
    a first episode under CUDA's sync debug mode "error" (the eager reset,
    the warm-up, the probe, the captures and every chunk's replay): overflow
    0, no cell kernel launched, cells and binned within phase 4's band;
    then, for blocked and binned, the same episode eagerly, bit for bit;
    then a BACKEND_TRACE_STEPS-step episode through the graph under the
    profiler (its program captured first) and eagerly, timed, bit for bit.
    Cut in depth: cells' 200-step eager twin (~5 s of device time) and
    the cells episode at its default cap 12 (its overflow printed, never
    checked); cells' graph against eager rests on the short episodes (the
    capture, a replay after a reset), the hand-off between chunks, the
    same loop on every path, on blocked's 2 chunks and binned's. Printed
    per path: steps per graph, nodes a graph, capture and instantiate s,
    pool MB, the long episodes' walls; per loop of the short episodes: ms
    per step, and the graph's busy ms, idle share and device ops per step.
    Returns what the phase line prints."""
    dev = torch.device(DEVICE)
    cap = {"cells": BACKEND_CELL_CAP, "binned": None, "blocked": None}
    out = {}
    for path, n, t_cut in (("blocked", BLOCKED_N, BLOCKED_STEPS),
                           ("cells", n_agents, None),
                           ("binned", n_agents, None)):
        p, _ = _section_params(ExperimentConfig, section, n, t_cut)
        p_stats, _ = _section_params(ExperimentConfig, section, n,
                                     BACKEND_TRACE_STEPS)
        steps = p.episode_steps

        def episode(graph, p=p, path=path):
            with torch.no_grad():
                return ln.rollout_large(
                    actor, acfg, ev.episode_generator(xcfg.seed, 0, dev), p,
                    centralized_expert=xcfg.centralized,
                    return_overflow=True, device=dev, path=path,
                    cap=cap[path], graph=graph)

        def synced():
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _wall(torch, lambda: episode(None))
            finally:
                torch.cuda.set_sync_debug_mode("default")

        ln.clear_programs()          # each path's graphs in a new pool
        (first, first_s), launched = _counted(cc, synced)
        lap(f"19 (b) {path} capturing episode")
        prog = ln.episode_program(ln.make_config(
            p, path=path, cap=cap[path], centralized=xcfg.centralized),
            acfg, steps, dev)
        same, walls = True, f"capturing {first_s:.3f} s"
        if path != "cells":
            eager, e_s = _wall(torch, lambda: episode(False))
            same = all(torch.equal(a, b) for a, b in zip(first, eager))
            walls += (f", eager {e_s:.3f} s ({1e3 * e_s / steps:.4f} ms per "
                      f"step)")
            del eager
            lap(f"19 (b) {path} eager episode")
        # the graph's device time from a shorter episode: a trace of a
        # 200-step cells episode's replays holds ~10^5 launches
        short = functools.partial(episode, p=p_stats)
        short(None)                  # its program's capture
        traced, *g_stats = _traced(torch, lambda: short(None),
                                   BACKEND_TRACE_STEPS)
        short_e, short_s = _wall(torch, lambda: short(False))
        same = same and all(torch.equal(a, b)
                            for a, b in zip(traced, short_e))
        lap(f"19 (b) {path} short episodes")
        total, ovf = float(first[0].sum()), int(first[2])
        print(f"#   {path}: {steps}-step K = 3 episode at N = {n} through "
              f"its graphs (the capture and its replays under sync debug "
              f"mode \"error\")"
              f"{'' if path == 'cells' else ' and eagerly'}, and a "
              f"{BACKEND_TRACE_STEPS}-step one through its graph, traced, "
              f"and eagerly: bit for bit {same}, reward {total} "
              f"(pcells at N = {n_agents} {reward}), overflow {ovf}, "
              f"launches {launched.host}, captures {launched.captures}; "
              f"{prog.steps_per_graph} steps per graph, {prog.nodes} nodes "
              f"a graph ({prog.nodes / prog.steps_per_graph:.1f} per step), "
              f"capture {prog.capture_s:.3f} s, instantiate "
              f"{prog.instantiate_s:.3f} s, pool {prog.pool_mb:.1f} MB; the "
              f"{steps}-step episode's wall: {walls}", flush=True)
        out.update(_loop_stats(
            path, 1e3 * short_s / BACKEND_TRACE_STEPS, g_stats,
            f"step (the {BACKEND_TRACE_STEPS}-step episode, reset included)"))
        if not same or ovf or any(launched.host.values()) \
                or launched.captures != 1 or not math.isfinite(total):
            raise AssertionError(f"{path}: bit for bit {same}, overflow "
                                 f"{ovf}, launches {launched}, reward "
                                 f"{total}")
        if n == n_agents and abs(total - REWARD_REF) > REWARD_BAND:
            raise AssertionError(f"{path}: reward {total} outside "
                                 f"{REWARD_REF} +- {REWARD_BAND}")
        out.update({f"{path}_reward": total, f"{path}_bit_for_bit": same,
                    f"{path}_steps_per_graph": prog.steps_per_graph,
                    f"{path}_nodes": prog.nodes})
        del first, traced, short_e, prog
    ln.clear_programs()
    cc.reset_launch_counts()
    return out


def graph_phase(torch, ev, ln, il, cc, ExperimentConfig, load_ini, n_agents,
                reward, captured):
    """Phase 20: the episode program (``parallel/large_n.py``), the default
    of phases 4 and 10-13. (a) The n32k checkpoint's 200-step K = 3
    episode of phase 4 (its section, generator and grid), eagerly
    (``graph=False``) and through the CUDA graph: phase 4's episode, whose
    launches are ``captured``, captured its program (its capture and
    instantiate seconds and the pool's growth printed), the next replays
    under CUDA's sync debug mode "error" (no host synchronisation from the
    reset to the generator's hand-back), one more replays, counted;
    rewards, final state and overflow bit for bit, reward equal to phase
    4's, launches as :func:`_check_graph_launches` wants them; ms per
    step of each loop. (b) One DAGGER collection episode of the
    ``[n32k]`` learner's setup (S = 4,096, beta 0.5) the same way, its
    capture its own: records, reward and overflow bit for bit, the same
    launches and numbers. Returns what the phase line prints."""
    section = load_ini(CONFIG)["n32k"]
    p, xcfg = _section_params(ExperimentConfig, section, n_agents)
    acfg = _section_actor_config(xcfg)
    actor = ev.load_actor(CHECKPOINT, acfg, DEVICE)
    steps = p.episode_steps
    kw = dict(centralized_expert=xcfg.centralized, return_overflow=True,
              cell_margin=xcfg.cell_margin, cap=xcfg.cell_cap or None,
              cell_edge_mult=xcfg.cell_edge_mult, device=DEVICE)
    cfg = ln.make_config(p, cap=kw["cap"], cell_margin=kw["cell_margin"],
                         cell_edge_mult=kw["cell_edge_mult"],
                         centralized=xcfg.centralized)
    out = {}

    def episode(graph):
        return ln.rollout_large(
            actor, acfg, ev.episode_generator(xcfg.seed, 0, DEVICE), p,
            graph=graph, **kw)

    # (a) the evaluation episode: phase 4's captured its program
    first_l, first_s = captured, captured.seconds
    prog = ln.episode_program(cfg, acfg, steps, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        synced = episode(True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    lap("20 (a) sync debug replay")
    graphed, g_launch = _counted(cc, lambda: episode(True), traced=True)
    lap("20 (a) traced replay")
    eager, e_launch = _counted(cc, lambda: episode(False))
    lap("20 (a) eager episode")
    same = all(all(torch.equal(a, b) for a, b in zip(run, eager))
               for run in (synced, graphed))
    total = float(graphed[0].sum())
    print(f"#   graph: {steps}-step K = 3 episode at N = {n_agents}: graph "
          f"reward {total}, eager {float(eager[0].sum())}, phase 4 {reward};"
          f" overflow {int(graphed[2])}; launches: replay {g_launch}, "
          f"capture episode {first_l}, eager {e_launch}; bit for bit "
          f"{same}; first graph episode {first_s:.3f} s: capture {prog.capture_s:.3f} s, instantiate "
          f"{prog.instantiate_s:.3f} s, pool {prog.pool_mb:.1f} MB",
          flush=True)
    if not same or total != reward or int(graphed[2]):
        raise AssertionError(f"graph episode differs from the eager loop "
                             f"or phase 4 ({total} against {reward})")
    _check_graph_launches(first_l, g_launch, e_launch)
    out.update(reward=total, bit_for_bit=same,
               capture_s=f"{prog.capture_s:.3f}",
               instantiate_s=f"{prog.instantiate_s:.3f}",
               pool_mb=f"{prog.pool_mb:.1f}")
    # each loop's ms per step: the eager episode's wall and the traced
    # replay's (under the profiler)
    out.update(_loop_stats("episode", 1e3 * e_launch.seconds / steps, (
        None, None, None, 1e3 * g_launch.seconds / steps)))

    # (b) one collection episode of the large learner's setup
    lcfg = il.LargeNImitationConfig.from_experiment(
        dataclasses.replace(xcfg, n_agents=n_agents), mode="dagger")
    ccfg = ln.make_config(p, cap=lcfg.cell_cap or None,
                          cell_margin=lcfg.cell_margin,
                          cell_edge_mult=lcfg.cell_edge_mult,
                          centralized=True, need_expert=True)

    def collect(graph):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
        samples, r, ovf = il.collect_episode(
            ccfg, actor, acfg, "dagger", lcfg.store_agents, gen, 0.5, DEVICE,
            graph=graph)
        return samples["agg"], samples["act"], r, ovf

    runs = {}
    for name, graph in (("capture", True), ("graph", True), ("eager", False)):
        res, launches = _counted(cc, lambda: collect(graph),
                                 traced=name == "graph")
        runs[name] = (res, launches, launches.seconds)
        lap(f"20 (b) {name}")
    prog = il.collection_program(ccfg, acfg, "dagger", lcfg.store_agents,
                                 DEVICE)
    same = all(all(torch.equal(a, b) for a, b in zip(runs[n][0],
                                                     runs["eager"][0]))
               for n in ("capture", "graph"))
    print(f"#   graph: DAGGER collection episode, S = {lcfg.store_agents}: "
          f"reward {float(runs['graph'][0][2])}, overflow "
          f"{int(runs['graph'][0][3])}, bit for bit {same}; launches "
          + ", ".join(f"{n} {runs[n][1]}" for n in runs) + "; "
          + ", ".join(f"{n} {1e3 * runs[n][2] / steps:.4f}" for n in runs)
          + " ms per step (reset and draws included; the replay under the "
          "profiler)",
          flush=True)
    if not same or int(runs["graph"][0][3]):
        raise AssertionError("graph collection differs from the eager loop")
    _check_graph_launches(*(runs[n][1] for n in runs))
    print(f"#   graph: collection capture {prog.capture_s:.3f} s, "
          f"instantiate {prog.instantiate_s:.3f} s, pool {prog.pool_mb:.1f} "
          f"MB", flush=True)
    out.update(collection_bit_for_bit=same,
               collection_capture_s=f"{prog.capture_s:.3f}",
               collection_instantiate_s=f"{prog.instantiate_s:.3f}",
               collection_pool_mb=f"{prog.pool_mb:.1f}")
    out.update(_loop_stats("collection", 1e3 * runs["eager"][2] / steps, (
        None, None, None, 1e3 * runs["graph"][2] / steps)))
    return out


def round_phase(torch, im, il, cc, ExperimentConfig, load_ini, dcfg,
                n_agents):
    """Phase 21: the compiled imitation round (``algos/imitation.py``'s
    update and dense episode programs), the default of phases 6-8 and 11,
    against the eager loops (``graph=False``). Returns what the phase line
    prints."""
    import numpy as np

    cut = dict(episode_steps=ROUND_STEPS, updates_per_step=ROUND_UPDATES)
    canon = ExperimentConfig.from_section(load_ini(CONFIG)["n32k"])
    learners = {
        "dense": lambda graph: im.ImitationLearner(
            im.ImitationConfig.from_experiment(dataclasses.replace(
                dcfg, **cut), mode="dagger"),
            device=DEVICE, graph=graph),
        "n32k": lambda graph: il.LargeNImitationLearner(
            il.LargeNImitationConfig.from_experiment(dataclasses.replace(
                canon, n_agents=n_agents, buffer_size=LARGE_BUFFER,
                n_test_episodes=1, **cut), mode="dagger"),
            device=DEVICE, graph=graph)}
    out = {}
    for name, make in learners.items():
        graphed, eager = make(None), make(False)
        with tempfile.TemporaryDirectory() as tmp:
            state = os.path.join(tmp, "state.npz")
            eager.train(stop_after=1)
            lap(f"21 [{name}] eager round 1")
            eager.save_training_state(state)
            lap(f"21 [{name}] state save")
            eager.train(stop_after=2)
            lap(f"21 [{name}] eager round 2")
            _, launched = _counted(cc, lambda: graphed.train(stop_after=2))
            lap(f"21 [{name}] graph rounds 1-2")
            same = _same_training_state(torch, graphed, eager)
            graphed.load_training_state(state)
            captures = (im.UpdateProgram.captures,
                        im.DenseEpisodeProgram.captures)
            graphed.train(stop_after=2)
            resumed = (_same_training_state(torch, graphed, eager)
                       and captures == (im.UpdateProgram.captures,
                                        im.DenseEpisodeProgram.captures))
            lap(f"21 [{name}] resume")
        losses = [float(lrn.last_loss_sum) for lrn in (graphed, eager)]
        g = graphed._updates
        print(f"#   round [{name}]: 2 DAGGER rounds and the eval at episode "
              f"0, graph against eager: training state bit for bit {same}; "
              f"a resume of round 1's state into the learner that captured,"
              f" its round 2 again: bit for bit {resumed}; loss sums "
              f"{losses}; update program capture {g.capture_s:.3f} s, "
              f"instantiate {g.instantiate_s:.3f} s, pool "
              f"{g.pool_mb:.1f} MB; launches {launched}", flush=True)
        if not (same and resumed) or losses[0] != losses[1]:
            raise AssertionError(f"round [{name}] differs from the eager "
                                 f"loop")
        if any(launched.host.values()) and name == "dense":
            raise AssertionError(f"the dense round launched cell kernels: "
                                 f"{launched}")
        for what, learner in (("graph", graphed), ("eager", eager)):
            tm = learner.timing_summary()
            print(f"#   round [{name}] {what}: learner's timing over its "
                  f"rounds (first capture included): rollout "
                  f"{tm['rollout_ms_per_step']:.4f} ms per env step, "
                  f"{tm['update_ms_per_update']:.4f} ms per Adam update",
                  flush=True)
        # per Adam update of each loop: the eager learner's rounds', and
        # TRACE_UPDATES more replays traced
        _, *g_stats = _traced(torch, lambda: graphed._updates.run(
            TRACE_UPDATES, graphed.gen), TRACE_UPDATES, top=5)
        out.update(_loop_stats(f"{name}_adam", eager.timing_summary()[
            "update_ms_per_update"], g_stats, "update"))
        lap(f"21 [{name}] more updates, traced")
        if name == "dense":
            icfg = graphed.cfg
            steps = icfg.env.episode_steps

            def episode(graph):
                gen = torch.Generator(device=DEVICE).manual_seed(SEED + 50)
                return im.rollout_episode(
                    graphed.actor, gen, 0.5, graphed.env, icfg.actor,
                    mode="dagger", graph=graph)

            # per dense DAGGER episode step of each loop: one episode
            # eagerly, timed, and one through the graph, traced; the two
            # bit for bit
            runs = {}
            runs["eager"], e_s = _wall(torch, lambda: episode(False))
            runs["graph"], *g_stats = _traced(torch, lambda: episode(True),
                                              steps, top=5)
            out.update(_loop_stats("dense_episode", 1e3 * e_s / steps,
                                   g_stats))
            if not (torch.equal(runs["eager"][1], runs["graph"][1]) and all(
                    torch.equal(runs["eager"][0][k], runs["graph"][0][k])
                    for k in runs["eager"][0])):
                raise AssertionError("dense episode differs from the eager "
                                     "loop")
            lap("21 [dense] episode of each loop")
            prog = im.dense_program(graphed.env, icfg.actor, "dagger",
                                    icfg.n_rollout_envs, True, True,
                                    graphed._updates.device)
            print(f"#   round [dense] DAGGER episode program: capture "
                  f"{prog.capture_s:.3f} s, instantiate "
                  f"{prog.instantiate_s:.3f} s, pool {prog.pool_mb:.1f} MB",
                  flush=True)
            # the round's other costs: a one-env reset, a batched eval
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 51)
            for what, run in (
                    ("one-env reset", lambda: graphed.env.reset(gen, (1,))),
                    (f"{icfg.n_test_episodes}-episode eval, graph",
                     graphed.eval_rewards),
                    (f"{icfg.n_test_episodes}-episode eval, eager",
                     eager.eval_rewards)):
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t))
                print(f"#   round [dense] {what}: {walls} ms (3 calls)",
                      flush=True)
            lap("21 [dense] reset and eval walls")
        out[f"{name}_bit_for_bit"] = same and resumed
        del graphed, eager
    # the baseline's expert episode, each cfg/baseline.cfg section
    from multiagent_gnn_policies_tpu_torch.algos.baseline import (
        train_baseline)
    from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl

    ini = load_ini(BASELINE_CONFIG)
    for section in ini.sections():
        bcfg = ExperimentConfig.from_section(ini[section])
        env = tfl.make_env(bcfg.env, tfl.FlockingParams(
            n_agents=bcfg.n_agents, comm_radius=bcfg.comm_radius,
            dt=bcfg.dt, v_max=bcfg.v_max, episode_steps=bcfg.episode_steps))
        rewards = [im.rollout_episode(
            None, torch.Generator(device=DEVICE).manual_seed(bcfg.seed), 0.0,
            env, None, mode="expert", collect=False,
            n_envs=bcfg.n_test_episodes, centralized=bcfg.centralized,
            graph=graph).cpu().numpy() for graph in (False, True)]
        t = time.perf_counter()
        stats = train_baseline(bcfg, device=DEVICE)    # ends on the host
        wall = time.perf_counter() - t
        want = {"mean": float(rewards[0].mean()),
                "std": float(rewards[0].std())}
        same = np.array_equal(*rewards) and stats == want
        print(f"#   round: baseline [{section}] expert episode, graph against"
              f" eager: bit for bit {same} ({stats['mean']}); the trainer "
              f"replaying it {wall:.3f} s", flush=True)
        if not same:
            raise AssertionError(f"baseline [{section}] differs from the "
                                 f"eager loop")
        kind = "centralized" if bcfg.centralized else "decentralized"
        lap("21 baseline " + kind)
        out[f"baseline_{kind}_bit_for_bit"] = same
    return out


def _check_graph_launches(capture, replay, eager):
    """One 200-step K = 3 episode's launches (:func:`_counted`): through
    the graph at its capture (the reset, the warm-up and the replay on the
    device; the wrappers' calls the same: the reset, the warm-up and the
    recorded steps), through the graph replayed (201/200/200 on the
    device; the wrappers count the reset's K1 alone) and eagerly
    (201/200/200, wrappers and device alike)."""
    once = _launches(1)
    want = ((capture, _launches(1, captures=1), _launches(1, captures=1), 1),
            (replay, once, {"frame_sweep": 1, "apply_deg_sweep": 0,
                            "apply_sweep": 0}, 0),
            (eager, once, once, 0))
    for got, device, host, captures in want:
        if (got.device, got.host, got.captures) != (device, host, captures):
            raise AssertionError(f"launches {got}, want device {device}, "
                                 f"host {host}, {captures} captures")


def _loop_stats(what, eager_ms, graph, unit="step (reset included)"):
    """Prints and returns the phase line's fields of each loop: the eager
    loop's ms per ``unit``, ``eager_ms``, from a run the phase made
    anyway (its device busy ms, idle share and device ops "not measured":
    a trace of an eager loop of ~10^5 launches took up to 14 s of the
    run; PERF.md section 5 has the eager loops' traces), and the graph's:
    ``(busy ms, idle, ops, ms)`` per ``unit`` from one run under the
    profiler (:func:`_traced`; its ms under it); from a replay the phase
    traced for its launches, ``(None, None, None, ms)`` (that trace is
    read for the launches alone)."""
    fmt = lambda v, f: "not measured" if v is None else format(v, f)
    per = unit.split()[0]
    out = {}
    for name, (busy, idle, ops, ms) in (("eager", (None, None, None,
                                                   eager_ms)),
                                        ("graph", graph)):
        print(f"#   graph: {what}, {name}: {ms:.4f} ms per {unit}, device "
              f"busy {fmt(busy, '.4f')} ms per {per}, idle "
              f"{fmt(idle, '.4f')}, {fmt(ops, '.2f')} device ops per {per}",
              flush=True)
        out[f"{what}_{name}_ms_per_{per}"] = f"{ms:.4f}"
        out[f"{what}_{name}_idle"] = fmt(idle, ".4f")
    return out


def _section_actor_config(xcfg):
    """The section's policy config (evaluate_blocked's)."""
    from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig

    return ActorConfig(n_s=xcfg.n_states, n_a=xcfg.n_actions,
                       hidden=xcfg.hidden, k=xcfg.k, ind_agg=0)


def _transfer_section(load_ini, k, noiseless=False):
    """The ``cfg/transfer_stoch.cfg`` section of filter length ``k``;
    with ``noiseless`` its env is FlockingRelative (the same swarm and
    radius without the velocity noise), for runs held step by step."""
    section = load_ini(TRANSFER_CONFIG)[str(k)]
    if noiseless:
        section["env"] = "FlockingRelative-v0"
    return section


def _large_setup(ev, ln, cc, ExperimentConfig, section, n, steps=None):
    """(params, LargeNConfig, ActorConfig, actor) of ``section`` at ``n``
    agents, as ``evaluate_blocked`` builds them, with its checkpoint."""
    import dataclasses as dc

    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        ENV_REGISTRY, FlockingParams)
    from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig

    xcfg = ExperimentConfig.from_section(section)
    p = ENV_REGISTRY[xcfg.env](FlockingParams(
        n_agents=n, comm_radius=xcfg.comm_radius, dt=xcfg.dt,
        v_max=xcfg.v_max, episode_steps=xcfg.episode_steps))
    if steps is not None:
        p = dc.replace(p, episode_steps=steps)
    spec = cc.make_pcell_spec(p, cap=xcfg.cell_cap or 16,
                              margin=xcfg.cell_margin,
                              edge_mult=xcfg.cell_edge_mult)
    cfg = ln.LargeNConfig(params=p, cell_spec=spec,
                          centralized=xcfg.centralized)
    acfg = ActorConfig(n_s=xcfg.n_states, n_a=xcfg.n_actions,
                       hidden=xcfg.hidden, k=xcfg.k)
    return p, cfg, acfg, ev.load_actor(f"{TRANSFER_BASE}{xcfg.k}", acfg,
                                       DEVICE)


def transfer_kernels(torch, ev, ln, cc, bl, ExperimentConfig, load_ini,
                     gen, floor_ms, ptxas):
    """Phase 13 (a): the widths K = 4 adds, on a K = 4 step's own inputs
    at N (the transfer2_stoch4 policy, TRANSFER_STEPS steps from a lattice
    reset, the noiseless section): K2 at 18 columns (and at 6, K = 2's
    width) and K3 at 12 on the row-strided view the delayed stack passes,
    each against its plain version (REL_PLAIN) and timed beside it with
    its bound; those two equal to their 6-column slices launched alone,
    bit for bit; 24 columns in two counted chunks of each; and at N_ORACLE the whole K = 4
    stack of ystack_pre against the O(N²) delayed_ystack (REL_ORACLE).
    Prints the build's ``ptxas`` lines first. Returns ``({name: (ms,
    plain_ms, bound_ms, bound_by)}, {name: max abs err})``."""
    for line in ptxas_summary(ptxas):
        print(f"#   {line}", flush=True)
    section = _transfer_section(load_ini, 4, noiseless=True)
    p, cfg, acfg, actor = _large_setup(ev, ln, cc, ExperimentConfig,
                                       section, N)
    spec, r2cut = cfg.cell_spec, float(p.comm_radius) ** 2
    state = ln._episode_init(cfg, acfg, gen, DEVICE)
    state, _ = ln._scan_steps(cfg, actor, state, TRANSFER_STEPS, gen)
    if int(state.overflow):
        raise AssertionError(f"K = 4 steps at N={N}: overflow "
                             f"{int(state.overflow)}")
    x, grid, carry = state.x, state.grid, state.carry
    deg = state.fq.degree.contiguous()
    cols18 = ln._s0_cols(carry)                       # (N, 18) contiguous
    cols6 = carry.history[0]                          # K = 2's (N, 6)
    pos_h, deg_h, grid_h = carry.pos_hist[0], carry.deg_hist[0], \
        state.grid_hist[0]
    cols_h = state.s0.reshape(N, 3, 6)[:, 1:].reshape(N, 12)
    if cols_h.stride() != (18, 1):
        raise AssertionError(f"K3's view has strides {cols_h.stride()}")
    # K = 3's widths on the same input, to compare the widths
    cols12 = cols18[:, :12].contiguous()
    cols_h6 = state.s0.reshape(N, 3, 6)[:, 2]
    cases = {
        "K2 C=18": (lambda: cc.apply_deg_sweep(x, cols18, deg, grid, spec,
                                               r2cut),
                    lambda: cc.apply_deg_sweep_plain(x, cols18, deg, grid,
                                                     spec, r2cut)),
        "K2 C=6": (lambda: cc.apply_deg_sweep(x, cols6, deg, grid, spec,
                                              r2cut),
                   lambda: cc.apply_deg_sweep_plain(x, cols6, deg, grid,
                                                    spec, r2cut)),
        "K3 C=12": (lambda: cc.apply_sweep(pos_h, cols_h, deg_h, grid_h,
                                           spec, r2cut),
                    lambda: cc.apply_sweep_plain(pos_h, cols_h, deg_h,
                                                 grid_h, spec, r2cut)),
        "K2 C=12, this input": (
            lambda: cc.apply_deg_sweep(x, cols12, deg, grid, spec, r2cut),
            lambda: cc.apply_deg_sweep_plain(x, cols12, deg, grid, spec,
                                             r2cut)),
        "K3 C=6, this input": (
            lambda: cc.apply_sweep(pos_h, cols_h6, deg_h, grid_h, spec,
                                   r2cut),
            lambda: cc.apply_sweep_plain(pos_h, cols_h6, deg_h, grid_h,
                                         spec, r2cut)),
    }
    err = {name: check_close(f"{name} vs plain, K = 4 step, N={N}",
                             fn(), plain(), REL_PLAIN)
           for name, (fn, plain) in cases.items()}
    # K = 4's widths against their 6-column slices, each launched alone
    # through sweep_tile's 6-column kernels: each column's sum is the
    # same, bit for bit
    for name, c in (("K2 C=18", 18), ("K3 C=12", 12)):
        whole, slices = cases[name][0](), []
        for s in range(0, c, 6):
            if name.startswith("K2"):
                slices.append(cc.apply_deg_sweep(x, cols18[:, s:s + 6], deg,
                                                 grid, spec, r2cut))
            else:
                slices.append(cc.apply_sweep(pos_h, cols_h[:, s:s + 6],
                                             deg_h, grid_h, spec, r2cut))
        same = torch.equal(whole, torch.cat(slices, 1))
        print(f"#   {name} equals its {len(slices)} 6-column slices launched "
              f"alone, bit for bit: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name} differs from its 6-column slices")
    # 24 columns: two launches each (18 + 6), each chunk read in place
    cols24 = torch.cat([cols18, cols6], 1)
    chunked = {"K2": (lambda: cc.apply_deg_sweep(x, cols24, deg, grid, spec,
                                                 r2cut),
                      lambda: cc.apply_deg_sweep_plain(x, cols24, deg, grid,
                                                       spec, r2cut)),
               "K3": (lambda: cc.apply_sweep(pos_h, cols24, deg_h, grid_h,
                                             spec, r2cut),
                      lambda: cc.apply_sweep_plain(pos_h, cols24, deg_h,
                                                   grid_h, spec, r2cut))}
    for name, (fn, plain) in chunked.items():
        out, launches = _counted(cc, fn)
        want = "apply_deg_sweep" if name == "K2" else "apply_sweep"
        if (launches.by_cols[want] != {6: 1, 18: 1}
                or sum(launches.host.values()) != 2):
            raise AssertionError(f"{name} at 24 columns: {launches}")
        check_close(f"{name} C=24 in chunks of 18 and 6 vs plain", out,
                    plain(), REL_PLAIN)
    # the whole K = 4 stack at N_ORACLE against the O(N^2) oracle
    p4, cfg4, _, _ = _large_setup(ev, ln, cc, ExperimentConfig, section,
                                  N_ORACLE)
    s4 = ln._episode_init(cfg4, acfg, gen, DEVICE)
    s4, _ = ln._scan_steps(cfg4, actor, s4, 2 * TRANSFER_STEPS, gen)
    y = ln._ystack(cfg4, s4)
    ref = bl.delayed_ystack(s4.carry, s4.x[:, :2], p4, block=512,
                            deg_now=s4.fq.degree)
    if y.shape != (4, N_ORACLE, 6) or not bool((ref[3] != 0).any()):
        raise AssertionError(f"K = 4 stack {tuple(y.shape)}, slot 3 zero")
    check_close(f"K = 4 ystack_pre vs delayed_ystack, N={N_ORACLE}",
                y.transpose(0, 1).reshape(N_ORACLE, -1),
                ref.transpose(0, 1).reshape(N_ORACLE, -1), REL_ORACLE)
    # times beside the plain versions and the bound of this input
    cand, nbr = pair_counts(x[:, :2], grid, spec, r2cut)
    cand_h, nbr_h = pair_counts(pos_h, grid_h, spec, r2cut)
    nb, nb_h = neighbour_bytes(grid, spec), neighbour_bytes(grid_h, spec)
    work = {"K2 C=18": apply_work(N, 18, cand, nbr, nb, False),
            "K2 C=6": apply_work(N, 6, cand, nbr, nb, False),
            "K3 C=12": apply_work(N, 12, cand_h, nbr_h, nb_h, True),
            "K2 C=12, this input": apply_work(N, 12, cand, nbr, nb, False),
            "K3 C=6, this input": apply_work(N, 6, cand_h, nbr_h, nb_h,
                                             True)}
    timing = {}
    for name, (fn, plain) in cases.items():
        ms, plain_ms = device_ms(fn), device_ms(plain)
        b_ms, b_by = bound_ms(*work[name])
        timing[name] = (ms, plain_ms, b_ms, b_by)
        print(f"#   {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {work[name][0]} B, "
              f"{work[name][1]} ops; launch floor {floor_ms:.4f} ms",
              flush=True)
    print(f"#   this input: radius {p.comm_radius}, {cand} candidate and "
          f"{nbr} neighbour pairs (historical graph {cand_h}, {nbr_h})",
          flush=True)
    return timing, err


def transfer_eval(torch, ev, cc, ExperimentConfig, n_agents, episodes,
                  extra=(), traced=False):
    """``evaluate cfg/transfer_stoch.cfg --actor-base ... --n-agents
    n_agents --episodes episodes`` through the CLI's main, each section's
    ``evaluate_blocked`` call counted by :func:`_counted` (``traced``: the
    device's launches from a trace). Returns ``{K: (stats, Launched, ms
    per step)}`` (ms with the reset, the checkpoint's load and the capture,
    and with ``traced`` the profiler); an overflow exits 3
    (evaluate_blocked's gate)."""
    per, orig = {}, ev.evaluate_blocked

    def counted(section, path, **kw):
        stats, launches = _counted(cc, lambda: orig(section, path, **kw),
                                   traced)
        steps = episodes * ExperimentConfig.from_section(
            section).episode_steps
        per[int(section.name)] = (stats, launches,
                                  1e3 * launches.seconds / steps)
        return stats

    ev.evaluate_blocked = counted
    try:
        ev.main([TRANSFER_CONFIG, "--actor-base", TRANSFER_BASE,
                 "--n-agents", str(n_agents), "--episodes", str(episodes),
                 "--per-episode", "--device", DEVICE, *extra])
    finally:
        ev.evaluate_blocked = orig
    return per


def transfer_parity(torch, ev, ln, cc, ExperimentConfig, load_ini, gen):
    """Phase 13 (c): one PARITY_STEPS-step episode at N_ORACLE of K = 4 and
    of K = 1 under the noiseless section, from an x0 drawn on the card,
    on the card and through the plain versions on the CPU: rewards and
    final states within REL_EPISODE."""
    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        _init_candidate)

    err = 0.0
    for k in (4, 1):
        section = _transfer_section(load_ini, k, noiseless=True)
        p, cfg, acfg, actor = _large_setup(ev, ln, cc, ExperimentConfig,
                                           section, N_ORACLE, PARITY_STEPS)
        x0 = _init_candidate(gen, p, DEVICE)
        kw = dict(cap=cfg.cell_spec.cap, return_overflow=True)
        got = ln.rollout_large(actor, acfg, None, p, x0=x0, device=DEVICE,
                               **kw)
        cpu_actor = copy.deepcopy(actor).cpu()
        want = ln.rollout_large(cpu_actor, acfg, None, p, x0=x0.cpu(),
                                device="cpu", **kw)
        if int(got[2]) or int(want[2]):
            raise AssertionError(f"K = {k} parity episode overflowed")
        err = max(err, check_close(
            f"K = {k} episode card vs CPU, rewards ({PARITY_STEPS} steps, "
            f"N={N_ORACLE})", got[0].cpu()[:, None], want[0][:, None],
            REL_EPISODE))
        err = max(err, check_close(f"K = {k} episode card vs CPU, final x",
                                   got[1].cpu(), want[1], REL_EPISODE))
    return err


def transfer_dense(torch, ev, cc, load_ini):
    """Phase 13 (d): ``evaluate cfg/transfer_stoch.cfg --actor-base ...``
    with no ``--n-agents``: the dense route at the sections' N = 50, 20
    episodes each, each mean in its TRANSFER_DENSE_BANDS band, no cell
    kernel launched; then one ``--save-trajectory`` file of section [4]
    in a temporary directory, its keys and shapes checked."""
    per, orig = {}, ev.evaluate_section

    def timed(section, path, **kw):
        t = time.perf_counter()
        stats = orig(section, path, **kw)
        per[int(section.name)] = (stats, time.perf_counter() - t)
        return stats

    ev.evaluate_section = timed
    cc.reset_launch_counts()
    try:
        ev.main([TRANSFER_CONFIG, "--actor-base", TRANSFER_BASE,
                 "--device", DEVICE])
    finally:
        ev.evaluate_section = orig
    if any(cc.launch_counts().values()):
        raise AssertionError(f"the dense route launched cell kernels: "
                             f"{cc.launch_counts()}")
    for k, (stats, wall) in sorted(per.items(), reverse=True):
        print(f"#   transfer dense: K = {k}, N = 50, "
              f"{len(stats['rewards'])} episodes: {stats['mean']} +- "
              f"{stats['std']} ({wall:.3f} s)", flush=True)
        _in_band(f"dense transfer K = {k}", stats["mean"],
                 TRANSFER_DENSE_BANDS[k])
    lap("13 (d) dense route")
    # the --save-trajectory dump through its program, then eagerly
    import numpy as np
    import torch

    from multiagent_gnn_policies_tpu_torch.algos import imitation as im

    program, seen = im.rollout_trajectory, {}

    def dump(graph):
        def traj(actor, gen, env, acfg, x0=None):
            res, wall = _wall(torch, lambda: program(actor, gen, env, acfg,
                                                     x0, graph=graph))
            seen.update(env=env, acfg=acfg, wall=wall)
            return res
        return traj

    with tempfile.TemporaryDirectory() as tmp:
        section = load_ini(TRANSFER_CONFIG)["4"]
        k, ckpt = ev.section_checkpoint(section, None, TRANSFER_BASE, None)
        paths, walls = {}, {}
        captures = im.TrajectoryProgram.captures
        for name, graph in (("graph", None), ("replay", None),
                            ("eager", False)):
            paths[name] = os.path.join(tmp, f"{name}.npz")
            im.rollout_trajectory = dump(graph)
            try:
                orig(section, ckpt, k=k, traj_path=paths[name],
                     device=DEVICE)
            finally:
                im.rollout_trajectory = program
            walls[name] = seen["wall"]
            _check_trajectory(paths[name], {"x": (200, 50, 4),
                                            "reward": (200,)})
        same = True
        for name in ("graph", "replay"):
            with np.load(paths[name]) as a, np.load(paths["eager"]) as b:
                same &= all(np.array_equal(a[key], b[key])
                            for key in a.files)
    lap("13 (d) trajectory dumps")
    captured = im.TrajectoryProgram.captures - captures
    prog = im.trajectory_program(seen["env"], seen["acfg"],
                                 torch.device("cuda",
                                              torch.cuda.current_device()))
    print(f"#   transfer dense: --save-trajectory of section [4] (200 "
          f"steps, N = 50) through its program (a capture, a replay) and "
          f"eagerly: bit for bit {same}, programs captured {captured} "
          f"(capture {prog.capture_s:.3f} s, instantiate "
          f"{prog.instantiate_s:.3f} s, {prog.nodes} nodes); the dump's "
          + ", ".join(f"{n} {1e3 * w / 200:.4f}" for n, w in walls.items())
          + " ms per step (reset included)", flush=True)
    if not same or captured != 1:
        raise AssertionError(f"the trajectory dump: bit for bit {same}, "
                             f"captures {captured}")
    return {k: stats["mean"] for k, (stats, _) in per.items()}


def _check_trajectory(path, shapes):
    import numpy as np

    with np.load(path) as z:
        got = {key: z[key].shape for key in z.files}
        if got != shapes or not all(np.isfinite(z[key]).all()
                                    for key in z.files):
            raise AssertionError(f"trajectory {got} != {shapes} or not "
                                 f"finite")


def transfer_phase(torch, ev, ln, cc, bl, ExperimentConfig, load_ini,
                   ptxas):
    """Phase 13, this slice's main path: (a) the new widths, (b) the
    full-width cross-K evaluation at N and the N_ORACLE check against the
    JAX package's means, (c) card against CPU at K = 4 and K = 1, (d) the
    dense route. Returns the kernel timings and errors of (a) and the
    launches by width of (b)'s N = 32,768 run, summed over its sections."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    with torch.no_grad():
        timing, err = transfer_kernels(torch, ev, ln, cc, bl,
                                       ExperimentConfig, load_ini, gen,
                                       floor_ms, ptxas)
    lap("13 (a) widths")
    # (b) the main path: every K at N, one episode per section
    per = transfer_eval(torch, ev, cc, ExperimentConfig, N, 1, traced=True)
    lap("13 (b) every K at N = 32,768, traced")
    total = {}
    for k, (stats, launches, ms) in sorted(per.items(), reverse=True):
        want = _launches(1, captures=launches.captures, per_step=dict(zip(
            ("frame_sweep", "apply_deg_sweep", "apply_sweep"),
            (1, *(n // 200 for n in TRANSFER_LAUNCHES[k][1:])))))
        print(f"#   transfer: K = {k}, N = {N}: {stats['mean']}, overflow "
              f"{stats['overflow']}, launches {launches}, {ms:.4f} ms per "
              f"step (reset, load and capture included, under the "
              f"profiler)", flush=True)
        if (launches.device != want or stats["overflow"]
                or not math.isfinite(stats["mean"])):
            raise AssertionError(f"K = {k}: {stats}, launches {launches} "
                                 f"!= {want}")
        for fn, cols in launches.by_cols.items():
            for c, count in cols.items():
                total[fn, c] = total.get((fn, c), 0) + count
    # the same evaluation at N_ORACLE against the JAX package's means
    small = transfer_eval(torch, ev, cc, ExperimentConfig, N_ORACLE,
                          TRANSFER_EPISODES)
    # and its --save-trajectory file, from section [4] alone, one episode
    # (cut in depth: every section's first episode recorded it, each
    # through a program of its own)
    with tempfile.TemporaryDirectory() as tmp:
        ini = load_ini(TRANSFER_CONFIG)
        for name in ini.sections():
            if name != "4":
                ini.remove_section(name)
        one, traj = os.path.join(tmp, "k4.cfg"), os.path.join(tmp, "k4.npz")
        with open(one, "w") as f:
            ini.write(f)
        ev.main([one, "--actor-base", TRANSFER_BASE, "--n-agents",
                 str(N_ORACLE), "--episodes", "1", "--save-trajectory", traj,
                 "--device", DEVICE])
        _check_trajectory(traj, {"x": (200, 2000, 4), "reward": (200,),
                                 "final_x": (N_ORACLE, 4),
                                 "subset_indices": (2000,)})
    lap("13 (b) every K at N = 4,096")
    for k, (stats, _, ms) in sorted(small.items(), reverse=True):
        print(f"#   transfer: K = {k}, N = {N_ORACLE}, {TRANSFER_EPISODES} "
              f"episodes: {stats['mean']} +- {stats['std']}, overflow "
              f"{stats['overflow']}, {ms:.4f} ms per step", flush=True)
        if stats["overflow"]:
            raise AssertionError(f"K = {k} at N={N_ORACLE} overflowed")
        _in_band(f"transfer K = {k} at N={N_ORACLE}", stats["mean"],
                 TRANSFER_LARGE_BANDS[k])
    # the K = 4 rewards to every digit: K2 at 18 columns and K3 at 12 carry
    # every K = 4 step, so a change of their sums shows here
    for n_agents, res in ((N, per), (N_ORACLE, small)):
        print(f"#   transfer K = 4 rewards, N = {n_agents}: "
              f"{[repr(float(r)) for r in res[4][0]['rewards']]}",
              flush=True)
    with torch.no_grad():
        parity_err = transfer_parity(torch, ev, ln, cc, ExperimentConfig,
                                     load_ini, gen)
    lap("13 (c) card against CPU")
    dense = transfer_dense(torch, ev, cc, load_ini)
    means = {k: per[k][0]["mean"] for k in per}
    ms = {k: per[k][2] for k in per}
    return timing, err, total, means, ms, parity_err, dense


def _ddpg_file(name):
    return os.path.join(ROOT, "models", f"actor_FlockingRelative-v0_{name}")


def ddpg_eval_phase(torch, ev, load_ini):
    """Phase 14 (a): each in-repo DDPG checkpoint under its section, 100
    greedy episodes as one batch through the evaluate CLI's DDPG route,
    each mean within its band; then the CLI's ``main`` on ``cfg/ddpg.cfg``
    with its own 10 episodes per section: finite rows."""
    import contextlib
    import io

    out = {}
    for config, name, ckpt, band in DDPG_EVALS:
        section = load_ini(DDPG_CONFIGS[config])[name]
        section["n_test_episodes"] = str(DDPG_EVAL_EPISODES)
        t = time.perf_counter()
        stats = ev.evaluate_section(section, _ddpg_file(ckpt) + ".npz",
                                    device=DEVICE)
        wall = time.perf_counter() - t
        print(f"#   ddpg eval: {ckpt} under {config}.cfg [{name}], "
              f"{DDPG_EVAL_EPISODES} episodes: {stats['mean']} +- "
              f"{stats['std']} (band {band[0]} +- {band[1]}), {wall:.3f} s",
              flush=True)
        _in_band(f"{ckpt} eval mean", stats["mean"], band)
        out[ckpt] = stats["mean"]
        lap("14 (a) " + ckpt)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev.main([DDPG_CONFIGS["ddpg"], "--actor-path",
                 _ddpg_file("ddpg_k2") + ".npz"])
    rows = [line.split(",") for line in buf.getvalue().splitlines()]
    print(f"#   ddpg eval: evaluate cfg/ddpg.cfg --actor-path ddpg_k2.npz "
          f"printed {rows}", flush=True)
    if rows[0] != ["reward"] or [r[0] for r in rows[1:]] != [
            "test", "test_unbounded"] or not all(
            math.isfinite(float(v)) for r in rows[1:] for v in r[1:]):
        raise AssertionError(f"evaluate CLI rows {rows}")
    lap("14 (a) the CLI's main")
    return out


def _ddpg_batch(torch, tfl, dcfg, large, seed):
    """A gradient step's batch of ``batch_size`` records drawn with numpy:
    K states per record (uniform disc positions, uniform velocities) give
    the feature history and the delayed graphs through the dense observe,
    the newest one an action drawn in [-1, 1] and the next state, its
    features, graph and reward; on the CPU."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p, k = dcfg.env, dcfg.actor.k
    b, n = dcfg.batch_size, p.n_agents
    radius = math.sqrt(p.arena_r2_per_agent * n)

    def draw():
        rad = radius * np.sqrt(rng.uniform(size=(b, n)))
        ang = rng.uniform(0, 2 * math.pi, size=(b, n))
        vel = rng.uniform(-p.v_max, p.v_max, size=(b, n, 2))
        return torch.from_numpy(np.concatenate(
            [np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1), vel],
            -1).astype(np.float32))

    xs = [draw() for _ in range(k)]                # newest first
    obs = [tfl.observe(x, p) for x in xs]
    action = torch.from_numpy(rng.uniform(-1, 1, (b, n, 2)).astype(
        np.float32))
    x_next = tfl.dynamics(xs[0], action, p)
    nxt = tfl.observe(x_next, p)
    batch = {"next_values": nxt.values, "action": action,
             "reward": tfl.reward(x_next),
             "notdone": torch.from_numpy((rng.uniform(size=b) < 0.9).astype(
                 np.float32))}
    hist = torch.stack([o.values for o in obs], 1)
    if large:
        batch["notdone"] = torch.ones(b)
        return {**batch, "hist": hist, "next_pos": x_next[..., :2],
                "pos": torch.stack([x[..., :2] for x in xs[:max(k - 1, 1)]],
                                   1)}
    gso = [torch.eye(n).expand(b, n, n)]
    for j in range(k - 1):
        gso.append(gso[-1] @ obs[j].network)
    return {**batch, "delay_state": hist, "delay_gso": torch.stack(gso, 1),
            "network": obs[0].network, "next_network": nxt.network}


def _ddpg_step_tensors(learner):
    """Every tensor a gradient step updates: the four networks and both
    Adam states, by name."""
    out = {}
    for name, m in learner._modules().items():
        out.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    for name, tree in learner._opt_trees().items():
        for i, st in tree.items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()
                        if k != "step"})
    return out


def _gn_cancelled(learner):
    """Names of the tensors whose gradient is zero up to rounding: with
    GroupNorm a hidden critic layer's bias shifts every agent alike and
    the normalisation subtracts it again; Adam scales the rounding noise
    to a step of up to ADAM_STEP_MAX · lr, so these are held to twice
    that, their Adam moments not at all."""
    cfg = learner.cfg.critic
    if not cfg.use_groupnorm:
        return set(), set()
    names = [n for n, _ in learner.critic.named_parameters()]
    biases = {f"layers.{i}.bias" for i in range(cfg.n_layers - 1)}
    held = {f"{m}.{b}" for m in ("critic", "critic_target") for b in biases}
    moments = {f"critic_opt.{i}.{k}" for i, n in enumerate(names)
               if n in biases for k in ("exp_avg", "exp_avg_sq")}
    return held, moments


def ddpg_step_parity(torch, dd, dl, tfl, tti, load_actor_npz,
                     load_critic_npz, ExperimentConfig, load_ini, config,
                     section, files, large):
    """Phase 14 (b): one gradient step from the in-repo actor and critic
    ``files`` (targets their copies) on one numpy-drawn batch, on the card
    and on the CPU: both losses (the actor's, a mean of Q values of both
    signs, to 1e-4 of the largest Q) and every updated tensor within
    REL_STEP of its largest magnitude. The same step with TF32 allowed is
    printed beside it."""
    xcfg = ExperimentConfig.from_section(load_ini(DDPG_CONFIGS[config])[
        section])
    dcfg = dd.DDPGConfig.from_experiment(xcfg)
    if large:
        dcfg = dataclasses.replace(dcfg, env=dataclasses.replace(
            dcfg.env, n_agents=DDPG_PARITY_N))
    dcfg = dataclasses.replace(dcfg, buffer_size=dcfg.batch_size + 1)
    cls = dl.DDPGLarge if large else dd.DDPG
    actor = tti.actor_params_from_numpy(load_actor_npz(files + ".npz",
                                                       dcfg.actor))
    critic = tti.critic_params_from_numpy(load_critic_npz(
        files + "_critic.npz", dcfg.critic))
    batch = _ddpg_batch(torch, tfl, dcfg, large, SEED + 2)

    def step(device, tf32=False):
        lrn = cls(dcfg, device=device)       # sets strict fp32
        for name, sd in (("actor", actor), ("actor_target", actor),
                         ("critic", critic), ("critic_target", critic)):
            getattr(lrn, name).load_state_dict(sd)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        b = {k: v.to(device) for k, v in batch.items()}
        c, a = lrn.gradient_step(b)
        (hist, ga, gc), _ = lrn._graphs(b)
        with torch.no_grad():
            q_max = float(lrn._q(lrn.critic, hist[:, 0],
                                 lrn._pi(lrn.actor, hist, ga),
                                 gc).abs().max())
        return lrn, float(c), float(a), q_max

    want, c_want, a_want, q_max = step("cpu")
    got, c_got, a_got, _ = step(DEVICE)
    held, skipped = _gn_cancelled(want)
    w_t, g_t = _ddpg_step_tensors(want), _ddpg_step_tensors(got)

    def worst(g_tensors):
        rel = 0.0
        for k, w in w_t.items():
            if k in held or k in skipped:
                continue
            err = float((g_tensors[k].cpu().double() - w.double()).abs()
                        .max())
            rel = max(rel, err / max(float(w.abs().max()), 1e-30))
        return rel

    rel = worst(g_t)
    lr_bound = 2 * ADAM_STEP_MAX * dcfg.critic_lr
    lr_err = max((float((g_t[k].cpu() - w_t[k]).abs().max())
                  for k in held), default=0.0)
    what = (f"{'DDPGLarge' if large else 'DDPG'} step, {config}.cfg "
            f"[{section}] at N = {dcfg.env.n_agents}, B = {dcfg.batch_size}")
    print(f"#   {what}: card vs CPU, losses {c_got} / {c_want} (critic), "
          f"{a_got} / {a_want} (actor); every updated tensor within "
          f"{rel:.3g} of its largest magnitude (tolerance {REL_STEP}); "
          f"{len(held)} GroupNorm-cancelled biases within {lr_err:.3g} "
          f"(bound {lr_bound:.3g})", flush=True)
    if (abs(c_got - c_want) > REL_STEP * abs(c_want)
            or abs(a_got - a_want) > REL_STEP * q_max or rel > REL_STEP
            or lr_err > lr_bound):
        raise AssertionError(f"{what}: card and CPU differ")
    try:
        tf32 = step(DEVICE, tf32=True)[0]
        print(f"#   {what} with TF32 allowed (not checked): max rel error "
              f"against the CPU {worst(_ddpg_step_tensors(tf32)):.3g}",
              flush=True)
    finally:
        tfl.strict_fp32()
    lap(f"14 (b) {config}, card and CPU")
    return rel


def _same_training_state(torch, a, b):
    """Whether two learners' training states are equal bit for bit."""
    import numpy as np

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    fa, fb = dict(flat(a.training_state())), dict(flat(b.training_state()))
    if sorted(fa) != sorted(fb):
        return False
    return all(torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor)
               else np.array_equal(fa[k], fb[k]) for k in fa)


def ddpg_train_phase(torch, dd, dl, tfl, ExperimentConfig, load_ini, config,
                     section, episodes, resume, steps=None):
    """Phase 14 (c) and (d). (c) ``episodes`` training episodes of
    ``config`` at full width through the learner's ``train`` (routed as
    the train CLI routes; the episodes through the learner's CUDA graphs,
    the default), finite rewards and losses per episode and a finite
    eval; ms per env step with its gradient steps; with ``resume``, the
    state of a run stopped after ``episodes - 1`` episodes (saved to a
    temporary directory by an eager learner) resumed by a fresh learner
    and by the learner whose graphs were captured: each one's training
    state (networks, targets, Adam, buffer, generator) equals the
    uninterrupted run's bit for bit, and the second captures nothing
    new; then one more episode under torch.profiler, the program's
    replay and the reset annotated. (d) :func:`ddpg_graph_check` against
    the eager twin; the graph's ms, busy ms, idle share and device ops
    per step are the profiled episode's, the eager loop's ms per step its
    last episode's (cut in depth: no more episodes of each loop to time
    them). Returns (ms per step, resumed, (d)'s fields)."""
    from multiagent_gnn_policies_tpu_torch.utils import graphs

    xcfg = ExperimentConfig.from_section(load_ini(DDPG_CONFIGS[config])[
        section])
    if steps is not None:
        xcfg = dataclasses.replace(xcfg, episode_steps=steps)
    dcfg = dd.DDPGConfig.from_experiment(xcfg)
    large = xcfg.trainer == "large" or (xcfg.trainer == "auto"
                                        and xcfg.n_agents > 1024)
    cls = dl.DDPGLarge if large else dd.DDPG
    log = _Events()
    full = cls(dcfg, log, device=DEVICE)
    eager = cls(dcfg, device=DEVICE, graph=False)
    per = []
    for e in range(1, episodes + 1):
        s0, n0 = full.timing["s"], full.timing["steps"]
        full.train(stop_after=e)
        ep = {k: float(v) for k, v in full.last_episode.items()}
        ep["ms_per_step"] = 1e3 * (full.timing["s"] - s0) / (
            full.timing["steps"] - n0)
        per.append(ep)
        lap(f"14 (c) {config} graph episode {e}")
    same = None
    with tempfile.TemporaryDirectory() as tmp:
        # the eager twin: with ``resume``, stopped one episode early with
        # its state saved (cut in depth: no third learner reruns those
        # episodes to save it), then on through its last episode, timed
        state = os.path.join(tmp, "state.npz")
        if not eager.train(state_path=state if resume else None,
                           stop_after=episodes - 1)["interrupted"]:
            raise AssertionError("the stopped run did not stop")
        s0, n0 = eager.timing["s"], eager.timing["steps"]
        eager.train(stop_after=episodes)
        eager_ms = 1e3 * (eager.timing["s"] - s0) / (
            eager.timing["steps"] - n0)
        lap(f"14 (d) {config} eager twin")
        if resume:
            state_mb = os.path.getsize(state) / 2**20
            # the learner that captured first: the fresh learner's
            # train writes its own state over the file when it stops
            captures = graphs.Program.captures
            full.load_training_state(state)
            full.train(stop_after=episodes)
            captured = (_same_training_state(torch, full, eager)
                        and graphs.Program.captures == captures)
            rest = cls(dcfg, device=DEVICE)
            rest.train(state_path=state, stop_after=episodes)
            fresh = _same_training_state(torch, rest, eager)
            del rest
            same = fresh and captured
            print(f"#   ddpg train: {config}: episode {episodes} resumed "
                  f"from the state of an eager run stopped before it, "
                  f"against the uninterrupted run: training state bit for "
                  f"bit {fresh} in a fresh learner, {captured} in the "
                  f"learner that captured (no new capture) (state file "
                  f"{state_mb:.1f} MiB)", flush=True)
            if not same:
                raise AssertionError(f"{config}: the resumed run differs")
            lap(f"14 (c) {config} resume")
    # (d), whose eval through the program (after the resume check: an
    # eval draws from the generator) is (c)'s eval after training
    graph, rewards = ddpg_graph_check(torch, config, full, eager, per)
    mean, std = float(rewards.mean()), float(rewards.std())
    evals = [f for ev_, f in log.events if ev_ == "eval"]
    steps = dcfg.env.episode_steps
    print(f"#   ddpg train: {config}.cfg [{section}] ({cls.__name__}, "
          f"N = {dcfg.env.n_agents}, batch {dcfg.batch_size}, buffer "
          f"{dcfg.buffer_size}), {episodes} episodes of {steps} steps, "
          f"{full.timing['updates']} gradient steps; eval at episode 0 "
          f"{evals[0]['reward_mean']}, after {episodes}: {mean} +- {std}",
          flush=True)
    for i, ep in enumerate(per):
        print(f"#   ddpg train: episode {i}: reward {ep['reward']:.4f}, "
              f"critic loss sum {ep['critic_loss']:.6g}, actor loss sum "
              f"{ep['actor_loss']:.6g}, {ep['ms_per_step']:.4f} ms per env "
              f"step (a capture's included)", flush=True)
    if not all(math.isfinite(v) for ep in per for v in ep.values()) or not (
            math.isfinite(mean) and math.isfinite(evals[0]["reward_mean"])):
        raise AssertionError(f"{config}: non-finite episode or eval {per}")
    if per[-1]["critic_loss"] == 0.0:
        raise AssertionError(f"{config}: no gradient step in the last "
                             f"episode")
    from torch.profiler import ProfilerActivity, profile, record_function

    # a replay calls none of the step's functions: the program's run and
    # the eager reset before it are the episode's layers
    targets = [(dd.DDPG, "_run_program", "episode program (replay)"),
               (cls, "_start", "reset")]
    with _Annotated(record_function, targets), profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        full.train(stop_after=full._ep + 1)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t) / steps
    print(f"#   ddpg trace: {config}.cfg, one episode, per env step with its "
          f"gradient step", flush=True)
    s = summarize_trace(trace_events(prof), steps, prof_wall_ms,
                        prof_wall_ms)
    lap(f"14 (c) {config} profiled episode")
    graph.update(_loop_stats(config, eager_ms, (None, None, None,
                                                prof_wall_ms) if s is None
                             else (s["busy_ms"], s["idle"],
                                   s["ops_per_step"], prof_wall_ms)))
    return per[-1]["ms_per_step"], same, graph


def ddpg_graph_check(torch, config, full, eager, per):
    """Phase 14 (d): the learner's CUDA graphs (``full``, after (c)'s
    episodes: one program per gate step the run met) against its eager
    twin (``graph=False``) that ran the same episodes: the last episode's
    summed reward and losses and the training state bit for bit; each
    program's capture and instantiate seconds and pool MB; the eval
    (``n_test_episodes`` episodes) through its
    program and eagerly, its wall and rewards bit for bit; then one more
    episode's replay behind its eager reset under CUDA's sync debug mode
    "error": finite sums, no new capture. Returns the phase line's
    fields and the eval's rewards through the program."""
    from multiagent_gnn_policies_tpu_torch.utils import graphs

    steps = full.cfg.env.episode_steps
    sums = [torch.stack([lrn.last_episode[k] for k in (
        "reward", "critic_loss", "actor_loss")]) for lrn in (full, eager)]
    same = (torch.equal(*sums)
            and _same_training_state(torch, full, eager))
    print(f"#   ddpg graph: {config}: {len(per)} episodes through the graphs "
          f"and eagerly: summed reward and losses {sums[0].tolist()} and "
          f"the training state bit for bit {same}", flush=True)
    for key, prog in full._programs.items():
        print(f"#   ddpg graph: {config}: program of gate step {key[0]} "
              f"(T = {steps}): capture {prog.capture_s:.3f} s, instantiate "
              f"{prog.instantiate_s:.3f} s, pool {prog.pool_mb:.1f} MB",
              flush=True)
    if not same:
        raise AssertionError(f"{config}: the graphs differ from the eager "
                             f"loop")
    import numpy as np

    walls, rewards = {}, {}
    for what, lrn in (("graph", full), ("eager", eager)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rewards[what] = lrn.eval_rewards()
        walls[what] = 1e3 * (time.perf_counter() - t)
    same_eval = np.array_equal(rewards["graph"], rewards["eager"])
    print(f"#   ddpg graph: {config}: {full.cfg.n_test_episodes}-episode "
          f"eval (resets included), graph {walls['graph']:.3f} ms (captured "
          f"at episode 0's eval), eager {walls['eager']:.3f} ms; rewards bit "
          f"for bit {same_eval}", flush=True)
    if not same_eval:
        raise AssertionError(f"{config}: the eval graph differs")
    lap(f"14 (d) {config} evals")
    # last: the eager twin runs no more episodes
    captures = graphs.Program.captures
    start = full._start()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = full._run_program(start, None, None, full._gate_opens())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    synced = (bool(torch.isfinite(got).all())
              and graphs.Program.captures == captures)
    print(f"#   ddpg graph: {config}: one more episode's replay under sync "
          f"debug mode \"error\" (behind its eager reset): {got.tolist()}, "
          f"no new capture {synced}", flush=True)
    if not synced:
        raise AssertionError(f"{config}: the replay under sync debug mode")
    lap(f"14 (d) {config} sync debug replay")
    return {f"{config}_graph_bit_for_bit": same and same_eval,
            f"{config}_eval_graph_ms": f"{walls['graph']:.3f}",
            f"{config}_eval_eager_ms": f"{walls['eager']:.3f}"}, rewards[
                "graph"]


def ddpg_phase(torch, ev, cc, ExperimentConfig, load_ini):
    """Phase 14: DDPG on the card. (a) the in-repo checkpoints, (b) one
    gradient step card vs CPU for each learner and critic kind, (c)
    training at full width with resumes and a profiled episode, (d) the
    learners' CUDA graphs against their eager twins. The cell kernels'
    counters, zeroed before, must read 0 after."""
    from multiagent_gnn_policies_tpu_torch.algos import ddpg as dd
    from multiagent_gnn_policies_tpu_torch.algos import ddpg_large as dl
    from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
    from multiagent_gnn_policies_tpu_torch.models import torch_import as tti
    from multiagent_gnn_policies_tpu_torch.utils.checkpoint import (
        load_actor_npz, load_critic_npz)

    cc.reset_launch_counts()
    means = ddpg_eval_phase(torch, ev, load_ini)
    parity = max(
        ddpg_step_parity(torch, dd, dl, tfl, tti, load_actor_npz,
                         load_critic_npz, ExperimentConfig, load_ini,
                         config, section, _ddpg_file(files), large)
        for config, section, files, large in (
            ("ddpg_toy", "test", "ddpg_toy_k2", False),
            ("ddpg", "test", "ddpg_k2", False),
            ("ddpg_n4k", "n4k", "ddpg_toy_k2", True)))
    speed, resumed, graph = {}, {}, {}
    for config, section, episodes, resume, steps in DDPG_TRAIN:
        speed[config], resumed[config], fields = ddpg_train_phase(
            torch, dd, dl, tfl, ExperimentConfig, load_ini, config, section,
            episodes, resume, steps)
        graph.update(fields)
    launches = cc.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the DDPG paths launched cell kernels: "
                             f"{launches}")
    return means, parity, speed, resumed, graph


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    # 1. device
    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from multiagent_gnn_policies_tpu_torch import evaluate as ev
    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        FlockingParams, _init_candidate, strict_fp32)
    from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig
    from multiagent_gnn_policies_tpu_torch.ops import _build
    from multiagent_gnn_policies_tpu_torch.ops import blocked as bl
    from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as ln
    from multiagent_gnn_policies_tpu_torch.utils.config import (
        ExperimentConfig, load_ini)

    strict_fp32()
    dev = torch.device(DEVICE)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    phase("device", t, imports_s=f"{T0 - T_START:.2f}",
          torch_name=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    # 2. build, and beside it the profiler's start-up
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(_build.build)
        profiler_s = profiler_start_up(torch, dev)
        built = building.result()
    _build.library()
    for line in ptxas_summary(built.ptxas):
        print(f"#   {line}", flush=True)
    phase("build", t, nvcc_seconds=f"{built.seconds:.2f}",
          profiler_start_up_s=f"{profiler_s:.2f}",
          library=os.path.relpath(built.path, ROOT))

    # 3. kernels at this slice's shapes, after 3 policy steps
    t = time.perf_counter()
    p = FlockingParams(n_agents=N)
    acfg = ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=3)
    actor = ev.load_actor(CHECKPOINT, acfg, dev)
    spec = cc.make_pcell_spec(p)
    cfg = ln.LargeNConfig(params=p, cell_spec=spec, centralized=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        state = ln._episode_init(cfg, acfg, gen, dev)
        state, _ = ln._scan_steps(cfg, actor, state, 3, gen)
        if int(state.overflow):
            raise AssertionError(f"overflow {int(state.overflow)} at N={N}")
        x, grid, carry = state.x, state.grid, state.carry
        cols = ln._s0_cols(carry).contiguous()                  # (N, 12)
        # K3's inputs as ystack_pre hands them over: the historical frame's
        # positions, grid and degrees, and slot 1 of the pre-applied s = 0
        # output, a row-strided view (row stride 12, 24 bytes in)
        pos_h, deg_h = carry.pos_hist[0], carry.deg_hist[0]
        grid_h = state.grid_hist[0]
        cols_h = state.s0[:, 6:]
        k1 = lambda: cc.frame_sweep(x, grid, spec, 1.0, True)
        k1_plain = lambda: cc.frame_sweep_plain(x, grid, spec, 1.0, True)
        out1 = k1()
        deg = out1[:, 6].contiguous()
        k2 = lambda: cc.apply_deg_sweep(x, cols, deg, grid, spec, 1.0)
        k2_plain = lambda: cc.apply_deg_sweep_plain(x, cols, deg, grid, spec,
                                                    1.0)
        k3 = lambda: cc.apply_sweep(pos_h, cols_h, deg_h, grid_h, spec, 1.0)
        k3_plain = lambda: cc.apply_sweep_plain(pos_h, cols_h, deg_h, grid_h,
                                                spec, 1.0)
        outs = {"K1": (out1, k1_plain()), "K2": (k2(), k2_plain()),
                "K3": (k3(), k3_plain())}
        torch.cuda.synchronize()
        err = {
            "K1": check_close("K1 vs plain, N=32768", *outs["K1"], REL_PLAIN,
                              exact_channels=(6, 9)),
            "K2": check_close("K2 vs plain, N=32768", *outs["K2"], REL_PLAIN),
            "K3": check_close("K3 vs plain, N=32768", *outs["K3"], REL_PLAIN),
        }

        # the O(N^2) blocked oracle at N = 4,096 (row blocks, never (N, N))
        p4 = FlockingParams(n_agents=N_ORACLE)
        spec4 = cc.make_pcell_spec(p4)
        x4 = _init_candidate(gen, p4, dev)
        x4[:, :2] += 0.05 * torch.randn(N_ORACLE, 2, generator=gen,
                                        device=dev)
        g4 = cc.build_pcell_grid(x4[:, :2], spec4)
        if int(g4.overflow):
            raise AssertionError(f"overflow at N={N_ORACLE}")
        cols4 = torch.randn(N_ORACLE, 12, generator=gen, device=dev)
        fq4, applied4 = cc.frame_apply(x4, cols4, g4, spec4, p4, True)
        ref4 = bl.blocked_frame(x4, p4, True, block=512)
        check_close("K1 vs blocked oracle, N=4096", fq4.values, ref4.values,
                    REL_ORACLE)
        check_close("K1 degree vs blocked oracle", fq4.degree[:, None],
                    ref4.degree[:, None], 0.0, exact_channels=(0,))
        if float(fq4.min_r2) != float(ref4.min_r2):
            raise AssertionError(f"min r^2 {float(fq4.min_r2)} != "
                                 f"{float(ref4.min_r2)}")
        check_close("K2 vs blocked oracle, N=4096", applied4,
                    bl.blocked_apply_adjT(x4[:, :2], cols4, p4, 512,
                                          deg=fq4.degree), REL_ORACLE)
        deg4 = ref4.degree.roll(1)          # any per-agent normaliser
        check_close("K3 vs blocked oracle, N=4096",
                    cc.apply_adjT(x4[:, :2], deg4, cols4[:, :6], spec4, p4,
                                  grid=g4),
                    bl.blocked_apply_adjT(x4[:, :2], cols4[:, :6], p4, 512,
                                          deg=deg4), REL_ORACLE)

        halo = dense_tile_case(torch, cc, bl, FlockingParams, gen, dev)

        # the grid build never waits for the device
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cc.build_pcell_grid(x[:, :2], spec)
        finally:
            torch.cuda.set_sync_debug_mode("default")

        # time each kernel and its plain version at this slice's shapes
        cand1, nbr1 = pair_counts(x[:, :2], grid, spec)
        cand3, nbr3 = pair_counts(pos_h, grid_h, spec)
        nb1, nb3 = neighbour_bytes(grid, spec), neighbour_bytes(grid_h, spec)
        work = {   # (bytes moved, operations) that this input needs
            "K1": frame_work(N, cand1, nbr1, nb1),
            "K2": apply_work(N, 12, cand1, nbr1, nb1, False),
            "K3": apply_work(N, 6, cand3, nbr3, nb3, True),
        }
        timing = {}
        for name, fn, plain in (("K1", k1, k1_plain), ("K2", k2, k2_plain),
                                ("K3", k3, k3_plain)):
            ms, plain_ms = device_ms(fn), device_ms(plain)
            b_ms, b_by = bound_ms(*work[name])
            timing[name] = (ms, plain_ms, b_ms, b_by)
            print(f"#   {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}), {work[name][0]} B, "
                  f"{work[name][1]} ops", flush=True)
        floor_ms = device_ms(lambda: torch.cuda._sleep(0))
        print(f"#   launch floor: {floor_ms:.4f} ms (torch.cuda._sleep(0), "
              f"timed as the kernels)", flush=True)
        tile = cc.tile_cells(spec, N)
        for T in sorted(set(TILES) | {tile}):
            t1 = device_ms(lambda: cc.frame_sweep(x, grid, spec, 1.0, True,
                                                  tile=T))
            t2 = device_ms(lambda: cc.apply_deg_sweep(x, cols, deg, grid,
                                                      spec, 1.0, tile=T))
            t3 = device_ms(lambda: cc.apply_sweep(pos_h, cols_h, deg_h,
                                                  grid_h, spec, 1.0, tile=T))
            print(f"#   tile {cc.TILE_ROWS} x {T:>3} cells"
                  f"{' (chosen)' if T == tile else ''}: K1 {t1:.4f} ms, "
                  f"K2 {t2:.4f} ms, K3 {t3:.4f} ms", flush=True)
    phase("kernels", t, candidate_pairs=cand1, neighbour_pairs=nbr1,
          tile=tile, dense_halo=halo)

    # 4. the main path: one greedy episode through the evaluate entry point
    t = time.perf_counter()
    section = load_ini(CONFIG)["n32k"]
    ln.clear_programs()
    stats, launched = _counted(cc, lambda: ev.evaluate_blocked(
        section, CHECKPOINT, n_agents=N, n_episodes=1, device=DEVICE),
        traced=True)
    episode_s = launched.seconds
    launches = launched.device
    reward = stats["mean"]
    steps = ExperimentConfig.from_section(section).episode_steps
    # one capture replayed once: the wrappers' calls (the reset, the
    # warm-up, the recorded steps) are the launches the device ran
    want = _launches(1, t=steps, captures=1)
    if launched.captures != 1 or not launches == launched.host == want:
        raise AssertionError(f"launches {launched} != {want}")
    if stats["overflow"] != 0 or not math.isfinite(reward):
        raise AssertionError(f"overflow {stats['overflow']}, reward {reward}")
    if abs(reward - REWARD_REF) > REWARD_BAND:
        raise AssertionError(f"reward {reward} outside {REWARD_REF} +- "
                             f"{REWARD_BAND}")
    phase("episode", t, reward=reward, overflow=stats["overflow"],
          ms_per_step=f"{1e3 * episode_s / steps:.3f}",
          launches=json.dumps(launches, separators=(",", ":")),
          counted=json.dumps(launched.host, separators=(",", ":")))

    # 5. a trace of steady steps of the same rollout
    t = time.perf_counter()
    with torch.no_grad():
        state, _ = ln._scan_steps(cfg, actor, state, 5, gen)
        step_ms, graph_ms = trace_steps(torch, ln, cc, cfg, actor, state,
                                        gen, TRACE_STEPS)
    phase("trace", t, steps=TRACE_STEPS, ms_per_step=f"{step_ms:.4f}",
          graph_ms_per_step=f"{graph_ms:.4f}")

    # 20. the episode program against the eager loop, run here: phase 4's
    # capture is its first episode, its program still cached
    from multiagent_gnn_policies_tpu_torch.algos import imitation_large as il

    t = time.perf_counter()
    graph = graph_phase(torch, ev, ln, il, cc, ExperimentConfig, load_ini, N,
                        reward, launched)
    phase("graph", t, **graph)

    # 6-8. the dense N = 100 path; it launches none of the cell kernels
    from multiagent_gnn_policies_tpu_torch.algos import imitation as im
    from multiagent_gnn_policies_tpu_torch.algos.baseline import (
        train_baseline)
    from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
    from multiagent_gnn_policies_tpu_torch.models.actor import Actor
    from multiagent_gnn_policies_tpu_torch.models.torch_import import (
        actor_params_from_numpy)
    from multiagent_gnn_policies_tpu_torch.utils.checkpoint import (
        load_actor_npz)

    dcfg = ExperimentConfig.from_section(load_ini(DAGGER_CONFIG)["test"])
    cc.reset_launch_counts()
    t = time.perf_counter()
    d_mean, d_std, d_ms, d_err = dense_eval_phase(
        torch, im, tfl, load_actor_npz, actor_params_from_numpy, dcfg)
    phase("dense eval", t, reward_mean=d_mean, reward_std=d_std,
          ms_per_batched_step=f"{d_ms:.4f}", card_vs_cpu_max_abs_err=d_err)
    t = time.perf_counter()
    base = baseline_phase(ExperimentConfig, load_ini, train_baseline)
    phase("baseline", t, centralized=base[True], decentralized=base[False])
    t = time.perf_counter()
    losses, speed, bitwise = dagger_phase(
        torch, im, load_actor_npz, actor_params_from_numpy, Actor, dcfg)
    phase("dagger", t, rounds=DENSE_ROUNDS,
          rollout_ms_per_step=f"{speed['rollout_ms_per_step']:.4f}",
          update_ms_per_update=f"{speed['update_ms_per_update']:.4f}",
          env_steps_per_s=f"{speed['env_steps_per_s']:.1f}",
          resume_bit_for_bit=bitwise)
    dense_launches = cc.launch_counts()
    if any(dense_launches.values()):
        raise AssertionError(f"the dense path launched cell kernels: "
                             f"{dense_launches}")

    # 10-12. the large-N expert, large-N DAGGER, the variant checkpoints
    t = time.perf_counter()
    experts = expert_phase(ev, cc, load_ini, N)
    phase("expert", t, centralized=experts[True],
          decentralized=experts[False])
    t = time.perf_counter()
    l_losses, l_speed, l_bitwise, l_launches = large_dagger_phase(
        torch, im, il, cc, ExperimentConfig, load_ini, N)
    phase("large dagger", t, rounds=LARGE_ROUNDS,
          collection_ms_per_step=f"{l_speed['rollout_ms_per_step']:.4f}",
          update_ms_per_update=f"{l_speed['update_ms_per_update']:.4f}",
          resume_bit_for_bit=l_bitwise,
          launches=json.dumps(l_launches, separators=(",", ":")))
    t = time.perf_counter()
    variants = variants_phase(ev, cc, load_ini, N)
    twoflocks_resid = twoflocks_gate(ev, cc, load_ini, N)
    phase("variants", t, **variants,
          twoflocks_max_residual=f"{twoflocks_resid:.4f}")

    # 13. transfer: every K of the in-repo transfer policies, this slice's
    # main path
    t = time.perf_counter()
    (t_timing, t_err, t_launches, t_means, t_ms, t_parity,
     t_dense) = transfer_phase(torch, ev, ln, cc, bl, ExperimentConfig,
                               load_ini, built.ptxas)
    phase("transfer", t, **{f"K{k}_reward": t_means[k] for k in t_means},
          **{f"K{k}_ms_per_step": f"{t_ms[k]:.4f}" for k in t_ms},
          card_vs_cpu_max_abs_err=t_parity,
          **{f"K{k}_dense": t_dense[k] for k in t_dense})

    # 14. DDPG: no cell kernel on its paths
    t = time.perf_counter()
    means, parity, speed, resumed, graph = ddpg_phase(
        torch, ev, cc, ExperimentConfig, load_ini)
    phase("ddpg", t, **{f"{k}_mean": v for k, v in means.items()},
          card_vs_cpu_max_rel_err=f"{parity:.3g}",
          **{f"{k}_ms_per_step": f"{v:.4f}" for k, v in speed.items()},
          resume_bit_for_bit=all(v for v in resumed.values()
                                 if v is not None), **graph)

    # 15. the measurement tools, at cut depth
    t = time.perf_counter()
    tools = tools_phase(cc)
    phase("tools", t, **{k: (f"{v:.2f}" if isinstance(v, float) else v)
                         for k, v in tools.items()})

    # 16. the agent-sharded path: bands, a one-rank NCCL mesh, force_n_dev
    t = time.perf_counter()
    mesh = mesh_phase(torch, ev, ln, cc, FlockingParams, ExperimentConfig,
                      _init_candidate, load_ini, reward)
    phase("mesh", t, **mesh)

    # 18. data-parallel training on a one-rank NCCL mesh
    t = time.perf_counter()
    dp, dp_launches = dp_phase(torch, im, il, cc, ExperimentConfig,
                               load_ini, N, l_speed)
    phase("dp training", t, **dp)

    # 19. the cells and binned graph backends
    t = time.perf_counter()
    backends = backends_phase(torch, ev, ln, cc, il, ExperimentConfig,
                              load_ini, N, reward)
    phase("backends", t, **backends)

    # 21. the compiled imitation round: graph against the eager loops
    t = time.perf_counter()
    rounds = round_phase(torch, im, il, cc, ExperimentConfig, load_ini, dcfg,
                         N)
    phase("round", t, **rounds)

    # 17. budget, last
    total = time.perf_counter() - T0
    phase("budget", T0, budget_s=BUDGET_S, total_s=f"{total:.2f}")
    if total > BUDGET_S:
        raise AssertionError(f"run took {total:.1f} s > {BUDGET_S} s")

    # one entry per kernel and width this run launched: phase 3 timed K1,
    # K2 at 12 and K3 at 6 (K = 3's widths), phase 13 the others; the
    # launches are the main paths', from the device's trace: phase 13 (b)
    # (every K at N = 32,768, through the graph) and phase 18 (b) (the
    # mesh training round through its graphs, K = 3's widths)
    timing.update(t_timing)
    err.update(t_err)
    kernels = []
    for name, key, fn_name, c, line in (
            ("K1", "K1", "frame_sweep", 10, 496),
            ("K2 C=6", "K2 C=6", "apply_deg_sweep", 6, 613),
            ("K2 C=12", "K2", "apply_deg_sweep", 12, 613),
            ("K2 C=18", "K2 C=18", "apply_deg_sweep", 18, 613),
            ("K3 C=6", "K3", "apply_sweep", 6, 572),
            ("K3 C=12", "K3 C=12", "apply_sweep", 12, 572)):
        ms, plain_ms, b_ms, b_by = timing[key]
        kernels.append({
            "name": f"{name} {fn_name}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": f"{TPU_SOURCE}:{line}",
            "launches": (t_launches.get((fn_name, c), 0)
                         + dp_launches.get((fn_name, c), 0)),
            "max_abs_err": err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        if not kernels[-1]["launches"]:
            raise AssertionError(f"{name} was not launched on the main "
                                 f"path")
    faulthandler.cancel_dump_traceback_later()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
