#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, a few minutes
    python3 chip_smoke.py --phases card,build,check
    python3 chip_smoke.py --phases card,build,lint
    python3 chip_smoke.py --phases card,build,lmcheck,serve,lmtick
    python3 chip_smoke.py --phases card,build,lmcheck,ssmserve,lmtick
    python3 chip_smoke.py --phases card,build,lmcheck,moeserve,zoo
    python3 chip_smoke.py --phases card,build,dag,wfloop
    python3 chip_smoke.py --phases card,build,engine,chaos
    python3 chip_smoke.py --phases card,build,group,straggler,paper,cluster
    python3 chip_smoke.py --phases card,build,engine,chaos,trace,sweep
    python3 chip_smoke.py --phases card,build,examples
    python3 chip_smoke.py --phases card,build,train
    python3 chip_smoke.py --phases card,build,shard
    python3 chip_smoke.py --phases card,build,lmcheck --f32-terms 1

``--f32-terms 1`` builds the float32 attention kernels with one TF32
product (``FA_F32_TERMS=1``), a lower-precision control: each phase holds
them as usual (``train`` runs only its float32 attention cases and the
tiny Jamba's step), the holds are expected to fail, and no result line is
printed.

Phases, in order:

1. ``card``   — the card's name and power limit (nvidia-smi), torch and CUDA.
2. ``build``  — nvcc builds each library of ``csrc/`` into
   ``build/repro_torch/`` (frontier_grid, its float32-sum variant
   ``-DFG_ACC=float``, rmsnorm, attention, ssd_scan, compose and
   family_score), all seven at once.
3. ``lint``   — the port's invariant linter (``repro_torch.analysis``) over
   the whole ``src/`` (both packages), 0 findings; the card's limits
   against the port's constants (``shared_memory_per_block_optin`` equal
   to ``autotune.SMEM_LIMIT_BYTES``, ``compose.SMEM_MAX`` and
   ``family_score.SMEM_MAX``, ``max_threads_per_block`` at least
   ``autotune.MAX_THREADS``); then each built kernel instance's registers,
   static shared memory, local bytes and stack frame (where spills land)
   (``cuobjdump --dump-resource-usage``, names through ``cu++filt``; its
   SHARED less the 1 KB the card reserves a block), one line each, held:
   static shared memory within the opt-in limit, each
   frontier instance's static shared memory plus the model's dynamic
   shared memory at every combination lint rule RPA030 audits within it,
   and pass 1's registers times ``MAX_THREADS`` within a block's 65536.
   Spills are reported, not held.
4. ``check``  — each CUDA kernel against its plain PyTorch version on the
   card: 5 families x {shared, per-row statistics} x {fwd, grad, pgrad} at
   F=256, K=128, T=256 with edge rows (a zero weight, a zero sigma, p=0, an
   argmax tie), one case at T=2048, grids past 4096 points (F=3, K=1024,
   T=8192 and 16384, normal and lognormal, all three modes), and the
   launch shapes of one balancer refresh at K=1024 (``MAIN_PATH``), each
   also timed (event pair, device and host time per call) with the blocks
   of each launch of one call (the forward split: pass 1 and an epilogue;
   the adjoint: pass 1, pass 2, epilogue). Every case runs twice and must
   repeat its bits.
5. ``tick``   — the fleet tick, K=1024 channels, F=4096 candidates, T=256:
   kernel against plain, and their times, for fwd, grad and pgrad, three
   families.
6. ``acc32``  — what the float64 sums cost: the shipped kernels against the
   float32-sum build, interleaved, at the fleet tick and at a refresh's
   launch shapes, each also held against the plain version (reported, not
   asserted: the float32 sums are the reference's arithmetic).
7. ``loop``   — the main path: ``UncertaintyAwareBalancer(1024, lam=0.02,
   refresh_every=10, pgd_steps=60)`` against
   ``ClusterSim.heterogeneous(1024, seed=0)`` for 40 ticks, channel 0 slowed
   3x at tick 20, with policy "frontier", "equal", and "frontier" with
   adaptive refresh and risk_lam=0.5. Launch counters are zeroed before and
   read after; every mode must have launched.
8. ``profile`` — warm balancer refreshes at K=1024 on the host clock (the
   median of five) and one under torch.profiler: device time by kernel,
   the busy share, and the device time per call of the fused adjoint and
   of the forward split.
9. ``twoch``  — the two-channel quickstart through ``optimize_2ch``, on the
   card and on the CPU plain path.
10. ``lmcheck`` — the model kernels (rmsnorm, flash_attention, flash_decode,
   ssd_scan) against their plain versions on the card, float32 and bf16,
   run twice (bitwise-equal): causal, window, GQA, rectangular, ragged and
   Qwen3-8B's own shapes; attention at D = 64, 80, 128 and 192, Nemotron-4-
   340B's layer (Hq 96, Hkv 8, D 192) cut in B and S, short prompts packed
   by kv group (groups of 3, 4 and 12), DeepSeek-V2-Lite's MLA prefill
   (16 heads, q and k of 192, v of 128); decode with one and several
   splits, whole splits invalid, S = 4096; SmolLM-360M's attention, decode
   (Hkv 5, G 3, D 64, a cache of 20) and norms (d_model 960) at the
   ``examples`` batcher's shapes; the zoo's: Whisper-large-v3's encoder
   (1500 x 1500, non-causal, D 64), cross-attention (16 x 1500) and
   decodes (G 1, self S 23 and cross S 1500), Qwen3-MoE's G = 16 decode,
   InternVL2's prefill of 256 + 16 and G = 8 decode, DeepSeek-V2-Lite's
   norms (512, 2048); for ssd_scan y and the final
   state at ragged S, S >= 1024, G = 2, chunks of 16/64/128 and
   Mamba2-2.7B's own shapes in one, two and many groups of chunks; dead
   rows give 0; the tiny Qwen3, Mamba2, DeepSeek-V2-Lite, Qwen3-MoE and
   Jamba configs on the card against the same weights on the CPU (prefill
   logits and greedy tokens), and the tiny Whisper and InternVL2 with
   their frames and patches (prefill and 4 decode steps' logits).
11. ``serve`` — the model-serving path: full-width Qwen3-8B (36 layers,
   bf16, seeded weights drawn on the card) shared by two ReplicaGroups
   behind a PartitionedBatcher (policy frontier) on ClusterSim([Channel(20,
   2), Channel(14, 5)]); 5 batches of 64 prompts of 16 tokens, max_new 8.
   First the full-width prefill through the kernels against the plain
   versions. Launch counters are zeroed before the batches and read after;
   every model kernel and the frontier grad kernel must have launched; two
   generate calls on one batch must agree. One group's generate is
   profiled, with the device time of each model kernel.
12. ``ssmserve`` — the same serving path with full-width Mamba2-2.7B (64
   mamba layers, bf16, seeded weights on the card). On 2 x 300 tokens
   (three chunks, the last ragged) and 4 more: every layer on its own input
   at full depth, its mixer through the kernels against the plain versions
   and its 4 decode steps from the kernel's final state against its
   forward on 304; then through ``prefill``/``decode_step``/``apply`` at 8,
   16, 32 and 64 layers the same two comparisons end to end (held up to 8
   layers, reported deeper), and the plain path in bf16 against float32 on
   the same weights. Then 5 batches of 64 prompts of 16 tokens, max_new 8,
   through the batcher, with ssd_scan (64 per prefill), rmsnorm (129 per
   forward) and the frontier forward kernel counted; two generate calls
   must agree; one group's generate profiled.
13. ``moeserve`` — the same serving path with DeepSeek-V2-Lite-16B at full
   size, not cut (27 layers: a dense first layer, then MLA with 64 routed
   and 2 shared experts, top-6; bf16, ~15.7 B seeded weights on the card).
   On 2 x 16 tokens: every layer on the kernel path's own input, its
   update through the kernels against the plain versions (held at
   relative L2 < 0.1), then ``prefill`` at 4, 9, 14 and 27 layers (held at
   full depth, reported at the others), each with the share of routing
   choices that differ between the two paths, layer by layer. Then 5
   batches of 64 prompts of 16 tokens, max_new 8, through the batcher:
   flash_attention (27 a prefill, the (192, 128) instance: its profiler
   name is checked) and rmsnorm (82 a forward) counted exactly, no
   flash_decode (the absorbed MLA decode is plain matmuls); two generate
   calls must agree; one group's generate profiled, and once more with
   each MoE block in a profiler range (the blocks' share of device time).
14. ``zoo`` — Whisper-large-v3 at full size (32 + 32 layers, d_model 1280,
   1500 bf16 stub frames), Qwen3-MoE-235B-A22B (d_model 4096, 128 experts
   top-8, GQA 64/4 with qk_norm) and InternVL2-76B (d_model 8192, 256
   prepended patch embeddings) at full width cut to 8 layers, one after
   the other, each freed before the next: a prefill of 2 x 16 tokens and 7
   decode steps through the kernels against the plain versions (relative
   L2 < 0.1), every model kernel's launches counted and held to the count
   the model's code makes.
15. ``lmtick`` — each model kernel's time at the path's shapes and at the
   serving shapes cut to one layer (prefill_32k at B=1, decode_32k at B=32,
   32768 x 4096 norms; ssd_scan at prefill_32k with B=8 and long_500k at
   B=1, each with its group split, blocks, launches per call and device
   time per call), and the attention kernels at a middle shape (prefill
   S=4096 at B=8, decode S=2048 at B=32), beside its bound, its plain
   version (where
   it fits) and the yardstick PyTorch call (scaled_dot_product_attention,
   rms_norm; none computes the SSD scan), which the port never calls, with
   kernel over bound and kernel over library (kernel and library timed
   in turns: kernel, library, library, kernel). rmsnorm runs at every norm
   shape of both serving paths (Qwen3-8B prefill and decode, Mamba2-2.7B),
   held against its plain version, with device and host time per call
   beside ``F.rms_norm``'s. The attention kernels are
   held against their plain versions at LM_TOL at the middle shapes and at
   decode_32k (once more there with its first split invalid), and at the
   path's shapes their device time per call under torch.profiler (no
   launch path) and their host time per call (the launch path) stand
   beside SDPA's. The float32 attention kernel too (split TF32): at
   SmolLM-360M's training shape, the tiny Jamba's and D 192 with a window
   and a ragged S, held against plain (also at relative L2), with device
   and host time per call beside SDPA's float32 forward, GQA and with k
   and v expanded, each with the SDPA backend that served it. The zoo's shapes too: DeepSeek-V2-Lite's MLA prefill
   (D 192, Dv 128) at a group's serving shape, Whisper's encoder, cross
   prefill and decodes, Qwen3-MoE's G = 16 decode and InternVL2's prefill
   and G = 8 decode, each held against its plain version, with SDPA
   where it takes the shape, and DeepSeek-V2-Lite's and Whisper's norms.
16. ``dag``   — the workflow DAG's joint solve (``repro_torch.bench.dag_scale``
   at full scale: 32 stages, a source, 10 branches of 3 and a sink, K=256,
   T=256, 60 steps, one restart, eval_num_t 2048, 200 paired WorkflowSim
   trials; DAG_REPEATS warm solves each of joint and greedy; the 512-stage
   scale point once), launch counters zeroed before and read after. It
   prints the predicted and realized makespans, the improvement, wall
   median and p90, phase_us, survivors and steps run, launches per solve
   by mode, the solver's host reads per PGD step. Asserted: joint <= greedy
   on the predicted makespan; both splits re-evaluated by the plain path on
   the CPU agree with the card's evaluate_dag (mu 1e-4, var 1e-3
   relative); every rung's stacked launch (presolve grad, triage fwd,
   refine grad, final fwd, fragility pgrad, at 32 and 512 stages) agrees
   with its plain version at the frontier tolerances and repeats its bits,
   with its time, bound and blocks; family_groups == 1. Then host and
   device ms of a refine step with its torch operations and the
   composition's share, one warm joint solve under torch.profiler (device
   time by kernel, busy share), a mixed-family 8-stage DAG (3 family
   groups, one launch per group per step, the CPU's decision) and an empty
   dirty set (the warm split, no PGD launch). The composed makespan's
   reverse pass, ``compose_grads`` (``csrc/compose.cu``, launched once per
   composed refine step; its launches counted with the path's), is held
   bit for bit against its plain version (``compose_structure`` and
   autograd, on the card) at the refine shape of both solves (their
   survivors, the stage moments of their starts at T=256), at the scale
   point with 20 starts and on a 24-way join with three sinks, each timed
   beside its bound and its chain estimate; the refine step's host and
   device cost (one complete profiled window, the device time split into
   the adjoint, ``compose_grads`` and the rest) is measured with the
   kernel and with the plain composition (before and after). Last, ``dag_scale.check_gates``: the reference's four gates
   (one batched path, improvement >= 0.088%, joint/greedy wall clock
   <= 1.0, a 512-stage scale point); the phase fails if any fails.
17. ``wfloop`` — ``WorkflowBalancer`` on the 32-stage DAG against
   ``WorkflowSim.from_dag`` for WF_TICKS ticks, refresh_every=5, then
   adaptive refresh with risk_lam=0.5, then that with dirty_tol=1 (the
   incremental path; WF_CONFIGS says why), one stage slowed 3x at
   WF_SLOW_AT: tick mean, solves per tick, dirty-set sizes, the solves'
   relative fragility, launches. Every mode must have launched, and a
   refresh with an empty dirty set launches no PGD step.
18. ``engine`` — the serving path: ``repro_torch.bench.serve_trace`` at
   full scale on the card (the continuous-batching ``WorkflowEngine``, 3
   templates in 3 families, 120 ticks, up to 320 live, T=128, bursty
   arrivals, stage churn), launch counters zeroed before and read after.
   It prints the counters, join latency per template, solver-tick us,
   rows per launch, occupancy, the live high-water mark (at least 256
   asserted), the SLO miss rate, ``batched_vs_looped_ratio``, each
   tick's host ms by stage (admission, stack_rows, launch, commit, each
   between device synchronizations) and its device synchronizations
   (torch's sync debug mode), and the device's busy share over five ticks
   under torch.profiler. Asserted: every tick makes one frontier call per
   family group with rows; every ENGINE_CHECK_EVERY-th tick's stacked
   calls, and each (family, F) the first time it appears, rebuilt from the
   engine's rows, agree with the plain version on the card at the
   frontier tolerances, repeat their bits and reproduce the engine's
   priced moments bit for bit. Then each engine shape seen
   (family, F) timed with its bound and blocks; ``launch.serve --engine``
   for ENGINE_CLI_TICKS ticks in-process; and the smoke trace on the card
   and on the CPU, whose per-tick admissions, retirements, rows and
   launches must agree and join latencies to 1e-4 relative (a dirty_tol
   decision that flips between the two is printed with its tick, instance
   and drift; only ticks before the first flip are then held).
19. ``chaos`` — kill/restore parity on the card: ``sim.chaos`` on a
   6-channel fleet with churn, on a defective fleet, on the dag_scale smoke
   DAG (8 stages, K=32) with stage churn, and a ``WorkflowEngine`` killed
   every ENGINE_KILL_EVERY ticks through ``save_pipeline`` /
   ``restore_pipeline``; every restored decision must equal the
   survivor's bit for bit. Then the full ``bench.fault_trace`` (12
   channels, 300 ticks): the failure-aware solve must beat the blind one.
20. ``trace`` — the port's tracing and sanitizer on the card: the full
   serve_trace traced (``obs``, a tracer of TRACE_CAPACITY records) against
   the ``engine`` phase's untraced run (run untraced here when that phase
   did not run): every tick's admissions, retirements (iids and join
   latencies), rows, launches, frontier calls and device syncs bitwise
   equal; the records valid; the span kinds and event types of the engine;
   the kernel.launch spans inside each tick span equal to the tick's
   counted calls; the median of TRACE_OVERHEAD_READINGS readings of
   ``overhead_pct`` (the run's and more on its last rows) under
   TRACE_OVERHEAD_MAX_PCT. Then the
   ``chaos`` runs traced (every kill bitwise, an ``audit.ckpt_restore`` at
   each manifest step, results equal to the ``chaos`` phase's), the K=1024
   loop traced (refresh spans; decisions bitwise the ``loop`` phase's),
   the dag_scale joint solve's ``phase_us`` against its spans, and the
   sanitizer switched on in-process: the K=1024 loop bitwise with at most
   SANITIZE_MAX_READS added device syncs a solve, a NaN in mus raising
   before any launch, a NaN gradient planted at step SANITIZE_NAN_STEP (by
   wrapping ``ops.frontier_moments_with_grads`` here) raising named.
21. ``group`` — the channel-count selection: the forward and adjoint
   kernels at K = 1 (F = 1 and 8, T = 2048), all five families, against
   their plain versions (off the path: a one-channel subset takes the
   plain quadrature); then ``select_channels`` on
   ``ClusterSim.heterogeneous(64, seed=0)``'s statistics under the normal
   and the defective family (join cost 0.5, lam 0.02, 120 PGD steps: 63
   solves each) and the exhaustive oracle against greedy on 6 channels,
   each choice held against the CPU plain path's (the same indices,
   objective 1e-4 relative); launch counters zeroed before and read after.
   Then the first call of each (mode, family, F, K, T) the path made, its
   inputs kept as it ran, again through the kernel (twice: the bits
   repeat) against its plain version at the frontier tolerances.
22. ``straggler`` — ``repro_torch.bench.elastic_fleet`` in quarantine and
   drift modes (16 channels, a 4x straggler at step 60, a hard failure at
   120, two joins at 160, 240 steps): the straggler flagged and quarantined
   or priced as drift, the failure removed, the joins admitted, every split
   a simplex; join statistics before and after, tick times; then each
   shape the scenario launched held as in ``group`` (K = 16, 15 after the
   failure, 17 after the joins; normal and drift).
23. ``paper`` — the paper's Figs 1, 2, 3-4 and 5-6 (``bench.fig1_theory``,
   ``fig2_frontier``, ``fig34_convex_opt``, ``fig56_file_transfer``) on the
   card with their own assertions, held against the CPU plain path (Figs 1
   and 2 mu 1e-4 and var 1e-3 relative, the same efficient mask; the
   simulated columns bit for bit; the joined MSE 1e-4 relative), and the
   201-row Fig 1 call timed (event pair, device, host) beside its bound.
24. ``cluster`` — ``bench.cluster_scale.run(smoke=False)`` on the card: the
   policy comparison at 64 / 256 / 1024 channels (frontier beats equal on
   mean and p99), the fleet ticks at K=1024, F=4096, T=256 against the
   plain foil and autograd (gradient parity 1e-4), the family ticks and the
   auto-family tick; prints ``pgd_speedup_vs_autodiff`` and
   ``auto_family_tick_overhead``. Then each shape of up to
   RECORD_MAX_POINTS grid points that the run launched (the policy loops'
   solves) held as in ``group``; its sweep section runs in ``sweep``. The
   auto-family tick scores on the card (``family_score``,
   ``csrc/family_score.cu``, counted); the kernel is held bit for bit
   against the numpy at the tick's K=1024, N=96 history and on windows
   with every edge case (below min_obs, all masked, nonpositive rates, zero
   variance, a singular drift regression, a negative slope; N = 12, 96,
   128, 4096, and K = 1025 for a ragged last block), with the relative BIC
   margin of each winner over its runner-up, and timed (its two launches
   apart) beside its bound, its chain estimate and the numpy's host
   time. Then
   ``cluster_scale.check_gates``: the phase fails if the auto-family tick
   costs more than 1.2x the fixed one.
25. ``sweep`` — ``kernels.autotune.sweep`` on the card at the fleet tick
   (K=1024, F=4096, T=256; fwd, grad through
   ``bench.cluster_scale.tick_sweep``, pgrad) and a refresh's shapes (fwd
   F=3 T=2048, grad F=3 T=1024, pgrad F=1 T=1024), normal family, into a
   temporary cache file: every candidate (the model's split and its
   neighbours) held against its plain version with its bits repeated
   (inside the sweep), the model's and the winner's time and every
   candidate's beside the bound; then the winners reloaded from the file
   through a cleared cache (source sweep), a K=1024 balancer checkpointed
   with them and restored (its next decision bitwise the survivor's), and
   the in-process cache restored, so no other phase launches a swept
   split.
26. ``examples`` — the ported examples and harness on the card, counters
   zeroed before and read after: ``bench.quickstart``,
   ``bench.file_transfer`` (its two asserts), ``bench.partitioned_training``
   (its two asserts), ``bench.serve_partitioned`` ``--engine`` (the
   WorkflowEngine demo, killed and restored at mid-trace) and
   ``--execute`` at full SmolLM-360M width (32 layers, d_model 960, 15
   query heads over 5 KV heads, bf16, seeded weights; 60 batches of 64
   prompts, the first two frontier batches generating), and ``bench.run
   --only fig1,parttrain``. Every frontier mode the path uses, the
   composed makespan's kernel and the three model kernels must have
   launched. Then the engine demo again unkilled (every tick bitwise the
   killed run's), and the full-width SmolLM-360M at the batcher's shapes
   (a prefill of 32 x 12 into a cache of 20, then 7 decode steps) through
   the kernels held against the plain ops at relative L2 < 0.1.
27. ``train`` — the training path. First the three backward kernels
   (``rmsnorm_bwd``: dx, dw; ``flash_attention_bwd``: dq, dk, dv;
   ``ssd_scan_bwd``: dx, ddt, dA, dB, dC, dD) against autograd of their
   plain forwards on the card (``ref.rmsnorm_ref``,
   ``ref.flash_attention_bf16p_ref`` in bf16 and ``flash_attention_ref``
   in float32, ``ref.ssd_chunked_ref``; the scan also against
   ``ref.ssd_chunked_bwd_ref``, its formulas) at relative L2 2e-4 in
   float32 and 1e-2 in bf16, each run twice (bitwise-equal): attention at
   SmolLM-360M's training shape (B 8, 15 query and 5 KV heads of 64, S
   2048, causal), Qwen3-8B's (B 2, 32/8 heads of 128), a window of 512, a
   non-causal 16 x 1500, a ragged S of 1000, float32 at a small shape, and
   the 192 tile: DeepSeek-V2-Lite's MLA (B 2, 16 heads, q and k of 192, v
   of 128), Nemotron-4-340B's layer (B 1, 96/8 heads of 192) and float32
   at 192, float32 at SmolLM-360M's training shape, h2o-danube-1.8b's
   layer (B 2, 32/8 heads of 80, S 8192, window 4096; the plain version
   a batch row and KV head at a time, ``_plain_attention``) and
   Whisper-large-v3's encoder (B 8, 20 heads, 1500 x 1500) and cross
   (448 x 1500) attention in float32, the path's type; norms at 16384 x
   960 and 4096 x 4096 in both dtypes; the scan
   at Mamba2-2.7B's layer (B 2 x S 2048, 80 heads of 64, N 128) in both
   dtypes, a ragged S, eight groups, S 16384 at B 1, and runs of dt = 0
   that tie decays across the float32 instance's chunks inside forward
   chunks;
   each with its event-pair and device time beside its bound (bytes for
   the norm; for attention and the scan their operations at the dense
   peak of their inputs' type, for float32 attention and the float32
   scan a third of the bf16 rate, three products of split operands, with
   the CUDA-core figure beside it, attention's split-TF32 one too),
   attention's device busy time (the union of a call's launches: the float32 dQ pass overlaps the dK/dV pass), the
   plain version's time and the yardstick PyTorch call's
   (``scaled_dot_product_attention``, ``F.rms_norm``: forward + backward,
   and backward alone with its device time; for float32 GQA SDPA's
   backward also with k and v expanded to the query heads, each with the
   SDPA backend that served it; none computes the scan's),
   which the port never calls; the phase fails where a kernel's or
   its library call's device time is not measured (``_device_ms`` checks
   that its profiled window holds every launch's device record). Then SmolLM-360M at full width in bf16
   (seeded weights, B = 8 x 2048 tokens from ``SyntheticStream``): its
   first step through
   the kernels against the plain ops on the same weights and batch (loss
   1e-2 relative, every gradient leaf relative L2 < 0.1, the worst leaf
   named; both runs recompute each layer in the backward, the config's
   remat, which the plain run needs to fit the card); TRAIN_STEPS (10)
   steps through
   ``launch.train`` (``Trainer``) with the model kernels' launches counted from zero and held to the count the code
   makes (step ms,
   tokens/s, peak memory, then one step under torch.profiler: device time
   by part, busy share, each backward kernel's device time a step and a
   launch (dK/dV, dQ, D_i, the norm's dx pass and dw sum), the AdamW
   update alone, and beside it the dry run's count of the same step on
   one chip: its compute and memory terms at the datasheet rates, their
   bound, ``model_flops``, the measured device time as a multiple of the
   bound, and the count's peak beside ``max_memory_allocated``, as after
   every arch's profiled step below); a Trainer killed after
   step TRAIN_KILL_AT (2) and restored from its checkpoint, whose next
   step must be bitwise the uninterrupted run's (loss and every
   parameter); and
   ``bench.train_partitioned --full-360m`` for 20 steps (the example's
   assertion that the loss falls; the simulated join's mean, variance and
   p99, the final split; every kernel's launches held to the count worked
   out from the code and the run's recorded splits: one ``frontier_grid``
   call a step, for two pods' ``optimize_2ch``, and no
   ``frontier_grid_with_grads``, whose PGD refresh runs for three pods or
   more). Then rematerialization (``REMAT_HOLDS``): SmolLM-360M (B 8 x
   2048), Mamba2-2.7B (all 64 layers, B 2 x 2048), DeepSeek-V2-Lite 1 + 3
   (its first dense layer outside remat) and the tiny Jamba (one 8-layer
   unit a repeat), each two ``make_train_step`` steps from one state under
   no remat (twice: its run-to-run distance), "full" and "dots", the second
   step after the AdamW update so that the state's weights are not the
   module's: the losses and every gradient leaf AdamW receives held
   bitwise against no remat's, launches held to the count the code makes
   (each forward kernel inside a unit twice a step), step ms, peak memory
   and a profiled step by part for each policy; and h2o-danube-1.8b's step
   tried once without remat (its peak, or the card's refusal). Then
   (``TRAIN_ARCHS``, every one under its config's remat "full")
   Mamba2-2.7B at full width, all 64 layers,
   DeepSeek-V2-Lite at full width cut to its dense first layer and
   ``DS_MOE_LAYERS`` MoE layers (the AdamW update's peak sets the cut),
   both bf16 on B = 2 x 2048, h2o-danube-1.8b whole on B 2 x 8192 (the
   4096 window acting) and Whisper-large-v3 whole (32 + 32 layers) on B
   8 x 448 tokens with 1500 stub frames: the first step end to end
   against the plain ops (Mamba2: bf16 at 2 layers and float32 at 8 at those tolerances,
   bf16 at 8 against the plain path's own distance from float32: the
   kernels' at most 1.25 times it, at the worst leaf and the median;
   the others bf16 at 2 layers, Whisper 2 + 2), every layer's gradients
   on its own input
   and a seeded
   cotangent (its input's and its parameters', relative L2 < 0.1), then
   ARCH_STEPS (10) steps through ``launch.train`` with every model
   kernel's launches counted from zero and held to the count the code
   makes (128 ``ssd_scan`` and 64 ``ssd_scan_bwd`` a Mamba2 step), the loss falling, step ms,
   tokens/s and peak memory, then one step under torch.profiler (device
   time by part, as SmolLM-360M's). Last the tiny Jamba (float32) one step on the
   card against the same weights on the CPU: loss 1e-3 relative and every
   gradient leaf at relative L2 5e-2 (a miss is reported with each layer's
   reading, ROADMAP.md section 3), launches counted.

28. ``shard`` — sharded serving and training. (a) A world of one over NCCL
   (``init_process_group("nccl", world_size=1)`` on a free local port, a
   (1, 1) ``DeviceMesh`` of ("data", "model"); one ``all_reduce`` must
   answer): DeepSeek-V2-Lite-16B at full width (27 layers, 64 experts top
   6, 2 shared, bf16) and then Qwen3-8B at full width, each run unsharded
   (a prefill of 2 x SHARD_PROMPT and SHARD_STEPS greedy decode steps),
   then placed in place at ``param_specs``' DTensor placements (checked
   against ``named``) under ``ShardCtx(mesh, decode_seq_axes=("data",))``
   and run again on the same weights, launch counters zeroed before and
   read after: DeepSeek's logits and tokens bit for bit (every collective
   covers one rank), Qwen3-8B's decode through the partial route
   (``flash_decode_partial`` a layer a step, no ``flash_decode``) with
   every step's logits at ``_hold_logits``' hold and the greedy tokens
   equal; launches held to the count the code makes; the process group
   destroyed at the end. (b) Every rank's body in one process at full
   width: DeepSeek-V2-Lite's MoE layer on 2 x 2048 tokens at (data,
   model) = (1, 2), (1, 4) and (2, 2), the partials summed in rank order,
   against the unsharded layer on each data shard's tokens (relative L2
   < MOE_HOLD; the tokens share a direction, MOE_SKEW, so that capacity
   drops copies; at data 2 the whole batch's capacity must miss that
   hold), and Qwen3-8B's decode attention at decode_32k in
   SHARD_SEQ sequence shards against one ``flash_decode`` and the plain
   version (LM_TOL), each twice with its bits repeated; the decode timed
   (event pair in turns and device time) against one ``flash_decode``
   call, and one partial on one shard beside its bound, its plain version
   and SDPA's memory-efficient call with its log-sum-exp. (c)
   ``flash_decode_partial`` against its plain version in bf16 and
   float32 (one split, several, G 16, decode_32k's shard, a shard with no
   valid slot, one whose valid logits are all below -100), twice: m
   absolutely, l relatively, acc relative to l and acc / l at the float32
   tolerance. (d) Training on the NCCL world of one (``SHARD_TRAIN``):
   SmolLM-360M at full width (B 8 x 2048) and DeepSeek-V2-Lite cut to
   1 + 3 layers (B 2 x 2048) each take SHARD_TRAIN_STEPS ``Trainer``
   steps unplaced, then placed on the (1, 1) ``DeviceMesh`` (``ShardCtx``
   with ``batch_axes=("data",)``, parameters and AdamW's moments
   DTensors) from the same seed and batches: losses, every parameter and
   every moment bit for bit, each run's launches counted from zero and
   held to the code's count. (e) DeepSeek-V2-Lite's MoE layer's gradient
   (x and every weight) at full width, every rank's body in one process
   at (data, model) = (1, 2) and (2, 2), against the unsharded layer's
   gradient on each data shard's tokens (relative L2 < MOE_HOLD in bf16),
   twice with its bits repeated. (f) Head-parallel compute
   (``models/tp.py``), every TP rank's body in one process at full width,
   bf16, B 2 x 2048, the partials summed in rank order
   (``tp.layer_ranks``, ``tp.head_ranks``, ``tp.xent_ranks``), launch
   counters zeroed before and read after: Qwen3-8B's layer (attention and
   MLP) at tp 2, 4 and 16 (16: each rank's KV head sliced), Mamba2-2.7B's
   mamba layer at tp 2, 4 and 16 (40, 20 and 5 SSD heads, the split-row
   gated norm), DeepSeek-V2-Lite's MLA layer with its dense first MLP at
   tp 2 and 4, each layer's update against the unsharded layer's
   (``layer_ranks`` at tp 1: every block whole), and a DeepSeek MoE block
   (its experts and its shared experts' columns by rank) on one normed
   input against the unsharded block, at relative L2 < MOE_HOLD, twice
   with its bits repeated; Qwen3-8B's vocab-parallel head and loss at tp 4 against the
   whole head and loss; the gradient (x and every weight) of Qwen3-8B's
   and Mamba2-2.7B's layer by rank at tp 2 against the unsharded layer's.
   Then the split-row RMSNorm kernels (``rmsnorm_stat``,
   ``rmsnorm_split``, ``rmsnorm_split_bwd``) on each rank's shard of
   Mamba2-2.7B's gated norm (4096 rows of 5120 / tp) in bf16 and float32
   against their plain versions (LM_TOL), twice, and timed (event pair)
   beside their bound and ``F.rms_norm`` on the whole row. (g) Megatron
   sequence parallelism (``ShardCtx(seq_axis="model")``), every TP rank's
   body in one process at (f)'s width and shape
   (``tp.layer_ranks(..., seq=True)``: each rank's block of the sequence
   through the norms, the blocks joined, the partials summed in rank order
   and cut back into blocks), launch counters zeroed before and read
   after: Qwen3-8B's and Mamba2-2.7B's layers at tp 2, 4 and 16,
   DeepSeek-V2-Lite's dense first layer (MLA) at tp 2 and 4 and
   SmolLM-360M's layer at tp 16 (its 15 heads replicated: the whole
   sequence gathered, the rank's block kept), each forward against (f)'s
   ``layer_ranks`` at the same size (bit for bit, else at LM_TOL with the
   reason logged) and against the unsharded layer (MOE_HOLD), twice with
   its bits repeated; the gradient of Qwen3-8B's and Mamba2-2.7B's layer
   at tp 2 against ``layer_ranks``' at every leaf (MOE_HOLD), twice; it
   fails if ``rmsnorm``, ``flash_attention``, ``ssd_scan`` or a backward
   kernel of theirs was never launched. Inside (a), Qwen3-8B's prefill and
   greedy steps again under ``ShardCtx(seq_axis="model")`` on the (1, 1)
   mesh and, placed anew, under ``batch_axes=("pod", "data")`` on a (1, 1,
   1) ("pod", "data", "model") mesh: each bit for bit the unsharded run.

Tolerances (kernel against plain, both on the card): mu rtol = atol = 1e-4;
var rtol 1e-2, atol 1e-3; every adjoint relative L2 <= 1e-4. Model kernels:
atol = rtol = 2e-4 in float32 and 1e-2 in bf16 (ssd_scan: 5e-4 for float32
y and every final state, 1e-2 for bf16 y); the tiny models on the card
against the CPU at atol 2e-4 / rtol 2e-3; the full-width bf16 prefills
through the kernels against the plain versions, and Mamba2's decode
continuation against its forward, at relative L2 < 0.1 (Mamba2: every
layer at full depth, and end to end up to SSM_E2E_LAYERS layers;
DeepSeek-V2-Lite: every layer's update and end to end at full depth; the
zoo's prefills and decode steps end to end). The
workflow DAG: the card's composed makespan against the plain path's on the
CPU, mu 1e-4 and var 1e-3 relative; ``compose_grads`` against its plain
version on the card bit for bit (losses and both gradients), and
``family_score`` against the numpy bit for bit (the winner, the channel
count, the BICs, rho and the mixture), each also against a second call.

Any failure exits non-zero. Without a card, or without the repository's
``src/`` beside this script, it fails before printing a result. The line
before the last is a JSON object of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``. A frontier kernel's ``launches`` in the
per-kernel line is the sum over the paths that drive it, each counted from
zero just before it runs (``loop``, ``dag``, ``wfloop``, ``engine``: the
ticks' own calls, ``chaos``, ``group``, ``straggler``, ``paper``,
``cluster``, ``trace``: its traced and sanitized runs, ``sweep``,
``examples``), and its ``launches_by_path`` gives each path's count; a
model kernel's sums the serving paths that ran (``serve``, ``ssmserve``,
``moeserve``, ``zoo``: its kernel paths, ``examples``, ``train``: the
SmolLM Trainer's 12 steps and the partitioned trainer's 20, which also
count in the frontier kernels' ``train`` path, the remat holds' steps, the
Mamba2, DeepSeek, danube and Whisper Trainers' 10 steps each and the tiny
Jamba's step, and ``shard``: the world of one's sharded serving and
training runs; ``train`` and ``shard`` in the three backward kernels'
lines, each with its timed shapes as ``instances``, and ``shard`` alone in
``flash_decode_partial``'s);
``compose_grads`` sums ``dag``, ``wfloop``, ``chaos``, ``trace`` and ``examples``,
``family_score`` ``cluster`` and ``examples``. Details go to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

PHASES = ("card", "build", "lint", "check", "tick", "acc32", "loop", "profile",
          "twoch", "lmcheck", "serve", "ssmserve", "moeserve", "zoo",
          "lmtick", "dag", "wfloop",
          "engine", "chaos", "trace", "group", "straggler", "paper",
          "cluster", "sweep", "examples", "train", "shard")

# nvcc defines of the float32-sum variant of csrc/frontier_grid.cu
ACC32 = ("FG_ACC=float",)

# The card's rates, every one from src/repro_torch/launch/roofline.py's
# table (the H100 SXM data sheet): device memory, FP32 outside the tensor
# cores, the special function units, the tensor cores in bf16, TF32 and
# float32 as split operands; the kernels' FLOP and byte formulas come from
# the same module. Run without its checkout, the script has none and
# main() refuses.
sys.path.insert(0, os.path.join(HERE, "src"))
try:
    from repro_torch.launch import roofline as RL
except ImportError:
    RL = None
HBM_BYTES_PER_S = getattr(RL, "HBM_BYTES_PER_S", None)
FP32_OPS_PER_S = getattr(RL, "FP32_OPS_PER_S", None)
SFU_OPS_PER_S = getattr(RL, "SFU_OPS_PER_S", None)
BF16_OPS_PER_S = getattr(RL, "BF16_OPS_PER_S", None)
TF32_OPS_PER_S = getattr(RL, "TF32_OPS_PER_S", None)
F32_SPLIT_OPS_PER_S = getattr(RL, "F32_SPLIT_OPS_PER_S", None)

# Work per CDF evaluation C_k(t_j), counted from csrc/frontier_grid.cu.
# Pass 1 (every mode): erf and log are the special functions; the z-score,
# Phi's affine form, the clamp and the log-sum add are FP32 operations.
# Pass 2 (grad, pgrad): erf and exp (the pdf), and the gate, the ratio and
# up to six accumulator updates.
PASS1 = {"special": 2, "fp32": 8}
PASS2 = {"special": 2, "fp32": 16}

TOL_MU = 1e-4
TOL_VAR = (1e-2, 1e-3)
TOL_ADJ = 1e-4

KERNELS = {
    "fwd": ("frontier_grid", "src/repro/kernels/frontier_grid.py:245"),
    "grad": ("frontier_grid_with_grads", "src/repro/kernels/frontier_grid.py:419"),
    "pgrad": ("frontier_grid_with_grads[param_grads]",
              "src/repro/kernels/frontier_grid.py:419"),
}
SOURCE = "src/repro_torch/csrc/frontier_grid.cu"
MODES = tuple(KERNELS)

# The port's two kernels with no Pallas counterpart: the source, and the
# JAX package's function each one computes (under jit there, numpy on the
# host there).
PORT_KERNELS = {
    "compose_grads": ("src/repro_torch/csrc/compose.cu",
                      "src/repro/workflow/dag.py:342"),
    "family_score": ("src/repro_torch/csrc/family_score.cu",
                     "src/repro/core/bayes.py:247"),
}
# H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12
# Work of one Clark fold step of compose_grads, forward and reverse,
# counted from csrc/compose.cu: square roots, divisions, erf and exp on
# the special function units, and float32 operations.
COMPOSE_FOLD = {"special": 12, "fp32": 85}
# Work of family_score per (sample, channel), from csrc/family_score.cu:
# per EM iteration and component an exp and a division plus ~12 float32
# operations; once, ~30 float64 operations and two logs.
FAMILY_EM = {"special": 2, "fp32": 12}
FAMILY_ONCE = {"special": 2, "fp64": 30}
# The dependency chains of those two kernels, in SM cycles a step: an
# estimate for the log, not a measurement, counted
# from their sources at ~4 cycles a dependent float32 operation, ~8 a
# float64 add, ~30 a shared-memory load, ~40 an IEEE division or square
# root, ~70 erf and ~35 exp (latencies, not issue rates), read at the
# card's maximum SM clock (CARD). compose_grads: the staging copy (one
# device-memory latency); a round of a level's lanes, each way (dependent
# shared loads and an add); a fold step forward (two square roots, a
# division, erf, the moments) and backward (two divisions on the var
# cotangent's path); each cotangent source summed. family_score, a warp:
# the staging copy; its three float64 ordered sums of N; a bisection round
# (a lane's keys, three warp reductions); an EM iteration (a lane's
# E-step samples, the M-step's N float32 adds, the update and its logs);
# the sort and the writes.
CHAIN_CYCLES = {"stage": 1500, "round": 150, "fold_fwd": 280,
                "fold_bwd": 185, "add32": 4, "add64": 8, "e_sample": 250,
                "em_update": 250, "bisect": 120, "final": 500}
# the card's maximum SM clock (nvidia-smi clocks.max.sm; the card phase
# reads it; H100 SXM 1980 MHz)
CARD = {"sm_hz": 1.98e9}


def log(*a):
    print(*a, flush=True)


def phase_card(ctx):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    ctx["smi"] = smi.stdout.strip().splitlines()[0]
    log(f"[card] {ctx['smi']}")
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    try:
        mx, now = (float(v) for v in clk.stdout.splitlines()[0].split(","))
        CARD["sm_hz"] = 1e6 * mx
        log(f"[card] SM clock max {mx:.0f} MHz, now {now:.0f} MHz")
    except (ValueError, IndexError):
        log(f"[card] SM clock not read ({clk.stdout.strip()!r}); chain "
            f"estimates at {CARD['sm_hz'] / 1e6:.0f} MHz")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")


def phase_build(ctx):
    """Every library at once, one nvcc each: the frontier kernels, their
    float32-sum variant, RMSNorm, attention (prefill and decode), the SSD
    scan, the composed makespan's reverse pass and the family scoring."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _cuda, compose
    from repro_torch.kernels import family_score as fs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    t0 = time.perf_counter()
    jobs = (lambda: fg.build(), lambda: fg.build(ACC32), rn.build, fa.build,
            ssd.build, compose.build, fs.build)
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(job) for job in jobs]:
            f.result()
    ctx["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(jobs)} libraries in {ctx['build_s']:.1f} s")
    for stem, info in sorted(_cuda.BUILD_INFO.items()):
        log(f"[build] {stem}: {info['path']} ({info['seconds']:.1f} s)")
        for line in info.get("log", "").splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


# a block's 32-bit registers on an H100 (64 K): pass 1's threads go up to
# autotune.MAX_THREADS in the sweep, so its registers must fit such a block
REGS_PER_BLOCK = 65536
FRONTIER_PASS1 = ("frontier_fwd_pass1", "frontier_grad_pass1")
# the frontier library's instances: each pass 1 per family (5 + 5), the
# forward's epilogue, pass 2 and the adjoint's epilogue per family and
# grad/pgrad (10 + 10)
FRONTIER_INSTANCES = 31


def _template(name):
    """(kernel, template arguments) of a demangled kernel name:
    ``void frontier_grad_pass2<(int)1, (bool)1>(Args, Split, GradOut)``
    gives ``("frontier_grad_pass2", (1, 1))``; an argument that is not an
    integer or a bool stays a string."""
    head = re.sub(r"<unnamed>::|\(anonymous namespace\)::", "",
                  re.sub(r"^\s*void\s+", "", name))
    qualified = re.match(r"[\w:]*", head).group(0)
    kernel = qualified.split("::")[-1]
    args, rest = [], head[len(qualified):]
    if rest.startswith("<"):
        depth, cur = 0, ""
        for ch in rest[1:]:
            if ch == "<":
                depth += 1
            elif ch == ">" and depth == 0:
                break
            elif ch == ">":
                depth -= 1
            if ch == "," and depth == 0:
                args.append(cur)
                cur = ""
            else:
                cur += ch
        args.append(cur)
    out = []
    for a in args:
        a = re.sub(r"^\((?:unsigned |signed )?\w+\)", "", a.strip()).strip()
        a = {"true": "1", "false": "0"}.get(a, a)
        if a:
            out.append(int(a.rstrip("uUlL"))
                       if re.fullmatch(r"-?\d+[uUlL]*", a) else a)
    return kernel, tuple(out)


def _frontier_modes(kernel, args, families):
    """The (family, mode) pairs a frontier kernel instance serves, None for
    another kernel."""
    if kernel == "frontier_fwd_epilogue":
        return [(fam, "fwd") for fam in families]
    if kernel == "frontier_fwd_pass1":
        return [(families[args[0]], "fwd")]
    if kernel == "frontier_grad_pass1":
        return [(families[args[0]], "grad"), (families[args[0]], "pgrad")]
    if kernel in ("frontier_grad_pass2", "frontier_grad_epilogue"):
        return [(families[args[0]], "pgrad" if args[1] else "grad")]
    return None


def _card_limits():
    """(opt-in shared memory a block, threads a block, shared memory the
    card reserves a block, where each was read) of card 0: torch's device
    properties where they carry them, else libcuda's device attributes
    (CU_DEVICE_ATTRIBUTE 97 and 1); the reservation from libcuda (111),
    which cuobjdump counts in a kernel's SHARED."""
    import ctypes
    import torch
    props = torch.cuda.get_device_properties(0)
    cu = ctypes.CDLL("libcuda.so.1")
    dev, val = ctypes.c_int(), ctypes.c_int()
    if cu.cuInit(0) or cu.cuDeviceGet(ctypes.byref(dev), 0):
        raise RuntimeError("libcuda did not open device 0")

    def attr(code):
        err = cu.cuDeviceGetAttribute(ctypes.byref(val), code, dev)
        if err:
            raise RuntimeError(f"cuDeviceGetAttribute({code}): {err}")
        return int(val.value)
    out = {}
    for key, prop, code in (("optin", "shared_memory_per_block_optin", 97),
                            ("threads", "max_threads_per_block", 1)):
        v = getattr(props, prop, None)
        out[key] = (int(v), "torch") if v is not None else (attr(code),
                                                             "libcuda")
    out["reserved"] = (attr(111), "libcuda")
    return out


def phase_lint(ctx):
    """The port's linter over src/, the card's limits against the port's
    constants, and each built kernel instance's resources against them."""
    from repro_torch.analysis import format_text, run_paths
    from repro_torch.analysis.rules import launch as lint_launch
    from repro_torch.core.distributions import FAMILIES
    from repro_torch.kernels import _cuda, autotune, compose
    from repro_torch.kernels import family_score as fs
    fails = []
    t0 = time.perf_counter()
    findings = run_paths([os.path.join(HERE, "src")])
    lint_s = time.perf_counter() - t0
    log(f"[lint] repro_torch.analysis over src/: {len(findings)} findings "
        f"in {lint_s:.2f} s")
    if findings:
        log(format_text(findings))
        fails.append(f"{len(findings)} lint findings")

    card = _card_limits()
    (optin, _), (max_threads, _), (reserved, _) = (
        card["optin"], card["threads"], card["reserved"])
    log(f"[lint] card: shared_memory_per_block_optin {optin} "
        f"({card['optin'][1]}), max_threads_per_block {max_threads} "
        f"({card['threads'][1]}), reserved shared memory a block {reserved} "
        f"({card['reserved'][1]})")
    consts = {"autotune.SMEM_LIMIT_BYTES": autotune.SMEM_LIMIT_BYTES,
              "compose.SMEM_MAX": compose.SMEM_MAX,
              "family_score.SMEM_MAX": fs.SMEM_MAX}
    for k, v in consts.items():
        log(f"[lint] {k} = {v}" + ("" if v == optin else
                                   f"  FAIL: the card's is {optin}"))
        if v != optin:
            fails.append(f"{k} = {v} != the card's {optin}")
    if max_threads < autotune.MAX_THREADS:
        fails.append(f"autotune.MAX_THREADS = {autotune.MAX_THREADS} over "
                     f"the card's {max_threads}")

    if not _cuda.BUILD_INFO:
        phase_build(ctx)
    # the model's dynamic shared memory at each combination RPA030 audits
    plans = {(fam, mode, stk): lint_launch.model_plan(
        autotune, lint_launch.AUDIT_F[stk], lint_launch.AUDIT_K,
        lint_launch.AUDIT_T, mode, fam)[2]
        for fam in FAMILIES for mode in autotune.MODES
        for stk in (False, True)}
    rows, n_frontier = [], 0
    for stem, info in sorted(_cuda.BUILD_INFO.items()):
        for r in _cuda.resource_usage(info["path"]):
            # cuobjdump's SHARED holds the card's reservation besides the
            # kernel's static shared memory
            r["library"] = stem
            r["static_shared"] = r["shared"] - reserved
            rows.append(r)
            log(f"[lint] {stem} {r['name']}: {r['registers']} registers, "
                f"{r['static_shared']} B static shared (+{reserved} "
                f"reserved), {r['local']} B local, {r['stack']} B stack")
            tag = f"{stem} {r['name']}"
            if not 0 <= r["static_shared"] <= optin:
                fails.append(f"{tag}: {r['static_shared']} B static shared "
                             f"outside [0, {optin}]")
            kernel, args = _template(r["name"])
            served = (_frontier_modes(kernel, args, FAMILIES)
                      if stem == "frontier_grid" else None)
            if served is None:
                continue
            n_frontier += 1
            worst = max(plans[(fam, mode, stk)] for fam, mode in served
                        for stk in (False, True))
            r["frontier_smem_max"] = r["static_shared"] + worst
            if r["static_shared"] + worst > optin:
                fails.append(f"{tag}: {r['static_shared']} B static + "
                             f"{worst} B dynamic over {optin}")
            if kernel in FRONTIER_PASS1 and \
                    r["registers"] * autotune.MAX_THREADS > REGS_PER_BLOCK:
                fails.append(f"{tag}: {r['registers']} registers x "
                             f"{autotune.MAX_THREADS} threads over "
                             f"{REGS_PER_BLOCK}")
    if n_frontier != FRONTIER_INSTANCES:
        fails.append(f"{n_frontier} frontier instances read, expected "
                     f"{FRONTIER_INSTANCES}")
    # a spill lands in the stack frame (ptxas' "bytes stack frame"), as do
    # local arrays; cuobjdump records the frame, not the spills
    framed = [f"{r['library']} {r['name']} ({r['stack']} B stack, "
              f"{r['local']} B local)" for r in rows
              if r["stack"] or r["local"]]
    log(f"[lint] {len(rows)} kernel instances in {len(_cuda.BUILD_INFO)} "
        f"libraries; {len(framed)} with a stack frame or local bytes, where "
        f"spills land" + (": " + "; ".join(framed) if framed else ""))
    ctx["lint"] = {"findings": len(findings), "seconds": lint_s,
                   "smem_optin": optin, "max_threads_per_block": max_threads,
                   "reserved_smem": reserved, "instances": rows}
    if fails:
        raise AssertionError("lint phase: " + "; ".join(fails))


def _case(fam, F, K, per_row, seed, device):
    """Inputs with edge rows: row 0 has a zero weight, channel 3 a zero
    sigma, channel 5 p = 0 (defective), rows 2 and 3 an argmax tie between
    channels 0 and 1."""
    import numpy as np
    import torch
    from repro_torch.core import distributions as dists
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(K), F)
    W[0, 7] = 0.0
    shape = (F, K) if per_row else (K,)
    mus = rng.uniform(10.0, 40.0, shape)
    sgs = mus * rng.uniform(0.02, 0.3, shape)
    sgs[..., 3] = 0.0
    mus[..., 1] = mus[..., 0]
    sgs[..., 1] = sgs[..., 0]
    W[2:4, 0] = W[2:4, 1] = 0.5
    W[2:4, 2:] = 0.0
    W = W / W.sum(1, keepdims=True)
    ex_shape = shape
    if fam == "drift":
        ex = rng.uniform(0.0, 0.8, (1,) + ex_shape)
        ex[:, ..., 1] = ex[:, ..., 0]
    elif fam == "defective":
        ex = np.stack([rng.uniform(0.02, 0.3, ex_shape),
                       np.full(ex_shape, 1.0)])
        ex[0, ..., 5] = 0.0
        ex[0, ..., 1] = ex[0, ..., 0]
    elif fam == "empirical":
        pis = rng.dirichlet(np.ones(3), ex_shape)
        pis = np.moveaxis(pis, -1, 0)
        ms = mus[None] * rng.uniform(0.7, 1.3, (3,) + ex_shape)
        ss = np.maximum(sgs[None], 0.5) * rng.uniform(0.3, 1.0,
                                                      (3,) + ex_shape)
        ss[2, ..., 6] = 0.0
        ex = np.concatenate([pis, ms, ss])
        ex[:, ..., 1] = ex[:, ..., 0]
    else:
        ex = np.zeros((dists.extra_rows(fam),) + ex_shape)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return t(W), t(mus), t(sgs), t(ex)


def _rel_l2(a, b):
    import torch
    den = torch.linalg.norm(b.double())
    num = torch.linalg.norm((a - b).double())
    return float(num / den) if float(den) > 0 else float(num)


def _compare(got, want):
    """(max |err| per output, relative L2 per adjoint, within tolerance)."""
    import torch
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    ok = bool(torch.allclose(got[0], want[0], rtol=TOL_MU, atol=TOL_MU))
    ok &= bool(torch.allclose(got[1], want[1], rtol=TOL_VAR[0],
                              atol=TOL_VAR[1]))
    rel = [_rel_l2(g, w) for g, w in zip(got[2:], want[2:])]
    ok &= all(r <= TOL_ADJ for r in rel)
    ok &= all(bool(torch.isfinite(g).all()) for g in got)
    return errs, rel, ok


def _report(phase, tag, errs, rel, ok):
    log(f"[{phase}] {tag} max|err| "
        + " ".join(f"{e:.2e}" for e in errs)
        + ("" if not rel else
           "  relL2(adj) " + " ".join(f"{r:.1e}" for r in rel))
        + ("  ok" if ok else "  FAIL"))


# The launches of one balancer refresh at K=1024 (sched/balancer.py with
# core/partitioner.py): the PGD steps (grad) over the warm, equal and
# inverse-mu starts at num_t=1024, the finalists (fwd) at eval_num_t=2048,
# and under risk_lam / adaptive_refresh the sensitivity launches (pgrad).
MAIN_PATH = (("grad", 3, 1024, 1024), ("fwd", 3, 1024, 2048),
             ("pgrad", 3, 1024, 1024), ("pgrad", 1, 1024, 1024))
# grids past the 4096 points one block per row once allowed: the splits
# tile them (family, F, K, T)
LONG_GRIDS = tuple((fam, 3, 1024, T) for T in (8192, 16384)
                   for fam in ("normal", "lognormal"))


def phase_check(ctx):
    import torch
    from repro_torch.core.distributions import FAMILIES
    from repro_torch.kernels import frontier_grid as fg, ref
    dev = torch.device("cuda")
    worst = {m: 0.0 for m in KERNELS}
    fails = []
    cases = [(fam, per_row, 256, 128, 256, MODES) for fam in FAMILIES
             for per_row in (False, True)]
    cases.append(("normal", False, 64, 128, 2048, MODES))
    cases += [(fam, False, F, K, T, MODES) for fam, F, K, T in LONG_GRIDS]
    cases += [("normal", False, F, K, T, (mode,))
              for mode, F, K, T in MAIN_PATH]
    main_ms = []
    for i, (fam, per_row, F, K, T, modes) in enumerate(cases):
        W, mus, sgs, ex = _case(fam, F, K, per_row, 100 + i, dev)
        for mode in modes:
            if mode == "fwd":
                def kern():
                    return fg.frontier_grid(W, mus, sgs, ex, num_t=T,
                                            dist_id=fam)
                want = ref.frontier_grid_ref(W, mus, sgs, num_t=T,
                                             dist_id=fam, extra=ex)
            else:
                def kern(pg=(mode == "pgrad")):
                    return fg.frontier_grid_with_grads(
                        W, mus, sgs, ex, num_t=T, dist_id=fam,
                        param_grads=pg)
                want = ref.frontier_grid_with_grads_ref(
                    W, mus, sgs, num_t=T, dist_id=fam, extra=ex,
                    param_grads=(mode == "pgrad"))
            got, again = kern(), kern()
            torch.cuda.synchronize()
            errs, rel, ok = _compare(got, want)
            # two launches give the same bits
            ok &= all(torch.equal(a, b) for a, b in zip(got, again))
            worst[mode] = max(worst[mode], max(errs))
            tag = f"{fam:9s} {'per-row' if per_row else 'shared ':7s} " \
                  f"F={F} K={K} T={T} {mode:5s}"
            _report("check", tag, errs, rel, ok)
            if not ok:
                fails.append(tag)
            if len(modes) == 1:
                # a main-path launch: its time on the card at that shape,
                # and the blocks of each kernel launch one call makes
                ms = _time_cuda(kern, reps=9)
                dev_ms, host_ms = _device_ms(kern), _host_ms(kern, reps=50)
                bound_ms, by = _bound(mode, F, K, T, ex.shape[0], per_row)
                blocks = _call_blocks(mode, F, K, T, fam)
                main_ms.append({"mode": mode, "F": F, "K": K, "T": T,
                                "ms": ms, "device_ms": dev_ms,
                                "host_ms": host_ms, "bound_ms": bound_ms,
                                "bound_by": by, "blocks": blocks,
                                "launches_per_call": len(blocks)})
                log(f"[check] {tag} kernel {ms:.4f} ms (device "
                    + (f"{dev_ms:.4f}" if dev_ms is not None else "n/a")
                    + f", host {host_ms:.4f} ms per call)  bound "
                    f"{bound_ms:.4f} ms ({by})  blocks {blocks} in "
                    f"{len(blocks)} launch(es) per call")
    ctx["max_abs_err"] = worst
    ctx["main_path_ms"] = main_ms
    if fails:
        raise AssertionError(f"kernel/plain disagreement: {fails}")


def _call_blocks(mode, F, K, T, fam):
    """Blocks of each kernel launch of one wrapper call in the split of
    ``autotune.lookup_split``: the forward moments pass 1 and the epilogue;
    the fused adjoint pass 1, pass 2 and the epilogue."""
    from repro_torch.kernels import autotune
    return list(autotune.split_blocks(
        F, K, T, autotune.lookup_split(F, K, T, mode=mode, dist_id=fam)))


def _time_cuda(fn, reps=7, warm=2, per_pair=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events; with
    ``per_pair`` > 1 each pair of events brackets that many back-to-back
    calls and the time is per call (the host's launch path then overlaps
    the device's work instead of adding to it)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_pair):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per_pair)
    times.sort()
    return times[len(times) // 2]


def _bound(mode, F, K, T, E, per_row):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates."""
    evals = F * T * K
    special = evals * PASS1["special"]
    fp32 = evals * PASS1["fp32"]
    if mode != "fwd":
        special += evals * PASS2["special"]
        fp32 += evals * PASS2["fp32"]
    stat = F * K if per_row else K
    n_fk = {"fwd": 0, "grad": 2, "pgrad": 8}[mode]
    nbytes = 4 * (F * K + (2 + E) * stat + 2 * F + n_fk * F * K)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(special / SFU_OPS_PER_S, fp32 / FP32_OPS_PER_S)
    if t_bytes > t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def phase_tick(ctx):
    import numpy as np
    import torch
    from repro_torch.core.distributions import extra_rows
    from repro_torch.kernels import ops
    F, K, T = 4096, 1024, 256
    rng = np.random.default_rng(0)
    dev = "cuda"
    W = torch.tensor(rng.dirichlet(np.ones(K), F).astype(np.float32),
                     device=dev)
    mus = rng.uniform(10.0, 40.0, K).astype(np.float32)
    sgs = (mus * rng.uniform(0.02, 0.3, K)).astype(np.float32)
    fams = {"normal": "normal", "lognormal": "lognormal",
            "drift": ("drift", rng.uniform(0.1, 0.8, (1, K)).astype(
                np.float32))}
    mus_t = torch.tensor(mus, device=dev)
    sgs_t = torch.tensor(sgs, device=dev)
    rows, fails = [], []
    for name, fam in fams.items():
        dist_id, ex = ops._resolve_family(fam, K, torch.device(dev))
        for mode in ("fwd", "grad", "pgrad"):
            if mode == "fwd":
                def kern():
                    return ops.frontier_moments(W, mus_t, sgs_t, num_t=T,
                                                device=dev, family=fam)
            else:
                def kern(pg=(mode == "pgrad")):
                    return ops.frontier_moments_with_grads(
                        W, mus_t, sgs_t, num_t=T, device=dev, family=fam,
                        param_grads=pg)

            def plain(mode=mode):
                return ops.plain_moments(W, mus_t, sgs_t, ex, num_t=T,
                                         dist_id=dist_id, mode=mode)

            errs, rel, ok = _compare(kern(), plain())
            tag = f"{name:9s} {mode:5s} F={F} K={K} T={T}"
            _report("tick", tag, errs, rel, ok)
            if not ok:
                fails.append(tag)
            ms = _time_cuda(kern, reps=7)
            plain_ms = _time_cuda(plain, reps=3, warm=1)
            bound_ms, by = _bound(mode, F, K, T, extra_rows(dist_id), False)
            blocks = _call_blocks(mode, F, K, T, dist_id)
            rows.append({"family": name, "mode": mode, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": by, "max_abs_err": max(errs),
                         "blocks": blocks, "launches_per_call": len(blocks)})
            log(f"[tick] {tag} kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  "
                f"bound {bound_ms:.3f} ms ({by})  kernel/bound "
                f"{ms / bound_ms:.1f}x  blocks {blocks}")
            torch.cuda.empty_cache()
    ctx["tick"] = rows
    if fails:
        raise AssertionError(f"kernel/plain disagreement: {fails}")


# (family, mode, F, K, T, per-row statistics): the fleet tick, a refresh's
# launches at K=1024, and the shape where float32 sums missed the plain
# version most (ROADMAP section 3 item 3)
ACC32_CASES = (("normal", "fwd", 4096, 1024, 256, False),
               ("normal", "grad", 4096, 1024, 256, False),
               ("normal", "pgrad", 4096, 1024, 256, False),
               ("drift", "grad", 4096, 1024, 256, False),
               ("normal", "fwd", 3, 1024, 2048, False),
               ("normal", "grad", 3, 1024, 1024, False),
               ("normal", "pgrad", 3, 1024, 1024, False),
               ("drift", "pgrad", 256, 128, 256, True))


def phase_acc32(ctx):
    import torch
    from repro_torch.kernels import frontier_grid as fg, ops
    dev = torch.device("cuda")
    libs = {"f64": fg.build(), "f32": fg.build(ACC32)}
    rows = []
    for i, (fam, mode, F, K, T, per_row) in enumerate(ACC32_CASES):
        W, mus, sgs, ex = _case(fam, F, K, per_row, 300 + i, dev)

        def run(lib, mode=mode):
            if mode == "fwd":
                return fg.launch_fwd(lib, W, mus, sgs, ex, per_row, num_t=T,
                                     z=10.0, dist_id=fam)
            return fg.launch_grad(lib, W, mus, sgs, ex, per_row, num_t=T,
                                  z=10.0, dist_id=fam,
                                  param_grads=(mode == "pgrad"))

        want = ops.plain_moments(W, mus, sgs, ex, num_t=T, dist_id=fam,
                                 mode=mode)
        row = {"family": fam, "mode": mode, "F": F, "K": K, "T": T,
               "per_row": per_row}
        for name, lib in libs.items():
            got = run(lib)
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"{name} build gave non-finite output")
            errs, rel, _ = _compare(got, want)
            row[f"{name}_max_abs_err"] = max(errs)
            row[f"{name}_max_rel_l2_adj"] = max(rel) if rel else None
        # f64, f32, f32, f64: each build's time is the mean of its two
        times = {"f64": [], "f32": []}
        for name in ("f64", "f32", "f32", "f64"):
            times[name].append(_time_cuda(lambda: run(libs[name]), reps=7))
        for name, ts in times.items():
            row[f"{name}_ms"] = sum(ts) / len(ts)
        row["f64_over_f32"] = row["f64_ms"] / row["f32_ms"]
        rows.append(row)
        adj = ("" if row["f32_max_rel_l2_adj"] is None else
               f"  relL2(adj) f64 {row['f64_max_rel_l2_adj']:.1e} "
               f"f32 {row['f32_max_rel_l2_adj']:.1e}")
        log(f"[acc32] {fam:9s} {mode:5s} F={F} K={K} T={T}"
            f"{' per-row' if per_row else ''}: float64 sums "
            f"{row['f64_ms']:.3f} ms, float32 sums {row['f32_ms']:.3f} ms, "
            f"ratio {row['f64_over_f32']:.3f}; max|err| f64 "
            f"{row['f64_max_abs_err']:.1e} f32 {row['f32_max_abs_err']:.1e}"
            + adj)
        torch.cuda.empty_cache()
    ctx["acc32"] = rows


def _closed_loop(policy, device, ticks=40, K=1024, slow_at=20, **kw):
    import numpy as np
    import torch
    from repro_torch.sched import UncertaintyAwareBalancer
    from repro_torch.sim import ClusterSim
    bal = UncertaintyAwareBalancer(K, lam=0.02, refresh_every=10,
                                   pgd_steps=60, policy=policy,
                                   device=device, **kw)
    sim = ClusterSim.heterogeneous(K, seed=0)
    joins, tick_s, ws = [], [], []
    for t in range(ticks):
        if t == slow_at:
            sim.inject_slowdown(0, 3.0)
        t0 = time.perf_counter()
        w = bal.weights()
        if device != "cpu":
            torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        join, durs = sim.run_step(w)
        bal.observe(durs, w)
        joins.append(join)
        ws.append(w)
        if not (np.all(np.isfinite(w)) and w.shape == (K,)
                and abs(w.sum() - 1.0) < 1e-4 and w.min() >= 0.0):
            raise AssertionError(f"bad split at tick {t}: {w}")
    return np.asarray(joins), np.asarray(tick_s), np.asarray(ws)


def phase_loop(ctx):
    import numpy as np
    import torch
    from repro_torch.kernels import frontier_grid as fg
    # the closed loop agrees with the CPU plain path on a small fleet
    _, _, w_gpu = _closed_loop("frontier", "cuda", ticks=6, K=8, slow_at=3)
    _, _, w_cpu = _closed_loop("frontier", "cpu", ticks=6, K=8, slow_at=3)
    diff = float(np.abs(w_gpu - w_cpu).max())
    log(f"[loop] K=8 6 ticks cuda vs cpu plain: max |w diff| {diff:.2e}")
    if diff > 1e-3:
        raise AssertionError(f"cuda and cpu closed loops disagree: {diff}")

    torch.cuda.synchronize()
    fg.reset_launches()
    stats = {}
    for name, policy, kw in (("frontier", "frontier", {}),
                             ("equal", "equal", {}),
                             ("frontier+adaptive+risk", "frontier",
                              {"adaptive_refresh": True, "risk_lam": 0.5})):
        joins, tick_s, ws = _closed_loop(policy, "cuda", **kw)
        if name == "frontier":
            ctx["loop_ws"] = ws   # the trace phase's untraced decisions
        stats[name] = {"join_mean": float(joins.mean()),
                       "join_p99": float(np.percentile(joins, 99)),
                       "tick_mean_s": float(tick_s.mean()),
                       "tick_max_s": float(tick_s.max())}
        log(f"[loop] {name:23s} join mean {joins.mean():.4f} p99 "
            f"{np.percentile(joins, 99):.4f}  tick mean "
            f"{1e3 * tick_s.mean():.2f} ms max {1e3 * tick_s.max():.1f} ms")
    torch.cuda.synchronize()
    counts = dict(fg.LAUNCHES)
    ctx["launches"] = counts
    ctx["loop"] = stats
    log(f"[loop] launches {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel mode never launched: {counts}")
    if stats["frontier"]["join_mean"] >= stats["equal"]["join_mean"]:
        raise AssertionError("the frontier policy did not beat equal split")


# warm refreshes timed on the host clock in phase_profile
PROFILE_REFRESHES = 5


def phase_profile(ctx):
    """Where one balancer refresh at K=1024 spends its time: warm-started
    solves timed on the host clock (the median of PROFILE_REFRESHES), then
    one under torch.profiler for the device time by kernel; busy share =
    device time / the median untraced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.sched import UncertaintyAwareBalancer
    from repro_torch.sim import ClusterSim
    K = 1024
    bal = UncertaintyAwareBalancer(K, lam=0.02, refresh_every=1,
                                   pgd_steps=60, device="cuda")
    sim = ClusterSim.heterogeneous(K, seed=0)

    def refresh():
        w = bal.weights()
        torch.cuda.synchronize()
        _, d = sim.run_step(w)
        bal.observe(d, w)

    refresh()   # cold solve: no warm start yet
    walls = []
    for _ in range(PROFILE_REFRESHES):
        t0 = time.perf_counter()
        refresh()
        walls.append(1e3 * (time.perf_counter() - t0))
    walls.sort()
    wall_ms = walls[len(walls) // 2]
    grads, fwds = fg.LAUNCHES["grad"], fg.LAUNCHES["fwd"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        refresh()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    grads = fg.LAUNCHES["grad"] - grads
    fwds = fg.LAUNCHES["fwd"] - fwds
    by_name = {}
    for e in prof.key_averages():
        # device events only: a host op's self device time repeats its
        # kernels' time
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    dev_ms = sum(by_name.values())
    # the fused adjoint's three kernels (pass 1, pass 2, epilogue)
    grad_ms = sum(ms for n, ms in by_name.items() if "frontier_grad" in n)
    # the forward split's two kernels (pass 1, epilogue)
    fwd_ms = sum(ms for n, ms in by_name.items() if "frontier_fwd" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    prof.export_chrome_trace(os.path.join(OUT_DIR, "refresh_trace.json"))
    busy = dev_ms / wall_ms if dev_ms > 0 else None
    per_grad = grad_ms / grads if grads and grad_ms > 0 else None
    per_fwd = fwd_ms / fwds if fwds and fwd_ms > 0 else None
    ctx["profile"] = {"wall_ms": wall_ms, "wall_ms_each": walls,
                      "traced_wall_ms": traced_ms,
                      "device_ms": dev_ms if dev_ms > 0 else None,
                      "busy_share": busy, "grad_calls": grads,
                      "grad_device_ms_per_call": per_grad,
                      "fwd_calls": fwds, "fwd_device_ms_per_call": per_fwd,
                      "top": [{"name": n, "ms": ms} for n, ms in top]}
    log(f"[profile] one refresh at K={K}: wall {wall_ms:.2f} ms (median of "
        f"{len(walls)}: " + " ".join(f"{w:.2f}" for w in walls)
        + f"; traced {traced_ms:.2f} ms), device "
        + (f"{dev_ms:.2f} ms, busy share {busy:.3f}" if busy is not None
           else "time not measured (the profiler saw no device time)"))
    log(f"[profile] fused adjoint: {grads} grad calls, device "
        + (f"{grad_ms:.3f} ms, {per_grad:.4f} ms per call"
           if per_grad is not None else "time not measured"))
    log(f"[profile] forward split: {fwds} fwd calls, device "
        + (f"{fwd_ms:.3f} ms, {per_fwd:.4f} ms per call"
           if per_fwd is not None else "time not measured"))
    for n, ms in top:
        log(f"[profile]   {ms:8.3f} ms  {n[:90]}")


def phase_twoch(ctx):
    import numpy as np
    from repro_torch.core import optimize_2ch
    # the paper's Fig. 1 parameters
    got = optimize_2ch(30.0, 2.0, 20.0, 6.0, lam=0.0, device="cuda")
    want = optimize_2ch(30.0, 2.0, 20.0, 6.0, lam=0.0, device="cpu")
    log(f"[twoch] cuda w={np.round(got.weights, 4)} mu={got.mu:.4f} "
        f"var={got.var:.4f}; cpu plain w={np.round(want.weights, 4)} "
        f"mu={want.mu:.4f}")
    if np.abs(got.weights - want.weights).max() > 1e-3 or \
            abs(got.mu - want.mu) > 1e-3 * abs(want.mu):
        raise AssertionError("two-channel split differs from the plain path")


# ---------------------------------------------------------------- model zoo
# Model kernels: JSON name, source, and the Pallas kernel each replaces.
LM_KERNELS = {
    "rmsnorm": ("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:21"),
    "flash_attention": ("flash_attention", "src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/flash_attention.py:83"),
    "flash_decode": ("flash_decode", "src/repro_torch/csrc/attention.cu",
                     "src/repro/kernels/flash_decode.py:68"),
    "ssd_scan": ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:80"),
}
# the model-serving paths whose launch counts (each from zero) the JSON
# line's model kernels sum
LM_PATHS = ("serve", "ssmserve", "moeserve", "zoo", "examples", "train",
            "shard")
# the attention-path kernels (every model but Mamba2 launches all three,
# DeepSeek-V2-Lite all but flash_decode: its MLA decode is plain matmuls)
ATTN_PATH = ("rmsnorm", "flash_attention", "flash_decode")

# the CUDA functions of each model kernel, as the profiler names them
LM_SYMBOLS = {"flash_attention": ("fa_wgmma_kernel", "fa_f32_kernel"),
              "flash_decode": ("fd_split_kernel", "fd_combine_kernel"),
              "rmsnorm": ("rmsnorm_",),
              "ssd_scan": ("ssd_pass", "ssd_one_kernel")}

# kernel against plain version on the card, per output dtype (atol = rtol)
LM_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# the SSD scan's y and final state: its sums run over up to L (L+1) / 2 + N
# products, ~1.5x those of attention's rows at D = 128
SSD_TOL = {"float32": 5e-4, "bfloat16": 1e-2}
# the tiny model on the card against the same model on the CPU
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)
# Mamba layers beyond which a tiny model's logits are reported, not held:
# ssd_scan's float32 instance (split bf16 planes, ROADMAP §3 item 12) is
# ~1e-4 from its plain version a layer, and a random-weight stack grows
# that ~1.25x a layer (item 5): Jamba's 14 tiny mamba layers reach 5e-3
# (item 23); each of its layers is held on its own input
TINY_E2E_MAMBA = 2

# Float32 attention on the tensor cores takes each float32 product as
# three products of split operands: the kernels split into TF32 (a third of
# TF32_OPS_PER_S), but two bf16 planes meet the float32 tolerance too
# (tests/test_torch_attention_numerics.py::
# test_split_bf16_attention_holds_float32) at a third of the bf16 rate,
# the fastest split that does. So the float32 attention bound takes the
# operations at F32_SPLIT_OPS_PER_S (BF16_OPS_PER_S / 3); the split-TF32
# figure and the CUDA-core one (FP32_OPS_PER_S) are logged beside it

# Qwen3-8B's serving path: 5 batches of 64 prompts of 16 tokens, max_new 8,
# split across two replica groups (about 32 prompts each)
SERVE_BATCHES, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 5, 64, 16, 8

# (name, B, Hq, Hkv, Sq, Sk, D, causal, window): the bf16 kernel's head
# dims 64, 80, 128 and 192, ragged S against its 128-row query tiles,
# Nemotron-4-340B's layer (96 query and 8 KV heads of 192) with B and S
# cut, and short prompts packed by kv group (Qwen3-8B's group of 4,
# smollm-360m's group of 3, Nemotron's 12 across two blocks)
ATTN_CASES = (
    ("causal", 2, 4, 4, 256, 256, 128, True, None),
    ("window64-ragged", 2, 4, 2, 300, 300, 64, True, 64),
    ("gqa4", 1, 8, 2, 200, 200, 128, True, None),
    ("rect-noncausal", 2, 4, 2, 100, 260, 64, False, None),
    ("noncausal-d80", 1, 4, 1, 128, 128, 80, False, None),
    ("causal-d80-ragged", 1, 32, 8, 333, 333, 80, True, None),
    ("window100-d192-ragged", 1, 4, 2, 450, 450, 192, True, 100),
    ("nemotron-4-340b layer S=300", 1, 96, 8, 300, 300, 192, True, None),
    ("nemotron-4-340b packed S=16", 2, 96, 8, 16, 16, 192, True, None),
    ("qwen3-8b prefill", 32, 32, 8, 16, 16, 128, True, None),
    ("smollm-360m packed group 3", 4, 15, 5, 16, 16, 64, True, None),
    ("smollm-360m batcher prefill", 32, 15, 5, 12, 12, 64, True, None),
    ("tiny prefill", 2, 4, 2, 16, 16, 16, True, None),
    ("whisper-large-v3 encoder", 2, 20, 20, 1500, 1500, 64, False, None),
    ("whisper-large-v3 cross", 2, 20, 20, 16, 1500, 64, False, None),
    ("internvl2-76b prefill 256+16", 2, 64, 8, 272, 272, 128, True, None),
    ("qwen3-moe prefill", 2, 64, 4, 16, 16, 128, True, None),
)
# (name, B, H, S, D, Dv): DeepSeek-V2-Lite's MLA prefill, 16 heads with q
# and k of 192 and v of 128 (the bf16 kernel's (192, 128) instance), at a
# ragged S and at the serving path's 32 prompts of 16 tokens
MLA_CASES = (("deepseek-v2-lite mla prefill S=300", 1, 16, 300, 192, 128),
             ("deepseek-v2-lite mla prefill B=32 S=16", 32, 16, 16, 192, 128))
# (name, B, Hkv, G, S, D, valid slots[, leading slots cleared]): one split
# at short S, several splits (flash_decode.decode_splits) with a whole
# split invalid, S = 4096, Nemotron's group of 12 at D = 192, and the
# examples' SmolLM-360M batcher (12-token prompts, 8 new tokens: a cache of
# 20 with 13 to 19 valid slots, up to 40 requests a group)
DECODE_CASES = (
    ("qwen3-8b decode", 32, 8, 4, 24, 128, 17),
    ("qwen3-8b last step", 32, 8, 4, 24, 128, 24),
    ("smollm-360m batcher decode", 32, 5, 3, 20, 64, 13),
    ("smollm-360m batcher last step", 40, 5, 3, 20, 64, 19),
    ("g1-ragged", 2, 2, 1, 200, 64, 150),
    ("g8", 1, 1, 8, 256, 128, 256),
    ("tiny decode", 2, 2, 2, 20, 16, 17),
    ("splits S=4096 two invalid", 1, 2, 4, 4096, 128, 3000, 600),
    ("splits B=32 S=2048", 32, 8, 4, 2048, 128, 1500),
    ("nemotron-4-340b decode splits", 2, 8, 12, 1000, 192, 700),
    ("splits d80 ragged", 2, 8, 4, 777, 80, 500, 259),
    ("whisper-large-v3 cross decode", 2, 20, 1, 1500, 64, 1500),
    ("whisper-large-v3 self decode", 2, 20, 1, 23, 64, 17),
    ("qwen3-moe decode g16", 2, 4, 16, 23, 128, 17),
    ("internvl2-76b decode g8", 2, 8, 8, 279, 128, 273),
)
# (name, B, S, H, P, G, N, chunk): ragged S, S >= 1024, G = 2, chunks of
# 16/64/128, Mamba2-2.7B's own shapes (the full-width prefill check and one
# group's serving prefill) in one group of chunks (8 x 300), two (4 x 300),
# a group per chunk (2 x 300) and eight groups of eight (S = 8192), and the
# tiny config (autotune.ssd_groups sets the groups from the shape)
SSD_CASES = (
    ("ragged g2 chunk64", 2, 200, 4, 32, 2, 64, 64),
    ("many chunks chunk128", 1, 1100, 4, 64, 1, 128, 128),
    ("many chunks g2 chunk16", 2, 1030, 4, 16, 2, 32, 16),
    ("mamba2-2.7b prefill 2x300", 2, 300, 80, 64, 1, 128, 128),
    ("mamba2-2.7b one group 8x300", 8, 300, 80, 64, 1, 128, 128),
    ("mamba2-2.7b two groups 4x300", 4, 300, 80, 64, 1, 128, 128),
    ("mamba2-2.7b eight groups S=8192", 1, 8192, 80, 64, 1, 128, 128),
    ("mamba2-2.7b path", 32, 16, 80, 64, 1, 128, 128),
    ("short prompt", 3, 13, 8, 64, 1, 128, 128),
    ("tiny", 2, 24, 16, 8, 1, 16, 16),
)
# (name, rows, D): Qwen3-8B's norms at the serving path's prefill (32 x 16
# tokens: ln1/ln2/final_norm, q_norm over 32 heads, k_norm over 8) and
# decode shapes, SmolLM-360M's (d_model 960) at the examples' batcher
# prefill (40 x 12 tokens) and decode, a ragged count and the tiny config
NORM_CASES = (("ln prefill", 512, 4096), ("q_norm prefill", 16384, 128),
              ("k_norm prefill", 4096, 128), ("ln decode", 32, 4096),
              ("smollm-360m batcher prefill", 480, 960),
              ("smollm-360m batcher decode", 32, 960),
              ("ragged", 21, 4096), ("tiny", 7, 16),
              ("deepseek-v2-lite kv_norm", 512, 512),
              ("deepseek-v2-lite ln", 512, 2048),
              ("whisper-large-v3 encoder ln", 3000, 1280),
              ("qwen3-moe q_norm", 2048, 128))
# (tag, rows, D) of lmtick's rmsnorm rows: every norm of the two serving
# paths (one group: 32 prompts of 16 tokens, then decode steps of 32
# tokens) -- Qwen3-8B's ln1/ln2/final_norm, q_norm over 32 heads and
# k_norm over 8; Mamba2-2.7B's ln1/final_norm (d_model 2560) and gated
# ssm_norm (ssm_inner 5120) -- then a long prefill's 32768 rows of 4096;
# DeepSeek-V2-Lite's (d_model 2048, the latent's kv_norm over 512) at the
# same serving shapes, and Whisper-large-v3's encoder norm over 2 x 1500
# frames (d_model 1280)
NORM_TICKS = (
    ("path qwen3-8b prefill ln", 512, 4096),
    ("path qwen3-8b prefill q_norm", 16384, 128),
    ("path qwen3-8b prefill k_norm", 4096, 128),
    ("path qwen3-8b decode ln", 32, 4096),
    ("path qwen3-8b decode q_norm", 1024, 128),
    ("path qwen3-8b decode k_norm", 256, 128),
    ("path mamba2-2.7b decode ln", 32, 2560),
    ("path mamba2-2.7b decode ssm_norm", 32, 5120),
    ("path mamba2-2.7b prefill ln", 512, 2560),
    ("path mamba2-2.7b prefill ssm_norm", 512, 5120),
    ("serving 32768 x 4096", 32768, 4096),
    ("moe path deepseek-v2-lite prefill ln", 512, 2048),
    ("moe path deepseek-v2-lite prefill kv_norm", 512, 512),
    ("moe path deepseek-v2-lite decode ln", 32, 2048),
    ("moe path deepseek-v2-lite decode kv_norm", 32, 512),
    ("zoo whisper-large-v3 encoder ln", 3000, 1280))


def _lm_modules():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    return rn, fa, fd, ssd


def _reset_all():
    from repro_torch.kernels import frontier_grid as fg
    for mod in (fg, *_lm_modules()):
        mod.reset_launches()


def _lm_launches():
    out = {}
    for mod in _lm_modules():
        out.update(mod.LAUNCHES)
    return out


def _gen(seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _attn_inputs(case, dtype, seed):
    _, B, Hq, Hkv, Sq, Sk, D, _, _ = case
    g = _gen(seed)
    return (_randn(g, (B, Hq, Sq, D), dtype), _randn(g, (B, Hkv, Sk, D), dtype),
            _randn(g, (B, Hkv, Sk, D), dtype))


def _decode_inputs(case, dtype, seed):
    """q, k, v and a mask of ``n_valid`` random valid slots, the first
    ``dead`` of them cleared (a split with no valid slot)."""
    import torch
    _, B, Hkv, G, S, D, n_valid, *dead = case
    g = _gen(seed)
    valid = torch.zeros(S, dtype=torch.bool, device="cuda")
    valid[torch.randperm(S, generator=g, device="cuda")[:n_valid]] = True
    valid[:dead[0] if dead else 0] = False
    return (_randn(g, (B, Hkv, G, D), dtype), _randn(g, (B, Hkv, S, D), dtype),
            _randn(g, (B, Hkv, S, D), dtype), valid)


def _ssd_inputs(case, dtype, seed):
    """x, dt, A, Bm, Cm, D of an SSD case: dt = softplus(normal) / 2,
    A = -exp(0.3 normal), B and C 0.3 normal, D = 0.5 + |normal|."""
    import torch
    import torch.nn.functional as F
    _, B, S, H, P, G, N, _ = case
    g = _gen(seed)
    f32 = torch.float32
    x = _randn(g, (B, S, H, P), dtype)
    dt = F.softplus(_randn(g, (B, S, H), f32)) * 0.5
    A = -torch.exp(0.3 * _randn(g, (H,), f32))
    Bm = (0.3 * _randn(g, (B, S, G, N), f32)).to(dtype)
    Cm = (0.3 * _randn(g, (B, S, G, N), f32)).to(dtype)
    D = 0.5 + _randn(g, (H,), f32).abs()
    return x, dt, A, Bm, Cm, D


def _norm_inputs(rows, D, dtype, seed):
    g = _gen(seed)
    x = 3.0 * _randn(g, (rows, D), dtype)
    w = (1.0 + 0.1 * _randn(g, (D,), dtype).float()).to(dtype)
    return x, w


def phase_lmcheck(ctx):
    """Each model kernel against its plain version on the card, in float32
    and bf16, twice (bitwise-equal runs), plus the dead-row rule; then the
    tiny Qwen3 and Mamba2 models on the card against themselves on the
    CPU."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd
    fails, worst = [], {k: 0.0 for k in LM_KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def hold(kernel, tag, run, plain, tols=LM_TOL):
        """Every output of ``run`` against ``plain``'s, each at the
        tolerance of its own dtype (float32 attention at relative L2 as
        well, ``_f32_attn_rel``); a second run must repeat the bits."""
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, again, want = (got,), (again,), (want,)
        errs, rels, ok = [], [], True
        for g, a, w in zip(got, again, want):
            tol = tols[str(g.dtype).split(".")[-1]]
            errs.append(float((g.float() - w.float()).abs().max()))
            ok &= bool(torch.allclose(g.float(), w.float(), atol=tol,
                                      rtol=tol))
            ok &= bool(torch.isfinite(g).all()) and torch.equal(g, a)
            rel = _f32_attn_rel(kernel, g, w)
            if rel is not None:
                rels.append(rel)
                ok &= rel < tol
        worst[kernel] = max(worst[kernel], *errs)
        log(f"[lmcheck] {kernel:15s} {tag:40s} max|err| "
            + " ".join(f"{e:.2e}" for e in errs)
            + "".join(f" rel L2 {r:.2e}" for r in rels)
            + f" (tol {tols[str(got[0].dtype).split('.')[-1]]:g}) "
            + ("ok" if ok else "FAIL"))
        if not ok:
            fails.append(f"{kernel} {tag}")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for i, case in enumerate(ATTN_CASES):
            name, *_, causal, window = case
            q, k, v = _attn_inputs(case, dtype, 10 + i)
            hold("flash_attention", f"{name} {dn} {tuple(q.shape)}",
                 lambda: ops.attention(q, k, v, causal=causal, window=window),
                 lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
        for i, (name, B, H, S, D, Dv) in enumerate(MLA_CASES):
            g = _gen(80 + i)
            q, k = (_randn(g, (B, H, S, D), dtype) for _ in range(2))
            v = _randn(g, (B, H, S, Dv), dtype)
            hold("flash_attention", f"{name} {dn} v {tuple(v.shape)}",
                 lambda: ops.attention(q, k, v, causal=True,
                                       sm_scale=D ** -0.5),
                 lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                 sm_scale=D ** -0.5))
        for i, case in enumerate(DECODE_CASES):
            q, k, v, valid = _decode_inputs(case, dtype, 30 + i)
            splits = fd.decode_splits(case[1], case[2], case[4], sms)[0]
            hold("flash_decode",
                 f"{case[0]} {dn} S={case[4]} splits={splits}",
                 lambda: ops.decode_attention(q, k, v, valid),
                 lambda: ref.decode_attention_ref(q, k, v, valid))
        for i, (name, rows, D) in enumerate(NORM_CASES):
            x, w = _norm_inputs(rows, D, dtype, 50 + i)
            hold("rmsnorm", f"{name} {dn} ({rows}, {D})",
                 lambda: ops.rmsnorm(x, w, eps=1e-6),
                 lambda: ref.rmsnorm_ref(x, w, eps=1e-6))
        for i, case in enumerate(SSD_CASES):
            args, chunk = _ssd_inputs(case, dtype, 60 + i), case[-1]
            split = ssd.kernel_split(case[1], case[3], case[2], chunk, dtype)
            # y and the final state
            hold("ssd_scan", f"{case[0]} {dn} S={case[2]} groups "
                 f"{split.groups}x{split.per_group}",
                 lambda: ops.ssd(*args, chunk=chunk, return_final_state=True),
                 lambda: ref.ssd_chunked_ref(*args, chunk=chunk,
                                             return_final_state=True),
                 tols=SSD_TOL)
            del args
    # dead rows: the kernels give 0 where the plain versions give NaN
    q, k, v = _attn_inputs(ATTN_CASES[0], torch.float32, 70)
    dead_fa = ops.attention(q, k, v, causal=True, window=0)
    qd, kd, vd, _ = _decode_inputs(DECODE_CASES[0], torch.float32, 71)
    none = torch.zeros(kd.shape[2], dtype=torch.bool, device="cuda")
    dead_fd = ops.decode_attention(qd, kd, vd, none)
    torch.cuda.synchronize()
    dead_ok = bool((dead_fa == 0).all()) and bool((dead_fd == 0).all())
    log(f"[lmcheck] dead rows (window=0; no valid slot) give 0: {dead_ok}")
    if not dead_ok:
        fails.append("dead rows")
    ctx["lm_max_abs_err"] = worst
    # Mamba2's tiny chunk is 16: a prompt of 20 carries a state across two
    # (Jamba's mamba layers too); the wrappers take frames and patches
    ctx["lmcheck_model"] = {arch: _tiny_model_check(arch, S)
                            for arch, S in (("qwen3-8b", 16),
                                            ("mamba2-2.7b", 20),
                                            ("deepseek-v2-lite-16b", 16),
                                            ("qwen3-moe-235b-a22b", 16),
                                            ("jamba-1.5-large-398b", 20))}
    for arch in ("whisper-large-v3", "internvl2-76b"):
        ctx["lmcheck_model"][arch] = _tiny_wrapper_check(arch)
    for arch, r in ctx["lmcheck_model"].items():
        if not r["ok"]:
            fails.append(f"tiny {arch} cuda vs cpu")
    if fails:
        raise AssertionError(f"model kernel/plain disagreement: {fails}")


def _tiny_layerwise(cpu, gpu, toks):
    """Each layer of the tiny model on the CPU path's own input (its
    residual stream on ``toks``), card against CPU: the worst max |err| of
    a layer's update over the layers, and whether every layer holds at
    MODEL_TOL."""
    import torch
    from repro_torch.models.layers import embed_lookup
    pos_c = cpu._positions(*toks.shape)
    pos_g = gpu._positions(*toks.shape)
    worst, ok = 0.0, True
    with torch.inference_mode():
        x = embed_lookup(cpu.embed, toks, cpu.cfg)
        for bc, bg in zip(cpu.layers, gpu.layers):
            yc, _ = cpu._block_apply(bc, x, pos_c)
            yg, _ = gpu._block_apply(bg, x.cuda(), pos_g)
            uc, ug = yc - x, yg.cpu() - x
            worst = max(worst, float((ug - uc).abs().max()))
            ok &= bool(torch.allclose(ug, uc, **MODEL_TOL))
            x = yc
    return worst, ok


def _tiny_model_check(arch, S):
    """The tiny model on the card against the same weights on the CPU: the
    prefill logits at MODEL_TOL and 8 greedy tokens equal. A stack with
    more than TINY_E2E_MAMBA mamba layers (Jamba's 14) holds every layer
    on its own input at MODEL_TOL instead and reports the logits (ROADMAP
    §3 item 23)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config(arch).tiny()
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = build_model(cfg, device="cuda", seed=1)
    gpu.load_state_dict(cpu.state_dict())
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, S))
    with torch.inference_mode():
        lc, _ = cpu.prefill(torch.as_tensor(prompts), cache_len=24)
        lg, _ = gpu.prefill(torch.as_tensor(prompts, device="cuda"),
                            cache_len=24)
    err = float((lg.cpu() - lc).abs().max())
    close = bool(torch.allclose(lg.cpu(), lc, **MODEL_TOL))
    tc = ServeEngine(cpu, cfg, device="cpu").generate(prompts, 8)
    tg = ServeEngine(gpu, cfg, device="cuda").generate(prompts, 8).cpu()
    same = bool(torch.equal(tc, tg))
    out = {"prefill_max_abs_err": err, "tokens_equal": same}
    mamba = sum(b.spec.mixer == "mamba" for b in cpu.layers)
    if mamba > TINY_E2E_MAMBA:
        worst, held = _tiny_layerwise(cpu, gpu, torch.as_tensor(prompts))
        log(f"[lmcheck] tiny {arch} f32 every layer on its own input cuda vs "
            f"cpu max|err| {worst:.2e} ({'ok' if held else 'FAIL'}); "
            f"prefill logits over {mamba} mamba layers max|err| {err:.2e} "
            f"(reported, not held); greedy tokens equal: {same}")
        return {**out, "layerwise_max_abs_err": worst, "ok": held and same}
    log(f"[lmcheck] tiny {arch} f32 prefill logits cuda vs cpu max|err| "
        f"{err:.2e} ({'ok' if close else 'FAIL'}); greedy tokens equal: "
        f"{same}")
    return {**out, "ok": close and same}


def _wrapper_extra(cfg, B, gen_device="cpu", dtype=None, seed=0):
    """The frames (Whisper) or patch embeddings (VLM) of a batch of B:
    seeded normal numbers, (B, encoder_seq or num_patches, d_model)."""
    import numpy as np
    import torch
    n = cfg.encoder_seq or cfg.num_patches
    x = np.random.default_rng(seed).standard_normal((B, n, cfg.d_model))
    return torch.as_tensor(x.astype(np.float32), device=gen_device).to(
        dtype or torch.float32)


def _wrapper_generate(model, toks, extra, prompt, cache_len):
    """The wrapper's prefill of ``toks[:, :prompt]`` with its frames or
    patches, then one decode step per remaining token of ``toks``: the
    prefill logits and the decode steps' logits."""
    import torch
    lpre, cache = model.prefill(toks[:, :prompt], extra, cache_len=cache_len)
    ldec = torch.cat([model.decode_step(cache, toks[:, t:t + 1])[0]
                      for t in range(prompt, toks.shape[1])], 1)
    return lpre, ldec


def _tiny_wrapper_check(arch):
    """The tiny Whisper or VLM on the card against the same weights on the
    CPU: the prefill and 4 teacher-forced decode steps' logits, float32,
    at MODEL_TOL, with their frames or patches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).tiny()
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = build_model(cfg, device="cuda", seed=1)
    gpu.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 20))
    extra = _wrapper_extra(cfg, 4)
    cache_len = 20 + cfg.num_patches
    with torch.inference_mode():
        pc, dc = _wrapper_generate(cpu, torch.as_tensor(toks), extra, 16,
                                   cache_len)
        pg, dg = _wrapper_generate(gpu, torch.as_tensor(toks, device="cuda"),
                                   extra.cuda(), 16, cache_len)
    errs = [float((g.cpu() - c).abs().max()) for g, c in ((pg, pc), (dg, dc))]
    close = all(bool(torch.allclose(g.cpu(), c, **MODEL_TOL))
                for g, c in ((pg, pc), (dg, dc)))
    log(f"[lmcheck] tiny {arch} f32 prefill / 4 decode steps logits cuda vs "
        f"cpu max|err| {errs[0]:.2e} / {errs[1]:.2e} "
        f"({'ok' if close else 'FAIL'})")
    return {"prefill_max_abs_err": errs[0], "decode_max_abs_err": errs[1],
            "ok": close}


class _TimedEngine:
    """A ServeEngine whose generate calls are timed on the host clock,
    synchronized (the per-group generation wall time of a batch)."""

    def __init__(self, engine):
        self.engine, self.seconds = engine, []

    def generate(self, prompts, max_new):
        import torch
        t0 = time.perf_counter()
        out = self.engine.generate(prompts, max_new)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def _plain_ops():
    """The model's ops swapped for their plain versions (a comparison
    path, restored on exit)."""
    import contextlib
    from repro_torch.kernels import ops, ref

    @contextlib.contextmanager
    def swapped():
        saved = ops.attention, ops.decode_attention, ops.rmsnorm, ops.ssd
        ops.attention = ref.flash_attention_ref
        ops.decode_attention = ref.decode_attention_ref
        ops.rmsnorm = ref.rmsnorm_ref
        ops.ssd = ref.ssd_chunked_ref
        try:
            yield
        finally:
            (ops.attention, ops.decode_attention, ops.rmsnorm,
             ops.ssd) = saved
    return swapped()


def _build_full(cfg, tag):
    """The full-width model on the card, weights from seed 0, with its
    parameter count, init time and memory logged."""
    import torch
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}"
        f", {n_params / 1e9:.3f} B parameters in {cfg.param_dtype}, drawn on "
        f"the card in {init_s:.1f} s; {torch.cuda.memory_allocated() / 1e9:.1f}"
        f" GB allocated")
    return model, init_s, n_params


def _hold_logits(tag, what, got, want, cfg, limit=0.1):
    """Relative L2 and argmax agreement of two logit tensors over the
    unpadded vocabulary; fails at ``limit`` or above (None: reported only)
    or on a non-finite value."""
    import torch
    got = got[..., :cfg.vocab_size].float()
    want = want[..., :cfg.vocab_size].float()
    rel = _rel_l2(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(got).all())
    log(f"[{tag}] {what}: relative L2 {rel:.2e}, argmax agreement "
        f"{agree:.3f}, finite {finite}"
        + (" (reported, not held)" if limit is None else ""))
    if not finite or (limit is not None and not rel < limit):
        raise AssertionError(f"{what} disagrees: rel L2 {rel}")
    return rel, agree


def _serve_batches(tag, model, cfg, rng):
    """SERVE_BATCHES batches through two replica groups sharing ``model``
    behind a PartitionedBatcher (policy frontier) on ClusterSim([Channel(20,
    2), Channel(14, 5)]), as ``launch/serve.py`` sets it up, with every
    launch counter zeroed before the batches and read after. Returns the
    engine, the per-batch records, the counts, the last prompts and the
    number of generate calls."""
    import numpy as np
    import torch
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.serve import PartitionedBatcher, ReplicaGroup, ServeEngine
    from repro_torch.sim import Channel, ClusterSim
    engine = ServeEngine(model, cfg)
    timed = [_TimedEngine(engine), _TimedEngine(engine)]
    groups = [ReplicaGroup("fast", timed[0]), ReplicaGroup("slow", timed[1])]
    sim = ClusterSim([Channel(mu=20.0, sigma=2.0), Channel(mu=14.0, sigma=5.0)])
    batcher = PartitionedBatcher(groups, policy="frontier", sim=sim)
    batches, calls = [], 0
    torch.cuda.synchronize()
    _reset_all()
    for i in range(SERVE_BATCHES):
        prompts = rng.integers(0, cfg.vocab_size,
                               (SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)
        t0 = time.perf_counter()
        join, counts, resp = batcher.run_batch(prompts, max_new=SERVE_NEW,
                                               execute=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls += int((counts > 0).sum())
        gen_s = [t.seconds[-1] if c else 0.0 for t, c in zip(timed, counts)]
        for c, r in zip(counts, resp):
            if c and not (r.shape == (c, SERVE_NEW) and r.min() >= 0
                          and r.max() < cfg.vocab_size):
                raise AssertionError(f"bad response {r.shape} for {c}")
        tokens = int(counts.sum()) * SERVE_NEW
        batches.append({"split": counts.tolist(), "join_latency": join,
                        "generate_s": gen_s, "wall_s": wall,
                        "tokens_per_s": tokens / wall})
        log(f"[{tag}] batch {i}: split {counts.tolist()} join {join:.3f} s "
            f"(sim); generate {gen_s[0]:.3f} / {gen_s[1]:.3f} s; batch wall "
            f"{wall:.3f} s, {tokens / wall:.1f} tokens/s")
    torch.cuda.synchronize()
    launches = {**dict(fg.LAUNCHES), **_lm_launches()}
    log(f"[{tag}] launches {launches} over {calls} generate calls")
    # the batcher's balancer solves its two-channel split on the card
    # through the frontier kernels (forward moments at K=2)
    if sum(launches[m] for m in MODES) <= 0:
        raise AssertionError("the batcher's solve never launched a frontier "
                             "kernel")
    return engine, batches, launches, prompts, calls


def _repeat_and_profile(tag, engine, prompts):
    """Two generate calls on one batch must agree; then one group's
    generate under the profiler."""
    import torch
    a = engine.generate(prompts, SERVE_NEW)
    b = engine.generate(prompts, SERVE_NEW)
    same = bool(torch.equal(a, b))
    log(f"[{tag}] two generate calls on one batch of {len(prompts)}: "
        f"identical tokens {same}")
    if not same:
        raise AssertionError("generate is not deterministic")
    return same, _profile_generate(tag, engine,
                                   prompts[:SERVE_REQUESTS // 2])


def _serve_record(cfg, n_params, init_s, batches, same, prof, **checks):
    import torch
    steady = batches[1:]
    return {"model": cfg.name, "params": n_params, "init_s": init_s,
            **checks, "batches": batches, "deterministic": same,
            "profile": prof,
            "tokens_per_s_steady": (sum(x["tokens_per_s"] for x in steady)
                                    / len(steady)),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_serve(ctx):
    """The main path at full width: Qwen3-8B (36 layers, bf16, weights from
    a seeded generator on the card) shared by two replica groups behind a
    PartitionedBatcher (policy frontier) on ClusterSim([Channel(20, 2),
    Channel(14, 5)]), as ``launch/serve.py`` sets it up."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-8b")
    model, init_s, n_params = _build_full(cfg, "serve")

    # full width, on a small input: the kernels' path against the same
    # model with the plain versions swapped in, both on the card
    rng = np.random.default_rng(0)
    small = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)),
                            device="cuda")
    with torch.inference_mode():
        lk, _ = model.prefill(small, cache_len=24)
        with _plain_ops():
            lp, _ = model.prefill(small, cache_len=24)
    rel, agree = _hold_logits(
        "serve", "full-width prefill (2 x 16), kernels vs plain on the card",
        lk, lp, cfg)

    engine, batches, counts, prompts, _ = _serve_batches("serve", model, cfg,
                                                         rng)
    ctx["serve_launches"] = counts
    missing = [k for k in ATTN_PATH if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the serving path never launched {missing}")
    same, prof = _repeat_and_profile("serve", engine, prompts)
    ctx["serve"] = _serve_record(cfg, n_params, init_s, batches, same, prof,
                                 full_width_rel_l2=rel,
                                 full_width_argmax_agreement=agree)
    del model, engine
    torch.cuda.empty_cache()


# Depths (of Mamba2-2.7B's 64 layers) of the end-to-end comparisons; those
# up to SSM_E2E_LAYERS are held at relative L2 < 0.1, the deeper ones are
# reported. A random-weight Mamba2 amplifies a rounding difference from
# layer to layer: at full depth its plain path in bf16 and in float32, on
# the same weights, end more than the logits' norm apart, so no end-to-end
# tolerance there can tell a kernel from its plain version. Every layer is
# held at full depth on its own inputs instead (_ssm_layerwise).
SSM_DEPTHS = (8, 16, 32, 64)
SSM_E2E_LAYERS = 8


def _ssm_layerwise(model, cfg, toks):
    """Each mamba layer of ``model`` on the kernel path's own input (the
    residual stream of the forward on all of ``toks``): its mixer through
    the kernels against the plain versions on the first S - 4 tokens (y of
    the scan and its final state both feed the output), and its 4 decode
    steps from the kernel's final state against its forward on all S.
    Returns the worst relative L2 of each over the layers, each held at
    0.1."""
    import torch
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed_lookup, rms_norm
    S = toks.shape[1] - 4
    worst = {"prefill": (0.0, -1), "decode": (0.0, -1)}
    with torch.inference_mode():
        x = embed_lookup(model.embed, toks, cfg)
        for i, blk in enumerate(model.layers):
            h = rms_norm(x, blk.ln1, cfg.norm_eps)
            full = ssm.mamba_apply(blk.mixer, h, cfg)
            mk, (st, cv) = ssm.mamba_apply(blk.mixer, h[:, :S], cfg,
                                           return_state=True)
            with _plain_ops():
                mp = ssm.mamba_apply(blk.mixer, h[:, :S], cfg)
            dec = torch.cat([ssm.mamba_decode(blk.mixer, h[:, t:t + 1], cfg,
                                              st, cv)[0]
                             for t in range(S, S + 4)], 1)
            for key, rel in (("prefill", _rel_l2(mk.float(), mp.float())),
                             ("decode", _rel_l2(dec.float(),
                                                full[:, S:].float()))):
                if rel >= worst[key][0]:
                    worst[key] = (rel, i)
            x = x + full
    for key, (rel, i) in worst.items():
        log(f"[ssmserve] every layer on its own input: worst {key} relative "
            f"L2 {rel:.2e} (layer {i})")
        if not rel < 0.1:
            raise AssertionError(f"layer {i}'s {key} disagrees: {rel}")
    return {k: v[0] for k, v in worst.items()}


def _ssm_end_to_end(model, cfg, toks):
    """Through the entry points at each depth of SSM_DEPTHS (the model's
    first layers): prefill of S - 4 tokens through the kernels against the
    plain versions, and that prefill then 4 decode steps against ``apply``
    on all S; then, at full depth, the plain path in bf16 against the same
    weights in float32 (the model's own sensitivity to rounding)."""
    import torch
    from repro_torch.models import build_model
    S = toks.shape[1] - 4
    layers, out = model.layers, {}
    try:
        for depth in SSM_DEPTHS:
            model.layers = layers[:depth]
            limit = 0.1 if depth <= SSM_E2E_LAYERS else None
            with torch.inference_mode():
                lk, _ = model.prefill(toks[:, :S])
                with _plain_ops():
                    lp, _ = model.prefill(toks[:, :S])
                full = model.apply(toks)
                _, cache = model.prefill(toks[:, :S])
                steps = torch.cat([model.decode_step(cache,
                                                     toks[:, t:t + 1])[0]
                                   for t in range(S, S + 4)], 1)
            pre = _hold_logits(
                "ssmserve", f"{depth} layers: prefill ({toks.shape[0]} x "
                f"{S}), kernels vs plain", lk, lp, cfg, limit)
            dec = _hold_logits(
                "ssmserve", f"{depth} layers: prefill then 4 decode steps vs "
                f"apply on {S + 4}", steps, full[:, S:], cfg, limit)
            out[depth] = {"prefill_rel_l2": pre[0], "prefill_argmax": pre[1],
                          "decode_rel_l2": dec[0], "decode_argmax": dec[1]}
            del lk, lp, full, cache, steps
    finally:
        model.layers = layers
    m32 = build_model(cfg.replace(param_dtype="float32",
                                  activation_dtype="float32"),
                      device="cuda", seed=0)
    m32.load_state_dict(model.state_dict())
    with torch.inference_mode(), _plain_ops():
        lp, _ = model.prefill(toks[:, :S])
        l32, _ = m32.prefill(toks[:, :S])
    out["bf16_vs_float32_plain_rel_l2"] = _hold_logits(
        "ssmserve", f"{len(layers)} layers, plain path: bf16 vs the same "
        "weights in float32", lp, l32, cfg, None)[0]
    del m32, lp, l32
    torch.cuda.empty_cache()
    return out


def phase_ssmserve(ctx):
    """The serving path with full-width Mamba2-2.7B (64 mamba layers, bf16,
    weights from a seeded generator on the card): the SSD scan runs once
    per layer per prefill, the decode steps run the recurrence in plain
    torch on the state the kernel returned."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-2.7b")
    torch.cuda.reset_peak_memory_stats()
    model, init_s, n_params = _build_full(cfg, "ssmserve")
    rng = np.random.default_rng(1)
    # 300 tokens are chunks of 128, 128 and a ragged 44, so the carry
    # between chunks and the final state run (the serving prompts of 16
    # tokens fit in one chunk); 4 more tokens for the decode steps
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 304)),
                           device="cuda")
    layerwise = _ssm_layerwise(model, cfg, toks)
    end_to_end = _ssm_end_to_end(model, cfg, toks)

    engine, batches, counts, prompts, calls = _serve_batches(
        "ssmserve", model, cfg, rng)
    ctx["ssmserve_launches"] = counts
    # one scan per layer per prefill; ln1 and the gated ssm_norm per layer
    # plus the final norm per forward, SERVE_NEW forwards per generate
    want = {"ssd_scan": cfg.num_layers * calls,
            "rmsnorm": (2 * cfg.num_layers + 1) * SERVE_NEW * calls}
    got = {k: counts[k] for k in want}
    log(f"[ssmserve] launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"the Mamba2 path launched {got}, not {want}")
    same, prof = _repeat_and_profile("ssmserve", engine, prompts)
    ctx["ssmserve"] = _serve_record(
        cfg, n_params, init_s, batches, same, prof,
        layerwise_rel_l2=layerwise, end_to_end=end_to_end)
    del model, engine
    torch.cuda.empty_cache()


# DeepSeek-V2-Lite's end-to-end comparisons: the full-width prefill through
# the kernels against the plain versions at each depth (the model's first
# layers), held at relative L2 < 0.1 at full depth and reported at the
# others, with the routing choices that differ layer by layer
MOE_DEPTHS = (4, 9, 14, 27)


class _RouteRecorder:
    """While active, keeps the experts (T, k) of each ``moe.route`` call,
    in call order (one per MoE layer of each forward)."""

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route, self.picks = moe, moe.route, []

        def route(probs, k, cap, *rank):
            r = self._route(probs, k, cap, *rank)
            self.picks.append(r.top_e)
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route
        return False


def _choice_flips(a, b, E):
    """Share of the (token, expert) choices in ``a`` that ``b`` does not
    make; both (T, k) expert indices."""
    import torch
    oa = torch.zeros(a.shape[0], E, device=a.device).scatter_(1, a, 1.0)
    ob = torch.zeros(b.shape[0], E, device=b.device).scatter_(1, b, 1.0)
    return float((oa * (1.0 - ob)).sum() / a.numel())


def _flips(rk, rp, cfg):
    return [_choice_flips(a, b, cfg.num_experts)
            for a, b in zip(rk.picks, rp.picks)]


def _moe_layerwise(model, cfg, toks):
    """Each layer of ``model`` on the kernel path's own input (the residual
    stream of the kernels' forward on ``toks``): its update (mixer and
    MLP) through the kernels against the plain versions, held at relative
    L2 < 0.1, and the share of its routing choices that differ."""
    import torch
    from repro_torch.models.layers import embed_lookup
    positions = model._positions(*toks.shape)
    worst, flips = (0.0, -1), []
    with torch.inference_mode():
        x = embed_lookup(model.embed, toks, cfg)
        for i, blk in enumerate(model.layers):
            with _RouteRecorder() as rk:
                yk, _ = model._block_apply(blk, x, positions)
            with _plain_ops(), _RouteRecorder() as rp:
                yp, _ = model._block_apply(blk, x, positions)
            rel = _rel_l2(yk.float() - x.float(), yp.float() - x.float())
            if rel >= worst[0]:
                worst = (rel, i)
            flips += _flips(rk, rp, cfg)
            x = yk
    log(f"[moeserve] every layer on its own input: worst relative L2 of its "
        f"update {worst[0]:.2e} (layer {worst[1]}); routing choices that "
        f"differ by layer: " + " ".join(f"{f:.3f}" for f in flips))
    if not worst[0] < 0.1:
        raise AssertionError(f"layer {worst[1]} disagrees: {worst[0]}")
    return {"worst_rel_l2": worst[0], "worst_layer": worst[1],
            "route_flips": flips}


def _moe_end_to_end(model, cfg, toks):
    """Through ``prefill`` at each depth of MOE_DEPTHS: the kernels against
    the plain versions, held at full depth, with the routing choices that
    differ layer by layer."""
    import torch
    layers, out = model.layers, {}
    try:
        for depth in MOE_DEPTHS:
            model.layers = layers[:depth]
            limit = 0.1 if depth == len(layers) else None
            with torch.inference_mode():
                with _RouteRecorder() as rk:
                    lk, _ = model.prefill(toks, cache_len=24)
                with _plain_ops(), _RouteRecorder() as rp:
                    lp, _ = model.prefill(toks, cache_len=24)
            rel, agree = _hold_logits(
                "moeserve", f"{depth} layers: full-width prefill "
                f"({toks.shape[0]} x {toks.shape[1]}), kernels vs plain on "
                f"the card", lk, lp, cfg, limit)
            flips = _flips(rk, rp, cfg)
            log(f"[moeserve] {depth} layers: routing choices that differ by "
                f"layer: " + " ".join(f"{f:.3f}" for f in flips))
            out[depth] = {"rel_l2": rel, "argmax": agree,
                          "route_flips": flips}
            del lk, lp
    finally:
        model.layers = layers
    return out


def _moe_share(engine, prompts):
    """One group's generate under torch.profiler with each MoE block in a
    ``record_function`` range: the device time of the kernels the blocks
    launched against the generate's, and the bf16 attention kernel
    instances (their names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe
    apply = moe.moe_apply

    def ranged(p, x, cfg, ctx=None, **kw):
        with record_function("moe_block"):
            return apply(p, x, cfg, ctx, **kw)
    moe.moe_apply = ranged
    try:
        engine.generate(prompts, SERVE_NEW)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.generate(prompts, SERVE_NEW)
            torch.cuda.synchronize()
    finally:
        moe.moe_apply = apply
    dev_ms, moe_ms, names = 0.0, 0.0, set()
    for e in prof.key_averages():
        if e.key == "moe_block":
            if e.device_type != DeviceType.CUDA:
                moe_ms += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA and e.self_device_time_total:
            dev_ms += e.self_device_time_total / 1e3
            names.add(e.key)
    wgmma = sorted(n for n in names if "fa_wgmma" in n)
    share = moe_ms / dev_ms if dev_ms > 0 else None
    log(f"[moeserve] one group's generate ({len(prompts)} prompts): device "
        f"{dev_ms:.2f} ms, the MoE blocks' kernels {moe_ms:.2f} ms"
        + (f" (share {share:.3f})" if share is not None else
           " (the profiler saw no device time: share not measured)"))
    log(f"[moeserve] attention kernel instances: {wgmma}")
    return {"device_ms": dev_ms or None, "moe_ms": moe_ms or None,
            "moe_share": share, "attention_instances": wgmma}


def phase_moeserve(ctx):
    """The serving path with DeepSeek-V2-Lite-16B at full size (27 layers:
    a dense first layer, then MLA with 64 routed and 2 shared experts,
    top-6; bf16, weights from a seeded generator on the card) behind the
    batcher: the MLA prefill runs the bf16 attention kernel's (192, 128)
    instance, the absorbed decode plain matmuls, the MoE plain gathers and
    batched matmuls."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b")
    gc.collect()     # the earlier serving phases' models, if still held
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s, n_params = _build_full(cfg, "moeserve")
    rng = np.random.default_rng(2)
    small = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)),
                            device="cuda")
    layerwise = _moe_layerwise(model, cfg, small)
    end_to_end = _moe_end_to_end(model, cfg, small)

    engine, batches, counts, prompts, calls = _serve_batches(
        "moeserve", model, cfg, rng)
    ctx["moeserve_launches"] = counts
    # per forward: ln1, the latent's kv_norm and ln2 in every layer, and
    # the final norm; one attention a layer per prefill; the absorbed
    # decode launches no flash_decode
    want = {"rmsnorm": (3 * cfg.num_layers + 1) * SERVE_NEW * calls,
            "flash_attention": cfg.num_layers * calls, "flash_decode": 0}
    got = {k: counts[k] for k in want}
    log(f"[moeserve] launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"the DeepSeek path launched {got}, not {want}")
    same, prof = _repeat_and_profile("moeserve", engine, prompts)
    share = _moe_share(engine, prompts[:SERVE_REQUESTS // 2])
    if not any("192" in n and "128" in n
               for n in share["attention_instances"]):
        raise AssertionError(f"no (192, 128) attention instance ran: "
                             f"{share['attention_instances']}")
    ctx["moeserve"] = _serve_record(
        cfg, n_params, init_s, batches, same, prof, layerwise=layerwise,
        end_to_end=end_to_end, moe_share=share)
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()


# zoo: (arch, depth; None keeps the config's); each model runs a prefill of
# ZOO_BATCH prompts of ZOO_PROMPT tokens (after Whisper's 1500 frames or
# InternVL2's 256 patches, bf16) and ZOO_STEPS teacher-forced decode steps
ZOO = (("whisper-large-v3", None), ("qwen3-moe-235b-a22b", 8),
       ("internvl2-76b", 8))
ZOO_BATCH, ZOO_PROMPT, ZOO_STEPS = 2, 16, 7


def _zoo_launches(cfg, steps):
    """Model kernel launches of one prefill and ``steps`` decode steps,
    counted from the code: every norm, attention and cached attention."""
    if cfg.is_encoder_decoder:
        enc, dec = cfg.num_encoder_layers, cfg.num_layers
        return {"rmsnorm": 2 * enc + 1 + (3 * dec + 1) * (1 + steps),
                "flash_attention": enc + 2 * dec,
                "flash_decode": 2 * dec * steps}
    if any(s != cfg.pattern[0] or s.mixer != "attn" for s in cfg.pattern):
        raise ValueError(f"{cfg.name}: the zoo counts attention stacks")
    norms = 1 + cfg.num_layers * (2 + (2 if cfg.qk_norm else 0))
    return {"rmsnorm": norms * (1 + steps),
            "flash_attention": cfg.num_layers,
            "flash_decode": cfg.num_layers * steps}


def phase_zoo(ctx):
    """Whisper-large-v3 at full size, Qwen3-MoE-235B-A22B and InternVL2-76B
    at full width cut to 8 layers: each one's prefill and decode steps
    through the kernels against the plain versions on the card."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    out, total = {}, {k: 0 for k in LM_KERNELS}
    for arch, depth in ZOO:
        cfg = get_config(arch)
        if depth:
            cfg = cfg.replace(num_layers=depth)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, init_s, n_params = _build_full(cfg, "zoo")
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (ZOO_BATCH, ZOO_PROMPT + ZOO_STEPS)),
            device="cuda")
        extra = ()
        if cfg.encoder_seq or cfg.num_patches:
            extra = (_wrapper_extra(cfg, ZOO_BATCH, "cuda", torch.bfloat16,
                                    seed=3),)
        cache_len = cfg.num_patches + ZOO_PROMPT + ZOO_STEPS

        def generate():
            lpre, cache = model.prefill(toks[:, :ZOO_PROMPT], *extra,
                                        cache_len=cache_len)
            ldec = torch.cat([model.decode_step(cache, toks[:, t:t + 1])[0]
                              for t in range(ZOO_PROMPT, toks.shape[1])], 1)
            return lpre, ldec

        torch.cuda.synchronize()
        _reset_all()
        t0 = time.perf_counter()
        with torch.inference_mode(), _RouteRecorder() as rk:
            pk, dk = generate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _lm_launches()
        with torch.inference_mode(), _plain_ops(), _RouteRecorder() as rp:
            pp, dp = generate()
        want = _zoo_launches(cfg, ZOO_STEPS)
        got = {k: counts[k] for k in want}
        log(f"[zoo] {cfg.name}: launches {counts}, expected {want}; the "
            f"kernels' prefill and {ZOO_STEPS} decode steps {wall:.3f} s")
        if got != want:
            raise AssertionError(f"{cfg.name} launched {got}, not {want}")
        rel, agree = _hold_logits(
            "zoo", f"{cfg.name} ({cfg.num_layers} layers) prefill "
            f"({ZOO_BATCH} x {ZOO_PROMPT}"
            + (f" after {extra[0].shape[1]} embeddings" if extra else "")
            + "), kernels vs plain on the card", pk, pp, cfg)
        drel, dagree = _hold_logits(
            "zoo", f"{cfg.name} {ZOO_STEPS} decode steps (cache "
            f"{cache_len}), kernels vs plain on the card", dk, dp, cfg)
        flips = _flips(rk, rp, cfg) if cfg.num_experts else []
        if flips:
            log(f"[zoo] {cfg.name}: routing choices that differ by call "
                f"(layers of the prefill, then of each step): "
                + " ".join(f"{f:.3f}" for f in flips))
        for k in total:
            total[k] += counts[k]
        out[cfg.name] = {
            "layers": cfg.num_layers, "params": n_params, "init_s": init_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": got, "kernel_path_s": wall, "prefill_rel_l2": rel,
            "prefill_argmax": agree, "decode_rel_l2": drel,
            "decode_argmax": dagree, "route_flips": flips}
        del model, pk, dk, pp, dp, extra
        gc.collect()
        torch.cuda.empty_cache()
    ctx["zoo_launches"] = total
    ctx["zoo"] = out


def _profile_generate(tag, engine, prompts):
    """One group's generate (prefill + decode steps) on the host clock and
    under torch.profiler: device time by kernel and the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, SERVE_NEW)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    per_kernel = {k: sum(ms for n, ms in by_name.items()
                         if any(sym in n for sym in syms))
                  for k, syms in LM_SYMBOLS.items()}
    busy = dev_ms / wall_ms if dev_ms > 0 else None
    log(f"[{tag}] one group's generate ({len(prompts)} prompts, {SERVE_NEW} "
        f"tokens): wall {wall_ms:.2f} ms, device "
        + (f"{dev_ms:.2f} ms, busy share {busy:.3f}" if busy is not None
           else "time not measured (the profiler saw no device time)"))
    for n, ms in top:
        log(f"[{tag}]   {ms:8.3f} ms  {n[:90]}")
    log(f"[{tag}] model kernels' device time: "
        + ", ".join(f"{k} {ms:.3f} ms" for k, ms in per_kernel.items()))
    return {"wall_ms": wall_ms, "device_ms": dev_ms if dev_ms > 0 else None,
            "busy_share": busy, "kernel_ms": per_kernel,
            "top": [{"name": n, "ms": ms} for n, ms in top]}


def _roof(nbytes, t_ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and ``t_ops``, the operations over their peak rate (seconds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def _fits(nbytes):
    import torch
    free, _ = torch.cuda.mem_get_info()
    return nbytes < 0.8 * free


def phase_lmtick(ctx):
    """Each model kernel's time at the serving path's shapes and at the
    repository's serving shapes cut to one layer, beside its bound, its
    plain version and the yardstick library call (timed here only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    rows, fails = [], []

    def tick(kernel, shape, run, plain, library, bound, plain_bytes,
             reps=7, plain_reps=5, check=False, device_time=False,
             per_pair=1):
        """``library`` None: no PyTorch call computes the function.
        ``check``: hold the kernel's output against the plain version's at
        LM_TOL first. ``device_time``: also the device time per call under
        torch.profiler, without the launch path, and the host time per
        call, the launch path alone, for kernel and library. ``per_pair``:
        calls between the events of each pair, for kernel and library."""
        err = _agree(kernel, shape, run, plain, fails) if check else None
        if library is not None:
            # in turns (kernel, library, library, kernel), each the mean of
            # its two medians, so a drift of the card's or host's state
            # between the two weighs on both
            t = [_time_cuda(f, reps=reps, per_pair=per_pair)
                 for f in (run, library, library, run)]
            ms, lib_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        else:
            ms = _time_cuda(run, reps=reps, per_pair=per_pair)
            lib_ms = None
        plain_ms = (_time_cuda(plain, reps=plain_reps, warm=1)
                    if _fits(plain_bytes) else None)
        dev_ms = _device_ms(run) if device_time else None
        lib_dev_ms = (_device_ms(library) if device_time and library
                      is not None else None)
        host_ms = _host_ms(run) if device_time else None
        lib_host_ms = (_host_ms(library) if device_time and library
                       is not None else None)
        bound_ms, by = bound
        rows.append({"kernel": kernel, "shape": shape, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": by,
                     "max_abs_err": err, "device_ms": dev_ms,
                     "library_device_ms": lib_dev_ms, "host_ms": host_ms,
                     "library_host_ms": lib_host_ms})
        log(f"[lmtick] {kernel:15s} {shape:46s} kernel {ms:9.4f} ms  plain "
            + (f"{plain_ms:9.4f}" if plain_ms is not None else "  no room")
            + " ms  library "
            + (f"{lib_ms:9.4f} ms" if lib_ms is not None else "none")
            + f"  bound {bound_ms:.4f} ms ({by})"
            f"  kernel/bound {ms / bound_ms:.1f}x"
            + (f"  kernel/library {ms / lib_ms:.2f}x" if lib_ms else ""))
        if dev_ms is not None:
            log(f"[lmtick] {kernel:15s} {shape:46s} device time per call: "
                f"kernel {dev_ms:.4f} ms"
                + (f", library {lib_dev_ms:.4f} ms, kernel/library "
                   f"{dev_ms / lib_dev_ms:.2f}x" if lib_dev_ms else "")
                + f"; host time per call: kernel {host_ms:.4f} ms"
                + (f", library {lib_host_ms:.4f} ms" if lib_host_ms
                   is not None else ""))
        torch.cuda.empty_cache()

    # flash_attention: the path (one group's prefill), a middle shape, then
    # prefill_32k's S = 32768 with B cut from 32 to 1
    for tag, B, S in (("path", 32, 16), ("middle", 8, 4096),
                      ("serving prefill_32k B=1", 1, 32768)):
        Hq, Hkv, D = 32, 8, 128
        q, k, v = _attn_inputs(("", B, Hq, Hkv, S, S, D, True, None), bf, 90)
        flops, nbytes = RL.attention_work(B, Hq, Hkv, S, S, D, D, True,
                                          None, 2)
        tick("flash_attention", f"{tag} (B={B}, Hq={Hq}, Hkv={Hkv}, S={S})",
             lambda: ops.attention(q, k, v, causal=True),
             lambda: ref.flash_attention_ref(q, k, v, causal=True),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True),
             _roof(nbytes, flops / BF16_OPS_PER_S),
             plain_bytes=4 * 3 * B * Hq * S * S, check=tag == "middle",
             device_time=tag == "path")
        del q, k, v
    # flash_decode: the path's last step (cache of 24, all valid), a middle
    # shape, then decode_32k's S = 32768 with B cut from 128 to 32
    for tag, B, S in (("path", 32, 24), ("middle", 32, 2048),
                      ("serving decode_32k B=32", 32, 32768)):
        Hkv, G, D = 8, 4, 128
        q, k, v, valid = _decode_inputs(("", B, Hkv, G, S, D, S), bf, 91)
        flops, nbytes = RL.decode_work(B, Hkv, G, S, D, 2)
        tick("flash_decode", f"{tag} (B={B}, Hkv={Hkv}, G={G}, S={S})",
             lambda: ops.decode_attention(q, k, v, valid),
             lambda: ref.decode_attention_ref(q, k, v, valid),
             lambda: F.scaled_dot_product_attention(
                 q.reshape(B, Hkv * G, 1, D), k, v,
                 attn_mask=valid[None, None, None, :], enable_gqa=True),
             _roof(nbytes, flops / BF16_OPS_PER_S),
             plain_bytes=4 * 2 * B * Hkv * S * D, check=tag != "path",
             device_time=tag == "path")
        del q, k, v
    # the zoo's attention shapes: DeepSeek-V2-Lite's MLA prefill at one
    # group's serving shape (q and k of 192, v of 128: the (192, 128)
    # instance; its scale passed), Whisper-large-v3's bidirectional encoder
    # over 1500 frames and its decoder's cross-attention of 16 tokens over
    # them, and InternVL2-76B's prefill of 256 patches and 16 tokens, at
    # the zoo's B; SDPA where it takes the shape
    for tag, B, Hq, Hkv, Sq, Sk, D, Dv, causal in (
            ("moe path deepseek-v2-lite mla", 32, 16, 16, 16, 16, 192, 128,
             True),
            ("zoo whisper-large-v3 encoder", 2, 20, 20, 1500, 1500, 64, 64,
             False),
            ("zoo whisper-large-v3 cross", 2, 20, 20, 16, 1500, 64, 64,
             False),
            ("zoo internvl2-76b prefill", 2, 64, 8, 272, 272, 128, 128,
             True)):
        g = _gen(95)
        q = _randn(g, (B, Hq, Sq, D), bf)
        k = _randn(g, (B, Hkv, Sk, D), bf)
        v = _randn(g, (B, Hkv, Sk, Dv), bf)
        scale = D ** -0.5
        flops, nbytes = RL.attention_work(B, Hq, Hkv, Sq, Sk, D, Dv, causal,
                                          None, 2)
        tick("flash_attention", f"{tag} (B={B}, Hq={Hq}, Hkv={Hkv}, "
             f"Sq={Sq}, Sk={Sk}, D={D}, Dv={Dv})",
             lambda: ops.attention(q, k, v, causal=causal, sm_scale=scale),
             lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                             sm_scale=scale),
             _sdpa(q, k, v, causal, scale), _roof(nbytes,
                                                   flops / BF16_OPS_PER_S),
             plain_bytes=4 * 3 * B * Hq * Sq * Sk, check=True,
             device_time=True)
        del q, k, v
    # the float32 kernel (split TF32 on the tensor cores) at SmolLM-360M's
    # training shape, the tiny Jamba's (its float32 config: 4 query and 2
    # kv heads of 16, B 2 x S 64) and the 192 tile with a window and a
    # ragged S, beside SDPA's float32 forward, GQA as the model calls it
    # and with k and v expanded to the query heads (which the memory-
    # efficient backend takes), each with the backend that served it; the
    # bound takes the operations at F32_SPLIT_OPS_PER_S, its figures at a
    # third of the TF32 rate and on the CUDA cores logged beside it
    for tag, B, Hq, Hkv, S, D, window in (
            ("float32 smollm-360m train", 8, 15, 5, 2048, 64, None),
            ("float32 tiny jamba", 2, 4, 2, 64, 16, None),
            ("float32 d192 window 256 ragged", 2, 8, 2, 1000, 192, 256)):
        q, k, v = _attn_inputs(("", B, Hq, Hkv, S, S, D, True, window),
                               torch.float32, 97)
        flops, nbytes = RL.attention_work(B, Hq, Hkv, S, S, D, D, True,
                                          window, 4)
        mask = (None if window is None
                else ref.attention_mask(S, S, True, window, q.device))

        def sdpa(q=q, k=k, v=v, mask=mask):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=q.shape[1] != k.shape[1])
        tick("flash_attention", f"{tag} (B={B}, Hq={Hq}, Hkv={Hkv}, S={S}, "
             f"D={D}" + (f", window={window}" if window else "") + ")",
             lambda: ops.attention(q, k, v, causal=True, window=window),
             lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                             window=window),
             sdpa, _roof(nbytes, flops / F32_SPLIT_OPS_PER_S),
             plain_bytes=4 * 3 * B * Hq * S * S, check=True,
             device_time=True)
        row = rows[-1]
        row["bound_tf32_ms"] = _roof(nbytes, flops / TF32_OPS_PER_S * 3)[0]
        row["bound_cuda_core_ms"] = _roof(nbytes, flops / FP32_OPS_PER_S)[0]
        kx, vx = (t.repeat_interleave(Hq // Hkv, 1) for t in (k, v))

        def sdpa_mha(q=q, k=kx, v=vx, mask=mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  is_causal=mask is None)
        row["library_backend"] = _sdpa_backend(sdpa)
        row["library_mha_ms"] = _time_cuda(sdpa_mha, reps=7)
        row["library_mha_device_ms"] = _device_ms(sdpa_mha)
        row["library_mha_backend"] = _sdpa_backend(sdpa_mha)
        dev, lib, mha = (row["device_ms"], row["library_device_ms"],
                         row["library_mha_device_ms"])
        log(f"[lmtick] flash_attention   {tag}: bound "
            f"{row['bound_ms']:.4f} ms at {F32_SPLIT_OPS_PER_S / 1e12:.0f} "
            f"TFLOP/s (split bf16), {row['bound_tf32_ms']:.4f} at "
            f"{TF32_OPS_PER_S / 3e12:.0f} (split TF32), "
            f"{row['bound_cuda_core_ms']:.4f} on the CUDA cores at "
            f"{FP32_OPS_PER_S / 1e12:.0f}; SDPA GQA device "
            + (f"{lib:.4f}" if lib else "not measured")
            + f" ms ({row['library_backend']}), SDPA with k, v expanded "
            f"{row['library_mha_ms']:.4f} ms, device "
            + (f"{mha:.4f}" if mha else "not measured")
            + f" ({row['library_mha_backend']})"
            + (f"; kernel/SDPA device {dev / lib:.2f}x GQA" if dev and lib
               else "")
            + (f", {dev / mha:.2f}x expanded" if dev and mha else ""))
        del q, k, v, kx, vx, mask
    # the zoo's cached attention: Whisper's cross decode over 1500 frames
    # and self decode (G = 1, D = 64), Qwen3-MoE's G = 16 and InternVL2's
    # G = 8 (D = 128), each at its decode's cache length
    for tag, B, Hkv, G, S, D in (
            ("zoo whisper-large-v3 cross decode", 2, 20, 1, 1500, 64),
            ("zoo whisper-large-v3 self decode", 2, 20, 1, 23, 64),
            ("zoo qwen3-moe decode", 2, 4, 16, 23, 128),
            ("zoo internvl2-76b decode", 2, 8, 8, 279, 128)):
        q, k, v, valid = _decode_inputs(("", B, Hkv, G, S, D, S), bf, 96)
        flops, nbytes = RL.decode_work(B, Hkv, G, S, D, 2)
        tick("flash_decode", f"{tag} (B={B}, Hkv={Hkv}, G={G}, S={S}, "
             f"D={D})",
             lambda: ops.decode_attention(q, k, v, valid),
             lambda: ref.decode_attention_ref(q, k, v, valid),
             lambda: F.scaled_dot_product_attention(
                 q.reshape(B, Hkv * G, 1, D), k, v,
                 attn_mask=valid[None, None, None, :], enable_gqa=True),
             _roof(nbytes, flops / BF16_OPS_PER_S),
             plain_bytes=4 * 2 * B * Hkv * S * D, check=True,
             device_time=True)
        del q, k, v
    # decode_32k's shape once more with a ragged mask whose first split (of
    # three) has no valid slot, held against the plain version
    case = ("", 32, 8, 4, 32768, 128, 20000, 10923)
    q, k, v, valid = _decode_inputs(case, bf, 94)
    _agree("flash_decode", "decode_32k B=32, first split invalid",
           lambda: ops.decode_attention(q, k, v, valid),
           lambda: ref.decode_attention_ref(q, k, v, valid), fails)
    del q, k, v, valid
    torch.cuda.empty_cache()
    # rmsnorm: every norm shape of the two serving paths, then 32768 rows
    # of 4096, each with device and host time per call beside F.rms_norm's.
    # At the path's shapes an event pair around one call reads the host's
    # launch path (a few microseconds of device work): 21 pairs each. At
    # 32768 x 4096 (~0.2 ms) one call's launch path would add ~10% to it:
    # each pair there brackets 10 calls.
    for tag, R, D in NORM_TICKS:
        x, w = _norm_inputs(R, D, bf, 92)
        tick("rmsnorm", f"{tag} ({R}, {D})",
             lambda: ops.rmsnorm(x, w, eps=1e-6),
             lambda: ref.rmsnorm_ref(x, w, eps=1e-6),
             lambda: F.rms_norm(x, (D,), w, 1e-6),
             _roof(RL.rmsnorm_work(R, D, 2)[1],
                   RL.rmsnorm_work(R, D, 2)[0] / FP32_OPS_PER_S),
             plain_bytes=4 * 3 * R * D, check=True, device_time=True,
             reps=21 if tag.startswith("path") else 7,
             per_pair=1 if tag.startswith("path") else 10)
    # ssd_scan at Mamba2-2.7B's H, P, G, N and chunk: the path (one group's
    # prefill, 32 prompts of 16 tokens: one chunk of 16), prefill_32k's
    # S = 32768 with B cut from 32 to 8, and long_500k's S = 524288 at its
    # own B = 1, each in the group split of autotune.ssd_groups (one group:
    # one launch of B H blocks; more: pass 1, pass 2 where there are more
    # than two groups, and pass 3). No PyTorch call computes the scan.
    from repro_torch.kernels import ssd_scan as ssd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tag, B, S in (("path", 32, 16), ("serving prefill_32k B=8", 8, 32768),
                      ("serving long_500k B=1", 1, 524288)):
        H, P, G, N, chunk = 80, 64, 1, 128, 128
        args = _ssd_inputs(("", B, S, H, P, G, N, chunk), bf, 93)
        long_s = S > 100000
        split = ssd.kernel_split(B, H, S, chunk, bf)
        blocks = _ssd_blocks(B, H, P, N, split.groups)
        log(f"[lmtick] ssd_scan {tag}: {split.groups} group(s) of "
            f"{split.per_group} of {split.chunks} chunks; {len(blocks)} "
            f"launch(es) per call of {blocks} blocks on {sms} SMs")
        tick("ssd_scan", f"{tag} (B={B}, H={H}, S={S})",
             lambda: ops.ssd(*args, chunk=chunk, return_final_state=True),
             lambda: ref.ssd_chunked_ref(*args, chunk=chunk,
                                         return_final_state=True),
             None, _roof(*_ssd_work(B, S, H, P, G, N, chunk)),
             plain_bytes=3 * 2 * B * S * H * P,
             reps=3 if long_s else 7, plain_reps=2 if long_s else 5,
             device_time=True)
        rows[-1].update(groups=split.groups, per_group=split.per_group,
                        blocks=blocks, launches_per_call=len(blocks))
        del args
    ctx["lmtick"] = rows
    worst = ctx.setdefault("lm_max_abs_err", {})
    for r in rows:
        if r["max_abs_err"] is not None:
            worst[r["kernel"]] = max(worst.get(r["kernel"], 0.0),
                                     r["max_abs_err"])
    if fails:
        raise AssertionError(f"kernel/plain disagreement at lmtick shapes: "
                             f"{fails}")


def _sdpa(q, k, v, causal, scale):
    """One SDPA call computing ``ops.attention(q, k, v, causal=causal,
    sm_scale=scale)`` as a function, or None (logged) where SDPA refuses
    the shape."""
    import torch.nn.functional as F

    def call():
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale,
            enable_gqa=q.shape[1] != k.shape[1])
    try:
        call()
    except RuntimeError as e:
        log(f"[lmtick] SDPA refuses q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}: {str(e).splitlines()[0][:160]}")
        return None
    return call


def _f32_attn_rel(kernel, got, want):
    """A float32 attention output's relative L2 error, held at LM_TOL
    beside the elementwise tolerance: at long rows the outputs are small
    (an average over ~1000 keys) and an absolute 2e-4 alone would pass one
    TF32 product, whose error is near 2^-11 of them; None for any other
    kernel or dtype."""
    import torch
    if kernel != "flash_attention" or got.dtype != torch.float32:
        return None
    return _rel_l2(got.float(), want.float())


def _agree(kernel, tag, run, plain, fails):
    """Max |err| of ``run``'s output against ``plain``'s, held at LM_TOL of
    the output's dtype; the output must be finite. A failure is logged and
    appended to ``fails``."""
    import torch
    got, want = run(), plain()
    torch.cuda.synchronize()
    tol = LM_TOL[str(got.dtype).split(".")[-1]]
    err = float((got.float() - want.float()).abs().max())
    ok = (bool(torch.isfinite(got).all())
          and bool(torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol)))
    rel = _f32_attn_rel(kernel, got, want)
    ok &= rel is None or rel < tol
    log(f"[lmtick] {kernel:15s} {tag:46s} against plain: max|err| "
        f"{err:.2e}" + (f" rel L2 {rel:.2e}" if rel is not None else "")
        + f" (tol {tol:g}) " + ("ok" if ok else "FAIL"))
    if not ok:
        fails.append(f"{kernel} {tag}")
    del got, want
    torch.cuda.empty_cache()
    return err


def _host_ms(fn, reps=200):
    """Host milliseconds per call of ``fn`` with the device idle at the
    start and no synchronization between calls: the launch path, where the
    device's work per call is shorter than it."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / reps


# the CUDA API calls each of whose device activities (a kernel, a copy, a
# fill) the profiler records: a profiled window is complete when it saw as
# many device activities as these calls
DEVICE_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
# empty kernels launched, and waited for, at the start of every profiled
# window, before the measured calls: once a run has profiled a while, a
# window loses the device records of its first launches, and these take
# the loss
DEVICE_FILL = 256
# windows a measurement may take: a rare one loses every record
DEVICE_WINDOWS = 3


def _device_diag(prof):
    """What an incomplete window held: the device records in kineto's raw
    result, and where they start against the measured launch calls (ms,
    the first and the last)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    dev = sorted(e.start_ns() for e in events
                 if e.device_type() == DeviceType.CUDA
                 and "spin_kernel" not in e.name())
    api = sorted(e.start_ns() for e in events if e.name() in DEVICE_APIS)
    out = {"raw_device": len(dev), "launch_calls": len(api) - DEVICE_FILL}
    if dev and len(api) > DEVICE_FILL:
        out["first_lag_ms"] = (dev[0] - api[DEVICE_FILL]) / 1e6
        out["last_lag_ms"] = (dev[-1] - api[-1]) / 1e6
    return out


def _profiled(fn, reps):
    """torch.profiler over ``DEVICE_FILL`` empty kernels, waited for, then
    ``reps`` calls of ``fn``, synchronized (see ``_device_window``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DEVICE_FILL):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def _device_window(fn, reps=20, expect=None):
    """Device microseconds by kernel name of ``reps`` calls of ``fn`` under
    torch.profiler, from a complete window; the host's launch path is not
    in it. The window counts only when it holds a device activity for every
    launch call the profiler saw on the host (and, with ``expect`` = (name
    part, launches a call), that kernel's launches exactly). Once a run has profiled a
    while, a window loses the device records of its first launches
    (kineto's raw result holds fewer than the launch calls, the last one
    always present: in a whole run 1 to 27 a window from the serving phases
    on, and all of some short windows), so ``DEVICE_FILL`` empty kernels
    (``torch.cuda._sleep(0)``, not counted) are launched and waited for at
    the window's start. A window that is short all the same (a rare one
    holds no record at all) is logged with what kineto held and taken again,
    up to ``DEVICE_WINDOWS`` windows; None when none was complete."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for window in range(1, DEVICE_WINDOWS + 1):
        prof = _profiled(fn, reps)
        ka = prof.key_averages()
        dev = [e for e in ka if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and "spin_kernel" not in e.key]
        total = sum(e.self_device_time_total for e in dev)
        seen = sum(e.count for e in dev)
        calls = (sum(e.count for e in ka if e.key in DEVICE_APIS)
                 - DEVICE_FILL)
        ok = total > 0 and seen >= calls
        if expect is not None:
            part, per_call = expect
            ok = ok and sum(e.count for e in dev
                            if part in e.key) == per_call * reps
        if ok:
            by_name = {}
            for e in dev:
                by_name[e.key] = (by_name.get(e.key, 0.0)
                                  + e.self_device_time_total)
            return by_name
        log(f"[device] incomplete window {window} of {DEVICE_WINDOWS}: "
            f"{seen} device activities for {calls} launch calls; "
            f"{_device_diag(prof)}")
    return None


def _kernel_name(name):
    """A kernel's name from the profiler's signature: the function name
    and its template arguments, without the namespace and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0]


def _sdpa_backend(fn):
    """The SDPA backend that served ``fn``, from the names of the kernels
    it launched (``_device_window``): "efficient" (the memory-efficient
    CUTLASS kernel), "flash", "cudnn" or "math" (matrix products and a
    softmax), with its longest kernel's name; None when no window was
    complete."""
    by_name = _device_window(fn, reps=2)
    if not by_name:
        return None
    names = " ".join(by_name).lower()
    kind = ("efficient" if "fmha" in names or "efficient" in names
            else "flash" if "flash" in names
            else "cudnn" if "cudnn" in names else "math")
    return f"{kind}: {_kernel_name(max(by_name, key=by_name.get))[:72]}"


def _device_ms(fn, reps=20, expect=None):
    """Device milliseconds per call of ``fn``: the sum of the device time
    of every kernel it launches over ``reps`` calls (``_device_window``),
    divided by ``reps``; None when no window was complete."""
    by_name = _device_window(fn, reps, expect)
    return None if by_name is None else sum(by_name.values()) / 1e3 / reps


def _device_busy_ms(fn, reps=5, expect=None):
    """Device milliseconds per call of ``fn`` during which one of its
    kernels ran: the union of their intervals over ``reps`` calls under
    torch.profiler, divided by ``reps``. Less than ``_device_ms``'s sum
    where a call's kernels overlap (the float32 attention backward's dQ
    pass, a programmatic dependent launch beside the dK/dV pass). A window
    counts when it holds ``expect`` = (name part, launches a call) such
    launches exactly, as in ``_device_window``; None when none did."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_WINDOWS):
        prof = _profiled(fn, reps)
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and "spin_kernel" not in e.name() and e.duration_ns() > 0]
        if expect is not None and sum(
                expect[0] in e.name() for e in events) != expect[1] * reps:
            continue
        busy, end = 0, None
        for start, stop in sorted((e.start_ns(),
                                   e.start_ns() + e.duration_ns())
                                  for e in events):
            if end is None or start > end:
                busy, end = busy + stop - start, stop
            elif stop > end:
                busy, end = busy + stop - end, stop
        if busy > 0:
            return busy / 1e6 / reps
    return None


def _ssd_blocks(B, H, P, N, groups):
    """Blocks of each launch of one SSD scan call (csrc/ssd_scan.cu): pass 1
    (one per (b, h) and group but the last) and pass 2 (one thread per
    state element, 256 a block) where there are more groups than one and
    two, and pass 3 (one per (b, h) and group)."""
    out = []
    if groups > 1:
        out.append(B * H * (groups - 1))
    if groups > 2:
        out.append(-(-B * H * P * N // 256))
    return out + [B * H * groups]


def _ssd_work(B, S, H, P, G, N, chunk):
    """(bytes, seconds of operations) of one bf16 SSD scan with its final
    state (``launch.roofline.ssd_work``) at the bf16 tensor-core rate."""
    flops, nbytes = RL.ssd_work(B, S, H, P, G, N, chunk, 2)
    return nbytes, flops / BF16_OPS_PER_S


# ------------------------------------------------------------- workflow DAG
# the dag phase's timed warm solves per method (the repository's
# benchmarks/dag_scale.py takes 5)
DAG_REPEATS = 3
# the stage slowed 3x at WF_SLOW_AT in the wfloop phase, and its ticks
WF_TICKS, WF_SLOW_AT, WF_SLOW_STAGE = 30, 15, "b0_1"
# the wfloop balancers: the plain cadence, adaptive refresh with risk, and
# the same with dirty_tol=1.0. A stage's drift is the largest relative move
# of its 256 channels' posterior estimates; in the first 30 ticks that is
# 0.26-6.2 at every stage, so at the default dirty_tol=0.05 every refresh
# dirties all 32 stages (a full solve), and only the loose tolerance lets
# the incremental path run
WF_CONFIGS = (("refresh_every=5", {}),
              ("adaptive+risk", {"adaptive_refresh": True, "risk_lam": 0.5}),
              ("adaptive+risk dirty_tol=1", {"adaptive_refresh": True,
                                             "risk_lam": 0.5,
                                             "dirty_tol": 1.0}))
# the composed objective and the shared evaluator, card against the plain
# path on the CPU (tests/test_torch_workflow.py)
DAG_TOL_MU, DAG_TOL_VAR = 1e-4, 1e-3


class _OpCount:
    """Counts the aten operations dispatched inside a ``with`` block
    (forward and autograd's backward alike)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _dag_rungs(res):
    """(phase, mode, R starts, num_t) of each rung of one joint solve, from
    its profile: presolve, triage, refine, final score, and the
    fragility's pgrad (as adaptive refresh and risk run it)."""
    p = res["profile"]
    surv, pool = p["survivors"], p["pool"]
    return (("presolve", "grad", p["starts"], p["presolve_num_t"]),
            ("triage", "fwd", 2 * p["starts"], p["presolve_num_t"]),
            ("refine", "grad", surv, res["num_t"]),
            ("final", "fwd", pool, p["eval_num_t"]),
            ("fragility", "pgrad", pool, res["num_t"]))


def _dag_rung_check(tag, dag, phase, mode, R, T, fails):
    """One rung's stacked launch on the card against its plain version
    (weights: seeded simplex rows on every stage, tiled like the solver's
    stack), twice (the bits repeat), with its time, bound and blocks."""
    import numpy as np
    import torch
    from repro_torch.kernels import frontier_grid as fg, ops
    from repro_torch.workflow import solve as wsolve
    dev = torch.device("cuda")
    groups, mask, kmax = wsolve._stage_groups(dag)
    stacks = wsolve._Stacks(groups, dev)
    rng = np.random.default_rng(R * T)
    e = rng.exponential(size=(R, len(dag.stages), kmax)) * mask
    W = torch.tensor((e / e.sum(-1, keepdims=True)).astype(np.float32),
                     device=dev)
    fam = groups[0].dist_id
    rows = stacks.rows(W, 0).contiguous()
    mus, sgs, ex = stacks.tiled(0, R)
    F = rows.shape[0]
    if mode == "fwd":
        def kern():
            return fg.frontier_grid(rows, mus, sgs, ex, num_t=T, dist_id=fam)
    else:
        def kern(pg=(mode == "pgrad")):
            return fg.frontier_grid_with_grads(rows, mus, sgs, ex, num_t=T,
                                               dist_id=fam, param_grads=pg)

    def plain():
        return ops.plain_moments(rows, mus, sgs, ex, num_t=T, dist_id=fam,
                                 mode=mode)

    got, again = kern(), kern()
    want = plain()
    torch.cuda.synchronize()
    errs, rel, ok = _compare(got, want)
    ok &= all(torch.equal(a, b) for a, b in zip(got, again))
    label = f"{tag} {phase:9s} {mode:5s} F={F} K={kmax} T={T}"
    _report("dag", label, errs, rel, ok)
    if not ok:
        fails.append(label)
    ms = _time_cuda(kern, reps=7)
    plain_ms = _time_cuda(plain, reps=3, warm=1)
    dev_ms = _device_ms(kern, reps=10)
    bound_ms, by = _bound(mode, F, kmax, T, ex.shape[0], True)
    blocks = _call_blocks(mode, F, kmax, T, fam)
    log(f"[dag] {label} kernel {ms:.4f} ms (device "
        + (f"{dev_ms:.4f}" if dev_ms is not None else "not measured")
        + f")  plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms ({by})  "
        f"blocks {blocks}")
    del got, again, want
    torch.cuda.empty_cache()
    return {"tag": tag, "phase": phase, "mode": mode, "F": F, "K": kmax,
            "T": T, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "blocks": blocks,
            "max_abs_err": max(errs), "ok": ok}


@contextmanager
def _plain_composition():
    """The joint solver's composition and its gradient on the plain path
    (``compose_structure`` and autograd on the card) in place of the
    ``compose_grads`` kernel: the cost before the kernel, for comparison."""
    from repro_torch.workflow import solve as wsolve
    saved = wsolve._compose_grads

    def plain(structure, smu, svar, lam32, enc=None):
        return wsolve._compose_grads_plain(structure, smu, svar, lam32)

    wsolve._compose_grads = plain
    try:
        yield
    finally:
        wsolve._compose_grads = saved


def _refine_step_cost(tag, dag, survivors, num_t, steps=20, prof_steps=4):
    """Host and device milliseconds of one composed refine step at the
    solver's refine shape (``survivors`` starts, ``steps`` steps on the host
    clock, ``prof_steps`` in one complete profiled window,
    ``_device_window``): the device time split into the adjoint (the
    frontier gradient kernels), ``compose_grads`` and the rest; the
    composition's own host time, and the torch operations of a step; under
    ``_plain_composition`` the step before the kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels import compose
    from repro_torch.workflow import solve as wsolve
    dev = torch.device("cuda")
    groups, mask, kmax = wsolve._stage_groups(dag)
    S = len(dag.stages)
    stacks = wsolve._Stacks(groups, dev, dag.structure)
    masks = torch.tensor(mask, device=dev)
    W0 = torch.tensor(wsolve._starts(dag, mask, kmax, survivors, None,
                                     0)[2:2 + survivors], device=dev)
    upd = np.ones(S, np.float32)

    def run(n):
        return wsolve._pgd_phase(dag.structure, stacks, masks, W0, upd, 0.0,
                                 1e-6, n, n, num_t, True, lr=0.005,
                                 warmup=n // 2)

    smu = torch.rand((survivors, S), device=dev) * 10 + 5
    svar = torch.rand((survivors, S), device=dev) + 0.1
    enc = stacks.compose
    n = compose.LAUNCHES["compose_grads"]
    with _OpCount() as ops_compose:
        wsolve._compose_grads(dag.structure, smu, svar, 0.0, enc)
    path = "kernel" if compose.LAUNCHES["compose_grads"] > n else "plain"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        wsolve._compose_grads(dag.structure, smu, svar, 0.0, enc)
    torch.cuda.synchronize()
    compose_ms = 1e3 * (time.perf_counter() - t0) / 5
    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps
    by_name = _device_window(
        lambda: run(prof_steps), reps=1,
        expect=("compose_grads", prof_steps) if path == "kernel" else None)

    def per_step(part=""):
        if by_name is None:
            return None
        return sum(us for k, us in by_name.items()
                   if part in k) / 1e3 / prof_steps

    with _OpCount() as ops_all:
        run(1)
    total, adj, comp = (per_step(), per_step("frontier_grad"),
                        per_step("compose_grads"))
    out = {"tag": tag, "composition": path, "stages": S,
           "survivors": survivors, "host_ms_per_step": host_ms,
           "device_ms_per_step": total,
           "kernel_device_ms_per_step": adj,
           "compose_device_ms_per_step": comp,
           "rest_device_ms_per_step": (None if total is None
                                       else total - adj - comp),
           "compose_host_ms": compose_ms,
           "ops_per_step": ops_all.n, "compose_ops": ops_compose.n}

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    log(f"[dag] {tag} refine step, {path} composition ({survivors} starts x "
        f"{S} stages, T={num_t}): host {host_ms:.2f} ms, device "
        f"{fmt(total)} (adjoint {fmt(adj)}, compose_grads {fmt(comp)}, the "
        f"rest {fmt(out['rest_device_ms_per_step'])}); {ops_all.n} torch ops "
        f"a step, of which the composition and its gradient "
        f"{ops_compose.n} ({compose_ms:.2f} ms host)")
    return out


def _profile_solve(tag, fn):
    """One warm call of ``fn`` on the host clock and under torch.profiler:
    device time by kernel and the busy share (device time / wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    kern_ms = sum(ms for n, ms in by_name.items() if "frontier_" in n)
    busy = dev_ms / wall_ms if dev_ms > 0 else None
    log(f"[dag] {tag} warm joint solve: wall {wall_ms:.1f} ms, device "
        + (f"{dev_ms:.2f} ms (frontier kernels {kern_ms:.2f}), busy share "
           f"{busy:.3f}" if busy is not None else "not measured"))
    for n, ms in top:
        log(f"[dag]   {ms:9.3f} ms  {n[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms or None,
            "frontier_kernel_ms": kern_ms or None, "busy_share": busy,
            "top": [{"name": n, "ms": ms} for n, ms in top]}


def _mixed_dag():
    """8 stages of three families (normal, lognormal, drift) with K of
    256, 200 and 131 (zero-padded): a fork into three branches, one
    joined back."""
    import numpy as np
    from repro_torch.core.distributions import Drift
    from repro_torch.workflow import Stage, StageDAG
    rng = np.random.default_rng(11)
    ks = (256, 200, 131)
    stages = []
    for i in range(8):
        k = ks[i % 3]
        mus = rng.uniform(10.0, 40.0, k)
        fam = ("normal", "lognormal",
               Drift(rng.uniform(0.1, 0.8, k).astype(np.float32)))[i % 3]
        stages.append(Stage(f"m{i}", mus, mus * rng.uniform(0.05, 0.5, k),
                            family=fam))
    edges = [("m0", "m1"), ("m0", "m2"), ("m0", "m3"), ("m1", "m4"),
             ("m2", "m5"), ("m3", "m6"), ("m4", "m7"), ("m5", "m7"),
             ("m6", "m7")]
    return StageDAG(stages, edges)


def _wide_structure():
    """A ``StageDAG.structure`` with a 24-way join of branches 1-3 stages
    long, a tail and two more sinks off branch stages (three sinks)."""
    import numpy as np
    from repro_torch.workflow import StageDAG
    rng = np.random.default_rng(24)
    names, edges, ends, inner = ["src"], [], [], []
    for b in range(24):
        prev = "src"
        for j in range(int(rng.integers(1, 4))):
            n = f"b{b}_{j}"
            names.append(n)
            edges.append((prev, n))
            inner.append(n)
            prev = n
        ends.append(prev)
    names += ["join", "tail", "side0", "side1"]
    edges += [(e, "join") for e in ends] + [("join", "tail")]
    edges += [(inner[int(rng.integers(len(inner)))], f"side{i}")
              for i in range(2)]
    return StageDAG.from_names(names, edges).structure


def _refine_inputs(dag, R, num_t):
    """The stage moments (R, S) of ``R`` random starts of ``dag`` at
    ``num_t`` on the card: what a refine step hands the composition."""
    import torch
    from repro_torch.workflow import solve as wsolve
    dev = torch.device("cuda")
    groups, mask, kmax = wsolve._stage_groups(dag)
    stacks = wsolve._Stacks(groups, dev)
    W = torch.tensor(wsolve._starts(dag, mask, kmax, R, None, 0)[2:2 + R],
                     device=dev)
    return wsolve._stage_moments(W, stacks, num_t, None)


def _compose_bound(structure, R):
    """(bound_ms, bound_by) of one compose_grads call: the moments read and
    the losses and gradients written once, the structure read once; the
    fold steps' operations."""
    from repro_torch.kernels import compose
    topo, preds, sinks = structure
    S = len(topo)
    steps = compose.encode_arrays(structure)[4]
    nbytes = 4 * (4 * R * S + R) + 4 * (2 * S + 1 + sum(map(len, preds))
                                         + len(sinks))
    special = R * steps * COMPOSE_FOLD["special"]
    fp32 = R * (steps * COMPOSE_FOLD["fp32"] + 4 * S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(special / SFU_OPS_PER_S, fp32 / FP32_OPS_PER_S)
    return (1e3 * t_bytes, "bytes") if t_bytes > t_ops else \
        (1e3 * t_ops, "operations")


def _compose_chain_ms(structure):
    """compose_grads' dependency chain a row (CHAIN_CYCLES), ms: the
    staging copy, each level's rounds of lanes both ways, every fold step
    forward and back, the longest cotangent sum."""
    import numpy as np
    from repro_torch.kernels import compose
    a = compose.encode_arrays(structure)
    c = CHAIN_CYCLES
    rounds = sum(-(-int(n) // 32) for n in np.diff(a.lvl_off))
    refs = max(np.diff(a.mref_off).max(initial=0)
               + np.diff(a.vref_off).max(initial=0), 0)
    cycles = (c["stage"] + 2 * rounds * c["round"]
              + a.n_steps * (c["fold_fwd"] + c["fold_bwd"])
              + int(refs) * c["add32"])
    return 1e3 * cycles / CARD["sm_hz"]


def _bits_equal(a, b):
    """Bit for bit (float32): the same words, signed zeros and NaNs too."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _compose_hold(tag, structure, smu, svar, lam, fails):
    """``compose_grads`` on the card against its plain version on the
    card, bit for bit, twice (the bits repeat), with its event-pair, device
    and host time, the plain version's time, the bound, the chain estimate
    and the plan's shared memory."""
    import numpy as np
    import torch
    from repro_torch.kernels import compose
    from repro_torch.workflow import solve as wsolve
    R, S = smu.shape
    lam32 = float(np.float32(lam))
    enc = compose.encode(structure, smu.device)

    def kern():
        return compose.compose_grads(enc, smu, svar, lam32)

    def plain():
        return wsolve._compose_grads_plain(structure, smu, svar, lam32)

    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    loss_rel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
    g_rel = [_rel_l2(g, w) for g, w in zip(got[1:], want[1:])]
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    bitwise = all(_bits_equal(g, w) for g, w in zip(got, want))
    ok = (bitwise and all(bool(torch.isfinite(t).all()) for t in got)
          and all(_bits_equal(a, b) for a, b in zip(got, again)))
    ms = _time_cuda(kern, reps=7)
    dev_ms = _device_ms(kern, reps=10, expect=("compose_grads", 1))
    host_ms = _host_ms(kern, reps=50)
    plain_ms = _time_cuda(plain, reps=3, warm=1)
    bound_ms, by = _compose_bound(structure, R)
    chain_ms = _compose_chain_ms(structure)
    label = f"{tag} R={R} S={S} fold steps {enc.n_steps} lam={lam}"
    log(f"[dag] compose_grads {label}: losses rel {loss_rel:.1e}, gradients "
        f"rel L2 {g_rel[0]:.1e} / {g_rel[1]:.1e}, max|err| {max_abs:.2e}"
        + (" (bitwise, repeats)" if ok else "  FAIL")
        + f"; kernel {ms:.4f} ms (device "
        + (f"{dev_ms:.4f}" if dev_ms is not None else "not measured")
        + f", host {host_ms:.4f}) plain {plain_ms:.3f} ms bound "
        f"{bound_ms:.3e} ms ({by}) chain estimate {chain_ms:.4f} ms; shared "
        "memory "
        + (f"{enc.smem} B a block" if enc.smem else
           f"none (a {4 * enc.floats} B workspace a row)"))
    if not ok:
        fails.append(f"compose_grads {label}")
    return {"tag": tag, "R": R, "S": S, "lam": lam, "loss_rel": loss_rel,
            "grad_rel_l2": g_rel, "max_abs_err": max_abs, "bitwise": bitwise,
            "ok": ok, "ms": ms,
            "device_ms": dev_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "smem": enc.smem}


def _port_launches():
    """The launch counts of the port's two kernels with no Pallas
    counterpart."""
    from repro_torch.kernels import compose
    from repro_torch.kernels import family_score as fs
    return {**compose.LAUNCHES, **fs.LAUNCHES}


def _reset_port():
    from repro_torch.kernels import compose
    from repro_torch.kernels import family_score as fs
    compose.reset_launches()
    fs.reset_launches()


def phase_dag(ctx):
    """The dag_scale experiment at full scale on the card, then its checks
    and costs (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.bench import dag_scale as bench
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.workflow import evaluate_dag, solve_dag
    from repro_torch.workflow import solve as wsolve
    fails = []
    torch.cuda.synchronize()
    fg.reset_launches()
    _reset_port()
    wsolve.reset_syncs()
    t0 = time.perf_counter()
    res = bench.run(smoke=False, device="cuda", repeats=DAG_REPEATS,
                    scale_repeats=1, scale_warmup=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(fg.LAUNCHES)
    port = _port_launches()
    syncs = dict(wsolve.SYNCS)
    ctx["dag_launches"] = counts
    ctx["dag_port_launches"] = port
    if port["compose_grads"] <= 0:
        fails.append(f"the composition's kernel never launched: {port}")
    j, g, sc = res["joint"], res["greedy"], res["scale_point"]
    log(f"[dag] main path: {res['stages']} stages, K={res['channels']}, "
        f"T={res['num_t']}, {res['steps']} steps, {res['trials']} trials, "
        f"{DAG_REPEATS} warm solves a method and the {sc['stages']}-stage "
        f"scale point, {run_s:.1f} s; launches {counts}, {port}, plateau "
        f"reads "
        f"{syncs['plateau']} over {syncs['steps']} PGD steps")
    for name, d in (("joint", j), ("greedy", g)):
        log(f"[dag] {name:6s} predicted makespan mu {d['makespan_mu']:.6f} "
            f"var {d['makespan_var']:.6f}; realized mean "
            f"{d['mc_makespan_mu']:.6f} var {d['mc_makespan_var']:.6f}; "
            f"wall median {d['median_us'] / 1e3:.1f} ms p90 "
            f"{d['p90_us'] / 1e3:.1f} ms; launches a solve "
            f"{d['launches_per_solve']}; phase_us {d['phase_us']}")
    log(f"[dag] improvement {res['improvement_pct']:.4f}% predicted, "
        f"{res['realized_improvement_pct']:.4f}% realized; wall ratio "
        f"joint/greedy {res['joint_vs_greedy_wallclock_ratio']:.3f}")
    log(f"[dag] joint: {j['profile']}; host reads {j['plateau_reads']} over "
        f"{j['pgd_steps']} steps "
        f"({j['plateau_reads'] / max(j['pgd_steps'], 1):.3f} a step)")
    log(f"[dag] scale point {sc['stages']} stages K={sc['channels']} "
        f"T={sc['num_t']}: wall {sc['median_us'] / 1e6:.2f} s, makespan mu "
        f"{sc['makespan_mu']:.4f}, launches {sc['launches_per_solve']}, "
        f"{sc['profile']}, host reads {sc['plateau_reads']} over "
        f"{sc['pgd_steps']} steps; phase_us {sc['phase_us']}")
    if j["makespan_mu"] > g["makespan_mu"]:
        fails.append("joint above greedy on the predicted makespan")
    if res["family_groups"] != 1 or sc["family_groups"] != 1:
        fails.append(f"family_groups {res['family_groups']}")

    # the card's splits re-evaluated by the plain path on the CPU
    dag = bench.make_dag()
    evals = {}
    for name in ("joint", "greedy"):
        w = res["weights"][name]
        card = evaluate_dag(dag, w, num_t=2048, device="cuda")
        cpu = evaluate_dag(dag, w, num_t=2048, device="cpu")
        d_mu = abs(card.makespan_mu - cpu.makespan_mu) / abs(cpu.makespan_mu)
        d_var = abs(card.makespan_var - cpu.makespan_var) / abs(
            cpu.makespan_var)
        ok = d_mu <= DAG_TOL_MU and d_var <= DAG_TOL_VAR and abs(
            card.makespan_mu - res[name]["makespan_mu"]) <= DAG_TOL_MU * abs(
            cpu.makespan_mu)
        evals[name] = {"card_mu": card.makespan_mu, "cpu_mu": cpu.makespan_mu,
                       "card_var": card.makespan_var,
                       "cpu_var": cpu.makespan_var, "rel_mu": d_mu,
                       "rel_var": d_var, "ok": ok}
        log(f"[dag] {name} split, evaluate_dag card against CPU plain: mu "
            f"{card.makespan_mu:.6f} / {cpu.makespan_mu:.6f} (rel {d_mu:.1e}"
            f"), var {card.makespan_var:.6f} / {cpu.makespan_var:.6f} (rel "
            f"{d_var:.1e})" + ("  ok" if ok else "  FAIL"))
        if not ok:
            fails.append(f"{name} evaluation card/CPU")

    # every rung's launch against its plain version, at the shapes of the
    # 32-stage solve and of the scale point
    rungs = []
    big = bench.make_dag(bench.SCALE_BRANCHES, bench.BRANCH_LEN,
                         bench.TICK_K, seed=1)
    for tag, d, r in (("S=32", dag, {**j, "num_t": res["num_t"]}),
                      ("S=512", big, {**sc, "num_t": sc["num_t"]})):
        for phase, mode, R, T in _dag_rungs(r):
            rungs.append(_dag_rung_check(tag, d, phase, mode, R, T, fails))

    # the composition's kernel against its plain version at the refine
    # shapes of both solves, the scale point at the solver's 20 starts, and
    # on a wide join with several sinks
    composes = []
    for tag, d, R, T in (("S=32", dag, j["profile"]["survivors"],
                          res["num_t"]),
                         ("S=512", big, sc["profile"]["survivors"],
                          sc["num_t"]),
                         ("S=512", big, 20, sc["num_t"])):
        smu, svar = _refine_inputs(d, R, T)
        for lam in (0.0, 0.05):
            composes.append(_compose_hold(tag, d.structure, smu, svar, lam,
                                          fails))
    wide = _wide_structure()
    rng = np.random.default_rng(5)
    shape = (6, len(wide[0]))
    smu = torch.tensor(rng.uniform(2.0, 12.0, shape).astype(np.float32),
                       device="cuda")
    var = rng.uniform(0.05, 3.0, shape).astype(np.float32)
    var[0, 1] = 0.0
    svar = torch.tensor(var, device="cuda")
    for lam in (0.0, 0.05):
        composes.append(_compose_hold("wide join, 3 sinks", wide, smu, svar,
                                      lam, fails))
    ctx.setdefault("port_kernels", {})["compose_grads"] = {
        **composes[0], "max_abs_err": max(c["max_abs_err"]
                                          for c in composes)}

    # where a refine step's time goes, before and after the kernel, and one
    # profiled warm solve
    t_sub = time.perf_counter()
    log(f"[dag] rung and composition checks in {t_sub - t0 - run_s:.1f} s")
    steps = []
    for plain in (True, False):
        with _plain_composition() if plain else nullcontext():
            steps += [_refine_step_cost("S=32", dag,
                                        j["profile"]["survivors"],
                                        res["num_t"]),
                      _refine_step_cost("S=512", big,
                                        sc["profile"]["survivors"],
                                        sc["num_t"], steps=4, prof_steps=1)]
    prof = _profile_solve("dag_joint", lambda: solve_dag(
        dag, steps=res["steps"], restarts=1, num_t=res["num_t"],
        device="cuda"))
    log(f"[dag] step costs and the profile in "
        f"{time.perf_counter() - t_sub:.1f} s")

    # a mixed-family DAG: one call per family group per evaluation, the
    # same decision as the CPU's plain path
    mixed = _mixed_dag()
    kw = dict(steps=20, restarts=1, num_t=128, plateau_patience=None)
    fg.reset_launches()
    dm = solve_dag(mixed, device="cuda", **kw)
    m_counts = dict(fg.LAUNCHES)
    dm_cpu = solve_dag(mixed, device="cpu", **kw)
    m_rel = abs(dm.makespan_mu - dm_cpu.makespan_mu) / dm_cpu.makespan_mu
    want = {"fwd": 3 * 2, "grad": 3 * 40, "pgrad": 0}
    ok = (dm.family_groups == 3 and m_counts == want
          and m_rel <= DAG_TOL_MU)
    log(f"[dag] mixed 8-stage DAG: family_groups {dm.family_groups}, "
        f"launches {m_counts} (want {want}), makespan card "
        f"{dm.makespan_mu:.6f} CPU {dm_cpu.makespan_mu:.6f} (rel "
        f"{m_rel:.1e})" + ("  ok" if ok else "  FAIL"))
    if not ok:
        fails.append("mixed-family DAG")
    # an empty dirty set: the warm split, one forward call per group, no
    # PGD launch
    fg.reset_launches()
    noop = solve_dag(mixed, device="cuda", warm_start=dm.weights, dirty=(),
                     **kw)
    n_counts = dict(fg.LAUNCHES)
    same = all(np.array_equal(noop.weights[n], w)
               for n, w in dm.weights.items())
    ok = same and n_counts == {"fwd": 3, "grad": 0, "pgrad": 0}
    log(f"[dag] empty dirty set: launches {n_counts}, warm split "
        + ("verbatim" if same else "moved") + ("  ok" if ok else "  FAIL"))
    if not ok:
        fails.append("empty dirty set")
    # the reference's acceptance gates, last
    try:
        bench.check_gates(res)
        log(f"[dag] check_gates: the reference's four gates hold (wall ratio "
            f"{res['joint_vs_greedy_wallclock_ratio']:.3f} <= 1.0)")
    except AssertionError as e:
        log(f"[dag] check_gates FAILED: {e!r}")
        fails.append(f"dag_scale.check_gates: {e!r}")
    ctx["dag"] = {"result": {k: v for k, v in res.items() if k != "weights"},
                  "run_s": run_s, "launches": counts, "syncs": syncs,
                  "port_launches": port, "compose_checks": composes,
                  "evaluations": evals, "rungs": rungs,
                  "refine_steps": steps, "profile": prof,
                  "mixed": {"launches": m_counts,
                            "family_groups": dm.family_groups,
                            "rel_mu": m_rel},
                  "noop_launches": n_counts}
    if fails:
        raise AssertionError(f"dag phase failed: {fails}")


def phase_wfloop(ctx):
    """WorkflowBalancer on the 32-stage DAG against WorkflowSim.from_dag:
    WF_TICKS ticks for each of WF_CONFIGS, stage WF_SLOW_STAGE slowed 3x
    at tick WF_SLOW_AT."""
    import numpy as np
    import torch
    from repro_torch.bench import dag_scale as bench
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.sched import WorkflowBalancer
    from repro_torch.sim import WorkflowSim
    dag = bench.make_dag()
    stats, total = {}, {m: 0 for m in fg.LAUNCHES}
    empty_ticks, fails = 0, []
    torch.cuda.synchronize()
    _reset_port()
    for name, kw in WF_CONFIGS:
        bal = WorkflowBalancer(dag, family="normal", refresh_every=5,
                               pgd_steps=bench.PGD_STEPS,
                               num_t=bench.TICK_T, restarts=1,
                               device="cuda", **kw)
        sim = WorkflowSim.from_dag(dag, seed=0)
        dirty_log = []
        spy_of = bal._dirty_stages

        def spy(live, spy_of=spy_of, dirty_log=dirty_log):
            d = spy_of(live)
            dirty_log.append(-1 if d is None else len(d))
            return d

        bal._dirty_stages = spy
        torch.cuda.synchronize()
        fg.reset_launches()
        tick_s, spans, solves, sizes, frags = [], [], 0, [], []
        for t in range(WF_TICKS):
            if t == WF_SLOW_AT:
                for idx in range(dag.stages[0].k):
                    sim.stage_sims[WF_SLOW_STAGE].inject_slowdown(idx, 3.0)
            before = dict(fg.LAUNCHES)
            n_dirty = len(dirty_log)
            prev = bal.last_decision
            t0 = time.perf_counter()
            w = bal.weights()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t0)
            if bal.last_decision is not prev:
                solves += 1
                frags.append(bal.last_decision.relative_fragility)
            if len(dirty_log) > n_dirty:
                sizes.append(dirty_log[-1])
                if dirty_log[-1] == 0:
                    empty_ticks += 1
                    if fg.LAUNCHES["grad"] != before["grad"]:
                        fails.append(f"{name} tick {t}: PGD launched on an "
                                     f"empty dirty set")
            mk, _, durs = sim.run_dag_step(dag, w)
            bal.observe(durs, w)
            spans.append(mk)
            if not all(np.isfinite(x).all() and abs(x.sum() - 1) < 1e-4
                       for x in w.values()):
                fails.append(f"{name} tick {t}: bad split")
        torch.cuda.synchronize()
        counts = dict(fg.LAUNCHES)
        for m in total:
            total[m] += counts[m]
        tick_s = np.asarray(tick_s)
        stats[name] = {"tick_mean_s": float(tick_s.mean()),
                       "tick_max_s": float(tick_s.max()),
                       "solves": solves, "solves_per_tick": solves / WF_TICKS,
                       "dirty_sizes": sizes, "launches": counts,
                       "relative_fragility": frags,
                       "makespan_mean": float(np.mean(spans)),
                       "makespan_after_slowdown": float(
                           np.mean(spans[WF_SLOW_AT:])),
                       "effective_refresh": bal.effective_refresh}
        log(f"[wfloop] {name:15s} tick mean {1e3 * tick_s.mean():.1f} ms max "
            f"{1e3 * tick_s.max():.1f} ms; {solves} solves in {WF_TICKS} "
            f"ticks; dirty-set sizes at refreshes {sizes} (-1: full "
            f"solve); relative fragility of the solves "
            + " ".join("-" if f is None else f"{f:.4f}" for f in frags)
            + f"; launches {counts}; makespan mean "
            f"{np.mean(spans):.3f} (after the slowdown "
            f"{np.mean(spans[WF_SLOW_AT:]):.3f})")
    ctx["wfloop"] = stats
    ctx["wfloop_launches"] = total
    ctx["wfloop_port_launches"] = _port_launches()
    log(f"[wfloop] launches {total}, {ctx['wfloop_port_launches']}; "
        f"{empty_ticks} refresh(es) with an empty dirty set")
    if min(total.values()) <= 0:
        fails.append(f"a kernel mode never launched: {total}")
    if fails:
        raise AssertionError(f"wfloop phase failed: {fails}")


# ------------------------------------------------------------- serving engine
# the engine's host stages, as the JAX engine's trace spans name them, and
# the WorkflowEngine method each times
ENGINE_STAGES = (("admission", "_admit"), ("stack_rows", "_gather_rows"),
                 ("launch", "_solve_tick"), ("commit", "_execute"))
# every ENGINE_CHECK_EVERY-th tick's stacked launches are held against the
# plain version on the card
ENGINE_CHECK_EVERY = 10
# the full trace's ticks after the first and through the second of these
# run under torch.profiler (whole ticks, no ratio sample among them)
ENGINE_PROFILE = (60, 65)
ENGINE_CLI_TICKS = 40
# the smoke trace on the card against the CPU: join latencies to this
# relative tolerance
ENGINE_TOL_JOIN = 1e-4


def _sync_quiet():
    """A device synchronization the sync counter does not count."""
    import torch
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)


class _EngineProbe:
    """Instruments ``WorkflowEngine`` while it is active: the host time of
    each stage of a tick on a synchronized clock, the device syncs of each
    tick (torch's sync debug mode, its own synchronizations excluded), the
    frontier calls each tick made, and each settled instance's posterior
    drift at its re-dirty check. It patches the class and restores it on
    exit."""

    def __init__(self, count_syncs=True, track_drift=False):
        self.count_syncs = count_syncs
        self.track_drift = track_drift   # re-reads the heads: off when timed
        self.ticks = []        # one dict per tick
        self.redirty = []      # (tick, iid, drift, dirtied)

    def __enter__(self):
        import warnings
        import torch
        from repro_torch.kernels import frontier_grid as fg
        from repro_torch.serve.engine import WorkflowEngine
        self._orig = {m: getattr(WorkflowEngine, m)
                      for m in ["tick", "_maybe_redirty"]
                      + [m for _, m in ENGINE_STAGES]}
        probe, orig = self, self._orig
        on_card = torch.cuda.is_available()

        def stage(name, meth):
            def run(eng, *a, **k):
                if eng.device.type == "cuda":
                    _sync_quiet()
                t0 = time.perf_counter()
                out = orig[meth](eng, *a, **k)
                if eng.device.type == "cuda":
                    _sync_quiet()
                probe._cur[name] += 1e3 * (time.perf_counter() - t0)
                return out
            return run

        def tick(eng, arrivals=()):
            probe._cur = {name: 0.0 for name, _ in ENGINE_STAGES}
            before = dict(fg.LAUNCHES)
            count = probe.count_syncs and eng.device.type == "cuda"
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if count:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = orig["tick"](eng, arrivals)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode(0)
            wall = 1e3 * (time.perf_counter() - t0)
            probe.ticks.append({
                "tick": out["tick"], "admitted": out["admitted"],
                "retired": [(r["iid"], r["join_latency_s"])
                            for r in out["retired"]],
                "rows": out["rows"], "launches": out["launches"],
                "groups": len({r.family.dist_id for r in eng.last_rows}),
                "calls": {m: fg.LAUNCHES[m] - before[m] for m in before},
                "syncs": (sum("synchroniz" in str(w.message)
                              for w in caught) if count else None),
                "wall_ms": wall, **probe._cur})
            return out

        def redirty(eng, inst):
            drift = eng._posterior_drift(inst)
            orig["_maybe_redirty"](eng, inst)
            probe.redirty.append((eng.tick_count, inst.iid, drift,
                                  inst.steps_left > 0))

        WorkflowEngine.tick = tick
        if self.track_drift:
            WorkflowEngine._maybe_redirty = redirty
        for name, meth in ENGINE_STAGES:
            setattr(WorkflowEngine, meth, stage(name, meth))
        return self

    def __exit__(self, *exc):
        from repro_torch.serve.engine import WorkflowEngine
        for m, fn in self._orig.items():
            setattr(WorkflowEngine, m, fn)


def _engine_launch_check(eng, fails, shapes, every_group):
    """The tick's stacked launches again, from ``eng.last_rows``: each
    family group's inputs (``serve.engine.stack_group``) through the kernel
    on the card against its plain version there, twice (the bits repeat);
    the kernel's mu must be the engine's priced row moment, bit for bit.
    Every group with ``every_group``, else only a (family, F) not seen
    before; the first inputs of each go to ``shapes``."""
    import numpy as np
    import torch
    from repro_torch.kernels import autotune, frontier_grid as fg, ops
    from repro_torch.serve.engine import stack_group
    from repro_torch.workflow.solve import stack_rows
    rows = eng.last_rows
    groups, mask, kmax = stack_rows([(r.mus, r.sigmas, r.family)
                                     for r in rows], kmax=eng.kmax)
    for g in groups:
        if not every_group and (g.dist_id, autotune.bucket_rows(
                len(g.idx))) in shapes:
            continue
        W, mus, sgs, ex, _, _ = stack_group(rows, g, mask, kmax)
        W, mus, sgs, ex = (torch.tensor(a, device="cuda")
                           for a in (W, mus, sgs, ex))
        F, T = W.shape[0], eng.num_t
        got = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                          dist_id=g.dist_id)
        again = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                            dist_id=g.dist_id)
        want = ops.plain_moments(W, mus, sgs, ex, num_t=T,
                                 dist_id=g.dist_id, mode="grad")
        errs, rel, ok = _compare(got, want)
        ok &= all(torch.equal(a, b) for a, b in zip(got, again))
        priced = np.asarray([rows[i].mu for i in g.idx], np.float64)
        same = np.array_equal(
            got[0][:len(g.idx)].cpu().numpy().astype(np.float64), priced)
        ok &= same
        tag = (f"tick {eng.tick_count} {g.dist_id:9s} rows {len(g.idx)} "
               f"F={F} K={kmax} T={T}")
        _report("engine", tag + (" (= the engine's mu)" if same else
                                 " (NOT the engine's mu)"), errs, rel, ok)
        if not ok:
            fails.append(tag)
        shapes.setdefault((g.dist_id, F), (W, mus, sgs, ex, T,
                                           max(max(errs), 0.0)))


def _engine_shape_times(shapes):
    """Event-pair and device ms, bound and blocks of the grad call at each
    engine shape seen, and the plain version's ms."""
    from repro_torch.kernels import frontier_grid as fg, ops
    out = []
    for (fam, F), (W, mus, sgs, ex, T, err) in sorted(shapes.items()):
        K = W.shape[1]

        def kern():
            return fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                               dist_id=fam)

        def plain():
            return ops.plain_moments(W, mus, sgs, ex, num_t=T, dist_id=fam,
                                     mode="grad")

        ms = _time_cuda(kern, reps=9)
        plain_ms = _time_cuda(plain, reps=3, warm=1)
        dev_ms = _device_ms(kern)
        bound_ms, by = _bound("grad", F, K, T, ex.shape[0], True)
        blocks = _call_blocks("grad", F, K, T, fam)
        rec = {"family": fam, "F": F, "K": K, "T": T, "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": by, "blocks": blocks,
               "max_abs_err": err}
        out.append(rec)
        log(f"[engine] grad {fam:9s} F={F:4d} K={K} T={T}: kernel {ms:.4f} "
            f"ms (device " + (f"{dev_ms:.4f}" if dev_ms else "not measured")
            + f"), plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({by}), "
            f"device/bound "
            + (f"{dev_ms / bound_ms:.1f}x" if dev_ms else "n/a")
            + f", blocks {blocks}")
    return out


def _percentiles(xs):
    import numpy as np
    xs = np.asarray(xs, np.float64)
    return {"mean": float(xs.mean()), "p50": float(np.percentile(xs, 50)),
            "p90": float(np.percentile(xs, 90)), "max": float(xs.max())}


def phase_engine(ctx):
    """The serve_trace experiment at full scale on the card through the
    continuous-batching WorkflowEngine, then its checks (see the module
    docstring)."""
    import warnings
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bench import serve_trace as bench
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.launch import serve as cli
    fails, shapes = [], {}

    # the sync counter counts: one known synchronization under it
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.ones(1, device="cuda").cpu()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if not any("synchroniz" in str(w.message) for w in caught):
        fails.append("the sync counter saw no synchronization")

    prof = {}

    def on_tick(eng, t, out):
        if eng.last_rows:
            _engine_launch_check(eng, fails, shapes,
                                 (t + 1) % ENGINE_CHECK_EVERY == 0)
        # the device's busy share over a window of whole ticks
        if t == ENGINE_PROFILE[0]:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        elif t == ENGINE_PROFILE[1]:
            torch.cuda.synchronize()
            prof["wall_ms"] = 1e3 * (time.perf_counter() - prof["t0"])
            prof["p"].stop()

    torch.cuda.synchronize()
    fg.reset_launches()
    t0 = time.perf_counter()
    with _EngineProbe() as probe:
        res = bench.run(smoke=False, device="cuda", on_tick=on_tick)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ticks = probe.ticks
    ctx["engine_ticks"] = ticks   # the trace phase's untraced run
    calls = {m: sum(t["calls"][m] for t in ticks) for m in fg.LAUNCHES}
    ctx["engine_launches"] = calls
    c = res["counters"]
    log(f"[engine] main path: serve_trace {res['ticks']} ticks, max_live "
        f"{res['max_live']}, T={bench.NUM_T}, {run_s:.1f} s; counters {c}; "
        f"frontier calls in the ticks {calls}")
    for e in res["entries"]:
        log(f"[engine] {e['name']:18s} ({e['family']:9s}) join latency "
            f"mean {e['mean_s']:.4f} p50 {e['p50_s']:.4f} p99 "
            f"{e['p99_s']:.4f} s")
    st, rp, oc, lv = (res["solver_tick_us"], res["rows_per_launch"],
                      res["row_occupancy"], res["live_instances"])
    log(f"[engine] solver tick p50 {st['p50']:.0f} us p90 {st['p90']:.0f} us"
        f" (max {st['max']:.0f}); rows per launch mean {rp['mean']:.1f} p50 "
        f"{rp['p50']:.0f} max {rp['max']:.0f}; occupancy mean "
        f"{oc['mean']:.3f}; live max {lv['max']:.0f} mean {lv['mean']:.1f}; "
        f"SLO miss rate {res['slo']['miss_rate']:.4f} "
        f"({res['slo']['misses']}/{res['slo']['retired']}); "
        f"batched_vs_looped_ratio {res['batched_vs_looped_ratio']:.3f}")
    if lv["max"] < 256:
        fails.append(f"live high-water {lv['max']} < 256")
    bad = [t["tick"] for t in ticks
           if not (t["launches"] == t["groups"] == t["calls"]["grad"])
           or t["calls"]["fwd"] or t["calls"]["pgrad"]]
    if bad:
        fails.append(f"ticks without one launch per family group: {bad}")
    host = {name: _percentiles([t[name] for t in ticks])
            for name, _ in ENGINE_STAGES + (("wall_ms", None),)}
    syncs = [t["syncs"] for t in ticks]
    launch_ticks = [t for t in ticks if t["launches"]]
    share = (sum(t["launch"] for t in ticks)
             / max(sum(t["wall_ms"] for t in ticks), 1e-9))
    log("[engine] host ms a tick (synchronized): " + "; ".join(
        f"{n} mean {h['mean']:.3f} p50 {h['p50']:.3f} p90 {h['p90']:.3f}"
        for n, h in host.items()) + f"; launch share of the tick "
        f"{share:.3f}")
    n_prof = ENGINE_PROFILE[1] - ENGINE_PROFILE[0]
    prof_ticks = ticks[ENGINE_PROFILE[0] + 1:ENGINE_PROFILE[1] + 1]
    dev_ms = sum(e.self_device_time_total for e in prof["p"].key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    busy = dev_ms / prof["wall_ms"] if dev_ms > 0 else None
    log(f"[engine] ticks {prof_ticks[0]['tick']}-{prof_ticks[-1]['tick']} "
        f"under torch.profiler: wall {prof['wall_ms']:.1f} ms, device "
        + (f"{dev_ms:.3f} ms, busy share {busy:.4f}, host share "
           f"{1 - busy:.4f}" if busy is not None else "not measured")
        + f" ({sum(t['launches'] for t in prof_ticks)} launches in "
        f"{n_prof} ticks)")
    log(f"[engine] device syncs a tick: mean {np.mean(syncs):.2f} max "
        f"{max(syncs)}; per launch "
        f"{sum(syncs) / max(sum(t['launches'] for t in ticks), 1):.2f} "
        f"({len(launch_ticks)} ticks launched)")
    times = _engine_shape_times(shapes)

    # the serving CLI's engine mode, in-process on the card
    fg.reset_launches()
    t1 = time.perf_counter()
    eng = cli.main(["--engine", "--batches", str(ENGINE_CLI_TICKS),
                    "--device", "cuda", "--deadline", "4.0"])
    cli_calls = dict(fg.LAUNCHES)
    cli_c = eng.telemetry.counters
    log(f"[engine] launch.serve --engine: {ENGINE_CLI_TICKS} ticks in "
        f"{time.perf_counter() - t1:.1f} s, counters {cli_c}, frontier "
        f"calls {cli_calls}")
    if cli_c["ticks"] != ENGINE_CLI_TICKS or cli_calls["grad"] != \
            cli_c["launches"]:
        fails.append("launch.serve --engine")

    # the smoke trace on the card and on the CPU
    smoke = {}
    for dev in ("cuda", "cpu"):
        with _EngineProbe(count_syncs=False, track_drift=True) as p:
            bench.run(smoke=True, device=dev)
        smoke[dev] = p
    flips = [(a[0], a[1], a[2], b[2]) for a, b in
             zip(smoke["cuda"].redirty, smoke["cpu"].redirty)
             if a[:2] == b[:2] and a[3] != b[3]]
    first_flip = flips[0][0] if flips else None
    diverged = []
    for a, b in zip(smoke["cuda"].ticks, smoke["cpu"].ticks):
        same = all(a[k] == b[k] for k in ("admitted", "rows", "launches"))
        same &= [r[0] for r in a["retired"]] == [r[0] for r in b["retired"]]
        same &= all(abs(x[1] - y[1]) <= ENGINE_TOL_JOIN * abs(y[1])
                    for x, y in zip(a["retired"], b["retired"]))
        if not same:
            diverged.append(a["tick"])
    worst = max((abs(x[1] - y[1]) / abs(y[1])
                 for a, b in zip(smoke["cuda"].ticks, smoke["cpu"].ticks)
                 for x, y in zip(a["retired"], b["retired"])), default=0.0)
    log(f"[engine] smoke trace card against CPU: "
        f"{len(smoke['cuda'].ticks)} ticks, per-tick admitted/retired/"
        f"rows/launches " + ("equal" if not diverged else
                             f"differ at ticks {diverged}")
        + f"; join latency worst relative difference {worst:.2e}; "
        f"{len(smoke['cuda'].redirty)} re-dirty checks, dirty_tol flips "
        + (", ".join(f"tick {t} instance {i} drift card {dc:.6f} CPU "
                     f"{dp:.6f}" for t, i, dc, dp in flips)
           if flips else "none"))
    if diverged and (first_flip is None or min(diverged) < first_flip):
        fails.append(f"smoke trace card/CPU diverged at {diverged}")
    ctx["engine"] = {
        "result": res, "run_s": run_s, "calls": calls, "host_ms": host,
        "launch_share": share, "syncs_per_tick": float(np.mean(syncs)),
        "profile": {"ticks": n_prof, "wall_ms": prof["wall_ms"],
                    "device_ms": dev_ms or None, "busy_share": busy},
        "syncs_max": max(syncs), "shapes": times,
        "ticks": [{k: v for k, v in t.items() if k != "retired"}
                  for t in ticks],
        "cli": {"counters": cli_c, "calls": cli_calls},
        "smoke_card_vs_cpu": {"diverged": diverged, "flips": flips,
                              "worst_join_rel": worst}}
    if fails:
        raise AssertionError(f"engine phase failed: {fails}")


# the chaos phase's churn: (step, action, idx, value) on the fleet, and
# (step, action, stage, idx, value) on the workflow
CHAOS_CHURN = [(5, "fail", 2), (9, "throttle", 0, 2.0), (13, "recover", 2)]
CHAOS_WF_CHURN = [(3, "fail", "b0_1", 4, None),
                  (6, "set_load", None, None, 1.4),
                  (9, "recover", "b0_1", 4, None)]
ENGINE_KILL_TICKS, ENGINE_KILL_EVERY = 16, 4


def _engine_chaos(ckpt_dir):
    """An engine on the serve_trace templates killed every
    ENGINE_KILL_EVERY ticks: each kill saves a manifest, lets the
    survivor tick, restores a replica from the manifest and ticks it on the
    same arrivals; the replica's tick dict and every live split must be
    the survivor's bit for bit, and the replica runs on."""
    import numpy as np
    from repro_torch.bench import serve_trace as bench
    from repro_torch.ckpt import restore_pipeline, save_pipeline
    from repro_torch.serve import WorkflowEngine
    tpls = bench.templates()
    eng = WorkflowEngine(tpls, max_live=96, lam_var=0.02, settle_steps=4,
                         dirty_tol=0.08, num_t=bench.NUM_T, seed=5,
                         prior_obs=4, device="cuda")
    rng = np.random.default_rng(5)
    names = list(tpls)
    kills = parity = 0
    for t in range(1, ENGINE_KILL_TICKS + 1):
        arrivals = [(names[int(rng.integers(3))], 6.0)
                    for _ in range(int(rng.poisson(24)))]
        if t % ENGINE_KILL_EVERY:
            eng.tick(arrivals)
            continue
        save_pipeline(ckpt_dir, t, eng)
        survivor = eng.tick(arrivals)
        replica_eng, _, _ = restore_pipeline(ckpt_dir, templates=tpls,
                                             device="cuda")
        replica = replica_eng.tick(arrivals)
        same = survivor == replica and sorted(eng._live) == sorted(
            replica_eng._live) and all(
            np.array_equal(w, replica_eng._live[iid].weights[n])
            for iid, inst in eng._live.items()
            for n, w in inst.weights.items())
        if not same:
            raise AssertionError(f"engine kill/restore parity broken at "
                                 f"tick {t}")
        parity += 1
        kills += 1
        eng = replica_eng
    return {"ticks": ENGINE_KILL_TICKS, "kills": kills,
            "parity_checks": parity, "live": eng.live_count,
            "counters": dict(eng.telemetry.counters)}


def phase_chaos(ctx):
    """Kill/restore parity on the card (balancer, defective fleet,
    workflow, engine) and the full fault_trace (see the module
    docstring)."""
    import tempfile
    import torch
    from repro_torch.bench import dag_scale, fault_trace
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.sim.chaos import (run_chaos_trace,
                                       run_workflow_chaos_trace)
    fails, out = [], {}
    torch.cuda.synchronize()
    fg.reset_launches()
    _reset_port()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as d:
        runs = (("balancer", lambda: run_chaos_trace(
                    churn=CHAOS_CHURN, seed=0, device="cuda").summary()),
                ("defective", lambda: run_chaos_trace(
                    dist="defective", seed=3, device="cuda").summary()),
                ("workflow", lambda: run_workflow_chaos_trace(
                    dag_scale.make_dag(2, 3, 32), churn=CHAOS_WF_CHURN,
                    seed=0, device="cuda").summary()),
                ("engine", lambda: _engine_chaos(os.path.join(d, "eng"))))
        for name, fn in runs:
            t1 = time.perf_counter()
            r = fn()
            out[name] = r
            log(f"[chaos] {name:9s} {r['ticks']} ticks, {r['kills']} kills, "
                f"{r['parity_checks']} parity checks bitwise equal on the "
                f"card ({time.perf_counter() - t1:.1f} s); {r}")
            if r["kills"] < 1 or r["parity_checks"] != r["kills"]:
                fails.append(name)
        t1 = time.perf_counter()
        ft = fault_trace.run(device="cuda")
        ft_cpu = fault_trace.run(device="cpu")
    torch.cuda.synchronize()
    calls = dict(fg.LAUNCHES)
    ctx["chaos_launches"] = calls
    ctx["chaos_port_launches"] = _port_launches()
    mk = ft["makespan"]
    log(f"[chaos] fault_trace {ft['ticks']} ticks, {ft['channels']} "
        f"channels, mean fail_p {ft['mean_fail_p']:.4f}: blind mean "
        f"{mk['blind']['mean']:.6f} p99 {mk['blind']['p99']:.6f}, aware mean "
        f"{mk['aware']['mean']:.6f} p99 {mk['aware']['p99']:.6f}; aware "
        f"beats blind by {ft['improvement_pct']:.4f}% (CPU plain path "
        f"{ft_cpu['improvement_pct']:.4f}%) "
        f"({time.perf_counter() - t1:.1f} s)")
    if not ft["improvement_pct"] > 0:
        fails.append("fault_trace: aware did not beat blind")
    port = ctx["chaos_port_launches"]
    log(f"[chaos] frontier calls {calls}, {port}, "
        f"{time.perf_counter() - t0:.1f} s")
    if port["compose_grads"] <= 0:
        fails.append(f"the workflow chaos run never launched the "
                     f"composition's kernel: {port}")
    ctx["chaos"] = {**out, "fault_trace": {k: ft[k] for k in (
        "ticks", "channels", "mean_fail_p", "makespan", "improvement_pct")},
        "fault_trace_cpu_improvement_pct": ft_cpu["improvement_pct"],
        "launches": calls, "port_launches": port}
    if fails:
        raise AssertionError(f"chaos phase failed: {fails}")


# the group phase: the fleet, its join cost and scalarization, the PGD
# budget of select_channels, and the exhaustive oracle's fleet size
GROUP_N, GROUP_JOIN, GROUP_LAM, GROUP_STEPS = 64, 0.5, 0.02, 120
GROUP_ORACLE_N, GROUP_ORACLE_STEPS = 6, 80
# the forward kernel at K = 1 (a one-channel subset): rows and grid points
K1_ROWS, K1_T = (1, 8), 2048


def _k1_case(fam, F, seed, device):
    """F rows of one channel (shares from 1/F to 1) with the family's
    extra, as float32 tensors on ``device``."""
    import numpy as np
    import torch
    from repro_torch.core.distributions import extra_rows
    rng = np.random.default_rng(seed)
    W = np.linspace(1.0 / F, 1.0, F)[:, None]
    mus = rng.uniform(10.0, 40.0, (1,))
    sgs = mus * rng.uniform(0.02, 0.3, (1,))
    if fam == "drift":
        ex = rng.uniform(0.1, 0.8, (1, 1))
    elif fam == "defective":
        ex = np.array([[rng.uniform(0.02, 0.3)], [1.0]])
    elif fam == "empirical":
        ex = np.concatenate([rng.dirichlet(np.ones(3))[:, None],
                             mus[None] * rng.uniform(0.7, 1.3, (3, 1)),
                             sgs[None] * rng.uniform(0.3, 1.0, (3, 1))])
    else:
        ex = np.zeros((extra_rows(fam), 1))
    return tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                 for a in (W, mus, sgs, ex))


def _group_fleet(dist):
    """(mus, sigmas, family) of the 64-channel heterogeneous fleet
    (``ClusterSim.heterogeneous(64, seed=0, dist=dist)``; the defective
    fleet with its own failure probabilities)."""
    import numpy as np
    from repro_torch.core import Defective
    from repro_torch.sim import ClusterSim
    sim = ClusterSim.heterogeneous(GROUP_N, seed=0, dist=dist)
    mus, sgs = sim.true_params
    if dist == "defective":
        return mus, sgs, Defective(p=np.asarray(
            [c.fail_p for c in sim.channels], np.float32))
    return mus, sgs, "normal"


def _same_choice(tag, card, cpu, fails):
    same = (card.indices.tolist() == cpu.indices.tolist()
            and abs(card.objective - cpu.objective)
            <= 1e-4 * abs(cpu.objective))
    log(f"[group] {tag}: card K={len(card.indices)} "
        f"{card.indices.tolist()} objective {card.objective:.6f}; cpu plain "
        f"K={len(cpu.indices)} objective {cpu.objective:.6f} "
        + ("same" if same else "DIFFERENT"))
    if not same:
        fails.append(tag)


# the largest call (F * K * T grid points) a path recorder keeps: the fleet
# ticks of ``cluster`` (F=4096, K=1024, T=256) hold themselves against the
# plain forward and autograd inside ``bench.cluster_scale``
RECORD_MAX_POINTS = 1 << 24


class _LaunchRecorder:
    """While active, keeps a copy of the inputs of the first frontier
    kernel call of each (mode, family, F, K, T, per-row statistics) that a
    path makes, up to RECORD_MAX_POINTS grid points a call, so that
    ``_hold_recorded`` can hold the kernels at the path's own shapes once
    the path's launch counts are read. It patches
    ``kernels.frontier_grid`` (``ops`` calls through the module) and
    restores it on exit; the calls themselves and their counts are
    unchanged."""

    def __init__(self):
        self.calls = {}

    def _keep(self, mode, W, mus, sigmas, extra, kw):
        F, K = W.shape
        T = kw.get("num_t", 1024)
        key = (mode, kw.get("dist_id", "normal"), F, K, T, mus.dim() == 2)
        if key not in self.calls and F * K * T <= RECORD_MAX_POINTS:
            self.calls[key] = (tuple(x.detach().clone()
                                     for x in (W, mus, sigmas, extra)),
                               dict(kw))

    def __enter__(self):
        from repro_torch.kernels import frontier_grid as fg
        self._orig = fwd, grad = fg.frontier_grid, fg.frontier_grid_with_grads

        def fwd_rec(W, mus, sigmas, extra, **kw):
            self._keep("fwd", W, mus, sigmas, extra, kw)
            return fwd(W, mus, sigmas, extra, **kw)

        def grad_rec(W, mus, sigmas, extra, **kw):
            self._keep("pgrad" if kw.get("param_grads") else "grad",
                       W, mus, sigmas, extra, kw)
            return grad(W, mus, sigmas, extra, **kw)

        fg.frontier_grid, fg.frontier_grid_with_grads = fwd_rec, grad_rec
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import frontier_grid as fg
        fg.frontier_grid, fg.frontier_grid_with_grads = self._orig


def _hold_recorded(phase, rec, fails):
    """Each call a ``_LaunchRecorder`` kept, again on its copied inputs:
    the kernel twice (the bits must repeat) against its plain version on
    the card (``ops.plain_moments``) at the frontier tolerances. Logs one
    line per (mode, family) and every failing shape; returns one row per
    shape."""
    import torch
    from repro_torch.kernels import frontier_grid as fg, ops
    rows = []
    for key in sorted(rec.calls):
        mode, fam, F, K, T, per_row = key
        (W, mus, sgs, ex), kw = rec.calls[key]
        kern = (fg.frontier_grid if mode == "fwd"
                else fg.frontier_grid_with_grads)
        got = kern(W, mus, sgs, ex, **kw)
        again = kern(W, mus, sgs, ex, **kw)
        want = ops.plain_moments(W, mus, sgs, ex, num_t=T,
                                 z=kw.get("z", 10.0), dist_id=fam, mode=mode)
        errs, rel, ok = _compare(got, want)
        ok &= all(torch.equal(a, b) for a, b in zip(got, again))
        rows.append({"mode": mode, "family": fam, "F": F, "K": K, "T": T,
                     "per_row": per_row, "max_abs_err": errs,
                     "adj_rel_l2": rel, "ok": ok})
        if not ok:
            tag = f"{mode} {fam} F={F} K={K} T={T}"
            _report(phase, "path shape " + tag, errs, rel, ok)
            fails.append(tag)
    groups = {}
    for r in rows:
        groups.setdefault((r["mode"], r["family"]), []).append(r)
    for (mode, fam), rs in sorted(groups.items()):
        ks = sorted({r["K"] for r in rs})
        fs = sorted({r["F"] for r in rs})
        ts = sorted({r["T"] for r in rs})
        worst = [max(r["max_abs_err"][i] for r in rs)
                 for i in range(len(rs[0]["max_abs_err"]))]
        rel = [max(r["adj_rel_l2"][i] for r in rs)
               for i in range(len(rs[0]["adj_rel_l2"]))]
        n_ok = sum(r["ok"] for r in rs)
        _report(phase, f"path shapes {mode:4s} {fam:9s} {len(rs)} "
                f"(K {ks[0]}-{ks[-1]}, F {fs}, T {ts}), {n_ok} ok; worst",
                worst, rel, n_ok == len(rs))
    if not rows:
        fails.append("no frontier call recorded on the path")
    return rows


def phase_group(ctx):
    """The channel-count selection on the card: the forward (and adjoint)
    kernel at K = 1 for every family against its plain version (off the
    path: a one-channel subset takes ``predict_moments``' plain
    quadrature), then the main path, ``select_channels`` over the
    64-channel heterogeneous fleet under the normal and the defective
    family (join cost 0.5) and the exhaustive oracle against greedy on 6
    channels, each choice held against the CPU plain path's, and the
    kernels held against their plain versions at every shape the path
    launched (``_hold_recorded``). Every prefix's objective is at least
    join_cost * K, so the CPU's greedy run stops at the K where that floor
    passes the card's best objective: a longer prefix cannot win."""
    import torch
    from repro_torch.core import select_channels, select_channels_exhaustive
    from repro_torch.core.distributions import FAMILIES
    from repro_torch.kernels import frontier_grid as fg, ref
    dev = torch.device("cuda")
    fails, k1 = [], []
    for i, fam in enumerate(FAMILIES):
        for F in K1_ROWS:
            W, mus, sgs, ex = _k1_case(fam, F, 400 + i, dev)
            for mode in ("fwd", "grad"):
                if mode == "fwd":
                    def kern():
                        return fg.frontier_grid(W, mus, sgs, ex, num_t=K1_T,
                                                dist_id=fam)
                    want = ref.frontier_grid_ref(W, mus, sgs, num_t=K1_T,
                                                 dist_id=fam, extra=ex)
                else:
                    def kern():
                        return fg.frontier_grid_with_grads(
                            W, mus, sgs, ex, num_t=K1_T, dist_id=fam)
                    want = ref.frontier_grid_with_grads_ref(
                        W, mus, sgs, num_t=K1_T, dist_id=fam, extra=ex)
                got, again = kern(), kern()
                torch.cuda.synchronize()
                errs, rel, ok = _compare(got, want)
                ok &= all(torch.equal(a, b) for a, b in zip(got, again))
                tag = f"K=1 (off the path) {fam:9s} F={F} T={K1_T} {mode:4s}"
                _report("group", tag, errs, rel, ok)
                k1.append({"family": fam, "F": F, "mode": mode,
                           "max_abs_err": max(errs), "ok": ok,
                           "on_path": False})
                if not ok:
                    fails.append(tag)

    torch.cuda.synchronize()
    fg.reset_launches()
    runs, card = {}, {}
    with _LaunchRecorder() as rec:
        for dist in ("normal", "defective"):
            mus, sgs, fam = _group_fleet(dist)
            t0 = time.perf_counter()
            card[dist] = select_channels(mus, sgs, lam=GROUP_LAM,
                                         join_cost=GROUP_JOIN,
                                         pgd_steps=GROUP_STEPS, family=fam,
                                         device="cuda")
            # a prefix of K >= 2 is one optimize_weights solve
            runs[dist] = {"wall_s": time.perf_counter() - t0,
                          "solves": GROUP_N - 1}
        mus6, sgs6, _ = _group_fleet("normal")
        mus6, sgs6 = mus6[:GROUP_ORACLE_N], sgs6[:GROUP_ORACLE_N]
        t0 = time.perf_counter()
        greedy6 = select_channels(mus6, sgs6, lam=GROUP_LAM,
                                  join_cost=GROUP_JOIN,
                                  pgd_steps=GROUP_ORACLE_STEPS, device="cuda")
        oracle6 = select_channels_exhaustive(mus6, sgs6, lam=GROUP_LAM,
                                             join_cost=GROUP_JOIN,
                                             pgd_steps=GROUP_ORACLE_STEPS,
                                             device="cuda")
        oracle_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    calls = dict(fg.LAUNCHES)
    ctx["group_launches"] = calls

    out = {"k1": k1, "launches": calls,
           "path_shapes": _hold_recorded("group", rec, fails)}
    for dist in ("normal", "defective"):
        mus, sgs, fam = _group_fleet(dist)
        ch = card[dist]
        max_k = min(GROUP_N, int(ch.objective * (1 + 1e-3) / GROUP_JOIN) + 1)
        t0 = time.perf_counter()
        cpu = select_channels(mus, sgs, lam=GROUP_LAM, join_cost=GROUP_JOIN,
                              max_k=max_k, pgd_steps=GROUP_STEPS, family=fam,
                              device="cpu")
        _same_choice(f"{dist} fleet of {GROUP_N}", ch, cpu, fails)
        out[dist] = {**runs[dist], "k": len(ch.indices),
                     "indices": ch.indices.tolist(),
                     "objective": ch.objective, "mu": ch.decision.mu,
                     "var": ch.decision.var, "cpu_objective": cpu.objective,
                     "cpu_max_k": max_k,
                     "cpu_wall_s": time.perf_counter() - t0}
        log(f"[group] {dist}: {runs[dist]['solves']} solves in "
            f"{runs[dist]['wall_s']:.2f} s on the card "
            f"({1e3 * runs[dist]['wall_s'] / runs[dist]['solves']:.1f} ms a "
            f"solve); the CPU's prefixes up to K={max_k}")
    cpu6 = select_channels_exhaustive(mus6, sgs6, lam=GROUP_LAM,
                                      join_cost=GROUP_JOIN,
                                      pgd_steps=GROUP_ORACLE_STEPS,
                                      device="cpu")
    _same_choice(f"exhaustive on {GROUP_ORACLE_N}", oracle6, cpu6, fails)
    within = greedy6.objective <= oracle6.objective * 1.1
    log(f"[group] greedy on {GROUP_ORACLE_N}: objective "
        f"{greedy6.objective:.6f} against the oracle's "
        f"{oracle6.objective:.6f} ({2 ** GROUP_ORACLE_N - 1} solves; both "
        f"{oracle_s:.2f} s) " + ("ok" if within else "FAIL"))
    if not within:
        fails.append("greedy beyond 1.1x the oracle")
    out["oracle6"] = {"greedy": greedy6.objective,
                      "exhaustive": oracle6.objective,
                      "indices": oracle6.indices.tolist(), "wall_s": oracle_s}
    log(f"[group] frontier calls {calls}")
    ctx["group"] = out
    if calls["grad"] <= 0 or calls["fwd"] <= 0:
        fails.append(f"a frontier kernel never launched: {calls}")
    if fails:
        raise AssertionError(f"group phase failed: {fails}")


def phase_straggler(ctx):
    """``bench.elastic_fleet`` on the card in quarantine and drift modes:
    the straggler flagged (and quarantined, or priced as drift), the failed
    channel removed, both joins admitted, every split a simplex (checked
    inside the run); join statistics before and after the chaos, tick
    times."""
    import torch
    from repro_torch.bench import elastic_fleet as ef
    from repro_torch.kernels import frontier_grid as fg
    fails, out = [], {}
    torch.cuda.synchronize()
    fg.reset_launches()
    rec = _LaunchRecorder()
    for mode in ("quarantine", "drift"):
        t0 = time.perf_counter()
        with rec:
            r = ef.run(device="cuda", mitigation=mode)
        r["wall_s"] = time.perf_counter() - t0
        out[mode] = r
        caught = (ef.SLOW_IDX in r["quarantined_ever"] if mode == "quarantine"
                  else r["drift_rho_max"].get(ef.SLOW_IDX, 0.0) > 0.0)
        ok = (ef.SLOW_IDX in r["flagged_after_slow"] and caught
              and r["fleet_at"] == {"start": ef.N, "after_fail": ef.N - 1,
                                    "after_join": ef.N - 1 + ef.JOINS,
                                    "end": ef.N - 1 + ef.JOINS})
        b, a, tk = r["before"], r["after"], r["tick_ms"]
        log(f"[straggler] {mode:10s} flagged {r['flagged_after_slow']} "
            f"quarantined {r['quarantined_ever']} drift rho max "
            f"{ {i: round(v, 4) for i, v in r['drift_rho_max'].items()} } "
            f"fleet {r['fleet_at']}; join before mean {b['mean']:.4f} var "
            f"{b['var']:.5f} p99 {b['p99']:.4f}, after mean {a['mean']:.4f} "
            f"var {a['var']:.5f} p99 {a['p99']:.4f}; tick mean "
            f"{tk['mean']:.2f} ms p50 {tk['p50']:.2f} max {tk['max']:.1f} "
            f"({r['wall_s']:.1f} s) " + ("ok" if ok else "FAIL"))
        if not ok:
            fails.append(mode)
    torch.cuda.synchronize()
    calls = dict(fg.LAUNCHES)
    ctx["straggler_launches"] = calls
    ctx["straggler"] = {**out, "launches": calls,
                        "path_shapes": _hold_recorded("straggler", rec,
                                                      fails)}
    log(f"[straggler] frontier calls {calls}")
    if calls["grad"] <= 0 or calls["fwd"] <= 0:
        fails.append(f"a frontier kernel never launched: {calls}")
    if fails:
        raise AssertionError(f"straggler phase failed: {fails}")


def phase_paper(ctx):
    """The paper's figures on the card with their own assertions (Figs 1,
    2, 3-4 and 5-6), held against the CPU plain path: Figs 1 and 2 mu 1e-4
    and var 1e-3 relative with the same efficient mask; the simulated
    columns of Figs 3-6 bit for bit, Fig 3-4's joined MSE 1e-4 relative;
    then the 201-row Fig 1 call's time (event pair, device, host) beside
    its bound and its plain version's."""
    import numpy as np
    import torch
    from repro_torch.bench import (common, fig1_theory, fig2_frontier,
                                   fig34_convex_opt, fig56_file_transfer)
    from repro_torch.core.distributions import extra_rows
    from repro_torch.kernels import frontier_grid as fg, ops
    common.RESULTS_DIR = os.path.join(OUT_DIR, "paper")
    figs = (("fig1", fig1_theory), ("fig2", fig2_frontier),
            ("fig34", fig34_convex_opt), ("fig56", fig56_file_transfer))
    fails, card, walls = [], {}, {}
    torch.cuda.synchronize()
    fg.reset_launches()
    for name, mod in figs:
        t0 = time.perf_counter()
        card[name] = mod.run(device="cuda")
        walls[name] = time.perf_counter() - t0
    torch.cuda.synchronize()
    calls = dict(fg.LAUNCHES)
    ctx["paper_launches"] = calls
    cpu = {name: mod.run(device="cpu") for name, mod in figs}

    out = {"launches": calls, "wall_s": walls}
    for name in ("fig1", "fig2"):
        a, b = card[name]["table"], cpu[name]["table"]
        mu_rel = float(np.max(np.abs(a.mu - b.mu) / np.abs(b.mu)))
        var_rel = float(np.max(np.abs(a.var - b.var) / np.abs(b.var)))
        same = bool(np.array_equal(a.efficient, b.efficient))
        ok = mu_rel <= 1e-4 and var_rel <= 1e-3 and same
        i_mu, i_var = int(np.argmin(a.mu)), int(np.argmin(a.var))
        out[name] = {"f_mu": float(a.f[i_mu]), "mu_min": float(a.mu[i_mu]),
                     "f_var": float(a.f[i_var]),
                     "var_min": float(a.var[i_var]),
                     "n_efficient": int(a.efficient.sum()),
                     "mu_max_rel": mu_rel, "var_max_rel": var_rel}
        log(f"[paper] {name}: {len(a.f)} rows, f*mu {a.f[i_mu]:.3f} mu_min "
            f"{a.mu[i_mu]:.6f}, f*var {a.f[i_var]:.3f} var_min "
            f"{a.var[i_var]:.6f}, {int(a.efficient.sum())} efficient; "
            f"against the CPU plain path mu {mu_rel:.1e} var {var_rel:.1e} "
            f"relative, mask " + ("same" if same else "DIFFERENT")
            + ("  ok" if ok else "  FAIL"))
        if not ok:
            fails.append(name)
    rows_a, rows_b = card["fig34"]["rows"], cpu["fig34"]["rows"]
    sim_same = all(x[1] == y[1] and x[2] == y[2]
                   for x, y in zip(rows_a, rows_b))
    mse_rel = max(abs(x[3] - y[3]) / y[3] for x, y in zip(rows_a, rows_b))
    ok = sim_same and mse_rel <= 1e-4
    out["fig34"] = {"mu_min_f": card["fig34"]["mu_min_f"],
                    "var_min_f": card["fig34"]["var_min_f"],
                    "joined_mse": [float(x[3]) for x in rows_a],
                    "mse_max_rel": mse_rel,
                    "halfsolve_us": card["fig34"]["halfsolve_us"]}
    log(f"[paper] fig34: mu/var columns "
        + ("bitwise the CPU's" if sim_same else "DIFFERENT")
        + f", joined MSE {min(x[3] for x in rows_a):.6f}-"
        f"{max(x[3] for x in rows_a):.6f} (max rel {mse_rel:.1e}); mu min "
        f"at f={card['fig34']['mu_min_f']}, var min at "
        f"f={card['fig34']['var_min_f']}; a 50-step half solve "
        f"{card['fig34']['halfsolve_us']:.0f} us" + ("  ok" if ok else
                                                     "  FAIL"))
    if not ok:
        fails.append("fig34")
    a, b = card["fig56"], cpu["fig56"]
    emp_same = (np.array_equal(a["hist_f05"], b["hist_f05"])
                and all(x[:3] == y[:3] and x[5] == y[5]
                        for x, y in zip(a["rows"], b["rows"])))
    th_rel = max(abs(x[3] - y[3]) / y[3] for x, y in zip(a["rows"], b["rows"])
                 if y[3] > 0)
    ok = emp_same and th_rel <= 1e-4
    out["fig56"] = {k: a[k] for k in ("skew", "kurt", "max_rel_mu_err")}
    out["fig56"]["theory_mu_max_rel"] = th_rel
    log(f"[paper] fig56: skew {a['skew']:.6f} kurt {a['kurt']:.6f}, "
        f"max rel mu err {a['max_rel_mu_err']:.6f}; empirical columns "
        + ("bitwise the CPU's" if emp_same else "DIFFERENT")
        + f", theory mu {th_rel:.1e}" + ("  ok" if ok else "  FAIL"))
    if not ok:
        fails.append("fig56")

    call = fig1_theory.curve_call("cuda")
    W, mus, sgs = fig1_theory.curve_inputs("cuda")
    _, ex = ops._resolve_family("normal", 2, torch.device("cuda"))
    ms, dev_ms = _time_cuda(call, reps=9), _device_ms(call)
    host_ms = _host_ms(call, reps=50)
    plain_ms = _time_cuda(lambda: ops.plain_moments(
        W, mus, sgs, ex, num_t=fig1_theory.NUM_T, mode="fwd"), reps=5)
    bound_ms, by = _bound("fwd", fig1_theory.NUM_F, 2, fig1_theory.NUM_T,
                          extra_rows("normal"), False)
    out["fig1_curve"] = {"F": fig1_theory.NUM_F, "K": 2,
                         "T": fig1_theory.NUM_T, "ms": ms,
                         "device_ms": dev_ms, "host_ms": host_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": by,
                         "blocks": _call_blocks("fwd", fig1_theory.NUM_F, 2,
                                                fig1_theory.NUM_T, "normal")}
    log(f"[paper] fig1 curve F={fig1_theory.NUM_F} K=2 T={fig1_theory.NUM_T}:"
        f" {ms:.4f} ms (device "
        + (f"{dev_ms:.4f}" if dev_ms is not None else "not measured")
        + f", host {host_ms:.4f} ms per call), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.5f} ms ({by}); frontier calls {calls}; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    ctx["paper"] = out
    if calls["fwd"] <= 0:
        fails.append(f"the forward kernel never launched: {calls}")
    if fails:
        raise AssertionError(f"paper phase failed: {fails}")


def _edge_window(N, K, seed):
    """(rates, works, mask) (N, K) with every edge case of the scoring
    pass: channel 0 below min_obs, 1 all masked, 2 with nonpositive rates,
    3 of zero variance, 4 with a singular drift regression, 5 with a
    negative slope, the last drifting (tests/test_torch_family_score.py)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0.5, 2.0, K)
    works = rng.uniform(0.5 / K, 2.0 / K, (N, K))
    rates = rng.lognormal(np.log(mu), 0.3, (N, K))
    mask = (rng.random((N, K)) < 0.9).astype(np.float64)
    rates[:, K - 1] = mu[K - 1] * (1.0 + works[:, K - 1] * K) \
        + rng.normal(0.0, 0.01, N)
    mask[:, 0] = 0.0
    mask[:3, 0] = 1.0
    mask[:, 1] = 0.0
    rates[2, 2], rates[5, 2] = -0.5, 0.0
    rates[:, 3] = 1.25
    works[:, 4] = 0.01
    rates[:, 5] = 3.0 - 50.0 * works[:, 5]
    return rates, works, mask


def _family_windows():
    """(tag, (rates, works, mask)) of family_score's card checks: the fleet
    tick's own history, then windows with every edge case."""
    from repro_torch.bench import cluster_scale as cs
    _, mus, _ = cs._tick_problem(cs.TICK_K, 1, device="cpu")
    yield "tick K=1024 N=96", cs.auto_history(mus.numpy(), 96)
    # the plan's edges besides: the longest window (one channel a block)
    # and a ragged last block
    for N, K in ((12, 8), (96, 64), (128, 256), (4096, 9), (96, 1025)):
        yield f"edges K={K} N={N}", _edge_window(N, K, seed=N + K)


def _family_bound(N, K):
    """(bound_ms, bound_by) of one family_score call: the window read once
    and the output written once; the EM's and the float64 pass's
    operations."""
    nbytes = 8 * (3 * N * K + 8 + 10 * K)
    em = 16 * 3 * N * K
    special = em * FAMILY_EM["special"] + N * K * FAMILY_ONCE["special"]
    t_ops = max(special / SFU_OPS_PER_S,
                em * FAMILY_EM["fp32"] / FP32_OPS_PER_S
                + N * K * FAMILY_ONCE["fp64"] / FP64_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * t_bytes, "bytes") if t_bytes > t_ops else \
        (1e3 * t_ops, "operations")


def _family_chain_ms(N):
    """family_score's dependency chain a warp (CHAIN_CYCLES), ms: the
    staging copy, three float64 ordered sums of N, 32 bisection rounds, 16
    EM iterations (a lane's E-step samples, the M-step's N adds, the
    update), the sort and the writes."""
    c = CHAIN_CYCLES
    per_lane = -(-N // 32)
    cycles = (c["stage"] + 3 * N * c["add64"] + 32 * c["bisect"]
              + 16 * (per_lane * c["e_sample"] + N * c["add32"]
                      + c["em_update"]) + c["final"])
    return 1e3 * cycles / CARD["sm_hz"]


def _family_hold(tag, window, fails):
    """``score_families`` on the card (the family_score kernel) against the
    numpy on the host, bit for bit, twice (the bits repeat), with the
    winner's relative BIC margin, the kernel's time (its two launches
    apart), the numpy's host time, the bound, the chain estimate and the
    launch plan."""
    import numpy as np
    import torch
    from repro_torch.bench import cluster_scale as cs
    from repro_torch.core import bayes
    from repro_torch.kernels import family_score as fs
    rates, works, mask = window
    N, K = rates.shape
    hist = [torch.as_tensor(a, dtype=torch.float64, device="cuda")
            for a in window]
    want = bayes.score_families(rates, works, mask)
    got = bayes.score_families(*hist)
    again = bayes.score_families(*hist)
    rel = {f: abs(got.bics[f] - b) / abs(b) for f, b in want.bics.items()}
    nz = want.rho != 0
    rho_rel = float(np.max(np.abs(got.rho - want.rho)[nz]
                           / np.abs(want.rho[nz]), initial=0.0))
    gmm_rel = max(float(np.max(np.abs(g.astype(np.float64) - w)
                               / np.maximum(np.abs(w), 1e-30)))
                  for g, w in zip(got.gmm, want.gmm))
    max_abs = max([abs(got.bics[f] - b) for f, b in want.bics.items()]
                  + [float(np.max(np.abs(got.rho - want.rho)))]
                  + [float(np.max(np.abs(g - w)))
                     for g, w in zip(got.gmm, want.gmm)])

    def same(x, y):
        return (x.winner == y.winner and x.n_channels == y.n_channels
                and x.bics == y.bics and np.array_equal(x.rho, y.rho)
                and all(a.dtype == b.dtype and np.array_equal(a, b)
                        for a, b in zip(x.gmm, y.gmm)))

    ok = same(got, want) and same(again, got)
    margin = cs.bic_margin(want.bics)

    def kern():
        return fs.family_score(*hist, min_obs=8, max_rho=8.0)

    ms = _time_cuda(kern, reps=7)
    by_name = _device_window(kern, reps=10)
    dev_ms = chan_ms = None
    if by_name is not None:
        dev_ms = sum(by_name.values()) / 1e3 / 10
        chan_ms = sum(us for k, us in by_name.items()
                      if "family_channel" in k) / 1e3 / 10
    host_ms = _host_ms(kern, reps=20)
    t_plain = []
    for _ in range(5):
        t1 = time.perf_counter()
        bayes.score_families(rates, works, mask)
        t_plain.append(1e3 * (time.perf_counter() - t1))
    plain_ms = sorted(t_plain)[2]
    bound_ms, by = _family_bound(N, K)
    chain_ms = _family_chain_ms(N)
    cpb, blocks, smem = fs.launch_plan(N, K)

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f}"

    log(f"[cluster] family_score {tag}: winner {got.winner} (numpy "
        f"{want.winner}), channels {got.n_channels}/{want.n_channels}, BIC "
        f"rel " + " ".join(f"{f} {r:.1e}" for f, r in rel.items())
        + f", rho rel {rho_rel:.1e}, mixture rel {gmm_rel:.1e}; margin "
        f"{margin:.3e}" + ("  (bitwise, repeats)" if ok else "  FAIL")
        + f"; kernel {ms:.4f} ms (device {fmt(dev_ms)}: channels "
        f"{fmt(chan_ms)}, reduce "
        f"{fmt(None if dev_ms is None else dev_ms - chan_ms)}; host "
        f"{host_ms:.4f}) numpy (host) {plain_ms:.3f} ms bound "
        f"{bound_ms:.3e} ms ({by}) chain estimate {chain_ms:.4f} ms; {cpb} "
        f"channels "
        f"a block, {blocks} blocks, {smem} B shared memory a block")
    if not ok:
        fails.append(f"family_score {tag}")
    return {"tag": tag, "N": N, "K": K, "winner": got.winner,
            "bic_rel": rel, "rho_rel": rho_rel, "gmm_rel": gmm_rel,
            "bic_margin": margin, "max_abs_err": max_abs, "ok": ok,
            "ms": ms, "device_ms": dev_ms, "channel_device_ms": chan_ms,
            "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "plan": [cpb, blocks, smem]}


def phase_cluster(ctx):
    """``bench.cluster_scale.run(smoke=False)`` on the card: the policy
    comparison at 64 / 256 / 1024 channels with the hotspot (frontier beats
    equal on mean and p99, asserted inside), and the fleet ticks at K=1024,
    F=4096, T=256 against their plain and autograd foils (gradient parity
    asserted inside), then family_score against the numpy and the
    benchmark's gate (``check_gates``: the auto-family tick at most 1.2x the
    fixed one); the benchmark's sweep section runs in phase ``sweep``, so no
    launch here takes a swept split."""
    import torch
    from repro_torch.bench import cluster_scale, common
    from repro_torch.kernels import frontier_grid as fg
    common.RESULTS_DIR = os.path.join(OUT_DIR, "cluster_scale")
    torch.cuda.synchronize()
    fg.reset_launches()
    _reset_port()
    t0 = time.perf_counter()
    with _LaunchRecorder() as rec:
        # its sweep section runs in the sweep phase, into a file of its own
        res = cluster_scale.run(smoke=False, device="cuda", sweep=False)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    calls = dict(fg.LAUNCHES)
    port = _port_launches()
    ctx["cluster_launches"] = calls
    ctx["cluster_port_launches"] = port
    fails = []
    shapes = _hold_recorded("cluster", rec, fails)
    with open(os.path.join(OUT_DIR, "cluster_scale.json"), "w") as fh:
        json.dump({"bench": "cluster_scale", "smoke": False, **res}, fh,
                  indent=1, sort_keys=True)
    for key, (mu, var, p99) in sorted(res["policies"].items()):
        log(f"[cluster] {key:22s} join mean {mu:.4f} var {var:.5f} p99 "
            f"{p99:.4f}")
    for e in res["entries"]:
        log(f"[cluster] {e['name']:34s} {e['family']:9s} median "
            f"{e['median_us'] / 1e3:9.3f} ms p90 {e['p90_us'] / 1e3:9.3f} ms")
    log(f"[cluster] pgd_speedup_vs_autodiff {res['pgd_speedup_vs_autodiff']:.3f}"
        f" (grad rel L2 {res['grad_rel_l2']:.1e}); auto_family_tick_overhead "
        f"{res['auto_family_tick_overhead']:.3f} (family "
        f"{res['auto_family']}, relative BIC margin over the runner-up "
        f"{res['auto_bic_margin']:.3e}); frontier calls {calls}, {port}; "
        f"{wall:.1f} s")
    if calls["grad"] <= 0 or calls["fwd"] <= 0:
        fails.append(f"a frontier kernel never launched: {calls}")
    if port["family_score"] <= 0:
        fails.append(f"the auto-family tick never scored on the card: {port}")
    families = [_family_hold(tag, win, fails)
                for tag, win in _family_windows()]
    ctx.setdefault("port_kernels", {})["family_score"] = {
        **families[0], "max_abs_err": max(f["max_abs_err"]
                                          for f in families)}
    try:
        cluster_scale.check_gates(res)
        log(f"[cluster] check_gates: auto_family_tick_overhead "
            f"{res['auto_family_tick_overhead']:.3f} <= 1.2")
    except AssertionError as e:
        log(f"[cluster] check_gates FAILED: {e}")
        fails.append(f"cluster_scale.check_gates: {e}")
    ctx["cluster"] = {k: v for k, v in res.items() if k != "skipped"}
    ctx["cluster"].update(wall_s=wall, path_shapes=shapes,
                          port_launches=port, family_checks=families)
    if fails:
        raise AssertionError(f"cluster phase failed: {fails}")


# ------------------------------------------------------------------- tracing
# records the trace phase's tracer keeps: the full serve_trace traced makes
# a few hundred thousand (a sim step per executed stage of 320 live)
TRACE_CAPACITY = 1 << 21
# the serving engine's traced solve over its untraced one, percent (the JAX
# package's zero-perturbation bound), held on the median of its readings
TRACE_OVERHEAD_MAX_PCT = 5.0
TRACE_OVERHEAD_READINGS = 5
# the engine probe's per-tick fields that tracing must leave bitwise alone
ENGINE_TICK_KEYS = ("tick", "admitted", "retired", "rows", "launches",
                    "groups", "calls", "syncs")
# the sanitizer: host reads a PGD solve may add, and the step a planted
# NaN gradient must be named at
SANITIZE_MAX_READS = 2
SANITIZE_NAN_STEP = 17


def _syncs_of(fn):
    """``(fn(), device synchronizations during it)``, by torch's sync debug
    mode."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


@contextmanager
def _counting_solves():
    """Counts the balancer's PGD solves (``sched.balancer.optimize_weights``)
    into the dict it yields."""
    from repro_torch.sched import balancer
    orig, n = balancer.optimize_weights, {"solves": 0}

    def counted(*a, **kw):
        n["solves"] += 1
        return orig(*a, **kw)

    balancer.optimize_weights = counted
    try:
        yield n
    finally:
        balancer.optimize_weights = orig


def phase_trace(ctx):
    """The port's tracing and sanitizer on the card (see the module
    docstring): the full serve_trace traced against the engine phase's
    untraced run, chaos traced, the K=1024 loop traced, the dag_scale joint
    solve's phase spans, and the sanitizer switched on in-process."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.analysis import sanitize as san
    from repro_torch.bench import dag_scale, serve_trace as bench
    from repro_torch.core import partitioner
    from repro_torch.kernels import frontier_grid as fg, ops
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import names as obs_names
    from repro_torch.obs import trace as obs
    from repro_torch.sim import ClusterSim
    from repro_torch.sim.chaos import (run_chaos_trace,
                                       run_workflow_chaos_trace)
    from repro_torch.workflow import solve_dag
    fails, out = [], {}
    total = {m: 0 for m in fg.LAUNCHES}
    port = {m: 0 for m in _port_launches()}

    def counted(fn):
        """``fn()`` as a path run: its launches, counted from zero, join
        the phase's totals."""
        torch.cuda.synchronize()
        fg.reset_launches()
        _reset_port()
        r = fn()
        torch.cuda.synchronize()
        for m in total:
            total[m] += fg.LAUNCHES[m]
        got = _port_launches()
        for m in port:
            port[m] += got[m]
        return r

    def spans_by_mode(recs, within=None):
        """kernel.launch spans by mode; with ``within`` (spans) only those
        that start inside one of them."""
        import bisect
        if within is not None:
            starts = [w["ts_us"] for w in within]
            ends = [w["ts_us"] + w["dur_us"] for w in within]
        n = {m: 0 for m in fg.LAUNCHES}
        for r in recs:
            if r["name"] != obs_names.SPAN_KERNEL_LAUNCH:
                continue
            if within is not None:
                i = bisect.bisect_right(starts, r["ts_us"]) - 1
                if i < 0 or r["ts_us"] > ends[i]:
                    continue
            n[r["attrs"]["mode"]] += 1
        return n

    tracer = obs.TRACER
    obs.TRACER = obs.Tracer(capacity=TRACE_CAPACITY)
    env = os.environ.pop(san.ENV_VAR, None)
    try:
        # 1. the serving engine: the full serve_trace traced
        plain = ctx.get("engine_ticks")
        if plain is None:
            with _EngineProbe() as p:
                bench.run(smoke=False, device="cuda")
            plain = p.ticks
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
            obs.set_enabled(True)
            mark = obs.mark()
            t0 = time.perf_counter()

            held = {}

            def engine():
                with _EngineProbe() as p:
                    return bench.run(smoke=False, device="cuda", out_dir=d,
                                     on_tick=lambda e, t, o: held.update(
                                         eng=e)), p
            res, probe = counted(engine)
            run_s = time.perf_counter() - t0
            # the overhead again on the same rows: its spread between
            # readings, and the median is what the bound holds
            eng = held["eng"]
            overheads = [res["trace"]["overhead_pct"]] + [
                bench._trace_overhead_pct(eng.last_rows, eng.kmax,
                                          bench.NUM_T, "cuda")[0]
                for _ in range(TRACE_OVERHEAD_READINGS - 1)]
            overhead = float(np.median(overheads))
            obs.set_enabled(False)
            recs = obs.records(mark)
            sizes = {k: os.path.getsize(res["trace"][k])
                     for k in ("jsonl", "perfetto")}
        tr = res["trace"]
        n_valid = obs_export.validate_records(recs)
        same = (len(plain) == len(probe.ticks) and all(
            all(a[k] == b[k] for k in ENGINE_TICK_KEYS)
            for a, b in zip(plain, probe.ticks)))
        syncs = [t["syncs"] for t in probe.ticks]
        # the ticks' own launches: spans inside each engine.tick span against
        # the launch counters' per-tick deltas (the ratio samples and the
        # overhead measurement launch between ticks, the latter half
        # untraced)
        ticks = sorted((r for r in recs
                        if r["name"] == obs_names.SPAN_ENGINE_TICK),
                       key=lambda r: r["ts_us"])
        spans = spans_by_mode(recs, within=ticks)
        calls = {m: sum(t["calls"][m] for t in probe.ticks)
                 for m in fg.LAUNCHES}
        kinds = obs_export.span_kinds(recs)
        types = obs_export.event_types(recs)
        dropped = obs.dropped()
        log(f"[trace] serve_trace traced: {len(probe.ticks)} ticks in "
            f"{run_s:.1f} s, {len(recs)} records ({n_valid} valid, dropped "
            f"{dropped}; JSONL {sizes['jsonl'] / 1e6:.1f} MB, Perfetto "
            f"{sizes['perfetto'] / 1e6:.1f} MB), span kinds {sorted(kinds)}, "
            f"event types {sorted(types)}")
        log(f"[trace] ticks traced against untraced (admitted, retired "
            f"iids and join latencies, rows, launches, groups, frontier "
            f"calls, device syncs): " + ("bitwise equal" if same else
                                          "DIFFER") + f"; syncs a tick "
            f"mean {np.mean(syncs):.2f} max {max(syncs)}")
        log(f"[trace] kernel.launch spans inside the {len(ticks)} tick spans "
            f"by mode {spans} against the ticks' launch counts {calls} (all "
            f"launch spans {spans_by_mode(recs)}); overhead_pct "
            f"{tr['overhead_pct']:.3f}, over {len(overheads)} readings "
            + ", ".join(f"{o:.3f}" for o in overheads) + f": median "
            f"{overhead:.3f} (bound {TRACE_OVERHEAD_MAX_PCT}; the stacked "
            f"solve of the last tick's {tr['rows']} rows {tr['solve_us']:.1f}"
            f" us untraced, {tr['solve_us_traced']:.1f} us traced)")
        if not same:
            fails.append("engine ticks traced differ from untraced")
        want_kinds = {obs_names.SPAN_ENGINE_TICK, obs_names.SPAN_ENGINE_STAGE,
                      obs_names.SPAN_SOLVER_PGD, obs_names.SPAN_KERNEL_LAUNCH,
                      obs_names.SPAN_SIM_STEP}
        if not want_kinds <= kinds:
            fails.append(f"span kinds missing: {want_kinds - kinds}")
        if not {obs_names.EV_DIRTY, obs_names.EV_SLO_LAM} <= types:
            fails.append(f"event types missing: {types}")
        if dropped == 0 and spans != calls:
            fails.append(f"launch spans {spans} != counters {calls}")
        if not overhead < TRACE_OVERHEAD_MAX_PCT:
            fails.append(f"overhead_pct {overheads}")
        out["engine"] = {"ticks": len(probe.ticks), "run_s": run_s,
                         "records": len(recs), "dropped": dropped,
                         "bitwise": same, "syncs_mean": float(np.mean(syncs)),
                         "spans": spans, "calls": calls,
                         "overhead_pct": overheads,
                         "solve_us": [tr["solve_us"], tr["solve_us_traced"]],
                         "span_kinds": sorted(kinds),
                         "event_types": sorted(types), "bytes": sizes}

        # 2. chaos traced: every kill bitwise, restores at the manifest steps
        obs.set_enabled(True)
        mark = obs.mark()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
            runs = {
                "balancer": counted(lambda: run_chaos_trace(
                    churn=CHAOS_CHURN, seed=0, device="cuda")),
                "defective": counted(lambda: run_chaos_trace(
                    dist="defective", seed=3, device="cuda")),
                "workflow": counted(lambda: run_workflow_chaos_trace(
                    dag_scale.make_dag(2, 3, 32), churn=CHAOS_WF_CHURN,
                    seed=0, device="cuda")),
                "engine": counted(lambda: _engine_chaos(
                    os.path.join(d, "eng")))}
        obs.set_enabled(False)
        recs = obs.records(mark)
        restores = [(r["attrs"]["kind"], r["attrs"]["step"]) for r in recs
                    if r["name"] == obs_names.EV_CKPT_RESTORE]
        want = []
        for name, r in runs.items():
            kind = {"defective": "balancer"}.get(name, name)
            if name == "engine":
                steps = list(range(ENGINE_KILL_EVERY, ENGINE_KILL_TICKS + 1,
                                   ENGINE_KILL_EVERY))
            else:
                steps = [t for t, what, _ in r.events
                         if what == "kill_restore"]
            want += [(kind, t) for t in steps]
        kills = {n: (r["kills"] if isinstance(r, dict) else r.kills)
                 for n, r in runs.items()}
        untraced = {n: ctx.get("chaos", {}).get(n) for n in runs}
        same_summary = all(
            u is None or u == (r if isinstance(r, dict) else r.summary())
            for u, r in zip(untraced.values(), runs.values()))
        log(f"[trace] chaos traced: kills {kills}, every restored decision "
            f"bitwise the survivor's; {len(restores)} ckpt_restore events at "
            f"{restores == want and 'the manifest steps' or restores} "
            f"({obs_export.validate_records(recs)} records, "
            f"{time.perf_counter() - t0:.1f} s); results "
            + ("equal to the chaos phase's" if same_summary else "DIFFER"))
        if restores != want:
            fails.append(f"restore events {restores} != manifest steps "
                         f"{want}")
        if not same_summary:
            fails.append("chaos traced differs from untraced")
        out["chaos"] = {"kills": kills, "restores": restores}

        # 3. the K=1024 closed loop traced
        ws_plain = ctx.get("loop_ws")
        if ws_plain is None:
            ws_plain = _closed_loop("frontier", "cuda")[2]
        obs.set_enabled(True)
        mark = obs.mark()
        _, tick_s, ws = counted(lambda: _closed_loop("frontier", "cuda"))
        obs.set_enabled(False)
        recs = obs.records(mark)
        refresh = [r for r in recs
                   if r["name"] == obs_names.SPAN_SCHED_REFRESH]
        plain_mean = ctx.get("loop", {}).get("frontier", {}).get(
            "tick_mean_s")
        same = np.array_equal(ws, ws_plain)
        log(f"[trace] K=1024 loop traced: {len(refresh)} sched.refresh spans "
            f"({sum(r['attrs']['warm'] for r in refresh)} warm re-solves), "
            f"{len(recs)} records; tick mean traced {1e3 * tick_s.mean():.2f}"
            f" ms, untraced " + (f"{1e3 * plain_mean:.2f} ms" if plain_mean
                                 else "not run") + "; decisions "
            + ("bitwise equal" if same else "DIFFER"))
        if not refresh or not same:
            fails.append("K=1024 loop traced")
        out["loop"] = {"refreshes": len(refresh),
                       "tick_mean_ms": 1e3 * float(tick_s.mean()),
                       "untraced_tick_mean_ms": (1e3 * plain_mean
                                                 if plain_mean else None)}

        # 4. the dag_scale joint solve: phase_us is its phase spans
        dag = dag_scale.make_dag()
        with obs.capture() as cap:
            dec = counted(lambda: solve_dag(
                dag, steps=dag_scale.PGD_STEPS, restarts=1,
                num_t=dag_scale.TICK_T, device="cuda"))
        phases = {r["attrs"]["phase"]: r["dur_us"] for r in cap
                  if r["name"] == obs_names.SPAN_SOLVER_PHASE}
        totals = obs_export.phase_totals(cap)
        pu = dec.profile["phase_us"]
        same = (pu == {p: round(d, 1) for p, d in phases.items()}
                and all(abs(totals[p] - pu[p]) <= 0.55 for p in pu))
        log(f"[trace] dag_scale joint solve: phase_us {pu}; phase_totals of "
            f"its spans {totals}: " + ("the same measurement" if same
                                       else "DIFFER")
            + f"; {spans_by_mode(cap)} kernel.launch spans inside phases")
        if not same:
            fails.append("dag phase_us differs from its spans")
        out["dag"] = {"phase_us": pu, "phase_totals": totals}

        # 5. the sanitizer, switched on in this process
        def loop_run():
            with _counting_solves() as n:
                (_, _, w), syncs = _syncs_of(
                    lambda: _closed_loop("frontier", "cuda"))
            return w, syncs, n["solves"]

        ws_off, syncs_off, solves = loop_run()
        os.environ[san.ENV_VAR] = "1"
        ws_on, syncs_on, solves_on = counted(loop_run)
        added = (syncs_on - syncs_off) / max(solves, 1)
        same = np.array_equal(ws_on, ws_off) and np.array_equal(ws_on,
                                                                 ws_plain)
        log(f"[trace] sanitizer on: K=1024 loop decisions " + (
            "bitwise the unsanitized ones" if same else "DIFFER")
            + f"; device syncs {syncs_on} against {syncs_off} over {solves} "
            f"PGD solves of 60 steps: {added:.2f} added a solve (at most "
            f"{SANITIZE_MAX_READS}), {added / 60:.3f} a step")
        if not same or solves_on != solves or added > SANITIZE_MAX_READS:
            fails.append("sanitized loop")
        sim = ClusterSim.heterogeneous(1024, seed=0)
        mus, sgs = (np.asarray(a, np.float32) for a in sim.true_params)
        bad = mus.copy()
        bad[5] = np.nan
        before = dict(fg.LAUNCHES)
        try:
            partitioner.optimize_weights(bad, sgs, lam=0.02, steps=60,
                                         restarts=0, device="cuda")
            nan_in = "no raise"
        except san.SanitizeError as e:
            nan_in = str(e)
        torch.cuda.synchronize()
        launched = {m: fg.LAUNCHES[m] - before[m] for m in before}
        log(f"[trace] sanitizer on, a NaN in mus: {nan_in!r}; launches "
            f"{launched}")
        if nan_in == "no raise" or any(launched.values()):
            fails.append("NaN mus")
        orig, seen = ops.frontier_moments_with_grads, {"n": 0}

        def planted(*a, **kw):
            outs = orig(*a, **kw)
            if seen["n"] == SANITIZE_NAN_STEP:
                outs[2][0, 0] = float("nan")
            seen["n"] += 1
            return outs

        ops.frontier_moments_with_grads = planted
        try:
            partitioner.optimize_weights(mus, sgs, lam=0.02, steps=60,
                                         restarts=0, device="cuda")
            nan_step = "no raise"
        except san.SanitizeError as e:
            nan_step = str(e)
        finally:
            ops.frontier_moments_with_grads = orig
        log(f"[trace] sanitizer on, a NaN gradient planted at step "
            f"{SANITIZE_NAN_STEP}: {nan_step!r} after {seen['n']} steps")
        if f"step {SANITIZE_NAN_STEP})" not in nan_step or seen["n"] != 60:
            fails.append("planted NaN gradient")
        out["sanitize"] = {"bitwise": same, "syncs_on": syncs_on,
                           "syncs_off": syncs_off, "solves": solves,
                           "added_per_solve": added, "nan_mus": nan_in,
                           "nan_step": nan_step}
    finally:
        obs.TRACER = tracer
        os.environ.pop(san.ENV_VAR, None)
        if env is not None:
            os.environ[san.ENV_VAR] = env
    ctx["trace_launches"] = total
    ctx["trace_port_launches"] = port
    ctx["trace"] = out
    log(f"[trace] frontier calls {total}, {port}")
    if port["compose_grads"] <= 0:
        fails.append(f"the traced runs never launched the composition's "
                     f"kernel: {port}")
    if fails:
        raise AssertionError(f"trace phase failed: {fails}")


# ------------------------------------------------------------- the sweep
# (mode, F, K, T), normal family: the fleet tick, then a refresh's finalists
# (fwd), PGD steps (grad) and sensitivity (pgrad) at K=1024
SWEEP_SHAPES = (("fwd", 4096, 1024, 256), ("grad", 4096, 1024, 256),
                ("pgrad", 4096, 1024, 256), ("fwd", 3, 1024, 2048),
                ("grad", 3, 1024, 1024), ("pgrad", 1, 1024, 1024))
SWEEP_REPEATS = 7


def phase_sweep(ctx):
    """``kernels.autotune.sweep`` on the card at SWEEP_SHAPES into a
    temporary cache file (the fleet-tick grad through
    ``bench.cluster_scale.tick_sweep``), every candidate held against its
    plain version with its bits repeated; then the winners reloaded from
    the file through a cleared cache, a K=1024 balancer checkpointed with
    them and restored (the next decision bitwise the survivor's), and the
    in-process cache restored."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.bench import cluster_scale
    from repro_torch.ckpt import restore_pipeline, save_pipeline
    from repro_torch.core.distributions import extra_rows
    from repro_torch.kernels import autotune, frontier_grid as fg
    from repro_torch.sched import UncertaintyAwareBalancer
    from repro_torch.sim import ClusterSim
    saved = autotune.cache_state()
    fails, rows = [], []
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as d:
            path = os.path.join(d, "autotune_cache.json")
            torch.cuda.synchronize()
            fg.reset_launches()
            for mode, F, K, T in SWEEP_SHAPES:
                t0 = time.perf_counter()
                if (mode, F) == ("grad", 4096):
                    entry = cluster_scale.tick_sweep(
                        [], K, F, T, "cuda", cache_path=path,
                        repeats=SWEEP_REPEATS)
                else:
                    entry = autotune.sweep(F, K, T, mode=mode,
                                           dist_id="normal",
                                           repeats=SWEEP_REPEATS,
                                           cache_path=path, device="cuda")
                bound_ms, by = _bound(mode, F, K, T, extra_rows("normal"),
                                      False)
                tm = entry["timings"]
                win = min(tm, key=tm.get)
                row = {"mode": mode, "F": F, "K": K, "T": T,
                       "model": entry["model"],
                       "model_ms": tm[entry["model"]] / 1e3,
                       "winner": win, "winner_ms": entry["us"] / 1e3,
                       "split": entry["value"],
                       "threads": entry.get("threads"),
                       "timings_ms": {k: v / 1e3 for k, v in tm.items()},
                       "bound_ms": bound_ms, "bound_by": by,
                       "seconds": time.perf_counter() - t0}
                rows.append(row)
                log(f"[sweep] {mode:5s} F={F} K={K} T={T}: model "
                    f"{row['model']} {row['model_ms']:.4f} ms, winner "
                    f"{win} {row['winner_ms']:.4f} ms (model/winner "
                    f"{row['model_ms'] / row['winner_ms']:.3f}), bound "
                    f"{bound_ms:.4f} ms ({by}), winner/bound "
                    f"{row['winner_ms'] / bound_ms:.1f}x; {len(tm)} "
                    f"candidates (threads/points,t_chunk,k_chunk,ep_chunk) "
                    f"within tolerance, bits repeated: "
                    + ", ".join(f"{k} {v / 1e3:.4f}" for k, v in tm.items())
                    + f" ({row['seconds']:.1f} s)")
            torch.cuda.synchronize()
            ctx["sweep_launches"] = dict(fg.LAUNCHES)

            # the winners come back from the file, as sweep entries
            autotune.clear_cache()
            for r in rows:
                split = autotune.lookup_split(r["F"], r["K"], r["T"],
                                              r["mode"], "normal",
                                              cache_path=path)
                if list(split) != r["split"] or \
                        autotune.last_outcome() != "sweep":
                    fails.append(f"reload {r['mode']} F={r['F']}")
            log(f"[sweep] {len(rows)} winners reloaded from the file "
                f"through a cleared cache with source sweep"
                + ("" if not fails else f": FAILED {fails}"))

            # a K=1024 balancer checkpointed with the swept cache
            K = 1024
            bal = UncertaintyAwareBalancer(K, lam=0.02, refresh_every=1,
                                           pgd_steps=60,
                                           adaptive_refresh=True,
                                           risk_lam=0.5, device="cuda")
            sim = ClusterSim.heterogeneous(K, seed=0)
            for _ in range(3):
                w = bal.weights()
                _, durs = sim.run_step(w)
                bal.observe(durs, w)
            ckpt = os.path.join(d, "ckpt")
            save_pipeline(ckpt, 3, bal)
            survivor = UncertaintyAwareBalancer.from_state_dict(
                bal.state_dict(), device="cuda")
            w_expect = survivor.weights()
            autotune.clear_cache()
            replica, _, _ = restore_pipeline(ckpt, device="cuda")
            outcomes = {f"{m} F={F}": autotune.plan_outcome(
                F, K_, T, m, "normal")[2]
                for m, F, K_, T in SWEEP_SHAPES if F < 4096}
            w_got = replica.weights()
            same = np.array_equal(w_expect, w_got)
            log(f"[sweep] K=1024 balancer checkpointed with the swept cache "
                f"and restored: launch plans {outcomes}; next decision "
                + ("bitwise the survivor's" if same else "DIFFERS"))
            if not same or set(outcomes.values()) != {"sweep"}:
                fails.append("checkpoint with the swept cache")
    finally:
        autotune.clear_cache()
        autotune.load_cache_state(saved)
    ctx["sweep"] = rows
    log(f"[sweep] in-process cache restored; frontier calls "
        f"{ctx.get('sweep_launches')}")
    if fails:
        raise AssertionError(f"sweep phase failed: {fails}")


# the model of the examples phase's full-width batcher (the path's arch)
EXAMPLES_ARCH = "smollm-360m"


def phase_examples(ctx):
    """The ported examples and the suite harness on the card (see the
    module docstring), then the engine demo's kill/restore against an
    unkilled run and the full-width model at the batcher's shapes against
    the plain ops."""
    import numpy as np
    import torch
    from repro_torch.bench import common, file_transfer, quickstart
    from repro_torch.bench import partitioned_training as parttrain
    from repro_torch.bench import run as harness
    from repro_torch.bench import serve_partitioned as sp
    from repro_torch.configs import get_config
    from repro_torch.kernels import frontier_grid as fg
    out_dir = os.path.join(OUT_DIR, "examples")
    common.RESULTS_DIR = out_dir
    fails, secs = [], {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"[examples] {name}: {secs[name]:.1f} s")
        return r

    cfg = get_config(EXAMPLES_ARCH)
    torch.cuda.synchronize()
    _reset_all()
    _reset_port()
    qs = timed("quickstart", lambda: quickstart.run(device="cuda"))
    ft = timed("file_transfer", lambda: file_transfer.run(device="cuda"))
    pt = timed("partitioned_training",
               lambda: parttrain.run(device="cuda"))
    eng = timed("serve_partitioned --engine", lambda: sp.run_engine_demo(
        device="cuda", ckpt_dir=os.path.join(out_dir, "engine_killed")))
    bat = timed("serve_partitioned --execute (full width)",
                lambda: sp.run_batcher(cfg, execute=True, device="cuda"))
    timed("run --only fig1,parttrain", lambda: harness.main(
        ["--only", "fig1,parttrain", "--device", "cuda"]))
    torch.cuda.synchronize()
    counts = {**fg.LAUNCHES, **_lm_launches(), **_port_launches()}
    ctx["examples_launches"] = counts
    log(f"[examples] launches {counts}")
    need = ("fwd", "grad", "compose_grads", "rmsnorm", "flash_attention",
            "flash_decode")
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        fails.append(f"the examples never launched {missing}")

    for policy, r in qs["policies"].items():
        log(f"[examples] quickstart {policy}: split "
            f"{np.round(r['weights'], 3).tolist()} join mean {r['mean']:.4f} "
            f"var {r['var']:.4f} p99 {r['p99']:.4f}")
    log(f"[examples] file_transfer: E[T] {ft['decision'].makespan_mu:.4f} "
        f"(single path {ft['single'].makespan_mu:.4f}, equal "
        f"{ft['equal'].makespan_mu:.4f}), MC {ft['mc_mean']:.4f} (rel "
        f"{ft['mc_rel_mu_err']:.2%}), speedup {ft['speedup']:.3f}x")
    log(f"[examples] partitioned_training: " + "; ".join(
        f"{p} join {m:.4f} var {v:.4f} {t:.3f} microbatches/s"
        for p, (m, v, t) in pt.items()))
    lat = bat["latencies"]
    log(f"[examples] serve_partitioned full width: equal mean "
        f"{lat['equal'].mean():.4f} s, frontier {lat['frontier'].mean():.4f}"
        f" s (-{bat['imp_mu']:.1%}); {bat['tokens']} tokens generated in "
        f"{bat['generate_s']:.2f} s ({bat['tokens'] / bat['generate_s']:.1f} "
        f"tokens/s, {len(bat['generated'])} batches)")

    # the demo's kill/restore against the same trace unkilled
    whole = sp.run_engine_demo(device="cuda", kill=False, ckpt_dir=os.path.join(
        out_dir, "engine_whole"))
    clock = "solver_tick_us"
    same = (eng["ticks"] == whole["ticks"]
            and {k: v for k, v in eng["summary"].items() if k != clock}
            == {k: v for k, v in whole["summary"].items() if k != clock})
    log(f"[examples] engine demo killed and restored at tick "
        f"{len(eng['ticks']) // 2 + 1} against the unkilled run: "
        + ("bitwise" if same else "DIFFERENT"))
    if not same:
        fails.append("engine demo kill/restore")

    # the full-width model through the kernels against the plain ops at
    # the batcher's shapes: a prefill of 32 prompts of 12 tokens into a
    # cache of 20, then 7 decode steps on the same tokens
    model, init_s, n_params = _build_full(cfg, "examples")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (32, 19)),
                           device="cuda")

    def generate():
        lpre, cache = model.prefill(toks[:, :12], cache_len=20)
        ldec = torch.cat([model.decode_step(cache, toks[:, t:t + 1])[0]
                          for t in range(12, 19)], 1)
        return lpre, ldec

    with torch.inference_mode():
        pk, dk = generate()
        with _plain_ops():
            pp, dp = generate()
    rel, agree = _hold_logits(
        "examples", f"full-width {cfg.name} prefill (32 x 12), kernels vs "
        f"plain on the card", pk, pp, cfg)
    drel, dagree = _hold_logits(
        "examples", f"full-width {cfg.name} 7 decode steps (32 x 1, cache "
        f"20), kernels vs plain on the card", dk, dp, cfg)
    del model, pk, dk, pp, dp
    torch.cuda.empty_cache()
    ctx["examples"] = {
        "seconds": secs, "launches": counts,
        "quickstart": {p: {**r, "weights": np.asarray(r["weights"]).tolist()}
                       for p, r in qs["policies"].items()},
        "file_transfer": {"makespan_mu": ft["decision"].makespan_mu,
                          "single_mu": ft["single"].makespan_mu,
                          "equal_mu": ft["equal"].makespan_mu,
                          "mc_mean": ft["mc_mean"],
                          "mc_rel_mu_err": ft["mc_rel_mu_err"]},
        "partitioned_training": {p: list(map(float, v))
                                 for p, v in pt.items()},
        "engine_summary": {k: v for k, v in eng["summary"].items()
                           if k != clock},
        "engine_restore_bitwise": same,
        "batcher": {"equal_mean": float(lat["equal"].mean()),
                    "frontier_mean": float(lat["frontier"].mean()),
                    "tokens": bat["tokens"], "generate_s": bat["generate_s"]},
        "full_width": {"arch": cfg.name, "params": n_params,
                       "rel_l2": rel, "argmax_agreement": agree,
                       "decode_rel_l2": drel,
                       "decode_argmax_agreement": dagree}}
    if fails:
        raise AssertionError(f"examples phase failed: {fails}")


# ---------------------------------------------------------------- training
# The training path's arch and its batch: SmolLM-360M at full width, bf16,
# B = 8 sequences of 2048 tokens from SyntheticStream (seed 0)
TRAIN_ARCH = "smollm-360m"
TRAIN_B, TRAIN_S = 8, 2048
TRAIN_STEPS = 10            # the Trainer's timed run
TRAIN_KILL_AT = 2           # the checkpoint the restored Trainer resumes from
PART_STEPS = 20             # bench.train_partitioned --full-360m
# the full-width first step through the kernels against the plain ops:
# the loss (relative) and every gradient leaf (relative L2)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-2, 0.1
# the backward kernels against autograd of their plain forwards, relative
# L2 of every output, per dtype (the model kernels' tolerances)
BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# (name, B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, dtype): SmolLM-360M's
# and Qwen3-8B's training shapes, a window, Whisper's non-causal cross
# shape, a ragged S and float32 at a small shape; then the 192 tile:
# DeepSeek-V2-Lite's MLA at its training batch (q, k of 192, v of 128),
# Nemotron-4-340B's layer (96 query and 8 KV heads of 192) at B 1, the
# float32 kernels' widest columns, and float32 at SmolLM-360M's training
# shape (q, k and v ~63 MB; the plain reference's scores ~2 GB); then the
# two archs trained since PR 29: h2o-danube-1.8b's layer at its training
# batch (B 2 x S 8192, 32/8 heads of 80, the 4096 window acting; the
# (128, 128) tile), and Whisper-large-v3's encoder self-attention and
# cross-attention at its (B 8, 20 heads, 1500 frames, 448 target tokens),
# in float32: the path's type, the float32 frames promoting the encoder
# and its cross K/V (models/whisper.py)
BWD_ATTN_CASES = (
    ("smollm-360m train", 8, 15, 5, 2048, 2048, 64, 64, True, None,
     "bfloat16"),
    ("qwen3-8b train", 2, 32, 8, 2048, 2048, 128, 128, True, None,
     "bfloat16"),
    ("window 512", 2, 8, 2, 2048, 2048, 64, 64, True, 512, "bfloat16"),
    ("noncausal 16 x 1500", 2, 20, 20, 16, 1500, 64, 64, False, None,
     "bfloat16"),
    ("ragged S=1000", 2, 15, 5, 1000, 1000, 64, 64, True, None, "bfloat16"),
    ("float32 small", 2, 4, 2, 256, 256, 64, 64, True, None, "float32"),
    ("deepseek-v2-lite mla train", 2, 16, 16, 2048, 2048, 192, 128, True,
     None, "bfloat16"),
    ("nemotron-4 layer", 1, 96, 8, 2048, 2048, 192, 192, True, None,
     "bfloat16"),
    ("float32 d192", 2, 4, 2, 512, 512, 192, 192, True, None, "float32"),
    ("float32 smollm-360m train", 8, 15, 5, 2048, 2048, 64, 64, True, None,
     "float32"),
    ("h2o-danube-1.8b train", 2, 32, 8, 8192, 8192, 80, 80, True, 4096,
     "bfloat16"),
    ("whisper encoder train", 8, 20, 20, 1500, 1500, 64, 64, False, None,
     "float32"),
    ("whisper cross train", 8, 20, 20, 448, 1500, 64, 64, False, None,
     "float32"),
)
# (name, B, S, H, P, G, N, chunk, dtype, rows where dt = 0): Mamba2-2.7B's
# layer at its training batch (B 2 x S 2048; 80 heads of 64, one group, a
# state of 128) in both dtypes, a ragged S, eight B/C groups, a long S at
# B 1, and the layer with runs of dt = 0 that tie decays across the
# float32 instance's chunk boundaries (64) inside forward chunks (128):
# rows 60-67, and 1000-1100, which spans the chunk [1024, 1088)
SSD_TIE_ROWS = tuple(range(60, 68)) + tuple(range(1000, 1101))
# the chunk at which the SSD backward's bound counts its work: the
# shortest in which a kernel of this repo computed the gradient (64 rows,
# ties across its own chunks included), the least work it needs
SSD_BOUND_CHUNK = 64
BWD_SSD_CASES = (
    ("mamba2-2.7b layer", 2, 2048, 80, 64, 1, 128, 128, "bfloat16", ()),
    ("mamba2-2.7b layer", 2, 2048, 80, 64, 1, 128, 128, "float32", ()),
    ("ragged S=1000", 2, 1000, 80, 64, 1, 128, 128, "bfloat16", ()),
    ("G=8", 2, 2048, 80, 64, 8, 128, 128, "bfloat16", ()),
    ("long S=16384", 1, 16384, 80, 64, 1, 128, 128, "bfloat16", ()),
    ("ties across chunks", 2, 2048, 80, 64, 1, 128, 128, "float32",
     SSD_TIE_ROWS),
)
# the further archs the training path trains at full width, after
# SmolLM-360M: (arch, layers kept (None: all), B, S, the end-to-end
# first-step checks as (depth, dtype, hold), Trainer steps, lr).
# Mamba2-2.7B whole (64 layers). DeepSeek-V2-Lite cut to its dense first
# layer and DS_MOE_LAYERS MoE layers: a step's peak is the AdamW update,
# ~26 bytes a parameter (bf16 weights and gradients, float32 moments old
# and new, the clip's float32 gradients), and 1 + 4 and 1 + 6 layers run
# out of the card's 80 GB there. In bf16 a random-weight Mamba2 stack's
# gradients are ill-conditioned: at 8 layers the plain path in bf16 reads
# ~0.9 relative L2 from the same weights in float32 (ROADMAP.md section 3
# item 30), so its 8-layer step is held in float32 at TRAIN_LOSS_TOL /
# TRAIN_GRAD_TOL ("plain"), and in bf16 against that witness ("witness":
# the kernels' distance from the float32 plain path at most
# TRAIN_WITNESS_RATIO times the bf16 plain path's own, at the worst leaf
# and at the median), and at 2 layers in bf16 at the tolerances. The
# Trainer runs take ARCH_STEPS steps (they took 12 before the shard
# phase's training and the train phase's counts took their time; the
# loss-falling check's windows of 5 stay disjoint), at a learning rate
# under which the loss falls from a random start.
# Since PR 29 every arch trains under its config's remat ("full", the
# reference's default), and two more archs train at full width:
# h2o-danube-1.8b whole (24 layers) on B 2 x 8192, so its 4096 window acts
# in forward and backward, and Whisper-large-v3 whole (32 + 32 layers) on
# B 8 x 448 target tokens and 1500 stub frames, each held end to end at 2
# layers (2 + 2 for Whisper) in bf16.
DS_MOE_LAYERS = 3
ARCH_STEPS = 10
TRAIN_ARCHS = (
    ("mamba2-2.7b", None, 2, 2048,
     ((2, "bfloat16", "plain"), (8, "float32", "plain"),
      (8, "bfloat16", "witness")), ARCH_STEPS, 3e-3),
    ("deepseek-v2-lite-16b", 1 + DS_MOE_LAYERS, 2, 2048,
     ((2, "bfloat16", "plain"),), ARCH_STEPS, 1e-3),
    ("h2o-danube-1.8b", None, 2, 8192, ((2, "bfloat16", "plain"),),
     ARCH_STEPS, 1e-3),
    ("whisper-large-v3", None, 8, 448, ((2, "bfloat16", "plain"),),
     ARCH_STEPS, 1e-3))
# the arch whose step is also tried once without remat, the measure of
# what remat buys: (arch, B, S, lr)
NO_REMAT_TRY = ("h2o-danube-1.8b", 2, 8192, 1e-3)
# the remat holds: (arch, layers kept, B, S, lr, tiny); two make_train_step
# steps under each of REMAT_RUNS, the second after the AdamW update (the
# state's weights then differ from the module's), the losses and the
# second step's every gradient leaf held bitwise against no remat's
REMAT_HOLDS = (
    ("smollm-360m", None, 8, 2048, 3e-4, False),
    ("mamba2-2.7b", None, 2, 2048, 3e-3, False),
    ("deepseek-v2-lite-16b", 1 + DS_MOE_LAYERS, 2, 2048, 1e-3, False),
    ("jamba-1.5-large-398b", None, 2, 64, 1e-3, True))
# (name, remat policy): no remat twice (its run-to-run distance, zero when
# the step repeats bit for bit), then "full" and "dots"
REMAT_RUNS = (("none", None), ("none again", None), ("full", "full"),
              ("dots", "dots"))
# where no remat's step does not repeat bit for bit, a policy is held at
# this many times its run-to-run distance (worst leaf and median)
REMAT_REPEAT_RATIO = 2.0
# a "witness" hold's bound on (kernels from float32) / (plain from float32):
# Mamba2-2.7B's 8-layer bf16 step read 0.815 at the worst leaf and 0.835 at
# the median (PR 26 runs T and G, NVIDIA H100 80GB HBM3, 700 W); a kernel
# that drifted at depth would put the kernels past the plain path
TRAIN_WITNESS_RATIO = 1.25
# the dense scores (float32 bytes) above which _plain_attention slices by
# batch row and KV heads, and the most a slice takes: the blockwise bf16
# reference keeps ~5 tensors of a key block's scores alive for autograd,
# ~90 GB at h2o-danube-1.8b's B 2 x S 8192 unsliced, ~21 GB a slice
PLAIN_ATTN_SLICE_BYTES = 4 << 30
# the tiny Jamba (float32) one step on the card against the CPU: the loss
# (relative) and every gradient leaf (relative L2); a miss is reported
# with each layer's reading (ROADMAP.md section 3), not failed
TINY_TRAIN_ARCH, TINY_TRAIN_B, TINY_TRAIN_S = "jamba-1.5-large-398b", 2, 64
TINY_LOSS_TOL, TINY_GRAD_TOL = 1e-3, 5e-2
# (rows, D, dtype): SmolLM-360M's norms at the training batch (16384 x
# 960) and a 4096-wide model's
BWD_NORM_CASES = ((16384, 960, "bfloat16"), (16384, 960, "float32"),
                  (4096, 4096, "bfloat16"), (4096, 4096, "float32"))
TRAIN_REPLACES = {
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/ops.py:190"),
    "flash_attention_bwd": ("src/repro_torch/csrc/attention.cu",
                            "src/repro/kernels/ops.py:43"),
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ops.py:130"),
}
# kernel names by their part of a training step (torch.profiler names)
STEP_PARTS = (("backward kernels", ("fa_bwd_", "rmsnorm_bwd", "rmsnorm_dw",
                                    "ssd_bwd")),
              ("forward kernels", ("fa_wgmma_kernel", "fa_f32_kernel",
                                   "rmsnorm_", "ssd_pass", "ssd_one")),
              ("cuBLAS", ("gemm", "nvjet", "xmma", "cutlass", "cublas")))


def _plain_attention(q, k, v, **kw):
    """The attention whose autograd is the backward kernels' plain version:
    ``ref.flash_attention_bf16p_ref`` in bf16, ``flash_attention_ref`` in
    float32. Above PLAIN_ATTN_SLICE_BYTES of dense scores it runs a batch
    row and as many KV heads (with their query heads) as that many bytes
    hold at a time, each slice recomputed in its backward: the same live
    pairs, one slice's graph alive at a time."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import ref
    fn = (ref.flash_attention_bf16p_ref if q.dtype == torch.bfloat16
          else ref.flash_attention_ref)
    B, Hq, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if 4 * B * Hq * Sq * Sk <= PLAIN_ATTN_SLICE_BYTES:
        return fn(q, k, v, **kw)
    G = Hq // Hkv
    n = max(1, PLAIN_ATTN_SLICE_BYTES // (4 * G * Sq * Sk))   # KV heads

    def one(qs, ks, vs):
        return fn(qs, ks, vs, **kw)
    return torch.cat([torch.cat([
        checkpoint(one, q[b:b + 1, h * G:(h + n) * G], k[b:b + 1, h:h + n],
                   v[b:b + 1, h:h + n], use_reentrant=False)
        for h in range(0, Hkv, n)], 1) for b in range(B)], 0)


def _plain_train_ops():
    """The model's ops swapped for the plain versions whose autograd is the
    backward kernels' plain version: ``_plain_attention``,
    ``ref.rmsnorm_ref`` and ``ref.ssd_chunked_ref``."""
    import contextlib
    from repro_torch.kernels import ops, ref

    @contextlib.contextmanager
    def swapped():
        saved = ops.attention, ops.rmsnorm, ops.ssd
        ops.attention, ops.rmsnorm, ops.ssd = (_plain_attention,
                                               ref.rmsnorm_ref,
                                               ref.ssd_chunked_ref)
        try:
            yield
        finally:
            ops.attention, ops.rmsnorm, ops.ssd = saved
    return swapped()


def _bwd_attn_case(case, fails):
    """One attention shape: the backward kernels against autograd of the
    plain forward (every gradient), timed beside their bound, the plain
    version and SDPA (forward + backward, backward alone)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    name, B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, dts = case
    dt = getattr(torch, dts)
    g = _gen(7)

    def view(H, S, d):   # the model's (B, S, H, d) projection, as a view
        return _randn(g, (B, S, H, d), dt).transpose(1, 2)
    q, k, v = view(Hq, Sq, D), view(Hkv, Sk, D), view(Hkv, Sk, Dv)
    dout = _randn(g, (B, Hq, Sq, Dv), dt)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, dout)
    plain = _plain_attention
    pl = [t.detach().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(plain(*pl, causal=causal, window=window), pl,
                               dout)
    tol = BWD_TOL[dts]
    rel = [_rel_l2(a.float(), b.float()) for a, b in zip(got, want)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    ok = all(r < tol for r in rel) and all(
        bool(torch.isfinite(a).all()) for a in got)
    again = torch.autograd.grad(
        fa.flash_attention(*leaves, causal=causal, window=window), leaves,
        dout)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not ok or not same:
        fails.append(f"flash_attention_bwd {name}")
    del want, again, pl
    torch.cuda.empty_cache()
    _, lse = fa._forward(q, k, v, causal, window, None, with_lse=True)
    o = out.detach()

    def bwd():
        return fa.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal,
                                      window=window)

    def fwd_bwd():
        y = fa.flash_attention(*leaves, causal=causal, window=window)
        return torch.autograd.grad(y, leaves, dout)

    ms = _time_cuda(bwd, reps=7)
    fb_ms = _time_cuda(fwd_bwd, reps=5)
    # D_i, dK/dV, dQ
    per_call = 3
    by_kernel = _device_window(bwd, reps=5, expect=("fa_bwd_", per_call))
    dev = (None if by_kernel is None
           else sum(by_kernel.values()) / 1e3 / 5)
    busy = _device_busy_ms(bwd, reps=5, expect=("fa_bwd_", per_call))
    by_kernel = {_kernel_name(n): us / 1e3 / 5
                 for n, us in (by_kernel or {}).items()}

    plain_ms = _time_cuda(lambda: torch.autograd.grad(
        plain(*leaves, causal=causal, window=window), leaves, dout),
        reps=3, warm=1)
    mask = None
    if window is not None:
        mask = ref.attention_mask(Sq, Sk, causal, window, q.device)

    def sdpa():
        return F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=Hq != Hkv)
    lib_fb = lib_bwd = lib_dev = lib_busy = backend = None
    try:
        y = sdpa()
        lib_fb = _time_cuda(lambda: torch.autograd.grad(sdpa(), leaves,
                                                        dout), reps=5)

        def lib_call():
            return torch.autograd.grad(y, leaves, dout, retain_graph=True)
        lib_bwd = _time_cuda(lib_call, reps=5)
        lib_dev = _device_ms(lib_call, reps=5)
        lib_busy = _device_busy_ms(lib_call, reps=5)
        if dt == torch.float32 or mask is not None:
            backend = _sdpa_backend(lib_call)
        del y
    except RuntimeError as e:
        log(f"[train] SDPA refuses {name}: {str(e).splitlines()[0][:120]}")
    # float32 GQA, or GQA under a window's mask: SDPA's backward also with
    # k and v expanded to the query heads as its leaves (the
    # memory-efficient backend takes that)
    mha = mha_dev = mha_backend = None
    if Hq != Hkv and (dt == torch.float32 or mask is not None):
        xl = [leaves[0].detach().requires_grad_(True)] + [
            t.detach().repeat_interleave(Hq // Hkv, 1).requires_grad_(True)
            for t in leaves[1:]]
        ym = F.scaled_dot_product_attention(
            *xl, attn_mask=mask, is_causal=causal and mask is None)

        def mha_call():
            return torch.autograd.grad(ym, xl, dout, retain_graph=True)
        mha = _time_cuda(mha_call, reps=5)
        mha_dev = _device_ms(mha_call, reps=5)
        mha_backend = _sdpa_backend(mha_call)
        log(f"[train] flash_attention_bwd {name:26s} SDPA bwd device "
            + (f"{lib_dev:.3f}" if lib_dev else "not measured")
            + f" ({backend}); with k, v expanded {mha:.3f} ms, device "
            + (f"{mha_dev:.3f}" if mha_dev else "not measured")
            + f" ({mha_backend})"
            + (f"; kernel busy/SDPA device {busy / lib_dev:.2f}x GQA, "
               f"{busy / mha_dev:.2f}x expanded"
               if busy and lib_dev and mha_dev else ""))
        del ym, xl
    esize = 2 if dt == torch.bfloat16 else 4
    ops_, nbytes = RL.attention_bwd_work(B, Hq, Hkv, Sq, Sk, D, Dv, causal,
                                         window, esize)
    peak = RL.tensor_peak(esize)
    bound_ms, by = _roof(nbytes, ops_ / peak)
    cuda_core_ms = (None if dt == torch.bfloat16
                    else _roof(nbytes, ops_ / FP32_OPS_PER_S)[0])
    tf32_ms = (None if dt == torch.bfloat16
               else _roof(nbytes, ops_ / TF32_OPS_PER_S * 3)[0])
    log(f"[train] flash_attention_bwd {name:26s} {dts} D={D} Dv={Dv}: "
        f"rel L2 dq "
        f"{rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e} (tol {tol:g}), "
        f"max|err| {err:.2e}, bits repeat {same}; bwd {ms:.3f} ms (device "
        + (f"{dev:.3f}" if dev is not None else "not measured")
        + ", busy " + (f"{busy:.3f}" if busy is not None else "not measured")
        + f"), fwd+bwd {fb_ms:.3f} ms, bound {bound_ms:.3f} ms ({by}, "
        f"{ops_ / 1e9:.1f} GFLOP at {peak / 1e12:.0f} TFLOP/s"
        + (f"; {tf32_ms:.3f} ms in split TF32 at "
           f"{TF32_OPS_PER_S / 3e12:.0f}, {cuda_core_ms:.3f} ms on the CUDA "
           f"cores at {FP32_OPS_PER_S / 1e12:.0f}" if cuda_core_ms else "")
        + f"), bwd/bound {ms / bound_ms:.2f}x; plain fwd+bwd {plain_ms:.2f} "
        f"ms; SDPA "
        f"fwd+bwd " + (f"{lib_fb:.3f}" if lib_fb else "n/a") + " ms, bwd "
        + (f"{lib_bwd:.3f}" if lib_bwd else "n/a") + " ms (device "
        + (f"{lib_dev:.3f}" if lib_dev else "not measured") + ", busy "
        + (f"{lib_busy:.3f}" if lib_busy else "not measured") + ")"
        + (f", kernel/SDPA device {dev / lib_dev:.2f}x" if dev and lib_dev
           else "")
        + (f", busy {busy / lib_busy:.2f}x" if busy and lib_busy else "")
        + ("" if ok and same else "  FAIL"))
    log(f"[train]   by launch (device ms a call): " + ", ".join(
        f"{n} {ms:.4f}" for n, ms in by_kernel.items()))
    row = {"name": name, "dtype": dts, "D": D, "Dv": Dv, "rel_l2": rel,
           "max_abs_err": err,
           "bits_repeat": same, "ms": ms, "device_ms": dev,
           "fwd_bwd_ms": fb_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": by, "library_ms": lib_bwd, "library_dev_ms": lib_dev,
           "library_fwd_bwd_ms": lib_fb, "by_kernel_ms": by_kernel,
           "device_busy_ms": busy, "library_busy_ms": lib_busy,
           "bound_cuda_core_ms": cuda_core_ms, "bound_tf32_ms": tf32_ms,
           "library_backend": backend, "library_mha_ms": mha,
           "library_mha_dev_ms": mha_dev,
           "library_mha_backend": mha_backend}
    del q, k, v, dout, leaves, out, got, lse, o
    torch.cuda.empty_cache()
    return row


def _bwd_norm_case(case, fails):
    """One norm shape: rmsnorm_bwd against autograd of the plain forward
    (dx, dw), timed beside its bound, the plain version and F.rms_norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    rows, D, dts = case
    dt = getattr(torch, dts)
    g = _gen(8)
    x = _randn(g, (rows, D), dt)
    w = (1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(dt)
    dy = _randn(g, (rows, D), dt)
    xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    got = torch.autograd.grad(rn.rmsnorm(xl, wl), (xl, wl), dy)
    want = torch.autograd.grad(ref.rmsnorm_ref(xl, wl), (xl, wl), dy)
    tol = BWD_TOL[dts]
    rel = [_rel_l2(a.float(), b.float()) for a, b in zip(got, want)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(
        got, torch.autograd.grad(rn.rmsnorm(xl, wl), (xl, wl), dy)))
    ok = all(r < tol for r in rel) and same
    if not ok:
        fails.append(f"rmsnorm_bwd {rows}x{D} {dts}")
    ms = _time_cuda(lambda: rn.rmsnorm_bwd(x, w, dy), reps=7, per_pair=10)
    dev = _device_ms(lambda: rn.rmsnorm_bwd(x, w, dy), reps=10,
                     expect=("rmsnorm_", 2))
    plain_ms = _time_cuda(lambda: torch.autograd.grad(
        ref.rmsnorm_ref(xl, wl), (xl, wl), dy), reps=5)
    lib_fb = _time_cuda(lambda: torch.autograd.grad(
        F.rms_norm(xl, (D,), wl, 1e-6), (xl, wl), dy), reps=5, per_pair=10)
    y = F.rms_norm(xl, (D,), wl, 1e-6)

    def lib_call():
        return torch.autograd.grad(y, (xl, wl), dy, retain_graph=True)
    lib_bwd = _time_cuda(lib_call, reps=5, per_pair=10)
    lib_dev = _device_ms(lib_call, reps=10)
    esize = x.element_size()
    ops_, nbytes = RL.rmsnorm_bwd_work(rows, D, esize)
    bound_ms, by = _roof(nbytes, ops_ / FP32_OPS_PER_S)
    log(f"[train] rmsnorm_bwd {rows} x {D} {dts}: rel L2 dx {rel[0]:.2e} dw "
        f"{rel[1]:.2e} (tol {tol:g}), max|err| {err:.2e}, bits repeat "
        f"{same}; {ms:.4f} ms (device "
        + (f"{dev:.4f}" if dev is not None else "not measured")
        + f"), bound {bound_ms:.4f} ms ({by}), kernel/bound "
        f"{ms / bound_ms:.2f}x; plain fwd+bwd {plain_ms:.3f} ms; F.rms_norm "
        f"fwd+bwd {lib_fb:.4f} ms, bwd {lib_bwd:.4f} ms (device "
        + (f"{lib_dev:.4f}" if lib_dev else "not measured") + ")"
        + (f", kernel/bound device {dev / bound_ms:.2f}x" if dev else "")
        + ("" if ok else "  FAIL"))
    return {"rows": rows, "D": D, "dtype": dts, "rel_l2": rel,
            "max_abs_err": err, "bits_repeat": same, "ms": ms,
            "device_ms": dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_bwd, "library_dev_ms": lib_dev,
            "library_fwd_bwd_ms": lib_fb}

def _ssd_bwd_work(B, S, H, P, G, N, L, esize, peak=None):
    """(bytes, seconds of operations) of one SSD backward call computed in
    chunks of L rows (``launch.roofline.ssd_bwd_work``) at ``peak``, by
    default the card's rate for the route the kernels take: the bf16
    tensor-core rate for bf16 inputs (float32 sums), and for float32 ones
    the rate of their split bf16 planes on the same tensor cores
    (``roofline.tensor_peak``, as the float32 attention bound). The work a
    row grows with L, so the bound takes L = min(chunk, S,
    SSD_BOUND_CHUNK)."""
    flops, nbytes = RL.ssd_bwd_work(B, S, H, P, G, N, L, esize)
    return nbytes, flops / (peak or RL.tensor_peak(esize))


def _ssd_bwd_case(case, fails):
    """One SSD shape: ssd_scan_bwd against its plain version
    (``ref.ssd_chunked_bwd_ref``, the kernel's formulas in the kernel's
    chunks) and against autograd of the plain forward
    (``ref.ssd_chunked_ref`` at the forward's chunk) on every gradient,
    bits repeated, timed beside its bound and the plain version. No PyTorch
    call computes it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    name, B, S, H, P, G, N, chunk, dts, zeros = case
    dt_ = getattr(torch, dts)
    g = _gen(9)
    x = _randn(g, (B, S, H, P), dt_)
    dt = F.softplus(torch.randn((B, S, H), generator=g, device="cuda") - 2.0)
    dt[:, list(zeros)] = 0.0
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    # B and C as the model's strided column views of one projection
    bc = (0.3 * torch.randn((B, S, 2 * G * N), generator=g,
                            device="cuda")).to(dt_)
    Bm = bc[..., :G * N].reshape(B, S, G, N)
    Cm = bc[..., G * N:].reshape(B, S, G, N)
    D = torch.ones((H,), device="cuda")
    dy = _randn(g, (B, S, H, P), dt_)
    arrs = (x, dt, A, Bm, Cm, D)
    leaves = [t.detach().requires_grad_(True) for t in arrs]
    got = torch.autograd.grad(ssd.ssd_scan(*leaves, chunk=chunk), leaves, dy)
    L = ssd.bwd_chunk(S, chunk, dt_)
    formulas = ref.ssd_chunked_bwd_ref(*arrs, dy, chunk=L, fwd_chunk=chunk)
    pl = [t.detach().requires_grad_(True) for t in arrs]
    auto = torch.autograd.grad(ref.ssd_chunked_ref(*pl, chunk=chunk), pl, dy)
    tol = BWD_TOL[dts]
    rel_f = [_rel_l2(a.float(), b.float()) for a, b in zip(got, formulas)]
    rel_a = [_rel_l2(a.float(), b.float()) for a, b in zip(got, auto)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, formulas))
    again = torch.autograd.grad(ssd.ssd_scan(*leaves, chunk=chunk), leaves,
                                dy)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (all(r < tol for r in rel_f + rel_a) and same
          and all(bool(torch.isfinite(a.float()).all()) for a in got))
    if not ok:
        fails.append(f"ssd_scan_bwd {name} {dts}")
    del formulas, auto, again, pl
    torch.cuda.empty_cache()

    def bwd():
        return ssd.ssd_scan_bwd(*arrs, dy, chunk=chunk)
    ms = _time_cuda(bwd, reps=5)
    # the chunks' increments and both scans (where S is more than one
    # chunk), each chunk's gradients, the ties across float32's chunks
    # inside a forward chunk, the sums
    per_call = ssd.bwd_launches(S, chunk, dt_)
    by_kernel = _device_window(bwd, reps=3, expect=("ssd_bwd_", per_call))
    dev = (None if by_kernel is None
           else sum(by_kernel.values()) / 1e3 / 3)
    plain_ms = _time_cuda(lambda: ref.ssd_chunked_bwd_ref(
        *arrs, dy, chunk=L, fwd_chunk=chunk),
                          reps=3, warm=1)
    esize = x.element_size()
    bound_ms, by = _roof(*_ssd_bwd_work(
        B, S, H, P, G, N, min(chunk, S, SSD_BOUND_CHUNK), esize))
    # the same work reckoned in the forward's chunks, for the record, and
    # a float32 call's on the CUDA cores (the bound before PR 29)
    fwd_bound_ms, fwd_by = _roof(*_ssd_bwd_work(B, S, H, P, G, N,
                                                min(chunk, S), esize))
    cuda_core_ms = (None if esize == 2 else _roof(*_ssd_bwd_work(
        B, S, H, P, G, N, min(chunk, S, SSD_BOUND_CHUNK), esize,
        FP32_OPS_PER_S))[0])
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    log(f"[train] ssd_scan_bwd {name:18s} {dts} (B {B}, S {S}, H {H}, P {P}, "
        f"G {G}, N {N}; chunks of {L}"
        + (f"; dt = 0 on {len(zeros)} rows" if zeros else "")
        + "): rel L2 against its plain version "
        + " ".join(f"{n} {r:.1e}" for n, r in zip(names, rel_f))
        + "; against autograd of the plain forward "
        + " ".join(f"{n} {r:.1e}" for n, r in zip(names, rel_a))
        + f" (tol {tol:g}), max|err| {err:.2e}, bits repeat {same}; "
        f"{ms:.3f} ms (device "
        + (f"{dev:.3f}" if dev is not None else "not measured")
        + f", {per_call} launches), bound {bound_ms:.4f} ms ({by}; "
        f"{fwd_bound_ms:.4f} ({fwd_by}) in the forward's chunks"
        + (f"; {cuda_core_ms:.4f} on the CUDA cores at "
           f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s" if cuda_core_ms else "")
        + f"), kernel/bound {ms / bound_ms:.1f}x; plain {plain_ms:.2f} ms"
        + ("" if ok else "  FAIL"))
    by_kernel = {_kernel_name(n): us / 1e3 / 3
                 for n, us in (by_kernel or {}).items()}
    log(f"[train]   by launch (device ms a call): " + ", ".join(
        f"{n} {ms:.4f}" for n, ms in by_kernel.items()))
    row = {"name": name, "dtype": dts, "shape": [B, S, H, P, G, N],
           "chunk": L, "zero_rows": len(zeros), "rel_l2": rel_f, "rel_l2_autograd": rel_a,
           "max_abs_err": err, "bits_repeat": same, "ms": ms,
           "device_ms": dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": by, "bound_fwd_chunk_ms": fwd_bound_ms,
           "bound_cuda_core_ms": cuda_core_ms, "library_ms": None,
           "library_dev_ms": None,
           "by_kernel_ms": by_kernel}
    del x, dt, Bm, Cm, bc, dy, leaves, got, arrs
    torch.cuda.empty_cache()
    return row


def _train_layerwise(model, cfg, tokens, tag, extra=None):
    """Each layer of ``model`` on the kernel path's own input (the residual
    stream of the kernels' forward on ``tokens``, without a graph; Whisper's
    encoder on ``extra``, its frames, and each decoder layer with the
    encoder's output) and a seeded cotangent: the gradients of its output
    in its input and in each of its parameters, through the kernels
    against the plain ops (``_plain_train_ops``), relative L2 each. Returns
    each layer's worst leaf and the overall worst."""
    import torch
    from repro_torch.models import remat
    from repro_torch.models.layers import embed_lookup, rms_norm
    g = _gen(11)
    if cfg.is_encoder_decoder:
        positions = model._positions(*extra.shape[:2])
        with torch.no_grad():
            enc_in = model._encoder_input(extra)
        dec_positions = model._positions(*tokens.shape)
        stacks = [("enc", model.enc_blocks, enc_in, positions, ())]
    else:
        positions = model._positions(*tokens.shape)
        with torch.no_grad():
            x = embed_lookup(model.embed, tokens, cfg)
        stacks = [("", model.layers, x, positions, ())]
    by_layer = []

    def run(name, blk, h, pos, extra_in):
        if name == "enc":
            return model._enc_layer(h, remat.unit_params(blk), pos)
        if name == "dec":
            return model._dec_layer(h, remat.unit_params(blk), pos,
                                    *extra_in)
        return model._block_apply(blk, h, pos)[0]
    while stacks:
        name, blocks, x, positions, extra_in = stacks.pop(0)
        for blk in blocks:
            names = ["input"] + [n for n, _ in blk.named_parameters()]
            params = list(blk.parameters())
            dy = _randn(g, tuple(x.shape), x.dtype)

            def grads(plain):
                xl = x.detach().requires_grad_(True)
                with _plain_train_ops() if plain else nullcontext():
                    y = run(name, blk, xl, positions, extra_in)
                return torch.autograd.grad(y, [xl] + params, dy)
            gk, gp = grads(False), grads(True)
            rels = [_rel_l2(a.float(), b.float()) for a, b in zip(gk, gp)]
            j = max(range(len(rels)), key=rels.__getitem__)
            finite = all(bool(torch.isfinite(a).all()) for a in gk)
            by_layer.append((rels[j], f"{name}{'.' if name else ''}"
                             f"{names[j]}", finite))
            del gk, gp
            with torch.no_grad():
                x = run(name, blk, x, positions, extra_in)
        if name == "enc":
            with torch.no_grad():
                enc_out = rms_norm(x, model.enc_norm.to(x.dtype),
                                   cfg.norm_eps)
                x = model._decoder_input(tokens)
            stacks.append(("dec", model.dec_blocks, x, dec_positions,
                           (enc_out,)))
    i = max(range(len(by_layer)), key=lambda k: by_layer[k][0])
    log(f"[train] {tag} every layer's gradients on its own input (input and "
        f"parameters, kernels against plain ops): worst relative L2 "
        f"{by_layer[i][0]:.3e} (layer {i}, {by_layer[i][1]}), by layer "
        + " ".join(f"{r:.1e}" for r, _, _ in by_layer)
        + f" (tol {TRAIN_GRAD_TOL:g})")
    return {"worst_rel_l2": by_layer[i][0], "worst_layer": i,
            "worst_leaf": by_layer[i][1],
            "by_layer": [r for r, _, _ in by_layer],
            "finite": all(f for _, _, f in by_layer)}


def _grad_gap(a, b):
    """(loss relative, worst leaf, its relative L2, the median) of two
    (loss, {name: grad}) results."""
    import numpy as np
    rels = {n: _rel_l2(a[1][n].float(), b[1][n].float()) for n in a[1]}
    worst = max(rels, key=rels.get)
    return (abs(a[0] - b[0]) / abs(b[0]), worst, rels[worst],
            float(np.median(list(rels.values()))))


def _hold_step(tag, cfg, B, S, dtype, hold, fails):
    """The first step of ``cfg``'s model (seed 0, full width; in float32
    the bf16 draw widened) on B x S tokens from SyntheticStream, through
    the kernels against the plain ops: the loss relative at
    TRAIN_LOSS_TOL, and with ``hold`` "plain" every gradient leaf's
    relative L2 at TRAIN_GRAD_TOL; with "witness" both paths' gradients
    against the plain path on the same weights in float32, the kernels'
    distance at most TRAIN_WITNESS_RATIO times the plain path's, at the
    worst leaf and at the median."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, device="cuda", seed=0, trainable=True)
    if dtype == "float32":
        m32 = build_model(cfg.replace(param_dtype="float32",
                                      activation_dtype="float32"),
                          device="cuda", seed=0, trainable=True)
        m32.load_state_dict(model.state_dict())
        model, cfg = m32, m32.cfg
    tokens, labels, extra = _batch_tensors(cfg, B, S)
    gk = _full_width_grads(model, cfg, tokens, labels, False, extra)
    gp = _full_width_grads(model, cfg, tokens, labels, True, extra)
    loss_rel, worst, worst_rel, median = _grad_gap(gk, gp)
    finite = all(bool(torch.isfinite(g).all()) for g in gk[1].values())
    out = {"layers": cfg.num_layers, "dtype": dtype, "hold": hold,
           "loss_kernels": gk[0], "loss_plain": gp[0], "loss_rel": loss_rel,
           "worst_leaf": worst, "worst_rel_l2": worst_rel,
           "median_rel_l2": median}
    if hold == "plain":
        ok = worst_rel < TRAIN_GRAD_TOL
        held = f"tol {TRAIN_GRAD_TOL:g}"
    else:
        c32 = cfg.replace(param_dtype="float32", activation_dtype="float32")
        m32 = build_model(c32, device="cuda", seed=0, trainable=True)
        m32.load_state_dict(model.state_dict())
        g32 = _full_width_grads(m32, c32, tokens, labels, True, extra)
        _, _, p_worst, p_med = _grad_gap(gp, g32)
        _, _, k_worst, k_med = _grad_gap(gk, g32)
        r_worst, r_med = k_worst / p_worst, k_med / p_med
        ok = max(r_worst, r_med) <= TRAIN_WITNESS_RATIO
        out.update(plain_vs_float32_median=p_med,
                   plain_vs_float32_worst=p_worst,
                   kernels_vs_float32_median=k_med,
                   kernels_vs_float32_worst=k_worst,
                   witness_ratio_worst=r_worst, witness_ratio_median=r_med)
        held = (f"held against the plain path on the same weights in "
                f"float32: the plain path reads median {p_med:.3e} (worst "
                f"{p_worst:.3e}), the kernels median {k_med:.3e} (worst "
                f"{k_worst:.3e}), kernels/plain {r_med:.3f} (worst "
                f"{r_worst:.3f}, at most {TRAIN_WITNESS_RATIO:g})")
        del m32, g32
    ok = ok and loss_rel < TRAIN_LOSS_TOL and finite
    log(f"[train] {tag} first step end to end at {cfg.num_layers} layers "
        f"in {dtype}, B={B} x S={S}: loss kernels {gk[0]:.6f} plain "
        f"{gp[0]:.6f} (rel {loss_rel:.2e}, tol {TRAIN_LOSS_TOL:g}); gradient "
        f"rel L2 worst {worst_rel:.3e} ({worst}), median {median:.3e} "
        f"({held}), finite {finite}" + ("" if ok else "  FAIL"))
    if not ok:
        fails.append(f"{tag} first step at {cfg.num_layers} layers {dtype}")
    del model, gk, gp
    torch.cuda.empty_cache()
    return out


def _trainer_run(cfg, argv, B, S, steps, fails, smi):
    """``steps`` steps through ``launch.train`` (``argv``) with the model
    kernels' launches counted from zero and held to the count the code
    makes, the loss falling: (state, record, counts). The step time is the
    median of the steps after the first two (the last 10 of SmolLM-360M's
    12, the last 8 of the other archs' 10) on the host clock,
    synchronized."""
    import numpy as np
    import torch
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.launch import train as train_cli
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    t0 = time.perf_counter()
    state, hist = train_cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {**dict(fg.LAUNCHES), **_lm_launches()}
    peak = torch.cuda.max_memory_allocated()
    want = _train_launches(cfg, steps)
    got = {k: counts[k] for k in want}
    walls = [h["wall_s"] for h in hist]
    step_ms = 1e3 * float(np.median(walls[2:]))
    losses = [h["loss"] for h in hist]
    log(f"[train] launch.train {' '.join(argv)} ({cfg.num_layers} layers) in "
        f"{run_s:.1f} s: step {step_ms:.1f} ms (median of the last "
        f"{len(walls[2:])}, host "
        f"clock, synchronized), {B * S / step_ms * 1e3:.0f} tokens/s, peak "
        f"memory {peak / 1e9:.2f} GB; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches {got}, expected {want} ({smi})")
    if got != want:
        fails.append(f"{cfg.name} Trainer launches {got}, not {want}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fails.append(f"{cfg.name}: the Trainer's loss did not fall")
    return state, {"steps": steps, "step_ms": step_ms,
                   "tokens_per_s": B * S / step_ms * 1e3,
                   "peak_gb": peak / 1e9, "losses": losses, "walls_s": walls,
                   "launches": got, "seconds": run_s}, counts


def _train_arch(arch, layers, B, S, holds, steps, lr, fails, smi):
    """One arch of TRAIN_ARCHS at full width: its first step end to end at
    each of ``holds`` (depth, dtype, hold), every layer's gradients on its
    own input at the trained depth (``layers``, None for all), then
    ``steps`` steps through ``launch.train`` at learning rate ``lr`` with
    the model kernels' launches counted from zero and held to the count the
    code makes, the loss falling, then one step profiled."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    out = {"arch": arch, "layers": cfg.num_layers, "batch": B, "seq": S,
           "remat": cfg.remat_policy if cfg.remat else None}
    out["end_to_end"] = [_hold_step(arch, _cut(cfg, depth), B, S, dtype,
                                    hold, fails)
                         for depth, dtype, hold in holds]
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    tokens, labels, extra = _batch_tensors(cfg, B, S)
    lw = _train_layerwise(model, cfg, tokens, arch, extra)
    if not (lw["worst_rel_l2"] < TRAIN_GRAD_TOL and lw["finite"]):
        fails.append(f"{arch} layer {lw['worst_layer']}'s gradients")
    out["layerwise"] = lw
    del model
    torch.cuda.empty_cache()

    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(B),
            "--seq", str(S), "--lr", str(lr)]
    if layers is not None:
        argv += ["--layers", str(layers)]
    state, out["trainer"], counts = _trainer_run(cfg, argv, B, S, steps,
                                                 fails, smi)
    out["trainer"].update(lr=lr, params=n_params)
    # one step by part under torch.profiler (the Trainer's step function
    # on its final state). The model is only the structure functional_call
    # runs on the state's weights: its own are emptied, which leaves the
    # step more room than the Trainer had (Mamba2's peaked at 74.2 GB)
    model = build_model(cfg, device="cuda", seed=0, trainable=True)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.new_empty(0)
    torch.cuda.empty_cache()
    trainer = Trainer(model, cfg, TrainerConfig(steps=steps))
    box = [state]
    del state
    state, prof = _step_profile(trainer._step_fn, box, tokens, labels,
                                extra=extra)
    _log_profile(f"{arch} at {cfg.num_layers} layers", prof)
    out["trainer"]["profile"] = prof
    out["trainer"]["count"] = _log_count(
        f"{arch} at {cfg.num_layers} layers",
        _step_count(cfg, tokens, labels, extra), prof, smi)
    del state, trainer, model, tokens, labels, extra
    torch.cuda.empty_cache()
    return out, counts


def _no_remat_step(arch, B, S, lr):
    """One ``make_train_step`` step of ``arch`` at full width with remat
    off: its peak memory (allocated, reserved), or the card's refusal. The
    measure of what remat buys beside the Trainer's run under it."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import step as tstep
    cfg = get_config(arch).replace(remat=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"arch": arch, "batch": B, "seq": S, "remat": None}
    model = build_model(cfg, device="cuda", seed=0, trainable=True)
    tokens, labels, extra = _batch_tensors(cfg, B, S)
    try:
        state = tstep.init_state(model)
        t0 = time.perf_counter()
        state, m = tstep.make_train_step(model, cfg, lr)(state, tokens,
                                                         labels, extra)
        out["loss"] = float(m["loss"])
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0
        out["result"] = "ran"
    except torch.OutOfMemoryError as e:
        out["result"] = "out of memory"
        out["error"] = str(e).splitlines()[0][:160]
    state = m = None
    gc.collect()
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    log(f"[train] {arch} one step without remat (B {B} x S {S}): "
        f"{out['result']}"
        + (f", loss {out['loss']:.4f} in {out['step_s']:.2f} s"
           if out["result"] == "ran" else f" ({out['error']})")
        + f"; memory at its peak {out['peak_allocated_gb']:.2f} GB "
        f"allocated, {out['peak_reserved_gb']:.2f} GB reserved")
    del model, tokens, labels, extra
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _with_cfg(model, cfg):
    """Every module of ``model`` that holds a config holds ``cfg``."""
    for m in model.modules():
        if "cfg" in vars(m):
            m.cfg = cfg


def _remat_hold(arch, layers, B, S, lr, tiny, fails, smi):
    """Two ``make_train_step`` steps of one model under each of REMAT_RUNS
    from the same initial state (the second step after the AdamW update,
    so the state's weights differ from the module's): the losses and the
    second step's every gradient leaf, as the step hands them to AdamW,
    held bitwise against no remat's (where no remat's own second run
    differs, at REMAT_REPEAT_RATIO times that distance); each run's launches
    held to the count the code makes, its step ms (host clock,
    synchronized, the median of steps 3 and 4), peak memory, and a fifth
    step profiled by part. Returns (record, launches)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import step as tstep
    cfg = get_config(arch)
    cfg = cfg.tiny() if tiny else cfg
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    model = build_model(cfg, device="cuda", seed=0, trainable=True)
    tokens, labels, _ = _batch_tensors(cfg, B, S)
    real_update, seen = tstep.adamw_update, {}

    def capture(params, grads, *a, **k):
        seen["grads"] = grads
        return real_update(params, grads, *a, **k)
    runs, want, total = {}, None, {}
    try:
        for name, policy in REMAT_RUNS:
            c = cfg.replace(remat=policy is not None,
                            remat_policy=policy or "full")
            _with_cfg(model, c)
            step = tstep.make_train_step(model, c, lr)
            state = tstep.init_state(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_all()
            walls, losses = [], []
            for i in range(2):
                # the second step's gradients only: the first's would stay
                # alive through the second step
                tstep.adamw_update = capture if i else real_update
                t0 = time.perf_counter()
                state, m = step(state, tokens, labels)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
            tstep.adamw_update = real_update
            grads = seen.pop("grads")
            counts = _lm_launches()
            expect = _train_launches(c, 2)
            got = {k: counts[k] for k in expect}
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            run = {"first_steps_ms": [1e3 * w for w in walls],
                   "losses": losses,
                   "peak_allocated_gb": torch.cuda.max_memory_allocated()
                   / 1e9,
                   "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                   "launches_a_step": {k: n / 2 for k, n in got.items()
                                       if n}}
            if got != expect:
                fails.append(f"remat {arch} {name} launches {got}, not "
                             f"{expect}")
            if want is None:
                want = (losses, {k: g.cpu() for k, g in grads.items()})
            else:
                # leaf by leaf on the card, no remat's copied back in turn
                rels = {}
                for k, g in grads.items():
                    w = want[1][k].to(g.device)
                    rels[k] = (0.0 if torch.equal(g, w)
                               else _rel_l2(g.float(), w.float()))
                    del w
                run["bitwise"] = (losses == want[0]
                                  and not any(rels.values()))
                run["worst_rel_l2"] = max(rels.values())
                run["median_rel_l2"] = float(np.median(list(rels.values())))
            del grads
            if name != "none again":
                box = [state]
                del state
                state, run["profile"] = _step_profile(step, box, tokens,
                                                      labels, steps=1, warm=2)
                run["step_ms"] = run["profile"]["warm_ms"]
            runs[name] = run
            del state, step
            torch.cuda.empty_cache()
    finally:
        tstep.adamw_update = real_update
        _with_cfg(model, cfg)
    repeat = runs["none again"]
    for name in ("full", "dots"):
        r = runs[name]
        if repeat["bitwise"]:
            r["held"] = r["bitwise"]
        else:
            r["held"] = (r["worst_rel_l2"] <= REMAT_REPEAT_RATIO
                         * repeat["worst_rel_l2"]
                         and r["median_rel_l2"] <= REMAT_REPEAT_RATIO
                         * repeat["median_rel_l2"])
        if not r["held"]:
            fails.append(f"remat {arch} {name}: gradients differ from no "
                         f"remat's (worst rel L2 {r['worst_rel_l2']:.3e})")
    log(f"[train] remat {arch}{' (tiny)' if tiny else ''} at "
        f"{cfg.num_layers} layers, B {B} x S {S}, two steps each, the "
        f"second after an update: no remat twice "
        + ("bitwise" if repeat["bitwise"] else
           f"NOT bitwise (worst rel L2 {repeat['worst_rel_l2']:.3e}, median "
           f"{repeat['median_rel_l2']:.3e})")
        + "; " + "; ".join(
            f"{n} " + ("bitwise" if runs[n]["bitwise"] else
                       f"worst rel L2 {runs[n]['worst_rel_l2']:.3e}")
            + (" held" if runs[n]["held"] else " FAIL")
            for n in ("full", "dots")) + f" ({smi})")
    for name in ("none", "full", "dots"):
        r, prof = runs[name], runs[name]["profile"]
        log(f"[train]   {name:5s} step {r['step_ms']:.1f} ms (host, median "
            f"of steps 3-4), peak {r['peak_allocated_gb']:.2f} GB allocated / "
            f"{r['peak_reserved_gb']:.2f} reserved; profiled step wall "
            f"{prof['wall_ms']:.1f} ms, device "
            + (f"{prof['device_ms']:.1f}" if prof["device_ms"] else
               "not measured") + " ms ("
            + ", ".join(f"{p} {ms:.2f}" for p, ms in prof["parts_ms"].items())
            + f"), peak {prof['peak_allocated_gb']:.2f} / "
            f"{prof['peak_reserved_gb']:.2f} GB; launches a step "
            f"{r['launches_a_step']}")
    del model, tokens, labels
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.num_layers, "tiny": tiny,
            "batch": B, "seq": S, "runs": runs}, total


def _tiny_card_step(arch, B, S, fails):
    """The tiny ``arch`` (float32) one step on the card against the same
    weights and batch on the CPU: the loss within TINY_LOSS_TOL relative,
    every gradient leaf's relative L2 reported and held at TINY_GRAD_TOL.
    A miss is reported with each layer's reading on the CPU path's own
    input (its gradients in its input and parameters, card against CPU),
    not failed: ROADMAP.md section 3 logs it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticStream
    from repro_torch.models import build_model
    from repro_torch.models.layers import embed_lookup
    from repro_torch.train.loss import softmax_xent
    cfg = get_config(arch).tiny()
    cpu = build_model(cfg, device="cpu", seed=0, trainable=True)
    gpu = build_model(cfg, device="cuda", seed=1, trainable=True)
    gpu.load_state_dict(cpu.state_dict())
    batch = SyntheticStream(cfg, S, B, seed=0).batch_at(0)

    def step(model, dev):
        tokens = torch.as_tensor(batch.tokens, device=dev)
        labels = torch.as_tensor(batch.labels, device=dev)
        params = dict(model.named_parameters())
        loss, _ = softmax_xent(model.apply(tokens), labels, cfg.vocab_size)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), {n: g.cpu()
                                      for n, g in zip(params, grads)}
    _reset_all()
    loss_g, grads_g = step(gpu, "cuda")
    counts = _lm_launches()
    loss_c, grads_c = step(cpu, "cpu")
    rels = {n: _rel_l2(grads_g[n], grads_c[n]) for n in grads_c}
    worst = max(rels, key=rels.get)
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    held = loss_rel < TINY_LOSS_TOL and rels[worst] < TINY_GRAD_TOL
    want = {k: v for k, v in _train_launches(cfg, 1).items()}
    log(f"[train] tiny {arch} float32 one step card against CPU (B {B} x S "
        f"{S}): loss {loss_g:.7f} vs {loss_c:.7f} (rel {loss_rel:.2e}, tol "
        f"{TINY_LOSS_TOL:g}); gradient rel L2 worst {rels[worst]:.3e} "
        f"({worst}, tol {TINY_GRAD_TOL:g}); every leaf: "
        + " ".join(f"{n}={r:.1e}" for n, r in sorted(rels.items()))
        + f"; launches {({k: counts[k] for k in want})}, expected {want}"
        + ("" if held else "  MISS (reported: ROADMAP.md section 3)"))
    if {k: counts[k] for k in want} != want:
        fails.append(f"tiny {arch} launches")
    out = {"arch": arch, "loss_card": loss_g, "loss_cpu": loss_c,
           "loss_rel": loss_rel, "worst_leaf": worst,
           "worst_rel_l2": rels[worst], "rel_l2": rels, "held": held}
    if not held:
        by_layer = []
        pos_c, pos_g = (m._positions(B, S) for m in (cpu, gpu))
        g = torch.Generator().manual_seed(12)
        with torch.no_grad():
            x = embed_lookup(cpu.embed, torch.as_tensor(batch.tokens), cfg)
        for i, (bc, bg) in enumerate(zip(cpu.layers, gpu.layers)):
            dy = torch.randn(tuple(x.shape), generator=g)

            def grads(model, blk, pos, dev):
                xl = x.to(dev).requires_grad_(True)
                y, _ = model._block_apply(blk, xl, pos)
                return [t.cpu() for t in torch.autograd.grad(
                    y, [xl] + list(blk.parameters()), dy.to(dev))]
            r = max(_rel_l2(a, b) for a, b in zip(
                grads(gpu, bg, pos_g, "cuda"), grads(cpu, bc, pos_c, "cpu")))
            by_layer.append(r)
            with torch.no_grad():
                x, _ = cpu._block_apply(bc, x, pos_c)
        log(f"[train] tiny {arch} each layer on the CPU path's own input, "
            f"card against CPU, worst gradient rel L2 by layer ("
            + ", ".join(f"{b.spec.mixer}/{b.spec.mlp}" for b in cpu.layers)
            + "): " + " ".join(f"{r:.1e}" for r in by_layer))
        out["by_layer"] = by_layer
    return out, counts


def _full_width_grads(model, cfg, tokens, labels, plain, extra=None):
    """(loss, {name: grad}) of the model's first step on its own weights
    (``extra``: Whisper's frames): through the kernels, or through the
    plain ops. Either way the config's remat (every arch's default)
    recomputes each unit in its backward: the plain attention's per-block
    probabilities of 32 layers would not fit the card otherwise, and
    recomputation changes no value."""
    import torch
    from repro_torch.train.loss import softmax_xent
    if not cfg.remat:
        raise ValueError("the full-width holds run with the config's remat")
    params = dict(model.named_parameters())
    args = (tokens,) if extra is None else (tokens, extra)
    with _plain_train_ops() if plain else nullcontext():
        loss, _ = softmax_xent(model.apply(*args), labels, cfg.vocab_size)
        grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _cut(cfg, depth):
    """``cfg`` at ``depth`` layers; an encoder-decoder's both stacks."""
    if cfg.is_encoder_decoder:
        return cfg.replace(num_layers=depth, num_encoder_layers=depth)
    return cfg.replace(num_layers=depth)


def _batch_tensors(cfg, B, S):
    """SyntheticStream's first batch on the card: tokens, labels and the
    frames or patches (None where the arch takes none)."""
    import torch
    from repro_torch.data import SyntheticStream
    batch = SyntheticStream(cfg, S, B, seed=0).batch_at(0)
    return tuple(None if a is None else torch.as_tensor(a, device="cuda")
                 for a in (batch.tokens, batch.labels, batch.extra_embeds))


def _step_profile(step_fn, box, tokens, labels, steps=2, extra=None,
                  warm=1):
    """Steps of the Trainer's step function on the host clock and under
    torch.profiler: device time by part of the step and the busy share,
    and the memory these steps held at their peak (allocated, and reserved
    by the caching allocator) beside the card's. ``box`` is a one-element
    list holding the state, which this takes out, so that no caller keeps
    an old state alive beside two new ones (a full-width Mamba2 state is
    ~28 GB). The ``warm`` unprofiled steps first are timed too
    (``warm_ms``: their median, host clock, synchronized)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    state = box.pop()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        state, _ = step_fn(state, tokens, labels, extra)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    warm_ms = float(np.median(walls))
    # the device's activity only: the host's op records would cost the
    # step's wall time and seconds of processing, and are not read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step_fn(state, tokens, labels, extra)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    by_name, launches = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3 / steps)
            launches[e.key] = launches.get(e.key, 0) + e.count / steps
    parts = {p: 0.0 for p, _ in STEP_PARTS}
    parts["other (elementwise, loss, optimizer)"] = 0.0
    for n, ms in by_name.items():
        part = next((p for p, syms in STEP_PARTS
                     if any(s in n for s in syms)), None)
        parts[part or "other (elementwise, loss, optimizer)"] += ms
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # each backward launch: dK/dV, dQ, D_i, the norm's dx pass, its dw sum
    bwd = [{"name": n, "ms": ms, "launches": launches[n],
            "ms_per_launch": ms / launches[n]}
           for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])
           if any(p in n for p in STEP_PARTS[0][1])]
    card = torch.cuda.get_device_properties(0).total_memory
    return state, {"wall_ms": wall_ms, "warm_ms": warm_ms,
                   "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                   "card_gb": card / 1e9,
                   "device_ms": dev_ms if dev_ms > 0 else None,
                   "busy_share": dev_ms / wall_ms if dev_ms > 0 else None,
                   "parts_ms": parts, "backward": bwd,
                   "top": [{"name": n, "ms": ms} for n, ms in top]}


def _step_count(cfg, tokens, labels, extra=None):
    """The dry run's count of one ``make_train_step`` step of ``cfg`` on
    one chip, on meta tensors of the batch's shapes
    (``launch.roofline.counting``): its terms at the H100's datasheet rates
    (bounds, not measurements), ``model_flops`` and the peak of live
    tensors, with the state counted live from the start."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train.step import init_state, make_train_step
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta", seed=0, trainable=True)
    state = init_state(model)
    step = make_train_step(model, cfg, cosine_schedule(3e-4, 20, 100))

    def meta(t):
        return None if t is None else torch.empty_like(t, device="meta")
    with RL.counting() as cnt:
        RL.track(state)
        step(state, meta(tokens), meta(labels), meta(extra))
    B, S = labels.shape
    terms = RL.roofline_terms(cnt, 1)
    return {"flops": cnt.flops, "hbm_bytes": cnt.hbm_bytes,
            "compute_ms": 1e3 * terms["compute_s"],
            "memory_ms": 1e3 * terms["memory_s"],
            "bound_ms": 1e3 * terms["step_lower_bound_s"],
            "dominant": terms["dominant"],
            "model_flops": RL.model_flops(cfg, ShapeSpec("step", S, B,
                                                         "train")),
            "peak_gb": cnt.peak_bytes / 1e9,
            "kernels": cnt.kernels, "count_s": time.perf_counter() - t0}


def _log_count(tag, count, prof, smi):
    """The dry run's count beside a measured step (``_step_profile``): the
    measured device time as a multiple of the count's bound, and the
    count's peak beside the measured one."""
    dev = prof.get("device_ms")
    count["device_over_bound"] = dev / count["bound_ms"] if dev else None
    count["peak_gap"] = (prof["peak_allocated_gb"] / count["peak_gb"] - 1
                         if count["peak_gb"] else None)
    log(f"[train] {tag} dry-run count of the same step on one chip "
        f"({count['count_s']:.1f} s on the host): compute "
        f"{count['compute_ms']:.2f} ms, memory {count['memory_ms']:.2f} ms "
        f"at the datasheet rates (bound {count['bound_ms']:.2f} ms, "
        f"{count['dominant']}), {count['flops']:.4g} FLOPs counted against "
        f"model_flops {count['model_flops']:.4g}; measured device "
        + (f"{dev:.2f} ms = {count['device_over_bound']:.2f}x the bound"
           if dev else "time not measured")
        + f"; the count's peak {count['peak_gb']:.2f} GB beside "
        f"max_memory_allocated {prof['peak_allocated_gb']:.2f} GB (measured "
        f"{100 * count['peak_gap']:+.1f}%) ({smi})")
    return count


def _log_profile(tag, prof, opt_ms=None):
    """One line of a ``_step_profile``: wall and device ms, busy share, the
    parts; then the top kernels and each backward kernel a step and a
    launch."""
    log(f"[train] {tag} one step under torch.profiler: wall "
        f"{prof['wall_ms']:.1f} ms, device "
        + (f"{prof['device_ms']:.1f} ms, busy share {prof['busy_share']:.3f}"
           if prof['device_ms'] else "time not measured")
        + "; by part: " + ", ".join(f"{p} {ms:.2f} ms"
                                    for p, ms in prof["parts_ms"].items())
        + ("; the AdamW update alone "
           + (f"{opt_ms:.2f} ms" if opt_ms else "not measured")
           if opt_ms is not None else "")
        + f"; memory at its peak {prof['peak_allocated_gb']:.2f} GB "
        f"allocated, {prof['peak_reserved_gb']:.2f} GB reserved, of the "
        f"card's {prof['card_gb']:.2f} GB")
    for t in prof["top"]:
        log(f"[train]   {t['ms']:8.3f} ms  {t['name'][:90]}")
    for t in prof["backward"]:
        log(f"[train]   backward launch {t['ms']:8.3f} ms a step, "
            f"{t['launches']:.0f} launches, {t['ms_per_launch']:.4f} ms a "
            f"launch  {t['name'][:80]}")


def _optimizer_device_ms(state):
    """Device ms of one AdamW update of the full-width state (the step's
    optimizer), under torch.profiler."""
    import torch
    from repro_torch.optim import adamw
    grads = {k: torch.ones_like(p) for k, p in state.params.items()}
    lr = adamw.cosine_schedule(3e-4, 20, 100)
    ms = _device_ms(lambda: adamw.adamw_update(state.params, grads,
                                               state.opt, lr), reps=3)
    del grads
    return ms


def _layer_specs(cfg):
    """The layers ``models.LM`` builds for ``cfg``, in order."""
    from repro_torch.configs.base import LayerSpec
    specs = [cfg.pattern[i % cfg.pattern_len]
             for i in range(cfg.num_repeats * cfg.pattern_len)]
    if cfg.first_layer_dense:
        specs.insert(0, LayerSpec(cfg.pattern[0].mixer, "dense"))
    return specs


def _train_launches(cfg, steps):
    """Model-kernel launches of ``steps`` standard steps, counted from the
    code (``models/transformer.py``, ``whisper.py``, ``attention.py``,
    ``mla.py``, ``ssm.py``): per layer ln1, ln2 where it has an MLP, and
    its mixer's: attention one flash_attention (and the q/k norms with
    qk_norm), MLA one flash_attention and its kv_norm, mamba one ssd_scan
    and its gated norm; then the final norm. Whisper: an encoder layer two
    norms and its attention, a decoder layer three norms, its self- and
    its cross-attention, then the encoder's norm and the final one; the
    float32 frames make the encoder and the cross-attention float32. Each
    backward kernel launches once; each forward kernel once, and with
    ``cfg.remat`` once more in the backward where it lies inside a unit
    (every layer but a first dense one; the same under "dots", which keeps
    no kernel's output). Attention's float32 calls (a float32 config's,
    Whisper's encoder and cross) are counted apart as well."""
    f32 = cfg.activation_dtype == "float32"
    # (norms, attention calls, float32 ones, scans) inside units, outside
    inside, outside = [0, 0, 0, 0], [1, 0, 0, 0]

    def add(into, norms, attn=0, attn32=0, scans=0):
        for i, n in enumerate((norms, attn, attn32, scans)):
            into[i] += n
    if cfg.is_encoder_decoder:
        if cfg.qk_norm:
            raise ValueError("Whisper's launches are counted without qk_norm")
        add(inside, 2 * cfg.num_encoder_layers, cfg.num_encoder_layers,
            cfg.num_encoder_layers)
        add(inside, 3 * cfg.num_layers, 2 * cfg.num_layers,
            cfg.num_layers * (2 if f32 else 1))
        add(outside, 1)
    else:
        for i, spec in enumerate(_layer_specs(cfg)):
            into = outside if i == 0 and cfg.first_layer_dense else inside
            norms = 1 + (spec.mlp != "none")
            if spec.mixer == "mamba":
                add(into, norms + 1, scans=1)
            elif spec.mixer == "mla":
                add(into, norms + 1, 1, int(f32))
            else:
                add(into, norms + (2 if cfg.qk_norm else 0), 1, int(f32))
    again = 2 if cfg.remat else 1
    fwd = [(a * again + b) * steps for a, b in zip(inside, outside)]
    bwd = [(a + b) * steps for a, b in zip(inside, outside)]
    return {"rmsnorm": fwd[0], "rmsnorm_bwd": bwd[0],
            "flash_attention": fwd[1], "flash_attention_bwd": bwd[1],
            "flash_attention_f32": fwd[2], "flash_attention_bwd_f32": bwd[2],
            "ssd_scan": fwd[3], "ssd_scan_bwd": bwd[3]}


def _part_launches(cfg, history):
    """Launches of the partitioned trainer's run, counted from the code and
    the splits the run recorded: each step one balancer solve, which for
    two pods is ``optimize_2ch`` (one ``frontier_grid`` call; the PGD
    refresh, ``frontier_grid_with_grads``, runs for three pods or more, or
    with risk or adaptive refresh, as in the reference), and, on a one-pod
    mesh, k[0] microsteps (the recorded split is already clipped to
    ``max_micro``), each a standard step's model kernels. Nothing
    decodes or scans, and no norm runs on split rows (no TP axis)."""
    micro = sum(json.loads(h["k_pods"])[0] for h in history)
    return {"fwd": len(history), "grad": 0, "pgrad": 0,
            **_train_launches(cfg, micro), "flash_decode": 0,
            "flash_decode_partial": 0,
            **{k: 0 for k in SPLIT_KERNELS}}


def phase_train(ctx):
    """The training path on the card (see the module docstring): the
    backward kernels against their plain versions, the full-width first
    step against the plain ops, the Trainer's timed run with its launches,
    kill and restore, the partitioned trainer, the remat holds
    (REMAT_HOLDS), h2o-danube-1.8b's step without remat, then TRAIN_ARCHS
    at full width and the tiny Jamba card against CPU."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.bench import train_partitioned as tp
    from repro_torch.configs import get_config
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.models import build_model
    from repro_torch.train import Trainer, TrainerConfig
    fails = []
    out = {}
    smi = ctx.get("smi")
    t_part = [time.perf_counter()]

    def part_done(what):
        now = time.perf_counter()
        log(f"[train] {what} in {now - t_part[0]:.1f} s")
        t_part[0] = now
    if ctx.get("f32_terms", 3) != 3:
        # the --f32-terms control: float32 attention's holds alone, the
        # backward cases and the tiny Jamba's step card against CPU
        out["attention"] = [_bwd_attn_case(c, fails) for c in BWD_ATTN_CASES
                            if c[-1] == "float32"]
        out["tiny"], _ = _tiny_card_step(TINY_TRAIN_ARCH, TINY_TRAIN_B,
                                         TINY_TRAIN_S, fails)
        if fails:
            raise AssertionError(f"train phase failed: {fails}")
        return

    # 1. the backward kernels against autograd of their plain forwards
    out["attention"] = [_bwd_attn_case(c, fails) for c in BWD_ATTN_CASES]
    out["rmsnorm"] = [_bwd_norm_case(c, fails) for c in BWD_NORM_CASES]
    out["ssd"] = [_ssd_bwd_case(c, fails) for c in BWD_SSD_CASES]
    for r in out["attention"] + out["rmsnorm"] + out["ssd"]:
        tag = r.get("name") or f"{r['rows']}x{r['D']} {r['dtype']}"
        if r["device_ms"] is None:
            fails.append(f"{tag}: the kernel's device time not measured")
        if r["library_ms"] is not None and r["library_dev_ms"] is None:
            fails.append(f"{tag}: the library's device time not measured")
    if fails:
        raise AssertionError(f"train phase: backward kernels failed {fails}")
    part_done("1. the backward kernels' cases")

    # 2. the full-width first step: kernels against the plain ops
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    tokens, labels, _ = _batch_tensors(cfg, TRAIN_B, TRAIN_S)
    t0 = time.perf_counter()
    loss_k, grads_k = _full_width_grads(model, cfg, tokens, labels, False)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    peak_k = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    loss_p, grads_p = _full_width_grads(model, cfg, tokens, labels, True)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    rels = {n: _rel_l2(grads_k[n].float(), grads_p[n].float())
            for n in grads_k}
    worst = max(rels, key=rels.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    log(f"[train] {cfg.name} full width ({n_params / 1e6:.1f} M parameters, "
        f"bf16) first step on B={TRAIN_B} x S={TRAIN_S}: loss kernels "
        f"{loss_k:.6f} plain {loss_p:.6f} (rel {loss_rel:.2e}, tol "
        f"{TRAIN_LOSS_TOL:g}); gradient rel L2 worst {rels[worst]:.3e} "
        f"({worst}), median {np.median(list(rels.values())):.3e} (tol "
        f"{TRAIN_GRAD_TOL:g}), finite {finite}; kernels {k_s:.2f} s (peak "
        f"{peak_k / 1e9:.2f} GB), plain with per-layer recompute {p_s:.2f} s")
    if not (loss_rel < TRAIN_LOSS_TOL and rels[worst] < TRAIN_GRAD_TOL
            and finite):
        raise AssertionError(f"full-width step disagrees: loss {loss_rel}, "
                             f"{worst} {rels[worst]}")
    out["full_width"] = {"arch": cfg.name, "params": n_params,
                         "loss_kernels": loss_k, "loss_plain": loss_p,
                         "loss_rel": loss_rel, "worst_leaf": worst,
                         "worst_rel_l2": rels[worst],
                         "median_rel_l2": float(np.median(
                             list(rels.values()))),
                         "first_step_s": k_s, "plain_step_s": p_s}
    del grads_k, grads_p
    torch.cuda.empty_cache()
    part_done("2. the full-width first step, kernels and plain")

    # 3. TRAIN_STEPS steps through the training CLI (Trainer, seed 0: the
    # same weights), launches counted from zero
    state, rec, counts = _trainer_run(
        cfg, ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
              str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", "3e-4"],
        TRAIN_B, TRAIN_S, TRAIN_STEPS, fails, smi)
    ctx["train_launches"] = dict(counts)
    trainer = Trainer(model, cfg, TrainerConfig(steps=TRAIN_STEPS))
    box = [state]
    del state
    state, prof = _step_profile(trainer._step_fn, box, tokens, labels)
    opt_ms = _optimizer_device_ms(state)
    _log_profile(cfg.name, prof, opt_ms)
    count = _log_count(cfg.name, _step_count(cfg, tokens, labels), prof, smi)
    out["trainer"] = {**rec, "profile": prof, "optimizer_device_ms": opt_ms,
                      "count": count}
    del state, trainer
    torch.cuda.empty_cache()
    part_done("3. the Trainer's run and its profiled step")

    # 4. kill after step TRAIN_KILL_AT, restore, the next step bitwise the
    # uninterrupted run
    with tempfile.TemporaryDirectory() as d:
        kcfg = TrainerConfig(steps=TRAIN_KILL_AT + 1, batch=TRAIN_B,
                             seq=TRAIN_S, lr=3e-4, warmup=5, log_every=100,
                             seed=0, ckpt_dir=d, ckpt_interval=TRAIN_KILL_AT)
        t0 = time.perf_counter()
        whole, wh = Trainer(model, cfg, kcfg).run()
        restored, rh = Trainer(model, cfg, kcfg).run()
        torch.cuda.synchronize()
        kill_s = time.perf_counter() - t0
    same_loss = rh[0]["step"] == TRAIN_KILL_AT and \
        rh[0]["loss"] == wh[TRAIN_KILL_AT]["loss"]
    same_params = all(torch.equal(whole.params[k], restored.params[k])
                      for k in whole.params)
    log(f"[train] killed after step {TRAIN_KILL_AT} and restored from its "
        f"checkpoint: step {TRAIN_KILL_AT + 1} loss {rh[0]['loss']:.6f} vs "
        f"{wh[TRAIN_KILL_AT]['loss']:.6f} uninterrupted, loss "
        + ("bitwise" if same_loss else "DIFFERENT") + ", params "
        + ("bitwise" if same_params else "DIFFERENT") + f" ({kill_s:.1f} s "
        f"with the checkpoint's write and read)")
    if not (same_loss and same_params):
        fails.append("kill/restore")
    out["restore_bitwise"] = bool(same_loss and same_params)
    del whole, restored, model
    torch.cuda.empty_cache()
    part_done("4. kill and restore")

    # 5. the partitioned trainer at full width, launches counted from zero
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    res = tp.run(steps=PART_STEPS, full_360m=True, device="cuda")
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    pcounts = {**dict(fg.LAUNCHES), **_lm_launches()}
    pwant = _part_launches(cfg, res["history"])
    s = res["summary"]
    log(f"[train] bench.train_partitioned --full-360m, {PART_STEPS} steps in "
        f"{part_s:.1f} s: loss first10 {s['first10']:.4f} last10 "
        f"{s['last10']:.4f} (falls: asserted); simulated join mean "
        f"{s['join_mean']:.4f} s var {s['join_var']:.5f} p99 "
        f"{s['join_p99']:.4f} s; final split {s['k_last']}; launches "
        f"{pcounts}, expected {pwant} ({smi})")
    if pcounts != pwant:
        fails.append(f"the partitioned trainer's launches {pcounts}, not "
                     f"{pwant}")
    for k, n in pcounts.items():
        ctx["train_launches"][k] = ctx["train_launches"].get(k, 0) + n
    out["partitioned"] = {**s, "steps": PART_STEPS, "seconds": part_s,
                          "launches": pcounts}
    part_done("5. the partitioned trainer")

    # 6. remat: two steps under no remat, "full" and "dots", bitwise
    out["remat"] = []
    for arch, layers, B, S, lr, tiny in REMAT_HOLDS:
        t0 = time.perf_counter()
        res, counts = _remat_hold(arch, layers, B, S, lr, tiny, fails, smi)
        res["seconds"] = time.perf_counter() - t0
        part_done(f"6. the remat hold of {arch}")
        out["remat"].append(res)
        for k, n in counts.items():
            ctx["train_launches"][k] = ctx["train_launches"].get(k, 0) + n

    # 7. Mamba2-2.7B, DeepSeek-V2-Lite, h2o-danube-1.8b and Whisper-large-v3
    # at full width: every layer held, the first step end to end at a cut
    # depth, the Trainer's steps counted; danube's step once without remat
    out["no_remat"] = _no_remat_step(*NO_REMAT_TRY)
    part_done(f"7. {NO_REMAT_TRY[0]}'s step without remat")
    out["archs"] = []
    for arch, layers, B, S, holds, steps, lr in TRAIN_ARCHS:
        t0 = time.perf_counter()
        res, counts = _train_arch(arch, layers, B, S, holds, steps, lr,
                                  fails, smi)
        res["seconds"] = time.perf_counter() - t0
        part_done(f"7. {arch}")
        out["archs"].append(res)
        for k, n in counts.items():
            ctx["train_launches"][k] = ctx["train_launches"].get(k, 0) + n

    # 8. the tiny Jamba, card against CPU, launches counted from zero
    out["tiny"], counts = _tiny_card_step(TINY_TRAIN_ARCH, TINY_TRAIN_B,
                                          TINY_TRAIN_S, fails)
    for k, n in counts.items():
        ctx["train_launches"][k] = ctx["train_launches"].get(k, 0) + n
    ctx["train"] = out
    if fails:
        raise AssertionError(f"train phase failed: {fails}")


# shard: Qwen3-8B's decode at decode_32k (B, Hkv, G, D, S) in SHARD_SEQ
# sequence shards; DeepSeek-V2-Lite's MoE layer on SHARD_MOE_TOKENS (B, S)
# at each (data, model) of SHARD_MOE_MESHES; the world of one's prefill
# of B 2 x SHARD_PROMPT and SHARD_STEPS greedy decode steps
SHARD_DECODE = (32, 8, 4, 128, 32768)
SHARD_SEQ = 4
SHARD_MOE_TOKENS = (2, 2048)
SHARD_MOE_MESHES = ((1, 2), (1, 4), (2, 2))
SHARD_PROMPT, SHARD_STEPS = 16, 16
# the rank-emulated bf16 MoE layer's hold (relative L2): the sound
# emulation reads ~2e-3 (bf16 partials summed), capacity counted over the
# whole batch instead of each data shard's tokens reads far above it
MOE_HOLD = 1e-2
# the shared direction added to the MoE layer's tokens (times a standard
# normal vector), so that the router's loads are uneven, as a trained
# router's are, and capacity drops copies (none would drop without it)
MOE_SKEW = 0.25
# the partial kernel against its plain version, both float32 sums of the
# same widened inputs: m absolutely, l relatively, acc relative to l, and
# acc / l elementwise, at the float32 tolerance
PARTIAL_TOL = LM_TOL["float32"]


def _partial_inputs(B, Hkv, G, S, D, dtype, mode, seed):
    """q, k, v, valid of a shard: ``mask`` 70% of the slots valid,
    ``empty`` none, ``neg`` every valid logit near -119 (q about 1, k
    about -10.5)."""
    import torch
    g = _gen(seed)
    f32 = torch.float32
    q = _randn(g, (B, Hkv, G, D), f32)
    k = _randn(g, (B, Hkv, S, D), f32)
    v = _randn(g, (B, Hkv, S, D), f32)
    valid = torch.rand(S, generator=g, device="cuda") < 0.7
    if mode == "empty":
        valid[:] = False
    elif mode == "neg":
        q = 1.0 + 0.1 * q
        k = -10.5 + 0.5 * k
        valid[0] = True
    return q.to(dtype), k.to(dtype), v.to(dtype), valid


def _partial_holds(got, want):
    """Whether a partial (m, l, acc) holds against ``want``: m absolutely,
    l relatively and acc relative to l at PARTIAL_TOL (the rounding of a
    float32 logit grows with its size, and l and acc with the number of
    valid slots), and acc / l elementwise at PARTIAL_TOL."""
    import torch
    m, l, acc = got
    wm, wl, wacc = want
    out = acc / l.clamp(min=1e-30)
    out_want = wacc / wl.clamp(min=1e-30)
    return (bool(((m - wm).abs() <= PARTIAL_TOL).all())
            and bool(((l - wl).abs() <= PARTIAL_TOL * wl).all())
            and bool(((acc - wacc).abs() <= PARTIAL_TOL * wl).all())
            and bool(torch.allclose(out, out_want, atol=PARTIAL_TOL,
                                    rtol=PARTIAL_TOL)))


def _shard_partial_checks(fails):
    """(c) flash_decode_partial against its plain version, bf16 and
    float32, twice (the bits repeat): one split, several, decode_32k's
    shard, a shard with no valid slot (m = -1e30, l = 0, acc = 0 exactly)
    and one whose valid logits are all below -100 (:func:`_partial_holds`
    for each)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    cases = (("one split", 2, 8, 4, 200, 128, "mask"),
             ("several splits", 4, 2, 4, 2048, 128, "mask"),
             ("G 16, D 64", 2, 4, 16, 1024, 64, "mask"),
             ("decode_32k shard", 32, 8, 4, 8192, 128, "mask"),
             ("no valid slot", 4, 8, 4, 2048, 128, "empty"),
             ("all valid logits below -100", 4, 8, 4, 2048, 128, "neg"))
    for dtype in (torch.bfloat16, torch.float32):
        for n, (tag, B, Hkv, G, S, D, mode) in enumerate(cases):
            q, k, v, valid = _partial_inputs(B, Hkv, G, S, D, dtype, mode,
                                             300 + n)
            splits = fd.decode_splits(B, Hkv, S, sm)[0]
            a = fd.flash_decode_partial(q, k, v, valid)
            b = fd.flash_decode_partial(q, k, v, valid)
            want = ref.decode_attention_partial_ref(q, k, v, valid,
                                                    splits=splits)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            errs = [float((x - y).abs().max()) for x, y in zip(a, want)]
            ok = same and _partial_holds(a, want)
            if mode == "empty":
                ok &= (bool((a[0] == ref.NEG_INF).all())
                       and not bool(a[1].any()) and not bool(a[2].any()))
            if mode == "neg":
                m_max = float(a[0].max())
                ok &= m_max < -100
            dt = str(dtype).split(".")[-1]
            log(f"[shard] partial {dt:8s} {tag:30s} (B={B}, Hkv={Hkv}, G={G}"
                f", S={S}, D={D}, {splits} splits): max|err| m {errs[0]:.2e}"
                f" l {errs[1]:.2e} acc {errs[2]:.2e}, bits repeat {same} "
                + ("ok" if ok else "FAIL"))
            rows.append({"case": tag, "dtype": dt, "shape": [B, Hkv, G, S, D],
                         "splits": splits, "max_abs_err": errs,
                         "repeat": same, "ok": ok})
            if not ok:
                fails.append(f"partial {dt} {tag}")
            del q, k, v, valid, a, b, want
    torch.cuda.empty_cache()
    return rows


def _shard_moe_ranks(fails):
    """(b) DeepSeek-V2-Lite's MoE layer at full width, every rank's body in
    one process at each (data, model), the partials summed in rank order,
    against the unsharded layer on each data shard's tokens (relative L2 <
    MOE_HOLD); twice (the bits repeat). The tokens share a direction
    (MOE_SKEW) so that capacity drops copies; with data > 1 the unsharded
    layer on the whole batch, whose capacity counts every token, must
    differ from the per-shard reference by more than MOE_HOLD."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-lite-16b")
    g = _gen(41)
    p = {k: t.detach() for k, t in moe.moe_init(cfg, g, "cuda").items()}
    x = (_randn(g, (*SHARD_MOE_TOKENS, cfg.d_model), torch.float32)
         + MOE_SKEW * _randn(g, (cfg.d_model,), torch.float32)
         ).to(torch.bfloat16)
    rows = []
    for data, tp in SHARD_MOE_MESHES:
        a = moe.moe_ranks(p, x, cfg, tp=tp, data=data)
        b = moe.moe_ranks(p, x, cfg, tp=tp, data=data)
        rows_per = x.shape[0] // data
        shards = x.split(rows_per)
        want = torch.cat([moe.moe_apply(p, xs, cfg) for xs in shards])
        # the copies each data shard's capacity drops
        dropped = 0
        for xs in shards:
            xt = xs.reshape(-1, cfg.d_model)
            probs = torch.softmax(xt.to(p["router"].dtype) @ p["router"], -1)
            dropped += int((~moe.route(probs, cfg.top_k, moe.capacity(
                cfg, xt.shape[0])).keep).sum())
        torch.cuda.synchronize()
        same = bool(torch.equal(a, b))
        rel = _rel_l2(a.float(), want.float())
        err = float((a.float() - want.float()).abs().max())
        ok = (same and rel < MOE_HOLD and bool(torch.isfinite(a).all())
              and dropped > 0)
        row = {"data": data, "model": tp, "rel_l2": rel, "max_abs_err": err,
               "repeat": same, "dropped_copies": dropped}
        whole_note = ""
        if data > 1:
            whole = moe.moe_apply(p, x, cfg)
            rel_whole = _rel_l2(whole.float(), want.float())
            ok &= rel_whole > MOE_HOLD
            row["whole_batch_rel_l2"] = rel_whole
            whole_note = (f"; the whole batch's capacity against it: "
                          f"relative L2 {rel_whole:.2e} (must exceed "
                          f"{MOE_HOLD:g})")
            del whole
        log(f"[shard] MoE ranks (data {data}, model {tp}) on "
            f"{SHARD_MOE_TOKENS[0]} x {SHARD_MOE_TOKENS[1]} tokens against "
            f"the unsharded layer per data shard: relative L2 {rel:.2e} "
            f"(hold {MOE_HOLD:g}), max|err| {err:.2e}, {dropped} of "
            f"{x.shape[0] * x.shape[1] * cfg.top_k} copies dropped, bits "
            f"repeat {same}{whole_note} " + ("ok" if ok else "FAIL"))
        rows.append({**row, "ok": ok})
        if not ok:
            fails.append(f"moe ranks {data}x{tp}")
    del p, x
    torch.cuda.empty_cache()
    return rows


def _shard_decode_ranks(fails):
    """(b) Qwen3-8B's decode attention at decode_32k in SHARD_SEQ sequence
    shards (each shard's partial on the kernel, combined in rank order)
    against one flash_decode over the whole cache and the plain version;
    twice (the bits repeat); timed (event pair in turns, device time) with
    one partial on one shard beside its bound, its plain version and SDPA's
    memory-efficient call with its log-sum-exp on that shard."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.models import attention
    B, Hkv, G, D, S = SHARD_DECODE
    q, k, v, valid = _decode_inputs(("", B, Hkv, G, S, D, S),
                                    torch.bfloat16, 91)
    shards = attention.seq_shards(k, v, valid, SHARD_SEQ)

    def sharded():
        return attention.lse_ranks(q, shards)

    def whole():
        return fd.flash_decode(q, k, v, valid)

    a, b = sharded(), sharded()
    want_k = whole()
    want_p = ref.decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    tol = LM_TOL["bfloat16"]
    err_k = float((a.float() - want_k.float()).abs().max())
    err_p = float((a.float() - want_p.float()).abs().max())
    ok = (same and bool(torch.isfinite(a).all())
          and bool(torch.allclose(a.float(), want_k.float(), atol=tol,
                                  rtol=tol))
          and bool(torch.allclose(a.float(), want_p.float(), atol=tol,
                                  rtol=tol)))
    log(f"[shard] decode_32k (B={B}, Hkv={Hkv}, G={G}, D={D}, S={S}) in "
        f"{SHARD_SEQ} shards: max|err| against flash_decode {err_k:.2e}, "
        f"against plain {err_p:.2e} (tol {tol:g}), bits repeat {same} "
        + ("ok" if ok else "FAIL"))
    if not ok:
        fails.append("decode_32k shards")
    del a, b, want_k, want_p
    # in turns: sharded, whole, whole, sharded
    t = [_time_cuda(f, reps=7) for f in (sharded, whole, whole, sharded)]
    sh_ms, whole_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    sh_dev = _device_ms(sharded)
    whole_dev = _device_ms(whole)
    flops, nbytes = RL.decode_work(B, Hkv, G, S, D, 2)
    whole_bound = _roof(nbytes, flops / BF16_OPS_PER_S)
    log(f"[shard] decode_32k: {SHARD_SEQ} partials + combine {sh_ms:.4f} ms "
        f"(device {sh_dev}), one flash_decode {whole_ms:.4f} ms (device "
        f"{whole_dev}); the whole cache's bound {whole_bound[0]:.4f} ms "
        f"({whole_bound[1]})")
    # one partial on one shard
    k0, v0, valid0 = shards[0]
    S0 = k0.shape[2]

    def part():
        return fd.flash_decode_partial(q, k0, v0, valid0)

    def plain():
        return ref.decode_attention_partial_ref(q, k0, v0, valid0)

    def library():
        # (B, Hkv, G, D): the G query rows of a kv head as its queries
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k0, v0, None, True)

    got, want = part(), plain()
    torch.cuda.synchronize()
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    ok_p = _partial_holds(got, want)
    if not ok_p:
        fails.append("partial at decode_32k shard")
    try:
        lib = library()
        torch.cuda.synchronize()
        lse_err = float((lib[1][..., :G].float()
                         - (got[0] + got[1].log()).squeeze(-1)).abs().max())
        t = [_time_cuda(f, reps=7) for f in (part, library, library, part)]
        ms, lib_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        lib_note = f"SDPA efficient {lib_ms:.4f} ms (its lse vs m + log l: " \
                   f"{lse_err:.2e})"
    except RuntimeError as e:        # the backend refused the shape
        ms, lib_ms = _time_cuda(part, reps=7), None
        lib_note = f"SDPA efficient refused: {str(e).splitlines()[0]}"
    plain_ms = _time_cuda(plain, reps=5, warm=1)
    dev_ms = _device_ms(part)
    flops, nbytes = RL.decode_partial_work(B, Hkv, G, S0, D, 2)
    bound = _roof(nbytes, flops / BF16_OPS_PER_S)
    log(f"[shard] flash_decode_partial on one shard (S={S0}): {ms:.4f} ms "
        f"(device {dev_ms}), plain {plain_ms:.4f} ms, {lib_note}; bound "
        f"{bound[0]:.4f} ms ({bound[1]}), kernel/bound {ms / bound[0]:.2f}x;"
        f" max|err| {err:.2e} " + ("ok" if ok_p else "FAIL"))
    del q, k, v, valid, shards, k0, v0, valid0, got, want
    torch.cuda.empty_cache()
    return {"shape": list(SHARD_DECODE), "shards": SHARD_SEQ,
            "max_abs_err_vs_kernel": err_k, "max_abs_err_vs_plain": err_p,
            "repeat": same, "sharded_ms": sh_ms, "sharded_device_ms": sh_dev,
            "whole_ms": whole_ms, "whole_device_ms": whole_dev,
            "whole_bound_ms": whole_bound[0],
            "whole_bound_by": whole_bound[1],
            "partial_row": {"shape": f"decode_32k shard (B={B}, Hkv={Hkv}, "
                                     f"G={G}, S={S0}, D={D})",
                            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                            "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": bound[0], "bound_by": bound[1]}}


def _plain(t):
    """A DTensor's global tensor (a placed model's logits); a plain tensor
    as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _greedy(model, toks):
    """Prefill and SHARD_STEPS greedy decode steps: (every step's logits,
    the greedy tokens)."""
    import torch
    with torch.no_grad():
        logits, cache = model.prefill(toks,
                                      cache_len=SHARD_PROMPT + SHARD_STEPS)
        logits = _plain(logits)
        outs, nxt, picks = [logits], logits[:, -1:].argmax(-1), []
        for _ in range(SHARD_STEPS):
            picks.append(nxt)
            logits, cache = model.decode_step(cache, nxt)
            logits = _plain(logits)
            outs.append(logits)
            nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    return outs, torch.cat(picks, 1)


def _shard_world_of_one(ctx, fails):
    """(a) The sharded path on a world of one over NCCL: DeepSeek-V2-Lite
    and Qwen3-8B at full width, run unsharded, then placed at
    ``param_specs``' DTensor placements on a (1, 1) ``DeviceMesh`` under a
    ``ShardCtx`` and run again on the same weights."""
    import gc
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, place
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    out, launches = {}, {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        one = torch.ones(4, device="cuda")
        dist.all_reduce(one)
        if not bool((one == 1).all()):
            raise AssertionError(f"the NCCL world of one summed {one}")
        rng = np.random.default_rng(5)
        for arch, fields in (("deepseek-v2-lite-16b",
                              {"decode_seq_axes": ("data",)}),
                             ("qwen3-8b", {"decode_seq_axes": ("data",)})):
            cfg = get_config(arch)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model, init_s, n_params = _build_full(cfg, "shard")
            toks = torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (2, SHARD_PROMPT)), device="cuda")
            t0 = time.perf_counter()
            base, base_toks = _greedy(model, toks)
            base_s = time.perf_counter() - t0
            sctx = ShardCtx(mesh=mesh, **fields)
            model.ctx = sctx
            place(model, sctx)
            names = shardings.named(mesh, shardings.param_specs(model, mesh))
            if not all(isinstance(t, DTensor)
                       and tuple(t.placements) == names[k]
                       for k, t in model.named_parameters()):
                raise AssertionError(f"{arch}: parameters not at their "
                                     f"named placements")
            torch.cuda.synchronize()
            _reset_all()
            t0 = time.perf_counter()
            got, got_toks = _greedy(model, toks)
            shard_s = time.perf_counter() - t0
            counts = _lm_launches()
            for key, n in counts.items():
                launches[key] = launches.get(key, 0) + n
            bitwise = (all(torch.equal(a, b) for a, b in zip(got, base))
                       and torch.equal(got_toks, base_toks))
            tokens_equal = bool(torch.equal(got_toks, base_toks))
            rels = [_hold_logits("shard", f"{arch} step {i} sharded against "
                                 f"unsharded", a, b, cfg)[0]
                    for i, (a, b) in enumerate(zip(got, base))]
            norms = 1 + cfg.num_layers * (2 + (2 if cfg.qk_norm else 0))
            if cfg.kv_lora_rank:
                norms = 3 * cfg.num_layers + 1
            want = {"rmsnorm": norms * (1 + SHARD_STEPS),
                    "flash_attention": cfg.num_layers, "flash_decode": 0,
                    "flash_decode_partial": (0 if cfg.kv_lora_rank else
                                             cfg.num_layers * SHARD_STEPS)}
            seen = {k: counts[k] for k in want}
            ok = tokens_equal and seen == want
            if arch.startswith("deepseek"):
                ok &= bitwise
            log(f"[shard] {arch} on the NCCL world of one ({n_params / 1e9:.2f}"
                f" B parameters, {init_s:.1f} s to draw): unsharded "
                f"{base_s:.2f} s, sharded {shard_s:.2f} s for a prefill of "
                f"2 x {SHARD_PROMPT} and {SHARD_STEPS} greedy steps; bit for "
                f"bit {bitwise}, greedy tokens equal {tokens_equal}, worst "
                f"relative L2 {max(rels):.2e}; launches {seen}, expected "
                f"{want}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
                f" GB allocated " + ("ok" if ok else "FAIL"))
            out[arch] = {"bitwise": bitwise, "tokens_equal": tokens_equal,
                         "worst_rel_l2": max(rels), "launches": seen,
                         "unsharded_s": base_s, "sharded_s": shard_s,
                         "params": n_params,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            if not ok:
                fails.append(f"world of one {arch}")
            del got
            if arch == "qwen3-8b":   # (g)'s two contexts
                counts, out["qwen3-8b (g)"] = _seq_world_of_one(
                    model, mesh, toks, base, base_toks, fails)
                for key, n in counts.items():
                    launches[key] = launches.get(key, 0) + n
            del model, base
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    ctx["shard_launches"] = launches
    for key in ("rmsnorm", "flash_attention", "flash_decode_partial"):
        if launches.get(key, 0) <= 0:
            fails.append(f"the sharded path never launched {key}")
    return out


# the sharded training holds: (arch, layers kept (None: all), B, S, lr),
# each two Trainer steps on the NCCL world of one, placed and unplaced
SHARD_TRAIN = (("smollm-360m", None, 8, 2048, 3e-4),
               ("deepseek-v2-lite-16b", 1 + DS_MOE_LAYERS, 2, 2048, 1e-3))
SHARD_TRAIN_STEPS = 2
# the MoE layer's gradient: every rank's body in one process at each
# (data, model), against the unsharded layer's on each data shard's tokens
SHARD_MOE_GRAD_MESHES = ((1, 2), (2, 2))


def _cpu_state(state):
    """Every tensor of a train state copied to the host (a DTensor's
    local shard): a state kept for a later bitwise comparison off the
    card's memory."""
    from repro_torch.launch import shardings
    return {f"{kind}/{k}": shardings.local(t).detach().cpu()
            for kind, tree in (("p", state.params), ("m", state.opt.m),
                               ("v", state.opt.v))
            for k, t in tree.items()}


def _shard_train_world_of_one(fails):
    """(d) Training on the NCCL world of one: each SHARD_TRAIN arch takes
    SHARD_TRAIN_STEPS Trainer steps unplaced, then placed at the specs'
    DTensor placements on a (1, 1) ``DeviceMesh`` (AdamW's moments too),
    from the same seed and batches: losses, every parameter and every
    moment bit for bit, and each run's launches the code's count."""
    import gc
    import socket
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, build_model
    from repro_torch.train import Trainer, TrainerConfig
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    out, launches = [], {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        for arch, layers, B, S, lr in SHARD_TRAIN:
            cfg = get_config(arch)
            if layers is not None:
                cfg = cfg.replace(num_layers=layers)
            want = _train_launches(cfg, SHARD_TRAIN_STEPS)
            runs = {}
            for tag, ctx in (("unsharded", None),
                             ("sharded", ShardCtx(mesh=mesh,
                                                  batch_axes=("data",)))):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                model = build_model(cfg, device="cuda", seed=0, ctx=ctx,
                                    trainable=True)
                tcfg = TrainerConfig(steps=SHARD_TRAIN_STEPS, batch=B,
                                     seq=S, lr=lr, log_every=100)
                torch.cuda.synchronize()
                _reset_all()
                t0 = time.perf_counter()
                state, hist = Trainer(model, cfg, tcfg).run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                got = {k: _lm_launches()[k] for k in want}
                placed = (ctx is None) or all(
                    isinstance(t, DTensor) for tree in
                    (state.params, state.opt.m, state.opt.v)
                    for t in tree.values())
                runs[tag] = {"losses": [h["loss"] for h in hist],
                             "state": _cpu_state(state), "launches": got,
                             "placed": placed, "seconds": secs,
                             "peak_gb": torch.cuda.max_memory_allocated()
                             / 1e9}
                for k, n in got.items():
                    launches[k] = launches.get(k, 0) + n
                del model, state
            a, b = runs["sharded"], runs["unsharded"]
            same_loss = a["losses"] == b["losses"]
            diff = [k for k in b["state"]
                    if not torch.equal(a["state"][k], b["state"][k])]
            ok = (same_loss and not diff and a["placed"]
                  and a["launches"] == want and b["launches"] == want)
            log(f"[shard] {arch} ({cfg.num_layers} layers, B {B} x {S}) "
                f"{SHARD_TRAIN_STEPS} Trainer steps on the NCCL world of one,"
                f" placed on a (1, 1) DeviceMesh against unplaced: losses "
                f"{a['losses']} vs {b['losses']} "
                + ("bitwise" if same_loss else "DIFFERENT")
                + f", {len(b['state']) - len(diff)} of {len(b['state'])} "
                f"parameters and moments bitwise, DTensors {a['placed']}; "
                f"launches {a['launches']} and {b['launches']}, expected "
                f"{want}; {a['seconds']:.1f} s and {b['seconds']:.1f} s, "
                f"peaks {a['peak_gb']:.2f} and {b['peak_gb']:.2f} GB "
                + ("ok" if ok else "FAIL"))
            out.append({"arch": arch, "layers": cfg.num_layers, "batch": B,
                        "seq": S, "losses_bitwise": same_loss,
                        "leaves_differing": diff[:8],
                        "launches": a["launches"], "expected": want,
                        "sharded_s": a["seconds"],
                        "unsharded_s": b["seconds"],
                        "peak_gb": a["peak_gb"], "ok": ok})
            if not ok:
                fails.append(f"sharded training {arch}")
            del runs, a, b
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def _shard_moe_grads(fails):
    """(e) DeepSeek-V2-Lite's MoE layer's gradient at full width, every
    rank's body in one process (``moe.moe_ranks``) at each (data, model) of
    SHARD_MOE_GRAD_MESHES, against the unsharded layer's gradient on each
    data shard's tokens, summed over the shards (relative L2 < MOE_HOLD in
    bf16 for x and every weight); twice (the bits repeat)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-lite-16b")
    g = _gen(43)
    p = {k: t.detach().requires_grad_(True)
         for k, t in moe.moe_init(cfg, g, "cuda").items()}
    x = (_randn(g, (*SHARD_MOE_TOKENS, cfg.d_model), torch.float32)
         + MOE_SKEW * _randn(g, (cfg.d_model,), torch.float32)
         ).to(torch.bfloat16).requires_grad_(True)
    dy = _randn(g, tuple(x.shape), torch.bfloat16)
    leaves = [x, *p.values()]
    names = ["x", *p]
    rows = []
    for data, tp in SHARD_MOE_GRAD_MESHES:
        def ranks():
            y = moe.moe_ranks(p, x, cfg, tp=tp, data=data)
            return torch.autograd.grad(y, leaves, dy)
        a, b = ranks(), ranks()
        per = x.shape[0] // data
        want = [torch.zeros_like(t) for t in leaves]
        for i in range(data):
            sl = slice(i * per, (i + 1) * per)
            xs = x[sl].detach().requires_grad_(True)
            y = moe.moe_apply(p, xs, cfg)
            gs = torch.autograd.grad(y, [xs, *p.values()], dy[sl])
            want[0][sl] = gs[0]
            for j, gj in enumerate(gs[1:], 1):
                want[j] = want[j] + gj
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        rels = {n: _rel_l2(u.float(), w.float())
                for n, u, w in zip(names, a, want)}
        worst = max(rels, key=rels.get)
        finite = all(bool(torch.isfinite(u).all()) for u in a)
        ok = same and finite and rels[worst] < MOE_HOLD
        log(f"[shard] MoE gradient, ranks (data {data}, model {tp}) on "
            f"{SHARD_MOE_TOKENS[0]} x {SHARD_MOE_TOKENS[1]} tokens against "
            f"the unsharded layer's per data shard: worst relative L2 "
            f"{rels[worst]:.2e} ({worst}; hold {MOE_HOLD:g}), x "
            f"{rels['x']:.2e}, router {rels['router']:.2e}, bits repeat "
            f"{same} " + ("ok" if ok else "FAIL"))
        rows.append({"data": data, "model": tp, "rel_l2": rels,
                     "worst": worst, "repeat": same, "ok": ok})
        if not ok:
            fails.append(f"moe gradient {data}x{tp}")
        del a, b, want
    del p, x
    torch.cuda.empty_cache()
    return rows


# (f) head-parallel compute by rank at full width: (arch, kind, TP
# sizes); "layer" is the pattern's first layer whole, "first" DeepSeek's
# dense first layer (MLA and a dense MLP), "moe" the MoE block of a
# DeepSeek layer on one normed input (its experts by rank and its shared
# experts' columns by rank; a whole layer's update there would also carry
# the routing choices that the attention's bf16 partial sums flip)
SHARD_TP_TOKENS = (2, 2048)
SHARD_TP_CASES = (("qwen3-8b", "layer", (2, 4, 16)),
                  ("mamba2-2.7b", "layer", (2, 4, 16)),
                  ("deepseek-v2-lite-16b", "first", (2, 4)),
                  ("deepseek-v2-lite-16b", "moe", (2, 4)))
SHARD_TP_HEAD = ("qwen3-8b", 4)
SHARD_TP_GRAD = (("qwen3-8b", 2), ("mamba2-2.7b", 2))
# the split-row norm's shapes: Mamba2-2.7B's gated norm, 4096 rows of
# ssm_inner / tp on each rank
SPLIT_NORM_TPS = (2, 4, 16)
# the split-row kernels a run of (f) launches
SPLIT_KERNELS = ("rmsnorm_stat", "rmsnorm_split", "rmsnorm_split_bwd")


def _tp_layer(arch, kind, seed, grad=False):
    """(cfg, spec, the layer's parameters as ``remat.unit_params`` nests
    them, x (B, S, d), positions): a full-width layer drawn on the card,
    bf16, and its input; with ``grad`` every leaf requires a gradient."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec
    from repro_torch.models import remat
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import Block
    cfg = get_config(arch)
    spec = (LayerSpec(cfg.pattern[0].mixer, "dense") if kind == "first"
            else cfg.pattern[0])
    g = _gen(seed)
    blk = Block(cfg, spec, g, "cuda")

    def leaves(tree):
        return {k: leaves(v) if isinstance(v, dict)
                else v.detach().requires_grad_(grad) for k, v in tree.items()}
    p = leaves(remat.unit_params(blk))
    x = _randn(g, (*SHARD_TP_TOKENS, cfg.d_model),
               dtype_of(cfg.activation_dtype)).requires_grad_(grad)
    positions = torch.arange(SHARD_TP_TOKENS[1], device="cuda").expand(
        *SHARD_TP_TOKENS)
    return cfg, spec, p, x, positions


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _shard_tp_ranks(fails):
    """(f) Every TP rank's body of a full-width layer in one process
    against the unsharded layer (the module docstring's list); the
    vocab-parallel head and loss; the gradient by rank."""
    import torch
    from repro_torch.models import tp as tp_lib
    from repro_torch.models.layers import dense_init, lm_head
    from repro_torch.train.loss import softmax_xent
    from repro_torch.models import moe
    from repro_torch.models.layers import rms_norm
    rows = []
    with torch.no_grad():
        for n, (arch, kind, sizes) in enumerate(SHARD_TP_CASES):
            cfg, spec, p, x, pos = _tp_layer(arch, kind, 60 + n)
            if kind == "moe":   # the MoE block on one normed input
                x = rms_norm(x, p["ln2"], cfg.norm_eps)

                def update(size, p=p, x=x, cfg=cfg):
                    return moe.moe_ranks(p["mlp"], x, cfg, tp=size,
                                         shared_tp=size > 1)
                what = "MoE block (experts and shared experts by rank)"
            else:
                def update(size, p=p, x=x, cfg=cfg, spec=spec, pos=pos):
                    return tp_lib.layer_ranks(spec, p, x, cfg, pos,
                                              size) - x
                what = f"layer {spec.mixer}+{spec.mlp}"
            t0 = time.perf_counter()
            want = update(1)
            for size in sizes:
                pl = tp_lib.plan(cfg, spec, size)
                a, b = update(size), update(size)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, b))
                rel = _rel_l2(a.float(), want.float())
                ok = (same and rel < MOE_HOLD
                      and bool(torch.isfinite(a).all()))
                log(f"[shard] tp ranks {arch} {what} at tp {size} (mixer "
                    f"{pl.mixer}, MLP by rank {pl.mlp}) on "
                    f"{SHARD_TP_TOKENS[0]} x {SHARD_TP_TOKENS[1]}: the "
                    f"update against the unsharded one's relative L2 "
                    f"{rel:.2e} (hold {MOE_HOLD:g}), bits repeat {same} "
                    + ("ok" if ok else "FAIL"))
                rows.append({"arch": arch, "block": what, "tp": size,
                             "mixer": pl.mixer, "mlp_by_rank": pl.mlp,
                             "rel_l2": rel, "repeat": same, "ok": ok})
                if not ok:
                    fails.append(f"tp ranks {arch} {kind} {size}")
                del a, b
            log(f"[shard] tp ranks {arch} {kind}: "
                f"{time.perf_counter() - t0:.1f} s")
            del p, x, want
            torch.cuda.empty_cache()
        # the vocab-parallel head and loss
        arch, size = SHARD_TP_HEAD
        from repro_torch.configs import get_config
        cfg = get_config(arch)
        g = _gen(70)
        emb = {"head": dense_init((cfg.d_model, cfg.padded_vocab),
                                  torch.bfloat16, g, "cuda")}
        x = _randn(g, (*SHARD_TP_TOKENS, cfg.d_model), torch.bfloat16)
        labels = torch.randint(0, cfg.vocab_size, SHARD_TP_TOKENS,
                               generator=g, device="cuda")
        labels[0, :2] = -1
        whole = lm_head(emb, x, cfg)
        loss_w, met_w = softmax_xent(whole, labels, cfg.vocab_size)
        parts = tp_lib.head_ranks(emb, x, cfg, size)
        loss_a, met_a = tp_lib.xent_ranks(parts, labels, cfg)
        loss_b, _ = tp_lib.xent_ranks(tp_lib.head_ranks(emb, x, cfg, size),
                                      labels, cfg)
        torch.cuda.synchronize()
        rel_logits = _rel_l2(torch.cat(parts, -1).float(), whole.float())
        rel_loss = abs(float(loss_a) - float(loss_w)) / abs(float(loss_w))
        same = bool(torch.equal(loss_a, loss_b))
        ok = same and rel_loss < MOE_HOLD and rel_logits < MOE_HOLD
        log(f"[shard] tp ranks {arch} vocab-parallel head and loss at tp "
            f"{size} ({cfg.padded_vocab // size} columns a rank): loss "
            f"{float(loss_a):.6f} vs whole {float(loss_w):.6f} (relative "
            f"{rel_loss:.2e}), accuracy {float(met_a['accuracy']):.6f} vs "
            f"{float(met_w['accuracy']):.6f}, logits relative L2 "
            f"{rel_logits:.2e}, bits repeat {same} "
            + ("ok" if ok else "FAIL"))
        rows.append({"arch": arch, "layer": "head+loss", "tp": size,
                     "rel_l2": rel_logits, "loss_rel": rel_loss,
                     "repeat": same, "ok": ok})
        if not ok:
            fails.append("tp ranks head and loss")
        del emb, x, whole, parts
        torch.cuda.empty_cache()
    # the gradient by rank
    for n, (arch, size) in enumerate(SHARD_TP_GRAD):
        cfg, spec, p, x, pos = _tp_layer(arch, "layer", 80 + n, grad=True)
        leaves = {"x": x, **_flat_leaves(p)}
        dy = _randn(_gen(90 + n), tuple(x.shape), x.dtype)

        def grads(tp_size):
            y = tp_lib.layer_ranks(spec, p, x, cfg, pos, tp_size)
            return torch.autograd.grad(y, list(leaves.values()), dy,
                                       allow_unused=True)
        want, a, b = grads(1), grads(size), grads(size)
        torch.cuda.synchronize()
        same = all((u is None and v is None) or torch.equal(u, v)
                   for u, v in zip(a, b))
        rels = {k: _rel_l2(u.float(), w.float())
                for k, u, w in zip(leaves, a, want) if w is not None}
        worst = max(rels, key=rels.get)
        finite = all(bool(torch.isfinite(u).all()) for u in a
                     if u is not None)
        ok = same and finite and rels[worst] < MOE_HOLD
        log(f"[shard] tp ranks {arch} layer gradient at tp {size} against "
            f"the unsharded layer's: worst relative L2 {rels[worst]:.2e} "
            f"({worst}; hold {MOE_HOLD:g}), x {rels['x']:.2e}, bits repeat "
            f"{same} " + ("ok" if ok else "FAIL"))
        rows.append({"arch": arch, "layer": "gradient", "tp": size,
                     "rel_l2": rels, "worst": worst, "repeat": same,
                     "ok": ok})
        if not ok:
            fails.append(f"tp ranks gradient {arch}")
        del p, x, leaves, want, a, b
        torch.cuda.empty_cache()
    return rows


def _split_norm_checks(fails):
    """The split-row kernels on each rank's shard of Mamba2-2.7B's gated
    norm against their plain versions (LM_TOL), twice; the rank's forward
    (row sums, then the norm) and backward (row sums, then dx and dw)
    timed beside their bound, the plain versions and ``F.rms_norm`` on
    the whole row (forward; backward through autograd)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    cfg = get_config("mamba2-2.7b")
    n_cols, eps = cfg.ssm_inner, cfg.norm_eps
    rows_n = SHARD_TP_TOKENS[0] * SHARD_TP_TOKENS[1]
    out = []
    for dts in ("bfloat16", "float32"):
        dt = getattr(torch, dts)
        tol = LM_TOL[dts]
        g = _gen(100)
        x = _randn(g, (rows_n, n_cols), dt)
        w = (1.0 + 0.1 * torch.randn(n_cols, generator=g,
                                     device="cuda")).to(dt)
        dy = _randn(g, (rows_n, n_cols), dt)
        for size in SPLIT_NORM_TPS:
            D = n_cols // size
            xs = [c.contiguous() for c in x.split(D, -1)]
            ws = [c.contiguous() for c in w.split(D)]
            gs = [c.contiguous() for c in dy.split(D, -1)]

            def fwd(r):
                return rn.rmsnorm_rows(xs[r], ws[r], ss, n_cols, eps=eps)

            def bwd(r):
                return rn.rmsnorm_rows_bwd(xs[r], ws[r], gs[r], ss, dot,
                                           n_cols, eps=eps)
            stats = [rn.row_stat(xr) for xr in xs]
            ss = stats[0]
            for st in stats[1:]:
                ss = ss + st
            dots = [rn.row_stat(xr, wr, gr) for xr, wr, gr in
                    zip(xs, ws, gs)]
            dot = dots[0]
            for d_ in dots[1:]:
                dot = dot + d_
            ok, errs, same = True, [], True
            for r in range(size):
                got = (stats[r], dots[r], fwd(r), *bwd(r))
                again = (rn.row_stat(xs[r]), rn.row_stat(xs[r], ws[r], gs[r]),
                         fwd(r), *bwd(r))
                want = (ref.rmsnorm_stat_ref(xs[r]),
                        ref.rmsnorm_stat_ref(xs[r], ws[r], gs[r]),
                        ref.rmsnorm_split_ref(xs[r], ws[r], ss, n_cols, eps),
                        *ref.rmsnorm_split_bwd_ref(xs[r], ws[r], gs[r], ss,
                                                   dot, n_cols, eps))
                same &= all(torch.equal(u, v) for u, v in zip(got, again))
                for i, (u, v) in enumerate(zip(got, want)):
                    # the row sums relative to their own size
                    scale = (v.abs().max().clamp(min=1.0) if i < 2 else 1.0)
                    okk = bool(torch.allclose(u.float() / scale,
                                              v.float() / scale, atol=tol,
                                              rtol=tol))
                    ok &= okk
                    errs.append(float((u.float() - v.float()).abs().max()))
            ok &= same
            # rank 0's launches, each timed (event pair, ten calls a pair;
            # device time a call) beside its bound and its plain version;
            # F.rms_norm on the whole row (forward, and its backward through
            # autograd) beside the norm's two passes
            xl = x.detach().requires_grad_(True)
            wl = w.detach().requires_grad_(True)
            yl = F.rms_norm(xl, (n_cols,), wl, eps)
            esize = x.element_size()
            lib = {"fwd": lambda: F.rms_norm(x, (n_cols,), w, eps),
                   "bwd": lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                                      retain_graph=True)}
            calls = {
                "stat": (lambda: rn.row_stat(xs[0]),
                         lambda: ref.rmsnorm_stat_ref(xs[0]),
                         RL.rmsnorm_stat_work(rows_n, D, esize, False),
                         None),
                "fwd": (lambda: fwd(0), lambda: ref.rmsnorm_split_ref(
                    xs[0], ws[0], ss, n_cols, eps),
                    RL.rmsnorm_split_work(rows_n, D, esize), lib["fwd"]),
                "bwd": (lambda: bwd(0), lambda: ref.rmsnorm_split_bwd_ref(
                    xs[0], ws[0], gs[0], ss, dot, n_cols, eps),
                    RL.rmsnorm_split_bwd_work(rows_n, D, esize),
                    lib["bwd"])}
            row = {"dtype": dts, "tp": size, "rows": rows_n, "D": D,
                   "n": n_cols, "max_abs_err": max(errs), "errs": errs,
                   "repeat": same, "ok": ok}
            notes = []
            for key, (fn, plain, (ops_, nbytes), lib_fn) in calls.items():
                ms = _time_cuda(fn, reps=7, per_pair=10)
                dev = _device_ms(fn, reps=10)
                plain_ms = _time_cuda(plain, reps=5)
                lib_ms = (_time_cuda(lib_fn, reps=7, per_pair=10)
                          if lib_fn is not None else None)
                bound = _roof(nbytes, ops_ / FP32_OPS_PER_S)
                row[key] = {"ms": ms, "device_ms": dev,
                            "plain_ms": plain_ms, "bound_ms": bound[0],
                            "bound_by": bound[1], "library_ms": lib_ms}
                notes.append(
                    f"{key} {ms:.4f} ms (device "
                    + (f"{dev:.4f}" if dev is not None else "not measured")
                    + f"; bound {bound[0]:.4f}, {bound[1]}; plain "
                    f"{plain_ms:.4f}"
                    + (f"; F.rms_norm whole row {lib_ms:.4f}"
                       if lib_ms is not None else "") + ")")
            log(f"[shard] split-row norm {dts} tp {size} ({rows_n} x {D} of "
                f"{n_cols}): max|err| stat {errs[0]:.2e} dot {errs[1]:.2e} "
                f"y {errs[2]:.2e} dx {errs[3]:.2e} dw {errs[4]:.2e} (tol "
                f"{tol:g}), bits repeat {same}; rank 0: " + ", ".join(notes)
                + (" ok" if ok else " FAIL"))
            out.append(row)
            if not ok:
                fails.append(f"split-row norm {dts} tp {size}")
            del xs, ws, gs, xl, wl, yl
        del x, w, dy
        torch.cuda.empty_cache()
    return out


# (g) sequence parallelism (ShardCtx.seq_axis): every TP rank's body in
# one process at full width, B 2 x 2048 (SHARD_TP_TOKENS), as (f) draws
# it: (arch, kind, TP sizes); SmolLM-360M's 15 heads run replicated at tp
# 16 (the whole sequence gathered, the rank's block kept)
SHARD_SEQ_CASES = (("qwen3-8b", "layer", (2, 4, 16)),
                   ("mamba2-2.7b", "layer", (2, 4, 16)),
                   ("deepseek-v2-lite-16b", "first", (2, 4)),
                   ("smollm-360m", "layer", (16,)))
SHARD_SEQ_GRAD = (("qwen3-8b", 2), ("mamba2-2.7b", 2))
# the kernels (g) must launch
SEQ_KERNELS = ("rmsnorm", "flash_attention", "ssd_scan", "rmsnorm_bwd",
               "flash_attention_bwd", "ssd_scan_bwd")


def _shard_seq_ranks(fails):
    """(g) The sequence mode of every TP rank's body of a full-width layer
    (``tp.layer_ranks(..., seq=True)``: each rank's block of the sequence
    through the norms, the blocks joined, the partials summed in rank
    order and cut into blocks) against (f)'s ``layer_ranks`` at the same
    size (bit for bit, else at LM_TOL with the reason logged) and against
    the unsharded layer (MOE_HOLD), its bits repeated; the gradient at tp 2
    against ``layer_ranks``' at every leaf (MOE_HOLD: the norms' scale
    gradients are summed by block)."""
    import torch
    from repro_torch.models import tp as tp_lib
    rows = []
    with torch.no_grad():
        for n, (arch, kind, sizes) in enumerate(SHARD_SEQ_CASES):
            cfg, spec, p, x, pos = _tp_layer(arch, kind, 110 + n)
            t0 = time.perf_counter()
            want = tp_lib.layer_ranks(spec, p, x, cfg, pos, 1) - x
            for size in sizes:
                pl = tp_lib.plan(cfg, spec, size)
                a = tp_lib.layer_ranks(spec, p, x, cfg, pos, size, seq=True)
                b = tp_lib.layer_ranks(spec, p, x, cfg, pos, size, seq=True)
                f = tp_lib.layer_ranks(spec, p, x, cfg, pos, size)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, b))
                bitwise = bool(torch.equal(a, f))
                rel_f = _rel_l2(a.float(), f.float())
                rel = _rel_l2((a - x).float(), want.float())
                ok = (same and rel < MOE_HOLD
                      and (bitwise or rel_f < LM_TOL["bfloat16"])
                      and bool(torch.isfinite(a).all()))
                log(f"[shard] (g) seq ranks {arch} layer {spec.mixer}+"
                    f"{spec.mlp} at tp {size} (mixer {pl.mixer}, MLP by "
                    f"rank {pl.mlp}; {x.shape[1] // size} rows a rank) on "
                    f"{SHARD_TP_TOKENS[0]} x {SHARD_TP_TOKENS[1]}: against "
                    f"(f)'s layer_ranks bit for bit {bitwise}"
                    + ("" if bitwise else f" (relative L2 {rel_f:.2e}, hold "
                       f"{LM_TOL['bfloat16']:g}: the norms on blocks of "
                       f"rows)")
                    + f"; the update against the unsharded one's relative "
                    f"L2 {rel:.2e} (hold {MOE_HOLD:g}), bits repeat {same} "
                    + ("ok" if ok else "FAIL"))
                rows.append({"arch": arch, "block": f"{spec.mixer}+"
                             f"{spec.mlp}", "tp": size, "mixer": pl.mixer,
                             "mlp_by_rank": pl.mlp, "bitwise_f": bitwise,
                             "rel_l2_f": rel_f, "rel_l2": rel,
                             "repeat": same, "ok": ok})
                if not ok:
                    fails.append(f"(g) seq ranks {arch} {kind} {size}")
                del a, b, f
            log(f"[shard] (g) seq ranks {arch} {kind}: "
                f"{time.perf_counter() - t0:.1f} s")
            del p, x, want
            torch.cuda.empty_cache()
    for n, (arch, size) in enumerate(SHARD_SEQ_GRAD):
        cfg, spec, p, x, pos = _tp_layer(arch, "layer", 120 + n, grad=True)
        leaves = {"x": x, **_flat_leaves(p)}
        dy = _randn(_gen(130 + n), tuple(x.shape), x.dtype)

        def grads(seq):
            y = tp_lib.layer_ranks(spec, p, x, cfg, pos, size, seq=seq)
            return torch.autograd.grad(y, list(leaves.values()), dy,
                                       allow_unused=True)
        want, a, b = grads(False), grads(True), grads(True)
        torch.cuda.synchronize()
        same = all((u is None and v is None) or torch.equal(u, v)
                   for u, v in zip(a, b))
        rels = {k: _rel_l2(u.float(), w.float())
                for k, u, w in zip(leaves, a, want) if w is not None}
        worst = max(rels, key=rels.get)
        finite = all(bool(torch.isfinite(u).all()) for u in a
                     if u is not None)
        ok = same and finite and rels[worst] < MOE_HOLD
        log(f"[shard] (g) seq ranks {arch} layer gradient at tp {size} "
            f"against layer_ranks': worst relative L2 {rels[worst]:.2e} "
            f"({worst}; hold {MOE_HOLD:g}), x {rels['x']:.2e}, bits repeat "
            f"{same} " + ("ok" if ok else "FAIL"))
        rows.append({"arch": arch, "layer": "gradient", "tp": size,
                     "rel_l2": rels, "worst": worst, "repeat": same,
                     "ok": ok})
        if not ok:
            fails.append(f"(g) seq ranks gradient {arch}")
        del p, x, leaves, want, a, b
        torch.cuda.empty_cache()
    return rows


def _unplace(model):
    """On a world of one: every parameter back to the plain tensor its
    DTensor holds (the whole of it; no copy)."""
    from torch import nn
    from repro_torch.launch import shardings
    for name, t in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        new = nn.Parameter(shardings.local(t), requires_grad=t.requires_grad)
        if isinstance(owner, nn.ParameterDict):
            owner[leaf] = new
        else:
            setattr(owner, leaf, new)


def _seq_world_of_one(model, mesh, toks, base, base_toks, fails):
    """(g) The placed Qwen3-8B of (a) on the NCCL world of one under
    ``ShardCtx(seq_axis="model")`` on its (1, 1) mesh, then placed anew on
    a (1, 1, 1) ("pod", "data", "model") mesh under
    ``batch_axes=("pod", "data")``: each prefill and its greedy steps bit
    for bit the unsharded run's. (counts of the launches, results)"""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, place
    out, launches = {}, {}
    cases = (("seq_axis", ShardCtx(mesh=mesh, seq_axis="model")),
             ("pod_data", ShardCtx(mesh=make_mesh(
                 (1, 1, 1), ("pod", "data", "model"), "cuda"),
                 batch_axes=("pod", "data"))))
    for tag, sctx in cases:
        if sctx.mesh is not model.ctx.mesh:
            _unplace(model)
            place(model, sctx)
        model.ctx = sctx
        torch.cuda.synchronize()
        _reset_all()
        t0 = time.perf_counter()
        got, got_toks = _greedy(model, toks)
        secs = time.perf_counter() - t0
        for key, n in _lm_launches().items():
            launches[key] = launches.get(key, 0) + n
        bitwise = (all(torch.equal(a, b) for a, b in zip(got, base))
                   and torch.equal(got_toks, base_toks))
        log(f"[shard] (g) Qwen3-8B on the NCCL world of one under {tag} "
            f"({sctx.batch_axes or ()}, seq_axis {sctx.seq_axis}, mesh "
            f"{tuple(sctx.mesh.mesh_dim_names)}): prefill of 2 x "
            f"{SHARD_PROMPT} and {SHARD_STEPS} greedy steps in {secs:.2f} "
            f"s, bit for bit the unsharded run {bitwise} "
            + ("ok" if bitwise else "FAIL"))
        out[tag] = {"bitwise": bitwise, "seconds": secs}
        if not bitwise:
            fails.append(f"(g) world of one {tag}")
        del got
    return launches, out


def phase_shard(ctx):
    """Sharded serving and training: (a) the world of one over NCCL, (b)
    every rank's body in one process at full width, (c) the partial
    kernel against its plain version, (d) training on the world of one,
    (e) the MoE layer's gradient by rank, (f) head-parallel compute by
    rank and the split-row norm's kernels, (g) sequence parallelism by
    rank (its two world-of-one cases run inside (a))."""
    import torch
    fails = []
    with torch.no_grad():
        world = _shard_world_of_one(ctx, fails)
        moe_rows = _shard_moe_ranks(fails)
        decode = _shard_decode_ranks(fails)
        partial = _shard_partial_checks(fails)
    train, launches = _shard_train_world_of_one(fails)
    for k, n in launches.items():
        ctx["shard_launches"][k] = ctx["shard_launches"].get(k, 0) + n
    moe_grads = _shard_moe_grads(fails)
    # (f): launches counted from zero
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    tp_rows = _shard_tp_ranks(fails)
    torch.cuda.synchronize()
    tp_launches = _lm_launches()
    log(f"[shard] (f) tp ranks in {time.perf_counter() - t0:.1f} s, "
        f"launches {tp_launches}")
    for k, n in tp_launches.items():
        ctx["shard_launches"][k] = ctx["shard_launches"].get(k, 0) + n
    ctx["tp_launches"] = {k: tp_launches.get(k, 0) for k in SPLIT_KERNELS}
    for k in ("rmsnorm", "flash_attention", "ssd_scan", *SPLIT_KERNELS):
        if tp_launches.get(k, 0) <= 0:
            fails.append(f"(f) never launched {k}")
    split = _split_norm_checks(fails)
    # (g): launches counted from zero
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    seq_rows = _shard_seq_ranks(fails)
    torch.cuda.synchronize()
    seq_launches = _lm_launches()
    seq_s = time.perf_counter() - t0
    log(f"[shard] (g) seq ranks in {seq_s:.1f} s, launches {seq_launches}")
    for k, n in seq_launches.items():
        ctx["shard_launches"][k] = ctx["shard_launches"].get(k, 0) + n
    for k in SPLIT_KERNELS:   # Mamba2's gated norm in (g)'s rank bodies
        ctx["tp_launches"][k] += seq_launches.get(k, 0)
    for k in SEQ_KERNELS:
        if seq_launches.get(k, 0) <= 0:
            fails.append(f"(g) never launched {k}")
    ctx["shard"] = {"world_of_one": world, "moe_ranks": moe_rows,
                    "decode": decode, "partial": partial,
                    "training": train, "moe_grads": moe_grads,
                    "tp_ranks": tp_rows, "split_norm": split,
                    "seq_ranks": seq_rows, "seq_seconds": seq_s,
                    "seq_launches": {k: seq_launches.get(k, 0)
                                     for k in SEQ_KERNELS}}
    if fails:
        raise AssertionError(f"shard: {fails}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--f32-terms", type=int, choices=(1, 3), default=3,
                    help="products a float32 attention product takes: 3 "
                    "(split TF32, the kernels as built) or 1 (one TF32 "
                    "product: a lower-precision control, which the float32 "
                    "attention holds should fail)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    if args.f32_terms != 3:
        import functools
        from repro_torch.kernels import flash_attention as fa
        fa.build = functools.partial(
            fa.build, defines=(f"FA_F32_TERMS={args.f32_terms}",))
        log(f"[main] float32 attention built with FA_F32_TERMS="
            f"{args.f32_terms}: a control, not the kernels as built")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx = {"f32_terms": args.f32_terms}
    t_start = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    fns = {"card": phase_card, "build": phase_build, "lint": phase_lint,
           "check": phase_check,
           "tick": phase_tick, "acc32": phase_acc32, "loop": phase_loop,
           "profile": phase_profile, "twoch": phase_twoch,
           "lmcheck": phase_lmcheck, "serve": phase_serve,
           "ssmserve": phase_ssmserve, "moeserve": phase_moeserve,
           "zoo": phase_zoo, "lmtick": phase_lmtick,
           "dag": phase_dag, "wfloop": phase_wfloop,
           "engine": phase_engine, "chaos": phase_chaos,
           "trace": phase_trace, "group": phase_group,
           "straggler": phase_straggler, "paper": phase_paper,
           "cluster": phase_cluster, "sweep": phase_sweep,
           "examples": phase_examples, "train": phase_train,
           "shard": phase_shard}
    for p in PHASES:
        if p in phases:
            t0 = time.perf_counter()
            fns[p](ctx)
            log(f"[{p}] done in {time.perf_counter() - t0:.1f} s")
    if args.f32_terms != 3:
        log(f"[main] the FA_F32_TERMS={args.f32_terms} control passed every "
            f"hold of {phases}: no result line")
        return 3

    kernels = []
    tick = {(r["family"], r["mode"]): r for r in ctx.get("tick", [])}
    # the frontier kernels' main paths: the closed loop, the workflow
    # experiment, the workflow loop, the serving engine (its ticks' own
    # calls), the chaos runs, the channel-count selection, the straggler
    # scenario, the paper's figures, the fleet experiment, the traced and
    # sanitized runs and the autotune sweep, each counted from zero;
    # "launches" is their sum and "launches_by_path" the split
    paths = {path: ctx[k] for path, k in (("loop", "launches"),
                                          ("dag", "dag_launches"),
                                          ("wfloop", "wfloop_launches"),
                                          ("engine", "engine_launches"),
                                          ("chaos", "chaos_launches"),
                                          ("group", "group_launches"),
                                          ("straggler", "straggler_launches"),
                                          ("paper", "paper_launches"),
                                          ("cluster", "cluster_launches"),
                                          ("trace", "trace_launches"),
                                          ("sweep", "sweep_launches"),
                                          ("examples", "examples_launches"),
                                          ("train", "train_launches"))
             if k in ctx}
    for mode, (name, replaces) in KERNELS.items():
        r = tick.get(("normal", mode), {})
        by_path = {path: c[mode] for path, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces,
            "launches": sum(by_path.values()) if by_path else None,
            "launches_by_path": by_path,
            "max_abs_err": ctx.get("max_abs_err", {}).get(mode),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": None})
    # the model kernels: times at the serving path's first shape of each
    path = {}
    for r in ctx.get("lmtick", []):
        if r["shape"].startswith("path"):
            path.setdefault(r["kernel"], r)
    for key, (name, source, replaces) in LM_KERNELS.items():
        r = path.get(key, {})
        by_path = {p: ctx[f"{p}_launches"][key] for p in LM_PATHS
                   if f"{p}_launches" in ctx}
        f32 = ({p: ctx[f"{p}_launches"].get(f"{key}_f32", 0)
                for p in LM_PATHS if f"{p}_launches" in ctx}
               if key == "flash_attention" else None)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()) if by_path else None,
            "launches_by_path": by_path,
            "max_abs_err": ctx.get("lm_max_abs_err", {}).get(key),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"),
            **({"launches_f32_by_path": f32} if f32 is not None else {})})
    # the decode's partial mode, at a shard of decode_32k (S / SHARD_SEQ
    # slots), launched by the sharded path alone
    r = ctx.get("shard", {}).get("decode", {}).get("partial_row", {})
    kernels.append({
        "name": "flash_decode_partial", "route": "cuda",
        "source": "src/repro_torch/csrc/attention.cu",
        "replaces": LM_KERNELS["flash_decode"][2],
        "launches": (ctx["shard_launches"]["flash_decode_partial"]
                     if "shard_launches" in ctx else None),
        "launches_by_path": ({"shard": ctx["shard_launches"][
            "flash_decode_partial"]} if "shard_launches" in ctx else {}),
        "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
        "device_ms": r.get("device_ms"), "plain_ms": r.get("plain_ms"),
        "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
        "library_ms": r.get("library_ms"), "shape": r.get("shape")})
    # the split-row norm (Mamba2-2.7B's gated norm under TP), each of its
    # three wrappers at rank 0's shard at tp 2 in bf16 (a row's partial
    # sum, the norm given the totals, its backward), launched by the shard
    # phase's rank bodies (f) and (g)
    split = {r["tp"]: r for r in ctx.get("shard", {}).get("split_norm", [])
             if r["dtype"] == "bfloat16"}.get(2, {})
    for name, part in (("rmsnorm_stat", "stat"), ("rmsnorm_split", "fwd"),
                       ("rmsnorm_split_bwd", "bwd")):
        r = split.get(part, {})
        n = ctx["tp_launches"][name] if "tp_launches" in ctx else None
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": LM_KERNELS["rmsnorm"][2],
            "launches": n, "launches_by_path": ({"shard": n}
                                                 if n is not None else {}),
            "max_abs_err": split.get("max_abs_err"), "ms": r.get("ms"),
            "device_ms": r.get("device_ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"),
            "shape": (f"{split['rows']} x {split['D']} of {split['n']} "
                      f"(tp 2), bf16" if split else None)})
    # the backward kernels of the training path, at SmolLM-360M's training
    # shapes (attention B=8, S=2048; norms 16384 x 960, bf16) and Mamba2-
    # 2.7B's layer (B=2, S=2048, bf16), each with every shape it was timed
    # at (the attention backward's 192 tiles among them) as "instances"
    train = ctx.get("train", {})
    rows = {"flash_attention_bwd": train.get("attention") or [{}],
            "rmsnorm_bwd": train.get("rmsnorm") or [{}],
            "ssd_scan_bwd": train.get("ssd") or [{}]}
    keep = ("name", "rows", "D", "Dv", "shape", "dtype", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_dev_ms", "by_kernel_ms", "device_busy_ms",
            "library_busy_ms", "bound_cuda_core_ms", "bound_tf32_ms",
            "library_backend", "library_mha_ms", "library_mha_dev_ms",
            "library_mha_backend")
    for name, (source, replaces) in TRAIN_REPLACES.items():
        r = rows[name][0]
        by_path = {p: ctx[f"{p}_launches"].get(name, 0)
                   for p in ("train", "shard") if f"{p}_launches" in ctx}
        f32 = ({"train": ctx["train_launches"].get(f"{name}_f32", 0)}
               if name == "flash_attention_bwd" and "train_launches" in ctx
               else None)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()) if by_path else None,
            "launches_by_path": by_path,
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "device_ms": r.get("device_ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"),
            "library_dev_ms": r.get("library_dev_ms"),
            **({"launches_f32_by_path": f32} if f32 is not None else {}),
            "instances": [{k: i[k] for k in keep if k in i}
                          for i in rows[name]]})
    # the port's kernels with no Pallas counterpart: compose_grads at the
    # 32-stage refine shape, family_score at the fleet tick's history, each
    # with its device time (the chain estimates stay in the log: they are
    # not measured)
    port_paths = {p: ctx[k] for p, k in (
        ("dag", "dag_port_launches"), ("wfloop", "wfloop_port_launches"),
        ("chaos", "chaos_port_launches"), ("trace", "trace_port_launches"),
        ("cluster", "cluster_port_launches"),
        ("examples", "examples_launches")) if k in ctx}
    for name, (source, replaces) in PORT_KERNELS.items():
        r = ctx.get("port_kernels", {}).get(name, {})
        by_path = {p: c[name] for p, c in port_paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()) if by_path else None,
            "launches_by_path": by_path,
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "device_ms": r.get("device_ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"), "library_ms": None})
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"smi": ctx.get("smi"), "kernels": kernels,
                   "main_path_ms": ctx.get("main_path_ms"),
                   "tick": ctx.get("tick"), "acc32": ctx.get("acc32"),
                   "loop": ctx.get("loop"),
                   "launches": ctx.get("launches"),
                   "profile": ctx.get("profile"),
                   "lm_max_abs_err": ctx.get("lm_max_abs_err"),
                   "lmcheck_model": ctx.get("lmcheck_model"),
                   "serve": ctx.get("serve"),
                   "serve_launches": ctx.get("serve_launches"),
                   "ssmserve": ctx.get("ssmserve"),
                   "ssmserve_launches": ctx.get("ssmserve_launches"),
                   "moeserve": ctx.get("moeserve"),
                   "moeserve_launches": ctx.get("moeserve_launches"),
                   "zoo": ctx.get("zoo"),
                   "zoo_launches": ctx.get("zoo_launches"),
                   "lmtick": ctx.get("lmtick"),
                   "dag": ctx.get("dag"), "wfloop": ctx.get("wfloop"),
                   "engine": ctx.get("engine"), "chaos": ctx.get("chaos"),
                   "dag_launches": ctx.get("dag_launches"),
                   "group": ctx.get("group"),
                   "straggler": ctx.get("straggler"),
                   "paper": ctx.get("paper"), "cluster": ctx.get("cluster"),
                   "trace": ctx.get("trace"), "sweep": ctx.get("sweep"),
                   "wfloop_launches": ctx.get("wfloop_launches"),
                   "examples": ctx.get("examples"),
                   "port_kernels": ctx.get("port_kernels"),
                   "train": ctx.get("train"),
                   "train_launches": ctx.get("train_launches"),
                   "shard": ctx.get("shard"),
                   "shard_launches": ctx.get("shard_launches"),
                   "build_s": ctx.get("build_s"),
                   "lint": ctx.get("lint"),
                   "seconds": time.perf_counter() - t_start}, fh, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(ctx.get("smi", ""))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
