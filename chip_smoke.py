#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of BW-Raft on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run on one GPU
    python3 chip_smoke.py --profile  # also profiles 10 ticks of the solo
                                     # and of the fleet path, and a
                                     # prefill and 4 decode steps of each
                                     # serve path, smollm-360m,
                                     # mamba2-130m and phase 16's three,
                                     # and 2 full-width train steps
                                     # (device busy share, kernels by
                                     # name)
    python3 chip_smoke.py --phase10 N  # phases 1, 8, 9, then phase 10's
                                     # float32 smollm check N times
    python3 chip_smoke.py --phase15  # phases 1 and 15 (training)
    python3 chip_smoke.py --phase16  # phases 1, 8 (without the long
                                     # shapes) and 16 (MoE, cross-
                                     # attention, encoder-decoder)
    python3 chip_smoke.py --phase17  # phase 17 alone (the expert-
                                     # parallel MoE; builds nothing)
    python3 chip_smoke.py --phase18  # phases 1 and 18 (the LM forward
                                     # on DTensors over 4 ranks)
    python3 chip_smoke.py --phase19  # phases 1 and 19 (the train step on
                                     # DTensors, seamless serving on a
                                     # mesh, over 4 ranks)
    python3 chip_smoke.py --phase20  # phases 1 and 20 (the dry run
                                     # against a real run on 4 ranks,
                                     # and production cells)
    python3 chip_smoke.py --phase21  # phases 1 and 21 (the frozen
                                     # reference forms against the
                                     # kernel pipeline)
    python3 chip_smoke.py --phase22  # phases 1 and 22 (launch/train.py
                                     # on 4 ranks against one device)
    python3 chip_smoke.py --probe-gloo  # which functional collectives
                                     # gloo takes on CUDA tensors
    python3 chip_smoke.py --depth-witness  # phase 1, then phase 18's
                                     # llama case on the card against
                                     # the host at 4, 8 and 16 layers,
                                     # and its long bf16 2 x 2 case at 4
                                     # with d_model sharded and whole;
                                     # phase 19's llama bf16 at 4 and 6
                                     # layers and seamless f32 at 2 + 2,
                                     # host against card, and its llama
                                     # bf16 1 x 4 case at 4 with the
                                     # heads and MLP sharded and whole

Phases, each fatal on failure, each ending in a line `phase N <seconds>
s` (the budget is 800 s of the 1,200 s limit: a phase that is added
brings its own seconds, cutting an earlier path's depth, never its
width, dtype, mesh, case or gate; PERF.md §4 has where it stands):

1. print the card's name and power limit, build the CUDA kernels from
   the seven sources of `src/repro_torch/kernels/csrc/` (one nvcc per
   source, in parallel), print each kernel's ptxas register and spill
   lines under its function name, and fail if ptxas spills in
   `lma_kernel`, `fanout_kernel`, either `ae_sync_kernel` instance (N <=
   128, S*S <= 32, and the general one) or `group_reduce_kernel`, or if
   an `ae_sync_kernel` has a block barrier or shared memory (ptxas) or
   its library a BAR or ATOMS instruction (its SASS, where cuobjdump
   exists);
2. each of the six kernels against its plain PyTorch twin on the same
   CUDA inputs, exact equality (floats bit for bit, +0 and -0 apart, a
   NaN matching a NaN): at the solo path's
   shapes (B=1, N=87, L=4096, K=1024, W=256, A=8), at the fleet path's
   (B=5, O=550, S=4, Fi=355 packed group lanes), at the sweep's B=32 and
   on edge cases (for ae_sync N in {1, 31, 32, 33, 64, 65, 87, 128,
   129, 1024, 1100, 2000} with the first alive voter in the last 32-node
   word, S in {1, 4, 5, 6}, O in {1, 31, 32, 33, 129}, wired followers
   at -1 and >= N, tick + phase below 0, intervals 0 and -3; for
   group_reduce B in {1, 8, 9, 15, 16, 17, 32, 33, 100}, up to 8 groups
   with an empty one, NaN, +-inf, +0 and -0 in the float lanes, int sums
   that wrap, and outputs allocated over a freed sentinel fill; for
   commit_majority N in {1, 32, 33, 87, 1024} by L in {1, 16, 33,
   4096}, mixed majorities, no live voter, the majority-th
   match past L; for apply_last_wins A in {1, 8, 31, 32, 33, 64}, one
   key per row, no valid entry, keys at -K-1, -1, K, K+1; for
   log_match_append from = 0 with position 0 overwritten, from = L,
   upto below from, a matching log longer than the window, W = 1, W =
   512 and 1024 (past the window the threads hold in registers), N =
   1024 and B = 32;
   for leader_fanout the budget rank cut on lane 31, on lane 0 of the
   next warp and past the total at N in {32, 33, 64, 65, 87, 1024} and B
   up to 32, and batch costs from a constant 1 up to 4097); then the
   launch floor (a one-cycle sleep kernel) and device times of kernel,
   twin and (group_reduce) the nearest PyTorch calls, with CUDA events
   around launches queued behind a sleep kernel, median of many, each
   kernel's time also printed as its excess over the floor;
3. the solo path: `BWRaftSim(CONFIG, seed=0)`, managed, 3 epochs, then
   2 more at phi=0.02, with every launch count set to 0 just before and
   read just after (each per-tick kernel once per tick: 500), keeping
   the operands of the four per-tick kernels' calls of tick 250 (with
   the ops' keyword arguments); those kernels against their twins on the
   kept operands and their device times there, beside phase 2's floor,
   with the rows due and the nodes idle at that tick; then the
   quickstart's client sequence through `BWKVService`;
4. one solo epoch from the same state and draw bundle on the card
   (kernels) and on the CPU (twins): integer and bool results equal,
   float results within rtol=1e-5 (float32 sums reduce in another order
   on the card);
5. the fleet path: one `FleetSim` of B=5 members at CONFIG — BW-Raft,
   Raft, two grouped Multi-Raft shards at chi=0.1, and BW-Raft with the
   550-slot digest-observer rack — for 3 epochs, counts set to 0 just
   before and read just after (each per-tick kernel and ae_sync 300
   launches, once per tick for the whole fleet; group_reduce 3), keeping
   the operands of ae_sync's call of tick 250 and of group_reduce's of
   epoch 1; both kernels against their twins on the kept operands and
   their device times there beside phase 2's floor, ae_sync also on the
   members with no slot due, with the slots due at that tick; then a
   sync-free check over 3 batched ticks;
6. the fixed-role sweep: `FleetSim.from_sweep(CONFIG, ...)` at B=32,
   unmanaged, `run(1)`, `lease_fixed(2, 8)`, `run(2)` on the
   multi-epoch path;
7. one fleet epoch, group digest included, on the card and on the CPU
   from the same state and bundles, held as in phase 4;
8. the compiled instructions of the attention and SSD libraries
   (`cuobjdump -sass`: HGMMA, HMMA, UTMALDG and LDGSTS counts; fatal if
   the flash library has no HGMMA or the ssd_scan library neither HGMMA
   nor HMMA, a note if cuobjdump is absent); the two attention
   kernels against their twins on the card, bfloat16 and float32,
   causal and not, ragged S, T and cache_len, S < T and S > T, the
   tensor-core route's tile edges (S = 1, 63, 64, 65, 127, 129; T off
   the 64-row tile; cache_len 1 and T), GQA groups 1, 3 and 8, hd 16 to
   128, phase 16(b)'s serve shapes (prefill B = 8, S = 128 at 64 heads
   over 8 and 16 over 16 with hd 128, 16 over 16 with hd 64; decode at
   capacity 144 with ragged cache_len, vision's cross cache of 1,600
   image tokens all read, seamless's cross cache of capacity 144 with
   cache_len 128), within float32 2e-4 / bfloat16 3e-2, with the
   launches of each route (tensor_core: bf16 at hd 64/128; scalar: the
   rest) printed and both routes required to run; then device times
   of kernel, twin and one library call (`scaled_dot_product_attention`,
   timed only) at the serve shapes (flash B=8, S=512, 15 heads over 5,
   hd=64; decode B=8, T=544) and the long ones (flash B=1, S=8192;
   decode B=32, T=32768), kernel and library each on inputs rotated through enough copies to
   defeat the L2, and decode also with one split (no combine) and at
   B=1, T=32768, where its cache splits matter;
9. the SSD scan against its twin on the card: bfloat16 and float32
   inputs, y in the input dtype and in float32, one chunk and ragged
   chunks (Q = 48, 100), H = 24, P = 64, N = 128 at B = 1 and 8, the
   reduced P = N = 16, every route's (P, N) mixes of 16, 64 and 128, the
   Jamba shape (B = 2, nc = 2, Q = 128, H = 8, P = 128, N = 64), and the
   tensor-core route's tile edges (Q = 1, 63, 64, 65, 100, 255, 256 at
   nc = 1 and 3), within float32 2e-4 / bfloat16 3e-2, with the launches
   of each route (tensor_core: bf16 with P, N in {64, 128}; scalar: the
   rest) printed and both routes required to run; then device times of
   kernel and twin at the serve shape (x (8,2,256,24,64) bf16, y f32)
   and the long one (B = 1, S = 65,536: 256 chunks); no single PyTorch
   call computes the scan, so there is no library time;
10. serving at full width on the card and the CPU: smollm-360m cut to 2
   layers, B=2, one 128-token prefill and 8 decode steps fed the CPU's
   greedy tokens; in float32 logits within 1e-3 and the card's greedy
   tokens within the tolerance band of the CPU's best; in bfloat16 at
   most a share SERVE_BF16_SHARE of the logits outside 3e-2 and none
   beyond SERVE_BF16_MAX (random weights make attention too peaked for a
   bf16 rounding not to flip some rows); every `decode_attention` ticket
   reads 0 before the first decode launch and after each one; a float32
   failure first prints the rows outside the tolerance (count, largest
   difference, the CPU's top-2 margin) and two reruns of the card side,
   each compared bit for bit with the failing run and with the CPU;
11. the same for mamba2-130m cut to 2 layers: B=2, a 300-token prefill
   (one full chunk of 256 and a ragged one) and 8 decode steps; float32
   within SSM_F32_TOL (2e-4), bfloat16 gated by SSM_BF16_SHARE /
   SSM_BF16_MAX;
12. the serve path: `launch.serve.serve()` on smollm-360m at full width
   and depth (32 layers, bfloat16, random weights from seed 0), 64
   requests in batches of 8, prompt 512, 32 generated tokens, revoke_p
   0.1, with every launch count set to 0 just before and read just
   after (flash 32 x 8 = 256, decode 32 x 8 x 32 = 8,192, ssd_scan 0,
   every attention launch on the tensor-core route), then a sync-free
   check of a prefill and 2 decode steps: a host synchronization fails
   the run;
13. the same for mamba2-130m at full width and depth (24 SSD layers,
   bfloat16, seed 0; ssd_scan 24 x 8 = 192, all on the tensor-core
   route, every other kernel 0), and its sync-free check, fatal as in
   phase 12; with
   --profile, the mamba2 prefill's device time against the 33.10 ms it
   took with the scalar scan kernel (PERF.md) and ssd_scan's share of
   it;
14. the host services over the sim at the paper's cluster size, each
   run's launches of the six consensus kernels counted from 0 (per-tick
   kernels once a tick, ae_sync once a tick with the rack, group_reduce
   once an epoch with the group) and each run held against the CPU from
   the same state and draws (ints exact, floats rtol 1e-5): the
   trace-market fleet of `perf_faults.py` (both bundled traces x W in
   {0, 25} x no policy / a hazard-aware bid policy with bid_on_trace, 8
   managed members, 2 epochs, bids printed per epoch); the open-loop
   system fleet of `perf_serving.py` (`system_specs` under a diurnal +
   flash-crowd plan with Zipfian keys: BW-Raft with the 550-slot rack,
   the AWS trace and a bid policy, Raft, 2 Multi-Raft shards; 2 epochs;
   then the tick's sync-free check); a managed `BWRaftSim` on the AWS
   trace with the predictor calibrated on the Google evictions (3
   epochs); the three chaos drills of `perf_faults.py` (120 ticks,
   spot_bid 10, recorder on), whose card `ChaosReport` must equal the
   CPU's, pass `invariants.check_all`, replay the probe's leader
   timeline from the trace, and write a Perfetto file; epoch walls and
   (member-)ticks/s printed;
15. the training path: (a) one train step of smollm-360m at full width
   cut to 2 layers (B = 4, S = 64) on the card and on the CPU from the
   same weights and batch, float32 (TF32 off) and bfloat16, M = 1 and
   2, loss and grad_norm within TRAIN_GATES and every updated parameter
   within 2 x lr + one rounding (AdamW's first step is at most lr in
   size), and the card's step rerun from the same start and held to the
   same bounds (its embedding backward accumulates with atomics, so a
   rerun need not be bit-equal); (b) `launch.train.main` at full width and
   depth (TRAIN_ARGS: 32 layers, bf16 weights, f32 AdamW, B = 8, S =
   64, 6 steps, checkpoints at steps 3 and 6 of about 3.6 GB in a
   temporary directory, pod 1 failing at step 4) with the coordinator on
   the paper's cluster, counts set to 0 just before: finite losses,
   every CKPT_COMMIT in the replicated log and the last one and the
   MEMBERSHIP record in the leader's state machine, then the leader pod
   killed, a new leader, and the last committed checkpoint restored bit
   for bit with its digest tag the record's; each per-tick consensus
   kernel launched once per coordinator tick, every other kernel 0;
   ms per train step, training tokens/s, save, restore and commit
   times, ticks per commit and peak memory printed;
16. MoE, cross-attention and the encoder-decoder (ROADMAP.md §1 item
   10d): (a) card against CPU, every cross layer's gate drawn from a
   normal distribution and the context (image embeddings or frames)
   seeded, since the zero init and the serve loop's zero stubs would
   leave those paths numerically dead: qwen2-moe-a2.7b at full width
   cut to 2 layers and seamless-m4t-medium cut to 2 + 2 layers, each in
   float32 and bfloat16 (B = 2, a 128-token prefill, 8 decode steps);
   llama-3.2-vision-90b at full width, one period of 5 layers, in
   bfloat16 (a 64-token prefill, 4 decode steps), after printing the
   host's free RAM and failing below VISION_HOST_GIB; the reduced
   vision and the reduced Jamba in float32.  Each run's attention
   kernel calls are held, on the operands the run gave them, to a
   float64 evaluation: within 3e-2 / 2e-4 (1 + |exact|) plus TWIN_SLACK
   times the twin's distance from it; in float32 each layer, given the
   CPU's input, against the CPU's output (LAYER_F32_SHARE outside 1e-3
   at most, none past LAYER_F32_MAX); for qwen2-moe in float32 and the
   reduced Jamba also every logit within 1e-3 (phase 10's gate); the
   weights are drawn on the card and copied to the host.
   The other whole-model figures are printed: these random models
   amplify rounding through their layers;
   (b) `launch.serve.serve()` (SERVE_10D: 16 requests in batches of 8,
   prompt 128, 16 generated tokens, bf16, seed 0) on qwen2-moe-a2.7b
   at 8 of its 24 layers, seamless-m4t-medium (12 + 12) at full depth
   and llama-3.2-vision-90b at one period, counts set to 0 just before and
   read just after: flash once per self-attention layer per batch,
   decode once per self-attention and once per cross layer per token,
   all on the tensor-core route; tokens/s, prefill and decode ms and
   peak memory printed; then each model's sync-free check as in phase
   12;
17. the expert-parallel MoE (ROADMAP.md §1 item 10e): `moe_apply` on
   DTensors over a (1, ep) ("data", "model") mesh of ep gloo ranks that
   share the card (ep 4 and 8, spawned with a FileStore in a temporary
   directory; gloo stages the CUDA tensors through the host; a rank
   that raises, dies or runs past MOE_EP_TIMEOUT fails the phase), at
   full width: qwen2-moe-a2.7b (D 2048, 60 experts padded to 64, top-4,
   F 1408, shared experts 5632) and qwen3-moe-30b-a3b (128 experts,
   top-8, F 768), in float32 and bfloat16, a prefill shape (B 8, S 512:
   the a2a form) and a decode shape (B 8, S 1: the psum form); (a) at
   capacity 8.0 the gathered output against the dense form on the card
   from the same weights and tokens (float32 within 1e-4, bfloat16
   gated by MOE_EP_BF16_SHARE and MOE_EP_BF16_MAX) and nothing dropped;
   (b) at the configured 1.25, float32, each rank's body on the card
   against the same body on the CPU over the same group: top-k ids,
   bin positions and drop masks equal, any token whose top-k flipped
   counted, printed and required to be a near-tie (MOE_EP_TIE), the
   outputs within 1e-4 where routing agrees; (c) the bodies' rank-local
   work (route, packing, expert products, combine) sync-free under
   `torch.cuda.set_sync_debug_mode("error")`, the collectives outside
   the check; (d) the wire bytes `launch.comm_stats` records for one
   layer equal to the closed form (`moe_ep_wire_bytes`); per-rank layer
   ms of each form and the dense form's are printed (host-staged
   collectives on one card: not a speed of the method);
18. the LM forward on DTensors (ROADMAP.md §1 item 10e part 2a): 4
   gloo ranks sharing the card (every functional collective of CUDA
   tensors staged through the host, `local_ranks.stage_through_host`,
   since gloo's all-gather of them kills the rank), the ("data",
   "model") host meshes 1 x 4 and 2 x 2, `make_prefill_step` /
   `make_decode_step` with a mesh: llama3.2-1b at full width, in
   float32 and bfloat16 (decode profile B 8, prompt 512, capacity 544,
   8 of its 16 layers; long profile B 1, prompt 2,048, capacity 2,080,
   8 layers in float32 and 12 in bfloat16: each depth keeps the
   witnessed rounding inside the gates, LM_MESH_CASES), qwen2-moe-a2.7b
   cut to 2 layers (bf16, 1 x 4, capacity 8.0: the expert-parallel MoE
   in the forward) and the reduced Jamba (f32, 1 x 4: `ssd_scan` on the
   rank's heads), a prefill and LM_MESH_STEPS decode steps fed the
   one-device run's greedy tokens and, layer by layer, its layer inputs
   (random weights are chaotic: an untapped full-depth run ends O(1)
   apart, PERF.md §6); (a) each rank's shard of every
   logit and cache leaf against its slice of the one-device run on the
   card from the same weights (float32 within LM_MESH_F32_TOL, bfloat16
   by LM_MESH_BF16_SHARE and LM_MESH_BF16_MAX), each float32 layer by
   LM_MESH_LAYER_SHARE and LAYER_F32_MAX, greedy tokens equal past the
   one-device top-2 margin; (b) the first decode call's (o, lse) form
   on the rank's cache shard against its twin and float64 as in phase
   16(a), also with cache_len 0, 1, T_local - 1 and T_local on the
   shards; (c) launches on every rank: flash once per attention layer a
   prefill, decode once per attention layer a step, all in the (o, lse)
   form, on the tensor cores for llama in bf16, `ssd_scan` once per SSD
   layer a prefill; (d) the merge's collectives (`launch.comm_stats`)
   of the closed form's bytes; ms a rank printed (host-staged: not a
   speed of the method);
19. the train step on DTensors and the cross layers and the encoder on
   a mesh (ROADMAP.md §1 item 10e part 2c), 4 gloo ranks sharing the
   card as in 18: `make_train_step` with a mesh (TRAIN_MESH_CASES) for
   llama3.2-1b at full width cut to 4 (f32) and 8 (bf16 parameters
   with f32 moments) of its 16 layers (B 8, S 256, 2 microbatches,
   remat "period", 2 steps; 2 x 2 with ZeRO-3 at use and 1 x 4),
   seamless-m4t-medium at full width cut to 6 + 6 of its 12 + 12
   layers (one step on 2 x 2) and qwen2-moe-a2.7b cut
   to 2 layers (f32, B 4, S 128, one step on 1 x 4: the
   expert-parallel MoE and its gradient), each against the one-device
   train step on the card from the same weights and batches (made by
   rank 0 and read by every rank from a file), each layer fed the
   one-device run's input and the gradient reaching its output
   (`launch.taps.TrainTaps`): loss, aux and grad_norm, each gradient's
   ||mesh - one device|| / ||one device||, the parameters after the
   steps, the ranks' grad_norms equal, the wire bytes of ZeRO-3's
   gathers, of the vocabulary-parallel cross entropy and of
   `global_norm` equal to the closed form (the gradient reductions
   printed), no kernel launched; then seamless serving on 1 x 4
   (TRAIN_MESH_SERVE: B 8, 128 seeded frames, 8 decode steps, gates
   drawn), layer by layer against the one-device run, its cross cache
   sharded on the KV heads and the cross decode on the rank's heads,
   launches (flash, decode (o, lse), decode plain) and the merge's
   bytes; step ms and peak memory a rank printed (host-staged: not a
   speed of the method);
20. the dry run (ROADMAP.md §1 item 10e part 2b,
   `launch/dryrun.py`): (a) llama3.2-1b at full width and 4 of its 16
   layers (DRYRUN_LAYERS, real run and trace alike), a
   prefill (B 4, S 512) and a decode step (capacity DRYRUN_CAP) on the
   1 x 4 host mesh, for real on 4 gloo ranks sharing the card (staged
   as in 18) under `launch.step_cost.StepCost`, and traced in this
   process over a fake group of 4 with fake CUDA tensors: the
   collective tables (count, result and wire bytes) and the FLOPs
   equal, each rank's argument bytes as the allocator holds them equal
   to the dry run's up to its rounding of each tensor (DRYRUN_ROUND),
   and the arguments plus the step's measured peak
   (`max_memory_allocated` over the step) within DRYRUN_PEAK_BAND of
   the dry run's args + out + temp - alias; (b) the production cells
   of DRYRUN_CELLS in worker processes beside (a), each OK with the
   kernels' fake calls counted (flash in a prefill, decode in a decode
   step, `ssd_scan` in mamba2's prefill; none in mamba2's decode step,
   which reaches no kernel) and no launch counted, one JSON record a
   line;
21. the frozen reference forms (ROADMAP.md §1 item 11, DESIGN.md
   §7.1): (a) `FleetSim(pipeline="host")` and the default kernel
   pipeline at CONFIG for REFERENCE_EPOCHS epochs each, from fresh
   draw sources at the same seeds, over phase 5's members without the
   grouped shards (the host pipeline refuses groups): BW-Raft managed
   at phi 0.02, Raft, and BW-Raft with the 550-slot rack; every
   EpochReport equal (counters exact, floats within FLOAT_RTOL, the
   largest difference printed), every control-plane decision equal,
   launch counts set to 0 before each run: every kernel 0 on the host
   pipeline (its reference ticks run the original forms and the twins) and
   each per-tick kernel and ae_sync once a tick on the device one, and
   the device pipeline's d2h bytes under a hundredth of the host's;
   each pipeline's epoch walls printed; (b) `spot_step` at warn_ticks
   = 0 (no faults, the init-time bid) against `spot_step_reference`
   for SPOT_GATE_TICKS ticks from a leased state at CONFIG, on the
   process market and on an exported-walk trace market: prices, kills
   and roles bit for bit, and at least one kill;
22. `launch/train.py` on the ranks that exist (the trainer on a mesh):
   4 gloo ranks sharing the card (collectives staged through the host,
   as in 18), each running `launch.train.train` of TRAIN_DIST_ARGS
   (smollm-360m at full width cut to TRAIN_DIST_LAYERS of its 32
   layers, bf16 weights, f32 AdamW, B 8, S 64, 4 steps, checkpoints at
   2 and 4, pod 1 failing at 3, the coordinator on rank 0 over the
   paper's cluster) on the (4, 1) host mesh, launch counts set to 0
   just before and read just after; meanwhile the same function on one
   device of the card in this process.  Gates: the initial state's
   digest equal on the mesh and on one device; every rank's losses,
   grad_norms, save digests and membership equal; the first step's loss
   within TRAIN_DIST_STEP0 of one device's, every later step's and the
   TRAIN_DIST_MORE steps' after the restore within
   TRAIN_DIST_LATER_LOSS (the bf16 grad_norms printed: the mesh sums
   bf16 partial products over "data", PERF.md §6, PR 31); the first
   TRAIN_DIST_F32_STEPS steps in float32 (the same weights and batches
   through the trainer's step with a float32 RunConfig) on the mesh:
   each AdamW update bit for bit the same update run on one device from
   copies of the rank's shards before it, and the first step's loss and
   grad_norm within TRAIN_DIST_STEP0 of one device's;
   commits [2, 4], each in the leader's replicated log and the last in
   its state machine, one coordinator (rank 0), membership 0b1101;
   each checkpoint's keys, shapes and dtypes those of the one-device
   checkpoint, its manifest digest the digest of the tree read back on
   the host and its first 3 hex digits the committed tag; the last mesh
   checkpoint and the one-device one restored onto the mesh, each
   rank's shard bit for bit its slice of the stored tensor, and the
   mesh checkpoint restored on one device bit for bit the files; each
   save's gathered bytes (`launch.comm_stats`) the closed form (each
   sharded leaf's bytes x 3/4); rank 0 each per-tick consensus kernel
   once a coordinator tick, ranks 1-3 none, no flash, decode or
   `ssd_scan` launch; ms per step a rank, save, gather, restore and
   commit ms, ticks per commit and peak memory printed (host-staged:
   not a speed of the method);
23. a `kernels` JSON line (with each kernel's launches in phase 15,
   `launches_train`, in phase 16(b) by model, `launches_10d`, in phase
   17 by ep, `launches_moe_ep`: none of them is on that path, in phase
   18 by case, `launches_lm_mesh`, and for decode
   `launches_lm_mesh_lse`, in phase 19's serving `launches_train_mesh`
   and `launches_train_mesh_lse`, for flash, decode and `ssd_scan` their
   fake calls in phase 20(b), `fake_calls_dryrun`; for decode also the
   (o, lse) form's phase-8 times `ms_lse`, `plain_ms_lse`,
   `bound_ms_lse` and their `_long`; for the six consensus kernels
   their launches on phase 21(a)'s host pipeline,
   `launches_host_pipeline` (0), and for every kernel its launches in
   phase 22 by rank, `launches_train_dist`), the
   `total` seconds, the card line, and the last line
   `{"ok": true, "device": {...}}`.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
INT_OPS_PER_S = 67e12              # non-tensor-core 32-bit rate (fp32 peak)
MATMUL_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
                "float32": 67e12}      # f32 outside the tensor cores
FLOAT_RTOL = 1e-5
ATT_TOL = {"float32": 2e-4, "bfloat16": 3e-2}     # rtol = atol
# card vs CPU logits of the 2-layer full-width model in float32: the model
# amplifies float32 rounding (its random attention scores are hundreds
# wide), so the two devices are held at 1e-3, five times the kernels' 2e-4
SERVE_F32_TOL = 1e-3
# ... and in bfloat16 at the kernels' 3e-2, which a small share of logits
# may exceed: one bf16 rounding of a score can flip the key a row attends
# to.  Chip readings on the H100: 379 of 13,369,344 logits (2.8e-5)
# outside 3e-2, the largest 0.0472; the gate allows a share of 1e-4 and
# a largest difference of 0.125
SERVE_BF16_SHARE = 1e-4
SERVE_BF16_MAX = 0.125
# card vs CPU logits of the 2-layer full-width mamba2-130m (no attention to
# amplify rounding).  Chip readings on the H100: float32 all 31,066,112
# logits within 1e-3, the largest difference 5.7e-5, so the gate is 2e-4;
# bfloat16 one logit outside 3e-2 (a share of 3.2e-8), the largest 0.0391
# (a bf16 rounding of a scan weight or projection landing on the other
# side of a tie), so the gate allows a share of 1e-6 and at most 0.1
SSM_F32_TOL = 2e-4
SSM_BF16_SHARE = 1e-6
SSM_BF16_MAX = 0.1
L2_DEFEAT_BYTES = 128 * 2 ** 20    # > the 50 MB L2: rotate input copies
SERVE = dict(requests=64, batch=8, prompt_len=512, gen_len=32,
             revoke_p=0.1, seed=0)
REPLACES = {
    "log_match_append": "src/repro/kernels/raft_tick/kernel.py:108",
    "commit_majority": "src/repro/kernels/raft_tick/kernel.py:173",
    "apply_last_wins": "src/repro/kernels/raft_tick/kernel.py:221",
    "leader_fanout": "src/repro/kernels/leader_fanout/kernel.py:124",
    "ae_sync": "src/repro/kernels/ae_sync/kernel.py:107",
    "group_reduce": "src/repro/kernels/group_digest/kernel.py:61",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:64",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:57",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:79",
}
SOURCE = {
    "log_match_append": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "commit_majority": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "apply_last_wins": "src/repro_torch/kernels/csrc/raft_tick.cu",
    "leader_fanout": "src/repro_torch/kernels/csrc/leader_fanout.cu",
    "ae_sync": "src/repro_torch/kernels/csrc/ae_sync.cu",
    "group_reduce": "src/repro_torch/kernels/csrc/group_digest.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}
RAFT = ("log_match_append", "commit_majority", "apply_last_wins",
        "leader_fanout", "ae_sync", "group_reduce")
PER_TICK = ("log_match_append", "commit_majority", "apply_last_wins",
            "leader_fanout")
FLEET_B = 5
SWEEP_B = 32
# the ops whose operands phase 3 keeps (the solo path's own data), by the
# module `core/step.py` reaches them through, with their operand names,
# and the call kept: mid-epoch, epoch 2, tick 50
MAIN_DATA = {
    "log_match_append": ("rt_ops", (
        "log_term", "log_key", "log_val", "ldr_term", "ldr_key", "ldr_val",
        "log_len", "app_from_len", "app_upto", "due")),
    "commit_majority": ("rt_ops", (
        "match_len", "voter_alive", "ldr_term", "ldr_cur_term",
        "majority")),
    "apply_last_wins": ("rt_ops", ("kv", "keys", "vals", "valid")),
    "leader_fanout": ("lf_ops", (
        "role", "alive", "warn_timer", "sec_of", "match_len",
        "app_arrive_t", "app_from_len", "app_upto", "app_term",
        "app_commit", "rtt", "lid_c", "has_leader", "tick", "ldr_len",
        "ldr_term", "ldr_commit"))}
MAIN_DATA_AT = 250
# the ops whose operands phase 5 keeps (the fleet path's own data): the
# digest tier's round at tick 250 of 300 through `core/step.py`, and the
# group digest of epoch 1 of 3 through `core/fleet.py`
FLEET_DATA = {
    "ae_sync": ("ae_ops", (
        "dobs_alive", "dobs_fol", "dobs_applied", "dobs_term", "dobs_digest",
        "dobs_synced_t", "ae_phase", "dobs_site", "alive", "is_voter",
        "applied_len", "term", "applied_digest", "site", "site_rtt", "tick",
        "ae_interval")),
    "group_reduce": ("gd_ops", ("gids", "int_mat", "flt_mat"))}
FLEET_DATA_AT = {"ae_sync": 250, "group_reduce": 1}
# the redesigned kernels ptxas must not spill for (phase 1) ...
AE_KERNELS = ("ae_sync_kernel<1>", "ae_sync_kernel<0>")  # N <= 128; any
NO_SPILL = ("lma_kernel", "fanout_kernel", *AE_KERNELS,
            "group_reduce_kernel")
# ... and, by library, those with no block barrier and no shared memory,
# hence no shared-memory atomic (ptxas and, where cuobjdump exists, the
# library's SASS)
NO_BARRIER = {"ae_sync": AE_KERNELS}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def phase(n):
    """Print `phase n <seconds> s` when the block ends: every phase's
    share of the time limit in one log."""
    t0 = time.perf_counter()
    yield
    log(f"phase {n} {time.perf_counter() - t0:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# phase 1: the ptxas report
# --------------------------------------------------------------------- #
def kernel_name(mangled: str) -> str:
    """`_Z10lma_kernelPi...` -> `lma_kernel`, `_Z13commit_kernelILi256EE...`
    -> `commit_kernel<256>`: the name and integer template arguments of a
    mangled kernel, or the mangled name where it does not parse."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    n, rest = int(m.group(1)), mangled[m.end():]
    name, rest = rest[:n], rest[n:]
    if rest.startswith("I"):
        args = []
        rest = rest[1:]
        while True:
            a = re.match(r"L[a-z]+(n?\d+)E", rest)
            if not a:
                break
            args.append(a.group(1).replace("n", "-"))
            rest = rest[a.end():]
        if args and rest.startswith("E"):
            name += "<" + ", ".join(args) + ">"
    return name


def ptxas_report(text: str):
    """[(kernel name, line)] for each register or spill line of an
    `nvcc -Xptxas -v` log, each under the function it describes."""
    out, fn = [], "?"
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", ln)
        if m:
            fn = kernel_name(m.group(1))
        elif "registers" in ln or "spill" in ln:
            out.append((fn, ln.strip().replace("ptxas info    : ", "")))
    return out


def check_barrier_free(libs):
    """Each NO_BARRIER kernel: ptxas reports 0 barriers and no shared
    memory, and its library's SASS (cuobjdump, where present) holds no
    BAR and no ATOMS instruction."""
    tool = cuobjdump_path()
    for lib, fns in NO_BARRIER.items():
        report = ptxas_report(libs[lib].with_suffix(".log").read_text())
        for fn in fns:
            used = [ln for f, ln in report if f == fn and "registers" in ln]
            if not used or "used 0 barriers" not in used[0] or \
                    "smem" in used[0]:
                raise AssertionError(f"{fn}: ptxas reports a barrier or "
                                     f"shared memory: {used}")
            log(f"  {fn}: no block barrier, no shared memory (ptxas: "
                f"{used[0]})")
        if tool is None:
            log(f"  {lib}: SASS not checked (no cuobjdump)")
            continue
        sass = subprocess.run([tool, "-sass", str(libs[lib])],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        n = {op: len(re.findall(rf"\b{op}\b", sass))
             for op in ("BAR", "ATOMS")}
        if any(n.values()):
            raise AssertionError(f"{lib}: SASS holds {n}")
        log(f"  {lib}: SASS holds BAR {n['BAR']}, ATOMS {n['ATOMS']}")


# --------------------------------------------------------------------- #
# phase 2: kernels against their twins
# --------------------------------------------------------------------- #
def device_ms(fn, reps: int, sleep_cycles: int) -> float:
    """Median device time of `fn()` in ms: a sleep kernel holds the
    stream while the host enqueues the events and `fn`'s launches, so the
    events bracket device work only, not host overhead."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lma_case(rng, B, N, L, W, *, due_frac=0.5, empty=False):
    import numpy as np
    hi = 1 if empty else L + 1
    frm = rng.integers(0, hi, (B, N))
    return dict(
        log_term=rng.integers(0, 4, (B, N, L)),
        log_key=rng.integers(0, 8, (B, N, L)),
        log_val=rng.integers(0, 64, (B, N, L)),
        ldr_term=rng.integers(0, 4, (B, L)),
        ldr_key=rng.integers(0, 8, (B, L)),
        ldr_val=rng.integers(0, 64, (B, L)),
        log_len=rng.integers(0, hi, (B, N)), app_from_len=frm,
        app_upto=np.minimum(frm + rng.integers(-8, W + 40, (B, N)), L),
        due=rng.random((B, N)) < due_frac)


def lma_edge_case(rng, kind, B, N, L, W):
    """A window edge, every row due: "from0" (prev < 0 reads position 0,
    which the window overwrites with another term), "fromL", "upto"
    (upto below from), "longer" (a matching log longer than the window)
    or "wide" (a window of W, past what the threads hold in registers
    when W > 256)."""
    import numpy as np
    c = lma_case(rng, B, N, L, W, due_frac=1.0)
    if kind == "from0":
        c["app_from_len"][:] = 0
        c["app_upto"] = rng.integers(1, W + 1, (B, N))
        c["log_term"][:, :, 0] = c["ldr_term"][:, None, 0] + 1
    elif kind == "fromL":
        c["app_from_len"][:] = L
        c["app_upto"][:] = L
        c["log_term"][:, ::2, L - 1] = c["ldr_term"][:, None, L - 1]
    elif kind == "upto":
        c["app_from_len"] = rng.integers(4, L + 1, (B, N))
        c["app_upto"] = c["app_from_len"] - rng.integers(1, 4, (B, N))
    elif kind == "longer":
        c["log_term"][:] = c["ldr_term"][:, None, :]
        c["log_len"][:] = L
        c["app_from_len"] = rng.integers(1, L - W, (B, N))
        c["app_upto"] = c["app_from_len"] + W // 2
    elif kind == "wide":
        c["app_upto"] = np.minimum(c["app_from_len"] + W + 40, L)
    return c


def fanout_cut_case(rng, B, N, L, cut, kw):
    """Every node a live follower of leader 0 with nothing in flight,
    nodes 1-2 secretaries, node 3 relayed (n_sec = 2), the rest direct;
    returns (case, msg_budget) with member 0's rank cut on lane 31
    ("lane31"), lane 0 of the next warp ("lane32") or past the total
    ("past")."""
    import numpy as np
    c = fanout_case(rng, B, N, L, alive_frac=1.0)
    c["role"][:] = 0
    c["role"][:, 1:3] = 3
    c["warn_timer"][:] = -1
    c["sec_of"][:] = -1
    c["sec_of"][:, 3] = 1
    c["app_arrive_t"][:] = -1
    c["lid_c"][:] = 0
    pending = np.maximum(c["ldr_len"][0] - c["match_len"][0], 0)
    cost = 1 + np.minimum(pending, kw["max_ship"]) // kw["entries_per_msg"]
    rank = np.cumsum(np.where(np.arange(N) > 3, cost, 0))
    at = {"lane31": rank[31], "lane32": rank[min(32, N - 1)],
          "past": rank[-1] + 1}[cut]
    return c, int(at) + 2


def commit_case(rng, B, N, L, *, dead_frac=0.3, majority=None, over=0):
    """Random terms (not monotone); match lengths in [0, L], or with
    over > 0 in [L, L + over], so the majority-th largest is past L."""
    import numpy as np
    maj = (rng.integers(0, N + 3, B) if majority is None
           else np.full(B, majority))
    return dict(match_len=rng.integers(L if over else 0, L + 1 + over,
                                       (B, N)),
                voter_alive=rng.random((B, N)) >= dead_frac,
                ldr_term=rng.integers(0, 3, (B, L)),
                ldr_cur_term=rng.integers(0, 3, B), majority=maj)


def apply_case(rng, B, N, K, A, *, keys="random", valid_frac=0.7):
    """keys: "random" in [-K-3, K+3), "one" (one key for every entry of a
    row) or "edge" (-K-1, -1, K, K+1 and the in-range ends 0, K-1)."""
    import numpy as np
    if keys == "one":
        k = np.repeat(rng.integers(-K - 3, K + 3, (B, N, 1)), A, axis=2)
    elif keys == "edge":
        k = rng.choice(np.array([-K - 1, -1, K, K + 1, 0, K - 1]),
                       (B, N, A))
    else:
        k = rng.integers(-K - 3, K + 3, (B, N, A))
    return dict(kv=rng.integers(-4, 4, (B, N, K)), keys=k,
                vals=rng.integers(0, 2 ** 20, (B, N, A)),
                valid=rng.random((B, N, A)) < valid_frac)


def fanout_case(rng, B, N, L, *, has_leader=True, alive_frac=0.8,
                warn_frac=0.3):
    import numpy as np
    warn = np.where(rng.random((B, N)) < warn_frac,
                    rng.integers(0, 5, (B, N)), -1)
    arrive = np.where(rng.random((B, N)) < 0.6, -1,
                      rng.integers(0, 40, (B, N)))
    return dict(
        role=rng.integers(0, 6, (B, N)),
        alive=rng.random((B, N)) < alive_frac,
        warn_timer=warn, sec_of=rng.integers(-1, N, (B, N)),
        match_len=rng.integers(0, L + 1, (B, N)), app_arrive_t=arrive,
        app_from_len=rng.integers(0, L + 1, (B, N)),
        app_upto=rng.integers(0, L + 1, (B, N)),
        app_term=rng.integers(0, 4, (B, N)),
        app_commit=rng.integers(0, L + 1, (B, N)),
        rtt=rng.integers(1, 20, (B, N, N)), lid_c=rng.integers(0, N, B),
        has_leader=np.full(B, has_leader), tick=rng.integers(0, 100, B),
        ldr_len=rng.integers(0, L + 1, B), ldr_term=rng.integers(0, 4, B),
        ldr_commit=rng.integers(0, L + 1, B))


def ae_case(rng, B, O, N, S, *, voter_frac=0.1, interval=4):
    import numpy as np
    return dict(
        dobs_alive=rng.random((B, O)) < 0.8,
        dobs_fol=rng.integers(-1, N + 2, (B, O)),
        dobs_applied=rng.integers(0, 4097, (B, O)),
        dobs_term=rng.integers(0, 4, (B, O)),
        dobs_digest=rng.integers(-2 ** 31, 2 ** 31, (B, O)),
        dobs_synced_t=rng.integers(-1, 400, (B, O)),
        ae_phase=rng.integers(0, 9, (B, O)),
        dobs_site=rng.integers(0, S, (B, O)),
        alive=rng.random((B, N)) < 0.8,
        is_voter=rng.random((B, N)) < voter_frac,
        applied_len=rng.integers(0, 4097, (B, N)),
        term=rng.integers(0, 4, (B, N)),
        applied_digest=rng.integers(-2 ** 31, 2 ** 31, (B, N)),
        site=rng.integers(0, S, (B, N)),
        site_rtt=rng.integers(1, 20, (B, S, S)),
        tick=rng.integers(0, 500, B), ae_interval=np.full(B, interval))


def ae_edge_case(rng, kind, B, O, N, S, interval):
    """An `ae_case` at an edge of the kernel: "last_word" (the alive
    voters all in the last 32-node word), "fol_out" (wired followers at
    -1, -5, N, N + 3 and in range), "neg_tick" (tick + phase below 0) or
    "random"."""
    import numpy as np
    c = ae_case(rng, B, O, N, S, voter_frac=0.6, interval=interval)
    if kind == "last_word":
        lo = (N - 1) // 32 * 32
        c["alive"][:, :lo] &= ~c["is_voter"][:, :lo]
        c["alive"][:, N - 1] = c["is_voter"][:, N - 1] = True
        c["dobs_fol"][:, ::3] = N - 1
    elif kind == "fol_out":
        c["dobs_fol"] = rng.choice(np.array([-1, -5, N, N + 3, 0, N - 1]),
                                   (B, O))
    elif kind == "neg_tick":
        c["tick"][:] = -13
        c["ae_phase"] = rng.integers(-9, 4, (B, O))
    return c


def ae_due(c):
    """The anti-entropy due rule and source of a case, in numpy: (due
    (B, O), src (B, O))."""
    import numpy as np
    a = lambda k: np.asarray(c[k])
    fol = a("dobs_fol").astype(np.int64)
    av = a("alive").astype(bool) & a("is_voter").astype(bool)
    fc = np.clip(fol, 0, av.shape[1] - 1)
    fol_ok = (fol >= 0) & np.take_along_axis(av, fc, 1)
    src = np.where(fol_ok, fc, np.argmax(av, 1)[:, None])
    interval = np.maximum(a("ae_interval").astype(np.int64), 1)[:, None]
    due = a("dobs_alive").astype(bool) & (fol_ok | av.any(1)[:, None]) & (
        (a("tick").astype(np.int64)[:, None] + a("ae_phase")) % interval
        == 0)
    return due, src


def group_edge_case(rng, B, G, *, empty=None, Fi=20):
    """Ids over [0, G] (G drops), group `empty` left empty; int lanes
    over all of int32 (the sums wrap); six float lanes: general values,
    only +0 / -0, -0 / -inf / -1.5, values with NaN, -inf / +inf / 1,
    values with +-0."""
    import numpy as np
    gids = rng.integers(0, G + 1, B)
    if empty is not None:
        gids[gids == empty] = (empty + 1) % G
    pick = lambda vals: rng.choice(np.array(vals, np.float32), B)
    normal = (rng.standard_normal(B) * 100.0).astype(np.float32)
    flt = np.stack([
        normal, pick([0.0, -0.0]), pick([-0.0, -np.inf, -1.5]),
        np.where(rng.random(B) < 0.1, np.float32(np.nan), normal[::-1]),
        pick([-np.inf, np.inf, 1.0]),
        np.where(rng.random(B) < 0.5, pick([0.0, -0.0]), normal)], 1)
    return dict(gids=gids, int_mat=rng.integers(-2 ** 31, 2 ** 31, (B, Fi)),
                flt_mat=flt.astype(np.float32))


def group_case(rng, B, G, Fi, Ff, *, dropped=0.0):
    import numpy as np
    gids = np.where(rng.random(B) < dropped, G, rng.integers(0, G, B))
    return dict(gids=gids, int_mat=rng.integers(-50, 2 ** 20, (B, Fi)),
                flt_mat=(rng.standard_normal((B, Ff)) * 1e3
                         ).astype(np.float32))


def to_dev(case, dev):
    import numpy as np
    import torch
    out = {}
    for k, v in case.items():
        a = np.asarray(v)
        if a.dtype not in (bool, np.float32):
            a = a.astype(np.int32)
        out[k] = torch.as_tensor(a, device=dev)
    return out


def clone(case):
    return {k: v.clone() for k, v in case.items()}


def check_equal(name, got, want):
    """Equal bit for bit (+0 and -0 apart); a float NaN matches a NaN
    whatever its payload (the card's adder returns its canonical NaN)."""
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        same = g.dtype == w.dtype and g.shape == w.shape
        if same and g.dtype.is_floating_point:
            nan = torch.isnan(w)
            same = torch.equal(torch.isnan(g), nan)
            g = g.masked_fill(nan, 0).view(torch.int32)
            w = w.masked_fill(nan, 0).view(torch.int32)
        if not (same and torch.equal(g, w)):
            raise AssertionError(f"{name}: output {i} differs from the twin")


def kernel_fns():
    """{name: fn(case, twin, kw) -> outputs}: each op, or its twin, on a
    case dict whose values are its operands in order."""
    from repro_torch.kernels.ae_sync import ops as ae
    from repro_torch.kernels.ae_sync import ref as ae_ref
    from repro_torch.kernels.group_digest import ops as gd
    from repro_torch.kernels.group_digest import ref as gd_ref
    from repro_torch.kernels.leader_fanout import ops as lf
    from repro_torch.kernels.leader_fanout import ref as lf_ref
    from repro_torch.kernels.raft_tick import ops as rt
    from repro_torch.kernels.raft_tick import ref as rt_ref

    def pick(op, twin):
        return lambda t: twin if t else op

    lma = pick(rt.log_match_append, rt_ref.log_match_append_ref)
    com = pick(rt.commit_majority, rt_ref.commit_majority_ref)
    app = pick(rt.apply_last_wins, rt_ref.apply_last_wins_ref)
    fan = pick(lf.leader_fanout, lf_ref.leader_fanout_ref)
    aes = pick(ae.ae_sync, ae_ref.ae_sync_ref)
    grp = pick(gd.group_reduce, gd_ref.group_reduce_ref)
    return {
        "log_match_append": lambda c, t, kw: lma(t)(*c.values(),
                                                    w=kw["max_ship"]),
        "commit_majority": lambda c, t, kw: (com(t)(*c.values()),),
        "apply_last_wins": lambda c, t, kw: (app(t)(*c.values()),),
        "leader_fanout": lambda c, t, kw: fan(t)(
            *c.values(), msg_budget=kw["msg_budget"],
            max_ship=kw["max_ship"],
            entries_per_msg=kw["entries_per_msg"]),
        "ae_sync": lambda c, t, kw: aes(t)(*c.values()),
        "group_reduce": lambda c, t, kw: grp(t)(*c.values(),
                                                n_groups=kw["G"]),
    }


def group_library(c, G):
    """The nearest PyTorch calls to group_reduce, three of them:
    `index_add_` for the int sums and for the float sums, and
    `scatter_reduce_("amax")` for the max; dropped members land in a
    spare row G."""
    import torch
    gids = c["gids"].long()
    gids = torch.where((gids >= 0) & (gids < G), gids, G)
    B, Fi = c["int_mat"].shape
    Ff = c["flt_mat"].shape[1]
    dev = gids.device
    g_int = torch.zeros((G + 1, Fi), dtype=torch.int32, device=dev)
    g_int.index_add_(0, gids, c["int_mat"])
    g_sum = torch.zeros((G + 1, Ff), dtype=torch.float32, device=dev)
    g_sum.index_add_(0, gids, c["flt_mat"])
    g_max = torch.full((G + 1, Ff), -torch.inf, device=dev)
    g_max.scatter_reduce_(0, gids[:, None].expand(B, Ff), c["flt_mat"],
                          "amax")
    return g_int[:G], g_sum[:G], g_max[:G]


def launch_floor_ms() -> float:
    """The device time of an empty launch under `device_ms`: a one-cycle
    sleep kernel."""
    import torch
    return device_ms(lambda: torch.cuda._sleep(1), 100, 4_000_000)


def run_kernel_checks(dev, cfg, static, fleet_shapes):
    """Every kernel == its twin on the card, at the solo path's shapes
    (B=1), at the fleet path's (B=5), at the sweep's (B=32) and on the
    edge cases; then device times beside the launch floor.  Returns
    ({name: {tag: {ms, plain_ms, library_ms, bytes, ops}}} for tag
    "solo" (the four slice-1 kernels) and "fleet" (all six), the floor
    in ms)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K_

    N = static["N"]
    L, K = cfg.max_log, cfg.key_space
    W, A = static["max_ship"], static["max_apply"]
    O, S, Fi, G = (fleet_shapes["O"], fleet_shapes["S"], fleet_shapes["Fi"],
                   fleet_shapes["G"])
    kw = dict(msg_budget=static["msg_budget"], max_ship=W,
              entries_per_msg=static["entries_per_msg"], G=G)
    B = FLEET_B
    rng = np.random.default_rng(0)
    maj = static["majority"]
    # (tag or None, case, kwargs override): the tagged cases are timed
    cases = {
        "log_match_append": [
            ("solo", lma_case(rng, 1, N, L, W), {}),
            ("fleet", lma_case(rng, B, N, L, W), {}),
            (None, lma_case(rng, 1, N, L, W, due_frac=1.0), {}),
            (None, lma_case(rng, 1, N, L, W, due_frac=0.0), {}),
            (None, lma_case(rng, 1, N, L, W, empty=True, due_frac=1.0), {}),
            (None, lma_case(rng, 1, 1, 1, 1, due_frac=1.0), {}),
            (None, lma_case(rng, 3, 5, 33, 256, due_frac=1.0), {})],
        "commit_majority": [
            ("solo", commit_case(rng, 1, N, L, majority=maj), {}),
            ("fleet", commit_case(rng, B, N, L, majority=maj), {}),
            (None, commit_case(rng, B, N, L), {}),   # mixed majorities
            (None, commit_case(rng, 1, N, L, dead_frac=1.0), {}),
            (None, commit_case(rng, 1, N, L, dead_frac=0.0), {}),
            (None, commit_case(rng, 1, 9, 40, majority=0), {}),
            (None, commit_case(rng, 1, N, L, majority=N + 3), {}),
            (None, commit_case(rng, 1, 1, 16, majority=1), {}),
            (None, commit_case(rng, SWEEP_B, N, L), {})],
        "apply_last_wins": [
            ("solo", apply_case(rng, 1, N, K, A), {}),
            ("fleet", apply_case(rng, B, N, K, A), {}),
            (None, apply_case(rng, 1, 3, 5, A), {}),
            (None, apply_case(rng, 3, N, K, 1), {}),
            (None, apply_case(rng, SWEEP_B, N, K, A), {})],
        "leader_fanout": [
            ("solo", fanout_case(rng, 1, N, L), {}),
            ("fleet", fanout_case(rng, B, N, L), {}),
            (None, fanout_case(rng, 1, N, L, has_leader=False), {}),
            (None, fanout_case(rng, 1, N, L, alive_frac=0.0), {}),
            (None, fanout_case(rng, 1, N, L, warn_frac=1.0), {}),
            (None, fanout_case(rng, 1, N, L), dict(msg_budget=0)),
            (None, fanout_case(rng, 1, 1, 8), {}),
            (None, fanout_case(rng, 1, 1024, L), {})],
        "ae_sync": [
            ("fleet", ae_case(rng, B, O, N, S), {}),
            (None, ae_case(rng, 1, O, N, S, voter_frac=0.0), {}),
            (None, ae_case(rng, 3, 7, 9, 2, voter_frac=1.0, interval=1),
             {}),
            (None, ae_case(rng, 2, 130, 17, 3, interval=0), {})],
        "group_reduce": [
            ("fleet", group_case(rng, B, G, Fi, 3), {}),
            (None, group_case(rng, 13, 3, 40, 3, dropped=0.2), dict(G=3)),
            (None, group_case(rng, 6, 3, 5, 2, dropped=1.0), dict(G=3)),
            (None, group_case(rng, 37, 1, 1, 3), dict(G=1))],
    }
    # the commit's edges: N across one warp's edge and the block limit, L
    # from one entry to the paper's, each with mixed majorities (0 to
    # N + 2), no live voter, and the majority-th largest at or past L
    for n in (1, 32, 33, N, 1024):
        for ln in (1, 16, 33, L):
            cases["commit_majority"] += [
                (None, commit_case(rng, B, n, ln), {}),
                (None, commit_case(rng, 1, n, ln, dead_frac=1.0,
                                   majority=n // 2 + 1), {}),
                (None, commit_case(rng, 1, n, ln, dead_frac=0.0,
                                   majority=n // 2 + 1, over=3), {})]
    # the apply's edges: A from one lane to two warps' worth, a row's
    # entries all on one key, none valid, keys at the wrap's edges
    for a in (1, 8, 31, 32, 33, 64):
        cases["apply_last_wins"] += [
            (None, apply_case(rng, B, N, K, a), {}),
            (None, apply_case(rng, 1, N, K, a, keys="one"), {}),
            (None, apply_case(rng, 1, N, K, a, valid_frac=0.0), {}),
            (None, apply_case(rng, 3, 7, 16, a, keys="edge"), {})]
    # the append's window edges at the solo and fleet shapes; then W = 1,
    # windows past what the threads hold in registers (W = 512, 1024),
    # N = 1024 and the sweep's B = 32
    for kind in ("from0", "fromL", "upto", "longer", "wide"):
        for b in (1, B):
            cases["log_match_append"].append(
                (None, lma_edge_case(rng, kind, b, N, L, W), {}))
    for b, n, ln, w in ((1, N, L, 1), (3, 33, 64, 1), (1, N, L, 512),
                        (B, N, L, 512), (2, 9, 1500, 1024),
                        (1, 1024, 512, W), (SWEEP_B, N, L, W)):
        cases["log_match_append"].append(
            (None, lma_edge_case(rng, "wide" if w > W else "random", b, n,
                                 ln, w), dict(max_ship=w)))
    # the fan-out's rank cut across a warp's edge: on lane 31, on lane 0
    # of the next warp, past the total; N up to one block, B up to 32
    for b, n in ((1, 32), (1, 33), (1, 64), (1, 65), (1, N), (B, N),
                 (1, 1024), (SWEEP_B, N)):
        for cut in ("lane31", "lane32", "past"):
            c, budget = fanout_cut_case(rng, b, n, L, cut, kw)
            cases["leader_fanout"].append((None, c,
                                           dict(msg_budget=budget)))
    # the fan-out's batch costs from a constant 1 up to 4097
    for ms, epm in ((254, 1), (255, 1), (4096, 1), (0, 7)):
        for b, n in ((B, N), (1, 1024)):
            cases["leader_fanout"].append(
                (None, fanout_case(rng, b, n, L),
                 dict(max_ship=ms, entries_per_msg=epm,
                      msg_budget=n * (1 + ms // epm) // 3)))
    # the warned-secretary handoff: every follower wired to an alive
    # SECRETARY, half of them warned
    c = fanout_case(rng, 1, N, L, alive_frac=1.0, warn_frac=0.0)
    c["role"][:] = 0
    c["role"][0, 7:23] = 3
    c["sec_of"][0, :7] = 7 + np.arange(7)
    c["warn_timer"][0, 7:23:2] = 2
    c["app_arrive_t"][:] = -1
    cases["leader_fanout"].append((None, c, {}))
    # the digest tier: dead observers; a dead wired follower
    c = ae_case(rng, 1, O, N, S, interval=1)
    c["dobs_alive"][:] = False
    cases["ae_sync"].append((None, c, {}))
    c = ae_case(rng, 1, 16, N, S, voter_frac=1.0, interval=1)
    c["dobs_alive"][:] = True
    c["alive"][0, :] = True
    c["alive"][0, 0] = False
    c["dobs_fol"][:] = 0
    cases["ae_sync"].append((None, c, {}))
    # an empty group among populated ones
    c = group_case(rng, 9, 4, 20, 3)
    c["gids"] = np.where(c["gids"] == 2, 0, c["gids"])
    cases["group_reduce"].append((None, c, dict(G=4)))
    # the redesigned ae_sync's edges: N across its 32-node words (the first
    # alive voter in the last), across the 128 of its one-trip instance
    # and past the 1024 its lane masks cover, S * S across the 32 entries
    # its lanes preload, O across its warps, wired followers out of
    # range, tick + phase below 0, an interval <= 0
    for n in (1, 31, 32, 33, 64, 65, N, 128, 129, 1024, 1100, 2000):
        cases["ae_sync"].append(
            (None, ae_edge_case(rng, "last_word", 2, 40, n, 3, 4), {}))
    for s_ in (1, 4, 5, 6):
        cases["ae_sync"].append(
            (None, ae_edge_case(rng, "random", B, O, N, s_, 1), {}))
    for o in (1, 31, 32, 33, 129):
        cases["ae_sync"].append(
            (None, ae_edge_case(rng, "random", 2, o, 9, 2, 1), {}))
    for kind, iv in (("fol_out", 1), ("neg_tick", 4), ("neg_tick", 3),
                     ("random", 0), ("random", -3)):
        cases["ae_sync"].append(
            (None, ae_edge_case(rng, kind, B, O, N, S, iv), {}))
    # the redesigned group_reduce's edges: B across its 8-member chunks
    # and its two chunk buffers, up to 8 groups with an empty one, NaN /
    # +-inf / +-0, int sums that wrap
    for b, g, empty in ((1, 1, None), (8, 2, None), (9, 3, None),
                        (15, 3, None), (16, 3, 1),
                        (17, 3, None), (32, 2, None), (33, 5, 4),
                        (100, 3, 0), (40, 8, 5), (SWEEP_B, 8, None)):
        cases["group_reduce"].append(
            (None, group_edge_case(rng, b, g, empty=empty), dict(G=g)))

    fns = kernel_fns()
    floor = launch_floor_ms()
    log(f"launch floor (a one-cycle sleep kernel): {floor * 1e3:.2f} us")
    results = {}
    for name, items in cases.items():
        fn = fns[name]
        for _, case, over in items:
            k = dict(kw, **over)
            t = to_dev(case, dev)
            got = fn(clone(t), False, k)
            torch.cuda.synchronize()
            want = fn(clone(t), True, k)
            check_equal(name, got, want)
        results[name] = {}
        for tag, case, over in items:
            if tag is None:
                continue
            k = dict(kw, **over)
            t = to_dev(case, dev)
            ka, kb = clone(t), clone(t)
            ms = device_ms(lambda: fn(ka, False, k), 100, 4_000_000)
            plain_ms = device_ms(lambda: fn(kb, True, k), 30, 40_000_000)
            lib_ms = None
            if name == "group_reduce":
                kc = clone(t)
                lib = group_library(kc, k["G"])
                want = fn(clone(t), True, k)
                check_equal(f"{name} library ints", lib[:1], want[:1])
                lib_ms = device_ms(lambda: group_library(kc, k["G"]), 100,
                                   4_000_000)
            nbytes, ops = work_of(name, case, static, k)
            results[name][tag] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bytes=nbytes,
                                      ops=ops)
            Bc = np.asarray(next(iter(case.values()))).shape[0]
            log(f"kernel {name} [{tag}, B={Bc}]: {ms * 1e3:.2f} us, "
                f"{(ms - floor) * 1e3:.2f} over the floor "
                f"(twin {plain_ms * 1e3:.2f} us"
                + (f", library {lib_ms * 1e3:.2f} us" if lib_ms else "")
                + f"), {nbytes} B, {ops} ops, bound "
                f"{bound_ms(nbytes, ops) * 1e3:.4f} us")
        log(f"kernel {name}: equal to twin on {len(items)} cases")
    check_group_unfilled(dev, fns["group_reduce"], Fi, G)
    K_.reset_launch_counts()
    return results, floor


def check_group_unfilled(dev, fn, Fi, G):
    """group_reduce allocates its outputs with `torch.empty`: after
    tensors of the outputs' sizes were filled with a sentinel and freed,
    so the allocator likely hands that memory back, the kernel must
    still equal the twin in every cell, at the fleet's widths with an
    empty group, and with every member dropped."""
    import numpy as np
    import torch
    G = max(G, 3)
    rng = np.random.default_rng(1)
    for gids in ([0, 2, 0, 2, 2], [G] * FLEET_B):
        c = group_case(rng, FLEET_B, G, Fi, 3)
        c["gids"] = np.array(gids)
        t = to_dev(c, dev)
        junk = [torch.full((G, Fi), 0x5A5A5A5A, dtype=torch.int32,
                           device=dev),
                torch.full((G, 3), 1234.5, device=dev),
                torch.full((G, 3), 1234.5, device=dev)]
        torch.cuda.synchronize()
        del junk
        got = fn(clone(t), False, dict(G=G))
        want = fn(clone(t), True, dict(G=G))
        check_equal("group_reduce (outputs after a sentinel fill)", got, want)
        if got[0][1].any() or not (got[2][1] == -torch.inf).all():
            raise AssertionError("group_reduce: an empty group is not 0 "
                                 "sums and a -inf max")
    log("kernel group_reduce: equal to twin on outputs allocated over a "
        "freed sentinel fill (an empty group; every member dropped)")


@contextlib.contextmanager
def keep_main_path_operands(at, data=MAIN_DATA):
    """Yield ({op name: (operands, keyword arguments)}, [due rows]):
    while open, the path reaches each op of `data` through a stand-in
    for the ops module `data` names (`rt_ops`, `lf_ops` and `ae_ops` of
    `core/step.py`, `gd_ops` of `core/fleet.py`) that keeps a copy of
    the operands of the op's `at[name]`-th call (cloned before the call,
    since log_match_append and apply_last_wins update their first
    operands in place) and a device copy of every call's `due` mask of
    log_match_append.  The ops modules themselves are left alone, so
    their launch counts stay the real ones."""
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.core import step as step_mod
    owner = {"rt_ops": step_mod, "lf_ops": step_mod, "ae_ops": step_mod,
             "gd_ops": fleet_mod}
    kept, dues = {}, []

    def wrap(mod, name):
        fn, calls = getattr(mod, name), [0]

        def op(*args, **kw):
            if calls[0] == at[name]:
                kept[name] = ([a.clone() for a in args], dict(kw))
            if name == "log_match_append":
                dues.append(args[9].clone())
            calls[0] += 1
            return fn(*args, **kw)
        return op

    saved = {m: getattr(owner[m], m) for m in {w for w, _ in data.values()}}
    for m, mod in saved.items():
        names = [n for n, (where, _) in data.items() if where == m]
        setattr(owner[m], m, types.SimpleNamespace(
            **dict(vars(mod), **{n: wrap(mod, n) for n in names})))
    try:
        yield kept, dues
    finally:
        for m, mod in saved.items():
            setattr(owner[m], m, mod)


def time_main_path_data(kept, floor, static, data=MAIN_DATA, where=None):
    """The kernels of `data` on the operands kept from the path's own
    calls (`where[name]` says which call): equal to the twin, then
    device times beside phase 2's floor; ae_sync also on the members
    with no slot due.  Returns {name: {ms, plain_ms, bytes, ops}}."""
    import torch
    from repro_torch import kernels as K_
    where = where or {n: f"tick {MAIN_DATA_AT}" for n in data}
    fns = kernel_fns()
    out = {}
    for name in data:
        args, opkw = kept[name]
        case = dict(zip(data[name][1], args))
        k = dict(opkw)
        if "w" in k:                    # log_match_append's window
            k["max_ship"] = k.pop("w")
        if "n_groups" in k:             # group_reduce's group count
            k["G"] = k.pop("n_groups")
        fn = fns[name]
        got = fn(clone(case), False, k)
        torch.cuda.synchronize()
        check_equal(f"{name} (main path data)", got,
                    fn(clone(case), True, k))
        tag = f"main path data, {where[name]}"
        out[name] = time_case(name, case, k, floor, static, tag,
                              main_data_note(name, case))
        if name == "ae_sync":
            quiet = ae_due(to_np(case))[0].sum(1) == 0
            if quiet.any() and not quiet.all():
                sub = {n: v[torch.as_tensor(quiet, device=v.device)]
                       for n, v in case.items()}
                check_equal(f"{name} (main path data, no slot due)",
                            fn(clone(sub), False, k),
                            fn(clone(sub), True, k))
                r = time_case(name, sub, k, floor, static,
                              f"{tag}, the {int(quiet.sum())} members "
                              f"with no slot due")
                out[name].update(ms_no_due=r["ms"],
                                 members_no_due=int(quiet.sum()))
    K_.reset_launch_counts()
    return out


def to_np(case):
    return {n: v.cpu().numpy() for n, v in case.items()}


def time_case(name, case, k, floor, static, tag, note=""):
    """Device times of kernel and twin on one case of device tensors,
    printed beside the floor and `note`.  Returns {ms, plain_ms, bytes,
    ops}."""
    fn = kernel_fns()[name]
    ka, kb = clone(case), clone(case)
    ms = device_ms(lambda: fn(ka, False, k), 100, 4_000_000)
    plain_ms = device_ms(lambda: fn(kb, True, k), 30, 40_000_000)
    nbytes, ops = work_of(name, to_np(case), static, k)
    log(f"kernel {name} [{tag}]: {ms * 1e3:.2f} us, "
        f"{(ms - floor) * 1e3:.2f} over the floor of {floor * 1e3:.2f} us; "
        f"twin {plain_ms * 1e3:.2f} us; {nbytes} B, {ops} ops, bound "
        f"{bound_ms(nbytes, ops) * 1e3:.4f} us" + (f"; {note}" if note
                                                   else ""))
    return dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops)


def main_data_note(name, case):
    """What the kept operands hold: the append's due rows, the commit's
    live voters and majority, the apply's valid entries, the fan-out's
    nodes with nothing in flight, ae_sync's due slots by member,
    group_reduce's grouped members."""
    if name == "ae_sync":
        due = ae_due(to_np(case))[0]
        alive = case["dobs_alive"].sum(1).tolist()
        return (f"{int(due.sum())} of {due.size} slots due (by member "
                f"{due.sum(1).tolist()}; alive slots {alive})")
    if name == "group_reduce":
        gids = case["gids"].cpu().numpy()
        return (f"members' group ids {gids.tolist()}, "
                f"{case['int_mat'].shape[1]} int and "
                f"{case['flt_mat'].shape[1]} float lanes")
    if name == "log_match_append":
        return (f"{int(case['due'].sum())} of {case['due'].numel()} rows "
                f"due")
    if name == "commit_majority":
        alive = int(case["voter_alive"].sum())
        return (f"{alive} live voters, majority "
                f"{int(case['majority'][0])}, term row of "
                f"{case['ldr_term'].shape[1]}")
    if name == "apply_last_wins":
        return (f"{int(case['valid'].sum())} of {case['valid'].numel()} "
                f"entries valid")
    idle = case["alive"] & (case["app_arrive_t"] < 0)
    return (f"{int(idle.sum())} of {idle.numel()} nodes alive with "
            f"nothing in flight, leader {int(case['lid_c'][0])} "
            f"({'up' if bool(case['has_leader'][0]) else 'none'})")


def work_of(name, c, static, kw):
    """Bytes the function must move (each input read once, each output
    written once) and its 32-bit operations, counted on these inputs."""
    import numpy as np
    a = lambda k: np.asarray(c[k])
    if name == "log_match_append":
        B, N, L = a("log_term").shape
        frm, up = a("app_from_len"), a("app_upto")
        prev = frm - 1
        pc = np.clip(prev, 0, L - 1)
        same = np.take_along_axis(a("log_term"), pc[..., None], 2)[..., 0] \
            == np.take_along_axis(a("ldr_term"), pc, 1)
        acc = a("due") & ((prev < 0) | same)
        win = np.clip(np.minimum(np.minimum(up, frm + kw["max_ship"]), L)
                      - np.maximum(frm, 0), 0, None)
        moved = int((win * acc).sum())
        nbytes = B * N * (3 * 4 + 1 + 2 * 4) + B * N * (4 + 1) + moved * 24
        return nbytes, B * N * 8 + moved * 3
    if name == "commit_majority":
        B, N = a("match_len").shape
        L = a("ldr_term").shape[1]
        return B * (N * 5 + L * 4 + 12), B * (N * N * 2 + L)
    if name == "apply_last_wins":
        B, N, K = a("kv").shape
        keys = a("keys")
        keys = np.where(keys < 0, keys + K, keys)
        writes = int((a("valid") & (keys >= 0) & (keys < K)).sum())
        A = keys.shape[2]
        return B * N * A * 9 + writes * 4, B * N * A * 4
    if name == "leader_fanout":
        B, N = a("role").shape
        return B * (N * (9 * 4 + 1) + 2 * N * 4 + 6 * 4 + 5 * N * 4 + 4), \
            B * N * 40
    if name == "ae_sync":
        # the slot rows, the alive and voter bytes and the site-pair
        # matrix of every member, the four source values once per
        # distinct (member, source) a due slot reads, the four rows out
        B, O = a("dobs_fol").shape
        N = a("alive").shape[1]
        S = a("site_rtt").shape[1]
        due, src = ae_due(c)
        n_src = len(set(zip(np.nonzero(due)[0].tolist(),
                            src[due].tolist())))
        return B * (O * (1 + 7 * 4) + N * 2 + S * S * 4 + 8 +
                    O * 4 * 4) + n_src * 4 * 4, B * O * 20
    # group_reduce: the ids, the rows of the grouped members, the outputs
    B, Fi = a("int_mat").shape
    Ff = a("flt_mat").shape[1]
    G = kw["G"]
    n_in = int(((a("gids") >= 0) & (a("gids") < G)).sum())
    return (B * 4 + n_in * (Fi + Ff) * 4 + G * (Fi + 2 * Ff) * 4,
            n_in * (Fi + 2 * Ff) + B * G * (Fi + Ff))


def bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3


def bound_by(nbytes, ops):
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S
            else "operations")


# --------------------------------------------------------------------- #
# phase 3: the solo path
# --------------------------------------------------------------------- #
def check_report(rep, ctx):
    for k in ("reads_arrived", "writes_arrived"):
        if getattr(rep, k) <= 0:
            raise AssertionError(f"{ctx}: no {k}")
    for k in ("cost", "read_lat_mean"):
        v = getattr(rep, k)
        if not (v == v and abs(v) < 1e30):
            raise AssertionError(f"{ctx}: {k}={v} not finite")


def run_main_path(dev, cfg):
    import torch
    from repro_torch import kernels as K_
    from repro_torch.core import state as SM
    from repro_torch.core.runtime import BWRaftSim
    sim = BWRaftSim(cfg, seed=0, device=dev)
    K_.reset_launch_counts()
    ticks, wall = 0, []
    at = {n: MAIN_DATA_AT for n in MAIN_DATA}
    with keep_main_path_operands(at) as (kept, dues):
        for e in range(5):
            if e == 3:
                sim.set_rates(phi=0.02)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = sim.run_epoch()      # ends in the digest fetch (a sync)
            wall.append((time.perf_counter() - t0) * 1e3)
            ticks += cfg.period_ticks
            d = {k: v for k, v in rep.__dict__.items()
                 if k not in ("decision", "metrics")}
            log(f"epoch {e}: {wall[-1]:.1f} ms  {json.dumps(d)}")
            if rep.decision is not None:
                log(f"  decision {json.dumps(rep.decision.__dict__)}")
            check_report(rep, f"epoch {e}")
    counts = K_.launch_counts()
    log(f"launches over {ticks} solo ticks: {json.dumps(counts)}")
    due = torch.stack(dues).sum((1, 2)).cpu()
    log(f"log_match_append rows due over {ticks} solo ticks: {int(due.sum())}"
        f" in all, on {int((due > 0).sum())} ticks, at most {int(due.max())}"
        f" in one; {int(due[MAIN_DATA_AT])} at tick {MAIN_DATA_AT}")
    for name, n in counts.items():
        want = ticks if name in PER_TICK else 0
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the solo "
                                 f"path, expected {want}")
    if sum(r.writes_committed for r in sim.reports) <= 0:
        raise AssertionError("no write committed in 5 epochs")
    bundle = sim.draws.epoch(3, sim.state, sim.cfg_c)
    check_tick_sync_free(SM.batch1(sim.state), sim.static_t,
                         SM.batch1(sim.cfg_c),
                         {k: v.unsqueeze(1) for k, v in bundle.items()}, 3)
    steady = wall[1:]
    log(f"solo epoch wall ms: median {statistics.median(steady):.1f} "
        f"(epochs 1-4; epoch 0 {wall[0]:.1f} incl. warm-up); "
        f"ticks/s {cfg.period_ticks * 1e3 / statistics.median(steady):.1f}")
    if sorted(kept) != sorted(MAIN_DATA):
        raise AssertionError(f"kept operands of {sorted(kept)} only")
    return sim, counts, kept


def check_tick_sync_free(state, static, cfg_c, bundle, ticks):
    """The batched tick never waits for the device: any synchronizing
    call (a host read, a pageable host-to-device copy) raises here."""
    import torch
    from repro_torch.core import step as step_mod
    from repro_torch.core.draws import row
    st = {k: v.clone() for k, v in state.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(ticks):
            st, _ = step_mod.tick(st, static, cfg_c, row(bundle, t))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"tick sync check: {ticks} ticks of B={st['tick'].shape[0]} ran "
        f"with no host synchronization")


def run_quickstart(dev, cfg):
    """The quickstart's client sequence through BWKVService."""
    from repro_torch.core import state as SM
    from repro_torch.core.runtime import BWRaftSim
    from repro_torch.kvstore.service import BWKVService
    sim = BWRaftSim(cfg, write_rate=2.0, read_rate=8.0, seed=0, device=dev)
    svc = BWKVService(sim)
    t0 = time.perf_counter()
    svc._step(120)
    lid = int(SM.leader_id(sim.state))
    if lid < 0:
        raise AssertionError("no leader after 120 ticks")
    sim._lease(3, 4)
    r = svc.put("paper/title", 2022)
    v, rev = svc.get("paper/title")
    if v != 2022:
        raise AssertionError(f"get(paper/title) = {v}")
    sim.set_rates(phi=1.0)
    svc._step(5)
    alive = sim.state["alive"].cpu().numpy()
    if alive[~sim.static["is_voter"]].any():
        raise AssertionError("phi=1 left a spot node alive")
    sim.set_rates(phi=0.0)
    r2 = svc.put("paper/venue", 42)
    v2, _ = svc.get("paper/venue")
    v3, _ = svc.get("paper/title")
    if (v2, v3) != (42, 2022):
        raise AssertionError(f"after the kill: venue={v2} title={v3}")
    ms = (time.perf_counter() - t0) * 1e3
    log(f"quickstart: leader {lid}; put latencies {r.latency_ticks}, "
        f"{r2.latency_ticks} ticks; read latencies "
        f"{svc.read_latencies} ticks; {ms:.0f} ms wall for "
        f"{int(sim.state['tick'])} ticks")


# --------------------------------------------------------------------- #
# phases 4 and 7: card against CPU
# --------------------------------------------------------------------- #
def run_card_vs_cpu(tag, state, statics, cfg_c, T, gids=None, n_groups=0):
    """One epoch of a batched state on the card and on the CPU from the
    same state and the same per-member draw bundles (and, with groups,
    the group digest): int/bool leaves equal, floats within rtol."""
    import numpy as np
    import torch
    from repro_torch.core import state as SM
    from repro_torch.core.draws import TorchDraws, fleet_epoch
    from repro_torch.core.fleet import _group_digest
    from repro_torch.core.runtime import device_epoch
    cpu = torch.device("cpu")
    dev = state["tick"].device
    st_cpu = {k: v.to(cpu) for k, v in state.items()}
    st_gpu = {k: v.clone() for k, v in state.items()}
    cfg_cpu = {k: v.to(cpu) for k, v in cfg_c.items()}
    B = state["tick"].shape[0]
    bundle = fleet_epoch([TorchDraws(123 + i, cpu) for i in range(B)], T,
                         st_cpu, cfg_cpu)
    t0 = time.perf_counter()
    s_g, d_g = device_epoch(st_gpu, SM.stack_static(statics, dev), cfg_c,
                            {k: v.to(dev) for k, v in bundle.items()}, T)
    if n_groups:
        d_g["group"] = _group_digest(d_g, gids, n_groups)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_c, d_c = device_epoch(st_cpu, SM.stack_static(statics, cpu), cfg_cpu,
                            bundle, T)
    if n_groups:
        d_c["group"] = _group_digest(d_c, gids.cpu(), n_groups)
    t2 = time.perf_counter()
    pairs = [("digest." + k, d_g[k], d_c[k]) for k in d_g if k != "group"]
    if n_groups:
        pairs += [("group." + k, d_g["group"][k], d_c["group"][k])
                  for k in d_g["group"]]
    pairs += [("state." + k, s_g[k], s_c[k]) for k in s_g]
    n_exact = n_float = 0
    for name, a, b in pairs:
        a = a.cpu()
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=FLOAT_RTOL, err_msg=name)
            n_float += 1
        elif not torch.equal(a, b):
            raise AssertionError(f"{tag}: card and CPU differ at {name}")
        else:
            n_exact += 1
    log(f"{tag} card vs CPU, one epoch of B={B}: {n_exact} int/bool leaves "
        f"equal, {n_float} float leaves within rtol={FLOAT_RTOL}; card "
        f"{(t1 - t0) * 1e3:.0f} ms, CPU {(t2 - t1) * 1e3:.0f} ms")


# --------------------------------------------------------------------- #
# phase 5: the fleet path; phase 6: the fixed-role sweep
# --------------------------------------------------------------------- #
def slice_fleet(dev, cfg):
    """The slice's fleet: BW-Raft, Raft and a 2-shard Multi-Raft group
    (one comparison point at 8 writes / 32 reads per tick) plus BW-Raft
    with the 50X digest-observer rack."""
    from repro_torch.core.fleet import (FleetSim, digest_rack_spec,
                                        system_specs)
    specs = system_specs(cfg, write_rate=8.0, read_rate=32.0, seed=0,
                         shards=2, group_id=0) + \
        [digest_rack_spec(cfg, write_rate=8.0, read_rate=32.0, seed=0)]
    return FleetSim(specs, device=dev)


def run_fleet_path(dev, cfg):
    import torch
    from repro_torch import kernels as K_
    from repro_torch.core.draws import fleet_epoch
    fleet = slice_fleet(dev, cfg)
    B, T = fleet.shapes.B, fleet.shapes.T
    log(f"fleet: {fleet.shapes}")
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    wall = []
    with keep_main_path_operands(FLEET_DATA_AT, FLEET_DATA) as (kept, _):
        for e in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = fleet.run_epoch()   # ends in the digest fetch (a sync)
            wall.append((time.perf_counter() - t0) * 1e3)
            for i, rep in enumerate(reps):
                check_report(rep, f"fleet epoch {e} member {i}")
            g = fleet.group_reports[0][-1]
            gd = {k: v for k, v in g.__dict__.items() if k != "metrics"}
            log(f"fleet epoch {e}: {wall[-1]:.1f} ms; writes committed "
                f"{[r.writes_committed for r in reps]}; multiraft group "
                f"{json.dumps(gd)}")
    counts = K_.launch_counts()
    if sorted(kept) != sorted(FLEET_DATA):
        raise AssertionError(f"kept fleet operands of {sorted(kept)} only")
    ticks = 3 * T
    log(f"launches over {ticks} fleet ticks of B={B}: {json.dumps(counts)}")
    for name, n in counts.items():
        want = (3 if name == "group_reduce" else ticks) if name in RAFT \
            else 0
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the fleet "
                                 f"path, expected {want}")
    obs = fleet.members[-1].reports[-1]
    log(f"digest rack member: n_obs_digest {obs.n_obs_digest}, "
        f"obs_reads_served {obs.obs_reads_served}, obs_rerouted "
        f"{obs.obs_rerouted}, obs_stale_p95 {obs.obs_stale_p95}, "
        f"obs_stale_p99 {obs.obs_stale_p99}")
    if obs.obs_reads_served <= 0 or not obs.obs_stale_p99 <= 12:
        raise AssertionError("the digest rack served no read within its "
                             "staleness bound")
    if g.writes_committed <= 0 or g.two_pc_prepares <= 0:
        raise AssertionError("the Multi-Raft group committed nothing")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    med = statistics.median(wall)
    log(f"fleet epoch wall ms: {[round(w, 1) for w in wall]}, median "
        f"{med:.1f}; member-ticks/s {B * T * 1e3 / med:.1f}; peak device "
        f"memory {peak:.0f} MiB")
    bundle = fleet_epoch(fleet.draws, 3, fleet.state, fleet._cfg_c)
    check_tick_sync_free(fleet.state, fleet._bstatic, fleet._cfg_c, bundle,
                         3)
    return fleet, counts, kept


def run_sweep(dev, cfg):
    import torch
    from repro_torch.core.fleet import FleetSim
    writes = [4.0 * (k + 1) for k in range(8)]
    fleet = FleetSim.from_sweep(
        cfg, {"write_rate": writes, "seed": [10, 11, 12, 13]},
        manage_resources=False, read_rate=32.0, device=dev)
    B, T = fleet.shapes.B, fleet.shapes.T
    if B != SWEEP_B or not fleet.single_dispatch_eligible:
        raise AssertionError(f"sweep fleet B={B}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet.run(1)
    t1 = time.perf_counter()
    fleet.lease_fixed(2, 8)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    reps = fleet.run(2)
    t3 = time.perf_counter()
    for i, r in enumerate(reps):
        for e, rep in enumerate(r):
            check_report(rep, f"sweep member {i} epoch {e}")
    if min(r[-1].writes_committed for r in reps) <= 0:
        raise AssertionError("a sweep member committed nothing")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"sweep B={B}: run(1) {(t1 - t0) * 1e3:.1f} ms, lease_fixed "
        f"{(t2 - t1) * 1e3:.1f} ms, run(2) {(t3 - t2) * 1e3:.1f} ms "
        f"(multi-epoch path); member-ticks/s "
        f"{B * 2 * T / (t3 - t2):.1f}; peak device memory {peak:.0f} MiB")


def run_profile(tag, state, static, cfg_c, bundle, ticks):
    """Device busy share and kernel time by name over the last
    `ticks - 2` of `ticks` batched ticks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import step as step_mod
    from repro_torch.core.draws import row
    st = {k: v.clone() for k, v in state.items()}
    for t in range(2):                                  # warm
        st, _ = step_mod.tick(st, static, cfg_c, row(bundle, t))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2, ticks):
            st, _ = step_mod.tick(st, static, cfg_c, row(bundle, t))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    evs = [e for e in avg if e.self_device_time_total > 0
           and not e.key.startswith("aten::")]
    dev_us = sum(e.self_device_time_total for e in evs)
    n_launch = sum(e.count for e in evs)
    n = ticks - 2
    log(f"{tag} profile over {n} ticks: wall {wall * 1e3 / n:.3f} ms/tick, "
        f"device busy {dev_us / 1e3 / n:.3f} ms/tick "
        f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
        f"{n_launch / n:.0f} device kernels and copies/tick")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        log(f"  {e.self_device_time_total / n:9.2f} us/tick "
            f"{e.count / n:6.1f}/tick  {e.key[:90]}")


# --------------------------------------------------------------------- #
# phase 8: the attention kernels against their twins; device times
# --------------------------------------------------------------------- #
def att_inputs(gen, dev, dtype, q_shape, kv_shape):
    import torch
    return [torch.randn(s, generator=gen, device=dev, dtype=torch.float32)
            .to(dtype) for s in (q_shape, kv_shape, kv_shape)]


def dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def att_compare(name, got, want, dtype, ctx) -> float:
    """max |kernel - twin|; raises unless within the dtype's tolerance."""
    import torch
    tol = ATT_TOL[dtype_name(dtype)]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name} {ctx}: non-finite output")
    bad = ((g - w).abs() > tol + tol * w.abs()).sum().item()
    if bad:
        raise AssertionError(f"{name} {ctx}: {bad} elements outside "
                             f"{tol} of the twin")
    return (g - w).abs().max().item()


def flash_work(q, k, causal=True):
    """Bytes (q, k, v read once, out written once) and matmul FLOPs
    (Q.K^T and P.V over the key positions each row sees)."""
    import numpy as np
    B, S, H, hd = q.shape
    T = k.shape[1]
    if causal:
        i = np.arange(S)
        pairs = int(np.clip(i + (T - S) + 1, 0, T).sum())
    else:
        pairs = S * T
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * B * H * pairs * hd


def decode_work(q, k, clen):
    """Bytes (q, out, the cache rows below cache_len, cache_len) and
    matmul FLOPs over those rows."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    rows = int(clen.clamp(0, k.shape[1]).sum().item())
    nbytes = (2 * q.numel() + 2 * rows * KV * hd) * q.element_size() + 4 * B
    return nbytes, 4 * H * rows * hd


def att_bound_ms(nbytes, flops, dtype):
    return max(nbytes / HBM_BYTES_PER_S,
               flops / MATMUL_FLOPS[dtype_name(dtype)]) * 1e3


def att_bound_by(nbytes, flops, dtype):
    return ("bytes" if nbytes / HBM_BYTES_PER_S >=
            flops / MATMUL_FLOPS[dtype_name(dtype)] else "operations")


def rotating(make, nbytes):
    """Enough copies of an input set to exceed L2_DEFEAT_BYTES, and a
    function that returns the next copy on each call."""
    n = max(1, -(-L2_DEFEAT_BYTES // max(nbytes, 1)))
    copies = [make() for _ in range(n)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % n
        return copies[it["i"]]
    return nxt


def cuobjdump_path():
    import os
    import shutil
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "cuobjdump"),
                 shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    return None


def check_sass():
    """Counts the tensor-core instructions compiled into the two
    attention libraries and the SSD library (`cuobjdump -sass`): HGMMA
    (wgmma) in flash, HMMA (mma.sync) in decode and ssd_scan.  Fails if
    the flash library has no HGMMA or the ssd_scan library neither HGMMA
    nor HMMA; says so and checks nothing when cuobjdump is absent."""
    from repro_torch.kernels import build
    tool = cuobjdump_path()
    if tool is None:
        log("SASS check: cuobjdump not found, compiled instructions not "
            "checked")
        return None
    counts = {}
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        sass = subprocess.run([tool, "-sass", str(build.lib_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\.", sass))
                        for op in ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")}
    log(f"SASS check (cuobjdump -sass): {json.dumps(counts)}")
    if counts["flash_attention"]["HGMMA"] == 0:
        raise AssertionError("flash_attention: no HGMMA instruction in the "
                             "built library")
    if not counts["ssd_scan"]["HGMMA"] + counts["ssd_scan"]["HMMA"]:
        raise AssertionError("ssd_scan: no HGMMA or HMMA instruction in the "
                             "built library")
    return counts


def run_attention_checks(dev, long_shapes=True):
    """Both attention kernels == their twins on the card within the
    stated tolerance over the correctness cases; then device times at
    the serve shapes and (long_shapes) the long ones.  Returns {name:
    {"max_abs_err": x, "cases": n, tag: {ms, plain_ms, library_ms,
    bytes, flops, dtype}}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K_
    from repro_torch.kernels.decode_attention import kernel as da_k
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    check_sass()
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    res = {"flash_attention": {"max_abs_err": 0.0, "cases": 0},
           "decode_attention": {"max_abs_err": 0.0, "cases": 0}}
    K_.reset_launch_counts()

    # (B, S, T, H, KV, hd): the serve shape, ragged S and T, S < T, GQA
    # groups 3, 1 (MHA), 8 (MQA and qwen2.5-3b's 16 over 2), hd 16..128;
    # then the tensor-core route's tile edges (64-row warpgroups, 128-row
    # blocks, 128-key tiles): S = 1, 63, 64, 65, 127, 129, S < T, S > T
    for dt in (bf16, f32):
        for B, S, T, H, KV, hd in [(8, 512, 512, 15, 5, 64),
                                   (2, 77, 77, 15, 5, 64),
                                   (2, 24, 61, 6, 2, 32),
                                   (1, 100, 100, 8, 8, 128),
                                   (1, 33, 33, 8, 1, 16),
                                   (2, 200, 200, 16, 2, 128),
                                   (1, 1, 1, 3, 1, 64),
                                   (2, 63, 63, 8, 8, 128),
                                   (1, 64, 64, 15, 5, 64),
                                   (2, 65, 65, 16, 2, 128),
                                   (1, 127, 127, 3, 3, 64),
                                   (2, 129, 129, 24, 3, 128),
                                   (2, 65, 300, 15, 5, 64),
                                   (1, 130, 70, 8, 1, 128),
                                   # phase 16(b)'s prefills: vision,
                                   # qwen2-moe, seamless
                                   (8, 128, 128, 64, 8, 128),
                                   (8, 128, 128, 16, 16, 128),
                                   (8, 128, 128, 16, 16, 64)]:
            q, k, v = att_inputs(gen, dev, dt, (B, S, H, hd), (B, T, KV, hd))
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = att_compare("flash_attention", got,
                                  fa_ref.flash_attention_ref(
                                      q, k, v, causal=causal), dt,
                                  (B, S, T, H, KV, hd, dtype_name(dt),
                                   "causal" if causal else "full"))
                r = res["flash_attention"]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["cases"] += 1
        # (B, T, H, KV, hd, cache_len): ragged cache_len including 1 and
        # T where it is None; T off the 64-row tile, G = 1, 3, 8 at hd 64
        # and 128; then phase 16(b)'s decode steps: vision's self and
        # cross (its 1,600 image tokens, all read), qwen2-moe's, and
        # seamless's self and cross (capacity 144, the 128 prompt frames)
        for B, T, H, KV, hd, fill in [
                (8, 544, 15, 5, 64, None), (3, 1000, 8, 8, 64, None),
                (4, 77, 16, 2, 128, None), (2, 33, 8, 1, 16, None),
                (32, 4096, 15, 5, 64, None), (1, 1, 3, 3, 32, None),
                (2, 63, 8, 1, 64, None), (3, 65, 6, 2, 128, None),
                (2, 129, 16, 16, 128, None), (5, 700, 24, 3, 128, None),
                (1, 1, 15, 5, 64, None),
                (8, 144, 64, 8, 128, None), (8, 1600, 64, 8, 128, 1600),
                (8, 144, 16, 16, 128, None), (8, 144, 16, 16, 64, None),
                (8, 144, 16, 16, 64, 128)]:
            q, k, v = att_inputs(gen, dev, dt, (B, 1, H, hd), (B, T, KV, hd))
            clen = torch.randint(1, T + 1, (B,), generator=gen, device=dev,
                                 dtype=torch.int32)
            if fill is None:
                clen[0], clen[-1] = T, 1
            else:
                clen.fill_(fill)
            got = da.decode_attention(q, k, v, clen)
            torch.cuda.synchronize()
            err = att_compare("decode_attention", got,
                              da_ref.decode_attention_ref(q, k, v, clen), dt,
                              (B, T, H, KV, hd, fill, dtype_name(dt)))
            r = res["decode_attention"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["cases"] += 1
            zero = da.decode_attention(q, k, v, torch.zeros_like(clen))
            if not torch.equal(zero, torch.zeros_like(zero)):
                raise AssertionError("decode_attention: cache_len 0 did not "
                                     "give 0")
    routes = K_.route_counts()
    for name in res:
        log(f"kernel {name}: within tolerance of its twin on "
            f"{res[name]['cases']} cases, max |kernel - twin| "
            f"{res[name]['max_abs_err']:.3g}; launches by route "
            f"{json.dumps(routes[name])}")
        for rt in routes[name]:
            if not routes[name][rt]:
                raise AssertionError(f"{name}: the {rt} route never ran")

    def sdpa_flash(qt, kt, vt):
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_decode(qt, kt, vt, mask):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    timed = [("flash_attention", "serve", (8, 512, 15, 5, 64))]
    timed += [("decode_attention", "serve", (8, 544, 15, 5, 64))]
    # where the cache splits matter: one sequence, 5 (batch row, KV head)
    # pairs for 132 SMs
    timed += [("decode_attention", "one-row", (1, 32768, 15, 5, 64))]
    if long_shapes:
        timed += [("flash_attention", "long", (1, 8192, 15, 5, 64)),
                  ("decode_attention", "long", (32, 32768, 15, 5, 64))]
    for name, tag, (B, T, H, KV, hd) in timed:
        S = T if name == "flash_attention" else 1
        dt = bf16
        q_shape, kv_shape = (B, S, H, hd), (B, T, KV, hd)

        def make():
            # the kernel's operands, then the library's: the same values
            # in its (B, H, S, hd) layout, transposed beforehand
            q, k, v = att_inputs(gen, dev, dt, q_shape, kv_shape)
            clen = torch.full((B,), T, dtype=torch.int32, device=dev)
            return (q, k, v, clen,
                    *(x.transpose(1, 2).contiguous() for x in (q, k, v)))
        a0 = make()
        q, k, v, clen = a0[:4]
        if name == "flash_attention":
            nbytes, flops = flash_work(q, k)
            op = lambda a: fa.flash_attention(a[0], a[1], a[2])
            twin = lambda a: fa_ref.flash_attention_ref(a[0], a[1], a[2])
            lib = lambda a: sdpa_flash(a[4], a[5], a[6])
        else:
            nbytes, flops = decode_work(q, k, clen)
            op = lambda a: da.decode_attention(*a[:4])
            twin = lambda a: da_ref.decode_attention_ref(*a[:4])
            mask = (torch.arange(T, device=dev)[None, :] <
                    clen[:, None])[:, None, None, :]
            lib = lambda a: sdpa_decode(a[4], a[5], a[6], mask)
        want = op(a0)
        att_compare(f"{name} library", lib(a0).transpose(1, 2), want, dt,
                    tag)
        # kernel and library each read a fresh rotated copy per call, so
        # neither finds its inputs in the L2
        nxt = rotating(make, nbytes)
        reps = 10 if tag == "long" else 50
        ms = device_ms(lambda: op(nxt()), reps, 4_000_000)
        lib_ms = device_ms(lambda: lib(nxt()), reps, 4_000_000)
        plain_ms = device_ms(lambda: twin(a0), 5 if tag == "long" else 20,
                             40_000_000)
        res[name][tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bytes=nbytes, flops=flops, dtype=dt)
        extra = ""
        if name == "decode_attention":
            # what the cache splits and their combine buy: one split per
            # (batch row, KV head), no combine
            ns = da_k.n_splits(B, T, KV, da_k.sm_count(dev),
                               da_k.tc_blocks_per_sm(dev, hd))
            out1 = torch.empty_like(q)
            ms1 = device_ms(lambda: da_k.decode_attention(
                *nxt()[:4], out1, nsplit=1), reps, 4_000_000)
            res[name][tag].update(n_splits=ns, ms_one_split=ms1)
            extra = (f"; {ns} splits per (batch row, KV head), one split "
                     f"(no combine) {ms1 * 1e3:.2f} us")
            # the (o, lse) form of a kv_seq-sharded cache (the mesh's
            # self decode): o in float32 and lse (B, H) written instead of
            # o in the input's dtype
            o_l, l_l = da.decode_attention(*a0[:4], with_lse=True)
            r_o, r_l = da_ref.decode_attention_ref(*a0[:4], with_lse=True)
            att_compare(f"{name} (o, lse)", o_l, r_o, dt, tag)
            att_compare(f"{name} lse", l_l, r_l, dt, tag)
            ms_lse = device_ms(lambda: da.decode_attention(
                *nxt()[:4], with_lse=True), reps, 4_000_000)
            plain_lse = device_ms(lambda: da_ref.decode_attention_ref(
                *a0[:4], with_lse=True), 5 if tag == "long" else 20,
                40_000_000)
            lse_bytes = nbytes + q.numel() * 2 + B * H * 4
            res[name][tag].update(ms_lse=ms_lse, plain_ms_lse=plain_lse,
                                  bound_ms_lse=att_bound_ms(lse_bytes, flops,
                                                            dt))
            extra += (f"; the (o, lse) form {ms_lse * 1e3:.2f} us (twin "
                      f"{plain_lse * 1e3:.2f} us, bound "
                      f"{att_bound_ms(lse_bytes, flops, dt) * 1e3:.2f} us)")
        log(f"kernel {name} [{tag}, B={B}, {'S' if S > 1 else 'T'}={T}, "
            f"H={H}, KV={KV}, hd={hd}, bf16]: {ms * 1e3:.2f} us (twin "
            f"{plain_ms * 1e3:.2f} us, library {lib_ms * 1e3:.2f} us on "
            f"rotated copies), {nbytes} B, {flops} matmul FLOPs, bound "
            f"{att_bound_ms(nbytes, flops, dt) * 1e3:.2f} us by "
            f"{att_bound_by(nbytes, flops, dt)}{extra}")
        del a0, q, k, v, clen, want, nxt
        torch.cuda.empty_cache()
    K_.reset_launch_counts()
    return res


# --------------------------------------------------------------------- #
# phase 9: the SSD scan against its twin; device times
# --------------------------------------------------------------------- #
def ssd_inputs(gen, dev, dtype, B, nc, Q, H, P, N):
    import torch
    import torch.nn.functional as F
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    return ((r(B, nc, Q, H, P) * 0.5).to(dtype),
            (r(B, nc, Q, N) * 0.5).to(dtype), (r(B, nc, Q, N) * 0.5).to(dtype),
            F.softplus(r(B, nc, Q, H) - 1.0), -torch.exp(r(H) * 0.3))


def ssd_work(x, Bm, out_dtype):
    """Bytes (x, B, C, dt, A read once; y in `out_dtype` and the state
    written once) and the matmul FLOPs the scan needs: C.B^T once per
    (batch row, chunk) over the causal pairs, w.x over the causal pairs
    and x^T.wB per (batch row, chunk, head), C.h_prev per head for every
    chunk after the first (the first starts from a zero state)."""
    import torch
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    pairs = Q * (Q + 1) // 2
    out_size = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (x.numel() * (x.element_size() + out_size)
              + 2 * Bm.numel() * Bm.element_size() + 4 * B * nc * Q * H
              + 4 * H + 4 * B * H * P * N)
    flops = (2 * B * nc * pairs * N
             + 2 * B * nc * H * (pairs * P + Q * P * N)
             + 2 * B * (nc - 1) * H * Q * N * P)
    return nbytes, flops


def run_ssd_checks(dev):
    """ssd_scan == its twin on the card within the stated tolerance over
    the correctness cases; then device times at the serve and the long
    shape.  Returns {"max_abs_err": x, "cases": n, "routes": {route:
    launches}, tag: {ms, plain_ms, library_ms, bytes, flops, dtype}}."""
    import torch
    from repro_torch import kernels as K_
    from repro_torch.kernels.decode_attention import kernel as da_k
    from repro_torch.kernels.ssd_scan import kernel as ss_k
    from repro_torch.kernels.ssd_scan import ops as ss
    from repro_torch.kernels.ssd_scan import ref as ss_ref
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    res = {"max_abs_err": 0.0, "cases": 0}
    K_.reset_launch_counts()
    # (B, nc, Q, H, P, N): one chunk, the serve shape, ragged chunks, the
    # reduced model's P = N = 16, (P, N) mixes of 16, 64 and 128 (both
    # routes in bf16), the Jamba shape; then, bf16 only, the tensor-core
    # route's tile edges (64-row tiles, 16-row k-steps) at nc = 1 and 3
    shapes = [(1, 1, 256, 24, 64, 128), (8, 2, 256, 24, 64, 128),
              (8, 1, 48, 24, 64, 128), (1, 3, 48, 24, 64, 128),
              (2, 4, 16, 8, 16, 16), (2, 2, 100, 3, 16, 128),
              (1, 2, 100, 5, 128, 128), (2, 2, 64, 6, 64, 64),
              (2, 1, 63, 4, 128, 16), (1, 2, 64, 3, 16, 64),
              (2, 2, 128, 8, 128, 64)]
    edges = [(2, nc, Q, 4, 64, 128) for nc in (1, 3)
             for Q in (1, 63, 64, 65, 100, 255, 256)]
    cases = [(dt, s) for dt in (bf16, f32) for s in shapes]
    cases += [(bf16, s) for s in edges]
    for dt, shape in cases:
        for out in (None, f32):
            args = ssd_inputs(gen, dev, dt, *shape)
            y, st = ss.ssd_scan(*args, out_dtype=out)
            torch.cuda.synchronize()
            yw, sw = ss_ref.ssd_scan_ref(*args, out_dtype=out)
            if y.dtype != yw.dtype:
                raise AssertionError(f"ssd_scan {shape}: y dtype "
                                     f"{y.dtype}, twin {yw.dtype}")
            ctx = shape + (dtype_name(dt), dtype_name(out or dt))
            err = max(att_compare("ssd_scan y", y, yw, dt, ctx),
                      att_compare("ssd_scan state", st, sw, dt, ctx))
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["cases"] += 1
    routes = K_.route_counts()["ssd_scan"]
    res["routes"] = routes
    log(f"kernel ssd_scan: within tolerance of its twin on {res['cases']} "
        f"cases, max |kernel - twin| {res['max_abs_err']:.3g}; launches by "
        f"route {json.dumps(routes)}")
    for rt in routes:
        if not routes[rt]:
            raise AssertionError(f"ssd_scan: the {rt} route never ran")
    for tag, shape, reps in (("serve", (8, 2, 256, 24, 64, 128), 50),
                             ("long", (1, 256, 256, 24, 64, 128), 5)):
        make = lambda: ssd_inputs(gen, dev, bf16, *shape)
        args = make()
        nbytes, flops = ssd_work(args[0], args[1], f32)
        op = lambda a: ss.ssd_scan(*a, out_dtype=f32)
        nxt = rotating(make, sum(t.numel() * t.element_size() for t in args))
        ms = device_ms(lambda: op(nxt()), reps, 4_000_000)
        plain_ms = device_ms(lambda: ss_ref.ssd_scan_ref(*args, out_dtype=f32),
                             3 if tag == "long" else 20, 40_000_000)
        res[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                        bytes=nbytes, flops=flops, dtype=bf16)
        B, nc, Q, H, P, N = shape
        G = ss_k.head_group(B, nc, Q, H, da_k.sm_count(dev))
        log(f"kernel ssd_scan [{tag}, B={B}, S={nc * Q} ({nc} chunks of "
            f"{Q}), H={H}, P={P}, N={N}, bf16 in, f32 y]: {ms * 1e3:.2f} us "
            f"(twin {plain_ms * 1e3:.2f} us, library none), {nbytes} B, "
            f"{flops} matmul FLOPs, bound "
            f"{att_bound_ms(nbytes, flops, bf16) * 1e3:.2f} us by "
            f"{att_bound_by(nbytes, flops, bf16)}; route "
            f"{ss_k.route(bf16, P, N)}, {G} heads per output block")
        del args, nxt
        ss_k.free_scratch()
        torch.cuda.empty_cache()
    K_.reset_launch_counts()
    return res


# --------------------------------------------------------------------- #
# phases 10-11: serving, card against CPU; phases 12-13: the serve paths
# --------------------------------------------------------------------- #
SERVE_GATES = {   # arch: (float32 tol, bfloat16 share, bfloat16 max)
    "smollm-360m": (SERVE_F32_TOL, SERVE_BF16_SHARE, SERVE_BF16_MAX),
    "mamba2-130m": (SSM_F32_TOL, SSM_BF16_SHARE, SSM_BF16_MAX),
}


def run_serve_card_vs_cpu(dev, dtype, arch="smollm-360m", layers=2, B=2,
                          S=128, steps=8):
    """One prefill and `steps` decode steps of `arch` at full width
    (`layers` layers) on the card and on the CPU from the same weights
    and tokens; the decode steps are fed the CPU's greedy tokens.

    Logits (limits by arch in SERVE_GATES): float32 all within the f32
    tolerance; bfloat16 at most a share outside 3e-2 and none further
    than a maximum (for smollm the random weights -- the JAX fan-in rule
    gives wq a std of 1/sqrt(H) -- make attention scores hundreds wide,
    so a bf16 rounding can flip which key a row attends to and move that
    row's logits past 3e-2 on either device).  Greedy tokens, both
    dtypes: the card's token must be one whose CPU logit is within twice
    the tolerance band tol (1 + |top|) of the CPU's best, so the tokens
    are equal wherever the CPU's top-2 margin exceeds that."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    name = dtype_name(dtype)
    cfg = get_config(arch).with_layers(layers)
    runcfg = RunConfig(remat=False, param_dtype=name, activation_dtype=name)
    cpu = torch.device("cpu")
    m_cpu = lm.init_lm(cfg, runcfg, seed=1, device=cpu)
    m_gpu = copy.deepcopy(m_cpu).to(dev)
    f32_tol, bf16_share, bf16_max = SERVE_GATES[arch]
    tol = f32_tol if name == "float32" else ATT_TOL[name]
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    c_cpu = lm.alloc_caches(cfg, B, S + steps, dtype, cpu)
    c_gpu = lm.alloc_caches(cfg, B, S + steps, dtype, dev)
    max_err, n_out, n_all, n_cmp, n_tok = 0.0, 0, 0, 0, 0
    fed = []                          # the CPU's greedy tokens, fed back
    with torch.no_grad(), decode_ticket_check(dev) as tickets:
        l_cpu, _, _ = lm.forward(m_cpu, toks, mode="prefill", caches=c_cpu)
        l_gpu, _, _ = lm.forward(m_gpu, toks.to(dev), mode="prefill",
                                 caches=c_gpu)
        pos = torch.full((B,), S, dtype=torch.int32)
        for step in range(steps + 1):
            a, b = l_gpu.float().cpu(), l_cpu.float()
            where = f"serve card-vs-CPU {arch} {name} step {step}"
            if not torch.isfinite(a).all():
                raise AssertionError(f"{where}: non-finite logits on the "
                                     f"card")
            n_out += int(((a - b).abs() > tol + tol * b.abs()).sum())
            n_all += b.numel()
            max_err = max(max_err, (a - b).abs().max().item())
            if name == "float32" and n_out:
                serve_f32_diagnosis(where, m_gpu, cfg, dtype, dev, toks,
                                    fed, step, a, b, tol, steps)
                raise AssertionError(f"{where}: {n_out} logits outside {tol}")
            if name == "bfloat16" and max_err > bf16_max:
                raise AssertionError(f"{where}: max |card - CPU| {max_err:.4g}"
                                     f" > {bf16_max}")
            top = b[:, -1].max(-1).values
            band = 2 * (tol + tol * top.abs())
            second = b[:, -1].topk(2, dim=-1).values[:, 1]
            g_cpu, g_gpu = b[:, -1].argmax(-1), a[:, -1].argmax(-1)
            picked = b[:, -1].gather(1, g_gpu[:, None])[:, 0]
            if not bool((picked >= top - band).all()):
                raise AssertionError(f"{where}: the card's greedy token has "
                                     f"a CPU logit more than {2 * tol} "
                                     f"(1 + |top|) below the CPU's best")
            n_cmp += int((top - second > band).sum())
            n_tok += int((g_cpu == g_gpu).sum())
            if step == steps:
                break
            nxt = g_cpu.to(torch.int32)[:, None]
            fed.append(nxt)
            l_cpu, _, _ = lm.forward(m_cpu, nxt, mode="decode", caches=c_cpu,
                                     cache_len=pos)
            l_gpu, _, _ = lm.forward(m_gpu, nxt.to(dev), mode="decode",
                                     caches=c_gpu, cache_len=pos.to(dev))
            pos = pos + 1
    share = n_out / n_all
    log(f"serve card vs CPU ({arch}, {layers} layers, {name}, B={B}, "
        f"prefill {S} + {steps} decode steps): {n_all - n_out}/{n_all} "
        f"logits within {tol} (share outside {share:.3g}), max |card - CPU| "
        f"{max_err:.3g}; greedy tokens equal on {n_tok}/{B * (steps + 1)} "
        f"positions, {n_cmp} of them with a top-2 margin over {2 * tol} "
        f"(1 + |top|); decode tickets {json.dumps(tickets)}")
    if name == "bfloat16" and share > bf16_share:
        raise AssertionError(f"serve card-vs-CPU {arch} bfloat16: {n_out} "
                             f"of {n_all} logits outside {tol}, a share of "
                             f"{share:.3g} > {bf16_share}")


@contextlib.contextmanager
def decode_ticket_check(dev):
    """Phase 10's check of `decode_attention`'s split scratch (ROADMAP.md
    §3 F4): every per-(batch row, KV head) ticket of every scratch on
    `dev` must read 0 before the first decode launch (what phases 8-9
    left) and after each launch, which this wraps (the kernel's path is
    unchanged).  Yields counts: launches checked, launches that used the
    split scratch."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as DK

    def dirty():
        torch.cuda.synchronize(dev)
        return {str(k): int((ctr != 0).sum())
                for k, (_, ctr) in DK._SCRATCH.items()
                if ctr is not None and ctr.device == dev and
                bool((ctr != 0).any())}

    stats = {"launches": 0, "split": 0}
    left = dirty()
    if left:
        raise AssertionError(f"decode_attention tickets non-zero before "
                             f"phase 10's first decode launch: {left}")
    orig = DK.decode_attention

    def checked(q, k_cache, v_cache, cache_len, out, nsplit=None,
                lse=None):
        r = orig(q, k_cache, v_cache, cache_len, out, nsplit, lse=lse)
        stats["launches"] += 1
        T, KV = k_cache.shape[1], k_cache.shape[2]
        B, hd = q.shape[0], q.shape[3]
        blocks = DK.tc_blocks_per_sm(q.device, hd) if r == "tensor_core" \
            else 1
        if (nsplit or DK.n_splits(B, T, KV, DK.sm_count(q.device),
                                  blocks)) > 1:
            stats["split"] += 1
        bad = dirty()
        if bad:
            raise AssertionError(f"decode_attention launch "
                                 f"{stats['launches']} left tickets "
                                 f"non-zero: {bad}")
        return r

    DK.decode_attention = checked
    try:
        yield stats
    finally:
        DK.decode_attention = orig


def serve_f32_diagnosis(where, m_gpu, cfg, dtype, dev, toks, fed, step,
                        a, b, tol, steps):
    """On a float32 card-vs-CPU failure (ROADMAP.md §3 F4), before the
    phase raises: the (step, batch row, position) rows outside the
    tolerance, with each row's count, largest difference and the CPU's
    top-2 logit margin; then the card side run twice more from the same
    weights and tokens, each compared bit for bit with the failing run
    and against the CPU."""
    import torch
    from repro_torch.models import lm
    bad = (a - b).abs() > tol + tol * b.abs()            # (B, P, V)
    rows = bad.any(-1).nonzero().tolist()
    log(f"F4 diagnosis, {where}: {int(bad.sum())} logits outside {tol} on "
        f"{len(rows)} of {bad.shape[0] * bad.shape[1]} rows")
    for bi, p in rows[:32]:
        top2 = b[bi, p].topk(2).values
        log(f"  step {step} row {bi} position {p}: "
            f"{int(bad[bi, p].sum())} logits out, largest |card - CPU| "
            f"{(a[bi, p] - b[bi, p]).abs().max().item():.6g}, CPU top-2 "
            f"margin {(top2[0] - top2[1]).item():.6g}, card argmax "
            f"{int(a[bi, p].argmax())} vs CPU {int(b[bi, p].argmax())}")
    B, S = toks.shape
    for rerun in range(2):
        c = lm.alloc_caches(cfg, B, S + steps, dtype, dev)
        with torch.no_grad():
            l, _, _ = lm.forward(m_gpu, toks.to(dev), mode="prefill",
                                 caches=c)
            pos = torch.full((B,), S, dtype=torch.int32, device=dev)
            for nxt in fed[:step]:
                l, _, _ = lm.forward(m_gpu, nxt.to(dev), mode="decode",
                                     caches=c, cache_len=pos)
                pos = pos + 1
        r = l.float().cpu()
        n_diff = int((r != a).sum())
        n_cpu = int(((r - b).abs() > tol + tol * b.abs()).sum())
        same = "equal to" if n_diff == 0 else "differs from"
        log(f"  card rerun {rerun + 1}: {same} the failing run bit for bit "
            f"({n_diff} logits differ), "
            f"{n_cpu} logits outside {tol} of the CPU, largest "
            f"{(r - b).abs().max().item():.6g}")


def run_serve_path(dev, arch="smollm-360m", layers=None, serve_kw=SERVE):
    """`serve()` on `arch` at full width and depth (`layers` layers when
    given) on the card, with the launch counts set to 0 just before and
    read just after: every self-attention layer launches flash once per
    batch, every self-attention and every cross layer decode once per
    token, every SSD layer ssd_scan once per batch, and nothing else
    launches."""
    import torch
    from repro_torch import kernels as K_
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.flash_attention.kernel import \
        route as attn_route
    from repro_torch.kernels.ssd_scan.kernel import route as ssd_route
    from repro_torch.launch.serve import serve, summary_line
    from repro_torch.models import lm
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_layers(layers)
    runcfg = RunConfig(remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, runcfg, seed=SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = lm.layer_kinds(cfg)
    n_attn = sum(k.mixer == "attn" for k in kinds) * (
        cfg.num_layers // len(kinds))
    n_ssd = cfg.num_layers - n_attn
    n_cross = sum(k.cross for k in kinds) * (cfg.num_layers // len(kinds))
    heads = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads" if n_attn else
             f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state "
             f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    extra = "".join((f", {n_cross} cross layers" if n_cross else "",
                     f", {cfg.encoder_layers} encoder layers"
                     if cfg.encoder_layers else "",
                     f", {cfg.moe_num_experts} experts top-{cfg.moe_top_k}"
                     if cfg.moe_num_experts else ""))
    log(f"serve: {arch}, {cfg.num_layers} layers{extra}, d_model "
        f"{cfg.d_model}, {heads}, "
        f"{n_params} parameters in bf16, made in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms; {json.dumps(serve_kw)}")
    K_.reset_launch_counts()
    r = serve(cfg, runcfg, params=model, device=dev, **serve_kw)
    counts = K_.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    B, G = serve_kw["batch"], serve_kw["gen_len"]
    n_batches = len(r["generated"])
    log(summary_line(r))
    want = {"flash_attention": n_attn * n_batches,
            "decode_attention": (n_attn + n_cross) * n_batches * G,
            "ssd_scan": n_ssd * n_batches}
    routes = K_.route_counts()
    log(f"launches on the {arch} serve path: {json.dumps(counts)}; by "
        f"route {json.dumps(routes)}")
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{name} launched {n} times on the serve "
                                 f"path, expected {want.get(name, 0)}")
    # every launch on the route its dtype and shape select: for the
    # attention kernels head_dim, for ssd_scan (head_dim, state), which is
    # the tensor-core route for mamba2-130m
    bf16 = torch.bfloat16
    want_rt = {"flash_attention": attn_route(bf16, cfg.head_dim),
               "decode_attention": attn_route(bf16, cfg.head_dim),
               "ssd_scan": ssd_route(bf16, cfg.ssm_head_dim, cfg.ssm_state)}
    if n_ssd and want_rt["ssd_scan"] != "tensor_core":
        raise AssertionError(f"ssd_scan: {arch} would take the "
                             f"{want_rt['ssd_scan']} route")
    for name in routes:
        rt = want_rt[name]
        if routes[name][rt] != counts[name]:
            raise AssertionError(f"{name}: {routes[name]} on the serve "
                                 f"path, expected all {counts[name]} on "
                                 f"the {rt} route")
    for i, g in enumerate(r["generated"]):
        if g.shape != (B, G + 1) or g.min() < 0 or \
                g.max() >= cfg.padded_vocab:
            raise AssertionError(f"serve batch {i}: tokens {g.shape} out "
                                 f"of range")
    steady = slice(1, None)           # batch 0 pays the first-call set-up
    pre = statistics.median(r["prefill_ms"][steady])
    dec = statistics.median(r["decode_ms"][steady]) / G
    log(f"serve {arch}: {r['tok_per_s']:.1f} generated tokens/s over "
        f"{r['seconds']:.2f} s; prefill {pre:.2f} ms per batch of "
        f"{B} x {serve_kw['prompt_len']} (median of batches 1-"
        f"{n_batches - 1}; batch 0 {r['prefill_ms'][0]:.1f} ms); decode "
        f"{dec:.3f} ms per token step of B={B} (median); peak device "
        f"memory {peak:.0f} MiB; pool served={r['served']} "
        f"rerouted={r['rerouted']} replicas={r['replicas']}")
    return model, dict(counts, routes=routes), r


def check_serve_sync_free(model, dev):
    """A prefill and two decode steps of the serve path never wait for
    the card: any synchronizing call (a host read, a pageable
    host-to-device copy) raises under the sync debug mode and fails the
    run, as in `check_tick_sync_free`."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import steps as S_
    from repro_torch.launch.serve import context_stubs
    from repro_torch.models import lm
    cfg, runcfg = model.cfg, RunConfig(remat=False)
    layers = lm.alloc_caches(cfg, 2, 20, torch.bfloat16, dev)
    prefill = S_.make_prefill_step(cfg, runcfg)
    decode = S_.make_decode_step(cfg, runcfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=dev)
    batch = {"tokens": toks, **context_stubs(cfg, 2, 16, dev)}
    tok, caches = prefill(model, batch, layers)                 # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok, caches = prefill(model, batch, layers)
        for _ in range(2):
            tok, caches = decode(model, caches, tok[:, None])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"serve sync check ({cfg.name}): a prefill and 2 decode steps "
        f"ran with no host synchronization")


def run_serve_profile(model, dev, steps=4):
    """Device busy share and kernel time by name over one prefill and,
    separately, `steps` decode steps of the serve path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import steps as S_
    from repro_torch.launch.serve import context_stubs
    from repro_torch.models import lm
    cfg = model.cfg
    runcfg = RunConfig(remat=False)
    B, P, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    layers = lm.alloc_caches(cfg, B, P + G, torch.bfloat16, dev)
    prefill = S_.make_prefill_step(cfg, runcfg)
    decode = S_.make_decode_step(cfg, runcfg)
    toks = torch.randint(0, cfg.vocab_size, (B, P), device=dev)
    batch = {"tokens": toks, **context_stubs(cfg, B, P, dev)}
    tok, caches = prefill(model, batch, layers)                # warm
    tok, caches = decode(model, caches, tok[:, None])
    for tag, fn, n in (
            ("serve prefill", lambda: prefill(model, batch, layers), 1),
            ("serve decode", None, steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if fn is not None:
                fn()
            else:
                for _ in range(n):
                    tok, caches = decode(model, caches, tok[:, None])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = [e for e in prof.key_averages()
               if e.self_device_time_total > 0
               and not e.key.startswith("aten::")]
        dev_us = sum(e.self_device_time_total for e in evs)
        log(f"{cfg.name} {tag} profile over {n} step(s): wall "
            f"{wall * 1e3 / n:.3f} "
            f"ms/step, device busy {dev_us / 1e3 / n:.3f} ms/step "
            f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
            f"{sum(e.count for e in evs) / n:.0f} device kernels/step")
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / n:9.2f} us/step "
                f"{e.count / n:6.1f}/step  {e.key[:90]}")
        ssd_us = sum(e.self_device_time_total for e in evs
                     if "ssd_" in e.key)
        if fn is not None and cfg.ssm_state:
            log(f"{cfg.name} prefill device time {dev_us / 1e3:.3f} ms "
                f"(33.10 ms with the scalar scan kernel), ssd_scan "
                f"{ssd_us / 1e3:.3f} ms of it "
                f"({100 * ssd_us / max(dev_us, 1e-9):.1f}%; the scalar "
                f"kernel: 18.69 ms)")


# --------------------------------------------------------------------- #
# phase 14: the host services over the sim, at the paper's cluster size
# --------------------------------------------------------------------- #
SERVICES_EPOCHS = 2
CHAOS_TICKS = 120


def services_launches(tag, counts, want):
    """Print one run's launches of rows 1-6 and hold them to `want`."""
    got = {k: counts[k] for k in RAFT}
    log(f"{tag} launches: {json.dumps(got)}")
    for name, n in got.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{tag}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    return got


def run_services_fleet(tag, dev, specs, want, bids=False):
    """`SERVICES_EPOCHS` epochs of a fleet on the card, counts set to 0
    just before and read just after, then one epoch card against CPU."""
    import torch
    from repro_torch import kernels as K_
    from repro_torch.core.fleet import FleetSim
    fleet = FleetSim(specs, device=dev)
    B, T = fleet.shapes.B, fleet.shapes.T
    log(f"{tag}: {fleet.shapes}, widths trace {fleet.trace_ticks} arrival "
        f"{fleet.arrival_ticks} fault {fleet.fault_ticks}")
    wall = []
    K_.reset_launch_counts()
    for e in range(SERVICES_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = fleet.run_epoch()      # ends in the digest fetch (a sync)
        wall.append((time.perf_counter() - t0) * 1e3)
        for i, rep in enumerate(reps):
            check_report(rep, f"{tag} epoch {e} member {i}")
        log(f"{tag} epoch {e}: {wall[-1]:.1f} ms; writes committed "
            f"{[r.writes_committed for r in reps]}; killed "
            f"{[r.killed for r in reps]}; warned "
            f"{[r.n_warned for r in reps]}")
        if bids:
            b = fleet._cfg_c["spot_bid"].cpu().numpy()
            log(f"{tag} bids after epoch {e}: "
                f"{[[round(float(x), 6) for x in row] for row in b]}")
    counts = services_launches(tag, K_.launch_counts(), want)
    med = statistics.median(wall)
    log(f"{tag} epoch wall ms: {[round(w, 1) for w in wall]}, median "
        f"{med:.1f}; member-ticks/s {B * T * 1e3 / med:.1f}")
    run_card_vs_cpu(tag, fleet.state, [m.static for m in fleet.members],
                    fleet._cfg_c, T, fleet._gids, fleet.n_groups)
    return fleet, counts, wall


def chaos_drills(cfg):
    """`perf_faults.py`'s three canonical drills: (schedule, W, node
    that must survive or None)."""
    from repro_torch.market import kill_nodes, mass_kill, \
        warning_then_reprieve
    N, T = cfg.max_nodes, CHAOS_TICKS
    return {
        "leader_kill": (kill_nodes([0], 20, n_nodes=N, ticks=T), 0, None),
        "mass_kill_warned": (mass_kill(30, n_nodes=N, ticks=T,
                                       spare=(0, 1, 2), warning_ticks=3),
                             3, None),
        "warning_then_reprieve": (warning_then_reprieve(
            [4], 20, n_nodes=N, ticks=T, warning_ticks=8), 8, 4),
    }


def compare_chaos(tag, a, b):
    """Card and CPU ChaosReports: every field, snapshot and event."""
    import dataclasses
    import numpy as np
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    for k in ("trace", "events", "perfetto_path"):
        da.pop(k), db.pop(k)
    if da != db:
        raise AssertionError(f"{tag}: card report {da} != CPU report {db}")
    if len(a.trace) != len(b.trace):
        raise AssertionError(f"{tag}: {len(a.trace)} != {len(b.trace)} "
                             f"snapshots")
    for i, (x, y) in enumerate(zip(a.trace, b.trace)):
        for k in x:
            if not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{tag}: snapshot {i} differs at {k}")
    if [dataclasses.astuple(e) for e in a.events] != \
            [dataclasses.astuple(e) for e in b.events]:
        raise AssertionError(f"{tag}: card and CPU events differ")


def run_host_services(dev, cfg):
    """The host services over the sim at the paper's cluster size, each
    run's launches of rows 1-6 counted from 0 and held to the ticks it
    ran, each run also held against the CPU (ints exact, floats rtol
    1e-5):

    - the trace-market fleet of `perf_faults.py`: both bundled traces x
      W in {0, 25} x (no policy, a hazard-aware bid policy with
      `bid_on_trace`), 8 managed members, 2 epochs;
    - the open-loop system fleet of `perf_serving.py`: `system_specs`
      under a diurnal + flash-crowd plan with Zipfian keys, BW-Raft with
      the 550-slot digest rack, the AWS trace and a bid policy, Raft and
      2 Multi-Raft shards, 2 epochs, then the tick's sync-free check;
    - a managed `BWRaftSim` on the AWS trace with the predictor
      calibrated on the Google evictions, 3 epochs;
    - the three chaos drills of `perf_faults.py` through `run_chaos`
      (120 ticks, market silenced, recorder on): card report = CPU
      report, safety checks, trace-replayed leader timeline, a Perfetto
      file."""
    import tempfile
    import torch
    from repro_torch import kernels as K_
    from repro_torch.core import state as SM
    from repro_torch.core.draws import CpuDraws, fleet_epoch
    from repro_torch.core.fleet import MemberSpec, system_specs
    from repro_torch.core.runtime import BWRaftSim
    from repro_torch.market import (HazardAwareBid, calibrate_predictor,
                                    load, run_chaos)
    from repro_torch.workload import (DiurnalRate, FlashCrowd, OpenLoop,
                                      ZipfianKeys)
    T = cfg.period_ticks
    E = SERVICES_EPOCHS
    ticks = E * T
    per_tick = lambda n, **kw: dict({k: n for k in PER_TICK}, **kw)
    out, walls = {}, {}

    specs = []
    for tname in ("aws-us-east", "google-evict"):
        trace = load(tname, ticks=ticks)
        mean = trace.fit_to(cfg.num_sites, ticks).price.mean(axis=1)
        for w in (0, 25):
            for policy in (None, HazardAwareBid(mean_price=mean,
                                                window_ticks=T)):
                specs.append(MemberSpec(
                    cfg=cfg, write_rate=8.0, read_rate=32.0,
                    seed=len(specs), market="trace", trace=trace,
                    warning_ticks=w, bid_policy=policy,
                    bid_on_trace=policy is not None))
    _, out["trace_fleet"], walls["trace_fleet"] = run_services_fleet(
        "services trace fleet", dev, specs, per_tick(ticks), bids=True)

    aws = load("aws-us-east", ticks=ticks)
    plan = OpenLoop(write=DiurnalRate(8.0, amplitude=0.5),
                    read=FlashCrowd(DiurnalRate(32.0, amplitude=0.5),
                                    mult=4.0, every_ticks=50,
                                    burst_ticks=5),
                    ticks=2 * T)
    specs = system_specs(
        cfg, write_rate=8.0, read_rate=32.0, seed=0, shards=2, group_id=0,
        market="trace", trace=aws, arrivals=plan, keypop=ZipfianKeys(1.1),
        bid_policy=HazardAwareBid(
            mean_price=aws.fit_to(cfg.num_sites, ticks).price.mean(axis=1),
            window_ticks=T),
        n_observers=550, staleness_bound=12, ae_interval=4)
    fleet, out["open_loop_fleet"], walls["open_loop_fleet"] = \
        run_services_fleet("services open-loop fleet", dev, specs,
                           per_tick(ticks, ae_sync=ticks, group_reduce=E),
                           bids=True)
    g = fleet.group_reports[0][-1]
    obs = fleet.members[0].reports[-1]
    log(f"services open-loop fleet: multiraft group writes committed "
        f"{g.writes_committed}, 2PC prepares {g.two_pc_prepares}; digest "
        f"rack obs_reads_served {obs.obs_reads_served}, obs_stale_p99 "
        f"{obs.obs_stale_p99}")
    if g.writes_committed <= 0 or obs.obs_reads_served <= 0:
        raise AssertionError("the open-loop fleet's group or rack did "
                             "nothing")
    check_tick_sync_free(fleet.state, fleet._bstatic, fleet._cfg_c,
                         fleet_epoch(fleet.draws, 3, fleet.state,
                                     fleet._cfg_c), 3)

    predictor, crep = calibrate_predictor(load("google-evict", ticks=1200),
                                          T)
    log(f"services solo: predictor alpha {crep.alpha}, mae {crep.mae:.4g}, "
        f"rates {[round(float(r), 5) for r in predictor.predict()]}")
    sim = BWRaftSim(cfg, seed=0, market="trace",
                    trace=load("aws-us-east", ticks=3 * T),
                    predictor=predictor, device=dev)
    wall = []
    K_.reset_launch_counts()
    for e in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sim.run_epoch()
        wall.append((time.perf_counter() - t0) * 1e3)
        check_report(rep, f"services solo epoch {e}")
        log(f"services solo epoch {e}: {wall[-1]:.1f} ms; writes committed "
            f"{rep.writes_committed}, killed {rep.killed}, secretaries "
            f"{rep.n_secretaries}, observers {rep.n_observers}")
    out["solo"] = services_launches("services solo", K_.launch_counts(),
                                    per_tick(3 * T))
    walls["solo"] = wall
    med = statistics.median(wall)
    log(f"services solo epoch wall ms: {[round(w, 1) for w in wall]}, "
        f"median {med:.1f}; ticks/s {T * 1e3 / med:.1f}")
    run_card_vs_cpu("services solo", SM.batch1(sim.state), [sim.static],
                    SM.batch1(sim.cfg_c), T)

    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        for name, (faults, w, survivor) in chaos_drills(cfg).items():
            kw = dict(warning_ticks=w, ticks=CHAOS_TICKS, seed=0,
                      spot_bid=10.0, trace_on=True, check=False)
            K_.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = run_chaos(cfg, faults, device=dev,
                             draws=CpuDraws(0, dev),
                             trace_out=f"{tmp}/{name}.json", **kw)
            wall = (time.perf_counter() - t0) * 1e3
            out[name] = services_launches(f"services chaos {name}",
                                          K_.launch_counts(),
                                          per_tick(CHAOS_TICKS))
            walls[name] = [wall]
            t0 = time.perf_counter()
            host = run_chaos(cfg, faults, device=cpu, **kw)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            compare_chaos(f"services chaos {name}", card, host)
            if card.safety_error is not None:
                raise AssertionError(f"chaos {name}: {card.safety_error}")
            if not card.trace_leader_match:
                raise AssertionError(f"chaos {name}: the trace-replayed "
                                     f"leader timeline misses the probe")
            if survivor is not None and not all(
                    s["alive"][survivor] for s in card.trace):
                raise AssertionError(f"chaos {name}: node {survivor} died")
            size = Path(card.perfetto_path).stat().st_size
            log(f"services chaos {name}: W={w}, first kill tick "
                f"{card.first_kill_tick}, killed {card.killed_total}, "
                f"recovery {card.recovery_ticks} ticks, max leaderless "
                f"span {card.max_leaderless_span}, leader uptime "
                f"{card.leader_uptime:.4f}, alive at end {card.alive_end}, "
                f"{len(card.events)} events (dropped "
                f"{json.dumps(card.events_dropped)}), Perfetto {size} "
                f"bytes; equal to the CPU's report; card {wall:.0f} ms "
                f"({CHAOS_TICKS * 1e3 / wall:.1f} ticks/s with the "
                f"per-tick probe, snapshot and drain), CPU {cpu_ms:.0f} ms")
            del card, host
    total = {k: sum(c[k] for c in out.values()) for k in RAFT}
    log(f"services launches over the phase: {json.dumps(total)}")
    for k, n in total.items():
        if n <= 0:
            raise AssertionError(f"{k} never launched in the services "
                                 f"phase")
    return out, walls


# --------------------------------------------------------------------- #
# phase 15: the training path, card against CPU, then launch/train.py at
# full width
# --------------------------------------------------------------------- #
TRAIN_ARGS = ["--arch", "smollm-360m", "--full", "--batch", "8", "--seq",
              "64", "--steps", "6", "--ckpt-every", "3", "--kill-at", "4"]
# card vs CPU after one train step of the 2-layer full-width smollm, by
# dtype: (loss rtol, grad_norm rtol).  The parameters are held to what
# AdamW's first step allows: its normalized update is at most lr in size,
# so card and CPU may differ by 2 x lr where a gradient's sign or its
# size against eps differs, plus (bfloat16) the two sides' roundings to
# bf16, one ulp at most.  Chip readings on the H100: float32 loss 0 /
# 1.8e-7 apart (M = 1 / 2), grad_norm 2.1e-4 / 7.6e-5, the parameters at
# 0.998 of the bound, 2% of them more than 1e-6 apart (the clip scale,
# 1 / grad_norm, moves every update in eps's range) and under 1e-6 more
# than lr; bfloat16 loss 3.4e-5, grad_norm 1.4% / 1.6%, 0.4% of the
# parameters more than lr apart.
TRAIN_GATES = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 5e-2)}


def train_param_diff(a, b, lr, bf16):
    """(largest |a - b| over the bound 2 lr + one rounding, and the shares
    of the parameters more than one rounding, lr / 10 and lr apart) of
    two parameter sets."""
    worst, n, counts = 0.0, 0, [0, 0, 0]
    for x, y in zip(a, b):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        # bf16: both sides round to bf16, at most one ulp <= 2**-7 |v|
        rnd = (2 ** -7 * x.abs().maximum(y.abs()) if bf16
               else 1e-6 * x.abs()) + 1e-7
        d = (x - y).abs()
        worst = max(worst, float((d / (2 * lr + rnd)).max()))
        for k, t in enumerate((rnd, lr / 10, lr)):
            counts[k] += int((d > t).sum())
        n += d.numel()
    return worst, [c / n for c in counts]


def run_train_card_vs_cpu(dev, dtype, M, layers=2, B=4, S=64):
    """One train step of smollm-360m at full width (`layers` layers) on
    the card and on the CPU from the same weights and batch, M
    microbatches; then the card's step again from the same start.  The
    card's embedding backward accumulates with atomics, so its two runs
    need not be equal bit for bit: the rerun is held to the same bounds
    against the CPU, and its distance from the first run is printed.
    Returns the failures, after printing every reading."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S_
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    name = dtype_name(dtype)
    bf16 = name == "bfloat16"
    cfg = get_config("smollm-360m").with_layers(layers)
    run = RunConfig(remat=False, param_dtype=name, activation_dtype=name,
                    num_microbatches=M)
    cpu = torch.device("cpu")
    m0 = lm.init_lm(cfg, run, seed=1, device=cpu, trainable=True)
    batch = TokenPipeline(DataConfig(cfg.vocab_size, S, B)).batch_at(
        0, device=cpu)
    step = S_.make_train_step(cfg, run)
    out = []
    for where in (cpu, dev, dev):
        st = S_.init_train_state(copy.deepcopy(m0).to(where))
        st, met = step(st, {k: v.to(where) for k, v in batch.items()})
        out.append((met["loss"].item(), met["grad_norm"].item(),
                    list(st["params"].parameters())))
        del st
    (l0, g0, p0), (l1, g1, p1), (l2, g2, p2) = out
    loss_rtol, gn_rtol = TRAIN_GATES[name]
    lr = run.learning_rate
    tag = f"train card vs CPU ({layers} layers, {name}, B={B}, S={S}, M={M})"
    worst, shares = train_param_diff(p0, p1, lr, bf16)
    r_worst, r_shares = train_param_diff(p0, p2, lr, bf16)
    rr_worst, rr_shares = train_param_diff(p1, p2, lr, bf16)
    fmt = lambda w, sh: (f"{w:.4g} x (2 lr + rounding); shares past one "
                         f"rounding, lr/10, lr: "
                         f"{', '.join(f'{x:.3g}' for x in sh)}")
    log(f"{tag}: loss card {l1!r} / CPU {l0!r} (rerun {l2!r}); grad_norm "
        f"card {g1!r} / CPU {g0!r} (rerun {g2!r}); params card - CPU "
        f"{fmt(worst, shares)}; rerun - CPU {fmt(r_worst, r_shares)}; "
        f"rerun - card {fmt(rr_worst, rr_shares)}")
    failed = []
    for a, b, what, rtol in ((l1, l0, "loss", loss_rtol),
                             (l2, l0, "rerun loss", loss_rtol),
                             (g1, g0, "grad_norm", gn_rtol),
                             (g2, g0, "rerun grad_norm", gn_rtol)):
        if not abs(a - b) <= rtol * abs(b):
            failed.append(f"{tag}: {what} {a!r} vs CPU {b!r} (rtol {rtol})")
    for w, what in ((worst, "card"), (r_worst, "rerun")):
        if not w <= 1.0:
            failed.append(f"{tag}: {what} params {w:.4g} x the bound")
    return failed


def run_train_profile(state, dev, steps=2):
    """Device busy share and kernel time by name over `steps` more
    training steps of the trainer's final state (TRAIN_ARGS' shapes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S_
    cfg = state["params"].cfg
    B, S = (int(TRAIN_ARGS[TRAIN_ARGS.index(f) + 1])
            for f in ("--batch", "--seq"))
    step = S_.make_train_step(cfg, RunConfig(remat=False,
                                             num_microbatches=1))
    batch = TokenPipeline(DataConfig(cfg.vocab_size, S, B)).batch_at(
        6, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages()
           if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    dev_us = sum(e.self_device_time_total for e in evs)
    log(f"train step profile over {steps} steps: wall "
        f"{wall * 1e3 / steps:.3f} ms/step, device busy "
        f"{dev_us / 1e3 / steps:.3f} ms/step "
        f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
        f"{sum(e.count for e in evs) / steps:.0f} device kernels/step")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / steps:9.2f} us/step "
            f"{e.count / steps:6.1f}/step  {e.key[:90]}")


def run_train_path(dev, profile=False):
    """`launch.train.main` at full width on the card (TRAIN_ARGS: 32
    layers, bf16 weights, f32 AdamW, 6 steps, checkpoints at steps 3 and
    6, pod 1 failing at step 4) on the paper's cluster, launch counts set
    to 0 just before; then the leader pod killed, a new leader, and the
    last committed checkpoint restored.  Gates: finite losses; every
    CKPT_COMMIT in the replicated log in order and the last one in the
    leader's state machine, with the MEMBERSHIP record; the restored
    state bit for bit the saved one, its digest tag the record's; each
    per-tick consensus kernel launched once a tick (> 0), no other."""
    import tempfile
    import torch
    from repro_torch import kernels as K_
    from repro_torch.checkpoint.store import tree_digest
    from repro_torch.coord import log_records as rec
    from repro_torch.core import state as SM
    from repro_torch.launch import steps as S_
    from repro_torch.launch import train
    from repro_torch.models.common import tree_items
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.reset_peak_memory_stats(dev)
        K_.reset_launch_counts()
        t0 = time.perf_counter()
        rep = train.main(TRAIN_ARGS + ["--ckpt-dir", ckpt, "--device",
                                       str(dev)])
        wall = time.perf_counter() - t0
        coord = rep.coord
        if not all(map(math.isfinite, rep.losses)) or len(rep.losses) != 6:
            raise AssertionError(f"train: losses {rep.losses}")
        st = coord.sim.state
        lid = int(SM.leader_id(st))
        base = rec.record_base(coord.cfg.key_space)
        ck = base + int(rec.RecordType.CKPT_COMMIT)
        n = int(st["commit_len"][lid])
        keys = st["log_key"][lid, :n].cpu().numpy()
        vals = st["log_val"][lid, :n].cpu().numpy()
        logged = [rec.unpack_ckpt(int(v)) for v in vals[keys == ck]]
        want = [(s, int(d[:3], 16)) for s, d, _ in rep.commits]
        if logged != want or coord.last_committed_checkpoint() != want[-1]:
            raise AssertionError(f"train: committed CKPT_COMMITs {logged}, "
                                 f"state machine "
                                 f"{coord.last_committed_checkpoint()}, "
                                 f"expected {want}")
        if rep.membership != 0b1101:
            raise AssertionError(f"train: MEMBERSHIP {rep.membership:#b}")
        coord.kill_pod(lid)
        new = coord.wait_for_leader()
        coord.kv._step(20)
        step, tag = coord.last_committed_checkpoint()
        saved = S_.state_tree(rep.state)
        t1 = time.perf_counter()
        got, digest = rep.store.restore(step, saved)
        restore_ms = (time.perf_counter() - t1) * 1e3
        if new == lid or (step, tag) != want[-1] or \
                int(digest[:3], 16) != tag or tree_digest(got) != digest:
            raise AssertionError(f"train: after killing leader {lid}: "
                                 f"leader {new}, record {(step, tag)}, "
                                 f"digest {digest}")
        for (path, a), (_, b) in zip(tree_items(saved), tree_items(got)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"train: restored {path} differs")
        del saved, got
        ticks = int(coord.sim.state["tick"])
        counts = K_.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        if profile:
            run_train_profile(rep.state, dev)
    for k, c in counts.items():
        if c != (ticks if k in PER_TICK else 0) or (k in PER_TICK and
                                                   not c):
            raise AssertionError(f"train: {k} launched {c} times over "
                                 f"{ticks} coordinator ticks")
    B, S = (int(TRAIN_ARGS[TRAIN_ARGS.index(f) + 1])
            for f in ("--batch", "--seq"))
    step_ms = statistics.median(rep.step_ms[1:])
    n_params = sum(p.numel() for p in rep.state["params"].parameters())
    width = "full" if "--full" in TRAIN_ARGS else "reduced"
    log(f"train main (smollm-360m {width}, {n_params} params, B={B}, "
        f"S={S}): losses {rep.losses}; ms per train step {step_ms:.2f} "
        f"(median of steps 2-6; step 1 {rep.step_ms[0]:.1f}), "
        f"{B * S * 1e3 / step_ms:.1f} training tokens/s; checkpoint "
        f"save ms {[round(x, 1) for x in rep.save_ms]}, restore "
        f"{restore_ms:.1f}; CKPT_COMMIT ticks {rep.commit_ticks}, ms "
        f"{[round(x, 1) for x in rep.commit_ms]}; commits {rep.commits}; "
        f"membership {rep.membership:#b}; leader {lid} killed, new leader "
        f"{new}, restored step {step} bit for bit; {ticks} coordinator "
        f"ticks; peak {peak:.0f} MiB; {wall:.1f} s")
    log(f"train launches over the phase: {json.dumps(counts)}")
    return counts


def run_training(dev, profile=False):
    """Phase 15: (a) one train step card vs CPU, float32 and bfloat16,
    M = 1 and 2; (b) `launch.train.main` at full width (with `profile`, two
    more steps profiled); then (a)'s failures, if any, raise.  Returns
    the launches."""
    import torch
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for M in (1, 2):
            failed += run_train_card_vs_cpu(dev, dtype, M)
    counts = run_train_path(dev, profile)
    if failed:
        raise AssertionError("; ".join(failed))
    return counts


# --------------------------------------------------------------------- #
# phase 16: MoE, cross-attention and the encoder-decoder (ROADMAP 10d)
# --------------------------------------------------------------------- #
SERVE_10D = dict(requests=16, batch=8, prompt_len=128, gen_len=16,
                 revoke_p=0.1, seed=0)
# what phase 16(b) serves: (arch, layers; None = the config's depth).
# qwen2-moe-a2.7b at 8 of its 24 layers (the script's time budget; the
# launch counts are per layer); llama-3.2-vision-90b's 100 layers (about
# 170 GB in bf16) do not fit on the card: one period of 5, its last a
# cross layer (about 13 GB)
SERVE_10D_ARCHS = (("qwen2-moe-a2.7b", 8), ("seamless-m4t-medium", None),
                   ("llama-3.2-vision-90b", 5))
# host RAM phase 16(a)'s vision check needs: the 13 GB bf16 model copied
# from the card and the host run's activations, with room to spare
VISION_HOST_GIB = 32
# phase 16(a)'s kernel gate on a run's own operands: the kernel's distance
# from float64 at most this many times the twin's (plus ATT_TOL).  Chip
# readings on the H100: the kernel's largest distance at most 1.10x the
# twin's in every run; a decode kernel that drops the newest key 67,000x
# (float32) and 280x (bfloat16)
TWIN_SLACK = 4
# ... and its float32 per-layer gate: each layer fed the CPU's input, at
# most a share LAYER_F32_SHARE of the outputs outside 1e-3 (1 + |CPU's|)
# and none further than LAYER_F32_MAX.  Chip readings on the H100: at
# most 85 of 1,081,344 outputs (7.9e-5, seamless) outside, the largest
# 6.0e-3 (the f32 attention twin itself is up to 1.9e-3 from float64 on
# these operands); with the dropped key 12,694 of 1,114,112 (1.1e-2),
# the largest 70.9
LAYER_F32_SHARE = 1e-3
LAYER_F32_MAX = 0.05


@contextlib.contextmanager
def keep_attention_calls(kept):
    """The model's attention ops (`models.attention._flash_op`,
    `_decode_op`) wrapped: each call runs as before, and its operands and
    output are cloned into `kept` as (name, args, kwargs, output), so the
    kernels can be held against their twins afterwards on the operands a
    model run gave them."""
    from repro_torch.models import attention as A
    orig = A._flash_op, A._decode_op

    def keep(name, fn):
        def op(*args, **kw):
            out = fn(*args, **kw)
            kept.append((name, [a.clone() for a in args], kw, out.clone()))
            return out
        return op

    A._flash_op = keep("flash_attention", orig[0])
    A._decode_op = keep("decode_attention", orig[1])
    try:
        yield kept
    finally:
        A._flash_op, A._decode_op = orig


def attention_exact(name, args, kw):
    """An attention op's call (`models.attention._flash_op` or
    `_decode_op` operands) computed in float64 with plain torch
    (`attention.full_attention`): flash with its causal flag, decode
    over the keys below cache_len."""
    import torch
    from repro_torch.models import attention as A
    q, k, v = (a.double() for a in args[:3])
    H = q.shape[2]
    k, v = A.repeat_kv(k, H), A.repeat_kv(v, H)
    if name == "flash_attention":
        return A.full_attention(q, k, v, causal=kw.get("causal", True))
    B, T = k.shape[:2]
    return A.full_attention(
        q, k, v, q_pos=args[3].long()[:, None] - 1,
        k_pos=torch.arange(T, device=q.device)[None].expand(B, T))


def kernel_vs_twin(name, args, kw, got, want, dtype, ctx):
    """A kernel's output `got` against its twin's `want` on a model run's
    operands.  These operands are ill-conditioned (random-weight
    attention scores hundreds wide, values of both signs in the tens):
    on them the twin itself lands up to 1.9e-3 (float32) and 0.5
    (bfloat16) from the call in float64, past phase 8's tolerances.  So
    both are held against the call in float64 (`attention_exact`):
    every element of the kernel's output within ATT_TOL (1 + |exact|)
    plus TWIN_SLACK times the twin's largest distance from it in this
    call.  A wrong kernel (a key dropped, a wrong head) lands orders of
    magnitude outside.  Returns ((max |kernel - twin|, max |twin -
    exact|, max |kernel - exact|), the elements outside)."""
    import torch
    tol = ATT_TOL[dtype_name(dtype)]
    x = attention_exact(name, args, kw)
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name} {ctx}: non-finite output")
    t_err = (w - x).abs().max().item()
    d = (g - x).abs()
    out = d > tol + tol * x.abs() + TWIN_SLACK * t_err
    return ((g - w).abs().max().item(), t_err, d.max().item()), \
        int(out.sum())


@contextlib.contextmanager
def layer_taps(record, names, feed=None):
    """Every layer call (`lm.apply_block`, `lm._encoder_block`) in order:
    (its module's name in `names`, input h, context, output h) appended
    to `record` on the CPU.  With `feed`, such a record of another run,
    each layer takes that run's input h and context in place of its
    own: a run fed the CPU's record gives each layer's error from equal
    inputs, which the layers after it cannot amplify."""
    from repro_torch.models import lm
    orig = lm.apply_block, lm._encoder_block

    def tap(blk, h, ctx, call):
        if feed is not None:
            _, h0, c0, _ = feed[len(record)]
            h = h0.to(h.device)
            ctx = None if ctx is None else c0.to(h.device)
        out = call(h, ctx)
        h1 = out[0] if isinstance(out, tuple) else out
        record.append((names[id(blk)], h.cpu(),
                       None if ctx is None else ctx.cpu(), h1.cpu()))
        return out

    def block(blk, h, cfg, **kw):
        return tap(blk, h, kw.pop("ctx", None),
                   lambda h, c: orig[0](blk, h, cfg, ctx=c, **kw))

    def encoder_block(blk, h, *a, **kw):
        return tap(blk, h, None, lambda h, c: orig[1](blk, h, *a, **kw))

    lm.apply_block, lm._encoder_block = block, encoder_block
    try:
        yield record
    finally:
        lm.apply_block, lm._encoder_block = orig


def run_10d_card_vs_cpu(dev, dtype, arch, layers=2, B=2, S=128, steps=8,
                        reduced=False, direct=False):
    """One prefill and `steps` decode steps of `arch` at full width
    (`layers` layers; `reduced`: the reduced config) on the CPU, then
    twice on the card, from the same weights, tokens, drawn gates and
    seeded context; every run is fed the CPU's greedy tokens.  The
    weights are drawn on the card and copied to the host (the host's
    generator draws about 1e8 values a second: 80 s for the vision
    period).  Gates:

    - each attention kernel call of the card's first run (prefill
      self-attention; self and cross decode) against its twin and a
      float64 evaluation on the operands it was given
      (`kernel_vs_twin`);
    - float32: the card's second run gives each layer (decoder and
      encoder) the CPU's input to that layer and its context; at most a
      share LAYER_F32_SHARE of the layers' outputs outside SERVE_F32_TOL
      (1 + |CPU's|) of the CPU's, and none further than LAYER_F32_MAX;
    - `direct` (qwen2-moe-a2.7b and the reduced Jamba in float32): all
      the first run's logits within SERVE_F32_TOL of the CPU's, phase
      10's float32 gate.

    These random models amplify rounding through their layers (at full
    width attention is nearly one-hot, so a rounding moves how much of
    a row goes to which key, and in bf16 a rounding of a router input
    which experts a token takes), and card and CPU stood equally far
    from a float64 run of the same model (PERF.md §6).  So the other
    runs' whole-model figures, and the per-layer figures in bfloat16,
    are printed and not gated."""
    import collections
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch.serve import draw_gates, seeded_context
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    t0 = time.perf_counter()
    name = dtype_name(dtype)
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg.with_layers(layers)
    runcfg = RunConfig(remat=False, param_dtype=name, activation_dtype=name)
    cpu = torch.device("cpu")
    m_gpu = draw_gates(lm.init_lm(cfg, runcfg, seed=1, device=dev), 2)
    m_cpu = copy.deepcopy(m_gpu).to(cpu)
    names = {id(b): n for m in (m_cpu, m_gpu)
             for n, b in m.named_modules()}
    ctx = seeded_context(cfg, B, S, 3, dtype)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    tol = SERVE_F32_TOL if name == "float32" else ATT_TOL[name]
    where = f"16(a) {arch} {name}"

    def run(model, d, fed=None):
        """Logits of each step on the CPU; `fed`: the tokens each decode
        step takes (None: this run's greedy ones, which it returns)."""
        caches = lm.alloc_caches(cfg, B, S + steps, dtype, d)
        nxt, out, greedy = toks, [], []
        for step in range(-1, steps):
            kw = ({n: v.to(d) for n, v in ctx.items()} if step < 0 else
                  {"cache_len": torch.full((B,), S + step,
                                           dtype=torch.int32, device=d)})
            logits, _, _ = lm.forward(
                model, nxt.to(d), mode="prefill" if step < 0 else "decode",
                caches=caches, **kw)
            out.append(logits.float().cpu())
            greedy.append(out[-1][:, -1].argmax(-1).to(torch.int32)[:, None])
            nxt = greedy[-1] if fed is None else fed[step + 1]
        return out, greedy

    cpu_rec, card_rec, kept = [], [], []
    with torch.no_grad(), decode_ticket_check(dev) as tickets:
        with layer_taps(cpu_rec, names):
            want, fed = run(m_cpu, cpu)
        with keep_attention_calls(kept):
            got, _ = run(m_gpu, dev, fed)
        with layer_taps(card_rec, names, feed=cpu_rec):
            run(m_gpu, dev, fed)
    n_all = n_direct = n_tok = 0
    max_direct = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{where}: non-finite logits on the card")
        d = (g - w).abs()
        n_direct += int((d > tol + tol * w.abs()).sum())
        max_direct = max(max_direct, d.max().item())
        n_all += w.numel()
        n_tok += int((g[:, -1].argmax(-1) == w[:, -1].argmax(-1)).sum())
    # each layer from the CPU's inputs: its largest error and the share of
    # its outputs outside tol, over the steps
    per_layer = collections.defaultdict(lambda: [0.0, 0, 0])
    for (n, _, _, w), (_, _, _, g) in zip(cpu_rec, card_rec):
        d = (g.float() - w.float()).abs()
        r = per_layer[n]
        r[0] = max(r[0], d.max().item())
        r[1] += int((d > tol + tol * w.float().abs()).sum())
        r[2] += d.numel()
    n_layer_out = sum(r[1] for r in per_layer.values())
    n_layer_all = sum(r[2] for r in per_layer.values())
    worst = max(per_layer, key=lambda n: per_layer[n][0])
    del cpu_rec, card_rec
    # the kernels against their twins on the operands the card's run
    # gave them
    twins = {"flash_attention": fa_ref.flash_attention_ref,
             "decode_attention": da_ref.decode_attention_ref}
    calls = collections.Counter(n for n, *_ in kept)
    k_err = collections.defaultdict(lambda: [0.0, 0.0, 0.0])
    failed = []
    for i, (n, args, kw, out) in enumerate(kept):
        errs, bad = kernel_vs_twin(n, args, kw, out, twins[n](*args, **kw),
                                   dtype, (where, n, i))
        k_err[n] = [max(a, b) for a, b in zip(k_err[n], errs)]
        if bad:
            failed.append(f"{n} call {i} (q {tuple(args[0].shape)}, k "
                          f"{tuple(args[1].shape)}): {bad} elements "
                          f"outside")
    del kept
    depth = ("reduced" if reduced else f"{cfg.num_layers} layers") + (
        f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
    k_err = {n: [float(f"{x:.4g}") for x in e] for n, e in k_err.items()}
    by_layer = {n: float(f"{r[0]:.4g}") for n, r in per_layer.items()}
    log(f"{where} ({depth}, B={B}, prefill {S} + {steps} decode steps, "
        f"{time.perf_counter() - t0:.1f} s): kernel against twin on the "
        f"card's own operands: {json.dumps(dict(calls))} calls, max "
        f"|kernel - twin|, |twin - float64|, |kernel - float64| "
        f"{json.dumps(k_err)}; each layer from the CPU's inputs: "
        f"{n_layer_out} of {n_layer_all} outputs outside {tol}, max "
        f"|card - CPU| {per_layer[worst][0]:.4g} ({worst}), by layer "
        f"{json.dumps(by_layer)}; whole model: {n_direct} of {n_all} "
        f"logits outside {tol} (share {n_direct / n_all:.4g}), max "
        f"{max_direct:.4g}, greedy tokens equal on {n_tok} of "
        f"{B * (steps + 1)}; decode tickets "
        f"{json.dumps(tickets)}")
    if name == "float32" and (n_layer_out > LAYER_F32_SHARE * n_layer_all
                              or per_layer[worst][0] > LAYER_F32_MAX):
        failed.append(f"from the CPU's inputs, {n_layer_out} of "
                      f"{n_layer_all} layer outputs outside {tol}, the "
                      f"largest {per_layer[worst][0]:.4g} ({worst})")
    if direct and n_direct:
        failed.append(f"{n_direct} logits outside {tol}")
    if failed:
        raise AssertionError(f"{where}: {'; '.join(failed)}")


def host_available_gib() -> float:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2 ** 20
    return float("nan")


def free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_10d(dev, profile=False):
    """Phase 16: (a) card against CPU at full width cut in depth, with
    drawn gates and seeded contexts (`run_10d_card_vs_cpu`):
    qwen2-moe-a2.7b (2 layers) and seamless-m4t-medium (2 + 2 layers)
    in float32 and bfloat16, llama-3.2-vision-90b (one period of 5
    layers) in bfloat16, the reduced vision and the reduced Jamba in
    float32; (b) `serve()` of each SERVE_10D_ARCHS entry with its
    launches counted from 0, then its sync-free check and, with
    `profile`, the profile of a prefill and 4 decode steps.  Returns
    {"serve": {arch: launches with routes}, "jamba": launches of the
    Jamba check}."""
    import torch
    from repro_torch import kernels as K_
    f32, bf16 = torch.float32, torch.bfloat16
    for arch in ("qwen2-moe-a2.7b", "seamless-m4t-medium"):
        for dt in (f32, bf16):
            run_10d_card_vs_cpu(dev, dt, arch, direct=arch ==
                                "qwen2-moe-a2.7b" and dt == f32)
            free_card()
    gib = host_available_gib()
    log(f"host RAM available before the vision check: {gib:.1f} GiB "
        f"(it needs about {VISION_HOST_GIB})")
    if not gib >= VISION_HOST_GIB:
        raise AssertionError(f"{gib:.1f} GiB of host RAM available, the "
                             f"vision check needs {VISION_HOST_GIB}")
    run_10d_card_vs_cpu(dev, bf16, "llama-3.2-vision-90b", layers=5,
                        S=64, steps=4)
    free_card()
    # the reduced vision: the model whose whole-model card-vs-CPU error
    # sets test_torch_cuda.py's float32 bound
    run_10d_card_vs_cpu(dev, f32, "llama-3.2-vision-90b", S=24, steps=3,
                        reduced=True)
    K_.reset_launch_counts()
    run_10d_card_vs_cpu(dev, f32, "jamba-1.5-large-398b", S=40,
                        reduced=True, direct=True)
    jamba = K_.launch_counts()
    log(f"reduced Jamba card-vs-CPU launches: {json.dumps(jamba)}; by "
        f"route {json.dumps(K_.route_counts())}")
    served = {}
    for arch, layers in SERVE_10D_ARCHS:
        model, counts, _ = run_serve_path(dev, arch, layers, SERVE_10D)
        check_serve_sync_free(model, dev)
        if profile:
            run_serve_profile(model, dev)
        served[arch] = counts
        del model
        free_card()
    return {"serve": served, "jamba": jamba}


# --------------------------------------------------------------------- #
# phase 17: the expert-parallel MoE on ranks sharing the card
# --------------------------------------------------------------------- #
MOE_EP_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
MOE_EP_RANKS = (4, 8)
MOE_EP_SHAPES = {"a2a": (8, 512), "psum": (8, 1)}   # prefill, decode (B, S)
MOE_EP_NO_DROP = 8.0           # the capacity factor at which nothing drops
# (a) the ranks' gathered output against the dense form on the card: float32
# within 1e-4 (rtol = atol); bfloat16 at most a share MOE_EP_BF16_SHARE of
# the outputs outside 3e-2 and none past MOE_EP_BF16_MAX (PERF.md §6:
# written before the first chip run)
MOE_EP_F32_TOL = 1e-4
MOE_EP_BF16_TOL = 3e-2
MOE_EP_BF16_SHARE = 1e-3
MOE_EP_BF16_MAX = 0.125
# (b) a token whose top-k differs between the card and the CPU must be a
# near-tie: the CPU's k-th and (k+1)-th probabilities within this
MOE_EP_TIE = 1e-5
MOE_EP_REPS = 3
MOE_EP_SEED = 17
MOE_EP_TIMEOUT = 420.0


def moe_ep_wire_bytes(form, T, D, k, ep, cf, itemsize):
    """One MoE layer's wire bytes per rank in closed form (comm_stats'
    ring models): a2a sends (ep, cap, D) out and back and the (ep, cap)
    int32 expert ids, each all-to-all (ep - 1)/ep of it; psum all-reduces
    (T, D), 2 (ep - 1)/ep of it; both all-reduce the float32 aux.  T is
    the rank's tokens."""
    ring = (ep - 1) / ep
    aux = 4 * 2 * ring
    if form == "psum":
        return int(T * D * itemsize * 2 * ring + aux)
    cap = max(int(-(-T * k // ep) * cf), 1)
    return int(2 * ep * cap * D * itemsize * ring + ep * cap * 4 * ring
               + aux)


def moe_ep_unaffected(ids_a, ids_b, bins_a, bins_b, k):
    """Entries (T*k,) whose position in their bin cannot differ between
    two routings: not of a token whose top-k differs, and before, in
    token order, the first such token entering their bin on either
    side.  Also returns the tokens whose top-k differs."""
    import numpy as np
    T = ids_a.shape[0]
    flipped = (ids_a != ids_b).any(axis=1)
    fe = np.repeat(flipped, k)
    tok = np.repeat(np.arange(T), k)
    ba, bb = bins_a.reshape(-1), bins_b.reshape(-1)
    first = np.full(int(max(ba.max(), bb.max())) + 1, T)
    np.minimum.at(first, ba[fe], tok[fe])
    np.minimum.at(first, bb[fe], tok[fe])
    return (~fe) & (tok < first[ba]), flipped


def moe_ep_case(arch, dt, ep, rank, mesh, dev, reduced, check_sync):
    """One model in one dtype on this rank: gates (a), (c), (d) at
    MOE_EP_NO_DROP through `moe_apply` and the bodies, layer times, and
    in float32 gate (b) at the configured capacity, card against CPU."""
    import dataclasses
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.launch import comm_stats
    from repro_torch.models import moe
    from repro_torch.models.common import init_tree
    base = get_config(arch)
    base = base.reduced() if reduced else base
    cfg8 = dataclasses.replace(base, moe_capacity_factor=MOE_EP_NO_DROP)
    dm, group = mesh.device_mesh, mesh.group("model")
    rep, shard = [Replicate(), Replicate()], [Replicate(), Shard(0)]
    full = init_tree(torch.Generator(device=dev).manual_seed(MOE_EP_SEED),
                     moe.moe_params(base, dt))
    E_loc = full["wg"].shape[0] // ep
    sl = slice(rank * E_loc, (rank + 1) * E_loc)
    p = {n: DTensor.from_local(v[sl].contiguous() if n in ("wg", "wu", "wd")
                               else v, dm,
                               shard if n in ("wg", "wu", "wd") else rep,
                               run_check=False) for n, v in full.items()}
    k, D = base.moe_top_k, base.d_model
    res = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    for form, (B, S) in MOE_EP_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(MOE_EP_SEED + S)
        x = torch.randn((B, S, D), generator=gen, device=dev).to(dt)
        xd = DTensor.from_local(x, dm, rep, run_check=False)
        r = {}
        with torch.no_grad():
            # (d) the collectives of one layer, through the entry point
            with comm_stats.CollectiveRecorder() as rec:
                y, aux = moe.moe_apply(p, xd, cfg8, mesh)
            T = B * S // ep if form == "a2a" else B * S
            r["wire"] = comm_stats.total_collective_bytes(rec.records)
            r["wire_want"] = moe_ep_wire_bytes(form, T, D, k, ep,
                                               MOE_EP_NO_DROP, dt.itemsize)
            r["kinds"] = [k_ for k_, _, _ in rec.records]
            yf = moe_ep_gather(y)
            times = []
            for _ in range(MOE_EP_REPS):
                torch.distributed.barrier()
                sync()
                t0 = time.perf_counter()
                y2, _ = moe.moe_apply(p, xd, cfg8, mesh)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            r["ms"] = statistics.median(times)
            del y2
            # (a) the gathered output against the dense form, on rank 0
            if rank == 0:
                yd, auxd = moe.moe_apply_dense(full, x, cfg8)
                diff = (yf.float() - yd.float()).abs()
                tol = MOE_EP_F32_TOL if dt == torch.float32 \
                    else MOE_EP_BF16_TOL
                r["max_err"] = diff.max().item()
                r["outside"] = (diff > tol * (1 + yd.float().abs())).sum(
                    ).item() / diff.numel()
                r["aux_err"] = abs(aux.full_tensor().item() - auxd.item())
                times = []
                for _ in range(MOE_EP_REPS):
                    sync()
                    t0 = time.perf_counter()
                    moe.moe_apply_dense(full, x, cfg8)
                    sync()
                    times.append((time.perf_counter() - t0) * 1e3)
                r["dense_ms"] = statistics.median(times)
                del yd, diff
            torch.distributed.barrier()
            # (c) the rank-local work reads nothing on the host; the bodies'
            # routing also counts what dropped
            xl = x if form == "psum" else \
                x[:, rank * (S // ep):(rank + 1) * (S // ep)]
            body = moe._moe_local_a2a if form == "a2a" else \
                moe._moe_local_psum
            w = [full["router"]] + [full[n][sl] for n in ("wg", "wu", "wd")]
            with moe_ep_sync_checked(check_sync):
                _, _, route = body(xl, *w, cfg=cfg8, ep=ep, group=group)
            if form == "a2a":
                r["dropped"] = int((~route["keep"]).sum().item() + (
                    (route["pos2"] >= 0) & ~route["keep2"]).sum().item())
            else:
                local = (route["ids"] // E_loc == rank).reshape(-1)
                r["dropped"] = int((local & ~route["keep"]).sum().item())
            # (b) card against CPU at the configured capacity, float32
            if dt == torch.float32:
                r.update(moe_ep_card_vs_cpu(body, xl, w, base, ep, group,
                                            rank, E_loc))
        res[form] = r
        del x, xd, y, yf
    return res


def moe_ep_gather(y):
    """The whole of a DTensor sharded on one mesh dim (or replicated), on
    every rank, gathered on the host: gloo's all-gather of CUDA tensors,
    which `full_tensor()` makes, crashed the rank on the card's torch
    (PERF.md §6)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    dims = [(i, pl.dim) for i, pl in enumerate(y.placements)
            if isinstance(pl, Shard) and y.device_mesh.size(i) > 1]
    local = y.to_local()
    if not dims:
        return local
    (mesh_dim, dim), = dims
    group = y.device_mesh.get_group(mesh_dim)
    host = local.cpu()
    parts = [torch.empty_like(host) for _ in range(group.size())]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts, dim=dim).to(local.device)


@contextlib.contextmanager
def moe_ep_sync_checked(on):
    """`torch.cuda.set_sync_debug_mode("error")` over the bodies' rank-
    local work: the route, the packing, the expert products and the
    combine.  Each collective runs, and completes, with the check off."""
    import torch
    from repro_torch.models import moe
    if not on:
        yield
        return
    saved = moe._all_to_all, moe._psum

    def unchecked(fn):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode(0)
            try:
                out = fn(*a, **kw)       # waits for the collective
                torch.cuda.synchronize()
                return out
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    moe._all_to_all, moe._psum = (unchecked(f) for f in saved)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        moe._all_to_all, moe._psum = saved


def moe_ep_card_vs_cpu(body, xl, w, cfg, ep, group, rank, E_loc):
    """Gate (b): the body on the card and on the CPU (the same gloo group)
    from the same float32 inputs.  Returns the flips (tokens whose top-k
    differs, each with the CPU's k-th / (k+1)-th probability gap), the
    integer routing entries compared and those that differ, and the
    largest output difference where routing agrees."""
    import numpy as np
    import torch
    import torch.distributed as dist
    k = cfg.moe_top_k
    with torch.no_grad():
        yc, _, rc = body(xl, *w, cfg=cfg, ep=ep, group=group)
        xh, wh = xl.cpu(), [t.cpu() for t in w]
        yh, _, rh = body(xh, *wh, cfg=cfg, ep=ep, group=group)
        xf = xh.reshape(-1, xh.shape[-1]).float()
        logits = xf @ wh[0]
        logits[:, cfg.moe_num_experts:] = -1e30
        probs = torch.sort(torch.softmax(logits, -1), -1,
                           descending=True).values
    rc = {n: v.cpu().numpy() for n, v in rc.items()}
    rh = {n: v.numpy() for n, v in rh.items()}
    ids_c, ids_h = rc["ids"], rh["ids"]
    bins = (lambda ids: ids // E_loc) if "pos2" in rh else (
        lambda ids: np.where(ids // E_loc == rank, ids % E_loc, E_loc))
    ok, flipped = moe_ep_unaffected(ids_c, ids_h, bins(ids_c), bins(ids_h),
                                    k)
    n_flips = torch.tensor([int(flipped.sum())])
    dist.all_reduce(n_flips, group=group)       # on the CPU: gloo
    gaps = (probs[:, k - 1] - probs[:, k]).numpy()[flipped]
    out = {"flips": int(flipped.sum()), "flip_gaps": gaps.tolist(),
           "compared": 0, "differ": 0}
    for n in ("pos", "keep"):
        out["compared"] += int(ok.sum())
        out["differ"] += int((rc[n][ok] != rh[n][ok]).sum())
    out["ids_differ_unflipped"] = int(
        (ids_c[~flipped] != ids_h[~flipped]).sum())
    if "pos2" in rh and int(n_flips) == 0:
        for n in ("pos2", "keep2"):
            out["compared"] += rh[n].size
            out["differ"] += int((rc[n] != rh[n]).sum())
    tok_ok = ok.reshape(-1, k).all(axis=1)
    if "pos2" not in rh:                 # psum: every rank's entries count
        agree = torch.from_numpy(tok_ok.astype(np.int32))
        dist.all_reduce(agree, op=dist.ReduceOp.MIN, group=group)
        tok_ok = agree.numpy().astype(bool)
    a = yc.cpu().reshape(-1, yc.shape[-1])[torch.from_numpy(tok_ok)]
    b = yh.reshape(-1, yh.shape[-1])[torch.from_numpy(tok_ok)]
    out["out_compared"] = int(tok_ok.sum())
    out["out_err"] = float((a - b).abs().max()) if a.numel() else 0.0
    out["out_outside"] = int(((a - b).abs() > MOE_EP_F32_TOL * (
        1 + b.abs())).sum())
    return out


def moe_ep_rank(rank, world, dev_type, reduced):
    """One rank of phase 17: the ("data", "model") = (1, world) mesh over
    the ranks sharing device 0 (gloo: CUDA tensors staged through the
    host), each model in float32 and bfloat16 (`moe_ep_case`)."""
    import os
    import torch
    from repro_torch import kernels as K_
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    mesh = make_host_mesh(model=world, device_type=dev_type)
    K_.reset_launch_counts()
    out = {"cases": {}}
    for arch in MOE_EP_ARCHS:
        for dt in (torch.float32, torch.bfloat16):
            out["cases"][arch, dtype_name(dt)] = moe_ep_case(
                arch, dt, world, rank, mesh, dev, reduced,
                check_sync=dev.type == "cuda")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    out["launches"] = K_.launch_counts()
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def run_moe_ep(dev_type="cuda", reduced=False, ranks=MOE_EP_RANKS):
    """Phase 17: the expert-parallel MoE (`models/moe.py`, ROADMAP.md §1
    item 10e) at full published width on `ep` gloo ranks sharing the
    card, spawned with a FileStore in a temporary directory
    (`launch.local_ranks.run_ranks`: a rank that raises, dies or runs
    past MOE_EP_TIMEOUT fails the phase).  Returns the kernel launches
    counted over it, by ep (none of the port's kernels is on this path)."""
    from repro_torch.launch.local_ranks import run_ranks
    launches = {}
    for ep in ranks:
        t0 = time.perf_counter()
        res = run_ranks(moe_ep_rank, ep, dev_type, reduced,
                        timeout=MOE_EP_TIMEOUT)
        log(f"phase 17: ep={ep} ranks on {dev_type} in "
            f"{time.perf_counter() - t0:.1f} s"
            + (f", peak {max(r['peak_gib'] for r in res):.1f} GiB a rank"
               if "peak_gib" in res[0] else ""))
        for (arch, dt), cases in res[0]["cases"].items():
            for form, r0 in cases.items():
                rs = [r["cases"][arch, dt][form] for r in res]
                check_moe_ep(ep, arch, dt, form, r0, rs)
        launches[ep] = res[0]["launches"]
        if any(res[0]["launches"].values()):
            raise AssertionError(f"phase 17 launched port kernels: "
                                 f"{res[0]['launches']}")
    return launches


def check_moe_ep(ep, arch, dt, form, r0, rs):
    """Print one (ep, model, dtype, form) row and apply gates (a)-(d)."""
    tag = f"phase 17 ep={ep} {arch} {dt} {form}"
    ms = statistics.median(r["ms"] for r in rs)
    log(f"{tag}: vs dense max_err {r0['max_err']:.3g} (share outside "
        f"{r0['outside']:.3g}), aux err {r0['aux_err']:.3g}; wire "
        f"{rs[0]['wire']} B/rank (closed form {rs[0]['wire_want']}), "
        f"{rs[0]['kinds']}; dropped {sum(r['dropped'] for r in rs)}; "
        f"layer ms {ms:.3f} (ranks {[round(r['ms'], 3) for r in rs]}), "
        f"dense {r0['dense_ms']:.3f} ms")
    if dt == "float32":
        if r0["outside"]:
            raise AssertionError(f"{tag}: {r0['outside']:.3g} of the "
                                 f"outputs outside {MOE_EP_F32_TOL}")
    elif r0["outside"] > MOE_EP_BF16_SHARE or \
            r0["max_err"] > MOE_EP_BF16_MAX:
        raise AssertionError(f"{tag}: share {r0['outside']:.3g} outside "
                             f"{MOE_EP_BF16_TOL}, max {r0['max_err']:.3g}")
    for i, r in enumerate(rs):
        if r["wire"] != r["wire_want"]:
            raise AssertionError(f"{tag} rank {i}: {r['wire']} wire bytes, "
                                 f"the closed form {r['wire_want']}")
        if r["dropped"]:
            raise AssertionError(f"{tag} rank {i}: {r['dropped']} entries "
                                 f"dropped at {MOE_EP_NO_DROP}")
    if dt != "float32":
        return
    flips = sum(r["flips"] for r in rs)
    gaps = [g for r in rs for g in r["flip_gaps"]]
    log(f"{tag} card vs CPU at the configured capacity: {flips} tokens "
        f"whose top-k flipped (CPU gaps {gaps}); routing entries compared "
        f"{sum(r['compared'] for r in rs)}, differing "
        f"{sum(r['differ'] for r in rs)}; outputs compared on "
        f"{sum(r['out_compared'] for r in rs)} tokens, max_err "
        f"{max(r['out_err'] for r in rs):.3g}")
    for i, r in enumerate(rs):
        if r["differ"] or r["ids_differ_unflipped"] or r["out_outside"]:
            raise AssertionError(f"{tag} rank {i}: card vs CPU {r}")
        if any(g > MOE_EP_TIE for g in r["flip_gaps"]):
            raise AssertionError(f"{tag} rank {i}: a top-k flip past a "
                                 f"near-tie: {r['flip_gaps']}")


# --------------------------------------------------------------------- #
# phase 18: the LM forward on DTensors over ranks sharing the card
# --------------------------------------------------------------------- #
GLOO_PROBE_BIG = 2 ** 22     # elements a rank: 16 MB, an activation's size


def gloo_probe_rank(rank, world, name, staged, n):
    """One functional collective of n float32 elements a rank, made by a
    kernel on the current stream just before, over the default gloo
    group, its result checked on the host; with `staged`, through
    `local_ranks.stage_through_host`."""
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fc
    from repro_torch.launch.local_ranks import stage_through_host
    torch.cuda.set_device(0)
    if staged:
        stage_through_host()
    g = dist.group.WORLD
    base = torch.arange(n, dtype=torch.float32)
    dev = torch.device("cuda")
    x = torch.arange(n, dtype=torch.float32, device=dev) + 10 * rank
    if name == "all_gather_into_tensor":
        y = fc.all_gather_tensor(x, 0, g)
        want = torch.cat([base + 10 * r for r in range(world)])
    elif name == "all_reduce":
        y = torch.cat([fc.all_reduce(x, "sum", g),
                       fc.all_reduce(x, "max", g)])
        want = torch.cat([world * base + 10 * sum(range(world)),
                          base + 10 * (world - 1)])
    elif name == "reduce_scatter_tensor":
        xx = torch.arange(n * world, dtype=torch.float32, device=dev)
        y = fc.reduce_scatter_tensor(xx, "sum", 0, g)
        want = world * (torch.arange(n, dtype=torch.float32) + n * rank)
    elif name == "all_to_all_single":
        xx = torch.arange(n * world, dtype=torch.float32, device=dev) + \
            1e7 * rank
        y = fc.all_to_all_single(xx, None, None, g)
        want = torch.cat([torch.arange(n * rank, n * rank + n,
                                       dtype=torch.float32) + 1e7 * r
                          for r in range(world)])
    else:
        y = fc.broadcast(x, 0, g)
        want = base
    y = fc.wait_tensor(y) if hasattr(fc, "wait_tensor") else y
    y = y * 1.0                       # a kernel reading the result
    torch.cuda.synchronize()
    return bool(torch.equal(y.cpu(), want)), y.device.type


def probe_gloo(world=4):
    """Which functional collectives gloo takes on CUDA tensors of ranks
    sharing the card, each in its own spawn (a crash fails that spawn
    only): raw at 4 and GLOO_PROBE_BIG elements a rank, and staged
    through the host at GLOO_PROBE_BIG.  Returns {name: {"raw",
    "staged"}: "ok" | "wrong" | the failure's first line}."""
    from repro_torch.launch.local_ranks import STAGED, run_ranks
    out = {}
    for name in STAGED:
        out[name] = {}
        for staged, n in ((False, 4), (False, GLOO_PROBE_BIG),
                          (True, GLOO_PROBE_BIG)):
            key = ("staged" if staged else "raw") + f" {n}"
            try:
                res = run_ranks(gloo_probe_rank, world, name, staged, n,
                                timeout=120.0)
                out[name][key] = "ok" if all(r[0] for r in res) else \
                    f"wrong {res}"
            except RuntimeError as exc:
                lines = [ln for ln in str(exc).splitlines() if ln.strip()]
                out[name][key] = " | ".join(lines[:1] + lines[-1:])
            log(f"gloo probe {name} {key}: {out[name][key]}")
    return out


LM_MESH_SHAPES = {"1x4": 4, "2x2": 2}   # ("data", "model") over 4 ranks
LM_MESH_WORLD = 4
# (name, arch, dtypes, profile, B, prompt, capacity, meshes, layers, or a
# dict of layers by dtype): llama3.2-1b at full width cut from 16 layers
# to 8, its long profile in bfloat16 to 12; qwen2-moe-a2.7b at full
# width cut to 2 of its 24 layers; the reduced Jamba.  Depth only, for
# the script's time budget (the host-staged steps are not a speed of the
# method); the launch counts and the merge's bytes are per layer.  The
# logit gates read rounding, and a shallower random model carries a
# layer's rounding further into its logits (its last layers weigh more
# in the residual stream); each cut keeps that rounding inside them, and
# the readings repeat bit for bit between calls.  Two causes, each with
# a second witness (`--depth-witness`, PERF.md §6): in float32 the host
# against the card, no mesh, crosses the 1e-4 (1 + |x|) limit at 4
# layers as the mesh does and stays under it at 8; in bfloat16 2 x 2
# shards the weights' d_model over "data", so each projection sums two
# bf16-rounded partial sums where one device rounds once (as XLA's
# all-reduce of a bf16 dot does), and with d_model kept whole the long
# case's logit share past 3e-2 at 4 layers falls from past the 0.1 limit
# to 0
LM_MESH_CASES = (
    ("llama", "llama3.2-1b", ("float32", "bfloat16"), "decode", 8, 512,
     544, ("1x4", "2x2"), 8),
    ("llama-long", "llama3.2-1b", ("float32", "bfloat16"), "long", 1, 2048,
     2080, ("1x4", "2x2"), {"float32": 8, "bfloat16": 12}),
    ("qwen2-moe", "qwen2-moe-a2.7b", ("bfloat16",), "decode", 8, 512, 544,
     ("1x4",), 2),
    ("jamba", "jamba-1.5-large-398b", ("float32",), "decode", 8, 64, 96,
     ("1x4",), "reduced"),
)
LM_MESH_STEPS = 8
LM_MESH_SEED = 23
# every functional collective of CUDA tensors is staged through the host
# (`local_ranks.stage_through_host()`): on the card's torch (2.11)
# gloo's all-gather of CUDA tensors kills the rank (its all-reduce,
# reduce-scatter, all-to-all and broadcast are right at 4 and 2**22
# elements: `python3 chip_smoke.py --probe-gloo`, PERF.md §6); one rule
# for every op is simpler than a list of the ops that fail
# (a) the mesh run, each layer fed the one-device run's input, against the
# one-device run on the card from the same weights: the logits and the
# caches in float32 within LM_MESH_F32_TOL (rtol = atol; PERF.md §6,
# written before the first chip run); in bfloat16 at most a share
# LM_MESH_BF16_SHARE outside LM_MESH_BF16_TOL and none past
# LM_MESH_BF16_MAX (1 + |x|).  Without the taps the full-width runs end
# O(1) apart (llama f32 logits 5.2 apart after 16 layers; a 1e-7
# relative change of the embedding moves the 2-layer full-width llama's
# logits by 2.9e-4 on the CPU): random weights, not the mesh
LM_MESH_F32_TOL = 1e-4
LM_MESH_BF16_TOL = 3e-2
# ... and each layer: in float32 a share of at most LM_MESH_LAYER_SHARE
# past LM_MESH_LAYER_TOL (1 + |x|) and none past LAYER_F32_MAX (1 + |x|),
# as phase 16(a) holds a layer (a partial sum over the ranks cancels to
# a value far smaller than its terms, random weights, and its rounding
# then lies far from the one-device GEMM's in relative terms); in every
# dtype ||mesh - one device|| / ||one-device output - input|| within
# LM_MESH_LAYER_NORM (bfloat16: each rank's partial sum is rounded to
# bf16 before the sum, as XLA's all-reduce of a bf16 dot does).
# Each limit lies between the readings of this tree and of three mutants
# on the card (PERF.md §6): f32 layer share 0.0039 here, >= 0.498 for
# every mutant; bf16 logit and cache share 0.042, >= 0.756 for a wrong
# merge or KV head (a wrong cache write: largest 40.3 (1 + |x|) against
# 0.242 here); layer norm f32 2.2e-5 against >= 0.181, bf16 0.127
# against >= 0.721 for a wrong merge or KV head
LM_MESH_LAYER_TOL = 1e-3
LM_MESH_LAYER_SHARE = 1e-2
LM_MESH_LAYER_NORM = {"float32": 1e-3, "bfloat16": 0.3}
LM_MESH_BF16_SHARE = 0.1
LM_MESH_BF16_MAX = 0.5
LM_MESH_TIMEOUT = 900.0
LM_MESH_OPS = ("flash", "decode", "decode_lse", "ssd_scan")


def lm_mesh_cfg(arch, layers, overrides=()):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers == "reduced":
        cfg = cfg.reduced()
    elif layers:
        cfg = cfg.with_layers(layers)
    # an expert-parallel layer that drops nothing computes the dense form
    return dataclasses.replace(
        cfg, moe_capacity_factor=MOE_EP_NO_DROP,
        sharding_overrides=cfg.sharding_overrides + tuple(overrides))


def lm_mesh_compare(got, want, tol, base=None):
    """(max |got - want|, share outside tol (1 + |want|), max |got -
    want| / (1 + |want|)), on the card; with `base` (a layer's input)
    also ||got - want|| / ||want - base||, the error against the layer's
    own contribution to the residual stream."""
    import torch
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), 1.0, float("inf"), float("inf")
    d = (g - w).abs()
    r = d / (1 + w.abs())
    out = (d.max().item(), (r > tol).float().mean().item(), r.max().item())
    if base is None:
        return out
    delta = torch.linalg.vector_norm(w - base.float()).item()
    return out + (torch.linalg.vector_norm(g - w).item() / max(delta, 1e-30),)


def lse_exact(q, k, clen):
    """The log-sum-exp of a decode call's scaled scores over the keys
    below cache_len, in float64: q (B,1,H,hd), k (B,T,KV,hd) -> (B,H)."""
    import torch
    from repro_torch.models import attention as A
    q, k = q.double(), A.repeat_kv(k.double(), q.shape[2])
    s = torch.einsum("bshk,bthk->bht", q, k) / q.shape[-1] ** 0.5
    T = k.shape[1]
    keep = torch.arange(T, device=q.device)[None] < clen.long()[:, None]
    return torch.logsumexp(s.masked_fill(~keep[:, None], float("-inf")),
                           dim=-1)


def lm_mesh_twin_check(call, rank_seq, n_seq, dtype):
    """Gate (b): the (o, lse) form on this rank's own cache shard against
    its twin, with the run's cache_len and with each row's clamped from
    global lengths that put 0, 1, T_local - 1 and T_local on the shards.
    A row with no valid key must give o = 0 and lse = -inf from both;
    the others are held as phase 16(a) holds the kernels on a run's
    operands (`kernel_vs_twin`): o and lse against the call in float64,
    within ATT_TOL (1 + |exact|) plus TWIN_SLACK times the twin's
    distance.  Returns, by case, (max |kernel - twin|, the twin's and the
    kernel's distance from float64) for o and for lse, and the local
    cache_len values."""
    import torch
    from repro_torch.kernels.decode_attention import ops, ref
    q, k, v, clen = call
    Tl = k.shape[1]
    T = Tl * n_seq
    lens = [1, Tl - 1, Tl, Tl + 1, 2 * Tl - 1, T - Tl, T - 1, T]
    B = max(q.shape[0], len(lens))
    lens = torch.tensor([lens[i % len(lens)] for i in range(B)],
                        dtype=torch.int32, device=q.device)
    rows = torch.arange(B, device=q.device) % q.shape[0]   # B = 1: repeated
    eq, ek, ev = q[rows].contiguous(), k[rows].contiguous(), \
        v[rows].contiguous()
    tol = ATT_TOL[dtype_name(dtype)]
    out = {}
    for tag, (q, k, v, c) in (
            ("run", (q, k, v, clen)),
            ("edges", (eq, ek, ev, (lens - rank_seq * Tl).clamp(0, Tl).to(
                torch.int32)))):
        o, lse = ops.decode_attention(q, k, v, c, with_lse=True)
        ro, rlse = ref.decode_attention_ref(q, k, v, c, with_lse=True)
        empty = c == 0
        for name, got in (("kernel", (o, lse)), ("twin", (ro, rlse))):
            if (got[0][empty] != 0).any() or \
                    (got[1][empty] != -float("inf")).any():
                raise AssertionError(f"decode (o, lse) {tag}: the {name} "
                                     f"gives a row with no key o != 0 or "
                                     f"lse != -inf")
        live = ~empty
        res = {"lens": sorted(set(c.tolist()))}
        if live.any():
            a = [t[live] for t in (q, k, v, c)]
            res["o"], bad = kernel_vs_twin("decode_attention", a, {},
                                           o[live], ro[live], dtype, tag)
            x = lse_exact(a[0], a[1], a[3])
            g, w = lse[live].double(), rlse[live].double()
            t_err = (w - x).abs().max().item()
            d = (g - x).abs()
            bad += int((d > tol + tol * x.abs() + TWIN_SLACK * t_err).sum())
            res["lse"] = ((g - w).abs().max().item(), t_err,
                          d.max().item())
            if bad:
                raise AssertionError(f"decode (o, lse) {tag}: {bad} "
                                     f"elements outside the gate: {res}")
        out[tag] = res
    out["T_local"] = Tl
    return out


def lm_mesh_case(name, arch, dt, profile, B, S, cap, mesh, layers, dev,
                 rank, overrides=()):
    """One case on one mesh, on this rank: the one-device run on the card,
    then the mesh run from the same weights fed the one-device run's
    greedy tokens and, layer by layer, its layer inputs (random-weight
    models are chaotic: at full width two runs apart by float32 rounding
    end O(1) apart after 16 layers, PERF.md §6), gates (a)-(d) measured.
    `overrides`: (logical axis, mesh axis) pairs on the profile's rules
    (`--depth-witness`)."""
    import torch
    from repro_torch import kernels as K_
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import steps as TS
    from repro_torch.launch.taps import Taps, serve
    from repro_torch.models import lm
    from repro_torch.models.common import DTYPES, tree_items
    from repro_torch.sharding.axes import (local_part, resolve_rules,
                                           shard_index, shard_lm)
    cfg = lm_mesh_cfg(arch, layers, overrides)
    rc = RunConfig(sharding_profile=profile, param_dtype=dt,
                   activation_dtype=dt)
    dtype = DTYPES[dt]
    rules = resolve_rules(cfg, profile)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    gen = torch.Generator(device="cpu").manual_seed(LM_MESH_SEED + S)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    tol = LM_MESH_F32_TOL if dt == "float32" else LM_MESH_BF16_TOL
    ref = lm.init_lm(cfg, rc, seed=LM_MESH_SEED, device=dev)
    c_ref = lm.alloc_caches(cfg, B, cap, dtype, dev)
    # the one-device run feeds its own greedy tokens, the mesh run those
    with Taps(on_layer=lambda i, h, y: (h, y)) as r_seen:
        r_toks, _, r_pre, r_dec = serve(
            ref, c_ref, tokens, TS.make_prefill_step(cfg, rc),
            TS.make_decode_step(cfg, rc), LM_MESH_STEPS, sync=sync)
    r_logits = r_seen.logits
    del ref
    free_card() if dev.type == "cuda" else None
    model = shard_lm(lm.init_lm(cfg, rc, seed=LM_MESH_SEED, device=dev),
                     rules, mesh)
    free_card() if dev.type == "cuda" else None
    res = {"logits": [], "caches": {}, "tokens_differ": 0,
           "tokens_compared": 0}
    prefill = TS.make_prefill_step(cfg, rc, mesh)
    decode = TS.make_decode_step(cfg, rc, mesh)
    caches = lm.alloc_caches(cfg, B, cap, dtype, dev, mesh=mesh,
                             rules=rules)
    torch.distributed.barrier()
    K_.reset_launch_counts()
    layer_tol = LM_MESH_LAYER_TOL if dt == "float32" else tol

    def on_layer(i, h, y):            # this rank's shard against the slice
        return lm_mesh_compare(y.to_local(), local_part(
            r_seen.layers[i][1], y.placements, mesh), layer_tol, h.to_local())

    with Taps(mesh, feed=[h for h, _ in r_seen.layers],
              on_layer=on_layer) as seen:
        m_toks, m_caches, m_pre, m_dec = serve(
            model, caches, tokens, prefill, decode, LM_MESH_STEPS,
            r_toks[:-1], sync)
    launches = K_.launch_counts()
    routes = K_.route_counts()
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention as dop
    lse_launches = dop.lse_launches
    # (a) each layer, the logits, tokens and caches of the tapped run,
    # each rank's shard against its slice of the one-device run's
    res["layers"] = seen.layers
    for got, want in zip(seen.logits, r_logits):
        res["logits"].append(lm_mesh_compare(
            got.to_local(), local_part(want, got.placements, mesh), tol))
    for i, (g, w) in enumerate(zip(m_toks, r_toks)):
        top = torch.topk(r_logits[i][:, -1].float(), 2, dim=-1).values
        ok = (top[:, 0] - top[:, 1]) > 2 * tol * (1 + top[:, 0].abs())
        res["tokens_compared"] += int(ok.sum())
        res["tokens_differ"] += int((g != w)[ok].sum())
    ref_leaves = dict(tree_items(c_ref))
    for path, a in tree_items(m_caches["layers"]):
        res["caches"]["/".join(path)] = lm_mesh_compare(
            a.to_local(), local_part(ref_leaves[path], a.placements, mesh),
            tol)
    # where the attention caches shard kv_seq
    first = next(a for p, a in tree_items(m_caches["layers"])
                 if p[-1] == "k")
    res["cache_placements"] = str(first.placements)
    si, sn = shard_index(first.placements, mesh, 2)
    # (b) the (o, lse) form against its twin on this rank's shards
    if seen.decode_call is not None:
        res["twin"] = lm_mesh_twin_check(seen.decode_call, si, sn, dtype)
    # (c) launches; (d) the merge's wire bytes against the closed form
    from repro_torch.launch.comm_stats import total_collective_bytes
    kinds = lm.layer_kinds(cfg)
    G = cfg.num_layers // len(kinds)
    n_attn = G * sum(k.mixer == "attn" for k in kinds)
    n_ssd = G * sum(k.mixer == "ssd" for k in kinds)
    res["launches"] = {"flash": launches["flash_attention"],
                       "decode": launches["decode_attention"],
                       "decode_lse": lse_launches,
                       "ssd_scan": launches["ssd_scan"],
                       "routes": routes, "all": launches,
                       "want": {"flash": n_attn,
                                "decode": n_attn * LM_MESH_STEPS,
                                "ssd_scan": n_ssd}}
    wire = want = 0
    dm = mesh.device_mesh
    seq_dims = [i for i, p in enumerate(first.placements)
                if getattr(p, "dim", None) == 2 and dm.size(i) > 1]
    H, hd = cfg.num_heads, cfg.head_dim
    for o_shape, records in seen.merge:
        wire += total_collective_bytes(records)
        Bl = o_shape[0]
        want += sum(2 * (dm.size(i) - 1) / dm.size(i) *
                    (Bl * H * 4 + Bl * H * (hd + 1) * 4) for i in seq_dims)
    res["wire"], res["wire_want"] = wire, int(want)
    res["merges"] = len(seen.merge)
    res.update(pre_ms=m_pre, dec_ms=statistics.median(m_dec),
               ref_pre_ms=r_pre, ref_dec_ms=statistics.median(r_dec))
    if rank == 0:       # as it ends, in case a later case stops the phase
        log(f"phase 18 {name} {dt} {mesh.shape} rank 0: layers max_err "
            f"{max(l[0] for l in res['layers']):.3g}, logits max_err "
            f"{max(l[0] for l in res['logits']):.3g}, caches max_err "
            f"{max(v[0] for v in res['caches'].values()):.3g}, tokens "
            f"differ {res['tokens_differ']}, launches "
            f"{ {k: res['launches'][k] for k in LM_MESH_OPS} },"
            f" wire {wire} ({int(want)}), prefill {m_pre:.1f} ms, decode "
            f"{res['dec_ms']:.1f} ms a step")
    del model, caches, m_caches, c_ref, seen, r_seen, r_logits
    return res


def lm_mesh_rank(rank, world, dev_type, reduced):
    """One rank of phase 18: every case on each host mesh over the 4
    ranks sharing device 0, CUDA all-gathers staged through the host."""
    up = time.time()
    import os
    import torch
    from repro_torch.launch.local_ranks import stage_through_host
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    staged = ()
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        staged = stage_through_host()
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    meshes = {n: make_host_mesh(model=m, device_type=dev_type)
              for n, m in LM_MESH_SHAPES.items()}
    out = {"staged": staged, "cases": {}, "up": up}
    for name, arch, dts, profile, B, S, cap, on, depth in LM_MESH_CASES:
        if reduced:
            depth, B, S, cap = "reduced", min(B, 4), min(S, 16), 24
        for dt in dts:
            layers = depth[dt] if isinstance(depth, dict) else depth
            for mname in on:
                t0 = time.perf_counter()
                r = lm_mesh_case(name, arch, dt, profile, B, S, cap,
                                 meshes[mname], layers, dev, rank)
                r["case_s"] = time.perf_counter() - t0
                out["cases"][name, dt, mname] = r
                if dev.type == "cuda":
                    free_card()
                    r["peak_gib"] = torch.cuda.max_memory_allocated() / \
                        2 ** 30
    return out


def run_lm_mesh(dev_type="cuda", reduced=False):
    """Phase 18: the LM forward on DTensors (ROADMAP.md §1 item 10e part
    2a) on 4 gloo ranks sharing the card, the serving steps with a mesh
    against the one-device steps on the card.  Returns the launches of
    each kernel summed over the cases, from rank 0."""
    from repro_torch.launch.local_ranks import run_ranks
    t0, w0 = time.perf_counter(), time.time()
    res = run_ranks(lm_mesh_rank, LM_MESH_WORLD, dev_type, reduced,
                    timeout=LM_MESH_TIMEOUT)
    log(f"phase 18: {LM_MESH_WORLD} ranks on {dev_type} in "
        f"{time.perf_counter() - t0:.1f} s (the last rank started "
        f"{max(r['up'] for r in res) - w0:.1f} s in); collectives staged "
        f"through the host: {res[0]['staged'] or 'none'}")
    totals, failed = {}, []
    for key in res[0]["cases"]:
        rs = [r["cases"][key] for r in res]
        try:
            check_lm_mesh(key, rs)
        except AssertionError as exc:
            failed.append(str(exc))
        L = rs[0]["launches"]
        counts = dict(L["all"], decode_lse=L["decode_lse"], **{
            op + "_tensor_core": L["routes"][op]["tensor_core"]
            for op in ("flash_attention", "decode_attention")})
        for op, n in counts.items():
            totals.setdefault(op, {})[" ".join(key)] = n
    if failed:
        raise AssertionError("phase 18 failed: " + " | ".join(failed))
    return totals


def check_lm_mesh(key, rs):
    """Print one (case, dtype, mesh) row and apply gates (a)-(d)."""
    name, dt, mname = key
    tag = f"phase 18 {name} {dt} {mname}"
    r0 = rs[0]
    lg = [max(l[0] for r in rs for l in [r["logits"][i]])
          for i in range(len(r0["logits"]))]
    share = max(l[1] for r in rs for l in r["logits"])
    cmax = max(v[0] for r in rs for v in r["caches"].values())
    cshare = max(v[1] for r in rs for v in r["caches"].values())
    lmax = max(v[0] for r in rs for v in r["layers"])
    lshare = max(v[1] for r in rs for v in r["layers"])
    lrel = max(v[2] for r in rs for v in r["layers"])
    lnorm = max(v[3] for r in rs for v in r["layers"])
    rel = max(max(l[2] for r in rs for l in r["logits"]),
              max(v[2] for r in rs for v in r["caches"].values()))
    log(f"{tag}: each layer fed the one-device input: {len(r0['layers'])} "
        f"layer calls, max_err {lmax:.3g} (relative {lrel:.3g}), share "
        f"outside {LM_MESH_LAYER_TOL if dt == 'float32' else LM_MESH_BF16_TOL}"
        f" {lshare:.3g}, largest ||mesh - one device|| / ||the layer's "
        f"change|| {lnorm:.3g}; "
        f"logits max_err by step {[f'{x:.3g}' for x in lg]}, share "
        f"outside {share:.3g}; caches max_err {cmax:.3g} (share "
        f"{cshare:.3g}); logits and caches largest relative {rel:.3g}; "
        f"tokens differ {sum(r['tokens_differ'] for r in rs)}"
        f" of {sum(r['tokens_compared'] for r in rs)} compared; cache "
        f"{r0['cache_placements']}; launches {r0['launches']}; merge wire "
        f"{r0['wire']} B/rank (closed form {r0['wire_want']}, "
        f"{r0['merges']} merges); twin {r0.get('twin')}; prefill ms "
        f"{[round(r['pre_ms'], 1) for r in rs]} (one device "
        f"{r0['ref_pre_ms']:.1f}), decode ms a step "
        f"{[round(r['dec_ms'], 1) for r in rs]} (one device "
        f"{r0['ref_dec_ms']:.2f}); case {r0['case_s']:.1f} s"
        + (f", peak {max(r['peak_gib'] for r in rs):.1f} GiB a rank"
           if "peak_gib" in r0 else ""))
    tol_bad = []
    if dt == "float32":
        if share or cshare:
            tol_bad.append("float32 logits or caches outside the tolerance")
        if lshare > LM_MESH_LAYER_SHARE or lrel > LAYER_F32_MAX:
            tol_bad.append("float32 layers past the phase 16 layer gate")
    elif max(share, cshare) > LM_MESH_BF16_SHARE or \
            rel > LM_MESH_BF16_MAX:
        tol_bad.append("bfloat16 share or max past the gate")
    if lnorm > LM_MESH_LAYER_NORM[dt]:
        tol_bad.append(f"{dt} layers past ||mesh - one device|| / ||the "
                       f"layer's change|| {LM_MESH_LAYER_NORM[dt]}")
    if any(r["tokens_differ"] for r in rs):
        tol_bad.append("greedy tokens differ past the margin")
    for i, r in enumerate(rs):
        L = r["launches"]
        w = L["want"]
        if (L["flash"], L["decode"], L["ssd_scan"]) != \
                (w["flash"], w["decode"], w["ssd_scan"]):
            tol_bad.append(f"rank {i} launches {L}")
        if L["decode_lse"] != L["decode"]:
            tol_bad.append(f"rank {i}: decode launches not all (o, lse)")
        if dt == "bfloat16" and name.startswith("llama") and (
                L["routes"]["flash_attention"]["tensor_core"] != w["flash"]
                or L["routes"]["decode_attention"]["tensor_core"] !=
                w["decode"]):
            tol_bad.append(f"rank {i} routes {L['routes']}")
        if r["wire"] != r["wire_want"] or not r["merges"]:
            tol_bad.append(f"rank {i} wire {r['wire']} vs {r['wire_want']}")
        if "Shard(dim=2)" not in r["cache_placements"]:
            tol_bad.append(f"rank {i}: the cache is not sharded on kv_seq")
    Tl = r0["twin"]["T_local"]
    seen_lens = {n for r in rs for n in r["twin"]["edges"]["lens"]}
    if not {0, 1, Tl - 1, Tl} <= seen_lens:
        tol_bad.append(f"gate (b) saw the local cache_len values "
                       f"{sorted(seen_lens)} only")
    if tol_bad:
        raise AssertionError(f"{tag}: " + "; ".join(tol_bad))


# the depths `--depth-witness` reads phase 18's "llama" case at
WITNESS_LAYERS = (4, 8, 16)


def depth_witness(dev):
    """Second witnesses for phase 18's depths (PERF.md §6), not gated.
    (a) The "llama" case (decode profile, B 8, prompt 512, LM_MESH_STEPS
    decode steps) at each depth of WITNESS_LAYERS, the one-device run on
    the card against the same weights and tokens on the host, each host
    layer fed the card's input and each host step the card's token, read
    as phase 18 reads the mesh: max |host - card| / (1 + |card|) of the
    logits of the prefill and of the decode steps, and the largest share
    of a step's past phase 18's tolerance.  The host is another rounding
    of the same sums and no mesh: where its readings cross phase 18's
    limits as the mesh's do, the depth moves rounding, not a fault of
    the mesh.  (b) The long profile's bfloat16 case on 2 x 2 at
    WITNESS_MESH_LAYERS layers as phase 18 runs it, and again with the
    weights' d_model kept whole on "data" (`witness_rank`).  (c) Phase
    19's readings at the depths that failed its gates (TRAIN_WITNESS),
    the host against the card (`train_witness`); (d) its llama bf16 case
    on 1 x 4 with the heads and MLP sharded and whole
    (`run_train_witness_mesh`).  (e) Phase 22's one-device steps, card
    against card and host, at each depth of TRAIN_DIST_WITNESS_LAYERS
    (`train_dist_witness`); (f) phase 22 itself, its gates reported, at
    the issue's depth of 4 layers, in float32 and with d_model whole
    (TRAIN_DIST_VARIANTS)."""
    import os

    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import steps as TS
    from repro_torch.launch.taps import Taps, serve
    from repro_torch.models import lm
    from repro_torch.models.common import DTYPES
    torch.backends.cuda.matmul.allow_tf32 = False
    name, arch, _, profile, B, S, cap, _, _ = LM_MESH_CASES[0]
    cpu = torch.device("cpu")
    for layers in WITNESS_LAYERS:
        cfg = lm_mesh_cfg(arch, layers)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.
                               Generator().manual_seed(LM_MESH_SEED + S))
        for dt in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            rc = RunConfig(sharding_profile=profile, param_dtype=dt,
                           activation_dtype=dt)
            steps = (TS.make_prefill_step(cfg, rc),
                     TS.make_decode_step(cfg, rc))
            card = lm.init_lm(cfg, rc, seed=LM_MESH_SEED, device=dev)
            with Taps(on_layer=lambda i, h, y: h.cpu()) as c_seen:
                toks, *_ = serve(card, lm.alloc_caches(
                    cfg, B, cap, DTYPES[dt], dev), tokens.to(dev), *steps,
                    LM_MESH_STEPS)
            want = [g.cpu() for g in c_seen.logits]
            host = card.to(cpu)
            del card, c_seen.logits
            free_card()
            with Taps(feed=c_seen.layers) as h_seen:
                serve(host, lm.alloc_caches(cfg, B, cap, DTYPES[dt], cpu),
                      tokens, *steps, LM_MESH_STEPS,
                      [t.cpu() for t in toks[:-1]])
            tol = LM_MESH_F32_TOL if dt == "float32" else LM_MESH_BF16_TOL
            pre = lm_mesh_compare(h_seen.logits[0], want[0], tol)
            dec = [lm_mesh_compare(g, w, tol)
                   for g, w in zip(h_seen.logits[1:], want[1:])]
            log(f"depth witness {name} {layers} layers {dt}: host against "
                f"card, each layer fed the card's input: prefill logits max "
                f"|d| / (1 + |card|) {pre[2]:.3g}, share outside {tol} "
                f"{pre[1]:.3g}; decode steps {max(d[2] for d in dec):.3g}, "
                f"share {max(d[1] for d in dec):.3g} "
                f"({time.perf_counter() - t0:.1f} s)")
            del host, h_seen, want
    from repro_torch.launch.local_ranks import run_ranks
    for overrides in ((), (("embed", None),)):
        res = run_ranks(witness_rank, LM_MESH_WORLD, overrides,
                        timeout=LM_MESH_TIMEOUT)
        log(f"depth witness llama-long bfloat16 2x2 {WITNESS_MESH_LAYERS} "
            f"layers, rule overrides {overrides or 'none'}: decode logits "
            f"share outside {LM_MESH_BF16_TOL} "
            f"{max(r[0] for r in res):.3g}, max |d| / (1 + |x|) "
            f"{max(r[1] for r in res):.3g}, caches max_err "
            f"{max(r[2] for r in res):.3g}")
    torch.set_num_threads(os.cpu_count() or 1)
    for case in TRAIN_WITNESS:
        train_witness(dev, *case)
        free_card()
    run_train_witness_mesh()
    for layers in TRAIN_DIST_WITNESS_LAYERS:
        train_dist_witness(dev, layers)
    from repro_torch.kernels import build
    build.build()                   # the coordinator's kernels
    for variant in TRAIN_DIST_VARIANTS:
        try:
            run_train_dist(dev, variant)
        except AssertionError as exc:         # a witness reads, not gates
            log(f"depth witness phase 22 variant {variant}: {exc}")


def run_train_witness_mesh():
    """`--depth-witness` (d): read as phase 19 reads the mesh, its gates
    reported, not applied."""
    import tempfile

    from repro_torch.launch.local_ranks import run_ranks
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(train_witness_rank, TRAIN_MESH_WORLD, tmp,
                        timeout=TRAIN_MESH_TIMEOUT)
    group, _, dt, layers = TRAIN_WITNESS_MESH[:4]
    for i, o in enumerate(TRAIN_WITNESS_OVERRIDES):
        tag = (f"depth witness mesh {group} {dt} 1x4 {layers} layers, rule "
               f"overrides {o or 'none'}")
        try:
            check_train_mesh((group, dt, "1x4"), [r[i] for r in res], tag)
        except AssertionError as exc:         # a witness reads, not gates
            log(f"{tag}: past phase 19's gates: {exc}")


# `--depth-witness` (b)'s depth
WITNESS_MESH_LAYERS = 4


def witness_rank(rank, world, overrides):
    """`--depth-witness` (b) on one rank: phase 18's long-profile case in
    bfloat16 on 2 x 2 at WITNESS_MESH_LAYERS layers, with `overrides` on
    its sharding rules.  ("embed", None) keeps the weights' d_model whole
    on "data", so no projection sums bf16-rounded partial sums over it.
    Returns the logits' largest share outside the tolerance, their
    largest |d| / (1 + |x|), and the caches' largest error."""
    import os
    import torch
    from repro_torch.launch.local_ranks import stage_through_host
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    stage_through_host()
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    name, arch, _, profile, B, S, cap, _, _ = LM_MESH_CASES[1]
    mesh = make_host_mesh(model=LM_MESH_SHAPES["2x2"], device_type="cuda")
    r = lm_mesh_case(name, arch, "bfloat16", profile, B, S, cap, mesh,
                     WITNESS_MESH_LAYERS, torch.device("cuda", 0), rank,
                     overrides)
    return (max(l[1] for l in r["logits"]), max(l[2] for l in r["logits"]),
            max(v[0] for v in r["caches"].values()))


# `--depth-witness` (c): phase 19's readings at the depths that failed
# its gates on the mesh (PERF.md §6, PR 30): (group, arch, dtype,
# layers, B, S, microbatches, steps), as TRAIN_MESH_CASES runs them
TRAIN_WITNESS = (
    ("llama", "llama3.2-1b", "bfloat16", 4, 8, 256, 2, 2),
    ("llama", "llama3.2-1b", "bfloat16", 6, 8, 256, 2, 2),
    ("seamless", "seamless-m4t-medium", "float32", 2, 8, 256, 2, 1),
)


def train_param_past(got, want, dt, lr):
    """(parameters past phase 19's limit, their count, max |got - want|)
    of one leaf: float32 past TRAIN_MESH_PARAM_TOL, bfloat16 past 6 (lr +
    one bf16 rounding of the one-device value)."""
    d = (got.float() - want.float()).abs()
    lim = TRAIN_MESH_PARAM_TOL if dt == "float32" else \
        6 * (lr + 2 ** -8 * want.float().abs())
    return int((d > lim).sum()), d.numel(), d.max().item()


# `--depth-witness` (d): phase 19's llama bf16 case on 1 x 4 at the
# depth that failed its grad_norm gate, on the mesh with phase 19's rules
# and with each layer's heads and MLP whole on every rank
TRAIN_WITNESS_MESH = ("llama", "llama3.2-1b", "bfloat16", 4, 8, 256, 2, 2)
TRAIN_WITNESS_OVERRIDES = (
    (), (("heads", None), ("kv_heads", None), ("mlp", None)))


def train_witness_rank(rank, world, tmp):
    """`--depth-witness` (d) on one rank: rank 0 makes phase 19's
    one-device reference of TRAIN_WITNESS_MESH, then the 1 x 4 mesh runs
    it under each rule override of TRAIN_WITNESS_OVERRIDES, fed the
    reference's layer taps as phase 19 feeds them.  With the heads and
    the MLP whole, no layer sums bf16-rounded partial products over
    "model" (the vocabulary stays sharded)."""
    import os

    import torch
    from repro_torch.launch.local_ranks import stage_through_host
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    stage_through_host()
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device("cuda", 0)
    group, arch, dt, layers, B, S, M, steps = TRAIN_WITNESS_MESH
    mesh = make_host_mesh(model=LM_MESH_SHAPES["1x4"], device_type="cuda")
    path = os.path.join(tmp, "ref.pt")
    t0 = time.perf_counter()
    file_s = None
    if rank == 0:
        file_s = train_mesh_reference(group, arch, dt, layers, B, S, M,
                                      steps, (1, 4), dev, path)
    torch.distributed.barrier()
    ref_s = time.perf_counter() - t0
    out = []
    for o in TRAIN_WITNESS_OVERRIDES:
        t1 = time.perf_counter()
        r = train_mesh_case(group, arch, dt, layers, B, S, M, steps, mesh,
                            "1x4", dev, rank, path, o)
        r.update(ref_s=ref_s, ref_file_s=file_s,
                 mesh_s=time.perf_counter() - t1)
        r["case_s"] = r["mesh_s"]
        out.append(r)
    return out


def train_witness(dev, group, arch, dt, layers, B, S, M, steps):
    """`--depth-witness` (c), one reading: the one-device train steps of
    phase 19's reference on the card, then on the host from the same
    weights and batches, each host layer fed the card's input and the
    gradient reaching the card's output (`launch.taps.TrainTaps`), read
    as `check_train_mesh` reads the mesh: the largest relative
    difference of loss, aux and grad_norm over the steps, the gradients'
    ||host - card|| / ||card||, and the largest leaf share of the
    parameters past the limit.  The host is another rounding of the same
    sums and no mesh: readings that cross phase 19's gates as the mesh's
    did make the depth a matter of rounding."""
    import copy

    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import steps as TS
    from repro_torch.launch.taps import TrainTaps
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = lm_mesh_cfg(arch, layers)
    rc = RunConfig(param_dtype=dt, activation_dtype=dt, num_microbatches=M)
    step = TS.make_train_step(cfg, rc)
    batches = train_mesh_batches(cfg, B, S, steps, dev)
    model = train_mesh_model(cfg, rc, dev)
    host = copy.deepcopy(model).to(cpu)
    state = TS.init_train_state(model)
    with TrainTaps() as taps:
        mets = [{k: float(v) for k, v in step(state, b)[1].items()}
                for b in batches]
    to_cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    feed = (to_cpu(taps.inputs), to_cpu(taps.grads))
    grads = to_cpu(taps.updates[0])
    params = to_cpu(dict(model.named_parameters()))
    card_s = time.perf_counter() - t0
    del model, state, taps
    free_card()
    h_state = TS.init_train_state(host)
    with TrainTaps(feed=feed) as h_taps:
        h_mets = [{k: float(v) for k, v in step(
            h_state, {k: v.cpu() for k, v in b.items()})[1].items()}
            for b in batches]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30) if (a or b) else 0.0
    metric = max(rel(h[k], c[k]) for h, c in zip(h_mets, mets)
                 for k in ("loss", "aux", "grad_norm"))
    g_rel = {n: (torch.linalg.vector_norm((g.float() - grads[n].float())) /
                 torch.linalg.vector_norm(grads[n].float()).clamp_min(
                     1e-30)).item()
             for n, g in h_taps.updates[0].items()}
    worst = max(g_rel.items(), key=lambda kv: kv[1])
    past = {n: train_param_past(p.detach(), params[n], dt, rc.learning_rate)
            for n, p in host.named_parameters()}
    share = max(k / n for k, n, _ in past.values())
    log(f"depth witness {group} {dt} {layers} layers (phase 19: B {B}, S "
        f"{S}, M {M}, {steps} steps): host against card, each layer fed "
        f"the card's input and output gradient: loss "
        f"{[m['loss'] for m in h_mets]} (card {[m['loss'] for m in mets]}), "
        f"grad_norm {[m['grad_norm'] for m in h_mets]} (card "
        f"{[m['grad_norm'] for m in mets]}); largest relative metric "
        f"difference {metric:.3g} (gate {TRAIN_MESH_METRIC[dt]}); "
        f"gradients largest {worst[1]:.3g} ({worst[0]}), median "
        f"{statistics.median(g_rel.values()):.3g} (gate "
        f"{TRAIN_MESH_GRAD[dt]}); parameters past the limit "
        f"{sum(k for k, _, _ in past.values())} of "
        f"{sum(n for _, n, _ in past.values())}, largest leaf share "
        f"{share:.3g} (gate {TRAIN_MESH_PARAM_SHARE}), max |d| "
        f"{max(m for _, _, m in past.values()):.3g} (card {card_s:.1f} s, "
        f"host {time.perf_counter() - t0 - card_s:.1f} s)")
    del host, h_state, h_taps, feed
    return metric, worst[1], share


# --------------------------------------------------------------------- #
# phase 19: the train step on DTensors, the cross layers and the encoder
# on a mesh (ROADMAP.md §1 item 10e part 2c)
# --------------------------------------------------------------------- #
TRAIN_MESH_WORLD = 4
TRAIN_MESH_SEED = 29
# (group, arch, dtype, layers, B, S, microbatches, steps, meshes): the
# one-device reference of a (group, dtype) serves each of its meshes;
# llama3.2-1b at full width cut to 4 (float32) and 8 (bfloat16) of its
# 16 layers, seamless-m4t-medium at full width cut to 6 + 6 of its
# 12 + 12 layers (`with_layers` cuts both stacks), qwen2-moe-a2.7b cut
# to 2 of its 24 layers (its expert-parallel MoE at capacity 8.0, where
# nothing drops; in float32: in bfloat16 its router's gradient read
# 0.0926 apart (PERF.md §6): a sum over every token whose terms cancel,
# so bf16 rounding of the expert outputs moves it far more than any
# other weight's).  Depth only, for the script's time budget; the ZeRO-3
# gathers' closed form counts the cut model's layers.  As in phase 18,
# a shallower model reads further from the one-device run (chip readings
# on the H100, PERF.md §6: llama bf16 on 1 x 4 puts its second step's
# grad_norm 0.014 apart at 4 layers and 0.0213 at 6 against the 1e-2
# gate, 0.002 at 8; seamless's updated parameters a leaf share 0.00293
# past the limit at 2 + 2 and 0.00195 at 4 + 4 against 1e-3, 8.68e-5 at
# 6 + 6); `--depth-witness` (c) and (d) read their cause (PERF.md §6, PR
# 31): seamless's is rounding (the host against the card crosses the
# gate too), llama's the mesh's bf16 partial sums over "model" (with the
# heads and MLP whole its 1 x 4 reading falls to 7.01e-7); they keep the
# depths at which they were read
TRAIN_MESH_CASES = (
    ("llama", "llama3.2-1b", "float32", 4, 8, 256, 2, 2, ("2x2", "1x4")),
    ("llama", "llama3.2-1b", "bfloat16", 8, 8, 256, 2, 2, ("2x2", "1x4")),
    ("seamless", "seamless-m4t-medium", "float32", 6, 8, 256, 2, 1,
     ("2x2",)),
    ("qwen2-moe", "qwen2-moe-a2.7b", "float32", 2, 4, 128, 1, 1, ("1x4",)),
)
# (arch, dtype, mesh, B, prompt, capacity, decode steps): seamless serving
# on 1 x 4, frames drawn from a seed, gates drawn
TRAIN_MESH_SERVE = ("seamless-m4t-medium", "float32", "1x4", 8, 128, 136, 8)
# gates (PERF.md §6, written before the first chip run): with each
# layer fed the one-device run's input and the gradient reaching its
# output, against the one-device train step on the card from the same
# weights and batches: loss, aux and grad_norm within TRAIN_MESH_METRIC
# (relative); each parameter's gradient ||mesh - one device|| / ||one
# device|| within TRAIN_MESH_GRAD; the parameters after the steps as
# tests/test_torch_train.py holds them (a share of at most
# TRAIN_MESH_PARAM_SHARE past TRAIN_MESH_PARAM_TOL, none past 4 lr; in
# bfloat16 within 6 (lr + one bf16 rounding)); every wire-byte count equal
# to its closed form; no kernel launched by training.  Serving: logits and
# caches of each rank's shard, fed layer by layer, at most a share
# TRAIN_MESH_SERVE_SHARE outside LM_MESH_F32_TOL (1 + |x|), none past
# TRAIN_MESH_SERVE_MAX
TRAIN_MESH_METRIC = {"float32": 1e-4, "bfloat16": 1e-2}
TRAIN_MESH_GRAD = {"float32": 1e-3, "bfloat16": 5e-2}
TRAIN_MESH_PARAM_TOL = 2e-5
TRAIN_MESH_PARAM_SHARE = 1e-3
TRAIN_MESH_SERVE_SHARE = 1e-3
TRAIN_MESH_SERVE_MAX = 1e-2
TRAIN_MESH_TIMEOUT = 700.0


def train_mesh_batches(cfg, B, S, steps, dev):
    """Seeded token batches (and frames for the encoder-decoder), made on
    the CPU and moved to the card."""
    import torch
    from repro_torch.launch.serve import seeded_context
    gen = torch.Generator(device="cpu").manual_seed(TRAIN_MESH_SEED)
    out = []
    for i in range(steps):
        b = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
        b.update(seeded_context(cfg, B, S, TRAIN_MESH_SEED + i))
        out.append({k: v.to(dev) for k, v in b.items()})
    return out


def train_mesh_model(cfg, rc, dev):
    from repro_torch.launch.serve import draw_gates
    from repro_torch.models import lm
    return draw_gates(lm.init_lm(cfg, rc, seed=TRAIN_MESH_SEED, device=dev,
                                 trainable=True), TRAIN_MESH_SEED)


def train_mesh_reference(group, arch, dt, layers, B, S, M, steps, shape,
                         dev, path):
    """The one-device train steps on the card (rank 0), saved to `path`
    for every rank (four one-device states would not fit the card): the
    metrics, the first step's gradients, the parameters after the steps,
    the layer taps, step ms and peak GiB."""
    import contextlib

    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import steps as TS
    from repro_torch.launch.taps import TrainTaps, mesh_aux
    cfg = lm_mesh_cfg(arch, layers)
    rc = RunConfig(param_dtype=dt, activation_dtype=dt, num_microbatches=M)
    batches = train_mesh_batches(cfg, B, S, steps, dev)
    model = train_mesh_model(cfg, rc, dev)
    state = TS.init_train_state(model)
    step = TS.make_train_step(cfg, rc)
    torch.cuda.reset_peak_memory_stats()
    aux = mesh_aux(*shape) if cfg.moe_num_experts else contextlib.nullcontext()
    mets, ms = [], []
    with aux, TrainTaps() as taps:
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mets.append({k: float(v) for k, v in step(state, b)[1].items()})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    torch.save({"metrics": mets, "grads": cpu(taps.updates[0]),
                "params": cpu(dict(model.named_parameters())),
                "feed": (cpu(taps.inputs), cpu(taps.grads)), "ms": ms,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30},
               path)
    file_s = time.perf_counter() - t0
    del model, state, taps
    free_card()
    return file_s


def gather_wire_want(cfg, rc, mesh, calls):
    """The closed form of ZeRO-3's gathers: each weight of a layer stored
    sharded over "data" all-gathered to its use placements, its result
    the use placements' local bytes, (n - 1) / n of it on the wire, per
    layer call."""
    from repro_torch.models import lm
    from repro_torch.models.common import DTYPES, tree_items
    from repro_torch.sharding.axes import (logical_to_spec, resolve_rules,
                                           use_rules)
    rules = resolve_rules(cfg, rc.sharding_profile)
    n = mesh.shape["data"]
    if n == 1:
        return 0
    kinds = lm.layer_kinds(cfg)
    total = 0
    for i in range(cfg.num_layers):
        for _, p in tree_items(lm.block_params(cfg, kinds[i % len(kinds)],
                                               DTYPES[rc.param_dtype])):
            store = logical_to_spec(p.axes, p.shape, rules, mesh)
            use = logical_to_spec(p.axes, p.shape, use_rules(rules), mesh)
            if "data" not in store or "data" in use:
                continue
            b = math.prod(p.shape) * p.dtype.itemsize
            for spec in use:
                for a in (spec if isinstance(spec, tuple) else (spec,)):
                    b //= mesh.shape[a] if a else 1
            total += b * (n - 1) // n
    return total * calls


def train_mesh_case(group, arch, dt, layers, B, S, M, steps, mesh, mname,
                    dev, rank, path, overrides=()):
    """One case on one mesh, on this rank: the mesh's train steps fed the
    one-device reference's layer taps, compared shard by shard
    (`overrides` on the sharding rules: `--depth-witness` (d))."""
    import torch
    from repro_torch import kernels as K_
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import steps as TS
    from repro_torch.launch.comm_stats import total_collective_bytes
    from repro_torch.launch.taps import TrainTaps
    from repro_torch.sharding.axes import local_part, resolve_rules, shard_lm
    laps = [time.perf_counter()]
    cfg = lm_mesh_cfg(arch, layers, overrides)
    rc = RunConfig(param_dtype=dt, activation_dtype=dt, num_microbatches=M,
                   zero3_at_use=True)
    ref = torch.load(path, mmap=True, weights_only=False)
    batches = train_mesh_batches(cfg, B, S, steps, dev)
    laps.append(time.perf_counter())
    model = shard_lm(train_mesh_model(cfg, rc, dev),
                     resolve_rules(cfg, rc.sharding_profile), mesh)
    free_card()
    state = TS.init_train_state(model)
    step = TS.make_train_step(cfg, rc, mesh)
    laps.append(time.perf_counter())
    torch.distributed.barrier()
    laps.append(time.perf_counter())
    torch.cuda.reset_peak_memory_stats()
    K_.reset_launch_counts()
    mets, ms = [], []
    with TrainTaps(mesh, feed=ref["feed"]) as taps:
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mets.append({k: float(v) for k, v in step(state, b)[1].items()})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = K_.launch_counts()
    laps.append(time.perf_counter())
    lr = rc.learning_rate
    res = {"metrics": mets, "ref_metrics": ref["metrics"], "ms": ms,
           "ref_ms": ref["ms"], "ref_peak_gib": ref["peak_gib"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": {k: launches[k] for k in ("flash_attention",
                                                 "decode_attention",
                                                 "ssd_scan")},
           "grads": {}, "params": {}}
    params = dict(model.named_parameters())
    dm = mesh.device_mesh
    for n, p in params.items():
        reps = math.prod(dm.size(i) for i, q in enumerate(p.placements)
                         if not q.is_shard())
        g = taps.updates[0][n].to_local().float()
        w = local_part(ref["grads"][n], p.placements, mesh).to(dev).float()
        res["grads"][n] = (((g - w) ** 2).sum().item() / reps,
                           (w ** 2).sum().item() / reps)
        got = p.detach().to_local().float()
        want = local_part(ref["params"][n], p.placements, mesh).to(
            dev).float()
        d = (got - want).abs()
        if dt == "float32":
            past = int((d > TRAIN_MESH_PARAM_TOL).sum())
            bound = 4 * lr
        else:
            past = int((d > 6 * (lr + 2 ** -8 * want.abs())).sum())
            bound = float("inf")
        res["params"][n] = (past, d.numel(), d.max().item(), bound)
    # wire bytes: the gathers, the cross entropy, the norm, the reductions
    wire = {k: sum(total_collective_bytes(r) for r in v)
            for k, v in taps.collectives.items()}
    calls = 2 * M * steps                      # forward and the recompute
    dn = mesh.shape["data"]
    vn = mesh.shape["model"]
    Bm = B // M
    b_n = dn if Bm % dn == 0 else 1
    rows = Bm // b_n * S * 4
    xent = (3 * 2 * (vn - 1) / vn * rows if vn > 1 else 0) + \
        (2 * (b_n - 1) / b_n * 4 if b_n > 1 else 0)
    norm = sum(2 * (k - 1) / k * 4 for k in (dn, vn) if k > 1)
    res["wire"] = wire
    res["wire_want"] = {"gather": gather_wire_want(cfg, rc, mesh, calls),
                        "xent": int(xent) * M * steps,
                        "norm": int(norm) * steps}
    res["counts"] = {k: len(v) for k, v in taps.collectives.items()}
    laps.append(time.perf_counter())
    res["laps"] = [round(b - a, 1) for a, b in zip(laps, laps[1:])]
    if rank == 0:
        log(f"phase 19 train {group} {dt} {mname} rank 0: loss "
            f"{[m['loss'] for m in mets]} (one device "
            f"{[m['loss'] for m in ref['metrics']]}), grad_norm "
            f"{[m['grad_norm'] for m in mets]} (one device "
            f"{[m['grad_norm'] for m in ref['metrics']]}), step ms "
            f"{[round(x, 1) for x in ms]}, wire {wire}")
    del model, state, taps, ref
    free_card()
    return res


def serve_mesh_case(arch, dt, mname, B, P, cap, steps, mesh, dev, rank,
                    layers=None):
    """Seamless serving on the mesh: a prefill of seeded frames and decode
    steps, each layer (encoder and decoder) fed the one-device run's
    input, each rank's shard of the logits and caches against the
    one-device run on the card; the kernels' launches and routes, the
    merge's wire bytes, and the first cross decode call on the rank's
    heads."""
    import torch
    from repro_torch import kernels as K_
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import steps as TS
    from repro_torch.launch.comm_stats import total_collective_bytes
    from repro_torch.launch.serve import draw_gates, seeded_context
    from repro_torch.launch.taps import Taps, TrainTaps, serve
    from repro_torch.models import lm
    from repro_torch.models.common import DTYPES, tree_items
    from repro_torch.sharding.axes import local_part, resolve_rules, shard_lm
    cfg = lm_mesh_cfg(arch, layers)
    rc = RunConfig(sharding_profile="decode", param_dtype=dt,
                   activation_dtype=dt)
    dtype = DTYPES[dt]
    rules = resolve_rules(cfg, "decode")

    def sync():
        torch.cuda.synchronize()

    gen = torch.Generator(device="cpu").manual_seed(TRAIN_MESH_SEED + P)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen).to(dev)
    ctx = {k: v.to(dev) for k, v in seeded_context(
        cfg, B, P, TRAIN_MESH_SEED, dtype).items()}

    def model_on(mesh=None):
        m = draw_gates(lm.init_lm(cfg, rc, seed=TRAIN_MESH_SEED, device=dev),
                       TRAIN_MESH_SEED)
        return shard_lm(m, rules, mesh) if mesh is not None else m

    ref = model_on()
    c_ref = lm.alloc_caches(cfg, B, cap, dtype, dev)
    with Taps() as r_seen, TrainTaps() as r_taps:
        r_toks, _, r_pre, r_dec = serve(
            ref, c_ref, tokens, TS.make_prefill_step(cfg, rc),
            TS.make_decode_step(cfg, rc), steps, sync=sync, context=ctx)
    del ref
    free_card()
    model = model_on(mesh)
    free_card()
    caches = lm.alloc_caches(cfg, B, cap, dtype, dev, mesh=mesh, rules=rules)
    torch.distributed.barrier()
    K_.reset_launch_counts()
    with Taps(mesh) as seen, TrainTaps(mesh, feed=(r_taps.inputs, {})):
        m_toks, m_caches, m_pre, m_dec = serve(
            model, caches, tokens, TS.make_prefill_step(cfg, rc, mesh),
            TS.make_decode_step(cfg, rc, mesh), steps, r_toks[:-1], sync,
            context=ctx)
    launches = K_.launch_counts()
    routes = K_.route_counts()
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention as dop
    res = {"logits": [lm_mesh_compare(g.to_local(), local_part(
        w, g.placements, mesh), LM_MESH_F32_TOL)
        for g, w in zip(seen.logits, r_seen.logits)], "caches": {}}
    ref_leaves = dict(tree_items(c_ref))
    for path_, a in tree_items(m_caches["layers"]):
        res["caches"]["/".join(path_)] = lm_mesh_compare(
            a.to_local(), local_part(ref_leaves[path_], a.placements, mesh),
            LM_MESH_F32_TOL) + (str(a.placements),)
    kinds = lm.layer_kinds(cfg)
    G = cfg.num_layers // len(kinds)
    n_attn = G * sum(k.mixer == "attn" for k in kinds)
    n_cross = G * sum(k.cross for k in kinds)
    res["launches"] = {"flash": launches["flash_attention"],
                       "decode": launches["decode_attention"],
                       "decode_lse": dop.lse_launches, "routes": routes,
                       "want": {"flash": n_attn,
                                "decode_lse": n_attn * steps,
                                "decode": (n_attn + n_cross) * steps}}
    res["cross_calls"] = [d for d in seen.decode if not d[2]][:1]
    # the cross decode on the rank's heads of a cache sharded on its KV
    # heads: H / model query heads against KV / model cache heads
    n = mesh.shape["model"] if cfg.num_kv_heads % mesh.shape["model"] == 0 \
        else 1
    res["cross_ok"] = bool(res["cross_calls"]) and all(
        q[2] == cfg.num_heads // n and k[2] == cfg.num_kv_heads // n and
        k[1] == cap for q, k, _ in res["cross_calls"])
    dm = mesh.device_mesh
    first = next(a for p_, a in tree_items(m_caches["layers"])
                 if p_[-2:] == ("self", "k"))
    seq_dims = [i for i, p in enumerate(first.placements)
                if getattr(p, "dim", None) == 2 and dm.size(i) > 1]
    H, hd = cfg.num_heads, cfg.head_dim
    wire = want = 0
    for o_shape, records in seen.merge:
        wire += total_collective_bytes(records)
        want += sum(2 * (dm.size(i) - 1) / dm.size(i) *
                    (o_shape[0] * H * 4 + o_shape[0] * H * (hd + 1) * 4)
                    for i in seq_dims)
    res.update(wire=wire, wire_want=int(want), merges=len(seen.merge),
               pre_ms=m_pre, dec_ms=statistics.median(m_dec),
               ref_pre_ms=r_pre, ref_dec_ms=statistics.median(r_dec),
               tokens_equal=all(torch.equal(a, b)
                                for a, b in zip(m_toks, r_toks)))
    if rank == 0:
        log(f"phase 19 serve {arch} {dt} {mname} rank 0: logits max_err "
            f"{max(l[0] for l in res['logits']):.3g}, caches max_err "
            f"{max(v[0] for v in res['caches'].values()):.3g}, launches "
            f"{ {k: v for k, v in res['launches'].items() if k != 'routes'} }"
            f", wire {wire} ({int(want)})")
    del model, caches, m_caches, c_ref, seen, r_seen, r_taps
    free_card()
    return res


def train_mesh_rank(rank, world, dev_type, reduced, tmp):
    """One rank of phase 19: per (group, dtype) rank 0 makes the
    one-device reference while the others wait, then every mesh case of
    it; then seamless serving on 1 x 4."""
    up = time.time()
    import os

    import torch
    from repro_torch.launch.local_ranks import stage_through_host
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    staged = ()
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        staged = stage_through_host()
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    meshes = {n: make_host_mesh(model=m, device_type=dev_type)
              for n, m in LM_MESH_SHAPES.items()}
    out = {"staged": staged, "train": {}, "serve": {}, "up": up}
    for i, (group, arch, dt, layers, B, S, M, steps, on) in enumerate(
            TRAIN_MESH_CASES):
        if reduced:
            layers, S = "reduced", 24
            B = 4
        path = os.path.join(tmp, f"ref{i}.pt")
        shape = (meshes[on[0]].shape["data"], meshes[on[0]].shape["model"])
        t0 = time.perf_counter()
        file_s = None
        if rank == 0:
            file_s = train_mesh_reference(group, arch, dt, layers, B, S, M,
                                          steps, shape, dev, path)
        torch.distributed.barrier()
        ref_s = time.perf_counter() - t0
        for mname in on:
            t1 = time.perf_counter()
            r = train_mesh_case(group, arch, dt, layers, B, S, M, steps,
                                meshes[mname], mname, dev, rank, path)
            r["case_s"] = time.perf_counter() - t0
            r["ref_s"], r["ref_file_s"] = ref_s, file_s
            r["mesh_s"] = time.perf_counter() - t1
            out["train"][group, dt, mname] = r
            t0 = time.perf_counter()
        torch.distributed.barrier()
        if rank == 0:
            os.remove(path)
    arch, dt, mname, B, P, cap, steps = TRAIN_MESH_SERVE
    if reduced:       # 2 x 2: the reduced model's 2 KV heads divide there
        mname, B, P, cap = "2x2", 4, 16, 24
    t0 = time.perf_counter()
    r = serve_mesh_case(arch, dt, mname, B, P, cap, steps, meshes[mname], dev,
                        rank, "reduced" if reduced else None)
    r["case_s"] = time.perf_counter() - t0
    out["serve"][arch, dt, mname] = r
    return out


def run_train_mesh(dev_type="cuda", reduced=False):
    """Phase 19: the train step on DTensors and seamless serving on a
    mesh (ROADMAP.md §1 item 10e part 2c) on 4 gloo ranks sharing the
    card.  Returns the serve case's launches from rank 0."""
    import tempfile

    from repro_torch.launch.local_ranks import run_ranks
    t0, w0 = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(train_mesh_rank, TRAIN_MESH_WORLD, dev_type, reduced,
                        tmp, timeout=TRAIN_MESH_TIMEOUT)
    log(f"phase 19: {TRAIN_MESH_WORLD} ranks on {dev_type} in "
        f"{time.perf_counter() - t0:.1f} s (the last rank started "
        f"{max(r['up'] for r in res) - w0:.1f} s in); collectives staged "
        f"through the host: {res[0]['staged'] or 'none'}")
    failed = []
    for key in res[0]["train"]:
        try:
            check_train_mesh(key, [r["train"][key] for r in res])
        except AssertionError as exc:
            failed.append(str(exc))
    for key in res[0]["serve"]:
        try:
            check_serve_mesh(key, [r["serve"][key] for r in res])
        except AssertionError as exc:
            failed.append(str(exc))
    if failed:
        raise AssertionError("phase 19 failed: " + " | ".join(failed))
    return {k: v["launches"] for k, v in res[0]["serve"].items()}


def check_train_mesh(key, rs, tag=None):
    """Print one train case and apply its gates."""
    group, dt, mname = key
    tag = tag or f"phase 19 train {group} {dt} {mname}"
    r0 = rs[0]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    metric = max(rel(m[k], w[k]) if (m[k] or w[k]) else 0.0
                 for r in rs for m, w in zip(r["metrics"], r["ref_metrics"])
                 for k in ("loss", "aux", "grad_norm"))
    norms_equal = len({tuple(m["grad_norm"] for m in r["metrics"])
                       for r in rs}) == 1
    grads = {}
    for n in r0["grads"]:
        d2 = sum(r["grads"][n][0] for r in rs)
        w2 = sum(r["grads"][n][1] for r in rs)
        grads[n] = math.sqrt(d2) / max(math.sqrt(w2), 1e-30)
    worst = sorted(grads.items(), key=lambda kv: -kv[1])[:3]
    past = sum(r["params"][n][0] for r in rs for n in r0["params"])
    elems = sum(r["params"][n][1] for r in rs for n in r0["params"])
    pmax = max(r["params"][n][2] for r in rs for n in r0["params"])
    leaf_share = max(sum(r["params"][n][0] for r in rs) /
                     sum(r["params"][n][1] for r in rs)
                     for n in r0["params"])
    bound = r0["params"][next(iter(r0["params"]))][3]
    log(f"{tag}: loss {[m['loss'] for m in r0['metrics']]} (one device "
        f"{[m['loss'] for m in r0['ref_metrics']]}), aux "
        f"{[m['aux'] for m in r0['metrics']]} "
        f"({[m['aux'] for m in r0['ref_metrics']]}), grad_norm "
        f"{[m['grad_norm'] for m in r0['metrics']]} "
        f"({[m['grad_norm'] for m in r0['ref_metrics']]}); largest relative "
        f"metric difference {metric:.3g}; grad_norm equal on every rank "
        f"{norms_equal}; gradients ||mesh - one device|| / ||one device||: "
        f"largest {worst[0][1]:.3g} ({', '.join(f'{n} {v:.3g}' for n, v in worst)}), "
        f"median {statistics.median(grads.values()):.3g}; parameters past "
        f"the limit {past} of {elems} (largest leaf share {leaf_share:.3g}), "
        f"max |mesh - one device| {pmax:.3g}; wire B/rank {r0['wire']} "
        f"(closed form {r0['wire_want']}), collective calls {r0['counts']}; "
        f"kernel launches {r0['launches']}; step ms "
        f"{[[round(x, 1) for x in r['ms']] for r in rs]} (one device "
        f"{[round(x, 1) for x in r0['ref_ms']]}); peak "
        f"{max(r['peak_gib'] for r in rs):.1f} GiB a rank (one device "
        f"{r0['ref_peak_gib']:.1f}); case {r0['case_s']:.1f} s (the "
        f"one-device reference and its file {r0['ref_s']:.1f} s, writing "
        f"the file {r0['ref_file_s']:.1f} s; this mesh "
        f"{r0['mesh_s']:.1f} s: load, build, barrier, steps, compare "
        f"{[r['laps'] for r in rs]})")
    bad = []
    if metric > TRAIN_MESH_METRIC[dt]:
        bad.append(f"loss, aux or grad_norm {metric:.3g} apart")
    if not norms_equal:
        bad.append("the ranks' grad_norms differ")
    if worst[0][1] > TRAIN_MESH_GRAD[dt]:
        bad.append(f"gradient {worst[0][0]} {worst[0][1]:.3g} apart")
    if leaf_share > TRAIN_MESH_PARAM_SHARE or pmax > bound:
        bad.append(f"parameters: leaf share {leaf_share:.3g}, max {pmax:.3g}")
    for r in rs:
        for k in ("gather", "xent", "norm"):
            if r["wire"][k] != r["wire_want"][k]:
                bad.append(f"{k} wire {r['wire'][k]} vs {r['wire_want'][k]}")
        if any(r["launches"].values()):
            bad.append(f"training launched kernels {r['launches']}")
    if mname == "2x2" and not r0["wire"]["gather"]:
        bad.append("no ZeRO-3 gather")
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(sorted(set(bad))))


def check_serve_mesh(key, rs):
    arch, dt, mname = key
    tag = f"phase 19 serve {arch} {dt} {mname}"
    r0 = rs[0]
    lg = [max(r["logits"][i][0] for r in rs)
          for i in range(len(r0["logits"]))]
    share = max(max(l[1] for r in rs for l in r["logits"]),
                max(v[1] for r in rs for v in r["caches"].values()))
    rel = max(max(l[2] for r in rs for l in r["logits"]),
              max(v[2] for r in rs for v in r["caches"].values()))
    xk = {n: v for n, v in r0["caches"].items() if "/cross/k" in n}
    log(f"{tag}: each layer fed the one-device input: logits max_err by "
        f"step {[f'{x:.3g}' for x in lg]}, logits and caches share outside "
        f"{LM_MESH_F32_TOL} {share:.3g}, largest relative {rel:.3g}; cross "
        f"cache {next(iter(xk.values()))[3] if xk else None}, first cross "
        f"decode call (q, k) {r0['cross_calls']}; tokens equal "
        f"{all(r['tokens_equal'] for r in rs)}; launches {r0['launches']}; "
        f"merge wire {r0['wire']} B/rank (closed form {r0['wire_want']}, "
        f"{r0['merges']} merges); prefill ms "
        f"{[round(r['pre_ms'], 1) for r in rs]} (one device "
        f"{r0['ref_pre_ms']:.1f}), decode ms a step "
        f"{[round(r['dec_ms'], 1) for r in rs]} (one device "
        f"{r0['ref_dec_ms']:.2f}); case {r0['case_s']:.1f} s")
    bad = []
    if share > TRAIN_MESH_SERVE_SHARE or rel > TRAIN_MESH_SERVE_MAX:
        bad.append(f"logits or caches: share {share:.3g}, max {rel:.3g}")
    for i, r in enumerate(rs):
        L = r["launches"]
        w = L["want"]
        if (L["flash"], L["decode"], L["decode_lse"]) != \
                (w["flash"], w["decode"], w["decode_lse"]):
            bad.append(f"rank {i} launches {L}")
        if r["wire"] != r["wire_want"] or not r["merges"]:
            bad.append(f"rank {i} wire {r['wire']} vs {r['wire_want']}")
        if not r["cross_ok"]:
            bad.append(f"rank {i} cross decode call {r['cross_calls']}")
    if not any("Shard(dim=3)" in v[3] for v in xk.values()):
        bad.append("the cross cache is not sharded on its KV heads")
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))


# phase 20: the dry run against a real run (a), and production cells (b)
DRYRUN_ARCH = "llama3.2-1b"
DRYRUN_LAYERS = 4                # of its 16, in the real run and the trace
DRYRUN_WORLD = 4                 # the 1 x 4 host mesh
DRYRUN_CAP = 528                 # the caches' capacity: 512 + 16
DRYRUN_KINDS = (("prefill", 512), ("decode", DRYRUN_CAP))   # (kind, S)
DRYRUN_B = 4
# the allocator rounds a request up to 512 bytes, and a block of more
# than 1 MiB may keep up to 1 MiB it does not split off
DRYRUN_ROUND = (512, 2 ** 20)
# the arguments plus the step's measured peak against the dry run's
# args + out + temp - alias (stated before the first run, PERF.md §6)
DRYRUN_PEAK_BAND = (0.95, 1.10)
# (b): the production cells, each with the kernel whose fake calls it
# must count (None: mamba2's decode step reaches no kernel; the scan
# runs in a prefill, so mamba2's prefill cell is added).  llama3.2-1b
# train_4k (41-62 s of host time, the longest cell; training reaches no
# kernel) is left to `python -m repro_torch.launch.dryrun --all`: with
# it the whole script took 1,120.7 s of its 1,200 on the H100
DRYRUN_CELLS = (("llama3.2-1b", "prefill_32k", False, "flash_attention"),
                ("llama3.2-1b", "decode_32k", False, "decode_attention"),
                ("llama3.2-1b", "decode_32k", True, "decode_attention"),
                ("mamba2-130m", "long_500k", False, None),
                ("mamba2-130m", "prefill_32k", False, "ssd_scan"))
DRYRUN_TIMEOUT = 600.0


def dryrun_shape(kind, S):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"phase20_{kind}", S, DRYRUN_B, kind)


def dryrun_summary(acc):
    return {k: acc[k] for k in ("collectives", "flops", "argument",
                                "output", "temp", "alias", "kernel_calls")}


def dryrun_rank(rank, world, dev_type):
    """One rank of phase 20(a): each step's inputs placed (the
    allocator's bytes before and after), a warm-up step, then the step
    under `StepCost` with the allocator's peak reset before it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.launch.local_ranks import stage_through_host
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.step_cost import storage_key, tensors
    cuda = dev_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(0)
        stage_through_host()
    mesh = make_host_mesh(model=world, device_type=dev_type)
    cfg = get_config(DRYRUN_ARCH).with_layers(DRYRUN_LAYERS)
    stats = (lambda k: torch.cuda.memory_stats()[k]) if cuda else \
        (lambda k: 0)
    out = {}
    for kind, S_len in DRYRUN_KINDS:
        shape = dryrun_shape(kind, S_len)
        runcfg = S.default_runcfg(cfg, shape)
        step = S.make_step(cfg, runcfg, kind, mesh)
        a0 = stats("allocated_bytes.all.current")
        r0 = stats("requested_bytes.all.current")
        args = D.step_inputs(cfg, runcfg, kind, shape, mesh, dev, DRYRUN_CAP)
        ts = {storage_key(t): t.untyped_storage().nbytes()
              for t in tensors(args)}
        a1 = stats("allocated_bytes.all.current")
        r1 = stats("requested_bytes.all.current")
        with torch.no_grad():      # defined tokens, positions in range
            if kind == "prefill":
                args[1]["tokens"].zero_()
            else:
                args[1]["pos"].fill_(512)
                args[2].zero_()
        step(*args)                # warm-up: workspaces, split scratch
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        m0 = stats("allocated_bytes.all.current")
        t0 = time.perf_counter()
        acc = D.measure_step(step, args)
        if cuda:
            torch.cuda.synchronize()
        res = dryrun_summary(acc)
        res.update(arg_alloc=a1 - a0, arg_requested=r1 - r0,
                   arg_round=sum(DRYRUN_ROUND[n > 2 ** 20]
                                 for n in ts.values()),
                   step_peak=stats("allocated_bytes.all.peak") - m0,
                   step_ms=(time.perf_counter() - t0) * 1e3)
        out[kind] = res
        del args, acc
        if cuda:
            free_card()
    return out


def dryrun_fake(dev_type="cuda"):
    """Phase 20(a)'s steps traced over a fake group of 4."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(DRYRUN_ARCH).with_layers(DRYRUN_LAYERS)
    out = {}
    with D.fake_group(DRYRUN_WORLD):
        mesh = make_host_mesh(model=DRYRUN_WORLD, device_type=dev_type)
        for kind, S_len in DRYRUN_KINDS:
            shape = dryrun_shape(kind, S_len)
            runcfg = S.default_runcfg(cfg, shape)
            acc, trace_s = D.trace_step(cfg, runcfg, kind, shape, mesh,
                                        dev_type, DRYRUN_CAP)
            out[kind] = dict(dryrun_summary(acc), trace_s=trace_s)
    return out


def check_dryrun(kind, fake, rs):
    """Phase 20(a)'s gates for one step: every rank against the fake
    run of rank 0 (the 1 x 4 mesh is symmetric)."""
    tag = f"phase 20(a) {DRYRUN_ARCH} {kind}"
    hbm = fake["argument"] + fake["output"] + fake["temp"] - fake["alias"]
    mib = lambda n: f"{n / 2 ** 20:.2f} MiB"
    for rank, r in enumerate(rs):
        meas = fake["argument"] + r["step_peak"]
        log(f"{tag} rank {rank}: args {fake['argument']} B dry / "
            f"{r['arg_alloc']} B allocated (requested {r['arg_requested']}, "
            f"rounding allowed {r['arg_round']}); peak {mib(meas)} "
            f"(args + the step's {mib(r['step_peak'])}) against the dry "
            f"run's {mib(hbm)} (temp {mib(fake['temp'])}, out "
            f"{mib(fake['output'])}, alias {mib(fake['alias'])}): "
            f"{meas / hbm:.4f}; flops {r['flops']:.6e} / dry "
            f"{fake['flops']:.6e}; kernel calls {r['kernel_calls']}; "
            f"step {r['step_ms']:.1f} ms (staged: not a speed)")
        if r["collectives"] != fake["collectives"]:
            raise AssertionError(f"{tag} rank {rank}: collectives "
                                 f"{r['collectives']} != dry run "
                                 f"{fake['collectives']}")
        if r["flops"] != fake["flops"]:
            raise AssertionError(f"{tag} rank {rank}: flops {r['flops']} "
                                 f"!= dry run {fake['flops']}")
        if r["kernel_calls"] != fake["kernel_calls"]:
            raise AssertionError(f"{tag} rank {rank}: kernel calls "
                                 f"{r['kernel_calls']} != dry run "
                                 f"{fake['kernel_calls']}")
        extra = r["arg_alloc"] - fake["argument"]
        if not 0 <= extra <= r["arg_round"]:
            raise AssertionError(f"{tag} rank {rank}: arguments take "
                                 f"{r['arg_alloc']} B, the dry run "
                                 f"{fake['argument']} B (rounding allowed "
                                 f"{r['arg_round']} B)")
        lo, hi = DRYRUN_PEAK_BAND
        if not lo <= meas / hbm <= hi:
            raise AssertionError(f"{tag} rank {rank}: peak {meas} B is "
                                 f"{meas / hbm:.4f} of the dry run's "
                                 f"{hbm} B, outside {DRYRUN_PEAK_BAND}")
    log(f"{tag}: collectives {fake['collectives']}")


def run_dryrun():
    """Phase 20: (a) the dry run of llama3.2-1b's prefill and decode step
    on a 1 x 4 mesh against the same steps on 4 gloo ranks sharing the
    card; (b) the production cells of DRYRUN_CELLS traced with fake CUDA
    tensors.  Returns the fake kernel calls of (b) by op."""
    import concurrent.futures as cf

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.local_ranks import run_ranks
    t0 = time.perf_counter()
    cells = [c[:3] for c in DRYRUN_CELLS]
    timed = lambda fn: (fn(), time.perf_counter() - t0)
    with cf.ThreadPoolExecutor(2) as pool:
        # (b) in worker processes, and (a)'s dry run in this process,
        # while (a)'s ranks run
        cells_b = pool.submit(lambda: list(D.run_cells(cells, "cuda",
                                                       len(cells))))
        fake_a = pool.submit(timed, dryrun_fake)
        rs = run_ranks(dryrun_rank, DRYRUN_WORLD, "cuda",
                       timeout=DRYRUN_TIMEOUT)
        t_real = time.perf_counter() - t0
        fake, t_fake = fake_a.result()
        log(f"phase 20(a): {DRYRUN_WORLD} ranks on cuda in {t_real:.1f} s, "
            f"the dry run beside them done {t_fake:.1f} s after the phase "
            f"began")
        done_b = {c[:3]: c[3:] for c in cells_b.result()}
    log(f"phase 20(b): {len(cells)} cells in {len(cells)} worker processes "
        f"beside (a), done {time.perf_counter() - t0:.1f} s after it began")
    failed = []
    for kind, _ in DRYRUN_KINDS:
        try:
            check_dryrun(kind, fake[kind], [r[kind] for r in rs])
        except AssertionError as exc:
            failed.append(str(exc))
    calls = {}
    for arch, shape, mp, kernel in DRYRUN_CELLS:
        rec, tb = done_b[arch, shape, mp]
        if tb is not None:                 # a FAIL is a result: print it
            log(tb)
            failed.append(f"phase 20(b) {arch} {shape} mp={mp}: "
                          f"{rec['error']}")
            continue
        log(f"phase 20(b) {rec['trace_s']} s " + json.dumps(rec, default=str))
        want = {kernel} if kernel else set()
        if rec["status"] != "OK" or set(rec["kernel_calls"]) != want or \
                rec["launched"]:
            failed.append(f"phase 20(b) {arch} {shape} mp={mp}: "
                          f"{rec['status']}, fake calls "
                          f"{rec.get('kernel_calls')} (want {kernel}), "
                          f"{rec['launched']} launched")
        for op, n in rec.get("kernel_calls", {}).items():
            calls[op] = calls.get(op, 0) + n
    if failed:
        raise AssertionError("phase 20 failed: " + " | ".join(failed))
    return calls


# --------------------------------------------------------------------- #
# phase 21: the frozen reference forms against the kernel pipeline
# --------------------------------------------------------------------- #
REFERENCE_EPOCHS = 3
# (b): the W = 0 spot gate's ticks, its i.i.d. kill rate, and the
# secretaries and observers leased first, so that there are spot nodes
# to kill
SPOT_GATE_TICKS = 100
SPOT_GATE_PHI = 0.01
SPOT_GATE_LEASE = (8, 24)


def reference_specs(cfg):
    """Phase 5's members without its grouped Multi-Raft shards, which
    the host pipeline refuses: BW-Raft managed at phi 0.02, Raft, and
    BW-Raft with the 550-slot digest rack (8 writes and 32 reads a
    tick, seed 0)."""
    from repro_torch.core.fleet import digest_rack_spec, system_specs
    kw = dict(write_rate=8.0, read_rate=32.0, seed=0)
    return system_specs(cfg, phi=0.02, **kw)[:2] + \
        [digest_rack_spec(cfg, **kw)]


def report_diff(a, b, ctx):
    """Hold two EpochReports (and their decisions) equal: integers and
    the metrics registry exact, floats within FLOAT_RTOL.  Returns the
    largest relative float difference."""
    import dataclasses
    worst = 0.0

    def close(x, y, name):
        nonlocal worst
        if isinstance(x, float) or isinstance(y, float):
            if x != x and y != y:
                return
            d = abs(x - y) / max(abs(y), 1e-30)
            worst = max(worst, d if x != y else 0.0)
            if not d <= FLOAT_RTOL:
                raise AssertionError(f"{ctx}: {name} {x} vs {y}")
        elif x != y:
            raise AssertionError(f"{ctx}: {name} {x} vs {y}")

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "decision":
            if (x is None) != (y is None):
                raise AssertionError(f"{ctx}: a decision on one side only")
            for k, v in (dataclasses.asdict(x) if x is not None else
                         {}).items():
                close(v, getattr(y, k), f"decision.{k}")
        else:
            close(x, y, f.name)
    return worst


def spot_gate(dev, cfg, market):
    """(b): `spot_step` at warn_ticks = 0 (no faults, the init-time bid)
    against `spot_step_reference` for SPOT_GATE_TICKS ticks from one
    leased state and one draw bundle: prices, kills and roles bit for
    bit.  Returns the kills counted."""
    import torch
    from repro_torch.core import state as SM
    from repro_torch.core import step as ST
    from repro_torch.core.draws import TorchDraws, row
    from repro_torch.core.runtime import ClusterController, make_cfg_arrays
    from repro_torch.market.synthetic import export_walk_trace
    static = SM.build_static(cfg)
    kw = {}
    if market == "trace":
        kw = dict(market="trace",
                  trace=export_walk_trace(cfg, seed=4, epochs=2, device=dev))
    cfg_c = make_cfg_arrays(cfg, dev, write_rate=8.0, read_rate=16.0,
                            phi=SPOT_GATE_PHI, **kw)
    st = SM.init_state(cfg, static, dev)
    wired = ClusterController(cfg, static, seed=0).lease(
        st["role"].cpu().numpy(), st["alive"].cpu().numpy(),
        *SPOT_GATE_LEASE)
    st = dict(st, **{k: torch.as_tensor(v, device=dev) for k, v in
                     zip(("role", "alive", "sec_of", "obs_of"), wired)})
    bundle = TorchDraws(9, dev).epoch(SPOT_GATE_TICKS, st, cfg_c)
    statics, cfg_b = SM.stack_static([static], dev), SM.batch1(cfg_c)
    new = ref = SM.batch1(st)
    kills = 0
    for t in range(SPOT_GATE_TICKS):
        d = SM.batch1(row(bundle, t))
        tick = torch.full((1,), t, dtype=torch.int32, device=dev)
        new, k_new = ST.spot_step(dict(new, tick=tick), statics, cfg_b, d)
        ref, k_ref = ST.spot_step_reference(dict(ref, tick=tick), statics,
                                            cfg_b, d)
        for name, a, b in (("price", new["spot_price"], ref["spot_price"]),
                           ("killed", k_new, k_ref),
                           ("alive", new["alive"], ref["alive"]),
                           ("role", new["role"], ref["role"])):
            if not torch.equal(a, b):
                raise AssertionError(f"phase 21(b) {market}: tick {t}: "
                                     f"{name} diverged")
        kills += int(k_new.sum())
    return kills


def run_reference(dev, cfg):
    """Phase 21: (a) `FleetSim(pipeline="host")`, the frozen reference
    path whose ticks launch no kernel, against the kernel pipeline at the
    paper's cluster, and (b) the W = 0 spot gate on the card.  Returns
    the launches of each kernel on the host pipeline."""
    import torch
    from repro_torch import kernels as K_
    from repro_torch.core.fleet import FleetSim
    runs = {}
    for pipeline in ("host", "device"):
        fleet = FleetSim(reference_specs(cfg), pipeline=pipeline, device=dev)
        torch.cuda.synchronize()
        K_.reset_launch_counts()
        wall = []
        for _ in range(REFERENCE_EPOCHS):
            t0 = time.perf_counter()
            fleet.run_epoch()          # ends in a host fetch (a sync)
            wall.append((time.perf_counter() - t0) * 1e3)
        runs[pipeline] = (fleet, K_.launch_counts())
        log(f"phase 21(a) {pipeline} pipeline, B={fleet.shapes.B}: epoch "
            f"wall ms {[round(w, 1) for w in wall]}; d2h bytes "
            f"{fleet.d2h_bytes}; launches {json.dumps(runs[pipeline][1])}")
    (host, h_counts), (device, d_counts) = runs["host"], runs["device"]
    worst, decisions = 0.0, 0
    for i, (hr, dr) in enumerate(zip(host.reports, device.reports)):
        for e, (a, b) in enumerate(zip(hr, dr)):
            check_report(a, f"phase 21(a) host epoch {e} member {i}")
            worst = max(worst, report_diff(a, b, f"phase 21(a) epoch {e} "
                                                 f"member {i}"))
            decisions += a.decision is not None
    ticks = REFERENCE_EPOCHS * cfg.period_ticks
    for name in RAFT:
        want = ticks if name in (*PER_TICK, "ae_sync") else 0
        if h_counts[name] != 0 or d_counts[name] != want:
            raise AssertionError(f"phase 21(a) {name}: {h_counts[name]} "
                                 f"launches on the host pipeline (want 0), "
                                 f"{d_counts[name]} on the device one "
                                 f"(want {want})")
    if any(h_counts.values()):
        raise AssertionError(f"the host pipeline launched {h_counts}")
    if not device.d2h_bytes < host.d2h_bytes / 100:
        raise AssertionError(f"phase 21(a) d2h bytes: device "
                             f"{device.d2h_bytes}, host {host.d2h_bytes}")
    if not decisions:
        raise AssertionError("phase 21(a) made no control-plane decision")
    log(f"phase 21(a): {len(host.reports)} members x {REFERENCE_EPOCHS} "
        f"epochs of reports equal (largest relative float difference "
        f"{worst:.3g}), {decisions} decisions equal; d2h bytes device / "
        f"host {device.d2h_bytes / host.d2h_bytes:.3g}")
    for market in ("process", "trace"):
        kills = spot_gate(dev, cfg, market)
        log(f"phase 21(b) {market} market: spot_step at W = 0 and "
            f"spot_step_reference bit-equal over {SPOT_GATE_TICKS} ticks "
            f"(prices, kills, roles); {kills} kills")
        if not kills:
            raise AssertionError(f"phase 21(b) {market}: no spot node was "
                                 f"killed, so the gate saw no kill")
    return h_counts


# --------------------------------------------------------------------- #
# phase 22: launch/train.py on the ranks that exist (the trainer on a
# mesh, checkpoints from and onto DTensor shards, one coordinator)
# --------------------------------------------------------------------- #
TRAIN_DIST_WORLD = 4
# of smollm-360m's 32 layers, at full width: the depth at which a
# rounding of the one-device step's sums moves its grad_norm least
# (`--depth-witness` (e), PERF.md §6, PR 31: the host against the card
# 0.00404 apart at 2 layers, 0.0289 at 3, 0.0442 at 4, 0.208 at 8, 0.872
# at 32; in float32 0.0478 at 4)
TRAIN_DIST_LAYERS = 2
# the trainer's own arguments: B 8, S 64, 4 steps, a checkpoint every 2,
# pod 1 failing at step 3, seed 0 (its RunConfig: bf16 weights, f32
# AdamW, no remat, one microbatch, the train profile)
TRAIN_DIST_ARGS = ["--arch", "smollm-360m", "--full", "--batch", "8",
                   "--seq", "64", "--steps", "4", "--ckpt-every", "2",
                   "--kill-at", "3", "--seed", "0"]
TRAIN_DIST_COMMITS = [2, 4]
TRAIN_DIST_MORE = 2              # steps from the restored checkpoint
# gates (PERF.md §6, PR 31): the trainer's bf16 run's losses against the
# one-device run's, the first step within phase 19's bf16 metric limit
# (relative), every later step and the steps after the restore within
# TRAIN_DIST_LATER_LOSS; the float32 steps below.  The bf16 grad_norms
# are printed,
# not gated: the (4, 1) train profile stores the weights' d_model dims
# sharded over "data", so the mesh sums bf16-rounded partial products
# over it, which this random model's gradients amplify (step 0 0.114
# apart at 2 layers; in float32 6.01e-5, with d_model whole 1.9e-4), and
# a later step's grad_norm is not fixed by its inputs on one device
# either (host against card 0.362 at 2 layers)
TRAIN_DIST_STEP0 = TRAIN_MESH_METRIC["bfloat16"]
TRAIN_DIST_LATER_LOSS = 1e-2
# what the update does, in float32 (PERF.md §6, PR 31): the trainer's
# first TRAIN_DIST_F32_STEPS steps on the mesh, each AdamW update held,
# bit for bit (TRAIN_DIST_UPDATE), to the same update run on one device
# from copies of the rank's shards before it and its gradients; the
# first step's loss and grad_norm within TRAIN_DIST_STEP0 of one
# device's.  A later step is not held to one device's: Adam's first
# update moves every element by about lr whatever its gradient's size,
# so the elements whose gradients are rounding noise (sums that cancel)
# move by a rounding's choice of sign, and the second step reads the
# float32 one-device run 0.0532 apart in grad_norm (PERF.md §6)
TRAIN_DIST_F32_STEPS = 2
TRAIN_DIST_UPDATE = 0.0
TRAIN_DIST_TIMEOUT = 300.0


# `--depth-witness` (e) and (f): phase 22's one-device depths, and its
# variants (4 layers; float32; the weights' d_model whole on "data")
TRAIN_DIST_WITNESS_LAYERS = (2, 3, 4, 8, 32)
TRAIN_DIST_VARIANTS = ({"layers": 4}, {"dtype": "float32"},
                       {"overrides": (("embed", None),)})


def train_dist_setup(variant=None):
    """(cfg, runcfg) of phase 22, or of a `--depth-witness` variant
    {"layers", "overrides" on the sharding rules, "dtype"}: the
    trainer's own RunConfig (None) unless a dtype is named."""
    from repro_torch.configs.base import RunConfig
    v = variant or {}
    cfg = lm_mesh_cfg("smollm-360m", v.get("layers", TRAIN_DIST_LAYERS),
                      v.get("overrides", ()))
    dt = v.get("dtype")
    return cfg, dt and RunConfig(remat=False, num_microbatches=1,
                                 param_dtype=dt, activation_dtype=dt)


def ckpt_files(d, step):
    """({keystr: array} of a checkpoint's files read on the host, its
    manifest)."""
    import os

    import numpy as np
    d = os.path.join(d, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for i in range(manifest["shards"]):
        with np.load(os.path.join(d, f"shard_{i}.npz")) as z:
            out.update({k: z[k] for k in z.files})
    return out, manifest


def wait_for_ckpt(d, step, timeout):
    """Until checkpoint `step` of `d` has its manifest (written last)."""
    import os
    path = os.path.join(d, f"step_{step}", "manifest.json")
    t_end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            raise AssertionError(f"phase 22: no checkpoint {path}")
        time.sleep(0.2)


def restore_on_mesh(d, step, like):
    """Checkpoint `step` of `d` restored onto the placements of the
    DTensor tree `like`: (the tree, its digest, the keys whose shard on
    this rank is not bit-equal to its slice of the stored tensor or not
    placed as `like`, the restore's ms)."""
    import torch
    from repro_torch.checkpoint.store import (CheckpointStore, _items,
                                              _to_tensor, keystr)
    from repro_torch.sharding.axes import is_dtensor, local_part
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, digest = CheckpointStore(d).restore(step, like)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    files, _ = ckpt_files(d, step)
    bad = []
    for (path, g), (_, w) in zip(_items(got), _items(like)):
        whole = _to_tensor(files[keystr(path)], "cpu")
        if is_dtensor(w):
            ok = g.placements == w.placements and \
                tuple(g.shape) == tuple(whole.shape) and torch.equal(
                    g.to_local().cpu(), local_part(whole, w.placements,
                                                   w.device_mesh))
        else:
            ok = torch.equal(g.cpu(), whole)
        if not ok:
            bad.append(keystr(path))
    return got, digest, bad, ms


def train_more(rep, tree, cfg, runcfg, dev):
    """TRAIN_DIST_MORE steps from the restored `tree`, loaded into the
    run's state, on its mesh: [(loss, grad_norm)] of each."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as TS
    from repro_torch.launch.train import parse_args
    a = parse_args(TRAIN_DIST_ARGS)
    B, S, n = a.batch, a.seq, a.steps
    step = TS.make_train_step(cfg, runcfg or RunConfig(
        remat=False, num_microbatches=1), rep.mesh)
    TS.load_state_tree(rep.state, tree)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, S, B))
    out = []
    for i in range(n, n + TRAIN_DIST_MORE):
        _, m = step(rep.state, pipe.batch_at(i, device=dev))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def train_dist_logged(coord):
    """The CKPT_COMMIT records in the leader's replicated log, as (step,
    tag)."""
    from repro_torch.coord import log_records as rec
    from repro_torch.core import state as SM
    st = coord.sim.state
    lid = int(SM.leader_id(st))
    ck = rec.record_base(coord.cfg.key_space) + int(rec.RecordType.CKPT_COMMIT)
    n = int(st["commit_len"][lid])
    keys = st["log_key"][lid, :n].cpu().numpy()
    vals = st["log_val"][lid, :n].cpu().numpy()
    return [rec.unpack_ckpt(int(v)) for v in vals[keys == ck]]


def train_dist_f32(cfg, dev, mesh):
    """The trainer's first TRAIN_DIST_F32_STEPS steps in float32 (its
    weights from `--seed` and its batches through
    `launch.steps.make_train_step` with a float32 RunConfig) on `mesh`,
    placed as the trainer places them, and on one device of the card.
    On the mesh each AdamW update is checked where it runs: the same
    `adamw_update` applied on one device to copies of this rank's local
    shards of the parameters, m and v before it and of the gradients it
    was given (clipped by the mesh's global norm) must give what the
    mesh holds after it.  Returns {"mesh", "one": [(loss, grad_norm)] a
    step, "update": the largest |mesh - reference| of each step over
    the parameters, m and v}."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.sharding.axes import is_dtensor
    a = train.parse_args(TRAIN_DIST_ARGS)
    rc = RunConfig(remat=False, num_microbatches=1, param_dtype="float32",
                   activation_dtype="float32")
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, a.seq, a.batch))
    real, out = adamw.adamw_update, {"update": []}
    loc = lambda t: (t.to_local() if is_dtensor(t) else t).detach()

    @torch.no_grad()
    def checked(params, grads, opt, **kw):
        grads = {n: grads[n].redistribute(p.device_mesh, p.placements)
                 if is_dtensor(grads[n]) else grads[n]
                 for n, p in params.items()}
        before = {n: [loc(t).clone() for t in (p, opt["m"][n], opt["v"][n])]
                  for n, p in params.items()}
        step = opt["step"].clone()
        res = real(params, grads, opt, **kw)
        clip = kw.get("grad_clip", 0.0)
        scale = torch.clamp(clip / torch.clamp(res[2]["grad_norm"], min=1e-9),
                            max=1.0) if clip else 1.0
        worst = 0.0
        for n, p in params.items():
            p0, m0, v0 = before[n]
            real({n: p0}, {n: loc(grads[n]).float() * scale},
                 {"m": {n: m0}, "v": {n: v0}, "step": step.clone()},
                 **dict(kw, grad_clip=0.0))
            for x, y in ((p0, p), (m0, opt["m"][n]), (v0, opt["v"][n])):
                worst = max(worst, float((x - loc(y)).abs().max()))
        out["update"].append(worst)
        return res

    for name, m in (("mesh", mesh), ("one", None)):
        st = train.init_state(cfg, rc, seed=a.seed, device=dev)
        if m is not None:
            st = TS.shard_state(st, cfg, rc, m)
        step = TS.make_train_step(cfg, rc, m)
        adamw.adamw_update = checked if m is not None else real
        try:
            mets = [step(st, pipe.batch_at(i, device=dev))[1]
                    for i in range(TRAIN_DIST_F32_STEPS)]
        finally:
            adamw.adamw_update = real
        out[name] = [(float(x["loss"]), float(x["grad_norm"]))
                     for x in mets]
        del st, step
    free_card()
    return out


def train_dist_rank(rank, world, mesh_dir, one_dir, dev_type="cuda",
                    variant=None):
    """One rank of phase 22: `launch.train.train` of TRAIN_DIST_ARGS on
    the (4, 1) host mesh (every rank on the card, collectives staged
    through the host), launch counts set to 0 just before and read just
    after, each save's gather timed and its collectives recorded; then
    the mesh checkpoint and the one-device run's restored onto the mesh
    and checked shard by shard, and TRAIN_DIST_MORE steps from the
    restored state."""
    up = time.time()
    import os

    import torch
    from repro_torch import kernels as K_
    from repro_torch.checkpoint import store as ST
    from repro_torch.checkpoint.store import tree_digest
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train
    from repro_torch.launch.comm_stats import (CollectiveRecorder,
                                               total_collective_bytes)
    from repro_torch.launch.local_ranks import stage_through_host
    from repro_torch.sharding.axes import is_dtensor
    dev, staged = torch.device("cpu"), ()
    if dev_type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        staged = stage_through_host()
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    cfg, runcfg = train_dist_setup(variant)
    out = {"up": up, "staged": staged, "gather_b": [], "gather_ms": []}
    whole, shard_state = ST.whole_tree, TS.shard_state

    def gathered(tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CollectiveRecorder() as rec:
            t = whole(tree)
        torch.cuda.synchronize()
        out["gather_ms"].append((time.perf_counter() - t0) * 1e3)
        out["gather_b"].append(total_collective_bytes(rec.records))
        return t

    def placed(*a, **k):
        st = shard_state(*a, **k)
        tree = TS.state_tree(st)
        out["init_digest"] = tree_digest(whole(tree))
        out["gather_want"] = sum(
            t.numel() * t.element_size() * (world - 1) // world
            for _, t in ST._items(tree)
            if is_dtensor(t) and any(p.is_shard() for p in t.placements))
        out["sharded"] = sum(is_dtensor(t) and any(
            p.is_shard() for p in t.placements) for _, t in ST._items(tree))
        return st

    ST.whole_tree, TS.shard_state = gathered, placed
    try:
        torch.cuda.reset_peak_memory_stats()
        K_.reset_launch_counts()
        t0 = time.perf_counter()
        rep = train.train(train.parse_args(
            TRAIN_DIST_ARGS + ["--ckpt-dir", mesh_dir]), cfg=cfg,
            runcfg=runcfg)
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["launches"] = K_.launch_counts()
    finally:
        ST.whole_tree, TS.shard_state = whole, shard_state
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for k in ("losses", "grad_norms", "step_ms", "save_ms", "digests",
              "membership", "commits", "commit_ticks", "commit_ms"):
        out[k] = getattr(rep, k)
    out["coordinators"] = int(rep.coord is not None)
    if rep.coord is not None:
        out["logged"] = train_dist_logged(rep.coord)
        out["last_committed"] = rep.coord.last_committed_checkpoint()
        out["ticks"] = rep.coord.ticks
    last = TRAIN_DIST_COMMITS[-1]
    like = TS.state_tree(rep.state)
    tree, digest, bad, ms = restore_on_mesh(mesh_dir, last, like)
    out["restore_mesh"] = (digest, bad, ms)
    wait_for_ckpt(one_dir, last, TRAIN_DIST_TIMEOUT)
    _, o_digest, o_bad, o_ms = restore_on_mesh(one_dir, last, like)
    out["restore_one"] = (o_digest, o_bad, o_ms)
    out["more"] = train_more(rep, tree, cfg, runcfg, dev)
    del tree, like
    out["f32"] = train_dist_f32(cfg, dev, rep.mesh)
    out["launches_after"] = K_.launch_counts()
    return out


def train_dist_witness(dev, layers):
    """`--depth-witness` (e), one depth: phase 22's train steps on one
    device (the trainer's weights from seed 0, its batches, its
    RunConfig) on the card, again on the card, and on the host from the
    same weights: (loss, grad_norm) a step of each.  How far apart a
    rerun and another rounding of the same sums read is how far the
    steps' bf16 gradients are fixed by their inputs at this depth."""
    import copy

    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train
    cfg, _ = train_dist_setup({"layers": layers})
    rc = RunConfig(remat=False, num_microbatches=1)
    a = train.parse_args(TRAIN_DIST_ARGS)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, a.seq, a.batch))
    batches = [pipe.batch_at(i, device="cpu") for i in range(a.steps)]
    step = TS.make_train_step(cfg, rc)
    t0 = time.perf_counter()
    model = train.init_state(cfg, rc, seed=a.seed, device=dev)["params"]
    host = copy.deepcopy(model).to("cpu")
    out = []
    for m, where in ((copy.deepcopy(model), dev), (model, dev),
                     (host, torch.device("cpu"))):
        st = TS.init_train_state(m)
        mets = [step(st, {k: v.to(where) for k, v in b.items()})[1]
                for b in batches]
        out.append([(float(x["loss"]), float(x["grad_norm"]))
                    for x in mets])
        del m, st
    del model, host
    free_card()

    def apart(i, k, first):
        return max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(
            out[i][:1] if first else out[i][1:],
            out[0][:1] if first else out[0][1:]))
    log(f"depth witness phase 22 one device {layers} layers, {a.steps} "
        f"steps: (loss, grad_norm) card {out[0]}, card rerun {out[1]}, "
        f"host {out[2]}; step 0 apart: rerun loss {apart(1, 0, True):.3g} "
        f"grad_norm {apart(1, 1, True):.3g}, host loss "
        f"{apart(2, 0, True):.3g} grad_norm {apart(2, 1, True):.3g} (gate "
        f"{TRAIN_DIST_STEP0}); later steps: rerun loss "
        f"{apart(1, 0, False):.3g} grad_norm {apart(1, 1, False):.3g}, "
        f"host loss {apart(2, 0, False):.3g} grad_norm "
        f"{apart(2, 1, False):.3g} (loss gate {TRAIN_DIST_LATER_LOSS}; "
        f"{time.perf_counter() - t0:.1f} s)")
    return out


def train_dist_reference(dev, one_dir, variant=None):
    """Phase 22's reference: the same `launch.train.train` on one device
    of the card (no process group), its initial digest, then
    TRAIN_DIST_MORE steps from its own last checkpoint."""
    import torch
    from repro_torch.checkpoint.store import tree_digest
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train
    cfg, runcfg = train_dist_setup(variant)
    init = {}
    init_state = train.init_state

    def recorded(*a, **k):
        st = init_state(*a, **k)
        init["digest"] = tree_digest(TS.state_tree(st))
        return st
    train.init_state = recorded
    try:
        t0 = time.perf_counter()
        rep = train.train(train.parse_args(
            TRAIN_DIST_ARGS + ["--ckpt-dir", one_dir, "--device",
                               str(dev)]), cfg=cfg, runcfg=runcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train.init_state = init_state
    last = TRAIN_DIST_COMMITS[-1]
    tree, _ = rep.store.restore(last, TS.state_tree(rep.state))
    return {"rep": rep, "init_digest": init["digest"], "wall": wall,
            "more": train_more(rep, tree, cfg, runcfg, dev)}


def run_train_dist(dev, variant=None):
    """Phase 22 (or a `--depth-witness` variant of it): `launch.train` on
    4 gloo ranks sharing the card (in a thread) and on one device of the
    card (here, meanwhile); then the gates.  Returns each kernel's
    launches by rank."""
    import tempfile
    import threading

    import torch
    from repro_torch.checkpoint.store import (CheckpointStore, _items,
                                              _to_tensor, keystr,
                                              tree_digest)
    from repro_torch.launch import steps as TS
    from repro_torch.launch.local_ranks import run_ranks
    w0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_dir, one_dir = f"{tmp}/mesh", f"{tmp}/one"
        got = {}

        def ranks():
            try:
                got["ranks"] = run_ranks(train_dist_rank, TRAIN_DIST_WORLD,
                                         mesh_dir, one_dir, dev.type,
                                         variant,
                                         timeout=TRAIN_DIST_TIMEOUT)
            except BaseException as exc:          # re-raised below
                got["error"] = exc
        th = threading.Thread(target=ranks)
        th.start()
        try:
            ref = train_dist_reference(dev, one_dir, variant)
        finally:
            th.join()
        if "error" in got:
            raise AssertionError(f"phase 22: {got['error']}")
        rs, one = got["ranks"], ref["rep"]
        r0 = rs[0]
        bad = []
        # the checkpoints on the host: layout, digests, tags
        tags = {s: int(d[:3], 16) for s, d, _ in r0["commits"]}
        one_tree = TS.state_tree(one.state)
        for s in TRAIN_DIST_COMMITS:
            mesh, man = ckpt_files(mesh_dir, s)
            ref_f, _ = ckpt_files(one_dir, s)
            if {k: (a.shape, a.dtype) for k, a in mesh.items()} != \
                    {k: (a.shape, a.dtype) for k, a in ref_f.items()}:
                bad.append(f"step {s}: keys, shapes or dtypes differ from "
                           f"the one-device checkpoint")
            del ref_f
            host = {}                 # the files as the state's tree
            for path, _ in _items(one_tree):
                node = host
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = _to_tensor(mesh[keystr(path)], "cpu")
            if not man["digest"] == tree_digest(host) or \
                    int(man["digest"][:3], 16) != tags.get(s):
                bad.append(f"step {s}: manifest {man['digest']}, read back "
                           f"{tree_digest(host)}, tag {tags.get(s)}")
            if s == TRAIN_DIST_COMMITS[-1]:
                # the mesh checkpoint restored on one device of the card
                t0 = time.perf_counter()
                on_one, digest = CheckpointStore(mesh_dir).restore(
                    s, one_tree)
                torch.cuda.synchronize()
                one_restore_ms = (time.perf_counter() - t0) * 1e3
                if digest != man["digest"]:
                    bad.append(f"one-device restore: digest {digest}")
                for (path, a), (_, b) in zip(_items(on_one), _items(host)):
                    if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                        bad.append(f"one-device restore of {keystr(path)}")
                del on_one
            del mesh, host
        del one_tree
    cfg, rc = train_dist_setup(variant)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    loss0 = max(rel(r["losses"][0], one.losses[0]) for r in rs)
    gn0 = max(rel(r["grad_norms"][0], one.grad_norms[0]) for r in rs)
    later = {k: max(rel(x, y) for r in rs for x, y in zip(
        r[ks][1:], getattr(one, ks)[1:]))
        for k, ks in (("loss", "losses"), ("grad_norm", "grad_norms"))}
    more = {k: max(rel(x[i], y[i]) for r in rs for x, y in zip(
        r["more"], ref["more"])) for i, k in enumerate(("loss", "grad_norm"))}
    f32 = [max(rel(r["f32"]["mesh"][s][i], r["f32"]["one"][s][i])
               for r in rs for i in range(2))
           for s in range(TRAIN_DIST_F32_STEPS)]
    update = [max(r["f32"]["update"][s] for r in rs)
              for s in range(TRAIN_DIST_F32_STEPS)]
    per_tick = r0["ticks"] if "ticks" in r0 else None
    step_ms = [statistics.median(r["step_ms"][1:]) for r in rs]
    log(f"phase 22 train on {TRAIN_DIST_WORLD} ranks (smollm-360m full "
        f"width, {cfg.num_layers} of 32 layers, "
        f"{rc.param_dtype if rc else 'bfloat16'}, 4 x 1"
        f"{', rule overrides ' + str(variant['overrides']) if variant and 'overrides' in variant else ''}"
        f"): losses "
        f"{r0['losses']} (one device {one.losses}), grad_norm "
        f"{r0['grad_norms']} (one device {one.grad_norms}); step 0 apart: "
        f"loss {loss0:.3g} (gate {TRAIN_DIST_STEP0}), grad_norm {gn0:.3g}; "
        f"later steps loss {later['loss']:.3g} (gate "
        f"{TRAIN_DIST_LATER_LOSS}), grad_norm {later['grad_norm']:.3g}; "
        f"after the restore "
        f"{[tuple(round(v, 6) for v in x) for x in r0['more']]} (one device "
        f"{[tuple(round(v, 6) for v in x) for x in ref['more']]}) loss "
        f"{more['loss']:.3g} (gate {TRAIN_DIST_LATER_LOSS}), grad_norm "
        f"{more['grad_norm']:.3g}; float32 steps (loss, grad_norm) "
        f"{r0['f32']['mesh']} (one device {r0['f32']['one']}), apart "
        f"{[float(f'{x:.3g}') for x in f32]} (gate {TRAIN_DIST_STEP0} on "
        f"step 0), each AdamW update against its reference on the rank's "
        f"shards: largest |mesh - reference| by step "
        f"{update} (gate {TRAIN_DIST_UPDATE}); initial digest {r0['init_digest']} "
        f"(one device {ref['init_digest']}); commits {r0['commits']}, in "
        f"the log {r0.get('logged')}, membership "
        f"{[bin(r['membership']) for r in rs]}, coordinators "
        f"{[r['coordinators'] for r in rs]}; ms per step a rank "
        f"{[round(x, 1) for x in step_ms]} (median of steps 2-4; one device "
        f"{statistics.median(one.step_ms[1:]):.1f}); save ms "
        f"{[[round(x, 1) for x in r['save_ms']] for r in rs]}, gather ms "
        f"{[[round(x, 1) for x in r['gather_ms']] for r in rs]}, gathered "
        f"B a save {r0['gather_b']} (closed form {r0['gather_want']}, "
        f"{r0['sharded']} sharded leaves); restore ms: mesh checkpoint "
        f"{[round(r['restore_mesh'][2], 1) for r in rs]}, one-device "
        f"checkpoint {[round(r['restore_one'][2], 1) for r in rs]}, on one "
        f"device {one_restore_ms:.1f}; CKPT_COMMIT ticks "
        f"{r0['commit_ticks']}, ms {[round(x, 1) for x in r0['commit_ms']]}"
        f"; {per_tick} coordinator ticks; peak "
        f"{max(r['peak_gib'] for r in rs):.2f} GiB a rank; the last rank "
        f"started {max(r['up'] for r in rs) - w0:.1f} s in, train "
        f"{[round(r['train_s'], 1) for r in rs]} s, one device "
        f"{ref['wall']:.1f} s; collectives staged through the host "
        f"({r0['staged']}): no time here is a speed of the method")
    if any(r["init_digest"] != ref["init_digest"] for r in rs):
        bad.append("initial state digests differ from one device's")
    for k in ("losses", "grad_norms", "digests", "membership", "more"):
        if any(r[k] != r0[k] for r in rs):
            bad.append(f"the ranks' {k} differ")
    if any(r["f32"]["mesh"] != r0["f32"]["mesh"] for r in rs):
        bad.append("the ranks' float32 metrics differ")
    if loss0 > TRAIN_DIST_STEP0 or f32[0] > TRAIN_DIST_STEP0:
        bad.append(f"step 0: loss {loss0:.3g}, float32 {f32[0]:.3g} apart")
    if max(update) > TRAIN_DIST_UPDATE:
        bad.append(f"float32 AdamW updates {update} from their reference "
                   f"on the rank's shards")
    if max(later["loss"], more["loss"]) > TRAIN_DIST_LATER_LOSS:
        bad.append(f"losses {later['loss']:.3g} apart, after the restore "
                   f"{more['loss']:.3g}")
    want = [(s, tags.get(s)) for s in TRAIN_DIST_COMMITS]
    if [s for s, _, _ in r0["commits"]] != TRAIN_DIST_COMMITS or \
            r0.get("logged") != want or r0.get("last_committed") != want[-1]:
        bad.append(f"commits {r0['commits']}, logged {r0.get('logged')}, "
                   f"last {r0.get('last_committed')}")
    if [r["coordinators"] for r in rs] != [1] + [0] * (len(rs) - 1) or \
            any(r["commits"] for r in rs[1:]):
        bad.append("not exactly one coordinator, on rank 0")
    if any(r["membership"] != 0b1101 for r in rs):
        bad.append(f"membership {[r['membership'] for r in rs]}")
    for i, r in enumerate(rs):
        for k in ("restore_mesh", "restore_one"):
            if r[k][1]:
                bad.append(f"rank {i} {k}: {r[k][1][:3]} not bit-equal")
        if r["restore_mesh"][0] != r0["commits"][-1][1] or \
                r["restore_one"][0] != one.commits[-1][1]:
            bad.append(f"rank {i}: restored digests {r['restore_mesh'][0]}, "
                       f"{r['restore_one'][0]}")
        if r["gather_b"] != [r0["gather_want"]] * len(TRAIN_DIST_COMMITS) \
                or not r0["gather_want"]:
            bad.append(f"rank {i}: gathered {r['gather_b']} B, closed form "
                       f"{r0['gather_want']}")
        for k, c in r["launches"].items():
            w = per_tick if i == 0 and k in PER_TICK else 0
            if c != w or (w == 0 and i == 0 and k in PER_TICK) or \
                    r["launches_after"][k] != c:
                bad.append(f"rank {i}: {k} launched {c} times "
                           f"({r['launches_after'][k]} after the extra "
                           f"steps) over {per_tick} coordinator ticks")
    log(f"phase 22 launches by rank: "
        f"{json.dumps({k: [r['launches'][k] for r in rs] for k in r0['launches']})}")
    if bad:
        raise AssertionError("phase 22 failed: " + "; ".join(bad))
    return {k: [r["launches"][k] for r in rs] for k in r0["launches"]}


def repeat_phase10(dev, n) -> int:
    """Phases 8-9 once, then phase 10's float32 smollm check `n` times in
    this process (ROADMAP.md §3 F4): each failure prints its diagnosis;
    the summary line counts them.  Exits 1 if any run failed."""
    import torch
    run_attention_checks(dev, long_shapes=False)
    run_ssd_checks(dev)
    failed = []
    for i in range(n):
        try:
            run_serve_card_vs_cpu(dev, torch.float32)
        except AssertionError as exc:
            failed.append(i)
            log(f"phase 10 run {i}: FAILED: {exc}")
    log(f"phase 10 float32 repeats: {n} runs, {len(failed)} failed "
        f"{failed}; {card_line()}")
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile 10 ticks of the solo and fleet "
                    "paths, a prefill and 4 decode steps of each "
                    "serve path and 2 train steps")
    ap.add_argument("--phase10", type=int, default=0, metavar="N",
                    help="build the kernels, run phases 8-9, then phase "
                    "10's float32 smollm check N times in this process "
                    "(ROADMAP.md F4), print how many failed and exit")
    ap.add_argument("--phase15", action="store_true",
                    help="build the kernels, run phase 15 (training) "
                    "alone and exit")
    ap.add_argument("--phase16", action="store_true",
                    help="build the kernels, run phase 8 without its "
                    "long shapes and phase 16 (MoE, cross-attention, "
                    "encoder-decoder), and exit")
    ap.add_argument("--phase17", action="store_true",
                    help="run phase 17 (the expert-parallel MoE on ranks "
                    "sharing the card) alone and exit: it runs none of "
                    "the port's kernels, so nothing is built")
    ap.add_argument("--phase18", action="store_true",
                    help="build the kernels, run phase 18 (the LM forward "
                    "on DTensors over ranks sharing the card) alone and "
                    "exit")
    ap.add_argument("--phase19", action="store_true",
                    help="build the kernels, run phase 19 (the train step "
                    "on DTensors, seamless serving on a mesh) alone and "
                    "exit")
    ap.add_argument("--phase20", action="store_true",
                    help="build the kernels, run phase 20 (the dry run "
                    "against a real run on ranks sharing the card, and "
                    "production cells) alone and exit")
    ap.add_argument("--phase21", action="store_true",
                    help="build the kernels, run phase 21 (the frozen "
                    "reference forms against the kernel pipeline at the "
                    "paper's cluster) alone and exit")
    ap.add_argument("--phase22", action="store_true",
                    help="build the kernels, run phase 22 (launch/train.py "
                    "on ranks sharing the card against one device) alone "
                    "and exit")
    ap.add_argument("--depth-witness", action="store_true",
                    help="build the kernels, read phase 18's llama "
                    "case on the card against the host at each depth of "
                    "WITNESS_LAYERS and its long bf16 case on 2 x 2 with "
                    "d_model sharded and whole, phase 19's readings of "
                    "TRAIN_WITNESS host against card and its llama bf16 "
                    "case on 1 x 4 with the heads and MLP sharded and "
                    "whole, and exit")
    ap.add_argument("--probe-gloo", action="store_true",
                    help="report which functional collectives gloo takes "
                    "on CUDA tensors of 4 ranks sharing the card, raw "
                    "and staged through the host, and exit")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    from repro_torch.configs.bwraft_kv import CONFIG
    from repro_torch.core import state as SM
    from repro_torch.core.draws import fleet_epoch
    from repro_torch.core.fleet import group_digest_width, rack_voters
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if args.probe_gloo:
        probe_gloo()
        log(card)
        return 0
    if args.phase17:
        with phase(17):
            run_moe_ep()
        log(f"phase 17 alone {time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    with phase(1):
        t0 = time.perf_counter()
        libs = build.build()
        log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
        spills = {}
        for name, path in libs.items():
            info = path.with_suffix(".log")
            if info.exists():
                for fn, ln in ptxas_report(info.read_text()):
                    log(f"  ptxas {name} {fn}: {ln}")
                    m = re.search(r"(\d+) bytes spill stores", ln)
                    if m:
                        spills[fn] = spills.get(fn, 0) + int(m.group(1))
        for fn in NO_SPILL:
            if fn not in spills:
                raise AssertionError(f"ptxas reported nothing for {fn}")
            if spills[fn]:
                raise AssertionError(f"ptxas spilled {spills[fn]} bytes in "
                                     f"{fn}")
        check_barrier_free(libs)
    dev = torch.device("cuda")
    alone = {18: (args.phase18, run_lm_mesh),
             19: (args.phase19, run_train_mesh),
             20: (args.phase20, run_dryrun),
             21: (args.phase21, lambda: run_reference(dev, CONFIG)),
             22: (args.phase22, lambda: run_train_dist(dev))}
    if args.depth_witness:
        depth_witness(dev)
        log(card)
        return 0
    for n, (on, run) in alone.items():
        if on:
            with phase(n):
                run()
            log(f"phase {n} alone {time.perf_counter() - t_start:.1f} s")
            log(card)
            return 0
    if args.phase10:
        return repeat_phase10(dev, args.phase10)
    if args.phase15:
        with phase(15):
            run_training(dev, args.profile)
        log(card)
        return 0
    if args.phase16:
        with phase(8):
            run_attention_checks(dev, long_shapes=False)
        with phase(16):
            run_10d(dev, args.profile)
        log(card)
        return 0
    static = SM.build_static(CONFIG)
    fleet_shapes = dict(O=50 * rack_voters(CONFIG), S=CONFIG.num_sites,
                        Fi=group_digest_width(CONFIG), G=1)
    with phase(2):
        results, floor = run_kernel_checks(dev, CONFIG, static, fleet_shapes)
    with phase(3):
        sim, solo_counts, kept = run_main_path(dev, CONFIG)
        main_data = time_main_path_data(kept, floor, static)
        run_quickstart(dev, CONFIG)
    with phase(4):
        run_card_vs_cpu("solo", SM.batch1(sim.state), [sim.static],
                        SM.batch1(sim.cfg_c), CONFIG.period_ticks)
    with phase(5):
        fleet, fleet_counts, fleet_kept = run_fleet_path(dev, CONFIG)
        main_data.update(time_main_path_data(
            fleet_kept, floor, static, FLEET_DATA,
            {"ae_sync": f"fleet tick {FLEET_DATA_AT['ae_sync']}",
             "group_reduce": f"fleet epoch {FLEET_DATA_AT['group_reduce']}"}))
    with phase(6):
        run_sweep(dev, CONFIG)
    with phase(7):
        run_card_vs_cpu("fleet", fleet.state,
                        [m.static for m in fleet.members], fleet._cfg_c,
                        CONFIG.period_ticks, fleet._gids, fleet.n_groups)
    with phase(8):
        att = run_attention_checks(dev)
    with phase(9):
        ssd = run_ssd_checks(dev)
    with phase(10):
        run_serve_card_vs_cpu(dev, torch.float32)
        run_serve_card_vs_cpu(dev, torch.bfloat16)
    with phase(11):
        for dt in (torch.float32, torch.bfloat16):
            run_serve_card_vs_cpu(dev, dt, arch="mamba2-130m", S=300)
    with phase(12):
        model, serve_counts, _ = run_serve_path(dev)
        check_serve_sync_free(model, dev)
    with phase(13):
        mamba, mamba_counts, _ = run_serve_path(dev, "mamba2-130m")
        check_serve_sync_free(mamba, dev)
    with phase(14):
        services, _ = run_host_services(dev, CONFIG)
    with phase(15):
        train_counts = run_training(dev, args.profile)
    with phase(16):
        ten_d = run_10d(dev, args.profile)
        free_card()
    with phase(17):
        moe_ep = run_moe_ep()
    with phase(18):
        lm_mesh = run_lm_mesh()
    with phase(19):
        train_mesh = next(iter(run_train_mesh().values()))
    with phase(20):
        dry_calls = run_dryrun()
    with phase(21):
        reference = run_reference(dev, CONFIG)
    if args.profile:
        b = sim.draws.epoch(10, sim.state, sim.cfg_c)
        run_profile("solo", SM.batch1(sim.state), sim.static_t,
                    SM.batch1(sim.cfg_c),
                    {k: v.unsqueeze(1) for k, v in b.items()}, 10)
        run_profile("fleet", fleet.state, fleet._bstatic, fleet._cfg_c,
                    fleet_epoch(fleet.draws, 10, fleet.state, fleet._cfg_c),
                    10)
        run_serve_profile(model, dev)
        run_serve_profile(mamba, dev)
    with phase(22):
        train_dist = run_train_dist(dev)
    with phase(23):
        kernels = []
        for name in RAFT:
            r = results[name]["fleet"]
            entry = {
                "name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": fleet_counts[name],
                "max_abs_err": 0, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": bound_ms(r["bytes"], r["ops"]),
                "bound_by": bound_by(r["bytes"], r["ops"]),
                "library_ms": r["library_ms"],
                "launches_solo": solo_counts[name],
                "launches_train": train_counts[name], "floor_ms": floor,
                "launches_moe_ep": {ep: c[name] for ep, c in moe_ep.items()},
                "launches_lm_mesh": lm_mesh[name],
                "launches_services": {run: c[name]
                                      for run, c in services.items()},
                "launches_host_pipeline": reference[name],
                "launches_train_dist": train_dist[name]}
            if "solo" in results[name]:
                s = results[name]["solo"]
                entry.update(ms_solo=s["ms"], plain_ms_solo=s["plain_ms"],
                             bound_ms_solo=bound_ms(s["bytes"], s["ops"]))
            if name in main_data:
                m = main_data[name]
                entry.update(ms_main_data=m["ms"],
                             plain_ms_main_data=m["plain_ms"],
                             bound_ms_main_data=bound_ms(m["bytes"], m["ops"]))
                if "ms_no_due" in m:
                    entry.update(ms_main_data_no_due=m["ms_no_due"])
            kernels.append(entry)
        for name in ("flash_attention", "decode_attention"):
            a = att[name]
            r = a["serve"]
            entry = {
                "name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": serve_counts[name],
                "max_abs_err": a["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": att_bound_ms(r["bytes"], r["flops"], r["dtype"]),
                "bound_by": att_bound_by(r["bytes"], r["flops"], r["dtype"]),
                "library_ms": r["library_ms"],
                "launches_tensor_core": serve_counts["routes"][name][
                    "tensor_core"],
                "launches_train": train_counts[name],
                "launches_moe_ep": {ep: c[name] for ep, c in moe_ep.items()},
                "launches_lm_mesh": lm_mesh[name],
                "launches_lm_mesh_tensor_core": lm_mesh[name + "_tensor_core"],
                "launches_10d": {a: c[name] for a, c in ten_d["serve"].items()},
                "launches_10d_tensor_core": {
                    a: c["routes"][name]["tensor_core"]
                    for a, c in ten_d["serve"].items()}}
            if name == "decode_attention":
                entry["launches_lm_mesh_lse"] = lm_mesh["decode_lse"]
                entry["launches_train_mesh_lse"] = train_mesh["decode_lse"]
                for k in ("ms_lse", "plain_ms_lse", "bound_ms_lse"):
                    entry[k] = r[k]
                    entry[k + "_long"] = a["long"][k] if "long" in a else None
            entry["launches_train_mesh"] = train_mesh[
                "flash" if name == "flash_attention" else "decode"]
            entry["fake_calls_dryrun"] = dry_calls.get(name, 0)
            entry["launches_train_dist"] = train_dist[name]
            if "long" in a:
                g = a["long"]
                entry.update(
                    ms_long=g["ms"], plain_ms_long=g["plain_ms"],
                    library_ms_long=g["library_ms"],
                    bound_ms_long=att_bound_ms(g["bytes"], g["flops"],
                                               g["dtype"]))
            kernels.append(entry)
        r, g = ssd["serve"], ssd["long"]
        kernels.append({
            "name": "ssd_scan", "route": "cuda", "source": SOURCE["ssd_scan"],
            "replaces": REPLACES["ssd_scan"],
            "launches": mamba_counts["ssd_scan"],
            "max_abs_err": ssd["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": att_bound_ms(r["bytes"], r["flops"], r["dtype"]),
            "bound_by": att_bound_by(r["bytes"], r["flops"], r["dtype"]),
            "library_ms": None,
            "launches_tensor_core": mamba_counts["routes"]["ssd_scan"][
                "tensor_core"],
            "launches_train": train_counts["ssd_scan"],
            "launches_moe_ep": {ep: c["ssd_scan"] for ep, c in moe_ep.items()},
            "launches_lm_mesh": lm_mesh["ssd_scan"],
            "launches_10d_jamba_check": ten_d["jamba"]["ssd_scan"],
            "fake_calls_dryrun": dry_calls.get("ssd_scan", 0),
            "launches_train_dist": train_dist["ssd_scan"],
            "ms_long": g["ms"],
            "plain_ms_long": g["plain_ms"], "library_ms_long": None,
            "bound_ms_long": att_bound_ms(g["bytes"], g["flops"], g["dtype"])})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
