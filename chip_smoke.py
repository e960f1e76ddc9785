#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``
   (``sm_90a``), print the build time and ``ptxas`` resource lines;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at B = 4096: link geometry (one thread a link
   up to U 32: U 8 at B 256 and 4096, U 16, 32 and 5, 6 (not powers of
   two), and U 80 (a warp a row); without ``gain_scale`` and with
   log-normal shadowing, a 0 dB fade and a -200 dB blackout of one UAV's
   links (``GAIN_MODES``), with dead UAVs; ``dist`` and ``threshold`` bitwise, ``rate`` within rtol
   1e-6), the tropical-DP step (random, tie-heavy and all-inf inputs;
   bitwise) and the fused chain DP (``assign`` and ``latency`` bitwise
   against ``chain_dp_ref``: AlexNet at the rollout's shape (U 8, 4
   slots, B 256), 8 slots, B 4096, tie-heavy rates, dead UAVs and a
   scenario with every UAV down, LeNet, U 32 with 32 slots, a chain of
   32 random layers (prefix sums in XLA's blocked order), each one
   launch on the ``fused`` route, its shared-memory total the launcher's
   layout's; and U 80 on the ``step`` route, 11 step launches and no
   fused one);
4. a small rollout on the card against the same rollout on the CPU (the
   plain path): discrete fields exact, floats within rtol 1e-5;
5. the main path: ``FleetRollout(...).run`` at AlexNet, U = 8, B = 256,
   T = 32 with the fused P2 stage, launch counters set to 0 just before
   and read just after (32 link-geometry and 32 tropical-DP launches,
   every chain DP on the ``fused`` route, no step launch), then
   ``ScenarioEngine.plan_batch_multi`` at B = 256 (1 and 1 launches,
   ``fused``); feasibility, latency percentiles, wall time; the
   warm-up rollout runs its frame loop under PyTorch's sync debug mode
   "error", so a host synchronisation inside the loop fails the phase;
   then ``plan_batch_multi`` at U = 80 (B 16), whose tables take the
   chain DP's ``step`` route: 1 link-geometry launch, no fused
   tropical-DP launch and 11 ``tropical_dp_step`` launches, counted on
   ``step``;
6. each kernel's time (CUDA events over a CUDA graph of many launches,
   and eager back-to-back launches) beside its plain version's and its
   bound at the published H100 SXM peaks: link geometry, the fused chain
   DP at the rollout's shape (its ``kernel_route``) and the step kernel,
   each with the launch floor (``launch_floor_ms``: a one-element
   ``zero_()`` in the same harness, graph and eager);
7. the conv2d GEMM kernel against its plain version at AlexNet's five
   conv GEMMs (batch 32 and 1; conv1 at K 363 and padded to 364) and
   ragged shapes, relu on and off, atol 5e-4 rtol 1e-3, each launch on
   the route its K gives (the 3xTF32 wgmma route for K a multiple of 4,
   the SIMT route otherwise), two launches bitwise equal; the conv2d op
   against a direct float32 convolution at the five conv layers;
8. the CNN path: ``LLHRPlanner.plan`` (P2 200 steps on the card) for four
   AlexNet requests on U = 8 UAVs with a fifth of the memory each, so
   every request spans >= 2 UAVs; each request's 32 images through
   ``distributed_forward`` sliced by its placement, launch counters set
   to 0 just before and read just after (4 x 5 conv2d launches, every one
   on the wgmma route); sliced equals monolithic bitwise; then the four requests served again and
   again over a window of at least 1.5 s (images/s over the window, the
   spread per serve and per request); the replan without request 0's
   first UAV; the same path at 2 images against the CPU plain path;
9. the conv2d kernel's time at the five conv GEMMs as served (batch 32,
   conv1's K padded to 364) beside its plain version, ``torch.addmm``,
   the route and tile its launches took and both bounds (3xTF32 on the
   tensor cores, fp32 outside them; ``bound_ms`` is the smaller);
10. the flash- and decode-attention kernels against their plain versions
    on the card, float32 (atol 2e-5, rtol 2e-4) and bfloat16 (the
    reference's atol 2e-2, rtol 2e-1, and within atol 1e-3, rtol 1e-2:
    one bf16 rounding of the output), two launches bitwise equal: flash
    at the reference's kernel-test grid, gemma2-9b's prefill (B 1, H 16,
    KV 8, S 2048, D 256, causal, cap 50, window 0 and 1024), ragged S
    (1, 1000), the serving run's shapes (B 8 at S 1345, its first
    prefill, and at S 2048, the timed one), olmoe-1b-7b's (B 8, H 16,
    KV 16, S 1024, D 128) and recurrentgemma-9b's (H 16 over KV 1, D 256,
    window 2048, B 8 at S 1536 and B 1 at S 3072), row blocks at a query
    offset (``FLASH_OFFSETS``: minicpm-2b's last block of 8, rows 256,
    keys 2,048, offset 1,792; offsets off a kv tile, with and without a
    window), every flash launch on
    the wgmma route in bfloat16 and the SIMT route in float32; decode at
    the reference's grid and gemma2-9b's decode (B 8, KV 8, G 2, S 4096,
    D 256, cap 50, pos with 0 and S - 1), and with pos at the split-KV
    edges (L - 1, L, S - 1 for the split length L, S not a multiple of
    L) at gemma2's widths (S 4001), recurrentgemma's decode (B KV 8 at
    G 16) and olmoe's D 128;
11. the reduced gemma2-9b and phi4-mini in float32, card against the CPU
    plain path: prefill and decode logits within 1e-4, and
    ``ContinuousBatcher`` token ids equal;
12. the LM serving path: gemma2-9b at full width (bfloat16 weights from a
    seeded card generator) serving 12 requests (prompts of 256-1536
    tokens, max_new 8-40) through ``ContinuousBatcher`` at max_batch 8,
    max_seq 4096, greedy, launch counters set to 0 just before and read
    just after (42 flash launches per prefill call, every one on the
    wgmma route, 42 decode launches per decode step); prefill and
    decode-step walls, decode tokens/s, time to first token per request,
    peak memory; then one 6144-token
    request at max_seq 8192 (the 4096 window bites); then one prefill and
    4 decode steps through the kernels against the plain versions inside
    the model: each logit's difference within the larger of 1.5 times
    the plain versions' own largest under reordered sums and, in float32
    (the weights widened), atol 1e-2 + rtol 1e-3 of that logit, in
    bfloat16 2 bf16 ulps of it;
13. both attention kernels' times at gemma2-9b's shapes in bfloat16
    beside their plain versions, ``F.scaled_dot_product_attention``
    (without the softcap), their bounds, the route flash's launches took
    and decode's splits;
14. the expert GEMM (``moe_matmul``) against its plain version at the
    reference's kernel-test grid and olmoe-1b-7b's prefill (E 64, C 8 x
    240 and the served 1144) and decode (C 8) GEMMs, a ragged C 97 and
    D, F not multiples of 8, float32 (atol 1e-5 sqrt(D), rtol 1e-4) and
    bfloat16 (atol 1e-3, rtol 1e-2, and the reference's TOL), each launch
    on the wgmma route in bfloat16 where TMA takes the shape and on the
    SIMT route otherwise; the
    RG-LRU scan bitwise against its sequential plain version at the
    reference's grid, recurrentgemma-9b's prefill (B 8, T 1536, W 4096)
    and a W 102, each launch on the TMA-ring route where rows are a
    multiple of 16 bytes and on the SIMT route otherwise (W 102); decode
    attention at G = 16 (B 8, KV 1, 2048 slots, D 256),
    random pos and pos at the split edges, and with its log-sum-exp at G 2
    and G 16 (``DECODE_LSE``: the output bitwise the call without it, rows
    with a negative pos 0 and ``-inf``);
    each two launches bitwise equal;
15. the reduced granite-moe, olmoe and recurrentgemma in float32, card
    against the CPU plain path, as phase 11;
16. olmoe-1b-7b at full width serving 8 requests (prompts 256-1024,
    max_new 8-24) at max_batch 8, max_seq 2048: exactly 48 expert-GEMM
    and 16 flash launches per prefill call, 48 expert-GEMM and 16 decode
    launches per decode step, every expert-GEMM and flash launch on the
    wgmma route; then kernels against plain inside the model as in phase
    12;
17. recurrentgemma-9b at full width serving 8 requests (prompts
    256-1536, max_new 8-24) at max_seq 4096, then one 3072-token request
    (its 2048 window rolls): exactly 26 RG-LRU-scan and 12 flash launches
    per prefill call (flash on the wgmma route, every scan on the tma
    route) and 12 decode launches per decode step; then kernels against
    plain inside the model;
18. the expert GEMM's and the RG-LRU scan's times at the served shapes in
    bfloat16, each first checked against its plain version at that
    shape, beside their plain versions, ``torch.bmm`` (the GEMM), their
    bounds and the route each took; decode attention at
    recurrentgemma-9b's decode (B 8, KV 1, G 16, 2048 slots, D 256)
    beside SDPA with ``enable_gqa`` and its bytes bound (the decode
    row's ``g16``);
19. the chunkwise mLSTM kernel (``mlstm_chunk``) against its plain
    version from nonzero initial states: the reference's kernel-test
    grid, xlstm-350m's prefill (B 8, H 4, D 256, S 1024 and S 1000: a
    ragged last chunk) and decode (S 1), S 63, 64, 65 and 129 at the
    wgmma route's chunk edges; float32 (h and the state within the
    reference's kernel-test atol 5e-4, rtol 1e-3) and bfloat16 (h one
    output rounding more: atol 1e-3, rtol 1e-2); two launches bitwise
    equal; each launch on the route its dtype and S give (bfloat16 with
    S > 1 wgmma, S 1 decode, float32 with S > 1 simt);
20. the reduced xlstm-350m in float32, card against the CPU plain path,
    as phase 11;
21. xlstm-350m at full width serving 8 requests (prompts 256-1024,
    max_new 8-24) at max_batch 8, max_seq 2048: exactly 12 mlstm_chunk
    launches per prefill call, every one on the wgmma route, and 12 per
    decode step on the decode route, no other kernel (the 12 sLSTM
    layers are a plain torch step loop); then kernels against plain
    inside the model as in phase 12;
22. the mLSTM kernel's time at the served prefill shape and at a decode
    step in bfloat16, each first checked against its plain version at
    that shape, beside its plain version, the route it took and its
    bounds (the prefill's on the tensor cores, split products counted
    twice, and in fp32 SIMT; ``bound_ms`` the smaller), and the prefill
    of one (b, h) sequence alone;
23. the paper's evaluation path, each run with the launch counters set
    to 0 just before it and read just after: ``solve_chain_dp_batched``
    (AlexNet, U 8, B 4096, a permuted device order, dead UAVs) and
    ``solve_chain_dp_multisource`` (4 sources), each exactly one fused
    chain-DP launch on the ``fused`` route and bitwise equal to the same
    call on the CPU; a ``ContingencyTable`` at U 8 refreshed twice at
    moved positions, each refresh 1 link-geometry + 1 fused chain-DP
    launch and equal to the CPU's table (assignments exact, latency and
    power within rtol 1e-5); ``SwarmSim`` at the example's configuration
    (LeNet and AlexNet, 6 UAVs, 4 requests a frame, T = 8 frames): LLHR
    with ``solve_chain_dp`` at 80 P2 steps on the rollout, exactly T
    link-geometry and T fused chain-DP launches, the heuristic and
    random baselines on the legacy loop, no launch; LLHR's mean latency
    <= both baselines' (+1e-9) and its feasibility >= theirs; the
    failure row (frame 1, UAV 2) replanned and every frame feasible;
    ``solve_positions_legacy`` at U 8, 800 steps, keeping 2R apart;
24. the paper's figure scripts and the serving layers, each rollout call
    counted (the counters read just before and just after it): the four
    ``benchmarks/torch_fig*.py`` ``--smoke`` grids on the card (their
    default device), every rollout call exactly T link-geometry and T
    fused chain-DP launches, nothing launched outside them (Fig. 5's
    baselines on the legacy loop), rows with the CPU plain path's names
    and feasibility, the derived column within rtol 1e-3 plus a printed
    digit (the baselines' exact), and the paper's trends (Fig. 2's
    latency falls with P_max, Fig. 4's power with bandwidth, Fig. 5's
    LLHR under both baselines); Fig. 5's full grid (5 LLHR points, 10
    baseline runs: LLHR feasible and under both everywhere); a
    ``PeriodicReplanner`` (AlexNet, U 8, B 128, fused P2) with an
    8-frame ``FleetRollout`` lookahead over 32 trajectories, 10 ticks at
    period 5: a refresh 9 link-geometry + 9 fused chain-DP launches, a
    tick between refreshes none, no build after the first; the chaos
    ladder's two scripts of ``tests/test_chaos.py`` (a single crash
    answered from the contingency table, a 3-UAV burst by a live
    replan) with the CPU's modes, rungs, metrics and runner events, and
    a -200 dB blackout through the rollout (exactly the faded frames
    infeasible); the gateway soak of ``tests/test_gateway.py`` twice on
    one plan cache (invariants, a bitwise replay on one built rollout,
    one retry for the stall, no failed window, 4 + 4 launches a window,
    the CPU's outcomes); ``examples/torch_quickstart.py`` (4 conv2d
    launches, sliced == monolithic) and
    ``examples/torch_scenario_planning.py`` (5 + 5 launches);
25. the attention kernels against their plain versions at whisper-tiny's
    and qwen2-vl-2b's shapes, float32 and bfloat16 (``ATTN_TOL``, bf16
    also ``ATTN_BF16_ROUNDING``), two launches bitwise equal, each flash
    launch on its dtype's route: flash non-causal at the encoder's B 4,
    H 6, S 1,500, D 64, cross-attention Sq 16 and 448 over Sk 1,500, and
    ragged Sq 1 / 63 / 65 over Sk 1 / 1,000; flash causal at qwen2-vl's
    prefill (B 4, H 12, KV 2, S 1,280, D 128); decode over the cross
    cache (B 4, KV 6, G 1, 1,500 slots, pos 1,499 on every row) and at
    qwen2-vl's decode (B 8, KV 2, G 6, 2,048 slots, D 128, pos at the
    split edges);
26. the reduced whisper-tiny (frames of 16 and 37, prompt 40, cache 48)
    and qwen2-vl-2b (8 patch embeddings, and text only with
    ``ContinuousBatcher`` as phase 11) in float32, card against the CPU
    plain path through ``make_prefill_step`` / ``make_decode_step``:
    prefill and 4 decode steps' logits within 1e-4;
27. whisper-tiny at full width in bfloat16 served through the step
    functions: 4 streams of seeded frames [4, 1,500, 384] made on the
    card, prompts of 4-16 tokens (left-padded), cache 448, 64 greedy
    tokens; exactly 12 flash launches a prefill call (4 encoder
    non-causal, 4 decoder causal, 4 cross), every one on the wgmma route,
    and 8 decode launches a step (4 self, 4 cross); then the kernels
    against the plain versions inside the model, as phase 12;
28. qwen2-vl-2b at full width in bfloat16: 8 text-only requests (prompts
    256-1,024) through ``ContinuousBatcher`` at max_batch 8, max_seq
    2,048, then B 4 through ``make_prefill_step`` with 256 seeded patch
    embeddings in front of the prompts and 32 decode steps: exactly 28
    flash launches a prefill call (wgmma) and 28 decode launches a step;
    kernels against plain inside the model, text only and with patches;
29. both attention kernels' times at this slice's shapes in bfloat16
    (flash non-causal at S 1,500 and cross Sq 448 x Sk 1,500; decode at
    G 1 x 1,500 slots and G 6 x 2,048), each first held against its
    plain version there, beside the plain version,
    ``F.scaled_dot_product_attention`` and the bound (sub-entries of the
    flash and decode rows);
30. the pipeline-stage planner with the card's constants (``card_chip``:
    the card's name and memory, the H100 SXM data sheet's dense bf16
    peak halved; the data sheet's NVLink rate one way, and an assumed
    2 us hop, 4 x 4 torus and 400 Gb/s cross-host port):
    ``plan_pipeline`` for every LM config at each supported shape at 2, 4
    and 8 stages of 8 cards, ``scale_elastic`` (qwen2-vl-2b, train_4k) at
    8, 7 and 5; each plan's blocks sum to the layers + 2 (+ encoder
    layers), consecutive stages sit one hop apart, the bottleneck is the
    largest stage latency, and a rescale uses at most n stages;
31. the main path's rollout (AlexNet, U 8, B 256, T 32, 4 requests a
    frame, P2) split over ``fleet_mesh`` meshes: two entries of this
    card, a ragged B 250 over four, and every visible card when there is
    more than one; each run bitwise equal on every valid field to the
    unsharded run with the same generator, with exactly T x shards
    link-geometry and fused chain-DP launches, no build after the first
    runs; then the unsharded and two-shard walls in turns;
32. ``examples/torch_serve_swarm.py``'s three modes on the card: the LM
    mode's 4 flash launches (SIMT route, float32) a prefill call and 4
    decode launches a decode step, nothing else, its 2-stage plan;
    ``--chaos`` and ``--stream``: every rollout call T + T fused
    launches, the chaos mode's planning calls 1 + 1 each outside them,
    the stream mode nothing outside them; events, windows and reports
    the CPU's;
33. the flash-attention backward kernel (``csrc/flash_attention_bwd.cu``)
    against its plain version ``attention_bwd_ref`` on the same o and lse,
    float32 and bfloat16 (``ATTN_TOL``, bf16 also ``ATTN_BF16_ROUNDING``):
    minicpm-2b's training call (B 1, H 36, S 4,096, D 64, causal),
    gemma2-9b's (H 16, KV 8, S 2,048, D 256, cap 50, window 1,024 and
    none), qwen2-vl-2b's (H 12, KV 2, D 128), whisper-tiny's non-causal
    S 1,500 and cross Sq 448 x Sk 1,500, ragged Sq / Sk of 1, 65 and
    1,000, recurrentgemma-9b's (H 16 over KV 1, S 4,096, D 256, window
    2,048), and row blocks at a query offset (``BWD_OFFSET_CASES``); two
    backward launches bitwise equal, each on its dtype's
    route (bfloat16 ``wgmma``, float32 ``simt``); the
    forward with ``with_lse`` on its dtype's route, its output bitwise
    the serving launch's, its lse the plain version's;
34. the backward kernel's time at minicpm-2b's and gemma2-9b's shapes in
    bfloat16 (graph and eager) beside its plain version, the backward of
    ``F.scaled_dot_product_attention`` (no softcap) and its bound (five
    products, 2 D flops a kept (query, key) pair and head, at the bf16
    peak, against the bytes of q, k, v, o, dO, dq, dk, dv and lse);
35. the reduced minicpm-2b, gemma2-9b, qwen2-vl-2b (8 patch embeddings)
    and whisper-tiny in float32, card against the CPU plain path: the
    loss and every gradient leaf (``TRAIN_TOL``), one flash and one
    backward launch a flash call; 3 ``make_train_step`` steps at 2
    microbatches with ``grad_compress`` off and on: the same losses and
    parameters (``held_after_steps``);
36. minicpm-2b at full width and depth trained on the card (bf16 compute
    on float32 masters, ``remat="full"``, S 4,096, 2 microbatches of one
    sequence, WSD, 3 steps; ``FULL_TRAIN``): exactly 2 x 40 flash
    launches a microbatch, all on wgmma, and 40 backward launches; loss
    and grad norm finite, the loss falling; step walls, tokens/s, peak
    memory, model FLOP/s; the bare forward wrappers refuse grad, and
    ``expert_gemm`` and ``linear_recurrence`` under grad launch their
    forward and backward kernels; then the gradients at S 1,024 through
    the kernels against the plain versions, each leaf's gap relative to
    its largest gradient within the larger of ``LM_GAP`` x the reordered
    plain side's largest and ``GRAD_FLOOR_ULPS`` bf16 ulps;
37. ``examples/torch_train_lm.py`` on the card, the default run and
    ``--simulate-failure`` (restore the latest committed checkpoint,
    resume): its own assert that the loss fell, exactly 2 x 6 flash and
    backward launches a step run, the forward on SIMT;
38. the expert GEMM's backward kernels (``csrc/moe_matmul_bwd.cu``: dX =
    dy w^T, dW = x^T dy) against their plain versions, float32 and
    bfloat16, at granite-moe's training shapes (E 32, C 1,280, D 1,024,
    F 512 and D 512, F 1,024), olmoe's (E 64, C 640, D 2,048, F 1,024),
    a ragged C 97, D and F of 100 and 36, and C 0 (dW zeros), within
    phase 14's tolerances with each product's contraction; the RG-LRU
    reverse scan (``csrc/rglru_scan_bwd.cu``) bitwise against
    ``rglru_bwd_ref`` at B 1 x T 4,096 x W 4,096, B 8 x T 1,345, a
    ragged W 100, T 1, T 5 at W 4,100 (a partial strip), h0 nonzero,
    with and without dhT; two launches bitwise equal, each on the
    forward's route rule (``tma`` where rows are a multiple of 16 B and
    T > 0, else ``simt``);
39. their times at granite-moe's dX and dW (bf16) and recurrentgemma's
    reverse scan (B 1, T 4,096, W 4,096, float32; ``tma``, and the
    ``simt`` kernel at the same inputs through its launcher), graph and
    eager, beside their plain versions, ``torch.bmm`` on the transposed
    operands and their bounds; the forward scan at the same training
    shape (the ``rglru_scan`` row's ``train``);
40. the reduced granite-moe, olmoe and recurrentgemma trained card
    against CPU as phase 35 (the loss with the MoE aux term; exactly 3
    expert GEMMs, 3 dX and 3 dW a MoE layer, a scan and a reverse scan
    an RG-LRU layer, each on its float32 route);
41. granite-moe-1b-a400m at full width and depth and recurrentgemma-9b
    at full width, 9 layers (three Griffin periods), trained as phase 36
    (``FULL_TRAIN_SLICE``): exactly 2 x 72 expert GEMMs (``wgmma``), 72
    dX and 72 dW, 2 x 24 flash and 24 backward launches a granite
    microbatch; 2 x 6 RG-LRU scans (float32 under grad: ``tma``), 6
    reverse scans (``tma``), 2 x 3 flash and 3 backward launches a recurrentgemma
    microbatch; model FLOP/s over the active parameters (a MoE layer's
    top-k experts); the in-model gradient gate at S 1,024;
42. the mLSTM chunk backward kernel against ``mlstm_chunk_bwd_ref`` at
    its chunks of 64 (``MLSTM_BWD_CASES``: xlstm-350m's training call B 1
    x S 4,096 x H 4 x D 256, its served prefill B 8 at S 1,024 and 1,000,
    S 1, 37 and 100, D 16 to 128, zero and random initial states, the
    final state's gradients given or not, each drawn on its own, one
    case on each of the normaliser's branches, and one whose m0 holds
    every chunk's max), float32 and bfloat16, each gradient within
    1e-4 of its largest magnitude (``MLSTM_BWD_SHARE``), two launches
    bitwise equal, every launch on ``mlstm_bwd_route``'s route (bfloat16
    ``wgmma``, float32 ``simt``);
43. its time at the training call in bfloat16 (graph and eager) on
    ``wgmma`` beside its plain version, its bound (bytes at the
    tensor-core peak; the fp32 SIMT bound beside it), the route's
    workspace floor (``mlstm_bwd_floor``) and its kernels' device times;
    the ``simt`` kernel on the same inputs (through its launcher, held
    against the ``wgmma`` outputs); no library call computes it; then the
    forward at the same shape (``wgmma``, 16 blocks at B 1), the
    ``mlstm_chunk`` row's ``train``;
44. the reduced xlstm-350m trained card against CPU as phase 35 (a chunk
    forward and a chunk backward an mLSTM layer, float32: on ``simt``);
45. xlstm-350m at full width and depth (24 layers, d 1,024, tied) trained
    as phase 36 with S cut to 1,024 (``FULL_TRAIN_XLSTM``: the sLSTM is a
    step loop of eager launches; cut to 8 layers its float32 gate read
    1.04 of its limit, against 0.81 at 24, so its depth stays): exactly
    2 x 12 mLSTM forward launches (``wgmma``) and 12 backward launches
    (``wgmma``) a microbatch and no
    other kernel; the in-model gradient gate at S 256 on the initial
    parameters in float32 compute (on ``simt``), the plain side's mLSTM at
    the kernels' chunks (32 forward, 64 backward), the reordered side's at
    64 (in bf16, and after the steps, the gradients are chaotic); the
    first bf16 backward's operands of the training (the model's own dh)
    through ``wgmma`` again, held against the plain backward;
46. expert-parallel serving: olmoe-1b-7b at full width and depth in
    bfloat16 (seeded card weights) under ``use_mesh_rules`` of two
    meshes of entries of the card, (data 1, model 8) and (data 2, model
    4): one prefill of B 8 x S 1,024 and 4 decode steps, each call
    exactly 3 x |data| x |model| x 16 expert-GEMM launches (every one on
    ``wgmma``) and 16 flash or decode launches; the same calls without a
    mesh beside them; each shard's capacity; the expert GEMM against its
    plain version at every shard shape those calls launched (E / |model|
    x cap x D x F, prefill and decode, both ways, ``MOE_TOL``); the
    kernels against the plain versions inside the model under each mesh
    (phase 12's logit rule); the reduced olmoe in float32 under a (2, 4)
    mesh of the card against the same mesh of the CPU, prefill and 4
    decode steps' logits within 1e-4;
47. the LLHR-planned pipelined forward: minicpm-2b at full width and
    depth in bfloat16, B 8 x S 2,048, ``plan_pipeline``'s 4-stage plan
    (as phase 30 makes it, at ``prefill_32k``) mapped from ``arch_cost``'s
    units (embedding first, head last) onto the 40 blocks, a ``stage``
    mesh of 4 entries of the card at 4 and 8 microbatches: exactly 40 x
    n_micro flash launches (``wgmma``), the output bitwise equal to the
    blocks run microbatch by microbatch with no pipeline, the largest gap
    to the whole-batch forward, the walls of all three;
48. the int8 all-reduce: ``psum_compressed`` over a data axis of 4
    entries of the card on the float32 gradients of the reduced
    granite-moe on four seeded batches (its ``stacked_groups``), two
    steps of error feedback, bitwise equal to the same call on the CPU;
49. the dry run beside the card (``DRY_CALLS``): phase 36's minicpm-2b
    training step, phase 46's unsharded olmoe-1b-7b prefill (B 8 x S
    1,024) and one gemma2-9b decode step at B 8 on phase 12's cache, each
    (a) run on ``meta`` under the op profiler (``launch.op_analysis``),
    (b) on the card under it: the aten products, traffic, kernel calls by
    name and route with their work, and launches by route equal the dry
    run's exactly, (c) on the card without it after a warm-up (CUDA
    events): the dry run's bytes a device within ``DRY_MEMORY_TOL`` of
    ``max_memory_allocated`` above what the card held before, (d) the
    roofline's terms (``launch.roofline``) beside the wall;
50. the sanitizer on the main path: the AlexNet U 8, B 256 rollout
    (``SANITIZE_T`` frames) inside ``sanitized(PLAN_FN_CACHE)`` after its
    one build: no NaN and no build; fed one position at +inf it raises
    ``FloatingPointError`` naming the op on the card that made the NaN;
51. minicpm-2b trained under a (2, 4) mesh of the card (FSDP x TP);
52. gemma2-9b served under a (2, 4) mesh, then the reduced
    recurrentgemma under (2, 2) against the CPU;
53. minicpm-2b (36 heads and KV heads on a model axis of 8) under a
    (1, 8) mesh: a training step under ``attn_seq_shard`` (rows over
    model, the flash kernels at each block's query offset) with the
    float32 gradient gate, the card's kernel calls and counts those of
    the dry run of all 8 positions, the dry run's last position exactly
    its share of all 8 (all 8 less the other 7 run on their own), its
    bytes within ``DRY_MEMORY_TOL``; then a prefill (both layouts) and 4
    decode steps (``seq_shard_kv``) under phase 12's logit rule; then the
    flash kernels at the last row block's shape, beside SDPA under the
    same mask and its backward, and decode attention with its
    log-sum-exp timed (``SEQ_TIMED``);
54. gemma2-9b (KV 8 on 16) under a (1, 16) mesh and ``seq_shard_kv``:
    a prefill and 4 decode steps (the cache's blocks merged by their
    log-sum-exps) under phase 12's rule; the reduced gemma2-9b and
    recurrentgemma-9b with a cache longer than their window against the
    CPU.  Phases 51-54 hold every kernel call at its shard shape against
    its plain version.  Phases 52 and 54 run gemma2-9b cut to 14 of its
    42 layers, 51 and 53 minicpm-2b cut to 20 of its 40 (depth, for the
    smoke's time: every width, layout, kernel and gate stays);
55. whisper-tiny at full width and depth under a (2, 4) mesh (6 heads on
    a model axis of 4): a training step under ``attn_seq_shard`` (the
    decoder's rows and the encoder's 1,500 frames, padded to 1,504, over
    model; K/V gathered and cut to the real frames) gated as phase 53's,
    a prefill under both layouts (the cross cache by slots, 375 a
    position) and 4 decode steps under ``seq_shard_kv``, phase 12's rule
    in bfloat16 and float32; the reduced whisper (3 heads) under (2, 2)
    card against CPU;
56. xlstm-350m at full width cut to 4 layers under a (1, 8) mesh: a
    training step with the rows over model, each position's recurrence
    starting from the state its predecessor hands on (one position x 8
    == all 8 on meta, the hand-off charged as a collective-permute), a
    prefill and 4 decode steps on the key-block decode step (32 key rows
    a position, the partial sums merged over model), the reduced xLSTM
    (3 heads) under (2, 2) card against CPU; phases 55 and 56 hold every
    kernel call at its shard shape (the mLSTM's backward at a position
    with the state's gradient its successor handed back) against its
    plain version; phase 19 holds the key-block mode against its plain
    version, and 57 times it (``DECODE_BLOCK_TIMED``).

Every phase's bound column reads the kernel's work from
``kernels.work.KERNEL_WORK`` and the card's rates from ``launch.roofline``
(``kernel_bound``).

The last lines are the sharded LMs' record (phases 51-56), the dry-run
and sanitizer record (phases 49-50), the
sharded-model record (phases 46-48), the training
record, the pipeline planner's, the
sharded rollout's and the serving example's records, the serving layers'
record, the evaluation path's walls and summaries, the CNN path's and the
six LM paths' serving numbers, the per-layer conv2d times, the kernels
line, the ``nvidia-smi`` line and the result object.
Without CUDA it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# each kernel's work (``KERNEL_WORK``) and the H100 SXM's rates have one
# source each in the port: ``kernels.work`` and ``launch.roofline``
from repro_torch.kernels.work import KERNEL_WORK, kept_pairs  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_FLOPS as BF16_OPS_PER_S, FP32_FLOPS as FP32_OPS_PER_S,
    HBM_BW as HBM_BYTES_PER_S, POD_BW as POD_BYTES_PER_S,
    TF32_FLOPS as TF32_OPS_PER_S, kernel_bound)


U, L_ALEXNET = 8, 11
MAIN_B, MAIN_T, REQUESTS = 256, 32, 4
MAIN_N_IMG = 32                  # images per request on the CNN path
CONV_ITERS = 20                  # timed conv GEMM launches per measurement
CNN_WINDOW_S = 1.5               # least timed serving window of the CNN path
LM_ARCH = "gemma2-9b"            # the LM serving path's model, full width
LM_BATCH = 8                     # ServeConfig.max_batch of the served runs
LM_CHECK_TOKENS = 1024           # prompt of the kernels-vs-plain check
#: the served runs at full width (phases 12, 16, 17, 21, 27, 28), at max_batch
#: 8: requests, prompt and max_new ranges (inclusive), max_seq, the kernel
#: launches every prefill call and every decode step must make (16
#: layers x 3 expert GEMMs for olmoe; recurrentgemma's 38 layers are 26
#: RG-LRU and 12 local attention; xlstm's 24 are 12 sLSTM and 12 mLSTM),
#: and the long request (prompt, max_seq, max_new) or None
SERVED = {
    LM_ARCH: dict(requests=12, prompt=(256, 1536), max_new=(8, 40),
                  max_seq=4096, prefill={"flash_attention": 42},
                  decode={"decode_attention": 42}, long=(6144, 8192, 16)),
    "olmoe-1b-7b": dict(requests=8, prompt=(256, 1024), max_new=(8, 24),
                        max_seq=2048,
                        prefill={"moe_matmul": 48, "flash_attention": 16},
                        decode={"moe_matmul": 48, "decode_attention": 16},
                        long=None),
    "recurrentgemma-9b": dict(requests=8, prompt=(256, 1536),
                              max_new=(8, 24), max_seq=4096,
                              prefill={"rglru_scan": 26,
                                       "flash_attention": 12},
                              decode={"decode_attention": 12},
                              long=(3072, 4096, 16)),
    "xlstm-350m": dict(requests=8, prompt=(256, 1024), max_new=(8, 24),
                       max_seq=2048, prefill={"mlstm_chunk": 12},
                       decode={"mlstm_chunk": 12}, long=None),
    # 28 layers; then ``streams`` requests with ``patches`` patch
    # embeddings through the step functions, ``steps`` decode steps
    "qwen2-vl-2b": dict(requests=8, prompt=(256, 1024), max_new=(8, 24),
                        max_seq=2048, prefill={"flash_attention": 28},
                        decode={"decode_attention": 28}, long=None,
                        streams=4, patches=256, steps=32),
    # served through the step functions only (the batcher passes no
    # frames): 4 encoder, 4 decoder and 4 cross flash launches a prefill,
    # 4 self and 4 cross decode launches a step
    "whisper-tiny": dict(streams=4, prompt=(4, 16), cache_len=448,
                         steps=63, prefill={"flash_attention": 12},
                         decode={"decode_attention": 8}),
}
#: the expert GEMM against its plain version: float32 sums in another
#: order grow with sqrt(D); bfloat16 within one output rounding, beside
#: the reference's kernel-test TOL (atol TOL sqrt(D), rtol 10 TOL)
MOE_TOL = {"float32": lambda d: dict(atol=1e-5 * d ** 0.5, rtol=1e-4),
           "bfloat16": lambda d: dict(atol=1e-3, rtol=1e-2)}
MOE_REF_TOL = {"float32": lambda d: dict(atol=2e-5 * d ** 0.5, rtol=2e-4),
               "bfloat16": lambda d: dict(atol=2e-2 * d ** 0.5, rtol=2e-1)}
#: the reference's attention kernel-test tolerance (tests/test_kernels.py)
ATTN_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
            "bfloat16": dict(atol=2e-2, rtol=2e-1)}
#: bfloat16 attention held tighter as well: the kernel and the plain
#: version agree in float32, so their bf16 outputs differ by at most one
#: rounding (2^-7 relative), far inside the reference's band
ATTN_BF16_ROUNDING = dict(atol=1e-3, rtol=1e-2)
#: a library call timed beside a kernel computes the same function: its
#: largest gap from the plain version within this share of the plain
#: version's largest value (SDPA rounds in its own order, a few bf16
#: ulps; a wrong mask moves whole rows)
LIBRARY_SAME_FUNCTION = 0.02
#: the mLSTM kernel against its plain version: h and the float32 state
#: within the reference's kernel-test tolerance (the kernel's chunks of
#: 32 against the plain version's 256 or S); a bfloat16 h one output
#: rounding more
MLSTM_TOL = dict(atol=5e-4, rtol=1e-3)
MLSTM_BF16_TOL = dict(atol=1e-3, rtol=1e-2)
#: the reordered plain side's mLSTM chunk (the model's is 256, or S)
MLSTM_REORDER_CHUNK = 64
#: logits through every layer: each logit's gap from the plain versions'
#: at most this many times the plain versions' own largest gap when only
#: their sums are reordered, ...
LM_GAP = 1.5
#: ... or, in bf16, this many bf16 ulps of that logit, whichever is
#: larger: the reordered side's own worst at the large logits is one ulp,
#: and bf16 logits resolve nothing finer; in float32, atol 1e-2 plus rtol
#: 1e-3 of the logit (the term that binds for the attention, MoE and
#: griffin models; xLSTM's recurrences carry float32 reordering to 0.05
#: at logits of 170, ROADMAP section 3)
LM_BF16_ULPS = 2
LM_F32_TOL = dict(atol=1e-2, rtol=1e-3)
#: the route every launch of a multi-route LM kernel must take in a
#: served (bfloat16) run, by call kind: the expert GEMM and flash
#: attention on wgmma (their SIMT routes take float32 and shapes TMA
#: cannot read), the RG-LRU scan on its TMA ring, the mLSTM on wgmma in
#: prefill and on its streaming route in decode (the conv GEMM's 3xTF32
#: wgmma route is gated on the CNN path)
SERVED_ROUTES = {
    "prefill": {"moe_matmul": "wgmma", "flash_attention": "wgmma",
                "rglru_scan": "tma", "mlstm_chunk": "wgmma"},
    "decode": {"moe_matmul": "wgmma", "mlstm_chunk": "decode"}}


def bound_keys(work):
    """A kernel line's ``bound_ms`` and ``bound_by`` from its work."""
    bound = kernel_bound(work)
    return {"bound_ms": bound.bound_s * 1e3, "bound_by": bound.bound_by}


def log(*args):
    print(*args, flush=True)


def ptxas_resources(build_log: str):
    """(kernel instantiation, registers line, spills line) per entry
    function in an ``nvcc -Xptxas -v`` log; the instantiation is the
    kernel's name and its mangled template arguments (``f`` float32,
    ``13__nv_bfloat16`` bfloat16, ``Li<n>E`` an integer)."""
    rows, entry, spills = [], "?", ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            end = mangled.find("_kernel") + len("_kernel")
            start = end - len("_kernel")
            while start and (mangled[start - 1].isalpha()
                             or mangled[start - 1] == "_"):
                start -= 1
            args = mangled[end:mangled.find("EEv", end) + 1] \
                if mangled[end:end + 1] == "I" else ""
            entry = mangled[start:end] + args
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            rows.append((entry, line.split(":", 1)[-1].strip(), spills))
    return rows


def only(launches, **nonzero):
    """The launch counts a run must show: ``nonzero``, every other kernel
    of ``launches`` 0."""
    return dict(dict.fromkeys(launches, 0), **nonzero)


def take_route(fn, call):
    """``call()``, one launch of the two-route kernel ``fn``; returns its
    result and the route the launch took."""
    before = dict(fn.launches_by_route)
    out = call()
    taken = [r for r, n in fn.launches_by_route.items() if n != before[r]]
    if len(taken) != 1 or fn.launches_by_route[taken[0]] != \
            before[taken[0]] + 1:
        raise AssertionError(f"{fn.__name__}: one launch, routes moved "
                             f"from {before} to {fn.launches_by_route}")
    return out, taken[0]


def want_route(name, route, want):
    if route != want:
        raise AssertionError(f"{name}: launch took the {route} route, want "
                             f"{want}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


#: the link-gain factors phase 3 holds link geometry at: none, log-normal
#: shadowing (3 dB), a neutral 0 dB fade and a -200 dB blackout of one UAV's
#: links a scenario (a gain of 1e-20 computed in float32, as the chaos
#: harness's ``rollout_inputs`` computes it)
GAIN_MODES = (None, "lognormal", "0 dB", "-200 dB")


def geometry_inputs(np, torch, seed, B, gain, device, u=U):
    from repro_torch.core.positions import hex_init
    rng = np.random.default_rng(seed)
    base = hex_init(u, 40.0, jitter=0.5, seed=seed)
    pos = (base[None] + rng.normal(0, 15.0, (B, u, 2))).astype(np.float32)
    pos[0, 1 % u] = pos[0, 0] + 0.3               # under the 1 m clamp
    active = rng.random((B, u)) >= 0.15
    gs = None
    if gain == "lognormal":
        gs = (10.0 ** (rng.normal(0, 3.0, (B, u, u)) / 10.0)).astype(
            np.float32)
    elif gain in ("0 dB", "-200 dB"):
        db = np.zeros((B, u, u), np.float32)
        if gain == "-200 dB":
            faded = rng.integers(0, u, B)
            db[np.arange(B), faded, :] = -200.0
            db[np.arange(B), :, faded] = -200.0
            db[np.arange(B), faded, faded] = 0.0
        gs = 10.0 ** (db / 10.0)
    return [None if x is None else torch.as_tensor(x, device=device)
            for x in (pos, active, gs)]


def dp_inputs(np, torch, seed, B, M, L, S, ties, device):
    """Step operands with inf holes; ``ties`` draws small integers so equal
    candidates across a and s0 are common, and plants all-inf rows."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.integers(0, 3, shape) if ties else rng.uniform(0, 5, shape)
        x = x.astype(np.float32)
        x[rng.random(shape) < 0.2] = np.inf
        return x

    table = np.full((B, M, L + 1, S + 1), np.inf, np.float32)
    table[:, :, :L] = draw((B, M, L, S + 1))
    tr, tr0 = draw((B, L, S, S + 1)), draw((B, M, S))
    ct = (rng.integers(0, 2, (L, S)) if ties
          else rng.uniform(0, 1, (L, S))).astype(np.float32)
    ok = (rng.random((L, S)) < 0.8).astype(np.float32)
    ok[:, 0] = 0.0                       # state 1: no feasible block start
    table[0, 0] = np.inf                 # a (b, m) slab with no parent
    tr0[0, 0] = np.inf
    t = torch.as_tensor(table, device=device)
    # the solver passes a row slice of its [B, M, L+1, S+1] table
    return [t[:, :, :L]] + [torch.as_tensor(x, device=device)
                            for x in (tr, tr0, ct, ok)]


def chain_costs(np, model):
    """The layer costs of a chain-DP case: a CNN's (``alexnet``,
    ``lenet``) or ``random<L>``, L layers drawn as the long-chain tests
    draw them (a chain past XLA's cumsum block of 16, so the prefix sums
    take its blocked order), weights large enough that a placement splits
    over UAVs."""
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.configs.lenet import LENET
    from repro_torch.core.cost_model import LayerCost, ModelCost, cnn_cost
    if model in ("alexnet", "lenet"):
        return cnn_cost({"alexnet": ALEXNET, "lenet": LENET}[model])
    L = int(model[len("random"):])
    rng = np.random.default_rng(L)
    return ModelCost(model, tuple(
        LayerCost(f"l{j}", float(c), float(m), float(a)) for j, (c, m, a)
        in enumerate(zip(np.abs(rng.normal(7e7, 3e7, L)) + 1e6,
                         np.abs(rng.normal(6e7, 3e7, L)) + 1e4,
                         np.abs(rng.normal(6e5, 3e5, L)) + 1e4))), 1e6)


def chain_inputs(np, torch, seed, mc, u, M, B, rates, device):
    """Operands of the chain DP at a planner shape: the tables of the
    layer costs ``mc`` for ``u`` devices in a shuffled order, rates from
    hex-grid positions through the plain link geometry (``geometry``) or
    integer multiples of 1e6 (``ties``: many equal-latency placements), a
    sixth of the UAVs dead, scenario 0 with every UAV down (all its slots
    infeasible)."""
    from repro_torch.core.batch import chain_dp_tables
    from repro_torch.core.channel import RadioParams
    from repro_torch.core.swarm import make_devices
    from repro_torch.kernels.link_geometry.ref import link_geometry_ref
    rng = np.random.default_rng(seed)
    devs = make_devices(u)
    t = chain_dp_tables(
        [x.flops for x in mc.layers], [x.weight_bytes for x in mc.layers],
        [x.act_bits for x in mc.layers], mc.input_bits,
        [d.mem_cap for d in devs], [d.compute_cap for d in devs],
        [d.throughput for d in devs],
        order=tuple(int(o) for o in rng.permutation(u)), device=device)
    pos, active, _ = geometry_inputs(np, torch, seed, B, None, device, u)
    active[0] = False
    if rates == "ties":
        rate = torch.as_tensor(rng.integers(0, 3, (B, u, u)) * 1e6,
                               dtype=torch.float32, device=device)
        rate[:, torch.arange(u), torch.arange(u)] = float("inf")
    else:
        rate = link_geometry_ref(pos, active, None, params=RadioParams())[2]
    sources = torch.as_tensor(rng.integers(0, u, (B, M)), device=device)
    return (rate, sources, active, t.order_arr, t.prev_dev, t.bits_in,
            t.input_bits, t.ct, t.ok)


def max_abs_err(torch, ref, got):
    worst = 0.0
    for a, b in zip(ref, got):
        if not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise AssertionError("inf masks differ")
        fin = torch.isfinite(a)
        if fin.any():
            worst = max(worst, float((a[fin].double() - b[fin].double())
                                     .abs().max()))
    return worst


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_geometry(np, torch, params, device, B, u, gain):
    """The link-geometry kernel against its plain version; returns the max
    abs error over the three outputs."""
    from repro_torch.kernels.link_geometry.link_geometry import link_geometry
    from repro_torch.kernels.link_geometry.ref import link_geometry_ref
    pos, active, gs = geometry_inputs(np, torch, 1, B, gain, device, u)
    got = link_geometry(pos, active.float(), gs, params=params)
    ref = link_geometry_ref(pos, active, gs, params=params)
    torch.cuda.synchronize()
    for name, a, b in zip(("dist", "threshold"), ref, got):
        if not torch.equal(a, b):
            raise AssertionError(f"link_geometry {name} differs "
                                 f"(B={B}, U={u}, gain={gain})")
    a, b = ref[2], got[2]
    if not torch.equal(a == 0, b == 0):
        raise AssertionError("link_geometry rate zero masks differ")
    fin = torch.isfinite(a)
    rel = ((a[fin] - b[fin]).abs() / a[fin].abs().clamp_min(1e-30))
    if float(rel.max()) > 1e-6:
        raise AssertionError(f"link_geometry rate rtol "
                             f"{float(rel.max())} > 1e-6 (B={B}, U={u})")
    err = max_abs_err(torch, ref, got)
    log(f"  link_geometry B={B} U={u} gain={gain}: dist/threshold bitwise,"
        f" rate max rel {float(rel.max()):.3g}, max abs err {err}")
    return err


#: the chain-DP cases of phase 3: (name, model, U, slots, B, rates, route)
CHAIN_CASES = (
    ("rollout", "alexnet", U, REQUESTS, MAIN_B, "geometry", "fused"),
    ("all slots", "alexnet", U, U, MAIN_B, "geometry", "fused"),
    ("B 4096", "alexnet", U, REQUESTS, 4096, "geometry", "fused"),
    ("ties", "alexnet", U, U, MAIN_B, "ties", "fused"),
    ("lenet", "lenet", U, REQUESTS, MAIN_B, "ties", "fused"),
    ("U 32", "alexnet", 32, 32, 64, "geometry", "fused"),
    ("U 80", "alexnet", 80, 2, 16, "geometry", "step"),
    # phase 23's SwarmSim shape: S 6 is the runtime-S warp-a-slot body
    ("swarm", "alexnet", 6, REQUESTS, 2, "geometry", "fused"),
    ("swarm lenet", "lenet", 6, REQUESTS, 2, "geometry", "fused"),
    ("swarm ties", "alexnet", 6, 6, MAIN_B, "ties", "fused"),
    # 32 random layers: prefix sums in XLA's blocked order
    ("L 32", "random32", U, REQUESTS, MAIN_B, "geometry", "fused"))


def check_chain(np, torch, device, name, model, u, M, B, rates, route):
    """The chain DP through its dispatcher against ``chain_dp_ref``, bitwise:
    one fused launch on the ``fused`` route, L step launches and no fused
    one on the ``step`` route.  On the fused route the wrapper's
    shared-memory total is also held against the launcher's layout."""
    from repro_torch import kernels
    from repro_torch.kernels.tropical_dp import tropical_dp as tdp
    from repro_torch.kernels.tropical_dp.ops import chain_dp
    from repro_torch.kernels.tropical_dp.ref import chain_dp_ref
    mc = chain_costs(np, model)
    L = len(mc.layers)
    args = chain_inputs(np, torch, 3, mc, u, M, B, rates, device)
    kernels.reset_launch_counts()
    got = chain_dp(*args)
    launches, routes = kernels.launch_counts(), kernels.route_counts()
    ref = chain_dp_ref(*args)
    torch.cuda.synchronize()
    fused = route == "fused"
    want = only(launches, tropical_dp=1) if fused else \
        only(launches, tropical_dp_step=L)
    want_routes = {"fused": 1, "step": 0} if fused else \
        {"fused": 0, "step": L}
    if launches != want or routes["tropical_dp"] != want_routes:
        raise AssertionError(f"tropical_dp {name}: launches {launches}, "
                             f"routes {routes['tropical_dp']}; want the "
                             f"{route} route")
    if fused:
        mt, _, smem = tdp.chain_plan(M, L, u, u)
        if tdp.kernel_smem_bytes(L, u, u, mt) != smem:
            raise AssertionError(f"tropical_dp {name}: shared memory "
                                 f"{smem} B, launcher's layout "
                                 f"{tdp.kernel_smem_bytes(L, u, u, mt)} B")
    for what, a, b in zip(("assign", "latency"), ref, got):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"tropical_dp {name}: {what} differs")
    lat = got[1]
    if not (torch.isinf(lat[0]).all() and (got[0][0] == -1).all()
            and torch.isfinite(lat).any()):
        raise AssertionError(f"tropical_dp {name}: infeasible rows")
    log(f"  tropical_dp {name} ({model} L={L} U={u} M={M} B={B} {rates}): "
        f"assign/latency bitwise on {route}; "
        f"{int(torch.isfinite(lat).sum())}/{lat.numel()} slots feasible")
    return max_abs_err(torch, ref[1:], got[1:])


def check_kernels(np, torch, params, device):
    from repro_torch.kernels.tropical_dp.ref import dp_step_ref
    from repro_torch.kernels.tropical_dp.tropical_dp import tropical_dp_step
    errs = {}
    for B, u in ((MAIN_B, U), (4096, U), (MAIN_B, 16), (MAIN_B, 32),
                 (MAIN_B, 5), (MAIN_B, 6), (64, 80)):
        for gain in GAIN_MODES:
            err = check_geometry(np, torch, params, device, B, u, gain)
            if (B, u, gain) == (MAIN_B, U, None):
                errs["link_geometry"] = err
    for B in (MAIN_B, 4096):
        for ties in (False, True):
            args = dp_inputs(np, torch, 2, B, REQUESTS, L_ALEXNET, U, ties,
                             device)
            got = tropical_dp_step(*args)
            ref = dp_step_ref(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("row", "pa", "ps"), ref, got):
                if not torch.equal(a, b):
                    raise AssertionError(f"tropical_dp_step {name} differs "
                                         f"(B={B}, ties={ties})")
            n_dead = int(torch.isinf(got[0]).sum())
            err = max_abs_err(torch, ref[:1], got[:1])
            if B == MAIN_B and not ties:
                errs["tropical_dp_step"] = err
            log(f"  tropical_dp_step B={B} ties={ties}: row/pa/ps bitwise "
                f"({n_dead} all-inf outputs)")
    for case in CHAIN_CASES:
        err = check_chain(np, torch, device, *case)
        if case[0] == "rollout":
            errs["tropical_dp"] = err
    return errs


def alexnet_fleet(torch, device, p2, seed, frames, cache=None):
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.rollout import PositionSpec, RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.scenario_engine import PlanFnCache
    spec = RolloutSpec(frames=frames, requests_per_frame=REQUESTS,
                       jitter_sigma_m=2.0, failure_prob=0.05,
                       recovery_prob=0.3, battery_j=5e3)
    return FleetRollout(RadioChannel(), make_devices(U), cnn_cost(ALEXNET),
                        spec, plan_cache=PlanFnCache() if cache is None
                        else cache,
                        position_spec=PositionSpec(steps=30, repair_iters=25)
                        if p2 else None, seed=seed, device=device)


def check_small_rollout(np, torch, device):
    """The card's rollout against the CPU's plain path, same seed."""
    from repro_torch.core.positions import hex_init
    base = hex_init(U, 40.0, jitter=0.5, seed=1)
    r_gpu = alexnet_fleet(torch, device, p2=False, seed=3, frames=4).run(
        base, n_trajectories=16)
    r_cpu = alexnet_fleet(torch, "cpu", p2=False, seed=3, frames=4).run(
        base, n_trajectories=16)
    for f in ("feasible", "cap_feasible", "assign", "active", "n_requests"):
        if not np.array_equal(getattr(r_gpu, f), getattr(r_cpu, f)):
            raise AssertionError(f"small rollout: {f} differs GPU vs CPU")
    for f in ("latency", "total_power", "source_latency", "positions",
              "charge", "energy_tx", "energy_cmp"):
        np.testing.assert_allclose(getattr(r_gpu, f), getattr(r_cpu, f),
                                   rtol=1e-5, atol=0, err_msg=f)
    log(f"  small rollout (B=16, T=4): GPU == CPU plain path; "
        f"feasibility {r_gpu.feasibility_rate}")


def without_sync(torch, fn, args):
    """``fn(*args)`` with PyTorch's sync debug mode set to raise."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def run_main_path(np, torch, device):
    from repro_torch import kernels
    from repro_torch.core.positions import hex_init
    from repro_torch.runtime.scenario_engine import ScenarioGenerator
    fleet = alexnet_fleet(torch, device, p2=True, seed=0, frames=MAIN_T)
    base = hex_init(U, 40.0, jitter=0.5, seed=0)
    # warm-up; it also proves the frame loop never makes the host wait for
    # the card: any synchronising call inside it raises
    built = fleet._rollout
    fleet._rollout = lambda *inputs: without_sync(torch, built, inputs)
    t0 = time.perf_counter()
    fleet.run(base, n_trajectories=MAIN_B)
    warm_s = time.perf_counter() - t0
    fleet._rollout = built
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trace = fleet.run(base, n_trajectories=MAIN_B)         # ends on host
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    routes = kernels.route_counts()["tropical_dp"]
    want = only(launches, link_geometry=MAIN_T, tropical_dp=MAIN_T)
    if launches != want or routes != {"fused": MAIN_T, "step": 0}:
        raise AssertionError(f"rollout launches {launches} != {want}, "
                             f"chain-DP routes {routes}")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    lat = trace.latency
    if lat.shape != (MAIN_B, MAIN_T) or \
            trace.assign.shape != (MAIN_B, MAIN_T, U, L_ALEXNET):
        raise AssertionError("rollout trace shapes")
    if not trace.feasibility_rate > 0:
        raise AssertionError("no feasible frame in the main rollout")
    feas = trace.feasible
    if not (np.isfinite(lat[feas]).all() and
            np.isfinite(trace.total_power).all() and
            np.isfinite(trace.positions).all() and
            (trace.total_power[feas] >= 0).all()):
        raise AssertionError("non-finite values in the main rollout")
    used = trace.assign[feas]
    if not ((used >= -1) & (used < U)).all():
        raise AssertionError("assignments out of range")
    d = np.sqrt(((trace.positions[..., :, None, :] -
                  trace.positions[..., None, :, :]) ** 2).sum(-1))
    d[..., np.eye(U, dtype=bool)] = np.inf
    min_sep = float(d.min())
    if min_sep < 40.0 - 0.5:          # eq. (8d) after P2's repair: d >= 2R
        raise AssertionError(f"UAVs {min_sep} m apart, under 2R = 40 m")
    spread = sorted({int(x) for x in np.unique(used) if x >= 0})
    p50, p95 = trace.latency_percentile(50), trace.latency_percentile(95)
    log(f"  rollout AlexNet U={U} B={MAIN_B} T={MAIN_T} RQ={REQUESTS} "
        f"P2(30 steps, 25 repairs): launches {launches}, chain-DP routes "
        f"{routes}")
    log(f"  feasibility {trace.feasibility_rate:.6f}  latency p50 {p50:.6f}"
        f" s  p95 {p95:.6f} s  mean {trace.mean_latency:.6f} s")
    log(f"  UAVs hosting layers: {spread}; min pairwise distance "
        f"{min_sep:.3f} m (2R = 40 m)")
    log("  frame loop: no host synchronisation (sync debug mode 'error')")
    log(f"  rollout wall: first run {warm_s:.3f} s, steady {wall_s:.3f} s "
        f"({MAIN_B * MAIN_T / wall_s:.1f} trajectory-frames/s); "
        f"peak device memory {peak_mb:.1f} MiB")

    gen = ScenarioGenerator(base, pos_sigma_m=2.0, failure_prob=0.05,
                            seed=0)
    batch = gen.draw(MAIN_B)
    n_req = np.random.default_rng(0).multinomial(
        REQUESTS, np.full(U, 1.0 / U), size=MAIN_B)
    fleet.plan_batch_multi(batch, n_req)                    # builds + warms
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    plan = fleet.plan_batch_multi(batch, n_req)
    plan_s = time.perf_counter() - t0
    plan_launches = kernels.launch_counts()
    plan_routes = kernels.route_counts()["tropical_dp"]
    want = only(plan_launches, link_geometry=1, tropical_dp=1)
    if plan_launches != want or plan_routes != {"fused": 1, "step": 0}:
        raise AssertionError(f"plan_batch_multi launches {plan_launches} "
                             f"!= {want}, chain-DP routes {plan_routes}")
    if not plan.n_feasible > 0 or not np.isfinite(
            plan.latency[plan.feasible]).all():
        raise AssertionError("plan_batch_multi: no feasible plan")
    log(f"  plan_batch_multi B={MAIN_B}: launches {plan_launches}, "
        f"feasible {plan.n_feasible}/{MAIN_B}, p50 "
        f"{plan.latency_percentile(50):.6f} s, wall {plan_s:.4f} s")
    return launches


#: the chain DP's step route through an entry point: a swarm whose
#: transfer tensor (S 80 x L 11 x 81 floats) exceeds a block's shared memory
STEP_U, STEP_B = 80, 16


def run_step_route(np, torch, device):
    """``plan_batch_multi`` on a swarm of ``STEP_U`` UAVs: the chain DP
    takes its ``step`` route (11 step launches, no fused one), link
    geometry its warp-a-row kernel.  Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.positions import hex_init
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.scenario_engine import (PlanFnCache,
                                                     ScenarioEngine,
                                                     ScenarioGenerator)
    engine = ScenarioEngine(RadioChannel(), make_devices(STEP_U),
                            cnn_cost(ALEXNET), plan_cache=PlanFnCache(),
                            device=device)
    batch = ScenarioGenerator(hex_init(STEP_U, 40.0, jitter=0.5, seed=0),
                              pos_sigma_m=2.0, failure_prob=0.05,
                              seed=0).draw(STEP_B)
    n_req = np.random.default_rng(0).multinomial(
        REQUESTS, np.full(STEP_U, 1.0 / STEP_U), size=STEP_B)
    engine.plan_batch_multi(batch, n_req)                   # builds + warms
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    plan = engine.plan_batch_multi(batch, n_req)
    plan_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    routes = kernels.route_counts()["tropical_dp"]
    want = only(launches, link_geometry=1, tropical_dp_step=L_ALEXNET)
    if launches != want or routes != {"fused": 0, "step": L_ALEXNET}:
        raise AssertionError(f"plan_batch_multi U={STEP_U} launches "
                             f"{launches} != {want}, routes {routes}")
    if plan.assign.shape != (STEP_B, STEP_U, L_ALEXNET) or \
            not plan.n_feasible > 0:
        raise AssertionError(f"plan_batch_multi U={STEP_U}: no feasible "
                             f"plan or shape {plan.assign.shape}")
    log(f"  plan_batch_multi U={STEP_U} B={STEP_B} (step route): launches "
        f"{launches}, feasible {plan.n_feasible}/{STEP_B}, wall "
        f"{plan_s:.4f} s")
    return launches


def time_ms(torch, fn, iters, graph):
    """Per-call time on the card from CUDA events: over a CUDA graph of
    ``iters`` calls replayed (device time, no host dispatch), or over
    ``iters`` eager back-to-back calls (what a Python caller sees)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(np, torch, params, device, launches, step_launches, errs):
    from repro_torch.kernels.link_geometry.link_geometry import link_geometry
    from repro_torch.kernels.link_geometry.ref import link_geometry_ref
    from repro_torch.kernels.tropical_dp.ref import chain_dp_ref, dp_step_ref
    from repro_torch.kernels.tropical_dp.tropical_dp import (
        tropical_dp_chain, tropical_dp_step)
    B, M, L, S = MAIN_B, REQUESTS, L_ALEXNET, U
    pos, active, _ = geometry_inputs(np, torch, 5, B, None, device)
    act_f = active.float()
    chain_args = chain_inputs(np, torch, 6, chain_costs(np, "alexnet"), U,
                              M, B, "geometry", device)
    dp_args = dp_inputs(np, torch, 6, B, M, L, S, False, device)
    one = torch.zeros(1, device=device)
    floor_ms = time_ms(torch, one.zero_, 200, graph=True)
    floor_eager_ms = time_ms(torch, one.zero_, 200, graph=False)
    log(f"  launch floor (one-element zero_): {floor_ms * 1e3:.2f} us in a "
        f"graph, {floor_eager_ms * 1e3:.2f} us eager")
    _, chain_route = take_route(tropical_dp_chain,
                                lambda: tropical_dp_chain(*chain_args))
    rows = []
    cases = [
        ("link_geometry", "src/repro_torch/csrc/link_geometry.cu",
         "src/repro/kernels/link_geometry/link_geometry.py:119",
         lambda: link_geometry(pos, act_f, None, params=params),
         lambda: link_geometry_ref(pos, active, None, params=params),
         KERNEL_WORK["link_geometry"](pos, act_f, None),
         launches["link_geometry"], {}),
        ("tropical_dp", "src/repro_torch/csrc/tropical_dp.cu",
         "src/repro/kernels/tropical_dp/tropical_dp.py:86",
         lambda: tropical_dp_chain(*chain_args),
         lambda: chain_dp_ref(*chain_args),
         KERNEL_WORK["tropical_dp"](*chain_args),
         launches["tropical_dp"], {"kernel_route": chain_route}),
        ("tropical_dp_step", "src/repro_torch/csrc/tropical_dp.cu",
         "src/repro/kernels/tropical_dp/tropical_dp.py:86",
         lambda: tropical_dp_step(*dp_args),
         lambda: dp_step_ref(*dp_args),
         KERNEL_WORK["tropical_dp_step"](*dp_args),
         step_launches["tropical_dp_step"],
         {"launches_path": f"plan_batch_multi at U {STEP_U} (chain DP on "
                           f"its step route)"}),
    ]
    for (name, source, replaces, kern, plain, work, n_launch,
         extra) in cases:
        ms = time_ms(torch, kern, 200, graph=True)
        plain_ms = time_ms(torch, plain, 50, graph=True)
        eager_ms = time_ms(torch, kern, 200, graph=False)
        plain_eager_ms = time_ms(torch, plain, 50, graph=False)
        nbytes, nops = work.bytes, work.flops
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            **bound_keys(work),
            "library_ms": None, "eager_ms": eager_ms,
            "plain_eager_ms": plain_eager_ms, "bytes": nbytes,
            "operations": nops, "launch_floor_ms": floor_ms,
            "launch_floor_eager_ms": floor_eager_ms, **extra})
        log(f"  {name}: {ms * 1e3:.2f} us/launch in a graph, "
            f"{eager_ms * 1e3:.2f} us eager; plain {plain_ms * 1e3:.2f} us "
            f"(graph), {plain_eager_ms * 1e3:.2f} us eager; bound "
            f"{kernel_bound(work).bound_s * 1e6:.4f} us ({nbytes} B, "
            f"{nops} ops); "
            f"launch floor {floor_ms * 1e3:.2f} us")
    return rows


# ---------------------------------------------------------------------------
# the CNN path: conv2d kernel, LLHR planner, placement-sliced AlexNet
# ---------------------------------------------------------------------------


def conv_layers(batch):
    """AlexNet's conv layers at ``batch``: (name, spec, input NHWC shape,
    GEMM (M, K, N))."""
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.models.cnn import layer_shapes
    return [(spec.name, spec, x_shape,
             (y_shape[0] * y_shape[1] * y_shape[2],
              spec.kernel ** 2 * x_shape[3], y_shape[3]))
            for spec, (x_shape, y_shape) in zip(
                ALEXNET.layers, layer_shapes(ALEXNET, batch))
            if spec.kind == "conv"]


def gemm_inputs(np, torch, seed, m, k, n, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n, dtype=np.float32)
    return [torch.as_tensor(a, device=device) for a in (x, w, b)]


def check_fp32(torch):
    """Every comparison below is in full float32: no TF32 anywhere."""
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("float32 matmul precision is not 'highest'")


def check_conv2d_kernel(np, torch, device):
    """``matmul_bias_act`` against ``matmul_ref`` at AlexNet's five conv
    GEMMs (batch 32 and 1; conv1 at its raw K 363, the SIMT route, and
    at the served padded K 364) and ragged shapes, relu on and off, atol
    5e-4 rtol 1e-3, each launch on the route its K gives (``wgmma`` for
    K a multiple of 4, else ``simt``); two launches bitwise equal;
    ``conv2d`` against ``conv2d_ref`` at the five conv layers.  Returns
    the max abs error at conv2, batch 32."""
    from repro_torch.kernels.conv2d.conv2d import gemm_route, matmul_bias_act
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.kernels.conv2d.ref import conv2d_ref, matmul_ref
    check_fp32(torch)
    cases = [(f"{name} N={bs}", mkn, True) for bs in (MAIN_N_IMG, 1)
             for name, _, _, mkn in conv_layers(bs)]
    cases += [(f"conv1 N={bs} padded", (m, k + (-k) % 4, n), True)
              for bs in (MAIN_N_IMG, 1)
              for name, _, _, (m, k, n) in conv_layers(bs)
              if name == "conv1"]
    cases += [(f"ragged {m}x{k}x{n}", (m, k, n), relu)
              for m, k, n in ((1, 363, 96), (1, 17, 5), (67, 2401, 33),
                              (130, 1, 257), (67, 2400, 33), (130, 4, 257),
                              (1, 364, 96)) for relu in (True, False)]
    conv2_err = None
    for i, (label, (m, k, n), relu) in enumerate(cases):
        x, w, b = gemm_inputs(np, torch, 10 + i, m, k, n, device)
        got, route = take_route(matmul_bias_act, lambda: matmul_bias_act(
            x, w, b, relu=relu))
        want_route("matmul_bias_act", route, gemm_route(k))
        again = matmul_bias_act(x, w, b, relu=relu)
        ref = matmul_ref(x, w, b, relu=relu)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"matmul_bias_act {label}: two launches "
                                 f"differ")
        torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)
        err = float((got.double() - ref.double()).abs().max())
        if label == f"conv2 N={MAIN_N_IMG}":
            conv2_err = err
        log(f"  matmul_bias_act {label} (M={m} K={k} N={n}, relu={relu}): "
            f"{route} route, max abs err {err:.3g}, two launches bitwise "
            f"equal")
    rng = np.random.default_rng(20)
    for name, spec, shape, _ in conv_layers(MAIN_N_IMG):
        x = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=device)
        fan_in = spec.kernel ** 2 * shape[-1]
        w = torch.as_tensor((rng.standard_normal(
            (spec.kernel, spec.kernel, shape[-1], spec.out_channels))
            / np.sqrt(fan_in)).astype(np.float32), device=device)
        b = torch.as_tensor(rng.standard_normal(spec.out_channels,
                                                dtype=np.float32),
                            device=device)
        got = conv2d(x, w, b, stride=spec.stride, padding=spec.padding)
        ref = conv2d_ref(x, w, b, stride=spec.stride, padding=spec.padding)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)
        log(f"  conv2d {name} {tuple(shape)} -> {tuple(got.shape)}: max abs "
            f"err {float((got - ref).abs().max()):.3g} against conv2d_ref")
    return conv2_err


def plan_cnn_path(np, torch, device, images):
    """``LLHRPlanner.plan`` (P2 200 steps on ``device``, P1/P3 on the
    host) for four AlexNet requests on eight UAVs with a fifth of the
    memory each; seeded parameters and ``images`` seeded 227 x 227 x 3
    images per request.  Returns (planner, plan, problems, params, xs,
    planning wall in s)."""
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.planner import LLHRPlanner
    from repro_torch.core.swarm import make_devices
    from repro_torch.models.cnn import init_cnn
    planner = LLHRPlanner(RadioChannel(), position_steps=200, device=device)
    t0 = time.perf_counter()
    plan, problems = planner.plan(cnn_cost(ALEXNET),
                                  make_devices(U, mem_frac=0.2),
                                  requests=list(range(REQUESTS)))
    plan_s = time.perf_counter() - t0
    params = init_cnn(ALEXNET, torch.Generator().manual_seed(0),
                      device=device)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal(
        (images, 227, 227, 3), dtype=np.float32), device=device)
        for _ in plan.placements]
    return planner, plan, problems, params, xs, plan_s


def serve(torch, params, xs, assigns, walls=None):
    """Each request's images through ``distributed_forward`` sliced by its
    placement, one request after another, each ending in a device
    synchronise; appends each request's wall (s) to ``walls``.  Returns
    [(logits, hand-offs)]."""
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.models.cnn import distributed_forward
    outs = []
    for x, a in zip(xs, assigns):
        t0 = time.perf_counter()
        outs.append(distributed_forward(ALEXNET, params, x, a))
        torch.cuda.synchronize()
        if walls is not None:
            walls.append(time.perf_counter() - t0)
    return outs


def serve_window(torch, params, xs, assigns, min_s):
    """Serve the requests again and again for at least ``min_s`` seconds.
    Returns images/s over the whole window, the number of serves, the
    images/s of each serve and every request's wall (s)."""
    walls, per_serve = [], []
    images = sum(x.shape[0] for x in xs)
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < min_s:
        t0 = time.perf_counter()
        serve(torch, params, xs, assigns, walls)
        per_serve.append(images / (time.perf_counter() - t0))
    window_s = time.perf_counter() - t_start
    return images * len(per_serve) / window_s, len(per_serve), per_serve, \
        walls


def run_cnn_path(np, torch, device):
    """The paper's distributed inference on the card: the LLHR plan, then
    each request's batch of 32 images through ``distributed_forward``
    sliced by its placement, counted once and then timed over a window of
    at least ``CNN_WINDOW_S``."""
    from repro_torch import kernels
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.models.cnn import distributed_forward, forward
    check_fp32(torch)
    t0 = time.perf_counter()
    planner, plan, problems, params, xs, plan_s = plan_cnn_path(
        np, torch, device, MAIN_N_IMG)
    if not plan.feasible:
        raise AssertionError("CNN path: a request is infeasible")
    assigns = [s.assign for s in plan.placements]
    for r, a in enumerate(assigns):
        log(f"  request {r} (source UAV {r}): placement {a}, latency "
            f"{plan.placements[r].latency:.6f} s")
        if len(set(a)) < 2:
            raise AssertionError(f"request {r} runs on one UAV")
    parts = {k: float(v) for k, v in plan.latency_breakdown(problems).items()}
    log(f"  plan: total latency {plan.total_latency:.6f} s, power "
        f"{plan.total_power:.6f} W, breakdown {parts}, wall {plan_s:.3f} s "
        f"(P2 200 steps on the card); with parameters and inputs "
        f"{time.perf_counter() - t0:.2f} s")
    distributed_forward(ALEXNET, params, xs[0], assigns[0])      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    outs = serve(torch, params, xs, assigns)
    launches = kernels.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_conv = sum(s.kind == "conv" for s in ALEXNET.layers)
    want = only(launches, conv2d=n_conv * len(assigns))
    if launches != want:
        raise AssertionError(f"CNN path launches {launches} != {want}")
    routes = kernels.route_counts()["conv2d"]
    if routes != {"simt": 0, "wgmma": launches["conv2d"]}:
        raise AssertionError(f"CNN path conv2d launches by route {routes}, "
                             f"want all {launches['conv2d']} on the wgmma "
                             f"(3xTF32) route")
    for r, ((y, hand), x, a) in enumerate(zip(outs, xs, assigns)):
        changes = sum(p != q for p, q in zip(a[:-1], a[1:]))
        if hand != changes:
            raise AssertionError(f"request {r}: {hand} hand-offs, placement "
                                 f"has {changes} device changes")
        if y.shape != (MAIN_N_IMG, 1000) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"request {r}: bad logits {tuple(y.shape)}")
        if not torch.equal(y, forward(ALEXNET, params, x)):
            raise AssertionError(f"request {r}: sliced forward != monolithic")
    log(f"  served {len(assigns)} requests x {MAIN_N_IMG} images: launches "
        f"{launches}, conv2d by route {routes}; sliced == monolithic "
        f"bitwise; hand-offs "
        f"{[h for _, h in outs]}; peak device memory {peak_mb:.1f} MiB")
    rate, n_serves, per_serve, walls = serve_window(torch, params, xs,
                                                    assigns, CNN_WINDOW_S)
    walls_ms = sorted(w * 1e3 for w in walls)
    cnn = {"images_per_s": rate, "serves": n_serves,
           "images_per_serve": len(assigns) * MAIN_N_IMG,
           "serve_images_per_s_min": min(per_serve),
           "serve_images_per_s_max": max(per_serve),
           "request_ms_min": walls_ms[0],
           "request_ms_median": walls_ms[len(walls_ms) // 2],
           "request_ms_max": walls_ms[-1], "peak_mib": peak_mb,
           "plan_s": plan_s}
    log(f"  timed window: {n_serves} serves of {len(assigns)} requests x "
        f"{MAIN_N_IMG} images, {rate:.1f} images/s over the window (per "
        f"serve {min(per_serve):.1f} to {max(per_serve):.1f}); wall per "
        f"request min {walls_ms[0]:.4f} median "
        f"{walls_ms[len(walls_ms) // 2]:.4f} max {walls_ms[-1]:.4f} ms")

    dead = assigns[0][0]
    re_plan, _ = planner.replan_on_failure(plan, problems, dead)
    if not re_plan.feasible:
        raise AssertionError(f"replan without UAV {dead} is infeasible")
    re_assign = re_plan.placements[0].assign
    y_re, _ = distributed_forward(ALEXNET, params, xs[0], re_assign)
    if not torch.equal(y_re, outs[0][0]):
        raise AssertionError("replanned sliced forward != monolithic")
    log(f"  replan without UAV {dead}: feasible, request 0 now "
        f"{re_assign} (survivor indices), latency "
        f"{re_plan.placements[0].latency:.6f} s; its sliced forward equals "
        f"the monolithic one")

    # the same path small, card against the CPU plain path
    params_cpu = [{k: v.cpu() for k, v in p.items()} for p in params]
    x2 = xs[0][:2]
    y_gpu, _ = distributed_forward(ALEXNET, params, x2, assigns[0])
    y_cpu, _ = distributed_forward(ALEXNET, params_cpu, x2.cpu(), assigns[0])
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, atol=5e-4, rtol=1e-3)
    log(f"  N=2 logits, card against the CPU plain path: max abs err "
        f"{float((y_gpu.cpu() - y_cpu).abs().max()):.3g}")
    return launches, cnn


def time_conv2d(np, torch, device, launches, conv2_err):
    """``matmul_bias_act`` at AlexNet's five conv GEMMs as served (batch
    32, conv1's K padded to 364), each first checked against its plain
    version, beside its plain version, ``torch.addmm``, the route and tile
    its launches take and both bounds: on the tensor cores (3xTF32: three
    products at the dense TF32 peak) and in fp32 outside them.  The row's
    ``bound_ms`` is the smaller, the least time for the float32-accurate
    work.  Returns the per-layer rows and the ``kernels`` row at conv2."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.conv2d.conv2d import (conv_tile_n, gemm_route,
                                                   matmul_bias_act)
    from repro_torch.kernels.conv2d.ref import matmul_ref
    layers = []
    for i, (name, _, _, (m, k, n)) in enumerate(conv_layers(MAIN_N_IMG)):
        k += (-k) % 4                     # the served K (ops.conv2d pads)
        x, w, b = gemm_inputs(np, torch, 30 + i, m, k, n, device)
        got, route = take_route(matmul_bias_act,
                                lambda: matmul_bias_act(x, w, b))
        want_route("matmul_bias_act", route, gemm_route(k))
        torch.testing.assert_close(got, matmul_ref(x, w, b), atol=5e-4,
                                   rtol=1e-3)
        work = KERNEL_WORK["conv2d"](x, w, b)
        nbytes, nops = work.bytes, 2 * m * n * k
        t_bytes = kernel_bound(work).memory_s * 1e3
        t_simt = max(t_bytes, nops / FP32_OPS_PER_S * 1e3)
        t_tc = max(t_bytes, 3 * nops / TF32_OPS_PER_S * 1e3)
        row = {"layer": name, "M": m, "K": k, "N": n, "route": route,
               "tile": [128, conv_tile_n(m, n, sm_count(device))],
               "ms": time_ms(torch, lambda: matmul_bias_act(x, w, b),
                             CONV_ITERS, graph=True),
               "eager_ms": time_ms(torch, lambda: matmul_bias_act(x, w, b),
                                   CONV_ITERS, graph=False),
               "plain_ms": time_ms(torch, lambda: matmul_ref(x, w, b),
                                   CONV_ITERS, graph=True),
               "plain_eager_ms": time_ms(torch, lambda: matmul_ref(x, w, b),
                                         CONV_ITERS, graph=False),
               "library_ms": time_ms(torch, lambda: torch.addmm(b, x, w),
                                     CONV_ITERS, graph=True),
               "bound_ms": min(t_tc, t_simt), "bound_by": "operations"
               if min(t_tc, t_simt) > t_bytes else "bytes",
               "bound_tensor_core_ms": t_tc, "bound_fp32_simt_ms": t_simt,
               "bytes": nbytes, "operations": nops}
        row["tflops"] = nops / row["ms"] / 1e9
        layers.append(row)
        log(f"  {name} M={m} K={k} N={n} ({route} route, tile "
            f"{row['tile'][0]}x{row['tile'][1]}): kernel {row['ms']:.4f} ms "
            f"(graph), {row['eager_ms']:.4f} ms eager, {row['tflops']:.2f} "
            f"TFLOP/s; plain {row['plain_ms']:.4f} ms "
            f"({row['plain_eager_ms']:.4f} eager); torch.addmm (GEMM + "
            f"bias, no ReLU) {row['library_ms']:.4f} ms; bound "
            f"{t_tc:.4f} ms on the tensor cores (3xTF32), {t_simt:.4f} ms "
            f"in fp32 SIMT")
    c2 = next(r for r in layers if r["layer"] == "conv2")
    kernel_row = {
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d/conv2d.py:50",
        "launches": launches["conv2d"], "max_abs_err": conv2_err,
        "ms": c2["ms"], "plain_ms": c2["plain_ms"],
        "bound_ms": c2["bound_ms"], "bound_by": c2["bound_by"],
        "library_ms": c2["library_ms"], "library": "torch.addmm",
        "kernel_route": c2["route"], "tile": c2["tile"],
        "bound_tensor_core_ms": c2["bound_tensor_core_ms"],
        "bound_fp32_simt_ms": c2["bound_fp32_simt_ms"],
        "eager_ms": c2["eager_ms"], "plain_eager_ms": c2["plain_eager_ms"],
        "shape": [c2["M"], c2["K"], c2["N"]], "bytes": c2["bytes"],
        "operations": c2["operations"]}
    return layers, kernel_row


# ---------------------------------------------------------------------------
# the LM serving path: flash and decode attention kernels, gemma2-9b
# ---------------------------------------------------------------------------


def attn_inputs(torch, seed, shapes, dtype, device):
    """Standard-normal tensors of ``shapes`` drawn on the card, in
    ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(sh, generator=gen, device=device).to(dtype)
            for sh in shapes]


def flash_case(torch, seed, b, h, kv, s, d, dtype, device):
    """q, k, v as transposed views of [B, S, heads, D] tensors, the way
    the model passes them."""
    q, k, v = attn_inputs(torch, seed, [(b, s, h, d), (b, s, kv, d),
                                        (b, s, kv, d)], dtype, device)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def decode_case(torch, seed, b, kv, g, s, d, dtype, device):
    """q [B,KV,G,D]; k/v transposed views of [B, S, KV, D] caches; pos
    with 0, S - 1 and random slots between."""
    q, k, v = attn_inputs(torch, seed, [(b, kv, g, d), (b, s, kv, d),
                                        (b, s, kv, d)], dtype, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    pos = torch.randint(0, s, (b,), generator=gen, device=device,
                        dtype=torch.int32)
    pos[0] = 0
    pos[-1] = s - 1
    return q, k.transpose(1, 2), v.transpose(1, 2), pos


def decode_edge_case(torch, seed, b, kv, g, s, d, dtype, device):
    """``decode_case`` with pos at the edges of the split-KV kernel's
    splits on this card: a split's last slot (L - 1), the next one's first
    (L), the cache's last (S - 1) and 0, repeated over the batch.  Returns
    (q, k, v, pos, L); S must not be a multiple of L."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_splits
    n_split, length = decode_splits(b, kv, s, sm_count(device))
    if n_split < 2 or s % length == 0:
        raise AssertionError(f"decode edge case B={b} KV={kv} S={s}: "
                             f"{n_split} splits of {length} slots")
    q, k, v, _ = decode_case(torch, seed, b, kv, g, s, d, dtype, device)
    pos = torch.tensor(([length - 1, length, s - 1, 0] * b)[:b],
                       dtype=torch.int32, device=device)
    return q, k, v, pos, length


#: phase 10's row blocks at a query offset, (b, h, kv, sq, sk, offset, d,
#: window, cap), causal: minicpm-2b's last block of 8 at S 2,048 (rows
#: 256, keys 2,048, offset 1,792), offsets that are no multiple of a kv
#: tile (a tile straddles the shifted diagonal), with a window and a cap
FLASH_OFFSETS = [(1, 36, 36, 256, 2048, 1792, 64, 0, 0.0),
                 (1, 16, 8, 130, 450, 300, 256, 0, 50.0),
                 (1, 16, 8, 200, 1100, 900, 256, 128, 50.0),
                 (2, 8, 4, 100, 300, 129, 128, 0, 30.0),
                 (1, 4, 2, 70, 300, 129, 64, 16, 0.0)]


def check_attention_kernels(np, torch, device):
    """Both attention kernels against their plain versions on the card,
    float32 and bfloat16 at the reference's tolerance, two launches
    bitwise equal: flash at the reference's kernel-test grid, at
    gemma2-9b's prefill (B 1, H 16, KV 8, S 2048, D 256, causal, cap 50,
    window 0 and 1024), ragged S (1, 1000), the serving run's prefill
    shapes (B 8 at S 1345 and 2048), olmoe-1b-7b's (B 8, H 16, KV 16,
    S 1024, D 128) and recurrentgemma-9b's (H 16 over KV 1, D 256, window
    2048: B 8 at S 1536, and B 1 at S 3072, where the window bites), and
    row blocks at a query offset (``FLASH_OFFSETS``: minicpm-2b's last
    block of 8, offsets off a kv tile, so a tile straddles the shifted
    diagonal, causal with and without a window), each
    flash launch on the wgmma route in bfloat16 and the SIMT route in
    float32; decode at the reference's grid and gemma2-9b's decode (B 8,
    KV 8, G 2, S 4096, D 256, cap 50); bfloat16 also within one output
    rounding.  Returns the max abs errors in bfloat16 at the shapes phase
    13 times."""
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    errs = {}
    flash = [(1, 2, 2, 128, 32, True, 0, 0.0), (2, 4, 2, 256, 64, True, 0,
                                                50.0),
             (1, 2, 1, 256, 32, True, 64, 0.0), (1, 2, 2, 128, 64, False, 0,
                                                 0.0),
             (1, 8, 4, 384, 128, True, 128, 30.0),
             (1, 16, 8, 2048, 256, True, 0, 50.0),
             (1, 16, 8, 2048, 256, True, 1024, 50.0),
             (1, 16, 8, 1, 256, True, 0, 50.0),
             (1, 16, 8, 1000, 256, True, 0, 50.0),
             (8, 16, 8, 1345, 256, True, 0, 50.0),
             (8, 16, 8, 2048, 256, True, 0, 50.0),
             (8, 16, 16, 1024, 128, True, 0, 0.0),
             (8, 16, 1, 1536, 256, True, 2048, 0.0),
             (1, 16, 1, 3072, 256, True, 2048, 0.0)]
    decode = [(2, 2, 4, 512, 64, 0.0), (1, 4, 1, 1024, 32, 50.0),
              (3, 1, 8, 256, 128, 0.0), (8, 8, 2, 4096, 256, 50.0)]
    # pos at the split edges, S not a multiple of the split length:
    # gemma2's widths at a 4001-slot cache, recurrentgemma's decode (B KV
    # 8 at G 16), olmoe's D 128
    decode_edges = [(8, 8, 2, 4001, 256, 50.0), (8, 1, 16, 2048, 256, 0.0),
                    (8, 16, 1, 2001, 128, 0.0)]

    def hold(got, ref, dtype):
        torch.testing.assert_close(got.float(), ref.float(),
                                   **ATTN_TOL[str(dtype).split(".")[1]])
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), ref.float(),
                                       **ATTN_BF16_ROUNDING)

    # row blocks at a query offset: s is (q rows, keys, offset)
    flash += [(b, h, kv, (sq, sk, off), d, True, window, cap)
              for b, h, kv, sq, sk, off, d, window, cap in FLASH_OFFSETS]
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, h, kv, s, d, causal, window, cap) in enumerate(flash):
            kw = dict(causal=causal, window=window, cap=cap)
            if isinstance(s, tuple):
                q, k, v = flash_cross_case(torch, 100 + i, b, h, kv, s[0],
                                           s[1], d, dtype, device)
                kw["q_offset"] = s[2]
            else:
                q, k, v = flash_case(torch, 100 + i, b, h, kv, s, d, dtype,
                                     device)
            got, route = take_route(flash_attention, lambda: flash_attention(
                q, k, v, **kw))
            want_route("flash_attention", route,
                       "wgmma" if dtype == torch.bfloat16 else "simt")
            again = flash_attention(q, k, v, **kw)
            ref = attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention {b, h, kv, s, d}: two "
                                     f"launches differ")
            hold(got, ref, dtype)
            err = float((got.double() - ref.double()).abs().max())
            if (b, s) == (8, 2048) and dtype == torch.bfloat16:
                errs["flash_attention"] = err
            at = f"Sq={s[0]} Sk={s[1]} offset={s[2]}" \
                if isinstance(s, tuple) else f"S={s}"
            log(f"  flash_attention {str(dtype)[6:]} B={b} H={h} KV={kv} "
                f"{at} D={d} causal={causal} window={window} cap={cap}: "
                f"{route} route, max abs err {err:.3g}, two launches "
                f"bitwise equal")
        for i, (b, kv, g, s, d, cap) in enumerate(decode + decode_edges):
            if i < len(decode):
                q, k, v, pos = decode_case(torch, 200 + i, b, kv, g, s, d,
                                           dtype, device)
                edge = ""
            else:
                q, k, v, pos, length = decode_edge_case(
                    torch, 200 + i, b, kv, g, s, d, dtype, device)
                edge = f" (split length {length})"
            got = decode_attention(q, k, v, pos, cap=cap)
            again = decode_attention(q, k, v, pos, cap=cap)
            ref = decode_ref(q, k, v, pos, cap=cap)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"decode_attention {b, kv, g, s, d}: "
                                     f"two launches differ")
            hold(got, ref, dtype)
            err = float((got.double() - ref.double()).abs().max())
            if s == 4096 and dtype == torch.bfloat16:
                errs["decode_attention"] = err
            log(f"  decode_attention {str(dtype)[6:]} B={b} KV={kv} G={g} "
                f"S={s} D={d} cap={cap} pos={pos.tolist()}{edge}: max abs "
                f"err {err:.3g}, two launches bitwise equal")
    return errs


class plain_kernels:
    """Inside this block a CUDA tensor takes the LM kernels' plain
    versions (the dispatch tables' ``cuda`` entries swapped: flash and
    decode attention, the expert GEMM, the RG-LRU scan, the mLSTM chunk
    and its key-block decode step,
    and training's triples and pairs: flash forward-with-lse and
    backward, the expert GEMM and its dX and dW, the RG-LRU scan and its
    reverse scan, the mLSTM chunk and its backward, the last pair at the
    kernels' own chunks: the forward's route's, ``BWD_CHUNK``): the model
    run through it is a comparison's other side.
    ``reorder`` sums the plain versions in another order: q and k with
    their head dimension reversed, the expert GEMM with its contraction
    reversed (dX's over F too, dW's over C in two halves), the RG-LRU
    recurrence and its reverse scan as log-depth scans, the mLSTM and its
    backward in chunks of 64 (not flipped q and k: every side decodes
    from the plain side's prefill state ``C``, which a flipped k would
    not match), the
    attention backward with q, k, v, o and dO reversed alike (its
    recomputed q k^T, dO v^T and delta summed in another order).  That
    measures how far such rounding alone moves the model's output."""

    def __init__(self, reorder: bool = False):
        self.reorder = reorder

    def __enter__(self):
        from repro_torch.kernels.decode_attention import ops as dops
        from repro_torch.kernels.decode_attention.ref import decode_ref
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.flash_attention.ref import (
            attention_bwd_ref, attention_fwd_ref, attention_ref)
        from repro_torch.kernels.mlstm_chunk import ops as lops
        from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
            BWD_CHUNK, CHUNK, mlstm_route)
        from repro_torch.kernels.mlstm_chunk.ref import (
            mlstm_chunk_bwd_ref, mlstm_chunk_ref, mlstm_decode_block_ref)
        from repro_torch.kernels.moe_matmul import ops as mops
        from repro_torch.kernels.moe_matmul.ref import (moe_matmul_dw_ref,
                                                        moe_matmul_dx_ref,
                                                        moe_matmul_ref)
        from repro_torch.kernels.rglru_scan import ops as rops
        from repro_torch.kernels.rglru_scan.ref import (rglru_bwd_ref,
                                                        rglru_ref)
        tables = (fops._BY_DEVICE, dops._BY_DEVICE, mops._BY_DEVICE,
                  rops._BY_DEVICE, lops._BY_DEVICE, fops._TRAIN_BY_DEVICE,
                  mops._TRAIN_BY_DEVICE, rops._TRAIN_BY_DEVICE,
                  lops._TRAIN_BY_DEVICE, lops._BLOCK_BY_DEVICE)
        self.saved = [(t, t["cuda"]) for t in tables]
        # the key-block decode step's plain version on either side: its
        # sums are over one block's rows
        lops._BLOCK_BY_DEVICE["cuda"] = mlstm_decode_block_ref
        if self.reorder:
            def flip(x):
                return x.flip(-1)

            fops._BY_DEVICE["cuda"] = lambda q, k, v, **kw: attention_ref(
                flip(q), flip(k), v, **kw)

            def bwd(q, k, v, o, lse, do, **kw):
                dq, dk, dv = attention_bwd_ref(flip(q), flip(k), flip(v),
                                               flip(o), lse, flip(do), **kw)
                return flip(dq), flip(dk), flip(dv)
            fops._TRAIN_BY_DEVICE["cuda"] = (
                lambda q, k, v, **kw: attention_fwd_ref(flip(q), flip(k), v,
                                                        **kw), bwd)
            dops._BY_DEVICE["cuda"] = lambda q, k, v, pos, **kw: decode_ref(
                flip(q), flip(k), v, pos, **kw)
            mops._BY_DEVICE["cuda"] = lambda x, w: moe_matmul_ref(
                flip(x), w.flip(1))
            mops._TRAIN_BY_DEVICE["cuda"] = (
                mops._BY_DEVICE["cuda"],
                lambda dy, w: moe_matmul_dx_ref(flip(dy), flip(w)),
                moe_dw_halves)
            rops._BY_DEVICE["cuda"] = rglru_log_depth
            rops._TRAIN_BY_DEVICE["cuda"] = (rglru_log_depth,
                                             rglru_bwd_log_depth)
            lops._BY_DEVICE["cuda"] = lambda *a: mlstm_chunk_ref(
                *a, chunk=MLSTM_REORDER_CHUNK)
            lops._TRAIN_BY_DEVICE["cuda"] = (
                lops._BY_DEVICE["cuda"],
                lambda *a: mlstm_chunk_bwd_ref(*a, chunk=MLSTM_REORDER_CHUNK))
        else:
            fops._BY_DEVICE["cuda"] = attention_ref
            fops._TRAIN_BY_DEVICE["cuda"] = (attention_fwd_ref,
                                             attention_bwd_ref)
            dops._BY_DEVICE["cuda"] = decode_ref
            mops._BY_DEVICE["cuda"] = moe_matmul_ref
            mops._TRAIN_BY_DEVICE["cuda"] = (moe_matmul_ref,
                                             moe_matmul_dx_ref,
                                             moe_matmul_dw_ref)
            rops._BY_DEVICE["cuda"] = rglru_ref
            rops._TRAIN_BY_DEVICE["cuda"] = (rglru_ref, rglru_bwd_ref)
            lops._BY_DEVICE["cuda"] = mlstm_chunk_ref
            lops._TRAIN_BY_DEVICE["cuda"] = (
                lambda q, *a: mlstm_chunk_ref(q, *a, chunk=CHUNK[mlstm_route(
                    q.dtype, q.shape[1])]),
                lambda *a: mlstm_chunk_bwd_ref(*a, chunk=BWD_CHUNK))
        return self

    def __exit__(self, *exc):
        for table, fn in self.saved:
            table["cuda"] = fn
        return False


def rglru_log_depth(a, b, h0):
    """The RG-LRU recurrence as a Hillis-Steele scan in float32 (log2 T
    rounds of ``(A, H)[t] <- (A[t] A[t-off], A[t] H[t-off] + H[t])``), the
    initial state folded into the first step as the reference's
    ``rglru_ref`` does: the sequential recurrence's sums in another
    order."""
    import torch
    A, H = a.float(), b.float().clone()
    H[:, 0] = A[:, 0] * h0.float() + H[:, 0]
    off = 1
    while off < A.shape[1]:
        H = torch.cat([H[:, :off], A[:, off:] * H[:, :-off] + H[:, off:]], 1)
        A = torch.cat([A[:, :off], A[:, off:] * A[:, :-off]], 1)
        off *= 2
    return H.to(a.dtype), H[:, -1].to(h0.dtype)


def rglru_bwd_log_depth(a, h, h0, dh, dhT=None):
    """The RG-LRU's reverse scan in another order: lambda_t = a[t+1]
    lambda_{t+1} + dh[t] from lambda_{T-1} = dh[T-1] + dhT is the forward
    recurrence on the time-reversed sequence (coefficients a[t+1], the
    first 1, the state dhT), taken as ``rglru_log_depth`` in float32;
    then da, db and dh0 as ``rglru_bwd_ref`` forms them."""
    import torch
    f32 = torch.float32
    last = torch.zeros(h0.shape, dtype=f32, device=h0.device) \
        if dhT is None else dhT.to(f32)
    a32 = a.to(f32)
    coef = torch.cat([torch.ones_like(a32[:, :1]), a32[:, 1:].flip(1)], 1)
    lam = rglru_log_depth(coef, dh.to(f32).flip(1), last)[0].flip(1)
    prev = torch.cat([h0.to(f32)[:, None], h.to(f32)[:, :-1]], 1)
    return ((lam * prev).to(a.dtype), lam.to(a.dtype),
            (a32[:, 0] * lam[:, 0]).to(h0.dtype))


def moe_dw_halves(x, dy):
    """The expert GEMM's dW with its sum over C in two halves, each in
    float32, added, then cast: ``moe_matmul_dw_ref`` in another order."""
    import torch
    half = x.shape[1] // 2
    xt, g = x.float().transpose(1, 2), dy.float()
    return (torch.matmul(xt[..., :half], g[:, :half])
            + torch.matmul(xt[..., half:], g[:, half:])).to(x.dtype)


def lm_requests(np, cls, vocab, n, prompt, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=[int(x) for x in rng.integers(
        2, vocab, size=int(rng.integers(prompt[0], prompt[1] + 1)))],
        max_new=int(rng.integers(max_new[0], max_new[1] + 1)))
        for i in range(n)]


def tree_map(fn, tree):
    """``fn`` on every tensor of a parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def check_reduced_lms(np, torch, device, archs):
    """Reduced ``archs`` in float32 on the card against the CPU plain
    path with the same parameters: prefill (40 tokens, cache 48, so a
    32-token window rolls) and 4 decode steps' logits within atol / rtol
    1e-4, then ``ContinuousBatcher`` token ids equal (with an untied
    head: a tied random table makes greedy decoding echo the last
    token)."""
    import dataclasses
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.runtime.serve_loop import ContinuousBatcher, Request

    def pair(cfg):
        cpu = TransformerLM(cfg, device="cpu")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        return ((cpu, p_cpu), (TransformerLM(cfg, device=device),
                               tree_map(lambda t: t.to(device), p_cpu)))

    for arch in archs:
        cfg = get_arch(arch).reduced()
        (cpu, p_cpu), (gpu, p_gpu) = pair(cfg)
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
        lc, cc = cpu.prefill(p_cpu, toks, 48)
        lg, cg = gpu.prefill(p_gpu, toks.to(device), 48)
        worst = 0.0
        for i in range(5):
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
            if i == 4:
                break
            nxt = torch.argmax(lc, -1).to(torch.int32)[:, None]
            pos = torch.full((2, 1), 40 + i, dtype=torch.int32)
            lc, cc = cpu.decode_step(p_cpu, nxt, pos, cc)
            lg, cg = gpu.decode_step(p_gpu, nxt.to(device), pos.to(device),
                                     cg)
        log(f"  {cfg.name} (window {cfg.attention.window}, 40-token prompt,"
            f" cache 48): prefill + 4 decode logits, card vs CPU max abs "
            f"diff {worst:.3g}")
        untied = dataclasses.replace(cfg, tie_embeddings=False)
        outs = []
        for model, params in pair(untied):
            bat = ContinuousBatcher(model, untied,
                                    ServeConfig(max_batch=2, max_seq=64),
                                    params)
            for r in lm_requests(np, Request, cfg.vocab_size, 5, (4, 14),
                                 (3, 9), seed=7):
                bat.submit(r)
            outs.append({r.rid: r.out for r in bat.run()})
        if outs[0] != outs[1]:
            raise AssertionError(f"{cfg.name}: batcher tokens differ card "
                                 f"vs CPU: {outs}")
        log(f"  {cfg.name} untied head, ContinuousBatcher 5 requests at "
            f"max_batch 2: token ids equal card vs CPU "
            f"({sum(len(v) for v in outs[0].values())} tokens)")


class StepTimer:
    """Wraps a batcher's prefill and decode steps: each call's wall (it
    ends in a device synchronise), its kernel launches (in total and by
    route), and each
    request's time to first token (the prefill that gives a request its
    first token, from the start of ``run``).  Each call runs in the
    profiler range ``serve.prefill`` or ``serve.decode``."""

    def __init__(self, torch, batcher):
        from repro_torch import kernels
        self.torch, self.kernels, self.batcher = torch, kernels, batcher
        self.prefill, self.decode, self.ttft = [], [], {}
        self.t_start = None
        pre, dec = batcher.prefill_step, batcher.decode_step
        batcher.prefill_step = lambda *a: self._call("prefill", pre, a)
        batcher.decode_step = lambda *a: self._call("decode", dec, a)

    def _call(self, kind, fn, args):
        first = [r.rid for r in self.batcher.active if not r.out]
        before = self.kernels.launch_counts()
        routes_before = self.kernels.route_counts()
        with self.torch.profiler.record_function(f"serve.{kind}"):
            t0 = time.perf_counter()
            out = fn(*args)
            self.torch.cuda.synchronize()
            t1 = time.perf_counter()
        after = self.kernels.launch_counts()
        routes = self.kernels.route_counts()
        rows = args[1].shape[0] if kind == "prefill" else args[2].shape[0]
        (self.prefill if kind == "prefill" else self.decode).append(
            {"s": t1 - t0, "batch": rows,
             "tokens": args[1].shape[1] if kind == "prefill" else 1,
             "launches": {k: after[k] - before[k] for k in after},
             "routes": {k: {r: n - routes_before[k][r] for r, n in v.items()}
                        for k, v in routes.items()}})
        if kind == "prefill":
            for rid in first:
                self.ttft[rid] = t1 - self.t_start
        return out

    def run(self):
        self.t_start = time.perf_counter()
        return self.batcher.run()


def check_call(name, kind, launches, routes, want):
    """One served call's launches (kernel -> count) must be exactly
    ``want[kind]`` (every other kernel 0), and its launches of each kernel
    in ``SERVED_ROUTES[kind]`` (``routes``: kernel -> route -> count) all
    on the route named there (the served runs are bfloat16)."""
    if launches != only(launches, **want[kind]):
        raise AssertionError(f"{name} {kind} call launched {launches}, "
                             f"want {want[kind]}")
    for kernel, route in SERVED_ROUTES[kind].items():
        got = routes[kernel]
        if got != only(got, **{route: launches[kernel]}):
            raise AssertionError(
                f"{name} {kind} call: {kernel} launches by route {got}, "
                f"want every one of the {launches[kernel]} on the {route} "
                f"route")


def serve_lm(np, torch, model, params, scfg, requests, want):
    """Serve ``requests`` through a fresh ``ContinuousBatcher`` with the
    launch counters reset just before and read just after; every prefill
    call must launch exactly ``want["prefill"]`` and every decode step
    ``want["decode"]`` (kernel name -> launches; every other kernel 0),
    and every launch of a kernel in ``SERVED_ROUTES`` must take the route
    it names for the call's kind (the served runs are bfloat16).  Returns
    (finished requests, timer, launches, peak device MiB)."""
    from repro_torch import kernels
    from repro_torch.runtime.serve_loop import ContinuousBatcher
    batcher = ContinuousBatcher(model, model.cfg, scfg, params)
    for r in requests:
        batcher.submit(r)
    timer = StepTimer(torch, batcher)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    done = timer.run()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    for kind, calls in (("prefill", timer.prefill), ("decode", timer.decode)):
        for c in calls:
            check_call(model.cfg.name, kind, c["launches"], c["routes"], want)
    total = {k: want["prefill"].get(k, 0) * len(timer.prefill)
             + want["decode"].get(k, 0) * len(timer.decode)
             for k in launches}
    if launches != total:
        raise AssertionError(f"serving launches {launches} != {total}")
    if len(done) != len(requests) or any(
            not r.done or not 1 <= len(r.out) <= r.max_new for r in done):
        raise AssertionError("serving: a request did not finish")
    return done, timer, launches, peak


def clone_cache(cache):
    """A copy of a decode cache: a list of layer states, or under a mesh
    a ``ShardedCache`` (its positions' lists)."""
    from repro_torch.models.transformer import ShardedCache
    if isinstance(cache, ShardedCache):
        return ShardedCache(cache.sp, [clone_cache(b) for b in cache.blocks])
    return [{k: t.clone() for k, t in c.items()} for c in cache]


def lm_sides(torch, model, params, prompts, steps=4, extra=None):
    """One prefill (through ``make_prefill_step``, with ``extra``: the
    frames or patch embeddings) and ``steps`` decode steps three ways on
    the card, same weights: through the kernels, through the plain
    versions, and through the plain versions with their sums reordered.
    Every side decodes from a copy of the plain side's prefill cache and
    is fed the plain side's greedy tokens, so each step compares like
    with like.  Returns each side's logits over the prefill and the
    decode steps, and the plain side's."""
    from repro_torch.runtime.serve_loop import (decode_start,
                                                make_prefill_step)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=model.device)
    b = toks.shape[0]
    s = decode_start(model.cfg, toks, extra)
    prefill = make_prefill_step(model, model.cfg, s + steps)
    sides = {"kernels": contextlib.nullcontext,
             "reordered": lambda: plain_kernels(True)}
    with plain_kernels():
        ref, cache = prefill(params, toks, extra)
    logits = {}
    for name, ctx in sides.items():
        with ctx():
            logits[name] = [prefill(params, toks, extra)[0]]
    caches = {name: clone_cache(cache) for name in sides}
    refs = [ref]
    nxt = torch.argmax(ref, -1).to(torch.int32)[:, None]
    for i in range(steps):
        pos = torch.full((b, 1), s + i, dtype=torch.int32,
                         device=model.device)
        with plain_kernels():
            ref, cache = model.decode_step(params, nxt, pos, cache)
        refs.append(ref)
        for name, ctx in sides.items():
            with ctx():
                out, caches[name] = model.decode_step(params, nxt, pos,
                                                      caches[name])
            logits[name].append(out)
        nxt = torch.argmax(ref, -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    return logits, refs


def bf16_ulp(torch, x):
    """The spacing of bfloat16 values (8 significant bits) at each |x|,
    that of the smallest normal below it."""
    x = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)


def float32_ulp(torch, x):
    """The spacing of float32 values (24 significant bits) at each |x|,
    that of the smallest normal below it."""
    x = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 24)


def logit_gaps(torch, logits, refs):
    """Each side's max abs logit difference from the plain side over the
    prefill and the decode steps, and the largest |logit|."""
    out = {name: max(float((a.float() - r.float()).abs().max())
                     for a, r in zip(outs, refs))
           for name, outs in logits.items()}
    out["max_abs_logit"] = max(float(r.float().abs().max()) for r in refs)
    return out


def check_lm_kernels_vs_plain(torch, model, params, prompts, extra=None):
    """The kernels against the plain versions inside the full model (with
    ``extra``, its frames or patch embeddings), in its bfloat16 and with
    the same weights in float32.  Each logit's gap
    must stay within the larger of ``LM_GAP`` times the largest gap that
    reordering the plain versions' sums alone gives (one rounding of an
    activation, carried through every layer) and, in bfloat16,
    ``LM_BF16_ULPS`` ulps of that logit, in float32 ``LM_F32_TOL`` of
    it.  Returns both, with each side's worst gap in ulps where the bf16
    ulp term sets the limit."""
    import dataclasses
    from repro_torch.models import build_model
    out = {}
    logits, refs = lm_sides(torch, model, params, prompts, extra=extra)
    bf16 = logit_gaps(torch, logits, refs)
    bf16["limit_abs"] = LM_GAP * bf16["reordered"]
    bf16["limit_ulps"] = LM_BF16_ULPS
    share = 0.0
    for name, outs in logits.items():
        ulps = 0.0
        for a, r in zip(outs, refs):
            gap, ulp = (a.float() - r.float()).abs(), bf16_ulp(torch, r)
            limit = (LM_BF16_ULPS * ulp).clamp_min(bf16["limit_abs"])
            by_ulp = LM_BF16_ULPS * ulp > bf16["limit_abs"]
            if by_ulp.any():
                ulps = max(ulps, float((gap / ulp)[by_ulp].max()))
            if name == "kernels":
                share = max(share, float((gap / limit).max()))
        bf16[f"{name}_ulps_where_ulp_limit"] = ulps
    bf16["kernels_share_of_limit"] = share
    out["bfloat16"] = bf16
    if not share <= 1.0:
        raise AssertionError(
            f"{model.cfg.name} bfloat16 logits: kernels reach {share:.3g} x "
            f"the per-logit limit (the larger of {LM_GAP} x the "
            f"reordered plain's {bf16['reordered']} and {LM_BF16_ULPS} "
            f"bf16 ulps of the logit); largest gap {bf16['kernels']}, "
            f"largest |logit| {bf16['max_abs_logit']}")
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    model32 = build_model(cfg32, device=model.device)

    params32 = tree_map(lambda t: t.float(), params)
    logits, refs = lm_sides(torch, model32, params32, prompts, extra=extra)
    f32 = out["float32"] = logit_gaps(torch, logits, refs)
    f32["limit_abs"] = LM_GAP * f32["reordered"]
    f32["kernels_share_of_limit"] = max(
        float(((a - r).abs() / (LM_F32_TOL["atol"] + LM_F32_TOL["rtol"]
                                * r.abs()).clamp_min(f32["limit_abs"])).max())
        for a, r in zip(logits["kernels"], refs))
    if not f32["kernels_share_of_limit"] <= 1.0:
        raise AssertionError(
            f"{model.cfg.name} float32 logits: kernels reach "
            f"{f32['kernels_share_of_limit']:.3g} x the per-logit limit (the "
            f"larger of {LM_GAP} x the reordered plain's "
            f"{f32['reordered']} and atol {LM_F32_TOL['atol']} + rtol "
            f"{LM_F32_TOL['rtol']} of the logit); largest gap "
            f"{f32['kernels']}, largest |logit| {f32['max_abs_logit']}")
    del params32
    torch.cuda.empty_cache()
    return out


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def serve_summary(timer, reqs, done, wall, launches, peak):
    """The served run's numbers: prefill and decode-step walls, decode
    tokens/s, TTFT per request, peak memory, launches."""
    pre = [c["s"] for c in timer.prefill]
    dec = [c["s"] for c in timer.decode]
    dec_tokens = sum(c["batch"] for c in timer.decode)
    ttft = [timer.ttft[r.rid] for r in sorted(done, key=lambda r: r.rid)]
    out = {"requests": len(done),
           "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "generated_tokens": sum(len(r.out) for r in done),
           "prefill_calls": len(pre), "decode_steps": len(dec),
           "prefill_shapes": [[c["batch"], c["tokens"]]
                              for c in timer.prefill],
           "prefill_s_median": pct(pre, 50), "prefill_s_max": max(pre),
           "decode_step_ms_min": min(dec) * 1e3 if dec else None,
           "decode_step_ms_median": pct(dec, 50) * 1e3 if dec else None,
           "decode_step_ms_max": max(dec) * 1e3 if dec else None,
           "decode_tokens_per_s": dec_tokens / sum(dec) if dec else None,
           "ttft_s": ttft, "ttft_s_median": pct(ttft, 50),
           "wall_s": wall,
           "tokens_per_s": sum(len(r.out) for r in done) / wall,
           "peak_gib": peak / 1024, "launches": launches,
           "launches_by_route": {
               k: {r: sum(c["routes"][k][r]
                          for c in timer.prefill + timer.decode)
                   for r in v}
               for k, v in timer.prefill[0]["routes"].items()
               if launches[k]}}
    log(f"  served {len(done)} requests ({out['prompt_tokens']} prompt "
        f"tokens, {out['generated_tokens']} generated) in {wall:.2f} s: "
        f"{len(pre)} prefill calls (batch x tokens "
        f"{out['prefill_shapes']}), {len(dec)} decode steps; launches "
        f"{launches}, by route {out['launches_by_route']}")
    log(f"  prefill wall median {out['prefill_s_median']:.3f} s, max "
        f"{max(pre):.3f} s; decode step min / median / max "
        f"{out['decode_step_ms_min']:.2f} / "
        f"{out['decode_step_ms_median']:.2f} / "
        f"{out['decode_step_ms_max']:.2f} ms; "
        f"{out['decode_tokens_per_s']:.1f} decode tokens/s; TTFT median "
        f"{out['ttft_s_median']:.3f} s (per request "
        f"{[round(x, 3) for x in ttft]}); peak device memory "
        f"{out['peak_gib']:.2f} GiB")
    return out


def run_lm_path(np, torch, device, arch):
    """``arch`` at full width on the card, as ``SERVED[arch]`` says:
    seeded bfloat16 weights, its requests through ``ContinuousBatcher``
    (greedy), every prefill call and decode step launching exactly the
    kernels it lists; then its long request (a window rolls in prefill
    and the local layers decode from a rolling cache); then the kernels
    against the plain versions inside the model."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import Request
    spec = SERVED[arch]
    want = {"prefill": spec["prefill"], "decode": spec["decode"]}
    cfg = get_arch(arch)
    model = build_model(cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    w_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"  {cfg.name}: {n_params / 1e9:.3f} B parameters, {w_gb:.2f} GB "
        f"held, initialised on the card in {init_s:.2f} s; every prefill "
        f"call must launch {spec['prefill']}, every decode step "
        f"{spec['decode']}")
    scfg = ServeConfig(max_batch=LM_BATCH, max_seq=spec["max_seq"])
    # warm-up: cuBLAS handles and the kernels' first launches
    serve_lm(np, torch, model, params, scfg, lm_requests(
        np, Request, cfg.vocab_size, 2, (64, 64), (3, 3), seed=99), want)
    reqs = lm_requests(np, Request, cfg.vocab_size, spec["requests"],
                       spec["prompt"], spec["max_new"])
    t0 = time.perf_counter()
    done, timer, launches, peak = serve_lm(np, torch, model, params, scfg,
                                           reqs, want)
    lm = {"model": cfg.name, "max_seq": spec["max_seq"],
          **serve_summary(timer, reqs, done, time.perf_counter() - t0,
                          launches, peak),
          "init_s": init_s, "weights_gb": w_gb, "params": n_params}

    if spec["long"]:
        prompt, max_seq, max_new = spec["long"]
        long_req = lm_requests(np, Request, cfg.vocab_size, 1,
                               (prompt, prompt), (max_new, max_new), seed=1)
        done, lt, l_launches, l_peak = serve_lm(
            np, torch, model, params,
            ServeConfig(max_batch=1, max_seq=max_seq), long_req, want)
        l_dec = [c["s"] for c in lt.decode]
        lm["long"] = {"prompt_tokens": prompt, "max_seq": max_seq,
                      "generated_tokens": len(done[0].out),
                      "prefill_s": lt.prefill[0]["s"],
                      "decode_step_ms_median": pct(l_dec, 50) * 1e3
                      if l_dec else None,
                      "launches": l_launches, "peak_gib": l_peak / 1024}
        log(f"  {prompt}-token request at max_seq {max_seq}: prefill "
            f"{lt.prefill[0]['s']:.3f} s, {len(l_dec)} decode steps median "
            f"{lm['long']['decode_step_ms_median']} ms, launches "
            f"{l_launches}, peak {l_peak / 1024:.2f} GiB")
        del lt

    del timer                # it holds the batcher, which holds params
    long_prompts = [r.prompt[:LM_CHECK_TOKENS] for r in reqs
                    if len(r.prompt) >= LM_CHECK_TOKENS]
    prompts = np.asarray(long_prompts[:2], np.int32) \
        if len(long_prompts) >= 2 else np.random.default_rng(2).integers(
            2, cfg.vocab_size, (2, LM_CHECK_TOKENS)).astype(np.int32)
    diffs = check_lm_kernels_vs_plain(torch, model, params, prompts)
    lm["kernels_vs_plain_max_abs_logit_diff"] = diffs
    log_lm_gaps(diffs, f"B={len(prompts)} x {LM_CHECK_TOKENS}-token prefill")
    # the batchers' step wrappers hold them in reference cycles
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return lm


def log_lm_gaps(diffs, what):
    """Log ``check_lm_kernels_vs_plain``'s gaps, each dtype's limit and the
    kernels' share of it."""
    for dt, d in diffs.items():
        log(f"  {dt}: {what} + "
            f"4 decode steps, max abs logit diff from the plain versions: "
            f"kernels {d['kernels']:.4g}, plain with reordered sums "
            f"{d['reordered']:.4g}, largest |logit| "
            f"{d['max_abs_logit']:.4g}"
            + (f"; per logit held within the larger of "
               f"{d['limit_abs']:.4g} ({LM_GAP} x the reordered) and atol "
               f"{LM_F32_TOL['atol']} + rtol {LM_F32_TOL['rtol']} of the "
               f"logit: kernels at {d['kernels_share_of_limit']:.3g} of that "
               f"limit" if dt == "float32"
               else f"; per logit held within the larger of "
               f"{d['limit_abs']:.4g} ({LM_GAP} x the reordered) and "
               f"{LM_BF16_ULPS} bf16 ulps of the logit: kernels at "
               f"{d['kernels_share_of_limit']:.3g} of that limit; where the "
               f"ulp term sets it, kernels "
               f"{d['kernels_ulps_where_ulp_limit']:.3g} ulps, reordered "
               f"{d['reordered_ulps_where_ulp_limit']:.3g} ulps"))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def time_attention(torch, device, lm_launches, attn_errs):
    """Both attention kernels at gemma2-9b's shapes in bfloat16 (flash:
    B 8, H 16, KV 8, S 2048, D 256, causal, cap 50; decode: B 8, KV 8,
    G 2, a 4096-slot cache all valid, cap 50) beside their plain versions
    and ``F.scaled_dot_product_attention`` (no softcap: the cap-0
    variant), with the bound from this run's shapes; flash's row names the
    route its launches took (``kernel_route``; ``route`` is the build
    route, CUDA C++).  Returns the two ``kernels`` rows."""
    import torch.nn.functional as F
    from repro_torch.device import sm_count
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_splits)
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    bf = torch.bfloat16
    B, H, KV, S, D, cap = 8, 16, 8, 2048, 256, 50.0
    q, k, v = flash_case(torch, 300, B, H, KV, S, D, bf, device)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    f_work = KERNEL_WORK["flash_attention"](q, k, v, causal=True, cap=cap)
    G, SC = H // KV, 4096
    dq, dk, dv, _ = decode_case(torch, 301, B, KV, G, SC, D, bf, device)
    pos = torch.full((B,), SC - 1, dtype=torch.int32, device=device)
    d_work = KERNEL_WORK["decode_attention"](dq, dk, dv, pos, cap=cap)
    dq_h = dq.reshape(B, H, 1, D)
    cases = [
        ("flash_attention", "src/repro/kernels/flash_attention/"
         "flash_attention.py:86",
         lambda: flash_attention(q, k, v, causal=True, cap=cap),
         lambda: attention_ref(q, k, v, causal=True, cap=cap),
         lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                enable_gqa=True),
         f_work, 3, [B, H, KV, S, D]),
        ("decode_attention", "src/repro/kernels/decode_attention/"
         "decode_attention.py:68",
         lambda: decode_attention(dq, dk, dv, pos, cap=cap),
         lambda: decode_ref(dq, dk, dv, pos, cap=cap),
         lambda: F.scaled_dot_product_attention(dq_h, dk, dv,
                                                enable_gqa=True),
         d_work, 20, [B, KV, G, SC, D]),
    ]
    rows = []
    for name, replaces, kern, plain, lib, work, iters, shape in cases:
        kernel_route = (take_route(flash_attention, kern)[1]
                        if name == "flash_attention" else None)
        ms = time_ms(torch, kern, iters, graph=True)
        eager_ms = time_ms(torch, kern, iters, graph=False)
        plain_ms = time_ms(torch, plain, iters, graph=True)
        plain_eager_ms = time_ms(torch, plain, iters, graph=False)
        lib_ms = time_ms(torch, lib, iters, graph=True)
        nbytes, nops = work.bytes, work.flops
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": attn_errs[name], "ms": ms, "plain_ms": plain_ms,
            **bound_keys(work),
            "library_ms": lib_ms, "library": "F.scaled_dot_product_attention"
            " (enable_gqa, no softcap)", "eager_ms": eager_ms,
            "plain_eager_ms": plain_eager_ms, "shape": shape,
            "dtype": "bfloat16", "bytes": nbytes, "operations": nops,
            "tflops": nops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6})
        if kernel_route:
            rows[-1]["kernel_route"] = kernel_route
        if name == "decode_attention":
            rows[-1]["splits"] = list(decode_splits(B, KV, SC,
                                                    sm_count(device)))
        via = f" ({kernel_route} route)" if kernel_route else ""
        log(f"  {name} {shape} bf16{via}: {ms:.4f} ms in "
            f"a graph, {eager_ms:.4f}"
            f" ms eager ({nops / ms / 1e9:.2f} TFLOP/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s); plain {plain_ms:.4f} ms "
            f"({plain_eager_ms:.4f} eager); SDPA (cap 0) {lib_ms:.4f} ms; "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})")
    return rows


def time_decode_g16(torch, device, served):
    """Decode attention at recurrentgemma-9b's served decode shape in
    bfloat16 (B 8, KV 1, G 16, its 2048-slot window cache all valid, D
    256, no cap), first checked against its plain version, beside the
    plain version, ``F.scaled_dot_product_attention`` with ``enable_gqa``
    and its bytes bound.  Returns the entry for the decode row's
    ``g16`` key (its launches: recurrentgemma's served run)."""
    import torch.nn.functional as F
    from repro_torch.device import sm_count
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_splits)
    from repro_torch.kernels.decode_attention.ref import decode_ref
    B, KV, G, S, D = 8, 1, 16, 2048, 256
    q, k, v, _ = decode_case(torch, 302, B, KV, G, S, D, torch.bfloat16,
                             device)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=device)
    got = decode_attention(q, k, v, pos)
    want = decode_ref(q, k, v, pos)
    torch.testing.assert_close(got.float(), want.float(),
                               **ATTN_BF16_ROUNDING)
    q_h = q.reshape(B, KV * G, 1, D)
    work = KERNEL_WORK["decode_attention"](q, k, v, pos)
    nbytes, nops = work.bytes, work.flops
    kern = lambda: decode_attention(q, k, v, pos)            # noqa: E731
    plain = lambda: decode_ref(q, k, v, pos)                 # noqa: E731
    entry = {
        "shape": [B, KV, G, S, D], "dtype": "bfloat16",
        "launches": served["recurrentgemma-9b"]["launches"][
            "decode_attention"],
        "max_abs_err": float((got.double() - want.double()).abs().max()),
        "ms": time_ms(torch, kern, 20, graph=True),
        "eager_ms": time_ms(torch, kern, 20, graph=False),
        "plain_ms": time_ms(torch, plain, 20, graph=True),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q_h, k, v, enable_gqa=True), 20, graph=True),
        "library": "F.scaled_dot_product_attention (enable_gqa)",
        **bound_keys(work),
        "splits": list(decode_splits(B, KV, S, sm_count(device))),
        "bytes": nbytes, "operations": nops}
    entry["gb_per_s"] = nbytes / entry["ms"] / 1e6
    log(f"  decode_attention {entry['shape']} bf16 (splits "
        f"{entry['splits']}): max abs err {entry['max_abs_err']:.3g}; "
        f"{entry['ms']:.4f} ms in a graph ({entry['gb_per_s']:.1f} GB/s), "
        f"{entry['eager_ms']:.4f} eager; plain {entry['plain_ms']:.4f} ms; "
        f"SDPA {entry['library_ms']:.4f} ms; bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return entry


# ---------------------------------------------------------------------------
# MoE and griffin serving: the expert GEMM and RG-LRU scan kernels
# ---------------------------------------------------------------------------


def moe_operands(torch, seed, e, c, d, f, dtype, device):
    """x ~ N(0, 1) [E, C, D] and w ~ N(0, 1/D) [E, D, F] drawn on the card
    in float32, then cast to ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((e, c, d), generator=gen, device=device)
    w = torch.randn((e, d, f), generator=gen, device=device) / d ** 0.5
    return x.to(dtype), w.to(dtype)


def rglru_operands(torch, seed, b, t, w, dtype, device):
    """a = sigmoid(N(0, 1)), b = 0.1 N(0, 1) [B, T, W] and h0 = N(0, 1)
    [B, W] drawn on the card in float32, then cast to ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, t, w), generator=gen, device=device))
    bb = 0.1 * torch.randn((b, t, w), generator=gen, device=device)
    h0 = torch.randn((b, w), generator=gen, device=device)
    return a.to(dtype), bb.to(dtype), h0.to(dtype)


def hold_moe_matmul(torch, seed, shape, dtype, device):
    """The expert GEMM at ``shape`` (E, C, D, F) on seeded operands
    against its plain version within ``MOE_TOL`` and the reference's TOL,
    on the wgmma route in bfloat16 where TMA takes D and F (multiples of
    8), else on simt, two launches bitwise equal.  Returns the max abs
    error."""
    from repro_torch.kernels.moe_matmul.moe_matmul import moe_matmul
    from repro_torch.kernels.moe_matmul.ref import moe_matmul_ref
    e, c, d, f = shape
    dname = str(dtype).split(".")[1]
    x, w = moe_operands(torch, seed, e, c, d, f, dtype, device)
    got, route = take_route(moe_matmul, lambda: moe_matmul(x, w))
    want_route("moe_matmul", route,
               "wgmma" if dtype == torch.bfloat16 and d % 8 == 0
               and f % 8 == 0 else "simt")
    again = moe_matmul(x, w)
    ref = moe_matmul_ref(x, w)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"moe_matmul {e, c, d, f}: two launches differ")
    for tol in (MOE_TOL[dname](d), MOE_REF_TOL[dname](d)):
        torch.testing.assert_close(got.float(), ref.float(), **tol)
    err = float((got.double() - ref.double()).abs().max())
    log(f"  moe_matmul {dname} E={e} C={c} D={d} F={f}: {route} route, max "
        f"abs err {err:.3g}, two launches bitwise equal")
    return err


def check_moe_rglru_kernels(np, torch, device):
    """The expert GEMM, the RG-LRU scan and decode attention at G = 16
    against their plain versions on the card, float32 and bfloat16, two
    launches bitwise equal.  Expert GEMM at the reference's kernel-test
    grid and olmoe-1b-7b's GEMMs (E 64, D/F 2048/1024 both ways) at
    prefill (C = 8 x 240, and the served run's 1144, not a multiple of
    64) and decode (C = 8), a ragged C 97 and a D and F that are not
    multiples of 8, within ``MOE_TOL`` and the reference's TOL, each
    launch on the wgmma route in bfloat16 where TMA takes the shape (D
    and F multiples of 8) and the SIMT route otherwise; RG-LRU scan at
    the reference's grid, recurrentgemma-9b's prefill (B 8, T 1536, W
    4096) and a W 102 that TMA cannot read, bitwise, each launch on the
    route its dtype and W give (``tma`` where rows are a multiple of 16
    bytes, ``simt`` otherwise); decode attention at recurrentgemma's
    decode (B 8, KV 1, G 16, a 2048-slot window cache, D 256) within
    ``ATTN_TOL`` and, in
    bfloat16, one output rounding, then with its log-sum-exp
    (``hold_decode_lse``).  Phase 18 checks both kernels again at the
    shapes it times."""
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_route,
                                                          rglru_scan)
    moe = [(4, 64, 96, 160), (8, 32, 128, 64), (2, 128, 64, 256),
           (64, 1920, 2048, 1024), (64, 1920, 1024, 2048),
           (64, 1144, 2048, 1024), (64, 1144, 1024, 2048), (8, 97, 200, 72),
           (3, 40, 100, 36), (64, 8, 2048, 1024), (64, 8, 1024, 2048)]
    scans = [(2, 64, 256), (1, 128, 128), (3, 32, 384), (8, 1536, 4096),
             (2, 37, 102)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for i, shape in enumerate(moe):
            hold_moe_matmul(torch, 400 + i, shape, dtype, device)
        for i, (b, t, w) in enumerate(scans):
            a, bb, h0 = rglru_operands(torch, 450 + i, b, t, w, dtype, device)
            (h, hT), route = take_route(rglru_scan,
                                        lambda: rglru_scan(a, bb, h0))
            want_route("rglru_scan", route, rglru_route(dtype, t, w))
            h2, hT2 = rglru_scan(a, bb, h0)
            rh, rhT = rglru_ref(a, bb, h0)
            torch.cuda.synchronize()
            if not (torch.equal(h, h2) and torch.equal(hT, hT2)):
                raise AssertionError(f"rglru_scan {b, t, w}: two launches "
                                     f"differ")
            if not (torch.equal(h, rh) and torch.equal(hT, rhT)):
                n_diff = int((h != rh).sum())
                raise AssertionError(f"rglru_scan {dname} {b, t, w}: "
                                     f"{n_diff} elements differ from the "
                                     f"plain version")
            log(f"  rglru_scan {dname} B={b} T={t} W={w} ({route} route): "
                f"bitwise equal to the sequential plain version, two "
                f"launches bitwise equal")
            del a, bb, h0, h, h2, rh
        for edge in (False, True):
            if edge:
                q, k, v, pos, length = decode_edge_case(
                    torch, 501, 8, 1, 16, 2048, 256, dtype, device)
            else:
                q, k, v, pos = decode_case(torch, 500, 8, 1, 16, 2048, 256,
                                           dtype, device)
            got = decode_attention(q, k, v, pos)
            again = decode_attention(q, k, v, pos)
            ref = decode_ref(q, k, v, pos)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("decode_attention G=16: two launches "
                                     "differ")
            torch.testing.assert_close(got.float(), ref.float(),
                                       **ATTN_TOL[dname])
            if dtype == torch.bfloat16:
                torch.testing.assert_close(got.float(), ref.float(),
                                           **ATTN_BF16_ROUNDING)
            err = float((got.double() - ref.double()).abs().max())
            log(f"  decode_attention {dname} B=8 KV=1 G=16 S=2048 D=256 "
                f"pos={pos.tolist()}"
                f"{f' (split length {length})' if edge else ''}: max abs "
                f"err {err:.3g}, two launches bitwise equal")
        hold_decode_lse(torch, dtype, device)


#: phase 14's decode attention with its log-sum-exp, (b, kv, g, s, d,
#: cap): gemma2-9b's G 2 at phase 54's block of a 1,040-slot cache split
#: over 16, and over a whole 4,096-slot cache; recurrentgemma-9b's G 16
#: (the tensor-core kernel in bfloat16)
DECODE_LSE = [(8, 8, 2, 1040 // 16, 256, 50.0), (8, 1, 16, 512, 256, 0.0),
              (4, 8, 2, 4096, 256, 50.0)]


def hold_decode_lse(torch, dtype, device):
    """Phase 14: ``decode_attention(return_lse=True)`` against its plain
    version at ``DECODE_LSE``: the output (float32) rounded to the dtype
    bitwise the call without the lse, it within ``ATTN_TOL`` (bf16 also
    ``ATTN_BF16_ROUNDING``) and the lse within float32's, rows whose pos
    is
    negative (a block wholly past the position) 0 and ``-inf``, no NaN;
    two launches bitwise equal."""
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_ref
    dname = str(dtype).split(".")[1]
    for i, (b, kv, g, s, d, cap) in enumerate(DECODE_LSE):
        q, k, v, _ = decode_case(torch, 520 + i, b, kv, g, s, d, dtype,
                                 device)
        pos = torch.tensor(([-1, s - 1, 0, -s, s // 2, 3, -2, s - 2] * b)[:b],
                           dtype=torch.int32, device=device)
        out, lse = decode_attention(q, k, v, pos, cap=cap, return_lse=True)
        out2, lse2 = decode_attention(q, k, v, pos, cap=cap,
                                      return_lse=True)
        plain = decode_attention(q, k, v, pos, cap=cap)
        ref, ref_lse = decode_ref(q, k, v, pos, cap=cap, return_lse=True)
        torch.cuda.synchronize()
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"decode_attention lse {b, kv, g, s, d}: "
                                 f"two launches differ")
        if out.dtype != torch.float32 or not torch.equal(out.to(dtype),
                                                          plain):
            raise AssertionError(f"decode_attention lse {b, kv, g, s, d}: "
                                 f"the output moved when lse was asked for")
        empty = pos < 0
        if not (bool(torch.isneginf(lse[empty]).all()) and
                not bool(out[empty].any()) and
                not bool(torch.isnan(ref).any() | torch.isnan(ref_lse).any())):
            raise AssertionError(f"decode_attention lse {b, kv, g, s, d}: "
                                 f"an empty row is not 0 and -inf")
        torch.testing.assert_close(out, ref, **ATTN_TOL[dname])
        if dtype == torch.bfloat16:
            torch.testing.assert_close(out, ref, **ATTN_BF16_ROUNDING)
        torch.testing.assert_close(lse, ref_lse, **ATTN_TOL["float32"])
        full = ~empty
        err = float((lse[full] - ref_lse[full]).abs().max())
        log(f"  decode_attention {dname} with lse B={b} KV={kv} G={g} S={s} "
            f"D={d} cap={cap} pos={pos.tolist()}: output bitwise the call "
            f"without it, lse max abs err {err:.3g}, empty rows 0 and -inf, "
            f"two launches bitwise equal")


def held_at_timed_shape(torch, name, got, want, d):
    """A timed kernel's output against its plain version's on the same
    operands: the expert GEMM within ``MOE_TOL`` and the reference's TOL
    (contraction ``d``), the RG-LRU scan's ``(h, hT)`` bitwise.  Returns
    the max abs error, which the timed row reports."""
    if name == "rglru_scan":
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("rglru_scan at the timed shape differs "
                                 "from the sequential plain version")
        got, want = got[0], want[0]
    else:
        for tol in (MOE_TOL["bfloat16"](d), MOE_REF_TOL["bfloat16"](d)):
            torch.testing.assert_close(got.float(), want.float(), **tol)
    return float((got.double() - want.double()).abs().max())


def time_moe_rglru(torch, device, served):
    """The expert GEMM and the RG-LRU scan at the served shapes in
    bfloat16, beside their plain versions, ``torch.bmm`` (the expert
    GEMM; no single PyTorch call computes the recurrence) and their
    bounds from this run's shapes.  Expert GEMM: olmoe's w_in GEMM (D
    2048, F 1024) at the largest served prefill's rows (B x cap) and at a
    decode step's 8 rows; RG-LRU scan: recurrentgemma's largest served
    prefill (B x T, W 4096).  Each is first checked against its plain
    version at the shape it is timed at; each row names the route its
    launches took.  Returns the two ``kernels`` rows."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.moe_matmul.moe_matmul import moe_matmul
    from repro_torch.kernels.moe_matmul.ref import moe_matmul_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    from repro_torch.models.moe import capacity
    bf = torch.bfloat16
    ocfg = get_arch("olmoe-1b-7b")
    om = served["olmoe-1b-7b"]
    pb, ps = max(om["prefill_shapes"], key=lambda bs: bs[0] * bs[1])
    E, D, F = ocfg.moe.n_experts, ocfg.d_model, ocfg.moe.d_expert
    rows = []

    def moe_case(c):
        x, w = moe_operands(torch, 600 + c, E, c, D, F, bf, device)
        return (lambda: moe_matmul(x, w), lambda: moe_matmul_ref(x, w),
                lambda: torch.bmm(x, w), KERNEL_WORK["moe_matmul"](x, w))

    gm = served["recurrentgemma-9b"]
    gb, gt = max(gm["prefill_shapes"], key=lambda bs: bs[0] * bs[1])
    W = get_arch("recurrentgemma-9b").rglru_width
    a, b, h0 = rglru_operands(torch, 700, gb, gt, W, bf, device)
    cases = [
        ("moe_matmul", "src/repro/kernels/moe_matmul/moe_matmul.py:44",
         [E, pb * capacity(ps, ocfg.moe.top_k, E, ocfg.moe.capacity_factor),
          D, F], om["launches"]["moe_matmul"]),
        ("rglru_scan", "src/repro/kernels/rglru_scan/rglru_scan.py:41",
         [gb, gt, W], gm["launches"]["rglru_scan"]),
    ]
    for name, replaces, shape, launches in cases:
        if name == "moe_matmul":
            kern, plain, lib, work = moe_case(shape[1])
            iters, plain_graph = 5, True
        else:
            kern = lambda: rglru_scan(a, b, h0)              # noqa: E731
            plain = lambda: rglru_ref(a, b, h0)              # noqa: E731
            lib = None
            work = KERNEL_WORK["rglru_scan"](a, b, h0)
            iters, plain_graph = 20, False    # plain: T steps of launches
        nbytes, nops = work.bytes, work.flops
        got, kernel_route = take_route(
            moe_matmul if name == "moe_matmul" else rglru_scan, kern)
        err = held_at_timed_shape(torch, name, got, plain(), D)
        ms = time_ms(torch, kern, iters, graph=True)
        eager_ms = time_ms(torch, kern, iters, graph=False)
        plain_ms = time_ms(torch, plain, iters if plain_graph else 1,
                           graph=plain_graph)
        plain_eager_ms = time_ms(torch, plain, iters if plain_graph else 1,
                                 graph=False)
        lib_ms = time_ms(torch, lib, iters, graph=True) if lib else None
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{name}.cu",
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **bound_keys(work),
               "library_ms": lib_ms,
               "library": "torch.bmm" if lib else None,
               "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
               "plain_timing": "graph" if plain_graph else "eager",
               "shape": shape, "dtype": "bfloat16", "bytes": nbytes,
               "operations": nops, "tflops": nops / ms / 1e9,
               "gb_per_s": nbytes / ms / 1e6}
        row["kernel_route"] = kernel_route
        if name == "moe_matmul":
            dk, dp, dl, dwork = moe_case(LM_BATCH)
            got, d_route = take_route(moe_matmul, dk)
            d_err = held_at_timed_shape(torch, name, got, dp(), D)
            d_ms = time_ms(torch, dk, 20, graph=True)
            row["decode"] = {
                "shape": [E, LM_BATCH, D, F], "max_abs_err": d_err,
                "ms": d_ms,
                "eager_ms": time_ms(torch, dk, 20, graph=False),
                "plain_ms": time_ms(torch, dp, 20, graph=True),
                "library_ms": time_ms(torch, dl, 20, graph=True),
                "bound_ms": kernel_bound(dwork).bound_s * 1e3,
                "gb_per_s": dwork.bytes / d_ms / 1e6,
                "kernel_route": d_route}
            log(f"  moe_matmul decode {row['decode']['shape']} bf16 "
                f"({d_route} route): "
                f"max abs err {d_err:.3g}; {d_ms:.4f} ms in a graph ({row['decode']['gb_per_s']:.1f} "
                f"GB/s), {row['decode']['eager_ms']:.4f} eager; plain "
                f"{row['decode']['plain_ms']:.4f} ms; torch.bmm "
                f"{row['decode']['library_ms']:.4f} ms; bound "
                f"{row['decode']['bound_ms']:.4f} ms (bytes)")
        rows.append(row)
        log(f"  {name} {shape} bf16 ({kernel_route} route): max abs err "
            f"{err:.3g}"
            f"{' (bitwise)' if name == 'rglru_scan' else ''}; "
            f"{ms:.4f} ms in a graph, {eager_ms:.4f}"
            f" ms eager ({nops / ms / 1e9:.2f} TFLOP/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s); plain {plain_ms:.4f} ms "
            f"({row['plain_timing']}; {plain_eager_ms:.4f} eager)"
            + (f"; torch.bmm {lib_ms:.4f} ms" if lib else "")
            + f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# xLSTM serving: the chunkwise mLSTM kernel
# ---------------------------------------------------------------------------


def mlstm_operands(torch, seed, b, s, h, d, dtype, device):
    """The reference kernel test's distributions drawn on the card in
    float32 (q, k, v ~ 0.5 N(0, 1) [B, S, H, D] cast to ``dtype``; i ~
    N(0, 1), f ~ N(3, 1) [B, S, H]) and a nonzero state (C ~ 0.1 N(0, 1),
    n ~ 0.1 N(0, 1), m ~ N(0, 1)): the kernel's arguments after
    ``scale``'s place."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = (0.5 * randn(b, s, h, d) for _ in range(3))
    ip, fp = randn(b, s, h), randn(b, s, h) + 3.0
    state = (0.1 * randn(b, h, d, d), 0.1 * randn(b, h, d), randn(b, h))
    return (q.to(dtype), k.to(dtype), v.to(dtype), ip, fp) + state


def held_mlstm(torch, got, want, dtype):
    """The kernel's (h, C, n, m) against the plain version's: h within
    ``MLSTM_TOL`` (bfloat16: ``MLSTM_BF16_TOL``), the state within
    ``MLSTM_TOL``.  Returns h's max abs error."""
    torch.testing.assert_close(
        got[0].float(), want[0].float(),
        **(MLSTM_TOL if dtype == torch.float32 else MLSTM_BF16_TOL))
    for a, r in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, r, **MLSTM_TOL)
    return float((got[0].double() - want[0].double()).abs().max())


def check_mlstm_kernel(np, torch, device):
    """The chunkwise mLSTM kernel against its plain version on the card
    from nonzero states, float32 and bfloat16, two launches bitwise
    equal: the reference's kernel-test grid, xlstm-350m's prefill (B 8,
    H 4, D 256 at S 1024 and at S 1000, whose last chunk is ragged on
    both routes) and decode (S 1), and S at the wgmma route's chunk edges
    (63, 64, 65, 129); each launch on the route its dtype and S give
    (bfloat16 with S > 1 ``wgmma``, S 1 ``decode``, float32 with S > 1
    ``simt``).  Phase 22 checks it again at the shapes it times."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (mlstm_chunk,
                                                            mlstm_route)
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    cases = [(2, 128, 3, 32), (1, 64, 2, 64), (2, 256, 1, 32),
             (8, 1024, 4, 256), (8, 1000, 4, 256), (8, 1, 4, 256),
             (2, 63, 4, 256), (2, 64, 4, 256), (2, 65, 4, 256),
             (2, 129, 4, 256), (2, 37, 2, 16)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for i, (b, s, h, d) in enumerate(cases):
            args = mlstm_operands(torch, 800 + i, b, s, h, d, dtype, device)
            scale = 1.0 / d ** 0.5
            got, route = take_route(mlstm_chunk,
                                    lambda: mlstm_chunk(*args, scale))
            want_route("mlstm_chunk", route, mlstm_route(dtype, s))
            again = mlstm_chunk(*args, scale)
            ref = mlstm_chunk_ref(*args, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                raise AssertionError(f"mlstm_chunk {b, s, h, d}: two "
                                     f"launches differ")
            err = held_mlstm(torch, got, ref, dtype)
            state_err = max(float((a - r).abs().max())
                            for a, r in zip(got[1:], ref[1:]))
            log(f"  mlstm_chunk {dname} B={b} S={s} H={h} D={d} ({route} "
                f"route): h max abs err {err:.3g}, state {state_err:.3g}, "
                f"two launches bitwise equal")
            del args, got, again, ref


def time_mlstm(torch, device, served):
    """The mLSTM kernel at xlstm-350m's largest served prefill (B x S, H 4,
    D 256) and at a decode step (B 8, S 1) in bfloat16, beside its plain
    version and its bounds from this run's shapes (no single PyTorch call
    computes the recurrence).  Each is first checked against its plain
    version at the shape it is timed at and names the route its launches
    took; the prefill also at one (b, h) sequence of the same length.
    The prefill carries two bounds, on the tensor cores (its
    ``wgmma`` route's products, the split ones counted twice, at the bf16
    peak) and in fp32 SIMT (the ``simt`` route's chunks of 32 at the
    fp32 peak); ``bound_ms`` is the smaller, as the conv rows' is.
    Returns the ``kernels`` row."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    bf = torch.bfloat16
    cfg = get_arch("xlstm-350m")
    H, D = cfg.attention.n_heads, cfg.head_dim
    xm = served["xlstm-350m"]
    pb, ps = max(xm["prefill_shapes"], key=lambda bs: bs[0] * bs[1])
    scale = 1.0 / D ** 0.5

    def case(b, s, seed, h=H):
        args = mlstm_operands(torch, seed, b, s, h, D, bf, device)
        kern = lambda: mlstm_chunk(*args, scale)            # noqa: E731
        plain = lambda: mlstm_chunk_ref(*args, scale)       # noqa: E731
        got, route = take_route(mlstm_chunk, kern)
        err = held_mlstm(torch, got, plain(), bf)
        work = KERNEL_WORK["mlstm_chunk"](*args, scale)
        nbytes, nops = work.bytes, work.flops
        # the simt route's count: the same call in float32
        simt_ops = KERNEL_WORK["mlstm_chunk"](
            *(t.to("meta", torch.float32) for t in args), scale).flops
        t_bytes = kernel_bound(work).memory_s * 1e3
        t_simt = max(t_bytes, simt_ops / FP32_OPS_PER_S * 1e3)
        t_tc = max(t_bytes, nops / BF16_OPS_PER_S * 1e3) \
            if route == "wgmma" else None
        bound = min(t_simt, t_tc) if t_tc else t_simt
        ms = time_ms(torch, kern, 20, graph=True)
        return {"shape": [b, s, h, D], "kernel_route": route,
                "max_abs_err": err, "ms": ms,
                "eager_ms": time_ms(torch, kern, 20, graph=False),
                "plain_ms": time_ms(torch, plain, 5, graph=True),
                "plain_eager_ms": time_ms(torch, plain, 5, graph=False),
                "bound_ms": bound,
                "bound_by": "bytes" if bound <= t_bytes else "operations",
                "bound_tensor_core_ms": t_tc, "bound_fp32_simt_ms": t_simt,
                "bytes": nbytes, "operations": nops,
                "operations_fp32_simt": simt_ops,
                "tflops": nops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6}

    pre = case(pb, ps, 900)
    dec = case(LM_BATCH, 1, 901)
    # one (b, h) sequence alone: its D / 64 blocks on an otherwise idle
    # card; as long as the served prefill's 32 sequences, so the time is
    # each block's chunk chain and not the card's throughput
    one = case(1, ps, 902, h=1)
    row = {"name": "mlstm_chunk", "route": "cuda",
           "source": "src/repro_torch/csrc/mlstm_chunk.cu",
           "replaces": "src/repro/kernels/mlstm_chunk/mlstm_chunk.py:81",
           "launches": xm["launches"]["mlstm_chunk"],
           "library_ms": None, "library": None, "plain_timing": "graph",
           "dtype": "bfloat16", **pre, "decode": dec, "one_sequence": one}
    for name, r in (("prefill", pre), ("decode", dec),
                    ("one sequence", one)):
        tc = r["bound_tensor_core_ms"]
        log(f"  mlstm_chunk {name} {r['shape']} bf16 ({r['kernel_route']} "
            f"route): max abs err {r['max_abs_err']:.3g}; {r['ms']:.4f} ms "
            f"in a graph, {r['eager_ms']:.4f} ms eager "
            f"({r['tflops']:.2f} TFLOP/s, {r['gb_per_s']:.1f} GB/s); plain "
            f"{r['plain_ms']:.4f} ms (graph; {r['plain_eager_ms']:.4f} "
            f"eager); bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            + (f"{tc:.4f} ms on the tensor cores, " if tc else "")
            + f"{r['bound_fp32_simt_ms']:.4f} ms in fp32 SIMT)")
    return row


#: phase 23: the batched wrappers' scenarios and source slots, the
#: simulated frames, and the example's P2 steps and swarm
EVAL_B, EVAL_SOURCES, EVAL_T, EVAL_P2_STEPS, EVAL_U = 4096, 4, 8, 80, 6


def eval_wrappers(np, torch, device):
    """``solve_chain_dp_batched`` and ``solve_chain_dp_multisource`` at
    AlexNet, U 8, B ``EVAL_B``: one fused launch each, bitwise the CPU's.
    Returns their rows."""
    from repro_torch import kernels
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.batch import (solve_chain_dp_batched,
                                        solve_chain_dp_multisource)
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.positions import hex_init
    from repro_torch.core.swarm import make_devices
    from repro_torch.kernels.link_geometry.ref import link_geometry_ref
    from repro_torch.core.channel import RadioParams
    rng = np.random.default_rng(23)
    mc, devs = cnn_cost(ALEXNET), make_devices(U)
    pos = hex_init(U, 40.0, jitter=0.5)[None] + rng.normal(
        0.0, 8.0, (EVAL_B, U, 2))
    active = rng.random((EVAL_B, U)) >= 0.1
    rate = link_geometry_ref(torch.as_tensor(pos, dtype=torch.float32),
                             torch.as_tensor(active), None,
                             params=RadioParams())[2].numpy()
    args = ([x.flops for x in mc.layers], [x.weight_bytes for x in mc.layers],
            [x.act_bits for x in mc.layers], mc.input_bits,
            [d.mem_cap for d in devs], [d.compute_cap for d in devs],
            [d.throughput for d in devs], rate)
    order = tuple(int(o) for o in rng.permutation(U))
    rows = {}
    for name, fn, src in (
            ("solve_chain_dp_batched", solve_chain_dp_batched,
             rng.integers(0, U, EVAL_B)),
            ("solve_chain_dp_multisource", solve_chain_dp_multisource,
             rng.integers(0, U, (EVAL_B, EVAL_SOURCES)))):
        fn(*args, src, active, order, device=device)            # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        assign, lat = fn(*args, src, active, order, device=device)
        wall = time.perf_counter() - t0                 # results on host
        launches = kernels.launch_counts()
        routes = kernels.route_counts()["tropical_dp"]
        want = only(launches, tropical_dp=1)
        if launches != want or routes != {"fused": 1, "step": 0}:
            raise AssertionError(f"{name}: launches {launches} != {want}, "
                                 f"routes {routes}")
        ref = fn(*args, src, active, order, device="cpu")
        if assign.dtype != np.int64 or lat.dtype != np.float64 or not (
                np.array_equal(assign, ref[0])
                and np.array_equal(lat, ref[1])):
            raise AssertionError(f"{name}: the card's result is not the "
                                 "CPU's bit for bit")
        feas = np.isfinite(lat)
        if not feas.any():
            raise AssertionError(f"{name}: no feasible placement")
        rows[name] = {"B": EVAL_B, "slots": 1 if src.ndim == 1 else
                      src.shape[1], "U": U, "L": len(mc.layers),
                      "launches": launches["tropical_dp"],
                      "route": "fused", "wall_s": wall,
                      "feasible": int(feas.sum()), "solves": int(lat.size),
                      "mean_latency_s": float(lat[feas].mean())}
        log(f"  {name} AlexNet U={U} B={EVAL_B} slots "
            f"{rows[name]['slots']}: 1 fused launch, bitwise the CPU's; "
            f"feasible {rows[name]['feasible']}/{lat.size}, wall "
            f"{wall:.4f} s")
    return rows


def eval_contingency(np, torch, device):
    """A ``ContingencyTable`` at AlexNet, U 8, refreshed twice at moved
    positions: each refresh 1 link-geometry + 1 fused chain-DP launch
    and the CPU's table.  Returns the refreshes' rows."""
    from repro_torch import kernels
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.positions import hex_init
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.scenario_engine import (ContingencyTable,
                                                     PlanFnCache,
                                                     ScenarioEngine)
    base = hex_init(U, 40.0, jitter=0.5, seed=23)
    tables = [ContingencyTable(ScenarioEngine(
        RadioChannel(), make_devices(U), cnn_cost(ALEXNET),
        plan_cache=PlanFnCache(), device=d), base, source=0)
        for d in (device, "cpu")]
    rng = np.random.default_rng(230)
    rows = []
    for k in range(2):
        moved = base + rng.normal(0.0, 4.0, base.shape)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tables[0].refresh(moved, source=k)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        routes = kernels.route_counts()["tropical_dp"]
        want = only(launches, link_geometry=1, tropical_dp=1)
        if launches != want or routes != {"fused": 1, "step": 0}:
            raise AssertionError(f"contingency refresh {k}: launches "
                                 f"{launches} != {want}, routes {routes}")
        tables[1].refresh(moved, source=k)
        for name, got in tables[0].plans.items():
            ref = tables[1].plans[name]
            if got.assign != ref.assign or got.dead_index != ref.dead_index:
                raise AssertionError(f"contingency refresh {k}: plan "
                                     f"{name} differs card vs CPU")
            np.testing.assert_allclose(got.latency, ref.latency, rtol=1e-5)
            np.testing.assert_allclose(got.power, ref.power, rtol=1e-5)
        feasible = sum(np.isfinite(p.latency)
                       for p in tables[0].plans.values())
        if not np.isfinite(tables[0].plans[None].latency):
            raise AssertionError("contingency: the nominal plan is "
                                 "infeasible")
        rows.append({"refresh": k, "U": U, "scenarios": U + 1,
                     "launches": {"link_geometry": 1, "tropical_dp": 1},
                     "wall_s": wall, "feasible": int(feasible),
                     "nominal_latency_s": tables[0].plans[None].latency})
        log(f"  ContingencyTable U={U} refresh {k}: 1 + 1 launches, the "
            f"CPU's table; {feasible}/{U + 1} plans feasible, wall "
            f"{wall:.4f} s")
    return rows


def eval_swarm(np, torch, device):
    """``SwarmSim`` at the example's configuration: per model, LLHR on the
    rollout (T + T launches) and both baselines on the legacy loop (no
    launch); Fig. 5's ordering; then the failure row.  Returns the
    rows and the launches of the LLHR runs."""
    from repro_torch import kernels
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.configs.lenet import LENET
    from repro_torch.core.baselines import HeuristicPlanner, RandomPlanner
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.placement import solve_chain_dp
    from repro_torch.core.planner import LLHRPlanner
    from repro_torch.core.swarm import (SwarmSim, average_power,
                                        latency_summary, make_devices)
    ch = RadioChannel()

    def run(model, cfg, name, planner, fail=False):
        sim = SwarmSim(cnn_cost(cfg), make_devices(EVAL_U), planner,
                       requests_per_frame=REQUESTS,
                       failure_frame=1 if fail else -1, failure_uav=2,
                       device=device)
        t0 = time.perf_counter()
        sim.run(frames=EVAL_T)                       # builds + warms
        first = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = sim.run(frames=EVAL_T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        routes = kernels.route_counts()["tropical_dp"]
        llhr = name == "LLHR"
        want = only(launches, link_geometry=EVAL_T, tropical_dp=EVAL_T) \
            if llhr else only(launches)
        want_routes = {"fused": EVAL_T if llhr else 0, "step": 0}
        if launches != want or routes != want_routes:
            raise AssertionError(f"SwarmSim {model} {name}: launches "
                                 f"{launches} != {want}, routes {routes}")
        s = latency_summary(stats)
        if len(stats) != EVAL_T or not all(
                np.isfinite(x.latency) and x.latency > 0
                for x in stats if x.feasible):
            raise AssertionError(f"SwarmSim {model} {name}: frames")
        row = {"model": model, "planner": name, "frames": EVAL_T,
               "U": EVAL_U, "requests_per_frame": REQUESTS,
               "failure": [1, 2] if fail else None,
               "mean_latency_s": s.mean_latency,
               "feasibility_rate": s.feasibility_rate,
               "average_power_w": average_power(stats),
               "replanned": [x.t for x in stats if x.replanned],
               "launches": {k: v for k, v in launches.items() if v},
               "first_s": first, "wall_s": wall}
        log(f"  SwarmSim {model:8s} {name:9s}{' +failure@1' * fail}: mean "
            f"latency {s.mean_latency:.6f} s, feasible "
            f"{s.feasibility_rate:.3f}, power "
            f"{row['average_power_w'] * 1e3:.2f} mW, launches "
            f"{row['launches']}, wall {wall:.3f} s (first {first:.3f} s)")
        return stats, s, row

    def llhr_planner():
        return LLHRPlanner(ch, placement_solver=solve_chain_dp,
                           position_steps=EVAL_P2_STEPS, device=device)

    rows = []
    for model, cfg in (("lenet", LENET), ("alexnet", ALEXNET)):
        _, lat, row = run(model, cfg, "LLHR", llhr_planner())
        rows.append(row)
        for name, planner in (("heuristic", HeuristicPlanner(
                ch, device=device)), ("random", RandomPlanner(
                    ch, device=device))):
            _, base, row = run(model, cfg, name, planner)
            rows.append(row)
            if not (lat.mean_latency <= base.mean_latency + 1e-9 and
                    lat.feasibility_rate >= base.feasibility_rate):
                raise AssertionError(f"SwarmSim {model}: LLHR {lat} does "
                                     f"not dominate {name} {base}")
    stats, _, row = run("lenet", LENET, "LLHR", llhr_planner(), fail=True)
    rows.append(row)
    if not stats[1].replanned or not all(x.feasible for x in stats):
        raise AssertionError("SwarmSim failure row: frame 1 not replanned "
                             "or a frame infeasible")
    return rows


def eval_positions_legacy(np, torch, device):
    """``solve_positions_legacy`` at U 8, 800 steps on the card: every
    pair at least 2R apart.  Returns its row."""
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.positions import solve_positions_legacy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_positions_legacy(U, RadioChannel(), steps=800, device=device)
    wall = time.perf_counter() - t0                  # positions on host
    d = np.sqrt(((sol.positions[:, None] - sol.positions[None]) ** 2)
                .sum(-1))
    d[np.eye(U, dtype=bool)] = np.inf
    if d.min() < 40.0 - 1e-3 or sol.max_violation != 0.0 or \
            not np.isfinite(sol.objective):
        raise AssertionError(f"solve_positions_legacy: min distance "
                             f"{d.min()} m (2R = 40 m), violation "
                             f"{sol.max_violation}")
    log(f"  solve_positions_legacy U={U} 800 steps: min distance "
        f"{d.min():.3f} m, objective {sol.objective:.6f}, wall {wall:.3f} s")
    return {"U": U, "steps": 800, "min_distance_m": float(d.min()),
            "objective": sol.objective, "wall_s": wall}


def run_eval_path(np, torch, device):
    """Phase 23: the paper's evaluation path.  Returns the
    ``swarm_eval`` record."""
    return {"wrappers": eval_wrappers(np, torch, device),
            "contingency": eval_contingency(np, torch, device),
            "swarm_sim": eval_swarm(np, torch, device),
            "positions_legacy": eval_positions_legacy(np, torch, device)}


#: phase 24: the figure scripts (their smoke grids, and Fig. 5's full grid)
FIGURES = ("fig2_latency_power", "fig3_latency_memory", "fig4_min_power",
           "fig5_request_scaling")
#: the figures' P2 tolerance on the smoke rows' derived column against the
#: CPU plain path (ROADMAP section 3: rtol 1e-3 at U 4 and 5, latency
#: within 1e-3 at U 6), plus one unit of the printed last digit
FIG_RTOL = 1e-3
#: phase 24's replanner: ticks, period, scenarios a refresh, and its
#: lookahead's frames and trajectories (AlexNet, U 8, fused P2)
SERVE_TICKS, SERVE_PERIOD, SERVE_B, SERVE_H, SERVE_TRAJ = 10, 5, 128, 8, 32
#: the gateway soak (``tests/test_gateway.py``'s): UAVs, window frames,
#: windows, and the device stall's failed attempts
SOAK_U, SOAK_T, SOAK_WINDOWS, SOAK_STALLS = 4, 4, 5, 1


@contextlib.contextmanager
def counted_rollouts(torch, calls):
    """Inside the block, every ``FleetRollout.run`` appends (its frames, the
    launches it made, its chain-DP launches by route) to ``calls``: the
    counters read just before and just after the call, the device
    drained at both reads.  The counters themselves are left running, so
    a caller that set them to 0 sees every launch of its block."""
    from repro_torch import kernels
    from repro_torch.runtime.fleet_rollout import FleetRollout
    run = FleetRollout.run

    def counts():
        torch.cuda.synchronize()
        return kernels.launch_counts(), kernels.route_counts()["tropical_dp"]

    def counted(self, *args, **kw):
        launches0, routes0 = counts()
        trace = run(self, *args, **kw)
        launches1, routes1 = counts()
        calls.append((trace.n_frames,
                      {k: v - launches0[k] for k, v in launches1.items()},
                      {k: v - routes0[k] for k, v in routes1.items()}))
        return trace

    FleetRollout.run = counted
    try:
        yield
    finally:
        FleetRollout.run = run


def want_rollout_calls(what, calls, n=None):
    """Each rollout call made exactly ``frames`` link-geometry and
    ``frames`` fused chain-DP launches and no step launch."""
    if not calls or (n is not None and len(calls) != n):
        raise AssertionError(f"{what}: {len(calls)} rollout calls, want "
                             f"{n or 'some'}")
    for frames, launches, routes in calls:
        want = only(launches, link_geometry=frames, tropical_dp=frames)
        if launches != want or routes != {"fused": frames, "step": 0}:
            raise AssertionError(f"{what}: a {frames}-frame rollout call "
                                 f"made {launches}, routes {routes}")


def figure_rows(torch, module, argv, calls):
    """One figure script's CSV rows through its ``main``, its rollout
    calls counted; raises if anything launched outside them."""
    import importlib
    import io
    from repro_torch import kernels
    out = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with counted_rollouts(torch, calls), contextlib.redirect_stdout(out):
        importlib.import_module(f"benchmarks.{module}").main(argv)
    torch.cuda.synchronize()
    outside = {k: v - sum(c[1][k] for c in calls)
               for k, v in kernels.launch_counts().items()}
    if any(outside.values()):
        raise AssertionError(f"{module}: launches outside the rollout "
                             f"calls {outside}")
    return [line.split(",") for line in out.getvalue().splitlines()]


def serving_figures(np, torch, device):
    """The four figure scripts' ``--smoke`` grids on the card (default
    device), held against the CPU plain path and the paper's trends, then
    Fig. 5's full grid.  Returns the figures' record."""
    record = {}
    derived = {}
    for fig in FIGURES:
        calls = []
        t0 = time.perf_counter()
        got = figure_rows(torch, f"torch_{fig}", ["--smoke"], calls)
        wall = time.perf_counter() - t0
        want_rollout_calls(fig, calls)
        ref = figure_rows(torch, f"torch_{fig}",
                          ["--smoke", "--device", "cpu"], [])
        if [r[0] for r in got] != [r[0] for r in ref]:
            raise AssertionError(f"{fig}: rows {[r[0] for r in got]}")
        for r, g in zip(ref, got):
            if g[3] != r[3]:
                raise AssertionError(f"{r[0]}: feasibility {g[3]} on the "
                                     f"card, {r[3]} on the CPU")
            a, b = float(g[2]), float(r[2])
            if "/heuristic/" in r[0] or "/random/" in r[0]:
                tol = 0.0                       # host numpy in both runs
            else:
                tol = FIG_RTOL * abs(b) + 10.0 ** -len(r[2].split(".")[1])
            if abs(a - b) > tol:
                raise AssertionError(f"{r[0]}: {a} on the card, {b} on the "
                                     "CPU")
            derived[g[0]] = a
        record[fig] = {"rows": [",".join(r) for r in got],
                       "rollout_calls": len(calls), "wall_s": wall}
        log(f"  {fig} --smoke: {len(got)} rows, {len(calls)} rollout calls "
            f"of T link-geometry + T fused chain-DP launches, the CPU's "
            f"feasibility and derived values; wall {wall:.3f} s")
    trends = [("fig2/bw=10MHz/uavs=4/pmax=120mW",
               "fig2/bw=10MHz/uavs=4/pmax=40mW"),
              ("fig4/lenet/uavs=4/bw=20MHz", "fig4/lenet/uavs=4/bw=10MHz")]
    trends += [(f"fig5/llhr/requests={rq}", f"fig5/{base}/requests={rq}")
               for rq in (2, 8) for base in ("heuristic", "random")]
    for lo, hi in trends:
        if not derived[lo] < derived[hi]:
            raise AssertionError(f"trend: {lo} {derived[lo]} is not below "
                                 f"{hi} {derived[hi]}")
    log("  the paper's trends hold: " + "; ".join(
        f"{lo} {derived[lo]} < {hi} {derived[hi]}" for lo, hi in trends))
    calls = []
    t0 = time.perf_counter()
    full = figure_rows(torch, "torch_fig5_request_scaling", [], calls)
    wall = time.perf_counter() - t0
    want_rollout_calls("fig5 full grid", calls, 10)     # warm + steady
    llhr = {r[0].rsplit("=", 1)[1]: r for r in full if "/llhr/" in r[0]}
    if len(full) != 15 or any(r[3] != "1.000" for r in llhr.values()):
        raise AssertionError(f"fig5 full grid: rows {full}")
    for r in full:        # a baseline's infeasible frames read inf / < 1
        mine = llhr[r[0].rsplit("=", 1)[1]]
        if r is not mine and not (float(mine[2]) < float(r[2])
                                  and float(r[3]) <= float(mine[3])):
            raise AssertionError(f"fig5 full grid: LLHR {mine} does not "
                                 f"dominate {r}")
    record["fig5_full"] = {"rows": [",".join(r) for r in full],
                           "rollout_calls": len(calls), "wall_s": wall}
    log(f"  fig5 full grid: 5 LLHR points (10 rollout calls) and 10 "
        f"baseline runs, LLHR feasible and under both baselines at every "
        f"request count; wall {wall:.3f} s")
    return record


def serving_replanner(np, torch, device):
    """``PeriodicReplanner`` over an AlexNet U 8 engine with fused P2 and
    a ``FleetRollout`` lookahead: ``SERVE_TICKS`` ticks at period
    ``SERVE_PERIOD``.  A refresh is one ``plan_batch`` (1 link-geometry +
    1 fused chain-DP launch; P2 launches no planner kernel) and one
    ``SERVE_H``-frame lookahead (``SERVE_H`` + ``SERVE_H``); a tick
    between refreshes launches nothing.  Returns its record."""
    from repro_torch import kernels
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.positions import hex_init
    from repro_torch.core.rollout import PositionSpec, RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.scenario_engine import (PlanFnCache,
                                                     ScenarioEngine,
                                                     ScenarioGenerator)
    from repro_torch.runtime.serve_loop import PeriodicReplanner
    cache, ch, mc, devs = PlanFnCache(), RadioChannel(), cnn_cost(ALEXNET), \
        make_devices(U)
    p2 = PositionSpec(steps=30)
    engine = ScenarioEngine(ch, devs, mc, plan_cache=cache, position_spec=p2,
                            device=device)
    rollout = FleetRollout(ch, devs, mc, RolloutSpec(
        frames=SERVE_H, requests_per_frame=REQUESTS, jitter_sigma_m=1.0,
        failure_prob=0.02, recovery_prob=0.5), plan_cache=cache,
        position_spec=p2, seed=24, device=device)
    base = hex_init(U, 40.0, jitter=0.5, seed=24)
    rp = PeriodicReplanner(
        engine, ScenarioGenerator(base, pos_sigma_m=2.0, failure_prob=0.05,
                                  shadow_sigma_db=2.0, seed=24),
        period=SERVE_PERIOD, n_scenarios=SERVE_B, rollout=rollout,
        rollout_horizon=SERVE_H, rollout_trajectories=SERVE_TRAJ)
    per_refresh = only(kernels.launch_counts(), link_geometry=1 + SERVE_H,
                       tropical_dp=1 + SERVE_H)
    ticks = []
    for frame in range(SERVE_TICKS):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hit = rp.tick(frame)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        want = per_refresh if hit else only(launches)
        routes = kernels.route_counts()["tropical_dp"]
        if launches != want or routes["step"]:
            raise AssertionError(f"replanner tick {frame}: launches "
                                 f"{launches} != {want}, routes {routes}")
        ticks.append({"frame": frame, "refresh": hit, "wall_s": wall})
    refreshes = [t["frame"] for t in ticks if t["refresh"]]
    if refreshes != list(range(0, SERVE_TICKS, SERVE_PERIOD)) or \
            rp.retraces != 0 or not np.isfinite(rp.nominal_latency) or \
            not 0.0 < rp.horizon_feasibility <= 1.0:
        raise AssertionError(f"replanner: refreshes {refreshes}, retraces "
                             f"{rp.retraces}, nominal {rp.nominal_latency},"
                             f" horizon {rp.horizon_feasibility}")
    walls = [t["wall_s"] for t in ticks if t["refresh"]]
    log(f"  PeriodicReplanner AlexNet U={U} B={SERVE_B} + {SERVE_H}-frame "
        f"lookahead x {SERVE_TRAJ}: refreshes at {refreshes}, each "
        f"{1 + SERVE_H} + {1 + SERVE_H} launches; nominal "
        f"{rp.nominal_latency:.4f} s, p95 {rp.robust_latency(95):.4f} s, "
        f"horizon feasibility {rp.horizon_feasibility:.3f}; refresh walls "
        f"{', '.join(f'{w:.3f}' for w in walls)} s")
    return {"U": U, "scenarios": SERVE_B, "horizon": SERVE_H,
            "trajectories": SERVE_TRAJ, "p2_steps": p2.steps,
            "launches_per_refresh": {"link_geometry": 1 + SERVE_H,
                                     "tropical_dp": 1 + SERVE_H},
            "refreshes": refreshes, "refresh_walls_s": walls,
            "first_refresh_s": walls[0],
            "nominal_latency_s": rp.nominal_latency,
            "robust_latency_p95_s": rp.robust_latency(95),
            "horizon_feasibility": rp.horizon_feasibility}


def chaos_stack(device, uavs, replan_fn):
    """``tests/test_chaos.py``'s live stack on ``device``: LeNet split over
    ``uavs`` UAVs, an engine and its contingency table, a tracker and a
    runner, a 3-frame lookahead and the SLO controller."""
    from repro_torch.configs.lenet import LENET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.positions import hex_init
    from repro_torch.core.rollout import RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,
                                                     HealthTracker)
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.scenario_engine import (ContingencyTable,
                                                     PlanFnCache,
                                                     ScenarioEngine,
                                                     ScenarioGenerator)
    from repro_torch.runtime.serve_loop import (PeriodicReplanner,
                                                ReplanController,
                                                ServiceLevelObjective)
    cache, ch, mc = PlanFnCache(), RadioChannel(), cnn_cost(LENET)
    devs = make_devices(uavs, mem_frac=2e-4)
    base = hex_init(uavs, 40.0, jitter=0.5, seed=1)
    engine = ScenarioEngine(ch, devs, mc, plan_cache=cache, device=device)
    tracker = HealthTracker([d.name for d in devs], timeout_s=2.5, now=0.0)
    runner = FaultTolerantRunner(
        devs, replan_fn, ".", health=tracker,
        contingency=ContingencyTable(engine, base, source=0))
    rp = PeriodicReplanner(
        engine, ScenarioGenerator(base, pos_sigma_m=1.0, seed=0), period=4,
        n_scenarios=2, rollout=FleetRollout(
            ch, devs, mc, RolloutSpec(frames=3), plan_cache=cache, seed=0,
            device=device),
        rollout_horizon=3, rollout_trajectories=2)
    ctl = ReplanController(
        rp, ServiceLevelObjective(min_horizon_feasibility=0.25),
        runner=runner)
    return base, tracker, runner, rp, ctl


def chaos_ladder(device, uavs, schedule):
    """One ladder script through ``ChaosHostDriver`` frame by frame."""
    from repro_torch.runtime.chaos import ChaosHostDriver

    def replan(survivors):
        return {"devices": [d.name for d in survivors]}

    base, tracker, runner, rp, ctl = chaos_stack(device, uavs, replan)
    drv = ChaosHostDriver(schedule, tracker, base, frame_s=1.0)
    modes = [ctl.step(t, now=drv.play_frame(t))
             for t in range(schedule.frames)]
    plan = runner.state.plan
    return {"modes": modes, "events": runner.events,
            "metrics": ctl.metrics(), "retraces": rp.retraces,
            "plan": plan if isinstance(plan, dict) else list(plan.assign)}


def chaos_rollout(device):
    """A 4-frame rollout of LeNet split over 4 UAVs on ``device``."""
    from repro_torch.configs.lenet import LENET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.rollout import RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.scenario_engine import PlanFnCache
    return FleetRollout(RadioChannel(), make_devices(4, mem_frac=2e-4),
                        cnn_cost(LENET), RolloutSpec(frames=4),
                        plan_cache=PlanFnCache(), device=device)


def serving_chaos(np, torch, device):
    """The chaos ladder's two scripts of ``tests/test_chaos.py`` on the
    card and on the CPU: the same rungs, modes, metrics and runner
    events, no build after the first refresh; then a -200 dB blackout
    (``gain_scale`` 1e-20 on the source's links) through the rollout:
    exactly the faded frames infeasible, as on the CPU.  Returns its
    record."""
    from repro_torch.core.positions import hex_init
    from repro_torch.runtime.chaos import FaultSchedule
    scripts = {
        "single_crash": (4, lambda: FaultSchedule(4, 10, seed=0).crash(3, 2),
                         ["contingency"]),
        "burst": (5, lambda: FaultSchedule(5, 10, seed=2).burst(
            3, 3, center=1, persistence=0.95), ["live_replan"])}
    record = {}
    for name, (uavs, schedule, rung) in scripts.items():
        calls = []
        t0 = time.perf_counter()
        with counted_rollouts(torch, calls):
            got = chaos_ladder(device, uavs, schedule())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want_rollout_calls(f"chaos {name}", calls)
        ref = chaos_ladder("cpu", uavs, schedule())
        for k in ("modes", "events", "metrics", "plan"):
            if got[k] != ref[k]:
                raise AssertionError(f"chaos {name}: {k} {got[k]} on the "
                                     f"card, {ref[k]} on the CPU")
        rungs = [r for e in got["metrics"]["events"] for r in e["rungs"]]
        if rungs[:1] != rung or got["retraces"] or \
                got["metrics"]["n_unrecovered"]:
            raise AssertionError(f"chaos {name}: rungs {rungs}, retraces "
                                 f"{got['retraces']}, metrics "
                                 f"{got['metrics']}")
        record[name] = {"rungs": rungs, "events": got["events"],
                        "rollout_calls": len(calls), "wall_s": wall}
        log(f"  chaos {name}: rungs {rungs}, runner events "
            f"{[(e['kind'], e.get('dead')) for e in got['events']]}, the "
            f"CPU's ladder; {len(calls)} lookaheads; wall {wall:.3f} s")
    T, B = 4, 2
    pos = hex_init(4, 40.0, jitter=0.5, seed=1)
    inputs = FaultSchedule(4, T, seed=0).link_fade(
        1, db=-200.0, uav=0, frames=2).rollout_inputs(B, pos)
    traces, calls = [], []
    for dev in (device, "cpu"):
        with counted_rollouts(torch, calls if dev == device else []):
            traces.append(chaos_rollout(dev).run(
                pos, n_trajectories=B, sources=np.zeros((T, B), np.int64),
                **inputs))
    want_rollout_calls("blackout", calls, 1)
    lat = traces[0].latency
    if not (np.isfinite(lat[:, [0, 3]]).all() and np.isinf(lat[:, 1:3]).all()
            and np.array_equal(traces[0].feasible, traces[1].feasible)
            and np.array_equal(traces[0].assign, traces[1].assign)):
        raise AssertionError(f"blackout: latency {lat} on the card, "
                             f"{traces[1].latency} on the CPU")
    np.testing.assert_allclose(lat[:, [0, 3]], traces[1].latency[:, [0, 3]],
                               rtol=1e-5)
    record["blackout"] = {"db": -200.0, "frames": T,
                          "infeasible_frames": [1, 2]}
    log("  blackout -200 dB on UAV 0's links, frames 1-2: those frames "
        "infeasible, the others feasible, as on the CPU")
    return record


def soak(device, cache):
    """``tests/test_gateway.py``'s soak on ``device``: a flood, a stall, a
    burst, a crash and a skew over ``SOAK_WINDOWS`` windows."""
    from repro_torch.configs.lenet import LENET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.positions import hex_init
    from repro_torch.core.rollout import RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.chaos import FaultSchedule
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.gateway import (GatewayConfig, LoadGenerator,
                                             StreamingGateway)
    U, T = SOAK_U, SOAK_T
    ro = FleetRollout(RadioChannel(), make_devices(U, mem_frac=2e-4),
                      cnn_cost(LENET), RolloutSpec(
                          frames=T, requests_per_frame=3, recovery_prob=0.5),
                      plan_cache=cache, seed=0, device=device)
    sched = (FaultSchedule(U, T * SOAK_WINDOWS, seed=5)
             .burst(frame=6, size=2, persistence=0.7)
             .crash(frame=10, uav=0, frames=4)
             .arrival_flood(8, 3.0, frames=4)
             .device_stall(4, attempts=SOAK_STALLS)
             .clock_skew(12, -1.0, frames=4))
    gw = StreamingGateway(
        ro, hex_init(U, 40.0, jitter=0.5, seed=1), GatewayConfig(
            window_frames=T, frame_s=1.0, queue_capacity=24,
            frame_capacity=3, retry_base_backoff_s=0.001, max_attempts=3),
        schedule=sched, seed=0)
    gen = LoadGenerator(U, kind="burst", rate=1.0, deadline_s=9.0, seed=7,
                        priorities=(0, 1), priority_weights=(0.2, 0.8))
    t0 = time.perf_counter()
    try:
        report = gw.serve(gen, n_windows=SOAK_WINDOWS)
    finally:
        gw.close()
    return gw, report, time.perf_counter() - t0


def soak_outcomes(gw):
    return ([(r.rid, r.outcome, r.frame, r.window) for r in gw.requests],
            dict(gw.shed_counts), [a.tolist() for a in gw.arrival_tensors])


def serving_gateway(np, torch, device):
    """The gateway soak on the card, twice on one plan cache: the
    invariants, a bitwise replay on one built rollout, the stall's
    retries, no failed window, ``SOAK_T`` + ``SOAK_T`` launches a window
    (counted in the worker's rollout calls, read after ``serve``
    returns); the outcomes the CPU's soak gives.  Returns its record."""
    from repro_torch.runtime.gateway import SERVED, SHED_REASONS
    from repro_torch.runtime.scenario_engine import PlanFnCache
    cache, passes = PlanFnCache(), []
    for _ in range(2):
        calls = []
        with counted_rollouts(torch, calls):
            gw, report, wall = soak(device, cache)
        want_rollout_calls("gateway soak", calls, SOAK_WINDOWS)
        passes.append((gw, report, wall, dict(cache.builds)))
    (gw, report, wall, builds), (gw2, report2, wall2, builds2) = passes
    outcomes = [r.outcome for r in gw.requests]
    bad = []
    if not all(o == SERVED or o in SHED_REASONS for o in outcomes) or \
            report["served"] + report["shed_total"] != report["submitted"]:
        bad.append("an outcome missing or twice")
    if report["deadline_hit_rate"] != 1.0 or report["retries"] != \
            SOAK_STALLS or report["windows_failed"] or \
            report["device_failures"]:
        bad.append(f"report {report}")
    if report2 != report or soak_outcomes(gw2) != soak_outcomes(gw) or \
            [r.latency_s for r in gw2.requests] != \
            [r.latency_s for r in gw.requests]:
        bad.append("the replay differs")
    rollout_keys = [k for k in builds if k[0] == "rollout"]
    if len(rollout_keys) != 1 or builds[rollout_keys[0]] != 1 or \
            builds2 != builds:
        bad.append(f"builds {builds} then {builds2}")
    cpu = soak("cpu", PlanFnCache())[0]
    if soak_outcomes(cpu) != soak_outcomes(gw):
        bad.append("outcomes differ from the CPU's soak")
    if bad:
        raise AssertionError("gateway soak: " + "; ".join(bad))
    log(f"  gateway soak U={SOAK_U} T={SOAK_T} x {SOAK_WINDOWS} windows: "
        f"{report['submitted']} submitted, {report['served']} served, shed "
        f"{report['shed']}, retries {report['retries']}, replayed bitwise "
        f"on one built rollout, the CPU's outcomes; walls {wall:.3f} / "
        f"{wall2:.3f} s")
    return {"windows": SOAK_WINDOWS, "frames_per_window": SOAK_T,
            "launches_per_window": {"link_geometry": SOAK_T,
                                    "tropical_dp": SOAK_T},
            "report": report, "walls_s": [wall, wall2],
            "window_wall_s": [wall / SOAK_WINDOWS, wall2 / SOAK_WINDOWS]}


def serving_examples(np, torch, device):
    """The two ported examples on the card: the quickstart (LeNet planned,
    run sliced through conv2d: 2 + 2 launches, sliced == monolithic) and
    the scenario-planning example (5 planning calls of 1 link-geometry +
    1 fused chain-DP launch each).  Returns their record."""
    import importlib.util
    import io
    from repro_torch import kernels
    record = {}
    for name, want in (("torch_quickstart", {"conv2d": 4}),
                       ("torch_scenario_planning",
                        {"link_geometry": 5, "tropical_dp": 5})):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "examples", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = mod.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        if launches != only(launches, **want):
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        ok = (out["sliced_equals_monolithic"] and out["replan_feasible"]) \
            if name == "torch_quickstart" else (
                out["feasible"] > 0 and out["refreshed_at"] == [0, 5]
                and out["retraces"] == 0
                and out["p2_min_separation_m"] >= 40.0 - 1e-3)
        if not ok:
            raise AssertionError(f"{name}: {out}")
        record[name] = dict(out, wall_s=wall, launches=want)
        log(f"  examples/{name}.py on the card: {out}; launches {want}; "
            f"wall {wall:.3f} s")
    return record


def run_serving_path(np, torch, device):
    """Phase 24: the figure scripts and the serving layers.  Returns the
    ``serving`` record."""
    record = {}
    for part, fn in (("figures", serving_figures),
                     ("replanner", serving_replanner),
                     ("chaos", serving_chaos),
                     ("gateway", serving_gateway),
                     ("examples", serving_examples)):
        t0 = time.perf_counter()
        record[part] = fn(np, torch, device)
        record[part + "_wall_s"] = time.perf_counter() - t0
    return record


# ---------------------------------------------------------------------------
# whisper-tiny (audio) and qwen2-vl-2b (M-RoPE, patch embeddings)
# ---------------------------------------------------------------------------

#: phase 25's flash cases (B, H, KV, Sq, Sk, D, causal): whisper's
#: encoder (non-causal at S 1,500 = 23 x 64 + 28), its cross-attention
#: from the prompt and from a 448-token prefill, ragged cross lengths,
#: and qwen2-vl's causal prefill at GQA 12 / 2
SLICE_FLASH = ([(4, 6, 6, 1500, 1500, 64, False),
                (4, 6, 6, 16, 1500, 64, False),
                (4, 6, 6, 448, 1500, 64, False)]
               + [(2, 6, 6, sq, sk, 64, False) for sq in (1, 63, 65)
                  for sk in (1, 1000)]
               + [(4, 12, 2, 1280, 1280, 128, True)])
#: phase 25's decode cases (B, KV, G, S, D, pos): whisper's cross cache
#: with every slot valid, qwen2-vl's decode with pos at the split edges
SLICE_DECODE = [(4, 6, 1, 1500, 64, "last"), (8, 2, 6, 2048, 128, "edges")]


def flash_cross_case(torch, seed, b, h, kv, sq, sk, d, dtype, device):
    """q [B, H, Sq, D], k/v [B, KV, Sk, D] as transposed views of
    [B, S, heads, D] tensors, the way the model passes them."""
    q, k, v = attn_inputs(torch, seed, [(b, sq, h, d), (b, sk, kv, d),
                                        (b, sk, kv, d)], dtype, device)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def check_slice_attention(np, torch, device):
    """Phase 25: ``SLICE_FLASH`` and ``SLICE_DECODE`` against the plain
    versions in float32 and bfloat16 (``ATTN_TOL``, bf16 also
    ``ATTN_BF16_ROUNDING``), two launches bitwise equal, each flash
    launch on its dtype's route.  Returns the bfloat16 max abs errors at
    the shapes phase 29 times."""
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    errs = {}

    def hold(name, got, again, ref, dtype):
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        torch.testing.assert_close(got.float(), ref.float(),
                                   **ATTN_TOL[str(dtype).split(".")[1]])
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), ref.float(),
                                       **ATTN_BF16_ROUNDING)
        return float((got.double() - ref.double()).abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, h, kv, sq, sk, d, causal) in enumerate(SLICE_FLASH):
            q, k, v = flash_cross_case(torch, 500 + i, b, h, kv, sq, sk, d,
                                       dtype, device)
            got, route = take_route(flash_attention, lambda: flash_attention(
                q, k, v, causal=causal))
            want_route("flash_attention", route,
                       "wgmma" if dtype == torch.bfloat16 else "simt")
            err = hold(f"flash_attention {b, h, kv, sq, sk, d}", got,
                       flash_attention(q, k, v, causal=causal),
                       attention_ref(q, k, v, causal=causal), dtype)
            if dtype == torch.bfloat16 and sk == 1500 and sq in (1500, 448):
                errs["encoder" if sq == sk else "cross"] = err
            log(f"  flash_attention {str(dtype)[6:]} B={b} H={h} KV={kv} "
                f"Sq={sq} Sk={sk} D={d} causal={causal}: {route} route, "
                f"max abs err {err:.3g}, two launches bitwise equal")
        for i, (b, kv, g, s, d, where) in enumerate(SLICE_DECODE):
            if where == "last":
                q, k, v, _ = decode_case(torch, 600 + i, b, kv, g, s, d,
                                         dtype, device)
                pos = torch.full((b,), s - 1, dtype=torch.int32,
                                 device=device)
            else:
                q, k, v, pos, _ = decode_edge_case(torch, 600 + i, b, kv, g,
                                                   s, d, dtype, device)
            err = hold(f"decode_attention {b, kv, g, s, d}",
                       decode_attention(q, k, v, pos),
                       decode_attention(q, k, v, pos),
                       decode_ref(q, k, v, pos), dtype)
            if dtype == torch.bfloat16:
                errs["cross_decode" if g == 1 else "vlm_decode"] = err
            log(f"  decode_attention {str(dtype)[6:]} B={b} KV={kv} G={g} "
                f"S={s} D={d} pos={pos.tolist()}: max abs err {err:.3g}, "
                f"two launches bitwise equal")
    return errs


def extra_inputs(np, torch, cfg, b, s, n_extra, seed, device):
    """Seeded prompt tokens [B, S] and the ``make_prefill_step`` extra of
    ``cfg``: whisper's frames [B, n_extra, d] or the VLM's patch
    embeddings [B, n_extra, d] (standard normal, float32), on ``device``."""
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           dtype=torch.int32, device=device)
    extra = torch.as_tensor(rng.normal(size=(b, n_extra, cfg.d_model)),
                            dtype=torch.float32, device=device)
    return toks, extra


def check_reduced_extra(np, torch, device):
    """Phase 26: the reduced whisper-tiny (frames of 16 and a ragged 37)
    and qwen2-vl-2b (8 patch embeddings) in float32 on the card against
    the CPU plain path with the same parameters, through
    ``make_prefill_step``: a 40-token prompt, the cache 4 slots longer,
    prefill and 4 decode steps' logits within atol / rtol 1e-4."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import (decode_start,
                                                make_prefill_step)
    for arch, n_extra in (("whisper-tiny", 16), ("whisper-tiny", 37),
                          ("qwen2-vl-2b", 8)):
        cfg = get_arch(arch).reduced()
        cpu = build_model(cfg, device="cpu")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        gpu = build_model(cfg, device=device)
        p_gpu = tree_map(lambda t: t.to(device), p_cpu)
        toks, extra = extra_inputs(np, torch, cfg, 2, 40, n_extra, 1, "cpu")
        first = decode_start(cfg, toks, extra)
        lc, cc = make_prefill_step(cpu, cfg, first + 4)(p_cpu, toks, extra)
        lg, cg = make_prefill_step(gpu, cfg, first + 4)(
            p_gpu, toks.to(device), extra.to(device))
        worst = 0.0
        for i in range(5):
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
            if i == 4:
                break
            nxt = torch.argmax(lc, -1).to(torch.int32)[:, None]
            pos = torch.full((2, 1), first + i, dtype=torch.int32)
            lc, cc = cpu.decode_step(p_cpu, nxt, pos, cc)
            lg, cg = gpu.decode_step(p_gpu, nxt.to(device), pos.to(device),
                                     cg)
        what = "frames" if cfg.family == "audio" else "patch embeddings"
        log(f"  {cfg.name} ({n_extra} {what}, 40-token prompt, cache "
            f"{first + 4}): prefill + 4 decode logits, card vs CPU max abs "
            f"diff {worst:.3g}")


def padded_prompts(np, torch, vocab, n, prompt, seed, device):
    """``n`` seeded prompts of ``prompt`` (inclusive range) tokens,
    left-padded with token 0 to the longest, as ``ContinuousBatcher``
    batches them: [n, S] int32 on ``device``, and the prompts' lengths."""
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(prompt[0], prompt[1] + 1)) for _ in range(n)]
    toks = np.zeros((n, max(lens)), np.int32)
    for i, m in enumerate(lens):
        toks[i, -m:] = rng.integers(2, vocab, size=m)
    return torch.as_tensor(toks, device=device), lens


def serve_steps(np, torch, model, params, toks, extra, cache_len, steps,
                want):
    """Serve a batch through the reference's step functions
    (``make_prefill_step`` with ``extra``, then ``steps`` greedy
    ``make_decode_step`` calls), the launch counters reset just before and
    read just after: the prefill call must launch exactly
    ``want["prefill"]`` and each decode step ``want["decode"]``, every
    launch of a kernel in ``SERVED_ROUTES`` on the route it names.  The
    prefill gives every stream its first token, so TTFT is the prefill's
    wall.  Returns the run's numbers."""
    from repro_torch import kernels
    from repro_torch.runtime.serve_loop import (decode_start,
                                                make_decode_step,
                                                make_prefill_step)
    cfg = model.cfg
    prefill = make_prefill_step(model, cfg, cache_len)
    decode = make_decode_step(model)
    calls = {"prefill": [], "decode": []}

    def call(kind, fn, *args):
        before = kernels.launch_counts()
        routes_before = kernels.route_counts()
        with torch.profiler.record_function(f"serve.{kind}"):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = kernels.launch_counts()
        check_call(cfg.name, kind, {k: after[k] - before[k] for k in after},
                   {k: {r: n - routes_before[k][r] for r, n in v.items()}
                    for k, v in kernels.route_counts().items()}, want)
        calls[kind].append(wall)
        return out

    b = toks.shape[0]
    first = decode_start(cfg, toks, extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = call("prefill", prefill, params, toks, extra)
    if tuple(logits.shape) != (b, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: prefill logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    nxt = torch.argmax(logits, -1).to(torch.int32)
    out = [nxt]
    for i in range(steps):
        pos = torch.full((b, 1), first + i, dtype=torch.int32,
                         device=model.device)
        nxt, cache = call("decode", decode, params, cache, nxt[:, None], pos,
                          None)
        out.append(nxt)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    total = {k: want["prefill"].get(k, 0) + want["decode"].get(k, 0) * steps
             for k in launches}
    if launches != total:
        raise AssertionError(f"{cfg.name}: launches {launches} != {total}")
    tokens = torch.stack(out, 1)
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: a token outside the vocabulary")
    dec = calls["decode"]
    return {"streams": b, "prompt_tokens": toks.shape[1],
            "extra_tokens": None if extra is None else extra.shape[1],
            "cache_len": cache_len, "generated_tokens": b * (steps + 1),
            "distinct_tokens": len(set(tokens.flatten().tolist())),
            "prefill_s": calls["prefill"][0], "ttft_s": calls["prefill"][0],
            "decode_steps": steps,
            "decode_step_ms_min": min(dec) * 1e3,
            "decode_step_ms_median": pct(dec, 50) * 1e3,
            "decode_step_ms_max": max(dec) * 1e3,
            "decode_tokens_per_s": b * steps / sum(dec), "wall_s": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches}


def log_steps(run, what):
    log(f"  {what}: {run['streams']} streams x {run['prompt_tokens']} "
        f"tokens (+ {run['extra_tokens']} extra), cache "
        f"{run['cache_len']}: TTFT (the prefill) {run['ttft_s']:.4f} s; "
        f"{run['decode_steps']} decode steps min / median / max "
        f"{run['decode_step_ms_min']:.2f} / "
        f"{run['decode_step_ms_median']:.2f} / "
        f"{run['decode_step_ms_max']:.2f} ms, "
        f"{run['decode_tokens_per_s']:.1f} decode tokens/s; "
        f"{run['generated_tokens']} tokens ({run['distinct_tokens']} "
        f"distinct); peak {run['peak_gib']:.2f} GiB; launches "
        f"{run['launches']}")


def init_full(torch, arch, device, n_layers=None):
    """``arch`` at full width on the card (cut to ``n_layers`` where
    given: depth, never width), weights from a seeded card generator:
    (model, params, record of the init)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    cfg = get_arch(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    rec = {"model": arch, "init_s": time.perf_counter() - t0,
           "params": sum(t.numel() for t in _leaves(params)),
           "weights_gb": sum(t.numel() * t.element_size()
                             for t in _leaves(params)) / 1e9}
    log(f"  {arch}: {rec['params'] / 1e9:.3f} B parameters, "
        f"{rec['weights_gb']:.2f} GB held, initialised on the card in "
        f"{rec['init_s']:.2f} s")
    return model, params, rec


def run_whisper_path(np, torch, device):
    """Phase 27: whisper-tiny at full width in bfloat16 through the step
    functions (``SERVED["whisper-tiny"]``): seeded frames made on the
    card, left-padded prompts, greedy decoding, exact launches and routes
    a call; then the kernels against the plain versions inside the model
    (2 streams, their frames and prompts)."""
    arch = "whisper-tiny"
    spec = SERVED[arch]
    want = {"prefill": spec["prefill"], "decode": spec["decode"]}
    model, params, rec = init_full(torch, arch, device)
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(7)
    frames = torch.randn((spec["streams"], cfg.enc_seq, cfg.d_model),
                         generator=gen, device=device).to(torch.bfloat16)
    toks, lens = padded_prompts(np, torch, cfg.vocab_size, spec["streams"],
                                spec["prompt"], 3, device)
    # warm-up: cuBLAS handles and the kernels' first launches
    serve_steps(np, torch, model, params, toks, frames, spec["cache_len"],
                2, want)
    run = serve_steps(np, torch, model, params, toks, frames,
                      spec["cache_len"], spec["steps"], want)
    rec.update(run, prompt_lengths=lens)
    log_steps(run, f"{arch} (frames {list(frames.shape)}, prompts {lens})")
    diffs = check_lm_kernels_vs_plain(torch, model, params,
                                      toks[:2].cpu().numpy(), frames[:2])
    rec["kernels_vs_plain_max_abs_logit_diff"] = diffs
    log_lm_gaps(diffs, f"B=2 x {toks.shape[1]}-token prompt over "
                f"{cfg.enc_seq} frames")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_vlm_patches(np, torch, device):
    """Phase 28 (b): qwen2-vl-2b at full width, ``streams`` requests with
    ``patches`` seeded patch embeddings (made on the card) in front of
    their prompts through the step functions, ``steps`` greedy decode
    steps, exact launches and routes a call; then the kernels against the
    plain versions inside the model with the patch embeddings."""
    arch = "qwen2-vl-2b"
    spec = SERVED[arch]
    want = {"prefill": spec["prefill"], "decode": spec["decode"]}
    model, params, rec = init_full(torch, arch, device)
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(8)
    patches = torch.randn((spec["streams"], spec["patches"], cfg.d_model),
                          generator=gen, device=device).to(torch.bfloat16)
    toks, lens = padded_prompts(np, torch, cfg.vocab_size, spec["streams"],
                                spec["prompt"], 4, device)
    serve_steps(np, torch, model, params, toks[:, -64:], patches,
                spec["max_seq"], 2, want)
    run = serve_steps(np, torch, model, params, toks, patches,
                      spec["max_seq"], spec["steps"], want)
    rec.update(run, prompt_lengths=lens)
    log_steps(run, f"{arch} with {spec['patches']} patch embeddings "
              f"(prompts {lens})")
    prompts = toks[:2, -256:].cpu().numpy()
    diffs = check_lm_kernels_vs_plain(torch, model, params, prompts,
                                      patches[:2])
    rec["kernels_vs_plain_max_abs_logit_diff"] = diffs
    log_lm_gaps(diffs, f"B=2 x ({spec['patches']} patch embeddings + "
                f"{prompts.shape[1]}-token prompt)")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def time_slice_attention(torch, device, served, errs):
    """Phase 29: the attention kernels at this slice's shapes in bfloat16,
    each first held against its plain version there (``errs`` from phase
    25 at the same shapes), beside the plain version,
    ``F.scaled_dot_product_attention`` and the bound from this run's
    shapes: flash non-causal at whisper's encoder (B 4, H 6, S 1,500, D
    64) and cross-attention Sq 448 x Sk 1,500; decode over the cross
    cache (B 4, KV 6, G 1, 1,500 slots) and at qwen2-vl's decode (B 8, KV
    2, G 6, 2,048 slots, D 128), every slot valid.  Returns (flash
    entries, decode entries), keyed by case; ``launches`` is what the
    counters read over the served run that ``launches_of`` names: every
    launch of that kernel there, whatever the layer (the counters do not
    tell the encoder's, the decoder's and the cross calls apart)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    bf = torch.bfloat16
    wh, vl = served["whisper-tiny"], served["qwen2-vl-2b"]
    whole = "the whole run: prefill and decode steps"
    flash, decode = {}, {}
    for key, (b, h, kv, sq, sk, d) in (("whisper_encoder",
                                        (4, 6, 6, 1500, 1500, 64)),
                                       ("whisper_cross",
                                        (4, 6, 6, 448, 1500, 64))):
        q, k, v = flash_cross_case(torch, 700, b, h, kv, sq, sk, d, bf,
                                   device)
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        flash[key] = attention_entry(
            torch, lambda: flash_attention(q, k, v, causal=False),
            lambda: attention_ref(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(qc, kc, vc),
            KERNEL_WORK["flash_attention"](q, k, v, causal=False), 5,
            errs["encoder" if sq == sk else "cross"], [b, h, kv, sq, sk, d],
            wh["launches"]["flash_attention"])
        flash[key]["launches_of"] = f"whisper-tiny's served run ({whole})"
        flash[key]["kernel_route"] = take_route(
            flash_attention, lambda: flash_attention(q, k, v,
                                                     causal=False))[1]
    for key, (b, kv, g, s, d), run, of in (
            ("whisper_cross_decode", (4, 6, 1, 1500, 64), wh,
             f"whisper-tiny's served run ({whole})"),
            ("qwen2vl_decode", (8, 2, 6, 2048, 128), vl,
             "qwen2-vl-2b's ContinuousBatcher run")):
        q, k, v, _ = decode_case(torch, 701, b, kv, g, s, d, bf, device)
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=device)
        q_h = q.reshape(b, kv * g, 1, d)
        decode[key] = attention_entry(
            torch, lambda: decode_attention(q, k, v, pos),
            lambda: decode_ref(q, k, v, pos),
            lambda: F.scaled_dot_product_attention(q_h, k, v,
                                                   enable_gqa=True),
            KERNEL_WORK["decode_attention"](q, k, v, pos), 20,
            errs["cross_decode" if g == 1 else "vlm_decode"],
            [b, kv, g, s, d], run["launches"]["decode_attention"])
        decode[key]["launches_of"] = of
    for name, entries in (("flash_attention", flash),
                          ("decode_attention", decode)):
        for key, e in entries.items():
            log(f"  {name} {key} {e['shape']} bf16: max abs err "
                f"{e['max_abs_err']:.3g}; {e['ms']:.4f} ms in a graph "
                f"({e['tflops']:.2f} TFLOP/s, {e['gb_per_s']:.1f} GB/s), "
                f"{e['eager_ms']:.4f} eager; plain {e['plain_ms']:.4f} ms; "
                f"SDPA {e['library_ms']:.4f} ms; bound {e['bound_ms']:.4f} "
                f"ms ({e['bound_by']})")
    return flash, decode


def attention_entry(torch, kern, plain, lib, work, iters, err, shape,
                    launches):
    """One timed attention shape: the kernel's, the plain version's and
    the library call's times (CUDA graph), the kernel's eager time, and
    the bound from its ``KERNEL_WORK``."""
    kern()
    torch.testing.assert_close(kern().float(), plain().float(),
                               **ATTN_BF16_ROUNDING)
    ms = time_ms(torch, kern, iters, graph=True)
    nbytes, nops = work.bytes, work.flops
    return {"shape": shape, "dtype": "bfloat16", "launches": launches,
            "max_abs_err": err, "ms": ms,
            "eager_ms": time_ms(torch, kern, iters, graph=False),
            "plain_ms": time_ms(torch, plain, iters, graph=True),
            "library_ms": time_ms(torch, lib, iters, graph=True),
            "library": "F.scaled_dot_product_attention",
            **bound_keys(work),
            "bytes": nbytes, "operations": nops,
            "tflops": nops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6}


# ---------------------------------------------------------------------------
# the pipeline-stage planner, the sharded rollout, the serving example
# ---------------------------------------------------------------------------

#: the interconnect figures no data sheet gives, phase 30's assumptions
#: (the caller's, as ``examples/torch_serve_swarm.py`` takes them):
#: one NVLink hop with its switch, 16 stage groups on a 4 x 4 torus, one
#: 400 Gb/s network port a card
PLAN_HOP_LATENCY_S = 2e-6
PLAN_TORUS = (4, 4)
PLAN_DCN_BYTES = POD_BYTES_PER_S
PLAN_STAGES, PLAN_CHIPS_PER_STAGE = (2, 4, 8), 8
ELASTIC = ("qwen2-vl-2b", "train_4k", (8, 7, 5))
#: phase 31's ragged split: B trajectories over a mesh of this many entries
RAGGED_B, RAGGED_SHARDS = 250, 4
SHARD_WALL_TURNS = 2


def run_pipeline_planner(np, torch, device):
    """Phase 30: ``plan_pipeline`` for every LM config at each supported
    shape at ``PLAN_STAGES`` stages of ``PLAN_CHIPS_PER_STAGE`` cards, and
    ``scale_elastic`` at 8, 7 and 5, with the card's constants; the
    reference test's invariants held on each plan.  Returns its record."""
    from repro_torch.configs.registry import LM_ARCHS, get_arch, get_shape
    from repro_torch.core.channel import ICIChannel, ICIParams
    from repro_torch.core.pipeline_opt import (
        H100_SXM_NVLINK_BYTES_ONE_WAY, card_chip, pipeline_efficiency,
        plan_pipeline)
    from repro_torch.runtime.fault_tolerance import scale_elastic
    chip = card_chip(device)
    ici = ICIChannel(ICIParams(H100_SXM_NVLINK_BYTES_ONE_WAY,
                               PLAN_HOP_LATENCY_S, PLAN_TORUS,
                               PLAN_DCN_BYTES))
    plans, t0 = [], time.perf_counter()

    def held(cfg, plan, n, exact):
        blocks = sum(plan.blocks_per_stage)
        hops = [ici.hops(a, b) for a, b in zip(plan.stage_coords[:-1],
                                                 plan.stage_coords[1:])]
        if blocks != cfg.n_layers + 2 + cfg.enc_layers or \
                any(h != 1 for h in hops) or \
                plan.bottleneck_s != max(plan.stage_latency_s) or \
                (plan.n_stages != n if exact else plan.n_stages > n):
            raise AssertionError(f"{cfg.name}: plan {plan} at {n} stages "
                                 f"(blocks {blocks}, hops {hops})")

    for arch in LM_ARCHS:
        cfg = get_arch(arch)
        for shape in cfg.supported_shapes:
            for n in PLAN_STAGES:
                plan = plan_pipeline(cfg, get_shape(shape), n,
                                     PLAN_CHIPS_PER_STAGE, chip=chip, ici=ici)
                held(cfg, plan, n, exact=True)
                plans.append({
                    "arch": arch, "shape": shape, "n_stages": n,
                    "blocks_per_stage": plan.blocks_per_stage,
                    "stage_coords": plan.stage_coords,
                    "bottleneck_s": plan.bottleneck_s,
                    "total_latency_s": plan.total_latency_s,
                    "efficiency_32mb": pipeline_efficiency(plan, 32)})
    arch, shape, counts = ELASTIC
    elastic = []
    for n in counts:
        plan = scale_elastic(n, get_arch(arch), get_shape(shape),
                             PLAN_CHIPS_PER_STAGE, chip=chip, ici=ici)
        held(get_arch(arch), plan, n, exact=False)
        elastic.append({"n_devices": n, "n_stages": plan.n_stages,
                        "blocks_per_stage": plan.blocks_per_stage,
                        "bottleneck_s": plan.bottleneck_s})
    wall = time.perf_counter() - t0
    p = ici.params
    log(f"  chip {chip.name}: {chip.macs_per_s:.6g} MAC/s (H100 SXM data "
        f"sheet, dense bf16 989 TFLOP/s halved), {chip.hbm_bytes:.6g} B "
        f"(the card's total_memory); link {p.link_bw_bytes:.6g} B/s (H100 "
        f"SXM data sheet, NVLink 900 GB/s both ways, one way); assumed: hop "
        f"{p.hop_latency_s} s, torus {p.torus}, cross-host "
        f"{p.dcn_bw_bytes:.6g} B/s")
    log(f"  {len(plans)} plans ({len(LM_ARCHS)} LM configs x their shapes x "
        f"{PLAN_STAGES} stages of {PLAN_CHIPS_PER_STAGE} cards) and "
        f"scale_elastic {arch}/{shape} at {counts} -> "
        f"{[e['n_stages'] for e in elastic]} stages: blocks, hops and "
        f"bottlenecks held; {wall:.3f} s on the host")
    return {"chip": {"name": chip.name, "macs_per_s": chip.macs_per_s,
                     "hbm_bytes": chip.hbm_bytes,
                     "source": "MAC/s: H100 SXM data sheet (dense bf16 "
                               "989 TFLOP/s, halved); bytes: the card"},
            "ici": {"link_bw_bytes": p.link_bw_bytes,
                    "hop_latency_s": p.hop_latency_s, "torus": p.torus,
                    "dcn_bw_bytes": p.dcn_bw_bytes,
                    "source": "link: H100 SXM data sheet (NVLink 900 GB/s "
                              "both ways, one way); hop, torus, cross-host: "
                              "assumed"},
            "chips_per_stage": PLAN_CHIPS_PER_STAGE, "plans": plans,
            "elastic": {"arch": arch, "shape": shape, "plans": elastic},
            "wall_s": wall}


def same_trace(np, ref, got):
    """``got``'s valid rows equal ``ref``'s rows bitwise, field by field;
    the names of the fields that differ."""
    sel = np.flatnonzero(got._valid())
    if len(sel) != ref.latency.shape[0]:
        return ["n_trajectories"]
    return [f for f in ("latency", "total_power", "feasible", "cap_feasible",
                        "source_latency", "assign", "positions", "active",
                        "charge", "n_requests", "energy_tx", "energy_cmp")
            if not np.array_equal(getattr(got, f)[sel], getattr(ref, f))]


def run_sharded_rollout(np, torch, device):
    """Phase 31: the main path's rollout (AlexNet, U 8, B 256, T 32, 4
    requests a frame, P2) split over ``fleet_mesh`` meshes on the card:
    two entries of this card, a ragged ``RAGGED_B`` over four, and every
    visible card when there is more than one.  Each run's counters are
    set to 0 just before and read just after it; each is bitwise equal on
    every valid field to the unsharded run with the same generator, with
    exactly T x shards link-geometry and fused chain-DP launches; each
    rollout entry is built once, by its first run.  Then the unsharded
    and two-shard walls in turns, which build nothing.  Returns its
    record."""
    from repro_torch import kernels
    from repro_torch.core.positions import hex_init
    from repro_torch.parallel.sharding import fleet_mesh
    fleet = alexnet_fleet(torch, device, p2=True, seed=0, frames=MAIN_T)
    base = hex_init(U, 40.0, jitter=0.5, seed=0)
    meshes = [("2 x this card", fleet_mesh([device] * 2), MAIN_B),
              (f"{RAGGED_SHARDS} x this card, ragged",
               fleet_mesh([device] * RAGGED_SHARDS), RAGGED_B)]
    if torch.cuda.device_count() > 1:
        meshes.append(("every visible card", fleet_mesh(), MAIN_B))

    def run(B, seed, mesh=None):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trace = fleet.run(base, n_trajectories=B, mesh=mesh,
                          rng=np.random.default_rng(seed))
        torch.cuda.synchronize()
        return trace, time.perf_counter() - t0, kernels.launch_counts(), \
            kernels.route_counts()["tropical_dp"]

    record = {"meshes": []}
    for k, (name, mesh, B) in enumerate(meshes):
        seed = 31 + k
        ref = run(B, seed)[0]
        trace, wall, launches, routes = run(B, seed, mesh)
        n = len(mesh)
        want = only(launches, link_geometry=MAIN_T * n,
                    tropical_dp=MAIN_T * n)
        if launches != want or routes != {"fused": MAIN_T * n, "step": 0}:
            raise AssertionError(f"sharded rollout ({name}): launches "
                                 f"{launches} != {want}, routes {routes}")
        diff = same_trace(np, ref, trace)
        if diff:
            raise AssertionError(f"sharded rollout ({name}): {diff} differ "
                                 f"from the unsharded run")
        padded = trace.latency.shape[0]
        if (padded != B) != (trace.valid is not None) or \
                trace.n_trajectories != B or not trace.feasibility_rate > 0:
            raise AssertionError(f"sharded rollout ({name}): {padded} rows, "
                                 f"valid {trace.valid}")
        record["meshes"].append({
            "mesh": name, "shards": n, "B": B, "padded_B": padded,
            "launches": {"link_geometry": MAIN_T * n,
                         "tropical_dp": MAIN_T * n},
            "feasibility": trace.feasibility_rate,
            "latency_p50_s": trace.latency_percentile(50),
            "first_wall_s": wall})
        log(f"  {name}: B {B} -> {padded} rows over {n} shards, launches "
            f"{MAIN_T * n} + {MAIN_T * n} (fused), every field bitwise the "
            f"unsharded run's; feasibility {trace.feasibility_rate:.6f}; "
            f"first run {wall:.3f} s")
    # every entry is built once, by the first run that needs it
    builds = dict(fleet.plan_cache.builds)
    keys = [key for key in fleet._cache_keys_used if key[0] == "rollout"]
    if len(keys) != 1 + len(meshes) or any(builds[key] != 1 for key in keys):
        raise AssertionError(f"sharded rollout: builds "
                             f"{[builds.get(key) for key in keys]}")
    walls = {"unsharded": [], "2 shards": []}
    for turn in range(SHARD_WALL_TURNS):
        for label, mesh in (("unsharded", None), ("2 shards",
                                                  meshes[0][1])):
            walls[label].append(run(MAIN_B, 90 + turn, mesh)[1])
    if dict(fleet.plan_cache.builds) != builds:
        raise AssertionError("sharded rollout: a run after the first built")
    log(f"  walls in turns, B {MAIN_B} T {MAIN_T}: unsharded "
        f"{', '.join(f'{w:.3f}' for w in walls['unsharded'])} s; 2 shards "
        f"of this card {', '.join(f'{w:.3f}' for w in walls['2 shards'])} s"
        f"; no build after the first runs")
    record.update({"U": U, "T": MAIN_T, "requests": REQUESTS,
                   "p2_steps": 30, "walls_in_turns_s": walls})
    return record


def load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_serve_swarm(np, torch, device):
    """Phase 32: ``examples/torch_serve_swarm.py``'s three modes on the
    card (its default device), each with the counters set to 0 just
    before and read just after it.  LM mode: 4 flash launches (the SIMT
    route: float32) a prefill call and 4 decode launches a decode step,
    nothing else; its 2-stage plan of 6 blocks.  ``--chaos`` and
    ``--stream``: every rollout call T + T launches (fused), the chaos
    mode's planning calls 1 + 1 each outside them, the stream mode
    nothing outside them; their events, windows and reports the CPU's.
    Returns its record."""
    import io
    from repro_torch import kernels
    mod = load_example("torch_serve_swarm")
    record = {}
    for mode, argv in (("lm", []), ("chaos", ["--chaos"]),
                       ("stream", ["--stream"])):
        calls = []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with counted_rollouts(torch, calls), \
                contextlib.redirect_stdout(io.StringIO()):
            out = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        routes = kernels.route_counts()
        if mode == "lm":
            layers = out["n_layers"]
            want = only(launches,
                        flash_attention=layers * out["prefill_calls"],
                        decode_attention=layers * out["decode_steps"])
            flash = routes["flash_attention"]
            plan = out["plan"]
            if launches != want or calls or flash != only(
                    flash, simt=want["flash_attention"]) or \
                    plan.n_stages != 2 or \
                    sum(plan.blocks_per_stage) != layers + 2 or \
                    out["completed"] != 8:
                raise AssertionError(f"serve_swarm lm: launches {launches}, "
                                     f"want {want}, flash routes {flash}, "
                                     f"plan {plan}")
            record[mode] = {
                "launches": {k: v for k, v in want.items() if v},
                "flash_route": "simt", "prefill_calls": out["prefill_calls"],
                "decode_steps": out["decode_steps"], "tokens": out["tokens"],
                "serve_wall_s": out["wall_s"],
                "plan": {"blocks_per_stage": plan.blocks_per_stage,
                         "stage_coords": plan.stage_coords,
                         "bottleneck_s": plan.bottleneck_s},
                "chip": out["chip"].name, "wall_s": wall}
            log(f"  lm: {out['prefill_calls']} prefill calls x {layers} "
                f"flash (simt) + {out['decode_steps']} decode steps x "
                f"{layers} decode; {out['tokens']} tokens in "
                f"{out['wall_s']:.3f} s; plan {plan.blocks_per_stage} "
                f"blocks at {plan.stage_coords}, period "
                f"{plan.bottleneck_s * 1e6:.3f} us")
            continue
        want_rollout_calls(f"serve_swarm {mode}", calls)
        outside = {k: v - sum(c[1][k] for c in calls)
                   for k, v in launches.items()}
        planning = outside["link_geometry"]
        if outside != only(outside, link_geometry=planning,
                           tropical_dp=planning) or \
                (planning == 0) != (mode == "stream") or \
                routes["tropical_dp"]["step"]:
            raise AssertionError(f"serve_swarm {mode}: launches outside the "
                                 f"rollout calls {outside}")
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = mod.main(argv + ["--device", "cpu"])
        keys = ("events", "mode", "metrics", "retraces") if mode == "chaos" \
            else ("windows",)
        if any(out[k] != cpu[k] for k in keys) or (
                mode == "stream" and {k: v for k, v in out["report"].items()
                                      if "latency" not in k}
                != {k: v for k, v in cpu["report"].items()
                    if "latency" not in k}):
            raise AssertionError(f"serve_swarm {mode}: {out} on the card, "
                                 f"{cpu} on the CPU")
        record[mode] = {"rollout_calls": len(calls),
                        "planning_calls": planning, "wall_s": wall}
        log(f"  {mode}: {len(calls)} rollout calls of T + T launches, "
            f"{planning} planning calls of 1 + 1 outside them; the CPU's "
            f"{', '.join(keys)}; wall {wall:.3f} s")
    return record


# ---------------------------------------------------------------------------
# training: the flash-attention backward, reduced and full-width training,
# the training example
# ---------------------------------------------------------------------------

#: phase 33's backward cases (B, H, KV, Sq, Sk, D, causal, window, cap):
#: minicpm-2b's training call, gemma2-9b's global and local layers,
#: qwen2-vl-2b's GQA at D 128, whisper-tiny's encoder and cross calls,
#: ragged Sq / Sk of 1, 65 and 1,000; D 16 and 32 (one with a window and a
#: cap), GQA with a window at D 128, and recurrentgemma-9b's training call
#: (KV 1 under 16 heads, D 256, window 2,048)
BWD_CASES = [
    (1, 36, 36, 4096, 4096, 64, True, 0, 0.0),
    (1, 16, 8, 2048, 2048, 256, True, 0, 50.0),
    (1, 16, 8, 2048, 2048, 256, True, 1024, 50.0),
    (2, 12, 2, 1280, 1280, 128, True, 0, 0.0),
    (4, 6, 6, 1500, 1500, 64, False, 0, 0.0),
    (4, 6, 6, 448, 1500, 64, False, 0, 0.0),
    (1, 4, 2, 1, 1, 64, True, 0, 0.0),
    (1, 4, 2, 65, 65, 64, True, 0, 0.0),
    (1, 4, 2, 1000, 1000, 128, True, 0, 0.0),
    (2, 6, 6, 65, 1000, 64, False, 0, 0.0),
    (2, 6, 6, 1000, 65, 64, False, 0, 0.0),
    (1, 4, 4, 1, 1000, 64, False, 0, 0.0),
    (2, 4, 2, 333, 333, 16, True, 0, 0.0),
    (1, 6, 2, 500, 500, 32, True, 100, 30.0),
    (1, 8, 2, 1500, 1500, 128, True, 512, 0.0),
    (1, 16, 1, 4096, 4096, 256, True, 2048, 0.0),
]
#: phase 33's row blocks at a query offset, each a ``BWD_CASES`` entry and
#: its offset: minicpm-2b's last block of 8 at S 2,048 (rows 256, keys
#: 2,048, offset 1,792), gemma2-9b's heads with a window and a cap at an
#: offset off a tile, recurrentgemma-9b's KV 1 at D 256
BWD_OFFSET_CASES = [
    (1, 36, 36, 256, 2048, 64, True, 0, 0.0, 1792),
    (1, 16, 8, 200, 1100, 256, True, 128, 50.0, 900),
    (1, 16, 1, 129, 700, 256, True, 0, 0.0, 300),
    (2, 6, 2, 100, 333, 32, True, 0, 30.0, 129),
]
#: phase 34's timed shapes, bfloat16: the row's and its sub-entry's
BWD_TIMED = {"minicpm-2b": BWD_CASES[0], "gemma2-9b": BWD_CASES[1]}
#: phases 35 (the first four) and 40 (the MoE and griffin models): the
#: reduced models trained card against CPU in float32, the tolerance of
#: loss and gradients (the attention kernels' float32 one)
TRAIN_ARCHS = ("minicpm-2b", "gemma2-9b", "qwen2-vl-2b", "whisper-tiny",
               "granite-moe-1b-a400m", "olmoe-1b-7b", "recurrentgemma-9b")
TRAIN_TOL = dict(atol=2e-5, rtol=2e-4)
#: parameters after 3 AdamW steps card against CPU: atol 0.05 lr a step
#: (an update is ~lr; where a gradient sits near zero float32 reordering
#: moves m / sqrt(v)); with grad_compress at most FLIP_SHARE of a leaf
#: (or FLIP_COUNT elements, for small leaves) may take an int8 payload
#: rounding the other way, within lr a step (error feedback carries a
#: flip into the later steps: 0.32 % of a leaf, and 2 of a 64-element
#: leaf, in the first card runs; ROADMAP section 3)
STEP_ATOL_PER_LR = 0.05
FLIP_SHARE = 1e-2
FLIP_COUNT = 4
#: phase 36: minicpm-2b at full width and depth, TRAIN_4K's sequence, its
#: global batch of 256 cut to 2 sequences (2 microbatches of 1), 3 steps
FULL_TRAIN = dict(arch="minicpm-2b", seq=4096, batch=2, microbatches=2,
                  steps=3, lr=1e-3, check_seq=1024)
#: phase 41, as phase 36: granite-moe-1b-a400m at full width and depth
#: (21.4 GB of float32 masters, gradients and moments), and
#: recurrentgemma-9b at full width cut to 9 layers, three whole Griffin
#: periods of two RG-LRU and one local-attention layer (46.7 GB; its 38
#: layers' 143.4 GB do not fit one card)
FULL_TRAIN_SLICE = (dict(FULL_TRAIN, arch="granite-moe-1b-a400m"),
                    dict(FULL_TRAIN, arch="recurrentgemma-9b", n_layers=9))
#: phase 38: the expert GEMM's backward products (E, C, D, F): granite-moe's
#: training shapes (the w_in / w_gate product, then w_out's D 512, F
#: 1,024), olmoe-1b-7b's, a ragged C 97, D and F not multiples of 8 (bf16
#: on ``simt``), C 0, C 1 at D 16, F 8 (a box mostly out of bounds), D != F
#: with a ragged C on ``wgmma``
MOE_BWD_CASES = [(32, 1280, 1024, 512), (32, 1280, 512, 1024),
                 (64, 640, 2048, 1024), (8, 97, 200, 72), (3, 40, 100, 36),
                 (4, 0, 64, 32), (2, 1, 16, 8), (5, 333, 136, 264)]
#: phase 38: the RG-LRU reverse scan (B, T, W, with a dhT): recurrentgemma's
#: training call, its served prefill's B x T, a ragged W (float32: a partial
#: strip on ``tma``; bfloat16: ``simt``), T 1, T below one box at a W that
#: leaves a partial strip at full size
RGLRU_BWD_CASES = [(1, 4096, 4096, False), (8, 1345, 4096, True),
                   (2, 37, 100, True), (3, 1, 64, True), (2, 64, 256, False),
                   (1, 5, 4100, True)]
#: in-model gradient gate, as phase 12 gates logits: each leaf's gap
#: (kernels against plain), as a share of the leaf's largest plain
#: gradient, within LM_GAP x the largest such share the reordered plain
#: side shows over all leaves, or within this many bf16 ulps of the leaf's
#: largest gradient, whichever is larger (each gradient element sums
#: 1,024 tokens' products of bf16-rounded activations; ROADMAP section 3)
GRAD_FLOOR_ULPS = 8


def bwd_case(torch, seed, case, dtype, device):
    """q, k, v, dO of a backward case as transposed views of [B, S, heads,
    D] tensors (dO as autograd hands it)."""
    b, h, kv, sq, sk, d = case[:6]
    ts = attn_inputs(torch, seed, [(b, sq, h, d), (b, sk, kv, d),
                                   (b, sk, kv, d), (b, sq, h, d)], dtype,
                     device)
    return [t.transpose(1, 2) for t in ts]


def check_flash_bwd(np, torch, device):
    """Phase 33: the forward with ``with_lse`` (the output bitwise the
    serving launch's, lse within the float32 tolerance of the plain
    version's) and the backward kernel against ``attention_bwd_ref`` on
    the same o and lse at ``BWD_CASES`` and, at a query offset, at
    ``BWD_OFFSET_CASES``, float32 and bfloat16
    (``ATTN_TOL``, bf16 also ``ATTN_BF16_ROUNDING``); two backward launches
    bitwise equal; each forward and each backward launch on its dtype's
    route (bfloat16 ``wgmma``, float32 ``simt``).  Returns the bf16 max
    abs errors at the timed shapes."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        bwd_route, flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for i, case in enumerate(BWD_CASES + BWD_OFFSET_CASES):
            b, h, kv, sq, sk, d, causal, window, cap = case[:9]
            kw = dict(causal=causal, window=window, cap=cap)
            if len(case) > 9:
                kw["q_offset"] = case[9]
            q, k, v, do = bwd_case(torch, 400 + i, case, dtype, device)
            plain_o = flash_attention(q, k, v, **kw)
            (o, lse), route = take_route(flash_attention, lambda: (
                flash_attention(q, k, v, with_lse=True, **kw)))
            want_route("flash_attention (with lse)", route,
                       "wgmma" if dtype == torch.bfloat16 else "simt")
            got, broute = take_route(flash_attention_bwd, lambda: (
                flash_attention_bwd(q, k, v, o, lse, do, **kw)))
            want_route("flash_attention_bwd", broute, bwd_route(dtype))
            again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            _, ref_lse = attention_fwd_ref(q, k, v, **kw)
            ref = attention_bwd_ref(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            if not torch.equal(o, plain_o):
                raise AssertionError(f"flash_attention {case}: the output "
                                     f"moved when lse was asked for")
            torch.testing.assert_close(lse, ref_lse, **ATTN_TOL["float32"])
            err = 0.0
            for name, g, a, r in zip("qkv", got, again, ref):
                if not torch.equal(g, a):
                    raise AssertionError(f"flash_attention_bwd {case} "
                                         f"{dname}: two launches differ "
                                         f"in d{name}")
                torch.testing.assert_close(g.float(), r.float(),
                                           **ATTN_TOL[dname])
                if dtype == torch.bfloat16:
                    torch.testing.assert_close(g.float(), r.float(),
                                               **ATTN_BF16_ROUNDING)
                err = max(err, float((g.double() - r.double()).abs().max()))
            for arch, timed in BWD_TIMED.items():
                if timed == case and dtype == torch.bfloat16:
                    errs[arch] = err
            log(f"  flash_attention_bwd {dname} B={b} H={h} KV={kv} Sq={sq} "
                f"Sk={sk} offset={kw.get('q_offset', 0)} D={d} "
                f"causal={causal} window={window} cap={cap}: "
                f"max abs err {err:.3g}, lse err "
                f"{float((lse - ref_lse).abs().max()):.3g}, forward on "
                f"{route}, backward on {broute}, two backward launches "
                f"bitwise equal")
            del q, k, v, do, o, lse, got, again, ref, plain_o
    torch.cuda.empty_cache()
    return errs


def kernel_device_ms(torch, fn, iters):
    """Device time per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``iters`` calls: {kernel name: ms}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)(<[^>(]*>)?", e.key)
        if e.device_time_total > 0:
            name = m.group(1) + (m.group(2) or "") if m else e.key[:60]
            out[name] = e.device_time_total / iters / 1e3
    return out


def time_flash_bwd(torch, device, errs):
    """Phase 34: the backward kernel at minicpm-2b's and gemma2-9b's
    training shapes in bfloat16 (CUDA events; in a graph and eager) on the
    route it takes, beside its plain version,
    ``F.scaled_dot_product_attention``'s backward (``torch.autograd.grad``
    of its output; no softcap) and the bound; the device time of its three
    kernels (``torch.profiler``); the forward with ``with_lse`` at the
    same shape.  Returns the ``kernels`` row (minicpm-2b's shape) with
    gemma2-9b's as a sub-entry; ``launches`` is filled from phase 36."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    entries = {}
    for arch, case in BWD_TIMED.items():
        b, h, kv, sq, sk, d, causal, window, cap = case
        kw = dict(causal=causal, window=window, cap=cap)
        q, k, v, do = bwd_case(torch, 500, case, torch.bfloat16, device)
        o, lse = flash_attention(q, k, v, with_lse=True, **kw)
        qc, kc, vc = (t.detach().contiguous().requires_grad_()
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=causal, enable_gqa=kv < h)
        doc = do.contiguous()
        kern = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa
        plain = lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw)  # noqa
        lib = lambda: torch.autograd.grad(lib_out, (qc, kc, vc), doc,  # noqa
                                          retain_graph=True)
        work = KERNEL_WORK["flash_attention_bwd"](q, k, v, o, lse, do, **kw)
        nbytes, nops = work.bytes, work.flops
        _, route = take_route(flash_attention_bwd, kern)
        fwd = lambda: flash_attention(q, k, v, with_lse=True, **kw)  # noqa
        ms = time_ms(torch, kern, 5, graph=True)
        entries[arch] = {
            "shape": [b, h, kv, sq, sk, d], "causal": causal,
            "window": window, "cap": cap, "dtype": "bfloat16", "ms": ms,
            "eager_ms": time_ms(torch, kern, 5, graph=False),
            "plain_ms": time_ms(torch, plain, 2, graph=False),
            "library_ms": time_ms(torch, lib, 5, graph=False),
            **bound_keys(work),
            "bytes": nbytes, "operations": nops, "max_abs_err": errs[arch],
            "tflops": nops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6,
            "kernel_route": route,
            "device_ms_by_kernel": kernel_device_ms(torch, kern, 3),
            "forward_with_lse_ms": time_ms(torch, fwd, 5, graph=True),
            "forward_with_lse_eager_ms": time_ms(torch, fwd, 5, graph=False)}
        e = entries[arch]
        by_kernel = {n: round(t, 4)
                     for n, t in e["device_ms_by_kernel"].items()}
        log(f"  flash_attention_bwd {arch} {e['shape']} bf16 ({route}): "
            f"{ms:.4f} ms in a graph, {e['eager_ms']:.4f} ms eager "
            f"({e['tflops']:.2f} TFLOP/s); plain {e['plain_ms']:.4f} ms "
            f"(eager); SDPA backward (cap 0) {e['library_ms']:.4f} ms "
            f"(eager); bound {e['bound_ms']:.4f} ms ({e['bound_by']}); "
            f"device ms by kernel {by_kernel}; the forward with lse "
            f"{e['forward_with_lse_ms']:.4f} ms in a "
            f"graph, {e['forward_with_lse_eager_ms']:.4f} ms eager")
        del q, k, v, do, o, lse, qc, kc, vc, lib_out, doc
        torch.cuda.empty_cache()
    row = dict(entries.pop("minicpm-2b"))
    row.update({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:109",
        "replaces_note": "no Pallas kernel has a backward: XLA's gradient "
                         "of the reference's attention",
        "launches": None,
        "plain_timing": "eager", "library_timing": "eager",
        "library": "F.scaled_dot_product_attention backward "
                   "(torch.autograd.grad; enable_gqa, no softcap)",
        "gemma2-9b": entries["gemma2-9b"]})
    return row


def train_batch(np, cfg, b, s, seed):
    """A training batch of ``cfg`` as numpy: the reference's synthetic
    tokens, and seeded patch embeddings or frames."""
    from repro_torch.data.pipeline import lm_data
    batch = next(lm_data(cfg, b, s, seed=seed, prefetch=0))
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def attention_calls(cfg):
    """Flash calls a forward pass of ``cfg`` makes (each attention layer's
    self attention; whisper's encoder layers and its decoder's self and
    cross attention)."""
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.n_layers
    from repro_torch.core.cost_model import _block_kinds
    return sum(k.startswith("attn") for k in _block_kinds(cfg))


def train_launches(cfg, passes):
    """The kernel launches of one ``train_loss`` and its backward, each
    layer's forward run ``passes`` times (2 under remat: the recompute):
    a flash forward and a backward an attention call; 3 expert GEMMs a
    MoE layer (2 without a gate) and as many dX and dW launches; a scan
    and a reverse scan an RG-LRU layer; a chunk forward and a chunk
    backward an mLSTM layer (the sLSTM launches none)."""
    from repro_torch.core.cost_model import _block_kinds
    attn = attention_calls(cfg)
    moe = (3 if cfg.glu else 2) * cfg.n_layers if cfg.moe.enabled else 0
    rec = sum(k == "rglru" for k in _block_kinds(cfg))
    mls = sum(k == "mlstm" for k in _block_kinds(cfg))
    want = {"flash_attention": passes * attn, "flash_attention_bwd": attn,
            "moe_matmul": passes * moe, "moe_matmul_dx": moe,
            "moe_matmul_dw": moe, "rglru_scan": passes * rec,
            "rglru_scan_bwd": rec, "mlstm_chunk": passes * mls,
            "mlstm_chunk_bwd": mls}
    return {k: n for k, n in want.items() if n}


def train_routes(torch, cfg, dtype):
    """The route every training launch of ``cfg`` in compute ``dtype``
    takes: flash and its backward ``wgmma`` in bfloat16, ``simt`` in
    float32; the expert GEMM and its dX and dW ``wgmma`` in bfloat16 where
    TMA reads D and F, else ``simt`` (``bwd_route``: the rule is the same
    for D -> F and F -> D); the RG-LRU scan the route of its float32
    operands (under grad the recurrence runs in float32), and so its
    reverse scan; the mLSTM chunk its dtype's route for S > 1 (``wgmma``
    in bfloat16, ``simt`` in float32), and so its backward
    (``mlstm_bwd_route``)."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (mlstm_bwd_route,
                                                            mlstm_route)
    from repro_torch.kernels.moe_matmul.moe_matmul import bwd_route
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_route
    bf16 = dtype == "bfloat16"
    tma = cfg.d_model % 8 == 0 and cfg.moe.d_expert % 8 == 0
    moe_bwd = bwd_route(torch.bfloat16 if bf16 else torch.float32,
                        cfg.d_model, cfg.moe.d_expert)
    return {"flash_attention": "wgmma" if bf16 else "simt",
            "flash_attention_bwd": "wgmma" if bf16 else "simt",
            "moe_matmul": "wgmma" if bf16 and tma else "simt",
            "moe_matmul_dx": moe_bwd, "moe_matmul_dw": moe_bwd,
            "rglru_scan": rglru_route(torch.float32, 1,
                                      cfg.rglru_width or cfg.d_model),
            "rglru_scan_bwd": rglru_route(torch.float32, 1,
                                          cfg.rglru_width or cfg.d_model),
            "mlstm_chunk": mlstm_route(torch.bfloat16 if bf16
                                       else torch.float32, 2),
            "mlstm_chunk_bwd": mlstm_bwd_route(
                torch.bfloat16 if bf16 else torch.float32, 2, cfg.head_dim)}


def want_launches(what, launches, routes, want, route):
    """Raise unless ``launches`` are exactly ``want`` (every other kernel
    0) and every launch of each kernel that ``route`` names took
    ``route[kernel]`` (a ``KeyError`` where that kernel counts no
    routes)."""
    full = only(launches, **want)
    off = {k: routes[k] for k in route
           if routes[k][route[k]] != want.get(k, 0)}
    if launches != full or off:
        raise AssertionError(f"{what}: launches {launches}, want {full}; "
                             f"routes off {route}: {off}")


def held_after_steps(np, what, got, want, lr, steps, compress):
    """Parameters after ``steps`` AdamW steps: within ``STEP_ATOL_PER_LR``
    lr a step (rtol 1e-5); with ``compress`` at most ``FLIP_SHARE`` of a
    leaf (or ``FLIP_COUNT`` elements) outside that, within lr a step."""
    from repro_torch.tree import leaves_with_paths
    worst = 0.0
    for key in got:
        tight = dict(atol=STEP_ATOL_PER_LR * lr * steps, rtol=1e-5)
        loose = dict(atol=lr * steps, rtol=1e-3)
        for (path, g), (_, w) in zip(leaves_with_paths(got[key]),
                                     leaves_with_paths(want[key])):
            g = g.detach().float().cpu().numpy()
            w = w.detach().float().cpu().numpy()
            off = ~np.isclose(g, w, **tight)
            tol = tight
            if compress and (off.mean() <= FLIP_SHARE
                             or off.sum() <= FLIP_COUNT):
                tol = loose
            np.testing.assert_allclose(g, w, **tol,
                                       err_msg=f"{what} {key}{path}")
            worst = max(worst, float(np.abs(g - w).max()))
    return worst


def run_reduced_training(np, torch, device, archs):
    """Phases 35, 40 and 44: the reduced ``archs`` in float32, the same
    parameters on the card and the CPU: the loss (with the MoE aux term)
    and every gradient leaf (``TRAIN_TOL``), exactly ``train_launches``
    a call (every one on its float32 route); then 3 ``make_train_step``
    steps at 2 microbatches with ``grad_compress`` off and on: losses
    within ``TRAIN_TOL``, the parameters ``held_after_steps``, launches 3
    x 2 x a call's.  Returns the record."""
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.optim.grad_compress import init_error
    from repro_torch.runtime.train_loop import (batch_to, loss_fn,
                                                make_train_step)
    from repro_torch.tree import leaves, leaves_with_paths
    record = {}
    for arch in archs:
        cfg = get_arch(arch).reduced()
        want = train_launches(cfg, 1)
        route = train_routes(torch, cfg, "float32")
        models = {"cpu": build_model(cfg, "cpu"),
                  "cuda": build_model(cfg, device)}
        p_cpu = models["cpu"].init(torch.Generator().manual_seed(0))

        def params_on(dev):
            return tree_map(
                lambda t: t.detach().to(dev, copy=True).requires_grad_(),
                p_cpu)

        batch = train_batch(np, cfg, 2, 24, 1)
        out = {}
        for dev in ("cpu", "cuda"):
            p = params_on(device if dev == "cuda" else "cpu")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            loss = loss_fn(models[dev], cfg, p, batch_to(
                batch, device if dev == "cuda" else "cpu"))
            loss.backward()
            torch.cuda.synchronize()
            out[dev] = (loss.detach().cpu(), p)
            if dev == "cuda":
                want_launches(f"{arch} train_loss", kernels.launch_counts(),
                              kernels.route_counts(), want, route)
        torch.testing.assert_close(out["cuda"][0], out["cpu"][0], **TRAIN_TOL)
        worst = 0.0
        for (path, g), c in zip(leaves_with_paths(out["cuda"][1]),
                                leaves(out["cpu"][1])):
            torch.testing.assert_close(g.grad.cpu(), c.grad, **TRAIN_TOL,
                                       msg=lambda m: f"{arch} d{path}: {m}")
            worst = max(worst, float((g.grad.cpu() - c.grad).abs().max()))
        rec = {"loss": float(out["cpu"][0]), "grad_max_abs_diff": worst,
               "launches": want}
        log(f"  {cfg.name}: loss {rec['loss']:.6f}, every gradient card vs "
            f"CPU within {TRAIN_TOL} (max abs diff {worst:.3g}); launches "
            f"{want}, each on its float32 route")
        for compress in (False, True):
            tc = TrainConfig(steps=3, lr=1e-3, warmup_steps=1,
                             microbatches=2, grad_compress=compress)
            states, losses = {}, {}
            for dev in ("cpu", "cuda"):
                p = params_on(device if dev == "cuda" else "cpu")
                st = {"params": p, "opt": init_opt_state(p)}
                if compress:
                    st["err"] = init_error(p)
                step = make_train_step(models[dev], cfg, tc)
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                losses[dev] = []
                for i in range(3):
                    st, m = step(st, train_batch(np, cfg, 4, 16, 10 + i))
                    losses[dev].append(float(m["loss"]))
                torch.cuda.synchronize()
                if dev == "cuda":
                    want_launches(f"{arch} 3 steps", kernels.launch_counts(),
                                  kernels.route_counts(),
                                  {k: 3 * 2 * n for k, n in want.items()},
                                  route)
                states[dev] = {"params": st["params"]}
            np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                                       **TRAIN_TOL)
            gap = held_after_steps(np, f"{arch} compress={compress}",
                                   states["cuda"], states["cpu"], tc.lr, 3,
                                   compress)
            rec[f"steps_compress_{compress}"] = {"losses": losses["cuda"],
                                                 "max_abs_diff": gap}
            log(f"  {cfg.name}: 3 steps, 2 microbatches, grad_compress "
                f"{compress}: losses {[round(x, 5) for x in losses['cuda']]}"
                f" (CPU {[round(x, 5) for x in losses['cpu']]}), state card "
                f"vs CPU max abs diff {gap:.3g}; 3 x 2 x a call's launches")
        record[arch] = rec
    return record


def refuse_grad_on_the_card(torch, device):
    """The bare forward wrappers raise under grad on a CUDA tensor that
    requires grad, before launching, naming the ROADMAP item (for the
    kernels with a backward, the op whose autograd Function launches
    it); through those ops the expert GEMM, the RG-LRU scan and the mLSTM
    chunk launch their forward and, on ``backward``, their backward
    kernels, one each.  Returns the refused wrappers."""
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
    from repro_torch.kernels.mlstm_chunk.ops import mlstm
    from repro_torch.kernels.moe_matmul.moe_matmul import moe_matmul
    from repro_torch.kernels.moe_matmul.ops import expert_gemm
    from repro_torch.kernels.rglru_scan.ops import linear_recurrence
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    x = torch.zeros((1, 2, 8, 64), device=device, requires_grad=True)
    s = torch.zeros((1, 8, 2), device=device)
    z = torch.zeros((1, 2), device=device)
    calls = {
        "flash_attention": lambda: flash_attention(x, x, x),
        "decode_attention": lambda: decode_attention(x, x, x, z[0].int()),
        "moe_matmul": lambda: moe_matmul(x[0], x[0].transpose(1, 2)),
        "rglru_scan": lambda: rglru_scan(x[0], x[0], x[0, :, 0]),
        "mlstm_chunk": lambda: mlstm_chunk(x, x, x, s, s, x, x[..., 0], z,
                                           0.125)}
    kernels.reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "ROADMAP queue 1 item 14" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: ran under grad")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"a refused wrapper launched: "
                             f"{kernels.launch_counts()}")
    w = torch.zeros((2, 64, 8), device=device, requires_grad=True)
    expert_gemm(x[0], w).sum().backward()
    a = torch.zeros((1, 8, 64), device=device, requires_grad=True)
    h, h_last = linear_recurrence(a, a, a[:, 0].detach())
    (h.sum() + h_last.sum()).backward()
    g = torch.zeros((1, 2, 8), device=device)
    hm, *_ = mlstm(x, x, x, g, g, torch.zeros((1, 8, 64, 64), device=device),
                   torch.zeros((1, 8, 64), device=device),
                   torch.full((1, 8), -1e30, device=device), 0.125)
    hm.sum().backward()
    launches = kernels.launch_counts()
    want = only(launches, moe_matmul=1, moe_matmul_dx=1, moe_matmul_dw=1,
                rglru_scan=1, rglru_scan_bwd=1, mlstm_chunk=1,
                mlstm_chunk_bwd=1)
    if launches != want:
        raise AssertionError(f"expert_gemm, linear_recurrence and mlstm "
                             f"under grad: launches {launches}, want {want}")
    return sorted(calls)


def grad_gaps(torch, model, params, toks, labels):
    """Phase 36's in-model check: the gradients through the kernels, the
    plain versions and the plain versions with their q . k sums reordered
    (``plain_kernels``); per leaf the kernels' and the reordered side's
    largest gap from the plain side, and the plain side's largest
    |gradient|."""
    from repro_torch.tree import leaves
    plist = leaves(params)

    def grads(ctx):
        with ctx:
            loss = model.train_loss(params, toks, labels)
            loss.backward()
        # a leaf the loss does not reach (xLSTM's ln2 without an MLP) has
        # no gradient: zeros, as make_train_step and the reference take it
        out = [torch.zeros_like(p) if p.grad is None else p.grad
               for p in plist]
        for p in plist:
            p.grad = None
        torch.cuda.synchronize()
        return loss.item(), out

    plain_loss, plain = grads(plain_kernels())
    gaps = {"plain_loss": plain_loss,
            "top": [float(g.abs().max()) for g in plain]}
    for side, ctx in (("kernels", contextlib.nullcontext()),
                      ("reordered", plain_kernels(True))):
        loss, got = grads(ctx)
        gaps[f"{side}_loss"] = loss
        gaps[side] = [float((a - b).abs().max()) for a, b in zip(got, plain)]
        del got
        torch.cuda.empty_cache()
    del plain
    return gaps


def run_full_training(np, torch, device):
    """Phase 36: the bare forward wrappers refuse grad on the card
    (``refuse_grad_on_the_card``), then minicpm-2b at full width and depth
    trained on the card (``FULL_TRAIN``, ``train_at_full_width``): exactly
    2 x 40 flash launches a microbatch (the recompute doubles them) and 40
    backward launches, every one on wgmma.  Returns the record."""
    refused = refuse_grad_on_the_card(torch, device)
    log(f"  under grad on the card {', '.join(refused)} refuse to launch "
        f"(RuntimeError naming the ROADMAP item); expert_gemm, "
        f"linear_recurrence and mlstm launch their forward and backward "
        f"kernels")
    rec = train_at_full_width(np, torch, device, FULL_TRAIN)
    rec["refused_under_grad"] = refused
    return rec


def train_at_full_width(np, torch, device, f):
    """A model trained on the card at full width (``f``: the arch, its
    depth if cut, S, the batch, microbatches, steps, lr, the check's S):
    bf16 compute on float32 masters, ``remat="full"``, WSD, the counters
    set to 0 just before and read just after: exactly ``train_launches``
    at 2 passes a microbatch, each on its bf16 route; loss and grad norm
    finite every step and, over more than one step, the loss falls; step
    walls, tokens/s, peak
    memory, model FLOP/s (6 N a token over the active parameters, a MoE
    layer's top-k experts of its E, plus 6 H D a kept causal (query, key)
    pair an attention layer; the recompute not counted).  Then the
    gradients at the check's S through the kernels against the plain
    versions: each leaf's gap, as a share of its largest plain gradient,
    within the larger of ``LM_GAP`` x the reordered plain side's largest
    share over the leaves and ``GRAD_FLOOR_ULPS`` ulps of that gradient
    in the check's dtype; with ``f["check_dtype"]`` the check's model
    computes in that dtype, with ``f["check_at_init"]`` on the initial
    parameters (else the trained ones).  Returns the record."""
    import dataclasses
    import math
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import lm_data
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import init_state, make_train_step
    from repro_torch.tree import leaves, leaves_with_paths
    cfg = get_arch(f["arch"])
    if "n_layers" in f:
        cfg = dataclasses.replace(cfg, n_layers=f["n_layers"])
    if cfg.remat != "full" or cfg.dtype != "bfloat16" or \
            cfg.param_dtype != "float32":
        raise AssertionError(f"{cfg.name}: want remat full, bf16 compute, "
                             f"float32 masters")
    model = build_model(cfg, device)
    tcfg = TrainConfig(steps=f["steps"], lr=f["lr"], warmup_steps=0,
                       microbatches=f["microbatches"], schedule="wsd")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_state(model, torch.Generator(device=device).manual_seed(0),
                       tcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    initial = None
    if f.get("check_at_init"):
        # kept on the host, out of the training's peak memory
        initial = tree_map(lambda t: t.detach().to("cpu", copy=True),
                           state["params"])
    n_params = sum(p.numel() for p in leaves(state["params"]))
    step = make_train_step(model, cfg, tcfg)
    data = lm_data(cfg, f["batch"], f["seq"], seed=0, prefetch=0)
    batches = [next(data) for _ in range(f["steps"])]
    tokens = f["batch"] * f["seq"]
    a, m = cfg.attention, cfg.moe
    # the experts a token does not visit: (E - k) of each MoE layer's
    inactive = cfg.n_layers * (m.n_experts - m.top_k) * \
        (3 if cfg.glu else 2) * cfg.d_model * m.d_expert \
        if m.enabled else 0
    active = n_params - inactive
    # 6 N_active a token for the matrices, 6 H D a kept causal (query,
    # key) pair of each attention layer (its window's) for q k^T and P V
    pairs = sum(kept_pairs(f["seq"], f["seq"], True,
                           a.window if k == "attn_local" else 0)
                for k in model.kinds if k.startswith("attn"))
    model_flops = tokens * 6 * active + \
        f["batch"] * 6 * a.n_heads * cfg.head_dim * pairs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, metrics = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches, routes = kernels.launch_counts(), kernels.route_counts()
    peak = torch.cuda.max_memory_allocated()
    per_mb = train_launches(cfg, 2)
    want_launches(f"{cfg.name} training", launches, routes,
                  {k: f["steps"] * f["microbatches"] * n
                   for k, n in per_mb.items()},
                  train_routes(torch, cfg, "bfloat16"))
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics) or \
            (len(losses) > 1 and not losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name} training: metrics {metrics}")
    rec = {"model": cfg.name, "params": n_params, "init_s": init_s,
           "n_layers": cfg.n_layers, "active_params": active,
           "model_flops_formula": "6 N_active a token + 6 H D a kept "
                                  "causal pair an attention layer",
           "seq": f["seq"], "global_batch": f["batch"],
           "microbatches": f["microbatches"], "remat": cfg.remat,
           "steps": metrics, "step_walls_s": walls,
           "tokens_per_s": [tokens / w for w in walls],
           "model_flops_per_step": model_flops,
           "model_tflops_per_s": [model_flops / w / 1e12 for w in walls],
           "peak_memory_gb": peak / 1e9,
           "launches": {k: v for k, v in launches.items() if v},
           "launches_per_microbatch": per_mb,
           "routes": {k: train_routes(torch, cfg, "bfloat16")[k]
                      for k in per_mb}}
    log(f"  {cfg.name} ({cfg.n_layers} layers): {n_params / 1e9:.3f} B "
        f"parameters ({active / 1e9:.3f} B active; float32 masters"
        f" + AdamW moments), initialised in {init_s:.2f} s; {f['steps']} "
        f"steps of {f['microbatches']} x {f['batch'] // f['microbatches']} "
        f"x {f['seq']} tokens: losses {[round(x, 4) for x in losses]}, "
        f"grad norms {[round(m['grad_norm'], 4) for m in metrics]}, lr "
        f"{[m['lr'] for m in metrics]}")
    log(f"  step walls {[round(w, 3) for w in walls]} s, "
        f"{[round(x, 1) for x in rec['tokens_per_s']]} tokens/s, model "
        f"{[round(x, 1) for x in rec['model_tflops_per_s']]} TFLOP/s, peak "
        f"memory {peak / 1e9:.2f} GB; launches {rec['launches']} "
        f"(routes {rec['routes']})")

    # kernels against plain versions inside the model at the check's S
    del state["opt"], step
    gc.collect()
    torch.cuda.empty_cache()
    params = state["params"] if initial is None else tree_map(
        lambda t: t.to(device).requires_grad_(), initial)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, f["check_seq"] + 1)),
                           device=device)
    check_model = model if "check_dtype" not in f else build_model(
        dataclasses.replace(cfg, dtype=f["check_dtype"]), device)
    gaps = grad_gaps(torch, check_model, params, toks[:, :-1], toks[:, 1:])
    rows = []
    paths = [p for p, _ in leaves_with_paths(params)]
    check_dtype = f.get("check_dtype", cfg.dtype)
    ulp = bf16_ulp if check_dtype == "bfloat16" else float32_ulp

    def rel(gap, top):
        return gap / top if top else (0.0 if gap == 0 else math.inf)
    reordered = max(rel(r, t) for r, t in zip(gaps["reordered"],
                                              gaps["top"]))
    for path, k, r, top in zip(paths, gaps["kernels"], gaps["reordered"],
                               gaps["top"]):
        floor = rel(GRAD_FLOOR_ULPS * float(ulp(torch, torch.tensor(top))),
                    top)
        limit = max(LM_GAP * reordered, floor)
        rows.append((rel(k, top) / limit, path, k, r, top,
                     floor > LM_GAP * reordered))
    rows.sort(reverse=True)
    worst_leaves = [dict(zip(("share", "leaf", "kernels_gap",
                              "reordered_gap", "top", "at_floor"), w))
                    for w in rows[:5]]
    for w in worst_leaves:
        log(f"    d{w['leaf']}: kernels gap {w['kernels_gap']:.3g}, "
            f"reordered {w['reordered_gap']:.3g}, largest |g| "
            f"{w['top']:.3g}: {w['share']:.3g} of the limit"
            f"{' (the floor)' if w['at_floor'] else ''}")
    worst, by_floor = rows[0][0], sum(r[-1] for r in rows)
    over = [w for w in rows if not w[0] <= 1.0]
    if over:
        raise AssertionError(
            f"{cfg.name} at S {f['check_seq']}: {len(over)} gradient "
            f"leaves over the larger of {LM_GAP} x the reordered plain's "
            f"largest relative gap {reordered:.3g} and {GRAD_FLOOR_ULPS} "
            f"{check_dtype} ulps of the leaf's largest gradient: "
            f"{worst_leaves}")
    kernels_rel = max(rel(k, t) for k, t in zip(gaps["kernels"],
                                               gaps["top"]))
    rec["grad_check"] = {
        "seq": f["check_seq"], "leaves": len(paths), "dtype": check_dtype,
        "at_init": initial is not None,
        "reordered_largest_relative_gap": reordered,
        "kernels_largest_relative_gap": kernels_rel,
        "kernels_share_of_limit": worst, "leaves_at_floor": by_floor,
        "worst_leaves": worst_leaves,
        "losses": {s: gaps[f"{s}_loss"] for s in ("plain", "kernels",
                                                  "reordered")},
        "largest_gap": {s: max(gaps[s]) for s in ("kernels", "reordered")}}
    log(f"  gradients at S {f['check_seq']} ({check_dtype}"
        f"{', initial parameters' if initial is not None else ''}), kernels "
        f"vs plain inside the model: every one of {len(paths)} leaves "
        f"within its limit (worst {worst:.3g} of it; the kernels' largest "
        f"gap {kernels_rel:.3g} of a leaf's largest gradient, the "
        f"reordered side's {reordered:.3g}; {by_floor} leaves at the "
        f"floor); largest gap "
        f"{max(gaps['kernels']):.3g} (reordered plain "
        f"{max(gaps['reordered']):.3g}); losses "
        f"{rec['grad_check']['losses']}")
    del params, state, model, gaps, initial
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def moe_bwd_operands(torch, seed, e, c, d, f, dtype, device):
    """x ~ N(0, 1) [E, C, D], w ~ N(0, 1/D) [E, D, F] and dy ~ N(0, 1)
    [E, C, F], drawn on the card in float32, then cast to ``dtype``."""
    x, w = moe_operands(torch, seed, e, c, d, f, dtype, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn((e, c, f), generator=gen, device=device)
    return x, w, dy.to(dtype)


def rglru_bwd_operands(torch, seed, b, t, w, last, dtype, device):
    """a, b, h0 of ``rglru_operands``, h from the plain forward, dh ~
    N(0, 1) and, with ``last``, dhT ~ N(0, 1), in ``dtype``."""
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    a, bb, h0 = rglru_operands(torch, seed, b, t, w, dtype, device)
    h, _ = rglru_ref(a, bb, h0)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dh = torch.randn((b, t, w), generator=gen, device=device).to(dtype)
    dhT = torch.randn((b, w), generator=gen, device=device).to(dtype) \
        if last else None
    return a, h, h0, dh, dhT


def rglru_bwd_simt(torch, a, h, h0, dh, dhT):
    """The reverse scan's ``simt`` kernel at any shape, through its
    launcher (route 0; not the wrapper, so uncounted), to time it beside
    the ``tma`` route on the same inputs.  Returns (a call that
    launches it, its outputs (da, db, dh0))."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import rglru_scan as rs
    fn = _build.launcher("rglru_scan_bwd", "repro_rglru_scan_bwd",
                         rs._BWD_ARGTYPES)
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), \
        torch.empty_like(h0)

    def call():
        err = fn(a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(),
                 None if dhT is None else dhT.data_ptr(), da.data_ptr(),
                 db.data_ptr(), dh0.data_ptr(), *a.shape,
                 rs._DTYPES[a.dtype], rs._DTYPES[h0.dtype],
                 rs.BWD_ROUTES.index("simt"),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rglru_scan_bwd simt: error {err}")
    return call, (da, db, dh0)


def check_train_kernels(np, torch, device):
    """Phase 38: the expert GEMM's backward kernels (``moe_matmul_dx``:
    dy w^T, ``moe_matmul_dw``: x^T dy) against their plain versions at
    ``MOE_BWD_CASES``, float32 and bfloat16, within ``MOE_TOL`` and the
    reference's TOL with the contraction of each product (F for dX, C for
    dW), as phase 14 holds the forward; the RG-LRU reverse scan
    (``rglru_scan_bwd``) bitwise against ``rglru_bwd_ref`` at
    ``RGLRU_BWD_CASES`` (h0 nonzero, with and without dhT, T 1, a ragged
    W); each kernel's two launches bitwise equal; dX and dW on
    ``bwd_route``'s route (``wgmma`` for bfloat16 with D and F multiples
    of 8), the reverse scan on ``rglru_route``'s.  Returns the bf16 max
    abs errors at phase 39's shapes (the second granite shape's under
    ``name/down``)."""
    from repro_torch.kernels.moe_matmul.moe_matmul import (bwd_route,
                                                           moe_matmul_dw,
                                                           moe_matmul_dx)
    from repro_torch.kernels.moe_matmul.ref import (moe_matmul_dw_ref,
                                                    moe_matmul_dx_ref)
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref
    from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_route,
                                                          rglru_scan_bwd)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for i, (e, c, d, f) in enumerate(MOE_BWD_CASES):
            x, w, dy = moe_bwd_operands(torch, 800 + i, e, c, d, f, dtype,
                                        device)
            for name, fn, ref, args, k in (
                    ("moe_matmul_dx", moe_matmul_dx, moe_matmul_dx_ref,
                     (dy, w), f),
                    ("moe_matmul_dw", moe_matmul_dw, moe_matmul_dw_ref,
                     (x, dy), c)):
                if name == "moe_matmul_dx" and c == 0:
                    got = fn(*args)         # nothing to launch: C 0 rows
                    if got.shape != (e, 0, d):
                        raise AssertionError(f"{name} C 0: {got.shape}")
                    continue
                got, route = take_route(fn, lambda: fn(*args))
                want_route(name, route, bwd_route(dtype, d, f))
                again = fn(*args)
                want = ref(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {e, c, d, f} {dname}: "
                                         f"two launches differ")
                for tol in (MOE_TOL[dname](max(k, 1)),
                            MOE_REF_TOL[dname](max(k, 1))):
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                if c == 0 and got.any():
                    raise AssertionError(f"{name} at C 0: not zeros")
                err = float((got.double() - want.double()).abs().max())
                if i < 2 and dname == "bfloat16":
                    errs[name if i == 0 else f"{name}/down"] = err
                log(f"  {name} {dname} E={e} C={c} D={d} F={f}: {route}, "
                    f"max abs err {err:.3g}, two launches bitwise equal")
            del x, w, dy
        for i, (b, t, w, last) in enumerate(RGLRU_BWD_CASES):
            args = rglru_bwd_operands(torch, 850 + i, b, t, w, last, dtype,
                                      device)
            got, route = take_route(rglru_scan_bwd,
                                    lambda: rglru_scan_bwd(*args))
            want_route("rglru_scan_bwd", route, rglru_route(dtype, t, w))
            again = rglru_scan_bwd(*args)
            want = rglru_bwd_ref(*args)
            torch.cuda.synchronize()
            for n, g, a2, r in zip(("da", "db", "dh0"), got, again, want):
                if not torch.equal(g, a2):
                    raise AssertionError(f"rglru_scan_bwd {b, t, w}: two "
                                         f"launches differ in {n}")
                if not torch.equal(g, r):
                    raise AssertionError(
                        f"rglru_scan_bwd {dname} {b, t, w}: {n} differs "
                        f"from the plain version in "
                        f"{int((g != r).sum())} elements")
            if (b, t, w) == RGLRU_BWD_CASES[0][:3] and dname == "float32":
                errs["rglru_scan_bwd"] = 0.0
            log(f"  rglru_scan_bwd {dname} B={b} T={t} W={w} dhT="
                f"{'given' if last else 'none'} ({route}): bitwise equal to "
                f"the plain reverse scan, two launches bitwise equal")
            del args, got, again, want
    torch.cuda.empty_cache()
    return errs


def time_train_kernels(torch, device, errs):
    """Phase 39: the expert GEMM's dX and dW at granite-moe's two training
    shapes (E 32, C 1,280, bfloat16; D 1,024 -> F 512, the gate and up
    products, in the row, and D 512 -> F 1,024, the down product, under
    the row's ``down``) and the RG-LRU reverse scan at recurrentgemma's
    (B 1, T 4,096, W 4,096, float32, dhT given), CUDA events in a graph
    and eager, beside their plain versions, ``torch.bmm`` on the
    transposed operands (the expert GEMM; no single PyTorch call computes
    the reverse scan) and their bounds from this run's shapes; each row's
    ``kernel_route`` is the route its timed launch took.  The reverse
    scan's row also times the ``simt`` kernel on the same inputs (under
    ``simt``; its outputs bitwise the ``tma`` launch's).  Then the forward
    scan at the same shape (float32, bitwise against ``rglru_ref``), for
    the ``rglru_scan`` row's ``train``.  Returns {"rows": the three
    ``kernels`` rows, "rglru_scan_train": the forward's timing};
    ``launches`` is filled from phase 41."""
    from repro_torch.kernels.moe_matmul.moe_matmul import (moe_matmul_dw,
                                                           moe_matmul_dx)
    from repro_torch.kernels.moe_matmul.ref import (moe_matmul_dw_ref,
                                                    moe_matmul_dx_ref)
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref
    from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_scan,
                                                          rglru_scan_bwd)

    def timed(name, fn, kern, plain, lib, work, shape, dname, plain_graph):
        _, route = take_route(fn, kern)
        iters = 5 if plain_graph else 20
        ms = time_ms(torch, kern, iters, graph=True)
        eager_ms = time_ms(torch, kern, iters, graph=False)
        plain_ms = time_ms(torch, plain, iters if plain_graph else 1,
                           graph=plain_graph)
        lib_ms = time_ms(torch, lib, iters, graph=True) if lib else None
        nbytes, nops = work.bytes, work.flops
        out = {"ms": ms, "plain_ms": plain_ms,
               **bound_keys(work),
               "library_ms": lib_ms, "eager_ms": eager_ms,
               "plain_timing": "graph" if plain_graph else "eager",
               "kernel_route": route, "shape": shape, "dtype": dname,
               "bytes": nbytes, "operations": nops,
               "tflops": nops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6}
        log(f"  {name} {shape} {dname} ({route}): {ms:.4f} ms in a graph, "
            f"{eager_ms:.4f} ms eager ({out['tflops']:.2f} TFLOP/s, "
            f"{out['gb_per_s']:.1f} GB/s); plain {plain_ms:.4f} ms "
            f"({out['plain_timing']})"
            + (f"; torch.bmm {lib_ms:.4f} ms" if lib else "")
            + f"; bound {out['bound_ms']:.4f} ms ({out['bound_by']})")
        return out

    def moe_bwd(i):
        """dX's and dW's timings at ``MOE_BWD_CASES[i]``."""
        e, c, d, f = MOE_BWD_CASES[i]
        x, w, dy = moe_bwd_operands(torch, 800 + i, e, c, d, f,
                                    torch.bfloat16, device)
        out = {
            "moe_matmul_dx": timed(
                "moe_matmul_dx", moe_matmul_dx, lambda: moe_matmul_dx(dy, w),
                lambda: moe_matmul_dx_ref(dy, w),
                lambda: torch.bmm(dy, w.transpose(1, 2)),
                KERNEL_WORK["moe_matmul_dx"](dy, w), [e, c, d, f],
                "bfloat16", True),
            "moe_matmul_dw": timed(
                "moe_matmul_dw", moe_matmul_dw, lambda: moe_matmul_dw(x, dy),
                lambda: moe_matmul_dw_ref(x, dy),
                lambda: torch.bmm(x.transpose(1, 2), dy),
                KERNEL_WORK["moe_matmul_dw"](x, dy), [e, c, d, f],
                "bfloat16", True)}
        del x, w, dy
        torch.cuda.empty_cache()
        return out

    rows = []
    gate_up, down = moe_bwd(0), moe_bwd(1)
    for name in ("moe_matmul_dx", "moe_matmul_dw"):
        rows.append(dict(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/moe_matmul_bwd.cu",
             "replaces": "src/repro/models/moe.py:82",
             "replaces_note": "no Pallas kernel has a backward: XLA's "
                              "gradient of the reference's einsum",
             "launches": None, "max_abs_err": errs[name],
             "library": "torch.bmm (transposed operands)"},
            **gate_up[name],
            down=dict(down[name], max_abs_err=errs[f"{name}/down"])))
    b, t, width, _ = RGLRU_BWD_CASES[0]
    rargs = rglru_bwd_operands(torch, 900, b, t, width, True,
                               torch.float32, device)
    nbytes = KERNEL_WORK["rglru_scan_bwd"](*rargs).bytes
    row = dict(
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan_bwd.cu",
         "replaces": "src/repro/models/recurrent.py:76",
         "replaces_note": "no Pallas kernel has a backward: XLA's gradient "
                          "of the reference's associative scan",
         "launches": None, "max_abs_err": errs["rglru_scan_bwd"],
         "library": None},
        **timed("rglru_scan_bwd", rglru_scan_bwd,
                lambda: rglru_scan_bwd(*rargs),
                lambda: rglru_bwd_ref(*rargs), None,
                KERNEL_WORK["rglru_scan_bwd"](*rargs), [b, t, width],
                "float32", False))
    simt, simt_out = rglru_bwd_simt(torch, *rargs)
    simt()
    got = rglru_scan_bwd(*rargs)
    torch.cuda.synchronize()
    if not all(torch.equal(g, o) for g, o in zip(got, simt_out)):
        raise AssertionError("rglru_scan_bwd: the simt and tma kernels "
                             "differ at the timed shape")
    s_ms = time_ms(torch, simt, 20, graph=True)
    row["simt"] = {"ms": s_ms, "eager_ms": time_ms(torch, simt, 20,
                                                   graph=False),
                   "gb_per_s": nbytes / s_ms / 1e6, "bitwise_vs_tma": True}
    log(f"  rglru_scan_bwd simt kernel at the same inputs: {s_ms:.4f} ms in "
        f"a graph, {row['simt']['eager_ms']:.4f} ms eager "
        f"({row['simt']['gb_per_s']:.1f} GB/s), bitwise the tma launch")
    rows.append(row)
    del rargs, got, simt, simt_out
    a, bb, h0 = rglru_operands(torch, 910, b, t, width, torch.float32, device)
    got, want = rglru_scan(a, bb, h0), rglru_ref(a, bb, h0)
    torch.cuda.synchronize()
    if not all(torch.equal(g, r) for g, r in zip(got, want)):
        raise AssertionError("rglru_scan at the training shape differs from "
                             "the plain version")
    fwd = dict(timed("rglru_scan", rglru_scan, lambda: rglru_scan(a, bb, h0),
                     lambda: rglru_ref(a, bb, h0), None,
                     KERNEL_WORK["rglru_scan"](a, bb, h0), [b, t, width],
                     "float32", False), max_abs_err=0.0)
    del a, bb, h0, got, want
    torch.cuda.empty_cache()
    return {"rows": rows, "rglru_scan_train": fwd}


def run_full_training_slice(np, torch, device):
    """Phase 41: ``FULL_TRAIN_SLICE`` through ``train_at_full_width``:
    granite-moe-1b-a400m at full width and depth (exactly 2 x 72 expert
    GEMMs, 72 dX and 72 dW, 2 x 24 flash and 24 backward launches a
    microbatch) and recurrentgemma-9b at full width, 9 layers (2 x 6 RG-LRU
    scans and 6 reverse scans, 2 x 3 flash and 3 backward launches a
    microbatch).  Returns the records by arch."""
    out = {}
    for f in FULL_TRAIN_SLICE:
        t0 = time.perf_counter()
        out[f["arch"]] = train_at_full_width(np, torch, device, f)
        out[f["arch"]]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_train_example(np, torch, device):
    """Phase 37: ``examples/torch_train_lm.py`` on the card (its default
    device), the default run and ``--simulate-failure`` (restore from the
    latest committed checkpoint, resume), each with the counters set to 0
    just before and read just after: exactly 2 microbatches x 6 flash and
    6 backward launches a step run, both on the SIMT route (float32); the
    example's own assert that the loss fell.  Returns the
    record."""
    import io
    import shutil
    from repro_torch import kernels
    mod = load_example("torch_train_lm")
    record = {}
    for name, argv in (("default", []),
                       ("simulate-failure", ["--simulate-failure"])):
        ckpt_dir = os.path.join(HERE, "build", "torch_train_lm", name)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = mod.main(argv + ["--ckpt-dir", ckpt_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_step = out["microbatches"] * out["n_layers"]
        want_launches(f"torch_train_lm {name}", kernels.launch_counts(),
                      kernels.route_counts(),
                      {"flash_attention": per_step * out["steps"],
                       "flash_attention_bwd": per_step * out["steps"]},
                      {"flash_attention": "simt",
                       "flash_attention_bwd": "simt"})
        if (out["restored_step"] is None) == (name == "simulate-failure") \
                or out["plan"] is None:
            raise AssertionError(f"torch_train_lm {name}: {out}")
        record[name] = {"first_loss": out["first"], "last_loss": out["last"],
                        "steps_run": out["steps"],
                        "restored_step": out["restored_step"],
                        "launches": per_step * out["steps"], "wall_s": wall,
                        "plan_blocks_per_stage":
                            out["plan"].blocks_per_stage}
        log(f"  {name}: loss {out['first']:.4f} -> {out['last']:.4f} over "
            f"{out['steps']} steps run (restored at "
            f"{out['restored_step']}), {per_step * out['steps']} flash + "
            f"{per_step * out['steps']} backward launches (simt), wall "
            f"{wall:.2f} s; plan {out['plan'].blocks_per_stage}")
        log("  " + printed.getvalue().strip().splitlines()[-1])
    return record


# ---------------------------------------------------------------------------
# xLSTM training: the mLSTM chunk backward kernel
# ---------------------------------------------------------------------------

#: phase 42's backward cases (B, S, H, D, initial state, the final state's
#: gradients given, input-gate offset): xlstm-350m's training call (zero
#: state, none: training's), its served prefill (B 8 at S 1,024 and the
#: ragged 1,000), S 1, 37 and 100 at D 256, D 16, 32, 64 and 128, two
#: cases built for the normaliser's branches: input gates 3 below (the
#: exp(-m_t) branch wins at most steps) and 4 above (|den_raw| wins), and
#: a ``held`` state (m0 12 up, input gates 3 down) whose m0 holds the max
#: over a_s in every chunk: the residual of mx_L's gradient reaches dm0
MLSTM_BWD_CASES = [
    (1, 4096, 4, 256, "zero", False, 0.0),
    (8, 1024, 4, 256, "random", True, 0.0),
    (8, 1000, 4, 256, "zero", True, 0.0),
    (2, 1, 4, 256, "random", True, 0.0),
    (2, 37, 4, 256, "random", False, 0.0),
    (2, 100, 4, 256, "zero", False, 0.0),
    (2, 200, 2, 16, "random", True, 0.0),
    (2, 200, 2, 32, "zero", True, 0.0),
    (2, 130, 2, 64, "random", False, 0.0),
    (2, 130, 2, 128, "random", True, 0.0),
    (2, 300, 4, 256, "random", True, -3.0),
    (2, 300, 4, 256, "random", True, 4.0),
    (2, 100, 4, 256, "held", True, 0.0),
]
#: the backward against its plain version at the kernel's chunks: each
#: gradient within this share of its largest magnitude (float32 sums in
#: another order), rtol 1e-4; a bfloat16 dq, dk, dv one output rounding
#: more (rtol 1e-2)
MLSTM_BWD_SHARE = 1e-4
#: phase 45: xlstm-350m at full width and depth, as phase 36, one step
#: (its gates are a step's launches, the gradient check and the backward's
#: operands, none of which needs a second), the sequence cut to 1,024 and
#: the gradient check at a quarter of it, as phase 36's: each token of a
#: layer's sLSTM is a step of eager launches
#: under autograd (ROADMAP item 21; PERF.md section 5 has the step walls
#: at S 1,024 and 4,096).  The check computes in float32 on the initial
#: parameters: in bf16 the model's gradients are chaotic at random init,
#: and in float32 after the three steps, the plain side moving by 1.9-4.8
#: and by 0.07-0.3 of a leaf's largest gradient when only its mLSTM
#: chunks change, against 0.007 in float32 at init (ROADMAP section 3,
#: ``scripts/probe_xlstm_grad_gate.py``).  Its plain side runs the mLSTM
#: at the kernels' chunks, its reordered side at 64 (``plain_kernels``)
FULL_TRAIN_XLSTM = dict(FULL_TRAIN, arch="xlstm-350m", seq=1024, steps=1,
                        check_seq=256, check_dtype="float32",
                        check_at_init=True)


def mlstm_bwd_operands(torch, seed, case, dtype, device):
    """``mlstm_operands`` for the forward's arguments (a zero state: m
    -1e30; a ``held`` one: m 12 up, input gates 3 down), input gates
    offset by the case's, dh ~ N(0, 1) in ``dtype`` and, where the case
    gives them, the final state's gradients dC1, dn1, dm1 ~ N(0, 1), each
    drawn on its own (so mx_L's residual dm1 - <dC1, C1> - <dn1, n1> is
    not 0).  Returns (the forward's arguments, scale, dh, (dC1, dn1,
    dm1))."""
    b, s, h, d, state, final, ibias = case
    args = list(mlstm_operands(torch, seed, b, s, h, d, dtype, device))
    args[3] = args[3] + ibias
    if state == "zero":
        args[5:] = [torch.zeros_like(args[5]), torch.zeros_like(args[6]),
                    torch.full_like(args[7], -1e30)]
    elif state == "held":
        args[3], args[7] = args[3] - 3.0, args[7] + 12.0
    scale = 1.0 / d ** 0.5
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dh = torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
    seeds = (None, None, None)
    if final:
        seeds = (torch.randn((b, h, d, d), generator=gen, device=device),
                 torch.randn((b, h, d), generator=gen, device=device),
                 torch.randn((b, h), generator=gen, device=device))
    return args, scale, dh, seeds


def raw_branch_share(torch, args, scale):
    """The share of steps whose normaliser is |den_raw| rather than
    exp(-m_t), in the plain version's chunks of ``BWD_CHUNK``."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import BWD_CHUNK
    from repro_torch.kernels.mlstm_chunk.ref import raw_normaliser
    return float(raw_normaliser(*args, scale, chunk=BWD_CHUNK).float()
                 .mean())


def held_mlstm_bwd(torch, got, want, what):
    """Each gradient of ``got`` against ``want`` within
    ``MLSTM_BWD_SHARE`` of its largest magnitude (rtol 1e-4; 1e-2 for a
    bfloat16 one).  Returns {gradient: its max abs error as a share of its
    largest magnitude} and the bf16 dq, dk, dv max abs error."""
    shares, err = {}, 0.0
    for name, g, w in zip(("dq", "dk", "dv", "di", "df", "dC0", "dn0",
                           "dm0"), got, want):
        top = float(w.float().abs().max())
        torch.testing.assert_close(
            g.float(), w.float(), atol=MLSTM_BWD_SHARE * top,
            rtol=1e-2 if g.dtype == torch.bfloat16 else 1e-4,
            msg=lambda m: f"mlstm_chunk_bwd {what} {name}: {m}")
        gap = float((g.double() - w.double()).abs().max())
        shares[name] = gap / top if top else gap
        err = max(err, gap)
    return shares, err


def check_mlstm_bwd(np, torch, device):
    """Phase 42: the mLSTM chunk backward kernel against
    ``mlstm_chunk_bwd_ref`` at its chunks (``BWD_CHUNK``) on the card at
    ``MLSTM_BWD_CASES``, float32 and bfloat16 (``held_mlstm_bwd``); two
    launches bitwise equal; each launch on ``mlstm_bwd_route``'s route
    (``wgmma`` in bfloat16, ``simt`` in float32); the two branch cases
    each with most steps on their branch, the ``held`` case with m0
    holding the max in every chunk; first the wrapper's workspace size
    (``bwd_workspace_bytes``) against the launcher's own layout at every
    case on both routes.  Returns the bf16 max abs error at the training
    call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        BWD_CHUNK, BWD_ROUTES, bwd_workspace_bytes, mlstm_bwd_route,
        mlstm_chunk_bwd)
    from repro_torch.kernels.mlstm_chunk.ref import (m0_holds_max,
                                                     mlstm_chunk_bwd_ref)
    size = _build.launcher("mlstm_chunk_bwd",
                           "repro_mlstm_chunk_bwd_workspace",
                           [ctypes.c_int] * 5, ctypes.c_longlong)
    for case in MLSTM_BWD_CASES:
        for code, route in enumerate(BWD_ROUTES):
            mine, theirs = bwd_workspace_bytes(*case[:4], route), \
                size(*case[:4], code)
            if mine != theirs:
                raise AssertionError(f"mlstm_chunk_bwd {case[:4]} {route}: "
                                     f"workspace {mine} B, launcher's "
                                     f"layout {theirs} B")
    log(f"  mlstm_chunk_bwd workspace: bwd_workspace_bytes equals the "
        f"launcher's layout at all {len(MLSTM_BWD_CASES)} cases on "
        f"{' and '.join(BWD_ROUTES)}")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for i, case in enumerate(MLSTM_BWD_CASES):
            args, scale, dh, seeds = mlstm_bwd_operands(torch, 1000 + i,
                                                        case, dtype, device)
            got, route = take_route(mlstm_chunk_bwd, lambda: mlstm_chunk_bwd(
                *args, scale, dh, *seeds))
            want_route("mlstm_chunk_bwd", route,
                       mlstm_bwd_route(dtype, case[1], case[3]))
            again = mlstm_chunk_bwd(*args, scale, dh, *seeds)
            want = mlstm_chunk_bwd_ref(*args, scale, dh, *seeds,
                                       chunk=BWD_CHUNK)
            torch.cuda.synchronize()
            for name, a, a2 in zip(("dq", "dk", "dv", "di", "df", "dC0",
                                    "dn0", "dm0"), got, again):
                if not torch.equal(a, a2):
                    raise AssertionError(f"mlstm_chunk_bwd {case} {dname}: "
                                         f"two launches differ in {name}")
            shares, err = held_mlstm_bwd(torch, got, want, f"{case} {dname}")
            branch = ""
            if case[-1]:
                share = raw_branch_share(torch, args, scale)
                if (share > 0.2) if case[-1] < 0 else (share < 0.8):
                    raise AssertionError(f"mlstm_chunk_bwd {case}: |den_raw|"
                                         f" wins at {share:.3f} of steps")
                branch = f", |den_raw| the normaliser at {share:.3f} of steps"
            if case[4] == "held":
                if not bool(m0_holds_max(*args, scale, chunk=BWD_CHUNK)
                            .all()):
                    raise AssertionError(f"mlstm_chunk_bwd {case}: m0 does "
                                         f"not hold every chunk's max")
                branch = ", m0 holding every chunk's max"
            if i == 0 and dtype == torch.bfloat16:
                errs["train"] = err
            worst = max(shares, key=shares.get)
            log(f"  mlstm_chunk_bwd {dname} B={case[0]} S={case[1]} "
                f"H={case[2]} D={case[3]} state {case[4]}, final-state "
                f"gradients {'given' if case[5] else 'none'}{branch}: "
                f"{route}, max abs err {err:.3g} (worst {worst} "
                f"{shares[worst]:.3g} of its largest), two launches bitwise "
                f"equal")
            del args, dh, seeds, got, again, want
    torch.cuda.empty_cache()
    return errs


def mlstm_bwd_floor(work, b, s, h, d):
    """The ``wgmma`` route's own least traffic: the call's bytes (``work``,
    its ``KERNEL_WORK``) plus its workspace's state planes (C_c and
    dC_{c+1}, bf16 hi + lo: 4 bytes an element of each chunk's D x D, D
    padded to 64) as it moves them: C_c written once and read twice (the
    gradient walk's <dC, C>, the gradient pass), dC_{c+1} written once
    and read once.  Returns bytes."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import BWD_CHUNK
    dp = -(-d // 64) * 64
    planes = b * h * -(-s // BWD_CHUNK) * dp * dp * 4
    return work.bytes + 5 * planes


def mlstm_bwd_simt(torch, args, scale, dh):
    """The backward's ``simt`` kernel on bfloat16 inputs, through its
    launcher (route 0; not the wrapper, so uncounted), to time it beside
    the ``wgmma`` route on the same inputs.  Returns (a call that
    launches it, its outputs (dq, dk, dv, di, df, dC0, dn0, dm0))."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk as mc
    q = args[0]
    b, s, h, d = q.shape
    code = mc.BWD_ROUTES.index("simt")
    size = _build.launcher("mlstm_chunk_bwd",
                           "repro_mlstm_chunk_bwd_workspace",
                           [ctypes.c_int] * 5, ctypes.c_longlong)
    nbytes = size(b, s, h, d, code)
    work = torch.empty((nbytes + 3) // 4, dtype=torch.float32,
                       device=q.device)
    fn = _build.launcher("mlstm_chunk_bwd", "repro_mlstm_chunk_bwd",
                         mc._BWD_ARGTYPES)
    outs = [torch.empty_like(q) for _ in range(3)] + \
        [torch.empty_like(args[3]) for _ in range(2)] + \
        [torch.empty_like(t) for t in args[5:8]]

    def call():
        err = fn(*(t.data_ptr() for t in (*args, dh)), None, None, None,
                 *(t.data_ptr() for t in (*outs, work)), nbytes, b, s, h, d,
                 mc._DTYPES[q.dtype], code, float(scale),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mlstm_chunk_bwd simt: error {err}")
    return call, outs


def time_mlstm_bwd(torch, device, errs):
    """Phase 43: the backward kernel at xlstm-350m's training call (B 1,
    S 4,096, H 4, D 256, bfloat16, the zero state, no final-state
    gradients) on its route (``wgmma``), CUDA events in a graph and eager,
    beside its plain version (eager), its bound from this run's shape
    (bytes against the bf16 tensor-core peak; the fp32 SIMT bound beside
    it), the route's workspace floor (``mlstm_bwd_floor``) and the device
    time of its kernels (``torch.profiler``); no PyTorch call computes it.
    The ``simt`` kernel on the same inputs beside it (through its
    launcher, held against the ``wgmma`` outputs within
    ``MLSTM_BWD_SHARE``).  Then the forward kernel at the same shape (the
    training call's: ``wgmma``, 16 blocks at B 1), checked against its
    plain version.  Returns the ``kernels`` row and the forward's
    timing."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (mlstm_chunk,
                                                            mlstm_chunk_bwd)
    from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_bwd_ref,
                                                     mlstm_chunk_ref)
    case = MLSTM_BWD_CASES[0]
    b, s, h, d = case[:4]
    args, scale, dh, _ = mlstm_bwd_operands(torch, 1100, case,
                                            torch.bfloat16, device)
    kern = lambda: mlstm_chunk_bwd(*args, scale, dh)             # noqa
    plain = lambda: mlstm_chunk_bwd_ref(*args, scale, dh)        # noqa
    got, route = take_route(mlstm_chunk_bwd, kern)
    want_route("mlstm_chunk_bwd", route, "wgmma")
    work = KERNEL_WORK["mlstm_chunk_bwd"](*args, scale, dh)
    nbytes, nops = work.bytes, work.flops
    t_bytes = kernel_bound(work).memory_s * 1e3
    t_tc = max(t_bytes, nops / BF16_OPS_PER_S * 1e3)
    t_simt = max(t_bytes, nops / FP32_OPS_PER_S * 1e3)
    floor = mlstm_bwd_floor(work, b, s, h, d)
    ms = time_ms(torch, kern, 5, graph=True)
    row = {"name": "mlstm_chunk_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/mlstm_chunk_bwd.cu",
           "replaces": "src/repro/models/recurrent.py:216",
           "replaces_note": "no Pallas kernel has a backward: XLA's "
                            "gradient of the reference's mlstm_chunk_math "
                            "under mlstm_seq",
           "launches": None, "max_abs_err": errs["train"],
           "ms": ms, "eager_ms": time_ms(torch, kern, 5, graph=False),
           "plain_ms": time_ms(torch, plain, 1, graph=False),
           "plain_timing": "eager", "bound_ms": t_tc,
           "bound_by": "bytes" if t_tc <= t_bytes else "operations",
           "bound_fp32_simt_ms": t_simt, "library_ms": None,
           "library": None, "kernel_route": route,
           "workspace_floor_bytes": floor,
           "workspace_floor_ms": floor / HBM_BYTES_PER_S * 1e3,
           "shape": [b, s, h, d], "dtype": "bfloat16", "bytes": nbytes,
           "operations": nops, "tflops": nops / ms / 1e9,
           "gb_per_s": nbytes / ms / 1e6,
           "device_ms_by_kernel": kernel_device_ms(torch, kern, 3)}
    by_kernel = {n: round(t, 4) for n, t in
                 row["device_ms_by_kernel"].items()}
    log(f"  mlstm_chunk_bwd {row['shape']} bf16 ({route}): {ms:.4f} ms in a "
        f"graph, {row['eager_ms']:.4f} ms eager ({row['tflops']:.2f} "
        f"TFLOP/s, {row['gb_per_s']:.1f} GB/s); plain {row['plain_ms']:.4f} "
        f"ms (eager); no library call; bound {t_tc:.4f} ms "
        f"({row['bound_by']}; {t_simt:.4f} ms at the fp32 SIMT peak); the "
        f"route's workspace floor {row['workspace_floor_ms']:.4f} ms "
        f"({floor / 1e6:.1f} MB); device ms by kernel {by_kernel}")
    simt, simt_out = mlstm_bwd_simt(torch, args, scale, dh)
    simt()
    torch.cuda.synchronize()
    held_mlstm_bwd(torch, simt_out, got, "simt against wgmma")
    s_ms = time_ms(torch, simt, 5, graph=True)
    row["simt"] = {"ms": s_ms, "eager_ms": time_ms(torch, simt, 5,
                                                   graph=False),
                   "tflops": nops / s_ms / 1e9,
                   "device_ms_by_kernel": kernel_device_ms(torch, simt, 3)}
    by_kernel = {n: round(t, 4) for n, t in
                 row["simt"]["device_ms_by_kernel"].items()}
    log(f"  mlstm_chunk_bwd simt kernel at the same inputs: {s_ms:.4f} ms "
        f"in a graph, {row['simt']['eager_ms']:.4f} ms eager, within "
        f"MLSTM_BWD_SHARE of the wgmma outputs; device ms by kernel "
        f"{by_kernel}")
    del simt, simt_out, got
    fwd = lambda: mlstm_chunk(*args, scale)                      # noqa
    got, froute = take_route(mlstm_chunk, fwd)
    err = held_mlstm(torch, got, mlstm_chunk_ref(*args, scale),
                     torch.bfloat16)
    fwork = KERNEL_WORK["mlstm_chunk"](*args, scale)
    fops = fwork.flops
    f_ms = time_ms(torch, fwd, 5, graph=True)
    forward = {"shape": [b, s, h, d], "dtype": "bfloat16",
               "kernel_route": froute, "max_abs_err": err, "ms": f_ms,
               "eager_ms": time_ms(torch, fwd, 5, graph=False),
               "blocks": b * h * (d // 64),
               "bound_ms": kernel_bound(fwork).bound_s * 1e3,
               "tflops": fops / f_ms / 1e9}
    log(f"  mlstm_chunk forward at the same shape ({froute}, "
        f"{forward['blocks']} blocks): max abs err {err:.3g}; {f_ms:.4f} ms "
        f"in a graph, {forward['eager_ms']:.4f} ms eager; bound "
        f"{forward['bound_ms']:.4f} ms")
    del args, dh, got
    torch.cuda.empty_cache()
    return {"row": row, "forward_train": forward}


def record_mlstm_bwd(torch):
    """A wrapper set on ``ops._TRAIN_BY_DEVICE["cuda"]`` whose backward
    copies the operands of the first call it serves, launches the real
    kernel and puts the real table entry back.  Returns (the list that
    receives the operands, a call that restores the entry)."""
    from repro_torch.kernels.mlstm_chunk import ops
    fwd, bwd = entry = ops._TRAIN_BY_DEVICE["cuda"]
    seen = []

    def restore():
        ops._TRAIN_BY_DEVICE["cuda"] = entry

    def record(*args):
        if not seen:
            seen.append(tuple(a.detach().clone() if torch.is_tensor(a)
                              else a for a in args))
            restore()
        return bwd(*args)
    ops._TRAIN_BY_DEVICE["cuda"] = (fwd, record)
    return seen, restore


def run_xlstm_training(np, torch, device):
    """Phase 45: ``FULL_TRAIN_XLSTM`` through ``train_at_full_width``:
    xlstm-350m at full width and depth, exactly 2 x 12 mLSTM forward
    launches (``wgmma``) and 12 backward launches (``wgmma``) a
    microbatch and no other kernel (the sLSTM is torch's autograd of its
    step loop); the in-model gradient gate at S 256 on the initial
    parameters in float32 compute (``FULL_TRAIN_XLSTM``: the mLSTM
    forward and backward on ``simt``), the plain side's mLSTM at the
    kernels' chunks.  The operands of the first bf16 backward of the
    training (``record_mlstm_bwd``: the model's own dh) through the
    ``wgmma`` route again, held against ``mlstm_chunk_bwd_ref`` at
    ``BWD_CHUNK`` (``held_mlstm_bwd``).  Returns the record."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (BWD_CHUNK,
                                                            mlstm_chunk_bwd)
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref
    t0 = time.perf_counter()
    seen, restore = record_mlstm_bwd(torch)
    try:
        rec = train_at_full_width(np, torch, device, FULL_TRAIN_XLSTM)
    finally:
        restore()
    rec["wall_s"] = time.perf_counter() - t0
    args = seen[0]
    got, route = take_route(mlstm_chunk_bwd, lambda: mlstm_chunk_bwd(*args))
    want_route("mlstm_chunk_bwd", route, "wgmma")
    want = mlstm_chunk_bwd_ref(*args, chunk=BWD_CHUNK)
    torch.cuda.synchronize()
    shares, err = held_mlstm_bwd(torch, got, want, "in-model operands")
    worst = max(shares, key=shares.get)
    rec["in_model_bwd"] = {"shape": list(args[0].shape),
                           "dtype": str(args[0].dtype).split(".")[1],
                           "route": route, "max_abs_err": err,
                           "shares": shares}
    log(f"  the first mLSTM backward's operands of the bf16 step "
        f"{rec['in_model_bwd']['shape']} through {route} again: every "
        f"gradient within MLSTM_BWD_SHARE of the plain backward (worst "
        f"{worst} {shares[worst]:.3g} of its largest, max abs err "
        f"{err:.3g})")
    del seen, args, got, want
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 46-48: the sharded-model pieces over entries of the card
# ---------------------------------------------------------------------------

EP_ARCH = "olmoe-1b-7b"
#: phase 46's (data, model) meshes of entries of the card
EP_MESHES = ((1, 8), (2, 4))
EP_BATCH, EP_SEQ, EP_STEPS = 8, 1024, 4
#: phase 47: the model, the shape ``plan_pipeline`` plans it at (as phase
#: 30 does), the stages, the batch and the microbatch counts
PIPE_ARCH, PIPE_SHAPE, PIPE_STAGES = "minicpm-2b", "prefill_32k", 4
PIPE_BATCH, PIPE_SEQ, PIPE_MICRO = 8, 2048, (4, 8)
#: phase 48: the reduced model whose gradients are all-reduced, the data
#: axis's entries, each shard's batch (sequences, tokens)
ALLREDUCE_ARCH, ALLREDUCE_SHARDS, ALLREDUCE_BATCH = \
    "granite-moe-1b-a400m", 4, (2, 24)


def counted(torch, fn, span="smoke.call"):
    """``fn()`` in the profiler range ``span``, with the launch counters
    reset just before: (its result, its wall in s ending in a
    synchronise, launches, launches by route)."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.profiler.record_function(span):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, kernels.launch_counts(), kernels.route_counts()


def tp_sharded(model, mesh, batch) -> bool:
    """Whether ``mesh``'s default rules give ``model`` its sharded
    program for a batch of ``batch`` rows."""
    from repro_torch.parallel.sharding import use_mesh_rules
    with use_mesh_rules(mesh):
        return model.spmd("prefill", batch) is not None


def ep_tokens(np, torch, cfg, device):
    """Phase 46's prompt batch, ``EP_BATCH`` x ``EP_SEQ`` seeded ids."""
    return torch.as_tensor(np.random.default_rng(46).integers(
        2, cfg.vocab_size, (EP_BATCH, EP_SEQ)), dtype=torch.int32,
        device=device)


def ep_serve(torch, model, params, toks, mesh, want=None):
    """One prefill of ``toks`` and ``EP_STEPS`` greedy decode steps under
    ``use_mesh_rules(mesh)`` (None: no mesh); with ``want`` (call kind ->
    kernel -> launches) every call held to it, each expert-GEMM and
    flash launch on ``wgmma``.  Each call runs in the profiler range
    ``serve.prefill`` or ``serve.decode``.  Returns each call's (kind,
    wall s, launches) and the last logits."""
    from repro_torch.parallel.sharding import use_mesh_rules
    b, s = toks.shape
    calls = []
    with use_mesh_rules(mesh), torch.no_grad():
        (logits, cache), wall, launches, routes = counted(
            torch, lambda: model.prefill(params, toks, s + EP_STEPS),
            "serve.prefill")
        calls.append(("prefill", wall, launches, routes))
        for i in range(EP_STEPS):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos = torch.full((b, 1), s + i, dtype=torch.int32,
                             device=toks.device)
            (logits, cache), wall, launches, routes = counted(
                torch, lambda: model.decode_step(params, nxt, pos, cache),
                "serve.decode")
            calls.append(("decode", wall, launches, routes))
    if want is not None:
        for kind, wall, launches, routes in calls:
            want_launches(f"{model.cfg.name} {kind} under {mesh}",
                          launches, routes, want[kind],
                          {k: "wgmma" for k in ("moe_matmul",
                                                "flash_attention")
                           if k in want[kind]})
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{model.cfg.name} under {mesh}: logits not "
                             f"finite")
    return [(k, w, n) for k, w, n, _ in calls], logits


def ep_reduced(np, torch, device):
    """The reduced olmoe in float32 under a (2, 4) mesh of the card
    against the same mesh of the CPU: prefill (40 tokens, cache 48) and 4
    decode steps' logits within 1e-4; each card call's expert-GEMM
    launches 3 x 8 a MoE layer, on ``simt`` (float32).  Twice: as the
    reduced config (its 4 heads split over model: the sharded program,
    a position's heads' attention launches), and with 2 heads, which
    ``model`` does not divide (the gap ``heads``: the rules ask for heads
    over model, so the program runs whole under the mesh, one attention
    launch a layer, its MoE through ``moe_apply_expert_parallel``)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.parallel.sharding import make_mesh, use_mesh_rules
    base = get_arch(EP_ARCH).reduced()
    shape = EP_MESHES[-1]
    n = shape[0] * shape[1]
    out = {}
    for program, heads_cfg in (("sharded", base.attention.n_heads),
                               ("whole", 2)):
        cfg = dataclasses.replace(base, attention=dataclasses.replace(
            base.attention, n_heads=heads_cfg, n_kv_heads=heads_cfg))
        cpu = TransformerLM(cfg, device="cpu")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        gpu = TransformerLM(cfg, device=device)
        p_gpu = tree_map(lambda t: t.to(device), p_cpu)
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
        want = {"moe_matmul": 3 * n * cfg.n_layers}
        if tp_sharded(gpu, card_mesh(torch, shape, device), 2) != \
                (program == "sharded"):
            raise AssertionError(f"{cfg.name} with {heads_cfg} heads under "
                                 f"{shape}: not the {program} program")
        heads = n if program == "sharded" else 1
        worst = 0.0
        with torch.no_grad():
            with use_mesh_rules(make_mesh(shape, ("data", "model"),
                                          ["cpu"] * n)):
                lc, cc = cpu.prefill(p_cpu, toks, 48)
                cpu_logits = [lc]
                for i in range(4):
                    nxt = torch.argmax(lc, -1).to(torch.int32)[:, None]
                    pos = torch.full((2, 1), 40 + i, dtype=torch.int32)
                    lc, cc = cpu.decode_step(p_cpu, nxt, pos, cc)
                    cpu_logits.append(lc)
            with use_mesh_rules(make_mesh(shape, ("data", "model"),
                                          [device] * n)):
                (lg, cg), _, launches, routes = counted(
                    torch, lambda: gpu.prefill(p_gpu, toks.to(device), 48))
                want_launches(f"{cfg.name} {program} prefill", launches,
                              routes, dict(want, flash_attention=heads *
                                           cfg.n_layers),
                              {"moe_matmul": "simt",
                               "flash_attention": "simt"})
                for i in range(5):
                    torch.testing.assert_close(lg.cpu(), cpu_logits[i],
                                               atol=1e-4, rtol=1e-4)
                    worst = max(worst, float((lg.cpu() - cpu_logits[i])
                                             .abs().max()))
                    if i == 4:
                        break
                    nxt = torch.argmax(cpu_logits[i], -1).to(torch.int32)
                    pos = torch.full((2, 1), 40 + i, dtype=torch.int32)
                    (lg, cg), _, launches, routes = counted(
                        torch, lambda: gpu.decode_step(
                            p_gpu, nxt[:, None].to(device), pos.to(device),
                            cg))
                    want_launches(f"{cfg.name} {program} decode", launches,
                                  routes, dict(want, decode_attention=heads *
                                               cfg.n_layers),
                                  {"moe_matmul": "simt"})
        log(f"  {cfg.name} ({heads_cfg} heads, the {program} program) "
            f"float32 under a {shape} mesh: prefill + 4 decode logits card "
            f"vs CPU (same mesh of CPU entries) max abs diff {worst:.3g}; "
            f"{want['moe_matmul']} expert-GEMM and {heads * cfg.n_layers} "
            f"attention launches a call")
        out[program] = {"mesh": list(shape), "n_heads": heads_cfg,
                        "max_abs_diff": worst,
                        "moe_launches_per_call": want["moe_matmul"],
                        "attention_launches_per_call": heads * cfg.n_layers}
    return out


def run_expert_parallel(np, torch, device, served):
    """Phase 46: olmoe-1b-7b at full width under ``use_mesh_rules`` of
    ``EP_MESHES``: one prefill of B 8 x S 1,024 and 4 decode steps, exact
    launches a call by route, beside the same calls without a mesh and
    phase 16's served walls (under a mesh the whole model runs sharded:
    each position's experts and heads); the expert GEMM against its
    plain version at every shard shape those calls launched
    (``hold_moe_matmul``), and the attention kernels at theirs
    (``record_shard_calls``, ``hold_recorded``); the kernels against the
    plain versions inside the model under each mesh; the reduced model
    card against CPU, as the sharded program and as the whole program
    under the mesh (``ep_reduced``).  Returns its record."""
    from repro_torch.models.moe import capacity
    from repro_torch.parallel.sharding import make_mesh, use_mesh_rules
    model, params, rec = init_full(torch, EP_ARCH, device)
    cfg = model.cfg
    moe = cfg.moe
    toks = ep_tokens(np, torch, cfg, device)
    runs = {}
    with record_shard_calls() as recorder:
        for shape in (None,) + EP_MESHES:
            n = 1 if shape is None else shape[0] * shape[1]
            mesh = None if shape is None else \
                make_mesh(shape, ("data", "model"), [device] * n)
            # where the mesh's rules give the model its sharded program,
            # every position runs its heads' attention too
            heads = n if mesh is not None and tp_sharded(model, mesh,
                                                         EP_BATCH) else 1
            want = {"prefill": {"moe_matmul": 3 * n * cfg.n_layers,
                                "flash_attention": heads * cfg.n_layers},
                    "decode": {"moe_matmul": 3 * n * cfg.n_layers,
                               "decode_attention": heads * cfg.n_layers}}
            ep_serve(torch, model, params, toks, mesh)            # warm-up
            calls, logits = ep_serve(torch, model, params, toks, mesh, want)
            b_loc = EP_BATCH // (1 if shape is None else shape[0])
            # moe_apply counts a sequence
            seqs = 1 if shape is None else b_loc
            caps = {kind: capacity((EP_SEQ if kind == "prefill" else 1)
                                   * seqs, moe.top_k, moe.n_experts,
                                   moe.capacity_factor)
                    for kind in ("prefill", "decode")}
            name = "none" if shape is None else f"{shape[0]}x{shape[1]}"
            runs[name] = {
                "mesh": None if shape is None else list(shape),
                "prefill_s": calls[0][1],
                "decode_step_ms": [c[1] * 1e3 for c in calls[1:]],
                "launches_per_call": want, "cap": caps,
                # moe_apply's [E, B cap, d]; a shard's [E / |model|, cap, d]
                "buffer_prefill": [
                    moe.n_experts // (1 if shape is None else shape[1]),
                    caps["prefill"] * (EP_BATCH if shape is None else 1),
                    cfg.d_model]}
            log(f"  mesh {name}: prefill B {EP_BATCH} x S {EP_SEQ} "
                f"{calls[0][1] * 1e3:.2f} ms, decode steps "
                f"{[round(c[1] * 1e3, 2) for c in calls[1:]]} ms; "
                f"{want['prefill']['moe_matmul']} expert-GEMM launches a "
                f"call, all wgmma; each shard's cap {caps} (buffer "
                f"{runs[name]['buffer_prefill']} in prefill)")
    p16 = served.get(EP_ARCH, {})
    log(f"  phase 16 served without a mesh (other shapes): prefill median "
        f"{p16.get('prefill_s_median')} s, decode step median "
        f"{p16.get('decode_step_ms_median')} ms")
    # every shard GEMM shape the meshes' timed calls launched, both ways
    held = {}
    for shape in EP_MESHES:
        caps = runs[f"{shape[0]}x{shape[1]}"]["cap"]
        for kind, cap in caps.items():
            for d, f in ((cfg.d_model, moe.d_expert),
                         (moe.d_expert, cfg.d_model)):
                gemm = (moe.n_experts // shape[1], cap, d, f)
                held[str(list(gemm))] = hold_moe_matmul(
                    torch, 460 + len(held), gemm, torch.bfloat16, device)
    held_attention = hold_recorded(torch, recorder.calls)
    gates = {}
    for shape in EP_MESHES:
        with use_mesh_rules(make_mesh(shape, ("data", "model"),
                                      [device] * (shape[0] * shape[1]))):
            diffs = check_lm_kernels_vs_plain(
                torch, model, params, toks[:2].cpu().numpy())
        log_lm_gaps(diffs, f"under a {shape} mesh, B=2 x {EP_SEQ}-token "
                    f"prefill")
        gates[f"{shape[0]}x{shape[1]}"] = diffs
    out = {"model": rec, "runs": runs,
           "phase16_prefill_s_median": p16.get("prefill_s_median"),
           "phase16_decode_step_ms_median": p16.get("decode_step_ms_median"),
           "moe_matmul_at_shard_shapes_max_abs_err": held,
           "attention_at_shard_shapes_max_abs_err": held_attention,
           "kernels_vs_plain_under_mesh": gates,
           "reduced": ep_reduced(np, torch, device)}
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_llhr_pipeline(np, torch, device):
    """Phase 47: minicpm-2b at full width through ``pipelined_forward``
    over ``plan_pipeline``'s 4-stage plan on a ``stage`` mesh of entries
    of the card, at ``PIPE_MICRO`` microbatches: exact flash launches,
    bitwise the unpipelined run microbatch by microbatch, the gap to the
    whole-batch forward.  Returns its record."""
    from repro_torch.configs.registry import get_shape
    from repro_torch.core.channel import ICIChannel, ICIParams
    from repro_torch.core.pipeline_opt import (
        H100_SXM_NVLINK_BYTES_ONE_WAY, card_chip, plan_pipeline)
    from repro_torch.models.blocks import Ctx
    from repro_torch.parallel.pipeline import pipelined_forward, stage_params
    from repro_torch.parallel.sharding import make_mesh
    model, params, rec = init_full(torch, PIPE_ARCH, device)
    cfg = model.cfg
    if set(model.kinds) != {"attn_full"}:
        raise AssertionError(f"{cfg.name}: block kinds {set(model.kinds)}")
    ici = ICIChannel(ICIParams(H100_SXM_NVLINK_BYTES_ONE_WAY,
                               PLAN_HOP_LATENCY_S, PLAN_TORUS,
                               PLAN_DCN_BYTES))
    plan = plan_pipeline(cfg, get_shape(PIPE_SHAPE), PIPE_STAGES,
                         PLAN_CHIPS_PER_STAGE, chip=card_chip(device),
                         ici=ici)
    # arch_cost's units: the embedding, the blocks, the head
    bounds = [min(max(b - 1, 0), cfg.n_layers) for b in plan.boundaries]
    if len(bounds) != PIPE_STAGES + 1 or bounds[0] != 0 or \
            bounds[-1] != cfg.n_layers:
        raise AssertionError(f"plan {plan.boundaries} -> blocks {bounds}")
    blk = model.blocks[0]
    positions = {}

    def block_fn(p, h):
        if h.shape[0] not in positions:
            positions[h.shape[0]] = model._positions(h.shape[0], h.shape[1])
        return blk.apply(p, h, None, Ctx(cfg, "train",
                                         positions[h.shape[0]]))[0]

    def unpipelined(x):
        for p in params["layers"]:
            x = block_fn(p, x)
        return x

    toks = torch.as_tensor(np.random.default_rng(47).integers(
        2, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ)), dtype=torch.int32,
        device=device)
    mesh = make_mesh((PIPE_STAGES,), ("stage",), [device] * PIPE_STAGES)
    per_stage = stage_params(params["layers"], bounds)
    runs = []
    with torch.no_grad():
        x = model._embed(params, toks)
        unpipelined(x)                                         # warm-up
        whole, whole_s, _, _ = counted(torch, lambda: unpipelined(x))
        for n_micro in PIPE_MICRO:
            pipelined_forward(block_fn, per_stage, x, mesh,
                              n_micro=n_micro)                 # warm-up
            y, pipe_s, launches, routes = counted(
                torch, lambda: pipelined_forward(block_fn, per_stage, x,
                                                 mesh, n_micro=n_micro))
            want_launches(f"pipelined forward at {n_micro} microbatches",
                          launches, routes,
                          {"flash_attention": cfg.n_layers * n_micro},
                          {"flash_attention": "wgmma"})
            ref, seq_s, _, _ = counted(torch, lambda: torch.cat(
                [unpipelined(m) for m in x.chunk(n_micro)]))
            if not torch.equal(y, ref):
                raise AssertionError(
                    f"pipelined forward at {n_micro} microbatches differs "
                    f"from the microbatch-by-microbatch run by "
                    f"{float((y.float() - ref.float()).abs().max())}")
            gap = float((y.float() - whole.float()).abs().max())
            logits = model._head(params, y[:, -1:])[:, 0]
            if tuple(logits.shape) != (PIPE_BATCH, cfg.vocab_size) or \
                    not bool(torch.isfinite(logits.float()).all()):
                raise AssertionError("pipelined logits not finite")
            runs.append({"n_micro": n_micro, "pipelined_s": pipe_s,
                         "unpipelined_micro_s": seq_s,
                         "flash_launches": launches["flash_attention"],
                         "max_abs_gap_to_whole_batch": gap,
                         "max_abs_hidden": float(whole.float().abs().max())})
            log(f"  {n_micro} microbatches: pipelined {pipe_s * 1e3:.2f} ms "
                f"({launches['flash_attention']} flash launches, wgmma), "
                f"bitwise the unpipelined run microbatch by microbatch "
                f"({seq_s * 1e3:.2f} ms); whole batch {whole_s * 1e3:.2f} "
                f"ms, largest gap to it {gap:.4g} (largest |hidden| "
                f"{runs[-1]['max_abs_hidden']:.4g})")
    out = {"model": rec, "plan_boundaries": list(plan.boundaries),
           "block_boundaries": bounds, "shape": PIPE_SHAPE,
           "batch": [PIPE_BATCH, PIPE_SEQ], "whole_batch_s": whole_s,
           "runs": runs}
    log(f"  plan at {PIPE_SHAPE}: units {list(plan.boundaries)} -> blocks "
        f"{bounds} ({[b - a for a, b in zip(bounds, bounds[1:])]} a stage)")
    del params, model, per_stage
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_int8_allreduce(np, torch, device):
    """Phase 48: ``psum_compressed`` over a data axis of
    ``ALLREDUCE_SHARDS`` entries of the card on the reduced granite-moe's
    float32 gradients (a seeded batch a shard, its ``stacked_groups``),
    two steps of error feedback, bitwise equal to the same call on the
    CPU.  Returns its record."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.optim.grad_compress import init_error, psum_compressed
    from repro_torch.parallel.sharding import make_mesh
    from repro_torch.runtime.train_loop import batch_to, loss_fn
    from repro_torch.tree import leaves, unflatten_like
    cfg = get_arch(ALLREDUCE_ARCH).reduced()
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    groups = model.stacked_groups(params)
    mesh = make_mesh((ALLREDUCE_SHARDS,), ("data",),
                     [device] * ALLREDUCE_SHARDS)
    devs = list(mesh.devices.flat)

    def grads_of(seed):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(model, cfg, p, batch_to(train_batch(
            np, cfg, *ALLREDUCE_BATCH, seed), device))
        gs = torch.autograd.grad(loss, leaves(p), allow_unused=True)
        return unflatten_like(params, [torch.zeros_like(t) if g is None
                                       else g for g, t in zip(
                                           gs, leaves(params))])

    errs = {"card": [tree_map(lambda t: t.to(d), init_error(params))
                     for d in devs],
            "cpu": [tree_map(lambda t: t.cpu(), init_error(params))
                    for _ in devs]}
    steps = []
    for step in range(2):
        grads = [grads_of(ALLREDUCE_SHARDS * step + i)
                 for i in range(ALLREDUCE_SHARDS)]
        (deq, new_e), wall, _, _ = counted(torch, lambda: psum_compressed(
            [tree_map(lambda t: t.to(d), g) for g, d in zip(grads, devs)],
            errs["card"], groups))
        c_deq, c_new = psum_compressed(
            [tree_map(lambda t: t.cpu(), g) for g in grads], errs["cpu"],
            groups)
        for k in range(ALLREDUCE_SHARDS):
            for what, a, b in (("sum", deq[k], c_deq[k]),
                               ("error", new_e[k], c_new[k])):
                for x, y in zip(leaves(a), leaves(b)):
                    if not torch.equal(x.cpu(), y):
                        raise AssertionError(
                            f"psum_compressed step {step} shard {k} {what}: "
                            f"card differs from the CPU by "
                            f"{float((x.cpu() - y).abs().max())}")
        errs = {"card": new_e, "cpu": c_new}
        n = sum(t.numel() for t in leaves(deq[0]))
        steps.append({"wall_s": wall, "leaves": len(leaves(deq[0])),
                      "values": n,
                      "max_abs_sum": max(float(t.abs().max())
                                         for t in leaves(deq[0])),
                      "max_abs_error": max(float(t.abs().max())
                                           for e in new_e
                                           for t in leaves(e))})
        log(f"  step {step}: {steps[-1]['leaves']} leaves ({n} values, "
            f"{len(groups)} scale groups) over {ALLREDUCE_SHARDS} shards: "
            f"sums and new errors bitwise the CPU's; card call "
            f"{wall * 1e3:.2f} ms; largest |sum| "
            f"{steps[-1]['max_abs_sum']:.4g}, |error| "
            f"{steps[-1]['max_abs_error']:.4g}")
    return {"model": cfg.name, "shards": ALLREDUCE_SHARDS,
            "batch": list(ALLREDUCE_BATCH), "groups": len(groups),
            "steps": steps}

# ---------------------------------------------------------------------------
# the dry run beside the card, and the sanitizer on the main path
# ---------------------------------------------------------------------------

#: phase 49: calls the card already runs, each dry-run on ``meta`` and held
#: to its card run: phase 36's minicpm-2b training step, phase 46's
#: unsharded olmoe-1b-7b prefill and one gemma2-9b decode step at B 8 on
#: phase 12's served cache
DRY_CALLS = ("train", "prefill", "decode")
#: the dry run's bytes a device within this share of the card's peak
DRY_MEMORY_TOL = 0.10
#: phase 50: the sanitized rollout's frames (AlexNet, U 8, B 256)
SANITIZE_T = 4


def dry_call(np, torch, kind, device):
    """One of phase 49's calls built on ``device`` (the card or ``meta``):
    (program, its inputs, model FLOPs, what it is).  Weights and state
    from a seeded generator (``MetaGenerator`` on ``meta``: shapes only);
    the training batch the same host arrays on both."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.cost_model import model_flops
    from repro_torch.device import MetaGenerator
    from repro_torch.models import build_model
    gen = MetaGenerator() if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(0)
    if kind == "train":
        from repro_torch.data.pipeline import lm_data
        from repro_torch.runtime.train_loop import (init_state,
                                                    make_train_step)
        f = FULL_TRAIN
        cfg = get_arch(f["arch"])
        model = build_model(cfg, device)
        tcfg = TrainConfig(steps=f["steps"], lr=f["lr"], warmup_steps=0,
                           microbatches=f["microbatches"], schedule="wsd")
        state = init_state(model, gen, tcfg)
        step = make_train_step(model, cfg, tcfg)
        batch = next(lm_data(cfg, f["batch"], f["seq"], seed=0, prefetch=0))
        shape = ShapeConfig("phase49", f["seq"], f["batch"], "train")
        return (lambda: step(state, batch)[1]), state, \
            model_flops(cfg, shape), \
            f"{cfg.name} training step ({f['batch']} x {f['seq']}, " \
            f"{f['microbatches']} microbatches)"
    if kind == "prefill":
        cfg = get_arch(EP_ARCH)
        model = build_model(cfg, device)
        params = model.init(gen)
        toks = ep_tokens(np, torch, cfg, device)

        def prefill():
            with torch.no_grad():
                return model.prefill(params, toks, EP_SEQ + EP_STEPS)
        shape = ShapeConfig("phase49", EP_SEQ, EP_BATCH, "prefill")
        return prefill, {"params": params, "tokens": toks}, \
            model_flops(cfg, shape), \
            f"{cfg.name} prefill ({EP_BATCH} x {EP_SEQ})"
    cfg = get_arch(LM_ARCH)
    model = build_model(cfg, device)
    params = model.init(gen)
    max_seq = SERVED[LM_ARCH]["max_seq"]
    cache = model.init_cache(LM_BATCH, max_seq)
    toks = torch.full((LM_BATCH, 1), 2, dtype=torch.int32, device=device)
    pos = torch.full((LM_BATCH, 1), max_seq - 1, dtype=torch.int32,
                     device=device)

    def decode():
        with torch.no_grad():
            return model.decode_step(params, toks, pos, cache)[0]
    shape = ShapeConfig("phase49", max_seq, LM_BATCH, "decode")
    return decode, {"params": params, "cache": cache, "tokens": toks,
                    "pos": pos}, model_flops(cfg, shape), \
        f"{cfg.name} decode step (B {LM_BATCH}, cache {max_seq})"


def profile_launches(profile):
    """The launches a profile's kernel calls make on the card, by kernel
    and by route, in the shape of the nonzero entries of
    ``kernels.launch_counts()`` and ``route_counts()``: one a call (the
    chain DP, whose ``step`` route launches L step kernels a call, runs
    in none of phase 49's calls)."""
    calls = profile.kernel_calls()
    launches = {k: sum(r["calls"] for r in v.values())
                for k, v in calls.items()}
    routes = {k: {r: c["calls"] for r, c in v.items()}
              for k, v in calls.items() if "None" not in v}
    return launches, routes


def card_launches():
    """The nonzero entries of ``kernels.launch_counts()`` and
    ``route_counts()``."""
    from repro_torch import kernels
    return ({k: v for k, v in kernels.launch_counts().items() if v},
            {k: {r: c for r, c in v.items() if c}
             for k, v in kernels.route_counts().items()
             if any(v.values())})


def op_differences(meta, card):
    """The aten ops whose (calls, bytes, FLOPs) differ between two
    profiles, and the kernel calls that differ."""
    ops = {k: (tuple(meta.by_op.get(k, ())), tuple(card.by_op.get(k, ())))
           for k in set(meta.by_op) | set(card.by_op)
           if list(meta.by_op.get(k, ())) != list(card.by_op.get(k, ()))}
    kern = {k: (meta.kernel_calls().get(k), card.kernel_calls().get(k))
            for k in set(meta.kernels) | set(card.kernels)
            if meta.kernel_calls().get(k) != card.kernel_calls().get(k)}
    return ops, kern


def run_dry_run(np, torch, device, smi):
    """Phase 49: each of ``DRY_CALLS`` (a) dry-run on ``meta`` (the op
    profiler's counts, its bytes a device, its roofline); (b) run on the
    card under the op profiler, whose counts (the aten products and
    traffic, the kernel calls by name and route with their work) must
    equal meta's exactly, and the card's launch counters (the kernels
    it launched, by route) must equal the launches meta's kernel calls
    make; (c) run again on the
    card without it, after a warm-up, timed by CUDA events, the peak
    memory from ``reset_peak_memory_stats``: meta's bytes within
    ``DRY_MEMORY_TOL`` of ``max_memory_allocated`` above what the card
    held before the call's inputs were made; (d) the roofline's terms
    beside the measured wall.  Returns the record."""
    from repro_torch import kernels
    from repro_torch.launch.dryrun import run_program, storage_bytes
    from repro_torch.launch.roofline import PEAK_FLOPS, build_roofline
    meta = torch.device("meta")
    rec = {"card": smi, "calls": {}}
    for kind in DRY_CALLS:
        program, inputs, mflops, what = dry_call(np, torch, kind, meta)
        t0 = time.perf_counter()
        mprof, mem = run_program(program, inputs)
        mlaunch, mroutes = profile_launches(mprof.profile)
        trace_s = time.perf_counter() - t0
        predicted = storage_bytes(inputs) + mem["output_size_in_bytes"] + \
            mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"]
        roof = build_roofline(mprof.profile, mflops, 1)
        del program, inputs
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        program, inputs, _, _ = dry_call(np, torch, kind, device)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        cprof, _ = run_program(program, inputs)
        torch.cuda.synchronize()
        claunch, croutes = card_launches()
        same = mprof.profile.counts() == cprof.profile.counts() and \
            mlaunch == claunch and mroutes == croutes
        if not same:
            ops, kern = op_differences(mprof.profile, cprof.profile)
            for k, (m, c) in sorted(ops.items()):
                log(f"  {kind}: {k}: meta (calls, bytes, flops) {m}, card "
                    f"{c}")
            raise AssertionError(
                f"phase 49 {what}: the card's counts differ from the dry "
                f"run's: dot_flops {cprof.profile.dot_flops} vs "
                f"{mprof.profile.dot_flops}, traffic "
                f"{cprof.profile.traffic_bytes} vs "
                f"{mprof.profile.traffic_bytes}; kernels {kern}; launches "
                f"{claunch} vs {mlaunch}, routes {croutes} vs {mroutes}")
        del cprof
        program()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        program()
        end.record()
        torch.cuda.synchronize()
        wall_s = start.elapsed_time(end) / 1e3
        peak = torch.cuda.max_memory_allocated() - base
        share = abs(predicted - peak) / peak
        r = roof.to_dict()
        rec["calls"][kind] = {
            "what": what, "trace_s": trace_s,
            "counts": mprof.profile.counts(),
            "launches": claunch, "routes": croutes,
            "predicted_bytes": predicted, "memory": mem,
            "max_memory_allocated_above_base": peak,
            "memory_base": base, "memory_share_off": share,
            "roofline": r, "wall_s": wall_s,
            "step_s_over_wall": r["step_s"] / wall_s,
            "model_flops_fraction": mflops / PEAK_FLOPS / wall_s}
        log(f"  {what}: counts on the card == the dry run's "
            f"(dot {mprof.profile.dot_flops:.4g} FLOP, traffic "
            f"{mprof.profile.traffic_bytes:.4g} B, kernels "
            f"{sorted(mprof.profile.kernels)}; traced on meta in "
            f"{trace_s:.2f} s)")
        log(f"  {what}: predicted {predicted / 1e9:.3f} GB, card peak "
            f"{peak / 1e9:.3f} GB above {base / 1e9:.3f} GB held before "
            f"({share * 100:.2f} % off)")
        log(f"  {what}: roofline compute {r['compute_s'] * 1e3:.3f} ms, "
            f"memory {r['memory_s'] * 1e3:.3f} ms, bottleneck "
            f"{r['bottleneck']}, step_s {r['step_s'] * 1e3:.3f} ms; wall "
            f"{wall_s * 1e3:.3f} ms (CUDA events); step_s / wall "
            f"{r['step_s'] / wall_s:.4f}; model FLOPs / bf16 peak / wall "
            f"{mflops / PEAK_FLOPS / wall_s:.4f} ({smi})")
        if share > DRY_MEMORY_TOL:
            raise AssertionError(
                f"phase 49 {what}: the dry run's {predicted} B a device is "
                f"{share * 100:.2f} % off the card's peak {peak} B")
        del program, inputs
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def run_sanitized_rollout(np, torch, device):
    """Phase 50: the main path's rollout (AlexNet, U 8, B 256,
    ``SANITIZE_T`` frames, fused P2) on ``PLAN_FN_CACHE``: one warm-up run
    (its build), then a run inside ``sanitized(PLAN_FN_CACHE)`` (every
    aten op's floating output checked for NaN, the re-build audit):
    neither a NaN nor a build; then a run fed one position at +inf must
    raise ``FloatingPointError`` naming the op on the card that made the
    first NaN: the host hands the inf over as it is (the sanitizer
    checks NaN only), and the card's ``inf - inf`` makes the NaN.
    Returns the walls."""
    from repro_torch.core.positions import hex_init
    from repro_torch.debug import sanitized
    from repro_torch.runtime.scenario_engine import PLAN_FN_CACHE
    fleet = alexnet_fleet(torch, device, p2=True, seed=0, frames=SANITIZE_T,
                          cache=PLAN_FN_CACHE)
    base = hex_init(U, 40.0, jitter=0.5, seed=0)
    fleet.run(base, n_trajectories=MAIN_B)            # the one build
    torch.cuda.synchronize()
    builds = dict(PLAN_FN_CACHE.builds)
    t0 = time.perf_counter()
    fleet.run(base, n_trajectories=MAIN_B)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with sanitized(PLAN_FN_CACHE):
        trace = fleet.run(base, n_trajectories=MAIN_B)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    if PLAN_FN_CACHE.builds != builds:
        raise AssertionError(f"phase 50: builds {PLAN_FN_CACHE.builds} != "
                             f"{builds}")
    if not (trace.feasibility_rate > 0 and
            np.isfinite(trace.total_power).all()):
        raise AssertionError("phase 50: the sanitized rollout's trace")
    bad = base.copy()
    bad[0, 0] = np.inf
    t0 = time.perf_counter()
    try:
        with sanitized(PLAN_FN_CACHE):
            fleet.run(bad, n_trajectories=MAIN_B)
    except FloatingPointError as e:
        msg = str(e)
    else:
        raise AssertionError("phase 50: an infinite position raised "
                             "nothing inside sanitized()")
    nan_s = time.perf_counter() - t0
    if "aten." not in msg or f"{device.type}:" not in msg:
        raise AssertionError(f"phase 50: the error names no op on "
                             f"{device}: {msg}")
    log(f"  AlexNet U={U} B={MAIN_B} T={SANITIZE_T}: unsanitized "
        f"{plain_s:.3f} s; sanitized {clean_s:.3f} s, no NaN, no build "
        f"({sum(builds.values())} built before)")
    log(f"  one position at +inf: FloatingPointError after {nan_s:.3f} s "
        f"at the first op on the card that made a NaN: {msg}")
    return {"unsanitized_s": plain_s, "sanitized_s": clean_s,
            "nan_raise_s": nan_s, "nan_error": msg,
            "builds": sum(builds.values())}


# ---------------------------------------------------------------------------
# phases 51-52: the LMs under the reference's FSDP x TP rules over entries
# of the card
# ---------------------------------------------------------------------------

#: phase 51: minicpm-2b at full width, cut to 20 of its 40 layers for the
#: smoke's time (every width, kernel and gate stays), one training step under a
#: (data, model) mesh of entries of the card.  Each microbatch's rows go
#: over data, so a microbatch holds a row a data position: B 4 in 2
#: microbatches (B 2 would leave one row for two positions); the gradient
#: gate on 2 rows (a row a data position) of phase 36's ``check_seq``, in
#: float32
TP_TRAIN = dict(arch="minicpm-2b", mesh=(2, 4), batch=4, seq=2048,
                microbatches=2, lr=1e-3, check_seq=FULL_TRAIN["check_seq"],
                n_layers=20)
#: the gradient gate's noise side, the same mesh through the plain
#: versions against them without one, holds the program itself: its
#: largest gap at most this share of a leaf's largest gradient (float32
#: sums in another order move a gradient ~1e-6 of it; a fault of the
#: sharded program, O(1))
TP_NOISE_MAX = 1e-3
#: phase 52: gemma2-9b at full width serving one prefill and decode steps
#: under a (data, model) mesh (KV 8 over model 4: 2 KV heads a position),
#: cut to 14 of its 42 layers (7 local / global pairs) for the smoke's
#: time: every layout, kernel and gate of the 42 stays
#: (``n_layers`` here and in phases 45, 53 and 54 cuts depth, never width)
TP_SERVE = dict(arch="gemma2-9b", mesh=(2, 4), batch=8, seq=1024, steps=4,
                n_layers=14)
#: the reduced griffin model under a (2, 2) mesh, card against the CPU
TP_REDUCED = dict(arch="recurrentgemma-9b", mesh=(2, 2), batch=2, seq=40,
                  cache=48, steps=4)
#: the kernels whose calls at shard shapes phases 51-54 record and hold
TP_HELD = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "rglru_scan", "rglru_scan_bwd", "mlstm_chunk", "mlstm_chunk_bwd",
           "mlstm_decode_block")
#: phase 53: minicpm-2b at full width under a (1, 8) mesh, whose 36 heads
#: and 36 KV heads ``model`` does not divide: training under
#: ``attn_seq_shard`` (256 rows a position a microbatch), serving with the
#: prefill under both layouts and decode under ``seq_shard_kv`` (a cache
#: of 1,032 slots, 129 a position); cut to 20 of its 40 layers
SEQ_TRAIN = dict(TP_TRAIN, mesh=(1, 8), batch=2)
SEQ_TRAIN_RULES = dict(attn_seq_shard=True)
SEQ_SERVE = dict(arch="minicpm-2b", mesh=(1, 8), batch=8, seq=1024, steps=4,
                 cache=1032, n_layers=20)
SEQ_PREFILL_RULES = dict(attn_seq_shard=True, seq_shard_kv=True)
SEQ_DECODE_RULES = dict(seq_shard_kv=True)
#: phase 54: gemma2-9b at full width under a (1, 16) mesh, its KV 8 on 16:
#: ``seq_shard_kv`` (heads over model, the cache by slots: 1,040 slots, 65
#: a position), cut to 14 of its 42 layers; then the reduced gemma2-9b
#: and recurrentgemma-9b with a cache longer than their window (rolling
#: buffers split over model)
KV_SERVE = dict(arch="gemma2-9b", mesh=(1, 16), batch=8, seq=1024, steps=4,
                cache=1040, n_layers=14)
KV_REDUCED = (dict(TP_REDUCED, arch="gemma2-9b", mesh=(1, 4)),
              dict(TP_REDUCED, mesh=(1, 4)))


#: phase 55: whisper-tiny at full width and depth (4 + 4 layers, d 384, 6
#: heads, vocab 51,865, 1,500 frames) under a (2, 4) mesh of the card,
#: whose 6 heads model does not divide: one training step under
#: ``attn_seq_shard`` (the decoder's rows and the encoder's frames, 1,500
#: padded to 1,504, over model), a prefill under both layouts (the cross
#: cache by slots, 375 a position) and 4 decode steps under
#: ``seq_shard_kv``
WHISPER_TRAIN = dict(arch="whisper-tiny", mesh=(2, 4), batch=4, seq=1024,
                     microbatches=2, lr=1e-3, check_seq=512)
WHISPER_SERVE = dict(arch="whisper-tiny", mesh=(2, 4), batch=8, seq=1024,
                     steps=4, cache=1032)
#: phase 56: xlstm-350m at full width (d 1,024, H 4, D 256, vocab 50,304)
#: cut to 4 of its 24 layers (2 sLSTM + 2 mLSTM) under a (1, 8) mesh: one
#: training step (128 rows a position, two 64-step chunks, the state
#: handed on along model), a prefill and 4 decode steps on the key-block
#: mode (32 key rows a position)
XLSTM_TRAIN = dict(arch="xlstm-350m", n_layers=4, mesh=(1, 8), batch=2,
                   seq=1024, microbatches=1, lr=1e-3, check_seq=512)
XLSTM_SERVE = dict(arch="xlstm-350m", n_layers=4, mesh=(1, 8), batch=8,
                   seq=1024, steps=4, cache=1032)
#: phases 55 and 56's reduced models (3 heads, which model 2 does not
#: divide; whisper's 16 frames by slots) in float32 under a (2, 2) mesh of
#: the card against the same mesh of the CPU
FAMILY_REDUCED = {"whisper-tiny": dict(arch="whisper-tiny", heads=3,
                                       frames=16, mesh=(2, 2), batch=2,
                                       seq=40, cache=48, steps=4),
                  "xlstm-350m": dict(arch="xlstm-350m", heads=3,
                                     mesh=(2, 2), batch=2, seq=40,
                                     cache=48, steps=4)}
#: the key-block decode step timed at phase 56's shape: B 8, H 4, the
#: last of 8 blocks of 32 key rows of D 256, bfloat16
DECODE_BLOCK_TIMED = (8, 4, 32, 256)


def card_mesh(torch, shape, device):
    from repro_torch.parallel.sharding import make_mesh
    return make_mesh(shape, ("data", "model"),
                     [device] * (shape[0] * shape[1]))


class record_shard_calls:
    """Inside this block the first call under a mesh of each kernel of
    ``TP_HELD`` at each operand signature (shapes, dtypes, options) is
    kept: its
    operands copied as the ops module charged them (the ``charge`` each
    ``kernels/<k>/ops.py`` calls before it launches).  ``calls`` maps the
    signature to (kernel, operands, options)."""

    def __enter__(self):
        from repro_torch.kernels.decode_attention import ops as dops
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.mlstm_chunk import ops as lops
        from repro_torch.kernels.rglru_scan import ops as rops
        from repro_torch.parallel.sharding import current_mesh
        self.modules = (fops, dops, rops, lops)
        self.saved = [m.charge for m in self.modules]
        self.calls = {}
        real = self.saved[0]

        def record(name, *args, **kw):
            if name in TP_HELD and current_mesh() is not None:
                key = (name,) + tuple(
                    (tuple(a.shape), str(a.dtype), a.device.type)
                    if hasattr(a, "shape") else a for a in args) + \
                    tuple(sorted(kw.items()))
                if key not in self.calls:
                    self.calls[key] = (name, tuple(
                        a.detach().clone() if hasattr(a, "detach") else a
                        for a in args), dict(kw))
            return real(name, *args, **kw)
        for m in self.modules:
            m.charge = record
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.modules, self.saved):
            m.charge = fn
        return False


def hold_recorded(torch, calls):
    """Each recorded call (``record_shard_calls``) launched again on its
    operands against its plain version: flash attention and its backward
    (at a query offset too) and decode attention (with its log-sum-exp
    too, ``-inf`` where a block holds no valid slot) within ``ATTN_TOL``
    (bf16 also ``ATTN_BF16_ROUNDING``), the RG-LRU scans bitwise; each on
    its route; two launches bitwise equal.  Returns each call's signature
    and max abs error over its finite values."""
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        bwd_route, flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref
    from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_route,
                                                          rglru_scan,
                                                          rglru_scan_bwd)
    held = {}
    for name, args, kw in calls.values():
        dtype = args[0].dtype
        dname = str(dtype).split(".")[1]
        kw = {k: v for k, v in kw.items() if k != "with_lse"}
        if name.startswith("mlstm"):
            err, route = hold_mlstm_call(torch, name, args)
            what = f"{name} {dname} " + " x ".join(
                str(list(a.shape)) for a in args if torch.is_tensor(a))
            held[what] = err
            log(f"  {what}: {route} route, max abs err {err:.3g}, two "
                f"launches bitwise equal")
            continue
        if name == "flash_attention":
            fn, ref, route = flash_attention, attention_ref, \
                "wgmma" if dtype == torch.bfloat16 else "simt"
        elif name == "flash_attention_bwd":
            fn, ref, route = flash_attention_bwd, attention_bwd_ref, \
                bwd_route(dtype)
        elif name == "decode_attention":
            fn, ref, route = decode_attention, decode_ref, None
        elif name == "rglru_scan":
            fn, ref, route = rglru_scan, rglru_ref, \
                rglru_route(dtype, args[0].shape[1], args[0].shape[2])
        else:
            fn, ref = rglru_scan_bwd, rglru_bwd_ref
            route = rglru_route(dtype, args[0].shape[1], args[0].shape[2])
        if route is None:
            got = fn(*args, **kw)
        else:
            got, took = take_route(fn, lambda: fn(*args, **kw))
            want_route(name, took, route)
        again = fn(*args, **kw)
        want = ref(*args, **kw)
        torch.cuda.synchronize()
        got, again, want = ((t,) if torch.is_tensor(t) else tuple(t)
                            for t in (got, again, want))
        err = 0.0
        for g, a, w in zip(got, again, want):
            if g is None:
                continue
            if not torch.equal(g, a):
                raise AssertionError(f"{name} at {g.shape}: two launches "
                                     f"differ")
            if name.startswith("rglru"):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} at {g.shape}: not "
                                         f"bitwise its plain version")
            else:
                torch.testing.assert_close(g.float(), w.float(),
                                           **ATTN_TOL[dname])
                if dtype == torch.bfloat16:
                    torch.testing.assert_close(g.float(), w.float(),
                                               **ATTN_BF16_ROUNDING)
            gap = (g.double() - w.double()).abs()
            err = max(err, float(torch.where(torch.isfinite(w), gap,
                                             0.0).max()))
        what = f"{name} {dname} " + " x ".join(
            str(list(a.shape)) for a in args if torch.is_tensor(a)) + \
            (f" {kw}" if kw else "")
        held[what] = err
        log(f"  {what}: {route or 'its'} route, max abs err {err:.3g}, "
            f"two launches bitwise equal")
    return held


def hold_mlstm_call(torch, name, args):
    """One recorded mLSTM kernel call (``hold_recorded``) launched again
    on its operands against its plain version: the chunk kernel
    (``held_mlstm``, at its route's chunks), its backward
    (``held_mlstm_bwd``, at ``BWD_CHUNK``; at a position of a chain its
    final state's gradients are those its successor handed back), the
    key-block decode step (every output within ``MLSTM_TOL``), each on
    its route, two launches bitwise equal.  Returns (max abs error, the
    route)."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        BWD_CHUNK, CHUNK, mlstm_bwd_route, mlstm_chunk, mlstm_chunk_bwd,
        mlstm_decode_block, mlstm_route)
    from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_bwd_ref,
                                                     mlstm_chunk_ref,
                                                     mlstm_decode_block_ref)
    q = args[0]
    if name == "mlstm_chunk":
        fn, route = mlstm_chunk, mlstm_route(q.dtype, q.shape[1])
        ref = lambda: mlstm_chunk_ref(*args, chunk=CHUNK[route])  # noqa
    elif name == "mlstm_chunk_bwd":
        fn = mlstm_chunk_bwd
        route = mlstm_bwd_route(q.dtype, q.shape[1], q.shape[-1])
        ref = lambda: mlstm_chunk_bwd_ref(*args, chunk=BWD_CHUNK)  # noqa
    else:
        fn, route = mlstm_decode_block, "decode_block"
        ref = lambda: mlstm_decode_block_ref(*args)  # noqa: E731
    got, took = take_route(fn, lambda: fn(*args))
    want_route(name, took, route)
    again = fn(*args)
    want = ref()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} at {list(q.shape)}: two launches "
                             f"differ")
    if name == "mlstm_chunk":
        err = held_mlstm(torch, got, want, q.dtype)
    elif name == "mlstm_chunk_bwd":
        err = held_mlstm_bwd(torch, got, want, "at its shard shape")[1]
    else:
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **MLSTM_TOL)
        err = max(float((a.double() - w.double()).abs().max())
                  for a, w in zip(got, want))
    return err, route


def serve_launches(cfg, n, dtype):
    """The launches of a prefill and of a decode step of ``cfg`` on ``n``
    positions, and the route each takes in ``dtype``: a flash call an
    attention layer (whisper's encoder layers and its decoder's self and
    cross attention) and a decode call a decoder attention; an xLSTM's
    mLSTM chunk a prefill and its key-block decode step a decode step, an
    mLSTM layer each."""
    from repro_torch.core.cost_model import _block_kinds
    flash = "wgmma" if dtype == "bfloat16" else "simt"
    if cfg.family == "ssm":
        mls = n * sum(k == "mlstm" for k in _block_kinds(cfg))
        return ({"prefill": {"mlstm_chunk": mls},
                 "decode": {"mlstm_decode_block": mls}},
                {"prefill": {"mlstm_chunk": flash},
                 "decode": {"mlstm_decode_block": "decode_block"}})
    pre = dec = cfg.n_layers
    if cfg.family == "audio":
        pre, dec = attention_calls(cfg), 2 * cfg.n_layers
    return ({"prefill": {"flash_attention": n * pre},
             "decode": {"decode_attention": n * dec}},
            {"prefill": {"flash_attention": flash}, "decode": {}})


def serve_frames(np, torch, cfg, batch, device):
    """Seeded frame embeddings for whisper's prefill (None for the other
    families)."""
    if cfg.family != "audio":
        return None
    return torch.as_tensor(np.random.default_rng(55).normal(
        size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32),
        device=device)


def tp_train_call(np, torch, device, one_position=None, f=TP_TRAIN,
                  rules=None):
    """Phase 51's (``f``'s) training step built on ``device`` (the card or
    ``meta``): (program, its state, the mesh, the model).  ``program(one)``
    runs one ``make_train_step`` step under ``use_mesh_rules`` of
    ``f``'s mesh and ``rules`` (``one`` as ``use_mesh_rules`` takes
    ``one_position``, default ``one_position``)."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import MetaGenerator
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import use_mesh_rules
    from repro_torch.runtime.train_loop import init_state, make_train_step
    cfg = get_arch(f["arch"])
    if f.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=f["n_layers"])
    model = build_model(cfg, device)
    gen = MetaGenerator() if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(0)
    tcfg = TrainConfig(steps=2, lr=f["lr"], warmup_steps=0,
                       microbatches=f["microbatches"], schedule="wsd")
    state = init_state(model, gen, tcfg)
    step = make_train_step(model, cfg, tcfg)
    batch = train_batch(np, cfg, f["batch"], f["seq"], 51)
    mesh = card_mesh(torch, f["mesh"], device)

    def program(one=one_position):
        with use_mesh_rules(mesh, one_position=one, **(rules or {})):
            return step(state, batch)[1]
    return program, state, mesh, model


def tp_grad_gate(np, torch, device, model, params, mesh, f=TP_TRAIN,
                 rules=None, phase=51):
    """Phase 51's gradient gate, phase 36's per-leaf gate in float32 on
    the initial parameters, at ``f``'s check batch (2 rows of phase 36's
    ``check_seq``) under the mesh and ``rules``: the loss and every
    gradient under the mesh against the same without one, both through
    the kernels; its noise side the same two runs through the plain
    versions, which reorder the same sums.  Each leaf's gap, as a share
    of its largest gradient, within the larger of ``LM_GAP`` x the
    largest such share the plain sides give and ``GRAD_FLOOR_ULPS``
    float32 ulps of that gradient; the loss within the larger of
    ``LM_GAP`` x the plain sides' loss gap and ``GRAD_FLOOR_ULPS``
    float32 ulps of it; the plain sides' own largest share within
    ``TP_NOISE_MAX``.  A key bias (whisper's ``bk``), whose gradient is
    zero in exact arithmetic, takes the model's largest gradient for its
    own."""
    import dataclasses
    import math
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import use_mesh_rules
    from repro_torch.tree import leaves, leaves_with_paths
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    check = build_model(cfg, device)
    plist = leaves(params)
    rng = np.random.default_rng(51)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (2, f["check_seq"] + 1)),
                           device=device)
    extra = () if cfg.family != "audio" else (torch.as_tensor(
        rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32),
        device=device),)

    def grads(ctx, on_mesh):
        with ctx, use_mesh_rules(mesh if on_mesh else None,
                                 **(rules or {})):
            loss = check.train_loss(params, toks[:, :-1], toks[:, 1:],
                                    *extra)
            loss.backward()
        out = [torch.zeros_like(p) if p.grad is None else p.grad
               for p in plist]
        for p in plist:
            p.grad = None
        torch.cuda.synchronize()
        return loss.item(), out

    # each mesh side's gap from its side without a mesh, leaf by leaf on
    # the card (two gradient sets held at a time)
    losses, gaps = {}, {}
    for side, ctx in (("plain", plain_kernels),
                      ("unsharded", contextlib.nullcontext)):
        losses[side], whole = grads(ctx(), False)
        if side == "plain":
            top = [float(g.abs().max()) for g in whole]
            # a key bias's gradient is zero in exact arithmetic (the
            # softmax ignores a constant added to a row's scores): its
            # float32 noise is held against the model's largest gradient
            top = [max(top) if path.endswith("['bk']") else t
                   for (path, _), t in zip(leaves_with_paths(params), top)]
        mesh_side = "plain_sharded" if side == "plain" else "sharded"
        losses[mesh_side], split = grads(ctx(), True)
        gaps[mesh_side] = [float((a - b).abs().max())
                           for a, b in zip(split, whole)]
        del whole, split
        torch.cuda.empty_cache()

    def rel(gap, t):
        return gap / t if t else (0.0 if gap == 0 else math.inf)
    noise = max(rel(g, t) for g, t in zip(gaps["plain_sharded"], top))
    rows = []
    for (path, _), gap, t in zip(leaves_with_paths(params), gaps["sharded"],
                                 top):
        floor = rel(GRAD_FLOOR_ULPS * float(float32_ulp(torch,
                                                        torch.tensor(t))), t)
        share = rel(gap, t)
        rows.append((share / max(LM_GAP * noise, floor), path, share,
                     floor > LM_GAP * noise))
    rows.sort(reverse=True)
    loss_limit = max(LM_GAP * abs(losses["plain_sharded"] - losses["plain"]),
                     GRAD_FLOOR_ULPS * float(float32_ulp(
                         torch, torch.tensor(losses["plain"]))))
    loss_gap = abs(losses["sharded"] - losses["unsharded"])
    gate = {"seq": f["check_seq"], "rows": 2, "dtype": cfg.dtype,
            "at_init": True, "leaves": len(rows),
            "noise_side": "the mesh through the plain versions vs the "
                          "plain versions without one",
            "plain_sharded_largest_share": noise,
            "worst_share_of_limit": rows[0][0],
            "leaves_at_floor": sum(r[3] for r in rows),
            "worst_leaves": [dict(zip(("share_of_limit", "leaf", "share",
                                       "at_floor"), r)) for r in rows[:5]],
            "losses": losses, "loss_gap": loss_gap, "loss_limit": loss_limit}
    log(f"  {cfg.dtype} gate at 2 x {f['check_seq']} (initial "
        f"parameters): losses {losses} (gap {loss_gap:.3g}, limit "
        f"{loss_limit:.3g}); worst leaf {rows[0][1]} at {rows[0][0]:.3g} "
        f"of its limit (the plain versions' mesh gap, largest share "
        f"{noise:.3g}; {gate['leaves_at_floor']} leaves at the floor)")
    if rows[0][0] > 1.0 or loss_gap > loss_limit or not noise <= \
            TP_NOISE_MAX:
        raise AssertionError(f"phase {phase}: the mesh's gradients or loss "
                             f"leave the gate: {gate}")
    del check
    gc.collect()
    torch.cuda.empty_cache()
    return gate


def seq_share(one, others, n_data):
    """The dot FLOPs, kernel calls and collective bytes and counts of
    ``one``'s program and ``others``' (op profiles) summed, times
    ``n_data`` alike positions along data."""
    def added(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            a, b = a or {}, b or {}
            return {k: added(a.get(k, 0), b.get(k, 0)) for k in {*a, *b}}
        return a + b

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return t * n_data
    out = {}
    for p in [one, *others]:
        out = added(out, {"dot_flops": p.dot_flops,
                          "kernels": p.kernel_calls(),
                          "coll_bytes": dict(p.coll_bytes),
                          "coll_count": dict(p.coll_count)})
    return scaled(out)


def run_tp_training(np, torch, device, smi, f=TP_TRAIN, rules=None,
                    phase=51):
    """Phase 51: ``TP_TRAIN``'s step (minicpm-2b at full width and depth,
    FSDP over data and TP over model, each position's block run in turn
    on the card); phase 53 runs ``SEQ_TRAIN`` under ``attn_seq_shard``
    (``f``, ``rules``).  (a) the step on ``meta`` as one position's
    program and as all 8: the one position's dot FLOPs, kernel calls and
    collective bytes and counts x 8 equal all 8's where every position's
    block is alike; under ``attn_seq_shard``, where the last rows attend
    to the most keys, they equal the last position's share of all 8's:
    all 8's less the other positions along model run each on its own
    (``seq_share``); (b) on the card under
    the op profiler: the aten products and traffic, the kernel calls and
    the collectives equal all 8 positions' on ``meta`` exactly, and the
    card's launch counters the launches of those kernel calls: flash and
    its backward at H 9 a position, 2 x 20 x 8 forward and 20 x 8
    backward launches a microbatch, all ``wgmma``; (c) the step again,
    timed, the meta run's bytes within ``DRY_MEMORY_TOL`` of
    ``max_memory_allocated`` above what the card held before the state
    was made; metrics finite; (d) before the steps, phase 36's gradient
    gate on the initial parameters beside the same model without a mesh
    (``tp_grad_gate``, float32); (e) every kernel call
    at its shard shape held against its plain version
    (``hold_recorded``).  Returns the record."""
    import math
    from repro_torch import kernels
    from repro_torch.launch.dryrun import run_program, storage_bytes
    meta = torch.device("meta")
    rec = {"card": smi, "config": dict(f), "rules": dict(rules or {})}
    marks = {"start": time.perf_counter()}
    profiles = {}
    # under rows the positions along model differ but for the xLSTM's,
    # whose row blocks all run the same recurrence (its hand-off charged
    # alike at every position)
    even = not (rules or {}).get("attn_seq_shard") or \
        f["arch"] == "xlstm-350m"
    program, state, _, _ = tp_train_call(np, torch, meta, f=f, rules=rules)
    for one in (True, False):
        t0 = time.perf_counter()
        prof, mem = run_program(lambda: program(one), state)
        profiles[one] = (prof.profile, mem, time.perf_counter() - t0,
                         storage_bytes(state))
        del prof
    # under rows the positions along model differ: each of the others
    # run on its own, so that the last one's share of all positions'
    # run is what they leave
    others = []
    for m in range(0 if even else f["mesh"][1] - 1):
        prof, _ = run_program(lambda m=m: program(m), state)
        others.append(prof.profile)
        del prof
    del program, state
    one, whole = profiles[True][0], profiles[False][0]
    n = f["mesh"][0] * f["mesh"][1]
    times = {k: {r: {q: v * n for q, v in c.items()}
                 for r, c in routes.items()}
             for k, routes in one.kernel_calls().items()}
    if not even:
        times = whole.kernel_calls()
        share = seq_share(one, others, f["mesh"][0])
        if share != seq_share(whole, [], 1):
            raise AssertionError(
                f"phase {phase}: the last position's program differs from "
                f"its share of all positions' (all less the other "
                f"positions' own programs): {share} vs "
                f"{seq_share(whole, [], 1)}")
        log(f"  meta: the last position's dot FLOPs, kernel calls and "
            f"collectives == all {n} positions' less the other "
            f"{len(others)} along model run on their own (its dot FLOPs "
            f"{one.dot_flops:.4g}, x {n} = {one.dot_flops * n:.4g} beside "
            f"all {n} positions' {whole.dot_flops:.4g}: its row block "
            f"attends to the most keys; its collectives "
            f"{dict(one.coll_bytes)} B)")
    elif one.dot_flops * n != whole.dot_flops or \
            times != whole.kernel_calls() or \
            {k: v * n for k, v in one.coll_bytes.items()} != \
            whole.coll_bytes or \
            {k: v * n for k, v in one.coll_count.items()} != \
            whole.coll_count:
        raise AssertionError(
            f"phase {phase}: one position x {n} differs from all positions: "
            f"dot {one.dot_flops * n} vs {whole.dot_flops}, collectives "
            f"{one.coll_bytes} x {n} vs {whole.coll_bytes}")
    if even:
        log(f"  meta: one position's dot FLOPs, kernel calls and collectives "
            f"x {n} == all {n} positions' ({one.dot_flops:.4g} FLOP a "
            f"position; {dict(one.coll_bytes)} B a position; traced in "
            f"{profiles[True][2]:.1f} s and {profiles[False][2]:.1f} s)")
    marks["meta"] = time.perf_counter()
    _, wmem, _, wargs = profiles[False]
    predicted = wargs + wmem["output_size_in_bytes"] + \
        wmem["temp_size_in_bytes"] - wmem["alias_size_in_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    program, state, mesh, model = tp_train_call(np, torch, device, f=f,
                                                rules=rules)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    marks["init"] = time.perf_counter()
    with record_shard_calls() as gate_seen:
        gate = tp_grad_gate(np, torch, device, model, state["params"], mesh,
                            f, rules, phase)
    marks["gate"] = time.perf_counter()
    kernels.reset_launch_counts()
    with record_shard_calls() as seen:
        cprof, _ = run_program(program, state)
    torch.cuda.synchronize()
    claunch, croutes = card_launches()
    mlaunch, mroutes = profile_launches(whole)
    # WhisperLM runs its layers without recomputation
    passes = 1 if model.cfg.family == "audio" else 2
    per_mb = {k: v * n for k, v in train_launches(model.cfg,
                                                  passes).items()}
    want = {k: v * f["microbatches"] for k, v in per_mb.items()}
    want_launches(f"phase {phase} step", claunch, croutes, want,
                  {k: "wgmma" for k in want})
    if cprof.profile.counts() != whole.counts() or \
            cprof.profile.coll_bytes != whole.coll_bytes or \
            cprof.profile.coll_count != whole.coll_count or \
            (mlaunch, mroutes) != (claunch, croutes):
        ops, kern = op_differences(whole, cprof.profile)
        for k, (m, c) in sorted(ops.items())[:20]:
            log(f"  {k}: meta {m}, card {c}")
        raise AssertionError(
            f"phase {phase}: the card's counts differ from the meta run's: dot "
            f"{cprof.profile.dot_flops} vs {whole.dot_flops}, traffic "
            f"{cprof.profile.traffic_bytes} vs {whole.traffic_bytes}, "
            f"collectives {cprof.profile.coll_bytes} vs {whole.coll_bytes}; "
            f"kernels {kern}; launches {claunch} vs {mlaunch}")
    log(f"  card under the op profiler: counts == the 8 positions' on meta "
        f"(dot {whole.dot_flops:.4g} FLOP, traffic {whole.traffic_bytes:.4g}"
        f" B, collectives {dict(whole.coll_bytes)} B, pod "
        f"{whole.collectives.pod_bytes}); launches {claunch} (routes "
        f"{croutes})")
    del cprof
    marks["profiled_step"] = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    metrics = program()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want_launches(f"phase {phase} timed step", *card_launches(), want,
                  {k: "wgmma" for k in want})
    peak = torch.cuda.max_memory_allocated() - base
    share = abs(predicted - peak) / peak
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"phase {phase}: metrics {metrics}")
    log(f"  step: loss {metrics['loss']:.4f}, grad norm "
        f"{metrics['grad_norm']:.4f}; wall {wall:.3f} s (CUDA events "
        f"{start.elapsed_time(end):.1f} ms); predicted "
        f"{predicted / 1e9:.3f} GB, card peak {peak / 1e9:.3f} GB above "
        f"{base / 1e9:.3f} GB ({share * 100:.2f} % off) ({smi})")
    if share > DRY_MEMORY_TOL:
        raise AssertionError(f"phase {phase}: the meta run's {predicted} B "
                             f"is {share * 100:.2f} % off the card's peak "
                             f"{peak}")
    marks["timed_step"] = time.perf_counter()
    del program, state, model
    gc.collect()
    torch.cuda.empty_cache()
    held = hold_recorded(torch, {**seen.calls, **gate_seen.calls})
    marks["held"] = time.perf_counter()
    names = list(marks)
    rec["sub_walls_s"] = {b: marks[b] - marks[a]
                          for a, b in zip(names, names[1:])}
    log(f"  phase {phase}'s parts: {rec['sub_walls_s']} s")
    rec.update({
        "init_s": init_s, "wall_s": wall,
        "cuda_event_ms": start.elapsed_time(end), "metrics": metrics,
        "launches": claunch, "routes": croutes,
        "launches_per_microbatch": per_mb,
        "tokens_per_s": f["batch"] * f["seq"] / wall,
        "meta_trace_s": {"one_position": profiles[True][2],
                         "all_positions": profiles[False][2]},
        "dot_flops_a_position": one.dot_flops,
        "collectives_a_position": {"bytes": dict(one.coll_bytes),
                                   "count": dict(one.coll_count),
                                   "pod_bytes": one.collectives.pod_bytes},
        "predicted_bytes": predicted, "peak_bytes": peak,
        "memory_base": base, "memory_share_off": share,
        "grad_gate": gate, "held_at_shard_shapes": held})
    return rec


def tp_serve_sides(torch, model, params, toks, mesh, steps, cache_len=None,
                   pre=None, dec=None, frames=None):
    """One prefill and ``steps`` decode steps three ways on the card:
    the plain versions without a mesh (the reference side), the same
    with their sums reordered, and the kernels under ``mesh`` (the
    prefill under the rules ``pre``, decode under ``dec``), each
    decoding from a copy of the plain side's prefill cache (of
    ``cache_len`` slots, default the prompt and the steps) and fed its
    greedy tokens; the mesh side's launches counted a call.  ``frames``:
    whisper's, through every prefill.  Returns the sides' logits, the
    plain side's, and the mesh side's launches."""
    from repro_torch import kernels
    from repro_torch.parallel.sharding import use_mesh_rules
    b, s = toks.shape
    cache_len = cache_len or s + steps

    def prefill():
        if frames is not None:
            return model.prefill(params, toks, frames, cache_len)
        return model.prefill(params, toks, cache_len)
    with torch.no_grad():
        with plain_kernels():
            ref, cache = prefill()
        logits = {}
        with plain_kernels(True):
            logits["reordered"] = [prefill()[0]]
        kernels.reset_launch_counts()
        with use_mesh_rules(mesh, **(pre or {})):
            out, _ = prefill()
        torch.cuda.synchronize()
        calls = [("prefill",) + card_launches()]
        logits["mesh"] = [out]
        caches = {side: clone_cache(cache) for side in ("reordered", "mesh")}
        refs = [ref]
        nxt = torch.argmax(ref, -1).to(torch.int32)[:, None]
        for i in range(steps):
            pos = torch.full((b, 1), s + i, dtype=torch.int32,
                             device=toks.device)
            with plain_kernels():
                ref, cache = model.decode_step(params, nxt, pos, cache)
            refs.append(ref)
            with plain_kernels(True):
                o, caches["reordered"] = model.decode_step(
                    params, nxt, pos, caches["reordered"])
            logits["reordered"].append(o)
            kernels.reset_launch_counts()
            with use_mesh_rules(mesh, **(dec or {})):
                o, caches["mesh"] = model.decode_step(params, nxt, pos,
                                                      caches["mesh"])
            torch.cuda.synchronize()
            calls.append(("decode",) + card_launches())
            logits["mesh"].append(o)
            nxt = torch.argmax(ref, -1).to(torch.int32)[:, None]
    return logits, refs, calls


def tp_logit_rule(torch, logits, refs, dtype):
    """Phase 12's per-logit rule for the mesh side: each logit's gap from
    the plain side within the larger of ``LM_GAP`` x the reordered plain
    side's largest gap and, in bfloat16, ``LM_BF16_ULPS`` ulps of the
    logit, in float32 ``LM_F32_TOL`` of it.  Returns the gaps and the
    mesh side's largest share of its limit."""
    gaps = logit_gaps(torch, logits, refs)
    limit_abs = LM_GAP * gaps["reordered"]
    share = 0.0
    for a, r in zip(logits["mesh"], refs):
        if dtype == "bfloat16":
            own = LM_BF16_ULPS * bf16_ulp(torch, r)
        else:
            own = LM_F32_TOL["atol"] + LM_F32_TOL["rtol"] * r.float().abs()
        gap = (a.float() - r.float()).abs()
        share = max(share, float((gap / own.clamp_min(limit_abs)).max()))
    return {"gaps": gaps, "limit_abs": limit_abs, "share": share}


def run_tp_serving(np, torch, device, smi, f=TP_SERVE, pre=None, dec=None,
                   phase=52, reduced=None, float32=True):
    """Phase 52: ``TP_SERVE``'s model (gemma2-9b at full width) serving
    one prefill of B 8 x S 1,024 and 4 decode steps under a (2, 4) mesh
    of the card (heads, KV heads, MLP and vocabulary over model, FSDP
    weights gathered over data, the KV cache by heads) beside the plain
    versions without a mesh (``tp_serve_sides``), in bfloat16 and with
    the same weights in float32: exact launches by route (flash 8
    positions x its layers (42, cut to 14) a prefill, on ``wgmma`` in
    bfloat16 and ``simt`` in float32, decode attention 8 x its layers a
    step; ``serve_launches``, which also gives whisper's and the xLSTM's);
    phase 12's per-logit rule
    (``tp_logit_rule``) gating the float32 logits and recorded for the
    bfloat16 ones; the mesh side's walls beside the same calls without
    a mesh; every kernel call at its shard shape held against its plain
    version.  Then ``TP_REDUCED`` (the
    reduced recurrentgemma in float32) under a (2, 2) mesh of the card
    against the same mesh of the CPU (``reduced``: the configs of that
    part, each as ``tp_reduced`` takes it).  Phases 53 and 54 run their
    configs (``f``, its cache) under the sequence layouts' rules: ``pre``
    for the prefill, ``dec`` for decode; phase 54 without the float32
    side (``float32``: its reduced models hold float32 card against CPU,
    and phase 53 the float32 merge at full width).  Returns the record."""
    from repro_torch.parallel.sharding import use_mesh_rules
    model, params, rec = init_full(torch, f["arch"], device,
                                   f.get("n_layers"))
    cache_len = f.get("cache", f["seq"] + f["steps"])
    cfg = model.cfg
    frames = serve_frames(np, torch, cfg, f["batch"], device)
    sides = dict(cache_len=cache_len, pre=pre, dec=dec, frames=frames)
    n = f["mesh"][0] * f["mesh"][1]
    mesh = card_mesh(torch, f["mesh"], device)
    toks = torch.as_tensor(np.random.default_rng(52).integers(
        2, cfg.vocab_size, (f["batch"], f["seq"])), dtype=torch.int32,
        device=device)
    with record_shard_calls() as seen:
        logits, refs, calls = tp_serve_sides(torch, model, params, toks,
                                             mesh, f["steps"], **sides)
    want, routes_by = serve_launches(cfg, n, "bfloat16")
    for kind, launches, routes in calls:
        want_launches(f"phase {phase} {kind}", launches, routes, want[kind],
                      routes_by[kind])
    rec["decode_launches"] = sum(c[1].get("mlstm_decode_block", 0)
                                 for c in calls if c[0] == "decode")
    bf16 = tp_logit_rule(torch, logits, refs, "bfloat16")
    log(f"  {cfg.name} bfloat16 under {f['mesh']}: logit gaps from the plain "
        f"side {bf16['gaps']}: the mesh side at {bf16['share']:.3g} of phase "
        f"12's bf16 per-logit limit; launches a call "
        f"{[(k, l) for k, l, _ in calls[:2]]}")
    if bf16["share"] > 1.0:
        raise AssertionError(f"phase {phase}: the mesh's bfloat16 logits "
                             f"leave phase 12's per-logit rule: {bf16}")
    walls = {}
    b, s = toks.shape

    def prefill(t):
        if frames is not None:
            return model.prefill(params, t, frames, cache_len)
        return model.prefill(params, t, cache_len)
    for name, m in (("none", None), ("mesh", mesh)):
        with torch.no_grad():
            with use_mesh_rules(m, **(pre or {})):
                prefill(toks[:, :64])                           # warm-up
                (lg, cache), w, _, _ = counted(torch,
                                               lambda: prefill(toks))
            steps = []
            for i in range(f["steps"]):
                nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
                pos = torch.full((b, 1), s + i, dtype=torch.int32,
                                 device=device)
                with use_mesh_rules(m, **(dec or {})):
                    (lg, cache), ws, _, _ = counted(
                        torch, lambda: model.decode_step(params, nxt, pos,
                                                         cache))
                steps.append(ws * 1e3)
        walls[name] = {"prefill_s": w, "decode_step_ms": steps}
    log(f"  walls: {walls} ({smi})")
    del logits, refs
    params32 = tree_map(lambda t: t.float(), params) if float32 else None
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    f32 = tp_float32_side(torch, cfg, params32, toks, mesh, f, phase, sides,
                          want, seen, smi) if float32 else None
    del frames
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    held = hold_recorded(torch, seen.calls)
    rec.update({"card": smi, "config": dict(f), "walls": walls,
                "rules": {"prefill": dict(pre or {}),
                          "decode": dict(dec or {})},
                "bfloat16": bf16, "float32": f32,
                "launches_per_call": want, "held_at_shard_shapes": held,
                "reduced": [tp_reduced(np, torch, device, r, dec)
                            for r in (reduced if reduced is not None
                                      else [TP_REDUCED])]})
    return rec


def tp_float32_side(torch, cfg, params32, toks, mesh, f, phase, sides, want,
                    seen, smi):
    """``run_tp_serving``'s float32 side: phase 12's float32 rule on the
    same weights in float32 (``tp_serve_sides``, exact launches by route,
    the simt flash route), its shard calls added to ``seen``.  Returns
    the rule's record."""
    import dataclasses
    from repro_torch.models import build_model
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                          device=toks.device)
    with record_shard_calls() as seen32:
        logits, refs, calls32 = tp_serve_sides(torch, model32, params32,
                                               toks, mesh, f["steps"],
                                               **sides)
    routes_by = serve_launches(cfg, f["mesh"][0] * f["mesh"][1],
                               "float32")[1]
    for kind, launches, routes in calls32:
        want_launches(f"phase {phase} float32 {kind}", launches, routes,
                      want[kind], routes_by[kind])
    f32 = tp_logit_rule(torch, logits, refs, "float32")
    log(f"  {cfg.name} float32 under {f['mesh']}: logit gaps from the plain "
        f"side {f32['gaps']}: the mesh side at {f32['share']:.3g} of phase "
        f"12's float32 per-logit limit ({smi})")
    if f32["share"] > 1.0:
        raise AssertionError(f"phase {phase}: the mesh's float32 logits "
                             f"leave phase 12's per-logit rule: {f32}")
    seen.calls.update(seen32.calls)
    return f32


def run_seq_rows(np, torch, device, smi):
    """Phase 53: minicpm-2b at full width under ``SEQ_TRAIN``'s (1, 8)
    mesh of the card, whose 36 heads and KV heads ``model`` does not
    divide.  Training under ``attn_seq_shard`` (``run_tp_training``: the
    rows over model, weights FSDP-only, K/V all-gathered, the flash
    kernels at each position's query offset; the float32 gradient gate
    at ``check_seq``, the card's kernel calls and counts those of the
    dry run of all 8 positions on ``meta``, its bytes within
    ``DRY_MEMORY_TOL`` of ``max_memory_allocated``), then serving
    ``SEQ_SERVE`` (``run_tp_serving``: the prefill under both layouts,
    decode under ``seq_shard_kv``, phase 12's logit rule against the
    unsharded run, bfloat16 and float32, walls beside it), then the
    flash kernels at the last position's shard shape timed
    (``time_seq_kernels``).  Returns the record."""
    rec = {"training": run_tp_training(np, torch, device, smi, SEQ_TRAIN,
                                       SEQ_TRAIN_RULES, 53)}
    gc.collect()
    torch.cuda.empty_cache()
    rec["serving"] = run_tp_serving(np, torch, device, smi, SEQ_SERVE,
                                    SEQ_PREFILL_RULES, SEQ_DECODE_RULES, 53,
                                    reduced=())
    gc.collect()
    torch.cuda.empty_cache()
    rec["kernel_times"] = time_seq_kernels(torch, device, smi)
    return rec


def run_seq_kv(np, torch, device, smi):
    """Phase 54: gemma2-9b at full width under ``KV_SERVE``'s (1, 16)
    mesh of the card (KV 8 on 16: ``seq_shard_kv``; a softcap): one
    prefill of B 8 x S 1,024 (heads over model, the cache by slots) and
    4 decode steps (each position's block of 65 slots, the blocks merged
    by their log-sum-exps), phase 12's rule in bfloat16, then
    ``KV_REDUCED``: the
    reduced gemma2-9b and recurrentgemma-9b with a cache longer than
    their window, card against CPU within 1e-4.  Returns the record."""
    return run_tp_serving(np, torch, device, smi, KV_SERVE,
                          SEQ_DECODE_RULES, SEQ_DECODE_RULES, 54,
                          reduced=KV_REDUCED, float32=False)


#: the shard shapes timed beside their unsharded calls, bfloat16: phase
#: 53's flash forward and backward (minicpm-2b at S 2,048, the last of 8
#: row blocks: 256 rows, 2,048 keys, offset 1,792) and phase 54's decode
#: attention (gemma2-9b at B 8, a block of 65 of 1,040 slots, all 16
#: heads) with and without the log-sum-exp
SEQ_TIMED = dict(flash=(1, 36, 36, 2048, 64, 8), decode=(8, 8, 2, 1040, 256,
                                                         16, 50.0))


def same_function(torch, want, got):
    """The largest gap of a library call's outputs ``got`` from the plain
    version's ``want``, raised where it passes
    ``LIBRARY_SAME_FUNCTION`` of ``want``'s largest value."""
    err = max_abs_err(torch, want, got)
    top = max(float(w.float().abs().max()) for w in want)
    if not err <= LIBRARY_SAME_FUNCTION * top:
        raise AssertionError(f"the library call differs from the plain "
                             f"version by {err} (largest value {top})")
    return err


def time_seq_kernels(torch, device, smi):
    """The kernels at ``SEQ_TIMED``'s shard shapes on the card, each held
    against its plain version first (``ATTN_BF16_ROUNDING``), timed in a
    CUDA graph beside the plain version, the library call and the bound
    from this run's shapes (``KERNEL_WORK``): the flash forward and its
    backward at the last row block, beside the same kernel's call over
    the whole sequence at offset 0 and the n blocks' calls summed, the
    library SDPA under the same mask (``causal_lower_right`` at an
    offset, ``is_causal`` at 0) and its ``autograd.grad``, each held
    against the plain version too;
    decode attention with its log-sum-exp beside the call without it."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    bf = torch.bfloat16
    b, h, kv, s, d, n = SEQ_TIMED["flash"]
    c = s // n
    q, k, v, do = bwd_case(torch, 530, (b, h, kv, s, s, d), bf, device)
    out = {}

    def flash_entry(off, rows):
        qb, dob = q[:, :, off:off + rows], do[:, :, off:off + rows]
        kb, vb = k[:, :, :off + rows], v[:, :, :off + rows]
        kw = dict(causal=True, q_offset=off) if off else dict(causal=True)
        o, lse = flash_attention(qb, kb, vb, with_lse=True, **kw)
        # SDPA under the same mask: query row i at key position off + i
        # (``causal_lower_right``), ``is_causal`` at offset 0; its
        # backward is ``torch.autograd.grad`` of its output, as phase 34's
        mask = dict(attn_mask=causal_lower_right(rows, off + rows)) if off \
            else dict(is_causal=True)
        qc, kc, vc = (t.detach().contiguous().requires_grad_()
                      for t in (qb, kb, vb))
        doc = dob.contiguous()
        lib_out = F.scaled_dot_product_attention(qc, kc, vc, **mask)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qc, kc, vc), doc, retain_graph=True)
        with torch.no_grad():
            fwd = attention_entry(
                torch, lambda: flash_attention(qb, kb, vb, **kw),
                lambda: attention_ref(qb, kb, vb, **kw),
                lambda: F.scaled_dot_product_attention(qc, kc, vc, **mask),
                KERNEL_WORK["flash_attention"](qb, kb, vb, **kw), 10,
                max_abs_err(torch, attention_ref(qb, kb, vb, **kw),
                            flash_attention(qb, kb, vb, **kw)),
                [b, h, kv, rows, off + rows, d, off], None)
        fwd["library_max_abs_err"] = same_function(
            torch, [attention_ref(qb, kb, vb, **kw)], [lib_out.detach()])
        got = flash_attention_bwd(qb, kb, vb, o, lse, dob, **kw)
        want = attention_bwd_ref(qb, kb, vb, o, lse, dob, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(),
                                       **ATTN_BF16_ROUNDING)
        lib_err = same_function(torch, want, lib_bwd())
        work = KERNEL_WORK["flash_attention_bwd"](qb, kb, vb, o, lse, dob,
                                                  **kw)
        kern = lambda: flash_attention_bwd(  # noqa: E731
            qb, kb, vb, o, lse, dob, **kw)
        bwd = {"shape": [b, h, kv, rows, off + rows, d, off],
               "max_abs_err": max(max_abs_err(torch, w, g)
                                  for g, w in zip(got, want)),
               "ms": time_ms(torch, kern, 10, graph=True),
               "eager_ms": time_ms(torch, kern, 10, graph=False),
               "plain_ms": time_ms(torch, lambda: attention_bwd_ref(
                   qb, kb, vb, o, lse, dob, **kw), 3, graph=True),
               # eager, as phase 34's: autograd runs the backward on the
               # forward's stream, outside a capture; beside eager_ms
               "library_ms": time_ms(torch, lib_bwd, 10, graph=False),
               "library": "autograd.grad of F.scaled_dot_product_attention"
                          " (eager)", "library_max_abs_err": lib_err,
               **bound_keys(work)}
        del lib_out, qc, kc, vc, doc
        return fwd, bwd

    last = flash_entry(s - c, c)
    whole = flash_entry(0, s)
    blocks = [flash_entry(m * c, c) for m in range(n - 1)] + [last]
    for i, name in enumerate(("flash_attention", "flash_attention_bwd")):
        out[name] = {"last_block": last[i], "whole_at_offset_0": whole[i],
                     "blocks_summed_ms": sum(e[i]["ms"] for e in blocks),
                     "blocks_summed_bound_ms": sum(e[i]["bound_ms"]
                                                   for e in blocks)}
    bd, kvd, g, size, dd, nd, cap = SEQ_TIMED["decode"]
    blk = size // nd
    qd, kd, vd, _ = decode_case(torch, 531, bd, kvd, g, blk, dd, bf, device)
    pos = torch.full((bd,), blk - 1, dtype=torch.int32, device=device)
    q_h = qd.reshape(bd, kvd * g, 1, dd)
    entries = {}
    for key, lse in (("with_lse", True), ("without_lse", False)):
        kw = dict(cap=cap, return_lse=True) if lse else dict(cap=cap)

        def kern(kw=kw):
            res = decode_attention(qd, kd, vd, pos, **kw)
            return res[0] if lse else res

        def plain(kw=kw):
            res = decode_ref(qd, kd, vd, pos, **kw)
            return res[0] if lse else res
        entries[key] = attention_entry(
            torch, kern, plain,
            lambda: F.scaled_dot_product_attention(q_h, kd, vd,
                                                   enable_gqa=True),
            KERNEL_WORK["decode_attention"](qd, kd, vd, pos, **kw), 20,
            max_abs_err(torch, plain(), kern()), [bd, kvd, g, blk, dd],
            None)
    out["decode_attention"] = entries
    for name, e in out.items():
        log(f"  {name} at the shard shapes, bf16: {json.dumps(e, default=str)}"
            f" ({smi})")
    return out


def family_reduced(np, torch, device, f, pre, dec):
    """``FAMILY_REDUCED[arch]`` (``f``): the reduced whisper-tiny or
    xlstm-350m with 3 heads, in float32, under ``f``'s mesh of the card
    against the same mesh of the CPU: the prefill under ``pre`` and the
    decode steps under ``dec`` (both sides fed the CPU side's greedy
    tokens), the logits within 1e-4; each card call's launches exact by
    route (``serve_launches``), every kernel call at its shard shape held
    against its plain version."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import use_mesh_rules
    cfg = get_arch(f["arch"]).reduced()
    cfg = dataclasses.replace(cfg, d_model=16 * f["heads"],
                              attention=dataclasses.replace(
                                  cfg.attention, n_heads=f["heads"],
                                  n_kv_heads=f["heads"]))
    if f.get("frames"):
        cfg = dataclasses.replace(cfg, enc_seq=f["frames"])
    n = f["mesh"][0] * f["mesh"][1]
    want, routes_by = serve_launches(cfg, n, "float32")
    cpu = build_model(cfg, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=device)
    p_gpu = tree_map(lambda t: t.to(device), p_cpu)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (f["batch"], f["seq"])),
                           dtype=torch.int32)
    frames = serve_frames(np, torch, cfg, f["batch"], "cpu")
    outs = {}
    with torch.no_grad(), record_shard_calls() as seen:
        for side, model, params, dev in (("cpu", cpu, p_cpu, "cpu"),
                                         ("card", gpu, p_gpu, device)):
            card = side == "card"
            mesh = card_mesh(torch, f["mesh"], torch.device(dev))
            extra = () if frames is None else (frames.to(dev),)
            with use_mesh_rules(mesh, **pre):
                (lg, cache), _, launches, routes = counted(
                    torch, lambda: model.prefill(params, toks.to(dev),
                                                 *extra, f["cache"]))
            if card:
                want_launches("reduced prefill", launches, routes,
                              want["prefill"], routes_by["prefill"])
            got = [lg.cpu()]
            for i in range(f["steps"]):
                ref = outs["cpu"][i] if card else got[i]
                nxt = torch.argmax(ref, -1).to(torch.int32)[:, None]
                pos = torch.full((f["batch"], 1), f["seq"] + i,
                                 dtype=torch.int32)
                with use_mesh_rules(mesh, **dec):
                    (lg, cache), _, launches, routes = counted(
                        torch, lambda: model.decode_step(
                            params, nxt.to(dev), pos.to(dev), cache))
                if card:
                    want_launches("reduced decode", launches, routes,
                                  want["decode"], routes_by["decode"])
                got.append(lg.cpu())
            outs[side] = got
    worst = 0.0
    for a, b in zip(outs["card"], outs["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        worst = max(worst, float((a - b).abs().max()))
    held = hold_recorded(torch, {k: v for k, v in seen.calls.items()
                                 if v[1][0].device.type == "cuda"})
    log(f"  {cfg.name} float32 under {f['mesh']}: prefill {pre} + "
        f"{f['steps']} decode steps {dec}: logits card vs CPU max abs diff "
        f"{worst:.3g}")
    return {"model": cfg.name, "mesh": list(f["mesh"]),
            "rules": {"prefill": dict(pre), "decode": dict(dec)},
            "max_abs_diff": worst, "held_at_shard_shapes": held}


def run_seq_family(np, torch, device, smi, train, serve, phase):
    """Phases 55 and 56: ``train``'s step (``run_tp_training`` under
    ``attn_seq_shard``: the float32 gradient gate, the mesh against no
    mesh, its noise side the mesh through the plain versions; the meta
    run of one position x the mesh's positions against all of them,
    where whisper's positions differ (its causal rows) by each position's
    own program, ``seq_share``; the card's counts those of all positions
    on ``meta``, its bytes within ``DRY_MEMORY_TOL``; launches by route;
    every kernel call at its shard shape held against its plain version),
    then ``serve``'s prefill under both layouts and its decode steps
    under ``seq_shard_kv`` (``run_tp_serving``: phase 12's logit rule in
    bfloat16 and float32, exact launches by route), then the reduced
    model under a (2, 2) mesh, card against CPU (``family_reduced``).
    Returns the record."""
    rec = {"training": run_tp_training(np, torch, device, smi, train,
                                       SEQ_TRAIN_RULES, phase)}
    gc.collect()
    torch.cuda.empty_cache()
    rec["serving"] = run_tp_serving(np, torch, device, smi, serve,
                                    SEQ_PREFILL_RULES, SEQ_DECODE_RULES,
                                    phase, reduced=())
    gc.collect()
    torch.cuda.empty_cache()
    rec["reduced"] = family_reduced(np, torch, device,
                                    FAMILY_REDUCED[train["arch"]],
                                    SEQ_PREFILL_RULES, SEQ_DECODE_RULES)
    return rec


def check_decode_block(torch, device):
    """Phase 19's key-block decode step (``mlstm_decode_block``) against
    its plain version on the card from nonzero states, float32 and
    bfloat16: each block's num, den, C1, n1 and m1 within ``MLSTM_TOL``,
    two launches bitwise equal, every launch on ``decode_block``; the
    blocks' sums divided once (``decode_block_merge``) against the whole
    decode step of the same operands (the decode route), h within
    ``MLSTM_TOL`` (bfloat16: ``MLSTM_BF16_TOL``), and the blocks' C1 and
    n1 its rows.  Returns the largest error."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        mlstm_chunk, mlstm_decode_block)
    from repro_torch.kernels.mlstm_chunk.ref import (decode_block_merge,
                                                     mlstm_decode_block_ref)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for i, (b, h, dk, d) in enumerate([(8, 4, 32, 256), (8, 4, 16, 256),
                                           (1, 4, 64, 256), (2, 3, 8, 16),
                                           (3, 2, 32, 64)]):
            q, k, v, ip, fp, C0, n0, m0 = mlstm_operands(
                torch, 960 + i, b, 1, h, d, dtype, device)
            scale = 1.0 / d ** 0.5
            whole = mlstm_chunk(q, k, v, ip, fp, C0, n0, m0, scale)
            num = den = 0
            for j in range(d // dk):
                rows = slice(j * dk, (j + 1) * dk)
                args = tuple(t.contiguous() for t in (
                    q[..., rows], k[..., rows], v, ip, fp, C0[:, :, rows],
                    n0[:, :, rows], m0))
                got, route = take_route(
                    mlstm_decode_block,
                    lambda: mlstm_decode_block(*args, scale))
                want_route("mlstm_decode_block", route, "decode_block")
                again = mlstm_decode_block(*args, scale)
                want = mlstm_decode_block_ref(*args, scale)
                torch.cuda.synchronize()
                if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                    raise AssertionError(f"mlstm_decode_block {b, h, dk, d}:"
                                         f" two launches differ")
                for a, w in zip(got, want):
                    torch.testing.assert_close(a, w, **MLSTM_TOL)
                    worst = max(worst, float((a - w).abs().max()))
                torch.testing.assert_close(got[2], whole[1][:, :, rows],
                                           **MLSTM_TOL)
                torch.testing.assert_close(got[3], whole[2][:, :, rows],
                                           **MLSTM_TOL)
                num, den = num + got[0], den + got[1]
            merged = decode_block_merge(num, den, got[4])
            torch.testing.assert_close(
                merged.float(), whole[0].float(),
                **(MLSTM_TOL if dtype == torch.float32 else MLSTM_BF16_TOL))
            log(f"  mlstm_decode_block {dname} B={b} H={h} DK={dk} D={d} "
                f"(decode_block route, {d // dk} blocks): max abs err "
                f"{worst:.3g} against the plain version, the blocks merged "
                f"against the whole decode step, two launches bitwise "
                f"equal")
    return worst


def time_decode_block(torch, device, launches, err):
    """The key-block decode step at ``DECODE_BLOCK_TIMED`` (phase 56's
    last position) in bfloat16, beside its plain version and its bound
    from this run's shapes (no PyTorch call computes it), checked against
    the plain version at that shape first.  Returns the ``kernels``
    row."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import mlstm_decode_block
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_decode_block_ref
    b, h, dk, d = DECODE_BLOCK_TIMED
    q, k, v, ip, fp, C0, n0, m0 = mlstm_operands(
        torch, 970, b, 1, h, d, torch.bfloat16, device)
    rows = slice(d - dk, d)
    args = tuple(t.contiguous() for t in (q[..., rows], k[..., rows], v, ip,
                                          fp, C0[:, :, rows], n0[:, :, rows],
                                          m0))
    scale = 1.0 / d ** 0.5
    kern = lambda: mlstm_decode_block(*args, scale)        # noqa: E731
    plain = lambda: mlstm_decode_block_ref(*args, scale)   # noqa: E731
    got, route = take_route(mlstm_decode_block, kern)
    want = plain()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **MLSTM_TOL)
    at_shape = max(float((a - w).abs().max()) for a, w in zip(got, want))
    work = KERNEL_WORK["mlstm_decode_block"](*args, scale)
    ms = time_ms(torch, kern, 20, graph=True)
    row = {"name": "mlstm_decode_block", "route": "cuda",
           "source": "src/repro_torch/csrc/mlstm_chunk.cu",
           "replaces": "src/repro/kernels/mlstm_chunk/mlstm_chunk.py:81",
           "kernel_route": route, "launches": launches,
           "max_abs_err": max(err, at_shape), "shape": [b, h, dk, d],
           "dtype": "bfloat16", "ms": ms,
           "eager_ms": time_ms(torch, kern, 20, graph=False),
           "plain_ms": time_ms(torch, plain, 5, graph=True),
           "plain_eager_ms": time_ms(torch, plain, 5, graph=False),
           **bound_keys(work), "bytes": work.bytes,
           "operations": work.flops, "gb_per_s": work.bytes / ms / 1e6,
           "library_ms": None, "library": None, "plain_timing": "graph"}
    log(f"  mlstm_decode_block B={b} H={h} DK={dk} D={d} bf16 ({route} "
        f"route): max abs err {at_shape:.3g}; {ms:.4f} ms in a graph, "
        f"{row['eager_ms']:.4f} ms eager ({row['gb_per_s']:.1f} GB/s); "
        f"plain {row['plain_ms']:.4f} ms (graph; {row['plain_eager_ms']:.4f}"
        f" eager); bound {row['bound_ms']:.5f} ms ({row['bound_by']}: "
        f"{work.bytes} B, {work.flops:.4g} operations)")
    return row


def tp_reduced(np, torch, device, f=TP_REDUCED, rules=None):
    """``TP_REDUCED`` (``f``): the reduced recurrentgemma in float32
    under a (2, 2) mesh of the card against the same mesh of the CPU,
    under ``rules`` (phase 54: ``seq_shard_kv``, a cache longer than the
    window): prefill and the decode steps' logits within 1e-4; each card
    call's launches exact (a position's flash or decode attention an
    attention layer, its RG-LRU scan an RG-LRU layer on prefill) and
    every kernel call at its shard shape held against its plain
    version."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.cost_model import _block_kinds
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.parallel.sharding import use_mesh_rules
    cfg = get_arch(f["arch"]).reduced()
    n = f["mesh"][0] * f["mesh"][1]
    kinds = _block_kinds(cfg)
    attn = sum(k.startswith("attn") for k in kinds)
    rec_layers = sum(k == "rglru" for k in kinds)
    cpu = TransformerLM(cfg, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    gpu = TransformerLM(cfg, device=device)
    p_gpu = tree_map(lambda t: t.to(device), p_cpu)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (f["batch"], f["seq"])), dtype=torch.int32)
    outs = {}
    with torch.no_grad(), record_shard_calls() as seen:
        for side, model, params, dev in (("cpu", cpu, p_cpu, "cpu"),
                                         ("card", gpu, p_gpu, device)):
            card = side == "card"
            with use_mesh_rules(card_mesh(torch, f["mesh"],
                                          torch.device(dev)),
                                **(rules or {})):
                (lg, cache), _, launches, routes = counted(
                    torch, lambda: model.prefill(params, toks.to(dev),
                                                 f["cache"]))
                if card:
                    want_launches("reduced prefill", launches, routes,
                                  {"flash_attention": n * attn,
                                   "rglru_scan": n * rec_layers},
                                  {"flash_attention": "simt"})
                got = [lg.cpu()]
                for i in range(f["steps"]):
                    # both sides fed the CPU side's greedy tokens
                    ref = outs["cpu"][i] if card else got[i]
                    nxt = torch.argmax(ref, -1).to(torch.int32)[:, None]
                    pos = torch.full((f["batch"], 1), f["seq"] + i,
                                     dtype=torch.int32)
                    (lg, cache), _, launches, routes = counted(
                        torch, lambda: model.decode_step(
                            params, nxt.to(dev), pos.to(dev), cache))
                    if card:
                        want_launches("reduced decode", launches, routes,
                                      {"decode_attention": n * attn}, {})
                    got.append(lg.cpu())
            outs[side] = got
    worst = 0.0
    for a, b in zip(outs["card"], outs["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        worst = max(worst, float((a - b).abs().max()))
    held = hold_recorded(torch, {k: v for k, v in seen.calls.items()
                                 if v[1][0].device.type == "cuda"})
    log(f"  {cfg.name} float32 under {f['mesh']} {rules or {}}: prefill + "
        f"{f['steps']} decode logits card vs CPU max abs diff {worst:.3g}")
    return {"model": cfg.name, "mesh": list(f["mesh"]),
            "rules": dict(rules or {}), "max_abs_diff": worst,
            "held_at_shard_shapes": held}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core.channel import RadioParams
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build(_build.sources())
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
    for name in _build.sources():
        for entry, regs, spills in ptxas_resources(_build.build_log(name)):
            log(f"  {name}: {entry}: {regs}; {spills}")

    params = RadioParams()
    log("[3] kernels against their plain versions on the card")
    errs = check_kernels(np, torch, params, device)
    log("[4] small rollout: card against the CPU plain path")
    check_small_rollout(np, torch, device)
    log("[5] main path")
    launches = run_main_path(np, torch, device)
    step_launches = run_step_route(np, torch, device)
    log("[6] kernel times (CUDA events)")
    rows = time_kernels(np, torch, params, device, launches, step_launches,
                        errs)
    log("[7] conv2d kernel against its plain version on the card")
    conv2_err = check_conv2d_kernel(np, torch, device)
    log("[8] CNN path: LLHR plan, then placement-sliced AlexNet")
    cnn_launches, cnn = run_cnn_path(np, torch, device)
    log("[9] conv2d kernel times (CUDA events), batch 32")
    layers, conv_row = time_conv2d(np, torch, device, cnn_launches,
                                   conv2_err)
    rows.append(conv_row)
    log("[10] attention kernels against their plain versions on the card")
    attn_errs = check_attention_kernels(np, torch, device)
    log("[11] reduced LMs: card against the CPU plain path")
    check_reduced_lms(np, torch, device, ("gemma2-9b", "phi4-mini-3.8b"))
    log(f"[12] LM serving path: {LM_ARCH} at full width through "
        f"ContinuousBatcher")
    served = {LM_ARCH: run_lm_path(np, torch, device, LM_ARCH)}
    log("[13] attention kernel times (CUDA events), gemma2-9b shapes")
    rows += time_attention(torch, device, served[LM_ARCH]["launches"],
                           attn_errs)
    log("[14] expert GEMM, RG-LRU scan and decode attention at G = 16 "
        "against their plain versions on the card")
    check_moe_rglru_kernels(np, torch, device)
    log("[15] reduced MoE and griffin LMs: card against the CPU plain path")
    check_reduced_lms(np, torch, device, ("granite-moe-1b-a400m",
                                          "olmoe-1b-7b", "recurrentgemma-9b"))
    for phase, arch in ((16, "olmoe-1b-7b"), (17, "recurrentgemma-9b")):
        log(f"[{phase}] LM serving path: {arch} at full width through "
            f"ContinuousBatcher")
        served[arch] = run_lm_path(np, torch, device, arch)
    log("[18] expert GEMM, RG-LRU scan and G = 16 decode attention times "
        "(CUDA events), served shapes")
    rows += time_moe_rglru(torch, device, served)
    next(r for r in rows if r["name"] == "decode_attention")["g16"] = \
        time_decode_g16(torch, device, served)
    log("[19] mLSTM chunk kernel and its decode route's key-block mode "
        "against their plain versions on the card")
    check_mlstm_kernel(np, torch, device)
    block_err = check_decode_block(torch, device)
    log("[20] reduced xLSTM LM: card against the CPU plain path")
    check_reduced_lms(np, torch, device, ("xlstm-350m",))
    log("[21] LM serving path: xlstm-350m at full width through "
        "ContinuousBatcher")
    served["xlstm-350m"] = run_lm_path(np, torch, device, "xlstm-350m")
    log("[22] mLSTM chunk kernel times (CUDA events), served shapes")
    rows.append(time_mlstm(torch, device, served))
    log("[23] the paper's evaluation path: batched chain DP, contingency "
        "table, SwarmSim against both baselines")
    swarm_eval = run_eval_path(np, torch, device)
    log("[24] the figure scripts and the serving layers: replanner, chaos "
        "ladder, gateway soak, examples")
    serving = run_serving_path(np, torch, device)

    log("[25] attention kernels at whisper-tiny's and qwen2-vl-2b's shapes "
        "against their plain versions on the card")
    slice_errs = check_slice_attention(np, torch, device)
    log("[26] reduced whisper-tiny and qwen2-vl-2b: card against the CPU "
        "plain path")
    check_reduced_extra(np, torch, device)
    check_reduced_lms(np, torch, device, ("qwen2-vl-2b",))
    log("[27] whisper-tiny at full width through the step functions")
    served["whisper-tiny"] = run_whisper_path(np, torch, device)
    log("[28] qwen2-vl-2b at full width through ContinuousBatcher, then "
        "with patch embeddings through the step functions")
    served["qwen2-vl-2b"] = run_lm_path(np, torch, device, "qwen2-vl-2b")
    served["qwen2-vl-2b"]["patches"] = run_vlm_patches(np, torch, device)
    log("[29] attention kernel times (CUDA events), whisper-tiny and "
        "qwen2-vl-2b shapes")
    flash_x, decode_x = time_slice_attention(torch, device, served,
                                             slice_errs)

    slice_records = []
    for phase, title, fn in (
            (30, "the pipeline-stage planner with the card's constants",
             run_pipeline_planner),
            (31, "the main path's rollout split over meshes of the card",
             run_sharded_rollout),
            (32, "examples/torch_serve_swarm.py's three modes on the card",
             run_serve_swarm)):
        log(f"[{phase}] {title}")
        t0 = time.perf_counter()
        slice_records.append(fn(np, torch, device))
        slice_records[-1]["phase_wall_s"] = time.perf_counter() - t0
        log(f"  phase {phase}: {slice_records[-1]['phase_wall_s']:.3f} s")
    pipeline, sharded, serve_swarm = slice_records

    log("[33] flash-attention backward kernel against its plain version on "
        "the card")
    bwd_errs = check_flash_bwd(np, torch, device)
    log("[34] flash-attention backward kernel times (CUDA events), "
        "minicpm-2b and gemma2-9b shapes")
    bwd_row = time_flash_bwd(torch, device, bwd_errs)
    train = {}
    for phase, key, title, fn in (
            (35, "reduced", "reduced training, card against the CPU plain "
             "path", lambda *a: run_reduced_training(*a, TRAIN_ARCHS[:4])),
            (36, "minicpm-2b", "minicpm-2b trained at full width and depth",
             run_full_training),
            (37, "example", "examples/torch_train_lm.py on the card",
             run_train_example),
            (38, "kernel_errs", "expert-GEMM and RG-LRU backward kernels "
             "against their plain versions on the card",
             check_train_kernels),
            (39, "kernel_rows", "expert-GEMM and RG-LRU backward kernel "
             "times (CUDA events), granite-moe and recurrentgemma training "
             "shapes", lambda np_, torch_, dev: time_train_kernels(
                 torch_, dev, train["kernel_errs"])),
            (40, "reduced_moe_griffin", "reduced MoE and griffin training, "
             "card against the CPU plain path",
             lambda *a: run_reduced_training(*a, TRAIN_ARCHS[4:])),
            (41, "slice", "granite-moe-1b-a400m (full width and depth) and "
             "recurrentgemma-9b (full width, 9 layers) trained on the card",
             run_full_training_slice),
            (42, "mlstm_bwd_errs", "mLSTM chunk backward kernel against its "
             "plain version on the card", check_mlstm_bwd),
            (43, "mlstm_bwd_timing", "mLSTM chunk backward kernel times "
             "(CUDA events), xlstm-350m's training call",
             lambda np_, torch_, dev: time_mlstm_bwd(
                 torch_, dev, train["mlstm_bwd_errs"])),
            (44, "reduced_xlstm", "reduced xLSTM training, card against the "
             "CPU plain path",
             lambda *a: run_reduced_training(*a, ("xlstm-350m",))),
            (45, "xlstm-350m", "xlstm-350m trained at full width and depth "
             "(S cut to 1,024)", run_xlstm_training)):
        log(f"[{phase}] {title}")
        t0 = time.perf_counter()
        train[key] = fn(np, torch, device)
        train[key]["phase_wall_s"] = time.perf_counter() - t0
        log(f"  phase {phase}: {train[key]['phase_wall_s']:.3f} s")
    sharded_model = {}
    for phase, key, title, fn in (
            (46, "expert_parallel", f"expert-parallel serving: {EP_ARCH} "
             f"at full width under meshes {EP_MESHES} of the card",
             lambda *a: run_expert_parallel(*a, served)),
            (47, "pipeline", f"the LLHR-planned pipelined forward: "
             f"{PIPE_ARCH} at full width over {PIPE_STAGES} stages of the "
             f"card", run_llhr_pipeline),
            (48, "int8_allreduce", f"the int8 all-reduce over "
             f"{ALLREDUCE_SHARDS} entries of the card against the CPU",
             run_int8_allreduce)):
        log(f"[{phase}] {title}")
        t0 = time.perf_counter()
        sharded_model[key] = fn(np, torch, device)
        sharded_model[key]["phase_wall_s"] = time.perf_counter() - t0
        log(f"  phase {phase}: {sharded_model[key]['phase_wall_s']:.3f} s "
            f"({smi})")
    launch_debug = {}
    for phase, key, title, fn in (
            (49, "dry_run", "the dry run beside the card: "
             f"{', '.join(DRY_CALLS)} on meta and on the card",
             lambda np_, torch_, dev: run_dry_run(np_, torch_, dev, smi)),
            (50, "sanitized", "the main path's rollout inside "
             "sanitized(PLAN_FN_CACHE)", run_sanitized_rollout)):
        log(f"[{phase}] {title}")
        t0 = time.perf_counter()
        launch_debug[key] = fn(np, torch, device)
        launch_debug[key]["phase_wall_s"] = time.perf_counter() - t0
        log(f"  phase {phase}: {launch_debug[key]['phase_wall_s']:.3f} s "
            f"({smi})")
    tp = {}
    for phase, key, title, fn in (
            (51, "training", f"{TP_TRAIN['arch']} trained at full width "
             f"under a {TP_TRAIN['mesh']} mesh of the card (FSDP x TP)",
             lambda np_, torch_, dev: run_tp_training(np_, torch_, dev,
                                                      smi)),
            (52, "serving", f"{TP_SERVE['arch']} served at full width "
             f"under a {TP_SERVE['mesh']} mesh of the card, then "
             f"{TP_REDUCED['arch']} reduced under {TP_REDUCED['mesh']}",
             lambda np_, torch_, dev: run_tp_serving(np_, torch_, dev,
                                                     smi)),
            (53, "seq_rows", f"{SEQ_TRAIN['arch']} trained and served at "
             f"full width under a {SEQ_TRAIN['mesh']} mesh of the card "
             f"(attn_seq_shard, seq_shard_kv)",
             lambda np_, torch_, dev: run_seq_rows(np_, torch_, dev, smi)),
            (54, "seq_kv", f"{KV_SERVE['arch']} served at full width under "
             f"a {KV_SERVE['mesh']} mesh of the card (seq_shard_kv), then "
             f"the reduced gemma2-9b and recurrentgemma-9b",
             lambda np_, torch_, dev: run_seq_kv(np_, torch_, dev, smi)),
            (55, "whisper", f"whisper-tiny trained and served at full width "
             f"and depth under a {WHISPER_TRAIN['mesh']} mesh of the card "
             f"(attn_seq_shard, seq_shard_kv), then reduced under (2, 2)",
             lambda np_, torch_, dev: run_seq_family(
                 np_, torch_, dev, smi, WHISPER_TRAIN, WHISPER_SERVE, 55)),
            (56, "xlstm", f"xlstm-350m (full width, {XLSTM_TRAIN['n_layers']}"
             f" layers) trained and served under a {XLSTM_TRAIN['mesh']} "
             f"mesh of the card, the state handed on along model and the "
             f"decode state by key rows, then reduced under (2, 2)",
             lambda np_, torch_, dev: run_seq_family(
                 np_, torch_, dev, smi, XLSTM_TRAIN, XLSTM_SERVE, 56))):
        log(f"[{phase}] {title}")
        t0 = time.perf_counter()
        tp[key] = fn(np, torch, device)
        tp[key]["phase_wall_s"] = time.perf_counter() - t0
        log(f"  phase {phase}: {tp[key]['phase_wall_s']:.3f} s ({smi})")
    del train["kernel_errs"], train["mlstm_bwd_errs"]
    mlstm_timing = train.pop("mlstm_bwd_timing")
    xlstm_launches = train["xlstm-350m"]["launches"]
    mlstm_bwd_row = dict(mlstm_timing["row"],
                         launches=xlstm_launches["mlstm_chunk_bwd"],
                         launches_by_path={"xlstm-350m training":
                                           xlstm_launches["mlstm_chunk_bwd"]})
    kernel_rows = train.pop("kernel_rows")
    train_rows = kernel_rows["rows"]
    next(r for r in rows if r["name"] == "rglru_scan")["train"] = \
        kernel_rows["rglru_scan_train"]
    slice_runs = {a: train["slice"][a] for a in (f["arch"]
                                                 for f in FULL_TRAIN_SLICE)}
    bwd_row["launches"] = train["minicpm-2b"]["launches"][
        "flash_attention_bwd"]
    slice_archs = list(slice_runs)
    bwd_row["launches_by_path"] = {
        "minicpm-2b training": bwd_row["launches"],
        **{f"{a} training": r["launches"]["flash_attention_bwd"]
           for a, r in slice_runs.items()},
        "torch_train_lm": {k: train["example"][k]["launches"]
                           for k in ("default", "simulate-failure")}}
    rows.append(bwd_row)
    for row in train_rows:
        arch = slice_archs[0] if row["name"].startswith("moe") \
            else slice_archs[1]
        row["launches"] = slice_runs[arch]["launches"][row["name"]]
        row["launches_by_path"] = {f"{arch} training": row["launches"]}
        rows.append(row)
    for row in rows:
        row.update({"flash_attention": flash_x,
                    "decode_attention": decode_x}.get(row["name"], {}))
        if row["name"] in ("flash_attention", "decode_attention"):
            row["launches_by_path"] = {a: s["launches"][row["name"]]
                                       for a, s in served.items()}
            row["launches_by_path"]["serve-lm"] = \
                serve_swarm["lm"]["launches"][row["name"]]
            if row["name"] == "flash_attention":
                for a, r in [("minicpm-2b", train["minicpm-2b"]),
                             *slice_runs.items()]:
                    row["launches_by_path"][f"{a} training"] = \
                        r["launches"]["flash_attention"]
        if row["name"] == "mlstm_chunk":
            row["train"] = mlstm_timing["forward_train"]
            row["launches_by_path"] = {
                "served": row["launches"],
                "xlstm-350m training": xlstm_launches["mlstm_chunk"]}
        if row["name"] in ("moe_matmul", "rglru_scan"):
            a = slice_archs[0 if row["name"] == "moe_matmul" else 1]
            row["launches_by_path"] = {
                "served": row["launches"],
                f"{a} training": slice_runs[a]["launches"][row["name"]]}
        if row["name"] in ("link_geometry", "tropical_dp"):
            row["launches_by_path"] = {"rollout": row["launches"], **{
                f"rollout over {m['mesh']}": m["launches"][row["name"]]
                for m in sharded["meshes"]}}

    rows.append(mlstm_bwd_row)
    log("[57] the key-block decode step's time (CUDA events), phase 56's "
        "shape")
    rows.append(time_decode_block(
        torch, device, tp["xlstm"]["serving"]["decode_launches"],
        block_err))
    # the attention kernels at phase 53's and 54's shard shapes
    seq_times = tp["seq_rows"].pop("kernel_times")
    for row in rows:
        if row["name"] in seq_times:
            row["seq_shard"] = seq_times[row["name"]]

    print(json.dumps({"tp_fsdp": tp}, default=str))
    print(json.dumps({"launch_debug": launch_debug}, default=str))
    print(json.dumps({"sharded_model": sharded_model}, default=str))
    print(json.dumps({"train": train}, default=str))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"sharded_rollout": sharded}))
    print(json.dumps({"serve_swarm": serve_swarm}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"swarm_eval": swarm_eval}))
    print(json.dumps({"cnn_path": cnn}))
    for arch, lm in served.items():
        print(json.dumps({"lm_serve": lm}))
    print(json.dumps({"conv2d_layers": layers}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
