#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda`` or ``CUDA_HOME``). Phases, each fatal on failure:

1. Build every CUDA kernel of the main path from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), and print the registers and spills
   ``ptxas`` reports for each instance of the tensor-core attention kernel
   (``flash_attention_wgmma.cu``), the Gram kernel (``pairwise_gram.cu``),
   ``bucket_mix.cu``, ``residual_norms.cu`` (which ``cclip_fused_iter``
   launches too), ``cclip.cu`` and every instance of the selection kernels
   it builds (W = 5 .. 128); a spill in any of them fails the phase.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (cohort W = 10, m = 5 buckets, d = 106,496: the
   784-128-10 MLP packed) and at the paper's n (W = 25, m = 13) with
   d = 16,777,216; time kernel, plain version and a one-call PyTorch
   yardstick, and compute each call's bound from bytes and operations.
   The Gram is also timed at a rank's slice of the 4-rank sync
   (X[10, 26,624]); it must be bitwise repeatable, symmetric and equal to
   its chain over 2048-aligned cuts, and it must stage X by TMA at these
   shapes (``VARIANT_LAUNCHES``), and by predicated loads at an unaligned
   X[10, 100,003], whose Gram equals bit for bit the TMA call on the same
   columns padded to 2048. Above 64 workers (W = 65 and 128, d = 106,496)
   the mix and combine and the Gram (one launch per pair of 32-row groups:
   symmetric, bitwise repeatable) are held, timed and bounded the same way.
   CM and TM (``SELECTION_SHAPES``: X[5, 106,496] with b = 1, 2; a rank's
   X[5, 26,624]; X[13, 16.7 M] and X[27, 16.7 M] with b = 5; X[65 / 128,
   106,496] with b = W // 4) are held bit for bit, on random values and on
   the same values with NaN, signed-zero and infinite columns, and bounded
   by min / max and add instruction rates (``kernels/cost.py::selection_ops``).
3. Drive the main path: ``CrossDeviceSim`` trains the MLP for 120 rounds
   under four rule/attack pairs. For each pair the kernel launch counts are
   set to 0 just before its run and read just after: each kernel of its
   route (Gram: ``pairwise_gram`` + ``bucket_mix``; CM or TM: ``bucket_mix``
   + the rule's kernel) must have launched once a round, every other
   kernel never. rfa+bitflip and acclip+ipm must pass 0.7 test accuracy.
   One round on the card is also held against the same round on the CPU.
4. Hold the residual-norm and centered-clipping kernels (``residual_norms``,
   ``cclip_fused_iter``, ``cclip_combine``) against their plain versions at
   the per-rank shape of the sharded sync ([5, 26,624]), the one-device
   main shape ([10, 106,496]), the paper's n = 25 and 53 ([25 / 53,
   16,777,216]) and above 64 workers ([65, 106,496], [128, 106,496]),
   timed and bounded as in phase 2. At each shape the v' of
   ``cclip_fused_iter`` equals ``cclip_combine``'s bit for bit (the same
   fmaf chain), every norm repeats bit for bit, and a ``cclip_fused_iter``
   call is one CUDA kernel (profiler).
5. Drive the one-device compositions ``ops.rfa_aggregate``, ``ops.cclip_aggregate``
   and ``ops.cclip_aggregate_unfused`` against their vector-space oracles,
   each with its exact launch counts, and time them at the paper's shape.
6. Drive the multi-rank sync: 4 ranks share the card under gloo
   (``launch.mesh.spawn_ranks``) and run ``robust_gradient_sync`` over the
   group on the MLP's per-worker gradients (W = 10, bucketing s = 2,
   d = 101,770) for rfa, cclip, cm, tm, krum and acclip. Each rank checks
   its exact launch counts per rule and its result against the one-device
   packed engine on the card (CM/TM bit for bit, the rest to 5e-4); every
   rank's result must be the same bit for bit. Host time per sync over 20
   syncs is printed, for 4 ranks sharing one card.
7. Hold ``flash_attention`` against its plain version (``ref.attention``) on
   the card: the reference test's four cases in fp32 (2e-4), and in bf16
   (torch's bf16 tolerance, with the fp64 error of kernel and plain version
   printed) the attention shapes of the ported configs at B = 1, S = 4096
   (TinyLlama H 32 / KV 4 / dh 64, qwen2.5-14b 40 / 8 / 128, gemma-7b
   16 / 16 / 256), a chunked prefill (Sq = 512 against Skv = 4096) and a
   window of 1024; timed and bounded as in phase 2 (bf16 operations against
   the tensor-core peak), with ``scaled_dot_product_attention`` as the
   yardstick (``is_causal`` where ``Sq == Skv`` and there is no window, else
   an explicit boolean ``attn_mask``). Each row prints the kernel that ran
   (``VARIANT_LAUNCHES``): every bf16 row must take ``wgmma``, every fp32
   row ``simt``; each bf16 row also checks and times the CUDA-core kernel on
   the same inputs, as the earlier design's time in the same run.
8. Serve TinyLlama-1.1B at full width (22 layers, bf16, random weights from
   a seeded generator on the card): (a) ``make_prefill_step`` on B = 2,
   S = 4096 gives finite next-token logits [2, 1, 32000], timed; (b) layer
   0's q/k/v, made by the model's own ``rmsnorm`` and ``_project_qkv`` from
   that prefill's embeddings, go through ``flash_attention`` (exactly one
   launch, of the ``wgmma`` kernel, counted on its own) and are held against
   the plain version, the model's ``_attn_blockwise`` and ``_attn_xla`` (2^-5),
   and an fp64 attention (the kernel's error no larger than blockwise's);
   (c) a ``ServeEngine`` with 4 slots serves 6 seeded requests (prompts of
   16-96 tokens, 16 new tokens each, greedy) to completion, and request 0's
   tokens equal a sequential greedy loop over ``decode_step`` run at the
   engine's batch width (the one-row loop's agreement is printed); decode
   ms per step and tokens/s are printed, and 20 steps with all 4 slots busy
   are timed (5 more under the profiler); (d) in fp32 at full width, the last
   prompt position's logits of the prefill and of token-by-token decode
   agree within the reference's bar (rtol and atol 2e-3). The serving
   path's own modules launch no kernel, as in the reference (counted).
9. Drive the paper's experiment loop, ``ByzantineSim``, at the benchmark's
   scale: the 784-128-10 MLP on SynthMNIST (4,000 train / 1,000 test) split
   non-iid over n = 25 workers, f = 5 Byzantine (0 in the unattacked runs),
   batch 32, 300 steps (``PAPER_RUNS``: mean; Krum without and with
   bucketing; CM under mimic without and with bucketing; RFA under
   bit-flipping; CCLIP under IPM with worker momentum 0.9, lr 0.5). One
   step of each on the card equals the same step on the CPU with the same
   draws (rtol 1e-4, atol 1e-6); the accuracies must pass the thresholds of
   ``tests/test_sim.py``, which the JAX reference meets at this scale
   (``PAPER_REFERENCE``, from ``scripts/paper_loop_reference.py``, printed
   beside them). Each run is counted on its own and launches no kernel, as
   in the reference; steps/s and the profiled busy share are printed beside
   the card's name and power limit.
10. Telemetry on the card: (a) ``ByzantineSim(telemetry=True)`` under ALIE
   (n = 25, f = 5, 15 steps): the Byzantine rows' ``cm_worker_dev`` is
   below 0.6 times the honest rows' and their Krum scores are lower; (b)
   for each of phase 3's pairs, 20 ``CrossDeviceSim`` rounds with telemetry
   on and off from the same draws launch the same kernels and end on the
   same parameters bit for bit, every metric finite and catalogued; (c) in
   each rank of phase 6, ``robust_gradient_sync(telemetry=True)`` for RFA
   and CCLIP launches what off did and keeps its bits, the metrics are
   equal bit for bit on every rank, and ``rfa_resid_norms`` /
   ``cclip_lam`` are within 1e-4 of the one-device engine's; (d) phase
   8(c)'s engine writes one ``serve`` event a step to a log on disk that
   ``validate_jsonl`` accepts.
11. LLM training (``distributed/steps.py::make_train_step``): (a)
   TinyLlama-1.1B at full width (22 layers, bf16, 1,100,048,384 random
   parameters from a seed) trained by W = 4 workers, one 1024-token
   sequence each from ``make_token_stream`` (one affine-bigram law a
   worker), sgdm lr 1e-2, worker momentum 0.9: RFA with bucketing s = 2
   for 3 steps, then CM for 1 step. Each step launches exactly ``TRAIN_ROUTE``'s kernels at
   X[4, n_pad], n_pad = 1,100,048,384 + padding; its loss is finite and the
   parameters move; its aggregate, recomputed on the same worker momenta,
   equals the plain route's (``TRAIN_AGG_RTOL`` of the largest row norm),
   and the kernel's Gram agrees with an fp64 Gram (``TRAIN_GRAM_RTOL`` of
   sqrt(G_ii G_jj)). Host ms a step, tokens/s, device ms by phase (CUDA
   events: forward + backward, worker momentum, pack, each kernel's phase,
   the optimizer) and each step's peak memory are printed; then
   ``pairwise_gram``, ``bucket_mix`` (mix [2, 4], combine [1, 4]) and
   ``cwise_median`` (X[2, n_pad]) are held and timed on the packed momenta,
   as in phase 2. (b) ``tests/test_system.py``'s run at smoke width (30
   steps, RFA + bucketing, lr 0.3) at W = 1 and 4 meets its gate (last loss
   below 0.8 x the first). (c) 4 gloo ranks on the card run the
   worker-sharded step (one worker a rank; the rows go to column slices
   through one ``all_to_all``) for 3 steps of RFA and of CM: launches per
   rank as phase 6's, every rank's parameters equal rank 0's bit for bit
   and the one-device step's within rtol 1e-4 / atol 1e-6. (d) gemma-7b
   at its published width (d_model 3072, 16 heads of 256, GeGLU d_ff
   24,576, tied 256,000-row embedding, bf16, server momentum) with the
   depth cut to 2 of 28 layers (1,340,095,488 parameters, the tree's count
   asserted), W = 4 workers of one 4096-token sequence (train_4k's
   length), RFA with bucketing s = 2: one step with the config's
   ``remat="full"`` (each period recomputed in the backward) and one with
   ``remat="none"`` from the same state, batch and mix. Parameters and
   optimizer state bit for bit between them, exact launches, a finite
   loss, host ms, forward + backward device ms, and the peak memory above
   the state through the forward and backward (lower with recompute) and
   in the step; the step's aggregate of its rows (each worker's gradient
   at the start, recomputed) equals the plain route's and the kernel's
   Gram the fp64 Gram, with (a)'s bars.
12. The MoE family (``models/moe.py``): (a) OLMoE-1B-7B served at its
   published width and depth (16 layers, 64 experts top-8, d_ff_expert
   1024, bf16; 6,919,096,320 random parameters from a seed, the count
   asserted): ``make_prefill_step`` on B = 2, S = 4096 (C = 1280) timed,
   its drop fraction printed; phase 8's 6-request
   ``ServeEngine`` run, request 0 equal to the greedy loop at the engine's
   width (C = 8 >= 4 decode tokens: none dropped); 20 decode steps with 4
   slots busy timed (5 more under the profiler) beside their bound (every expert's
   weights are read each step); no kernel of ours launches (counted). (b)
   phase 11(a)'s training at OLMoE's full width with the depth cut to 2
   layers (d = 1,045,178,368): the same steps, exact launches, checks and
   prints, then each worker's routing on the trained model (drop fraction,
   experts that got no token from some worker). (c) The smoke-width gate
   of phase 11(b) for OLMoE at W = 4, and one Kimi K2 smoke step of RFA
   and of CM (fsdp on one rank, server momentum, bf16 optimizer momentum)
   with exact launches.
13. The SSM and hybrid families (``models/ssm.py``): (a) Mamba2-130m
   served at its published width and depth (24 layers, d_inner 1536, 24
   heads of 64, N = 128, tied vocab 50,280, bf16; the tree's 128,983,488
   parameters asserted, the reference formula's 128,958,336 beside them):
   the prefill on B = 2 x 4096 (64 chunks) timed, phase 8's
   6-request ``ServeEngine`` run with request 0 and request 4 (served after
   another in its slot, whose SSM state the engine zeroed) equal to the
   greedy loop, 20 decode steps with 4 slots busy timed (5 more under the profiler) beside
   their bound (the parameters, and the SSM state read and written); no
   kernel of ours launches (counted). (b) phase 11(a)'s training at
   Mamba2's full width and depth (d = 128,983,488), one RFA and one CM
   step (``SSM_TRAIN_RUNS``; 15(h) trains it again on one
   device as its reference): exact launches, the aggregate equal to the
   plain route's, every parameter and momentum leaf finite, then the three
   kernels held and timed on its packed momenta.
   (c) Jamba v0.1 at its published width over one period, 8 of 32 layers
   (1 attention, 7 SSM, 4 MoE and 4 SwiGLU layers; 13,267,656,416
   parameters, 26.5 GB: the 52 B parameters fit on no 80 GB card): (a)'s
   serving checks (request 0), the prefill's drop fraction. (d) phase
   11(b)'s smoke gate at W = 4 for Mamba2 and Jamba, then one RFA and one
   CM smoke step of each with exact launches.
14. Prefix embeddings and codebooks: (a) InternVL2-2B's prefill at its
   published width and depth, B = 2 with 256 prefix embeddings from a seed
   before 3,840 tokens, timed, logits [2, 1, V] finite; (b)
   MusicGen-medium's prefill on B = 2 x 4 codebooks x 4,032 tokens after
   64 prefix embeddings, logits [2, 1, 4, 2048], then 20 greedy
   ``decode_step`` calls on [2, 4] tokens timed; the engine refuses
   codebooks, as the reference's does; none launches a kernel of ours
   (counted). (c) the smoke gate and one RFA and one CM step of each (the
   VLM with prefix embeddings in the batch, the audio model on codebook
   streams), and one RFA smoke step of Qwen1.5-32B, with exact launches.

15. Sharding over a mesh of ranks (``distributed/sharding.py``): 4 gloo
   ranks share the card (``launch.mesh.make_host_mesh``). (a) gemma-7b at
   its published width (d_model 3072, 16 heads of 256, GeGLU d_ff 24,576,
   tied 256,000-row embedding, bf16, fsdp, server momentum) with the depth
   cut to 1 of 28 layers (1,063,265,280 parameters, the tree's count
   asserted) trained on the mesh (data=4, model=1), W = 4 workers of one
   1024-token sequence each: RFA with bucketing s = 2 for 1 step, then CM
   for 1 from RFA's state (``FSDP_RUNS``),
   each with the group's exact launches per rank, a finite loss and
   moving parameters, the first step of each rule held against the plain
   route of the same sharded sync on each rank's column slice
   (``TRAIN_AGG_RTOL`` of the largest row norm); each rank holds only its
   blocks (printed, the embed on ("data", "model") by gemma's override),
   and receives in the egress
   exactly its blocks' bytes, never the [n_pad] row; host ms a step,
   tokens/s and each step's peak memory per rank. (b) gemma at smoke width
   on the (4, 1) and (2, 2) meshes: 3 steps of RFA and of CM, the fsdp
   step's gathered parameters and momenta equal to the replicated step's
   (fsdp off, same mesh) bit for bit and within rtol 1e-4 / atol 1e-6 of
   the one-device step. (c) TinyLlama-1.1B at full width and depth served
   on (4, 1): the prefill on B = 4 x 4096 (a row a rank) against the
   one-device prefill; ``make_serve_step`` with a batch-sharded 4-row cache,
   ``MESH_DECODE_STEPS`` greedy steps after a 16-token prompt equal to the
   one-device greedy loop's tokens at the rank's width; with B = 1 and the cache
   sequence-sharded over the 4 ranks, filled from a seed at 4,095
   positions, one decode step's logits against ``decode_step`` on the same
   cache (in fp32 within the reference's decode bar, rtol and atol 2e-3;
   in bf16 no further from the fp32 logits than ``SEQ_BF16_RATIO`` x the
   one-device bf16 step); then a ``SEQ_PROMPT``-token prompt
   in a ``SEQ_CACHE``-position cache (4 positions a rank) decoded greedily
   for ``SEQ_NEW`` steps, in fp32 the tokens equal to the one-device loop's (in bf16 the
   share that agrees is printed: bf16 products over a rank's positions
   round otherwise than over all of them and can move a near tie); no
   kernel of ours launches (counted). (d) (b)'s fsdp state on (4, 1) saved from the mesh, restored on one device
   and onto the mesh, bit for bit. (b) to (d) run in one group; (b)'s
   (2, 2) steps compute along its model axis. (e) In (a)'s group, (a)'s
   gemma-7b on (data=1, model=4), every part of the compute plan split
   (16 / 4 heads, 16 / 4 kv heads, d_ff 24,576 / 4, vocab 256,000 / 4;
   ``models/parallel.py``): one RFA step (``TP_RUNS``; CM along a model
   axis is 15(h)'s) on (a)'s batch from the seeded init, each rank
   checking its compute blocks' shapes, the exact ``SYNC_ROUTE``
   launches, the loss equal bit for bit on every rank and (a)'s
   plain-route check; then rank 0 runs the same step
   with ``mesh=None`` from the same seeded init, batch and mix (exact
   ``TRAIN_ROUTE`` launches): the mesh step's loss within ``TP_LOSS_TOL``
   of it and its aggregate, gathered whole, within ``TP_AGG_RTOL`` of the
   largest worker row norm. Host ms a step, and each rank's peak at the
   end of the forward and backward (``phase_times``' peaks) beside (a)'s,
   which it must stay below. (f) In (a)'s group, gemma-7b served at its
   published width on each rank's compute blocks (``tps_rank``; weights
   drawn leaf by leaf from seeded generators, ``seeded_params``, each leaf
   cut to its block as ``sharding.compute_blocks`` cuts and freed), each
   rank asserting that it holds exactly the plan's blocks. At REMAT_LAYERS
   of 28 layers in fp32 and bf16: on (data=1, model=4) the prefill of
   ``TPS_PREFILL`` (2 x 1024 tokens), a greedy decode of 4 slots
   (``TPS_GEMMA``'s ``new`` tokens after a ``prompt``-token prompt,
   ``MESH_DECODE_CACHE`` positions) and one step on a seeded one-row
   ATTN_S cache (positions over model); on (2, 2) one batch-sharded step
   on a seeded 4-row cache and the one-row step (positions over data, kv
   heads over model). ``tps_check`` runs the same on one device: every
   rank the same bits, in fp32 the greedy tokens equal and every logit
   within ``TP_LOSS_TOL``, in bf16 each output no further from the fp32
   one-device logits than ``SEQ_BF16_RATIO`` x the one-device bf16 run's.
   Then one bf16 run at full depth (``TPS_FULL_LAYERS``) on (1, 4): each
   rank's bytes and peak against one device's, prefill ms and decode ms a
   token (``TPS_FULL_NEW`` tokens), with the card's name and power limit;
   no kernel of ours launches (counted). (g) In (a)'s group, OLMoE-1B-7B's
   MoE layers along the model axis of (data=1, model=4) (``moe_rank``):
   each rank computes its 16 of 64 experts, the router and routing whole
   on every rank (``models/moe.py``). Training: (e)'s step and holds
   (``tp_rank`` / ``tp_check``; one RFA step, ``MOE_TP_RUNS``) on OLMoE at
   its published width, MOE_TP_LAYERS deep in MOE_TP_DTYPE, worker
   momentum, the replicated egress: exact launches, the loss within
   ``TP_LOSS_TOL`` and the aggregate within ``TP_AGG_RTOL`` of one
   device's, each rank's peak at the end of the forward and backward
   below one device's, the assignments routed otherwise printed; then the
   same step in bf16, held
   to the same bits on every rank, a finite loss, exact launches, the
   plain-route check and a peak below one device's, its gap to one
   device's loss and aggregate printed. Serving:
   (f)'s ``tps_rank`` / ``tps_check`` with ``TPS_MOE`` (MOE_TRAIN_LAYERS
   deep in fp32 and bf16: the B = 2 x 1,024 prefill and the 4-slot greedy
   decode on (1, 4), one batch-sharded step on (2, 2); the bf16 holds on
   each output and on the mean over every held logit row; the assignments
   the prefill routed otherwise than one device printed; one bf16 run at
   8 of its 16 layers, each rank's expert bytes printed). (h) In (a)'s
   group, Mamba2-130m's SSM layers along the model axis of (data=1,
   model=4) (``ssm_rank``): each rank computes its 6 of 24 SSD heads (the
   z, x and dt columns of in_proj, the x channels of the conv, the
   per-head leaves, the gated norm's scale and out_proj's rows), B and C
   whole on every rank (``models/ssm.py``). Training at the published
   width and depth in fp32 (``tp_rank`` / ``tp_check``; one RFA and one CM
   step, ``SSM_TP_RUNS``, worker momenta in the rank's head blocks): exact
   launches, the loss within ``SSM_TP_LOSS_TOL`` of one device's
   (absolute) and the aggregate within ``SSM_TP_AGG_RTOL`` of the largest
   row norm, each rank's peak below one device's. Serving (``tps_rank`` /
   ``tps_check`` with ``TPS_SSM``, 12 of its 24 layers in fp32 and bf16 on
   (1, 4)):
   the B = 2 x 1,024 prefill and a 4-slot greedy decode of 3 tokens after
   the prompt, in fp32 the tokens equal to one device's and every logit
   within ``TPS_SSM["tol"]``, in bf16 each output within ``SEQ_BF16_RATIO``
   x one device's distance from fp32; a rank's parameter bytes against the
   whole. Jamba v0.1's SSM layer alone at its width (d_model 4,096, 128
   heads, N = 16; ``ssm_layer_rank``), ``SSM_LAYER_S`` tokens, forward and
   backward on (1, 4) against one device: in fp32 the output and every
   gradient within ``SSM_LAYER_RTOL["float32"]`` of its largest one-device
   magnitude, in bf16 within ``SSM_LAYER_RTOL["bfloat16"]``. (i) Attention
   whose heads the model axis does not divide, on (data=1, model=16): a
   group of ``HEADS_TP_RANKS`` = 16 gloo ranks on the card, the attention
   in t = 8 head blocks, each held by 2 ranks, replica 0's partial alone
   summed (``models/parallel.py``). The ranks start up beside phase 15's
   and wait for its end (``start_heads``); the parent computes the
   one-device references while they run. qwen2.5-14b's attention layer alone at
   its width (d_model 5,120, 40 / 8 heads of 128: 5 q heads and one kv
   head a block; ``heads_layer_rank``), ``HEADS_LAYER_B`` x
   ``HEADS_LAYER_S`` tokens, forward and backward against one device: in
   fp32 the output and every gradient within ``HEADS_LAYER_RTOL
   ["float32"]`` of its largest one-device magnitude, in bf16 within
   ``HEADS_LAYER_RTOL["bfloat16"]``, a rank's attention bytes 1 / 8 of the
   layer's. MusicGen-medium at its published width, ``HEADS_AUDIO_LAYERS``
   deep in fp32 (24 heads, 3 a block; d_ff 6,144 and the 4 x 2,048
   codebook vocab split 16 ways): (e)'s ``tp_rank`` / ``tp_check`` with
   one RFA step (``HEADS_TP_RUNS``), the loss within ``HEADS_TP_LOSS_TOL``
   of one device's (absolute) and the aggregate within
   ``HEADS_TP_AGG_RTOL`` of the largest row norm, the exact launches, each
   rank's peak below one device's; served (``tps_rank`` / ``tps_check``
   with ``TPS_HEADS``): the B = 2 x 1,024 prefill and a 4-slot greedy
   decode of 3 tokens after a 4-token prompt in fp32, the tokens equal to
   one device's and every logit within ``TPS_HEADS["tol"]``. The phase has
   no fallback to the whole layer or the whole attention: any miss raises.
16. The CNN of App. Table 5 (``models/mlp.py::init_cnn``, HWIO convolutions
   run by cuDNN under ``ieee_fp32()``) and the static-analysis gate. (a)
   ``ByzantineSim`` with the CNN at phase 9's scale (n = 25, 300 steps) for
   two of phase 9's pairs with their learning rates (``CNN_RUNS``): one
   step on the card against the step on the CPU with the same draws
   (parameters and momenta, rtol 1e-4 / atol 1e-6), no kernel launched,
   the test accuracy within ``CNN_MARGIN`` of the JAX reference's on the
   CPU at the same seeds (``CNN_REFERENCE``), steps/s, peak memory,
   profiled. (b) ``CrossDeviceSim`` with the CNN on phase 3's pool at
   scale 1 and 4 (d = 52,114 / 824,362) under RFA, CM and TM with
   bucketing: one round on the card against the CPU's (rtol 1e-4 / atol
   1e-5), the aggregate of the card's own messages through the kernels
   against the plain versions (CM / TM bit for bit), ``CNN_ROUNDS`` rounds
   with the route's exact launches (``launches_by_path`` ``cnn.slice.*``),
   rounds/s, peak memory, busy share; the four kernels held and timed at
   scale 4's packed width (X[10, 825,344]). (c) ``python -m
   repro_torch.analysis --layers ast,trace --device cuda``'s ``main``: the
   six targets on the card's one rank, no finding (f64, host syncs, kernel
   presence read from ``LAUNCHES``), exit 0, exact launches.
17. 16-bit worker rows, the dry-run and the examples. (a) Every
   aggregation kernel and form on bf16 X at the path shape (X[10, 106,496];
   CM / TM X[5, 106,496]), at TinyLlama-1.1B's training shape X[4, n_pad]
   and at an unaligned d = 100,003, and on fp16 X at the path shape:
   ``kernel(X16)`` equals ``kernel(X16.float())`` bit for bit, the same
   launches; held against the plain version, timed, bounded by
   ``kernels/cost.py`` at 2 bytes an element of X, the fp32 row's library
   call timed on ``X16.float()`` with the cast. The Gram must stage X16 as
   ``pairwise_gram.variant`` says (TMA of the 16-bit type where d % 8 == 0,
   predicated loads at d = 100,003); where it took TMA, the predicated
   loads on a copy one element off 16-byte alignment (same bits) and the
   fp32 TMA route on ``X16.float()`` are timed beside it. (b) The per-leaf
   engine on TinyLlama-1.1B's full-width tree of bf16 leaves (W = 4,
   bucketing s = 2, rfa and cm): each aggregate equals the packed engine's
   bit for bit, with the launches stated from the leaf count
   (``x16.per_leaf.*``, ``x16.packed.*``) and each Gram's route as the
   variant rule gives it, host ms, device ms and peak memory of each engine.
   (c) ``python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape
   train_4k --layers 4`` (4 of 22 layers) in a subprocess (fake tensors on the host's CPU), started
   before phase 1 and run beside phases 1, 2 and 4, which report device
   times only; it must end before phase 3: exit 0 and its four lines. (d)
   ``examples/quickstart_torch.py``, ``attack_defense_matrix_torch.py
   --steps 50`` and ``serve_decode_torch.py`` in subprocesses after (b),
   each exiting 0.

Each log line starts with the seconds since the process imported this
script. The last two lines are the ``kernels`` JSON and the result JSON. Exits
non-zero, without a result line, when CUDA is unavailable or any check
fails, in any rank.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) op/s
#: and dense bf16 tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
#: Instruction rates behind the fp32 peak (132 SMs x 128 FMA a clock x 2 flops
#: x 1.98 GHz): the CUDA C++ Programming Guide's throughput table for
#: compute capability 9.0 gives 128 results a clock an SM for fp32 add /
#: multiply / FMA and 64 for compare / minimum / maximum, so a min or a max
#: costs two fp32 flops' time and an add one.
PEAK_FADD_PER_S = PEAK_FP32_PER_S / 2
PEAK_MINMAX_PER_S = PEAK_FP32_PER_S / 4

MAIN_D = 106_496          # the MLP's packed width (4 leaves padded to 2048)
PAPER_D = 16_777_216      # 1.68 GB at W = 25: above launch latency
ROUNDS = 120
SYNC_RANKS = 4            # ranks of the sharded sync, all on cuda:0
RANK_D = MAIN_D // SYNC_RANKS
SYNC_REPS = 20
WIDE_W = (65, 128)        # workers above the 64 the register arrays hold
#: phase 4's (W, d, (reps, batch)): a rank's slice of the sync, the
#: one-device path, the paper's n = 25 and 53, and the wide rows
NORM_SHAPES = [(5, RANK_D, (20, 50)), (10, MAIN_D, (20, 50)), (25, PAPER_D, (10, 1)),
               (53, PAPER_D, (5, 1))] + [(W, MAIN_D, (20, 20)) for W in WIDE_W]
#: selection rows (W, d, n_trim values, (reps, batch)): the path (5 buckets of
#: the W = 10 cohort), a rank's slice of the 4-rank sync, the paper's n = 25
#: and n = 53 in buckets (13 / 27 rows), and the wide rows trimming W // 4;
#: the path's own shape first
SELECTION_SHAPES = [(5, MAIN_D, (1, 2), (20, 50)), (5, RANK_D, (1,), (20, 50)),
                    (13, PAPER_D, (5,), (10, 1)), (27, PAPER_D, (5,), (10, 1))] + [
    (W, MAIN_D, (W // 4,), (20, 10)) for W in WIDE_W]
#: phase 3's rule/attack pairs and their accuracy thresholds
SLICE_RUNS = [("rfa", "bitflip", 0.7), ("acclip", "ipm", 0.7), ("cm", "bitflip", None),
              ("tm", "alie", None)]
#: phase 9: the paper's experiment loop at benchmarks/common.py's scale,
#: (label, f, lr, ByzConfig fields) with n = 25 workers, batch 32, 300 steps;
#: scripts/paper_loop_reference.py runs the same list through the JAX
#: reference on the CPU
PAPER_N, PAPER_STEPS = 25, 300
PAPER_RUNS = [
    ("mean/none", 0, 0.1, dict(aggregator="mean", attack="none")),
    ("krum/none vanilla", 0, 0.1, dict(aggregator="krum", mixing="none", attack="none")),
    ("krum/none s=2", 0, 0.1, dict(aggregator="krum", mixing="bucketing", s=2,
                                   attack="none")),
    ("cm+mimic vanilla", 5, 0.1, dict(aggregator="cm", mixing="none", attack="mimic")),
    ("cm+mimic s=2", 5, 0.1, dict(aggregator="cm", mixing="bucketing", s=2, attack="mimic")),
    ("rfa+bitflip s=2", 5, 0.1, dict(aggregator="rfa", mixing="bucketing", s=2,
                                     attack="bitflip")),
    ("cclip+ipm s=2", 5, 0.5, dict(aggregator="cclip", mixing="bucketing", s=2,
                                   worker_momentum=0.9, attack="ipm",
                                   attack_kwargs=(("eps", 0.1),))),
]
#: the JAX reference's test accuracy for each run, on the CPU with the same
#: n, f, steps and seeds (scripts/paper_loop_reference.py); printed beside
#: the card's, the gates are tests/test_sim.py's (``paper_gates``)
PAPER_REFERENCE = {"mean/none": 1.0, "krum/none vanilla": 0.2, "krum/none s=2": 0.806,
                   "cm+mimic vanilla": 0.938, "cm+mimic s=2": 0.989,
                   "rfa+bitflip s=2": 0.994, "cclip+ipm s=2": 1.0}
#: phase 10(c): the sync rules run again with telemetry on, in each rank
SYNC_TELEMETRY = {"rfa": "rfa_resid_norms", "cclip": "cclip_lam"}
ATTN_S = 4096             # the attention and serving phases' sequence length
#: phase 11: TinyLlama-1.1B trained at full width by TRAIN_W workers, one
#: TRAIN_S-token sequence each; (rule, steps) in order, the state carried on
TRAIN_W, TRAIN_S, TRAIN_LR = 4, 1024, 1e-2
TRAIN_RUNS = [("rfa", 3), ("cm", 1)]
#: phase 13(b)'s steps on Mamba2 (15(h) steps it again)
SSM_TRAIN_RUNS = [("rfa", 1), ("cm", 1)]
#: phase 15(a)'s steps: a gemma-7b fsdp step takes 10-21 s over gloo, and
#: the plain-route checks read the first step of each rule; CM's step
#: carries RFA's parameters and server momentum (gemma's mode)
FSDP_RUNS = [("rfa", 1), ("cm", 1)]
#: phase 15(e): one step of each rule of (a)'s gemma-7b on (data=1,
#: model=4), computing along the model axis (CM along a model axis is
#: 15(h)'s); its loss against the same step on one device (absolute), its
#: aggregate against the one device's relative to the largest worker row
#: norm (the port's bf16 gradient bar)
TP_RUNS = ("rfa",)
TP_LOSS_TOL, TP_AGG_RTOL = 1e-2, 2e-2
TRAIN_M = 2               # buckets of W = 4 at s = 2: CM's selection rows
#: exact launches of one one-device train step (the Gram route folds the
#: mixing into the combine weights; CM mixes, then selects)
TRAIN_ROUTE = {"rfa": {"pairwise_gram": 1, "bucket_mix": 1},
               "cm": {"bucket_mix": 1, "cwise_median": 1}}
#: the kernel aggregate against the plain route's, on the same worker
#: momenta, relative to the largest row norm; the Gram against an fp64
#: Gram relative to sqrt(G_ii G_jj). At n_pad = 1.1e9 the kernel's fold of
#: ~537,000 unit partials in column order (the reference's order) is off by
#: 2.4e-4, torch.matmul by 2.3e-3 (NVIDIA H100 80GB HBM3, 700 W)
TRAIN_AGG_RTOL, TRAIN_GRAM_RTOL = 1e-4, 1e-3
#: phase 11(d): gemma-7b at its published width with the depth cut to
#: REMAT_LAYERS of 28 (786,432,000 embed + 276,830,208 a layer + 3,072 final
#: norm), TRAIN_W workers of one REMAT_S-token sequence each (train_4k's
#: length): one RFA step with its config's remat="full", one with "none"
REMAT_ARCH, REMAT_LAYERS, REMAT_PARAMS, REMAT_S = "gemma-7b", 2, 1_340_095_488, 4096
REMAT_TURNS = ("none", "full", "full", "none")
#: phase 11(b)/(c): tests/test_system.py's run at smoke width (30 steps, lr
#: 0.3, global batch 8 x 64 tokens), and the group's steps (11(c), 15(b)):
#: two, so the second carries the first's state
SMOKE_STEPS, SMOKE_LR, GROUP_STEPS = 30, 0.3, 2
#: phase 12: OLMoE-1B-7B served at its published width and depth, and
#: trained at its width with the depth cut to MOE_TRAIN_LAYERS, which puts
#: d near phase 11's TinyLlama (1.1e9); Kimi K2 at smoke width only
MOE_ARCH, MOE_PARAMS = "olmoe-1b-7b", 6_919_096_320
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS = 2, 1_045_178_368
#: phase 13: Mamba2-130m served and trained at its published width and
#: depth (the tree holds 128,983,488 parameters; the reference's
#: param_count formula, copied as it is, counts 128,958,336), and Jamba
#: v0.1 served at its width over one period: 8 of 32 layers (the 52 B
#: parameters, 103 GB in bf16, fit on no 80 GB card)
SSM_ARCH, SSM_PARAMS, SSM_FORMULA = "mamba2-130m", 128_983_488, 128_958_336
HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 8
HYBRID_PARAMS, HYBRID_FORMULA = 13_267_656_416, 13_267_597_952
#: phase 14: InternVL2-2B (256 prefix embeddings before 3,840 tokens) and
#: MusicGen-medium (64 before 4 codebooks x 4,032 tokens), ATTN_S positions
#: each, at their published width and depth; Qwen1.5-32B at smoke width
VLM_ARCH, AUDIO_ARCH, DENSE_ARCH = "internvl2-2b", "musicgen-medium", "qwen1.5-32b"
DECODE_STEPS = 20
#: decode steps under the profiler: processing its trace costs ~1.5 s a step
PROFILED_DECODE_STEPS = 2
#: phase 15: gemma-7b trained over a (data=4, model=1) mesh of gloo ranks
#: on the card at its published width, the depth cut to FSDP_LAYERS of 28
#: (786,432,000 embed + 276,830,208 a layer + 3,072 final norm); the
#: smoke-width step on the (4, 1) and (2, 2) meshes; TinyLlama served on
#: the (4, 1) mesh: MESH_DECODE_CACHE positions for the batch-sharded loop
#: of MESH_DECODE_STEPS greedy tokens,
#: ATTN_S for the one sequence-sharded step, then a SEQ_PROMPT-token prompt
#: in a SEQ_CACHE-position cache decoded for SEQ_NEW tokens (4 positions a
#: rank, the prompt across three ranks' blocks and the decode into the
#: fourth: the loop steps every position through 22 layers over gloo, ~0.3
#: s in bf16 and ~0.5 s in fp32 a position on the H100, and the script's
#: time limit wants the seconds for phase 15(g))
FSDP_ARCH, FSDP_LAYERS, FSDP_PARAMS = "gemma-7b", 1, 1_063_265_280
MESH_SHAPES = [(4, 1), (2, 2)]
MESH_DECODE_PROMPT, MESH_DECODE_CACHE, MESH_DECODE_STEPS = 16, 64, 8
SEQ_PROMPT, SEQ_CACHE, SEQ_NEW = 12, 16, 4
#: phase 15(c)'s bar for a row's prefill alone against the B = 4 prefill,
#: relative to the largest |logit|; and for the sequence-sharded bf16 step,
#: its max |logit - fp32 one device| against the one-device bf16 step's
PREFILL_MESH_TOL, SEQ_BF16_RATIO = 2e-2, 1.5
#: phase 15(f): gemma-7b served at its published width on (data=1, model=4)
#: and (2, 2), each rank on its compute blocks; the holds at REMAT_LAYERS of
#: 28 layers: a prefill of TPS_PREFILL (rows, tokens), a greedy decode of 4
#: slots (``prompt`` + ``new`` tokens, MESH_DECODE_CACHE positions) and one
#: step on a seeded cache (4 rows of MESH_DECODE_CACHE positions, and 1 row
#: of ATTN_S); one bf16 run at TPS_FULL_LAYERS, the full depth, with
#: TPS_FULL_NEW greedy tokens after the prompt (a gemma-7b token takes ~1 s
#: over gloo at full depth, and the script's time limit wants the seconds
#: for phases 15(g) and (h))
TPS_PREFILL, TPS_FULL_LAYERS, TPS_FULL_NEW = (2, 1024), 28, 4
#: phase 15(f)'s serving runs and 15(g)'s and (h)'s: the arch, the depth of
#: the holds against one device, the full depth of the one timed bf16 run
#: (0: none), whether the one-row ATTN_S steps run, whether (2, 2)'s 4-row
#: seeded step runs, the greedy decode's prompt tokens and new tokens (a
#: mesh token takes 0.1-0.5 s over gloo), the fp32 logits' bar against one
#: device, and the dtypes the holds run in
TPS_GEMMA = dict(label="tps", arch=FSDP_ARCH, layers=REMAT_LAYERS, full=TPS_FULL_LAYERS,
                 one_row=True, pooled=False, rows=True, prompt=8, new=8, tol=TP_LOSS_TOL,
                 dtypes=("float32", "bfloat16"))
#: ``pooled``: beside the bf16 hold on each output, one on the mean over
#: every held logit row (each prompt position of the greedy decode, the
#: prefill's and the 4-row step's rows) of max |x - fp32 one device|. A
#: top-8 near-tie among 64 experts routes otherwise than fp32 in either
#: bf16 run (the H100, 2 layers: 5 and 2 of the prompt's 1,024 decode
#: assignments), and a row whose own token routed otherwise sits far off
#: fp32 (the prefill's 1.33 in both), so an output's max says whether a
#: near-tie flipped, the mean over rows how far each run's rounding is
TPS_MOE = dict(label="moe serve", arch=MOE_ARCH, layers=MOE_TRAIN_LAYERS, full=8,
               one_row=False, pooled=True, rows=True, prompt=8, new=8, tol=TP_LOSS_TOL,
               dtypes=("float32", "bfloat16"))
#: phase 15(e)'s compute blocks: the dim each leaf splits on (path suffix ->
#: dim; every other leaf whole); 15(g)'s OLMoE adds its lm_head and its
#: experts on the expert dim of [P, E, D, F] / [P, E, F, D], the router whole
TP_GEMMA_DIMS = {"embed": 0, "mixer/wq": 2, "mixer/wk": 2, "mixer/wv": 2, "mixer/wo": 1,
                 "ff/w_gate": 2, "ff/w_up": 2, "ff/w_down": 1}
TP_MOE_DIMS = {"embed": 0, "lm_head": 1, "mixer/wq": 2, "mixer/wk": 2, "mixer/wv": 2,
               "mixer/wo": 1, "ff/w_gate": 1, "ff/w_up": 1, "ff/w_down": 1}
#: phase 15(g): one RFA step of OLMoE (its worker momentum) on the model
#: axis, held against one device in fp32 at MOE_TP_LAYERS. In bf16 a router
#: near-tie that routes otherwise moves a token's whole expert gradient, and
#: the bf16 prefill on the mesh routes some assignments otherwise than one
#: device (60 of 32,768 on the H100), so the same step in bf16 (OLMoE's own
#: dtype) is held to what it can meet: the same bits on every rank, a finite
#: loss, its launches and peak; its gap to one device is printed. In fp32 no
#: assignment is routed otherwise (0 of 32,768). One layer (625,612,800
#: parameters) in both: four ranks share the card, the 1-layer fp32 step
#: peaks at 11.5 GB a rank (rows, ingress buffers, the replicated egress
#: row), the 2-layer bf16 step at 18.45 GB, and four of those with the
#: script's own process did not fit the 80 GB card
MOE_TP_RUNS, MOE_TP_LAYERS, MOE_TP_DTYPE = ("rfa",), 1, "float32"
#: phase 15(h): Mamba2-130m at its published width and depth, fp32, on
#: (data=1, model=4), 6 of 24 SSM heads a rank: one step of each rule, the
#: loss within SSM_TP_LOSS_TOL of one device's (absolute: 1e-4 of a seeded
#: start's loss near 11.0, ln 50,280 = 10.8), the aggregate within
#: SSM_TP_AGG_RTOL of the largest worker row norm
SSM_TP_RUNS = ("rfa", "cm")
SSM_TP_LOSS_TOL, SSM_TP_AGG_RTOL = 1e-3, 1e-3
#: each model-axis training check's bars (``tp_check``'s key): the loss's
#: absolute gap to one device's, the aggregate's gap relative to the
#: largest worker row norm; None where both gaps are only printed (15(g)'s
#: bf16 step)
TP_BARS = {"tp": (TP_LOSS_TOL, TP_AGG_RTOL), "moe.tp": (TP_LOSS_TOL, TP_AGG_RTOL),
           "moe.tp16": None, "ssm.tp": (SSM_TP_LOSS_TOL, SSM_TP_AGG_RTOL)}
#: 15(h)'s compute blocks (path suffix -> split dim, or (dim, width) where
#: a segmented dim keeps whole segments): d_inner 1,536, N = 128, 24 heads
#: over 4 ranks, so in_proj's z | x | B | C | dt block is 384 + 384 + 128 +
#: 128 + 6 = 1,030 columns and the conv's x | B | C 384 + 256 = 640
#: channels; the tied embedding on its rows
TP_SSM_DIMS = {"embed": 0, "mixer/in_proj": (2, 1030), "mixer/conv_w": (1, 640),
               "mixer/conv_b": (1, 640), "mixer/A_log": 1, "mixer/D": 1, "mixer/dt_bias": 1,
               "mixer/norm_scale": 1, "mixer/out_proj": 1}
#: 15(h)'s serving: 12 of 24 layers in both dtypes on (1, 4) only, the
#: greedy decode 3 tokens after a 4-token prompt (a mesh token takes ~0.4 s
#: over gloo: 24 all-reduces), fp32 logits within ``tol`` of one device's;
#: no separate full-depth run (``full`` 0)
TPS_SSM = dict(label="ssm serve", arch=SSM_ARCH, layers=12, full=0, one_row=False,
               pooled=False, rows=False, prompt=4, new=3, tol=1e-4,
               dtypes=("float32", "bfloat16"))
#: 15(h)'s Jamba SSM layer alone: tokens of one row, and the bars on the
#: output and each gradient relative to its largest one-device magnitude
SSM_LAYER_S = 1024
SSM_LAYER_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: phase 15(i): attention whose heads the model axis does not divide, on
#: (data=1, model=HEADS_TP_RANKS): 16 gloo ranks on the card, the attention
#: in t = 8 head blocks of 2 ranks. qwen2.5-14b's attention layer alone:
#: HEADS_LAYER_B rows of HEADS_LAYER_S tokens, the bars on the output and
#: each gradient relative to its largest one-device magnitude.
#: MusicGen-medium HEADS_AUDIO_LAYERS of 48 layers deep in fp32
#: (81,796,608 parameters): one RFA step, the loss within
#: HEADS_TP_LOSS_TOL of one device's (absolute) and the aggregate within
#: HEADS_TP_AGG_RTOL of the largest worker row norm
HEADS_TP_RANKS, HEADS_BLOCKS = 16, 8
HEADS_LAYER_ARCH, HEADS_LAYER_B, HEADS_LAYER_S = "qwen2.5-14b", 2, 1024
HEADS_LAYER_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
HEADS_AUDIO_LAYERS, HEADS_TP_RUNS = 2, ("rfa",)
HEADS_TP_LOSS_TOL, HEADS_TP_AGG_RTOL = 1e-3, 1e-3
TP_BARS["heads.tp"] = (HEADS_TP_LOSS_TOL, HEADS_TP_AGG_RTOL)
#: 15(i)'s MusicGen compute blocks (path suffix -> split dim, or (dim,
#: width) for a replicated head block): 3 of 24 heads of 64 a block, 192
#: columns of wq / wk / wv and rows of wo; d_ff 6,144 / 16 and each
#: codebook's 2,048 rows of embed and columns of lm_head / 16
TP_AUDIO_DIMS = {"embed": 1, "lm_head": 2, "mixer/wq": (2, 192), "mixer/wk": (2, 192),
                 "mixer/wv": (2, 192), "mixer/wo": (1, 192), "ff/w_up": 2, "ff/w_down": 1}
#: 15(i)'s serving: HEADS_AUDIO_LAYERS deep in fp32 only on (1, 16), the
#: greedy decode 3 tokens after a 4-token prompt of 4 codebooks, fp32 logits
#: within ``tol`` of one device's
TPS_HEADS = dict(label="heads serve", arch=AUDIO_ARCH, layers=HEADS_AUDIO_LAYERS, full=0,
                 one_row=False, pooled=False, rows=False, prompt=4, new=3, tol=1e-4,
                 dtypes=("float32",))
#: exact launches of one sync over the group, per rank (the aggregators'
#: defaults: RFA T = 8, CCLIP T = 3)
SYNC_ROUTE = {
    "rfa": {"bucket_mix": 2, "residual_norms": 8},
    "cclip": {"bucket_mix": 2, "residual_norms": 1, "cclip_fused_iter": 3},
    "cm": {"bucket_mix": 1, "cwise_median": 1},
    "tm": {"bucket_mix": 1, "cwise_trimmed_mean": 1},
    "krum": {"pairwise_gram": 1, "bucket_mix": 1},
    "acclip": {"pairwise_gram": 1, "bucket_mix": 1},
}


#: phase 16: the CNN of App. Table 5. (a) two of phase 9's pairs, with their
#: learning rates, through ByzantineSim at phase 9's scale with the CNN
#: (scale 1): the two whose CNN leaves chance within 300 steps in the JAX
#: reference (scripts/paper_loop_cnn_reference.py; rfa+bitflip and
#: cm+mimic stay at 0.1 there at lr 0.1)
CNN_RUNS = [
    ("cnn cclip+ipm s=2", 5, 0.5, dict(aggregator="cclip", mixing="bucketing", s=2,
                                       worker_momentum=0.9, attack="ipm",
                                       attack_kwargs=(("eps", 0.1),))),
    ("cnn mean/none", 0, 0.1, dict(aggregator="mean", attack="none")),
]
#: the JAX reference's CNN test accuracy for each run, on the CPU with the
#: same n, f, steps and seeds (scripts/paper_loop_cnn_reference.py); the
#: card's must lie within CNN_MARGIN of it. At step 300 both reference
#: curves still rise (mean/none by 0.103, cclip+ipm by 0.012 over the last
#: 50 steps), and the port draws its own data and batches, so the bar is
#: about one such 50-step rise; a CNN that stays at chance (0.1) misses it
CNN_REFERENCE = {"cnn cclip+ipm s=2": 0.672, "cnn mean/none": 0.42}
CNN_MARGIN = 0.1
#: (b) CrossDeviceSim with the CNN on the slice's pool: scale -> d (App.
#: A.2.3's knob), the rule/attack pairs (no accuracy threshold), rounds a run
CNN_SCALES = {1: 52_114, 4: 824_362}
CNN_SLICE_RUNS = [("rfa", "bitflip", None), ("cm", "bitflip", None),
                  ("tm", "alie", None)]
CNN_ROUNDS = 60
#: phase 17: the 16-bit element types, the selection kernels' rows at the
#: path shape (the mix's 5 buckets of the W = 10 cohort), the unaligned d,
#: the dry-run's combination, the examples (script, arguments) and the
#: phase's budget in seconds
X16_DTYPES = ("bfloat16", "float16")
X16_SEL_W = 5
X16_ODD_D = 100_003
X16_DRYRUN = ("--arch", "tinyllama-1.1b", "--shape", "train_4k", "--layers", "4")
X16_EXAMPLES = [("examples/quickstart_torch.py", ()),
                ("examples/attack_defense_matrix_torch.py", ("--steps", "50")),
                ("examples/serve_decode_torch.py", ())]
X16_BUDGET_S = 90.0
X16_TIMEOUT_S = 240.0     # the most a subprocess may take before the phase fails


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` behind the seconds since this process imported the script."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def time_ms(fn, reps: int, batch: int) -> float:
    """Device time of one call: ``batch`` calls captured in one CUDA graph,
    the graph replayed ``reps`` times between CUDA events; the median
    replay over ``batch``. The graph keeps the host's per-call overhead
    (argument checks, allocation, the launch itself) out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    del graph
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_phase():
    from repro_torch.kernels import (_build, bucket_mix, cclip_combine, cclip_fused,
                                     cwise_median, flash_attention, pairwise_gram,
                                     trimmed_mean, weiszfeld_norms)

    # every library the ranks of phase 6 load is built here, before they start
    selection = {
        "cwise_median": list(dict.fromkeys(
            src for W in [w for w, _, _, _ in SELECTION_SHAPES] + [TRAIN_M]
            for src in cwise_median.sources(W))),
        "cwise_trimmed_mean": list(dict.fromkeys(
            src for W, _, trims, _ in SELECTION_SHAPES for b in trims
            for src in trimmed_mean.sources(W, b)))}
    # phase 17's 16-bit libraries: one per source and element type
    import torch

    dtypes16 = [getattr(torch, name) for name in X16_DTYPES]
    for dt in dtypes16:
        selection["cwise_median"] += [src for W in (X16_SEL_W, TRAIN_W)
                                      for src in cwise_median.sources(W, dt)]
        selection["cwise_trimmed_mean"] += [src for W in (X16_SEL_W, TRAIN_W)
                                            for src in trimmed_mean.sources(W, 1, dt)]
    x16 = [src for dt in dtypes16 for src in bucket_mix.sources(dt)
           + pairwise_gram.sources(dt) + weiszfeld_norms.sources(dt) + cclip_combine.sources(dt)]
    # cclip_fused_iter launches the residual_norms library: each source once
    sources = list(dict.fromkeys(
        bucket_mix.sources() + pairwise_gram.sources() + weiszfeld_norms.sources()
        + cclip_fused.sources() + cclip_combine.sources() + flash_attention.sources()
        + selection["cwise_median"] + selection["cwise_trimmed_mean"] + x16))
    seconds = _build.build_all(sources)
    log(f"build: {len(sources)} CUDA sources for sm_90a ready in {seconds:.1f} s "
        f"({_build.BUILD_DIR})")
    ptxas = {}
    # each instance's registers and spills: the tensor-core attention and
    # the Gram, bucket_mix, residual_norms (all three centre forms), the
    # combine and every selection instance built here (all at W <= 128).
    # A spill in any instance fails the phase.
    checked = [("flash_attention_wgmma", "DH"), ("pairwise_gram", "L"), ("bucket_mix", ""),
               ("residual_norms", ""), ("cclip", "")] + [
        (n, "") for srcs in selection.values() for n, _ in srcs] + [
        (n, "L" if n.startswith("pairwise_gram") else "") for n, _ in x16]
    for name, param in checked:
        (text,) = [t for n, t in sources if n == name]
        ptxas[name] = res = ptxas_resources(_build.build_log(name, text), param)
        for inst, r in res.items():
            log(f"build {name} {inst}: {r['registers']} registers, spill "
                f"stores {r['spill_stores']} B, spill loads {r['spill_loads']} B")
        if not res or any(r["spill_stores"] or r["spill_loads"] for r in res.values()):
            raise AssertionError(f"{name}: ptxas resources {res} (a spill, or no report)")
    for kernel, srcs in selection.items():
        ptxas[kernel] = {n: ptxas[n] for n, _ in srcs}
    return ptxas


def ptxas_resources(text: str, param: str = ""):
    """Registers and spill bytes per kernel instance from ``ptxas -v``
    output, keyed by the instance's template arguments: ``DH=64`` for a
    ``param`` of one argument, else ``name<16,1>`` (bools as 0 / 1), or
    the kernel's name where it has none."""
    import re

    out, inst = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            head = re.match(r"_Z(\d+)", mangled)
            name = mangled[head.end():head.end() + int(head.group(1))] if head else mangled
            args = re.search(r"I((?:L[a-z]\d+E)+)E", mangled)
            vals = re.findall(r"L[a-z](\d+)E", args.group(1)) if args else []
            if param and len(vals) == 1:
                inst = f"{param}={vals[0]}"
            else:
                inst = f"{name}<{','.join(vals)}>" if vals else name
            out[inst] = dict(registers=None, spill_stores=None, spill_loads=None)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and inst:
            out[inst].update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and inst:
            out[inst]["registers"] = int(regs.group(1))
    return out


def measure(results, name, label, kernel, plain, library, n_bytes, n_ops, timing, check,
            peak_ops=PEAK_FP32_PER_S, extra=None, once=False):
    """Hold ``kernel()`` against ``plain()`` with ``check``, time kernel, plain
    version and library call, and append the row (with ``extra``'s keys) to
    ``results[name]``. A kernel with several outputs returns a tuple, checked
    by a tuple of checks; the error is the largest. ``peak_ops`` is the
    card's peak for the inputs' type (fp32 on the CUDA cores unless given).
    ``once``: the plain version and the library call are timed by
    ``time_once``."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want, check = (got,), (want,), (check,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w, c in zip(got, want, check):
        c(g, w)
    del got, want, g, w
    b_ms, b_by = bound_ms(n_bytes, n_ops, peak_ops)
    slow = time_once if once else (lambda fn: time_ms(fn, *timing))
    if once and library is not None:
        library()  # its warm-up
    row = dict(shape=label, max_abs_err=err, ms=time_ms(kernel, *timing),
               plain_ms=slow(plain),
               library_ms=None if library is None else slow(library),
               bound_ms=b_ms, bound_by=b_by, bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
               ops_ms=n_ops / peak_ops * 1e3, **(extra or {}))
    results[name].append(row)
    lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    log(f"kernel {name} [{label}]: max_abs_err {err:.3g}  ms {row['ms']:.4f}  "
        f"bound_ms {b_ms:.4f} ({b_by})  plain_ms {row['plain_ms']:.4f}  library_ms {lib}")


def close(rtol, atol):
    import torch

    return lambda got, want: torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def gram_close(x):
    """The Gram's check. fp32 summation error scales with sum_k |x_ik x_jk|,
    not with the value: off-diagonal terms cancel, and at d = 16.7 M an
    entry of a few thousand carries rounding of ~1e-2 in any fp32 order. So
    the reference's rtol 1e-5 is taken against |X| |X|^T, atol 1e-3."""
    scale = x.abs() @ x.abs().T

    def check(got, want):
        excess = (got - want).abs() - (1e-3 + 1e-5 * scale)
        if bool((excess > 0).any()):
            raise AssertionError(f"pairwise_gram off by {float(excess.max())} "
                                 "beyond 1e-3 + 1e-5 |X||X|^T")
    return check


def kernel_cases(dev):
    """Inputs at the shapes the path gives each kernel."""
    import torch

    from repro_torch.core.mixing import Bucketing

    cases = []
    # (reps, batch) for time_ms: many calls per graph where a call is short
    for W, m_rows, d, timing in [(10, 5, MAIN_D, (20, 50)), (25, 13, PAPER_D, (10, 1))]:
        gen = torch.Generator(dev).manual_seed(W)
        x = torch.randn((W, d), device=dev, generator=gen)
        perm = torch.randperm(W, generator=torch.Generator().manual_seed(W))
        mix = Bucketing(2).matrix(W, perm=perm, device=dev)
        assert mix.shape == (m_rows, W)
        weights = torch.rand((1, W), device=dev, generator=gen)
        weights = weights / weights.sum()
        cases.append(dict(W=W, d=d, timing=timing, x=x, mix=mix, weights=weights))
    return cases


def kernel_phase(dev):
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.pairwise_gram import TILE_D, pairwise_gram

    results = {name: [] for name in ("bucket_mix", "pairwise_gram", "cwise_median",
                                     "cwise_trimmed_mean")}
    record = functools.partial(measure, results)

    for case in kernel_cases(dev):
        W, d = case["W"], case["d"]
        timing = case["timing"]
        x, mix, weights = case["x"], case["mix"], case["weights"]
        for what, M in (("mix", mix), ("combine", weights)):
            rows = M.shape[0]
            record("bucket_mix", f"{what} M[{rows},{W}] X[{W},{d}]",
                   lambda M=M: bucket_mix(M, x), lambda M=M: ref.bucket_mix(M, x),
                   lambda M=M: torch.matmul(M, x),
                   (W * d + rows * W + rows * d) * 4, 2 * rows * W * d, timing,
                   close(1e-5, 1e-4))
        record("pairwise_gram", f"X[{W},{d}]", lambda: pairwise_gram(x),
               lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
               (W * d + W * W) * 4, W * (W + 1) * d, timing, gram_close(x))
        exact = x.double() @ x.double().T
        errs = {k: float((g.double() - exact).abs().max()) for k, g in
                (("kernel", pairwise_gram(x)), ("plain", ref.pairwise_gram(x)))}
        results["pairwise_gram"][-1]["err_vs_fp64"] = errs
        log(f"check pairwise_gram X[{W},{d}]: max |error| against an fp64 Gram: "
            f"kernel {errs['kernel']:.4g}, plain fp32 {errs['plain']:.4g}")
        del exact

        g1, kind = gram_variant(lambda: pairwise_gram(x))
        if kind != "gram_tma":
            raise AssertionError(f"pairwise_gram X[{W},{d}] ran {kind}, not gram_tma")
        g2 = pairwise_gram(x)
        if not (torch.equal(g1, g2) and torch.equal(g1, g1.T)):
            raise AssertionError("pairwise_gram is not bitwise repeatable and symmetric")
        cuts = [0, TILE_D, 2 * TILE_D, d - TILE_D, d] if d == MAIN_D else \
            [0, 7 * TILE_D, d // 2, d]
        acc = None
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            acc = pairwise_gram(x[:, lo:hi].contiguous(), acc)
        if not torch.equal(acc, g1):
            raise AssertionError("pairwise_gram acc chain differs from one call")
        log(f"check pairwise_gram X[{W},{d}]: {kind}, bitwise repeatable, symmetric, "
            f"{len(cuts) - 1}-call acc chain == one call")
        del x
        torch.cuda.empty_cache()

    # the Gram at a rank's slice of the 4-rank sync (krum, acclip)
    x = torch.randn((10, RANK_D), device=dev, generator=torch.Generator(dev).manual_seed(4))
    record("pairwise_gram", f"X[10,{RANK_D}]", lambda: pairwise_gram(x),
           lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
           (10 * RANK_D + 100) * 4, 110 * RANK_D, (20, 50), gram_close(x))
    g1, kind = gram_variant(lambda: pairwise_gram(x))
    if kind != "gram_tma" or not (torch.equal(g1, pairwise_gram(x)) and torch.equal(g1, g1.T)):
        raise AssertionError(f"pairwise_gram X[10,{RANK_D}]: {kind}, or not bitwise "
                             "repeatable and symmetric")
    log(f"check pairwise_gram X[10,{RANK_D}]: {kind}, bitwise repeatable, symmetric")
    # an unaligned X (the per-leaf chain's leaves) takes the predicated loads
    # and gives the bits of the same values padded to TILE_D, which take TMA
    d_odd = 100_003
    x = torch.randn((10, d_odd), device=dev, generator=torch.Generator(dev).manual_seed(5))
    g_odd, kind = gram_variant(lambda: pairwise_gram(x))
    gram_close(x)(g_odd, ref.pairwise_gram(x))
    padded = torch.nn.functional.pad(x, (0, -d_odd % TILE_D)).contiguous()
    g_pad, kind_pad = gram_variant(lambda: pairwise_gram(padded))
    if (kind, kind_pad) != ("gram_ldg", "gram_tma") or not torch.equal(g_odd, g_pad):
        raise AssertionError(f"pairwise_gram X[10,{d_odd}] ran {kind} (padded: {kind_pad}); "
                             "expected gram_ldg and gram_tma with the same bits")
    log(f"check pairwise_gram X[10,{d_odd}]: gram_ldg, within tolerance, bitwise equal to "
        "the TMA call on the same columns padded to 2048")
    del x, padded
    wide_kernel_rows(dev, record)
    selection_rows(dev, record)
    return results


def plant_specials(x):
    """A copy of ``x`` [W, d] with a NaN in one row of a column, eight NaN
    columns among one warp's columns and an all-NaN one, columns of mixed
    +0 / -0 (alone and among other values), and +-inf (with a NaN in one
    column)."""
    import torch

    W, d = x.shape
    x = x.clone()
    nan, inf = float("nan"), float("inf")
    even = torch.arange(W, device=x.device) % 2 == 0
    signed_zeros = torch.where(even, -0.0, 0.0)
    x[W // 2, 7 % d] = nan
    for j in range(8):
        x[(3 * j) % W, (32 + j) % d] = nan
    x[:, 40 % d] = nan
    x[:, 64 % d] = signed_zeros
    x[: (W + 1) // 2, 65 % d] = signed_zeros[: (W + 1) // 2]
    x[0, 96 % d] = inf
    x[W - 1, 97 % d] = -inf
    x[:, 98 % d] = inf
    x[:, 99 % d] = torch.where(even, -inf, inf)
    x[:, 100 % d] = torch.where(torch.arange(W, device=x.device) % 3 == 0, -inf, inf)
    x[W - 1, 100 % d] = nan
    return x


def same_bits(got, want) -> bool:
    """Bit-for-bit equality, NaN payloads and signed zeros included."""
    import torch

    return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


def offset_copy(x, offset: int = 1):
    """``x``'s values in a buffer ``offset`` elements past a 16-byte boundary:
    rows a TMA map cannot take, so the Gram stages them by predicated loads."""
    import torch

    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    return buf[offset:].view(x.shape).copy_(x)


def selection_rows(dev, record):
    """Phase 2's CM and TM rows (``SELECTION_SHAPES``): bit for bit against
    the plain version, timed beside ``torch.median`` and a sort with the band's
    mean, bounded by ``selection_ops``; then the same values with
    ``plant_specials``' NaN, signed-zero and infinite columns, bit for bit."""
    import torch

    from repro_torch.kernels.cost import selection_ops

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cwise_median import cwise_median, threads_for
    from repro_torch.kernels.trimmed_mean import cwise_trimmed_mean

    def bitwise(got, want):
        if not same_bits(got, want):
            raise AssertionError("kernel and plain version differ bitwise")

    for W, d, trims, timing in SELECTION_SHAPES:
        x = torch.randn((W, d), device=dev, generator=torch.Generator(dev).manual_seed(W + d))
        # one column a thread, in blocks of the wrapper's size
        geometry = dict(threads=threads_for(W, d, _build.sm_count(torch.cuda.current_device())))
        record("cwise_median", f"X[{W},{d}]", lambda: cwise_median(x),
               lambda: ref.cwise_median(x), lambda: torch.median(x, dim=0).values,
               (W + 1) * d * 4, selection_ops(W, d), timing, bitwise, PEAK_MINMAX_PER_S,
               geometry)
        rows = [("cwise_median", None)]
        for b in trims:
            record("cwise_trimmed_mean", f"X[{W},{d}] b={b}",
                   lambda b=b: cwise_trimmed_mean(x, b), lambda b=b: ref.cwise_trimmed_mean(x, b),
                   lambda b=b: torch.sort(x, dim=0).values[b:W - b].mean(dim=0),
                   (W + 1) * d * 4, selection_ops(W, d, b), timing, bitwise, PEAK_MINMAX_PER_S,
                   geometry)
            rows.append(("cwise_trimmed_mean", b))
        special = plant_specials(x)
        del x
        for name, b in rows:
            got = cwise_median(special) if b is None else cwise_trimmed_mean(special, b)
            want = ref.cwise_median(special) if b is None else ref.cwise_trimmed_mean(special, b)
            bitwise(got, want)
            if not bool(torch.isnan(got[7 % d])):
                raise AssertionError(f"{name} X[{W},{d}]: a NaN column did not come out NaN")
        log(f"check selection X[{W},{d}] ({geometry['threads']} threads a block): CM and TM "
            f"b={list(trims)} bit for bit with the plain version, NaN, +-0 and +-inf "
            "columns included")
        del special, got, want
        torch.cuda.empty_cache()


def wide_kernel_rows(dev, record):
    """Phase 2's rows above 64 workers (W = 65, 128) at the one-device d:
    mix (bucketing s = 2) and combine, the Gram (one launch per pair of
    32-row groups); CM and TM there are ``selection_rows``'."""
    import torch

    from repro_torch.core.mixing import Bucketing
    from repro_torch.kernels import LAUNCHES, ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.pairwise_gram import pairwise_gram, row_groups

    d = MAIN_D
    for W in WIDE_W:
        gen = torch.Generator(dev).manual_seed(W)
        x = torch.randn((W, d), device=dev, generator=gen)
        perm = torch.randperm(W, generator=torch.Generator().manual_seed(W))
        weights = torch.rand((1, W), device=dev, generator=gen)
        for what, M in (("mix", Bucketing(2).matrix(W, perm=perm, device=dev)),
                        ("combine", weights / weights.sum())):
            rows = M.shape[0]
            record("bucket_mix", f"{what} M[{rows},{W}] X[{W},{d}]",
                   lambda M=M: bucket_mix(M, x), lambda M=M: ref.bucket_mix(M, x),
                   lambda M=M: torch.matmul(M, x),
                   (W * d + rows * W + rows * d) * 4, 2 * rows * W * d, (20, 50),
                   close(1e-5, 1e-4))
        before = LAUNCHES["pairwise_gram"]
        g = pairwise_gram(x)
        calls = LAUNCHES["pairwise_gram"] - before
        n_groups = len(row_groups(W))
        if calls != n_groups * (n_groups - 1) // 2 or not (
                torch.equal(g, g.T) and torch.equal(g, pairwise_gram(x))):
            raise AssertionError(f"pairwise_gram X[{W},{d}]: {calls} launches, or not "
                                 "symmetric and bitwise repeatable")
        record("pairwise_gram", f"X[{W},{d}] ({calls} launches)", lambda: pairwise_gram(x),
               lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
               (W * d + W * W) * 4, W * (W + 1) * d, (20, 10), gram_close(x))
        log(f"check W = {W}: the mix, the combine and the Gram agreed with their plain "
            f"versions (the Gram in {calls} launches, symmetric, bitwise repeatable)")
        del x, g
        torch.cuda.empty_cache()


def gram_variant(call):
    """``call()``'s result and the one ``pairwise_gram`` variant it ran."""
    from repro_torch.kernels import VARIANT_LAUNCHES

    before = dict(VARIANT_LAUNCHES)
    out = call()
    ran = [k for k in ("gram_tma", "gram_ldg") if VARIANT_LAUNCHES[k] > before[k]]
    if len(ran) != 1:
        raise AssertionError(f"pairwise_gram ran the variants {ran}")
    return out, ran[0]


def slice_task(dev):
    """The slice's pool: SynthMNIST (3,000 train / 500 test) split non-iid
    over 50 clients, 5 of them Byzantine, on the card."""
    import torch

    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test

    X, Y, Xt, Yt = make_train_test(torch.Generator().manual_seed(0), n_train=3000,
                                   n_test=500, device=dev)
    wx, wy = worker_datasets(X.cpu().numpy(), Y.cpu().numpy(), n_good=45, n_byz=5,
                             noniid=True)
    return torch.tensor(wx, device=dev), torch.tensor(wy, device=dev), Xt, Yt


def slice_sim(agg, attack, device, telemetry=False, loss_fn=None):
    """The slice's ``CrossDeviceSim`` (the MLP's ``nll_loss`` by default)."""
    from repro_torch.configs.base import ByzConfig
    from repro_torch.models.mlp import nll_loss
    from repro_torch.training.cross_device import CrossDeviceSim

    kwargs = (("n", 10), ("f", 2)) if attack == "alie" else ()
    byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2, attack=attack,
                    attack_kwargs=kwargs, n_byzantine=0)
    return CrossDeviceSim(loss_fn=loss_fn or nll_loss, byz=byz, n_clients=50, byz_frac=0.1,
                          clients_per_round=10, lr=1.0, batch_size=16,
                          server_momentum=0.9, telemetry=telemetry, device=device)


#: the kernels a ``CrossDeviceSim`` round launches, once each, by rule (the
#: Gram route folds the mixing into the combine weights), and no other
SLICE_ROUTE = {"rfa": ("pairwise_gram", "bucket_mix"),
               "acclip": ("pairwise_gram", "bucket_mix"),
               "cm": ("bucket_mix", "cwise_median"), "tm": ("bucket_mix", "cwise_trimmed_mean")}


def held_out_accuracy(apply_fn, params, x, y) -> float:
    """Test accuracy, in IEEE fp32 as the reference computes it (cuDNN would
    convolve in TF32)."""
    import torch

    from repro_torch import ieee_fp32

    with ieee_fp32():
        return float(torch.mean((torch.argmax(apply_fn(params, x), dim=-1) == y).float()))


def slice_phase(dev, smi: str, task=None, runs=None, loss_fn=None, init=None, apply_fn=None,
                rounds=None, prefix: str = "", check=None):
    """Phase 3 (and 16(b)): ``CrossDeviceSim`` on the slice's pool (``task``,
    ``slice_task``'s by default) under ``runs`` ((rule, attack, accuracy
    threshold or None), ``SLICE_RUNS`` by default), with ``loss_fn``,
    ``init`` and ``apply_fn`` (the MLP's by default). Each run: one round on
    the card held against the same round on the CPU (plain versions), then
    ``check(label, rule, sim_gpu, sim_cpu, params_gpu, draws_gpu, draws)``
    if given; then ``rounds`` (``ROUNDS``) rounds with the route's exact launches (under
    ``prefix + label``), finite parameters and the threshold; rounds/s, peak
    memory, profiled."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.mlp import init_mlp, mlp_apply, nll_loss

    runs = SLICE_RUNS if runs is None else runs
    rounds = rounds or ROUNDS
    loss_fn, init, apply_fn = loss_fn or nll_loss, init or init_mlp, apply_fn or mlp_apply
    wx, wy, Xt, Yt = task or slice_task(dev)
    # one round on the card against the same round on the CPU (plain versions)
    for agg, attack, _ in runs:
        label = f"{prefix}{agg}+{attack}"
        sim_gpu = slice_sim(agg, attack, dev, loss_fn=loss_fn)
        sim_cpu = slice_sim(agg, attack, "cpu", loss_fn=loss_fn)
        params = init(torch.Generator().manual_seed(1), device="cpu")
        draws = sim_cpu.draw(torch.Generator().manual_seed(5), wx.shape[1])
        p_gpu = {k: v.to(dev) for k, v in params.items()}
        d_gpu = draws._replace(mix=draws.mix.to(dev))
        s_cpu, _ = sim_cpu.step(sim_cpu.init_state(params), wx.cpu(), wy.cpu(), draws)
        s_gpu, _ = sim_gpu.step(sim_gpu.init_state(p_gpu), wx, wy, d_gpu)
        for k in params:
            torch.testing.assert_close(s_gpu.params[k].cpu(), s_cpu.params[k],
                                       rtol=1e-4, atol=1e-5)
        log(f"check {label}: one round on the card == the round on the CPU "
            "(rtol 1e-4, atol 1e-5)")
        if check is not None:
            check(label, agg, sim_gpu, sim_cpu, p_gpu, d_gpu, draws)
        del s_gpu, s_cpu

    # Each path is counted on its own: counts set to 0 just before its run,
    # read just after.
    round_us, launches = {}, {}
    for agg, attack, threshold in runs:
        label = f"{prefix}{agg}+{attack}"
        sim = slice_sim(agg, attack, dev, loss_fn=loss_fn)
        params = init(torch.Generator().manual_seed(1), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        state, _ = sim.run(params, wx, wy, rounds, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[label] = counts = dict(LAUNCHES)
        flat = torch.cat([p.reshape(-1) for p in state.params.values()])
        if not bool(torch.isfinite(flat).all()):
            raise AssertionError(f"{label}: non-finite parameters")
        acc = held_out_accuracy(apply_fn, state.params, Xt, Yt)
        round_us[(agg, attack)] = seconds / rounds * 1e6
        log(f"slice {label}: d {flat.numel()}, {rounds} rounds, test accuracy {acc:.4f}, "
            f"{rounds / seconds:.1f} rounds/s, {peak_above(live)}, "
            f"launches {json.dumps(counts)} on {smi}")
        want = {k: rounds if k in SLICE_ROUTE[agg] else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"{label}: kernel launches {counts}, expected {want}")
        if threshold is not None and not acc > threshold:
            raise AssertionError(f"{label}: accuracy {acc} <= {threshold}")
    for (agg, attack), us in round_us.items():
        profile_rounds(slice_sim(agg, attack, dev, loss_fn=loss_fn), wx, wy, dev,
                       f"{prefix}{agg}+{attack} ({smi})", us, init=init)
    return launches


def norm_kernel_phase(dev):
    """Phase 4: the residual-norm and centered-clipping kernels against their
    plain versions, timed, at ``NORM_SHAPES``. The path's own shape comes
    first in each kernel's rows."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.cclip_combine import cclip_combine
    from repro_torch.kernels.cclip_fused import cclip_fused_iter
    from repro_torch.kernels.weiszfeld_norms import residual_norms

    results = {name: [] for name in ("residual_norms", "cclip_fused_iter", "cclip_combine")}
    record = functools.partial(measure, results)
    for W, d, timing in NORM_SHAPES:
        gen = torch.Generator(dev).manual_seed(100 + W)
        x = torch.randn((W, d), device=dev, generator=gen)
        c = torch.softmax(torch.randn(W, device=dev, generator=gen), 0)
        v = x.mean(0)
        norms = torch.sqrt(ref.residual_norms(x, center=v))
        lam = torch.clamp(0.5 * norms.median() / norms, max=1.0)  # about half clipped
        beta = 1.0 - float(lam.mean())
        label = f"X[{W},{d}]"
        # sums of W d terms in another order than the plain version's: the
        # reference's tolerances (tests/test_kernels.py)
        record("residual_norms", f"coeffs {label}", lambda: residual_norms(x, c),
               lambda: ref.residual_norms(x, c), None,
               (W * d + 2 * W) * 4, 5 * W * d, timing, close(1e-4, 1e-3))
        record("residual_norms", f"center {label}", lambda: residual_norms(x, center=v),
               lambda: ref.residual_norms(x, center=v),
               lambda: torch.cdist(x, v[None, :]),
               (W * d + d + W) * 4, 3 * W * d, timing, close(1e-4, 1e-3))
        record("cclip_fused_iter", label, lambda: cclip_fused_iter(x, v, lam),
               lambda: ref.cclip_fused_iter(x, v, lam), None,
               (W * d + 2 * d + 2 * W) * 4, 6 * W * d, timing,
               (close(1e-5, 1e-4), close(1e-4, 1e-3)))
        record("cclip_combine", label, lambda: cclip_combine(x, v, lam),
               lambda: ref.cclip_combine(x, v, lam),
               lambda: torch.addmv(v, x.T, lam, beta=beta, alpha=1.0 / W),
               (W * d + 2 * d + W) * 4, 3 * W * d, timing, close(1e-5, 1e-4))
        for what, call in (("coeffs", lambda: residual_norms(x, c)),
                           ("center", lambda: residual_norms(x, center=v)),
                           ("fused", lambda: cclip_fused_iter(x, v, lam)[1])):
            if not torch.equal(call(), call()):
                raise AssertionError(f"residual norms ({what}) not bitwise repeatable")
        if not same_bits(cclip_fused_iter(x, v, lam)[0], cclip_combine(x, v, lam)):
            raise AssertionError(f"cclip_fused_iter {label}: v' differs from cclip_combine's")
        kernels = profile_kernels(lambda: cclip_fused_iter(x, v, lam), 3)
        if [launches for _, launches in kernels.values()] != [1]:
            raise AssertionError(f"cclip_fused_iter {label}: a call ran the CUDA kernels "
                                 f"{kernels}, not one")
        log(f"check residual norms {label}: coefficient, centre and fused forms "
            "bitwise repeatable; the fused v' equals cclip_combine's bit for bit; a fused "
            f"call is one CUDA kernel ({next(iter(kernels))[:60]})")
        del x, v, norms
        torch.cuda.empty_cache()
    # the combine's path is a one-device composition: its main shape first
    results["cclip_combine"].insert(0, results["cclip_combine"].pop(1))
    return results


def profile_kernels(fn, calls: int = 20):
    """Device microseconds and launches per call of each CUDA kernel ``fn``
    launches (memsets included), from the profiler's device records over
    ``calls`` calls after one call outside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / calls, e.count / calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0}


def ops_phase(dev):
    """Phase 5: the one-device compositions, counted, checked and timed."""
    import torch

    from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches

    launches = {}
    for W, d, tau, timing in [(10, MAIN_D, 500.0, (20, 10)), (25, PAPER_D, 2000.0, (5, 1))]:
        x = torch.randn((W, d), device=dev, generator=torch.Generator(dev).manual_seed(W)) * 3
        compositions = [
            ("rfa_aggregate", lambda: ops.rfa_aggregate(x), lambda: ref.rfa_aggregate(x),
             {"residual_norms": 8, "bucket_mix": 1}),
            ("cclip_aggregate", lambda: ops.cclip_aggregate(x, tau),
             lambda: ref.cclip_aggregate(x, tau),
             {"bucket_mix": 1, "residual_norms": 1, "cclip_fused_iter": 3}),
            ("cclip_aggregate_unfused", lambda: ops.cclip_aggregate_unfused(x, tau),
             lambda: ref.cclip_aggregate(x, tau),
             {"bucket_mix": 1, "residual_norms": 3, "cclip_combine": 3}),
        ]
        for name, compose, oracle, route in compositions:
            label = f"ops.{name} X[{W},{d}]"
            torch.cuda.synchronize()
            reset_launches()
            got = compose()
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            want = {k: route.get(k, 0) for k in counts}
            if counts != want:
                raise AssertionError(f"{label}: kernel launches {counts}, expected {want}")
            expect = oracle()
            err = float((got - expect).abs().max())
            torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)
            if d == MAIN_D:
                launches[f"ops.{name}"] = counts
            log(f"ops {label}: launches {json.dumps(route)}, max_abs_err vs oracle {err:.3g}, "
                f"{time_ms(compose, *timing):.4f} ms per call")
        del x
        torch.cuda.empty_cache()
    return launches


def mlp_worker_grads(device):
    """Per-worker gradients of the 784-128-10 MLP (W = 10 workers, leaves
    [10, ...]), workers 8 and 9 sending them sign-flipped: the same on every
    rank (made on the CPU from fixed seeds), then moved to ``device``."""
    import torch
    from torch.func import grad, vmap

    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test
    from repro_torch.models.mlp import init_mlp, nll_loss

    X, Y, _, _ = make_train_test(torch.Generator().manual_seed(0), n_train=3000, n_test=10,
                                 device="cpu")
    wx, wy = worker_datasets(X.numpy(), Y.numpy(), n_good=8, n_byz=2, noniid=True)
    wx, wy = torch.tensor(wx), torch.tensor(wy)
    idx = torch.randint(0, wx.shape[1], (10, 16), generator=torch.Generator().manual_seed(2))
    rows = torch.arange(10)[:, None]
    params = init_mlp(torch.Generator().manual_seed(1), device="cpu")
    grads = vmap(grad(nll_loss), in_dims=(None, 0, 0))(params, wx[rows, idx], wy[rows, idx])
    return {k: torch.cat([g[:8], -g[8:]]).contiguous().to(device) for k, g in grads.items()}


def sync_rank(rank, group, device):
    """Phase 6, in each rank: every rule's sync over the group, with its
    launch counts, its check against the one-device engine and its time."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.robust_sync import robust_gradient_sync
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.telemetry import get_metric

    tree = mlp_worker_grads(device)
    out = {}
    for rule, route in SYNC_ROUTE.items():
        ra = ByzConfig(aggregator=rule, mixing="bucketing", s=2,
                       n_byzantine=2).make_aggregator(10)
        mix = ra.mixing_matrix(10, torch.Generator().manual_seed(7), device=device)

        def sync(mesh):
            return robust_gradient_sync(tree, ra, mix=mix, mesh=mesh)[0]

        torch.cuda.synchronize()
        dist.barrier(group)
        reset_launches()
        got = sync(group)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        want = {k: route.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"rank {rank} {rule}: launches {counts}, expected {want}")
        single = sync(None)
        err = max(float((got[k] - single[k]).abs().max()) for k in got)
        for k in got:
            if rule in ("cm", "tm"):
                if not torch.equal(got[k], single[k]):
                    raise AssertionError(f"rank {rank} {rule}: {k} differs from the "
                                         "one-device engine")
            else:
                torch.testing.assert_close(got[k], single[k], rtol=5e-4, atol=5e-4)
        if not all(bool(torch.isfinite(t).all()) for t in got.values()):
            raise AssertionError(f"rank {rank} {rule}: non-finite result")
        ms = {}
        for label, mesh in (("group", group), ("one_device", None)):
            dist.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SYNC_REPS):
                sync(mesh)
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) / SYNC_REPS * 1e3
        out[rule] = dict(result=got, counts=counts, max_abs_err=err, ms=ms)
        if rule in SYNC_TELEMETRY:
            # phase 10(c): telemetry on over the group launches what off did,
            # keeps off's bits, and reads the kernels' own outputs
            torch.cuda.synchronize()
            dist.barrier(group)
            reset_launches()
            on, info = robust_gradient_sync(tree, ra, mix=mix, mesh=group, telemetry=True)
            torch.cuda.synchronize()
            tele_counts = dict(LAUNCHES)
            if tele_counts != counts:
                raise AssertionError(f"rank {rank} {rule} telemetry on: launches "
                                     f"{tele_counts}, off {counts}")
            if not all(torch.equal(on[k], got[k]) for k in got):
                raise AssertionError(f"rank {rank} {rule}: telemetry on changed the result")
            tele = info["telemetry"]
            for name, v in tele.items():
                get_metric(name)
                if not bool(torch.isfinite(torch.as_tensor(v, dtype=torch.float32)).all()):
                    raise AssertionError(f"rank {rank} {rule}: {name} not finite")
            name = SYNC_TELEMETRY[rule]
            single = robust_gradient_sync(tree, ra, mix=mix, mesh=None,
                                          telemetry=True)[1]["telemetry"][name]
            torch.testing.assert_close(tele[name], single, rtol=1e-4, atol=1e-4)
            out[rule].update(telemetry=tele, telemetry_counts=tele_counts,
                             telemetry_err=float((tele[name] - single).abs().max()))
    return out


def sync_phase():
    """Phase 6: SYNC_RANKS ranks on cuda:0 under gloo, results compared
    across ranks."""
    import numpy as np

    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(sync_rank, SYNC_RANKS, backend="gloo",
                        devices=["cuda:0"] * SYNC_RANKS, timeout_s=600)
    log(f"sync: {SYNC_RANKS} ranks on cuda:0 under gloo ran in "
        f"{time.perf_counter() - t0:.1f} s, spawn included")
    launches = {}
    for rule in SYNC_ROUTE:
        first = ranks[0][rule]["result"]
        for rank, r in enumerate(ranks):
            for k, v in r[rule]["result"].items():
                if not np.array_equal(v, first[k]):
                    raise AssertionError(f"sync {rule}: rank {rank} differs from rank 0 in {k}")
        counts = [r[rule]["counts"] for r in ranks]
        launches[f"sync.{rule}"] = {k: sum(c[k] for c in counts) for k in counts[0]}
        if rule in SYNC_TELEMETRY:
            first_t = ranks[0][rule]["telemetry"]
            for rank, r in enumerate(ranks):
                tele = r[rule]["telemetry"]
                if sorted(tele) != sorted(first_t) or not all(
                        np.array_equal(np.asarray(v), np.asarray(first_t[k]))
                        for k, v in tele.items()):
                    raise AssertionError(f"sync {rule} telemetry: rank {rank} differs from rank 0")
            tcounts = [r[rule]["telemetry_counts"] for r in ranks]
            launches[f"telemetry.sync.{rule}"] = {k: sum(c[k] for c in tcounts)
                                                  for k in tcounts[0]}
            log(f"check sync {rule} telemetry on ({len(first_t)} metrics): launches and result "
                "bits as off in every rank; the metrics equal bit for bit on every rank; "
                f"{SYNC_TELEMETRY[rule]} within 1e-4 of the one-device engine's, max |diff| "
                f"{max(r[rule]['telemetry_err'] for r in ranks):.3g}")
        log(f"sync {rule}: every rank bitwise equal; launches per rank "
            f"{json.dumps(SYNC_ROUTE[rule])}; max |group - one device| "
            f"{max(r[rule]['max_abs_err'] for r in ranks):.3g}; host ms per sync, "
            f"{SYNC_RANKS} ranks sharing one card under gloo: "
            + ", ".join(f"{r[rule]['ms']['group']:.3f}" for r in ranks)
            + "; one-device engine in the same ranks: "
            + ", ".join(f"{r[rule]['ms']['one_device']:.3f}" for r in ranks))
    return launches


def attention_fp64(q, k, v, window: int = 0, q_offset=None):
    """``ref.attention`` in fp64: the yardstick of both bf16 versions' error."""
    from repro_torch.kernels import ref

    return ref.attention(q.double(), k.double(), v.double(), window=window, q_offset=q_offset)


def attention_row(results, label, q, k, v, window=0, q_offset=-1, timing=(5, 2),
                  blocks=(128, 128)):
    """One ``flash_attention`` case: kernel against the plain version, timed
    and bounded; for bf16 inputs the fp64 error of both is printed. ``blocks``
    are the caller's (block_q, block_kv), which must divide Sq and Skv."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import VARIANT_LAUNCHES, ref
    from repro_torch.kernels.cost import visible_pairs
    from repro_torch.kernels.flash_attention import flash_attention

    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    off = Skv - Sq if q_offset == -1 else q_offset
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if Sq == Skv and window == 0:  # SDPA's is_causal aligns top-left: only then the same
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    else:  # the same function through an explicit boolean mask (True: attend)
        qpos = off + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = (kpos <= qpos) & ((kpos > qpos - window) if window > 0 else True)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    bf16 = q.dtype == torch.bfloat16
    before = dict(VARIANT_LAUNCHES)
    # fp32 at the reference's 2e-4; bf16: both do fp32 math and round the
    # output to bf16 once, so torch's bf16 tolerance (rtol 1.6e-2, atol 1e-5)
    check = close(1.6e-2, 1e-5) if bf16 else close(2e-4, 2e-4)
    n_bytes = (2 * B * Sq * H * dh + 2 * B * Skv * KV * dh) * q.element_size()
    n_ops = 4 * B * H * dh * visible_pairs(Sq, Skv, window, off)
    measure(results, "flash_attention", label,
            lambda: flash_attention(q, k, v, window=window, q_offset=q_offset,
                                    block_q=blocks[0], block_kv=blocks[1]),
            lambda: ref.attention(q, k, v, window=window, q_offset=off), library,
            n_bytes, n_ops, timing, check, PEAK_BF16_PER_S if bf16 else PEAK_FP32_PER_S)
    ran = [kind for kind, n in VARIANT_LAUNCHES.items() if n > before[kind]]
    want = "wgmma" if bf16 else "simt"
    results["flash_attention"][-1]["variant"] = "+".join(ran)
    log(f"variant flash_attention [{label}]: {'+'.join(ran)}")
    if ran != [want]:
        raise AssertionError(f"flash_attention [{label}]: ran {ran}, expected {want}")
    if bf16:
        exact = attention_fp64(q, k, v, window, off)
        errs = {name: float((got.double() - exact).abs().max()) for name, got in
                (("kernel", flash_attention(q, k, v, window=window, q_offset=q_offset,
                                            block_q=blocks[0], block_kv=blocks[1])),
                 ("plain", ref.attention(q, k, v, window=window, q_offset=off)))}
        results["flash_attention"][-1]["err_vs_fp64"] = errs
        log(f"check flash_attention [{label}]: max |error| against fp64 attention: "
            f"kernel {errs['kernel']:.4g}, plain {errs['plain']:.4g}")
        del exact
        # the CUDA-core kernel (the only one before the tensor-core redesign)
        # on the same inputs, called past the dispatch: not a launch of the path
        simt = simt_attention(q, k, v, window, off)
        check(simt(), ref.attention(q, k, v, window=window, q_offset=off))
        row = results["flash_attention"][-1]
        row["simt_ms"] = time_ms(simt, *timing)
        log(f"kernel flash_attention [{label}]: CUDA-core kernel on the same bf16 inputs "
            f"{row['simt_ms']:.4f} ms, {row['simt_ms'] / row['ms']:.1f}x the wgmma kernel")
    torch.cuda.empty_cache()


def simt_attention(q, k, v, window: int, off: int):
    """A call of ``csrc/flash_attention.cu`` on bf16 inputs that the
    wrapper would send to the tensor-core kernel."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)

    def call():
        code = fa._lib("simt").flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KV, dh,
            1, window, off, dh ** -0.5, 1, _build.stream_of(q))
        _build.check_launch("flash_attention (simt)", code)
        return out
    return call


def attention_phase(dev):
    """Phase 7: ``flash_attention`` against its plain version at the reference
    test's cases (fp32) and the ported configs' attention shapes (bf16)."""
    import torch

    from repro_torch.configs import get_config

    results = {"flash_attention": []}
    gen = torch.Generator(dev).manual_seed(7)

    def qkv(B, Sq, Skv, H, KV, dh, dtype):
        return (torch.randn((B, Sq, H, dh), device=dev, generator=gen).to(dtype),
                torch.randn((B, Skv, KV, dh), device=dev, generator=gen).to(dtype),
                torch.randn((B, Skv, KV, dh), device=dev, generator=gen).to(dtype))

    # tests/test_kernels.py's cases: B = 2, dh = 32, fp32
    for Sq, Skv, H, KV, window in [(64, 64, 4, 4, 0), (64, 64, 8, 2, 0), (64, 64, 4, 2, 24),
                                   (32, 128, 4, 4, 0)]:
        attention_row(results, f"fp32 B2 Sq{Sq} Skv{Skv} H{H} KV{KV} dh32 w{window}",
                      *qkv(2, Sq, Skv, H, KV, 32, torch.float32), window=window,
                      timing=(20, 50), blocks=(16, 32))
    S = ATTN_S
    cases = [(name, get_config(name)) for name in ("tinyllama-1.1b", "qwen2.5-14b", "gemma-7b")]
    for name, cfg in cases:
        H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        attention_row(results, f"bf16 {name} B1 S{S} H{H} KV{KV} dh{dh}",
                      *qkv(1, S, S, H, KV, dh, torch.bfloat16))
    tiny = cases[0][1]
    H, KV, dh = tiny.n_heads, tiny.n_kv_heads, tiny.head_dim_
    attention_row(results, f"bf16 tinyllama-1.1b chunked B1 Sq512 Skv{S}",
                  *qkv(1, 512, S, H, KV, dh, torch.bfloat16))
    attention_row(results, f"bf16 tinyllama-1.1b B1 S{S} window 1024",
                  *qkv(1, S, S, H, KV, dh, torch.bfloat16), window=1024)
    return results


def run_counted(launches, label, fn):
    """``fn()`` with every launch count set to 0 just before it and read
    just after, into ``launches[label]``."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches[label] = dict(LAUNCHES)
    return out


def greedy_decode(cfg, params, prompt, max_new, batch, dev):
    """Sequential greedy decode of one request over ``decode_step`` (the
    loop of tests/test_serving.py::reference_decode), the request in row 0
    of a ``batch``-row step whose other rows feed token 0."""
    import torch

    from repro_torch.models import transformer as tfm

    cache = tfm.init_cache(cfg, batch, 256, device=dev)
    out = []
    for t in range(len(prompt) + max_new - 1):
        feed = torch.zeros(batch, dtype=torch.long, device=dev)
        feed[0] = prompt[t] if t < len(prompt) else out[-1]
        logits, cache = tfm.decode_step(params, cfg, cache, feed, t)
        if t >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0])))
    return out[:max_new]


def serve_phase(dev, results):
    """Phase 8: TinyLlama-1.1B at full width through the serving path; adds
    the kernel's row on the model's own q/k/v at the front of ``results``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rmsnorm
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.telemetry import EventLog, validate_jsonl
    from repro_torch.utils.tree import tree_flatten, tree_map

    cfg = get_config("tinyllama-1.1b")
    V, S = cfg.vocab_size, ATTN_S
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    log(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, {cfg.dtype}): {n_params:,} parameters on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    counted = functools.partial(run_counted, launches)

    # (a) the serving prefill, B = 2, S = 4096 (auto -> blockwise attention)
    tokens = torch.randint(0, V, (2, S), device=dev, generator=torch.Generator(dev).manual_seed(1))
    prefill = make_prefill_step(cfg, device=dev)
    logits = counted("serve.prefill", lambda: prefill(params, {"tokens": tokens}))
    if tuple(logits.shape) != (2, 1, V) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"serve prefill B2 S{S}: logits [2, 1, {V}] finite; host ms per prefill "
        f"{', '.join(f'{t:.1f}' for t in times)} (median {statistics.median(times):.1f}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # (b) the kernel on layer 0's own q/k/v
    lp = tree_map(lambda t: t[0], params["blocks"])["0"]
    x = tfm.embed_tokens(params, cfg, tokens)
    q, k, v = attn._project_qkv(lp["mixer"], rmsnorm(lp["norm1"], x, cfg.norm_eps), cfg,
                                torch.arange(S, device=dev)[None, :])
    got = counted("serve.layer0_attention", lambda: flash_attention(q, k, v))
    want = {name: int(name == "flash_attention") for name in LAUNCHES}
    attn_variants = {k: VARIANT_LAUNCHES[k] for k in ("wgmma", "simt")}
    if launches["serve.layer0_attention"] != want or attn_variants != {"wgmma": 1, "simt": 0}:
        raise AssertionError(f"layer 0 attention: launches "
                             f"{launches['serve.layer0_attention']}, expected {want}; "
                             f"variants {VARIANT_LAUNCHES}, expected one wgmma")
    scale = cfg.head_dim_ ** -0.5
    exact = attention_fp64(q, k, v)
    others = {"plain": ref.attention(q, k, v),
              "blockwise": attn._attn_blockwise(q, k, v, scale, True, 0, cfg.attn_block_q,
                                                cfg.attn_block_kv),
              "xla": attn._attn_xla(q, k, v, scale, True, 0)}
    errs = {name: float((t.double() - exact).abs().max())
            for name, t in [("kernel", got)] + list(others.items())}
    diffs = {name: float((got.float() - t.float()).abs().max()) for name, t in others.items()}
    log(f"check flash_attention on layer 0's q/k/v {tuple(q.shape)} {q.dtype}: max |error| "
        f"against fp64 attention: " + ", ".join(f"{n} {e:.4g}" for n, e in errs.items())
        + "; max |kernel - other|: " + ", ".join(f"{n} {d:.4g}" for n, d in diffs.items()))
    # the model's impls round the logits (xla the probabilities too) to bf16
    # before the softmax, so they stand further from the exact value than
    # the kernel and the plain version, which keep them in fp32: 2^-5
    for name in ("blockwise", "xla"):
        torch.testing.assert_close(got, others[name], rtol=2**-5, atol=2**-5)
    if errs["kernel"] > errs["blockwise"]:
        raise AssertionError(f"layer 0 attention: kernel error {errs['kernel']} above "
                             f"blockwise's {errs['blockwise']}")
    del exact, others
    torch.cuda.empty_cache()
    rows = {"flash_attention": []}
    attention_row(rows, f"serve layer 0 q/k/v bf16 B2 S{S} H{cfg.n_heads} KV{cfg.n_kv_heads} "
                  f"dh{cfg.head_dim_}", q, k, v,
                  timing=(3, 1))
    results["flash_attention"].insert(0, rows["flash_attention"][0])
    del q, k, v, x, got
    torch.cuda.empty_cache()

    # (c) continuous batching: 4 slots, 6 requests
    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 97, (6,), generator=rng).tolist()
    prompts = [torch.randint(0, V, (n,), generator=rng).tolist() for n in lens]
    # phase 10(d): the engine writes one serve event a step to a log on disk
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log_path = os.path.join(tmp, "serve.jsonl")
        with EventLog(log_path, run_id="chip_smoke") as event_log:
            eng = ServeEngine(cfg, params, batch_slots=4, max_len=256, event_log=event_log,
                              device=dev)
            for uid, prompt in enumerate(prompts):
                eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=16))
            t0 = time.perf_counter()
            done = counted("serve.engine", eng.run_until_drained)
            wall = time.perf_counter() - t0
        events = validate_jsonl(log_path)
    if sorted(done) != list(range(6)) or any(len(r.output) != 16 for r in done.values()):
        raise AssertionError(f"engine: finished {sorted(done)}, outputs "
                             f"{[len(r.output or []) for r in done.values()]}")
    if len(events) != eng.steps_total or any(e["kind"] != "serve" for e in events):
        raise AssertionError(f"engine event log: {len(events)} events of kinds "
                             f"{sorted({e['kind'] for e in events})} for {eng.steps_total} steps")
    if events[-1]["metrics"]["serve_tokens_total"] != 6 * 16:
        raise AssertionError(f"engine event log: last event {events[-1]}")
    log(f"check serve event log: validate_jsonl accepts {len(events)} serve events on disk, "
        f"one a step ({eng.steps_total} steps), the last counting {6 * 16} tokens")
    stats = eng.stats()
    log(f"serve engine: 6 requests (prompts {lens}) x 16 new tokens in {eng.steps_total} steps, "
        f"{wall:.2f} s; decode ms per step mean {stats['serve_decode_step_s'] * 1e3:.2f}, "
        f"median {eng.step_timer.summary()['p50_s'] * 1e3:.2f}; "
        f"{eng.tokens_total / wall:.1f} tokens/s "
        f"over the run ({stats.get('serve_tokens_per_s', float('nan')):.1f} over the "
        f"timer's window)")
    # bf16 GEMMs of another batch size may sum in another order, and greedy
    # argmax follows any last-bit change of near-tied logits: the loop runs
    # the request in a batch of the engine's width, where row 0's arithmetic
    # is the engine's own; the one-row loop's agreement is printed
    seq = greedy_decode(cfg, params, prompts[0], 16, eng.B, dev)
    if done[0].output != seq:
        raise AssertionError(f"engine request 0 {done[0].output} != sequential greedy {seq}")
    one_row = greedy_decode(cfg, params, prompts[0], 16, 1, dev)
    log(f"check engine request 0 == sequential greedy decode over decode_step (16 tokens); "
        f"the one-row loop agrees on {sum(a == b for a, b in zip(one_row, seq))} of 16")

    # decode steps with all 4 slots in one cohort, unprofiled then profiled
    busy = ServeEngine(cfg, params, batch_slots=4, max_len=256, device=dev)
    for uid in range(4):
        busy.submit(Request(uid=uid, prompt=prompts[uid][:8], max_new_tokens=200))
    for _ in range(5):
        busy.step()
    t0 = time.perf_counter()
    for _ in range(20):
        busy.step()
    step_us = (time.perf_counter() - t0) / 20 * 1e6
    log(f"serve decode, 4 slots busy: {step_us / 1e3:.2f} ms per step, "
        f"{4e6 / step_us:.1f} tokens/s")
    profile_steps(busy.step, "serve.decode 4 slots", step_us, PROFILED_DECODE_STEPS)
    del busy

    # (d) prefill against decode in fp32 at full width
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    prompt = torch.randint(0, V, (1, 32), device=dev, generator=torch.Generator(dev).manual_seed(4))
    last = make_prefill_step(cfg32, device=dev)(params32, {"tokens": prompt})[:, 0]
    cache = tfm.init_cache(cfg32, 1, 32, device=dev)
    for t in range(32):
        step, cache = tfm.decode_step(params32, cfg32, cache, prompt[:, t], t)
    err = float((step - last).abs().max())
    torch.testing.assert_close(step, last, rtol=2e-3, atol=2e-3)
    log(f"check fp32 prefill vs decode (32 tokens, full width): last-position logits agree, "
        f"max |diff| {err:.3g} (bar: rtol and atol 2e-3)")
    del params32, cache
    torch.cuda.empty_cache()
    for label in ("serve.prefill", "serve.engine"):
        if any(launches[label].values()):
            raise AssertionError(f"{label} launched {launches[label]}; the serving path's "
                                 "own modules call no kernel")
    return launches


def paper_task(dev, runs):
    """Phase 9's data: SynthMNIST at benchmarks/common.py's scale (4,000
    train / 1,000 test), split non-iid over ``PAPER_N`` workers with f of
    them Byzantine, for each f of ``runs``; on the card."""
    import torch

    from repro_torch.data.partition import worker_datasets
    from repro_torch.data.synthetic import make_train_test

    X, Y, Xt, Yt = make_train_test(torch.Generator().manual_seed(0), n_train=4000,
                                   n_test=1000, device=dev)
    split = {}
    for f in sorted({f for _, f, _, _ in runs}):
        wx, wy = worker_datasets(X.cpu().numpy(), Y.cpu().numpy(), n_good=PAPER_N - f,
                                 n_byz=f, noniid=True)
        split[f] = (torch.tensor(wx, device=dev), torch.tensor(wy, device=dev))
    return split, Xt, Yt


def paper_sim(fields, f, lr, device, telemetry=False, loss_fn=None):
    """Phase 9's ``ByzantineSim`` (the MLP's ``nll_loss`` by default)."""
    from repro_torch.configs.base import ByzConfig
    from repro_torch.models.mlp import nll_loss
    from repro_torch.training.byzantine import ByzantineSim

    return ByzantineSim(loss_fn=loss_fn or nll_loss, byz=ByzConfig(n_byzantine=f, **fields),
                        n_workers=PAPER_N, n_byzantine=f, lr=lr, batch_size=32,
                        telemetry=telemetry, device=device)


def paper_gates(acc) -> None:
    """tests/test_sim.py's thresholds, which the reference meets at this
    scale (``PAPER_REFERENCE``)."""
    gates = [
        ("mean/none > 0.75", acc["mean/none"] > 0.75),
        ("krum s=2 > vanilla + 0.05", acc["krum/none s=2"] > acc["krum/none vanilla"] + 0.05),
        ("cm+mimic s=2 > vanilla - 0.07", acc["cm+mimic s=2"] > acc["cm+mimic vanilla"] - 0.07),
        ("cm+mimic s=2 > 0.5", acc["cm+mimic s=2"] > 0.5),
        ("rfa+bitflip s=2 > 0.6", acc["rfa+bitflip s=2"] > 0.6),
        ("cclip+ipm s=2 > 0.6", acc["cclip+ipm s=2"] > 0.6),
    ]
    failed = [name for name, ok in gates if not ok]
    if failed:
        raise AssertionError(f"paper loop: accuracies {acc} miss {failed}")
    log("check paper loop gates (tests/test_sim.py): " + "; ".join(n for n, _ in gates))


def paper_phase(dev, smi: str, runs=None, loss_fn=None, init=None, apply_fn=None,
                gate=None, reference=None, prefix: str = "paper."):
    """Phase 9 (and 16(a)): the paper's experiment loop, ``ByzantineSim``, at
    the benchmark's scale on the card, under ``runs`` (``PAPER_RUNS`` by
    default) with ``loss_fn``, ``init`` and ``apply_fn`` (the MLP's by
    default): one step held against the CPU's, then ``PAPER_STEPS`` steps a
    run (no launch, finite state; counted under ``prefix + label``), the
    accuracies gated by ``gate`` (``paper_gates``) and printed beside the
    JAX reference's (``reference``, ``PAPER_REFERENCE``); steps/s, peak
    memory, profiled."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.mlp import init_mlp, mlp_apply, nll_loss

    runs = PAPER_RUNS if runs is None else runs
    loss_fn, init, apply_fn = loss_fn or nll_loss, init or init_mlp, apply_fn or mlp_apply
    gate, reference = gate or paper_gates, reference or PAPER_REFERENCE
    split, Xt, Yt = paper_task(dev, runs)
    # one step on the card against the same step on the CPU, same draws
    for label, f, lr, fields in runs:
        wx, wy = split[f]
        sim_gpu = paper_sim(fields, f, lr, dev, loss_fn=loss_fn)
        sim_cpu = paper_sim(fields, f, lr, "cpu", loss_fn=loss_fn)
        params = init(torch.Generator().manual_seed(1), device="cpu")
        draws = sim_cpu.draw(torch.Generator().manual_seed(5), wx.shape[1])
        s_cpu, _ = sim_cpu.step(sim_cpu.init_state(params), wx.cpu(), wy.cpu(), draws)
        s_gpu, _ = sim_gpu.step(sim_gpu.init_state({k: v.to(dev) for k, v in params.items()}),
                                wx, wy, draws._replace(mix=draws.mix.to(dev)))
        for k in params:
            torch.testing.assert_close(s_gpu.params[k].cpu(), s_cpu.params[k],
                                       rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(s_gpu.momentum.cpu(), s_cpu.momentum, rtol=1e-4, atol=1e-6)
    log(f"check {prefix}*: one step on the card == the step on the CPU with the same draws "
        f"(parameters and momenta, rtol 1e-4, atol 1e-6), for all {len(runs)} runs")

    # each run counted on its own: ByzantineSim aggregates through
    # RobustAggregator, as the reference does, and launches no kernel
    acc, step_us, launches = {}, {}, {}
    for label, f, lr, fields in runs:
        wx, wy = split[f]
        sim = paper_sim(fields, f, lr, dev, loss_fn=loss_fn)
        params = init(torch.Generator().manual_seed(1), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        state, _ = sim.run(params, wx, wy, PAPER_STEPS, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[f"{prefix}{label}"] = counts = dict(LAUNCHES)
        if any(counts.values()):
            raise AssertionError(f"{prefix}{label}: launched {counts}; the loop runs no kernel")
        flat = torch.cat([p.reshape(-1) for p in state.params.values()])
        if not bool(torch.isfinite(flat).all()) or not bool(torch.isfinite(state.momentum).all()):
            raise AssertionError(f"{prefix}{label}: non-finite parameters or momenta")
        acc[label] = held_out_accuracy(apply_fn, state.params, Xt, Yt)
        step_us[label] = seconds / PAPER_STEPS * 1e6
        log(f"{prefix}{label}: d {flat.numel()}, n {PAPER_N}, f {f}, lr {lr}, {PAPER_STEPS} "
            f"steps: test accuracy {acc[label]:.4f} (the JAX reference on the CPU: "
            f"{reference[label]:.4f}); {PAPER_STEPS / seconds:.1f} steps/s, "
            f"{peak_above(live)} on {smi}")
    gate(acc)
    for label, f, lr, fields in runs:
        wx, wy = split[f]
        profile_rounds(paper_sim(fields, f, lr, dev, loss_fn=loss_fn), wx, wy, dev,
                       f"{prefix}{label} ({smi})", step_us[label], unit="step", init=init)
    return launches, split


def telemetry_phase(dev, split):
    """Phase 10(a) and (b): the simulators with telemetry on."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.mlp import init_mlp
    from repro_torch.telemetry import get_metric

    def checked(label, tele):
        for name, v in tele.items():
            get_metric(name)
            if not np.isfinite(np.asarray(v, dtype=np.float32)).all():
                raise AssertionError(f"{label}: telemetry {name} not finite")

    # (a) ALIE is visible in ByzantineSim's traces (tests/test_telemetry.py)
    n, f = PAPER_N, 5
    wx, wy = split[f]
    launches, hist = {}, {}
    for agg in ("cm", "krum"):
        fields = dict(aggregator=agg, mixing="none", attack="alie",
                      attack_kwargs=(("n", n), ("f", f)), worker_momentum=0.9, delta=f / n)
        sim = paper_sim(fields, f, 0.1, dev, telemetry=True)
        torch.cuda.synchronize()
        reset_launches()
        _, hist[agg] = sim.run(init_mlp(torch.Generator().manual_seed(1), device=dev), wx, wy,
                               15, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        launches[f"telemetry.paper.{agg}+alie"] = counts = dict(LAUNCHES)
        if any(counts.values()):
            raise AssertionError(f"telemetry {agg}+alie: launched {counts}")
        checked(f"telemetry {agg}+alie", hist[agg]["telemetry"])
    cm_dev = hist["cm"]["telemetry"]["cm_worker_dev"][5:]
    scores = hist["krum"]["telemetry"]["krum_scores"][5:]
    mask = hist["cm"]["telemetry"]["byz_mask"][0]
    byz_dev, good_dev = float(cm_dev[:, :f].mean()), float(cm_dev[:, f:].mean())
    byz_s, good_s = float(scores[:, :f].mean()), float(scores[:, f:].mean())
    if cm_dev.shape != (10, n) or not mask[:f].all() or mask[f:].any():
        raise AssertionError(f"telemetry cm+alie: cm_worker_dev {cm_dev.shape}, mask {mask}")
    if not byz_dev < 0.6 * good_dev or not byz_s < good_s:
        raise AssertionError(f"telemetry: ALIE not visible: cm_worker_dev {byz_dev} vs "
                             f"{good_dev}, krum_scores {byz_s} vs {good_s}")
    log(f"check ALIE visible in ByzantineSim telemetry (n {n}, f {f}, steps 6-15): "
        f"cm_worker_dev Byzantine {byz_dev:.4g} < 0.6 x honest {good_dev:.4g}; "
        f"krum_scores Byzantine {byz_s:.4g} < honest {good_s:.4g}")

    # (b) CrossDeviceSim with telemetry on and off from the same draws
    wx, wy, _, _ = slice_task(dev)
    for agg, attack, _ in SLICE_RUNS:
        label, runs = f"{agg}+{attack}", {}
        for telemetry in (False, True):
            sim = slice_sim(agg, attack, dev, telemetry=telemetry)
            torch.cuda.synchronize()
            reset_launches()
            state, hist_ = sim.run(init_mlp(torch.Generator().manual_seed(1), device=dev),
                                   wx, wy, 20, torch.Generator().manual_seed(2))
            torch.cuda.synchronize()
            runs[telemetry] = (state, hist_, dict(LAUNCHES))
        (off, _, c_off), (on, hist_on, c_on) = runs[False], runs[True]
        launches[f"telemetry.slice.{label}"] = c_on
        if c_on != c_off:
            raise AssertionError(f"telemetry {label}: launches on {c_on}, off {c_off}")
        if not all(torch.equal(on.params[k], off.params[k]) for k in off.params):
            raise AssertionError(f"telemetry {label}: parameters differ from telemetry off")
        tele = hist_on["telemetry"]
        checked(f"telemetry {label}", tele)
        log(f"check CrossDeviceSim {label} telemetry on vs off, 20 rounds: launches "
            f"{json.dumps(c_on)} both; parameters equal bit for bit; {len(tele)} metrics "
            f"catalogued and finite ({', '.join(sorted(tele))})")
    return launches


def bigram_batch(gen, V, batch, seq_len, dev, cfg=None):
    """tests/test_system.py's learnable stream: random first tokens, then
    ``next = (3 tok + 7) mod V``; inputs and next-token labels. For a
    ``cfg`` with codebooks, codebook k carries the chain shifted by 17 k
    (one law seen through K tables: K independent chains summed into one
    embedding miss the gate in 30 steps, 6.75 -> 6.24 at smoke width on
    the CPU); with prefix tokens, ``prefix_embeds`` [batch, n_prefix, D]
    drawn from ``gen`` in the model dtype."""
    import torch

    seq = [torch.randint(0, V, (batch, 1), generator=gen)]
    for _ in range(seq_len):
        seq.append((seq[-1] * 3 + 7) % V)
    toks = torch.cat(seq, dim=1)
    if cfg is not None and cfg.n_codebooks:
        toks = torch.stack([(toks + 17 * k) % V for k in range(cfg.n_codebooks)], dim=1)
    toks = toks.to(dev)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg is not None and cfg.n_prefix_tokens:
        out["prefix_embeds"] = torch.randn((batch, cfg.n_prefix_tokens, cfg.d_model),
                                           generator=gen).to(dev, getattr(torch, cfg.dtype))
    return out


def smoke_train(dev, n_workers, agg, steps, mesh=None, arch="tinyllama-1.1b"):
    """Phase 11(b) / (c), 12(c): ``make_train_step`` at ``smoke_config``
    width on tests/test_system.py's stream, each step's mix drawn from one
    seeded generator (so every rank and the one-device run see the same
    ones). Returns the parameters, the losses and the launches of each
    step."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = smoke_config(arch)
    byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2, worker_momentum=0.9)
    step_fn, state = make_train_step(cfg, byz, mesh=mesh, lr=SMOKE_LR, n_workers=n_workers,
                                     device=dev)
    params = state["init_params"](torch.Generator().manual_seed(0))
    opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
    gen = torch.Generator().manual_seed(1)
    losses, counts = [], []
    for _ in range(steps):
        batch = bigram_batch(gen, cfg.vocab_size, 8, 64, dev, cfg)
        mix = state["aggregator"].mixing_matrix(n_workers, gen, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        params, opt_state, worker_m, metrics = step_fn(params, opt_state, worker_m, mix, batch)
        torch.cuda.synchronize()
        counts.append(dict(LAUNCHES))
        losses.append(float(metrics["loss"]))
    return params, losses, counts


def train_rank(rank, group, device):
    """Phase 11(c), in each rank: the worker-sharded train step over the
    group (this rank's worker only), RFA and CM, ``GROUP_STEPS`` steps."""
    out = {}
    for agg in ("rfa", "cm"):
        params, losses, counts = smoke_train(device, SYNC_RANKS, agg, GROUP_STEPS, mesh=group)
        want = [{k: SYNC_ROUTE[agg].get(k, 0) for k in c} for c in counts]
        if counts != want:
            raise AssertionError(f"rank {rank} train {agg}: launches {counts}, expected {want}")
        out[agg] = dict(params=params, losses=losses, counts=counts)
    return out


def model_width(cfg) -> str:
    """The widths a log line names: attention heads, the feed-forward or
    the experts, the SSM's inner width, heads and state, the dtype."""
    parts = [f"d_model {cfg.d_model}"]
    mixers = {m for m, _ in cfg.pattern_}
    if "attn" in mixers:
        parts.append(f"{cfg.n_heads}/{cfg.n_kv_heads} heads")
    if "ssm" in mixers:
        parts.append(f"SSM d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, "
                     f"N {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    if cfg.n_experts:
        parts.append(f"{cfg.n_experts} experts, top-{cfg.experts_per_token}, d_ff_expert "
                     f"{cfg.d_ff_expert}")
    if any(ff == "mlp" for _, ff in cfg.pattern_):
        parts.append(f"d_ff {cfg.d_ff}")
    parts.append(f"vocab {cfg.vocab_size}" + (f" x {cfg.n_codebooks} codebooks"
                                              if cfg.n_codebooks else ""))
    return ", ".join(parts + [cfg.dtype])


def agreement(label: str, rows, aggregator, mix):
    """The sync's aggregate of ``rows`` (leaves ``[W, ...]``: a step's
    worker momenta or raw gradients), kernel route against plain route,
    within ``TRAIN_AGG_RTOL`` of the largest row norm; the Gram of the
    packed rows, kernel and ``torch.matmul``, against an fp64 Gram summed
    in chunks, the kernel's within ``TRAIN_GRAM_RTOL`` of
    sqrt(G_ii G_jj)."""
    import torch

    from repro_torch.distributed.packing import packer_for
    from repro_torch.distributed.robust_sync import robust_gradient_sync
    from repro_torch.kernels.pairwise_gram import pairwise_gram
    from repro_torch.utils.tree import tree_flatten

    buf = packer_for(rows).pack(rows)
    exact = sum(c.double() @ c.double().T for c in buf.split(1 << 26, dim=1))
    diag = torch.diagonal(exact)
    scale = torch.sqrt(torch.outer(diag, diag))
    gram_err = {name: float(((g.double() - exact).abs() / scale).max())
                for name, g in (("kernel", pairwise_gram(buf)), ("matmul", buf @ buf.T))}
    row_norm = float(torch.sqrt(diag.max()))
    del buf, exact
    got = robust_gradient_sync(rows, aggregator, mix=mix)[0]
    k_row = torch.cat([t.reshape(-1) for t in tree_flatten(got)[0]])
    del got
    want = robust_gradient_sync(rows, aggregator, mix=mix, use_kernels=False)[0]
    p_row = torch.cat([t.reshape(-1) for t in tree_flatten(want)[0]])
    del want
    comb_err = float(torch.linalg.vector_norm(k_row - p_row)) / row_norm
    del k_row, p_row
    torch.cuda.empty_cache()
    log(f"check {label} aggregate, kernel route vs plain route on the same rows: "
        f"|agg_kernel - agg_plain|_2 / max_i |x_i|_2 = {comb_err:.3g} (bar {TRAIN_AGG_RTOL}); "
        f"Gram of the packed rows against fp64, max |G - G64|_ij / sqrt(G64_ii G64_jj): "
        f"kernel {gram_err['kernel']:.3g} (bar {TRAIN_GRAM_RTOL}), torch.matmul "
        f"{gram_err['matmul']:.3g}")
    if not comb_err <= TRAIN_AGG_RTOL or not gram_err["kernel"] <= TRAIN_GRAM_RTOL:
        raise AssertionError(f"{label}: kernel aggregate off the plain route's, or its Gram "
                             "off the fp64 Gram")


def train_full_width(dev, smi, cfg, note: str = "", n_expected=None, runs=None):
    """Phase 11(a) / 12(b) / 13(b): ``make_train_step`` on ``cfg`` at its
    full width, W = TRAIN_W heterogeneous workers with one TRAIN_S-token
    sequence each, the steps of ``runs`` (``TRAIN_RUNS`` by default) with
    exact launches, each step's loss, device ms by phase and peak memory,
    the first step of each rule held against the plain route.
    ``note`` (a depth cut) goes into the log lines; ``n_expected`` is the
    tree's parameter count (default ``cfg.param_count()``). Returns the
    launch totals and the run's state: ``params``, ``worker_m``,
    ``batch``, ``steppers`` and the generator ``gen`` of the mixing
    matrices."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ByzConfig
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.telemetry import phase_times
    from repro_torch.utils.tree import tree_flatten

    runs = TRAIN_RUNS if runs is None else runs
    torch.cuda.empty_cache()
    toks = make_token_stream(torch.Generator().manual_seed(11), TRAIN_W, TRAIN_S, 1,
                             cfg.vocab_size, device=dev)[:, 0]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}  # global batch W x S
    steppers = {agg: make_train_step(
        cfg, ByzConfig(aggregator=agg, mixing="bucketing", s=2, worker_momentum=0.9),
        lr=TRAIN_LR, n_workers=TRAIN_W, device=dev) for agg, _ in runs}
    state = steppers["rfa"][1]
    params = state["init_params"](torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
    torch.cuda.synchronize()
    if n_params != (n_expected or cfg.param_count()):
        raise AssertionError(f"train {cfg.name}: {n_params:,} parameters, expected "
                             f"{n_expected or cfg.param_count():,}")
    log(f"train: {cfg.name} ({cfg.n_layers} layers{note}, {model_width(cfg)}): "
        f"{n_params:,} parameters; "
        f"W {TRAIN_W} workers x 1 sequence of {TRAIN_S} tokens (make_token_stream, one law "
        f"each), sgdm lr {TRAIN_LR}, worker momentum 0.9; state on the card "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    gen = torch.Generator().manual_seed(12)
    total = {k: 0 for k in LAUNCHES}
    steps_ms, peaks = [], []
    probe = tree_flatten(params)[0][0].flatten()[:4096].clone()

    def one_step(agg, step_fn, aggregator):
        nonlocal params, opt_state, worker_m
        mix = aggregator.mixing_matrix(TRAIN_W, gen, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with phase_times() as ms:
            params, opt_state, worker_m, metrics = step_fn(params, opt_state, worker_m, mix,
                                                          batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peaks.append(torch.cuda.max_memory_allocated())
        counts = dict(LAUNCHES)
        want = {k: TRAIN_ROUTE[agg].get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"train {agg}: launches {counts}, expected {want}")
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"train {agg}: loss {loss}")
        return mix, wall, ms, counts, loss

    for agg, n_steps in runs:
        step_fn, st = steppers[agg]
        for i in range(n_steps):
            mix, wall, ms, counts, loss = one_step(agg, step_fn, st["aggregator"])
            for k, v in counts.items():
                total[k] += v
            steps_ms.append(wall)
            fb = ms.get("forward_backward", 0.0)
            split = {k: round(v, 3) for k, v in ms.items()}
            log(f"train {cfg.name} {agg} step {i + 1}: loss {loss:.5f}; host ms {wall:.1f}, "
                f"{TRAIN_W * TRAIN_S / wall * 1e3:.0f} tokens/s; device ms by phase (CUDA "
                f"events) {json.dumps(split)}; forward + backward per worker "
                f"{fb / TRAIN_W:.1f}; launches {json.dumps({k: v for k, v in counts.items() if v})}")
            if i == 0:
                moved = float((tree_flatten(params)[0][0].flatten()[:4096].float()
                               - probe.float()).abs().max())
                if not moved > 0:
                    raise AssertionError(f"train {agg}: the parameters did not move")
                agreement(f"train {agg}", worker_m, st["aggregator"], mix)
        if agg == "rfa":
            rfa_ms = statistics.median(steps_ms)
    log(f"train {cfg.name}{note}: host ms per step {', '.join(f'{t:.1f}' for t in steps_ms)} "
        f"(rfa median {rfa_ms:.1f}, {TRAIN_W * TRAIN_S / rfa_ms * 1e3:.0f} tokens/s); peak "
        f"device memory in a step {', '.join(f'{b / 1e9:.2f}' for b in peaks)} GB "
        f"(max_memory_allocated) on {smi}")
    return total, dict(params=params, worker_m=worker_m, batch=batch, steppers=steppers,
                       gen=gen)


def train_kernel_rows(run, dev, label: str, timing=(2, 1)):
    """``pairwise_gram``, ``bucket_mix`` (mix [2, W] and combine [1, W]) and
    ``cwise_median`` (X[2, n_pad]) held and timed on the packed momenta of
    ``train_full_width``'s ``run``, as in phase 2 (the plain versions and
    library calls once, ``time_once``); the momenta are freed.
    Returns the rows by kernel."""
    import torch

    from repro_torch.kernels.cost import selection_ops

    from repro_torch.distributed.packing import packer_for
    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.cwise_median import cwise_median
    from repro_torch.kernels.pairwise_gram import pairwise_gram

    worker_m = run.pop("worker_m")
    x = packer_for(worker_m).pack(worker_m)
    del worker_m
    torch.cuda.empty_cache()
    W_, d = x.shape
    kernel_rows = {"bucket_mix": [], "pairwise_gram": [], "cwise_median": []}
    # the plain Gram adds 537,133 tiles one launch each at TinyLlama's
    # n_pad: its graph-timed run took ~50 s, so the plain versions and the
    # library calls are timed once
    record = functools.partial(measure, kernel_rows, once=True)
    mix = run["steppers"]["cm"][1]["aggregator"].mixing_matrix(TRAIN_W, run["gen"], device=dev)
    weights = torch.full((1, W_), 1.0 / W_, device=dev)
    for what, M in (("mix", mix), ("combine", weights)):
        m = M.shape[0]
        record("bucket_mix", f"{label} {what} M[{m},{W_}] X[{W_},{d}]",
               lambda M=M: bucket_mix(M, x), lambda M=M: ref.bucket_mix(M, x),
               lambda M=M: torch.matmul(M, x), (W_ * d + m * W_ + m * d) * 4,
               2 * m * W_ * d, timing, close(1e-5, 1e-4))
    record("pairwise_gram", f"{label} X[{W_},{d}]", lambda: pairwise_gram(x),
           lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
           (W_ * d + W_ * W_) * 4, W_ * (W_ + 1) * d, timing,
           lambda got, want: torch.testing.assert_close(
               got, want, rtol=0, atol=TRAIN_GRAM_RTOL * float(torch.diagonal(want).max())))
    mixed = bucket_mix(mix, x)
    del x
    torch.cuda.empty_cache()
    record("cwise_median", f"{label} X[{TRAIN_M},{d}]", lambda: cwise_median(mixed),
           lambda: ref.cwise_median(mixed), lambda: torch.median(mixed, dim=0).values,
           3 * d * 4, selection_ops(TRAIN_M, d), timing, close(0, 0))
    del mixed
    torch.cuda.empty_cache()
    return kernel_rows


def remat_phase(dev, smi):
    """Phase 11(d): ``make_train_step`` on gemma-7b at its published width,
    REMAT_LAYERS deep, W = TRAIN_W workers of one REMAT_S-token sequence,
    RFA with bucketing s = 2 and the config's server momentum: steps with
    ``remat="full"`` (each period recomputed in the backward) and with
    ``remat="none"`` in the turns of ``REMAT_TURNS``, each from the same
    parameters, optimizer state, batch and mixing matrix. All give the same
    parameters and optimizer state bit for bit, and each launches exactly
    ``TRAIN_ROUTE["rfa"]`` and has a finite loss. Each step's peak memory
    above what was allocated before it is read twice: at the end of its
    last forward and backward (``phase_times``' peaks: what recompute cuts,
    the remat steps' must be the lower) and at the end of the step (which
    the sync's packed rows set in both). Then the rows the steps synced
    (each worker's gradient at the start, recomputed with remat) go
    through ``agreement``. Returns the launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer as tfm
    from repro_torch.telemetry import phase_times
    from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(REMAT_ARCH), n_layers=REMAT_LAYERS)
    if cfg.remat != "full" or cfg.momentum_mode != "server":
        raise AssertionError(f"remat: {cfg.name} has remat {cfg.remat!r}, momentum "
                             f"{cfg.momentum_mode!r}")
    toks = make_token_stream(torch.Generator().manual_seed(11), TRAIN_W, REMAT_S, 1,
                             cfg.vocab_size, device=dev)[:, 0]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    byz = ByzConfig(aggregator="rfa", mixing="bucketing", s=2)
    steppers = {remat: make_train_step(dataclasses.replace(cfg, remat=remat), byz,
                                       lr=TRAIN_LR, n_workers=TRAIN_W, device=dev)
                for remat in ("full", "none")}
    state = steppers["full"][1]
    params = state["init_params"](torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    if n_params != REMAT_PARAMS:
        raise AssertionError(f"remat: {n_params:,} parameters, expected {REMAT_PARAMS:,}")
    # each step starts from its own copy (the optimizer writes its moments in place)
    start = (params, state["init_opt_state"](params))
    del params
    mix = state["aggregator"].mixing_matrix(TRAIN_W, torch.Generator().manual_seed(12),
                                            device=dev)
    total = {k: 0 for k in LAUNCHES}
    log(f"remat: {cfg.name} ({REMAT_LAYERS} of 28 layers, {model_width(cfg)}): "
        f"{n_params:,} parameters; W {TRAIN_W} workers x 1 sequence of {REMAT_S} tokens, "
        f"rfa + bucketing s = 2, server momentum, sgdm lr {TRAIN_LR} ({smi})")

    first, peaks = None, {"full": [], "none": []}
    for remat in REMAT_TURNS:
        p, o = tree_map(torch.clone, start)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with phase_times() as ms:
            p, o, _, metrics = steppers[remat][0](p, o, {}, mix, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        fb_peak = ms.peaks["forward_backward"] - live
        peak = torch.cuda.max_memory_allocated() - live
        counts = dict(LAUNCHES)
        for k, v in counts.items():
            total[k] += v
        want = {k: TRAIN_ROUTE["rfa"].get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"remat {remat}: launches {counts}, expected {want}")
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"remat {remat}: loss {loss}")
        log(f"train {cfg.name} ({REMAT_LAYERS} of 28 layers) rfa, remat {remat!r}: loss "
            f"{loss:.5f}; host ms {wall:.1f}; forward + backward device ms "
            f"{ms.get('forward_backward', 0.0):.1f} (4 workers); device ms by phase "
            f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}; peak above the "
            f"{live / 1e9:.2f} GB held before the step: {fb_peak / 1e9:.2f} GB through the "
            f"forward and backward, {peak / 1e9:.2f} GB in the step; launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        out = tree_flatten((p, o))[0]
        del p, o
        if first is None:
            first = out
        elif not all(torch.equal(a, b) for a, b in zip(out, first)):
            raise AssertionError(f"remat: the parameters or optimizer state of the "
                                 f"{remat!r} step differ from the first step's "
                                 f"({REMAT_TURNS[0]!r})")
        del out
        peaks[remat].append((fb_peak, peak))
    del first
    fb = {remat: max(p[0] for p in v) for remat, v in peaks.items()}
    step = {remat: max(p[1] for p in v) for remat, v in peaks.items()}
    if not fb["full"] < fb["none"]:
        raise AssertionError(f"remat: peak through the forward and backward {fb['full']} B "
                             f"with recompute, {fb['none']} B without")
    log(f"check remat: parameters and optimizer state bit for bit over {len(REMAT_TURNS)} "
        f"steps {REMAT_TURNS}; peak above the state through the forward and backward "
        f"{fb['full'] / 1e9:.2f} GB with recompute against {fb['none'] / 1e9:.2f} GB without "
        f"({(fb['none'] - fb['full']) / 1e9:.2f} GB lower); in the whole step "
        f"{step['full'] / 1e9:.2f} against {step['none'] / 1e9:.2f} GB on {smi}")

    # the rows the steps synced: each worker's gradient at the start
    leaves, treedef = tree_flatten(start[0])
    live = [t.detach().requires_grad_() for t in leaves]
    rows = [torch.empty((TRAIN_W,) + tuple(t.shape), dtype=t.dtype, device=dev)
            for t in leaves]
    for w in range(TRAIN_W):
        loss, _ = tfm.loss_fn(tree_unflatten(treedef, live), cfg,
                              {k: v[w:w + 1] for k, v in batch.items()})
        for row, g in zip(rows, torch.autograd.grad(loss, live, materialize_grads=True)):
            row[w].copy_(g)
    del start, leaves, live
    agreement(f"remat {cfg.name} rfa", tree_unflatten(treedef, rows), state["aggregator"], mix)
    del rows
    torch.cuda.empty_cache()
    return total


def train_phase(dev, smi):
    """Phase 11: LLM training. (a) TinyLlama-1.1B at full width on the
    card; (b) the reference test's run at smoke width; (c) the
    worker-sharded step over 4 ranks; (d) gemma-7b's step with and without
    recompute (``remat_phase``). Returns the launch counts by path and
    the kernels' rows at the training shape."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.utils.tree import tree_flatten

    # (a) full width: W = 4 heterogeneous workers, one sequence each
    total, run = train_full_width(dev, smi, get_config("tinyllama-1.1b"))
    kernel_rows = train_kernel_rows(run, dev, "train")
    del run

    # (b) smoke width, tests/test_system.py's gate, W = 1 and 4
    launches = {"train": total}
    for n in (1, TRAIN_W):
        smoke_gate(dev, "tinyllama-1.1b", launches, f"train W{n}", n_workers=n, aggs=())

    # (c) the worker-sharded step over 4 ranks on cuda:0, against one device
    t0 = time.perf_counter()
    ranks = spawn_ranks(train_rank, SYNC_RANKS, backend="gloo",
                        devices=["cuda:0"] * SYNC_RANKS, timeout_s=600)
    log(f"train group: {SYNC_RANKS} ranks on cuda:0 under gloo ran in "
        f"{time.perf_counter() - t0:.1f} s, spawn included")
    launches["train_group"] = {k: 0 for k in LAUNCHES}
    for agg in ("rfa", "cm"):
        one_params, one_losses, _ = smoke_train(dev, SYNC_RANKS, agg, GROUP_STEPS)
        one = [t.cpu().numpy() for t in tree_flatten(one_params)[0]]
        first = tree_flatten(ranks[0][agg]["params"])[0]
        err = 0.0
        for rank, r in enumerate(ranks):
            leaves = tree_flatten(r[agg]["params"])[0]
            if not all(np.array_equal(a, b) for a, b in zip(leaves, first)):
                raise AssertionError(f"train group {agg}: rank {rank} differs from rank 0")
            for c in r[agg]["counts"]:
                for k, v in c.items():
                    launches["train_group"][k] += v
        for a, b in zip(first, one):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
            err = max(err, float(np.abs(a - b).max()))
        log(f"check train group {agg}, {GROUP_STEPS} steps: every rank bitwise equal; "
            f"launches per rank and step {json.dumps(SYNC_ROUTE[agg])}; max |group - one "
            f"device| of the parameters {err:.3g} (bar rtol 1e-4, atol 1e-6); losses "
            f"{[round(x, 5) for x in ranks[0][agg]['losses']]} vs one device "
            f"{[round(x, 5) for x in one_losses]}")

    # (d) gemma-7b at full width, 2 layers: remat "full" against "none"
    launches["train_remat"] = remat_phase(dev, smi)
    return launches, kernel_rows


def nbytes(tree) -> int:
    from repro_torch.utils.tree import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def decode_bytes(params, cache, batch: int, vocab: int, tied: bool = False,
                 written: int = 0) -> int:
    """Bytes one decode step must move: every parameter but the embedding
    table read once (a MoE layer's products read every expert's weights),
    ``batch`` embedding rows (the whole table when it is ``tied`` to the
    head), the cache read once, ``written`` bytes of it written (an SSM
    state is replaced each step) and the logits written."""
    embed = params["embed"]
    rows = 0 if tied else nbytes(embed) - batch * embed.shape[1] * embed.element_size()
    return nbytes(params) - rows + nbytes(cache) + written + batch * vocab * 4


def moe_routing(params, cfg, batch):
    """Each worker's routing on the trained model: the top-k assignments
    per expert of each MoE layer ([W, n_layers, E], from the router as the
    layer computes it) and the drop fraction per layer, from one forward of
    each worker's rows."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    counts, drops = [], []
    layer = moe_mod.moe_layer

    def recording(p, x, c, ax=None):
        gates = torch.softmax(x.reshape(-1, c.d_model).float() @ p["router"], dim=-1)
        top = torch.sort(gates, dim=-1, descending=True, stable=True).indices
        counts.append(torch.bincount(top[:, :c.experts_per_token].reshape(-1),
                                     minlength=c.n_experts))
        return layer(p, x, c, ax=ax)

    moe_mod.moe_layer = recording
    try:
        with torch.no_grad():
            for w in range(batch["tokens"].shape[0]):
                _, aux = tfm.forward(params, cfg, batch["tokens"][w:w + 1])
                drops.append(float(aux["moe_drop_frac"]) / cfg.n_layers)
    finally:
        moe_mod.moe_layer = layer
    return torch.stack(counts).reshape(len(drops), cfg.n_layers, cfg.n_experts), drops


def moe_phase(dev, smi):
    """Phase 12: the MoE family. (a) OLMoE-1B-7B served at full width and
    depth; (b) trained at full width, depth cut to MOE_TRAIN_LAYERS; (c)
    the smoke-width gate for OLMoE and one Kimi K2 step (fsdp on one rank,
    server momentum, bf16 optimizer momentum). Returns the launch counts by
    path."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.utils.tree import tree_flatten

    launches = {}
    counted = functools.partial(run_counted, launches)

    # (a) serving at full width and depth
    cfg = get_config(MOE_ARCH)
    if cfg.param_count() != MOE_PARAMS:
        raise AssertionError(f"{cfg.name}: the config counts {cfg.param_count():,}")
    params = init_full(cfg, dev, MOE_PARAMS, "moe serve")
    serve_full(cfg, params, dev, smi, launches, "moe.serve")
    del params
    torch.cuda.empty_cache()

    # (b) training at full width, the depth cut
    cfg_t = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    if cfg_t.param_count() != MOE_TRAIN_PARAMS:
        raise AssertionError(f"{cfg.name} at {MOE_TRAIN_LAYERS} layers: "
                             f"{cfg_t.param_count():,} parameters")
    launches["moe.train"], run = train_full_width(
        dev, smi, cfg_t, note=f" of {cfg.n_layers}: depth cut, full width")
    per, drops = moe_routing(run["params"], cfg_t, run["batch"])
    del run
    torch.cuda.empty_cache()
    starved = (per == 0).any(dim=0).sum(dim=-1).tolist()  # per layer
    log(f"moe train routing after the steps, W {TRAIN_W} workers (one token law each): drop "
        f"fraction a layer per worker {[round(d, 4) for d in drops]}, mean "
        f"{statistics.mean(drops):.4f}; experts that got no token from some worker, per "
        f"layer: {starved} of {cfg.n_experts}; assignments per expert and worker, min "
        f"{int(per.min())} / max {int(per.max())} of {TRAIN_S * cfg.experts_per_token}")

    # (c) smoke width: the reference test's gate for OLMoE; one Kimi K2 step
    smoke_gate(dev, MOE_ARCH, launches, "moe.train", aggs=())
    kcfg = smoke_config("kimi-k2-1t-a32b")
    if not (kcfg.fsdp and kcfg.momentum_mode == "server" and kcfg.opt_m_dtype == "bfloat16"):
        raise AssertionError(f"kimi smoke config: {kcfg}")
    gen = torch.Generator().manual_seed(13)
    for agg in ("rfa", "cm"):
        step_fn, state = make_train_step(
            kcfg, ByzConfig(aggregator=agg, mixing="bucketing", s=2, worker_momentum=0.9),
            lr=SMOKE_LR, n_workers=TRAIN_W, device=dev)
        params = state["init_params"](torch.Generator().manual_seed(0))
        opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
        batch = bigram_batch(gen, kcfg.vocab_size, 8, 64, dev)
        mix = state["aggregator"].mixing_matrix(TRAIN_W, gen, device=dev)
        params, opt_state, worker_m, metrics = counted(
            f"moe.kimi {agg}", lambda: step_fn(params, opt_state, worker_m, mix, batch))
        got = launches[f"moe.kimi {agg}"]
        m_dtypes = {t.dtype for t in tree_flatten(opt_state.m)[0]}
        if (got != {k: TRAIN_ROUTE[agg].get(k, 0) for k in got} or worker_m
                or m_dtypes != {torch.bfloat16} or not np.isfinite(float(metrics["loss"]))):
            raise AssertionError(f"kimi smoke {agg}: launches {got}, worker_m "
                                 f"{bool(worker_m)}, m {m_dtypes}, loss {metrics['loss']}")
        log(f"moe kimi smoke step {agg} ({kcfg.name} smoke_config: fsdp on one rank, server "
            f"momentum, bf16 optimizer momentum): loss {float(metrics['loss']):.4f}; launches "
            f"{json.dumps({k: v for k, v in got.items() if v})}")
    return launches


def init_full(cfg, dev, n_expected: int, label: str, note: str = ""):
    """``cfg``'s random parameters on the card from a seed; the tree's count
    must be ``n_expected``."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_flatten

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    if n_params != n_expected:
        raise AssertionError(f"{cfg.name}: {n_params:,} parameters on the card, expected "
                             f"{n_expected:,}")
    log(f"{label}: {cfg.name} ({cfg.n_layers} layers{note}, {model_width(cfg)}): "
        f"{n_params:,} parameters ({nbytes(params) / 1e9:.2f} GB) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def timed_prefill(cfg, params, batch, label, launches, shape, dev):
    """``make_prefill_step`` on ``batch``: counted once (its logits must
    have ``shape`` and be finite), then timed three times. Returns the host
    ms."""
    import torch

    from repro_torch.distributed.steps import make_prefill_step

    prefill = make_prefill_step(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    logits = run_counted(launches, label, lambda: prefill(params, batch))
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)} (expected {shape}), "
                             f"finite {bool(torch.isfinite(logits).all())}")
    del logits
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"{label}: logits {list(shape)} finite; host ms per prefill "
        f"{', '.join(f'{t:.1f}' for t in times)} (median {statistics.median(times):.1f}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return prefill, times


def serve_full(cfg, params, dev, smi, launches, label: str, reuse: bool = False):
    """Phase 13's serving at full width: the prefill (B = 2 x ATTN_S) timed,
    a MoE model's drop fraction; phase 8's 6-request
    ``ServeEngine`` run, request 0 (and with ``reuse`` request 4, served
    after another in the same slot) equal to the greedy loop at the
    engine's width; 20 decode steps with 4 slots busy timed (5 more under the profiler)
    beside their bound; no kernel of ours launched (counted)."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serving import Request, ServeEngine

    V, S = cfg.vocab_size, ATTN_S
    tokens = torch.randint(0, V, (2, S), device=dev, generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": tokens}
    prefill, times = timed_prefill(cfg, params, batch, f"{label}.prefill", launches, (2, 1, V),
                                   dev)
    n_moe = sum(ff == "moe" for _, ff in cfg.pattern_) * cfg.n_periods
    if n_moe:
        with torch.no_grad():
            _, aux = tfm.forward_hidden(params, cfg, tokens)
        C = expert_capacity(2 * S, cfg)
        log(f"{label}.prefill B2 S{S}: capacity C = {C}, buffer [{cfg.n_experts}, {C}, "
            f"{cfg.d_model}]; drop fraction a MoE layer "
            f"{float(aux['moe_drop_frac']) / n_moe:.4f} ({n_moe} MoE layers)")
        del aux

    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 97, (6,), generator=rng).tolist()
    prompts = [torch.randint(0, V, (n,), generator=rng).tolist() for n in lens]
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=256, device=dev)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=16))
    t0 = time.perf_counter()
    done = run_counted(launches, f"{label}.engine", eng.run_until_drained)
    wall = time.perf_counter() - t0
    if sorted(done) != list(range(6)) or any(len(r.output) != 16 for r in done.values()):
        raise AssertionError(f"{label} engine: finished {sorted(done)}, outputs "
                             f"{[len(r.output or []) for r in done.values()]}")
    log(f"{label} engine: 6 requests (prompts {lens}) x 16 new tokens in {eng.steps_total} "
        f"steps, {wall:.2f} s; decode ms per step mean "
        f"{eng.stats()['serve_decode_step_s'] * 1e3:.2f}, median "
        f"{eng.step_timer.summary()['p50_s'] * 1e3:.2f}; {eng.tokens_total / wall:.1f} tokens/s")
    # requests 0-3 take the four slots; 4 and 5 each reuse a slot freed by one.
    # bf16 GEMMs of another batch size may sum in another order, and greedy
    # argmax follows any last-bit change of near-tied logits: the loop runs
    # the request in a batch of the engine's width (phase 8)
    for uid in (0, 4) if reuse else (0,):
        seq = greedy_decode(cfg, params, prompts[uid], 16, eng.B, dev)
        if done[uid].output != seq:
            raise AssertionError(f"{label} engine request {uid} {done[uid].output} != "
                                 f"sequential greedy {seq}")
        log(f"check {label} engine request {uid}"
            + (" (served after another request in its slot)" if uid else "")
            + " == sequential greedy decode over decode_step (16 tokens)"
            + (f"; C = {expert_capacity(eng.B, cfg)} >= {eng.B} decode tokens, none dropped"
               if n_moe else ""))
    one_row = greedy_decode(cfg, params, prompts[0], 16, 1, dev)
    log(f"{label}: the one-row loop agrees with request 0 on "
        f"{sum(a == b for a, b in zip(one_row, done[0].output))} of 16 tokens")

    busy = ServeEngine(cfg, params, batch_slots=4, max_len=256, device=dev)
    for uid in range(4):
        busy.submit(Request(uid=uid, prompt=prompts[uid][:8], max_new_tokens=200))
    for _ in range(5):
        busy.step()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        busy.step()
    step_us = (time.perf_counter() - t0) / DECODE_STEPS * 1e6
    state = sum(nbytes(busy.cache[str(i)]) for i, (m, _) in enumerate(cfg.pattern_)
                if m == "ssm")
    n_bytes = decode_bytes(params, busy.cache, busy.B, V, tied=cfg.tie_embeddings,
                           written=state)
    log(f"{label} decode, 4 slots busy: {step_us / 1e3:.3f} ms per step, "
        f"{4e6 / step_us:.1f} tokens/s; a step reads the parameters"
        + (" (every expert's)" if n_moe else "") + " and the cache"
        + (f" and writes the SSM state ({state / 1e6:.1f} MB each way)" if state else "")
        + f": {n_bytes / 1e9:.3f} GB, bound {n_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms (bytes "
        f"at 3.35 TB/s) on {smi}")
    profile_steps(busy.step, f"{label}.decode 4 slots ({smi})", step_us,
                  PROFILED_DECODE_STEPS)
    log(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB since "
        f"the prefill")
    del busy, eng
    torch.cuda.empty_cache()
    for what in ("prefill", "engine"):
        if any(launches[f"{label}.{what}"].values()):
            raise AssertionError(f"{label}.{what} launched {launches[f'{label}.{what}']}; the "
                                 "serving path calls no kernel")


def smoke_gate(dev, arch, launches, label: str, n_workers: int = TRAIN_W,
               aggs=("rfa", "cm"), gate: bool = True):
    """Phase 11(b)'s gate for ``arch`` at smoke width over ``n_workers``
    (tests/test_system.py's: 30 steps of RFA + bucketing, the last loss
    below 0.8 x the first, every step's launches exactly RFA's route), then
    one step of each of ``aggs`` with exact launches."""
    import numpy as np

    if gate:
        t0 = time.perf_counter()
        _, losses, counts = smoke_train(dev, n_workers, "rfa", SMOKE_STEPS, arch=arch)
        sec = time.perf_counter() - t0
        launches[f"{label}.smoke"] = {k: sum(c[k] for c in counts) for k in counts[0]}
        if any(c != {k: TRAIN_ROUTE["rfa"].get(k, 0) for k in c} for c in counts):
            raise AssertionError(f"{label} smoke: launches {counts}")
        if not all(np.isfinite(losses)) or not losses[-1] < 0.8 * losses[0]:
            raise AssertionError(f"{label} smoke: losses {losses[::10]} miss the gate")
        log(f"{label} smoke W{n_workers} ({arch} smoke_config, rfa + bucketing, lr {SMOKE_LR}, "
            f"{SMOKE_STEPS} steps): loss {losses[0]:.4f} -> {losses[-1]:.4f} (gate < 0.8 x "
            f"first); {SMOKE_STEPS / sec:.1f} steps/s")
    for agg in aggs:
        _, losses, counts = smoke_train(dev, n_workers, agg, 1, arch=arch)
        want = {k: TRAIN_ROUTE[agg].get(k, 0) for k in counts[0]}
        if counts[0] != want or not np.isfinite(losses[0]):
            raise AssertionError(f"{label} {agg} step: launches {counts[0]}, expected {want}; "
                                 f"loss {losses[0]}")
        launches[f"{label}.{agg}"] = counts[0]
        log(f"{label} smoke step {agg} ({arch}): loss {losses[0]:.4f}; launches "
            f"{json.dumps({k: v for k, v in counts[0].items() if v})}")


def ssm_phase(dev, smi):
    """Phase 13: the SSM and the hybrid. (a) Mamba2-130m served at its
    published width and depth; (b) trained there through phase 11(a)'s
    ``train_full_width`` (``SSM_TRAIN_RUNS``, unprofiled), every gradient
    finite, and the three kernels held and timed on its packed momenta;
    (c) Jamba v0.1 served at its width over one 8-layer period; (d) the
    smoke gate and one RFA and one CM step of each. Returns the launch
    counts by path and the kernels' rows."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.utils.tree import tree_flatten

    launches = {}
    t_phase = time.perf_counter()
    # (a) Mamba2-130m served at full width and depth
    cfg = get_config(SSM_ARCH)
    params = init_full(cfg, dev, SSM_PARAMS, "ssm serve")
    log(f"ssm serve: the tree holds {SSM_PARAMS:,} parameters; the reference's param_count "
        f"formula, copied as it is, counts {cfg.param_count():,} (a norm2 the layers lack, "
        "without dt_bias and conv_b)")
    if cfg.param_count() != SSM_FORMULA:
        raise AssertionError(f"{cfg.name}: param_count {cfg.param_count():,}")
    serve_full(cfg, params, dev, smi, launches, "ssm.serve", reuse=True)
    del params
    torch.cuda.empty_cache()

    # (b) trained at full width and depth: every gradient folds into a
    # worker's momentum, so finite momenta mean finite gradients
    launches["ssm.train"], run = train_full_width(dev, smi, cfg, n_expected=SSM_PARAMS,
                                                  runs=SSM_TRAIN_RUNS)
    for name, tree in (("parameters", run["params"]), ("worker momenta", run["worker_m"])):
        bad = [i for i, t in enumerate(tree_flatten(tree)[0]) if not bool(torch.isfinite(t).all())]
        if bad:
            raise AssertionError(f"ssm train: {name} not finite in leaves {bad}")
    log(f"check ssm train: every parameter and worker-momentum leaf finite after the steps "
        f"({len(tree_flatten(run['params'])[0])} leaves, A_log / D / dt_bias fp32)")
    rows = train_kernel_rows(run, dev, "ssm train")
    del run
    torch.cuda.empty_cache()

    # (c) Jamba v0.1 at its width, one period
    hcfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS)
    if hcfg.param_count() != HYBRID_FORMULA:
        raise AssertionError(f"{hcfg.name} at {HYBRID_LAYERS} layers: param_count "
                             f"{hcfg.param_count():,}")
    params = init_full(hcfg, dev, HYBRID_PARAMS, "hybrid serve",
                       note=f" of {get_config(HYBRID_ARCH).n_layers}: one period")
    serve_full(hcfg, params, dev, smi, launches, "hybrid.serve")
    del params
    torch.cuda.empty_cache()

    # (d) smoke width
    for arch, label in ((SSM_ARCH, "ssm"), (HYBRID_ARCH, "hybrid")):
        smoke_gate(dev, arch, launches, label)
    log(f"ssm phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, rows


def prefix_codebook_phase(dev, smi):
    """Phase 14: prefix embeddings and codebooks. (a) InternVL2-2B's prefill
    at its published width and depth with 256 prefix embeddings; (b)
    MusicGen-medium's prefill over 4 codebooks with 64 prefix embeddings,
    20 greedy ``decode_step`` calls on [B, 4] tokens, the engine's refusal;
    (c) the smoke gates and steps with exact launches. Returns the launch
    counts by path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine

    launches = {}
    t_phase = time.perf_counter()
    for arch in (VLM_ARCH, AUDIO_ARCH):
        cfg = get_config(arch)
        params = init_full(cfg, dev, cfg.param_count(), "prefix serve")
        K, P, V = cfg.n_codebooks, cfg.n_prefix_tokens, cfg.vocab_size
        gen = torch.Generator(dev).manual_seed(1)
        lead = (2, K) if K else (2,)
        tokens = torch.randint(0, V, lead + (ATTN_S - P,), device=dev, generator=gen)
        # stub modality embeddings at the embedding table's scale
        prefix = (torch.randn((2, P, cfg.d_model), device=dev, generator=gen) * 0.02).to(
            getattr(torch, cfg.dtype))
        shape = (2, 1, K, V) if K else (2, 1, V)
        label = "vlm.prefill" if not K else "audio.prefill"
        timed_prefill(cfg, params, {"tokens": tokens, "prefix_embeds": prefix}, label, launches,
                      shape, dev)
        log(f"{label}: B2 x {P} prefix embeddings + {ATTN_S - P} tokens"
            + (f" in each of {K} codebooks" if K else "") + f" ({ATTN_S} positions) on {smi}")
        if K:
            cache = tfm.init_cache(cfg, 2, 256, device=dev)
            tok = torch.randint(0, V, (2, K), device=dev, generator=gen)

            def decode():
                nonlocal cache, tok
                times = []
                for t in range(DECODE_STEPS):
                    t0 = time.perf_counter()
                    logits, cache = tfm.decode_step(params, cfg, cache, tok, t)
                    tok = torch.argmax(logits, dim=-1)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                if tuple(logits.shape) != (2, K, V) or not bool(torch.isfinite(logits).all()):
                    raise AssertionError(f"audio decode: logits {tuple(logits.shape)}")
                return times

            times = run_counted(launches, "audio.decode", decode)
            log(f"audio decode: {DECODE_STEPS} greedy decode_step calls on [2, {K}] tokens, "
                f"logits [2, {K}, {V}] finite; host ms a step median "
                f"{statistics.median(times[1:]):.2f} (first {times[0]:.2f}) on {smi}")
            try:
                ServeEngine(cfg, params, device=dev)
            except NotImplementedError as e:
                log(f"check audio: the engine refuses codebooks, as the reference's ({e})")
            else:
                raise AssertionError("the engine accepted a codebook model")
        del params
        torch.cuda.empty_cache()
    for label in ("vlm.prefill", "audio.prefill", "audio.decode"):
        if any(launches[label].values()):
            raise AssertionError(f"{label} launched {launches[label]}; it calls no kernel")

    # (c) smoke width
    smoke_gate(dev, VLM_ARCH, launches, "vlm")
    smoke_gate(dev, AUDIO_ARCH, launches, "audio")
    smoke_gate(dev, DENSE_ARCH, launches, "qwen1.5", aggs=("rfa",), gate=False)
    log(f"prefix / codebook phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def fsdp_rank(rank, group, device):
    """Phase 15(a), in each rank: gemma-7b at full width, FSDP_LAYERS deep,
    trained on the (data=4, model=1) mesh; per step the launches, loss,
    host ms, peak memory and the elements the two all_to_alls received.
    The first step of each rule is held against the plain route of the
    same sharded sync on this rank's column slice (``plain_sync_check``)."""
    import dataclasses
    import math

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.distributed import packing
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.telemetry import phase_times
    from repro_torch.utils.tree import tree_flatten

    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config(FSDP_ARCH), n_layers=FSDP_LAYERS)
    mesh = make_host_mesh(group, data=SYNC_RANKS, model=1)
    toks = make_token_stream(torch.Generator().manual_seed(11), TRAIN_W, TRAIN_S, 1,
                             cfg.vocab_size, device=device)[:, 0]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    steppers = {agg: make_train_step(cfg, ByzConfig(aggregator=agg, mixing="bucketing", s=2),
                                     mesh=mesh, lr=TRAIN_LR, n_workers=TRAIN_W, device=device)
                for agg, _ in FSDP_RUNS}
    sh = steppers["rfa"][1]["shardings"]
    n_params = sum(math.prod(s.shape) for s in tree_flatten(sh["params_shape"])[0])
    if n_params != FSDP_PARAMS:
        raise AssertionError(f"fsdp: {n_params:,} parameters, expected {FSDP_PARAMS:,}")
    if sh["params"]["embed"].spec != ("data", "model"):
        raise AssertionError(f"fsdp: embed placed {sh['params']['embed'].spec}")
    params = steppers["rfa"][1]["init_params"](torch.Generator(device).manual_seed(0))
    opt_state, worker_m = steppers["rfa"][1]["init_opt_state"](params), {}
    torch.cuda.synchronize()
    held = {"params": nbytes(params), "momentum": nbytes(opt_state.m),
            "allocated": torch.cuda.memory_allocated()}
    block_elems = sum(t.numel() for t in tree_flatten(params)[0])
    probe = params["embed"][:64].clone()
    received, a2a = [], dist.all_to_all_single

    def counted(output, input, output_split_sizes=None, input_split_sizes=None, **kw):
        received.append(int(output.numel()))
        return a2a(output, input, output_split_sizes, input_split_sizes, **kw)

    # the sync's column slice and combined slice, kept for the plain check
    cap, reshard_in, unpack = {}, packing.reshard_in, packing.unpack_to_shardings

    def keep_cols(*a, **kw):
        cap["buf"] = reshard_in(*a, **kw)
        return cap["buf"]

    def keep_out(packer, local, out_shardings):
        cap.update(packer=packer, out=local, shardings=out_shardings,
                   blocks=unpack(packer, local, out_shardings))
        return cap["blocks"]

    gen = torch.Generator().manual_seed(12)
    steps, checks = [], []
    dist.all_to_all_single = counted
    try:
        for agg, n_steps in FSDP_RUNS:
            step_fn, st = steppers[agg]
            for i in range(n_steps):
                mix = st["aggregator"].mixing_matrix(TRAIN_W, gen, device=device)
                if i == 0:
                    packing.reshard_in, packing.unpack_to_shardings = keep_cols, keep_out
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dist.barrier(group)
                received.clear()
                reset_launches()
                t0 = time.perf_counter()
                try:
                    with phase_times() as pt:
                        params, opt_state, worker_m, metrics = step_fn(params, opt_state,
                                                                      worker_m, mix, batch)
                    torch.cuda.synchronize()
                finally:
                    packing.reshard_in, packing.unpack_to_shardings = reshard_in, unpack
                wall = (time.perf_counter() - t0) * 1e3
                counts = dict(LAUNCHES)
                want = {k: SYNC_ROUTE[agg].get(k, 0) for k in counts}
                if counts != want:
                    raise AssertionError(f"fsdp rank {rank} {agg}: launches {counts}, "
                                         f"expected {want}")
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise AssertionError(f"fsdp rank {rank} {agg}: loss {loss}")
                if len(received) != 2 or received[1] != block_elems:
                    raise AssertionError(f"fsdp rank {rank}: all_to_all received {received}, "
                                         f"its blocks hold {block_elems} elements")
                steps.append(dict(agg=agg, loss=loss, ms=wall, counts=counts,
                                  peak=torch.cuda.max_memory_allocated(),
                                  fb_peak=pt.peaks["forward_backward"],
                                  ingress=received[0], egress=received[1]))
                if cap:
                    checks.append(dict(agg=agg, **plain_sync_check(st["aggregator"], mix, cap,
                                                                   group)))
                    cap.clear()
                    torch.cuda.empty_cache()
    finally:
        dist.all_to_all_single = a2a
    moved = float((params["embed"][:64].float() - probe.float()).abs().max())
    if not moved > 0:
        raise AssertionError(f"fsdp rank {rank}: the parameters did not move")
    del params, opt_state, worker_m, steppers
    torch.cuda.empty_cache()
    out = dict(held=held, block_elems=block_elems, steps=steps, moved=moved,
               n_pad=_n_pad(sh["params_shape"]), checks=checks)
    # (e)-(h) in the same group; the seconds each took on this rank
    seconds = {"a": time.perf_counter() - t_start}
    for part, key, run in (("e", "tp", lambda: tp_rank(rank, group, device, cfg, batch)),
                           ("f", "tps", lambda: tps_rank(rank, group, device, TPS_GEMMA)),
                           ("g", "moe", lambda: moe_rank(rank, group, device)),
                           ("h", "ssm", lambda: ssm_rank(rank, group, device))):
        t0 = time.perf_counter()
        out[key] = run()
        seconds[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = seconds
    return out


def moe_config(n_layers: int = MOE_TP_LAYERS, dtype: str = MOE_TP_DTYPE):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), n_layers=n_layers, dtype=dtype)


def moe_rank(rank, group, device):
    """Phase 15(g), in each rank of (a)'s group: OLMoE-1B-7B at its
    published width on the (data=1, model=4) mesh, each rank on its 16 of
    64 experts (``models/moe.py``: routing whole on every rank, the
    experts' fp32 partial all-reduced) beside its split attention and
    vocab. Training: (e)'s ``tp_rank`` with one RFA step
    (``MOE_TP_RUNS``) at MOE_TP_LAYERS deep in MOE_TP_DTYPE on a token
    stream of OLMoE's vocab, worker momentum in compute blocks, then the
    same in bf16. Serving: (f)'s ``tps_rank`` with
    ``TPS_MOE``."""
    import torch

    from repro_torch.data.synthetic import make_token_stream

    cfg = moe_config()
    toks = make_token_stream(torch.Generator().manual_seed(11), TRAIN_W, TRAIN_S, 1,
                             cfg.vocab_size, device=device)[:, 0]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    train = tp_rank(rank, group, device, cfg, batch, rules=MOE_TP_RUNS, split_dims=TP_MOE_DIMS)
    torch.cuda.empty_cache()
    train16 = tp_rank(rank, group, device, moe_config(dtype="bfloat16"), batch,
                      rules=MOE_TP_RUNS, split_dims=TP_MOE_DIMS)
    del toks, batch
    torch.cuda.empty_cache()
    return dict(train=train, train16=train16, serve=tps_rank(rank, group, device, TPS_MOE))


def ssm_rank(rank, group, device):
    """Phase 15(h), in each rank of (a)'s group: Mamba2-130m at its
    published width and depth on the (data=1, model=4) mesh, each rank on
    its 6 of 24 SSD heads, B and C whole (``models/ssm.py``). Training:
    (e)'s ``tp_rank`` with one RFA and one CM step (``SSM_TP_RUNS``) in
    fp32 on a token stream of Mamba2's vocab, worker momenta in the rank's
    head blocks. Serving: (f)'s ``tps_rank`` with ``TPS_SSM``. Then
    Jamba's SSM layer alone (``ssm_layer_rank``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_stream

    cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32")
    toks = make_token_stream(torch.Generator().manual_seed(11), TRAIN_W, TRAIN_S, 1,
                             cfg.vocab_size, device=device)[:, 0]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    train = tp_rank(rank, group, device, cfg, batch, rules=SSM_TP_RUNS, split_dims=TP_SSM_DIMS)
    del toks, batch
    torch.cuda.empty_cache()
    serve = tps_rank(rank, group, device, TPS_SSM)
    torch.cuda.empty_cache()
    return dict(train=train, serve=serve, layer=ssm_layer_rank(rank, group, device))


def ssm_layer_leaves(cfg, device, seed: int = 7):
    """One SSM layer's leaves at ``cfg``'s width, drawn on the card from a
    seed: the weights at the init's scales, A_log as the card test draws it
    (0.5 N(0, 1): |A| below ~5 at 128 heads) and dt_bias from dt in Mamba's
    init range [1e-3, 0.1], so no 64-step chunk's summed decay nears
    fp32's exp overflow at 88.7 (where the gradient turns NaN, in both
    packages); fp32 for A_log / D / dt_bias as the init keeps them, the
    model dtype for the rest."""
    import math

    import torch

    gen = torch.Generator(device).manual_seed(seed)
    D, din, n, h, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.conv_kernel)
    dtype = getattr(torch, cfg.dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((h,), generator=gen, device=device)

    dt = torch.exp(uniform(math.log(1e-3), math.log(0.1)))
    leaves = {"in_proj": randn(D, 2 * din + 2 * n + h) * D ** -0.5,
              "conv_w": randn(din + 2 * n, K) * 0.1, "conv_b": randn(din + 2 * n) * 0.1,
              "norm_scale": 1.0 + 0.1 * randn(din), "out_proj": randn(din, D) * din ** -0.5}
    leaves = {k: v.to(dtype) for k, v in leaves.items()}
    leaves.update(A_log=0.5 * randn(h), D=torch.ones((h,), device=device),
                  dt_bias=dt + torch.log(-torch.expm1(-dt)))  # softplus(dt_bias) = dt
    return leaves


def ssm_layer_rank(rank, group, device):
    """15(h)'s Jamba v0.1 SSM layer alone at its published width (d_model
    4,096, d_inner 8,192, 128 heads of 64, N = 16) on (data=1, model=4),
    in fp32 and in bf16: each rank cuts its blocks of ``ssm_layer_leaves``
    by the compute plan of Jamba's first SSM layer (32 heads a rank, B / C
    whole), runs ``ssm_layer`` forward and backward on ``SSM_LAYER_S``
    tokens of one row against ``sum(out * r)`` for a seeded ``r``, and
    gathers its gradients whole; then rank 0 runs the whole layer on one
    device. The largest |mesh - one device| of the output, of the input's
    gradient and of each leaf's gradient over the largest one-device
    magnitude, the bytes a rank holds against the whole, and the host ms
    of each."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import compute_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.parallel import ModelAxis

    mesh = make_host_mesh(group, data=1, model=SYNC_RANKS)
    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS, dtype=dtype)
        i = next(j for j, (mixer, _) in enumerate(cfg.pattern_) if mixer == "ssm")
        plan = compute_shardings(cfg, tfm.params_shape(cfg), mesh)["blocks"][str(i)]["mixer"]
        ax = ModelAxis.of(cfg, mesh)
        if not ax.ssm:
            raise AssertionError(f"ssm layer: {cfg.ssm_heads} heads do not split over the axis")
        whole = ssm_layer_leaves(cfg, device)
        names = sorted(whole)
        block = {k: plan[k].local(whole[k][None])[0] for k in names}
        gen = torch.Generator(device).manual_seed(8)
        x = torch.randn((1, SSM_LAYER_S, cfg.d_model), generator=gen, device=device).to(
            getattr(torch, dtype))
        r = torch.randn((1, SSM_LAYER_S, cfg.d_model), generator=gen, device=device)

        def run(p, axis):
            live = [x.clone().requires_grad_()] + [p[k].detach().requires_grad_() for k in names]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ssm.ssm_layer(dict(zip(names, live[1:])), live[0], cfg, ax=axis)
            grads = torch.autograd.grad((out.float() * r).sum(), live)
            torch.cuda.synchronize()
            return out.detach(), grads, (time.perf_counter() - t0) * 1e3

        run(block, ax)  # the first call builds its kernels' plans
        out, grads, ms = run(block, ax)
        got = [out, grads[0]] + [plan[k].gather(g[None])[0] for k, g in zip(names, grads[1:])]
        held = sum(t.numel() * t.element_size() for t in block.values())
        del grads, block
        dist.barrier(group)
        res[dtype] = {"ms": ms, "held": held,
                      "whole": sum(t.numel() * t.element_size() for t in whole.values()),
                      "width": f"d_model {cfg.d_model}, {cfg.ssm_heads} heads of "
                               f"{cfg.ssm_head_dim}, N {cfg.ssm_state}"}
        if rank == 0:
            run(whole, None)
            out1, grads1, ms1 = run(whole, None)
            want = [out1, grads1[0]] + list(grads1[1:])
            res[dtype].update(one_ms=ms1, err={
                name: float((a.float() - b.float()).abs().max() / b.float().abs().max())
                for name, a, b in zip(["output", "input"] + names, got, want)})
            del out1, grads1, want
        del got, whole, x, r
        torch.cuda.empty_cache()
    return res


def ssm_layer_check(results, smi: str) -> None:
    """15(h)'s Jamba SSM layer (``ssm_layer_rank``'s ``results`` of every
    rank) against one device: in each dtype the output and every gradient
    within ``SSM_LAYER_RTOL`` of its largest one-device magnitude (a NaN
    misses)."""
    first = results[0]
    for dtype, bar in SSM_LAYER_RTOL.items():
        r = first[dtype]
        log(f"check ssm layer {HYBRID_ARCH} SSM layer alone ({r['width']}), {dtype}, "
            f"{SSM_LAYER_S} tokens, forward and backward on (data=1, model=4) "
            f"against one device: max |mesh - one device| / max |one device| "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in r['err'].items()})} (bar {bar}); "
            f"a rank holds {r['held']:,} of {r['whole']:,} B ({r['held'] / r['whole']:.4f}); "
            f"host ms forward + backward "
            f"{', '.join(f'{x[dtype]['ms']:.1f}' for x in results)} a rank (one device "
            f"{r['one_ms']:.1f}) ({smi})")
        if not all(v <= bar for v in r["err"].values()):
            raise AssertionError(f"ssm layer {dtype}: {r['err']} off one device, above {bar}")


def heads_layer_leaves(cfg, device, seed: int = 9):
    """One attention layer's leaves at ``cfg``'s width (wq / wk / wv / wo
    and, with ``qkv_bias``, bq / bk / bv), drawn on the card from a seed at
    the init's scales (the biases at 0.02, where the init's zeros would
    leave their gradients untested), in the model dtype."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)
    D, q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    dtype = getattr(torch, cfg.dtype)

    def randn(*shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    leaves = {"wq": randn(D, q, std=D ** -0.5), "wk": randn(D, kv, std=D ** -0.5),
              "wv": randn(D, kv, std=D ** -0.5), "wo": randn(q, D, std=q ** -0.5)}
    if cfg.qkv_bias:
        leaves.update(bq=randn(q, std=0.02), bk=randn(kv, std=0.02), bv=randn(kv, std=0.02))
    return leaves


def heads_layer_inputs(cfg, device):
    """15(i)'s attention layer inputs from a seed: the stream ``x`` [B, S,
    D] in the model dtype and the output's fp32 weights ``r``."""
    import torch

    gen = torch.Generator(device).manual_seed(8)
    shape = (HEADS_LAYER_B, HEADS_LAYER_S, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=device).to(getattr(torch, cfg.dtype))
    return x, torch.randn(shape, generator=gen, device=device)


def heads_layer_run(p, cfg, x, r, axis):
    """``attention`` of the layer leaves ``p`` on ``x`` (on the model axis
    ``axis``, or one device), forward and backward of ``sum(out * r)``:
    the output, the gradients of ``x`` and of each leaf (in ``p``'s
    order) and the host ms."""
    import torch

    from repro_torch.models import attention as attn_mod

    names = list(p)
    live = [x.clone().requires_grad_()] + [p[k].detach().requires_grad_() for k in names]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = attn_mod.attention(dict(zip(names, live[1:])), live[0], cfg, positions, ax=axis)
    grads = torch.autograd.grad((out.float() * r).sum(), live)
    torch.cuda.synchronize()
    return out.detach(), grads, (time.perf_counter() - t0) * 1e3


def heads_layer_rank(rank, group, device):
    """15(i)'s qwen2.5-14b attention layer alone at its published width
    (d_model 5,120, 40 heads and 8 kv heads of 128, QKV bias) on (data=1,
    model=R), in fp32 and in bf16: each rank cuts its head block of
    ``heads_layer_leaves`` by the compute plan (t = 8 blocks of 5 q heads
    and one kv head, each held by R / 8 ranks), runs ``attention`` forward
    and backward on ``HEADS_LAYER_B`` x ``HEADS_LAYER_S`` tokens against
    ``sum(out * r)`` for a seeded ``r`` (one timed call), and returns: rank 0 the output and the stream's gradient (the same on
    every rank), each replica 0 its blocks' gradients, every rank whether
    its leaves' gradients are exact zeros (replicas other than 0 add
    nothing), its head block, the bytes it holds against the whole layer's
    and the host ms. The parent holds them against one device
    (``heads_layer_check``)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import compute_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.parallel import ModelAxis

    R = dist.get_world_size(group)
    mesh = make_host_mesh(group, data=1, model=R)
    res = {}
    for dtype in HEADS_LAYER_RTOL:
        cfg = dataclasses.replace(get_config(HEADS_LAYER_ARCH), n_layers=1, dtype=dtype)
        plan = compute_shardings(cfg, tfm.params_shape(cfg), mesh)["blocks"]["0"]["mixer"]
        ax = ModelAxis.of(cfg, mesh)
        if not (ax.attn and ax.kv and ax.head_groups == HEADS_BLOCKS):
            raise AssertionError(f"heads layer: {cfg.n_heads} / {cfg.n_kv_heads} heads on "
                                 f"{R} ranks in {ax.head_groups} blocks, expected "
                                 f"{HEADS_BLOCKS}")
        whole = heads_layer_leaves(cfg, device)
        block = {k: plan[k].local(v[None])[0] for k, v in whole.items()}
        whole_bytes = sum(t.numel() * t.element_size() for t in whole.values())
        del whole
        x, r = heads_layer_inputs(cfg, device)
        out, grads, ms = heads_layer_run(block, cfg, x, r, ax)
        leaf_grads = dict(zip(block, grads[1:]))
        res[dtype] = {"ms": ms, "block": ax.head_block, "replica": ax.replica,
                      "held": sum(t.numel() * t.element_size() for t in block.values()),
                      "whole": whole_bytes,
                      "zeros": all(not bool(g.any()) for g in leaf_grads.values()),
                      "width": f"d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads "
                               f"of {cfg.head_dim_}"}
        if not ax.replica:
            res[dtype]["grads"] = {k: g.float().cpu() for k, g in leaf_grads.items()}
        if rank == 0:
            res[dtype].update(out=out.float().cpu(), input=grads[0].float().cpu())
        del out, grads, leaf_grads, block, x, r
        dist.barrier(group)
        torch.cuda.empty_cache()
    return res


def heads_layer_one_device(dev):
    """``heads_layer_rank``'s layer whole on one device, in each dtype: the
    output, the stream's and every leaf's gradients (on the host) and the
    host ms of the call."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    one = {}
    for dtype in HEADS_LAYER_RTOL:
        cfg = dataclasses.replace(get_config(HEADS_LAYER_ARCH), n_layers=1, dtype=dtype)
        whole = heads_layer_leaves(cfg, dev)
        x, r = heads_layer_inputs(cfg, dev)
        out, grads, ms = heads_layer_run(whole, cfg, x, r, None)
        one[dtype] = {"ms": ms, "out": out.float().cpu(), "input": grads[0].float().cpu(),
                      "grads": {k: g.float().cpu() for k, g in zip(whole, grads[1:])}}
        del whole, x, r, out, grads
        torch.cuda.empty_cache()
    return one


def heads_layer_check(results, one, smi: str) -> None:
    """15(i)'s attention layer (``heads_layer_rank``'s ``results`` of every
    rank) against one device (``heads_layer_one_device``'s ``one``): in
    each dtype the output, the stream's gradient and each leaf's gradient,
    every head block's from its replica 0 (wq / wk / wv / bq / bk / bv by
    their columns, wo by its rows), within ``HEADS_LAYER_RTOL`` of its
    largest one-device magnitude (a NaN misses); every replica other than
    0 with exact-zero leaf gradients, each of the HEADS_BLOCKS = 8 blocks
    held by R / 8 ranks; a rank's bytes 1 / 8 of the layer's."""
    import torch

    R = len(results)
    for dtype, bar in HEADS_LAYER_RTOL.items():
        first, o = results[0][dtype], one[dtype]
        blocks = [r[dtype]["block"] for r in results]
        if blocks != [m // (R // HEADS_BLOCKS) for m in range(R)]:
            raise AssertionError(f"heads layer {dtype}: head blocks {blocks}")
        if not all(r[dtype]["zeros"] == bool(r[dtype]["replica"]) for r in results):
            raise AssertionError(f"heads layer {dtype}: a replica's gradients are not zeros, "
                                 f"or replica 0's are")
        err = {name: float((torch.as_tensor(first[name]) - o[name]).abs().max()
                           / o[name].abs().max()) for name in ("out", "input")}
        for name, want in o["grads"].items():
            dim = 0 if name == "wo" else want.dim() - 1
            gaps = []
            for r in results:
                if r[dtype]["replica"]:
                    continue
                got = torch.as_tensor(r[dtype]["grads"][name])
                w = got.shape[dim]
                gaps.append(float((got - want.narrow(dim, r[dtype]["block"] * w, w)).abs().max()))
            if len(gaps) != HEADS_BLOCKS:
                raise AssertionError(f"heads layer {dtype}: {len(gaps)} head blocks of {name}")
            err[name] = max(gaps) / float(want.abs().max())
        share = {r[dtype]["held"] / r[dtype]["whole"] for r in results}
        log(f"check heads layer {HEADS_LAYER_ARCH} attention layer alone ({first['width']}), "
            f"{dtype}, {HEADS_LAYER_B} x {HEADS_LAYER_S} tokens, forward and backward on "
            f"(data=1, model={R}), {HEADS_BLOCKS} head blocks of {R // HEADS_BLOCKS} ranks, "
            f"against one device: max "
            f"|mesh - one device| / max |one device| "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in err.items()})} (bar {bar}); "
            f"replicas other than 0: exact-zero leaf gradients; a rank holds "
            f"{first['held']:,} of {first['whole']:,} B of attention parameters "
            f"({first['held'] / first['whole']:.4f}); host ms forward + backward a rank "
            f"{min(r[dtype]['ms'] for r in results):.1f}-"
            f"{max(r[dtype]['ms'] for r in results):.1f} (one device {o['ms']:.1f}, run beside "
            f"the ranks) ({smi})")
        if share != {1 / HEADS_BLOCKS}:
            raise AssertionError(f"heads layer {dtype}: a rank holds {share} of the layer")
        if not all(v <= bar for v in err.values()):
            raise AssertionError(f"heads layer {dtype}: {err} off one device, above {bar}")


def heads_batch(cfg, device):
    """15(i)'s training batch: TRAIN_W sequences of TRAIN_S tokens in each of
    ``cfg``'s codebooks, drawn from a seed, and their next-token labels."""
    import torch

    toks = torch.randint(0, cfg.vocab_size, (TRAIN_W, cfg.n_codebooks, TRAIN_S + 1),
                         generator=torch.Generator().manual_seed(11)).to(device)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def heads_config():
    """15(i)'s MusicGen-medium: HEADS_AUDIO_LAYERS deep, in fp32."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(AUDIO_ARCH), n_layers=HEADS_AUDIO_LAYERS,
                               dtype="float32")


def heads_rank(rank, group, device, go, abort):
    """Phase 15(i), in each rank of a group of HEADS_TP_RANKS: attention
    whose heads the model axis does not divide, on (data=1, model=16), the
    attention in 8 head blocks of 2 ranks. The rank imports the port and
    makes its CUDA context and cuBLAS handle, then waits for the parent's
    ``go`` (``start_heads``); ``abort`` set means an earlier phase failed.
    Then qwen2.5-14b's attention layer alone (``heads_layer_rank``);
    MusicGen-medium at its published width, HEADS_AUDIO_LAYERS deep in
    fp32: (e)'s ``tp_rank`` with one RFA step (``HEADS_TP_RUNS``), its
    one-device step left to the parent (``one_device=False``), and (f)'s
    ``tps_rank`` with ``TPS_HEADS``. The seconds each took on this rank."""
    import torch

    import repro_torch.distributed.steps  # noqa: F401  (imported before the wait)
    import repro_torch.serving  # noqa: F401

    x = torch.ones((8, 8), device=device)
    float((x @ x).sum())  # the CUDA context and cuBLAS handle, before the wait
    go.wait()
    if abort.is_set():
        raise RuntimeError("phase 15(i) called off: an earlier phase failed")
    cfg = heads_config()
    out, seconds = {}, {}
    for part, run in (("layer", lambda: heads_layer_rank(rank, group, device)),
                      ("train", lambda: tp_rank(rank, group, device, cfg,
                                                heads_batch(cfg, device), rules=HEADS_TP_RUNS,
                                                split_dims=TP_AUDIO_DIMS, one_device=False)),
                      ("serve", lambda: tps_rank(rank, group, device, TPS_HEADS))):
        t0 = time.perf_counter()
        out[part] = run()
        seconds[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = seconds
    return out


def start_heads():
    """Starts phase 15(i)'s group ahead of phase 15: HEADS_TP_RANKS gloo
    ranks on the card (``heads_rank``) that start up beside phase 15's
    ranks and wait for ``go``. Returns ``(pool, future, go, abort)`` for
    ``heads_phase`` and ``stop_heads``."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.launch.mesh import spawn_ranks

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # as mesh_phase's ranks
    ctx = multiprocessing.get_context("spawn")
    go, abort = ctx.Event(), ctx.Event()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    started = pool.submit(spawn_ranks, heads_rank, HEADS_TP_RANKS, backend="gloo",
                          devices=["cuda:0"] * HEADS_TP_RANKS, args=(go, abort),
                          timeout_s=1500)
    return pool, started, go, abort


def stop_heads(heads) -> None:
    """Releases ``start_heads``' ranks (called off where ``heads_phase`` has
    not run) and waits for their processes to end."""
    pool, _, go, abort = heads
    abort.set()
    go.set()
    pool.shutdown(wait=True)


def heads_phase(dev, smi, heads):
    """Phase 15(i): sets ``go`` for ``start_heads``' ranks (``heads_rank``)
    and, while they run, computes the one-device references (the attention
    layer, the RFA step from the same seeded init, batch and mix, the
    prefill and greedy decode); then the holds: ``heads_layer_check``,
    ``tp_check`` with the bars of ``TP_BARS["heads.tp"]`` (each rank's
    peak below one device's) and ``tps_check``. Returns the launch counts
    by path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES

    launches = {}
    cfg = heads_config()
    _, started, go, _ = heads
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    go.set()
    layer_one = heads_layer_one_device(dev)
    train_one = tp_one_device(cfg, heads_batch(cfg, dev), HEADS_TP_RUNS, dev)
    serve_one = tps_one_device(dev, TPS_HEADS)
    t_one = time.perf_counter() - t0
    ranks = started.result()
    log(f"heads phase (i): {HEADS_TP_RANKS} ranks, started before phase 15, ran in "
        f"{time.perf_counter() - t0:.1f} s after the go; the one-device references beside "
        f"them {t_one:.1f} s; in the ranks (rank 0), s a part: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items()))
    torch.cuda.empty_cache()
    heads_layer_check([r["layer"] for r in ranks], layer_one, smi)
    runs = [r["train"]["runs"] for r in ranks]
    for run, one, mesh in zip(runs[0], train_one, ranks[0]["train"]["mesh"]):
        tp_merge(run, one, mesh["agg"], mesh["routes"])
    tp_check(launches, "heads.tp", f"{AUDIO_ARCH} ({HEADS_AUDIO_LAYERS} of "
             f"{get_config(AUDIO_ARCH).n_layers} layers, float32, {cfg.param_count():,} "
             f"parameters, {cfg.n_heads} heads in {HEADS_BLOCKS} blocks)", runs, HEADS_TP_RUNS, smi)
    launches["heads.serve_tp"] = {k: sum(r["serve"]["counts"][k] for r in ranks)
                                  for k in LAUNCHES}
    if any(launches["heads.serve_tp"].values()):
        raise AssertionError(f"heads serve tp: kernels launched {launches['heads.serve_tp']}")
    tps_check(dev, smi, [r["serve"] for r in ranks], TPS_HEADS, one=serve_one)
    return launches


def tp_rank(rank, group, device, cfg, batch, rules=TP_RUNS, split_dims=TP_GEMMA_DIMS,
            one_device=True):
    """Phase 15(e), in each rank of (a)'s group: (a)'s gemma-7b on the
    (data=1, model=4) mesh, where the training forward and backward run on
    this rank's compute blocks (4 of 16 heads, 4 of 16 kv heads, d_ff
    24,576 / 4, vocab 256,000 / 4; ``models/parallel.py``) and the rows go
    into the sync in those blocks; 15(g) runs it on OLMoE (16 of 64
    experts a rank). One step of each rule of ``rules`` from the seeded
    init on ``batch``: the blocks' shapes (``split_dims``, path suffix ->
    split dim, or ``(dim, width)`` for a segmented dim), the exact
    launches, the loss,
    host ms and the peak at the end of the forward and backward; (a)'s
    ``plain_sync_check``; the aggregate gathered whole. The mesh is
    (data=1, model=R) over the group's R ranks. Then, where
    ``one_device``, rank 0 alone (the others have returned) runs the same
    step with ``mesh=None`` from the same seeded init, batch and mix
    (``tp_one_device``); else rank 0 returns the aggregate and routes for
    the caller to hold against its own (``tp_merge``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed import packing, steps
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.telemetry import phase_times
    from repro_torch.utils.tree import tree_flatten, tree_flatten_with_path

    T = dist.get_world_size(group)
    mesh = make_host_mesh(group, data=1, model=T)
    runs, kept = [], []
    sync, pack, unpack, row_out = (steps.robust_gradient_sync, packing.pack_from_shardings,
                                   packing.unpack_to_shardings, packing.reshard_out)
    for i, agg in enumerate(rules):
        byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2)
        step_fn, st = steps.make_train_step(cfg, byz, mesh=mesh, lr=TRAIN_LR,
                                            n_workers=TRAIN_W, device=device)
        sh = st["shardings"]
        # the compute blocks: each leaf's split dim cut by T, the rest whole
        blocks = {}
        for (path, cpl), (_, spec) in zip(tree_flatten_with_path(sh["compute"])[0],
                                          tree_flatten_with_path(sh["params_shape"])[0]):
            d = next((v for k, v in split_dims.items() if path.endswith(k)), None)
            d, width = d if isinstance(d, tuple) else (d, None)
            shape = tuple((width or n // T) if j == d else n for j, n in enumerate(spec.shape))
            if cpl.local_shape(spec.shape) != shape:
                raise AssertionError(f"tp rank {rank}: {path}'s compute block "
                                     f"{cpl.local_shape(spec.shape)}, expected {shape}")
            blocks[path] = shape
        params = st["init_params"](torch.Generator(device).manual_seed(0))
        opt_state, worker_m = st["init_opt_state"](params), st["init_worker_m"](params)
        mix = st["aggregator"].mixing_matrix(TRAIN_W, torch.Generator().manual_seed(40 + i),
                                             device=device)
        cap = {}

        def keep_cols(*a, **kw):
            cap["buf"] = pack(*a, **kw)
            return cap["buf"]

        def keep_out(packer, local, out_shardings):
            cap.update(packer=packer, out=local, shardings=out_shardings,
                       blocks=unpack(packer, local, out_shardings))
            return cap["blocks"]

        def keep_row(vec, n, group_):
            """The replicated egress (a config without fsdp): the combined
            slice, and this rank's columns of the row it gives."""
            row = row_out(vec, n, group_)
            cap.update(out=vec, row=row[rank * vec.shape[0]:][:vec.shape[0]].clone(), n=n)
            return row

        def keep_agg(*a, **kw):
            out = sync(*a, **kw)
            cap["agg"] = out[0]
            return out

        packing.pack_from_shardings, packing.unpack_to_shardings = keep_cols, keep_out
        packing.reshard_out = keep_row
        steps.robust_gradient_sync = keep_agg
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier(group)
        reset_launches()
        t0 = time.perf_counter()
        try:
            with phase_times() as pt, moe.recorded_routes() as routes:
                params, opt_state, _, metrics = step_fn(params, opt_state, worker_m, mix,
                                                        batch)
            torch.cuda.synchronize()
        finally:
            packing.pack_from_shardings, packing.unpack_to_shardings = pack, unpack
            packing.reshard_out = row_out
            steps.robust_gradient_sync = sync
        wall = (time.perf_counter() - t0) * 1e3
        routes = on_host(routes)
        counts = dict(LAUNCHES)
        want_counts = {k: SYNC_ROUTE[agg].get(k, 0) for k in counts}
        if counts != want_counts:
            raise AssertionError(f"tp rank {rank} {agg}: launches {counts}, expected "
                                 f"{want_counts}")
        loss = metrics["loss"].float().cpu().numpy()
        if not np.isfinite(loss):
            raise AssertionError(f"tp rank {rank} {agg}: loss {loss}")
        peak, fb_peak = torch.cuda.max_memory_allocated(), pt.peaks["forward_backward"]
        # the aggregate: storage blocks of an fsdp config, else whole leaves
        combined = cap.pop("agg")
        agg_whole = (host_leaves(combined, sh["params"], rank == 0) if cfg.fsdp else
                     [t.cpu() if rank == 0 else None for t in tree_flatten(combined)[0]])
        del combined
        check = plain_sync_check(st["aggregator"], mix, cap, group)
        cap.clear()
        runs.append(dict(agg=agg, loss=loss, ms=wall, counts=counts, peak=peak,
                         fb_peak=fb_peak, check=check, blocks=blocks if i == 0 else None,
                         phase_ms=dict(pt)))
        kept.append((agg_whole, routes))
        del params, opt_state, worker_m, metrics, agg_whole
        torch.cuda.empty_cache()
    dist.barrier(group)
    if rank:
        return dict(runs=runs)
    if not one_device:
        return dict(runs=runs, mesh=[dict(agg=agg_whole, routes=routes)
                                     for agg_whole, routes in kept])
    # rank 0: the same steps on one device
    for run, one, (agg_mesh, mesh_routes) in zip(runs, tp_one_device(cfg, batch, rules, device),
                                                  kept):
        tp_merge(run, one, agg_mesh, mesh_routes)
    return dict(runs=runs)


def tp_one_device(cfg, batch, rules, device):
    """``tp_rank``'s steps on one device: for each rule of ``rules`` the step
    with ``mesh=None`` on ``batch`` and the same mix, from the seeded init
    the ranks cut their blocks from (the same whole draw): its loss,
    launches, aggregate (on the host), the largest norm of the rows it
    synced, its peak at the end of the forward and backward and its
    routes."""
    import torch

    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed import steps
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import moe
    from repro_torch.telemetry import phase_times
    from repro_torch.utils.tree import tree_flatten, tree_map

    sync, out = steps.robust_gradient_sync, []
    for i, agg in enumerate(rules):
        byz = ByzConfig(aggregator=agg, mixing="bucketing", s=2)
        step_fn, st = steps.make_train_step(cfg, byz, lr=TRAIN_LR, n_workers=TRAIN_W,
                                            device=device)
        params = st["init_params"](torch.Generator(device).manual_seed(0))
        opt_state, worker_m = st["init_opt_state"](params), st["init_worker_m"](params)
        mix = st["aggregator"].mixing_matrix(TRAIN_W, torch.Generator().manual_seed(40 + i),
                                             device=device)
        seen = {}

        def keep(messages, *a, **kw):
            leaves = tree_flatten(messages)[0]
            sq = [sum(float(torch.linalg.vector_norm(x[w], dtype=torch.float32)) ** 2
                      for x in leaves) for w in range(TRAIN_W)]
            seen["row_norm"] = max(sq) ** 0.5
            res = sync(messages, *a, **kw)
            seen["agg"] = tree_map(lambda t: t.cpu(), res[0])
            return res

        steps.robust_gradient_sync = keep
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            with phase_times() as pt, moe.recorded_routes() as routes:
                params, opt_state, _, metrics = step_fn(params, opt_state, worker_m, mix, batch)
            torch.cuda.synchronize()
        finally:
            steps.robust_gradient_sync = sync
        out.append(dict(loss=float(metrics["loss"]), counts=dict(LAUNCHES),
                        agg=tree_flatten(seen["agg"])[0], row_norm=seen["row_norm"],
                        fb_peak=pt.peaks["forward_backward"], routes=on_host(routes)))
        del params, opt_state, worker_m, metrics, seen
        torch.cuda.empty_cache()
    return out


def tp_merge(run, one, agg_mesh, mesh_routes) -> None:
    """``run`` (a rank's step of ``tp_rank``) given the one-device step
    ``one`` (``tp_one_device``'s): its loss, launches, the gap of the mesh
    aggregate ``agg_mesh`` (whole leaves) over the largest row norm, its
    peak, and the assignments ``mesh_routes`` routed otherwise."""
    import torch

    d2 = sum(torch.sum(torch.square(torch.as_tensor(a).float() - b.float()))
             for a, b in zip(agg_mesh, one["agg"]))
    run.update(one_loss=one["loss"], one_counts=one["counts"],
               agg_err=float(torch.sqrt(d2)) / one["row_norm"], row_norm=one["row_norm"],
               one_fb_peak=one["fb_peak"],
               routed=routed_otherwise(mesh_routes, one["routes"]) + (
                   sum(int(idx.numel()) for idx, _ in one["routes"]),))


def seeded_params(cfg, device, mesh=None, seed: int = 0):
    """``cfg``'s parameters drawn leaf by leaf on the card, each leaf from a
    generator seeded by its index (the init's scales: embeddings 0.02, a
    weight ``[..., d_in, d_out]`` (1 / d_in)^0.5, norms ones), so every
    process draws the same numbers. With ``mesh``, this rank's compute
    blocks: each whole leaf cut by the compute plan, as
    ``sharding.compute_blocks`` cuts a whole tree, and freed before the
    next is drawn; else the whole leaves."""
    import torch

    from repro_torch.distributed.sharding import compute_shardings
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_flatten, tree_flatten_with_path, tree_unflatten

    specs = tfm.params_shape(cfg)
    flat, treedef = tree_flatten_with_path(specs)
    plan = None if mesh is None else tree_flatten(compute_shardings(cfg, specs, mesh))[0]
    leaves = []
    for i, (path, s) in enumerate(flat):
        if path.endswith("scale"):
            whole = torch.ones(s.shape, dtype=s.dtype, device=device)
        else:
            gen = torch.Generator(device).manual_seed(seed * 10_000 + i)
            std = 0.02 if path.split("/")[0] == "embed" else s.shape[-2] ** -0.5
            whole = torch.empty(s.shape, dtype=s.dtype, device=device)
            for part in whole.view(-1, s.shape[-1]).split(4096):
                part.copy_(torch.randn(part.shape, generator=gen, device=device) * std)
        leaves.append(whole if plan is None else plan[i].local(whole))
        del whole
    return tree_unflatten(treedef, leaves)


def tps_config(dtype: str, n_layers: int, arch: str = FSDP_ARCH):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=n_layers, dtype=dtype)


def on_host(routes):
    """``models/moe.py::recorded_routes``'s list, each MoE layer's top-k
    experts and kept assignments, copied to the host."""
    return [(idx.cpu(), keep.cpu()) for idx, keep in routes]


def moe_layers(cfg) -> int:
    """How many MoE layers a forward of ``cfg`` runs."""
    return sum(ff == "moe" for _, ff in cfg.pattern_) * cfg.n_periods


def routed_otherwise(routes, want) -> tuple[int, int]:
    """How many (token, expert) assignments of ``routes`` are not among
    ``want``'s for the same token and layer (each layer's ``[T, K]`` top-k
    compared as sets), and how many kept assignments differ in count."""
    import torch

    other, kept = 0, 0
    for (idx, keep), (idx1, keep1) in zip(routes, want, strict=True):
        idx, keep, idx1, keep1 = map(torch.as_tensor, (idx, keep, idx1, keep1))
        same = (idx[:, :, None] == idx1[:, None, :]).any(-1)
        other += int((~same).sum())
        kept += abs(int(keep.sum()) - int(keep1.sum()))
    return other, kept


def tps_inputs(cfg, spec):
    """Phase 15(f)'s tokens of ``cfg``'s vocab from a seed (each row's K
    codebooks for a codebook model): the prefill's, the greedy decode's
    prompt (its first ``spec["prompt"]`` tokens where given), the seeded
    4-row step's and the one-row step's."""
    import torch

    vocab, books = cfg.vocab_size, ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    gen = torch.Generator().manual_seed(41)
    out = {"prefill": torch.randint(0, vocab, TPS_PREFILL[:1] + books + TPS_PREFILL[1:],
                                    generator=gen),
           "prompt": torch.randint(0, vocab, (4,) + books + (MESH_DECODE_PROMPT,),
                                   generator=gen),
           "rows": torch.randint(0, vocab, (4,) + books, generator=gen),
           "row": torch.randint(0, vocab, (1,) + books, generator=gen)}
    out["prompt"] = out["prompt"][..., :spec["prompt"]]
    return out


def one_device_decode(cfg):
    """``decode_step`` of ``cfg`` in the form of a serving step: ``(params,
    cache, token, position) -> (logits, cache)``."""
    from repro_torch.models import transformer as tfm

    return lambda params, cache, token, pos: tfm.decode_step(params, cfg, cache, token, pos)


def greedy_logits(serve, params, cache, prompt, n_new, gather=None, every_prompt=False):
    """Greedy decode of the global ``prompt`` rows (``[B, S]``, or ``[B, K,
    S]`` for codebooks) through ``serve(params, cache, token, position)``
    (``gather`` puts a batch-sharded step's logits together): the chosen
    tokens ``[B, n_new]`` (``[B, n_new, K]``), the logits at the
    prompt's last position and at the last step (host; with
    ``every_prompt`` a third entry, the logits of every prompt position
    ``[S, B, ...]``), and the host ms of the steps after the prompt's
    last."""
    import torch

    toks, kept, prompt_logits = [], [], []
    S = prompt.shape[-1]
    t0 = time.perf_counter()
    for pos in range(S + n_new - 1):
        if pos == S:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        tok = prompt[..., pos] if pos < S else toks[-1]
        logits, cache = serve(params, cache, tok, pos)
        logits = logits if gather is None else gather(logits)
        if pos >= S - 1:
            toks.append(torch.argmax(logits, dim=-1))
        if pos in (S - 1, S + n_new - 2):
            kept.append(logits.float().cpu())
        if every_prompt and pos < S:
            prompt_logits.append(logits.float().cpu())
    torch.cuda.synchronize()
    if every_prompt:
        kept.append(torch.stack(prompt_logits))
    return (torch.stack(toks, dim=1).cpu(), kept,
            (time.perf_counter() - t0) * 1e3 / max(n_new - 1, 1))


def tps_rank(rank, group, device, spec):
    """Phase 15(f), in each rank of (a)'s group: gemma-7b served at its
    published width on each rank's compute blocks (4 / T of 16 heads and kv
    heads, d_ff and vocab over T; ``models/parallel.py``); 15(g) serves
    OLMoE so (64 / T experts a rank), 15(h) Mamba2 (24 / T of its SSM
    heads), 15(i) MusicGen (24 heads in 8 blocks of 2 ranks on (1, 16)).
    ``spec`` (``TPS_GEMMA``, ``TPS_MOE``, ``TPS_SSM``, ``TPS_HEADS``) names
    the arch and the depths. At ``spec["layers"]`` deep, in each dtype of
    ``spec["dtypes"]``: on (data=1, model=R) over the group's R ranks the
    prefill's last-position logits (and each MoE
    layer's routing) and a greedy decode of 4 slots, ``spec["new"]``
    tokens after the first ``spec["prompt"]`` tokens of the prompt, and,
    where ``spec["one_row"]``, one step on a one-row ATTN_S cache
    (positions over model); on (2, 2), where ``spec["rows"]``, one
    batch-sharded step on a seeded 4-row cache and, where
    ``spec["one_row"]``, one step on the one-row cache (positions over
    data, kv heads over model). Then, unless ``spec["full"]`` is 0, one
    bf16 run at ``spec["full"]`` layers on (1, R): prefill ms, decode ms
    a token, the peak. Each rank checks that it holds exactly the plan's
    blocks."""
    import math

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.sharding import compute_shardings, local_zeros
    from repro_torch.distributed.steps import gather_batch, make_prefill_step, make_serve_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_flatten, tree_flatten_with_path, tree_map

    arch, n_new, R = spec["arch"], spec["new"], dist.get_world_size(group)
    meshes = {(1, R): make_host_mesh(group, data=1, model=R)}
    if spec["rows"] or spec["one_row"]:
        meshes[(2, 2)] = make_host_mesh(group, data=2, model=2)
    T = {shape: shape[1] for shape in meshes}
    inputs = {k: v.to(device)
              for k, v in tps_inputs(tps_config("float32", 1, arch), spec).items()}

    def blocks(cfg, mesh):
        """This rank's blocks, asserted to be the plan's and nothing more;
        their bytes, and those of its experts."""
        params = seeded_params(cfg, device, mesh)
        specs = tfm.params_shape(cfg)
        flat = tree_flatten_with_path(specs)[0]
        want = [pl.local_shape(s.shape) for (_, s), pl in zip(
            flat, tree_flatten(compute_shardings(cfg, specs, mesh))[0])]
        leaves = tree_flatten(params)[0]
        got = [tuple(x.shape) for x in leaves]
        held = sum(x.untyped_storage().nbytes() for x in leaves)
        size = sum(math.prod(w) * s.dtype.itemsize for w, (_, s) in zip(want, flat))
        if got != want or held != size:
            raise AssertionError(f"tps rank {rank}: holds {held} B in {got}, the plan's "
                                 f"blocks are {want} ({size} B)")
        experts = sum(x.untyped_storage().nbytes() for x, (path, _) in zip(leaves, flat)
                      if "/ff/w_" in path and x.dim() == 4)
        return params, held, experts

    def seeded_step(cfg, mesh, params, rows, length, token):
        serve, _, pls = make_serve_step(cfg, mesh, InputShape("seeded", length, rows, "decode"),
                                        device=device)
        cache = tree_map(lambda x, pl: pl.local(x),
                         seeded_cache(cfg, length - 1, device, batch=rows, length=length), pls)
        logits, _ = serve(params, cache, token, length - 1)
        return gather_batch(logits, mesh, rows).float().cpu(), pls["0"]["k"].spec

    torch.cuda.synchronize()
    reset_launches()
    out = {}
    for dtype in spec["dtypes"]:
        cfg = tps_config(dtype, spec["layers"], arch)
        res = out[dtype] = {"held": {}}
        for shape, mesh in meshes.items():
            params, res["held"][shape], _ = blocks(cfg, mesh)
            if shape[0] == 1:
                torch.cuda.synchronize()
                dist.barrier(group)  # rank 0 may come from (e)'s one-device steps
                t0 = time.perf_counter()
                with moe.recorded_routes() as routes:
                    res["prefill"] = make_prefill_step(cfg, mesh, device=device)(
                        params, {"tokens": inputs["prefill"]}).float().cpu()
                res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                res["routes"] = on_host(routes)
                serve, cache_spec, pls = make_serve_step(
                    cfg, mesh, InputShape("serve", MESH_DECODE_CACHE, 4, "decode"), device=device)
                with moe.recorded_routes() as routes:
                    res["tokens"], res["greedy"], res["decode_ms"] = greedy_logits(
                        serve, params, local_zeros(cache_spec, pls, device), inputs["prompt"],
                        n_new, every_prompt=spec["pooled"])
                res["greedy_routes"] = on_host(
                    routes[:moe_layers(cfg) * inputs["prompt"].shape[-1]])
                first = pls["0"]  # a KV cache's k, or an SSM layer's conv ring and state
                res["greedy_spec"] = first["k"].spec if "k" in first else {
                    k: pl.spec for k, pl in first.items()}
            elif spec["rows"]:
                res["rows"], res["rows_spec"] = seeded_step(cfg, mesh, params, 4,
                                                            MESH_DECODE_CACHE, inputs["rows"])
            if spec["one_row"]:
                res[f"row_{shape}"] = seeded_step(cfg, mesh, params, 1, ATTN_S, inputs["row"])
            del params
            torch.cuda.empty_cache()
    out["T"], out["counts"] = T, dict(LAUNCHES)
    if not spec["full"]:
        return out
    # one bf16 run at full depth on (1, R)
    mesh = meshes[(1, R)]
    cfg = tps_config("bfloat16", spec["full"], arch)
    params, held, experts = blocks(cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier(group)
    t0 = time.perf_counter()
    prefill = make_prefill_step(cfg, mesh, device=device)(params, {"tokens": inputs["prefill"]})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    serve, cache_spec, pls = make_serve_step(
        cfg, mesh, InputShape("serve", MESH_DECODE_CACHE, 4, "decode"), device=device)
    toks, _, decode_ms = greedy_logits(serve, params, local_zeros(cache_spec, pls, device),
                                       inputs["prompt"], TPS_FULL_NEW)
    out["full"] = dict(held=held, experts=experts, prefill=prefill.float().cpu(),
                       prefill_ms=prefill_ms, tokens=toks, decode_ms=decode_ms,
                       peak=torch.cuda.max_memory_allocated())
    out["counts"] = dict(LAUNCHES)
    del params, prefill
    torch.cuda.empty_cache()
    return out


def tps_one_device(dev, spec):
    """``tps_check``'s one-device side of ``spec`` (as ``tps_rank``'s): the
    same seeded parameters whole on the card through ``make_prefill_step``
    and ``decode_step``, in each dtype of ``spec["dtypes"]``: the whole
    bytes, the prefill's last-position logits and routes, the greedy
    decode's tokens and logits, the seeded steps' logits and the host
    ms."""
    import torch

    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    arch, four = spec["arch"], spec["rows"]
    inputs = {k: v.to(dev) for k, v in tps_inputs(tps_config("float32", 1, arch), spec).items()}
    one = {}
    for dtype in spec["dtypes"]:
        cfg = tps_config(dtype, spec["layers"], arch)
        params = seeded_params(cfg, dev)
        o = one[dtype] = {"whole": nbytes(params)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe.recorded_routes() as routes:
            o["prefill"] = make_prefill_step(cfg, device=dev)(
                params, {"tokens": inputs["prefill"]}).float().cpu()
        o["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        o["routes"] = on_host(routes)
        with moe.recorded_routes() as routes:
            o["tokens"], o["greedy"], o["decode_ms"] = greedy_logits(
                one_device_decode(cfg), params,
                tfm.init_cache(cfg, 4, MESH_DECODE_CACHE, device=dev),
                inputs["prompt"], spec["new"], every_prompt=spec["pooled"])
        o["greedy_routes"] = on_host(routes[:moe_layers(cfg) * inputs["prompt"].shape[-1]])
        for key, rows, length in (("rows", 4, MESH_DECODE_CACHE), ("row", 1, ATTN_S)):
            if (key == "row" and not spec["one_row"]) or (key == "rows" and not four):
                continue
            cache = seeded_cache(cfg, length - 1, dev, batch=rows, length=length)
            o[key] = tfm.decode_step(params, cfg, cache, inputs[key], length - 1)[0].float().cpu()
            del cache
        del params
        torch.cuda.empty_cache()
    return one


def tps_check(dev, smi: str, tps, spec, one=None) -> None:
    """Phase 15(f) (and 15(g)'s, (h)'s and (i)'s: ``spec`` as ``tps_rank``'s)
    against one device (``tps_one_device``, or its result ``one``). Every
    rank's outputs the same bits; in fp32 the greedy tokens equal and every
    logit within ``spec["tol"]``; in bf16, where ``spec["dtypes"]`` has
    it, each output no further from the fp32 one-device logits than
    ``SEQ_BF16_RATIO`` x the one-device bf16 run's; a MoE prefill's
    assignments routed otherwise than one device's printed; at full depth
    the prefill and decode times and the peak a rank beside one
    device's."""
    import numpy as np
    import torch

    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.models import transformer as tfm

    label, arch, layers = spec["label"], spec["arch"], spec["layers"]
    n_new, tol, four, dtypes = spec["new"], spec["tol"], spec["rows"], spec["dtypes"]
    R = len(tps)
    rows_1 = [f"row_{(1, R)}", "row_(2, 2)"] if spec["one_row"] else []
    first = tps[0]
    for rank, r in enumerate(tps):
        for key in dtypes:
            for item in ["prefill", "tokens"] + ["rows"] * four + rows_1:
                a, b = r[key][item], first[key][item]
                a, b = (a[0], b[0]) if isinstance(a, tuple) else (a, b)
                if not np_same_bits(np.asarray(a), np.asarray(b)):
                    raise AssertionError(f"{label} rank {rank}: {key} {item} differs from "
                                         "rank 0's")
    inputs = {k: v.to(dev) for k, v in tps_inputs(tps_config("float32", 1, arch), spec).items()}
    one = one or tps_one_device(dev, spec)

    def pairs(key):
        """(label, mesh output, one-device output) of every held output."""
        m, o = first[key], one[key]
        held = [(f"prefill (1, {R})", m["prefill"], o["prefill"]),
                (f"greedy (1, {R}), last prompt position", m["greedy"][0], o["greedy"][0])]
        if four:
            held.append(("4-row step (2, 2)", m["rows"], o["rows"]))
        else:  # the last greedy step's logits
            held.append((f"greedy (1, {R}), last step", m["greedy"][1], o["greedy"][1]))
        if spec["one_row"]:
            held += [(f"1-row step (1, {R})", m[f"row_{(1, R)}"][0], o["row"]),
                     ("1-row step (2, 2)", m["row_(2, 2)"][0], o["row"])]
        return [(name, torch.as_tensor(a), b) for name, a, b in held]

    if not np.array_equal(first["float32"]["tokens"], one["float32"]["tokens"].numpy()):
        raise AssertionError(f"{label} fp32 greedy tokens {first['float32']['tokens'].tolist()} "
                             f"differ from one device's {one['float32']['tokens'].tolist()}")
    fp32 = {}
    for name, m, o in pairs("float32"):
        fp32[name] = float((m - o).abs().max())
        if not fp32[name] <= tol:
            raise AssertionError(f"{label} fp32 {name}: max |mesh - one device| {fp32[name]}")
    bf16, pooled, agree16 = {}, "", ""
    if "bfloat16" in dtypes:
        for (name, m, o), (_, _, o32) in zip(pairs("bfloat16"), pairs("float32")):
            bf16[name] = (float((m - o32).abs().max()), float((o - o32).abs().max()))
            if not bf16[name][0] <= SEQ_BF16_RATIO * bf16[name][1]:
                raise AssertionError(f"{label} bf16 {name}: {bf16[name][0]} off fp32, above "
                                     f"{SEQ_BF16_RATIO} x the one device's {bf16[name][1]}")
        agree = float(np.mean(first["bfloat16"]["tokens"] == one["bfloat16"]["tokens"].numpy()))
        agree16 = (f"; bf16 max |x - fp32 one device| (mesh, one device) "
                   f"{json.dumps({k: [float(f'{x:.3g}') for x in v] for k, v in bf16.items()})}"
                   f" (bar {SEQ_BF16_RATIO} x one device's"
                   f"{', and pooled' if spec['pooled'] else ''}); bf16 greedy tokens agreeing "
                   f"with one device's {agree:.3f}")
    if spec["pooled"]:  # and the mean over every held row of its max |x - fp32 one device|
        def row_dist(a, b):
            return (torch.as_tensor(a) - b).abs().reshape(-1, a.shape[-1]).amax(-1)

        m16, o16, o32 = first["bfloat16"], one["bfloat16"], one["float32"]
        rows = [(m16["greedy"][2], o16["greedy"][2], o32["greedy"][2])] + [
            (m, o, x) for (name, m, o), (_, _, x) in zip(pairs("bfloat16"), pairs("float32"))
            if not name.startswith("greedy")]
        dm = torch.cat([row_dist(m, x) for m, _, x in rows])
        do = torch.cat([row_dist(o, x) for _, o, x in rows])
        pooled = (f"; pooled over {dm.numel()} rows (every prompt position of the greedy "
                  f"decode, the prefill's and the 4-row step's): mean max |x - fp32 one "
                  f"device| mesh {float(dm.mean()):.4g}, one device {float(do.mean()):.4g} "
                  f"(bar {SEQ_BF16_RATIO} x one device's), median {float(dm.median()):.4g} / "
                  f"{float(do.median()):.4g}; the prompt's decode assignments routed "
                  f"otherwise than fp32 one device's: mesh "
                  f"{routed_otherwise(m16['greedy_routes'], o32['greedy_routes'])[0]}, one "
                  f"device {routed_otherwise(o16['greedy_routes'], o32['greedy_routes'])[0]}")
        if not float(dm.mean()) <= SEQ_BF16_RATIO * float(do.mean()):
            raise AssertionError(f"{label} bf16: mean row distance from fp32 "
                                 f"{float(dm.mean())} above {SEQ_BF16_RATIO} x the one "
                                 f"device's {float(do.mean())}")
    held = {k: [r[k]["held"] for r in tps] for k in dtypes}
    two = {k: f" / {held[k][0][(2, 2)]:,}" if (2, 2) in held[k][0] else ""
           for k in held}
    routing = ""
    if one["float32"]["routes"]:
        other = {k: routed_otherwise(first[k]["routes"], one[k]["routes"])
                 for k in ("float32", "bfloat16")}
        n = sum(int(idx.numel()) for idx, _ in one["float32"]["routes"])
        routing = (f"; the prefill's (token, expert) assignments routed otherwise than one "
                   f"device's, of {n:,}: fp32 {other['float32'][0]}, bf16 "
                   f"{other['bfloat16'][0]} (kept counts differing by {other['float32'][1]} / "
                   f"{other['bfloat16'][1]})")
    one_row = (f", 1 row (1, {R}) {first['float32'][f'row_{(1, R)}'][1]}, (2, 2) "
               f"{first['float32']['row_(2, 2)'][1]}" if spec["one_row"] else "")
    rows_spec = f", 4 rows {first['float32']['rows_spec']}" if four else ""
    whole = one["float32"]["whole"]
    log(f"check {label} {arch} ({layers} layers) served on compute blocks, {R} gloo "
        f"ranks on one card, every rank the same bits; bytes a rank (1, {R})"
        f"{' / (2, 2)' if two['float32'] else ''}: "
        + ", ".join(f"{'fp32' if k == 'float32' else 'bf16'} {held[k][0][(1, R)]:,}{two[k]}"
                    for k in dtypes)
        + f" (the plan's blocks, asserted in each rank; "
        f"{held['float32'][0][(1, R)] / whole:.4f} of the whole {whole:,} B on (1, {R})); "
        f"caches: greedy {first['float32']['greedy_spec']}{rows_spec}{one_row}; fp32: {n_new} "
        f"greedy tokens of 4 slots equal one device's, max |mesh - one device| "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in fp32.items()})} (bar {tol})"
        f"{agree16}{pooled}{routing}")
    log(f"{label} {arch} ({layers} layers) on (data=1, model={R}): prefill B = "
        f"{TPS_PREFILL[0]} x {TPS_PREFILL[1]} host ms "
        + " / ".join(", ".join(f"{r[k]['prefill_ms']:.1f}" for r in tps) for k in dtypes)
        + " (one device " + " / ".join(f"{one[k]['prefill_ms']:.1f}" for k in dtypes)
        + "); decode of 4 slots, ms a token after the prompt "
        + " / ".join(", ".join(f"{r[k]['decode_ms']:.1f}" for r in tps) for k in dtypes)
        + " (one device " + " / ".join(f"{one[k]['decode_ms']:.1f}" for k in dtypes)
        + f") ({' / '.join(dtypes)}) ({smi})")
    if not spec["full"]:
        return
    # the full-depth bf16 run on one device
    cfg = tps_config("bfloat16", spec["full"], arch)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    params = seeded_params(cfg, dev)
    whole = nbytes(params)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prefill = make_prefill_step(cfg, device=dev)(params, {"tokens": inputs["prefill"]})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks, _, decode_ms = greedy_logits(one_device_decode(cfg), params,
                                       tfm.init_cache(cfg, 4, MESH_DECODE_CACHE, device=dev),
                                       inputs["prompt"], TPS_FULL_NEW)
    peak = torch.cuda.max_memory_allocated() - live
    full = [r["full"] for r in tps]
    for rank, f in enumerate(full):
        if not (np.isfinite(f["prefill"]).all() and f["prefill"].shape == prefill.shape):
            raise AssertionError(f"{label} full depth rank {rank}: prefill logits "
                                 f"{f['prefill'].shape} not finite")
        if not np_same_bits(f["prefill"], full[0]["prefill"]):
            raise AssertionError(f"{label} full depth rank {rank}: prefill differs from rank "
                                 "0's")
    prefill = prefill.float().cpu().numpy()
    gap = float(np.abs(full[0]["prefill"] - prefill).max())
    next_equal = float(np.mean(full[0]["prefill"].argmax(-1) == prefill.argmax(-1)))
    experts = (f" ({', '.join(f'{f['experts']:,}' for f in full)} B of experts)"
               if full[0]["experts"] else "")
    log(f"{label} {arch} at full depth ({spec['full']} layers, bf16, {whole:,} B whole) on "
        f"(data=1, model={R}), {R} gloo ranks on one card: each rank holds "
        f"{', '.join(f'{f['held']:,}' for f in full)} B{experts} "
        f"({full[0]['held'] / whole:.4f} of the whole); peak a rank "
        f"{', '.join(f'{f['peak'] / 1e9:.2f}' for f in full)} GB against one device's "
        f"{peak / 1e9:.2f} GB; prefill B = {TPS_PREFILL[0]} x {TPS_PREFILL[1]} host ms "
        f"{', '.join(f'{f['prefill_ms']:.1f}' for f in full)} (one device {prefill_ms:.1f}); "
        f"decode of 4 slots, ms a token {', '.join(f'{f['decode_ms']:.1f}' for f in full)} (one "
        f"device {decode_ms:.1f}); max |mesh - one device| of the prefill's logits {gap:.3g}, "
        f"next tokens equal {next_equal:.3f}, {TPS_FULL_NEW} greedy tokens agreeing "
        f"{float(np.mean(full[0]['tokens'] == toks.numpy())):.3f} ({smi})")
    del params, prefill
    torch.cuda.empty_cache()


def host_leaves(tree, placements, keep: bool):
    """Each leaf of ``tree`` (this rank's blocks) gathered whole, leaf by
    leaf, in host memory where ``keep`` (else ``None``): the gathers run
    on every rank."""
    from repro_torch.utils.tree import tree_flatten

    out = []
    for block, pl in zip(tree_flatten(tree)[0], tree_flatten(placements)[0]):
        whole = pl.gather(block)
        out.append(whole.cpu() if keep else None)
        del whole
    return out


def plain_sync_check(aggregator, mix, cap, group):
    """Phase 15(a)'s check of one step's sync, in each rank: the plain
    route of the same sharded sync (``ref``'s mix, then RFA's Weiszfeld
    with the ``[W]`` norms all-reduced, or CM) on this rank's column slice
    ``cap["buf"]`` of the packed rows, against the kernel route's combined
    slice ``cap["out"]`` and against its egress: the blocks
    ``cap["blocks"]`` of an fsdp config (the plain slice put through
    ``unpack_to_shardings``), else this rank's columns ``cap["row"]`` of the
    replicated row. Both as ``|kernel - plain|_2 / max_i |x_i|_2`` over
    all ranks' columns."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.packing import unpack_to_shardings
    from repro_torch.kernels import ref
    from repro_torch.utils.tree import tree_flatten

    def summed(t):
        dist.all_reduce(t, group=group)
        return t

    buf, base = cap.pop("buf"), aggregator.base
    cols = buf.shape[1]
    row_norm = float(torch.sqrt(torch.max(summed(torch.linalg.vector_norm(buf, dim=1) ** 2))))
    mixed = ref.bucket_mix(mix, buf)
    del buf
    if base.name == "cm":
        out = ref.cwise_median(mixed)
    else:
        c = torch.full((mixed.shape[0],), 1.0 / mixed.shape[0], dtype=torch.float32,
                       device=mixed.device)
        for _ in range(base.n_iters):
            w = 1.0 / torch.sqrt(summed(ref.residual_norms(mixed, c)) + base.eps**2)
            c = w / torch.sum(w)
        out = ref.bucket_mix(c[None, :], mixed)[0]
    del mixed
    slice_err = float(torch.sqrt(summed(torch.sum(torch.square(cap["out"] - out))[None])))
    if "blocks" in cap:
        blocks = unpack_to_shardings(cap["packer"], out, cap["shardings"])
        del out
        d2 = sum(torch.sum(torch.square(a.float() - b.float()))
                 for a, b in zip(tree_flatten(cap["blocks"])[0], tree_flatten(blocks)[0]))
    else:  # the row's columns past n_pad are no one's
        d2 = torch.sum(torch.square(cap["row"] - out[:cap["row"].shape[0]]))
        del out
    egress_err = float(torch.sqrt(summed(d2.reshape(1))))
    return dict(slice=slice_err / row_norm, egress=egress_err / row_norm, cols=cols,
                rows=int(mix.shape[1]), buckets=int(mix.shape[0]))


def _n_pad(specs) -> int:
    """The packed row's width for a parameter tree (``GradPacker``'s)."""
    import math

    from repro_torch.kernels.pairwise_gram import TILE_D
    from repro_torch.utils.tree import tree_flatten

    return sum(-(-math.prod(s.shape) // TILE_D) * TILE_D for s in tree_flatten(specs)[0])


def mesh_smoke_steps(dev, agg, fsdp, mesh):
    """Phase 15(b): gemma's smoke-width step (fsdp on or off) on ``mesh``
    (``None``: one device), GROUP_STEPS steps of tests/test_system.py's
    stream with mixes from one seeded generator. Returns the step's state,
    the whole parameters and optimizer momenta (gathered on a mesh), the
    losses and each step's launches."""
    import dataclasses

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ByzConfig
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(smoke_config(FSDP_ARCH), fsdp=fsdp)
    step_fn, state = make_train_step(cfg, ByzConfig(aggregator=agg, mixing="bucketing", s=2),
                                     mesh=mesh, lr=SMOKE_LR, n_workers=TRAIN_W, device=dev)
    params = state["init_params"](torch.Generator().manual_seed(0))
    opt_state, worker_m = state["init_opt_state"](params), state["init_worker_m"](params)
    gen = torch.Generator().manual_seed(1)
    losses, counts = [], []
    for _ in range(GROUP_STEPS):
        batch = bigram_batch(gen, cfg.vocab_size, 8, 64, dev, cfg)
        mix = state["aggregator"].mixing_matrix(TRAIN_W, gen, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        params, opt_state, worker_m, metrics = step_fn(params, opt_state, worker_m, mix, batch)
        torch.cuda.synchronize()
        counts.append(dict(LAUNCHES))
        losses.append(float(metrics["loss"]))
    sh = state["shardings"]
    whole = (lambda t: t) if sh is None else (
        lambda t: tree_map(lambda b, pl: pl.gather(b), t, sh["params"]))
    return dict(state=state, blocks=(params, opt_state), params=whole(params),
                m=whole(opt_state.m), losses=losses, counts=counts)


def mesh_smoke_rank(rank, group, device, shape, ckpt_dir):
    """Phase 15(b) and (d), in each rank: the smoke-width steps with fsdp on
    and off on the mesh ``shape``; on (4, 1) the fsdp RFA state is saved
    from the mesh and restored onto it (bit for bit, checked here)."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map_with_path

    mesh = make_host_mesh(group, *shape)
    out = {}
    for agg in ("rfa", "cm"):
        for fsdp in (True, False):
            run = mesh_smoke_steps(device, agg, fsdp, mesh)
            want = [{k: SYNC_ROUTE[agg].get(k, 0) for k in c} for c in run["counts"]]
            if run["counts"] != want:
                raise AssertionError(f"mesh {shape} rank {rank} {agg} fsdp {fsdp}: launches "
                                     f"{run['counts']}, expected {want}")
            if fsdp and agg == "rfa" and shape == (4, 1):
                sh = run["state"]["shardings"]
                params, opt_state = run["blocks"]
                tree = {"params": params, "opt_state": opt_state, "worker_m": {}}
                placements = {"params": sh["params"], "opt_state": sh["opt_state"],
                              "worker_m": {}}
                save_checkpoint(ckpt_dir, GROUP_STEPS, tree, shardings=placements)
                like = tree_map_with_path(lambda _, x: torch.zeros_like(x), tree)
                back = restore_checkpoint(ckpt_dir, like, shardings=placements)
                for (_, a), (_, b) in zip(tree_flatten_with_path(tree)[0],
                                          tree_flatten_with_path(back)[0]):
                    if not same_bits(b, a):
                        raise AssertionError(f"rank {rank}: the mesh restore differs")
            out[(agg, fsdp)] = dict(params=run["params"], m=run["m"], losses=run["losses"],
                                    counts=run["counts"])
    return out


def mesh_rank(rank, group, device, ckpt_dir, payload):
    """Phase 15(b) and (d) on each mesh of ``MESH_SHAPES``, then (c), in
    one group. CUDA's deterministic algorithms are on for (b), so that two
    runs of a step (fsdp on and off) compute the same worker gradients
    (the embedding's backward otherwise adds atomically, in no fixed
    order)."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = {shape: mesh_smoke_rank(rank, group, device, shape, ckpt_dir)
               for shape in MESH_SHAPES}
    finally:
        torch.use_deterministic_algorithms(False)
    out["serve"] = serve_mesh_rank(rank, group, device, payload)
    return out


def serve_mesh_rank(rank, group, device, payload):
    """Phase 15(c), in each rank: TinyLlama-1.1B at full width served on the
    (data=4, model=1) mesh: the sharded prefill, the batch-sharded greedy
    loop, one sequence-sharded step on a seeded cache (bf16 and fp32), and
    the sequence-sharded greedy loop (bf16 and fp32); with the launch
    counts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.sharding import local_zeros
    from repro_torch.distributed.steps import gather_batch, make_prefill_step, make_serve_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map

    cfg = get_config("tinyllama-1.1b")
    mesh = make_host_mesh(group, data=SYNC_RANKS, model=1)
    params = tfm.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    reset_launches()
    out = {}
    t0 = time.perf_counter()
    out["prefill"] = make_prefill_step(cfg, mesh, device=device)(
        params, {"tokens": torch.as_tensor(payload["prefill"])})
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3

    def greedy(serve, p, cache, prompt, n_new):
        """Greedy decode of the global ``prompt`` rows; a batch-sharded
        step's logits are gathered (``gather_batch``) into the next global
        tokens."""
        gather = functools.partial(gather_batch, mesh=mesh, batch=prompt.shape[0])
        return greedy_logits(serve, p, cache, prompt.to(device), n_new, gather)[0]

    prompt = torch.as_tensor(payload["decode"])
    serve, spec, pls = make_serve_step(
        cfg, mesh, InputShape("serve", MESH_DECODE_CACHE, prompt.shape[0], "decode"),
        device=device)
    out["batch_spec"] = pls["0"]["k"].spec
    t0 = time.perf_counter()
    out["batch_tokens"] = greedy(serve, params, local_zeros(spec, pls, device), prompt,
                                 MESH_DECODE_STEPS)
    torch.cuda.synchronize()
    out["batch_ms"] = (time.perf_counter() - t0) * 1e3
    # one step on a seeded cache, in bf16 and in fp32
    for c, p in ((cfg, params), (dataclasses.replace(cfg, dtype="float32"),
                                 tree_map(lambda t: t.float(), params))):
        serve, spec, pls = make_serve_step(c, mesh, InputShape("long", ATTN_S, 1, "decode"),
                                           device=device)
        out["seq_spec"] = pls["0"]["k"].spec
        whole = seeded_cache(c, ATTN_S - 1, device)
        cache = tree_map(lambda x, pl: pl.local(x), whole, pls)
        del whole
        out["seq_cache_elems"] = sum(x.numel() for x in (cache["0"]["k"], cache["0"]["v"]))
        out[f"seq_logits_{c.dtype}"], _ = serve(p, cache, torch.tensor([payload["seq_token"]]),
                                                ATTN_S - 1)
        del cache, p
    # the greedy loop, in fp32 (its tokens held) and in bf16 (agreement printed)
    for c, p in ((cfg, params), (dataclasses.replace(cfg, dtype="float32"),
                                 tree_map(lambda t: t.float(), params))):
        serve, spec, pls = make_serve_step(c, mesh, InputShape("short", SEQ_CACHE, 1, "decode"),
                                           device=device)
        t0 = time.perf_counter()
        out[f"seq_tokens_{c.dtype}"] = greedy(serve, p, local_zeros(spec, pls, device),
                                              torch.as_tensor(payload["seq_prompt"]), SEQ_NEW)
        torch.cuda.synchronize()
        out[f"seq_ms_{c.dtype}"] = (time.perf_counter() - t0) * 1e3
        del p
    out["counts"] = dict(LAUNCHES)
    return out


def seeded_cache(cfg, filled: int, dev, batch: int = 1, length=None):
    """A decode cache of ``batch`` rows and ``length`` positions (ATTN_S by
    default) whose first ``filled`` positions hold k / v drawn from a seed
    (the size of the model's own keys and values), the rest zero."""
    import torch

    from repro_torch.models import transformer as tfm

    cache = tfm.init_cache(cfg, batch, ATTN_S if length is None else length, device="cpu")
    gen = torch.Generator().manual_seed(21)
    for layer in cache.values():
        for x in layer.values():
            x[:, :, :filled] = torch.randn(x[:, :, :filled].shape, generator=gen).to(x.dtype)
    return {i: {k: x.to(dev) for k, x in layer.items()} for i, layer in cache.items()}


def tp_check(launches, key: str, name: str, tp, rules, smi: str, peak_bar=None) -> None:
    """Phase 15(e)'s holds (and 15(g)'s and (h)'s) on ``tp_rank``'s results
    ``tp`` of every rank, one step per rule of ``rules``: the losses the
    same bits on every rank, the plain-route checks equal and within
    ``TRAIN_AGG_RTOL``, the one-device step's exact ``TRAIN_ROUTE``
    launches, and the loss and the aggregate within ``TP_BARS[key]`` of
    the one-device step's (where it is None, both gaps printed); each
    rank's peak at the end of the forward and backward below ``peak_bar``
    (``(peaks a rank, label)``), or below the one-device step's where it
    is ``None``. The launches are added to
    ``launches[key + "_train"]`` and ``[key + "_one_device"]``."""
    from repro_torch.kernels import LAUNCHES

    bars, T = TP_BARS[key], len(tp)
    launches[f"{key}_train"] = {k: 0 for k in LAUNCHES}
    launches[f"{key}_one_device"] = {k: 0 for k in LAUNCHES}
    log(f"{key} {name} on (data=1, model={T}): rank 0's compute blocks "
        f"{json.dumps(tp[0][0]['blocks'])}")
    for i, agg in enumerate(rules):
        runs = [t[i] for t in tp]
        for run in runs:
            for k, v in run["counts"].items():
                launches[f"{key}_train"][k] += v
        if not all(np_same_bits(run["loss"], runs[0]["loss"]) for run in runs):
            raise AssertionError(f"{key} {agg}: the ranks' losses differ "
                                 f"{[float(run['loss']) for run in runs]}")
        if any(run["check"] != runs[0]["check"] for run in runs):
            raise AssertionError(f"{key} {agg}: the ranks' plain-route checks differ")
        c, one = runs[0]["check"], runs[0]
        if not (c["slice"] <= TRAIN_AGG_RTOL and c["egress"] <= TRAIN_AGG_RTOL):
            raise AssertionError(f"{key} {agg}: the kernel route is off the plain route {c}")
        want = {k: TRAIN_ROUTE[agg].get(k, 0) for k in one["one_counts"]}
        if one["one_counts"] != want:
            raise AssertionError(f"{key} {agg} one device: launches {one['one_counts']}, "
                                 f"expected {want}")
        for k, v in one["one_counts"].items():
            launches[f"{key}_one_device"][k] += v
        loss_gap = abs(float(one["loss"]) - one["one_loss"])
        bar, bar_label = peak_bar or ([one["one_fb_peak"]] * len(runs), "one device's")
        for rank, run in enumerate(runs):
            if not run["fb_peak"] < bar[rank]:
                raise AssertionError(f"{key} {agg} rank {rank}: peak at the end of the forward "
                                     f"and backward {run['fb_peak']} not below "
                                     f"{bar_label} {bar[rank]}")
        wall = max(run["ms"] for run in runs)
        log(f"{key} {name} {agg} step on (data=1, model={T}), {T} gloo ranks on one card, W = "
            f"{TRAIN_W} x {TRAIN_S} tokens on every rank: loss {float(one['loss']):.5f}, the same "
            f"bits on every rank, one device {one['one_loss']:.5f} "
            f"(|gap| {loss_gap:.3g}, bar {bars[0] if bars else 'none'}); host ms {wall:.1f} (slowest rank), "
            f"{TRAIN_W * TRAIN_S / wall * 1e3:.0f} tokens/s; launches per rank "
            f"{json.dumps({k: v for k, v in one['counts'].items() if v})}, one device "
            f"{json.dumps({k: v for k, v in one['one_counts'].items() if v})}; peak at the "
            f"end of the forward and backward per rank "
            f"{', '.join(f'{run['fb_peak'] / 1e9:.2f}' for run in runs)} GB against "
            f"{bar_label} {', '.join(f'{p / 1e9:.2f}' for p in bar)} (one device's "
            f"{one['one_fb_peak'] / 1e9:.2f}); step peak "
            f"{', '.join(f'{run['peak'] / 1e9:.2f}' for run in runs)} GB; device ms by phase "
            f"(rank 0) {json.dumps({k: round(v, 1) for k, v in one['phase_ms'].items()})} "
            f"({smi})")
        other, kept, n = one["routed"]
        routed = (f"; (token, expert) assignments the mesh routed otherwise than one device, "
                  f"of {n:,}: {other} (kept counts differing by {kept})" if n else "")
        log(f"check {key} {agg}: kernel route vs plain route of the sharded sync on each rank's "
            f"column slice X[{c['rows']}, {c['cols']:,}]: {c['slice']:.3g} on the combined "
            f"slice, {c['egress']:.3g} on the egress (bar {TRAIN_AGG_RTOL}); the "
            f"aggregate gathered whole against the one-device step's: |mesh - one device|_2 / "
            f"max_i |x_i|_2 = {one['agg_err']:.3g} (bar {bars[1] if bars else 'none'}; "
            f"max_i |x_i|_2 "
            f"{one['row_norm']:.4g}){routed}")
        if bars and not loss_gap <= bars[0]:
            raise AssertionError(f"{key} {agg}: loss {float(one['loss'])} vs one device "
                                 f"{one['one_loss']}")
        if bars and not one["agg_err"] <= bars[1]:
            raise AssertionError(f"{key} {agg}: aggregate off the one-device step's by "
                                 f"{one['agg_err']}")


def mesh_phase(dev, smi):
    """Phase 15: (a) gemma-7b's fsdp training at full width, then in the
    same group (e) its steps computing along a (1, 4) mesh's model axis,
    (f) gemma-7b served on compute blocks, (g) OLMoE's experts along the
    model axis, trained and served, (h) Mamba2's SSM heads along it,
    trained and served, and Jamba's SSM layer alone, (b) the smoke step on
    the (4, 1) and
    (2, 2) meshes against the replicated and the one-device steps, (c)
    TinyLlama served on (4, 1), (d) checkpoints. Returns the launch counts
    by path."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer as tfm
    from repro_torch.training.checkpoint import restore_checkpoint
    from repro_torch.utils.tree import tree_flatten, tree_map, tree_map_with_path

    launches = {}
    cards = ["cuda:0"] * SYNC_RANKS
    # the ranks' allocators grow segments in place: four ranks share the
    # card, and a rank's freed activations would otherwise sit in blocks
    # too small for the packed row's 4 GB exchange buffers
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

    # (a) fsdp training at full width, FSDP_LAYERS deep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(fsdp_rank, SYNC_RANKS, backend="gloo", devices=cards, timeout_s=900)
    launches["fsdp_train"] = {k: 0 for k in LAUNCHES}
    n_pad = ranks[0]["n_pad"]
    for rank, r in enumerate(ranks):
        for st in r["steps"]:
            for k, v in st["counts"].items():
                launches["fsdp_train"][k] += v
            if st["egress"] >= n_pad:
                raise AssertionError(f"fsdp rank {rank} received {st['egress']} >= n_pad")
        log(f"fsdp {FSDP_ARCH} rank {rank}: holds {r['held']['params'] / 1e9:.3f} GB of "
            f"parameter blocks ({r['block_elems']:,} of {FSDP_PARAMS:,}) and "
            f"{r['held']['momentum'] / 1e9:.3f} GB of momentum blocks "
            f"({r['held']['allocated'] / 1e9:.2f} GB allocated before the first step); per "
            f"step received {r['steps'][0]['ingress']:,} fp32 in the ingress and "
            f"{r['steps'][0]['egress']:,} in the egress (its blocks; n_pad {n_pad:,}); peak "
            f"memory per step {', '.join(f'{st['peak'] / 1e9:.2f}' for st in r['steps'])} GB")
    for i, st in enumerate(ranks[0]["steps"]):
        if len({round(r["steps"][i]["loss"], 12) for r in ranks}) != 1:
            raise AssertionError(f"fsdp step {i}: the ranks' losses differ")
        wall = max(r["steps"][i]["ms"] for r in ranks)
        log(f"fsdp {FSDP_ARCH} ({FSDP_LAYERS} of 28 layers, {FSDP_PARAMS:,} parameters, remat "
            f"{get_config(FSDP_ARCH).remat!r}) {st['agg']} step {i + 1} on (data=4, model=1), "
            f"4 gloo ranks on one card: loss "
            f"{st['loss']:.5f}; host ms {wall:.1f} (slowest rank), "
            f"{TRAIN_W * TRAIN_S / wall * 1e3:.0f} tokens/s; launches per rank "
            f"{json.dumps({k: v for k, v in st['counts'].items() if v})} ({smi})")
    for c in ranks[0]["checks"]:
        if any(r["checks"] != ranks[0]["checks"] for r in ranks):
            raise AssertionError("fsdp: the ranks' plain-route checks differ")
        log(f"check fsdp {c['agg']} step 1, kernel route vs plain route of the sharded sync on "
            f"each rank's column slice X[{c['rows']}, {c['cols']:,}] (mixed to "
            f"{c['buckets']} buckets): |kernel - plain|_2 / max_i |x_i|_2 over all ranks' "
            f"columns {c['slice']:.3g} on the combined slice, {c['egress']:.3g} on the egress "
            f"blocks (bar {TRAIN_AGG_RTOL})")
        if not (c["slice"] <= TRAIN_AGG_RTOL and c["egress"] <= TRAIN_AGG_RTOL):
            raise AssertionError(f"fsdp {c['agg']}: the kernel route is off the plain route")
    if [c["agg"] for c in ranks[0]["checks"]] != [agg for agg, _ in FSDP_RUNS]:
        raise AssertionError(f"fsdp: checked {ranks[0]['checks']}, expected one step a rule")
    log(f"fsdp phase (a), (e), (f), (g) and (h) ran in {time.perf_counter() - t0:.1f} s, "
        "spawn included")

    # (e) the same group on (data=1, model=4): compute along the model axis
    a_fb = [min(st["fb_peak"] for st in r["steps"]) for r in ranks]
    tp_check(launches, "tp", f"{FSDP_ARCH} ({FSDP_LAYERS} of 28 layers, {FSDP_PARAMS:,} "
             "parameters)", [r["tp"]["runs"] for r in ranks], TP_RUNS, smi,
             (a_fb, "(a)'s (4, 1)"))

    # (f) the same group serving gemma-7b on compute blocks
    t0 = time.perf_counter()
    launches["serve_tp"] = {k: sum(r["tps"]["counts"][k] for r in ranks) for k in LAUNCHES}
    if any(launches["serve_tp"].values()):
        raise AssertionError(f"serve tp: kernels launched {launches['serve_tp']}")
    tps_check(dev, smi, [r["tps"] for r in ranks], TPS_GEMMA)
    log(f"tps checks on one device ran in {time.perf_counter() - t0:.1f} s")

    # (g) the same group: OLMoE's experts along the model axis, trained and served
    t0 = time.perf_counter()
    cfg = moe_config()
    tp_check(launches, "moe.tp", f"{MOE_ARCH} ({MOE_TP_LAYERS} of "
             f"{get_config(MOE_ARCH).n_layers} layers, {MOE_TP_DTYPE}, "
             f"{cfg.param_count():,} parameters, {cfg.n_experts} experts top-"
             f"{cfg.experts_per_token})", [r["moe"]["train"]["runs"] for r in ranks],
             MOE_TP_RUNS, smi)
    cfg = moe_config(dtype="bfloat16")
    tp_check(launches, "moe.tp16", f"{MOE_ARCH} ({MOE_TP_LAYERS} of "
             f"{get_config(MOE_ARCH).n_layers} layers, bfloat16, {cfg.param_count():,} "
             f"parameters)", [r["moe"]["train16"]["runs"] for r in ranks], MOE_TP_RUNS, smi)
    launches["moe.serve_tp"] = {k: sum(r["moe"]["serve"]["counts"][k] for r in ranks)
                                for k in LAUNCHES}
    if any(launches["moe.serve_tp"].values()):
        raise AssertionError(f"moe serve tp: kernels launched {launches['moe.serve_tp']}")
    tps_check(dev, smi, [r["moe"]["serve"] for r in ranks], TPS_MOE)
    log(f"moe tp checks on one device ran in {time.perf_counter() - t0:.1f} s")

    # (h) the same group: Mamba2's SSM heads along the model axis, trained and
    # served; Jamba's SSM layer alone
    t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    tp_check(launches, "ssm.tp", f"{SSM_ARCH} ({cfg.n_layers} layers, float32, "
             f"{SSM_PARAMS:,} parameters, {cfg.ssm_heads} SSM heads)",
             [r["ssm"]["train"]["runs"] for r in ranks], SSM_TP_RUNS, smi)
    launches["ssm.serve_tp"] = {k: sum(r["ssm"]["serve"]["counts"][k] for r in ranks)
                                for k in LAUNCHES}
    if any(launches["ssm.serve_tp"].values()):
        raise AssertionError(f"ssm serve tp: kernels launched {launches['ssm.serve_tp']}")
    tps_check(dev, smi, [r["ssm"]["serve"] for r in ranks], TPS_SSM)
    ssm_layer_check([r["ssm"]["layer"] for r in ranks], smi)
    log(f"ssm tp checks on one device ran in {time.perf_counter() - t0:.1f} s")
    log("phase 15 in the ranks, s a sub-phase (rank 0): "
        + ", ".join(f"({k}) {v:.1f}" for k, v in ranks[0]["seconds"].items()))

    # (b) + (d) the smoke-width step on both meshes
    launches["fsdp_smoke"] = {k: 0 for k in LAUNCHES}
    one = {agg: mesh_smoke_steps(dev, agg, True, None) for agg in ("rfa", "cm")}
    cfg = get_config("tinyllama-1.1b")
    gen = torch.Generator().manual_seed(31)
    payload = {"prefill": torch.randint(0, cfg.vocab_size, (SYNC_RANKS, ATTN_S), generator=gen),
               "decode": torch.randint(0, cfg.vocab_size, (SYNC_RANKS, MESH_DECODE_PROMPT),
                                       generator=gen),
               "seq_token": int(torch.randint(0, cfg.vocab_size, (1,), generator=gen)),
               "seq_prompt": torch.randint(0, cfg.vocab_size, (1, SEQ_PROMPT), generator=gen)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        t0 = time.perf_counter()
        runs = spawn_ranks(mesh_rank, SYNC_RANKS, backend="gloo", devices=cards,
                           args=(ckpt, payload), timeout_s=900)
        log(f"mesh phases (b)-(d): 4 ranks ran in {time.perf_counter() - t0:.1f} s, spawn "
            f"included")
        for shape in MESH_SHAPES:
            for agg in ("rfa", "cm"):
                want = [t.cpu().numpy() for t in tree_flatten(one[agg]["params"])[0]
                        + tree_flatten(one[agg]["m"])[0]]
                err = 0.0
                for rank, r in enumerate(runs):
                    fs, rep = r[shape][(agg, True)], r[shape][(agg, False)]
                    for c in fs["counts"] + rep["counts"]:
                        for k, v in c.items():
                            launches["fsdp_smoke"][k] += v
                    got = tree_flatten(fs["params"])[0] + tree_flatten(fs["m"])[0]
                    if not all(np_same_bits(a, b) for a, b in zip(
                            got, tree_flatten(rep["params"])[0] + tree_flatten(rep["m"])[0])):
                        raise AssertionError(f"mesh {shape} {agg} rank {rank}: the fsdp step "
                                             "differs from the replicated step")
                    for a, b in zip(got, want):
                        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
                        err = max(err, float(np.abs(a - b).max()))
                log(f"check fsdp smoke {FSDP_ARCH} {agg} on mesh {shape}, {GROUP_STEPS} steps: "
                    f"the fsdp and the replicated steps' parameters and momenta equal bit for "
                    f"bit on every rank; max |mesh - one device| {err:.3g} (bar rtol 1e-4, "
                    f"atol 1e-6); losses "
                    f"{[round(x, 5) for x in runs[0][shape][(agg, True)]['losses']]} vs one "
                    f"device {[round(x, 5) for x in one[agg]['losses']]}")
        # (d) the (4, 1) mesh's checkpoint, restored on one device
        params, opt_state = one["rfa"]["blocks"]
        like = tree_map_with_path(lambda _, x: torch.zeros_like(x),
                                  {"params": params, "opt_state": opt_state, "worker_m": {}})
        back = restore_checkpoint(ckpt, like)
    saved = runs[0][(4, 1)][("rfa", True)]
    for a, b in zip(tree_flatten(back["params"])[0] + tree_flatten(back["opt_state"].m)[0],
                    tree_flatten(saved["params"])[0] + tree_flatten(saved["m"])[0]):
        if not np_same_bits(a.cpu().numpy(), b):
            raise AssertionError("the mesh's checkpoint restored on one device differs")
    log(f"check checkpoint: the fsdp RFA state saved from mesh (4, 1) restores on one device "
        f"bit for bit ({len(tree_flatten(back)[0])} leaves), and onto the mesh bit for bit in "
        f"every rank")

    # (c) TinyLlama served on (4, 1), against one device
    ranks = [r["serve"] for r in runs]
    launches["serve_mesh"] = {k: sum(r["counts"][k] for r in ranks) for k in LAUNCHES}
    if any(launches["serve_mesh"].values()):
        raise AssertionError(f"serve mesh: kernels launched {launches['serve_mesh']}")
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    whole = prefill(params, {"tokens": payload["prefill"]})
    tol = PREFILL_MESH_TOL * float(whole.abs().max())
    err = 0.0
    for rank, r in enumerate(ranks):
        alone = prefill(params, {"tokens": payload["prefill"][rank:rank + 1]}).cpu().numpy()
        if not np_same_bits(r["prefill"], alone):
            raise AssertionError(f"serve mesh prefill: rank {rank} differs from its row alone")
        want = whole[rank:rank + 1].cpu().numpy()
        err = max(err, float(np.abs(r["prefill"] - want).max()))
        if int(r["prefill"].argmax()) != int(want.argmax()):
            raise AssertionError(f"serve mesh prefill: rank {rank}'s next token differs")
    if not err <= tol:
        raise AssertionError(f"serve mesh prefill: max |mesh - one device| {err} > {tol}")
    log(f"check serve mesh prefill, TinyLlama-1.1B B = 4 x {ATTN_S} on (data=4, model=1), a "
        f"row a rank: each rank's logits equal its row prefilled alone on one device bit for "
        f"bit, and the B = 4 prefill's within {err:.3g} (bar {PREFILL_MESH_TOL} x max |logit| "
        f"= {tol:.3g}); next tokens equal; prefill host ms per rank "
        f"{', '.join(f'{r["prefill_ms"]:.1f}' for r in ranks)} ({smi})")

    def loop(c, p, prompt, n_new, cache_len):
        """The one-device greedy loop over ``decode_step``."""
        return greedy_logits(one_device_decode(c), p,
                             tfm.init_cache(c, prompt.shape[0], cache_len, device=dev),
                             prompt.to(dev), n_new)[0].numpy()

    wide = loop(cfg, params, payload["decode"], MESH_DECODE_STEPS, MESH_DECODE_CACHE)
    rows = np.concatenate([loop(cfg, params, payload["decode"][i:i + 1], MESH_DECODE_STEPS,
                                MESH_DECODE_CACHE) for i in range(SYNC_RANKS)])
    for rank, r in enumerate(ranks):
        if not np.array_equal(r["batch_tokens"], rows):
            raise AssertionError(f"serve mesh batch decode: rank {rank}'s tokens differ")
    agree = float(np.mean(rows == wide))
    log(f"check serve mesh batch-sharded decode (cache {ranks[0]['batch_spec']}, "
        f"{MESH_DECODE_CACHE} positions): {MESH_DECODE_STEPS} greedy tokens after a "
        f"{MESH_DECODE_PROMPT}-token prompt equal, on every rank, the one-device loop's at the "
        f"rank's width (one row); {agree:.3f} of them agree with the one-device loop at width 4; "
        f"host ms {', '.join(f'{r["batch_ms"]:.0f}' for r in ranks)} per loop")
    want = {}
    for c, p in ((cfg, params), (dataclasses.replace(cfg, dtype="float32"),
                                 tree_map(lambda t: t.float(), params))):
        cache = seeded_cache(c, ATTN_S - 1, dev)
        logits, _ = tfm.decode_step(p, c, cache, torch.tensor([payload["seq_token"]], device=dev),
                                    ATTN_S - 1)
        want[c.dtype] = logits.cpu().numpy()
        del cache, p
    for dtype in want:
        if any(not np_same_bits(r[f"seq_logits_{dtype}"], ranks[0][f"seq_logits_{dtype}"])
               for r in ranks):
            raise AssertionError(f"serve mesh sequence-sharded step: the ranks differ ({dtype})")
    mesh32 = ranks[0]["seq_logits_float32"]
    err = float(np.abs(mesh32 - want["float32"]).max())
    np.testing.assert_allclose(mesh32, want["float32"], rtol=2e-3, atol=2e-3)
    off = {label: float(np.abs(x - want["float32"]).max()) for label, x in (
        ("mesh", ranks[0]["seq_logits_bfloat16"]), ("one device", want["bfloat16"]))}
    bf16_gap = float(np.abs(ranks[0]["seq_logits_bfloat16"] - want["bfloat16"]).max())
    if not off["mesh"] <= SEQ_BF16_RATIO * off["one device"]:
        raise AssertionError(f"serve mesh sequence-sharded bf16 step: {off['mesh']} off fp32, "
                             f"above {SEQ_BF16_RATIO} x the one device's {off['one device']}")
    log(f"check serve mesh sequence-sharded decode step (cache {ranks[0]['seq_spec']}, "
        f"{ATTN_S} positions, {ATTN_S - 1} filled from a seed; {ranks[0]['seq_cache_elems']:,} "
        f"k/v elements a rank over the {cfg.n_layers} layers), logits equal on every rank: in "
        f"fp32 max |mesh - one device| {err:.3g} (the reference's decode bar, rtol and atol "
        f"2e-3); in bf16 max |x - fp32 one device| mesh {off['mesh']:.3g}, one device "
        f"{off['one device']:.3g} (bar {SEQ_BF16_RATIO} x the one device's), max |mesh bf16 - "
        f"one device bf16| {bf16_gap:.3g} (max |logit| "
        f"{float(np.abs(want['float32']).max()):.3g})")
    rows = {"bfloat16": loop(cfg, params, payload["seq_prompt"], SEQ_NEW, SEQ_CACHE)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rows["float32"] = loop(cfg32, tree_map(lambda t: t.float(), params), payload["seq_prompt"],
                           SEQ_NEW, SEQ_CACHE)
    for rank, r in enumerate(ranks):
        if not np.array_equal(r["seq_tokens_float32"], rows["float32"]):
            raise AssertionError(f"serve mesh sequence-sharded loop: rank {rank}'s fp32 tokens "
                                 f"{r['seq_tokens_float32'].tolist()} differ from "
                                 f"{rows['float32'].tolist()}")
    agree = float(np.mean(ranks[0]["seq_tokens_bfloat16"] == rows["bfloat16"]))
    log(f"check serve mesh sequence-sharded loop: a {SEQ_PROMPT}-token prompt in a "
        f"{SEQ_CACHE}-position cache ({SEQ_CACHE // SYNC_RANKS} a rank) and {SEQ_NEW} greedy "
        f"tokens; in fp32 they equal the one-device loop's on every rank; in bf16 {agree:.3f} of "
        f"them agree with the one-device bf16 loop (in the step above bf16 put the one "
        f"device {off['one device']:.3g} and the mesh {off['mesh']:.3g} off fp32); host ms per "
        f"loop "
        f"{', '.join(f'{r["seq_ms_bfloat16"]:.0f}' for r in ranks)} (bf16), "
        f"{', '.join(f'{r["seq_ms_float32"]:.0f}' for r in ranks)} (fp32) ({smi})")
    del params
    torch.cuda.empty_cache()
    return launches


def peak_above(live: int) -> str:
    """The peak device memory since ``reset_peak_memory_stats`` above ``live``,
    the bytes already allocated when it was reset (earlier phases' tensors)."""
    import torch

    return (f"peak {(torch.cuda.max_memory_allocated() - live) / 2**20:.1f} MiB above the "
            f"{live / 2**20:.1f} MiB already allocated")


def cnn_gates(acc) -> None:
    """Phase 16(a)'s gate: each CNN accuracy within ``CNN_MARGIN`` of the JAX
    reference's (``CNN_REFERENCE``)."""
    gaps = {label: abs(a - CNN_REFERENCE[label]) for label, a in acc.items()}
    missed = {label: gap for label, gap in gaps.items() if not gap <= CNN_MARGIN}
    if missed:
        raise AssertionError(f"cnn paper loop: accuracies {acc} miss the reference's "
                             f"{CNN_REFERENCE} by {missed} (margin {CNN_MARGIN})")
    log("check cnn paper loop: |accuracy - the JAX reference's| " + "; ".join(
        f"{label} {gap:.4f}" for label, gap in gaps.items()) + f" <= {CNN_MARGIN}")


def conv_precision(dev, workers, reps: int = 20) -> None:
    """What IEEE fp32 costs the CNN's convolutions: conv1 and conv2 forward
    and backward (input and weight gradients) on one step's images (n = 25
    workers x 32), as ``cnn_apply`` runs them, in IEEE fp32 (the setting the
    simulators pick) and in cuDNN's default TF32; device ms a pass (CUDA
    events over ``reps`` passes), and how far TF32's gradients lie from
    IEEE's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.mlp import init_cnn

    wx, _ = workers
    x = wx[:, :32].reshape(-1, 1, 28, 28)
    params = init_cnn(torch.Generator().manual_seed(1), device=dev)
    w1, w2 = (params[k].permute(3, 2, 0, 1).contiguous().requires_grad_()
              for k in ("conv1", "conv2"))
    h1 = F.max_pool2d(torch.relu(F.conv2d(x, w1.detach(), padding=1)), 2, 2)
    h1 = h1.detach().requires_grad_()
    g1 = torch.randn((x.shape[0], w1.shape[0], 28, 28), device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    g2 = torch.randn((x.shape[0], w2.shape[0], 14, 14), device=dev,
                     generator=torch.Generator(dev).manual_seed(1))

    def one_pass():
        a = F.conv2d(x, w1, padding=1)
        b = F.conv2d(h1, w2, padding=1)
        return torch.autograd.grad((a, b), (w1, w2, h1), (g1, g2))

    saved = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for name, tf32 in (("ieee", False), ("tf32", True)):
            torch.backends.cudnn.allow_tf32 = tf32
            grads = one_pass()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                one_pass()
            end.record()
            end.synchronize()
            out[name] = (start.elapsed_time(end) / reps, grads)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    dev_rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(out["tf32"][1], out["ieee"][1]))
    log(f"cnn conv precision: conv1 + conv2 forward and backward on {x.shape[0]} images, "
        f"device ms a pass: IEEE fp32 {out['ieee'][0]:.4f}, cuDNN TF32 {out['tf32'][0]:.4f}; "
        f"TF32's gradients off IEEE's by up to {dev_rel:.3g} of a tensor's largest entry")


def cnn_messages(sim, params, wx, wy, draws):
    """What a ``CrossDeviceSim`` round hands the packed engine: the
    cohort's per-client CNN gradients after the attack, ``[C, d]``."""
    import torch

    from repro_torch import ieee_fp32
    from repro_torch.training.byzantine import stack_flatten_workers

    cohort, idx = draws.cohort.to(wx.device), draws.idx.to(wx.device)
    with ieee_fp32():
        grads = sim.grad_fn(params, wx[cohort[:, None], idx], wy[cohort[:, None], idx])
    sent, _ = sim.attack(stack_flatten_workers(grads).float(), cohort < sim.n_byz_pool, None)
    return sent.contiguous()


def cnn_kernel_rows(results, sent, mix, W: int, d: int, timing=(20, 20)) -> None:
    """The four kernels of the CNN's cross-device path, at the packed width
    ``d`` of its round, on the round's own messages: held, timed and bounded
    as in phase 2."""
    import torch

    from repro_torch.distributed.packing import packer_for
    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.cost import selection_ops
    from repro_torch.kernels.cwise_median import cwise_median
    from repro_torch.kernels.pairwise_gram import pairwise_gram
    from repro_torch.kernels.trimmed_mean import cwise_trimmed_mean

    record = functools.partial(measure, results)
    n_pad = packer_for([sent]).n_pad
    x = torch.nn.functional.pad(sent, (0, n_pad - d)).contiguous()
    m_rows = mix.shape[0]
    tag = f"CNN d={d}"
    record("bucket_mix", f"{tag}: mix M[{m_rows},{W}] X[{W},{n_pad}]",
           lambda: bucket_mix(mix, x), lambda: ref.bucket_mix(mix, x),
           lambda: torch.matmul(mix, x), (W * n_pad + m_rows * W + m_rows * n_pad) * 4,
           2 * m_rows * W * n_pad, timing, close(1e-5, 1e-4))
    record("pairwise_gram", f"{tag}: X[{W},{n_pad}]", lambda: pairwise_gram(x),
           lambda: ref.pairwise_gram(x), lambda: torch.matmul(x, x.T),
           (W * n_pad + W * W) * 4, W * (W + 1) * n_pad, timing, gram_close(x))
    mixed = bucket_mix(mix, x)

    def bitwise(got, want):
        if not same_bits(got, want):
            raise AssertionError("kernel and plain version differ bitwise")

    record("cwise_median", f"{tag}: X[{m_rows},{n_pad}]", lambda: cwise_median(mixed),
           lambda: ref.cwise_median(mixed), lambda: torch.median(mixed, dim=0).values,
           (m_rows + 1) * n_pad * 4, selection_ops(m_rows, n_pad), timing, bitwise,
           PEAK_MINMAX_PER_S)
    b = 1
    record("cwise_trimmed_mean", f"{tag}: X[{m_rows},{n_pad}] b={b}",
           lambda: cwise_trimmed_mean(mixed, b), lambda: ref.cwise_trimmed_mean(mixed, b),
           lambda: torch.sort(mixed, dim=0).values[b:m_rows - b].mean(dim=0),
           (m_rows + 1) * n_pad * 4, selection_ops(m_rows, n_pad, b), timing, bitwise,
           PEAK_MINMAX_PER_S)


def cnn_slice_phase(dev, smi: str, results):
    """Phase 16(b): ``slice_phase`` with the CNN at each of ``CNN_SCALES``
    under ``CNN_SLICE_RUNS``; after each round's comparison, the round's
    aggregate of the card's own messages through the kernels against the
    plain versions on the same values (CM / TM bit for bit); the kernels
    held and timed at the largest scale's packed width."""
    import torch

    from repro_torch.distributed.packing import packed_aggregate
    from repro_torch.models.mlp import cnn_apply, cnn_nll_loss, init_cnn

    task = slice_task(dev)
    wx, wy = task[:2]
    launches = {}
    for scale, d in CNN_SCALES.items():
        init = functools.partial(init_cnn, scale=scale)
        n = sum(p.numel() for p in init(torch.Generator().manual_seed(1), device="cpu").values())
        if n != d:
            raise AssertionError(f"cnn scale {scale}: {n} parameters, expected {d}")

        def check(label, agg, sim_gpu, sim_cpu, p_gpu, d_gpu, draws, scale=scale, d=d):
            sent = cnn_messages(sim_gpu, p_gpu, wx, wy, d_gpu)
            got = packed_aggregate(sent, sim_gpu.aggregator, mix=d_gpu.mix).cpu()
            want = packed_aggregate(sent.cpu(), sim_cpu.aggregator, mix=draws.mix)
            if agg in ("cm", "tm"):
                if not same_bits(got, want):
                    raise AssertionError(f"{label}: the kernel aggregate differs bitwise "
                                         "from the plain one")
                how = "bit for bit"
            else:
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
                how = "rtol 1e-4, atol 1e-6"
            log(f"check {label}: its aggregate of the card's messages "
                f"X[{sent.shape[0]},{d}] == the plain versions' {how}")
            if scale == max(CNN_SCALES) and agg == "cm":
                cnn_kernel_rows(results, sent, d_gpu.mix, sent.shape[0], d)

        launches.update(slice_phase(
            dev, smi, task=task, runs=CNN_SLICE_RUNS, loss_fn=cnn_nll_loss, init=init,
            apply_fn=cnn_apply, rounds=CNN_ROUNDS, prefix=f"cnn.slice.s{scale}.",
            check=check))
    return launches


def analysis_phase(dev):
    """Phase 16(c): ``python -m repro_torch.analysis --layers ast,trace
    --device cuda``'s function on the card: every target once on one rank,
    kernel presence read from ``LAUNCHES``; exit 0 and the exact launches."""
    import torch

    from repro_torch.analysis import cli
    from repro_torch.analysis.targets import TARGET_NAMES
    from repro_torch.kernels import LAUNCHES, reset_launches

    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as tmp:
        path = os.path.join(tmp, "report.json")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["--layers", "ast,trace", "--device", str(dev), "--json", path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        with open(path, encoding="utf-8") as fh:
            report = json.load(fh)
    if rc != 0 or not report["ok"] or report["meta"]["device"] != str(dev):
        raise AssertionError(f"analysis on the card: exit {rc}, findings {report['findings']}")
    # one device: the Gram route for RFA and CCLIP, the mix and CM for CM
    want = dict.fromkeys(counts, 0)
    want.update(bucket_mix=len(TARGET_NAMES), pairwise_gram=len(TARGET_NAMES) - 1,
                cwise_median=1)
    if counts != want:
        raise AssertionError(f"analysis on the card: launches {counts}, expected {want}")
    log(f"check analysis --layers ast,trace --device cuda: exit 0, no finding, "
        f"{len(report['meta']['targets'])} targets on {report['meta']['device_name']}, "
        f"launches {json.dumps(counts)}, {seconds:.1f} s")
    return {"analysis.trace": counts}


def cnn_phase(dev, smi: str, results):
    """Phase 16: the CNN through both paper loops, and the static-analysis
    gate's trace layer on the card."""
    from repro_torch.models.mlp import cnn_apply, cnn_nll_loss, init_cnn

    t0 = time.perf_counter()
    launches, split = paper_phase(dev, smi, runs=CNN_RUNS, loss_fn=cnn_nll_loss, init=init_cnn,
                                  apply_fn=cnn_apply, gate=cnn_gates,
                                  reference=CNN_REFERENCE, prefix="cnn.paper.")
    conv_precision(dev, split[0])
    launches.update(cnn_slice_phase(dev, smi, results))
    launches.update(analysis_phase(dev))
    log(f"cnn / analysis phase: {time.perf_counter() - t0:.1f} s")
    return launches


def np_same_bits(got, want) -> bool:
    """Bit-for-bit equality of two numpy arrays (any dtype)."""
    import numpy as np

    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    return got.shape == want.shape and np.array_equal(got.reshape(-1).view(np.uint8),
                                                      want.reshape(-1).view(np.uint8))


def profile_rounds(sim, wx, wy, dev, label, round_us: float, rounds: int = 20,
                   unit: str = "round", init=None) -> None:
    """Profile ``rounds`` rounds (steps) of ``sim`` after 5 warm-up rounds,
    from ``init(generator, device=)``'s parameters (the MLP's by default)."""
    import torch

    from repro_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(3)
    state = sim.init_state((init or init_mlp)(torch.Generator().manual_seed(1), device=dev))
    for _ in range(5):
        state, _ = sim.step(state, wx, wy, sim.draw(gen, wx.shape[1]))

    def one_round():
        nonlocal state
        state, _ = sim.step(state, wx, wy, sim.draw(gen, wx.shape[1]))

    profile_steps(one_round, label, round_us, rounds, unit)


def profile_steps(step, label, step_us: float, steps: int, unit: str = "step") -> None:
    """Device busy time per step and its largest kernels, from the
    profiler's CUDA kernel records; the busy share is taken against
    ``step_us``, the step time measured without the profiler (which slows
    the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()  # one pass over the trace: it holds ~10^5 events a step
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"profile {label}: {steps} {unit}s, device busy {busy_us / steps:.1f} us/{unit} "
        f"= {100 * busy_us / steps / step_us:.2f} % of the unprofiled {unit} "
        f"({step_us:.0f} us; {wall_us / steps:.0f} us under the profiler), "
        f"{sum(e.count for e in kernels) / steps:.0f} kernels/{unit}; largest: " + "; ".join(
            f"{e.key[:48]} x{e.count / steps:g} {e.self_device_time_total / steps:.1f} us"
            for e in top))
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    log(f"profile {label} host self time per {unit} (under the profiler): " + "; ".join(
        f"{e.key[:40]} x{e.count / steps:g} {e.self_cpu_time_total / steps:.0f} us"
        for e in host))


# ---------------------------------------------------------------- phase 17
def time_once(fn) -> float:
    """Device ms of one call between CUDA events: for the plain versions and
    library calls at X[4, n_pad], where a call takes up to six seconds and
    ``time_ms``' five would eat the phase's budget. ``measure`` has just
    made the plain call once for its check (the warm-up); a library call
    is made once before."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def x16_calls(x16, W, d, dev, seed, big):
    """Phase 17(a)'s calls at one shape, ``(name, label, call, plain, library,
    cost, check)``: ``call(X)`` runs the kernel on rows X (16-bit or their
    fp32 copy), ``plain(X)`` its plain version, ``library(X)`` the fp32 row's
    yardstick on ``X.float()`` (the cast included; none for TM at X[4,
    n_pad] (``big``), where the sort's int64 indices alone take 35 GB),
    ``cost(x_bytes)`` the call's ``kernels/cost.py`` record. Side inputs are
    fp32, drawn from the rows' values and ``seed``."""
    import torch

    from repro_torch.core.mixing import Bucketing
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.bucket_mix import bucket_mix
    from repro_torch.kernels.cclip_combine import cclip_combine
    from repro_torch.kernels.cclip_fused import cclip_fused_iter
    from repro_torch.kernels.cwise_median import cwise_median
    from repro_torch.kernels.pairwise_gram import pairwise_gram
    from repro_torch.kernels.trimmed_mean import cwise_trimmed_mean
    from repro_torch.kernels.weiszfeld_norms import residual_norms

    gen = torch.Generator(dev).manual_seed(seed)
    mix = Bucketing(2).matrix(W, perm=torch.randperm(W, generator=torch.Generator()
                                                     .manual_seed(seed)), device=dev)
    weights = torch.rand((1, W), device=dev, generator=gen)
    weights = weights / weights.sum()
    c = torch.softmax(torch.randn(W, device=dev, generator=gen), 0)
    v = x16.float().mean(0)
    norms = torch.sqrt(ref.residual_norms(x16, center=v))
    lam = torch.clamp(0.5 * norms.median() / norms, max=1.0)  # about half clipped
    beta = 1.0 - float(lam.mean())
    Ws = min(W, X16_SEL_W)  # CM / TM take the mix's rows on the path: 5 of W = 10
    # phase 11's check at X[4, n_pad], phase 2's elsewhere
    gram_check = gram_close(x16.float()) if not big else (
        lambda got, want: torch.testing.assert_close(
            got, want, rtol=0, atol=TRAIN_GRAM_RTOL * float(torch.diagonal(want).max())))
    sort_band = None if big else (
        lambda X: torch.sort(X[:Ws].float(), dim=0).values[1:Ws - 1].mean(dim=0))

    def bitwise(got, want):
        if not same_bits(got, want):
            raise AssertionError("kernel and plain version differ bitwise")

    m = mix.shape[0]
    return [
        ("bucket_mix", f"mix M[{m},{W}] X[{W},{d}]", lambda X: bucket_mix(mix, X),
         lambda X: ref.bucket_mix(mix, X), lambda X: torch.matmul(mix, X.float()),
         lambda b: cost.bucket_mix(m, W, d, b), close(1e-5, 1e-4)),
        ("bucket_mix", f"combine M[1,{W}] X[{W},{d}]", lambda X: bucket_mix(weights, X),
         lambda X: ref.bucket_mix(weights, X), lambda X: torch.matmul(weights, X.float()),
         lambda b: cost.bucket_mix(1, W, d, b), close(1e-5, 1e-4)),
        ("pairwise_gram", f"X[{W},{d}]", lambda X: pairwise_gram(X),
         lambda X: ref.pairwise_gram(X), lambda X: (lambda y: torch.matmul(y, y.T))(X.float()),
         lambda b: cost.pairwise_gram(W, d, b), gram_check),
        ("cwise_median", f"X[{Ws},{d}]", lambda X: cwise_median(X[:Ws]),
         lambda X: ref.cwise_median(X[:Ws]),
         lambda X: torch.median(X[:Ws].float(), dim=0).values,
         lambda b: cost.selection(Ws, d, None, b), bitwise),
        ("cwise_trimmed_mean", f"X[{Ws},{d}] b=1", lambda X: cwise_trimmed_mean(X[:Ws], 1),
         lambda X: ref.cwise_trimmed_mean(X[:Ws], 1), sort_band,
         lambda b: cost.selection(Ws, d, 1, b), bitwise),
        ("residual_norms", f"coeffs X[{W},{d}]", lambda X: residual_norms(X, c),
         lambda X: ref.residual_norms(X, c), None, lambda b: cost.residual_norms(W, d, b),
         close(1e-4, 1e-3)),
        ("residual_norms", f"center X[{W},{d}]", lambda X: residual_norms(X, center=v),
         lambda X: ref.residual_norms(X, center=v),
         lambda X: torch.cdist(X.float(), v[None, :]),
         lambda b: cost.residual_norms(W, d, b, center=True), close(1e-4, 1e-3)),
        ("cclip_fused_iter", f"X[{W},{d}]", lambda X: cclip_fused_iter(X, v, lam),
         lambda X: ref.cclip_fused_iter(X, v, lam), None,
         lambda b: cost.cclip_fused_iter(W, d, b), (close(1e-5, 1e-4), close(1e-4, 1e-3))),
        ("cclip_combine", f"X[{W},{d}]", lambda X: cclip_combine(X, v, lam),
         lambda X: ref.cclip_combine(X, v, lam),
         lambda X: torch.addmv(v, X.float().T, lam, beta=beta, alpha=1.0 / W),
         lambda b: cost.cclip_combine(W, d, b), close(1e-5, 1e-4)),
    ]


def gram_routes(x16, timing):
    """The Gram's other routes on the values of X16, which took TMA: the
    predicated loads on an offset copy (``gram_ldg``, the bits held equal)
    and the fp32 TMA route on ``X16.float()``; device ms of each."""
    from repro_torch.kernels.pairwise_gram import pairwise_gram

    moved = offset_copy(x16)
    got, kind = gram_variant(lambda: pairwise_gram(moved))
    if kind != "gram_ldg" or not same_bits(got, pairwise_gram(x16)):
        raise AssertionError(f"pairwise_gram on an offset copy ran {kind}, or not the "
                             "bits of the TMA call")
    ms = {"gram_ldg_ms": time_ms(lambda: pairwise_gram(moved), *timing)}
    del moved, got
    x32 = x16.float()
    ms["fp32_gram_tma_ms"] = time_ms(lambda: pairwise_gram(x32), *timing)
    return ms


def x16_rows(dev, results, dtype, W, d, timing, seed, big=False):
    """Phase 17(a) at one shape: rows X16 ``[W, d]`` of ``dtype``. Each call
    on X16 must equal the same call on ``X16.float()`` bit for bit with the
    same launches (the Gram through the route ``pairwise_gram.variant``
    names, its other routes timed beside it: ``gram_routes``); then kernel,
    plain version and library call are held and timed (``measure``;
    ``big``: the plain version and the library call once, ``time_once``)
    and bounded at X16's element size."""
    import torch

    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.pairwise_gram import variant

    x16 = torch.randn((W, d), device=dev, dtype=dtype,
                      generator=torch.Generator(dev).manual_seed(seed))
    calls = x16_calls(x16, W, d, dev, seed, big)
    name16 = str(dtype).replace("torch.", "")
    kind = variant(d, x16.data_ptr(), dtype)  # the Gram's route on X16
    for name, label, call, plain, library, cost_of, check in calls:
        runs = []
        for fp32 in (False, True):
            x = x16.float() if fp32 else x16
            before, kinds = dict(LAUNCHES), dict(VARIANT_LAUNCHES)
            out = call(x)
            torch.cuda.synchronize()
            runs.append((out if isinstance(out, tuple) else (out,),
                         {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]},
                         {k: n - kinds[k] for k, n in VARIANT_LAUNCHES.items() if n != kinds[k]}))
            del x, out
        (got, n16, v16), (want, n32, v32) = runs
        if n16 != n32 or not all(same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} [{name16} {label}]: {n16} launches vs {n32}, or "
                                 "not the bits of the fp32 call")
        if name == "pairwise_gram" and v16 != {kind: n16[name]}:
            raise AssertionError(f"pairwise_gram [{name16} {label}] ran {v16}, not {kind}")
        del got, want, runs
        c = cost_of(x16.element_size())
        extra = dict(x_dtype=name16, same_bits_as_fp32=True, variants=v16)
        if name == "pairwise_gram" and kind == "gram_tma":
            extra.update(gram_routes(x16, timing))
            log(f"time pairwise_gram [{name16} {label}]: the predicated loads on an offset "
                f"copy {extra['gram_ldg_ms']:.4f} ms (same bits), fp32 TMA on X.float() "
                f"{extra['fp32_gram_tma_ms']:.4f} ms")
        measure(results, name, f"{name16} {label}", lambda: call(x16), lambda: plain(x16),
                None if library is None else (lambda: library(x16)), c.bytes, c.ops, timing,
                check, c.peak, extra, once=big)
        torch.cuda.empty_cache()
    log(f"check 16-bit rows {name16} X[{W},{d}]: every kernel and form gave the bits of "
        f"the fp32 call on X.float() with the same launches; the Gram ran {kind}")
    del x16, calls
    torch.cuda.empty_cache()


def train_n_pad(arch: str = "tinyllama-1.1b") -> int:
    """The packed width of ``arch``'s full-width tree (``packing.packer_for``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.packing import packer_for
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import TensorSpec, tree_map

    specs = tfm.params_shape(get_config(arch))
    return packer_for(tree_map(lambda s: TensorSpec((TRAIN_W,) + tuple(s.shape), s.dtype),
                               specs)).n_pad


def x16_per_leaf(dev, smi: str):
    """Phase 17(b): the per-leaf engine's bf16 route at TinyLlama-1.1B's full
    width. Each rule (rfa, cm; bucketing s = 2) runs on one tree of seeded
    bf16 leaves [TRAIN_W, ...] through the packed engine, then the per-leaf
    engine with its kernels: the aggregates must be equal bit for bit, and
    each engine's launches exact (per leaf: the Gram and the combine for
    rfa, the mix and the median for cm; packed: one of each), each Gram on
    the route ``pairwise_gram.variant`` gives its leaf (the packed fp32
    buffer: TMA). Host ms, device ms and peak memory above what was
    allocated."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.aragg import RobustAggregator
    from repro_torch.distributed.robust_sync import robust_gradient_sync
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES, reset_launches
    from repro_torch.kernels.pairwise_gram import variant
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_flatten, tree_map

    cfg = get_config("tinyllama-1.1b")
    gen = torch.Generator(dev).manual_seed(17)
    tree = tree_map(lambda s: torch.randn((TRAIN_W,) + tuple(s.shape), device=dev,
                                          dtype=torch.bfloat16, generator=gen),
                    tfm.params_shape(cfg))
    leaves = tree_flatten(tree)[0]
    n_leaves = sum(1 for t in leaves if t.numel())
    n_params = sum(t[0].numel() for t in leaves)
    leaf_kinds = {}
    for t in leaves:
        if t.numel():
            kind = variant(t[0].numel(), t.data_ptr(), t.dtype)
            leaf_kinds[kind] = leaf_kinds.get(kind, 0) + 1
    routes = {"rfa": ("pairwise_gram", "bucket_mix"), "cm": ("bucket_mix", "cwise_median")}
    launches = {}
    for agg, route in routes.items():
        ra = RobustAggregator.from_spec(agg, mixing="bucketing", s=2)
        mix = ra.mixing_matrix(TRAIN_W, torch.Generator().manual_seed(5), device=dev)
        outs = {}
        for engine, per in (("packed", 1), ("per_leaf", n_leaves)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            live = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            reset_launches()
            t0 = time.perf_counter()
            start.record()
            outs[engine], _ = robust_gradient_sync(tree, ra, mix=mix, engine=engine,
                                                   use_kernels=True)
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            counts = dict(LAUNCHES)
            want = {k: (per if k in route else 0) for k in counts}
            if counts != want:
                raise AssertionError(f"x16.{engine}.{agg}: launches {counts}, expected {want}")
            kinds = {k: VARIANT_LAUNCHES[k] for k in ("gram_tma", "gram_ldg")
                     if VARIANT_LAUNCHES[k]}
            want_kinds = {} if "pairwise_gram" not in route else (
                {"gram_tma": 1} if engine == "packed" else leaf_kinds)
            if kinds != want_kinds:
                raise AssertionError(f"x16.{engine}.{agg}: Gram routes {kinds}, expected "
                                     f"{want_kinds}")
            launches[f"x16.{engine}.{agg}"] = counts
            log(f"per-leaf bf16 [{agg}, {engine}]: TinyLlama-1.1B W={TRAIN_W} x "
                f"{n_params:,} bf16 parameters ({n_leaves} leaves): host "
                f"{host_ms:.1f} ms, device {start.elapsed_time(end):.3f} ms, "
                f"{peak_above(live)}, launches {json.dumps({k: n for k, n in counts.items() if n})} "
                f"{json.dumps(kinds)} ({smi})")
        got, want = (tree_flatten(outs[e])[0] for e in ("per_leaf", "packed"))
        if not all(g.dtype == w.dtype == torch.bfloat16 and torch.equal(
                g.view(torch.int16), w.view(torch.int16)) for g, w in zip(got, want)):
            raise AssertionError(f"per-leaf bf16 [{agg}]: differs from the packed engine")
        log(f"check per-leaf bf16 [{agg}]: the aggregate equals the packed engine's bit "
            f"for bit ({len(got)} bf16 leaves)")
        del outs, got, want
    del tree, leaves
    torch.cuda.empty_cache()
    return launches


def start_subprocess(args, label: str):
    """``(process, log file, start time)`` of ``python args`` from the
    checkout's root, its output to a temporary file."""
    root = Path(__file__).resolve().parent
    out = tempfile.TemporaryFile(mode="w+")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.Popen([sys.executable, *args], cwd=root, env=env, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    log(f"started {label} (pid {proc.pid})")
    return proc, out, time.perf_counter()


def finish_subprocess(started, label: str, timeout: float) -> str:
    """Wait for a ``start_subprocess`` process, log its output, and raise
    unless it exited 0; returns the output."""
    proc, out, t0 = started
    try:
        rc = proc.wait(timeout=max(1.0, timeout))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    out.seek(0)
    text = out.read()
    out.close()
    for line in text.splitlines():
        log(f"  [{label}] {line}")
    log(f"{label} exited {rc} after {seconds:.1f} s")
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}")
    return text


def start_dryrun():
    """Phase 17(c): the dry-run in a subprocess (``start_subprocess``)."""
    return start_subprocess(["-m", "repro_torch.launch.dryrun", *X16_DRYRUN],
                            "dry-run " + " ".join(X16_DRYRUN))


def dryrun_check(dryrun) -> None:
    """Wait for ``start_dryrun``'s process and raise unless it exited 0
    with its four lines."""
    text = finish_subprocess(dryrun, "dry-run", X16_TIMEOUT_S)
    head = "== tinyllama-1.1b x train_4k x 16x16 (train, n_layers=4) =="
    lines = text.splitlines()
    if head not in lines or [line.split(":")[0] for line in
                             lines[lines.index(head) + 1:lines.index(head) + 4]] != [
            "memory_analysis", "cost_analysis", "roofline"] or \
            "1/1 combinations traced" not in text:
        raise AssertionError("the dry-run did not print its four lines")


def x16_phase(dev, smi: str, results):
    """Phase 17: (a) the 16-bit rows and (b) the per-leaf engine's bf16
    route; then (d) the examples, each in a subprocess, all at once
    ((c), the dry-run, ran beside phases 1-4). Returns (b)'s launches by
    path."""
    import torch

    t0 = time.perf_counter()
    bf16, f16 = torch.bfloat16, torch.float16
    for dtype, W, d, timing, seed, big in [
            (bf16, 10, MAIN_D, (20, 50), 1, False), (f16, 10, MAIN_D, (20, 50), 2, False),
            (bf16, 10, X16_ODD_D, (20, 50), 3, False),
            (bf16, TRAIN_W, train_n_pad(), (1, 1), 4, True)]:
        x16_rows(dev, results, dtype, W, d, timing, seed, big)
    log(f"phase 17(a) done at {time.perf_counter() - t0:.1f} s of the phase")
    launches = x16_per_leaf(dev, smi)
    log(f"phase 17(b) done at {time.perf_counter() - t0:.1f} s of the phase")
    examples = [start_subprocess([path, *args], path) for path, args in X16_EXAMPLES]
    try:
        for run, (path, _) in zip(examples, X16_EXAMPLES):
            finish_subprocess(run, path, X16_TIMEOUT_S)
    finally:  # a phase that fails leaves no process behind
        stop_subprocesses(examples)
    seconds = time.perf_counter() - t0
    log(f"phase 17: {seconds:.1f} s ({'within' if seconds <= X16_BUDGET_S else 'over'} the "
        f"budget of {X16_BUDGET_S:.0f} s)")
    return launches


def stop_subprocesses(started) -> None:
    """End every ``start_subprocess`` process of ``started`` still running."""
    for proc, _, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def stop_resource_tracker() -> None:
    """Stop the process ``multiprocessing`` starts beside this one to track
    the rank groups' semaphores (``spawn_ranks``) and wait for it. It exits
    by itself only once this process has exited, so without this it can
    outlive the script."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    def done(phases: str) -> None:
        """Where the script's time goes: the clock at the end of each phase."""
        log(f"chip_smoke: phase {phases} done at {time.perf_counter() - t_start:.1f} s")

    # phase 17(c) on the host's CPU beside phases 1, 2 and 4, which time
    # nothing on the host; it ends before phase 3 times the slice's rounds
    dryrun = start_dryrun()
    try:
        ptxas = build_phase()
        done("1")
        results = kernel_phase(dev)
        done("2")
        results.update(norm_kernel_phase(dev))
        done("4")
        dryrun_check(dryrun)
    finally:
        stop_subprocesses([dryrun])
    done("17(c)")
    launches = slice_phase(dev, smi)
    done("3")
    launches.update(ops_phase(dev))
    launches.update(sync_phase())
    done("5-6")
    results.update(attention_phase(dev))
    done("7")
    launches.update(serve_phase(dev, results))
    done("8")
    paper, split = paper_phase(dev, smi)
    launches.update(paper)
    done("9")
    launches.update(telemetry_phase(dev, split))
    done("10")
    train, train_rows = train_phase(dev, smi)
    launches.update(train)
    done("11")
    launches.update(moe_phase(dev, smi))
    done("12")
    ssm_launches, ssm_rows = ssm_phase(dev, smi)
    launches.update(ssm_launches)
    done("13")
    launches.update(prefix_codebook_phase(dev, smi))
    done("14")
    # phase 15(i)'s 16 ranks start up beside phase 15's and wait for it
    heads = start_heads()
    try:
        launches.update(mesh_phase(dev, smi))
        done("15")
        launches.update(heads_phase(dev, smi, heads))
        done("15(i)")
    finally:
        stop_heads(heads)
        del heads  # its events' semaphores, before the resource tracker stops
    launches.update(cnn_phase(dev, smi, results))
    done("16")
    launches.update(x16_phase(dev, smi, results))
    done("17")
    for rows_by_kernel in (train_rows, ssm_rows):
        for name, rows in rows_by_kernel.items():
            results[name].extend(rows)

    src = {"bucket_mix": "bucket_mix.cu", "pairwise_gram": "pairwise_gram.cu",
           "cwise_median": "selection.cu", "cwise_trimmed_mean": "selection.cu",
           "residual_norms": "residual_norms.cu", "cclip_fused_iter": "residual_norms.cu",
           "cclip_combine": "cclip.cu", "flash_attention": "flash_attention_wgmma.cu"}
    # flash_attention: the tensor-core kernel (bf16, the main path's rows) and
    # the CUDA-core one (fp32 and the bf16 inputs TMA refuses)
    # bucket_mix, residual_norms, cclip_fused_iter and cclip_combine: every
    # instance's ptxas report (residual_norms_kernel<RC,NSUB,FORM,ALIGNED>:
    # FORM 0 the given centre, 1 the coefficients, 2 the CCLIP update)
    # the selection kernels: each built instance's report (its name gives W
    # and n_trim); each case row gives its block size
    norms = ptxas["residual_norms"]
    other = {"bucket_mix": {"ptxas": ptxas["bucket_mix"]},
             "residual_norms": {"ptxas": {i: r for i, r in norms.items()
                                          if i.split(",")[2] != "2"}},
             "cclip_fused_iter": {"ptxas": {i: r for i, r in norms.items()
                                            if i.split(",")[2] == "2"}},
             "cclip_combine": {"ptxas": ptxas["cclip"]},
             "cwise_median": {"ptxas": ptxas["cwise_median"]},
             "cwise_trimmed_mean": {"ptxas": ptxas["cwise_trimmed_mean"]},
             "flash_attention": {"sources": [
        "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro_torch/kernels/csrc/tma.cuh"], "ptxas": ptxas["flash_attention_wgmma"]},
        # pairwise_gram: one kernel, X staged by TMA (aligned rows, the main
        # path's) or by predicated loads (the per-leaf chain's unaligned leaves)
        "pairwise_gram": {"sources": [
            "src/repro_torch/kernels/csrc/pairwise_gram.cu",
            "src/repro_torch/kernels/csrc/tma.cuh"], "variants": ["gram_tma", "gram_ldg"],
            "ptxas": ptxas["pairwise_gram"]}}
    tpu = {"bucket_mix": "src/repro/kernels/bucket_mix.py:28",
           "pairwise_gram": "src/repro/kernels/pairwise_gram.py:47",
           "cwise_median": "src/repro/kernels/cwise_median.py:47",
           "cwise_trimmed_mean": "src/repro/kernels/trimmed_mean.py:43",
           "residual_norms": "src/repro/kernels/weiszfeld_norms.py:68",
           "cclip_fused_iter": "src/repro/kernels/cclip_fused.py:50",
           "cclip_combine": "src/repro/kernels/cclip_combine.py:33",
           "flash_attention": "src/repro/kernels/flash_attention.py:74"}
    kernels = []
    for name, rows in results.items():
        main_row = rows[0]  # the main path's shape comes first
        by_path = {label: counts[name] for label, counts in launches.items()}
        if not sum(by_path.values()):
            raise AssertionError(f"{name} never launched on the main paths")
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src[name]}",
            replaces=tpu[name], launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=main_row["max_abs_err"],
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"], cases=rows,
            **other.get(name, {})))
    log(f"chip_smoke: phases 1-17 passed in {time.perf_counter() - t_start:.1f} s")
    stop_resource_tracker()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
