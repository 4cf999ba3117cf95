#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--out DIR]     # from the repository root

Phases, in order; any failure raises and the process exits non-zero:

1. device: the card's name and power limit, the host's total and
   available memory (``/proc/meminfo``, printed again after every phase
   with its wall seconds), the kernels' build
   (``src/repro_torch/csrc/*.cu`` -> one shared library, timed), the
   attention kernels' registers, shared memory and spills (``-Xptxas
   -v``) and the measured pinned host-to-device copy rate, from a block of
   PyTorch's pinned allocator and from a view into a host-pool buffer
   written and then registered in place, the two copied in turn
   (``HostBuffer``: ``is_pinned()`` and at least 0.8x the allocator's
   rate);
2. kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (smollm-135m heads and rows, llama3-8b's,
   llama2-13b's, phi3.5-moe's and deepseek-v3's rows (7168; ``q_a_norm``
   rows of 1536; ``kv_a_norm`` rows of 512 read in place at a row stride
   of 576, on the kernel's 16-byte load path), qwen3-14b's and
   chameleon-34b's head-norm rows; paged and dense decode also at B = 1,
   T = 4096 and at lengths shorter than one split, length 0 giving
   zeros), each timed beside its roofline bound and one PyTorch library
   call; rmsnorm also in its residual form (``s`` equal to ``x + r`` and
   ``y`` to the unfused kernel on ``s``, bit for bit, timed beside ``x + r;
   F.rms_norm`` and ``x + r`` then the kernel) and in its split-row form
   at one rank's slices at tp = 2 (2,560 of 5,120, 2,048 of 4,096 and
   1,024 of 2,048: zamba2's Mamba2 norm, xlstm-1.3b's mLSTM and sLSTM
   norms; each launch against its plain version, the slice beside the
   other ranks' against the whole row's norm, the slice normalised alone
   apart from it; timed beside ``F.rms_norm`` on the whole row); then, at smollm-135m's,
   llama3-8b's and gemma-2b's heads, bitwise
   invariance of the bf16 flash, decode and paged decode kernels (a
   suffix prefill's rows equal the whole prefill's, a sequence alone
   equals it in a batch, a repeated call equals the first) and paged
   decode equal to dense decode over the same rows (bf16 and fp32,
   lengths 0 to 512); then at llama2-13b's heads (40 / 40 / 128, G = 1)
   and chameleon-34b's (64 / 8 / 128): paged decode (bf16 and int8) and
   dense decode at B = 8 and at B = 1, T = 4096, flash at S = T = 384,
   and the invariance checks; then the rank split of dense decode (a
   cache split by sequence): ``decode_attention_slice`` on each of 1, 2
   and 4 slices of 512 rows (lengths that leave slices empty: zeros and
   -inf there) and ``decode_merge_ranks`` over them, at llama3-8b's and
   chameleon-34b's heads in fp32 (2e-5) and bf16 (2e-2), against their
   plain versions and the merge against the unsplit kernel; both timed at
   phase 18's shapes (8 sequences over a rank's 2,048 rows; 16 ranks);
3. serving: smollm-135m at full width (30 layers, bf16, seeded random
   weights) through ``ContinuousBatchingEngine`` over a
   ``PagedKVCachePool``, with a baked shared prefix, a chunked-prefill pass
   and an int8-arena pass; the kernels' launch counts (attention and
   rmsnorm, 2L+1 per model call, L of them with the residual add fused)
   are checked against the engine's decode steps and prefill calls;
4. parity: a 2-layer fp32 smollm-135m at full width on the card (kernels)
   against the same seeded weights on the CPU (plain versions), through
   the paged pool and through the sequential ``Engine``; the card's
   layer-streamed prefill of a forked session equals its monolithic one;
5. engine: the sequential ``Engine`` (dense cache, ``decode_attention``)
   on smollm-135m at full width, then a ``paged=False`` continuous pass
   over phase 3's workload, whose greedy tokens must all equal the paged
   pass's; launch counts checked per layer and step;
6. TIDAL: ``FaaSRuntime`` on smollm-135m at full width with a static
   function (131-token template prompt) and a LoRA function, ~16
   invocations through the gateway's pump thread covering cold, warm and
   fork; streamed prefill, byte accounting, stream order, the forking
   guard and fork-equals-warm tokens are checked, and the first
   invocation's TTFT is measured in fresh processes with and without
   prewarming (the two start together and register their function at
   once; then each in turn deploys and serves);
7. tenants: a shared smollm-135m base at full width with a 4-row adapter
   bank (wq, wv; rank 8) serving three LoRA functions and the base, 16
   invocations through the pump thread, at least one decode step mixing
   adapter rows; a 2-layer fp32 check of each adapter function against
   its merged-weight model; then the control plane: a learned 128-token
   prefix baked after three misses and reused by the fourth invocation,
   and a 24-request open-loop Poisson replay at 4 qps;
8. ssm: ``ssd_scan`` against both of its plain versions (chunked and
   sequential) at zamba2-2.7b's shapes (H = 80, dh = ds = 64, chunk 128;
   S = 64, 128, 384, 512, a ragged 200, and B = 4 with an initial state,
   whose sequences run alone must give the batch's bits; B and C in bf16
   and fp32; one tp = 2 rank's 40 heads at S = 96 and B = 4 with h0),
   and ``flash_attention`` / ``decode_attention`` at zamba2's head dim of
   80 (and a rank's 16 heads), all timed, with the bitwise invariance checks
   (paged equal to dense included) at zamba2's heads; then zamba2-2.7b at full width
   (54 Mamba2 layers and one shared attention block applied 9 times,
   bf16, seeded random weights) through a dense-pool
   ``ContinuousBatchingEngine`` (12 requests) and the sequential
   ``Engine`` (8 x 256 tokens, the continuous engine's tokens equal),
   with exact launch counts (ssd_scan 54 and flash 9 per prefill call,
   decode 9 per step, rmsnorm 127 per model call, 9 of them fused); a
   2-layer fp32 card
   against CPU check, streamed prefill equal to prefill, and
   ``FaaSRuntime`` cold / fork / warm for a static zamba function;
9. llama2-13b at full width (d_model 5120, 40 query and key heads of
   128, bf16) and 10 of its 40 layers (6.7 GB of seeded random weights
   drawn leaf by leaf; cut for the script's time limit): phase 3's paged serving passes (bf16 and int8 arenas), the
   sequential ``Engine`` (8 x 256 + 32) with the continuous engine's
   tokens equal to it, exact launch counts, the decode step at 8 busy
   slots (host ms, device-busy share under ``torch.profiler``) beside its
   byte bound, ``FaaSRuntime`` cold / warm / fork of a static function
   with the template prompt (every fork streams the whole model; fork
   tokens equal warm; peak device allocation under three copies), then a
   2-layer fp32 card against CPU check and streamed prefill equal to
   prefill;
10. phi3.5-moe-42b-a6.6b at full width (d_model 4096, 32 / 8 heads of
   128, 16 experts of 6400, top-2, capacity factor 1.25, bf16) and
   the largest depth of its 32 layers, at most 4, at which a warm copy, a
   fork's copy and the arena fit the card and the host's memory (printed
   as reduced, with the budget that stopped it): the paged serving passes at 8
   slots (plain, chunked, int8), the (token, k) pairs the capacity drops
   (decode and prefill), the plain and chunked passes again at cf = E/K
   (dropless), a 384-token prompt prefilled whole and in 64-token chunks
   (fp32 at one layer: the same expert choices and logits within 1e-3; in
   bf16 the expert choices that rounding flips are counted), a 4-slot pass
   (decode dropless) equal to the
   sequential ``Engine`` run prompt by prompt, the decode step beside its
   byte bound (the batched expert products read every expert),
   ``FaaSRuntime`` with a static and a LoRA function (``blocks.attn.wq``)
   cold / warm / fork, then 1-layer fp32 card against CPU checks with
   every call's routing and kept pairs equal, at 2 slots and at 8 slots
   with a prefill in 48-token chunks (pairs dropped at decode and in the
   chunks), and streamed prefill equal to prefill;
11. deepseek-v3-671b at full width (MLA: 128 heads, ranks 1536 / 512,
   dims 128 / 64 / 128; 256 experts of 2048, top-8, one shared expert;
   vocabulary 129,280; bf16) at the depth ``fitting_depth`` works out
   (one layer and the head are 26.7 GB; printed as reduced): phase 3's
   paged serving passes over the latent arena (plain, chunked, int8),
   the pairs the capacity drops at cf 1.25, a dropless 8-slot pass equal
   to the sequential ``Engine`` run prompt by prompt, the arena's bytes
   per token per layer (1,152 bf16, 584 int8) beside a GQA cache's at 128
   heads of 128, the decode step beside its byte bound (no
   ``FaaSRuntime`` pass here: its 26.7 GB host checkpoint and pinned
   pool cost ~27 s of the script's time; phase 15 serves deepseek-v3
   through ``FaaSRuntime`` at tp = 2); exact launch counts (rmsnorm 4L+1
   per call, L fused, no attention kernel); then 1-layer fp32 card against CPU checks with the
   experts cut to 32 (logits within 1e-4 of the largest, routing and kept
   pairs equal) at 2 slots and at 8 slots with a 48-token chunked
   prefill, and streamed prefill equal to prefill;
12. xlstm-1.3b at full width, 8 of its 48 layers (7 mLSTM and 1 sLSTM
   blocks, printed as reduced; d_model 2048, 4 heads, mLSTM head dim
   1024, chunk 128, vocabulary 50,304, bf16, seeded random weights):
   rmsnorm at xLSTM's rows (8 and 512 rows of 2048 and 4096, both forms), then the
   dense-pool ``ContinuousBatchingEngine`` (8 slots, 12 requests of 16
   new tokens, prompts of 32 to 512 tokens that keep the reference's
   chunk rule; tokens/s, TTFT, decode host ms, state bytes per slot), the
   sequential ``Engine`` (8 x 256 + 32) with the continuous engine's
   tokens equal to it, exact launch counts (rmsnorm 18 per model call, 1
   with the residual fused; no attention kernel, no ``ssd_scan``), the
   decode step at 8 busy slots beside its byte bound (the weights, and
   the recurrent state read and written once), a 512-token prefill with
   its sLSTM time loop's share, ``FaaSRuntime`` cold / warm / fork of a
   static function (a fork streams the whole model; fork tokens equal
   warm; page-locked bytes within 1.05 times the weights), the peak
   allocation; then a 2-layer fp32 card against CPU check (one mLSTM
   and one sLSTM block: logits within 1e-4 of the largest, tokens equal)
   and streamed prefill equal to prefill;
13. whisper-medium at full width and depth (24 encoder and 24 decoder
   layers, d_model 1024, 16 heads of 64 (G = 1), d_ff 4096, vocabulary
   51,865 with a tied head, 448 decoder positions; bf16, 1.52 GB of
   seeded random weights): ``flash_attention`` at its shapes, non-causal
   at B = 8 over 1,500 keys with S = 1,500 (the encoder) and S = 4
   (cross-attention of a 4-token prompt) and causal at S = T = 64, and
   ``decode_attention`` at B = 8 over 1,500 rows (cross) and 448 rows at
   per-sequence lengths (self), bf16 and fp32, each against its plain
   version and timed beside SDPA and the bound; then
   ``Engine.generate(frames=)`` at 8 sequences over 1,500 frames
   (``make_frames``) with 4-token prompts and 444 new tokens, so 447 of
   the 448 decoder rows fill (TTFT: encoder, every layer's cross K/V and
   the prompt; decode host ms per step; tokens/s; peak allocation), with
   exact launch counts (72 flash per prefill, 48 ``decode_attention``
   per step, no rmsnorm, paged decode or ``ssd_scan``); the first and
   the last sequence alone against the batch over 32 tokens (printed,
   not asserted); the
   decode step over the filled cache beside its byte bound (decoder
   weights without the cross K/V projections, the tied head, the cross
   K/V and the self K/V rows); ``ContinuousBatchingEngine`` refusing the
   model; then a 2 + 2-layer fp32 card against CPU check over 1,500
   frames (logits within 1e-4 of the largest, 16 greedy tokens equal);
14. training, fp32: the backward kernels (``flash_attention_bwd`` at
   smollm's heads, S = T = 128 and 2,048 at B = 8, with a softcap, at
   phi3.5-moe's heads (32 / 8 / 128) over 512, whisper's non-causal
   encoder (1,500 over 1,500) and cross-attention (64 over 1,500);
   ``rmsnorm_bwd`` plain and residual at smollm's training rows and on
   strided q_norm rows) against their plain versions (1e-4 of the
   largest |grad|; 1e-5 for rmsnorm), each run twice to the same bits,
   timed beside the plain version, the library call's backward and the
   bound; then ``repro_torch.launch.train``'s ``train()`` on smollm-135m
   at full width and depth at the CLI's defaults (batch 8, seq 128,
   remat) for 6 steps, exact launches per step (flash 2L, rmsnorm 4L +
   1, 2L fused, flash backward L, rmsnorm backward 2L + 1), step time,
   tokens/s and peak memory, a second run checkpointing every 3 steps,
   stopped at step 3 and resumed to 6, whose losses, parameters and
   optimizer state equal the first's bit for bit, the device-busy share
   of two steps under ``torch.profiler``, the loss falling over 5 steps
   on one batch, one step at seq 2,048; card-against-CPU steps of
   smollm-135m (2 layers), phi3.5-moe (1 layer, 4 of its 16 experts, 1 x
   64) and whisper-medium (1 + 1 layers), one each (loss 1e-5, grad norm 1e-4
   relative, parameters 1e-5 of the largest);
   phi3.5-moe at full width and 1 of 32 layers (printed as reduced) and
   whisper-medium at full width and depth (2 x 1,500 frames, 64 decoder
   tokens), 3 steps each with exact launches (phi3.5-moe's load-balancing
   loss finite and nonzero); ``ssd_scan_bwd`` at zamba2-2.7b's training
   shapes (B = 8, S = 128, H = 80, dh = ds = 64; its own 16-row chunks)
   and at S = 200 (a partial chunk) with ``h0`` and ``dh_final``, B and C
   strided views (1e-4 of the largest |grad|), and the split-row rmsnorm's
   backward on a tp = 2 rank's 8 x 128 x 2,560 (1e-5, the slices put
   together against the whole row's backward), each twice to the same
   bits and timed beside its plain version and bound; zamba2-2.7b at full
   width and depth through ``train()`` at the CLI's defaults (3 steps,
   exact launches: ``ssd_scan`` 2L, its backward L, rmsnorm 4L + 2U + 1,
   flash and its backward U), the loss falling over 4 steps on one
   batch at lr 1e-5, and the run's first step again at its lr with the
   plain ``ssd_scan`` backward on the card (gradients within 1e-4 of
   the kernel route's, the second loss within 1e-3 of the run's:
   ``zamba_plain_witness``); and card-against-CPU steps (one each) of
   zamba2-2.7b and xlstm-1.3b at full width and one unit;
15. tensor parallelism: llama3-8b, phi3.5-moe-42b-a6.6b,
   deepseek-v3-671b, zamba2-2.7b and xlstm-1.3b at full width served by
   2 ranks sharing the card
   (``repro_torch.distributed.spawn``, gloo: NCCL refuses two ranks on
   one device) through ``FaaSRuntime(mesh=ServingMesh(1, 2))``, each
   rank's shard drawn on the card from the seed (llama3-8b and
   phi3.5-moe 16 query / 4 KV heads; phi3.5-moe 8 of its 16 experts,
   whole; deepseek-v3 64 MLA heads, 128 of its 256 experts and half the
   shared expert, its latent arena whole on each rank: 1,152 bytes per
   token per layer, asserted): per case a paged bf16 / fp32 pass and, in
   fp32, an int8 one, each deploying with a 64-token template prompt, then cold,
   fork (after an evict; its prefill streamed while the rank's shard is
   in flight), a prefix hit and warm, the launches of every rank read
   per invocation (L flash per prefill and L paged decode per step for
   GQA, none for MLA; 2L + 1 rmsnorm per call, 4L + 1 with MLA) and its
   collectives (2L + 2 per model call: one per attention, one per moe
   or MLP layer, the embedding and the head), each rank's weight bytes
   against the configuration's reckoning, and the divergence guard on
   every op; the same in one ``tp = 1`` process run beside the two ranks
   (``tp_runs``: it takes deepseek-v3's case first, the ranks theirs
   once it has ended).  fp32 at 2 layers (llama3-8b
   and phi3.5-moe): greedy tokens of every invocation equal to ``tp =
   1``, and for phi3.5-moe the expert ids, ``keep`` masks and dropped
   pairs of every moe call (``moe.watch`` on the controller) equal too;
   bf16 (llama3-8b at 8 of 32 layers, phi3.5-moe at 4 of 32,
   deepseek-v3 at 1 of 61): the first prefill's logits within 5% (2% for
   deepseek-v3) of the largest |logit| of ``tp = 1``'s (the share of
   equal greedy tokens printed).  deepseek-v3's fp32 parity is held on the CPU only
   (``tests/test_torch_tp_moe.py``): one fp32 layer is ~53 GB per copy,
   and a fork needs a second.  Fork TTFT, bytes streamed and pinned per
   rank, and the decode step's host, device-span and collective ms per
   rank, each beside the card's name and power limit.  Phase 2 also
   holds the kernels at one rank's heads (llama3-8b and phi3.5-moe 16 /
   4 / 128, gemma-2b 4 / 1 / 256: G = 4).  zamba2-2.7b (16 query / 16
   KV heads and 40 of 80 Mamba2 heads per rank, B and C whole) and
   xlstm-1.3b (2 of 4 heads: the mLSTM's x_inner whole, its heads'
   2,048 of 4,096, the sLSTM's 1,024 of 2,048 and half its post-MLP)
   serve over the dense slot pool: no int8 arena, no template prefix,
   so the third invocation is a plain warm one; fp32 at one unit (6
   Mamba2 blocks and the shared block; 7 mLSTM blocks and 1 sLSTM) with
   greedy tokens equal to ``tp = 1``, bf16 at two units (12 of 54; 16 of
   48) with the first logits within ``tp_logit_bound``; every norm over
   a split row runs the split-row rmsnorm (two launches and one
   collective each), so a call makes 2L + 2U + 2 collectives (zamba) or
   2M + 3U + 2 (xLSTM), and launches L ``ssd_scan`` and U flash per
   zamba prefill, U ``decode_attention`` per step, all asserted per
   rank.  LoRA at tp = 2 (in the fp32
   llama3-8b run of both processes): the case's function deployed as a
   shared base whose bank adapts wq, wk, wv and wo, three adapter
   functions attached and served together with it (the adapter rows of
   every decode step printed), then a merged ``lora_function`` cold, forked
   onto another adapter and warm: every function's greedy tokens equal
   to ``tp = 1``, launches and collectives exact per rank; in the bf16
   llama3-8b run the first prefill's logits through a bank row within
   ``TP_LORA_LOGIT_BOUND`` of ``tp = 1``'s.  Two tensor-parallel
   instances (``FaaSRuntime(mesh=ServingMesh(2, 2))``, 4 ranks sharing
   the card over gloo, llama3-8b fp32 at 2 layers): cold on instance 0,
   a fork kept there by locality, a fork routed to instance 1 once
   instance 0 holds more than one extra engine (its template prefix
   baked there at that fork), warm, and a prefix hit on each instance:
   tokens equal to ``tp = 1``'s, launches exact on the serving group's
   ranks and none on the other's, page-locked bytes per rank group
   within 1.05 times the group's weights, fork bytes per rank alike in
   both groups, and every rank's pools back after ``evict``.  llama3-8b
   under a ``prefer_seq`` plan (each rank holds half the positions of
   every KV head; decode through ``decode_attention_slice`` and
   ``decode_merge_ranks``): two 96-token prompts and 16 greedy steps
   beside one process's dense decode, fp32 at 2 layers with the tokens
   equal, bf16 at 8 layers with the first logits within the case's
   bound, the launches and each step's collectives by kind and bytes
   against ``tp_seq_collectives``.  Heads the model axis does not divide
   (``sharding.head_split``): smollm-135m at full width and all 30
   layers (9 query / 3 KV heads: 6 / 2 on rank 0, 3 / 1 on rank 1)
   through ``FaaSRuntime`` cold, fork, prefix hit and warm, fp32 with
   greedy tokens equal to ``tp = 1`` and bf16 with the first logits
   within 5%, launches and collectives exact on both ranks; whisper-medium
   at full width and depth under the plan (8 of 16 heads per rank in the
   encoder, the decoder's self-attention and its cross-attention), a
   prefill of 2 x 1,500 frames and 16 greedy decode steps through
   ``Model`` (the sequential ``Engine`` takes no plan for enc-dec, as the
   reference's), fp32 tokens equal to ``tp = 1`` and bf16 first logits
   within 5%, 72 flash launches per prefill and 48 ``decode_attention``
   per step on each rank, 120 and 72 collectives; and ``python -m
   repro_torch.launch.serve --tp 2 --arch smollm-135m`` on the card
   (run beside phase 18; its lines name each rank's heads).  Phase 2
   holds the kernels at those ranks' heads (smollm 6 / 2 and 3 / 1,
   qwen3-14b's (16, 16) ranks 3 / 1 and 2 / 1 at d = 128, whisper 8 / 8);
16. cluster: ``FaaSRuntime(mesh=ServingMesh(2, 1))``, two instances
   sharing the card, serving smollm-135m at full width and depth (bf16,
   paged arenas): a static and a LoRA function land on different
   instances, the LoRA function's second engine (a new event) on its
   warm instance, every invocation's greedy tokens equal the sequential
   ``Engine``'s over the same weights, launches exact, and ``evict``
   puts each instance's pool back at its baseline; then
   ``measure_service_times`` on that runtime (two fresh functions, prompt
   buckets of 64 and 256 tokens), each entry printed beside the port's
   cost model for ``plan_for("smollm-135m", 1, L)`` on the card's profile
   with the measured host-to-device rate, warm below fork and cold at
   each bucket; then the port's ``ClusterSim`` with that table as its
   oracle over a seeded trace under ``serverlessllm``, ``tidal`` and
   ``tidal-dk`` (``summarize`` printed; every lookup served from the
   table);
17. train_tp: four models at full width, fp32 and remat as the training
   CLI trains, depth cut for the script's time (``TRAIN_TP_CASES``):
   llama3-8b (4,096 wide, 32 / 8 heads, d_ff 14,336, vocabulary 128,256)
   at 1 of 32 layers, 4 x 128; zamba2-2.7b at one unit (6 Mamba2 blocks
   and the shared block), 4 x 128; xlstm-1.3b at one unit (7 mLSTM and 1
   sLSTM blocks), 4 x 128; whisper-medium at 1 + 1 layers, 4 x (1,500
   frames, 64 tokens).  Each trained from one seed's weights three ways
   on the card (every rank first takes one warm-up training step, all at
   once: ``_warm_rank``): one process and tp = 2 (2 ranks) for 2 steps,
   FSDP over ``ServingMesh(2, 2)`` (4 ranks) for one, all in one spawn of 4 gloo ranks
   (``spawn(..., data=2)``; per case rank 0 runs the one process, then
   ranks 0 and 1 the tp = 2 run over their model-axis group, then all
   four the FSDP run) through ``make_train_step`` under
   ``group.training_plan``.  Held against the one process: step 1's loss
   (1e-5 relative) and every gradient leaf put back together from the
   ranks' pieces (each cut on the first rank's card and sent to the
   rank that holds it; 1e-4 of its largest, or 4 times the model's fp32
   floor where that is larger: the gradients' largest move under weights
   perturbed by 1e-7, ``grad_floor``), the grad norms (1e-4), the
   parameters (1e-5 where AdamW is well conditioned, the criterion of
   ``train_parity``) after the last step, or after the first for FSDP
   and for zamba2 and xlstm (their decay and gate leaves have elements
   whose gradients sit near zero: AdamW moves those by up to lr either
   way, and every later gradient reads them); exact kernel
   launches per rank per step (``train_launches``: dense flash 2L,
   rmsnorm 4L + 1 with 2L fused, flash backward L, rmsnorm backward 2L
   + 1; zamba ``ssd_scan`` 2L and its backward L, at tp = 2 the gated
   norm in the split-row form, 4L launches forward and 2L backward;
   xlstm's inner norms split alike; whisper's flash per layer), exact
   collectives per step by kind with their bytes
   (``train_tp_collectives``) and each rank's bytes of parameters and
   optimizer state against ``train_tp_state_bytes``.  A control of the
   gradient limit (``TRAIN_TP_PLANTS``): zamba2's and xlstm's step 1 at
   tp = 2 again with the replicated weights' column sums skipped (Mamba2's
   B / C columns, the mLSTM's ``x_inner`` columns) must read beyond it.  Printed: ms per
   step per rank, its collective ms (gloo through the host: no measure
   of tensor-parallel speed) and peak allocation;
18. dryrun: one rank of chameleon-34b ``decode_32k`` on the production
   mesh (16, 16) at its full per-rank size (~4.3 GB of weights drawn on
   the card, 3.2 GB of cache split by sequence), then in the same process
   qwen3-14b's ``decode_32k`` rank 0 (its 40 heads split unevenly: 3
   query heads on 1 KV head, the busiest rank; ~1.8 GB of weights, 5.4 GB
   of cache), each through
   ``repro_torch.launch.dryrun.run_cell`` under torch's fake process group
   (set up and destroyed around the cell): the step's peak allocation above its
   arguments within 5% of the ``meta`` reckoning of the same step, its
   collectives by kind and bytes equal to the reckoning's, the slice and
   merge entries once per layer per step; its device ms printed beside
   the roofline's ``H100_SXM`` terms (the fake group moves no data: no
   logits are read).

Phase 8's kernels run right after phase 2; phase 17's spawn starts then
and runs beside phases 3 to 8 (``train_tp_spawn``), and its checks run
before phase 9.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Detailed results go to
``DIR/chip_smoke.json`` (default ``results/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEFAULT_OUT = ROOT / "results"

# NVIDIA H100 SXM peaks (data sheet, dense): HBM bytes/s and FLOP/s by type
# ("tf32": fp32 operands on the tensor cores, one TF32 pass)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}

SMOLLM = dict(H=9, KV=3, d=64)
LLAMA3_8B = dict(H=32, KV=8, d=128)
LLAMA2_13B = dict(H=40, KV=40, d=128)             # G = 1 at d = 128
CHAMELEON_34B = dict(H=64, KV=8, d=128)
GEMMA_2B = dict(H=8, KV=1, d=256)
# one rank's heads at tp = 2 (phase 15): llama3-8b splits its KV heads
# (G = 4, as at tp = 1), gemma-2b keeps its one KV head (G = 8 -> 4)
LLAMA3_8B_TP2 = dict(H=16, KV=4, d=128)
GEMMA_2B_TP2 = dict(H=4, KV=1, d=256)
# ranks of heads the model axis does not divide (sharding.head_split):
# smollm-135m at tp = 2 (phase 15; G = 3 on both), qwen3-14b at (16, 16)
# (phase 18's cell; G = 3 and 2), whisper-medium at tp = 2 (G = 1)
SMOLLM_TP2 = (dict(H=6, KV=2, d=64), dict(H=3, KV=1, d=64))
QWEN3_14B_16 = (dict(H=3, KV=1, d=128), dict(H=2, KV=1, d=128))
WHISPER_TP2 = dict(H=8, KV=8, d=64)
ZAMBA2_ATTN = dict(H=32, KV=32, d=80)             # the shared attention block
ZAMBA2_SSD = dict(H=80, dh=64, ds=64, Q=128, d_inner=5120)
# one rank's share of zamba2 at tp = 2 (phase 15): half the heads of the
# shared block and of the Mamba2 mixer (B and C whole)
ZAMBA2_ATTN_TP2 = dict(H=16, KV=16, d=80)
ZAMBA2_SSD_TP2 = dict(H=40, dh=64, ds=64, Q=128, d_inner=2560)
# the split-row rmsnorm at tp = 2 (phase 15): (tag, the rank's slice, the
# whole row): Mamba2's gated norm, the mLSTM's and the sLSTM's norms
SPLIT_RMSNORM_CASES = (("zamba2-mamba-norm/tp2", 2560, 5120),
                       ("xlstm-mlstm-norm/tp2", 2048, 4096),
                       ("xlstm-slstm-norm/tp2", 1024, 2048))
PAGE_SIZE = 8
SERVE_LAYERS = 30
RMSNORM_CASES = (("smollm-decode", (8, 1, 576)), ("smollm-prefill", (384, 576)),
                 ("qwen3-14b-head", (8, 1, 40, 128)),
                 ("llama3-8b-prefill", (384, 4096)),
                 ("chameleon-34b-head", (8, 1, 64, 128)),
                 ("llama2-13b-decode", (8, 1, 5120)),
                 ("llama2-13b-prefill", (384, 5120)),
                 ("phi3.5-moe-decode", (8, 1, 4096)),
                 ("deepseek-v3-decode", (8, 1, 7168)),
                 ("deepseek-v3-prefill", (384, 7168)),
                 ("deepseek-v3-q_a_norm", (8, 1, 1536)))
# MLA's kv_a_norm reads the latent rows of the wkv_a product in place:
# rows of 512 at a row stride of 576 (the latent and the rope key)
STRIDED_RMSNORM_CASES = (("deepseek-v3-kv_a_norm", (8, 1, 512), 576),)
# one device's serving launches no backward kernel (training, phase 14,
# does), no split-row rmsnorm (a row cut over ranks, phase 15) and no
# entry over a sequence-sharded cache (phases 15 and 18)
NOT_LAUNCHED = {"flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0,
                "rmsnorm_split": 0, "rmsnorm_split_bwd": 0,
                "decode_attention_slice": 0, "decode_merge_ranks": 0}
# zamba2-2.7b serving prompts: six take the JAX mixer's chunked branch
# (<= 128 tokens or a multiple of 128), six are ragged
ZAMBA_LENGTHS = (64, 200, 128, 300, 256, 150, 100, 333, 384, 250, 96, 180)


def _import_port():
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch/ not found beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, str(src))


class Background:
    """``fn(*args)`` on a thread of its own: a spawn of rank processes
    that the script's own phases run beside (the main thread only waits
    on its ranks).  :meth:`join` returns its result or raises its error."""

    def __init__(self, fn, *args):
        self.result, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(fn, args),
                                       name=fn.__name__, daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.result = fn(*args)
        except BaseException as e:      # re-raised on the joining thread
            self.error = e

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def warmup_stream() -> torch.cuda.Stream:
    """The one side stream that every timing's warm-up runs on before its
    capture.  PyTorch gives each stream that runs a cuBLAS call a workspace
    of its own (32 MiB on the H100) and keeps it for the life of the
    process: a new pool stream per timing took all 32 of the pool's and
    held 1.06 GB of the card for the rest of the script, which phase 12's
    peak then counted."""
    if not _WARMUP_STREAM:
        _WARMUP_STREAM.append(torch.cuda.Stream())
    return _WARMUP_STREAM[0]


_WARMUP_STREAM: list = []


def time_ms(fn, reps: int = 20, graph_calls: int = 10) -> float:
    """Mean device time of one ``fn()`` in ms.

    ``fn`` is captured ``graph_calls`` times into a CUDA graph and the
    graph replayed ``reps`` times between CUDA events, so host launch
    overhead is not in the number.
    """
    side = warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(graph_calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * graph_calls)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """The least time the card could take: max(ops / peak, bytes / HBM)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def paged_decode_work(B, H, KV, d, ps, lengths, q_dtype, kv_dtype) -> tuple:
    """(FLOPs, bytes) the paged decode of these lengths needs: each valid
    K/V row (and its scale) read once, q read and out written once."""
    rows = int(np.sum(lengths))
    kv_elt = torch.empty((), dtype=kv_dtype).element_size()
    q_elt = torch.empty((), dtype=q_dtype).element_size()
    nbytes = 2 * rows * KV * d * kv_elt + 2 * B * H * d * q_elt
    if kv_dtype == torch.int8:
        nbytes += 2 * rows * KV * 4
    nbytes += 4 * int(np.sum(-(-np.asarray(lengths) // ps))) + 4 * B
    flops = 4 * rows * H * d                      # QK and PV, per query head
    return flops, nbytes


def decode_work(B, H, KV, d, lengths, dtype) -> tuple:
    """(FLOPs, bytes) of dense-cache decode over these lengths: each
    selected K/V row read once, q and the lengths read, out written."""
    rows = int(np.sum(lengths))
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * rows * KV * d * elt + 2 * B * H * d * elt + 4 * B
    return 4 * rows * H * d, nbytes


def flash_work(B, H, KV, S, T, d, dtype, causal=True) -> tuple:
    """(FLOPs, bytes) of attention, causal with the bottom-right mask or
    over every (row, key) pair."""
    rows = np.arange(S)
    pairs = int(np.minimum(T, rows + (T - S) + 1).sum()) if causal else S * T
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = elt * (2 * B * H * S * d + 2 * B * KV * T * d)
    return 4 * B * H * pairs * d, nbytes


def ssd_work(B, S, H, dh, ds, Q, bc_dtype, with_h0: bool) -> tuple:
    """(FLOPs, bytes) of the chunked SSD scan.  Per chunk of n rows the
    causal pairs j <= i number P = n (n + 1) / 2: C_i . B_j once per
    (batch, chunk) (it is the same for every head), then per head the
    scores times x (2 P dh), C times the state and the state update
    (2 n dh ds each).  Bytes: xb, B, C, the log decays and h0 read once,
    y and the final state written once.  The kernel runs these products
    on the tensor cores, so its bound takes them at the TF32 peak, one
    pass (the least any design could use)."""
    flops = 0
    for c0 in range(0, S, Q):
        n = min(Q, S - c0)
        pairs = n * (n + 1) // 2
        flops += B * 2 * pairs * ds + B * H * (2 * pairs * dh + 4 * n * dh * ds)
    bc = torch.empty((), dtype=bc_dtype).element_size()
    state = B * H * dh * ds * 4
    nbytes = (2 * B * S * H * dh * 4 + 2 * B * S * ds * bc + B * S * H * 4
              + state * (2 if with_h0 else 1))
    return flops, nbytes


def rmsnorm_work(shape, dtype, residual: bool = False) -> tuple:
    """(FLOPs, bytes) of RMSNorm: x read and y written once, the scale
    read once; square, add, and two multiplies per element.  With the
    residual fused in, r read and s = x + r written once more, and one
    more add per element."""
    n = int(np.prod(shape))
    elt = torch.empty((), dtype=dtype).element_size()
    if residual:
        return 5 * n, elt * (4 * n + shape[-1])
    return 4 * n, elt * (2 * n + shape[-1])


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each value (8 significant bits)."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def sdpa_gqa(q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call with grouped KV heads."""
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def make_paged_case(gen, B, H, KV, d, ps, max_len, lengths, q_dtype,
                    int8: bool, device):
    """A random arena with shuffled disjoint page tables; rows of length 1
    and an all-null table stand for free slots, as in serving."""
    from repro_torch.models import quant
    NB = -(-max_len // ps)
    n_pages = 1 + B * NB
    kp = torch.randn((n_pages, ps, KV, d), generator=gen)
    vp = torch.randn((n_pages, ps, KV, d), generator=gen)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    pt = perm[:B * NB].reshape(B, NB).to(torch.int32)
    for b, n in enumerate(lengths):
        if n == 1:
            pt[b] = 0                              # free slot: null page
    q = torch.randn((B, H, d), generator=gen)
    case = {"q": q.to(device, q_dtype), "page_table": pt.to(device),
            "lengths": torch.as_tensor(lengths, dtype=torch.int32).to(device)}
    if int8:
        kq, ks = quant.quantize_rows(kp)
        vq, vs = quant.quantize_rows(vp)
        case.update(k_pages=kq.to(device), v_pages=vq.to(device),
                    k_scales=ks.to(device), v_scales=vs.to(device))
    else:
        case.update(k_pages=kp.to(device, q_dtype), v_pages=vp.to(device, q_dtype),
                    k_scales=None, v_scales=None)
    return case


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {name} | nvidia-smi: {limit}")
    print(json.dumps({"host_memory": meminfo()}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (matmul and cudnn)")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernels built: {lib} in {build_s:.1f} s")
    log = (lib.parent / "build.log").read_text()
    for line in log.splitlines():
        if "spill" in line and "0 bytes spill stores" not in line:
            print("ptxas:", line.strip())
    ptxas = ptxas_report(log)
    print(json.dumps({"ptxas": ptxas}))
    # the template server's host pools: one buffer, written and then
    # registered in place, the weights views into it at HOST_ALIGN offsets.
    # The buffer is written before it is page-locked, as pack_host_pool
    # fills a pool (pages never touched before they are registered copy
    # slower: tools/torch_host_pool_h2d.py).  Both sources are copied in
    # turn in every round, so a change of the host's rate between them
    # falls on both.
    from repro_torch.core.merging import HOST_ALIGN, HostBuffer
    alloc = torch.empty(256 << 20, dtype=torch.uint8).pin_memory()
    hb = HostBuffer((256 << 20) + HOST_ALIGN)
    hb.buf.fill_(1)
    hb.pin()
    view = hb.view(HOST_ALIGN, (256 << 20,), torch.uint8)
    pool_view_pinned = view.is_pinned()
    h2d, h2d_pool = measure_h2d((alloc, view))
    hb.release()
    del hb, view, alloc
    print(f"pinned host->device copy: {h2d / 1e9:.2f} GB/s (pinned allocator), "
          f"{h2d_pool / 1e9:.2f} GB/s (a view into a registered host-pool "
          f"buffer, is_pinned {pool_view_pinned})")
    if not pool_view_pinned or h2d_pool < 0.8 * h2d:
        raise AssertionError(f"host-pool views: pinned {pool_view_pinned}, "
                             f"{h2d_pool / 1e9:.2f} GB/s against {h2d / 1e9:.2f}")
    return {"name": name, "nvidia_smi": limit, "build_s": build_s,
            "h2d_bytes_per_s": h2d, "h2d_host_pool_bytes_per_s": h2d_pool,
            "torch": torch.__version__,
            "cuda": torch.version.cuda, "ptxas": ptxas}


def demangle(names: list) -> list:
    """C++ names demangled by ``c++filt`` (or the CUDA toolkit's
    ``cu++filt``); the mangled names where neither is there."""
    for tool in ("c++filt", "/usr/local/cuda/bin/cu++filt"):
        try:
            res = subprocess.run([tool], input="\n".join(names), text=True,
                                 capture_output=True, timeout=60)
        except FileNotFoundError:
            continue
        out = res.stdout.splitlines()
        if res.returncode == 0 and len(out) == len(names):
            return out
    return list(names)


def ptxas_report(log: str, kernels=("flash_tc_kernel", "flash_fp32_kernel",
                                    "decode_split_kernel", "decode_merge_kernel",
                                    "rmsnorm_vec_kernel", "rmsnorm_scalar_kernel",
                                    "chunk_state_kernel", "state_pass_kernel",
                                    "chunk_out_kernel", "flash_bwd_dkdv_kernel",
                                    "flash_bwd_dq_kernel",
                                    "rmsnorm_bwd_dx_kernel")) -> list:
    """Registers, static shared memory and spills of the attention, rmsnorm
    and ssd_scan kernels' instantiations (and the backward kernels'), by
    source file, from ``nvcc -Xptxas -v`` in the build log."""
    entries, cur, source = [], None, None
    for line in log.splitlines():
        m = re.match(r"== (\S+) \(exit", line)
        if m:
            source, cur = m.group(1), None
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"mangled": m.group(1), "source": source}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            cur["registers"] = int(m.group(1))
            cur["static_smem"] = int(sm.group(1)) if sm else 0
            cur = None
    rows = []
    for e, name in zip(entries, demangle([e.pop("mangled") for e in entries])):
        k = next((k for k in kernels if k in name), None)
        if k is None:
            continue
        short = name[name.index(k):]
        depth = 0
        for i, ch in enumerate(short):            # cut after the template args
            depth += {"<": 1, ">": -1}.get(ch, 0)
            if ch == ">" and depth == 0:
                short = short[:i + 1]
                break
        for long, abbr in (("(anonymous namespace)::", ""), ("__nv_bfloat16", "bf16"),
                           ("signed char", "int8"), ("float", "f32"), (" ", "")):
            short = short.replace(long, abbr)
        rows.append({"kernel": short, **e})
    return rows


def measure_h2d(srcs: tuple, reps: int = 10) -> list:
    """Pinned host -> device copy rate (bytes/s) from each of ``srcs``
    (uint8 host tensors), one copy of each in turn per round on a side
    stream, as the weight streamer issues them; best of ``reps`` rounds."""
    dst = torch.empty(max(s.numel() for s in srcs), dtype=torch.uint8,
                      device="cuda")
    stream = torch.cuda.Stream()
    best = [float("inf")] * len(srcs)
    for _ in range(reps):
        for i, src in enumerate(srcs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                start.record()
                dst[:src.numel()].copy_(src, non_blocking=True)
                end.record()
            end.synchronize()
            best[i] = min(best[i], start.elapsed_time(end) / 1e3)
    return [src.numel() / t for src, t in zip(srcs, best)]


def phase_kernels(device) -> list:
    """Every kernel against its plain version on the card, timed."""
    gen = torch.Generator().manual_seed(0)
    results = []
    rng = np.random.default_rng(0)

    paged = []
    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b")):
        for B in (1, 8):
            lengths = [512] if B == 1 else (
                [1] + rng.integers(2, 513, B - 2).tolist() + [512])
            for q_dtype, int8 in ((torch.bfloat16, False), (torch.float32, False),
                                  (torch.bfloat16, True), (torch.float32, True)):
                if tag == "llama3-8b" and q_dtype == torch.float32:
                    continue
                paged.append(("serving", tag, heads, 512, lengths, q_dtype, int8))
    # split-KV's own shapes, as for dense decode: one long sequence, and
    # lengths shorter than one split with a sequence of length 0
    for q_dtype, int8 in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True)):
        paged.append(("long", "smollm", SMOLLM, 4096, [4096], q_dtype, int8))
        paged.append(("short", "smollm", SMOLLM, 512, [0, 1, 5, 63, 64, 65, 300, 512],
                      q_dtype, int8))
    for int8 in (False, True):
        paged.append(("long", "llama3-8b", LLAMA3_8B, 4096, [4096], torch.bfloat16,
                      int8))
    # one rank's heads at tp = 2, as phase 15 decodes them
    lengths = [1] + rng.integers(2, 513, 6).tolist() + [512]
    for int8 in (False, True):
        paged.append(("serving", "llama3-8b/tp2", LLAMA3_8B_TP2, 512, lengths,
                      torch.bfloat16, int8))
        paged.append(("serving", "gemma-2b/tp2", GEMMA_2B_TP2, 512, lengths,
                      torch.bfloat16, int8))
    for case in paged:
        results.append(paged_case(device, gen, *case))

    decode_cases = []
    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b"),
                       (GEMMA_2B, "gemma-2b")):
        for dtype in (torch.bfloat16, torch.float32):
            lengths = [1] + rng.integers(2, 513, 6).tolist() + [512]
            decode_cases.append(("serving", tag, heads, 512, lengths, dtype))
    # split-KV's own shapes: one long sequence (3 and 8 blocks before the
    # split), and lengths shorter than one split with a sequence of length 0
    decode_cases += [("long", "smollm", SMOLLM, 4096, [4096], torch.bfloat16),
                     ("long", "smollm", SMOLLM, 4096, [4096], torch.float32),
                     ("long", "llama3-8b", LLAMA3_8B, 4096, [4096], torch.bfloat16),
                     ("serving", "gemma-2b/tp2", GEMMA_2B_TP2, 512,
                      [1] + rng.integers(2, 513, 6).tolist() + [512],
                      torch.bfloat16)]
    for dtype in (torch.bfloat16, torch.float32):
        decode_cases.append(("short", "smollm", SMOLLM, 512,
                             [0, 1, 5, 63, 64, 65, 300, 512], dtype))
    for case, tag, heads, T, lengths, dtype in decode_cases:
        results.append(decode_case(device, gen, case, tag, heads, T, lengths, dtype))

    flash_cases = []
    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b")):
        flash_cases += [(tag, heads, 1, 384, 384, torch.bfloat16, 0.0),
                        (tag, heads, 1, 64, 320, torch.bfloat16, 0.0),
                        (tag, heads, 1, 96, 96, torch.float32, 0.0)]
    flash_cases += [("llama3-8b/tp2", LLAMA3_8B_TP2, 1, 96, 96, torch.bfloat16, 0.0),
                    ("llama3-8b/tp2", LLAMA3_8B_TP2, 1, 24, 88, torch.bfloat16, 0.0),
                    ("smollm", SMOLLM, 1, 384, 384, torch.float32, 0.0),
                    ("smollm", SMOLLM, 2, 256, 256, torch.bfloat16, 30.0),
                    ("smollm", SMOLLM, 1, 200, 333, torch.float32, 30.0)]
    for tag, hd, B, S, T, dtype, softcap in flash_cases:
        results.append(flash_case(device, gen, tag, hd, B, S, T, dtype, softcap))

    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b"),
                       (GEMMA_2B, "gemma-2b")):
        results.append(attention_invariance(device, gen, heads, tag))

    # rmsnorm: fp32 within 1e-5 relative, bf16 within one bf16 ulp of the
    # plain version (the same fp32 value rounded; summation order only);
    # the fused form's s equals x + r and its y the unfused kernel on s,
    # bit for bit
    for tag, shape in RMSNORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            results += rmsnorm_case(device, gen, tag, shape, dtype)
    for tag, shape, stride in STRIDED_RMSNORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            results += rmsnorm_case(device, gen, tag, shape, dtype, stride)
    # the split-row form at one rank's slices: decode rows in both dtypes,
    # a prefill's rows in bf16
    for tag, d, d_global in SPLIT_RMSNORM_CASES:
        for rows, dtype in (((8, 1), torch.bfloat16), ((8, 1), torch.float32),
                            ((96,), torch.bfloat16)):
            results.append(rmsnorm_split_case(device, gen, tag, rows + (d,),
                                              d_global, dtype))
    return (results + big_head_cases(device) + decode_split_cases(device)
            + rank_head_cases(device))


def rank_head_cases(device) -> list:
    """The attention kernels at the heads of ranks that split unevenly
    (``SMOLLM_TP2``, ``QWEN3_14B_16``, ``WHISPER_TP2``): dense decode at
    B = 8 over lengths to 512 (whisper's self cache: to 448), paged decode
    and flash at S = T = 96 at smollm's ranks, in bf16."""
    gen = torch.Generator().manual_seed(31)
    rng = np.random.default_rng(31)
    results = []
    lengths = [1] + rng.integers(2, 513, 6).tolist() + [512]
    for i, heads in enumerate(SMOLLM_TP2):
        tag = f"smollm/tp2-rank{i}"
        results.append(decode_case(device, gen, "serving", tag, heads, 512,
                                   lengths, torch.bfloat16))
        results.append(paged_case(device, gen, "serving", tag, heads, 512,
                                  lengths, torch.bfloat16, False))
        results.append(flash_case(device, gen, tag, heads, 1, 96, 96,
                                  torch.bfloat16, 0.0))
    for i, heads in enumerate(QWEN3_14B_16):
        results.append(decode_case(device, gen, "serving",
                                   f"qwen3-14b/16-rank{i}", heads, 512, lengths,
                                   torch.bfloat16))
    results.append(decode_case(device, gen, "serving", "whisper-medium/tp2",
                               WHISPER_TP2, 448,
                               [min(n, 448) for n in lengths], torch.bfloat16))
    return results


def big_head_cases(device) -> list:
    """The attention kernels at llama2-13b's heads (40 / 40 / 128, G = 1)
    and chameleon-34b's (64 / 8 / 128): paged decode (bf16 and the int8
    arena) and dense decode at B = 8 over lengths to 512 and at B = 1,
    T = 4096, flash at S = T = 384, and the invariance checks; rmsnorm at
    their rows and chameleon's qk-norm rows is in ``RMSNORM_CASES``."""
    gen = torch.Generator().manual_seed(18)
    rng = np.random.default_rng(18)
    results = []
    for heads, tag in ((LLAMA2_13B, "llama2-13b"), (CHAMELEON_34B, "chameleon-34b")):
        lengths = [1] + rng.integers(2, 513, 6).tolist() + [512]
        for int8 in (False, True):
            for case, T, ln in (("serving", 512, lengths), ("long", 4096, [4096])):
                results.append(paged_case(device, gen, case, tag, heads, T, ln,
                                          torch.bfloat16, int8))
        for case, T, ln in (("serving", 512, lengths), ("long", 4096, [4096])):
            results.append(decode_case(device, gen, case, tag, heads, T, ln,
                                       torch.bfloat16))
        results.append(flash_case(device, gen, tag, heads, 1, 384, 384,
                                  torch.bfloat16, 0.0))
        results.append(attention_invariance(device, gen, heads, tag))
    return results


def flash_case(device, gen, tag, hd, B, S, T, dtype, softcap,
               causal: bool = True) -> dict:
    """``flash_attention`` against its plain version, timed beside SDPA
    (none with a softcap) and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn((B, hd["H"], S, hd["d"]), generator=gen).to(device, dtype)
    k = torch.randn((B, hd["KV"], T, hd["d"]), generator=gen).to(device, dtype)
    v = torch.randn((B, hd["KV"], T, hd["d"]), generator=gen).to(device, dtype)
    kw = {"causal": causal, "softcap": softcap}
    out = flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    kern_ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw))
    lib_ms = None
    if softcap == 0.0:           # SDPA has no softcap: no library call
        mask = (torch.arange(T, device=device)[None, :]
                <= torch.arange(S, device=device)[:, None] + (T - S))
        lib_kw = ({} if not causal else {"is_causal": True} if S == T
                  else {"attn_mask": mask})
        lib_ms = time_ms(lambda: sdpa_gqa(q, k, v, **lib_kw))
    flops, nbytes = flash_work(B, hd["H"], hd["KV"], S, T, hd["d"], dtype,
                               causal)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    res = {"kernel": "flash_attention", "shape": tag, "B": B, "H": hd["H"],
           "KV": hd["KV"], "d": hd["d"], "S": S, "T": T, "causal": causal,
           "dtype": str(dtype)[6:], "softcap": softcap, "max_abs_err": err,
           "tol": tol, "ms": kern_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not err <= tol:
        raise AssertionError(f"flash_attention disagrees: {res}")
    return res


def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a view one element into rows one element wider: the same
    values, rows no longer 16-byte aligned (the kernels' element-load
    paths)."""
    wide = torch.empty(t.shape[:-1] + (t.shape[-1] + 1,), dtype=t.dtype,
                       device=t.device)[..., 1:]
    wide.copy_(t)
    return wide


def strided_rows(t: torch.Tensor, stride: int) -> torch.Tensor:
    """``t`` as the first ``t.shape[-1]`` elements of rows ``stride`` wide
    (as MLA's ``kv[..., :kvr]``): the same values, another row stride."""
    wide = torch.zeros(t.shape[:-1] + (stride,), dtype=t.dtype, device=t.device)
    wide[..., :t.shape[-1]] = t
    return wide[..., :t.shape[-1]]


def rmsnorm_case(device, gen, tag, shape, dtype, stride=None) -> list:
    """One rmsnorm case of phase 2: the kernel against its plain version,
    timed beside ``F.rms_norm``; then the residual form against its plain
    version, the add and the unfused kernel, timed beside ``x + r;
    F.rms_norm`` and ``x + r`` then the kernel.  Both forms must give the
    same bits on unaligned rows (the element-load kernel).  With
    ``stride``, x and r are rows of ``shape[-1]`` inside rows ``stride``
    wide, read in place; the case records whether the kernel takes its
    16-byte load path for them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm, vector_path

    def within_tol(out, want) -> tuple:
        diff = (out.float() - want.float()).abs()
        if dtype == torch.float32:
            return float(diff.max()), bool((diff <= 1e-5 * want.float().abs()).all())
        return float(diff.max()), bool((diff <= bf16_ulp(want)).all())

    tol = "1e-5 relative" if dtype == torch.float32 else "1 bf16 ulp"
    x = torch.randn(shape, generator=gen).to(device, dtype)
    scale = (torch.randn(shape[-1], generator=gen) * 0.1 + 1).to(device, dtype)
    if stride:
        x = strided_rows(x, stride)
    out = rmsnorm(x, scale, 1e-5)
    same_bits = torch.equal(rmsnorm(x, scale, 1e-5), out)
    err, ok = within_tol(out, ref.rmsnorm_ref(x, scale, 1e-5))
    flops, nbytes = rmsnorm_work(shape, dtype)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    plain = {"kernel": "rmsnorm", "shape": tag, "dims": list(shape),
             "row_stride": stride or shape[-1],
             "vector_path": vector_path(x, scale),
             "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
             "deterministic": same_bits,
             "unaligned_equal": torch.equal(rmsnorm(unaligned_copy(x), scale, 1e-5),
                                            out),
             "ms": time_ms(lambda: rmsnorm(x, scale, 1e-5)),
             "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, scale, 1e-5)),
             "library_ms": time_ms(lambda: F.rms_norm(x, (shape[-1],), scale, 1e-5)),
             "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(plain))
    if not (ok and same_bits and plain["unaligned_equal"] and plain["vector_path"]):
        raise AssertionError(f"rmsnorm disagrees: {plain}")

    r = torch.randn(shape, generator=gen).to(device, dtype)
    if stride:
        r = strided_rows(r, stride)
    y, s = rmsnorm(x, scale, 1e-5, residual=r)
    y2, s2 = rmsnorm(x, scale, 1e-5, residual=r)
    want_y, want_s = ref.rmsnorm_ref(x, scale, 1e-5, residual=r)
    err, ok = within_tol(y, want_y)
    y_u, s_u = rmsnorm(unaligned_copy(x), scale, 1e-5, residual=unaligned_copy(r))
    flops, nbytes = rmsnorm_work(shape, dtype, residual=True)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    fused = {"kernel": "rmsnorm[residual]", "shape": tag, "dims": list(shape),
             "row_stride": stride or shape[-1],
             "vector_path": vector_path(x, scale, r),
             "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
             "s_equals_add": torch.equal(s, x + r) and torch.equal(s, want_s),
             "y_equals_kernel_on_add": torch.equal(y, rmsnorm(x + r, scale, 1e-5)),
             "deterministic": torch.equal(y, y2) and torch.equal(s, s2),
             "unaligned_equal": torch.equal(y_u, y) and torch.equal(s_u, s),
             "ms": time_ms(lambda: rmsnorm(x, scale, 1e-5, residual=r)),
             "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, scale, 1e-5, residual=r)),
             "add_then_library_ms": time_ms(
                 lambda: F.rms_norm(x + r, (shape[-1],), scale, 1e-5)),
             "add_then_kernel_ms": time_ms(lambda: rmsnorm(x + r, scale, 1e-5)),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(fused))
    if not (ok and fused["s_equals_add"] and fused["y_equals_kernel_on_add"]
            and fused["deterministic"] and fused["unaligned_equal"]
            and fused["vector_path"]):
        raise AssertionError(f"fused rmsnorm differs from its plain version, the "
                             f"add or the unfused kernel: {fused}")
    return [plain, fused]


def rmsnorm_split_case(device, gen, tag, shape, d_global, dtype) -> dict:
    """The split-row rmsnorm at one rank's slice ``shape`` of rows of
    ``d_global``: the sums launch against its plain version (fp32, 1e-5
    relative), the scaling launch against its plain version from the same
    sums (within one bf16 ulp, or 1e-5 relative in fp32), both bit for
    bit on a repeat; the slice put beside the other ranks' (their sums
    added as the ``all_reduce`` would) against the whole row's one-launch
    norm, and the slice normalised alone against it (it must differ).
    Timed: the two launches (the collective between them runs on the
    host), their plain versions, and ``F.rms_norm`` over the gathered
    whole row for scale (no library call computes the split form)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_apply,
                                             rmsnorm_sumsq)

    def within_tol(out, want) -> tuple:
        diff = (out.float() - want.float()).abs()
        if out.dtype == torch.float32:
            return float(diff.max()), bool((diff <= 1e-5 * want.float().abs()
                                            ).all())
        return float(diff.max()), bool((diff <= bf16_ulp(want)).all())

    d = shape[-1]
    x = torch.randn(shape, generator=gen).to(device, dtype)
    # the other ranks' slices at twice the scale: a slice's own mean of
    # squares is then a quarter of theirs, as rows of unequal halves have
    rest = (2 * torch.randn(shape[:-1] + (d_global - d,), generator=gen)).to(
        device, dtype)
    scale = (torch.randn(d_global, generator=gen) * 0.1 + 1).to(device, dtype)
    sums = rmsnorm_sumsq(x)
    sums_err, sums_ok = within_tol(sums, ref.rmsnorm_sumsq_ref(x))
    total = sums + rmsnorm_sumsq(rest)
    y = rmsnorm_apply(x, total, scale[:d], d_global, 1e-5)
    err, ok = within_tol(y, ref.rmsnorm_apply_ref(x, total, scale[:d],
                                                  d_global, 1e-5))
    same = (torch.equal(rmsnorm_sumsq(x), sums) and torch.equal(
        rmsnorm_apply(x, total, scale[:d], d_global, 1e-5), y))
    whole = rmsnorm(torch.cat([x, rest], -1), scale, 1e-5)[..., :d].float()
    # one more ulp than the plain comparison: the whole row sums its
    # squares in another order
    whole_tol = (1e-5 * whole.abs() if dtype == torch.float32
                 else 2 * bf16_ulp(whole))
    diff = (y.float() - whole).abs()
    alone = (rmsnorm(x, scale[:d], 1e-5).float() - whole).abs()
    whole_ok = bool((diff <= whole_tol).all())
    alone_apart = bool((alone > whole_tol).any())
    whole_err, alone_err = float(diff.max()), float(alone.max())
    n = int(np.prod(shape))
    elt = torch.empty((), dtype=dtype).element_size()
    rows = n // d
    # x read once, y written once, the scale slice read once, and each
    # row's sum written, read back after the reduce and read again
    b_ms, b_by = bound_ms(4 * n, elt * (2 * n + d) + 12 * rows, dtype)
    full = torch.cat([x, rest], -1)
    res = {"kernel": "rmsnorm_split", "shape": tag, "dims": list(shape),
           "d_global": d_global, "dtype": str(dtype)[6:],
           "max_abs_err": max(err, sums_err), "sums_max_abs_err": sums_err,
           "tol": "1e-5 relative" if dtype == torch.float32 else "1 bf16 ulp",
           "deterministic": same, "whole_row_max_abs_err": whole_err,
           "whole_row_tol": ("1e-5 relative" if dtype == torch.float32
                             else "2 bf16 ulp"),
           "slice_alone_max_abs_err": alone_err,
           "ms": time_ms(lambda: rmsnorm_apply(x, rmsnorm_sumsq(x), scale[:d],
                                               d_global, 1e-5)),
           "plain_ms": time_ms(lambda: ref.rmsnorm_apply_ref(
               x, ref.rmsnorm_sumsq_ref(x), scale[:d], d_global, 1e-5)),
           "library_ms": None,
           "whole_row_library_ms": time_ms(
               lambda: F.rms_norm(full, (d_global,), scale, 1e-5)),
           "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not (ok and sums_ok and same and whole_ok and alone_apart):
        raise AssertionError(f"split-row rmsnorm disagrees: {res}")
    return res


def paged_case(device, gen, case, tag, hd, max_len, lengths, q_dtype,
               int8) -> dict:
    """``paged_decode_attention`` against its plain version over a shuffled
    arena of 8-row pages, timed beside gather + SDPA (the arena
    dequantized first for int8) and the bound.  A sequence of length 0
    must give exact zeros, the others agree within the tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    B = len(lengths)
    c = make_paged_case(gen, B, hd["H"], hd["KV"], hd["d"], PAGE_SIZE, max_len,
                        lengths, q_dtype, int8, device)
    args = (c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["lengths"])
    kw = {"k_scales": c["k_scales"], "v_scales": c["v_scales"]}
    out = paged_decode_attention(*args, **kw)
    want = ref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    live = c["lengths"] > 0
    err = float((out.float() - want.float())[live].abs().max())
    empty_zero = bool((out[~live] == 0).all())
    tol = 2e-5 if q_dtype == torch.float32 else 2e-2
    kern_ms = time_ms(lambda: paged_decode_attention(*args, **kw))
    plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(*args, **kw))
    T = c["page_table"].shape[1] * PAGE_SIZE
    mask = (torch.arange(T, device=device)[None, :]
            < c["lengths"][:, None].long())[:, None, None, :]

    def library():
        kp, vp = c["k_pages"], c["v_pages"]
        if int8:
            kp = kp.to(q_dtype) * c["k_scales"].to(q_dtype)[..., None]
            vp = vp.to(q_dtype) * c["v_scales"].to(q_dtype)[..., None]
        pt = c["page_table"].long()
        k = kp[pt].reshape(B, T, hd["KV"], hd["d"]).transpose(1, 2)
        v = vp[pt].reshape(B, T, hd["KV"], hd["d"]).transpose(1, 2)
        return sdpa_gqa(c["q"][:, :, None], k, v, attn_mask=mask)

    lib_ms = time_ms(library)
    kv_dtype = torch.int8 if int8 else q_dtype
    flops, nbytes = paged_decode_work(B, hd["H"], hd["KV"], hd["d"], PAGE_SIZE,
                                      lengths, q_dtype, kv_dtype)
    b_ms, b_by = bound_ms(flops, nbytes, q_dtype)
    res = {"kernel": "paged_decode_attention", "case": case, "shape": tag, "B": B,
           "H": hd["H"], "KV": hd["KV"], "d": hd["d"], "ps": PAGE_SIZE,
           "max_len": int(max(lengths)),
           "lengths": list(lengths) if case == "short" else None,
           "q_dtype": str(q_dtype)[6:], "kv_dtype": str(kv_dtype)[6:],
           "max_abs_err": err, "tol": tol,
           "length0_zero": empty_zero if not live.all() else None,
           "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not (err <= tol and empty_zero):
        raise AssertionError(f"paged_decode_attention disagrees: {res}")
    return res


def decode_case(device, gen, case, tag, heads, T, lengths, dtype) -> dict:
    """``decode_attention`` against its plain version over a [B, T, KV, d]
    cache view, timed beside SDPA and the bound.  A sequence of length 0
    must give exact zeros (as the Pallas kernel does; the plain version's
    softmax over no rows is uniform instead), the others agree within the
    tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    B, H, KV, d = len(lengths), heads["H"], heads["KV"], heads["d"]
    q = torch.randn((B, H, d), generator=gen).to(device, dtype)
    ck = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
    cv = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)   # the cache view
    out = decode_attention(q, k, v, ln)
    want = ref.decode_attention_ref(q, k, v, ln)
    torch.cuda.synchronize()
    live = ln > 0
    err = float((out.float() - want.float())[live].abs().max())
    empty_zero = bool((out[~live] == 0).all())
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    kern_ms = time_ms(lambda: decode_attention(q, k, v, ln))
    plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, v, ln))
    mask = (torch.arange(T, device=device)[None, :]
            < ln[:, None].long())[:, None, None, :]
    lib_ms = time_ms(lambda: sdpa_gqa(q[:, :, None], k, v, attn_mask=mask))
    flops, nbytes = decode_work(B, H, KV, d, lengths, dtype)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    res = {"kernel": "decode_attention", "case": case, "shape": tag, "B": B,
           "H": H, "KV": KV, "d": d, "T": T, "max_len": int(max(lengths)),
           "lengths": list(lengths) if case == "short" else None,
           "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
           "length0_zero": empty_zero if not live.all() else None,
           "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not (err <= tol and empty_zero):
        raise AssertionError(f"decode_attention disagrees: {res}")
    return res


def _slice_rows(k, v, ln, r: int, Tr: int) -> tuple:
    """Rank ``r``'s rows of a [B, KV, T, d] cache view and its lengths."""
    return (k[:, :, r * Tr:(r + 1) * Tr], v[:, :, r * Tr:(r + 1) * Tr],
            (ln - r * Tr).clamp(0, Tr).to(torch.int32))


def decode_split_case(device, gen, tag, heads, T, lengths, R, dtype) -> dict:
    """The rank split of dense decode (a cache split by sequence over R
    ranks): ``decode_attention_slice`` on each rank's rows against its
    plain version (o and lse; a rank whose slice holds none of a
    sequence's rows must give exact zeros and -inf), then
    ``decode_merge_ranks`` over the ranks' results against its plain
    version and against the unsplit ``decode_attention`` kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_slice, decode_merge_ranks)
    B, H, KV, d = len(lengths), heads["H"], heads["KV"], heads["d"]
    q = torch.randn((B, H, d), generator=gen).to(device, dtype)
    ck = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
    cv = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    Tr = T // R
    outs, lses, err, empty_ok = [], [], 0.0, True
    for r in range(R):
        ks, vs, lr = _slice_rows(k, v, ln, r, Tr)
        o, lse = decode_attention_slice(q, ks, vs, lr)
        wo, wl = ref.decode_attention_slice_ref(q, ks, vs, lr)
        live = lr > 0
        if live.any():
            err = max(err, float((o - wo)[live].abs().max()),
                      float((lse - wl)[live].abs().max()))
        empty_ok &= bool((o[~live] == 0).all()) and bool(
            torch.isneginf(lse[~live]).all())
        outs.append(o)
        lses.append(lse)
    O, L = torch.stack(outs), torch.stack(lses)
    merged = decode_merge_ranks(O, L, dtype)
    want = ref.decode_merge_ranks_ref(O, L, dtype)
    whole = decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    live = ln > 0
    merge_err = float((merged.float() - want.float())[live].abs().max())
    unsplit_err = float((merged.float() - whole.float())[live].abs().max())
    zeros = bool((merged[~live] == 0).all())
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    res = {"kernel": "decode_attention_slice", "case": "ranks", "shape": tag,
           "B": B, "H": H, "KV": KV, "d": d, "T": T, "R": R,
           "lengths": list(lengths), "dtype": str(dtype)[6:],
           "max_abs_err": err, "merge_err": merge_err,
           "unsplit_err": unsplit_err, "empty_slices_ok": empty_ok,
           "length0_zero": zeros, "tol": tol}
    print(json.dumps(res))
    if not (max(err, merge_err, unsplit_err) <= tol and empty_ok and zeros):
        raise AssertionError(f"the rank split of decode disagrees: {res}")
    return res


def decode_split_timing(device, gen, heads, tag, B, Tr, R, dtype) -> list:
    """``decode_attention_slice`` over one rank's ``Tr`` full rows and
    ``decode_merge_ranks`` over ``R`` ranks' results, at the shapes phase
    18's rank decodes, each against its plain version and timed beside
    the bound (the slice also beside SDPA over the same rows, which
    gives no log-sum-exp; the merge has no library call)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention_slice,
                                                      decode_merge_ranks)
    H, KV, d = heads["H"], heads["KV"], heads["d"]
    elt = torch.empty((), dtype=dtype).element_size()
    q = torch.randn((B, H, d), generator=gen).to(device, dtype)
    k = torch.randn((B, Tr, KV, d), generator=gen).to(device, dtype).transpose(1, 2)
    v = torch.randn((B, Tr, KV, d), generator=gen).to(device, dtype).transpose(1, 2)
    ln = torch.full((B,), Tr, dtype=torch.int32, device=device)
    o, lse = decode_attention_slice(q, k, v, ln)
    wo, wl = ref.decode_attention_slice_ref(q, k, v, ln)
    torch.cuda.synchronize()
    err = max(float((o - wo).abs().max()), float((lse - wl).abs().max()))
    rows = B * Tr
    flops = 4 * rows * H * d
    nbytes = 2 * rows * KV * d * elt + B * H * d * (elt + 4) + B * H * 4 + 4 * B
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    sl = {"kernel": "decode_attention_slice", "case": "rank", "shape": tag,
          "B": B, "H": H, "KV": KV, "d": d, "T": Tr, "dtype": str(dtype)[6:],
          "max_abs_err": err,
          "ms": time_ms(lambda: decode_attention_slice(q, k, v, ln)),
          "plain_ms": time_ms(lambda: ref.decode_attention_slice_ref(q, k, v, ln)),
          "library_ms": time_ms(lambda: sdpa_gqa(q[:, :, None], k, v)),
          "bound_ms": b_ms, "bound_by": b_by}
    O = torch.randn((R, B, H, d), generator=gen).to(device)
    L = torch.randn((R, B, H), generator=gen).to(device) * 4
    L[R // 2] = -math.inf                      # a rank with no rows
    m = decode_merge_ranks(O, L, dtype)
    want = ref.decode_merge_ranks_ref(O, L, dtype)
    torch.cuda.synchronize()
    b_ms, b_by = bound_ms(2 * R * B * H * d,
                          R * B * H * (d + 1) * 4 + B * H * d * elt, dtype)
    mg = {"kernel": "decode_merge_ranks", "case": "rank", "shape": tag,
          "R": R, "B": B, "H": H, "d": d, "dtype": str(dtype)[6:],
          "max_abs_err": float((m.float() - want.float()).abs().max()),
          "ms": time_ms(lambda: decode_merge_ranks(O, L, dtype)),
          "plain_ms": time_ms(lambda: ref.decode_merge_ranks_ref(O, L, dtype)),
          "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for row in (sl, mg):
        print(json.dumps(row))
        if not row["max_abs_err"] <= tol:
            raise AssertionError(f"{row['kernel']} disagrees: {row}")
    return [sl, mg]


def decode_split_cases(device) -> list:
    """The rank split's checks at llama3-8b's and chameleon-34b's heads
    (1, 2 and 4 slices of 512 rows, lengths that leave slices empty, fp32
    and bf16), and the timed rows at phase 18's shapes (chameleon-34b's
    decode_32k rank: 8 sequences over 2,048 rows, 16 ranks)."""
    gen = torch.Generator().manual_seed(18)
    lengths = [0, 1, 100, 129, 256, 300, 511, 512]
    rows = [decode_split_case(device, gen, tag, heads, 512, lengths, R, dtype)
            for tag, heads in (("llama3-8b", LLAMA3_8B),
                               ("chameleon-34b", CHAMELEON_34B))
            for dtype in (torch.float32, torch.bfloat16) for R in (1, 2, 4)]
    return rows + decode_split_timing(device, gen, CHAMELEON_34B,
                                      "chameleon-34b/decode_32k@16x16", 8,
                                      2048, 16, torch.bfloat16)


def attention_invariance(device, gen, heads: dict, tag: str) -> dict:
    """Bitwise checks of the attention kernels that serving relies on (a
    fork's full prefill against a warm suffix prefill over the baked
    prefix; a sequence decoded alone or in a batch; the paged and the
    dense pool giving the same tokens): in bf16 a suffix prefill's rows
    equal the last rows of the whole prefill over the same K/V, a sequence
    alone equals it inside a batch of other prompts or lengths, and a
    repeated call equals the first; in bf16 and fp32 paged decode over a
    shuffled arena of 8-row pages equals dense decode over a cache built
    from the pages the table selects, at ragged lengths from 0 to 512."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    H, KV, d, bf = heads["H"], heads["KV"], heads["d"], torch.bfloat16
    T, S = 320, 64
    q = torch.randn((4, H, T, d), generator=gen).to(device, bf)
    k = torch.randn((4, KV, T, d), generator=gen).to(device, bf)
    v = torch.randn((4, KV, T, d), generator=gen).to(device, bf)
    full = flash_attention(q, k, v)
    res = {"flash_suffix_equals_prefill": torch.equal(
               flash_attention(q[:, :, T - S:], k, v), full[:, :, T - S:]),
           "flash_alone_equals_batch": torch.equal(
               flash_attention(q[2:3], k[2:3], v[2:3]), full[2:3]),
           "flash_repeat_equal": torch.equal(flash_attention(q, k, v), full)}
    T = 512
    lengths = [300, 1, 64, 0, 129, 512, 17, 250]
    q = torch.randn((8, H, d), generator=gen).to(device, bf)
    ck = torch.randn((8, T, KV, d), generator=gen).to(device, bf)
    cv = torch.randn((8, T, KV, d), generator=gen).to(device, bf)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    kc, vc = ck.transpose(1, 2), cv.transpose(1, 2)
    out = decode_attention(q, kc, vc, ln)
    res["decode_alone_equals_batch"] = all(
        torch.equal(decode_attention(q[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                     ln[b:b + 1]), out[b:b + 1]) for b in (0, 4, 6))
    res["decode_repeat_equal"] = torch.equal(decode_attention(q, kc, vc, ln), out)
    lengths = [0, 1, 5, 63, 64, 65, 300, 512]
    for dtype in (bf, torch.float32):
        c = make_paged_case(gen, 8, H, KV, d, PAGE_SIZE, T, lengths, dtype, False,
                            device)
        args = (c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["lengths"])
        pt = c["page_table"].long()
        kd = c["k_pages"][pt].reshape(8, T, KV, d).transpose(1, 2)
        vd = c["v_pages"][pt].reshape(8, T, KV, d).transpose(1, 2)
        out = paged_decode_attention(*args)
        name = str(dtype)[6:]
        res[f"paged_equals_dense_{name}"] = torch.equal(
            out, decode_attention(c["q"], kd, vd, c["lengths"]))
        if dtype == bf:
            qb, kp, vp, ptb, lb = args
            res["paged_alone_equals_batch"] = all(
                torch.equal(paged_decode_attention(qb[b:b + 1], kp, vp, ptb[b:b + 1],
                                                   lb[b:b + 1]), out[b:b + 1])
                for b in (2, 4, 6, 7))
            res["paged_repeat_equal"] = torch.equal(paged_decode_attention(*args), out)
    row = {"invariance": tag, **res}
    print(json.dumps(row))
    if not all(res.values()):
        raise AssertionError(f"attention invariance broken: {row}")
    return row


def attention_launches(cfg) -> int:
    """Attention blocks of one model call: one per layer, or for zamba one
    per application of the shared block, none for xlstm.  Each GQA block
    launches one attention kernel; an MLA block none (see
    ``attention_kernels``)."""
    if cfg.family == "zamba":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "xlstm":
        return 0
    return cfg.n_layers


def xlstm_blocks(cfg) -> tuple:
    """xlstm: (mLSTM blocks, sLSTM blocks) of the model: a unit of
    ``slstm_every`` layers holds ``slstm_every - 1`` mLSTM blocks and one
    sLSTM block (42 and 6 for xlstm-1.3b)."""
    units = cfg.n_layers // cfg.slstm_every
    return units * (cfg.slstm_every - 1), units


def attention_kernels(cfg) -> int:
    """Attention kernel launches of one model call: MLA attends in PyTorch
    ops (the reference runs it outside any Pallas kernel), so none."""
    return 0 if cfg.use_mla else attention_launches(cfg)


def norm_launches(cfg) -> int:
    """rmsnorm launches of one model call: two per block, the final norm,
    and two more per block for qk-norm models or MLA models (``q_a_norm``
    and ``kv_a_norm``).  zamba: two per Mamba2 block (the pre-norm and the
    mixer's gated norm), two per application of the shared block, and the
    final norm (127 for zamba2-2.7b).  xlstm: two per mLSTM block (the
    pre-norm and the inner norm), three per sLSTM block (the pre-norm, the
    inner norm and ``mlp_norm``), and the final norm (103 for
    xlstm-1.3b)."""
    if cfg.family == "zamba":
        return 2 * cfg.n_layers + 2 * attention_launches(cfg) + 1
    if cfg.family == "xlstm":
        n_m, n_s = xlstm_blocks(cfg)
        return 2 * n_m + 3 * n_s + 1
    return (4 if cfg.qk_norm or cfg.use_mla else 2) * cfg.n_layers + 1


def fused_norm_launches(cfg) -> int:
    """rmsnorm launches of one model call with the residual add fused in:
    the pre-MLP norm of every attention + MLP block (``_dense_block``), so
    one per attention launch (30 for smollm-135m, 9 for zamba2-2.7b's
    shared block); for xlstm the ``mlp_norm`` of every sLSTM block (6 for
    xlstm-1.3b).  They are counted under ``rmsnorm`` too."""
    if cfg.family == "xlstm":
        return xlstm_blocks(cfg)[1]
    return attention_launches(cfg)


def check_norm_launches(counts: dict, cfg, where: str) -> None:
    """Every model call launches attention_kernels(cfg) attention kernels,
    norm_launches(cfg) rmsnorms and fused_norm_launches(cfg) fused ones, so
    the counts stand in fixed ratios (MLA and xlstm: no attention kernel,
    and the fused launches count the calls; xlstm: no ``ssd_scan``
    either)."""
    attn = (counts["paged_decode_attention"] + counts["flash_attention"]
            + counts["decode_attention"])
    units = attention_kernels(cfg)
    if cfg.use_mla or cfg.family == "xlstm":
        attn, units = counts["rmsnorm_fused"], fused_norm_launches(cfg)
        if counts["paged_decode_attention"] or counts["flash_attention"] or (
                counts["decode_attention"]) or not attn or (
                cfg.family == "xlstm" and counts["ssd_scan"]):
            raise AssertionError(f"{where}: {cfg.name} launched {counts}")
    if (counts["rmsnorm"] * units != norm_launches(cfg) * attn
            or counts["rmsnorm_fused"] * units != fused_norm_launches(cfg) * attn):
        raise AssertionError(f"{where}: rmsnorm launches {counts} are not "
                             f"{norm_launches(cfg)} ({fused_norm_launches(cfg)} "
                             f"fused) per {units} attention launches")


def _serve_requests(vocab: int, prefix: np.ndarray, n: int = 12, seed: int = 0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if i < 3:                    # three requests share the baked prefix
            tail = rng.integers(1, vocab, int(rng.integers(16, 257)))
            reqs.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            reqs.append(rng.integers(1, vocab, int(rng.integers(64, 385))
                                     ).astype(np.int32))
    return reqs


def serving_engine(model, params, prefix: np.ndarray, chunk_tokens=None,
                   kv_dtype=None):
    """The serving setup every pass uses: 8 slots over a fresh paged arena
    (max_len 512, page size 8) with ``prefix`` baked and registered."""
    from repro_torch.runtime import (ContinuousBatchingEngine, PagedKVCachePool,
                                     PrefixIndex)
    pool = PagedKVCachePool(model, n_slots=8, max_len=512, page_size=PAGE_SIZE,
                            kv_dtype=kv_dtype)
    cache = model.make_cache(1, pool.padded_len)
    _, cache = model.prefill(params, {"tokens": prefix[None]}, cache)
    index = PrefixIndex(PAGE_SIZE)
    index.register(pool.bake_prefix(cache, prefix))
    return ContinuousBatchingEngine(model, params, pool=pool, prefix_index=index,
                                    chunk_tokens=chunk_tokens)


def serving_workload(vocab: int):
    """The shared prefix (131 tokens: 16 pages aliased plus a partial page
    copied on write) and the 12 prompts of every serving pass."""
    prefix = np.random.default_rng(1).integers(1, vocab, 131).astype(np.int32)
    return prefix, _serve_requests(vocab, prefix)


def full_model(device, seed: int = 0):
    """smollm-135m at full width and depth with seeded random weights."""
    from repro_torch.models.registry import get_model
    model = get_model("smollm-135m", device=device)
    assert model.cfg.n_layers == SERVE_LAYERS and model.cfg.d_model == 576
    t0 = time.perf_counter()
    params = model.init_params(seed=seed)
    torch.cuda.synchronize()
    print(f"smollm-135m: {model.cfg.n_layers} layers, d_model "
          f"{model.cfg.d_model}, {model.dtype}, weights (seed {seed}) in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, params


SERVE_PASSES = (("paged", {}), ("chunked", {"chunk_tokens": 64}),
                ("int8", {"kv_dtype": "int8"}))


def phase_serve(model, params, passes=SERVE_PASSES) -> tuple:
    """A model at full width through the paged continuous-batching engine
    over the serving workload (smollm-135m: plain, chunked-prefill and
    int8-arena passes), after a warm-up of two requests.  Launch counts
    are exact per pass; each row records how many of its tokens equal the
    first pass's.  Returns the passes' rows and the first pass's
    tokens."""
    from repro_torch.kernels import ops
    vocab, L = model.cfg.vocab_size, attention_kernels(model.cfg)
    prefix, reqs = serving_workload(vocab)
    out = []
    tokens_by_pass = {}
    for warm, (name, kw) in [(True, passes[0])] + [(False, p) for p in passes]:
        eng = serving_engine(model, params, prefix, **kw)
        pool = eng.pool
        batch = reqs[:2] if warm else reqs
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ids = [eng.submit(p, 16) for p in batch]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if warm:
            eng.close()
            continue
        res = [results[i] for i in ids]
        bad = [r for r in res if r.status != "done" or r.n_generated != 16]
        if bad:
            raise AssertionError(f"{name}: unfinished requests {bad}")
        for r in res:
            if not ((r.tokens >= 0) & (r.tokens < vocab)).all():
                raise AssertionError(f"{name}: token out of range {r.tokens}")
        if counts["paged_decode_attention"] != eng.n_decode_steps * L:
            raise AssertionError(f"{name}: paged decode launches {counts} != "
                                 f"{eng.n_decode_steps} steps x {L}")
        if counts["flash_attention"] != eng.n_prefill_calls * L:
            raise AssertionError(f"{name}: flash launches {counts} != "
                                 f"{eng.n_prefill_calls} prefills x {L}")
        calls = eng.n_decode_steps + eng.n_prefill_calls
        if (counts["rmsnorm"] != calls * norm_launches(model.cfg)
                or counts["rmsnorm_fused"] != calls * fused_norm_launches(model.cfg)):
            raise AssertionError(f"{name}: rmsnorm launches {counts} != "
                                 f"{calls} model calls x {norm_launches(model.cfg)} "
                                 f"({fused_norm_launches(model.cfg)} fused)")
        hits = sum(r.reused_prefix_len > 0 for r in res)
        if hits < 2 or pool.stats["shared_pages_mapped"] < 2 * (128 // PAGE_SIZE):
            raise AssertionError(f"{name}: prefix hits {hits}, {pool.stats}")
        ttft = np.asarray([r.ttft_s for r in res]) * 1e3
        e2e = np.asarray([r.e2e_s for r in res]) * 1e3
        n_tok = sum(r.n_generated for r in res)
        tokens_by_pass[name] = [r.tokens for r in res]
        row = {"pass": name, "arch": model.cfg.name, "requests": len(res),
               "prompt_lens": [int(r.prompt_len) for r in res],
               "prefix_hits": int(hits), "pool_stats": dict(pool.stats),
               "decode_steps": eng.n_decode_steps,
               "prefill_calls": eng.n_prefill_calls, "launches": counts,
               "wall_s": wall, "tokens_per_s": n_tok / wall,
               "ttft_ms_p50": float(np.percentile(ttft, 50)),
               "ttft_ms_max": float(ttft.max()),
               "e2e_ms_p50": float(np.percentile(e2e, 50)),
               "e2e_ms_max": float(e2e.max()),
               "peak_used_pages": pool.peak_used_pages}
        out.append(row)
        print(json.dumps(row))
        eng.close()
    base = tokens_by_pass[passes[0][0]]
    for row in out:
        same = sum(int((a == b).sum())
                   for a, b in zip(base, tokens_by_pass[row["pass"]]))
        row["tokens_equal_to_first_pass"] = f"{same}/{16 * len(base)}"
        print(f"{model.cfg.name} tokens equal to the {passes[0][0]} pass: "
              f"{row['pass']} {same}/{16 * len(base)}")
    return out, base


def phase_parity(device) -> dict:
    """2-layer fp32 smollm-135m at full width: card (kernels) vs CPU
    (plain versions), same seeded weights."""
    from repro_torch.models.registry import get_model
    from repro_torch.models.registry import get_config
    from repro_torch.runtime import PagedKVCachePool
    cfg = get_config("smollm-135m").replace(n_layers=2, dtype="float32")
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, 100).astype(np.int32)
    runs = {}
    for dev in (device, "cpu"):
        model = get_model(cfg, device=dev)
        params = model.init_params(seed=1)
        pool = PagedKVCachePool(model, n_slots=2, max_len=128, page_size=PAGE_SIZE)
        cache = model.make_cache(1, pool.padded_len)
        logits, cache = model.prefill(params, {"tokens": prompt[None]}, cache)
        slot = pool.alloc(len(prompt), 8)
        pool.write_prompt(slot, cache, len(prompt))
        all_logits = [logits[0].float().cpu()]
        toks = [int(logits[0].argmax())]
        pos = np.zeros(2, np.int32)
        pos[slot] = len(prompt)
        for _ in range(8):
            pool.ensure_len(slot, int(pos[slot]) + 1)
            tok = np.zeros((2, 1), np.int32)
            tok[slot, 0] = toks[-1]
            lg, _ = model.decode_step_paged(params, pool.cache, {"tokens": tok},
                                            pos, pool.device_page_table(),
                                            PAGE_SIZE)
            all_logits.append(lg[slot].float().cpu())
            toks.append(int(lg[slot].argmax()))
            pos[slot] += 1
        runs[str(dev)] = (torch.stack(all_logits), toks)
    (lg_gpu, tk_gpu), (lg_cpu, tk_cpu) = runs[str(device)], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    res = {"max_abs_logit_err": err, "tol": 1e-3, "tokens_card": tk_gpu,
           "tokens_cpu": tk_cpu}
    print(json.dumps({"parity": res}))
    if not err <= 1e-3 or tk_gpu != tk_cpu:
        raise AssertionError(f"card vs CPU parity failed: {res}")
    res["engine"] = engine_parity(cfg, device)
    res["streamed_prefill_equal"] = streamed_parity(cfg, device)
    return res


def engine_parity(cfg, device) -> dict:
    """The sequential ``Engine`` (dense cache: flash prefill, then the
    decode_attention kernel) on the card against the CPU."""
    from repro_torch.models.registry import get_model
    from repro_torch.runtime import Engine
    prompts = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 40)
                                                ).astype(np.int32)
    runs = {}
    for dev in (device, "cpu"):
        model = get_model(cfg, device=dev)
        logits = []

        def prefill(p, inputs, cache, m=model, out=logits):
            lg, cache = m.prefill(p, inputs, cache)
            out.append(lg.float().cpu())
            return lg, cache

        def decode(p, cache, inputs, pos, m=model, out=logits):
            lg, cache = m.decode_step(p, cache, inputs, pos)
            out.append(lg.float().cpu())
            return lg, cache

        res = Engine(model, model.init_params(seed=1), prefill, decode
                     ).generate(prompts, max_new_tokens=8)
        runs[str(dev)] = (torch.stack(logits), res.tokens)
    (lg_gpu, tk_gpu), (lg_cpu, tk_cpu) = runs[str(device)], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    out = {"max_abs_logit_err": err, "tol": 1e-3,
           "tokens_equal": bool((tk_gpu == tk_cpu).all())}
    print(json.dumps({"engine_parity": out}))
    if not err <= 1e-3 or not out["tokens_equal"]:
        raise AssertionError(f"Engine card vs CPU parity failed: {out}")
    return out


def streamed_parity(cfg, device) -> bool:
    """A forked session's layer-streamed prefill on the card equals the
    monolithic prefill bit for bit (logits and cache)."""
    from repro_torch.core import api as tidal
    from repro_torch.core.streaming import streamed_prefill
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.models.registry import get_model
    model = get_model(cfg, device=device)
    params = model.init_params(seed=1)
    srv = TemplateServer(trace_seq=64)
    srv.register(tidal.static_function("f", model, params), {})
    session, _ = srv.fork("f", {})
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (1, 100)
                                             ).astype(np.int32)
    lg_s, c_s = streamed_prefill(session, {"tokens": toks},
                                 model.make_cache(1, 128))
    lg_m, c_m = model.prefill(params, {"tokens": toks}, model.make_cache(1, 128))
    torch.cuda.synchronize()
    equal = (torch.equal(lg_s, lg_m)
             and all(torch.equal(c_s[k], c_m[k]) for k in c_s))
    print(f"streamed prefill on the card equals the monolithic one: {equal}")
    if not equal:
        raise AssertionError("streamed prefill differs from prefill on the card")
    return equal


def phase_engine(model, params, paged_tokens: list) -> list:
    """The dense-cache paths at full width: the sequential ``Engine`` (8
    prompts of 256 tokens, 32 new tokens), then ``paged=False`` continuous
    batching over phase 3's workload."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ContinuousBatchingEngine, Engine
    L, vocab = model.cfg.n_layers, model.cfg.vocab_size
    prompts = np.random.default_rng(5).integers(1, vocab, (8, 256)
                                                ).astype(np.int32)
    eng = Engine(model, params)
    eng.generate(prompts[:, :32], max_new_tokens=2)          # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_norm, n_fused = norm_launches(model.cfg), fused_norm_launches(model.cfg)
    if (counts["decode_attention"] != L * 31 or counts["flash_attention"] != L
            or counts["rmsnorm"] != 32 * n_norm
            or counts["rmsnorm_fused"] != 32 * n_fused):
        raise AssertionError(f"Engine launches {counts}, want {L * 31} decode, "
                             f"{L} flash and {32 * n_norm} rmsnorm "
                             f"({32 * n_fused} fused)")
    if res.tokens.shape != (8, 32) or not ((res.tokens >= 0)
                                           & (res.tokens < vocab)).all():
        raise AssertionError(f"Engine tokens {res.tokens.shape}")
    rows = [{"pass": "engine", "batch": 8, "prompt_len": 256, "new_tokens": 32,
             "launches": counts, "wall_s": wall, "ttft_ms": res.ttft_s * 1e3,
             "decode_ms_per_step": res.decode_s / 31 * 1e3,
             "tokens_per_s": 8 * 32 / wall}]
    print(json.dumps(rows[-1]))

    _, reqs = serving_workload(vocab)
    cbe = ContinuousBatchingEngine(model, params, n_slots=8, max_len=512,
                                   paged=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids = [cbe.submit(p, 16) for p in reqs]
    results = cbe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    out = [results[i] for i in ids]
    if any(r.status != "done" or r.n_generated != 16 for r in out):
        raise AssertionError("dense pass: unfinished requests")
    if (counts["decode_attention"] != L * cbe.n_decode_steps
            or counts["flash_attention"] != L * cbe.n_prefill_calls
            or counts["rmsnorm"] != n_norm * (cbe.n_decode_steps
                                              + cbe.n_prefill_calls)
            or counts["rmsnorm_fused"] != n_fused * (cbe.n_decode_steps
                                                     + cbe.n_prefill_calls)
            or counts["paged_decode_attention"]):
        raise AssertionError(f"dense pass launches {counts}, steps "
                             f"{cbe.n_decode_steps}, prefills {cbe.n_prefill_calls}")
    same = sum(int((r.tokens == t).sum()) for r, t in zip(out, paged_tokens))
    ttft = np.asarray([r.ttft_s for r in out]) * 1e3
    rows.append({"pass": "dense", "requests": len(out),
                 "decode_steps": cbe.n_decode_steps,
                 "prefill_calls": cbe.n_prefill_calls, "launches": counts,
                 "wall_s": wall, "tokens_per_s": 16 * len(out) / wall,
                 "ttft_ms_p50": float(np.percentile(ttft, 50)),
                 "ttft_ms_max": float(ttft.max()),
                 "tokens_equal_to_paged_pass": same})
    print(json.dumps(rows[-1]))
    print(f"dense pass tokens equal to the paged pass: {same}/{16 * len(out)}")
    # paged and dense decode run one split-KV body, so the two pools give
    # the same greedy tokens
    if same != 16 * len(out):
        raise AssertionError(f"dense pass: {same}/{16 * len(out)} tokens equal "
                             f"to the paged pass")
    return rows


def _median_max(xs) -> dict:
    xs = np.asarray(xs, dtype=float) * 1e3
    return {"n": int(xs.size), "median_ms": float(np.median(xs)),
            "max_ms": float(xs.max())}


def phase_tidal(device, h2d: float) -> dict:
    """``FaaSRuntime`` at full width: a static function with a 131-token
    template prompt and a LoRA function (``blocks.attn.wq``, 2 adapters),
    invoked through the gateway's pump thread so that each is cold once,
    then warm, then forked after an evict (the LoRA one also on a new
    event)."""
    from repro_torch.core import api as tidal
    from repro_torch.core.forking import DonationGuard
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import FaaSRuntime, InvocationRequest
    model, p_static = full_model(device, seed=2)
    p_lora = model.init_params(seed=3)
    vocab = model.cfg.vocab_size
    prefix, reqs = serving_workload(vocab)
    rt = FaaSRuntime(server=TemplateServer(hw=H100_SXM.with_h2d(h2d),
                                           trace_seq=128),
                     n_slots=8, max_len=512, page_size=PAGE_SIZE, device=device)
    t0 = time.perf_counter()
    rt.deploy(tidal.static_function("static", model, p_static), {},
              prewarm_seq=128, template_prompt=prefix)
    rt.deploy(tidal.lora_function("lora", model, p_lora, ["blocks.attn.wq"],
                                  n_adapters=2), {"adapter": "adapter-0"},
              prewarm_seq=128)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    model_bytes = rt.server.templates["static"].total_bytes
    a0, a1 = {"adapter": "adapter-0"}, {"adapter": "adapter-1"}
    # (function, event, prompt index): the first of each key forks its engine
    waves = [[("static", {}, 0), ("static", {}, 1), ("lora", a0, 3),
              ("lora", a0, 4)],
             [("static", {}, 2), ("lora", a0, 5), ("lora", a1, 6),
              ("lora", a1, 7)],
             "evict",
             [("static", {}, 0), ("lora", a1, 6)],
             [("static", {}, 0), ("lora", a1, 6), ("static", {}, 8),
              ("lora", a0, 9), ("lora", a0, 10), ("static", {}, 11)]]
    results, stats, guard_bufs = [], [], None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rt.gateway.start_pump()
    try:
        for wave in waves:
            if wave == "evict":
                rt.evict()
                # make half the static template resident, so the next fork
                # shares device buffers the guard then watches
                rt.server.set_resident_bytes("static", model_bytes // 2)
                guard_bufs = dict(rt.server.device_cache["static"])
                guard = DonationGuard.guard(guard_bufs)
                continue
            handles = [rt.submit(InvocationRequest(fn, reqs[i], event=ev,
                                                   max_new_tokens=16))
                       for fn, ev, i in wave]
            for (fn, ev, i), h in zip(wave, handles):
                r = h.result(timeout=600)
                results.append((fn, tuple(sorted(ev.items())), i, r))
                if r.fork_stats is not None:
                    eng = rt._engines[h.engine_key].engine
                    stats.append((fn, r.fork_stats, eng.session.streamer))
    finally:
        rt.gateway.stop_pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    kinds = [r.kind for *_, r in results]
    if set(kinds) != {"cold", "warm", "fork"}:
        raise AssertionError(f"service kinds {kinds}")
    bad = [r for *_, r in results if r.status != "done" or len(r.tokens) != 16]
    if bad:
        raise AssertionError(f"unfinished invocations {bad}")
    first_of_engine = [r for *_, r in results if r.fork_stats is not None]
    if not all(r.streamed_prefill for r in first_of_engine):
        raise AssertionError("a cold/fork admission did not stream its prefill")
    for fn, fs, streamer in stats:
        if fs.reused_bytes + fs.streamed_bytes + fs.dynamic_bytes != model_bytes:
            raise AssertionError(f"{fn}: fork bytes {fs} != {model_bytes}")
        streamer.wait_all()
        rank = {k: j for j, k in enumerate(rt.server.templates[fn].order)}
        done = [rank[k] for k in streamer.completed_order]
        if (streamer.completed_order != [e.key for e in streamer.entries]
                or done != sorted(done)):
            raise AssertionError(f"{fn}: stream order differs from the template")
    reused = [fs.reused_bytes for fn, fs, _ in stats if fn == "static"]
    violated = guard.check(guard_bufs)
    if not guard_bufs or not reused[-1] or violated:
        raise AssertionError(f"forking guard: {len(guard_bufs)} buffers, "
                             f"reused {reused}, violated {violated}")
    # a fork's tokens equal a warm invocation's for the same prompt/event
    by_key = {}
    for fn, ev, i, r in results[-8:]:
        by_key.setdefault((fn, ev, i), []).append(r)
    for key, rs in by_key.items():
        if len(rs) == 2 and rs[0].kind == "fork":
            if rs[1].kind != "warm" or not np.array_equal(rs[0].tokens,
                                                          rs[1].tokens):
                raise AssertionError(f"{key}: fork tokens != warm tokens")
    if (counts["paged_decode_attention"] == 0 or counts["flash_attention"] == 0
            or counts["decode_attention"]):
        raise AssertionError(f"TIDAL phase launches {counts}")
    check_norm_launches(counts, model.cfg, "TIDAL phase")
    out = {"deploy_s": deploy_s, "model_bytes": model_bytes,
           "invocations": len(results), "kinds": kinds, "wall_s": wall,
           "launches": counts,
           "ttft": {k: _median_max([r.ttft_s for *_, r in results
                                    if r.kind == k])
                    for k in ("cold", "fork", "warm")},
           "fork_s": _median_max([fs.fork_s for _, fs, _ in stats]),
           "fork_bytes": [{"fn": fn, "reused": fs.reused_bytes,
                           "streamed": fs.streamed_bytes,
                           "dynamic": fs.dynamic_bytes} for fn, fs, _ in stats],
           "reuse_hits": sum(r.reused_prefix_len > 0 for *_, r in results),
           "h2d_gb_per_s": h2d / 1e9,
           "resident_bytes_after_eq1": {k: t.resident_bytes for k, t
                                        in rt.server.templates.items()},
           "gateway": dict(rt.gateway.stats)}
    out["isolated"] = isolated_fork_and_warm(rt, reqs[0])
    print(json.dumps(out))
    rt.evict()
    out["first_invocation"] = first_ttft_subprocesses(("prewarm",
                                                       "no-prewarm"))
    print(json.dumps({"first_invocation": out["first_invocation"]}))
    return out


def isolated_fork_and_warm(rt, prompt) -> dict:
    """One invocation alone on a fresh fork, then the same one warm: the
    paper's fork-against-warm TTFT with no other request queued."""
    rt.evict()
    fork = rt.submit("static", {}, prompt, 16)
    warm = rt.submit("static", {}, prompt, 16)
    if (fork.kind, warm.kind) != ("fork", "warm") or not np.array_equal(
            fork.tokens, warm.tokens):
        raise AssertionError(f"isolated pair: {fork.kind} {warm.kind}")
    return {"fork_ttft_ms": fork.ttft_s * 1e3, "warm_ttft_ms": warm.ttft_s * 1e3,
            "fork_s_ms": fork.fork_stats.fork_s * 1e3,
            "streamed_prefill": fork.streamed_prefill,
            "reused_prefix_len": fork.reused_prefix_len}


def first_ttft_subprocesses(modes: tuple) -> dict:
    """The first invocation's TTFT in a fresh process per mode (context,
    library load and first calls unpaid), with or without deploy-time
    prewarming.  The processes start together and each stops once its
    function is registered (the start-up, ~10 s, taken at once); then one
    at a time deploys and serves its first invocations, so no measured
    part shares the card with another."""
    import tempfile
    errs = {m: tempfile.TemporaryFile(mode="w+") for m in modes}
    procs = {m: subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                  "--first-ttft", m], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=errs[m],
                                 text=True)
             for m in modes}

    def stderr_of(m):
        errs[m].seek(0)
        return errs[m].read()[-4000:]
    try:
        for m, p in procs.items():
            seen = []
            for line in p.stdout:            # up to the handshake line
                if line.strip() == "registered":
                    break
                seen.append(line)
            else:
                p.wait()
                raise RuntimeError(f"--first-ttft {m} ended before its "
                                   f"turn:\n{''.join(seen)}{stderr_of(m)}")
        out = {}
        for m, p in procs.items():
            res_out, _ = p.communicate("go\n", timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"--first-ttft {m} failed:\n{res_out}"
                                   f"{stderr_of(m)}")
            out[m] = json.loads(res_out.strip().splitlines()[-1])
        return out
    finally:
        for m, p in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait()
            errs[m].close()


def first_ttft(mode: str) -> dict:
    """Body of ``--first-ttft``: deploy one static smollm-135m function and
    time its first invocation (256-token prompt, 8 new tokens)."""
    from repro_torch.core import api as tidal
    from repro_torch.runtime import FaaSRuntime
    device = torch.device("cuda", 0)
    model, params = full_model(device, seed=2)
    t0 = time.perf_counter()
    rt = FaaSRuntime(n_slots=8, max_len=512, page_size=PAGE_SIZE,
                     prewarm=mode == "prewarm", device=device)
    runtime_s = time.perf_counter() - t0
    fn = tidal.static_function("f", model, params)
    t0 = time.perf_counter()
    rt.server.register(fn, {})
    register_s = time.perf_counter() - t0
    print("registered", flush=True)       # then wait for our turn
    sys.stdin.readline()
    t0 = time.perf_counter()
    rt.deploy(fn, {}, prewarm_seq=256)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    prompt = np.random.default_rng(6).integers(1, model.cfg.vocab_size, 256)
    r = rt.submit("f", {}, prompt.astype(np.int32), 8)
    second = rt.submit("f", {}, prompt.astype(np.int32), 8)
    return {"mode": mode, "runtime_s": runtime_s, "register_s": register_s,
            "deploy_s": deploy_s, "kind": r.kind,
            "ttft_ms": r.ttft_s * 1e3, "e2e_ms": r.e2e_s * 1e3,
            "warm_ttft_ms": second.ttft_s * 1e3}


TENANT_TARGETS = ("blocks.attn.wq", "blocks.attn.wv")
TENANT_ALPHAS = {"fn-1": 0.5, "fn-2": 1.0, "fn-3": 1.5}


def _tenant_checkpoints(model, rank: int = 8) -> dict:
    from repro_torch.core import api as tidal
    return {name: tidal.lora_checkpoint(f"ckpt://{name}", model,
                                        list(TENANT_TARGETS), rank=rank, seed=i)
            for i, name in enumerate(TENANT_ALPHAS, start=1)}


def phase_tenants(device, h2d: float) -> dict:
    """Many LoRA functions on one resident base at full width: a shared
    smollm-135m base (bank of 4 rows over wq and wv, rank 8) serving three
    adapter functions and the base itself through the gateway's pump
    thread; then the merged-weight check and the control plane."""
    from repro_torch.core import api as tidal
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import FaaSRuntime, InvocationRequest
    model, p_base = full_model(device, seed=4)
    vocab, L = model.cfg.vocab_size, model.cfg.n_layers
    rt = FaaSRuntime(server=TemplateServer(hw=H100_SXM.with_h2d(h2d),
                                           trace_seq=128),
                     n_slots=8, max_len=512, page_size=PAGE_SIZE, device=device)
    t0 = time.perf_counter()
    rt.deploy_shared_base(tidal.static_function("base", model, p_base),
                          n_adapters=4, rank=8, target_paths=TENANT_TARGETS,
                          prewarm_seq=128)
    for name, ckpt in _tenant_checkpoints(model).items():
        rt.attach_adapter(name, "base", ckpt, alpha=TENANT_ALPHAS[name])
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    names = ["base"] + list(TENANT_ALPHAS)
    work = [(names[i % 4], rng.integers(1, vocab, int(rng.integers(64, 257))
                                        ).astype(np.int32)) for i in range(16)]
    # record the adapter rows of every banked decode step
    mixes = []
    decode_step_paged = model.decode_step_paged

    def recording(*a, **kw):
        if kw.get("adapter_bank") is not None:
            ids = set(kw["adapter_ids"].tolist()) - {0}
            mixes.append(len(ids))
        return decode_step_paged(*a, **kw)

    model.decode_step_paged = recording
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rt.gateway.start_pump()
    try:
        handles = [rt.submit(InvocationRequest(fn, p, max_new_tokens=16))
                   for fn, p in work]
        res = [h.result(timeout=600) for h in handles]
    finally:
        rt.gateway.stop_pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    del model.decode_step_paged

    key = ("__adapters__", "base", 0)
    rows = dict(rt._engines[key].adapter_ids)
    if sorted(rows) != sorted(TENANT_ALPHAS) or sorted(rows.values()) != [1, 2, 3]:
        raise AssertionError(f"adapter rows {rows}")
    bad = [r for r in res if r.status != "done" or len(r.tokens) != 16
           or not ((r.tokens >= 0) & (r.tokens < vocab)).all()]
    if bad:
        raise AssertionError(f"unfinished tenant invocations {bad}")
    if not mixes or max(mixes) < 2:
        raise AssertionError(f"no decode step mixed adapter rows: {mixes}")
    engines = [w.engine for w in rt._engines.values()]
    steps = sum(e.n_decode_steps for e in engines)
    prefills = sum(e.n_prefill_calls for e in engines)
    if (counts["paged_decode_attention"] != L * steps
            or counts["flash_attention"] != L * prefills
            or counts["rmsnorm"] != norm_launches(model.cfg) * (steps + prefills)
            or counts["rmsnorm_fused"] != fused_norm_launches(model.cfg) * (
                steps + prefills)
            or counts["decode_attention"]):
        raise AssertionError(f"tenant launches {counts}, {steps} decode steps, "
                             f"{prefills} prefills")
    out = {"deploy_s": deploy_s, "invocations": len(res),
           "engines": [list(map(str, k)) for k in rt.warm_engines()],
           "adapter_rows": rows, "decode_steps": steps, "prefill_calls": prefills,
           "banked_steps": len(mixes), "mixed_steps": sum(m >= 2 for m in mixes),
           "max_rows_in_a_step": max(mixes), "launches": counts, "wall_s": wall,
           "tokens_per_s": 16 * len(res) / wall,
           "kinds": [r.kind for r in res],
           "ttft": {fn: _median_max([r.ttft_s for (f, _), r in zip(work, res)
                                     if f == fn]) for fn in names}}
    print(json.dumps(out))
    out["merged_parity"] = merged_parity(device)
    out["control_plane"] = control_plane_run(rt, model, p_base)
    return out


def merged_parity(device) -> dict:
    """2-layer fp32 smollm-135m at full width on the card: each adapter
    function's greedy tokens from one mixed banked batch equal its
    merged-weight model's (W + alpha * A @ B), and their last-token logits
    agree within 1e-3 (different fp32 arithmetic, TF32 off)."""
    from repro_torch.models.adapters import load_adapter, make_adapter_bank
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.runtime import ContinuousBatchingEngine, Engine
    cfg = get_config("smollm-135m").replace(n_layers=2, dtype="float32")
    model = get_model(cfg, device=device)
    params = model.init_params(seed=1)
    ckpts = _tenant_checkpoints(model)
    bank = make_adapter_bank(model, TENANT_TARGETS, 4, 8)
    for row, (name, ckpt) in enumerate(ckpts.items(), start=1):
        load_adapter(bank, row, ckpt, model, alpha=TENANT_ALPHAS[name])
    prompts = np.random.default_rng(8).integers(1, cfg.vocab_size, (3, 40)
                                                ).astype(np.int32)
    eng = ContinuousBatchingEngine(model, params, n_slots=4, max_len=64,
                                   page_size=PAGE_SIZE, adapter_bank=bank)
    ids = [eng.submit(p, 8, adapter_id=row) for row, p in enumerate(prompts, 1)]
    got = eng.run()
    out, worst = {}, 0.0
    for row, (name, ckpt) in enumerate(ckpts.items(), start=1):
        merged = {**params, "layers": [dict(lp, attn=dict(lp["attn"]))
                                       for lp in params["layers"]]}
        for path in TENANT_TARGETS:
            proj = path.rsplit(".", 1)[-1]
            a, b = ckpt.arrays[path + ".A"], ckpt.arrays[path + ".B"]
            delta = ((a @ b) * TENANT_ALPHAS[name]).reshape(cfg.n_layers, *merged[
                "layers"][0]["attn"][proj].shape)
            for i, lp in enumerate(merged["layers"]):
                lp["attn"][proj] = lp["attn"][proj] + delta[i].to(device)
        want = Engine(model, merged).generate(prompts[row - 1][None],
                                              max_new_tokens=8).tokens[0]
        toks = got[ids[row - 1]].tokens
        seq = np.concatenate([prompts[row - 1], toks[:-1]])[None]
        lg_bank, _ = model.prefill(params, {"tokens": seq}, model.make_cache(1, 64),
                                   adapter_bank=bank, adapter_ids=[row])
        lg_merged, _ = model.prefill(merged, {"tokens": seq}, model.make_cache(1, 64))
        err = float((lg_bank - lg_merged).abs().max())
        worst = max(worst, err)
        out[name] = {"tokens_equal": bool(np.array_equal(toks, want)),
                     "max_abs_logit_err": err}
    res = {"functions": out, "tol": 1e-3, "max_abs_logit_err": worst}
    print(json.dumps({"merged_parity": res}))
    if worst > 1e-3 or not all(v["tokens_equal"] for v in out.values()):
        raise AssertionError(f"banked adapters differ from merged weights: {res}")
    return res


def control_plane_run(rt, model, params) -> dict:
    """The control plane on the tenants' runtime: an undeclared 128-token
    root shared by four prompts is baked after three misses (on the pump
    thread) and reused by the fourth; then a 24-request open-loop Poisson
    replay at 4 qps over a static function and an adapter function."""
    from repro_torch.core import api as tidal
    from repro_torch.kernels import ops
    from repro_torch.runtime import ControlPlane, InvocationRequest
    vocab = model.cfg.vocab_size
    rt.deploy(tidal.static_function("cp-static", model, params), {},
              prewarm_seq=128)
    cp = ControlPlane(rt, min_hits=3, tick_interval_s=0)
    rng = np.random.default_rng(9)
    root = rng.integers(1, vocab, 128).astype(np.int32)
    prompts = [np.concatenate([root, rng.integers(1, vocab, 8 * int(rng.integers(
        2, 9)))]).astype(np.int32) for _ in range(4)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rt.gateway.start_pump()
    try:
        misses = [rt.submit(InvocationRequest("cp-static", p, max_new_tokens=16)
                            ).result(timeout=600) for p in prompts[:3]]
    finally:
        rt.gateway.stop_pump()
    cp.tick()
    hit = rt.submit("cp-static", {}, prompts[3], 16)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check_norm_launches(counts, model.cfg, "control plane")
    want_reuse = 128 - (128 - len(prompts[3])) % PAGE_SIZE
    pinned = cp.pinned_nbytes()
    if (cp.stats["prefix_bakes"] != 1 or not 0 < pinned <= cp.pinned_bytes_budget
            or hit.reused_prefix_len != want_reuse
            or any(m.reused_prefix_len for m in misses)):
        raise AssertionError(f"learned prefix: {cp.stats}, pinned {pinned}, "
                             f"reuse {hit.reused_prefix_len} != {want_reuse}")
    learned = {"bakes": cp.stats["prefix_bakes"], "pinned_bytes": pinned,
               "reused_prefix_len": hit.reused_prefix_len,
               "miss_ttft_ms": [m.ttft_s * 1e3 for m in misses],
               "hit_ttft_ms": hit.ttft_s * 1e3, "launches": counts}
    print(json.dumps({"learned_prefix": learned}))

    t, schedule = 0.0, []
    for i in range(24):
        t += rng.exponential(1 / 4.0)
        fn = "cp-static" if i % 2 == 0 else "fn-1"
        tail = rng.integers(1, vocab, int(rng.integers(16, 129))).astype(np.int32)
        prompt = np.concatenate([root, tail]) if i % 4 == 0 else tail
        schedule.append((t, InvocationRequest(fn, prompt, max_new_tokens=16)))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = rt.gateway.replay(schedule)
    wall = time.perf_counter() - t0
    res = [h.result() for h in handles]
    counts = ops.launch_counts()
    check_norm_launches(counts, model.cfg, "open-loop replay")
    if any(r.status != "done" or len(r.tokens) != 16 for r in res):
        raise AssertionError("open-loop replay: unfinished invocations")
    ttft = np.asarray([r.ttft_s for r in res]) * 1e3
    kinds = {k: sum(r.kind == k for r in res) for k in ("cold", "fork", "warm")}
    replay = {"requests": len(res), "qps": 4.0, "wall_s": wall,
              "ttft_ms_p50": float(np.percentile(ttft, 50)),
              "ttft_ms_p95": float(np.percentile(ttft, 95)), "kinds": kinds,
              "reuse_hits": sum(r.reused_prefix_len > 0 for r in res),
              "control_plane": dict(cp.stats), "launches": counts}
    print(json.dumps({"open_loop": replay}))
    return {"learned_prefix": learned, "open_loop": replay}


# ---------------------------------------------------------------------------
# phase 8: the ssm family (ssd_scan, zamba2-2.7b)
# ---------------------------------------------------------------------------

def make_ssd_case(gen, B, S, bc_dtype, with_h0: bool, device,
                  c: dict = ZAMBA2_SSD) -> tuple:
    """Inputs as the zamba2 mixer makes them: xb [B, S, H, dh] fp32, B and
    C strided column slices of a [B, S, conv_ch] conv output, negative log
    decays, and an optional initial state (``c``: the mixer's heads, or
    one rank's)."""
    d_in, ds = c["d_inner"], c["ds"]
    conv = (torch.randn((B, S, d_in + 2 * ds), generator=gen) * 0.5).to(
        device, bc_dtype)
    xb = torch.randn((B, S, c["H"], c["dh"]), generator=gen).to(device)
    ld = (-torch.rand((B, S, c["H"]), generator=gen) * 0.25).to(device)
    h0 = (torch.randn((B, c["H"], c["dh"], ds), generator=gen).to(device)
          if with_h0 else None)
    return xb, conv[..., d_in:d_in + ds], conv[..., d_in + ds:], ld, h0


def phase_ssm_kernels(device) -> list:
    """``ssd_scan`` against both plain versions, and the attention kernels
    at zamba2's head dim of 80, on the card, timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator().manual_seed(8)
    rng = np.random.default_rng(8)
    Q = ZAMBA2_SSD["Q"]
    results = []
    # S = 64 and 384 are the ends of zamba2's serving prompts; one rank's
    # 40 heads at tp = 2 (phase 15) at its prompt of 96 and at 256 with h0
    full = ((1, 128, False), (1, 512, False), (1, 200, False),
            (4, 256, True), (1, 64, False), (1, 384, False))
    cases = ([(ZAMBA2_SSD, "zamba2-2.7b", dt) + c for c in full
              for dt in (torch.bfloat16, torch.float32)]
             + [(ZAMBA2_SSD_TP2, "zamba2-2.7b/tp2", torch.bfloat16) + c
                for c in ((1, 96, False), (4, 256, True))])
    for c, shape, bc_dtype, B, S, with_h0 in cases:
        args = make_ssd_case(gen, B, S, bc_dtype, with_h0, device, c)
        y, h = ssd_scan(*args[:4], Q, args[4])
        y2, h2 = ssd_scan(*args[:4], Q, args[4])
        plain = {"sequential": ref.ssd_scan_ref(*args)}
        if S % Q == 0:
            plain["chunked"] = ref.ssd_chunked_ref(*args[:4], Q, args[4])
        torch.cuda.synchronize()
        errs, ok = {}, True
        for name, (yp, hp) in plain.items():
            ey = float((y - yp).abs().max())
            eh = float((h - hp).abs().max())
            ty, th = 1e-4 * float(yp.abs().max()), 1e-4 * float(hp.abs().max())
            errs[name] = {"y": ey, "h": eh, "tol_y": ty, "tol_h": th}
            ok = ok and ey <= ty and eh <= th
        same = torch.equal(y, y2) and torch.equal(h, h2)
        kern_ms = time_ms(lambda: ssd_scan(*args[:4], Q, args[4]))
        plain_ms = time_ms(lambda: ref.ssd_ref(*args[:4], Q, args[4]),
                           reps=3, graph_calls=1)
        flops, nbytes = ssd_work(B, S, c["H"], c["dh"], c["ds"], Q,
                                 bc_dtype, with_h0)
        b_ms, b_by = bound_ms(flops, nbytes, "tf32")
        res = {"kernel": "ssd_scan", "shape": shape, "B": B, "S": S,
               "H": c["H"], "dh": c["dh"], "ds": c["ds"], "Q": Q,
               "h0": with_h0, "bc_dtype": str(bc_dtype)[6:],
               "max_abs_err": max(max(e["y"], e["h"]) for e in errs.values()),
               "errors": errs, "tol": "1e-4 of the largest |y| and |h|",
               "deterministic": same, "ms": kern_ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        results.append(res)
        print(json.dumps(res))
        if not ok or not same:
            raise AssertionError(f"ssd_scan disagrees: {res}")
        if B > 1:
            results.append(ssd_invariance(args, Q, y, h, bc_dtype, shape))

    for heads, shape, dtype, S in (
            (ZAMBA2_ATTN, "zamba2-2.7b", torch.bfloat16, 384),
            (ZAMBA2_ATTN, "zamba2-2.7b", torch.float32, 384),
            (ZAMBA2_ATTN_TP2, "zamba2-2.7b/tp2", torch.bfloat16, 96)):
        H, KV, d = heads["H"], heads["KV"], heads["d"]
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        T = S
        q = torch.randn((1, H, S, d), generator=gen).to(device, dtype)
        k = torch.randn((1, KV, T, d), generator=gen).to(device, dtype)
        v = torch.randn((1, KV, T, d), generator=gen).to(device, dtype)
        out = flash_attention(q, k, v)
        err = float((out.float() - ref.flash_attention_ref(q, k, v).float()
                     ).abs().max())
        flops, nbytes = flash_work(1, H, KV, S, T, d, dtype)
        b_ms, b_by = bound_ms(flops, nbytes, dtype)
        res = {"kernel": "flash_attention", "shape": shape, "B": 1,
               "H": H, "KV": KV, "d": d, "S": S, "T": T, "dtype": str(dtype)[6:],
               "softcap": 0.0, "max_abs_err": err, "tol": tol,
               "ms": time_ms(lambda: flash_attention(q, k, v)),
               "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v)),
               "library_ms": time_ms(lambda: sdpa_gqa(q, k, v, is_causal=True)),
               "bound_ms": b_ms, "bound_by": b_by}
        results.append(res)
        print(json.dumps(res))
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees at d = 80: {res}")

        B, T = 8, 512
        lengths = [1] + rng.integers(2, T + 1, B - 2).tolist() + [T]
        q = torch.randn((B, H, d), generator=gen).to(device, dtype)
        ck = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
        cv = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
        ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
        k, v = ck.transpose(1, 2), cv.transpose(1, 2)
        out = decode_attention(q, k, v, ln)
        err = float((out.float() - ref.decode_attention_ref(q, k, v, ln).float()
                     ).abs().max())
        mask = (torch.arange(T, device=device)[None, :]
                < ln[:, None].long())[:, None, None, :]
        flops, nbytes = decode_work(B, H, KV, d, lengths, dtype)
        b_ms, b_by = bound_ms(flops, nbytes, dtype)
        res = {"kernel": "decode_attention", "shape": shape, "B": B,
               "H": H, "KV": KV, "d": d, "T": T, "max_len": int(max(lengths)),
               "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
               "ms": time_ms(lambda: decode_attention(q, k, v, ln)),
               "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, ln)),
               "library_ms": time_ms(lambda: sdpa_gqa(q[:, :, None], k, v,
                                                      attn_mask=mask)),
               "bound_ms": b_ms, "bound_by": b_by}
        results.append(res)
        print(json.dumps(res))
        if not err <= tol:
            raise AssertionError(f"decode_attention disagrees at d = 80: {res}")
    results.append(attention_invariance(device, gen, ZAMBA2_ATTN, "zamba2-2.7b"))
    return results


def ssd_invariance(args: tuple, Q: int, y, h, bc_dtype,
                   shape: str = "zamba2-2.7b") -> dict:
    """Bitwise checks of ``ssd_scan`` that the layer-streamed prefill and
    batched prefills rely on: each sequence of a batch run alone gives the
    bits it got in the batch, and a repeated call gives the first call's;
    B and C on unaligned rows (element loads in place of cp.async) give
    the same bits too."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    xb, Bm, Cm, ld, h0 = args
    alone = []
    for b in range(xb.shape[0]):
        s = slice(b, b + 1)
        ya, ha = ssd_scan(xb[s], Bm[s], Cm[s], ld[s], Q, None if h0 is None else h0[s])
        alone.append(torch.equal(ya, y[s]) and torch.equal(ha, h[s]))
    yr, hr = ssd_scan(xb, Bm, Cm, ld, Q, h0)
    yu, hu = ssd_scan(xb, unaligned_copy(Bm), unaligned_copy(Cm), ld, Q, h0)
    row = {"invariance": f"ssd_scan {shape}", "B": int(xb.shape[0]),
           "S": int(xb.shape[1]), "bc_dtype": str(bc_dtype)[6:],
           "ssd_alone_equals_batch": all(alone),
           "ssd_repeat_equal": torch.equal(yr, y) and torch.equal(hr, h),
           "ssd_unaligned_bc_equal": torch.equal(yu, y) and torch.equal(hu, h)}
    print(json.dumps(row))
    if not all(v for k, v in row.items() if k.startswith("ssd_")):
        raise AssertionError(f"ssd_scan invariance broken: {row}")
    return row


def zamba_model(device, seed: int = 0):
    """zamba2-2.7b at full width and depth with seeded random weights,
    drawn on the card (a CPU draw of its 2.4 B normals took ~20 s)."""
    from repro_torch.models.registry import get_model
    model = get_model("zamba2-2.7b", device=device)
    cfg = model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.attn_every) == (54, 2560, 6)
    t0 = time.perf_counter()
    params = model.init_params(seed=seed, draw_on_device=True)
    torch.cuda.synchronize()
    print(f"zamba2-2.7b: {cfg.n_layers} Mamba2 layers + 1 shared attention "
          f"block x {attention_launches(cfg)}, d_model {cfg.d_model}, "
          f"{model.dtype}, weights (seed {seed}) in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, params


def check_zamba_launches(counts: dict, cfg, prefills: int, steps: int,
                         where: str) -> None:
    """Exact launches of ``prefills`` prefill calls (S > 1) and ``steps``
    decode steps of a zamba model."""
    units = attention_launches(cfg)
    want = {"ssd_scan": cfg.n_layers * prefills,
            "flash_attention": units * prefills,
            "decode_attention": units * steps,
            "rmsnorm": norm_launches(cfg) * (prefills + steps),
            "rmsnorm_fused": fused_norm_launches(cfg) * (prefills + steps),
            "paged_decode_attention": 0, **NOT_LAUNCHED}
    if counts != want:
        raise AssertionError(f"{where}: launches {counts} != {want} "
                             f"({prefills} prefills, {steps} decode steps)")


def check_xlstm_launches(counts: dict, cfg, calls: int, where: str) -> None:
    """Exact launches of ``calls`` model calls of an xlstm model: rmsnorm
    only (103 per call for xlstm-1.3b, 6 of them fused), no attention
    kernel and no ``ssd_scan``."""
    want = {"rmsnorm": norm_launches(cfg) * calls,
            "rmsnorm_fused": fused_norm_launches(cfg) * calls,
            "ssd_scan": 0, "flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, **NOT_LAUNCHED}
    if counts != want:
        raise AssertionError(f"{where}: launches {counts} != {want} "
                             f"({calls} model calls)")


def dense_continuous(model, params, prompts: list, new_tokens: int,
                     where: str, max_len: int = 512) -> tuple:
    """Every prompt through one dense-pool ContinuousBatchingEngine (8
    slots), launch counts checked (zamba or xlstm); returns (row,
    tokens)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, params, n_slots=8, max_len=max_len)
    if eng.paged:
        raise AssertionError(f"{model.cfg.name} must serve over the dense "
                             "slot pool")
    host = []
    decode_step = model.decode_step

    def timed_decode(*a, **kw):             # host time of one decode call
        t = time.perf_counter()
        out = decode_step(*a, **kw)
        host.append(time.perf_counter() - t)
        return out

    model.decode_step = timed_decode
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ids = [eng.submit(p, new_tokens) for p in prompts]
        results = eng.run()
    finally:
        del model.decode_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = [results[i] for i in ids]
    vocab = model.cfg.vocab_size
    if any(r.status != "done" or r.n_generated != new_tokens
           or not ((r.tokens >= 0) & (r.tokens < vocab)).all() for r in res):
        raise AssertionError(f"{where}: unfinished requests")
    if model.cfg.family == "xlstm":
        check_xlstm_launches(counts, model.cfg,
                             eng.n_prefill_calls + eng.n_decode_steps, where)
    else:
        check_zamba_launches(counts, model.cfg, eng.n_prefill_calls,
                             eng.n_decode_steps, where)
    ttft = np.asarray([r.ttft_s for r in res]) * 1e3
    row = {"pass": where, "requests": len(res),
           "state_bytes_per_slot": eng.pool.nbytes() // eng.pool.n_slots,
           "prompt_lens": [int(r.prompt_len) for r in res],
           "new_tokens": new_tokens, "decode_steps": eng.n_decode_steps,
           "prefill_calls": eng.n_prefill_calls, "launches": counts,
           "wall_s": wall, "tokens_per_s": new_tokens * len(res) / wall,
           "decode_host_ms_median": float(np.median(host) * 1e3),
           "decode_host_ms_max": float(np.max(host) * 1e3),
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_max": float(ttft.max())}
    print(json.dumps(row))
    return row, [r.tokens for r in res]


def phase_zamba(device, h2d: float) -> dict:
    """zamba2-2.7b at full width: the dense-pool continuous engine, the
    sequential Engine, a 2-layer fp32 parity check, streamed prefill and
    FaaSRuntime cold / fork / warm."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import Engine
    model, params = zamba_model(device)
    cfg, vocab = model.cfg, model.cfg.vocab_size
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in ZAMBA_LENGTHS]
    dense_continuous(model, params, prompts[:2], 2, "zamba warm-up")
    serve, _ = dense_continuous(model, params, prompts, 16, "zamba dense pool")

    batch = np.random.default_rng(11).integers(1, vocab, (8, 256)).astype(np.int32)
    eng = Engine(model, params)
    eng.generate(batch[:, :32], max_new_tokens=2)             # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(batch, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_zamba_launches(counts, cfg, 1, 31, "zamba Engine")
    cont, cont_tokens = dense_continuous(model, params, list(batch), 32,
                                         "zamba dense pool, Engine's prompts")
    equal = sum(int((res.tokens[i] == t).sum()) for i, t in enumerate(cont_tokens))
    engine = {"pass": "zamba engine", "batch": 8, "prompt_len": 256,
              "new_tokens": 32, "launches": counts, "wall_s": wall,
              "ttft_ms": res.ttft_s * 1e3,
              "decode_ms_per_step": res.decode_s / 31 * 1e3,
              "tokens_per_s": 8 * 32 / wall,
              "tokens_equal_to_continuous": f"{equal}/{8 * 32}"}
    print(json.dumps(engine))
    if equal != 8 * 32:
        raise AssertionError(f"Engine tokens differ from the continuous "
                             f"engine's: {equal}/{8 * 32}")
    out = {"serve": serve, "engine": engine, "engine_prompts_continuous": cont}
    out["faas"] = zamba_faas(model, params, prompts, h2d)
    del model, params
    torch.cuda.empty_cache()
    out["parity"] = zamba_parity(device)
    return out


def zamba_parity(device) -> dict:
    """A 2-layer fp32 zamba2 at full width (one unit of two Mamba2 blocks
    and the shared block): ``recurrent_parity`` on a ragged 200-token
    prompt pair, logits within 1e-3."""
    from repro_torch.models.registry import get_config
    cfg = get_config("zamba2-2.7b").replace(n_layers=2, attn_every=2,
                                            dtype="float32")
    prompts = np.random.default_rng(12).integers(1, cfg.vocab_size, (2, 200)
                                                 ).astype(np.int32)
    return recurrent_parity(cfg, device, prompts, lambda _: 1e-3, "zamba", 64)


def recurrent_parity(cfg, device, prompts: np.ndarray, tol, tag: str,
                     trace_seq: int) -> dict:
    """``cfg`` (fp32, cut depth, full width): the same seeded weights on
    the card (kernels) and on the CPU (plain versions), ``prompts`` and 8
    greedy decode steps through the ``Engine``, logits within
    ``tol(largest |logit|)`` and tokens equal; then the card's
    layer-streamed prefill of a forked session against its monolithic
    prefill, bit for bit."""
    from repro_torch.core import api as tidal
    from repro_torch.core.streaming import streamed_prefill
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.models.registry import get_model
    from repro_torch.runtime import Engine
    from repro_torch.utils import named_leaves
    runs = {}
    for dev in (device, "cpu"):
        model = get_model(cfg, device=dev)
        logits = []

        def prefill(p, inputs, cache, m=model, out=logits):
            lg, cache = m.prefill(p, inputs, cache)
            out.append(lg.float().cpu())
            return lg, cache

        def decode(p, cache, inputs, pos, m=model, out=logits):
            lg, cache = m.decode_step(p, cache, inputs, pos)
            out.append(lg.float().cpu())
            return lg, cache

        res = Engine(model, model.init_params(seed=1), prefill, decode
                     ).generate(prompts, max_new_tokens=9)
        runs[str(dev)] = (torch.stack(logits), res.tokens)
    (lg_gpu, tk_gpu), (lg_cpu, tk_cpu) = runs[str(device)], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    out = {"config": f"{cfg.name} x {cfg.n_layers} layers, {cfg.dtype}",
           "max_abs_logit_err": err, "max_abs_logit": float(lg_cpu.abs().max()),
           "tol": tol(float(lg_cpu.abs().max())),
           "tokens_equal": bool((tk_gpu == tk_cpu).all()),
           "tokens_card": tk_gpu.tolist()}
    if not err <= out["tol"] or not out["tokens_equal"]:
        raise AssertionError(f"{tag} card vs CPU parity failed: {out}")

    model = get_model(cfg, device=device)
    params = model.init_params(seed=1)
    srv = TemplateServer(trace_seq=trace_seq)
    srv.register(tidal.static_function("z", model, params), {})
    session, _ = srv.fork("z", {})
    lg_s, c_s = streamed_prefill(session, {"tokens": prompts[:1]},
                                 model.make_cache(1, 256))
    lg_m, c_m = model.prefill(params, {"tokens": prompts[:1]},
                              model.make_cache(1, 256))
    torch.cuda.synchronize()
    out["streamed_prefill_equal"] = bool(torch.equal(lg_s, lg_m) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(c_s),
                                                    named_leaves(c_m))))
    print(json.dumps({f"{tag}_parity": out}))
    if not out["streamed_prefill_equal"]:
        raise AssertionError(f"{tag} streamed prefill differs from prefill")
    return out


def zamba_faas(model, params, prompts: list, h2d: float) -> dict:
    """A static zamba2-2.7b function through ``FaaSRuntime`` and the pump
    thread: cold, warm, then fork and warm after an evict; then one fork
    alone and one warm invocation alone."""
    from repro_torch.core import api as tidal
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import FaaSRuntime, InvocationRequest
    rt = FaaSRuntime(server=TemplateServer(hw=H100_SXM.with_h2d(h2d),
                                           trace_seq=128),
                     n_slots=8, max_len=512, device=model.device)
    t0 = time.perf_counter()
    rt.deploy(tidal.static_function("zamba", model, params), {},
              prewarm_seq=128)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    tpl = rt.server.templates["zamba"]
    results = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rt.gateway.start_pump()
    try:
        for wave in ([0, 1], "evict", [2, 3]):
            if wave == "evict":
                rt.evict()
                continue
            handles = [rt.submit(InvocationRequest("zamba", prompts[i],
                                                   max_new_tokens=16))
                       for i in wave]
            results += [h.result(timeout=600) for h in handles]
    finally:
        rt.gateway.stop_pump()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    kinds = [r.kind for r in results]
    if kinds != ["cold", "warm", "fork", "warm"]:
        raise AssertionError(f"zamba service kinds {kinds}")
    if any(r.status != "done" or len(r.tokens) != 16 for r in results):
        raise AssertionError("unfinished zamba invocations")
    forks = [r for r in results if r.fork_stats is not None]
    for r in forks:
        fs = r.fork_stats
        if not r.streamed_prefill or (fs.reused_bytes + fs.streamed_bytes
                                      + fs.dynamic_bytes != tpl.total_bytes):
            raise AssertionError(f"zamba fork: streamed {r.streamed_prefill}, "
                                 f"bytes {fs} != {tpl.total_bytes}")
    check_norm_launches(counts, model.cfg, "zamba FaaS")
    if counts["ssd_scan"] * attention_launches(model.cfg) != (
            model.cfg.n_layers * counts["flash_attention"]) or counts[
                "paged_decode_attention"]:
        raise AssertionError(f"zamba FaaS launches {counts}")
    rt.evict()
    fork = rt.submit("zamba", {}, prompts[4], 16)
    warm = rt.submit("zamba", {}, prompts[4], 16)
    if (fork.kind, warm.kind) != ("fork", "warm") or not np.array_equal(
            fork.tokens, warm.tokens):
        raise AssertionError(f"zamba isolated pair: {fork.kind} {warm.kind}")
    out = {"deploy_s": deploy_s, "model_bytes": tpl.total_bytes,
           "kinds": kinds, "launches": counts,
           "ttft_ms": {r.kind + str(i): r.ttft_s * 1e3
                       for i, r in enumerate(results)},
           "fork_bytes": [{"reused": r.fork_stats.reused_bytes,
                           "streamed": r.fork_stats.streamed_bytes,
                           "dynamic": r.fork_stats.dynamic_bytes}
                          for r in forks],
           "resident_bytes_after_eq1": tpl.resident_bytes,
           "isolated": {"fork_ttft_ms": fork.ttft_s * 1e3,
                        "warm_ttft_ms": warm.ttft_s * 1e3,
                        "fork_s_ms": fork.fork_stats.fork_s * 1e3,
                        "streamed_bytes": fork.fork_stats.streamed_bytes,
                        "reused_bytes": fork.fork_stats.reused_bytes,
                        "prompt_len": len(prompts[4])}}
    print(json.dumps({"zamba_faas": out}))
    rt.evict()
    return out


# ---------------------------------------------------------------------------
# phases 9 and 10: llama2-13b and phi3.5-moe at cut depth
# ---------------------------------------------------------------------------

# phi3.5-moe-42b-a6.6b does not fit one card at its 32 layers (84 GB);
# phase 10 takes the largest depth whose FaaS runtime fits (see
# ``fitting_depth``), keeping these margins free: on the card for the
# arena, activations and the caching allocator's slack (1.5 GB at 8
# layers), on the host for the transient leaves of the random draw and
# the serving passes
DEVICE_SLACK_BYTES = 6e9
HOST_SLACK_BYTES = 10e9
# phase 10's depth at most (its draw, deploys and serving passes grow with
# it; the whole script keeps to its time limit with phases 11 to 16 after
# it: 8 layers took the script to 1,165.8 s of its 1,200 on a slow host,
# and 4 until phase 15 served LoRA and two rank groups)
MOE_MAX_LAYERS = 2
# phase 11's fp32 card against CPU check: one full-width layer holds 256
# experts of 46 GB in fp32 on each side, too much for the host
DEEPSEEK_PARITY_EXPERTS = 32
# phase 9's depth: the whole script keeps to its time limit with phase
# 15's moe and MLA cases (they added ~100-120 s); phase 9 took 33.2-35.9
# s at 20 layers and 60.2-75.3 s at 40, the script 820.6-896.9 s at 20;
# 10 since the script read 1,252.4 s on a slow host with phase 17's
# training cases (phase 9 37.3 s there)
LLAMA_LAYERS = 10


def meminfo() -> dict:
    """The host's total and available memory in GB (``/proc/meminfo``)."""
    kb = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in ("MemTotal", "MemAvailable"):
                kb[key] = int(rest.split()[0])
    return {"host_total_gb": kb.get("MemTotal", 0) * 1024 / 1e9,
            "host_available_gb": kb.get("MemAvailable", 0) * 1024 / 1e9}


def release_host_memory() -> None:
    """Collect unreferenced objects, then return the pinned blocks that
    PyTorch's host allocator keeps cached for reuse to the system (a freed
    pinned tensor stays in that cache, rounded up to a power of two)."""
    gc.collect()
    torch._C._host_emptyCache()


def host_free_bytes() -> int:
    """Host memory this process may still take: ``MemAvailable``, or less
    where its cgroup's limit leaves less."""
    free = meminfo()["host_available_gb"] * 1e9
    cg = Path("/sys/fs/cgroup")
    try:
        limit = (cg / "memory.max").read_text().strip()
        if limit != "max":
            free = min(free, int(limit) - int((cg / "memory.current").read_text()))
    except (OSError, ValueError):
        pass
    return int(free)


def fitting_depth(cfg, device, cap: int | None = None) -> dict:
    """The largest depth of ``cfg`` (at most its own, and at most ``cap``)
    at which ``big_faas`` fits: on the card a warm copy of the weights, a
    fork's copy and ``DEVICE_SLACK_BYTES`` within the free memory; on the
    host the function's checkpoint and its pinned pool (the weights'
    exact bytes, laid out at ``HOST_ALIGN``) plus ``HOST_SLACK_BYTES``
    within ``host_free_bytes()``; and on the card, earlier, the random
    draw's peak (the largest leaf in float32 and its cast).  Read with nothing
    of the model allocated; returns the depth, the budget that stopped it
    and the bytes it was worked out from."""
    from repro_torch.core.merging import host_layout
    from repro_torch.models.transformer import param_specs, torch_dtype
    from repro_torch.utils import named_leaves

    def sizes(n):
        leaves = [(p, t.numel() * t.element_size()) for p, t in
                  named_leaves(param_specs(cfg.replace(n_layers=n)))]
        return sum(b for _, b in leaves), host_layout(leaves)[1]

    (dev1, pin1), (dev2, pin2) = sizes(1), sizes(2)
    layer_dev, layer_pin = dev2 - dev1, pin2 - pin1
    base_dev, base_pin = dev1 - layer_dev, pin1 - layer_pin
    largest = max(t.numel() for _, t in named_leaves(param_specs(
        cfg.replace(n_layers=1))))
    draw_peak = largest * (4 + torch.empty((), dtype=torch_dtype(cfg.dtype))
                           .element_size())
    device_free = torch.cuda.mem_get_info(device)[0]
    host_free = host_free_bytes()
    by_device = int((device_free - DEVICE_SLACK_BYTES - 2 * base_dev)
                    // (2 * layer_dev))
    by_host = int((host_free - HOST_SLACK_BYTES - base_dev - base_pin)
                  // (layer_dev + layer_pin))
    if device_free - DEVICE_SLACK_BYTES < draw_peak:
        by_device = 0
    depth = min(cfg.n_layers, by_device, by_host, cap or cfg.n_layers)
    out = {"depth": depth, "cap": cap, "draw_peak_bytes": draw_peak,
           "limited_by": ("full depth" if depth == cfg.n_layers else
                          "the script's time limit" if depth == cap and cap < min(
                              by_device, by_host) else
                          "the device's memory" if by_device <= by_host
                          else "the host's memory"),
           "by_device": by_device, "by_host": by_host,
           "device_free_bytes": device_free, "host_free_bytes": host_free,
           "layer_bytes": layer_dev, "layer_pinned_bytes": layer_pin,
           "base_bytes": base_dev, "base_pinned_bytes": base_pin,
           "device_slack_bytes": DEVICE_SLACK_BYTES,
           "host_slack_bytes": HOST_SLACK_BYTES}
    print(json.dumps({"fitting_depth": out}))
    if depth < 1:
        raise AssertionError(f"{cfg.name}: not one layer fits: {out}")
    return out


def pinned_bytes(server) -> dict:
    """Page-locked host bytes: the pinned host allocator's held (cached
    blocks included) and handed out, by its own statistics, the bytes the
    template ``server``'s pools registered in place (``cudaHostRegister``,
    which those statistics do not see), and the sum of held and
    registered."""
    stats = torch.cuda.host_memory_stats()
    held = stats.get("allocated_bytes.current") or 0
    return {"pinned_held_bytes": held,
            "pinned_active_bytes": stats.get("active_bytes.current"),
            "registered_bytes": server.registered_bytes(),
            "pinned_bytes": held + server.registered_bytes()}


def big_model(arch: str, device, seed: int = 0, **replace) -> tuple:
    """``arch`` at full width (depth cut by ``replace``) with seeded random
    weights, drawn on the card leaf by leaf (a CPU draw of the 21-27 GB
    models took 54-90 s of the script's time limit)."""
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.utils import tree_bytes
    model = get_model(get_config(arch).replace(**replace), device=device)
    t0 = time.perf_counter()
    params = model.init_params(seed=seed, draw_on_device=True)
    torch.cuda.synchronize()
    info = {"arch": arch, "layers": model.cfg.n_layers,
            "d_model": model.cfg.d_model, "dtype": model.cfg.dtype,
            "init_s": time.perf_counter() - t0, "param_bytes": tree_bytes(params),
            **meminfo()}
    print(json.dumps({"model": info}))
    return model, params, info


def moe_drops(calls) -> dict:
    """The (token, k) pairs of the expert layer calls recorded by
    ``moe.watch()`` and those their capacity dropped, split by prefill
    (S > 1) and decode calls.  Reads back through host syncs, so passes
    watched are not timed."""
    out = {"prefill_dropped": 0, "prefill_pairs": 0, "decode_dropped": 0,
           "decode_pairs": 0}
    for S, _, keep in calls:
        kind = "decode" if S == 1 else "prefill"
        out[kind + "_dropped"] += int((~keep).sum())
        out[kind + "_pairs"] += keep.numel()
    return out


def card_drawn_host_params(cfg, device, seed: int = 1) -> dict:
    """Weights for ``cfg`` drawn on the card from ``seed`` and copied to
    the host.  A card-against-CPU check holds both sides to the same
    weights wherever they were drawn, and a CPU draw of one full-width
    fp32 layer is slow (deepseek-v3's with 32 experts took 22.2 s, PR
    25)."""
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import to_device
    params = get_model(cfg, device=device).init_params(seed=seed,
                                                       draw_on_device=True)
    host = to_device(params, "cpu")
    del params
    torch.cuda.empty_cache()
    return host


def card_cpu_parity(cfg, device, seed: int = 1, n_slots: int = 2,
                    chunk: int | None = None, cpu_params=None,
                    streamed: bool = True) -> dict:
    """``cfg`` (fp32, cut depth, full width): the same CPU-drawn weights on
    the card (kernels) and on the CPU (plain versions), through a paged
    pool of ``n_slots`` slots: a 100-token prefill (in ``chunk``-token
    pieces, the later ones through ``prefill_from``, when given) and 8
    greedy paged decode steps of one busy slot, logits within 1e-4 of the
    largest |logit| and tokens equal (moe: every call's expert ids and kept pairs equal; the free
    slots' rows take capacity too, so 8 slots at cf 1.25 drop pairs at
    decode); then the card's layer-streamed prefill of a forked session
    equals its monolithic prefill bit for bit (``streamed=False``: a
    later call over the same configuration and weights, which ran it
    already).  ``cpu_params``: weights for ``cfg`` already on the host
    (else drawn from ``seed`` by :func:`card_drawn_host_params`)."""
    from repro_torch.core import api as tidal
    from repro_torch.core.streaming import streamed_prefill
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import to_device
    from repro_torch.runtime import PagedKVCachePool
    from repro_torch.utils import named_leaves
    cpu_model = get_model(cfg, device="cpu")
    if cpu_params is None:
        cpu_params = card_drawn_host_params(cfg, device, seed)
    card_model = get_model(cfg, device=device)
    card_params = to_device(cpu_params, card_model.device)
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, 100).astype(np.int32)
    step = chunk or len(prompt)
    runs = {}
    for model, params in ((card_model, card_params), (cpu_model, cpu_params)):
        with moe.watch() as calls:
            pool = PagedKVCachePool(model, n_slots=n_slots, max_len=128,
                                    page_size=PAGE_SIZE)
            cache = model.make_cache(1, pool.padded_len)
            for start in range(0, len(prompt), step):
                piece = {"tokens": prompt[None, start:start + step]}
                if start:
                    logits, cache = model.prefill_from(params, piece, cache, start)
                else:
                    logits, cache = model.prefill(params, piece, cache)
            slot = pool.alloc(len(prompt), 8)
            pool.write_prompt(slot, cache, len(prompt))
            all_logits, toks = [logits[0].float().cpu()], [int(logits[0].argmax())]
            pos = np.zeros(n_slots, np.int32)
            pos[slot] = len(prompt)
            for _ in range(8):
                pool.ensure_len(slot, int(pos[slot]) + 1)
                tok = np.zeros((n_slots, 1), np.int32)
                tok[slot, 0] = toks[-1]
                lg, _ = model.decode_step_paged(params, pool.cache, {"tokens": tok},
                                                pos, pool.device_page_table(),
                                                PAGE_SIZE)
                all_logits.append(lg[slot].float().cpu())
                toks.append(int(lg[slot].argmax()))
                pos[slot] += 1
        routes = [(S, idx.cpu(), keep.cpu()) for S, idx, keep in calls]
        runs[model.device.type] = (torch.stack(all_logits), toks, routes)
    (lg_gpu, tk_gpu, rt_gpu), (lg_cpu, tk_cpu, rt_cpu) = runs["cuda"], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    tol = 1e-4 * float(lg_cpu.abs().max())
    res = {"config": f"{cfg.name} x {cfg.n_layers} layers, {cfg.dtype}",
           "n_slots": n_slots, "prefill_chunk": chunk,
           "max_abs_logit_err": err, "max_abs_logit": float(lg_cpu.abs().max()),
           "tol": tol, "tokens_equal": tk_gpu == tk_cpu,
           "moe_calls": len(rt_gpu),
           "routing_equal": len(rt_gpu) == len(rt_cpu) and all(
               s1 == s2 and torch.equal(i1, i2) and torch.equal(k1, k2)
               for (s1, i1, k1), (s2, i2, k2) in zip(rt_gpu, rt_cpu)),
           "drops_card": moe_drops(rt_gpu), "drops_cpu": moe_drops(rt_cpu)}
    del cpu_params, cpu_model
    if streamed:
        srv = TemplateServer(trace_seq=64)
        srv.register(tidal.static_function("f", card_model, card_params), {})
        session, _ = srv.fork("f", {})
        toks = prompt[None]
        lg_s, c_s = streamed_prefill(session, {"tokens": toks},
                                     card_model.make_cache(1, 128))
        lg_m, c_m = card_model.prefill(card_params, {"tokens": toks},
                                       card_model.make_cache(1, 128))
        torch.cuda.synchronize()
        res["streamed_prefill_equal"] = bool(torch.equal(lg_s, lg_m) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(c_s),
                                                        named_leaves(c_m))))
    print(json.dumps({"card_cpu_parity": res}))
    if not (err <= tol and res["tokens_equal"] and res["routing_equal"]
            and res["drops_card"] == res["drops_cpu"]
            and res.get("streamed_prefill_equal", not streamed)):
        raise AssertionError(f"card vs CPU parity failed: {res}")
    return res


def chunked_prefill_witness(model, params, prompt: np.ndarray,
                            chunk: int) -> dict:
    """A moe ``model`` whose capacity drops nothing: ``prompt`` prefilled
    whole and in ``chunk``-token pieces (``prefill_from``, as the engine's
    chunked prefill runs them).  Returns the last-token logits' largest
    difference, how many (token, layer) expert choices differ, and the
    pairs dropped (none: chunking then changes only the rounding)."""
    from repro_torch.models import moe
    L, runs = model.cfg.n_layers, []
    for step in (len(prompt), chunk):
        cache = model.make_cache(1, 512)
        with moe.watch() as calls:
            for start in range(0, len(prompt), step):
                piece = {"tokens": prompt[None, start:start + step]}
                if start:
                    logits, cache = model.prefill_from(params, piece, cache, start)
                else:
                    logits, cache = model.prefill(params, piece, cache)
        # calls run layer by layer within each piece
        routes = [torch.cat([calls[i][1] for i in range(layer, len(calls), L)])
                  for layer in range(L)]
        runs.append((logits[0].float(), routes, moe_drops(calls)))
    (lg_a, rt_a, dr_a), (lg_b, rt_b, dr_b) = runs
    out = {"config": f"{model.cfg.name} x {L} layers, {model.cfg.dtype}, cf "
                     f"{model.cfg.capacity_factor}",
           "prompt_len": len(prompt), "chunk": chunk,
           "max_abs_logit_diff": float((lg_a - lg_b).abs().max()),
           "max_abs_logit": float(lg_a.abs().max()),
           "routes_differ": sum(int((a != b).any(-1).sum())
                                for a, b in zip(rt_a, rt_b)),
           "routes": L * len(prompt),
           "pairs_dropped": dr_a["prefill_dropped"] + dr_b["prefill_dropped"]}
    print(json.dumps({"chunked_prefill_witness": out}))
    if out["pairs_dropped"]:
        raise AssertionError(f"the dropless witness dropped pairs: {out}")
    return out


def engine_vs_continuous(model, params, prompts: np.ndarray, new_tokens: int,
                         n_slots: int, per_prompt: bool) -> dict:
    """The sequential ``Engine`` (dense cache: flash prefill, then
    ``decode_attention``) against the paged continuous engine with
    ``n_slots`` slots over the same prompts: greedy tokens equal, launch
    counts exact.  ``per_prompt`` runs the Engine on one prompt at a time
    (a moe prefill then routes the same T tokens as the continuous
    engine's), else on the whole batch at once.  An MLA decode attends over
    every row of its cache, so the Engine's dense cache takes the paged
    pool's padded length (512): the same reduction, the same bits."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ContinuousBatchingEngine, Engine
    cfg, L = model.cfg, attention_kernels(model.cfg)
    n_norm, n_fused = norm_launches(cfg), fused_norm_launches(cfg)
    cache_len = 512 if cfg.use_mla else None
    eng = Engine(model, params)
    eng.generate(prompts[:1, :32], max_new_tokens=2)           # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if per_prompt:
        runs = [eng.generate(p[None], max_new_tokens=new_tokens,
                             cache_len=cache_len) for p in prompts]
        want = np.concatenate([r.tokens for r in runs])
        calls = len(prompts)
    else:
        runs = [eng.generate(prompts, max_new_tokens=new_tokens,
                             cache_len=cache_len)]
        want, calls = runs[0].tokens, 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect = {"decode_attention": L * (new_tokens - 1) * calls,
              "flash_attention": L * calls,
              "rmsnorm": n_norm * new_tokens * calls,
              "rmsnorm_fused": n_fused * new_tokens * calls,
              "paged_decode_attention": 0, "ssd_scan": 0, **NOT_LAUNCHED}
    if counts != expect:
        raise AssertionError(f"{cfg.name} Engine launches {counts} != {expect}")
    row = {"pass": "engine", "arch": cfg.name, "batch": len(prompts),
           "per_prompt": per_prompt, "prompt_len": int(prompts.shape[1]),
           "new_tokens": new_tokens, "launches": counts, "wall_s": wall,
           "ttft_ms": float(np.mean([r.ttft_s for r in runs]) * 1e3),
           "decode_ms_per_step": float(np.mean([r.decode_s for r in runs])
                                       / (new_tokens - 1) * 1e3)}
    cbe = ContinuousBatchingEngine(model, params, n_slots=n_slots, max_len=512,
                                   page_size=PAGE_SIZE)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids = [cbe.submit(p, new_tokens) for p in prompts]
    results = cbe.run()
    torch.cuda.synchronize()
    cont_wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    got = np.stack([results[i].tokens for i in ids])
    calls = cbe.n_decode_steps + cbe.n_prefill_calls
    expect = {"decode_attention": 0, "flash_attention": L * cbe.n_prefill_calls,
              "paged_decode_attention": L * cbe.n_decode_steps,
              "rmsnorm": n_norm * calls, "rmsnorm_fused": n_fused * calls,
              "ssd_scan": 0, **NOT_LAUNCHED}
    if counts != expect:
        raise AssertionError(f"{cfg.name} continuous launches {counts} != {expect}")
    equal = int((got == want).sum())
    row.update(continuous={"pass": "engine prompts, continuous", "arch": cfg.name,
                           "n_slots": n_slots, "launches": counts,
                           "wall_s": cont_wall,
                           "decode_steps": cbe.n_decode_steps,
                           "prefill_calls": cbe.n_prefill_calls},
               tokens_equal=f"{equal}/{want.size}")
    cbe.close()
    print(json.dumps(row))
    if equal != want.size:
        raise AssertionError(f"{cfg.name}: Engine tokens differ from the "
                             f"continuous engine's: {equal}/{want.size}")
    return row


def profiled_steps(calls: list) -> dict:
    """Run ``calls`` in order under ``torch.profiler``: their wall ms per
    call, the device ms per call and its share of the wall, and the
    kernels that took the most device time (ms and calls per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = len(calls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side events only: a CPU op reports the device time of the
    # kernels it launched as its own, so summing both counts it twice
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(((e.key, device_us(e) / 1e3 / n, e.count // n)
                  for e in events if device_us(e) > 0), key=lambda r: -r[1])
    return {"profiled_ms_per_step": wall / n * 1e3,
            "device_ms_per_step": device_ms / n if device_ms else None,
            "device_busy_share": device_ms / (wall * 1e3) if device_ms else None,
            "kernels_top_ms_per_step": [{"name": k[:100], "ms": ms, "calls": c}
                                        for k, ms, c in top[:12]]}


def decode_profile(model, params, prompts: list, steps: int = 8) -> dict:
    """The continuous engine's decode step at 8 busy slots: host ms per step
    (synchronised), then under ``torch.profiler`` the device time of
    ``steps`` steps and its share of their wall time, beside the step's
    byte bound (every weight but the embedding table read once, plus the
    K/V rows the step attends over: MLA's latent and rope-key rows; for
    a family on the dense slot pool (xlstm) its whole recurrent state,
    read once and written once)."""
    from repro_torch.models.transformer import kv_rows
    from repro_torch.runtime import ContinuousBatchingEngine
    from repro_torch.utils import tree_bytes
    cfg = model.cfg
    eng = ContinuousBatchingEngine(model, params, n_slots=8, max_len=512,
                                   page_size=PAGE_SIZE)
    for p in prompts[:8]:
        eng.submit(p, 2 * steps + 4)
    while eng.queue or eng.n_prefill_calls < len(prompts[:8]):
        eng.step()
    eng.step()
    host = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    rows = int(np.sum(eng._pos))                 # K/V rows of the next step
    state = 0 if model.supports_paged_kv else eng.pool.nbytes()
    prof = profiled_steps([eng.step] * steps)
    eng.close()
    elt = torch.empty((), dtype=model.dtype).element_size()
    embed = params["embed"]
    weights = tree_bytes(params) - embed.numel() * elt + 8 * cfg.d_model * elt
    if model.supports_paged_kv:
        row = sum(int(np.prod(r)) for r in kv_rows(cfg).values())
        kv = rows * cfg.n_layers * row * elt
    else:
        kv = 2 * state
    out = {"arch": cfg.name, "layers": cfg.n_layers, "slots": 8,
           "host_ms_per_step_median": float(np.median(host) * 1e3),
           "host_ms_per_step_min": float(np.min(host) * 1e3),
           **prof, "weight_bytes": weights, "kv_bytes": kv,
           "bound_ms": (weights + kv) / HBM_BYTES_PER_S * 1e3}
    print(json.dumps({"decode_step": out}))
    return out


def big_faas(model, params, h2d: float, lora_target=None, prompts=None,
             state_bytes: int = 0) -> dict:
    """``FaaSRuntime`` over a model of GBs with one function: a static one
    with the 131-token template prompt (without it when ``prompts`` are
    given: a recurrent family has no template prompt, and its prompts
    keep its chunk rule), or with ``lora_target`` a LoRA function (2
    adapters), served cold, warm, then forked after an evict (the LoRA one
    on the other adapter) and warm again, through the gateway.  The template server keeps no
    weights resident (``device_budget_bytes=0``): every fork streams the
    whole model, and the card holds the function's weights and one
    forked copy.  A fork's tokens equal the warm invocation's for the
    same prompt and event.  One function per runtime: a function holds
    its host checkpoint and its pinned pool, each the model's bytes.  The
    page-locked bytes after deploy must stay within 1.05 times the
    model's (the pool's exact size; a pool pinned leaf by leaf held 1.7
    times it for llama2-13b).  ``state_bytes``: the dense slot pool's
    recurrent state and the prewarm's copy of it, allowed at peak beside
    the weights."""
    from repro_torch.core import api as tidal
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.utils import tensor_nbytes
    prefix, reqs = serving_workload(model.cfg.vocab_size)
    if prompts is not None:
        prefix, reqs = None, prompts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt = FaaSRuntime(server=TemplateServer(hw=H100_SXM.with_h2d(h2d), trace_seq=128,
                                           device_budget_bytes=0),
                     n_slots=8, max_len=512, page_size=PAGE_SIZE,
                     device=model.device)
    t0 = time.perf_counter()
    a0, a1 = {"adapter": "adapter-0"}, {"adapter": "adapter-1"}
    if lora_target is None:
        name = "static"
        rt.deploy(tidal.static_function(name, model, params), {},
                  prewarm_seq=128, template_prompt=prefix)
        waves = [[(name, {}, 0)], [(name, {}, 1)], "evict", [(name, {}, 0)],
                 [(name, {}, 0)]]
    else:
        name = "lora"
        rt.deploy(tidal.lora_function(name, model, params, [lora_target],
                                      n_adapters=2), a0, prewarm_seq=128)
        waves = [[(name, a0, 3)], [(name, a0, 4)], "evict", [(name, a1, 3)],
                 [(name, a1, 3)]]
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    model_bytes = rt.server.templates[name].total_bytes
    pinned = {**pinned_bytes(rt.server), **meminfo(), "host_pool_bytes": sum(
        tensor_nbytes(t) for pool in rt.server.host_pool.values()
        for t in pool.values()), "host_buffer_bytes": sum(
        b.nbytes for b in rt.server.host_buffers.values())}
    view = next(iter(rt.server.host_pool[name].values()))
    pinned["pool_views_pinned"] = view.is_pinned()
    print(json.dumps({"after_deploy": {"arch": model.cfg.name, **pinned,
                                       "model_bytes": model_bytes}}))
    if not pinned["pool_views_pinned"] or pinned["pinned_bytes"] > 1.05 * model_bytes:
        raise AssertionError(f"{model.cfg.name}: {pinned['pinned_bytes']} bytes "
                             f"page-locked for {model_bytes} of weights: {pinned}")
    results = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for wave in waves:
        if wave == "evict":
            rt.evict()
            continue
        outs = rt.submit_many([(fn, ev, reqs[i], 16) for fn, ev, i in wave])
        results += [(fn, i, r) for (fn, _, i), r in zip(wave, outs)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    kinds = [r.kind for *_, r in results]
    want = ["cold", "warm", "fork", "warm"]
    if kinds != want:
        raise AssertionError(f"{model.cfg.name} service kinds {kinds} != {want}")
    if any(r.status != "done" or len(r.tokens) != 16 for *_, r in results):
        raise AssertionError(f"{model.cfg.name}: unfinished invocations")
    forked = [(fn, r) for fn, _, r in results if r.fork_stats is not None]
    for fn, r in forked:
        fs = r.fork_stats
        total = rt.server.templates[fn].total_bytes
        if not r.streamed_prefill or fs.reused_bytes or (
                fs.streamed_bytes + fs.dynamic_bytes != total):
            raise AssertionError(f"{fn} fork: streamed prefill {r.streamed_prefill}, "
                                 f"bytes {fs} != {total}")
    for j, (fn, i, r) in enumerate(results):
        if r.kind == "fork":        # the next invocation: the same one, warm
            fn2, i2, warm = results[j + 1]
            if (fn2, i2, warm.kind) != (fn, i, "warm") or not np.array_equal(
                    r.tokens, warm.tokens):
                raise AssertionError(f"{fn}: fork tokens != warm tokens")
    check_norm_launches(counts, model.cfg, f"{model.cfg.name} FaaS")
    if model.supports_paged_kv and not model.cfg.use_mla and (
            counts["paged_decode_attention"] == 0 or counts["flash_attention"] == 0
            or counts["decode_attention"] or counts["ssd_scan"]):
        raise AssertionError(f"{model.cfg.name} FaaS launches {counts}")
    peak = torch.cuda.max_memory_allocated()
    out = {"arch": model.cfg.name, "function": name, "lora_target": lora_target,
           "deploy_s": deploy_s, "model_bytes": model_bytes,
           "kinds": kinds, "wall_s": wall, "launches": counts,
           "ttft_ms": [{"fn": fn, "kind": r.kind, "ms": r.ttft_s * 1e3,
                        "reused_prefix_len": r.reused_prefix_len}
                       for fn, _, r in results],
           "fork_bytes": [{"fn": fn, "streamed": r.fork_stats.streamed_bytes,
                           "dynamic": r.fork_stats.dynamic_bytes,
                           "fork_s": r.fork_stats.fork_s} for fn, r in forked],
           "max_memory_allocated": peak,
           "max_memory_allocated_per_model_bytes": peak / model_bytes,
           "after_deploy": pinned}
    print(json.dumps({"faas": out}))
    rt.evict()
    del rt
    release_host_memory()
    # the function's weights plus one forked copy, and the arena (or the
    # recurrent state) and activations: a third copy would show here
    if peak >= 2.5 * model_bytes + state_bytes:
        raise AssertionError(f"{model.cfg.name}: {peak} bytes allocated at peak, "
                             f"more than 2 copies of {model_bytes} and "
                             f"{state_bytes} of state")
    return out


def phase_llama(device, h2d: float) -> dict:
    """llama2-13b at full width and ``LLAMA_LAYERS`` of its 40 layers
    (d_model 5120, 40 heads of 128 for queries and keys, bf16, 6.7 GB
    at 10 layers): the paged serving
    passes (bf16 and int8 arenas), the sequential Engine against the
    continuous engine, the decode step against its weight-byte bound,
    ``FaaSRuntime`` cold / warm / fork; then a 2-layer fp32 card against
    CPU check and streamed prefill."""
    from repro_torch.models.registry import get_config
    full = get_config("llama2-13b")
    model, params, info = big_model("llama2-13b", device,
                                    n_layers=LLAMA_LAYERS)
    cfg = model.cfg
    assert (full.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim) == (40, 5120, 40, 40, 128)
    info["reduced"] = f"n_layers {full.n_layers} -> {cfg.n_layers}"
    out = {"model": info}
    out["serve"], _ = phase_serve(model, params, passes=(
        ("paged", {}), ("int8", {"kv_dtype": "int8"})))
    prompts = np.random.default_rng(5).integers(1, cfg.vocab_size, (8, 256)
                                                ).astype(np.int32)
    out["engine"] = engine_vs_continuous(model, params, prompts, 32, 8,
                                         per_prompt=False)
    out["decode_step"] = decode_profile(model, params, list(prompts))
    out["faas"] = big_faas(model, params, h2d)
    del model, params
    torch.cuda.empty_cache()
    out["parity"] = card_cpu_parity(
        get_config("llama2-13b").replace(n_layers=2, dtype="float32"), device)
    return out


def phase_moe(device, h2d: float) -> dict:
    """phi3.5-moe-42b-a6.6b at full width (d_model 4096, 32 / 8 heads of
    128, 16 experts of 6400, top-2, capacity factor 1.25, bf16) and the
    largest depth that fits (``fitting_depth``): the paged serving passes
    at 8 slots (plain, chunked, int8), the (token, k) pairs their capacity
    drops, the plain and chunked passes again at cf = E/K (dropless) and a
    384-token prompt prefilled whole and in 64-token chunks there (fp32 at
    one layer: the same expert choices, logits within 1e-3), a 4-slot pass
    (decode dropless) equal to the sequential Engine, the decode step against its byte bound (every expert's weights
    are read), ``FaaSRuntime`` with a static and a LoRA function; then
    1-layer fp32 card against CPU checks (routing and drops equal) at 2
    slots, and at 8 slots with a chunked prefill (both drop pairs), and
    streamed prefill."""
    from repro_torch.models import moe
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.transformer import to_device
    full = get_config("phi3.5-moe-42b-a6.6b")
    fit = fitting_depth(full, device, cap=MOE_MAX_LAYERS)
    model, params, info = big_model("phi3.5-moe-42b-a6.6b", device,
                                    n_layers=fit["depth"])
    cfg = model.cfg
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.n_experts, cfg.top_k,
            cfg.moe_d_ff, cfg.capacity_factor) == (4096, 32, 8, 16, 2, 6400, 1.25)
    info["reduced"] = (f"n_layers {full.n_layers} -> {cfg.n_layers} "
                       f"({fit['limited_by']})")
    info["fitting_depth"] = fit
    print(f"phi3.5-moe-42b-a6.6b reduced: {info['reduced']} (full width; "
          f"{info['param_bytes'] / 1e9:.1f} GB of weights)")
    out = {"model": info}
    out["serve"], base = phase_serve(model, params)
    prefix, reqs = serving_workload(cfg.vocab_size)
    eng = serving_engine(model, params, prefix)
    with moe.watch() as calls:
        ids = [eng.submit(p, 16) for p in reqs]
        results = eng.run()
    eng.close()
    same = sum(int((results[i].tokens == t).sum()) for i, t in zip(ids, base))
    drops = moe_drops(calls)
    drops["tokens_equal_to_plain_pass"] = f"{same}/{16 * len(base)}"
    print(json.dumps({"moe_drops_8_slots": drops}))
    if same != 16 * len(base) or not drops["decode_dropped"]:
        raise AssertionError(f"8-slot drop count pass: {drops}")
    out["drops_8_slots"] = drops
    # the chunked pass without drops (cf = E/K): the tokens it shares
    # with the plain pass, and one prompt prefilled whole and in chunks
    dropless_cf = cfg.n_experts / cfg.top_k
    dropless = get_model(cfg.replace(capacity_factor=dropless_cf), device=device)
    with moe.watch() as calls:
        out["serve_dropless"], _ = phase_serve(dropless, params,
                                               passes=SERVE_PASSES[:2])
    out["serve_dropless_drops"] = moe_drops(calls)
    if out["serve_dropless_drops"]["decode_dropped"] or (
            out["serve_dropless_drops"]["prefill_dropped"]):
        raise AssertionError(f"cf = E/K dropped pairs: {out['serve_dropless_drops']}")
    witness_prompt = np.random.default_rng(8).integers(1, cfg.vocab_size, 384
                                                       ).astype(np.int32)
    out["chunked_witness"] = [chunked_prefill_witness(dropless, params,
                                                      witness_prompt, 64)]
    prompts = np.random.default_rng(6).integers(1, cfg.vocab_size, (4, 256)
                                                ).astype(np.int32)
    with moe.watch() as calls:
        out["engine"] = engine_vs_continuous(model, params, prompts, 16, 4,
                                             per_prompt=True)
    out["engine"]["drops"] = moe_drops(calls)
    if out["engine"]["drops"]["decode_dropped"]:
        raise AssertionError(f"4-slot decode dropped pairs: {out['engine']['drops']}")
    dec_prompts = np.random.default_rng(7).integers(1, cfg.vocab_size, (8, 256))
    out["decode_step"] = decode_profile(model, params,
                                        list(dec_prompts.astype(np.int32)))
    out["faas"] = big_faas(model, params, h2d)
    out["faas_lora"] = big_faas(model, params, h2d, lora_target="blocks.attn.wq")
    del model, params, dropless
    torch.cuda.empty_cache()
    small = full.replace(n_layers=1, dtype="float32")
    # chunking on the card at fp32 changes no expert choice and moves the
    # logits by rounding only; the same weights in bf16 are printed beside
    one = get_model(small.replace(capacity_factor=dropless_cf), device=device)
    one_params = one.init_params(seed=1, draw_on_device=True)
    fp32 = chunked_prefill_witness(one, one_params, witness_prompt, 64)
    one_bf16 = get_model(one.cfg.replace(dtype="bfloat16"), device=device)
    out["chunked_witness"] += [fp32, chunked_prefill_witness(
        one_bf16, to_device(one_params, device, torch.bfloat16), witness_prompt, 64)]
    del one, one_params, one_bf16
    if fp32["routes_differ"] or fp32["max_abs_logit_diff"] > 1e-3:
        raise AssertionError(f"chunked prefill differs from the whole prefill: {fp32}")
    cpu_params = card_drawn_host_params(small, device)
    out["parity"] = card_cpu_parity(small, device, cpu_params=cpu_params)
    out["parity_8_slots"] = card_cpu_parity(small, device, n_slots=8, chunk=48,
                                            streamed=False,
                                            cpu_params=cpu_params)
    got = out["parity_8_slots"]["drops_card"]
    if not (got["decode_dropped"] and got["prefill_dropped"]):
        raise AssertionError(f"the 8-slot, chunked card against CPU check "
                             f"dropped no pairs: {got}")
    return out


def latent_arena_bytes(model) -> dict:
    """Bytes per token per layer of the latent paged arena (bf16 and int8
    with its scales), beside a GQA cache's at the model's heads (K and V,
    ``n_heads`` of ``v_head_dim``, bf16)."""
    from repro_torch.runtime import PagedKVCachePool
    cfg, out = model.cfg, {}
    for kv_dtype in (None, "int8"):
        pool = PagedKVCachePool(model, n_slots=1, max_len=PAGE_SIZE,
                                page_size=PAGE_SIZE, kv_dtype=kv_dtype)
        out[kv_dtype or str(model.dtype)[6:]] = pool.page_nbytes() / (
            PAGE_SIZE * cfg.n_layers)
        del pool
    elt = torch.empty((), dtype=model.dtype).element_size()
    out["gqa_same_heads"] = 2 * cfg.n_heads * cfg.v_head_dim * elt
    out["gqa_over_latent"] = out["gqa_same_heads"] / out[str(model.dtype)[6:]]
    print(json.dumps({"latent_arena_bytes_per_token_per_layer": out}))
    row = cfg.kv_lora_rank + cfg.qk_rope_dim
    if (out[str(model.dtype)[6:]], out["int8"]) != (row * elt, row + 8):
        raise AssertionError(f"latent arena bytes {out}, rows of {row}")
    return out


def phase_deepseek(device) -> dict:
    """deepseek-v3-671b at full width (d_model 7168, 128 heads; MLA ranks
    1536 / 512, dims 128 / 64 / 128; 256 experts of 2048, top-8, one
    shared expert; capacity factor 1.25; vocabulary 129,280; bf16) at the
    depth ``fitting_depth`` works out (one of 61 layers is 23 GB): the
    paged serving passes at 8 slots (plain, chunked, int8) over the latent
    arena, the (token, k) pairs the capacity drops (an untimed pass), a
    dropless (cf = E/K) 8-slot pass equal to the sequential ``Engine`` run
    prompt by prompt, the arena's bytes per token, the decode step beside
    its byte bound (no ``FaaSRuntime`` pass: phase 15 serves deepseek-v3
    through it at tp = 2); then 1-layer fp32 card against CPU checks with the experts
    cut to 32 (logits within 1e-4 of the largest, routing and kept pairs
    equal) at 2 slots and at 8 slots with a 48-token chunked prefill, and
    streamed prefill equal to prefill.  No attention kernel runs (MLA
    attends in PyTorch ops); rmsnorm launches 4L+1 per model call."""
    from repro_torch.models import moe
    from repro_torch.models.registry import get_config, get_model
    full = get_config("deepseek-v3-671b")
    fit = fitting_depth(full, device)
    model, params, info = big_model("deepseek-v3-671b", device,
                                    n_layers=fit["depth"])
    cfg = model.cfg
    assert (cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
            cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.n_experts,
            cfg.top_k, cfg.n_shared_experts, cfg.moe_d_ff, cfg.vocab_size,
            cfg.capacity_factor) == (7168, 128, 1536, 512, 128, 64, 128, 256,
                                     8, 1, 2048, 129280, 1.25)
    info["reduced"] = (f"n_layers {full.n_layers} -> {cfg.n_layers} "
                       f"({fit['limited_by']})")
    info["fitting_depth"] = fit
    print(f"deepseek-v3-671b reduced: {info['reduced']} (full width; "
          f"{info['param_bytes'] / 1e9:.1f} GB of weights)")
    out = {"model": info}
    out["serve"], base = phase_serve(model, params)
    prefix, reqs = serving_workload(cfg.vocab_size)
    eng = serving_engine(model, params, prefix)
    with moe.watch() as calls:
        ids = [eng.submit(p, 16) for p in reqs]
        results = eng.run()
    eng.close()
    same = sum(int((results[i].tokens == t).sum()) for i, t in zip(ids, base))
    drops = moe_drops(calls)
    drops["tokens_equal_to_plain_pass"] = f"{same}/{16 * len(base)}"
    print(json.dumps({"moe_drops_8_slots": {"arch": cfg.name, **drops}}))
    if same != 16 * len(base):
        raise AssertionError(f"the drop count pass differs from the plain pass: {drops}")
    out["drops_8_slots"] = drops
    dropless = get_model(cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k),
                         device=device)
    prompts = np.random.default_rng(6).integers(1, cfg.vocab_size, (8, 256)
                                                ).astype(np.int32)
    with moe.watch() as calls:
        out["engine"] = engine_vs_continuous(dropless, params, prompts, 16, 8,
                                             per_prompt=True)
    out["engine"]["drops"] = moe_drops(calls)
    if out["engine"]["drops"]["decode_dropped"] or (
            out["engine"]["drops"]["prefill_dropped"]):
        raise AssertionError(f"cf = E/K dropped pairs: {out['engine']['drops']}")
    out["arena"] = latent_arena_bytes(model)
    dec_prompts = np.random.default_rng(7).integers(1, cfg.vocab_size, (8, 256))
    out["decode_step"] = decode_profile(model, params,
                                        list(dec_prompts.astype(np.int32)))
    del model, params, dropless
    torch.cuda.empty_cache()
    release_host_memory()
    small = full.replace(n_layers=1, dtype="float32",
                         n_experts=DEEPSEEK_PARITY_EXPERTS)
    print(f"deepseek-v3-671b parity reduced: n_layers {full.n_layers} -> 1, "
          f"n_experts {full.n_experts} -> {DEEPSEEK_PARITY_EXPERTS} (fp32 on the "
          f"card and on the CPU; every other width the config's)")
    cpu_params = card_drawn_host_params(small, device)
    out["parity"] = card_cpu_parity(small, device, cpu_params=cpu_params)
    out["parity_8_slots"] = card_cpu_parity(small, device, n_slots=8, chunk=48,
                                            streamed=False,
                                            cpu_params=cpu_params)
    return out


# ---------------------------------------------------------------------------
# phase 12: xlstm-1.3b at full width and depth
# ---------------------------------------------------------------------------

# xLSTM's rows: the block norms at d_model 2048 and the mLSTM inner norm
# at d_inner 4096, at decode (8 slots) and at a 512-token prefill
XLSTM_RMSNORM_CASES = (("xlstm-decode", (8, 1, 2048)),
                       ("xlstm-inner-decode", (8, 1, 4096)),
                       ("xlstm-prefill", (512, 2048)),
                       ("xlstm-inner-prefill", (512, 4096)))
# prompt lengths the reference's chunked mLSTM takes at ssm_chunk 128: at
# most one chunk, or a multiple of it
XLSTM_LENGTHS = (32, 64, 96, 128, 256, 384, 512)
# phase 12's depth, one unit of slstm_every = 8 layers: the whole script
# keeps to its time limit (at 48 layers the phase took 84-123 s of a
# script that reached 1,165.8 s of its 1,200 on a slow host; at 16, 42.0
# s of one that read 1,252.4 s with phase 17's training cases)
XLSTM_LAYERS = 8


def xlstm_prefill_timing(model, params, S: int = 512, reps: int = 3) -> dict:
    """One S-token prefill: its wall ms (synchronised) and the ms until
    the call returned to the host (median of ``reps``); then one run with
    the card synchronised around each sLSTM mixer, whose time loop runs S
    steps of ~15 ops per sLSTM block, for that loop's share of the wall."""
    from repro_torch.models import ssm
    toks = np.random.default_rng(21).integers(1, model.cfg.vocab_size, (1, S)
                                              ).astype(np.int32)

    def run():
        cache = model.make_cache(1, S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache)
        t_call = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t_call, time.perf_counter() - t0

    run()                                                  # warm-up
    calls, walls = zip(*[run() for _ in range(reps)])
    mixer, spent = ssm.slstm_mixer, []

    def timed_slstm(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = mixer(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    ssm.slstm_mixer = timed_slstm
    try:
        _, wall_i = run()
    finally:
        ssm.slstm_mixer = mixer
    out = {"prompt_len": S, "wall_ms_median": float(np.median(walls) * 1e3),
           "host_ms_median": float(np.median(calls) * 1e3),
           "instrumented_wall_ms": wall_i * 1e3,
           "slstm_ms": float(np.sum(spent) * 1e3), "slstm_calls": len(spent),
           "slstm_share": float(np.sum(spent) / wall_i)}
    print(json.dumps({"xlstm_prefill": out}))
    return out


def xlstm_parity(device) -> dict:
    """A 2-layer fp32 xlstm-1.3b at full width (``slstm_every`` 2: one
    mLSTM and one sLSTM block): ``recurrent_parity`` on two 256-token
    prompts (two mLSTM chunks), logits within 1e-4 of the largest."""
    from repro_torch.models.registry import get_config
    cfg = get_config("xlstm-1.3b").replace(n_layers=2, slstm_every=2,
                                           dtype="float32")
    print("xlstm-1.3b parity reduced: n_layers 48 -> 2, slstm_every 8 -> 2 "
          "(fp32 on the card and on the CPU; every width the config's)")
    prompts = np.random.default_rng(22).integers(1, cfg.vocab_size, (2, 256)
                                                 ).astype(np.int32)
    return recurrent_parity(cfg, device, prompts, lambda m: 1e-4 * m, "xlstm",
                            128)


def phase_xlstm(device, h2d: float) -> dict:
    """xlstm-1.3b at full width, ``XLSTM_LAYERS`` of its 48 layers (7
    mLSTM and 1 sLSTM block, printed as reduced; d_model 2048, 4 heads,
    mLSTM head dim 1024, chunk 128, bf16, seeded random weights drawn leaf
    by leaf): rmsnorm at xLSTM's rows, the dense-pool continuous engine (8
    slots, 12 requests), the sequential Engine (8 x 256 + 32) with the
    continuous engine's tokens equal to it, exact launch counts (rmsnorm 18
    per model call, 1 fused; no attention kernel, no ``ssd_scan``), the decode step at 8
    busy slots beside its byte bound (weights, and the recurrent state read
    and written), a 512-token prefill and its sLSTM loop's share,
    ``FaaSRuntime`` cold / warm / fork of a static function (a fork
    streams the whole model), the peak allocation; then a 2-layer fp32
    card against CPU check and streamed prefill equal to prefill."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import make_cache
    from repro_torch.runtime import Engine
    from repro_torch.utils import tree_bytes
    gen = torch.Generator().manual_seed(12)
    rows = []
    for tag, shape in XLSTM_RMSNORM_CASES:
        rows += rmsnorm_case(device, gen, tag, shape, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    model, params, info = big_model("xlstm-1.3b", device, n_layers=XLSTM_LAYERS)
    cfg = model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.slstm_every,
            cfg.mlstm_proj_factor, cfg.ssm_chunk, cfg.conv_width,
            cfg.vocab_size) == (8, 2048, 4, 8, 2.0, 128, 4, 50304)
    info["reduced"] = "n_layers 48 -> 8 (the script's time limit)"
    print(f"xlstm-1.3b reduced: {info['reduced']} (full width; "
          f"{info['param_bytes'] / 1e9:.2f} GB of weights)")
    per_call = (norm_launches(cfg), fused_norm_launches(cfg))
    if per_call != (18, 1):
        raise AssertionError(f"xlstm-1.3b rmsnorm launches per call {per_call}")
    slot_bytes = tree_bytes(make_cache(cfg, 1, 512, device="meta"))
    out = {"model": info, "kernels": rows, "rmsnorm_per_call": per_call,
           "state_bytes_per_slot": slot_bytes}
    rng = np.random.default_rng(20)
    lengths = list(XLSTM_LENGTHS) + list(rng.choice(XLSTM_LENGTHS, 5))
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths]
    dense_continuous(model, params, prompts[:2], 2, "xlstm warm-up", 1024)
    out["serve"], _ = dense_continuous(model, params, prompts, 16,
                                       "xlstm dense pool", 1024)

    batch = np.random.default_rng(23).integers(1, cfg.vocab_size, (8, 256)
                                               ).astype(np.int32)
    eng = Engine(model, params)
    eng.generate(batch[:, :32], max_new_tokens=2)             # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(batch, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    # the Engine's batch of 8 prefills one sequence at a time (8 calls),
    # then 31 decode steps of the batch
    check_xlstm_launches(counts, cfg, 8 + 31, "xlstm Engine")
    cont, cont_tokens = dense_continuous(model, params, list(batch), 32,
                                         "xlstm dense pool, Engine's prompts")
    equal = sum(int((res.tokens[i] == t).sum()) for i, t in enumerate(cont_tokens))
    engine = {"pass": "xlstm engine", "batch": 8, "prompt_len": 256,
              "new_tokens": 32, "launches": counts, "wall_s": wall,
              "ttft_ms": res.ttft_s * 1e3,
              "decode_ms_per_step": res.decode_s / 31 * 1e3,
              "tokens_per_s": 8 * 32 / wall,
              "tokens_equal_to_continuous": f"{equal}/{8 * 32}"}
    print(json.dumps(engine))
    if equal != 8 * 32:
        raise AssertionError(f"xlstm Engine tokens differ from the continuous "
                             f"engine's: {equal}/{8 * 32}")
    out["engine"], out["engine_prompts_continuous"] = engine, cont
    out["decode_step"] = decode_profile(model, params, list(batch))
    out["prefill_512"] = xlstm_prefill_timing(model, params)
    peak = {"serving_max_memory_allocated": torch.cuda.max_memory_allocated(),
            "param_bytes": info["param_bytes"],
            "pool_state_bytes_8_slots": 8 * slot_bytes}
    faas_prompts = [prompts[i] for i in (3, 4, 5, 1, 2)]      # 128, 256, 384, ...
    out["faas"] = big_faas(model, params, h2d, prompts=faas_prompts,
                           state_bytes=9 * slot_bytes)
    out["peak"] = peak = {**peak, "faas_max_memory_allocated":
                          out["faas"]["max_memory_allocated"]}
    print(json.dumps({"xlstm_peak": peak}))
    del model, params, eng
    torch.cuda.empty_cache()
    out["parity"] = xlstm_parity(device)
    return out


# whisper-medium's attention heads (16 / 16 / 64, G = 1) and serving shape
WHISPER = dict(H=16, KV=16, d=64)
WHISPER_FRAMES = 1500            # the 30 s window
WHISPER_BATCH = 8
WHISPER_PROMPT = 4
WHISPER_NEW = 444                # prompt + 444 - 1 = 447 of 448 decoder rows
# the batch's sequences run alone against it (printed, not asserted): the
# first and the last (all eight took 10 s of the script's time limit)
WHISPER_ALONE = (0, WHISPER_BATCH - 1)


def whisper_kernel_cases(device) -> list:
    """The attention kernels at whisper-medium's heads, bf16 and fp32,
    each against its plain version, timed beside SDPA and the bound:
    flash non-causal at B = 8 over 1,500 keys with S = 1,500 (the encoder)
    and S = 4 (cross-attention of a 4-token prompt), flash causal at S = T
    = 64 (decoder self-attention), decode at B = 8 over 1,500 rows at one
    length (cross) and over 448 rows at per-sequence lengths (self)."""
    gen = torch.Generator().manual_seed(13)
    rng = np.random.default_rng(13)
    T, B = WHISPER_FRAMES, WHISPER_BATCH
    self_lengths = rng.integers(1, 449, B).tolist()
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for S, Tk, causal in ((T, T, False), (WHISPER_PROMPT, T, False),
                              (64, 64, True)):
            rows.append(flash_case(device, gen, "whisper-medium", WHISPER, B,
                                   S, Tk, dtype, 0.0, causal))
        rows.append(decode_case(device, gen, "cross", "whisper-medium",
                                WHISPER, T, [T] * B, dtype))
        rows.append(decode_case(device, gen, "self", "whisper-medium",
                                WHISPER, 448, self_lengths, dtype))
    return rows


def whisper_step_bytes(params, cfg, B: int, T: int, positions) -> dict:
    """Bytes one decode step must move at each of ``positions``, averaged:
    every decoder layer's weights but the cross K/V projections (``wk``,
    ``wv``, ``bv``: the prefill applied them), the final norm, the tied
    head (the whole embedding table), B embedding rows and one position
    row; the cross K/V (B x Ld x T rows of K and V); the self K/V rows 0
    .. pos read and row pos written; the logits written.  No encoder
    weight."""
    from repro_torch.utils import named_leaves, tensor_nbytes
    elt = torch.empty((), dtype=params["embed"].dtype).element_size()
    D, Ld = cfg.d_model, cfg.dec_layers
    weights = sum(tensor_nbytes(t) for path, t in named_leaves(params["dec_layers"])
                  if path.split(".", 1)[1] not in ("cross_attn.wk", "cross_attn.wv",
                                                   "cross_attn.bv"))
    weights += (sum(tensor_nbytes(t) for _, t in named_leaves(params["dec_ln"]))
                + tensor_nbytes(params["embed"]) + (B + 1) * D * elt)
    row = 2 * cfg.n_heads * cfg.head_dim * elt          # one K and one V row
    cross = B * Ld * T * row
    self_kv = float(np.mean([B * Ld * (p + 2) * row for p in positions]))
    logits = B * cfg.vocab_size * elt
    total = weights + cross + self_kv + logits
    return {"weight_bytes": weights, "cross_kv_bytes": cross,
            "self_kv_bytes": self_kv, "logit_bytes": logits,
            "total_bytes": total,
            "bound_ms": total / HBM_BYTES_PER_S * 1e3}


def whisper_decode_profile(model, params, cache, steps: int = 8) -> dict:
    """Decode steps of the batch over a filled cache (the ``Engine``
    run's, positions 429 to 446): host ms per step (synchronised), then
    under ``torch.profiler`` the device time of ``steps`` steps and its
    share of their wall time, beside the byte bound."""
    cfg = model.cfg
    B = cache["self_kv"]["k"].shape[1]
    T = cache["cross_kv"]["k"].shape[2]
    toks = torch.ones((B, 1), dtype=torch.int32, device=model.device)
    pos0 = cfg.max_dec_len - 2 - (2 * steps + 2) + 1
    model.decode_step(params, cache, {"tokens": toks}, pos0)        # warm-up
    model.decode_step(params, cache, {"tokens": toks}, pos0 + 1)
    host = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(params, cache, {"tokens": toks}, pos0 + 2 + i)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    positions = [pos0 + 2 + steps + i for i in range(steps)]
    prof = profiled_steps([
        lambda p=p: model.decode_step(params, cache, {"tokens": toks}, p)
        for p in positions])
    out = {"arch": cfg.name, "batch": B, "positions": [positions[0], positions[-1]],
           "host_ms_per_step_median": float(np.median(host) * 1e3), **prof,
           **whisper_step_bytes(params, cfg, B, T, positions)}
    print(json.dumps({"whisper_decode_step": out}))
    return out


def whisper_parity(device) -> dict:
    """A 2 + 2-layer fp32 whisper-medium at full width: the same seeded
    weights on the card (kernels) and on the CPU (plain versions), 1,500
    frames and 4-token prompts at B = 2, then 15 greedy decode steps
    through the ``Engine``: logits within 1e-4 of the largest |logit|,
    tokens equal over the 16."""
    from repro_torch.data.pipeline import make_frames
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.runtime import Engine
    cfg = get_config("whisper-medium").replace(n_layers=2, dec_layers=2,
                                               dtype="float32")
    print("whisper-medium parity reduced: n_layers 24 -> 2, dec_layers 24 -> "
          "2 (fp32 on the card and on the CPU; every width the config's)")
    frames = make_frames(cfg.d_model, 2, WHISPER_FRAMES, seed=31)
    prompts = np.random.default_rng(31).integers(1, cfg.vocab_size, (2, 4)
                                                 ).astype(np.int32)
    runs = {}
    for dev in (device, "cpu"):
        model = get_model(cfg, device=dev)
        logits = []

        def prefill(p, inputs, cache, m=model, out=logits):
            lg, cache = m.prefill(p, inputs, cache)
            out.append(lg.float().cpu())
            return lg, cache

        def decode(p, cache, inputs, pos, m=model, out=logits):
            lg, cache = m.decode_step(p, cache, inputs, pos)
            out.append(lg.float().cpu())
            return lg, cache

        res = Engine(model, model.init_params(seed=1), prefill, decode
                     ).generate(prompts, max_new_tokens=16, frames=frames)
        runs[str(dev)] = (torch.stack(logits), res.tokens)
    (lg_gpu, tk_gpu), (lg_cpu, tk_cpu) = runs[str(device)], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    big = float(lg_cpu.abs().max())
    out = {"config": f"{cfg.name} x {cfg.n_layers} + {cfg.dec_layers} layers, "
           f"{cfg.dtype}", "frames": WHISPER_FRAMES, "steps": 16,
           "max_abs_logit_err": err, "max_abs_logit": big, "tol": 1e-4 * big,
           "tokens_equal": bool((tk_gpu == tk_cpu).all()),
           "tokens_card": tk_gpu.tolist()}
    print(json.dumps({"whisper_parity": out}))
    if not err <= out["tol"] or not out["tokens_equal"]:
        raise AssertionError(f"whisper card vs CPU parity failed: {out}")
    return out


def check_whisper_launches(counts: dict, cfg, prefills: int, steps: int,
                           where: str) -> None:
    """Exact launches: 3 flash per decoder layer pair per prefill (encoder,
    decoder self, cross), 2 ``decode_attention`` per decoder layer per
    step, and nothing else."""
    want = {"flash_attention": prefills * (cfg.n_layers + 2 * cfg.dec_layers),
            "decode_attention": steps * 2 * cfg.dec_layers,
            "paged_decode_attention": 0, "rmsnorm": 0, "rmsnorm_fused": 0,
            "ssd_scan": 0, **NOT_LAUNCHED}
    if counts != want:
        raise AssertionError(f"{where}: launches {counts}, want {want}")


def phase_whisper(device) -> dict:
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, d_model 1024, 16 heads of 64, d_ff 4096, vocabulary 51,865,
    tied head, 448 decoder positions; bf16, seeded random weights): the
    attention kernels at its shapes, then ``Engine.generate(frames=)`` at
    8 sequences over 1,500 frames with 4-token prompts and 444 new tokens
    (exact launches: 72 flash per prefill, 48 ``decode_attention`` per
    step, no other kernel), the first and last sequence alone against
    the batch (32 tokens, information only), the decode step beside its
    byte bound,
    the peak allocation, ``ContinuousBatchingEngine`` refusing the model,
    then a 2 + 2-layer fp32 card against CPU check."""
    from repro_torch.data.pipeline import make_frames
    from repro_torch.kernels import ops
    from repro_torch.runtime import ContinuousBatchingEngine, Engine
    rows = whisper_kernel_cases(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, params, info = big_model("whisper-medium", device)
    cfg = model.cfg
    assert (cfg.n_layers, cfg.dec_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.max_dec_len) == (
        24, 24, 1024, 16, 64, 4096, 51865, 448)
    B, S, new = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW
    frames = make_frames(cfg.d_model, B, WHISPER_FRAMES, seed=30)
    prompts = np.random.default_rng(30).integers(1, cfg.vocab_size, (B, S)
                                                 ).astype(np.int32)
    kept = {}

    def decode(p, cache, inputs, pos):
        kept["cache"] = cache
        return model.decode_step(p, cache, inputs, pos)

    eng = Engine(model, params, decode_fn=decode)
    eng.generate(prompts, max_new_tokens=2, frames=frames)          # warm-up
    torch.cuda.synchronize()
    stamps = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=new, frames=frames,
                       on_token=lambda toks, i: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_whisper_launches(counts, cfg, 1, new - 1, "whisper Engine")
    peak = torch.cuda.max_memory_allocated()
    engine = {"pass": "whisper engine", "batch": B, "frames": WHISPER_FRAMES,
              "prompt_len": S, "new_tokens": new, "launches": counts,
              "wall_s": wall, "ttft_ms": res.ttft_s * 1e3,
              "decode_ms_per_step_median": float(np.median(np.diff(stamps)) * 1e3),
              "decode_ms_per_step_mean": res.decode_s / (new - 1) * 1e3,
              "tokens_per_s": B * new / wall,
              "max_memory_allocated": peak, "param_bytes": info["param_bytes"]}
    print(json.dumps(engine))
    alone = []
    for b in WHISPER_ALONE:
        one = Engine(model, params).generate(prompts[b:b + 1], max_new_tokens=32,
                                             frames=frames[b:b + 1])
        alone.append(bool((one.tokens[0] == res.tokens[b, :32]).all()))
    engine["alone_equal_to_batch_32_tokens"] = (
        f"{sum(alone)}/{len(WHISPER_ALONE)}")
    print(json.dumps({"whisper_alone_vs_batch": engine[
        "alone_equal_to_batch_32_tokens"], "per_sequence": alone}))
    out = {"model": info, "kernels": rows, "engine": engine,
           "decode_step": whisper_decode_profile(model, params, kept["cache"])}
    try:
        ContinuousBatchingEngine(model, params)
    except NotImplementedError as e:
        out["continuous_refused"] = str(e)
    else:
        raise AssertionError("ContinuousBatchingEngine took an enc-dec model")
    del model, params, eng, kept
    torch.cuda.empty_cache()
    out["parity"] = whisper_parity(device)
    return out


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

PHI_MOE = dict(H=32, KV=8, d=128)
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 3
# zamba2-2.7b through the CLI: steps of train(), then steps on one batch
# at a smaller lr: at the CLI's 3e-4 the random 54-block model's loss rose
# after its first step (10.89, 15.04, 11.32 over the stream's batches,
# then 9.61 to 10.32 over one batch; H100)
ZAMBA_TRAIN_STEPS, ZAMBA_REPEAT_STEPS, ZAMBA_REPEAT_LR = 3, 4, 1e-5


def time_grad_ms(forward, inputs: tuple, grad_out, reps: int = 20,
                 graph_calls: int = 10) -> float:
    """Mean device time in ms of one ``torch.autograd.grad`` of
    ``forward(*inputs)`` with respect to ``inputs`` (a library operator's
    backward, timed as ``time_ms`` times a kernel).  The forward is
    captured into one CUDA graph and ``graph_calls`` backward calls into
    a second one in the same pool, as ``torch.cuda.make_graphed_callables``
    does, so the backward runs on the capture stream; the backward graph
    is replayed ``reps`` times between CUDA events, and host launch
    overhead is not in the number."""
    side = warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            torch.autograd.grad(forward(*inputs), inputs, grad_out)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(fwd):
        out = forward(*inputs)
    with torch.cuda.graph(bwd, pool=fwd.pool()):
        for _ in range(graph_calls):
            torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
    fwd.replay()
    bwd.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        bwd.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * graph_calls)


def max_rel(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def flash_bwd_case(device, gen, tag, hd, B, S, T, causal=True,
                   softcap=0.0) -> dict:
    """``flash_attention_bwd`` (fp32) against its plain version on the
    card, from the forward kernel's output and log-sum-exp; timed beside
    the plain version, the backward of SDPA through ``autograd.grad``
    under a CUDA graph (none with a softcap) and the bound: 2.5 times the forward's FLOPs at
    the fp32 peak, or q, k, v, o, dO and the lse read and dq, dk, dv
    written once over HBM's rate.  Tolerance 1e-4 of the largest |grad|
    of each of dq, dk and dv."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_launch, _lse_like,
                                                     flash_attention_bwd)
    H, KV, d = hd["H"], hd["KV"], hd["d"]
    f32 = torch.float32
    q = torch.randn((B, S, H, d), generator=gen).to(device).transpose(1, 2)
    k = torch.randn((B, T, KV, d), generator=gen).to(device).transpose(1, 2)
    v = torch.randn((B, T, KV, d), generator=gen).to(device).transpose(1, 2)
    do = torch.randn((B, S, H, d), generator=gen).to(device).transpose(1, 2)
    lse = _lse_like(q)
    o = _launch(q, k, v, causal, softcap, lse)
    o_ref, lse_ref = ref.flash_attention_fwd_ref(q, k, v, causal, softcap)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, softcap)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal, softcap)
    want = ref.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal,
                                       softcap)
    torch.cuda.synchronize()
    errs = {n: max_rel(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    big = B * H * S * T > 2e8
    reps, calls = (3, 2) if big else (20, 10)
    kern_ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal,
                                                  softcap), reps, calls)
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o_ref, lse_ref, do, causal, softcap), reps, calls)
    lib_ms = None
    if softcap == 0.0:
        lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        mask = (torch.arange(T, device=device)[None, :]
                <= torch.arange(S, device=device)[:, None] + (T - S))
        lib_kw = ({} if not causal else {"is_causal": True} if S == T
                  else {"attn_mask": mask})
        lib_ms = time_grad_ms(lambda a, b, c: sdpa_gqa(a, b, c, **lib_kw),
                              (lq, lk, lv), do, reps, calls)
        del lq, lk, lv
    flops, _ = flash_work(B, H, KV, S, T, d, f32, causal)
    nbytes = 4 * (4 * B * H * S * d + 4 * B * KV * T * d + B * H * S)
    b_ms, b_by = bound_ms(2.5 * flops, nbytes, f32)
    res = {"kernel": "flash_attention_bwd", "shape": tag, "B": B, "H": H,
           "KV": KV, "d": d, "S": S, "T": T, "causal": causal,
           "softcap": softcap, "dtype": "float32",
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, want)),
           "rel_err_of_largest": errs, "tol": "1e-4 of the largest |grad|",
           "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
           "lse_max_abs_err": float((lse - lse_ref).abs().max()),
           "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    del want, got, again, o_ref, lse_ref
    if not (max(errs.values()) <= 1e-4 and res["deterministic"]
            and res["lse_max_abs_err"] <= 1e-4):
        raise AssertionError(f"flash_attention_bwd disagrees: {res}")
    return res


def rmsnorm_bwd_case(device, gen, tag, shape, residual=False,
                     stride=None) -> dict:
    """``rmsnorm_bwd`` (fp32) against its plain version, from the forward
    kernel's rstd (and its sum ``s`` in the residual form, where the
    gradient at ``s`` adds to dx), timed beside the plain version, the
    backward of ``F.rms_norm`` (after ``x + r`` in the residual form)
    through ``autograd.grad`` under a CUDA graph and the bound (x, dy, d_sum, rstd and the
    scale read, dx and dscale written once).  Tolerance 1e-5 of the
    largest |value| of dx and of dscale."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
    d = shape[-1]
    x = torch.randn(shape, generator=gen).to(device)
    if stride:
        x = strided_rows(x, stride)
    scale = (torch.randn(d, generator=gen) * 0.1 + 1).to(device)
    r = torch.randn(shape, generator=gen).to(device) if residual else None
    dy = torch.randn(shape, generator=gen).to(device)
    d_sum = torch.randn(shape, generator=gen).to(device) if residual else None
    _, s, rstd = rmsnorm_fwd(x, scale, 1e-5, r)
    xin = s if residual else x
    got = rmsnorm_bwd(xin, scale, dy, 1e-5, d_sum, rstd)
    again = rmsnorm_bwd(xin, scale, dy, 1e-5, d_sum, rstd)
    want = ref.rmsnorm_bwd_ref(xin, scale, dy, 1e-5, d_sum)
    torch.cuda.synchronize()
    errs = {"dx": max_rel(got[0], want[0]), "dscale": max_rel(got[1], want[1])}
    lx, ls = x.detach().clone().requires_grad_(True), scale.clone().requires_grad_(True)
    lr = r.clone().requires_grad_(True) if residual else None
    lib_ms = time_grad_ms(
        lambda a, b, *c: F.rms_norm(a + c[0] if c else a, (d,), b, 1e-5),
        (lx, ls) + ((lr,) if residual else ()), dy)
    n = int(np.prod(shape))
    rows = n // d
    nbytes = 4 * (n * (4 if residual else 3) + 2 * d + rows)
    b_ms, b_by = bound_ms(8 * n, nbytes, torch.float32)
    res = {"kernel": "rmsnorm_bwd" + ("[residual]" if residual else ""),
           "shape": tag, "dims": list(shape), "row_stride": stride or d,
           "dtype": "float32",
           "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
           "rel_err_of_largest": errs, "tol": "1e-5 of the largest |value|",
           "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
           "ms": time_ms(lambda: rmsnorm_bwd(xin, scale, dy, 1e-5, d_sum, rstd)),
           "plain_ms": time_ms(lambda: ref.rmsnorm_bwd_ref(xin, scale, dy, 1e-5,
                                                           d_sum)),
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not (max(errs.values()) <= 1e-5 and res["deterministic"]):
        raise AssertionError(f"rmsnorm_bwd disagrees: {res}")
    return res


def rmsnorm_bwd_many_rows(device) -> dict:
    """``rmsnorm_bwd`` past 65,535 chunks of 64 rows: q_norm's rows at
    batch 8 x seq 16,384 x 40 heads (5,242,880 rows of 128; 81,920
    dscale partials), drawn on the card, against its plain version.
    Correctness only (tolerance 1e-5 of the largest |value| of dx and of
    dscale); the times are those of the training shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
    gen = torch.Generator(device=device).manual_seed(23)
    shape = (8, 16384, 40, 128)
    x = torch.randn(shape, generator=gen, device=device)
    dy = torch.randn(shape, generator=gen, device=device)
    scale = torch.randn(128, generator=gen, device=device) * 0.1 + 1
    _, _, rstd = rmsnorm_fwd(x, scale, 1e-5)
    got = rmsnorm_bwd(x, scale, dy, 1e-5, None, rstd)
    want = ref.rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    errs = {"dx": max_rel(got[0], want[0]), "dscale": max_rel(got[1], want[1])}
    res = {"kernel": "rmsnorm_bwd", "shape": "q_norm-many-rows", "dims": list(shape),
           "rows": x.numel() // 128, "rel_err_of_largest": errs,
           "tol": "1e-5 of the largest |value|"}
    print(json.dumps(res))
    del x, dy, got, want, rstd
    torch.cuda.empty_cache()
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"rmsnorm_bwd disagrees past 65,535 chunks: {res}")
    return res


def ssd_bwd_case(device, gen, tag, B, S, H, dh, ds, with_h0: bool,
                 with_dh: bool) -> dict:
    """``ssd_scan_bwd`` (fp32) against its plain version (the sequential
    backward) on the card, B and C strided column views of one ``[B, S,
    3 ds]`` tensor (the mixer's); run twice to the same bits; timed beside
    the plain version and the bound: xb and dy read and dxb written, B, C
    and the log decays read and dB, dC and their gradient written (and
    h0, dh_final, dh0) once over HBM's rate, or the 16-row chunked
    backward's products with the causal pairs halved at the TF32 peak.
    No single PyTorch call computes it.  Tolerance 1e-4 of each
    gradient's largest |value|, as the forward."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import BWD_CHUNK, ssd_scan_bwd
    xb = torch.randn((B, S, H, dh), generator=gen).to(device)
    wide = (torch.randn((B, S, 3 * ds), generator=gen) * 0.3).to(device)
    Bm, Cm = wide[..., ds:2 * ds], wide[..., 2 * ds:]
    ld = (-torch.rand((B, S, H), generator=gen) * 0.2).to(device)
    h0 = torch.randn((B, H, dh, ds), generator=gen).to(device) if with_h0 else None
    dy = torch.randn((B, S, H, dh), generator=gen).to(device)
    dhf = torch.randn((B, H, dh, ds), generator=gen).to(device) if with_dh else None

    def call():
        return ssd_scan_bwd(xb, Bm, Cm, ld, dy, h0, dhf)

    got, again = call(), call()
    want = ref.ssd_scan_bwd_ref(xb, Bm, Cm, ld, dy, h0, dhf)
    torch.cuda.synchronize()
    names = ("dxb", "dB", "dC", "dlog_decay", "dh0")
    errs = {n: max_rel(g, w) for n, g, w in zip(names, got, want) if w is not None}
    state = B * H * dh * ds
    nbytes = 4 * (3 * B * S * H * dh + 4 * B * S * ds + 2 * B * S * H
                  + (2 * state if with_h0 else 0) + (state if with_dh else 0))
    flops = 0
    for c0 in range(0, S, BWD_CHUNK):
        n = min(BWD_CHUNK, S - c0)
        pairs = n * (n + 1) // 2
        flops += B * (2 * pairs * ds
                      + H * (10 * n * dh * ds + 4 * pairs * (dh + ds)))
    b_ms, b_by = bound_ms(flops, nbytes, "tf32")
    res = {"kernel": "ssd_scan_bwd", "shape": tag, "B": B, "S": S, "H": H,
           "dh": dh, "ds": ds, "chunk": BWD_CHUNK, "h0": with_h0,
           "dh_final": with_dh, "dtype": "float32",
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, want) if w is not None),
           "rel_err_of_largest": errs, "tol": "1e-4 of the largest |grad|",
           "deterministic": all(a is None or torch.equal(a, b)
                                for a, b in zip(got, again)),
           "ms": time_ms(call),
           "plain_ms": time_ms(lambda: ref.ssd_scan_bwd_ref(
               xb, Bm, Cm, ld, dy, h0, dhf), reps=3, graph_calls=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    del got, again, want
    torch.cuda.empty_cache()
    if not (max(errs.values()) <= 1e-4 and res["deterministic"]):
        raise AssertionError(f"ssd_scan_bwd disagrees: {res}")
    return res


def rmsnorm_split_bwd_case(device, gen, tag, shape, d_global) -> dict:
    """The split-row rmsnorm's backward (fp32) at one rank's slice
    ``shape`` of rows of ``d_global``, the other ranks' slice beside it:
    the dots launch against its plain version (1e-5 relative), the dx and
    dscale launch against its plain version from the same dots and the
    forward's rstd (1e-5 of the largest |value|), both bit for bit on a
    repeat, and the slices' dx and dscale put together against the whole
    row's plain backward (1e-5 of the largest).  Timed: the two launches
    (the collective between them runs on the host), their plain
    versions, and the backward of ``F.rms_norm`` over the gathered whole
    row through ``autograd.grad`` under a CUDA graph (no library call
    computes the split form); bound: x and dy read, each row's rstd and
    dot read (the dot written before the reduce), dx and the slice's
    dscale written, once each.  An empty slice (a rank without a head)
    gives zero sums and dots and launches nothing."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import (rmsnorm_apply, rmsnorm_split_bwd,
                                             rmsnorm_split_dot, rmsnorm_sumsq)
    d = shape[-1]
    rshape = shape[:-1] + (d_global - d,)
    x = torch.randn(shape, generator=gen).to(device)
    rest = (2 * torch.randn(rshape, generator=gen)).to(device)
    scale = (torch.randn(d_global, generator=gen) * 0.1 + 1).to(device)
    dy = torch.randn(shape, generator=gen).to(device)
    dy_rest = torch.randn(rshape, generator=gen).to(device)
    sc, sc_rest = scale[:d], scale[d:].contiguous()
    sums = rmsnorm_sumsq(x) + rmsnorm_sumsq(rest)
    rstd = torch.empty(sums.shape, device=device)
    rmsnorm_apply(x, sums, sc, d_global, 1e-5, rstd=rstd)
    rstd_rest = torch.empty(sums.shape, device=device)
    rmsnorm_apply(rest, sums, sc_rest, d_global, 1e-5, rstd=rstd_rest)
    mine = rmsnorm_split_dot(x, sc, dy)
    dots_err = max_rel(mine, ref.rmsnorm_split_dot_ref(x, sc, dy))
    dots = mine + rmsnorm_split_dot(rest, sc_rest, dy_rest)
    got = rmsnorm_split_bwd(x, sc, dy, dots, rstd, d_global)
    again = rmsnorm_split_bwd(x, sc, dy, rmsnorm_split_dot(x, sc, dy)
                              + rmsnorm_split_dot(rest, sc_rest, dy_rest),
                              rstd, d_global)
    want = ref.rmsnorm_split_bwd_ref(x, sc, dy, dots, rstd, d_global)
    other = rmsnorm_split_bwd(rest, sc_rest, dy_rest, dots, rstd_rest, d_global)
    full, dy_full = torch.cat([x, rest], -1), torch.cat([dy, dy_rest], -1)
    whole = ref.rmsnorm_bwd_ref(full, scale, dy_full, 1e-5)
    # a rank that holds none of the row (heads split unevenly): zero sums
    # and dots, though the allocator hands back a block just filled with
    # NaN, an empty dx and no launch
    from repro_torch.kernels import ops
    counted = ops.launch_counts()
    none, dy_none = x[..., :0], dy[..., :0].contiguous()
    del_me = torch.full(sums.shape, float("nan"), device=device)
    del del_me
    sums0 = rmsnorm_sumsq(none)
    dots0 = rmsnorm_split_dot(none, sc[:0], dy_none)
    dx0, ds0 = rmsnorm_split_bwd(none, sc[:0], dy_none, dots, rstd, d_global)
    empty_ok = bool((sums0 == 0).all() and (dots0 == 0).all()
                    and sums0.shape == dots0.shape == sums.shape
                    and dx0.shape == none.shape and ds0.shape == (0,)
                    and ops.launch_counts() == counted)
    torch.cuda.synchronize()
    errs = {"dots": dots_err, "dx": max_rel(got[0], want[0]),
            "dscale": max_rel(got[1], want[1]),
            "whole_row_dx": max_rel(torch.cat([got[0], other[0]], -1), whole[0]),
            "whole_row_dscale": max_rel(torch.cat([got[1], other[1]]), whole[1])}
    n = int(np.prod(shape))
    rows = n // d
    b_ms, b_by = bound_ms(8 * n, 4 * (3 * n + 2 * d + 3 * rows), torch.float32)
    lx, ls = full.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    res = {"kernel": "rmsnorm_split_bwd", "shape": tag, "dims": list(shape),
           "d_global": d_global, "dtype": "float32",
           "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
           "rel_err_of_largest": errs, "tol": "1e-5 of the largest |value|",
           "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
           "empty_slice_ok": empty_ok,
           "ms": time_ms(lambda: rmsnorm_split_bwd(
               x, sc, dy, rmsnorm_split_dot(x, sc, dy), rstd, d_global)),
           "plain_ms": time_ms(lambda: ref.rmsnorm_split_bwd_ref(
               x, sc, dy, ref.rmsnorm_split_dot_ref(x, sc, dy), rstd, d_global)),
           "library_ms": time_grad_ms(
               lambda a, b: F.rms_norm(a, (d_global,), b, 1e-5), (lx, ls), dy_full),
           "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not (max(errs.values()) <= 1e-5 and res["deterministic"] and empty_ok):
        raise AssertionError(f"split-row rmsnorm backward disagrees: {res}")
    return res


def train_kernel_cases(device) -> list:
    """The backward kernels at the training path's shapes (fp32)."""
    gen = torch.Generator().manual_seed(22)
    rows = [flash_bwd_case(device, gen, "smollm", SMOLLM, 8, 128, 128),
            flash_bwd_case(device, gen, "smollm", SMOLLM, 8, 2048, 2048),
            flash_bwd_case(device, gen, "smollm-softcap", SMOLLM, 2, 256, 256,
                           softcap=30.0),
            flash_bwd_case(device, gen, "phi3.5-moe", PHI_MOE, 2, 512, 512),
            flash_bwd_case(device, gen, "whisper-encoder", WHISPER, 2, 1500, 1500,
                           causal=False),
            flash_bwd_case(device, gen, "whisper-cross", WHISPER, 2, 64, 1500,
                           causal=False)]
    torch.cuda.empty_cache()
    for residual in (False, True):
        rows.append(rmsnorm_bwd_case(device, gen, "smollm-train", (8, 128, 576),
                                     residual))
    # qwen3-14b's q_norm rows (40 heads of 128) read in place, as rows of
    # 128 inside rows of 192
    rows.append(rmsnorm_bwd_case(device, gen, "q_norm-strided", (8, 128, 40, 128),
                                 stride=192))
    rows.append(rmsnorm_bwd_many_rows(device))
    # zamba2-2.7b's training shapes (the CLI's batch 8 x 128), then S =
    # 200 (a partial last chunk of the forward's 128 and of the backward's
    # 16) with an initial state and a final-state gradient; the gated
    # norm's split-row backward on a tp = 2 rank
    rows.append(ssd_bwd_case(device, gen, "zamba2-train", 8, 128, 80, 64, 64,
                             False, False))
    rows.append(ssd_bwd_case(device, gen, "zamba2-ragged", 2, 200, 80, 64, 64,
                             True, True))
    rows.append(rmsnorm_split_bwd_case(device, gen, "zamba2-mamba-norm/tp2",
                                       (8, 128, 2560), 5120))
    return rows


_MARK = [time.perf_counter()]


def mark(what: str) -> None:
    """Seconds since the last mark, on stderr: where a phase's time goes."""
    now = time.perf_counter()
    print(f"  {what}: {now - _MARK[0]:.1f} s", file=sys.stderr, flush=True)
    _MARK[0] = now


def tree_equal(a, b) -> bool:
    from repro_torch.utils import named_leaves
    return all(na == nb and torch.equal(x, y) for (na, x), (nb, y)
               in zip(named_leaves(a), named_leaves(b)))


def check_train_launches(counts: dict, want: dict, steps: int, where: str) -> None:
    """Exact launches of ``steps`` training steps, every kernel named
    (``want`` per step; kernels not named must not launch)."""
    expect = {k: 0 for k in counts}
    expect.update({k: n * steps for k, n in want.items()})
    if counts != expect:
        raise AssertionError(f"{where}: launches {counts}, expected {expect}")


def smollm_train_launches(L: int) -> dict:
    """Per training step of a dense model with remat: forward L flash and
    2L + 1 rmsnorm (L fused), recomputed per block in the backward (the
    final norm is not), then one backward per forward call."""
    return {"flash_attention": 2 * L, "rmsnorm": 4 * L + 1, "rmsnorm_fused": 2 * L,
            "flash_attention_bwd": L, "rmsnorm_bwd": 2 * L + 1}


def phase_train(device) -> dict:
    """Phase 14: the backward kernels against their plain versions, then
    ``repro_torch.launch.train``'s ``train()`` on smollm-135m at full
    width and depth (fp32, the CLI's defaults) with exact launches and a
    bit-equal resume, the loss falling on a repeated batch, a step at seq
    2,048, card-against-CPU steps (smollm at 2 layers, phi3.5-moe at 1,
    whisper-medium at 1 + 1), phi3.5-moe at one layer and whisper-medium
    at full depth."""
    import tempfile
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.train.train_loop import (init_train_state, make_train_step,
                                              train)
    mark("train: start")
    out = {"kernels": train_kernel_cases(device)}
    mark("train: kernel cases")
    torch.cuda.empty_cache()
    scratch = ROOT / "_scratch"
    scratch.mkdir(exist_ok=True)

    # --- smollm-135m at full width and depth through the CLI's train() ---
    # the uninterrupted run writes no checkpoint (the resumed one below
    # writes and reads them): 1.6 GB of state per write
    with tempfile.TemporaryDirectory(dir=scratch) as d2:
        args = cli.parse_args(["--arch", "smollm-135m", "--steps", str(TRAIN_STEPS),
                               "--ckpt-every", str(TRAIN_CKPT_EVERY)])
        model, opt, data, loop = cli.build(args)
        cfg = model.cfg
        assert (cfg.n_layers, cfg.d_model, cfg.dtype, cfg.remat) == (
            30, 576, "float32", True)
        stamps = []
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state_a, losses_a = train(model, opt, data, loop, log=print,
                                  on_step=lambda s, m: stamps.append(
                                      time.perf_counter()), draw_on_device=True)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_train_launches(counts, smollm_train_launches(cfg.n_layers),
                             TRAIN_STEPS, "smollm-135m training")
        step_s = float(np.median(np.diff(stamps)))
        run = {"pass": "smollm-135m train", "batch": args.batch, "seq": args.seq,
               "steps": TRAIN_STEPS, "launches": counts, "wall_s": wall,
               "step_ms_median": step_s * 1e3,
               "tokens_per_s": args.batch * args.seq / step_s,
               "losses": losses_a, "max_memory_allocated": peak}
        # interrupted at the first checkpoint, then resumed to the end
        ops.reset_launch_counts()
        loop_b = dataclasses.replace(loop, ckpt_dir=d2, total_steps=TRAIN_CKPT_EVERY)
        _, first = train(model, opt, data, loop_b, log=print,
                         draw_on_device=True)
        state_b, rest = train(model, opt, data,
                              dataclasses.replace(loop_b, total_steps=TRAIN_STEPS),
                              log=print, draw_on_device=True)
        resumed = ops.launch_counts()
        check_train_launches(resumed, smollm_train_launches(cfg.n_layers),
                             TRAIN_STEPS, "smollm-135m resumed training")
        run["resume_losses_equal"] = first + rest == losses_a
        run["resume_params_equal"] = tree_equal(state_a["params"], state_b["params"])
        run["resume_opt_equal"] = tree_equal(state_a["opt"], state_b["opt"])
        run["resume_launches"] = resumed
        print(json.dumps({k: v for k, v in run.items() if k != "losses"}))
        print(json.dumps({"smollm_train_losses": losses_a}))
        if not (run["resume_losses_equal"] and run["resume_params_equal"]
                and run["resume_opt_equal"]):
            raise AssertionError(f"resumed training differs: {run}")
    del state_b
    out["smollm"] = run

    # --- the device-busy share of two steps, the loss falling on one batch ---
    step_fn = make_train_step(model, opt)
    batch = next(iter(TokenStream(data)))
    holder = {"state": state_a}

    def one_step():
        holder["state"], holder["m"] = step_fn(holder["state"], batch)

    one_step()
    out["smollm"]["profile"] = profiled_steps([one_step, one_step])
    print(json.dumps({"smollm_train_profile": out["smollm"]["profile"]}))
    del holder, state_a
    state = init_train_state(model, opt, seed=5, draw_on_device=True)
    falling = []
    for _ in range(5):
        state, m = step_fn(state, batch)
        falling.append(float(m["loss"]))
    out["smollm"]["repeated_batch_losses"] = falling
    print(json.dumps({"smollm_repeated_batch_losses": falling}))
    if not falling[-1] < falling[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: {falling}")

    # --- one step at seq 2,048 ---
    long = dataclasses.replace(data, seq_len=2048)
    lbatch = next(iter(TokenStream(long)))
    state, _ = step_fn(state, lbatch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step_fn(state, lbatch)
    float(m["loss"])
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    out["smollm"]["seq2048"] = {"batch": long.global_batch, "seq": 2048,
                                "step_ms": long_s * 1e3,
                                "tokens_per_s": long.global_batch * 2048 / long_s,
                                "loss": float(m["loss"]),
                                "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(json.dumps({"smollm_seq2048_step": out["smollm"]["seq2048"]}))
    del state, model, step_fn
    torch.cuda.empty_cache()

    mark("train: smollm")
    out["zamba"] = train_zamba_cli()
    mark("train: zamba2 CLI")
    out["parity"] = []
    for run in PARITY_RUNS:
        out["parity"].append(train_parity(device, *run))
        mark(f"train: parity {run[0]}")
    out["moe"] = train_big(device, "phi3.5-moe-42b-a6.6b", n_layers=1)
    mark("train: phi3.5-moe")
    out["whisper"] = train_big(device, "whisper-medium")
    mark("train: whisper-medium")
    return out


def train_zamba_cli() -> dict:
    """zamba2-2.7b at full width and depth (54 Mamba2 blocks, the shared
    block used 9 times; 2.42 B parameters, fp32: parameters, gradients
    and both moments ~39 GB) through ``launch.train``'s ``train()`` at the
    CLI's defaults (batch 8, seq 128, remat): exact launches per step
    (``ssd_scan`` 2L and its backward L), step time, tokens/s and peak
    allocation; then, carrying the state on at lr 1e-5, the loss falling
    over a few steps on one batch."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.train.train_loop import make_train_step, train
    args = cli.parse_args(["--arch", "zamba2-2.7b", "--steps",
                           str(ZAMBA_TRAIN_STEPS)])
    model, opt, data, loop = cli.build(args)
    cfg = model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.dtype, cfg.remat) == (
        54, 2560, "float32", True)
    stamps = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses = train(model, opt, data, loop, log=print,
                          on_step=lambda s, m: stamps.append(time.perf_counter()),
                          draw_on_device=True)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_train_launches(counts, train_launches(cfg), ZAMBA_TRAIN_STEPS,
                         "zamba2-2.7b training")
    step_s = float(np.median(np.diff(stamps)))
    step_fn = make_train_step(model, dataclasses.replace(opt, lr=ZAMBA_REPEAT_LR))
    batch = next(iter(TokenStream(data)))
    falling = []
    for _ in range(ZAMBA_REPEAT_STEPS):
        state, m = step_fn(state, batch)
        falling.append(float(m["loss"]))
    run = {"pass": "zamba2-2.7b train", "batch": args.batch, "seq": args.seq,
           "layers": cfg.n_layers, "steps": ZAMBA_TRAIN_STEPS, "launches": counts,
           "wall_s": wall, "step_ms_median": step_s * 1e3,
           "tokens_per_s": args.batch * args.seq / step_s, "losses": losses,
           "repeated_batch_losses": falling, "repeated_batch_lr": ZAMBA_REPEAT_LR,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del state, step_fn
    torch.cuda.empty_cache()
    run["plain_backward"] = zamba_plain_witness(model, opt, data, losses)
    print(json.dumps(run))
    del model
    torch.cuda.empty_cache()
    if not (all(np.isfinite(losses)) and falling[-1] < falling[0]):
        raise AssertionError(f"zamba2-2.7b training: {run}")
    return run


def zamba_plain_witness(model, opt, data, losses: list) -> dict:
    """The CLI run's first step again at its lr (seed 0 drawn on the card,
    the stream's first batch): the gradients once through the
    ``ssd_scan`` backward kernel and once through the plain backward
    (``ref.ssd_scan_bwd_ref``, sequential) on the card, then the plain
    route's AdamW step and its loss on the stream's second batch.  Held:
    step 1's loss equal to the CLI run's within 1e-6 relative, each
    gradient leaf within ``TRAIN_GRAD_TOL`` of its largest and the grad
    norms within 1e-4 relative, the kernel launched L times and not at
    all on the plain route, and the plain route's second loss within 1e-3
    relative of the CLI run's: where the CLI run's loss rises, it rises
    without the kernel too."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as scan
    from repro_torch.train.optimizer import (adamw_update, global_norm,
                                             init_opt_state)
    from repro_torch.utils import named_leaves, unflatten_like
    stream = iter(TokenStream(data))
    b1, b2 = next(stream), next(stream)
    params = model.init_params(0, draw_on_device=True)
    flat = dict(named_leaves(params))
    real = scan.ssd_scan_bwd
    n0 = real.launches
    loss_k, g_kernel = step_grads(model, params, flat, b1)
    n1 = real.launches
    scan.ssd_scan_bwd = ref.ssd_scan_bwd_ref
    try:
        loss_p, g_plain = step_grads(model, params, flat, b1)
    finally:
        scan.ssd_scan_bwd = real
    n2 = real.launches
    torch.cuda.synchronize()
    grad_err = {n: max_rel(g_plain[n], g_kernel[n]) for n in g_plain}
    norm_k = float(global_norm(g_kernel))
    norm_p = float(global_norm(g_plain))
    del g_kernel
    torch.cuda.empty_cache()
    new, _, _ = adamw_update(params, unflatten_like(params, iter(g_plain.values())),
                             init_opt_state(params, opt), opt)
    del params, flat, g_plain
    torch.cuda.empty_cache()
    with torch.no_grad():
        loss2 = float(model.loss(new, b2))
    del new
    torch.cuda.empty_cache()
    worst = max(grad_err, key=grad_err.get)
    out = {"lr": opt.lr, "loss1_cli": losses[0], "loss1_kernel": loss_k,
           "loss1_plain": loss_p, "loss2_cli": losses[1], "loss2_plain": loss2,
           "grad_norm_kernel": norm_k, "grad_norm_plain": norm_p,
           "grad_err_of_largest": grad_err[worst], "grad_worst_leaf": worst,
           "grad_tol": TRAIN_GRAD_TOL,
           "bwd_launches": {"kernel": n1 - n0, "plain": n2 - n1}}
    print(json.dumps({"zamba_plain_witness": out}))
    if not (abs(loss_k - losses[0]) <= 1e-6 * abs(losses[0])
            and abs(loss_p - loss_k) <= 1e-6 * abs(loss_k)
            and grad_err[worst] <= TRAIN_GRAD_TOL
            and abs(norm_p - norm_k) <= 1e-4 * norm_k
            and out["bwd_launches"] == {"kernel": model.cfg.n_layers, "plain": 0}
            and abs(loss2 - losses[1]) <= 1e-3 * abs(losses[1])):
        raise AssertionError(f"zamba2-2.7b plain-backward witness: {out}")
    return out


# (arch, depth cut, batch, seq, weight seed, data seed): smollm at 2
# layers; phi3.5-moe and whisper-medium at train_big's seeds, their
# weights drawn on the card as train_big's are and copied to the host (a
# CPU draw of phi3.5-moe's fp32 layer takes ~20 s); zamba2-2.7b and
# xlstm-1.3b at one unit (6 Mamba2 blocks and the shared block; 7 mLSTM
# and 1 sLSTM blocks).  One step each, at one sequence (smollm two).
# phi3.5-moe's step runs 4 of its 16 experts (each whole, top-2, as phase
# 11's deepseek-v3 parity cuts its experts): its 16-expert layer took
# 103.0-108.1 s of the script's time limit at 1 x 64 and 2 x 128, its
# 1.3 B parameters through the CPU's optimizer and comparisons, the
# largest part of phase 14
# The AdamW update is the same elementwise code for every model: the
# CPU's update from the card's gradients is held against the card's for
# the two whose parameters the host updates in a second or two.  For
# phi3.5-moe, zamba2-2.7b and xlstm-1.3b (0.4-0.6 B fp32 parameters) two
# host updates each took most of phase 14's parity time (their CPU step
# and comparisons 11-21 s each on an H100 host), and their whole step
# runs the card's AdamW on the CPU's gradients
PARITY_HOST_ADAMW = ("smollm-135m", "whisper-medium")
PARITY_RUNS = (("smollm-135m", dict(n_layers=2), 2, 64, 3, 7),
               ("phi3.5-moe-42b-a6.6b", dict(n_layers=1, n_experts=4), 1, 64, 4, 2),
               ("whisper-medium", dict(n_layers=1, dec_layers=1), 1, 64, 4, 2),
               ("zamba2-2.7b", dict(n_layers=6), 1, 64, 4, 2),
               ("xlstm-1.3b", dict(n_layers=8), 1, 64, 4, 2))


def step_grads(model, like, params: dict, batch: dict) -> tuple:
    """(loss, {name: gradient}) of ``model.loss`` at the flat ``params``
    (``like`` the tree they unflatten into)."""
    from repro_torch.utils import unflatten_like
    for t in params.values():
        t.requires_grad_(True)
    loss = model.loss(unflatten_like(like, iter(params.values())), batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for t in params.values():
        t.requires_grad_(False)
    return float(loss.detach()), grads


# how far a gradient may move under weights perturbed in their last bits:
# a sharded or card-against-CPU gradient is held to the larger of
# TRAIN_GRAD_TOL and GRAD_FLOOR_FACTOR times that
GRAD_NOISE, GRAD_FLOOR_FACTOR = 1e-7, 4.0


def grad_floor(grad_fn, params: dict, grads: dict) -> float:
    """The largest change, over each leaf's largest |gradient|, of the
    gradients ``grad_fn(perturbed)`` at ``params`` times (1 + 1e-7 noise)
    (a fixed seed), against ``grads`` at ``params``: the fp32 noise floor
    of the model's gradient, which any other order of summation (another
    device, a sharding) can reach.  zamba2-2.7b at one unit read 4.3e-5,
    xlstm-1.3b 1.5e-4 (CPU, fp32).  The noise is drawn on the parameters'
    device (the host's generator draws ~1e8 normals a second: 12 s for
    llama3-8b at one layer)."""
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev).manual_seed(97)
    noisy = {n: t * (1 + GRAD_NOISE * torch.randn(t.shape, generator=gen,
                                                  device=dev))
             for n, t in params.items()}
    moved = grad_fn(noisy)
    return max(max_rel(moved[n], grads[n]) for n in grads)


def train_parity(device, arch: str, replace: dict, batch: int, seq: int,
                 seed: int, data_seed: int) -> dict:
    """One training step of ``arch`` at full width, its depth cut by
    ``replace`` (fp32, remat), from the same seeded weights and batch on
    the card (kernels) and on the CPU (plain versions).  Held: the loss
    (moe: its load-balancing loss included) within 1e-5 relative, the
    grad norm within 1e-4 relative, every gradient within 1e-4 of its
    largest |value|, every parameter the card's AdamW step writes within
    1e-5 of its largest |value| of the card's AdamW step from the CPU's
    gradients (the whole step) wherever the gradient is at least 1e-3 of
    the leaf's largest and, clipped, at least 1e3 eps, and for the archs
    of ``PARITY_HOST_ADAMW`` within 1e-5 everywhere of the same update
    computed on the CPU from the card's gradients.  Elsewhere the whole
    step is printed, not held: AdamW's first update is lr * g / (|g| +
    eps), so an element whose gradient is near eps = 1e-8 turns a
    gradient difference of ~1e-6 of the leaf's largest into a part of lr.
    The gradients' 1e-4 is raised to 4 times the model's own fp32 floor
    (:func:`grad_floor`) where that is larger: xlstm-1.3b's read ~1.5e-4
    on the CPU."""
    from repro_torch.data.pipeline import DataConfig, TokenStream, make_frames
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             global_norm, init_opt_state)
    from repro_torch.utils import named_leaves
    t_start = time.perf_counter()
    cfg = get_config(arch).replace(dtype="float32", **replace)
    assert cfg.remat
    opt = OptimizerConfig(warmup_steps=1)
    batch0 = next(iter(TokenStream(DataConfig(cfg.vocab_size, seq, batch,
                                              seed=data_seed))))
    if cfg.is_encdec:
        batch0["frames"] = make_frames(cfg.d_model, batch, WHISPER_FRAMES,
                                       seed=31)
    cpu_model = get_model(cfg, device="cpu")
    like = card_drawn_host_params(cfg, device, seed)
    init = dict(named_leaves(like))

    def card(t):
        return t.to(device)

    model = get_model(cfg, device=device)
    params = {n: card(t) for n, t in init.items()}
    lc, dc = step_grads(model, like, params, batch0)
    floor = grad_floor(lambda q: step_grads(model, like, q, batch0)[1],
                       params, dc)
    nc, _, m = adamw_update(params, dc, init_opt_state(params, opt), opt)
    gc = float(m["grad_norm"])
    del params, m
    torch.cuda.empty_cache()
    mark(f"train: parity {arch} card step")
    lh, dh = step_grads(cpu_model, like, init, batch0)
    gh = float(global_norm(dh))
    del cpu_model
    mark(f"train: parity {arch} CPU step")
    # every comparison (fp32 differences, maxima and quotients, exact on
    # either device) runs on the card, the host's tensors moved there
    # leaf by leaf
    step_err = None
    if arch in PARITY_HOST_ADAMW:
        # the card's AdamW step against the CPU's from the card's gradients
        same, _, _ = adamw_update(init, {n: t.cpu() for n, t in dc.items()},
                                  init_opt_state(init, opt), opt)
        step_err = max(max_rel(nc[n], card(same[n])) for n in same)
        del same
    grad_err = {n: max_rel(dc[n], card(dh[n])) for n in dh}
    # the whole step: the card's AdamW from the CPU's gradients
    p0 = {n: card(t) for n, t in init.items()}
    g0 = {n: card(t) for n, t in dh.items()}
    nh, _, _ = adamw_update(p0, g0, init_opt_state(p0, opt), opt)
    del p0, g0
    whole_err, held_err = {}, {}
    clip = min(1.0, opt.clip_norm / gh)
    for n in nh:
        diff, top = (nc[n] - nh[n]).abs(), nh[n].abs().max().clamp_min(1e-30)
        g = card(dh[n]).abs()
        held = (g >= 1e-3 * g.max()) & (clip * g >= 1e3 * opt.eps)
        whole_err[n] = float(diff.max() / top)
        held_err[n] = float(diff[held].max() / top) if held.any() else 0.0
        del diff, g, held
    n_w = max(whole_err, key=whole_err.get)
    i = int((nc[n_w] - nh[n_w]).abs().argmax())
    del nc, nh
    torch.cuda.empty_cache()
    row = {"arch": arch, "reduced": replace, "batch": batch, "seq": seq,
           "loss_card": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) / abs(lh),
           "grad_norm_card": gc, "grad_norm_cpu": gh,
           "grad_norm_rel": abs(gc - gh) / abs(gh),
           "grad_err_of_largest": max(grad_err.values()),
           "grad_err_worst_leaf": max(grad_err, key=grad_err.get),
           "grad_floor": floor,
           "grad_tol": max(TRAIN_GRAD_TOL, GRAD_FLOOR_FACTOR * floor),
           "step_err_of_largest": step_err,
           "whole_step_param_err_of_largest": whole_err[n_w],
           "whole_step_held_param_err_of_largest": max(held_err.values()),
           "whole_step_worst": {"param": n_w,
                                "grad_card": float(dc[n_w].flatten()[i]),
                                "grad_cpu": float(dh[n_w].flatten()[i])},
           "seconds": time.perf_counter() - t_start}
    del dc, dh
    print(json.dumps({"train_parity": row}))
    if not (row["loss_rel"] <= 1e-5 and row["grad_norm_rel"] <= 1e-4
            and row["grad_err_of_largest"] <= row["grad_tol"]
            and (step_err is None or step_err <= 1e-5)
            and row["whole_step_held_param_err_of_largest"] <= 1e-5):
        raise AssertionError(f"{arch} training step: card and CPU differ: {row}")
    return row


def train_big(device, arch: str, steps: int = 3, **replace) -> dict:
    """``steps`` training steps of ``arch`` at full width in fp32 (the
    depth cut by ``replace``): phi3.5-moe at the CLI's batch (8 x 128)
    with its load-balancing loss finite and nonzero; whisper-medium at 2
    x (1,500 frames, 64 decoder tokens).  Exact backward launches."""
    from repro_torch.data.pipeline import DataConfig, TokenStream, make_frames
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_config
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, params, info = big_model(arch, device, seed=4, dtype="float32",
                                    **replace)
    cfg = model.cfg
    if replace:
        full = get_config(arch)
        info["reduced"] = {k: f"{v} of {getattr(full, k)}"
                           for k, v in replace.items()}
        print(json.dumps({"reduced": info["reduced"], "arch": arch,
                          "why": "fp32 parameters, gradients and both moments "
                                 "of every layer do not fit one card"}))
    opt = OptimizerConfig(warmup_steps=1)
    state = {"params": params, "opt": init_opt_state(params, opt)}
    del params
    if cfg.is_encdec:
        B, seq = 2, 64
        frames = make_frames(cfg.d_model, B, WHISPER_FRAMES, seed=31)
    else:
        B, seq = 8, 128
    stream = iter(TokenStream(DataConfig(cfg.vocab_size, seq, B, seed=2)))
    step_fn = make_train_step(model, opt)
    ops.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        batch = next(stream)
        if cfg.is_encdec:
            batch["frames"] = frames
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    check_train_launches(counts, train_launches(cfg), steps, f"{arch} training")
    row = {"arch": arch, "model": info, "batch": B, "seq": seq, "steps": steps,
           "losses": losses, "step_ms": [t * 1e3 for t in times],
           "tokens_per_s": B * seq / float(np.median(times[1:])),
           "launches": counts, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if cfg.n_experts:
        with torch.no_grad():
            _, aux = model.forward(state["params"], batch)
        row["aux_loss"] = float(aux)
        if not (np.isfinite(row["aux_loss"]) and row["aux_loss"] > 0):
            raise AssertionError(f"{arch}: load-balancing loss {row['aux_loss']}")
    print(json.dumps(row))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch}: losses {losses}")
    del state, model
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 15: tensor-parallel serving, 2 ranks sharing one card
# ---------------------------------------------------------------------------

TP = 2
TP_BACKEND = "gloo"            # NCCL refuses two ranks on one device
TP_SEED = 7
TP_NEW = 8                     # tokens per invocation
TP_PROMPT = 96                 # tokens of a plain prompt
TP_TEMPLATE = 64               # the template prompt (8 pages)
TP_REUSE_SUFFIX = 24           # a prefix hit's own tokens
# bf16: the first prefill's logits at tp = 2 against tp = 1
# for the same seed and prompt, as a share of the largest |logit|
TP_BF16_LOGIT_BOUND = 5e-2
# deepseek-v3's (1 layer) tighter: its sound gap read 1.10%, and one
# rank's shared-expert partial left out read 3.89%, inside 5%; every
# other planted fault read >= 52% (tools/torch_tp_fault_gap.py; H100)
TP_MLA_LOGIT_BOUND = 2e-2
# zamba2 (12 of 54 Mamba2 blocks, 2 units) and xlstm (16 of 48 blocks, 2
# units) in bf16, each a third of its nearest planted fault: zamba2's
# sound gap read 5.36% (a slice normalised alone 42.2%, B and C cut like
# x 113.6%, a skipped out-projection reduce 112.3%), xlstm's 18.85% (rank
# 1's sLSTM output ungathered 63.4%, a slice alone 112.9%, a skipped
# reduce 135.7%).  Random-weight bf16 recurrences are noisy: one rank's
# bf16 logits read 8.29% (zamba2) and 29.50% (xlstm) from the float32
# prefill of the same draw, and tp = 2's no farther (10.32%, 27.24%)
# (tools/torch_tp_fault_gap.py --case zamba --case xlstm --floor; H100)
TP_ZAMBA_LOGIT_BOUND = 0.14
TP_XLSTM_LOGIT_BOUND = 0.21
# their fp32 cases' first logits besides equal tokens: 9.47e-6 (zamba2)
# and 2.07e-5 (xlstm) of the largest read apart (H100)
TP_RECURRENT_FP32_LOGIT_BOUND = 1e-4


def tp_requests(vocab: int) -> tuple:
    """The template prompt and the invocations of one tensor-parallel
    pass: cold, then (after an evict) a fork, a prefix hit, and the cold
    prompt again warm (its tokens must equal the cold ones)."""
    rng = np.random.default_rng(11)
    tpl = rng.integers(1, vocab, TP_TEMPLATE).astype(np.int32)
    a = rng.integers(1, vocab, TP_PROMPT).astype(np.int32)
    b = rng.integers(1, vocab, TP_PROMPT).astype(np.int32)
    hit = np.concatenate([tpl, rng.integers(1, vocab, TP_REUSE_SUFFIX)
                          ]).astype(np.int32)
    return tpl, [("cold", a), ("fork", b), ("warm-hit", hit), ("warm", a)]


def _rank_memory(server) -> dict:
    """One rank's page-locked pool bytes and device allocation."""
    return {"registered_bytes": server.registered_bytes(),
            "device_allocated_bytes": torch.cuda.memory_allocated(),
            "device_peak_bytes": torch.cuda.max_memory_allocated()}


def _rank_counts() -> dict:
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    return {"launches": ops.launch_counts(),
            "collectives": sharding.collective_stats()}


def _rank_reset() -> None:
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    sharding.reset_collective_stats()


def _rank_release() -> None:
    release_host_memory()
    torch.cuda.empty_cache()


def _rank_arena_bytes(model) -> dict:
    """Bytes per token per layer of the paged arena this rank allocates
    (bf16 / fp32 and int8 with its scales)."""
    out = {}
    for kv_dtype in (None, "int8"):
        arena = model.make_paged_cache(1, PAGE_SIZE, kv_dtype=kv_dtype)
        out[kv_dtype or str(model.dtype)[6:]] = sum(
            t.numel() * t.element_size() for t in arena.values()) / (
            model.cfg.n_layers * PAGE_SIZE)
        del arena
    return out


def _rank_state_bytes(model) -> int:
    """Bytes of one slot of the dense cache this rank allocates (zamba:
    its Mamba2 heads' state, the conv window and the shared block's K/V
    over 128 rows; xLSTM: its heads' states and the whole mLSTM conv)."""
    from repro_torch.utils import tree_bytes
    return tree_bytes(model.make_cache(1, 128))


def tp_reckoned_bytes(cfg, tp: int) -> int:
    """One rank's weight bytes reckoned from the configuration alone (not
    from the parameter tree): attention split by heads (MLA's a-side
    whole), a dense MLP by ``d_ff``, a moe layer's experts by expert
    (each whole), its shared experts by width and its router whole,
    norms whole, embedding and head by vocabulary.  zamba and xLSTM:
    ``tp_recurrent_bytes``."""
    if cfg.family in ("zamba", "xlstm"):
        return tp_recurrent_bytes(cfg, tp)
    D, L, V, E = cfg.d_model, cfg.n_layers, cfg.vocab_size, cfg.n_experts
    H, KV = rank0_heads(cfg, tp)
    if cfg.use_mla:
        qr, kvr, dr = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim
        dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
        attn = (D * qr + qr + qr * H * (dn + dr) + D * (kvr + dr) + kvr
                + kvr * H * (dn + dv) + H * dv * D)
    else:
        # KV heads split, or each rank keeping the one its queries read
        hd = cfg.head_dim
        attn = D * hd * (H + 2 * KV) + H * hd * D
    if E:
        Fd = cfg.moe_d_ff or cfg.d_ff
        mlp = (D * E + 3 * (E // tp) * D * Fd
               + 3 * D * Fd * cfg.n_shared_experts // tp)
    else:
        mlp = 3 * D * cfg.d_ff // tp
    elt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    # embedding and head (one tied leaf), by vocabulary where it splits
    vocab = (1 if cfg.tied_embeddings else 2) * (V // tp if V % tp == 0
                                                 else V) * D
    return elt * (vocab + D + L * (2 * D + attn + mlp))


def rank0_heads(cfg, tp: int) -> tuple:
    """Rank 0's (query heads, KV heads) of ``tp``, by the rule of
    uneven splits written out from the configuration alone: with ``KV >=
    tp`` the first rank takes ceil(KV / tp) whole KV groups; with ``KV <
    tp`` one KV head and ceil(G / ceil(tp / KV)) of its G query heads.
    Where the model axis divides the heads: H / tp and KV / tp (or 1)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        return H // tp, KV
    G = H // KV
    if KV >= tp:
        kv = -(-KV // tp)
        return kv * G, kv
    return -(-G // -(-tp // KV)), 1


def tp_recurrent_bytes(cfg, tp: int) -> int:
    """One zamba or xLSTM rank's weight bytes from the configuration
    alone: Mamba2's z, x and dt columns and its heads' vectors by heads
    with B and C whole, the shared block's attention by heads and MLP by
    ``d_ff``; the mLSTM's x_inner half of up_proj and its conv whole, its
    heads' columns (z, q, k, v, gates) and down_proj rows by heads; the
    sLSTM by heads and its post-MLP by width where ``tp`` divides it;
    norms whole, embedding and head by vocabulary."""
    D, V = cfg.d_model, cfg.vocab_size
    W = cfg.conv_width
    if cfg.family == "zamba":
        di, ds, H = cfg.ssm_expand * D, cfg.ssm_state, cfg.ssm_heads // tp
        dil = di // tp
        mamba = (D + D * (2 * dil + 2 * ds + H) + W * (dil + 2 * ds) + 3 * H
                 + dil + dil * D)
        hd, Hq, KV = cfg.head_dim, cfg.n_heads // tp, max(cfg.n_kv_heads // tp, 1)
        shared = 2 * D + D * hd * (Hq + 2 * KV) + Hq * hd * D + 3 * D * cfg.d_ff // tp
        blocks = cfg.n_layers * mamba + shared
    else:
        units = cfg.n_layers // cfg.slstm_every
        n_m = units * (cfg.slstm_every - 1)
        di = int(cfg.mlstm_proj_factor * D)
        dil, H = di // tp, cfg.n_heads // tp
        mlstm = (D + D * (di + dil) + W * di + 3 * di * dil + di * 2 * H
                 + 2 * H + dil + dil * D)
        Dl, dh = D // tp, D // cfg.n_heads
        F_ = int(4 * D / 3)
        mlp = 3 * D * (F_ // tp if F_ % tp == 0 else F_)
        slstm = 2 * D + D * 4 * Dl + H * dh * 4 * dh + 4 * Dl + Dl + mlp
        blocks = n_m * mlstm + units * slstm
    elt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return elt * (2 * (V // tp) * D + D + blocks)


def tp_collectives(cfg) -> int:
    """Collectives of one model call at ``TP`` ranks: one per attention,
    one per MLP or moe layer, the embedding and the head (2L + 2); zamba
    two per Mamba2 block (the split norm's sums, ``out_proj``) and two per
    application of the shared block (2L + 2U + 2); xLSTM two per mLSTM
    block (the split norm's sums, ``down_proj``), and per sLSTM block the
    split norm's sums, the gather of its heads and its post-MLP where
    ``TP`` divides its width (2M + 3U + 2)."""
    if cfg.family == "zamba":
        return 2 * cfg.n_layers + 2 * attention_launches(cfg) + 2
    if cfg.family == "xlstm":
        n_m, n_s = xlstm_blocks(cfg)
        mlp = int(4 * cfg.d_model / 3) % TP == 0
        return 2 * n_m + (3 if mlp else 2) * n_s + 2
    return 2 * cfg.n_layers + 2


def split_norms(cfg) -> int:
    """Norms of one model call over a row that tensor parallelism splits
    (the split-row form's two launches each at tp > 1): Mamba2's gated
    norm, the mLSTM's and the sLSTM's inner norms."""
    if cfg.family == "zamba":
        return cfg.n_layers
    if cfg.family == "xlstm":
        return sum(xlstm_blocks(cfg))
    return 0


def tp_routing(calls) -> list:
    """The controller's moe calls of one invocation (``moe.watch``): per
    call its rows, dropped pairs and a digest of its expert ids and
    ``keep`` mask, compared across ``tp``."""
    import hashlib
    out = []
    for S, idx, keep in calls:
        idx, keep = idx.cpu(), keep.cpu()
        digest = hashlib.sha1(idx.numpy().tobytes() + keep.numpy().tobytes())
        out.append([int(S), int(idx.shape[0]), int((~keep).sum()),
                    digest.hexdigest()[:16]])
    return out


def _rank_decode_timing(model, params, steps: int) -> dict:
    """One rank's decode step at 4 busy slots, position 127, over a paged
    arena (zamba and xLSTM: a dense cache): the host's wall ms, the
    CUDA-event span ms (the card's time line, waits in the collectives
    included) and the host ms inside the collectives, per step (medians;
    every rank runs this together)."""
    from repro_torch.distributed import sharding
    B, ps, pos = 4, PAGE_SIZE, 127
    bps = 128 // ps
    toks = np.ones((B, 1), np.int32)
    posv = np.full((B,), pos, np.int32)
    if model.supports_paged_kv:
        arena = model.make_paged_cache(1 + B * bps, ps)
        pt = (1 + np.arange(B * bps, dtype=np.int32)).reshape(B, bps)

        def step():
            model.decode_step_paged(params, arena, {"tokens": toks}, posv, pt,
                                    ps)
    else:
        cache = model.make_cache(B, 128)

        def step():
            model.decode_step(params, cache, {"tokens": toks}, posv)
    host, dev, coll = [], [], []
    for i in range(steps + 2):
        sharding.reset_collective_stats()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        step()
        e1.record()
        torch.cuda.synchronize()
        if i >= 2:
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(e0.elapsed_time(e1))
            coll.append(sharding.collective_stats()["seconds"] * 1e3)
    return {"host_ms": float(np.median(host)), "device_span_ms": float(
        np.median(dev)), "collective_ms": float(np.median(coll)),
        "collectives_per_step": sharding.collective_stats()["calls"]}


def _want_launches(cfg, prefills: int, decodes: int, tp: int = TP) -> dict:
    """Every kernel's launches (and the collectives at tp > 1) of
    ``prefills`` model prefills and ``decodes`` paged decode steps (zamba
    and xLSTM: dense-cache decode steps; at tp > 1 their split rows take
    the split-row rmsnorm's two launches in place of one rmsnorm)."""
    attn, calls = attention_kernels(cfg), prefills + decodes
    split = split_norms(cfg) if tp > 1 else 0
    recurrent = cfg.family in ("zamba", "xlstm")
    return {"flash_attention": attn * prefills,
            "paged_decode_attention": 0 if recurrent else attn * decodes,
            "decode_attention": attn * decodes if recurrent else 0,
            "ssd_scan": (cfg.n_layers * prefills if cfg.family == "zamba"
                         else 0),
            "rmsnorm": (norm_launches(cfg) - split) * calls,
            "rmsnorm_fused": fused_norm_launches(cfg) * calls,
            "rmsnorm_split": 2 * split * calls,
            "collectives": tp_collectives(cfg) * calls if tp > 1 else 0}


def _check_launches(tag: str, counts: list, wants: list) -> None:
    """Each rank's launches and collectives against its want (a rank of
    a group of one runs no collective)."""
    for r, (c, want) in enumerate(zip(counts, wants)):
        got = {k: c["launches"][k] for k in want if k != "collectives"}
        got["collectives"] = c["collectives"]["calls"]
        if got != want:
            raise AssertionError(f"{tag} rank {r}: launches {got}, want {want}")


def _tp_pass(group, fn, model, kv_dtype, tpl, reqs, server,
             lora_logits: bool = False, faults: bool = False) -> dict:
    """One ``FaaSRuntime`` over the group's mesh and the case's template
    ``server`` (every pass of a case deploys from the host pool its first
    deploy packed): deploy with the template prompt, then cold, fork, a
    prefix hit and warm, each invocation's launches per rank read alone
    (counts set to 0 on every rank just before it).  ``lora_logits``:
    the first prefill's logits through row 1 of ``tp_lora_bank`` too.
    ``faults``: then ``_tp_fetch_faults``."""
    from repro_torch.models import moe
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    cfg = model.cfg
    L = cfg.n_layers
    paged = model.supports_paged_kv
    want = _want_launches(cfg, 1, TP_NEW - 1, group.size)
    rt = FaaSRuntime(server=server, mesh=group.mesh, device=group.device,
                     n_slots=4, max_len=TP_PROMPT + TP_NEW + 24,
                     page_size=PAGE_SIZE, kv_dtype=kv_dtype,
                     keep_alive_s=3600)
    packed = server.host_buffers.get(fn.name)
    t0 = time.perf_counter()
    # zamba and xLSTM serve over the dense slot pool, which bakes no
    # template prefix: their third invocation is a plain warm one
    rt.deploy(fn, {}, template_prompt=tpl if paged else None,
              prewarm_seq=TP_PROMPT)
    out = {"pass": "int8" if kv_dtype else "paged",
           "deploy_s": time.perf_counter() - t0,
           "host_pool_reused": server.host_buffers[fn.name] is packed,
           "memory_after_deploy": group.gather(_rank_memory, rt.server),
           "requests": []}
    rt.gateway.start_pump()
    try:
        for kind, prompt in reqs:
            if kind == "fork":
                rt.evict(fn.name)
            group.gather(_rank_reset)
            with moe.watch() as calls:
                res = rt.submit(InvocationRequest(
                    fn.name, prompt, max_new_tokens=TP_NEW)).result()
            counts = group.gather(_rank_counts)
            row = {"want": kind, "kind": res.kind, "tokens": res.tokens.tolist(),
                   "ttft_s": res.ttft_s, "e2e_s": res.e2e_s,
                   "reused_prefix_len": res.reused_prefix_len,
                   "launches_per_rank": [c["launches"] for c in counts],
                   "collectives_per_rank": [c["collectives"] for c in counts],
                   "routing": tp_routing(calls)}
            del calls
            if res.fork_stats is not None:
                row["fork_per_rank"] = [
                    {"fork_s": st.fork_s, "streamed_bytes": st.streamed_bytes,
                     "reused_bytes": st.reused_bytes,
                     "replicated_bytes": st.replicated_bytes}
                    for st in (res.fork_stats.per_rank or (res.fork_stats,))]
            _check_launches(f"tp {cfg.name} {kind}", counts,
                            [want] * group.size)
            if bool(row["routing"]) != bool(cfg.n_experts) or (
                    cfg.n_experts and len(row["routing"]) != L * TP_NEW):
                raise AssertionError(f"tp {cfg.name} {kind}: "
                                     f"{len(row['routing'])} moe calls")
            out["requests"].append(row)
            print(json.dumps({"tp_request": {
                "arch": cfg.name, **{k: v for k, v in row.items()
                                     if k not in ("tokens", "routing")},
                "moe_dropped": sum(c[2] for c in row["routing"])}}))
        kinds = [r["kind"] for r in out["requests"]]
        if kinds != ["cold", "fork", "warm", "warm"]:
            raise AssertionError(f"tp invocation kinds {kinds}")
        if paged and (out["requests"][2]["reused_prefix_len"]
                      < TP_TEMPLATE - PAGE_SIZE):
            raise AssertionError("tp: the template prefix was not reused")
        if out["requests"][3]["tokens"] != out["requests"][0]["tokens"]:
            raise AssertionError("tp: warm tokens differ from cold's")
        if faults:
            out["faults"] = _tp_fetch_faults(group, rt, fn, reqs[1][1],
                                             out["requests"][1]["tokens"])
    finally:
        rt.gateway.stop_pump()
    if kv_dtype is None:
        # the first prefill's logits, from the warm engine's weights
        engine = next(w.engine for w in rt._engines.values())
        pool = engine.pool
        rows = pool.padded_len if paged else pool.max_len
        logits, _ = model.prefill(engine.params(), {"tokens": reqs[0][1][None]},
                                  model.make_cache(1, rows))
        out["logits"] = logits.float().cpu().numpy()[0]
        if lora_logits:
            logits, _ = model.prefill(engine.params(),
                                      {"tokens": reqs[0][1][None]},
                                      model.make_cache(1, pool.padded_len),
                                      adapter_bank=tp_lora_bank(model),
                                      adapter_ids=[1])
            out["lora_logits"] = logits.float().cpu().numpy()[0]
        out["decode_step_per_rank"] = group.gather(
            _rank_decode_timing, model, engine.params(), 8)
    rt.evict()
    del rt
    group.gather(_rank_release)
    return out


def _rank_fired() -> list:
    """This rank's log of the installed fault plan."""
    from repro_torch.runtime.faults import active_fault_plan
    return [(f["point"], f["visit"]) for f in active_fault_plan().fired]


def _tp_fetch_faults(group, rt, fn, prompt, want: list) -> dict:
    """A ``weight_fetch`` fault in a fork's streamer on every rank (the
    plan is installed on every rank, ``runtime.faults``): transient (the
    first fetch fails once and is retried: the fork's tokens equal the
    fault-free fork's), then permanent (three failures exhaust the
    streamer's two retries: the invocation fails typed with no request
    retry left, the workers serve on, and the next invocation is
    served with the fault-free tokens).  Every rank's log is read."""
    from repro_torch.runtime.errors import EngineFailure, WeightFetchFault
    from repro_torch.runtime.faults import FaultPlan, FaultSpec, use_fault_plan
    from repro_torch.runtime.gateway import InvocationRequest
    out = {}
    for name, times in (("transient", 1), ("permanent", 3)):
        rt.evict(fn.name)
        plan = FaultPlan([FaultSpec("weight_fetch", at=0, times=times)])
        t0 = time.perf_counter()
        with use_fault_plan(plan):
            h = rt.submit(InvocationRequest(fn.name, prompt,
                                            max_new_tokens=TP_NEW,
                                            max_retries=0))
            try:
                res = h.result()
                row = {"status": res.status, "kind": res.kind,
                       "tokens_equal": res.tokens.tolist() == want}
            except EngineFailure as e:
                row = {"status": h.status, "error": type(e).__name__,
                       "cause": type(e.__cause__).__name__}
            row["fired_per_rank"] = group.gather(_rank_fired)
        row["s"] = time.perf_counter() - t0
        nxt = rt.submit(InvocationRequest(fn.name, prompt,
                                          max_new_tokens=TP_NEW)).result()
        row["next"] = {"kind": nxt.kind,
                       "tokens_equal": nxt.tokens.tolist() == want}
        visits = [v for _, v in row["fired_per_rank"][0]]
        ok = (row["fired_per_rank"] == [row["fired_per_rank"][0]] * group.size
              and row["next"]["tokens_equal"])
        if name == "transient":
            ok = ok and row.get("tokens_equal") and visits == [0]
        else:
            ok = ok and (row.get("error"), row.get("cause")) == (
                EngineFailure.__name__, WeightFetchFault.__name__) \
                and visits == [0, 1, 2]
        print(json.dumps({"tp_fault": {"case": name, "tp": group.size,
                                       **row}}))
        if not ok:
            raise AssertionError(f"tp weight_fetch fault ({name}): {row}")
        out[name] = row
    return out


def _tp_function(arch: str, replace: dict):
    """On every rank: the model at full width under the rank's plan, its
    shard of the weights drawn on the card from the seed, and one static
    function over a host checkpoint of that shard."""
    from repro_torch.core import api as tidal
    from repro_torch.distributed import current_group
    from repro_torch.models.registry import get_config, get_model
    group = current_group()
    model = get_model(get_config(arch).replace(**replace), device=group.device,
                      plan=group.plan)
    params = model.init_params(TP_SEED, draw_on_device=True)
    fn = tidal.static_function("tp", model, params)
    del params
    _rank_release()
    return fn


# LoRA at tp = 2 (phase 15's fp32 llama3-8b case): a shared base whose
# bank targets every attention projection, three adapter functions
# attached (seed, alpha: large enough that their tokens part from the
# base's), and one merged ``lora_function``
TP_LORA_TARGETS = ("blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv",
                   "blocks.attn.wo")
TP_LORA_ADAPTERS = ((1, 20.0), (2, 40.0), (3, 60.0))
TP_LORA_RANK = 8


# bf16 LoRA at tp = 2 (phase 15's bf16 llama3-8b case): the first prefill's
# logits through bank row 1 against tp = 1's, as a share of the largest
# |logit|.  The sound gap read 1.65%; planted faults read 15.5% (rank 1's
# wq b heads swapped), 55.6% (the wo delta after the reduce) and 124.4%
# (rank 1's bank row off by one) (tools/torch_tp_fault_gap.py --case
# lora; H100)
TP_LORA_BF16_CASE = "bf16_8layers"
TP_LORA_LOGIT_BOUND = 5e-2


def tp_lora_bank(model) -> dict:
    """An adapter bank over ``TP_LORA_TARGETS`` with rows 1.. loaded from
    ``TP_LORA_ADAPTERS`` (under a plan, every rank's shard of it)."""
    from repro_torch.core import api as tidal
    from repro_torch.models.adapters import load_adapter, make_adapter_bank
    bank = make_adapter_bank(model, TP_LORA_TARGETS,
                             len(TP_LORA_ADAPTERS) + 1, TP_LORA_RANK)
    for i, (seed, alpha) in enumerate(TP_LORA_ADAPTERS, start=1):
        ad = tidal.lora_checkpoint(f"tp-ad{seed}", model, list(TP_LORA_TARGETS),
                                   rank=TP_LORA_RANK, seed=seed)
        load_adapter(bank, i, ad, model, alpha=alpha)
    return bank


def _tp_lora_function(arch: str, replace: dict):
    """On every rank: a merged ``lora_function`` (its query projection
    adapted per event) over the rank's shard of the seed's weights."""
    from repro_torch.core import api as tidal
    from repro_torch.distributed import current_group
    from repro_torch.models.registry import get_config, get_model
    group = current_group()
    model = get_model(get_config(arch).replace(**replace), device=group.device,
                      plan=group.plan)
    params = model.init_params(TP_SEED, draw_on_device=True)
    fn = tidal.lora_function("tp-lora", model, params, ["blocks.attn.wq"],
                             n_adapters=2, rank=TP_LORA_RANK)
    del params
    _rank_release()
    return fn


def _tp_lora(group, fn, model, arch: str, replace: dict) -> dict:
    """LoRA on the group's ranks: ``fn`` as a shared base with three
    attached adapter functions served together (the adapter rows of every
    decode step recorded), then a merged ``lora_function`` cold, forked
    onto another adapter and warm; every rank's launches exact."""
    from repro_torch.core import api as tidal
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    cfg = model.cfg
    tp = group.size
    kw = dict(mesh=group.mesh, device=group.device, n_slots=4,
              max_len=TP_PROMPT + TP_NEW + 24, page_size=PAGE_SIZE,
              trace_seq=TP_PROMPT, keep_alive_s=3600)
    rt = FaaSRuntime(**kw)
    rt.deploy_shared_base(fn, n_adapters=len(TP_LORA_ADAPTERS) + 1,
                          rank=TP_LORA_RANK, target_paths=TP_LORA_TARGETS,
                          prewarm_seq=TP_PROMPT)
    names = [fn.name]
    for i, (seed, alpha) in enumerate(TP_LORA_ADAPTERS, start=1):
        ad = tidal.lora_checkpoint(f"tp-ad{seed}", model, list(TP_LORA_TARGETS),
                                   rank=TP_LORA_RANK, seed=seed)
        rt.attach_adapter(f"tp-ad{i}", fn.name, ad, alpha=alpha)
        names.append(f"tp-ad{i}")
    rng = np.random.default_rng(21)
    prompts = {n: rng.integers(1, cfg.vocab_size, TP_PROMPT).astype(np.int32)
               for n in names}
    rows_per_step = []
    decode = model.decode_step_paged

    def recording(*args, **kwargs):
        ids = kwargs.get("adapter_ids")
        if ids is not None:
            rows_per_step.append(sorted(
                set(torch.as_tensor(ids).cpu().tolist()) - {0}))
        return decode(*args, **kwargs)

    model.decode_step_paged = recording
    try:
        group.gather(_rank_reset)
        handles = {n: rt.submit(InvocationRequest(n, p, max_new_tokens=TP_NEW))
                   for n, p in prompts.items()}
        res = {n: h.result() for n, h in handles.items()}
        counts = group.gather(_rank_counts)
    finally:
        del model.decode_step_paged
    engines = [w.engine for w in rt._engines.values()]
    want = _want_launches(cfg, sum(e.n_prefill_calls for e in engines),
                          sum(e.n_decode_steps for e in engines))
    if tp == 1:
        want["collectives"] = 0
    _check_launches(f"tp {tp} lora shared base", counts, [want] * tp)
    # the base on each adapter function's prompt: what the adapter's
    # tokens must part from
    base_on = {n: rt.submit(InvocationRequest(
        fn.name, prompts[n], max_new_tokens=TP_NEW)).result().tokens.tolist()
        for n in names[1:]}
    bank = rt._engines[("__adapters__", fn.name, 0)]
    shared = {"tokens": {n: r.tokens.tolist() for n, r in res.items()},
              "base_on_prompt": base_on,
              "kinds": {n: r.kind for n, r in res.items()},
              "rows": dict(bank.adapter_ids),
              "rows_per_step": rows_per_step,
              "launches_per_rank": [c["launches"] for c in counts],
              "collectives_per_rank": [c["collectives"]["calls"]
                                       for c in counts]}
    rt.evict()
    del rt, bank
    group.gather(_rank_release)

    merged_fn = group.build(_tp_lora_function, arch, replace)
    rt = FaaSRuntime(**kw)
    rt.deploy(merged_fn, {"adapter": "adapter-0"}, prewarm_seq=TP_PROMPT)
    want = _want_launches(cfg, 1, TP_NEW - 1)
    if tp == 1:
        want["collectives"] = 0
    merged = []
    for kind, adapter in (("cold", "adapter-0"), ("fork", "adapter-1"),
                          ("warm", "adapter-1")):
        if kind == "fork":
            rt.evict()
        group.gather(_rank_reset)
        r = rt.submit(InvocationRequest(
            merged_fn.name, prompts[fn.name], event={"adapter": adapter},
            max_new_tokens=TP_NEW)).result()
        counts = group.gather(_rank_counts)
        _check_launches(f"tp {tp} lora merged {kind}", counts, [want] * tp)
        row = {"want": kind, "kind": r.kind, "tokens": r.tokens.tolist(),
               "ttft_s": r.ttft_s,
               "launches_per_rank": [c["launches"] for c in counts]}
        if r.fork_stats is not None:
            row["dynamic_bytes_per_rank"] = [
                st.dynamic_bytes for st in (r.fork_stats.per_rank
                                            or (r.fork_stats,))]
        merged.append(row)
    rt.evict()
    del rt, merged_fn
    group.gather(_rank_release)
    if [m["kind"] for m in merged] != ["cold", "fork", "warm"]:
        raise AssertionError(f"tp lora merged kinds {merged}")
    return {"shared": shared, "merged": merged}


# llama3-8b under a ``prefer_seq`` plan at tp = 2 (each rank holds half the
# positions of every KV head; decode through ``decode_attention_slice``
# and ``decode_merge_ranks``), beside one process's dense decode: two
# prompts of TP_PROMPT tokens, then TP_SEQ_STEPS greedy steps over a
# cache of TP_SEQ_ROWS rows
TP_SEQ_CASES = ("fp32_2layers", "bf16_8layers")
TP_SEQ_STEPS = 16
TP_SEQ_ROWS = 128


def _tp_seq_decode(arch: str, replace: dict) -> dict:
    """On every rank: the model under the rank's plan with ``prefer_seq``
    (one process: no plan), weights drawn on the card from the seed, a
    prefill of two prompts and ``TP_SEQ_STEPS`` greedy decode steps; the
    tokens, the first logits, the launches and the last step's
    collectives by kind and bytes."""
    from repro_torch.distributed import current_group, sharding
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_config, get_model
    group = current_group()
    plan = (dataclasses.replace(group.plan, prefer_seq=True)
            if group.size > 1 else None)
    model = get_model(get_config(arch).replace(**replace), device=group.device,
                      plan=plan)
    params = model.init_params(TP_SEED, draw_on_device=True)
    _, reqs = tp_requests(model.cfg.vocab_size)
    prompts = np.stack([reqs[0][1], reqs[1][1]])
    ops.reset_launch_counts()
    cache = model.make_cache(len(prompts), TP_SEQ_ROWS)
    logits, cache = model.prefill(params, {"tokens": prompts}, cache)
    first = logits.float().cpu().numpy()
    tokens = [logits.argmax(-1)]
    for i in range(TP_SEQ_STEPS):
        sharding.reset_collective_stats()
        logits, cache = model.decode_step(
            params, cache, {"tokens": tokens[-1][:, None]},
            prompts.shape[1] + i)
        tokens.append(logits.argmax(-1))
    torch.cuda.synchronize()
    stats = sharding.collective_stats()
    out = {"tokens": torch.stack(tokens, 1).cpu().tolist(), "logits": first,
           "launches": ops.launch_counts(),
           "collectives": {"kinds": stats["kinds"],
                           "bytes_by_kind": stats["bytes_by_kind"]},
           "cache_rows": int(cache["k"].shape[2])}
    del model, params, cache
    _rank_release()
    return out


def tp_seq_collectives(cfg, batch: int) -> dict:
    """One decode step's collectives at ``TP`` ranks under ``prefer_seq``
    (a dense or moe GQA model): per layer two ``all_gather`` (q and the
    new token's K/V rows, in the model's dtype; the ranks' (o, lse),
    fp32), beside the one-process plan's 2L + 2 fp32 ``all_reduce`` (the
    embedding's and each layer's two [B, D] sums, the head's [B, V]
    gather).  Bytes: an all_gather's gathered output, an all_reduce's
    buffer."""
    from repro_torch.models.transformer import torch_dtype
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    elt = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    Hr, KVr = H // TP, max(KV // TP, 1)
    gather = L * (TP * batch * (Hr + 2 * KVr) * hd * elt
                  + TP * batch * H * (hd + 1) * 4)
    return {"kinds": {"all_reduce": 2 * L + 2, "all_gather": 2 * L},
            "bytes_by_kind": {"all_reduce": (1 + 2 * L) * batch * D * 4
                              + batch * V * 4, "all_gather": gather}}


def tp_seq_parity(tag: str, one: dict, ranks: list, cfg, card: str) -> dict:
    """phase 15's ``prefer_seq`` case against one process: fp32 greedy
    tokens equal, bf16 first logits within the case's bound; on every
    rank the slice and merge entries once per layer per step, no dense
    decode kernel, and the reckoned collectives of a step."""
    L = cfg.n_layers
    gap = max(float(np.abs(r["logits"] - one["logits"]).max()
                    / np.abs(one["logits"]).max()) for r in ranks)
    same = [r["tokens"] == one["tokens"] for r in ranks]
    res = {"case": tag, "card": card, "steps": TP_SEQ_STEPS,
           "logit_gap_of_max": gap, "tokens_equal": same,
           "token_agreement": float(np.mean(
               [np.mean(np.equal(r["tokens"], one["tokens"])) for r in ranks])),
           "cache_rows_per_rank": [r["cache_rows"] for r in ranks],
           "collectives": ranks[0]["collectives"]}
    print(json.dumps({"tp_prefer_seq": res}))
    want = tp_seq_collectives(cfg, 2)
    for r, got in enumerate(ranks):
        c = got["launches"]
        if (c["decode_attention_slice"], c["decode_merge_ranks"],
                c["decode_attention"], c["flash_attention"]) != (
                L * TP_SEQ_STEPS, L * TP_SEQ_STEPS, 0, L):
            raise AssertionError(f"tp prefer_seq {tag} rank {r}: launches {c}")
        if got["collectives"] != want:
            raise AssertionError(f"tp prefer_seq {tag} rank {r}: collectives "
                                 f"{got['collectives']} != {want}")
        if got["cache_rows"] != TP_SEQ_ROWS // TP:
            raise AssertionError(f"tp prefer_seq {tag}: {got['cache_rows']} "
                                 "cache rows on a rank")
    if "fp32" in tag and not all(same):
        raise AssertionError(f"tp prefer_seq {tag}: tokens differ from one "
                             f"process: {res}")
    if "fp32" not in tag and gap > tp_logit_bound(cfg.name):
        raise AssertionError(f"tp prefer_seq {tag}: logits {gap} of the "
                             f"largest apart (bound {tp_logit_bound(cfg.name)})")
    return res


# whisper-medium at full width and depth under a serving plan (phase 15):
# (tag, configuration); a prefill of TP_WHISPER_BATCH sequences of the
# 30 s window's 1,500 frames and a WHISPER_PROMPT-token prompt, then
# TP_WHISPER_STEPS greedy decode steps, through ``Model`` (the
# sequential Engine takes no plan for enc-dec, as the reference's)
WHISPER_ARCH = "whisper-medium"
TP_WHISPER_CASES = (("whisper_fp32", {"dtype": "float32"}),
                    ("whisper_bf16", {}))
TP_WHISPER_BATCH = 2
TP_WHISPER_STEPS = 16


def _tp_whisper(replace: dict) -> dict:
    """On every rank: whisper-medium under the rank's plan (one process:
    no plan), weights drawn on the card from the seed, the prefill and
    greedy decode steps; the tokens, the first logits, the rank's heads,
    its launches and collectives (the prefill's and all)."""
    from repro_torch.distributed import current_group, sharding
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_config, get_model
    group = current_group()
    model = get_model(get_config(WHISPER_ARCH).replace(**replace),
                      device=group.device,
                      plan=group.plan if group.size > 1 else None)
    params = model.init_params(TP_SEED, draw_on_device=True)
    cfg, B = model.cfg, TP_WHISPER_BATCH
    rng = np.random.default_rng(TP_SEED)
    frames = torch.from_numpy((rng.standard_normal(
        (B, WHISPER_FRAMES, cfg.d_model)) * 0.1).astype(np.float32))
    prompts = rng.integers(0, cfg.vocab_size, (B, WHISPER_PROMPT)
                           ).astype(np.int32)
    ops.reset_launch_counts()
    sharding.reset_collective_stats()
    cache = model.make_cache(B, WHISPER_FRAMES)
    logits, cache = model.prefill(
        params, {"frames": frames.to(group.device), "tokens": prompts}, cache)
    torch.cuda.synchronize()
    prefill = {"launches": ops.launch_counts(),
               "collectives": sharding.collective_stats()["calls"]}
    first = logits.float().cpu().numpy()
    tokens = [logits.argmax(-1)]
    for i in range(TP_WHISPER_STEPS):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tokens[-1][:, None]}, WHISPER_PROMPT + i)
        tokens.append(logits.argmax(-1))
    torch.cuda.synchronize()
    out = {"tokens": torch.stack(tokens, 1).cpu().tolist(), "logits": first,
           "heads": [model.local_cfg.n_heads, model.local_cfg.n_kv_heads],
           "prefill": prefill, "launches": ops.launch_counts(),
           "collectives": sharding.collective_stats()["calls"]}
    del model, params, cache
    _rank_release()
    return out


def tp_whisper_parity(tag: str, one: dict, ranks: list, card: str) -> dict:
    """phase 15's whisper case against one process: on every rank 8 of
    the 16 heads, fp32 greedy tokens equal, bf16 first logits within
    ``TP_BF16_LOGIT_BOUND``; per rank 3L flash launches in the prefill
    and 2L ``decode_attention`` per step (L = 24 decoder layers; the
    encoder's 24 in the 3L), no rmsnorm; collectives 2 per encoder layer
    and 3 per decoder layer in the prefill (the vocabulary is odd: the
    embedding and head are whole), 3 per decoder layer per step.  The
    rank's kernels run on every rank in both runs (the one process's
    launches are held too)."""
    from repro_torch.models.registry import get_config
    cfg = get_config(WHISPER_ARCH)
    Le, Ld, n = cfg.n_layers, cfg.dec_layers, TP_WHISPER_STEPS
    # a vocabulary the ranks split adds the embedding's sum and the head's
    # gather to every call (whisper-medium's 51,865 does not split)
    vocab = 2 if cfg.vocab_size % TP == 0 else 0
    gap = max(float(np.abs(r["logits"] - one["logits"]).max()
                    / np.abs(one["logits"]).max()) for r in ranks)
    same = [r["tokens"] == one["tokens"] for r in ranks]
    res = {"case": tag, "card": card, "steps": n, "batch": TP_WHISPER_BATCH,
           "frames": WHISPER_FRAMES, "logit_gap_of_max": gap,
           "tokens_equal": same, "heads_per_rank": [r["heads"] for r in ranks],
           "collectives_per_rank": [r["collectives"] for r in ranks]}
    print(json.dumps({"tp_whisper": res}))
    want_prefill = {"flash_attention": Le + 2 * Ld, "decode_attention": 0,
                    "rmsnorm": 0}
    want_all = {"flash_attention": Le + 2 * Ld, "decode_attention": 2 * Ld * n,
                "rmsnorm": 0}
    for r, got in enumerate([one] + ranks):
        for what, want in ((got["prefill"]["launches"], want_prefill),
                           (got["launches"], want_all)):
            seen = {k: what[k] for k in want}
            if seen != want:
                raise AssertionError(f"tp {tag} rank {r}: launches {seen}, "
                                     f"want {want}")
    for r, got in enumerate(ranks):
        if got["heads"] != [cfg.n_heads // TP] * 2:
            raise AssertionError(f"tp {tag} rank {r}: heads {got['heads']}")
        if (got["prefill"]["collectives"], got["collectives"]) != (
                2 * Le + 3 * Ld + vocab,
                2 * Le + 3 * Ld + vocab + (3 * Ld + vocab) * n):
            raise AssertionError(f"tp {tag} rank {r}: collectives "
                                 f"{got['prefill']['collectives']} / "
                                 f"{got['collectives']}")
    if "fp32" in tag and not all(same):
        raise AssertionError(f"tp {tag}: tokens differ from one process: {res}")
    if "fp32" not in tag and gap > TP_BF16_LOGIT_BOUND:
        raise AssertionError(f"tp {tag}: logits {gap} of the largest apart "
                             f"(bound {TP_BF16_LOGIT_BOUND})")
    return res


# the case the two runs of phase 15 never hold at once (``tp_runs``), and
# how long the tp = 2 run waits for the one process to end before it
TP_GATED = "mla_bf16_1layer"
TP_GATE_TIMEOUT_S = 500.0


def _wait_for(gate: str, timeout_s: float = TP_GATE_TIMEOUT_S) -> float:
    """Seconds until the file ``gate`` exists; raises after ``timeout_s``."""
    t0 = time.perf_counter()
    while not Path(gate).exists():
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"{gate} did not appear in {timeout_s} s")
        time.sleep(0.2)
    return time.perf_counter() - t0


def _tp_rank(group, cases: tuple, gate: str | None = None) -> dict | None:
    """One rank of the tensor-parallel phase (``tp`` 1 or 2): per case
    ``(tag, architecture, configuration, arenas)``, every rank builds its
    function (``group.build``), then a pass per arena (None: the model's
    dtype) runs on the controller.  ``gate``: the controller waits for
    that file before ``TP_GATED``'s case (the workers wait in
    ``group.serve``)."""
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.models.registry import get_config
    from repro_torch.utils import tree_bytes
    if not group.is_controller:
        group.serve()
        return None
    out = {}

    def whisper():
        if TP_WHISPER_CASES[0][0] in out:
            return
        for tag, replace in TP_WHISPER_CASES:
            t0 = time.perf_counter()
            out[tag] = group.gather(_tp_whisper, replace)
            print(f"  tp {group.size} {tag}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)

    for tag, arch, replace, arenas in cases:
        if gate and tag == TP_GATED:
            whisper()             # before the wait for the one process
            out["gate_wait_s"] = _wait_for(gate)
        t0 = time.perf_counter()
        fn = group.build(_tp_function, arch, replace)
        model = fn.model
        cfg, local = model.cfg, model.local_cfg
        first, end = local.expert_range
        info = {"arch": arch, "layers": cfg.n_layers,
                "reduced": (None if "n_layers" not in replace else
                            f"n_layers {get_config(arch).n_layers} -> "
                            f"{replace['n_layers']}"),
                "dtype": cfg.dtype, "tp": group.size,
                "backend": group.backend,
                "local_heads": [local.n_heads, local.n_kv_heads],
                "local_experts": end - first,
                "local_widths": {"ssm_heads": local.ssm_heads,
                                 "mamba": local.mamba_width,
                                 "mlstm": local.mlstm_width,
                                 "slstm": local.slstm_width,
                                 "slstm_mlp": local.slstm_mlp_width},
                "shard_bytes": tree_bytes(model.param_specs()),
                "reckoned_bytes": tp_reckoned_bytes(cfg, group.size),
                "init_s": time.perf_counter() - t0}
        if model.supports_paged_kv:
            info["arena_bytes_per_token_per_layer"] = group.gather(
                _rank_arena_bytes, model)
        else:
            info["state_bytes_per_slot"] = group.gather(_rank_state_bytes,
                                                        model)
        if info["shard_bytes"] != info["reckoned_bytes"]:
            raise AssertionError(f"tp {tag}: {info['shard_bytes']} bytes per "
                                 f"rank, reckoned {info['reckoned_bytes']}")
        print(json.dumps({"tp_model": {"case": tag, **info}}))
        tpl, reqs = tp_requests(cfg.vocab_size)
        # one template server per case: its passes deploy from one host
        # pool, packed and page-locked once
        server = TemplateServer(trace_batch=1, trace_seq=TP_PROMPT,
                                plan=group.plan)
        out[tag] = {"model": info,
                    "passes": [_tp_pass(group, fn, model, kv, tpl, reqs, server,
                                        lora_logits=tag == TP_LORA_BF16_CASE,
                                        faults=(tag == TP_FAULT_CASE and i == 0
                                                and group.size > 1))
                               for i, kv in enumerate(arenas)]}
        del server
        if tag == TP_LORA_CASE:
            out[tag]["lora"] = _tp_lora(group, fn, model, arch, replace)
        del fn, model
        group.gather(_rank_release)
        if tag in TP_SEQ_CASES:
            out[tag]["seq"] = group.gather(_tp_seq_decode, arch, replace)
    whisper()
    out["guard_ops"] = group.channel.n_ops
    return out


# two tensor-parallel instances (``ServingMesh(2, 2)``: 4 ranks sharing
# the card over gloo) serving phase 15's fp32 llama3-8b case: one static
# function, a new engine per event, the second instance taken once the
# first holds more than ``TP_LOCALITY_EXTRA`` engines over it.  Per
# request (event, prompt index into ``tp_requests``' list, instance)
TP_INSTANCES = 2
TP_LOCALITY_EXTRA = 1
TP_INSTANCE_REQUESTS = ((0, 0, 0), (1, 1, 0), (2, 0, 1), (0, 0, 0),
                        (1, 2, 0), (2, 2, 1))


def _tp_instances_rank(group, arch: str, replace: dict) -> dict | None:
    """The controller of ``ServingMesh(2, 2)``: every rank builds its
    function, then cold on instance 0, a fork kept there by locality, a
    fork routed to instance 1 (its template prefix baked there at that
    fork), warm, and a template-prefix hit on each instance; every rank's
    launches read per request (the other group's ranks launch nothing),
    the fork bytes and page-locked bytes per rank group, and every rank's
    pools back at their baseline after ``evict``."""
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    from repro_torch.utils import tree_bytes
    if not group.is_controller:
        group.serve()
        return None
    t0 = time.perf_counter()
    fn = group.build(_tp_function, arch, replace)
    model = fn.model
    cfg, tp = model.cfg, group.size
    weights = tree_bytes(model.param_specs()) * tp       # one group's
    tpl, reqs = tp_requests(cfg.vocab_size)
    rt = FaaSRuntime(mesh=group.mesh, device=group.device, n_slots=4,
                     max_len=TP_PROMPT + TP_NEW + 24, page_size=PAGE_SIZE,
                     trace_seq=TP_PROMPT, keep_alive_s=3600,
                     locality_max_extra_load=TP_LOCALITY_EXTRA)
    rt.deploy(fn, {}, template_prompt=tpl, prewarm_seq=TP_PROMPT)
    out = {"ranks": [list(i.ranks) for i in rt.instances],
           "init_s": time.perf_counter() - t0, "requests": []}
    memory = group.gather(_rank_memory, rt.server)
    out["pinned_per_group"] = [
        sum(m["registered_bytes"] for m in memory[i * tp:(i + 1) * tp])
        for i in range(TP_INSTANCES)]
    out["group_weight_bytes"] = weights
    for pinned in out["pinned_per_group"]:
        if not weights <= pinned <= 1.05 * weights:
            raise AssertionError(f"tp instances: {pinned} pinned bytes in a "
                                 f"rank group of {weights} weight bytes")
    baked = set()
    for event, idx, inst in TP_INSTANCE_REQUESTS:
        group.gather(_rank_reset)
        res = rt.submit(InvocationRequest(
            fn.name, reqs[idx][1], event={"v": event},
            max_new_tokens=TP_NEW)).result()
        counts = group.gather(_rank_counts)
        (placed,) = [w.instance for k, w in rt._engines.items()
                     if k == (fn.name, (("v", event),))]
        if placed != inst:
            raise AssertionError(f"tp instances: event {event} on instance "
                                 f"{placed}, want {inst}")
        # the first fork onto instance 1 bakes the template prefix there
        bake = res.kind != "warm" and inst not in baked and inst > 0
        baked.add(inst)
        serving = _want_launches(cfg, 1 + bake, TP_NEW - 1)
        idle = {k: 0 for k in serving}
        _check_launches(f"tp instances event {event}", counts, [
            serving if r // tp == inst else idle
            for r in range(TP_INSTANCES * tp)])
        row = {"event": event, "prompt": reqs[idx][0], "instance": placed,
               "kind": res.kind, "tokens": res.tokens.tolist(),
               "ttft_s": res.ttft_s, "reused_prefix_len": res.reused_prefix_len,
               "launches_per_rank": [c["launches"] for c in counts],
               "collectives_per_rank": [c["collectives"]["calls"]
                                        for c in counts]}
        if res.fork_stats is not None:
            row["fork_per_rank"] = [
                {"fork_s": st.fork_s, "streamed_bytes": st.streamed_bytes,
                 "reused_bytes": st.reused_bytes}
                for st in res.fork_stats.per_rank]
        out["requests"].append(row)
        print(json.dumps({"tp_instance_request": {
            k: v for k, v in row.items() if k != "tokens"}}))
    kinds = [r["kind"] for r in out["requests"]]
    if kinds != ["cold", "fork", "fork", "warm", "warm", "warm"]:
        raise AssertionError(f"tp instances kinds {kinds}")
    for r in out["requests"][4:]:
        if r["reused_prefix_len"] < TP_TEMPLATE - PAGE_SIZE:
            raise AssertionError(f"tp instances: no prefix hit on instance "
                                 f"{r['instance']}")
    out["prefix_handles"] = sorted(k[1] for k in rt._prefix_handles)
    if out["prefix_handles"] != list(range(TP_INSTANCES)):
        raise AssertionError(f"tp instances: bakes {out['prefix_handles']}")
    # every rank's pool: all slots back after evict (the template's pages
    # still pinned), every page back once the template is released
    out["pools_per_rank"] = {}
    for stage, pinned in (("evict", True), ("release", False)):
        if pinned:
            rt.evict()
        else:
            rt.release_template_prefix(fn.name)
        states = [group.gather(_pool_state, pool) for pool in rt._pools.values()]
        for pool, ranks in zip(rt._pools.values(), states):
            free = pool.n_pages - 1 - pinned * pool.blocks_for(TP_TEMPLATE)
            if len(states) != TP_INSTANCES or ranks != [
                    [pool.n_slots, free, free]] * tp:
                raise AssertionError(f"tp instances after {stage}: {states}")
        out["pools_per_rank"][stage] = states
    del rt, fn, model
    group.gather(_rank_release)
    out["guard_ops"] = [ch.n_ops for ch in group.channels]
    return out


def _pool_state(pool) -> list:
    """One rank's free slots, free pages and available pages."""
    return [pool.n_free_slots, pool.n_free_pages, pool.n_available_pages]


def tp_instances_run() -> dict:
    """``_tp_instances_rank`` on ``TP_INSTANCES * TP`` new processes."""
    from repro_torch.distributed import spawn
    tag, arch, replace, *_ = next(c for c in TP_CASES if c[0] == TP_LORA_CASE)
    t0 = time.perf_counter()
    out = spawn(_tp_instances_rank, TP, (arch, replace), data=TP_INSTANCES,
                backend=TP_BACKEND, device="cuda", guard=True, timeout_s=900)
    out["case"] = tag
    out["wall_s"] = time.perf_counter() - t0
    return out


def tp_run(tp: int, gate: str | None = None) -> dict:
    """``_tp_rank`` on ``tp`` new processes (2 ranks share the one card),
    the cases in ``tp``'s order (``tp_runs``)."""
    from repro_torch.distributed import spawn
    cases = [(tag, arch, replace, two if tp > 1 else one)
             for tag, arch, replace, two, one in TP_CASES]
    if tp == 1:
        cases.sort(key=lambda c: c[0] != TP_GATED)
    else:
        cases.sort(key=lambda c: (c[0] == TP_GATED,
                                  c[1] not in (ZAMBA_ARCH, XLSTM_ARCH)))
    t0 = time.perf_counter()
    out = spawn(_tp_rank, tp, (tuple(cases), gate), backend=TP_BACKEND,
                device="cuda", guard=True, timeout_s=900)
    out["wall_s"] = time.perf_counter() - t0
    return out


def tp_runs() -> dict:
    """The ``tp = 1`` and ``tp = 2`` runs side by side: the one process
    takes ``TP_GATED``'s case first (deepseek-v3 at one layer: its copies
    peak at ~40 GB of the card) while the two ranks serve the recurrent,
    then the dense and moe cases (at most ~24 GB together); the ranks
    take ``TP_GATED``'s case (~31 GB each) once the one process has
    ended, so no two deepseek-v3 cases share the card."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        gate = str(Path(d) / "tp1_ended")
        two = Background(tp_run, TP, gate)
        try:
            one = tp_run(1)
        finally:
            Path(gate).touch()
            runs = {TP: two.join()}
    runs[1] = one
    return runs


# (tag, architecture, configuration, arenas at tp = 2, arenas at tp = 1):
# in bf16 both serve the fp arena only, all that the bf16 comparison
# reads (the int8 arena at tp = 2 is held in fp32).  bf16 runs 8 of llama3-8b's 32 layers: the whole script keeps to
# its time limit (phase 16 after it; at 32 layers the script took
# 1,165.8 s of its 1,200 on a slow host).  phi3.5-moe-42b-a6.6b runs 2
# (fp32) and 4 (bf16) of its 32 layers, deepseek-v3-671b 1 of 61 (26.7 GB
# at tp = 1): neither fits one card whole.  zamba2-2.7b and xlstm-1.3b
# (dense slot pool: no int8 arena, no template prefix) run one unit in
# fp32 (6 Mamba2 blocks and the shared block; 7 mLSTM blocks and an
# sLSTM block) and two in bf16 (12 of 54 blocks; 16 of 48), depth cut
# for the script's time limit, width never
TP_BF16_LAYERS = 8
PHI_ARCH, DSV3_ARCH = "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"
# smollm-135m at full width and depth: 9 query / 3 KV heads split
# unevenly over the two ranks (6 / 2 and 3 / 1)
SMOLLM_ARCH = "smollm-135m"
ZAMBA_ARCH, XLSTM_ARCH = "zamba2-2.7b", "xlstm-1.3b"
TP_CASES = (("fp32_2layers", "llama3-8b", {"n_layers": 2, "dtype": "float32"},
             (None, "int8"), (None, "int8")),
            ("bf16_8layers", "llama3-8b", {"n_layers": TP_BF16_LAYERS},
             (None,), (None,)),
            ("moe_fp32_2layers", PHI_ARCH, {"n_layers": 2, "dtype": "float32"},
             (None, "int8"), (None, "int8")),
            ("moe_bf16_4layers", PHI_ARCH, {"n_layers": 4}, (None,), (None,)),
            ("mla_bf16_1layer", DSV3_ARCH, {"n_layers": 1}, (None,), (None,)),
            ("zamba_fp32_1unit", ZAMBA_ARCH, {"n_layers": 6,
                                              "dtype": "float32"},
             (None,), (None,)),
            ("xlstm_fp32_1unit", XLSTM_ARCH, {"n_layers": 8,
                                              "dtype": "float32"},
             (None,), (None,)),
            ("zamba_bf16_2units", ZAMBA_ARCH, {"n_layers": 12}, (None,),
             (None,)),
            ("xlstm_bf16_2units", XLSTM_ARCH, {"n_layers": 16}, (None,),
             (None,)),
            ("smollm_fp32_30layers", SMOLLM_ARCH, {"dtype": "float32"},
             (None,), (None,)),
            ("smollm_bf16_30layers", SMOLLM_ARCH, {}, (None,), (None,)))
# the case whose tp = 1 and tp = 2 runs serve LoRA too (``_tp_lora``)
TP_LORA_CASE = "fp32_2layers"
# the case whose first pass at tp = 2 takes the weight_fetch faults
TP_FAULT_CASE = "fp32_2layers"
# what one rank holds at tp = 2: (query heads, KV heads), whole experts
TP_LOCAL = {"llama3-8b": ([16, 4], 0), PHI_ARCH: ([16, 4], 8),
            DSV3_ARCH: ([64, 64], 128), ZAMBA_ARCH: ([16, 16], 0),
            XLSTM_ARCH: ([2, 2], 0), SMOLLM_ARCH: ([6, 2], 0)}
# and its recurrent widths at tp = 2: zamba2's 40 of 80 Mamba2 heads
# (2,560 of 5,120 channels); xlstm-1.3b's 2 of 4 heads (mLSTM 2,048 of
# 4,096, sLSTM 1,024 of 2,048) and half its sLSTM post-MLP (1,365 of 2,730)
TP_LOCAL_WIDTHS = {ZAMBA_ARCH: {"ssm_heads": 40, "mamba": 2560},
                   XLSTM_ARCH: {"mlstm": 2048, "slstm": 1024,
                                "slstm_mlp": 1365}}


def tp_logit_bound(arch: str) -> float:
    """The bound on ``arch``'s bf16 first-logit gap between tp = 2 and 1."""
    return {DSV3_ARCH: TP_MLA_LOGIT_BOUND, ZAMBA_ARCH: TP_ZAMBA_LOGIT_BOUND,
            XLSTM_ARCH: TP_XLSTM_LOGIT_BOUND}.get(arch, TP_BF16_LOGIT_BOUND)


def phase_tp(device) -> dict:
    """llama3-8b, phi3.5-moe (expert parallelism) and deepseek-v3 (MLA
    by heads over a replicated latent arena, experts by expert) at full
    width served tensor-parallel by 2 ranks sharing the card (gloo),
    through ``FaaSRuntime(mesh=ServingMesh(1, 2))``: fp32 at 2 layers
    (llama3-8b, phi3.5-moe) with greedy tokens equal to ``tp = 1`` (cold,
    fork, warm, prefix hit; fp and int8 arenas) and, for phi3.5-moe, the
    controller's expert ids, ``keep`` masks and dropped pairs equal to
    ``tp = 1``'s on every moe call; then bf16 (llama3-8b at 8 of 32
    layers, phi3.5-moe at 4, deepseek-v3 at 1 of 61) with the first
    prefill's logits within ``tp_logit_bound`` of ``tp = 1``'s (5%;
    deepseek-v3 2%) and
    the share of equal greedy tokens over the fp arena (the ``tp = 1``
    side serves no int8 pass in bf16).  deepseek-v3 runs no fp32 case
    here: one fp32 layer is ~53 GB per copy and a fork takes a second,
    so its fp32 parity at tp = 2 is held on the CPU only
    (``tests/test_torch_tp_moe.py``).  The ``tp = 1`` run is a process of
    its own too.  Launches and collectives (2L + 2 per model call) per
    rank, each rank's weight bytes against ``tp_reckoned_bytes``, the
    latent arena's bytes per token per layer on each rank, the divergence
    guard on every op, fork bytes and pinned bytes per rank, the decode
    step's host, device-span and collective ms per rank.  zamba2-2.7b
    and xlstm-1.3b over the dense slot pool: fp32 at one unit with
    tokens equal to ``tp = 1``, bf16 at two units within
    ``tp_logit_bound``, each rank's widths (``TP_LOCAL_WIDTHS``), the
    split-row rmsnorm's launches and ``tp_collectives`` per call.  Then
    LoRA (``_tp_lora``, ``tp_lora_parity``; the bf16 bank-row logits
    against ``TP_LORA_LOGIT_BOUND``) and two rank groups of 2 ranks
    (``tp_instances_run``, ``tp_instances_parity``)."""
    del device
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    torch.cuda.empty_cache()
    out = {"backend": TP_BACKEND, "card": card,
           "note": f"{TP} ranks sharing one card"}
    print(json.dumps({"tp_backend": TP_BACKEND, "why": "NCCL refuses two "
                      "ranks on one device (Duplicate GPU detected)"}))
    runs = tp_runs()
    instances = tp_instances_run()
    # deploys from one host pool per case: a case's first pass packs and
    # page-locks it, its int8 pass reuses it (PR 27 packed it per pass)
    deploys = {str(k): {kind: [p["deploy_s"] for tag, *_ in TP_CASES
                               for p in v[tag]["passes"]
                               if p["host_pool_reused"] == reused]
                        for kind, reused in (("packed", False),
                                             ("reused", True))}
               for k, v in runs.items()}
    print(json.dumps({"tp_deploys": deploys}))
    out["deploys"] = deploys
    out["wall_s"] = {str(k): v["wall_s"] for k, v in runs.items()}
    out["wall_s"]["instances"] = instances["wall_s"]
    out["gate_wait_s"] = runs[TP].get("gate_wait_s")
    print(f"  tp walls: {out['wall_s']}, tp = 2 waited "
          f"{out['gate_wait_s']} s for tp = 1", file=sys.stderr, flush=True)
    out["guard_ops"] = runs[TP]["guard_ops"]
    from repro_torch.models.registry import get_config
    for tag, arch, replace, *_ in TP_CASES:
        one, two = runs[1][tag], runs[TP][tag]
        heads, experts = TP_LOCAL[arch]
        if (two["model"]["local_heads"], two["model"]["local_experts"]) != (
                heads, experts):
            raise AssertionError(f"tp {tag}: heads {two['model']['local_heads']}"
                                 f", experts {two['model']['local_experts']}")
        widths = {k: two["model"]["local_widths"][k]
                  for k in TP_LOCAL_WIDTHS.get(arch, {})}
        if widths != TP_LOCAL_WIDTHS.get(arch, {}):
            raise AssertionError(f"tp {tag}: rank widths {widths}")
        steps = [d["collectives_per_step"] for d in
                 two["passes"][0]["decode_step_per_rank"]]
        if steps != [tp_collectives(get_config(arch).replace(**replace))] * TP:
            raise AssertionError(f"tp {tag}: {steps} collectives per decode "
                                 "step")
        if arch == DSV3_ARCH:
            # the latent arena is whole on every rank: (512 + 64) x bf16
            arena = [a["bfloat16"] for a in
                     two["model"]["arena_bytes_per_token_per_layer"]]
            if arena != [1152.0] * TP:
                raise AssertionError(f"tp latent arena bytes {arena}")
        rows, routes = [], []
        for p1, p2 in zip(one["passes"], two["passes"]):
            for r1, r2 in zip(p1["requests"], p2["requests"]):
                same = [a == b for a, b in zip(r1["tokens"], r2["tokens"])]
                rows.append({"pass": p2["pass"], "kind": r2["kind"],
                             "equal_tokens": int(sum(same)),
                             "tokens": len(same)})
                routes.append(r1["routing"] == r2["routing"])
        agree = sum(r["equal_tokens"] for r in rows) / sum(r["tokens"]
                                                           for r in rows)
        l1, l2 = one["passes"][0]["logits"], two["passes"][0]["logits"]
        gap = float(np.abs(l1 - l2).max() / np.abs(l1).max())
        fp32 = "fp32" in tag
        res = {"tp1": _strip_logits(one), "tp2": _strip_logits(two),
               "token_agreement": agree, "per_request": rows,
               "routing_equal_share": sum(routes) / len(routes),
               "logit_gap_of_max": gap,
               "argmax_equal": bool(l1.argmax() == l2.argmax())}
        if tag == TP_LORA_BF16_CASE:
            a1, a2 = (r["passes"][0]["lora_logits"] for r in (one, two))
            res["lora_logit_gap_of_max"] = float(np.abs(a1 - a2).max()
                                                 / np.abs(a1).max())
            res["lora_argmax_equal"] = bool(a1.argmax() == a2.argmax())
            # the adapter's own effect must read above the bound, or the
            # bound could not tell a bank that adds nothing
            res["lora_effect_of_max"] = float(np.abs(a2 - l2).max()
                                              / np.abs(l2).max())
            if res["lora_logit_gap_of_max"] > TP_LORA_LOGIT_BOUND:
                raise AssertionError(
                    f"tp {tag} LoRA logits {res['lora_logit_gap_of_max']} of "
                    f"the largest apart (bound {TP_LORA_LOGIT_BOUND})")
            if res["lora_effect_of_max"] <= TP_LORA_LOGIT_BOUND:
                raise AssertionError(
                    f"tp {tag} LoRA logits only {res['lora_effect_of_max']} "
                    f"of the largest from the base's (bound "
                    f"{TP_LORA_LOGIT_BOUND})")
        print(json.dumps({"tp_parity": {"case": tag, "card": card,
                                        "note": out["note"],
                                        "token_agreement": agree,
                                        "routing_equal_share":
                                            res["routing_equal_share"],
                                        "logit_gap_of_max": gap,
                                        "lora_logit_gap_of_max": res.get(
                                            "lora_logit_gap_of_max"),
                                        "lora_effect_of_max": res.get(
                                            "lora_effect_of_max"),
                                        "per_request": rows}}))
        if fp32 and (agree != 1.0 or not all(routes)):
            raise AssertionError(f"tp {tag}: tokens or moe routing differ "
                                 f"from tp = 1: {rows}, routing {routes}")
        if fp32 and arch in (ZAMBA_ARCH, XLSTM_ARCH) and (
                gap > TP_RECURRENT_FP32_LOGIT_BOUND):
            raise AssertionError(f"tp {tag} fp32 logits {gap} of the largest "
                                 f"apart (bound {TP_RECURRENT_FP32_LOGIT_BOUND})")
        if not fp32 and gap > tp_logit_bound(arch):
            raise AssertionError(f"tp {tag} logits {gap} of the largest apart "
                                 f"(bound {tp_logit_bound(arch)})")
        fork = two["passes"][0]["requests"][1]
        print(json.dumps({"tp_numbers": {
            "case": tag, "card": card, "note": out["note"],
            "backend": TP_BACKEND, "guard_ops": out["guard_ops"],
            "shard_bytes": two["model"]["shard_bytes"],
            "fork_ttft_ms": fork["ttft_s"] * 1e3,
            "fork_per_rank": fork["fork_per_rank"],
            "pinned_per_rank": [m["registered_bytes"] for m in
                                two["passes"][0]["memory_after_deploy"]],
            "decode_step_per_rank": two["passes"][0]["decode_step_per_rank"],
            "decode_step_tp1": one["passes"][0]["decode_step_per_rank"]}}))
        if tag in TP_SEQ_CASES:
            res["prefer_seq"] = tp_seq_parity(
                tag, one["seq"][0], two["seq"],
                get_config(arch).replace(**replace), card)
        if tag == TP_LORA_CASE:
            res["lora"] = tp_lora_parity(one["lora"], two["lora"], card,
                                         out["note"])
            res["instances"] = tp_instances_parity(instances, one, card)
        out[tag] = res
    out["instances"] = instances
    for tag, _ in TP_WHISPER_CASES:
        out[tag] = {"parity": tp_whisper_parity(tag, runs[1][tag][0],
                                                runs[TP][tag], card),
                    "launches": [r["launches"] for run in (1, TP)
                                 for r in runs[run][tag]]}
    return out


SERVE_CLI_TP = ["--tp", "2", "--arch", SMOLLM_ARCH, "--functions", "2",
                "--requests", "6", "--prompt-len", "64", "--max-new", "8"]


def serve_cli_tp() -> dict:
    """``python -m repro_torch.launch.serve`` with ``SERVE_CLI_TP`` on the
    card (smollm-135m at full width and depth, 2 gloo ranks sharing the
    card): exit 0, its heads line naming the uneven split (6 / 2 and 3 /
    1), every request served."""
    import os
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *SERVE_CLI_TP], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = [l for l in run.stdout.splitlines() if l.startswith("req")]
    heads = next((l for l in run.stdout.splitlines()
                  if l.startswith("tensor parallel")), None)
    out = {"argv": SERVE_CLI_TP, "returncode": run.returncode,
           "heads_line": heads, "kinds": sorted({l.split()[2] for l in lines}),
           "requests": len(lines), "wall_s": time.perf_counter() - t0,
           "p50_line": next((l for l in run.stdout.splitlines()
                             if l.startswith("p50")), None)}
    print(json.dumps({"serve_cli_tp": out}))
    if (run.returncode != 0 or len(lines) != 6 or heads is None
            or "6 query / 2 KV heads on rank 0" not in heads
            or "6/2, 3/1" not in heads or "cold" not in out["kinds"]):
        raise AssertionError(f"serve --tp 2: {out}\n{run.stdout[-2000:]}\n"
                             f"{run.stderr[-3000:]}")
    return out


def tp_lora_parity(one: dict, two: dict, card: str, note: str) -> dict:
    """LoRA at tp = 2 against tp = 1: every function's greedy tokens
    equal (fp32), the bank rows, and the adapter rows of each decode
    step."""
    s1, s2 = one["shared"], two["shared"]
    m1, m2 = one["merged"], two["merged"]
    equal = {n: s1["tokens"][n] == s2["tokens"][n] for n in s2["tokens"]}
    equal.update({f"base on {n}": s1["base_on_prompt"][n] == t
                  for n, t in s2["base_on_prompt"].items()})
    merged_equal = [a["tokens"] == b["tokens"] for a, b in zip(m1, m2)]
    rows = sorted(s2["rows"].values())
    steps = s2["rows_per_step"]
    res = {"tokens_equal": equal, "merged_tokens_equal": merged_equal,
           "kinds": s2["kinds"], "rows": s2["rows"],
           "rows_per_step": steps,
           "adapters_part_from_base": {
               n: s2["tokens"][n] != t
               for n, t in s2["base_on_prompt"].items()},
           "collectives_per_rank": s2["collectives_per_rank"],
           "merged_kinds": [m["kind"] for m in m2],
           "merged_ttft_ms": [m["ttft_s"] * 1e3 for m in m2],
           "merged_dynamic_bytes_per_rank": m2[1].get("dynamic_bytes_per_rank")}
    print(json.dumps({"tp_lora": {"card": card, "note": note, **res}}))
    if not all(equal.values()) or not all(merged_equal):
        raise AssertionError(f"tp lora tokens differ from tp = 1: {equal}, "
                             f"merged {merged_equal}")
    if s1["rows"] != s2["rows"] or s1["rows_per_step"] != steps:
        raise AssertionError("tp lora: bank rows or rows per step differ")
    if not all(res["adapters_part_from_base"].values()):
        raise AssertionError(f"tp lora: an adapter function's tokens equal "
                             f"the base's on its prompt: "
                             f"{res['adapters_part_from_base']}")
    # every adapter row decodes in each of its TP_NEW - 1 steps, and
    # the steps where all three decode gather all three rows
    seen = {r: sum(r in st for st in steps) for r in rows}
    if (rows != [1, 2, 3] or rows not in steps
            or any(set(st) - set(rows) for st in steps)
            or any(n != TP_NEW - 1 for n in seen.values())):
        raise AssertionError(f"tp lora: adapter rows per decode step {steps}"
                             f" (rows {rows}, steps per row {seen})")
    dyn = res["merged_dynamic_bytes_per_rank"]
    if not dyn or min(dyn) <= 0:
        raise AssertionError(f"tp lora merged fork streamed {dyn} dynamic "
                             f"bytes per rank: the merged delta is missing")
    return res


def tp_instances_parity(inst: dict, one: dict, card: str) -> dict:
    """Two rank groups against tp = 1: every request's greedy tokens equal
    the tp = 1 fp pass's for its prompt (fp32)."""
    ref = {r["want"]: r["tokens"] for r in one["passes"][0]["requests"]}
    equal = [r["tokens"] == ref[r["prompt"]] for r in inst["requests"]]
    forks = [r for r in inst["requests"] if "fork_per_rank" in r]
    res = {"ranks": inst["ranks"], "tokens_equal": equal,
           "placed": [r["instance"] for r in inst["requests"]],
           "kinds": [r["kind"] for r in inst["requests"]],
           "reused_prefix_len": [r["reused_prefix_len"]
                                 for r in inst["requests"]],
           "fork_per_rank_group": {
               r["instance"]: r["fork_per_rank"] for r in forks},
           "pinned_per_group": inst["pinned_per_group"],
           "group_weight_bytes": inst["group_weight_bytes"],
           "guard_ops": inst["guard_ops"], "wall_s": inst["wall_s"]}
    print(json.dumps({"tp_instances": {"card": card, "backend": TP_BACKEND,
                                       **res}}))
    if not all(equal):
        raise AssertionError(f"tp instances tokens differ from tp = 1: "
                             f"{equal}")
    streamed = {i: [f["streamed_bytes"] for f in rows]
                for i, rows in res["fork_per_rank_group"].items()}
    if len(streamed) != TP_INSTANCES or len(
            {tuple(v) for v in streamed.values()}) != 1:
        raise AssertionError(f"tp instances: fork bytes per group {streamed}")
    return res


CLUSTER_BUCKETS = (64, 256)
CLUSTER_POLICIES = ("serverlessllm", "tidal", "tidal-dk")


def cluster_expected_launches(cfg, engines) -> dict:
    """Exact kernel launches of the engines' runs: L flash per prefill
    call, L paged decode per step, norm_launches per model call."""
    L = attention_kernels(cfg)
    steps = sum(e.n_decode_steps for e in engines)
    prefills = sum(e.n_prefill_calls for e in engines)
    calls = steps + prefills
    return {"decode_attention": 0, "flash_attention": L * prefills,
            "paged_decode_attention": L * steps,
            "rmsnorm": norm_launches(cfg) * calls,
            "rmsnorm_fused": fused_norm_launches(cfg) * calls,
            "ssd_scan": 0, **NOT_LAUNCHED}


def phase_cluster(device, h2d: float) -> dict:
    """Phase 16: the cluster layer.  ``FaaSRuntime(mesh=ServingMesh(2, 1))``
    serves smollm-135m at full width and depth on two instances sharing
    the card (a static and a LoRA function placed apart, a warm
    function's new engine routed to its instance, tokens equal to the
    sequential ``Engine``'s over the same weights, exact launches, every
    instance's pool back at its baseline after ``evict``); then
    ``measure_service_times`` on that runtime at two prompt buckets, each
    entry beside the port's cost model on the card's profile; then the
    port's ``ClusterSim`` in measured mode over a seeded trace under three
    policies, every lookup served from the measured table."""
    from repro_torch.core import api as tidal
    from repro_torch.core.plans import plan_for
    from repro_torch.core.scheduler import (ClusterSim, FunctionProfile,
                                            SchedulerConfig, make_trace,
                                            summarize)
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.distributed import ServingMesh
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import Engine, FaaSRuntime
    from repro_torch.runtime.faas import measure_service_times
    model, p_static = full_model(device, seed=2)
    p_lora = model.init_params(seed=3)
    cfg, vocab = model.cfg, model.cfg.vocab_size
    hw = H100_SXM.with_h2d(h2d)
    rt = FaaSRuntime(mesh=ServingMesh(2, 1), device=device,
                     server=TemplateServer(hw=hw, trace_seq=128), n_slots=4,
                     max_len=512, page_size=PAGE_SIZE)
    t0 = time.perf_counter()
    for suffix in ("", "-m"):        # "-m": fresh functions, measured cold
        rt.deploy(tidal.static_function("static" + suffix, model, p_static),
                  {}, prewarm_seq=CLUSTER_BUCKETS[0])
        rt.deploy(tidal.lora_function("lora" + suffix, model, p_lora,
                                      ["blocks.attn.wq"], n_adapters=2),
                  {"adapter": "adapter-0"}, prewarm_seq=CLUSTER_BUCKETS[0])
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    devices = [str(inst.device) for inst in rt.instances]
    if devices != [str(device)] * 2:
        raise AssertionError(f"instances on {devices}, want two on {device}")
    for inst in rt.instances:        # every instance's pool, at its baseline
        rt._pool_for(rt._model_on("static", inst), inst)
    baseline = rt.kv_pool_stats()

    # 1. two instances: placement, locality, tokens, launches, evict
    rng = np.random.default_rng(16)
    a0, a1 = {"adapter": "adapter-0"}, {"adapter": "adapter-1"}
    plan = [("static", {}), ("lora", a0), ("static", {}), ("lora", a1),
            ("lora", a0)]
    prompts = [rng.integers(1, vocab, int(n)).astype(np.int32)
               for n in rng.integers(32, 257, len(plan))]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = [rt.submit(fn, ev, p, 16) for (fn, ev), p in zip(plan, prompts)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    keys = [(fn, tuple(sorted(ev.items()))) for fn, ev in plan]
    placed = {k: rt._engines[k].instance for k in keys}
    kinds = [r.kind for r in results]
    expect = cluster_expected_launches(
        cfg, [w.engine for w in rt._engines.values()])
    if kinds != ["cold", "cold", "warm", "fork", "warm"]:
        raise AssertionError(f"instances: kinds {kinds}")
    if placed[keys[0]] == placed[keys[1]]:
        raise AssertionError(f"both functions on instance {placed[keys[0]]}")
    if placed[keys[3]] != placed[keys[1]]:
        raise AssertionError(f"the LoRA function's new engine went to "
                             f"instance {placed[keys[3]]}, not its warm "
                             f"instance {placed[keys[1]]}")
    if counts != expect:
        raise AssertionError(f"instances launches {counts} != {expect}")
    equal = []
    for (fn, ev), key, p, r in zip(plan, keys, prompts, results):
        params = rt._engines[key].engine.params()
        want = Engine(model, params).generate(p[None], max_new_tokens=16)
        equal.append(int((want.tokens[0] == r.tokens).sum()))
    instances = rt.stats()["instances"]
    rt.evict()
    after = rt.kv_pool_stats()
    if sorted(k[0] for k in baseline) != [0, 1] or after != baseline:
        raise AssertionError(f"evict: pools {after} != baseline {baseline}")
    row = {"pass": "instances", "devices": devices, "kinds": kinds,
           "placed": {f"{k[0]}{dict(k[1]) or ''}": v for k, v in placed.items()},
           "instances": instances, "launches": counts, "wall_s": wall,
           "deploy_s": deploy_s, "tokens_equal_engine": f"{sum(equal)}/{16 * len(plan)}",
           "ttft_ms": [r.ttft_s * 1e3 for r in results]}
    print(json.dumps(row))
    if sum(equal) != 16 * len(plan):
        raise AssertionError(f"instances: tokens equal to the Engine's "
                             f"{equal} of 16 each")

    # 2. measured service times beside the cost model on the card's profile
    measured_fns = {"static-m": {}, "lora-m": a1}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    table = measure_service_times(rt, measured_fns, max_new_tokens=4,
                                  warm_reps=2, prompt_lens=list(CLUSTER_BUCKETS))
    torch.cuda.synchronize()
    measure_s = time.perf_counter() - t0
    m_counts = ops.launch_counts()
    if (m_counts["paged_decode_attention"] == 0 or m_counts["flash_attention"] == 0
            or m_counts["decode_attention"]):
        raise AssertionError(f"measurement launches {m_counts}")
    check_norm_launches(m_counts, cfg, "measured service times")
    print(table.summary())
    profiles = {}
    for fn in measured_fns:
        tpl = rt.server.templates[fn]
        profiles[fn] = FunctionProfile(
            name=fn, plan_for_len=lambda n: plan_for("smollm-135m", 1, n),
            dynamic_bytes=tpl.dynamic_bytes, template_bytes=tpl.resident_bytes,
            model_bytes=tpl.total_bytes)
    oracle = ClusterSim(SchedulerConfig(policy="tidal", hw=hw), profiles)
    predict = {"warm": oracle._warm_ttft, "fork": oracle._fork_ttft,
               "cold": oracle._cold_ttft}
    service = []
    for fn in measured_fns:
        for kind in ("cold", "fork", "warm"):
            for n, s in table._buckets(fn, kind) or []:
                service.append({"fn": fn, "kind": kind, "prompt_len": n,
                                "measured_ms": s * 1e3,
                                "predicted_ms": predict[kind](profiles[fn], n) * 1e3})
    for r in service:
        print(json.dumps({"service_time": r}))
    for fn in measured_fns:        # warm below fork and cold at each bucket
        got = {k: dict(table._buckets(fn, k) or []) for k in ("cold", "fork",
                                                              "warm")}
        if (set(got["warm"]) != set(CLUSTER_BUCKETS)
                or set(got["fork"]) != set(CLUSTER_BUCKETS)
                or set(got["cold"]) != {CLUSTER_BUCKETS[0]}):
            raise AssertionError(f"{fn}: measured {got}")
        if not all(got["warm"][n] < min(got["fork"][n],
                                        got["cold"].get(n, np.inf))
                   for n in CLUSTER_BUCKETS):
            raise AssertionError(f"{fn}: warm is not below fork and cold: {got}")

    # 3. the simulator with the measured table as its oracle
    class CountingTable:
        def __init__(self):
            self.lookups = self.hits = 0

        def service_s(self, fn, kind, input_len):
            self.lookups += 1
            t = table.service_s(fn, kind, input_len)
            self.hits += t is not None
            return t

    trace = make_trace({"static-m": 4.0, "lora-m": 4.0}, 30.0,
                       {"static-m": "mail", "lora-m": "conv"}, seed=0)
    sims = {}
    for policy in CLUSTER_POLICIES:
        counter = CountingTable()
        res = ClusterSim(SchedulerConfig(n_gpus=2, policy=policy,
                                         dk=policy == "tidal-dk",
                                         keep_alive_s=2.0, hw=hw,
                                         measured=counter),
                         profiles).run(trace)
        served = [r for r in res if not (r.rejected or r.shed)]
        if len(res) != len(trace):
            raise AssertionError(f"{policy}: {len(res)} results for "
                                 f"{len(trace)} requests")
        if counter.lookups != len(served) or counter.hits != counter.lookups:
            raise AssertionError(f"{policy}: {counter.hits} of "
                                 f"{counter.lookups} lookups from the table, "
                                 f"{len(served)} served")
        sims[policy] = {**summarize(res), "lookups": counter.lookups,
                        "table_hits": counter.hits}
        print(json.dumps({"cluster_sim": policy, **sims[policy]}))
    out = {"instances": row, "measure_s": measure_s,
           "measure_launches": m_counts, "service_times": service,
           "h2d_gb_per_s": h2d / 1e9, "trace_requests": len(trace),
           "sim": sims}
    rt.evict()
    return out


# phase 17: training under a sharding plan.  (arch, depth cut, batch, seq)
# at full width, fp32 and remat as the training CLI trains, depth cut for
# the script's time: llama3-8b at 1 of 32 layers (its 128,256-row embed
# and head are most of its bytes: a gloo FSDP step at 2 layers took
# 8.7-29.5 s); zamba2-2.7b at one unit (6 Mamba2 blocks and the shared
# block); xlstm-1.3b at one unit (7 mLSTM blocks and an sLSTM block);
# whisper-medium at 1 + 1 layers over 1,500 frames.  The one process and
# tp = 2 run two steps, FSDP one.  The last field is the step
# after which the parameters are held: the last for llama3-8b and
# whisper-medium; the first for zamba2 and xlstm, whose decay and gate
# leaves (``a_log``,
# ``dt_bias``, the sLSTM's bias) have elements with gradients near zero:
# AdamW's first step moves those by up to lr either way, and every later
# gradient reads them (zamba2's held parameters read 1.2e-5 to 3.8e-5
# apart after two steps at tp = 2 while its gradients agreed; H100)
TRAIN_TP_CASES = (("llama3-8b", dict(n_layers=1), 4, 128, "last"),
                  ("zamba2-2.7b", dict(n_layers=6), 4, 128, "first"),
                  ("xlstm-1.3b", dict(n_layers=8), 4, 128, "first"),
                  ("whisper-medium", dict(n_layers=1, dec_layers=1), 4, 64, "last"))
# the control of the gradient limit at full width: step 1 at tp = 2 with
# ``sharding.sum_grad_columns`` the identity, so the replicated weights
# named here keep each rank's partial gradient; it must read beyond the
# limit the sound runs are held to
TRAIN_TP_PLANTS = {"zamba2-2.7b": "Mamba2's B / C columns' sum skipped",
                   "xlstm-1.3b": "the mLSTM's x_inner columns' sum skipped"}
TRAIN_TP_STEPS = 2
TRAIN_TP_SEED, TRAIN_TP_DATA_SEED = 7, 11
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_STATE_TOL = 1e-5, 1e-4, 1e-5


def train_tp_config(arch: str, replace: dict):
    from repro_torch.models.registry import get_config
    return get_config(arch).replace(dtype="float32", **replace)


def train_launches(cfg, tp: int = 1) -> dict:
    """Kernel launches of one training step (remat) of ``cfg`` on a rank
    of ``tp``.  Dense: :func:`smollm_train_launches`.  zamba (L Mamba2
    blocks, U uses of the shared block): per block the pre-norm, the
    gated norm and ``ssd_scan``, twice (the recomputation), each use two
    norms (one fused) and flash; backward one of each; at tp = 2 the
    gated norm is split-row (two launches forward, two backward).  xlstm
    (M mLSTM blocks recomputed, U sLSTM blocks not): per mLSTM block two
    norms, per sLSTM block three (one fused); at tp = 2 the inner norms
    split.  whisper: flash per encoder layer and per decoder layer twice
    (self and cross), the decoder recomputed; no rmsnorm."""
    from repro_torch.models.transformer import n_units, xlstm_units
    if cfg.is_encdec:
        L, Ld = cfg.n_layers, cfg.dec_layers
        return {"flash_attention": L + 4 * Ld, "flash_attention_bwd": L + 2 * Ld}
    if cfg.family == "zamba":
        L, U = cfg.n_layers, n_units(cfg)
        out = {"ssd_scan": 2 * L, "ssd_scan_bwd": L, "flash_attention": U,
               "flash_attention_bwd": U, "rmsnorm_fused": U}
        if tp == 1:
            return {**out, "rmsnorm": 4 * L + 2 * U + 1,
                    "rmsnorm_bwd": 2 * L + 2 * U + 1}
        return {**out, "rmsnorm": 2 * L + 2 * U + 1, "rmsnorm_bwd": L + 2 * U + 1,
                "rmsnorm_split": 4 * L, "rmsnorm_split_bwd": 2 * L}
    if cfg.family == "xlstm":
        U, per = xlstm_units(cfg)
        M = U * per
        if tp == 1:
            return {"rmsnorm": 4 * M + 3 * U + 1, "rmsnorm_fused": U,
                    "rmsnorm_bwd": 2 * M + 3 * U + 1}
        return {"rmsnorm": 2 * M + 2 * U + 1, "rmsnorm_fused": U,
                "rmsnorm_bwd": M + 2 * U + 1, "rmsnorm_split": 4 * M + 2 * U,
                "rmsnorm_split_bwd": 2 * M + 2 * U}
    return smollm_train_launches(cfg.n_layers)


def _all_reduce_sizes(cfg, tp: int, rows: int, seq: int, frames: int) -> list:
    """Bytes of every all_reduce of one training step's model call (remat)
    on a rank of ``tp``: activations ``[rows, seq, d]`` fp32 (``act``),
    row statistics ``[rows, seq]`` (``row``).  Forward: the row-parallel
    products' sums (attention, MLP, Mamba2's and the mLSTM's out
    projections, the sLSTM's post-MLP where split), the split norms'
    row sums, the sLSTM's gather; the recomputation repeats what a
    block's backward reads before its last product (the attention sum of
    a dense block, the split norm's sums of a Mamba2 or mLSTM block,
    whisper's self- and cross-attention sums).  Backward: each copy op
    (a block's input, the MLP input, whisper's encoder output at every
    cross-attention), the replicated columns' gradient sums (Mamba2's B /
    C columns of ``in_proj`` and ``conv_w``, the mLSTM's ``x_inner``
    columns of ``up_proj`` and its conv) and the split norms' dots.  A
    vocab-parallel head adds the embedding's sum, the loss's max and
    ``[2, rows, seq]`` sums and the head input's copy; K/V heads kept by
    every rank their copies after the rope."""
    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import n_units, xlstm_units
    D = cfg.d_model
    act, row = rows * seq * D * 4, rows * seq * 4
    out = []
    if sharding.vocab_parallel(cfg, tp):
        out += [act, row, 2 * row, act]
    if cfg.is_encdec:
        enc = rows * frames * D * 4
        out += [enc] * (4 * cfg.n_layers)
        out += ([act] * 3 + [act] * 2 + [act, act, enc, act]) * cfg.dec_layers
    elif cfg.family == "zamba":
        bc, W = 2 * cfg.ssm_state, cfg.conv_width
        out += [row, act, row, act, D * bc * 4, W * bc * 4, row] * cfg.n_layers
        out += [act] * (4 * n_units(cfg))
    elif cfg.family == "xlstm":
        U, per = xlstm_units(cfg)
        d_in = cfg.mlstm_input_width
        out += [row, act, row, act, D * d_in * 4, cfg.conv_width * d_in * 4,
                row] * (U * per)
        mlp = 2 if sharding.slstm_mlp_split(cfg, tp) else 0
        out += ([row, rows * seq * cfg.slstm_width * 4, row, act] + [act] * mlp) * U
    else:
        out += [act] * (5 * cfg.n_layers)
    if not cfg.is_encdec and sharding.kv_groups(cfg, tp) < tp:
        # K/V heads every rank keeps enter the rank's attention after the
        # rope through their copy ops: k and v per attention
        uses = n_units(cfg) if cfg.family == "zamba" else cfg.n_layers
        out += [rows * seq * cfg.n_kv_heads * cfg.head_dim * 4] * (2 * uses)
    return out


def _fsdp_gathers(cfg, path: str) -> tuple:
    """(all_gathers, reduce_scatters) of a leaf cut over 'data' in one FSDP
    step.  Gathers: its forward
    gather and a second one, either in a remat'd block's recomputation or
    at the backward's first read of the leaf saved whole; one only where,
    outside a recomputed block, no op saves the leaf itself (a bias added,
    positions sliced, a leaf saved through a view, which keeps it whole
    instead: whisper's encoder biases, its final norms' biases,
    ``dec_pos``, the first encoder norm's scale, whose input carries no
    gradient; the sLSTM's bias and its recurrent ``r``).  The embedding
    takes two: the lookup's and the head's (the tied head saves a
    transposed view, an untied model's head gathers it unread); whisper's
    tied embedding then scatters both gradients (the second element)."""
    leaf = path.rsplit(".", 1)[-1]
    if cfg.is_encdec:
        if path == "embed":
            return 2, 2
        if (path in ("dec_pos", "enc_layers.0.ln1.scale")
                or (not path.startswith("dec_layers")
                    and leaf in ("bq", "bv", "bo", "b1", "b2", "bias"))):
            return 1, 1
        return 2, 1
    if (cfg.family == "xlstm" and path.startswith("slstm.")
            and (path.endswith("mixer.b") or path.endswith("mixer.r"))):
        return 1, 1
    return 2, 1


def train_tp_collectives(cfg, plan, rows: int, seq: int, frames: int = 0) -> dict:
    """Collectives of one training step on a rank of ``plan`` (a tp = 2 or
    FSDP (2, 2) plan over ``rows`` rows per rank), by kind: (calls,
    bytes).  all_reduce: the model call's (:func:`_all_reduce_sizes`),
    the global norm (one fp32) and under FSDP the loss metric's mean
    (one fp32) and the gradient of every leaf not cut over 'data' (its
    model shard).  FSDP's all_gather and reduce_scatter: as many per leaf
    cut over 'data' as :func:`_fsdp_gathers` reckons, its model shard's
    bytes each time."""
    sizes = _all_reduce_sizes(cfg, plan.mesh.model, rows, seq, frames) + [4]
    gathers, scatters = [], []
    if plan.mesh.data > 1:
        sizes.append(4)
        for path, spec, full in _train_tp_leaves(cfg, plan):
            shard = 4 * full                      # the leaf's model shard
            if "data" in spec:
                n_gather, n_scatter = _fsdp_gathers(cfg, path)
                gathers += [shard] * n_gather
                scatters += [shard] * n_scatter
            else:
                sizes.append(shard)
    out = {"all_reduce": (len(sizes), sum(sizes))}
    if gathers:
        out["all_gather"] = (len(gathers), sum(gathers))
        out["reduce_scatter"] = (len(scatters), sum(scatters))
    return out


def _train_tp_leaves(cfg, plan):
    """(path, spec, elements of the rank's model shard times its data
    pieces) for every leaf: a rank's piece of the global leaf (a ``meta``
    shard), scaled back over 'data'."""
    from repro_torch.distributed import sharding
    from repro_torch.models import encdec, transformer
    from repro_torch.utils import named_leaves
    specs = dict(named_leaves(sharding.plan_param_specs(cfg, plan)))
    family = encdec if cfg.is_encdec else transformer
    out = []
    for path, leaf in named_leaves(family.param_specs(cfg)):
        piece = sharding.shard_for_rank(torch.empty(leaf.shape, device="meta"),
                                        specs[path], plan)
        data = plan.mesh.data if "data" in specs[path] else 1
        out.append((path, specs[path], piece.numel() * data))
    return out


def train_tp_state_bytes(cfg, plan) -> int:
    """Bytes of parameters, ``m`` and ``v`` (fp32) and the step counter
    one rank holds: three times its pieces (a meta shard of each global
    leaf by the plan's spec)."""
    return sum(3 * 4 * n // (plan.mesh.data if "data" in spec else 1)
               for _, spec, n in _train_tp_leaves(cfg, plan)) + 4


def _train_tp_batches(cfg, batch: int, seq: int) -> list:
    from repro_torch.data.pipeline import DataConfig, TokenStream, make_frames
    it = iter(TokenStream(DataConfig(cfg.vocab_size, seq, batch,
                                     seed=TRAIN_TP_DATA_SEED)))
    out = [next(it) for _ in range(TRAIN_TP_STEPS)]
    if cfg.is_encdec:
        frames = make_frames(cfg.d_model, batch, WHISPER_FRAMES, seed=31)
        for b in out:
            b["frames"] = frames
    return out


def _train_tp_reference(cfg, opt, batches, device, held_after: tuple) -> dict:
    """The one-process run (rank 0): every step with its gradients, exact
    launches per step, and at step 1 the gradients' fp32 floor
    (:func:`grad_floor`); kept on the host: step 1's gradients and, for
    each step in ``held_after``, the parameters after it and where AdamW
    was well conditioned at every step up to it (the clipped gradient at
    least 1e-3 of its leaf's largest and 1e3 eps)."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import adamw_update, init_opt_state
    from repro_torch.utils import named_leaves, unflatten_like
    model = get_model(cfg, device=device)
    params = model.init_params(TRAIN_TP_SEED, draw_on_device=True)
    opt_state = init_opt_state(params, opt)
    names = [n for n, _ in named_leaves(params)]
    held, rows, grads1, kept, floor = None, [], None, {}, None
    for i, b in enumerate(batches):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = [t for _, t in named_leaves(params)]
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, b)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        new, opt_state, m = adamw_update(
            params, unflatten_like(params, iter(grads)), opt_state, opt)
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "loss": float(loss.detach()),
                     "grad_norm": float(m["grad_norm"]),
                     "launches": ops.launch_counts()})
        if i == 0:
            grads1 = {n: g.cpu() for n, g in zip(names, grads)}

            def grad_at(q, b=b, tree=params):
                qs = [t.requires_grad_(True) for t in q.values()]
                out = torch.autograd.grad(
                    model.loss(unflatten_like(tree, iter(qs)), b), qs)
                return dict(zip(names, out))

            floor = grad_floor(grad_at, dict(zip(names, leaves)),
                               dict(zip(names, grads)))
        params = new
        clip = min(1.0, opt.clip_norm / float(m["grad_norm"]))
        ok = [g.abs() * clip >= max(1e-3 * float(g.abs().max()) * clip,
                                    1e3 * opt.eps) for g in grads]
        held = ok if held is None else [a & b for a, b in zip(held, ok)]
        if i + 1 in held_after:
            kept[i + 1] = ({n: t.cpu() for n, t in named_leaves(params)},
                           {n: h.cpu() for n, h in zip(names, held)})
        del grads, loss, leaves, new
    check_train_launches_rows(rows, cfg, 1, "train_tp one process")
    out = {"rows": rows, "grads1": grads1, "kept": kept, "floor": floor,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, opt_state, model, held
    torch.cuda.empty_cache()
    return out


def check_train_launches_rows(rows: list, cfg, tp: int, where: str) -> None:
    for i, r in enumerate(rows):
        check_train_launches(r["launches"], train_launches(cfg, tp), 1,
                             f"{where} step {i + 1}")


def _compare_pieces(plan, cfg, tree, want: dict | None, masked: bool = False,
                    held: dict | None = None) -> dict:
    """Every rank's piece of every leaf against the same piece of the one
    process's ``want`` (host tensors on the plan's first rank), cut on
    that rank's card (the host's strided copies took ~45 s of the phase),
    sent to the rank that holds it (``dist.scatter`` through the host) and
    compared there on the card: per leaf, max |got - want| over the
    leaf's largest |want|; ``masked``, over the elements ``held`` marks
    only: their max |got - want| and whether each is within
    ``TRAIN_STATE_TOL`` (1 + |want|).  ``masked`` is the same on every
    rank, ``want`` and ``held`` are the first rank's.  The first rank's
    {leaf: result}; None elsewhere."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.utils import named_leaves
    specs = dict(named_leaves(sharding.plan_param_specs(cfg, plan)))
    first = plan.world_rank == 0
    src = dist.get_global_rank(plan.world_group, 0)
    plans = [sharding.training_plan(plan.mesh, rank=r % plan.mesh.model,
                                    data_rank=r // plan.mesh.model,
                                    fsdp=plan.fsdp, mode=plan.mode)
             for r in range(plan.mesh.size)] if first else None

    def mine(full_of, dtype):
        recv = torch.empty(tuple(t.shape), dtype=dtype)
        pieces = None
        if first:
            whole = full_of.to(t.device, dtype)
            if all(e is None for e in specs[path]):
                pieces = [whole.cpu()] * len(plans)
            else:
                pieces = [p.shard(whole, specs[path]).cpu() for p in plans]
            del whole
        dist.scatter(recv, pieces, src=src, group=plan.world_group)
        return recv.to(t.device)

    local = {}
    for path, t in named_leaves(tree):
        w = mine(want[path] if first else None, torch.float32)
        diff = (t.detach().float() - w).abs()
        if not masked:
            local[path] = (float(diff.max()), float(w.abs().max()))
        else:
            h = mine(held[path] if first else None, torch.uint8).bool()
            local[path] = (float(diff[h].max()) if bool(h.any()) else 0.0,
                           bool((diff <= TRAIN_STATE_TOL * (1 + w.abs()))[h].all()),
                           int(h.sum()), h.numel())
        del w, diff
    ranks = [None] * plan.mesh.size if first else None
    dist.gather_object(local, ranks, dst=src, group=plan.world_group)
    if not first:
        return None
    out = {}
    for path in local:
        parts = [r[path] for r in ranks]
        if not masked:
            out[path] = max(p[0] for p in parts) / max(
                max(p[1] for p in parts), 1e-30)
        else:
            out[path] = {"max_abs": max(p[0] for p in parts),
                         "within": all(p[1] for p in parts),
                         "held": sum(p[2] for p in parts),
                         "size": sum(p[3] for p in parts)}
    return out


def _train_tp_run(group, plan, cfg, opt, batches, ref, steps: int,
                  held_after: int) -> dict | None:
    """One sharded run of ``steps`` steps on the plan's ranks: the rank's
    pieces of the seed's weights (drawn leaf by leaf on the card), step 1
    by hand with its gradients read, then ``make_train_step`` for the
    later steps, each step's launches and collectives read; held against
    the one process's ``ref`` on the plan's first rank (the parameters
    after step ``held_after``)."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import shard_rows
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import adamw_update, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.utils import named_leaves, tree_bytes, unflatten_like
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=group.device, plan=plan)
    params = model.init_params(TRAIN_TP_SEED, draw_on_device=True)
    state = {"params": params,
             "opt": init_opt_state(params, opt, model.layout)}
    state_bytes = tree_bytes(state["params"]) + tree_bytes(state["opt"])
    kept = ref and ref["kept"][held_after]

    def row(t0, loss, m) -> dict:
        coll = sharding.collective_stats()
        return {"ms": (time.perf_counter() - t0) * 1e3,
                "collective_ms": coll["seconds"] * 1e3, "loss": loss,
                "grad_norm": float(m["grad_norm"]),
                "launches": ops.launch_counts(), "collectives": coll}

    # step 1 by hand, to read its gradients: the pieces' gradients (the
    # FSDP backward's mean included), then the optimizer under the layout,
    # the collectives and launches of make_train_step
    ops.reset_launch_counts()
    sharding.reset_collective_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaves = [t for _, t in named_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, shard_rows(batches[0], plan.data_rank, plan.data))
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    model.layout.end_step()
    loss1 = float(fsdp.batch_mean(loss.detach(), model.layout))
    new, new_opt, m1 = adamw_update(params, unflatten_like(params, iter(grads)),
                                    state["opt"], opt, model.layout)
    torch.cuda.synchronize()
    rows = [row(t0, loss1, m1)]
    names = [n for n, _ in named_leaves(params)]
    grad_err = _compare_pieces(plan, cfg, dict(zip(names, grads)),
                               ref and ref["grads1"])
    state = {"params": new, "opt": new_opt}
    del grads, loss, leaves, params, new, new_opt

    def held_params():
        return _compare_pieces(plan, cfg, dict(named_leaves(state["params"])),
                               kept and kept[0], masked=True,
                               held=kept and kept[1])

    param_err = held_params() if held_after == 1 else None
    step = make_train_step(model, opt)
    for i, b in enumerate(batches[1:steps], start=2):
        ops.reset_launch_counts()
        sharding.reset_collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        rows.append(row(t0, float(m["loss"]), m))
        if i == held_after:
            param_err = held_params()
    mine = {"rows": rows, "state_bytes": state_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated()}
    ranks = [None] * plan.mesh.size if plan.world_rank == 0 else None
    dist.gather_object(mine, ranks, dst=dist.get_global_rank(
        plan.world_group, 0), group=plan.world_group)
    del state, model, step
    torch.cuda.empty_cache()
    if plan.world_rank != 0:
        return None
    return {"loss1": loss1, "grad_err": grad_err, "param_err": param_err,
            "ranks": ranks}


def _train_tp_planted(group, plan, cfg, batches, ref) -> dict | None:
    """Step 1's gradients on the plan's ranks again, with
    ``sharding.sum_grad_columns`` the identity (``TRAIN_TP_PLANTS``), held
    against the one process's as the sound run's are: per leaf, max |got
    - want| over the leaf's largest |want| (the plan's first rank; None
    elsewhere)."""
    from repro_torch.data.pipeline import shard_rows
    from repro_torch.distributed import sharding
    from repro_torch.models.registry import get_model
    from repro_torch.utils import named_leaves
    model = get_model(cfg, device=group.device, plan=plan)
    params = model.init_params(TRAIN_TP_SEED, draw_on_device=True)
    named = list(named_leaves(params))
    for _, t in named:
        t.requires_grad_(True)
    real = sharding.sum_grad_columns
    sharding.sum_grad_columns = lambda w, *a, **k: w
    try:
        loss = model.loss(params, shard_rows(batches[0], plan.data_rank,
                                             plan.data))
        grads = torch.autograd.grad(loss, [t for _, t in named])
    finally:
        sharding.sum_grad_columns = real
    model.layout.end_step()
    err = _compare_pieces(plan, cfg, {n: g for (n, _), g in zip(named, grads)},
                          ref and ref["grads1"])
    del grads, loss, named, params, model
    torch.cuda.empty_cache()
    return err


def _train_tp_case(group, grid, arch: str, replace: dict, batch: int,
                   seq: int, held: str) -> dict:
    """One case of phase 17 on every rank: the one process on rank 0,
    tp = 2 on the first data slice's ranks, FSDP (2, 2) on all."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ServingMesh, training_plan
    from repro_torch.train.optimizer import OptimizerConfig
    cfg = train_tp_config(arch, replace)
    opt = OptimizerConfig(warmup_steps=1)
    batches = _train_tp_batches(cfg, batch, seq)
    # tp = 2 runs every step, FSDP the first only (its steps move the
    # leaves through gloo: 8.7-16 s each at llama3-8b's)
    held_after = TRAIN_TP_STEPS if held == "last" else 1
    ref = None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if group.global_rank == 0:
        ref = _train_tp_reference(cfg, opt, batches, group.device,
                                  (1, held_after))
    dist.barrier(group=group.world_group)
    out = {"one_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    if group.instance == 0:
        two = training_plan(ServingMesh(1, group.size), rank=group.rank,
                            group=group.data_group,
                            world_group=group.data_group)
        out["tp2"] = _train_tp_run(group, two, cfg, opt, batches, ref,
                                   TRAIN_TP_STEPS, held_after)
        if arch in TRAIN_TP_PLANTS:
            out["planted"] = _train_tp_planted(group, two, cfg, batches, ref)
    dist.barrier(group=group.world_group)
    out["tp2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fsdp"] = _train_tp_run(group, grid, cfg, opt, batches, ref, 1, 1)
    out["fsdp_s"] = time.perf_counter() - t0
    if group.global_rank == 0:
        out["one"] = {k: ref[k] for k in ("rows", "peak_bytes", "floor")}
    del ref
    torch.cuda.empty_cache()
    return out


def _warm_rank(device) -> float:
    """One training step of llama3-8b's layer (fp32, one layer, a 1,024-row
    vocabulary, 4 x 128 tokens, no plan) on this rank; its seconds.  A
    fresh process's first training step took 13-16 s on the card (H100)
    beyond its later ones, and the ranks took theirs in turn (rank 0 in
    the one process, rank 1 at tp = 2, ranks 2 and 3 in the first FSDP
    step): every rank takes it here at once."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_loop import init_train_state, make_train_step
    cfg = train_tp_config("llama3-8b", {"n_layers": 1, "vocab_size": 1024})
    model = get_model(cfg, device=device)
    opt = OptimizerConfig(warmup_steps=1)
    state = init_train_state(model, opt, draw_on_device=True)
    batch = next(iter(TokenStream(DataConfig(cfg.vocab_size, 128, 4))))
    t0 = time.perf_counter()
    state, m = make_train_step(model, opt)(state, batch)
    float(m["loss"])
    torch.cuda.synchronize()
    del state, model
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _train_tp_rank(group) -> dict | None:
    """Every rank of phase 17's spawn (see ``phase_train_tp``): the
    warm-up (``_warm_rank``), then the cases in turn."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warm = ([None] * dist.get_world_size(group.world_group)
            if group.global_rank == 0 else None)
    dist.gather_object(_warm_rank(group.device), warm, dst=0,
                       group=group.world_group)
    grid = group.training_plan(fsdp=True)          # SPMD from here on
    out = {arch: _train_tp_case(group, grid, arch, replace, batch, seq, held)
           for arch, replace, batch, seq, held in TRAIN_TP_CASES}
    return {**out, "warm_s": warm} if group.global_rank == 0 else None


def train_tp_check(tag: str, run: dict, one: dict, cfg, plan, batch: int,
                   seq: int, held: str) -> dict:
    """Phase 17's checks of one sharded run against the one process."""
    one_rows = one["rows"]
    tp = plan.tp
    if abs(run["loss1"] - one_rows[0]["loss"]) > TRAIN_LOSS_RTOL * abs(
            one_rows[0]["loss"]):
        raise AssertionError(f"train_tp {tag}: step 1 loss {run['loss1']} "
                             f"against {one_rows[0]['loss']}")
    worst = max(run["grad_err"].items(), key=lambda kv: kv[1])
    grad_tol = max(TRAIN_GRAD_TOL, GRAD_FLOOR_FACTOR * one["floor"])
    if worst[1] > grad_tol:
        raise AssertionError(f"train_tp {tag}: gradient {worst} beyond "
                             f"{grad_tol} (floor {one['floor']})")
    bad = {n: e for n, e in run["param_err"].items() if not e["within"]}
    if bad:
        raise AssertionError(f"train_tp {tag}: held parameters {bad}")
    # past the held step the trajectories may part by AdamW's steps on
    # near-zero gradients (see TRAIN_TP_CASES): grad norms held up to it
    held_steps = TRAIN_TP_STEPS if held == "last" and not plan.fsdp else 1
    for r in run["ranks"]:
        norms = [row["grad_norm"] for row in r["rows"]][:held_steps]
        for i, (norm, ref) in enumerate(zip(norms, one_rows)):
            if abs(norm - ref["grad_norm"]) > 1e-4 * ref["grad_norm"]:
                raise AssertionError(f"train_tp {tag} step {i + 1}: grad norm "
                                     f"{norm} against {ref['grad_norm']}")
        check_train_launches_rows(r["rows"], cfg, tp, f"train_tp {tag}")
    rows_per_rank = batch // plan.mesh.data
    want = train_tp_collectives(cfg, plan, rows_per_rank, seq,
                                WHISPER_FRAMES if cfg.is_encdec else 0)
    state_want = train_tp_state_bytes(cfg, plan)
    for rank, r in enumerate(run["ranks"]):
        for i, row in enumerate(r["rows"], start=1):
            c = row["collectives"]
            if c["kinds"] != {k: n for k, (n, _) in want.items()} or c["bytes"] != sum(
                    b for _, b in want.values()):
                raise AssertionError(
                    f"train_tp {tag} rank {rank} step {i + 1}: collectives "
                    f"{c['kinds']} / {c['bytes']} bytes, reckoned {want}")
        if r["state_bytes"] != state_want:
            raise AssertionError(f"train_tp {tag} rank {rank}: "
                                 f"{r['state_bytes']} bytes of state, "
                                 f"reckoned {state_want}")
    summary = {
        "case": tag, "mesh": [plan.mesh.data, plan.mesh.model],
        "fsdp": plan.fsdp, "loss1": run["loss1"],
        "loss1_one": one_rows[0]["loss"],
        "losses": [row["loss"] for row in run["ranks"][0]["rows"]],
        "losses_one": [row["loss"] for row in one_rows],
        "grad_max_rel": worst[1], "grad_worst_leaf": worst[0],
        "grad_floor": one["floor"], "grad_tol": grad_tol,
        "steps": len(run["ranks"][0]["rows"]),
        "params_held_after": held if not plan.fsdp else "first",
        "param_max_abs": max(e["max_abs"] for e in run["param_err"].values()),
        "held_share": (sum(e["held"] for e in run["param_err"].values())
                       / sum(e["size"] for e in run["param_err"].values())),
        "step_ms_per_rank": [[row["ms"] for row in r["rows"]]
                             for r in run["ranks"]],
        "collective_ms_per_rank": [[row["collective_ms"] for row in r["rows"]]
                                   for r in run["ranks"]],
        "collectives_per_step": {k: {"calls": n, "bytes": b}
                                 for k, (n, b) in want.items()},
        "state_bytes_per_rank": [r["state_bytes"] for r in run["ranks"]],
        "state_bytes_reckoned": state_want,
        "peak_bytes_per_rank": [r["peak_bytes"] for r in run["ranks"]],
        "launches_per_rank_step": run["ranks"][0]["rows"][0]["launches"]}
    print(json.dumps({"train_tp": summary}))
    return summary


def train_tp_planted_check(arch: str, errs: dict, grad_tol: float) -> dict:
    """The control must read beyond the limit the sound runs are held to."""
    worst = max(errs.items(), key=lambda kv: kv[1])
    row = {"arch": arch, "fault": TRAIN_TP_PLANTS[arch], "mesh": [1, TP],
           "grad_max_rel": worst[1], "grad_worst_leaf": worst[0],
           "grad_tol": grad_tol}
    print(json.dumps({"train_tp_planted": row}))
    if not worst[1] > grad_tol:
        raise AssertionError(f"train_tp {arch}: the planted fault reads "
                             f"{worst}, within the limit {grad_tol}")
    return row


def train_tp_spawn() -> dict:
    """Phase 17's one spawn of 4 gloo ranks sharing the card (see the
    module doc), its wall seconds beside rank 0's result.  ``main`` starts
    it on a thread after phase 8's kernels and joins it before phase 9:
    its ranks hold at most ~52 GB of the card (llama3-8b's one process),
    phases 3 to 8 time no kernel, and phases 10 and 11 size their models
    by the card's free memory."""
    from repro_torch.distributed import spawn
    t0 = time.perf_counter()
    out = spawn(_train_tp_rank, TP, (), data=2, backend=TP_BACKEND,
                device="cuda", timeout_s=900)
    return {"out": out, "wall_s": time.perf_counter() - t0}


def phase_train_tp(device, spawned: Background) -> dict:
    """Phase 17 (see the module doc): the spawn's result (``spawned``, a
    :class:`Background` of :func:`train_tp_spawn`); per case the one
    process, tp = 2 and FSDP over (2, 2), each held against the one
    process."""
    from repro_torch.distributed.sharding import ServingMesh, training_plan
    del device
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    run = spawned.join()
    out = run["out"]
    res = {"card": card, "wall_s": run["wall_s"], "cases": {},
           "launch_rows": [], "warm_s_per_rank": out["warm_s"],
           "note": "beside phases 3 to 8 (shared card)"}
    print(f"  train_tp spawn: {run['wall_s']:.1f} s", file=sys.stderr,
          flush=True)
    print(f"  train_tp warm-up per rank: {out['warm_s']}", file=sys.stderr,
          flush=True)
    for arch, replace, batch, seq, held in TRAIN_TP_CASES:
        cfg = train_tp_config(arch, replace)
        got = out[arch]
        print(f"  train_tp {arch}: " + ", ".join(
            f"{k} {got[k]:.1f} s" for k in ("one_s", "tp2_s", "fsdp_s")),
            file=sys.stderr, flush=True)
        one = got["one"]
        check_train_launches_rows(one["rows"], cfg, 1, f"train_tp {arch} one process")
        full = train_tp_config(arch, {})
        case = {"model": {"arch": arch, "dtype": cfg.dtype, "batch": batch,
                          "seq": seq, "steps": TRAIN_TP_STEPS,
                          "reduced": {k: f"{v} of {getattr(full, k)}"
                                      for k, v in replace.items()}},
                "one": {"step_ms": [r["ms"] for r in one["rows"]],
                        "losses": [r["loss"] for r in one["rows"]],
                        "peak_bytes": one["peak_bytes"],
                        "launches_per_step": one["rows"][0]["launches"]},
                "seconds": {k: got[k] for k in ("one_s", "tp2_s", "fsdp_s")}}
        print(json.dumps({"train_tp_one": {"card": card, "arch": arch,
                                           **case["one"]}}))
        case["tp2"] = train_tp_check(f"{arch} tp2", got["tp2"], one, cfg,
                                     training_plan(ServingMesh(1, TP)), batch, seq,
                                     held)
        case["fsdp"] = train_tp_check(
            f"{arch} fsdp_2x2", got["fsdp"], one, cfg,
            training_plan(ServingMesh(2, TP), fsdp=True), batch, seq, held)
        if arch in TRAIN_TP_PLANTS:
            case["planted"] = train_tp_planted_check(
                arch, got["planted"], case["tp2"]["grad_tol"])
        res["cases"][arch] = case
        res["launch_rows"] += ([{"launches": r["launches"]} for r in one["rows"]]
                               + [{"launches": row["launches"]}
                                  for key in ("tp2", "fsdp") if key in got
                                  for rk in got[key]["ranks"]
                                  for row in rk["rows"]])
    return res


# ---------------------------------------------------------------------------
# phase 18: one rank of a dry-run cell on the card
# ---------------------------------------------------------------------------

# chameleon-34b decode_32k at (16, 16): 8 sequences of the global 128 over
# a cache split by sequence (2,048 of 32,768 rows of every KV head), the
# rank's 4 of 64 query heads, no FSDP (the reference's decode default);
# ~4.3 GB of weights and 3.2 GB of cache drawn on the card from the seed
# qwen3-14b decode_32k at (16, 16): its 40 / 8 heads split unevenly over
# the model axis; rank 0 (the reckoned one) holds 3 query heads on 1 KV
# head, the most of any rank; ~1.8 GB of weights and 5.4 GB of cache
DRYRUN_CELLS = (("chameleon-34b", "decode_32k", (4, 1)),
                ("qwen3-14b", "decode_32k", (3, 1)))
DRYRUN_PEAK_TOL = 0.05


def dry_run_cell(arch: str, shape: str) -> dict:
    """``launch.dryrun.run_cell`` on the card (its fake process group is
    this process's default group while the cell runs and is destroyed
    with it: no later phase sees it), the kernel launches of its two card
    steps (warm-up and measured) beside it."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    art = dryrun.run_cell(arch, shape, device="cuda", verbose=False)
    art["launches"] = ops.launch_counts()
    art["wall_s"] = time.perf_counter() - t0
    return art


def phase_dryrun(device) -> dict:
    """One rank of each of ``DRYRUN_CELLS`` on the production mesh (16,
    16), one after the other in this process, run on the card under
    torch's fake process group, held against the ``meta`` reckoning of the
    same step: the rank's query / KV heads, the step's peak allocation
    above its arguments within ``DRYRUN_PEAK_TOL`` of the reckoned peak,
    the collectives by kind and bytes equal, the slice and merge entries
    launched once per layer per step; the step's device ms printed beside
    the roofline's terms (``H100_SXM`` data-sheet rates).  The fake group
    moves no data: the logits are not read.  ``serve_cli_tp`` (phase 15's
    CLI run) runs beside it."""
    del device
    cli = Background(serve_cli_tp)
    try:
        cells = [dryrun_cell_check(arch, shape, heads)
                 for arch, shape, heads in DRYRUN_CELLS]
    finally:
        served = cli.join()
    launches = {}
    for c in cells:
        for k, v in c["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"cells": cells, "launches": launches, "serve_cli_tp": served}


def dryrun_cell_check(arch: str, shape: str, heads: tuple) -> dict:
    """One cell of ``phase_dryrun``."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    torch.cuda.empty_cache()
    art = dry_run_cell(arch, shape)
    if "refused" in art or "refused" in art.get("card", {"refused": "none"}):
        raise AssertionError(f"dry run {arch} {shape} refused: {art}")
    from repro_torch.models.registry import get_config
    on_card, mem = art["card"], art["memory"]
    L = get_config(arch).n_layers
    reckoned = mem["temp_size_in_bytes"]
    peak = on_card["peak_above_arguments"]
    rank = art["meta"]["rank_heads"]
    if (rank["query"], rank["kv"]) != heads or rank["most_query"] != heads[0]:
        raise AssertionError(f"dry run {arch}: rank 0's heads {rank}")
    out = {"cell": [arch, shape], "mesh": art["meta"]["mesh"],
           "rank_heads": rank,
           "card": card, "step_ms": on_card["step_ms"],
           "roofline_ms": {k: art["roofline"][k] * 1e3 for k in
                           ("compute_s", "memory_s", "collective_s")},
           "roofline_hw": art["roofline"]["hw"],
           "peak_above_arguments": peak, "reckoned_peak": reckoned,
           "peak_ratio": peak / reckoned,
           "argument_bytes": on_card["argument_bytes"],
           "reckoned_argument_bytes": mem["argument_size_in_bytes"],
           "state_bytes_per_device": art["meta"]["state_bytes_per_device"],
           "collectives": art["collectives"], "launches": art["launches"],
           "trace_s": art["timing"]["trace_s"], "wall_s": art["wall_s"]}
    print(json.dumps({"dryrun": out}))
    if abs(peak - reckoned) > DRYRUN_PEAK_TOL * reckoned:
        raise AssertionError(f"dry run peak {peak} bytes against the "
                             f"reckoned {reckoned}")
    if on_card["collectives"] != art["collectives"]:
        raise AssertionError(f"dry run collectives {on_card['collectives']} "
                             f"!= the reckoned {art['collectives']}")
    c = art["launches"]
    if (c["decode_attention_slice"], c["decode_merge_ranks"],
            c["decode_attention"]) != (2 * L, 2 * L, 0):
        raise AssertionError(f"dry run launches {c}")
    return out


def _strip_logits(run: dict) -> dict:
    out = {**run, "passes": [{k: v for k, v in p.items()
                              if k not in ("logits", "lora_logits")}
                             for p in run["passes"]]}
    if "seq" in run:
        out["seq"] = [{k: v for k, v in r.items() if k != "logits"}
                      for r in run["seq"]]
    return out



def kernel_summary(kernels: list, serve: list, engine: list,
                   tidal_row: dict, tenants: dict, ssm: dict,
                   big: tuple = (), xlstm: dict | None = None,
                   whisper: dict | None = None, train: dict | None = None,
                   tp: dict | None = None, cluster: dict | None = None,
                   train_tp: dict | None = None,
                   dryrun: dict | None = None) -> list:
    """One entry per kernel (and the int8 variant) at the main path's
    shapes, with its launches from the serving phases (3, 5, 6, 7 and 8,
    the serving, engine and FaaS passes of ``big``: phases 9, 10 and 11,
    those of ``xlstm``: phase 12, and ``whisper``'s Engine: phase 13),
    the training runs of phase 14 (``train``; the backward kernels run
    there only), every rank's invocations of phase 15 (``tp``: its
    passes, its LoRA functions and its two rank groups), the
    two instances' invocations and service-time measurements of phase 16
    (``cluster``), every rank's training steps of phase 17
    (``train_tp``), phase 15's ``prefer_seq`` decodes and phase 18's rank
    (``dryrun``)."""
    def pick(**kw):
        return next(r for r in kernels if all(r.get(k) == v for k, v in kw.items()))

    launches = {"paged": 0, "int8": 0, "flash": 0, "decode": 0, "rmsnorm": 0,
                "rmsnorm_fused": 0, "rmsnorm_split": 0, "ssd": 0,
                "flash_bwd": 0, "rmsnorm_bwd": 0, "ssd_bwd": 0,
                "rmsnorm_split_bwd": 0, "slice": 0, "merge": 0}
    cp = tenants["control_plane"]
    rows = (list(serve) + list(engine) + [tidal_row, tenants,
                                          cp["learned_prefix"], cp["open_loop"]]
            + [ssm["serve"], ssm["engine"], ssm["engine_prompts_continuous"],
               ssm["faas"]])
    for phase in big:
        rows += list(phase["serve"]) + [phase["engine"],
                                        phase["engine"]["continuous"]] + [
            phase[k] for k in ("faas", "faas_lora") if k in phase]
    if xlstm is not None:
        rows += [xlstm["serve"], xlstm["engine"],
                 xlstm["engine_prompts_continuous"], xlstm["faas"]]
    if whisper is not None:
        rows.append(whisper["engine"])
    if train is not None:
        rows += [train["smollm"], {"launches": train["smollm"]["resume_launches"]},
                 train["zamba"], train["moe"], train["whisper"]]
    if tp is not None:
        for tag, *_ in TP_CASES:
            for run in ("tp1", "tp2"):
                for p in tp[tag][run]["passes"]:
                    rows += [{"pass": p["pass"], "launches": counts}
                             for r in p["requests"]
                             for counts in r["launches_per_rank"]]
                lora = tp[tag][run].get("lora")
                if lora is not None:
                    rows += [{"launches": counts} for counts in
                             lora["shared"]["launches_per_rank"]]
                    rows += [{"launches": counts} for r in lora["merged"]
                             for counts in r["launches_per_rank"]]
        rows += [{"launches": counts} for r in tp["instances"]["requests"]
                 for counts in r["launches_per_rank"]]
        rows += [{"launches": r["launches"]} for tag in TP_SEQ_CASES
                 for run in ("tp1", "tp2") for r in tp[tag][run]["seq"]]
        rows += [{"launches": c} for tag, _ in TP_WHISPER_CASES
                 for c in tp[tag]["launches"]]
    if cluster is not None:
        rows += [cluster["instances"], {"launches": cluster["measure_launches"]}]
    if train_tp is not None:
        rows += train_tp["launch_rows"]
    if dryrun is not None:
        rows.append({"launches": dryrun["launches"]})
    for row in rows:
        key = "int8" if row.get("pass") == "int8" else "paged"
        launches[key] += row["launches"]["paged_decode_attention"]
        launches["flash"] += row["launches"]["flash_attention"]
        launches["decode"] += row["launches"]["decode_attention"]
        launches["rmsnorm"] += row["launches"]["rmsnorm"]
        launches["rmsnorm_fused"] += row["launches"]["rmsnorm_fused"]
        launches["rmsnorm_split"] += row["launches"].get("rmsnorm_split", 0)
        launches["ssd"] += row["launches"]["ssd_scan"]
        launches["flash_bwd"] += row["launches"].get("flash_attention_bwd", 0)
        launches["rmsnorm_bwd"] += row["launches"].get("rmsnorm_bwd", 0)
        launches["ssd_bwd"] += row["launches"].get("ssd_scan_bwd", 0)
        launches["rmsnorm_split_bwd"] += row["launches"].get("rmsnorm_split_bwd", 0)
        launches["slice"] += row["launches"].get("decode_attention_slice", 0)
        launches["merge"] += row["launches"].get("decode_merge_ranks", 0)
    entries = [
        ("paged_decode_attention",
         pick(kernel="paged_decode_attention", case="serving", shape="smollm",
              B=8, q_dtype="bfloat16", kv_dtype="bfloat16"),
         "src/repro_torch/csrc/paged_decode_attention.cu",
         "src/repro/kernels/paged_decode_attention.py:129", launches["paged"]),
        ("paged_decode_attention[int8]",
         pick(kernel="paged_decode_attention", case="serving", shape="smollm",
              B=8, q_dtype="bfloat16", kv_dtype="int8"),
         "src/repro_torch/csrc/paged_decode_attention.cu",
         "src/repro/kernels/paged_decode_attention.py:129", launches["int8"]),
        ("flash_attention",
         pick(kernel="flash_attention", shape="smollm", S=384, T=384,
              dtype="bfloat16"),
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:86", launches["flash"]),
        ("decode_attention",
         pick(kernel="decode_attention", case="serving", shape="smollm",
              dtype="bfloat16"),
         "src/repro_torch/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention.py:76", launches["decode"]),
        ("rmsnorm",
         pick(kernel="rmsnorm", shape="smollm-decode", dtype="bfloat16"),
         "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm.py:25", launches["rmsnorm"]),
        # the residual form: a subset of the rmsnorm launches above
        ("rmsnorm[residual]",
         pick(kernel="rmsnorm[residual]", shape="smollm-decode", dtype="bfloat16"),
         "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm.py:25", launches["rmsnorm_fused"]),
        ("ssd_scan",
         pick(kernel="ssd_scan", B=1, S=200, bc_dtype="bfloat16"),
         "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd_scan.py:79", launches["ssd"]),
    ]
    if tp is not None:
        # the split-row form (two launches per norm over a row split by
        # tensor parallelism): phase 15's zamba and xLSTM ranks
        entries.append(
            ("rmsnorm_split",
             pick(kernel="rmsnorm_split", shape="zamba2-mamba-norm/tp2",
                  dims=[8, 1, 2560], dtype="bfloat16"),
             "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:25", launches["rmsnorm_split"]))
    if train is not None:
        entries += [
            ("flash_attention_bwd",
             pick(kernel="flash_attention_bwd", shape="smollm", S=128, T=128),
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:86", launches["flash_bwd"]),
            ("rmsnorm_bwd",
             pick(kernel="rmsnorm_bwd", shape="smollm-train"),
             "src/repro_torch/csrc/rmsnorm_bwd.cu",
             "src/repro/kernels/rmsnorm.py:25", launches["rmsnorm_bwd"]),
            ("ssd_scan_bwd",
             pick(kernel="ssd_scan_bwd", shape="zamba2-train"),
             "src/repro_torch/csrc/ssd_scan_bwd.cu",
             "src/repro/kernels/ssd_scan.py:79", launches["ssd_bwd"]),
        ]
    if train is not None and train_tp is not None:
        # the split-row backward: phase 17's zamba and xLSTM ranks
        entries.append(
            ("rmsnorm_split_bwd",
             pick(kernel="rmsnorm_split_bwd", shape="zamba2-mamba-norm/tp2"),
             "src/repro_torch/csrc/rmsnorm_bwd.cu",
             "src/repro/kernels/rmsnorm.py:25", launches["rmsnorm_split_bwd"]))
    if tp is not None and dryrun is not None:
        # the rank split of dense decode: phase 15's prefer_seq decodes
        # and phase 18's rank
        entries += [
            ("decode_attention_slice",
             pick(kernel="decode_attention_slice", case="rank"),
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:76", launches["slice"]),
            ("decode_merge_ranks", pick(kernel="decode_merge_ranks", case="rank"),
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:76", launches["merge"])]
    out = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
           for name, r, src, rep, n in entries]
    if not all(e["launches"] > 0 for e in out):
        raise AssertionError(f"a kernel never ran on the main path: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT,
                    help="directory for chip_smoke.json")
    ap.add_argument("--first-ttft", choices=["prewarm", "no-prewarm"],
                    help=argparse.SUPPRESS)    # phase 6's fresh-process probe
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    _import_port()
    if args.first_ttft:
        print(json.dumps(first_ttft(args.first_ttft)))
        return 0
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phases = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*a)
        peak = torch.cuda.max_memory_allocated()
        release_host_memory()
        torch.cuda.empty_cache()
        phases[name] = time.perf_counter() - t
        mem = meminfo()
        free, total = torch.cuda.mem_get_info()
        line = (f"phase {name}: {phases[name]:.1f} s (host memory "
                f"{mem['host_available_gb']:.1f} of {mem['host_total_gb']:.1f} GB "
                f"available; {torch.cuda.memory_allocated() / 1e9:.3f} GB "
                f"allocated on the card, peak {peak / 1e9:.1f}; "
                f"{(total - free) / 1e9:.1f} GB of the card in use by all "
                f"processes)")
        print(line)
        print(line, file=sys.stderr, flush=True)   # the short stream
        return out

    dev = timed("device", phase_device)
    h2d = dev["h2d_bytes_per_s"]
    kernels = timed("kernels", phase_kernels, device)
    kernels += timed("ssm_kernels", phase_ssm_kernels, device)
    # phase 17's ranks run beside phases 3 to 8 (Background, train_tp_spawn)
    train_tp_ranks = Background(train_tp_spawn)
    model, params = full_model(device)
    serve, paged_tokens = timed("serve", phase_serve, model, params)
    parity = timed("parity", phase_parity, device)
    engine = timed("engine", phase_engine, model, params, paged_tokens)
    del model, params
    tidal_row = timed("tidal", phase_tidal, device, dev["h2d_bytes_per_s"])
    tenants = timed("tenants", phase_tenants, device, dev["h2d_bytes_per_s"])
    torch.cuda.empty_cache()
    ssm = timed("ssm", phase_zamba, device, h2d)
    train_tp = timed("train_tp", phase_train_tp, device, train_tp_ranks)
    llama = timed("llama", phase_llama, device, h2d)
    moe = timed("moe", phase_moe, device, h2d)
    deepseek = timed("deepseek", phase_deepseek, device)
    xlstm = timed("xlstm", phase_xlstm, device, h2d)
    kernels += xlstm["kernels"]
    whisper = timed("whisper", phase_whisper, device)
    kernels += whisper["kernels"]
    train = timed("train", phase_train, device)
    kernels += train["kernels"]
    tp = timed("tp", phase_tp, device)
    cluster = timed("cluster", phase_cluster, device, h2d)
    dryrun = timed("dryrun", phase_dryrun, device)
    summary = kernel_summary(kernels, serve, engine, tidal_row, tenants, ssm,
                             (llama, moe, deepseek), xlstm, whisper, train, tp,
                             cluster, train_tp, dryrun)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke.json").write_text(json.dumps(
        {"device": dev, "kernels": kernels, "serve": serve, "parity": parity,
         "engine": engine, "tidal": tidal_row, "tenants": tenants, "ssm": ssm,
         "llama": llama, "moe": moe, "deepseek": deepseek, "xlstm": xlstm,
         "whisper": whisper, "train": train, "tp": tp, "cluster": cluster,
         "train_tp": {k: v for k, v in train_tp.items()
                      if k != "launch_rows"},
         "dryrun": dryrun,
         "summary": summary,
         "phases_s": phases,
         "seconds": time.perf_counter() - t0}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
