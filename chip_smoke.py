"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Phases, run
in the order 1, 2, 5-13, 15-24, 3, 4, 25, 26, 27, 28, 30, 29, 14 (the
water-fill's last: once its tier-1m case has run, `torch.profiler` reads
no device events in the same process --
`repro_torch.kernels.waterfill.study` finds where -- so every phase that
reads the profiler runs first); any
failure raises and exits non-zero (nothing is caught, and nothing falls
back to the CPU or to a plain version):

  1. the card: name and power limit as nvidia-smi reports them;
  2. build every kernel from the checkout's CUDA sources, one nvcc per
     source, all started together (water-fill, flash attention, SSD and
     grouped matmul, each with its backward), with ptxas' register and
     shared-memory report;
  3. the water-fill kernel against its plain PyTorch version on the card,
     on the matchmaking tiers (10k/100k/1m jobs), a fractional-request
     problem, a finite budget with an `active` mask, a drained pool, a
     worker whose memory lies a rounding below zero (the JAX package's
     drain guard skips its claims), worker counts 129/1000/1500/6000/
     8000 (one to sixteen lanes a thread, part of the carry in shared
     memory) and float32, each on every instance the call can take --
     "staged" and PR 11's "rounds" -- with takes equal and free_after
     bitwise; the matchmaker's plan against the NumPy backend's: takes
     equal, free_after within 1e-7.  The routed solve (the launch
     `match()` makes) and PR 11's instance timed by CUDA events (median
     of 20) and by device time (`queued_ms`), beside the staged instance
     dividing every lane, the divide probe (no divide at all), the
     bytes/operations bound and the step-floor probe (the
     scan-and-barrier skeleton alone, one step per cohort it works on).  Then K = 1, 2, 8 cycles
     (`waterfill_cycles`: one launch, deltas with arrivals, returned
     capacity and budgets) and N = 1, 8 candidates (`waterfill_preview`:
     one launch, with and without demands) on the 10k tier and the
     fractional problem, each against its plain loop bitwise, and
     `match_cycles`/`preview_many` against `sequential_match_cycles`/
     `sequential_preview_many` on the NumPy backend; K = 8 timed against
     8 `match` calls, a preview session hit against a miss;
  4. end to end: `run_policy` over the 10k-job diurnal day on the
     standard 3-provider federation with ``[provision] matchmaker=torch``
     against the same run on the NumPy backend (equal jobs, pods, cost
     and Fig 2/3 series, every job completed), then a 2k-job 3-schedd
     fair-share day the same way, then a `FUSION_JOBS` (2k) day at
     ``negotiation_batch=8`` at the live-fusion cadence (negotiate every
     20 s inside a 60 s tick and metrics grid: the standard grid leaves
     no window to fuse in), where fused batches must occur and each must
     be one "cycles" launch, and the same day at batch 1 (its launches,
     and whether the blocks are equal: not a gate).  The kernel's launches in all, by
     entry point and by instance, are read from each run; then the
     largest problem of the 10k day is timed and `match()` broken down
     on the host clock (prep, copy in, kernel and wait, copy out and
     scatter);
  5. the flash-attention kernel against its plain PyTorch version
     (float32) on the card, each call through the instance `flash_route`
     names (the decode split for at most 32 query rows per kv head, the
     tensor cores for bfloat16 with Dh 64 or 128, SIMT for the rest): the
     reference suite's eight cases in float32 and bfloat16, fully masked
     rows, the rolling-window permutation, the tensor-core edge cases
     (two calls bitwise equal), and qwen2-1.5b's serving shapes (prefill
     B=1, Sq=Skv=512 and 2048; decode B=8, Sq=1 against the engine's
     2048-slot cache) in float32 and in bfloat16, the bfloat16 calls
     timed (CUDA events, and the kernels' device time from the profiler)
     beside their bound, the plain version and SDPA (a yardstick only);
     the decode split at G = 1 against a 1500-slot cache without a
     causal mask (twice, bitwise); then whisper-medium's and
     llava-next-mistral-7b's calls (`MODAL_FLASH_CALLS`: whisper's
     encoder, cross prefill and cross tick, its decoder's prefill and
     tick, llava's prefix prefill and tick) in both dtypes, each on the
     instance the serving gates count it on, four of them timed in
     bfloat16 (`MODAL_FLASH_TIMED`) beside their bound and SDPA with its
     own mask; the group sizes of phases 21-24 (`FLASH_GROUP_CASES`: G =
     9, 8 and 5 at Dh 128 on the tensor cores, Sq ending inside a packed
     tile, an empty batch row; `FLASH_GROUP_DECODE`: a tick of 8 slots on
     the split), each twice, bitwise; and each of those configurations'
     1024-token prefill and decode tick (`CONFIG_FLASH_CALLS`) in both
     dtypes, timed in bfloat16 like the modal calls (a tick's SDPA takes
     the positions' mask: its own causal mask is aligned top-left);
  6. qwen2-1.5b at full width (28 layers, random weights from a seeded
     generator): forward logits with the kernel against the same model
     with attention forced through the plain version, in float32 and in
     bfloat16; prefill of a prefix then token-by-token decode against the
     teacher-forced forward in float32; a float32 engine with the serving
     run's slots and cache gives the same greedy tokens with the kernel
     as with the plain version;
  7. serving qwen2: `ServeEngine` in bfloat16 with 8 slots and a
     2048-token cache, 16 requests of 64-1024 prompt tokens and 32 new
     tokens each; every request must finish, and the flash kernel's
     launches must equal 28 x (prefill calls + decode ticks): 28 x
     prefill calls on the tensor-core instance, 28 x ticks on the split
     (`expected_flash_routes`).  Then
     tokens/s, prefill ms, decode ms per tick, and a `torch.profiler`
     pass over decode ticks (device busy and idle share; the kernel's,
     GEMM and unembedding device time; launches and synchronisations per
     tick), and a profiled 1024-token prefill (its wall beside the
     device's busy time and the port's kernels' share); then the spot
     reclaim of examples/spot_serving.py at full width;
  8. the SSD kernel against its plain chunked version and the sequential
     oracle on the card, y and the final state, each call through the
     instance `ssd_route` names (the tensor-core passes for bfloat16 with
     P and N 64 or 128 and a chunk that is a multiple of 64, SIMT for the
     rest): the reference suite's four cases in float32 (2e-3) and
     bfloat16 (5e-2), the tensor-core edge cases (`SSD_TC_CASES`: S = 1,
     63, 65, 200 and 777, one chunk and several, 2 and 4 heads a group, N
     and P 64 and 128, with and without an initial state, strided views;
     each twice, bitwise equal), then mamba2-1.3b's serving shapes (B=1,
     64 heads of 64, d_state 128, one group, chunk 256; S = 512, 1024
     and a ragged 777, with and without an initial state) in both dtypes;
     then mamba2's and jamba's (128 heads of 64, d_state 64) bfloat16
     prefill at S = 512 and 1024 timed (CUDA events, and the passes'
     device time from the profiler) on the tensor cores and on the SIMT
     instance, beside their bound and the plain version (no single
     PyTorch call computes the scan, so there is no library yardstick);
  9. mamba2-1.3b at full width (48 layers, random weights from a seeded
     generator): the gates of phase 6 with the SSD scan forced through
     its plain version in place of attention; the float32 engine's scans
     all on the SIMT instance;
 10. serving mamba2 like phase 7 (same slots, requests and lengths); the
     SSD kernel's launches must equal 48 x prefill calls (decode runs the
     plain one-token update), every one on the tensor-core instance
     (`expected_ssd_routes`), then the decode-tick and prefill
     profiles;
 11. the grouped-matmul kernel against its plain version on the card,
     each call through the instance `gmm_route` names (the tensor-core
     instance for bfloat16 whose K and N are multiples of 8, the SIMT one
     for float32 and the rest): the reference suite's four cases in
     float32 (1e-4) and bfloat16 (5e-2), ragged groups (unaligned, empty,
     a tail; also bfloat16 in, float32 out), the tensor-core edge cases
     (one group holding every row, a short group between long ones, N
     and K ending inside a tile; two calls bitwise equal), then
     jamba-v0.1-52b's expert products (16 experts, 4096 x 14336, gate/up
     and down) at a prefill of 1024 and of 512 tokens and at a decode
     tick of 8 slots, in float32 and in bfloat16 with float32 output, the
     bfloat16 calls timed beside their bound, the stream-only probe (the
     tensor-core ring without its products), the plain version and
     `torch.bmm` (a yardstick only); then one full-width MoE layer,
     kernel against plain, in both dtypes;
 12. jamba at full width, depth cut to one period (8 layers: 7 Mamba, 1
     attention, 4 MoE FFNs) in float32: forward with every kernel
     against every plain version, prefill + decode against the forward,
     the float32 engine's greedy tokens with the kernels and without;
 13. jamba at full width, depth cut to two periods (16 layers, bfloat16,
     ~52 GB; the published 32 are ~103 GB): forward with the kernels
     against the plain versions over the positions before the first one
     routed to other experts, then serving like phase 7; every launch
     count must equal `expected_launches` (gmm 3 x 8 x (prefills +
     ticks), flash 2 x (prefills + ticks), SSD 14 x prefills), every
     gmm launch must have taken the tensor-core instance, flash's
     prefills the tensor-core instance and its ticks the split, and every
     SSD launch the tensor-core instance; then the decode-tick and
     prefill profiles;
 15. training: the forward's log-sum-exp (`flash_attention_forward`, each
     instance's against the plain one's within `LSE_TOL`, +inf on the
     rows that see no key) and flash attention's backward kernel against
     its plain version (`attention_backward_reference`, given that lse)
     on `FLASH_BWD_CASES` (the reference suite's shapes, fully masked
     rows, softcap, window, G = 1, 4 and 6, a shape the forward sends to
     the decode split) in float32 (1e-4 of each gradient's max) and
     bfloat16 (2e-2), each call through the instance `flash_bwd_route`
     names (the tensor cores for bfloat16 with Dh 64 or 128, SIMT
     otherwise), two calls bitwise equal, then timed at qwen2-1.5b's
     training shapes (B = 8, S = 512 and B = 2, S = 2048; the routed
     instance and the SIMT one at the same shape: CUDA events, device
     time in all and by kernel (`dot`, `dkdv`, `dq`), the bound, the
     plain backward, SDPA's backward as a yardstick), and at whisper's
     encoder's (B = 8, 1500 x 1500, 16 heads of 64, no causal mask);
     qwen2 at
     full width cut to 2 layers in float32: loss and every gradient leaf
     with the kernels against attention through the plain version; the
     same 2 layers in bfloat16 with the kernels against the float32
     model of the same weights through the plain attention; then the
     main path: `repro_torch.launch.train.run_fixed` on qwen2-1.5b at
     full width (cut to `TRAIN_LAYERS`, 8 of 28 layers, bfloat16, random
     weights from a seed), 6 steps of 8 x 512 tokens with checkpoints at
     steps 3 and 6: every loss finite, each step 8 flash forward
     launches and 8 backward
     launches, all on the tensor-core instances; step time, tokens/s,
     peak device memory; then the step-3 checkpoint restored into a fresh
     state (every parameter, both moments and the step bit for bit the
     first run's after step 3) retakes steps 4-6 (one profiled: the
     device's busy share and the backward's share) with losses within
     `RESUME_TOL` of the first run's;
 16. training mamba2: the SSD scan's backward kernel (`ssd_bwd.cu`)
     against the plain backward (`ssd_backward_reference`, given the
     states the forward kept) on `SSD_CASES` (both dtypes), the
     tensor-core edge cases `SSD_TC_CASES` (ragged tails, an initial
     state, G > 1, fused views), the tensor-core backward's own
     `SSD_BWD_TC_CASES` and `SSD_BWD_DFINAL` (a final-state gradient),
     each gradient within `SSD_BWD_TOL` of its max (1e-4 in
     float32, 2e-2 in bfloat16), each call on the instance `ssd_route`
     names, two calls bitwise equal; then timed at `SSD_BWD_TIMED`
     (mamba2's B = 8, S = 512 and B = 2, S = 2048, jamba's heads at B =
     2, S = 2048; the routed instance and the SIMT one: CUDA events,
     device time in all and by kernel, the bound, the plain backward);
     mamba2 at full width cut to 2 layers in float32, kernels against the
     plain scan (loss 1e-5, each leaf 1e-4, one `ssd` and one `ssd_bwd`
     launch a layer), then in bfloat16 against that float32 model; then
     the main path: `run_fixed` on mamba2-1.3b at full width (cut to
     `TRAIN_LAYERS`, 16 of 48 layers, bfloat16), 6 steps of 8 x 512 with
     checkpoints at steps 3 and 6: every loss finite, each step 16 `ssd`
     and 16 `ssd_bwd` launches and
     nothing else, all on the tensor-core instances; step time, tokens/s,
     peak memory, and step 2 profiled, outside steps 3-6 (busy share,
     the backward's and the optimizer's shares; qwen2's run already
     checks the resume);
 17. training jamba: the grouped matmul's backward kernel (`gmm_bwd.cu`)
     against the plain backward (`gmm_backward_reference`) on the
     reference suite's cases and the ragged ones in both dtypes (1e-4 and
     2e-2 of each gradient's max), the tensor-core edge cases in bfloat16,
     `GMM_BWD_STAGE_CASES` (groups ending inside drhs's 64-row stages)
     and `GMM_BWD_TILE_CASES` (the 128 x 256 tiles and their clusters at
     the edges of groups, K and N) in both, each on the instance
     `gmm_route` names, two calls bitwise equal, the padding rows' dlhs
     and the empty groups' drhs exactly 0; ptxas' report and the
     clusters of drhs's persistent grid; then timed at jamba's training
     products (8 x 512 tokens: 10,240 rows in 16 groups; gate/up and
     down, bfloat16 in, float32 dout): CUDA events and device time of the
     whole backward, of dlhs and of drhs alone, beside each one's bound,
     its floor probe (the kernel without its products), the plain
     backward and `torch.bmm` (a yardstick); one full-width MoE layer of
     4096 tokens, forward and backward, kernels against autograd through
     the plain version in float32 (1e-4) and bfloat16 (2.5e-2) with the
     auxiliary loss equal and two backward passes bitwise, the second
     timed; jamba at full width cut
     to one period (8 layers, bfloat16, 13.3e9 parameters): `loss_fn`
     and its backward with every kernel (exact launches of the six
     kernels and their instances), the gradients moved to host memory,
     then the plain versions with the routes pinned to the kernels side's
     (`GATE_PERIOD_LOSS`, `GATE_PERIOD_GRAD`; each side's peak memory);
     then the main path: `run_fixed` on the reduced jamba (float32, head
     dim 32) for 6 steps of 8 x 512 with checkpoints at steps 3 and 6,
     each step's launches and instances exact, the resume from step 3,
     and steps 4-6 on the CPU from that checkpoint within 1e-5;
 18. whisper-medium at full width (24 encoder and 24 decoder layers,
     16 heads of 64, 1500 frames from `stub_modality_inputs`, random
     weights from a seeded generator): phase 6's gates (float32 and
     bfloat16 forward, kernel against plain attention; float32 prefill of
     256 tokens then decode against the forward); the float32 serving
     loop (`serve_loop`: `ServeEngine` takes tokens alone) gives the same
     greedy tokens with the kernel as with the plain version; then the
     main path, the bfloat16 loop over 8 requests of 48-224 prompt tokens
     (numpy seed 11), each with its own frames, 32 new tokens each:
     every prefill launches 72 flash calls on the tensor cores (24
     encoder, 24 decoder, 24 cross), every tick 48 on the decode split
     (24 decoder, 24 cross against the read-only cross cache), nothing
     else launched; prefill ms, decode ms a tick, tokens/s, and a
     profiled tick's device busy time and flash share;
 19. llava-next-mistral-7b at full width (32 layers, 32 / 8 heads of
     128, the 576-position patch prefix from 1024-wide patches): the same
     gates (float32 at full width, 29 GB of weights), with prompts of
     64-448 text tokens after the prefix: 32 tensor-core calls a prefill,
     32 split calls a tick;
 20. training whisper (its encoder's backward, B 8, 1500 x 1500 without
     a causal mask, is timed in phase 15 beside qwen2's shapes): the
     2-layer gates with 2 encoder layers (float32
     kernels against plain, each leaf 1e-4; bfloat16 against the float32
     plain model, the loss within `GATE_WHISPER_TRAIN_BF16_LOSS`, the
     leaves within qwen2's limit; a key bias, whose gradient is 0 in exact
     arithmetic without RoPE, against the largest gradient: `leaf_errors`;
     every encoder leaf a nonzero gradient, through the cross-attention's
     dk and dv), then the main path: `run_fixed` at full depth, 6 steps of
     8 x 224 text tokens and 8 x 1500 frames, each step 72 flash forward
     and 72 backward launches, all on the tensor cores; step time,
     tokens/s, peak memory, step 2 profiled;
 21-24. granite-8b (36 layers), starcoder2-7b (32), qwen3-32b (64) and
     llama4-scout-17b-a16e (8 of its 48: two periods of three chunked
     layers and a global NoPE one) at full width (`CONFIGS`,
     `config_phase`): phase 6's gates at 2 layers (llama4: one period of
     4, every kernel against its plain version, no bfloat16 gate there),
     the float32 engine's greedy tokens with the kernels and without;
     for llama4 then `window_phase` (a 9,216-token prompt through its
     8,192-key chunked window: prefill of 9,200 tokens and 16 decodes
     through the wrapping rolling cache against the forward, at a
     capacity that drops nothing), its expert products (16 experts, 5120
     <-> 8192, a 1024-token prefill and a tick) against the plain version
     and timed beside `torch.bmm`, and the routed bfloat16 gate at 8
     layers; then serving in bfloat16 like phase 7 with exact launches
     and routes (llama4: every gmm launch on the tensor cores), the tick
     and prefill profiles, the serving peak memory; granite-8b also runs
     the spot reclaim;
 25. the pool service (`service_phase`): `python -m repro_torch.service
     smoke`'s sequence on the standard federation with ``[provision]
     matchmaker = torch`` (a 2,000-job diurnal day at seed 7 submitted at
     trace times over HTTP, the spot provider drained at t = 30,000 s, a
     snapshot once the clock passes 10,000 s, the service shut down, a
     new one resumed from the snapshot and run until drained) against the
     uninterrupted run on the NumPy backend: completed stats, summary and
     series equal, jobs and core- and GPU-seconds conserved, spot
     detached, the /metrics, /metrics.prom and /trace surfaces complete;
     the water-fill's launches in the live run equal the matchmaker's
     calls of `match`, `match_cycles` and `preview_many`, more than 0;
     then the command line itself, `serve --ini ... --as-fast --start` in
     a process of its own driven by `submit`, `status` until drained,
     `snapshot` and `shutdown`, each exiting 0; a `{"service": ...}`
     line;
 26. `repro_torch.parallel` on one world of 8 ranks spawned on card 0
     (gloo; every rank builds nothing: the kernels are phase 2's), meshes
     of different shapes over the same ranks (`parallel_phase`,
     `PARALLEL_PLAN`): jamba-v0.1-52b's MoE layer at full width,
     expert-parallel on (data 4, model 2), 1024 tokens a "data" rank, at
     a capacity that drops nothing on either side, forward and backward in
     bfloat16 and forward in float32, against rank 0's one-device dense
     dispatch over the gathered tokens (y, dx, drouter, rank 0's expert
     shards and every expert gradient's norm, aux); qwen2-1.5b at full
     width (4 layers) sequence-parallel on (1, 8): loss_fn and its
     gradient in float32 (loss 1e-4, each leaf 1e-4 of its max), then in
     bfloat16 (loss 4.2e-4 of itself, each leaf's |diff| / |g| 2.5e-2); its sharded zero3 step at 2 layers on (4, 2), 3 steps of
     8 x 512 in float32, against rank 0's one-device step (loss 1e-4 of
     itself, parameters 2e-2); its int8-compressed step on (2, 2, 2) under base
     against the exact one (loss 1e-5, parameters 5e-2), each pod group's
     bits equal, the compressed mean within amax/127 (bfloat16).  Each rank's
     launches on each part's main path equal `parallel_launches`; a
     `{"parallel": ...}` line with each part's wall time per rank, each
     rank's peak memory and rank 0's launches by instance;
 27. in phase 26's world, after its parts (`PARALLEL_PLAN`'s "elastic"
     and "serve_mesh"): `run_elastic` on qwen2-1.5b at full width cut to
     2 layers, float32, 8 x 512 tokens, 4 steps: the control plane on
     rank 0 claims 4 workers at step 0 and 8 at step 2
     (`elastic_schedule`), the state zero3 on ranks 0-3, saved from them
     and restored onto all 8 at the rescale; held against this process's
     one-device `run_fixed` of the same steps (each loss 1e-4 of itself,
     the final parameters 2e-2); then `ServeEngine` on {"data": 8} under ``decode`` (a row a
     rank) and ``decode_sp`` (256 of the 2048 cache slots a rank, the
     ranks' flash outputs merged by their lse), 8 requests of 64-512
     prompt tokens and 16 new tokens: at 2 layers in float32 (greedy
     tokens equal to the one-device engine's) and at 8 of 28 layers in
     bfloat16 (the first tick's logits within 5e-2; where the tokens
     first part is printed), each rank's flash launches by instance
     exact (`serve_mesh_routes`); an `{"elastic": ...}` line (rescales
     with their save and restore seconds, each step's seconds and worker
     count, peaks by rank) and a `{"serve_mesh": ...}` line;
 28. in the same world, after phase 27's parts (`PARALLEL_PLAN`'s
     "tp_serve" and "tp_train"): activation tensor parallelism over
     "model".  `ServeEngine` under ``decode`` with phase 27's traffic,
     each rank keeping the "model" cut of the weights and computing its
     part of the heads, MLP columns, SSM heads and vocabulary:
     qwen2-1.5b on (data 4, model 2) and (data 2, model 4) (its 2 kv
     heads do not divide 4: the cache's slots are cut over "model") and
     mamba2-1.3b on (data 2, model 4), at 2 layers in float32 (greedy
     tokens equal to the one-device engine's, the first tick within
     1e-4) and in bfloat16 at `TRAIN_LAYERS` (qwen2 8 of 28 layers,
     mamba2 16 of 48; full depth until phase 30 joined the smoke: the
     time limit) (the first tick within 5e-2; a
     partial dropped from the sums over "model" must read above it);
     mamba2 cut to 2 layers in float32 trained under base on (4, 2), 3
     steps of 8 x 512, against rank 0's one-device step (losses 1e-4 of
     themselves, parameters 0.1 of the one-device run's change; a
     dropped partial above the loss bar); each rank's flash, SSD and SSD
     backward launches exact; `{"tp_serve": ...}` and `{"tp_train":
     ...}` lines with each rank's peak memory and resident weight bytes;
 29. the dry-run (`repro_torch.launch.dryrun`): (a) its command line in
     processes of its own, at once, for qwen2-1.5b × train_4k and ×
     prefill_32k on both production meshes and jamba-v0.1-52b ×
     decode_32k (`DRYRUN_CELLS`): each exits 0 with every result key, no
     error, and no CUDA context made in its process; (b) phase 15's step
     (qwen2-1.5b at `TRAIN_LAYERS`, 8 x 512, bfloat16) analysed on a mesh
     of one rank:
     its kernel sites per step equal `training_launches` and phase 15's
     measured launches per step, its argument bytes the state's
     (parameters and both moments) as phase 15 measured them, and its
     bound (the sites at the kernel model) over phase 15's median step
     at most `DRYRUN_BOUND_SLACK`; a `{"dryrun_cli": ...}` and a
     `{"dryrun_step": ...}` line (the ratio, the predicted peak against
     `torch.cuda.max_memory_allocated`, the card's name and power limit);
 30. in phase 26's world, after phase 28's parts (`PARALLEL_PLAN`'s
     "prefill_rows"; it runs before phase 29): a batched prefill,
     `make_prefill_step(..., batch=8)`, whose rows are cut over the mesh
     as the reference lowers its prefill, each rank prefilling its rows
     of 8 prompts of 512 tokens into its part of the cache and the logits
     gathered: qwen2-1.5b at full width on {"data": 8} (a row a rank) and
     (data 4, model 2) (2 rows, 6 query heads and 1 kv head a rank) and
     mamba2-1.3b on (data 2, model 4) (4 rows, 16 of 64 SSM heads) under
     ``decode``, jamba-v0.1-52b at full width under ``ep`` on (data 4,
     model 2) (2 rows and 4 of 16 experts a rank), cut to 2 layers with
     attention every second layer (a Mamba layer and an attention layer
     with the MoE layer: one period of jamba holds four MoE layers, which
     would not fit eight ranks and rank 0's reference) at a capacity that
     drops nothing (`dispatch_demand`).  In float32 at 2 layers the
     gathered logits within 1e-4 of rank 0's one-device prefill of the
     batch, relative, the lengths equal, every rank's cache part within
     1e-4 of that prefill's part (`models.model.cache_part`), and every
     rank prefilling its neighbour's rows (a planted fault) above the
     bars; in bfloat16 (qwen2 at 8 layers, mamba2 at `TRAIN_LAYERS`' 16)
     the logits within 5e-2, each rank's flash, SSD and gmm launches
     exact at its rows (`prefill_rows_expected`: the rows each kernel got
     and the instances); the uncut prefill of the same batch (every row
     on every rank) timed beside it, a measured reference; a
     `{"prefill_rows": ...}` line with each run's wall, main-path and
     uncut seconds and peak memory by rank;
 14. a JSON line per kernel (the water-fill's with its launches by
     instance and by entry point and the host breakdown; flash's, the
     SSD's and gmm's with their launches by instance and ptxas' report of
     their instances, flash's and gmm's with their launches in each of
     phases 21-24 and the new timed shapes; the water-fill's with the
     service's launches; the flash backward's, the SSD backward's and the
     grouped matmul backward's with their launches by instance and their
     training shapes), the card line, and the result line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
R = 6
CHUNK = 64                     # cohorts per drain-guard chunk
TIERS = {
    "10k": dict(jobs=10_000, C=512, W=128),
    "100k": dict(jobs=100_000, C=4_096, W=512),
    "1m": dict(jobs=1_000_000, C=16_384, W=1_024),
}
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch import roofline_adjust as ra  # noqa: E402
from repro_torch.observability.steps import SPANS  # noqa: E402

# NVIDIA H100 SXM data sheet (`roofline_adjust.H100`): HBM3 bandwidth, and
# the FP64 rate outside the tensor cores (the water-fill's divides and
# compares are vector ops); the kernels' bounds take their byte and FLOP
# counts from `roofline_adjust`'s per-call formulas, which the dry-run
# prices its kernel sites with
HBM_BYTES_PER_S = ra.H100["hbm_bytes_per_s"]
FP64_OPS_PER_S = ra.H100["fp64_flops_per_s"]
FP32_OPS_PER_S = ra.H100["fp32_flops_per_s"]
BF16_OPS_PER_S = ra.H100["bf16_flops_per_s"]        # dense tensor-core rate
KERNEL_REPS = 20
# negotiate every 20 s inside a 60 s tick and metrics grid: windows in
# which a staged cycle may wait for the next (tests/test_live_fusion.py)
FUSION_CADENCE = {"tick_s": 60.0, "negotiate_interval_s": 20.0,
                  "metrics_interval_s": 60.0}
#: jobs of the two live-fusion-cadence days (batch 8 and batch 1): 10,000
#: until phase 26 joined the smoke; the smoke's 1200 s then did not hold a
#: slower host's host-bound days (1305 s in all, the 10k pair 307 s), so
#: 5,000; 2,000 since phase 28 joined it (a slow host's smoke 1320 s, the
#: 5k pair 122 s); 2,000 still fuse (135 batches on the CPU's torch
#: backend)
FUSION_JOBS = 2_000

# the cases of tests/test_kernel_flash_attention.py: B, Sq, Skv, Hq, Hkv,
# Dh, causal, window, softcap
FLASH_CASES = [
    (2, 256, 256, 8, 4, 64, True, None, None),
    (1, 200, 200, 4, 4, 64, True, None, None),
    (2, 128, 384, 8, 2, 128, True, 64, None),
    (1, 1, 256, 8, 4, 64, True, None, None),
    (2, 64, 128, 4, 4, 32, False, None, None),
    (1, 96, 96, 6, 2, 64, True, 32, None),
    (2, 128, 128, 4, 2, 64, True, None, 30.0),
    (1, 300, 100, 4, 1, 64, True, None, None),
]
# the reference suite's tolerances, against the plain version in float32
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# edge cases of the tensor-core instance (bfloat16): B, Sq, Skv, Hq, Hkv,
# Dh, causal, window, softcap, and whether the last batch row's cache is
# empty.  Sq and Skv ending inside a tile, Sq > Skv, G = 6 (qwen2: 10
# positions and 4 idle rows a warpgroup) and G = 3, a window, a softcap,
# no causal mask, an empty batch row; the blocks of one consumer
# warpgroup (fewer than 132 blocks of two) and, for Sq = 1000, of two;
# then whisper-medium's shapes (16 heads of 64, G = 1, 1500 encoder
# frames: a tail of 92 keys in the last 128-key tile, no causal mask):
# a cross prefill of 37 tokens, the encoder's self-attention, and a
# cross prefill of 200 tokens with an empty batch row
FLASH_WGMMA_CASES = [
    (1, 300, 100, 4, 1, 64, True, None, None, False),
    (1, 77, 333, 12, 2, 128, True, None, None, False),
    (2, 130, 257, 6, 2, 64, True, 40, None, False),
    (1, 200, 200, 12, 2, 128, False, None, 20.0, False),
    (2, 100, 100, 12, 2, 128, True, None, None, True),
    (2, 1000, 1000, 12, 2, 128, True, None, None, False),
    (2, 37, 1500, 16, 16, 64, False, None, None, False),
    (1, 1500, 1500, 16, 16, 64, False, None, None, False),
    (2, 200, 1500, 16, 16, 64, False, None, None, True),
]
# the backward kernel's cases: the reference suite's eight, then G = 6 at
# Dh 128 with Sq < Skv, a shape the forward routes to the decode split (Sq
# * G <= 32), G = 6 with a window and a softcap, G = 1 at Dh 32, and G = 4
# without causal masking; the last field is the number of leading query
# rows that see no key at all (their cache slots emptied); then
# whisper-medium's cross-attention (40 queries over 1500 frames) and its
# encoder's self-attention (1500 x 1500), G = 1 at Dh 64, no causal mask
FLASH_BWD_CASES = [(*case, 0) for case in FLASH_CASES] + [
    (2, 40, 72, 12, 2, 128, True, None, None, 0),
    (1, 4, 50, 24, 4, 64, True, None, None, 0),
    (2, 100, 100, 12, 2, 64, True, 24, 20.0, 5),
    (1, 70, 70, 6, 6, 32, True, None, None, 3),
    (1, 64, 130, 16, 4, 128, False, None, None, 0),
    (2, 40, 1500, 16, 16, 64, False, None, None, 0),
    (1, 1500, 1500, 16, 16, 64, False, None, None, 0),
]
# gates on max |kernel - plain| / max |plain| of each gradient: float32
# sums in another order; bfloat16 gradients round once to 8 bits
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# gate on max |kernel - plain| of the forward's log-sum-exp (natural log,
# float32 in both dtypes: the same input values), where both are finite;
# the rows that see no key must be +inf in both: float32 sums in another
# order, exp2 of a log2-domain max on the tensor cores
LSE_TOL = 1e-4
# qwen2-1.5b's attention at its training shapes (B, S), timed
FLASH_BWD_TIMED = [(8, 512), (2, 2048)]
# whisper-medium and llava-next-mistral-7b (the enc-dec and VLM families)
WHISPER_ARCH, VLM_ARCH = "whisper-medium", "llava-next-mistral-7b"
# their attention calls: label, B, Sq, Skv, Hq, Hkv, Dh, causal, and the
# instance `flash_route` names in bfloat16.  whisper (16 heads of 64, G =
# 1, 1500 frames): the encoder's self-attention, a cross prefill at the
# longest serving prompt (224), a decode tick's cross call of the 8 slots
# against the read-only cross cache, the decoder's self-attention over the
# shortest serving prompt (48) and a tick against its cache; a prompt of
# 32 at G = 1 has Sq * G = 32, a decode-sized call.  llava (32 heads over
# 8 of 128): a prefill of the 576-patch prefix and 448 text tokens, and a
# tick against the serving cache.  The first four rows, and llava's
# prefill, are timed in bfloat16
MODAL_FLASH_CALLS = [
    ("whisper-encoder", 1, 1500, 1500, 16, 16, 64, False, "wgmma"),
    ("whisper-cross-prefill", 1, 224, 1500, 16, 16, 64, False, "wgmma"),
    ("whisper-cross-decode", 8, 1, 1500, 16, 16, 64, False, "split"),
    ("llava-prefill", 1, 1024, 1024, 32, 8, 128, True, "wgmma"),
    ("whisper-self-prefill", 1, 48, 48, 16, 16, 64, True, "wgmma"),
    ("whisper-self-decode", 8, 1, 256, 16, 16, 64, True, "split"),
    ("whisper-self-prefill-32", 1, 32, 32, 16, 16, 64, True, "split"),
    ("llava-decode", 8, 1, 1056, 32, 8, 128, True, "split"),
]
MODAL_FLASH_TIMED = ("whisper-encoder", "whisper-cross-prefill",
                     "whisper-cross-decode", "llava-prefill")
# whisper's encoder backward at its training batch (B, frames), timed in
# phase 15 beside qwen2's shapes
WHISPER_BWD_TIMED = (8, 1500)
# the serving loops: slots, requests, prompt lengths (text tokens; llava's
# 576-position prefix comes before them) and new tokens per request
MODAL_SERVE = {WHISPER_ARCH: dict(slots=8, requests=8, prompt=(48, 224),
                                  new=32),
               VLM_ARCH: dict(slots=8, requests=8, prompt=(64, 448),
                              new=32)}
# whisper's training run: all 24 + 24 layers, bfloat16, 8 x 224 text
# tokens (and 8 x 1500 frames), no checkpoints (qwen2's run checks them)
WHISPER_TRAIN = dict(steps=6, batch=8, seq=224, ckpt_every=None)
# the published configurations that no earlier phase ran, served at
# full width in this order: name, the depth of the float32 gates and the
# bfloat16 serving depth (None: every layer).  llama4-scout's period is
# four layers (a global NoPE layer after three chunked ones), so its
# gates take one period, and it serves 8 of its 48 layers: all 48 are
# 107.8e9 parameters, about 216 GB in bfloat16
CONFIGS = [("granite-8b", 2, None), ("starcoder2-7b", 2, None),
           ("qwen3-32b", 2, None), ("llama4-scout-17b-a16e", 4, 8)]
LLAMA4_ARCH = "llama4-scout-17b-a16e"
# llama4's expert products are checked and timed at a 1024-token prefill
# beside a decode tick of the 8 slots
LLAMA4_PREFILLS = (1024,)
# llama4's window binding: a prompt longer than its chunked layers'
# 8,192-key window, prefilled but for its last 16 tokens, which decode
# through the rolling cache as it wraps
WINDOW_PROMPT, WINDOW_DECODE = 9216, 16
# the group sizes of those configurations that no earlier case took, on
# the tensor cores at Dh 128 (`FLASH_WGMMA_CASES`' fields): G = 9
# (starcoder2-7b, 36 / 4: 7 positions and 1 idle row a warpgroup), G = 8
# (qwen3-32b, 64 / 8: 8 positions, none idle) and G = 5 (llama4-scout,
# 40 / 8: 12 positions and 4 idle rows); for each a prefill whose Sq
# (333) ends inside a packed tile and whose Skv ends inside a 128-key
# tile, and one with an empty batch row
FLASH_GROUP_CASES = [
    (B, Sq, Skv, Hq, Hkv, 128, True, None, None, empty)
    for Hq, Hkv in ((36, 4), (64, 8), (40, 8))
    for B, Sq, Skv, empty in ((1, 333, 333, False), (2, 200, 260, True))]
# and at each of those group sizes a decode tick of the 8 slots on the
# split (Sq * G = 9, 8 and 5 rows) against the serving cache (Hq, Hkv)
FLASH_GROUP_DECODE = [(36, 4), (64, 8), (40, 8)]
# each configuration's attention at its serving shapes (label, B, Sq,
# Skv, Hq, Hkv, Dh, causal, the bfloat16 instance), all timed in
# bfloat16 as `MODAL_FLASH_TIMED`'s: a 1024-token prefill, and a decode
# tick of the 8 slots against rows of 1056 keys (the longest prompt and
# its new tokens)
CONFIG_FLASH_CALLS = [
    (f"{name}-{kind}", B, Sq, Skv, Hq, Hkv, 128, True, want)
    for name, Hq, Hkv in (("granite-8b", 32, 8), ("starcoder2-7b", 36, 4),
                          ("qwen3-32b", 64, 8), (LLAMA4_ARCH, 40, 8))
    for kind, B, Sq, Skv, want in (("prefill", 1, 1024, 1024, "wgmma"),
                                   ("decode", 8, 1, 1056, "split"))]
ARCH = "qwen2-1.5b"
# the serving run: slots, cache capacity, requests, prompt lengths, and
# new tokens per request
SERVE = dict(slots=8, max_seq=2048, requests=16, prompt=(64, 1024), new=32)
# full-width model gates, on max |logits difference| / max |logits|:
# float32 kernel vs plain attention differ only in the order of the
# attention sums; prefill+decode vs forward also in cuBLAS's GEMM shapes;
# bfloat16 rounds each layer's output to 8 bits, so a 1-ulp difference in
# an attention output can move later layers by an ulp each
GATE_F32 = 1e-4
GATE_BF16 = 5e-2

# the cases of tests/test_kernel_ssd.py: B, S, H, P, G, N, chunk, init
SSD_CASES = [
    (2, 512, 4, 64, 1, 128, 256, False),
    (1, 300, 8, 32, 2, 64, 128, True),
    (2, 64, 2, 64, 1, 32, 256, False),    # S < chunk
    (1, 128, 4, 16, 4, 16, 32, True),     # many groups
]
# the reference suite's tolerances (atol and rtol), against the plain
# version and the sequential oracle
SSD_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
SSD_ARCH = "mamba2-1.3b"
# mamba2-1.3b's scan at the serving prefill: B, H, P, G, N, chunk, and
# the prompt lengths (777 leaves a ragged last chunk)
SSD_SERVING = dict(B=1, H=64, P=64, G=1, N=128, chunk=256,
                   S=(512, 1024, 777))
SSD_TIMED = (512, 1024)
# jamba-v0.1-52b's scan at its serving prefill (d_inner 8192: 128 heads of
# 64, d_state 64), timed at SSD_TIMED lengths beside mamba2's
SSD_JAMBA = dict(B=1, H=128, P=64, G=1, N=64, chunk=256)
# edge cases of the tensor-core instance (bfloat16): B, S, H, P, G, N,
# chunk, init, and whether x, B and C are views of one fused projection.
# One step; under one 64-row tile; one chunk past one tile (65 = 64 + 1
# with chunk 64: a one-row second chunk); a ragged last chunk of 9 rows
# (777); one chunk of 200 (a ragged fourth tile); several chunks with B =
# 2; 4 and 2 heads a group; N and P 64 and 128; with and without an
# initial state
SSD_TC_CASES = [
    (1, 1, 4, 64, 1, 64, 256, False, False),
    (2, 63, 8, 128, 2, 128, 256, True, True),
    (1, 65, 8, 64, 2, 128, 64, True, False),
    (1, 777, 8, 128, 4, 64, 256, False, True),
    (1, 200, 2, 128, 1, 128, 256, True, False),
    (2, 300, 4, 64, 1, 64, 128, True, True),
]
# the backward's case beyond SSD_CASES and SSD_TC_CASES: a final-state
# gradient, with an initial state, on a ragged tail (300 = 2 x 128 + 44)
# and G = 2 (B, S, H, P, G, N, chunk, init)
SSD_BWD_DFINAL = (2, 300, 4, 64, 2, 64, 128, True)
# the tensor-core backward's own edges (bfloat16; a final-state gradient
# where the case has an initial state; B, S, H, P, G, N, chunk, init): G =
# 2 with two splits a group (32 heads a group in splits of 16, the scores
# read by group); a second chunk whose last key tile holds 2 rows (450 =
# 256 + 3 x 64 + 2); S under one tile; P 64 with N 64 and 128; three heads
# a split (a pair, then one head with the second warpgroup idle); P 128
# (one head a stage) over three chunks of 64, 64 and 2
SSD_BWD_TC_CASES = [
    (1, 256, 64, 64, 2, 128, 256, False),
    (2, 450, 8, 64, 1, 64, 256, True),
    (2, 40, 4, 64, 1, 128, 256, True),
    (1, 300, 6, 64, 2, 64, 128, True),
    (1, 130, 4, 128, 1, 64, 64, True),
]

# the cases of tests/test_kernel_moe_gmm.py: E, K, N, BT, group sizes (BT
# aligned), tail padding rows
GMM_CASES = [
    (4, 256, 512, 128, [256, 128, 0, 384], 256),
    (2, 64, 64, 128, [128, 128], 0),
    (8, 128, 256, 128, [0, 0, 1024, 0, 0, 0, 0, 0], 128),
    (3, 100, 96, 64, [64, 192, 64], 64),
]
# ragged groups the kernel takes and the Pallas kernel does not: unaligned
# sizes, empty groups, a tail (E, K, N, sizes, tail)
GMM_RAGGED = [(4, 32, 48, [7, 0, 13, 21], 5),
              (5, 136, 200, [0, 65, 1, 0, 9], 31)]
# cases for the tensor-core instance's edges (E, K, N, sizes, tail): one
# group holding every row while the mean group is small (a tail too); a
# group shorter than a row tile between two long ones, N not a multiple of
# the 128-column tile (its last tile's second 64-column box wholly past
# N); a K that ends inside a 64-deep stage and an N inside a box
GMM_TC_CASES = [(16, 128, 256, [0] * 7 + [300] + [0] * 8, 20),
                (3, 256, 136, [130, 17, 200], 0),
                (4, 200, 328, [64, 0, 1, 127], 9)]
# the reference suite's tolerances (atol and rtol), against the plain version
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
MOE_ARCH = "jamba-v0.1-52b"
# the prefill lengths at which jamba's expert products are checked and
# timed (the serving prompts' range), beside a decode tick of the 8 slots
MOE_PREFILLS = (1024, 512)
# jamba's depths here: one period (8 layers) in float32 for the kernel vs
# plain gates, two periods (16 layers) in bfloat16 for serving: the
# published 32 layers are ~103 GB in bfloat16, more than the card holds
MOE_F32_LAYERS, MOE_SERVE_LAYERS = 8, 16


def build_problem(MatchProblem, jobs: int, C: int, W: int, seed: int = 0):
    """The matchmaking benchmark's paper-regime problem: heterogeneous
    1-4 cpu / 0-1 gpu requests, cohort-compressed backlog, a pool that
    drains mid-cycle."""
    rng = np.random.default_rng(seed)
    requests = np.zeros((C, R))
    requests[:, 0] = rng.integers(1, 5, size=C)           # cpus
    requests[:, 1] = rng.integers(0, 2, size=C)           # gpus
    requests[:, 2] = rng.integers(1, 9, size=C)           # memory GB
    demand = np.full(C, jobs // C, dtype=np.int64)
    demand[: jobs % C] += 1
    free = np.zeros((W, R))
    free[:, 0] = rng.integers(8, 65, size=W)
    free[:, 1] = rng.integers(0, 9, size=W)
    free[:, 2] = rng.integers(32, 257, size=W)
    compat = rng.random((C, W)) < 0.9
    return MatchProblem(
        keys=[(0, c) for c in range(C)], requests=requests,
        demand=demand, order=rng.permutation(C).astype(np.int64),
        free=free, capacity=free.copy(),
        compat=np.asarray(compat, dtype=bool))


def fractional_problem(MatchProblem, C: int, W: int, seed: int):
    """Fractional cpu and memory requests (7.6/0.4-style ratios), sparse
    compat, a random processing order."""
    rng = np.random.default_rng(seed)
    requests = np.zeros((C, R))
    requests[:, 0] = rng.integers(1, 5, size=C) + rng.choice(
        [0.0, 0.25, 0.5], size=C)
    requests[:, 1] = rng.integers(0, 3, size=C)
    requests[:, 2] = rng.integers(0, 9, size=C) * 0.4
    free = np.zeros((W, R))
    free[:, 0] = rng.integers(1, 17, size=W)
    free[:, 1] = rng.integers(0, 9, size=W)
    free[:, 2] = rng.integers(0, 65, size=W) * 0.4
    return MatchProblem(
        keys=[(0, c) for c in range(C)], requests=requests,
        demand=rng.integers(1, 60, size=C).astype(np.int64),
        order=rng.permutation(C).astype(np.int64), free=free,
        capacity=free.copy(), compat=rng.random((C, W)) < 0.8)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (after one warm
    run), each bracketed by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, reps: int = KERNEL_REPS) -> float:
    """Device time of one call of ``fn`` by CUDA events, without the
    host's cost: ``reps`` calls are queued behind a GPU sleep long enough
    for the host to enqueue them all, so the events bracket only the
    device's work (the gaps between launches included).  ``fn`` must not
    synchronise.  No profiler session: once the water-fill phase's
    tier-1m case has run, the profiler reads no device events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view))


def kernel_bound(C: int, W: int, args, takes, ran):
    """Least time the card could take for this call's work, counting only
    what this run's data needs: the real W x R free values in and out,
    demand for the real cohorts of the chunks that ran, the request row
    and u8 compat row of those among them that could take anything
    (d = min(demand, left) > 0: cohorts masked out, padding and cohorts
    after the budget ran out take nothing), and out the i32 takes rows
    of the real cohorts of the chunks that ran (what the solve `match()`
    launches writes), the C i32 totals and the ran flags.  Padding and
    the host-derived safe, big, 1/safe and chunk_min arrays are left
    out.  Against that, the live cohorts' per-lane arithmetic (R
    divides, adds and multiply-subtracts, the min/floor/clip chain, one
    scan add: about 4R + 8 operations) over the vector rate.  Returns
    (bound ms, what bounds it, bytes, operations, live cohorts)."""
    nch, chunk, r = args["want"].shape
    item = args["freeT"].element_size()
    rows = torch.arange(nch * chunk, device=takes.device)
    real_ran = ran[:, None].expand(nch, chunk).reshape(-1) & (rows < C)
    taken = takes.reshape(nch * chunk, -1).sum(1, dtype=torch.float64)
    left_before = args["left"] - (taken.cumsum(0) - taken)
    live = real_ran & (args["demand"].reshape(-1) > 0) & (left_before > 0)
    n_real, n_live = int(real_ran.sum().item()), int(live.sum().item())
    nbytes = (2 * W * r * item                       # free in + out
              + n_real * item                        # demand
              + n_live * (r * item + W)              # want, u8 compat
              + n_real * W * 4 + C * 4 + nch)        # takes, totals, ran
    ops = n_live * W * (4 * r + 8)
    bound_ms, bound_by = bytes_ops_bound(nbytes, ops, item)
    return bound_ms, bound_by, nbytes, ops, n_live


def guard_problem(MatchProblem):
    """One cohort asking 1 cpu and no memory, one worker with 4 cpus and a
    memory a rounding below zero (what fractional claims leave behind):
    the JAX package's drain guard retires the worker and claims nothing,
    the NumPy backend claims 3 (tests/test_torch_matchmaker.py)."""
    req = np.zeros((1, R))
    req[0, 0] = 1.0
    free = np.zeros((1, R))
    free[0, 0] = 4.0
    free[0, 2] = -1.1102230246251565e-15
    return MatchProblem(
        keys=[(0, 0)], requests=req, demand=np.array([3], dtype=np.int64),
        order=np.array([0], dtype=np.int64), free=free, capacity=free.copy(),
        compat=np.ones((1, 1), dtype=bool))


def bytes_ops_bound(nbytes: int, nops: int, item: int):
    """(bound ms, what bounds it) for this many bytes moved and vector
    operations done in the element type of size ``item``."""
    rate = FP64_OPS_PER_S if item == 8 else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / rate
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def fused_bound(C: int, W: int, item: int, *, frees: int, demands: int,
                live_rows: int, live_steps: int, outputs: int):
    """The least time for a cycles or candidates launch, counted as
    `kernel_bound` counts one cycle: the real W x R free values of each
    of ``frees`` matrices read (the start, and each cycle's returned
    capacity where it adds any, or each candidate's), ``demands`` real
    C-long demand vectors (the start and each cycle's arrivals, or each
    candidate's), the request row and u8 compat row of the
    ``live_rows`` cohorts that were live in some cycle or candidate, and
    ``outputs`` bytes written; padding and the host-derived safe, big and
    1/safe arrays are left out.  Against that, ``live_steps`` cohort
    steps (summed over cycles or candidates) at 4R + 8 operations a real
    worker lane.  Returns (bound ms, what bounds it)."""
    nbytes = (frees * W * R * item + demands * C * item
              + live_rows * (R * item + W) + outputs)
    return bytes_ops_bound(nbytes, live_steps * W * (4 * R + 8), item)


def check_case(label, p, mm, ref_mm, ops, waterfill_reference, *,
               budget=None, active=None, plain_reps=1):
    """Each instance the call can take against the plain version on the
    card (takes exact, free bitwise), then the matchmaker's plan against
    the NumPy backend's; times (CUDA events around each call, and device
    time by `queued_ms`) the routed solve, the launch `match()` makes,
    PR 11's "rounds" instance (its device time includes its memset and,
    in this wrapper, the small kernels that give its outputs the staged
    instance's layout), the staged instance dividing every lane and the
    divide probe, the plain version and match(); returns the row."""
    args, _order = mm.kernel_inputs(p, budget=budget, active=active)
    nch, chunk, r = args["want"].shape
    Wp = args["crow"].shape[2]
    dt, dev = args["freeT"].dtype, args["freeT"].device
    route = ops.route(args["freeT"], args["want"], args["safe"],
                      args["big"], args["crow"], args["inv"])

    def plain():
        return waterfill_reference(
            args["freeT"].T, args["want"].reshape(nch * chunk, r),
            args["demand"].reshape(nch * chunk),
            args["crow"].reshape(nch * chunk, Wp), budget=args["left"])

    def instance(name, fit=ops.FIT):
        return lambda: ops._waterfill_instance(name, **args, fit=fit)

    def solve():
        return ops.waterfill_solve(**args)

    takes_p, free_p = plain()
    runs = [("rounds", ops.FIT)]
    if route == "staged":
        runs = [("staged", ops.FIT), ("staged", "divide")] + runs
    for name, fit in runs:
        out = instance(name, fit)()
        takes_k, free_k = ops.dense_takes(out)[0], out.free[0]
        torch.cuda.synchronize()
        if not torch.equal(takes_k.reshape(nch * chunk, Wp), takes_p):
            bad = (takes_k.reshape(nch * chunk, Wp) != takes_p).sum().item()
            raise AssertionError(f"{label}: {name}/{fit} takes differ from "
                                 f"the plain version in {bad} cells")
        if not bitwise_equal(free_k, free_p.T):
            raise AssertionError(f"{label}: {name}/{fit} free_after is not "
                                 f"bitwise equal to the plain version's")
    takes_k, free_k, ran = ops.waterfill(**args)
    max_abs_err = float((free_k - free_p.T).abs().max().item())

    kw = {"budget": budget, "active": active}
    plan, plan_np = mm.match(p, **kw), ref_mm.match(p, **kw)
    if not np.array_equal(plan.takes, plan_np.takes):
        raise AssertionError(f"{label}: matchmaker takes differ from the "
                             f"numpy backend's")
    if not np.allclose(plan.free_after, plan_np.free_after, rtol=0,
                       atol=1e-7):
        raise AssertionError(f"{label}: matchmaker free_after differs from "
                             f"the numpy backend's beyond 1e-7")

    row = {"case": label, "C": p.n_cohorts, "W": p.n_workers, "nch": nch,
           "Wp": Wp, "dtype": mm.dtype, "route": route,
           "ran_chunks": int(ran.sum().item()), "claimed": plan.claimed}
    row["ms"] = cuda_ms(solve, KERNEL_REPS)
    row["device_ms"] = queued_ms(solve)
    row["rounds_ms"] = cuda_ms(instance("rounds"), KERNEL_REPS)
    row["rounds_device_ms"] = queued_ms(instance("rounds"))
    if route == "staged":
        row["divide_ms"] = cuda_ms(instance("staged", "divide"), KERNEL_REPS)
        row["divide_device_ms"] = queued_ms(instance("staged", "divide"))
        row["probe_device_ms"] = queued_ms(lambda: ops.divide_probe(**args))
        row["divide_share"] = (1 - row["probe_device_ms"]
                               / max(row["divide_device_ms"], 1e-9))
    row["plain_ms"] = cuda_ms(plain, plain_reps)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        mm.match(p, **kw)
        walls.append(time.perf_counter() - t0)
    row["match_wall_ms"] = 1e3 * statistics.median(walls)
    bound_ms, bound_by, nbytes, nops, n_live = kernel_bound(
        p.n_cohorts, p.n_workers, args, takes_k, ran)
    # the floor of the serial chain: the cohort step's scan-and-barrier
    # skeleton alone, one step per live cohort (and, for rounds, per lane
    # round), at the instance's block size
    if route == "staged":
        threads, steps = ops.staged_plan(dt, Wp).threads, n_live
    else:
        threads = min(Wp, 1024)
        steps = n_live * -(-Wp // threads)
    row.update(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=nops,
               steps=steps, threads=threads, max_abs_err=max_abs_err)
    row["step_floor_ms"] = cuda_ms(
        lambda: ops.step_floor(steps, threads, dt, dev), KERNEL_REPS)
    row["empty_launch_ms"] = cuda_ms(
        lambda: ops.step_floor(0, threads, dt, dev), KERNEL_REPS)
    print(json.dumps(row), flush=True)
    return row


def fused_deltas(rng, p, K):
    """K staged deltas: arrivals on every cohort, capacity returned on odd
    cycles, a claim budget on every third."""
    from repro_torch.core.matchmaker.base import CycleDelta
    C, W = p.compat.shape
    deltas = []
    for k in range(K):
        free_add = None
        if k % 2:
            free_add = np.zeros((W, R))
            free_add[:, 0] = rng.integers(0, 5, W)
            free_add[:, 2] = rng.integers(0, 9, W)
        deltas.append(CycleDelta(
            arrivals=rng.integers(0, 30, C).astype(np.int64),
            free_add=free_add,
            budget=None if k % 3 else int(rng.integers(50, 400))))
    return deltas


def plans_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x.takes, y.takes)
        and np.array_equal(x.free_after.view(np.int64),
                           y.free_after.view(np.int64))
        for x, y in zip(a, b))


def cycles_bound(p, a, out):
    """`fused_bound` of a `waterfill_cycles` launch: per cycle, the live
    cohorts are the real ones of the chunks that ran whose live demand
    and the claim budget left before them were positive (the live demand
    replayed from the arrivals and the launch's totals)."""
    C, W = p.compat.shape
    K, nch = out.ran.shape
    item = a["freeT"].element_size()
    rows = torch.arange(nch * CHUNK, device=out.totals.device)
    dem = a["demand"].reshape(-1).clone()
    live_any = torch.zeros_like(rows, dtype=torch.bool)
    steps = ran_rows = 0
    for k in range(K):
        dem += a["arrivals"][k].reshape(-1)
        real = out.ran[k][:, None].expand(nch, CHUNK).reshape(-1) & (rows < C)
        taken = out.totals[k].reshape(-1).to(dem.dtype)
        left = a["budgets"][k] - (taken.cumsum(0) - taken)
        live = real & (dem > 0) & (left > 0)
        steps += int(live.sum())
        ran_rows += int(real.sum())
        live_any |= live
        dem -= taken
    outputs = (K * W * R * item                  # free after each cycle
               + K * C * 4 + K * nch             # totals, ran
               + ran_rows * W * 4)               # the ran chunks' takes
    return fused_bound(C, W, item, frees=1 + int(a["add_free"].sum()),
                       demands=1 + K, live_rows=int(live_any.sum()),
                       live_steps=steps, outputs=outputs)


def preview_bound(p, a, ops):
    """`fused_bound` of a `waterfill_preview` launch: each candidate's
    live cohorts are the real ones with positive demand in the chunks its
    drain guard runs, read from a one-cycle solve of that candidate (the
    same guard on the same free and demand, no budget)."""
    C, W = p.compat.shape
    N = a["frees"].shape[0]
    nch = a["want"].shape[0]
    item = a["frees"].element_size()
    rows = torch.arange(nch * CHUNK, device=a["frees"].device)
    live_any = torch.zeros_like(rows, dtype=torch.bool)
    steps = 0
    for i in range(N):
        d = a["demands"][i]
        cmin = torch.where((d > 0)[..., None], a["want"],
                           math.inf).amin(dim=1)
        ran = ops.waterfill_solve(
            a["frees"][i], math.inf, a["want"], a["safe"], a["big"], d,
            a["crow"], cmin, a["inv"]).ran[0]
        live = (ran[:, None].expand(nch, CHUNK).reshape(-1) & (rows < C)
                & (d.reshape(-1) > 0))
        steps += int(live.sum())
        live_any |= live
    return fused_bound(C, W, item, frees=N, demands=N,
                       live_rows=int(live_any.sum()), live_steps=steps,
                       outputs=N * C * 4)


def check_cycles(label, p, K, seed, mm, ref_mm, ops, refs):
    """`waterfill_cycles` (one launch) against its plain loop on the card
    (takes, each cycle's free bitwise, totals), `match_cycles` against
    `sequential_match_cycles` on the NumPy backend (bitwise); K = 8 timed
    against 8 `match` calls."""
    waterfill_cycles_reference, sequential_match_cycles = refs
    p = dataclasses.replace(p, demand=np.zeros_like(p.demand))
    deltas = fused_deltas(np.random.default_rng(seed), p, K)
    a, _order = mm.cycles_inputs(p, deltas)
    nch, chunk, r = a["want"].shape
    Wp = a["crow"].shape[2]
    out = ops.waterfill_cycles(**a)
    takes_p, free_p, tot_p = waterfill_cycles_reference(
        a["freeT"].T, a["want"].reshape(-1, r), a["demand"].reshape(-1),
        a["arrivals"].reshape(K, -1), a["free_add"].transpose(1, 2),
        a["add_free"], a["budgets"], a["crow"].reshape(-1, Wp))
    torch.cuda.synchronize()
    if not (torch.equal(ops.dense_takes(out).reshape(K, -1, Wp), takes_p)
            and bitwise_equal(out.free, free_p.transpose(1, 2))
            and torch.equal(out.totals.reshape(K, -1), tot_p)):
        raise AssertionError(f"cycles {label} K={K}: the kernel differs "
                             f"from the plain loop")
    fused = mm.match_cycles(p, deltas)
    if not plans_equal(fused, sequential_match_cycles(ref_mm, p, deltas)):
        raise AssertionError(f"cycles {label} K={K}: match_cycles differs "
                             f"from sequential_match_cycles on numpy")
    row = {"cycles_case": label, "K": K, "Wp": Wp, "nch": nch,
           "claimed": [x.claimed for x in fused],
           "ran_chunks": int(out.ran.sum().item())}
    if K == 8:
        row["device_ms"] = queued_ms(lambda: ops.waterfill_cycles(**a))
        row["bound_ms"], row["bound_by"] = cycles_bound(p, a, out)
        row["plain_ms"] = cuda_ms(lambda: waterfill_cycles_reference(
            a["freeT"].T, a["want"].reshape(-1, r), a["demand"].reshape(-1),
            a["arrivals"].reshape(K, -1), a["free_add"].transpose(1, 2),
            a["add_free"], a["budgets"], a["crow"].reshape(-1, Wp)), 1)
        fused_w, seq_w = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            mm.match_cycles(p, deltas)
            t1 = time.perf_counter()
            sequential_match_cycles(mm, p, deltas)
            t2 = time.perf_counter()
            fused_w.append(t1 - t0)
            seq_w.append(t2 - t1)
        row["match_cycles_wall_ms"] = 1e3 * statistics.median(fused_w)
        row["eight_match_wall_ms"] = 1e3 * statistics.median(seq_w)
    print(json.dumps(row), flush=True)
    return row


def check_preview(label, p, N, with_demands, seed, mm, ref_mm, ops, refs):
    """`waterfill_preview` (one launch, a block a candidate) against its
    plain loop on the card, `preview_many` against
    `sequential_preview_many` on the NumPy backend; a session hit timed
    against a miss."""
    waterfill_preview_reference, sequential_preview_many = refs
    rng = np.random.default_rng(seed)
    frees = [p.free * s for s in rng.choice([0.0, 0.5, 1.0, 2.0], size=N)]
    demands = None
    if with_demands:
        demands = [rng.integers(0, 40, p.n_cohorts).astype(np.int64)
                   for _ in range(N)]
    a, _order = mm.preview_inputs(p, frees, demands)
    nch, chunk, r = a["want"].shape
    Wp = a["crow"].shape[2]
    out = ops.waterfill_preview(**a)
    want = waterfill_preview_reference(
        a["frees"].transpose(1, 2), a["demands"].reshape(N, -1),
        a["want"].reshape(-1, r), a["crow"].reshape(-1, Wp))
    torch.cuda.synchronize()
    if not torch.equal(out.totals.reshape(N, -1), want):
        raise AssertionError(f"preview {label} N={N}: the kernel differs "
                             f"from the plain loop")
    got = mm.preview_many(p, frees, demands, session=("smoke", label))
    ref = sequential_preview_many(ref_mm, p, frees, demands)
    if not all(np.array_equal(g, w) for g, w in zip(got, ref)):
        raise AssertionError(f"preview {label} N={N}: preview_many differs "
                             f"from sequential_preview_many on numpy")
    hit, miss = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        mm.preview_many(p, frees, demands, session=("smoke", label))
        t1 = time.perf_counter()
        mm.preview_many(p, frees, demands)
        t2 = time.perf_counter()
        hit.append(t1 - t0)
        miss.append(t2 - t1)
    bound_ms, bound_by = preview_bound(p, a, ops)
    row = {"preview_case": label, "N": N, "demands": with_demands,
           "Wp": Wp, "nch": nch,
           "device_ms": queued_ms(lambda: ops.waterfill_preview(**a)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "plain_ms": cuda_ms(lambda: waterfill_preview_reference(
               a["frees"].transpose(1, 2), a["demands"].reshape(N, -1),
               a["want"].reshape(-1, r), a["crow"].reshape(-1, Wp)), 1),
           "hit_wall_ms": 1e3 * statistics.median(hit),
           "miss_wall_ms": 1e3 * statistics.median(miss)}
    print(json.dumps(row), flush=True)
    return row


def per_array_feed(arrays, device) -> dict:
    """The feed `TorchMatchmaker` had before its one pinned buffer: one
    pageable host-to-device copy per array.  A measurement aid for
    `match_breakdown`; the port never calls it."""
    return {name: torch.as_tensor(a, dtype=dt).to(device)
            for name, a, dt in arrays}


def match_breakdown(mm, ops, p, kw, reps=20):
    """Host-clock breakdown of `match()`, phase by phase as it runs them:
    prep (padding, order, minima, reciprocals), copy in (synchronised
    here to be timed), kernel and wait (the launch and the copy of free,
    totals and ran, which waits for it), copy out and scatter (the ran
    chunks' takes rows and the plan), and the same call's wall
    unsynchronised.  For the matchmaker's feed (``one_copy``: one pinned
    buffer, one copy) and for one pageable copy per array
    (``per_array``), in turns; medians of ``reps``."""
    C, W = p.compat.shape
    budget = kw.get("budget")
    feeds = {"one_copy": mm._feed.ship,
             "per_array": lambda arrays: per_array_feed(arrays, mm.device)}
    names = ("prep", "copy_in", "kernel_and_wait", "copy_out_and_scatter")

    def match(feed, sync: bool) -> list:
        t = [time.perf_counter()]
        arrays, order = mm._match_arrays(p, kw.get("active"))
        t.append(time.perf_counter())
        args = feed(arrays)
        if sync:
            torch.cuda.synchronize()
        t.append(time.perf_counter())
        args["left"] = math.inf if budget is None else float(budget)
        out = ops.waterfill_solve(**args).to_host()
        t.append(time.perf_counter())
        mm._plans(out, order, C, W)
        t.append(time.perf_counter())
        return [1e3 * (b - a) for a, b in zip(t, t[1:])]

    phases = {f: {k: [] for k in names + ("match_wall",)} for f in feeds}
    for _ in range(reps):
        for f, feed in feeds.items():
            for key, ms in zip(names, match(feed, True)):
                phases[f][key].append(ms)
            phases[f]["match_wall"].append(sum(match(feed, False)))
    row = {"match_breakdown_ms": {
        f: {k: statistics.median(v) for k, v in ph.items()}
        for f, ph in phases.items()}}
    print(json.dumps(row), flush=True)
    return row["match_breakdown_ms"]


class Recorder:
    """Wraps a built Simulation: keeps it (its collector's counters are
    read after the run) and a copy of the largest problem its matchmaker
    was asked to solve (the timing phase solves it again)."""

    def __init__(self):
        self.largest: tuple | None = None
        self.sim = None

    def wrap(self, sim):
        self.sim = sim
        mm = sim.collector.matchmaker
        inner = mm.match

        def match(p, **kw):
            if (self.largest is None
                    or p.compat.size > self.largest[0].compat.size):
                self.largest = (copy.deepcopy(p), copy.deepcopy(kw))
            return inner(p, **kw)

        mm.match = match
        return sim


def policy(PolicySpec, standard_policy, matchmaker: str, recorder=None, *,
           batch: int = 1, cadence: dict | None = None):
    base = standard_policy("fill-first")
    extra = f"matchmaker={matchmaker}\n"
    if batch > 1:
        extra += f"negotiation_batch={batch}\n"
    ini = base.ini.replace("[provision]\n", "[provision]\n" + extra, 1)
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(PolicySpec)}
    fields["ini"] = ini
    fields.update(cadence or {})

    class Spec(PolicySpec):
        def build(self, **kw):
            sim = super().build(**kw)
            return recorder.wrap(sim) if recorder is not None else sim

    return Spec(**fields)


def comparable(block: dict) -> dict:
    """A run_policy block without its host wall-clock fields."""
    return {k: v for k, v in block.items() if k not in ("wall_s", "phases")}


def run_e2e(label, trace, mods, *, batch=1, cadence=None, **kw):
    """The port's run_policy on the card vs on the NumPy backend; returns
    the row (walls, the water-fill's launches in all, by entry point and
    by instance, the fused batches and fallbacks), the torch run's block
    and the largest problem it solved."""
    PolicySpec, standard_policy, run_policy, ops = mods
    rec = Recorder()
    ops.launch_counts["waterfill"] = 0
    for counts in (ops.kind_counts, ops.route_counts):
        for key in counts:
            counts[key] = 0
    t0 = time.perf_counter()
    out_t = run_policy(trace, policy(PolicySpec, standard_policy, "torch",
                                     rec, batch=batch, cadence=cadence), **kw)
    wall_t = time.perf_counter() - t0
    launches = ops.launch_counts["waterfill"]
    kinds, routes = dict(ops.kind_counts), dict(ops.route_counts)
    t0 = time.perf_counter()
    out_n = run_policy(trace, policy(PolicySpec, standard_policy, "numpy",
                                     batch=batch, cadence=cadence), **kw)
    wall_n = time.perf_counter() - t0
    for key in ("jobs", "pods_submitted", "cost_total", "series"):
        if out_t[key] != out_n[key]:
            raise AssertionError(f"{label}: {key} differs between the torch "
                                 f"and numpy runs")
    if comparable(out_t) != comparable(out_n):
        raise AssertionError(f"{label}: run_policy blocks differ")
    if out_t["jobs"]["n"] != len(trace):
        raise AssertionError(f"{label}: {out_t['jobs']['n']} of "
                             f"{len(trace)} jobs completed")
    if launches == 0:
        raise AssertionError(f"{label}: the water-fill kernel never ran")
    col = rec.sim.collector
    row = {"e2e": label, "jobs": len(trace), "negotiation_batch": batch,
           "cadence": cadence, "pods_submitted": out_t["pods_submitted"],
           "cost_total": out_t["cost_total"], "torch_wall_s": wall_t,
           "numpy_wall_s": wall_n, "waterfill_launches": launches,
           "launches_by_kind": kinds, "launches_by_instance": routes,
           "fused_batches": col.fused_batches,
           "fused_cycles": col.fused_cycles,
           "fallbacks": {k[0]: int(c.value) for k, c in
                         col._c_fallbacks.children.items()}}
    print(json.dumps(row), flush=True)
    return row, out_t, rec.largest


def waterfill_phase(mods, MatchProblem, TorchMatchmaker, NumpyMatchmaker,
                    refs, after=None):
    """Phases 3 and 4: the water-fill's cases on both instances, its K
    cycles and N candidates, the four days, then the largest problem of
    the 10k day timed and broken down.  ``after(row)`` runs after each
    piece (`repro_torch.kernels.waterfill.study` probes the profiler
    there).  Returns the kernels-line row."""
    PolicySpec, standard_policy, run_policy, ops, diurnal_day = mods
    (waterfill_reference, waterfill_cycles_reference,
     waterfill_preview_reference, sequential_match_cycles,
     sequential_preview_many) = refs
    mm, ref_mm = TorchMatchmaker(), NumpyMatchmaker()
    check = dict(mm=mm, ref_mm=ref_mm, ops=ops,
                 waterfill_reference=waterfill_reference)
    rows = []

    def add(row):
        rows.append(row)
        if after is not None:
            after(row)
        return row

    for tier, spec in TIERS.items():
        add(check_case(f"tier-{tier}", build_problem(MatchProblem, **spec),
                       **check))
    frac = fractional_problem(MatchProblem, 300, 200, 5)
    add(check_case("fractional", frac, **check))
    p = build_problem(MatchProblem, jobs=10_000, C=512, W=128, seed=3)
    active = np.random.default_rng(3).random(512) < 0.6
    add(check_case("budget+active", p, budget=3_000, active=active,
                   **check))
    drain = fractional_problem(MatchProblem, 600, 4, 17)
    drain.requests[300:, 0] = 0.0           # zero-cpu cohorts, late chunks
    add(check_case("drained-pool", drain, **check))
    add(check_case("guard-negative-free", guard_problem(MatchProblem),
                   **check))
    for W in (129, 1000, 1500, 6000, 8000):
        add(check_case(f"W={W}", build_problem(
            MatchProblem, jobs=20_000, C=512, W=W, seed=W), **check))
    add(check_case(
        "float32-10k", build_problem(MatchProblem, **TIERS["10k"]),
        mm=TorchMatchmaker(dtype="float32"), ref_mm=ref_mm, ops=ops,
        waterfill_reference=waterfill_reference))

    # K cycles and N candidates, each one launch
    cyc_refs = (waterfill_cycles_reference, sequential_match_cycles)
    pre_refs = (waterfill_preview_reference, sequential_preview_many)
    tier10k = build_problem(MatchProblem, **TIERS["10k"])
    for label, prob in (("tier-10k", tier10k), ("fractional", frac)):
        for K in (1, 2, 8):
            add(check_cycles(label, prob, K, 40 + K, mm, ref_mm, ops,
                             cyc_refs))
        for N in (1, 8):
            for with_demands in (False, True):
                add(check_preview(label, prob, N, with_demands, 50 + N,
                                  mm, ref_mm, ops, pre_refs))

    # phase 4: end to end through run_policy, the main path first: every
    # count is 0 just before it and read just after
    e2e = (PolicySpec, standard_policy, run_policy, ops)
    day, _block, largest = run_e2e("diurnal-10k",
                                     diurnal_day(10_000, seed=7), e2e)
    add(day)
    add(run_e2e("diurnal-2k-3schedd-fairshare", diurnal_day(2_000, seed=11),
                e2e, schedds=3, fairshare=True)[0])
    # the live-fusion cadence: the standard 30/60/300 s grid leaves no
    # window in which a staged cycle may wait, so batch=8 fuses nothing
    # there; at 20 s inside a 60 s grid it does
    fused_label = f"diurnal-{FUSION_JOBS // 1000}k-batch8"
    fused_row, fused_block, _ = run_e2e(
        fused_label, diurnal_day(FUSION_JOBS, seed=7), e2e, batch=8,
        cadence=FUSION_CADENCE)
    add(fused_row)
    if fused_row["fused_batches"] == 0:
        raise AssertionError(f"{fused_label}: no batch was fused")
    if fused_row["launches_by_kind"]["cycles"] != fused_row["fused_batches"]:
        raise AssertionError(f"{fused_label}: "
                             f"{fused_row['launches_by_kind']['cycles']} "
                             f"cycles launches for "
                             f"{fused_row['fused_batches']} fused batches")
    one_row, one_block, _ = run_e2e(
        f"diurnal-{FUSION_JOBS // 1000}k-batch1-fusion-cadence",
        diurnal_day(FUSION_JOBS, seed=7), e2e, cadence=FUSION_CADENCE)
    add(one_row)
    fused_row["equals_batch1"] = comparable(fused_block) == comparable(
        one_block)
    fused_row["launches_saved"] = (one_row["waterfill_launches"]
                                   - fused_row["waterfill_launches"])
    print(json.dumps({"e2e_fusion": fused_row["e2e"],
                      "equals_batch1": fused_row["equals_batch1"],
                      "launches_saved": fused_row["launches_saved"],
                      "fused_cycles_less_batches":
                          fused_row["fused_cycles"]
                          - fused_row["fused_batches"]}), flush=True)

    # the water-fill's line: timed at the largest problem the 10k day
    # solved, and match() broken down there
    p, kw = largest
    main = check_case("main-path-largest", p, budget=kw.get("budget"),
                      active=kw.get("active"), plain_reps=3, **check)
    add(main)
    breakdown = add(match_breakdown(mm, ops, p, kw))
    return {
        "name": "waterfill", "route": "cuda",
        "source": "src/repro_torch/kernels/waterfill/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill/kernel.py:120",
        "launches": day["waterfill_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if "max_abs_err" in r),
        "ms": main["ms"], "device_ms": main.get("device_ms"),
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "step_floor_ms": main["step_floor_ms"],
        "rounds_ms": main["rounds_ms"],
        "rounds_device_ms": main["rounds_device_ms"],
        "divide_share": main.get("divide_share"),
        "instances": {
            "staged": "R = 6, up to 8,192 lanes: tiles staged ahead by "
                      "bulk copies, the carry "
                      "in registers, fits by a checked multiply, one "
                      "launch for one cycle, K cycles or N candidates",
            "rounds": "PR 11's kernel, for the rest"},
        "routes": day["launches_by_instance"],
        "launches_by_kind": {r["e2e"]: r["launches_by_kind"]
                             for r in rows if "e2e" in r},
        "match_breakdown_ms": breakdown}


def run_waterfill_phase(after=None):
    """`waterfill_phase` with the port's modules (``src`` on the path)."""
    from repro_torch.core.matchmaker import (
        MatchProblem, NumpyMatchmaker, TorchMatchmaker,
    )
    from repro_torch.core.matchmaker.base import (
        sequential_match_cycles, sequential_preview_many,
    )
    from repro_torch.kernels.waterfill import ops
    from repro_torch.kernels.waterfill.ref import (
        waterfill_cycles_reference, waterfill_preview_reference,
        waterfill_reference,
    )
    from repro_torch.workload import (
        PolicySpec, diurnal_day, run_policy, standard_policy,
    )
    return waterfill_phase(
        (PolicySpec, standard_policy, run_policy, ops, diurnal_day),
        MatchProblem, TorchMatchmaker, NumpyMatchmaker,
        (waterfill_reference, waterfill_cycles_reference,
         waterfill_preview_reference, sequential_match_cycles,
         sequential_preview_many), after)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def attention_inputs(seed, B, Sq, Skv, Hq, Hkv, Dh, dtype, device, *,
                     lengths=None, dense=False):
    """The reference suite's inputs (normal q/k/v, queries at the last Sq
    positions, every 7th cache slot empty; with ``dense`` none empty, as
    in a prompt's prefill), or, with ``lengths``, a serving cache: row b
    holds positions 0..lengths[b]-1 and is empty (-1) after them, and its
    query sits at position lengths[b]."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=dtype,
                            device=device)
               for shape in ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh),
                             (B, Skv, Hkv, Dh)))
    kp = torch.arange(Skv, dtype=torch.int32,
                      device=device).expand(B, Skv).clone()
    if lengths is None:
        qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                          device=device).expand(B, Sq).contiguous()
        if not dense:
            kp[:, ::7] = -1
    else:
        ln = torch.tensor(lengths, dtype=torch.int32, device=device)
        kp[kp >= ln[:, None]] = -1
        qp = ln[:, None].contiguous()
    return q, k, v, qp, kp


def flash_bound(q, k, v, q_pos, kv_pos, mask):
    """Least time for this call, counting what this data needs
    (`roofline_adjust.flash_cost`): q, both position arrays and the
    output once, and the K and V rows of the cache slots that some query
    attends (an empty or never-attended slot need not be read), at the
    HBM rate; against the QK^T and PV FLOPs of the unmasked (query, key)
    pairs (4 * Dh per pair and query head) at the tensor-core bf16 rate
    (float32 at the vector rate).  Returns (ms, bound by, bytes, FLOPs)."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    attended = int(mask.any(dim=1).sum().item())          # (b, slot) pairs
    nbytes, flops = ra.flash_cost(B, Sq, Skv, Hq, Hkv, Dh, q.element_size(),
                                  int(mask.sum().item()), attended)
    return (*ra.bound_ms(nbytes, flops, q.dtype), nbytes, flops)


def flash_route(dtype, Sq, Hq, Hkv, Dh) -> str:
    """The flash instance a call must take: the decode split for at most
    32 query rows per kv head (Sq * G), the tensor cores for bfloat16 with
    Dh 64 or 128 (the tensors here are fresh, so 16-byte aligned, and
    short of the 262,144-key limit), the SIMT instance for the rest
    (float32 prefill: no TF32; Dh 32)."""
    if Sq * (Hq // Hkv) <= 32:
        return "split"
    if dtype == torch.bfloat16 and Dh in (64, 128):
        return "wgmma"
    return "simt"


profiler_sessions = 0          # torch.profiler sessions this process opened
SESSION_TRIES = 3              # sessions a device_ms reading may take


def profiled(activities):
    """A `torch.profiler.profile` session, counted in
    `profiler_sessions` (printed before the kernels line: the session at
    which a process stops reading device events is studied by
    `repro_torch.kernels.waterfill.study`)."""
    global profiler_sessions
    from torch.profiler import profile
    profiler_sessions += 1
    return profile(activities=activities)


def device_ms(fn, reps: int, match: str | None = None) -> float:
    """Device time of one call of ``fn``: the kernels' own time summed by
    `torch.profiler` over ``reps`` calls (after one warm call), without
    the host's launch cost that a CUDA-event bracket of a small call
    measures; ``match`` keeps only kernels whose name holds it."""
    return sum(e.self_device_time_total
               for e in device_kernels(fn, reps, match)) / reps / 1e3


def device_ms_by(fn, reps: int, match: str, names) -> dict:
    """`device_ms` of ``fn`` in total (``"all"``) and by kernel (each of
    ``names``: the kernels whose name holds ``match + name``), read from
    one profiler session."""
    kernels = device_kernels(fn, reps, match)
    ms = {"all": sum(e.self_device_time_total for e in kernels) / reps / 1e3}
    for name in names:
        ms[name] = sum(e.self_device_time_total for e in kernels
                       if match + name in e.key) / reps / 1e3
    return ms


def device_ms_per_launch(fn, reps: int, names) -> tuple[dict, dict]:
    """Device time of one call of ``fn``, every kernel of which runs once
    a call: each kernel's time over the launches the profiler read of it
    (a session late in a long process can miss some: run 23d's summed
    over 20 calls read about 13 calls' worth), in total (``"all"``) and
    for the kernels whose name holds each of ``names``; and the launches
    read of each of ``names`` in ``reps`` calls."""
    kernels = device_kernels(fn, reps)
    per = {e.key: e.self_device_time_total / e.count / 1e3 for e in kernels}
    ms = {"all": sum(per.values())}
    ms.update({name: sum(v for k, v in per.items() if name in k)
               for name in names})
    read = {name: sum(e.count for e in kernels if name in e.key)
            for name in names}
    return ms, read


def device_kernels(fn, reps: int, match: str | None = None) -> list:
    """The profiler's kernels (`key_averages` entries) of ``reps`` calls
    of ``fn``, after one warm call; ``match`` keeps only kernels whose
    name holds it.  A session that read no kernel lost its events (a
    probe in `repro_torch.kernels.waterfill.study` read none once after
    25k launches): it is measured again, at most SESSION_TRIES times,
    then raises."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(SESSION_TRIES):
        with profiled([ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key not in SPANS
                   and (match is None or match in e.key)]
        n = sum(e.count for e in kernels)
        if n > 0:
            return kernels
        counts.append(n)
    raise AssertionError(f"profiler sessions up to {profiler_sessions} read "
                         f"{counts} kernels (match={match!r}) for {reps} "
                         f"calls")


def check_flash(label, fa, q, k, v, qp, kp, *, timed=False,
                causal_library=False, **kw):
    """Kernel vs plain version (float32) on the card, at the reference
    suite's tolerance, through the instance `flash_route` names; with
    ``timed``, CUDA-event medians of the kernel, the plain version and
    SDPA (a yardstick only; with ``causal_library`` its own mask -- the
    causal one, or none for a call without a causal mask -- in place of
    the positions' boolean mask, the same function where no slot is empty
    and, for a causal call, q_pos = kv_pos = 0..S-1) beside the bound,
    the kernel's and SDPA's device time from the profiler, and two calls
    bitwise equal."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask, attention_reference,
    )
    want = flash_route(q.dtype, q.shape[1], q.shape[2], k.shape[2],
                       q.shape[3])
    before = dict(fa.route_counts)
    out = fa.flash_attention(q, k, v, qp, kp, **kw)
    routed = {n: fa.route_counts[n] - before[n] for n in before}

    def plain():
        return attention_reference(q.float(), k.float(), v.float(), qp, kp,
                                   **kw)

    ref = plain()
    torch.cuda.synchronize()
    if routed != {n: int(n == want) for n in routed}:
        raise AssertionError(f"{label}: routed {routed}, expected {want}")
    tol = FLASH_TOL[q.dtype]
    if out.dtype != q.dtype or out.shape != q.shape:
        raise AssertionError(f"{label}: output {out.dtype} {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: kernel output is not finite")
    err = (out.float() - ref).abs()
    if bool((err > tol + tol * ref.abs()).any()):
        raise AssertionError(f"{label}: kernel differs from the plain "
                             f"version by {float(err.max()):.3g} > {tol}")
    row = {"flash_case": label, "instance": want,
           "dtype": str(q.dtype).split(".")[1],
           "shape": [*q.shape, k.shape[1], k.shape[2]],
           "max_abs_err": float(err.max()), "tol": tol}
    if timed:
        check_flash_deterministic(label, fa, q, k, v, qp, kp, **kw)
        mask = attention_mask(qp, kp, causal=kw.get("causal", True),
                              window=kw.get("window")).expand(
            q.shape[0], q.shape[1], k.shape[1])
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_mask = mask[:, None].contiguous()

        def library():
            if causal_library:
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=kw.get("causal", True),
                    enable_gqa=True)
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True)

        def kernel():
            return fa.flash_attention(q, k, v, qp, kp, **kw)

        bound_ms, bound_by, nbytes, flops = flash_bound(q, k, v, qp, kp, mask)
        row.update(
            ms=cuda_ms(kernel, KERNEL_REPS),
            plain_ms=cuda_ms(plain, KERNEL_REPS),
            library_ms=cuda_ms(library, KERNEL_REPS),
            device_ms=device_ms(kernel, KERNEL_REPS,
                                match="flash_attention_kernel"),
            library_device_ms=device_ms(library, KERNEL_REPS),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    print(json.dumps(row), flush=True)
    return row


def check_flash_deterministic(label, fa, q, k, v, qp, kp, **kw):
    """Two calls on the same inputs give the same bits (the split's parts
    merge in a fixed order; no atomics)."""
    a = fa.flash_attention(q, k, v, qp, kp, **kw)
    b = fa.flash_attention(q, k, v, qp, kp, **kw)
    if not bitwise_equal(a.float(), b.float()):
        raise AssertionError(f"{label}: two calls differ")


def check_fully_masked_rows(flash_attention, device):
    """Rows with no visible key give 0, not NaN."""
    q, k, v, qp, kp = attention_inputs(2, 1, 8, 16, 2, 2, 32, torch.float32,
                                       device)
    out = flash_attention(q, k, v, qp, torch.full_like(kp, -1), causal=True)
    if bool(out.isnan().any()) or float(out.abs().max()) != 0.0:
        raise AssertionError("fully masked rows: output is not all zero")


def check_rolling_window(flash_attention, device):
    """A windowed decode over a rolling cache does not depend on the order
    of the cache's slots."""
    C, W = 64, 32
    q, k, v, _, _ = attention_inputs(3, 1, 1, C, 4, 2, 32, torch.float32,
                                     device)
    qp = torch.tensor([[100 + C]], dtype=torch.int32, device=device)
    kp = torch.arange(100, 100 + C, dtype=torch.int32, device=device)[None]
    perm = torch.as_tensor(np.random.default_rng(3).permutation(C),
                           device=device)
    out1 = flash_attention(q, k, v, qp, kp, causal=True, window=W)
    out2 = flash_attention(q, k[:, perm].contiguous(),
                           v[:, perm].contiguous(), qp,
                           kp[:, perm].contiguous(), causal=True, window=W)
    if float((out1 - out2).abs().max()) > 1e-5:
        raise AssertionError("rolling window: slot order changed the output")


def serving_shapes():
    """qwen2-1.5b's attention at the serving run's shapes (12 query heads
    over 2 kv heads, d_head 128): label, seed, B, Sq, Skv and the cache
    rows' lengths (None: the reference suite's positions)."""
    lengths = np.random.default_rng(5).integers(
        SERVE["prompt"][0], SERVE["prompt"][1] + SERVE["new"], SERVE["slots"])
    return [(f"prefill-{Sq}", 4, 1, Sq, Sq, None) for Sq in (512, 2048)] + [
        (f"decode-{SERVE['slots']}x{SERVE['max_seq']}", 6, SERVE["slots"], 1,
         SERVE["max_seq"], lengths.tolist())]


def modal_flash_inputs(call, dtype, device):
    """A `MODAL_FLASH_CALLS` call's inputs: a prompt or an encoder's
    frames (no empty slot), or a decode tick against a cache whose rows
    are full; returns (label, inputs, options, the bfloat16 instance)."""
    label, B, Sq, Skv, Hq, Hkv, Dh, causal, want = call
    lengths = [Skv] * B if Sq == 1 else None
    inputs = attention_inputs(13, B, Sq, Skv, Hq, Hkv, Dh, dtype, device,
                              lengths=lengths, dense=True)
    return label, inputs, dict(causal=causal), want


def modal_flash_phase(fa, device, calls=MODAL_FLASH_CALLS,
                      timed_labels=MODAL_FLASH_TIMED):
    """whisper's and llava's attention calls (or ``calls``) against the
    plain version in float32 and bfloat16, each through the instance
    `flash_route` names (checked against the call's own); the
    ``timed_labels`` ones timed in bfloat16 beside their bound and SDPA
    with its own mask.  Returns the timed rows."""
    rows = []
    for call in calls:
        for dtype in (torch.float32, torch.bfloat16):
            label, inputs, kw, want = modal_flash_inputs(call, dtype, device)
            _, _, Sq, Skv, Hq, Hkv, Dh, _, _ = call
            got = flash_route(dtype, Sq, Hq, Hkv, Dh)
            if dtype == torch.bfloat16 and got != want:
                raise AssertionError(f"{label}: flash_route names {got}, "
                                     f"the call's own is {want}")
            timed = dtype == torch.bfloat16 and label in timed_labels
            # SDPA's causal mask is aligned top-left: for a tick (Sq 1 <
            # Skv) it is not the cache's, so SDPA takes the positions' mask
            row = check_flash(label, fa, *inputs, timed=timed,
                              causal_library=Sq == Skv or not kw["causal"],
                              **kw)
            if timed:
                rows.append(row)
    return rows


def flash_wgmma_inputs(case, device):
    """The inputs of a `FLASH_WGMMA_CASES` case in bfloat16; ``empty_row``
    empties one batch row's cache."""
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, softcap, empty_row = case
    q, k, v, qp, kp = attention_inputs(7, B, Sq, Skv, Hq, Hkv, Dh,
                                       torch.bfloat16, device)
    if empty_row:
        kp[-1] = -1
    return (q, k, v, qp, kp), dict(causal=causal, window=window,
                                   softcap=softcap)


def flash_group_phase(fa, device):
    """The group sizes G = 9, 8 and 5: `FLASH_GROUP_CASES` on the tensor
    cores and `FLASH_GROUP_DECODE`'s ticks on the split in both dtypes,
    each against the plain version and twice, bitwise equal."""
    for case in FLASH_GROUP_CASES:
        inputs, kw = flash_wgmma_inputs(case, device)
        check_flash(f"group{case}", fa, *inputs, **kw)
        check_flash_deterministic(f"group{case}", fa, *inputs, **kw)
    for Hq, Hkv in FLASH_GROUP_DECODE:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = flash_group_decode_inputs(Hq, Hkv, dtype, device)
            label = f"group-decode-G{Hq // Hkv}"
            check_flash(label, fa, *inputs)
            check_flash_deterministic(label, fa, *inputs)


def flash_group_decode_inputs(Hq, Hkv, dtype, device):
    """A `FLASH_GROUP_DECODE` tick: the serving run's 8 slots against its
    2048-slot cache, rows filled to qwen2's decode shape's lengths."""
    label, seed, B, Sq, Skv, lengths = serving_shapes()[-1]
    return attention_inputs(seed, B, Sq, Skv, Hq, Hkv, 128, dtype, device,
                            lengths=lengths)


def flash_bwd_inputs(case, dtype, device, seed=11, dense=False):
    """A `FLASH_BWD_CASES` case: the reference suite's inputs (every 7th
    slot empty, none with ``dense``: a training batch) with the slots up
    to the first ``masked`` query rows' positions emptied, so that those
    rows see no key, and an output gradient drawn from the same seed;
    returns ((q, k, v, q_pos, kv_pos), the options, dout)."""
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, softcap, masked = case
    q, k, v, qp, kp = attention_inputs(seed, B, Sq, Skv, Hq, Hkv, Dh, dtype,
                                       device, dense=dense)
    if masked:
        kp[kp <= qp[:, masked - 1:masked]] = -1
    dout = torch.tensor(np.random.default_rng(seed + 1).standard_normal(
        q.shape), dtype=dtype, device=device)
    return (q, k, v, qp, kp), dict(causal=causal, window=window,
                                   softcap=softcap), dout


def flash_bwd_route(dtype, Dh) -> str:
    """The backward instance a call must take: the tensor cores for
    bfloat16 with Dh 64 or 128 (the tensors here are fresh, so 16-byte
    aligned, and far short of the tile limits), the SIMT instance for
    the rest (float32: no TF32; Dh 32)."""
    return "wgmma" if dtype == torch.bfloat16 and Dh in (64, 128) else "simt"


def check_lse(label, q, k, v, qp, kp, lse, kw):
    """The forward kernel's log-sum-exp against the plain version's on
    the same inputs (float32): +inf on the same rows (those that see no
    key), within `LSE_TOL` elsewhere.  Returns the largest difference."""
    from repro_torch.kernels.flash_attention.ref import attention_reference
    _, want = attention_reference(q.float(), k.float(), v.float(), qp, kp,
                                  return_lse=True, **kw)
    if lse.dtype != torch.float32 or lse.shape != want.shape:
        raise AssertionError(f"{label}: lse is {lse.dtype} "
                             f"{tuple(lse.shape)}")
    inf = torch.isinf(want)
    if not bool(torch.equal(torch.isinf(lse), inf)) or bool(
            (lse[inf] < 0).any()):
        raise AssertionError(f"{label}: lse is +inf on other rows than the "
                             f"plain version's")
    err = float((lse[~inf] - want[~inf]).abs().max()) if bool(
        (~inf).any()) else 0.0
    if not err <= LSE_TOL:
        raise AssertionError(f"{label}: lse differs from the plain "
                             f"version's by {err:.3g} > {LSE_TOL}")
    return err


def check_flash_bwd(label, fa, inputs, kw, dout, *, masked=0,
                    instance=None):
    """The routed forward's output and log-sum-exp (the lse against the
    plain one, `check_lse`), then the backward kernel against the plain
    backward (float32 math on the same inputs, the kernel forward's
    output and lse) on the card: each gradient within `FLASH_BWD_TOL` x
    its max, finite, in its input's dtype; rows that see no key get dq =
    0 exactly; one launch counted, on the instance `flash_bwd_route`
    names (or on ``instance``, forced through `ops._backward_instance`).
    Returns (the kernel's gradients, the worst error relative to each
    gradient's max, the largest absolute error, the lse's error)."""
    from repro_torch.kernels.build import launch_counts
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference,
    )
    q, k, v, qp, kp = inputs
    out, lse = fa.flash_attention_forward(q, k, v, qp, kp, **kw)
    lse_err = check_lse(label, q, k, v, qp, kp, lse, kw)
    want_route = instance or flash_bwd_route(q.dtype, q.shape[3])
    before = launch_counts["flash_attention_bwd"]
    routed = dict(fa.bwd_route_counts)
    if instance is None:
        got = fa.flash_attention_backward(q, k, v, out, dout, lse, qp, kp,
                                          **kw)
    else:
        got = fa._backward_instance(instance, q, k, v, out, dout, lse, qp,
                                    kp, **kw)
    if launch_counts["flash_attention_bwd"] != before + 1:
        raise AssertionError(f"{label}: the backward did not count one "
                             f"launch")
    moved = {n: fa.bwd_route_counts[n] - routed[n] for n in routed}
    if moved != {n: int(n == want_route) for n in moved}:
        raise AssertionError(f"{label}: the backward took {moved}, "
                             f"expected {want_route}")
    want = attention_backward_reference(q.float(), k.float(), v.float(),
                                        out.float(), dout.float(), lse, qp,
                                        kp, **kw)
    torch.cuda.synchronize()
    worst = max_abs = 0.0
    for name, a, b, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        if a.dtype != like.dtype or a.shape != like.shape:
            raise AssertionError(f"{label}: {name} is {a.dtype} "
                                 f"{tuple(a.shape)}")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: {name} is not finite")
        err = (a.float() - b).abs().max()
        rel = float(err / b.abs().max().clamp(min=1e-30))
        if rel > FLASH_BWD_TOL[q.dtype]:
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 f"backward by {rel:.3g} of its max > "
                                 f"{FLASH_BWD_TOL[q.dtype]}")
        worst, max_abs = max(worst, rel), max(max_abs, float(err))
    if masked and bool(got[0][:, :masked].any()):
        raise AssertionError(f"{label}: rows that see no key have dq != 0")
    return got, worst, max_abs, lse_err


def flash_phase(fa, device):
    """Every case of the reference suite in both dtypes, the two special
    cases, the tensor-core instance's edge cases (each also twice, bitwise
    equal), then the serving shapes in float32 and in bfloat16 (timed).
    Each call's instance is checked."""
    for case in FLASH_CASES:
        B, Sq, Skv, Hq, Hkv, Dh, causal, window, softcap = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, qp, kp = attention_inputs(0, B, Sq, Skv, Hq, Hkv, Dh,
                                               dtype, device)
            check_flash(f"case{case}", fa, q, k, v, qp, kp, causal=causal,
                        window=window, softcap=softcap)
    check_fully_masked_rows(fa.flash_attention, device)
    check_rolling_window(fa.flash_attention, device)
    print(json.dumps({"flash_case": "fully-masked-rows+rolling-window",
                      "ok": True}), flush=True)
    for case in FLASH_WGMMA_CASES:
        inputs, kw = flash_wgmma_inputs(case, device)
        check_flash(f"wgmma{case}", fa, *inputs, **kw)
        check_flash_deterministic(f"wgmma{case}", fa, *inputs, **kw)
    flash_group_phase(fa, device)
    # the decode split at G = 1 (one live row of the block's 32) against a
    # 1500-slot cross cache, no causal mask: every slot in some split
    for dtype in (torch.float32, torch.bfloat16):
        inputs = attention_inputs(9, 8, 1, 1500, 16, 16, 64, dtype, device,
                                  lengths=[1500] * 8)
        check_flash("split-cross-8x1500", fa, *inputs, causal=False)
        check_flash_deterministic("split-cross-8x1500", fa, *inputs,
                                  causal=False)

    rows = []
    for label, seed, B, Sq, Skv, lengths in serving_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, qp, kp = attention_inputs(seed, B, Sq, Skv, 12, 2, 128,
                                               dtype, device, lengths=lengths)
            row = check_flash(label, fa, q, k, v, qp, kp,
                              timed=dtype == torch.bfloat16)
        rows.append(row)
    # a prompt's prefill has no empty slot: the tiles below the diagonal
    # need no mask, and SDPA's own causal mask computes the same function
    for label, seed, B, Sq, Skv, _ in serving_shapes()[:2]:
        q, k, v, qp, kp = attention_inputs(seed, B, Sq, Skv, 12, 2, 128,
                                           torch.bfloat16, device, dense=True)
        rows.insert(-1, check_flash(f"{label}-dense", fa, q, k, v, qp, kp,
                                    timed=True, causal_library=True))
    return rows


# ---------------------------------------------------------------------------
# SSD (the Mamba2 scan)
# ---------------------------------------------------------------------------

def ssd_arrays(seed, B, S, H, P, G, N, init):
    """The reference suite's `_mk` inputs as float32 numpy arrays: normal
    x, dt = |normal| * 0.3 + 0.01, A = -(|normal| + 0.1), B and C normal
    * 0.3, D normal, and with ``init`` an initial state |normal| * 0.1."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f32)
    dt = (np.abs(rng.standard_normal((B, S, H))) * 0.3 + 0.01).astype(f32)
    A = (-(np.abs(rng.standard_normal(H)) + 0.1)).astype(f32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f32)
    D = rng.standard_normal(H).astype(f32)
    st = (np.abs(rng.standard_normal((B, H, P, N))) * 0.1).astype(f32) \
        if init else None
    return x, dt, A, Bm, Cm, D, st


def ssd_inputs(seed, B, S, H, P, G, N, init, dtype, device):
    """`ssd_arrays` as tensors on ``device``: x, B and C in ``dtype``, the
    rest float32."""
    x, dt, A, Bm, Cm, D, st = ssd_arrays(seed, B, S, H, P, G, N, init)

    def t(a, to=torch.float32):
        return None if a is None else torch.tensor(a, device=device).to(to)

    return (t(x, dtype), t(dt), t(A), t(Bm, dtype), t(Cm, dtype), t(D),
            t(st))


def ssd_bwd_arrays(seed, B, S, H, P, G, N, init, dfinal):
    """`ssd_arrays`, then the backward's cotangents drawn after them: dy
    normal (B, S, H, P) and, with ``dfinal``, a final-state gradient
    normal (B, H, P, N), float32 numpy arrays.  Returns (the arrays, dy,
    dfinal or None)."""
    arrays = ssd_arrays(seed, B, S, H, P, G, N, init)
    rng = np.random.default_rng(seed + 1000)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    df = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if dfinal else None)
    return arrays, dy, df


def ssd_route(dtype, P, N, chunk) -> str:
    """The SSD instance a call must take (`ops.route` for fresh or
    fused-projection tensors, which are 16-byte aligned with strides a
    multiple of 8 elements): the tensor cores for bfloat16 with P and N 64
    or 128 and a chunk that is a multiple of 64, the SIMT instance for the
    rest (float32: no TF32 or bf16 operands; the small shapes)."""
    if (dtype == torch.bfloat16 and P in (64, 128) and N in (64, 128)
            and chunk % 64 == 0):
        return "mma"
    return "simt"


def ssd_tc_inputs(case, device):
    """The inputs of an `SSD_TC_CASES` case in bfloat16; with ``strided``
    x, B and C are views of one fused projection, as the model makes
    them."""
    B, S, H, P, G, N, chunk, init, strided = case
    x, dt, A, Bm, Cm, D, st = ssd_inputs(6, B, S, H, P, G, N, init,
                                         torch.bfloat16, device)
    if strided:
        fused = torch.cat([x.flatten(2), Bm.flatten(2), Cm.flatten(2)],
                          dim=-1)
        xv, bv, cv = torch.split(fused, [H * P, G * N, G * N], dim=-1)
        x, Bm, Cm = (xv.unflatten(-1, (H, P)), bv.unflatten(-1, (G, N)),
                     cv.unflatten(-1, (G, N)))
    return x, dt, A, Bm, Cm, D, st


def ssd_serving_cases():
    """mamba2-1.3b's scan at the serving prefill's shapes: label, seed and
    the case tuple, with and without an initial state."""
    c = SSD_SERVING
    return [(f"serving-S{S}{'-init' if init else ''}", 40 + S + init,
             (c["B"], S, c["H"], c["P"], c["G"], c["N"], c["chunk"], init))
            for S in c["S"] for init in (False, True)]


#: the causal work of a chunked scan (see `roofline_adjust.ssd_flops`)
ssd_flops = ra.ssd_flops


def ssd_bound(x, dt, Bm, Cm, init, chunk):
    """Least time for one call (`roofline_adjust.ssd_cost`): x, dt, A, D,
    B and C per group, and the initial state once in, y and the final
    state once out, at the HBM rate; against the causal FLOPs
    (`ssd_flops`) at the tensor-core bf16 rate (float32 at the vector
    rate).  Returns (ms, bound by, bytes, FLOPs)."""
    Bsz, S, H, P = x.shape
    nbytes, flops = ra.ssd_cost(Bsz, S, H, P, Bm.shape[2], Bm.shape[3],
                                chunk, x.element_size(), init is not None)
    return (*ra.bound_ms(nbytes, flops, x.dtype), nbytes, flops)


def check_ssd(label, so, case, seed, dtype, device, *, timed=False,
              inputs=None):
    """Kernel vs the plain version and vs the sequential oracle on the
    card, y and the final state at the reference suite's tolerance,
    through the instance `ssd_route` names; with ``timed``, two calls
    bitwise equal, CUDA-event medians of the kernel, of the SIMT instance
    on the same call and of the plain version, the kernels' device time
    from the profiler (summed over the passes), beside the bound."""
    from repro_torch.kernels.ssd.ref import ssd_reference
    B, S, H, P, G, N, chunk, init = case[:8]
    x, dt, A, Bm, Cm, D, st = inputs or ssd_inputs(seed, B, S, H, P, G, N,
                                                   init, dtype, device)
    instance = ssd_route(dtype, P, N, chunk)
    before = dict(so.route_counts)
    y, fin = so.ssd(x, dt, A, Bm, Cm, D, chunk=chunk, initial_state=st)
    routed = {n: so.route_counts[n] - before[n] for n in before}

    def plain():
        return so.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                              initial_state=st)

    refs = {"plain": plain(),
            "oracle": ssd_reference(x, dt, A, Bm, Cm, D, initial_state=st)}
    torch.cuda.synchronize()
    if routed != {n: int(n == instance) for n in routed}:
        raise AssertionError(f"{label}: routed {routed}, expected "
                             f"{instance}")
    tol = SSD_TOL[dtype]
    if y.dtype != dtype or y.shape != x.shape or fin.shape != (B, H, P, N):
        raise AssertionError(f"{label}: output {y.dtype} {tuple(y.shape)}, "
                             f"state {tuple(fin.shape)}")
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())):
        raise AssertionError(f"{label}: kernel output is not finite")
    errs = {}
    for name, (yr, fr) in refs.items():
        for what, got, want in (("y", y, yr), ("state", fin, fr)):
            err = (got.float() - want.float()).abs()
            if bool((err > tol + tol * want.float().abs()).any()):
                raise AssertionError(
                    f"{label}: kernel {what} differs from the {name} version "
                    f"by {float(err.max()):.3g} > {tol}")
            errs[f"{what}_vs_{name}"] = float(err.max())
    row = {"ssd_case": label, "instance": instance,
           "dtype": str(dtype).split(".")[1], "shape": list(case),
           "max_abs_err": errs["y_vs_plain"], "errs": errs, "tol": tol}
    if timed:
        check_ssd_deterministic(label, so, x, dt, A, Bm, Cm, D, chunk, st)
        bound_ms, bound_by, nbytes, flops = ssd_bound(x, dt, Bm, Cm, st,
                                                      chunk)

        def kernel():
            return so.ssd(x, dt, A, Bm, Cm, D, chunk=chunk,
                          initial_state=st)

        def simt():
            return so._ssd_instance("simt", x, dt, A, Bm, Cm, D,
                                    chunk=chunk, initial_state=st)

        row.update(
            ms=cuda_ms(kernel, KERNEL_REPS),
            device_ms=device_ms(kernel, KERNEL_REPS, match="ssd_"),
            simt_ms=cuda_ms(simt, KERNEL_REPS),
            simt_device_ms=device_ms(simt, KERNEL_REPS, match="ssd_"),
            plain_ms=cuda_ms(plain, KERNEL_REPS), library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    print(json.dumps(row), flush=True)
    return row


def check_ssd_deterministic(label, so, x, dt, A, Bm, Cm, D, chunk, st):
    """Two calls on the same inputs give the same bits (no atomics; the
    passes' sums run in a fixed order)."""
    a = so.ssd(x, dt, A, Bm, Cm, D, chunk=chunk, initial_state=st)
    b = so.ssd(x, dt, A, Bm, Cm, D, chunk=chunk, initial_state=st)
    if not all(bitwise_equal(u.float(), v.float()) for u, v in zip(a, b)):
        raise AssertionError(f"{label}: two calls differ")


def ssd_timed_cases():
    """The bfloat16 calls timed: mamba2's and jamba's serving prefill at
    SSD_TIMED lengths, without an initial state (label, seed, case)."""
    m, j = SSD_SERVING, SSD_JAMBA
    return [(f"{arch}-S{S}", 40 + S,
             (c["B"], S, c["H"], c["P"], c["G"], c["N"], c["chunk"], False))
            for arch, c in (("mamba2", m), ("jamba", j)) for S in SSD_TIMED]


def ssd_phase(so, device):
    """Every case of the reference suite in both dtypes, the tensor-core
    instance's edge cases (each also twice, bitwise equal), mamba2's
    serving shapes in both dtypes, then the timed bfloat16 calls (mamba2
    and jamba at SSD_TIMED lengths, each on both instances).  Each
    call's instance is checked.  Returns the timed rows, then every
    row."""
    rows = []
    for case in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_ssd(f"case{case}", so, case, 0, dtype, device))
    for case in SSD_TC_CASES:
        inputs = ssd_tc_inputs(case, device)
        rows.append(check_ssd(f"tc{case}", so, case, 6, torch.bfloat16,
                              device, inputs=inputs))
        check_ssd_deterministic(f"tc{case}", so, *inputs[:6], case[6],
                                inputs[6])
    for label, seed, case in ssd_serving_cases():
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_ssd(label, so, case, seed, dtype, device))
    timed = [check_ssd(label, so, case, seed, torch.bfloat16, device,
                       timed=True)
             for label, seed, case in ssd_timed_cases()]
    torch.cuda.empty_cache()
    return timed, rows + timed


def ssd_instances(so):
    """ptxas' report of each SSD kernel: the SIMT instance by dtype and
    head dim, the tensor-core instance's four kernels (the scores by
    d_state, the outputs by head dim and d_state, with their dynamic
    shared memory)."""
    rows = []
    for r in ptxas_report(so.build_log, "ssd_"):
        name = r.pop("kernel")
        simt = re.search(r"ssd_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
        outputs = re.search(r"ssd_mma_outputsILi(\d+)ELi(\d+)E", name)
        scores = re.search(r"ssd_mma_scoresILi(\d+)E", name)
        other = re.search(r"(ssd_mma_states|ssd_mma_pass)", name)
        if simt:
            r = {"instance": "simt", "P": int(simt[2]),
                 "dtype": "float32" if simt[1] == "f" else "bfloat16", **r}
        elif outputs:
            P, N = int(outputs[1]), int(outputs[2])
            r = {"instance": "mma", "pass": "ssd_mma_outputs", "P": P,
                 "N": N, "dynamic_smem": so.mma_smem_bytes(P, N), **r}
        elif scores:
            r = {"instance": "mma", "pass": "ssd_mma_scores",
                 "N": int(scores[1]), **r}
        elif other:
            r = {"instance": "mma", "pass": other[1], **r}
        else:
            r = {"kernel": name, **r}
        rows.append(r)
    return rows


# ---------------------------------------------------------------------------
# grouped matmul (the MoE expert products)
# ---------------------------------------------------------------------------

def gmm_arrays(seed, E, K, N, sizes, tail):
    """The reference suite's inputs as float32 numpy arrays: normal lhs
    (sum(sizes) + tail, K) and rhs (E, K, N), and the int32 group sizes."""
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((sum(sizes) + tail, K)).astype(np.float32)
    rhs = rng.standard_normal((E, K, N)).astype(np.float32)
    return lhs, rhs, np.asarray(sizes, np.int32)


def gmm_inputs(seed, E, K, N, sizes, tail, dtype, device):
    """`gmm_arrays` as tensors on ``device``, lhs and rhs in ``dtype``."""
    lhs, rhs, gs = gmm_arrays(seed, E, K, N, sizes, tail)
    return (torch.tensor(lhs, device=device).to(dtype),
            torch.tensor(rhs, device=device).to(dtype),
            torch.tensor(gs, device=device))


def moe_serving_shapes(arch=MOE_ARCH, prefills=MOE_PREFILLS):
    """jamba's (or ``arch``'s) expert products at the serving run's shapes
    (jamba: 16 experts, d_model 4096, d_ff 14336, C rows each): label,
    rows (E x C), K and N, for the gate/up product (d -> f) and the down
    product (f -> d), at the prefill lengths and at a decode tick."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    cfg = get_config(arch)
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    calls = [(f"prefill-{S}", S) for S in prefills] + [
        (f"decode-{SERVE['slots']}", SERVE["slots"])]
    return [(f"{label}-{what}", E * capacity(cfg, T), K, N)
            for label, T in calls
            for what, K, N in (("gate", d, f), ("down", f, d))]


def moe_serving_inputs(rows, K, N, dtype, device, seed=0, arch=MOE_ARCH):
    """Unit-normal activations (rows, K), jamba's (or ``arch``'s) E
    expert weights (E, K, N) drawn as the model draws them (`Init.dense`,
    fan-in K), and E equal groups."""
    from repro_torch.configs import get_config
    from repro_torch.models.param import Init
    E = get_config(arch).moe.n_experts
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rhs = Init(gen, device).dense((E, K, N), dtype, fan_in=K)
    lhs = torch.randn((rows, K), generator=gen, device=device).to(dtype)
    gs = torch.full((E,), rows // E, dtype=torch.int32, device=device)
    return lhs, rhs, gs


def gmm_bound(lhs, rhs, group_sizes, out):
    """Least time for one call, counting what this data needs
    (`roofline_adjust.gmm_cost`): lhs, the weights of the experts whose
    groups are non-empty, the group sizes and the output once, at the HBM
    rate; against 2 x K x N FLOPs per row in a group at the tensor-core
    bf16 rate (float32 at the vector rate).  Returns (ms, bound by,
    bytes, FLOPs)."""
    E, K, N = rhs.shape
    sizes = group_sizes.tolist()
    rows = min(sum(max(g, 0) for g in sizes), lhs.shape[0])
    live = sum(1 for g in sizes if g > 0)
    nbytes, flops = ra.gmm_cost(lhs.shape[0], K, N, E, rows, live,
                                lhs.element_size(), rhs.element_size(),
                                out.element_size())
    return (*ra.bound_ms(nbytes, flops, lhs.dtype), nbytes, flops)


def gmm_route(dtype, K, N) -> str:
    """The gmm instance a call must take: the tensor cores for bfloat16
    inputs whose rows TMA can stream (K and N multiples of 8; the tensors
    here are fresh, so 16-byte aligned), the SIMT instance for float32 (no
    TF32) and for the rest."""
    tc = dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
    return "wgmma" if tc else "simt"


def check_gmm(label, gm, lhs, rhs, gs, out_dtype=None, *, timed=False):
    """Kernel vs plain version on the card, at the reference suite's
    tolerance, through the instance `gmm_route` names; with ``timed``,
    CUDA-event medians of the kernel, of its stream-only probe (the ring
    without the products), of the plain version and of `torch.bmm` over
    the (E, C, K) x (E, K, N) layout (a yardstick only; equal groups)
    beside the bound, and two calls bitwise equal."""
    E, K, N = rhs.shape
    want = gmm_route(lhs.dtype, K, N)
    before = dict(gm.route_counts)
    out = gm.gmm(lhs, rhs, gs, out_dtype=out_dtype)
    routed = {k: gm.route_counts[k] - before[k] for k in before}
    ref = gm.gmm_plain(lhs, rhs, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    if routed != {k: int(k == want) for k in routed}:
        raise AssertionError(f"{label}: routed {routed}, expected {want}")
    tol = GMM_TOL[lhs.dtype]
    if out.dtype != (out_dtype or lhs.dtype) or out.shape != ref.shape:
        raise AssertionError(f"{label}: output {out.dtype} {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: kernel output is not finite")
    err = (out.float() - ref).abs()
    if bool((err > tol + tol * ref.abs()).any()):
        raise AssertionError(f"{label}: kernel differs from the plain "
                             f"version by {float(err.max()):.3g} > {tol}")
    row = {"gmm_case": label, "route": want,
           "dtype": str(lhs.dtype).split(".")[1],
           "out_dtype": str(out.dtype).split(".")[1],
           "shape": [lhs.shape[0], K, N, E], "max_abs_err": float(err.max()),
           "tol": tol}
    if timed:
        check_gmm_deterministic(label, gm, lhs, rhs, gs, out_dtype)
        C = lhs.shape[0] // E
        batched = lhs.view(E, C, K)

        def library():
            return torch.bmm(batched, rhs)

        bound_ms, bound_by, nbytes, flops = gmm_bound(lhs, rhs, gs, out)
        row.update(
            ms=cuda_ms(lambda: gm.gmm(lhs, rhs, gs, out_dtype=out_dtype),
                       KERNEL_REPS),
            stream_ms=cuda_ms(lambda: gm.stream_floor(lhs, rhs, gs),
                              KERNEL_REPS),
            plain_ms=cuda_ms(lambda: gm.gmm_plain(lhs, rhs, gs,
                                                  out_dtype=out_dtype),
                             KERNEL_REPS),
            library_ms=cuda_ms(library, KERNEL_REPS),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
        row["bound_share"] = row["bound_ms"] / row["ms"]
    print(json.dumps(row), flush=True)
    return row


def check_gmm_deterministic(label, gm, lhs, rhs, gs, out_dtype=None):
    """Two calls on the same inputs give the same bits (no atomics, a
    fixed K order)."""
    a = gm.gmm(lhs, rhs, gs, out_dtype=out_dtype)
    b = gm.gmm(lhs, rhs, gs, out_dtype=out_dtype)
    if not bitwise_equal(a.float(), b.float()):
        raise AssertionError(f"{label}: two calls differ")


def ptxas_report(log, name):
    """Registers, spill bytes and static shared memory of each kernel in
    nvcc's ``-Xptxas -v`` output whose mangled name holds ``name``."""
    rows, kernel = [], None
    for line in (log or "").splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = entry.group(1) if name in entry.group(1) else None
            if kernel:
                rows.append({"kernel": kernel})
            continue
        if kernel is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            rows[-1]["spill_bytes"] = int(spill[1]) + int(spill[2])
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1].update(registers=int(used[1]),
                            static_smem=int(smem[1]) if smem else 0)
    return rows


def wgmma_instances(gm):
    """ptxas' report of each tensor-core instance, with its rows per tile,
    ring depth, output type and dynamic shared memory."""
    rows = []
    for r in ptxas_report(gm.build_log, "gmm_kernel_wgmma"):
        args = re.search(r"gmm_kernel_wgmmaI(\w+?)Li(\d+)ELi(\d+)ELb(\d)E",
                         r["kernel"])
        if args:
            bm = int(args[2])
            r = {"rows": bm, "stages": int(args[3]),
                 "out": "float32" if args[1] == "f" else "bfloat16",
                 "products": args[4] == "1",
                 "dynamic_smem": gm.wgmma_smem_bytes(bm),
                 **{k: v for k, v in r.items() if k != "kernel"}}
        rows.append(r)
    return rows


def flash_instances(fa):
    """ptxas' report of each split, merge and tensor-core instance of the
    flash kernel, with its dtype, head dim, consumer warpgroups and
    dynamic shared memory (the tensor-core instance's registers are those
    at launch; its consumers raise theirs to 232 with setmaxnreg when
    there are two)."""
    rows = []
    for r in ptxas_report(fa.build_log, "flash_attention_kernel_"):
        name = r.pop("kernel")
        wg = re.search(r"kernel_wgmmaILi(\d+)ELi(\d)E", name)
        sm = re.search(r"kernel_(split|merge)I(f|13__nv_bfloat16)Li(\d+)E",
                       name)
        if wg:
            dh, w = int(wg[1]), int(wg[2])
            r = {"instance": "wgmma", "dtype": "bfloat16", "dh": dh,
                 "warpgroups": w, "dynamic_smem": fa.wgmma_smem_bytes(dh, w),
                 **r}
        elif sm:
            r = {"instance": sm[1], "dh": int(sm[3]),
                 "dtype": "float32" if sm[2] == "f" else "bfloat16", **r}
        else:
            r = {"kernel": name, **r}
        rows.append(r)
    return rows


def gmm_phase(gm, device):
    """Every case of the reference suite in both dtypes, the ragged cases
    (also bfloat16 in, float32 out), the tensor-core edge cases (bfloat16
    and float32 out, twice: bitwise equal), then jamba's serving products
    in float32 and in bfloat16 with float32 output (the MoE's call), the
    bfloat16 calls timed.  Each call's instance is checked.  Returns the
    timed rows."""
    for E, K, N, _bt, sizes, tail in GMM_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            check_gmm(f"case{(E, K, N, sizes, tail)}", gm,
                      *gmm_inputs(0, E, K, N, sizes, tail, dtype, device))
    for E, K, N, sizes, tail in GMM_RAGGED:
        for dtype, out_dtype in ((torch.float32, None), (torch.bfloat16, None),
                                 (torch.bfloat16, torch.float32)):
            check_gmm(f"ragged{(E, K, N, sizes, tail)}", gm,
                      *gmm_inputs(1, E, K, N, sizes, tail, dtype, device),
                      out_dtype)
    for E, K, N, sizes, tail in GMM_TC_CASES:
        inputs = gmm_inputs(2, E, K, N, sizes, tail, torch.bfloat16, device)
        for out_dtype in (None, torch.float32):
            label = f"tc{(E, K, N, sizes, tail)}"
            check_gmm(label, gm, *inputs, out_dtype)
            check_gmm_deterministic(label, gm, *inputs, out_dtype)
    return gmm_serving_phase(gm, device)


def gmm_serving_phase(gm, device, arch=MOE_ARCH, prefills=MOE_PREFILLS):
    """``arch``'s expert products at its serving shapes
    (`moe_serving_shapes`) in float32 and in bfloat16 with float32
    output (the MoE's call), the bfloat16 calls timed; labels carry the
    arch where it is not jamba's.  Returns the timed rows."""
    timed = []
    for label, rows, K, N in moe_serving_shapes(arch, prefills):
        if arch != MOE_ARCH:
            label = f"{arch}-{label}"
        for dtype in (torch.float32, torch.bfloat16):
            lhs, rhs, gs = moe_serving_inputs(rows, K, N, dtype, device,
                                              arch=arch)
            row = check_gmm(label, gm, lhs, rhs, gs, torch.float32,
                            timed=dtype == torch.bfloat16)
            del lhs, rhs
        timed.append(row)
    torch.cuda.empty_cache()
    return timed


# ---------------------------------------------------------------------------
# the model and the serving engine at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def swapped(module, name, plain):
    """Routes ``module.name`` through ``plain`` (the comparison's other
    side); the kernel is back on exit."""
    kernel = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def plain_attention():
    """The model's attention through the plain version."""
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.models import attention as attn_mod
    return swapped(attn_mod, "flash_attention", attention_reference)


def plain_ssd():
    """The model's SSD scan through the plain version."""
    from repro_torch.kernels.ssd.ops import ssd_chunked
    from repro_torch.models import ssm as ssm_mod
    return swapped(ssm_mod, "ssd", ssd_chunked)


def plain_gmm():
    """The MoE's expert products through the plain version."""
    from repro_torch.kernels.moe_gmm.ops import gmm_plain
    from repro_torch.models import moe as moe_mod
    return swapped(moe_mod, "gmm", gmm_plain)


class PlainGmmFn(torch.autograd.Function):
    """The grouped matmul's plain version with its plain backward
    (`gmm_plain`, `ref.gmm_backward_reference`), saving lhs and rhs as
    they are: autograd through `gmm_plain` would keep a float32 copy of
    every bfloat16 expert weight (11.3 GB a jamba MoE layer, 45 GB for
    one period's four), which the one-period gradient cannot hold beside
    its 26.5 GB of parameters and 26.5 GB of gradients."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, out_dtype):
        from repro_torch.kernels.moe_gmm.ops import gmm_plain
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm_plain(lhs, rhs, group_sizes, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.moe_gmm.ref import gmm_backward_reference
        grads = gmm_backward_reference(*ctx.saved_tensors, dout)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def plain_gmm_fn():
    """The MoE's expert products through `PlainGmmFn`."""
    from repro_torch.models import moe as moe_mod
    return swapped(moe_mod, "gmm",
                   lambda lhs, rhs, gs, *, out_dtype=None, host_sizes=None:
                   PlainGmmFn.apply(lhs, rhs, gs, out_dtype))


@contextlib.contextmanager
def plain_kernels(gmm=plain_gmm):
    """Every kernel of the model through its plain version (the grouped
    matmul's through ``gmm``)."""
    with plain_attention(), plain_ssd(), gmm():
        yield


class Routes:
    """Records the experts each MoE layer call routes each token to (as
    sets: the order of a token's k experts changes no rank)."""

    def __init__(self):
        self.calls: list[torch.Tensor] = []

    @contextlib.contextmanager
    def on(self):
        from repro_torch.models import moe as moe_mod
        topk = moe_mod._router_topk

        def recorded(logits, k):
            probs, gates, idx = topk(logits, k)
            self.calls.append(idx.sort(dim=-1).values)
            return probs, gates, idx

        moe_mod._router_topk = recorded
        try:
            yield self
        finally:
            moe_mod._router_topk = topk

    @contextlib.contextmanager
    def pinned(self):
        """The MoE layer calls route, call by call, to the experts
        recorded here, with their gates gathered from their own router
        probabilities (so the gates keep their gradient).  Yields a list
        that gets, per call, the number of tokens whose own top-k experts
        differ from the pinned ones."""
        from repro_torch.models import moe as moe_mod
        topk = moe_mod._router_topk
        calls, moved = iter(self.calls), []

        def pinned(logits, k):
            probs, _, own = topk(logits, k)
            idx = next(calls)
            moved.append(int((own.sort(dim=-1).values != idx).any(-1).sum()))
            gates = torch.gather(probs, -1, idx)
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
            return probs, gates, idx

        moe_mod._router_topk = pinned
        try:
            yield moved
        finally:
            moe_mod._router_topk = topk

    def dropped(self, cfg) -> int:
        """Assignments over the capacity in the recorded calls."""
        from repro_torch.models.moe import capacity
        E = cfg.moe.n_experts
        return sum(int((torch.bincount(idx.reshape(-1), minlength=E)
                        - capacity(cfg, idx.shape[0])).clamp(min=0).sum())
                   for idx in self.calls)


def no_drops(cfg):
    """cfg with a capacity that holds every assignment (C = T).  The
    capacity is per model call (T tokens), so a forward over S tokens
    and a prefill plus one-token decodes drop different tokens by design,
    in the JAX package too; comparing the two paths needs a capacity
    that drops none."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def gate(label, value, limit):
    print(json.dumps({"gate": label, "value": value, "limit": limit}),
          flush=True)
    if not value <= limit:
        raise AssertionError(f"{label}: {value:.3g} > {limit:.3g}")


def modality_inputs(cfg, batch, device, seed=0) -> dict:
    """An enc-dec model's frames or a VLM's patches for ``batch`` rows
    (`stub_modality_inputs`, float32), on ``device``; {} for the rest."""
    from repro_torch.data.pipeline import stub_modality_inputs
    return {k: torch.from_numpy(v).to(device) for k, v in
            stub_modality_inputs(cfg, batch, rng_seed=seed).items()}


def prefix_len(cfg) -> int:
    """Positions a VLM's patches take before the text (0 otherwise)."""
    return cfg.frontend.n_prefix if cfg.frontend is not None else 0


def model_phase(cfg, device, *, plain=plain_attention, what="attention",
                prompt_len=320, n_pre=256, seed=0, bf16=True):
    """Kernel vs plain version (``plain``, of the model's ``what``) in
    the whole model at cfg's widths, and prefill+decode vs forward (with
    `no_drops`' capacity for an MoE model; with the frames or patches of
    an enc-dec or VLM model, whose text follows the patches); returns the
    float32 config and parameters for the engine check, and, with
    ``bf16``, the bfloat16 parameters."""
    from repro_torch.models import model as model_lib
    toks = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt_len)), device=device)
    extra = modality_inputs(cfg, 1, device, seed)
    batch = {"tokens": toks, **extra}
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              activation_dtype="float32")
    from repro_torch.models.param import param_count
    t0 = time.perf_counter()
    params = model_lib.init_model(f32, seed=seed, device=device)
    torch.cuda.synchronize()
    print(json.dumps({"model": cfg.name, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                      "dtype": "float32", "params": param_count(params),
                      "init_s": time.perf_counter() - t0}), flush=True)
    with Routes().on() as routes:
        logits = model_lib.forward(params, f32, batch)
    with plain():
        logits_plain = model_lib.forward(params, f32, batch)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("float32 forward logits are not finite")
    if cfg.moe is not None:
        print(json.dumps({"model": cfg.name, "forward_tokens": prompt_len,
                          "moe_calls": len(routes.calls),
                          "dropped_assignments": routes.dropped(f32)}),
              flush=True)
    gate(f"{cfg.name} f32 forward: kernel vs plain {what}",
         rel_err(logits, logits_plain), GATE_F32)
    del logits_plain

    prefill_decode_gate(f32, params, batch, n_pre, logits=logits)
    del logits
    if not bf16:
        return f32, params, None

    bf = model_lib.init_model(cfg, seed=seed, device=device)
    logits = model_lib.forward(bf, cfg, batch)
    with plain():
        logits_plain = model_lib.forward(bf, cfg, batch)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("bfloat16 forward logits are not finite")
    gate(f"{cfg.name} bf16 forward: kernel vs plain {what}",
         rel_err(logits, logits_plain), GATE_BF16)
    return f32, params, bf


def prefill_decode_gate(cfg, params, batch, n_pre, *, logits=None):
    """Prefill of the first ``n_pre`` tokens of ``batch`` (and its frames
    or patches), then one-token decodes to its end, against the
    teacher-forced forward's logits at each position (``logits``: the
    forward's at cfg's capacity, computed here when None or when an MoE
    model needs `no_drops`' capacity), within `GATE_F32`."""
    from repro_torch.models import model as model_lib
    toks = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    prompt_len = toks.shape[1]
    full = no_drops(cfg)
    if logits is None or full is not cfg:
        logits = model_lib.forward(params, full, batch)
    # the positions read below, before the cache takes their memory
    logits = logits[:, n_pre - 1:].clone()
    device = toks.device
    cache = model_lib.init_cache(full, 1, prefix_len(cfg) + prompt_len + 16,
                                 device=device)
    step, cache, lengths = model_lib.prefill(
        params, full, {"tokens": toks[:, :n_pre], **extra}, cache)
    worst = rel_err(step, logits[:, 0])
    for s in range(n_pre, prompt_len):
        step, cache, lengths = model_lib.decode_step(
            params, full, toks[:, s:s + 1], cache, lengths)
        worst = max(worst, rel_err(step, logits[:, s - n_pre + 1]))
    gate(f"{cfg.name} f32 prefill({n_pre}) + decode({prompt_len - n_pre}) "
         f"vs forward", worst, GATE_F32)
    return worst


def init_logged(cfg, device, seed=0):
    """The model's parameters at cfg's depth and dtype, from a seed; prints
    their count, the memory allocated and the time taken."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import param_count
    t0 = time.perf_counter()
    params = model_lib.init_model(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    print(json.dumps({"model": cfg.name, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "dtype": cfg.param_dtype,
                      "params": param_count(params),
                      "memory_allocated_gb": torch.cuda.memory_allocated()
                      / 1e9, "init_s": time.perf_counter() - t0}),
          flush=True)
    return params


def routed_bf16_phase(cfg, device, *, prompt_len=320, seed=0):
    """The bfloat16 model (cfg's depth) with every kernel against every
    plain version, over the positions before the first one whose experts
    differ in any MoE layer: the model is causal and an expert's
    capacity rank counts only earlier tokens, so those positions saw the
    same routing on both sides.  Returns the parameters."""
    from repro_torch.models import model as model_lib
    params = init_logged(cfg, device, seed)
    batch = {"tokens": torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt_len)), device=device)}
    with Routes().on() as kernel_routes:
        logits = model_lib.forward(params, cfg, batch)
    with plain_kernels(), Routes().on() as plain_routes:
        logits_plain = model_lib.forward(params, cfg, batch)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("bfloat16 forward logits are not finite")
    differ = torch.stack([(a != b).any(dim=-1) for a, b in zip(
        kernel_routes.calls, plain_routes.calls)])      # (layers, tokens)
    moved = differ.any(dim=0).nonzero()
    first = int(moved[0]) if len(moved) else prompt_len
    print(json.dumps({"model": cfg.name, "forward_tokens": prompt_len,
                      "moe_calls": differ.shape[0],
                      "routes_differing": int(differ.sum()),
                      "first_differing_position": first,
                      "dropped_assignments": kernel_routes.dropped(cfg)}),
          flush=True)
    if first == 0:
        raise AssertionError(f"{cfg.name} bf16: the kernels route position 0 "
                             f"to other experts than the plain versions")
    gate(f"{cfg.name} bf16 forward: kernels vs plain versions, positions "
         f"0..{first - 1}", rel_err(logits[:, :first],
                                    logits_plain[:, :first]), GATE_BF16)
    return params


def moe_layer_phase(cfg, device, tokens=1024, seed=0, *, train=False):
    """One full-width MoE layer, kernel against plain, on the same input
    in float32 and in bfloat16: routing is identical by construction, so
    y is held to the model gates and the auxiliary loss must be equal.
    With ``train``, also the backward of sum(y * dy) + aux for a seeded
    float32 dy: y and the gradients of x, router, gate, up and down
    against autograd through the plain version (`plain_gmm`), each on
    max |diff| / max |plain| at `GATE_TRAIN_GRAD` (float32) and
    `GATE_TRAIN_BF16_GRAD` (bfloat16), and two backward passes of the
    kernels' graph bitwise equal, the second timed by CUDA events
    (``backward_ms``).  Returns the rows."""
    from repro_torch.kernels.build import launch_counts
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.param import Init
    limits = ((("float32", GATE_TRAIN_GRAD), ("bfloat16", GATE_TRAIN_BF16_GRAD))
              if train else (("float32", GATE_F32), ("bfloat16", GATE_BF16)))
    rows = []
    for dtype, limit in limits:
        c = dataclasses.replace(cfg, param_dtype=dtype,
                                activation_dtype=dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        p = moe_mod.init_moe(Init(gen, device), c)
        h = torch.randn((1, tokens, c.d_model), generator=gen,
                        device=device).to(p["gate"].dtype)
        dy = torch.randn((1, tokens, c.d_model), generator=gen,
                         device=device)
        names = ("x", "router", "gate", "up", "down")

        def run(p, h):
            if not train:
                with torch.no_grad():
                    return (*moe_mod.moe_forward_dense(p, c, h), None, None)
            leaves = [h.detach().requires_grad_()] + [
                p[k].detach().requires_grad_() for k in names[1:]]
            q = dict(p, **dict(zip(names[1:], leaves[1:])))
            y, aux = moe_mod.moe_forward_dense(q, c, leaves[0])
            loss = (y.float() * dy).sum() + aux
            grads = torch.autograd.grad(loss, leaves, retain_graph=True)
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            again = torch.autograd.grad(loss, leaves)
            stop.record()
            stop.synchronize()
            for name, a, b in zip(names, grads, again):
                if not bitwise_equal(a.float(), b.float()):
                    raise AssertionError(f"MoE layer {dtype}: two backward "
                                         f"passes differ in d{name}")
            return y.detach(), aux.detach(), grads, start.elapsed_time(stop)

        before = dict(launch_counts)
        y, aux, grads, backward_ms = run(p, h)
        launched = {k: launch_counts[k] - before[k] for k in before}
        with plain_gmm():
            y_plain, aux_plain, grads_plain, _ = run(p, h)
        if launched["gmm"] != 3 or launched["gmm_bwd"] != 6 * train:
            raise AssertionError(f"MoE layer {dtype}: launches {launched}")
        if not bool(torch.isfinite(y).all()) or y.dtype != h.dtype:
            raise AssertionError(f"MoE layer {dtype}: output {y.dtype}, "
                                 f"finite {bool(torch.isfinite(y).all())}")
        if not torch.equal(aux, aux_plain):
            raise AssertionError(f"MoE layer {dtype}: aux loss differs")
        what = "forward and backward" if train else "kernel vs plain"
        gate(f"{cfg.name} MoE layer {dtype}, {tokens} tokens: {what}, y",
             rel_err(y, y_plain), limit)
        row = {"moe_layer": dtype, "tokens": tokens, "train": train,
               "y": rel_err(y, y_plain)}
        if train:
            # CUDA events around the second backward pass of the kernels'
            # graph (the first one's launches are warm by then)
            row["backward_ms"] = backward_ms
            for name, g, g_plain, t in zip(names, grads, grads_plain,
                                           [h] + [p[k] for k in names[1:]]):
                if g.dtype != t.dtype or not bool(
                        torch.isfinite(g.float()).all()):
                    raise AssertionError(f"MoE layer {dtype}: d{name} is "
                                         f"{g.dtype}, finite "
                                         f"{bool(torch.isfinite(g).all())}")
                row[f"d{name}"] = rel_err(g, g_plain)
                gate(f"{cfg.name} MoE layer {dtype}, {tokens} tokens: "
                     f"d{name}, kernels vs plain", row[f"d{name}"], limit)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del p, h, y, y_plain, grads, grads_plain
        torch.cuda.empty_cache()
    return rows


def make_requests(cfg, n, prompt, new, seed):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(prompt[0], prompt[1] + 1))
    ).astype(np.int32), max_new_tokens=new) for i in range(n)]


def outputs(engine) -> dict:
    return {i: r.output for i, r in engine.done.items()}


def engine_equal_phase(cfg, params, *, plain=plain_attention, n=12, new=8,
                       ssd_routes=None):
    """The float32 engine, with the serving run's slots, cache and prompt
    lengths but fewer requests and tokens, gives the same greedy tokens
    with the kernel as with the model forced through the plain version.
    With ``ssd_routes`` (the SSD's launches by instance) the kernel run's
    scans must all have taken `expected_ssd_routes`' instance (SIMT in
    float32)."""
    from repro_torch.serve.engine import ServeEngine
    runs = []
    for use_plain in (False, True):
        eng = ServeEngine(cfg, params, batch_slots=SERVE["slots"],
                          max_seq=SERVE["max_seq"])
        for r in make_requests(cfg, n, SERVE["prompt"], new, seed=21):
            eng.submit(r)
        before = dict(ssd_routes or {})
        with plain() if use_plain else contextlib.nullcontext():
            eng.run_until_drained()
        runs.append(outputs(eng))
        if ssd_routes is not None and not use_plain:
            moved = {k: ssd_routes[k] - before[k] for k in before}
            if moved != (want := expected_ssd_routes(cfg, eng)):
                raise AssertionError(f"{cfg.name} float32 engine: SSD "
                                     f"routes {moved}, expected {want}")
    if runs[0] != runs[1] or len(runs[0]) != n:
        raise AssertionError(f"{cfg.name} float32 engine: greedy tokens "
                             f"differ between the kernel and the plain "
                             f"version")
    print(json.dumps({"f32_engine_greedy_equal": True, "model": cfg.name,
                      "requests": n,
                      "tokens": sum(len(o) for o in runs[0].values())}),
          flush=True)


class TimedModel:
    """Wraps the model's prefill and decode entry points, as the engine
    calls them, with a host clock that ends in a synchronise."""

    def __init__(self, model_lib):
        self.lib = model_lib
        self.prefill_s: list[float] = []
        self.decode_s: list[float] = []

    def _wrap(self, fn, into):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return timed

    @contextlib.contextmanager
    def on(self):
        saved = self.lib.prefill, self.lib.decode_step
        self.lib.prefill = self._wrap(saved[0], self.prefill_s)
        self.lib.decode_step = self._wrap(saved[1], self.decode_s)
        try:
            yield self
        finally:
            self.lib.prefill, self.lib.decode_step = saved


def profile_ticks(cfg, params, engine, ticks=4,
                  kernel="flash_attention_kernel"):
    """`torch.profiler` over a few decode ticks of a full engine: the
    device's busy time against the host's wall (the idle share), the
    device time of the port's ``kernel`` (None: the tick runs none), the
    GEMMs' and the unembedding's, the kernels that take the most, and
    the runtime calls per tick.  The profiler's own host cost inflates
    the wall; the unprofiled tick is the serving run's
    ``decode_ms_per_tick``."""
    from torch.profiler import ProfilerActivity, record_function

    from repro_torch.models import model as model_lib
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    unembed = model_lib._unembed

    def labelled(*a, **kw):
        with record_function("unembed"):
            return unembed(*a, **kw)

    torch.cuda.synchronize()
    model_lib._unembed = labelled
    try:
        with profiled(acts) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                logits, engine.cache, engine.lengths = model_lib.decode_step(
                    params, cfg, engine.last_tok, engine.cache,
                    engine.lengths)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        model_lib._unembed = unembed
    stats = prof.key_averages()
    # kernels only: a CPU op's entry repeats its kernels' device time, a
    # label's mirror on the device's timeline spans its kernels and gaps
    device = [e for e in stats
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in SPANS and e.key != "unembed"]

    def ms(events):
        return sum(e.self_device_time_total for e in events) / 1e3 / ticks

    busy = ms(device)
    port_kernel = ms(e for e in device if kernel and kernel in e.key)
    gemm = ms(e for e in device if "nvjet" in e.key or "gemm" in e.key)
    unembed_ms = sum(e.device_time_total for e in stats
                     if e.key == "unembed") / 1e3 / ticks
    runtime = {e.key: e.count / ticks for e in stats
               if "LaunchKernel" in e.key or e.key in (
                   "cudaMemcpyAsync", "cudaStreamSynchronize",
                   "cudaDeviceSynchronize")}
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    wall_ms = 1e3 * wall / ticks
    row = {"ticks": ticks, "wall_ms_per_tick": wall_ms,
           "device_busy_ms_per_tick": busy,
           "device_idle_share": 1 - busy / wall_ms if busy else None,
           "kernel": kernel, "kernel_ms_per_tick": port_kernel,
           "gemm_ms_per_tick": gemm, "unembed_ms_per_tick": unembed_ms,
           "kernel_share_of_busy": port_kernel / busy if busy else None,
           "kernels_per_tick": sum(e.count for e in device) / ticks,
           "aten_ops_per_tick": sum(e.count for e in stats
                                    if e.key.startswith("aten::")) / ticks,
           "runtime_calls_per_tick": runtime,
           "top_kernels": [{"name": e.key[:80],
                            "ms_per_tick": e.self_device_time_total / 1e3
                            / ticks, "calls_per_tick": e.count / ticks}
                           for e in top]}
    print(json.dumps({"decode_tick_profile": row}), flush=True)
    return row


def prefill_profile(cfg, params, S=1024, reps=3):
    """An S-token prefill of one request: its wall time (host clock
    ending in a synchronise, median of ``reps`` after a warm one,
    unprofiled) beside the device's busy time in one more run under
    `torch.profiler` (every kernel's, one stream) and the port's kernels'
    share of it, to tell a host-bound prefill from a device-bound one."""
    from torch.profiler import ProfilerActivity
    from repro_torch.models import model as model_lib
    device = torch.device("cuda", torch.cuda.current_device())
    toks = torch.tensor(np.random.default_rng(S).integers(
        0, cfg.vocab_size, (1, S)), device=device)

    def run():
        cache = model_lib.init_cache(cfg, 1, S + 16, device=device)
        model_lib.prefill(params, cfg, {"tokens": toks}, cache)
        torch.cuda.synchronize()

    run()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    with profiled([ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in SPANS]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    row = {"tokens": S, "wall_ms": 1e3 * wall, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / (1e3 * wall),
           "kernels": sum(e.count for e in kernels),
           "port_kernels_ms": {
               name: sum(e.self_device_time_total for e in kernels
                         if prefix in e.key) / 1e3
               for name, prefix in (("flash_attention", "flash_attention_"),
                                    ("ssd", "ssd_"), ("gmm", "gmm_"))}}
    print(json.dumps({"prefill_profile": cfg.name, **row}), flush=True)
    return row


def expected_launches(cfg, engine) -> dict:
    """The launches a serving run must count, by kernel: flash attention
    once per attention layer and model call, the SSD scan once per Mamba
    layer and prefill (decode runs the plain one-token update), the
    grouped matmul three times (gate, up, down) per MoE layer and model
    call, and no water-fill and no backward."""
    mixers = [cfg.mixer_kind(s) for s in range(cfg.period)]
    ffns = [cfg.ffn_kind(s) for s in range(cfg.period)]
    attn = cfg.n_scan * mixers.count("attn")
    ssm = cfg.n_scan * mixers.count("ssm")
    moe = cfg.n_scan * ffns.count("moe")
    calls = engine.prefill_calls + engine.decode_ticks
    return {"waterfill": 0, "flash_attention": attn * calls,
            "ssd": ssm * engine.prefill_calls, "gmm": 3 * moe * calls,
            "flash_attention_bwd": 0, "ssd_bwd": 0, "gmm_bwd": 0}


def expected_flash_routes(cfg, engine) -> dict:
    """The flash instances a bfloat16 serving run must take: every prefill
    call (at least 64 prompt tokens, so more than 32 rows per kv head) on
    the tensor cores, every decode tick (one token a slot) on the split."""
    mixers = [cfg.mixer_kind(s) for s in range(cfg.period)]
    attn = cfg.n_scan * mixers.count("attn")
    return {"wgmma": attn * engine.prefill_calls,
            "split": attn * engine.decode_ticks, "simt": 0}


def expected_ssd_routes(cfg, engine) -> dict:
    """The SSD instances a serving run must take: every prefill call's
    scan (once per Mamba layer) on the instance `ssd_route` names for the
    config's activation dtype, head dim, d_state and chunk: the tensor
    cores in bfloat16, the SIMT instance in float32."""
    mixers = [cfg.mixer_kind(s) for s in range(cfg.period)]
    ssm = cfg.n_scan * mixers.count("ssm")
    s = cfg.ssm
    dtype = getattr(torch, cfg.activation_dtype)
    want = ssd_route(dtype, s.head_dim, s.d_state, s.chunk)
    return {n: ssm * engine.prefill_calls * (n == want)
            for n in ("mma", "simt")}


def serve_phase(cfg, params, launch_counts, *, kernels=("flash_attention",),
                profile_kernel="flash_attention_kernel", routes=None):
    """The main path: `ServeEngine` at full width.  Every count is set
    to 0 just before the run and read just after; each must equal
    `expected_launches`, and each of ``kernels`` (the path's) must have
    launched.  ``routes`` (kernel name: its launches by instance) are set
    to 0 and read with them; flash's must equal `expected_flash_routes`
    and the SSD's `expected_ssd_routes`.  Then `profile_ticks` and
    `prefill_profile`, off the main path."""
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import ServeEngine
    reqs = make_requests(cfg, SERVE["requests"], SERVE["prompt"],
                         SERVE["new"], seed=11)
    engine = ServeEngine(cfg, params, batch_slots=SERVE["slots"],
                         max_seq=SERVE["max_seq"])
    for r in reqs:
        engine.submit(r)
    timer = TimedModel(model_lib)
    torch.cuda.synchronize()
    with timer.on():
        for counter in (launch_counts, *(routes or {}).values()):
            for name in counter:
                counter[name] = 0
        t0 = time.perf_counter()
        ticks = engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        routed = {k: dict(c) for k, c in (routes or {}).items()}
    expected = expected_launches(cfg, engine)
    if len(engine.done) != len(reqs) or any(
            len(r.output) != SERVE["new"] for r in engine.done.values()):
        raise AssertionError(f"serving {cfg.name}: not every request "
                             f"finished with {SERVE['new']} tokens")
    if counts != expected or not all(counts[k] > 0 for k in kernels):
        raise AssertionError(
            f"serving {cfg.name}: launches {counts}, expected {expected} "
            f"({engine.prefill_calls} prefills, {engine.decode_ticks} "
            f"decode ticks), each of {kernels} at least once")
    if "flash_attention" in routed and routed["flash_attention"] != (
            want := expected_flash_routes(cfg, engine)):
        raise AssertionError(
            f"serving {cfg.name}: flash routes {routed['flash_attention']}, "
            f"expected {want}")
    if "ssd" in routed and routed["ssd"] != (
            want := expected_ssd_routes(cfg, engine)):
        raise AssertionError(
            f"serving {cfg.name}: SSD routes {routed['ssd']}, expected "
            f"{want}")
    tokens = sum(len(r.output) for r in engine.done.values())
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    row = {"serve": cfg.name, "slots": SERVE["slots"],
           "max_seq": SERVE["max_seq"], "requests": len(reqs),
           "prompt_tokens": prompt_tokens, "new_tokens": tokens,
           "ticks": ticks, "prefill_calls": engine.prefill_calls,
           "decode_ticks": engine.decode_ticks, "launch_counts": counts,
           "routes": routed, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "prefill_ms_per_request": 1e3 * statistics.mean(timer.prefill_s),
           "prefill_ms_max": 1e3 * max(timer.prefill_s),
           "prefill_s_total": sum(timer.prefill_s),
           "decode_ms_per_tick": 1e3 * statistics.median(timer.decode_s),
           "decode_s_total": sum(timer.decode_s)}
    print(json.dumps(row), flush=True)

    # the tick's device-time breakdown, on a fresh full engine (its
    # launches are not the main path's)
    probe = ServeEngine(cfg, params, batch_slots=SERVE["slots"],
                        max_seq=SERVE["max_seq"])
    for r in make_requests(cfg, SERVE["slots"], SERVE["prompt"],
                           SERVE["new"], seed=12):
        probe.submit(r)
    probe.step()                                         # admit, warm
    prof = row["profile"] = profile_ticks(cfg, params, probe,
                                          kernel=profile_kernel)
    print(json.dumps({"decode_tick_shares": {
        "model": cfg.name, "decode_ms_per_tick": row["decode_ms_per_tick"],
        "kernel": prof["kernel_ms_per_tick"] / row["decode_ms_per_tick"],
        "gemm": prof["gemm_ms_per_tick"] / row["decode_ms_per_tick"],
        "unembed": prof["unembed_ms_per_tick"] / row["decode_ms_per_tick"],
        "device_busy": prof["device_busy_ms_per_tick"]
        / row["decode_ms_per_tick"]}}), flush=True)
    row["prefill_profile"] = prefill_profile(cfg, params)
    return row


def reclaim_phase(cfg, params):
    """examples/spot_serving.py at full width: the engine is lost after a
    few ticks, its unfinished requests go to a fresh engine, and every
    request is served."""
    from repro_torch.serve.engine import ServeEngine
    new = 8
    reqs = make_requests(cfg, 12, (64, 256), new, seed=31)
    engine = ServeEngine(cfg, params, batch_slots=SERVE["slots"],
                         max_seq=SERVE["max_seq"])
    for r in reqs[:10]:
        engine.submit(r)
    for _ in range(10):
        engine.step()
    lost = [r for r in reqs[:10] if r.rid not in engine.done]
    in_flight, queued = engine.busy_slots(), engine.queue_depth()
    for r in lost:
        r.output = None
    del engine
    engine2 = ServeEngine(cfg, params, batch_slots=SERVE["slots"],
                          max_seq=SERVE["max_seq"])
    for r in lost + reqs[10:]:
        engine2.submit(r)
    engine2.run_until_drained()
    served = {r.rid for r in reqs if r.output is not None}
    if served != set(range(len(reqs))) or any(
            len(r.output) != new for r in reqs):
        raise AssertionError("spot reclaim: not every request was served")
    print(json.dumps({"spot_reclaim": True, "requests": len(reqs),
                      "lost_in_flight": in_flight, "lost_queued": queued,
                      "served_by_replacement": len(engine2.done)}),
          flush=True)


# ---------------------------------------------------------------------------
# The enc-dec and VLM families: whisper-medium and llava-next-mistral-7b
# ---------------------------------------------------------------------------

def modal_launches(cfg) -> tuple[int, int]:
    """flash attention's launches per prefill and per decode tick of an
    enc-dec or VLM model: the decoder's attention layers, and for an
    enc-dec model the encoder's (prefill only) and a cross call per
    decoder layer (both)."""
    attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    if cfg.encoder is None:
        return attn, attn
    enc = sum(cfg.mixer_kind(i) == "attn"
              for i in range(cfg.encoder.n_layers))
    return attn + enc + cfg.n_layers, attn + cfg.n_layers


def serve_loop(cfg, params, reqs, extra, *, slots):
    """The serving engine's loop for an enc-dec or VLM model, which
    `ServeEngine` does not take (it passes tokens alone, as the JAX
    package's does): each request prefilled alone, with its own frames or
    patches (row i of ``extra``), into a fresh one-row cache spliced into
    its slot of the batch's cache; then decode ticks over every slot,
    greedy, until each request has its tokens.  Every request is admitted
    at once (at most ``slots``).  Goes through `model.prefill` and
    `model.decode_step` as module attributes, so `TimedModel` times
    them.  Returns ({rid: tokens}, prefill calls, decode ticks, the
    cache, the lengths and the last tokens after the last tick)."""
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import _splice_row
    if len(reqs) > slots:
        raise ValueError(f"serve_loop: {len(reqs)} requests, {slots} slots")
    dev = model_lib.params_device(params)
    max_seq = prefix_len(cfg) + max(len(r.prompt) for r in reqs) + max(
        r.max_new_tokens for r in reqs)
    cache = model_lib.init_cache(cfg, slots, max_seq, device=dev)
    lengths = torch.zeros((slots,), dtype=torch.int32, device=dev)
    last = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
    out = {}
    for i, r in enumerate(reqs):
        row = model_lib.init_cache(cfg, 1, max_seq, device=dev)
        batch = {"tokens": torch.as_tensor(r.prompt.astype(np.int64),
                                           device=dev)[None],
                 **{k: v[i:i + 1] for k, v in extra.items()}}
        logits, row, row_len = model_lib.prefill(params, cfg, batch, row)
        _splice_row(cache, row, i)
        lengths[i] = row_len[0]
        last[i, 0] = torch.argmax(logits[0])
        out[r.rid] = [int(last[i, 0])]
    ticks = 0
    while any(len(out[r.rid]) < r.max_new_tokens for r in reqs):
        logits, cache, lengths = model_lib.decode_step(params, cfg, last,
                                                       cache, lengths)
        ticks += 1
        last = torch.argmax(logits, dim=-1)[:, None]
        host = last[:, 0].tolist()
        for i, r in enumerate(reqs):
            if len(out[r.rid]) < r.max_new_tokens:
                out[r.rid].append(host[i])
    return out, len(reqs), ticks, cache, lengths, last


def modal_requests(cfg, device, seed=11):
    """`MODAL_SERVE`'s requests for cfg (prompt lengths from numpy seed
    ``seed``) and their frames or patches, one row each."""
    spec = MODAL_SERVE[cfg.name]
    reqs = make_requests(cfg, spec["requests"], spec["prompt"], spec["new"],
                         seed=seed)
    return reqs, modality_inputs(cfg, len(reqs), device, seed)


def modal_greedy_phase(cfg, params, device):
    """The float32 serving loop gives the same greedy tokens with the
    kernel as with attention through the plain version."""
    reqs, extra = modal_requests(cfg, device)
    slots = MODAL_SERVE[cfg.name]["slots"]
    runs = []
    for use_plain in (False, True):
        with plain_attention() if use_plain else contextlib.nullcontext():
            runs.append(serve_loop(cfg, params, reqs, extra, slots=slots)[0])
    if runs[0] != runs[1]:
        differ = [rid for rid in runs[0] if runs[0][rid] != runs[1][rid]]
        raise AssertionError(f"{cfg.name} float32 serving loop: greedy "
                             f"tokens differ between the kernel and the "
                             f"plain version in requests {differ}")
    print(json.dumps({"f32_engine_greedy_equal": True, "model": cfg.name,
                      "requests": len(reqs),
                      "tokens": sum(len(o) for o in runs[0].values())}),
          flush=True)


def modal_serve_phase(cfg, params, launch_counts, routes):
    """The main path of serving an enc-dec or VLM model: `serve_loop` in
    bfloat16 over `MODAL_SERVE`'s requests, every count (and flash's
    instances, ``routes``) set to 0 just before and read just after:
    flash attention launched `modal_launches`' count a prefill on the
    tensor cores and a tick on the decode split, nothing else launched.
    Prefill ms a request (the encoder included), decode ms a tick,
    tokens/s; then a profiler pass over 4 ticks at the last tick's
    lengths (off the main path): the device's busy time a tick and the
    flash kernel's share."""
    from repro_torch.models import model as model_lib
    spec = MODAL_SERVE[cfg.name]
    reqs, extra = modal_requests(cfg, model_lib.params_device(params))
    timer = TimedModel(model_lib)
    torch.cuda.synchronize()
    with timer.on():
        for counter in (launch_counts, routes):
            for name in counter:
                counter[name] = 0
        t0 = time.perf_counter()
        out, prefills, ticks, cache, lengths, last = serve_loop(
            cfg, params, reqs, extra, slots=spec["slots"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routed = dict(launch_counts), dict(routes)
    per_prefill, per_tick = modal_launches(cfg)
    want = {k: 0 for k in counts}
    want["flash_attention"] = per_prefill * prefills + per_tick * ticks
    want_routes = {"wgmma": per_prefill * prefills,
                   "split": per_tick * ticks, "simt": 0}
    if len(out) != len(reqs) or any(len(o) != spec["new"]
                                    for o in out.values()):
        raise AssertionError(f"serving {cfg.name}: not every request "
                             f"finished with {spec['new']} tokens")
    if counts != want or routed != want_routes:
        raise AssertionError(
            f"serving {cfg.name}: launches {counts} by instance {routed}, "
            f"expected {want} by instance {want_routes} ({prefills} "
            f"prefills of {per_prefill}, {ticks} ticks of {per_tick})")

    def tick():
        return model_lib.decode_step(params, cfg, last, cache, lengths)

    kernels = device_kernels(tick, 4)
    busy = sum(e.self_device_time_total for e in kernels) / 4 / 1e3
    flash = sum(e.self_device_time_total for e in kernels
                if "flash_attention" in e.key) / 4 / 1e3
    tokens = sum(len(o) for o in out.values())
    decode_ms = 1e3 * statistics.median(timer.decode_s)
    row = {"serve": cfg.name, "slots": spec["slots"], "requests": len(reqs),
           "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "prefix": prefix_len(cfg), "new_tokens": tokens,
           "prefill_calls": prefills, "decode_ticks": ticks,
           "launch_counts": counts, "routes": routed,
           "launches_per_prefill": per_prefill, "launches_per_tick": per_tick,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "prefill_ms_per_request": 1e3 * statistics.mean(timer.prefill_s),
           "prefill_ms_max": 1e3 * max(timer.prefill_s),
           "prefill_s_total": sum(timer.prefill_s),
           "decode_ms_per_tick": decode_ms,
           "decode_s_total": sum(timer.decode_s),
           "tick_device_busy_ms": busy, "tick_flash_ms": flash,
           "tick_device_busy_share": busy / decode_ms,
           "tick_flash_share_of_busy": flash / busy if busy else None}
    print(json.dumps(row), flush=True)
    return row


def modal_model_phase(cfg, device, launch_counts, fa):
    """An enc-dec or VLM model at full width: `model_phase`'s gates
    (float32 and bfloat16 forward, kernel against plain attention; float32
    prefill of 256 tokens then decode against the forward), the float32
    serving loop's greedy tokens with the kernel and without, then the
    bfloat16 serving loop, the main path.  Returns its row."""
    f32_cfg, f32_params, params = model_phase(cfg, device)
    modal_greedy_phase(f32_cfg, f32_params, device)
    del f32_params
    torch.cuda.empty_cache()
    row = modal_serve_phase(cfg, params, launch_counts, fa.route_counts)
    del params
    torch.cuda.empty_cache()
    return row


def window_phase(cfg, params, device, seed=0):
    """llama4's chunked layers with their window binding: a prompt of
    `WINDOW_PROMPT` tokens, longer than the window, through
    `prefill_decode_gate` (prefill but for the last `WINDOW_DECODE`
    tokens, then one-token decodes, whose rolling cache of ``window``
    slots wraps) against the teacher-forced forward, at `no_drops`'
    capacity.  Returns its row."""
    chunked = [i for i in range(cfg.n_layers)
               if not cfg.layer_uses_global_attn(i)]
    if not chunked or cfg.attn_window >= WINDOW_PROMPT - WINDOW_DECODE:
        raise AssertionError(f"{cfg.name}: no chunked layer whose window "
                             f"{cfg.attn_window} a {WINDOW_PROMPT}-token "
                             f"prompt binds")
    toks = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, WINDOW_PROMPT)), device=device)
    t0 = time.perf_counter()
    worst = prefill_decode_gate(cfg, params, {"tokens": toks},
                                WINDOW_PROMPT - WINDOW_DECODE)
    row = {"window_binding": cfg.name, "prompt": WINDOW_PROMPT,
           "decoded": WINDOW_DECODE, "window": cfg.attn_window,
           "chunked_layers": chunked, "rel_err": worst, "limit": GATE_F32,
           "wall_s": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    return row


def config_phase(name, gate_layers, serve_layers, device, launch_counts,
                 fa, gm):
    """One of `CONFIGS` at full width: `model_phase`'s gates at
    ``gate_layers`` (float32: kernels against the plain versions, prefill
    + decode against the forward; a dense model's bfloat16 forward too),
    the float32 engine's greedy tokens with the kernels and without; for
    an MoE model (llama4-scout) then `window_phase`, its expert products
    against the plain version and timed (`gmm_serving_phase`) and the
    routed bfloat16 gate at the serving depth; then serving in bfloat16
    at ``serve_layers`` (None: every layer), the main path, with exact
    launches and routes (every gmm launch on the tensor cores), and for
    granite-8b the spot reclaim of examples/spot_serving.py.  Returns
    the serving row (with the peak memory from the bfloat16 model's
    making on), with the window and gmm rows of an MoE model."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    moe = cfg.moe is not None
    plain, what = ((plain_kernels, "kernels") if moe
                   else (plain_attention, "attention"))
    f32_cfg, f32_params, bf = model_phase(cut_layers(cfg, gate_layers),
                                          device, plain=plain, what=what,
                                          bf16=not moe)
    del bf
    engine_equal_phase(f32_cfg, f32_params, plain=plain)
    extra = {}
    if moe:
        extra["window"] = window_phase(f32_cfg, f32_params, device)
    del f32_params
    torch.cuda.empty_cache()
    if moe:
        extra["gmm"] = gmm_serving_phase(gm, device, name, LLAMA4_PREFILLS)
    if serve_layers is not None:
        cfg = cut_layers(cfg, serve_layers)
    kernels, routes = ("flash_attention",), {
        "flash_attention": fa.route_counts}
    torch.cuda.reset_peak_memory_stats()
    if moe:
        params = routed_bf16_phase(cfg, device)
        kernels, routes = kernels + ("gmm",), dict(routes,
                                                   gmm=gm.route_counts)
    else:
        params = init_logged(cfg, device)
    served = serve_phase(cfg, params, launch_counts, kernels=kernels,
                         profile_kernel="gmm_kernel" if moe else
                         "flash_attention_kernel", routes=routes)
    if moe and served["routes"]["gmm"]["wgmma"] != \
            served["launch_counts"]["gmm"]:
        raise AssertionError(f"serving {name} in bfloat16: gmm routes "
                             f"{served['routes']['gmm']}, not every launch "
                             f"on the tensor cores")
    served["serving_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"serving_peak_gb": served["serving_peak_gb"],
                      "model": name, "layers": cfg.n_layers}), flush=True)
    if name == "granite-8b":
        reclaim_phase(cfg, params)
    del params
    torch.cuda.empty_cache()
    return {**served, **extra}


def whisper_train_phase(cfg, device, launch_counts, fa):
    """Training whisper-medium: the float32 and bfloat16 gates at full
    width with 2 encoder and 2 decoder layers (kernels against plain
    attention under autograd; the encoder's leaves get their gradient
    through the cross-attention's dk and dv), then `run_fixed` at full
    depth, its main path: `WHISPER_TRAIN`, each step 72 flash forward and
    72 backward launches (24 encoder, 24 decoder, 24 cross), all on the
    tensor cores."""
    train_f32_gate(cfg, device, launch_counts, seq=WHISPER_TRAIN["seq"])
    train_bf16_gate(cfg, device, launch_counts, seq=WHISPER_TRAIN["seq"],
                    limits=(GATE_WHISPER_TRAIN_BF16_LOSS,
                            GATE_TRAIN_BF16_GRAD))
    return train_phase(
        cfg, device, launch_counts,
        {"flash_attention": (fa.route_counts, "wgmma"),
         "flash_attention_bwd": (fa.bwd_route_counts, "wgmma")},
        per_step=training_launches(cfg), resume=False, train=WHISPER_TRAIN)


# ---------------------------------------------------------------------------
# Training: flash attention's backward, qwen2-1.5b through run_fixed
# ---------------------------------------------------------------------------

# the training run: qwen2-1.5b at full width, all 28 layers, bfloat16
TRAIN = dict(steps=6, batch=8, seq=512, ckpt_every=3)
#: the depth phases 15 and 16 train qwen2-1.5b and mamba2-1.3b at, at
#: full width: 28 and 48 layers until phase 28 joined the smoke (a slow
#: host's smoke then took 1320 s of the 1200; phase 15 155 s of it, most
#: of it qwen2's two 18.5 GB checkpoints and the resume)
TRAIN_LAYERS = {ARCH: 8, SSD_ARCH: 16}
# the float32 gate: the same widths cut to 2 layers
TRAIN_F32 = dict(layers=2, batch=2, seq=512)
# gates of the float32 model with the kernels against the plain versions
# (float32 sums in another order): the loss, and each gradient leaf on
# max |diff| / max |plain|
GATE_TRAIN_LOSS, GATE_TRAIN_GRAD = 1e-5, 1e-4
# gates of the same 2-layer model in bfloat16 with the kernels (the
# bfloat16 products' backward through `layers._MatmulF32`) against the
# float32 model of the same weights through the plain attention: the
# loss, and each gradient leaf on max |diff| / max |f32|.  Read on an
# H100 (every step deterministic, so every run reads the same): the
# loss 9.9e-7, the leaves 2.4e-3 to 7.6e-3 and the tied embedding's
# 1.30e-2; the limits are 10x and 2x those.  A dropped or miscast
# operand gradient moves a leaf by its own size.
GATE_TRAIN_BF16_LOSS, GATE_TRAIN_BF16_GRAD = 1e-5, 2.5e-2
# whisper-medium's bf16 loss gate (its leaves take qwen2's).  Read on an
# H100 (run 25b, 2 + 2 layers, 2 x 224 tokens and 2 x 1500 frames): the
# loss 4.18e-5 of 702.2 nats, the leaves up to 1.96e-2 (final_norm's
# bias); the limit is 10x the loss's reading, as mamba2's.  The same
# bfloat16 model with the plain attention reads 3.12e-5
# (`loss_rel_plain_bf16`; qwen2's 2.3e-6): the bfloat16 roundings outside
# attention set most of it
GATE_WHISPER_TRAIN_BF16_LOSS = 4.2e-4
# the resumed steps' losses against the first run's: the restored state
# is checked bit for bit first, and the steps are deterministic (the
# resumed losses equal the first run's bit for bit in every run so far);
# the limit leaves room for a few float32 ulps of a loss near 200
RESUME_TOL = 1e-6


def flash_bwd_bound(q, k, q_pos, kv_pos, mask):
    """Least time for the backward of this call
    (`roofline_adjust.flash_bwd_cost`): FlashAttention-2's backward work,
    2.5 x the forward's QK^T and PV FLOPs of the unmasked (query, key)
    pairs (4 Dh per pair and query head), at the tensor-core bf16 rate
    (float32 at the vector rate), against the bytes at the HBM rate: q,
    k, v, the output, its gradient and the forward's float32 log-sum-exp
    read once, dq, dk and dv written once, the positions.  Returns (ms,
    bound by, bytes, FLOPs)."""
    B, Sq, Hq, Dh = q.shape
    nbytes, flops = ra.flash_bwd_cost(B, Sq, k.shape[1], Hq, k.shape[2], Dh,
                                      q.element_size(),
                                      int(mask.sum().item()))
    return (*ra.bound_ms(nbytes, flops, q.dtype), nbytes, flops)


#: the backward's kernels, by the name each holds after "flash_bwd_"
BWD_KERNELS = ("dot", "dkdv", "dq")


def time_flash_bwd(fa, B, S, device, *, heads=(12, 2, 128), causal=True,
                   label=None):
    """The backward at a training shape, by default qwen2-1.5b's (12
    query heads over 2 kv heads of 128, causal; whisper's encoder passes
    16 over 16 of 64, no causal mask), bfloat16, no empty slot, checked
    against the plain backward on the routed instance and on the SIMT
    one (`ops._backward_instance`), then both timed: CUDA events (median
    of KERNEL_REPS) and device time in all and by kernel
    (`BWD_KERNELS`), beside the bound, the plain backward and SDPA's
    backward (its own mask, the kv heads expanded to the query heads; a
    yardstick only, its forward not timed)."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_mask,
    )
    Hq, Hkv, Dh = heads
    case = (B, S, S, Hq, Hkv, Dh, causal, None, None, 0)
    label = label or f"qwen2-train-{B}x{S}"
    inputs, kw, dout = flash_bwd_inputs(case, torch.bfloat16, device,
                                        dense=True)
    (q, k, v, qp, kp) = inputs
    _, rel, err, lse_err = check_flash_bwd(label, fa, inputs, kw, dout)
    _, simt_rel, simt_err, _ = check_flash_bwd(f"{label}-simt", fa, inputs,
                                               kw, dout, instance="simt")
    out, lse = fa.flash_attention_forward(q, k, v, qp, kp, **kw)
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1).detach()
              .requires_grad_() for x in (k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    lib_dout = dout.transpose(1, 2)

    def kernel():
        return fa.flash_attention_backward(q, k, v, out, dout, lse, qp, kp,
                                           **kw)

    def simt():
        return fa._backward_instance("simt", q, k, v, out, dout, lse, qp, kp,
                                     **kw)

    def plain():
        return attention_backward_reference(q, k, v, out, dout, lse, qp, kp,
                                            **kw)

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), lib_dout,
                                   retain_graph=True)

    mask = attention_mask(qp, kp, causal=causal, window=None).expand(B, S, S)
    bound_ms, bound_by, nbytes, flops = flash_bwd_bound(q, k, qp, kp, mask)
    by = device_ms_by(kernel, KERNEL_REPS, "flash_bwd_", BWD_KERNELS)
    simt_by = device_ms_by(simt, KERNEL_REPS, "flash_bwd_", BWD_KERNELS)
    row = {"flash_bwd_case": label, "route": fa.bwd_route(q, k, v),
           "shape": [B, S, Hq, Dh, S, Hkv], "dtype": "bfloat16",
           "ms": cuda_ms(kernel, KERNEL_REPS),
           "device_ms": by.pop("all"), "kernels_device_ms": by,
           "simt_ms": cuda_ms(simt, KERNEL_REPS),
           "simt_device_ms": simt_by.pop("all"),
           "simt_kernels_device_ms": simt_by,
           "plain_ms": cuda_ms(plain, KERNEL_REPS),
           "library_ms": cuda_ms(library, KERNEL_REPS),
           "library_device_ms": device_ms(library, KERNEL_REPS),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops, "max_abs_err": max(err, simt_err),
           "max_rel_err": rel, "simt_max_rel_err": simt_rel,
           "lse_max_abs_err": lse_err}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    row["device_over_library"] = (row["device_ms"]
                                  / row["library_device_ms"])
    row["simt_over_wgmma_device"] = (row["simt_device_ms"]
                                     / row["device_ms"])
    print(json.dumps(row), flush=True)
    return row


def flash_bwd_phase(fa, device):
    """The backward kernel against the plain backward on every
    `FLASH_BWD_CASES` case in both dtypes (each forward instance's
    log-sum-exp against the plain one; the backward through the instance
    `flash_bwd_route` names; two calls bitwise equal), then timed at
    qwen2-1.5b's training shapes and at whisper-medium's encoder's (early
    in the process, where the profiler reads every launch).  Returns (the
    timed rows, the largest absolute error of any check)."""
    worst = 0.0
    for case in FLASH_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs, kw, dout = flash_bwd_inputs(case, dtype, device)
            label = f"bwd{case}-{str(dtype).split('.')[1]}"
            got, rel, err, lse_err = check_flash_bwd(label, fa, inputs, kw,
                                                     dout, masked=case[9])
            out, lse = fa.flash_attention_forward(*inputs, **kw)
            again = fa.flash_attention_backward(*inputs[:3], out, dout, lse,
                                                *inputs[3:], **kw)
            if not all(bitwise_equal(a.float(), b.float())
                       for a, b in zip(got, again)):
                raise AssertionError(f"{label}: two calls differ")
            worst = max(worst, err)
            print(json.dumps({
                "flash_bwd_case": label,
                "forward": flash_route(dtype, case[1], case[3], case[4],
                                       case[5]),
                "backward": flash_bwd_route(dtype, case[5]),
                "max_rel_err": rel, "max_abs_err": err,
                "lse_max_abs_err": lse_err,
                "tol": FLASH_BWD_TOL[dtype]}), flush=True)
    rows = [time_flash_bwd(fa, B, S, device) for B, S in FLASH_BWD_TIMED]
    B, S = WHISPER_BWD_TIMED
    rows.append(time_flash_bwd(fa, B, S, device, heads=(16, 16, 64),
                               causal=False,
                               label=f"whisper-encoder-train-{B}x{S}"))
    return rows, max([worst] + [r["max_abs_err"] for r in rows])


def state_items(tree, prefix=""):
    """(path, tensor) of a `TrainState`'s parameters, moments and step
    (or of a nested dict of tensors)."""
    if not isinstance(tree, dict):
        tree = vars(tree) if hasattr(tree, "params") else tree
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from state_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def loss_and_grads(model_lib, params, cfg, batch):
    """One `loss_fn` and its backward: the loss and the gradient of
    every leaf, in the parameters' order."""
    from repro_torch.models.param import tree_leaves, tree_map
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model_lib.loss_fn(req, cfg, batch, remat="none")
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(req))


def cut_layers(cfg, n: int):
    """cfg cut to ``n`` layers (and an encoder's to ``n`` too)."""
    enc = cfg.encoder
    if enc is not None:
        enc = dataclasses.replace(enc, n_layers=n)
    return dataclasses.replace(cfg, n_layers=n, encoder=enc)


def gate_batch(cfg, device, seq):
    """`TRAIN_F32`'s batch of the synthetic pipeline at ``seq`` tokens,
    with an enc-dec model's frames or a VLM's patches (`make_batch`)."""
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.train import make_batch
    pipe = SyntheticTokenPipeline(cfg.vocab_size, seq, TRAIN_F32["batch"])
    return make_batch(cfg, pipe, 0, TRAIN_F32["batch"], device)


def check_gate_launches(label, cfg, launch_counts, before, kernels):
    """Each of ``kernels`` launched as often as one `loss_fn` and its
    backward launch it (`training_launches`)."""
    want = training_launches(cfg)
    for name in kernels:
        if launch_counts[name] - before[name] != want[name]:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launch_counts[name] - before[name]} "
                                 f"times, not {want[name]}")


def zero_grad_leaf(cfg, path: str) -> bool:
    """Whether a leaf's gradient is 0 in exact arithmetic: without RoPE an
    attention key bias adds q . b to every logit of a query, which the
    softmax cancels (whisper's self- and cross-attention)."""
    return not cfg.rope and path.endswith("wk/b")


def leaf_errors(cfg, names, grads, want) -> dict:
    """max |diff| / max |want| of each gradient leaf; a `zero_grad_leaf`'s
    own max is rounding noise, so its difference is taken against the
    largest max |want| of any leaf instead."""
    scale = max(float(b.float().abs().max()) for b in want)
    return {name: (float((a.float() - b.float()).abs().max()) / scale
                   if zero_grad_leaf(cfg, name) else rel_err(a, b))
            for name, a, b in zip(names, grads, want)}


def check_encoder_grads(label, cfg, names, grads):
    """An enc-dec model's encoder leaves all get a nonzero gradient: the
    encoder reaches the loss only through the decoder's cross-attention
    keys and values (the backward's dk and dv)."""
    enc = [name for name, g in zip(names, grads) if name.startswith(
        "encoder/") and not zero_grad_leaf(cfg, name) and not bool(
        g.float().abs().max() > 0)]
    if cfg.encoder is not None and enc:
        raise AssertionError(f"{label}: encoder leaves with no gradient: "
                             f"{enc}")


def train_f32_gate(cfg, device, launch_counts, *,
                   kernels=("flash_attention", "flash_attention_bwd"),
                   plain=plain_attention, seq=TRAIN_F32["seq"]):
    """qwen2-1.5b (mamba2-1.3b, whisper-medium) at full width cut to
    `TRAIN_F32`'s layers (an encoder's too), float32: one `loss_fn` and
    backward with the kernels (each of ``kernels``, a forward and its
    backward, as often as `training_launches` counts) against the same
    with the kernel through the plain version (``plain``), which autograd
    differentiates.  Each leaf on `leaf_errors`."""
    from repro_torch.models import model as model_lib
    f32 = dataclasses.replace(cut_layers(cfg, TRAIN_F32["layers"]),
                              param_dtype="float32",
                              activation_dtype="float32")
    params = model_lib.init_model(f32, seed=0, device=device)
    batch = gate_batch(f32, device, seq)

    before = dict(launch_counts)
    loss, grads = loss_and_grads(model_lib, params, f32, batch)
    check_gate_launches("f32 training gate", f32, launch_counts, before,
                        kernels)
    with plain():
        loss_plain, grads_plain = loss_and_grads(model_lib, params, f32,
                                                 batch)
    if not bool(torch.isfinite(loss)) or not all(
            bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("f32 training gate: loss or gradients not "
                             "finite")
    names = [path for path, _ in state_items(params)]
    check_encoder_grads("f32 training gate", f32, names, grads)
    leaves = leaf_errors(f32, names, grads, grads_plain)
    worst = max(leaves, key=leaves.get)
    print(json.dumps({"train_f32_gate": {"model": cfg.name,
                                         "worst_leaf": worst,
                                         "leaves": leaves}}), flush=True)
    gate(f"{cfg.name} f32 {f32.n_layers} layers: loss, kernels vs plain",
         abs(float(loss) - float(loss_plain)) / abs(float(loss_plain)),
         GATE_TRAIN_LOSS)
    gate(f"{cfg.name} f32 {f32.n_layers} layers: worst gradient leaf, "
         f"kernels vs plain", leaves[worst], GATE_TRAIN_GRAD)
    del params, grads, grads_plain
    torch.cuda.empty_cache()


def train_bf16_gate(cfg, device, launch_counts, *,
                    kernels=("flash_attention", "flash_attention_bwd"),
                    plain=plain_attention,
                    limits=(GATE_TRAIN_BF16_LOSS, GATE_TRAIN_BF16_GRAD),
                    seq=TRAIN_F32["seq"]):
    """qwen2-1.5b (mamba2-1.3b, whisper-medium) at full width cut to
    `TRAIN_F32`'s layers (an encoder's too) in its own bfloat16: one
    `loss_fn` and backward with the kernels (each of ``kernels`` as often
    as `training_launches` counts), whose MLP and unembedding products
    differentiate through `layers._MatmulF32`, against the float32 model
    of the same weights (the bfloat16 ones widened) with the kernel
    through the plain version (``plain``), held to ``limits`` (the loss,
    the worst leaf on `leaf_errors`).  Prints the readings, each leaf's
    max |diff| / max |f32| among them, and the loss of the bfloat16
    model with the plain version against the float32 one's (how far the
    roundings outside the kernels move it)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import tree_map
    bf16 = cut_layers(cfg, TRAIN_F32["layers"])
    if bf16.param_dtype != "bfloat16":
        raise AssertionError(f"bf16 training gate: {cfg.name} is "
                             f"{bf16.param_dtype}")
    f32 = dataclasses.replace(bf16, param_dtype="float32",
                              activation_dtype="float32")
    params = model_lib.init_model(bf16, seed=0, device=device)
    batch = gate_batch(bf16, device, seq)
    before = dict(launch_counts)
    loss, grads = loss_and_grads(model_lib, params, bf16, batch)
    check_gate_launches("bf16 training gate", bf16, launch_counts, before,
                        kernels)
    from repro_torch.models.param import tree_leaves
    if any(g.dtype != t.dtype for g, t in zip(grads, tree_leaves(params))):
        raise AssertionError("bf16 training gate: a gradient is not in its "
                             "parameter's dtype")
    with plain():
        loss_ref, grads_ref = loss_and_grads(
            model_lib, tree_map(lambda p: p.float(), params), f32, batch)
        with torch.no_grad():
            loss_plain_bf16 = model_lib.loss_fn(params, bf16, batch,
                                                remat="none")[0]
    if not bool(torch.isfinite(loss)) or not all(
            bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("bf16 training gate: loss or gradients not "
                             "finite")
    names = [path for path, _ in state_items(params)]
    check_encoder_grads("bf16 training gate", bf16, names, grads)
    leaves = leaf_errors(bf16, names, grads, grads_ref)
    loss_rel = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    plain_rel = abs(float(loss_plain_bf16) - float(loss_ref)) / abs(
        float(loss_ref))
    print(json.dumps({"train_bf16_gate": {"model": cfg.name,
                                          "loss": float(loss),
                                          "loss_f32": float(loss_ref),
                                          "loss_rel": loss_rel,
                                          "loss_plain_bf16": float(
                                              loss_plain_bf16),
                                          "loss_rel_plain_bf16": plain_rel,
                                          "leaves": leaves}}), flush=True)
    gate(f"{cfg.name} bf16 {bf16.n_layers} layers: loss, kernels vs f32 "
         f"plain", loss_rel, limits[0])
    gate(f"{cfg.name} bf16 {bf16.n_layers} layers: worst gradient leaf, "
         f"kernels vs f32 plain", max(leaves.values()), limits[1])
    del params, grads, grads_ref
    torch.cuda.empty_cache()


#: the program spans of a training step whose device-timeline span the
#: summary reads (`make_train_step`); every program span's mirror on the
#: device's timeline is left out of the busy time
#: (`observability.steps.SPANS`)
STEP_LABELS = ("forward", "optimizer")


def profile_summary(prof, wall_ms, kernel="flash_bwd_"):
    """A profiled training step: the device's busy time (its kernels' and
    copies' own time) against the step's wall, the device-timeline span
    of its forward and its optimizer (`STEP_LABELS`; a span includes
    the gaps between its kernels) and its share of the wall, the
    backward kernel's (the kernels whose name holds ``kernel``) share of
    the busy time and the kernels that take the most."""
    stats = prof.key_averages()
    device = [e for e in stats
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in SPANS]
    span = {e.key: e.device_time_total / 1e3 for e in stats
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key in STEP_LABELS}
    busy = sum(e.self_device_time_total for e in device) / 1e3
    mine = sum(e.self_device_time_total for e in device
               if kernel in e.key) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:12]
    name = kernel.rstrip("_")
    optimizer = span.get("optimizer")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "device_idle_share": 1 - busy / wall_ms,
            "forward_span_ms": span.get("forward"),
            "optimizer_span_ms": optimizer,
            "optimizer_share_of_wall": (optimizer / wall_ms
                                        if optimizer is not None else None),
            f"{name}_ms": mine,
            f"{name}_share_of_busy": mine / busy if busy else None,
            "kernels": sum(e.count for e in device),
            "top_kernels": [{"name": e.key[:80],
                             "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in top]}


def train_phase(cfg, device, launch_counts, routes, *, per_step,
                resume=True, profile_kernel="flash_bwd_", cpu_tol=None,
                train=TRAIN):
    """The main path of training: `run_fixed` on cfg (qwen2-1.5b,
    mamba2-1.3b and whisper-medium at full width, the reduced jamba) at
    ``train`` (`TRAIN` unless given), with every count set to 0 just
    before and read just after, and per step: each step must launch each
    kernel of ``per_step`` that many times and nothing else, each launch
    on the instance ``routes`` names ({kernel: (its counts by instance,
    the instance)}).  Every loss finite; checkpoints at steps 3 and 6
    (none where ``train["ckpt_every"]`` is None, which takes no
    ``resume`` and no ``cpu_tol``).  With ``resume`` the step-3 checkpoint
    restored into a fresh state then retakes steps 4-6 (one of them
    profiled) with the first run's losses within `RESUME_TOL`; without,
    step 2 of the first run is profiled (outside steps 3-6, whose median
    stays unprofiled).  With ``cpu_tol`` steps 4-6 retaken on the CPU
    (the plain versions) from the step-3 checkpoint must give every loss
    within that relative difference of the card's."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as launch_train
    build = ROOT / "build" / "repro_torch"
    build.mkdir(parents=True, exist_ok=True)
    saves = train["ckpt_every"] is not None
    if not saves and (resume or cpu_tol is not None):
        raise ValueError("train_phase: a resume needs checkpoints")
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=build) if saves \
        else None
    steps = []
    state_bytes = []    # the parameters' and both moments' bytes

    at_3 = {}           # the state after step 3, in host memory

    prof = (None if resume
            else profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA]))

    def by_instance():
        return {name: dict(c) for name, (c, _) in routes.items()}

    def on_step(i, state, metrics, seconds):
        if i == 0:
            state_bytes.append(sum(
                t.numel() * t.element_size() for tree in (
                    state.params, state.opt["mu"], state.opt["nu"])
                for _, t in state_items(tree)))
        steps.append({"step": i, "seconds": seconds,
                      "counts": dict(launch_counts), "routes": by_instance(),
                      "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"])})
        if i == 2 and resume:
            at_3.update((path, t.to("cpu", copy=True))
                        for path, t in state_items(state))
        if not resume and i == 0:
            prof.start()
        elif not resume and i == 1:
            prof.stop()

    restored_checked = []

    def check_restored(state):
        """The step-3 checkpoint restored into a fresh state: every
        parameter, both moments and the step bit for bit the state the
        first run had after step 3."""
        got = dict(state_items(state))
        if got.keys() != at_3.keys():
            raise AssertionError(f"training {cfg.name}: restored leaves "
                                 f"{sorted(got.keys() ^ at_3.keys())} "
                                 f"differ from the step-3 state's")
        differ = [path for path, t in got.items()
                  if t.dtype != at_3[path].dtype
                  or not torch.equal(t.cpu(), at_3[path])]
        if differ:
            raise AssertionError(f"training {cfg.name}: restored leaves "
                                 f"differ from the step-3 state: {differ}")
        restored_checked.append(len(got))
        print(json.dumps({"restored_step_3": {
            "leaves": len(got), "bitwise_equal": True,
            "bytes": sum(t.numel() * t.element_size()
                         for t in got.values())}}), flush=True)

    kw = dict(steps=train["steps"], batch=train["batch"], seq=train["seq"],
              ckpt_dir=ckpt, log_every=1, device=device)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for counter in (launch_counts, *(c for c, _ in routes.values())):
            for name in counter:
                counter[name] = 0
        losses = launch_train.run_fixed(
            cfg, ckpt_every=train["ckpt_every"] or 10 ** 9, on_step=on_step,
            **kw)
        counts, routed = dict(launch_counts), by_instance()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if len(losses) != train["steps"] or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"training {cfg.name}: losses {losses}")
        want = {k: per_step.get(k, 0) for k in counts}
        want_via = {name: {k: per_step[name] * (k == inst) for k in c}
                    for name, (c, inst) in routes.items()}
        prev = {"counts": {k: 0 for k in counts},
                "routes": {name: {k: 0 for k in c}
                           for name, c in routed.items()}}
        for s in steps:
            delta = {k: s["counts"][k] - prev["counts"][k] for k in counts}
            via = {name: {k: s["routes"][name][k] - prev["routes"][name][k]
                          for k in c} for name, c in routed.items()}
            if delta != want or via != want_via:
                raise AssertionError(
                    f"training {cfg.name}, step {s['step']}: launches "
                    f"{delta} by instance {via}, expected {want} by "
                    f"instance {want_via}")
            prev = s
        if any(counts[k] != n * train["steps"] for k, n in per_step.items()):
            raise AssertionError(f"training {cfg.name}: {counts}")
        committed = CheckpointManager(ckpt).all_steps() if saves else None
        if saves and committed != [3, 6]:
            raise AssertionError(f"training {cfg.name}: checkpoints "
                                 f"{committed}, expected [3, 6]")
        timed = [s["seconds"] for s in steps[2:]]       # steps 3-6
        step_ms = 1e3 * statistics.median(timed)
        tokens = train["batch"] * train["seq"]
        if resume:
            again, worst, profile = resume_run(cfg, losses, kw,
                                               check_restored,
                                               restored_checked,
                                               profile_kernel)
        else:
            again = worst = None
            profile = profile_summary(prof, 1e3 * steps[1]["seconds"],
                                      kernel=profile_kernel)
        cpu = cpu_worst = None
        if cpu_tol is not None:
            # the same steps on the CPU from the same state: the weights a
            # seed gives differ between the two devices' generators
            cpu = launch_train.run_fixed(
                cfg, ckpt_every=10 ** 9, resume_from=3,
                **dict(kw, device=torch.device("cpu")))
            cpu_worst = max(abs(a - b) / abs(b)
                            for a, b in zip(cpu, losses[3:]))
            gate(f"training {cfg.name}: steps 4-6 on the CPU from the "
                 f"card's step-3 checkpoint, losses vs the card's",
                 cpu_worst, cpu_tol)
    finally:
        if saves:
            shutil.rmtree(ckpt, ignore_errors=True)
    row = {"train": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.param_dtype, "batch": train["batch"],
           "seq": train["seq"], "steps": train["steps"], "losses": losses,
           "grad_norms": [s["grad_norm"] for s in steps],
           "step_seconds": [s["seconds"] for s in steps],
           "step_ms_median_3_6": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "max_memory_allocated_gb": peak / 1e9, "wall_s": wall,
           "state_bytes": state_bytes[0],
           "launch_counts": counts, "routes": routed,
           "resumed_losses": again, "resume_worst_rel": worst,
           "cpu_losses": cpu, "cpu_worst_rel": cpu_worst,
           "profiled_step": profile}
    print(json.dumps({"train_run": row}), flush=True)
    return row


def resume_run(cfg, losses, kw, check_restored, restored_checked,
               profile_kernel):
    """The step-3 checkpoint of ``kw["ckpt_dir"]`` into a fresh state
    (``check_restored`` checks it); steps 4-6 retaken with step 5 (i = 4)
    profiled and no checkpoint written; the losses against the first
    run's within `RESUME_TOL`.  Returns (the resumed losses, the worst
    relative difference, the profiled step's summary)."""
    from torch.profiler import ProfilerActivity

    from repro_torch.launch import train as launch_train
    prof = profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    resumed = []

    def on_resume(i, state, metrics, seconds):
        resumed.append((i, seconds))
        if i == 3:
            prof.start()
        elif i == 4:
            prof.stop()

    again = launch_train.run_fixed(cfg, ckpt_every=10 ** 9, resume_from=3,
                                   on_step=on_resume,
                                   on_resume=check_restored, **kw)
    if not restored_checked:
        raise AssertionError(f"training {cfg.name}: the resume did not "
                             f"restore a state")
    worst = max(abs(a - b) / abs(b) for a, b in zip(again, losses[3:]))
    gate(f"training {cfg.name}: steps 4-6 resumed from the step-3 "
         f"checkpoint, losses vs the first run", worst, RESUME_TOL)
    return again, worst, profile_summary(prof, 1e3 * resumed[1][1],
                                         kernel=profile_kernel)


# ---------------------------------------------------------------------------
# Training mamba2: the SSD scan's backward, mamba2-1.3b through run_fixed
# ---------------------------------------------------------------------------

# gates on max |kernel - plain| / max |plain| of each gradient (0 where
# both are exactly 0): float32 sums in another order; the tensor-core
# instance rounds the masked, decayed products to bfloat16 before their
# products, and bfloat16 gradients round once to 8 bits
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the timed backward calls (bfloat16, chunk 256, G = 1, no initial
# state): mamba2-1.3b's training shape and a longer sequence, and
# jamba-v0.1-52b's heads (label, B, S, H, P, N)
SSD_BWD_TIMED = [("mamba2", 8, 512, 64, 64, 128),
                 ("mamba2", 2, 2048, 64, 64, 128),
                 ("jamba", 2, 2048, 128, 64, 64)]
#: the backward's kernels, by the name each holds after "ssd_bwd_"
SSD_BWD_KERNELS = ("states", "pass", "scores", "keys", "queries", "dcum",
                   "group_sums", "head_sums")
# gates of mamba2's 2-layer model in bfloat16 with the kernels against the
# float32 model of the same weights through the plain scan: the loss, and
# each gradient leaf on max |diff| / max |f32|.  Read on an H100 (run
# 21d): the loss 3.14e-5, the leaves 3.4e-3 to 7.8e-3 and dt_bias's
# 1.47e-2; the limits are 10x and 2x those, as qwen2's.  (The float32
# gate read 0 on the loss and 1.98e-5 on the worst leaf.)
GATE_SSD_TRAIN_BF16_LOSS, GATE_SSD_TRAIN_BF16_GRAD = 3.2e-4, 3e-2


def ssd_bwd_inputs(seed, case, dtype, device, *, inputs=None, dfinal=False):
    """A backward case's inputs (`ssd_inputs`, or ``inputs`` as given),
    the output gradient dy in ``dtype`` and, with ``dfinal``, a
    final-state gradient (float32), drawn by `ssd_bwd_arrays`."""
    B, S, H, P, G, N, chunk, init = case[:8]
    arrays, dy, df = ssd_bwd_arrays(seed, B, S, H, P, G, N, init, dfinal)
    if inputs is None:
        inputs = ssd_inputs(seed, B, S, H, P, G, N, init, dtype, device)
    return (inputs, torch.tensor(dy, device=device).to(dtype),
            None if df is None else torch.tensor(df, device=device))


#: the backward's work (see `roofline_adjust.ssd_bwd_flops`)
ssd_bwd_flops = ra.ssd_bwd_flops


def ssd_bwd_bound(x, Bm, init, dfinal, chunk):
    """Least time for one backward call (`roofline_adjust.ssd_bwd_cost`):
    x and dy, B and C per group, dt, A, D, the states the forward kept
    (every chunk's but a first one without an initial state, 4 bytes an
    element) and the final state's gradient once in; dx, dB, dC, ddt, dA,
    dD and the initial state's gradient once out, at the HBM rate;
    against `ssd_bwd_flops` at the tensor-core bf16 rate (float32 at the
    vector rate).  Returns (ms, bound by, bytes, FLOPs)."""
    Bsz, S, H, P = x.shape
    nbytes, flops = ra.ssd_bwd_cost(Bsz, S, H, P, Bm.shape[2], Bm.shape[3],
                                    chunk, x.element_size(), init is not None,
                                    dfinal is not None)
    return (*ra.bound_ms(nbytes, flops, x.dtype), nbytes, flops)


def check_ssd_bwd(label, so, case, seed, dtype, device, *, inputs=None,
                  dfinal=False, instance=None):
    """The backward kernel against the plain backward on the card: the
    forward through `ssd_forward` (which keeps the entering states), then
    the backward twice (bitwise equal) through the instance
    `ssd_route` names (or ``instance``, forced), each gradient within
    `SSD_BWD_TOL` of its max, in its input's dtype and finite.  Returns
    the row (the worst relative error of each gradient, the largest
    absolute one), the inputs and the gradients."""
    from repro_torch.kernels.build import launch_counts
    from repro_torch.kernels.ssd.ref import ssd_backward_reference
    B, S, H, P, G, N, chunk, init = case[:8]
    ins, dy, df = ssd_bwd_inputs(seed, case, dtype, device, inputs=inputs,
                                 dfinal=dfinal)
    x, dt, A, Bm, Cm, D, st = ins
    _, _, kept = so.ssd_forward(x, dt, A, Bm, Cm, D, chunk=chunk,
                                initial_state=st)
    want = instance or ssd_route(dtype, P, N, chunk)
    kw = dict(chunk=chunk, initial_state=st, dfinal=df, kept=kept)

    def kernel():
        if instance is None:
            return so.ssd_backward(x, dt, A, Bm, Cm, D, dy, **kw)
        return so._backward_instance(instance, x, dt, A, Bm, Cm, D, dy, **kw)

    before, launched = dict(so.bwd_route_counts), launch_counts["ssd_bwd"]
    got, again = kernel(), kernel()
    plain = ssd_backward_reference(x, dt, A, Bm, Cm, D, st, dy, df, chunk)
    torch.cuda.synchronize()
    routed = {k: so.bwd_route_counts[k] - before[k] for k in before}
    if (routed != {k: 2 * (k == want) for k in routed}
            or launch_counts["ssd_bwd"] != launched + 2):
        raise AssertionError(f"{label}: backward routed {routed}, expected "
                             f"two calls on {want}")
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")
    dtypes = (dtype, torch.float32, torch.float32, dtype, dtype,
              torch.float32, torch.float32)
    errs, worst_abs = {}, 0.0
    for name, g, g2, p, want_dtype in zip(names, got, again, plain, dtypes):
        if (g is None) != (p is None):
            raise AssertionError(f"{label}: {name} is {g}, plain {p}")
        if g is None:
            continue
        if g.dtype != want_dtype or g.shape != p.shape:
            raise AssertionError(f"{label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, plain {p.dtype} "
                                 f"{tuple(p.shape)}")
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"{label}: {name} is not finite")
        if not bitwise_equal(g.float(), g2.float()):
            raise AssertionError(f"{label}: two calls differ in {name}")
        errs[name] = rel_err(g, p)
        worst_abs = max(worst_abs, float((g.float() - p.float()).abs().max()))
    tol = SSD_BWD_TOL[dtype]
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{label}: gradients {bad} differ from the "
                             f"plain backward by more than {tol} of their "
                             f"max")
    row = {"ssd_bwd_case": label, "instance": want,
           "dtype": str(dtype).split(".")[1], "shape": list(case[:8]),
           "dfinal": dfinal, "max_rel_err": max(errs.values()),
           "max_abs_err": worst_abs, "errs": errs, "tol": tol}
    return row, (ins, dy, df, kept), got


def time_ssd_bwd(so, label, B, S, H, P, N, device):
    """The backward at one training shape (bfloat16, G = 1, chunk 256, no
    initial state or final-state gradient), checked against the plain
    backward on the routed instance and on the SIMT one, then both timed:
    CUDA events (median of KERNEL_REPS) and device time in all and by
    kernel (`SSD_BWD_KERNELS`), beside the bound and the plain backward
    (no PyTorch call computes it: library_ms is null)."""
    from repro_torch.kernels.ssd.ref import ssd_backward_reference
    case = (B, S, H, P, 1, N, 256, False)
    row, (ins, dy, df, kept), _ = check_ssd_bwd(
        f"{label}-train-{B}x{S}", so, case, 60 + S, torch.bfloat16, device)
    simt_row, _, _ = check_ssd_bwd(f"{label}-train-{B}x{S}-simt", so, case,
                                   60 + S, torch.bfloat16, device,
                                   inputs=ins, instance="simt")
    x, dt, A, Bm, Cm, D, st = ins
    kw = dict(chunk=256, kept=kept)

    def kernel():
        return so.ssd_backward(x, dt, A, Bm, Cm, D, dy, **kw)

    def simt():
        return so._backward_instance("simt", x, dt, A, Bm, Cm, D, dy, **kw)

    def plain():
        return ssd_backward_reference(x, dt, A, Bm, Cm, D, None, dy, None,
                                      256)

    bound_ms, bound_by, nbytes, flops = ssd_bwd_bound(x, Bm, None, None, 256)
    by = device_ms_by(kernel, KERNEL_REPS, "ssd_bwd_", SSD_BWD_KERNELS)
    simt_by = device_ms_by(simt, KERNEL_REPS, "ssd_bwd_", SSD_BWD_KERNELS)
    row.update(
        ssd_bwd_case=f"{label}-train-{B}x{S}", shape=[B, S, H, P, 1, N, 256],
        ms=cuda_ms(kernel, KERNEL_REPS), device_ms=by.pop("all"),
        kernels_device_ms=by, simt_ms=cuda_ms(simt, KERNEL_REPS),
        simt_device_ms=simt_by.pop("all"), simt_kernels_device_ms=simt_by,
        plain_ms=cuda_ms(plain, KERNEL_REPS), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
        simt_max_rel_err=simt_row["max_rel_err"])
    row["max_abs_err"] = max(row["max_abs_err"], simt_row["max_abs_err"])
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    row["simt_over_mma_device"] = row["simt_device_ms"] / row["device_ms"]
    print(json.dumps(row), flush=True)
    return row


def ssd_bwd_tile_passes(so):
    """ptxas' registers and spill bytes of the tensor-core backward's
    key and query passes (`ssd_bwd_keys_wgmma`, `ssd_bwd_queries_wgmma`)
    at each head dim and d_state."""
    rows = []
    for r in ptxas_report(so.bwd_build_log, "ssd_bwd_"):
        name = re.search(r"ssd_bwd_(keys|queries)_wgmmaILi(\d+)ELi(\d+)E",
                         r["kernel"])
        if name:
            rows.append({"pass": name[1], "P": int(name[2]),
                         "N": int(name[3]), "registers": r.get("registers"),
                         "spill_bytes": r.get("spill_bytes")})
    return rows


def ssd_bwd_phase(so, device):
    """The backward kernel against the plain backward on every `SSD_CASES`
    case in both dtypes, every `SSD_TC_CASES` case (bfloat16, the fused
    views where the case has them) and `SSD_BWD_DFINAL` in both dtypes
    (with a final-state gradient), each through the instance `ssd_route`
    names, bitwise on two calls; then timed at `SSD_BWD_TIMED`.  Returns
    (the timed rows, the largest absolute error of any check)."""
    rows = []
    for case in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_ssd_bwd(f"bwd{case}", so, case, 0, dtype,
                                      device, dfinal=case[7])[0])
    for case in SSD_TC_CASES:
        rows.append(check_ssd_bwd(f"bwd-tc{case}", so, case, 6,
                                  torch.bfloat16, device,
                                  inputs=ssd_tc_inputs(case, device),
                                  dfinal=True)[0])
    for case in SSD_BWD_TC_CASES:
        rows.append(check_ssd_bwd(f"bwd-tc-edge{case}", so, case, 9,
                                  torch.bfloat16, device, dfinal=case[7])[0])
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(check_ssd_bwd(f"bwd-dfinal{SSD_BWD_DFINAL}", so,
                                  SSD_BWD_DFINAL, 3, dtype, device,
                                  dfinal=True)[0])
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"ssd_bwd_tile_passes": ssd_bwd_tile_passes(so)}),
          flush=True)
    timed = [time_ssd_bwd(so, *shape, device) for shape in SSD_BWD_TIMED]
    torch.cuda.empty_cache()
    return timed, max(r["max_abs_err"] for r in rows + timed)


# ---------------------------------------------------------------------------
# Training jamba: the grouped matmul's backward, jamba's MoE layer and
# period, the reduced jamba through run_fixed
# ---------------------------------------------------------------------------

# gates on max |kernel - plain| / max |plain| of each gradient (0 where
# both are exactly 0): float32 sums in another order; the tensor-core
# instance rounds the float32 cotangent to bfloat16 once, and bfloat16
# gradients round once to 8 bits
GMM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# groups that end inside drhs's 64-row stages, beside empty ones, an
# unaligned start and a tail (E, K, N, sizes, tail)
GMM_BWD_STAGE_CASES = [(5, 192, 256, [100, 37, 0, 130, 64], 11),
                       (3, 64, 136, [1, 63, 65], 0)]
# the tensor-core backward's tiling (128 x 256 tiles, clusters of two
# blocks): groups ending inside a 128-row tile, a 256-column tile and a
# 64-row stage; an odd count of row tiles (300, 333, 191: 3 each); a
# pair's second tile wholly past K (K 200, 120) or partly (K 520), drhs's
# second block of K rows past K (K 120) and dout boxes past N (N 136,
# 264); empty groups, a tail, E = 1 (E, K, N, sizes, tail)
GMM_BWD_TILE_CASES = [(4, 200, 136, [300, 0, 129, 64], 7),
                      (1, 520, 264, [333], 0),
                      (3, 120, 512, [64, 65, 191], 5),
                      (6, 264, 392, [0, 256, 1, 0, 127, 384], 130)]
# jamba's training expert products: 8 x 512 tokens, top-2, capacity factor
# 1.25, so C = 640 and 10,240 rows in 16 groups
MOE_TRAIN_TOKENS = TRAIN["batch"] * TRAIN["seq"]
#: the backward's kernels, by the name each holds
GMM_BWD_KERNELS = ("gmm_bwd_dlhs", "gmm_bwd_drhs")
# gates of jamba's one period (8 layers) in bfloat16, kernels against the
# plain versions on the same weights with the routes pinned: the loss,
# and the worst gradient leaf on max |diff| / max |plain|.  Read on an
# H100 (every kernel deterministic, so every run reads the same): the
# loss 3.97e-5, the leaves 5.7e-3 to 4.35e-2 (slot 2's A_log; the MoE
# leaves 1.1e-2 to 2.7e-2); the limits are 10x the loss's and 2x the
# worst leaf's, that one cut to GATE_BF16
GATE_PERIOD_LOSS, GATE_PERIOD_GRAD = 4e-4, GATE_BF16
# the reduced jamba's losses on the card against the same steps on the
# CPU from the same checkpoint
GATE_CPU_LOSSES = 1e-5


def gmm_bwd_inputs(seed, E, K, N, sizes, tail, dtype, device):
    """`gmm_inputs` and a unit-normal float32 output gradient (the MoE
    layer's products are float32)."""
    lhs, rhs, gs = gmm_inputs(seed, E, K, N, sizes, tail, dtype, device)
    dout = np.random.default_rng(seed + 100).standard_normal(
        (lhs.shape[0], N)).astype(np.float32)
    return lhs, rhs, gs, torch.tensor(dout, device=device)


def check_gmm_bwd(label, gm, lhs, rhs, gs, dout):
    """The backward kernel against the plain backward on the card: two
    calls (bitwise equal) through the instance `gmm_route` names, each
    gradient in its input's dtype, finite, within `GMM_BWD_TOL` of its
    max; the padding rows' dlhs and the empty groups' drhs exactly 0.
    Returns the row."""
    from repro_torch.kernels.build import launch_counts
    from repro_torch.kernels.moe_gmm.ref import gmm_backward_reference
    E, K, N = rhs.shape
    want = gmm_route(lhs.dtype, K, N)
    before, launched = dict(gm.bwd_route_counts), launch_counts["gmm_bwd"]
    got = gm.gmm_backward(lhs, rhs, gs, dout)
    again = gm.gmm_backward(lhs, rhs, gs, dout)
    plain = gmm_backward_reference(lhs, rhs, gs, dout)
    torch.cuda.synchronize()
    routed = {k: gm.bwd_route_counts[k] - before[k] for k in before}
    if (routed != {k: 2 * (k == want) for k in routed}
            or launch_counts["gmm_bwd"] != launched + 2):
        raise AssertionError(f"{label}: backward routed {routed}, expected "
                             f"two calls on {want}")
    sizes = gs.tolist()
    errs, worst_abs = {}, 0.0
    for name, g, g2, p, x in zip(("dlhs", "drhs"), got, again, plain,
                                 (lhs, rhs)):
        if g.dtype != x.dtype or g.shape != x.shape:
            raise AssertionError(f"{label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}, input {x.dtype} "
                                 f"{tuple(x.shape)}")
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"{label}: {name} is not finite")
        if not bitwise_equal(g.float(), g2.float()):
            raise AssertionError(f"{label}: two calls differ in {name}")
        errs[name] = rel_err(g, p)
        worst_abs = max(worst_abs, float((g.float() - p.float()).abs().max()))
    if bool(got[0][min(sum(sizes), lhs.shape[0]):].any()) or any(
            bool(got[1][e].any()) for e, n in enumerate(sizes) if n == 0):
        raise AssertionError(f"{label}: a padding row's dlhs or an empty "
                             f"group's drhs is not 0")
    tol = GMM_BWD_TOL[lhs.dtype]
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{label}: gradients {bad} differ from the "
                             f"plain backward by more than {tol} of their "
                             f"max")
    row = {"gmm_bwd_case": label, "instance": want,
           "dtype": str(lhs.dtype).split(".")[1],
           "shape": [lhs.shape[0], K, N, E], "sizes": sizes,
           "max_rel_err": max(errs.values()), "max_abs_err": worst_abs,
           "errs": errs, "tol": tol}
    print(json.dumps(row), flush=True)
    return row


def gmm_bwd_bound(lhs, rhs, group_sizes, dout, which):
    """`gmm_bound`'s rule for one gradient (``which``: "dlhs" or "drhs";
    `roofline_adjust.gmm_bwd_cost`): its inputs once in (dout as given,
    float32; rhs of the non-empty groups for dlhs, lhs for drhs; the group
    sizes) and its output once out, at the HBM rate, against 2 x K x N
    FLOPs per row in a group at the tensor-core bf16 rate (float32 at the
    vector rate).  Returns (ms, bound by, bytes, FLOPs)."""
    E, K, N = rhs.shape
    sizes = group_sizes.tolist()
    rows = min(sum(max(g, 0) for g in sizes), lhs.shape[0])
    live = sum(1 for g in sizes if g > 0)
    nbytes, flops = ra.gmm_bwd_cost(lhs.shape[0], K, N, E, rows, live,
                                    lhs.element_size(), rhs.element_size(),
                                    dout.element_size(), which)
    return (*ra.bound_ms(nbytes, flops, lhs.dtype), nbytes, flops)


def moe_training_shapes():
    """jamba's expert products in a training step of `TRAIN`'s batch
    (label, rows E x C, K, N): gate/up (d -> f) and down (f -> d)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    cfg = get_config(MOE_ARCH)
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    rows = E * capacity(cfg, MOE_TRAIN_TOKENS)
    return [(f"train-{MOE_TRAIN_TOKENS}-{what}", rows, K, N)
            for what, K, N in (("gate", d, f), ("down", f, d))]


def time_gmm_bwd(gm, label, rows, K, N, device):
    """The backward at one of jamba's training products (bfloat16 lhs and
    rhs, float32 dout), checked against the plain backward, then timed:
    CUDA events (median of KERNEL_REPS) of the whole backward and of dlhs
    and drhs alone, device time by kernel (`device_ms_per_launch`; the
    cast of dout to bfloat16 is the rest), beside each gradient's bound,
    the plain backward and
    `torch.bmm` of the same products on the bfloat16-rounded dout (a
    yardstick only: the groups are equal), and each gradient's floor
    probe (`ops.bwd_stream_floor`: its kernel without the products, on
    the rounded dout), events and device time."""
    from repro_torch.kernels.moe_gmm.ref import gmm_backward_reference
    lhs, rhs, gs = moe_serving_inputs(rows, K, N, torch.bfloat16, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    dout = torch.randn((rows, N), generator=gen, device=device)
    row = check_gmm_bwd(label, gm, lhs, rhs, gs, dout)
    E = rhs.shape[0]
    C = rows // E

    def kernel(need=(True, True)):
        return gm.gmm_backward(lhs, rhs, gs, dout, need=need)

    def library(which=("dlhs", "drhs")):
        d = dout.bfloat16().view(E, C, N)
        out = []
        if "dlhs" in which:
            out.append(torch.bmm(d, rhs.transpose(1, 2)))
        if "drhs" in which:
            out.append(torch.bmm(lhs.view(E, C, K).transpose(1, 2), d))
        return out

    by, read = device_ms_per_launch(kernel, KERNEL_REPS, GMM_BWD_KERNELS)
    total = by.pop("all")
    row.update(
        gmm_bwd_case=label, shape=[rows, K, N, E],
        ms=cuda_ms(kernel, KERNEL_REPS), device_ms=total,
        kernels_device_ms=by, profiler_launches_read=read,
        cast_device_ms=total - sum(by.values()),
        plain_ms=cuda_ms(lambda: gmm_backward_reference(lhs, rhs, gs, dout),
                         KERNEL_REPS),
        library_ms=cuda_ms(library, KERNEL_REPS))
    nbytes = flops = 0
    rounded = dout.bfloat16()
    for which, need in (("dlhs", (True, False)), ("drhs", (False, True))):
        b_ms, b_by, b_bytes, b_flops = gmm_bwd_bound(lhs, rhs, gs, dout,
                                                     which)
        ms = cuda_ms(lambda: kernel(need), KERNEL_REPS)
        name = f"gmm_bwd_{which}"

        def floor():
            return gm.bwd_stream_floor(lhs, rhs, gs, rounded, which)
        floor_by, _ = device_ms_per_launch(floor, KERNEL_REPS, (name,))
        row[which] = {
            "ms": ms, "device_ms": by[name],
            "floor_ms": cuda_ms(floor, KERNEL_REPS),
            "floor_device_ms": floor_by[name],
            "library_ms": cuda_ms(lambda: library((which,)), KERNEL_REPS),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": b_bytes,
            "flops": b_flops, "bound_share": b_ms / ms,
            "device_bound_share": b_ms / by[name]}
        nbytes, flops = nbytes + b_bytes, flops + b_flops
    bound, bound_by = ra.bound_ms(nbytes, flops, torch.bfloat16)
    row.update(bound_ms=bound, bound_by=bound_by, bytes=nbytes, flops=flops,
               bound_share=bound / row["ms"],
               device_bound_share=bound / row["device_ms"])
    print(json.dumps(row), flush=True)
    del lhs, rhs, dout, rounded
    torch.cuda.empty_cache()
    return row


def gmm_bwd_phase(gm, device):
    """The backward kernel against the plain backward on every case of
    the reference suite in both dtypes, the ragged cases in both, the
    tensor-core edge cases in bfloat16, `GMM_BWD_STAGE_CASES` and
    `GMM_BWD_TILE_CASES` in both, each through the instance `gmm_route`
    names, bitwise on two calls; then ptxas' report and the clusters of
    drhs's persistent grid, and the timings at jamba's training products.
    Returns (the timed rows, the largest absolute error of any check)."""
    rows = []
    both = (torch.float32, torch.bfloat16)
    cases = ([(f"bwd-case{(E, K, N, sizes, tail)}", (E, K, N, sizes, tail),
               both) for E, K, N, _bt, sizes, tail in GMM_CASES]
             + [(f"bwd-ragged{case}", case, both) for case in GMM_RAGGED]
             + [(f"bwd-tc{case}", case, (torch.bfloat16,))
                for case in GMM_TC_CASES]
             + [(f"bwd-stages{case}", case, both)
                for case in GMM_BWD_STAGE_CASES]
             + [(f"bwd-tiles{case}", case, both)
                for case in GMM_BWD_TILE_CASES])
    for label, case, dtypes in cases:
        for dtype in dtypes:
            rows.append(check_gmm_bwd(
                f"{label}-{str(dtype).split('.')[1]}", gm,
                *gmm_bwd_inputs(12, *case, dtype, device)))
    print(json.dumps({"gmm_bwd_ptxas": ptxas_report(gm.bwd_build_log,
                                                    "gmm_bwd_"),
                      "gmm_bwd_drhs_clusters": gm.drhs_clusters(device)}),
          flush=True)
    timed = [time_gmm_bwd(gm, *shape, device)
             for shape in moe_training_shapes()]
    return timed, max(r["max_abs_err"] for r in rows + timed)


def training_launches(cfg) -> dict:
    """The launches one `loss_fn` and its backward make (remat "none"),
    by kernel: flash attention and its backward once per attention
    layer (an encoder's included) and once more per decoder layer of an
    enc-dec model (its cross-attention), the SSD scan and its backward
    once per Mamba layer, the grouped matmul and its backward three times
    per MoE layer."""
    layers = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)
    mixers = [cfg.mixer_kind(i) for i in range(layers)]
    ffns = [cfg.ffn_kind(i) for i in range(layers)]
    cross = cfg.n_layers if cfg.encoder is not None else 0
    fwd = {"flash_attention": mixers.count("attn") + cross,
           "ssd": mixers.count("ssm"), "gmm": 3 * ffns.count("moe")}
    return {**fwd, **{f"{k}_bwd": n for k, n in fwd.items()}}


def period_grad_phase(cfg, device, launch_counts, routes):
    """jamba at full width, one period (8 layers: 7 Mamba, 1 attention, 4
    MoE FFNs) in bfloat16: `loss_fn` and its backward on `TRAIN_F32`'s
    batch with every kernel (every count set to 0 just before and read
    just after: each kernel of the path and its backward launched once a
    layer that runs it, the grouped matmul's three times, each on the
    instance ``routes`` names), the gradients finite and in their
    parameters' dtype, then moved to host memory; then the same with
    every kernel through its plain version (the grouped matmul through
    `PlainGmmFn`) and the routes pinned to the kernels side's, held to
    `GATE_PERIOD_LOSS` and `GATE_PERIOD_GRAD`.  Prints each side's peak
    memory and the routes the plain side would have chosen otherwise."""
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import param_count, tree_leaves
    cfg = dataclasses.replace(cfg, n_layers=cfg.period)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_lib.init_model(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = SyntheticTokenPipeline(
        cfg.vocab_size, TRAIN_F32["seq"], TRAIN_F32["batch"]).torch_batch_at(
        0, device)
    per_call = training_launches(cfg)
    for counter in (launch_counts, *(c for c, _ in routes.values())):
        for name in counter:
            counter[name] = 0
    t0 = time.perf_counter()
    with Routes().on() as kernel_routes:
        loss, grads = loss_and_grads(model_lib, params, cfg, batch)
    torch.cuda.synchronize()
    kernels_s = time.perf_counter() - t0
    counts = dict(launch_counts)
    routed = {name: dict(c) for name, (c, _) in routes.items()}
    want = {k: per_call.get(k, 0) for k in counts}
    want_via = {name: {k: per_call[name] * (k == inst) for k in c}
                for name, (c, inst) in routes.items()}
    if counts != want or routed != want_via:
        raise AssertionError(f"{cfg.name} one period: launches {counts} by "
                             f"instance {routed}, expected {want} by "
                             f"instance {want_via}")
    leaves = tree_leaves(params)
    if any(g.dtype != t.dtype for g, t in zip(grads, leaves)):
        raise AssertionError(f"{cfg.name} one period: a gradient is not in "
                             f"its parameter's dtype")
    if not bool(torch.isfinite(loss)) or not all(
            bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"{cfg.name} one period: loss or gradients not "
                             f"finite")
    peak_kernels = torch.cuda.max_memory_allocated()
    host = [g.to("cpu") for g in grads]
    del grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_kernels(gmm=plain_gmm_fn), kernel_routes.pinned() as moved:
        loss_plain, grads_plain = loss_and_grads(model_lib, params, cfg,
                                                 batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    peak_plain = torch.cuda.max_memory_allocated()
    n_params = param_count(params)
    names = [path for path, _ in state_items(params)]
    del params, leaves
    torch.cuda.empty_cache()
    errs = {name: rel_err(g.to(device), g_plain)
            for name, g, g_plain in zip(names, host, grads_plain)}
    worst = max(errs, key=errs.get)
    loss_rel = abs(float(loss) - float(loss_plain)) / abs(float(loss_plain))
    row = {"period_grad": cfg.name, "layers": cfg.n_layers,
           "dtype": cfg.param_dtype, "batch": TRAIN_F32["batch"],
           "seq": TRAIN_F32["seq"], "params": n_params, "init_s": init_s,
           "loss": float(loss), "loss_plain": float(loss_plain),
           "loss_rel": loss_rel, "worst_leaf": worst,
           "worst_leaf_err": errs[worst], "leaf_errs": errs,
           "kernels_s": kernels_s, "plain_s": plain_s,
           "peak_gb_kernels": peak_kernels / 1e9,
           "peak_gb_plain": peak_plain / 1e9,
           "routes_moved_per_call": moved, "moe_calls": len(moved),
           "launch_counts": counts, "routes": routed}
    print(json.dumps(row), flush=True)
    gate(f"{cfg.name} one period bf16: loss, kernels vs plain, routes "
         f"pinned", loss_rel, GATE_PERIOD_LOSS)
    gate(f"{cfg.name} one period bf16: worst gradient leaf, kernels vs "
         f"plain, routes pinned", errs[worst], GATE_PERIOD_GRAD)
    del host, grads_plain
    torch.cuda.empty_cache()
    return row


def jamba_train_phase(device, launch_counts, fa, so, gm):
    """The main path of training jamba: `run_fixed` on the reduced jamba
    (`reduced_config`'s widths and depth, float32, its head dim raised
    from 16 to 32: attention's kernel takes 32, 64 and 128) at `TRAIN`,
    with the resume and steps 4-6 on the CPU (`GATE_CPU_LOSSES`); each
    step launches every kernel of the path and its backward once a layer
    that runs it (the grouped matmul's three times), each on the
    instance its route names for the config's dtype and shapes."""
    from repro_torch.configs import reduced_config
    cfg = dataclasses.replace(reduced_config(MOE_ARCH), d_head=32)
    dtype = getattr(torch, cfg.param_dtype)
    m, s = cfg.moe, cfg.ssm
    flash = flash_route(dtype, TRAIN["seq"], cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head)
    ssd = ssd_route(dtype, s.head_dim, s.d_state, s.chunk)
    gmm = gmm_route(dtype, cfg.d_model, m.d_ff_expert)
    routes = {"flash_attention": (fa.route_counts, flash),
              "flash_attention_bwd": (fa.bwd_route_counts,
                                      flash_bwd_route(dtype, cfg.d_head)),
              "ssd": (so.route_counts, ssd),
              "ssd_bwd": (so.bwd_route_counts, ssd),
              "gmm": (gm.route_counts, gmm),
              "gmm_bwd": (gm.bwd_route_counts, gmm)}
    return train_phase(cfg, device, launch_counts, routes,
                       per_step=training_launches(cfg),
                       profile_kernel="gmm_bwd_", cpu_tol=GATE_CPU_LOSSES)


# ---------------------------------------------------------------------------
# The pool service: `python -m repro_torch.service smoke`'s sequence on the
# water-fill kernel, and the command line itself
# ---------------------------------------------------------------------------

# the service smoke's day: the command line's defaults (a diurnal day at
# seed 7, the spot provider drained at t = 30,000 s, a snapshot at t =
# 10,000 s) but 2,000 jobs, not 10,000: on an H100 80GB HBM3 at 700 W
# the 10k day took 71 s on torch and 47 s on numpy, which would bring the
# smoke to about 970 s of its 1200; the command line's own round trip
# serves the same day
SERVICE_DAY = dict(jobs=2_000, seed=7, t_drain=30_000.0, t_snap=10_000.0,
                   max_t=5e6)
SERVICE_DIR = ROOT / "build" / "repro_torch" / "service"


def service_ini(matchmaker: str | None = None) -> str:
    """The service's standard 3-provider federation, with ``[provision]
    matchmaker = `` naming the negotiation backend (None: the default,
    numpy)."""
    from repro_torch.service.__main__ import STANDARD_INI
    if matchmaker is None:
        return STANDARD_INI
    return STANDARD_INI.replace("[provision]\n", "[provision]\nmatchmaker = "
                                f"{matchmaker}\n", 1)


@contextlib.contextmanager
def counted_calls(cls, names=("match", "match_cycles", "preview_many")):
    """Counts the calls of ``cls``'s methods ``names`` (the matchmaker's
    entry points, each one water-fill launch) while it is on; yields the
    counts by name."""
    calls = dict.fromkeys(names, 0)
    saved = {name: cls.__dict__[name] for name in names}

    def counted(name, fn):
        def call(self, *a, **kw):
            calls[name] += 1
            return fn(self, *a, **kw)
        return call

    for name, fn in saved.items():
        setattr(cls, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def service_sequence(api, ini, trace, snap_path, *, t_drain, t_snap, kw,
                     budget_s=3600.0):
    """`_cmd_smoke`'s live run (src/repro_torch/service/__main__.py) on
    ``api`` (a package's PoolService, serve_in_thread and RemoteClient):
    a service over HTTP gets the trace at trace times and the spot drain
    at ``t_drain``, runs as fast as it can, is snapshotted once its clock
    passes ``t_snap`` and shut down; a service resumed from the snapshot
    runs until drained; its /metrics, /metrics.prom and /trace must carry
    what `_cmd_smoke` checks.  Returns (the resumed service, the
    snapshot's reply, its last status)."""
    PoolService, serve_in_thread, RemoteClient = api
    svc = PoolService(ini, **kw)
    server, url = serve_in_thread(svc)
    rc = RemoteClient(url, timeout=120.0)
    if not rc.healthz().get("ok"):
        raise AssertionError("service: healthz not ok")
    r = rc.submit([rec.to_obj() for rec in trace.records],
                  at_trace_times=True, at=0.0)
    if r.get("scheduled") != len(trace.records):
        raise AssertionError(f"service: submit scheduled {r} != "
                             f"{len(trace.records)}")
    rc.drain_backend("spot", at=t_drain)
    rc.start(None)                      # as fast as possible
    while True:
        st = rc.status()
        if st["t"] >= t_snap or st["drained"]:
            break
        time.sleep(0.02)
    saved = rc.snapshot(str(snap_path))
    rc.shutdown()                       # the first service is gone
    server.server_close()

    svc2 = PoolService.resume(str(snap_path), speed=None)
    server2, url2 = serve_in_thread(svc2)
    rc2 = RemoteClient(url2, timeout=120.0)
    rc2.start(None)
    deadline = time.time() + budget_s
    while True:
        st = rc2.status()
        if st["drained"]:
            break
        if time.time() > deadline:
            raise AssertionError(f"service: the resumed run is not drained "
                                 f"in {budget_s} s (t={st['t']})")
        time.sleep(0.02)
    svc2.stop()
    check_service_surfaces(rc2)
    rc2.shutdown()
    server2.server_close()
    if st["detached_backends"] != ["spot"]:
        raise AssertionError(f"service: spot not detached: "
                             f"{st['detached_backends']}")
    return svc2, saved, st


def check_service_surfaces(rc):
    """`_cmd_smoke`'s checks of a drained service's telemetry: /metrics
    carries the gauges, backends and the Fig 2/3 series, /metrics.prom
    the pool's gauges and histograms, /trace well-formed events with the
    jobs' run spans."""
    m = rc.metrics()
    for key in ("gauges", "backends", "series"):
        if key not in m:
            raise AssertionError(f"service: /metrics missing {key!r}")
    for key in ("idle_jobs", "running_jobs", "provisioned_cores",
                "cost_rate"):
        if key not in m["series"] or key not in m["gauges"]:
            raise AssertionError(f"service: /metrics missing {key!r}")
    prom = rc.metrics_prom()
    for needle in ("# TYPE repro_pool_idle_jobs gauge",
                   "# TYPE repro_job_wait_seconds histogram",
                   "# TYPE repro_cycle_phase_seconds histogram",
                   "repro_job_spans_total"):
        if needle not in prom:
            raise AssertionError(f"service: /metrics.prom missing "
                                 f"{needle!r}")
    evs = rc.trace().get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise AssertionError("service: /trace has no traceEvents")
    if any(not {"name", "ph", "pid"} <= set(e)
           or (e["ph"] != "M" and "ts" not in e) for e in evs):
        raise AssertionError("service: /trace events missing required keys")
    if not any(e.get("ph") == "X" and e.get("cat") == "job,run"
               for e in evs):
        raise AssertionError("service: /trace has no job run spans")


def check_service_equal(svc, ref, trace):
    """The resumed service's completed jobs, summary and Fig 2/3 series
    equal the uninterrupted run ``ref``'s exactly (the float64 plan
    contract), and its jobs, core-seconds and GPU-seconds are the
    trace's."""
    got, want = svc.completed_stats().state_dict(), \
        ref.completed_stats().state_dict()
    if got != want:
        raise AssertionError(f"service: completed stats diverge:\n ref "
                             f"{want}\n got {got}")
    if json.dumps(ref.summary(), sort_keys=True, default=str) != \
            json.dumps(svc.summary(), sort_keys=True, default=str):
        raise AssertionError("service: summary() diverges from the "
                             "uninterrupted run's")
    if svc.metrics()["series"] != ref.metrics()["series"]:
        raise AssertionError("service: the Fig 2/3 series diverge from the "
                             "uninterrupted run's")
    stats = trace.stats()
    if got["n"] != stats["n"]:
        raise AssertionError(f"service: completed {got['n']} != trace "
                             f"{stats['n']}")
    for key in ("core_seconds", "gpu_seconds"):
        x, y = got[key], stats[key]
        if abs(x - y) > 1e-6 * max(1.0, abs(x), abs(y)):
            raise AssertionError(f"service: {key} not conserved: {x} != {y}")


def service_phase(launch_counts, *, matchmaker="torch"):
    """The pool service on the card: `service_sequence` with ``[provision]
    matchmaker = torch`` (`service_ini`) against the uninterrupted run of
    the same day on the NumPy backend (the CLI's `_smoke_reference`),
    equal by `check_service_equal`; the water-fill's launches are set to
    0 just before the live run and read just after, and must equal the
    calls of the matchmaker's three entry points (`counted_calls`), more
    than 0; then `service_cli_phase`.  Returns the row."""
    from repro_torch.core.matchmaker import TorchMatchmaker
    from repro_torch.service import PoolService, RemoteClient
    from repro_torch.service.__main__ import SMOKE_KW, _smoke_reference
    from repro_torch.service.http import serve_in_thread
    from repro_torch.workload.generators import generate_preset
    day = SERVICE_DAY
    trace = generate_preset("diurnal", day["jobs"], seed=day["seed"])
    t0 = time.perf_counter()
    ref = _smoke_reference(service_ini(), trace, day["t_drain"],
                           day["max_t"])
    wall_numpy = time.perf_counter() - t0
    SERVICE_DIR.mkdir(parents=True, exist_ok=True)
    with counted_calls(TorchMatchmaker) as calls:
        launch_counts["waterfill"] = 0
        t0 = time.perf_counter()
        svc, saved, _ = service_sequence(
            (PoolService, serve_in_thread, RemoteClient),
            service_ini(matchmaker), trace, SERVICE_DIR / "pool_snap.json",
            t_drain=day["t_drain"], t_snap=day["t_snap"], kw=SMOKE_KW)
        wall_torch = time.perf_counter() - t0
        launches = launch_counts["waterfill"]
        calls = dict(calls)
    check_service_equal(svc, ref, trace)
    if matchmaker == "torch" and not 0 < launches == sum(calls.values()):
        raise AssertionError(f"service: {launches} water-fill launches for "
                             f"the matchmaker's calls {calls}")
    row = {"jobs": day["jobs"], "wall_s_torch": wall_torch,
           "wall_s_numpy": wall_numpy, "waterfill_launches": launches,
           "equal": True, "matchmaker_calls": calls,
           "snapshot_t": saved["t"], "drained_t": svc.sim.now,
           "cli": service_cli_phase(matchmaker, day["jobs"], day["seed"])}
    print(json.dumps({"service": row}), flush=True)
    return row


def service_cli_phase(matchmaker, jobs, seed, timeout_s=600.0):
    """`python -m repro_torch.service` itself: `serve --ini (matchmaker
    named) --as-fast --port P --start` in a process of its own, then, each
    in its own process, `submit` of a ``jobs``-job diurnal day at trace
    times, `status` until drained with every job completed, `snapshot`
    and `shutdown`; every command must exit 0, the server too.  Returns
    its row."""
    import socket
    SERVICE_DIR.mkdir(parents=True, exist_ok=True)
    ini = SERVICE_DIR / f"{matchmaker}.ini"
    ini.write_text(service_ini(matchmaker))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([path] if path else [])))
    cli = [sys.executable, "-m", "repro_torch.service"]
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    server = subprocess.Popen(
        cli + ["serve", "--ini", str(ini), "--as-fast", "--port", str(port),
               "--start"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    commands = 0

    def run(verb, *args):
        nonlocal commands
        done = subprocess.run(cli + [verb, "--url", url, *args], env=env,
                              capture_output=True, text=True, timeout=120)
        commands += 1
        if done.returncode != 0:
            raise AssertionError(f"service CLI: {verb} exited "
                                 f"{done.returncode}: {done.stderr[-2000:]}")
        return json.loads(done.stdout)

    try:
        while not (line := server.stdout.readline()).startswith(
                "pool service on"):
            if not line:
                raise AssertionError(f"service CLI: serve exited "
                                     f"{server.wait()} before listening")
        submitted = run("submit", "--preset", "diurnal", "--jobs", str(jobs),
                        "--seed", str(seed), "--at-trace-times")
        if submitted.get("scheduled") != jobs:
            raise AssertionError(f"service CLI: submit {submitted}")
        deadline = time.perf_counter() + timeout_s
        while not (st := run("status"))["drained"]:
            if time.perf_counter() > deadline:
                raise AssertionError(f"service CLI: not drained in "
                                     f"{timeout_s} s (t={st['t']})")
            time.sleep(2.0)
        if st["completed"] != jobs:
            raise AssertionError(f"service CLI: {st['completed']} of {jobs} "
                                 f"jobs completed")
        saved = run("snapshot", "--path", str(SERVICE_DIR / "cli_snap.json"))
        run("shutdown")
        code = server.wait(timeout=60)
        if code != 0:
            raise AssertionError(f"service CLI: serve exited {code}")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
        server.stdout.close()
    return {"jobs": jobs, "matchmaker": matchmaker, "commands": commands + 1,
            "drained_t": st["t"], "snapshot_t": saved["t"],
            "wall_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 26: parallel/ on a world of ranks that share the card
# ---------------------------------------------------------------------------

#: ranks of phase 26's world, all on card 0 (gloo: NCCL refuses two ranks
#: on one device), and the world's timeout
PARALLEL_RANKS = 8
PARALLEL_TIMEOUT_S = 480.0
#: the parts, at full width: jamba's MoE layer expert-parallel on (4, 2),
#: 1024 tokens a "data" rank; qwen2-1.5b sequence-parallel on (1, 8)
#: (12 heads do not divide 8); qwen2-1.5b's sharded zero3 step on (4, 2);
#: its int8-compressed step on (2, 2, 2) under base.  qwen2 is cut to
#: ``layers`` (its 28 layers would not fit eight ranks and rank 0's
#: one-device reference on the card; the zero3 step at 2, not 4, since
#: phase 28 joined the smoke: the time limit.  SP and int8 stay at 4: at 2
#: the random model's loss passes 1024, where one float32 ulp, 1.2e-4,
#: is above their absolute loss bars of 1e-4 and 1e-5); the zero3 step
#: and the SP loss gate run in float32, the EP layer, the SP gradient and
#: the int8 step in bfloat16
PARALLEL_PLAN = {
    "ep": dict(arch=MOE_ARCH, mesh={"data": 4, "model": 2}, tokens=1024),
    "sp": dict(arch=ARCH, layers=4, mesh={"data": 1, "model": 8}, batch=8,
               seq=512),
    "step": dict(arch=ARCH, layers=2, mesh={"data": 4, "model": 2},
                 steps=3, batch=8, seq=512),
    "int8": dict(arch=ARCH, layers=4, mesh={"pod": 2, "data": 2, "model": 2},
                 batch=8, seq=512),
}
#: phase 27, run in phase 26's world after its parts: elastic training
#: (`run_elastic`) on qwen2-1.5b at full width cut to 2 layers, float32,
#: zero3 over "data" (the rescale at step steps // 2 reshards 4 ranks'
#: state onto 8); serving qwen2-1.5b at full width in bfloat16, cut to
#: ``layers`` (its full depth until phase 28 joined the smoke: the time
#: limit), on {"data": 8} under ``decode`` (a row a rank) and
#: ``decode_sp`` (256 cache slots a rank), with a float32 gate at
#: ``gate_layers`` layers
PARALLEL_PLAN["elastic"] = dict(arch=ARCH, layers=2, steps=4, batch=8,
                                seq=512)
PARALLEL_PLAN["serve_mesh"] = dict(
    arch=ARCH, mesh={"data": 8}, rules=("decode", "decode_sp"), slots=8,
    max_seq=2048, requests=8, prompt=(64, 512), new=16, gate_layers=2,
    layers=8)
#: phase 28, in the same world after phase 27's parts: activation tensor
#: parallelism over "model".  Serving under ``decode`` with phase 27's
#: traffic: qwen2-1.5b at full width in bfloat16 on (data 4, model 2) (6
#: query heads and 1 kv head a rank) and (data 2, model 4) (3 query heads;
#: its 2 kv heads do not divide 4, so the cache's slots are cut over
#: "model"), mamba2-1.3b on (data 2, model 4) (16 of its 64 SSM heads a
#: rank), cut to ``layers`` by arch (their full depth until phase 30
#: joined the smoke: the time limit; a slower host took 102.7 s for the
#: part at full depth, run 31b, 48.8 s in 30b), each with a float32 gate
#: at ``gate_layers`` layers; mamba2-1.3b cut to 2 layers in float32,
#: trained under base on (data 4, model 2), 3 steps of 8 x 512
PARALLEL_PLAN["tp_serve"] = dict(
    runs=[dict(arch=ARCH, mesh={"data": 4, "model": 2}),
          dict(arch=ARCH, mesh={"data": 2, "model": 4}),
          dict(arch=SSD_ARCH, mesh={"data": 2, "model": 4})],
    rules="decode", slots=8, max_seq=2048, requests=8, prompt=(64, 512),
    new=16, gate_layers=2, layers=dict(TRAIN_LAYERS))
PARALLEL_PLAN["tp_train"] = dict(arch=SSD_ARCH, layers=2,
                                 mesh={"data": 4, "model": 2}, rules="base",
                                 steps=3, batch=8, seq=512)
#: phase 30, in the same world after phase 28's parts: a batched prefill
#: (`make_prefill_step(..., batch=8)`) with its rows cut over the mesh, 8
#: prompts of 512 tokens under ``decode``: qwen2-1.5b at full width cut to
#: 8 layers (as phase 27's serving) on {"data": 8} (a row a rank) and on
#: (data 4, model 2) (2 rows, 6 query heads and 1 kv head a rank),
#: mamba2-1.3b at `TRAIN_LAYERS`' 16 layers on (data 2, model 4) (4 rows,
#: 16 of 64 SSM heads); jamba-v0.1-52b under ``ep`` on (data 4, model 2)
#: (2 rows and 4 of 16 experts a rank, half of each expert's FF columns),
#: cut to the fewest layers that hold one MoE layer: its period is 8 (a
#: cut keeps whole periods) and one period holds four MoE layers (22.5 GB
#: of bfloat16 experts, 45 GB in float32 on rank 0 alone), so the cut
#: takes attention every second layer (``attn_every`` 2) and 2 layers: a
#: Mamba layer with its dense FFN, an attention layer with the MoE layer
#: (14.7 GB in float32 on rank 0, 3.1 GB a rank: each keeps its own
#: experts), at a capacity that drops nothing (`dispatch_demand`).  A
#: float32 gate at ``gate_layers`` layers for each (jamba's 2 are its cut)
PARALLEL_PLAN["prefill_rows"] = dict(
    runs=[dict(arch=ARCH, mesh={"data": 8}, rules="decode", layers=8),
          dict(arch=ARCH, mesh={"data": 4, "model": 2}, rules="decode",
               layers=8),
          dict(arch=SSD_ARCH, mesh={"data": 2, "model": 4}, rules="decode",
               layers=TRAIN_LAYERS[SSD_ARCH]),
          dict(arch=MOE_ARCH, mesh={"data": 4, "model": 2}, rules="ep",
               layers=2, changes=dict(attn_every=2))],
    batch=8, seq=512, gate_layers=2)
#: phase 27 at small size (tests/test_torch_cuda.py): the reduced qwen2,
#: head dim 32
MESH_PLAN_SMALL = {
    "elastic": dict(PARALLEL_PLAN["elastic"], reduced=True, seq=32,
                    changes=dict(d_head=32)),
    "serve_mesh": dict(PARALLEL_PLAN["serve_mesh"], reduced=True,
                       changes=dict(d_head=32), max_seq=64, prompt=(8, 24),
                       new=4, layers=None),
}
#: phase 28 at small size (tests/test_torch_cuda.py): the reduced qwen2
#: (4 heads, 2 kv heads) and mamba2 (8 SSM heads), head dim 32
TP_PLAN_SMALL = {
    "tp_serve": dict(PARALLEL_PLAN["tp_serve"], reduced=True,
                     changes=dict(d_head=32), max_seq=64, prompt=(8, 24),
                     new=4, layers={}),
    "tp_train": dict(PARALLEL_PLAN["tp_train"], reduced=True, seq=32),
}
#: phase 30 at small size (tests/test_torch_cuda.py): the reduced configs
#: (qwen2 4 heads and 2 kv heads, mamba2 8 SSM heads, jamba 4 experts),
#: head dim 32, 32 tokens a prompt
ROWS_PLAN_SMALL = {"prefill_rows": dict(
    PARALLEL_PLAN["prefill_rows"], reduced=True, seq=32, runs=[
        dict(run, layers=2, changes=dict(run.get("changes", {}), d_head=32))
        for run in PARALLEL_PLAN["prefill_rows"]["runs"]])}
#: phase 26 at small size (tests/test_torch_cuda.py): the reduced
#: configs, head dim 32 (flash takes 32, 64 and 128)
PARALLEL_PLAN_SMALL = {
    "ep": dict(PARALLEL_PLAN["ep"], reduced=True, tokens=64),
    "sp": dict(PARALLEL_PLAN["sp"], reduced=True, layers=2, seq=64,
               changes=dict(d_head=32)),
    "step": dict(PARALLEL_PLAN["step"], reduced=True, layers=2, seq=32,
                 changes=dict(d_head=32)),
    "int8": dict(PARALLEL_PLAN["int8"], reduced=True, layers=2, seq=32,
                 changes=dict(d_head=32)),
}
#: the reference's bars (tests/test_multidevice.py) and the training
#: gates' bfloat16 bar
GATE_EP_F32 = 1e-4
GATE_EP_AUX = 0.1
GATE_SP_LOSS = 1e-4
#: bfloat16 SP's loss against one device, absolute: a rank's eighth of
#: the queries may take another flash instance than the whole sequence
#: (at the small size "split" against "simt"); a few times the largest
#: reading, 3.0e-4 at the small size (run 27e; 0 at full width, where both
#: take "wgmma")
GATE_SP_BF16_LOSS = 1e-3
GATE_STEP_LOSS, GATE_STEP_PARAMS = 1e-4, 2e-2
GATE_INT8_LOSS, GATE_INT8_PARAMS = 1e-5, 5e-2
#: the int8 step's reduced gradient against the exact step's, in units of
#: the compressed mean's quantum amax/127 (below 1 in exact arithmetic;
#: the rest is float32 rounding), the pods' mean against the exact step's
#: (the same gradients summed in another order), and the quantum against
#: the gradient's max: under 1/2, a zero, sign-flipped or un-averaged
#: gradient would fail the first bar
GATE_INT8_GRAD, GATE_INT8_PODS, GATE_INT8_QUANTUM = 1.0 + 1e-3, 1e-2, 0.5
#: SP's tied embedding (qwen2 ties its input and output embeddings)
SP_TIED_LEAF = "embed/table"
#: phase 27's bars: the elastic run's losses against one device (phase
#: 26's step bar, relative), its final parameters against one device's
#: as a share of how far the one-device run moved them (the four steps'
#: lr is 0 to 3e-4, so an absolute bar would sit above any fault;
#: `elastic_one_device` plants one, moments zeroed at the rescale, that
#: reads 0.87-0.90; sound runs read 1.6e-3 at full width and 1.5e-2 at
#: the small size on the H100: float32 summation order, which AdamW's
#: normalised step can enlarge where a gradient is near zero), the meshed
#: bfloat16 engine's first tick's logits against the one-device
#: engine's (phase 7's bar; `serve_mesh_part` plants a dropped cache part
#: that must read above it)
GATE_ELASTIC_LOSS = GATE_STEP_LOSS
GATE_ELASTIC_PARAMS_SHARE = 0.1
GATE_SERVE_MESH_BF16 = GATE_BF16
#: phase 28's bars: the float32 engines' first tick against one device's,
#: relative (phase 6's), the bfloat16 engines' (phase 7's), the training
#: losses (relative) and parameters as a share of the one-device run's
#: change (phase 27's); a partial dropped from the row-parallel sums must
#: read above the bfloat16 and the loss bars
GATE_TP_F32, GATE_TP_BF16 = GATE_F32, GATE_BF16
GATE_TP_LOSS, GATE_TP_PARAMS_SHARE = GATE_STEP_LOSS, GATE_ELASTIC_PARAMS_SHARE
PARALLEL_KERNELS = ("flash_attention", "flash_attention_bwd", "gmm",
                    "gmm_bwd", "ssd", "ssd_bwd")


def parallel_config(part: dict, dtype: str):
    """A part's config: the arch at full width (``reduced`` takes the
    reduced one, ``changes`` are applied), cut to ``layers``, in
    ``dtype``."""
    from repro_torch.configs import get_config, reduced_config
    cfg = (reduced_config if part.get("reduced") else get_config)(
        part["arch"])
    cfg = dataclasses.replace(cfg, param_dtype=dtype, activation_dtype=dtype,
                              **part.get("changes", {}))
    if part.get("layers"):
        cfg = cut_layers(cfg, part["layers"])
    return cfg


class PartClock:
    """A part's wall time, its main path's, and its main path's launches
    (the counts set to 0 just before it, read just after)."""

    def __init__(self, dev):
        from repro_torch.kernels.build import launch_counts
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.moe_gmm import ops as gm
        from repro_torch.kernels.ssd import ops as so
        self.dev, self.counts = dev, launch_counts
        self.routes = {"flash_attention": fa.route_counts,
                       "flash_attention_bwd": fa.bwd_route_counts,
                       "gmm": gm.route_counts, "gmm_bwd": gm.bwd_route_counts,
                       "ssd": so.route_counts, "ssd_bwd": so.bwd_route_counts}
        self.t0 = time.perf_counter()
        self.main_s = 0.0
        self.launches = {k: 0 for k in PARALLEL_KERNELS}
        self.by_instance = {k: {} for k in PARALLEL_KERNELS}

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def main_path(self):
        self._sync()
        for k in self.counts:
            self.counts[k] = 0
        routes = {k: dict(v) for k, v in self.routes.items()}
        t0 = time.perf_counter()
        yield
        self._sync()
        self.main_s += time.perf_counter() - t0
        for k in PARALLEL_KERNELS:
            self.launches[k] += self.counts[k]
            for inst, n in self.routes[k].items():
                d = n - routes[k].get(inst, 0)
                if d:
                    self.by_instance[k][inst] = \
                        self.by_instance[k].get(inst, 0) + d

    def row(self, **extra) -> dict:
        self._sync()
        return {"wall_s": time.perf_counter() - self.t0,
                "main_s": self.main_s, "launches": self.launches,
                "by_instance": self.by_instance, **extra}


def elastic_schedule(steps: int, ranks: int) -> list:
    """The rescales the control plane gives `run_elastic` on a pool of
    ``ranks`` (the reference's demand schedule, as its run on the CPU
    prints it; tests/test_torch_elastic.py holds the port's lines to the
    reference's): (step, from, to, claimed)."""
    return [(0, 0, ranks // 2, ranks // 2),
            (steps // 2, ranks // 2, ranks, ranks)]


def parallel_launches(plan: dict, rank: int = 0,
                      ranks: int = PARALLEL_RANKS) -> dict:
    """Each part's launches on a rank's main path, from the shapes: EP
    three gmm forwards and three backwards; SP one flash forward and one
    backward per layer; each step the same per layer and step (elastic:
    the steps the rank's meshes ran); serving one flash forward per
    layer, each prefill (every rank computes it whole) and each tick;
    phase 28's serving the same for qwen2 at the rank's heads and one
    SSD launch per layer and prefill for mamba2 (none at a tick), its
    training one SSD forward and one backward per layer and step; phase
    30's cut prefills as `prefill_rows_expected` counts them."""
    none = {k: 0 for k in PARALLEL_KERNELS}
    per_layer = dict(none, flash_attention=1, flash_attention_bwd=1)
    steps = {"sp": 1, "step": plan.get("step", {}).get("steps"), "int8": 2}
    if "elastic" in plan:
        e = plan["elastic"]
        first = elastic_schedule(e["steps"], ranks)[0][2]
        steps["elastic"] = (e["steps"] if rank < first
                            else e["steps"] - e["steps"] // 2)
    out = {}
    for name in plan:
        if name == "ep":
            out[name] = dict(none, gmm=3, gmm_bwd=3)
        elif name == "tp_serve":
            part, out[name] = plan[name], dict(none)
            for run in part["runs"]:
                cfg = parallel_config(dict(
                    part, **run, layers=part["layers"].get(run["arch"])),
                    "float32")
                if cfg.ssm is not None:     # mamba2: an SSD launch a layer
                    out[name]["ssd"] += part["requests"] * cfg.n_layers
                else:                       # one flash launch a layer
                    out[name]["flash_attention"] += cfg.n_layers * (
                        part["requests"] + part["new"] - 1)
        elif name == "tp_train":
            n = plan[name]["layers"] * plan[name]["steps"]
            out[name] = dict(none, ssd=n, ssd_bwd=n)
        elif name == "prefill_rows":
            out[name] = dict(none)
            for _, by in prefill_rows_expected(plan):
                for kernel, insts in by.items():
                    out[name][kernel] += sum(insts.values())
        elif name == "serve_mesh":
            part = plan[name]
            calls = part["requests"] + part["new"] - 1
            out[name] = dict(none, flash_attention=len(part["rules"]) * calls
                             * parallel_config(part, "float32").n_layers)
        else:
            out[name] = {k: v * plan[name]["layers"] * steps[name]
                         for k, v in per_layer.items()}
    return out


def _ep_router(cfg, dev):
    from repro_torch.models.param import Init
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    return Init(gen, dev).dense((cfg.d_model, cfg.moe.n_experts), "float32")


def _ep_weights(cfg, dev, experts, mesh=None):
    """The MoE layer's weights from fixed seeds: the router whole, the
    experts in ``experts`` (one generator an expert, so every rank draws
    the same expert), cut to this rank's part of the FF dim under
    ``mesh``."""
    from repro_torch.models.param import Init
    from repro_torch.parallel import collectives as coll
    d, f, dt = cfg.d_model, cfg.moe.d_ff_expert, cfg.param_dtype
    gen = torch.Generator(device=dev)
    p = {"router": _ep_router(cfg, dev)}
    for name, shape, f_dim in (("gate", (d, f), 1), ("up", (d, f), 1),
                               ("down", (f, d), 0)):
        ws = []
        for e in experts:
            gen.manual_seed(1000 * (1 + ("gate", "up", "down").index(name))
                            + e)
            w = Init(gen, dev).dense(shape, dt, fan_in=shape[0])
            if mesh is not None:
                w = coll.own_slice(w, mesh, "model", f_dim).contiguous()
            ws.append(w)
        p[name] = torch.stack(ws)
    return p


def _ep_tokens(cfg, dev, data_index, tokens, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(100 + data_index)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev)
    dy = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev)
    return x.to(dtype), dy


def ep_no_drop_capacity(cfg, mesh, x):
    """(capacity factor of EP, of the dense dispatch over the gathered
    tokens) at which neither drops an assignment: C_send holds the most
    assignments a rank sends one rank, cap_e the most an expert receives,
    the dense C the most an expert gets of all the tokens."""
    m = cfg.moe
    dsz = mesh.shape["data"]
    T = x.shape[0] * x.shape[1]
    A = T * m.top_k
    p_router = _ep_router(cfg, x.device)
    idx = torch.topk(torch.softmax(x.reshape(T, -1).float() @ p_router, -1),
                     m.top_k, dim=-1).indices.reshape(-1)
    per_expert = torch.bincount(idx, minlength=m.n_experts).to(torch.int32)
    cf, most = ep_factor(per_expert, A, mesh)
    dense_cf = most * m.n_experts / (dsz * A)
    return cf * 1.0001, dense_cf * 1.0001


def ep_factor(per_expert, A, mesh, data_axis="data") -> tuple[float, int]:
    """(the least capacity factor at which expert parallelism drops none
    of a rank's ``A`` assignments, ``per_expert`` of them to each expert,
    the most assignments an expert gets from the "data" group): C_send
    must hold the most a rank sends one rank, cap_e the most an expert
    receives (collective over the mesh)."""
    from repro_torch.parallel import collectives as coll
    dsz = mesh.shape[data_axis]
    E_loc = per_expert.numel() // dsz
    per_dst = per_expert.reshape(dsz, E_loc).sum(1)
    most_sent = int(coll.pmax(per_dst.max(), mesh, mesh.axis_names))
    # assignments an expert gets from the "data" group (the pod's tokens)
    totals = coll.psum(per_expert, mesh, data_axis)
    most = int(coll.pmax(totals.max(), mesh, mesh.axis_names))
    cf = most_sent * dsz / A
    while math.ceil(dsz * math.ceil(A * cf / dsz) * cf / E_loc) < most:
        cf *= 1.05
    return cf, most


def ep_part(rank, dev, plan, clock):
    """jamba's MoE layer on (4, 2), expert-parallel, forward and backward
    in bfloat16, then forward in float32; rank 0 holds it against the
    one-device dense dispatch over the gathered tokens with the same
    weights."""
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import collectives as coll
    part = plan["ep"]
    mesh = WorkerMesh(part["mesh"], dev)
    di, dsz = mesh.coord["data"], mesh.shape["data"]
    rep = mesh.shape["model"]
    names = ("router", "gate", "up", "down")
    row = {}
    for dtype in ("bfloat16", "float32"):
        cfg = parallel_config(part, dtype)
        E_loc = cfg.moe.n_experts // dsz
        x, dy = _ep_tokens(cfg, dev, di, part["tokens"],
                           getattr(torch, dtype))
        cf, dense_cf = ep_no_drop_capacity(cfg, mesh, x)
        ep_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        p = _ep_weights(cfg, dev, range(di * E_loc, (di + 1) * E_loc), mesh)
        train = dtype == "bfloat16"
        leaves = [x.detach().requires_grad_(train)] + [
            p[k].detach().requires_grad_(train) for k in names]
        q = dict(zip(names, leaves[1:]))
        with clock.main_path() if train else contextlib.nullcontext():
            y, aux = moe_mod.moe_forward_ep(q, ep_cfg, leaves[0], mesh)
            if train:
                # sum(y * dy), each "model" replica's share: aux's
                # gradient (a mean of per-rank estimates here, one
                # estimate on the dense side) is left out of the check
                obj = (y.float() * dy).sum() / rep
                grads = torch.autograd.grad(obj, leaves)
        y_all = coll.all_gather(y.detach(), mesh, "data", 0)
        dy_all = coll.all_gather(dy, mesh, "data", 0)
        x_all = coll.all_gather(x, mesh, "data", 0)
        if train:
            dx_all = coll.all_gather(coll.psum(grads[0], mesh, "model"),
                                     mesh, "data", 0)
            d_router = coll.psum(grads[1].float(), mesh, mesh.axis_names)
            # each expert leaf's gradient norm over every rank's shard
            sq = torch.stack([g.float().square().sum() for g in grads[2:]])
            norms = coll.psum(sq, mesh, mesh.axis_names).sqrt()
            mine = [g.detach() for g in grads[2:]]
        del p, q, leaves, y
        if rank == 0:
            dense_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=dense_cf))
            P = _ep_weights(cfg, dev, range(cfg.moe.n_experts))
            if train:
                L = {k: P[k].detach().requires_grad_() for k in names}
                X = x_all.detach().requires_grad_()
                Y, AUX = moe_mod.moe_forward_dense(L, dense_cfg, X)
                G = torch.autograd.grad((Y.float() * dy_all).sum(), [X] +
                                        [L[k] for k in names])
                row["y_bf16"] = rel_err(y_all, Y)
                row["dx"] = rel_err(dx_all, G[0])
                row["drouter"] = rel_err(d_router, G[1])
                row["aux"] = abs(float(aux) - float(AUX))
                f_loc = cfg.moe.d_ff_expert // rep
                for k, g_ep, g_ref, norm in zip(names[1:], mine, G[2:],
                                                norms):
                    own = g_ref[:E_loc]
                    own = (own[:, :f_loc] if k == "down"
                           else own[:, :, :f_loc])
                    row[f"d{k}_rank0_shard"] = rel_err(g_ep, own)
                    row[f"d{k}_norm"] = abs(float(norm) - float(
                        g_ref.float().norm())) / float(g_ref.float().norm())
                del L, X, Y, G
            else:
                with torch.no_grad():
                    Y, _ = moe_mod.moe_forward_dense(P, dense_cfg, x_all)
                row["y_f32"] = rel_err(y_all, Y)
            del P
        if train:
            del grads, mine
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        row[f"capacity_factor_{dtype}"] = cf
    return row


def ep_gates(row):
    gate("EP jamba MoE layer f32: y, EP (4, 2) vs dense", row["y_f32"],
         GATE_EP_F32)
    gate("EP jamba MoE layer bf16: y", row["y_bf16"], GATE_TRAIN_BF16_GRAD)
    gate("EP jamba MoE layer bf16: aux", row["aux"], GATE_EP_AUX)
    gate("EP jamba MoE layer bf16: dx", row["dx"], GATE_TRAIN_BF16_GRAD)
    gate("EP jamba MoE layer bf16: drouter", row["drouter"],
         GATE_TRAIN_BF16_GRAD)
    for k in ("gate", "up", "down"):
        for what in ("rank0_shard", "norm"):
            gate(f"EP jamba MoE layer bf16: d{k} {what}",
                 row[f"d{k}_{what}"], GATE_TRAIN_BF16_GRAD)


def _same_params(cfg, dev, mesh):
    from repro_torch.models import model as model_lib
    from repro_torch.parallel.collectives import assert_replicated
    params = model_lib.init_model(cfg, seed=0, device=dev)
    assert_replicated(params, mesh, f"{cfg.name}'s drawn weights")
    return params


def _pipeline_batch(cfg, part, step, dev):
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    pipe = SyntheticTokenPipeline(cfg.vocab_size, part["seq"], part["batch"],
                                  seed=1)
    return pipe.torch_batch_at(step, dev)


def sp_part(rank, dev, plan, clock):
    """qwen2 on (1, 8), attention sequence-parallel: loss_fn and its
    gradient in float32 (the gates), then in bfloat16 (the main path);
    rank 0 holds both against its one-device loss_fn on the whole batch,
    the gradient leaf by leaf."""
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import model as model_lib
    from repro_torch.models.attention import _use_sp
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import constrainer, rules_for
    part = plan["sp"]
    mesh = WorkerMesh(part["mesh"], dev)
    row = {}
    for dtype in ("float32", "bfloat16"):
        cfg = parallel_config(part, dtype)
        if not _use_sp(cfg, mesh, part["seq"], part["seq"], part["batch"],
                       False):
            raise AssertionError(f"SP: {cfg.n_heads} heads on {mesh.shape} "
                                 f"do not route sequence-parallel")
        params = _same_params(cfg, dev, mesh)
        names = [name for name, _ in state_items(params)]
        batch = _pipeline_batch(cfg, part, 0, dev)
        c = constrainer(rules_for(cfg, "train"), mesh)
        req = tree_map(lambda t: t.detach().requires_grad_(), params)
        main = dtype == "bfloat16"
        with clock.main_path() if main else contextlib.nullcontext():
            loss, _ = model_lib.loss_fn(req, cfg, batch, mesh=mesh,
                                        constrain=c, remat="none")
            grads = torch.autograd.grad(loss, tree_leaves(req))
        # the whole gradient: the ranks' shares summed in float32
        grads = [coll.psum(g.float(), mesh, mesh.axis_names) for g in grads]
        del req
        if rank == 0:
            ref_loss, ref_grads = loss_and_grads(model_lib, params, cfg,
                                                 batch)
            row[f"loss_{dtype}"] = abs(float(loss) - float(ref_loss))
            errs = leaf_errors(cfg, names, grads, ref_grads)
            row[f"grad_{dtype}"] = max(errs.values())
            row[f"worst_leaves_{dtype}"] = dict(sorted(
                errs.items(), key=lambda kv: -kv[1])[:3])
            # every leaf but the tied embedding on max |diff| / max |g|;
            # the tied embedding on |diff| / |g| (sp_gates)
            row[f"grad_untied_{dtype}"] = max(
                v for k, v in errs.items() if k != SP_TIED_LEAF)
            a, b = grads[names.index(SP_TIED_LEAF)], \
                ref_grads[names.index(SP_TIED_LEAF)].float()
            row[f"grad_tied_norm_{dtype}"] = float((a - b).norm() /
                                                   b.norm())
            del ref_grads
        del params, grads
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    return row


def sp_gates(row):
    gate("SP qwen2 f32 (1, 8): loss vs one device", row["loss_float32"],
         GATE_SP_LOSS)
    gate("SP qwen2 f32 (1, 8): gradient vs one device, each leaf",
         row["grad_float32"], GATE_TRAIN_GRAD)
    gate("SP qwen2 bf16 (1, 8): loss vs one device", row["loss_bfloat16"],
         GATE_SP_BF16_LOSS)
    gate("SP qwen2 bf16 (1, 8): gradient vs one device, each leaf but the "
         "tied embedding", row["grad_untied_bfloat16"], GATE_TRAIN_BF16_GRAD)
    # in bfloat16 each rank rounds its rows' share of a leaf's gradient
    # before the float32 sum, where one device rounds the whole sum once:
    # the tied embedding's largest entries are sums that cancel, so its
    # max |diff| / max |g| reads 3.7e-2 at full width (27e, 27g); it is
    # held on |diff| / |g| over the leaf (1.3e-2 there), and the float32
    # run above on every element
    gate("SP qwen2 bf16 (1, 8): tied embedding's gradient vs one device, "
         "|diff| / |g|", row["grad_tied_norm_bfloat16"],
         GATE_TRAIN_BF16_GRAD)


def step_part(rank, dev, plan, clock):
    """qwen2 in float32, zero3 on (4, 2): ``steps`` sharded steps; rank 0
    runs the one-device `make_train_step` on the same weights and
    batches."""
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.parallel.collectives import unshard
    from repro_torch.train.train_step import (
        init_train_state, make_train_step, param_specs, shard_params)
    part = plan["step"]
    mesh = WorkerMesh(part["mesh"], dev)
    cfg = parallel_config(part, "float32")
    rules = rules_for(cfg, "train")
    opt = OptimizerConfig(lr=1e-3)
    lr_kwargs = dict(peak=1e-3, warmup_steps=0, total_steps=10)
    params = _same_params(cfg, dev, mesh)
    specs = param_specs(cfg, rules, mesh)
    state = init_train_state(shard_params(params, specs, mesh), opt)
    if rank != 0:                   # rank 0 keeps them for its reference
        del params
    step = make_train_step(cfg, opt, mesh, rules, remat="none",
                           lr_kwargs=lr_kwargs)
    losses = []
    batches = [_pipeline_batch(cfg, part, i, dev)
               for i in range(part["steps"])]
    with clock.main_path():
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    whole = tree_map(lambda t, s: unshard(t, s, mesh), state.params, specs)
    del state
    row = {"rules": rules.name, "losses": losses}
    if rank == 0:
        one = make_train_step(cfg, opt, remat="none", lr_kwargs=lr_kwargs,
                              device=dev)
        ref = init_train_state(params, opt)
        for i, b in enumerate(batches):
            ref, m = one(ref, b)
            # relative: the random full-width model starts at a loss of
            # ~1275 (its z-loss), where a float32 ulp is 1.2e-4
            row.setdefault("loss", []).append(abs(
                losses[i] - float(m["loss"])) / max(1.0, abs(float(
                    m["loss"]))))
        row["params"] = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(whole), tree_leaves(ref.params)))
        del ref, one, params
    del whole
    return row


def step_gates(row):
    gate("sharded step qwen2 f32 zero3 (4, 2): loss vs one device, "
         "relative", max(row["loss"]), GATE_STEP_LOSS)
    gate("sharded step qwen2 f32 zero3 (4, 2): parameters vs one device",
         row["params"], GATE_STEP_PARAMS)


def _pod_quanta(cfg, rules, mesh, specs, batch, dev) -> list:
    """Each of this rank's gradient shards' quantum under the int8 step's
    compressed mean over "pod": amax/127, amax the shard's largest |g|
    over the pods.  The pods' gradients are formed as the int8 step forms
    them before its mean (each pod's loss a mean over its own rows, the
    ranks' shares summed over "data", and over "model" where the rules
    keep activations uncut over it).  Returns [(quantum,
    the pods' mean of the shard)]."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import (
        constrainer, model_cut, split_model)
    inner = tuple(a for a in mesh.axis_names if a != "pod")
    # under the "model" cut a "model" group computes one share of the
    # loss, and each rank's gradient is its part of a cut leaf
    tp = model_cut(rules, mesh)
    shares = tuple(a for a in inner if a != "model" or tp == 1)
    params = tree_map(lambda t: t.requires_grad_(), model_lib.model_part(
        _same_params(cfg, dev, mesh), cfg, rules, mesh))
    loss, _ = model_lib.loss_fn(params, cfg, batch, mesh=mesh,
                                constrain=constrainer(rules, mesh),
                                remat="none", mean_axes=inner)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    del params, loss
    out = []
    for g, spec in zip(grads, tree_leaves(specs)):
        pod = coll.shard_of(coll.psum(g.float(), mesh, shares),
                            split_model(spec)[1] if tp > 1 else spec, mesh)
        amax = coll.pmax(pod.abs().max(), mesh, "pod")
        mean = coll.psum(pod, mesh, "pod") / mesh.shape["pod"]
        out.append((float(amax) / 127.0, mean.cpu()))
    return out


def int8_part(rank, dev, plan, clock):
    """qwen2 in bfloat16 on (2, 2, 2) under base: the exact and the
    int8-compressed sharded step from the same state.  Each rank holds
    the gradient the int8 step reduced (read from AdamW's first moment)
    against the exact step's, shard by shard, in units of the compressed
    mean's quantum (`_pod_quanta`, outside the main path), and the
    parameters; then the compressed mean's bound and bits on a drawn
    tensor."""
    import hashlib
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models.param import tree_leaves
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import preset
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (
        init_train_state, make_train_step, param_specs, shard_params)
    part = plan["int8"]
    mesh = WorkerMesh(part["mesh"], dev)
    cfg = parallel_config(part, "bfloat16")
    rules = preset("base")
    opt = OptimizerConfig(lr=1e-3)
    lr_kwargs = dict(peak=1e-3, warmup_steps=0, total_steps=10)
    specs = param_specs(cfg, rules, mesh)
    batch = _pipeline_batch(cfg, part, 0, dev)
    row, after, grads = {}, {}, {}
    with clock.main_path():
        for name, comp in (("exact", None), ("int8", "int8")):
            # each state from the seed's weights again, and the updated
            # shards kept in host memory: eight ranks share the card
            state = init_train_state(shard_params(
                _same_params(cfg, dev, mesh), specs, mesh), opt)
            step = make_train_step(cfg, opt, mesh, rules, remat="none",
                                   grad_compression=comp,
                                   lr_kwargs=lr_kwargs)
            state, m = step(state, batch)
            row[f"loss_{name}"] = float(m["loss"])
            row[f"grad_norm_{name}"] = float(m["grad_norm"])
            after[name] = [t.detach().cpu() for t in
                           tree_leaves(state.params)]
            # AdamW's first step stores (1 - b1) x clip_factor x g
            scale = (1.0 - opt.b1) * float(m["clip_factor"])
            grads[name] = [(mu.float() / scale).cpu()
                           for mu in tree_leaves(state.opt["mu"])]
            del state, step
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    for name in after:
        digest = hashlib.sha256()
        for t in after[name]:
            digest.update(t.float().numpy().tobytes())
        row[f"digest_{name}"] = digest.hexdigest()
    # the parameters' largest difference, over every rank's shards
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(after["exact"], after["int8"]))
    row["params"] = float(coll.pmax(torch.tensor(diff, device=dev), mesh,
                                    mesh.axis_names))
    row["loss"] = abs(row["loss_exact"] - row["loss_int8"])
    # the reduced gradients, in units of each shard's quantum; the
    # squared norm of the quanta, each element counted once
    quanta = _pod_quanta(cfg, rules, mesh, specs, batch, dev)
    err, pods, q_max, g_max, bound_sq = [], [], [], [], 0.0
    for a, b, (q, mean), spec in zip(grads["int8"], grads["exact"], quanta,
                                     tree_leaves(specs)):
        d, dp = float((a - b).abs().max()), float((mean - b).abs().max())
        err.append(d / q if q > 0 else (0.0 if d == 0 else math.inf))
        pods.append(dp / q if q > 0 else (0.0 if dp == 0 else math.inf))
        q_max.append(q)
        g_max.append(float(b.abs().max()))
        bound_sq += b.numel() * q * q / coll.replication(spec, mesh)
    worst = coll.pmax(torch.tensor([max(err), max(pods)], device=dev),
                      mesh, mesh.axis_names)
    row["grad_over_quantum"], row["pods_over_quantum"] = map(float, worst)
    # each leaf's largest quantum over its largest |g|, over the shards
    qg = coll.pmax(torch.tensor([q_max, g_max], device=dev), mesh,
                   mesh.axis_names)
    row["quantum_over_gmax"] = float((qg[0] / qg[1]).max())
    bound = float(coll.psum(torch.tensor(bound_sq, device=dev), mesh,
                            mesh.axis_names).sqrt())
    row["grad_norm_over_bound"] = abs(
        row["grad_norm_int8"] - row["grad_norm_exact"]) / bound
    del grads, quanta
    # the compressed mean on a drawn tensor: its error and its bits
    gen = torch.Generator(device=dev)
    gen.manual_seed(rank)
    g = torch.randn((4096, 1024), generator=gen, device=dev)
    mean = coll.compressed_psum(g, mesh, ("pod",), coll.rng_seed(17, 0))
    exact = coll.psum(g, mesh, "pod") / mesh.shape["pod"]
    amax = coll.pmax(g.abs().max(), mesh, "pod")
    row["psum_err_over_step"] = float((mean - exact).abs().max() /
                                      (amax / 127.0))
    row["psum_digest"] = hashlib.sha256(
        mean.cpu().numpy().tobytes()).hexdigest()
    row["coord"] = dict(mesh.coord)
    return row


def int8_gates(rows):
    r0 = rows[0]["int8"]
    gate("int8 step qwen2 bf16 base (2, 2, 2): loss vs exact", r0["loss"],
         GATE_INT8_LOSS)
    gate("int8 step qwen2 bf16 base (2, 2, 2): parameters vs exact",
         r0["params"], GATE_INT8_PARAMS)
    # the loss is taken before the update and AdamW's first step moves
    # each parameter by about lr whatever the gradient, so the gradient
    # the step reduced is held too: against the exact step's, shard by
    # shard, in units of the compressed mean's quantum amax/127
    gate("int8 step qwen2 bf16 base (2, 2, 2): reduced gradient vs exact / "
         "(amax/127)", r0["grad_over_quantum"], GATE_INT8_GRAD)
    gate("int8 step qwen2 bf16 base (2, 2, 2): the pods' mean gradient vs "
         "exact / (amax/127)", r0["pods_over_quantum"], GATE_INT8_PODS)
    gate("int8 step qwen2 bf16 base (2, 2, 2): amax/127 / max |g|, each leaf",
         r0["quantum_over_gmax"], GATE_INT8_QUANTUM)
    gate("int8 step qwen2 bf16 base (2, 2, 2): |grad_norm - exact's| / the "
         "quanta's norm", r0["grad_norm_over_bound"], GATE_INT8_GRAD)
    # the bound amax/127, and the float32 rounding of the two means
    gate("int8 compressed mean: max error / (amax/127)",
         max(r["int8"]["psum_err_over_step"] for r in rows), 1.0 + 1e-5)
    for key in ("digest_int8", "psum_digest"):
        groups = {}
        for r in rows:
            c = r["int8"]["coord"]
            groups.setdefault((c["data"], c["model"]), set()).add(
                r["int8"][key])
        if any(len(v) != 1 for v in groups.values()):
            raise AssertionError(f"int8: {key} differs within a pod group")


def _printed(fn, *args, **kwargs):
    """(fn's result, the lines it printed)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def elastic_part(rank, dev, plan, clock):
    """Phase 27 (a): `run_elastic` on the world (the control plane on
    rank 0, zero3 meshes of the claimed ranks, the rescale's save from 4
    ranks and restore onto 8).  Rank 0 leaves the final parameters beside
    the run's checkpoints for `elastic_one_device` (a one-device
    `run_fixed` cannot run inside the world)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel.collectives import unshard
    part = plan["elastic"]
    cfg = parallel_config(part, "float32")
    events, step_s = [], []

    def on_rescale(event):
        events.append(event)

    def on_step(i, state, metrics, seconds):
        step_s.append({"step": i, "workers": events[-1]["to"],
                       "s": seconds})
        if i == part["steps"] - 1:
            mesh, specs = events[-1]["mesh"], events[-1]["specs"]
            whole = tree_map(lambda t, s: unshard(t, s, mesh), state.params,
                             specs)
            if rank == 0:
                torch.save([t.cpu() for t in tree_leaves(whole)],
                           Path(part["ckpt_dir"]) / "final_params.pt")
            del whole

    with clock.main_path():
        losses, printed = _printed(
            launch_train.run_elastic, cfg, steps=part["steps"],
            batch=part["batch"], seq=part["seq"],
            ckpt_dir=part["ckpt_dir"], log_every=1, device=dev,
            on_step=on_step, on_rescale=on_rescale)
    return {"losses": losses, "step_s": step_s,
            "rescales": [{k: e[k] for k in ("step", "from", "to", "claimed",
                                            "save_s", "restore_s")}
                         for e in events],
            "printed": [line for line in printed
                        if line.startswith("[elastic]")]}


def _one_device_run(cfg, part, device, zero_moments_at=None) -> dict:
    """A one-device `run_fixed` of the elastic part's steps: its losses,
    step seconds and final parameters (on the host).  With
    ``zero_moments_at`` AdamW's moments are zeroed before that step: the
    planted fault of a rescale that restored them as zeros."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models.param import tree_leaves
    one = {"step_s": []}

    def on_step(i, state, metrics, seconds):
        one["step_s"].append(seconds)
        if zero_moments_at is not None and i == zero_moments_at - 1:
            for t in (tree_leaves(state.opt["mu"])
                      + tree_leaves(state.opt["nu"])):
                t.zero_()
        if i == part["steps"] - 1:
            one["params"] = [t.detach().cpu()
                             for t in tree_leaves(state.params)]

    one["losses"] = launch_train.run_fixed(
        cfg, steps=part["steps"], batch=part["batch"], seq=part["seq"],
        ckpt_dir=None, device=device, log_every=1, on_step=on_step)
    return one


def _max_diff(a: list, b: list) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def elastic_one_device(rows, plan, device) -> dict:
    """The one-device `run_fixed` of the elastic part's steps (in this
    process, outside the world), against the elastic run: each logged
    loss relative to itself, and the final parameters' largest
    difference as a share of the largest change the one-device run made
    to them (from the seed's draw); the same share for a one-device run
    with the moments zeroed at the rescale's step (a planted fault the
    gate must fail)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import tree_leaves
    part = plan["elastic"]
    cfg = parallel_config(part, "float32")
    t0 = time.perf_counter()
    one = _one_device_run(cfg, part, device)
    wall = time.perf_counter() - t0
    fault = _one_device_run(cfg, part, device,
                            zero_moments_at=part["steps"] // 2)
    init = [t.cpu() for t in tree_leaves(
        model_lib.init_model(cfg, seed=0, device=device))]
    final = torch.load(Path(part["ckpt_dir"]) / "final_params.pt")
    losses = rows[0]["elastic"]["losses"]
    change = _max_diff(one["params"], init)
    # relative: the random full-width model starts at a loss of ~1275
    out = {"one_device_losses": one["losses"],
           "one_device_step_s": one["step_s"], "one_device_wall_s": wall,
           "loss": max(abs(a - b) / max(1.0, abs(b))
                       for a, b in zip(losses, one["losses"])),
           "params": _max_diff(final, one["params"]),
           "params_change": change,
           "fault_params": _max_diff(fault["params"], one["params"]),
           "fault_loss": max(abs(a - b) / max(1.0, abs(b))
                             for a, b in zip(fault["losses"],
                                             one["losses"]))}
    out["params_share"] = out["params"] / change
    out["fault_params_share"] = out["fault_params"] / change
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def elastic_gates(rows, plan, one):
    part = plan["elastic"]
    want = elastic_schedule(part["steps"], len(rows))
    r0 = dict(rows[0]["elastic"], **one)
    got = [(e["step"], e["from"], e["to"], e["claimed"])
           for e in r0["rescales"]]
    if got != want or r0["printed"] != [
            f"[elastic] rescale: {a} -> {b} workers (claimed={c})"
            for _, a, b, c in want]:
        raise AssertionError(f"elastic: rescales {got} ({r0['printed']}), "
                             f"not the control plane's {want}")
    if any(r["elastic"]["losses"] != r0["losses"] for r in rows):
        raise AssertionError("elastic: the ranks logged different losses")
    if len(r0["losses"]) != part["steps"]:
        raise AssertionError(f"elastic: {len(r0['losses'])} losses logged")
    gate("elastic qwen2 f32 zero3 4 -> 8 ranks: loss vs one device, "
         "relative", r0["loss"], GATE_ELASTIC_LOSS)
    label = ("elastic qwen2 f32 zero3 4 -> 8 ranks: final parameters vs "
             "one device, a share of the one-device run's change")
    if not r0["fault_params_share"] > GATE_ELASTIC_PARAMS_SHARE:
        raise AssertionError(
            f"{label}: the planted fault (moments zeroed at the rescale) "
            f"reads {r0['fault_params_share']:.3g}, not above the bar "
            f"{GATE_ELASTIC_PARAMS_SHARE:.3g}: the gate cannot fail")
    print(json.dumps({"elastic_params": {
        "max_diff": r0["params"], "one_device_change": r0["params_change"],
        "fault_share": r0["fault_params_share"]}}), flush=True)
    gate(label, r0["params_share"], GATE_ELASTIC_PARAMS_SHARE)


def first_parting(a: dict, b: dict) -> dict:
    """Each request's first position where two runs' tokens part (None
    where they are equal)."""
    return {i: next((j for j, (x, y) in enumerate(zip(a[i], b[i]))
                     if x != y), None) for i in a}


def _serve_run(engine, reqs, main=None):
    """Drives ``engine`` over copies of ``reqs`` until drained: (tokens,
    the first tick's logits, wall seconds)."""
    from repro_torch.serve.engine import Request
    for r in reqs:
        engine.submit(Request(rid=r.rid, prompt=r.prompt,
                              max_new_tokens=r.max_new_tokens))
    first = None
    t0 = time.perf_counter()
    with main if main is not None else contextlib.nullcontext():
        while engine.queue or engine.busy_slots():
            engine.step()
            if first is None and engine.last_logits is not None:
                first = engine.last_logits.detach().float().clone()
    return outputs(engine), first, time.perf_counter() - t0


@contextlib.contextmanager
def dropped_part(rank: int):
    """A planted fault: `merge_partials` weighs the cache part of the
    rank at ``rank`` of the merge's axes 0 (its lse read as +inf, a part
    with no key), as a merge that left that part out would."""
    from repro_torch.models import attention
    real = attention.merge_partials

    def merge(o, lse, mesh, axes):
        if mesh.index(axes) == rank:
            lse = torch.full_like(lse, float("inf"))
        return real(o, lse, mesh, axes)

    attention.merge_partials = merge
    try:
        yield
    finally:
        attention.merge_partials = real


def serve_mesh_part(rank, dev, plan, clock):
    """Phase 27 (b): `ServeEngine` on the mesh under each of the part's
    rules: at ``gate_layers`` layers in float32 (rank 0 holds the greedy
    tokens equal to the one-device engine's), then at full depth in
    bfloat16, the main path (rank 0: the first tick's logits against the
    one-device engine's, and where the greedy tokens first part).  Off
    the main path, the bfloat16 engine's first tick under ``decode_sp``
    with the first rank's cache part dropped from the merge (every
    prompt has keys there): a fault the bfloat16 gate must fail."""
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import Request
    from repro_torch.parallel.sharding import preset
    from repro_torch.serve.engine import ServeEngine
    part = plan["serve_mesh"]
    mesh = WorkerMesh(part["mesh"], dev)
    row = {"runs": {}}
    for dtype, layers in (("float32", part["gate_layers"]),
                          ("bfloat16", part["layers"])):
        cfg = parallel_config(dict(part, layers=layers), dtype)
        params = model_lib.init_model(cfg, seed=0, device=dev)
        reqs = make_requests(cfg, part["requests"], part["prompt"],
                             part["new"], seed=27)
        main = dtype == "bfloat16"
        runs = {}
        for rules in part["rules"]:
            engine = ServeEngine(cfg, params, batch_slots=part["slots"],
                                 max_seq=part["max_seq"], mesh=mesh,
                                 rules=preset(rules))
            runs[rules] = _serve_run(engine, reqs,
                                     clock.main_path() if main else None)
            if main:
                if (engine.prefill_calls, engine.decode_ticks) != (
                        part["requests"], part["new"] - 1):
                    raise AssertionError(
                        f"serve_mesh {rules}: {engine.prefill_calls} "
                        f"prefills, {engine.decode_ticks} ticks")
                tokens = sum(len(t) for t in runs[rules][0].values())
                row["runs"][rules] = {
                    "wall_s": runs[rules][2],
                    "tokens_per_s": tokens / runs[rules][2],
                    "layout": [engine.layout.rows, engine.layout.kv_seq],
                    "cache_slots_per_rank": engine.cache["slot0"]["self"][
                        "k"].shape[2]}
            del engine
        fault_first = None
        if main and "decode_sp" in part["rules"]:
            engine = ServeEngine(cfg, params, batch_slots=part["slots"],
                                 max_seq=part["max_seq"], mesh=mesh,
                                 rules=preset("decode_sp"))
            for r in reqs:
                engine.submit(Request(rid=r.rid, prompt=r.prompt,
                                      max_new_tokens=r.max_new_tokens))
            with dropped_part(0):
                engine.step()
            fault_first = engine.last_logits.detach().float().clone()
            del engine
        if rank == 0:
            one = ServeEngine(cfg, params, batch_slots=part["slots"],
                              max_seq=part["max_seq"])
            want, want_first, _ = _serve_run(one, reqs)
            del one
            for rules, (got, first, _) in runs.items():
                key = f"{rules}_{dtype}"
                row[f"logits_{key}"] = rel_err(first, want_first)
                row[f"tokens_equal_{key}"] = got == want
                row[f"first_parting_{key}"] = first_parting(got, want)
            if fault_first is not None:
                row["logits_fault_decode_sp_bfloat16"] = rel_err(
                    fault_first, want_first)
        del params, runs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return row


def serve_mesh_gates(row, plan):
    part = plan["serve_mesh"]
    for rules in part["rules"]:
        if not row[f"tokens_equal_{rules}_float32"]:
            raise AssertionError(
                f"serve_mesh {rules} f32 at {part['gate_layers']} layers: "
                f"greedy tokens part from one device's at "
                f"{row[f'first_parting_{rules}_float32']}")
        gate(f"serve_mesh qwen2 f32 {rules} on {part['mesh']}: first tick's "
             f"logits vs one device", row[f"logits_{rules}_float32"],
             GATE_F32)
        gate(f"serve_mesh qwen2 bf16 {rules} on {part['mesh']}: first tick's "
             f"logits vs one device", row[f"logits_{rules}_bfloat16"],
             GATE_SERVE_MESH_BF16)
    if "decode_sp" in part["rules"]:
        fault = row["logits_fault_decode_sp_bfloat16"]
        if not fault > GATE_SERVE_MESH_BF16:
            raise AssertionError(
                f"serve_mesh bf16 decode_sp: the first tick with rank 0's "
                f"cache part dropped from the merge reads {fault:.3g}, not "
                f"above the bar {GATE_SERVE_MESH_BF16:.3g}: the gate cannot "
                f"fail")


@contextlib.contextmanager
def dropped_partial(rank: int):
    """A planted fault: every sum of the ranks' partial results over
    "model" (`collectives.from_model`: the row-parallel products, the
    vocab-parallel embedding) leaves out the partial of the rank at
    ``rank`` of the group."""
    from repro_torch.parallel import collectives as coll
    real = coll.from_model

    def summed(x, mesh, axes="model"):
        if mesh.index(axes) == rank:
            x = x * 0           # in the graph: the leaves keep a gradient
        return real(x, mesh, axes)

    coll.from_model = summed
    try:
        yield
    finally:
        coll.from_model = real


def _bytes(tree) -> int:
    from repro_torch.models.param import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tp_serve_part(rank, dev, plan, clock):
    """Phase 28 (a, b): `ServeEngine` under ``decode`` on each run's mesh,
    the rank computing its part of the heads, MLP columns, SSM heads and
    vocabulary: at ``gate_layers`` layers in float32 (rank 0 holds the
    greedy tokens equal to the one-device engine's, and the first tick's
    logits), then at its arch's ``layers`` (full depth where none) in
    bfloat16, the main path (rank 0: the first tick's logits against the
    one-device engine's).  Each rank's
    resident weight bytes against the whole model's.  Off the main path,
    the first run's bfloat16 first tick with rank 0's partial dropped
    from every sum over "model" (`dropped_partial`): a fault the bfloat16
    gate must fail."""
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import model as model_lib
    from repro_torch.parallel.sharding import preset
    from repro_torch.serve.engine import ServeEngine
    part = plan["tp_serve"]
    rules = preset(part["rules"])
    meshes = [WorkerMesh(run["mesh"], dev) for run in part["runs"]]
    row = {"runs": [], "weight_bytes": []}
    archs = list(dict.fromkeys(run["arch"] for run in part["runs"]))
    for arch in archs:
        for dtype, layers in (("float32", part["gate_layers"]),
                              ("bfloat16", part["layers"].get(arch))):
            cfg = parallel_config(dict(part, arch=arch, layers=layers),
                                  dtype)
            params = model_lib.init_model(cfg, seed=0, device=dev)
            reqs = make_requests(cfg, part["requests"], part["prompt"],
                                 part["new"], seed=28)
            main = dtype == "bfloat16"
            want = None
            if rank == 0:           # the one-device engine, once an arch
                one = ServeEngine(cfg, params, batch_slots=part["slots"],
                                  max_seq=part["max_seq"])
                want = _serve_run(one, reqs)
                del one
            for run, mesh in zip(part["runs"], meshes):
                if run["arch"] != arch:
                    continue
                engine = ServeEngine(cfg, params, batch_slots=part["slots"],
                                     max_seq=part["max_seq"], mesh=mesh,
                                     rules=rules)
                got = _serve_run(engine, reqs,
                                 clock.main_path() if main else None)
                out = {"arch": arch, "mesh": run["mesh"], "dtype": dtype,
                       "layers": cfg.n_layers, "wall_s": got[2],
                       "weight_bytes": _bytes(engine.params),
                       "whole_weight_bytes": _bytes(params),
                       "cache_bytes": _bytes(engine.cache)}
                if main and (engine.prefill_calls, engine.decode_ticks) != (
                        part["requests"], part["new"] - 1):
                    raise AssertionError(
                        f"tp_serve {arch} {run['mesh']}: "
                        f"{engine.prefill_calls} prefills, "
                        f"{engine.decode_ticks} ticks")
                del engine
                fault = None
                if main and run is part["runs"][0]:
                    engine = ServeEngine(
                        cfg, params, batch_slots=part["slots"],
                        max_seq=part["max_seq"], mesh=mesh, rules=rules)
                    engine.submit(reqs[0])
                    with dropped_partial(0):
                        engine.step()
                    fault = engine.last_logits.detach().float().clone()
                    del engine
                if rank == 0:
                    out["logits"] = rel_err(got[1], want[1])
                    out["tokens_equal"] = got[0] == want[0]
                    out["first_parting"] = first_parting(got[0], want[0])
                    if fault is not None:
                        # the one-device first tick's row of that request
                        out["logits_fault"] = rel_err(fault[0], want[1][0])
                row["runs"].append(out)
                row["weight_bytes"].append(out["weight_bytes"])
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return row


def tp_serve_gates(row):
    for out in row["runs"]:
        label = (f"tp_serve {out['arch']} {out['dtype']} decode on "
                 f"{out['mesh']}")
        if out["dtype"] == "float32":
            if not out["tokens_equal"]:
                raise AssertionError(
                    f"{label} at {out['layers']} layers: greedy tokens part "
                    f"from one device's at {out['first_parting']}")
            gate(f"{label}: first tick's logits vs one device",
                 out["logits"], GATE_TP_F32)
        else:
            gate(f"{label}: first tick's logits vs one device",
                 out["logits"], GATE_TP_BF16)
        if "logits_fault" in out and not out["logits_fault"] > GATE_TP_BF16:
            raise AssertionError(
                f"{label}: the first tick with rank 0's partial dropped "
                f"from the sums over \"model\" reads "
                f"{out['logits_fault']:.3g}, not above the bar "
                f"{GATE_TP_BF16:.3g}: the gate cannot fail")


def tp_train_part(rank, dev, plan, clock):
    """Phase 28 (c): mamba2 cut to 2 layers in float32, ``steps`` sharded
    steps under base on (4, 2), the rank computing its 1/M of the SSM
    heads and the vocabulary; rank 0 runs the one-device step on the same
    weights and batches.  Off the main path, one step with rank 0's
    partial dropped from every sum over "model": a fault the loss gate
    must fail."""
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel.collectives import unshard
    from repro_torch.parallel.sharding import preset
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (
        init_train_state, make_train_step, param_specs, shard_params)
    part = plan["tp_train"]
    mesh = WorkerMesh(part["mesh"], dev)
    cfg = parallel_config(part, "float32")
    rules = preset(part["rules"])
    opt = OptimizerConfig(lr=1e-3)
    lr_kwargs = dict(peak=1e-3, warmup_steps=0, total_steps=10)
    params = _same_params(cfg, dev, mesh)
    specs = param_specs(cfg, rules, mesh)
    step = make_train_step(cfg, opt, mesh, rules, remat="none",
                           lr_kwargs=lr_kwargs)
    batches = [_pipeline_batch(cfg, part, i, dev)
               for i in range(part["steps"])]
    state = init_train_state(shard_params(params, specs, mesh), opt)
    losses = []
    with clock.main_path():
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    whole = [t.cpu().clone() for t in tree_leaves(tree_map(
        lambda t, s: unshard(t, s, mesh), state.params, specs))]
    row = {"rules": rules.name, "losses": losses,
           "weight_bytes": _bytes(state.params),
           "whole_weight_bytes": _bytes(params)}
    del state
    fault = init_train_state(shard_params(params, specs, mesh), opt)
    with dropped_partial(0):
        _, m = step(fault, batches[0])
    fault_loss = float(m["loss"])
    del fault
    if rank == 0:
        one = make_train_step(cfg, opt, remat="none", lr_kwargs=lr_kwargs,
                              device=dev)
        init = [t.cpu().clone() for t in tree_leaves(params)]
        ref = init_train_state(params, opt)
        ref_losses = []
        for b in batches:
            ref, m = one(ref, b)
            ref_losses.append(float(m["loss"]))
        final = [t.cpu() for t in tree_leaves(ref.params)]
        row["loss"] = max(abs(a - b) / max(1.0, abs(b))
                          for a, b in zip(losses, ref_losses))
        row["loss_fault"] = abs(fault_loss - ref_losses[0]) / max(
            1.0, abs(ref_losses[0]))
        row["params"] = _max_diff(whole, final)
        row["params_change"] = _max_diff(final, init)
        row["params_share"] = row["params"] / row["params_change"]
        del ref, one
    del params
    return row


def tp_train_gates(row):
    label = "tp_train mamba2 f32 base (4, 2)"
    if not row["loss_fault"] > GATE_TP_LOSS:
        raise AssertionError(
            f"{label}: a step with rank 0's partial dropped from the sums "
            f"over \"model\" reads {row['loss_fault']:.3g}, not above the "
            f"bar {GATE_TP_LOSS:.3g}: the gate cannot fail")
    gate(f"{label}: loss vs one device, relative", row["loss"], GATE_TP_LOSS)
    gate(f"{label}: parameters vs one device, a share of its change",
         row["params_share"], GATE_TP_PARAMS_SHARE)


# ---------------------------------------------------------------------------
# Phase 30: the prefill's rows cut over the mesh
# ---------------------------------------------------------------------------

#: phase 30's bars: the float32 prefill's gathered logits and each rank's
#: cache part against rank 0's one-device prefill, relative (phase 28's
#: float32 bar), the bfloat16 logits (phase 28's); a planted fault (every
#: rank prefills its neighbour's rows) must read above them
GATE_ROWS_F32, GATE_ROWS_BF16 = GATE_TP_F32, GATE_TP_BF16


@contextlib.contextmanager
def dispatch_demand(out: list):
    """Appends, for each MoE dispatch the model makes while open, the
    least capacity factor at which it drops no assignment: the dense
    dispatch's capacity at its busiest expert, expert parallelism's as
    `ep_factor` (phase 26's rule) reckons it.  The router comes before
    any capacity, so a call on the same inputs routes alike at every
    factor."""
    from repro_torch.models import moe as moe_mod
    dense, ep = moe_mod.moe_forward_dense, moe_mod._ep_local

    def per_expert(x2d, router, m):
        idx = moe_mod._router_topk(x2d.float() @ router.float(),
                                   m.top_k)[2]
        return torch.bincount(idx.reshape(-1), minlength=m.n_experts).to(
            torch.int32)

    def dense_demand(p, cfg, x, **kw):
        m = cfg.moe
        T = x.shape[0] * x.shape[1]
        most = int(per_expert(x.reshape(T, -1), p["router"], m).max())
        out.append(most * m.n_experts / (T * m.top_k))
        return dense(p, cfg, x, **kw)

    def ep_demand(xt, router_w, *args, m, mesh, data_axis, **kw):
        out.append(ep_factor(per_expert(xt, router_w, m),
                             xt.shape[0] * m.top_k, mesh, data_axis)[0])
        return ep(xt, router_w, *args, m=m, mesh=mesh, data_axis=data_axis,
                  **kw)

    moe_mod.moe_forward_dense, moe_mod._ep_local = dense_demand, ep_demand
    try:
        yield out
    finally:
        moe_mod.moe_forward_dense, moe_mod._ep_local = dense, ep


def no_drop(cfg, call):
    """``cfg`` at a capacity factor at which ``call(cfg)`` (one model
    call) drops no MoE assignment: the call runs once at cfg's own factor
    with `dispatch_demand` open; ``cfg`` itself without MoE."""
    if cfg.moe is None:
        return cfg
    demand = []
    with dispatch_demand(demand):
        call(cfg)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=max(demand) * 1.0001))


@contextlib.contextmanager
def kernel_rows(seen: dict):
    """Records the rows each kernel call of the model gets (by kernel, a
    set): flash attention's queries' and the SSD scan's leading dim, and
    the grouped matmul's experts (its weights' leading dim)."""
    from repro_torch.models import attention, ssm
    from repro_torch.models import moe as moe_mod
    sites = [(attention, "flash_attention", 0), (ssm, "ssd", 0),
             (moe_mod, "gmm", 1)]
    real = [getattr(mod, attr) for mod, attr, _ in sites]

    def record(name, fn, arg):
        def wrapped(*args, **kwargs):
            seen.setdefault(name, set()).add(int(args[arg].shape[0]))
            return fn(*args, **kwargs)
        return wrapped
    for (mod, attr, arg), fn in zip(sites, real):
        setattr(mod, attr, record(attr, fn, arg))
    try:
        yield seen
    finally:
        for (mod, attr, _), fn in zip(sites, real):
            setattr(mod, attr, fn)


def rows_params(cfg, rules, mesh, rank, dev):
    """(this rank's serving part of the weights drawn from seed 0, rank
    0's whole weights or None).  The part is `models.model.serving_part`'s
    and, under expert parallelism, holds the rank's own experts only (the
    dispatch reads no other).  A model with experts is drawn by one rank
    at a time: eight whole copies of jamba's cut would not fit the
    card."""
    import torch.distributed as dist
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import tree_map
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import Constrainer

    axes = model_lib.axes_tree(cfg)

    def draw():
        whole = model_lib.init_model(cfg, seed=0, device=dev)
        part = tree_map(lambda t, a: coll.own_slice(
            t, mesh, "data", a.index("expert")).clone()
            if "expert" in a and rules.name == "ep" else t,
            model_lib.model_part(whole, cfg, rules, mesh), axes)
        return whole, part

    if cfg.moe is None:
        whole, part = draw()
    else:
        for turn in range(mesh.size(mesh.axis_names)):
            if turn == rank:
                whole, part = draw()
                if rank:
                    whole = None
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
            dist.barrier()
    # the weights a call would gather, gathered once (`serving_part`)
    constrain = Constrainer(rules, mesh, rows=())
    if constrain.tp > 1:
        part["stack"] = tfm.serving_stack(part["stack"], cfg, constrain)
    return part, whole if rank == 0 else None


def from_rank0(tree, like, dev):
    """Rank 0's ``tree`` on every rank of the world (host copies over
    gloo); ``like`` (a tree of the same shapes on the CPU) holds the other
    ranks' buffers."""
    import torch.distributed as dist
    from repro_torch.models.param import tree_map

    def one(t, buf):
        buf = t.detach().cpu().clone() if t is not None else buf
        dist.broadcast(buf, src=0)
        return buf.to(dev)
    if tree is None:
        return tree_map(lambda b: one(None, b), like)
    return tree_map(one, tree, like)


def _cache_err(got, want) -> tuple[float, bool]:
    """(the largest relative error of a cache's float leaves, its slot
    positions equal)."""
    from repro_torch.models.param import tree_leaves
    err, pos = 0.0, True
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        if b.dtype == torch.int32:
            pos = pos and torch.equal(a, b)
        else:
            err = max(err, rel_err(a, b))
    return err, pos


def prefill_rows_run(rank, dev, part, run, mesh, dtype, layers, clock):
    """One run of phase 30 at ``layers`` in ``dtype``: the batch's prefill
    through `make_prefill_step(..., batch=B)`, every rank its rows.  In
    float32 (the gates): rank 0 holds the gathered logits and lengths
    against its one-device prefill of the whole batch, every rank its
    cache part against that prefill's (broadcast from rank 0; its part by
    `models.model.cache_part`), and the same with every rank prefilling
    its neighbour's rows (the batch rolled by a rank's rows: a planted
    fault).  In bfloat16 (the main path, with the rows each kernel got):
    the cut prefill and the uncut one (every row on every rank, as
    before: a measured reference, not a gate), each once to warm and once
    timed; rank 0 holds the logits against its one-device prefill."""
    from repro_torch.models import model as model_lib
    from repro_torch.parallel.sharding import preset
    from repro_torch.serve.engine import make_prefill_step
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = parallel_config(dict(part, **dict(run, layers=layers)), dtype)
    rules = preset(run["rules"])
    B, S = part["batch"], part["seq"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=dev)}
    mine, whole = rows_params(cfg, rules, mesh, rank, dev)
    layout = make_prefill_step(cfg, mesh, rules, batch=B).layout
    n = B // mesh.size(layout.rows)

    def cut(c, b=batch):
        step = make_prefill_step(c, mesh, rules, batch=B)
        return step(mine, b, model_lib.init_cache(c, n, S, device=dev,
                                                  layout=step.layout))

    def uncut(c):
        step = make_prefill_step(c, mesh, rules)
        return step(mine, batch, model_lib.init_cache(c, B, S, device=dev,
                                                      layout=step.layout))

    def synced(fn, *args):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    row = {"arch": cfg.name, "mesh": run["mesh"], "rules": rules.name,
           "dtype": dtype, "layers": cfg.n_layers, "rows": list(layout.rows),
           "rows_per_rank": n}
    cut_cfg = no_drop(cfg, cut)
    if cfg.moe is not None:
        row["capacity_factor"] = cut_cfg.moe.capacity_factor
    fault = None
    if dtype == "bfloat16":
        uncut_cfg = no_drop(cfg, uncut)
        cut(cut_cfg)
        uncut(uncut_cfg)
        seen: dict = {}
        before = clock.main_s
        with clock.main_path(), kernel_rows(seen):
            logits, cache, lengths = cut(cut_cfg)
        row["main_s"] = clock.main_s - before
        row["kernel_rows"] = {k: sorted(v) for k, v in seen.items()}
        row["uncut_s"] = synced(uncut, uncut_cfg)[1]
    else:
        logits, cache, lengths = cut(cut_cfg)
        rolled = {k: v.roll(-n, 0) for k, v in batch.items()}
        fault = cut(cut_cfg, rolled)
    ref = None
    if rank == 0:                   # the one-device prefill of the batch

        def one(c):
            return model_lib.prefill(whole, c, batch, model_lib.init_cache(
                c, B, S, device=dev))
        ref = one(no_drop(cfg, one))
        row["logits"] = rel_err(logits, ref[0])
        row["lengths_equal"] = bool(torch.equal(lengths, ref[2]))
        if fault is not None:
            row["logits_fault"] = rel_err(fault[0], ref[0])
    if fault is not None:           # every rank's cache part
        like = model_lib.init_cache(cfg, B, S, device="cpu")
        want = model_lib.cache_part(from_rank0(
            None if ref is None else ref[1], like, dev), cfg, layout)
        row["cache"], row["cache_pos_equal"] = _cache_err(cache, want)
        row["cache_fault"] = _cache_err(fault[1], want)[0]
    del mine, whole, ref, cache, fault
    if dev.type == "cuda":
        row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t0
    return row


def prefill_rows_part(rank, dev, plan, clock):
    """Phase 30 (`PARALLEL_PLAN`'s "prefill_rows"): each run's float32
    gate at ``gate_layers`` layers, then its bfloat16 main path at its
    ``layers`` (`prefill_rows_run`)."""
    from repro_torch.launch.mesh import WorkerMesh
    part = plan["prefill_rows"]
    meshes = [WorkerMesh(run["mesh"], dev) for run in part["runs"]]
    return {"runs": [
        prefill_rows_run(rank, dev, part, run, mesh, dtype, layers, clock)
        for run, mesh in zip(part["runs"], meshes)
        for dtype, layers in (("float32", part["gate_layers"]),
                              ("bfloat16", run["layers"]))]}


def prefill_rows_expected(plan: dict) -> list:
    """Per bfloat16 run, on each rank's main path: the rows each kernel
    must get (flash attention and the SSD scan the rank's rows, the
    grouped matmul the rank's experts), and each kernel's launches by
    instance (one flash launch an attention layer, one SSD launch a Mamba
    layer, three gmm launches a MoE layer; the instances `flash_route`,
    `ssd_route` and `gmm_route` name at the run's shapes)."""
    part = plan["prefill_rows"]
    out = []
    for run in part["runs"]:
        cfg = parallel_config(dict(part, **run), "bfloat16")
        mesh = run["mesh"]
        rows = part["batch"] // mesh.get("data", 1)
        mixers = [cfg.mixer_kind(s) for s in range(cfg.period)]
        moe = [cfg.ffn_kind(s) for s in range(cfg.period)].count("moe")
        want, by = {}, {}
        if "attn" in mixers:
            want["flash_attention"] = [rows]
            by["flash_attention"] = {flash_route(
                torch.bfloat16, part["seq"], cfg.n_heads, cfg.n_kv_heads,
                cfg.d_head): cfg.n_scan * mixers.count("attn")}
        if "ssm" in mixers:
            s = cfg.ssm
            want["ssd"] = [rows]
            by["ssd"] = {ssd_route(torch.bfloat16, s.head_dim, s.d_state,
                                   s.chunk): cfg.n_scan * mixers.count("ssm")}
        if moe:
            m = cfg.moe
            f = m.d_ff_expert // mesh.get("model", 1)
            want["gmm"] = [m.n_experts // mesh["data"]]
            by["gmm"] = {}
            for K, N, calls in ((cfg.d_model, f, 2), (f, cfg.d_model, 1)):
                inst = gmm_route(torch.bfloat16, K, N)
                by["gmm"][inst] = by["gmm"].get(inst, 0) + \
                    calls * cfg.n_scan * moe
        out.append((want, by))
    return out


def prefill_rows_gates(rows, plan):
    """Phase 30's gates: the float32 runs' logits, lengths and every
    rank's cache part against one device, each planted fault above the
    bars, the bfloat16 logits against one device, and the rows and the
    instance each kernel got on every rank's main path."""
    expected = prefill_rows_expected(plan)
    runs0 = rows[0]["prefill_rows"]["runs"]
    for i, out in enumerate(runs0):
        label = (f"prefill_rows {out['arch']} {out['dtype']} {out['rules']} "
                 f"on {out['mesh']} (rows over {out['rows']})")
        if out["dtype"] == "float32":
            gate(f"{label}: gathered logits vs one device", out["logits"],
                 GATE_ROWS_F32)
            if not out["lengths_equal"]:
                raise AssertionError(f"{label}: lengths differ")
            for rank, r in enumerate(rows):
                o = r["prefill_rows"]["runs"][i]
                gate(f"{label}: rank {rank}'s cache part vs one device",
                     o["cache"], GATE_ROWS_F32)
                if not o["cache_pos_equal"]:
                    raise AssertionError(f"{label}: rank {rank}'s slot "
                                         f"positions differ")
                if not o["cache_fault"] > GATE_ROWS_F32:
                    raise AssertionError(
                        f"{label}: rank {rank} prefilling its neighbour's "
                        f"rows reads {o['cache_fault']:.3g} in the cache, "
                        f"not above the bar: the gate cannot fail")
            if not out["logits_fault"] > max(GATE_ROWS_F32, GATE_ROWS_BF16):
                raise AssertionError(
                    f"{label}: every rank prefilling its neighbour's rows "
                    f"reads {out['logits_fault']:.3g}, not above the bars: "
                    f"the gate cannot fail")
            continue
        gate(f"{label}: gathered logits vs one device", out["logits"],
             GATE_ROWS_BF16)
        want, routes = expected[i // 2]
        for rank, r in enumerate(rows):
            got = r["prefill_rows"]["runs"][i]["kernel_rows"]
            if got != want:
                raise AssertionError(f"{label}: rank {rank}'s kernels got "
                                     f"rows {got}, not {want}")
    # the instances: every main-path launch on its run's route
    want: dict = {}
    for _, by in expected:
        for kernel, insts in by.items():
            for inst, k in insts.items():
                want.setdefault(kernel, {})
                want[kernel][inst] = want[kernel].get(inst, 0) + k
    for rank, r in enumerate(rows):
        got = {k: v for k, v in r["prefill_rows"]["by_instance"].items()
               if v}
        if got != want:
            raise AssertionError(f"phase 30: rank {rank}'s launches by "
                                 f"instance {got}, not {want}")


def parallel_rank(rank, dev, plan):
    """Phase 26 on one rank: the four parts, each timed, with its main
    path's launches; every rank's peak memory."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, fn in (("ep", ep_part), ("sp", sp_part), ("step", step_part),
                     ("int8", int8_part), ("elastic", elastic_part),
                     ("serve_mesh", serve_mesh_part),
                     ("tp_serve", tp_serve_part),
                     ("tp_train", tp_train_part),
                     ("prefill_rows", prefill_rows_part)):
        if name not in plan:
            continue
        dist.barrier()
        clock = PartClock(dev)
        out[name] = clock.row(**fn(rank, dev, plan, clock))
        if dev.type == "cuda":
            out[name]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.empty_cache()
        if rank == 0:           # as it goes: the gates read them at the end
            print(json.dumps({"parallel_part": name, **{
                k: v for k, v in out[name].items()
                if isinstance(v, (int, float, str, dict, list))}}),
                flush=True)
    return out


def serve_mesh_routes(plan: dict) -> dict:
    """The flash instances each rank's serving runs launch (`flash_route`
    of every prefill, whole on every rank, and of each tick), by
    instance, over the part's rules."""
    part = plan["serve_mesh"]
    cfg = parallel_config(part, "bfloat16")
    dims = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    out: dict = {}
    calls = [len(r.prompt) for r in make_requests(
        cfg, part["requests"], part["prompt"], part["new"], seed=27)]
    calls += [1] * (part["new"] - 1)
    for Sq in calls:
        inst = flash_route(torch.bfloat16, Sq, *dims)
        out[inst] = out.get(inst, 0) + cfg.n_layers * len(part["rules"])
    return out


#: the parts of phases 27, 28 and 30 (run in phase 26's world)
MESH_PARTS = ("elastic", "serve_mesh")
TP_PARTS = ("tp_serve", "tp_train")
ROWS_PARTS = ("prefill_rows",)


def parallel_phase(plan=PARALLEL_PLAN, device="cuda",
                   ranks=PARALLEL_RANKS) -> dict:
    """Phases 26-28 and 30: one world of ``ranks`` processes (spawn, gloo
    on the rank's device, all on card 0), the parts on meshes made over
    the same ranks, their gates, and each rank's launches held exactly to
    `parallel_launches` (and serving's flash instances to
    `serve_mesh_routes`, phase 30's to `prefill_rows_expected`).  Prints
    a ``{"parallel": ...}`` line for phase 26's parts, and a line for
    each of phases 27, 28 and 30's (``{"elastic": ...}``,
    ``{"serve_mesh": ...}``, ``{"tp_serve": ...}``, ``{"tp_train":
    ...}``, ``{"prefill_rows": ...}``).  Returns each part's launches by
    kernel, as the ranks counted them on its main path, summed over the
    ranks."""
    import shutil
    from repro_torch.launch.mesh import spawn_world
    if device == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(json.dumps({"parallel_free_gb": free / 1e9,
                          "card_gb": total / 1e9}), flush=True)
    # the ranks' allocators grow by segments (eight of them share 80 GB)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    world_dir = ROOT / "build" / "repro_torch" / "world"
    world_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{time.time_ns()}"
    store = world_dir / f"store-{tag}"
    ckpt_dir = world_dir / f"elastic-{tag}"
    if "elastic" in plan:
        plan = dict(plan, elastic=dict(plan["elastic"],
                                       ckpt_dir=str(ckpt_dir)))
    t0 = time.perf_counter()
    try:
        rows = spawn_world(parallel_rank, ranks, backend="gloo",
                           device=device, init_file=store,
                           timeout_s=PARALLEL_TIMEOUT_S, threads=None,
                           args=(plan,))
        wall = time.perf_counter() - t0
        if "elastic" in plan:
            one = elastic_one_device(rows, plan, device)
            rows[0]["elastic"].update(one)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for name, gates in (("ep", ep_gates), ("sp", sp_gates),
                        ("step", step_gates), ("int8", int8_gates)):
        if name in plan:
            gates(rows[0][name] if name != "int8" else rows)
    if "elastic" in plan:
        elastic_gates(rows, plan, one)
    if "serve_mesh" in plan:
        serve_mesh_gates(rows[0]["serve_mesh"], plan)
        routes = serve_mesh_routes(plan)
        for rank, r in enumerate(rows):
            got = r["serve_mesh"]["by_instance"]["flash_attention"]
            if got != routes:
                raise AssertionError(f"phase 27 serve_mesh: rank {rank}'s "
                                     f"flash instances {got}, not {routes}")
    if "tp_serve" in plan:
        tp_serve_gates(rows[0]["tp_serve"])
    if "tp_train" in plan:
        tp_train_gates(rows[0]["tp_train"])
    if "prefill_rows" in plan:
        prefill_rows_gates(rows, plan)
    for rank, r in enumerate(rows):
        for part, counts in parallel_launches(plan, rank, ranks).items():
            if r[part]["launches"] != counts:
                raise AssertionError(f"phase 26-28 {part}: rank {rank} "
                                     f"launched {r[part]['launches']}, not "
                                     f"{counts}")
    by_part = {part: {k: sum(r[part]["launches"][k] for r in rows)
                      for k in PARALLEL_KERNELS} for part in plan}

    def part_line(part):
        return {
            "mesh": plan[part].get("mesh"),
            "wall_s": [r[part]["wall_s"] for r in rows],
            "main_s": [r[part]["main_s"] for r in rows],
            "launches_per_rank": [r[part]["launches"] for r in rows],
            "by_instance_rank0": rows[0][part]["by_instance"],
            "peak_gb": [r[part].get("peak_gb") for r in rows],
            # each rank's resident weights (phase 28: a run's each)
            "weight_bytes": [r[part].get("weight_bytes") for r in rows],
            **{k: v for k, v in rows[0][part].items() if k not in (
                "wall_s", "main_s", "launches", "by_instance", "peak_gb",
                "weight_bytes")}}

    def rows_line():
        """Phase 30's runs: rank 0's row of each, with every rank's wall,
        main-path and uncut seconds and peak beside it."""
        line = part_line("prefill_rows")
        line["runs"] = [dict(run, **{f"{k}_by_rank": [
            r["prefill_rows"]["runs"][i].get(k) for r in rows]
            for k in ("wall_s", "main_s", "uncut_s", "peak_gb", "cache",
                      "cache_fault")})
            for i, run in enumerate(line["runs"])]
        return line

    summary = {"parallel": {
        "ranks": ranks, "backend": "gloo", "world_wall_s": wall,
        "parts": {part: part_line(part) for part in plan
                  if part not in MESH_PARTS + TP_PARTS + ROWS_PARTS},
        "launches": {k: sum(by_part[part][k] for part in plan
                            if part not in MESH_PARTS + TP_PARTS
                            + ROWS_PARTS)
                     for k in PARALLEL_KERNELS}}}
    print(json.dumps(summary), flush=True)
    for part in MESH_PARTS + TP_PARTS + ROWS_PARTS:
        if part in plan:
            line = rows_line() if part in ROWS_PARTS else part_line(part)
            print(json.dumps({part: dict(line, ranks=ranks,
                                         plan=plan[part])}), flush=True)
    return by_part


def build_all(modules) -> None:
    """Builds every kernel at once, one nvcc per source (a module's
    `build`, and its `build_backward` where it has one), and prints each
    build's time and ptxas' register and shared-memory report."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = [(mod, "build", "build_log") for mod in modules] + [
        (mod, "build_backward", "bwd_build_log") for mod in modules
        if hasattr(mod, "build_backward")]

    def timed(job):
        t0 = time.perf_counter()
        lib = getattr(job[0], job[1])()
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(timed, jobs))
    for (mod, _, log), (lib, secs) in zip(jobs, built):
        print(f"built {lib.relative_to(ROOT)} in {secs:.3f} s", flush=True)
        if getattr(mod, log):
            print(getattr(mod, log).strip(), flush=True)
    print(f"all kernels built in {time.perf_counter() - t0:.3f} s",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 29: the dry-run
# ---------------------------------------------------------------------------

#: the dry-run's command line on the card's host: (arch, shape, --mesh)
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", "both"),
                ("jamba-v0.1-52b", "decode_32k", "single"),
                ("qwen2-1.5b", "prefill_32k", "both"))
DRYRUN_KEYS = ("roofline", "roofline_extrapolated",
               "roofline_kernel_adjusted", "memory",
               "collective_bytes_per_chip")
#: a step's bound over its measured time: a bound above the measured time
#: would mean the count holds work the card did not do
DRYRUN_BOUND_SLACK = 1.05
DRYRUN_DIR = ROOT / "build" / "repro_torch" / "dryrun"


def dryrun_cli_phase(timeout_s=240.0):
    """Phase 29(a): `python -m repro_torch.launch.dryrun` for each of
    `DRYRUN_CELLS`, the processes started together; each must exit 0 and
    write, for each mesh, a result with every key of `DRYRUN_KEYS`, no
    error, and ``cuda_initialized`` false (the dry-run made no CUDA
    context in its process).  Prints and returns a ``{"dryrun_cli": ...}``
    row."""
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([path] if path else [])))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(DRYRUN_DIR)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for arch, shape, mesh in DRYRUN_CELLS]
    try:
        outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    cells = []
    for (arch, shape, mesh), p, out in zip(DRYRUN_CELLS, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"dry-run CLI {arch} × {shape}: exit "
                                 f"{p.returncode}: {out[-2000:]}")
        for suffix in {"both": ("single", "multi")}.get(mesh, (mesh,)):
            res = json.loads((DRYRUN_DIR / f"{arch}_{shape}_{suffix}.json")
                             .read_text())
            missing = [k for k in DRYRUN_KEYS if k not in res]
            if missing or "error" in res or res["cuda_initialized"]:
                raise AssertionError(
                    f"dry-run CLI {arch} × {shape} × {suffix}: missing "
                    f"{missing}, error {res.get('error')}, CUDA context "
                    f"{res.get('cuda_initialized')}")
            adj = res["roofline_kernel_adjusted"]
            cells.append({
                "arch": arch, "cell": shape, "mesh": res["mesh"],
                "sites": res["sites"], "trace_s": res["trace_s"],
                "analysis_s": res["analysis_s"],
                "step_bound_s": adj["step_time_lower_bound_s"],
                "bottleneck": adj["bottleneck"],
                "roofline_fraction": adj["roofline_fraction"],
                "peak_gb": res["memory"]["peak_memory_in_bytes"] / 1e9,
                "fits_hbm": res["memory"]["fits_hbm"],
                "rows": res.get("rows"),
                "flops_per_chip": adj["hlo_flops_per_chip"],
                "useful_flop_ratio": adj["useful_flop_ratio"],
                "cuda_initialized": res["cuda_initialized"]})
    row = {"wall_s": wall, "cells": cells}
    print(json.dumps({"dryrun_cli": row}), flush=True)
    return row


def dryrun_step_phase(cfg, trained, card, train=TRAIN):
    """Phase 29(b): phase 15's step (``cfg``: qwen2-1.5b cut to
    `TRAIN_LAYERS`; `TRAIN`'s batch; `run_fixed`'s optimizer and remat)
    analysed by the dry-run on a mesh of one rank, held against phase
    15's measurements (``trained``, `train_phase`'s row at ``train``'s
    batch): its sites per
    step by kernel equal `training_launches` and the launches phase 15
    counted per step, its parameters' and moments' bytes equal the
    state's bytes exactly, and its bound over the measured median step is
    at most `DRYRUN_BOUND_SLACK`.  Prints and returns a
    ``{"dryrun_step": ...}`` row beside the card's name and power limit."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.train.optimizer import OptimizerConfig

    cell = ShapeCell("train_phase", "train", train["seq"], train["batch"])
    opt = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype, lr=1e-3)
    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        mesh = WorkerMesh({"data": 1, "model": 1}, "cpu")
        res = dryrun.analyse_step(cfg, cell, mesh, analysis=False,
                                  remat="none", opt_cfg=opt)
    wall = time.perf_counter() - t0
    want = {k: n for k, n in training_launches(cfg).items() if n}
    measured = {k: n // trained["steps"]
                for k, n in trained["launch_counts"].items() if n}
    if res["sites"] != want or want != measured:
        raise AssertionError(f"dry-run of {cfg.name}'s step: sites "
                             f"{res['sites']}, training_launches {want}, "
                             f"measured per step {measured}")
    args = res["memory"]["arguments"]
    state = args["params"] + args["mu"] + args["nu"]
    if state != trained["state_bytes"]:
        raise AssertionError(f"dry-run of {cfg.name}'s step: state bytes "
                             f"{state}, measured {trained['state_bytes']}")
    adj = res["roofline_kernel_adjusted"]
    bound_ms = 1e3 * adj["step_time_lower_bound_s"]
    ratio = bound_ms / trained["step_ms_median_3_6"]
    row = {"card": card, "arch": cfg.name, "layers": cfg.n_layers,
           "batch": train["batch"], "seq": train["seq"],
           "sites_per_step": res["sites"], "measured_per_step": measured,
           "state_bytes": state, "argument_bytes":
           res["memory"]["argument_size_in_bytes"],
           "bound_ms": bound_ms, "bound_by": adj["bottleneck"],
           "terms_ms": {k: 1e3 * adj[k] for k in (
               "compute_s", "memory_s", "collective_s")},
           "flops": adj["hlo_flops_per_chip"],
           "bytes": adj["hlo_bytes_per_chip"],
           "plain_bound_ms": 1e3 * res["roofline"]["step_time_lower_bound_s"],
           "measured_step_ms": trained["step_ms_median_3_6"],
           "bound_over_measured": ratio,
           "predicted_peak_gb": res["memory"]["peak_memory_in_bytes"] / 1e9,
           "max_memory_allocated_gb": trained["max_memory_allocated_gb"],
           "wall_s": wall}
    print(json.dumps({"dryrun_step": row}), flush=True)
    gate(f"dry-run of {cfg.name}'s step: bound over the measured median "
         f"step", ratio, DRYRUN_BOUND_SLACK)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    started = time.perf_counter()

    def phase_done(phase):
        """The command time at the end of a phase: the smoke's time limit
        stays while it grows, so each phase's share is printed."""
        print(json.dumps({"phase_done": phase,
                          "at_s": time.perf_counter() - started}), flush=True)

    # phase 1: the card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    from repro_torch.configs import get_config
    from repro_torch.kernels.build import launch_counts
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_gmm import ops as gm
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.waterfill import ops

    # phase 2: build every kernel from the checkout's sources
    build_all([ops, fa, so, gm])

    phase_done("2")
    # phase 5: flash attention against its plain version, timed at the
    # serving shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    shapes = flash_phase(fa, dev)
    modal_shapes = modal_flash_phase(fa, dev)
    config_shapes = modal_flash_phase(
        fa, dev, CONFIG_FLASH_CALLS, [c[0] for c in CONFIG_FLASH_CALLS])

    phase_done("5")
    # phase 6: qwen2-1.5b at full width
    cfg = get_config(ARCH)
    f32_cfg, f32_params, params = model_phase(cfg, dev)
    engine_equal_phase(f32_cfg, f32_params)
    del f32_params
    torch.cuda.empty_cache()

    phase_done("6")
    # phase 7: serving qwen2, its main path, then the spot reclaim
    served = serve_phase(cfg, params, launch_counts,
                         routes={"flash_attention": fa.route_counts})
    reclaim_phase(cfg, params)
    del params
    torch.cuda.empty_cache()
    decode = shapes[-1]
    flash_line = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:136",
        "launches": served["launch_counts"]["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "device_ms": decode["device_ms"],
        "library_device_ms": decode["library_device_ms"],
        "instances": {
            "split": "at most 32 query rows per kv head (decode): the "
                     "cache split across blocks, parts merged in order",
            "wgmma": "bfloat16 prefill, Dh 64 or 128: TMA ring, wgmma",
            "simt": "float32 prefill, and Dh 32"},
        "launches_by_instance": served["routes"]["flash_attention"],
        "ptxas": flash_instances(fa),
        "shapes": [{k: r[k] for k in (
            "flash_case", "instance", "shape", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_share", "device_bound_share",
            "library_ms", "library_device_ms", "max_abs_err")}
            for r in shapes]}

    phase_done("7")
    # phase 8: the SSD scan against its plain version and the oracle,
    # timed at mamba2's and jamba's serving shapes on both instances
    ssd_timed, ssd_rows = ssd_phase(so, dev)

    phase_done("8")
    # phase 9: mamba2-1.3b at full width
    cfg = get_config(SSD_ARCH)
    f32_cfg, f32_params, params = model_phase(cfg, dev, plain=plain_ssd,
                                              what="SSD scan")
    engine_equal_phase(f32_cfg, f32_params, plain=plain_ssd,
                       ssd_routes=so.route_counts)
    del f32_params
    torch.cuda.empty_cache()

    phase_done("9")
    # phase 10: serving mamba2, its main path: the scan runs once per
    # layer and prefill, every one on the tensor cores, and decode runs
    # the plain one-token update
    served = serve_phase(cfg, params, launch_counts, kernels=("ssd",),
                         profile_kernel=None,
                         routes={"ssd": so.route_counts})
    longest = ssd_timed[SSD_TIMED.index(max(SSD_TIMED))]   # mamba2, 1024
    ssd_line = {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:113",
        "launches": served["launch_counts"]["ssd"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows),
        "ms": longest["ms"], "plain_ms": longest["plain_ms"],
        "bound_ms": longest["bound_ms"], "bound_by": longest["bound_by"],
        "library_ms": None,
        "device_ms": longest["device_ms"],
        "instances": {
            "mma": "bfloat16, P and N 64 or 128, chunk a multiple of 64: "
                   "chunk states, state passing, scores once per group, "
                   "chunk outputs on mma.sync",
            "simt": "float32, and the shapes mma does not take"},
        "launches_by_instance": served["routes"]["ssd"],
        "ptxas": ssd_instances(so),
        "shapes": [{k: r[k] for k in (
            "ssd_case", "instance", "shape", "ms", "device_ms", "simt_ms",
            "simt_device_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "device_bound_share", "library_ms",
            "max_abs_err")} for r in ssd_timed]}
    del params
    torch.cuda.empty_cache()

    phase_done("10")
    # phase 11: the grouped matmul against its plain version, timed at
    # jamba's serving products; one full-width MoE layer
    gmm_timed = gmm_phase(gm, dev)
    cfg = get_config(MOE_ARCH)
    moe_layer_phase(cfg, dev)

    phase_done("11")
    # phase 12: jamba at full width, one period (8 layers) in float32;
    # freed before the 16-layer model is made
    f32_cfg, f32_params, _ = model_phase(
        dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS), dev,
        plain=plain_kernels, what="kernels", bf16=False)
    engine_equal_phase(f32_cfg, f32_params, plain=plain_kernels,
                       ssd_routes=so.route_counts)
    del f32_params
    torch.cuda.empty_cache()

    phase_done("12")
    # phase 13: jamba at full width, two periods (16 layers) in bfloat16:
    # the routed gate, then serving, its main path
    cfg = dataclasses.replace(cfg, n_layers=MOE_SERVE_LAYERS)
    params = routed_bf16_phase(cfg, dev)
    served = serve_phase(cfg, params, launch_counts,
                         kernels=("flash_attention", "ssd", "gmm"),
                         profile_kernel="gmm_kernel",
                         routes={"gmm": gm.route_counts,
                                 "flash_attention": fa.route_counts,
                                 "ssd": so.route_counts})
    if served["routes"]["gmm"]["wgmma"] != served["launch_counts"]["gmm"]:
        raise AssertionError(f"serving jamba in bfloat16: gmm routes "
                             f"{served['routes']['gmm']}, not every launch "
                             f"on the tensor cores")
    flash_line["launches_by_instance_jamba"] = served["routes"][
        "flash_attention"]
    ssd_line["launches_by_instance_jamba"] = served["routes"]["ssd"]
    del params
    torch.cuda.empty_cache()
    decode = gmm_timed[-2]                  # the decode tick's gate/up call
    gmm_line = {
        "name": "gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:76",
        "launches": served["launch_counts"]["gmm"],
        "max_abs_err": max(r["max_abs_err"] for r in gmm_timed),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "instances": {"wgmma": "bfloat16 with K, N multiples of 8",
                      "simt": "float32, and bfloat16 TMA cannot take"},
        "launches_by_instance": served["routes"]["gmm"],
        "wgmma_ptxas": wgmma_instances(gm),
        "shapes": [{k: r[k] for k in (
            "gmm_case", "route", "shape", "ms", "stream_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_share", "library_ms",
            "max_abs_err")} for r in gmm_timed]}
    phase_done("13")
    # phase 15: training -- flash attention's backward kernel against
    # its plain version, timed at qwen2's training shapes; the float32
    # and bfloat16 2-layer gates; then qwen2-1.5b at full width, cut to
    # `TRAIN_LAYERS`, through run_fixed, its
    # main path (before the water-fill: the profiler reads it)
    cfg = get_config(ARCH)
    bwd_timed, bwd_err = flash_bwd_phase(fa, dev)
    train_f32_gate(cfg, dev, launch_counts)
    train_bf16_gate(cfg, dev, launch_counts)
    cfg = train_cfg = cut_layers(cfg, TRAIN_LAYERS[ARCH])
    trained = train_phase(
        cfg, dev, launch_counts,
        {"flash_attention": (fa.route_counts, "wgmma"),
         "flash_attention_bwd": (fa.bwd_route_counts, "wgmma")},
        per_step=training_launches(cfg))
    main_shape = bwd_timed[FLASH_BWD_TIMED.index(
        (TRAIN["batch"], TRAIN["seq"]))]
    bwd_line = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/"
                  "flash_attention_bwd.cu",
        "replaces": "gradient of src/repro/kernels/flash_attention/"
                    "ops.py:74 (no Pallas backward)",
        "launches": trained["launch_counts"]["flash_attention_bwd"],
        "max_abs_err": bwd_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "device_ms": main_shape["device_ms"],
        "library_device_ms": main_shape["library_device_ms"],
        "instances": {
            "wgmma": "bfloat16, Dh 64 or 128: dk/dv and dq on wgmma, packed "
                     "query tiles and K/V tiles on TMA rings, P and dS in "
                     "registers",
            "simt": "float32, and Dh 32: f32 FMAs from shared memory"},
        "launches_by_instance": trained["routes"]["flash_attention_bwd"],
        "kernels_of_a_call": {
            "dot": "D = dO . O per row and head (both instances)",
            "dkdv": "dk, dv per 64 keys over the group's heads",
            "dq": "dq per packed query tile (wgmma) or 64 rows (simt)"},
        "ptxas": ptxas_report(fa.bwd_build_log, "flash_bwd_"),
        "shapes": bwd_timed,
        "train_step_ms": trained["step_ms_median_3_6"],
        "train_tokens_per_s": trained["tokens_per_s"]}

    phase_done("15")
    # phase 16: training mamba2 -- the SSD scan's backward kernel against
    # its plain version, timed at mamba2's and jamba's training shapes;
    # the float32 and bfloat16 2-layer gates; then mamba2-1.3b (cut to
    # `TRAIN_LAYERS`) at full
    # width through run_fixed, its main path (before the water-fill: the
    # profiler reads it)
    cfg = get_config(SSD_ARCH)
    ssd_bwd_timed, ssd_bwd_err = ssd_bwd_phase(so, dev)
    ssd_kernels = dict(kernels=("ssd", "ssd_bwd"), plain=plain_ssd)
    train_f32_gate(cfg, dev, launch_counts, **ssd_kernels)
    train_bf16_gate(cfg, dev, launch_counts, limits=(
        GATE_SSD_TRAIN_BF16_LOSS, GATE_SSD_TRAIN_BF16_GRAD), **ssd_kernels)
    cfg = cut_layers(cfg, TRAIN_LAYERS[SSD_ARCH])
    ssd_trained = train_phase(
        cfg, dev, launch_counts,
        {"ssd": (so.route_counts, "mma"), "ssd_bwd": (so.bwd_route_counts,
                                                      "mma")},
        per_step=training_launches(cfg),
        resume=False, profile_kernel="ssd_bwd_")
    main_shape = next(r for r in ssd_bwd_timed if r["ssd_bwd_case"] ==
                      f"mamba2-train-{TRAIN['batch']}x{TRAIN['seq']}")
    ssd_bwd_line = {
        "name": "ssd_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/ssd_bwd.cu",
        "replaces": "gradient of src/repro/kernels/ssd/ops.py:32 (no Pallas "
                    "backward)",
        "launches": ssd_trained["launch_counts"]["ssd_bwd"],
        "max_abs_err": ssd_bwd_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "device_ms": main_shape["device_ms"],
        "kernels_device_ms": main_shape["kernels_device_ms"],
        "instances": {
            "mma": "bfloat16, P and N 64 or 128, chunk a multiple of 64: "
                   "U_c on mma.sync; the scores C B^T once per group, then "
                   "the key-side and query-side tile passes on wgmma, a "
                   "head a warpgroup, tiles staged by TMA",
            "simt": "float32, and the shapes mma does not take: f32 FMAs "
                    "from shared memory"},
        "launches_by_instance": ssd_trained["routes"]["ssd_bwd"],
        "kernels_of_a_call": {
            "states": "U_c = sum exp(cum) dy^T C per chunk, and cum",
            "pass": "the state's gradient G_c walked back over the chunks",
            "scores": "C_i B_j^T and B_j C_i^T once per group (mma only)",
            "keys": "dx, ddt's direct part, dB per split of heads",
            "queries": "dC per split of heads, dcum",
            "dcum": "da, then ddt += A da and dA per chunk",
            "group_sums": "dB and dC over each group's splits",
            "head_sums": "dA and dD"},
        "ptxas": ptxas_report(so.bwd_build_log, "ssd_bwd_"),
        "tile_passes_ptxas": ssd_bwd_tile_passes(so),
        "shapes": ssd_bwd_timed,
        "train_step_ms": ssd_trained["step_ms_median_3_6"],
        "train_tokens_per_s": ssd_trained["tokens_per_s"],
        "train_peak_gb": ssd_trained["max_memory_allocated_gb"]}

    phase_done("16")
    # phase 17: training jamba -- the grouped matmul's backward kernel
    # against its plain version, timed at jamba's training products; one
    # full-width MoE layer forward and backward; one full-width period's
    # gradient in bfloat16 with the routes pinned; then the reduced jamba
    # through run_fixed, its main path (before the water-fill: the
    # profiler reads it)
    gmm_bwd_timed, gmm_bwd_err = gmm_bwd_phase(gm, dev)
    cfg = get_config(MOE_ARCH)
    moe_layer_phase(cfg, dev, tokens=MOE_TRAIN_TOKENS, train=True)
    period = period_grad_phase(cfg, dev, launch_counts, {
        "gmm": (gm.route_counts, "wgmma"),
        "gmm_bwd": (gm.bwd_route_counts, "wgmma"),
        "flash_attention": (fa.route_counts, "wgmma"),
        "flash_attention_bwd": (fa.bwd_route_counts, "wgmma"),
        "ssd": (so.route_counts, "mma"),
        "ssd_bwd": (so.bwd_route_counts, "mma")})
    jamba_trained = jamba_train_phase(dev, launch_counts, fa, so, gm)
    main_shape = gmm_bwd_timed[0]                   # gate/up
    gmm_bwd_line = {
        "name": "gmm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/gmm_bwd.cu",
        "replaces": "the gradient of src/repro/kernels/moe_gmm/ops.py:15 "
                    "(ragged_dot's VJP, no Pallas backward)",
        "launches": jamba_trained["launch_counts"]["gmm_bwd"],
        "max_abs_err": gmm_bwd_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "device_ms": main_shape["device_ms"],
        "kernels_device_ms": main_shape["kernels_device_ms"],
        "floor_device_ms": {w: main_shape[w]["floor_device_ms"]
                            for w in ("dlhs", "drhs")},
        "instances": {
            "wgmma": "bfloat16 with K, N multiples of 8: 128 x 256 "
                     "tiles on wgmma m64n256k16, clusters of two blocks "
                     "sharing one operand by TMA multicast, experts "
                     "slowest: dlhs a cluster per (expert, 128-row tile, "
                     "pair of K tiles) with the weights read K-major in "
                     "place, drhs a persistent grid walking (expert, pair "
                     "of K tiles, N tile) over the group's rows, TMA "
                     "stores; dout rounded to bfloat16 once",
            "simt": "float32, and bfloat16 TMA cannot take: f32 FMAs from "
                    "shared memory, dout float32"},
        "launches_by_instance": jamba_trained["routes"]["gmm_bwd"],
        "launches_by_instance_period": period["routes"]["gmm_bwd"],
        "kernels_of_a_call": {
            "dlhs": "dout rhs[e]^T per row tile (when lhs needs a gradient)",
            "drhs": "lhs[rows]^T dout[rows] per expert (when rhs needs one)"},
        "ptxas": ptxas_report(gm.bwd_build_log, "gmm_bwd_"),
        "shapes": gmm_bwd_timed,
        "train_step_ms": jamba_trained["step_ms_median_3_6"],
        "train_tokens_per_s": jamba_trained["tokens_per_s"],
        "train_peak_gb": jamba_trained["max_memory_allocated_gb"],
        "period_peak_gb": [period["peak_gb_kernels"],
                           period["peak_gb_plain"]]}

    phase_done("17")
    # phase 18: whisper-medium at full width (24 + 24 layers): the model
    # gates, the float32 loop's greedy tokens, then serving, its main path
    whisper = get_config(WHISPER_ARCH)
    whisper_served = modal_model_phase(whisper, dev, launch_counts, fa)
    flash_line["launches_whisper"] = whisper_served["launch_counts"][
        "flash_attention"]
    flash_line["launches_by_instance_whisper"] = whisper_served["routes"]

    phase_done("18")
    # phase 19: llava-next-mistral-7b at full width (32 layers, the
    # 576-position patch prefix): the same
    llava_served = modal_model_phase(get_config(VLM_ARCH), dev,
                                     launch_counts, fa)
    flash_line["launches_llava"] = llava_served["launch_counts"][
        "flash_attention"]
    flash_line["launches_by_instance_llava"] = llava_served["routes"]
    flash_line["modal_shapes"] = [{k: r[k] for k in (
        "flash_case", "instance", "shape", "ms", "device_ms", "plain_ms",
        "bound_ms", "bound_by", "bound_share", "device_bound_share",
        "library_ms", "library_device_ms", "max_abs_err")}
        for r in modal_shapes]

    phase_done("19")
    # phase 20: training whisper -- the 2 + 2-layer gates, then run_fixed
    # at full depth, its main path (its encoder's backward is timed in
    # phase 15)
    whisper_trained = whisper_train_phase(whisper, dev, launch_counts, fa)
    bwd_line["launches_whisper"] = whisper_trained["launch_counts"][
        "flash_attention_bwd"]
    bwd_line["launches_by_instance_whisper"] = whisper_trained["routes"][
        "flash_attention_bwd"]
    bwd_line["whisper_train_step_ms"] = whisper_trained["step_ms_median_3_6"]
    bwd_line["whisper_train_tokens_per_s"] = whisper_trained["tokens_per_s"]

    phase_done("20")
    # phases 21-24: granite-8b, starcoder2-7b, qwen3-32b and llama4-scout
    # (8 of its 48 layers) at full width: the 2-layer (llama4: 4-layer)
    # gates, the float32 engine's greedy tokens, llama4's window binding
    # and expert products, then serving, their main path
    for phase, (name, gate_layers, serve_layers) in enumerate(CONFIGS, 21):
        served = config_phase(name, gate_layers, serve_layers, dev,
                              launch_counts, fa, gm)
        flash_line[f"launches_{name}"] = served["launch_counts"][
            "flash_attention"]
        flash_line[f"launches_by_instance_{name}"] = served["routes"][
            "flash_attention"]
        if "gmm" in served:
            gmm_line[f"launches_{name}"] = served["launch_counts"]["gmm"]
            gmm_line[f"launches_by_instance_{name}"] = served["routes"][
                "gmm"]
            gmm_line[f"shapes_{name}"] = [{k: r[k] for k in (
                "gmm_case", "route", "shape", "ms", "stream_ms", "plain_ms",
                "bound_ms", "bound_by", "bound_share", "library_ms",
                "max_abs_err")} for r in served["gmm"]]
        phase_done(str(phase))
    flash_line["config_shapes"] = [{k: r[k] for k in (
        "flash_case", "instance", "shape", "ms", "device_ms", "plain_ms",
        "bound_ms", "bound_by", "bound_share", "device_bound_share",
        "library_ms", "library_device_ms", "max_abs_err")}
        for r in config_shapes]

    # phases 3 and 4, run last: the water-fill's cases, cycles and
    # candidates, then the days through run_policy (once the tier-1m
    # case has run the profiler reads no device events in this process,
    # so every phase that reads it runs first; these time device work by
    # queued_ms)
    waterfill_line = run_waterfill_phase()
    phase_done("3, 4")
    # phase 25: the pool service on the water-fill kernel, and its command
    # line (no profiler: it may run after the water-fill's phases)
    service = service_phase(launch_counts)
    waterfill_line["launches_service"] = service["waterfill_launches"]
    phase_done("25")
    # phases 26-28 and 30 in one world of 8 ranks that share the card
    # (gloo): parallel/ -- expert-parallel MoE, sequence-parallel
    # attention, the sharded and the int8-compressed train steps; elastic
    # training and serving under a mesh; the "model" cut; the prefill's
    # rows cut over the mesh
    by_part = parallel_phase()
    for line, name in ((flash_line, "flash_attention"),
                       (bwd_line, "flash_attention_bwd"),
                       (gmm_line, "gmm"), (gmm_bwd_line, "gmm_bwd")):
        line["launches_parallel"] = sum(
            counts[name] for part, counts in by_part.items()
            if part not in MESH_PARTS + TP_PARTS + ROWS_PARTS)
    for part in MESH_PARTS:
        flash_line[f"launches_{part}"] = by_part[part]["flash_attention"]
    bwd_line["launches_elastic"] = by_part["elastic"]["flash_attention_bwd"]
    flash_line["launches_tp_serve"] = by_part["tp_serve"]["flash_attention"]
    ssd_line["launches_tp_serve"] = by_part["tp_serve"]["ssd"]
    ssd_line["launches_tp_train"] = by_part["tp_train"]["ssd"]
    ssd_bwd_line["launches_tp_train"] = by_part["tp_train"]["ssd_bwd"]
    for line, name in ((flash_line, "flash_attention"), (ssd_line, "ssd"),
                       (gmm_line, "gmm")):
        line["launches_prefill_rows"] = by_part["prefill_rows"][name]
    phase_done("26-28, 30")
    # phase 29: the dry-run's command line on this host, then phase 15's
    # step analysed and held against what phase 15 measured
    dryrun_cli_phase()
    dryrun_step_phase(train_cfg, trained, card)
    phase_done("29")
    print(json.dumps({"profiler_sessions": profiler_sessions}), flush=True)
    print(json.dumps({"kernels": [waterfill_line, flash_line, ssd_line,
                                  gmm_line, bwd_line, ssd_bwd_line,
                                  gmm_bwd_line]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
