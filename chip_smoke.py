#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero):

1. build: compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   for sm_90a, one nvcc per source, all at once; print ptxas's registers,
   spills and the dynamic shared memory of flash_attention's wgmma kernels,
   and fail unless ``cuobjdump -sass`` of the flash library holds HGMMA
   (tensor cores) and UTMALDG (TMA) instructions; then each paged_attention
   instantiation by name (the tensor-core kernel per head_dim for bf16 K/V
   and for e4m3 K/V under a float32 or bf16 q; the float32 CUDA-core kernel
   per head_dim and group) with its registers, spills, shared memory and
   CTAs per SM, failing if a tensor-core one that Llama (d 128) or
   qwen3-32b (d 80) decode runs, from a bf16 or an e4m3 cache, spills or
   the paged library's SASS holds no HMMA and LDSM instruction; then each ssd_chunk instantiation
   (B/C float32, bfloat16) the same way, failing if the bf16 one spills or
   the ssd_chunk library's SASS holds no tensor-core (HMMA) instruction;
   then flash_attention_bwd's kernels: the wgmma route's dK/dV and dQ at
   d 64, 80 and 128 with their registers, spills and dynamic shared memory,
   failing on a spill or a library whose SASS lacks HGMMA and UTMALDG; the
   CUDA-core route's three kernels per dtype (a spill there is printed);
   then ssd_chunk_bwd's three kernels per B/C dtype with their registers,
   spills and shared memory, the main kernel's CTAs per SM, failing if the
   main kernel spills or its SASS holds no tensor-core (HMMA) instruction,
   for either B/C dtype.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the paths give it (Llama-3.1-8B: 32 layers, 8 kv heads,
   head_dim 128; 1024-token prompts = 64 pool blocks; max_len 2048; decode
   at a context of 1040 tokens. Mamba-2 2.7B: chunks of 256, 80 heads of 64,
   d_state 128, prompts of 1024 and 4096 tokens. The sparse gather: the
   16-token reads of phase 6, 8,192 pieces of 256 B from the Llama-3.1-8B
   pool and 16,384 of 160 B from a qwen3-32b pool of 512 blocks, with ids
   -1, -N, N and 2**31 - 1 added, then exp10's top-k read of 4,096 rows of
   1,280 B; the Llama read is also timed replayed from one captured CUDA
   graph, beside the empty kernel on its grid). Gather, scatter and the
   sparse gather (its NaN fill and negative-id wrap included) must be
   bit-exact; flash attention within bf16 2e-2 (tests/test_kernels.py), its wgmma route at
   the main path's shape and at the ragged, GQA and non-causal shapes of
   FLASH_SHAPES (phase 16's head shards of olmo-1b among them), and its
   CUDA-core route on the main path's inputs;
   paged attention within two bf16 steps at its largest output (also at
   contexts {0, 17, 1040} in one batch, 1 and the full table, with its
   split plan checked: every CTA has work and every cluster is resident,
   and one device kernel per call under torch.profiler), ssd_chunk
   within 1e-4 of its output's scale at 1024 and 4096 tokens, and at the
   training call whole and as a phase 16 rank's 20 of its 80 heads (both sides
   get the same inputs, so the limits sit a few times above the readings)
   and its prefix sums within 1e-6 of torch.cumsum's; its bound is the
   larger of its bytes and its operations at the tensor-core peak of their
   type; its human-readable line also prints the same operations over the
   float32 CUDA-core peak, computed, not timed. Each is timed with CUDA events
   against its plain version, its bound and, where one PyTorch call computes
   the same thing, that call (``scaled_dot_product_attention`` for the
   attention kernels, ``index_select`` for the sparse gather; timed only, the
   port never calls them); flash's row also gives the CUDA-core route's time
   on the same inputs and the wgmma route's TFLOP/s. The MoE and hybrid
   paths' shapes get rows of their own under ``shapes``, checked under the
   same limits and timed the same way: flash and paged attention at
   Arctic's GQA group of 7 (56 / 8 heads; 1024 tokens, decode context 1040)
   and Jamba's group of 8 at 64 / 8 heads (1000 tokens, context 1016), d
   128, at qwen3-32b's group of 8 at 64 / 8 heads, d 80, at internvl2-26b's
   group of 6 (48 / 8 heads, d 128) and at musicgen-large's group of 1 (32
   / 32 heads, d 64) (1024 tokens, context 1040); ssd_chunk at Jamba's 256
   heads (1024 tokens). The fp8 KV cache: paged attention's e4m3
   instantiation (a bf16 q over e4m3 K/V) at Llama's group 4, d 128 and
   qwen3-32b's group 8, d 80 (context 1040) within the same two bf16 steps,
   its bound at one byte a K/V element and SDPA timed on the same cache
   dequantized to bf16 (a reference on other inputs); gather and scatter on
   an e4m3 qwen3-32b cache (64 layers), bit for bit. exp10's top-k read is
   also timed over 96 seeded sources in turn (63 MB, above L2) beside its
   byte bound. flash_attention_bwd against flash_attention_bwd_ref at the
   training path's shape (olmo-1b: b 4, 2048 tokens, 16 heads at d 128,
   causal, bf16), Llama's group 4 and qwen3-32b's group 8 (d 80) at 1024
   tokens, in float32, and at every ragged and non-causal shape of
   FLASH_SHAPES, on each route that takes the inputs (wgmma: bf16 at d 64,
   80, 128; cuda_cores: all), its gradients within FLASH_TOL (bf16) or
   F32_GRAD_TOL (float32) of the largest |gradient|, the wgmma route rerun
   bit for bit; the forward's stored log-sum-exp against
   flash_attention_lse_ref's on both routes (LSE_TOL); each route timed
   against the plain version, its bound (2.5 times the forward's operations
   at 989 TFLOP/s) and the backward of ``scaled_dot_product_attention``
   under autograd (timed only), the wgmma route at the training shape
   within BWD_TRAIN_MS.
3. small: reduced Llama-3.1-8B and Arctic-480B and a narrow qwen3-32b
   (head_dim 80, group 8, d_model 640, 2 layers) in float32 served cold and
   warm on the card (kernels) and on the CPU (plain versions) with the same
   weights, and reduced Mamba-2 2.7B, Jamba-1.5-Large, musicgen-large (70
   seeded audio frame embeddings) and internvl2-26b (8 seeded patch
   embeddings before 70 tokens) in float32 prefilled and decoded on both;
   the per-step logits must agree within 1e-4; the attention prefills' flash
   calls (float32) take the cuda_cores route. Then reduced Llama-3.1-8B
   with an fp8 KV cache, the same: the prefill's e4m3 caches bit for bit,
   the logits within FP8_SMALL_TOL. Then one float32 train step of reduced
   olmo-1b and Llama-3.1-8B (``make_train_step``, AdamW, remat "full") on the
   card (the forward kernel with its log-sum-exp twice a layer, the backward
   kernels once) and on the CPU from the same weights and batch: loss, grad
   norm, every gradient leaf and the updated weights within SMALL_TOL. Then
   a reduced float32 mamba2-2.7b resumed on the card: 4 steps through
   ``run_train_loop`` saving a checkpoint (``checkpoint/checkpointer.py``),
   a restore into fresh tensors and 4 more steps (``ssd_chunk`` and
   ``ssd_chunk_bwd`` launched), equal to an unbroken 8 bit for bit.
4. main path: full-width Llama-3.1-8B (random weights from a seed, bf16)
   served through ``RealEngine`` (kernels for tensors on the card): two cold
   prompts, two that hit a 512-token shared prefix, two full repeats. Checks
   hit counts, that the cache restored from the pool equals the KV prefill
   wrote bit for bit, that warm logits agree with cold ones and with a
   fresh prefill, and that every kernel of the path was launched during the
   run, paged attention 32 times per decode step and flash attention 32
   times per cold request, all on the wgmma route; then a profiled cold
   request (prefill, writeback, first token) and a profiled window of
   decode steps show where TTFT and a step's time go (the window must hold
   32 paged kernels a step: one launch per layer).
5. Mamba-2 path: full-width mamba2-2.7b (64 layers, bf16, random weights
   from a seed under the JAX init rules): prefill of 1000 and 4095 tokens,
   each followed by 16 greedy decode steps, through ``Model``. Checks finite
   logits, 64 ssd_chunk launches per prefill, the final SSM state against
   the plain path's, and continuity: prefill of 4095 tokens then one decode
   step against a prefill of all 4096, beside the noise floor of the same
   prefill with the plain ssd_chunk, in float32 and in bf16 (see
   CONTINUITY_TOL). Each prefill's wall time is the median of five runs
   after a warm-up, with its spread, outside the counted run and every
   profiler window; then profiled prefills of both prompts and decode.
6. sparse reads: the port's twin of exp10 (Table 6), then of exp09
   (Fig. 14), on the card. exp10: full-width qwen3-32b at depth 1 (layer 0
   is all it reads) selects the top-32 of 256 tokens per query head and
   gathers those rows of K and V in one launch; then 16 sparse tokens per
   (layer, kv head) are read in ONE launch from phase 4's Llama-3.1-8B pool
   (checked against the cold prefill's KV bit for bit) and from a seeded
   qwen3-32b pool of 512 blocks. exp09: one block of each bf16 layout
   written and read back, and the one-launch check. Checks one launch per
   read, bit-exact pieces, finite scores; prints the rows (the fabric rows
   are MODELED by the paper's CXL/RDMA constants, not measured).
7. Arctic-480B path (phase 4's engine freed first): full width (d 7168,
   56 / 8 heads, 128 experts top-2, d_ff 4864, dense residual 4864, bf16,
   random weights from a seed), depth cut to 2 layers (about 55 GB),
   served through ``RealEngine`` with a pool of 512 blocks: two cold
   1024-token requests, a partial hit on a 768-token shared prefix and a
   full repeat, 16 new tokens each. Checks hit counts, the restored cache
   bit for bit, the launches (flash 2 per cold request, all wgmma; paged 2
   per decode step; gather 1 per cold request; scatter 1 per hit), and the
   per-step logits against the same requests through the plain versions on
   the card (printed: that noise floor); prints the dropped (token, k)
   pairs per MoE layer of each cold prefill, TTFT cold / partial / full,
   decode tokens/s, peak memory, and a profiled cold request and decode
   window.
8. Jamba-1.5-Large path: full width (d 8192, 64 / 8 heads, d_ff 24576, 256
   SSD heads of 64, d_state 128, bf16), cut to one period of 8 layers and
   8 of its 16 experts, top-2 kept (about 52 GB), through ``Model``: a
   1000-token prefill and 16 greedy decode steps. Checks finite logits,
   ssd_chunk 7 and flash 1 per prefill and paged 1 per decode step, the
   final SSM states against the plain path's, and continuity at a capacity
   factor of 8.0 beside its noise floor, as phase 5 does; prints the
   dropped pairs, the prefill's median of 5 with its spread, decode
   tokens/s, peak memory and profiled windows.
9. qwen3-32b path (phase 8's model freed first): full width (d 5120, 64 /
   8 heads at head_dim 80, d_ff 25600, vocabulary 151936, bf16, random
   weights from a seed), depth cut to 16 of 64 layers (about 17.6 GB),
   served through ``RealEngine`` with a pool of 512 blocks: two cold
   1024-token requests, a partial hit on a 768-token shared prefix and a
   full repeat, 16 new tokens each. Checks hit counts, the restored cache
   bit for bit, the launches (flash 16 per cold request, all wgmma at d 80;
   paged 16 per decode step, one a layer; gather 1 per cold request; scatter
   1 per hit), and the logits at every step against the same requests
   through the plain versions on the card, their decode fed the kernel
   path's tokens, within 0.5; prints TTFT cold / partial /
   full, decode tokens/s, peak memory, and a profiled cold request and
   decode window (16 paged kernels a step).
10. qwen3-32b with an fp8 KV cache (phase 9's model freed first): the same
   config and cut, through ``Model`` with ``RuntimeConfig(use_fp8_kv=True)``:
   a 1024-token prefill and 16 greedy decode steps (``model_path``). Checks
   the caches are float8_e4m3fn, flash 16 per prefill (wgmma), paged 16 per
   step, all of the e4m3 instantiation, and the kernel path's logits against
   the plain path's at every step, each step on a copy of the kernel path's
   cache (FP8_LOGIT_TOL); prints the logits' gap against the same model
   with a bf16 cache fed the same tokens (relative to their largest), the
   cache's bytes against bf16's, TTFT, decode tokens/s, peak memory and a
   profiled decode window.
11. internvl2-26b (phase 10's model freed first): full width (d 6144, 48 /
   8 heads at d 128, d_ff 16384, vocabulary 92553, bf16), all 48 layers
   (19.9 B parameters), through ``Model``: 256 seeded patch embeddings and
   768 text tokens, then 16 decode steps from token embeddings at
   positions 1024 on. The checks of phase 10 (a bf16 cache), the logits
   within DEEP_LOGIT_TOL; prints TTFT, decode tokens/s and peak memory.
12. musicgen-large: full width (d 2048, 32 / 32 heads at d 64, d_ff 8192,
   gelu, vocabulary 2048), all 48 layers (3.2 B parameters): 1024 seeded
   audio frame embeddings, then 16 decode steps, as phase 11.
    The SSD backward ``ssd_chunk_bwd`` against ``ssd_chunk_bwd_ref`` at
   SSD_BWD_SHAPES: mamba2-2.7b's training call (32 chunk tiles of 256, 80
   heads of 64, d_state 128, one bf16 group) and a phase 16 rank's 20 of
   its heads, Jamba's 256 heads, a ragged
   chunk of 100, two groups, float32 B/C, with and without dcum, decays
   strong enough that exp above the diagonal would overflow: dx and da
   within SSD_TOL of their scale, dB and dC within one rounding of the f32
   result, a second call equal bit for bit; timed at the training shape, its
   shard and Jamba's beside the plain version and the bound, the training shape at
   or under SSD_BWD_TRAIN_MS.
13. training (phase 12's model freed first): olmo-1b at full width and depth
   (d 2048, 16 / 16 heads at d 128, d_ff 8192, vocabulary 50304, tied
   embeddings, non-parametric norms, 16 layers, 1.18 B parameters, bf16)
   through ``Model.loss_fn``, ``make_train_step`` and ``run_train_loop``,
   remat "full", ``OptimizerConfig()`` (AdamW, bf16 gradient compression),
   ``SyntheticLM`` batches of 4 x 2048 tokens. (i) one step on the kernel
   path against the same step with the plain versions (kernel_mode="ref")
   from the same weights and batch: loss, every gradient leaf and the
   updated weights within the TRAIN_* limits, the grad norm on each of
   batches 0-2 within TRAIN_NORM_TOL; at layers 0, 7 and 15, on batch 0's
   captured backward inputs, each backward route's dq, dk and dv against
   the float64 backward (``experiments/train_bwd_probe.py``): the RMS
   relative error within BWD_F64_RMS_RATIO of the float64 result's own
   bf16 rounding, the bias within BWD_F64_BIAS, and a planted fault (each
   head's last diagonal tile dropped) refused by the same check; one step of
   ``run_train_loop`` (in place) equal to the pure step bit for bit; (ii)
   8 steps through ``run_train_loop``: finite losses and grad norms, 32
   flash forward launches a step (16 and 16 recomputed, wgmma), 16 of each
   backward kernel (wgmma), no pool, paged or SSM kernel; step time,
   tokens/s, the model-FLOP share of 989 TFLOP/s and peak memory; the same
   8 steps as pure steps: weights and moments equal bit for bit, the pure
   step's peak printed beside the loop's; (iv) the same run killed and
   resumed: from a clone of the same weights and a fresh ``SyntheticLM``,
   ``run_train_loop`` to step RESUME_AT saving a checkpoint there (the
   Checkpointer's sync save, timed), the tensors dropped, the checkpoint
   restored into fresh tensors with the data state (timed) and run on to
   step 8: weights, both moments and step equal (ii)'s and the losses and
   grad norms of steps 5-8 equal (ii)'s, bit for bit; then an async save
   of that state, ASYNC_STEPS steps in place while its thread writes (the
   median step beside (ii)'s), and the saved step restored in place equal
   to (ii)'s state again; the bytes on disk, save and restore GB/s, the
   save's blocking time and wall time, the disk's free space and the peak
   printed; one checkpoint on disk at a time, in a ``tempfile.mkdtemp()``
   directory removed at the phase's end; a profiled step; (iii) 5 steps
   on one repeated batch at peak_lr 1e-3 (no warmup): the last loss below
   the first.
14. Mamba-2 training (phase 13's model freed first): mamba2-2.7b at full
   width and depth (d 2560, 64 layers, 80 SSD heads of 64, d_state 128, one
   group, chunk 256, vocabulary 50280, tied embeddings, 2.70 B parameters)
   through ``Model.loss_fn`` and ``run_train_loop``, remat "full",
   ``OptimizerConfig()``, phase 13's batches of 4 x 2048 tokens. (i) float32
   weights: one gradient on the kernel path (``ssd_chunk`` forward and the
   ``ssd_chunk_bwd`` kernel) against the plain path (kernel_mode="ref"),
   the first path's gradients parked on the host: the loss within
   SSM_LOSS_TOL and every gradient leaf within SSM_GRAD_TOL of its largest
   entry, limits set from ``experiments/ssd_train_probe.py``'s readings; the
   kernel built with a planted fault (SSM_FAULT) refused by the same limit;
   at layers 0, 31 and 63 each layer's own backward call against the
   float64 ``ssd_chunk_bwd_ref`` on its captured inputs, within SSM_F64_TOL,
   the fault refused there too. (ii) bf16: 8 steps through
   ``run_train_loop`` in place: finite losses and grad norms, 128 forward
   and 64 backward SSD launches a step, no attention, pool, paged or sparse
   kernel; step time, tokens/s, the model-FLOP share of 989 TFLOP/s (the
   SSD's FLOPs stated) and peak memory; a profiled step by kind of kernel.
   (iii) 5 steps on one repeated batch at peak_lr 1e-3: the last loss below
   the first. The pure step is not run at this size (a second 30 GB of
   weights and moments); its equality with the in-place loop is phase 13's
   check and a ``gpu`` test's on a reduced mamba2.
15. the model under a device mesh (phase 14's model freed first;
   ``experiments/mesh_probe.py``): each run's single-device reference on the
   same weights first, kept on the host and freed; then ONE world of 4
   gloo ranks on the card (``distributed.world.run_world``), every rank on
   its shards: the collectives on CUDA tensors against CPU tensors; (i)
   Llama-3.1-8B, all 32 layers, mesh 1x4, a 1024-token prompt and 16 greedy
   steps through ``launch.generate.mesh_generate`` with the
   pool-interleaved KV decode (flash on 8 q / 2 kv heads a rank, the paged
   kernel with its lse on a quarter of the sequence, merged by
   log-sum-exp); (ii) the same at 4 of 32 layers on mesh 2x2, 2 prompts
   (FSDP gathers and the batch over data); (iii) arctic-480b, 1 of 35
   layers, mesh 1x4, the a2a dispatch (32 experts a rank), a 1024-token
   prefill at capacity 8.0 (nothing dropped) and at the published 1.25
   (dropped pairs printed); (iv) mamba2-2.7b, 8 of 64 layers, mesh 1x4,
   20 SSD heads a rank through ``ssd_chunk``, 1000 tokens and 16 steps,
   against one device on the tp-4 layout (vocab 50304). Logits, greedy
   tokens and arctic's outputs at the tokens routed alike within limits
   set from readings; each rank's launches as the path says; per-rank
   peaks and the phase's wall time printed.
16. training under a device mesh (phase 15's world ended first;
   ``experiments/mesh_train_probe.py``): each run's one-device reference
   on the same weights and phase 13's batches (4 x 2048 tokens from batch
   1 on), ``OptimizerConfig()``, remat "full" (olmo-1b's is phase 13's
   run: its loss must equal phase 13 (ii)'s first, bit for bit), its weights
   parked on disk; then ONE world of 4 gloo ranks on the card, every rank on
   its shards: the collectives' forwards and backwards on CUDA tensors
   against CPU tensors; (i) olmo-1b, all 16 layers, mesh 1x4 (4 heads a
   rank), 4 AdamW steps; (ii) olmo-1b, 4 of 16 layers, mesh 2x2 (FSDP over
   data, 2 rows a rank), 4 steps, then a checkpoint written by the 4 ranks
   (one proc_<rank>.npz of shards each), restored here on one device equal
   to every rank's shards bit for bit (sha1 of each), its save and restore
   GB/s printed as disk and host I/O of 4 processes on one machine; (iii)
   mamba2-2.7b, 8 of 64 layers, mesh 1x4 (20 SSD heads a rank), 2 steps.
   Every rank reports the same losses and grad norms; each step's loss and
   grad norm, and each rank's f32 AdamW moments m and v after the last step
   (relative to each leaf's largest entry: they carry every step's gradient
   at full precision, where a bf16 weight after four steps at lrs of 1.2e-5
   or less is one rounding step off whatever the gradient), within limits
   set from readings over 3 seeds; each rank's launches a
   step as the path says (flash 32 on wgmma, its backward 16; ssd_chunk 16,
   ssd_chunk_bwd 8), nothing else; per-rank peaks, the steps' and the
   world's wall times printed (gloo through host memory with 4 CUDA
   contexts on one card: no multi-GPU time and no tokens/s).
17. the roofline held against the card (``launch/``: the launch tooling;
   phase 16's world ended first): ``steps.build_cell`` on one device at
   full width for olmo-1b training (4 x 2048, all 16 layers, remat
   "full", AdamW in place), a 1024-token Llama-3.1-8B prefill, one Llama
   decode step at context 1040 (all 32 layers) and a 1000-token mamba2-2.7b
   prefill (64 layers). Each cell's second call (the first builds the
   kernels and a decode's block table) is counted by
   ``op_analysis.OpAnalyzer`` on ``meta`` (a dry run: nothing launched) and
   on the card: the two counts equal exactly (every (aten op, input shapes,
   dtypes), FLOPs, bytes, transcendentals, kernel entries), the kernel
   entries equal the delta of ``ops.launch_counts()``, and the FLOPs of
   every aten op ``torch.utils.flop_counter.FlopCounterMode`` knows equal
   the analyzer's on the same call. The median of ROOFLINE_RUNS
   synchronised calls, timed outside the analyzer, against the as-counted
   bound max(FLOPs / 989e12, bytes / 3.35e12) (the share may not pass
   ROOFLINE_SHARE_MAX: the count would overstate the work) and the useful
   one (``dryrun.model_flops`` + ``attn_model_flops``,
   ``roofline.useful_bytes``); ``torch.cuda.max_memory_allocated()`` of the
   call against the analyzer's peak of live bytes within ROOFLINE_PEAK_RATIO.
18. the cluster simulator, on the card's host (``serving/scheduler.py``,
   ``kvcache/``; nothing launched): the exp05 twin at the paper's own size,
   256 closed-loop clients, 16 engines, 15,000-token prompts, a pool of
   262,144 Qwen3-32B blocks (payload-free, on ``meta``), for vllm / rdma /
   beluga, each a populate then a cache-hit phase. Fails unless every
   request finishes, every pool block's refcount is back to what the index
   owns (and every HBM slot is free), each summary number equals
   ``exp05_e2e.PINNED`` (the JAX package's numbers at this size, held by
   ``tests/test_torch_cluster.py``: integers exactly, times within 1e-12
   relative), and beluga's cache-hit TTFT is below rdma's. Prints the
   MODELED Table 5 rows and the phase's wall seconds, beside no card's
   name: the simulator runs where no JAX exists.
19. the tiered pool (``tiering/``). (i) On the card's host, nothing
   launched: the exp13 twin at full size (four sweep cells, two chain
   cells, the zero-cost check), then the exp03 and exp04 twins. Fails
   unless every request finishes, after every cell each pool block's
   refcount is what the index owns and ``promote_pending`` names only live
   refcount-1 blocks, each number equals ``exp13_tiering.PINNED`` (the JAX
   package's: integers exactly, times within 1e-12 relative), and the
   three-tier chain beats destroy-on-evict at 2x and 4x oversubscription;
   exp03's interleaved queues must beat the non-interleaved ones and
   exp04's p99 must rise with the background. Prints the MODELED rows,
   beside no card's name. (ii) Tier migrations of real KV payloads on the
   card: a ``TieredPool`` on ``cuda`` at the Qwen3-32B layout (2.5 MiB a
   block), fast 512, spill 512 (RDMA DRAM), SSD 2048: 3,072 blocks, 7.5
   GiB. The churn protocol of ``experiments/tier_churn.py`` (writebacks of
   distinct seeded bytes a key, planned fetches, LRU and targeted
   evictions, the migrator stepped after each) must balance the books after
   every operation, demote, promote and write the SSD tier, place the block
   ids and count the ``TierStats`` of ``tier_churn.PINS`` (the JAX
   package's payload-free run), read every indexed block back through
   ``PoolTransfer.scatter_read`` equal to its key's bytes bit for bit, and
   free every block on a full eviction. The migration copies (HBM to HBM on
   the card; the spill media's latency is MODELED and is not this number)
   are timed with CUDA events and printed as GB/s beside the copy bound
   (2 x bytes / 3.35 TB/s), the card's name and power limit.
20. the CXL-RPC metadata plane served by threads and by processes
   (``core/{rpc,wire,procserver}.py``, ``experiments/ring_serve.py``). (i)
   On the card's host: exp05's beluga mode at Table 5's size with
   ``index_rpc`` over 1 and 4 rings, each summary number equal to
   ``exp05_e2e.PINNED`` (the in-process reference; the per-shard entries
   summing to the total), every refcount back to the index's, no round trip
   failed, every server thread stopped; exp11's thread rows, its process
   rows (one spawned service process a shard) and its chaos sweep (a
   watched shard killed under load), host wall time of the card's machine,
   every round trip answered and the chaos shard recovered; exp01 and
   exp02, MODELED. (ii) Llama-3.1-8B at full width, all 32 layers: phase 4's six
   requests behind one ring, and its requests 0, 1, 4 and 5 (the two cold
   requests and the two full hits; the partial-hit tails, which decode
   token by token, only over the one ring) behind 4 rings, on a
   ``RealEngine`` of phase 4's seed, each run on a fresh pool, the
   engine's ``index`` field the client side of the rings
   (``core/wire.ring_plane``, one server thread a ring).
   Fails unless each run hits as phase 4 wants and gives the tokens, pool
   block ids and epochs of phase 4's run (its index a ``PrefixIndex`` in
   process, on a fresh pool), and its logits bit for bit; prints each
   request's TTFT, ring round trips, the clients' mean wait and the index
   calls' share of the TTFT. (iii) On the one-ring
   run's pool, its two full hits under a ``FaultPlan``: clean three times,
   then under a 1 ms delay window (the tokens and logits unchanged; the
   index calls' time outside their round trips at least posts x 1 ms above
   their fastest clean run's; the TTFTs printed beside the clean median),
   then under a 50 ms drop window, inside ``RingRetryPolicy``'s budget (the
   match retried, the tokens unchanged). (iv) The same engine on a fresh
   pool whose metadata is shared, its index behind one shard service
   process (spawned) under a ``ShardWatchdog`` with no probe thread: phase
   4's requests 0, 1, 4 and 5 (two cold, two full hits), which must give
   phase 4's tokens, pool block ids, epochs and logits bit for bit in
   round trips [2, 2, 1, 1]; then ``kill -9`` of the service, one
   ``check`` that respawns it from its journal, and the two full hits
   again, 1024 of 1024 tokens hit and logits bit for bit; exactly one
   restart, every kernel of the path launched, and after ``close`` no
   child running and every segment and FIFO unlinked. Prints the respawn's
   wall time and the journal records it replayed, each full hit's TTFT in
   process, over the thread ring and over the process ring, the process
   ring's share of the hit TTFT and its mean wait, beside the card's name
   and power limit. Prints the phase's wall time.
21. the shared data plane and the engine worker processes
   (``core/shmpool.py``, ``serving/engineproc.py``,
   ``experiments/exp14_procengine.py``), on the card's host: prints
   ``/dev/shm``'s free bytes, then exp14 at its full size (160 requests of
   4096 tokens, 4096 pool blocks of 32 KiB: a 128 MiB segment). Fails
   unless the private in-process, shared in-process and one-worker runs give
   the same ``run()`` dict and its parity numbers equal
   ``exp14_procengine.PINNED["full"]`` (the JAX package's run; integers
   exactly, times within 1e-12 relative); unless at N = 1, 2 and 4 workers
   every request is done, every pool refcount is accounted for (the
   index's, or a block another worker's publish of the same key replaced)
   and no block moved twice (bytes moved at most N = 1's); unless the chaos
   drill (``chaos_sweep(fast=True)``: a worker killed, the allocator moved
   to a fresh ring) restarts each once and finishes every request; and
   unless afterwards no segment or FIFO any run made is left and no child
   process lives. Prints the sweep's and the drill's rows, host wall time
   of the card's machine beside the card's name and power limit (the
   parity numbers are the simulator's virtual time: MODELED), and the
   phase's wall time.

Prints the kernel table as one JSON line (the e4m3 paged instantiation as
a row of its own, ``paged_attention_e4m3``, and the attention backward as
``flash_attention_bwd``, its launches from phase 13, and the SSD backward
as ``ssd_chunk_bwd``, its launches from phase 14; each row's launches by
path, ``mesh_train`` among them: rank 0's in phase 16, ``ring`` phase
20 (ii)-(iii)'s, ``ring_process`` (iv)'s),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Without a GPU it exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.mesh import (  # noqa: E402; one H100 SXM's data sheet
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOP_PER_S,
    PEAK_FLOPS_F32 as F32_FLOP_PER_S, PEAK_FLOPS_TF32 as TF32_FLOP_PER_S)


# the timing helpers import torch when first called, not with this module: a
# spawned child (phase 20's shard services) imports this file as its main
# module and must stay light
def cycled_ms(*args, **kwargs):
    from repro_torch.experiments import common

    return common.cycled_ms(*args, **kwargs)


def device_ms(*args, **kwargs):
    from repro_torch.experiments import common

    return common.device_ms(*args, **kwargs)


def rounding_steps(*args, **kwargs):
    from repro_torch.experiments import common

    return common.rounding_steps(*args, **kwargs)


FLASH_TOL = 2e-2  # bf16, tests/test_kernels.py:42
# paged attention, bf16: kernel and plain version take the same inputs and
# both accumulate in f32, so they differ only where the two f32 results round
# to neighbouring bf16 values; the limit is two such steps at the largest
# output (about 2e-3 at ctx 1040), far below what a dropped block moves
PAGED_ULPS = 2
# ssd_chunk, relative to the output's scale: the same f32 x and bf16 B/C on
# both sides, f32 accumulation, so only the summation order differs (about
# 1e-5); rounding x to bf16 or to TF32 inside the kernel would read above it
SSD_TOL = 1e-4
# ssd_chunk's prefix sums against torch.cumsum of the same a, relative to the
# largest |cum|: a warp's shuffle scan and torch's sum in other orders, 256
# float32 terms at most
CUM_TOL = 1e-6
SMALL_TOL = 1e-4  # float32 reduced model, card vs CPU
# float32 reduced model decoding from an fp8 cache, card vs CPU: both decode
# attentions round P to bf16 (JAX's contract for an fp8 cache), the kernel a
# tile's unnormalised P and the plain version the normalised one, so the
# logits differ by such roundings: 3e-4 to 5e-4 in the first readings
# (tests/test_torch_gpu.py), where a bf16 cache's stay under 1e-6
FP8_SMALL_TOL = 2e-3
# warm vs cold logits at full width, bf16 (logit std about 1.3): the two
# paths round the bf16 residual stream at different points (a 1024-row
# prefill GEMM + flash kernel vs one-token decode over the restored cache)
# through 32 layers, and later steps inherit the difference. Logits of an
# unrelated context differ by about 9 at the max. The run also prints the
# noise floor: the same prefill with the plain attention in place of the
# kernel.
LOGIT_TOL = 0.5
PROMPT, SHARED, MAX_LEN, POOL_BLOCKS, MAX_NEW = 1024, 512, 2048, 512, 16
DECODE_CTX = 1040  # a 1024-token prompt and 16 decode steps
# phase 15 (i): Llama's 1088-position cache (1024 + 17 rounded up to whole
# blocks of 16 on each of 4 shards) is 272 positions a rank
MESH_SHARD = 272
# paged_attention's lse against the plain version's, absolute on values of
# 1-10: f32 sums in other orders (tests/test_torch_gpu.py)
PAGED_LSE_TOL = 1e-4
# the wgmma route against the plain version beside the main path's shape:
# (b, sq, skv, hq, hkv, d, causal); d 64 and 128, several K/V tiles, ragged
# lengths, sq != skv under the causal mask, non-causal, b 2, groups 1, 4, 8
FLASH_SHAPES = (
    (1, 2048, 2048, 8, 1, 128, True), (1, 1024, 1024, 8, 8, 64, True),
    (1, 2048, 2048, 16, 2, 64, True), (1, 100, 100, 8, 2, 128, True),
    (2, 200, 200, 16, 2, 64, True), (2, 200, 200, 8, 8, 128, True),
    (1, 37, 80, 4, 1, 128, True), (1, 37, 80, 8, 2, 64, True),
    (1, 64, 300, 8, 2, 64, False), (1, 64, 300, 8, 1, 128, False),
    (2, 1024, 1024, 4, 4, 128, False),
    # d 80: five 32-byte TMA boxes a tile
    (1, 129, 129, 16, 2, 80, True), (2, 200, 200, 16, 2, 80, False),
    (1, 37, 80, 8, 1, 80, True),
    # phase 16's shards of olmo-1b's training call: 4 heads a rank at 1x4,
    # 8 heads and 2 rows a rank at 2x2 (forward and backward)
    (4, 2048, 2048, 4, 4, 128, True), (2, 2048, 2048, 8, 8, 128, True),
)
# the flash library's SASS must hold tensor-core and TMA instructions
FLASH_SASS = ("HGMMA", "UTMALDG")
# the ssd_chunk library's SASS must hold tensor-core instructions (either)
SSD_SASS = ("HMMA", "HGMMA")
# the paged library's SASS must hold tensor-core (mma.sync) and ldmatrix
# instructions: its bf16 kernel, which every served model runs
PAGED_SASS = ("HMMA", "LDSM")
LLAMA_KERNELS = ("kv_gather_write", "kv_scatter_read", "flash_attention", "paged_attention")
# phase 2 at the other attention paths' shapes, bf16: the MoE and hybrid
# paths' (d 128, groups 7 and 8) and qwen3-32b's (d 80, group 8):
# label -> (prompt tokens, q heads, kv heads, head_dim, max_len, decode context)
ATTN_SHAPES = {"arctic": (1024, 56, 8, 128, 2048, 1040), "jamba": (1000, 64, 8, 128, 1024, 1016),
               "qwen3_32b": (1024, 64, 8, 80, 2048, 1040),
               # phases 11-12: internvl2-26b's group of 6 at d 128, musicgen-large's
               # group of 1 (32 / 32 heads) at d 64
               "internvl2_26b": (1024, 48, 8, 128, 2048, 1040),
               "musicgen_large": (1024, 32, 32, 64, 2048, 1040)}
# phase 2's paged rows from an e4m3 cache under a bf16 q: Llama's group 4 at d
# 128 and qwen3-32b's group 8 at d 80 (phase 10's decode)
FP8_SHAPES = {"llama_fp8": (32, 8, 128, 2048, 1040), "qwen3_32b_fp8": (64, 8, 80, 2048, 1040)}
# paged rows at those shapes are timed cycling over this many layers' caches,
# so that each call finds its cache cold in L2, as a decode step that reads
# gigabytes of expert weights between two attention layers does
PAGED_CYCLE = 32
# exp10's top-k read, also timed cycling over this many seeded sources of
# 655 KB (63 MB together, above the 50 MB L2), so that its byte bound holds
TOPK_SOURCES = 96
# phase 7: Arctic-480B at full width, depth cut to 2 layers (about 55 GB of
# bf16 weights); requests of 1024 tokens, a 768-token shared prefix
ARCTIC_LAYERS, ARCTIC_SHARED = 2, 768
# phase 7's kernel path against its plain path, per-step logits (bf16, logit
# std about 1.7) at the steps whose scored token was routed alike on both
# paths in every MoE layer (a step where it was not is reported as a routing
# flip). The prompt tokens the two paths route otherwise (4-8 of 1024 in
# layer 0 and 54-69 in layer 1 in the first readings, most through capacity
# slots that another token's flip took or freed) get other layer-1 K/V,
# which every later step reads: the readings were 0.18-0.67. Logits of an
# unrelated context differ by about 10 at the max.
ARCTIC_LOGIT_TOL = 1.0
# phase 8: Jamba-1.5-Large at full width, one period of 8 layers, 8 of its
# 16 experts (top-2 kept; about 52 GB: one period with all 16 is about 88 GB)
JAMBA_EXPERTS, JAMBA_PROMPT, JAMBA_STEPS = 8, 1000, 16
# continuity through MoE layers at the capacity factor JAX's own test takes
# (tests/test_models.py:104-108): at the default factor a prefill may drop the
# last token's expert pair, which a one-token decode (capacity 4) never drops
CONTINUITY_CAPACITY = 8.0
# phase 9: qwen3-32b at full width (d 5120, 64 / 8 heads at head_dim 80,
# d_ff 25600, vocabulary 151936), depth cut to 16 of 64 layers (about 17.6 GB
# of bf16 weights); requests of 1024 tokens, a 768-token shared prefix
QWEN3_LAYERS, QWEN3_SHARED = 16, 768
# phases 10-12 through Model: a PROMPT-position prefill, then this many greedy
# decode steps, each checked against the plain path on a copy of its cache
MODEL_STEPS = 16
# phase 10, qwen3-32b with an fp8 cache: the kernel path's logits against the
# plain path's on the same fp8 cache at every step (bf16, 16 layers); no
# looser than LOGIT_TOL
# (readings 0.20-0.27 at logit std 1.43, the bf16 cache's phase 9 0.23-0.24)
FP8_LOGIT_TOL = LOGIT_TOL
# phases 11-12, 48-layer bf16 stacks through Model: the same comparison
# through three times phase 9's depth, where the paths' bf16 roundings (flash
# rounds P to bf16, the plain version does not) compound: the first readings
# were 0.39-0.56 for internvl2-26b (logit std 1.57) and 0.15-0.22 for
# musicgen-large (0.90); logits of an unrelated context differ by about 10
DEEP_LOGIT_TOL = 1.0
MAMBA_PROMPTS, MAMBA_STEPS = (1000, 4095), 16
PREFILL_REPEATS = 5  # timed prefills of each prompt, after one warm-up
# the final SSM state of the kernel path against the plain path's, relative to
# its largest entry: layer 0 sees the same inputs on both paths, so only the
# kernel's f32 summation order differs; deeper layers also inherit bf16
# roundings of the residual stream that flip where the two paths' f32 results
# straddle a rounding boundary
STATE_TOL_L0, STATE_TOL = 1e-4, 5e-2
# continuity, relative to the largest logit (tests/test_models.py:127). In
# float32 the noise floor (the same prefill with the plain ssd_chunk in place
# of the kernel) is about 1e-5, and the limit about ten times that. In bf16
# the 64 layers of random weights amplify any rounding flip, so the floor is
# about 3e-2 already: there continuity is held to twice the floor measured in
# the same run, which a gross bf16-only fault still crosses
CONTINUITY_TOL, CONTINUITY_BF16_FLOORS = 1e-4, 2
# flash_attention_bwd against its plain version on the same inputs, relative
# to the largest |gradient|: bf16 within FLASH_TOL (the gradients' bf16
# rounding, 1.2e-3 at the training shape in the first reading); float32
# within F32_GRAD_TOL (f32 sums in other orders: readings up to 2.5e-6)
F32_GRAD_TOL = 2e-5
# the forward's stored log-sum-exp against flash_attention_lse_ref's, absolute
# on values of 1-10 (f32 sums in other orders: readings up to 9.5e-7)
LSE_TOL = 1e-5
# phase 2's backward at the training path's shape (olmo-1b: b 4, 2048
# tokens, 16 / 16 heads at d 128), Llama's group 4 at d 128, qwen3-32b's
# group 8 at d 80, and float32: label -> (b, sq, skv, hq, hkv, d, causal, dtype)
BWD_SHAPES = {"olmo_1b_train": (4, 2048, 2048, 16, 16, 128, True, "bfloat16"),
              "llama_group4": (1, 1024, 1024, 32, 8, 128, True, "bfloat16"),
              "qwen3_32b_group8": (1, 1024, 1024, 64, 8, 80, True, "bfloat16"),
              "llama_group4_f32": (1, 1024, 1024, 32, 8, 128, True, "float32")}
# the wgmma route at the training path's shape: the tensor cores bring the
# backward from 11.6 ms a layer on the CUDA cores (the other route, timed
# beside it) to under this (H100 80GB HBM3, 700 W)
BWD_TRAIN_MS = 1.5
# phase 13: olmo-1b at full width and depth, trained on SyntheticLM batches
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, OVERFIT_STEPS = 2048, 4, 8, 5
# phase 13 (iv): the run is saved at RESUME_AT, restored, and taken on to
# TRAIN_STEPS; then ASYNC_STEPS steps while an async save of step
# TRAIN_STEPS writes
RESUME_AT, ASYNC_STEPS = 4, 4
# phase 2's SSD backward against ssd_chunk_bwd_ref on the same inputs: dx and
# da within SSD_TOL of each output's scale (f32 sums in other orders on both
# sides: readings 1.1e-6 to 2.7e-6 in the first chip run), dB and dC (in B's
# dtype) within one rounding step of the f32 result (common.rounding_steps).
# label -> (chunk tiles, Lc, heads, head dim, groups, d_state, B/C dtype,
# with dcum, largest decay per step; None: the model's dt * A draws of
# ssd_inputs). Decays of up to 2 a step make cum fall past -100 within a
# chunk, where exp above the diagonal overflows
# the tensor-core backward at the training shape: half of the 3.80 ms the
# CUDA-core kernel it replaced took there (H100 80GB HBM3, 700 W)
SSD_BWD_TRAIN_MS = 1.9
SSD_BWD_SHAPES = {"mamba2_2.7b_train": (32, 256, 80, 64, 1, 128, "bfloat16", True, None),
                  "jamba": (4, 256, 256, 64, 1, 128, "bfloat16", True, None),
                  "ragged_lc100": (8, 100, 80, 64, 1, 128, "bfloat16", True, 2.0),
                  "groups2": (8, 256, 80, 64, 2, 128, "bfloat16", True, 2.0),
                  "float32_bc": (8, 256, 80, 64, 1, 128, "float32", True, 2.0),
                  "no_dcum": (32, 256, 80, 64, 1, 128, "bfloat16", False, 2.0),
                  # phase 16: a rank's 20 of the 80 heads at 1x4 (two blocks of 10)
                  "mamba2_2.7b_shard": (32, 256, 20, 64, 1, 128, "bfloat16", True, None)}
# phase 16's SSD heads a rank: mamba2-2.7b's 80 over 4 ranks
MESH_SSD_HEADS = 20
# phase 15: the weights' seed, the world's clock, and the limits on each
# run's largest |logit| gap against one device over every step, about twice
# the largest reading of experiments/mesh_probe.py over seeds 0-2 (NVIDIA
# H100 80GB HBM3, 700.00 W; chiprun_out/pr30_call2_probe.log): Llama 1x4,
# 32 layers, 0.3281 / 0.3394 / 0.3438 at logit std 1.28 (bf16 roundings of
# the residual stream at other points: f32 partial sums over model, each
# shard's attention rounded before the merge, and the paged kernel's
# splits of a shorter context, compounded through 32 layers); 2x2, 4
# layers, 0.1016 / 0.1016 / 0.0977; arctic's prefill logits 0.0469 /
# 0.0625 / 0.0469 and its layer outputs at the tokens routed alike 0.1875
# at each seed (one bf16 step at |x| 16-32; output std 3.44); mamba2, 8
# layers, 0.0625 / 0.0586 / 0.0625. Logits of an unrelated context differ
# by about 8 (the first readings, before the ranks decoded the reference's
# tokens)
MESH_SEED = 0
MESH_TIMEOUT_S = 600.0
MESH_LOGIT_TOL = {"llama_1x4": 0.7, "llama_2x2": 0.2, "arctic_1x4": 0.125,
                  "mamba2_1x4": 0.125}
MESH_HIDDEN_TOL = 0.375
# phase 16: training under a mesh (experiments/mesh_train_probe.py), each
# run against one device on the same weights and phase 13's batches: the
# weights' seed and, per run, the limits on each step's loss and grad norm
# relative to the reference's, and on each rank's f32 AdamW moments m and v
# after the last step against its slices of the reference's, relative to
# each leaf's largest entry, about twice the largest reading of
# experiments/mesh_train_probe.py over seeds 0-2 (NVIDIA H100 80GB HBM3,
# 700.00 W). The gaps are bf16 roundings at other points than one device's
# (the f32 partial sums over model, the bf16 gradient sum over data; phase
# 13's kernel-vs-plain gradient leaves read 4.1e-2 of their largest entry).
# olmo_1x4, 16 layers: loss 4.753e-5 / 1.811e-5 / 5.43e-5, grad norm
# 1.396e-4 / 3.201e-4 / 1.352e-4, m 4.254e-2 / 4.325e-2 / 5.166e-2, v
# 4.910e-2 / 4.289e-2 / 5.361e-2; mamba2_1x4, 8 layers: loss 3.423e-5 /
# 1.371e-5 / 4.963e-6, grad norm 6.347e-5 / 2.84e-5 / 4.942e-5, m 2.558e-2 /
# 2.916e-2 / 2.391e-2, v 2.962e-2 / 3.351e-2 / 2.744e-2; olmo_2x2, 4 layers:
# loss 1.716e-5 / 2.645e-5 / 1.418e-5, grad norm 7.149e-5 / 8.305e-5 /
# 9.22e-5, m 1.928e-2 / 1.923e-2 / 1.956e-2, v 2.589e-2 / 3.094e-2 /
# 2.520e-2. The weights are not held: four steps at lrs of 1.2e-5 or less
# move a bf16 weight near 0.01 by less than one bf16 step (2**-14, 5 lr),
# so their gap is one rounding step whatever the gradient was
MESH_TRAIN_SEED = 0
MESH_TRAIN_LOSS_TOL = {"olmo_1x4": 1.1e-4, "olmo_2x2": 5.5e-5, "mamba2_1x4": 7e-5}
MESH_TRAIN_NORM_TOL = {"olmo_1x4": 6.4e-4, "olmo_2x2": 1.9e-4, "mamba2_1x4": 1.3e-4}
MESH_TRAIN_MOMENT_TOL = {"olmo_1x4": 0.11, "olmo_2x2": 0.062, "mamba2_1x4": 0.067}
# phase 14: mamba2-2.7b at full width and depth trained on phase 13's
# SyntheticLM batches; its SSD backward checked per layer at these layers
SSM_TRAIN_STEPS, SSM_F64_LAYERS = 8, (0, 31, 63)
# phase 14 (i), float32 weights, the kernel path against the plain path from
# the same weights and batch: the two differ only by f32 summation order
# through 64 layers. Readings (experiments/ssd_train_probe.py, batches 0 and
# 1, NVIDIA H100 80GB HBM3, 700.00 W): loss gap 1.9e-6 and 0 at a loss of
# 11.334; the furthest gradient leaf 3.04e-5 and 4.66e-5 of its largest
# entry; per layer (0, 31, 63) dx, da, dB and dC against the float64
# backward 4.9e-6 to 8.4e-6. The limits are four to ten times those. The
# planted faults read: without u_j in dcum ("no_u") the furthest leaf 20.1
# and 15.8, da per layer 0.25-0.38; without a head block's dB and dC
# partial ("drop_block") 0.53 and 0.54, dB and dC per layer 0.54-0.93
SSM_LOSS_TOL = 2e-5
SSM_GRAD_TOL = 2e-4
SSM_F64_TOL = 5e-5
SSM_FAULT = "no_u"
# phase 13 (i), one AdamW step on the kernel path against the plain path
# (kernel_mode="ref") from the same weights and batch, bf16 through 16
# layers (flash rounds P to bf16 for P.V, the plain version does not, and
# the paths' bf16 roundings of the residual stream compound, as in phases
# 9-12). Limits set from the first readings (in the comments), a few times
# above; the inputs are seeded, so a rerun reads the same.
TRAIN_LOSS_TOL = 5e-4  # |loss difference| at a loss of 11.2 (reading 1.2e-4)
# grad norm, relative, on each of the first TRAIN_NORM_BATCHES batches. The
# gap is bf16 rounding compounded through 16 layers, and it spreads across
# batches even for an exact backward: with the CUDA-core backward, batches
# 0-7 read +1.31e-6, +2.4065e-4, +1.193e-4, -1.794e-4, -2.38e-5, +7.72e-5,
# -7.39e-5, -2.24e-5 (train_bwd_probe on an NVIDIA H100 80GB HBM3, 700.00 W;
# a float64 backward rounded to bf16 read up to 2.21e-4 on the same
# batches, and float32 weights 0). The limit is twice the largest of the
# CUDA-core readings, a constant.
TRAIN_NORM_TOL = 4.813e-4
TRAIN_NORM_BATCHES = 3
# each gradient leaf, relative to its largest |entry| (reading 4.1e-2)
TRAIN_GRAD_TOL = 0.1
# the updated weights, absolute, in units of the step's lr: at step 1 the
# default schedule's lr is 3e-6, below half a bf16 step of most weights (|w|
# ~ 0.02 -> 6e-5), so the update moves only weights whose bf16 step is under
# about 2 lr; AdamW's first update is lr * g / (|g| + eps), so a gradient
# whose sign differs between the paths moves such a weight 2 lr apart, plus
# a bf16 step in rounding: 4 lr at most
TRAIN_PARAM_LRS = 4
# phase 13 (i), per layer: at layers BWD_F64_LAYERS, on batch 0's captured
# backward inputs, each route's dq, dk and dv against the float64 backward
# of the same inputs. The RMS relative error is held to BWD_F64_RMS_RATIO
# times that of the float64 result rounded once to bf16 (the floor of any
# bf16 backward), and the bias <a, w> / <w, w> - 1 to BWD_F64_BIAS. The
# CUDA-core route read a ratio of 1.000000 at all nine (layer, gradient)
# pairs (RMS 1.6577e-3 to 1.6623e-3) and biases of -1.81e-5 to +1.2e-6
# (train_bwd_probe, H100 80GB HBM3, 700.00 W); the limits are twice and
# 2.8 times those readings. The wgmma route reads 1.28-1.41: it feeds P and
# dS to the tensor cores in bf16, and the float64 backward with just that
# rounding (train_bwd_probe's emulated_pds_bf16) reads the same to 5
# digits. On the same captured inputs the probe's wrong backwards read
# above the limit: sums kept in bf16 2.4-5.2, the last diagonal 64 x 64
# tile of each head dropped 5.1-12.3 (checked below each run, as a fault
# the check must refuse), the causal mask one key too wide 95-356.
BWD_F64_LAYERS = (0, 7, 15)
BWD_F64_RMS_RATIO = 2.0
BWD_F64_BIAS = 5e-5
# phase 17: the roofline held against the card. Cells at full width on one
# device (launch/steps.build_cell): label -> (arch, ShapeConfig fields)
ROOFLINE_CELLS = {
    "olmo_train": ("olmo-1b", ("olmo_train", TRAIN_SEQ, TRAIN_BATCH, "train")),
    "llama_prefill": ("llama3.1-8b", ("llama_prefill", PROMPT, 1, "prefill")),
    "llama_decode": ("llama3.1-8b", ("llama_decode", DECODE_CTX, 1, "decode")),
    "mamba2_prefill": ("mamba2-2.7b", ("mamba2_prefill", 1000, 1, "prefill")),
}
ROOFLINE_RUNS = 5  # synchronised calls timed after the warm-up, median
# the as-counted bound over the measured time: above this the count
# overstates the work the call did (an impossible reading)
ROOFLINE_SHARE_MAX = 1.05
# torch.cuda.max_memory_allocated() of a call over the analyzer's predicted
# peak of live bytes: the caching allocator rounds each block up to 512 B
# and cuBLAS keeps its workspace, which the count of tensor storages does
# not see. Readings at seeds 0-2, each the same at every seed (NVIDIA H100
# 80GB HBM3, 700.00 W): olmo_train 1.0030, llama_prefill 1.0041,
# llama_decode 1.0041, mamba2_prefill 1.0118; the upper limit about twice
# the largest excess, and never under the count
ROOFLINE_PEAK_RATIO = (1.0, 1.025)
# phase 20 (iii): the delay window's sleep before each post on the ring, and
# a drop window that ends well inside RingRetryPolicy()'s budget (3.3 s)
RING_DELAY_S = 0.001
RING_DROP_S = 0.05


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def paged_row(cfg, randn) -> dict:
    """paged_attention as Llama-3.1-8B decode runs it: each layer's dense
    (1, 2048, 8, 128) cache seen as 128 blocks of 16 through the identity
    table, context 1040; then once on one layer of the fused pool layout."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    L, hkv, hd, hq, bt = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 16
    n_blk = MAX_LEN // bt
    kc, vc = randn(L, 1, MAX_LEN, hkv, hd), randn(L, 1, MAX_LEN, hkv, hd)
    q = randn(L, 1, hq, hd)
    table = pa.make_block_table([list(range(n_blk))], n_blk, dev)
    ctx = torch.tensor([DECODE_CTX], dtype=torch.int32, device=dev)

    def kernel(i):
        return pa.paged_attention(q[i], pa.dense_blocks(kc[i], bt), pa.dense_blocks(vc[i], bt),
                                  table, ctx)

    def plain(i):
        return ref.paged_attention_ref(q[i], pa.dense_blocks(kc[i], bt),
                                       pa.dense_blocks(vc[i], bt), table, ctx)

    err, tol = bf16_check(torch.stack([kernel(i) for i in range(L)]),
                          torch.stack([plain(i) for i in range(L)]))
    check(err <= tol, f"paged_attention over {L} layers' dense caches, ctx {DECODE_CTX}: "
          f"max |err| {err:.3g} <= {tol:.3g} ({PAGED_ULPS} bf16 steps at the largest output; "
          f"margin {tol / max(err, 1e-30):.3g}x)")
    # layout (ii): one layer of the port's fused pool (n, 2L, bt, hkv, hd),
    # blocks in a shuffled order, read in place
    n_ctx = -(-DECODE_CTX // bt)
    pool = randn(n_ctx, 2 * L, bt, hkv, hd)
    order = torch.randperm(n_ctx, generator=torch.Generator().manual_seed(2)).tolist()
    ptable = pa.make_block_table([order], n_ctx, dev)
    layer = L // 2
    kl, vl = pa.pool_layer(pool, layer)
    perr, ptol = bf16_check(pa.paged_attention(q[0], kl, vl, ptable, ctx),
                            ref.paged_attention_ref(q[0], kl, vl, ptable, ctx))
    check(perr <= ptol, f"paged_attention on layer {layer} of a fused pool "
          f"{tuple(pool.shape)}: max |err| {perr:.3g} <= {ptol:.3g} "
          f"(margin {ptol / max(perr, 1e-30):.3g}x)")
    del pool, kl, vl
    # the split plan's edges on the same caches: a batch of 3 with contexts
    # {0, 17, 1040} (the dense caches of layers 0-2 as three rows), then one
    # row at ctx 1 and at the full table, 2048
    errs = [err, perr]
    rows3 = kc[:3, 0], vc[:3, 0]  # (3, 2048, hkv, hd)
    table3 = pa.make_block_table([[i * n_blk + j for j in range(n_blk)] for i in range(3)],
                                 3 * n_blk, dev)
    for qq, kk, vv, tbl, ctxs in (
            (q[:3, 0], *rows3, table3, [0, 17, DECODE_CTX]),
            (q[0], kc[0], vc[0], table, [1]), (q[0], kc[0], vc[0], table, [MAX_LEN])):
        cl = torch.tensor(ctxs, dtype=torch.int32, device=dev)
        kb, vb = pa.dense_blocks(kk, bt), pa.dense_blocks(vv, bt)
        got = pa.paged_attention(qq, kb, vb, tbl, cl)
        e, t = bf16_check(got, ref.paged_attention_ref(qq, kb, vb, tbl, cl))
        errs.append(e)
        check(e <= t and (ctxs[0] or not got[0].any()),
              f"paged_attention at contexts {ctxs}: max |err| {e:.3g} <= {t:.3g}"
              + (" (the context-0 row all zeros)" if not ctxs[0] else ""))
    del rows3
    splits, per_sm = pa.plan(dev, q.dtype, hd, hq // hkv, 1, hkv, n_blk)
    resident = pa.clusters_resident(dev, q.dtype, hd, hq // hkv, splits)
    idle = splits - len(pa.split_ranges(DECODE_CTX, bt, splits))
    check(resident >= hkv and idle == 0,
          f"paged plan at Llama decode: {splits} splits x {hkv} kv heads = {splits * hkv} CTAs "
          f"in {hkv} clusters ({resident} resident at once), {per_sm} CTAs per SM, {idle} "
          f"without work at ctx {DECODE_CTX}")
    per_call = kernels_per_call(lambda: [kernel(i) for i in range(4)], 4, "paged")
    check(per_call == 1, f"paged_attention is {per_call} device kernel per call "
          "(torch.profiler over 4 calls)")
    flops, moved = pa.paged_attention.cost(1, hq, hkv, hd, DECODE_CTX, q.element_size())
    qs = q.unsqueeze(3)  # (L, 1, hq, 1, hd)
    ks, vs = kc[:, :, :DECODE_CTX].transpose(2, 3), vc[:, :, :DECODE_CTX].transpose(2, 3)
    row = dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:128", max_abs_err=max(errs),
        splits=splits, ctas_per_sm=per_sm, clusters_resident=resident,
        kernels_per_call=per_call,
        ms=cycled_ms(kernel, range(L)),
        plain_ms=cycled_ms(plain, range(L)),
        bound_ms=max(moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
        bound_by="bytes" if moved / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations",
        library_ms=cycled_ms(lambda i: F.scaled_dot_product_attention(
            qs[i], ks[i], vs[i], enable_gqa=True), range(L)),
    )
    row["lse"] = paged_lse_shape(kc, vc, q)
    del kc, vc, q, qs, ks, vs
    row["shapes"] = {label: paged_shape(label, hq_, hkv_, hd_, max_len, ctx_len, randn)
                     for label, (_, hq_, hkv_, hd_, max_len, ctx_len) in ATTN_SHAPES.items()}
    return row


def paged_lse_shape(kc, vc, q) -> dict:
    """paged_attention with its log-sum-exp output at one rank's shape of
    phase 15 (i): all 32 q heads over the rank's shard of Llama-3.1-8B's
    sequence (MESH_SHARD of 4 x MESH_SHARD positions, a full shard), each
    layer's shard cut from phase 2's caches. The output and the lse against
    the plain version's; timed with the lse and without it on the same
    inputs, cycling over the layers."""
    import torch

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev, bt, L = torch.device("cuda"), 16, kc.shape[0]
    ks = kc[:, :, :MESH_SHARD].contiguous()
    vs = vc[:, :, :MESH_SHARD].contiguous()
    n_blk = MESH_SHARD // bt
    table = pa.make_block_table([list(range(n_blk))], n_blk, dev)
    ctx = torch.tensor([MESH_SHARD], dtype=torch.int32, device=dev)

    def call(i, lse=True):
        return pa.paged_attention(q[i], pa.dense_blocks(ks[i], bt), pa.dense_blocks(vs[i], bt),
                                  table, ctx, return_lse=lse)

    before = pa.paged_attention.launches_with_lse
    got = [call(i) for i in range(L)]
    want = [ref.paged_attention_ref(q[i], pa.dense_blocks(ks[i], bt),
                                    pa.dense_blocks(vs[i], bt), table, ctx, return_lse=True)
            for i in range(L)]
    err, tol = bf16_check(torch.stack([g[0] for g in got]), torch.stack([w[0] for w in want]))
    lse_err = max(float((g[1] - w[1]).abs().max()) for g, w in zip(got, want))
    same = all(torch.equal(g[0], call(i, lse=False)) for i, g in enumerate(got))
    check(err <= tol and lse_err <= PAGED_LSE_TOL and same
          and pa.paged_attention.launches_with_lse == before + L,
          f"paged_attention with its lse at a phase 15 shard ({MESH_SHARD} positions, 32 / 8 "
          f"heads, d 128) over {L} layers: out max |err| {err:.3g} <= {tol:.3g}, lse max "
          f"|err| {lse_err:.3g} <= {PAGED_LSE_TOL}; the output equal with the lse null")
    r = dict(max_abs_err=err, lse_max_abs_err=lse_err, positions=MESH_SHARD,
             ms=cycled_ms(call, range(L)), ms_lse_null=cycled_ms(lambda i: call(i, False),
                                                                 range(L)))
    print(f"  paged_attention at a phase 15 shard: {r['ms']:.4f} ms with the lse, "
          f"{r['ms_lse_null']:.4f} without")
    del ks, vs
    return r


def paged_shape(label: str, hq: int, hkv: int, hd: int, max_len: int, ctx_len: int,
                randn, fp8: bool = False) -> dict:
    """paged_attention at the Arctic, Jamba, qwen3-32b, internvl2-26b or
    musicgen-large decode (bf16; d 128 at groups 7, 8 and 6, d 80 at group
    8, d 64 at group 1), or, with ``fp8``, from an e4m3 cache under a bf16 q
    (Llama's group 4 at d 128, qwen3-32b's group 8 at d 80): one token over
    a dense (1, max_len, hkv, hd) cache as blocks of 16 through the identity
    table, checked and timed over PAGED_CYCLE such caches in turn. An fp8
    row's bound counts one byte a K/V element, and its SDPA time is taken on
    the same cache dequantized to bf16: a reference on other inputs, since
    no single call computes the fp8 function."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import to_e4m3

    dev, bt, n = torch.device("cuda"), 16, PAGED_CYCLE
    n_blk = max_len // bt
    kc, vc = randn(n, 1, max_len, hkv, hd), randn(n, 1, max_len, hkv, hd)
    if fp8:
        kc, vc = to_e4m3(kc), to_e4m3(vc)
    q = randn(n, 1, hq, hd)
    table = pa.make_block_table([list(range(n_blk))], n_blk, dev)
    ctx = torch.tensor([ctx_len], dtype=torch.int32, device=dev)

    def kernel(i):
        return pa.paged_attention(q[i], pa.dense_blocks(kc[i], bt), pa.dense_blocks(vc[i], bt),
                                  table, ctx)

    def plain(i):
        return ref.paged_attention_ref(q[i], pa.dense_blocks(kc[i], bt),
                                       pa.dense_blocks(vc[i], bt), table, ctx)

    before = dict(pa.paged_attention.launches_by_kv)
    err, tol = bf16_check(torch.stack([kernel(i) for i in range(n)]),
                          torch.stack([plain(i) for i in range(n)]))
    took = pa.paged_attention.launches_by_kv[pa.KV_NAMES[kc.dtype]] - before[pa.KV_NAMES[kc.dtype]]
    check(err <= tol and took == n, f"paged_attention at {label}'s decode (q heads {hq} / kv "
          f"{hkv}, group {hq // hkv}, d {hd}, ctx {ctx_len}, K/V {str(kc.dtype)[6:]}: {took} "
          f"launches of that instantiation): max |err| {err:.3g} <= {tol:.3g} ({PAGED_ULPS} "
          f"bf16 steps at the largest output)")
    flops, moved = pa.paged_attention.cost(1, hq, hkv, hd, ctx_len, q.element_size(),
                                           kc.element_size())
    qs = q.unsqueeze(3)
    ks, vs = (c[:, :, :ctx_len].to(q.dtype).transpose(2, 3) for c in (kc, vc))
    splits, per_sm = pa.plan(dev, q.dtype, hd, hq // hkv, 1, hkv, n_blk, kc.dtype)
    r = dict(max_abs_err=err, head_dim=hd, kv_dtype=str(kc.dtype)[6:], splits=splits,
             ctas_per_sm=per_sm,
             ms=cycled_ms(kernel, range(n)), plain_ms=cycled_ms(plain, range(n)),
             bound_ms=max(moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
             bound_by="bytes" if moved / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
             else "operations",
             library_ms=cycled_ms(lambda i: F.scaled_dot_product_attention(
                 qs[i], ks[i], vs[i], enable_gqa=True), range(n)))
    if fp8:
        r["library_on"] = "the same cache dequantized to bf16 (a reference on other inputs)"
    print(f"  paged_attention, {label} (group {hq // hkv}, d {hd}, ctx {ctx_len}, K/V "
          f"{r['kv_dtype']}, {splits} splits, {per_sm} CTAs per SM): {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f}, SDPA{' on bf16' if fp8 else ''} {r['library_ms']:.4f}, bound "
          f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return r


@contextlib.contextmanager
def profiled():
    """A torch.profiler window over the CPU and the card, opened on an idle
    card and left to settle (``profiler_probe.SETTLE_S``) before the
    caller's first launch: a window whose first ops came as it opened
    missed some of them (``repro_torch.experiments.profiler_probe``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiments.profiler_probe import SETTLE_S

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        yield prof


def kernels_per_call(run, calls: int, name: str) -> float:
    """Device kernels per call in a torch.profiler window of ``run`` (which
    makes ``calls`` calls); fails if a kernel without ``name`` in its name
    ran in the window."""
    import torch

    run()
    torch.cuda.synchronize()
    with profiled() as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(all(name in e.key for e in kernels),
          f"only {name} kernels in the window: {[(e.key[:60], e.count) for e in kernels]}")
    return sum(e.count for e in kernels) / calls


def bf16_check(got, want) -> tuple[float, float]:
    """max |got - want| and the limit: PAGED_ULPS bf16 rounding steps at
    the largest |want| (a step at x is 2**(floor(log2 x) - 7))."""
    import math

    top = want.float().abs().max().item()
    step = 2.0 ** (math.floor(math.log2(top)) - 7)
    return (got.float() - want.float()).abs().max().item(), PAGED_ULPS * step


def ssd_inputs(cfg, seq: int, g, heads: int | None = None):
    """ssd_chunk's inputs as one layer of a seq-token Mamba-2 prefill gives
    them: x and a f32, B and C bf16 slices of one projection, one group;
    with ``heads``, that many of its heads (a rank's shard under a mesh)."""
    import torch

    ssm = cfg.ssm
    nh, hp, n, lc = heads or ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state, ssm.chunk_size
    nb = seq // lc
    dev = torch.device("cuda")
    x = torch.randn((nb, lc, nh, hp), generator=g, device=dev) * 0.05
    dt = torch.rand((nb, lc, nh), generator=g, device=dev) * 0.1 + 1e-3
    a = -dt * (torch.rand((nh,), generator=g, device=dev) * 15 + 1)  # dt * A
    bc = (torch.randn((nb, lc, 2 * n), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    return x, a, bc[..., :n].reshape(nb, lc, 1, n), bc[..., n:].reshape(nb, lc, 1, n)


def ssd_row(cfg, jamba_cfg, g) -> dict:
    """ssd_chunk at the full-width Mamba-2 2.7B shapes, prompts of 1024 and
    4096 tokens, and at Jamba-1.5-Large's (256 heads) for 1024 tokens,
    called as the model calls it (with the prefix sums); the row reports
    Mamba-2's 1024-token call, with the other two beside it."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd

    rows = {}
    for key, c_, seq, heads in ((1024, cfg, 1024, None), (4096, cfg, 4096, None),
                                ("jamba", jamba_cfg, 1024, None),
                                ("mamba2_2.7b_train", cfg, TRAIN_BATCH * TRAIN_SEQ, None),
                                ("mamba2_2.7b_shard", cfg, TRAIN_BATCH * TRAIN_SEQ,
                                 MESH_SSD_HEADS)):
        x, a, b, c = ssd_inputs(c_, seq, g, heads)
        y, st, cum = ssd.ssd_chunk(x, a, b, c, return_cum=True)
        yr, sr = ref.ssd_chunk_ref(x, a, b, c)
        err = max((y - yr).abs().max().item(), (st - sr).abs().max().item())
        rel = max((y - yr).abs().max().item() / yr.abs().max().item(),
                  (st - sr).abs().max().item() / sr.abs().max().item())
        check(rel <= SSD_TOL, f"ssd_chunk at x {tuple(x.shape)}: max |err| {err:.3g}, "
              f"{rel:.3g} of the output's scale <= {SSD_TOL} "
              f"(margin {SSD_TOL / max(rel, 1e-30):.3g}x)")
        want = torch.cumsum(a, dim=1)
        cum_rel = _rel(cum, want)
        check(cum_rel <= CUM_TOL, f"ssd_chunk's prefix sums at {tuple(a.shape)} against "
              f"torch.cumsum: {cum_rel:.3g} of the largest |cum| <= {CUM_TOL}")
        nb, lc, nh, hp = x.shape
        ng, n = b.shape[2] if b.stride(2) else 1, b.shape[-1]
        _, moved = ssd.ssd_chunk.cost(nb, lc, nh, hp, ng, n, b.element_size(), True)
        flops_g, flops_tf32 = ssd.forward_flops(nb, lc, nh, hp, ng, n)  # bf16 C.B^T; f32
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = flops_g / BF16_FLOP_PER_S + flops_tf32 / TF32_FLOP_PER_S
        rows[key] = dict(
            name="ssd_chunk", route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk.cu",
            replaces="src/repro/kernels/ssd_chunk.py:72", max_abs_err=err,
            ms=device_ms(lambda: ssd.ssd_chunk(x, a, b, c, return_cum=True)),
            plain_ms=device_ms(lambda: ref.ssd_chunk_ref(x, a, b, c, return_cum=True), iters=5),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=None,
        )
        r = rows[key]
        # The float32 CUDA-core figure is a computed lower bound, not a timing:
        # it stays on this line, out of the kernels JSON row.
        f32_ops_ms = (flops_g + flops_tf32) / F32_FLOP_PER_S * 1e3
        print(f"  ssd_chunk, {c_.name}, {seq} tokens, {nh} heads: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}: {moved / 1e6:.1f} MB, "
              f"{(flops_g + flops_tf32) / 1e9:.2f} GFLOP on the tensor cores "
              f"{t_ops * 1e3:.4f} ms; computed for f32 CUDA cores {f32_ops_ms:.4f} ms)")
        del x, a, b, c, y, st, cum, yr, sr, want
    row = rows[1024]
    row["ms_4096"], row["plain_ms_4096"] = rows[4096]["ms"], rows[4096]["plain_ms"]
    row["max_abs_err_4096"] = rows[4096]["max_abs_err"]
    row["shapes"] = {key: {k: rows[key][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        for key in ("jamba", "mamba2_2.7b_train", "mamba2_2.7b_shard")}
    return row


def ssd_bwd_bound(nb, lc, nh, hp, g, n, bc_dtype, with_dcum) -> tuple[float, str, float]:
    """(bound in ms, what bounds it, FLOPs) of one ssd_chunk_bwd call: each
    input read once and each output written once; the products on causal
    pairs, per head (dM = dy.x^T, M^T.dy, w dst^T B, w x dst^T) and per group
    (G = C.B^T in B/C's type, dG^T.C and dG.B after the head sum), f32
    products at the TF32 tensor-core rate."""
    import torch

    from repro_torch.kernels import ssd_chunk as ssd

    es = torch.tensor([], dtype=getattr(torch, bc_dtype)).element_size()
    _, moved = ssd.ssd_chunk_bwd.cost(nb, lc, nh, hp, g, n, es, with_dcum)
    flops_g, flops_f32 = ssd.backward_flops(nb, lc, nh, hp, g, n)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = (flops_g / (BF16_FLOP_PER_S if es == 2 else TF32_FLOP_PER_S)
             + flops_f32 / TF32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            flops_g + flops_f32)


def ssd_bwd_row(cfg, jamba_cfg, g) -> dict:
    """ssd_chunk_bwd against ssd_chunk_bwd_ref at SSD_BWD_SHAPES (module
    docstring, phase 2), each rerun bit for bit; timed at the training shape
    and Jamba's 256 heads against the plain version and the bound. No single
    PyTorch call computes this gradient, so the library column is null."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd

    dev = torch.device("cuda")
    row, shapes = None, {}
    for label, (nb, lc, nh, hp, ng, n, bc, with_dcum, decay) in SSD_BWD_SHAPES.items():
        if decay is None:  # the model's draws, at this many tokens of one sequence
            x, a, b, c = ssd_inputs(jamba_cfg if label == "jamba" else cfg, nb * lc, g,
                                    nh if label == "mamba2_2.7b_shard" else None)
            check(tuple(x.shape) == (nb, lc, nh, hp) and tuple(b.shape) == (nb, lc, ng, n),
                  f"{label}: the config gives x {tuple(x.shape)}, B {tuple(b.shape)}")
        else:
            x = torch.randn((nb, lc, nh, hp), generator=g, device=dev) * 0.05
            a = -torch.rand((nb, lc, nh), generator=g, device=dev) * decay
            bcm = torch.randn((nb, lc, 2 * ng * n), generator=g, device=dev) * 0.5
            bcm = bcm.to(getattr(torch, bc))
            b = bcm[..., :ng * n].reshape(nb, lc, ng, n)
            c = bcm[..., ng * n:].reshape(nb, lc, ng, n)
        dy = torch.randn((nb, lc, nh, hp), generator=g, device=dev)
        dst = torch.randn((nb, nh, n, hp), generator=g, device=dev)
        dcum = torch.randn((nb, lc, nh), generator=g, device=dev) if with_dcum else None
        got = ssd.ssd_chunk_bwd(x, a, b, c, dy, dst, dcum)
        want = ref.ssd_chunk_bwd_ref(x, a, b, c, dy, dst, dcum)
        torch.cuda.synchronize()
        rel = {k: _rel(gv, wv) for k, gv, wv in zip(("dx", "da"), got, want)}
        ulp = {k: rounding_steps(gv, wv) for k, gv, wv in zip(("dB", "dC"), got[2:], want[2:])}
        cum = torch.cumsum(a, dim=1)
        overflow = (cum.max(1).values - cum.min(1).values).max().item()
        check(all(torch.isfinite(t).all() for t in got) and max(rel.values()) <= SSD_TOL
              and max(ulp.values()) <= 1.0,
              f"ssd_chunk_bwd at {label} (x {tuple(x.shape)}, groups {ng}, B/C {bc}, dcum "
              f"{'random' if with_dcum else 'none'}; cum spans up to {overflow:.0f} in a "
              f"chunk): dx, da {[f'{v:.3g}' for v in rel.values()]} of their scale <= "
              f"{SSD_TOL}; dB, dC {[f'{v:.3g}' for v in ulp.values()]} rounding steps <= 1")
        again = ssd.ssd_chunk_bwd(x, a, b, c, dy, dst, dcum)
        check(all(torch.equal(p, q) for p, q in zip(got, again)),
              f"ssd_chunk_bwd at {label}: a second call equals the first bit for bit")
        r = {"max_abs_err": max((p.float() - q.float()).abs().max().item()
                                for p, q in zip(got, want)),
             "max_rel_err": max(rel.values()), "max_round_steps": max(ulp.values())}
        del got, want, again
        if label in ("mamba2_2.7b_train", "jamba", "mamba2_2.7b_shard"):
            bound, by, flops = ssd_bwd_bound(nb, lc, nh, hp, ng, n, bc, with_dcum)
            r.update(ms=device_ms(lambda: ssd.ssd_chunk_bwd(x, a, b, c, dy, dst, dcum),
                                  iters=10),
                     plain_ms=device_ms(lambda: ref.ssd_chunk_bwd_ref(x, a, b, c, dy, dst,
                                                                      dcum), iters=3),
                     bound_ms=bound, bound_by=by, library_ms=None)
            r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
            if label == "mamba2_2.7b_train":
                check(r["ms"] <= SSD_BWD_TRAIN_MS, f"ssd_chunk_bwd at {label}: {r['ms']:.4f} ms "
                      f"<= {SSD_BWD_TRAIN_MS} ms")
            print(f"  ssd_chunk_bwd, {label} (x {tuple(x.shape)}): {r['ms']:.4f} ms "
                  f"({r['tflops']:.2f} TFLOP/s of {flops / 1e9:.1f} GFLOP on causal pairs), "
                  f"plain {r['plain_ms']:.4f}, bound {bound:.4f} by {by} (computed for f32 "
                  f"CUDA cores {flops / F32_FLOP_PER_S * 1e3:.4f} ms); library: none, no "
                  "single PyTorch call computes this gradient")
        if row is None:
            row = dict(name="ssd_chunk_bwd", route="cuda",
                       source="src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
                       replaces="src/repro/models/mamba.py:67",
                       replaces_note="no Pallas backward exists: JAX trains through "
                                     "jax.value_and_grad of its jnp _ssd_chunked (this "
                                     "line); the forward kernel differentiated is "
                                     "src/repro/kernels/ssd_chunk.py:72", **r)
        else:
            shapes[label] = r
        del x, a, b, c, dy, dst, dcum
    row["shapes"] = shapes
    return row


def sparse_row(cfg, qwen_cfg, g) -> dict:
    """sparse_kv_gather at phase 6's reads, built by the exp10 twin's own
    helpers: 16 tokens per (layer, kv head) of a 1024-token context in a
    full-width Llama-3.1-8B pool of 512 blocks, and of an 8192-token context
    in a qwen3-32b pool of 512 blocks, each read one launch of
    (-1, 1, head_dim) pieces, timed over exp10's 32 reads cold in L2; then
    exp10's top-k read, 4,096 rows of (8, 80) from one full-width qwen3-32b
    layer's K and V, timed on one id set with its source in L2 as
    exp10.topk_gather times it. The row reports Llama's read, with the
    other two reads' times, the Llama read replayed from one captured CUDA
    graph of its 32 reads (per read) and the launch floor: the kernel's C
    entry with an empty body on the same grid (sparse_probe's ``empty``)."""
    import torch

    from repro_torch.core.pool import KVBlockLayout
    from repro_torch.experiments import exp10_sparse as exp10
    from repro_torch.experiments import sparse_probe
    from repro_torch.experiments.common import graph_ms
    from repro_torch.kernels import kv_transfer as kv
    from repro_torch.kernels import ref

    rows = {}
    for c, ctx_blocks in ((cfg, PROMPT // 16), (qwen_cfg, POOL_BLOCKS)):
        lay = KVBlockLayout.for_model(c, 16)
        pool = exp10.random_pool(lay, POOL_BLOCKS, g)[0]
        view = pool.view(-1, 1, lay.head_dim)
        n = view.shape[0]
        id_sets = exp10.cold_id_sets(lay, POOL_BLOCKS, ctx_blocks, g)
        edge = torch.tensor([-1, -n, n, 2**31 - 1], dtype=torch.int32, device=g.device)
        ids = torch.cat([id_sets[0], edge])
        out, want = kv.sparse_kv_gather(view, ids), ref.sparse_kv_gather_ref(view, ids)
        torch.cuda.synchronize()
        nan_rows = torch.isnan(out).all(dim=(1, 2))
        n_sel = id_sets[0].numel()
        check(torch.equal(out.view(torch.int16), want.view(torch.int16))
              and nan_rows.nonzero().flatten().tolist() == [n_sel + 2, n_sel + 3]
              and torch.equal(out[n_sel], view[n - 1]) and torch.equal(out[n_sel + 1], view[0]),
              f"sparse_kv_gather bit-exact on {c.name}'s pool {tuple(pool.shape)}: {n_sel} "
              f"pieces + ids -1, -N (wrapped), N, 2**31-1 (NaN rows, exactly those)")
        _, moved = kv.sparse_kv_gather.cost(n_sel, view[0].numel() * view.element_size())
        rows[c.name] = r = dict(
            name="sparse_kv_gather", route="cuda",
            source="src/repro_torch/kernels/csrc/kv_transfer.cu",
            replaces="src/repro/kernels/kv_transfer.py:172", max_abs_err=0.0,
            ms=cycled_ms(lambda i: kv.sparse_kv_gather(view, i), id_sets),
            plain_ms=cycled_ms(lambda i: ref.sparse_kv_gather_ref(view, i), id_sets),
            bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=cycled_ms(lambda i: view.index_select(0, i), id_sets),
        )
        print(f"  sparse_kv_gather, {c.name}: {n_sel} pieces of {lay.head_dim * 2} B: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, index_select "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} by bytes: {moved / 1e6:.2f} MB)")
        if c is cfg:
            r["graph_ms"] = graph_ms(lambda i: kv.sparse_kv_gather(view, i), id_sets)
            r["floor_ms"] = sparse_probe.floor_ms(view, id_sets)
        del pool, view, id_sets, out, want
    tkv, tids = sparse_probe.topk_read(qwen_cfg, g)
    out = kv.sparse_kv_gather(tkv, tids)
    torch.cuda.synchronize()
    check(torch.equal(out, tkv[tids.long()]),
          f"sparse_kv_gather bit-exact on the top-k read: {tids.numel()} rows of "
          f"{tuple(tkv.shape[1:])} from {qwen_cfg.name}'s K and V of one layer")
    row, qwen = rows[cfg.name], rows[qwen_cfg.name]
    row["ms_qwen3_32b"] = qwen["ms"]
    row["ms_topk"] = device_ms(lambda: kv.sparse_kv_gather(tkv, tids))
    # the same read over TOPK_SOURCES seeded sources in turn, each cold in L2,
    # so that the HBM byte bound holds: each distinct source row the ids
    # select read once, the ids read once, each output row written once
    sources = [sparse_probe.topk_read(qwen_cfg, g) for _ in range(TOPK_SOURCES)]
    for src, ids in sources[:2]:
        check(torch.equal(kv.sparse_kv_gather(src, ids), src[ids.long()]),
              f"sparse_kv_gather bit-exact on a top-k read of source {tuple(src.shape)}")
    row["ms_topk_cold"] = cycled_ms(lambda p: kv.sparse_kv_gather(*p), sources)
    row_bytes = tkv[0].numel() * tkv.element_size()
    distinct = sum(torch.unique(ids).numel() for _, ids in sources) / TOPK_SOURCES
    moved = distinct * row_bytes + tids.numel() * (tids.element_size() + row_bytes)
    row["bound_ms_topk"] = moved / HBM_BYTES_PER_S * 1e3
    print(f"  sparse_kv_gather, three reads: {cfg.name} {row['ms'] * 1e3:.3f} us (one CUDA "
          f"graph of its 32 reads: {row['graph_ms'] * 1e3:.3f} us a read; empty kernel on its "
          f"grid {row['floor_ms'] * 1e3:.3f}; bound {row['bound_ms'] * 1e3:.3f}), {qwen_cfg.name} "
          f"{qwen['ms'] * 1e3:.3f} (bound {qwen['bound_ms'] * 1e3:.3f}), top-k "
          f"{row['ms_topk_cold'] * 1e3:.3f} over {TOPK_SOURCES} sources cold in L2 (bound "
          f"{row['bound_ms_topk'] * 1e3:.3f}: {distinct:.1f} distinct source rows of "
          f"{row_bytes} B, "
          f"{tids.numel()} ids and output rows, {moved / 1e6:.2f} MB; counting each of the "
          f"{tids.numel()} selections as a row read, {2 * tids.numel() * row_bytes / 1e6:.2f} MB, "
          f"{2 * tids.numel() * row_bytes / HBM_BYTES_PER_S * 1e6:.3f} us), top-k with its "
          f"source and output in L2 {row['ms_topk'] * 1e3:.3f} (no HBM bound holds there)")
    return row


def flash_row(cfg, randn) -> dict:
    """flash_attention at one layer of the 1024-token Llama-3.1-8B prefill
    (bf16, d 128: the wgmma route), timed against the CUDA-core route on the
    same inputs, the plain version and SDPA; then the wgmma route against the
    plain version at the ragged and GQA shapes of FLASH_SHAPES."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    hkv, hd, hq = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    q, fk, fv = randn(1, PROMPT, hq, hd), randn(1, PROMPT, hkv, hd), randn(1, PROMPT, hkv, hd)
    picked = fa.route(q.dtype, hd)
    before = dict(fa.flash_attention.launches_by_route)
    out = fa.flash_attention(q, fk, fv, causal=True)
    want = ref.flash_attention_ref(q, fk, fv, causal=True)
    err = (out.float() - want.float()).abs().max().item()
    took = fa.flash_attention.launches_by_route["wgmma"] - before["wgmma"]
    check(picked == "wgmma" and took == 1,
          f"flash_attention at q {tuple(q.shape)} bf16 takes the {picked} route")
    check(torch.allclose(out.float(), want.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
          f"flash_attention (wgmma) within {FLASH_TOL} at q {tuple(q.shape)} (max |err| {err:.3g})")
    slow = fa.flash_attention(q, fk, fv, causal=True, force_route="cuda_cores")
    slow_err = (slow.float() - want.float()).abs().max().item()
    check(torch.allclose(slow.float(), want.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
          f"flash_attention (cuda_cores) on the same inputs within {FLASH_TOL} "
          f"(max |err| {slow_err:.3g})")
    flops, moved = fa.flash_attention.cost(1, PROMPT, PROMPT, hq, hkv, hd, True,
                                           q.element_size())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, fk, fv))
    ms = device_ms(lambda: fa.flash_attention(q, fk, fv, causal=True))
    row = dict(
        name="flash_attention", route="cuda", dispatch_route=picked,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:135", max_abs_err=err,
        ms=ms,
        cuda_cores_ms=device_ms(
            lambda: fa.flash_attention(q, fk, fv, causal=True, force_route="cuda_cores")),
        plain_ms=device_ms(lambda: ref.flash_attention_ref(q, fk, fv, causal=True)),
        bound_ms=max(flops / BF16_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOP_PER_S > moved / HBM_BYTES_PER_S
        else "bytes",
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        tflops=flops / (ms * 1e-3) / 1e12,
        cuda_cores_max_abs_err=slow_err,
    )
    print(f"  flash_attention, {flops / 1e9:.2f} GFLOP: wgmma {row['ms']:.4f} ms "
          f"({row['tflops']:.1f} TFLOP/s), cuda_cores {row['cuda_cores_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, bound {row['bound_ms']:.4f}")
    del q, fk, fv, out, want, slow, qt, kt, vt
    errs = []
    for b, sq, skv, nq, nkv, d, causal in FLASH_SHAPES:
        q, k, v = randn(b, sq, nq, d), randn(b, skv, nkv, d), randn(b, skv, nkv, d)
        before = fa.flash_attention.launches_by_route["wgmma"]
        out = fa.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        e = (out.float() - want.float()).abs().max().item()
        errs.append(e)
        check(fa.flash_attention.launches_by_route["wgmma"] == before + 1
              and torch.allclose(out.float(), want.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
              f"flash_attention (wgmma) within {FLASH_TOL} at b {b}, sq {sq}, skv {skv}, heads "
              f"{nq}/{nkv}, d {d}, {'causal' if causal else 'non-causal'} (max |err| {e:.3g})")
    row["max_abs_err_shapes"] = max(errs)
    row["shapes"] = {label: flash_shape(label, sq, hq_, hkv_, hd_, randn)
                     for label, (sq, hq_, hkv_, hd_, _, _) in ATTN_SHAPES.items()}
    return row


def flash_shape(label: str, sq: int, hq: int, hkv: int, hd: int, randn) -> dict:
    """flash_attention at one layer of the Arctic, Jamba or qwen3-32b prefill
    (bf16; d 128 at groups 7 and 8, d 80 at group 8: the wgmma route)
    against the plain version, timed beside it, SDPA and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q, k, v = randn(1, sq, hq, hd), randn(1, sq, hkv, hd), randn(1, sq, hkv, hd)
    before = fa.flash_attention.launches_by_route["wgmma"]
    out = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    err = (out.float() - want.float()).abs().max().item()
    check(fa.flash_attention.launches_by_route["wgmma"] == before + 1
          and torch.allclose(out.float(), want.float(), atol=FLASH_TOL, rtol=FLASH_TOL),
          f"flash_attention (wgmma) within {FLASH_TOL} at {label}'s q {tuple(q.shape)}, "
          f"group {hq // hkv} (max |err| {err:.3g})")
    flops, moved = fa.flash_attention.cost(1, sq, sq, hq, hkv, hd, True, q.element_size())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    r = dict(q=list(q.shape), max_abs_err=err,
             ms=device_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
             plain_ms=device_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True)),
             bound_ms=max(flops / BF16_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3,
             bound_by="operations" if flops / BF16_FLOP_PER_S > moved / HBM_BYTES_PER_S
             else "bytes",
             library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True)))
    r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
    print(f"  flash_attention, {label} (q {tuple(q.shape)}, group {hq // hkv}): wgmma "
          f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), plain {r['plain_ms']:.4f}, SDPA "
          f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}")
    return r


def phase_kernels(cfg, mamba_cfg) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_transfer as kv
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    L, hkv, hd, hq, bt = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 16
    n_blocks, n_slots = PROMPT // bt, MAX_LEN // bt
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    rows = []
    # -- kv_gather_write: the miss path's writeback of one prompt
    k, v = randn(L, MAX_LEN, hkv, hd), randn(L, MAX_LEN, hkv, hd)
    slots = list(range(n_blocks))
    slots_t = torch.tensor(slots, device=dev)
    blocks = kv.kv_gather_write(k, v, slots, bt)
    want = ref.kv_gather_write_ref(k, v, slots_t, bt)
    torch.cuda.synchronize()
    check(torch.equal(blocks, want), f"kv_gather_write bit-exact at {tuple(blocks.shape)}")
    _, moved = kv.kv_gather_write.cost(n_blocks, L, bt, hkv, hd, blocks.element_size())
    rows.append(dict(
        name="kv_gather_write", route="cuda",
        source="src/repro_torch/kernels/csrc/kv_transfer.cu",
        replaces="src/repro/kernels/kv_transfer.py:76", max_abs_err=0.0,
        ms=device_ms(lambda: kv.kv_gather_write(k, v, slots, bt)),
        plain_ms=device_ms(lambda: ref.kv_gather_write_ref(k, v, slots_t, bt)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    ))
    # -- kv_scatter_read: the hit path's fetch of those blocks
    kr, vr = kv.kv_scatter_read(blocks, slots, n_slots)
    zeros = torch.zeros_like(k)
    kw, vw = ref.kv_scatter_read_ref(blocks, slots_t, zeros, zeros, bt)
    torch.cuda.synchronize()
    check(torch.equal(kr, kw) and torch.equal(vr, vw),
          f"kv_scatter_read bit-exact (zero fill included) at {tuple(kr.shape)}")
    _, moved = kv.kv_scatter_read.cost(n_blocks, L, n_slots, bt, hkv, hd, kr.element_size())
    rows.append(dict(
        name="kv_scatter_read", route="cuda",
        source="src/repro_torch/kernels/csrc/kv_transfer.cu",
        replaces="src/repro/kernels/kv_transfer.py:132", max_abs_err=0.0,
        ms=device_ms(lambda: kv.kv_scatter_read(blocks, slots, n_slots)),
        plain_ms=device_ms(
            lambda: ref.kv_scatter_read_ref(blocks, slots_t, zeros, zeros, bt)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    ))
    del k, v, blocks, want, kr, vr, kw, vw, zeros
    qwen_cfg = get_config("qwen3-32b")
    for r, shape in zip(rows, kv_fp8_shapes(qwen_cfg, g)):
        r["shapes"] = {"qwen3_32b_fp8": shape}
    rows.append(flash_row(cfg, randn))
    rows.append(paged_row(cfg, randn))
    rows.append(paged_fp8_row(randn))
    rows.append(ssd_row(mamba_cfg, get_config("jamba-1.5-large-398b"), g))
    rows.append(sparse_row(cfg, qwen_cfg, g))
    rows.append(bwd_row())
    rows.append(ssd_bwd_row(mamba_cfg, get_config("jamba-1.5-large-398b"), g))
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    return rows


def kv_fp8_shapes(qwen_cfg, g) -> tuple[dict, dict]:
    """kv_gather_write and kv_scatter_read on an e4m3 qwen3-32b cache (64
    layers, 8 kv heads at d 80, max_len 2048; a 1024-token prompt's 64
    blocks), cast as the fp8 KV cache casts: each bit for bit against its
    plain version (uint8 views), timed beside it and its byte bound."""
    import torch

    from repro_torch.kernels import kv_transfer as kv
    from repro_torch.kernels import ref
    from repro_torch.models.attention import to_e4m3

    dev, bt = torch.device("cuda"), 16
    L, hkv, hd = qwen_cfg.n_layers, qwen_cfg.n_kv_heads, qwen_cfg.head_dim
    n_slots, slots = MAX_LEN // bt, list(range(PROMPT // bt))
    slots_t = torch.tensor(slots, device=dev)
    k, v = (to_e4m3(torch.randn((L, MAX_LEN, hkv, hd), generator=g, device=dev))
            for _ in range(2))
    blocks = kv.kv_gather_write(k, v, slots, bt)
    want = ref.kv_gather_write_ref(k, v, slots_t, bt)
    kr, vr = kv.kv_scatter_read(blocks, slots, n_slots)
    zeros = torch.zeros_like(k)
    kw, vw = ref.kv_scatter_read_ref(blocks, slots_t, zeros, zeros, bt)
    torch.cuda.synchronize()
    u8 = lambda t: t.view(torch.uint8)  # noqa: E731
    check(blocks.dtype == torch.float8_e4m3fn and torch.equal(u8(blocks), u8(want)),
          f"kv_gather_write bit-exact on an e4m3 qwen3-32b cache at {tuple(blocks.shape)}")
    check(torch.equal(u8(kr), u8(kw)) and torch.equal(u8(vr), u8(vw)),
          f"kv_scatter_read bit-exact (zero fill included) on e4m3 blocks at {tuple(kr.shape)}")
    _, gather_moved = kv.kv_gather_write.cost(len(slots), L, bt, hkv, hd, 1)
    _, scatter_moved = kv.kv_scatter_read.cost(len(slots), L, n_slots, bt, hkv, hd, 1)
    out = (dict(max_abs_err=0.0, bytes_per_element=1,
                ms=device_ms(lambda: kv.kv_gather_write(k, v, slots, bt)),
                plain_ms=device_ms(lambda: ref.kv_gather_write_ref(k, v, slots_t, bt)),
                bound_ms=gather_moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None),
           dict(max_abs_err=0.0, bytes_per_element=1,
                ms=device_ms(lambda: kv.kv_scatter_read(blocks, slots, n_slots)),
                plain_ms=device_ms(
                    lambda: ref.kv_scatter_read_ref(blocks, slots_t, zeros, zeros, bt)),
                bound_ms=scatter_moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None))
    for name, r in zip(("kv_gather_write", "kv_scatter_read"), out):
        print(f"  {name}, qwen3-32b e4m3: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f})")
    return out


def paged_fp8_row(randn) -> dict:
    """paged_attention's e4m3 instantiation (an fp8 cache under a bf16 q), at
    qwen3-32b's decode (phase 10: group 8, d 80, context 1040) and Llama's
    (group 4, d 128): the row of the kernels line, timed as ``paged_shape``
    times it."""
    shapes = {label: paged_shape(label, hq, hkv, hd, max_len, ctx, randn, fp8=True)
              for label, (hq, hkv, hd, max_len, ctx) in FP8_SHAPES.items()}
    main = shapes["qwen3_32b_fp8"]
    return dict(
        name="paged_attention_e4m3", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:128",
        max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                "library_on", "splits", "ctas_per_sm")},
        shapes=shapes,
    )


def flash_build_proof(build) -> None:
    """The wgmma route's kernels as ptxas built them (registers, spills, the
    CTA's dynamic shared memory), and the flash library's SASS holding the
    tensor-core (HGMMA) and TMA (UTMALDG) instructions."""
    import re

    from repro_torch.kernels import flash_attention as fa

    log = build.build_log("flash_attention")
    for fn, body in re.findall(r"Compiling entry function '(\S*flash_wgmma_kernel\S*)'"
                               r"(.*?)Compile time", log, flags=re.S):
        d = re.search(r"ILi(\d+)E", fn).group(1)
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        smem = build.load("flash_attention", fa.SIGNATURES).flash_attention_wgmma_smem(int(d))
        print(f"  flash wgmma kernel, d {d}: {regs} registers at launch, spill stores "
              f"{spill.group(1)} B / loads {spill.group(2)} B, {smem} B dynamic shared memory")
    sass = build.sass("flash_attention")
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in FLASH_SASS}
    check(all(counts.values()), f"flash library SASS holds tensor-core and TMA instructions: "
          f"{counts}")


def paged_build_proof(build) -> None:
    """Each paged_attention instantiation as ptxas built it, by name: the
    tensor-core kernel per (q, K/V) dtype pair (bf16/bf16, and the fp8
    cache's float32/e4m3 and bf16/e4m3) and head_dim (a whole group of up to
    8 heads a CTA) and the float32 CUDA-core kernel per (head_dim, group
    rounded up to a power of two): registers, spill stores and loads,
    static shared memory, its K/V ring (dynamic shared memory) and CTAs per
    SM. The tensor-core kernels that Llama (d 128) and qwen3-32b (d 80)
    decode run, from a bf16 or an e4m3 cache, must not spill, and the
    library's SASS must hold the tensor-core (HMMA) and ldmatrix (LDSM)
    instructions."""
    import re

    import torch

    from repro_torch.kernels import paged_attention as pa

    log = build.build_log("paged_attention")
    dev = torch.device("cuda", torch.cuda.current_device())
    seen = {}
    codes = {v: k for k, v in pa.KINDS.items()}  # the C entry's dtype code -> (q, K/V)
    for fn, body in re.findall(r"Compiling entry function '(\S*paged_\w*kernel\S*)'"
                               r"(.*?)Compile time", log, flags=re.S):
        mma = re.search(r"paged_mma_kernelILi(\d+)ELi(\d+)E", fn)
        if mma:
            (dtype, kv_dtype), d, g = codes[int(mma.group(1))], int(mma.group(2)), 8
        else:
            m = re.search(r"paged_attention_kernelIfLi(\d+)ELi(\d+)E", fn)
            dtype, kv_dtype, d, g = torch.float32, torch.float32, int(m.group(1)), int(m.group(2))
        regs = int(re.search(r"Used (\d+) registers", body).group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        seen[(dtype, kv_dtype, d, g)] = stores, loads = int(spill.group(1)), int(spill.group(2))
        print(f"  paged kernel q {str(dtype)[6:]}, K/V {str(kv_dtype)[6:]}, d {d}, {g} heads a "
              f"CTA: {regs} registers, spill stores {stores} B / loads {loads} B, "
              f"{smem.group(1) if smem else 0} B static + "
              f"{pa.ring_bytes(dev, dtype, d, g, kv_dtype)} B ring shared memory, "
              f"{pa.ctas_per_sm(dev, dtype, d, g, kv_dtype)} CTAs per SM")
    # tensor cores: one per (q, K/V) pair and head_dim; float32: 1, 2, 4, 8 heads a CTA
    want = len(pa.HEAD_DIMS) * (3 + 4)
    check(len(seen) == want, f"ptxas reported all {len(seen)} of {want} paged "
          "instantiations (tensor cores: bf16/bf16, float32/e4m3, bf16/e4m3 x 5 head_dims; "
          "float32 x 5 head_dims x 1, 2, 4, 8 heads a CTA)")
    served = [(q, kv, d, 8) for q, kv in ((torch.bfloat16, torch.bfloat16),
                                           (torch.bfloat16, torch.float8_e4m3fn),
                                           (torch.float32, torch.float8_e4m3fn))
              for d in (128, 80)]
    check(all(seen[k] == (0, 0) for k in served),
          "the tensor-core paged kernels Llama (d 128) and qwen3-32b (d 80) decode run, from "
          "a bf16 or an e4m3 cache (q bf16 or float32), do not spill")
    sass = build.sass("paged_attention")
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in PAGED_SASS}
    check(all(counts.values()), f"paged library SASS holds tensor-core and ldmatrix "
          f"instructions: {counts}")


def ssd_build_proof(build) -> None:
    """Each ssd_chunk instantiation as ptxas built it, by B/C dtype: registers,
    spill stores and loads, static and dynamic shared memory, CTAs per SM;
    the bf16 one (the served model) must not spill, and the library's SASS
    must hold tensor-core instructions."""
    import re

    import torch

    from repro_torch.kernels import ssd_chunk as ssd

    log = build.build_log("ssd_chunk")
    seen = {}
    for fn, body in re.findall(r"Compiling entry function '(\S*ssd_chunk_kernel\S*)'"
                               r"(.*?)Compile time", log, flags=re.S):
        dtype = torch.bfloat16 if "nv_bfloat16" in fn else torch.float32
        regs = int(re.search(r"Used (\d+) registers", body).group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        seen[dtype] = stores, loads = int(spill.group(1)), int(spill.group(2))
        print(f"  ssd_chunk kernel, B/C {str(dtype)[6:]}: {regs} registers, spill stores "
              f"{stores} B / loads {loads} B, {smem.group(1) if smem else 0} B static + "
              f"{ssd.smem_bytes(dtype)} B dynamic shared memory, "
              f"{ssd.ctas_per_sm(dtype)} CTAs per SM")
    check(set(seen) == {torch.float32, torch.bfloat16},
          "ptxas reported both ssd_chunk instantiations (B/C float32, bfloat16)")
    check(seen[torch.bfloat16] == (0, 0),
          "the ssd_chunk instantiation the bf16 model runs does not spill")
    sass = build.sass("ssd_chunk")
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SSD_SASS}
    check(sum(counts.values()) > 0, f"ssd_chunk library SASS holds tensor-core "
          f"instructions: {counts}")


def ssd_bwd_build_proof(build) -> None:
    """ssd_chunk_bwd's kernels as ptxas built them, by B/C dtype: registers,
    spills and shared memory; the main kernel's dynamic shared memory and
    CTAs per SM. A spill in the main kernel fails, and so does an
    instantiation of it whose SASS holds no tensor-core instruction."""
    import re

    import torch

    from repro_torch.kernels import ssd_chunk as ssd

    seen = []
    for fn, body in re.findall(r"Compiling entry function '(\S*ssd_bwd_\w+?_kernel\S*)'"
                               r"(.*?)(?=Compiling entry function|\Z)",
                               build.build_log("ssd_chunk_bwd"), flags=re.S):
        kernel = re.search(r"ssd_bwd_(\w+?)_kernel", fn).group(1)
        dtype = "bfloat16" if "nv_bfloat16" in fn else "float32" if "IfE" in fn else "-"
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        extra = ""
        if kernel == "main":
            dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
            extra = (f", {ssd.smem_bytes(dt, 'ssd_chunk_bwd')} B dynamic shared memory, "
                     f"{ssd.ctas_per_sm(dt, 'ssd_chunk_bwd')} CTAs per SM")
            check(spill.group(1) == spill.group(2) == "0",
                  f"ssd_chunk_bwd's main kernel (B/C {dtype}) does not spill")
        print(f"  ssd_chunk_bwd {kernel} kernel, B/C {dtype}: {regs} registers, spill stores "
              f"{spill.group(1)} B / loads {spill.group(2)} B, "
              f"{smem.group(1) if smem else 0} B static shared memory{extra}")
        seen.append((kernel, dtype))
    check(sorted(seen) == sorted([("main", "bfloat16"), ("main", "float32"), ("bc", "bfloat16"),
                                  ("bc", "float32"), ("da", "-")]),
          f"ptxas built ssd_chunk_bwd's kernels for both B/C dtypes: {sorted(seen)}")
    counts = {}
    for fn, body in re.findall(r"Function : (\S*ssd_bwd_main_kernel\S*)(.*?)(?=Function : |\Z)",
                               build.sass("ssd_chunk_bwd"), flags=re.S):
        dtype = "bfloat16" if "nv_bfloat16" in fn else "float32"
        counts[dtype] = {op: len(re.findall(rf"\b{op}\b", body)) for op in SSD_SASS}
    check(set(counts) == {"bfloat16", "float32"}
          and all(sum(c.values()) > 0 for c in counts.values()),
          f"ssd_chunk_bwd's main kernel SASS holds tensor-core instructions for both B/C "
          f"dtypes: {counts}")


def bwd_build_proof(build) -> None:
    """flash_attention_bwd's kernels as ptxas built them: registers and
    spills of each. The wgmma route's dK/dV and dQ kernels per head_dim with
    their dynamic shared memory: a spill there fails, and so does a library
    whose SASS lacks the tensor-core (HGMMA) or TMA (UTMALDG) instructions.
    The CUDA-core route's kernels per dtype with their shared memory at d
    128 and 80; a spill there is printed, not failed."""
    import re

    from repro_torch.kernels import flash_attention as fa

    lib = build.load("flash_attention_bwd", fa.BWD_SIGNATURES)
    log = build.build_log("flash_attention_bwd")
    seen = []
    for fn, body in re.findall(r"Compiling entry function '(\S*_kernel\S*)'"
                               r"(.*?)(?=Compiling entry function|\Z)", log, flags=re.S):
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        spilled = spill.group(1) != "0" or spill.group(2) != "0"
        wgmma = re.search(r"bwd_(dkdv|dq)_wgmma_kernelILi(\d+)E", fn)
        if wgmma:
            kernel, d = wgmma.group(1), int(wgmma.group(2))
            smem = lib.flash_attention_bwd_wgmma_smem({"dkdv": 1, "dq": 2}[kernel], d)
            print(f"  flash_attention_bwd {kernel} kernel (wgmma), d {d}: {regs} registers, "
                  f"spill stores {spill.group(1)} B / loads {spill.group(2)} B, {smem} B "
                  f"dynamic shared memory")
            check(not spilled, f"flash_attention_bwd's wgmma {kernel} kernel at d {d} does "
                  f"not spill")
            seen.append((kernel, d))
            continue
        if "bwd_stat_kernel" in fn:
            print(f"  flash_attention_bwd delta kernel (wgmma: D and the log-sum-exp per row): "
                  f"{regs} registers, spill stores {spill.group(1)} B / loads {spill.group(2)} B")
            continue
        kernel = re.search(r"flash_bwd_(\w+?)_kernel", fn).group(1)
        dtype = "bfloat16" if "bfloat16" in fn else "float32"
        smem = {d: lib.flash_attention_bwd_smem({"dkdv": 1, "dq": 2}[kernel], d)
                for d in (128, 80)} if kernel != "delta" else {}
        print(f"  flash_attention_bwd {kernel} kernel (cuda_cores), {dtype}: {regs} registers, "
              f"spill stores {spill.group(1)} B / loads {spill.group(2)} B"
              f"{' (SPILLS)' if spilled else ''}"
              + (f", dynamic shared memory {smem[128]} B at d 128, {smem[80]} B at d 80"
                 if smem else ""))
    check(sorted(seen) == sorted((k, d) for k in ("dkdv", "dq") for d in fa.WGMMA_HEAD_DIMS),
          f"ptxas built the backward's wgmma kernels at every head_dim: {sorted(seen)}")
    sass = build.sass("flash_attention_bwd")
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in FLASH_SASS}
    check(all(counts.values()), f"flash_attention_bwd library SASS holds tensor-core and TMA "
          f"instructions: {counts}")


def bwd_row() -> dict:
    """flash_attention_bwd on each route against flash_attention_bwd_ref at
    BWD_SHAPES and at FLASH_SHAPES (the wgmma route at every bf16 shape, the
    CUDA-core route at every shape), the wgmma route rerun bit for bit; each
    route timed at each BWD_SHAPES entry against the plain version, its bound
    and SDPA's backward; the forward's log-sum-exp against the plain one on
    both routes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)

    def inputs(b, sq, skv, hq, hkv, d, dtype):
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]

    def compared(q, k, v, do, causal, label):
        """{route: (max rel, max abs)} of every route that takes the inputs;
        (o, lse) of the forward."""
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
        tol = FLASH_TOL if q.dtype == torch.bfloat16 else F32_GRAD_TOL
        errs = {}
        for route_name in fa.ROUTES:
            if route_name == "wgmma" and fa.route(q.dtype, q.shape[3]) != "wgmma":
                continue
            before = dict(fa.flash_attention_bwd.launches_by_route)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, force_route=route_name)
            after = fa.flash_attention_bwd.launches_by_route
            rel = max(_rel(a, b) for a, b in zip(got, want))
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            check(after[route_name] == before[route_name] + 1 and sum(after.values())
                  == sum(before.values()) + 1 and rel <= tol,
                  f"flash_attention_bwd ({route_name}) within {tol} of the largest |grad| at "
                  f"{label} (max rel {rel:.3g}, abs {err:.3g})")
            if route_name == "wgmma":
                again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, force_route="wgmma")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"flash_attention_bwd (wgmma) rerun at {label}: the same bits")
            errs[route_name] = (rel, err)
        return o, lse, errs

    def lse_check(q, k, v, route_name):
        _, lse = fa.flash_attention(q, k, v, causal=True, force_route=route_name,
                                    return_lse=True)
        _, want = ref.flash_attention_lse_ref(q, k, v, causal=True)
        e = (lse - want).abs().max().item()
        check(e <= LSE_TOL, f"flash_attention ({route_name}, {q.dtype}) stores the "
              f"log-sum-exp within {LSE_TOL} of the plain one at q {tuple(q.shape)} "
              f"(max |err| {e:.3g})")
        return e

    shapes, row = {}, None
    for label, (b, sq, skv, hq, hkv, d, causal, dt) in BWD_SHAPES.items():
        dtype = getattr(torch, dt)
        q, k, v, do = inputs(b, sq, skv, hq, hkv, d, dtype)
        o, lse, errs = compared(q, k, v, do, causal, f"{label} q {tuple(q.shape)} {dt}")
        main = fa.route(dtype, d)  # the route the training path takes
        flops, moved = fa.flash_attention_bwd.cost(b, sq, skv, hq, hkv, d, causal,
                                                   q.element_size())
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        dot = do.transpose(1, 2)
        by_route = {r_: device_ms(lambda r_=r_: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal, force_route=r_)) for r_ in errs}
        r = dict(q=list(q.shape), kv=list(k.shape), dtype=dt, route=main,
                 max_rel_err=errs[main][0], max_abs_err=errs[main][1], ms=by_route[main],
                 ms_by_route=by_route, max_rel_err_by_route={k_: e[0] for k_, e in errs.items()},
                 plain_ms=device_ms(
                     lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal), iters=5),
                 bound_ms=max(flops / BF16_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3,
                 bound_by="operations" if flops / BF16_FLOP_PER_S > moved / HBM_BYTES_PER_S
                 else "bytes",
                 library_ms=device_ms(lambda: torch.autograd.grad(
                     out, (qt, kt, vt), dot, retain_graph=True)))
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        grids = fa.bwd_grids(b, sq, skv, hq, hkv)
        print(f"  flash_attention_bwd, {label} (q {tuple(q.shape)}, group {hq // hkv}, {dt}): "
              + ", ".join(f"{r_} {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s)"
                          for r_, ms in by_route.items())
              + f"; plain {r['plain_ms']:.4f}, SDPA backward {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}"
              + (f"; wgmma grids dK/dV {grids['dkdv']}, dQ {grids['dq']} CTAs"
                 if "wgmma" in by_route else ""))
        if row is None:  # the training path's shape: the row itself, with the forward beside
            check(by_route["wgmma"] <= BWD_TRAIN_MS,
                  f"flash_attention_bwd (wgmma) at {label}: {by_route['wgmma']:.4f} ms <= "
                  f"{BWD_TRAIN_MS} ms")
            row = dict(
                name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/attention.py:128",
                replaces_note="no Pallas backward exists: JAX trains through jax.grad of its "
                              "jnp chunked flash attention (this line); the forward kernel "
                              "differentiated is src/repro/kernels/flash_attention.py:135",
                **{k_: r[k_] for k_ in ("max_abs_err", "max_rel_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms", "tflops",
                                        "ms_by_route", "max_rel_err_by_route")},
                fwd_ms=device_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
                fwd_lse_ms=device_ms(
                    lambda: fa.flash_attention(q, k, v, causal=causal, return_lse=True)),
                lse_err={"wgmma": lse_check(q, k, v, "wgmma"),
                         "cuda_cores": lse_check(q[:1, :1024], k[:1, :1024], v[:1, :1024],
                                                 "cuda_cores")},
            )
            print(f"  flash_attention forward at {label}: {row['fwd_ms']:.4f} ms, with its "
                  f"log-sum-exp {row['fwd_lse_ms']:.4f} ms")
        else:
            shapes[label] = r
        if dtype == torch.float32:
            row["lse_err"]["cuda_cores_f32"] = lse_check(q, k, v, "cuda_cores")
        del q, k, v, do, o, lse, qt, kt, vt, out, dot
    rels = {name: [] for name in fa.ROUTES}
    for b, sq, skv, nq, nkv, d, causal in FLASH_SHAPES:
        q, k, v, do = inputs(b, sq, skv, nq, nkv, d, torch.bfloat16)
        for name, (rel, _) in compared(q, k, v, do, causal,
                                       f"b {b}, sq {sq}, skv {skv}, heads {nq}/{nkv}, d {d}, "
                                       f"{'causal' if causal else 'non-causal'}")[2].items():
            rels[name].append(rel)
    row["max_rel_err_shapes"] = {name: max(x) for name, x in rels.items()}
    row["shapes"] = shapes
    return row


def phase_small() -> None:
    from repro_torch.configs.registry import get_config

    small_engine("llama3.1-8b")
    small_engine("arctic-480b")
    # qwen3-32b's head_dim 80 and group 8 (reduced_config would force d 16)
    small_engine("qwen3-32b", dataclasses.replace(
        get_config("qwen3-32b"), name="qwen3-32b-narrow", n_layers=2, d_model=640, n_heads=8,
        n_kv_heads=1, d_ff=256, vocab_size=256))
    small_model("mamba2-2.7b")
    small_model("jamba-1.5-large-398b")
    small_model("musicgen-large")
    small_model("internvl2-26b")
    small_model("llama3.1-8b", fp8=True)
    small_train("olmo-1b")
    small_train("llama3.1-8b")
    small_resume("mamba2-2.7b")


def small_train(arch: str) -> None:
    """One float32 train step of a reduced stack (``make_train_step``,
    AdamW, remat "full") on the card and on the CPU from the same weights
    and SyntheticLM batch: loss, grad norm, every gradient leaf (relative to
    its largest entry) and the updated weights within SMALL_TOL; on the
    card, flash's forward kernel twice a layer (the recompute) on the
    cuda_cores route and the backward kernels once a layer."""
    import torch

    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state, tree_leaves
    from repro_torch.training.train_loop import make_train_step, to_device, value_and_grad

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, "cuda")
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    batch = next(SyntheticLM(DataConfig(seq_len=70, global_batch=2, vocab_size=cfg.vocab_size)))
    cpu_b, card_b = to_device(batch, "cpu"), to_device(batch, "cuda")
    loss_c, _, g_c = value_and_grad(model, params, cpu_b)
    ops.reset_launch_counts()
    loss_g, _, g_g = value_and_grad(model, on_card, card_b)
    torch.cuda.synchronize()
    launches, routes, bwd = ops.launch_counts(), ops.flash_routes(), ops.bwd_kernels()
    L = cfg.n_layers
    check(launches["flash_attention"] == routes["cuda_cores"] == 2 * L
          and launches["flash_attention_bwd"] == L and set(bwd.values()) == {L},
          f"reduced fp32 {arch} train step: flash forward {2 * L} (twice a layer), backward "
          f"{L}, each of its kernels {L}: {launches['flash_attention']}, {routes}, {bwd}")
    grad_gap = max(_rel(a.cpu(), b) for a, b in zip(tree_leaves(g_g), tree_leaves(g_c)))
    opt = OptimizerConfig()
    p_c, _, m_c = make_train_step(model, opt)(params, init_opt_state(opt, params), cpu_b)
    p_g, _, m_g = make_train_step(model, opt)(on_card, init_opt_state(opt, on_card), card_b)
    loss_gap = abs(float(m_g["loss"]) - float(m_c["loss"]))
    norm_gap = abs(float(m_g["grad_norm"]) / float(m_c["grad_norm"]) - 1)
    param_gap = max((a.cpu() - b).abs().max().item()
                    for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)))
    check(max(abs(float(loss_g) - float(loss_c)), grad_gap, loss_gap, norm_gap,
              param_gap) <= SMALL_TOL,
          f"reduced fp32 {arch} train step, card vs CPU: loss {loss_gap:.3g}, grad norm "
          f"(relative) {norm_gap:.3g}, gradient leaves (relative) {grad_gap:.3g}, updated "
          f"weights {param_gap:.3g}, all <= {SMALL_TOL}")


def small_resume(arch: str) -> None:
    """A reduced float32 stack trained on the card: 4 steps through
    ``run_train_loop`` with a checkpoint, a restore into fresh tensors, 4
    more; weights, moments, step and every metric equal an unbroken 8 bit
    for bit, and the resumed steps launch ``ssd_chunk`` twice a layer (the
    recompute) and ``ssd_chunk_bwd`` once."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import (OptimizerConfig, init_opt_state, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_loop import TrainLoopConfig, run_train_loop

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    opt = OptimizerConfig(warmup_steps=2, total_steps=8)
    data_cfg = DataConfig(seq_len=96, global_batch=2, vocab_size=cfg.vocab_size)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    p8, s8, h8 = run_train_loop(model, opt, TrainLoopConfig(steps=8, log_every=1),
                                SyntheticLM(data_cfg), params=tree_map(torch.clone, params))
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        _, _, h4 = run_train_loop(model, opt, TrainLoopConfig(
            steps=4, log_every=1, checkpoint_every=4, checkpoint_dir=ckdir),
            SyntheticLM(data_cfg), params=params)
        del params  # the crash
        ck = Checkpointer(ckdir)
        fresh = init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
        tree = ck.restore(4, {"params": fresh, "opt_state": init_opt_state(opt, fresh)})
        data = SyntheticLM(data_cfg)
        data.load_state_dict(ck.load_extra(4)["data_state"])
        ops.reset_launch_counts()
        p, s, h = run_train_loop(model, opt, TrainLoopConfig(steps=8, log_every=1), data,
                                 params=tree["params"], opt_state=tree["opt_state"],
                                 start_step=4)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        shutil.rmtree(ckdir)
    L = cfg.n_layers
    check(launches["ssd_chunk"] == 4 * 2 * L and launches["ssd_chunk_bwd"] == 4 * L,
          f"reduced fp32 {arch} resumed for 4 steps: ssd_chunk {launches['ssd_chunk']} "
          f"(== {8 * L}), ssd_chunk_bwd {launches['ssd_chunk_bwd']} (== {4 * L})")
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(p8)))
          and all(torch.equal(a, b) for a, b in zip(tree_leaves(s), tree_leaves(s8)))
          and h4 + h == h8,
          f"reduced fp32 {arch}: 4 steps, a checkpoint, a restore into fresh tensors and 4 "
          f"more equal an unbroken 8 bit for bit (weights, moments, step {int(s['step'])}, "
          f"losses {[round(x['loss'], 6) for x in h]})")


def small_engine(arch: str, cfg=None) -> None:
    """A reduced attention stack (or ``cfg``) in float32 served cold and warm
    through ``RealEngine`` on the card (kernels) and on the CPU (plain
    versions) with the same weights: per-step logits within SMALL_TOL, equal
    tokens; its prefill's flash calls (float32) take the cuda_cores route."""
    import torch

    from repro_torch.configs.registry import reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.serving.real_runner import RealEngine

    cfg = dataclasses.replace(cfg or reduced_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ops.reset_launch_counts()
    engines = {
        "cuda": RealEngine.create(cfg, max_len=128, pool_blocks=64, device="cuda",
                                  params=_to(params, "cuda")),
        "cpu": RealEngine.create(cfg, max_len=128, pool_blocks=64, device="cpu",
                                 params=params),
    }
    prompt = torch.randint(0, cfg.vocab_size, (48,), generator=torch.Generator().manual_seed(3))
    got = {}
    for name, eng in engines.items():
        got[name] = [eng.generate(prompt.tolist(), max_new=8) for _ in range(2)]
    routes = ops.flash_routes()
    check(routes["cuda_cores"] == cfg.n_layers and routes["wgmma"] == 0,
          f"{cfg.name} fp32 (head_dim {cfg.head_dim}) prefill took the cuda_cores route: "
          f"{routes}")
    for i, label in enumerate(("cold", "warm")):
        (tg, ig), (tc, ic) = got["cuda"][i], got["cpu"][i]
        diff = (ig["logits"].cpu() - ic["logits"]).abs().max().item()
        check(ig["hit_tokens"] == ic["hit_tokens"] == 48 * i
              and diff <= SMALL_TOL and tg == tc,
              f"{cfg.name} fp32 {label}: card vs CPU logits max |diff| {diff:.3g} "
              f"<= {SMALL_TOL}, hits {ig['hit_tokens']}")


def small_model(arch: str, fp8: bool = False) -> None:
    """A reduced stack in float32 through ``Model`` on the card and on the
    CPU with the same weights: a prefill of two rows of 70 tokens (Mamba-2
    and Jamba: three chunks, the last padded), 70 seeded audio frame
    embeddings (musicgen-large) or 8 seeded patch embeddings before 70
    tokens (internvl2-26b), then 8 decode steps; logits within SMALL_TOL.
    With ``fp8`` (an e4m3 KV cache) the prefill's caches must match bit for
    bit and the logits stay within FP8_SMALL_TOL; the rows decode writes may
    round to a neighbouring e4m3 value (counted)."""
    import torch

    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import Model, init_params

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, "cuda")
    model = Model(cfg, runtime=RuntimeConfig(use_fp8_kv=fp8))
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 70), generator=gen)
    batch, s = {"tokens": tokens}, 70
    if cfg.frontend == "audio_stub":
        batch = {"frame_embeds": torch.randn((2, 70, cfg.d_model), generator=gen)}
    elif cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                                            generator=gen)
        s += cfg.n_frontend_tokens
    max_len = -(-(s + 8) // 16) * 16
    lg_cpu, cache_cpu = model.prefill_fn(params, batch, max_len=max_len)
    lg_gpu, cache_gpu = model.prefill_fn(on_card, _to(batch, "cuda"), max_len=max_len)
    diffs = [(lg_gpu.cpu() - lg_cpu).abs().max().item()]
    if fp8:
        check(cache_gpu[0].dtype == torch.float8_e4m3fn
              and all(torch.equal(a.view(torch.uint8), b.view(torch.uint8).cpu())
                      for a, b in zip(cache_cpu, cache_gpu)),
              f"reduced fp32 {arch} with an fp8 cache: the prefill's e4m3 caches equal the "
              "CPU's bit for bit")
    for step in range(8):
        tok, pos = tokens[:, step], torch.full((2,), s + step)
        lc = model.decode_fn(params, cache_cpu, tok, pos)
        diffs.append((model.decode_fn(on_card, cache_gpu, tok.cuda(), pos.cuda()).cpu()
                      - lc).abs().max().item())
    tol = FP8_SMALL_TOL if fp8 else SMALL_TOL
    what = f"reduced fp32 {arch}" + (" with an fp8 cache" if fp8 else "")
    if fp8:
        flips = sum(e4m3_neighbours(a, b) for a, b in zip(cache_cpu, cache_gpu))
        print(f"  {what}: after 8 decode steps {flips} e4m3 bytes of the caches one rounding "
              "step from the CPU's (rows written from K/V that carry the decode attention's "
              "bf16 P roundings), none further")
    check(max(diffs) <= tol, f"{what}: card vs CPU prefill and 8 decode steps, logits max "
          f"|diff| {max(diffs):.3g} <= {tol} (per step {[f'{d:.2g}' for d in diffs]})")


def e4m3_neighbours(a, b) -> int:
    """Bytes of two e4m3 tensors that differ; fails unless each such pair is
    at most one rounding step apart: adjacent on the e4m3 number line, where
    -0 and +0 are one point (a value near zero rounds to either)."""
    import torch

    def ordinal(t):
        x = t.view(torch.uint8).cpu().int()
        return torch.where(x >= 0x80, -(x & 0x7F), x)

    x, y = a.view(torch.uint8).cpu().int(), b.view(torch.uint8).cpu().int()
    differ = x != y
    pairs = [(hex(i), hex(j)) for i, j in zip(x[differ].tolist()[:8], y[differ].tolist()[:8])]
    check(bool(((ordinal(a) - ordinal(b)).abs() <= 1).all()),
          f"the {int(differ.sum())} e4m3 bytes that differ are at most one rounding step "
          f"apart: {pairs}")
    return int(differ.sum())


def _to(tree: dict, device) -> dict:
    return _map(tree, lambda t: t.to(device))


def compare_steps(a, b) -> tuple[int, float]:
    """Max |diff| of per-step logits over the steps whose inputs agree:
    step i depends on the tokens emitted before it."""
    (ta, ia), (tb, ib) = a, b
    n = 1
    while n < len(ta) and ta[n - 1] == tb[n - 1]:
        n += 1
    diff = (ia["logits"][:n] - ib["logits"][:n]).abs().max().item()
    return n, diff


def main_prompts(cfg):
    """Phase 4's six requests (two cold, two partial hits on a shared 512
    prefix, two repeats), their expected hit tokens, and the seeded draw
    that made them, to draw more."""
    import numpy as np

    rng = np.random.default_rng(0)
    fresh = lambda n: rng.integers(0, cfg.vocab_size, size=n).tolist()  # noqa: E731
    shared = fresh(SHARED)
    p0, p1 = shared + fresh(PROMPT - SHARED), fresh(PROMPT)
    p2, p3 = shared + fresh(PROMPT - SHARED), shared + fresh(PROMPT - SHARED)
    return fresh, [p0, p1, p2, p3, p0, p1], [0, 0, SHARED, SHARED, PROMPT, PROMPT]


def phase_main(cfg) -> dict:
    import torch

    from repro_torch.experiments import ring_serve as rs
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.real_runner import RealEngine

    t0 = time.perf_counter()
    eng = RealEngine.create(cfg, max_len=MAX_LEN, pool_blocks=POOL_BLOCKS, seed=0)
    torch.cuda.synchronize()
    print(f"  engine up in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    fresh, prompts, want_hits = main_prompts(cfg)
    p0 = prompts[0]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results, chains = [], []
    for p in prompts:
        results.append(eng.generate(p, max_new=MAX_NEW))
        chains.append(rs.chain_state(eng.index, p, eng.pool.layout.block_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = ops.flash_routes()
    peak = torch.cuda.max_memory_allocated()

    for i, ((toks, info), want) in enumerate(zip(results, want_hits)):
        lg = info["logits"]
        print(f"  req {i}: hit {info['hit_tokens']}/{PROMPT}, ttft "
              f"{info['ttft_s'] * 1e3:.2f} ms, total {info['total_s'] * 1e3:.1f} ms, "
              f"tokens {toks[:6]}...")
        check(info["hit_tokens"] == want, f"req {i} hit_tokens {info['hit_tokens']} == {want}")
        check(len(toks) == MAX_NEW and lg.shape == (MAX_NEW, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()), f"req {i}: {MAX_NEW} finite logit rows")
    check(all(launches[k] > 0 for k in LLAMA_KERNELS) and launches["ssd_chunk"] == 0,
          f"every kernel of the path launched: {launches}")
    # decode steps: a hit's tail (or its re-fed last token), then MAX_NEW - 1
    steps = sum(
        (len(p) - min(info["hit_tokens"], len(p) - 1) if info["hit_tokens"] else 0)
        + len(toks) - 1
        for p, (toks, info) in zip(prompts, results)
    )
    cold = want_hits.count(0)
    check(launches["flash_attention"] == routes["wgmma"] == cold * cfg.n_layers
          and routes["cuda_cores"] == 0,
          f"all {launches['flash_attention']} flash launches ({cold} cold prefills x "
          f"{cfg.n_layers} layers) took the wgmma route: {routes}")
    check(launches["paged_attention"] == cfg.n_layers * steps,
          f"paged_attention launched {launches['paged_attention']} times = "
          f"{cfg.n_layers} layers x {steps} decode steps")

    # the cache restored from the pool is the KV prefill wrote, bit for bit
    cold_k, cold_v = results[0][1]["kv"]
    hits = eng.index.match_prefix(p0)
    rk, rv = eng.fetch([b for _, b, _ in hits])
    torch.cuda.synchronize()
    check(len(hits) * 16 == PROMPT
          and torch.equal(rk[:, :, :PROMPT], cold_k[:, :, :PROMPT])
          and torch.equal(rv[:, :, :PROMPT], cold_v[:, :, :PROMPT])
          and not rk[:, :, PROMPT:].any() and not rv[:, :, PROMPT:].any(),
          f"pool round trip of {len(hits)} blocks is bit-exact, unmapped slots zero")
    del rk, rv
    for cold, warm in ((0, 4), (1, 5)):
        n, diff = compare_steps(results[cold], results[warm])
        check(diff <= LOGIT_TOL, f"warm req {warm} vs cold req {cold}: max |dlogit| "
              f"{diff:.4g} <= {LOGIT_TOL} over {n} steps (logit std "
              f"{results[cold][1]['logits'].std().item():.3g})")
    plain = Model(cfg, kernel_mode="ref")  # plain attention, same weights
    floor_logits, _ = plain.prefill_fn(eng.params, torch.tensor([p0], device=eng.device),
                                       max_len=PROMPT)
    floor = (floor_logits[0, 0] - results[0][1]["logits"][0]).abs().max().item()
    print(f"  noise floor: cold prefill with plain vs kernel attention, max |dlogit| "
          f"{floor:.4g}")
    for i in (2, 3):  # partial hit (decode over the tail) vs a fresh prefill
        logits, _ = eng.prefill(prompts[i])
        diff = (logits - results[i][1]["logits"][0]).abs().max().item()
        check(diff <= LOGIT_TOL, f"req {i} first-token logits vs prefill: max |dlogit| "
              f"{diff:.4g} <= {LOGIT_TOL}")

    decode_s = sum(info["total_s"] - info["ttft_s"] for _, info in results)
    decode_tok = sum(len(t) - 1 for t, _ in results)
    summary = {
        "wall_s": wall,
        "ttft_ms": [info["ttft_s"] * 1e3 for _, info in results],
        "decode_tok_per_s": decode_tok / decode_s,
        "peak_mem_gib": peak / 2**30,
        "launches": launches,
        "flash_routes": routes,
    }
    print("  main path: " + json.dumps(summary))
    # phase 20's in-process reference: this run, its index a PrefixIndex on
    # a fresh pool, each chain's block ids and epochs read after its request
    in_process = [{"tokens": toks, "logits": info["logits"].cpu(),
                   "hit_tokens": info["hit_tokens"], "block_ids": ids, "epochs": epochs,
                   "ttft_s": info["ttft_s"]}
                  for (toks, info), (ids, epochs) in zip(results, chains)]
    phase_profile(eng, results[0], fresh(PROMPT), results[1][1]["ttft_s"])
    # phase 6 reads this engine's pool: the blocks of p0 and the KV they hold
    return launches, (eng, [b for _, b, _ in hits], cold_k[:, 0], cold_v[:, 0]), in_process


def report_profile(label, events, n, wall_ms, top=5) -> None:
    """Wall, device-kernel time, busy share, aten calls and the top kernels
    of a profiled window of n repeats."""
    import torch

    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    ops_n = sum(e.count for e in events if e.key.startswith("aten::")) / n
    print(f"  {label} (profiled): {wall_ms:.2f} ms wall, device kernels {busy_ms:.2f} ms "
          f"({busy_ms / wall_ms:.1%} busy), {ops_n:.0f} aten ops")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3 / n:.3f} ms  x{e.count // n}  {e.key[:90]}")


def phase_profile(eng, cold, prompt, ttft_s) -> None:
    """Where a cold request's time to first token goes (one profiled cold
    request of a fresh prompt: prefill, pool writeback, first token) and where
    one decode step's time goes (a short profiled window)."""
    import torch

    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        _, info = eng.generate(prompt, max_new=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"  cold TTFT, req 1 of the run: {ttft_s * 1e3:.2f} ms; profiled cold request "
          f"(hit {info['hit_tokens']}): ttft {info['ttft_s'] * 1e3:.2f} ms")
    report_profile(f"cold prefill of {len(prompt)} tokens + writeback", prof.key_averages(), 1,
                   wall_ms, top=8)
    toks, info = cold
    cache = info["kv"]
    pos, steps = PROMPT + len(toks), 8
    with profiled() as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            eng._decode(cache, toks[-1], pos + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    report_profile("decode step", events, steps, wall_ms)
    paged = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and "paged" in e.key) / steps
    check(paged == eng.cfg.n_layers, f"profiled decode step: {paged:g} paged kernels a step "
          f"= {eng.cfg.n_layers} layers (one launch per layer, no merge kernel)")


def _rel(a, b) -> float:
    """max |a - b| relative to the largest |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def phase_mamba(cfg) -> dict:
    """Full-width mamba2-2.7b through ``Model``: prefill then greedy decode,
    the port's twin of examples/quickstart.py:46-60."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, init_params

    dev = torch.device("cuda")
    # phase 4's engine stays resident for phase 6: memory is counted above it
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters up in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB)")
    rng = np.random.default_rng(5)
    full = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, MAMBA_PROMPTS[1] + 1))).to(dev)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, MAMBA_PROMPTS[0])))
               .to(dev), full[:, :-1]]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs = []
    for tokens in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        state = cache["state"].clone()
        steps, out = [logits[:, 0]], [int(logits[0, 0].argmax())]
        t0 = time.perf_counter()
        for i in range(MAMBA_STEPS):
            pos = torch.tensor([tokens.shape[1] + i], device=dev)
            lg = model.decode_fn(params, cache, torch.tensor([out[-1]], device=dev), pos)
            steps.append(lg)
            out.append(int(lg[0].argmax()))
        torch.cuda.synchronize()
        runs.append(dict(prefill_s=prefill_s, decode_s=time.perf_counter() - t0,
                         logits=torch.cat(steps), tokens=out, state=state))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # each prefill's wall time: one warm-up, then the median of PREFILL_REPEATS
    # (outside the counted run above and every profiler window)
    for tokens, r in zip(prompts, runs):
        model.prefill_fn(params, tokens)
        times = []
        for _ in range(PREFILL_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill_fn(params, tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        r["prefill_ms"] = sorted(times)
    for tokens, r in zip(prompts, runs):
        t = r["prefill_ms"]
        print(f"  prompt {tokens.shape[1]}: prefill median {t[len(t) // 2]:.1f} ms of "
              f"{len(t)} (spread {t[0]:.1f}-{t[-1]:.1f}; the counted run's "
              f"{r['prefill_s'] * 1e3:.1f}), {MAMBA_STEPS} decode steps "
              f"{r['decode_s'] * 1e3:.1f} ms, tokens {r['tokens'][:6]}...")
        check(r["logits"].shape == (MAMBA_STEPS + 1, cfg.padded_vocab)
              and bool(torch.isfinite(r["logits"]).all()),
              f"prompt {tokens.shape[1]}: {MAMBA_STEPS + 1} finite logit rows")
    check(launches["ssd_chunk"] == cfg.n_layers * len(prompts)
          and all(launches[k] == 0 for k in LLAMA_KERNELS),
          f"ssd_chunk launched {cfg.n_layers} times per prefill: {launches}")

    # the final SSM state of the kernel path against the plain path's
    plain = Model(cfg, kernel_mode="ref")
    _, pcache = plain.prefill_fn(params, prompts[0])
    got, want = runs[0]["state"], pcache["state"]
    rel0, rel = _rel(got[0], want[0]), _rel(got, want)
    check(rel0 <= STATE_TOL_L0 and rel <= STATE_TOL,
          f"final SSM state, kernel vs plain path ({MAMBA_PROMPTS[0]} tokens): layer 0 "
          f"{rel0:.3g} <= {STATE_TOL_L0}, all {cfg.n_layers} layers {rel:.3g} <= {STATE_TOL} "
          "of the largest entry")
    del pcache, got, want

    # continuity, in the model's bf16 (against the floor measured here) and
    # on the same weights in float32 (against CONTINUITY_TOL)
    what = f"prefill {MAMBA_PROMPTS[1]} + decode 1 vs prefill {full.shape[1]}"
    cont_bf16, floor_bf16 = continuity(cfg, params, full)
    lim_bf16 = CONTINUITY_BF16_FLOORS * floor_bf16
    check(cont_bf16 <= lim_bf16, f"bf16 continuity: {what}: {cont_bf16:.3g} of the largest "
          f"logit <= {lim_bf16:.3g} = {CONTINUITY_BF16_FLOORS} x the noise floor (the same "
          f"prefill with plain vs kernel ssd_chunk) {floor_bf16:.3g}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _map(params, lambda t: t.float())
    cont, floor = continuity(cfg32, params32, full)
    del params32
    check(cont <= CONTINUITY_TOL, f"float32 continuity: {what}: {cont:.3g} of the largest "
          f"logit <= {CONTINUITY_TOL} (noise floor {floor:.3g}; margin "
          f"{CONTINUITY_TOL / max(cont, 1e-30):.3g}x)")

    decode_s = sum(r["decode_s"] for r in runs)
    summary = {
        "prefill_ms": {str(t.shape[1]): r["prefill_ms"][PREFILL_REPEATS // 2]
                       for t, r in zip(prompts, runs)},
        "prefill_ms_spread": {str(t.shape[1]): [r["prefill_ms"][0], r["prefill_ms"][-1]]
                              for t, r in zip(prompts, runs)},
        "decode_tok_per_s": MAMBA_STEPS * len(runs) / decode_s,
        "peak_mem_gib": (peak - base) / 2**30,
        "launches": launches,
        "continuity_rel": {"bfloat16": cont_bf16, "float32": cont},
        "noise_floor_rel": {"bfloat16": floor_bf16, "float32": floor},
    }
    print("  mamba path: " + json.dumps(summary))
    profile_model(model, params, prompts, runs[0]["tokens"])
    return launches


def phase_arctic(cfg) -> dict:
    """Arctic-480B at full width, depth cut to ARCTIC_LAYERS, served through
    ``RealEngine`` with the pool: two cold 1024-token requests, one that hits
    a 768-token shared prefix (the tail stepped through decode) and a full
    repeat, 16 new tokens each; then the same requests through the plain
    versions on the card."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.moe import capacity
    from repro_torch.serving.real_runner import RealEngine

    L = cfg.n_layers
    t0 = time.perf_counter()
    eng = RealEngine.create(cfg, max_len=MAX_LEN, pool_blocks=POOL_BLOCKS, seed=0)
    torch.cuda.synchronize()
    experts = eng.params["stack"]["pos_0"]["moe"]
    expert_bytes = sum(experts[w].numel() * experts[w].element_size()
                       for w in ("wi_gate", "wi_up", "wo"))
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"  cut: {L} of 35 layers; widths, heads, 128 experts top-2, the dense residual "
          f"and the vocabulary as published. {n_params / 1e9:.2f} B parameters up in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated); the experts' "
          f"{expert_bytes / 1e9:.2f} GB are all read by every decode step (both dispatch paths "
          f"multiply all 128 experts), at least {expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms a "
          "step at the HBM rate")
    rng = np.random.default_rng(7)
    fresh = lambda n: rng.integers(0, cfg.vocab_size, size=n).tolist()  # noqa: E731
    shared = fresh(ARCTIC_SHARED)
    p0, p1, p2 = shared + fresh(PROMPT - ARCTIC_SHARED), fresh(PROMPT), \
        shared + fresh(PROMPT - ARCTIC_SHARED)
    prompts, want_hits = [p0, p1, p2, p0], [0, 0, ARCTIC_SHARED, PROMPT]

    torch.cuda.reset_peak_memory_stats()
    klog = recording(eng.model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results, ends = [], []
    for p in prompts:
        results.append(eng.generate(p, max_new=MAX_NEW))
        ends.append(len(klog))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = ops.launch_counts(), ops.flash_routes()
    peak = torch.cuda.max_memory_allocated()
    del eng.model.prefill_fn, eng.model.decode_fn  # recording off
    kcalls = [klog[a:b] for a, b in zip([0, *ends], ends)]  # each request's model calls
    del klog

    for i, ((toks, info), want) in enumerate(zip(results, want_hits)):
        lg = info["logits"]
        print(f"  req {i}: hit {info['hit_tokens']}/{PROMPT}, ttft "
              f"{info['ttft_s'] * 1e3:.2f} ms, total {info['total_s'] * 1e3:.1f} ms, "
              f"tokens {toks[:6]}...")
        check(info["hit_tokens"] == want, f"req {i} hit_tokens {info['hit_tokens']} == {want}")
        check(len(toks) == MAX_NEW and lg.shape == (MAX_NEW, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()), f"req {i}: {MAX_NEW} finite logit rows")
    steps = sum(
        (len(p) - min(info["hit_tokens"], len(p) - 1) if info["hit_tokens"] else 0)
        + len(toks) - 1
        for p, (toks, info) in zip(prompts, results)
    )
    cold, hit = want_hits.count(0), len(want_hits) - want_hits.count(0)
    check(launches["flash_attention"] == routes["wgmma"] == cold * L
          and routes["cuda_cores"] == 0,
          f"flash_attention {L} per cold request ({cold} cold), all wgmma: "
          f"{launches['flash_attention']}, {routes}")
    check(launches["paged_attention"] == L * steps,
          f"paged_attention launched {launches['paged_attention']} times = {L} layers x "
          f"{steps} decode steps")
    check(launches["kv_gather_write"] == cold and launches["kv_scatter_read"] == hit
          and launches["ssd_chunk"] == launches["sparse_kv_gather"] == 0,
          f"kv_gather_write once per cold request, kv_scatter_read once per hit: {launches}")

    cold_k, cold_v = results[0][1]["kv"]
    blocks = eng.index.match_prefix(p0)
    rk, rv = eng.fetch([b for _, b, _ in blocks])
    torch.cuda.synchronize()
    check(len(blocks) * 16 == PROMPT
          and torch.equal(rk[:, :, :PROMPT], cold_k[:, :, :PROMPT])
          and torch.equal(rv[:, :, :PROMPT], cold_v[:, :, :PROMPT])
          and not rk[:, :, PROMPT:].any() and not rv[:, :, PROMPT:].any(),
          f"pool round trip of {len(blocks)} blocks is bit-exact, unmapped slots zero")
    del rk, rv, cold_k, cold_v

    # the same requests through the plain versions on the card, same weights:
    # the kernels' rounding is all that differs (the noise floor of the path)
    plain = RealEngine.create(cfg, max_len=MAX_LEN, pool_blocks=POOL_BLOCKS, params=eng.params,
                              kernel_mode="ref")
    plog = recording(plain.model)
    plain_results, ends = [], []
    for p in prompts:
        plain_results.append(plain.generate(p, max_new=MAX_NEW))
        ends.append(len(plog))
    del plain
    pcalls = [plog[a:b] for a, b in zip([0, *ends], ends)]
    del plog
    floor = routed_compare(results, plain_results, kcalls, pcalls)
    del plain_results, pcalls

    # dropped (token, k) pairs per MoE layer in each cold prefill (its first call)
    drops = [[int(a["dropped"]) for a in kcalls[i][0]] for i in (0, 1)]
    margins = [min(float(a["margin"]) for a in kcalls[i][0]) for i in (0, 1)]
    del kcalls
    print(f"  cold prefills of {PROMPT} tokens: capacity {capacity(PROMPT, cfg)} slots per "
          f"expert ({PROMPT * cfg.moe.top_k} (token, k) pairs over {cfg.moe.n_experts} experts); "
          f"dropped pairs per MoE layer {drops}; smallest top-k router margin {margins}")

    decode_s = sum(info["total_s"] - info["ttft_s"] for _, info in results)
    decode_tok = sum(len(t) - 1 for t, _ in results)
    summary = {
        "wall_s": wall,
        "ttft_ms": {"cold": [results[i][1]["ttft_s"] * 1e3 for i in (0, 1)],
                    "partial": results[2][1]["ttft_s"] * 1e3,
                    "full": results[3][1]["ttft_s"] * 1e3},
        "decode_tok_per_s": decode_tok / decode_s,
        "peak_mem_gib": peak / 2**30,
        "expert_gb_per_step": expert_bytes / 1e9,
        "dropped_pairs": drops,
        "kernel_vs_plain": floor,
        "launches": launches,
        "flash_routes": routes,
    }
    print("  arctic path: " + json.dumps(summary))
    phase_profile(eng, results[0], fresh(PROMPT), results[1][1]["ttft_s"])
    return launches


def recording(model) -> list:
    """Shadow ``model``'s prefill and decode (on the instance) so that each
    call also appends its MoE layers' aux dicts, one list per call, to the
    returned log; ``del model.prefill_fn, model.decode_fn`` ends it."""
    log = []
    prefill, decode = model.prefill_fn, model.decode_fn

    def rec_prefill(params, tokens, max_len=None):
        log.append([])
        return prefill(params, tokens, max_len, aux=log[-1])

    def rec_decode(params, cache, tokens, pos):
        log.append([])
        return decode(params, cache, tokens, pos, aux=log[-1])

    model.prefill_fn, model.decode_fn = rec_prefill, rec_decode
    return log


def routed_compare(results, plain_results, kcalls, pcalls) -> list:
    """Per-step logits of the kernel path against the plain path's, request
    by request, over the steps whose input tokens agree. A step is held to
    ARCTIC_LOGIT_TOL where the token it scores was routed alike on both paths in
    every MoE layer (the same experts, the same ones kept). Where it was
    not, a routing flip (a router margin below the two paths' probability
    difference, or a capacity slot taken by another token's flip) is
    reported, not compared. Also reports, per cold prefill, the prompt
    tokens whose experts differ between the paths. ``kcalls`` and ``pcalls``
    hold each request's model calls (``recording``), the last of them the
    calls that scored its logit rows; -> per-request stats."""
    import torch

    out = []
    for i, ((tk, ik), (tp, ip), kc, pc) in enumerate(
            zip(results, plain_results, kcalls, pcalls)):
        check(ik["hit_tokens"] == ip["hit_tokens"] and len(kc) == len(pc),
              f"req {i}: the plain path hits {ip['hit_tokens']} tokens and makes "
              f"{len(pc)} model calls, as the kernel path")
        if not ik["hit_tokens"]:
            flipped = [(_expert_sets(a) != _expert_sets(b)).any(-1).sum().item()
                       for a, b in zip(kc[0], pc[0])]
            print(f"  req {i}: prompt tokens routed to other experts by the plain path, per "
                  f"MoE layer: {flipped} of {PROMPT}")
        n, _ = compare_steps((tk, ik), (tp, ip))
        compared, flips, worst = 0, [], 0.0
        for r, (ka, pa) in enumerate(zip(kc[-len(tk):][:n], pc[-len(tp):][:n])):
            differ = [(layer, a, b) for layer, (a, b) in enumerate(zip(ka, pa))
                      if not (torch.equal(_expert_sets(a)[-1], _expert_sets(b)[-1])
                              and torch.equal(_kept_sets(a)[-1], _kept_sets(b)[-1]))]
            if differ:
                for layer, a, b in differ:
                    ranked = a["probs"][-1].sort(descending=True).values
                    k = a["top_e"].shape[1]
                    print(f"  req {i} step {r}: routing flip in MoE layer {layer}: kernel path "
                          f"experts {a['top_e'][-1].tolist()} kept {a['kept'][-1].tolist()}, "
                          f"plain {b['top_e'][-1].tolist()} kept {b['kept'][-1].tolist()}; "
                          f"top-k gap {(ranked[k - 1] - ranked[k]).item():.3g}, probability "
                          f"difference {(a['probs'][-1] - b['probs'][-1]).abs().max().item():.3g}")
                flips.append(r)
                continue
            compared += 1
            worst = max(worst, (ik["logits"][r] - ip["logits"][r]).abs().max().item())
        check(worst <= ARCTIC_LOGIT_TOL, f"req {i}: kernel vs plain path, max |dlogit| "
              f"{worst:.4g} <= {ARCTIC_LOGIT_TOL} over {compared} of {n} steps routed alike "
              f"(logit std {ip['logits'].std().item():.3g}); routing flips at steps {flips}")
        out.append({"max_dlogit": worst, "steps_compared": compared, "flip_steps": flips})
    return out


def _expert_sets(aux: dict):
    """Each token's chosen experts in ascending order: the set it routes to."""
    return aux["top_e"].sort(dim=-1).values


def _kept_sets(aux: dict):
    """Each token's kept flags in the order of ``_expert_sets``."""
    return aux["kept"].gather(-1, aux["top_e"].sort(dim=-1).indices)


def phase_jamba(cfg) -> dict:
    """Jamba-1.5-Large at full width, one period, JAMBA_EXPERTS experts,
    through ``Model``: a prefill of 1000 tokens, then 16 greedy decode steps."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as stack_lib
    from repro_torch.models.model import Model, init_params
    from repro_torch.models.moe import capacity

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Model(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    print(f"  cut: {cfg.n_layers} of 72 layers (one period: Mamba-2 at positions 0-6, attention "
          f"at 7, MoE at the odd positions), {cfg.moe.n_experts} of 16 experts, top-"
          f"{cfg.moe.top_k} kept (one period with all 16 is about 88 GB); widths, heads and the "
          f"SSD as published. {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B parameters "
          f"up in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    kinds = model.kinds
    n_ssm = sum(k.mixer == "ssm" for k in kinds) * stack_lib.n_periods(cfg)
    n_attn = sum(k.mixer == "attn" for k in kinds) * stack_lib.n_periods(cfg)
    rng = np.random.default_rng(9)
    full = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, JAMBA_PROMPT + 1))).to(dev)
    tokens = full[:, :-1]
    max_len = -(-(JAMBA_PROMPT + JAMBA_STEPS) // 16) * 16

    def ssm_states(cache) -> dict:
        """layer index -> its final SSM state (layer = period x P + position)."""
        caches = stack_lib.position_caches(cache, kinds)
        return {i * len(kinds) + j: caches[j]["state"][i].clone()
                for j, k in enumerate(kinds) if k.mixer == "ssm"
                for i in range(stack_lib.n_periods(cfg))}

    moe_layers = sorted(i * len(kinds) + j for j, k in enumerate(kinds) if k.ffn == "moe"
                        for i in range(stack_lib.n_periods(cfg)))

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    aux = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill_fn(params, tokens, max_len=max_len, aux=aux)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    states = ssm_states(cache)
    steps, out = [logits[:, 0]], [int(logits[0, 0].argmax())]
    t0 = time.perf_counter()
    for i in range(JAMBA_STEPS):
        pos = torch.tensor([JAMBA_PROMPT + i], device=dev)
        lg = model.decode_fn(params, cache, torch.tensor([out[-1]], device=dev), pos)
        steps.append(lg)
        out.append(int(lg[0].argmax()))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lg = torch.cat(steps)
    del cache

    check(lg.shape == (JAMBA_STEPS + 1, cfg.padded_vocab) and bool(torch.isfinite(lg).all()),
          f"prompt {JAMBA_PROMPT}: {JAMBA_STEPS + 1} finite logit rows, tokens {out[:6]}...")
    check(launches["ssd_chunk"] == n_ssm and launches["flash_attention"] == n_attn
          and launches["paged_attention"] == n_attn * JAMBA_STEPS
          and launches["kv_gather_write"] == launches["kv_scatter_read"] == 0
          and launches["sparse_kv_gather"] == 0,
          f"ssd_chunk {n_ssm} and flash_attention {n_attn} per prefill, paged_attention "
          f"{n_attn} per decode step: {launches}")
    drops = [int(a["dropped"]) for a in aux]
    print(f"  prefill of {JAMBA_PROMPT} tokens: capacity {capacity(JAMBA_PROMPT, cfg)} slots per "
          f"expert; dropped (token, k) pairs per MoE layer {drops} of "
          f"{JAMBA_PROMPT * cfg.moe.top_k}; smallest top-k router margin "
          f"{min(float(a['margin']) for a in aux):.3g}")

    times = []
    model.prefill_fn(params, tokens, max_len=max_len)
    for _ in range(PREFILL_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill_fn(params, tokens, max_len=max_len)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    print(f"  prefill median {times[len(times) // 2]:.1f} ms of {len(times)} (spread "
          f"{times[0]:.1f}-{times[-1]:.1f}; the counted run's {prefill_s * 1e3:.1f}), "
          f"{JAMBA_STEPS} decode steps {decode_s * 1e3:.1f} ms")

    # the final SSM states of the kernel path against the plain path's. A
    # token routed to other experts by the plain path (a router margin below
    # the paths' rounding difference) feeds every later layer another input,
    # so the states are held up to the first MoE layer where one was, and
    # the later ones reported
    paux = []
    _, pcache = Model(cfg, kernel_mode="ref").prefill_fn(params, tokens, max_len=max_len,
                                                         aux=paux)
    want = ssm_states(pcache)
    del pcache
    flipped = {layer: ((_expert_sets(a) != _expert_sets(b)).any(-1)
                       | (_kept_sets(a) != _kept_sets(b)).any(-1)).sum().item()
               for layer, a, b in zip(moe_layers, aux, paux)}
    first = min([layer for layer, n in flipped.items() if n] + [cfg.n_layers])
    rels = {layer: _rel(states[layer], want[layer]) for layer in states}
    held = {layer: r for layer, r in rels.items() if layer <= first}
    print(f"  kernel vs plain prefill: tokens routed otherwise per MoE layer {flipped}; final "
          f"SSM state differences per layer {({k: f'{v:.3g}' for k, v in rels.items()})}")
    check(rels[0] <= STATE_TOL_L0 and max(held.values()) <= STATE_TOL,
          f"final SSM states, kernel vs plain path: layer 0 {rels[0]:.3g} <= {STATE_TOL_L0}, "
          f"layers {sorted(held)} (up to the first MoE layer a token was routed otherwise on "
          f"the plain path) {max(held.values()):.3g} <= {STATE_TOL} of the largest entry")
    del states, want, aux, paux

    cfg_c = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=CONTINUITY_CAPACITY))
    routes = []
    cont, floor = continuity(cfg_c, params, full, max_len=max_len, routes=routes)
    stepped, whole, plain = ([(_expert_sets(a)[-1].tolist(), _kept_sets(a)[-1].tolist())
                              for a in r] for r in routes)
    print(f"  continuity: the last token's experts per MoE layer: decoded {stepped}, in the "
          f"prefill {whole}, in the plain prefill {plain}")
    lim = CONTINUITY_BF16_FLOORS * floor
    check(cont <= lim, f"bf16 continuity at capacity factor {CONTINUITY_CAPACITY}: prefill "
          f"{JAMBA_PROMPT - 1} + decode 1 vs prefill {JAMBA_PROMPT}: {cont:.3g} of the largest "
          f"logit <= {lim:.3g} = {CONTINUITY_BF16_FLOORS} x the noise floor (the same prefill "
          f"with the plain kernels' versions) {floor:.3g}")

    summary = {
        "prefill_ms": times[PREFILL_REPEATS // 2],
        "prefill_ms_spread": [times[0], times[-1]],
        "decode_tok_per_s": JAMBA_STEPS / decode_s,
        "peak_mem_gib": peak / 2**30,
        "dropped_pairs": drops,
        "launches": launches,
        "continuity_rel": cont,
        "noise_floor_rel": floor,
    }
    print("  jamba path: " + json.dumps(summary))
    profile_model(model, params, [tokens], out, max_len=max_len)
    return launches


def phase_qwen3(cfg) -> dict:
    """qwen3-32b at full width, depth cut to QWEN3_LAYERS, served through
    ``RealEngine`` with the pool: two cold 1024-token requests, one that hits
    a QWEN3_SHARED-token shared prefix (the tail stepped through decode) and
    a full repeat, MAX_NEW new tokens each; then the same requests through
    the plain versions on the card, the logits held at every step."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.real_runner import RealEngine

    L = cfg.n_layers
    t0 = time.perf_counter()
    eng = RealEngine.create(cfg, max_len=MAX_LEN, pool_blocks=POOL_BLOCKS, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"  cut: {L} of 64 layers; d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} "
          f"heads at head_dim {cfg.head_dim}, d_ff {cfg.d_ff} and the vocabulary "
          f"{cfg.vocab_size} as in the registry. {n_params / 1e9:.2f} B parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16) up in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    rng = np.random.default_rng(9)
    fresh = lambda n: rng.integers(0, cfg.vocab_size, size=n).tolist()  # noqa: E731
    shared = fresh(QWEN3_SHARED)
    p0, p1, p2 = shared + fresh(PROMPT - QWEN3_SHARED), fresh(PROMPT), \
        shared + fresh(PROMPT - QWEN3_SHARED)
    prompts, want_hits = [p0, p1, p2, p0], [0, 0, QWEN3_SHARED, PROMPT]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = [eng.generate(p, max_new=MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = ops.launch_counts(), ops.flash_routes()
    peak = torch.cuda.max_memory_allocated()

    for i, ((toks, info), want) in enumerate(zip(results, want_hits)):
        lg = info["logits"]
        print(f"  req {i}: hit {info['hit_tokens']}/{PROMPT}, ttft "
              f"{info['ttft_s'] * 1e3:.2f} ms, total {info['total_s'] * 1e3:.1f} ms, "
              f"tokens {toks[:6]}...")
        check(info["hit_tokens"] == want, f"req {i} hit_tokens {info['hit_tokens']} == {want}")
        check(len(toks) == MAX_NEW and lg.shape == (MAX_NEW, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()), f"req {i}: {MAX_NEW} finite logit rows")
    steps = sum(
        (len(p) - min(info["hit_tokens"], len(p) - 1) if info["hit_tokens"] else 0)
        + len(toks) - 1
        for p, (toks, info) in zip(prompts, results)
    )
    cold, hit = want_hits.count(0), len(want_hits) - want_hits.count(0)
    check(launches["flash_attention"] == routes["wgmma"] == cold * L
          and routes["cuda_cores"] == 0,
          f"flash_attention {L} per cold request ({cold} cold) at head_dim {cfg.head_dim}, "
          f"all on the wgmma route: {launches['flash_attention']}, {routes}")
    check(launches["paged_attention"] == L * steps,
          f"paged_attention launched {launches['paged_attention']} times = {L} layers x "
          f"{steps} decode steps (one launch per layer per step)")
    check(launches["kv_gather_write"] == cold and launches["kv_scatter_read"] == hit
          and launches["ssd_chunk"] == launches["sparse_kv_gather"] == 0,
          f"kv_gather_write once per cold request, kv_scatter_read once per hit: {launches}")

    cold_k, cold_v = results[0][1]["kv"]
    blocks = eng.index.match_prefix(p0)
    rk, rv = eng.fetch([b for _, b, _ in blocks])
    torch.cuda.synchronize()
    check(len(blocks) * 16 == PROMPT
          and torch.equal(rk[:, :, :PROMPT], cold_k[:, :, :PROMPT])
          and torch.equal(rv[:, :, :PROMPT], cold_v[:, :, :PROMPT])
          and not rk[:, :, PROMPT:].any() and not rv[:, :, PROMPT:].any(),
          f"pool round trip of {len(blocks)} blocks is bit-exact, unmapped slots zero")
    del rk, rv, cold_k, cold_v

    # the same requests through the plain versions on the card, same weights,
    # the decode fed the kernel path's tokens: the kernels' rounding is all
    # that differs, at every step (a greedy near-tie would otherwise end the
    # comparison at its first flip)
    plain = RealEngine.create(cfg, max_len=MAX_LEN, pool_blocks=POOL_BLOCKS, params=eng.params,
                              kernel_mode="ref")
    diffs = []
    for i, (p, (toks, info)) in enumerate(zip(prompts, results)):
        _, pinfo = plain.generate(p, max_new=len(toks), feed=toks)
        n_hit = pinfo["hit_tokens"]
        diff = (info["logits"] - pinfo["logits"]).abs().max().item()
        diffs.append(diff)
        check(diff <= LOGIT_TOL and n_hit == want_hits[i],
              f"req {i} kernel vs plain path: max |dlogit| {diff:.4g} <= {LOGIT_TOL} over all "
              f"{len(toks)} steps (logit std {info['logits'].std().item():.3g})")
    del plain

    decode_s = sum(info["total_s"] - info["ttft_s"] for _, info in results)
    decode_tok = sum(len(t) - 1 for t, _ in results)
    summary = {
        "wall_s": wall,
        "ttft_ms": {"cold": [results[i][1]["ttft_s"] * 1e3 for i in (0, 1)],
                    "partial": results[2][1]["ttft_s"] * 1e3,
                    "full": results[3][1]["ttft_s"] * 1e3},
        "decode_tok_per_s": decode_tok / decode_s,
        "peak_mem_gib": peak / 2**30,
        "kernel_vs_plain_max_dlogit": diffs,
        "launches": launches,
        "flash_routes": routes,
    }
    print("  qwen3 path: " + json.dumps(summary))
    phase_profile(eng, results[0], fresh(PROMPT), results[1][1]["ttft_s"])
    return launches


def model_path(label: str, cfg, batch: dict, seq: int, runtime=None) -> dict:
    """Prefill ``batch`` (``seq`` positions) and MODEL_STEPS greedy decode
    steps through ``Model`` on the card, with random bf16 weights from a
    seed; then the same again with the plain versions beside it, the plain
    path taking each step from a copy of the kernel path's cache (the same
    cache, fp8 or bf16) and the kernel path's token. Checks finite logits,
    flash once a layer per prefill (wgmma) and paged once a layer per step
    (of the cache's instantiation), the kernel path's logits against the
    plain path's at every step; returns the readings, the parameters, the
    kernel path's tokens and logits and its caches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, init_params
    from repro_torch.models.transformer import position_caches

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Model(cfg, runtime=runtime)
    plain = Model(cfg, kernel_mode="ref", runtime=runtime)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {label}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads at head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocabulary "
          f"{cfg.vocab_size}; {n_params / 1e9:.2f} B parameters ({n_params * 2 / 1e9:.2f} GB "
          f"bf16) up in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    max_len = -(-(seq + MODEL_STEPS) // 16) * 16
    L = cfg.n_layers

    def decode_loop(cache, first: int, checked: bool):
        out, steps, gaps = [first], [], []
        for i in range(MODEL_STEPS):
            tok, pos = torch.tensor([out[-1]], device=dev), torch.tensor([seq + i], device=dev)
            if checked:
                snap = _map_cache(cache, torch.clone)
            lg = model.decode_fn(params, cache, tok, pos)
            if checked:
                gaps.append((lg - plain.decode_fn(params, snap, tok, pos)).abs().max().item())
                del snap
            steps.append(lg)
            out.append(int(lg[0].argmax()))
        return out, steps, gaps

    model.prefill_fn(params, batch, max_len=max_len)  # warm-up: plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill_fn(params, batch, max_len=max_len)
    first = int(logits[0, 0].argmax())
    ttft = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, steps, _ = decode_loop(cache, first, checked=False)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches, routes, kv_kinds = ops.launch_counts(), ops.flash_routes(), ops.paged_kv()
    peak = torch.cuda.max_memory_allocated()
    lg = torch.cat([logits[:, 0]] + steps)
    kv_dtype = position_caches(cache, model.kinds)[0]["k"].dtype
    kv_name = str(kv_dtype)[6:]
    check(lg.shape == (MODEL_STEPS + 1, cfg.padded_vocab) and bool(torch.isfinite(lg).all()),
          f"{label}: {MODEL_STEPS + 1} finite logit rows, tokens {toks[:6]}...")
    check(launches["flash_attention"] == routes["wgmma"] == L and routes["cuda_cores"] == 0,
          f"{label}: flash_attention {L} per prefill (one a layer), all wgmma: {routes}")
    check(launches["paged_attention"] == kv_kinds[kv_name] == L * MODEL_STEPS,
          f"{label}: paged_attention {L} a step over {MODEL_STEPS} steps, all of the K/V "
          f"{kv_name} instantiation: {kv_kinds}")
    check(all(launches[k] == 0 for k in ("kv_gather_write", "kv_scatter_read",
                                          "sparse_kv_gather", "ssd_chunk")),
          f"{label}: no pool or SSM kernel on the Model path: {launches}")

    # the plain path beside the kernel path: the prefill on the same batch,
    # each decode step on a copy of the kernel path's cache
    logits2, cache2 = model.prefill_fn(params, batch, max_len=max_len)
    plogits, _ = plain.prefill_fn(params, batch, max_len=max_len)
    gaps = [(logits2 - plogits).abs().max().item()]
    del plogits
    toks2, _, step_gaps = decode_loop(cache2, int(logits2[0, 0].argmax()), checked=True)
    gaps += step_gaps
    check(toks2 == toks, f"{label}: the checked run repeats the counted run's tokens")
    print(f"  {label}: kernel vs plain path, max |dlogit| prefill {gaps[0]:.4g}, decode steps "
          f"{[f'{x:.3g}' for x in gaps[1:]]} (logit std {lg.std().item():.3g})")
    del cache2
    summary = {
        "ttft_ms": ttft * 1e3,
        "decode_tok_per_s": MODEL_STEPS / decode_s,
        "peak_mem_gib": peak / 2**30,
        "kernel_vs_plain_max_dlogit": gaps,
        "launches": launches,
        "flash_routes": routes,
        "paged_kv": kv_kinds,
        "cache_dtype": kv_name,
    }
    return dict(summary=summary, params=params, model=model, cache=cache, tokens=toks,
                logits=lg, max_len=max_len)


def _map_cache(cache, fn):
    if isinstance(cache, tuple):
        return tuple(fn(t) for t in cache)
    return _map(cache, fn)


def profile_decode(label: str, run: dict, seq: int) -> None:
    """A profiled window of 8 decode steps (at the last positions the run
    wrote, which it writes again): wall, device time, busy share, top
    kernels; one paged launch a layer a step."""
    import torch

    model, params, cache, toks = run["model"], run["params"], run["cache"], run["tokens"]
    dev, steps = torch.device("cuda"), 8
    base = seq + MODEL_STEPS - steps
    with profiled() as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model.decode_fn(params, cache, torch.tensor([toks[-1]], device=dev),
                            torch.tensor([base + i], device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    report_profile(f"{label} decode step", events, steps, wall_ms)
    paged = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and "paged" in e.key) / steps
    check(paged == model.cfg.n_layers, f"{label}: profiled decode step: {paged:g} paged kernels "
          f"a step = {model.cfg.n_layers} layers")


def phase_qwen3_fp8(cfg) -> dict:
    """qwen3-32b at full width, QWEN3_LAYERS of 64 layers, with an fp8 KV
    cache through ``Model``: a 1024-token prefill and MODEL_STEPS greedy
    decode steps (``model_path``), the paged launches all of the e4m3
    instantiation; then the same model with a bf16 cache fed the same tokens:
    the logits' gap relative to their largest, and the caches' bytes."""
    import numpy as np
    import torch

    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import position_caches

    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, PROMPT))).to(dev)
    run = model_path("qwen3-32b fp8", cfg, {"tokens": tokens}, PROMPT,
                     RuntimeConfig(use_fp8_kv=True))
    summary, params = run["summary"], run["params"]
    caches = position_caches(run["cache"], run["model"].kinds)
    check(all(c[n].dtype == torch.float8_e4m3fn for c in caches for n in "kv"),
          "qwen3-32b fp8: every layer's K and V cache is float8_e4m3fn")
    gap = max(summary["kernel_vs_plain_max_dlogit"])
    check(gap <= FP8_LOGIT_TOL, f"qwen3-32b fp8: kernel vs plain path at every step on the same "
          f"fp8 cache, max |dlogit| {gap:.4g} <= {FP8_LOGIT_TOL}")

    # the same model and tokens with a bf16 cache
    bf16 = Model(cfg)
    lg16, cache16 = bf16.prefill_fn(params, {"tokens": tokens}, max_len=run["max_len"])
    rows = [lg16[:, 0]]
    for i, tok in enumerate(run["tokens"][:-1]):
        rows.append(bf16.decode_fn(params, cache16, torch.tensor([tok], device=dev),
                                   torch.tensor([PROMPT + i], device=dev)))
    lg16 = torch.cat(rows)
    rel = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(run["logits"], lg16)]
    fp8_bytes = sum(c[n].numel() * c[n].element_size() for c in caches for n in "kv")
    bf16_bytes = sum(t.numel() * t.element_size() for t in cache16)
    summary.update(fp8_vs_bf16_cache_rel_gap=rel, cache_bytes=fp8_bytes,
                   bf16_cache_bytes=bf16_bytes)
    print(f"  qwen3-32b: fp8 vs bf16 cache, logits' gap relative to their largest, per step "
          f"{[f'{x:.3g}' for x in rel]} (max {max(rel):.3g}; JAX's reduced-model test holds it "
          f"under 0.1, tests/test_models.py:152-176); cache {fp8_bytes / 2**20:.2f} MiB against "
          f"{bf16_bytes / 2**20:.2f} MiB in bf16 ({fp8_bytes / bf16_bytes:.2f}x)")
    del cache16, bf16
    print("  qwen3 fp8 path: " + json.dumps(summary))
    profile_decode("qwen3-32b fp8", run, PROMPT)
    launches = dict(summary["launches"],
                    paged_attention_e4m3=summary["paged_kv"]["float8_e4m3fn"])
    return launches


def phase_frontend(label: str, cfg) -> dict:
    """A stub-frontend model at full width through ``Model`` (``model_path``):
    internvl2-26b prefills its 256 seeded patch embeddings before 768 text
    tokens, musicgen-large 1024 seeded audio frame embeddings (PROMPT
    positions either way); the kernel path's logits within DEEP_LOGIT_TOL of
    the plain path's at every step; TTFT, decode tokens/s and peak memory."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    embeds = lambda n: torch.randn((1, n, cfg.d_model), generator=gen,  # noqa: E731
                                   device=dev).to(torch.bfloat16)
    if cfg.frontend == "vision_stub":
        npat = cfg.n_frontend_tokens
        batch = {"patch_embeds": embeds(npat),
                 "tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT - npat), generator=gen,
                                         device=dev)}
        what = f"{npat} patch embeddings + {PROMPT - npat} text tokens"
    else:
        batch, what = {"frame_embeds": embeds(PROMPT)}, f"{PROMPT} audio frame embeddings"
    print(f"  {label}: prefill of {what}, then {MODEL_STEPS} decode steps from token "
          f"embeddings (decode positions from {PROMPT})")
    run = model_path(label, cfg, batch, PROMPT)
    summary = run["summary"]
    gap = max(summary["kernel_vs_plain_max_dlogit"])
    check(gap <= DEEP_LOGIT_TOL, f"{label}: kernel vs plain path at every step, max |dlogit| "
          f"{gap:.4g} <= {DEEP_LOGIT_TOL}")
    print(f"  {label} path: " + json.dumps(summary))
    return summary["launches"]


def continuity(cfg, params, full, max_len: int | None = None,
               routes: list | None = None) -> tuple[float, float]:
    """Prefill all but the last token, decode the last at its position, and
    compare with the last logits of a prefill of all of them; the noise
    floor is that prefill with the plain kernels' versions against the
    kernels. An attention cache holds ``max_len`` tokens. ``routes``, if
    given, receives the MoE aux lists of the decode step, the prefill and
    the plain prefill."""
    import torch

    from repro_torch.models.model import Model

    model, plain = Model(cfg), Model(cfg, kernel_mode="ref")
    s = full.shape[1] - 1
    aux = [[], [], []] if routes is not None else [None] * 3
    _, cache = model.prefill_fn(params, full[:, :-1], max_len=max_len)
    stepped = model.decode_fn(params, cache, full[:, -1], torch.tensor([s], device=full.device),
                              aux=aux[0])
    del cache
    whole, _ = model.prefill_fn(params, full, max_len=max_len, aux=aux[1])
    whole_plain, _ = plain.prefill_fn(params, full, max_len=max_len, aux=aux[2])
    if routes is not None:
        routes.extend(aux)
    return _rel(stepped, whole[:, 0]), _rel(whole_plain[:, 0], whole[:, 0])


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def profile_model(model, params, prompts, toks, max_len: int | None = None) -> None:
    """Where each prefill's and a decode step's time go (Mamba-2: prompts of
    1000 and 4095 tokens; Jamba: 1000, its caches of ``max_len`` tokens)."""
    import torch

    caches = []
    for prompt in prompts:
        torch.cuda.synchronize()
        with profiled() as prof:
            t0 = time.perf_counter()
            caches.append(model.prefill_fn(params, prompt, max_len=max_len)[1])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        report_profile(f"prefill {prompt.shape[1]}", prof.key_averages(), 1, wall_ms, top=6)
    prompt, cache = prompts[0], caches[0]
    del caches[1:]
    steps, dev = 8, prompt.device
    with profiled() as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model.decode_fn(params, cache, torch.tensor([toks[i]], device=dev),
                            torch.tensor([prompt.shape[1] + i], device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    report_profile("decode step", prof.key_averages(), steps, wall_ms, top=6)


def phase_train(cfg) -> dict:
    """olmo-1b at full width and depth trained on the card (module
    docstring, phase 13); returns the launches of (ii)'s 8 steps."""
    import math
    import re

    import torch

    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.experiments import train_bwd_probe as probe
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import (OptimizerConfig, global_norm, init_opt_state,
                                                tree_leaves, tree_map)
    from repro_torch.training.train_loop import (TrainLoopConfig, make_train_step,
                                                 run_train_loop, to_device, value_and_grad)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    runtime = RuntimeConfig(remat="full")
    model = Model(cfg, runtime=runtime)
    plain = Model(cfg, kernel_mode="ref", runtime=runtime)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    L, tokens = cfg.n_layers, TRAIN_BATCH * TRAIN_SEQ
    print(f"  olmo-1b: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} "
          f"heads at head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocabulary {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B parameters up in {time.perf_counter() - t0:.1f} s; batches "
          f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    data = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  vocab_size=cfg.vocab_size))
    opt = OptimizerConfig()

    # (i) one step on the kernel path and on the plain path, same weights and batch
    batch = to_device(next(data), dev)
    loss_k, _, g_k = value_and_grad(model, params, batch)
    loss_p, _, g_p = value_and_grad(plain, params, batch)
    gaps = sorted(((_rel(a, b), name) for (name, a), b in zip(_named(g_k), tree_leaves(g_p))),
                  reverse=True)
    grad_gap = gaps[0][0]
    print(f"  (i) gradient leaves furthest apart, kernel vs plain (relative to the leaf's largest "
          f"entry): {[(n, f'{x:.3g}') for x, n in gaps[:4]]}")
    del g_k, g_p
    pure_k, _, m_k = make_train_step(model, opt)(params, init_opt_state(opt, params), batch)
    p_k = [t.float() for t in tree_leaves(pure_k)]
    p_p, _, m_p = make_train_step(plain, opt)(params, init_opt_state(opt, params), batch)
    param_gap = max((a - b.float()).abs().max().item() for a, b in zip(p_k, tree_leaves(p_p)))
    param_tol = TRAIN_PARAM_LRS * float(m_k["lr"])
    moved = sum(int((a != b.float()).sum()) for a, b in zip(p_k, tree_leaves(params)))
    del p_k, p_p
    loss_gap = abs(float(m_k["loss"]) - float(m_p["loss"]))
    norm_gaps = [abs(float(m_k["grad_norm"]) / float(m_p["grad_norm"]) - 1)]
    later = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                   vocab_size=cfg.vocab_size))
    later.load_state_dict({"step": 1})
    for _ in range(1, TRAIN_NORM_BATCHES):  # the same gap on the next batches
        b_ = to_device(next(later), dev)
        g_k = value_and_grad(model, params, b_)[2]
        n_k = float(global_norm(g_k))
        del g_k
        n_p = float(global_norm(value_and_grad(plain, params, b_)[2]))
        norm_gaps.append(abs(n_k / n_p - 1))
    norm_gap = max(norm_gaps)
    print(f"  (i) one step, kernel vs plain path: loss {float(m_k['loss']):.6f} vs "
          f"{float(m_p['loss']):.6f}, grad norm {float(m_k['grad_norm']):.6f} vs "
          f"{float(m_p['grad_norm']):.6f}; {moved} of {n_params} weights moved by the step "
          f"(lr {float(m_k['lr']):.3g})")
    check(abs(float(loss_k) - float(loss_p)) <= TRAIN_LOSS_TOL and loss_gap <= TRAIN_LOSS_TOL,
          f"(i) loss, kernel vs plain: |diff| {loss_gap:.4g} <= {TRAIN_LOSS_TOL}")
    check(norm_gap <= TRAIN_NORM_TOL,
          f"(i) grad norm, kernel vs plain, batches 0-{TRAIN_NORM_BATCHES - 1}: relative "
          f"{[f'{x:.4g}' for x in norm_gaps]}, each <= {TRAIN_NORM_TOL}")
    check(grad_gap <= TRAIN_GRAD_TOL, f"(i) every gradient leaf, kernel vs plain: relative to "
          f"its largest entry {grad_gap:.4g} <= {TRAIN_GRAD_TOL}")
    check(param_gap <= param_tol, f"(i) the updated weights, kernel vs plain: max |diff| "
          f"{param_gap:.4g} <= {TRAIN_PARAM_LRS} lr = {param_tol:.3g}")
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    layer_f64 = f64_check(probe.capture(model, params, batch, BWD_F64_LAYERS), probe)
    # the in-place loop's first step against the pure step above, bit for bit;
    # the loop steps the tensors it is given, so it gets a copy of the weights
    one, one_state, _ = run_train_loop(model, opt, TrainLoopConfig(steps=1), iter([batch]),
                                       params=tree_map(torch.clone, params))
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(one), tree_leaves(pure_k))),
          "(i) one step of run_train_loop (in place) equals make_train_step's pure step, bit "
          "for bit")
    del one, one_state, pure_k

    # (ii) TRAIN_STEPS steps through run_train_loop, counted, timed
    stamps = []

    def on_metrics(step, metrics):
        stamps.append(time.perf_counter())

    trained = tree_map(torch.clone, params)  # params start the pure replay below
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stamps.append(time.perf_counter())
    trained, state, history = run_train_loop(
        model, opt, TrainLoopConfig(steps=TRAIN_STEPS, log_every=1), data, params=trained,
        on_metrics=on_metrics)
    launches, routes, bwd = ops.launch_counts(), ops.flash_routes(), ops.bwd_kernels()
    bwd_routes = ops.bwd_routes()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    check(len(history) == TRAIN_STEPS and all(map(math.isfinite, losses + norms)),
          f"(ii) {TRAIN_STEPS} steps through run_train_loop: finite losses "
          f"{[f'{x:.4f}' for x in losses]}, grad norms {[f'{x:.4f}' for x in norms]}")
    check(launches["flash_attention"] == routes["wgmma"] == 2 * L * TRAIN_STEPS
          and launches["flash_attention_bwd"] == bwd_routes["wgmma"] == L * TRAIN_STEPS
          and set(bwd.values()) == {L * TRAIN_STEPS},
          f"(ii) per step: flash forward {launches['flash_attention'] / TRAIN_STEPS:g} "
          f"({L} + {L} recomputed, wgmma: {routes}), backward "
          f"{launches['flash_attention_bwd'] / TRAIN_STEPS:g} ({bwd_routes}), its kernels "
          f"{bwd}")
    check(all(launches[k] == 0 for k in ("kv_gather_write", "kv_scatter_read",
                                          "paged_attention", "ssd_chunk", "ssd_chunk_bwd",
                                          "sparse_kv_gather")),
          f"(ii) no pool, paged or SSM kernel on the training path: {launches}")
    step_s = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    step_ms = step_s[len(step_s) // 2] * 1e3  # median
    attn_flops = 4 * cfg.n_heads * cfg.head_dim * TRAIN_BATCH * fa.attn_pairs(
        TRAIN_SEQ, TRAIN_SEQ, True) * L
    model_flops = 6 * n_params * tokens + 3 * attn_flops  # forward + backward, no recompute
    summary = {
        "step_ms": step_ms, "step_ms_all": [x * 1e3 for x in step_s],
        "tokens_per_s": tokens / (step_ms * 1e-3),
        "model_tflop_per_step": model_flops / 1e12,
        "model_flop_share": model_flops / (step_ms * 1e-3) / BF16_FLOP_PER_S,
        "peak_mem_gib": peak / 2**30, "losses": losses, "grad_norms": norms,
        "kernel_vs_plain": {"loss": loss_gap, "grad_norm_rel": norm_gap,
                            "grad_leaf_rel": grad_gap, "updated_weights": param_gap},
    }
    print(f"  (ii) step {step_ms:.1f} ms (median of {TRAIN_STEPS}; all "
          f"{[f'{x * 1e3:.0f}' for x in step_s]}), {summary['tokens_per_s']:.0f} tokens/s, "
          f"model FLOPs {summary['model_tflop_per_step']:.1f} TFLOP a step "
          f"({summary['model_flop_share']:.1%} of 989 TFLOP/s), peak "
          f"{summary['peak_mem_gib']:.2f} GiB")
    # the same TRAIN_STEPS steps as pure steps from the same weights and batches
    replay = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                    vocab_size=cfg.vocab_size))
    replay.load_state_dict({"step": 1})
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p_pure, s_pure, step = params, init_opt_state(opt, params), make_train_step(model, opt)
    for _ in range(TRAIN_STEPS):
        p_pure, s_pure, _ = step(p_pure, s_pure, to_device(next(replay), dev))
    torch.cuda.synchronize()
    summary["pure_step_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(trained), tree_leaves(p_pure)))
          and all(torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(s_pure))),
          f"(ii) after {TRAIN_STEPS} steps the in-place loop's weights and moments equal "
          f"{TRAIN_STEPS} pure steps', bit for bit")
    print(f"  (ii) peak memory: the in-place loop {summary['peak_mem_gib']:.2f} GiB, the pure "
          f"step {summary['pure_step_peak_mem_gib']:.2f} GiB")
    summary["layer_f64"] = layer_f64
    del p_pure, s_pure
    gc.collect()
    summary["resume"] = train_resume(model, opt, cfg, params, trained, state, history, step_ms)
    del trained, state
    batch = to_device(next(data), dev)
    step = make_train_step(model, opt)
    opt_state = init_opt_state(opt, params)
    torch.cuda.synchronize()
    with profiled() as prof:
        t1 = time.perf_counter()
        out = step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    del out, opt_state
    events = prof.key_averages()
    report_profile("train step", events, 1, wall_ms, top=10)
    attn = {}  # the attention kernels' device time in the profiled step, by kernel
    for e in events:
        name = re.search(r"(\w*(?:flash|bwd)\w*_kernel)", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            ms, n = attn.get(name.group(1), (0.0, 0))
            attn[name.group(1)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    print("  train step's attention kernels (profiled): " + "; ".join(
        f"{k} {ms:.2f} ms x{n}" for k, (ms, n) in sorted(attn.items())))
    summary["attention_kernels_ms"] = {k: ms for k, (ms, _) in attn.items()}

    # (iii) OVERFIT_STEPS steps on one repeated batch: the loss goes down
    fast = OptimizerConfig(peak_lr=1e-3, warmup_steps=1)
    _, _, hist = run_train_loop(model, fast, TrainLoopConfig(steps=OVERFIT_STEPS, log_every=1),
                                iter([batch] * OVERFIT_STEPS), params=params)
    fit = [h["loss"] for h in hist]
    check(fit[-1] < fit[0], f"(iii) {OVERFIT_STEPS} steps on one repeated batch (peak_lr 1e-3, "
          f"no warmup): loss {[f'{x:.4f}' for x in fit]}, last below first")
    summary["overfit_losses"] = fit
    print("  olmo-1b training path: " + json.dumps(summary))
    return launches, losses


def train_resume(model, opt, cfg, params, trained, state, history, step_ms) -> dict:
    """Phase 13 (iv), module docstring: (ii)'s run killed at RESUME_AT and
    resumed bit for bit, then an async save timed under training; one
    checkpoint on disk at a time, in a directory removed at the end."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import init_opt_state, tree_leaves, tree_map
    from repro_torch.training.train_loop import TrainLoopConfig, run_train_loop

    dev = torch.device("cuda")
    data_cfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, vocab_size=cfg.vocab_size)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(trained) + tree_leaves(state))
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(ckdir).free
    print(f"  (iv) {n_bytes / 1e9:.2f} GB of weights and moments; {free / 1e9:.1f} GB free "
          f"where {ckdir} lies")
    out = {"state_gb": n_bytes / 1e9, "disk_free_gb": free / 1e9}
    try:
        # (ii)'s run from its start (batch 0 went to (i)), saved at RESUME_AT
        data = SyntheticLM(data_cfg)
        data.load_state_dict({"step": 1})
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first, first_state, first_hist = run_train_loop(
            model, opt, TrainLoopConfig(steps=RESUME_AT, log_every=1, checkpoint_every=RESUME_AT,
                                        checkpoint_dir=ckdir, keep_checkpoints=1),
            data, params=tree_map(torch.clone, params),
            on_metrics=lambda step, m: stamps.append(time.perf_counter()))
        save_s = time.perf_counter() - stamps[-1]  # the loop saves after step RESUME_AT's metrics
        check(first_hist == history[:RESUME_AT], f"(iv) steps 1-{RESUME_AT} of the run to be "
              "killed repeat (ii)'s metrics")
        ck = Checkpointer(ckdir)
        check(ck.latest_step() == RESUME_AT, f"(iv) latest committed step {ck.latest_step()} "
              f"== {RESUME_AT}")
        on_disk = sum(os.path.getsize(os.path.join(ck.step_dir(RESUME_AT), f))
                      for f in os.listdir(ck.step_dir(RESUME_AT)))
        del first, first_state  # the crash
        gc.collect()
        fresh = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
        target = {"params": fresh, "opt_state": init_opt_state(opt, fresh)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = ck.restore(RESUME_AT, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del target, fresh
        data = SyntheticLM(data_cfg)
        data.load_state_dict(ck.load_extra(RESUME_AT)["data_state"])
        check(data.step == RESUME_AT + 1, f"(iv) the restored data state is at batch "
              f"{data.step}, (ii)'s was at {RESUME_AT + 1}")
        p, s, hist = run_train_loop(model, opt, TrainLoopConfig(steps=TRAIN_STEPS, log_every=1),
                                    data, params=tree["params"], opt_state=tree["opt_state"],
                                    start_step=RESUME_AT)
        peak = torch.cuda.max_memory_allocated()
        check(all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(trained)))
              and all(torch.equal(a, b) for a, b in zip(tree_leaves(s), tree_leaves(state))),
              f"(iv) killed after step {RESUME_AT}, restored and run to {TRAIN_STEPS}: weights, "
              f"both moments and step ({int(s['step'])}) equal (ii)'s, bit for bit")
        check(hist == history[RESUME_AT:], f"(iv) the losses of steps {RESUME_AT + 1}-{TRAIN_STEPS} "
              f"{[h['loss'] for h in hist]} and their grad norms equal (ii)'s")
        shutil.rmtree(ck.step_dir(RESUME_AT))  # one checkpoint on disk at a time

        # an async save of step TRAIN_STEPS, then ASYNC_STEPS steps in place while it writes
        ack = Checkpointer(ckdir, keep=1, async_save=True)
        stamps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ack.save(TRAIN_STEPS, {"params": p, "opt_state": s},
                 extra={"data_state": data.state_dict()})
        block_s = time.perf_counter() - t0
        stamps.append(time.perf_counter())
        run_train_loop(model, opt, TrainLoopConfig(steps=TRAIN_STEPS + ASYNC_STEPS, log_every=1),
                       data, params=p, opt_state=s, start_step=TRAIN_STEPS,
                       on_metrics=lambda step, m: stamps.append(time.perf_counter()))
        ack.wait()
        wall_s = time.perf_counter() - t0
        async_ms = sorted(b - a for a, b in zip(stamps, stamps[1:]))[ASYNC_STEPS // 2] * 1e3
        # what the thread wrote is step TRAIN_STEPS, not the steps taken since
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ack.restore(TRAIN_STEPS, {"params": p, "opt_state": s}, in_place=True)
        torch.cuda.synchronize()
        restore_in_place_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(trained)))
              and all(torch.equal(a, b) for a, b in zip(tree_leaves(s), tree_leaves(state))),
              f"(iv) the async save of step {TRAIN_STEPS}, written while {ASYNC_STEPS} more "
              "steps changed the same tensors in place, restores (in place) to (ii)'s state, "
              "bit for bit")
        del p, s, tree
    finally:
        shutil.rmtree(ckdir)
    out.update({
        "bytes_on_disk": on_disk, "save_s": save_s, "save_gb_per_s": on_disk / save_s / 1e9,
        "restore_s": restore_s, "restore_gb_per_s": on_disk / restore_s / 1e9,
        "restore_in_place_s": restore_in_place_s, "async_blocking_ms": block_s * 1e3,
        "async_wall_s": wall_s, "step_ms_during_async_save": async_ms,
        "step_ms_ii": step_ms, "peak_mem_gib": peak / 2**30})
    print(f"  (iv) {on_disk / 1e9:.3f} GB on disk; sync save {save_s:.2f} s "
          f"({out['save_gb_per_s']:.2f} GB/s); restore into new tensors {restore_s:.2f} s "
          f"({out['restore_gb_per_s']:.2f} GB/s), in place {restore_in_place_s:.2f} s; async "
          f"save blocks {block_s * 1e3:.0f} ms, done after {wall_s:.2f} s; a step while it "
          f"writes {async_ms:.1f} ms (median of {ASYNC_STEPS}; (ii)'s {step_ms:.1f}); peak "
          f"{peak / 2**30:.2f} GiB")
    return out


def ssd_flops(cfg, tokens: int) -> tuple[int, int]:
    """(intra-chunk forward FLOPs, inter-chunk forward FLOPs) of one SSD layer
    over ``tokens`` tokens in chunks: C.B^T per group and P.x and B^T.(w x)
    per head on causal pairs; C.prev per head."""
    ssm = cfg.ssm
    nh, hp, n, g, lc = (ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state, ssm.n_groups,
                        ssm.chunk_size)
    nb, pairs = tokens // lc, lc * (lc + 1) // 2
    intra = nb * g * 2 * pairs * n + nb * nh * (2 * pairs * hp + 2 * lc * n * hp)
    return intra, nb * nh * 2 * lc * n * hp


def phase_train_ssm(cfg) -> dict:
    """mamba2-2.7b at full width and depth trained on the card (module
    docstring, phase 14); returns the launches of (ii)'s steps."""
    import math
    import re

    import torch

    from repro_torch.configs.base import RuntimeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.experiments import ssd_train_probe as probe
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as ssd
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.optimizer import (OptimizerConfig, init_opt_state, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_loop import (TrainLoopConfig, make_train_step,
                                                 run_train_loop, to_device)

    dev = torch.device("cuda")
    L, tokens = cfg.n_layers, TRAIN_BATCH * TRAIN_SEQ
    # (i) float32 weights: the kernel path against the plain path
    t0 = time.perf_counter()
    model, plain, params, data, _ = probe.setup("float32")
    n_params = sum(t.numel() for t in tree_leaves(params))
    ssm = cfg.ssm
    print(f"  mamba2-2.7b: {L} layers, d_model {cfg.d_model}, {ssm.n_heads(cfg.d_model)} SSD "
          f"heads of {ssm.head_dim}, d_state {ssm.d_state}, {ssm.n_groups} group, chunk "
          f"{ssm.chunk_size}, vocabulary {cfg.vocab_size}; {n_params / 1e9:.3f} B parameters "
          f"(float32 for (i)) up in {time.perf_counter() - t0:.1f} s; batches of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    batch = to_device(next(data), dev)
    ops.reset_launch_counts()
    loss_k, g_k, captured = probe.gradient(model, params, batch, SSM_F64_LAYERS)
    counts = ops.launch_counts()
    check(counts["ssd_chunk"] == 2 * L and counts["ssd_chunk_bwd"] == L,
          f"(i) one float32 gradient: ssd_chunk {counts['ssd_chunk']} = 2 x {L} (remat "
          f"\"full\"), ssd_chunk_bwd {counts['ssd_chunk_bwd']} = {L}")
    loss_p, g_p, _ = probe.gradient(plain, params, batch)
    names = [name for name, _ in _named(params)]
    gaps = probe.leaf_gaps(g_k, g_p)
    del g_k
    worst = sorted(zip(gaps, names), reverse=True)
    loss_gap = abs(loss_k - loss_p)
    print(f"  (i) loss kernel {loss_k:.6f} vs plain {loss_p:.6f}; gradient leaves furthest "
          f"apart (relative to the leaf's largest entry): "
          f"{[(n, f'{x:.3g}') for x, n in worst[:4]]}")
    check(loss_gap <= SSM_LOSS_TOL, f"(i) loss, kernel vs plain, float32: |diff| "
          f"{loss_gap:.4g} <= {SSM_LOSS_TOL}")
    check(worst[0][0] <= SSM_GRAD_TOL, f"(i) every gradient leaf, kernel vs plain, float32: "
          f"{worst[0][0]:.4g} of its largest entry <= {SSM_GRAD_TOL} ({worst[0][1]})")
    fault = probe.fault_lib(SSM_FAULT)
    with probe.backward_lib(fault):
        loss_f, g_f, _ = probe.gradient(model, params, batch)
    fault_gap = max(probe.leaf_gaps(g_f, g_p))
    del g_f, g_p
    check(fault_gap > SSM_GRAD_TOL, f"(i) the same limit refuses a planted fault (the kernel "
          f"built without {SSM_FAULT!r}, probe.FAULTS): its furthest leaf {fault_gap:.4g} > "
          f"{SSM_GRAD_TOL}")
    layer_f64, fault_f64 = {}, {}
    for layer, (inputs, outputs) in sorted(captured.items()):
        errs = probe.f64_errors(inputs, outputs)
        layer_f64[layer] = errs
        check(max(errs.values()) <= SSM_F64_TOL,
              f"(i) layer {layer}'s ssd_chunk_bwd against the float64 backward on its inputs: "
              f"{ {k: f'{v:.3g}' for k, v in errs.items()} } of each largest entry <= "
              f"{SSM_F64_TOL}")
        with probe.backward_lib(fault):
            bad = ssd.ssd_chunk_bwd(*inputs)
        fault_f64[layer] = max(probe.f64_errors(inputs, bad).values())
        del bad
    check(all(v > SSM_F64_TOL for v in fault_f64.values()),
          f"(i) the per-layer check refuses the planted fault: "
          f"{ {k: f'{v:.3g}' for k, v in fault_f64.items()} } > {SSM_F64_TOL}")
    del model, plain, params, captured
    gc.collect()
    torch.cuda.empty_cache()

    # (ii) bf16: SSM_TRAIN_STEPS steps through run_train_loop, counted, timed
    model = Model(cfg, runtime=RuntimeConfig(remat="full"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  vocab_size=cfg.vocab_size))
    opt = OptimizerConfig()
    stamps = []

    def on_metrics(step, metrics):
        stamps.append(time.perf_counter())

    trained = tree_map(torch.clone, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stamps.append(time.perf_counter())
    trained, state, history = run_train_loop(
        model, opt, TrainLoopConfig(steps=SSM_TRAIN_STEPS, log_every=1), data, params=trained,
        on_metrics=on_metrics)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    check(len(history) == SSM_TRAIN_STEPS and all(map(math.isfinite, losses + norms)),
          f"(ii) {SSM_TRAIN_STEPS} bf16 steps through run_train_loop: finite losses "
          f"{[f'{x:.4f}' for x in losses]}, grad norms {[f'{x:.4f}' for x in norms]}")
    check(launches["ssd_chunk"] == 2 * L * SSM_TRAIN_STEPS
          and launches["ssd_chunk_bwd"] == L * SSM_TRAIN_STEPS,
          f"(ii) per step: ssd_chunk {launches['ssd_chunk'] / SSM_TRAIN_STEPS:g} ({L} + {L} "
          f"recomputed), ssd_chunk_bwd {launches['ssd_chunk_bwd'] / SSM_TRAIN_STEPS:g}")
    others = ("flash_attention", "flash_attention_bwd", "kv_gather_write", "kv_scatter_read",
              "paged_attention", "sparse_kv_gather")
    check(all(launches[k] == 0 for k in others),
          f"(ii) no flash, pool, paged or sparse kernel on the Mamba-2 training path: "
          f"{launches}")
    step_s = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    step_ms = step_s[len(step_s) // 2] * 1e3  # median
    intra, inter = ssd_flops(cfg, tokens)
    model_flops = 6 * n_params * tokens + 3 * (intra + inter) * L  # forward + backward
    summary = {
        "step_ms": step_ms, "step_ms_all": [x * 1e3 for x in step_s],
        "tokens_per_s": tokens / (step_ms * 1e-3),
        "model_tflop_per_step": model_flops / 1e12,
        "ssd_tflop_per_step": 3 * (intra + inter) * L / 1e12,
        "model_flop_share": model_flops / (step_ms * 1e-3) / BF16_FLOP_PER_S,
        "peak_mem_gib": peak / 2**30, "losses": losses, "grad_norms": norms,
        "kernel_vs_plain_f32": {"loss": loss_gap, "grad_leaf_rel": worst[0][0],
                                "fault_grad_leaf_rel": fault_gap},
        "layer_f64": {str(k): v for k, v in layer_f64.items()},
        "fault_layer_f64": {str(k): v for k, v in fault_f64.items()},
    }
    print(f"  (ii) step {step_ms:.1f} ms (median of {SSM_TRAIN_STEPS}; all "
          f"{[f'{x * 1e3:.0f}' for x in step_s]}), {summary['tokens_per_s']:.0f} tokens/s, "
          f"model FLOPs {summary['model_tflop_per_step']:.1f} TFLOP a step (6 x parameters x "
          f"tokens + 3 x the SSD's forward, {summary['ssd_tflop_per_step']:.2f} TFLOP of it; "
          f"{summary['model_flop_share']:.1%} of 989 TFLOP/s), peak "
          f"{summary['peak_mem_gib']:.2f} GiB")
    # a profiled in-place step: where the step's device time goes
    batch = to_device(next(data), dev)
    step = make_train_step(model, opt, in_place=True)
    torch.cuda.synchronize()
    with profiled() as prof:
        t1 = time.perf_counter()
        step(trained, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    events = prof.key_averages()
    report_profile("mamba2-2.7b train step", events, 1, wall_ms, top=10)
    groups = {"ssd_forward": 0.0, "ssd_backward": 0.0, "gemm": 0.0, "other": 0.0}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ("ssd_forward" if "ssd_chunk_kernel" in e.key
               else "ssd_backward" if "ssd_bwd_" in e.key
               else "gemm" if re.search(r"gemm|xmma|cutlass|nvjet|sm90_", e.key, re.I)
               else "other")
        groups[key] += e.self_device_time_total / 1e3
    busy = sum(groups.values())
    print("  train step's device time by kind (profiled): " + "; ".join(
        f"{k} {ms:.1f} ms ({ms / busy:.1%})" for k, ms in groups.items())
        + f"; {busy:.1f} ms busy of {wall_ms:.1f} ms wall")
    # who launches the elementwise work: aten ops by the device time of the
    # kernels they launch themselves, and backward nodes with their children
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    top_ops = sorted((e for e in host if e.key.startswith("aten::")),
                     key=lambda e: -e.self_device_time_total)[:8]
    nodes = sorted((e for e in host if e.key.startswith("autograd::engine::evaluate_function")),
                   key=lambda e: -e.device_time_total)[:8]
    print("  train step's aten ops by own device time (profiled): " + "; ".join(
        f"{e.key} {e.self_device_time_total / 1e3:.1f} ms x{e.count}" for e in top_ops))
    print("  train step's backward nodes by device time with children (profiled): " + "; ".join(
        f"{e.key.split(': ')[-1]} {e.device_time_total / 1e3:.1f} ms x{e.count}" for e in nodes))
    summary["profile_ms"] = {**groups, "busy": busy, "wall": wall_ms}
    summary["profile_top_ops_ms"] = {e.key: e.self_device_time_total / 1e3 for e in top_ops}
    summary["profile_backward_nodes_ms"] = {e.key.split(": ")[-1]: e.device_time_total / 1e3
                                            for e in nodes}
    del trained, state

    # (iii) OVERFIT_STEPS steps on one repeated batch: the loss goes down
    fast = OptimizerConfig(peak_lr=1e-3, warmup_steps=1)
    _, _, hist = run_train_loop(model, fast, TrainLoopConfig(steps=OVERFIT_STEPS, log_every=1),
                                iter([batch] * OVERFIT_STEPS), params=params)
    fit = [h["loss"] for h in hist]
    check(fit[-1] < fit[0], f"(iii) {OVERFIT_STEPS} steps on one repeated batch (peak_lr 1e-3, "
          f"no warmup): loss {[f'{x:.4f}' for x in fit]}, last below first")
    summary["overfit_losses"] = fit
    print("  mamba2-2.7b training path: " + json.dumps(summary))
    del params
    return launches


def f64_check(captured: dict, probe) -> dict:
    """Phase 13 (i)'s per-layer check: each backward route on the captured
    inputs of BWD_F64_LAYERS against the float64 backward (the RMS relative
    error within BWD_F64_RMS_RATIO of the float64 result's own rounding to
    bf16, the bias within BWD_F64_BIAS); returns the readings."""
    from repro_torch.kernels import flash_attention as fa

    fault = "emulated_drop_tile"  # a wrong backward the check must refuse
    stats = probe.layer_stats(captured, {**{r: probe.route_bwd(r) for r in fa.ROUTES},
                                         fault: probe.emulated("drop_tile"),
                                         "f64_rounded": None})
    out, refused = {}, []
    for (layer, name, grad), (rms, bias) in sorted(stats.items()):
        if name == "f64_rounded":
            continue
        ratio = rms / stats[(layer, "f64_rounded", grad)][0]
        out[f"layer{layer}.{name}.{grad}"] = {"rms_rel": rms, "ratio": ratio, "bias": bias}
        passes = ratio <= BWD_F64_RMS_RATIO and abs(bias) <= BWD_F64_BIAS
        if name == fault:
            refused.append((not passes, f"{ratio:.3g}"))
            continue
        check(passes, f"(i) layer {layer}'s {grad} ({name}) against the float64 backward: RMS "
              f"relative error {rms:.5g}, {ratio:.6f} x the float64 result's bf16 rounding "
              f"<= {BWD_F64_RMS_RATIO}; bias {bias:+.3g}, |bias| <= {BWD_F64_BIAS}")
    check(all(r for r, _ in refused), f"(i) the per-layer check refuses a planted fault (the "
          f"float64 backward without each head's last diagonal 64 x 64 tile): ratios "
          f"{[x for _, x in refused]} at layers {BWD_F64_LAYERS} x (dk, dq, dv), each over "
          f"{BWD_F64_RMS_RATIO}")
    return out


def _named(tree: dict, path: str = ""):
    """(path, leaf) in ``tree_leaves`` order: keys sorted, depth first."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", tree[k]


def _fields(derived: str) -> dict:
    """``a=1;b=x`` -> {"a": "1", "b": "x"}: a twin row's derived column."""
    return dict(f.split("=", 1) for f in derived.split(";") if "=" in f)


def phase_sparse(llama_pool) -> dict:
    """The exp10 twin (on phase 4's pool for Llama-3.1-8B) then the exp09
    twin, untimed: their kernels' times are phase 2's, at the same reads."""
    import torch

    from repro_torch.experiments import exp09_dense_transfer as exp09
    from repro_torch.experiments import exp10_sparse as exp10
    from repro_torch.experiments.common import emit
    from repro_torch.kernels import ops

    eng, block_ids, k, v = llama_pool
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows10 = exp10.run(pools={"llama3.1-8b": (eng.pool.data, block_ids, k, v)}, timed=False)
    rows09 = exp09.run(timed=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print("  rows (exp10.sparse16.<arch> and exp09.<layout>.write|read without a suffix are "
          "MODELED by the paper's CXL/RDMA fabric, not measured):")
    emit(rows10 + rows09)
    rows = {r[0]: r for r in rows10 + rows09}
    reads = ["exp10.topk_gather", "exp10.sparse16.llama3.1-8b.device",
             "exp10.sparse16.qwen3-32b.device"]
    for name in reads:
        f = _fields(rows[name][2])
        check(f["launches"] == "1" and f["bit_exact"] == "True",
              f"{name}: {f.get('pieces', f.get('ids'))} pieces in one launch, bit-exact"
              + (" against the cold prefill's KV" if "llama" in name else ""))
    check(_fields(rows["exp10.topk_gather"][2])["finite"] == "True"
          and rows["exp10.kernel_allclose"][2] == "ok=True",
          "full-width qwen3-32b layer-0 scores finite; the JAX toy case equal to the plain "
          f"version; non-contiguous fraction {rows['exp10.noncontiguous_fraction'][1]} %")
    check(all(_fields(r[2])["bit_exact"] == "True" for n, r in rows.items()
              if n.startswith("exp09.") and n.endswith(".device"))
          and " in 1 kernel launch" in rows["exp09.kernel_single_launch"][2],
          "exp09: one block of each bf16 layout written and read back bit for bit; "
          "one launch packs every fragment")
    check(launches["sparse_kv_gather"] == len(reads) + 1,
          f"sparse_kv_gather launched once per read ({len(reads)} reads + the toy case): "
          f"{launches}")
    print(f"  sparse path: {wall:.1f} s wall, launches {json.dumps(launches)}")
    return launches


def phase_mesh() -> dict:
    """Phase 15: the model under a device mesh, every run at full width
    (``experiments/mesh_probe.py``). Each run's single-device reference is
    computed here first, on the same weights, its results kept on the host
    and the model freed; then ONE world of 4 gloo ranks on the card runs
    the four runs in turn (the collectives first checked on CUDA tensors).
    Every rank runs the kernels on its shards; nothing falls back."""
    import torch

    from repro_torch.distributed.world import run_world
    from repro_torch.experiments import mesh_probe as mp

    t0 = time.perf_counter()
    for name, run in mp.RUNS.items():
        cut = (f"{run['layers']} of {mp.get_layers(run['arch'])} layers" if run["layers"]
               else "all layers")
        print(f"  {name}: {run['arch']} full width, {cut}, mesh {run['mesh'][0]}x"
              f"{run['mesh'][1]}, {run['batch']} x {run['prompt']} prompt tokens, "
              f"{run['gen'] - 1} decode steps, dispatch {run['dispatch']}")
    refs = {name: mp.reference(run, MESH_SEED) for name, run in mp.RUNS.items()}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  references done in {time.perf_counter() - t0:.1f} s; the parent holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB before the ranks start", flush=True)
    # the ranks decode the reference's greedy tokens: every step compares
    # the logits of one context
    forced = {name: ref["tokens"] for name, ref in refs.items() if "hidden" not in ref}
    t1 = time.perf_counter()
    got = run_world(mp.rank_program, 4, (mp.RUNS, MESH_SEED, forced), timeout_s=MESH_TIMEOUT_S)
    world_s = time.perf_counter() - t1
    for mesh in ("1x4", "2x2"):
        check(got[f"collectives_{mesh}"] == [],
              f"mesh {mesh}: all_reduce (sum, max), all_gather (dims 0, 2) and all_to_all "
              "over model, data and both, float32 / bfloat16 / int64, CUDA equal to CPU")
    out = {"world_s": world_s}
    launches = {}
    for name, run in mp.RUNS.items():
        r = mp.readings(name, refs[name], got[name])
        out[name] = r
        layers = run["layers"] or mp.get_layers(run["arch"])
        steps = run["gen"] - 1
        for rank, n in enumerate(r["launches"]):
            want = {"flash_attention": layers if run["arch"] != "mamba2-2.7b" else 0,
                    "paged_attention": layers * steps if run["arch"] != "mamba2-2.7b" else 0,
                    "ssd_chunk": layers if run["arch"] == "mamba2-2.7b" else 0}
            lse = r["paged_with_lse"][rank]
            check(all(n[k] == v for k, v in want.items()) and lse == want["paged_attention"],
                  f"{name} rank {rank}: launches {want} (paged with its lse {lse}) as the path "
                  "says")
        for k, v in got[name]["ranks"][0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        gap = max(r["max_dlogit_per_step"])
        check(gap <= MESH_LOGIT_TOL[name],
              f"{name}: logits against one device, max |dlogit| {gap:.4g} <= "
              f"{MESH_LOGIT_TOL[name]} over {len(r['max_dlogit_per_step'])} steps (logit std "
              f"{r['logit_std']:.3g})")
        if "token_flips" in r:
            # an argmax can differ only where the reference's top two are
            # closer than twice the step's gap; anywhere else is a fault
            ties = r["token_flips"]
            check(all(m <= 2 * g for _, _, m, g in ties),
                  f"{name}: greedy tokens equal at every step but {len(ties)} near-ties "
                  f"(reference top-2 margin within twice the step's gap: "
                  f"{[(st, round(m, 4)) for st, _, m, _ in ties]})")
        if "flips" in r:
            check(r["max_dhidden_alike"] <= MESH_HIDDEN_TOL and max(r["dropped"]) == 0,
                  f"{name}: the layer's outputs at the tokens routed alike, max |d| "
                  f"{r['max_dhidden_alike']:.4g} <= {MESH_HIDDEN_TOL} (output std "
                  f"{r['hidden_std']:.3g}); {r['flips']} of {mp.RUNS[name]['prompt']} tokens "
                  f"routed otherwise; no pair dropped at capacity {run['capacity']}; "
                  f"{r['dropped_published']} pairs dropped at the published "
                  f"{mp.PUBLISHED_CAPACITY}")
        print(f"  {name}: wall {r['wall_s']:.1f} s, peak per rank "
              f"{[round(x, 2) for x in r['peak_gib']]} GiB")
    wall = time.perf_counter() - t0
    print(f"  mesh phase: {wall:.1f} s wall ({world_s:.1f} s the world); collectives are gloo "
          "through host memory on one card, not a multi-GPU time")
    out["wall_s"] = wall
    print(f"  mesh path: {json.dumps(out)}")
    return launches


def phase_mesh_train(phase13_losses: list) -> dict:
    """Phase 16: training under a device mesh, every run at full width
    (``experiments/mesh_train_probe.py``). Each run's one-device reference
    first (olmo-1b's is phase 13's run: its losses must equal phase 13
    (ii)'s, bit for bit), its weights parked on disk and the model freed;
    then ONE world of 4 gloo ranks on the card trains the three runs in
    turn and saves the 2x2 run's checkpoint, which is restored here on one
    device. Every rank runs the kernels on its shards; nothing falls back."""
    from repro_torch.experiments import mesh_train_probe as mp

    t0 = time.perf_counter()
    for name, run in mp.RUNS.items():
        cut = (f"{run['layers']} of {mp.get_layers(run['arch'])} layers" if run["layers"]
               else "all layers")
        print(f"  {name}: {run['arch']} full width, {cut}, mesh {run['mesh'][0]}x"
              f"{run['mesh'][1]}, {run['steps']} AdamW steps on {mp.BATCH} x {mp.SEQ} tokens"
              f"{', then a checkpoint' if run.get('checkpoint') else ''}")
    got = mp.run(seeds=(MESH_TRAIN_SEED,))[MESH_TRAIN_SEED]
    for mesh in ("1x4", "2x2"):
        check(got[f"collectives_{mesh}"] == [],
              f"mesh {mesh}: all_reduce (sum, max), all_gather, all_gather_flat and "
              "all_to_all over model, data and both, float32 / bfloat16, forward and "
              "backward, CUDA equal to CPU")
    olmo = got["olmo_1x4"]
    steps = mp.RUNS["olmo_1x4"]["steps"]
    check(olmo["ref_losses"] == phase13_losses[:steps],
          f"olmo-1b's one-device reference is phase 13's run: losses {olmo['ref_losses']} "
          f"equal phase 13 (ii)'s first {steps}, bit for bit")
    launches = {}
    for name, run in mp.RUNS.items():
        r = got[name]
        n, layers = run["steps"], run["layers"] or mp.get_layers(run["arch"])
        attn = run["arch"] != "mamba2-2.7b"
        want = {"flash_attention": 2 * layers * n if attn else 0,
                "flash_attention_bwd": layers * n if attn else 0,
                "ssd_chunk": 0 if attn else 2 * layers * n,
                "ssd_chunk_bwd": 0 if attn else layers * n,
                "kv_gather_write": 0, "kv_scatter_read": 0, "paged_attention": 0,
                "sparse_kv_gather": 0}
        for rank, (got_n, routes, bwd) in enumerate(zip(r["launches"], r["flash_routes"],
                                                         r["bwd_routes"])):
            per_step = {k: v / n for k, v in got_n.items() if v}
            check(got_n == want and routes["wgmma"] == want["flash_attention"]
                  and bwd["wgmma"] == want["flash_attention_bwd"],
                  f"{name} rank {rank}: launches a step {per_step} (flash on wgmma "
                  f"{routes['wgmma'] / n:g}, its backward {bwd['wgmma'] / n:g}), nothing "
                  f"else: as {layers} layers with their recompute say")
        for k, v in r["launches"][0].items():
            launches[k] = launches.get(k, 0) + v
        check(r["ranks_agree"], f"{name}: every rank reports the same loss and grad norm "
              "at every step")
        check(max(r["loss_rel"]) <= MESH_TRAIN_LOSS_TOL[name],
              f"{name}: loss against one device at each step, relative "
              f"{[f'{x:.4g}' for x in r['loss_rel']]} <= {MESH_TRAIN_LOSS_TOL[name]} (losses "
              f"{[f'{x:.5f}' for x in r['losses']]})")
        check(max(r["grad_norm_rel"]) <= MESH_TRAIN_NORM_TOL[name],
              f"{name}: grad norm against one device at each step, relative "
              f"{[f'{x:.4g}' for x in r['grad_norm_rel']]} <= {MESH_TRAIN_NORM_TOL[name]}")
        check(max(r["moment_gap"].values()) <= MESH_TRAIN_MOMENT_TOL[name],
              f"{name}: each rank's AdamW moments after step {n} against its slices of one "
              f"device's, relative to each leaf's largest entry: m "
              f"{r['moment_gap']['m']:.4g}, v {r['moment_gap']['v']:.4g} <= "
              f"{MESH_TRAIN_MOMENT_TOL[name]}")
        print(f"  {name}: wall {r['wall_s']:.1f} s; steps "
              f"{[f'{x:.2f}' for x in r['step_s']]} s; peak per rank "
              f"{[round(x, 2) for x in r['peak_gib']]} GiB")
    ck = got["checkpoint"]
    check(ck["shards_differ"] == [] and ck["nprocs"] == 4,
          f"olmo_2x2's checkpoint (step {ck['step']}, {ck['nprocs']} processes' files, "
          f"{ck['bytes'] / 1e9:.3f} GB) restored on one device equals every rank's shards, "
          "bit for bit (sha1 of each shard)")
    save_s = got["olmo_2x2"]["save_s"]
    print(f"  checkpoint: save {ck['bytes'] / 1e9 / save_s:.2f} GB/s ({save_s:.1f} s, 4 ranks "
          f"writing), restore on one device {ck['bytes'] / 1e9 / ck['restore_s']:.2f} GB/s "
          f"({ck['restore_s']:.1f} s): disk and host I/O of 4 processes on one machine")
    wall = time.perf_counter() - t0
    print(f"  mesh training phase: {wall:.1f} s wall ({got['world_s']:.1f} s the world); "
          "collectives are gloo through host memory with 4 CUDA contexts on one card, "
          "not a multi-GPU time, and no tokens/s is claimed for them")
    got["wall_s"] = wall
    print(f"  mesh training path: {json.dumps(got)}")
    return launches


def phase_cluster() -> None:
    """Phase 18: the port's exp05 twin (Table 5) at the paper's size on the
    host, each mode's cluster checked and dropped before the next."""
    from repro_torch.experiments import exp05_e2e as exp05
    from repro_torch.serving.scheduler import refcounts_settled

    t0 = time.perf_counter()
    res = {}
    for name, _, _ in exp05.MODES:
        s1, s2, c = exp05.run_mode(name)
        check(len(c.requests) == 512 and all(r.state == "done" for r in c.requests),
              f"exp05 {name}: all 512 requests of both phases finished")
        check(refcounts_settled(c.pool, c.index)
              and all(e.manager.hbm.free_slots() == e.manager.hbm.n_slots for e in c.engines),
              f"exp05 {name}: every pool refcount is what the index owns "
              f"({c.index.stats()['entries']} entries, {c.pool.free_blocks()} blocks free), "
              "every HBM slot free")
        bad = exp05.pinned_mismatches(name, s1, s2)
        check(not bad, f"exp05 {name}: every summary number equals the pinned reference "
                       "(integers exactly, times within 1e-12 relative)" + (f": {bad[:4]}" if bad else ""))
        res[name] = (s1, s2)
        del c
    hit = {name: res[name][1]["avg_ttft_s"] for name in res}
    check(hit["beluga"] < hit["rdma"],
          f"beluga's cache-hit TTFT {hit['beluga']!r} s below rdma's {hit['rdma']!r} s (MODELED)")
    print("  " + exp05.MODELED_NOTE)
    for row in exp05.rows_of(res):
        print("  " + ",".join(row))
    print(f"  phase 18 in {time.perf_counter() - t0:.1f} s of wall time on the host "
          "(the rows above are MODELED; no device)", flush=True)


def phase_tiering() -> None:
    """Phase 19: the tiered pool (module docstring). (i) exp13 / exp03 /
    exp04 on the host; (ii) tier migrations of real payloads on the card."""
    import torch

    from repro_torch.core.index import PrefixIndex
    from repro_torch.core.transfer import PoolTransfer
    from repro_torch.experiments import exp03_skew, exp04_background
    from repro_torch.experiments import exp13_tiering as exp13
    from repro_torch.experiments import tier_churn as tc
    from repro_torch.experiments.cluster_common import mismatches, qwen32b_layout
    from repro_torch.kvcache.hbm_cache import HbmPagedCache
    from repro_torch.kvcache.manager import KVCacheManager
    from repro_torch.serving.scheduler import pending_live, refcounts_settled
    from repro_torch.tiering import MigrationEngine, TieredPool, TieringConfig

    t0 = time.perf_counter()

    def settled(label, c, reqs):
        check(all(r.state == "done" for r in reqs), f"exp13 {label}: all {len(reqs)} requests finished")
        check(refcounts_settled(c.pool, c.index)
              and (c.migrator is None or pending_live(c.pool)),
              f"exp13 {label}: every pool refcount is what the index owns "
              f"({c.index.stats()['entries']} entries, {c.pool.free_blocks()} blocks free)"
              + ("" if c.migrator is None else
                 f", promote_pending's {len(c.pool.promote_pending)} ids live refcount-1 blocks"))

    res = exp13.results_of(False, check=settled)
    bad = exp13.pinned_mismatches(res)
    check(not bad, "exp13: every number equals the pinned reference (integers exactly, times "
                   "within 1e-12 relative)" + (f": {bad[:4]}" if bad else ""))
    ratios = [c["ttft_ratio_3t"] for c in res["tier_chain"]]
    check(len(ratios) == 2 and not exp13.chain_gate(res),
          f"exp13: the 3-tier chain beats destroy-on-evict at os 2 and os 4 "
          f"(ratio_3t {ratios}, MODELED)")
    print("  " + exp13.MODELED_NOTE)
    for row in exp13.rows_of(res):
        print("  " + ",".join(row))
    r3, r4 = exp03_skew.run(), exp04_background.run()
    bw = {name.split(".")[1]: float(d.split("agg_bw=")[1].rstrip("GiB/s")) for name, _, d in r3[:2]}
    check(bw["interleave"] > bw["no_interleave"],
          f"exp03: interleaved queues {bw['interleave']} GiB/s above non-interleaved "
          f"{bw['no_interleave']} (MODELED)")
    p99 = [float(d.split("=")[1].rstrip("us")) for _, _, d in r4]
    check(p99 == sorted(p99) and p99[-1] > p99[0],
          f"exp04: the 64 B p99 rises with the background, {p99} us (MODELED)")
    print("  " + exp03_skew.MODELED_NOTE)
    print("  " + exp04_background.MODELED_NOTE)
    for row in r3 + r4:
        print("  " + ",".join(row))
    print(f"  phase 19 (i) in {time.perf_counter() - t0:.1f} s of wall time on the host "
          "(the rows above are MODELED; no device)", flush=True)

    # (ii) the churn on a chain whose tiers hold real rows on the card
    t1 = time.perf_counter()
    layout = qwen32b_layout()
    cfg = TieringConfig(**tc.TIERING)
    pool = TieredPool(layout, tc.FAST_BLOCKS, tc.SPILL_BLOCKS, "cuda", n_shards=tc.N_SHARDS,
                      cfg=cfg)
    gib = pool.n_blocks * layout.block_bytes / 2**30
    check(pool.n_blocks == 3072 and all(t.data.is_cuda for t in pool.tiers),
          f"tiered pool on the card: {pool.n_blocks} blocks of {layout.block_bytes} B "
          f"({gib:.2f} GiB), tiers {[t.n_blocks for t in pool.tiers]} {list(pool.tier_media)}")
    index = PrefixIndex(pool)
    index.on_evict = pool.policy.ghost_add
    transfer = PoolTransfer(pool)
    mgr = KVCacheManager(pool, index, HbmPagedCache(512, 16), transfer)

    class TimedMigrator(MigrationEngine):
        """Times each migration's copy with CUDA events; counts the rows
        each tier receives."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.copies: list = []
            self.rows_into = [0] * self.pool.n_tiers

        def _copy_payloads(self, src_ids, dst_pool, dst_local):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            eps = super()._copy_payloads(src_ids, dst_pool, dst_local)
            e1.record()
            self.copies.append((e0, e1, len(src_ids) * self.pool.layout.block_bytes))
            self.rows_into[self.pool.tiers.index(dst_pool)] += len(src_ids)
            return eps

    mig = TimedMigrator(pool, index, cfg)
    unbalanced: list = []

    def books(step):
        bad = tc.books_balance(pool, index)
        if bad:
            unbalanced.append((step, bad))

    record = tc.churn(mgr, index, mig, pool, payload=lambda keys: tc.key_payload(keys, layout, "cuda"),
                      after_op=books)
    torch.cuda.synchronize()
    churn_s = time.perf_counter() - t1
    got = tc.summary(record, pool, mig, index)
    st = pool.tier_stats
    check(not unbalanced, f"churn: the books balance after each of {len(record)} operations and "
                          f"{mig.steps} migrator steps" + (f": {unbalanced[:2]}" if unbalanced else ""))
    deep = pool.tier_writes[2] + mig.rows_into[2]
    check(st.demotions > 0 and st.promotions > 0 and deep > 0,
          f"churn: {st.demotions} demotions, {st.promotions} promotions, {deep} blocks written "
          f"into the SSD tier ({mig.rows_into[2]} by demotion)")
    bad = mismatches(got, tc.PINS, "churn.")
    check(not bad, f"churn: the placed ids and TierStats equal the pins of the JAX package's "
                   f"payload-free run (digest {got['digest']})" + (f": {bad[:4]}" if bad else ""))
    n_read, n_bad = tc.verify_payloads(index, transfer)
    check(n_read == got["entries"] and n_bad == 0,
          f"churn: all {n_read} indexed blocks read back through scatter_read equal their keys' "
          f"bytes bit for bit ({n_bad} differ)")
    index.evict_lru(pool.n_blocks)
    check(pool.free_blocks() == pool.n_blocks and not tc.books_balance(pool, index),
          f"churn: a full eviction frees all {pool.n_blocks} blocks")
    ms = sum(a.elapsed_time(b) for a, b, _ in mig.copies)
    moved = sum(n for _, _, n in mig.copies)
    bound_ms = 2 * moved / HBM_BYTES_PER_S * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"  migration copies on the card ({smi}): {len(mig.copies)} copies, {moved} B, "
          f"{ms:.3f} ms of CUDA events ({moved / ms / 1e6:.1f} GB/s; each copy's interval "
          f"holds its gather, scatter and index uploads), copy bound {bound_ms:.3f} ms "
          f"(2 x bytes / 3.35 TB/s): HBM-to-HBM copies, not the spill media's latency, which "
          f"is MODELED", flush=True)
    print(f"  phase 19 (ii) in {time.perf_counter() - t1:.1f} s ({churn_s:.1f} s of churn); "
          f"phase 19 in {time.perf_counter() - t0:.1f} s", flush=True)
    del pool, index, transfer, mgr, mig


def _segment_gone(name: str) -> bool:
    from repro_torch.core.shm import attach_segment, close_segment

    try:
        seg = attach_segment(name)
    except FileNotFoundError:
        return True
    close_segment(seg, unlink=False)
    return False


def phase_ring(cfg, local: list[dict]) -> tuple[dict, dict]:
    """Phase 20: the CXL-RPC metadata plane in threads and in processes
    (module docstring). (i) exp05 over the rings, exp11's rows, exp01 /
    exp02 on the host; (ii) Llama-3.1-8B with its index behind one ring and
    behind 4, held against ``local``, phase 4's run with its index in
    process; (iii) the ring under a delay and a drop window; (iv) the index
    behind a watched shard service process, killed and respawned. Returns
    the launches of (ii) and (iii), and those of (iv)."""
    import torch

    from repro_torch.core.rpc import RingRetryPolicy
    from repro_torch.distributed.fault_tolerance import FaultEvent, FaultPlan
    from repro_torch.experiments import exp01_coherence, exp02_latency, exp11_rpc
    from repro_torch.experiments import exp05_e2e as exp05
    from repro_torch.experiments import ring_serve as rs
    from repro_torch.kernels import ops
    from repro_torch.serving.real_runner import RealEngine
    from repro_torch.serving.scheduler import refcounts_settled

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for shards in (1, 4):
        t = time.perf_counter()
        s1, s2, c = exp05.run_mode("beluga", index_rpc=True, index_shards=shards)
        alive = c.close()
        per = s1["index"].pop("shards", None)
        bad = exp05.pinned_mismatches("beluga", s1, s2)
        check(not bad and (per is None or sum(per) == s1["index"]["entries"]),
              f"exp05 beluga, index over {shards} ring(s): every summary number equals the "
              "pinned in-process reference" + (f" (entries a shard {per})" if per else "")
              + (f": {bad[:4]}" if bad else ""))
        rts = [cl.stats.requests for cl in c.ring_clients]
        check(refcounts_settled(c.pool, c.index) and all(rts)
              and not any(cl.stats.errors or cl.stats.timeouts for cl in c.ring_clients)
              and not alive and len(c.plane.servers) == shards
              and not any(srv.alive() for srv in c.plane.servers),
              f"exp05 over {shards} ring(s): {rts} round trips a ring, no error or timeout, "
              "every refcount what the index owns, every server thread stopped")
        print(f"  exp05 beluga over {shards} ring(s): {time.perf_counter() - t:.1f} s of wall "
              f"time on the host; hit TTFT {s2['avg_ttft_s']!r} s (MODELED)", flush=True)
    rows, res = exp11_rpc.run(fast=False)
    check(res["client_stats"]["errors"] == res["client_stats"]["timeouts"] == 0
          and all(cl["errors"] == cl["timeouts"] == 0 and all(cl["served_per_shard"])
                  for cl in res["shard_sweep"] + res["shard_sweep_process"]),
          "exp11: every round trip answered (no error, no timeout), every shard served, "
          "by threads and by service processes")
    ch = res["chaos"]
    check(ch["restarts"] == 1 and ch["recovery_s"] is not None,
          f"exp11 chaos: the killed shard respawned once and served a full match again "
          f"{ch['recovery_s']} s after the kill (host wall time)")
    print(f"  {exp11_rpc.HOST_NOTE}; the host of the {smi}")
    for row in rows:
        print("  " + ",".join(row))
    e1, e2 = exp01_coherence.run(), exp02_latency.run()
    check(e1[-1] == ("exp01.guideline_ordering_holds", "0", "ok=True"),
          "exp01: the paper's ordering of the coherence methods holds (MODELED)")
    print("  " + exp01_coherence.MODELED_NOTE)
    print("  " + exp02_latency.MODELED_NOTE)
    for row in e1 + e2:
        print("  " + ",".join(row))
    t_i = time.perf_counter() - t0

    # (ii) Llama-3.1-8B: phase 4's requests behind one ring, and without the
    # partial hits behind 4, each run on a fresh pool of an engine of phase
    # 4's seed, against phase 4's run with the index in process
    t1 = time.perf_counter()
    picks = [0, 1, 4, 5]  # the two cold requests and the two full hits
    eng = RealEngine.create(cfg, max_len=MAX_LEN, pool_blocks=POOL_BLOCKS, seed=0)
    _, prompts, want_hits = main_prompts(cfg)
    ops.reset_launch_counts()
    ring, plane = rs.serve(eng, prompts, MAX_NEW, n_shards=1)
    try:
        # (iii) the ring of the run above under the injector's windows, on
        # its pool: the two full hits, clean, then under each window
        t3 = time.perf_counter()
        hits = prompts[4:]
        clean = rs.faulted(eng, plane, hits * 3, 1, FaultPlan([]))
        slow = rs.faulted(eng, plane, hits, MAX_NEW, FaultPlan(
            [FaultEvent(0.0, "delay", 0, duration=600.0, delay_s=RING_DELAY_S)]))
        dropped = rs.faulted(eng, plane, hits, MAX_NEW, FaultPlan(
            [FaultEvent(0.0, "drop", 0, duration=RING_DROP_S)]))
        t_iii = time.perf_counter() - t3
    finally:
        alive = plane.close()
    check(not alive and not any(srv.alive() for srv in plane.servers),
          "the ring's server thread stopped")
    del plane
    sharded, plane4 = rs.serve(eng, [prompts[i] for i in picks], MAX_NEW, n_shards=4)
    alive = plane4.close()
    check(not alive and len(plane4.servers) == 4
          and not any(srv.alive() for srv in plane4.servers),
          "the 4 rings' server threads stopped")
    del plane4
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    t_ii = time.perf_counter() - t1 - t_iii
    six = list(range(len(prompts)))
    for name, run, idx in (("in process (phase 4)", local, six), ("1 ring", ring, six),
                           ("4 rings", sharded, picks)):
        want = [want_hits[i] for i in idx]
        check([r["hit_tokens"] for r in run] == want,
              f"Llama, index {name}: hit tokens {[r['hit_tokens'] for r in run]} == {want}")
    for name, run, idx in (("1 ring", ring, six), ("4 rings", sharded, picks)):
        ref = [local[i] for i in idx]
        same = all(a["tokens"] == b["tokens"] and a["block_ids"] == b["block_ids"]
                   and a["epochs"] == b["epochs"] for a, b in zip(ref, run))
        bits = all(torch.equal(a["logits"], b["logits"]) for a, b in zip(ref, run))
        check(same and bits, f"Llama, index behind {name}: the same tokens, pool block ids "
              f"and epochs as phase 4's run with its index in process (requests {idx}), "
              "logits bit for bit")
        for i, r in zip(idx, run):
            print(f"  {name} req {i}: hit {r['hit_tokens']}/{PROMPT}, ttft "
                  f"{r['ttft_s'] * 1e3:.2f} ms (in process {local[i]['ttft_s'] * 1e3:.2f}), "
                  f"{r['round_trips']} round trips, mean wait {r['mean_wait_s'] * 1e6:.1f} us, "
                  f"index calls {r['index_s'] * 1e3:.3f} ms ({r['index_s'] / r['ttft_s']:.2%} "
                  "of the TTFT)")
    check([r["round_trips"] for r in ring] == [2, 2, 1, 1, 1, 1],
          "over 1 ring: a cold request is two round trips (match, publish), a hit one (match)")
    check(all(launches[k] > 0 for k in LLAMA_KERNELS),
          f"every kernel of the path launched in phase 20: {launches}")

    # (iii) the windows: tokens unchanged, the delay paid, the drop retried
    for i, (sl, dr) in enumerate(zip(slow, dropped)):
        want = ring[4 + i]
        check(sl["tokens"] == dr["tokens"] == want["tokens"]
              and torch.equal(sl["logits"], want["logits"])
              and torch.equal(dr["logits"], want["logits"])
              and sl["hit_tokens"] == dr["hit_tokens"] == PROMPT,
              f"req {4 + i} under the delay and the drop window: the same tokens and logits")
        # the delay is paid before each post, so it lands in the index
        # calls' time outside their round trips (whose wake-up latency varies
        # by more than the delay between runs)
        floor = min(b["index_s"] - b["wait_s"] for b in clean[i::2])
        base = sorted(b["ttft_s"] for b in clean[i::2])[1]
        grew = sl["index_s"] - sl["wait_s"] - floor
        check(sl["retries"] == 0 and grew >= sl["round_trips"] * RING_DELAY_S,
              f"req {4 + i} under a {RING_DELAY_S * 1e3:g} ms delay: its index calls spent "
              f"{grew * 1e3:.3f} ms more outside their round trips than in their fastest clean "
              f"run, >= {sl['round_trips']} post(s) x {RING_DELAY_S * 1e3:g} ms (TTFT "
              f"{sl['ttft_s'] * 1e3:.2f} ms against a clean median {base * 1e3:.2f}; round "
              f"trips {sl['wait_s'] * 1e3:.3f} ms)")
        check(dr["retries"] >= 1 and RING_DROP_S < RingRetryPolicy().budget(),
              f"req {4 + i} under a {RING_DROP_S * 1e3:g} ms drop window (retry budget "
              f"{RingRetryPolicy().budget():.2f} s): {dr['retries']} retries, TTFT "
              f"{dr['ttft_s'] * 1e3:.2f} ms")
    share = [r["index_s"] / r["ttft_s"] for r in ring[4:]]
    print("  ring: " + json.dumps({
        "card": smi, "round_trips": [r["round_trips"] for r in ring],
        "round_trips_4": [r["round_trips"] for r in sharded],
        "mean_wait_us": [r["mean_wait_s"] * 1e6 for r in ring],
        "hit_ttft_ms": {"in_process": [r["ttft_s"] * 1e3 for r in local[4:]],
                        "ring": [r["ttft_s"] * 1e3 for r in ring[4:]],
                        "rings_4": [r["ttft_s"] * 1e3 for r in sharded[2:]]},
        "ring_share_of_hit_ttft": share, "launches": launches}))

    # (iv) the index behind one shard service process under a watchdog
    # (spawned, no probe thread): requests 0, 1, 4 and 5 on a fresh pool,
    # then the service killed, respawned from its journal, the hits again
    t4 = time.perf_counter()
    ops.reset_launch_counts()
    proc, pplane = rs.serve(eng, [prompts[i] for i in picks], MAX_NEW, n_shards=1,
                            transport="process", watched=True)
    try:
        healed = rs.respawn(pplane)
        again = rs.rerun(eng, pplane, prompts[4:], MAX_NEW)
        restarts, adopted = pplane.restarts(), pplane.clients[0].stats.restarts
        names, paths = pplane.segment_names(), pplane.doorbell_paths()
    finally:
        alive = pplane.close()
    torch.cuda.synchronize()
    launches_iv = ops.launch_counts()
    t_iv = time.perf_counter() - t4
    check(not alive and not any(s.running() for s in pplane.services)
          and all(_segment_gone(n) for n in names) and not any(os.path.exists(p) for p in paths),
          f"the shard service's children ended, its {len(names)} segments and {len(paths)} "
          "FIFOs unlinked")
    same = all(r["tokens"] == local[i]["tokens"] and r["block_ids"] == local[i]["block_ids"]
               and r["epochs"] == local[i]["epochs"]
               and torch.equal(r["logits"], local[i]["logits"]) for i, r in zip(picks, proc))
    check(same and [r["hit_tokens"] for r in proc] == [want_hits[i] for i in picks],
          "Llama, index behind a shard service process: requests 0, 1, 4, 5 give phase 4's "
          "tokens, pool block ids, epochs and hits, logits bit for bit")
    check([r["round_trips"] for r in proc] == [2, 2, 1, 1],
          f"over the process ring: round trips {[r['round_trips'] for r in proc]} == [2, 2, 1, 1]")
    check(restarts == adopted == 1 and healed["ready"]
          and all(r["hit_tokens"] == PROMPT and r["tokens"] == local[4 + k]["tokens"]
                  and torch.equal(r["logits"], local[4 + k]["logits"])
                  for k, r in enumerate(again)),
          f"after kill -9 and one respawn from {healed['replayed']} journal records: "
          f"{[r['hit_tokens'] for r in again]} of {PROMPT} tokens hit, the tokens and logits "
          f"of phase 4 bit for bit; {restarts} restart, the client on the new ring")
    check(all(launches_iv[k] > 0 for k in LLAMA_KERNELS),
          f"every kernel of the path launched in phase 20 (iv): {launches_iv}")
    hits_iv = proc[2:]
    print("  process ring: " + json.dumps({
        "card": smi, "respawn_s": healed["respawn_s"], "journal_records": healed["replayed"],
        "round_trips": [r["round_trips"] for r in proc],
        "mean_wait_us": [r["mean_wait_s"] * 1e6 for r in proc],
        "hit_ttft_ms": {"in_process": [r["ttft_s"] * 1e3 for r in local[4:]],
                        "thread_ring": [r["ttft_s"] * 1e3 for r in ring[4:]],
                        "process_ring": [r["ttft_s"] * 1e3 for r in hits_iv],
                        "process_ring_after_respawn": [r["ttft_s"] * 1e3 for r in again]},
        "process_ring_share_of_hit_ttft": [r["index_s"] / r["ttft_s"] for r in hits_iv],
        "thread_ring_share_of_hit_ttft": [r["index_s"] / r["ttft_s"] for r in ring[4:]],
        "launches": launches_iv}))
    del eng, local, ring, sharded, proc, again
    print(f"  phase 20 in {time.perf_counter() - t0:.1f} s ((i) {t_i:.1f} s on the host, "
          f"(ii) {t_ii:.1f} s, (iii) {t_iii:.1f} s, (iv) {t_iv:.1f} s)", flush=True)
    return launches, launches_iv


def phase_procengine() -> None:
    """Phase 21: exp14 on the card's host, the parity and the sweep at full
    size, the chaos drill at --fast; no kernel is launched."""
    import multiprocessing

    from repro_torch.experiments import exp14_procengine as exp14

    t0 = time.perf_counter()
    seg_bytes = 4096 * exp14._layout().block_bytes
    print(f"  /dev/shm: {shutil.disk_usage('/dev/shm').free} bytes free; a full-size pool "
          f"segment is {seg_bytes} bytes", flush=True)
    shm_before = set(os.listdir("/dev/shm"))
    tmp = tempfile.gettempdir()
    fifos_before = {f for f in os.listdir(tmp) if f.startswith("beluga-doorbell-")}
    cell, worker1 = exp14.parity(fast=False)
    check(cell["bit_identical"], "exp14 parity: the private in-process, the shared in-process "
          "and the one-worker runs give the same run() dict (160 requests of 4096 tokens, "
          f"4096 pool blocks, a {seg_bytes} B segment)")
    nums = {k: cell[k] for k in exp14.PARITY_KEYS}
    check(cell["pinned_mismatches"] == [], f"exp14 parity numbers {nums} equal "
          "exp14_procengine.PINNED['full'] (the JAX package's run; integers exactly, times "
          "within 1e-12 relative)" + (f": {cell['pinned_mismatches']}" if
                                      cell["pinned_mismatches"] else ""))
    sweep = exp14.sweep(False, worker1)
    check(exp14.one_engine_settled(cell, sweep),
          "exp14 one engine (the private and shared in-process runs, one worker): every pool "
          "refcount accounted for, none left by a key published twice")
    most = sweep[0]["bytes_moved_total"]
    hygiene = cell["hygiene"] + [c["hygiene"] for c in sweep]
    for c in sweep:
        h = c["hygiene"]
        check(c["n_done"] == 160 and h["settled"] and h["left"] == []
              and c["bytes_moved_total"] <= most,
              f"exp14 N={c['n_workers']}: 160 of 160 requests done, every pool refcount "
              f"accounted for ({h['overwritten']} blocks of a key another worker published "
              f"again), {c['bytes_moved_total']} bytes moved <= N=1's {most}, nothing left "
              "running")
    ch = exp14.chaos_sweep(fast=True)
    check(ch["restarts"] == 1 and ch["allocator_restarts"] == 1 and ch["n_done"] == 48
          and ch["settled"],
          f"exp14 chaos (--fast, 2 workers): the killed worker restarted once "
          f"({ch['leases_released']} leases released), the allocator moved once, 48 of 48 "
          f"requests done, every pool refcount accounted for ({ch['overwritten']} blocks "
          "of a key another worker published again, each named by the journals)")
    names = [n for h in hygiene for n in h["names"]]
    paths = [p for h in hygiene for p in h["paths"]]
    left_shm = set(os.listdir("/dev/shm")) - shm_before
    left_fifos = {f for f in os.listdir(tmp) if f.startswith("beluga-doorbell-")} - fifos_before
    check(all(_segment_gone(n) for n in names) and not any(os.path.exists(p) for p in paths)
          and not left_shm and not left_fifos and not multiprocessing.active_children(),
          f"exp14: the {len(names)} segments and {len(paths)} FIFOs its runs named are gone, "
          "nothing new is left under /dev/shm or the FIFOs' directory, and no child process "
          "lives")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"  {exp14.HOST_NOTE}; the card's machine: {smi}")
    for c in sweep:
        print(f"  procengine.N{c['n_workers']}: wall_s={c['wall_s']!r} "
              f"qps_wall={c['qps_wall']!r} per_engine_mb_s={c['per_engine_mb_s']!r} "
              f"bytes_moved_total={c['bytes_moved_total']} hit_tokens={c['hit_tokens']} "
              "(host wall time)")
    print(f"  procengine.chaos: recovery_s={ch['recovery_s']!r} steady_qps_wall="
          f"{ch['steady_qps_wall']!r} outage_qps_wall={ch['outage_qps_wall']!r} "
          f"post_qps_wall={ch['post_qps_wall']!r} worker_boot_s={ch['worker_boot_s']!r} "
          "(host wall time)")
    report = {"card": smi, "host_cores": os.cpu_count(), "parity": nums,
              "sweep": [{k: v for k, v in c.items() if k != "hygiene"} for c in sweep],
              "chaos": ch}
    print(f"  procengine: {json.dumps(report)}")
    print(f"  phase 21 in {time.perf_counter() - t0:.1f} s of wall time on the host (the parity "
          "numbers are MODELED; no device)", flush=True)


def phase_roofline(seed: int = 0) -> dict:
    """The launch tooling held against the card (module docstring, phase
    17), the card's arguments drawn from ``seed``; returns the kernel
    launches of the cells' counted calls."""
    import statistics

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import attn_model_flops, model_flops
    from repro_torch.launch.op_analysis import OpAnalyzer
    from repro_torch.launch.roofline import useful_bytes
    from repro_torch.launch.steps import build_cell

    def counted(cell, device):
        """The analyzer's count of the second call (the first builds the
        kernels and a decode's block table), the launches and the peak."""
        args = cell.make_args(device, seed)
        cell.fn(*args)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        with FlopCounterMode(display=False) as fc, OpAnalyzer(track=args) as an:
            cell.fn(*args)
        peak = None
        if device == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        launched = {k: v - before[k] for k, v in ops.launch_counts().items() if v > before[k]}
        return args, an, fc, launched, peak

    total: dict[str, int] = {}
    out = {}
    for label, (arch, fields) in ROOFLINE_CELLS.items():
        t0 = time.perf_counter()
        cfg, shape = get_config(arch), ShapeConfig(*fields)
        _, meta, _, meta_launched, _ = counted(build_cell(cfg, shape), "meta")
        check(not meta_launched, f"{label}: the dry run on meta launched no kernel")
        cell = build_cell(cfg, shape)
        args, card, fc, launched, peak = counted(cell, "cuda")
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        got, want = card.result(), meta.result()
        check(card.ops == meta.ops and all(got[k] == want[k] for k in (
            "flops", "bytes_accessed", "transcendentals", "kernels")),
            f"{label}: the dry run on meta counts the card's call exactly: "
            f"{sum(card.ops.values())} aten ops ({len(card.ops)} distinct (op, shapes, dtypes)), "
            f"{got['flops']:.6e} FLOPs, {got['bytes_accessed']:.6e} bytes, "
            f"{got['transcendentals']:.6e} transcendentals")
        kernel_launches = {k: v["launches"] for k, v in got["kernels"].items()}
        check(kernel_launches == launched and kernel_launches,
              f"{label}: kernel entries {kernel_launches} equal ops.launch_counts()'s delta "
              f"{launched}")
        gemm = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
        check(gemm == {k: v for k, v in card.op_flops.items() if v},
              f"{label}: every aten op FlopCounterMode knows counted alike: {gemm}")
        times = []
        for _ in range(ROOFLINE_RUNS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cell.fn(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        ms = statistics.median(times)
        t_ops, t_bytes = got["flops"] / BF16_FLOP_PER_S, got["bytes_accessed"] / HBM_BYTES_PER_S
        counted_ms = max(t_ops, t_bytes) * 1e3
        useful_flops = model_flops(cfg, shape) + attn_model_flops(cfg, shape)
        u_ops, u_bytes = useful_flops / BF16_FLOP_PER_S, useful_bytes(cfg, shape) / HBM_BYTES_PER_S
        useful_ms = max(u_ops, u_bytes) * 1e3
        r = out[label] = {
            "ms": ms, "ms_all": times, "flops": got["flops"], "bytes": got["bytes_accessed"],
            "counted_bound_ms": counted_ms,
            "counted_by": "operations" if t_ops > t_bytes else "bytes",
            "counted_share": counted_ms / ms, "useful_flops": useful_flops,
            "useful_bound_ms": useful_ms, "useful_by": "operations" if u_ops > u_bytes else "bytes",
            "useful_share": useful_ms / ms, "peak_predicted": meta.peak_live_bytes,
            "peak_measured": peak, "peak_ratio": peak / meta.peak_live_bytes,
            "kernels": kernel_launches, "top_flops": got["top_flops"][:3],
            "top_bytes": got["top_bytes"][:3],
        }
        print(f"  {label} ({arch}, {fields[2]} x {fields[1]}, {fields[3]}): {ms:.2f} ms (median "
              f"of {ROOFLINE_RUNS}: {[round(x, 2) for x in times]}); counted "
              f"{r['flops']:.4e} FLOPs, {r['bytes']:.4e} bytes: bound {counted_ms:.2f} ms by "
              f"{r['counted_by']}, share {r['counted_share']:.4f}; useful {useful_flops:.4e} "
              f"FLOPs (model + attention), bound {useful_ms:.2f} ms by {r['useful_by']}, share "
              f"{r['useful_share']:.4f}; peak {peak / 2**30:.3f} GiB measured, "
              f"{meta.peak_live_bytes / 2**30:.3f} predicted (ratio {r['peak_ratio']:.4f}); "
              f"top FLOPs {r['top_flops']}; top bytes {r['top_bytes']}")
        check(r["counted_share"] <= ROOFLINE_SHARE_MAX,
              f"{label}: as-counted share {r['counted_share']:.4f} <= {ROOFLINE_SHARE_MAX}")
        lo, hi = ROOFLINE_PEAK_RATIO
        check(lo <= r["peak_ratio"] <= hi,
              f"{label}: measured peak over predicted {r['peak_ratio']:.4f} in [{lo}, {hi}]")
        r["phase_s"] = time.perf_counter() - t0
        del cell, args, card, meta, fc
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  phase 17 cells: {json.dumps(out)}")
    return total


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build

    # float32 matmuls in full float32 (the default, stated): the float32
    # checks compare against the CPU and against float32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print("[1] build", flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {name}: {line.strip()}")
    flash_build_proof(build)
    paged_build_proof(build)
    ssd_build_proof(build)
    bwd_build_proof(build)
    ssd_bwd_build_proof(build)

    cfg, mamba_cfg = get_config("llama3.1-8b"), get_config("mamba2-2.7b")
    print("[2] kernels vs plain versions", flush=True)
    rows = phase_kernels(cfg, mamba_cfg)
    print("[3] reduced models, card vs CPU", flush=True)
    phase_small()
    print("[4] main path: Llama-3.1-8B full width", flush=True)
    launches, llama_pool, llama_in_process = phase_main(cfg)
    print("[5] Mamba-2 path: mamba2-2.7b full width", flush=True)
    mamba_launches = phase_mamba(mamba_cfg)
    print("[6] sparse reads: exp10 and exp09 twins, full width", flush=True)
    sparse_launches = phase_sparse(llama_pool)
    # phase 4's engine (16 GB of weights and its pool) goes before the ~55 GB
    # of phase 7 and the ~52 GB of phase 8, each freed before the next
    del llama_pool
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 4's engine freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    arctic_cfg = dataclasses.replace(get_config("arctic-480b"), n_layers=ARCTIC_LAYERS)
    print(f"[7] Arctic-480B path: full width, {ARCTIC_LAYERS} layers, through the pool",
          flush=True)
    arctic_launches = phase_arctic(arctic_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    jamba = get_config("jamba-1.5-large-398b")
    jamba_cfg = dataclasses.replace(jamba, n_layers=8, moe=dataclasses.replace(
        jamba.moe, n_experts=JAMBA_EXPERTS))
    print(f"[8] Jamba-1.5-Large path: full width, one period, {JAMBA_EXPERTS} experts",
          flush=True)
    jamba_launches = phase_jamba(jamba_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 8's model freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    qwen3_cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=QWEN3_LAYERS)
    print(f"[9] qwen3-32b path: full width, {QWEN3_LAYERS} of 64 layers, through the pool",
          flush=True)
    qwen3_launches = phase_qwen3(qwen3_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[10] qwen3-32b with an fp8 KV cache: full width, {QWEN3_LAYERS} of 64 layers, "
          "through Model", flush=True)
    qwen3_fp8_launches = phase_qwen3_fp8(qwen3_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 10's model freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    print("[11] internvl2-26b path: full width, all 48 layers, through Model", flush=True)
    internvl_launches = phase_frontend("internvl2-26b", get_config("internvl2-26b"))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 11's model freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    print("[12] musicgen-large path: full width, all 48 layers, through Model", flush=True)
    musicgen_launches = phase_frontend("musicgen-large", get_config("musicgen-large"))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 12's model freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    print("[13] training: olmo-1b full width, all 16 layers, AdamW steps", flush=True)
    train_launches, train_losses = phase_train(get_config("olmo-1b"))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 13's model freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    print("[14] training: mamba2-2.7b full width, all 64 layers, AdamW steps", flush=True)
    ssm_train_launches = phase_train_ssm(mamba_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 14's model freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    print("[15] the model under a device mesh: 4 gloo ranks on the card, full width",
          flush=True)
    mesh_launches = phase_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    print("[16] training under a device mesh: 4 gloo ranks on the card, full width",
          flush=True)
    mesh_train_launches = phase_mesh_train(train_losses)
    gc.collect()
    torch.cuda.empty_cache()
    print("[17] the roofline held against the card: olmo-1b train, Llama-3.1-8B prefill and "
          "decode, mamba2-2.7b prefill, full width, one device", flush=True)
    t17 = time.perf_counter()
    roofline_launches = phase_roofline()
    print(f"  phase 17 in {time.perf_counter() - t17:.1f} s")
    print("[18] the cluster simulator, on the card's host: exp05 (Table 5) at 256 clients, "
          "16 engines, 262,144 pool blocks", flush=True)
    phase_cluster()
    print("[19] the tiered pool: exp13 / exp03 / exp04 on the card's host, then tier "
          "migrations of real Qwen3-32B KV blocks on the card (fast 512, spill 512, SSD 2048)",
          flush=True)
    phase_tiering()
    gc.collect()
    torch.cuda.empty_cache()
    print("[20] the CXL-RPC metadata plane in threads and processes: exp05 over 1 and 4 "
          "rings, exp11, exp01, exp02 on the card's host; Llama-3.1-8B full width with its "
          "index behind 1 ring and behind 4 against phase 4's run; the ring under delay and "
          "drop windows; the index behind a shard service process, killed and respawned",
          flush=True)
    ring_launches, ring_process_launches = phase_ring(cfg, llama_in_process)
    del llama_in_process
    gc.collect()
    torch.cuda.empty_cache()
    print("[21] the shared data plane and engine worker processes: exp14 on the card's host, "
          "parity and N = 1, 2, 4 workers at full size, the chaos drill at --fast", flush=True)
    phase_procengine()
    paths = {"llama": launches, "mamba2": mamba_launches, "sparse": sparse_launches,
             "arctic": arctic_launches, "jamba": jamba_launches, "qwen3": qwen3_launches,
             "qwen3_fp8": qwen3_fp8_launches, "internvl2": internvl_launches,
             "musicgen": musicgen_launches, "train": train_launches,
             "mamba2_train": ssm_train_launches, "mesh": mesh_launches,
             "mesh_train": mesh_train_launches, "roofline": roofline_launches,
             "ring": ring_launches, "ring_process": ring_process_launches}
    own = {"ssd_chunk": "mamba2", "sparse_kv_gather": "sparse",
           "paged_attention_e4m3": "qwen3_fp8", "flash_attention_bwd": "train",
           "ssd_chunk_bwd": "mamba2_train"}
    for r in rows:
        r["launches"] = paths[own.get(r["name"], "llama")][r["name"]]
        r["launches_by_path"] = {p: n.get(r["name"], 0) for p, n in paths.items()}
    print(f"done in {time.perf_counter() - t_all:.1f} s", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
