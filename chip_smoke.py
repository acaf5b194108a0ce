#!/usr/bin/env python3
"""chip_smoke.py — run the PyTorch/CUDA port on one card and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints a line; any failure raises and exits non-zero with no
result line), in the order they run:
  1. card: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build: one nvcc per source, all started together, builds the eight
     CUDA sources (cnn_eq, volterra, quant, conv1d, flash_attn,
     flash_attn_bwd, slstm, slstm_bwd) for sm_90a; prints the -Xptxas -v
     register / shared-memory / spill lines of every kernel instance (the
     sLSTM source's: the cluster kernel's twelve, the stream kernel's
     four; the sLSTM backward's: the cluster kernel's twelve, all
     present and their registers and spills printed, and the stream
     kernel's two), and
     the registers and spills of the three register-blocked cnn_eq
     instances (`cnn_eq_kernel_rb`, fp32, bf16 and int8 at the plan's P),
     the three register-blocked conv1d instances (`conv1d_kernel_rb`, the
     deployed CNN's layer shapes) and the three register-blocked Volterra
     instances (`volterra_kernel_rb`, the deployed baseline in float32,
     bfloat16 and float16); none may spill;
  3. kernel == plain: each datapath (fp32, bf16, int8) on the card at the
     paper's deployment shape (equalizer_ht: 64 rows × 7320 symbols),
     shared and per-row stacked weights, tile_m ∈ {16, 64, 256}, and at
     the edge widths of EDGE_SHAPES (one row; a width shorter than the
     receptive field; n_pos = 1; n_pos a multiple of neither the
     kernel's run nor its P; a strided view; tile_m 8192); each kernel
     must equal its plain PyTorch version (`ref.py`) bitwise. With the
     counts zeroed before, every launch of every datapath must have run
     the register-blocked kernel (`INSTANCE_LAUNCHES`); `cnn_eq._plan`
     must name the kernel of the library's `cnn_eq_plan` for each
     datapath, "rb" in all three; and the register-blocked kernel must
     equal the generic one forced on the same inputs bitwise, in every
     datapath;
  4. the slice: `ServeRuntime(device="cuda")` serves 4 int8 "ht" tenants,
     4 bf16 "lp" tenants and 1 fp32 tenant (7320 symbols each, jittered
     chunks of ~1024 symbols, one chunk shorter than the receptive field);
     every stream must equal its offline engine bitwise, every kernel's
     launch count, zeroed just before, must equal its datapath's stacked
     serving launches (no autotune probe: no engine at these widths tiles
     by tile_m), and every launch must be the register-blocked kernel;
     4a. each kernel == plain bitwise at its most common serving launch
     shape, with the same instance check; 4b. the same serving run again
     under torch.profiler: device busy and idle share;
  11. stream partitioning at full width: one stream of N_i = 64 instances
     of ℓ_inst = 7320 symbols (936 960 samples) through
     `core.stream_partition.partitioned_apply` on an engine of each
     datapath (int8 "ht", bf16 "lp", fp32), split over 8 and over 64
     instances (o_act 128 and 1024 symbols); with the counts zeroed
     before each split, every call is one register-blocked launch, and
     the merged interior [o_sym : −o_sym] (every chunk border included)
     equals the unsplit engine on the same stream bitwise; on the split's
     own chunks (a view whose rows overlap: row stride < width, passed to
     the kernel with no copy) each engine's kernel equals its plain
     version (`ref.py`, the engine's weights and strides) bitwise, and
     the merge of that output is the partitioned output; ℓ_inst lies on
     `seqlen_opt.granularity` and is at least what
     `seqlen_opt.optimal_l_inst` asks for the paper's 80 GSa/s share of
     T_max; prints per datapath the partitioned call's ms and symbols/s
     (CUDA events), the unsplit call's ms and the kernel's device ms;
  12. threaded serving: phase 4's tenants in jittered ~1024-symbol chunks
     from `serve.loadgen.chop`, replayed by `serve.loadgen.replay` through
     `ServeRuntime` and `AsyncServeRuntime(device="cuda")`, each with an
     `obs.LinkMonitor` (through ``link=``) and an `obs.SloEngine`
     attached, the counts zeroed before each replay; then the async
     runtime again under a `FaultPlan` (a launch error, retried in place,
     and a NaN-corrupted output, replayed by failover). Every async
     stream equals the sync stream and its offline engine bitwise, every
     launch is the register-blocked kernel, every async execute ran on
     the runtime's own CUDA stream, no session is poisoned, each tenant's
     `LinkEstimate` is finite and equal between the runtimes, and
     `obs.report.render` shows the serve, link and slo sections; prints
     each run's symbols/s, chunk latency p50/p99 and p50 wait (submit to
     launch); 12a. each kernel == plain bitwise at the async run's most
     common launch shape, as 4a; 12b. the async replay again under
     torch.profiler (the replay only: the tenants are opened before the
     profiled window): device busy and idle share;
  13. the packetized wire: [12]'s nine tenants, and the first int8 tenant
     again on an fp32 wire, in [12]'s chunks as DATA frames from a
     `net.NetClient` over an impaired `net.loopback_pair` (reorder window
     6, duplicates 0.2, each way) to a `net.NetGateway` serving
     `ServeRuntime`, then `AsyncServeRuntime`, by
     `serve.loadgen.replay_wire(burst=4)`, the counts zeroed before each
     replay; int8 tenants on an int8 wire on their engine's layer-0 grid,
     the first bf16 tenant on a BF16 wire (its offline engine sees the
     bf16-rounded waveform), the rest fp32. Every tenant's egress symbols
     equal its offline engine bitwise, the int8-wire tenant equals its
     fp32-wire twin (contract #12), no wire error, duplicates and
     reordering above 0, every datapath launched, every launch rb, the
     report has its [net] section; prints symbols/s, ingress-to-emit p50
     and p99, chunk latency and the frame counts, beside the same chunks
     replayed by `loadgen.replay` on a `ServeRuntime` with no wire and no
     link telemetry (`sync_no_wire`); 13a. each kernel ==
     plain bitwise at the async wire run's most common launch shape; 13b.
     the control plane: an int8 tenant OPENed over the wire, DATA,
     SWAP_WEIGHTS, DATA, ROLLBACK, DATA, EOS and CLOSE, the spliced stream
     equal to each weight epoch's offline engine on its segment bitwise;
     then a frame dropped on one of three tenants surfaces a stream_gap
     and a NACK for that tenant only, the other two bitwise; 13c. drift
     traffic: `loadgen.drift_streams` on the card for `DriftingProakis`
     and `DriftingIMDD` (4 tenants, 16 bursts of 7320 symbols,
     DriftSchedule(8, 8)); at t = 0 each burst equals the stationary
     simulator on the same generator within atol 1e-4, a second draw
     repeats bitwise and is timed (ms per burst); the IM/DD tenant 0's
     whole drift stream served over the int8 wire equals offline bitwise;
  14. online adaptation at the reference's acceptance sizes
     (tests/test_adapt.py `test_drift_recovery_acceptance`,
     benchmarks/bench_adapt.py): a CNN (`CNNEqConfig()`) trained 600
     steps on the card on `DriftingProakis()` at t = 0; a "frozen" and an
     "adaptive" fused_fp32 tenant from it on `ServeRuntime`, the adaptive
     one attached to an `adapt.OnlineAdapter` (AdaptPolicy(3072, 3072,
     eval_capacity 8192), PromotionPolicy(min_eval_syms 1024,
     eval_bucket_syms 512), FineTuneConfig(200, 8, 256, 3e-3)); 26 bursts
     × 2048 symbols under DriftSchedule(4, 6) (`loadgen.drift_streams`,
     seed 3) through `loadgen.replay_adaptive(step_every=2)`, the counts
     zeroed before. At least one promotion; the recovery criterion at
     t = 1 against a freshly trained (600-step) equalizer on 2^14 fresh
     symbols: frozen ≥ 4 × max(pre-drift, 1e-3), adaptive ≤ 2 × max(fresh,
     2.5e-3), adaptive ≤ frozen / 4; the adaptive stream over each epoch's
     positions in `swap_log` equals that epoch's spec's offline engine
     bitwise; every launch rb. Prints the per-burst BER trajectories, the
     actions, the fine-tune's ms per step, each cycle's wall seconds.
     14a. `OnlineAdapter.start()` (its own CUDA stream) against
     `AsyncServeRuntime` under live traffic (one tenant, 8 bursts × 1024
     symbols, DriftSchedule(2, 3); the producer waits up to 2 s for the
     thread's next cycle after each burst, so the fine-tunes and any swap
     run while the stream is live): the stream complete, `swap_log`
     monotone, no adapter or runtime error, bitwise per epoch, every
     launch rb; then [14]'s streams replayed (`loadgen.replay`) through
     `AsyncServeRuntime` with and without a continuously busy fine-tune
     thread (bench_adapt's overhead ratio): symbols/s of each, best of 3
     interleaved after a warm-up. 14b. [14a]'s sync twin run twice: the
     same history and final weights, bitwise;
  15. the fleet: [4]'s tenants in [12]'s chunks by `loadgen.replay`
     through `FleetRuntime(n_workers=2)`, both workers on the card (each
     with its own CUDA stream), a `FaultPlan` losing worker 1
     (`device_lost`) after its third execute, the counts zeroed before:
     every stream == its offline engine bitwise (every chunk once), 0
     sessions poisoned, ≥ 1 migration in the `fleet.*` snapshot, every
     datapath launched, every launch rb; prints symbols/s, chunk latency
     p50/p99 (all workers and each) and launches per worker. 15a. each
     kernel == plain bitwise at the fleet's most common launch shapes.
     15b. `device_slow` (0.05 s) on worker 0: it fires, the worker lives,
     the stream bitwise. 15c. [13]'s impaired loopback over a 2-worker
     fleet with two tenants (fp32 and int8 wires): egress == offline
     bitwise. Each of [14]–[15c] prints its wall seconds;
  16. the parallel layer: [11]'s engines and 468 480-symbol stream over 4
     ranks spawned by `launch.mesh.run_ranks` (gloo: NCCL refuses two
     ranks on one GPU; each rank on cuda:0, its CUDA edges staged through
     the host), each rank's shard (`parallel.halo.local_shard`) through
     `halo.halo_apply` on a ("data",) `DeviceMesh`, the counts zeroed
     before the checked call: per datapath the gathered symbols equal the
     unsplit engine bitwise and `partitioned_apply(n_inst=4)` on the
     interior, one rb launch a rank; prints per rank the call and
     exchange ms (host clock, after a barrier), the bytes each way (int8
     edges a quarter of fp32's), the backend, whether edges were staged,
     and the exchange of host tensors for comparison. 16a. each kernel ==
     plain at the per-rank launch shape (an interior shard with its
     halos). 16b. `optim.grad_comp.compressed_psum` over the same 4 ranks
     on seeded f32 gradients shaped like smollm-135m's full-width tree (tp
     1, 162 826 560 a rank): the mean within one quantization step of the
     exact mean and 0 < |residual| < scale, leaf by leaf; ms a call and
     the bytes gathered (int8 against f32). 16c. a seeded smollm-135m tree
     saved by `CheckpointManager` and restored by `runtime.ElasticRestore`
     onto `best_mesh()` of a one-rank world on cuda:0: every leaf a
     DTensor on the card, bitwise; then the (2, 2) → (1, 2) reshard on a
     "cuda" mesh over 4 gloo ranks, saved from DTensor leaves (gathered
     through the host: gloo cannot all-gather CUDA tensors) and from plain
     tensors: both must run, each rank's restored shard must be its slice,
     and the two saves must write the same files byte for byte;
  6. train: `train_equalizer` on the card for the CNN (equalizer_ht widths,
     3-phase QAT), the FIR and the Volterra baselines on the default IM/DD
     link (40 GBd, 31.5 km, N_os = 2), 300 steps each; every loss finite,
     the mean loss of the last 50 steps below that of the first 50, the
     CNN's widths frozen to integers; prints BER and ms per step;
  7. deploy: one fresh IM/DD batch at 64 × 7320 symbols through the
     trained parameters' deployment entry points, with every launch count
     zeroed just before and read just after: `volterra.ops.equalize`,
     `quant.ops.quantize_params`, `conv1d.ops.conv1d_same_lower` through
     the CNN's three layers. Each kernel == its plain version bitwise.
     Volterra: the deploy run took the register-blocked kernel (1 "rb", 0
     "generic" launches in `volterra.INSTANCE_LAUNCHES`, no padding copy)
     and equals the generic kernel forced; rb == plain at the edges
     (V_EDGES: fewer symbols than a run, n_out not a multiple of P, an
     odd width, one row, a strided view) and in bfloat16 and float16; two
     random parameter sets up to the DSE's largest memory lengths run the
     generic kernel, as the plan says. quant: quantize_params made exactly
     one launch (`quant_many_kernel`) and each tensor == its plain version
     == the QAT quantizer; the per-tensor kernel == plain at 64 × 14 640
     in float32 and bfloat16, at lengths 1, 3, 5, 17 and on a view off
     the 16-byte boundary. conv1d: each layer ran the register-blocked
     kernel (3 "rb" launches in `conv1d.INSTANCE_LAUNCHES`, no padding
     copy) and equals the generic kernel forced on the same input bitwise,
     in float32 and, on the same layers' inputs in bfloat16, bfloat16;
     conv1d against F.conv1d (TF32 off) as a max abs error;
  5. times: CUDA events over many calls after warm-up at the deployment
     shapes, and device time from torch.profiler, for all six kernels:
     kernel, plain version, and a PyTorch yardstick (a chain of F.conv1d +
     ReLU for cnn_eq, the einsum chain of `core.volterra.apply`,
     torch.fake_quantize_per_tensor_affine, F.conv1d), beside the least
     time the card could take; for each cnn_eq datapath also the plan's
     kernel, run W and P, the generic kernel forced on the same inputs,
     the device time at the [4a] serving shape and, for fp32 and bf16, the
     FP32-issue floor of their fixed order (two FP32 instructions a MAC);
     for each conv1d layer the plan's kernel and run, its device time and
     the generic kernel's forced on the same input; for Volterra the
     plan's kernel and its device time beside the generic kernel's forced
     in the same call (and rb in bfloat16); for quant the deploy shape
     (quantize_params: one launch, against six per-tensor launches and
     six torch.fake_quantize_per_tensor_affine calls) and the large shape
     (64 × 14 640, float32 and bfloat16); beside them, the device times
     before the redesigns as PERF.md records them (OLD_DEVICE_MS, not
     measured here);
  8. LM serving: `repro_torch.launch.serve.serve_session` builds
     qwen3-0.6b at full width (28 layers, d_model 1024, 16/8 heads of 128,
     bf16, fused_attention, tp = 1) with seeded random weights on the
     card and serves 4 × 2048-token prompts, then 32 greedy decode steps;
     the flash-attention launch count, zeroed before each, must be 28 for
     the prefill (one per layer, and no training kernel) and 0 for the
     decode; prints prefill ms,
     decode ms per step and tokens/s (host clock around synchronised
     work). 8b: the kernel against its plain version on layer 0's q, k, v
     of that prefill (bf16; rtol 1e-2, atol 2e-2) and on random inputs at
     non-aligned shapes (f32 atol 2e-5, bf16 atol 2e-2): GQA 16/8, MQA
     8/1, a window, q_offset > 0 with Sq < Sk, bidirectional, and the
     bf16 tensor-core tiles' edges (S = 63, 64, 65, 129, 2049; D = 80,
     112; a window ending inside a tile). 8c: the
     whole model in f32 (TF32 off), 1 × 2048 tokens: fused against the
     chunked plain prefill, and decode at position 2047 against a prefill
     over 2048 tokens, each within 2e-3. 8d: at the serving shape the
     kernel's device and call time, the plain version's, the bound from
     `attention_costs` and F.scaled_dot_product_attention as the library
     yardstick, the achieved TFLOP/s, the share of the bound, the factor
     against SDPA and the f32 instance's device time at the same shape,
     then one prefill and 4 decode steps under torch.profiler (device idle
     share, top kernels); 8m: MoE serving: `serve_session` builds
     moonshot-v1-16b-a3b at full width (d_model 2048, 16 heads of 128, 64
     experts top-6, expert d_ff 1408, vocab 163 840, bf16,
     fused_attention, tp = 1) with its depth cut to 4 of 48 layers and
     serves 4 × 2048-token prompts, then 32 greedy decode steps: 4 flash
     launches in the prefill, 0 in the decode, finite logits; prints
     prefill ms, decode ms per step, tokens/s and the peak memory; then f32
     at the same width and 2 layers over 1 × 256 tokens, the card's logits
     at every position against the same weights on the host, within 2e-3
     or, where f32 cannot resolve that, 4 × the host's own f32 distance
     from a float64 run (both host runs routed as the card routed: a
     token's dispatch slot depends on every token's choices in its group;
     the top-6 choices the host would have made differently counted);
  9. LM training: `repro_torch.launch.train.build` at qwen3-0.6b's full
     width (fused_attention, remat, tp = 1, AdamW lr 3e-4 with
     grad_clip_norm 1.0) and its train step on 2 × (4 × 2048) tokens a
     step from the reference's token stream: one warm-up step, then 4
     timed steps; every loss finite; per step exactly 112
     flash_attention_fwd (a forward and a remat forward per layer and
     microbatch), 56 flash_attention_bwd_dkv, 56 flash_attention_bwd_dq
     and 0 flash_attention launches; prints ms per step (host clock around
     synchronised steps), tokens/s, max_memory_allocated and the losses.
     9b: the three training kernels against their plain versions on layer
     0 of the trained model (bf16) and at random non-aligned shapes (S =
     100, 130, 2049; window 0 and 48; GQA 2 and 4; f32 and bf16) and the
     bf16 tensor-core backward's tile edges (S = 1 at an offset, 63, 64,
     65, 127, 129; D = 48, 80, 112; GQA 1 and 8; a negative offset; a
     window ending inside a tile): o f32
     2e-5 (bf16 2e-2 + 1e-2·|o|), lse 1e-5, backward f32 5e-4, bf16
     1e-2·|want| + 1e-3·max|want|. 9c: one f32 microbatch of 1 × 2048 at
     full width (TF32 off): loss within 1e-4 and every gradient leaf
     within 1e-3·max|leaf| of the plain attention path. 9d: each training
     kernel's device and call time at the training shape, its plain
     version's, its bound (its own products — 2, 4 and 3 — at the bf16
     tensor-core peak) and the library yardstick (SDPA's forward, and its
     backward through autograd), and for each of the three the same four
     figures as 8d (TFLOP/s, share of the bound, x SDPA, the f32
     instance's device time); 9e: the training CLI
     (`launch.train.run`) at qwen3-0.6b widths and 2 layers with a failure
     injected before step 2 and a checkpoint every step: 1 restart,
     finite losses, 3 checkpoints;
  6a. 10 CNN training steps under torch.profiler (device busy and idle
     share, the kernels that took the most device time);
  10. xlstm serving: `launch.serve.serve_session` builds xlstm-125m at
     full width (12 blocks, sLSTM at 3 and 9, d_model 768, 4 heads, vocab
     50304, bf16, tp = 1; 141 225 296 parameters) with seeded random
     weights on the card and serves 4 × 2048-token prompts, then 32 greedy
     decode steps; with the counts zeroed before each, slstm_fused must
     launch exactly 2 times in the prefill and 64 over the decode (one per
     sLSTM block and step), every one of them the cluster kernel
     (`INSTANCE_LAUNCHES`), and no flash kernel at all; every logit finite;
     prints prefill ms, decode ms per step, tokens/s (host clock around
     synchronised work) and the peak memory the run added. 10b: the kernel
     against its plain version (f32, TF32 off) and a float64 run of the
     plain version, on block 3's xg and state from that prefill (recomputed,
     and reproducing the prefill's state bitwise) and on random inputs with
     a nonzero state at (B, S, nh, dh) = (4, 2048, 4, 192), (1, 65, 2, 8),
     (3, 17, 1, 32), (2, 1, 4, 192), (1, 300, 4, 100), (5, 33, 4, 192) (a
     ragged row group) and (2, 33, 1, 1024) (the stream kernel), xg and r
     each f32 and bf16, each through the plan `slstm._plan` gives (held to
     the library's own `slstm_plan`; the count of the kernel it names must
     go up): within atol 1e-4, or 4 × the plain version's own distance
     from float64 where f32 cannot resolve 1e-4 (see SLSTM_ATOL); the
     cluster kernel at forced geometries the plan does not take
     (SLSTM_FORCED: CTAs with no column, a ragged row group at every RB,
     Q = 16) within 1e-4; a split at 700 of 2048 steps bitwise equal to one
     pass; and the f32-vs-float64
     distance of the plain version at the reference test's r ~ 0.3·N
     (printed: that recurrence is chaotic at dh = 192). 10c: the whole
     model in f32 at full width (TF32 off): the card's prefill logits over
     1 × 512 tokens against the same weights on the host (device="cpu"),
     and decode at position 2047 after a 2047-token prefill against a
     2048-token prefill, each within 2e-3. 10d: the kernel's call and
     device time at the serving shape, µs a step, the plan's Q and RB and
     how many such clusters the card holds at once, the plain version's
     time, the bound from `slstm_costs` (operations at the FP32 peak; the
     recurrence makes 2048 dependent steps), beside the stream kernel's
     16.44 ms at the same shape (PERF.md §6 row 10), then
     one prefill and 4 decode steps under torch.profiler (idle share, top
     kernels, the kernel's share of the prefill);
  9x. xlstm training: `launch.train.build` at xlstm-125m's full width
     (bf16, remat, tp = 1, AdamW lr 3e-4, grad_clip_norm 1.0) and its
     train step on 2 × (4 × 2048) tokens: one warm-up step, then 4 timed
     steps; every loss finite and the last no higher than the first; per
     step exactly 8 slstm_fused launches (the cluster kernel, twice per
     sLSTM block and micro-batch under remat) and 4 slstm_fused_bwd
     launches, all the cluster backward (`INSTANCE_LAUNCHES`
     "bwd_cluster"; none "bwd_stream"); prints ms per step,
     tokens/s, peak memory, the losses and one profiled step's idle
     share. Then on block 3's trained inputs (a fresh micro-batch; bf16 xg
     and r) the backward's planned kernel (the cluster kernel, its plan
     held to the library's `slstm_bwd_plan`) and the stream kernel forced,
     each against `ref.slstm_fused_bwd` (f32, TF32 off) and its float64
     run: each output within max(1e-4 · max(1, |x|), 4 × the plain
     version's own float64 distance), two launches of each bitwise; the
     block's slstm_r and slstm_w gradients in f32 through the kernel path
     (`models.xlstm.slstm_scan`) against autograd through the plain loop,
     nonzero and within 1e-3 · max|leaf|; and the backward's call and
     device time, µs a step, Q and RB, beside the stream kernel's forced
     on the same inputs in the same call, the plain loop's time and the
     bound from `slstm_bwd_costs`;
  8v. VLM serving: `serve_session` builds llava-next-34b at full width
     (d_model 7168, 56 heads of 128 over 8 KV heads, d_ff 20480, vocab
     64000, bf16, fused_attention, tp = 1) with its depth cut to 8 of 60
     layers (its parameter count checked against the one the config
     implies) and serves 4 × (2880 image tokens ~ 0.1·N from a seed +
     2048 text tokens), then 32 greedy decode steps at the global
     positions 4928 + i (the prefix shifts the text): 8 flash launches in
     the prefill, 0 in the decode, finite logits; prints prefill ms,
     decode ms per step, tokens/s and peak memory; then f32 at 2 layers
     over 1 × (256 + 256) tokens: the card's logits at every position
     against the host's within 2e-3 or 4 × the host's own f32 distance
     from a float64 run where f32 cannot resolve 2e-3 ([8m]'s rule), and
     decode at the prefix-shifted position against a prefill one token
     longer within 2e-3;
  8h. hybrid serving: zamba2-1.2b at full width and depth (38 mamba2
     layers, d_model 2048, 64 SSD heads of 64, ssm_state 64, the shared
     block of 32 heads of 64 and d_ff 8192 after layers 5, 11, …, 35,
     vocab 32000, bf16, tp = 1; 1 170 473 856 parameters), 4 × 2048
     tokens + 32 decode steps: 6 flash launches in the prefill, 0 in the
     decode; prints as [8v] and the prefill's device idle share under
     torch.profiler; then f32 at 12 layers (two applications of the
     shared block) over 1 × 512 tokens, card vs host and decode at 512
     against a prefill over 513, bounds as [8v];
  8w. encoder-decoder serving: whisper-large-v3 at full width and depth
     (32 + 32 layers, d_model 1280, 20 heads of 64, d_ff 5120, vocab
     51866 padded to 51968, enc_len 1500, bf16, tp = 1; 1 601 251 840
     parameters) on 4 × 1500 frames (~ 0.1·N, in place of the stubbed
     mel frontend) and 416-token prompts, then 32 decode steps (416 + 32
     = whisper's 448-token context): 32 flash launches in the prefill
     (the decoder's causal self-attention; the encoder and the
     cross-attention are plain, as in the reference), 0 in the decode;
     prints the prefill, the encoder alone, decode ms per step, tokens/s
     and peak memory; then f32 at 2 + 2 layers over 1500 frames and 64
     tokens, bounds as [8v]; then the flash forward's figures of [8d] at
     the two head-dim-64 prefill shapes, (4, 2048, 32, 64) and (4, 416,
     20, 64) bf16 causal;
  9h. hybrid training: `launch.train.build` at zamba2-1.2b's full width
     and depth (bf16, remat, fused_attention, AdamW lr 3e-4,
     grad_clip_norm 1.0) on 2 × (4 × 2048) tokens a step: one warm-up
     step, then 4 timed steps; every loss finite, the last no higher than
     the first; per step exactly 24 flash_attention_fwd (2 per
     application of the shared block and micro-batch under remat), 12
     dK/dV and 12 dQ launches; prints ms per step, tokens/s, peak memory,
     the losses and one profiled micro-batch step's idle share; then f32
     at full width, 12 layers, 1 × 512 tokens: the shared block's attn
     and mlp gradients and mamba layer 7's in_proj and A_log, fused
     against plain attention, nonzero and within 1e-3 · max|leaf|;
  9d: one full-width LM train step under torch.profiler, after a warm-up
     step inside the profiler's schedule (the last profiled phase): idle
     share and the top device activities;
  17. the sharded launch on a one-rank NCCL world's (1, 1) DeviceMesh
     ("data", "model") on the card: qwen3-0.6b at full width and depth
     (tp=1, fused_attention) through `launch.steps.make_lowerable`, its
     params, AdamW state, batch and serve state DTensors, the flash
     kernels reached through `local_map`: one train step on [9]'s 2 × (4
     × 2048) tokens (the train_4k cell cut in batch), the prefill of [8]'s
     4 × 2048 tokens and 32 greedy decode steps, each against the
     unsharded path (`launch.train.build`, `launch.serve.serve_session`)
     on the same seeded weights and inputs: the flash counts, zeroed
     before each path, equal both ways (112 / 56 / 56 a step, 28 a
     prefill, 0 a decode); bitwise where it is, else the loss and logits
     within 2e-3 × their largest magnitude and every parameter after the
     step within 1e-3 · max|leaf|; the step, prefill and decode ms both
     ways, the steps' beside SHARD_MS_BEFORE (the readings before the
     weight products ran on each rank's own rows); 17b. one sharded
     xlstm-125m train step on the same mesh against `launch.train.build`:
     8 slstm_fused "cluster" and 4 slstm_fused_bwd "bwd_cluster" launches
     both ways, the same bounds. Multi-rank
     sharding cannot run on one card (NCCL refuses two ranks on one GPU;
     gloo's all-gather of CUDA tensors segfaults on the card): the tests hold
     a 2 × 2 gloo CPU mesh against the reference; 17c. the dry run
     (`launch.dryrun`, one process a cell, all together, CPU only):
     qwen3-0.6b × train_4k / prefill_32k / decode_32k (fused_attention)
     on the 16 × 16 and 2 × 16 × 16 fake worlds, xlstm-125m × long_500k,
     qwen3-0.6b × long_500k (skipped with the policy's reason) and
     mixtral-8x22b × decode_32k with int8 weight gathers (each layer's
     weights gathered and dequantized when its layer runs); each ok
     cell's roofline terms, bottleneck, MFU at the roofline, collective
     ring bytes by op, bytes per rank, the op at the temporaries' peak
     and the local matrix product with the largest operand (every weight
     product multiplies a rank's own rows, `sharding.weight_products`);
     a failed cell fails the script, and so does a qwen3 train_4k
     cell (its CE vocab-parallel) or the mixtral cell that does not fit
     80 GB a rank.
The line before the last is the `kernels` JSON (twelve kernels; the
three cnn_eq rows also carry their launches on each path, `path_launches`:
[4], [11], [12], [13], [14], [15] and [16], the last summed over ranks;
the flash forward's row its launches in the [8], [8v], [8h], [8w] and
[17] prefills and its head-dim-64 readings, the training kernels' rows
their launches over [9]'s and [9h]'s timed steps and [17]'s sharded
step; the sLSTM rows theirs in [10] / [9x] and [17b]'s sharded step; the
sLSTM backward's row the
cluster kernel's Q, RB, registers and µs a step beside the stream
kernel's times forced in the same call);
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Phases 3–5 and 11–13 use random weights from a seed (numpy), carried in
through `repro_torch.interop`, and waveforms of PAM-2 through a short ISI
filter with noise, also from a seed ([13c] draws its traffic from seeded
card generators through the simulated channels; [14] trains and draws
its drift traffic from seeded generators, the reference's seeds 0, 1, 3
and 77 as numbers); phases 6–7 train from seeded generators on
the simulated link; phases 8, 9 and 10 (and 8v, 8h, 8w, 9h) draw their
weights from seeded card generators, phases 9 and 9h their tokens from
the reference's seeded stream. Without a CUDA card the script exits with
code 2.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import gc
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs as LM_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import net  # noqa: E402
from repro_torch.channels import imdd, proakis  # noqa: E402
from repro_torch.channels.drift import (DriftingIMDD,  # noqa: E402
                                        DriftingProakis, DriftSchedule)
from repro_torch.channels.common import (ber_from_soft,  # noqa: E402
                                         pam_decision)
from repro_torch.configs import equalizer_ht as HT  # noqa: E402
from repro_torch.core import equalizer as eq  # noqa: E402
from repro_torch.core import fir, qat, seqlen_opt, train_eq  # noqa: E402
from repro_torch.core import stream_partition as SP  # noqa: E402
from repro_torch.core import timing_model as TM  # noqa: E402
from repro_torch.core import volterra as vol  # noqa: E402
from repro_torch.data import PipelineConfig, lm_batches  # noqa: E402
from repro_torch.data.equalizer_data import channel_fn  # noqa: E402
from repro_torch.device import fp32_exact  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cnn_eq import cnn_eq as K  # noqa: E402
from repro_torch.kernels.cnn_eq import ref as R  # noqa: E402
from repro_torch.kernels.cnn_eq import sweep as K_sweep  # noqa: E402
from repro_torch.kernels.conv1d import conv1d as C1  # noqa: E402
from repro_torch.kernels.conv1d import ops as C1_ops  # noqa: E402
from repro_torch.kernels.conv1d import ref as C1_ref  # noqa: E402
from repro_torch.kernels.conv1d import sweep as C1_sweep  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attn as FA  # noqa: E402
from repro_torch.kernels.flash_attn import ref as FA_ref  # noqa: E402
from repro_torch.kernels.quant import ops as Q_ops  # noqa: E402
from repro_torch.kernels.quant import quant as Q  # noqa: E402
from repro_torch.kernels.quant import ref as Q_ref  # noqa: E402
from repro_torch.kernels.volterra import ops as V_ops  # noqa: E402
from repro_torch.kernels.volterra import ref as V_ref  # noqa: E402
from repro_torch.kernels.volterra import sweep as V_sweep  # noqa: E402
from repro_torch.kernels.slstm import ref as SL_ref  # noqa: E402
from repro_torch.kernels.slstm import slstm as SL  # noqa: E402
from repro_torch.kernels.slstm import sweep as SL_sweep  # noqa: E402
from repro_torch.kernels.volterra import volterra as V  # noqa: E402
from repro_torch.interop import (tree_leaves,  # noqa: E402
                                 tree_named_leaves, tree_unflatten)
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import serve as LM_serve  # noqa: E402
from repro_torch.launch import steps as LM_steps  # noqa: E402
from repro_torch.launch import train as LM_train  # noqa: E402
from repro_torch.launch.roofline import HBM_BYTES_S, PEAK_OPS_S  # noqa: E402
from repro_torch.models import attention as LM_attn  # noqa: E402
from repro_torch.models import registry as LM_registry  # noqa: E402
from repro_torch.models import transformer as LM_tr  # noqa: E402
from repro_torch.models import whisper as WH  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402
from repro_torch.models import zamba2 as ZB  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.obs import (LinkMonitor, Observability,  # noqa: E402
                             SloEngine, SloRule)
from repro_torch.obs import report as OBS_report  # noqa: E402
from repro_torch.serve import (AsyncServeRuntime, BatchPolicy,  # noqa: E402
                               Fault, FaultPlan, FleetRuntime, ServeRuntime,
                               TenantSpec, loadgen)
from repro_torch.adapt import (AdaptPolicy, FineTuneConfig,  # noqa: E402
                               OnlineAdapter, PromotionPolicy, engine_ber,
                               fine_tune_from_buffer)
from repro_torch.examples.adaptive_serving import burst_ber  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.engine import EqualizerEngine  # noqa: E402
from repro_torch.launch.mesh import (make_mesh, run_ranks,  # noqa: E402
                                     stages_through_host)
from repro_torch.optim import grad_comp as GC  # noqa: E402
from repro_torch.parallel import halo as HALO  # noqa: E402
from repro_torch.parallel import sharding as SHARD  # noqa: E402
from repro_torch.runtime import ElasticRestore, best_mesh  # noqa: E402

CFG = HT.CNN
ROWS = HT.N_INSTANCES                 # 64 parallel instances
SYMS = HT.L_INST                      # 7320 symbols per instance
TILES = (16, 64, 256)
# [3] edge widths: (rows, samples, tile_m, strided view); the receptive
# field is 137 samples, a final position 16, the plan's run 60 positions
EDGE_SHAPES = ((1, 2 * SYMS, 64, False), (4, 100, 64, False),
               (4, 16, 64, False), (4, 16 * 197 + 9, 16, True),
               (ROWS, 16 * 131 + 3, 8192, False))
# device ms of the kernels before their redesigns took these calls
# (PERF.md §6 rows 1–6, conv1d's three layers summed; NVIDIA H100 80GB
# HBM3, 700.00 W)
OLD_DEVICE_MS = {"fp32": 0.0457, "bf16": 0.0475, "int8": 0.0441,
                 "conv1d": 0.0610, "volterra": 0.0241,
                 "fixed_point_quantize_64x14640": 0.00621}
FORMATS = {
    "ht": {"w_int": 2, "w_frac": 5, "a_int": 3, "a_frac": 4},   # → int8
    "lp": {"w_int": 3, "w_frac": 8, "a_int": 3, "a_frac": 8},   # → bf16
}
# the H100 SXM's published peaks (dense), bytes/s and operations/s per
# type, are HBM_BYTES_S and PEAK_OPS_S of repro_torch.launch.roofline
SOURCE = "src/repro_torch/kernels/cnn_eq/csrc/cnn_eq.cu"
KERNELS = {   # datapath → (wrapper name, TPU kernel it replaces)
    "fp32": ("cnn_eq_fused", "src/repro/kernels/cnn_eq/cnn_eq.py:268"),
    "bf16": ("cnn_eq_fused_bf16", "src/repro/kernels/cnn_eq/cnn_eq.py:293"),
    "int8": ("cnn_eq_fused_int8", "src/repro/kernels/cnn_eq/cnn_eq.py:342"),
}
BACKEND_OF = {"fp32": "fused_fp32", "bf16": "fused_bf16",
              "int8": "fused_int8"}
# the train-then-deploy slice: its kernels, sources and the TPU kernels
# they replace
SOURCES = (K.CSRC, V.CSRC, Q.CSRC, C1.CSRC, FA.CSRC, FA.CSRC_BWD, SL.CSRC,
           SL.CSRC_BWD)
DEPLOY_KERNELS = {
    "volterra": ("src/repro_torch/kernels/volterra/csrc/volterra.cu",
                 "src/repro/kernels/volterra/volterra.py:61", V.LAUNCHES),
    "fixed_point_quantize": (
        "src/repro_torch/kernels/quant/csrc/quant.cu",
        "src/repro/kernels/quant/quant.py:33", Q.LAUNCHES),
    "conv1d": ("src/repro_torch/kernels/conv1d/csrc/conv1d.cu",
               "src/repro/kernels/conv1d/conv1d.py:46", C1.LAUNCHES),
}
TRAIN = train_eq.EqTrainConfig(steps=300, batch=8, seq_syms=512,
                               eval_syms=1 << 15)
QAT_CFG = qat.QATConfig(init_int_bits=8.0, init_frac_bits=8.0)
FAMILIES = {"cnn": (HT.CNN, QAT_CFG), "fir": (fir.FIRConfig(), None),
            "volterra": (vol.VolterraConfig(), None)}
VOLTERRA_SETS = ((41, 15, 9), (121, 35, 15))    # random; the DSE's largest
# [7] the register-blocked Volterra kernel's edges: (rows, samples, strided
# view); its plan's run is 512 symbols, P = 4
V_EDGES = ((ROWS, 2 * 100, False), (ROWS, 2 * 257, False),
           (ROWS, 2 * 1001 + 1, False), (1, 2 * SYMS, False),
           (ROWS, 2 * 513 + 1, True))
HALF_TYPES = (torch.bfloat16, torch.float16)
# the LM serving slice (phase 8)
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
FLASH = ("flash_attention",
         "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
         "src/repro/kernels/flash_attn/flash_attn.py:186")
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the forward's kernels by input type, as the profiler names them: the
# bf16 tensor-core template and the f32 FMA template
FLASH_KERNEL = {torch.bfloat16: "flash_attn_kernel_tc<",
                torch.float32: "flash_attn_kernel<float"}
FLASH_CASES = (  # b, sq, sk, h, hkv, d, causal, window, q_offset
    (1, 1000, 1000, 16, 8, 128, True, 0, 0),      # non-aligned, GQA 16/8
    (1, 1000, 1000, 8, 1, 128, True, 0, 0),       # MQA 8/1
    (1, 1000, 1000, 16, 8, 128, True, 256, 0),    # sliding window
    (1, 700, 1000, 16, 8, 128, True, 0, 300),     # q_offset > 0, Sq < Sk
    (1, 1000, 1000, 16, 8, 128, False, 0, 0),     # bidirectional
    (2, 1000, 1000, 4, 2, 48, True, 0, 0),        # qwen3-reduced head dim
    # the bf16 tensor-core tiles' edges (64-row q tiles, 64-key K/V tiles)
    (1, 63, 63, 16, 8, 128, True, 0, 0),
    (1, 64, 64, 16, 8, 128, True, 0, 0),
    (1, 65, 65, 16, 8, 80, True, 0, 0),
    (1, 129, 129, 16, 8, 112, True, 0, 0),
    (1, 2049, 2049, 16, 8, 128, True, 0, 0),
    (1, 129, 129, 16, 8, 112, True, 37, 0),       # window ends inside a tile
    (1, 65, 2049, 16, 8, 80, True, 0, 1984),      # Sq < Sk, offset 1984
    # head dim 64: the served shapes of [8h] (zamba2's shared block, MHA
    # 32/32, its window the 2080-slot cache) and [8w] (whisper's decoder
    # prefill, 20/20), and a tile edge
    (4, 2048, 2048, 32, 32, 64, True, 2080, 0),
    (4, 416, 416, 20, 20, 64, True, 0, 0),
    (1, 65, 65, 16, 8, 64, True, 0, 0),
)
LM_LOGIT_TOL = 2e-3          # the reference's decode-vs-prefill bound
# the LM training slice (phase 9): microbatches of 4 x 2048 tokens, accum 2
LM_TRAIN_MB, LM_TRAIN_SEQ, LM_TRAIN_ACCUM, LM_TRAIN_STEPS = 4, 2048, 2, 4
LM_TRAIN_LR = 3e-4
FLASH_SRC = "src/repro_torch/kernels/flash_attn/csrc/"
FLASH_TPU = "src/repro/kernels/flash_attn/flash_attn.py:"
TRAIN_KERNELS = {   # name → (source, TPU kernel's pallas_call, products)
    "flash_attention_fwd": (FLASH_SRC + "flash_attn.cu", FLASH_TPU + "282",
                            2),
    "flash_attention_bwd_dkv": (FLASH_SRC + "flash_attn_bwd.cu",
                                FLASH_TPU + "342", 4),
    "flash_attention_bwd_dq": (FLASH_SRC + "flash_attn_bwd.cu",
                               FLASH_TPU + "366", 3),
}
TRAIN_KERNEL_NAMES = {   # name → (bf16 instance, f32 instance) in traces
    "flash_attention_fwd": (FLASH_KERNEL[torch.bfloat16],
                            FLASH_KERNEL[torch.float32]),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_kernel_tc<",
                                "flash_bwd_dkv_kernel<float"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_kernel_tc<",
                               "flash_bwd_dq_kernel<float"),
}
TRAIN_CASES = (  # b, sq, sk, h, hkv, d, window, q_offset
    (1, 100, 100, 8, 4, 128, 0, 0),       # non-aligned S, GQA 2 and 4
    (1, 130, 130, 16, 4, 128, 48, 0),
    (2, 130, 130, 8, 2, 128, 0, 0),
    (1, 2049, 2049, 16, 8, 128, 0, 0),
    (1, 2049, 2049, 16, 4, 128, 48, 0),
    # the bf16 tensor-core backward's tile edges (64 q rows x 64 keys,
    # 16-wide passes): S = 1 (one query at an offset; a lone row with a
    # lone key has ds = 0 up to rounding, which no elementwise bound can
    # compare), 63, 64, 65, 127, 129; D = 48, 80, 112; GQA 1 and 8
    (1, 1, 65, 16, 16, 128, 0, 64),
    (1, 63, 63, 16, 8, 48, 0, 0),
    (1, 64, 64, 16, 2, 80, 0, 0),
    (1, 65, 65, 16, 16, 112, 0, 0),
    (1, 127, 127, 16, 2, 128, 0, -5),     # rows with no valid key
    (1, 129, 129, 16, 8, 112, 37, 0),     # window ends inside a tile
    # head dim 64: [9h]'s shared block (one micro-batch of zamba2, MHA
    # 32/32) and a tile edge
    (4, 2048, 2048, 32, 32, 64, 0, 0),
    (1, 65, 65, 16, 8, 64, 0, 0),
)
LSE_TOL = 1e-5               # lse: f32 math in both, any input type
BWD_F32_TOL = 5e-4           # the reference's bound on its own backward
# bf16 backward: kernel and plain round the same f32 result once, so they
# differ by at most one bf16 ulp (≤ 2^-7·|want|) plus f32 sum-order noise
BWD_BF16_RTOL, BWD_BF16_ATOL_REL = 1e-2, 1e-3
# [9e]: the training CLI at qwen3-0.6b widths and 2 layers, a failure
# injected before step 2, a checkpoint every step
LM_CLI_ARGS = ("--arch", LM_ARCH, "--full", "--layers", "2", "--steps", "3",
               "--batch", "4", "--seq", "512", "--accum", "2",
               "--ckpt-every", "1", "--fail-at", "2")
# [9c]: fused vs plain in f32 at full width, stated before the first run:
# |loss| difference and each gradient leaf's max |diff| / max |leaf|
TRAIN_F32_LOSS_TOL, TRAIN_F32_GRAD_TOL = 1e-4, 1e-3
# the xlstm serving slice (phase 10): xlstm-125m at full width, 4 x 2048
# tokens + 32 decode steps, as phase 8; its parameter count from
# jax.eval_shape of the reference's init
XL_ARCH, XL_PARAMS = "xlstm-125m", 141_225_296
SLSTM = ("slstm_fused", "src/repro_torch/kernels/slstm/csrc/slstm.cu",
         "src/repro/kernels/slstm/slstm.py:86")
SLSTM_CASES = ((4, 2048, 4, 192), (1, 65, 2, 8), (3, 17, 1, 32),
               (2, 1, 4, 192), (1, 300, 4, 100), (5, 33, 4, 192),
               (2, 33, 1, 1024))                   # b, s, nh, dh
# [10b] the cluster kernel at geometries the plan does not take: (b, s, nh,
# dh) and (Q, RB); dh = 8 at Q = 16 leaves eight CTAs with no column
SLSTM_FORCED = (((1, 9, 2, 8), (16, 1)), ((5, 9, 2, 40), (8, 4)),
                ((3, 9, 4, 100), (7, 2)), ((2, 9, 4, 192), (16, 1)))
# [10d] the stream kernel's device time at the serving shape, from before
# the cluster kernel took the shape (PERF.md §6 row 10), printed beside
# this run's
SLSTM_STREAM_MS = 16.44
SLSTM_SPLIT = 700
# [10b] kernel vs plain, stated before the first run: atol 1e-4 (the
# reference's bound on its own kernel, tests/test_slstm_kernel.py:26)
# wherever f32 resolves 1e-4 over the sequence. Where it cannot, the bound
# is SLSTM_ENVELOPE x the plain version's own distance from a float64 run
# of the same function: under the model's forget offset m grows by ~1 a
# step, and at |m| ~ 2048 one f32 ulp is 2.4e-4, so two f32 orders of the
# recurrent sum part by more than 1e-4 in m (and in c, n) whatever the
# kernel does. A case counts only if f32 resolves it: plain vs float64
# within SLSTM_RESOLVED x max(1, |x|) (a chaotic case measures f32, not
# the kernel).
SLSTM_ATOL, SLSTM_ENVELOPE, SLSTM_RESOLVED = 1e-4, 4.0, 1e-3
# [9x] xlstm training: xlstm-125m at full width through launch.train.build,
# LM_TRAIN_ACCUM x (LM_TRAIN_MB x LM_TRAIN_SEQ) tokens a step, 1 warm-up
# step and XL_TRAIN_STEPS timed ones; the backward kernel is held on block
# 3's trained inputs to the row-10 rule, stated before the first run:
# max |kernel - plain| <= max(SLSTM_ATOL · max(1, max |float64|),
# SLSTM_ENVELOPE · max |plain - float64|) for dxg, dr and each dstate0;
# slstm_r's and slstm_w's gradients through the block, kernel path (the
# autograd Function) against autograd through the plain loop, f32, nonzero
# and within XL_GRAD_TOL · max|leaf| (see XL_GRAD_PREFIX)
SLSTM_BWD = ("slstm_fused_bwd", "src/repro_torch/kernels/slstm/csrc/"
             "slstm_bwd.cu", "none: the reference differentiates its "
             "lax.scan (src/repro/models/xlstm.py:257); its Pallas kernel "
             "(src/repro/kernels/slstm/slstm.py:104) has no backward")
XL_TRAIN_STEPS, XL_GRAD_TOL = 4, 1e-3
# [9x] the gradient check over the whole sequence is held to the row-10
# rule (max(XL_GRAD_TOL · max|leaf|, SLSTM_ENVELOPE x the plain f32
# path's distance from float64)): the model's slstm_r ~ 0.3·N makes the
# recurrence expand, and over 2048 steps its gradient reached 3e6 with
# the f32 paths 42 % apart (my chip call 4, PR 26). Over the first
# XL_GRAD_PREFIX steps f32 resolves it, and there the bound is
# XL_GRAD_TOL · max|leaf| alone
XL_GRAD_PREFIX = 256
# [8m] MoE serving: moonshot-v1-16b-a3b at full width, its depth cut to
# MOE_LAYERS of 48, LM_BATCH x LM_PROMPT tokens + LM_GEN decode steps; then
# f32 at MOE_F32_LAYERS layers over MOE_F32_TOKENS tokens, card vs host
MOE_ARCH, MOE_LAYERS = "moonshot-v1-16b-a3b", 4
MOE_F32_LAYERS, MOE_F32_TOKENS = 2, 256
# [8m] card vs host in f32 is held to LM_LOGIT_TOL where f32 resolves it;
# where it cannot, to MOE_F32_ENVELOPE x the host's own f32 distance from
# a float64 run of the same function (the row-10 rule). The reference's
# init draws wq and wk with fan_in = the head count (16), so |q|, |k| reach
# ~11 an entry and the attention scores ~100: a near one-hot softmax that
# carries f32 rounding far (PERF.md, PR 26)
MOE_F32_ENVELOPE = 4.0
# [10c]: f32 at full width, card vs host over this many tokens, and decode
# vs prefill at LM_PROMPT; both within LM_LOGIT_TOL, stated before the
# first run
XL_F32_TOKENS = 512
# [8v] VLM serving: llava-next-34b at full width, its depth cut to
# VLM_LAYERS of 60 (the whole model is 68.8 GB of bf16 weights; 8 layers
# with the embedding and the head are 10.8 GB), LM_BATCH x (2880 image +
# LM_PROMPT text) tokens and LM_GEN decode steps at the global positions;
# the image prefix ~ VLM_PREFIX_STD · N from a seed. Then f32 at
# VLM_F32_LAYERS layers over VLM_F32_IMG image + VLM_F32_TEXT text tokens,
# card vs host and decode at the prefix-shifted position vs a prefill one
# token longer, each to [8m]'s rule: LM_LOGIT_TOL, or F32_ENVELOPE x the
# host's own f32 distance from float64 where f32 cannot resolve it
VLM_ARCH, VLM_LAYERS, VLM_PREFIX_STD = "llava-next-34b", 8, 0.1
VLM_F32_LAYERS, VLM_F32_IMG, VLM_F32_TEXT = 2, 256, 256
F32_ENVELOPE = MOE_F32_ENVELOPE
# where f32 cannot resolve LM_LOGIT_TOL for decode vs prefill, the bound
# is F32_ENVELOPE x the host's own f32 decode's and prefill's distance
# from their float64 runs, and the serving path's decode vs prefill in
# float64 must agree within this ([8h]'s f32 decode vs prefill on the
# card is 3.9e-3 where the host's own f32 forward is 8.3e-3 from float64,
# PERF.md)
F64_CONSISTENCY_TOL = 1e-6
F32_RULE = (f"each {LM_LOGIT_TOL}, or where f32 cannot resolve it "
            f"{F32_ENVELOPE} x the host's own f32 distance from float64 on "
            f"the same function")
# [8h] / [9h] the hybrid: zamba2-1.2b at full width and depth (its
# parameter count at tp = 1, from the reference's init shapes); f32 checks
# at HY_F32_LAYERS layers (two applications of the shared block) over
# HY_F32_TOKENS tokens; [9h] trains 1 warm-up + HY_TRAIN_STEPS steps and
# holds the shared block's and one mamba layer's gradients, fused against
# plain attention, to HY_GRAD_TOL · max|leaf| (the PR 14 guard)
HY_ARCH, HY_PARAMS = "zamba2-1.2b", 1_170_473_856
HY_F32_LAYERS, HY_F32_TOKENS = 12, 512
HY_TRAIN_STEPS, HY_GRAD_TOL, HY_GRAD_LAYER = 4, 1e-3, 7
# [8w] the encoder-decoder: whisper-large-v3 at full width and depth,
# LM_BATCH x 1500 frames (~ VLM_PREFIX_STD · N, in place of the stubbed
# mel frontend), an ED_PROMPT-token decoder prompt and ED_GEN decode steps
# (416 + 32 = whisper's 448-token text context); f32 at ED_F32_LAYERS +
# ED_F32_LAYERS layers over 1500 frames and ED_F32_TOKENS tokens
ED_ARCH, ED_PARAMS = "whisper-large-v3", 1_601_251_840
ED_PROMPT, ED_GEN = 416, 32
ED_F32_LAYERS, ED_F32_TOKENS = 2, 64
# [11] one stream of N_i = 64 instances of l_inst symbols, split over 8 and
# over 64 instances
PART_SYMS = HT.N_INSTANCES * HT.L_INST          # 468 480 symbols
PART_INSTANCES = (8, HT.N_INSTANCES)
# [12] each tenant's link-quality floor (random weights: a breach is
# recorded, not a failure)
SLO_SNR_FLOOR_DB = 10.0
# [13] the wire's impairment, each way
WIRE_REORDER, WIRE_DUP = 6, 0.2
# [13c] drift traffic: tenants, bursts of SYMS symbols, and the bound of a
# drifting channel at t = 0 against the stationary simulator on the same
# draws (the channels' bound, tests/test_torch_channels.py)
DRIFT_TENANTS, DRIFT_BURSTS = 4, 16
DRIFT_ATOL = 1e-4
# [14] adaptation at the reference's acceptance sizes (tests/test_adapt.py
# test_drift_recovery_acceptance, benchmarks/bench_adapt.py): the
# equalizer_lp topology on DriftingProakis(), a 600-step base at t = 0,
# 26 bursts x 2048 symbols under DriftSchedule(4, 6), and the recovery
# criterion's factors and floors
ADAPT_CFG = eq.CNNEqConfig()
ADAPT_BASE_STEPS, ADAPT_BURSTS, ADAPT_BURST_SYMS = 600, 26, 2048
ADAPT_POLICY = AdaptPolicy(min_train_syms=3072, adapt_every_syms=3072,
                           eval_capacity=8192,
                           promotion=PromotionPolicy(min_eval_syms=1024,
                                                     eval_bucket_syms=512))
ADAPT_FT = FineTuneConfig(steps=200, batch=8, seq_syms=256, lr=3e-3)
FROZEN_FACTOR, FROZEN_FLOOR = 4.0, 1e-3      # frozen >= 4 x max(pre, 1e-3)
FRESH_FACTOR, FRESH_FLOOR = 2.0, 2.5e-3      # adaptive <= 2 x max(fresh, ..)
# [14a]/[14b] the background scenario of
# test_adapter_background_thread_with_live_async_traffic, at its sizes
BG_POLICY = AdaptPolicy(min_train_syms=1024, adapt_every_syms=512,
                        eval_capacity=4096,
                        promotion=PromotionPolicy(min_eval_syms=512,
                                                  eval_bucket_syms=256))
BG_FT = FineTuneConfig(steps=10, batch=4, seq_syms=128, lr=1e-3)
BG_PACE_S = 2.0           # [14a]: the longest wait for a cycle per burst
# [15] the fleet: worker 1 lost after its FLEET_KILL_AFTER-th execute
FLEET_KILL_AFTER = 3
# [16] the halo: [11]'s stream sharded over HALO_RANKS gloo ranks on the one
# card (NCCL refuses two ranks on one GPU), timed over HALO_ITERS calls
HALO_RANKS, HALO_ITERS = 4, 20
# [16b] compressed all-reduce of gradients shaped like this model's
# full-width parameter tree (tp = 1: the tree one card holds), timed over
# COMP_ITERS calls after one warm-up; [16c] saves and restores the same tree
COMP_ARCH, COMP_ITERS = "smollm-135m", 3
RANK_TIMEOUT_S = 600
# [17] the sharded cells: qwen3-0.6b at full width and depth through
# launch.steps.make_lowerable on a one-rank NCCL DeviceMesh (1, 1): the
# train cell cut from train_4k's 256 x 4096 to [9]'s 2 x (4 x 2048) tokens,
# a serving cell of LM_BATCH rows and LM_PROMPT + LM_GEN positions (the
# prefill of LM_BATCH x LM_PROMPT tokens, then LM_GEN decode steps), both
# at [8]/[9]'s tp = 1 with the flash kernels; each held against the
# unsharded path on the same weights and inputs: bitwise where it is,
# else the loss and logits within LM_LOGIT_TOL x their largest magnitude
# and every parameter after the step within SHARD_PARAM_TOL x max|leaf|
SHARD_TRAIN = ShapeSpec("train_2x4x2048", LM_TRAIN_SEQ,
                        LM_TRAIN_MB * LM_TRAIN_ACCUM, "train")
SHARD_SERVE = ShapeSpec("decode_4x2080", LM_PROMPT + LM_GEN, LM_BATCH,
                        "decode")
SHARD_OVERRIDES = {"tp": 1, "fused_attention": True}
SHARD_PARAM_TOL = 1e-3
# [17] / [17b] host ms of the sharded steps at commit e686c1c, before the
# weight products ran on each rank's own rows (DTensor's strategy laid
# them out), two runs in one call on an NVIDIA H100 80GB HBM3, 700.00 W,
# torch 2.11.0+cu128: printed beside this run's (DTensor's per-op host
# dispatch sets these times; the comparison is across calls)
SHARD_MS_BEFORE = {"train_sharded_again": (1796.0, 1946.3),
                   "train_unsharded_again": (720.0, 922.0),
                   "xlstm_sharded": (8474.6, 8049.8),
                   "xlstm_unsharded": (7279.0, 6621.6)}
# [17c] the dry run's cells on fake production worlds: (arch, shape,
# multi_pod, overrides); qwen3 with the flash kernels (its path here),
# mixtral serving 2-D sharded with int8 weight gathers; each cell one
# process, all started together
DRYRUN_CELLS = tuple(
    [("qwen3-0.6b", s, mp, {"fused_attention": True})
     for s in ("train_4k", "prefill_32k", "decode_32k")
     for mp in (False, True)]
    + [("xlstm-125m", "long_500k", False, {}),
       ("qwen3-0.6b", "long_500k", False, {}),
       ("mixtral-8x22b", "decode_32k", False, {"serve_int8_weights": True})])
DRYRUN_TIMEOUT_S = 420
# the cells whose temporaries the vocab-parallel CE and the layer-by-layer
# int8 dequantization bring within 80 GB a rank (on every mesh above)
DRYRUN_MUST_FIT = (("qwen3-0.6b", "train_4k"), ("mixtral-8x22b",
                                                "decode_32k"))


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# data and weights from seeds
# ---------------------------------------------------------------------------

def waveform(rng: np.random.Generator, n_syms: int) -> np.ndarray:
    """PAM-2 at N_os samples/symbol through a short ISI filter, plus noise."""
    sym = rng.choice(np.array([-1.0, 1.0]), n_syms)
    up = np.zeros(n_syms * CFG.n_os)
    up[::CFG.n_os] = sym
    rx = np.convolve(up, [0.2, 0.9, 0.35, -0.1])[:up.shape[0]]
    return (rx + 0.05 * rng.standard_normal(up.shape[0])).astype(np.float32)


def np_params(rng: np.random.Generator, fmt=None) -> dict:
    """He-initialized numpy params in the reference layout (+ QAT widths)."""
    params = {"conv": [], "bn": []}
    for i, (c_in, c_out, _) in enumerate(CFG.layer_specs()):
        std = np.sqrt(2.0 / (c_in * CFG.kernel))
        params["conv"].append({
            "w": (rng.standard_normal((c_out, c_in, CFG.kernel))
                  * std).astype(np.float32),
            "b": (0.05 * rng.standard_normal(c_out)).astype(np.float32)})
        if i < CFG.layers - 1:
            params["bn"].append({
                "scale": (1 + 0.1 * rng.standard_normal(c_out)).astype(
                    np.float32),
                "bias": (0.05 * rng.standard_normal(c_out)).astype(
                    np.float32)})
    if fmt is not None:
        params["qat"] = {f"layer{i}": {k: np.float32(v)
                                       for k, v in fmt.items()}
                         for i in range(CFG.layers)}
    return params


def np_bn_state(rng: np.random.Generator) -> dict:
    return {"bn": [{"mean": (0.1 * rng.standard_normal(c_out)).astype(
                        np.float32),
                    "var": (1 + 0.5 * rng.random(c_out)).astype(np.float32)}
                   for _, c_out, _ in CFG.layer_specs()[:-1]]}


def host_folded(rng: np.random.Generator):
    """BN-folded fp32 weights on the host, from numpy params via interop."""
    params = interop.to_torch(np_params(rng), device="cpu")
    bn = interop.to_torch(np_bn_state(rng), device="cpu")
    return eq.folded_weights(eq.fold_bn(params, bn, CFG))


def chop(w: np.ndarray, mean: int, rng: np.random.Generator,
         short: int) -> list:
    """Jittered chunks of ~mean samples; the second is `short` samples."""
    out = [w[:mean], w[mean:mean + short]]
    i = mean + short
    while i < w.shape[0]:
        n = max(1, int(mean * rng.uniform(0.5, 1.5)))
        out.append(w[i:i + n])
        i += n
    return out


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_inputs(dev, rows: int, syms: int) -> dict:
    """Per datapath: (wrapper, plain, x, stacked weights, shared weights)."""
    rng = np.random.default_rng(1)
    strides = eq.layer_strides(CFG)
    x = torch.from_numpy(np.stack([waveform(rng, syms)
                                   for _ in range(rows)])).to(dev)
    per_row = [host_folded(rng) for _ in range(rows)]
    fmts = (tuple(tuple(FORMATS["ht"][k]
                        for k in ("w_int", "w_frac", "a_int", "a_frac"))
                  for _ in range(CFG.layers)))
    forms = {"fp32": per_row,
             "bf16": [K.cast_weights_bf16(w) for w in per_row],
             "int8": [K.quantize_weights_int8(w, fmts) for w in per_row]}

    def stack(ws):
        return tuple((torch.stack([w[l][0] for w in ws]).to(dev),
                      torch.stack([w[l][1] for w in ws]).to(dev))
                     for l in range(CFG.layers))

    def shared(ws):
        return tuple((w.to(dev), b.to(dev)) for w, b in ws[0])

    wrap = {
        "fp32": (lambda x, w, t: K.cnn_eq_fused(x, w, strides, t),
                 lambda x, w: R.cnn_eq(x, w, strides)),
        "bf16": (lambda x, w, t: K.cnn_eq_fused_bf16(x, w, strides, t),
                 lambda x, w: R.cnn_eq_bf16(x, w, strides)),
        "int8": (lambda x, w, t: K.cnn_eq_fused_int8(x, w, strides, fmts, t),
                 lambda x, w: R.cnn_eq_int8(x, w, strides, fmts)),
    }
    return {dp: {"kernel": wrap[dp][0], "plain": wrap[dp][1], "x": x,
                 "stacked": stack(forms[dp]), "shared": shared(forms[dp]),
                 "strides": strides, "fp32_stacked": stack(per_row),
                 "formats": fmts}
            for dp in forms}


MODE_OF = {"fp32": K.MODE_FP32, "bf16": K.MODE_BF16, "int8": K.MODE_INT8}


def require_instances(launches: dict, instances: dict, where: str) -> None:
    """Every launch of every datapath ran the register-blocked kernel
    (counts zeroed together before)."""
    want = {"rb": sum(launches.values()), "generic": 0}
    require(instances == want, f"{where}: kernel instances {instances}, "
                               f"expected {want} from launches {launches}")


def check_edges(inputs: dict) -> list:
    """Kernel == plain bitwise at EDGE_SHAPES, every datapath, stacked
    weights; returns the shapes checked."""
    done = []
    for rows, width, tile, strided in EDGE_SHAPES:
        for dp, d in inputs.items():
            x = d["x"][:rows, :width]
            if strided:                     # a view with a row stride > W
                x = d["x"][:rows, 5:5 + width]
            else:
                x = x.contiguous()
            w = tuple((a[:rows].contiguous(), b[:rows].contiguous())
                      for a, b in d["stacked"])
            got, want = d["kernel"](x, w, tile), d["plain"](x, w)
            require(got.shape == want.shape and torch.equal(got, want),
                    f"{dp} at {rows}x{width} samples, tile {tile}: kernel "
                    f"!= plain")
        done.append(f"{rows}x{width}{' strided' if strided else ''} "
                    f"tile {tile}")
    return done


def check_plans() -> dict:
    """`cnn_eq._plan` against the library's `cnn_eq_plan`, each datapath;
    returns the library's plans."""
    lib = K._load()
    plans = {}
    for dp, mode in MODE_OF.items():
        plan = K._lib_plan(lib, mode, K._RB_DIMS)
        require(plan.instance == K._plan(mode, K._RB_DIMS),
                f"{dp}: _plan {K._plan(mode, K._RB_DIMS)} != cnn_eq_plan "
                f"{plan}")
        require(plan.instance == "rb", f"{dp}: plan {plan}, expected rb")
        plans[dp] = plan._asdict()
    return plans


def check_against_generic(inputs: dict) -> dict:
    """The register-blocked kernel == the generic kernel forced on the same
    inputs (every datapath; stacked and shared weights), bitwise."""
    fmts = {"fp32": None, "bf16": None, "int8": inputs["int8"]["formats"]}
    checked = {}
    for dp, d in inputs.items():
        for form in ("stacked", "shared"):
            got = d["kernel"](d["x"], d[form], 64)
            gen = K._forced("generic", MODE_OF[dp], d["x"], d[form],
                            d["strides"], 64, formats=fmts[dp])
            require(torch.equal(got, gen), f"{dp} {form}: rb != generic")
        checked[dp] = "bitwise"
    return checked


def check_kernels(inputs: dict, tiles) -> dict:
    """Kernel == plain bitwise for every datapath, weight form and tile.
    Returns the largest |kernel − plain| per datapath."""
    worst = {}
    for dp, d in inputs.items():
        worst[dp] = 0.0
        for form in ("stacked", "shared"):
            want = d["plain"](d["x"], d[form])
            for tile in tiles:
                got = d["kernel"](d["x"], d[form], tile)
                require(got.shape == want.shape,
                        f"{dp} {form} tile {tile}: shape {tuple(got.shape)}"
                        f" != plain {tuple(want.shape)}")
                require(bool(torch.isfinite(got).all()),
                        f"{dp} {form} tile {tile}: non-finite output")
                err = float((got - want).abs().max())
                worst[dp] = max(worst[dp], err)
                require(torch.equal(got, want),
                        f"{dp} {form} tile {tile}: kernel != plain "
                        f"(max |diff| {err:.3e})")
    return worst


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------

def tenants(n_syms: int, chunk_syms: int, counts=(4, 4, 1)):
    """int8 "ht", bf16 "lp" and fp32 tenants with their waveforms and
    jittered chunk streams (the second chunk shorter than the receptive
    field), all from seeds."""
    rng = np.random.default_rng(2)
    specs = []
    for op, n in zip(("ht", "lp", "fp"), counts):
        for i in range(n):
            specs.append(TenantSpec(f"{op}-{i}", CFG,
                                    params=np_params(rng, FORMATS.get(op)),
                                    bn_state=np_bn_state(rng)))
    waves = {s.tenant_id: waveform(rng, n_syms) for s in specs}
    short = R.receptive_halo([CFG.kernel] * CFG.layers,
                             eq.layer_strides(CFG))        # < 2·halo + 1
    streams = {tid: chop(w, chunk_syms * CFG.n_os, rng, short)
               for tid, w in waves.items()}
    return specs, waves, streams


def serve(dev, specs, streams, max_batch: int) -> dict:
    """Stream every tenant through one ServeRuntime, round-robin; returns
    the outputs, this run's launch counts, stats, backends and tiles."""
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rt = ServeRuntime(BatchPolicy(max_batch=max_batch), device=dev)
    sessions = {s.tenant_id: rt.open(s) for s in specs}
    backends = {tid: s.engine.backend for tid, s in sessions.items()}
    tiles = {tid: s.engine.resolved_tile_m() for tid, s in sessions.items()}
    n_rounds = max(len(c) for c in streams.values())
    for r in range(n_rounds):
        for tid, chunks in streams.items():
            if r < len(chunks):
                rt.submit(tid, chunks[r])
    outs = {tid: rt.close(tid) for tid in streams}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"outs": outs, "launches": dict(K.LAUNCHES),
            "instances": dict(K.INSTANCE_LAUNCHES), "stats": rt.stats(),
            "backends": backends, "tiles": tiles,
            "elapsed_s": time.perf_counter() - t0}


def check_offline(dev, specs, waves, outs, n_syms: int) -> int:
    """Each stream must equal its offline engine bitwise; returns the
    number of symbols checked."""
    ts = CFG.v_parallel * CFG.n_os
    n_out = (n_syms * CFG.n_os // ts) * CFG.v_parallel
    for s in specs:
        tid = s.tenant_id
        want = s.build_engine(dev)(waves[tid]).cpu().numpy()
        got = outs[tid]
        require(got.shape == (n_out,) and want.shape == (n_out,),
                f"{tid}: streamed {got.shape}, offline {want.shape}, "
                f"expected ({n_out},)")
        require(bool(np.isfinite(got).all()), f"{tid}: non-finite symbols")
        require(np.array_equal(got, want),
                f"{tid}: streamed != offline (max |diff| "
                f"{float(np.max(np.abs(got - want))):.3e})")
    return n_out * len(specs)


def check_serving_shapes(inputs: dict, stats: dict, tiles: dict) -> dict:
    """Kernel == plain bitwise at each datapath's most common serving launch
    shape (mode occupancy × median width of the run's traffic)."""
    shapes = {}
    K.reset_launch_counts()
    for dp, d in inputs.items():
        tr = stats["traffic"][f"L{CFG.layers}_K{CFG.kernel}_{BACKEND_OF[dp]}"]
        rows = tr["mode_occupancy"]
        width = min(tr["median_width"], d["x"].shape[1])
        x = d["x"][:rows, :width].contiguous()
        w = tuple((a[:rows].contiguous(), b[:rows].contiguous())
                  for a, b in d["stacked"])
        got, want = d["kernel"](x, w, tiles[dp]), d["plain"](x, w)
        require(torch.equal(got, want),
                f"{dp} at serving shape {rows}x{width}: kernel != plain")
        shapes[dp] = {"rows": rows, "width": width, "tile_m": tiles[dp]}
    require_instances(K.LAUNCHES, K.INSTANCE_LAUNCHES, "[4a]")
    return shapes


# ---------------------------------------------------------------------------
# phase 11: stream partitioning at full width
# ---------------------------------------------------------------------------

DATAPATH_OP = {"int8": "ht", "bf16": "lp", "fp32": "fp"}


def partition_engines(dev) -> dict:
    """One engine per datapath from seeded params (QAT widths of the
    int8 "ht" and bf16 "lp" operating points; none for fp32)."""
    rng = np.random.default_rng(11)
    engines = {}
    for dp, op in DATAPATH_OP.items():
        spec = TenantSpec(f"part-{dp}", CFG,
                          params=np_params(rng, FORMATS.get(op)),
                          bn_state=np_bn_state(rng))
        engines[dp] = spec.build_engine(dev)
        require(engines[dp].backend == BACKEND_OF[dp],
                f"[11] {dp}: deployed {engines[dp].backend}")
    return engines


def engine_plain(e):
    """The plain PyTorch version (`ref.py`) of an engine's kernel, on the
    engine's own kernel weights, strides and int8 formats."""
    strides = eq.layer_strides(e.cfg)
    w = e._layer_weights()
    if e.backend == "fused_int8":
        return lambda x: R.cnn_eq_int8(x, w, strides, e.formats)
    plain = {"fused_fp32": R.cnn_eq, "fused_bf16": R.cnn_eq_bf16}
    return lambda x: plain[e.backend](x, w, strides)


def check_split_chunks(engines: dict, x, n_inst: int, ys: dict) -> dict:
    """On the split's own chunks — the strided view whose rows overlap,
    which the wrapper hands to the kernel with no copy — each engine's
    kernel == its plain version bitwise, and the merge of that output ==
    the partitioned output. Returns the view's shape and row stride."""
    o_act = SP.actual_overlap(CFG, n_inst)
    chunks = SP.split_with_overlap(x, n_inst, o_act, CFG.n_os)
    require(chunks.stride(0) < chunks.shape[1] and chunks.stride(1) == 1,
            f"[11] N_i = {n_inst}: chunks {tuple(chunks.shape)} with "
            f"strides {chunks.stride()} do not overlap")
    for dp, e in engines.items():
        got, want = e(chunks), engine_plain(e)(chunks)
        require(got.shape == want.shape and torch.equal(got, want),
                f"[11] {dp}, N_i = {n_inst}: kernel != plain on the "
                f"overlapping chunks {tuple(chunks.shape)} (max |diff| "
                f"{float((got - want).abs().max()):.3e})")
        require(torch.equal(SP.merge_with_overlap_removal(got, o_act),
                            ys[dp]),
                f"[11] {dp}, N_i = {n_inst}: merged kernel output != "
                f"partitioned output")
    return {"shape": list(chunks.shape), "row_stride": chunks.stride(0),
            "kernel_vs_plain": "bitwise"}


def check_partitioned(dev) -> dict:
    """`partitioned_apply` over N_i instances on one PART_SYMS stream, per
    datapath: the merged interior (every chunk border included) equals the
    unsplit engine bitwise, each call one register-blocked launch, and
    the kernel == plain bitwise on the split's chunks; ℓ_inst
    on the granularity of `seqlen_opt` and at least the length its
    framework asks for the paper's throughput target. Returns the checks,
    the N_i = 64 launch counts (zeroed just before) and the engines."""
    engines = partition_engines(dev)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(waveform(rng, PART_SYMS)).to(dev)
    o_sym = SP.overlap_symbols(CFG)
    hw = TM.fpga_profile(CFG, f_clk=HT.F_CLK)
    t_share = HT.T_REQ_SAMPLES / TM.max_throughput(hw, HT.N_INSTANCES)
    full = {dp: e(x) for dp, e in engines.items()}
    out = {"syms": PART_SYMS, "samples": int(x.shape[0]), "o_sym": o_sym,
           "instances": {}}
    launches = instances = None
    for n_inst in PART_INSTANCES:
        l_inst = SP.chunk_lengths(PART_SYMS, n_inst)
        gran = seqlen_opt.granularity(CFG, n_inst)
        want_l = seqlen_opt.optimal_l_inst(
            CFG, hw, n_inst, t_share * TM.max_throughput(hw, n_inst))
        require(l_inst % gran == 0 and l_inst >= want_l,
                f"[11] N_i = {n_inst}: l_inst {l_inst} off granularity "
                f"{gran} or below the framework's {want_l}")
        K.reset_launch_counts()
        ys = {dp: SP.partitioned_apply(e, x, n_inst, CFG)
              for dp, e in engines.items()}
        torch.cuda.synchronize(dev)
        launches, instances = dict(K.LAUNCHES), dict(K.INSTANCE_LAUNCHES)
        for dp, (name, _) in KERNELS.items():
            require(launches[name] == 1,
                    f"[11] {dp}: {launches[name]} launches for one "
                    f"partitioned call")
        require_instances(launches, instances, f"[11] N_i = {n_inst}")
        for dp, y in ys.items():
            require(y.shape == full[dp].shape == (PART_SYMS,)
                    and bool(torch.isfinite(y).all()),
                    f"[11] {dp}: partitioned {tuple(y.shape)} or "
                    f"non-finite")
            require(torch.equal(y[o_sym:-o_sym], full[dp][o_sym:-o_sym]),
                    f"[11] {dp}, N_i = {n_inst}: partitioned interior != "
                    f"unsplit (max |diff| "
                    f"{float((y - full[dp])[o_sym:-o_sym].abs().max()):.3e})")
        chunks = check_split_chunks(engines, x, n_inst, ys)
        out["instances"][n_inst] = {
            "l_inst": l_inst, "o_act": SP.actual_overlap(CFG, n_inst),
            "granularity": gran, "optimal_l_inst": want_l,
            "chunk_samples": (l_inst + 2 * SP.actual_overlap(CFG, n_inst))
            * CFG.n_os, "interior": "bitwise", "chunks": chunks}
    return {"checks": out, "launches": launches, "instances": instances,
            "engines": engines, "x": x}


def time_partitioned(part: dict, iters: int) -> dict:
    """Per datapath: CUDA-event ms of the N_i = 64 partitioned call and of
    the unsplit engine on the same stream, symbols/s of the partitioned
    call, and its kernel's device ms from torch.profiler."""
    x, out = part["x"], {}
    n_inst = HT.N_INSTANCES
    for dp, e in part["engines"].items():
        ms = cuda_ms(lambda: SP.partitioned_apply(e, x, n_inst, CFG), iters)
        out[dp] = {"ms": ms, "syms_per_s": PART_SYMS / (ms / 1e3),
                   "unsplit_ms": cuda_ms(lambda: e(x), iters),
                   "kernel_device_ms": _device_ms(
                       lambda: SP.partitioned_apply(e, x, n_inst, CFG),
                       "cnn_eq_kernel_rb")}
    return out


# ---------------------------------------------------------------------------
# phase 12: threaded serving, with link estimation and SLO rules
# ---------------------------------------------------------------------------

def slice_traffic(specs, waves) -> dict:
    """Each tenant's waveform in jittered ~1024-symbol chunks
    (`serve.loadgen.chop`, seeded per tenant)."""
    return {s.tenant_id: loadgen.chop(waves[s.tenant_id], 1024 * CFG.n_os,
                                      seed=i, jitter=0.5)
            for i, s in enumerate(specs)}


def serve_threaded(dev, specs, streams, runtime: str,
                   fault_plan=None, traced: bool = False) -> dict:
    """One `loadgen.replay` of the tenants through ServeRuntime ("sync")
    or AsyncServeRuntime ("async"), each with a LinkMonitor and an
    SloEngine attached; launch counts zeroed just before the replay and
    read just after. The async runtime's batcher records the current
    stream of every execute. With ``traced``, the replay alone (the
    tenants are opened before) runs under `device_trace`."""
    obs = Observability()
    slo = SloEngine(obs, rules=(SloRule(
        "snr_floor", "link.{tenant}.snr_db", threshold=SLO_SNR_FLOOR_DB,
        patience=3),))
    link = LinkMonitor(obs, slo=slo)
    policy = BatchPolicy(max_batch=4)
    streams_seen = set()
    if runtime == "sync":
        rt = ServeRuntime(policy, device=dev, obs=obs, link=link,
                          fault_plan=fault_plan)
    else:
        rt = AsyncServeRuntime(policy, device=dev, obs=obs, link=link,
                               launch_retries=2, fault_plan=fault_plan)
        execute = rt.batcher.execute

        def recording_execute(batch):
            streams_seen.add(torch.cuda.current_stream(dev).cuda_stream)
            return execute(batch)
        rt.batcher.execute = recording_execute
    try:
        for s in specs:
            rt.open(s)
        K.reset_launch_counts()
        box = {}
        trace = (device_trace(lambda: box.update(
            acct=loadgen.replay(rt, streams))) if traced else None)
        acct = box["acct"] if traced else loadgen.replay(rt, streams)
        launches, instances = dict(K.LAUNCHES), dict(K.INSTANCE_LAUNCHES)
        st = rt.stats()
        outs = {s.tenant_id: rt.close(s.tenant_id) for s in specs}
    finally:
        if runtime == "async":
            rt.shutdown()
    return {"outs": outs, "acct": acct, "stats": st, "launches": launches,
            "instances": instances, "link": {
                s.tenant_id: link.estimate(s.tenant_id) for s in specs},
            "slo_breached": slo.breached_tenants(), "obs": obs,
            "streams_seen": streams_seen,
            "own_stream": (rt.stream.cuda_stream if runtime == "async"
                           else None),
            "recovery": st.get("recovery"), "trace": trace}


def check_threaded(dev, specs, waves) -> dict:
    """Sync and async replays of the same traffic, then an async replay
    under a FaultPlan (a transient launch failure and a corrupted output):
    every async stream == the sync stream == its offline engine bitwise,
    every launch rb and, in the async runs, on the runtime's stream; link
    estimates finite and equal between the runtimes; the report has its
    serve, link and slo sections."""
    streams = slice_traffic(specs, waves)
    runs = {"sync": serve_threaded(dev, specs, streams, "sync"),
            "async": serve_threaded(dev, specs, streams, "async")}
    fault_plan = FaultPlan([Fault("launch_error", 3),
                            Fault("corrupt", 7, mode="nan")])
    runs["async_faults"] = serve_threaded(dev, specs, streams, "async",
                                          fault_plan=fault_plan)
    require(fault_plan.pending == 0,
            f"[12] faults not fired: {fault_plan.summary()}")
    rec = runs["async_faults"]["recovery"]
    require(rec["sessions_poisoned"] == 0 and rec["corrupt_detected"] >= 1
            and rec["chunks_replayed"] >= 1,
            f"[12] fault run recovery {rec}")
    n_checked = check_offline(dev, specs, waves, runs["sync"]["outs"], SYMS)
    for name, run in runs.items():
        require(run["acct"]["total_syms"] == n_checked,
                f"[12] {name}: {run['acct']['total_syms']} symbols served, "
                f"{n_checked} expected")
        require_instances(run["launches"], run["instances"], f"[12] {name}")
        for tid, out in run["outs"].items():
            require(np.array_equal(out, runs["sync"]["outs"][tid]),
                    f"[12] {name} {tid}: stream != sync stream")
        for tid, est in run["link"].items():
            vals = dataclasses.asdict(est)
            require(est.syms == run["outs"][tid].shape[0]
                    and all(np.isfinite(v) for k, v in vals.items()
                            if k != "tenant_id"),
                    f"[12] {name} {tid}: link estimate {est}")
            require(est == runs["sync"]["link"][tid],
                    f"[12] {name} {tid}: link estimate {est} != sync "
                    f"{runs['sync']['link'][tid]}")
        if name != "sync":
            require(run["streams_seen"] == {run["own_stream"]}
                    and run["own_stream"] != torch.cuda.default_stream(
                        dev).cuda_stream,
                    f"[12] {name}: executes on streams "
                    f"{run['streams_seen']}, the runtime's is "
                    f"{run['own_stream']}")
        text = OBS_report.render(run["obs"].snapshot())
        require(all(sec in text for sec in ("[serve]", "[link]", "[slo]")),
                f"[12] {name}: report lacks a section:\n{text}")
    return runs


# ---------------------------------------------------------------------------
# phase 13: the packetized wire, its control plane and drift traffic
# ---------------------------------------------------------------------------

def wire_pair(seed: int, drop_idx=()):
    """(client end, server end) of an impaired loopback: reorder window 6
    and duplicates 0.2 each way (with drops, FIFO and one-way instead)."""
    if drop_idx:
        return net.loopback_pair(net.WireSchedule(seed, drop_idx=drop_idx))
    sch = dict(reorder_window=WIRE_REORDER, dup_prob=WIRE_DUP)
    return net.loopback_pair(net.WireSchedule(seed, **sch),
                             net.WireSchedule(seed + 1, **sch))


def wire_tenants(specs, waves):
    """[12]'s tenants plus a twin of the first int8 tenant on an fp32 wire;
    each tenant's wire type (int8 tenants on their engine's int8 grid, the
    first bf16 tenant on a BF16 wire, the rest fp32) and the waveform its
    offline engine must see (a BF16 wire rounds the samples)."""
    first = specs[0]
    twin = dataclasses.replace(first, tenant_id=f"{first.tenant_id}-fp32")
    specs = list(specs) + [twin]
    wire = {s.tenant_id: (net.WireDtype.INT8 if s.tenant_id.startswith("ht")
                          else net.WireDtype.FP32) for s in specs}
    wire[twin.tenant_id] = net.WireDtype.FP32
    wire["lp-0"] = net.WireDtype.BF16
    seen = {}
    for s in specs:
        w = waves[first.tenant_id if s is twin else s.tenant_id]
        if wire[s.tenant_id] == net.WireDtype.BF16:
            w = net.decode_samples(net.encode_samples(w, net.WireDtype.BF16),
                                   net.WireDtype.BF16)
        seen[s.tenant_id] = w
    return specs, wire, seen, twin.tenant_id


def serve_wire(dev, specs, streams, wire, runtime: str, seed: int) -> dict:
    """One `loadgen.replay_wire` (burst 4) of the streams: NetClient →
    impaired loopback → NetGateway → ServeRuntime ("sync") or
    AsyncServeRuntime ("async"); launch counts zeroed just before the
    replay and read just after."""
    obs = Observability()
    policy = BatchPolicy(max_batch=4)
    rt = (ServeRuntime(policy, device=dev, obs=obs) if runtime == "sync"
          else AsyncServeRuntime(policy, device=dev, obs=obs))
    try:
        cli_t, srv_t = wire_pair(seed)
        gw, client = net.NetGateway(rt, srv_t), net.NetClient(cli_t)
        for s in specs:
            sess = rt.open(s)
            gw.open_wire(s.tenant_id)
            client.attach(s.tenant_id, wire[s.tenant_id],
                          grid=net.wire_grid(sess.engine))
        K.reset_launch_counts()
        acct = loadgen.replay_wire(gw, client, streams, burst=4)
        launches, instances = dict(K.LAUNCHES), dict(K.INSTANCE_LAUNCHES)
        st = rt.stats()
    finally:
        if runtime == "async":
            rt.shutdown()
    return {"syms": {s.tenant_id: client.symbols(s.tenant_id)
                     for s in specs},
            "acct": acct, "stats": st, "net": obs.snapshot()["net"],
            "launches": launches, "instances": instances, "obs": obs}


def check_wire(dev, specs, waves) -> dict:
    """[12]'s tenants over the impaired wire through both runtimes: every
    tenant's egress symbols == its offline engine bitwise; the int8 tenant
    on an int8 wire == its twin on an fp32 wire (contract #12); no wire
    error, and the impairment fired (duplicates and reordering); every
    datapath launched, every launch rb."""
    specs, wire, seen, twin = wire_tenants(specs, waves)
    want = {s.tenant_id: s.build_engine(dev)(seen[s.tenant_id]).cpu().numpy()
            for s in specs}
    streams = slice_traffic(specs, {s.tenant_id: seen[s.tenant_id]
                                    for s in specs})
    runs = {rt: serve_wire(dev, specs, streams, wire, rt, seed=91)
            for rt in ("sync", "async")}
    # the same chunks through `loadgen.replay`, no wire and no telemetry:
    # what the wire's host work costs, in the same call
    rt = ServeRuntime(BatchPolicy(max_batch=4), device=dev)
    for s in specs:
        rt.open(s)
    no_wire = {"acct": loadgen.replay(rt, streams), "stats": rt.stats()}
    require(no_wire["acct"]["total_syms"] == runs["sync"]["acct"][
        "total_syms"], f"[13] no-wire replay {no_wire['acct']}")
    for name, run in runs.items():
        c = run["net"]
        require(not run["acct"]["errors"],
                f"[13] {name}: wire errors {run['acct']['errors']}")
        require(c["duplicates"] > 0 and c["reordered"] > 0
                and c["gaps"] == 0 and c["crc_errors"] == 0,
                f"[13] {name}: wire counters {c}")
        for s in specs:
            tid = s.tenant_id
            got = run["syms"][tid]
            require(got.shape == want[tid].shape
                    and np.array_equal(got, want[tid]),
                    f"[13] {name} {tid} ({wire[tid].name} wire): egress "
                    f"symbols != offline")
        require(np.array_equal(run["syms"][specs[0].tenant_id],
                               run["syms"][twin]),
                f"[13] {name}: int8 wire != fp32 wire for "
                f"{specs[0].tenant_id}")
        require(all(run["launches"][n] > 0 for n, _ in KERNELS.values()),
                f"[13] {name}: launches {run['launches']}")
        require_instances(run["launches"], run["instances"], f"[13] {name}")
        text = OBS_report.render(run["obs"].snapshot())
        require("[net]" in text, f"[13] {name}: report lacks [net]:\n{text}")
    return {"runs": runs, "no_wire": no_wire,
            "wire": {t: w.name for t, w in wire.items()}}


def check_control(dev, specs, waves) -> dict:
    """One int8 tenant over the wire: OPEN → DATA → SWAP_WEIGHTS → DATA →
    ROLLBACK → DATA → EOS → CLOSE; the spliced stream == each weight
    epoch's offline engine on its segment, bitwise. Then a frame dropped
    on one of three tenants: a stream_gap and a NACK for that tenant only,
    the other two bitwise."""
    rng = np.random.default_rng(13)
    fmts = tuple(tuple(FORMATS["ht"][k] for k in ("w_int", "w_frac",
                                                  "a_int", "a_frac"))
                 for _ in range(CFG.layers))
    w_old, w_new = [tuple((w.numpy(), b.numpy()) for w, b in
                          host_folded(rng)) for _ in range(2)]
    wave = waveform(rng, SYMS)
    chunks = loadgen.chop(wave, 1024 * CFG.n_os, seed=13)
    rt = ServeRuntime(BatchPolicy(max_batch=4), device=dev)
    cli_t, srv_t = wire_pair(71)
    gw, client = net.NetGateway(rt, srv_t), net.NetClient(cli_t)
    ack = client.open("ctl", CFG, w_old, formats=fmts, backend="fused_int8",
                      pump=gw.step)
    require(ack["backend"] == "fused_int8"
            and ack["wire_dtype"] == int(net.WireDtype.INT8)
            and (ack["a_int"], ack["a_frac"]) == fmts[0][2:],
            f"[13b] open ack {ack}")
    def send(part):
        for c in part:
            client.send_samples("ctl", c)
        gw.settle()
        client.poll(max_datagrams=256)

    third = len(chunks) // 3
    send(chunks[:third])
    epochs = [client.swap_weights("ctl", w_new, pump=gw.step)["epoch"]]
    send(chunks[third:2 * third])
    epochs.append(client.rollback_weights("ctl", pump=gw.step)["epoch"])
    for c in chunks[2 * third:]:
        client.send_samples("ctl", c)
    client.finish("ctl")
    acct = loadgen.replay_wire(gw, client, {"ctl": []})
    require(not acct["errors"] and epochs == [1, 2],
            f"[13b] errors {acct['errors']}, epochs {epochs}")
    log = rt.sessions.get("ctl").swap_log
    (_, p0), (_, p1), (_, p2) = log
    require(p0 == 0 < p1 < p2, f"[13b] swap log {log}")

    def offline(w):
        return TenantSpec("x", CFG, weights=w, formats=fmts,
                          backend="fused_int8").build_engine(dev)(
            wave).cpu().numpy()
    old, new = offline(w_old), offline(w_new)
    vp = CFG.v_parallel
    want = np.concatenate([old[:p1 * vp], new[p1 * vp:p2 * vp],
                           old[p2 * vp:]])
    got = client.symbols("ctl")
    require(got.shape == want.shape and np.array_equal(got, want),
            "[13b] spliced stream != offline per weight epoch")
    n_spliced = int(want.shape[0])
    closed = client.close("ctl", pump=gw.step)
    require(closed["syms_emitted"] == n_spliced and "ctl" not in
            rt.sessions, f"[13b] close ack {closed}")
    commands = rt.obs.snapshot()["net"]["ctrl_commands"]

    # a drop on one tenant: datagram 3 is tenant 0's second frame (burst 1,
    # three tenants round-robin on a FIFO wire)
    trio = [specs[1], specs[5], specs[8]]
    rt = ServeRuntime(BatchPolicy(max_batch=4), device=dev)
    cli_t, srv_t = wire_pair(72, drop_idx=(3,))
    gw = net.NetGateway(rt, srv_t, reorder_window=2)
    client = net.NetClient(cli_t)
    for s in trio:
        sess = rt.open(s)
        gw.open_wire(s.tenant_id)
        client.attach(s.tenant_id, net.WireDtype.INT8 if s.tenant_id
                      .startswith("ht") else net.WireDtype.FP32,
                      grid=net.wire_grid(sess.engine))
    streams = slice_traffic(trio, waves)
    acct = loadgen.replay_wire(gw, client, streams, burst=1)
    lossy = trio[0].tenant_id
    require(set(acct["errors"]) == {lossy}
            and "stream_gap" in acct["errors"][lossy]
            and any("stream_gap" in e for e in client.errors(lossy))
            and rt.obs.snapshot()["net"]["gaps"] == 1,
            f"[13b] drop: errors {acct['errors']}, NACKs "
            f"{client.errors(lossy)}")
    for s in trio[1:]:
        tid = s.tenant_id
        want = s.build_engine(dev)(waves[tid]).cpu().numpy()
        require(not client.errors(tid) and gw.ingress.error(tid) is None
                and np.array_equal(client.symbols(tid), want),
                f"[13b] drop: {tid} errors {client.errors(tid)} or != "
                f"offline")
    return {"epochs": [list(e) for e in log], "syms": n_spliced,
            "ctrl_commands": commands, "drop_error": acct["errors"][lossy],
            "nacks": client.errors(lossy),
            "intact": [s.tenant_id for s in trio[1:]]}


def check_drift(dev, specs) -> dict:
    """drift_streams on the card for both drifting channels
    (DRIFT_TENANTS tenants, DRIFT_BURSTS bursts of SYMS symbols,
    DriftSchedule(8, 8)): at t = 0 each burst == the stationary simulator
    on the same generator within DRIFT_ATOL, pilots equal; a second draw
    repeats bitwise and is timed. Then the IM/DD tenant 0's whole drift
    stream, served by an int8 engine over the int8 wire == offline."""
    sch = DriftSchedule(8, 8)
    ids = [f"d{i}" for i in range(DRIFT_TENANTS)]
    out, streams = {}, {}
    for name, ch, sim in (("proakis", DriftingProakis(), proakis.simulate),
                          ("imdd", DriftingIMDD(), imdd.simulate)):
        streams[name], pilots = loadgen.drift_streams(
            ch, sch, ids, DRIFT_BURSTS, SYMS, seed=23, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        again, _ = loadgen.drift_streams(ch, sch, ids, DRIFT_BURSTS, SYMS,
                                         seed=23, device=dev)
        draw_s = time.perf_counter() - t0
        worst = 0.0
        for i, tid in enumerate(ids):
            for b in range(DRIFT_BURSTS):
                rx = streams[name][tid][b]
                require(rx.shape == (SYMS * CFG.n_os,)
                        and bool(np.isfinite(rx).all())
                        and np.array_equal(rx, again[tid][b]),
                        f"[13c] {name} {tid} burst {b}: shape, finiteness "
                        f"or repeat")
                if sch.t_at(b) > 0.0:
                    continue
                want, syms = sim(loadgen._burst_generator(23, b, i, dev),
                                 ch.cfg, SYMS, device=dev)
                err = float(np.max(np.abs(rx - want.cpu().numpy())))
                worst = max(worst, err)
                require(err <= DRIFT_ATOL and np.array_equal(
                    pilots[tid][b], syms.cpu().numpy()),
                    f"[13c] {name} {tid} burst {b}: t = 0 vs stationary "
                    f"max |diff| {err:.3e}")
        out[name] = {"t0_vs_stationary_max_abs": worst,
                     "draw_ms_per_burst": draw_s / DRIFT_BURSTS * 1e3}
    spec = dataclasses.replace(specs[0], tenant_id="drift-imdd")
    wave = np.concatenate(streams["imdd"][ids[0]])
    run = serve_wire(dev, [spec], {spec.tenant_id: loadgen.chop(
        wave, 1024 * CFG.n_os, seed=5)}, {spec.tenant_id: net.WireDtype.INT8},
        "sync", seed=93)
    want = spec.build_engine(dev)(wave).cpu().numpy()
    require(not run["acct"]["errors"]
            and np.array_equal(run["syms"][spec.tenant_id], want),
            "[13c] the drift stream over the wire != offline")
    out["served"] = {"tenant": spec.tenant_id, "syms": int(want.shape[0]),
                     "agg_syms_per_s": run["acct"]["agg_syms_per_s"]}
    return out


# ---------------------------------------------------------------------------
# phase 14: online adaptation, closing the drift loop
# ---------------------------------------------------------------------------

def record_epochs(sess) -> dict:
    """weight epoch → the spec the session installed for it (epoch 0: the
    spec it opened with), recorded as swaps and rollbacks install them."""
    specs = {sess.spec.weight_epoch: sess.spec}
    install = sess.install_spec

    def recording(new_spec, prebuilt=None):
        epoch = install(new_spec, prebuilt=prebuilt)
        specs[epoch] = new_spec
        return epoch
    sess.install_spec = recording
    return specs


def check_epochs(dev, sess, specs: dict, wave: np.ndarray,
                 got: np.ndarray, where: str) -> list:
    """The stream over each epoch's positions in `swap_log` == that
    epoch's spec's offline engine on the same samples, bitwise."""
    vp = sess.v_parallel
    log = sess.swap_log
    require(log[0][1] == 0 and [e for e, _ in log] == sorted(
        e for e, _ in log) and all(a[1] <= b[1] for a, b in
                                   zip(log, log[1:])),
            f"{where}: swap log {log}")
    bounds = [p * vp for _, p in log] + [got.shape[0]]
    for (epoch, _), a, b in zip(log, bounds, bounds[1:]):
        want = specs[epoch].build_engine(dev)(wave).cpu().numpy()
        require(want.shape == got.shape and np.array_equal(got[a:b],
                                                           want[a:b]),
                f"{where}: epoch {epoch} positions [{a}, {b}) != its "
                f"offline engine")
    return [list(e) for e in log]


def timed_steps(adapter) -> list:
    """Wrap `adapter.step` to record each call's wall seconds and actions."""
    cycles = []
    step = adapter.step

    def timed(tenant_id=None):
        t0 = time.perf_counter()
        out = step(tenant_id)
        cycles.append({"s": time.perf_counter() - t0,
                       "actions": [r.action for r in out]})
        return out
    adapter.step = timed
    return cycles


def train_base(dev, ch, t: float, seed: int) -> tuple:
    """A CNN trained on the drifting channel frozen at ``t`` (the
    reference's 600-step `trained_base`); returns (params, bn, info,
    wall seconds)."""
    t0 = time.perf_counter()
    params, bn, info = train_eq.train_equalizer(
        torch.Generator().manual_seed(seed), "cnn", ADAPT_CFG,
        ch.at(t, device=dev),
        train_eq.EqTrainConfig(steps=ADAPT_BASE_STEPS, eval_syms=1 << 14),
        device=dev)
    return params, bn, info, time.perf_counter() - t0


def adapt_spec(tid: str, params, bn) -> TenantSpec:
    return TenantSpec(tid, ADAPT_CFG, params=params, bn_state=bn,
                      backend="fused_fp32", tile_m=16)


def check_adapt(dev) -> dict:
    """[14]: a frozen and an adaptive tenant from one base on
    `ServeRuntime(device=dev)`, replayed through the drift by
    `replay_adaptive(step_every=2)`; at least one promotion, the
    recovery criterion at t = 1 against a fresh 600-step equalizer, the
    adaptive stream bitwise per epoch, every launch rb."""
    ch = DriftingProakis()
    params, bn, info, base_s = train_base(dev, ch, 0.0, seed=0)
    ber0 = info["ber"]
    rt = ServeRuntime(BatchPolicy(max_batch=2, max_wait_s=1e9), device=dev)
    adapter = OnlineAdapter(rt, ADAPT_POLICY, ADAPT_FT)
    rt.open(adapt_spec("frozen", params, bn))
    sess = adapter.attach(adapt_spec("adaptive", params, bn))
    epochs = record_epochs(sess)
    sched = DriftSchedule(hold_bursts=4, ramp_bursts=6)
    streams, pilots = loadgen.drift_streams(
        ch, sched, ["frozen", "adaptive"], n_bursts=ADAPT_BURSTS,
        syms_per_burst=ADAPT_BURST_SYMS, seed=3, device=dev)
    cycles = timed_steps(adapter)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    acct = loadgen.replay_adaptive(rt, streams, pilots=pilots,
                                   adapter=adapter, step_every=2)
    replay_s = time.perf_counter() - t0
    launches, instances = dict(K.LAUNCHES), dict(K.INSTANCE_LAUNCHES)
    require_instances(launches, instances, "[14]")
    require(launches[KERNELS["fp32"][0]] > 0, f"[14] launches {launches}")
    history = adapter.history
    promoted = [r for r in history if r.action == "promoted"]
    require(bool(promoted) and sess.weight_epoch >= 1
            and len(sess.swap_log) >= 2,
            f"[14] no promotion: {[r.action for r in history]}")
    wave = np.concatenate(streams["adaptive"])
    log = check_epochs(dev, sess, epochs, wave, rt.output("adaptive"),
                       "[14]")

    rx1, sy1 = ch.at(1.0, device=dev)(
        torch.Generator(device=dev).manual_seed(77), 1 << 14)
    rx1, sy1 = rx1.cpu().numpy(), sy1.cpu().numpy()
    params_f, bn_f, _, fresh_s = train_base(dev, ch, 1.0, seed=1)
    ber_frozen = engine_ber(rt.sessions.get("frozen").engine, rx1, sy1)
    ber_adapt = engine_ber(sess.engine, rx1, sy1)
    ber_fresh = engine_ber(adapt_spec("fresh", params_f, bn_f)
                           .build_engine(dev), rx1, sy1)
    crit = {"pre_drift": ber0, "frozen": ber_frozen, "adaptive": ber_adapt,
            "fresh": ber_fresh,
            "frozen_degraded": ber_frozen >= FROZEN_FACTOR * max(
                ber0, FROZEN_FLOOR),
            "adaptive_recovered": ber_adapt <= FRESH_FACTOR * max(
                ber_fresh, FRESH_FLOOR),
            "adaptive_vs_frozen": ber_adapt <= ber_frozen / 4.0}
    require(crit["frozen_degraded"] and crit["adaptive_recovered"]
            and crit["adaptive_vs_frozen"],
            f"[14] recovery criterion failed: {crit}")
    tuned = [r.train_info for r in history if r.train_info is not None]
    return {
        "criterion": crit, "actions": [r.action for r in history],
        "swap_log": log, "launches": launches,
        "ber_frozen": [round(b, 4) for b in burst_ber(
            rt.output("frozen"), pilots["frozen"])],
        "ber_adaptive": [round(b, 4) for b in burst_ber(
            rt.output("adaptive"), pilots["adaptive"])],
        "fine_tune_ms_per_step": [i["wall_s"] / i["steps"] * 1e3
                                  for i in tuned],
        "cycle_s": [c["s"] for c in cycles],
        "cycle_actions": [c["actions"] for c in cycles],
        "base_train_s": base_s, "fresh_train_s": fresh_s,
        "replay_s": replay_s, "agg_syms_per_s": acct["agg_syms_per_s"],
        "state": (params, bn, streams)}


def bg_streams(dev):
    """[14a]'s traffic: one tenant, 8 bursts of 1024 symbols through
    DriftSchedule(2, 3), seed 11."""
    return loadgen.drift_streams(DriftingProakis(), DriftSchedule(2, 3),
                                 ["bg"], n_bursts=8, syms_per_burst=1024,
                                 seed=11, device=dev)


def bg_spec() -> TenantSpec:
    """The background scenario's tenant: seeded random weights."""
    params = eq.init(torch.Generator().manual_seed(21), ADAPT_CFG,
                     device="cpu")
    return adapt_spec("bg", params, eq.init_bn_state(ADAPT_CFG, "cpu"))


def check_adapt_background(dev) -> dict:
    """[14a]: `OnlineAdapter.start()` against AsyncServeRuntime(device=dev)
    under live traffic: the stream complete, `swap_log` monotone, no
    adapter or runtime error, bitwise per epoch, every launch rb. The card
    serves a burst in about a millisecond, far inside one adapter cycle,
    so the producer waits (at most BG_PACE_S) for the thread's next cycle
    after each burst: the fine-tunes, and any swap, then run while the
    stream is live."""
    streams, pilots = bg_streams(dev)
    with AsyncServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                           device=dev) as rt:
        adapter = OnlineAdapter(rt, BG_POLICY, BG_FT)
        require(adapter.stream is not None,
                "[14a] the adapter has no CUDA stream")
        sess = adapter.attach(bg_spec())
        epochs = record_epochs(sess)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        adapter.start(interval_s=0.02)
        try:
            for chunk, labels in zip(streams["bg"], pilots["bg"]):
                adapter.feed_pilots("bg", labels)
                rt.submit("bg", chunk)
                seen, t_pace = len(adapter.history), time.perf_counter()
                while (len(adapter.history) == seen and time.perf_counter()
                       - t_pace < BG_PACE_S):
                    time.sleep(0.005)
            rt.finish("bg")
            rt.drain()
        finally:
            adapter.stop()
        wall = time.perf_counter() - t0
        launches, instances = dict(K.LAUNCHES), dict(K.INSTANCE_LAUNCHES)
        errors = (list(adapter.errors), list(rt.errors))
        out = rt.output("bg")
    require(bool(adapter.history) and errors == ([], []),
            f"[14a] history {len(adapter.history)}, errors {errors}")
    require(out.shape == (8 * 1024,), f"[14a] stream shape {out.shape}")
    require_instances(launches, instances, "[14a]")
    log = check_epochs(dev, sess, epochs, np.concatenate(streams["bg"]),
                       out, "[14a]")
    return {"cycles": len(adapter.history),
            "actions": [r.action for r in adapter.history],
            "swap_log": log, "launches": launches, "wall_s": wall}


def adapt_overhead(dev, state) -> dict:
    """bench_adapt's overhead ratio on one card: [14]'s drift streams
    replayed (`loadgen.replay`) through AsyncServeRuntime(device=dev)
    with and without a continuously busy fine-tune thread (back-to-back
    `fine_tune_from_buffer` rounds of [14]'s config, on its own CUDA
    stream); a warm-up pass per arm, then the best of 3 interleaved."""
    import threading
    params, bn, streams = state
    rx_buf, sy_buf = DriftingProakis().at(0.0, device=dev)(
        torch.Generator(device=dev).manual_seed(8), 1 << 14)
    rx_buf, sy_buf = rx_buf.cpu().numpy(), sy_buf.cpu().numpy()
    rounds = []

    def one_pass(busy: bool) -> float:
        stop = threading.Event()

        def trainer_loop():
            gen = torch.Generator(device=dev).manual_seed(0)
            with torch.cuda.stream(torch.cuda.Stream(device=dev)):
                while not stop.is_set():
                    fine_tune_from_buffer(gen, params, bn, ADAPT_CFG,
                                          rx_buf, sy_buf, ADAPT_FT,
                                          device=dev)
                    rounds.append(1)

        with AsyncServeRuntime(BatchPolicy(max_batch=2, max_wait_s=1e9),
                               device=dev) as rt:
            for tid in streams:
                rt.open(adapt_spec(tid, params, bn))
            th = threading.Thread(target=trainer_loop, daemon=True)
            if busy:
                th.start()
            try:
                rep = loadgen.replay(rt, streams)
            finally:
                stop.set()
                if busy:
                    th.join()
        return rep["agg_syms_per_s"]

    one_pass(False)
    one_pass(True)
    best = {False: 0.0, True: 0.0}
    for _ in range(3):
        for busy in (False, True):
            best[busy] = max(best[busy], one_pass(busy))
    return {"idle_syms_per_s": best[False], "busy_syms_per_s": best[True],
            "throughput_ratio": best[True] / best[False],
            "fine_tune_rounds": len(rounds)}


def check_adapt_determinism(dev) -> dict:
    """[14b]: [14a]'s sync twin (ServeRuntime, `replay_adaptive`) run
    twice: the same history and the same final weights, bitwise."""
    def run():
        streams, pilots = bg_streams(dev)
        rt = ServeRuntime(BatchPolicy(max_batch=1, max_wait_s=1e9),
                          device=dev)
        adapter = OnlineAdapter(rt, BG_POLICY, BG_FT)
        sess = adapter.attach(bg_spec())
        loadgen.replay_adaptive(rt, streams, pilots=pilots, adapter=adapter)
        hist = [(r.action, r.weight_epoch, repr(r.shadow),
                 None if r.train_info is None else
                 (r.train_info["loss_first"], r.train_info["loss_last"]))
                for r in adapter.history]
        return hist, interop.to_numpy(sess.spec.params), rt.output("bg")

    (h1, p1, o1), (h2, p2, o2) = run(), run()
    require(h1 == h2, f"[14b] histories differ:\n{h1}\n{h2}")
    require(any(h[3] is not None for h in h1), "[14b] no fine-tune ran")
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        require(np.array_equal(a, b), "[14b] final weights differ")
    require(np.array_equal(o1, o2), "[14b] outputs differ")
    return {"cycles": len(h1), "fine_tunes": sum(h[3] is not None
                                                 for h in h1),
            "actions": [h[0] for h in h1], "final_epoch": h1[-1][1]}


# ---------------------------------------------------------------------------
# phase 15: the fleet under device loss
# ---------------------------------------------------------------------------

def fleet_traffic(fleet_stats: dict) -> dict:
    """A stats dict in `check_serving_shapes`' form: per datapath, the
    traffic of the worker that launched it most."""
    traffic = {}
    for w in fleet_stats["workers"]:
        for key, tr in w["traffic"].items():
            if tr["launches"] > traffic.get(key, {"launches": -1})[
                    "launches"]:
                traffic[key] = tr
    return {"traffic": traffic}


def check_fleet(dev, specs, waves) -> dict:
    """[15]: [4]'s tenants in [12]'s chunks through FleetRuntime(n_workers
    = 2, both workers on the card), worker 1 lost mid-stream
    (`device_lost`): every stream == its offline engine bitwise (every
    chunk once), 0 sessions poisoned, >= 1 migration in the `fleet.*`
    snapshot, every launch rb."""
    streams = slice_traffic(specs, waves)
    fp = FaultPlan([Fault("device_lost", at=1, after=FLEET_KILL_AFTER)])
    with FleetRuntime(n_workers=2, policy=BatchPolicy(max_batch=4),
                      fault_plan=fp) as rt:
        require([w.device for w in rt.workers] == [dev, dev]
                and all(w.stream is not None for w in rt.workers),
                f"[15] workers on {[str(w.device) for w in rt.workers]}")
        for s in specs:
            rt.open(s)
        placed = dict(rt.stats()["placement"])
        K.reset_launch_counts()
        acct = loadgen.replay(rt, streams)
        launches, instances = dict(K.LAUNCHES), dict(K.INSTANCE_LAUNCHES)
        st = rt.stats()
        snap = rt.obs.snapshot()["fleet"]
        lat = {w.idx: w.batcher.latency_stats() for w in rt.workers}
        lat_all = np.array([r.latency_s for w in rt.workers
                            for r in w.batcher.completed])
        per_worker = {w.idx: w.batcher.launches for w in rt.workers}
        outs = {s.tenant_id: rt.close(s.tenant_id) for s in specs}
    require(fp.fired == [("device_lost", 1)], f"[15] fired {fp.fired}")
    n = check_offline(dev, specs, waves, outs, SYMS)
    require(acct["total_syms"] == n, f"[15] {acct['total_syms']} of {n}")
    rec = st["recovery"]
    require(rec["sessions_poisoned"] == 0 and snap["migrations"] >= 1
            and rec["sessions_migrated_in"] >= 1,
            f"[15] recovery {rec}, migrations {snap['migrations']}")
    require_instances(launches, instances, "[15]")
    require(all(launches[name] > 0 for name, _ in KERNELS.values()),
            f"[15] launches {launches}")
    return {"placement_before": placed, "placement_after": st["placement"],
            "migrations": snap["migrations"], "recovery": {
                k: v for k, v in rec.items() if v}, "launches": launches,
            "launches_per_worker": per_worker,
            "agg_syms_per_s": acct["agg_syms_per_s"],
            "elapsed_s": acct["elapsed_s"],
            "p50_latency_ms": float(np.percentile(lat_all, 50) * 1e3),
            "p99_latency_ms": float(np.percentile(lat_all, 99) * 1e3),
            "latency_ms": {i: {k: l[k] for k in ("p50_latency_ms",
                                                  "p99_latency_ms")
                               if k in l} for i, l in lat.items()},
            "stats": fleet_traffic(st)}


def check_fleet_slow(dev, specs, waves) -> dict:
    """[15b]: `device_slow` on worker 0 feeds its heartbeat and the
    worker survives; the stream bitwise."""
    spec = specs[-1]
    fp = FaultPlan([Fault("device_slow", at=0, after=1, delay_s=0.05)])
    with FleetRuntime(n_workers=2, policy=BatchPolicy(max_batch=4),
                      fault_plan=fp) as rt:
        rt.open(spec)
        for c in slice_traffic([spec], waves)[spec.tenant_id]:
            rt.submit(spec.tenant_id, c)
        got = rt.close(spec.tenant_id)
        st = rt.stats()
    want = spec.build_engine(dev)(waves[spec.tenant_id]).cpu().numpy()
    w0 = st["workers"][0]
    require(fp.fired == [("device_slow", 0)] and w0["alive"]
            and st["recovery"]["device_losses"] == 0
            and np.array_equal(got, want),
            f"[15b] fired {fp.fired}, worker 0 {w0['alive']}, recovery "
            f"{st['recovery']}")
    return {"fired": fp.fired, "worker0_alive": w0["alive"],
            "worker0_health": w0["health"]}


def check_fleet_wire(dev) -> dict:
    """[15c]: [13]'s impaired loopback over a 2-worker fleet with
    test_wire_fleet_runtime_bitwise's two tenants (fp32 and int8, seeded
    weights): egress == offline bitwise, no wire error."""
    rng = np.random.default_rng(112)
    fmts = tuple(tuple(FORMATS["ht"][k] for k in ("w_int", "w_frac",
                                                  "a_int", "a_frac"))
                 for _ in range(CFG.layers))
    specs = [TenantSpec("w0", CFG, weights=host_folded(rng),
                        backend="fused_fp32"),
             TenantSpec("w1", CFG, weights=host_folded(rng), formats=fmts,
                        backend="fused_int8")]
    waves = {s.tenant_id: waveform(rng, 2048) for s in specs}
    with FleetRuntime(n_workers=2, policy=BatchPolicy(max_batch=2,
                                                      max_wait_s=2e-3)) as rt:
        cli_t, srv_t = wire_pair(95)
        gw, client = net.NetGateway(rt, srv_t), net.NetClient(cli_t)
        for s in specs:
            sess = rt.open(s)
            gw.open_wire(s.tenant_id)
            client.attach(s.tenant_id, net.WireDtype.INT8
                          if s.backend == "fused_int8" else
                          net.WireDtype.FP32, grid=net.wire_grid(sess.engine))
        K.reset_launch_counts()
        acct = loadgen.replay_wire(gw, client, slice_traffic(specs, waves),
                                   burst=4)
        launches, instances = dict(K.LAUNCHES), dict(K.INSTANCE_LAUNCHES)
        counters = rt.obs.snapshot()["net"]
    require(not acct["errors"], f"[15c] wire errors {acct['errors']}")
    require_instances(launches, instances, "[15c]")
    for s in specs:
        want = s.build_engine(dev)(waves[s.tenant_id]).cpu().numpy()
        require(np.array_equal(client.symbols(s.tenant_id), want),
                f"[15c] {s.tenant_id}: egress != offline")
    return {"agg_syms_per_s": acct["agg_syms_per_s"],
            "duplicates": counters["duplicates"],
            "reordered": counters["reordered"], "launches": launches}


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------
# phase 16: the parallel layer over ranks on the card
# ---------------------------------------------------------------------------

def engine_recipe(e) -> tuple:
    """What a rank needs to rebuild engine ``e`` bit for bit: (backend,
    host folded weights, int8 formats, tile_m)."""
    return (e.backend, tuple((w.cpu().numpy(), b.cpu().numpy())
                             for w, b in e.weights),
            e.formats if e.backend == "fused_int8" else None,
            e.resolved_tile_m())


def comp_shapes(dev) -> list:
    """(name, shape) of COMP_ARCH's full-width parameter tree at tp = 1."""
    cfg = LM_configs.get_config(COMP_ARCH, tp=1)
    tree = LM_registry.build(cfg).init(torch.Generator(dev).manual_seed(0),
                                       dev)
    return [(n, tuple(t.shape)) for n, t in tree_named_leaves(tree)]


def rank_grads(rank: int, shapes: list, dev) -> dict:
    """Rank ``rank``'s seeded f32 gradients, one per parameter."""
    gen = torch.Generator(dev).manual_seed(1000 + rank)
    return {n: torch.randn(shp, generator=gen, device=dev)
            for n, shp in shapes}


def _wall_ms(fn, iters: int, group=None) -> float:
    """Mean host ms of ``iters`` calls, the ranks aligned at a barrier
    first and each call synchronised with the card."""
    dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def halo_rank(rank: int, world: int, recipes: dict, x_np: np.ndarray,
              shapes: list) -> dict:
    """One rank of [16] and [16b] on cuda:0: its shard of the stream
    through each datapath's halo_apply (counts zeroed before the checked
    call), the exchange alone, then compressed_psum on its gradients."""
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = make_mesh((world,), ("data",), "cuda")
    group = mesh.get_group("data")
    x = HALO.local_shard(torch.from_numpy(x_np), CFG, mesh).to(dev)
    o_samp = HALO.halo_samples(CFG, world)
    neighbours = (rank > 0) + (rank < world - 1)
    x_host = x.cpu()
    out = {"backend": dist.get_backend(group),
           "staged_through_host": stages_through_host(group, dev),
           "shard_samples": int(x.shape[0]), "halo_samples": o_samp,
           "exchange_host_tensor_ms": _wall_ms(lambda: HALO.halo_exchange(
               x_host[None], o_samp, group), HALO_ITERS, group),
           "datapaths": {}}
    for dp, (backend, weights, fmts, tile) in recipes.items():
        e = EqualizerEngine(cfg=CFG, weights=weights, backend=backend,
                            formats=fmts, tile_m=tile, device=dev)
        quant = HALO._engine_halo_quant(e)
        HALO.halo_apply(e, x, CFG, mesh)               # warm-up
        torch.cuda.synchronize()
        K.reset_launch_counts()
        y = HALO.halo_apply(e, x, CFG, mesh)
        torch.cuda.synchronize()
        launches, instances = dict(K.LAUNCHES), dict(K.INSTANCE_LAUNCHES)
        call_ms = _wall_ms(lambda: HALO.halo_apply(e, x, CFG, mesh),
                           HALO_ITERS, group)
        xch_ms = _wall_ms(lambda: HALO.halo_exchange(
            x[None], o_samp, group, quant), HALO_ITERS, group)
        edge_bytes = o_samp * (1 if quant else 4)
        out["datapaths"][dp] = {
            "y": y.cpu().numpy(), "launches": launches,
            "instances": instances, "call_ms": call_ms,
            "exchange_ms": xch_ms, "wire": "int8" if quant else "fp32",
            "bytes_sent": neighbours * edge_bytes,
            "bytes_received": neighbours * edge_bytes}
    out["comp"] = comp_rank(rank, world, shapes, dev)
    return out


def comp_rank(rank: int, world: int, shapes: list, dev) -> dict:
    """[16b] on one rank: compressed_psum of its gradients (error zero),
    timed, then held to the exact mean of every rank's gradients (each
    rank's are regenerated from their seeds): within one quantization
    step (the largest rank's scale) of it, and each residual 0 < |e| <
    this rank's scale, leaf by leaf."""
    grads = rank_grads(rank, shapes, dev)
    error = GC.init_error(grads)
    GC.compressed_psum(grads, error)                   # warm-up
    ms = _wall_ms(lambda: GC.compressed_psum(grads, error), COMP_ITERS)
    mean, new_error = GC.compressed_psum(grads, error)
    torch.cuda.synchronize()
    scales = {n: [] for n, _ in shapes}
    exact = {n: torch.zeros(shp, device=dev) for n, shp in shapes}
    for r in range(world):
        for n, g in rank_grads(r, shapes, dev).items():
            exact[n] += g
            scales[n].append(float(g.abs().max()) / 127)
    worst_step, resid = 0.0, []
    for n, _ in shapes:
        err = float((mean[n] - exact[n] / world).abs().max())
        step = max(scales[n])
        require(err < step, f"[16b] rank {rank} {n}: mean off the exact "
                f"mean by {err:.3e}, one step {step:.3e}")
        worst_step = max(worst_step, err / step)
        e = float(new_error[n].abs().max())
        require(0 < e < scales[n][rank], f"[16b] rank {rank} {n}: residual "
                f"{e:.3e}, scale {scales[n][rank]:.3e}")
        resid.append(e / scales[n][rank])
    numel = sum(int(np.prod(shp)) for _, shp in shapes)
    return {"ms": ms, "leaves": len(shapes), "params": numel,
            "int8_bytes_gathered": (world - 1) * (numel + 4 * len(shapes)),
            "f32_bytes_same_gather": (world - 1) * 4 * numel,
            "max_err_over_step": worst_step,
            "max_residual_over_scale": max(resid)}


def check_halo(dev) -> dict:
    """[16]/[16a]/[16b]: [11]'s engines and stream over HALO_RANKS ranks;
    every datapath's gathered output == the unsplit engine bitwise and ==
    partitioned_apply(n_inst=HALO_RANKS) on the interior, one rb launch
    a rank; the kernel == plain at the per-rank launch shape."""
    engines = partition_engines(dev)
    x_np = waveform(np.random.default_rng(12), PART_SYMS)
    x = torch.from_numpy(x_np).to(dev)
    shapes = comp_shapes(dev)
    ranks = run_ranks(halo_rank, HALO_RANKS, (
        {dp: engine_recipe(e) for dp, e in engines.items()}, x_np, shapes),
        timeout_s=RANK_TIMEOUT_S)
    o_sym = SP.overlap_symbols(CFG)
    checks, per_rank, launches = {}, {}, {}
    for dp, e in engines.items():
        name = KERNELS[dp][0]
        whole = e(x)
        got = torch.from_numpy(np.concatenate(
            [r["datapaths"][dp]["y"] for r in ranks])).to(dev)
        part = SP.partitioned_apply(e, x, HALO_RANKS, CFG)
        require(torch.equal(got, whole),
                f"[16] {dp}: halo over {HALO_RANKS} ranks != unsplit "
                f"(max |diff| {float((got - whole).abs().max()):.3e})")
        require(torch.equal(got[o_sym:-o_sym], part[o_sym:-o_sym]),
                f"[16] {dp}: halo interior != partitioned_apply")
        for r, out in enumerate(ranks):
            n = out["datapaths"][dp]["launches"]
            require(n[name] == 1 and sum(n.values()) == 1,
                    f"[16] {dp} rank {r}: launches {n}")
            require_instances(n, out["datapaths"][dp]["instances"],
                              f"[16] {dp} rank {r}")
        launches[name] = sum(out["datapaths"][dp]["launches"][name]
                             for out in ranks)
        checks[dp] = {"vs_unsplit": "bitwise",
                      "vs_partitioned_interior": "bitwise"}
        per_rank[dp] = [{k: out["datapaths"][dp][k] for k in (
            "call_ms", "exchange_ms", "wire", "bytes_sent",
            "bytes_received")} | {"rb_launches": out["datapaths"][dp][
                "instances"]["rb"]} for out in ranks]
    # [16a] each kernel == plain at the per-rank launch shape (an interior
    # rank's shard with its neighbours' halos)
    w = ranks[0]["shard_samples"]
    o_samp = ranks[0]["halo_samples"]
    ext = x[w - o_samp:2 * w + o_samp][None]
    shape16a = {}
    for dp, e in engines.items():
        got, want = e(ext), engine_plain(e)(ext)
        require(torch.equal(got, want),
                f"[16a] {dp}: kernel != plain at {tuple(ext.shape)}")
        shape16a[dp] = list(ext.shape)
    return {"checks": checks, "per_rank": per_rank, "launches": launches,
            "backend": ranks[0]["backend"],
            "staged_through_host": ranks[0]["staged_through_host"],
            "exchange_host_tensor_ms": [r["exchange_host_tensor_ms"]
                                        for r in ranks],
            "shard_samples": w, "halo_samples": o_samp, "kernel_vs_plain":
            {"shape": shape16a, "result": "bitwise"},
            "comp": [r["comp"] for r in ranks]}


RESHARD_STEPS = ("mesh", "distribute", "save", "restore", "checked")


def cuda_reshard_rank(rank: int, world: int, tmp: str,
                      gather: bool) -> dict:
    """The (2, 2) → (1, 2) reshard on a "cuda" mesh over gloo: a tree
    sharded on (2, 2) (each rank cuts its shard, no collective), saved
    (with ``gather`` as DTensor leaves, which `CheckpointManager.save`
    gathers through the host off NCCL; without, the same tree as plain
    tensors), restored onto best_mesh(2, 2), each
    rank's local shard held to its slice (no collective). Each step
    reached is written to ``tmp``/progress<rank>, so a rank that dies
    shows where."""
    from torch.distributed.tensor import distribute_tensor
    progress = pathlib.Path(tmp, f"progress{rank}")

    def reached(step: str) -> None:
        with progress.open("a") as f:
            f.write(step + "\n")

    torch.cuda.set_device(0)
    w = torch.arange(64, dtype=torch.float32, device="cuda").reshape(8, 8)
    tree = {"layers": {"w_gate": w}}
    mesh4 = make_mesh((2, 2), ("data", "model"), "cuda")
    reached("mesh")
    specs = SHARD.param_specs(tree, mesh4, "train")
    place = SHARD.placements(specs["layers"]["w_gate"], mesh4)
    sharded = distribute_tensor(w, mesh4, place, src_data_rank=None)
    reached("distribute")
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    ckpt.save(1, {"layers": {"w_gate": sharded if gather else w}})
    reached("save")
    mesh2 = best_mesh(n_devices=2, model_parallel=2)
    got, _ = ElasticRestore(ckpt).restore(tree, mesh2)
    reached("restore")
    local = got["layers"]["w_gate"].to_local()
    if rank < 2:
        require(local.is_cuda and torch.equal(
            local, w[:, 4 * rank:4 * rank + 4]),
            f"[16c] rank {rank}: local shard {tuple(local.shape)}")
    reached("checked")
    return {"local": list(local.shape), "device": str(local.device)}


def check_elastic(dev) -> dict:
    """[16c]: a seeded COMP_ARCH tree saved by the port's CheckpointManager
    and restored by ElasticRestore onto best_mesh() of a one-rank world on
    the card: every leaf a DTensor on cuda:0 equal to the saved tensor
    bitwise. Then the multi-rank reshard on a "cuda" mesh over gloo, from
    DTensor leaves and from plain tensors: both must run, and the two
    saves must write the same files byte for byte."""
    cfg = LM_configs.get_config(COMP_ARCH, tp=1)
    tree = LM_registry.build(cfg).init(torch.Generator(dev).manual_seed(3),
                                       dev)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as tmp:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
            t0 = time.perf_counter()
            ckpt.save(7, tree)
            out["save_s"] = time.perf_counter() - t0
            mesh = best_mesh()
            t0 = time.perf_counter()
            restored, step = ElasticRestore(ckpt).restore(tree, mesh)
            torch.cuda.synchronize()
            out["restore_s"] = time.perf_counter() - t0
            require(step == 7, f"[16c] step {step}")
            names = dict(tree_named_leaves(tree))
            for n, leaf in tree_named_leaves(restored):
                local = leaf.to_local()
                require(local.device == dev and torch.equal(local, names[n]),
                        f"[16c] {n}: on {local.device}, or != saved")
            out.update(mesh=str(mesh), leaves=len(names), bytes=sum(
                t.numel() * t.element_size() for t in names.values()),
                restored="bitwise, every leaf on cuda:0")
        finally:
            dist.destroy_process_group()
        arms = {}
        for gather in (True, False):
            t0 = time.perf_counter()
            arms[gather] = cuda_reshard(
                os.path.join(tmp, f"reshard_{gather}"), gather)
            arms[gather]["s"] = time.perf_counter() - t0
        require(arms[True]["files"] == arms[False]["files"],
                "[16c] the DTensor save's files differ from the plain "
                "save's")
        for gather, arm in arms.items():
            arm.pop("files")
            out[f"cuda_mesh_reshard_2x2_to_1x2_gather_{gather}"] = arm
        out["dtensor_save_equals_plain_save"] = "file for file"
    return out


def cuda_reshard(tmp: str, gather: bool) -> dict:
    """`cuda_reshard_rank` on 4 ranks; a failure raises, naming the step
    each rank reached (a rank that segfaults in a collective raises
    nothing itself)."""
    os.makedirs(tmp)
    try:
        ranks = run_ranks(cuda_reshard_rank, 4, (tmp, gather), timeout_s=180)
    except (RuntimeError, TimeoutError) as e:
        last = []
        for r in range(4):
            f = pathlib.Path(tmp, f"progress{r}")
            done = f.read_text().split() if f.exists() else []
            last.append(done[-1] if done else "none")
        raise RuntimeError(f"[16c] the (2, 2) -> (1, 2) reshard on a cuda "
                           f"mesh (gather={gather}) failed; last step per "
                           f"rank {last} of {list(RESHARD_STEPS)}") from e
    saved = pathlib.Path(tmp, "ckpt", "step_00000001")
    return {"ran": True, "locals": [r["local"] for r in ranks],
            "files": {p.name: p.read_bytes() for p in saved.iterdir()}}


# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the port's kernels by name prefix (a kind in `device_trace` is a kernel's
# whole name up to its arguments, template arguments included)
KERNEL_NAMES = ("cnn_eq_kernel", "volterra_kernel", "quant_kernel",
                "quant_many_kernel",
                "conv1d_kernel", "flash_attn_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_kernel", "slstm_kernel", "slstm_bwd_kernel",
                "slstm_bwd_kernel_cluster")


def device_trace(fn, warmup=None) -> dict:
    """One run of fn under torch.profiler: wall time, the union of device
    activity (kernels and copies), device time by kind (each of the port's
    kernels by name, copies, everything else) and the six device
    activities that took the most time. With ``warmup``, the session has
    a schedule of one warm-up and one active step: warmup() runs in the
    warm-up step and only fn() is recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    sched = (schedule(wait=0, warmup=1, active=1) if warmup is not None
             else None)
    torch.cuda.synchronize()
    box = {}   # a scheduled session clears its events when its cycle ends
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched, on_trace_ready=lambda p: box.update(
                     events=list(p.events()))) as prof:
        if warmup is not None:
            warmup()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        if sched is not None:
            prof.step()
    events = box["events"] if sched is not None else prof.events()
    # a scheduled step's "ProfilerStep#" annotation is recorded on the
    # device too and spans the whole step: it is no device work
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep"))
    busy_us, last = 0.0, float("-inf")
    kinds: dict = {}
    names: dict = {}
    for start, end, name in spans:
        if end > last:
            busy_us += end - max(start, last)
            last = end
        kind = (name.split("(")[0].replace("void ", "")
                if any(k in name for k in KERNEL_NAMES)
                else "memcpy" if "emcpy" in name else "other")
        for table, key in ((kinds, kind), (names, name[:80])):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + (end - start) / 1e3)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": (1.0 - busy_us / wall_us) if spans else None,
            "by_kind_ms": {k: {"count": n, "total_ms": t, "mean_ms": t / n}
                           for k, (n, t) in kinds.items()},
            "top_ms": [{"name": k, "count": n, "total_ms": t}
                       for k, (n, t) in top]}


def conv_chain(xp: torch.Tensor, weights, strides, dtype) -> torch.Tensor:
    """The same stacked function as a chain of grouped F.conv1d + ReLU
    (one group per row) — a library yardstick, never called by the port."""
    rows = xp.shape[0]
    h = xp[None].to(dtype)                                  # (1, rows, W)
    for i, ((w, b), s) in enumerate(zip(weights, strides)):
        h = F.conv1d(h, w.reshape(-1, w.shape[-2], w.shape[-1]).to(dtype),
                     b.reshape(-1).to(dtype), stride=s, groups=rows)
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def macs_of(x: torch.Tensor, weights, strides) -> int:
    """The MACs this input needs through the stack (untiled)."""
    rows, width = x.shape
    kernels = [int(w.shape[-1]) for w, _ in weights]
    n_pos = width // int(np.prod(strides))
    spans = R._spans(n_pos, kernels, strides)
    return rows * sum(int(w.shape[-3]) * int(w.shape[-2]) * int(w.shape[-1])
                      * spans[i + 1] for i, (w, _) in enumerate(weights))


def bound(dp: str, x: torch.Tensor, weights, strides) -> tuple:
    """(least ms, "bytes" | "operations"): each input read once, each output
    written once, against the MACs this input needs (untiled)."""
    rows, width = x.shape
    n_pos = width // int(np.prod(strides))
    macs = macs_of(x, weights, strides)
    n_out = rows * n_pos * int(weights[-1][0].shape[-3])
    n_bytes = (x.numel() * 4 + n_out * 4
               + sum(w.numel() * w.element_size() + b.numel() * 4
                     for w, b in weights))
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = 2 * macs / PEAK_OPS_S[dp]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernels(inputs: dict, tiles_used: dict, serving: dict,
                 iters: int) -> dict:
    out = {}
    for dp, d in inputs.items():
        x, w, st = d["x"], d["stacked"], d["strides"]
        tile = tiles_used[dp]
        plan = K._lib_plan(K._load(), MODE_OF[dp], K._RB_DIMS)
        xp, _ = R._halo_pad(x, [int(wi.shape[-1]) for wi, _ in w], st)
        # PyTorch has no int8 convolution: the int8 yardstick is the fp32
        # chain on the same rows' fp32 folded weights
        lib_w = d["fp32_stacked"] if dp == "int8" else w
        lib_dtype = torch.bfloat16 if dp == "bf16" else torch.float32
        with fp32_exact():
            t_kernel = cuda_ms(lambda: d["kernel"](x, w, tile), iters)
            t_plain = cuda_ms(lambda: d["plain"](x, w), max(3, iters // 20),
                              warmup=2)
            t_lib = cuda_ms(lambda: conv_chain(xp, lib_w, st, lib_dtype),
                            iters)
            t_kernel_again = cuda_ms(lambda: d["kernel"](x, w, tile), iters)
        prof = device_trace(lambda: [d["kernel"](x, w, tile)
                                     for _ in range(20)])
        dev_ms = [v["mean_ms"] for k, v in prof["by_kind_ms"].items()
                  if k.startswith("cnn_eq_kernel")]
        b_ms, b_by = bound(dp, x, w, st)
        out[dp] = {"ms": t_kernel, "ms_repeat": t_kernel_again,
                   "device_ms": dev_ms[0] if dev_ms else None,
                   "plain_ms": t_plain, "library_ms": t_lib,
                   "bound_ms": b_ms, "bound_by": b_by, "tile_m": tile,
                   "instance": plan.instance,
                   "shape": f"{x.shape[0]}x{x.shape[1]} samples, "
                            f"stacked weights"}
        if plan.instance == "rb":
            fmts = d["formats"] if dp == "int8" else None
            sv = serving[dp]
            xs = x[:sv["rows"], :sv["width"]].contiguous()
            ws = tuple((a[:sv["rows"]].contiguous(), b[:sv["rows"]]
                        .contiguous()) for a, b in w)
            out[dp].update(
                w_run=plan.w_run, p=plan.p, threads=plan.threads,
                generic_device_ms=_device_ms(
                    lambda: K._forced("generic", MODE_OF[dp], x, w, st, tile,
                                      formats=fmts), "cnn_eq_kernel",
                    warm=True),
                device_ms_again=_device_ms(lambda: d["kernel"](x, w, tile),
                                           "cnn_eq_kernel", warm=True),
                serving_shape=f"{sv['rows']}x{sv['width']} samples",
                serving_device_ms=_device_ms(
                    lambda: d["kernel"](xs, ws, tile), "cnn_eq_kernel",
                    warm=True),
                serving_generic_device_ms=_device_ms(
                    lambda: K._forced("generic", MODE_OF[dp], xs, ws, st,
                                      tile, formats=fmts), "cnn_eq_kernel",
                    warm=True))
        if dp in ("fp32", "bf16"):
            # the fixed order issues a multiply and an add a MAC: two FP32
            # instructions at half the FMA peak's flop rate
            out[dp]["fp32_issue_floor_ms"] = (
                2 * macs_of(x, w, st) / (PEAK_OPS_S["fp32"] / 2) * 1e3)
    return out


# ---------------------------------------------------------------------------
# phase 6: train the three equalizer families on the card
# ---------------------------------------------------------------------------

def train_families(dev) -> dict:
    """`train_equalizer` for CNN (3-phase QAT), FIR and Volterra on the
    default IM/DD link, each from its own seeded card generator."""
    fn = channel_fn("imdd", HT.CHANNEL, device=dev)
    out = {}
    for i, (kind, (cfg, qcfg)) in enumerate(FAMILIES.items()):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, bn, info = train_eq.train_equalizer(
            gen, kind, cfg, fn, TRAIN, qat_cfg=qcfg, record_every=1,
            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = np.array([h["loss"] for h in info["history"]])
        require(losses.shape == (TRAIN.steps,) and bool(
            np.isfinite(losses).all()), f"{kind}: non-finite training loss")
        first, last = float(losses[:50].mean()), float(losses[-50:].mean())
        require(last < first, f"{kind}: loss did not fall (first 50 steps "
                              f"{first:.4f}, last 50 {last:.4f})")
        if qcfg is not None:
            widths = [float(v) for q in params["qat"].values()
                      for v in q.values()]
            require(all(w == np.ceil(w) for w in widths),
                    f"{kind}: QAT widths not frozen to integers: {widths}")
        out[kind] = {"params": params, "bn": bn, "info": info,
                     "loss_first50": first, "loss_last50": last,
                     "ms_per_step": wall / TRAIN.steps * 1e3,
                     "wall_s": wall}
    return out


def train_trace(dev) -> dict:
    """A short CNN run (10 steps through all three QAT phases) under
    torch.profiler: where a training step's time goes."""
    short = train_eq.EqTrainConfig(steps=10, batch=TRAIN.batch,
                                   seq_syms=TRAIN.seq_syms, eval_syms=4096)
    cfg, qcfg = FAMILIES["cnn"]
    return device_trace(lambda: train_eq.train_equalizer(
        torch.Generator(device=dev).manual_seed(9), "cnn", cfg,
        channel_fn("imdd", HT.CHANNEL, device=dev), short, qat_cfg=qcfg,
        device=dev))


# ---------------------------------------------------------------------------
# phase 7: deploy the trained parameters through the three kernels
# ---------------------------------------------------------------------------

def deploy_inputs(dev, trained: dict) -> dict:
    """One fresh IM/DD batch at the deployment shape and the trained
    parameters in the deployment entry points' forms."""
    gen = torch.Generator(device=dev).manual_seed(7)
    rx, syms = imdd.simulate(gen, HT.CHANNEL, SYMS, batch=ROWS, device=dev)
    cnn = trained["cnn"]
    folded = eq.fold_bn(cnn["params"], cnn["bn"], CFG)
    return {"rx": rx.contiguous(), "syms": syms,
            "vol": trained["volterra"]["params"],
            "cnn": cnn["params"], "qat": cnn["params"]["qat"],
            "layers": [(l["w"].contiguous(), l["b"].contiguous(), s)
                       for l, (_, _, s) in zip(folded["conv"],
                                               CFG.layer_specs())]}


def deploy(d: dict) -> dict:
    """The main path of this slice: the trained parameters through each
    deployment entry point once, on the card."""
    y_vol = V_ops.equalize(d["vol"], d["rx"], FAMILIES["volterra"][0],
                           device=d["rx"].device)
    q = Q_ops.quantize_params(d["cnn"], d["qat"], device=d["rx"].device)
    h, ins, outs = d["rx"][:, None, :], [], []
    for i, (w, b, s) in enumerate(d["layers"]):
        ins.append(h)
        outs.append(C1_ops.conv1d_same_lower(h, w, b, s,
                                             device=d["rx"].device))
        h = torch.relu(outs[-1]) if i < len(d["layers"]) - 1 else outs[-1]
    torch.cuda.synchronize()
    return {"volterra": y_vol, "quant": q, "ins": ins, "outs": outs}


def check_deploy(d: dict, run: dict) -> dict:
    """Each kernel == its plain version bitwise on the deploy run's inputs,
    plus the cross-checks; returns the numbers phase 7 prints."""
    dev = d["rx"].device
    vcfg = FAMILIES["volterra"][0]
    out = {"max_abs_err": {}}
    # volterra: the trained baseline, then random sets up to the DSE's
    # largest memory lengths
    want = V_ops.equalize(d["vol"], d["rx"], vcfg, use_kernel=False,
                          device=dev)
    got = run["volterra"]
    require(got.shape == (ROWS, SYMS) and bool(torch.isfinite(got).all()),
            f"volterra: output {tuple(got.shape)} or non-finite")
    err = float((got - want).abs().max())
    require(torch.equal(got, want), f"volterra kernel != plain ({err:.3e})")
    core = vol.apply(d["vol"], d["rx"], vcfg)
    out["volterra_ber_kernel"] = float(ber_from_soft(got, d["syms"]))
    out["volterra_ber_core"] = float(ber_from_soft(core, d["syms"]))
    out["volterra_kernel_vs_core_max_abs"] = float((got - core).abs().max())
    out["volterra_decisions_differ"] = int(
        (pam_decision(got) != pam_decision(core)).sum())
    ws = [d["vol"]["w0"], d["vol"]["w1"], d["vol"]["w2"], None]
    generic = V._forced("generic", d["rx"], *ws, stride=vcfg.n_os)
    require(torch.equal(got, generic), "volterra: rb != generic forced")
    # the register-blocked kernel at the edges and in the 16-bit types
    gen = torch.Generator().manual_seed(9)
    edges = []
    for rows, width, strided in V_EDGES:
        big = torch.randn((rows, width + 11), generator=gen).to(dev)
        for dt in (torch.float32,) + HALF_TYPES:
            xb = big.to(dt)
            x = xb[:, 5:5 + width] if strided else xb[:, :width].contiguous()
            before = dict(V.INSTANCE_LAUNCHES)
            k = V.volterra(x, *ws, stride=vcfg.n_os)
            require(V.INSTANCE_LAUNCHES["rb"] == before["rb"] + 1,
                    f"volterra {rows}x{width} {dt}: not the rb kernel")
            p = V_ref.volterra(x, *ws, vcfg.n_os)
            e = float((k.float() - p.float()).abs().max())
            require(k.dtype == dt and torch.equal(k, p),
                    f"volterra {rows}x{width} {dt}: kernel != plain "
                    f"({e:.3e})")
            require(torch.equal(k, V._forced("generic", x, *ws,
                                             stride=vcfg.n_os)),
                    f"volterra {rows}x{width} {dt}: rb != generic forced")
            err = max(err, e)
        edges.append(f"{rows}x{width}{' strided' if strided else ''}")
    for dt in HALF_TYPES:
        x = d["rx"].to(dt)
        k = V_ops.equalize(d["vol"], x, vcfg, device=dev)
        require(k.dtype == dt and torch.equal(k, V_ops.equalize(
            d["vol"], x, vcfg, use_kernel=False, device=dev)),
            f"volterra deploy in {dt}: kernel != plain")
    out["volterra_edges_bitwise"] = edges + ["bf16", "f16"]
    rng = torch.Generator().manual_seed(8)
    for m1, m2, m3 in VOLTERRA_SETS:
        ws = [torch.tensor(0.05), 0.3 * torch.randn(m1, generator=rng),
              0.1 * torch.randn((m2, m2), generator=rng),
              0.05 * torch.randn((m3, m3, m3), generator=rng)]
        ws = [w.to(dev) for w in ws]
        before = dict(V.INSTANCE_LAUNCHES)
        k = V.volterra(d["rx"], *ws, stride=HT.CNN.n_os)
        require(V.INSTANCE_LAUNCHES["generic"] == before["generic"] + 1,
                f"volterra ({m1}, {m2}, {m3}): not the generic kernel")
        p = V_ref.volterra(d["rx"], *ws, HT.CNN.n_os)
        e = float((k - p).abs().max())
        require(torch.equal(k, p), f"volterra ({m1}, {m2}, {m3}): kernel != "
                                   f"plain ({e:.3e})")
        err = max(err, e)
    out["max_abs_err"]["volterra"] = err
    # quant: kernel == plain == the QAT quantizer at the frozen widths
    plain = Q_ops.quantize_params(d["cnn"], d["qat"], use_kernel=False,
                                  device=dev)
    err = 0.0
    for i, (lk, lp) in enumerate(zip(run["quant"]["conv"], plain["conv"])):
        qw = d["qat"][f"layer{i}"]
        for key in ("w", "b"):
            e = float((lk[key] - lp[key]).abs().max())
            require(torch.equal(lk[key], lp[key]),
                    f"quant layer {i} {key}: kernel != plain ({e:.3e})")
            require(torch.equal(lk[key], qat.quantize_fixed(
                d["cnn"]["conv"][i][key], qw["w_int"], qw["w_frac"])),
                f"quant layer {i} {key}: != core.qat.quantize_fixed")
            err = max(err, e)
    # the per-tensor kernel: the waveform (64 x 14640) in float32 and
    # bfloat16, short lengths, a view off the 16-byte boundary
    qi, qf = d["qat"]["layer0"]["w_int"], d["qat"]["layer0"]["w_frac"]
    flat = d["rx"].reshape(-1)
    cases = {"64x14640 f32": d["rx"], "64x14640 bf16": d["rx"].to(
        torch.bfloat16), "offset 1": flat[1:]}
    cases.update({f"length {n}": flat[:n] for n in (1, 3, 5, 17)})
    for name, x in cases.items():
        k = Q.fixed_point_quantize(x, qi, qf)
        require(k.dtype == x.dtype and torch.equal(
            k, Q_ref.fixed_point_quantize(x, qi, qf)),
            f"quant {name}: kernel != plain")
    out["quant_per_tensor_bitwise"] = list(cases)
    out["max_abs_err"]["fixed_point_quantize"] = err
    out["quant_formats"] = [tuple(int(v) for v in (q["w_int"], q["w_frac"]))
                            for q in d["qat"].values()]
    # conv1d: each layer on the deploy run's own input to it, against the
    # plain version and the generic kernel forced on the same input
    err, lib_err = 0.0, 0.0
    for i, (w, b, s) in enumerate(d["layers"]):
        x, got_lin = run["ins"][i], run["outs"][i]
        want = C1_ops.conv1d_same_lower(x, w, b, s, use_kernel=False,
                                        device=dev)
        e = float((got_lin - want).abs().max())
        require(torch.equal(got_lin, want),
                f"conv1d layer {i}: kernel != plain ({e:.3e})")
        k = w.shape[-1]
        generic = C1._forced("generic", x, w, b, s,
                             pad=(k // 2, k - 1 - k // 2))
        require(torch.equal(got_lin, generic),
                f"conv1d layer {i}: rb != generic forced")
        with fp32_exact():
            lib = F.conv1d(F.pad(x, (k // 2, k - 1 - k // 2)), w, b,
                           stride=s)
        lib_err = max(lib_err, float((got_lin - lib).abs().max()))
        err = max(err, e)
    out["max_abs_err"]["conv1d"] = err
    out["conv1d_vs_F_conv1d_max_abs"] = lib_err
    # bfloat16 through the three deploy layers, on the deploy run's inputs
    h = run["ins"][0].to(torch.bfloat16)
    for i, (w, b, s) in enumerate(d["layers"]):
        got = C1_ops.conv1d_same_lower(h, w, b, s, device=dev)
        want = C1_ops.conv1d_same_lower(h, w, b, s, use_kernel=False,
                                        device=dev)
        require(got.dtype == torch.bfloat16 and torch.equal(got, want),
                f"conv1d layer {i} in bfloat16: kernel != plain")
        h = torch.relu(got)
    out["conv1d_bf16_bitwise"] = len(d["layers"])
    y = run["outs"][-1].transpose(1, 2).reshape(ROWS, -1)
    require(y.shape == (ROWS, SYMS), f"CNN output {tuple(y.shape)}")
    out["cnn_ber_conv1d_chain"] = float(ber_from_soft(y, d["syms"]))
    return out


# ---------------------------------------------------------------------------
# phase 5 (new kernels): times at the deployment shapes
# ---------------------------------------------------------------------------

def _bound(n_bytes: float, flops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / PEAK_OPS_S["fp32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _device_ms(fn, name: str, calls: int = 20, warm: bool = False):
    """Mean device ms of the kernels whose name starts with ``name`` over
    ``calls`` calls of fn (end ``name`` with "<" to take one template's
    instances only: "slstm_bwd_kernel<" is the stream backward, not
    "slstm_bwd_kernel_cluster<…>"); with ``warm``, one call runs first in
    the profiler's warm-up step (a session that follows another may miss
    its first kernel events, which a 3-call session cannot spare)."""
    prof = device_trace(lambda: [fn() for _ in range(calls)],
                        warmup=fn if warm else None)
    ms = [v["mean_ms"] for k, v in prof["by_kind_ms"].items()
          if k.startswith(name)]
    if ms or not warm:
        return ms[0] if ms else None
    # late in a long process a short scheduled session can come back
    # with no device events at all (a padded window does not help): say
    # so, then take one unscheduled session, the kernel warmed outside it
    seen = {k: v["count"] for k, v in prof["by_kind_ms"].items()}
    fn()
    prof = device_trace(lambda: [fn() for _ in range(calls)])
    ms = [v["mean_ms"] for k, v in prof["by_kind_ms"].items()
          if k.startswith(name)]
    print(f"    profiler: no {name} events in a scheduled session of "
          f"{calls} calls (device kinds seen: {seen}); an unscheduled one "
          f"read {ms[0] if ms else None} ms (device kinds seen: "
          f"{ {k: v['count'] for k, v in prof['by_kind_ms'].items()} })",
          flush=True)
    return ms[0] if ms else None


def time_deploy_kernels(d: dict, run: dict, iters: int) -> dict:
    """CUDA-event ms per call, profiler device ms, plain ms, a PyTorch
    yardstick and the bound, for each deployment kernel at the deploy
    run's shapes."""
    out = {}
    x = d["rx"]
    vcfg = FAMILIES["volterra"][0]
    ws = [d["vol"]["w0"], d["vol"]["w1"], d["vol"].get("w2"), None]
    m1, m2, m3 = vcfg.m1, vcfg.m2, vcfg.m3
    macs = m1 + m2 * m2 + m2 + m3 ** 3 + m3 * m3 + m3
    n_out = x.shape[0] * (x.shape[1] // vcfg.n_os)
    b_ms, b_by = _bound(x.numel() * 4 + n_out * 4 + 4 * (1 + m1 + m2 * m2),
                        2 * macs * n_out)
    vplan = V._lib_plan(V._load(), V._dims(ws[1], ws[2], ws[3], vcfg.n_os))

    def v_kernel():         # the deploy path's call
        return V.volterra(x, *ws, stride=vcfg.n_os)

    def v_generic():
        return V._forced("generic", x, *ws, stride=vcfg.n_os)
    x16 = x.to(torch.bfloat16)
    with fp32_exact():
        t_k = cuda_ms(v_kernel, iters)
        t_p = cuda_ms(lambda: V_ref.volterra(x, *ws, vcfg.n_os), 5, warmup=1)
        t_l = cuda_ms(lambda: vol.apply(d["vol"], x, vcfg), iters)
        t_g = cuda_ms(v_generic, iters)
        t_k2 = cuda_ms(v_kernel, iters)
    out["volterra"] = {
        "ms": t_k, "ms_repeat": t_k2, "plain_ms": t_p, "library_ms": t_l,
        "generic_ms": t_g,
        "device_ms": _device_ms(v_kernel, "volterra_kernel", warm=True),
        "generic_device_ms": _device_ms(v_generic, "volterra_kernel",
                                        warm=True),
        "bf16_device_ms": _device_ms(
            lambda: V.volterra(x16, *ws, stride=vcfg.n_os),
            "volterra_kernel", warm=True),
        "instance": vplan.instance, "w_run": vplan.w_run, "p": vplan.p,
        "bound_ms": b_ms, "bound_by": b_by, "flop": 2 * macs * n_out,
        "library": "einsum chain of core.volterra.apply (unfold + 2 "
                   "einsums, TF32 off): a chain, no single call",
        "shape": f"{x.shape[0]}x{x.shape[1]} samples, (M1, M2, M3) = "
                 f"({m1}, {m2}, {m3}); generic kernel at tile 128"}

    out["fixed_point_quantize"] = time_quant(d, iters)

    layers = []
    lib = C1._load()
    for i, (w, b, s) in enumerate(d["layers"]):
        h = run["ins"][i]
        k = w.shape[-1]
        pad = (k // 2, k - 1 - k // 2)
        xp = F.pad(h, pad).contiguous()
        n_o = (xp.shape[-1] - k) // s + 1
        c_out, c_in = int(w.shape[0]), int(w.shape[1])
        lb_ms, lb_by = _bound(
            4 * (h.numel() + xp.shape[0] * c_out * n_o + w.numel() + c_out),
            2 * xp.shape[0] * c_out * c_in * k * n_o)
        plan = C1._lib_plan(lib, C1._dims(w, s))

        def kernel():       # the deploy path's call: conv1d_same_lower
            return C1_ops.conv1d_same_lower(h, w, b, s, device=h.device)
        with fp32_exact():
            t_k = cuda_ms(kernel, iters)
            t_p = cuda_ms(lambda: C1_ref.conv1d(xp, w, b, s), 5, warmup=1)
            t_l = cuda_ms(lambda: F.conv1d(xp, w, b, stride=s), iters)
        layers.append({
            "shape": f"{tuple(h.shape)} -> ({xp.shape[0]}, {c_out}, {n_o}),"
                     f" stride {s}",
            "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "device_ms": _device_ms(kernel, "conv1d_kernel", warm=True),
            "generic_device_ms": _device_ms(
                lambda: C1._forced("generic", h, w, b, s, pad=pad),
                "conv1d_kernel", warm=True),
            "instance": plan.instance, "w_run": plan.w_run, "p": plan.p,
            "bound_ms": lb_ms, "bound_by": lb_by})

    def total(key):
        vals = [l[key] for l in layers]
        return None if any(v is None for v in vals) else sum(vals)
    out["conv1d"] = {
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "library_ms": total("library_ms"), "device_ms": total("device_ms"),
        "generic_device_ms": total("generic_device_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if all(l["bound_by"] == "bytes" for l in layers)
        else "operations",
        "instance": "+".join(sorted({l["instance"] for l in layers})),
        "library": "F.conv1d (TF32 off) per layer on the padded input, bias "
                   "included",
        "shape": f"the trained CNN's three layers at {x.shape[0]} x "
                 f"{x.shape[1]} samples through conv1d_same_lower; times "
                 f"summed over the layers",
        "per_layer": layers}
    return out


def _fake_quant(x: torch.Tensor, wi, wf):
    """torch.fake_quantize_per_tensor_affine at Q(wi).(wf) (integer widths,
    wi + wf < 31), or None where it cannot take them: a library yardstick,
    never called by the port."""
    i_, f_ = int(wi), int(wf)
    if i_ + f_ >= 31:
        return None
    return lambda: torch.fake_quantize_per_tensor_affine(
        x, 2.0 ** -f_, 0, -2 ** (i_ + f_), 2 ** (i_ + f_) - 1)


def time_quant(d: dict, iters: int) -> dict:
    """The quant kernels' times. The deploy shape (the main path's): the
    trained CNN's six tensors through `fixed_point_quantize_many` (one
    launch), against six per-tensor launches and six
    torch.fake_quantize_per_tensor_affine calls. The large shape: the
    64 × 14 640 waveform at the layer-0 format, float32 and bfloat16."""
    xs, widths = [], []
    for i, layer in enumerate(d["cnn"]["conv"]):
        q = d["qat"][f"layer{i}"]
        xs += [layer["w"], layer["b"]]
        widths += [(q["w_int"], q["w_frac"])] * 2
    n = sum(x.numel() for x in xs)
    b_ms, b_by = _bound(8 * n + 8 * len(xs), 5 * n)

    def many():             # the deploy path's call
        return Q.fixed_point_quantize_many(xs, widths)
    six = [lambda x=x, w=w: Q.fixed_point_quantize(x, *w)
           for x, w in zip(xs, widths)]
    libs = [_fake_quant(x, *w) for x, w in zip(xs, widths)]
    t_lib = (cuda_ms(lambda: [f() for f in libs], iters)
             if all(f is not None for f in libs) else None)
    six_dev = [_device_ms(f, "quant_kernel", warm=True) for f in six]
    out = {
        "ms": cuda_ms(many, iters), "launches": 1,
        "plain_ms": cuda_ms(lambda: Q_ref.fixed_point_quantize_many(
            xs, widths), iters),
        "library_ms": None, "library_six_calls_ms": t_lib,
        "device_ms": _device_ms(many, "quant_many_kernel", warm=True),
        "six_tensor_ms": cuda_ms(lambda: [f() for f in six], iters),
        "six_tensor_device_ms": (None if None in six_dev else sum(six_dev)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library": "none: no one PyTorch call quantizes six tensors at their "
                   "own widths (library_six_calls_ms: six calls of "
                   "torch.fake_quantize_per_tensor_affine)",
        "shape": f"the trained CNN's six tensors ({n} floats) at their "
                 f"layers' formats through quantize_params' call"}
    x = d["rx"]
    qi, qf = d["qat"]["layer0"]["w_int"], d["qat"]["layer0"]["w_frac"]
    lib = _fake_quant(x, qi, qf)
    large = {"shape": f"{x.shape[0]}x{x.shape[1]} floats at "
                      f"Q{int(qi)}.{int(qf)} (the layer-0 format)",
             "bound_ms": _bound(8 * x.numel(), 5 * x.numel())[0],
             "ms": cuda_ms(lambda: Q.fixed_point_quantize(x, qi, qf), iters),
             "plain_ms": cuda_ms(lambda: Q_ref.fixed_point_quantize(
                 x, qi, qf), iters),
             "library_ms": None if lib is None else cuda_ms(lib, iters),
             "library_max_abs_diff": None if lib is None else float(
                 (lib() - Q.fixed_point_quantize(x, qi, qf)).abs().max())}
    for name, xt in (("device_ms", x), ("bf16_device_ms",
                                        x.to(torch.bfloat16))):
        large[name] = _device_ms(
            lambda xt=xt: Q.fixed_point_quantize(xt, qi, qf),
            "quant_kernel", warm=True)
    out["large"] = large
    return out


# ---------------------------------------------------------------------------
# phase 8: LM serving (qwen3-0.6b) through the flash-attention kernel
# ---------------------------------------------------------------------------

def serve_lm(dev) -> dict:
    """The main path of this slice: `serve_session` at full width, one
    prefill of LM_BATCH × LM_PROMPT tokens and LM_GEN greedy decode steps,
    the flash-attention launch count zeroed before each and read after.
    A warm-up pass on a second cache comes first (cuBLAS handles, the
    kernel library's first load), outside the counted run."""
    cfg = LM_configs.get_config(LM_ARCH, tp=1, fused_attention=True)
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.qk_norm, cfg.dtype) ==
            (28, 1024, 16, 8, 128, 3072, 151936, True, "bfloat16"),
            f"{LM_ARCH} is not at full width: {cfg}")
    max_len = LM_PROMPT + LM_GEN
    t0 = time.perf_counter()
    model, params, state, prefill, decode = LM_serve.serve_session(
        cfg, LM_BATCH, LM_PROMPT, max_len, device=dev, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)
    warm = model.init_serve_state(LM_BATCH, max_len, dev)
    logits, warm = prefill(params, {"tokens": tokens}, warm)
    decode(params, logits.argmax(-1).to(torch.int32)[:, None], LM_PROMPT,
           warm)
    del warm
    torch.cuda.synchronize()

    FA.reset_launch_counts()
    t0 = time.perf_counter()
    logits, state = prefill(params, {"tokens": tokens}, state)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = FA.LAUNCHES["flash_attention"]
    require(prefill_launches == cfg.n_layers,
            f"prefill launched flash_attention {prefill_launches} times, "
            f"expected {cfg.n_layers} (one per layer)")
    require(all(n == 0 for k, n in FA.LAUNCHES.items()
                if k != "flash_attention"),
            f"prefill launched training kernels: {FA.LAUNCHES}")
    first = logits.clone()

    FA.reset_launch_counts()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(LM_GEN):
        tok, logits, state = decode(params, tok, LM_PROMPT + i, state)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = FA.LAUNCHES["flash_attention"]
    require(decode_launches == 0,
            f"decode launched flash_attention {decode_launches} times")
    out = torch.cat(generated, dim=1)
    require(first.shape == (LM_BATCH, cfg.vocab_padded) and bool(
        torch.isfinite(first.float()).all() and torch.isfinite(
            logits.float()).all()), "LM logits: wrong shape or non-finite")
    require(out.shape == (LM_BATCH, LM_GEN + 1) and bool(
        ((out >= 0) & (out < cfg.vocab)).all()), "LM tokens out of range")
    return {"cfg": cfg, "model": model, "params": params, "state": state,
            "tokens": tokens, "generated": out, "setup_s": setup_s,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": decode_s * 1e3 / LM_GEN,
            "decode_tokens_per_s": LM_BATCH * LM_GEN / decode_s,
            "launches": prefill_launches + decode_launches,
            "prefill_launches": prefill_launches,
            "decode_launches": decode_launches}


def layer0_qkv(run: dict):
    """Layer 0's q, k, v of the served prefill, recomputed by the port's
    own functions from the same weights and tokens; k and v must equal
    what the prefill wrote into layer 0's cache."""
    cfg, params, tokens = run["cfg"], run["params"], run["tokens"]
    lp = LM_tr._layer(params["layers"], 0)
    h = LM_tr.embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    q, k, v = LM_attn.qkv(lp["attn"], rms_norm(h, lp["attn_norm"]), cfg,
                          positions)
    s = tokens.shape[1]
    require(torch.equal(k, run["state"]["k"][0][:, :s]) and torch.equal(
        v, run["state"]["v"][0][:, :s]), "layer 0's k, v differ from the "
        "prefill's cache")
    return q, k, v


def check_flash(dev, q, k, v) -> dict:
    """The kernel against its plain version: the served layer 0 (bf16,
    rtol 1e-2 with atol 2e-2), then random inputs at non-aligned shapes
    and at the head-dim-64 shapes of [8h] and [8w] (reported apart)."""
    out = {}
    got = FA.flash_attention(q, k, v)
    want = FA_ref.flash_attention(q, k, v)
    diff = (got.float() - want.float()).abs()
    out["layer0_max_abs"] = float(diff.max())
    out["layer0_max_abs_v"] = float(v.float().abs().max())
    require(bool((diff <= 2e-2 + 1e-2 * want.float().abs()).all()),
            f"flash_attention on layer 0: kernel != plain (max |diff| "
            f"{out['layer0_max_abs']:.3e})")
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = {}
    for case in FLASH_CASES:
        b, sq, sk, h, hkv, d, causal, win, qoff = case
        for dt, tol in FLASH_TOL.items():
            qq, kk, vv = (torch.randn(sh, generator=gen, device=dev).to(dt)
                          for sh in ((b, sq, h, d), (b, sk, hkv, d),
                                     (b, sk, hkv, d)))
            g = FA.flash_attention(qq, kk, vv, causal, win, qoff)
            w = FA_ref.flash_attention(qq, kk, vv, causal, win, qoff)
            e = float((g.float() - w.float()).abs().max())
            require(g.dtype == dt and bool(torch.isfinite(g.float()).all())
                    and e <= tol, f"flash_attention {case} {dt}: max "
                    f"|diff| {e:.3e} > {tol}")
            key = str(dt).replace("torch.", "") + (" d64" if d == 64 else "")
            worst[key] = max(worst.get(key, 0.0), e)
    out["random_max_abs"] = worst
    return out


def check_lm_f32(dev, tokens: torch.Tensor) -> dict:
    """The whole model at full width in f32 (TF32 off), 1 × 2048 tokens:
    fused against the chunked plain prefill, and decode at position s − 1
    against a prefill over s tokens."""
    cfg = LM_configs.get_config(LM_ARCH, tp=1, fused_attention=True,
                                dtype="float32")
    fused = LM_registry.build(cfg)
    plain = LM_registry.build(LM_configs.get_config(
        LM_ARCH, tp=1, fused_attention=False, dtype="float32"))
    toks = tokens[:1]
    s = toks.shape[1]
    with fp32_exact():
        params = fused.init(torch.Generator(device=dev).manual_seed(1), dev)
        FA.reset_launch_counts()
        lf, _ = fused.prefill(params, {"tokens": toks},
                              fused.init_serve_state(1, s, dev))
        require(FA.LAUNCHES["flash_attention"] == cfg.n_layers,
                "f32 fused prefill did not launch the kernel per layer")
        lp, _ = plain.prefill(params, {"tokens": toks},
                              plain.init_serve_state(1, s, dev))
        _, st = fused.prefill(params, {"tokens": toks[:, :s - 1]},
                              fused.init_serve_state(1, s, dev))
        ld, _ = fused.decode(params, toks[:, s - 1:], s - 1, st)
        torch.cuda.synchronize()
    out = {"max_abs_logit": float(lf.abs().max()),
           "fused_vs_plain_max_abs": float((lf - lp).abs().max()),
           "decode_vs_prefill_max_abs": float((ld - lf).abs().max())}
    for key in ("fused_vs_plain_max_abs", "decode_vs_prefill_max_abs"):
        require(out[key] < LM_LOGIT_TOL, f"f32 {LM_ARCH}: {key} "
                f"{out[key]:.3e} >= {LM_LOGIT_TOL}")
    del params
    return out


def redesign_figures(t: dict, kern_f32, f32_name: str) -> dict:
    """What the bf16 tensor-core forward is read by: achieved TFLOP/s and
    the share of the bound, both from the device time; the factor against
    SDPA (CUDA events for both); the f32 instance's device time at the
    same shape (the FP32-FMA datapath, which the redesign left alone)."""
    dev_ms = t["device_ms"]
    return {"tflops": t["flops"] / dev_ms / 1e9 if dev_ms else None,
            "bound_share": t["bound_ms"] / dev_ms if dev_ms else None,
            "x_sdpa": t["ms"] / t["library_ms"],
            "f32_device_ms": _device_ms(kern_f32, f32_name, calls=3,
                                        warm=True)}


def time_flash(q, k, v, iters: int,
               what: str = f"{LM_ARCH} prefill, layer 0") -> dict:
    """Kernel (CUDA events and profiler device time), plain version,
    SDPA yardstick and bound at the serving shape."""
    b, sq, h, d = q.shape
    costs = FA.attention_costs(b, sq, k.shape[1], h, d, causal=True,
                               dtype_bytes=q.element_size())
    t_ops = costs["flops"] / PEAK_OPS_S["bf16"]
    t_bytes = costs["hbm_bytes"] / HBM_BYTES_S

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
    t_k = cuda_ms(lambda: FA.flash_attention(q, k, v), iters, warmup=3)
    t_p = cuda_ms(lambda: FA_ref.flash_attention(q, k, v), 5, warmup=1)
    t_l = cuda_ms(sdpa, iters)
    t_k2 = cuda_ms(lambda: FA.flash_attention(q, k, v), iters, warmup=3)
    lib_diff = float((sdpa().transpose(1, 2).float()
                      - FA.flash_attention(q, k, v).float()).abs().max())
    qf, kf, vf = q.float(), k.float(), v.float()
    out = {"ms": t_k, "ms_repeat": t_k2, "plain_ms": t_p, "library_ms": t_l,
           "device_ms": _device_ms(lambda: FA.flash_attention(q, k, v),
                                   FLASH_KERNEL[q.dtype], calls=10,
                                   warm=True),
           "bound_ms": max(t_ops, t_bytes) * 1e3, "flops": costs["flops"]}
    out.update(redesign_figures(
        out, lambda: FA.flash_attention(qf, kf, vf),
        FLASH_KERNEL[torch.float32]))
    return {**out,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "hbm_bytes": costs["hbm_bytes"],
            "library_max_abs_diff": lib_diff,
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) on (B, H, S, D) views",
            "shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} "
                     f"{str(q.dtype).replace('torch.', '')}, causal "
                     f"({what})"}


def trace_lm(run: dict, steps: int = 4) -> dict:
    """One prefill and `steps` decode steps of the served model under
    torch.profiler, on a fresh cache: device busy, idle share, top
    kernels."""
    model, params = run["model"], run["params"]
    st = model.init_serve_state(LM_BATCH, LM_PROMPT + steps,
                                run["tokens"].device)
    box = {}

    def prefill():
        box["logits"], box["st"] = model.prefill(
            params, {"tokens": run["tokens"]}, st)

    def decode():
        tok = box["logits"].argmax(-1).to(torch.int32)[:, None]
        for i in range(steps):
            logits, _ = model.decode(params, tok, LM_PROMPT + i, box["st"])
            tok = logits.argmax(-1).to(torch.int32)[:, None]
    return {"prefill": device_trace(prefill),
            f"decode_{steps}_steps": device_trace(decode)}


# ---------------------------------------------------------------------------
# phase 9: LM training (qwen3-0.6b) through the flash forward/backward kernels
# ---------------------------------------------------------------------------

def train_lm(dev) -> dict:
    """The main path of this slice: `launch.train.build` at full width and
    its train step, one warm-up step, then LM_TRAIN_STEPS timed steps of
    LM_TRAIN_ACCUM × (LM_TRAIN_MB × LM_TRAIN_SEQ) tokens from the
    reference's token stream. The launch counts are zeroed after the
    warm-up and each step's share of them is checked."""
    cfg = LM_configs.get_config(LM_ARCH, tp=1, fused_attention=True)
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.qk_norm, cfg.dtype,
             cfg.remat, cfg.train_accum) ==
            (28, 1024, 16, 8, 128, 3072, 151936, True, "bfloat16", True,
             LM_TRAIN_ACCUM), f"{LM_ARCH} is not at full width: {cfg}")
    t0 = time.perf_counter()
    init_state, step = LM_train.build(cfg, LM_TRAIN_LR, LM_TRAIN_ACCUM, dev)
    params, opt = init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batches = lm_batches(PipelineConfig(
        seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_MB * LM_TRAIN_ACCUM,
        accum=LM_TRAIN_ACCUM), cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, next(batches))
    warm_loss = float(m["loss"])
    warm_ms = (time.perf_counter() - t0) * 1e3
    n = cfg.n_layers
    want = {"flash_attention": 0,
            "flash_attention_fwd": 2 * n * LM_TRAIN_ACCUM,
            "flash_attention_bwd_dkv": n * LM_TRAIN_ACCUM,
            "flash_attention_bwd_dq": n * LM_TRAIN_ACCUM}
    FA.reset_launch_counts()
    losses, step_ms, host = [], [], []
    gc_box = {"ms": 0.0}

    def on_gc(phase, info):   # host time in Python's garbage collector
        if phase == "start":
            gc_box["t0"] = time.perf_counter()
        else:
            gc_box["ms"] += (time.perf_counter() - gc_box["t0"]) * 1e3
    gc.callbacks.append(on_gc)
    try:
        for i in range(LM_TRAIN_STEPS):
            batch = next(batches)
            torch.cuda.synchronize()
            before = dict(FA.LAUNCHES)
            mem0, gc0 = torch.cuda.memory_stats(), gc_box["ms"]
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            mem1 = torch.cuda.memory_stats()
            host.append({  # what else the step waited on
                "gc_ms": gc_box["ms"] - gc0,
                "device_mallocs": mem1.get("num_device_alloc", 0)
                - mem0.get("num_device_alloc", 0),
                "device_frees": mem1.get("num_device_free", 0)
                - mem0.get("num_device_free", 0),
                "alloc_retries": mem1["num_alloc_retries"]
                - mem0["num_alloc_retries"],
                "reserved_gib": mem1["reserved_bytes.all.current"] / 2 ** 30})
            got = {k: n - before[k] for k, n in FA.LAUNCHES.items()}
            require(got == want, f"train step {i} launched {got}, expected "
                                 f"{want}")
    finally:
        gc.callbacks.remove(on_gc)
    launches = dict(FA.LAUNCHES)
    require(bool(np.isfinite([warm_loss] + losses).all()),
            f"non-finite training loss: {[warm_loss] + losses}")
    require(int(opt.step) == LM_TRAIN_STEPS + 1, "optimizer step count")
    tokens = LM_TRAIN_ACCUM * LM_TRAIN_MB * LM_TRAIN_SEQ
    return {"cfg": cfg, "params": params, "opt": opt, "step": step,
            "batches": batches, "setup_s": setup_s, "warmup_ms": warm_ms,
            "losses": [warm_loss] + losses, "step_ms": step_ms,
            "mean_step_ms": float(np.mean(step_ms)),
            "median_step_ms": float(np.median(step_ms)),
            "step_host": host,
            "tokens_per_step": tokens,
            "tokens_per_s": tokens / (np.mean(step_ms) / 1e3),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches, "launches_per_step": want}


def train_layer0(run: dict, seed: int = 21):
    """Layer 0's q, k, v of the trained model on a fresh microbatch of the
    run's stream, and a seeded cotangent do, all bf16 at (4, 2048, ·)."""
    cfg, params = run["cfg"], run["params"]
    tokens = next(run["batches"])["tokens"][0]
    with torch.no_grad():
        lp = LM_tr._layer(params["layers"], 0)
        h = LM_tr.embed_tokens(params, tokens, cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        q, k, v = LM_attn.qkv(lp["attn"], rms_norm(h, lp["attn_norm"]), cfg,
                              positions)
    gen = torch.Generator(device=tokens.device).manual_seed(seed)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    return q, k, v, do


def _bwd_err(got, want, dtype) -> tuple:
    """(max |diff|, within the stated bound)."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return float(diff.max()), float(diff.max()) <= BWD_F32_TOL
    w = want.float().abs()
    ok = bool((diff <= BWD_BF16_RTOL * w
               + BWD_BF16_ATOL_REL * float(w.max())).all())
    return float(diff.max()), ok


def check_train_kernels(dev, q, k, v, do, causal=True, window=0,
                        q_offset=0) -> dict:
    """Each training kernel against its plain version on the same inputs:
    the forward with lse, then dK/dV and dQ from the plain forward's o and
    lse. Returns the max |diff| per output; raises past the bounds."""
    dt = q.dtype
    o, lse = FA.flash_attention_fwd(q, k, v, causal, window, q_offset)
    wo, wl = FA_ref.flash_attention_fwd(q, k, v, causal, window, q_offset)
    e_o = float((o.float() - wo.float()).abs().max())
    e_l = float((lse - wl).abs().max())
    o_ok = (e_o <= FLASH_TOL[dt] if dt == torch.float32 else bool(
        ((o.float() - wo.float()).abs()
         <= 2e-2 + 1e-2 * wo.float().abs()).all()))
    require(o_ok and e_l <= LSE_TOL and bool(torch.isfinite(lse).all()),
            f"flash_attention_fwd {tuple(q.shape)} {dt}: o {e_o:.3e}, "
            f"lse {e_l:.3e}")
    delta = FA_ref.attention_delta(wo, do)
    args = (causal, window, q_offset)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, wl, delta, *args)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, wl, delta, *args)
    wdk, wdv = FA_ref.flash_attention_bwd_dkv(q, k, v, do, wl, delta, *args)
    wdq = FA_ref.flash_attention_bwd_dq(q, k, v, do, wl, delta, *args)
    out = {"o": e_o, "lse": e_l}
    for name, got, want in (("dq", dq, wdq), ("dk", dk, wdk),
                            ("dv", dv, wdv)):
        e, ok = _bwd_err(got, want, dt)
        require(ok and got.dtype == dt and got.shape == want.shape,
                f"flash backward {name} {tuple(q.shape)} {dt}: max |diff| "
                f"{e:.3e} outside the bound")
        out[name] = e
    return out


def check_train_random(dev) -> dict:
    """The training kernels against their plain versions at random
    non-aligned shapes and [9h]'s head-dim-64 shape, f32 and bf16: worst
    max |diff| per dtype (head dim 64 apart)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = {}
    for b, sq, sk, h, hkv, d, win, qoff in TRAIN_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(sh, generator=gen, device=dev).to(dt)
                           for sh in ((b, sq, h, d), (b, sk, hkv, d),
                                      (b, sk, hkv, d), (b, sq, h, d)))
            errs = check_train_kernels(dev, q, k, v, do, window=win,
                                       q_offset=qoff)
            key = str(dt).replace("torch.", "") + (" d64" if d == 64 else "")
            for name, e in errs.items():
                worst.setdefault(key, {})
                worst[key][name] = max(worst[key].get(name, 0.0), e)
    return worst


def _loss_grads(model, params, toks):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss_fn(tree_unflatten(params, leaves),
                            {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads


def check_train_f32(dev, tokens: torch.Tensor) -> dict:
    """One f32 microbatch of 1 × LM_TRAIN_SEQ at full width (TF32 off):
    loss and every gradient leaf through the fused kernels against the
    chunked plain attention path, within the bounds stated above."""
    cfg = LM_configs.get_config(LM_ARCH, tp=1, fused_attention=True,
                                dtype="float32")
    fused = LM_registry.build(cfg)
    plain = LM_registry.build(LM_configs.get_config(
        LM_ARCH, tp=1, fused_attention=False, dtype="float32"))
    toks = tokens[:1]
    with fp32_exact():
        params = fused.init(torch.Generator(device=dev).manual_seed(2), dev)
        FA.reset_launch_counts()
        lf, gf = _loss_grads(fused, params, toks)
        counts = dict(FA.LAUNCHES)
        lp, gp = _loss_grads(plain, params, toks)
        torch.cuda.synchronize()
    n = cfg.n_layers
    require(counts == {"flash_attention": 0, "flash_attention_fwd": 2 * n,
                       "flash_attention_bwd_dkv": n,
                       "flash_attention_bwd_dq": n},
            f"f32 fused step launched {counts}")
    names = [name for name, _ in tree_named_leaves(params)]
    ratios = {name: float((a - b).abs().max()) / max(
        float(b.abs().max()), 1e-30) for name, a, b in zip(names, gf, gp)}
    worst = max(ratios, key=ratios.get)
    out = {"loss_fused": lf, "loss_plain": lp,
           "loss_abs_diff": abs(lf - lp), "worst_leaf": worst,
           "worst_grad_diff_over_max": ratios[worst],
           "wq_grad_max_abs": float(gf[names.index("layers/attn/wq")]
                                    .abs().max()),
           "grad_diff_over_max": ratios}
    require(out["loss_abs_diff"] < TRAIN_F32_LOSS_TOL,
            f"f32 loss fused {lf} vs plain {lp}")
    require(out["worst_grad_diff_over_max"] <= TRAIN_F32_GRAD_TOL,
            f"f32 gradient {worst}: max |fused − plain| / max |plain| "
            f"{ratios[worst]:.3e} > {TRAIN_F32_GRAD_TOL}")
    require(out["wq_grad_max_abs"] > 0, "no gradient reached wq")
    del params, gf, gp
    return out


def time_train_kernels(q, k, v, do, iters: int) -> dict:
    """At the training shape: each kernel's CUDA-event and profiler device
    time, its plain version's, its bound (its own products at the bf16
    tensor-core peak against its bytes at the HBM rate) and the library
    yardstick: F.scaled_dot_product_attention's forward for the forward,
    its backward through autograd (dq, dk and dv together) for the two
    backward kernels."""
    b, s, h, d = q.shape
    o, lse = FA.flash_attention_fwd(q, k, v)
    delta = FA_ref.attention_delta(o, do)
    product = FA.attention_costs(b, s, s, h, d)["flops"] / 2   # one QKᵀ
    el = q.element_size()
    qb, kb, rows = q.numel() * el, k.numel() * el, b * s * h * 4
    n_bytes = {   # each input read once, each output written once
        "flash_attention_fwd": qb + 2 * kb + qb + rows,
        "flash_attention_bwd_dkv": qb + 2 * kb + qb + 2 * rows + 2 * kb,
        "flash_attention_bwd_dq": qb + 2 * kb + qb + 2 * rows + qb,
    }
    calls = {
        "flash_attention_fwd": (lambda: FA.flash_attention_fwd(q, k, v),
                                lambda: FA_ref.flash_attention_fwd(q, k, v)),
        "flash_attention_bwd_dkv": (
            lambda: FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
            lambda: FA_ref.flash_attention_bwd_dkv(q, k, v, do, lse, delta)),
        "flash_attention_bwd_dq": (
            lambda: FA.flash_attention_bwd_dq(q, k, v, do, lse, delta),
            lambda: FA_ref.flash_attention_bwd_dq(q, k, v, do, lse, delta)),
    }
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    f32_calls = {   # the f32 instances (FP32 FMAs) at the same shape
        "flash_attention_fwd": lambda: FA.flash_attention_fwd(qf, kf, vf),
        "flash_attention_bwd_dkv": lambda: FA.flash_attention_bwd_dkv(
            qf, kf, vf, dof, lse, delta),
        "flash_attention_bwd_dq": lambda: FA.flash_attention_bwd_dq(
            qf, kf, vf, dof, lse, delta),
    }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    gt = do.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qt, kt, vt), gt,
                                   retain_graph=True)
    t_fwd = cuda_ms(sdpa_fwd, iters)
    t_bwd = cuda_ms(sdpa_bwd, iters)
    lib_dq, lib_dk, lib_dv = sdpa_bwd()
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    lib_diff = {n_: float((a.transpose(1, 2).float() - g.float()).abs()
                          .max()) for n_, a, g in (("dq", lib_dq, dq),
                                                   ("dk", lib_dk, dk),
                                                   ("dv", lib_dv, dv))}
    shape = (f"q/do {tuple(q.shape)}, k/v {tuple(k.shape)} "
             f"{str(q.dtype).replace('torch.', '')}, causal ({LM_ARCH} "
             f"training microbatch, layer 0)")
    out = {}
    for name, (kern, plain) in calls.items():
        _, _, products = TRAIN_KERNELS[name]
        t_ops = products * product / PEAK_OPS_S["bf16"]
        t_bytes = n_bytes[name] / HBM_BYTES_S
        t_k = cuda_ms(kern, iters, warmup=3)
        t_p = cuda_ms(plain, 3, warmup=1)
        t_k2 = cuda_ms(kern, iters, warmup=3)
        kernel_name, f32_name = TRAIN_KERNEL_NAMES[name]
        fwd = name == "flash_attention_fwd"
        out[name] = {
            "ms": t_k, "ms_repeat": t_k2, "plain_ms": t_p,
            "library_ms": t_fwd if fwd else t_bwd,
            "device_ms": _device_ms(kern, kernel_name, calls=10, warm=True),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": products * product, "bytes": n_bytes[name],
            "library": ("F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True) forward" if fwd else
                        "backward of F.scaled_dot_product_attention("
                        "is_causal=True, enable_gqa=True) through autograd "
                        "(dq, dk, dv together)"),
            "shape": shape}
        out[name].update(redesign_figures(out[name], f32_calls[name],
                                          f32_name))
    out["library_bwd_max_abs_diff"] = lib_diff
    return out


def fill_device_ms(row: dict, trace: dict, kernel: str, what: str) -> None:
    """A timing row whose own profiler session read nothing takes its
    kernel's mean device time from a profiled run of the main path at the
    same shape (``trace``, a `device_trace`), and says so."""
    if row["device_ms"] is not None:
        return
    hits = [v for k, v in trace["by_kind_ms"].items() if k.startswith(kernel)]
    if not hits:
        return
    row["device_ms"] = hits[0]["mean_ms"]
    row["device_ms_from"] = f"{what}: {hits[0]['count']} launches"
    if "tflops" in row:
        row["tflops"] = row["flops"] / row["device_ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["device_ms"]


def trace_train_step(run: dict) -> dict:
    """One full-width train step under torch.profiler, after one step in
    the profiler's warm-up window: wall, device busy, idle share, device
    time by kind and the top device activities."""
    box = {"params": run["params"], "opt": run["opt"]}
    batches = [next(run["batches"]) for _ in range(2)]

    def one(i):
        box["params"], box["opt"], m = run["step"](box["params"], box["opt"],
                                                   batches[i])
        box["loss"] = float(m["loss"])
    return device_trace(lambda: one(1), warmup=lambda: one(0))


def train_cli(dev) -> dict:
    """`launch.train`'s CLI run on the card at qwen3-0.6b widths and 2
    layers: a failure injected before step 2 and a checkpoint every step,
    into a temporary directory removed afterwards."""
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    argv = ["--device", str(dev), *LM_CLI_ARGS, "--ckpt-dir", ckpt_dir]
    try:
        t0 = time.perf_counter()
        out = LM_train.run(argv)
        wall = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in pathlib.Path(
            ckpt_dir, "step_00000003").iterdir())
        kept = sorted(p.name for p in pathlib.Path(ckpt_dir).iterdir())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    require(out["restarts"] == 1 and out["steps"] == 3,
            f"CLI run: {out['steps']} steps, {out['restarts']} restarts")
    require(len(out["losses"]) == 3 and bool(np.isfinite(
        out["losses"]).all()), f"CLI losses {out['losses']}")
    require(kept == ["step_00000001", "step_00000002", "step_00000003"],
            f"checkpoints kept: {kept}")
    return {"argv": " ".join(argv[:-1] + ["<tmp>"]), "wall_s": wall,
            "restarts": out["restarts"], "losses": out["losses"],
            "checkpoint_gb": ckpt_bytes / 1e9,
            "straggler": out["straggler"]}


# ---------------------------------------------------------------------------
# phase 10: xlstm serving (xlstm-125m) through the fused sLSTM kernel
# ---------------------------------------------------------------------------

def serve_xlstm(dev) -> dict:
    """The main path of this slice: `serve_session` for xlstm-125m at full
    width, one prefill of LM_BATCH × LM_PROMPT tokens and LM_GEN greedy
    decode steps, the kernels' launch counts zeroed before each and read
    after. A warm-up prefill and decode step on a second state come first,
    outside the counted run."""
    cfg = LM_configs.get_config(XL_ARCH, tp=1, fused_attention=True)
    require((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab,
             cfg.slstm_at, cfg.expand, cfg.d_conv, cfg.ssd_chunk,
             cfg.dtype) == ("ssm", 12, 768, 4, 50304, (3, 9), 2, 4, 64,
                            "bfloat16"),
            f"{XL_ARCH} is not at full width: {cfg}")
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, params, state, prefill, decode = LM_serve.serve_session(
        cfg, LM_BATCH, LM_PROMPT, LM_PROMPT + LM_GEN, device=dev, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    require(n_params == XL_PARAMS, f"{XL_ARCH}: {n_params} parameters, "
            f"expected {XL_PARAMS}")
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)
    logits, warm = prefill(params, {"tokens": tokens},
                           model.init_serve_state(LM_BATCH, 0, dev))
    decode(params, logits.argmax(-1).to(torch.int32)[:, None], LM_PROMPT,
           warm)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    n_slstm = len(cfg.slstm_at)
    FA.reset_launch_counts()
    SL.reset_launch_counts()
    t0 = time.perf_counter()
    logits, state = prefill(params, {"tokens": tokens}, state)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = SL.LAUNCHES["slstm_fused"]
    require(prefill_launches == n_slstm,
            f"prefill launched slstm_fused {prefill_launches} times, "
            f"expected {n_slstm} (one per sLSTM block)")
    require(SL.INSTANCE_LAUNCHES == {"cluster": n_slstm, "stream": 0,
                                     "bwd_cluster": 0, "bwd_stream": 0},
            f"prefill ran {SL.INSTANCE_LAUNCHES}, expected only the "
            f"cluster kernel")
    require(all(n == 0 for n in FA.LAUNCHES.values()),
            f"xlstm prefill launched flash kernels: {FA.LAUNCHES}")
    first, prefill_state = logits.clone(), state

    SL.reset_launch_counts()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(LM_GEN):
        tok, logits, state = decode(params, tok, LM_PROMPT + i, state)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = SL.LAUNCHES["slstm_fused"]
    require(decode_launches == n_slstm * LM_GEN,
            f"decode launched slstm_fused {decode_launches} times, expected "
            f"{n_slstm * LM_GEN} ({n_slstm} per step)")
    require(SL.INSTANCE_LAUNCHES == {"cluster": n_slstm * LM_GEN,
                                     "stream": 0, "bwd_cluster": 0,
                                     "bwd_stream": 0},
            f"decode ran {SL.INSTANCE_LAUNCHES}, expected only the cluster "
            f"kernel")
    require(all(n == 0 for n in FA.LAUNCHES.values()),
            f"xlstm decode launched flash kernels: {FA.LAUNCHES}")
    out = torch.cat(generated, dim=1)
    require(first.shape == (LM_BATCH, cfg.vocab_padded) and bool(
        torch.isfinite(first.float()).all() and torch.isfinite(
            logits.float()).all()), "xlstm logits: wrong shape or non-finite")
    require(out.shape == (LM_BATCH, LM_GEN + 1) and bool(
        ((out >= 0) & (out < cfg.vocab)).all()), "xlstm tokens out of range")
    return {"cfg": cfg, "model": model, "params": params,
            "prefill_state": prefill_state, "tokens": tokens,
            "generated": out, "setup_s": setup_s, "n_params": n_params, "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": decode_s * 1e3 / LM_GEN,
            "decode_tokens_per_s": LM_BATCH * LM_GEN / decode_s,
            "peak_mem_gib": (torch.cuda.max_memory_allocated() - base)
            / 2 ** 30,
            "launches": prefill_launches + decode_launches,
            "prefill_launches": prefill_launches,
            "decode_launches": decode_launches}


def block3_inputs(run: dict):
    """Block 3's (the first sLSTM block's) xg, r and starting state in the
    served prefill, recomputed by the port's own block functions from the
    same weights and tokens; the kernel on them must end in the state the
    prefill returned for block 3, bitwise."""
    cfg, params, model = run["cfg"], run["params"], run["model"]
    tokens = run["tokens"]
    i3 = cfg.slstm_at[0]
    states = model.init_serve_state(tokens.shape[0], 0, tokens.device)
    h = params["embed"][tokens].to(cfg.param_dtype())
    for i in range(i3):
        h, _ = XL.mlstm_block_apply(params["blocks"][i]["mlstm"], h, cfg,
                                    states[i])
    p = params["blocks"][i3]["slstm"]
    hc, _ = XL._conv_causal(rms_norm(h, p["norm"]), p["conv_w"],
                            p["conv_b"], states[i3]["conv"])
    xg = hc @ p["slstm_w"] + p["slstm_b"][None, None, :].to(hc.dtype)
    cell0 = tuple(states[i3]["cell"])
    _, got = SL.slstm_fused(xg, p["slstm_r"], cell0, cfg.n_heads)
    require(all(torch.equal(a, w) for a, w in
                zip(got, run["prefill_state"][i3]["cell"])),
            "block 3's recomputed xg does not reproduce the prefill's state")
    return xg, p["slstm_r"], cell0


def slstm_random(gen, b, s, nh, dh, x_dt, r_dt, r_scale=None,
                 f_offset=1.0):
    """Random sLSTM inputs on the card: xg 0.5·N with the model's forget
    offset (slstm_b puts 1 on f), r ~ N(0, r_scale²) (default 0.3/sqrt(dh):
    unit-order recurrent pre-activations at every dh), and a nonzero state
    (c ~ N, n ~ U(0.5, 2), h ~ 0.5·N, m ~ N)."""
    dev = gen.device
    d = nh * dh
    xg = 0.5 * torch.randn((b, s, 4, d), generator=gen, device=dev)
    xg[:, :, 2] += f_offset
    scale = 0.3 / np.sqrt(dh) if r_scale is None else r_scale
    r = scale * torch.randn((4, nh, dh, dh), generator=gen, device=dev)
    st = (torch.randn((b, d), generator=gen, device=dev),
          0.5 + 1.5 * torch.rand((b, d), generator=gen, device=dev),
          0.5 * torch.randn((b, d), generator=gen, device=dev),
          torch.randn((b, d), generator=gen, device=dev))
    return xg.reshape(b, s, 4 * d).to(x_dt), r.to(r_dt), st


def slstm_agreement(xg, r, st, nh: int, what: str) -> dict:
    """The kernel against its plain version (f32, TF32 off) and both
    against the plain version in float64, for hs and each state. Holds
    max |kernel − plain| ≤ max(SLSTM_ATOL, SLSTM_ENVELOPE · max |plain −
    float64|), and that the case is resolvable in f32 at all: max |plain −
    float64| ≤ SLSTM_RESOLVED · max(1, max |float64|); and that the kernel
    that ran is the one `_plan` names, which must be the library's own
    plan. Returns the errors."""
    b, _, d4 = xg.shape
    plan = SL._plan(b, nh, d4 // (4 * nh))
    lib_plan = SL._lib_plan(SL._lib(), b, nh, d4 // (4 * nh))
    require(lib_plan == plan, f"slstm_fused {what}: the library's plan "
            f"{lib_plan} is not _plan's {plan}")
    before = dict(SL.INSTANCE_LAUNCHES)
    with fp32_exact():
        got = SL.slstm_fused(xg, r, st, nh)
        want = SL_ref.slstm_fused(xg, r, st, nh)
        truth = SL_ref.slstm_fused(xg, r, st, nh, dtype=torch.float64)
    require(SL.INSTANCE_LAUNCHES[plan.instance]
            == before[plan.instance] + 1, f"slstm_fused {what}: the "
            f"{plan.instance} kernel did not run")
    out = {"instance": plan.instance}
    for name, g, w, t in zip(("hs", "c", "n", "h", "m"), (got[0], *got[1]),
                             (want[0], *want[1]), (truth[0], *truth[1])):
        require(g.dtype == torch.float32 and bool(torch.isfinite(g).all()),
                f"slstm_fused {what}: {name} not finite f32")
        kp = float((g - w).abs().max())
        p64 = float((w.double() - t).abs().max())
        k64 = float((g.double() - t).abs().max())
        mag = float(t.abs().max())
        require(p64 <= SLSTM_RESOLVED * max(1.0, mag),
                f"slstm_fused {what}: {name} is not resolvable in f32 "
                f"(plain vs float64 {p64:.3e} at |x| {mag:.3e})")
        bound = max(SLSTM_ATOL, SLSTM_ENVELOPE * p64)
        require(kp <= bound, f"slstm_fused {what}: {name} kernel vs plain "
                f"{kp:.3e} > {bound:.3e} (plain vs float64 {p64:.3e})")
        out[name] = {"kernel_vs_plain": kp, "plain_vs_f64": p64,
                     "kernel_vs_f64": k64, "max_abs": mag}
    return out


def check_slstm(dev, xg3, r3, cell3) -> dict:
    """[10b]: the kernel against its plain version on the served block 3
    and on random inputs at SLSTM_CASES in each input type; the split at
    SLSTM_SPLIT bitwise; and the conditioning of the reference test's
    r ~ 0.3·N at the serving shape (printed, not a check of the kernel)."""
    nh = r3.shape[1]
    out = {"block3": slstm_agreement(xg3, r3, cell3, nh, "block 3")}
    gen = torch.Generator(device=dev).manual_seed(13)
    worst: dict = {}
    for case in SLSTM_CASES:
        for x_dt in (torch.float32, torch.bfloat16):
            for r_dt in (torch.float32, torch.bfloat16):
                xg, r, st = slstm_random(gen, *case, x_dt, r_dt)
                errs = slstm_agreement(xg, r, st, case[2],
                                       f"{case} {x_dt} {r_dt}")
                key = f"{case} {errs.pop('instance')}"
                worst[key] = {n: max(worst.get(key, {}).get(n, 0.0),
                                     e["kernel_vs_plain"])
                              for n, e in errs.items()}
    out["random_kernel_vs_plain"] = worst
    out["forced_kernel_vs_plain"] = check_slstm_forced(gen)
    b, s, nh, dh = SLSTM_CASES[0]
    xg, r, st = slstm_random(gen, b, s, nh, dh, torch.bfloat16,
                             torch.bfloat16)
    full, fst = SL.slstm_fused(xg, r, st, nh)
    h1, st1 = SL.slstm_fused(xg[:, :SLSTM_SPLIT], r, st, nh)
    h2, st2 = SL.slstm_fused(xg[:, SLSTM_SPLIT:], r, st1, nh)
    require(torch.equal(torch.cat([h1, h2], 1), full) and all(
        torch.equal(a, w) for a, w in zip(st2, fst)),
        f"slstm_fused: split at {SLSTM_SPLIT} of {s} is not bitwise")
    out["split_bitwise"] = True
    xg, r, st = slstm_random(gen, b, s, nh, dh, torch.float32,
                             torch.float32, r_scale=0.3, f_offset=0.0)
    with fp32_exact():
        p32, _ = SL_ref.slstm_fused(xg, r, st, nh)
        p64, _ = SL_ref.slstm_fused(xg, r, st, nh, dtype=torch.float64)
    out["conditioning_r_0.3N"] = {
        "plain_f32_vs_f64_hs": float((p32.double() - p64).abs().max()),
        "max_abs_hs": float(p64.abs().max())}
    return out


def check_slstm_forced(gen) -> dict:
    """The cluster kernel through `slstm_cluster_launch` at the geometries
    of SLSTM_FORCED (bf16 xg and r), within SLSTM_ATOL of the plain version
    (short sequences: f32 resolves it)."""
    lib = SL._lib()
    out = {}
    for (b, s, nh, dh), (q, rb) in SLSTM_FORCED:
        xg, r, st = slstm_random(gen, b, s, nh, dh, torch.bfloat16,
                                 torch.bfloat16)
        hs = torch.empty((b, s, nh * dh), device=xg.device)
        fin = tuple(torch.empty_like(t) for t in st)
        with fp32_exact():
            rc = SL._launch_cluster(lib, q, rb, xg, r, st, hs, fin,
                                    torch.cuda.current_stream().cuda_stream)
            want = SL_ref.slstm_fused(xg, r, st, nh)
        torch.cuda.synchronize()
        require(rc == 0, f"slstm cluster kernel at Q = {q}, RB = {rb}, "
                f"{(b, s, nh, dh)}: launch failed with {rc}")
        err = max(float((g - w).abs().max()) for g, w in
                  zip((hs, *fin), (want[0], *want[1])))
        require(err <= SLSTM_ATOL, f"slstm cluster kernel at Q = {q}, RB = "
                f"{rb}, {(b, s, nh, dh)}: {err:.3e} > {SLSTM_ATOL}")
        out[f"{(b, s, nh, dh)} Q {q} RB {rb}"] = err
    return out


def check_xlstm_f32(dev, tokens: torch.Tensor) -> dict:
    """[10c]: the whole model in f32 at full width (TF32 off), seed 0: the
    card's prefill logits over 1 × XL_F32_TOKENS tokens against the same
    weights run on the host (device="cpu", the plain versions); and decode
    at position s − 1 after an (s − 1)-token prefill against an s-token
    prefill's last logits, on the card."""
    cfg = LM_configs.get_config(XL_ARCH, tp=1, dtype="float32")
    model = LM_registry.build(cfg)
    cpu = torch.device("cpu")
    toks = tokens[:1]
    s = toks.shape[1]
    short = toks[:, :XL_F32_TOKENS]
    with fp32_exact():
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        SL.reset_launch_counts()
        lc, _ = model.prefill(params, {"tokens": short},
                              model.init_serve_state(1, 0, dev))
        require(SL.LAUNCHES["slstm_fused"] == len(cfg.slstm_at),
                "f32 prefill did not launch the kernel per sLSTM block")
        lf, _ = model.prefill(params, {"tokens": toks},
                              model.init_serve_state(1, 0, dev))
        _, st = model.prefill(params, {"tokens": toks[:, :s - 1]},
                              model.init_serve_state(1, 0, dev))
        ld, _ = model.decode(params, toks[:, s - 1:], s - 1, st)
        torch.cuda.synchronize()
    host = interop.tree_map(lambda t: t.to(cpu), params)
    del params
    t0 = time.perf_counter()
    with torch.no_grad():
        lh, _ = model.prefill(host, {"tokens": short.to(cpu)},
                              model.init_serve_state(1, 0, cpu))
    host_s = time.perf_counter() - t0
    out = {"max_abs_logit": float(lc.abs().max()),
           "card_vs_host_max_abs": float((lc.cpu() - lh).abs().max()),
           "decode_vs_prefill_max_abs": float((ld - lf).abs().max()),
           "host_prefill_s": host_s}
    for key in ("card_vs_host_max_abs", "decode_vs_prefill_max_abs"):
        require(out[key] < LM_LOGIT_TOL, f"f32 {XL_ARCH}: {key} "
                f"{out[key]:.3e} >= {LM_LOGIT_TOL}")
    return out


def time_slstm(xg, r, st, iters: int) -> dict:
    """[10d]: the kernel's call time (CUDA events) on the served block 3's
    inputs at the serving shape, the plain version's time (a Python loop
    over S steps: few calls), and the bound from `slstm_costs`. Its device
    time comes from the profiled prefill (`trace_xlstm`), at the same
    shape: a short profiler session right after [6a]'s 20 k-event trace
    recorded none of its kernel events. No single PyTorch call computes an
    sLSTM (`nn.LSTM` is another cell), so there is no library time."""
    b, s, _ = xg.shape
    _, nh, dh, _ = r.shape
    costs = SL.slstm_costs(b, s, nh, dh, xg.dtype, r.dtype)
    plan = SL._plan(b, nh, dh)
    fits = ctypes.c_int(-1)
    hs = torch.empty((b, s, nh * dh), device=xg.device)
    fin = tuple(torch.empty_like(t) for t in st)
    require(SL._launch_cluster(SL._lib(), plan.q, plan.rb, xg, r, st, hs,
                               fin, 0, fits) == 0,
            "slstm: the occupancy query failed")
    t_ops = costs["flops"] / PEAK_OPS_S["fp32"]
    t_bytes = costs["bytes"] / HBM_BYTES_S
    with fp32_exact():
        t_k = cuda_ms(lambda: SL.slstm_fused(xg, r, st, nh), iters,
                      warmup=3)
        t_p = cuda_ms(lambda: SL_ref.slstm_fused(xg, r, st, nh), 3,
                      warmup=1)
        t_k2 = cuda_ms(lambda: SL.slstm_fused(xg, r, st, nh), iters,
                       warmup=3)
    return {"ms": t_k, "ms_repeat": t_k2, "plain_ms": t_p,
            "us_per_step": t_k * 1e3 / s, "instance": plan.instance,
            "q": plan.q, "rb": plan.rb, "clusters": nh * -(-b // plan.rb),
            "max_active_clusters": fits.value,
            "library_ms": None, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": costs["flops"], "bytes": costs["bytes"],
            "dependent_steps": s,
            "library": "none: no single PyTorch call computes the sLSTM "
                       "(nn.LSTM is another cell)",
            "shape": f"xg {tuple(xg.shape)} "
                     f"{str(xg.dtype).replace('torch.', '')}, r "
                     f"{tuple(r.shape)} "
                     f"{str(r.dtype).replace('torch.', '')} ({XL_ARCH} "
                     f"prefill, block 3)"}


def trace_xlstm(run: dict, steps: int = 4) -> dict:
    """One prefill and `steps` decode steps of the served model under
    torch.profiler, each after a warm-up run in the profiler's schedule:
    device busy, idle share, top kernels, and the sLSTM kernel's device ms
    per launch and share of the prefill's device time."""
    model, params, tokens = run["model"], run["params"], run["tokens"]
    dev = tokens.device
    box = {}

    def prefill():
        box["logits"], box["st"] = model.prefill(
            params, {"tokens": tokens}, model.init_serve_state(
                LM_BATCH, 0, dev))

    def decode():
        tok = box["logits"].argmax(-1).to(torch.int32)[:, None]
        st = box["st"]
        for i in range(steps):
            logits, st = model.decode(params, tok, LM_PROMPT + i, st)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
    pre = device_trace(prefill, warmup=prefill)
    sl = [v for k, v in pre["by_kind_ms"].items()
          if k.startswith("slstm_kernel")]
    n_sl, sl_ms = sum(v["count"] for v in sl), sum(v["total_ms"] for v in sl)
    pre["slstm_device_ms"] = sl_ms / n_sl if n_sl else None
    pre["slstm_share_of_busy"] = (sl_ms / pre["device_busy_ms"]
                                  if pre["device_busy_ms"] else None)
    return {"prefill": pre,
            f"decode_{steps}_steps": device_trace(decode, warmup=decode)}


# ---------------------------------------------------------------------------
# phase 9x: xlstm training through the sLSTM forward and backward kernels
# ---------------------------------------------------------------------------

def train_xlstm(dev) -> dict:
    """The main path of this part: `launch.train.build` on xlstm-125m at
    full width and its train step, one warm-up step, then XL_TRAIN_STEPS
    timed steps of LM_TRAIN_ACCUM × (LM_TRAIN_MB × LM_TRAIN_SEQ) tokens from
    the reference's token stream. The counts are zeroed after the warm-up;
    each step must launch the forward kernel twice per sLSTM block and
    micro-batch (remat) and the backward kernel once."""
    cfg = LM_configs.get_config(XL_ARCH, tp=1)
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, tuple(cfg.slstm_at),
             cfg.vocab, cfg.dtype, cfg.remat, cfg.train_accum) ==
            (12, 768, 4, (3, 9), 50304, "bfloat16", True, LM_TRAIN_ACCUM),
            f"{XL_ARCH} is not at full width: {cfg}")
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    init_state, step = LM_train.build(cfg, LM_TRAIN_LR, LM_TRAIN_ACCUM, dev)
    params, opt = init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batches = lm_batches(PipelineConfig(
        seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_MB * LM_TRAIN_ACCUM,
        accum=LM_TRAIN_ACCUM), cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, next(batches))
    losses = [float(m["loss"])]
    warm_ms = (time.perf_counter() - t0) * 1e3
    n = len(cfg.slstm_at)
    want = {"slstm_fused": 2 * n * LM_TRAIN_ACCUM,
            "slstm_fused_bwd": n * LM_TRAIN_ACCUM}
    want_inst = {"cluster": want["slstm_fused"], "stream": 0,
                 "bwd_cluster": want["slstm_fused_bwd"], "bwd_stream": 0}
    SL.reset_launch_counts()
    step_ms = []
    for i in range(XL_TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        before, before_inst = dict(SL.LAUNCHES), dict(SL.INSTANCE_LAUNCHES)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in SL.LAUNCHES.items()}
        got_inst = {k: v - before_inst[k]
                    for k, v in SL.INSTANCE_LAUNCHES.items()}
        require(got == want and got_inst == want_inst,
                f"xlstm train step {i} launched {got} {got_inst}, "
                f"expected {want} {want_inst}")
    launches = dict(SL.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(bool(np.isfinite(losses).all()) and losses[-1] <= losses[0],
            f"xlstm training loss not finite or rising: {losses}")
    require(int(opt.step) == XL_TRAIN_STEPS + 1, "optimizer step count")
    tokens = LM_TRAIN_ACCUM * LM_TRAIN_MB * LM_TRAIN_SEQ
    # one micro-batch a profiled step (the mLSTM chunk loop makes ~90 000
    # device events of a micro-batch); warm-up inside the schedule
    batch = interop.tree_map(lambda t: t[:1], next(batches))
    box = {"p": params, "o": opt}

    def one():
        box["p"], box["o"], _ = step(box["p"], box["o"], batch)
    trace = device_trace(one, warmup=one)
    return {"cfg": cfg, "params": params, "batches": batches,
            "setup_s": setup_s, "warmup_ms": warm_ms, "losses": losses,
            "step_ms": step_ms, "mean_step_ms": float(np.mean(step_ms)),
            "median_step_ms": float(np.median(step_ms)),
            "tokens_per_step": tokens,
            "tokens_per_s": tokens / (np.mean(step_ms) / 1e3),
            "peak_mem_gib": peak,
            "peak_added_gib": peak - base / 2 ** 30, "launches": launches,
            "launches_per_step": want, "trace": trace}


def train_block3(run: dict, seed: int = 23):
    """Block 3's (the first sLSTM block's) params in f32, its input h on a
    fresh micro-batch of the run's stream (the trained blocks before it,
    training form), and the xg the block hands its recurrence."""
    cfg, params = run["cfg"], run["params"]
    tokens = next(run["batches"])["tokens"][0]
    i3 = cfg.slstm_at[0]
    with torch.no_grad():
        h = params["embed"][tokens].to(cfg.param_dtype())
        for i in range(i3):
            h, _ = XL.mlstm_block_apply(params["blocks"][i]["mlstm"], h,
                                        cfg)
        p = params["blocks"][i3]["slstm"]
        hc, _ = XL._conv_causal(rms_norm(h, p["norm"]), p["conv_w"],
                                p["conv_b"])
        xg = hc @ p["slstm_w"] + p["slstm_b"][None, None, :].to(hc.dtype)
    cell0 = tuple(XL.slstm_block_state(cfg, tokens.shape[0],
                                       tokens.device)["cell"])
    return xg, p, h, cell0


def check_slstm_bwd(dev, xg, p, h, cell0, nh: int) -> dict:
    """[9x]: the backward's planned kernel (the cluster kernel, the plan
    held to the library's) and the stream kernel forced, each against
    `ref.slstm_fused_bwd` (f32, TF32 off) and a float64 run of it, on block
    3's trained xg (bf16) and r (bf16) with a seeded cotangent; two
    launches of each bitwise; then slstm_r's and slstm_w's gradients
    through the block in f32, the kernel path (`models.xlstm.slstm_scan`)
    against autograd through the plain loop."""
    gen = torch.Generator(device=dev).manual_seed(29)
    r = p["slstm_r"]
    b, s, d4 = xg.shape
    dh = d4 // (4 * nh)
    plan = SL._plan_bwd(b, nh, dh)
    require(plan.instance == "bwd_cluster" and plan == SL._lib_plan_bwd(
        SL._lib_bwd(), b, nh, dh), f"slstm_fused_bwd plan {plan}")
    dhs = torch.randn((b, s, d4 // 4), generator=gen, device=dev)
    zero = tuple(torch.zeros_like(t) for t in cell0)
    runs = {"cluster": lambda: SL.slstm_fused_bwd(xg, r, cell0, nh, hs, dhs,
                                                  zero),
            "stream": lambda: SL._forced_bwd("stream", xg, r, cell0, nh, hs,
                                             dhs, zero)}
    with torch.no_grad(), fp32_exact():
        hs, _ = SL.slstm_fused(xg, r, cell0, nh)
        before = dict(SL.INSTANCE_LAUNCHES)
        got = {k: (f(), f()) for k, f in runs.items()}
        want = SL_ref.slstm_fused_bwd(xg, r, cell0, nh, hs, dhs, zero)
        truth = SL_ref.slstm_fused_bwd(xg, r, cell0, nh, hs, dhs, zero,
                                       dtype=torch.float64)
    torch.cuda.synchronize()
    require(SL.INSTANCE_LAUNCHES["bwd_cluster"] == before["bwd_cluster"] + 2
            and SL.INSTANCE_LAUNCHES["bwd_stream"] == before["bwd_stream"]
            + 2, f"slstm_fused_bwd ran {SL.INSTANCE_LAUNCHES}, expected "
            f"two launches of each kernel")
    out = {"plan": plan._asdict(), "repeat": "bitwise"}
    names = ("dxg", "dr", "dc0", "dn0", "dh0", "dm0")
    for kind, (one, again) in got.items():
        require(all(torch.equal(a, c) for a, c in zip(
            (one[0], one[1], *one[2]), (again[0], again[1], *again[2]))),
            f"slstm_fused_bwd ({kind}): two launches differ")
        for name, g, w, t in zip(names, (one[0], one[1], *one[2]),
                                 (want[0].to(xg.dtype), want[1].to(r.dtype),
                                  *want[2]),
                                 (truth[0], truth[1], *truth[2])):
            g, w = g.double(), w.double()
            require(bool(torch.isfinite(g).all()),
                    f"slstm_fused_bwd ({kind}): {name} not finite")
            kp = float((g - w).abs().max())
            p64 = float((w - t).abs().max())
            mag = float(t.abs().max())
            bound = max(SLSTM_ATOL * max(1.0, mag), SLSTM_ENVELOPE * p64)
            require(kp <= bound, f"slstm_fused_bwd ({kind}) block 3: {name}"
                    f" kernel vs plain {kp:.3e} > {bound:.3e} (plain vs "
                    f"float64 {p64:.3e}, max |x| {mag:.3e})")
            row = {"kernel_vs_plain": kp, "plain_vs_f64": p64,
                   "kernel_vs_f64": float((g - t).abs().max()),
                   "max_abs": mag, "bound": bound}
            if kind == "cluster":
                out[name] = row
            else:
                out.setdefault("stream", {})[name] = row
    # the block's slstm_r / slstm_w gradients: the kernel path (f32)
    # against autograd through the plain loop, in f32 and in float64, over
    # the whole sequence and over its first XL_GRAD_PREFIX steps
    with torch.no_grad():    # the block's conv output, f32 (exact in f64)
        hc32, _ = XL._conv_causal(rms_norm(h.float(), p["norm"].float()),
                                  p["conv_w"].float(), p["conv_b"].float())

    def block_grads(steps: int, use_kernel: bool, dtype=torch.float32):
        leaves = {k: p[k].to(dtype).detach().requires_grad_(True)
                  for k in ("slstm_r", "slstm_w")}
        xg_ = (hc32[:, :steps].to(dtype) @ leaves["slstm_w"]
               + p["slstm_b"].to(dtype)[None, None, :])
        if use_kernel:
            hs_, _ = XL.slstm_scan({"slstm_r": leaves["slstm_r"]}, xg_, nh,
                                   cell0)
        else:
            hs_, _ = SL_ref.slstm_fused(xg_, leaves["slstm_r"], cell0, nh,
                                        dtype=dtype)
        loss = (hs_ * dhs[:, :steps].to(dtype)).sum()
        return [g_.detach() for g_ in torch.autograd.grad(
            loss, [leaves["slstm_r"], leaves["slstm_w"]])]

    for steps, tag in ((s, "grad"), (XL_GRAD_PREFIX, "grad_prefix")):
        with fp32_exact():
            before = SL.LAUNCHES["slstm_fused_bwd"]
            kern = block_grads(steps, True)
            require(SL.LAUNCHES["slstm_fused_bwd"] == before + 1,
                    "the block's backward did not launch the kernel")
            plain = block_grads(steps, False)
            truth = block_grads(steps, False, torch.float64)
        torch.cuda.synchronize()
        for name, g, w, t in zip(("slstm_r", "slstm_w"), kern, plain, truth):
            scale = float(t.abs().max())
            err = float((g - w).abs().max())
            p64 = float((w.double() - t).abs().max())
            bound = (XL_GRAD_TOL * scale if tag == "grad_prefix"
                     else max(XL_GRAD_TOL * scale, SLSTM_ENVELOPE * p64))
            require(scale > 0 and float(g.abs().max()) > 0,
                    f"{name}: zero gradient")
            require(err <= bound, f"{name} over {steps} steps: kernel path "
                    f"vs plain {err:.3e} > {bound:.3e} (plain vs float64 "
                    f"{p64:.3e}, max |leaf| {scale:.3e})")
            out[f"{tag}_{name}"] = {
                "steps": steps, "kernel_vs_plain": err, "plain_vs_f64": p64,
                "kernel_vs_f64": float((g.double() - t).abs().max()),
                "max_abs": scale, "bound": bound}
    return out


def time_slstm_bwd(xg, r, cell0, nh: int, iters: int) -> dict:
    """[9x]: the backward's call time (CUDA events: the pre recompute, the
    kernel, dr's einsum) and device time (profiler) on block 3's trained
    inputs, through the plan (the cluster kernel) and with the stream
    kernel forced, in turns (cluster, stream, stream, cluster); the plain
    reverse loop's time, and the bound from `slstm_bwd_costs`. No single
    PyTorch call computes it."""
    b, s, d4 = xg.shape
    dh = d4 // (4 * nh)
    gen = torch.Generator(device=xg.device).manual_seed(31)
    dhs = torch.randn((b, s, d4 // 4), generator=gen, device=xg.device)
    zero = tuple(torch.zeros_like(t) for t in cell0)
    with torch.no_grad():
        hs, _ = SL.slstm_fused(xg, r, cell0, nh)
    costs = SL.slstm_bwd_costs(b, s, nh, dh, r.dtype)
    t_ops = costs["flops"] / PEAK_OPS_S["fp32"]
    t_bytes = costs["bytes"] / HBM_BYTES_S

    plan = SL._plan_bwd(b, nh, dh)

    def kern():
        return SL.slstm_fused_bwd(xg, r, cell0, nh, hs, dhs, zero)

    def stream():
        return SL._forced_bwd("stream", xg, r, cell0, nh, hs, dhs, zero)
    with torch.no_grad(), fp32_exact():
        t_k = cuda_ms(kern, iters, warmup=2)
        t_s = cuda_ms(stream, max(1, iters // 3), warmup=1)
        t_s2 = cuda_ms(stream, max(1, iters // 3), warmup=0)
        t_k2 = cuda_ms(kern, iters, warmup=0)
        t_p = cuda_ms(lambda: SL_ref.slstm_fused_bwd(
            xg, r, cell0, nh, hs, dhs, zero), 1, warmup=1)
        dev_ms = _device_ms(kern, "slstm_bwd_kernel_cluster<", calls=3,
                            warm=True)
        s_dev = _device_ms(stream, "slstm_bwd_kernel<", calls=3, warm=True)
    return {"ms": t_k, "ms_repeat": t_k2, "plain_ms": t_p,
            "device_ms": dev_ms, "instance": plan.instance, "q": plan.q,
            "rb": plan.rb,
            "us_per_step": None if dev_ms is None else dev_ms * 1e3 / s,
            "stream_ms": t_s, "stream_ms_repeat": t_s2,
            "stream_device_ms": s_dev,
            "stream_us_per_step": None if s_dev is None else s_dev * 1e3 / s,
            "library_ms": None, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": costs["flops"], "bytes": costs["bytes"],
            "library": "none: no single PyTorch call computes the sLSTM's "
                       "backward",
            "shape": f"xg {tuple(xg.shape)} "
                     f"{str(xg.dtype).replace('torch.', '')}, r "
                     f"{tuple(r.shape)} "
                     f"{str(r.dtype).replace('torch.', '')} ({XL_ARCH} "
                     f"train micro-batch, block 3)"}


# ---------------------------------------------------------------------------
# phase 8m: MoE serving (moonshot-v1-16b-a3b) at full width, cut in depth
# ---------------------------------------------------------------------------

def serve_moe(dev) -> dict:
    """`serve_family` on moonshot-v1-16b-a3b at full width with its depth
    cut to MOE_LAYERS: one prefill of LM_BATCH × LM_PROMPT tokens and
    LM_GEN greedy decode steps, MOE_LAYERS flash launches in the prefill,
    none in the decode."""
    cfg = LM_configs.get_config(MOE_ARCH, tp=1, fused_attention=True,
                                n_layers=MOE_LAYERS)
    full = LM_configs.get_config(MOE_ARCH)
    require((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.n_experts,
             cfg.top_k, cfg.d_ff, cfg.vocab, cfg.dtype, full.n_layers) ==
            (2048, 16, 16, 64, 6, 1408, 163840, "bfloat16", 48),
            f"{MOE_ARCH} is not at full width: {cfg}")
    run = serve_family(dev, cfg, family_batch(cfg, LM_BATCH, LM_PROMPT, dev),
                       LM_GEN, cfg.n_layers)
    del run["params"], run["model"]
    return run


def check_moe_f32(dev, tokens: torch.Tensor) -> dict:
    """[8m]: f32 at full width and MOE_F32_LAYERS layers, 1 × MOE_F32_TOKENS
    tokens (TF32 off): the card's logits at every position against the
    same weights on the host in f32 and in float64 (the chunked plain
    attention; the flash kernels take f32 and bf16), each host run routed
    as the card routed. A token's dispatch slot depends on every other
    token's choices in its group (the rank-0 choices of all tokens fill
    the experts before any rank-1 choice), so one near-tie resolved the
    other way would move tokens between slots; the host therefore takes
    the card's top-k indices (with its own probabilities at them), and the
    choices its own top-k would have made differently are counted. Held:
    card vs host f32 <= max(LM_LOGIT_TOL, MOE_F32_ENVELOPE × host f32 vs
    float64)."""
    from repro_torch.models import mlp as LM_mlp
    cfg = LM_configs.get_config(MOE_ARCH, tp=1, fused_attention=True,
                                n_layers=MOE_F32_LAYERS, dtype="float32")
    cfg64 = dataclasses.replace(cfg, dtype="float64",
                                fused_attention=False)
    model = LM_registry.build(cfg)
    toks = tokens[:1, :MOE_F32_TOKENS]
    cpu = torch.device("cpu")
    top_k = LM_mlp._top_k
    card_idx: list = []
    differ = {"float32": 0, "float64": 0}

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        card_idx.append(idx.cpu())
        return vals, idx

    def replaying(probs, k):
        idx = card_idx[replaying.calls % len(card_idx)]
        replaying.calls += 1
        differ[str(probs.dtype).replace("torch.", "")] += int(
            (top_k(probs, k)[1] != idx).sum())
        return probs.gather(-1, idx), idx
    replaying.calls = 0
    try:
        with torch.no_grad(), fp32_exact():
            params = model.init(torch.Generator(device=dev).manual_seed(1),
                                dev)
            FA.reset_launch_counts()
            LM_mlp._top_k = recording
            lc, _ = LM_tr.forward(params, toks, cfg)
            torch.cuda.synchronize()
            require(FA.LAUNCHES["flash_attention"] == cfg.n_layers,
                    "f32 MoE forward did not launch flash per layer")
            host = interop.tree_map(lambda t: t.to(cpu), params)
            del params
            LM_mlp._top_k = replaying
            t0 = time.perf_counter()
            lh, _ = LM_tr.forward(host, toks.to(cpu), cfg)
            host_s = time.perf_counter() - t0
            host = interop.tree_map(lambda t: t.double(), host)
            l64, _ = LM_tr.forward(host, toks.to(cpu), cfg64)
            del host
    finally:
        LM_mlp._top_k = top_k
    require(len(card_idx) == cfg.n_layers
            and replaying.calls == 2 * cfg.n_layers,
            "MoE routing not recorded and replayed per layer")
    lc = lc.cpu()
    host_f64 = float((lh.double() - l64).abs().max())
    bound = max(LM_LOGIT_TOL, MOE_F32_ENVELOPE * host_f64)
    out = {"max_abs_logit": float(l64.abs().max()),
           "card_vs_host_max_abs": float((lc - lh).abs().max()),
           "host_f32_vs_f64_max_abs": host_f64,
           "card_vs_f64_max_abs": float((lc.double() - l64).abs().max()),
           "bound": bound,
           "choices": int(sum(t.numel() for t in card_idx)),
           "host_choices_that_differ": differ, "host_forward_s": host_s}
    require(out["card_vs_host_max_abs"] <= bound,
            f"f32 {MOE_ARCH}: card vs host {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phases 8v, 8h, 8w, 9h: the VLM, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

def transformer_params(cfg) -> int:
    """The parameter count a dense transformer config implies: embed and
    head, final norm, and per layer two norms, attention (q and o over
    the padded q heads, k and v over kv_eff) and a gated MLP."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    hq, kv = SHARD.resolve_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    layer = 2 * d + 2 * d * hq * hd + 2 * d * kv * hd + 3 * d * f
    return 2 * cfg.vocab_padded * d + d + cfg.n_layers * layer


def family_batch(cfg, b: int, s: int, dev, seed: int = 7) -> dict:
    """Tokens (b, s) and the family's stub input, ~ VLM_PREFIX_STD · N from
    a seeded card generator: the image prefix (b, img_tokens, d) of a VLM
    or the frames (b, enc_len, d) of an encdec model, in the param dtype."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev)}
    return dict(batch, **LM_registry.stub_inputs(
        cfg, (b,), dev, make=lambda shape: (VLM_PREFIX_STD * torch.randn(
            shape, generator=gen, device=dev)).to(cfg.param_dtype())))


def serve_family(dev, cfg, batch: dict, gen: int, flash_prefill: int
                 ) -> dict:
    """`serve_session` for ``cfg``: one prefill of ``batch`` and ``gen``
    greedy decode steps at the global positions (a VLM's prefix shifts
    them), a warm-up prefill and decode step on a second state first. The
    flash counts are zeroed before the prefill and before the decode: the
    prefill must launch `flash_attention` ``flash_prefill`` times and no
    training kernel, the decode none."""
    b, prompt = batch["tokens"].shape
    start = LM_serve.prefix_len(cfg) + prompt
    max_len = start + gen
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, params, state, prefill, decode = LM_serve.serve_session(
        cfg, b, prompt, max_len, device=dev, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm = model.init_serve_state(b, max_len, dev)
    logits, warm = prefill(params, batch, warm)
    decode(params, logits.argmax(-1).to(torch.int32)[:, None], start, warm)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    FA.reset_launch_counts()
    t0 = time.perf_counter()
    logits, state = prefill(params, batch, state)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    want = {k: (flash_prefill if k == "flash_attention" else 0)
            for k in FA.LAUNCHES}
    require(FA.LAUNCHES == want, f"{cfg.name} prefill launched "
            f"{FA.LAUNCHES}, expected {want}")
    first = logits.clone()
    FA.reset_launch_counts()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(gen):
        tok, logits, state = decode(params, tok, start + i, state)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    require(all(n == 0 for n in FA.LAUNCHES.values()),
            f"{cfg.name} decode launched {FA.LAUNCHES}")
    out = torch.cat(generated, dim=1)
    require(first.shape == (b, cfg.vocab_padded) and bool(
        torch.isfinite(first.float()).all()
        and torch.isfinite(logits.float()).all()),
        f"{cfg.name} logits: wrong shape or not finite")
    # greedy decode takes the argmax over the padded vocabulary, as the
    # reference's does (whisper pads 51866 to 51968)
    require(bool(((out >= 0) & (out < cfg.vocab_padded)).all()),
            f"{cfg.name} tokens out of range")
    peak = torch.cuda.max_memory_allocated()
    return {"cfg": cfg, "model": model, "params": params, "batch": batch,
            "setup_s": setup_s, "n_params": LM_registry.param_count(params),
            "first_decode_pos": start, "max_len": max_len,
            "prefill_ms": prefill_s * 1e3,
            "prefill_tokens_per_s": b * start / prefill_s,
            "decode_ms_per_step": decode_s * 1e3 / gen,
            "decode_tokens_per_s": b * gen / decode_s,
            "peak_mem_gib": peak / 2 ** 30,
            "peak_added_gib": (peak - base) / 2 ** 30,
            "prefill_launches": flash_prefill, "decode_launches": 0,
            "generated": out}


def trace_prefill(run: dict) -> dict:
    """One prefill of the served batch under torch.profiler on a fresh
    state, a prefill in the profiler's warm-up step first: idle share,
    device time by kind, top activities."""
    model, params, batch = run["model"], run["params"], run["batch"]
    b = batch["tokens"].shape[0]

    def one():
        model.prefill(params, batch,
                      model.init_serve_state(b, run["max_len"],
                                             batch["tokens"].device))
    return device_trace(one, warmup=one)


FAMILY_FORWARD = {   # family → logits at every position, training form
    "vlm": lambda p, b, c: LM_tr.forward(
        p, b["tokens"], c, embed_prefix=b["embed_prefix"])[0],
    "hybrid": lambda p, b, c: ZB.forward(p, b["tokens"], c),
    "encdec": lambda p, b, c: WH.decode_train(
        p, b["tokens"], WH.encode(p, b["enc_embed"], c), c),
}


def check_family_f32(dev, cfg, batch: dict, flash: int) -> dict:
    """f32 at full width (TF32 off), seed 1: the card's logits at every
    position of ``batch`` without its last token (the fused forward,
    ``flash`` launches of the serving kernel) against the same weights on
    the host; and on the card decode at the position after that prefix (a
    VLM's image prefix shifts it) against a prefill of the whole batch.

    Each is held to LM_LOGIT_TOL where f32 resolves it. Where the card
    vs host distance is above it, a float64 run of the forward on the
    host measures f32's own distance on that function, and the bound
    (``bound``) is max(LM_LOGIT_TOL, F32_ENVELOPE x host f32 vs float64).
    Where decode vs prefill is above it, the host runs the same decode
    and prefill in f32 and in float64: the bound (``decode_bound``) is
    max(LM_LOGIT_TOL, F32_ENVELOPE x the larger of the host's f32 decode
    vs float64 decode and f32 prefill vs float64 prefill), and the
    float64 decode vs prefill must agree within F64_CONSISTENCY_TOL."""
    model = LM_registry.build(cfg)
    fwd = FAMILY_FORWARD[cfg.family]
    n = batch["tokens"].shape[1] - 1
    short = dict(batch, tokens=batch["tokens"][:, :n])
    start = LM_serve.prefix_len(cfg) + n
    cpu = torch.device("cpu")
    cfg64 = dataclasses.replace(cfg, dtype="float64", fused_attention=False)

    def decode_and_prefill(m, params, full, sub, dev_):
        _, st = m.prefill(params, sub, m.init_serve_state(1, start + 1, dev_))
        ld, _ = m.decode(params, full["tokens"][:, n:], start, st)
        lf, _ = m.prefill(params, full, m.init_serve_state(1, start + 1,
                                                           dev_))
        return ld, lf

    def gap(a, b) -> float:
        return float((a.double() - b.double()).abs().max())

    with torch.no_grad(), fp32_exact():
        params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
        FA.reset_launch_counts()
        lc = fwd(params, short, cfg)
        torch.cuda.synchronize()
        require(FA.LAUNCHES["flash_attention"] == flash,
                f"f32 {cfg.name} forward launched {FA.LAUNCHES}, expected "
                f"{flash} flash_attention")
        dvp = gap(*decode_and_prefill(model, params, batch, short, dev))
        torch.cuda.synchronize()
        host = interop.tree_map(lambda t: t.to(cpu), params)
        del params
        hb = {k: v.to(cpu) for k, v in batch.items()}
        hshort = dict(hb, tokens=hb["tokens"][:, :n])
        t0 = time.perf_counter()
        lh = fwd(host, hshort, cfg)
        host_s = time.perf_counter() - t0
        lc = lc.cpu()
        out = {"max_abs_logit": float(lh.abs().max()),
               "card_vs_host_max_abs": gap(lc, lh), "bound": LM_LOGIT_TOL,
               "decode_pos": start, "decode_vs_prefill_max_abs": dvp,
               "decode_bound": LM_LOGIT_TOL, "host_forward_s": host_s}
        host64 = (interop.tree_map(lambda t: t.double(), host)
                  if max(out["card_vs_host_max_abs"], dvp) > LM_LOGIT_TOL
                  else None)
        if out["card_vs_host_max_abs"] > LM_LOGIT_TOL:
            l64 = fwd(host64, hshort, cfg64)
            out["host_f32_vs_f64_max_abs"] = gap(lh, l64)
            out["card_vs_f64_max_abs"] = gap(lc, l64)
            out["bound"] = max(LM_LOGIT_TOL, F32_ENVELOPE
                               * out["host_f32_vs_f64_max_abs"])
        if dvp > LM_LOGIT_TOL:
            hd, hf = decode_and_prefill(model, host, hb, hshort, cpu)
            d64, f64 = decode_and_prefill(LM_registry.build(cfg64), host64,
                                          hb, hshort, cpu)
            out["host_f32_decode_vs_f64_max_abs"] = gap(hd, d64)
            out["host_f32_prefill_vs_f64_max_abs"] = gap(hf, f64)
            out["host_f32_decode_vs_prefill_max_abs"] = gap(hd, hf)
            out["host_f64_decode_vs_prefill_max_abs"] = gap(d64, f64)
            require(out["host_f64_decode_vs_prefill_max_abs"]
                    <= F64_CONSISTENCY_TOL, f"float64 {cfg.name}: decode "
                    f"vs prefill {json.dumps(out)}")
            out["decode_bound"] = max(LM_LOGIT_TOL, F32_ENVELOPE * max(
                out["host_f32_decode_vs_f64_max_abs"],
                out["host_f32_prefill_vs_f64_max_abs"]))
        del host, host64
    require(out["card_vs_host_max_abs"] <= out["bound"],
            f"f32 {cfg.name}: card vs host {json.dumps(out)}")
    require(out["decode_vs_prefill_max_abs"] <= out["decode_bound"],
            f"f32 {cfg.name}: decode vs prefill {json.dumps(out)}")
    return out


def serve_vlm(dev) -> dict:
    """[8v]: llava-next-34b at full width, VLM_LAYERS of 60 layers."""
    cfg = LM_configs.get_config(VLM_ARCH, tp=1, fused_attention=True,
                                n_layers=VLM_LAYERS)
    full = LM_configs.get_config(VLM_ARCH)
    require((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
             cfg.d_ff, cfg.vocab, cfg.img_tokens, cfg.dtype, full.n_layers)
            == (7168, 56, 8, 128, 20480, 64000, 2880, "bfloat16", 60),
            f"{VLM_ARCH} is not at full width: {cfg}")
    run = serve_family(dev, cfg, family_batch(cfg, LM_BATCH, LM_PROMPT, dev),
                       LM_GEN, cfg.n_layers)
    want = transformer_params(cfg)
    require(run["n_params"] == want, f"{VLM_ARCH} at {VLM_LAYERS} layers: "
            f"{run['n_params']} parameters, the config implies {want}")
    require(run["first_decode_pos"] == cfg.img_tokens + LM_PROMPT,
            "VLM decode does not start after the image prefix")
    run["n_params_full"] = transformer_params(full)
    return run


def check_vlm_f32(dev) -> dict:
    cfg = LM_configs.get_config(
        VLM_ARCH, tp=1, fused_attention=True, n_layers=VLM_F32_LAYERS,
        img_tokens=VLM_F32_IMG, dtype="float32")
    return check_family_f32(dev, cfg, family_batch(
        cfg, 1, VLM_F32_TEXT + 1, dev, seed=9), cfg.n_layers)


def serve_hybrid(dev) -> dict:
    """[8h]: zamba2-1.2b at full width and depth."""
    cfg = LM_configs.get_config(HY_ARCH, tp=1, fused_attention=True)
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
             cfg.expand, cfg.ssm_head, cfg.ssm_state, cfg.d_ff, cfg.vocab,
             cfg.ssd_chunk, cfg.dtype) ==
            (38, 2048, 32, 64, 2, 64, 64, 8192, 32000, 64, "bfloat16"),
            f"{HY_ARCH} is not at full width: {cfg}")
    apps = len(ZB.attn_points(cfg))
    run = serve_family(dev, cfg, family_batch(cfg, LM_BATCH, LM_PROMPT, dev),
                       LM_GEN, apps)
    require(run["n_params"] == HY_PARAMS, f"{HY_ARCH}: {run['n_params']} "
            f"parameters, expected {HY_PARAMS}")
    return run


def check_hybrid_f32(dev) -> dict:
    cfg = LM_configs.get_config(HY_ARCH, tp=1, fused_attention=True,
                                n_layers=HY_F32_LAYERS, dtype="float32")
    return check_family_f32(dev, cfg, family_batch(
        cfg, 1, HY_F32_TOKENS + 1, dev, seed=9), len(ZB.attn_points(cfg)))


def serve_encdec(dev) -> dict:
    """[8w]: whisper-large-v3 at full width and depth; the encoder alone
    timed after the run (host clock around a synchronised call)."""
    cfg = LM_configs.get_config(ED_ARCH, tp=1, fused_attention=True)
    require((cfg.n_layers, cfg.enc_layers, cfg.d_model, cfg.n_heads,
             cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.vocab_padded,
             cfg.enc_len, cfg.rope_theta, cfg.mlp_act, cfg.dtype) ==
            (32, 32, 1280, 20, 64, 5120, 51866, 51968, 1500, 0.0, "gelu",
             "bfloat16"), f"{ED_ARCH} is not at full width: {cfg}")
    run = serve_family(dev, cfg, family_batch(cfg, LM_BATCH, ED_PROMPT, dev),
                       ED_GEN, cfg.n_layers)
    require(run["n_params"] == ED_PARAMS, f"{ED_ARCH}: {run['n_params']} "
            f"parameters, expected {ED_PARAMS}")
    enc_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        WH.encode(run["params"], run["batch"]["enc_embed"], cfg)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    run["encoder_ms"] = enc_ms[-1]
    run["decoder_prefill_ms"] = run["prefill_ms"] - enc_ms[-1]
    return run


def check_encdec_f32(dev) -> dict:
    cfg = LM_configs.get_config(ED_ARCH, tp=1, fused_attention=True,
                                n_layers=ED_F32_LAYERS,
                                enc_layers=ED_F32_LAYERS, dtype="float32")
    return check_family_f32(dev, cfg, family_batch(
        cfg, 1, ED_F32_TOKENS + 1, dev, seed=9), cfg.n_layers)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _alloc_site(frames) -> str:
    """The innermost frame of the port or this script, as file:line fn."""
    for f in frames:
        name = f["filename"]
        if "repro_torch" in name or name.endswith("chip_smoke.py"):
            return f"{pathlib.Path(name).name}:{f['line']} {f['name']}"
    return "elsewhere"


def peak_breakdown(fn, top: int = 10) -> dict:
    """What is live on the card at the peak of one call of fn, from the
    allocator's recorded history (python frames): the bytes allocated
    before the call, the peak the history replays to, and the largest
    groups of the allocations the call made that are live at that peak,
    by the innermost frame of the port or this script (GiB, count)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=8_000_000,
                                             stacks="python")
    try:
        fn()
        torch.cuda.synchronize()
        events = torch.cuda.memory._snapshot()["device_traces"][
            torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    sign = {"alloc": 1, "free_completed": -1}
    cur, peak, peak_at = base, base, -1
    for n, ev in enumerate(events):
        cur += sign.get(ev["action"], 0) * ev["size"]
        if cur > peak:
            peak, peak_at = cur, n
    live = {}
    for ev in events[:peak_at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    groups = {}
    for ev in live.values():
        g = groups.setdefault(_alloc_site(ev["frames"]), [0, 0])
        g[0] += ev["size"]
        g[1] += 1
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])
    return {"before_gib": base / 2 ** 30, "peak_gib": peak / 2 ** 30,
            "events": len(events),
            "added_live_at_peak_gib": sum(g[0] for g in groups.values())
            / 2 ** 30,
            "top": [[site, round(b / 2 ** 30, 3), c]
                    for site, (b, c) in ranked[:top]]}


def train_hybrid(dev) -> dict:
    """[9h]: `launch.train.build` on zamba2-1.2b at full width and depth
    and its train step, one warm-up step, then HY_TRAIN_STEPS timed steps
    of LM_TRAIN_ACCUM × (LM_TRAIN_MB × LM_TRAIN_SEQ) tokens from the
    reference's stream. The counts are zeroed after the warm-up; each step
    must launch the flash forward-with-lse twice per application of the
    shared block and micro-batch (remat), each backward kernel once, and
    the serving kernel never. Then one more step under the allocator's
    history (`peak_breakdown`) and one profiled micro-batch step."""
    cfg = LM_configs.get_config(HY_ARCH, tp=1, fused_attention=True)
    require((cfg.n_layers, cfg.d_model, cfg.remat, cfg.dtype) ==
            (38, 2048, True, "bfloat16"), f"{HY_ARCH}: {cfg}")
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    init_state, step = LM_train.build(cfg, LM_TRAIN_LR, LM_TRAIN_ACCUM, dev)
    params, opt = init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    static = {"params_gib": _tree_bytes(params) / 2 ** 30,
              "adam_moments_gib": (_tree_bytes(opt.mu)
                                   + _tree_bytes(opt.nu)) / 2 ** 30,
              "f32_gradient_sums_gib": 4 * LM_registry.param_count(params)
              / 2 ** 30}
    batches = lm_batches(PipelineConfig(
        seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_MB * LM_TRAIN_ACCUM,
        accum=LM_TRAIN_ACCUM), cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, next(batches))
    losses = [float(m["loss"])]
    warm_ms = (time.perf_counter() - t0) * 1e3
    apps = len(ZB.attn_points(cfg))
    want = {"flash_attention": 0,
            "flash_attention_fwd": 2 * apps * LM_TRAIN_ACCUM,
            "flash_attention_bwd_dkv": apps * LM_TRAIN_ACCUM,
            "flash_attention_bwd_dq": apps * LM_TRAIN_ACCUM}
    FA.reset_launch_counts()
    step_ms = []
    for i in range(HY_TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        before = dict(FA.LAUNCHES)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: n - before[k] for k, n in FA.LAUNCHES.items()}
        require(got == want, f"{HY_ARCH} train step {i} launched {got}, "
                f"expected {want}")
    launches = dict(FA.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(bool(np.isfinite(losses).all()) and losses[-1] <= losses[0],
            f"{HY_ARCH} training loss not finite or rising: {losses}")
    require(int(opt.step) == HY_TRAIN_STEPS + 1, "optimizer step count")
    tokens = LM_TRAIN_ACCUM * LM_TRAIN_MB * LM_TRAIN_SEQ
    box = {"p": params, "o": opt}
    del params, opt
    # what is live at the peak of one more whole step
    whole = next(batches)

    def full():
        box["p"], box["o"], _ = step(box["p"], box["o"], whole)
    breakdown = dict(peak_breakdown(full), **static)
    # one micro-batch a profiled step (the SSD chunk loop makes tens of
    # thousands of device events of a micro-batch); warm-up in the schedule
    batch = interop.tree_map(lambda t: t[:1], next(batches))

    def one():
        box["p"], box["o"], _ = step(box["p"], box["o"], batch)
    trace = device_trace(one, warmup=one)
    del box, batches, whole
    return {"cfg": cfg, "setup_s": setup_s, "warmup_ms": warm_ms,
            "losses": losses, "step_ms": step_ms,
            "mean_step_ms": float(np.mean(step_ms)),
            "median_step_ms": float(np.median(step_ms)),
            "tokens_per_step": tokens,
            "tokens_per_s": tokens / (np.mean(step_ms) / 1e3),
            "peak_mem_gib": peak / 2 ** 30,
            "peak_added_gib": (peak - base) / 2 ** 30,
            "launches": launches, "launches_per_step": want,
            "peak_breakdown": breakdown, "trace": trace}


def check_hybrid_grads(dev) -> dict:
    """[9h]: f32 at full width (TF32 off), HY_F32_LAYERS layers, 1 ×
    HY_F32_TOKENS tokens: the loss's gradient with the shared block's
    attention through the flash kernels (`_FusedCausal`, both
    applications) against the plain path on the same weights. The shared
    block's attn and mlp leaves and mamba layer HY_GRAD_LAYER's in_proj
    and A_log: nonzero and within HY_GRAD_TOL · max|leaf|; the loss within
    TRAIN_F32_LOSS_TOL."""
    cfg = LM_configs.get_config(HY_ARCH, tp=1, fused_attention=True,
                                n_layers=HY_F32_LAYERS, dtype="float32")
    plain = LM_registry.build(dataclasses.replace(cfg,
                                                  fused_attention=False))
    fused = LM_registry.build(cfg)
    toks = family_batch(cfg, 1, HY_F32_TOKENS, dev, seed=11)["tokens"]
    apps = len(ZB.attn_points(cfg))
    with fp32_exact():
        params = fused.init(torch.Generator(device=dev).manual_seed(2), dev)
        FA.reset_launch_counts()
        lf, gf = _loss_grads(fused, params, toks)
        counts = dict(FA.LAUNCHES)
        lp, gp = _loss_grads(plain, params, toks)
        torch.cuda.synchronize()
    require(counts == {"flash_attention": 0, "flash_attention_fwd": 2 * apps,
                       "flash_attention_bwd_dkv": apps,
                       "flash_attention_bwd_dq": apps},
            f"f32 fused {HY_ARCH} step launched {counts}")
    names = [name for name, _ in tree_named_leaves(params)]
    held = [n for n in names if n.startswith(("shared/attn/", "shared/mlp/"))]
    out = {"loss_fused": lf, "loss_plain": lp, "loss_abs_diff": abs(lf - lp)}
    for name in held + ["layers/mamba/in_proj", "layers/mamba/A_log"]:
        a, b = gf[names.index(name)], gp[names.index(name)]
        if name.startswith("layers/"):
            a, b, name = a[HY_GRAD_LAYER], b[HY_GRAD_LAYER], \
                f"{name}[{HY_GRAD_LAYER}]"
        scale = float(b.abs().max())
        out[name] = {"max_abs": float(a.abs().max()),
                     "diff_over_max": float((a - b).abs().max())
                     / max(scale, 1e-30)}
        require(out[name]["max_abs"] > 0 and scale > 0,
                f"{HY_ARCH}: no gradient reached {name}")
        require(out[name]["diff_over_max"] <= HY_GRAD_TOL,
                f"{HY_ARCH} gradient {name}: {out[name]}")
    require(out["loss_abs_diff"] < TRAIN_F32_LOSS_TOL,
            f"f32 {HY_ARCH} loss fused {lf} vs plain {lp}")
    del params, gf, gp
    return out


def time_flash_hd64(dev) -> dict:
    """The flash forward at the two head-dim-64 prefill shapes the new
    families give it (bf16, causal, seeded random q, k, v): zamba2's
    shared block (LM_BATCH, LM_PROMPT, 32, 64) and whisper's decoder
    (LM_BATCH, ED_PROMPT, 20, 64); `time_flash`'s figures beside SDPA."""
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for what, (s, h) in (("zamba2 prefill", (LM_PROMPT, 32)),
                         ("whisper decoder prefill", (ED_PROMPT, 20))):
        q, k, v = (torch.randn((LM_BATCH, s, h, 64), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out[what] = time_flash(q, k, v, iters=50, what=what)
        del q, k, v
    return out


# ---------------------------------------------------------------------------
# [17] the sharded launch on the card
# ---------------------------------------------------------------------------

def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _leaf_gap(got, want) -> dict:
    """Leaf by leaf: whether two trees are bitwise equal, and the worst
    max |Δ| / max |leaf|."""
    worst, bitwise = 0.0, True
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g = _whole(g)
        bitwise &= bool(torch.equal(g, w))
        scale = float(w.float().abs().max()) or 1.0
        worst = max(worst, float((g.float() - w.float()).abs().max())
                    / scale)
    return {"bitwise": bitwise, "max_diff_over_max_leaf": worst}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sharded_train(dev, mesh) -> dict:
    """[17] the train cell: one step of make_lowerable's sharded train
    step and one of launch.train.build's, from the same seeded weights,
    AdamW state and micro-batches, each called twice (the second timed
    again); the flash counts zeroed before each path's first call."""
    low = LM_steps.make_lowerable(LM_ARCH, SHARD_TRAIN, mesh,
                                  lr=LM_TRAIN_LR,
                                  cfg_overrides=SHARD_OVERRIDES)
    cfg = low.cfg
    require((cfg.n_layers, cfg.d_model, cfg.train_accum, cfg.tp,
             cfg.fused_attention) == (28, 1024, LM_TRAIN_ACCUM, 1, True),
            f"[17] {LM_ARCH} train cell not at full width: {cfg}")
    init_state, step = LM_train.build(cfg, LM_TRAIN_LR, LM_TRAIN_ACCUM, dev)
    params, opt = init_state()
    batch = next(lm_batches(PipelineConfig(
        seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_MB * LM_TRAIN_ACCUM,
        accum=LM_TRAIN_ACCUM), cfg, dev))
    dbatch = low.place(2, batch)
    runs = {"unsharded": lambda: step(params, opt, batch),
            "sharded": lambda: low.fn(low.args[0], low.args[1], dbatch)}
    out, launches, ms = {}, {}, {}
    for name, fn in runs.items():
        FA.reset_launch_counts()
        out[name], first = _timed(fn)
        launches[name] = dict(FA.LAUNCHES)
        ms[name] = {"first": first, "again": _timed(fn)[1]}
        torch.cuda.empty_cache()
    n = cfg.n_layers
    want = {"flash_attention": 0,
            "flash_attention_fwd": 2 * n * LM_TRAIN_ACCUM,
            "flash_attention_bwd_dkv": n * LM_TRAIN_ACCUM,
            "flash_attention_bwd_dq": n * LM_TRAIN_ACCUM}
    require(launches["sharded"] == launches["unsharded"] == want,
            f"[17] train launches {launches}, each should be {want}")
    (p1, o1, m1), (p2, o2, m2) = out["unsharded"], out["sharded"]
    loss1, loss2 = float(m1["loss"]), float(_whole(m2["loss"]))
    gap = _leaf_gap(p2, p1)
    require(abs(loss2 - loss1) <= LM_LOGIT_TOL * abs(loss1)
            and gap["max_diff_over_max_leaf"] <= SHARD_PARAM_TOL,
            f"[17] sharded train step differs: loss {loss2} vs {loss1}, "
            f"{gap}")
    opt_gap = _leaf_gap(o2.mu, o1.mu)
    return {"ms": ms, "launches": launches,
            "loss": {"unsharded": loss1, "sharded": loss2},
            "params_after_step": gap, "adam_mu_after_step": opt_gap,
            "tokens": SHARD_TRAIN.global_batch * SHARD_TRAIN.seq_len}


def sharded_serve(dev, mesh) -> dict:
    """[17] the serving cell: make_lowerable's decode cell (its params and
    its LM_PROMPT + LM_GEN-position state) runs a prefill of [8]'s
    tokens, then LM_GEN greedy decode steps; launch.serve.serve_session
    does the same unsharded from the same seeded weights. The sharded
    decode is fed the unsharded path's tokens, so each step compares one
    function on the same inputs."""
    low = LM_steps.make_lowerable(LM_ARCH, SHARD_SERVE, mesh,
                                  cfg_overrides=SHARD_OVERRIDES)
    cfg = low.cfg
    dparams, _, _, dstate = low.args
    prefill = LM_steps.build_prefill_step(LM_registry.build(cfg))
    _, params, state, p_prefill, p_decode = LM_serve.serve_session(
        cfg, LM_BATCH, LM_PROMPT, LM_PROMPT + LM_GEN, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)
    dtokens = LM_steps.place({"tokens": tokens},
                             {"tokens": low.specs[1]}, mesh)
    res = {"ms": {}, "launches": {}}
    FA.reset_launch_counts()
    (l1, state), res["ms"]["prefill_unsharded"] = _timed(
        lambda: p_prefill(params, {"tokens": tokens}, state))
    res["launches"]["prefill_unsharded"] = FA.LAUNCHES["flash_attention"]
    FA.reset_launch_counts()
    (l2, dstate), res["ms"]["prefill_sharded"] = _timed(
        lambda: prefill(dparams, dtokens, dstate))
    res["launches"]["prefill_sharded"] = FA.LAUNCHES["flash_attention"]
    # each prefill again (the caches are rewritten with the same values):
    # a first call pays one-time costs (DTensor's sharding rules, cuBLAS)
    for name, fn in (("unsharded", lambda: p_prefill(
            params, {"tokens": tokens}, state)), ("sharded", lambda: prefill(
                dparams, dtokens, dstate))):
        res["ms"][f"prefill_{name}_again"] = _timed(fn)[1]
    require(res["launches"]["prefill_sharded"]
            == res["launches"]["prefill_unsharded"] == cfg.n_layers,
            f"[17] prefill flash launches {res['launches']}, each should "
            f"be {cfg.n_layers}")
    l2 = _whole(l2)
    scale = float(l1.float().abs().max())
    res["prefill"] = {"bitwise": bool(torch.equal(l1, l2)),
                      "max_abs_diff": float((l1.float() - l2.float())
                                            .abs().max()),
                      "bound": LM_LOGIT_TOL * scale}
    require(res["prefill"]["max_abs_diff"] <= res["prefill"]["bound"],
            f"[17] sharded prefill logits differ: {res['prefill']}")
    tok = torch.argmax(l1, dim=-1).to(torch.int32)[:, None]
    toks, worst, bitwise = [tok], 0.0, True
    FA.reset_launch_counts()
    t_plain = t_shard = 0.0
    for i in range(LM_GEN):
        (nxt, lp, state), ms1 = _timed(
            lambda: p_decode(params, tok, LM_PROMPT + i, state))
        dtok = LM_steps.place(tok, low.specs[1], mesh)
        (_, ls, dstate), ms2 = _timed(
            lambda: low.fn(dparams, dtok, LM_PROMPT + i, dstate))
        t_plain, t_shard = t_plain + ms1, t_shard + ms2
        ls = _whole(ls)
        bitwise &= bool(torch.equal(lp, ls))
        worst = max(worst, float((lp.float() - ls.float()).abs().max())
                    / float(lp.float().abs().max()))
        tok = nxt
        toks.append(tok)
    require(FA.LAUNCHES["flash_attention"] == 0,
            f"[17] decode launched flash_attention {FA.LAUNCHES}")
    require(worst <= LM_LOGIT_TOL, f"[17] sharded decode logits differ: "
                                   f"{worst} x max|logits|")
    res["decode"] = {"bitwise": bitwise, "max_diff_over_max": worst}
    res["ms"]["decode_per_step_unsharded"] = t_plain / LM_GEN
    res["ms"]["decode_per_step_sharded"] = t_shard / LM_GEN
    return res


def sharded_xlstm(dev, mesh) -> dict:
    """[17b] one sharded xlstm-125m train step (make_lowerable, [17]'s
    train cell) against one of launch.train.build's from the same weights
    and micro-batches; the sLSTM counts zeroed before each: [9x]'s per
    step, all the cluster kernels."""
    over = {"tp": 1}
    low = LM_steps.make_lowerable(XL_ARCH, SHARD_TRAIN, mesh,
                                  lr=LM_TRAIN_LR, cfg_overrides=over)
    cfg = low.cfg
    init_state, step = LM_train.build(cfg, LM_TRAIN_LR, LM_TRAIN_ACCUM, dev)
    params, opt = init_state()
    batch = next(lm_batches(PipelineConfig(
        seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_MB * LM_TRAIN_ACCUM,
        accum=LM_TRAIN_ACCUM), cfg, dev))
    dbatch = low.place(2, batch)
    n = len(cfg.slstm_at)
    want = {"slstm_fused": 2 * n * LM_TRAIN_ACCUM,
            "slstm_fused_bwd": n * LM_TRAIN_ACCUM}
    want_inst = {"cluster": want["slstm_fused"], "stream": 0,
                 "bwd_cluster": want["slstm_fused_bwd"], "bwd_stream": 0}
    out, launches, ms = {}, {}, {}
    for name, fn in (("unsharded", lambda: step(params, opt, batch)),
                     ("sharded", lambda: low.fn(low.args[0], low.args[1],
                                                dbatch))):
        SL.reset_launch_counts()
        out[name], ms[name] = _timed(fn)
        launches[name] = {**SL.LAUNCHES, **SL.INSTANCE_LAUNCHES}
        require(dict(SL.LAUNCHES) == want
                and dict(SL.INSTANCE_LAUNCHES) == want_inst,
                f"[17b] {name} xlstm step launched {launches[name]}, "
                f"expected {want} {want_inst}")
    (p1, _, m1), (p2, _, m2) = out["unsharded"], out["sharded"]
    loss1, loss2 = float(m1["loss"]), float(_whole(m2["loss"]))
    gap = _leaf_gap(p2, p1)
    require(abs(loss2 - loss1) <= LM_LOGIT_TOL * abs(loss1)
            and gap["max_diff_over_max_leaf"] <= SHARD_PARAM_TOL,
            f"[17b] sharded xlstm step differs: loss {loss2} vs {loss1}, "
            f"{gap}")
    return {"ms": ms, "launches": launches,
            "loss": {"unsharded": loss1, "sharded": loss2},
            "params_after_step": gap}


def sharded_lm(dev) -> dict:
    """[17] and [17b] on a one-rank NCCL world and its (1, 1) DeviceMesh
    ("data", "model") on the card, torn down after. Multi-rank sharding
    cannot run here: NCCL refuses two ranks on one GPU, and gloo's
    all-gather of CUDA tensors segfaults every rank on the card (the
    checkpoints gather through the host for that reason); it is held
    against the reference on a 2 x 2 gloo CPU mesh by
    tests/test_torch_launch_steps.py."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            out["train"] = sharded_train(dev, mesh)
            torch.cuda.empty_cache()
            out["serve"] = sharded_serve(dev, mesh)
            torch.cuda.empty_cache()
            out["xlstm"] = sharded_xlstm(dev, mesh)
        finally:
            SHARD.set_mesh(None)
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def dryrun_cells() -> dict:
    """[17c] `python -m repro_torch.launch.dryrun`, one process a cell of
    DRYRUN_CELLS, all started together (CPU only: fake worlds of 256 or
    512 ranks, fake tensors); every process ended before this returns.
    Each cell's JSON result by "arch shape mesh"."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    results, procs = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        t0 = time.perf_counter()
        for i, (arch, shape, mp, over) in enumerate(DRYRUN_CELLS):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape,
                   "--out", os.path.join(tmp, str(i))]
            cmd += ["--multi-pod"] if mp else []
            cmd += [f"--override={k}={json.dumps(v)}"
                    for k, v in over.items()]
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, DRYRUN_TIMEOUT_S
                                - (time.perf_counter() - t0)))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for i, (arch, shape, mp, over) in enumerate(DRYRUN_CELLS):
            files = list(pathlib.Path(tmp, str(i)).glob("*.json"))
            require(len(files) == 1, f"[17c] {arch} x {shape}: no result "
                                     f"({procs[i].returncode}):\n{logs[i]}")
            res = json.loads(files[0].read_text())
            res["overrides"] = over
            results[f"{arch} {shape} {'2x16x16' if mp else '16x16'}"] = res
    return {"wall_s": wall, "cells": results}


def check_dryrun(dry: dict) -> None:
    """[17c] every cell "ok", or "skipped" with the port's reason for
    exactly the cells the long-context policy skips; the cells of
    DRYRUN_MUST_FIT within 80 GB a rank."""
    for key, res in dry["cells"].items():
        arch, shape, _ = key.split()
        ok, reason = LM_steps.cell_supported(arch, LM_configs.SHAPES[shape])
        if ok:
            require(res["status"] == "ok",
                    f"[17c] {key}: {res.get('status')} "
                    f"{res.get('error', '')}")
            if (arch, shape) in DRYRUN_MUST_FIT:
                m = res["memory"]
                require(m["fits_hbm"], f"[17c] {key} does not fit 80 GB: "
                                       f"{m['live_bytes_per_chip']} B a "
                                       f"rank, peak at {m['peak_op']}")
        else:
            require(res == {"arch": arch, "shape": shape,
                            "status": "skipped", "reason": reason,
                            "overrides": res["overrides"]},
                    f"[17c] {key} not skipped with the policy's reason: "
                    f"{res}")


def new_families(dev, card: str) -> dict:
    """[8v], [8h], [8w] and [9h], each phase's objects freed before the
    next; returns the flash launches of each path and the head-dim-64
    flash readings for the `kernels` line."""
    vlm = serve_vlm(dev)
    print(f"[8v] VLM serving: {vlm['cfg'].name} at full width (d_model "
          f"7168, 56/8 heads of 128, d_ff 20480, vocab 64000, bf16, "
          f"fused_attention, tp=1; depth cut to {VLM_LAYERS} of 60 layers: "
          f"{vlm['n_params']} parameters, {vlm['n_params_full']} at 60; "
          f"seeded weights, set-up {vlm['setup_s']:.2f} s) on {LM_BATCH} x "
          f"({vlm['cfg'].img_tokens} image + {LM_PROMPT} text) = "
          f"{vlm['first_decode_pos']}-token prefills (image prefix ~ "
          f"{VLM_PREFIX_STD}·N) + {LM_GEN} greedy decode steps at positions "
          f"{vlm['first_decode_pos']}..: prefill {vlm['prefill_ms']:.3f} ms "
          f"({vlm['prefill_tokens_per_s']:.1f} tokens/s), decode "
          f"{vlm['decode_ms_per_step']:.3f} ms/step, "
          f"{vlm['decode_tokens_per_s']:.1f} tokens/s; max_memory_allocated "
          f"{vlm['peak_mem_gib']:.2f} GiB ({vlm['peak_added_gib']:.2f} "
          f"above what was allocated before); flash_attention launches: "
          f"prefill {vlm['prefill_launches']}, decode 0; row 0 tokens "
          f"{vlm['generated'][0, :8].tolist()}; {card}", flush=True)
    launches = {"8v": vlm["prefill_launches"]}
    del vlm
    torch.cuda.empty_cache()
    vf32 = check_vlm_f32(dev)
    print(f"[8v] {VLM_ARCH} f32 at full width, {VLM_F32_LAYERS} layers, 1 x "
          f"({VLM_F32_IMG} image + {VLM_F32_TEXT} text) tokens (TF32 off): "
          f"card vs host at every position within {vf32['bound']:.3e}, "
          f"decode at the prefix-shifted position vs a prefill one token "
          f"longer within {vf32['decode_bound']:.3e} ({F32_RULE}): "
          f"{json.dumps(vf32)}", flush=True)
    torch.cuda.empty_cache()

    hy = serve_hybrid(dev)
    hy_trace = trace_prefill(hy)
    print(f"[8h] hybrid serving: {hy['cfg'].name} at full width and depth "
          f"(38 mamba2 layers, d_model 2048, 64 SSD heads of 64, ssm_state "
          f"64, the shared block (32 heads of 64, d_ff 8192) after layers "
          f"{ZB.attn_points(hy['cfg'])}, vocab 32000, bf16, "
          f"fused_attention, tp=1; {hy['n_params']} parameters, seeded, "
          f"set-up {hy['setup_s']:.2f} s) on {LM_BATCH} x {LM_PROMPT}-token "
          f"prompts + {LM_GEN} greedy decode steps: prefill "
          f"{hy['prefill_ms']:.3f} ms ({hy['prefill_tokens_per_s']:.1f} "
          f"tokens/s), decode {hy['decode_ms_per_step']:.3f} ms/step, "
          f"{hy['decode_tokens_per_s']:.1f} tokens/s; max_memory_allocated "
          f"{hy['peak_mem_gib']:.2f} GiB ({hy['peak_added_gib']:.2f} above "
          f"what was allocated before); flash_attention launches: prefill "
          f"{hy['prefill_launches']}, decode 0; row 0 tokens "
          f"{hy['generated'][0, :8].tolist()}; one prefill under "
          f"torch.profiler: idle share {hy_trace['idle_share']}, device busy "
          f"{hy_trace['device_busy_ms']:.1f} of {hy_trace['wall_ms']:.1f} "
          f"ms, by kind {json.dumps(hy_trace['by_kind_ms'])}, top "
          f"{json.dumps(hy_trace['top_ms'])}; {card}", flush=True)
    launches["8h"] = hy["prefill_launches"]
    del hy
    torch.cuda.empty_cache()
    hf32 = check_hybrid_f32(dev)
    print(f"[8h] {HY_ARCH} f32 at full width, {HY_F32_LAYERS} layers, 1 x "
          f"{HY_F32_TOKENS} tokens (TF32 off): card vs host within "
          f"{hf32['bound']:.3e}, decode at {HY_F32_TOKENS} vs a prefill "
          f"over {HY_F32_TOKENS + 1} within {hf32['decode_bound']:.3e} "
          f"({F32_RULE}): {json.dumps(hf32)}", flush=True)
    torch.cuda.empty_cache()

    ed = serve_encdec(dev)
    print(f"[8w] encoder-decoder serving: {ed['cfg'].name} at full width "
          f"and depth (32 + 32 layers, d_model 1280, 20 heads of 64, d_ff "
          f"5120, vocab 51866 padded to 51968, enc_len 1500, bf16, "
          f"fused_attention, tp=1; {ed['n_params']} parameters, seeded, "
          f"set-up {ed['setup_s']:.2f} s) on {LM_BATCH} x 1500 frames (~ "
          f"{VLM_PREFIX_STD}·N) and {ED_PROMPT}-token prompts + {ED_GEN} "
          f"greedy decode steps: prefill {ed['prefill_ms']:.3f} ms (encoder "
          f"alone {ed['encoder_ms']:.3f} ms, so the decoder's prefill "
          f"{ed['decoder_prefill_ms']:.3f} ms), decode "
          f"{ed['decode_ms_per_step']:.3f} ms/step, "
          f"{ed['decode_tokens_per_s']:.1f} tokens/s; max_memory_allocated "
          f"{ed['peak_mem_gib']:.2f} GiB ({ed['peak_added_gib']:.2f} above "
          f"what was allocated before); flash_attention launches: prefill "
          f"{ed['prefill_launches']}, decode 0; row 0 tokens "
          f"{ed['generated'][0, :8].tolist()}; {card}", flush=True)
    launches["8w"] = ed["prefill_launches"]
    del ed
    torch.cuda.empty_cache()
    ef32 = check_encdec_f32(dev)
    print(f"[8w] {ED_ARCH} f32 at full width, {ED_F32_LAYERS} + "
          f"{ED_F32_LAYERS} layers, 1 x 1500 frames and {ED_F32_TOKENS} "
          f"tokens (TF32 off): card vs host within {ef32['bound']:.3e}, "
          f"decode at {ED_F32_TOKENS} vs a prefill over "
          f"{ED_F32_TOKENS + 1} within {ef32['decode_bound']:.3e} "
          f"({F32_RULE}): {json.dumps(ef32)}", flush=True)
    torch.cuda.empty_cache()

    hd64 = time_flash_hd64(dev)
    print(f"[8h/8w] flash_attention at head dim 64 (ms; CUDA events, mean "
          f"of 50 calls; device_ms from torch.profiler over 10 calls): "
          f"{json.dumps(hd64)}; {card}", flush=True)

    ht = train_hybrid(dev)
    trace = ht.pop("trace")
    print(f"[9h] hybrid training: {ht['cfg'].name} at full width and depth "
          f"(bf16, remat, fused_attention, tp=1; AdamW lr {LM_TRAIN_LR}, "
          f"grad_clip_norm 1.0; seeded weights, set-up {ht['setup_s']:.2f} "
          f"s) on {LM_TRAIN_ACCUM} x ({LM_TRAIN_MB} x {LM_TRAIN_SEQ}) = "
          f"{ht['tokens_per_step']} tokens per step: warm-up "
          f"{ht['warmup_ms']:.1f} ms, then {HY_TRAIN_STEPS} steps of "
          f"{json.dumps(ht['step_ms'])} ms (mean {ht['mean_step_ms']:.1f} "
          f"ms, median {ht['median_step_ms']:.1f} ms, "
          f"{ht['tokens_per_s']:.1f} tokens/s at the mean); losses "
          f"{json.dumps(ht['losses'])}; max_memory_allocated "
          f"{ht['peak_mem_gib']:.2f} GiB ({ht['peak_added_gib']:.2f} above "
          f"what was allocated before); flash launches per step "
          f"{json.dumps(ht['launches_per_step'])}, over the timed steps "
          f"{json.dumps(ht['launches'])}; at the peak of one more step "
          f"(the allocator's history): {json.dumps(ht['peak_breakdown'])}; "
          f"one micro-batch step under "
          f"torch.profiler: idle share {trace['idle_share']}, device busy "
          f"{trace['device_busy_ms']:.1f} of {trace['wall_ms']:.1f} ms, by "
          f"kind {json.dumps(trace['by_kind_ms'])}, top "
          f"{json.dumps(trace['top_ms'])}; {card}", flush=True)
    launches["9h"] = ht["launches"]
    del ht
    torch.cuda.empty_cache()
    hgrads = check_hybrid_grads(dev)
    print(f"[9h] {HY_ARCH} f32 at full width, {HY_F32_LAYERS} layers, 1 x "
          f"{HY_F32_TOKENS} tokens (TF32 off), fused vs plain attention: "
          f"the shared block's and mamba layer {HY_GRAD_LAYER}'s gradients "
          f"nonzero and within {HY_GRAD_TOL} x max|leaf|, loss within "
          f"{TRAIN_F32_LOSS_TOL}: {json.dumps(hgrads)}", flush=True)
    torch.cuda.empty_cache()
    return {"flash_attention": {k: launches[k] for k in ("8v", "8h", "8w")},
            "9h": launches["9h"], "head_dim_64": hd64}


# ---------------------------------------------------------------------------

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build_all() -> list:
    """One nvcc per source, all started together; (source, lib, log, s)."""
    def one(src):
        t0 = time.perf_counter()
        lib, log = _build.build(src)
        return src, lib, log, time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        return list(pool.map(one, SOURCES))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] card: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    built = build_all()
    print(f"[2] build: {len(built)} sources in parallel, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, lib, log, secs in built:
        print(f"    {lib.name}: {secs:.1f} s")
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill",
                                       "Compiling entry", "smem")):
                print(f"    ptxas: {line.strip()}")
    logs = {src: log for src, _, log, _ in built}
    rb_ptxas = K_sweep.ptxas(logs[K.CSRC])
    require(len(rb_ptxas) == 3 and all(
        v.get("spill_bytes") == 0 for v in rb_ptxas.values()),
        f"cnn_eq_kernel_rb instances spill or are missing: {rb_ptxas}")
    c1_ptxas = C1_sweep.ptxas(logs[C1.CSRC])
    require(len(c1_ptxas) == 3 and all(
        v.get("spill_bytes") == 0 for v in c1_ptxas.values()),
        f"conv1d_kernel_rb instances spill or are missing: {c1_ptxas}")
    v_ptxas = V_sweep.ptxas(logs[V.CSRC])
    require(len(v_ptxas) == 3 and all(
        v.get("spill_bytes") == 0 for v in v_ptxas.values()),
        f"volterra_kernel_rb instances spill or are missing: {v_ptxas}")
    bwd_ptxas = SL_sweep.ptxas_bwd(logs[SL.CSRC_BWD])
    require(len(bwd_ptxas) == 12, f"slstm_bwd_kernel_cluster instances "
            f"missing: {bwd_ptxas}")
    print(f"[2] cnn_eq_kernel_rb registers and spill bytes: "
          f"{json.dumps(rb_ptxas)}; conv1d_kernel_rb: "
          f"{json.dumps(c1_ptxas)}; volterra_kernel_rb: "
          f"{json.dumps(v_ptxas)}; slstm_bwd_kernel_cluster: "
          f"{json.dumps(bwd_ptxas)}", flush=True)

    inputs = kernel_inputs(dev, ROWS, SYMS)
    K.reset_launch_counts()
    worst = check_kernels(inputs, TILES)
    edges = check_edges(inputs)
    instances = dict(K.INSTANCE_LAUNCHES)
    require_instances(K.LAUNCHES, instances, "[3]")
    plans = check_plans()
    vs_generic = check_against_generic(inputs)
    print(f"[3] kernel == plain bitwise at {ROWS}x{SYMS} symbols, stacked "
          f"and shared weights, tile_m {TILES}: max |diff| {worst}; at the "
          f"edge widths {edges}; kernel instances {instances} (all rb); "
          f"plans (held to cnn_eq_plan) "
          f"{json.dumps(plans)}; rb == generic forced {vs_generic}",
          flush=True)

    specs, waves, streams = tenants(SYMS, 1024)
    run = serve(dev, specs, streams, max_batch=4)
    n_checked = check_offline(dev, specs, waves, run["outs"], SYMS)
    for dp, (name, _) in KERNELS.items():
        stacked = run["stats"]["traffic"][
            f"L{CFG.layers}_K{CFG.kernel}_{BACKEND_OF[dp]}"]["launches"]
        require(stacked > 0 and run["launches"][name] == stacked,
                f"{name}: {run['launches'][name]} kernel launches on the "
                f"serving path for {stacked} stacked serving launches")
    require_instances(run["launches"], run["instances"], "[4]")
    want_backends = {"ht": "fused_int8", "lp": "fused_bf16",
                     "fp": "fused_fp32"}
    for tid, be in run["backends"].items():
        require(be == want_backends[tid.split("-")[0]],
                f"{tid}: deployed {be}, expected "
                f"{want_backends[tid.split('-')[0]]}")
    st = run["stats"]
    print(f"[4] serve: {len(run['backends'])} tenants, {n_checked} "
          f"symbols in {run['elapsed_s']:.3f} s (engine builds and autotune "
          f"included), streamed == offline bitwise; kernel launches "
          f"{run['launches']}, instances {run['instances']}, stacked "
          f"launches {st['launches']}, mean_batch "
          f"{st['mean_batch']:.2f}, p50 {st['p50_latency_ms']:.3f} ms, "
          f"p99 {st['p99_latency_ms']:.3f} ms, tiles {run['tiles']}",
          flush=True)
    tiles_used = {dp: next(run["tiles"][tid] for tid, be
                           in run["backends"].items()
                           if be == BACKEND_OF[dp]) for dp in KERNELS}
    shapes = check_serving_shapes(inputs, st, tiles_used)
    print(f"[4a] kernel == plain bitwise at the serving launch shapes: "
          f"{shapes}", flush=True)
    again = {}
    trace = device_trace(lambda: again.update(
        serve(dev, specs, streams, max_batch=4)))
    print(f"[4b] serve again under torch.profiler: "
          f"{json.dumps(trace)}; p50 {again['stats']['p50_latency_ms']:.3f}"
          f" ms, p99 {again['stats']['p99_latency_ms']:.3f} ms", flush=True)

    part = check_partitioned(dev)
    ptimes = time_partitioned(part, iters=50)
    print(f"[11] stream partitioning: one stream of {PART_SYMS} symbols "
          f"({2 * PART_SYMS} samples) through `partitioned_apply` per "
          f"datapath; interior [o_sym : -o_sym] == unsplit bitwise at N_i "
          f"{list(PART_INSTANCES)}: {json.dumps(part['checks'])}; N_i = "
          f"{HT.N_INSTANCES} launches {part['launches']}, instances "
          f"{part['instances']}; times (ms; CUDA events, mean of 50 calls; "
          f"kernel_device_ms from torch.profiler over 20 calls) "
          f"{json.dumps(ptimes)}; {card}", flush=True)
    part_launches = part["launches"]
    del part

    threaded = check_threaded(dev, specs, waves)
    lines = {}
    for name, r in threaded.items():
        lines[name] = {
            "agg_syms_per_s": r["acct"]["agg_syms_per_s"],
            "elapsed_s": r["acct"]["elapsed_s"],
            "p50_latency_ms": r["stats"]["p50_latency_ms"],
            "p99_latency_ms": r["stats"]["p99_latency_ms"],
            "p50_wait_ms": r["stats"]["p50_wait_ms"],
            "launches": r["stats"]["launches"],
            "mean_batch": r["stats"]["mean_batch"],
            "kernel_launches": r["launches"],
            "slo_breached": len(r["slo_breached"])}
    lines["async_faults"]["recovery"] = threaded["async_faults"]["recovery"]
    snr = {tid: est.snr_db for tid, est in threaded["async"]["link"].items()}
    print(f"[12] threaded serving ({len(specs)} tenants x {SYMS} symbols, "
          f"loadgen.chop ~1024-symbol chunks, loadgen.replay, BatchPolicy "
          f"max_batch 4, a LinkMonitor and an SloEngine on each runtime): "
          f"async == sync == offline bitwise, also under a FaultPlan "
          f"(launch_error at 3, corrupt at 7); every launch rb; async "
          f"executes on the launcher's stream; link estimates finite and "
          f"equal between runtimes; report has [serve] [link] [slo]: "
          f"{json.dumps(lines)}; link snr_db {json.dumps(snr)}; {card}",
          flush=True)
    shapes12 = check_serving_shapes(inputs, threaded["async"]["stats"],
                                    tiles_used)
    print(f"[12a] kernel == plain bitwise at the async run's launch shapes: "
          f"{shapes12}", flush=True)
    atrace = serve_threaded(dev, specs, slice_traffic(specs, waves),
                            "async", traced=True)["trace"]
    print(f"[12b] the async replay again under torch.profiler (the replay "
          f"only; the tenants were opened before): {json.dumps(atrace)}",
          flush=True)
    wired = check_wire(dev, specs, waves)
    lines = {}
    for name, r in wired["runs"].items():
        c, lat = r["net"], r["net"]["ingress_to_emit_s"]
        lines[name] = {
            "agg_syms_per_s": r["acct"]["agg_syms_per_s"],
            "elapsed_s": r["acct"]["elapsed_s"],
            "total_syms": r["acct"]["total_syms"],
            "rounds": r["acct"]["rounds"],
            "ingress_to_emit_p50_ms": lat["p50"] * 1e3,
            "ingress_to_emit_p99_ms": lat["p99"] * 1e3,
            "p50_latency_ms": r["stats"]["p50_latency_ms"],
            "p99_latency_ms": r["stats"]["p99_latency_ms"],
            "launches": r["stats"]["launches"],
            "mean_batch": r["stats"]["mean_batch"],
            "kernel_launches": r["launches"],
            **{k: c[k] for k in ("frames_in", "frames_out", "duplicates",
                                 "reordered", "frames_parked",
                                 "credits_granted", "frames_dropped")}}
    nw = wired["no_wire"]
    lines["sync_no_wire"] = {
        "agg_syms_per_s": nw["acct"]["agg_syms_per_s"],
        "elapsed_s": nw["acct"]["elapsed_s"],
        "p50_latency_ms": nw["stats"]["p50_latency_ms"],
        "p99_latency_ms": nw["stats"]["p99_latency_ms"],
        "launches": nw["stats"]["launches"]}
    print(f"[13] the wire ({len(wired['wire'])} tenants: [12]'s nine and "
          f"ht-0 again on an fp32 wire; wires {json.dumps(wired['wire'])}; "
          f"loadgen.chop ~1024-symbol chunks, NetClient -> loopback "
          f"(reorder window {WIRE_REORDER}, duplicates {WIRE_DUP}, each "
          f"way) -> NetGateway -> ServeRuntime / AsyncServeRuntime, "
          f"loadgen.replay_wire burst 4): egress == offline bitwise, int8 "
          f"wire == fp32 wire, no wire errors, every launch rb; "
          f"sync_no_wire: the same chunks by loadgen.replay on a "
          f"ServeRuntime, no wire, no link telemetry: "
          f"{json.dumps(lines)}; {card}", flush=True)
    shapes13 = check_serving_shapes(inputs, wired["runs"]["async"]["stats"],
                                    tiles_used)
    print(f"[13a] kernel == plain bitwise at the async wire run's launch "
          f"shapes: {shapes13}", flush=True)
    ctl = check_control(dev, specs, waves)
    print(f"[13b] control plane over the wire (int8 tenant, OPEN -> DATA -> "
          f"SWAP_WEIGHTS -> DATA -> ROLLBACK -> DATA -> EOS -> CLOSE): "
          f"spliced == offline per epoch bitwise; a frame dropped on one of "
          f"three tenants: stream_gap and NACK for it only, the others "
          f"bitwise: {json.dumps(ctl)}", flush=True)
    drifted = check_drift(dev, specs)
    print(f"[13c] drift traffic on the card ({DRIFT_TENANTS} tenants x "
          f"{DRIFT_BURSTS} bursts of {SYMS} symbols, DriftSchedule(8, 8); "
          f"t = 0 vs the stationary simulator on the same draws, bound "
          f"{DRIFT_ATOL}; draw ms per burst of {DRIFT_TENANTS} tenants, "
          f"host clock, the second draw): {json.dumps(drifted)}; {card}",
          flush=True)
    t0 = time.perf_counter()
    adapted = check_adapt(dev)
    adapt_state = adapted.pop("state")
    print(f"[14] adaptation ({ADAPT_BURSTS} bursts x {ADAPT_BURST_SYMS} "
          f"symbols of DriftingProakis under DriftSchedule(4, 6), a "
          f"{ADAPT_BASE_STEPS}-step base at t = 0, a frozen and an adaptive "
          f"fused_fp32 tenant on ServeRuntime, replay_adaptive step_every 2, "
          f"AdaptPolicy(3072, 3072, eval_capacity 8192), "
          f"PromotionPolicy(min_eval_syms 1024, eval_bucket_syms 512), "
          f"FineTuneConfig(200, 8, 256, 3e-3)): >= 1 promotion; recovery "
          f"criterion at t = 1 (frozen >= {FROZEN_FACTOR} x max(pre-drift, "
          f"{FROZEN_FLOOR}), adaptive <= {FRESH_FACTOR} x max(fresh, "
          f"{FRESH_FLOOR}), adaptive <= frozen / 4); adaptive stream "
          f"bitwise per epoch; every launch rb: {json.dumps(adapted)}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    t0 = time.perf_counter()
    bg = check_adapt_background(dev)
    overhead = adapt_overhead(dev, adapt_state)
    print(f"[14a] background adaptation (OnlineAdapter.start on its own "
          f"CUDA stream) under live AsyncServeRuntime traffic (1 tenant, 8 "
          f"bursts x 1024 symbols, DriftSchedule(2, 3)): stream complete, "
          f"swap log monotone, no errors, bitwise per epoch, every launch "
          f"rb: {json.dumps(bg)}; serving symbols/s of [14]'s drift streams "
          f"through AsyncServeRuntime with and without a busy fine-tune "
          f"thread (best of 3, interleaved): {json.dumps(overhead)}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    t0 = time.perf_counter()
    det = check_adapt_determinism(dev)
    print(f"[14b] [14a]'s sync twin run twice: history and final weights "
          f"bitwise equal: {json.dumps(det)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del adapt_state
    t0 = time.perf_counter()
    fleet = check_fleet(dev, specs, waves)
    fleet_stats = fleet.pop("stats")
    print(f"[15] fleet ({len(specs)} tenants of [4] x {SYMS} symbols in "
          f"[12]'s ~1024-symbol chunks, loadgen.replay, FleetRuntime("
          f"n_workers=2) on {dev}, BatchPolicy max_batch 4, worker 1 lost "
          f"after its execute {FLEET_KILL_AFTER}): every stream == offline "
          f"bitwise, every chunk once, 0 poisoned, >= 1 migration, every "
          f"launch rb: {json.dumps(fleet)}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    shapes15 = check_serving_shapes(inputs, fleet_stats, tiles_used)
    print(f"[15a] kernel == plain bitwise at the fleet's launch shapes: "
          f"{shapes15}", flush=True)
    t0 = time.perf_counter()
    slow = check_fleet_slow(dev, specs, waves)
    print(f"[15b] device_slow (0.05 s) on worker 0: the heartbeat saw it, "
          f"the worker lives, the stream bitwise: {json.dumps(slow)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fwire = check_fleet_wire(dev)
    print(f"[15c] the wire over the fleet ([13]'s loopback, two tenants, "
          f"fp32 and int8 wires): egress == offline bitwise: "
          f"{json.dumps(fwire)}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    halo = check_halo(dev)
    print(f"[16] halo: one stream of {PART_SYMS} symbols ({2 * PART_SYMS} "
          f"samples) over {HALO_RANKS} {halo['backend']} ranks on {dev} "
          f"(edges staged through the host: "
          f"{halo['staged_through_host']}; the fp32 exchange of host "
          f"tensors, no staging, host ms a rank "
          f"{json.dumps(halo['exchange_host_tensor_ms'])}), "
          f"{halo['shard_samples']} "
          f"samples a shard, halo {halo['halo_samples']} samples each side; "
          f"gathered == unsplit engine bitwise and == partitioned_apply("
          f"n_inst={HALO_RANKS}) on the interior, one rb launch a rank a "
          f"call: {json.dumps(halo['checks'])}; launches (all ranks) "
          f"{json.dumps(halo['launches'])}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    for dp, rows in halo["per_rank"].items():
        print(f"[16] {dp} per rank (host ms a call, mean of {HALO_ITERS} "
              f"after a barrier; exchange alone; bytes each way): "
              f"{json.dumps(rows)}", flush=True)
    print(f"[16a] kernel == plain at the per-rank launch shape: "
          f"{json.dumps(halo['kernel_vs_plain'])}", flush=True)
    print(f"[16b] compressed_psum over {HALO_RANKS} ranks ({COMP_ARCH} "
          f"full-width tree at tp 1, seeded f32 gradients a rank; host ms a "
          f"call, mean of {COMP_ITERS} after a warm-up; mean within one "
          f"quantization step of the exact mean, 0 < |residual| < scale): "
          f"{json.dumps(halo['comp'])}; {card}", flush=True)
    t0 = time.perf_counter()
    elastic = check_elastic(dev)
    print(f"[16c] elastic restore ({COMP_ARCH} at tp 1, CheckpointManager "
          f"-> ElasticRestore onto best_mesh() of a one-rank world): "
          f"{json.dumps(elastic)}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    path_launches = {
        name: {"[4] serve": run["launches"][name],
               "[11] partitioned N_i=64": part_launches[name],
               "[12] sync": threaded["sync"]["launches"][name],
               "[12] async": threaded["async"]["launches"][name],
               "[13] wire sync": wired["runs"]["sync"]["launches"][name],
               "[13] wire async": wired["runs"]["async"]["launches"][name],
               "[14] adapt": adapted["launches"][name],
               "[15] fleet": fleet["launches"][name],
               f"[16] halo ({HALO_RANKS} ranks)": halo["launches"][name]}
        for name, _ in KERNELS.values()}
    del threaded, wired

    trained = train_families(dev)
    summary = {k: {"ber": v["info"]["ber"], "ms_per_step": v["ms_per_step"],
                   "loss_first50": v["loss_first50"],
                   "loss_last50": v["loss_last50"]}
               for k, v in trained.items()}
    summary["cnn"].update(bits_params=trained["cnn"]["info"]["bits_params"],
                          bits_acts=trained["cnn"]["info"]["bits_acts"])
    print(f"[6] train ({TRAIN.steps} steps, batch {TRAIN.batch} x "
          f"{TRAIN.seq_syms} symbols, IM/DD 40 GBd 31.5 km; ms_per_step is "
          f"wall time incl. init and a {TRAIN.eval_syms}-symbol eval): "
          f"{json.dumps(summary)}", flush=True)

    d = deploy_inputs(dev, trained)
    for kern in (V, Q, C1):
        kern.reset_launch_counts()
    drun = deploy(d)
    deploy_launches = {name: launches[name] for name, (_, _, launches)
                       in DEPLOY_KERNELS.items()}
    c1_instances = dict(C1.INSTANCE_LAUNCHES)
    v_instances = dict(V.INSTANCE_LAUNCHES)
    q_instances = dict(Q.INSTANCE_LAUNCHES)
    for name, n in deploy_launches.items():
        require(n > 0, f"{name} was not launched on the deploy path")
    require(c1_instances == {"rb": len(d["layers"]), "generic": 0},
            f"conv1d kernel instances on the deploy path {c1_instances}, "
            f"expected all {len(d['layers'])} rb")
    require(v_instances == {"rb": 1, "generic": 0},
            f"volterra kernel instances on the deploy path {v_instances}, "
            f"expected one rb")
    require(deploy_launches["fixed_point_quantize"] == 1
            and q_instances == {"tensor": 0, "many": 1},
            f"quantize_params made {deploy_launches['fixed_point_quantize']}"
            f" launches {q_instances}, expected one of quant_many_kernel")
    checks = check_deploy(d, drun)
    print(f"[7] deploy at {ROWS}x{SYMS} symbols: kernel launches "
          f"{deploy_launches}, conv1d instances {c1_instances}, volterra "
          f"instances {v_instances}, quant instances {q_instances}; kernel "
          f"== plain bitwise; {json.dumps(checks)}", flush=True)

    times = time_kernels(inputs, tiles_used, shapes, iters=200)
    dtimes = time_deploy_kernels(d, drun, iters=200)
    print(f"[5] times (ms; CUDA events, mean of 200 calls after warm-up; "
          f"device_ms from torch.profiler over 20 calls): "
          f"{json.dumps(times)} {json.dumps(dtimes)}; device ms before "
          f"the register-blocked kernels (PERF.md, not measured here): "
          f"{json.dumps(OLD_DEVICE_MS)}", flush=True)

    lm = serve_lm(dev)
    print(f"[8] LM serving: {lm['cfg'].name} (28 layers, bf16, "
          f"fused_attention, tp=1; seeded weights, set-up "
          f"{lm['setup_s']:.2f} s) on {LM_BATCH} x {LM_PROMPT}-token prompts"
          f" + {LM_GEN} greedy decode steps: prefill {lm['prefill_ms']:.3f} "
          f"ms, decode {lm['decode_ms_per_step']:.3f} ms/step, "
          f"{lm['decode_tokens_per_s']:.1f} tokens/s; flash_attention "
          f"launches: prefill {lm['prefill_launches']}, decode "
          f"{lm['decode_launches']}; row 0 tokens "
          f"{lm['generated'][0, :8].tolist()}", flush=True)
    q0, k0, v0 = layer0_qkv(lm)
    fchecks = check_flash(dev, q0, k0, v0)
    print(f"[8b] flash_attention kernel vs plain: {json.dumps(fchecks)}",
          flush=True)
    f32 = check_lm_f32(dev, lm["tokens"])
    print(f"[8c] {LM_ARCH} f32 at full width, 1 x {LM_PROMPT} tokens (TF32 "
          f"off), bound {LM_LOGIT_TOL}: {json.dumps(f32)}", flush=True)
    ftimes = time_flash(q0, k0, v0, iters=50)
    lm_trace = trace_lm(lm)
    fill_device_ms(ftimes, lm_trace["prefill"], FLASH_KERNEL[torch.bfloat16],
                   "the profiled prefill below")
    print(f"[8d] flash_attention times (ms; CUDA events, mean of 50 calls; "
          f"device_ms from torch.profiler over 10 calls): "
          f"{json.dumps(ftimes)}; profiled prefill and decode steps: "
          f"{json.dumps(lm_trace)}", flush=True)
    flash_launches = lm["launches"]
    del lm, q0, k0, v0
    torch.cuda.empty_cache()

    moe = serve_moe(dev)
    print(f"[8m] MoE serving: {moe['cfg'].name} at full width (d_model "
          f"2048, 16 heads, 64 experts top-6, expert d_ff 1408, vocab "
          f"163840, bf16, fused_attention, tp=1; depth cut to "
          f"{MOE_LAYERS} of 48 layers; seeded weights, set-up "
          f"{moe['setup_s']:.2f} s) on {LM_BATCH} x {LM_PROMPT}-token "
          f"prompts + {LM_GEN} greedy decode steps: prefill "
          f"{moe['prefill_ms']:.3f} ms ({moe['prefill_tokens_per_s']:.1f} "
          f"tokens/s), decode {moe['decode_ms_per_step']:.3f} ms/step, "
          f"{moe['decode_tokens_per_s']:.1f} tokens/s; "
          f"max_memory_allocated {moe['peak_mem_gib']:.2f} GiB (the "
          f"served run, weights included); "
          f"flash_attention launches: prefill {moe['prefill_launches']}, "
          f"decode 0; row 0 tokens {moe['generated'][0, :8].tolist()}; "
          f"{card}", flush=True)
    torch.cuda.empty_cache()
    moe_f32 = check_moe_f32(dev, moe["batch"]["tokens"])
    print(f"[8m] {MOE_ARCH} f32 at full width, {MOE_F32_LAYERS} layers, 1 x "
          f"{MOE_F32_TOKENS} tokens (TF32 off), card vs host, the host "
          f"routed as the card, bound max({LM_LOGIT_TOL}, "
          f"{MOE_F32_ENVELOPE} x host f32 vs float64): "
          f"{json.dumps(moe_f32)}", flush=True)
    del moe
    torch.cuda.empty_cache()

    tr = train_lm(dev)
    print(f"[9] LM training: {tr['cfg'].name} (28 layers, bf16, "
          f"fused_attention, remat, tp=1; AdamW lr {LM_TRAIN_LR}, "
          f"grad_clip_norm 1.0; seeded weights, set-up {tr['setup_s']:.2f} "
          f"s) on {LM_TRAIN_ACCUM} x ({LM_TRAIN_MB} x {LM_TRAIN_SEQ}) = "
          f"{tr['tokens_per_step']} tokens per step: warm-up "
          f"{tr['warmup_ms']:.1f} ms, then {LM_TRAIN_STEPS} steps of "
          f"{json.dumps(tr['step_ms'])} ms (mean {tr['mean_step_ms']:.1f} "
          f"ms, median {tr['median_step_ms']:.1f} ms, "
          f"{tr['tokens_per_s']:.1f} tokens/s at the mean); losses "
          f"{json.dumps(tr['losses'])}; max_memory_allocated "
          f"{tr['peak_mem_gib']:.2f} GiB; launches per step "
          f"{json.dumps(tr['launches_per_step'])}, over the timed steps "
          f"{json.dumps(tr['launches'])}; per step, garbage-collector ms, "
          f"cudaMalloc and cudaFree calls, allocator retries and reserved "
          f"GiB: {json.dumps(tr['step_host'])}", flush=True)
    tr_launches = tr["launches"]
    q1, k1, v1, do1 = train_layer0(tr)
    layer0 = check_train_kernels(dev, q1, k1, v1, do1)
    random_errs = check_train_random(dev)
    print(f"[9b] training kernels vs plain (o f32 {FLASH_TOL[torch.float32]}"
          f", bf16 2e-2 + 1e-2·|o|; lse {LSE_TOL}; backward f32 "
          f"{BWD_F32_TOL}, bf16 {BWD_BF16_RTOL}·|want| + "
          f"{BWD_BF16_ATOL_REL}·max|want|): trained layer 0 "
          f"{json.dumps(layer0)}; random {json.dumps(random_errs)}",
          flush=True)
    f32_train = check_train_f32(dev, next(tr["batches"])["tokens"][0])
    print(f"[9c] {LM_ARCH} f32 at full width, 1 x {LM_TRAIN_SEQ} tokens "
          f"(TF32 off), fused vs plain attention: bounds loss "
          f"{TRAIN_F32_LOSS_TOL}, gradient {TRAIN_F32_GRAD_TOL}·max|leaf|: "
          f"{json.dumps(f32_train)}", flush=True)
    torch.cuda.empty_cache()
    ttimes = time_train_kernels(q1, k1, v1, do1, iters=20)
    print(f"[9d] training kernel times (ms; CUDA events, mean of 20 calls; "
          f"device_ms from torch.profiler over 10 calls): "
          f"{json.dumps(ttimes)}", flush=True)
    del q1, k1, v1, do1
    cli = train_cli(dev)
    print(f"[9e] CLI: python -m repro_torch.launch.train {cli['argv']}: "
          f"{json.dumps({k: v for k, v in cli.items() if k != 'argv'})}",
          flush=True)
    torch.cuda.empty_cache()

    # after every other profiler session but the last: a trace of tens of
    # thousands of training events left the next session short of its
    # first events (the last one warms up inside its profiler schedule)
    print(f"[6a] 10 CNN training steps (QAT, all three phases) under "
          f"torch.profiler: {json.dumps(train_trace(dev))}", flush=True)

    xl = serve_xlstm(dev)
    print(f"[10] xlstm serving: {xl['cfg'].name} (12 blocks, sLSTM at "
          f"{list(xl['cfg'].slstm_at)}, d_model 768, 4 heads, bf16, tp=1; "
          f"{xl['n_params']} parameters, seeded, set-up "
          f"{xl['setup_s']:.2f} s) on {LM_BATCH} x {LM_PROMPT}-token prompts"
          f" + {LM_GEN} greedy decode steps: prefill {xl['prefill_ms']:.3f} "
          f"ms, decode {xl['decode_ms_per_step']:.3f} ms/step, "
          f"{xl['decode_tokens_per_s']:.1f} tokens/s; max_memory_allocated "
          f"{xl['peak_mem_gib']:.3f} GiB above what was allocated before; "
          f"slstm_fused launches: prefill {xl['prefill_launches']}, decode "
          f"{xl['decode_launches']}; flash launches 0; row 0 tokens "
          f"{xl['generated'][0, :8].tolist()}", flush=True)
    xg3, r3, c3 = block3_inputs(xl)
    schecks = check_slstm(dev, xg3, r3, c3)
    print(f"[10b] slstm_fused kernel vs plain (atol {SLSTM_ATOL}, or "
          f"{SLSTM_ENVELOPE} x the plain version's distance from float64; "
          f"resolvable: plain vs float64 <= {SLSTM_RESOLVED} x max(1, |x|))"
          f": {json.dumps(schecks)}", flush=True)
    xf32 = check_xlstm_f32(dev, xl["tokens"])
    print(f"[10c] {XL_ARCH} f32 at full width (TF32 off), bound "
          f"{LM_LOGIT_TOL}: card vs host over 1 x {XL_F32_TOKENS} tokens, "
          f"decode at {LM_PROMPT - 1} vs prefill over {LM_PROMPT}: "
          f"{json.dumps(xf32)}", flush=True)
    xtrace = trace_xlstm(xl)
    stimes = time_slstm(xg3, r3, c3, iters=20)
    stimes["device_ms"] = xtrace["prefill"]["slstm_device_ms"]
    print(f"[10d] slstm_fused times (ms; CUDA events, mean of 20 calls; "
          f"device_ms from the profiled prefill's launches): the "
          f"{stimes['instance']} kernel at Q = {stimes['q']}, RB = "
          f"{stimes['rb']} ({stimes['clusters']} clusters, "
          f"{stimes['max_active_clusters']} fit at once), "
          f"{stimes['us_per_step']:.3f} µs a step, device "
          f"{stimes['device_ms']} ms (the stream kernel before: "
          f"{SLSTM_STREAM_MS} ms device); {json.dumps(stimes)}; profiled "
          f"prefill and decode steps: {json.dumps(xtrace)}", flush=True)
    slstm_launches = xl["launches"]
    del xl, xg3, r3, c3
    torch.cuda.empty_cache()

    xt = train_xlstm(dev)
    xtrace = xt.pop("trace")
    print(f"[9x] xlstm training: {xt['cfg'].name} at full width (12 "
          f"blocks, sLSTM at {list(xt['cfg'].slstm_at)}, d_model 768, 4 "
          f"heads, bf16, remat, tp=1; AdamW lr {LM_TRAIN_LR}, "
          f"grad_clip_norm 1.0; seeded weights, set-up "
          f"{xt['setup_s']:.2f} s) on {LM_TRAIN_ACCUM} x ({LM_TRAIN_MB} x "
          f"{LM_TRAIN_SEQ}) = {xt['tokens_per_step']} tokens per step: "
          f"warm-up {xt['warmup_ms']:.1f} ms, then {XL_TRAIN_STEPS} steps "
          f"of {json.dumps(xt['step_ms'])} ms (mean "
          f"{xt['mean_step_ms']:.1f} ms, median {xt['median_step_ms']:.1f} "
          f"ms, {xt['tokens_per_s']:.1f} tokens/s at the mean); losses "
          f"{json.dumps(xt['losses'])}; max_memory_allocated "
          f"{xt['peak_mem_gib']:.2f} GiB, {xt['peak_added_gib']:.2f} GiB "
          f"above what was allocated before; sLSTM launches per step "
          f"{json.dumps(xt['launches_per_step'])}, over the timed steps "
          f"{json.dumps(xt['launches'])}; one step under torch.profiler: "
          f"idle share {xtrace['idle_share']}, device busy "
          f"{xtrace['device_busy_ms']:.1f} of {xtrace['wall_ms']:.1f} ms, "
          f"by kind {json.dumps(xtrace['by_kind_ms'])}, top "
          f"{json.dumps(xtrace['top_ms'])}; {card}", flush=True)
    xgb, pb, hb, cb = train_block3(xt)
    bchecks = check_slstm_bwd(dev, xgb, pb, hb, cb, xt["cfg"].n_heads)
    print(f"[9x] slstm_fused_bwd kernel vs plain on block 3's trained "
          f"inputs (bound max({SLSTM_ATOL} x max(1, |x|), "
          f"{SLSTM_ENVELOPE} x the plain version's distance from float64); "
          f"slstm_r / slstm_w gradients kernel path vs plain within "
          f"{XL_GRAD_TOL} x max|leaf|): {json.dumps(bchecks)}", flush=True)
    btimes = time_slstm_bwd(xgb, pb["slstm_r"], cb, xt["cfg"].n_heads,
                            iters=10)
    print(f"[9x] slstm_fused_bwd times (ms; CUDA events, mean of 10 calls, "
          f"the recompute and dr's einsum included; device_ms from "
          f"torch.profiler over 3 calls): {json.dumps(btimes)}; {card}",
          flush=True)
    xt_launches = xt["launches"]
    del xt, xgb, pb, hb, cb
    torch.cuda.empty_cache()
    family_launches = new_families(dev, card)

    step_trace = trace_train_step(tr)
    for name in TRAIN_KERNELS:
        fill_device_ms(ttimes[name], step_trace, TRAIN_KERNEL_NAMES[name][0],
                       "the profiled train step, [9d] below")
    filled = {n: (ttimes[n]["device_ms"], ttimes[n].get("device_ms_from"))
              for n in TRAIN_KERNELS}
    print(f"[9d] one full-width LM train step under torch.profiler (after "
          f"a warm-up step in the profiler's schedule): "
          f"{json.dumps(step_trace)}; the training kernels' device_ms: "
          f"{json.dumps(filled)}", flush=True)
    del tr
    torch.cuda.empty_cache()

    shard = sharded_lm(dev)
    st, ss, sx = shard["train"], shard["serve"], shard["xlstm"]
    print(f"[17] sharded {LM_ARCH} train step through launch.steps."
          f"make_lowerable on a one-rank NCCL DeviceMesh (1, 1) (data, "
          f"model), full width and depth, tp=1, fused_attention, "
          f"{LM_TRAIN_ACCUM} x ({LM_TRAIN_MB} x {LM_TRAIN_SEQ}) tokens (the "
          f"train_4k cell cut in batch), against launch.train.build on the "
          f"same weights and micro-batches: ms {json.dumps(st['ms'])}; "
          f"flash launches {json.dumps(st['launches'])}; loss "
          f"{json.dumps(st['loss'])}; params after the step "
          f"{json.dumps(st['params_after_step'])} (bound "
          f"{SHARD_PARAM_TOL} x max|leaf|), Adam mu "
          f"{json.dumps(st['adam_mu_after_step'])}; {card}", flush=True)
    print(f"[17] sharded {LM_ARCH} serving (make_lowerable's decode cell, "
          f"{LM_BATCH} x {LM_PROMPT + LM_GEN} positions): prefill of "
          f"{LM_BATCH} x {LM_PROMPT} tokens and {LM_GEN} decode steps "
          f"against serve_session on the same weights and tokens: ms "
          f"{json.dumps(ss['ms'])}; flash launches "
          f"{json.dumps(ss['launches'])}, 0 in decode both ways; prefill "
          f"logits {json.dumps(ss['prefill'])}; decode logits "
          f"{json.dumps(ss['decode'])} (bound {LM_LOGIT_TOL} x "
          f"max|logits|); {card}", flush=True)
    print(f"[17b] sharded {XL_ARCH} train step on the same mesh against "
          f"launch.train.build: ms {json.dumps(sx['ms'])}; sLSTM launches "
          f"{json.dumps(sx['launches'])}; loss {json.dumps(sx['loss'])}; "
          f"params after the step {json.dumps(sx['params_after_step'])}; "
          f"{card}", flush=True)
    print(f"[17] host ms of the sharded steps against commit e686c1c's "
          f"(before the weight products ran on each rank's rows; "
          f"{json.dumps(SHARD_MS_BEFORE)}): train sharded "
          f"{st['ms']['sharded']['again']:.1f}, unsharded "
          f"{st['ms']['unsharded']['again']:.1f}; xlstm sharded "
          f"{sx['ms']['sharded']:.1f}, unsharded {sx['ms']['unsharded']:.1f}"
          f"; {card}", flush=True)
    dry = dryrun_cells()
    for key, res in dry["cells"].items():
        if res["status"] != "ok":
            print(f"[17c] {key}: {res['status']} "
                  f"{res.get('reason', res.get('error', ''))}", flush=True)
            continue
        r, m = res["roofline"], res["memory"]
        print(f"[17c] {key} {json.dumps(res['overrides'])} "
              f"({res['chips']} ranks): compute "
              f"{r['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{r['t_memory_s'] * 1e3:.3f} ms, collective "
              f"{r['t_collective_s'] * 1e3:.3f} ms -> {r['bottleneck']}"
              f"-bound, MFU at the roofline {r['mfu_at_roofline']:.4f}; "
              f"per rank: flops {r['flops_per_chip']:.4g}, HBM bytes "
              f"{r['hbm_bytes_per_chip']:.4g}, collective ring bytes "
              f"{r['collective_ring_bytes']:.4g} "
              f"{json.dumps(r['collective_ring_bytes_by_op'])} "
              f"{json.dumps(r['collective_ops'])}, kernel flops "
              f"{json.dumps(res['kernel_flops'])} (expected "
              f"{res['kernel_flops_expected']:.4g}); arguments "
              f"{m['argument_bytes']} B + temporaries {m['temp_bytes']} B a "
              f"rank (peak at {m['peak_op']}), fits 80 GB: "
              f"{m['fits_hbm']}; largest local product "
              f"{json.dumps(res['products'][:1])}; build "
              f"{res['t_build_s']} s, count {res['t_count_s']} s, "
              f"{res['ops_per_chip']} ops", flush=True)
    check_dryrun(dry)
    print(f"[17c] {len(dry['cells'])} dry-run cells on torch "
          f"{torch.__version__}, one process each, all together: "
          f"{dry['wall_s']:.1f} s", flush=True)


    library = {"fp32": "F.conv1d x3 + ReLU x2, fp32, TF32 off, grouped "
                       "per row",
               "bf16": "F.conv1d x3 + ReLU x2, bf16, grouped per row",
               "int8": "F.conv1d x3 + ReLU x2 on the fp32 folded weights, "
                       "fp32, TF32 off (PyTorch has no int8 conv)"}
    kernels = []
    for dp, (name, replaces) in KERNELS.items():
        t = times[dp]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": run["launches"][name],
            "max_abs_err": worst[dp], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "library": library[dp],
            "tile_m": t["tile_m"], "shape": t["shape"], "card": card,
            "path_launches": path_launches[name],
            **{k: t[k] for k in ("instance", "generic_device_ms",
                                 "serving_shape", "serving_device_ms")
               if k in t}})
    for name, (source, replaces, _) in DEPLOY_KERNELS.items():
        t = dtimes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": deploy_launches[name],
            "max_abs_err": checks["max_abs_err"][name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "library": t["library"],
            "shape": t["shape"], "card": card,
            **{k: t[k] for k in ("instance", "generic_device_ms",
                                 "library_six_calls_ms", "large")
               if k in t}})
    kernels.append({
        "name": FLASH[0], "route": "cuda", "source": FLASH[1],
        "replaces": FLASH[2], "launches": flash_launches,
        "max_abs_err": fchecks["layer0_max_abs"], "ms": ftimes["ms"],
        "plain_ms": ftimes["plain_ms"], "bound_ms": ftimes["bound_ms"],
        "bound_by": ftimes["bound_by"], "library_ms": ftimes["library_ms"],
        "device_ms": ftimes["device_ms"], "library": ftimes["library"],
        "shape": ftimes["shape"], "card": card,
        **{k: ftimes[k] for k in ("device_ms_from",) if k in ftimes},
        "path_launches": {"8": flash_launches,
                          **family_launches["flash_attention"],
                          "17 sharded prefill":
                              ss["launches"]["prefill_sharded"]},
        "head_dim_64": family_launches["head_dim_64"]})
    for name, (source, replaces, _) in TRAIN_KERNELS.items():
        t = ttimes[name]
        err = (layer0["o"] if name == "flash_attention_fwd" else
               max(layer0["dk"], layer0["dv"]) if name.endswith("dkv")
               else layer0["dq"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": tr_launches[name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library": t["library"], "shape": t["shape"], "card": card,
            **{k: t[k] for k in ("device_ms_from",) if k in t},
            "path_launches": {"9": tr_launches[name],
                              "9h": family_launches["9h"][name],
                              "17 sharded step":
                                  st["launches"]["sharded"][name]}})
    kernels.append({
        "name": SLSTM[0], "route": "cuda", "source": SLSTM[1],
        "replaces": SLSTM[2], "launches": slstm_launches,
        "max_abs_err": schecks["block3"]["hs"]["kernel_vs_plain"],
        "ms": stimes["ms"], "plain_ms": stimes["plain_ms"],
        "bound_ms": stimes["bound_ms"], "bound_by": stimes["bound_by"],
        "library_ms": stimes["library_ms"],
        "device_ms": stimes["device_ms"], "library": stimes["library"],
        "instance": stimes["instance"], "q": stimes["q"],
        "rb": stimes["rb"], "us_per_step": stimes["us_per_step"],
        "path_launches": {"10": slstm_launches, "17b sharded step":
                          sx["launches"]["sharded"]["slstm_fused"]},
        "shape": stimes["shape"], "card": card})
    kernels.append({
        "name": SLSTM_BWD[0], "route": "cuda", "source": SLSTM_BWD[1],
        "replaces": SLSTM_BWD[2],
        "launches": xt_launches["slstm_fused_bwd"],
        "max_abs_err": bchecks["dxg"]["kernel_vs_plain"],
        "ms": btimes["ms"], "plain_ms": btimes["plain_ms"],
        "bound_ms": btimes["bound_ms"], "bound_by": btimes["bound_by"],
        "library_ms": btimes["library_ms"],
        "device_ms": btimes["device_ms"], "library": btimes["library"],
        "instance": btimes["instance"], "q": btimes["q"],
        "rb": btimes["rb"], "us_per_step": btimes["us_per_step"],
        "registers": bwd_ptxas.get("bf16 RB=1 KB=24", {}),
        "stream_ms": btimes["stream_ms"],
        "stream_device_ms": btimes["stream_device_ms"],
        "stream_us_per_step": btimes["stream_us_per_step"],
        "stream_max_abs_err": bchecks["stream"]["dxg"]["kernel_vs_plain"],
        "path_launches": {"9x": xt_launches["slstm_fused_bwd"],
                          "17b sharded step":
                              sx["launches"]["sharded"]["slstm_fused_bwd"]},
        "shape": btimes["shape"], "card": card})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
