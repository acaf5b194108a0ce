#!/usr/bin/env python3
"""chip_smoke.py — run the PyTorch/CUDA port on one card and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints a line; any failure raises and exits non-zero with no
result line), in the order they run:
  1. card: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build: one nvcc per source, all started together, builds the seven
     CUDA sources (cnn_eq, volterra, quant, conv1d, flash_attn,
     flash_attn_bwd, slstm) for sm_90a; prints the -Xptxas -v register /
     shared-memory / spill lines of every kernel instance (the sLSTM
     source's: the cluster kernel's twelve, the stream kernel's four), and
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
     share, top kernels);
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
  9d (last): one full-width LM train step under torch.profiler, after a
     warm-up step inside the profiler's schedule: idle share and the top
     device activities.
The line before the last is the `kernels` JSON (eleven kernels; the
three cnn_eq rows also carry their launches on each path, `path_launches`);
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Phases 3–5, 11 and 12 use random weights from a seed (numpy), carried in
through `repro_torch.interop`, and waveforms of PAM-2 through a short ISI
filter with noise, also from a seed; phases 6–7 train from seeded generators on
the simulated link; phases 8, 9 and 10 draw their weights from seeded card
generators, phase 9 its tokens from the reference's seeded stream. Without
a CUDA card the script exits with code 2.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import gc
import json
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
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs as LM_configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.channels import imdd  # noqa: E402
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
from repro_torch.kernels.volterra import volterra as V  # noqa: E402
from repro_torch.interop import (tree_leaves,  # noqa: E402
                                 tree_named_leaves, tree_unflatten)
from repro_torch.launch import serve as LM_serve  # noqa: E402
from repro_torch.launch import train as LM_train  # noqa: E402
from repro_torch.models import attention as LM_attn  # noqa: E402
from repro_torch.models import registry as LM_registry  # noqa: E402
from repro_torch.models import transformer as LM_tr  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.obs import (LinkMonitor, Observability,  # noqa: E402
                             SloEngine, SloRule)
from repro_torch.obs import report as OBS_report  # noqa: E402
from repro_torch.serve import (AsyncServeRuntime, BatchPolicy,  # noqa: E402
                               Fault, FaultPlan, ServeRuntime, TenantSpec,
                               loadgen)

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
# H100 SXM published peaks (dense): bytes/s, and operations/s per type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
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
SOURCES = (K.CSRC, V.CSRC, Q.CSRC, C1.CSRC, FA.CSRC, FA.CSRC_BWD, SL.CSRC)
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
# [10c]: f32 at full width, card vs host over this many tokens, and decode
# vs prefill at LM_PROMPT; both within LM_LOGIT_TOL, stated before the
# first run
XL_F32_TOKENS = 512
# [11] one stream of N_i = 64 instances of l_inst symbols, split over 8 and
# over 64 instances
PART_SYMS = HT.N_INSTANCES * HT.L_INST          # 468 480 symbols
PART_INSTANCES = (8, HT.N_INSTANCES)
# [12] each tenant's link-quality floor (random weights: a breach is
# recorded, not a failure)
SLO_SNR_FLOOR_DB = 10.0


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
# phase 5: times
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


KERNEL_NAMES = ("cnn_eq_kernel", "volterra_kernel", "quant_kernel",
                "quant_many_kernel",
                "conv1d_kernel", "flash_attn_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_kernel", "slstm_kernel")


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
    ``calls`` calls of fn; with ``warm``, one call runs first in the
    profiler's warm-up step (a session that follows another may miss its
    first kernel events, which a 3-call session cannot spare)."""
    prof = device_trace(lambda: [fn() for _ in range(calls)],
                        warmup=fn if warm else None)
    ms = [v["mean_ms"] for k, v in prof["by_kind_ms"].items()
          if k.startswith(name)]
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
    rtol 1e-2 with atol 2e-2), then random inputs at non-aligned shapes."""
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
            key = str(dt).replace("torch.", "")
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


def time_flash(q, k, v, iters: int) -> dict:
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
                                   FLASH_KERNEL[q.dtype], calls=10),
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
                     f"({LM_ARCH} prefill, layer 0)"}


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
    non-aligned shapes, f32 and bf16: worst max |diff| per dtype."""
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = {}
    for b, sq, sk, h, hkv, d, win, qoff in TRAIN_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(sh, generator=gen, device=dev).to(dt)
                           for sh in ((b, sq, h, d), (b, sk, hkv, d),
                                      (b, sk, hkv, d), (b, sq, h, d)))
            errs = check_train_kernels(dev, q, k, v, do, window=win,
                                       q_offset=qoff)
            key = str(dt).replace("torch.", "")
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
            "device_ms": _device_ms(kern, kernel_name, calls=10),
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
    require(SL.INSTANCE_LAUNCHES == {"cluster": n_slstm, "stream": 0},
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
                                     "stream": 0},
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
    print(f"[2] cnn_eq_kernel_rb registers and spill bytes: "
          f"{json.dumps(rb_ptxas)}; conv1d_kernel_rb: "
          f"{json.dumps(c1_ptxas)}; volterra_kernel_rb: "
          f"{json.dumps(v_ptxas)}", flush=True)

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
    path_launches = {
        name: {"[4] serve": run["launches"][name],
               "[11] partitioned N_i=64": part_launches[name],
               "[12] sync": threaded["sync"]["launches"][name],
               "[12] async": threaded["async"]["launches"][name]}
        for name, _ in KERNELS.values()}
    del threaded

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
    print(f"[8d] flash_attention times (ms; CUDA events, mean of 50 calls; "
          f"device_ms from torch.profiler over 10 calls): "
          f"{json.dumps(ftimes)}; profiled prefill and decode steps: "
          f"{json.dumps(trace_lm(lm))}", flush=True)
    flash_launches = lm["launches"]
    del lm, q0, k0, v0
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
    print(f"[9d] one full-width LM train step under torch.profiler (after "
          f"a warm-up step in the profiler's schedule): "
          f"{json.dumps(trace_train_step(tr))}", flush=True)
    del tr

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
        "shape": ftimes["shape"], "card": card})
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
            "library": t["library"], "shape": t["shape"], "card": card})
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
        "shape": stimes["shape"], "card": card})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
