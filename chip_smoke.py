#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0]

Phases, one line each, and any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under tdm_tpu_torch/csrc compiled with nvcc for
     sm_90a, one nvcc per source, all started together; each kernel's
     registers, spills and shared memory (ptxas) and its HGMMA (wgmma) and
     HMMA (mma.sync) instructions (cuobjdump -sass), with a check that the
     bf16 kernels of all four libraries (the forwards of kernels 1 and 4,
     dQ and dK/dV) run on wgmma and hold no mma.sync, and that the backward
     ones spill nothing;
  3. kernels: each kernel held against its plain PyTorch version on the
     card at the main path's shapes (and a sweep of head dims), with its
     time and one PyTorch library call's in turns (2 rounds of 10
     launches; median, min and max), the plain version's and the bound;
  4. reference: the tiny pipeline on the card (kernel) against the same
     pipeline on the CPU (plain attention);
  5. serve: a full-width PixArt-α-512 pipeline (28 layers, seeded random
     weights) written with the port's writer, its T5-v1.1-XXL (24 x 4096,
     4.76 B parameters, seeded, bf16) and a hash tokenizer bundled,
     served over HTTP by TDMServer from raw prompts with no embedding
     cache (ENC_PROMPTS: 1 to 160 words, caption-length rows of 56 to 120
     tokens among them, one cut at 120): 6 concurrent requests (two batches of 4, one padded), PNG
     checks, per-seed determinism and the kernel launch count per batch,
     the peak memory with the T5 resident; the T5 in bf16 against the same
     weights in fp32 per row, its batch-1 encode time against its bound,
     the host time of a request's encode; then
     `python -m tdm_tpu_torch.cli.build_cache --pipeline <the bundle>`
     (its main()) writes the cache the train phases read, each prompt's
     batch-1 encode against its row reported; then one full-width forward
     with the kernel against plain attention; then the pipeline's
     `data_parallel_devices` = [cuda:0, cuda:0]: a batch of 4 split 2 + 2
     over two replicas against the undivided batch (bit for bit, or within
     one bf16 ulp of the latent scale), kernel 1's launches from both
     replicas' threads, the overlap against the chunks alone. The seeded
     encoders (T5-XXL,
     CLIP-L, OpenCLIP-G) are written once per run and hardlinked into the
     bundle and the SD3, SD1.5 and CogVideoX checkouts' text_encoder*/;
  6. train: full-width PixArt-α-512 TDM distillation through the training
     CLI's main() at the JAX CLI's default flags, the teacher read from the
     transformer/ folder of a PixArt-α-512 diffusers checkout written from
     the seed (the cache build_cache wrote, batch 4, bf16, dmd, 3 steps): the
     teacher's load seconds by part, seconds per step, peak
     memory, the idle share of a step, and each training kernel's launches
     per step (checked), --export_lora_rank 0 (the SVD export is held in
     phase 12). main() runs inside a world of one
     process over NCCL formed by the port's initialiser from torchrun's
     variables, and makes no collective (counted); then, in that world,
     the one-process reference step at batch 2 of the data-parallel check
     (full width, the checkout's first RANK_LAYERS blocks) and the port's
     allreduce_mean, all_gather and reduce_scatter over its critic
     gradients, each equal to its input; after the --quant_forwards run,
     two data-parallel ranks (this script with --dp_rank, gloo, both on
     cuda:0, batch 1 each, the reference's inputs): their weights equal
     bit for bit after the step, the reduced gradients and losses within
     DP_GRAD_TOL of the reference, kernels 1–3's launches per rank, each
     rank's step seconds and peak memory (checked where stated); with the
     `moe` phase, the same two processes then take one --ep 2 step of the
     MoE PixArt-α-512 at RANK_LAYERS blocks (4 experts, 2 a rank, batch
     4 on both) against the one-process step: the leaves other than the
     expert stacks equal bit for bit, the reduced gradients and the
     gathered update within DP_GRAD_TOL, launches, seconds and peaks;
     then the --tp 2 checks in the same two processes (`tp_rank_step`,
     `tp_serve_rank`): one --quant int8 forward of the 8-block model at
     batch 4 cut for each rank, its int8 codes and scales equal to the
     one-process int8 forward's; one --tp 2 dmd step on both rows against
     the one-process batch-2 step (the leaves tp does not cut bit for bit
     across the ranks, the gathered gradients within TP_GRAD_TOL and the
     losses within DP_GRAD_TOL, the gathered update equal to the
     one-process AdamW update of the gathered gradient, launches,
     all-reduces, seconds, peaks); the same step in fp32 within
     TP_FP32_TOL of the one-process fp32 step, and its control (rank 1's
     f backward all-reduce dropped) beyond it; `train_tdm.main --tp 2
     --device cuda:0` for one step at RANK_LAYERS blocks, seeded (launches, all-reduces,
     the student written whole by rank 0 alone); then the --sp 2 checks
     (`sp_rank_checks`, the ('data', 'sp') = (1, 2) mesh): the
     CogVideoX pipeline with `sequence_parallel_mesh` (CogVideoX-2B at 30
     blocks, seeded, 61 frames at 480x720: 16 latent frames, 10,800 video
     rows a rank; batch 1, 4 NFE, latents) against the one-process
     pipeline (relative L2 ≤ SP_SERVE_TOL), the sp dmd step at RANK_LAYERS
     blocks with remat against the one-process step (the summed gradients
     within SP_GRAD_TOL, the losses within DP_GRAD_TOL, the weights bit for
     bit across ranks, the update reported), its fp32 witness (TF32 off, 2
     blocks, 4 latent frames) within SP_FP32_TOL and its control (rank 1
     keeps its own dK/dV on each backward's return hop) beyond it, and
     `train_tdm.main --sp 2 --model_family cogvideox --num_frames 61` with
     the recipe's flags (LoRA 64, 8-bit Adam, --gradient_checkpointing) for
     one step at SP_MAIN_LAYERS blocks; each with kernels 1–3's launches
     (the lse forward (n+1)x every attention call, dQ and dK/dV (n+1)x every
     backward call, no forward without lse: checked), the permutes by
     direction (checked) and their bytes, seconds and peak memory a rank
     (the parent computes the references meanwhile); then the `--tp 2` server of
     the 28-block checkout (rank 0 by `build_server`, rank 1 by
     `serve.server.main`, the follower's path) against the one-process
     pipeline (relative L2 ≤ TP_SERVE_TOL), a served row with another
     batch-mate bit for bit, 224 kernel-1 launches a batch a rank, each
     rank's sampler device ms, all-reduces and peak memory; meanwhile
     this process runs `generate --tp 2 --device cuda:0`, whose follower
     `tp.launch` starts (a PNG, 224 launches and 336 all-reduces on rank
     0). main() itself runs with --tp 1 in the NCCL world;
  6b. moe: the mixture-of-experts PixArt (`models/moe.py`, no kernel of its
     own): a tiny MoE TDM step (capacity factor 0.6) on the card against
     the CPU with its dropped pairs and the tokens routed otherwise
     counted; main() with --moe_experts 4 --use_8bit_adam at batch 4,
     512², full width (1.50 B parameters a model copy), 3 steps: s/step,
     the idle share, peak memory, kernels 1–3's launches per step
     (checked, the dense step's), the dropped share of pairs per call, the
     MoE parts' device ms in the profiled step beside their bound; the
     exported fp16 student (JAX layout) served through from_pretrained, a
     batch of 4 at 4 NFE against the student's own sampler (one bf16 ulp
     of the latents' scale; the files deleted after);
  7. train_lora: the same run with a rank-32 LoRA student, 8-bit Adam and
     gradient accumulation 2 (2 optimizer steps of 2 micro-steps): the
     attention launches of every micro-step, the factors unchanged inside
     each window, int8 moments and the rank-32 kohya file (checked);
     seconds per optimizer step, peak memory, the idle share and device
     launches of a profiled micro-step, and each optimizer's launches per
     update of the full-width critic and of the LoRA factors;
  8. sd3: a full-width SD3-Medium pipeline (24 layers, 24x64 heads, 1024²,
     bf16, attn_impl='splash'; the seeded weights of the SD3 checkout that
     phases 9 and 10 read too, converted and kept at fp16) with a seeded
     rank-64 kohya LoRA on the default targets, written in the tdm_tpu
     layout and served over HTTP with --lora_scale 0.125: 8 concurrent
     requests (two batches of 4), exactly 96 splash-kernel launches and no
     flash launch per batch,
     per-seed determinism, a profiled batch, and one full-width forward
     through the splash kernel against the same forward through the flash
     kernel;
  9. diffusers: stock diffusers checkouts at full width, written from the
     seed through the port's manifests (fp16 files, the released key
     layout): a tiny KL decoder on the card against the CPU (fp32, TF32
     off); PixArt-α-512 with its 4-channel AutoencoderKL served over HTTP
     from --model <checkout> (load seconds with the read and the conversion
     apart, 6 concurrent requests, PNG checks, per-seed determinism,
     exactly 224 flash-kernel launches per batch, a profiled batch with the
     KL decode's device time); SD3-Medium with its 16-channel AutoencoderKL
     and its text_encoder, _2, _3 (CLIP-L, OpenCLIP-G, T5-XXL) through
     from_pretrained at the default attn_impl with hash tokenizers passed
     (load seconds, the encoders' apart, one warm batch of 4 raw prompts at
     1024² through the pipeline, timed, exactly 96 flash-kernel launches and
     nothing else, finite images, the peak memory; the same batch from its
     prompt_embeds timed apart from the batch-4 encode; a profiled batch with
     the decode's share and the kernel's ms per call; CLIP-L, CLIP-G and
     T5 at 256 tokens in bf16 against fp32 and their encode times); and
     the PixArt checkout's transformer through `python -m
     tdm_tpu_torch.cli.convert_checkpoint` (--check-manifest, --src/--dst,
     --reverse): the reversed state dict equal to the checkout's tensor by
     tensor, the param file through load_params and the weight carry
     giving the served transformer's weights and one forward bit for bit
     (each file deleted after; seconds and GB printed);
 10. train_sd3: full-width SD3-Medium TDM training through the CLI's main()
     with the recipe's flags (--model_family sd3 at 512², batch 4, bf16,
     dmd, rank-32 LoRA student, 8-bit Adam, --gradient_checkpointing, 3
     steps), the teacher from the SD3 checkout's transformer/ folder, a
     seeded pooled cache and a seeded TAESD3 for one validation grid:
     load seconds, seconds per step, peak memory, the idle share and top
     device operations of a profiled step, each training kernel's launches
     per step (checked), and the kohya LoRA loaded back into the SD3
     pipeline;
 11. sd15: a small SD1.5 pipeline at head dims 80 and 160 with a merged
     LoRA, fp32, on the card against the CPU; then a full-width SD1.5
     diffusers checkout (the UNet at 320/640/1280/1280, 8 heads, context
     768, fp16, and its KL VAE, written from the seed through the port's
     manifests) served over HTTP from --model <a view of the checkout
     without its text_encoder/, so that the cache serves> with a seeded
     rank-64 kohya LoRA on the attention projections (--lora) and a CLIP-L
     embedding cache: 8 concurrent requests (two batches of 4 at 512², 4
     NFE, DPM-Solver++ on the scaled-linear grid) and one alone, PNGs that
     are not constant, per-seed determinism, exactly 128 kernel-1 launches
     and nothing else per batch, a profiled batch (48 of its launches at
     head dim 160, by kernel name), the KL decode alone, the load seconds,
     peak memory, and one full-width UNet forward against plain attention;
     then the same server as `python -m tdm_tpu_torch.serve.server` in a
     subprocess (which sets its fp32 precision itself) answers the lone
     request with the in-process server's PNG bytes, its KL decode timed
     by CUDA events beside the in-process one; then the checkout through
     from_pretrained with a hash tokenizer passed: its CLIP-L
     text_encoder/, one batch of 4 raw prompts (128 launches), CLIP-L in
     bf16 against fp32 and its encode time;
 12. train_sd15: full-width SD1.5 TDM training through the CLI's main() at
     the JAX CLI's defaults plus --gradient_checkpointing (--model_family
     sd15 at 512², batch 4, bf16 on fp32 masters, dmd, AdamW, 3 steps), the
     teacher from the SD1.5 checkout's unet/ folder, a seeded CLIP-L cache
     with ragged masks and a seeded TAESD for one validation grid: first
     one full-width step on one batch without remat, with it and with it
     again, bit for bit; then seconds per step, peak memory, the idle share
     and top device operations of a profiled step, each training kernel's
     launches per step (checked) and by padded head dim in the profiled
     step (checked), and the rank-32 export's seconds, keys and one
     kernel's reconstruction against a float64 SVD (checked);
 13. cogvideox: a full-width CogVideoX-2B diffusers checkout (30 layers,
     30x64 heads, T5 4096, fp16 in the released transformer key layout;
     the AutoencoderKLCogVideoX decoder in tdm_tpu's key layout), written
     from the seed through the port's manifests with a seeded T5 cache
     [4, 226, 4096] and a seeded rank-64 kohya LoRA, served over HTTP
     with --lora_scale 1 --num_frames 49 --batch_size 2: two concurrent
     requests (one batch) and one of them alone, GIF structure
     (GIF89a, 720x480, 49 frames, 12 cs delays, the loop block) read
     without an imaging package and two frames of each decoded, per-seed
     determinism (the same GIF bytes alone and in the batch),
     exactly 120 kernel-1 launches and nothing else per batch; a profiled
     batch of one video (kernel 1's ms a call, the transformer's and the 3D decode's
     device time by CUDA events, the idle share, peak memory), the load
     seconds, a video's decode timed in the profiled batch, the decode's
     operations and the GIF encode's seconds, one full-width forward
     against plain attention head by head, and the decoder's per-tap
     causal conv against F.conv3d (cuDNN, a yardstick), repeated bit for
     bit; the serving peak (the server is built on a view of the checkout
     without its text_encoder/, so no encoder is resident); then the
     checkout through from_pretrained with a hash tokenizer passed: one
     batch of 2 raw prompts to latents (120 launches), T5 at 226 tokens in
     bf16 against fp32 and its encode time; then the 3D VAE's encoder
     (`VAE3DEncoder`) at CogVideoX-2B's widths with seeded weights: a
     9-frame 32x48 clip on the card against the CPU (fp32, within
     ENCODER_TOL), one 9-frame 480x720 encode timed with its peak memory;
 14. train_cogvideox: full-width CogVideoX-2B TDM training through the
     CLI's main() with the recipe's flags (--model_family cogvideox
     --num_frames 49, batch 2, bf16 on fp32 masters, dmd, rank-64 LoRA
     student, 8-bit Adam, --gradient_checkpointing, 3 steps), the teacher
     from the CogVideoX checkout's transformer/ folder, a seeded T5 cache
     with ragged masks and a TAESD3 in $TDM_TAESD_DIR that the video run
     leaves unread: first one full-width step at 2 blocks and batch 1
     without remat, with it and with it again, bit for bit; then load
     seconds, seconds per step, peak memory, the idle share and top device
     operations of a profiled step, each training kernel's launches per
     step (checked, and by template arguments in the profiled step), and
     the rank-64 kohya LoRA loaded back into the checkout's pipeline, one
     4-NFE latent with it and one without.
Phase 3 also holds the ring (`ops/ring_attention.py`, `phase_kernels_ring`)
in a world of one: against the plain ring at a mid shape with an
all-masked batch row (exact zeros, lse +1e30), and at the full hop shape of
--sp 2 at 61 frames against one monolithic kernel 1/2/3 call; each hop shape
timed in turns with SDPA, and SDPA over one rank's whole call.
Phase `probe`: the TDM distill probe
(`eval/distill_probe.run_probe`) at the JAX defaults on the card (700
decoder steps, 3000 DSM steps, 500 TDM steps, n_eval 256): its gap
closure, errors and losses, each stage's seconds, and the five bars of
tests/test_tdm_image_e2e.py, checked (PROBE_BARS). With the train phase it
runs in this process while that phase's two rank processes run (its
seconds then share the card and the host with them); else after reference.
Each phase prints `[timing] <phase> <seconds>`. Phase 3 also holds kernel 1
and kernel 4 at CogVideoX-2B's [1,30,17776,17776,64] and
[2,30,17776,17776,64] (no mask) against the plain version computed head by
head, timed in turns with SDPA, and the training kernels (the forward with
its lse, dQ with its fused Δ, dK/dV) at [2,30,17776,17776,64] against
their plain versions head by head, timed in turns with SDPA's forward and
backward; phase 4 also runs the tiny CogVideoX pipeline under both
position schemes, tiled and streamed, on the card against the CPU, and one
tiny cogvideox TDM step, plain and as the recipe's LoRA student with 8-bit
Adam and accumulation 2. Phase 3 also holds kernel 1 at SD1.5's head dims
40, 136 and 160 (ragged, masked and all-masked rows, bf16 and fp32) and
times its eight SD1.5
shapes in turns with SDPA; it also holds the training kernels (the forward
with its lse, dQ with its fused Δ, dK/dV) at one PixArt block's shapes and
SD3 training's
[4,24,1178,1178,64] and [8,24,1178,1178,64] (the forward without lse too,
all timed in turns with SDPA), SD1.5 training's eight shapes at head dims
40, 80 and 160 (batch 4, 8 heads, cross over 77 ragged CLIP tokens, timed
in turns with SDPA) with fp32 checks at 136 and 160, and the splash kernel (SD3's
[4,24,4429,4429,64], ragged fp32 shapes, rows whose logits are all below
-20) against their plain versions; phase 4 runs one tiny train step, the
same step with a LoRA student, 8-bit Adam and accumulation 2, one tiny sd3
step, one tiny sd15 step, and a tiny SD3 pipeline with a merged LoRA on the card against the
same on the CPU; phase 7 also trains the tiny PixArt model for 2 steps
through main() on the card with its prompts read from a .txt shard by the
native C++ loader (checked), and times that loader's host seconds per batch
against the Python batcher's.

int8 and the offline verbs, inside those phases: in serve, sd3, sd15 and
cogvideox, one batch of the served pipeline at `pipe.quant = "int8"`
against bf16 (same conditioning and noise, latents out; CogVideoX at 13
frames, 4 latent frames, for the clock): the int8
products a batch (`int8_dot`'s count, and `aten::_int_mm` in a profiled
forward) against the Dense calls the gate admits, reckoned from the
model's modules and shapes on the meta device (`reckon_gated`), the
attention launches unchanged, the bf16 bits unchanged after an int8
batch, a row's int8 bits the same with other batch-mates, the latents
within 0.15 (relative L2) of bf16, the sampler's device ms and the
batch's wall ms in turns, the quantize/rescale share of a profiled int8
forward; serve also answers one raw request from a server started with
`--quant int8` (the bundle without its T5, serving the build_cache cache), and
runs `cli.generate.main` on the PixArt bundle (a directory of 4 PNGs at
--quant int8, from raw prompts); train runs main() again with
--quant_forwards for 2 steps (int8 products per step against the gate's
count over the forwards JAX wraps in q(), kernels 1-3 launches unchanged,
s/step, peak); sd15 runs `cli.evaluate.main` with --compare_teacher (28
steps, cfg 7) on a seeded CLIP ViT-L/14
folder with a hash tokenizer (written, then deleted), and the vision
tower in bf16 against fp32; cogvideox runs `cli.generate.main` to a GIF of
13 frames (GEN_GIF_FRAMES); reference holds int8_dot, the CLIP vision
tower, preprocess_images and both image VAE encoders on the card against
the CPU. The kernels phase times 2 rounds of 10 launches in turns;
train_sd3, train_sd15 and train_cogvideox take 3 steps, and they, train
and the --quant_forwards run write no final checkpoint
(`no_final_checkpoint`: the train_lora phase writes the checkpoint path's
files and times them), and all but train write no fp16 student
(`no_student_export`: train writes PixArt's and sizes it). For the clock, cogvideox serves its lone request
once (its GIF bytes held against the batch's) and decodes no latent of its
own: the decode is timed inside the profiled batch, whose first video the
GIF encode takes (the route's repeatability is
conv3d_route_check's). The train phases' profiled step records the card's
activity alone (the `moe` phase the CPU's ops too, for its parts' ranges),
and the two ranks' checks run at RANK_LAYERS blocks.

Then a JSON line of per-kernel
numbers, the nvidia-smi line, and as the last line {"ok": true, "device":
{...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import zlib

# H100 SXM dense peaks (NVIDIA data sheet), for the bound of each kernel
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

# PixArt-α-512 attention shapes at serving batch 4
PIX_B, PIX_H, PIX_S, PIX_D, PIX_TXT = 4, 16, 1024, 72, 120
# SD3-Medium 1024² joint attention at serving batch 4: 4096 image + 333 text
# tokens (77 CLIP + 256 T5)
SD3_B, SD3_H, SD3_TXT, SD3_D = 4, 24, 333, 64
SD3_S = 4096 + SD3_TXT
# SD3-Medium training at the CLI's default --resolution 512: 1024 image + 154
# T5 tokens of joint attention, the grad forwards at batch 4 and the
# teacher's CFG probe at 8
SD3T_B, SD3T_TXT = 4, 154
SD3T_S = 1024 + SD3T_TXT
# bf16, per batch row (all masked: exactly 0): relative L2 error under
# BF16_REL_L2 and max |kernel - plain| under BF16_ULPS bf16 ulps of the row's
# largest |plain|. Both versions round the output to bf16 (half an ulp) and
# round p to bf16 at different points (unnormalised in the kernel,
# normalised in the plain version), a relative L2 of a few 1e-3 at most; a
# wrong rescale or a dropped key shows as more.
BF16_REL_L2, BF16_ULPS = 1e-2, 4
# fp32, elementwise |kernel - plain| <= atol + rtol·|plain|: the same sums
# in another order.
F32_TOL = (2e-5, 2e-5)
# fp32 at SD1.5's head dims 40 and 160 (outputs are O(1) averages of v):
# max |kernel - plain| under 1e-5
SD15_F32_ATOL = 1e-5
# SD1.5 at 512², batch 4, 8 heads: its attention calls [B, H, Sq, Sk, D] by
# level (64² latent: 4096 tokens at width 320, D 40; 1024 at 640, D 80; 256
# at 1280, D 160; the mid block's 64 at D 160), each self-attention unmasked
# and each cross-attention over the 77 CLIP tokens, with the calls of each
# per batch of 4 NFE (5 transformers at D 40 and at D 80, 6 at D 160, one
# of them the mid block's)
SD15_B, SD15_H, SD15_TXT = 4, 8, 77
SD15_SHAPES = (  # name, sq, sk, d, calls per batch
    ("sd15_self_d40", 4096, 4096, 40, 20), ("sd15_cross_d40", 4096, SD15_TXT, 40, 20),
    ("sd15_self_d80", 1024, 1024, 80, 20), ("sd15_cross_d80", 1024, SD15_TXT, 80, 20),
    ("sd15_self_d160", 256, 256, 160, 20), ("sd15_cross_d160", 256, SD15_TXT, 160, 20),
    ("sd15_mid_self_d160", 64, 64, 160, 4), ("sd15_mid_cross_d160", 64, SD15_TXT, 160, 4),
)
# CogVideoX-2B at 49 frames, 480×720: 226 T5 tokens + 13·30·45 video tokens
# in one unmasked joint attention per block, 30 heads × 64; 30 blocks × 4 NFE
# launches of kernel 1 per batch
COG_H, COG_D, COG_TXT = 30, 64, 226
COG_S = COG_TXT + 13 * 30 * 45
COG_LAUNCHES_PER_BATCH = 30 * 4
# CogVideoX-2B training at 49 frames, 480×720 (latents [16, 13, 60, 90]) with
# the recipe's flags at the video pipeline's batch 2, 3 optimizer steps (the
# smoke's clock: the first warms, the second is timed, the third profiled)
COG_TRAIN_B, COG_TRAIN_STEPS, COG_LORA_RANK = 2, 3, 64
# per step (dmd, cfg 4.5, one critic update, --gradient_checkpointing): 7
# forwards without grad (rollout x4, x0_gen_sg, the teacher's CFG probe at
# 2B, the critic probe) and 2 with grad (critic DSM, student loss), each 30
# joint attentions; every grad forward's blocks run again in the backward's
# recompute
COG_TRAIN_LAUNCHES = {"flash_attention_fwd": 7 * 30, "flash_attention_fwd_lse": 2 * 2 * 30,
                      "flash_attention_bwd_dq": 2 * 30, "flash_attention_bwd_dkv": 2 * 30,
                      "splash_attention_fwd": 0}
# kernel 1's launches per SD1.5 batch (16 transformers, self + cross, 4 NFE)
# and those at head dim 160 (6 transformers)
SD15_LAUNCHES_PER_BATCH = 16 * 2 * 4
SD15_D160_PER_BATCH = 6 * 2 * 4
# SD1.5 training at 512², batch 4 (the grad forwards), bf16: the self and
# cross calls of each level (cross over 77 CLIP tokens with ragged masks)
SD15T_LENGTHS = [77, 40, 13, 5]
SD15T_SHAPES = (  # name, sq, sk, d
    ("sd15_train_self_d40", 4096, 4096, 40), ("sd15_train_cross_d40", 4096, SD15_TXT, 40),
    ("sd15_train_self_d80", 1024, 1024, 80), ("sd15_train_cross_d80", 1024, SD15_TXT, 80),
    ("sd15_train_self_d160", 256, 256, 160), ("sd15_train_cross_d160", 256, SD15_TXT, 160),
    ("sd15_train_mid_self_d160", 64, 64, 160),
    ("sd15_train_mid_cross_d160", 64, SD15_TXT, 160),
)
# the lse of a row with live keys, fp32, kernel against plain: the same
# logits, exp by __expf or expf, the sums in another order
LSE_TOL = 1e-4
# fp32 gradients through the kernels against autograd of plain_attention,
# relative to each tensor's largest magnitude: the same sums in another order
GRAD_TOL = 1e-4
# the dQ kernel's Δ = rowsum(dO∘O) against attention_delta, relative to the
# largest |Δ|: fp32 sums of the same products in another order
DELTA_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(torch, fns: dict, rounds: int = 2, iters: int = 10) -> dict:
    """Time each callable of `fns` in turns: `rounds` rounds of `iters`
    launches each (CUDA-event mean per launch), the order reversed every
    other round (a, b, b, a, ...), after a warm-up of each. Returns, per
    name, the median, min and max of the rounds' means: a library call's
    time moves between calls, so one reading is no yardstick."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    runs = {name: [] for name in fns}
    for r in range(rounds):
        for name, fn in (list(fns.items()) if r % 2 == 0 else reversed(list(fns.items()))):
            runs[name].append(time_ms(torch, fn, iters, 0))
    return {name: {"median": statistics.median(v), "min": min(v), "max": max(v)}
            for name, v in runs.items()}


def spread(t: dict) -> str:
    return f"{t['median']:.4f} ms (min {t['min']:.4f}, max {t['max']:.4f})"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | sm_{cap[0]}{cap[1]} | "
          f"count {torch.cuda.device_count()}", flush=True)
    check(cap == (9, 0), f"kernels target sm_90a, card is sm_{cap[0]}{cap[1]}")
    # the plain references run in full fp32 (section 6 of the kernel guide)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "kind": kind}


def _short_name(mangled: str) -> str:
    """`flash_fwd_sm90_kernel<80,1>` from the mangled name of a kernel
    template instance (its length-prefixed name, then the integer and bool
    template arguments)."""
    for m in re.finditer(r"(\d+)([A-Za-z_])", mangled):
        start, n = m.start(2), int(m.group(1))
        name = mangled[start:start + n]
        if name.endswith("_kernel") and mangled[start + n:start + n + 1] == "I":
            args = mangled[start + n + 1:].split("EE", 1)[0] + "E"
            return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args))}>"
    return mangled


def _cuobjdump() -> str | None:
    import importlib.util

    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "cuobjdump"))
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        cands.append(os.path.join(spec.submodule_search_locations[0], "backends",
                                  "nvidia", "bin", "cuobjdump"))
    return next((c for c in cands if c and os.path.exists(c)), None)


def kernel_resources(libs: dict) -> dict:
    """Per kernel of each built library: registers, spill bytes and static
    shared memory from nvcc's -Xptxas -v report (this run's build log), and
    its HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS that
    cuobjdump -sass shows."""
    from tdm_tpu_torch.ops import _build

    tool = _cuobjdump()
    out = {}
    for name, path in libs.items():
        funcs = {}
        cur = None
        for ln in _build.build_log.get(name, {}).get("ptxas", "").splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
            if m:
                cur = funcs.setdefault(_short_name(m.group(1)), {})
            elif cur is not None and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
                cur.update(spill_stores=int(st), spill_loads=int(ld))
            elif cur is not None and "registers" in ln:
                cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
                smem = re.search(r"(\d+) bytes smem", ln)
                cur["static_smem"] = int(smem.group(1)) if smem else 0
        if tool:
            sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                                  text=True, timeout=120).stdout
            cur = None
            for ln in sass.splitlines():
                m = re.search(r"Function : (\w+)", ln)
                if m:
                    cur = funcs.setdefault(_short_name(m.group(1)), {})
                    cur.update(hgmma=0, hmma=0)
                elif cur is not None:
                    cur["hgmma"] += "HGMMA." in ln
                    cur["hmma"] += " HMMA." in ln
        out[name] = funcs
    return out


def phase_build() -> dict:
    """Build every kernel; print each kernel's registers, spills, shared
    memory and wgmma/mma.sync instruction counts; check that the bf16
    kernels of kernels 1-4 run on wgmma, that no mma.sync is left in their
    libraries and that the backward's bf16 kernels spill nothing."""
    import ctypes

    from tdm_tpu_torch.ops import _build

    names = _build.kernel_names()
    # a fresh build: ptxas reports registers and spills only while compiling
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.monotonic()
    libs = _build.build(names)
    secs = time.monotonic() - t0
    print(f"[build] {names} in {secs:.1f}s (nvcc sm_90a)", flush=True)
    res = kernel_resources(libs)
    for lib, funcs in res.items():
        for fn, r in funcs.items():
            print(f"[build]   {lib}: {fn} registers {r.get('registers', 'n/a')} spill "
                  f"{r.get('spill_stores', 'n/a')}/{r.get('spill_loads', 'n/a')} B static "
                  f"smem {r.get('static_smem', 'n/a')} B HGMMA {r.get('hgmma', 'n/a')} "
                  f"HMMA {r.get('hmma', 'n/a')}", flush=True)
    for lib in ("flash_fwd", "splash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        sm90 = {fn: r for fn, r in res[lib].items() if "sm90_kernel" in fn}
        check(bool(sm90) and all(r.get("hgmma", 0) > 0 for r in sm90.values()),
              f"{lib}: a bf16 kernel without HGMMA (wgmma) in its SASS: {sm90}")
        check(all(r.get("hmma", 0) == 0 for r in res[lib].values()),
              f"{lib}: mma.sync (HMMA) left in the library")
        if lib.startswith("flash_bwd"):
            check(all("spill_stores" in r and "spill_loads" in r for r in sm90.values()),
                  f"{lib}: ptxas reported no spills for a bf16 kernel: {sm90}")
            check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                      for r in sm90.values()), f"{lib}: a bf16 kernel spills: {sm90}")
    smem = {}
    for lib, fn_name, keys in (
            ("flash_fwd", "tdm_attn_fwd_smem_bytes", ((64,), (80,), (128,), (160,))),
            ("splash_fwd", "tdm_attn_fwd_smem_bytes", ((64,), (128,))),
            ("flash_bwd_dq", "tdm_flash_bwd_dq_smem_bytes", ((64,), (80,), (128,), (160,))),
            ("flash_bwd_dkv", "tdm_flash_bwd_dkv_smem_bytes",
             tuple((d, g) for d in (64, 80, 128, 160) for g in (1, 2)))):
        fn = getattr(ctypes.CDLL(str(libs[lib])), fn_name)
        smem[lib] = {"/".join(map(str, key)): fn(*key) for key in keys}
        print(f"[build]   {lib}: dynamic shared memory per CTA by head dim"
              f"{' / consumer warpgroups' if lib == 'flash_bwd_dkv' else ''} {smem[lib]} B",
              flush=True)
    return {"resources": res, "dynamic_smem": smem}


def _attn_inputs(torch, gen, b, h, sq, sk, d, dtype, lengths):
    from tdm_tpu_torch.ops import attention as A

    dev = "cuda"
    q = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, h, sk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, h, sk, d, generator=gen, device=dev).to(dtype)
    mask = None
    if lengths is not None:
        mask = (torch.arange(sk, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
    qs = (q.float() / d ** 0.5).to(dtype)
    bias = None if mask is None else A.key_bias(mask)
    return q, k, v, mask, qs, bias


def attention_work(b, h, sq, sk, d, item_bytes, live_keys, bias=True):
    """(bytes, operations) the function needs at this run's mask: q read and
    the output written once, k and v read once for each unmasked key, the
    key bias read once (when the kernel takes one); 4·d operations (two
    multiply-adds) per (query, unmasked key) pair. `live_keys` is the
    unmasked keys summed over the batch."""
    nbytes = item_bytes * h * d * (2 * b * sq + 2 * live_keys) + (4 * b * sk if bias else 0)
    return nbytes, 4 * h * sq * d * live_keys


def bound_ms(nbytes, ops, dtype_name="bfloat16"):
    """Least time on the card: the larger of bytes over the memory rate and
    operations over the dtype's peak. Returns (ms, bound_by)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def compare(torch, out, ref) -> tuple:
    """(max_abs_err, rel_l2, failure or None) of the kernel's output
    against the plain version's, by the tolerance of out's dtype."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rel = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
    if out.dtype == torch.float32:
        excess = (diff - F32_TOL[0] - F32_TOL[1] * ref.float().abs()).max().item()
        if excess > 0:
            return err, rel, (f"max_abs_err {err:.3e} outside atol {F32_TOL[0]} "
                              f"+ rtol {F32_TOL[1]}·|plain|")
        return err, rel, None
    for i in range(out.shape[0]):
        o, r = out[i].float(), ref[i].float()
        top = r.abs().max().item()
        if top == 0:
            if bool((o != 0).any()):
                return err, rel, f"row {i}: all keys masked but output not 0"
            continue
        row_rel = ((o - r).norm() / r.norm()).item()
        row_err = (o - r).abs().max().item()
        if row_rel > BF16_REL_L2 or row_err > BF16_ULPS * bf16_ulp(top):
            return err, rel, (
                f"row {i}: rel L2 {row_rel:.3e} (limit {BF16_REL_L2}), max_abs_err "
                f"{row_err:.3e} (limit {BF16_ULPS} ulps of {top:.3g} = "
                f"{BF16_ULPS * bf16_ulp(top):.3e})")
    return err, rel, None


def sd3_train_cases(torch) -> list:
    """SD3-Medium training's joint attention at head dim 64, no key mask:
    the grad forwards' [4,24,1178,1178,64] and the CFG probe's batch of 8."""
    return [(f"sd3_train_b{b}", b, SD3_H, SD3T_S, SD3T_S, SD3_D, torch.bfloat16, None, True)
            for b in (SD3T_B, 2 * SD3T_B)]


def sd15_train_cases(torch) -> list:
    """SD1.5 training's attention calls at batch 4, 8 heads, bf16 (timed),
    and fp32 checks at head dims 136 and 160 with ragged, masked and
    all-masked batch rows."""
    return [*((name, SD15_B, SD15_H, sq, sk, d, torch.bfloat16,
               None if sq == sk else SD15T_LENGTHS, True) for name, sq, sk, d in SD15T_SHAPES),
            *((f"sd15_train_ragged_d{d}_float32", 3, 2, 333, 200, d, torch.float32,
               [200, 129, 0], False) for d in (136, 160)),
            ("sd15_train_ragged_d160_bfloat16", 3, 2, 333, 200, 160, torch.bfloat16,
             [200, 129, 0], False)]


def group_of(shape_name: str) -> str:
    """The path a timed shape belongs to: SD3 training, SD1.5 training,
    SD1.5 serving, or one PixArt block."""
    for group in ("sd3_train", "sd15_train", "sd15"):
        if shape_name.startswith(group):
            return group
    return "pixart"


def phase_kernels(torch, seed: int) -> dict:
    """Hold the flash kernel against its plain version; time both, SDPA and
    the bound at the two PixArt shapes, SD3 training's two shapes and the
    eight SD1.5 serving shapes. SD1.5's head dims 40 (the 64-column panel)
    and 160 (three panels, 64-key tiles) and 136 are held on ragged shapes
    with a masked, a ragged and an all-masked batch row, bf16 and fp32 (fp32
    within SD15_F32_ATOL)."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A

    fwd, _ = A._entry("tdm_flash_fwd")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, h, sq, sk, d, dtype, lengths, timed
        ("self", PIX_B, PIX_H, PIX_S, PIX_S, PIX_D, bf16, None, True),
        ("cross", PIX_B, PIX_H, PIX_S, PIX_TXT, PIX_D, bf16,
         [120, 77, 13, 0], True),
        ("odd", 2, 3, 1000, 77, 64, f32, [77, 40], False),
        ("odd_bf16", 2, 3, 1000, 77, 64, bf16, [77, 0], False),
        ("odd_d72_bf16", 3, 2, 333, 200, 72, bf16, [200, 129, 1], False),
        *sd3_train_cases(torch),
        *((f"sd15_ragged_d{d}_{str(dt).split('.')[-1]}", 3, 2, 333, 200, d, dt,
           [200, 129, 0], False) for d in (40, 136, 160) for dt in (bf16, f32)),
        *((name, SD15_B, SD15_H, sq, sk, d, bf16, None if sq == sk else [sk] * SD15_B, True)
          for name, sq, sk, d, _ in SD15_SHAPES),
    ]
    for d in (8, 16, 36, 64, 100, 128):
        for dtype in (bf16, f32):
            cases.append((f"sweep_d{d}_{str(dtype).split('.')[-1]}", 2, 2, 130,
                          70, d, dtype, [70, 33], False))
    shapes = []
    max_err = 0.0
    for name, b, h, sq, sk, d, dtype, lengths, timed in cases:
        q, k, v, mask, qs, bias = _attn_inputs(
            torch, gen, b, h, sq, sk, d, dtype, lengths)
        before = A.flash_attention_fwd.launches
        out = A.flash_attention_fwd(qs, k, v, bias)
        A.flash_attention_fwd.launches = before  # comparison launches do not count
        ref = A.plain_attention(qs, k, v, bias)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err, rel, bad = compare(torch, out, ref)
        tol = (f"per row rel L2 <= {BF16_REL_L2}, max_abs_err <= {BF16_ULPS} "
               f"bf16 ulps of max|plain|" if dtype == bf16 else
               f"atol {F32_TOL[0]:g} + rtol {F32_TOL[1]:g}·|plain|")
        print(f"[kernels] flash_fwd {name} [{b},{h},{sq},{sk},{d}] "
              f"{str(dtype).split('.')[-1]} max_abs_err {err:.3e} rel_l2 "
              f"{rel:.3e} ({tol})", flush=True)
        check(bad is None, f"{name}: {bad}")
        check(not (name.startswith("sd15") and dtype == f32 and err > SD15_F32_ATOL),
              f"{name}: max_abs_err {err:.3e} above {SD15_F32_ATOL}")
        max_err = max(max_err, err)
        if not timed:
            continue
        stream = torch.cuda.current_stream().cuda_stream
        args = (qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(), None,
                b, h, sq, sk, d, 1, stream)
        sdpa_mask = None if mask is None else mask.bool()[:, None, None, :]
        turns = time_turns(torch, {
            "kernel": lambda: fwd(*args),
            "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)})
        ms, lib_ms = turns["kernel"]["median"], turns["sdpa"]["median"]
        plain_ms = time_ms(torch, lambda: A.plain_attention(qs, k, v, bias), 20)
        live = sk * b if lengths is None else sum(lengths)
        nbytes, ops = attention_work(b, h, sq, sk, d, 2, live)
        bound, by = bound_ms(nbytes, ops)
        rec = {"shape": name, "group": group_of(name), "dims": [b, h, sq, sk, d], "ms": ms,
               "ms_range": [turns["kernel"]["min"], turns["kernel"]["max"]],
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_ms_range": [turns["sdpa"]["min"], turns["sdpa"]["max"]],
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "rel_l2": rel, "bytes": nbytes, "ops": ops}
        shapes.append(rec)
        print(f"[kernels] flash_fwd {name} in turns with SDPA: kernel "
              f"{spread(turns['kernel'])} ({ms / bound:.1f}x bound, {ms / lib_ms:.2f}x "
              f"SDPA) | sdpa {spread(turns['sdpa'])} | plain_ms {plain_ms:.4f} | "
              f"bound_ms {bound:.5f} ({by})", flush=True)
    return {"max_abs_err": max_err, "shapes": shapes}


def attention_bwd_work(kernel, b, h, sq, sk, d, item_bytes, live_keys, bias=True):
    """(bytes, operations) of one training kernel at this run's mask, each
    input read once and each output written once (the fp32 key bias only
    when the call has one). `live_keys` is the
    unmasked keys summed over the batch; K and V are read for those keys
    only, and the products are counted per (query, unmasked key) pair:
      fwd_lse: q read, out written, K/V read, bias read, lse written;
               2 products (S, P·V) = 4·d operations per pair;
      dq:      q, dO and O read, dQ written, K/V read, lse read, Δ written,
               bias read; 3 products (S, dP, dS·K) = 6·d per pair (Δ's
               d multiply-adds per row are left out);
      dkv:     q, dO read, K/V read, dK and dV written in full, lse and Δ
               read, bias read; 4 products (S, Pᵀ·dO, dP, dSᵀ·Q) = 8·d."""
    rows = item_bytes * h * d * b * sq  # one [B,H,Sq,D] tensor
    kv = item_bytes * h * d * live_keys  # K or V over the unmasked keys
    full_k = item_bytes * h * d * b * sk
    row_f32 = 4 * b * h * sq  # lse or Δ
    bias = 4 * b * sk if bias else 0
    if kernel == "fwd_lse":
        return 2 * rows + 2 * kv + bias + row_f32, 4 * h * sq * d * live_keys
    if kernel == "dq":
        return 4 * rows + 2 * kv + 2 * row_f32 + bias, 6 * h * sq * d * live_keys
    if kernel == "dkv":
        return (2 * rows + 2 * kv + 2 * full_k + 2 * row_f32 + bias,
                8 * h * sq * d * live_keys)
    raise ValueError(kernel)


def compare_grad(torch, got, ref) -> tuple:
    """compare() for a gradient: bf16 by the same per-row rule; fp32 with
    max |kernel - plain| <= GRAD_TOL of the largest |plain| (a gradient is a
    sum of terms that cancel, so elementwise relative error means little)."""
    if got.dtype != torch.float32:
        return compare(torch, got, ref)
    diff = (got - ref).abs()
    err = diff.max().item()
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    top = ref.abs().max().item()
    if err > GRAD_TOL * top:
        return err, rel, f"max_abs_err {err:.3e} above {GRAD_TOL} of {top:.3e}"
    return err, rel, None


def compare_lse(torch, got, ref) -> tuple:
    """(max_abs_err, failure or None) of the kernel's lse against the plain
    version's: rows of an all-masked batch row hold exactly +1e30, the rest
    agree to LSE_TOL (fp32 logsumexp of the same logits, __expf and another
    order of sums)."""
    masked = ref >= 1e29
    if bool((got[masked] != ref[masked]).any()):
        return float("inf"), "an all-masked row's lse is not +1e30"
    if bool(masked.all()):
        return 0.0, None
    err = (got[~masked] - ref[~masked]).abs().max().item()
    if err > LSE_TOL:
        return err, f"lse max_abs_err {err:.3e} above {LSE_TOL}"
    return err, None


def phase_kernels_train(torch, seed: int) -> dict:
    """The training kernels (forward with lse, dQ with its fused Δ, dK/dV)
    against their plain versions at the training shapes (one PixArt block,
    SD3's two, SD1.5's eight at head dims 40, 80 and 160) and a sweep, the
    fp32
    gradients of FlashAttention against autograd of plain_attention, exact
    zeros on all-masked rows, and the times of each kernel, its plain
    version, its bound and SDPA's forward + backward."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("self", PIX_B, PIX_H, PIX_S, PIX_S, PIX_D, bf16, None, True),
        ("cross", PIX_B, PIX_H, PIX_S, PIX_TXT, PIX_D, bf16, [120, 77, 13, 0], True),
        ("odd", 2, 3, 1000, 77, 64, f32, [77, 0], False),
        ("odd_bf16", 3, 2, 333, 200, 72, bf16, [200, 129, 0], False),
        *sd3_train_cases(torch),
        *sd15_train_cases(torch),
    ]
    for d in (8, 16, 36, 64, 100, 128):
        for dtype in (bf16, f32):
            cases.append((f"sweep_d{d}_{str(dtype).split('.')[-1]}", 2, 2, 130,
                          70, d, dtype, [70, 33], False))
    names = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    recs = {n: {"max_abs_err": 0.0, "shapes": []} for n in names}
    pair = []
    for name, b, h, sq, sk, d, dtype, lengths, timed in cases:
        q, k, v, mask, qs, bias = _attn_inputs(
            torch, gen, b, h, sq, sk, d, dtype, lengths)
        dout = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
        scale = 1.0 / d ** 0.5
        before = A.launch_counts()
        out, lse = A.flash_attention_fwd_lse(qs, k, v, bias)
        ref_out, ref_lse = A.plain_attention_lse(qs, k, v, bias)
        # the backward kernels and their plain versions on the same inputs
        # (the plain forward's output and lse; dK/dV fed the plain Δ)
        ref_dq, ref_delta = A.plain_attention_bwd_dq(qs, k, v, bias, dout, ref_out, ref_lse,
                                                     scale)
        ref_dk, ref_dv = A.plain_attention_bwd_dkv(qs, k, v, bias, dout, ref_lse, ref_delta)
        dq, delta = A.flash_attention_bwd_dq(qs, k, v, bias, dout, ref_out, ref_lse, scale)
        dk, dv = A.flash_attention_bwd_dkv(qs, k, v, bias, dout, ref_lse, ref_delta)
        # ... and driven by the forward kernel's own output and lse and the
        # dQ kernel's Δ, as in training
        dq_own, delta_own = A.flash_attention_bwd_dq(qs, k, v, bias, dout, out, lse, scale)
        dk_own, dv_own = A.flash_attention_bwd_dkv(qs, k, v, bias, dout, lse, delta_own)
        for w in A.WRAPPERS:  # comparison launches do not count
            w.launches = before[w.__name__]
        torch.cuda.synchronize()
        dims = f"[{b},{h},{sq},{sk},{d}] {str(dtype).split('.')[-1]}"
        results = {
            "flash_fwd_lse": [("out", out, ref_out)],
            "flash_bwd_dq": [("dq", dq, ref_dq), ("dq from the kernel's lse", dq_own, ref_dq)],
            "flash_bwd_dkv": [("dk", dk, ref_dk), ("dv", dv, ref_dv),
                              ("dk from the kernel's lse", dk_own, ref_dk),
                              ("dv from the kernel's lse", dv_own, ref_dv)],
        }
        lse_err, lse_bad = compare_lse(torch, lse, ref_lse)
        print(f"[kernels] flash_fwd_lse {name} {dims} lse max_abs_err "
              f"{lse_err:.3e} (limit {LSE_TOL}; all-masked rows exactly +1e30)",
              flush=True)
        check(lse_bad is None, f"flash_fwd_lse {name}: {lse_bad}")
        for label, got, ref in (("delta", delta, ref_delta),
                                ("delta from the kernel's output", delta_own,
                                 A.attention_delta(dout, out))):
            err = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
            print(f"[kernels] flash_bwd_dq {name} {dims} {label}: max_abs_err {err:.3e} of "
                  f"the largest |Δ| (limit {DELTA_TOL})", flush=True)
            check(bool(torch.isfinite(got).all()) and err <= DELTA_TOL,
                  f"flash_bwd_dq {name} {label}: {err:.3e} > {DELTA_TOL}")
            recs["flash_bwd_dq"]["delta_max_err"] = max(
                recs["flash_bwd_dq"].get("delta_max_err", 0.0), err)
        for kern, outs in results.items():
            for label, got, ref in outs:
                check(bool(torch.isfinite(got).all()),
                      f"{kern} {name}: non-finite {label}")
                err, rel, bad = (compare(torch, got, ref) if kern == "flash_fwd_lse"
                                 else compare_grad(torch, got, ref))
                print(f"[kernels] {kern} {name} {dims} {label} max_abs_err "
                      f"{err:.3e} rel_l2 {rel:.3e}", flush=True)
                check(bad is None, f"{kern} {name} {label}: {bad}")
                recs[kern]["max_abs_err"] = max(recs[kern]["max_abs_err"], err)
        recs["flash_fwd_lse"]["max_abs_err"] = max(
            recs["flash_fwd_lse"]["max_abs_err"], lse_err)
        if lengths is not None:  # all-masked batch rows: exactly 0
            for i, n_live in enumerate(lengths):
                if n_live == 0:
                    check(not bool(out[i].any()) and not bool(dq[i].any())
                          and not bool(dk[i].any()) and not bool(dv[i].any()),
                          f"{name}: batch row {i} has no key but a non-zero "
                          f"output or gradient")
                check(not bool(dk[i, :, n_live:].any())
                      and not bool(dv[i, :, n_live:].any()),
                      f"{name}: a masked key got a gradient")
        if not timed:
            continue
        live = sk * b if lengths is None else sum(lengths)
        stream = torch.cuda.current_stream().cuda_stream
        bp = None if bias is None else bias.data_ptr()
        fwd, _ = A._entry("tdm_flash_fwd")
        fdq, _ = A._entry("tdm_flash_bwd_dq")
        fdkv, _ = A._entry("tdm_flash_bwd_dkv")
        calls = {
            "flash_fwd_lse": (
                lambda: fwd(qs.data_ptr(), k.data_ptr(), v.data_ptr(), bp,
                            out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, 1, stream),
                lambda: A.plain_attention_lse(qs, k, v, bias), "fwd_lse"),
            "flash_bwd_dq": (
                lambda: fdq(qs.data_ptr(), k.data_ptr(), v.data_ptr(), bp,
                            dout.data_ptr(), ref_out.data_ptr(), ref_lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, d, scale, 1,
                            stream),
                lambda: A.plain_attention_bwd_dq(qs, k, v, bias, dout, ref_out, ref_lse,
                                                 scale), "dq"),
            "flash_bwd_dkv": (
                lambda: fdkv(qs.data_ptr(), k.data_ptr(), v.data_ptr(), bp,
                             dout.data_ptr(), ref_lse.data_ptr(), ref_delta.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, 1, stream),
                lambda: A.plain_attention_bwd_dkv(qs, k, v, bias, dout, ref_lse,
                                                  ref_delta), "dkv"),
        }
        # the yardsticks (the port never calls them), on the same inputs:
        # SDPA's forward on inputs that require grad beside the lse forward,
        # its backward alone (retain_graph on one forward) beside dQ + dK/dV,
        # and forward + backward beside the port's whole training attention
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        sdpa_mask = None if mask is None else mask.bool()[:, None, None, :]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask)

        sdpa_out = sdpa_fwd()
        turns = time_turns(torch, {
            **{kern: kfn for kern, (kfn, _, _) in calls.items()},
            "sdpa_fwd": sdpa_fwd,
            "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout,
                                                    retain_graph=True),
            "sdpa_fwd_bwd": lambda: torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), dout),
        })
        times = {}
        for kern, (_, pfn, work) in calls.items():
            ms = turns[kern]["median"]
            plain_ms = time_ms(torch, pfn, 10, 2)
            nbytes, ops = attention_bwd_work(work, b, h, sq, sk, d, 2, live)
            bound, by = bound_ms(nbytes, ops)
            times[kern] = ms
            recs[kern]["shapes"].append({
                "shape": name, "group": group_of(name), "dims": [b, h, sq, sk, d], "ms": ms,
                "ms_range": [turns[kern]["min"], turns[kern]["max"]],
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "bytes": nbytes, "ops": ops})
            print(f"[kernels] {kern} {name} {spread(turns[kern])} ({ms / bound:.1f}x "
                  f"bound) plain_ms {plain_ms:.4f} bound_ms {bound:.5f} ({by})", flush=True)
        port_ms = sum(times.values())
        sdpa_fwd_ms = turns["sdpa_fwd"]["median"]
        rec = recs["flash_fwd_lse"]["shapes"][-1]
        rec["library_ms"] = sdpa_fwd_ms
        rec["library_ms_range"] = [turns["sdpa_fwd"]["min"], turns["sdpa_fwd"]["max"]]
        pair.append({"shape": name, "dims": [b, h, sq, sk, d], "port_fwd_lse_dq_dkv_ms": port_ms,
                     "dq_plus_dkv_ms": times["flash_bwd_dq"] + times["flash_bwd_dkv"],
                     "sdpa_bwd_ms": turns["sdpa_bwd"]["median"],
                     "sdpa_bwd_ms_range": [turns["sdpa_bwd"]["min"], turns["sdpa_bwd"]["max"]],
                     "sdpa_fwd_bwd_ms": turns["sdpa_fwd_bwd"]["median"],
                     "sdpa_fwd_bwd_ms_range": [turns["sdpa_fwd_bwd"]["min"],
                                               turns["sdpa_fwd_bwd"]["max"]]})
        print(f"[kernels] flash_fwd_lse {name}: {times['flash_fwd_lse'] / sdpa_fwd_ms:.2f}x "
              f"SDPA's forward (grad) {spread(turns['sdpa_fwd'])}", flush=True)
        print(f"[kernels] training attention {name}: dq + dkv "
              f"{pair[-1]['dq_plus_dkv_ms']:.4f} ms vs SDPA backward alone "
              f"{spread(turns['sdpa_bwd'])}; port lse forward + dq (delta fused) + dkv "
              f"{port_ms:.4f} ms vs SDPA forward + backward "
              f"{spread(turns['sdpa_fwd_bwd'])}", flush=True)
    grad_check(torch, seed)
    return {"kernels": recs, "pair": pair}


def phase_kernels_splash(torch, seed: int) -> dict:
    """The splash kernel (kernel 4) against its plain version: SD3's joint
    attention [4,24,4429,4429,64] in bf16 (per batch row, as compare()),
    ragged shapes at D = 64 and 128 (fp32 and bf16), and rows whose real
    logits all lie below -32 (fp32 and bf16), where the TPU path's pad-key
    rescale fails. At the SD3 shape: the kernel's time, the flash kernel's
    (bias all zero) and SDPA's (the library yardstick) in turns, the plain
    version once, and the bound."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    bf16, f32 = torch.bfloat16, torch.float32
    max_err = 0.0

    def held(name, q, k, v):
        nonlocal max_err
        before = A.splash_attention_fwd.launches
        out = A.splash_attention_fwd(q, k, v)
        A.splash_attention_fwd.launches = before  # comparison launches do not count
        ref = A.plain_splash_attention(q, k, v)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"splash {name}: non-finite output")
        err, rel, bad = compare(torch, out, ref)
        print(f"[kernels] splash_fwd {name} {list(q.shape[:3]) + [k.shape[2], q.shape[3]]} "
              f"{str(q.dtype).split('.')[-1]} max_abs_err {err:.3e} rel_l2 {rel:.3e}",
              flush=True)
        check(bad is None, f"splash {name}: {bad}")
        max_err = max(max_err, err)
        return out

    for name, (b, h, sq, sk, d) in (("odd_d64", (2, 3, 1000, 777, 64)),
                                    ("odd_d128", (2, 3, 1000, 777, 128)),
                                    ("odd_d64_bf16", (2, 3, 1000, 777, 64)),
                                    ("odd_d128_bf16", (2, 3, 1000, 777, 128)),
                                    ("tail13_d128_bf16", (2, 4, 333, 77, 128))):
        dtype = bf16 if name.endswith("bf16") else f32
        q, k, v, _, qs, _ = _attn_inputs(torch, gen, b, h, sq, sk, d, dtype, None)
        held(name, qs, k, v)
    # every real logit below -32: keys clustered round u, queries along -u
    u = torch.randn(64, generator=gen, device="cuda")
    u = u / u.norm()
    k = u + 0.05 * torch.randn(2, 3, 4429, 64, generator=gen, device="cuda")
    q = (-50.0 * u).expand(2, 3, 100, 64).contiguous()
    v = torch.randn(2, 3, 4429, 64, generator=gen, device="cuda")
    top = (q @ k.transpose(2, 3)).max().item()
    check(top < -32, f"negative-logit rows reach {top}")
    for dtype in (f32, bf16):
        held(f"logits_below_-32_{str(dtype).split('.')[-1]}", q.to(dtype), k.to(dtype),
             v.to(dtype))
    print(f"[kernels] splash_fwd rows with every logit <= {top:.1f}: exact against plain "
          f"(the TPU path's out / (1 - n_pad*exp(-lse)) is not carried over)", flush=True)

    # the SD3 shape
    b, h, s, d = SD3_B, SD3_H, SD3_S, SD3_D
    q, k, v, _, qs, _ = _attn_inputs(torch, gen, b, h, s, s, d, bf16, None)
    out = held("sd3", qs, k, v)
    stream = torch.cuda.current_stream().cuda_stream
    splash, _ = A._entry("tdm_splash_fwd")
    fwd, _ = A._entry("tdm_flash_fwd")
    zero_bias = torch.zeros(b, s, dtype=f32, device="cuda")
    flash_out = torch.empty_like(qs)
    turns = time_turns(torch, {
        "splash": lambda: splash(qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 b * h, s, s, d, 1, stream),
        "flash": lambda: fwd(qs.data_ptr(), k.data_ptr(), v.data_ptr(), zero_bias.data_ptr(),
                             flash_out.data_ptr(), None, b, h, s, s, d, 1, stream),
        "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)})
    ms, flash_ms, lib_ms = (turns[n]["median"] for n in ("splash", "flash", "sdpa"))
    flash_err, _, flash_bad = compare(torch, flash_out, A.plain_splash_attention(qs, k, v))
    check(flash_bad is None, f"flash kernel at the SD3 shape: {flash_bad}")
    plain_ms = time_ms(torch, lambda: A.plain_splash_attention(qs, k, v), 1, 0)
    nbytes, ops = attention_work(b, h, s, s, d, 2, s * b, bias=False)
    bound, by = bound_ms(nbytes, ops)
    fb_bytes, fb_ops = attention_work(b, h, s, s, d, 2, s * b)
    flash_bound, _ = bound_ms(fb_bytes, fb_ops)
    print(f"[kernels] splash_fwd sd3 [{b},{h},{s},{s},{d}] in turns: splash "
          f"{spread(turns['splash'])} ({ms / bound:.2f}x bound, {ms / lib_ms:.2f}x SDPA, "
          f"{ops / ms / 1e9:.0f} TFLOP/s) | flash_fwd (bias all 0) {spread(turns['flash'])} "
          f"({flash_ms / lib_ms:.2f}x SDPA, max_abs_err {flash_err:.3e}) | sdpa "
          f"{spread(turns['sdpa'])} | plain_ms {plain_ms:.4f} (once) | bound_ms {bound:.5f} "
          f"({by})", flush=True)
    return {"max_abs_err": max_err, "ms": ms,
            "ms_range": [turns["splash"]["min"], turns["splash"]["max"]],
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_ms_range": [turns["sdpa"]["min"], turns["sdpa"]["max"]],
            "bound_ms": bound, "bound_by": by, "dims": [b, h, s, s, d], "bytes": nbytes,
            "ops": ops, "flash_ms": flash_ms,
            "flash_ms_range": [turns["flash"]["min"], turns["flash"]["max"]],
            "flash_bound_ms": flash_bound}


def grad_check(torch, seed: int) -> None:
    """fp32, small shape: the gradients of q, k and v through
    FlashAttention (the kernels) against autograd of plain_attention, both
    on the card, with a ragged and an all-masked batch row. Tolerance
    GRAD_TOL relative to each gradient's largest magnitude: the same fp32
    arithmetic in another order; the all-masked row's gradients are exactly
    0."""
    from tdm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    b, h, sq, sk, d = 3, 2, 200, 77, 40
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
               for s in (sq, sk, sk))
    mask = (torch.arange(sk, device="cuda")[None]
            < torch.tensor([77, 30, 0], device="cuda")[:, None]).int()
    g = torch.randn(b, h, sq, d, generator=gen, device="cuda")
    before = A.launch_counts()
    grads = {}
    for impl in ("auto", "plain"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = A.attention(*leaves, mask, impl=impl)
        grads[impl] = (out, *torch.autograd.grad(out, leaves, g))
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:
        w.launches = before[w.__name__]
    check(launched == {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
                       "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
                       "splash_attention_fwd": 0},
          f"grad check launches {launched}")
    worst = 0.0
    for label, got, ref in zip(("out", "dq", "dk", "dv"), grads["auto"], grads["plain"]):
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        worst = max(worst, err)
        check(err <= GRAD_TOL, f"grad check {label}: {err:.3e} > {GRAD_TOL}")
        check(not bool(got[2].any()), f"grad check {label}: all-masked row not 0")
    print(f"[kernels] fp32 [{b},{h},{sq},{sk},{d}] FlashAttention (kernels) vs "
          f"autograd of plain_attention: out/dq/dk/dv max error {worst:.3e} of "
          f"the largest magnitude (limit {GRAD_TOL}); all-masked row exactly 0",
          flush=True)


def check_png(png: bytes, width: int, height: int):
    """A valid 8-bit RGB PNG of the given size: signature, chunk CRCs,
    IHDR, and an IDAT stream that inflates to one filter byte plus 3·width
    bytes per row. Returns its [H, W, 3] uint8 pixels (the server writes
    filter 0 on every row, which is checked)."""
    import numpy as np

    check(png[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    pos, chunks = 8, {}
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        crc = int.from_bytes(png[pos + 8 + n:pos + 12 + n], "big")
        check(zlib.crc32(tag + data) & 0xFFFFFFFF == crc, f"PNG {tag} CRC")
        chunks[tag] = chunks.get(tag, b"") + data
        pos += 12 + n
    ihdr = chunks[b"IHDR"]
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    check((w, h, ihdr[8], ihdr[9]) == (width, height, 8, 2),
          f"PNG header {w}x{h} depth {ihdr[8]} color {ihdr[9]}")
    data = zlib.decompress(chunks[b"IDAT"])
    check(len(data) == h * (1 + 3 * w), "PNG data size")
    check(b"IEND" in chunks, "PNG IEND")
    rows = np.frombuffer(data, np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG rows use filter 0")
    return rows[:, 1:].reshape(h, w, 3)


def phase_reference(torch, seed: int) -> None:
    """The whole tiny pipeline (fp32, attention through the kernel) on the
    card against the same pipeline on the CPU (plain attention): the
    sampler state is bf16 in both, so the latents agree to one bf16 ulp of
    their scale and the images to half a PNG step."""
    import numpy as np

    from tdm_tpu_torch.models import pixart, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import PixArtPipeline

    torch.manual_seed(seed)
    cpu = PixArtPipeline(
        pixart.PixArtTransformer2D(pixart.PixArtConfig.tiny(), device="cpu"),
        vae_decoder=vae.TAESDDecoder(vae.TAESDConfig(width=16), device="cpu"),
        device="cpu",
    )
    gpu = PixArtPipeline(
        pixart.PixArtTransformer2D(pixart.PixArtConfig.tiny(), device="cuda"),
        vae_decoder=vae.TAESDDecoder(vae.TAESDConfig(width=16), device="cuda"),
        device="cuda",
    )
    gpu.transformer.load_state_dict(cpu.transformer.state_dict())
    gpu.vae_decoder.load_state_dict(cpu.vae_decoder.state_dict())
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    text = rng.standard_normal((3, 120, 32)).astype(np.float32)
    mask = (np.arange(120)[None] < np.array([[120], [7], [0]])).astype(np.int32)
    kw = dict(prompt_embeds=(text, mask), latents=lat, height=128, width=128)
    ref = cpu(**kw)
    before = A.flash_attention_fwd.launches
    got = gpu(**kw)
    torch.cuda.synchronize()
    launched = A.flash_attention_fwd.launches - before
    A.flash_attention_fwd.launches = before  # a check, not the main path
    dl = (got.latents.float().cpu() - ref.latents.float()).abs()
    scale = ref.latents.float().abs().max().item()
    di = (got.images.cpu() - ref.images).abs().max().item()
    print(f"[reference] tiny pipeline cuda (kernel, {launched} launches) vs "
          f"cpu (plain): latents max_abs_err {dl.max().item():.3e} of scale "
          f"{scale:.3g}, {(dl > 0).float().mean().item():.4f} of elements "
          f"differ; images max_abs_err {di:.3e}", flush=True)
    check(launched == 2 * 2 * 4, f"tiny pipeline launched the kernel {launched}x")
    check(dl.max().item() <= 2**-7 * scale, "tiny pipeline latents disagree")
    check((dl > 0).float().mean().item() < 0.01, "tiny pipeline latents disagree")
    check(di <= 2e-3, "tiny pipeline images disagree")


def pixart_cache(workdir: str, seed: int) -> tuple[str, list]:
    """An embedding cache of 8 prompts with ragged T5 masks (120 tokens at
    4096), written once per run: (its path, its prompts)."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache

    prompts = [f"prompt {i}" for i in range(8)]
    cache = os.path.join(workdir, "cache.npz")
    if not os.path.exists(cache):
        rng = np.random.default_rng(seed)
        lengths = np.array([120, 77, 33, 9, 120, 1, 56, 100])
        EmbeddingCache(
            rng.standard_normal((8, 120, 4096)).astype(np.float16),
            (np.arange(120)[None] < lengths[:, None]).astype(np.int32), prompts,
            uncond_embed=np.zeros((120, 4096), np.float16),
            uncond_mask=np.zeros(120, np.int32),
        ).save(cache)
    return cache, prompts


# the seeded weights of a checkout's KL VAE: at the transformers' 0.02 a
# full-width decode is ~0.02 wide and every PNG pixel the same; at 0.15 it
# spreads over about [-1, 1]
KL_WEIGHT_SCALE = 0.15


def write_seeded(path: str, family: str, cfg, seed: int, scale: float = 0.02) -> int:
    """The file `manifest.write_synthetic` writes (the family's released key
    layout, fp16, N(0, scale) weights), one tensor at a time, with the
    weights drawn on the card from the seed: numpy's generator takes most
    of a minute for 2 B of them. Returns the number of parameters."""
    import numpy as np
    import torch

    from tdm_tpu_torch.io import manifest, params as params_io

    shapes = manifest.expected_manifest(family, cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params_io.write_file(
        path, [(k, shape, np.float16) for k, shape in shapes.items()],
        ((scale * torch.randn(shape, generator=gen, device="cuda")).half().cpu().numpy()
         for shape in shapes.values()))
    return sum(math.prod(shape) for shape in shapes.values())


# ---------------------------------------------------------------------------
# The text encoders at full width: seeded files, checks, times
# ---------------------------------------------------------------------------

# bf16 against fp32 on the same weights, per row: bf16 rounds every product
# and the residual stream to 8 bits, and over 24-32 blocks a row drifts by
# about 2% (a 24-layer, 512-wide T5 and a 32-layer CLIP-G-like tower on the
# CPU at these init scales: relative L2 0.019-0.024 and 0.013); a wrong
# mask, bias or norm dtype shows as O(1)
ENC_BF16_REL_L2 = 5e-2
# the hash tokenizers the smoke passes: CLIP's pool at its EOS 49407, as a
# real tokenizer's rows do; T5's vocabulary of 32,128 holds HashTokenizer's
# default 30,000
CLIP_VOCAB, CLIP_EOS = 49408, 49407
# a dense caption of the kind PixArt-α trains on (161 words)
CAPTION = (
    "The image shows a quiet harbor town at dawn, seen from a hill above the water. Small "
    "fishing boats with red and blue hulls are moored along a wooden pier, and their "
    "reflections ripple in the calm sea. Behind the pier, rows of whitewashed houses with "
    "terracotta roofs climb the slope, their windows catching the first warm light. A narrow "
    "cobblestone street winds between the houses toward a stone church with a tall bell "
    "tower. On the left, a lighthouse painted in white and red stripes stands on a rocky "
    "point, and a few seagulls circle above it. The sky is pale pink near the horizon and "
    "fades to soft blue overhead, with thin clouds drifting to the east. In the foreground, "
    "wild grass and yellow flowers sway in a light breeze, and a bicycle leans against a "
    "weathered fence. The overall mood is peaceful and nostalgic, rendered in a detailed, "
    "painterly style with gentle contrast and a warm color palette.")


def caption(words: int, start: int = 0) -> str:
    """`words` words of CAPTION from word `start` on, wrapping around."""
    w = CAPTION.split()
    return " ".join(w[(start + i) % len(w)] for i in range(words))


# the prompts the encoders see: short ones and caption-length ones, so that
# the cache the train phases read has ragged masks of 2 to 120 live tokens
# (hash tokens: a word each and the EOS): 160 words is cut at T5's 120 and
# CLIP's 77, 119 fill 120 exactly, 76 fill CLIP's 77
ENC_PROMPTS = ["a red fox in the snow", caption(160),
               "an astronaut riding a horse on mars, oil painting", caption(76, 40), "x",
               caption(119, 80), caption(55, 20), caption(99, 60)]
ENC_T5_LIVE = [7, 120, 10, 77, 2, 120, 56, 100]  # at 120 tokens


def t5_xxl_config(torch):
    from tdm_tpu_torch.models import t5

    cfg = t5.T5Config()
    check((cfg.vocab_size, cfg.d_model, cfg.d_kv, cfg.num_heads, cfg.d_ff, cfg.num_layers,
           cfg.dtype) == (32128, 4096, 64, 64, 10240, 24, torch.bfloat16), "T5-v1.1-XXL")
    return cfg


def clip_configs(torch) -> dict:
    """CLIP-L as SD1.5 ships it (no projection), CLIP-L with its 768²
    projection and OpenCLIP-G (exact GELU, projection 1280) as SD3 does."""
    import dataclasses

    from tdm_tpu_torch.models import clip

    base = clip.CLIPTextConfig()
    check((base.vocab_size, base.hidden, base.num_heads, base.num_layers, base.max_positions,
           base.eos_token_id, base.activation) == (CLIP_VOCAB, 768, 12, 12, 77, CLIP_EOS,
                                                   "quick_gelu"), "CLIP-L")
    return {"clip_l": base, "clip_l_proj": dataclasses.replace(base, projection_dim=768),
            "clip_g": dataclasses.replace(base, hidden=1280, num_heads=20, num_layers=32,
                                          activation="gelu", projection_dim=1280)}


def hf_encoder_layout(cfg) -> dict:
    """{key: (shape, init std, or 'ones' / 'zeros')} of the HF layout the
    converters read (T5EncoderModel; CLIPTextModel[WithProjection]), with
    the transformers init of each tensor: T5 folds 1/sqrt(d_kv) into q."""
    from tdm_tpu_torch.models import t5

    out = {}
    if isinstance(cfg, t5.T5Config):
        d, inner, ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
        out["shared.weight"] = ((cfg.vocab_size, d), 1.0)
        for i in range(cfg.num_layers):
            b = f"encoder.block.{i}.layer"
            out[f"{b}.0.layer_norm.weight"] = ((d,), "ones")
            out[f"{b}.0.SelfAttention.q.weight"] = ((inner, d), (d * cfg.d_kv) ** -0.5)
            for p in ("k", "v"):
                out[f"{b}.0.SelfAttention.{p}.weight"] = ((inner, d), d ** -0.5)
            out[f"{b}.0.SelfAttention.o.weight"] = ((d, inner), inner ** -0.5)
            if i == 0:
                out[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = (
                    (cfg.rel_buckets, cfg.num_heads), d ** -0.5)
            out[f"{b}.1.layer_norm.weight"] = ((d,), "ones")
            out[f"{b}.1.DenseReluDense.wi_0.weight"] = ((ff, d), d ** -0.5)
            out[f"{b}.1.DenseReluDense.wi_1.weight"] = ((ff, d), d ** -0.5)
            out[f"{b}.1.DenseReluDense.wo.weight"] = ((d, ff), ff ** -0.5)
        out["encoder.final_layer_norm.weight"] = ((d,), "ones")
        return out
    d, ff, t = cfg.hidden, cfg.hidden * cfg.mlp_ratio, "text_model"
    in_std = d ** -0.5 * (2 * cfg.num_layers) ** -0.5
    out[f"{t}.embeddings.token_embedding.weight"] = ((cfg.vocab_size, d), 0.02)
    out[f"{t}.embeddings.position_embedding.weight"] = ((cfg.max_positions, d), 0.02)
    for i in range(cfg.num_layers):
        b = f"{t}.encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            out[f"{b}.{n}.weight"], out[f"{b}.{n}.bias"] = ((d,), "ones"), ((d,), "zeros")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{b}.self_attn.{p}.weight"] = ((d, d), d ** -0.5 if p == "out_proj" else in_std)
            out[f"{b}.self_attn.{p}.bias"] = ((d,), "zeros")
        out[f"{b}.mlp.fc1.weight"], out[f"{b}.mlp.fc1.bias"] = ((ff, d), (2 * d) ** -0.5), \
            ((ff,), "zeros")
        out[f"{b}.mlp.fc2.weight"], out[f"{b}.mlp.fc2.bias"] = ((d, ff), in_std), \
            ((d,), "zeros")
    out[f"{t}.final_layer_norm.weight"] = ((d,), "ones")
    out[f"{t}.final_layer_norm.bias"] = ((d,), "zeros")
    if cfg.projection_dim is not None:
        out["text_projection.weight"] = ((cfg.projection_dim, d), d ** -0.5)
    return out


def hf_encoder_config(cfg) -> dict:
    """The config.json of an HF encoder folder."""
    from tdm_tpu_torch.models import t5

    if isinstance(cfg, t5.T5Config):
        return {"architectures": ["T5EncoderModel"], "vocab_size": cfg.vocab_size,
                "d_model": cfg.d_model, "d_kv": cfg.d_kv, "num_heads": cfg.num_heads,
                "d_ff": cfg.d_ff, "num_layers": cfg.num_layers,
                "relative_attention_num_buckets": cfg.rel_buckets,
                "relative_attention_max_distance": cfg.rel_max_distance,
                "feed_forward_proj": "gated-gelu"}
    out = {"architectures": ["CLIPTextModel"], "vocab_size": cfg.vocab_size,
           "hidden_size": cfg.hidden, "intermediate_size": cfg.hidden * cfg.mlp_ratio,
           "num_attention_heads": cfg.num_heads, "num_hidden_layers": cfg.num_layers,
           "max_position_embeddings": cfg.max_positions, "eos_token_id": cfg.eos_token_id,
           "hidden_act": cfg.activation}
    if cfg.projection_dim is not None:
        out.update(architectures=["CLIPTextModelWithProjection"],
                   projection_dim=cfg.projection_dim)
    return out


def _seeded_leaves(torch, layout: dict, seed: int, transpose: set):
    """The layout's tensors drawn on the card from the seed, in its order, as
    fp16 numpy arrays; the keys in `transpose` as [in, out]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for key, (shape, init) in layout.items():
        if init == "ones":
            x = torch.ones(shape, device="cuda")
        elif init == "zeros":
            x = torch.zeros(shape, device="cuda")
        else:
            x = init * torch.randn(shape, generator=gen, device="cuda")
        if key in transpose:
            x = x.t()
        yield x.half().contiguous().cpu().numpy()


def write_seeded_encoder(torch, cfg, seed: int, *, folder: str | None = None,
                         bundle: str | None = None) -> int:
    """Weights drawn on the card from the seed at the transformers init, as
    an HF encoder `folder` (config.json, model.safetensors at fp16) and/or
    a tdm_tpu-layout text_encoder file `bundle` (the strict converter's
    tree, flat '/' keys, Dense kernels [in, out], drawn again from the seed
    rather than transposed on the host): the same values either way.
    Returns the parameter count."""
    import numpy as np

    from tdm_tpu_torch.io import convert, params as params_io
    from tdm_tpu_torch.models import t5

    layout = hf_encoder_layout(cfg)
    if folder is not None:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump(hf_encoder_config(cfg), f)
        params_io.write_file(os.path.join(folder, "model.safetensors"),
                             [(k, shape, np.float16) for k, (shape, _) in layout.items()],
                             _seeded_leaves(torch, layout, seed, set()))
    if bundle is not None:
        # the converter over unread placeholders: its tree names each leaf
        # and says which are transposed views
        empty = {k: np.empty(shape, np.float16) for k, (shape, _) in layout.items()}
        conv = convert.t5_encoder_params if isinstance(cfg, t5.T5Config) else \
            convert.clip_text_params
        by_id = {id(a): k for k, a in empty.items()}
        flax = {}
        for name, leaf in convert.flatten(conv(empty)).items():
            src = leaf if id(leaf) in by_id else leaf.base
            flax[by_id[id(src)]] = (name, leaf.shape, src is not leaf)
        params_io.write_file(
            bundle, [(flax[k][0], flax[k][1], np.float16) for k in layout],
            _seeded_leaves(torch, layout, seed, {k for k in layout if flax[k][2]}))
    return sum(math.prod(shape) for shape, _ in layout.values())


ENCODER_SEEDS = {"t5": 7, "t5_bundle": 7, "clip_l": 30, "clip_l_proj": 30, "clip_g": 31}


def seeded_encoders(torch, workdir: str, seed: int, names=()) -> dict:
    """The run's seeded text encoders under workdir/encoders, each of
    `names` written when it is not there (hardlinked wherever a checkout or
    bundle needs it; `release_encoder` deletes one when its phases are
    done, since the card's machine counts every block its disk ever held):
    T5-v1.1-XXL as an HF folder ('t5') and as a tdm_tpu-layout file
    ('t5_bundle', the same weights), CLIP-L without and with its
    projection, OpenCLIP-G. Returns {name: (folder or file, config)} of all."""
    root = os.path.join(workdir, "encoders")
    cfgs = {"t5": t5_xxl_config(torch), **clip_configs(torch)}
    out = {name: (os.path.join(root, name), cfg) for name, cfg in cfgs.items()}
    out["t5_bundle"] = (os.path.join(root, "t5_text_encoder.safetensors"), cfgs["t5"])
    for name in names:
        path, cfg = out[name]
        if os.path.exists(path):
            continue
        t0 = time.monotonic()
        os.makedirs(root, exist_ok=True)
        tmp = path + ".partial"
        n = write_seeded_encoder(torch, cfg, seed + ENCODER_SEEDS[name],
                                 **({"bundle": tmp} if name == "t5_bundle" else {"folder": tmp}))
        os.rename(tmp, path)
        gb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
                 for f in fs) / 1e9 if os.path.isdir(path) else os.path.getsize(path) / 1e9
        print(f"[encoders] wrote {name} ({n / 1e6:.1f}M params, {gb:.2f} GB at fp16) in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
    return out


def release_encoder(torch, workdir: str, seed: int, name: str, *links: str) -> None:
    """Delete a seeded encoder and the `links` to it (checkout folders or a
    bundle), so that its blocks serve the later phases' writes."""
    path = seeded_encoders(torch, workdir, seed)[name][0]
    for p in (path, *links):
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.remove(p)


def cache_served_view(root: str) -> str:
    """The checkout at `root` without its text_encoder*/ folders, beside it:
    a directory of symlinks to the rest. A server built on it attaches no
    encoder and serves its embedding cache; on the checkout itself, whose
    encoders have no tokenizer here (no transformers), every request would
    go to encode_prompt and raise, as in the JAX package."""
    view = root.rstrip("/") + "_cache_served"
    os.makedirs(view, exist_ok=True)
    for name in os.listdir(root):
        dst = os.path.join(view, name)
        if not name.startswith("text_encoder") and not os.path.lexists(dst):
            os.symlink(os.path.join(root, name), dst)
    return view


def link_encoder(folder: str, dst: str) -> None:
    """An HF encoder folder into a checkout as `dst`, its files hardlinked."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(folder):
        if not os.path.exists(os.path.join(dst, name)):
            os.link(os.path.join(folder, name), os.path.join(dst, name))


def encoder_work(cfg, tokens: int) -> tuple:
    """(bytes, bf16 operations, fp32 operations) of one batch-1 encode at
    `tokens` tokens: every bf16 weight matrix read once (the embedding's
    rows only), the ids read and the states written once; 2 operations per
    multiply-add of the bf16 products, and the fp32 attention products."""
    from tdm_tpu_torch.models import t5

    if isinstance(cfg, t5.T5Config):
        d, inner, layers = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.num_layers
        mat = layers * (4 * d * inner + 3 * d * cfg.d_ff)
        attn = layers * 2 * 2 * tokens * tokens * inner
        embed_bytes = tokens * d * 2
    else:
        d, layers = cfg.hidden, cfg.num_layers
        mat = layers * (4 * d * d + 2 * d * d * cfg.mlp_ratio) + d * (cfg.projection_dim or 0)
        attn = layers * 2 * 2 * tokens * tokens * d
        embed_bytes = tokens * d * 4 * 2  # fp32 token and position rows
    nbytes = mat * 2 + embed_bytes + tokens * 8 + tokens * d * 2
    return nbytes, 2 * mat * tokens, attn


def encoder_bound_ms(cfg, tokens: int) -> tuple[float, str]:
    nbytes, bf16_ops, f32_ops = encoder_work(cfg, tokens)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (bf16_ops / PEAK_OPS_S["bfloat16"] + f32_ops / PEAK_OPS_S["float32"]) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_encode(torch, fn, iters: int = 10) -> dict:
    """Median (min, max) ms of `fn()` by CUDA events over `iters` calls
    after one warm call, and the host's seconds around the median call."""
    with torch.inference_mode():
        fn()
        ms = []
        for _ in range(iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
    return {"ms": statistics.median(ms), "ms_range": [min(ms), max(ms)]}


def encoder_report(torch, name: str, enc, ids, mask=None, outputs=None,
                   against_fp32: bool = True) -> dict:
    """One full-width encoder: `enc` (bf16) against the same weights in fp32
    on the card, per row of the batch `ids` (relative L2 under
    ENC_BF16_REL_L2, finite; skipped without `against_fp32`, for an
    encoder already held so at another length), and the batch-1 encode
    time against its bound. `outputs(result)` picks the compared tensors
    (CLIP: the states a pipeline reads and the pooled vector)."""
    import dataclasses

    outputs = outputs or (lambda r: {"states": r})
    ids = torch.as_tensor(ids, device="cuda")
    mask = None if mask is None else torch.as_tensor(mask, device="cuda")
    args = (ids,) if mask is None else (ids, mask)
    with torch.inference_mode():
        got = {k: v.float() for k, v in outputs(enc(*args)).items()}
        ref = {}
        if against_fp32:
            enc32 = type(enc)(dataclasses.replace(enc.cfg, dtype=torch.float32), device="cuda")
            enc32.load_state_dict(enc.state_dict())  # widened exactly
            ref = outputs(enc32(*args))
            del enc32
    torch.cuda.empty_cache()
    rel = {}
    for k, g in got.items():
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {k}")
    for k, r in ref.items():
        rows = [((a - b).norm() / b.norm()).item() for a, b in zip(got[k], r)]
        rel[k] = max(rows)
        check(rel[k] <= ENC_BF16_REL_L2,
              f"{name} bf16 against fp32, {k}: relative L2 {rows} > {ENC_BF16_REL_L2}")
    one = tuple(a[:1] for a in args)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time_encode(torch, lambda: enc(*one))
    t["encode_peak_extra_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    tokens = ids.shape[1]
    bound, by = encoder_bound_ms(enc.cfg, tokens)
    held = ("bf16 against fp32 per row, max relative L2 "
            + ", ".join(f"{k} {v:.4f}" for k, v in rel.items())
            + f" (bound {ENC_BF16_REL_L2})") if rel else "finite"
    print(f"[encoders] {name}: {held}; batch-1 encode at {tokens} tokens {t['ms']:.3f} ms "
          f"({t['ms_range'][0]:.3f}-{t['ms_range'][1]:.3f}), bound {bound:.3f} ms ({by}), "
          f"{t['ms'] / bound:.2f}x; {encoder_params(enc) / 1e6:.1f}M params, "
          f"{t['encode_peak_extra_gib']:.3f} GiB above them while encoding", flush=True)
    return {"rel_l2": rel, "tokens": tokens, **t, "bound_ms": bound, "bound_by": by,
            "params": encoder_params(enc)}


def clip_outputs(proj: bool):
    """What a pipeline reads of a CLIP output: SD3 the penultimate state and
    the projected pooled vector, SD1.5 the last state."""
    if proj:
        return lambda r: {"penultimate": r.hidden_states[-2], "pooled": r.pooled}
    return lambda r: {"last": r.last_hidden_state, "pooled": r.pooled}


def encoder_params(module) -> int:
    return sum(p.numel() for p in module.parameters())


def write_checkout(root: str, family: str, cfg, vcfg, seed: int) -> tuple[float, int]:
    """A stock diffusers checkout at `root`: model_index.json, transformer/
    (SD1.5: unet/) and vae/ (an AutoencoderKL), each a config.json and one
    fp16 diffusion_pytorch_model.safetensors of seeded weights in the
    released checkpoint's key layout (the port's manifests, family pixart,
    sd3 or unet_sd15), written one tensor at a time; the denoiser's drawn
    on the card (write_seeded). Returns (seconds, parameters)."""
    from tdm_tpu_torch.io import manifest

    t0 = time.monotonic()
    sub = "transformer"
    if family == "unet_sd15":  # SD1.5's int attention_head_dim is its head count
        sub, index = "unet", {"_class_name": "StableDiffusionPipeline"}
        tconf = {"_class_name": "UNet2DConditionModel", "in_channels": cfg.in_channels,
                 "out_channels": cfg.out_channels, "layers_per_block": cfg.layers_per_block,
                 "block_out_channels": list(cfg.block_widths),
                 "norm_num_groups": cfg.norm_groups, "cross_attention_dim": cfg.context_dim,
                 "attention_head_dim": cfg.num_heads}
    else:
        tconf = {"sample_size": cfg.sample_size, "patch_size": cfg.patch_size,
                 "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
                 "num_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                 "attention_head_dim": cfg.head_dim}
    if family == "pixart":
        index = {"_class_name": "PixArtAlphaPipeline"}
        tconf.update(_class_name="PixArtTransformer2DModel", caption_channels=cfg.caption_dim)
    elif family == "sd3":
        index = {"_class_name": "StableDiffusion3Pipeline"}
        tconf.update(_class_name="SD3Transformer2DModel", joint_attention_dim=cfg.context_dim,
                     pooled_projection_dim=cfg.pooled_dim,
                     pos_embed_max_size=cfg.pos_embed_max_size)
    vconf = {"_class_name": "AutoencoderKL", "latent_channels": vcfg.latent_channels,
             "block_out_channels": list(vcfg.block_widths),
             "layers_per_block": vcfg.layers_per_block, "norm_num_groups": vcfg.norm_groups,
             "scaling_factor": vcfg.scaling_factor,
             "shift_factor": vcfg.shift_factor if vcfg.shift_factor else None}
    n = 0
    for folder, conf in (("", index), (sub, tconf), ("vae", vconf)):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        with open(os.path.join(root, folder, "config.json" if folder else "model_index.json"),
                  "w") as f:
            json.dump(conf, f)
    n += write_seeded(os.path.join(root, sub, "diffusion_pytorch_model.safetensors"), family,
                      cfg, seed)
    n += manifest.write_synthetic(
        "klvae", os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"),
        vcfg, seed=seed + 1, scale=KL_WEIGHT_SCALE)
    return time.monotonic() - t0, n


def pixart_checkout(workdir: str, seed: int) -> str:
    """The PixArt-α-512 checkout (28 layers, hidden 1152, 16x72 heads,
    caption 4096; its 4-channel AutoencoderKL [128, 256, 512, 512], scaling
    0.18215), written once per run."""
    from tdm_tpu_torch.models import pixart, vae

    root = os.path.join(workdir, "PixArt-XL-2-512x512")
    if not os.path.exists(os.path.join(root, "model_index.json")):
        cfg, vcfg = pixart.PixArtConfig(), vae.KLVAEConfig()
        check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.caption_dim,
               tuple(vcfg.block_widths), vcfg.latent_channels, vcfg.scaling_factor)
              == (28, 1152, 16, 72, 4096, (128, 256, 512, 512), 4, 0.18215),
              "PixArt-α-512 and its VAE")
        secs, n = write_checkout(root, "pixart", cfg, vcfg, seed)
        gb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                 for f in fs) / 1e9
        print(f"[checkout] wrote the PixArt-α-512 diffusers checkout ({n / 1e6:.1f}M "
              f"params, {gb:.2f} GB at fp16) in {secs:.1f}s", flush=True)
    return root


@contextlib.contextmanager
def timed_calls(torch, targets):
    """Each (object, attribute) of `targets` wrapped to add the seconds of
    its calls, the card synchronised after each, to times[attribute]."""
    times, saved = {}, []

    def wrap(fn, name):
        def wrapped(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                times[name] = times.get(name, 0.0) + time.monotonic() - t0
        return wrapped

    for obj, name in targets:
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, wrap(getattr(obj, name), name))
    try:
        yield times
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def load_targets():
    """What a checkout's load is made of: the whole of `_from_diffusers`,
    the safetensors reads and the strict converters."""
    from tdm_tpu_torch.io import convert
    from tdm_tpu_torch.pipelines import loading

    return [(loading, "_from_diffusers"), (convert, "load_torch_state_dict"),
            (convert, "pixart_params"), (convert, "sd3_params"), (convert, "klvae_params")]


def teacher_load_parts(converter: str):
    """What a trainer's teacher load is made of: the directory's read, the
    family's strict converter, the carry's checks and `load_from_jax` (the
    carry and the copy into the module on the card)."""
    from tdm_tpu_torch.io import convert, from_jax

    return [(convert, "load_torch_state_dict"), (convert, converter),
            (from_jax, "_carried"), (from_jax, "load_from_jax")]


def teacher_load_report(times: dict, converter: str) -> tuple[float, str]:
    """The load's seconds (`_carried` runs inside `load_from_jax`) and a
    line of its parts."""
    total = times["load_torch_state_dict"] + times[converter] + times["load_from_jax"]
    return total, (f"safetensors read {times['load_torch_state_dict']:.2f}s, conversion "
                   f"{times[converter]:.3f}s, carry {times['_carried']:.2f}s, copy into "
                   f"the module {times['load_from_jax'] - times['_carried']:.2f}s")


def load_report(times: dict) -> dict:
    total = times["_from_diffusers"]
    read = times["load_torch_state_dict"]
    conv = sum(v for k, v in times.items() if k.endswith("_params"))
    return {"load_s": total, "read_s": read, "convert_s": conv,
            "convert_share": conv / total, "build_and_copy_s": total - read - conv}


def pixart_bundle(torch, seed: int, workdir: str) -> str:
    """The served PixArt-α-512 pipeline (28 layers, hidden 1152, 16x72
    heads, caption 4096, TAESD width 64, bf16) with weights from the seed,
    written once per run in the tdm_tpu layout by the port's
    save_pretrained, and its T5-v1.1-XXL bundled beside it: the seeded
    encoder's tdm_tpu-layout file hardlinked as text_encoder.safetensors and
    pipeline.json's "text_encoder" block with a hash tokenizer."""
    from tdm_tpu_torch.models import pixart, vae
    from tdm_tpu_torch.pipelines import PixArtPipeline, loading, save_pretrained

    model_dir = os.path.join(workdir, "pixart_alpha_512")
    if os.path.exists(os.path.join(model_dir, "text_encoder.safetensors")):
        return model_dir
    t0 = time.monotonic()
    torch.manual_seed(seed)
    cfg = pixart.PixArtConfig()
    check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.caption_dim)
          == (28, 1152, 16, 72, 4096), "PixArt-α-512 widths")
    pipe = PixArtPipeline(
        pixart.PixArtTransformer2D(cfg, device="cuda"),
        vae_decoder=vae.TAESDDecoder(vae.TAESDConfig(dtype=torch.bfloat16), device="cuda"),
        device="cuda",
    )
    n_params = sum(p.numel() for p in pipe.transformer.parameters())
    save_pretrained(model_dir, pipe)
    del pipe
    torch.cuda.empty_cache()
    t5_file, t5_cfg = seeded_encoders(torch, workdir, seed, ["t5_bundle"])["t5_bundle"]
    os.link(t5_file, os.path.join(model_dir, "text_encoder.safetensors"))
    meta_file = os.path.join(model_dir, "pipeline.json")
    with open(meta_file) as f:
        meta = json.load(f)
    meta["text_encoder"] = {"family": "t5", "config": loading.config_dict(t5_cfg),
                            "tokenizer": {"kind": "hash"}}
    with open(meta_file, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[serve] wrote PixArt-α-512 ({n_params / 1e6:.1f}M params) with its T5-XXL "
          f"bundled in {time.monotonic() - t0:.1f}s", flush=True)
    return model_dir


def built_cache(seed: int, workdir: str) -> str:
    """`python -m tdm_tpu_torch.cli.build_cache --pipeline <the PixArt
    bundle>` over a .txt of the 8 prompts (its main() in this process), run
    once per run: the T5-XXL cache [8, 120, 4096] with the uncond and the
    CLI's 4 validation rows that the train phases read."""
    import torch

    from tdm_tpu_torch.cli import build_cache

    cache = os.path.join(workdir, "built_cache.npz")
    if os.path.exists(cache):
        return cache
    bundle = pixart_bundle(torch, seed, workdir)
    txt = os.path.join(workdir, "cache_prompts.txt")
    with open(txt, "w") as f:
        f.write("\n".join(ENC_PROMPTS) + "\n")
    t0 = time.monotonic()
    build_cache.main(["--pipeline", bundle, "--prompts", txt, "--out", cache,
                      "--batch_size", "8"])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[build_cache] {time.monotonic() - t0:.1f}s with the bundle's load", flush=True)
    return cache


def phase_serve(torch, seed: int, workdir: str) -> dict:
    """Full-width PixArt-α-512 served over HTTP through the port from raw
    prompts: the bundle's T5-XXL and hash tokenizer, no embedding cache."""
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    from tdm_tpu_torch.models import t5
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import loading
    from tdm_tpu_torch.serve import batcher as B, server as S

    model_dir = pixart_bundle(torch, seed, workdir)
    prompts = ENC_PROMPTS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    args = S.parse_args([
        "--model", model_dir, "--port", "0", "--batch_size", "4", "--max_delay_ms", "1000",
        "--warmup",
    ])
    with timed_calls(torch, [(loading, "_load_bundled_text_encoder")]) as times:
        server = S.build_server(args).start()
    stats, pipe = server.batcher.stats, server.batcher.pipe
    check(isinstance(pipe.text_encoder, t5.T5Encoder) and B.has_encoders(pipe)
          and args.embedding_cache is None, "the served bundle encodes raw prompts")
    t5_load_s = times["_load_bundled_text_encoder"]
    print(f"[serve] loaded and warmed on '' in {time.monotonic() - t0:.1f}s (T5-XXL "
          f"{encoder_params(pipe.text_encoder) / 1e9:.3f} B params loaded in {t5_load_s:.2f}s; "
          f"warm-up batch {stats.last_batch_latency_s:.3f}s); no embedding cache", flush=True)

    def post(prompt, seed):
        body = json.dumps({"prompt": prompt, "seed": seed}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        t = time.monotonic()
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, time.monotonic() - t

    try:
        # the main path: counts to 0, 6 concurrent requests (one full batch
        # and one padded), then one request alone for determinism
        A.flash_attention_fwd.launches = 0
        b0, pad0 = stats.batches, stats.rows_padded
        t0 = time.monotonic()
        with ThreadPoolExecutor(6) as ex:
            replies = list(ex.map(lambda i: post(prompts[i], 100 + i), range(6)))
        wall6 = time.monotonic() - t0
        batches6 = stats.batches - b0
        solo, solo_s = post(prompts[0], 100)
        launches = A.flash_attention_fwd.launches
        batches = stats.batches - b0
        solo_batch_s = stats.last_batch_latency_s
    finally:
        server.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for reply, _ in replies + [(solo, solo_s)]:
        check(reply.get("format") == "png" and reply.get("shape") == [512, 512, 3],
              f"reply {str(reply)[:200]}")
        check_png(base64.b64decode(reply["image"]), 512, 512)
    check(batches6 == 2 and stats.rows_padded - pad0 == 2 + 3,
          f"6 requests ran as {batches6} batches")
    check(solo["image"] == replies[0][0]["image"],
          "same (prompt, seed) gave different bytes in another batch")
    check(len({r["image"] for r, _ in replies}) == 6, "distinct seeds gave equal images")
    per_batch = PIXART_LAUNCHES_PER_BATCH
    check(launches == per_batch * batches,
          f"flash_fwd launched {launches}x over {batches} batches, "
          f"expected {per_batch} per batch")
    lat = [s for _, s in replies]
    print(f"[serve] 6 concurrent raw-prompt requests in {wall6:.3f}s as {batches6} "
          f"batches ({6 / wall6:.2f} images/s), request latency "
          f"{min(lat):.3f}-{max(lat):.3f}s; lone request {solo_s:.3f}s, its "
          f"batch {solo_batch_s:.3f}s; same (prompt, seed) -> same PNG bytes; "
          f"flash_fwd launches {launches} = {per_batch} x {batches} batches; peak device "
          f"memory {peak_gb:.2f} GiB with the T5 resident", flush=True)
    # the request's encode on its handler thread: host seconds around it
    enc_s = []
    for p in prompts:
        t0 = time.monotonic()
        server.batcher.cond_fn(p)
        torch.cuda.synchronize()
        enc_s.append(time.monotonic() - t0)
    ids, mask = pipe.tokenizer(prompts[:4], max_length=pipe.max_text_len)
    t5_rep = encoder_report(torch, "T5-XXL (PixArt, 120 tokens)", pipe.text_encoder, ids, mask)
    t5_rep.update(load_s=t5_load_s, params=encoder_params(pipe.text_encoder),
                  request_encode_s=statistics.median(enc_s))
    cache_rows = cache_against_batch1(torch, pipe, built_cache(seed, workdir))
    cond = tuple(torch.cat([x] * 4) for x in server.batcher.cond_fn(prompts[1]))
    noise = torch.randn(4, 4, 64, 64)
    prof = profile_batch(torch, pipe, cond, noise)
    if prof:
        share = 4 * t5_rep["ms"] / (prof["busy_ms"] + 4 * t5_rep["ms"])
        prof["encode_share"] = share
        print(f"[serve] the batch's 4 encodes (4 x {t5_rep['ms']:.3f} ms, one per request; "
              f"host {t5_rep['request_encode_s'] * 1e3:.2f} ms each) are {share:.3f} of its "
              f"device time", flush=True)
    full_forward_check(torch, pipe.transformer, seed)
    int8 = int8_serving(
        torch, "serve", pipe, cond, noise,
        tuple(torch.cat([x] * 4) for x in server.batcher.cond_fn(prompts[2])),
        torch.randn(4, 4, 64, 64), gated_per_forward=pixart_gated(torch, 4), forwards=4,
        wrapper="flash_attention_fwd")
    int8["server"] = quant_server_request(torch, model_dir, built_cache(seed, workdir),
                                          prompts[0], 100)
    dp = dp_serving_check(torch, pipe, cond, noise)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    gen = generate_runs(torch, model_dir, prompts, workdir)
    # the train phases read the cache, nothing reads the bundle again
    release_encoder(torch, workdir, seed, "t5_bundle", model_dir)
    return {"launches": launches, "batches": batches, "wall6_s": wall6,
            "images_per_s": 6 / wall6, "batch_s": solo_batch_s, "profile": prof,
            "peak_gib": peak_gb, "t5": t5_rep, "cache_rows": cache_rows, "int8": int8,
            "generate": gen, "data_parallel": dp}


def cache_against_batch1(torch, pipe, cache_path: str) -> dict:
    """Each prompt's batch-1 encode against its row of the cache that
    build_cache wrote from the same bundle in chunks of 8: the largest
    difference, before and after rounding the batch-1 row to the cache's
    fp16 (cuBLAS may take another algorithm for another M; reported, not
    checked)."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache

    cache = EmbeddingCache.load(cache_path)
    check(cache.embeds.shape == (len(ENC_PROMPTS), 120, 4096) and cache.prompts == ENC_PROMPTS
          and cache.masks.sum(1).tolist() == ENC_T5_LIVE
          and cache.uncond_embed is not None and len(cache.val_prompts) == 4,
          f"build_cache wrote {cache.embeds.shape} with {cache.masks.sum(1).tolist()} live "
          f"tokens for {[len(p.split()) for p in cache.prompts]} words")
    raw = fp16 = rel = 0.0
    for i, p in enumerate(cache.prompts):
        e, m = pipe.encode_prompt([p])
        row = e[0].float().cpu().numpy()
        check(np.array_equal(m[0].cpu().numpy(), cache.masks[i]), f"mask of {p!r}")
        ref = cache.embeds[i].astype(np.float32)
        raw = max(raw, float(np.abs(row - ref).max()))
        fp16 = max(fp16, float(np.abs(row.astype(np.float16).astype(np.float32) - ref).max()))
        rel = max(rel, float(np.linalg.norm(row - ref) / np.linalg.norm(ref)))
    print(f"[build_cache] a prompt's batch-1 encode against its row of the cache (chunks of "
          f"8): max |diff| {raw:.3e} ({fp16:.3e} after rounding it to fp16), relative L2 "
          f"{rel:.4f} at most", flush=True)
    return {"max_abs_diff": raw, "max_abs_diff_fp16": fp16, "max_rel_l2": rel,
            "rows": len(cache.prompts)}


def profile_batch(torch, pipe, cond, noise, kernel: str = "flash_fwd") -> dict:
    """Device time of one full batch (4 NFE + decode) by kernel, from
    torch.profiler's CUDA activity: busy time, the attention kernel's share
    (kernels whose name holds `kernel`), the device's idle share of the
    batch's wall time, and the VAE decode's span by CUDA events around it
    (its kernels run back to back: `decode_alone` finds its device time
    equal to that span, where the profiler's attribution of kernels to a
    record_function range around the decode counted MMDiT kernels too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dec = pipe.vae_decoder
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_decode(z, forward=dec.forward):
        events[0].record()
        out = forward(z)
        events[1].record()
        return out

    torch.cuda.synchronize()
    dec.forward = timed_decode
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            pipe(prompt_embeds=cond, latents=noise).images.cpu()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        del dec.forward
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("[profile] no device time in the trace: not measured", flush=True)
        return {}
    attn_ms = sum(e.device_time_total for e in kernels if kernel in e.key) / 1e3
    by_name = {e.key: e.count for e in kernels if kernel in e.key}
    decode_ms = events[0].elapsed_time(events[1])
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    print(f"[profile] one batch of 4: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{kernel} {attn_ms:.1f} ms ({attn_ms / busy_ms:.3f} of busy), "
          f"{type(dec).__name__} decode {decode_ms:.1f} ms by CUDA events "
          f"({decode_ms / busy_ms:.3f} of busy), "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    for e in top:
        print(f"[profile]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "attention_ms": attn_ms,
            "idle_share": 1 - busy_ms / wall_ms, "launches": sum(e.count for e in kernels),
            "decode_ms": decode_ms, "kernel_launches": by_name}


@contextlib.contextmanager
def forced_attention(impl: str):
    """Every attention call of the models takes the route `impl`, whatever
    route its module asks for (here only: a comparison, not the main
    path)."""
    from tdm_tpu_torch.models import layers

    kernel_attention = layers.fused_attention

    def forced(q, k, v, key_mask=None, **kw):
        return kernel_attention(q, k, v, key_mask, **{**kw, "impl": impl})

    layers.fused_attention = forced
    try:
        yield
    finally:
        layers.fused_attention = kernel_attention


def pixart_forward_inputs(torch, seed: int) -> tuple:
    """One full-width PixArt-α-512 forward's inputs on the card, from the
    seed: latents [4,4,64,64], the 4-NFE grid's timesteps, T5 rows
    [4,120,4096] and masks of 120, 40, 3 and 0 live tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lat = torch.from_numpy(rng.standard_normal((4, 4, 64, 64)).astype(np.float32)).cuda()
    text = torch.from_numpy(rng.standard_normal((4, 120, 4096)).astype(np.float32)).cuda()
    mask = (torch.arange(120)[None] < torch.tensor([[120], [40], [3], [0]])).int().cuda()
    return lat, torch.tensor([899, 674, 449, 224], device="cuda"), text, mask


def full_forward_check(torch, transformer, seed: int) -> None:
    """One full-width forward of the served model with the kernel against
    the same forward with the plain attention, both on the card: bf16
    activations through 28 layers, so the check is relative (L2 error
    under 2%)."""
    from tdm_tpu_torch.ops import attention as A

    lat, t, text, mask = pixart_forward_inputs(torch, seed + 1)
    before = A.flash_attention_fwd.launches
    with torch.inference_mode():
        out = transformer(lat, t, text, mask).float()
        # the same forward with every Attention's call made plain, here only
        with forced_attention("plain"):
            ref = transformer(lat, t, text, mask).float()
    A.flash_attention_fwd.launches = before
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[check] full-width forward, kernel vs plain attention: rel L2 "
          f"{rel:.3e}, finite {bool(torch.isfinite(out).all())}", flush=True)
    check(bool(torch.isfinite(out).all()) and rel < 2e-2,
          f"full-width forward disagrees: rel L2 {rel}")


def tiny_step_inputs(torch, config, bundle, gen, dev) -> tuple:
    """A tiny step's draws and (cond, uncond) for 3 rows with text lengths
    8, 3 and 1, drawn on the CPU from `gen` and moved to `dev`."""
    from tdm_tpu_torch.train import tdm

    draws = tdm.make_draws(config, 3, bundle.sample_shape, gen, "cpu")
    draws = tdm.StepDraws(*(x.to(dev) for x in draws))
    text = torch.randn(3, bundle.seq_len, bundle.embed_dim, generator=gen).to(dev)
    mask = (torch.arange(bundle.seq_len)[None] < torch.tensor([[8], [3], [1]])).int().to(dev)
    return draws, (text, mask), (torch.zeros_like(text), torch.ones_like(mask))


def uncounted(A, fn) -> tuple:
    """fn()'s result and the kernel launches it made, which are then taken
    off the wrappers' counts: a check, not the main path."""
    before = A.launch_counts()
    out = fn()
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:
        w.launches = before[w.__name__]
    return out, launched


def phase_reference_train(torch, seed: int) -> None:
    """One tiny TDM step (fp32, dmd) on the card (the kernels) against the
    same step on the CPU (the plain versions), from one state with the same
    draws and conditioning. Losses and grad norms to 1e-4 relative; the
    update of each role (new − old params) to 5e-3 in relative L2 and each
    weight to 25% of lr (Adam ε 1e-4, as tests/test_torch_port_train.py
    holds the step against JAX: fp32 roundoff in another order; a weight
    whose gradient is a near-cancelling sum moves by lr·δg/ε, measured up to
    16% of lr between card and CPU)."""
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import families, optim as topt, tdm

    lr = 1e-4
    runs = {}
    cpu_params = None
    for dev in ("cpu", "cuda"):
        bundle = families.build("pixart", tiny=True, seed=seed, device=dev)
        if cpu_params is None:
            cpu_params = bundle.init_params()
        teacher = {k: v.to(dev) for k, v in cpu_params.items()}
        gen = torch.Generator(device="cpu").manual_seed(seed + 3)
        config = tdm.TDMConfig()
        draws, cond, uncond = tiny_step_inputs(torch, config, bundle, gen, dev)
        tx = topt.make_optimizer(lr, eps=1e-4)
        state = tdm.init_state(teacher, teacher, tx, tx)
        start = {r: {k: v.clone() for k, v in getattr(state, r).items()}
                 for r in ("student", "critic")}
        step = tdm.build_train_step(bundle.denoise_fn, teacher, bundle.schedule, config,
                                    tx, tx, sample_shape=bundle.sample_shape)
        (state, metrics), launched = uncounted(A, lambda: step(state, draws, cond, uncond))
        runs[dev] = (state, metrics, start, launched)
    (cs, cm, cstart, _), (gs, gm, gstart, glaunch) = runs["cpu"], runs["cuda"]
    # 2 layers x (self, cross): 7 no-grad forwards, 2 with grad
    want = {"flash_attention_fwd": 28, "flash_attention_fwd_lse": 8,
            "flash_attention_bwd_dq": 8, "flash_attention_bwd_dkv": 8,
            "splash_attention_fwd": 0}
    check(glaunch == want, f"tiny step launches {glaunch}, expected {want}")
    worst = {}
    for name in tdm.StepMetrics._fields:
        c, g = float(getattr(cm, name)), float(getattr(gm, name))
        worst[name] = abs(c - g) / max(abs(c), 1e-12)
        check(math.isfinite(g) and abs(c - g) <= 1e-4 * abs(c) + 1e-7,
              f"tiny step {name}: card {g} vs cpu {c}")
    upd = {}
    for role in ("student", "critic"):
        d_c = torch.cat([(getattr(cs, role)[k] - cstart[role][k]).flatten()
                         for k in cstart[role]])
        d_g = torch.cat([(getattr(gs, role)[k] - gstart[role][k]).cpu().flatten()
                         for k in cstart[role]])
        rel = float((d_g - d_c).norm() / d_c.norm())
        top = float((d_g - d_c).abs().max())
        upd[role] = (rel, top)
        check(float(d_c.abs().max()) > 0.5 * lr, f"tiny step: {role} did not move")
        check(rel <= 5e-3 and top <= 0.25 * lr,
              f"tiny step {role} update: rel L2 {rel:.3e}, max {top:.3e}")
    print(f"[reference] tiny TDM step (dmd) cuda (kernels: {glaunch}) vs cpu "
          f"(plain): metrics max rel err {max(worst.values()):.3e} (limit 1e-4); "
          f"update rel L2 / max: student {upd['student'][0]:.3e} / "
          f"{upd['student'][1]:.3e}, critic {upd['critic'][0]:.3e} / "
          f"{upd['critic'][1]:.3e} (limits 5e-3 / {0.25 * lr:.1e})", flush=True)
    reference_train_recipe(torch, seed, cpu_params, want)


def reference_family_step(torch, seed: int, family: str, want: dict,
                          total_steps: int = 900) -> dict:
    """One tiny TDM step of `family` (fp32, dmd, MSE, on the grid of
    `total_steps`) on the card (the kernels) against the same step on the
    CPU (the plain versions), from one state with the same draws: the
    bounds of phase_reference_train.
    MSE, as the recipe check: under the Huber loss the student's grad norm
    is ill-conditioned at one critic update. sd3 conditions on a seeded
    pooled vector too. Returns the card's launches, checked against `want`,
    and the worst errors."""
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import families, optim as topt, tdm

    lr = 1e-4
    runs = {}
    cpu_params = None
    for dev in ("cpu", "cuda"):
        bundle = families.build(family, tiny=True, seed=seed, device=dev)
        if cpu_params is None:
            cpu_params = bundle.init_params()
        teacher = {k: v.to(dev) for k, v in cpu_params.items()}
        gen = torch.Generator(device="cpu").manual_seed(seed + 6)
        config = tdm.TDMConfig(use_huber=False, total_steps=total_steps)
        draws, (text, mask), (utext, umask) = tiny_step_inputs(torch, config, bundle, gen, dev)
        if family == "sd3":
            pooled = torch.randn(3, bundle.model.cfg.pooled_dim, generator=gen).to(dev)
            cond = bundle.cond_of(text, mask, pooled)
            uncond = bundle.cond_of(utext, umask, torch.zeros_like(pooled))
        else:
            cond, uncond = bundle.cond_of(text, mask), bundle.cond_of(utext, umask)
        tx = topt.make_optimizer(lr, eps=1e-4)
        state = tdm.init_state(teacher, teacher, tx, tx)
        start = {r: {k: v.clone() for k, v in getattr(state, r).items()}
                 for r in ("student", "critic")}
        step = tdm.build_train_step(bundle.denoise_fn, teacher, bundle.schedule, config,
                                    tx, tx, sample_shape=bundle.sample_shape)
        (state, metrics), launched = uncounted(A, lambda: step(state, draws, cond, uncond))
        runs[dev] = (state, metrics, start, launched)
    (cs, cm, cstart, _), (gs, gm, gstart, glaunch) = runs["cpu"], runs["cuda"]
    check(glaunch == want, f"tiny {family} step launches {glaunch}, expected {want}")
    worst = {}
    for name in tdm.StepMetrics._fields:
        c, g = float(getattr(cm, name)), float(getattr(gm, name))
        worst[name] = abs(c - g) / max(abs(c), 1e-12)
        check(math.isfinite(g) and abs(c - g) <= 1e-4 * abs(c) + 1e-7,
              f"tiny {family} step {name}: card {g} vs cpu {c}")
    upd = {}
    for role in ("student", "critic"):
        d_c = torch.cat([(getattr(cs, role)[k] - cstart[role][k]).flatten()
                         for k in cstart[role]])
        d_g = torch.cat([(getattr(gs, role)[k] - gstart[role][k]).cpu().flatten()
                         for k in cstart[role]])
        rel = float((d_g - d_c).norm() / d_c.norm())
        top = float((d_g - d_c).abs().max())
        upd[role] = (rel, top)
        check(float(d_c.abs().max()) > 0.5 * lr, f"tiny {family} step: {role} did not move")
        check(rel <= 5e-3 and top <= 0.25 * lr,
              f"tiny {family} step {role} update: rel L2 {rel:.3e}, max {top:.3e}")
    print(f"[reference] tiny {family} TDM step (dmd, MSE, {bundle.schedule.prediction_type} "
          f"schedule) cuda (kernels: {glaunch}) vs cpu (plain): metrics max rel err "
          f"{max(worst.values()):.3e} (limit 1e-4); update rel L2 / max: student "
          f"{upd['student'][0]:.3e} / {upd['student'][1]:.3e}, critic {upd['critic'][0]:.3e} / "
          f"{upd['critic'][1]:.3e} (limits 5e-3 / {0.25 * lr:.1e})", flush=True)
    return {"launches": glaunch, "metrics_max_rel_err": max(worst.values()),
            "update_rel_l2": {r: u[0] for r, u in upd.items()}}


def phase_reference_train_sd3(torch, seed: int) -> None:
    """The tiny sd3 step (the flow schedule, pooled conditioning) on the card
    against the CPU: 2 joint blocks, 7 no-grad forwards and 2 with grad."""
    reference_family_step(torch, seed, "sd3", {
        "flash_attention_fwd": 14, "flash_attention_fwd_lse": 4,
        "flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4, "splash_attention_fwd": 0})


def phase_reference_train_cogvideox(torch, seed: int) -> dict:
    """The tiny cogvideox step (v-prediction at zero terminal SNR on the
    1000-step grid, whose first index is the terminal one; video latents
    [3, 16, 3, 8, 8]; T5 rows zeroed past their masks) on the card against
    the CPU: 2 blocks, 7 no-grad forwards and 2 with grad; then the same
    step as the recipe's LoRA student with 8-bit Adam and accumulation 2
    (reference_train_recipe)."""
    from tdm_tpu_torch.train import families

    want = {"flash_attention_fwd": 14, "flash_attention_fwd_lse": 4,
            "flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4,
            "splash_attention_fwd": 0}
    out = reference_family_step(torch, seed, "cogvideox", want, total_steps=1000)
    cpu_params = families.build("cogvideox", tiny=True, seed=seed, device="cpu").init_params()
    reference_train_recipe(torch, seed, cpu_params, want, family="cogvideox", total_steps=1000)
    return out


def phase_reference_train_sd15(torch, seed: int) -> dict:
    """The tiny sd15 step (the scaled-linear schedule, the UNet's im2col
    convolutions) on the card against the CPU: 4 spatial transformers x
    (self, cross), 7 no-grad forwards and 2 with grad."""
    return reference_family_step(torch, seed, "sd15", {
        "flash_attention_fwd": 56, "flash_attention_fwd_lse": 16,
        "flash_attention_bwd_dq": 16, "flash_attention_bwd_dkv": 16, "splash_attention_fwd": 0})


def q8_decoded(torch, q, shape):
    """A packed moment's fp32 values and each one's bound on its
    quantization error, one int8 code step at its magnitude:
    (2·sqrt(|x|/s) + 1/254)·s/254, s the block's absmax scale."""
    from tdm_tpu_torch.train import optim as topt

    x = topt.q8_dequantize(q, shape).cpu()
    s = q.scales.cpu().repeat_interleave(topt.Q8_BLOCK)[:x.numel()].reshape(shape)
    return x, (2 * torch.sqrt(x.abs() / s.clamp(min=1e-30)) + 1 / 254) * s / 254


def state_to(torch, obj, dev):
    """A copy of a (nested) train state with every tensor on `dev`."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(dev, copy=True)
    if isinstance(obj, dict):
        return {k: state_to(torch, v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(state_to(torch, v, dev) for v in obj))
    return obj


def q8_moments(torch, opt, params: dict) -> dict:
    """'{mu|nu} {name}' → (fp32 values, one-code-step bound) on the CPU for
    every quantized moment of an accumulating 8-bit optimizer (q8_decoded)."""
    from tdm_tpu_torch.train import optim as topt

    out = {}
    for m in ("mu", "nu"):
        for k, q in topt.leaf_moments(getattr(opt.inner, m), params).items():
            if isinstance(q, topt.Q8Moment):
                check(q.values.dtype == torch.int8, f"{m} {k}: codes are {q.values.dtype}")
                out[f"{m} {k}"] = q8_decoded(torch, q, params[k].shape)
    return out


def reference_train_recipe(torch, seed: int, cpu_params: dict, want: dict,
                           family: str = "pixart", total_steps: int = 900) -> None:
    """The tiny step of phase_reference_train (or of `family`'s tiny model,
    on the grid of `total_steps`) with a rank-4 LoRA student
    (both factors seeded), 8-bit Adam and accumulation 2, two windows (four
    micro-steps) on the card against the CPU, the packed 8-bit update cut
    into slices of 40 blocks (several on the tiny critic, some holding two
    leaves). Window 1 starts from zero moments; window 2 starts on both
    sides from the CPU's state after window 1 (its stored int8 codes
    copied to the card), so its update reads stored codes from the same
    inputs. Bounds as the plain tiny step: losses and grad norms to 1e-4
    relative at every micro-step; inside a window every parameter keeps its
    bits; each window's update (new − old params) of each role to 5e-3
    relative L2 and each weight to 25% of lr. The requantized moments may
    differ by one code where a value sits at a rounding boundary, so after
    each window each decoded moment is held within one code step of each
    side (q8_decoded) plus 1e-6 of the leaf's largest value. The loss is
    MSE, as in tests/test_torch_port_train.py's 8-bit step: under the Huber
    loss (c = 1e-3) the student's grad norm of micro-step 3 differed by
    1.2e-4 and 2.6e-4 relative between card and CPU, the second time from
    the same state, while the plain step's differs by 4.1e-5."""
    from tdm_tpu_torch import lora as lora_lib
    from tdm_tpu_torch.io import from_jax
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import families, optim as topt, tdm

    lr = 1e-4
    roles = ("student", "critic")
    runs = {}
    full_slice = topt._SLICE
    topt._SLICE = 40 * topt.Q8_BLOCK
    try:
        for dev in ("cpu", "cuda"):
            bundle = families.build(family, tiny=True, seed=seed, device=dev)
            teacher = {k: v.to(dev) for k, v in cpu_params.items()}
            lora = seeded_lora(torch, bundle.model, 4, seed + 5)
            factors = {k: v.to(dev) for k, v in lora_lib.factors(lora).items()}
            tx = topt.make_optimizer(lr, eps=1e-4, eight_bit=True, accumulation_steps=2)
            config = tdm.TDMConfig(use_huber=False, total_steps=total_steps)
            step = tdm.build_train_step(
                bundle.denoise_fn, teacher, bundle.schedule, config, tx, tx,
                sample_shape=bundle.sample_shape, student_denoise_fn=lora_lib.wrap_denoise_fn(
                    bundle.denoise_fn, lora, stacks=from_jax.layer_stacks(bundle.model.cfg)))
            gen = torch.Generator(device="cpu").manual_seed(seed + 4)
            inputs = [tiny_step_inputs(torch, config, bundle, gen, dev) for _ in range(4)]
            runs[dev] = {"state": tdm.init_state(factors, teacher, tx, tx), "step": step,
                         "inputs": [(draws, bundle.cond_of(*cond), bundle.cond_of(*uncond))
                                    for draws, cond, uncond in inputs],
                         "params": [], "metrics": [], "launched": [], "moments": []}

        def snapshot(run):
            run["params"].append({r: {k: v.cpu().clone()
                                      for k, v in getattr(run["state"], r).items()}
                                  for r in roles})

        for run in runs.values():
            snapshot(run)
        for i in range(4):
            if i == 2:  # window 2 starts from the CPU's state on both sides
                runs["cuda"]["state"] = state_to(torch, runs["cpu"]["state"], "cuda")
                runs["cuda"]["params"][-1] = runs["cpu"]["params"][-1]
            for run in runs.values():
                draws, cond, uncond = run["inputs"][i]
                (run["state"], metrics), launched = uncounted(
                    A, lambda: run["step"](run["state"], draws, cond, uncond))
                run["metrics"].append(metrics)
                run["launched"].append(launched)
                snapshot(run)
                if i % 2:
                    st = run["state"]
                    run["moments"].append({r: q8_moments(torch, getattr(st, f"{r}_opt"),
                                                         getattr(st, r)) for r in roles})
    finally:
        topt._SLICE = full_slice
    cpu, card = runs["cpu"], runs["cuda"]
    worst, upd = 0.0, {}
    for i, (cm, gm, glaunch) in enumerate(zip(cpu["metrics"], card["metrics"],
                                              card["launched"])):
        check(glaunch == want, f"tiny recipe micro-step {i + 1} launches {glaunch}")
        for name in tdm.StepMetrics._fields:
            c, g = float(getattr(cm, name)), float(getattr(gm, name))
            worst = max(worst, abs(c - g) / max(abs(c), 1e-12))
            check(math.isfinite(g) and abs(c - g) <= 1e-4 * abs(c) + 1e-7,
                  f"tiny recipe micro-step {i + 1} {name}: card {g} vs cpu {c}")
    cp, gp = cpu["params"], card["params"]
    for role in roles:
        for window, lo in ((1, 0), (2, 2)):
            for k in cp[lo][role]:
                check(torch.equal(cp[lo + 1][role][k], cp[lo][role][k])
                      and torch.equal(gp[lo + 1][role][k], gp[lo][role][k]),
                      f"tiny recipe: {role} {k} changed at micro-step {lo + 1}")
            d_c = torch.cat([(cp[lo + 2][role][k] - cp[lo][role][k]).flatten()
                             for k in cp[lo][role]])
            d_g = torch.cat([(gp[lo + 2][role][k] - gp[lo][role][k]).flatten()
                             for k in cp[lo][role]])
            rel = float((d_g - d_c).norm() / d_c.norm())
            top = float((d_g - d_c).abs().max())
            upd[(role, window)] = (rel, top)
            check(float(d_c.abs().max()) > 0.5 * lr,
                  f"tiny recipe: {role} did not move in window {window}")
            check(rel <= 5e-3 and top <= 0.25 * lr,
                  f"tiny recipe {role} window {window} update: rel L2 {rel:.3e}, max {top:.3e}")
    n_q = 0
    for window, (cmom, gmom) in enumerate(zip(cpu["moments"], card["moments"]), 1):
        for role in roles:
            for key, (x_c, e_c) in cmom[role].items():
                n_q += window == 2
                x_g, e_g = gmom[role][key]
                bound = e_c + e_g + 1e-6 * float(x_c.abs().max())
                check(bool(((x_g - x_c).abs() <= bound).all()),
                      f"tiny recipe window {window} {role} {key}: card and cpu moments "
                      "differ by more than one int8 code step")
    for role in roles:
        gopt = getattr(card["state"], f"{role}_opt")
        check((gopt.mini_step, gopt.gradient_step, gopt.inner.count) == (0, 2, 2),
              f"tiny recipe {role}: counters {gopt.mini_step, gopt.gradient_step}")
        check(gopt.inner.mu.codes.is_cuda and gopt.inner.nu.codes.is_cuda,
              f"tiny recipe {role}: moments not on the card")
    check(n_q > 0, "tiny recipe: no quantized moment")
    print(f"[reference] tiny {family} TDM recipe step (rank-4 LoRA, 8-bit Adam, "
          f"accumulation 2; 2 "
          f"windows of 2 micro-steps, slices of 40 blocks; window 2 from the cpu's state) "
          f"cuda vs cpu: metrics max rel err {worst:.3e} (limit 1e-4); bits kept inside each "
          f"window; update rel L2 / max, windows 1 and 2: " + "; ".join(
              f"{role} {upd[(role, 1)][0]:.3e} / {upd[(role, 1)][1]:.3e}, "
              f"{upd[(role, 2)][0]:.3e} / {upd[(role, 2)][1]:.3e}" for role in roles)
          + f" (limits 5e-3 / {0.25 * lr:.1e}); {n_q} int8 moments within one code step "
          "after each window", flush=True)


def seeded_lora(torch, model, rank: int, seed: int):
    """A LoRA on the default targets with both factors drawn from the seed
    (peft's init leaves b = 0, which would merge to nothing)."""
    from tdm_tpu_torch.lora import adapter

    gen = torch.Generator().manual_seed(seed)
    lora = adapter.init_lora(model, rank, generator=gen)
    for entry in lora.params.values():
        entry["b"] = 0.02 * torch.randn(entry["b"].shape, generator=gen)
    return lora


def phase_reference_sd3(torch, seed: int, workdir: str) -> None:
    """A tiny SD3 pipeline at head dim 64 (fp32, attn_impl='splash': the
    splash kernel on the card) with a merged kohya LoRA at 0.125, against
    the same pipeline on the CPU (the plain version): the sampler state is
    bf16 in both, so the latents agree to one bf16 ulp of their scale and
    the images to half a PNG step."""
    import dataclasses

    import numpy as np

    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import mmdit_sd3
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines.sd3 import default_sd3_pipeline

    torch.manual_seed(seed)
    cfg = dataclasses.replace(mmdit_sd3.MMDiTConfig.tiny(), head_dim=64, attn_impl="splash")
    cpu = default_sd3_pipeline(cfg=cfg, device="cpu")
    gpu = default_sd3_pipeline(cfg=cfg, device="cuda")
    gpu.transformer.load_state_dict(cpu.transformer.state_dict())
    gpu.vae_decoder.load_state_dict(cpu.vae_decoder.state_dict())
    lora_file = os.path.join(workdir, "tiny_lora.safetensors")
    lora_io.save_kohya(seeded_lora(torch, cpu.transformer, 4, seed), lora_file)
    for pipe in (cpu, gpu):
        pipe.load_lora_weights(lora_file, adapter_name="tdm")
        pipe.set_adapters(["tdm"], [0.125])
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((3, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((3, 21, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((3, cfg.pooled_dim)).astype(np.float32)
    kw = dict(prompt_embeds=(ctx, pooled), latents=lat, height=64, width=64)
    ref = cpu(**kw)
    before = A.launch_counts()
    got = gpu(**kw)
    torch.cuda.synchronize()
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:  # a check, not the main path
        w.launches = before[w.__name__]
    dl = (got.latents.float().cpu() - ref.latents.float()).abs()
    scale = ref.latents.float().abs().max().item()
    di = (got.images.cpu() - ref.images).abs().max().item()
    print(f"[reference] tiny SD3 pipeline (head dim 64, LoRA at 0.125) cuda (splash kernel, "
          f"{launched['splash_attention_fwd']} launches) vs cpu (plain): latents max_abs_err "
          f"{dl.max().item():.3e} of scale {scale:.3g}, {(dl > 0).float().mean().item():.4f} "
          f"of elements differ; images max_abs_err {di:.3e}", flush=True)
    check(launched["splash_attention_fwd"] == cfg.num_layers * 4
          and launched["flash_attention_fwd"] == 0, f"tiny SD3 launches {launched}")
    check(dl.max().item() <= 2**-7 * scale, "tiny SD3 latents disagree")
    check((dl > 0).float().mean().item() < 0.01, "tiny SD3 latents disagree")
    check(di <= 2e-3, "tiny SD3 images disagree")


# per batch of 4 at 4 NFE: one joint attention in each of the 24 blocks
SD3_LAUNCHES_PER_BATCH = 24 * 4


def phase_sd3(torch, seed: int, workdir: str) -> dict:
    """Full-width SD3-Medium 1024² served over HTTP through the port with
    the splash kernel and a LoRA at the recipe's scale."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.io import convert, from_jax, params as params_io
    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import mmdit_sd3, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.serve import server as S

    # SD3-Medium (24 layers, hidden 1536, 24x64 heads, context 4096, pooled
    # 2048, bf16) in the tdm_tpu layout: the seeded transformer of the SD3
    # checkout (written once per run, shared with the diffusers and
    # train_sd3 phases) converted to the JAX package's tree and kept at the
    # checkout's fp16, a seeded TAESD3 decoder, the rank-64 LoRA
    root, _, _ = sd3_checkout(workdir, seed)
    t0 = time.monotonic()
    cfg = mmdit_sd3.MMDiTConfig(attn_impl="splash")
    check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.context_dim,
           cfg.pooled_dim, cfg.sample_size) == (24, 1536, 24, 64, 4096, 2048, 128),
          "SD3-Medium widths")
    model_dir = os.path.join(workdir, "sd3_medium")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "pipeline.json"), "w") as f:
        json.dump({"family": "sd3", "model": {"attn_impl": "splash"}, "vae": {}}, f)
    tree = from_jax.flatten_tree(convert.sd3_params(
        convert.load_torch_state_dict(os.path.join(root, "transformer")),
        scan_layers=cfg.scan_layers))
    n_params = sum(a.size for a in tree.values())
    params_io.save_file(tree, os.path.join(model_dir, "transformer.safetensors"))
    del tree
    torch.manual_seed(seed)
    params_io.save_file(
        from_jax.jax_layout(vae.TAESDDecoder(vae.TAESDConfig.taesd3()).state_dict()),
        os.path.join(model_dir, "vae_decoder.safetensors"))
    lora = seeded_lora(torch, mmdit_sd3.SD3Transformer2D(cfg, device="meta"), 64, seed)
    lora_file = os.path.join(workdir, "sd3_tdm_lora.safetensors")
    lora_io.save_kohya(lora, lora_file)
    lora_mb = os.path.getsize(lora_file) / 1e6
    # an embedding cache of 8 prompts: 333 context tokens and a pooled vector
    rng = np.random.default_rng(seed)
    prompts = [f"prompt {i}" for i in range(8)]
    cache = os.path.join(workdir, "sd3_cache.npz")
    EmbeddingCache(
        rng.standard_normal((8, SD3_TXT, 4096)).astype(np.float16),
        np.ones((8, SD3_TXT), np.int32), prompts,
        pooled=rng.standard_normal((8, 2048)).astype(np.float16),
    ).save(cache)
    print(f"[sd3] wrote SD3-Medium ({cfg.num_layers} layers, {n_params / 1e6:.1f}M params "
          f"from the checkout, fp16) in the tdm_tpu layout, a rank-64 kohya LoRA "
          f"({len(lora.params)} entries, {lora_mb:.0f} MB) and an 8-prompt pooled cache in "
          f"{time.monotonic() - t0:.1f}s", flush=True)

    t0 = time.monotonic()
    args = S.parse_args([
        "--model", model_dir, "--embedding_cache", cache, "--port", "0",
        "--batch_size", "4", "--max_delay_ms", "1000", "--warmup",
        "--lora", lora_file, "--lora_scale", "0.125",
    ])
    server = S.build_server(args).start()
    stats = server.batcher.stats
    pipe = server.batcher.pipe
    check(pipe.family == "sd3" and pipe.transformer.cfg == cfg
          and isinstance(pipe.vae_decoder, vae.TAESDDecoder)
          and pipe._active == (("tdm", 0.125),), "the served SD3 pipeline")
    print(f"[sd3] loaded, merged the LoRA and warmed in {time.monotonic() - t0:.1f}s "
          f"(warm-up batch {stats.last_batch_latency_s:.3f}s)", flush=True)

    def post(prompt, seed):
        body = json.dumps({"prompt": prompt, "seed": seed}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        t = time.monotonic()
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
        return out, time.monotonic() - t

    try:
        # the main path: counts to 0, 8 concurrent requests (two full
        # batches), then one request alone for determinism
        A.reset_launches()
        b0, pad0 = stats.batches, stats.rows_padded
        t0 = time.monotonic()
        with ThreadPoolExecutor(8) as ex:
            replies = list(ex.map(lambda i: post(prompts[i], 200 + i), range(8)))
        wall8 = time.monotonic() - t0
        batches8, padded8 = stats.batches - b0, stats.rows_padded - pad0
        batch_s = stats.last_batch_latency_s
        solo, solo_s = post(prompts[0], 200)
        launches = A.launch_counts()
        batches = stats.batches - b0
    finally:
        server.close()
    for reply, _ in replies + [(solo, solo_s)]:
        check(reply.get("format") == "png" and reply.get("shape") == [1024, 1024, 3],
              f"reply {str(reply)[:200]}")
        check_png(base64.b64decode(reply["image"]), 1024, 1024)
    check(batches8 == 2 and padded8 == 0, f"8 requests ran as {batches8} batches")
    check(solo["image"] == replies[0][0]["image"],
          "same (prompt, seed) gave different bytes in another batch")
    check(len({r["image"] for r, _ in replies}) == 8, "distinct seeds gave equal images")
    check(launches["splash_attention_fwd"] == SD3_LAUNCHES_PER_BATCH * batches
          and sum(launches.values()) == launches["splash_attention_fwd"],
          f"launches {launches} over {batches} batches, expected "
          f"{SD3_LAUNCHES_PER_BATCH} splash and nothing else per batch")
    lat = [s for _, s in replies]
    print(f"[sd3] 8 concurrent requests in {wall8:.3f}s as {batches8} batches "
          f"({8 / wall8:.2f} images/s), request latency {min(lat):.3f}-{max(lat):.3f}s, "
          f"last batch {batch_s:.3f}s; lone request {solo_s:.3f}s; same (prompt, seed) -> "
          f"same PNG bytes; launches {launches} = {SD3_LAUNCHES_PER_BATCH} splash x {batches} "
          f"batches", flush=True)
    cond = tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[1]))
    noise = torch.randn(4, 16, 128, 128)
    prof = profile_batch(torch, pipe, cond, noise, kernel="splash_fwd")
    forward_rel = sd3_forward_check(torch, pipe.transformer, seed)
    gated = reckon_gated(torch, mmdit_sd3.SD3Transformer2D(cfg, device="meta"),
                         (4, 16, 128, 128), (4,), (4, SD3_TXT, 4096), (4, 2048))[1]
    int8 = int8_serving(
        torch, "sd3", pipe, cond, noise,
        tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[2])),
        torch.randn(4, 16, 128, 128), gated_per_forward=gated, forwards=4,
        wrapper="splash_attention_fwd")
    return {"launches": launches["splash_attention_fwd"], "batches": batches,
            "launches_per_batch": SD3_LAUNCHES_PER_BATCH, "wall8_s": wall8,
            "images_per_s": 8 / wall8, "batch_s": batch_s, "solo_s": solo_s,
            "profile": prof, "splash_vs_flash_forward_rel_l2": forward_rel, "int8": int8}


def sd3_forward_check(torch, transformer, seed: int) -> float:
    """One full-width SD3 forward (batch 4, the served LoRA merged) through
    the splash kernel against the same forward through the flash kernel,
    both bf16 on the card: two kernels' roundings through 24 layers, so the
    check is relative (L2 error under 2%)."""
    import numpy as np

    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 2)
    lat = torch.from_numpy(rng.standard_normal((4, 16, 128, 128)).astype(np.float32)).cuda()
    ctx = torch.from_numpy(rng.standard_normal((4, SD3_TXT, 4096)).astype(np.float32)).cuda()
    pooled = torch.from_numpy(rng.standard_normal((4, 2048)).astype(np.float32)).cuda()
    t = torch.tensor([1000.0, 750.0, 500.0, 250.0], device="cuda")
    before = A.launch_counts()
    with torch.inference_mode():
        out = transformer(lat, t, ctx, pooled).float()
        with forced_attention("auto"):
            ref = transformer(lat, t, ctx, pooled).float()
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:  # a check, not the main path
        w.launches = before[w.__name__]
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[check] full-width SD3 forward, splash kernel vs flash kernel: rel L2 "
          f"{rel:.3e}, finite {bool(torch.isfinite(out).all())}, launches {launched}",
          flush=True)
    check(launched["splash_attention_fwd"] == 24 and launched["flash_attention_fwd"] == 24,
          f"forward check launches {launched}")
    check(bool(torch.isfinite(out).all()) and rel < 2e-2,
          f"full-width SD3 forward disagrees: rel L2 {rel}")
    return rel


# per batch of 4 at 4 NFE: a self and a cross attention in each of the 28
# PixArt blocks
PIXART_LAUNCHES_PER_BATCH = 28 * 2 * 4
# the KL decoder on the card against the CPU, fp32 with TF32 off: the same
# convs, GroupNorms and softmax by other algorithms, relative L2
KL_REL_L2 = 1e-5


def kl_decoder_check(torch, seed: int) -> dict:
    """A tiny KL decoder (4 latent channels, and SD3's 16 at narrow widths)
    on the card against the same decoder and weights on the CPU, fp32 with
    TF32 off: relative L2 under KL_REL_L2, and finite."""
    import dataclasses

    import numpy as np

    from tdm_tpu_torch.io import convert, from_jax, manifest
    from tdm_tpu_torch.models import vae

    out = {}
    for name, vcfg in (("tiny", vae.KLVAEConfig.tiny()),
                       ("sd3_narrow", dataclasses.replace(
                           vae.KLVAEConfig.sd3(), block_widths=(32, 64, 64), norm_groups=8))):
        sd = manifest.synthetic_state_dict("klvae", vcfg, seed=seed, scale=0.3)
        flat = convert.flatten(convert.klvae_params(
            sd, layers_per_block=vcfg.layers_per_block, n_stages=len(vcfg.block_widths)
        )["decoder"])
        z = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (2, vcfg.latent_channels, 24, 20)).astype(np.float32))
        got = {}
        for dev in ("cpu", "cuda"):
            dec = from_jax.load_from_jax(flat, vae.KLDecoder(vcfg, device=dev))
            with torch.inference_mode():
                got[dev] = dec(z.to(dev)).cpu()
        rel = ((got["cuda"] - got["cpu"]).norm() / got["cpu"].norm()).item()
        print(f"[diffusers] KL decoder {name} {list(got['cuda'].shape)} fp32 card vs CPU: "
              f"rel L2 {rel:.3e} (limit {KL_REL_L2})", flush=True)
        check(bool(torch.isfinite(got["cuda"]).all()) and rel <= KL_REL_L2,
              f"the KL decoder ({name}) on the card disagrees with the CPU: rel L2 {rel}")
        out[name] = rel
    return out


def decode_alone(torch, pipe, shape: tuple, seed: int) -> dict:
    """The pipeline's VAE decode of one batch of latents of `shape` alone
    (the cost does not depend on the values): its device time and launches
    under torch.profiler, and its CUDA-event time warm (mean of 3), a
    check on the `vae_decode` range of a profiled batch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(shape, device="cuda", generator=gen)
    dec = pipe.vae_decoder
    flops = [0]

    def count(module, args, out):  # 2 operations per multiply-add
        if isinstance(module, torch.nn.Conv2d):
            flops[0] += 2 * out.numel() * module.in_channels * math.prod(module.kernel_size)
        elif isinstance(module, torch.nn.Linear):
            flops[0] += 2 * out.numel() * module.in_features
        else:  # the mid-block's one-head attention: q·kᵀ and p·v over h·w positions
            b, c, h, w = args[0].shape
            flops[0] += 2 * 2 * b * (h * w) ** 2 * c

    hooks = [m.register_forward_hook(count) for m in dec.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
             or type(m).__name__ == "_MidAttention"]
    with torch.inference_mode():
        dec(z)
        for hook in hooks:
            hook.remove()
        out, launches, device_ms = count_device_work(torch, lambda: dec(z))
        event_ms = time_ms(torch, lambda: dec(z), iters=3, warmup=1)
    check(bool(torch.isfinite(out).all()), f"{type(dec).__name__} decode is not finite")
    rate = flops[0] / (device_ms * 1e-3)
    print(f"[diffusers] {type(dec).__name__} decode alone {list(shape)} -> "
          f"{list(out.shape)} fp32: {device_ms:.1f} ms of device time over {launches} "
          f"launches, {event_ms:.1f} ms by CUDA events (mean of 3); {flops[0] / 1e12:.2f} "
          f"TFLOP in its convs, linears and attention products, {rate / 1e12:.1f} TFLOP/s "
          f"= {rate / PEAK_OPS_S['float32']:.2f} of the fp32 peak", flush=True)
    return {"device_ms": device_ms, "launches": launches, "event_ms": event_ms,
            "tflop": flops[0] / 1e12, "tflop_s": rate / 1e12}


def convert_round_trip(torch, root: str, transformer, seed: int, workdir: str) -> dict:
    """`python -m tdm_tpu_torch.cli.convert_checkpoint` on the full-width
    PixArt-α-512 checkout's transformer/: --check-manifest (headers only),
    --src/--dst to the tdm_tpu param file (scan-stacked, fp16 as the
    checkout) and --reverse back to the diffusers layout. The reversed
    state dict against the checkout's tensor by tensor (dtype, shape and
    bytes); the param file through `io/params.load_params` and the weight
    carry into a PixArtTransformer2D whose weights and one forward on the
    card must equal the checkout-loaded (served) transformer's bit for bit.
    Each file is deleted once read."""
    from tdm_tpu_torch.io import convert, from_jax, params as params_io
    from tdm_tpu_torch.models import pixart
    from tdm_tpu_torch.ops import attention as A

    src_dir = os.path.join(root, "transformer")
    src = os.path.join(src_dir, "diffusion_pytorch_model.safetensors")
    param_file = os.path.join(workdir, "pixart.tdm.safetensors")
    torch_file = os.path.join(workdir, "pixart.diffusers.safetensors")

    def cli(*argv):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "tdm_tpu_torch.cli.convert_checkpoint", "--family",
             "pixart", *argv], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0,
              f"convert_checkpoint {argv}: {proc.stdout[-1000:]} {proc.stderr[-2000:]}")
        return proc.stdout.strip(), time.monotonic() - t0

    line, check_s = cli("--check-manifest", src)
    check(line.endswith("keys match the pixart inventory"), f"--check-manifest: {line}")
    _, convert_s = cli("--src", src_dir, "--dst", param_file)
    _, reverse_s = cli("--reverse", "--src", param_file, "--dst", torch_file)
    gb = {"checkout": os.path.getsize(src) / 1e9, "param_file": os.path.getsize(param_file) / 1e9,
          "reversed": os.path.getsize(torch_file) / 1e9}
    t0 = time.monotonic()
    ref, back = params_io.load_file(src), params_io.load_file(torch_file)
    differing = sorted(k for k in ref if k not in back or ref[k].dtype != back[k].dtype
                       or ref[k].shape != back[k].shape or ref[k].tobytes() != back[k].tobytes())
    n_tensors, extra = len(ref), sorted(set(back) - set(ref))
    del ref, back
    os.remove(torch_file)
    check(not differing and not extra,
          f"the reversed state dict differs from the checkout: {differing[:5]} {extra[:5]}")
    compare_s = time.monotonic() - t0
    t0 = time.monotonic()
    model = pixart.PixArtTransformer2D(transformer.cfg, device="cuda")
    from_jax.load_from_jax(convert.flatten(params_io.load_params(param_file)), model)
    os.remove(param_file)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    served, carried = transformer.state_dict(), model.state_dict()
    weights_equal = served.keys() == carried.keys() and all(
        torch.equal(served[k], carried[k]) for k in served)
    lat, t, text, mask = pixart_forward_inputs(torch, seed + 5)
    with torch.inference_mode():
        (a, b), _ = uncounted(A, lambda: (transformer(lat, t, text, mask),
                                          model(lat, t, text, mask)))
    same = torch.equal(a, b)
    del model, served, carried
    torch.cuda.empty_cache()
    print(f"[convert] python -m tdm_tpu_torch.cli.convert_checkpoint on the PixArt-α-512 "
          f"checkout ({gb['checkout']:.2f} GB at fp16): --check-manifest {check_s:.2f}s, "
          f"--src/--dst {convert_s:.2f}s ({gb['param_file']:.2f} GB, stacked), --reverse "
          f"{reverse_s:.2f}s ({gb['reversed']:.2f} GB; {n_tensors} tensors equal to the "
          f"checkout's byte for byte, compared in {compare_s:.2f}s); the param file through "
          f"load_params and the carry to the card in {load_s:.2f}s: weights equal to the "
          f"served transformer's {weights_equal}, one forward [4,4,64,64] bit for bit {same}",
          flush=True)
    check(weights_equal, "the converted file carried other weights than the checkout's")
    check(same, "the converted file's transformer gave other bits than the checkout's")
    return {"check_manifest_s": check_s, "convert_s": convert_s, "reverse_s": reverse_s,
            "compare_s": compare_s, "load_and_carry_s": load_s, "gb": gb,
            "tensors_equal": n_tensors, "forward_bit_equal": same}


def diffusers_pixart(torch, seed: int, workdir: str) -> dict:
    """The PixArt-α-512 checkout served over HTTP from --model <checkout>:
    the load (its read and conversion apart), 6 concurrent requests (two
    batches of 4, one padded), PNGs, per-seed determinism, the flash
    kernel's launches per batch, and a profiled batch with the KL decode."""
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    import numpy as np

    from tdm_tpu_torch.models import vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.serve import server as S

    root = pixart_checkout(workdir, seed)
    cache, prompts = pixart_cache(workdir, seed)
    t0 = time.monotonic()
    args = S.parse_args([
        "--model", root, "--embedding_cache", cache, "--port", "0",
        "--batch_size", "4", "--max_delay_ms", "1000", "--warmup",
    ])
    with timed_calls(torch, load_targets()) as times:
        server = S.build_server(args).start()
    up_s = time.monotonic() - t0
    load = load_report(times)
    stats, pipe = server.batcher.stats, server.batcher.pipe
    check(isinstance(pipe.vae_decoder, vae.KLDecoder) and pipe.vae_range == "pm1"
          and pipe.vae_scaling == 0.18215 and pipe.vae_decoder.cfg.dtype == torch.float32
          and pipe.transformer.cfg.dtype == torch.bfloat16, "the served PixArt checkout")
    print(f"[diffusers] PixArt-α-512 checkout loaded in {load['load_s']:.2f}s (safetensors "
          f"read {load['read_s']:.2f}s, conversion {load['convert_s']:.3f}s = "
          f"{load['convert_share']:.3f} of the load, modules and copy to the card "
          f"{load['build_and_copy_s']:.2f}s); server up and warm in {up_s:.1f}s (warm-up "
          f"batch {stats.last_batch_latency_s:.3f}s)", flush=True)

    def post(prompt, seed):
        body = json.dumps({"prompt": prompt, "seed": seed}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        t = time.monotonic()
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, time.monotonic() - t

    try:
        # the main path: counts to 0, 6 concurrent requests, then one alone
        A.reset_launches()
        b0, pad0 = stats.batches, stats.rows_padded
        t0 = time.monotonic()
        with ThreadPoolExecutor(6) as ex:
            replies = list(ex.map(lambda i: post(prompts[i], 300 + i), range(6)))
        wall6 = time.monotonic() - t0
        batches6 = stats.batches - b0
        solo, solo_s = post(prompts[0], 300)
        launches = A.launch_counts()
        batches = stats.batches - b0
        solo_batch_s = stats.last_batch_latency_s
    finally:
        server.close()
    for reply, _ in replies + [(solo, solo_s)]:
        check(reply.get("format") == "png" and reply.get("shape") == [512, 512, 3],
              f"reply {str(reply)[:200]}")
        check_png(base64.b64decode(reply["image"]), 512, 512)
    check(batches6 == 2 and stats.rows_padded - pad0 == 2 + 3,
          f"6 requests ran as {batches6} batches")
    check(solo["image"] == replies[0][0]["image"],
          "same (prompt, seed) gave different bytes in another batch")
    check(len({r["image"] for r, _ in replies}) == 6, "distinct seeds gave equal images")
    check(launches["flash_attention_fwd"] == PIXART_LAUNCHES_PER_BATCH * batches
          and sum(launches.values()) == launches["flash_attention_fwd"],
          f"launches {launches} over {batches} batches, expected "
          f"{PIXART_LAUNCHES_PER_BATCH} flash_fwd and nothing else per batch")
    lat = [t for _, t in replies]
    print(f"[diffusers] PixArt checkout: 6 concurrent requests in {wall6:.3f}s as "
          f"{batches6} batches ({6 / wall6:.2f} images/s), request latency "
          f"{min(lat):.3f}-{max(lat):.3f}s; lone request {solo_s:.3f}s, its batch "
          f"{solo_batch_s:.3f}s; same (prompt, seed) -> same PNG bytes; launches "
          f"{launches} = {PIXART_LAUNCHES_PER_BATCH} flash_fwd x {batches} batches", flush=True)
    cond = tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[1]))
    prof = profile_batch(torch, pipe, cond, torch.randn(4, 4, 64, 64))
    decode = decode_alone(torch, pipe, (4, 4, 64, 64), seed)
    converted = convert_round_trip(torch, root, pipe.transformer, seed, workdir)
    return {"load": load, "up_s": up_s, "decode": decode, "convert": converted,
            "launches": launches["flash_attention_fwd"], "batches": batches, "launches_per_batch": PIXART_LAUNCHES_PER_BATCH,
            "wall6_s": wall6, "images_per_s": 6 / wall6, "batch_s": solo_batch_s,
            "solo_s": solo_s, "profile": prof}


def sd3_checkout(workdir: str, seed: int) -> tuple[str, float, int]:
    """The SD3-Medium checkout (24 layers, hidden 1536, 24x64 heads, context
    4096, pooled 2048; its 16-channel AutoencoderKL, scaling 1.5305, shift
    0.0609), written once per run: (its root, the seconds and parameters of
    the write, 0 when it was there)."""
    from tdm_tpu_torch.models import mmdit_sd3, vae

    cfg, vcfg = mmdit_sd3.MMDiTConfig(), vae.KLVAEConfig.sd3()
    check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.attn_impl,
           cfg.context_dim, cfg.pooled_dim, vcfg.latent_channels, vcfg.scaling_factor,
           vcfg.shift_factor)
          == (24, 1536, 24, 64, "auto", 4096, 2048, 16, 1.5305, 0.0609),
          "SD3-Medium and its VAE")
    root = os.path.join(workdir, "stable-diffusion-3-medium-diffusers")
    if os.path.exists(os.path.join(root, "model_index.json")):
        return root, 0.0, 0
    import torch

    secs, n = write_checkout(root, "sd3", cfg, vcfg, seed)
    enc = seeded_encoders(torch, workdir, seed, ["clip_l_proj", "clip_g", "t5"])
    for sub, name in (("text_encoder", "clip_l_proj"), ("text_encoder_2", "clip_g"),
                      ("text_encoder_3", "t5")):
        link_encoder(enc[name][0], os.path.join(root, sub))
    print(f"[checkout] wrote the SD3-Medium diffusers checkout ({n / 1e6:.1f}M params at "
          f"fp16) in {secs:.1f}s, its text_encoder, _2, _3 (CLIP-L, CLIP-G, T5-XXL) "
          "hardlinked", flush=True)
    return root, secs, n


def diffusers_sd3(torch, seed: int, workdir: str) -> dict:
    """The SD3-Medium checkout (24 layers, hidden 1536, 24x64 heads; its
    16-channel AutoencoderKL, scaling 1.5305, shift 0.0609; its text
    encoders CLIP-L, CLIP-G and T5-XXL in text_encoder, _2, _3) through
    from_pretrained at the default attn_impl ('auto': the flash kernel),
    hash tokenizers passed: the load, then one warm batch of 4 at 1024²
    from raw prompts through the pipeline (the triple stack's encode
    included), timed, with the kernel's launches counted; the same batch
    from its prompt_embeds, timed apart from the encode; one profiled;
    then CLIP-L and CLIP-G (and T5 at 256 tokens) in bf16 against fp32 and
    their batch-1 encode times."""
    import numpy as np

    from tdm_tpu_torch.data.tokenizer import HashTokenizer
    from tdm_tpu_torch.models import vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import from_pretrained, loading
    from tdm_tpu_torch.serve import batcher as B

    root, secs, n = sd3_checkout(workdir, seed)
    gc.collect()
    torch.cuda.empty_cache()
    toks = {"clip_l": HashTokenizer(CLIP_VOCAB, eos_id=CLIP_EOS),
            "clip_g": HashTokenizer(CLIP_VOCAB, eos_id=CLIP_EOS), "t5": HashTokenizer()}
    torch.cuda.reset_peak_memory_stats()
    with timed_calls(torch, load_targets() + [(loading, "_load_diffusers_text_encoders")]) \
            as times:
        pipe = from_pretrained(root, tokenizers=toks)
    load = load_report(times)
    enc_load_s = times["_load_diffusers_text_encoders"]
    check(pipe.family == "sd3" and pipe.transformer.cfg.attn_impl == "auto"
          and pipe.transformer.cfg.dtype == torch.bfloat16
          and isinstance(pipe.vae_decoder, vae.KLDecoder)
          and (pipe.vae_scaling, pipe.vae_shift, pipe.vae_range) == (1.5305, 0.0609, "pm1")
          and B.has_encoders(pipe) and pipe.tokenizers == toks
          and [pipe.text_encoders[k].cfg.projection_dim for k in ("clip_l", "clip_g")]
          == [768, 1280] and pipe.text_encoders["clip_g"].cfg.activation == "gelu",
          "the SD3 checkout's pipeline and its triple stack")
    enc_params = {k: encoder_params(m) for k, m in pipe.text_encoders.items()}
    print(f"[diffusers] SD3-Medium checkout loaded in {load['load_s']:.2f}s (safetensors "
          f"read {load['read_s']:.2f}s, conversion {load['convert_s']:.3f}s = "
          f"{load['convert_share']:.3f} of the load, modules and copy to the card "
          f"{load['build_and_copy_s']:.2f}s); of it the text encoders "
          f"({', '.join(f'{k} {v / 1e6:.1f}M' for k, v in enc_params.items())}) "
          f"{enc_load_s:.2f}s", flush=True)
    prompts = ENC_PROMPTS[:4]
    rng = np.random.default_rng(seed + 3)
    noise = torch.from_numpy(rng.standard_normal((4, 16, 128, 128)).astype(np.float32))
    call = dict(prompt=prompts, latents=noise, height=1024, width=1024)
    pipe(**call)  # warm
    torch.cuda.synchronize()
    # the main path: counts to 0, one batch of 4 from raw prompts, read just after
    A.reset_launches()
    t0 = time.monotonic()
    images = pipe(**call).images.cpu()
    raw_s = time.monotonic() - t0
    launches = A.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches["flash_attention_fwd"] == SD3_LAUNCHES_PER_BATCH
          and sum(launches.values()) == SD3_LAUNCHES_PER_BATCH,
          f"SD3 checkout batch launches {launches}, expected {SD3_LAUNCHES_PER_BATCH} "
          "flash_fwd and nothing else")
    check(tuple(images.shape) == (4, 1024, 1024, 3) and bool(torch.isfinite(images).all())
          and images.std().item() > 0.01, f"SD3 checkout images {tuple(images.shape)}")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    cond = pipe.encode_prompt(prompts)
    torch.cuda.synchronize()
    encode_s = time.monotonic() - t0
    check(tuple(cond[0].shape) == (4, SD3_TXT, 4096) and tuple(cond[1].shape) == (4, 2048)
          and not cond[0][:, :77, 768 + 1280:].any(),
          f"SD3 conditioning {tuple(cond[0].shape)}, {tuple(cond[1].shape)}")
    # the same batch from its prompt_embeds: its time without the encode
    t0 = time.monotonic()
    again = pipe(prompt_embeds=cond, latents=noise, height=1024, width=1024).images.cpu()
    batch_s = time.monotonic() - t0
    raw_vs_embeds = (again - images).abs().max().item()
    print(f"[diffusers] SD3 checkout: one batch of 4 at 1024² from prompt_embeds in "
          f"{batch_s:.3f}s ({4 / batch_s:.2f} images/s); from raw prompts {raw_s:.3f}s (the "
          f"triple stack's batch-4 encode alone {encode_s:.3f}s); the two batches' images "
          f"differ by {raw_vs_embeds:.3e} at most; images finite (std "
          f"{images.std().item():.3f}); launches {launches}; peak device memory "
          f"{peak_gib:.2f} GiB with the encoders resident", flush=True)
    prof = profile_batch(torch, pipe, cond, noise)
    per_call = prof["attention_ms"] / SD3_LAUNCHES_PER_BATCH if prof else None
    if per_call is not None:
        print(f"[diffusers] SD3 checkout: flash_fwd {per_call:.3f} ms per call at "
              f"[4,24,{SD3_S},{SD3_S},64] in the profiled batch", flush=True)
    decode = decode_alone(torch, pipe, (4, 16, 128, 128), seed)
    ids_clip, _ = toks["clip_l"](prompts, max_length=pipe.max_clip_len)
    ids_t5, mask_t5 = toks["t5"](prompts, max_length=pipe.max_t5_len)
    encoders = {
        "clip_l": encoder_report(torch, "CLIP-L (SD3, projected)", pipe.text_encoders["clip_l"],
                                 ids_clip, outputs=clip_outputs(True)),
        "clip_g": encoder_report(torch, "CLIP-G (SD3, projected)", pipe.text_encoders["clip_g"],
                                 ids_clip, outputs=clip_outputs(True)),
        "t5": encoder_report(torch, "T5-XXL (SD3, 256 tokens)", pipe.text_encoders["t5"],
                             ids_t5, mask_t5, against_fp32=False),
    }
    stack_ms = sum(e["ms"] for e in encoders.values())
    if prof:
        prof["encode_share"] = stack_ms / (prof["busy_ms"] + stack_ms)
        print(f"[diffusers] SD3: the triple stack's batch-1 encodes {stack_ms:.3f} ms against "
              f"the profiled batch's {prof['busy_ms']:.1f} ms busy (one batch-4 encode per "
              f"pipeline call; per request in the server: 4 x {stack_ms:.3f} ms)", flush=True)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    # train_sd3 reads only transformer/; the T5 is written again for CogVideoX
    release_encoder(torch, workdir, seed, "t5", os.path.join(root, "text_encoder_3"))
    return {"load": load, "checkout_write_s": secs, "decode": decode, "params": n,
            "batch_s": batch_s, "images_per_s": 4 / batch_s, "raw_batch_s": raw_s,
            "encode_batch4_s": encode_s, "raw_vs_embeds_max_abs": raw_vs_embeds,
            "launches": launches["flash_attention_fwd"],
            "launches_per_batch": SD3_LAUNCHES_PER_BATCH, "profile": prof,
            "flash_fwd_ms_per_call": per_call, "peak_gib": peak_gib,
            "encoders_load_s": enc_load_s, "encoders": encoders}


def phase_diffusers(torch, seed: int, workdir: str) -> dict:
    """Stock diffusers checkouts at full width: the KL decoder on the card
    against the CPU, PixArt-α-512 served over HTTP from its checkout, and
    SD3-Medium at 1024² from its checkout through the pipeline."""
    return {"kl_check": kl_decoder_check(torch, seed),
            "pixart": diffusers_pixart(torch, seed, workdir),
            "sd3": diffusers_sd3(torch, seed, workdir)}


# ---------------------------------------------------------------------------
# SD1.5 / Dreamshaper served from a diffusers checkout
# ---------------------------------------------------------------------------


def sd15_reference(torch, seed: int, workdir: str) -> dict:
    """A small SD1.5 pipeline whose levels run at head dims 80 and 160 (one
    head over widths 80/160), fp32, with a merged kohya LoRA on its
    attention projections, on the card (kernel 1's fp32 path) against the
    same pipeline on the CPU (the plain version): the sampler state is bf16
    in both, so the latents agree to one bf16 ulp of their scale and the
    images to half a PNG step."""
    import dataclasses

    import numpy as np

    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import unet_sd15, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import SD15Pipeline

    torch.manual_seed(seed)
    cfg = dataclasses.replace(unet_sd15.UNetConfig.tiny(), block_widths=(80, 160), num_heads=1)
    pipes = [SD15Pipeline(unet_sd15.UNet2DCondition(cfg, device=dev),
                          vae_decoder=vae.KLDecoder(vae.KLVAEConfig.tiny(), device=dev),
                          device=dev) for dev in ("cpu", "cuda")]
    cpu, gpu = pipes
    gpu.unet.load_state_dict(cpu.unet.state_dict())
    gpu.vae_decoder.load_state_dict(cpu.vae_decoder.state_dict())
    lora_file = os.path.join(workdir, "tiny_sd15_lora.safetensors")
    lora_io.save_kohya(sd15_lora(torch, cpu.unet, 4, seed), lora_file)
    for pipe in pipes:
        pipe.load_lora_weights(lora_file, adapter_name="tdm")
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((3, SD15_TXT, cfg.context_dim)).astype(np.float32)
    mask = (np.arange(SD15_TXT)[None] < np.array([[77], [9], [0]])).astype(np.int32)
    kw = dict(prompt_embeds=(ctx, mask), latents=lat, height=128, width=128)
    ref = cpu(**kw)
    before = A.launch_counts()
    got = gpu(**kw)
    torch.cuda.synchronize()
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:  # a check, not the main path
        w.launches = before[w.__name__]
    dl = (got.latents.float().cpu() - ref.latents.float()).abs()
    scale = ref.latents.float().abs().max().item()
    di = (got.images.cpu() - ref.images).abs().max().item()
    print(f"[sd15] small SD1.5 pipeline (head dims 80/160, fp32, LoRA) cuda (kernel 1, "
          f"{launched['flash_attention_fwd']} launches) vs cpu (plain): latents max_abs_err "
          f"{dl.max().item():.3e} of scale {scale:.3g}, {(dl > 0).float().mean().item():.4f} of "
          f"elements differ; images max_abs_err {di:.3e}", flush=True)
    check(launched["flash_attention_fwd"] == 4 * 2 * 4 and sum(launched.values()) == 4 * 2 * 4,
          f"small SD1.5 pipeline launches {launched}")
    check(dl.max().item() <= 2**-7 * scale, "small SD1.5 latents disagree")
    check((dl > 0).float().mean().item() < 0.01, "small SD1.5 latents disagree")
    check(di <= 2e-3, "small SD1.5 images disagree")
    return {"latents_max_abs_err": dl.max().item(), "images_max_abs_err": di}


def sd15_lora(torch, unet, rank: int, seed: int):
    """A LoRA of `rank` on the UNet's attention projections (to_q, to_k,
    to_v, to_out of every self and cross attention), both factors drawn
    from the seed."""
    from tdm_tpu_torch.lora import adapter

    gen = torch.Generator().manual_seed(seed)
    lora = adapter.init_lora(
        unet, rank, generator=gen,
        target=lambda path, shape: path[-1] in ("to_q", "to_k", "to_v", "to_out"))
    for entry in lora.params.values():
        entry["b"] = 0.02 * torch.randn(entry["b"].shape, generator=gen)
    return lora


def sd15_checkout(torch, workdir: str, seed: int) -> tuple[str, float, int]:
    """The SD1.5 checkout (the UNet at widths 320/640/1280/1280, 2 layers a
    block, 8 heads, context 768, GroupNorm 32; the 4-channel AutoencoderKL
    [128, 256, 512, 512], scaling 0.18215) as `StableDiffusionPipeline`
    ships it: model_index.json, unet/ and vae/, each a config.json and one
    fp16 safetensors file of seeded weights in the released key layout,
    written once per run. Returns (its root, the seconds and parameters of
    the write, 0 when it was there)."""
    from tdm_tpu_torch.models import unet_sd15, vae

    cfg, vcfg = unet_sd15.UNetConfig(), vae.KLVAEConfig()
    check((tuple(cfg.block_widths), cfg.layers_per_block, cfg.num_heads, cfg.context_dim,
           cfg.norm_groups, cfg.dtype, tuple(vcfg.block_widths), vcfg.scaling_factor)
          == ((320, 640, 1280, 1280), 2, 8, 768, 32, torch.bfloat16, (128, 256, 512, 512),
              0.18215), "SD1.5 and its VAE")
    root = os.path.join(workdir, "stable-diffusion-v1-5")
    if os.path.exists(os.path.join(root, "model_index.json")):
        return root, 0.0, 0
    secs, n = write_checkout(root, "unet_sd15", cfg, vcfg, seed)
    link_encoder(seeded_encoders(torch, workdir, seed, ["clip_l"])["clip_l"][0],
                 os.path.join(root, "text_encoder"))
    print(f"[checkout] wrote the SD1.5 diffusers checkout ({n / 1e6:.1f}M params at fp16) "
          f"in {secs:.1f}s, its text_encoder (CLIP-L) hardlinked", flush=True)
    return root, secs, n


def sd15_cache(workdir: str, seed: int) -> tuple[str, list]:
    """An embedding cache of 8 prompts: CLIP-L last hidden states [77, 768]
    with every token live, as SD1.5's UNet attends them."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache

    prompts = [f"sd15 prompt {i}" for i in range(8)]
    cache = os.path.join(workdir, "clip_cache.npz")
    rng = np.random.default_rng(seed + 5)
    EmbeddingCache(rng.standard_normal((8, SD15_TXT, 768)).astype(np.float16),
                   np.ones((8, SD15_TXT), np.int32), prompts).save(cache)
    return cache, prompts


def sd15_forward_check(torch, unet, seed: int) -> float:
    """One full-width UNet forward at 512², batch 4, with kernel 1 against
    the same forward with the plain attention, both on the card: bf16
    through 16 transformers and 22 ResBlocks, so the check is relative (L2
    error under 2%)."""
    import numpy as np

    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 7)
    lat = torch.from_numpy(rng.standard_normal((4, 4, 64, 64)).astype(np.float32)).cuda()
    ctx = torch.from_numpy(rng.standard_normal((4, SD15_TXT, 768)).astype(np.float32)).cuda()
    mask = torch.ones(4, SD15_TXT, dtype=torch.int32, device="cuda")
    t = torch.tensor([999, 749, 500, 250], device="cuda")
    before = A.launch_counts()
    with torch.inference_mode():
        out = unet(lat, t, ctx, mask).float()
        with forced_attention("plain"):
            ref = unet(lat, t, ctx, mask).float()
    for w in A.WRAPPERS:  # a check, not the main path
        w.launches = before[w.__name__]
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[sd15] full-width UNet forward, kernel vs plain attention: rel L2 {rel:.3e}, "
          f"finite {bool(torch.isfinite(out).all())}", flush=True)
    check(bool(torch.isfinite(out).all()) and rel < 2e-2,
          f"full-width UNet forward disagrees: rel L2 {rel}")
    return rel


@contextlib.contextmanager
def timed_kl_decode(torch, out: list):
    """Every KLDecoder forward timed by CUDA events (ms appended to `out`)."""
    from tdm_tpu_torch.models import vae

    fwd = vae.KLDecoder.forward

    def timed(self, z):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        y = fwd(self, z)
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
        return y

    vae.KLDecoder.forward = timed
    try:
        yield out
    finally:
        vae.KLDecoder.forward = fwd


# `python -m tdm_tpu_torch.serve.server` as run_module runs it, with the KL
# decoder's forward timed by CUDA events (one stderr line per decode, with
# the cuDNN TF32 flag the server left)
SERVER_WITH_DECODE_TIMES = """
import runpy, sys, torch
from tdm_tpu_torch.models import vae
fwd = vae.KLDecoder.forward
def timed(self, z):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record(); y = fwd(self, z); ev[1].record(); torch.cuda.synchronize()
    print(f"decode_ms {ev[0].elapsed_time(ev[1])} cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr, flush=True)
    return y
vae.KLDecoder.forward = timed
sys.argv = ["tdm_tpu_torch.serve.server", *sys.argv[1:]]
runpy.run_module("tdm_tpu_torch.serve.server", run_name="__main__", alter_sys=True)
"""


def subprocess_server_check(torch, server_args: list, prompt: str, seed: int,
                            want_png: str) -> dict:
    """The server's own process (`python -m tdm_tpu_torch.serve.server`,
    which sets the fp32 precision itself, TF32 off) answers one request
    with the PNG bytes that the in-process server (the smoke's own TF32-off
    settings) gave the same (prompt, seed); its decode times and the flags
    it ran under come back on stderr. The process is stopped with SIGTERM
    (the server's graceful path) and waited for."""
    import signal
    import urllib.request

    here = os.path.dirname(os.path.abspath(__file__))
    log = os.path.join(os.path.dirname(server_args[server_args.index("--model") + 1]),
                       "server_subprocess.log")
    t0 = time.monotonic()
    with open(log, "w") as errf:
        proc = subprocess.Popen([sys.executable, "-c", SERVER_WITH_DECODE_TIMES, *server_args],
                                cwd=here, stdout=subprocess.PIPE, stderr=errf, text=True)
    try:
        port = None
        for line in proc.stdout:
            m = re.search(r"at http://[^:]+:(\d+) ", line)
            if m:
                port = int(m.group(1))
                break
        check(port is not None, "the server subprocess never said where it listens")
        up_s = time.monotonic() - t0
        body = json.dumps({"prompt": prompt, "seed": seed}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            reply = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    with open(log) as f:
        err = f.read()
    decodes = [float(m.group(1)) for m in re.finditer(r"decode_ms ([0-9.]+)", err)]
    flags = re.findall(r"cudnn.allow_tf32 (\w+) matmul.allow_tf32 (\w+)", err)
    check(bool(decodes) and all(f == ("False", "False") for f in flags),
          f"the server subprocess's decodes {decodes} under TF32 flags {flags}")
    check(reply.get("image") == want_png,
          "the server subprocess gave other PNG bytes than the in-process server")
    return {"up_s": up_s, "decode_ms": decodes[-1], "decodes": len(decodes),
            "tf32": False, "png_equal": True}


def raw_prompt_batch(torch, root: str, family: str, tokenizer, call: dict, want: int,
                     report, warm: bool = True) -> dict:
    """The checkout at `root` through from_pretrained with `tokenizer`
    passed (the card's machine has no `transformers` for a tokenizer
    folder): its text_encoder/ loaded (timed), one batch from raw prompts
    with kernel 1's launches counted (`want`, and nothing else), the
    largest device memory of load and batch, and `report(pipe)`, the
    encoder's own checks."""
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import from_pretrained, loading
    from tdm_tpu_torch.serve import batcher as B

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with timed_calls(torch, [(loading, "_load_diffusers_text_encoders")]) as times:
        pipe = from_pretrained(root, tokenizer=tokenizer)
    load_s = time.monotonic() - t0
    check(pipe.family == family and B.has_encoders(pipe) and pipe.tokenizer is tokenizer,
          f"the {family} checkout's text encoder")
    with torch.inference_mode():
        if warm:
            pipe(**call)
            torch.cuda.synchronize()
        A.reset_launches()
        t0 = time.monotonic()
        out = pipe(**call)
        result = (out.images if out.images is not None else out.latents).float().cpu()
        batch_s = time.monotonic() - t0
    launches = A.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches["flash_attention_fwd"] == want and sum(launches.values()) == want,
          f"{family} raw-prompt batch launches {launches}, expected {want} flash_fwd")
    check(bool(torch.isfinite(result).all()) and result.std().item() > 0.01,
          f"{family} raw-prompt batch output {tuple(result.shape)}")
    enc_s = times["_load_diffusers_text_encoders"]
    print(f"[{family}] from_pretrained(<checkout>, tokenizer=HashTokenizer) in {load_s:.2f}s "
          f"(text encoder {encoder_params(pipe.text_encoder) / 1e6:.1f}M params, "
          f"{enc_s:.2f}s); one {'warm ' if warm else 'first '}batch of "
          f"{len(call['prompt'])} raw prompts in {batch_s:.3f}s, "
          f"output {tuple(result.shape)} finite; launches {launches}; peak device memory "
          f"{peak_gib:.2f} GiB", flush=True)
    rep = report(pipe)
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"load_s": load_s, "encoder_load_s": enc_s, "batch_s": batch_s,
            "launches": launches["flash_attention_fwd"], "peak_gib": peak_gib, "encoder": rep}


def phase_sd15(torch, seed: int, workdir: str) -> dict:
    """SD1.5 served over HTTP from a full-width diffusers checkout with a
    rank-64 kohya LoRA merged at load: 8 concurrent requests (two batches
    of 4) and one alone, PNGs that are not constant, per-seed determinism,
    kernel 1's launches per batch (128, 48 at head dim 160, and nothing
    else), a profiled batch, the KL decode alone, and one full-width forward
    against plain attention."""
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    import numpy as np

    from tdm_tpu_torch.data.tokenizer import HashTokenizer
    from tdm_tpu_torch.io import convert
    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import unet_sd15, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.serve import server as S

    torch.cuda.empty_cache()
    reference = sd15_reference(torch, seed, workdir)
    root, write_s, n_params = sd15_checkout(torch, workdir, seed)
    cache, prompts = sd15_cache(workdir, seed)
    lora_file = os.path.join(workdir, "sd15_tdm_lora.safetensors")
    lora = sd15_lora(torch, unet_sd15.UNet2DCondition(device="meta"), 64, seed)
    lora_io.save_kohya(lora, lora_file)
    t0 = time.monotonic()
    args_list = ["--model", cache_served_view(root), "--lora", lora_file, "--embedding_cache",
                 cache, "--port",
                 "0", "--batch_size", "4", "--max_delay_ms", "1000", "--warmup"]
    args = S.parse_args(args_list)
    with timed_calls(torch, load_targets() + [(convert, "unet_sd15_params")]) as times:
        server = S.build_server(args).start()
    up_s = time.monotonic() - t0
    load = load_report(times)
    stats, pipe = server.batcher.stats, server.batcher.pipe
    check(pipe.family == "sd15" and pipe.unet.cfg == unet_sd15.UNetConfig()
          and isinstance(pipe.vae_decoder, vae.KLDecoder) and pipe.vae_range == "pm1"
          and pipe.vae_scaling == 0.18215 and pipe.vae_decoder.cfg.dtype == torch.float32
          and pipe._active == (("tdm", 1.0),) and pipe.text_encoder is None,
          "the served SD1.5 checkout (its cache-served view: no encoder)")
    print(f"[sd15] SD1.5 checkout with a rank-64 LoRA ({len(lora.params)} projections) loaded "
          f"in {load['load_s']:.2f}s (safetensors read {load['read_s']:.2f}s, conversion "
          f"{load['convert_s']:.3f}s, modules and copy to the card "
          f"{load['build_and_copy_s']:.2f}s); server up and warm in {up_s:.1f}s (warm-up "
          f"batch {stats.last_batch_latency_s:.3f}s)", flush=True)

    def post(prompt, seed):
        body = json.dumps({"prompt": prompt, "seed": seed}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        t = time.monotonic()
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, time.monotonic() - t

    try:
        # the main path: counts to 0, 8 concurrent requests, then one alone
        A.reset_launches()
        b0, pad0 = stats.batches, stats.rows_padded
        t0 = time.monotonic()
        with ThreadPoolExecutor(8) as ex:
            replies = list(ex.map(lambda i: post(prompts[i], 500 + i), range(8)))
        wall8 = time.monotonic() - t0
        batches8 = stats.batches - b0
        full_batch_s = stats.last_batch_latency_s
        with timed_kl_decode(torch, []) as solo_decode_ms:
            solo, solo_s = post(prompts[0], 500)
        launches = A.launch_counts()
        batches = stats.batches - b0
    finally:
        server.close()
    stds, pixels = [], []
    for reply, _ in replies + [(solo, solo_s)]:
        check(reply.get("format") == "png" and reply.get("shape") == [512, 512, 3],
              f"reply {str(reply)[:200]}")
        pixels.append(check_png(base64.b64decode(reply["image"]), 512, 512).astype(np.int16))
        stds.append(float(pixels[-1].std()))
    solo_diff = np.abs(pixels[-1] - pixels[0])
    check(min(stds) > 1.0, f"a served image is (nearly) constant: pixel std {min(stds)}")
    check(batches8 == 2 and stats.rows_padded - pad0 == 3,
          f"8 requests ran as {batches8} batches")
    check(solo["image"] == replies[0][0]["image"],
          f"same (prompt, seed) gave different bytes in another batch: "
          f"{int((solo_diff > 0).sum())} of {solo_diff.size} pixel values differ, by at most "
          f"{int(solo_diff.max())}")
    check(len({r["image"] for r, _ in replies}) == 8, "distinct seeds gave equal images")
    check(launches["flash_attention_fwd"] == SD15_LAUNCHES_PER_BATCH * batches
          and sum(launches.values()) == launches["flash_attention_fwd"],
          f"launches {launches} over {batches} batches, expected "
          f"{SD15_LAUNCHES_PER_BATCH} flash_fwd and nothing else per batch")
    lat = [t for _, t in replies]
    print(f"[sd15] 8 concurrent requests in {wall8:.3f}s as {batches8} batches of 4 "
          f"({8 / wall8:.2f} images/s), request latency {min(lat):.3f}-{max(lat):.3f}s, "
          f"last full batch {full_batch_s:.3f}s; lone request {solo_s:.3f}s; same (prompt, "
          f"seed) -> same PNG bytes; pixel std {min(stds):.1f}-{max(stds):.1f}; launches "
          f"{launches} = {SD15_LAUNCHES_PER_BATCH} flash_fwd x {batches} batches", flush=True)
    cond = tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[1]))
    noise = torch.randn(4, 4, 64, 64)
    with torch.inference_mode():
        images = pipe(prompt_embeds=cond, latents=noise).images.cpu()
    check(tuple(images.shape) == (4, 512, 512, 3) and bool(torch.isfinite(images).all())
          and images.std().item() > 0.01, f"SD1.5 images {tuple(images.shape)}")
    torch.cuda.reset_peak_memory_stats()
    prof = profile_batch(torch, pipe, cond, noise)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_dim = {dp: sum(c for k, c in prof.get("kernel_launches", {}).items()
                      if f"flash_fwd_sm90_kernel<{dp}," in k) for dp in (64, 80, 160)}
    if prof:
        check(sum(prof["kernel_launches"].values()) == SD15_LAUNCHES_PER_BATCH
              and by_dim[160] == SD15_D160_PER_BATCH and by_dim[64] == by_dim[80] == 40,
              f"profiled SD1.5 batch: kernel 1 launches {prof['kernel_launches']}")
        print(f"[sd15] profiled batch: kernel 1 launches by padded head dim {by_dim} "
              f"(D 40 reads DP 64); peak device memory {peak_gb:.2f} GB", flush=True)
    decode = decode_alone(torch, pipe, (4, 4, 64, 64), seed)
    rel = sd15_forward_check(torch, pipe.unet, seed)
    gated = reckon_gated(torch, unet_sd15.UNet2DCondition(device="meta"), (4, 4, 64, 64), (4,),
                         (4, SD15_TXT, 768), (4, SD15_TXT), int_arg=3)[1]
    int8 = int8_serving(
        torch, "sd15", pipe, cond, noise,
        tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[2])),
        torch.randn(4, 4, 64, 64), gated_per_forward=gated, forwards=4,
        wrapper="flash_attention_fwd")
    server.batcher.pipe = None
    del pipe
    torch.cuda.empty_cache()
    sub = subprocess_server_check(torch, args_list, prompts[0], 500, solo["image"])
    sub["in_process_decode_ms"] = solo_decode_ms[-1]
    print(f"[sd15] `python -m tdm_tpu_torch.serve.server` in a subprocess (TF32 off, set by "
          f"the server): up and warm in {sub['up_s']:.1f}s, the lone request's PNG bytes equal "
          f"the in-process server's; KL decode of its batch of 4 {sub['decode_ms']:.2f} ms "
          f"there, {sub['in_process_decode_ms']:.2f} ms in-process (CUDA events)", flush=True)
    tok = HashTokenizer(CLIP_VOCAB, eos_id=CLIP_EOS)

    def clip_report(p):
        ids, _ = tok(ENC_PROMPTS[:4], max_length=p.max_text_len)
        return encoder_report(torch, "CLIP-L (SD1.5, last state)", p.text_encoder, ids,
                              outputs=clip_outputs(False))

    raw = raw_prompt_batch(torch, root, "sd15", tok,
                           dict(prompt=ENC_PROMPTS[:4], latents=torch.randn(4, 4, 64, 64)),
                           SD15_LAUNCHES_PER_BATCH, clip_report)
    evaluated = evaluate_runs(torch, cache_served_view(root), lora_file, workdir, seed)
    return {"int8": int8, "evaluate": evaluated,
            "raw_prompts": raw, "reference": reference, "load": load, "up_s": up_s, "checkout_write_s": write_s,
            "subprocess_server": sub,
            "params": n_params, "lora_projections": len(lora.params),
            "launches": launches["flash_attention_fwd"], "batches": batches,
            "launches_per_batch": SD15_LAUNCHES_PER_BATCH, "launches_by_head_dim": by_dim,
            "wall8_s": wall8, "images_per_s": 8 / wall8, "batch_s": full_batch_s,
            "solo_s": solo_s, "profile": prof, "peak_gb": peak_gb, "decode": decode,
            "forward_rel_l2": rel}


TRAIN_STEPS = 3
# per step at batch 4, dmd, cfg 4.5, critic_updates 1: 7 forwards without
# grad (rollout x4, x0_gen_sg, teacher CFG probe at 2B, critic probe) and 2
# with grad (critic DSM, student loss), each 28 blocks x (self, cross)
TRAIN_LAUNCHES = {"flash_attention_fwd": 392, "flash_attention_fwd_lse": 112,
                  "flash_attention_bwd_dq": 112, "flash_attention_bwd_dkv": 112,
                  "splash_attention_fwd": 0}
# the train_lora phase: rank-32 LoRA student, 8-bit Adam, 2 micro-steps per
# optimizer step, 2 optimizer steps
LORA_RANK, LORA_ACCUM, LORA_STEPS = 32, 2, 2
# the export's rank-32 reconstruction of one ΔW against float64's optimum
# (train_sd15: the train phase exports no LoRA, for the clock)
EXPORT_TOL = 1e-3
SD15_EXPORT_PATH = "down_0_attn_0/transformer_blocks_0/attn1/to_q"


def train_env(seed: int, workdir: str) -> None:
    """The cache the port's build_cache wrote from the PixArt bundle's
    T5-XXL (`built_cache`: 8 prompts of 120 tokens at 4096 with their
    ragged masks, the one-token empty prompt, the CLI's validation rows) as
    $TDM_EMBEDDING_CACHE, and the full-size model (no $TDM_TINY_MODEL, no
    validation decoder)."""
    cache = built_cache(seed, workdir)
    for var in ("TDM_TINY_MODEL", "TDM_TAESD_DIR"):
        os.environ.pop(var, None)
    os.environ["TDM_EMBEDDING_CACHE"] = cache


def count_device_work(torch, fn) -> tuple:
    """(result, device work items launched, their device ms) of one call
    of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return out, sum(e.count for e in kern), sum(e.device_time_total for e in kern) / 1e3


def step_hook(torch, records: list, profile_at: int, tag: str, after=None, profiled=None):
    """A `step_hook` for train_tdm.main: each call (a micro-step) timed by
    the host clock and CUDA events, its kernels' launches counted, the
    `profile_at`-th call under torch.profiler (device busy time, every
    device launch, the top kernels, from the card's activity; with
    `profiled(prof, rec)`, which reads the profile, the CPU's ops too),
    and its int8 products (`int8_dot`'s count); `after(rec, state)` sees
    each call's record and state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tdm_tpu_torch.ops import attention as A, quant

    def hook(step, run):
        n = len(records) + 1
        before = A.launch_counts()
        q8_before = quant.int8_dot.launches
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # the card's activity alone unless `profiled` reads the CPU ops: the
        # profile's own processing grows with its events (tens of
        # thousands of ops a step)
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if profiled else [])
        prof = profile(activities=activities) if n == profile_at else None
        if prof is not None:
            prof.__enter__()
        t0 = time.monotonic()
        ev0.record()
        state, metrics = run()
        ev1.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        rec = {"step": step, "micro": n, "host_s": wall, "event_ms": ev0.elapsed_time(ev1),
               "busy_ms": None,
               "launches": {k: A.launch_counts()[k] - before[k] for k in before},
               "int8_products": quant.int8_dot.launches - q8_before,
               "metrics": {k: float(v) for k, v in metrics._asdict().items()}}
        if prof is not None:
            prof.__exit__(None, None, None)
            kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            rec["busy_ms"] = sum(e.device_time_total for e in kern) / 1e3
            rec["all_launches"] = sum(e.count for e in kern)
            flash = [e for e in kern if "flash_" in e.key]
            rec["flash_kernels"] = {e.key: e.count for e in flash}
            top = sorted(kern, key=lambda e: -e.device_time_total)[:10]
            for e in top + [e for e in flash if e not in top]:
                print(f"[profile]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<6d} "
                      f"{e.key[:90]}", flush=True)
            print(f"[profile] {tag} micro-step {n}: device busy {rec['busy_ms']:.1f} ms, "
                  f"the flash kernels {sum(e.device_time_total for e in flash) / 1e3:.1f} "
                  f"ms, {rec['all_launches']} device launches", flush=True)
            if profiled is not None:
                profiled(prof, rec)
        if after is not None:
            after(rec, state)
        records.append(rec)
        print(f"[{tag}] step {step} (micro-step {n}): host {wall:.3f}s, CUDA events "
              f"{rec['event_ms']:.1f} ms, launches {rec['launches']}, {rec['metrics']}",
              flush=True)
        return state, metrics

    return hook


@contextlib.contextmanager
def no_final_checkpoint():
    """train_tdm.main() without its final checkpoint (CheckpointManager.save
    a no-op): the `train_lora` phase writes and times the checkpoint path;
    the other train phases' 10–21 GB of the same writes cost the smoke's
    clock a minute or more each and check nothing."""
    from tdm_tpu_torch.utils import checkpoint as ckpt_lib

    save = ckpt_lib.CheckpointManager.save
    ckpt_lib.CheckpointManager.save = lambda self, step, state: ""
    try:
        yield
    finally:
        ckpt_lib.CheckpointManager.save = save


@contextlib.contextmanager
def no_student_export():
    """train_tdm.main() without its fp16 `student.safetensors`
    (`train_tdm.write_student` a no-op): the train phase writes and sizes
    PixArt's; the later families' (1.7-2.0 B parameters re-stacked on the
    host, cast and written) cost the clock and check nothing; their LoRA
    files are still written and read back."""
    from tdm_tpu_torch.cli import train_tdm

    write = train_tdm.write_student
    train_tdm.write_student = lambda params, stacks, out_dir: None
    try:
        yield
    finally:
        train_tdm.write_student = write


def check_train_records(records: list, n: int) -> None:
    check(len(records) == n, f"{len(records)} micro-steps ran, expected {n}")
    for rec in records:
        check(rec["launches"] == TRAIN_LAUNCHES,
              f"micro-step {rec['micro']} launches {rec['launches']}, expected {TRAIN_LAUNCHES}")
        check(all(math.isfinite(v) for v in rec["metrics"].values()),
              f"micro-step {rec['micro']}: non-finite metrics {rec['metrics']}")


def kohya_pieces(torch, path: str, rank: int) -> int:
    """The adapted (kernel, layer) pairs of a kohya file, checking that each
    has its three keys and rank-`rank` factors."""
    from tdm_tpu_torch.io import params as params_io

    flat = params_io.load_file(path)
    downs = [k for k in flat if k.endswith(".lora_down.weight")]
    for k in downs:
        up = k.replace(".lora_down.", ".lora_up.")
        check(up in flat and k.replace(".lora_down.weight", ".alpha") in flat,
              f"{path}: {k} lacks its up factor or alpha")
        check(flat[k].shape[0] == rank and flat[up].shape[1] == rank,
              f"{path}: {k} has rank {flat[k].shape[0]}, expected {rank}")
    check(len(flat) == 3 * len(downs), f"{path}: {len(flat)} keys for {len(downs)} pieces")
    return len(downs)


def phase_train(torch, seed: int, workdir: str, moe_ranks: bool = False,
                meanwhile=None) -> dict:
    """Full-width PixArt-α-512 TDM training through the CLI's main() at the
    JAX CLI's default flags but --export_lora_rank 0 (the rank-32 SVD export,
    ~22 s here, is held and timed in train_sd15), the teacher read from the
    PixArt checkout's transformer/ folder (--pretrained_model_name_or_path;
    its load timed by part): seeded weights, the embedding cache the port's
    build_cache wrote from the PixArt bundle's T5-XXL (`train_env`), batch
    4, bf16, dmd, 3 steps, inside a world of one process over NCCL
    (`nccl_world_1`; no collective, counted). Per step: host and
    CUDA-event times and the kernels' launches (checked); step 3 under
    torch.profiler for device busy time. No final checkpoint
    (`no_final_checkpoint`): the train_lora phase writes and times the
    checkpoint path. Then, in the NCCL world, the data-parallel check's
    one-process reference (`dp_reference`) and the collectives over its
    gradients (`nccl_collectives_check`); the --quant_forwards run; and the
    two data-parallel ranks (`dp_ranks`), which with `moe_ranks` then take
    the --ep 2 step against `moe_ep_reference`'s; `meanwhile` runs in this
    process while they do (`dp_ranks`)."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.ops import attention as A

    teacher_dir = os.path.join(pixart_checkout(workdir, seed), "transformer")
    train_env(seed, workdir)
    held = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] device memory allocated before the phase {held:.2f} GiB, after a "
          f"collection {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    out = os.path.join(workdir, "train")
    steps = []
    watch = ("blocks.0.attn1.to_q.weight", "blocks.0.ff.proj_out.weight", "proj_out.weight")
    snap = {}

    def after(rec, state):
        if rec["micro"] == 1:
            snap.update({k: state.student[k].clone() for k in watch})
        if rec["micro"] == 2:
            rec["student_changed"] = all(
                bool((state.student[k] != snap[k]).any()) for k in watch)

    ref_path = os.path.join(workdir, "dp_reference.pt")
    # main() in a world of one process over NCCL (formed from torchrun's
    # variables): the step is the one-process step, no collective and the
    # same launches; then the one-process reference of the 2-rank check,
    # whose gradients go through the NCCL collectives
    with nccl_world_1(torch):
        A.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        # the teacher's load: the directory's read, the conversion, the carry
        # and the copy into the module on the card (nothing else in the run loads)
        load_parts = teacher_load_parts("pixart_params")
        with timed_calls(torch, load_parts) as teacher_times, no_final_checkpoint(), \
                counted_collectives(torch) as collectives:
            train_tdm.main([
                "--output_dir", out, "--max_train_steps", str(TRAIN_STEPS),
                "--train_batch_size", "4", "--mixed_precision", "bf16", "--loss_mode",
                "dmd", "--seed", str(seed), "--pretrained_model_name_or_path", teacher_dir,
                "--export_lora_rank", "0", "--tp", "1",
            ], step_hook=step_hook(torch, steps, TRAIN_STEPS, "train", after))
        total_s = time.monotonic() - t0
        launches = A.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        check(not collectives, f"main() in a world of one made collectives: {collectives}")
        gc.collect()
        torch.cuda.empty_cache()
        reference = dp_reference(torch, seed, teacher_dir, ref_path)
        nccl = nccl_collectives_check(torch, reference.pop("critic_grads"))
    gc.collect()
    torch.cuda.empty_cache()
    check(set(teacher_times) == {name for _, name in load_parts},
          f"the teacher was not loaded from {teacher_dir}: {teacher_times}")
    teacher_s, parts = teacher_load_report(teacher_times, "pixart_params")
    print(f"[train] teacher from {teacher_dir}: loaded in {teacher_s:.2f}s ({parts})",
          flush=True)
    run_dir = out + "_cfg4.5_steps900"
    student_gb = os.path.getsize(os.path.join(run_dir, "student.safetensors")) / 1e9
    check_train_records(steps, TRAIN_STEPS)
    check(steps[1]["student_changed"], "the student did not change in step 2")
    check(not os.path.exists(os.path.join(run_dir, "tdm_lora.safetensors")),
          "--export_lora_rank 0 wrote a LoRA")
    shutil.rmtree(run_dir, ignore_errors=True)  # the disk for the later phases
    # steps after the first that ran without the profiler (its own cost
    # inflates the profiled last step's wall time)
    plain = [r["host_s"] for r in steps[1:] if r["busy_ms"] is None]
    per_step = sum(plain) / len(plain)
    qf = quant_forwards_run(torch, seed, workdir, teacher_dir, per_step)
    moe_ref = None
    if moe_ranks:
        moe_path = os.path.join(workdir, "moe_ep_reference.pt")
        moe_ref = {**moe_ep_reference(torch, seed, moe_path), "path": moe_path}
    dp = dp_ranks(torch, seed, workdir, teacher_dir, ref_path, reference, moe_ref, meanwhile)
    busy = steps[-1]["busy_ms"]
    span = steps[1]["event_ms"]
    idle = None if not busy else 1 - busy / span
    print(f"[train] PixArt-α-512 TDM (dmd, batch 4, bf16, seeded weights): "
          f"{per_step:.3f} s/step after the first, unprofiled ({3600 / per_step:.0f} "
          f"iters/hour), first step {steps[0]['host_s']:.3f} s, profiled step "
          f"{steps[-1]['host_s']:.3f} s, peak memory {peak_gb:.2f} GiB; "
          f"launches per step {TRAIN_LAUNCHES} (checked); step 2 CUDA-event span "
          f"{span:.1f} ms, step 3 device busy "
          + (f"{busy:.1f} ms -> idle share {idle:.3f}" if busy else "not measured")
          + f"; main() {total_s:.1f}s incl. a {student_gb:.2f} GB fp16 student, no LoRA "
          "export (train_sd15 times it), no final checkpoint; main() ran with --tp 1 in an "
          "NCCL world of one and made no collective (checked)", flush=True)
    return {"s_per_step": per_step, "iters_per_hour": 3600 / per_step,
            "teacher_load_s": teacher_s, "teacher_load": teacher_times,
            "first_step_s": steps[0]["host_s"], "peak_gib": peak_gb,
            "idle_share": idle, "busy_ms": busy, "event_span_ms": span,
            "launches": launches, "launches_per_step": TRAIN_LAUNCHES,
            "all_launches_per_step": steps[-1].get("all_launches"),
            "checkpoint_gb": None, "main_s": total_s,
            "steps": steps, "quant_forwards": qf,
            "data_parallel": {"nccl_world_1": nccl, "collectives_in_main": collectives,
                              "two_ranks": dp}}


def optimizer_work(torch, params: dict, seed: int) -> dict:
    """Device launches and device ms of one update of each optimizer the
    training path builds, on `params` with seeded gradients, each after a
    warm-up update of its own: clip + AdamW, clip + 8-bit Adam, and 8-bit
    Adam under accumulation 2 (a micro-step inside the window, then the one
    that updates); and apply_updates. The parameters are not changed."""
    from tdm_tpu_torch.train import optim as topt

    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = {k: 1e-3 * torch.randn(p.shape, generator=gen, device=p.device)
             for k, p in params.items()}
    out = {"leaves": len(params), "elements": sum(p.numel() for p in params.values())}
    for name, kw in (("adamw", {}), ("adam8bit", {"eight_bit": True}),
                     ("adam8bit_accum", {"eight_bit": True, "accumulation_steps": LORA_ACCUM})):
        tx = topt.make_optimizer(1e-5, **kw)
        opt = tx.init(params)
        phases = ("inside_window", "updating") if "accumulation_steps" in kw else ("update",)
        for _ in phases:  # warm-up: one window
            _, opt = tx.update(grads, opt, params)
        out[name] = {}
        for phase in phases:
            (updates, opt), n, ms = count_device_work(
                torch, lambda: tx.update(grads, opt, params))
            out[name][phase] = {"launches": n, "device_ms": ms}
        del opt
    dests = {k: p.clone() for k, p in params.items()}
    _, n, ms = count_device_work(torch, lambda: topt.apply_updates(dests, updates))
    out["apply_updates"] = {"launches": n, "device_ms": ms}
    return out


def prompts_txt(workdir: str, n: int = 64) -> str:
    """A .txt prompt shard of `n` lines, one prompt each."""
    path = os.path.join(workdir, "prompts.txt")
    with open(path, "w") as f:
        f.writelines(f"a photo of object {i} on a table, studio light\n" for i in range(n))
    return path


def phase_train_lora(torch, seed: int, workdir: str) -> dict:
    """Full-width PixArt-α-512 TDM training of a rank-32 LoRA student with
    8-bit Adam and gradient accumulation 2 through the CLI's main(): batch 4,
    bf16, dmd, 2 optimizer steps of 2 micro-steps each. Checks: the
    attention launches of every micro-step equal the train phase's, the
    factors keep their bits in micro-steps 1 and 3 and change in 2 and 4,
    every quantized moment is int8, finite metrics, a kohya file of rank-32
    factors. Reports seconds per optimizer step, peak memory, the device
    busy time, idle share and device launches of micro-step 2 (profiled),
    and each optimizer's launches per update of the critic and the factors."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import tdm as tdm_mod

    train_env(seed, workdir)
    out = os.path.join(workdir, "train_lora")
    records, prev, last = [], {}, {}
    init_state = tdm_mod.init_state

    def capture_init(student, *a, **kw):
        prev.update({k: v.clone() for k, v in student.items()})
        return init_state(student, *a, **kw)

    def after(rec, state):
        rec["factors_changed"] = any(not torch.equal(state.student[k], v)
                                     for k, v in prev.items())
        prev.update({k: v.clone() for k, v in state.student.items()})
        rec["mini_step"] = state.student_opt.mini_step
        last["state"] = state

    A.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tdm_mod.init_state = capture_init
    try:
        train_tdm.main([
            "--output_dir", out, "--max_train_steps", str(LORA_STEPS),
            "--train_batch_size", "4", "--mixed_precision", "bf16", "--loss_mode", "dmd",
            "--train_lora_rank", str(LORA_RANK), "--use_8bit_adam",
            "--gradient_accumulation_steps", str(LORA_ACCUM), "--seed", str(seed),
        ], step_hook=step_hook(torch, records, 2, "train_lora", after))
    finally:
        tdm_mod.init_state = init_state
    total_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    run_dir = out + "_cfg4.5_steps900"
    ckpt = os.path.join(run_dir, f"checkpoint-{LORA_STEPS}")
    ckpt_gb = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)) / 1e9
    check_train_records(records, LORA_STEPS * LORA_ACCUM)
    changed = [r["factors_changed"] for r in records]
    check(changed == [False, True] * LORA_STEPS,
          f"factors changed after micro-steps {changed}, expected only at each 2nd")
    state = last["state"]
    for role in ("student", "critic"):
        inner = getattr(state, f"{role}_opt").inner
        for m in ("mu", "nu"):
            q = getattr(inner, m)
            check(q.codes.dtype == torch.int8 and q.codes.is_cuda,
                  f"{role} {m}: codes {q.codes.dtype} on {q.codes.device}")
    check(bool(state.critic_opt.inner.nu.codes.ne(0).any()), "the critic's ν codes are all 0")
    pieces = kohya_pieces(torch, os.path.join(run_dir, "tdm_lora.safetensors"), LORA_RANK)
    opt_work = {"critic": optimizer_work(torch, state.critic, seed),
                "student": optimizer_work(torch, state.student, seed)}
    del state, last["state"]
    print(f"[disk] {shutil.disk_usage(run_dir).used / 2**30:.1f} GiB used with "
          f"the run's checkpoint, before its removal", flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)
    per_opt_step = records[2]["host_s"] + records[3]["host_s"]
    busy = records[1]["busy_ms"]
    span = records[3]["event_ms"]
    idle = None if not busy else 1 - busy / span
    print(f"[train_lora] PixArt-α-512 TDM, rank-{LORA_RANK} LoRA student, 8-bit Adam, "
          f"accumulation {LORA_ACCUM} (dmd, batch 4, bf16): {per_opt_step:.3f} s per "
          f"optimizer step (micro-steps 3+4, unprofiled), micro-steps "
          + ", ".join(f"{r['host_s']:.3f}" for r in records)
          + f" s; peak memory {peak_gb:.2f} GiB; micro-step 2 device busy "
          + (f"{busy:.1f} ms against micro-step 4's CUDA-event span {span:.1f} ms -> "
             f"idle share {idle:.3f}" if busy else "not measured")
          + f", {records[1].get('all_launches')} device launches; attention launches per "
          f"micro-step {TRAIN_LAUNCHES} (checked); factors changed {changed} (checked); "
          f"kohya file {pieces} rank-{LORA_RANK} pieces; main() {total_s:.1f}s incl. a "
          f"{ckpt_gb:.2f} GB checkpoint", flush=True)
    for role, work in opt_work.items():
        print(f"[train_lora] one update of the {role}'s parameters ({work['leaves']} "
              f"leaves, {work['elements']} elements): "
              f"{json.dumps({k: v for k, v in work.items() if isinstance(v, dict)})}",
              flush=True)
    native = native_loader_run(torch, seed, workdir)
    return {"s_per_optimizer_step": per_opt_step, "micro_step_s": [r["host_s"] for r in records],
            "peak_gib": peak_gb, "busy_ms": busy, "event_span_ms": span, "idle_share": idle,
            "all_launches_per_micro_step": records[1].get("all_launches"),
            "launches_per_micro_step": TRAIN_LAUNCHES, "factors_changed": changed,
            "kohya_pieces": pieces, "checkpoint_gb": ckpt_gb, "main_s": total_s,
            "optimizers": opt_work, "records": records, "native_loader": native}


def native_loader_run(torch, seed: int, workdir: str) -> dict:
    """The native C++ prompt loader on PixArt's training path, apart from
    the full-width runs (which read the embedding cache): 2 steps of the
    tiny PixArt model through the CLI's main() on the card with a .txt
    shard as --train_data_dir (hash pseudo-embeddings), every step's batch
    checked to come from the native loader; then the host seconds per
    batch of 4 at PixArt's 120 tokens of the native loader against the
    Python batcher the CLI takes without it, the same shard, seed and hash
    tokenizer, medians of 5 rounds of 200 batches taken in turns (the
    embedding lookup after it is the same for both and left out)."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.data import native_loader, prompts, tokenizer

    shard = prompts_txt(workdir)
    served = []
    native_next = native_loader.NativePromptLoader.__next__

    def counted_next(self):
        batch = native_next(self)
        served.append(len(batch["prompts"]))
        return batch

    cache = os.environ.pop("TDM_EMBEDDING_CACHE", None)
    os.environ["TDM_TINY_MODEL"] = "1"
    native_loader.NativePromptLoader.__next__ = counted_next
    out = os.path.join(workdir, "train_native")
    t0 = time.monotonic()
    try:
        train_tdm.main(["--output_dir", out, "--max_train_steps", "2",
                        "--train_batch_size", "4", "--seed", str(seed),
                        "--train_data_dir", shard])
    finally:
        native_loader.NativePromptLoader.__next__ = native_next
        os.environ.pop("TDM_TINY_MODEL")
        if cache is not None:
            os.environ["TDM_EMBEDDING_CACHE"] = cache
    main_s = time.monotonic() - t0
    shutil.rmtree(out + "_cfg4.5_steps900", ignore_errors=True)
    check(served == [4, 4], f"the native loader served batches {served}, expected one "
                            "of 4 per step")
    tok = tokenizer.HashTokenizer()
    loaders = {
        "native": native_loader.NativePromptLoader(shard, 4, tokenizer=tok, max_length=120,
                                                   seed=seed),
        "python": iter(prompts.PromptBatcher(prompts.load_prompts(shard), 4, tokenizer=tok,
                                             max_length=120, seed=seed)),
    }
    secs = {name: [] for name in loaders}
    try:
        for name, it in loaders.items():  # warm: the C++ thread fills its ring
            next(it)
        for _ in range(5):
            for name, it in loaders.items():
                t = time.perf_counter()
                for _ in range(200):
                    next(it)
                secs[name].append((time.perf_counter() - t) / 200)
    finally:
        loaders["native"].close()
    per_batch = {name: sorted(v)[len(v) // 2] for name, v in secs.items()}
    print(f"[train_lora] native loader ({native_loader.library_path().name}): a tiny "
          f"PixArt run through main() on the card read its prompts from {shard} "
          f"({len(served)} batches of 4, checked; main() {main_s:.1f}s); host time per "
          f"batch of 4 at 120 tokens, medians of 5 rounds of 200 in turns: native "
          f"{per_batch['native'] * 1e6:.1f} us ({min(secs['native']) * 1e6:.1f}-"
          f"{max(secs['native']) * 1e6:.1f}), Python batcher "
          f"{per_batch['python'] * 1e6:.1f} us ({min(secs['python']) * 1e6:.1f}-"
          f"{max(secs['python']) * 1e6:.1f})", flush=True)
    return {"batches": len(served), "main_s": main_s, "per_batch_s": per_batch,
            "rounds_s": secs}


# the train_sd3 phase: the recipe's rank-32 LoRA student, 8-bit Adam,
# --gradient_checkpointing, accumulation 1, 3 optimizer steps at batch 4 (the
# smoke's clock: the first warms, the second is timed, the third profiled)
SD3_TRAIN_STEPS, SD3_LORA_RANK = 3, 32
# per SD3 step (dmd, cfg 4.5, one critic update): 7 forwards without grad
# (rollout x4, x0_gen_sg, the teacher's CFG probe at 2B, the critic probe)
# and 2 with grad (critic DSM, student loss), each 24 joint attentions; the
# checkpointed blocks run their grad forward again in the backward
SD3_TRAIN_LAUNCHES = {"flash_attention_fwd": 7 * 24, "flash_attention_fwd_lse": 2 * 2 * 24,
                      "flash_attention_bwd_dq": 2 * 24, "flash_attention_bwd_dkv": 2 * 24,
                      "splash_attention_fwd": 0}


def sd3_train_env(seed: int, workdir: str) -> str:
    """A seeded full-width SD3 embedding cache as $TDM_EMBEDDING_CACHE: 8
    prompts of 154 T5 tokens at 4096 with pooled CLIP vectors [8, 2048], the
    empty prompt's embedding and pooled vector, and dedicated rows with
    pooled vectors for the 4 default validation prompts; and a seeded TAESD3
    (a diffusers AutoencoderTiny directory, 16 latent channels) as
    $TDM_TAESD_DIR. Returns the TAESD3 directory."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.utils import config as cfg_lib

    rng = np.random.default_rng(seed + 20)
    n, L = 8, SD3T_TXT
    lengths = np.array([154, 77, 33, 9, 154, 1, 56, 100])
    val = list(cfg_lib.TrainConfig.validation_prompts)
    cache = os.path.join(workdir, "sd3_train_cache.npz")
    EmbeddingCache(
        rng.standard_normal((n, L, 4096)).astype(np.float16),
        (np.arange(L)[None] < lengths[:, None]).astype(np.int32),
        [f"prompt {i}" for i in range(n)],
        uncond_embed=(0.1 * rng.standard_normal((L, 4096))).astype(np.float16),
        uncond_mask=(np.arange(L) < 1).astype(np.int32),
        pooled=rng.standard_normal((n, 2048)).astype(np.float16),
        uncond_pooled=(0.1 * rng.standard_normal(2048)).astype(np.float16),
        val_prompts=val,
        val_embeds=rng.standard_normal((len(val), L, 4096)).astype(np.float16),
        val_masks=np.ones((len(val), L), np.int32),
        val_pooled=rng.standard_normal((len(val), 2048)).astype(np.float16),
    ).save(cache)
    taesd = taesd3_dir(workdir, seed)
    os.environ.pop("TDM_TINY_MODEL", None)
    os.environ["TDM_EMBEDDING_CACHE"] = cache
    os.environ["TDM_TAESD_DIR"] = taesd
    return taesd


def taesd3_dir(workdir: str, seed: int) -> str:
    """A seeded TAESD3: a diffusers AutoencoderTiny directory with 16 latent
    channels."""
    from tdm_tpu_torch.io import manifest
    from tdm_tpu_torch.models import vae

    taesd = os.path.join(workdir, "taesd3")
    os.makedirs(taesd, exist_ok=True)
    with open(os.path.join(taesd, "config.json"), "w") as f:
        json.dump({"_class_name": "AutoencoderTiny", "latent_channels": 16,
                   "decoder_block_out_channels": [64] * 4,
                   "num_decoder_blocks": [3, 3, 3, 1]}, f)
    manifest.write_synthetic("taesd", os.path.join(taesd, "diffusion_pytorch_model.safetensors"),
                             vae.TAESDConfig.taesd3(), seed=seed + 21, scale=0.05)
    return taesd


def phase_train_sd3(torch, seed: int, workdir: str) -> dict:
    """Full-width SD3-Medium TDM training through the CLI's main() with the
    recipe's flags: --model_family sd3 at the default --resolution 512
    (latent 16x64x64, 1024 + 154 tokens), batch 4, bf16 compute on fp32
    masters, dmd, a rank-32 LoRA student, 8-bit Adam,
    --gradient_checkpointing, accumulation 1, 3 optimizer steps; the
    teacher read from the SD3 checkout's transformer/ folder (its load timed
    by part); a seeded pooled cache; one validation grid at step 3 through a
    seeded TAESD3. Per step: host and CUDA-event times and the kernels'
    launches (checked against SD3_TRAIN_LAUNCHES); step 3 under
    torch.profiler (device busy time, idle share, the top device
    operations). Then the kohya LoRA: rank-32 factors on every adapted
    piece, loaded back into the port's SD3 pipeline from the same checkout
    (every key resolved to a kernel of SD3's module names and merged)."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.lora import adapter, io as lora_io
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import from_pretrained

    root, _, _ = sd3_checkout(workdir, seed)
    teacher_dir = os.path.join(root, "transformer")
    sd3_train_env(seed, workdir)
    out = os.path.join(workdir, "train_sd3")
    steps = []
    load_parts = teacher_load_parts("sd3_params")
    torch.cuda.empty_cache()
    A.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with timed_calls(torch, load_parts) as load_times, no_final_checkpoint(), \
            no_student_export():
        train_tdm.main([
            "--output_dir", out, "--model_family", "sd3", "--max_train_steps",
            str(SD3_TRAIN_STEPS), "--train_batch_size", str(SD3T_B), "--mixed_precision", "bf16",
            "--loss_mode", "dmd", "--train_lora_rank", str(SD3_LORA_RANK), "--use_8bit_adam",
            "--gradient_checkpointing", "--gradient_accumulation_steps", "1",
            "--validation_steps", str(SD3_TRAIN_STEPS), "--seed", str(seed),
            "--pretrained_model_name_or_path", teacher_dir,
        ], step_hook=step_hook(torch, steps, 3, "train_sd3"))
    total_s = time.monotonic() - t0
    launches = A.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(len(steps) == SD3_TRAIN_STEPS, f"{len(steps)} SD3 steps ran")
    for rec in steps:
        check(rec["launches"] == SD3_TRAIN_LAUNCHES,
              f"SD3 step {rec['step']} launches {rec['launches']}, expected "
              f"{SD3_TRAIN_LAUNCHES}")
        check(all(math.isfinite(v) for v in rec["metrics"].values()),
              f"SD3 step {rec['step']}: non-finite metrics {rec['metrics']}")
    run_dir = out + "_cfg4.5_steps900"
    for k in (4, 1):  # 4 validation prompts at 512²: a 2 x 2 grid
        with open(os.path.join(run_dir, f"validation_step{SD3_TRAIN_STEPS}_{k}nfe.png"),
                  "rb") as f:
            check_png(f.read(), 1024, 1024)
    check(not any(f.startswith("checkpoint-") for f in os.listdir(run_dir)),
          "train_sd3 wrote a checkpoint")
    lora_path = os.path.join(run_dir, "tdm_lora.safetensors")
    pieces = kohya_pieces(torch, lora_path, SD3_LORA_RANK)
    torch.cuda.empty_cache()
    # the file's names against SD3's: every key resolves to a kernel of the
    # checkout's transformer and the pipeline merges it (load_lora_weights
    # raises on a weight the transformer lacks)
    pipe = from_pretrained(root)
    lora = lora_io.load_lora(lora_path, model=pipe.transformer)
    adapted = adapter.adapted_keys(lora, from_jax.layer_stacks(pipe.transformer.cfg))
    check(len(adapted) == pieces, f"the kohya file's {pieces} pieces: {len(adapted)} resolved")
    pipe.load_lora_weights(lora_path, adapter_name="tdm")
    pipe.set_adapters(["tdm"], [1.0])
    del pipe, lora
    torch.cuda.empty_cache()
    print(f"[disk] {shutil.disk_usage(run_dir).used / 2**30:.1f} GiB used with "
          f"the run's files, before their removal", flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)
    plain = [r["host_s"] for r in steps[1:] if r["busy_ms"] is None]
    per_step = sum(plain) / len(plain)
    busy = steps[2]["busy_ms"]
    span = steps[1]["event_ms"]
    idle = None if not busy else 1 - busy / span
    load_s, parts = teacher_load_report(load_times, "sd3_params")
    print(f"[train_sd3] teacher from {teacher_dir} (and the TAESD3 decoder): loaded in {load_s:.2f}s ({parts})",
          flush=True)
    print(f"[train_sd3] SD3-Medium TDM at 512² (dmd, batch {SD3T_B}, bf16, rank-"
          f"{SD3_LORA_RANK} LoRA student, 8-bit Adam, gradient checkpointing, seeded "
          f"weights): {per_step:.3f} s/step after the first, unprofiled (step 2; "
          f"{3600 / per_step:.0f} iters/hour), first step {steps[0]['host_s']:.3f} s, "
          f"profiled step 3 {steps[2]['host_s']:.3f} s; peak memory {peak_gb:.2f} GiB; "
          f"launches per step {SD3_TRAIN_LAUNCHES} (checked); step 2 CUDA-event span "
          f"{span:.1f} ms, step 3 device busy "
          + (f"{busy:.1f} ms -> idle share {idle:.3f}" if busy else "not measured")
          + f", {steps[2].get('all_launches')} device launches; kohya file {pieces} rank-"
          f"{SD3_LORA_RANK} pieces, every one resolved and merged by the SD3 pipeline; "
          f"validation grids checked; main() {total_s:.1f}s (no final checkpoint: "
          f"`no_final_checkpoint`)", flush=True)
    return {"s_per_step": per_step, "iters_per_hour": 3600 / per_step,
            "first_step_s": steps[0]["host_s"], "peak_gib": peak_gb, "idle_share": idle,
            "busy_ms": busy, "event_span_ms": span,
            "all_launches_per_step": steps[2].get("all_launches"),
            "launches": launches, "launches_per_step": SD3_TRAIN_LAUNCHES,
            "load_s": load_s, "load": load_times, "kohya_pieces": pieces,
            "checkpoint_gb": None, "main_s": total_s, "steps": steps}


SD15_TRAIN_STEPS = 3  # the first warms, the second is timed, the third profiled
# per step at batch 4, dmd, cfg 4.5, critic_updates 1, --gradient_checkpointing:
# 7 forwards without grad (rollout x4, x0_gen_sg, teacher CFG probe at 2B,
# critic probe) and 2 with grad (critic DSM, student loss), each 16 spatial
# transformers x (self, cross) = 32 calls (10 at head dim 40, 10 at 80, 12
# at 160); every grad forward's calls run twice with the lse, once more in
# the remat recompute
SD15_CALLS = {64: 10, 80: 10, 160: 12}  # per forward, by padded head dim
SD15_TRAIN_LAUNCHES = {"flash_attention_fwd": 7 * 32, "flash_attention_fwd_lse": 2 * 2 * 32,
                       "flash_attention_bwd_dq": 2 * 32, "flash_attention_bwd_dkv": 2 * 32,
                       "splash_attention_fwd": 0}


def sd15_train_env(seed: int, workdir: str) -> str:
    """A seeded CLIP-L embedding cache as $TDM_EMBEDDING_CACHE (8 prompts of
    77 tokens at 768 with ragged masks, the empty prompt's 77 live tokens,
    dedicated rows for the 4 default validation prompts),
    and a seeded TAESD (a diffusers AutoencoderTiny directory, 4 latent
    channels) as $TDM_TAESD_DIR. Returns the TAESD directory."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.io import manifest
    from tdm_tpu_torch.models import vae

    from tdm_tpu_torch.utils import config as cfg_lib

    rng = np.random.default_rng(seed + 40)
    lengths = np.array([77, 40, 13, 5, 77, 1, 56, 20])
    val = list(cfg_lib.TrainConfig.validation_prompts)
    cache = os.path.join(workdir, "sd15_train_cache.npz")
    EmbeddingCache(
        rng.standard_normal((8, SD15_TXT, 768)).astype(np.float16),
        (np.arange(SD15_TXT)[None] < lengths[:, None]).astype(np.int32),
        [f"sd15 train prompt {i}" for i in range(8)],
        uncond_embed=(0.1 * rng.standard_normal((SD15_TXT, 768))).astype(np.float16),
        uncond_mask=np.ones(SD15_TXT, np.int32),
        val_prompts=val,
        val_embeds=rng.standard_normal((len(val), SD15_TXT, 768)).astype(np.float16),
        val_masks=np.ones((len(val), SD15_TXT), np.int32),
    ).save(cache)
    taesd = os.path.join(workdir, "taesd")
    os.makedirs(taesd, exist_ok=True)
    with open(os.path.join(taesd, "config.json"), "w") as f:
        json.dump({"_class_name": "AutoencoderTiny", "latent_channels": 4}, f)
    manifest.write_synthetic("taesd", os.path.join(taesd, "diffusion_pytorch_model.safetensors"),
                             vae.TAESDConfig(), seed=seed + 41, scale=0.05)
    os.environ.pop("TDM_TINY_MODEL", None)
    os.environ["TDM_EMBEDDING_CACHE"] = cache
    os.environ["TDM_TAESD_DIR"] = taesd
    return taesd


def sd15_remat_check(torch, seed: int, teacher_dir: str) -> dict:
    """One full-width sd15 TDM step (512², batch 4, bf16 on fp32 masters,
    dmd, AdamW) on one batch three times from one state: without remat,
    with remat, with remat again. Remat recomputes each ResBlock and
    SpatialTransformer through the same kernels and the same im2col
    convolutions, none of which uses atomics, so the metrics and every
    updated tensor of student and critic are checked bit for bit against
    the run without remat, and the second remat run against the first."""
    from tdm_tpu_torch.io import convert
    from tdm_tpu_torch.train import families, tdm

    bundles = {r: families.build("sd15", gradient_checkpointing=r, mixed_precision="bf16",
                                 seed=seed, device="cuda") for r in (False, True)}
    teacher = bundles[False].convert(convert.load_torch_state_dict(teacher_dir))
    shape = bundles[False].sample_shape
    gen = torch.Generator(device="cpu").manual_seed(seed + 42)
    config = tdm.TDMConfig()
    draws = tdm.StepDraws(*(x.cuda() for x in tdm.make_draws(config, SD15_B, shape, gen, "cpu")))
    text = torch.randn(SD15_B, SD15_TXT, 768, generator=gen).cuda()
    mask = (torch.arange(SD15_TXT)[None] < torch.tensor(SD15T_LENGTHS)[:, None]).int().cuda()
    cond, uncond = (text, mask), (torch.zeros_like(text), torch.ones_like(mask))
    report = remat_steps(torch, {r: b.denoise_fn for r, b in bundles.items()}, teacher,
                         bundles[False].schedule, shape, (draws, cond, uncond), "sd15")
    del teacher, bundles
    torch.cuda.empty_cache()
    print(f"[train_sd15] full-width step on one batch: remat vs plain "
          f"{report['remat_vs_plain']}, remat twice {report['repeat']} (host "
          f"{report['plain_s']:.2f}s plain, {report['remat_s']:.2f}s remat, first calls)",
          flush=True)
    return report


def remat_steps(torch, denoise_fns: dict, teacher: dict, schedule, shape: tuple,
                inputs: tuple, tag: str) -> dict:
    """One TDM step (dmd, AdamW, the smoke's recipe defaults) from the
    teacher's state on one batch (`inputs`: draws, cond, uncond) three
    times: through `denoise_fns[False]` (no remat), then twice through
    `denoise_fns[True]` (remat). Checks the metrics and every updated
    tensor of student and critic bit for bit, remat against plain and the
    second remat run against the first; returns the comparisons, each
    kind's first host seconds and launches."""
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import optim as topt, tdm

    draws, cond, uncond = inputs
    tx = topt.make_optimizer(2e-5, eps=1e-8, weight_decay=0.01, max_grad_norm=1.0)
    runs, report = [], {}
    for i, remat in enumerate((False, True, True)):
        state = tdm.init_state(teacher, teacher, tx, tx)
        step = tdm.build_train_step(denoise_fns[remat], teacher, schedule, tdm.TDMConfig(),
                                    tx, tx, sample_shape=shape)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        (new, metrics), launched = uncounted(A, lambda: step(state, draws, cond, uncond))
        torch.cuda.synchronize()
        report.setdefault("remat_s" if remat else "plain_s", time.monotonic() - t0)
        report.setdefault("remat_launches" if remat else "plain_launches", launched)
        m = {k: float(v) for k, v in metrics._asdict().items()}
        check(all(math.isfinite(v) for v in m.values()), f"{tag} step metrics {m}")
        runs.append((m, {r: getattr(new, r) for r in ("student", "critic")}))
        del state, new
        if i == 1:  # remat against plain; then the plain run's tensors go
            report["remat_vs_plain"] = _same_step(torch, *runs)
            runs.pop(0)
    report["repeat"] = _same_step(torch, *runs)
    for name in ("remat_vs_plain", "repeat"):
        check(report[name]["metrics_equal"] and report[name]["tensors_differing"] == 0,
              f"{tag} step {name}: not bit for bit: {report[name]}")
    return report


def _same_step(torch, a, b) -> dict:
    """Whether two steps' metrics and updated tensors are the same bits."""
    (ma, ta), (mb, tb) = a, b
    differ = [f"{r}/{k}" for r in ta for k in ta[r] if not torch.equal(ta[r][k], tb[r][k])]
    worst = max((float((ta[r][k] - tb[r][k]).abs().max()) for r in ta for k in ta[r]
                 if f"{r}/{k}" in differ), default=0.0)
    return {"metrics_equal": ma == mb, "tensors_differing": len(differ),
            "tensors": sum(len(t) for t in ta.values()), "max_abs_diff": worst,
            "first_differing": differ[:3]}


def _flash_by_dim(kernels: dict) -> dict:
    """{kernel: {template arguments: launches}} of a profiled step's flash
    kernels, from their demangled names."""
    out = {}
    for key, n in kernels.items():
        m = re.search(r"(flash_\w+_sm90_kernel)<([^>]*)>", key)
        if m:
            args = ",".join(a.strip() for a in m.group(2).split(","))
            out.setdefault(m.group(1), {})
            out[m.group(1)][args] = out[m.group(1)].get(args, 0) + n
    return out


def phase_train_sd15(torch, seed: int, workdir: str) -> dict:
    """Full-width SD1.5 TDM training through the CLI's main() at the JAX
    CLI's defaults plus --gradient_checkpointing (--model_family sd15 at
    512², latent 4x64x64, batch 4, bf16 compute on fp32 masters, dmd, AdamW,
    3 steps), the teacher read from the unet/ folder of the SD1.5 checkout
    (written here if the sd15 phase did not run; its load timed by part), a
    seeded CLIP-L cache with ragged masks and one validation grid at step 3
    through a seeded TAESD. First the remat check (sd15_remat_check). Per
    step: host and CUDA-event times and the kernels' launches (checked
    against SD15_TRAIN_LAUNCHES); step 3 under torch.profiler (device busy
    time, idle share, top device operations, and the flash kernels'
    launches by padded head dim, checked against SD15_CALLS). Then the
    default rank-32 kohya export by truncated SVD: its seconds and keys,
    and SD15_EXPORT_PATH's rank-32 reconstruction against a float64 SVD of
    its ΔW (checked; the train phase exports no LoRA)."""
    from tdm_tpu_torch import lora as lora_lib
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.ops import attention as A

    root, _, _ = sd15_checkout(torch, workdir, seed)
    teacher_dir = os.path.join(root, "unet")
    remat = sd15_remat_check(torch, seed, teacher_dir)
    sd15_train_env(seed, workdir)
    out = os.path.join(workdir, "train_sd15")
    steps = []
    export = {}
    extract = lora_lib.extract_lora

    def timed_extract(model, base, tuned, rank, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        lora = extract(model, base, tuned, rank, **kw)
        torch.cuda.synchronize()
        export["s"] = time.monotonic() - t0
        export["pieces"] = len(lora.params)
        key = SD15_EXPORT_PATH.replace("/", ".") + ".weight"
        export["delta"] = (tuned[key].float() - base[key].float()).T.double().cpu()
        export["ab"] = (lora.params[SD15_EXPORT_PATH]["a"].double()
                        @ lora.params[SD15_EXPORT_PATH]["b"].double()).cpu()
        return lora

    load_parts = teacher_load_parts("unet_sd15_params")
    torch.cuda.empty_cache()
    A.reset_launches()  # the main path from here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    lora_lib.extract_lora = timed_extract
    try:
        with timed_calls(torch, load_parts) as load_times, no_final_checkpoint(), \
                no_student_export():
            train_tdm.main([
                "--output_dir", out, "--model_family", "sd15", "--max_train_steps",
                str(SD15_TRAIN_STEPS), "--train_batch_size", str(SD15_B), "--mixed_precision",
                "bf16", "--loss_mode", "dmd", "--gradient_checkpointing", "--validation_steps",
                str(SD15_TRAIN_STEPS), "--seed", str(seed),
                "--pretrained_model_name_or_path", teacher_dir,
            ], step_hook=step_hook(torch, steps, 3, "train_sd15"))
    finally:
        lora_lib.extract_lora = extract
    total_s = time.monotonic() - t0
    launches = A.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(set(load_times) == {name for _, name in load_parts},
          f"the teacher was not loaded from {teacher_dir}: {load_times}")
    check(len(steps) == SD15_TRAIN_STEPS, f"{len(steps)} sd15 steps ran")
    for rec in steps:
        check(rec["launches"] == SD15_TRAIN_LAUNCHES,
              f"sd15 step {rec['step']} launches {rec['launches']}, expected "
              f"{SD15_TRAIN_LAUNCHES}")
        check(all(math.isfinite(v) for v in rec["metrics"].values()),
              f"sd15 step {rec['step']}: non-finite metrics {rec['metrics']}")
    by_dim = _flash_by_dim(steps[2].get("flash_kernels", {}))
    if by_dim:  # the profiler saw the device: launches by padded head dim
        want = {"flash_fwd_sm90_kernel": {f"{dp},{lse}": n * c for dp, c in SD15_CALLS.items()
                                          for lse, n in (("false", 7), ("true", 4))},
                "flash_bwd_dq_sm90_kernel": {str(dp): 2 * c for dp, c in SD15_CALLS.items()}}
        got_fwd = {k.replace(",0", ",false").replace(",1", ",true"): v
                   for k, v in by_dim.get("flash_fwd_sm90_kernel", {}).items()}
        dkv = by_dim.get("flash_bwd_dkv_sm90_kernel", {})
        dkv_by_dp = {}
        for args, n in dkv.items():
            dp, _, passes = args.split(",")
            if passes != "2":  # the dV pass or the whole kernel: one per call
                dkv_by_dp[dp] = dkv_by_dp.get(dp, 0) + n
        check(got_fwd == want["flash_fwd_sm90_kernel"]
              and by_dim.get("flash_bwd_dq_sm90_kernel") == want["flash_bwd_dq_sm90_kernel"]
              and dkv_by_dp == {str(dp): 2 * c for dp, c in SD15_CALLS.items()}
              and sum(n for a, n in dkv.items() if a.endswith(",2")) == 2 * SD15_CALLS[160],
              f"profiled sd15 step: flash kernels by template arguments {by_dim}")
        print(f"[train_sd15] profiled step 3: flash kernels by template arguments {by_dim} "
              f"(checked: padded head dims 64/80/160 at {SD15_CALLS} calls a forward; the "
              f"dK/dV kernel at 160 runs a dV pass <160,*,1> and a dK pass <160,*,2>)",
              flush=True)
    run_dir = out + "_cfg4.5_steps900"
    for k in (4, 1):  # 4 validation prompts at 512²: a 2 x 2 grid
        with open(os.path.join(run_dir, f"validation_step{SD15_TRAIN_STEPS}_{k}nfe.png"),
                  "rb") as f:
            check_png(f.read(), 1024, 1024)
    check(not any(f.startswith("checkpoint-") for f in os.listdir(run_dir)),
          "train_sd15 wrote a checkpoint")
    check("s" in export, "the LoRA export did not run")
    pieces = kohya_pieces(torch, os.path.join(run_dir, "tdm_lora.safetensors"), 32)
    check(pieces == export["pieces"], f"kohya file: {pieces} pieces, the export made "
                                      f"{export['pieces']}")
    delta = export["delta"]
    sv = torch.linalg.svdvals(delta)
    norm = float(delta.norm())
    opt_err = float(sv[32:].norm()) / norm
    err = float((delta - export["ab"]).norm()) / norm
    print(f"[train_sd15] export: {SD15_EXPORT_PATH} rank-32 relative error {err:.6f} against "
          f"the float64 optimum {opt_err:.6f} (limit +-{EXPORT_TOL})", flush=True)
    check(abs(err - opt_err) <= EXPORT_TOL,
          f"the rank-32 export of {SD15_EXPORT_PATH}: relative error {err}, optimum {opt_err}")
    print(f"[disk] {shutil.disk_usage(run_dir).used / 2**30:.1f} GiB used with "
          f"the run's files, before their removal", flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)
    plain = [r["host_s"] for r in steps[1:] if r["busy_ms"] is None]
    per_step = sum(plain) / len(plain)
    busy = steps[2]["busy_ms"]
    span = steps[1]["event_ms"]
    idle = None if not busy else 1 - busy / span
    load_s, parts = teacher_load_report(load_times, "unet_sd15_params")
    print(f"[train_sd15] teacher from {teacher_dir}: loaded in {load_s:.2f}s ({parts})",
          flush=True)
    print(f"[train_sd15] SD1.5 TDM at 512² (dmd, batch {SD15_B}, bf16, AdamW, gradient "
          f"checkpointing, seeded weights): {per_step:.3f} s/step after the first, "
          f"unprofiled (step 2; {3600 / per_step:.0f} iters/hour), first step "
          f"{steps[0]['host_s']:.3f} s, profiled step 3 {steps[2]['host_s']:.3f} s; peak "
          f"memory {peak_gb:.2f} GiB; launches per step {SD15_TRAIN_LAUNCHES} (checked); "
          f"step 2 CUDA-event span {span:.1f} ms, step 3 device busy "
          + (f"{busy:.1f} ms -> idle share {idle:.3f}" if busy else "not measured")
          + f", {steps[2].get('all_launches')} device launches; export: rank-32 kohya LoRA "
          f"of {pieces} kernels ({3 * pieces} keys) in {export['s']:.2f} s; validation "
          f"grids checked; main() {total_s:.1f}s (no final checkpoint: "
          f"`no_final_checkpoint`)", flush=True)
    return {"s_per_step": per_step, "iters_per_hour": 3600 / per_step,
            "first_step_s": steps[0]["host_s"], "peak_gib": peak_gb, "idle_share": idle,
            "busy_ms": busy, "event_span_ms": span,
            "all_launches_per_step": steps[2].get("all_launches"),
            "flash_kernels_by_template": by_dim, "launches": launches,
            "launches_per_step": SD15_TRAIN_LAUNCHES, "load_s": load_s, "load": load_times,
            "export": {"s": export["s"], "pieces": pieces, "keys": 3 * pieces,
                       "rel_err": err, "optimal_rel_err": opt_err},
            "checkpoint_gb": None, "main_s": total_s, "remat_check": remat,
            "steps": steps}


# ---------------------------------------------------------------------------
# CogVideoX-2B: kernel 1 at S = 17,776, the tiny pipeline, the served path
# ---------------------------------------------------------------------------


def plain_by_head(torch, q_scaled, k, v):
    """`plain_attention` one head at a time over every batch row: the same
    function (each head's softmax is its own) with fp32 logits of one head,
    [B, 1, S, S], at a time, where the whole call's would not fit."""
    from tdm_tpu_torch.ops import attention as A

    return torch.cat([A.plain_attention(q_scaled[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1],
                                        None) for h in range(q_scaled.shape[1])], dim=1)


def phase_kernels_cogvideox(torch, seed: int) -> dict:
    """Kernel 1 (no key bias) and kernel 4 at CogVideoX-2B's joint attention,
    [B, 30, 17776, 17776, 64] bf16 at batch 1 and 2, each held against the
    plain version computed head by head (compare(), per batch row), and
    timed in turns with SDPA (2 rounds of 10 launches; median, min, max),
    with the plain version's time (head by head, once) and the bound."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    fwd, _ = A._entry("tdm_flash_fwd")
    splash, _ = A._entry("tdm_splash_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    shapes, max_err, splash_err = [], 0.0, 0.0
    for b in (1, 2):
        h, s, d = COG_H, COG_S, COG_D
        q, k, v, _, qs, _ = _attn_inputs(torch, gen, b, h, s, s, d, torch.bfloat16, None)
        before = A.launch_counts()
        out = A.flash_attention_fwd(qs, k, v, None)
        out4 = A.splash_attention_fwd(qs, k, v)
        for w in A.WRAPPERS:  # comparison launches do not count
            w.launches = before[w.__name__]
        t0 = time.monotonic()
        ref = plain_by_head(torch, qs, k, v)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        results = {}
        for name, got in (("flash_fwd", out), ("splash_fwd", out4)):
            check(bool(torch.isfinite(got).all()), f"{name} cogvideox_b{b}: non-finite output")
            err, rel, bad = compare(torch, got, ref)
            print(f"[kernels] {name} cogvideox_b{b} [{b},{h},{s},{s},{d}] bf16 no mask "
                  f"max_abs_err {err:.3e} rel_l2 {rel:.3e} against plain head by head "
                  f"(per row rel L2 <= {BF16_REL_L2}, <= {BF16_ULPS} bf16 ulps)", flush=True)
            check(bad is None, f"{name} cogvideox_b{b}: {bad}")
            results[name] = (err, rel)
        del ref
        max_err = max(max_err, results["flash_fwd"][0])
        splash_err = max(splash_err, results["splash_fwd"][0])
        turns = time_turns(torch, {
            "kernel": lambda: fwd(qs.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                  out.data_ptr(), None, b, h, s, s, d, 1, stream),
            "splash": lambda: splash(qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out4.data_ptr(), b * h, s, s, d, 1, stream),
            "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)})
        ms, splash_ms, lib_ms = (turns[n]["median"] for n in ("kernel", "splash", "sdpa"))
        nbytes, ops = attention_work(b, h, s, s, d, 2, s * b, bias=False)
        bound, by = bound_ms(nbytes, ops)
        shapes.append({
            "shape": f"cogvideox_b{b}", "group": "cogvideox", "dims": [b, h, s, s, d],
            "ms": ms, "ms_range": [turns["kernel"]["min"], turns["kernel"]["max"]],
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_ms_range": [turns["sdpa"]["min"], turns["sdpa"]["max"]],
            "bound_ms": bound, "bound_by": by, "max_abs_err": results["flash_fwd"][0],
            "rel_l2": results["flash_fwd"][1], "bytes": nbytes, "ops": ops,
            "splash_ms": splash_ms,
            "splash_ms_range": [turns["splash"]["min"], turns["splash"]["max"]],
            "splash_max_abs_err": results["splash_fwd"][0]})
        print(f"[kernels] cogvideox_b{b} [{b},{h},{s},{s},{d}] in turns: flash_fwd "
              f"{spread(turns['kernel'])} ({ms / bound:.2f}x bound, {ms / lib_ms:.2f}x SDPA, "
              f"{ops / ms / 1e9:.0f} TFLOP/s) | splash_fwd {spread(turns['splash'])} "
              f"({splash_ms / bound:.2f}x bound, {splash_ms / lib_ms:.2f}x SDPA) | sdpa "
              f"{spread(turns['sdpa'])} | plain_ms {plain_ms:.1f} (head by head, once) | "
              f"bound_ms {bound:.4f} ({by})", flush=True)
        del q, k, v, qs, out, out4
        torch.cuda.empty_cache()
    return {"shapes": shapes, "max_abs_err": max_err, "splash_max_abs_err": splash_err}


def plain_train_by_head(torch, qs, k, v, dout, scale):
    """The training kernels' plain versions (the lse forward, dQ with Δ,
    dK/dV fed the plain Δ) one head at a time over every batch row, each
    head's fp32 [B, 1, S, S] logits, probabilities and dS at a time."""
    from tdm_tpu_torch.ops import attention as A

    outs = {n: [] for n in ("out", "lse", "dq", "delta", "dk", "dv")}
    for h in range(qs.shape[1]):
        one = [x[:, h:h + 1] for x in (qs, k, v, dout)]
        out, lse = A.plain_attention_lse(*one[:3], None)
        dq, delta = A.plain_attention_bwd_dq(*one[:3], None, one[3], out, lse, scale)
        dk, dv = A.plain_attention_bwd_dkv(*one[:3], None, one[3], lse, delta)
        for name, t in zip(outs, (out, lse, dq, delta, dk, dv)):
            outs[name].append(t)
    return {n: torch.cat(ts, dim=1) for n, ts in outs.items()}


def phase_kernels_train_cogvideox(torch, seed: int) -> dict:
    """The training kernels at CogVideoX-2B's joint attention with the
    train step's batch, [2, 30, 17776, 17776, 64] bf16 with no key mask
    (17,776 = 138·128 + 112: a ragged tail of query and key tiles): the
    forward with its lse, dQ with its fused Δ and dK/dV, each against its
    plain version computed head by head (compare() per batch row; the lse
    to LSE_TOL, Δ to DELTA_TOL), and the backward driven by the forward
    kernel's own output and lse as in training. Then each kernel timed in
    turns with SDPA's forward on inputs that require grad and SDPA's
    backward alone (2 rounds of 20 launches: median, min, max), with the
    plain version's time (head by head, once) and the bound."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    b, h, s, d = COG_TRAIN_B, COG_H, COG_S, COG_D
    q, k, v, _, qs, _ = _attn_inputs(torch, gen, b, h, s, s, d, torch.bfloat16, None)
    dout = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    scale = 1.0 / d ** 0.5
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = plain_train_by_head(torch, qs, k, v, dout, scale)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    before = A.launch_counts()
    out, lse = A.flash_attention_fwd_lse(qs, k, v, None)
    dq, delta = A.flash_attention_bwd_dq(qs, k, v, None, dout, ref["out"], ref["lse"], scale)
    dk, dv = A.flash_attention_bwd_dkv(qs, k, v, None, dout, ref["lse"], ref["delta"])
    dq_own, delta_own = A.flash_attention_bwd_dq(qs, k, v, None, dout, out, lse, scale)
    dk_own, dv_own = A.flash_attention_bwd_dkv(qs, k, v, None, dout, lse, delta_own)
    for w in A.WRAPPERS:  # comparison launches do not count
        w.launches = before[w.__name__]
    torch.cuda.synchronize()
    dims = f"[{b},{h},{s},{s},{d}] bf16 no mask"
    lse_err, lse_bad = compare_lse(torch, lse, ref["lse"])
    check(lse_bad is None, f"flash_fwd_lse cogvideox_train: {lse_bad}")
    errs = {"flash_fwd_lse": lse_err, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for label, got, want in (("delta", delta, ref["delta"]),
                             ("delta from the kernel's output", delta_own,
                              A.attention_delta(dout, out))):
        err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
        print(f"[kernels] flash_bwd_dq cogvideox_train {dims} {label}: max_abs_err {err:.3e} "
              f"of the largest |Δ| (limit {DELTA_TOL})", flush=True)
        check(bool(torch.isfinite(got).all()) and err <= DELTA_TOL,
              f"flash_bwd_dq cogvideox_train {label}: {err:.3e} > {DELTA_TOL}")
    for kern, label, got, want in (
            ("flash_fwd_lse", "out", out, ref["out"]),
            ("flash_bwd_dq", "dq", dq, ref["dq"]),
            ("flash_bwd_dq", "dq from the kernel's lse", dq_own, ref["dq"]),
            ("flash_bwd_dkv", "dk", dk, ref["dk"]), ("flash_bwd_dkv", "dv", dv, ref["dv"]),
            ("flash_bwd_dkv", "dk from the kernel's lse", dk_own, ref["dk"]),
            ("flash_bwd_dkv", "dv from the kernel's lse", dv_own, ref["dv"])):
        check(bool(torch.isfinite(got).all()), f"{kern} cogvideox_train: non-finite {label}")
        err, rel, bad = compare(torch, got, want)
        tail, _, tail_bad = compare(torch, got[:, :, 138 * 128:], want[:, :, 138 * 128:])
        print(f"[kernels] {kern} cogvideox_train {dims} {label} max_abs_err {err:.3e} rel_l2 "
              f"{rel:.3e} (the ragged tail's 112 rows {tail:.3e}) against plain head by head",
              flush=True)
        check(bad is None and tail_bad is None, f"{kern} cogvideox_train {label}: "
                                                f"{bad or tail_bad}")
        errs[kern] = max(errs[kern], err)
    print(f"[kernels] flash_fwd_lse cogvideox_train {dims} lse max_abs_err {lse_err:.3e} "
          f"(limit {LSE_TOL}); plain versions head by head {plain_s:.1f}s", flush=True)
    del ref, dq_own, dk_own, dv_own, delta_own
    torch.cuda.empty_cache()
    stream = torch.cuda.current_stream().cuda_stream
    fwd, _ = A._entry("tdm_flash_fwd")
    fdq, _ = A._entry("tdm_flash_bwd_dq")
    fdkv, _ = A._entry("tdm_flash_bwd_dkv")
    kernels = {
        "flash_fwd_lse": lambda: fwd(qs.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                     out.data_ptr(), lse.data_ptr(), b, h, s, s, d, 1, stream),
        "flash_bwd_dq": lambda: fdq(qs.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                    dout.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                    delta.data_ptr(), dq.data_ptr(), b, h, s, s, d, scale, 1,
                                    stream),
        "flash_bwd_dkv": lambda: fdkv(qs.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                      dk.data_ptr(), dv.data_ptr(), b, h, s, s, d, 1, stream),
    }
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
    turns = time_turns(torch, {
        **kernels,
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(qg, kg, vg),
        "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout,
                                                retain_graph=True),
    }, iters=20)
    # the plain versions' times, head by head, once each
    plain_ms = {}
    for kern, fn in (
            ("flash_fwd_lse", lambda i, *x: A.plain_attention_lse(*x[:3], None)),
            ("flash_bwd_dq", lambda i, *x: A.plain_attention_bwd_dq(
                *x[:3], None, x[3], out[:, i], lse[:, i], scale)),
            ("flash_bwd_dkv", lambda i, *x: A.plain_attention_bwd_dkv(
                *x[:3], None, x[3], lse[:, i], delta[:, i]))):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for hh in range(h):
            one = slice(hh, hh + 1)
            fn(one, qs[:, one], k[:, one], v[:, one], dout[:, one])
        torch.cuda.synchronize()
        plain_ms[kern] = (time.monotonic() - t0) * 1e3
    work = {"flash_fwd_lse": "fwd_lse", "flash_bwd_dq": "dq", "flash_bwd_dkv": "dkv"}
    recs = {}
    for kern, name in work.items():
        nbytes, ops = attention_bwd_work(name, b, h, s, s, d, 2, s * b, bias=False)
        bound, by = bound_ms(nbytes, ops)
        ms = turns[kern]["median"]
        lib = "sdpa_fwd" if kern == "flash_fwd_lse" else "sdpa_bwd"
        recs[kern] = {
            "shape": "cogvideox_train_b2", "group": "cogvideox_train", "dims": [b, h, s, s, d],
            "ms": ms, "ms_range": [turns[kern]["min"], turns[kern]["max"]],
            "plain_ms": plain_ms[kern],
            # SDPA's forward beside the lse forward; its backward alone (dQ,
            # dK, dV) beside dQ and beside dK/dV each: no one library call
            # computes either backward kernel's function alone
            "library_ms": turns[lib]["median"] if kern == "flash_fwd_lse" else None,
            "sdpa_ms": turns[lib]["median"], "sdpa_ms_range": [turns[lib]["min"],
                                                               turns[lib]["max"]],
            "bound_ms": bound, "bound_by": by, "max_abs_err": errs[kern],
            "bytes": nbytes, "ops": ops}
        print(f"[kernels] {kern} cogvideox_train {dims} in turns: {spread(turns[kern])} "
              f"({ms / bound:.2f}x bound, {ops / ms / 1e9:.0f} TFLOP/s) | {lib} "
              f"{spread(turns[lib])} | plain_ms {plain_ms[kern]:.1f} (head by head, once) | "
              f"bound_ms {bound:.4f} ({by})", flush=True)
    pair = recs["flash_bwd_dq"]["ms"] + recs["flash_bwd_dkv"]["ms"]
    print(f"[kernels] training attention cogvideox_train: dq + dkv {pair:.3f} ms vs SDPA's "
          f"backward alone {spread(turns['sdpa_bwd'])} "
          f"({pair / turns['sdpa_bwd']['median']:.2f}x)", flush=True)
    del q, k, v, qs, dout, out, lse, dq, delta, dk, dv, qg, kg, vg, sdpa_out
    torch.cuda.empty_cache()
    return {"kernels": recs, "dq_plus_dkv_ms": pair, "sdpa_bwd_ms": turns["sdpa_bwd"]["median"],
            "plain_s": plain_s}


# CogVideoX-2B under --sp 2 at 61 frames, 480×720: 16 latent frames, 21,600
# video tokens, 10,800 a rank; a rank's 226 + 10,800 query rows attend, per
# attention call, the 226-row T5 prefix and the two 10,800-row shards (its
# own and the other rank's): n + 1 = 3 hops of each kernel
SP_N, SP_FRAMES = 2, 61
SP_LAT_F = 1 + (SP_FRAMES - 1) // 4
SP_SHARD = SP_LAT_F * 30 * 45 // SP_N
SP_Q = COG_TXT + SP_SHARD
SP_HOPS = SP_N + 1
SP_MID = 2048  # the shard rows of the mid shape held against the plain ring


def ring_launches(mono: dict) -> dict:
    """A step's or a batch's launches under the ring at SP_N from the
    monolithic ones: every attention call (with or without grad) takes
    kernel 1 with its lse once per hop, every backward call kernels 2 and
    3 once per hop, and nothing takes the forward without lse."""
    calls = mono["flash_attention_fwd"] + mono["flash_attention_fwd_lse"]
    return {"flash_attention_fwd": 0, "flash_attention_fwd_lse": SP_HOPS * calls,
            "flash_attention_bwd_dq": SP_HOPS * mono["flash_attention_bwd_dq"],
            "flash_attention_bwd_dkv": SP_HOPS * mono["flash_attention_bwd_dkv"],
            "splash_attention_fwd": 0}


def _ring_grads(torch, ring, ops, group, q, k, v, k_p, v_p, g, mask=None, prefix_mask=None):
    """(out, lse, dq, dk, dv, dk_p, dv_p) of the ring over `ops` (the
    kernels or the plain versions) in a world of one."""
    from tdm_tpu_torch.ops import attention as A

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, k_p, v_p)]
    bias = None if mask is None else A.key_bias(mask)
    bias_p = None if prefix_mask is None else A.key_bias(prefix_mask)
    scale = 1.0 / q.shape[-1] ** 0.5
    out = ring.RingFlashAttention.apply(*leaves, bias, bias_p, group, scale, ops)
    grads = torch.autograd.grad(out, leaves, g)
    qs = (q.float() * scale).to(q.dtype)
    with torch.no_grad():
        _, lse = ring.ring_forward(ops, qs, k, v, bias, k_p, v_p, bias_p, group)
    return (out.detach(), lse, *grads)


def phase_kernels_ring(torch, seed: int) -> dict:
    """The ring (`ops/ring_attention.py`, no kernel of its own) in a world
    of one: with the prefix that is two hops, the prefix's and the local
    shard's, so the lse merge and the merged-lse backward run with no
    permute. Held (1) against the plain ring (the plain versions called on
    the card) at a mid shape, q [2, 30, 226 + SP_MID, 64] over a SP_MID-row
    shard and the 226-row prefix, batch row 1's keys and prefix all masked
    (its output and gradients exactly 0), and (2) at the full hop shape of
    --sp 2 at 61 frames, q [1, 30, 11026, 64] over the 226-row prefix and a
    10,800-row shard, against one monolithic kernel 1/2/3 call over the
    concatenated 11,026 keys: the output and dQ/dK/dV (compare()), the lse
    (LSE_TOL). Then each hop shape of a rank's ring call, the prefix hop
    [1, 30, 11026, 226, 64] and the shard hop [1, 30, 11026, 10800, 64],
    timed in turns with SDPA at that shape (forward on inputs that require
    grad, and its backward alone) for kernels 1 (lse), 2 and 3, with each
    hop's plain time (head by head, once) and bound; and SDPA over one
    rank's whole call, [1, 30, 11026, 21826, 64] (the prefix and both
    shards: the function of a ring call), beside the call's kernel times
    (the prefix hop plus SP_N shard hops)."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A, ring_attention as ring
    from tdm_tpu_torch.parallel import mesh as pmesh

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    dev, bf = "cuda", torch.bfloat16
    h, d = COG_H, COG_D
    one = pmesh.AxisGroup(1, 0, None, (0,))
    before = A.launch_counts()

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    # (1) the mid shape, kernels against the plain ring
    sq = COG_TXT + SP_MID
    q, g = rnd(2, h, sq, d), rnd(2, h, sq, d)
    k, v = rnd(2, h, SP_MID, d), rnd(2, h, SP_MID, d)
    k_p, v_p = rnd(2, h, COG_TXT, d), rnd(2, h, COG_TXT, d)
    mask = torch.ones(2, SP_MID, dtype=torch.int32, device=dev)
    mask[1] = 0
    pmask = torch.ones(2, COG_TXT, dtype=torch.int32, device=dev)
    pmask[1] = 0
    got = _ring_grads(torch, ring, ring.KERNELS, one, q, k, v, k_p, v_p, g, mask, pmask)
    want = _ring_grads(torch, ring, ring.PLAIN, one, q, k, v, k_p, v_p, g, mask, pmask)
    names = ("out", "lse", "dq", "dk", "dv", "dk_p", "dv_p")
    mid_err = 0.0
    for name, a, b in zip(names, got, want):
        check(bool(torch.isfinite(a[0]).all()), f"ring mid {name}: non-finite")
        if name == "lse":
            err, bad = compare_lse(torch, a, b)
            check(bool((a[1] == 1e30).all()), "ring mid: the all-masked row's lse is not +1e30")
        else:
            err, _, bad = compare(torch, a, b)
            check(bool((a[1] == 0).all()), f"ring mid {name}: the all-masked row is not 0")
        print(f"[kernels] ring mid [2,{h},{sq},{COG_TXT}+{SP_MID},{d}] bf16 {name}: kernels "
              f"against the plain ring max_abs_err {err:.3e} (row 1 all masked: exactly "
              f"{'+1e30' if name == 'lse' else '0'}, checked)", flush=True)
        check(bad is None, f"ring mid {name}: {bad}")
        mid_err = max(mid_err, err)
    del q, g, k, v, k_p, v_p, got, want
    # (2) the full hop shape against one monolithic call
    q, g = rnd(1, h, SP_Q, d), rnd(1, h, SP_Q, d)
    k, v = rnd(1, h, SP_SHARD, d), rnd(1, h, SP_SHARD, d)
    k_p, v_p = rnd(1, h, COG_TXT, d), rnd(1, h, COG_TXT, d)
    got = _ring_grads(torch, ring, ring.KERNELS, one, q, k, v, k_p, v_p, g)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, k_p, v_p)]
    kk, vv = torch.cat([leaves[3], leaves[1]], 2), torch.cat([leaves[4], leaves[2]], 2)
    mono = A.FlashAttention.apply(leaves[0], kk, vv, None, 1.0 / d ** 0.5)
    dq, dk, dv, dk_p, dv_p = torch.autograd.grad(mono, leaves, g)
    qs = (q.float() / d ** 0.5).to(bf)
    _, lse = A.flash_attention_fwd_lse(qs, kk.detach(), vv.detach(), None)
    want = (mono.detach(), lse, dq, dk, dv, dk_p, dv_p)
    full_err = {}
    for name, a, b in zip(names, got, want):
        check(bool(torch.isfinite(a).all()), f"ring full {name}: non-finite")
        if name == "lse":
            err, bad = compare_lse(torch, a, b)
        else:
            err, _, bad = compare(torch, a, b)
        full_err[name] = err
        print(f"[kernels] ring hop shape [1,{h},{SP_Q},{COG_TXT}+{SP_SHARD},{d}] bf16 {name}: "
              f"the ring's 2 hops against one monolithic kernel call over the {SP_Q} keys "
              f"max_abs_err {err:.3e}", flush=True)
        check(bad is None, f"ring full {name}: {bad}")
    del got, want, leaves, kk, vv, mono, dq, dk, dv, dk_p, dv_p, lse
    torch.cuda.empty_cache()
    for w in A.WRAPPERS:  # comparison launches do not count
        w.launches = before[w.__name__]
    # (3) the hop shapes timed in turns with SDPA
    stream = torch.cuda.current_stream().cuda_stream
    fwd, _ = A._entry("tdm_flash_fwd")
    fdq, _ = A._entry("tdm_flash_bwd_dq")
    fdkv, _ = A._entry("tdm_flash_bwd_dkv")
    scale = 1.0 / d ** 0.5
    hops, b = {}, 1
    for hop, kk, vv in (("prefix", k_p, v_p), ("shard", k, v)):
        sk = kk.shape[2]
        out, lse_h = A.flash_attention_fwd_lse(qs, kk, vv, None)
        dq, delta = A.flash_attention_bwd_dq(qs, kk, vv, None, g, out, lse_h, scale)
        dk, dv = A.flash_attention_bwd_dkv(qs, kk, vv, None, g, lse_h, delta)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, kk, vv))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
        turns = time_turns(torch, {
            "fwd_lse": lambda: fwd(qs.data_ptr(), kk.data_ptr(), vv.data_ptr(), None,
                                   out.data_ptr(), lse_h.data_ptr(), b, h, SP_Q, sk, d, 1,
                                   stream),
            "dq": lambda: fdq(qs.data_ptr(), kk.data_ptr(), vv.data_ptr(), None, g.data_ptr(),
                              out.data_ptr(), lse_h.data_ptr(), delta.data_ptr(),
                              dq.data_ptr(), b, h, SP_Q, sk, d, scale, 1, stream),
            "dkv": lambda: fdkv(qs.data_ptr(), kk.data_ptr(), vv.data_ptr(), None,
                                g.data_ptr(), lse_h.data_ptr(), delta.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), b, h, SP_Q, sk, d, 1, stream),
            "sdpa_fwd": lambda: F.scaled_dot_product_attention(qg, kg, vg),
            "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), g,
                                                    retain_graph=True)}, iters=10)
        plain = {}
        for name, fn in (
                ("fwd_lse", lambda i: A.plain_attention_lse(qs[:, i], kk[:, i], vv[:, i], None)),
                ("dq", lambda i: A.plain_attention_bwd_dq(qs[:, i], kk[:, i], vv[:, i], None,
                                                          g[:, i], out[:, i], lse_h[:, i],
                                                          scale)),
                ("dkv", lambda i: A.plain_attention_bwd_dkv(qs[:, i], kk[:, i], vv[:, i], None,
                                                            g[:, i], lse_h[:, i],
                                                            delta[:, i]))):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for hh in range(h):
                fn(slice(hh, hh + 1))
            torch.cuda.synchronize()
            plain[name] = (time.monotonic() - t0) * 1e3
        rec = {"dims": [b, h, SP_Q, sk, d], "sdpa_fwd_ms": turns["sdpa_fwd"]["median"],
               "sdpa_bwd_ms": turns["sdpa_bwd"]["median"]}
        for name in ("fwd_lse", "dq", "dkv"):
            nbytes, ops = attention_bwd_work(name, b, h, SP_Q, sk, d, 2, sk, bias=False)
            bound, by = bound_ms(nbytes, ops)
            ms = turns[name]["median"]
            rec[name] = {"ms": ms, "ms_range": [turns[name]["min"], turns[name]["max"]],
                         "plain_ms": plain[name], "bound_ms": bound, "bound_by": by,
                         "bytes": nbytes, "ops": ops}
            lib = "sdpa_fwd" if name == "fwd_lse" else "sdpa_bwd"
            print(f"[kernels] ring {hop} hop [{b},{h},{SP_Q},{sk},{d}] {name} in turns: "
                  f"{spread(turns[name])} ({ms / bound:.2f}x bound, {ops / ms / 1e9:.0f} "
                  f"TFLOP/s) | {lib} {spread(turns[lib])} | plain_ms {plain[name]:.1f} (head "
                  f"by head, once) | bound_ms {bound:.4f} ({by})", flush=True)
        hops[hop] = rec
        del out, lse_h, dq, delta, dk, dv, qg, kg, vg, sdpa_out
        torch.cuda.empty_cache()
    # one rank's whole ring call: SDPA over the prefix and both shards
    k_all = torch.cat([k_p, k, k], 2)
    v_all = torch.cat([v_p, v, v], 2)
    call = time_turns(torch, {"sdpa_call": lambda: F.scaled_dot_product_attention(
        q, k_all, v_all)}, iters=10)["sdpa_call"]
    del q, g, k, v, k_p, v_p, k_all, v_all, qs
    torch.cuda.empty_cache()
    sk_all = COG_TXT + SP_N * SP_SHARD
    calls = {}
    for name in ("fwd_lse", "dq", "dkv"):
        ms = hops["prefix"][name]["ms"] + SP_N * hops["shard"][name]["ms"]
        plain_ms = hops["prefix"][name]["plain_ms"] + SP_N * hops["shard"][name]["plain_ms"]
        nbytes, ops = attention_bwd_work(name, 1, h, SP_Q, sk_all, d, 2, sk_all, bias=False)
        bound, by = bound_ms(nbytes, ops)
        calls[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        sdpa = (f"; SDPA over the whole call {spread(call)} ({ms / call['median']:.2f}x)"
                if name == "fwd_lse" else "")
        print(f"[kernels] ring call of one rank at --sp {SP_N}, q [1,{h},{SP_Q},{d}] over "
              f"{sk_all} keys ({SP_HOPS} hops): {name} {ms:.4f} ms ({ms / bound:.2f}x bound "
              f"{bound:.4f} ms, {by}){sdpa}", flush=True)
    return {"mid_max_abs_err": mid_err, "full_max_abs_err": full_err, "hops": hops,
            "call": calls, "sdpa_call_ms": call["median"],
            "sdpa_call_ms_range": [call["min"], call["max"]]}


def tiny_cogvideox_pair(torch, seed: int, use_rotary: bool):
    """The tiny CogVideoX pipeline (fp32, 2 layers of 2×16 heads, the tiny
    3D VAE, tiles of 6 latents overlapping by 2) on the CPU and on the card
    with the same seeded weights."""
    import dataclasses

    from tdm_tpu_torch.models import cogvideox as cog, vae3d
    from tdm_tpu_torch.pipelines import CogVideoXPipeline

    torch.manual_seed(seed)
    cfg = dataclasses.replace(cog.CogVideoXConfig.tiny(), use_rotary=use_rotary)
    pipes = [CogVideoXPipeline(cog.CogVideoXTransformer3D(cfg, device=dev),
                               vae_decoder=vae3d.VAE3DDecoder(vae3d.VAE3DConfig.tiny(), device=dev),
                               vae_tile=6, vae_tile_overlap=2, device=dev)
             for dev in ("cpu", "cuda")]
    pipes[1].transformer.load_state_dict(pipes[0].transformer.state_dict())
    pipes[1].vae_decoder.load_state_dict(pipes[0].vae_decoder.state_dict())
    return pipes


def phase_reference_cogvideox(torch, seed: int) -> None:
    """The tiny CogVideoX pipeline under both position schemes on the card
    (kernel 1, the per-tap conv2d route of the 3D VAE) against the same
    pipeline on the CPU (plain attention): latents to one bf16 ulp of their
    scale (the sampler state is bf16 in both), frames of the tiled decode
    (8×10 latents in 6-tiles) and of the same decode streamed in chunks of 2
    latent frames to half an 8-bit step."""
    import numpy as np

    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 23)
    lat = rng.standard_normal((3, 16, 3, 8, 10)).astype(np.float32)
    text = rng.standard_normal((3, 8, 32)).astype(np.float32)
    kw = dict(prompt_embeds=text, latents=lat, num_frames=5, height=16, width=20)
    for use_rotary in (False, True):
        cpu, gpu = tiny_cogvideox_pair(torch, seed, use_rotary)
        ref = cpu(**kw)
        before = A.launch_counts()
        got = gpu(**kw)
        gpu.vae_temporal_chunk = 2
        with torch.inference_mode():
            streamed = to_frames(gpu.decode(got.latents))
        torch.cuda.synchronize()
        launched = {n: A.launch_counts()[n] - before[n] for n in before}
        for w in A.WRAPPERS:  # a check, not the main path
            w.launches = before[w.__name__]
        dl = (got.latents.float().cpu() - ref.latents.float()).abs()
        scale = ref.latents.float().abs().max().item()
        di = (got.frames.cpu() - ref.frames).abs().max().item()
        ds = (streamed.cpu() - ref.frames).abs().max().item()
        print(f"[reference] tiny CogVideoX ({'RoPE' if use_rotary else 'sin-cos'}) cuda "
              f"(kernel 1, {launched['flash_attention_fwd']} launches) vs cpu (plain): latents "
              f"max_abs_err {dl.max().item():.3e} of scale {scale:.3g}, "
              f"{(dl > 0).float().mean().item():.4f} of elements differ; frames "
              f"{tuple(got.frames.shape)} tiled max_abs_err {di:.3e}, streamed {ds:.3e}",
              flush=True)
        check(launched["flash_attention_fwd"] == 2 * 4 and sum(launched.values()) == 8,
              f"tiny CogVideoX launches {launched}")
        check(dl.max().item() <= 2**-7 * scale, "tiny CogVideoX latents disagree")
        check((dl > 0).float().mean().item() < 0.01, "tiny CogVideoX latents disagree")
        check(tuple(got.frames.shape) == (3, 5, 16, 20, 3) and di <= 2e-3 and ds <= 2e-3,
              "tiny CogVideoX frames disagree")


def to_frames(video):
    """A decoded [B, 3, F, H, W] video as the pipeline's [B, F, H, W, 3]."""
    from tdm_tpu_torch.pipelines.base import to_images

    return to_images(video, value_range="pm1")


VAE3D_WEIGHT_SCALE = 0.1  # seeded decoder weights: frames spread over [0, 1]


def cogvideox_checkout(torch, workdir: str, seed: int) -> tuple[str, float, int]:
    """The CogVideoX-2B checkout (30 layers, 30×64 heads, T5 4096, time
    embedding 512; the AutoencoderKLCogVideoX decoder [128, 256, 256, 512],
    scaling 1.15258426) as `CogVideoXPipeline` ships it: model_index.json,
    transformer/ (its config counting 49 pixel frames) and vae/, each a
    config.json and one fp16 safetensors file of seeded weights in the key
    layout of the port's manifests, written once per run (by the first of
    `cogvideox` and `train_cogvideox` that runs); the transformer's 1.69 B
    weights drawn on the card (write_seeded). Returns (its root, the
    seconds and parameters of the write, 0 when it was there)."""
    from tdm_tpu_torch.io import manifest
    from tdm_tpu_torch.models import cogvideox as cog, vae3d

    cfg, vcfg = cog.CogVideoXConfig(), vae3d.VAE3DConfig()
    check((cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.text_dim, cfg.time_embed_dim,
           cfg.max_text_len, cfg.use_rotary, tuple(vcfg.block_widths), vcfg.scaling_factor)
          == (30, 30, 64, 4096, 512, 226, False, (128, 256, 256, 512), 1.15258426),
          "CogVideoX-2B and its VAE")
    root = os.path.join(workdir, "CogVideoX-2b")
    if os.path.exists(os.path.join(root, "model_index.json")):
        return root, 0.0, 0
    t0 = time.monotonic()
    files = {
        "model_index.json": {"_class_name": "CogVideoXPipeline"},
        "transformer/config.json": {
            "_class_name": "CogVideoXTransformer3DModel", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "patch_size": cfg.patch_size,
            "num_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "attention_head_dim": cfg.head_dim, "text_embed_dim": cfg.text_dim,
            "time_embed_dim": cfg.time_embed_dim, "max_text_seq_length": cfg.max_text_len,
            "sample_frames": 49, "sample_height": 60, "sample_width": 90,
            "temporal_compression_ratio": 4, "use_rotary_positional_embeddings": False},
        "vae/config.json": {
            "_class_name": "AutoencoderKLCogVideoX", "latent_channels": vcfg.latent_channels,
            "block_out_channels": list(vcfg.block_widths),
            "layers_per_block": vcfg.layers_per_block, "norm_num_groups": vcfg.norm_groups,
            "scaling_factor": vcfg.scaling_factor, "temporal_compression_ratio": 4},
    }
    for name, conf in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        with open(os.path.join(root, name), "w") as f:
            json.dump(conf, f)
    n = write_seeded(os.path.join(root, "transformer", "diffusion_pytorch_model.safetensors"),
                     "cogvideox", cfg, seed)
    n += manifest.write_synthetic(
        "vae3d_decoder", os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"),
        vcfg, seed=seed + 1, scale=VAE3D_WEIGHT_SCALE)
    secs = time.monotonic() - t0
    link_encoder(seeded_encoders(torch, workdir, seed, ["t5"])["t5"][0],
                 os.path.join(root, "text_encoder"))
    print(f"[checkout] wrote the CogVideoX-2B diffusers checkout ({n / 1e6:.1f}M params at "
          f"fp16) in {secs:.1f}s, its text_encoder (T5-XXL) hardlinked", flush=True)
    return root, secs, n


def t5_cache(workdir: str, seed: int) -> tuple[str, list]:
    """An embedding cache of 4 prompts: T5-XXL rows [226, 4096] (CogVideoX
    attends to all 226, so the masks are all ones)."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache

    prompts = [f"cogvideox prompt {i}" for i in range(4)]
    cache = os.path.join(workdir, "t5_cache.npz")
    rng = np.random.default_rng(seed + 29)
    EmbeddingCache(rng.standard_normal((4, COG_TXT, 4096)).astype(np.float16),
                   np.ones((4, COG_TXT), np.int32), prompts).save(cache)
    return cache, prompts


def check_gif(gif: bytes, frames: int, width: int, height: int) -> list:
    """A GIF89a of `frames` frames at width×height with a 256-entry global
    colour table, the NETSCAPE2.0 block looping forever and a 12 cs delay
    before every frame, read block by block. Returns each frame's LZW
    sub-block data, joined."""
    check(gif[:6] == b"GIF89a" and gif[-1:] == b"\x3b", "GIF signature and trailer")
    w, h, packed = (int.from_bytes(gif[6:8], "little"), int.from_bytes(gif[8:10], "little"),
                    gif[10])
    check((w, h, packed) == (width, height, 0xF7), f"GIF screen {w}x{h} flags {packed:#x}")
    pos, loop, delays, data = 13 + 768, None, [], []
    while gif[pos] != 0x3B:
        kind = gif[pos]
        if kind == 0x21:
            label, pos, blocks = gif[pos + 1], pos + 2, []
            while gif[pos]:
                blocks.append(gif[pos + 1:pos + 1 + gif[pos]])
                pos += 1 + gif[pos]
            pos += 1
            if label == 0xFF and blocks[0] == b"NETSCAPE2.0":
                loop = int.from_bytes(blocks[1][1:3], "little")
            elif label == 0xF9:
                delays.append(int.from_bytes(blocks[0][1:3], "little"))
        else:
            check(kind == 0x2C and gif[pos + 9] == 0 and gif[pos + 10] == 8,
                  "GIF image descriptor")
            pos, chunks = pos + 11, []
            while gif[pos]:
                chunks.append(gif[pos + 1:pos + 1 + gif[pos]])
                pos += 1 + gif[pos]
            pos += 1
            data.append(b"".join(chunks))
    check(loop == 0 and len(data) == frames and delays == [12] * frames,
          f"GIF loop {loop}, {len(data)} frames, delays {sorted(set(delays))}")
    return data


def lzw_decode(data: bytes, n: int, min_size: int = 8) -> list:
    """The first `n` palette indices of one GIF frame's LZW data."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    acc = nbits = pos = 0
    size, table, prev, out = min_size + 1, None, None, []
    while len(out) < n:
        while nbits < size:
            acc |= data[pos] << nbits
            pos, nbits = pos + 1, nbits + 8
        code, acc, nbits = acc & ((1 << size) - 1), acc >> size, nbits - size
        if code == clear:
            table = [[i] for i in range(clear)] + [None, None]
            size, prev = min_size + 1, None
            continue
        if code == end:
            break
        entry = table[code] if code < len(table) else table[prev] + [table[prev][0]]
        out.extend(entry)
        if prev is not None and len(table) < 4096:
            table.append(table[prev] + [entry[0]])
        prev = code
        if len(table) == (1 << size) and size < 12:
            size += 1
    return out[:n]


def gif_frame_std(torch, data: bytes, width: int, height: int) -> float:
    """The standard deviation of one decoded GIF frame's RGB values."""
    import numpy as np

    from tdm_tpu_torch.serve.server import gif_palette

    return float(gif_palette()[np.array(lzw_decode(data, width * height))].std())


@contextlib.contextmanager
def counted_conv_ops():
    """Inside the block, every causal conv of the 3D VAE adds its
    operations (2 a multiply-add) to the yielded one-item list."""
    from tdm_tpu_torch.models import vae3d

    ops, conv = [0], vae3d.causal_conv3d

    def counted(xp, weight, bias, kh, kw, strides=(1, 1, 1)):
        out = conv(xp, weight, bias, kh, kw, strides)
        ops[0] += 2 * out.numel() * math.prod(weight.shape[1:])
        return out

    vae3d.causal_conv3d = counted
    try:
        yield ops
    finally:
        vae3d.causal_conv3d = conv


def vae3d_conv_ops(torch, pipe, shape) -> int:
    """The operations of the causal convs of one tiled decode of latents of
    `shape`, counted as they run on the meta device (shapes only, no
    arithmetic)."""
    from tdm_tpu_torch.models import vae3d

    with counted_conv_ops() as ops, torch.inference_mode():
        vae3d.decode_tiled(vae3d.VAE3DDecoder(pipe.vae_cfg, device="meta"),
                           torch.zeros(shape, device="meta"), tile=pipe.vae_tile,
                           overlap=pipe.vae_tile_overlap,
                           spatial_factor=pipe.vae_cfg.spatial_factor)
    return ops[0]


ENCODE_SHAPE = (1, 3, 9, 480, 720)  # one 9-frame clip at CogVideoX-2B's 480×720
ENCODER_TOL = 1e-4  # max |card − CPU| over the output's largest |value|, fp32 both


def vae3d_encoder_check(torch, seed: int) -> dict:
    """VAE3DEncoder at CogVideoX-2B's widths ((128, 256, 256, 512), 3
    ResBlocks a stage, 4× temporal and 8× spatial strides) with seeded
    weights: a 9-frame 32×48 clip on the card against the CPU (fp32 both,
    TF32 off; within ENCODER_TOL of the output's scale), then one 9-frame
    480×720 encode (→ 3 latent frames of 60×90) timed by CUDA events after
    a warm-up, its convolutions' operations (reckoned on the meta device)
    and the peak memory it adds."""
    from tdm_tpu_torch.device import set_fp32_precision
    from tdm_tpu_torch.models import vae3d

    set_fp32_precision()
    cfg = vae3d.VAE3DConfig()
    check((tuple(cfg.block_widths), cfg.layers_per_block, cfg.latent_channels,
           cfg.temporal_factor, cfg.spatial_factor) == ((128, 256, 256, 512), 3, 16, 4, 8),
          "CogVideoX-2B's 3D VAE config")
    torch.manual_seed(seed + 41)  # torch's default init, from the seed
    cpu = vae3d.VAE3DEncoder(cfg, device="cpu")
    enc = vae3d.VAE3DEncoder(cfg, device="cuda")
    enc.load_state_dict(cpu.state_dict())
    n_params = sum(p.numel() for p in enc.parameters())
    gen = torch.Generator().manual_seed(seed + 42)
    clip = torch.rand(1, 3, 9, 32, 48, generator=gen) * 2 - 1
    with torch.no_grad():
        ref = cpu(clip)
        got = enc(clip.cuda())
    err = max(float((g.cpu() - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))
    check(all(g.shape == (1, 16, 3, 4, 6) for g in got), f"encoder output {got[0].shape}")
    check(err <= ENCODER_TOL, f"VAE3DEncoder on the card against the CPU: {err} of the scale")
    del cpu, ref, got
    with counted_conv_ops() as ops, torch.no_grad():
        vae3d.VAE3DEncoder(cfg, device="meta")(torch.zeros(ENCODE_SHAPE, device="meta"))
    video = torch.rand(ENCODE_SHAPE, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed + 43)) * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.no_grad():
        ev[0].record()
        enc(video)
        ev[1].record()
        mean, logvar = enc(video)
        ev[2].record()
    torch.cuda.synchronize()
    ms = [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])]
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    check(mean.shape == logvar.shape == (1, 16, 3, 60, 90)
          and bool(torch.isfinite(mean).all() and torch.isfinite(logvar).all()),
          f"the 9-frame encode gave {tuple(mean.shape)}")
    print(f"[cogvideox] VAE3DEncoder at full widths ({n_params / 1e6:.1f}M params, seeded): a "
          f"9-frame 32x48 clip on the card against the CPU {err:.2e} of the scale (limit "
          f"{ENCODER_TOL}); one 9-frame 480x720 encode -> {tuple(mean.shape)} in {ms[1]:.1f} ms "
          f"(first {ms[0]:.1f} ms) by CUDA events, {ops[0] / 1e12:.2f} TFLOP in its convs "
          f"({ops[0] / (ms[1] * 1e-3) / 1e12:.1f} TFLOP/s), peak {peak:.2f} GiB above its "
          f"{held / 2**30:.2f} GiB of weights and input", flush=True)
    del enc, video, mean, logvar
    torch.cuda.empty_cache()
    return {"params": n_params, "max_err_of_scale": err, "tol": ENCODER_TOL, "encode_ms": ms[1],
            "first_encode_ms": ms[0], "tflop": ops[0] / 1e12, "peak_gib_above_held": peak,
            "held_gib": held / 2**30, "shape": list(ENCODE_SHAPE)}


def profile_cogvideox(torch, pipe, cond, noise, **call) -> tuple[dict, object]:
    """One batch (4 NFE + the tiled 3D decode) under torch.profiler's CUDA
    activity: wall time, device busy time (the union of the kernels'
    intervals: launches of one stream may overlap, so their summed times
    can exceed the wall) and idle share, the summed kernel time, kernel
    1's device time and ms per call (by kernel name), the transformer's
    forwards and the decode by CUDA events around them, and the peak
    memory. Returns (those numbers, the batch's videos [B, F, H, W, 3] on
    the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans = {"transformer": [], "decode": []}
    saved = [(pipe.transformer, "forward"), (pipe, "decode")]

    def timed(fn, name):
        def wrapped(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            spans[name].append(ev)
            return out
        return wrapped

    pipe.transformer.forward = timed(pipe.transformer.forward, "transformer")
    pipe.decode = timed(pipe.decode, "decode")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            videos = pipe(prompt_embeds=cond, latents=noise, **call).images.cpu()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        for obj, name in saved:
            del obj.__dict__[name]
    t_post = time.monotonic()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    summed_ms = sum(e.device_time_total for e in kernels) / 1e3
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                              if e.device_type == DeviceType.CUDA):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy_ms = busy_us / 1e3
    span_ms = {n: sum(a.elapsed_time(b) for a, b in ev) for n, ev in spans.items()}
    if busy_ms == 0:
        print("[profile] no device time in the trace: not measured", flush=True)
        return {"wall_ms": wall_ms, "peak_gib": peak_gb,
                **{f"{n}_ms": v for n, v in span_ms.items()}}, videos
    flash = [e for e in kernels if "flash_fwd" in e.key]
    attn_ms = sum(e.device_time_total for e in flash) / 1e3
    calls = sum(e.count for e in flash)
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    print(f"[profile] one CogVideoX batch of {noise.shape[0]}: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms (the union of kernel intervals; idle share "
          f"{1 - busy_ms / wall_ms:.3f}; kernel times summed {summed_ms:.1f} ms); transformer "
          f"{span_ms['transformer']:.1f} ms over {len(spans['transformer'])} forwards, kernel 1 "
          f"{attn_ms:.1f} ms over {calls} calls ({attn_ms / max(calls, 1):.3f} ms a call), 3D "
          f"decode {span_ms['decode']:.1f} ms ({span_ms['decode'] / busy_ms:.3f} of busy) by "
          f"CUDA events; peak {peak_gb:.2f} GiB; {sum(e.count for e in kernels)} launches; "
          f"trace read in {time.monotonic() - t_post:.1f}s", flush=True)
    for e in top:
        print(f"[profile]   {e.device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}",
              flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "summed_kernel_ms": summed_ms, "attention_ms": attn_ms, "attention_calls": calls,
            "attention_ms_per_call": attn_ms / max(calls, 1),
            "transformer_ms": span_ms["transformer"], "decode_ms": span_ms["decode"],
            "peak_gib": peak_gb, "launches": sum(e.count for e in kernels)}, videos


@contextlib.contextmanager
def attention_by_head():
    """Every attention call of the models computed by the plain version one
    head at a time (here only: a comparison, not the main path)."""
    import torch

    from tdm_tpu_torch.models import layers

    kernel_attention = layers.fused_attention

    def by_head(q, k, v, key_mask=None, **kw):
        return torch.cat([kernel_attention(q[:, h:h + 1].contiguous(), k[:, h:h + 1].contiguous(),
                                           v[:, h:h + 1].contiguous(), key_mask,
                                           **{**kw, "impl": "plain"})
                          for h in range(q.shape[1])], dim=1)

    layers.fused_attention = by_head
    try:
        yield
    finally:
        layers.fused_attention = kernel_attention


def cogvideox_forward_check(torch, transformer, seed: int) -> float:
    """One full-width CogVideoX-2B forward (batch 1, 49 frames at 480×720,
    the served LoRA merged) through kernel 1 against the same forward with
    attention computed plainly head by head, both on the card: bf16 through
    30 blocks, so the check is relative (L2 error under 2%)."""
    import numpy as np

    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 31)
    lat = torch.from_numpy(rng.standard_normal((1, 16, 13, 60, 90)).astype(np.float32)).cuda()
    text = torch.from_numpy(rng.standard_normal((1, COG_TXT, 4096)).astype(np.float32)).cuda()
    t = torch.tensor([856], device="cuda")
    before = A.launch_counts()
    with torch.inference_mode():
        out = transformer(lat, t, text).float()
        with attention_by_head():
            ref = transformer(lat, t, text).float()
    for w in A.WRAPPERS:  # a check, not the main path
        w.launches = before[w.__name__]
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[cogvideox] full-width forward [1,16,13,60,90], kernel 1 vs plain attention head "
          f"by head: rel L2 {rel:.3e}, finite {bool(torch.isfinite(out).all())}", flush=True)
    check(bool(torch.isfinite(out).all()) and rel < 2e-2,
          f"full-width CogVideoX forward disagrees: rel L2 {rel}")
    return rel


def conv3d_route_check(torch, seed: int) -> dict:
    """The 3D VAE's largest causal conv, 256 → 128 channels over 49 frames
    at 256×256 (fp32, TF32 off), by the decoder's route (one conv2d per
    temporal tap, summed) three times, bit for bit, and by cuDNN's 3D
    convolution (`F.conv3d`, a yardstick the decoder never calls) on the
    same padded input: their agreement, each one's repeatability and time
    (CUDA events, mean of 3 after one warm-up)."""
    import torch.nn.functional as F

    from tdm_tpu_torch.models import vae3d

    gen = torch.Generator(device="cuda").manual_seed(seed + 37)
    xp = torch.randn(1, 51, 256, 256, 256, generator=gen, device="cuda")
    w = torch.randn(128, 256, 3, 3, 3, generator=gen, device="cuda") / (27 * 256) ** 0.5
    bias = torch.randn(128, generator=gen, device="cuda")
    x3 = xp.permute(0, 2, 1, 3, 4).contiguous()  # N, C, D, H, W
    with torch.inference_mode():
        outs = [vae3d.causal_conv3d(xp, w, bias, 3, 3) for _ in range(3)]
        lib = [F.conv3d(x3, w, bias, padding=(0, 1, 1)) for _ in range(2)]
        route_ms = time_ms(torch, lambda: vae3d.causal_conv3d(xp, w, bias, 3, 3), 3, 1)
        lib_ms = time_ms(torch, lambda: F.conv3d(x3, w, bias, padding=(0, 1, 1)), 3, 1)
    same = all(torch.equal(outs[0], o) for o in outs[1:])
    lib_same = torch.equal(lib[0], lib[1])
    ref = lib[0].permute(0, 2, 1, 3, 4)
    rel = ((outs[0] - ref).norm() / ref.norm()).item()
    ops = 2 * outs[0].numel() * 256 * 27
    print(f"[cogvideox] causal conv 256->128 [1,49,256,256] fp32: per-tap conv2d route "
          f"{route_ms:.1f} ms ({ops / route_ms / 1e9:.1f} TFLOP/s), 3 calls the same bits: "
          f"{same}; F.conv3d (cuDNN, yardstick) {lib_ms:.1f} ms, 2 calls the same bits: "
          f"{lib_same}; rel L2 between them {rel:.2e}", flush=True)
    check(same, "the decoder's causal conv gave other bits on a repeated call")
    check(rel < 1e-5, f"the per-tap causal conv disagrees with F.conv3d: rel L2 {rel}")
    return {"route_ms": route_ms, "conv3d_ms": lib_ms, "route_repeatable": same,
            "conv3d_repeatable": lib_same, "rel_l2": rel, "tflop": ops / 1e12}


def phase_cogvideox(torch, seed: int, workdir: str) -> dict:
    """CogVideoX-2B served over HTTP from a full-width diffusers checkout
    with a seeded rank-64 kohya LoRA merged at scale 1, --num_frames 49 at
    480×720, batch 2: two concurrent requests (one batch) and one of them
    alone; GIF structure, frames that are not constant, per-seed
    determinism, exactly 120 kernel-1 launches and nothing else per batch;
    a profiled batch (a video's decode timed in it), the GIF encode time, one
    full-width forward against plain attention head by head, and the 3D
    VAE's encoder at full widths (`vae3d_encoder_check`)."""
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    import numpy as np

    from tdm_tpu_torch.data.tokenizer import HashTokenizer
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.lora import adapter, io as lora_io
    from tdm_tpu_torch.models import cogvideox as cog, vae3d
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.serve import server as S

    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    root, write_s, n_params = cogvideox_checkout(torch, workdir, seed)
    cache, prompts = t5_cache(workdir, seed)
    lora_file = os.path.join(workdir, "cogvideox_tdm_lora.safetensors")
    lora = seeded_lora(torch, cog.CogVideoXTransformer3D(device="meta"), 64, seed)
    lora_io.save_kohya(lora, lora_file)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    args = S.parse_args(["--model", cache_served_view(root), "--lora", lora_file,
                         "--lora_scale", "1", "--num_frames", "49", "--embedding_cache", cache,
                         "--port", "0",
                         "--batch_size", "2", "--max_delay_ms", "1000"])
    with timed_calls(torch, load_targets() + [(convert, "cogvideox_params"),
                                              (convert, "vae3d_decoder_params")]) as times:
        server = S.build_server(args).start()
    up_s = time.monotonic() - t0
    load = load_report(times)
    stats, pipe = server.batcher.stats, server.batcher.pipe
    check(pipe.family == "cogvideox" and pipe.transformer.cfg == cog.CogVideoXConfig()
          and isinstance(pipe.vae_decoder, vae3d.VAE3DDecoder)
          and pipe.vae_cfg == vae3d.VAE3DConfig() and pipe._active == (("tdm", 1.0),)
          and (pipe.vae_tile, pipe.vae_tile_overlap) == (32, 4),
          "the served CogVideoX-2B checkout")
    adapted = len(adapter.adapted_keys(lora, from_jax.layer_stacks(pipe.transformer.cfg)))
    print(f"[cogvideox] CogVideoX-2B checkout with a rank-64 LoRA ({len(lora.params)} targets, "
          f"{adapted} weights) loaded in {load['load_s']:.2f}s (safetensors read "
          f"{load['read_s']:.2f}s, conversion {load['convert_s']:.3f}s, modules and copy to the "
          f"card {load['build_and_copy_s']:.2f}s); server up in {up_s:.1f}s "
          f"({time.monotonic() - t_phase:.1f}s into the phase)", flush=True)

    def post(prompt, seed):
        body = json.dumps({"prompt": prompt, "seed": seed}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        t = time.monotonic()
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
        return out, time.monotonic() - t

    try:
        # the main path: counts to 0, two concurrent requests, then one alone
        A.reset_launches()
        b0 = stats.batches
        t0 = time.monotonic()
        with ThreadPoolExecutor(2) as ex:
            pair = list(ex.map(lambda i: post(prompts[i], 700 + i), range(2)))
        wall2 = time.monotonic() - t0
        pair_batch_s = stats.last_batch_latency_s
        solo = [post(prompts[0], 700)]
        launches = A.launch_counts()
        batches = stats.batches - b0
    finally:
        server.close()
    serve_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(pipe.text_encoder is None, "the cache-served view attached no T5")
    stds = []
    for reply, _ in pair + solo:
        check(reply.get("format") == "gif" and reply.get("shape") == [49, 480, 720, 3],
              f"reply {str(reply)[:200]}")
        data = check_gif(base64.b64decode(reply["video"]), 49, 720, 480)
        stds += [gif_frame_std(torch, data[i], 720, 480) for i in (0, 48)]
    check(min(stds) > 1.0, f"a served frame is (nearly) constant: RGB std {min(stds)}")
    check(batches == 2, f"3 requests ran as {batches} batches")
    check(solo[0][0]["video"] == pair[0][0]["video"],
          "the same (prompt, seed) gave other GIF bytes in a batch of 2 than alone")
    check(pair[0][0]["video"] != pair[1][0]["video"], "distinct seeds gave equal videos")
    check(launches["flash_attention_fwd"] == COG_LAUNCHES_PER_BATCH * batches
          and sum(launches.values()) == launches["flash_attention_fwd"],
          f"launches {launches} over {batches} batches, expected {COG_LAUNCHES_PER_BATCH} "
          f"flash_fwd and nothing else per batch")
    lat = [t for _, t in pair]
    print(f"[cogvideox] 2 concurrent requests in {wall2:.2f}s as one batch of 2 (latency "
          f"{min(lat):.2f}-{max(lat):.2f}s, batch {pair_batch_s:.2f}s dispatch to readback); "
          f"alone {solo[0][1]:.2f}s; GIFs 49x720x480, frame RGB std "
          f"{min(stds):.1f}-{max(stds):.1f}; same (prompt, seed) -> same GIF bytes alone "
          f"and in the batch; launches {launches} = {COG_LAUNCHES_PER_BATCH} flash_fwd x "
          f"{batches} batches ({time.monotonic() - t_phase:.1f}s into the phase)", flush=True)
    cond = torch.from_numpy(np.concatenate([server.batcher.cond_fn(prompts[1])] * 2))
    noise = torch.randn(2, 16, 13, 60, 90)
    # one video, not the served batch of 2: a video's decode takes ~10 s
    # (the smoke's clock); the batch's time is the served pair's above
    prof, videos = profile_cogvideox(torch, pipe, cond[:1], noise[:1], num_frames=49,
                                     height=480, width=720)
    # the decode in the profiled batch, one video at a time: a video's time
    # and operations (the route's repeatability is conv3d_route_check's, and
    # the same GIF bytes alone and in a batch); the GIF encode of video 0
    t0 = time.monotonic()
    gif = S.encode_gif(videos[0].numpy())
    gif_s = time.monotonic() - t0
    n_videos = len(videos)
    del videos
    ops = vae3d_conv_ops(torch, pipe, (1, *noise.shape[1:]))
    dec_ms = prof["decode_ms"] / n_videos
    print(f"[cogvideox] 3D decode (8 tiles of 32x32 latents a video, 13 -> 49 frames, fp32) "
          f"in the profiled batch: {prof['decode_ms']:.1f} ms by CUDA events for "
          f"{n_videos} video(s), {dec_ms:.1f} ms a video; {ops / 1e12:.1f} TFLOP a video "
          f"in its convs ({ops / (dec_ms * 1e-3) / 1e12:.1f} TFLOP/s); GIF encode "
          f"{gif_s:.2f}s on the host ({len(gif) / 1e6:.1f} MB) "
          f"({time.monotonic() - t_phase:.1f}s into the phase)", flush=True)
    rel = cogvideox_forward_check(torch, pipe.transformer, seed)
    conv = conv3d_route_check(torch, seed)
    # int8 at the served batch and width, 13 frames (4 latent frames): the
    # smoke's clock; an int8 batch at 49 frames takes 5.1 s against 2.8
    gated = reckon_gated(torch, cog.CogVideoXTransformer3D(device="meta"), (2, 16, 4, 60, 90),
                         (2,), (2, 226, 4096))[1]
    int8 = int8_serving(
        torch, "cogvideox", pipe, cond, torch.randn(2, 16, 4, 60, 90),
        torch.from_numpy(np.concatenate([server.batcher.cond_fn(prompts[2])] * 2)),
        torch.randn(2, 16, 4, 60, 90), gated_per_forward=gated, forwards=4,
        wrapper="flash_attention_fwd", call=dict(num_frames=13), images=False)
    server.batcher.pipe = None
    del pipe
    torch.cuda.empty_cache()
    print(f"[cogvideox] serving peak device memory {serve_peak_gib:.2f} GiB from the cache, "
          f"no encoder resident", flush=True)
    gif = generate_gif(torch, cache_served_view(root), cache, prompts[0], workdir)
    tok = HashTokenizer()

    def t5_report(p):
        ids, mask = tok(ENC_PROMPTS[:2], max_length=p.transformer.cfg.max_text_len)
        return encoder_report(torch, "T5-XXL (CogVideoX, 226 tokens)", p.text_encoder, ids,
                              mask, against_fp32=False)

    raw = raw_prompt_batch(
        torch, root, "cogvideox", tok,
        dict(prompt=ENC_PROMPTS[:2], latents=noise, num_frames=49, output_type="latent"),
        COG_LAUNCHES_PER_BATCH, t5_report, warm=False)
    release_encoder(torch, workdir, seed, "t5", os.path.join(root, "text_encoder"))
    encoder = vae3d_encoder_check(torch, seed)
    phase_s = time.monotonic() - t_phase
    print(f"[cogvideox] phase in {phase_s:.1f}s", flush=True)
    return {"load": load, "up_s": up_s, "checkout_write_s": write_s, "params": n_params,
            "lora_targets": len(lora.params), "lora_weights": adapted,
            "launches": launches["flash_attention_fwd"],
            "batches": batches, "launches_per_batch": COG_LAUNCHES_PER_BATCH,
            "wall2_s": wall2, "videos_per_min": 2 / wall2 * 60, "batch_s": pair_batch_s,
            "solo_s": [t for _, t in solo], "profile": prof, "decode_ms": dec_ms,
            "decode_tflop": ops / 1e12, "gif_encode_s": gif_s, "gif_mb": len(gif) / 1e6,
            "forward_rel_l2": rel, "conv_route": conv, "phase_s": phase_s,
            "serve_peak_gib": serve_peak_gib, "raw_prompts": raw, "int8": int8,
            "generate_gif": gif, "vae3d_encoder": encoder}


# ---------------------------------------------------------------------------
# CogVideoX-2B training: the recipe's flags at 49 frames, 480×720
# ---------------------------------------------------------------------------


def cog_train_env(seed: int, workdir: str) -> str:
    """A seeded full-width T5 embedding cache as $TDM_EMBEDDING_CACHE: 8
    prompts of 226 tokens at 4096 with ragged masks (CogVideoX zeroes the
    rows past them) and the empty prompt's embedding (one live token); and
    a seeded TAESD3 as $TDM_TAESD_DIR, which a video run must leave
    unread (TAESD decodes no video latent). Returns the cache's path."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache

    rng = np.random.default_rng(seed + 30)
    lengths = np.array([226, 120, 57, 13, 226, 1, 90, 200])
    cache = os.path.join(workdir, "cog_train_cache.npz")
    EmbeddingCache(
        rng.standard_normal((8, COG_TXT, 4096)).astype(np.float16),
        (np.arange(COG_TXT)[None] < lengths[:, None]).astype(np.int32),
        [f"cogvideox train prompt {i}" for i in range(8)],
        uncond_embed=(0.1 * rng.standard_normal((COG_TXT, 4096))).astype(np.float16),
        uncond_mask=(np.arange(COG_TXT) < 1).astype(np.int32),
    ).save(cache)
    os.environ.pop("TDM_TINY_MODEL", None)
    os.environ["TDM_EMBEDDING_CACHE"] = cache
    os.environ["TDM_TAESD_DIR"] = taesd3_dir(workdir, seed)
    return cache


def cogvideox_remat_check(torch, seed: int, teacher_dir: str) -> dict:
    """One CogVideoX TDM step at full width and S (1920 wide, 30×64 heads,
    latents [1, 16, 13, 60, 90], 226 T5 tokens) cut to the checkout's first
    2 blocks, batch 1, bf16 on fp32 masters, dmd, AdamW, three times from
    one state on one batch: without remat, with remat, with remat again.
    The models are the bundle's (its denoise_fn puts the weights into the
    3D DiT by functional_call; its schedule; its cond_of). Remat recomputes
    each block through the same kernels, none of which uses atomics, so the
    metrics and every updated tensor of student and critic are checked bit
    for bit against the run without remat, and the second remat run
    against the first. 30 blocks at batch 2 without remat do not fit."""
    import dataclasses

    from torch.func import functional_call

    from tdm_tpu_torch.core import schedules as sched
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.models import cogvideox as cog
    from tdm_tpu_torch.train import families, tdm

    full = families.build("cogvideox", num_frames=49, mixed_precision="bf16", device="meta")
    cfg = dataclasses.replace(full.model.cfg, num_layers=2)
    flat = {k: v for k, v in convert.flatten(convert.cogvideox_params(
        convert.load_torch_state_dict(teacher_dir), scan_layers=False)).items()
        if not k.startswith("blocks_") or int(k.split("/")[0][7:]) < cfg.num_layers}
    models = {r: cog.CogVideoXTransformer3D(dataclasses.replace(cfg, remat=r), device="cuda",
                                            param_dtype=torch.float32).requires_grad_(False)
              for r in (False, True)}
    teacher = {k: v.to("cuda", torch.float32)
               for k, v in from_jax.state_dict_from_jax(flat, models[False]).items()}
    shape = full.sample_shape
    gen = torch.Generator(device="cpu").manual_seed(seed + 31)
    draws = tdm.StepDraws(*(x.cuda() for x in tdm.make_draws(tdm.TDMConfig(), 1, shape, gen,
                                                               "cpu")))
    text = torch.randn(1, COG_TXT, 4096, generator=gen).cuda()
    mask = (torch.arange(COG_TXT) < 100).int()[None].cuda()
    cond = full.cond_of(text, mask)
    uncond = full.cond_of(torch.zeros_like(text), torch.ones_like(mask))

    def denoise_fn(model):  # the bundle's denoise_fn over `model`
        return lambda params, x, t, c: functional_call(model, params, (x, t, c))

    report = remat_steps(torch, {r: denoise_fn(m) for r, m in models.items()}, teacher,
                         sched.cogvideox(device="cuda"), shape, (draws, cond, uncond),
                         "cogvideox")
    del teacher, models
    torch.cuda.empty_cache()
    n = cfg.num_layers
    check(report["plain_launches"]["flash_attention_fwd_lse"] == 2 * n
          and report["remat_launches"]["flash_attention_fwd_lse"] == 4 * n
          and report["remat_launches"]["flash_attention_bwd_dq"] == 2 * n,
          f"cogvideox remat check launches {report['plain_launches']}, "
          f"{report['remat_launches']}")
    print(f"[train_cogvideox] full-width step at 2 blocks, batch 1, one batch: remat vs plain "
          f"{report['remat_vs_plain']}, remat twice {report['repeat']} (host "
          f"{report['plain_s']:.2f}s plain, {report['remat_s']:.2f}s remat, first calls; lse "
          f"forwards {report['plain_launches']['flash_attention_fwd_lse']} plain, "
          f"{report['remat_launches']['flash_attention_fwd_lse']} with the recompute)",
          flush=True)
    return report


def cogvideox_lora_latents(torch, root: str, lora_path: str, seed: int) -> dict:
    """The trained kohya LoRA loaded back into the CogVideoX pipeline of
    the checkout: every key resolved to a kernel of the 3D DiT and merged at
    1.0; one 4-NFE latent [1, 16, 13, 60, 90] (no decode) with it and one
    without it from the same noise and T5 rows: finite, and not the same."""
    from tdm_tpu_torch.io import from_jax
    from tdm_tpu_torch.lora import adapter, io as lora_io
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import from_pretrained

    pipe = from_pretrained(root)
    lora = lora_io.load_lora(lora_path, model=pipe.transformer)
    adapted = adapter.adapted_keys(lora, from_jax.layer_stacks(pipe.transformer.cfg))
    gen = torch.Generator().manual_seed(seed + 32)
    call = dict(prompt_embeds=torch.randn(1, COG_TXT, 4096, generator=gen),
                latents=torch.randn(1, 16, 13, 60, 90, generator=gen), num_frames=49,
                output_type="latent")

    def without_and_with():
        base = pipe(**call).latents
        pipe.load_lora_weights(lora_path, adapter_name="tdm")
        pipe.set_adapters(["tdm"], [1.0])
        return base, pipe(**call).latents

    (base, tuned), _ = uncounted(A, without_and_with)  # a check, not the main path
    rel = float((tuned.float() - base.float()).norm() / base.float().norm())
    check(bool(torch.isfinite(tuned).all()) and bool(torch.isfinite(base).all()),
          "a CogVideoX latent with the trained LoRA is not finite")
    check(not torch.equal(tuned, base), "the trained LoRA left the 4-NFE latent unchanged")
    del pipe
    torch.cuda.empty_cache()
    return {"adapted_weights": len(adapted), "latent_rel_l2_vs_base": rel}


def _flash_launch_check(kernels: dict, want: dict) -> dict:
    """The flash kernels of a profiled step by template arguments
    (_flash_by_dim), checked against `want`: the wrappers' launches of one
    step, all at padded head dim 64 (the forward <64, lse>; dK/dV one
    launch a call there)."""
    by = _flash_by_dim(kernels)
    fwd = by.get("flash_fwd_sm90_kernel", {})
    dkv = by.get("flash_bwd_dkv_sm90_kernel", {})
    got = {"flash_attention_fwd": fwd.get("64,false", 0),
           "flash_attention_fwd_lse": fwd.get("64,true", 0),
           "flash_attention_bwd_dq": by.get("flash_bwd_dq_sm90_kernel", {}).get("64", 0),
           "flash_attention_bwd_dkv": sum(n for a, n in dkv.items() if a.startswith("64,"))}
    check(got == {k: want[k] for k in got} and sum(fwd.values()) == got["flash_attention_fwd"]
          + got["flash_attention_fwd_lse"] and sum(dkv.values()) == got["flash_attention_bwd_dkv"],
          f"profiled step: flash kernels by template arguments {by}, expected {want}")
    return by


def phase_train_cogvideox(torch, seed: int, workdir: str) -> dict:
    """Full-width CogVideoX-2B TDM training through the CLI's main() with
    the recipe's flags: --model_family cogvideox --num_frames 49 (latents
    [16, 13, 60, 90], 17,550 video + 226 T5 tokens), batch 2 (the video
    pipeline's), bf16 compute on fp32 masters, dmd, a rank-64 LoRA student,
    8-bit Adam, --gradient_checkpointing, 3 optimizer steps without LR
    warm-up (so 3 steps move the factors); the teacher read from the
    transformer/ folder of the CogVideoX-2B checkout (written here if the
    cogvideox phase did not run; its load timed by part); a seeded T5 cache
    with ragged masks; $TDM_TAESD_DIR set to a TAESD3 that the video run
    must leave unread (validation every 2 steps; no grid). First the remat
    check (cogvideox_remat_check). Per step: host and CUDA-event times and
    the kernels' launches (checked against COG_TRAIN_LAUNCHES); step 3
    under torch.profiler (device busy time, idle share, the top device
    operations, the flash kernels by template arguments, checked). Then
    the rank-64 kohya LoRA loaded back into the checkout's pipeline
    (cogvideox_lora_latents)."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.ops import attention as A

    t_phase = time.monotonic()
    root, write_s, _ = cogvideox_checkout(torch, workdir, seed)
    teacher_dir = os.path.join(root, "transformer")
    remat = cogvideox_remat_check(torch, seed, teacher_dir)
    cog_train_env(seed, workdir)
    out = os.path.join(workdir, "train_cogvideox")
    steps = []
    load_parts = teacher_load_parts("cogvideox_params")
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 2**30  # by earlier phases, before main()
    A.reset_launches()  # the main path from here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        with timed_calls(torch, load_parts) as load_times, no_final_checkpoint(), \
                no_student_export():
            train_tdm.main([
                "--output_dir", out, "--model_family", "cogvideox", "--num_frames", "49",
                "--max_train_steps", str(COG_TRAIN_STEPS), "--train_batch_size",
                str(COG_TRAIN_B), "--mixed_precision", "bf16", "--loss_mode", "dmd",
                "--gradient_checkpointing", "--train_lora_rank", str(COG_LORA_RANK),
                "--use_8bit_adam", "--lr_warmup_steps", "0", "--validation_steps", "2",
                "--seed", str(seed), "--pretrained_model_name_or_path", teacher_dir,
            ], step_hook=step_hook(torch, steps, 3, "train_cogvideox"))
    finally:
        os.environ.pop("TDM_TAESD_DIR", None)
    total_s = time.monotonic() - t0
    launches = A.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(set(load_times) == {name for _, name in load_parts},
          f"the teacher was not loaded from {teacher_dir}: {load_times}")
    check(len(steps) == COG_TRAIN_STEPS, f"{len(steps)} cogvideox steps ran")
    for rec in steps:
        check(rec["launches"] == COG_TRAIN_LAUNCHES,
              f"cogvideox step {rec['step']} launches {rec['launches']}, expected "
              f"{COG_TRAIN_LAUNCHES}")
        check(all(math.isfinite(v) for v in rec["metrics"].values()),
              f"cogvideox step {rec['step']}: non-finite metrics {rec['metrics']}")
    by_template = None
    if steps[2].get("flash_kernels"):  # the profiler saw the device
        by_template = _flash_launch_check(steps[2]["flash_kernels"], COG_TRAIN_LAUNCHES)
        print(f"[train_cogvideox] profiled step 3: flash kernels by template arguments "
              f"{by_template} (checked against {COG_TRAIN_LAUNCHES})", flush=True)
    run_dir = out + "_cfg4.5_steps900"
    grids = [f for f in os.listdir(run_dir) if f.startswith("validation")]
    check(not grids, f"a video run wrote validation grids {grids}")
    check(not any(f.startswith("checkpoint-") for f in os.listdir(run_dir)),
          "train_cogvideox wrote a checkpoint")
    lora_path = os.path.join(run_dir, "tdm_lora.safetensors")
    pieces = kohya_pieces(torch, lora_path, COG_LORA_RANK)
    torch.cuda.empty_cache()
    lora = cogvideox_lora_latents(torch, root, lora_path, seed)
    check(lora["adapted_weights"] == pieces,
          f"the kohya file's {pieces} pieces: {lora['adapted_weights']} resolved")
    print(f"[disk] {shutil.disk_usage(run_dir).used / 2**30:.1f} GiB used with "
          f"the run's files, before their removal", flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)
    plain = [r["host_s"] for r in steps[1:] if r["busy_ms"] is None]
    per_step = sum(plain) / len(plain)
    busy = steps[2]["busy_ms"]
    # the profiled step's own CUDA-event span: its kernels run milliseconds
    # each, so the unprofiled step 2's span can be shorter than step 3's busy
    span = steps[2]["event_ms"]
    idle = None if not busy else 1 - busy / span
    load_s, parts = teacher_load_report(load_times, "cogvideox_params")
    phase_s = time.monotonic() - t_phase
    print(f"[train_cogvideox] teacher from {teacher_dir}: loaded in {load_s:.2f}s ({parts})",
          flush=True)
    print(f"[train_cogvideox] CogVideoX-2B TDM at 49x480x720 (dmd, batch {COG_TRAIN_B}, bf16 "
          f"on fp32 masters, rank-{COG_LORA_RANK} LoRA student, 8-bit Adam, gradient "
          f"checkpointing, seeded weights): {per_step:.3f} s/step after the first, "
          f"unprofiled (step 2; {3600 / per_step:.0f} iters/hour), first step "
          f"{steps[0]['host_s']:.3f} s, profiled step 3 {steps[2]['host_s']:.3f} s; peak "
          f"memory {peak_gb:.2f} GiB ({held_gb:.2f} GiB of it held before main()); launches "
          f"per step {COG_TRAIN_LAUNCHES} (checked); step "
          f"2 CUDA-event span {steps[1]['event_ms']:.1f} ms; step 3 span {span:.1f} ms, busy "
          + (f"{busy:.1f} ms -> idle share {idle:.4f}" if busy else "not measured")
          + f", {steps[2].get('all_launches')} device launches; no validation grid (video); "
          f"kohya file {pieces} rank-{COG_LORA_RANK} pieces, every one resolved and merged by "
          f"the pipeline, its 4-NFE latent {lora['latent_rel_l2_vs_base']:.3e} (rel L2) from "
          f"the base's; main() {total_s:.1f}s (no final checkpoint: `no_final_checkpoint`); phase "
          f"{phase_s:.1f}s", flush=True)
    return {"s_per_step": per_step, "iters_per_hour": 3600 / per_step,
            "first_step_s": steps[0]["host_s"], "peak_gib": peak_gb,
            "held_before_main_gib": held_gb, "idle_share": idle,
            "busy_ms": busy, "event_span_ms": span,
            "all_launches_per_step": steps[2].get("all_launches"),
            "flash_kernels_by_template": by_template, "launches": launches,
            "launches_per_step": COG_TRAIN_LAUNCHES, "load_s": load_s, "load": load_times,
            "kohya_pieces": pieces, "lora": lora, "checkpoint_gb": None, "main_s": total_s,
            "checkout_write_s": write_s, "remat_check": remat, "phase_s": phase_s,
            "steps": steps}


# ---------------------------------------------------------------------------
# int8 and the offline verbs: --quant int8 in serving, --quant_forwards in
# training, cli/generate, cli/evaluate with the CLIP score
# ---------------------------------------------------------------------------

INT8_REL_BOUND = 0.15  # the JAX package's bound of int8 latents against bf16 (tests/test_quant.py)


def reckon_gated(torch, model, *shapes, int_arg: int | None = None) -> tuple[int, int]:
    """(Dense calls, calls the int8 gate admits) in one forward of `model`
    (a module built on the meta device) at the input `shapes`: the shapes
    alone decide (tokens = the product of an input's leading dims, K and N
    from the layer), so the forward runs on meta tensors, with the
    attention replaced by its output shape. `int_arg` is the index of an
    int32 input (a mask)."""
    from tdm_tpu_torch.models import layers
    from tdm_tpu_torch.ops import quant

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: calls.append((math.prod(a[0].shape[:-1]), m.in_features, m.out_features)))
        for m in model.modules() if isinstance(m, layers.Dense)]
    attention = layers.fused_attention
    layers.fused_attention = lambda q, k, v, key_mask=None, **kw: torch.empty_like(q)
    t0 = time.monotonic()
    try:
        args = [torch.empty(s, device="meta",
                            dtype=torch.int32 if i == int_arg else torch.float32)
                for i, s in enumerate(shapes)]
        with torch.no_grad():
            model(*args)
    finally:
        layers.fused_attention = attention
        for h in hooks:
            h.remove()
    gated = sum(quant.gate(*c) for c in calls)
    print(f"[int8] {type(model).__name__} at {shapes[0]}: {gated} of {len(calls)} Dense calls "
          f"a forward pass the gate (reckoned on the meta device in "
          f"{time.monotonic() - t0:.1f}s)", flush=True)
    return len(calls), gated


def _rows(torch, keep, other):
    """Conditioning with row 0 of `keep` and the other rows of `other` (a
    tuple of arrays or tensors, or one)."""
    if isinstance(keep, (tuple, list)):
        return tuple(_rows(torch, a, b) for a, b in zip(keep, other))
    a, b = torch.as_tensor(keep), torch.as_tensor(other)
    return torch.cat([a[:1], b[1:].to(a.device)])


def profile_int8(torch, pipe, cond, noise, call: dict) -> tuple:
    """One int8 sampler run (latents out) with its first denoiser forward
    under torch.profiler (one forward: the profiler's own cost grows with
    the tens of thousands of eager ops an int8 batch launches). Returns the
    latents and, for that forward, the `aten::_int_mm` calls and their
    device ms, the device ms of everything a rerouted Dense runs (a
    record_function range around `quant.dense`: the casts, the quantize
    passes, the product, the rescale and the bias), and the busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tdm_tpu_torch.ops import quant

    dense, denoiser, held = quant.dense, pipe.denoiser, {}
    forward = denoiser.forward

    def ranged(*args, **kw):
        with record_function("int8_dense"):
            return dense(*args, **kw)

    def first_profiled(*args, **kw):
        if "prof" in held:
            return forward(*args, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = forward(*args, **kw)
            torch.cuda.synchronize()
        held["prof"] = prof
        return out

    quant.dense, denoiser.forward, pipe.quant = ranged, first_profiled, "int8"
    try:
        latents = pipe(prompt_embeds=cond, latents=noise, output_type="latent", **call).latents
    finally:
        quant.dense, pipe.quant = dense, None
        del denoiser.forward
    ev = held["prof"].key_averages()
    busy = sum(e.device_time_total for e in ev if e.device_type == DeviceType.CUDA) / 1e3
    by = {e.key: e for e in ev if e.device_type == DeviceType.CPU}
    mm, rng = by.get("aten::_int_mm"), by.get("int8_dense")
    if not busy or mm is None:
        return latents, {"int_mm_calls": mm.count if mm else 0, "busy_ms": None}
    mm_ms = mm.device_time_total / 1e3
    dot_ms = rng.device_time_total / 1e3 if rng else None
    return latents, {"int_mm_calls": mm.count, "int_mm_ms": mm_ms, "int8_dense_ms": dot_ms,
                     "quant_rescale_ms": None if dot_ms is None else dot_ms - mm_ms,
                     "busy_ms": busy,
                     "quant_rescale_share": None if dot_ms is None else (dot_ms - mm_ms) / busy}


def int8_serving(torch, tag: str, pipe, cond, noise, other_cond, other_noise, *,
                 gated_per_forward: int, forwards: int, wrapper: str, call=None,
                 images: bool = True) -> dict:
    """One family's batch at `pipe.quant = "int8"` against bf16 on the
    served pipeline (same conditioning, same noise, latents out): the int8
    products per batch (the wrapper's count, and `aten::_int_mm` in a
    profiled batch) against `gated_per_forward` × `forwards`, the attention
    wrapper's launches unchanged, the bf16 bits unchanged after int8
    batches, row 0's int8 bits the same with other batch-mates, the
    latents' relative L2 against bf16 under 0.15; the sampler's device ms
    (CUDA events at the ends of the pipeline's sampler scope) and the
    batch's wall ms (host clock, the decode included when `images`) of the
    same 3 batches at bf16, int8, bf16; then an int8 batch with row 0 kept
    and other batch-mates, its first forward profiled: its `aten::_int_mm`
    calls (checked against the gate's count) and the share of its busy
    time in the quantize and rescale passes."""
    from tdm_tpu_torch.ops import attention as A, quant

    call = dict(call or {})
    want = gated_per_forward * forwards
    events = []
    scope = pipe.sampler_scope

    @contextlib.contextmanager
    def timed_scope():
        """The pipeline's sampler scope with CUDA events at its ends: the
        sampler's device span, decode excluded."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with scope():
            yield
        ev[1].record()
        events.append(ev)

    def run(quant_mode, c, z, out_type):
        """(latents, sampler ms, batch wall ms, attention launches, int8
        products) of one batch."""
        pipe.quant = quant_mode
        try:
            A.reset_launches()
            quant.int8_dot.launches = 0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = pipe(prompt_embeds=c, latents=z, output_type=out_type, **call)
            (out.images if out_type == "image" else out.latents).cpu()
            wall_ms = (time.monotonic() - t0) * 1e3
            ev = events.pop()
            return (out.latents, ev[0].elapsed_time(ev[1]), wall_ms, A.launch_counts(),
                    quant.int8_dot.launches)
        finally:
            pipe.quant = None

    ms, walls, runs = {"bf16": [], "int8": []}, {"bf16": [], "int8": []}, {}
    t0 = time.monotonic()
    pipe.sampler_scope = timed_scope
    try:
        with torch.inference_mode():
            for mode in ("bf16", "int8", "bf16"):  # in turns
                out, t, w, attn, n = run("int8" if mode == "int8" else None, cond, noise,
                                         "image" if images else "latent")
                ms[mode].append(t)
                walls[mode].append(w)
                runs.setdefault(mode, []).append((out, attn, n))
    finally:
        del pipe.sampler_scope
    (base, attn_bf16, n_bf16), (again, _, _) = runs["bf16"]
    ((q8, attn_int8, n_int8),) = runs["int8"]
    check(n_bf16 == 0 and n_int8 == want,
          f"[{tag}] {n_int8} int8 products in a batch (bf16: {n_bf16}), the gate admits "
          f"{gated_per_forward} a forward x {forwards} forwards = {want}")
    check(attn_int8 == attn_bf16 and attn_bf16[wrapper] > 0,
          f"[{tag}] attention launches at int8 {attn_int8} against bf16 {attn_bf16}")
    check(torch.equal(again, base), f"[{tag}] the bf16 bits moved after an int8 batch")
    rel = float((q8.float() - base.float()).norm() / base.float().norm())
    check(math.isfinite(rel) and rel < INT8_REL_BOUND,
          f"[{tag}] int8 latents {rel:.4f} (relative L2) from bf16, bound {INT8_REL_BOUND}")
    # the profiled int8 batch is the one with other batch-mates for row 0
    with torch.inference_mode():
        mates, prof = profile_int8(torch, pipe, _rows(torch, cond, other_cond),
                                   torch.cat([noise[:1], other_noise[1:]]), call)
    check(torch.equal(mates[:1], q8[:1]),
          f"[{tag}] row 0's int8 bits depend on its batch-mates")
    if prof.get("busy_ms"):
        check(prof["int_mm_calls"] == gated_per_forward,
              f"[{tag}] {prof['int_mm_calls']} aten::_int_mm in a profiled forward, the gate "
              f"admits {gated_per_forward}")
    med = {k: statistics.median(v) for k, v in ms.items()}
    wmed = {k: statistics.median(v) for k, v in walls.items()}
    share = prof.get("quant_rescale_share")
    check_s = time.monotonic() - t0
    print(f"[{tag}] int8: {n_int8} int8 products a batch = {gated_per_forward} gated Dense x "
          f"{forwards} forwards (checked; aten::_int_mm {prof['int_mm_calls']} in a profiled "
          f"forward); attention launches unchanged {attn_int8[wrapper]}; bf16 bits unchanged "
          f"after an int8 batch; row 0 the same bits with other batch-mates; latents "
          f"{rel:.4f} (relative L2) from bf16; sampler device ms int8 "
          f"{[round(t, 2) for t in ms['int8']]} against bf16 {[round(t, 2) for t in ms['bf16']]}"
          f" (x{med['int8'] / med['bf16']:.3f})"
          + f"; batch wall ms ({'decode included' if images else 'latents out'}) int8 "
            f"{[round(t, 1) for t in walls['int8']]} against bf16 "
            f"{[round(t, 1) for t in walls['bf16']]}"
          + (f"; the profiled int8 forward busy {prof['busy_ms']:.1f} ms, _int_mm "
             f"{prof['int_mm_ms']:.1f} ms, quantize + rescale {prof['quant_rescale_ms']:.1f} ms "
             f"({share:.3f} of busy)" if share is not None else "; profile: not measured")
          + f"; the check took {check_s:.1f}s", flush=True)
    return {"int8_products_per_batch": n_int8, "gated_per_forward": gated_per_forward,
            "forwards": forwards, "attention_launches": attn_int8[wrapper],
            "latent_rel_l2": rel, "sampler_ms": ms, "sampler_ms_median": med,
            "int8_over_bf16": med["int8"] / med["bf16"], "batch_wall_ms": walls,
            "batch_wall_ms_median": wmed, "profile": prof, "check_s": check_s}


def quant_server_request(torch, model_dir: str, cache: str, prompt: str, seed: int) -> dict:
    """`--quant int8` end to end: a server started with the flag (batch 1,
    no warm-up) on the PixArt bundle without its T5 (a symlink view, so the
    load skips the 9.5 GB encoder) serving `cache`, which build_cache wrote
    from that T5, answers one raw request: a valid 512² PNG, made with the
    int8 products the gate admits (4 forwards' worth)."""
    import urllib.request

    from tdm_tpu_torch.ops import quant
    from tdm_tpu_torch.serve import server as S

    t0 = time.monotonic()
    server = S.build_server(S.parse_args(["--model", cache_served_view(model_dir), "--port",
                                          "0", "--batch_size", "1",
                                          "--embedding_cache", cache, "--quant",
                                          "int8"])).start()
    up_s = time.monotonic() - t0
    try:
        check(server.batcher.pipe.quant == "int8" and server.batcher.pipe.text_encoder is None,
              "--quant int8 did not reach the cache-served pipeline")
        quant.int8_dot.launches = 0
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate",
            data=json.dumps({"prompt": prompt, "seed": seed}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.monotonic()
        with urllib.request.urlopen(req, timeout=300) as r:
            reply = json.loads(r.read())
        req_s = time.monotonic() - t0
        products = quant.int8_dot.launches
    finally:
        server.close()
        server.batcher.pipe = None
    check_png(base64.b64decode(reply["image"]), 512, 512)
    want = 4 * pixart_gated(torch, 1)
    check(products == want, f"the --quant int8 server ran {products} int8 products, the gate "
                            f"admits {want} (4 forwards at batch 1)")
    print(f"[serve] `--quant int8`: a server up in {up_s:.1f}s (the bundle without its T5, "
          f"the build_cache cache) answered a raw request in {req_s:.3f}s with a valid "
          f"512x512 PNG, {products} int8 products (checked)", flush=True)
    torch.cuda.empty_cache()
    return {"up_s": up_s, "request_s": req_s, "int8_products": products}


def generate_runs(torch, bundle: str, prompts: list, workdir: str) -> dict:
    """`tdm_tpu_torch.cli.generate.main` in process on the PixArt bundle
    from raw prompts to a directory of 4 PNGs at --quant int8, checked
    (512², not constant); the call's seconds, the bundle's load included.
    (The single-file output and bf16 are held by the CPU tests against the
    JAX CLI; one call here keeps the smoke's clock.)"""
    import numpy as np

    from tdm_tpu_torch.cli import generate

    out, runs = os.path.join(workdir, "generate"), {}
    os.makedirs(out, exist_ok=True)
    t0 = time.monotonic()
    generate.main(["--model", bundle, "--seed", "8888", "--prompt", *prompts[:4],
                   "--output", os.path.join(out, "four"), "--quant", "int8"])
    runs["dir_int8"] = {"s": time.monotonic() - t0}
    files = [os.path.join(out, "four", f"{i:03d}.png") for i in range(4)]
    stds = []
    for f in files:
        with open(f, "rb") as fh:
            stds.append(float(check_png(fh.read(), 512, 512).astype(np.float32).std()))
    check(min(stds) > 1.0, f"a generated image is (nearly) constant: std {min(stds)}")
    check(sorted(os.listdir(os.path.join(out, "four"))) == [f"{i:03d}.png" for i in range(4)],
          "generate's directory of 4")
    shutil.rmtree(out, ignore_errors=True)
    print(f"[generate] PixArt bundle from raw prompts: a directory of 4 at --quant int8 in "
          f"{runs['dir_int8']['s']:.1f}s (the bundle's load included); 512x512 PNGs, "
          f"pixel std {min(stds):.1f}-{max(stds):.1f}", flush=True)
    return runs


GEN_GIF_FRAMES = 13  # 4 latent frames at full width: the smoke's clock, not the recipe's 49


def generate_gif(torch, view: str, cache: str, prompt: str, workdir: str) -> dict:
    """`cli.generate.main` on the CogVideoX checkout's cache-served view
    with its T5 cache, to one GIF of GEN_GIF_FRAMES frames at 480×720 (fps
    8), checked with check_gif and two frames decoded."""
    from tdm_tpu_torch.cli import generate

    path = os.path.join(workdir, "wave.gif")
    t0 = time.monotonic()
    generate.main(["--model", view, "--prompt", prompt, "--embedding_cache", cache,
                   "--num_frames", str(GEN_GIF_FRAMES), "--seed", "8888", "--output", path])
    s = time.monotonic() - t0
    with open(path, "rb") as f:
        gif = f.read()
    os.remove(path)
    data = check_gif(gif, GEN_GIF_FRAMES, 720, 480)
    stds = [gif_frame_std(torch, data[i], 720, 480) for i in (0, GEN_GIF_FRAMES - 1)]
    check(min(stds) > 1.0, f"a generated frame is (nearly) constant: RGB std {min(stds)}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[generate] CogVideoX-2B checkout (cache-served view) to a GIF of "
          f"{GEN_GIF_FRAMES} frames at 720x480 in {s:.1f}s, the load included ({len(gif) / 1e6:.1f}"
          f" MB; 12 cs delays, loop block; frame RGB std {min(stds):.1f}-{max(stds):.1f})",
          flush=True)
    return {"s": s, "frames": GEN_GIF_FRAMES, "mb": len(gif) / 1e6}


def clip_model_layout(text_cfg, vision_cfg) -> dict:
    """{key: (shape, init)} of a `transformers.CLIPModel` state dict (both
    towers, both projections, logit_scale), with the transformers inits:
    the text tower's as `hf_encoder_layout` gives it."""
    out = hf_encoder_layout(text_cfg)
    d, ff, v = vision_cfg.hidden, vision_cfg.hidden * vision_cfg.mlp_ratio, "vision_model"
    p = vision_cfg.patch_size
    in_std = d ** -0.5 * (2 * vision_cfg.num_layers) ** -0.5
    out[f"{v}.embeddings.class_embedding"] = ((d,), d ** -0.5)
    out[f"{v}.embeddings.patch_embedding.weight"] = ((d, 3, p, p), 0.02)
    n_pos = (vision_cfg.image_size // p) ** 2 + 1
    out[f"{v}.embeddings.position_embedding.weight"] = ((n_pos, d), 0.02)
    for n in ("pre_layrnorm", "post_layernorm"):
        out[f"{v}.{n}.weight"], out[f"{v}.{n}.bias"] = ((d,), "ones"), ((d,), "zeros")
    for i in range(vision_cfg.num_layers):
        b = f"{v}.encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            out[f"{b}.{n}.weight"], out[f"{b}.{n}.bias"] = ((d,), "ones"), ((d,), "zeros")
        for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{b}.self_attn.{q}.weight"] = ((d, d), d ** -0.5 if q == "out_proj" else in_std)
            out[f"{b}.self_attn.{q}.bias"] = ((d,), "zeros")
        out[f"{b}.mlp.fc1.weight"], out[f"{b}.mlp.fc1.bias"] = ((ff, d), (2 * d) ** -0.5), \
            ((ff,), "zeros")
        out[f"{b}.mlp.fc2.weight"], out[f"{b}.mlp.fc2.bias"] = ((d, ff), in_std), ((d,), "zeros")
    out["visual_projection.weight"] = ((vision_cfg.projection_dim, d), d ** -0.5)
    out["logit_scale"] = ((), "ones")
    return out


def write_clip_model(torch, folder: str, seed: int) -> dict:
    """A seeded CLIP ViT-L/14 `CLIPModel` folder with the public
    openai/clip-vit-large-patch14 configuration (text 12 x 768, vision 24 x
    1024 at patch 14 and 224², projection 768; the legacy eos_token_id 2,
    which pools at the highest id) at fp16, and a hash tokenizer
    (`tdm_tokenizer.json`, vocab 49408, EOS 49407 = the highest id)."""
    import numpy as np

    from tdm_tpu_torch.eval import clip_score
    from tdm_tpu_torch.io import params as params_io
    from tdm_tpu_torch.models import clip

    text = clip.CLIPTextConfig(projection_dim=768)
    vision = clip.CLIPVisionConfig()
    check((vision.hidden, vision.num_layers, vision.num_heads, vision.patch_size,
           vision.image_size, vision.projection_dim) == (1024, 24, 16, 14, 224, 768),
          "CLIP ViT-L/14")
    layout = clip_model_layout(text, vision)
    t0 = time.monotonic()
    os.makedirs(folder, exist_ok=True)
    config = {
        "architectures": ["CLIPModel"], "projection_dim": 768, "logit_scale_init_value": 2.6592,
        "text_config": {"vocab_size": CLIP_VOCAB, "hidden_size": 768, "intermediate_size": 3072,
                        "num_attention_heads": 12, "num_hidden_layers": 12,
                        "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                        "eos_token_id": 2},
        "vision_config": {"hidden_size": 1024, "intermediate_size": 4096,
                          "num_attention_heads": 16, "num_hidden_layers": 24, "image_size": 224,
                          "patch_size": 14, "hidden_act": "quick_gelu"}}
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(folder, clip_score.HASH_TOKENIZER_FILE), "w") as f:
        json.dump({"kind": "hash", "vocab_size": CLIP_VOCAB, "eos_id": CLIP_EOS}, f)
    params_io.write_file(os.path.join(folder, "model.safetensors"),
                         [(k, shape, np.float16) for k, (shape, _) in layout.items()],
                         _seeded_leaves(torch, layout, seed, set()))
    n = sum(math.prod(s) for s, _ in layout.values())
    gb = os.path.getsize(os.path.join(folder, "model.safetensors")) / 1e9
    s = time.monotonic() - t0
    print(f"[evaluate] wrote a seeded CLIP ViT-L/14 CLIPModel ({n / 1e6:.1f}M params, {gb:.2f} "
          f"GB at fp16) with a hash tokenizer in {s:.1f}s", flush=True)
    return {"params": n, "gb": gb, "write_s": s}


def evaluate_runs(torch, view: str, lora_file: str, workdir: str, seed: int) -> dict:
    """`tdm_tpu_torch.cli.evaluate.main` in process on the SD1.5 checkout's
    cache-served view with its LoRA (at the recipe's 0.125), 4 prompts of
    an eval cache (with the empty prompt's rows, for CFG), the seeded
    CLIP ViT-L/14 folder: `--compare_teacher --teacher_steps 28
    --teacher_guidance 7.0` (the int8 sampler is held by the sd15 phase's
    int8 batch and `generate`; one call here keeps the smoke's clock). The
    JSON's keys, lengths and scores in [0, 100] checked; the teacher run's
    seconds, the scorer's ms per image, the vision tower in bf16 against
    fp32 per row. The CLIP folder is deleted after (the disk)."""
    import dataclasses
    import io

    import numpy as np

    from tdm_tpu_torch.cli import evaluate
    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.eval import clip_score
    from tdm_tpu_torch.models import clip as clip_mod

    folder = os.path.join(workdir, "clip-vit-large-patch14")
    written = write_clip_model(torch, folder, seed + 40)
    prompts = [f"eval prompt {i}" for i in range(4)]
    cache = os.path.join(workdir, "eval_cache.npz")
    rng = np.random.default_rng(seed + 41)
    EmbeddingCache(rng.standard_normal((4, SD15_TXT, 768)).astype(np.float16),
                   np.ones((4, SD15_TXT), np.int32), prompts,
                   uncond_embed=rng.standard_normal((SD15_TXT, 768)).astype(np.float16),
                   uncond_mask=np.ones(SD15_TXT, np.int32)).save(cache)
    timing = {}
    real_score = evaluate._score_run

    def timed_score(pipe, scorer, prompts_, neg, call, cache_, tag, save_dir):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = real_score(pipe, scorer, prompts_, neg, call, cache_, tag, save_dir)
        timing[tag] = time.monotonic() - t0
        return out

    runs = {}
    evaluate._score_run = timed_score
    try:
        for name, extra in {"bf16": []}.items():
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                evaluate.main(["--model", view, "--clip_model", folder, "--prompt", *prompts,
                               "--embedding_cache", cache, "--lora", lora_file,
                               "--compare_teacher", "--teacher_steps", "28",
                               "--teacher_guidance", "7.0", *extra])
            res = json.loads(buf.getvalue().strip().splitlines()[-1])
            runs[name] = {"result": res, "s": time.monotonic() - t0, **{
                f"{k}_s": v for k, v in timing.items()}}
    finally:
        evaluate._score_run = real_score
    for name, run in runs.items():
        res = run["result"]
        check(set(res) == {"prompts", "student", "teacher", "student_minus_teacher"}
              and res["prompts"] == prompts, f"[evaluate {name}] keys {sorted(res)}")
        for role, steps in (("student", 4), ("teacher", 28)):
            r = res[role]
            check(r["steps"] == steps and len(r["clip_scores"]) == 4
                  and all(math.isfinite(s) and 0.0 <= s <= 100.0 for s in r["clip_scores"]),
                  f"[evaluate {name}] {role}: {r}")
    # the scorer alone: ms per image, the vision tower bf16 against fp32
    scorer = clip_score.CLIPScorer.from_pretrained(folder, device="cuda")
    imgs = torch.rand(4, 512, 512, 3, generator=torch.Generator().manual_seed(seed),
                      device="cpu").cuda()
    ids = scorer.tokenize(prompts)
    score_ms = time_ms(torch, lambda: scorer.score(imgs, input_ids=ids), iters=5, warmup=2) / 4
    px = clip_score.preprocess_images(imgs, 224)
    f32 = dataclasses.replace(scorer.vision_cfg, dtype=torch.float32)
    v32 = clip_mod.CLIPVisionEncoder(f32, device="cuda")
    v32.load_state_dict({k: v.float() for k, v in scorer.vision_model.state_dict().items()})
    with torch.inference_mode():
        a = scorer.vision_model(px).pooled.float()
        b = v32(px).pooled.float()
        # 100·cos before the clip at 0: seeded towers give scores near 0
        # of either sign, which the CLIP score clips; these show the spread
        img_e = scorer.embed_images(imgs).float()
        txt_e = scorer.embed_texts(input_ids=ids).float()
        raw = (100 * torch.nn.functional.cosine_similarity(img_e, txt_e, dim=-1)).tolist()
    row_rel = ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()
    check(max(row_rel) < 0.05, f"the CLIP vision tower in bf16 against fp32: {row_rel}")
    del scorer, v32
    shutil.rmtree(folder, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res = runs["bf16"]["result"]
    print(f"[evaluate] SD1.5 (LoRA 0.125) on 4 prompts, CLIP ViT-L/14 (seeded, so the scores "
          f"show the plumbing, not quality): student {res['student']['clip_score_mean']} "
          f"teacher {res['teacher']['clip_score_mean']} (28 steps, cfg 7: "
          f"{runs['bf16']['teacher_s']:.2f}s); evaluate.main "
          f"{runs['bf16']['s']:.1f}s with the loads; the scorer "
          f"{score_ms:.2f} ms an image (batch 4 at 512², preprocess and both towers); the vision "
          f"tower bf16 against fp32 per row {max(row_rel):.4f} at most; 100·cos before the "
          f"clip on random images {[round(c, 3) for c in raw]}", flush=True)
    return {"runs": runs, "clip": written, "score_ms_per_image": score_ms,
            "vision_bf16_rel_l2": row_rel, "raw_100cos": raw}


def phase_reference_eval(torch, seed: int) -> dict:
    """The tiny new modules on the card against the CPU (fp32, TF32 off):
    int8_dot (the same int8 codes, outputs within one ulp of the output
    dtype), the CLIP vision tower, preprocess_images (512² and 480×720 to
    224²), TAESDEncoder and KLEncoder; to 1e-5 of the largest |CPU
    output| (the same sums in another order), 1e-4 for preprocess's
    resize products."""
    import dataclasses

    from tdm_tpu_torch.device import set_fp32_precision
    from tdm_tpu_torch.eval import clip_score
    from tdm_tpu_torch.models import clip, vae
    from tdm_tpu_torch.ops import quant

    set_fp32_precision()
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(300, 1152, generator=gen).to(dtype)
        w = torch.randn(4608, 1152, generator=gen).to(dtype)
        x[0] *= 1e3
        ref = quant.int8_dot(x, w).float()
        before = quant.int8_dot.launches
        got = quant.int8_dot(x.cuda(), w.cuda()).float().cpu()
        quant.int8_dot.launches = before  # a check, not the main path
        check(torch.equal(quant.quantize_rows(x.cuda())[0].cpu(), quant.quantize_rows(x)[0]),
              "int8 codes on the card")
        mant = 23 if dtype == torch.float32 else 7
        ulp = torch.pow(2.0, torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - mant)
        check(bool(((got - ref).abs() <= ulp).all()), f"int8_dot {dtype} on the card")
        out[f"int8_dot_{str(dtype)[6:]}_max_abs_err"] = float((got - ref).abs().max())

    def close(name, got, ref, tol=1e-5):
        err = float((got.float().cpu() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        check(err <= tol * scale, f"{name} on the card: {err:.3e} of {scale:.3g}")
        out[name] = err / scale

    def seeded(module):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) / max(p.shape[-1], 1) ** 0.5)
        return module

    vcfg = clip.CLIPVisionConfig.tiny()
    cpu_v = seeded(clip.CLIPVisionEncoder(vcfg, device="cpu"))
    gpu_v = clip.CLIPVisionEncoder(vcfg, device="cuda")
    gpu_v.load_state_dict(cpu_v.state_dict())
    px = torch.randn(3, 3, 16, 16, generator=gen)
    with torch.no_grad():
        close("clip_vision_pooled", gpu_v(px.cuda()).pooled, cpu_v(px).pooled)
    for h, w in ((512, 512), (480, 720)):
        imgs = torch.rand(2, h, w, 3, generator=gen)
        close(f"preprocess_{h}x{w}", clip_score.preprocess_images(imgs.cuda()),
              clip_score.preprocess_images(imgs), 1e-4)
    tcfg = vae.TAESDConfig(width=16, num_stages=2, blocks_per_stage=1)
    kcfg = dataclasses.replace(vae.KLVAEConfig.tiny(), latent_channels=4)
    img = torch.rand(2, 3, 32, 48, generator=gen) * 2 - 1
    for name, cls, cfg in (("taesd_encoder", vae.TAESDEncoder, tcfg),
                           ("kl_encoder", vae.KLEncoder, kcfg)):
        cpu_m = seeded(cls(cfg, device="cpu"))
        gpu_m = cls(cfg, device="cuda")
        gpu_m.load_state_dict(cpu_m.state_dict())
        with torch.no_grad():
            a, b = gpu_m(img.cuda()), cpu_m(img)
        if isinstance(b, tuple):
            a, b = torch.cat(a, 1), torch.cat(b, 1)
        close(name, a, b)
    print(f"[reference] the new modules on the card against the CPU: {out}", flush=True)
    return out


@functools.cache
def pixart_gated(torch, batch: int) -> int:
    """The Dense calls the int8 gate admits in one full-width PixArt-α-512
    forward at `batch` rows (512², 120 caption tokens)."""
    from tdm_tpu_torch.models import pixart

    return reckon_gated(torch, pixart.PixArtTransformer2D(pixart.PixArtConfig(), device="meta"),
                        (batch, 4, 64, 64), (batch,), (batch, 120, 4096), (batch, 120),
                        int_arg=3)[1]


QF_STEPS = 2


def quant_forwards_run(torch, seed: int, workdir: str, teacher_dir: str,
                       bf16_s_per_step: float) -> dict:
    """The train phase's main() again with --quant_forwards (QF_STEPS
    steps, no LoRA export, no final checkpoint): per step the int8
    products (checked against the
    gate's count over the forwards the JAX step wraps in q(): the 4-step
    rollout, the stop-grad x̂₀ and the critic probe at batch 4, the
    teacher's CFG probe at 8), kernels 1–3's launches unchanged (checked
    against TRAIN_LAUNCHES), the losses finite; s/step against the bf16
    run's, peak memory."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.ops import attention as A

    g4, g8 = pixart_gated(torch, 4), pixart_gated(torch, 8)
    want = 6 * g4 + g8
    out = os.path.join(workdir, "train_q8")
    steps = []
    A.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with no_final_checkpoint(), \
            no_student_export():
        train_tdm.main([
            "--output_dir", out, "--max_train_steps", str(QF_STEPS), "--train_batch_size",
            "4", "--mixed_precision", "bf16", "--loss_mode", "dmd", "--seed", str(seed),
            "--pretrained_model_name_or_path", teacher_dir, "--quant_forwards",
            "--export_lora_rank", "0",
        ], step_hook=step_hook(torch, steps, 0, "train_q8"))
    main_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check_train_records(steps, QF_STEPS)
    for rec in steps:
        check(rec["int8_products"] == want,
              f"--quant_forwards step {rec['step']}: {rec['int8_products']} int8 products, "
              f"the gate's count over the q() forwards {want}")
    shutil.rmtree(out + "_cfg4.5_steps900", ignore_errors=True)
    per_step = steps[-1]["host_s"]
    print(f"[train] --quant_forwards: {want} int8 products a step (checked: 6 forwards x "
          f"{g4} + the CFG probe's {g8}), kernels 1-3 "
          f"launches {TRAIN_LAUNCHES} (checked), losses finite; step 2 {per_step:.3f} s against "
          f"bf16 {bf16_s_per_step:.3f} s/step (x{per_step / bf16_s_per_step:.3f}); peak "
          f"{peak_gb:.2f} GiB; main() {main_s:.1f}s", flush=True)
    return {"int8_products_per_step": want, "s_per_step": per_step,
            "over_bf16": per_step / bf16_s_per_step, "peak_gib": peak_gb, "main_s": main_s,
            "steps": steps}


# --- data parallelism: --dp serving and two training ranks on one card -------

# the 2-rank step's constant learning rate (the CLI's default schedule warms
# up from 0, which would leave the weights, and the bit-for-bit check, idle)
DP_LR = 2e-5
# the 2-rank step's reduced gradients against the one-process step at batch 2:
# relative L2, bf16 GEMMs at M of one row against two
DP_GRAD_TOL = 2e-2
DP_RANK_TIMEOUT_S = 900


def dp_serving_check(torch, pipe, cond, noise) -> dict:
    """The served PixArt pipeline with `data_parallel_devices = [cuda:0,
    cuda:0]`: one batch of 4 split 2 + 2 over two replicas (a copy of the
    transformer and the decoder for the second), latents out, against the
    undivided batch (bit for bit, or within one bf16 ulp of the latent
    scale, the pipeline parity bound; the line says which held); kernel 1's
    launches counted from both replicas' threads (2 x 224); the overlap: the
    split call's wall ms against the sum of the two chunks' device ms, each
    chunk run alone and timed by CUDA events."""
    from tdm_tpu_torch.ops import attention as A

    call = dict(prompt_embeds=cond, latents=noise, output_type="latent")
    whole = pipe(**call).latents

    def rows(i):
        return dict(prompt_embeds=tuple(t[2 * i:2 * i + 2] for t in cond),
                    latents=noise[2 * i:2 * i + 2], output_type="latent")

    chunk_ms = []
    for i in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        pipe(**rows(i))
        ev[1].record()
        torch.cuda.synchronize()
        chunk_ms.append(ev[0].elapsed_time(ev[1]))
    pipe.data_parallel_devices = [torch.device("cuda", 0)] * 2
    try:
        pipe(**call)  # the replica's first call
        torch.cuda.synchronize()
        A.reset_launches()
        t0 = time.monotonic()
        split = pipe(**call).latents
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
        launches = A.flash_attention_fwd.launches
    finally:
        pipe.data_parallel_devices = None
        gc.collect()
        torch.cuda.empty_cache()
    diff = float((split.float() - whole.float()).abs().max())
    ulp = bf16_ulp(float(whole.float().abs().max()))
    exact = bool(torch.equal(split, whole))
    check(exact or diff <= ulp,
          f"--dp 2 latents differ from the undivided batch by {diff} (> one bf16 ulp {ulp})")
    check(launches == 2 * PIXART_LAUNCHES_PER_BATCH,
          f"the two replicas launched kernel 1 {launches}x, expected "
          f"{2 * PIXART_LAUNCHES_PER_BATCH}")
    held = "bit for bit" if exact else f"max |diff| {diff:.3g} within one bf16 ulp {ulp:.3g}"
    print(f"[serve] --dp on [cuda:0, cuda:0]: a batch of 4 split 2 + 2 gives the undivided "
          f"batch's latents {held}; kernel 1 launched {launches}x (2 replicas x 224, "
          f"counted from their threads); wall {wall_ms:.1f} ms against the chunks' "
          f"{chunk_ms[0]:.1f} + {chunk_ms[1]:.1f} ms alone (overlap "
          f"{sum(chunk_ms) / wall_ms:.3f}x)", flush=True)
    return {"exact": exact, "max_abs_diff": diff, "bf16_ulp": ulp, "launches": launches,
            "wall_ms": wall_ms, "chunk_ms": chunk_ms, "overlap": sum(chunk_ms) / wall_ms}


@contextlib.contextmanager
def nccl_world_1(torch):
    """A world of one process over NCCL, formed by the port's initialiser
    from torchrun's variables (set here, removed after, with the group)."""
    import socket

    import torch.distributed as dist

    from tdm_tpu_torch.parallel import mesh as pmesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    os.environ.update(env)
    try:
        check(pmesh.maybe_initialize_distributed("cuda"), "no world formed from RANK/WORLD_SIZE")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"world {dist.get_backend()} x {dist.get_world_size()}, expected nccl x 1")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


@contextlib.contextmanager
def counted_collectives(torch):
    """Every torch.distributed collective the port calls, counted by name."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
             "reduce_scatter_tensor", "reduce_scatter_single", "broadcast", "barrier")
    counts, saved = {}, {}
    for name in names:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def nccl_collectives_check(torch, grads: dict) -> dict:
    """In the NCCL world of one: the port's allreduce_mean over a real
    gradient dict (one flattened all_reduce), and each leaf through the
    ZeRO-3 all_gather and reduce_scatter; each result equal to its input
    bit for bit (a sum over one rank), with the seconds."""
    from tdm_tpu_torch.parallel import mesh as pmesh

    nbytes = sum(g.numel() * g.element_size() for g in grads.values())
    torch.cuda.synchronize()
    t0 = time.monotonic()
    mean = pmesh.allreduce_mean(grads)
    torch.cuda.synchronize()
    ar_s = time.monotonic() - t0
    check(all(torch.equal(mean[k], g) for k, g in grads.items()),
          "allreduce_mean at world 1 changed the gradients")
    t0 = time.monotonic()
    for k, g in grads.items():
        flat = g.reshape(-1)
        check(torch.equal(pmesh.all_gather_flat(flat, None), flat), f"all_gather of {k}")
        out = torch.empty_like(flat)
        pmesh.reduce_scatter(out, flat, None)
        check(torch.equal(out, flat), f"reduce_scatter of {k}")
    torch.cuda.synchronize()
    zero_s = time.monotonic() - t0
    print(f"[train] NCCL world of 1: allreduce_mean of the critic's {len(grads)} gradients "
          f"({nbytes / 1e9:.2f} GB, one flattened all_reduce) in {ar_s:.3f} s, all_gather and "
          f"reduce_scatter leaf by leaf in {zero_s:.3f} s, each equal to its input (checked)",
          flush=True)
    return {"leaves": len(grads), "gb": nbytes / 1e9, "allreduce_s": ar_s, "zero_s": zero_s}


class _Recorder:
    """The one-process step's reducer: the identity, keeping each role's
    gradients."""

    def __init__(self):
        self.grads = {}

    def compute(self, role, params):
        return params

    def reduce(self, role, grads):
        self.grads[role] = grads
        return grads

    def norm(self, role, grads):
        from tdm_tpu_torch.train import optim as topt

        return topt.global_norm(grads)

    def mean(self, values):
        return values

    def moe_scope(self, rows):
        return contextlib.nullcontext()


# the two ranks' checks: full width at RANK_LAYERS blocks, so that two
# ranks fit on the card and start quickly (the dense check took all 28
# blocks of the checkout before this cut for the smoke's clock)
RANK_LAYERS = 8
RANK_LAUNCHES = {k: v * RANK_LAYERS // 28 for k, v in TRAIN_LAUNCHES.items()}


def rank_setup(torch, seed: int, device, sync, experts: int = 0, teacher_dir=None, tp=None,
               before_tp=None, dtype=None):
    """The 2-rank checks' step: PixArt-α-512 at full width and RANK_LAYERS
    blocks (the teacher, the student and the critic start equal), dense at
    global batch 2 (a data-parallel rank's row each) with the first blocks
    of the checkout's transformer/ at `teacher_dir`, or seeded with
    `experts` top-2 experts a block at global batch
    MOE_EP_BATCH (all rows on both --ep ranks); bf16 compute (or `dtype`)
    on fp32 masters, dmd, cfg 4.5, the CLI's TDM defaults, AdamW at the constant
    DP_LR with the clip's norm through `sync`; seeded T5-shaped conditions
    [B, 120, 4096] with ragged masks, the CFG null branch zeros under an
    all-ones mask (the CLI without a cache), and the draws of one seeded
    generator. Under a reducer with layouts (`ZeRO3`) each role and the
    teacher keep this rank's experts (and tp slices). `before_tp(model,
    full)` runs on the whole model; then, with `tp` (a `TPGroup`), the
    model is cut for this rank. Returns (step, state, draws, cond,
    uncond)."""
    import dataclasses
    import functools

    import numpy as np
    from torch.func import functional_call

    from tdm_tpu_torch.core import schedules as sched
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.models import pixart
    from tdm_tpu_torch.train import optim as topt, tdm

    cfg = dataclasses.replace(pixart.PixArtConfig(), num_layers=RANK_LAYERS,
                              moe_experts=experts, moe_top_k=MOE_K)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    torch.manual_seed(seed + 23)
    model = pixart.PixArtTransformer2D(cfg, device=device, param_dtype=torch.float32)
    model.requires_grad_(False)
    if teacher_dir is not None:
        tree = convert.pixart_params(convert.load_torch_state_dict(teacher_dir),
                                     scan_layers=False)
        from_jax.load_from_jax({k: v for k, v in convert.flatten(tree).items()
                                if not k.startswith("blocks_")
                                or int(k.split("/")[0][len("blocks_"):]) < RANK_LAYERS}, model)
    full = {k: p.detach() for k, p in model.named_parameters()}
    if before_tp is not None:
        before_tp(model, full)
    if tp is not None:  # the model's modules run this rank's share (--tp)
        from tdm_tpu_torch.parallel import tp as tp_lib

        tp_lib.parallelize(model, tp)

    def denoise_fn(params, x, t, cond):
        text, mask = cond
        return pixart.epsilon(functional_call(model, params, (x, t, text, mask)))

    sharded = hasattr(sync, "layouts")
    tx_s, tx_c = (topt.make_optimizer(DP_LR, norm_fn=functools.partial(sync.norm, role))
                  for role in ("student", "critic"))
    config = tdm.TDMConfig(use_huber=False, use_separate=False)
    shape = (cfg.in_channels, cfg.sample_size, cfg.sample_size)
    step = tdm.build_train_step(denoise_fn, sync.teacher(full) if sharded else full,
                                sched.ddpm_linear(device=device), config, tx_s, tx_c,
                                sample_shape=shape, sync=sync)
    state = tdm.init_state(sync.shard("student", full) if sharded else full,
                           sync.shard("critic", full) if sharded else full, tx_s, tx_c)
    lengths = [[120], [57], [9], [1]][:2 if experts == 0 else MOE_EP_BATCH]
    b = len(lengths)
    rng = np.random.default_rng(seed + 17)
    text = torch.from_numpy(rng.standard_normal((b, 120, cfg.caption_dim)).astype(np.float32)
                            * 0.2)
    mask = torch.from_numpy((np.arange(120)[None] < np.array(lengths)).astype(np.int32))
    cond = (text.to(device), mask.to(device))
    uncond = (torch.zeros_like(text).to(device), torch.ones_like(mask).to(device))
    draws = tdm.make_draws(config, b, shape, torch.Generator(device=device).manual_seed(seed + 1),
                           device)
    return step, state, draws, cond, uncond


def bit_checksum(torch, tree: dict) -> list:
    """Two int64 sums over every tensor's 32-bit words, plain and weighted
    by position (wrapping): equal trees give equal sums; a changed bit
    changes them."""
    total = None
    for k in sorted(tree):
        w = tree[k].detach().reshape(-1).contiguous().view(torch.int32).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        s = torch.stack([w.sum(), (w * pos).sum()])
        total = s if total is None else total + s
    return [int(v) for v in total.cpu()]


def dp_reference(torch, seed: int, teacher_dir: str, path: str, dtype=None) -> dict:
    """The one-process step at batch 2 on the 2-rank check's inputs: its
    gradients of each role (the critic's returned for the NCCL check), the
    student before and after, and the metrics written to `path` for the
    data-parallel and the --tp 2 ranks to hold theirs against. With
    `dtype` float32, the step computes in fp32 with TF32 off (the --tp 2
    fp32 witness's reference)."""
    if dtype == torch.float32:
        from tdm_tpu_torch.device import set_fp32_precision

        set_fp32_precision(False)
    rec = _Recorder()
    step, state, draws, cond, uncond = rank_setup(torch, seed, "cuda", rec,
                                                  teacher_dir=teacher_dir, dtype=dtype)
    before = {k: v.to("cpu", copy=True) for k, v in state.student.items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    new, metrics = step(state, draws, cond, uncond)
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    metrics = {k: float(v) for k, v in metrics._asdict().items()}
    torch.save({"grads": {role: {k: v.cpu() for k, v in g.items()}
                          for role, g in rec.grads.items()}, "metrics": metrics,
                "before": before, "student": {k: v.cpu() for k, v in new.student.items()}},
               path + ".tmp")
    os.replace(path + ".tmp", path)  # whole when a rank finds it
    print(f"[train] the one-process reference step at batch 2"
          f"{' in fp32' if dtype == torch.float32 else ''}: {step_s:.3f} s, {metrics}",
          flush=True)
    return {"critic_grads": rec.grads["critic"], "metrics": metrics, "step_s": step_s}


def dp_rank_main(rank: int, spec: dict) -> int:
    """One of the two data-parallel training ranks (`--dp_rank`): the
    port's initialiser with backend gloo, both ranks on cuda:0; the 2-rank
    step on this rank's row through the port's DataParallel reducer; the
    bit checksums of the new student and critic, the step's seconds and
    peak memory, the kernels' launches; rank 0 also the relative L2 of the
    reduced gradients against the reference's (from spec['ref'])."""
    import torch
    import torch.distributed as dist

    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.parallel import mesh as pmesh
    from tdm_tpu_torch.train import tdm

    os.environ.update(TDM_COORDINATOR=spec["store"], TDM_NUM_PROCESSES="2",
                      TDM_PROCESS_ID=str(rank))
    check(pmesh.maybe_initialize_distributed("cuda", backend="gloo"), "no gloo world")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    mesh = pmesh.make_mesh()

    class Recording(pmesh.DataParallel):
        """The port's gradient mean, keeping each role's reduced gradients."""

        def __init__(self, mesh):
            super().__init__(mesh)
            self.grads = {}

        def reduce(self, role, grads):
            out = super().reduce(role, grads)
            self.grads[role] = out
            return out

    sync = Recording(mesh)
    step, state, draws, cond, uncond = rank_setup(torch, spec["seed"], device, sync,
                                                  teacher_dir=spec["teacher_dir"])
    rows = mesh.batch_rows(1)
    part = tdm.draw_rows(draws, rows)
    pmesh.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t0 = time.monotonic()
    new, metrics = step(state, part, tuple(t[rows] for t in cond),
                        tuple(t[rows] for t in uncond))
    torch.cuda.synchronize()
    out = {"rank": rank, "step_s": time.monotonic() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": A.launch_counts(),
           "metrics": {k: float(v) for k, v in metrics._asdict().items()},
           "checksums": {role: bit_checksum(torch, getattr(new, role))
                         for role in ("student", "critic")}}
    if rank == 0:
        ref = torch.load(spec["ref"], map_location="cpu", mmap=True)
        out["ref_metrics"] = ref["metrics"]
        out["grad_rel_l2"] = {}
        for role, grads in sync.grads.items():
            num = den = 0.0
            for k, g in grads.items():
                r = ref["grads"][role][k].to(device)
                num += float((g.float() - r.float()).square().sum())
                den += float(r.float().square().sum())
            out["grad_rel_l2"][role] = math.sqrt(num / den)
        # the update against the one-process step's, for the record beside
        # the --tp one (Adam's first step is lr·sign(g) wherever |g| ≫ eps)
        num = den = 0.0
        for k, v in new.student.items():
            want = ref["student"][k].to(device) - ref["before"][k].to(device)
            got = v - ref["before"][k].to(device)
            num += float((got - want).square().sum())
            den += float(want.square().sum())
        out["update_rel_l2"] = math.sqrt(num / den)
    del step, state, new, metrics, sync, draws, part, cond, uncond
    gc.collect()
    torch.cuda.empty_cache()
    if spec.get("moe_ref"):  # the same two processes take the --ep 2 step
        out["moe"] = moe_rank_step(torch, rank, spec)
        gc.collect()
        torch.cuda.empty_cache()
    out["tp"] = tp_rank_step(torch, rank, spec)  # then the --tp 2 checks
    gc.collect()
    torch.cuda.empty_cache()
    out["tp_main"] = tp_main_rank(torch, rank, spec)  # train_tdm.main --tp 2
    gc.collect()
    torch.cuda.empty_cache()
    pmesh.barrier()
    out["sp"] = sp_rank_checks(torch, rank, spec)  # the --sp 2 checks
    gc.collect()
    torch.cuda.empty_cache()
    pmesh.barrier()
    out["tp_serve"] = tp_serve_rank(torch, rank, spec)  # its close ends the world
    with open(spec["out"] % rank, "w") as f:
        json.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def dp_ranks(torch, seed: int, workdir: str, teacher_dir: str, ref_path: str,
             reference: dict, moe_ref: dict | None = None, meanwhile=None) -> dict:
    """Two gloo ranks on cuda:0 (`dp_rank_main`), started together, each
    with a time limit, killed if either fails: their new student and critic
    equal bit for bit (checked); the reduced gradients within DP_GRAD_TOL
    (relative L2) and the losses within it of the one-process step at
    batch 2 (checked); kernels 1–3's launches per rank as RANK_LAUNCHES
    (checked); each rank's step seconds and peak memory. With `moe_ref`
    (`moe_ep_reference`'s, its file at moe_ref['path']) the same two
    processes then take the --ep 2 step (`moe_rank_step`): the leaves
    other than the expert stacks equal bit for bit across the ranks, the
    reduced gradients (each rank's experts) and rank 0's gathered update
    within DP_GRAD_TOL of the one-process step, the losses too, kernels
    1–3's launches per rank (checked); each rank's
    step seconds and peak memory. `meanwhile()`, when given, runs in this
    process after its references, while the ranks run (its result under
    'meanwhile')."""
    gc.collect()
    torch.cuda.empty_cache()  # the card's memory to the two ranks
    print(f"[train] this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of the "
          f"card when the ranks start", flush=True)
    spec = {"seed": seed, "teacher_dir": teacher_dir, "ref": ref_path,
            "store": "file://" + os.path.join(workdir, f"dp_store_{os.getpid()}"),
            "out": os.path.join(workdir, "dp_rank%d.json"),
            "moe_ref": moe_ref and moe_ref["path"],
            "serve_model": cache_served_view(os.path.dirname(teacher_dir)),
            "serve_cache": pixart_cache(workdir, seed)[0],
            "serve_ref": os.path.join(workdir, "tp_serve_reference.pt"),
            "ref32": os.path.join(workdir, "tp_fp32_reference.pt"), "workdir": workdir,
            "sp_serve_ref": os.path.join(workdir, "sp_serve_reference.pt"),
            "sp_ref": os.path.join(workdir, "sp_reference.pt"),
            "sp_ref32": os.path.join(workdir, "sp_fp32_reference.pt")}
    here = os.path.abspath(__file__)
    t0 = time.monotonic()
    # each rank peaks about where the one-process step does (weights, AdamW
    # moments and the update's temporaries, ~33 GiB): two fit on the card
    # only without the allocator's fragmentation (~5 GiB a process)
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen([sys.executable, here, "--dp_rank", str(r), "--dp_spec",
                               json.dumps(spec)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    logs = []
    try:
        # while the ranks start and take their steps: the references of the
        # --tp 2 server and fp32 witness, then `generate --tp 2`
        tp_serve_reference(torch, spec)
        dp_reference(torch, seed, teacher_dir, spec["ref32"], dtype=torch.float32)
        gc.collect()
        torch.cuda.empty_cache()
        generated = tp_generate(torch, spec)
        gc.collect()
        torch.cuda.empty_cache()
        sp_references(torch, spec)  # the --sp 2 checks' references
        done_meanwhile = meanwhile() if meanwhile is not None else None
        for p in procs:
            logs.append(p.communicate(timeout=DP_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"data-parallel rank {r} exited {p.returncode}:\n{log[-3000:]}")
    res = []
    for r in range(2):
        with open(spec["out"] % r) as f:
            res.append(json.load(f))
    for path in (ref_path, spec["ref32"], spec["sp_serve_ref"], spec["sp_ref"],
                 spec["sp_ref32"]):
        os.remove(path)
    for d in os.listdir(workdir):
        if d.startswith(("tp_main", "sp_main")):
            shutil.rmtree(os.path.join(workdir, d), ignore_errors=True)
    check(res[0]["checksums"] == res[1]["checksums"],
          f"the two ranks' weights differ after the step: {res[0]['checksums']} "
          f"{res[1]['checksums']}")
    rel = res[0]["grad_rel_l2"]
    check(set(rel) == {"student", "critic"} and all(v <= DP_GRAD_TOL for v in rel.values()),
          f"reduced gradients against the one-process step: relative L2 {rel} "
          f"(limit {DP_GRAD_TOL})")
    loss_rel = {k: abs(res[0]["metrics"][k] - reference["metrics"][k])
                / abs(reference["metrics"][k]) for k in ("loss_student", "loss_critic")}
    check(all(v <= DP_GRAD_TOL for v in loss_rel.values()),
          f"2-rank losses against the one-process step: {loss_rel}")
    for r in res:
        check(r["launches"] == RANK_LAUNCHES,
              f"rank {r['rank']} launched {r['launches']}, expected {RANK_LAUNCHES}")
    print(f"[train] 2 data-parallel ranks on cuda:0 (gloo), PixArt-α-512 at {RANK_LAYERS} "
          f"blocks (the checkout's first), batch 1 each "
          f"(global 2), one dmd step: weights equal bit for bit across ranks (checked); the "
          f"reduced gradients' relative L2 against the one-process batch-2 step "
          f"{rel['student']:.3e} (student), {rel['critic']:.3e} (critic), losses "
          f"{loss_rel['loss_student']:.3e} / {loss_rel['loss_critic']:.3e} (limit "
          f"{DP_GRAD_TOL}), the update {res[0]['update_rel_l2']:.3e} (not checked); step "
          f"{res[0]['step_s']:.3f} / {res[1]['step_s']:.3f} s, peak "
          f"{res[0]['peak_gib']:.2f} / {res[1]['peak_gib']:.2f} GiB per rank (the one-process "
          f"step {reference['step_s']:.3f} s); launches per rank {res[0]['launches']}; "
          f"{wall:.1f} s with the ranks' start", flush=True)
    out = {"grad_rel_l2": rel, "loss_rel": loss_rel, "ranks": res, "wall_s": wall,
           "reference_step_s": reference["step_s"]}
    if moe_ref:
        out["moe_ep"] = moe_ep_check(res, moe_ref)
    out["tp"] = tp_check(res, reference, generated)
    out["sp"] = sp_check(res)
    out["meanwhile"] = done_meanwhile
    return out


def moe_ep_check(res: list, moe_ref: dict) -> dict:
    """The two ranks' --ep 2 results against the one-process MoE step."""
    os.remove(moe_ref["path"])
    m = [r["moe"] for r in res]
    check(m[0]["replicated_checksums"] == m[1]["replicated_checksums"],
          f"--ep 2: the ranks' leaves other than the experts differ: "
          f"{m[0]['replicated_checksums']} {m[1]['replicated_checksums']}")
    grads = [r["grad_rel_l2"] for r in m]
    check(all(g <= DP_GRAD_TOL for g in grads) and m[0]["update_rel_l2"] <= DP_GRAD_TOL,
          f"--ep 2 against the one-process step: gradients {grads}, update "
          f"{m[0]['update_rel_l2']} (relative L2, limit {DP_GRAD_TOL})")
    loss_rel = {k: abs(m[0]["metrics"][k] - moe_ref["metrics"][k]) / abs(moe_ref["metrics"][k])
                for k in ("loss_student", "loss_critic")}
    check(all(v <= DP_GRAD_TOL for v in loss_rel.values()),
          f"--ep 2 losses against the one-process step: {loss_rel}")
    for r in m:
        check(r["launches"] == RANK_LAUNCHES,
              f"an --ep 2 rank launched {r['launches']}, expected {RANK_LAUNCHES}")
    print(f"[train] 2 --ep 2 ranks on cuda:0 (gloo), MoE PixArt-α-512 at {RANK_LAYERS} blocks "
          f"(4 experts, 2 a rank), batch {MOE_EP_BATCH} on both, one dmd step: the leaves other "
          f"than the experts equal bit for bit across ranks (checked); reduced gradients "
          f"{grads[0]:.3e} / {grads[1]:.3e} and the gathered student's update "
          f"{m[0]['update_rel_l2']:.3e} relative L2 from the one-process step, losses "
          f"{loss_rel['loss_student']:.3e} / {loss_rel['loss_critic']:.3e} (limit {DP_GRAD_TOL}); "
          f"step {m[0]['step_s']:.3f} / {m[1]['step_s']:.3f} s (one process "
          f"{moe_ref['step_s']:.3f} s), peak {m[0]['peak_gib']:.2f} / {m[1]['peak_gib']:.2f} "
          f"GiB per rank; launches per rank {m[0]['launches']}", flush=True)
    return {"grad_rel_l2": grads, "update_rel_l2": m[0]["update_rel_l2"], "loss_rel": loss_rel,
            "ranks": m, "reference_step_s": moe_ref["step_s"]}


# ---- the mixture-of-experts PixArt (models/moe.py) ----

# PixArt-α-512 with each block's MLP a top-2 mixture of 4 experts at
# capacity factor 1.25 (the JAX test's --moe_experts 4 --ep 2,
# tests/test_moe.py:190-224); main() at batch 4 with 8-bit Adam, 3 steps
MOE_E, MOE_K, MOE_CF, MOE_STEPS = 4, 2, 1.25, 3
# the tiny step card against CPU: capacity factor 0.6, so that pairs drop
MOE_TINY_CF = 0.6
# the two --ep 2 ranks on one card (at RANK_LAYERS blocks): batch 4 shared
MOE_EP_BATCH = 4
MOE_PARTS = ("route", "dispatch", "experts", "combine")
# the backward's nodes of the MoE parts (autograd's evaluate_function rows)
MOE_BWD = {"experts": ("BaddbmmBackward0",), "dispatch": ("IndexCopyBackward0",),
           "combine": ("IndexBackward0", "BmmBackward0"),
           "route": ("SoftmaxBackward0", "SortBackward1")}


@contextlib.contextmanager
def moe_parts(torch, drops: list):
    """Every MoE layer's four parts (`MoEFeedForward._route`, `_dispatch`,
    `_experts`, `_combine`) each inside a record_function range
    'moe.<part>', and each call's dropped pairs (a device tensor) and
    pairs appended to `drops`."""
    from tdm_tpu_torch.models import moe

    saved = {p: getattr(moe.MoEFeedForward, "_" + p) for p in MOE_PARTS}

    def ranged(part):
        fn = saved[part]

        def wrapped(self, *args):
            with torch.profiler.record_function(f"moe.{part}"):
                out = fn(self, *args)
            if part == "route":
                gates, _, pos, cap = out
                drops.append(((pos >= cap).sum(), pos.numel()))
            return out
        return wrapped

    for p in MOE_PARTS:
        setattr(moe.MoEFeedForward, "_" + p, ranged(p))
    try:
        yield
    finally:
        for p, fn in saved.items():
            setattr(moe.MoEFeedForward, "_" + p, fn)


def moe_work(batch: int, layers: int, hidden: int = 1152, mult: int = 4) -> dict:
    """(expert-product operations, routing/dispatch/combine bytes) of one
    TDM step at `batch` (dmd, cfg 4.5, one critic update, no remat): 7
    forwards without grad, one of them the teacher's CFG call at 2·batch,
    and 2 with grad, whose backward does twice a forward's products; the
    [E, C] slots computed whole, as the JAX einsums compute them. Bytes:
    x read for the router and its [T, E] probabilities written, the k·T
    rows copied into the [E, C, D] buffer, the k·T output rows gathered and
    [T, D] written, bf16 (the forwards only)."""
    ops = nbytes = 0.0
    for rows, forwards in ((batch, 8), (2 * batch, 1)):  # 8 = 6 no-grad + 2 grad
        t = rows * 1024
        cap = max(1, min(math.ceil(MOE_CF * MOE_K * t / MOE_E), t))
        fwd_ops = 2 * 2 * MOE_E * cap * hidden * hidden * mult
        ops += forwards * fwd_ops + (2 * 2 * fwd_ops if rows == batch else 0)
        nbytes += forwards * (t * hidden * 2 + t * MOE_E * 4 + MOE_K * t * hidden * 2
                              + MOE_E * cap * hidden * 2 + MOE_K * t * hidden * 2
                              + t * hidden * 2)
    return {"expert_ops": ops * layers, "routing_bytes": nbytes * layers}


def moe_reference_step(torch, seed: int) -> dict:
    """One tiny MoE-PixArt TDM step (4 experts, top-2, capacity factor 0.6,
    fp32, dmd) on the card (the kernels) against the same step on the CPU
    (the plain versions) from one state with the same draws: the pairs each
    MoE call drops (counted), the tokens whose chosen experts differ
    between the two (counted, checked ≤ 1%), and then the bounds of
    phase_reference_train (metrics to 1e-4 relative, each role's update to
    5e-3 relative L2 and 25% of lr a weight)."""
    import dataclasses

    from tdm_tpu_torch.models import moe, pixart
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import families, optim as topt, tdm

    lr = 1e-4
    tiny = pixart.PixArtConfig.tiny
    pixart.PixArtConfig.tiny = staticmethod(
        lambda: dataclasses.replace(tiny(), moe_capacity_factor=MOE_TINY_CF))
    routes: dict = {}
    route = moe.MoEFeedForward._route

    def recorded(self, *args):
        out = route(self, *args)
        _, idx, pos, cap = out
        routes[dev].append((idx.cpu(), int((pos >= cap).sum())))
        return out

    runs, cpu_params = {}, None
    moe.MoEFeedForward._route = recorded
    try:
        for dev in ("cpu", "cuda"):
            routes[dev] = []
            bundle = families.build("pixart", tiny=True, moe_experts=MOE_E, seed=seed, device=dev)
            if cpu_params is None:
                cpu_params = bundle.init_params()
            teacher = {k: v.to(dev) for k, v in cpu_params.items()}
            gen = torch.Generator(device="cpu").manual_seed(seed + 3)
            config = tdm.TDMConfig()
            draws, cond, uncond = tiny_step_inputs(torch, config, bundle, gen, dev)
            tx = topt.make_optimizer(lr, eps=1e-4)
            state = tdm.init_state(teacher, teacher, tx, tx)
            start = {r: {k: v.clone() for k, v in getattr(state, r).items()}
                     for r in ("student", "critic")}
            step = tdm.build_train_step(bundle.denoise_fn, teacher, bundle.schedule, config,
                                        tx, tx, sample_shape=bundle.sample_shape)
            (state, metrics), launched = uncounted(A, lambda: step(state, draws, cond, uncond))
            runs[dev] = (state, metrics, start, launched)
    finally:
        moe.MoEFeedForward._route = route
        pixart.PixArtConfig.tiny = tiny
    (cs, cm, cstart, _), (gs, gm, gstart, glaunch) = runs["cpu"], runs["cuda"]
    calls = len(routes["cpu"])
    check(calls == len(routes["cuda"]) and calls > 0, "the MoE calls differ in number")
    dropped = [d for _, d in routes["cuda"]]
    differ = sum(int((a != b).any(-1).sum()) for (a, _), (b, _) in zip(routes["cpu"],
                                                                       routes["cuda"]))
    tokens = sum(a.shape[0] for a, _ in routes["cpu"])
    check(min(dropped) > 0, f"a tiny MoE call dropped no pair: {dropped}")
    check(differ <= 0.01 * tokens, f"{differ} of {tokens} tokens chose other experts")
    worst = {}
    for name in tdm.StepMetrics._fields:
        c, g = float(getattr(cm, name)), float(getattr(gm, name))
        worst[name] = abs(c - g) / max(abs(c), 1e-12)
        check(math.isfinite(g) and abs(c - g) <= 1e-4 * abs(c) + 1e-7,
              f"tiny MoE step {name}: card {g} vs cpu {c}")
    upd = {}
    for role in ("student", "critic"):
        d_c = torch.cat([(getattr(cs, role)[k] - cstart[role][k]).flatten()
                         for k in cstart[role]])
        d_g = torch.cat([(getattr(gs, role)[k] - gstart[role][k]).cpu().flatten()
                         for k in cstart[role]])
        rel = float((d_g - d_c).norm() / d_c.norm())
        top = float((d_g - d_c).abs().max())
        upd[role] = (rel, top)
        check(rel <= 5e-3 and top <= 0.25 * lr,
              f"tiny MoE step {role} update: rel L2 {rel:.3e}, max {top:.3e}")
    print(f"[moe] tiny MoE TDM step (4 experts, top-2, cf {MOE_TINY_CF}, dmd) cuda vs cpu: "
          f"{calls} MoE calls, pairs dropped per call {min(dropped)}-{max(dropped)} (of "
          f"{2 * routes['cpu'][0][0].shape[0]}-{2 * max(a.shape[0] for a, _ in routes['cpu'])}"
          f"); {differ} of {tokens} tokens chose other experts; metrics max rel err "
          f"{max(worst.values()):.3e} (limit 1e-4); update rel L2 / max: student "
          f"{upd['student'][0]:.3e} / {upd['student'][1]:.3e}, critic {upd['critic'][0]:.3e} "
          f"/ {upd['critic'][1]:.3e}; launches {glaunch}", flush=True)
    return {"calls": calls, "dropped_per_call": [min(dropped), max(dropped)],
            "tokens_routed_otherwise": differ, "tokens": tokens,
            "metrics_max_rel_err": max(worst.values()), "update": upd}


def moe_served(torch, seed: int, run_dir: str, workdir: str) -> dict:
    """The student main() exported (fp16, the JAX layout) served: a
    tdm_tpu-layout directory of it (pipeline.json with moe_experts 4, the
    file as transformer.safetensors, no decoder) through from_pretrained,
    one batch of 4 at 4 NFE to latents; against the trained student's own
    sampler (`sample_fewstep` on the trainer's denoise_fn with the exported
    weights as its fp32 masters): within one bf16 ulp of the latents'
    scale. 224 kernel-1 launches a batch (checked). The directory is
    deleted after."""
    import dataclasses

    import numpy as np

    from tdm_tpu_torch.core import sampling, schedules as sched
    from tdm_tpu_torch.io import from_jax, params as params_io
    from tdm_tpu_torch.models import moe, pixart
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import from_pretrained, loading
    from tdm_tpu_torch.train import families

    root = os.path.join(workdir, "moe_student")
    os.makedirs(root, exist_ok=True)
    weights = os.path.join(root, "transformer.safetensors")
    os.replace(os.path.join(run_dir, "student.safetensors"), weights)
    cfg = dataclasses.replace(pixart.PixArtConfig(), moe_experts=MOE_E, moe_top_k=MOE_K)
    with open(os.path.join(root, "pipeline.json"), "w") as f:
        json.dump({"family": "pixart", "model": loading.config_dict(cfg)}, f)
    rng = np.random.default_rng(seed + 29)
    text = torch.from_numpy(rng.standard_normal((4, 120, 4096)).astype(np.float32) * 0.2)
    mask = torch.from_numpy((np.arange(120)[None] < np.array([[120], [77], [13], [1]]))
                            .astype(np.int32))
    noise = torch.from_numpy(rng.standard_normal((4, 4, 64, 64)).astype(np.float32)).cuda()
    t0 = time.monotonic()
    pipe = from_pretrained(root, device="cuda")
    load_s = time.monotonic() - t0
    check(isinstance(pipe.transformer.blocks[0].ff, moe.MoEFeedForward), "no MoE block served")
    before = A.launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    served = pipe(prompt_embeds=(text, mask), latents=noise, num_inference_steps=4,
                  output_type="latent").latents.float()
    torch.cuda.synchronize()
    batch_s = time.monotonic() - t0
    launched = A.launch_counts()["flash_attention_fwd"] - before["flash_attention_fwd"]
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    bundle = families.build("pixart", moe_experts=MOE_E, mixed_precision="bf16", seed=seed,
                            device="cuda")
    from_jax.load_from_jax(params_io.load_file(weights), bundle.model)
    w = bundle.init_params()
    with torch.no_grad():  # from the pipeline's bf16 noise (`initial_noise`)
        own = sampling.sample_fewstep(
            lambda x, t, c: bundle.denoise_fn(w, x, t, c), bundle.schedule, noise.bfloat16(),
            (text.cuda(), mask.cuda()), timestep_grid=sched.fewstep_grid(900, 4)).float()
    A.reset_launches()
    del bundle, w
    gc.collect()
    torch.cuda.empty_cache()
    size_gb = os.path.getsize(weights) / 1e9
    shutil.rmtree(root, ignore_errors=True)
    diff = float((served - own).abs().max())
    scale = float(own.abs().max())
    check(torch.isfinite(served).all() and served.shape == (4, 4, 64, 64),
          "the served MoE latents are not finite [4, 4, 64, 64]")
    check(diff <= bf16_ulp(scale), f"served MoE latents {diff:.3e} from the student's own "
          f"sampler (one bf16 ulp of {scale:.3f} is {bf16_ulp(scale):.3e})")
    check(launched == PIXART_LAUNCHES_PER_BATCH,
          f"{launched} kernel-1 launches a MoE batch, expected {PIXART_LAUNCHES_PER_BATCH}")
    print(f"[moe] the exported student ({size_gb:.2f} GB fp16) served through from_pretrained "
          f"(load {load_s:.2f}s): a batch of 4 at 4 NFE in {batch_s:.3f}s, {launched} kernel-1 "
          f"launches, latents {diff:.3e} from the student's own sampler (one bf16 ulp of the "
          f"scale {scale:.3f}: {bf16_ulp(scale):.3e})", flush=True)
    return {"student_gb": size_gb, "load_s": load_s, "batch_s": batch_s,
            "launches": launched, "max_abs_diff": diff, "scale": scale}


def phase_moe(torch, seed: int, workdir: str) -> dict:
    """The mixture-of-experts PixArt: the tiny step on the card against the
    CPU (`moe_reference_step`); then full-width PixArt-α-512 with 4 experts
    a block, top-2, capacity factor 1.25 (1.50 B parameters a model copy),
    trained through the CLI's main() with --moe_experts 4 --use_8bit_adam
    at batch 4, 512², bf16, dmd, 3 steps, the teacher seeded (no MoE
    checkout exists; the JAX CLI converts only dense ones), hash prompt
    embeddings (no cache: the phase stands alone), --export_lora_rank 0,
    no final checkpoint: s/step after the first, the idle share of the
    profiled step 3, peak memory, kernels 1–3's launches per step (checked:
    TRAIN_LAUNCHES, the dense step's), the dropped share of pairs per
    call, and the MoE parts' device ms in the profiled step (forward by
    their record_function ranges, backward by autograd's nodes) beside
    their bound (`moe_work`); then the exported student served
    (`moe_served`). The two --ep 2 ranks run in the train phase's
    `dp_ranks`."""
    from torch.autograd import DeviceType

    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.ops import attention as A

    tiny = moe_reference_step(torch, seed)
    gc.collect()
    torch.cuda.empty_cache()
    saved_env = {v: os.environ.pop(v, None)
                 for v in ("TDM_EMBEDDING_CACHE", "TDM_TINY_MODEL", "TDM_TAESD_DIR")}
    out = os.path.join(workdir, "train_moe")
    steps, drops, parts = [], [], {}

    def profiled(prof, rec):
        """The kernels under each part's CPU range (its record_function's
        span on the card's timeline would count the idle gaps between its
        kernels too), and the step's busy time without those spans."""
        t0 = time.monotonic()
        for p in MOE_PARTS:
            parts[p] = {"forward_ms": 0.0, "backward_ms": 0.0}
        for ev in prof.events():
            name = ev.name
            if ev.device_type != DeviceType.CPU:
                if name.startswith("moe."):  # a range's span, not a kernel
                    rec["busy_ms"] -= ev.device_time_total / 1e3
                    rec["all_launches"] -= 1
                continue
            if name.startswith("moe."):
                parts[name[4:]]["forward_ms"] += ev.device_time_total / 1e3
            elif name.startswith("autograd::engine::evaluate_function"):
                node = name.rsplit(" ", 1)[-1]
                for p, nodes in MOE_BWD.items():
                    if node in nodes:
                        parts[p]["backward_ms"] += ev.device_time_total / 1e3
        rec["moe_parts_ms"] = parts
        print(f"[moe] the profile read in {time.monotonic() - t0:.1f}s: busy "
              f"{rec['busy_ms']:.1f} ms, {rec['all_launches']} device launches", flush=True)

    A.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        with moe_parts(torch, drops), no_final_checkpoint(), \
                timed_calls(torch, [(train_tdm, "write_student")]) as export_s:
            train_tdm.main([
                "--output_dir", out, "--max_train_steps", str(MOE_STEPS),
                "--train_batch_size", "4", "--mixed_precision", "bf16", "--loss_mode", "dmd",
                "--seed", str(seed), "--export_lora_rank", "0",
                "--moe_experts", str(MOE_E), "--moe_top_k", str(MOE_K), "--use_8bit_adam",
            ], step_hook=step_hook(torch, steps, MOE_STEPS, "moe", profiled=profiled))
    finally:
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v
    main_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = A.launch_counts()
    check_train_records(steps, MOE_STEPS)
    shares = [float(d) / n for d, n in drops]
    per_step = steps[1]["host_s"]
    busy, span = steps[-1]["busy_ms"], steps[1]["event_ms"]
    idle = None if not busy else 1 - busy / span
    work = moe_work(4, 28)
    experts_bound, _ = bound_ms(0, work["expert_ops"])
    routing_bound, _ = bound_ms(work["routing_bytes"], 0)
    experts_ms = parts["experts"]["forward_ms"] + parts["experts"]["backward_ms"]
    routing_ms = sum(parts[p]["forward_ms"] for p in ("route", "dispatch", "combine"))
    print(f"[moe] PixArt-α-512 MoE (4 experts, top-2, cf {MOE_CF}) TDM with 8-bit Adam, batch "
          f"4, bf16, seeded: {per_step:.3f} s/step after the first ({3600 / per_step:.0f} "
          f"iters/hour), first {steps[0]['host_s']:.3f} s, profiled step "
          f"{steps[-1]['host_s']:.3f} s, device busy "
          + (f"{busy:.1f} ms -> idle share {idle:.3f}" if busy else "not measured")
          + f"; peak memory {peak_gb:.2f} GiB; launches per step {TRAIN_LAUNCHES} (checked, the "
          f"dense step's); dropped share of pairs per call {min(shares):.4f}-{max(shares):.4f} "
          f"(mean {sum(shares) / len(shares):.4f}, {len(shares)} calls); main() {main_s:.1f}s "
          f"incl. the fp16 student's export {export_s.get('write_student', 0.0):.1f}s",
          flush=True)
    print(f"[moe] MoE parts' device ms in the profiled step: " + ", ".join(
        f"{p} {v['forward_ms']:.1f} fwd + {v['backward_ms']:.1f} bwd" for p, v in parts.items())
        + f"; the expert products {experts_ms:.1f} ms against their bound {experts_bound:.1f} ms"
        f" ({work['expert_ops'] / 1e12:.1f} TFLOP bf16), route + dispatch + combine forward "
        f"{routing_ms:.1f} ms against {routing_bound:.2f} ms (bytes)", flush=True)
    served = moe_served(torch, seed, out + "_cfg4.5_steps900", workdir)
    shutil.rmtree(out + "_cfg4.5_steps900", ignore_errors=True)
    return {"tiny_step": tiny, "s_per_step": per_step, "first_step_s": steps[0]["host_s"],
            "peak_gib": peak_gb, "idle_share": idle, "busy_ms": busy, "event_span_ms": span,
            "launches": launches, "launches_per_step": TRAIN_LAUNCHES,
            "dropped_share": {"min": min(shares), "max": max(shares),
                              "mean": sum(shares) / len(shares), "calls": len(shares)},
            "parts_ms": parts, "experts_ms": experts_ms, "experts_bound_ms": experts_bound,
            "routing_ms": routing_ms, "routing_bound_ms": routing_bound, "main_s": main_s,
            "export_s": export_s.get("write_student"),
            "steps": steps, "served": served}


def moe_ep_reference(torch, seed: int, path: str, device="cuda") -> dict:
    """The one-process step of the --ep 2 check (all 4 experts): its
    gradients of each role, the weights before and after and the metrics
    written to `path` for the ranks to hold theirs against."""
    rec = _Recorder()
    step, state, draws, cond, uncond = rank_setup(torch, seed, device, rec, MOE_E)
    before = {k: v.to("cpu", copy=True) for k, v in state.student.items()}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.monotonic()
    new, metrics = step(state, draws, cond, uncond)
    sync()
    step_s = time.monotonic() - t0
    metrics = {k: float(v) for k, v in metrics._asdict().items()}
    torch.save({"grads": {role: {k: v.cpu() for k, v in g.items()}
                          for role, g in rec.grads.items()},
                "before": before, "student": {k: v.cpu() for k, v in new.student.items()},
                "metrics": metrics}, path)
    print(f"[train] the one-process MoE reference step ({RANK_LAYERS} blocks, batch "
          f"{MOE_EP_BATCH}): {step_s:.3f} s, {metrics}", flush=True)
    return {"metrics": metrics, "step_s": step_s}


def moe_rank_step(torch, rank: int, spec: dict) -> dict:
    """One --ep 2 rank (`dp_rank_main`, after its dense step): the ('data',
    'fsdp', 'ep') = (1, 1, 2) mesh, the ZeRO3 reducer of two expert
    layouts, the step on all rows with this rank's 2 of 4 experts; the bit
    checksums of the new student's and critic's leaves other than the
    expert stacks, the step's seconds and peak memory, kernels 1–3's
    launches; the relative L2 of the reduced gradients against the
    reference's (this rank's experts of them), and rank 0 that of the
    gathered student's update."""
    import dataclasses

    from tdm_tpu_torch.models import moe, pixart
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(1, 1, 2)
    device = torch.device(spec.get("device", "cuda:0"))
    on_card = device.type == "cuda"

    class Recording(pmesh.ZeRO3):
        def reduce(self, role, grads):
            out = super().reduce(role, grads)
            self.grads[role] = out
            return out

    # the layouts take the parameters' shapes: the model's on the meta device
    cfg = dataclasses.replace(pixart.PixArtConfig(), num_layers=RANK_LAYERS,
                              moe_experts=MOE_E, moe_top_k=MOE_K)
    shapes = dict(pixart.PixArtTransformer2D(cfg, device="meta").named_parameters())
    sync = Recording(mesh, pmesh.ShardLayout(mesh, shapes), pmesh.ShardLayout(mesh, shapes))
    sync.grads = {}
    step, state, draws, cond, uncond = rank_setup(torch, spec["seed"], device, sync, MOE_E)
    pmesh.barrier()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t0 = time.monotonic()
    new, metrics = step(state, draws, cond, uncond)
    if on_card:
        torch.cuda.synchronize()
    out = {"step_s": time.monotonic() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
           "launches": A.launch_counts(),
           "metrics": {k: float(v) for k, v in metrics._asdict().items()},
           "replicated_checksums": {role: bit_checksum(torch, {
               k: v for k, v in getattr(new, role).items() if not moe.is_expert_key(k)})
               for role in ("student", "critic")}}
    ref = torch.load(spec["moe_ref"], map_location="cpu", mmap=True)
    n = MOE_E // mesh.n_ep
    num = den = 0.0
    for role, grads in sync.grads.items():
        for k, g in grads.items():
            r = ref["grads"][role][k]
            if moe.is_expert_key(k):
                r = r[mesh.ep_index * n:(mesh.ep_index + 1) * n]
            r = r.to(device).float()
            num += float((g.float() - r).square().sum())
            den += float(r.square().sum())
    out["grad_rel_l2"] = math.sqrt(num / den)
    student = sync.full("student", new.student)  # both ranks: a collective
    if rank == 0:
        num = den = 0.0
        for k, v in student.items():
            want = ref["student"][k].to(device) - ref["before"][k].to(device)
            got = v - ref["before"][k].to(device)
            num += float((got - want).square().sum())
            den += float(want.square().sum())
        out["update_rel_l2"] = math.sqrt(num / den)
        out["ref_metrics"] = ref["metrics"]
    return out


# the --tp 2 checks run in the two rank processes after the dense
# and --ep 2 steps: the tp TDM step against the one-process batch-2 step,
# one int8 forward against the one-process int8 forward, then the --tp 2
# server on [cuda:0, cuda:0] against the one-process pipeline
TP_SERVE_TOL = 1e-2  # the served latents' relative L2 against one process (bf16)


@contextlib.contextmanager
def int8_records(torch):
    """Every int8 operand's codes and scales, in call order, with whether
    its absmax was reduced over 'tp' (a row-parallel layer)."""
    from tdm_tpu_torch.ops import quant

    real, recs = quant.quantize_rows, []

    def rec(t, tp=None):
        codes, scale = real(t, tp)
        recs.append((codes, scale, tp is not None))
        return codes, scale

    quant.quantize_rows = rec
    try:
        yield recs
    finally:
        quant.quantize_rows = real


def int8_same(torch, one, mine, index: int, n: int) -> bool:
    """One operand's codes and scales under 'tp' against the one-process
    ones: equal, or equal to this rank's cut of them (a row layer's K
    slice, a column layer's output rows)."""
    (c1, s1, _), (c2, s2, row) = one, mine
    if c1.shape == c2.shape:
        return torch.equal(c1, c2) and torch.equal(s1, s2)
    if row:
        return torch.equal(c1.chunk(n, -1)[index], c2) and torch.equal(s1, s2)
    return torch.equal(c1.chunk(n, 0)[index], c2) and torch.equal(s1.chunk(n, 0)[index], s2)


def wait_for(path: str, what: str, limit_s: float = 180) -> None:
    """Wait until the parent has written `path` (it writes whole files)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        check(time.monotonic() - t0 < limit_s, f"no {what} at {path}")
        time.sleep(0.5)


def tp_rank_step(torch, rank: int, spec: dict) -> dict:
    """One --tp 2 rank (`dp_rank_main`, after its other steps): the ('data',
    'fsdp', 'ep', 'tp') = (1, 1, 1, 2) mesh over the same two processes, the
    dense 8-block model of the data-parallel check cut for this rank
    (`tp.parallelize`: 8 of 16 heads, half of each projection and of the
    FF), the ZeRO3 reducer of two tp layouts, the step on both rows (the
    'tp' ranks share them) against the one-process batch-2 step; before the
    cut, one --quant int8 forward whose codes and scales the cut forward
    must give again. Then the fp32 witness, the same step computed in fp32
    (TF32 off) against the one-process fp32 step (spec['ref32'], which the
    parent writes while the ranks run), and from the witness's start its
    control, in which rank 1 keeps its own partial gradient at every f (its
    backward all-reduce dropped; it still joins the collective). Returns the step's seconds, peak memory, launches and
    all-reduces, the replicated leaves' bit checksums, the gathered
    gradients' relative L2 (the step, the control, the witness), the int8
    result, and rank 0's gathered update: against the one-process AdamW
    update of the gathered gradient (its largest difference) and against
    the one-process step's update (relative L2)."""
    import copy
    import dataclasses

    from torch.func import functional_call

    from tdm_tpu_torch.device import set_fp32_precision
    from tdm_tpu_torch.models import pixart
    from tdm_tpu_torch.ops import attention as A, quant
    from tdm_tpu_torch.parallel import mesh as pmesh, tp as tp_lib
    from tdm_tpu_torch.train import optim as topt

    mesh = pmesh.make_mesh(1, 1, 1, 2)
    device = torch.device("cuda", 0)
    cfg = dataclasses.replace(pixart.PixArtConfig(), num_layers=RANK_LAYERS)
    meta = pixart.PixArtTransformer2D(cfg, device="meta")
    shapes, plan = dict(meta.named_parameters()), tp_lib.plan(meta, 2)

    class Recording(pmesh.ZeRO3):
        def reduce(self, role, grads):
            out = super().reduce(role, grads)
            self.grads[role] = out
            return out

    def recording():
        sync = Recording(mesh, pmesh.ShardLayout(mesh, shapes, plan),
                         pmesh.ShardLayout(mesh, shapes, plan))
        sync.grads = {}
        return sync

    def gathered_grads(sync, ref) -> tuple:
        """Each role's gradient gathered whole (both ranks: a collective)
        and its relative L2 against the one-process step's."""
        rel, whole = {}, {}
        for role, grads in sync.grads.items():
            whole[role] = sync.layouts[role].uncut_model(grads)
            num = den = 0.0
            for k, g in whole[role].items():
                r = ref["grads"][role][k].to(device).float()
                num += float((g.float() - r).square().sum())
                den += float(r.square().sum())
            rel[role] = math.sqrt(num / den)
        return rel, whole

    sync = recording()
    rng = torch.Generator(device=device).manual_seed(spec["seed"] + 31)
    # batch 4: every cut layer passes the int8 gates (the cross-attention's
    # k/v at 4 x 120 text rows), so the cut forward is the one-process one
    x = torch.randn((4, 4, 64, 64), generator=rng, device=device)
    t = torch.tensor([700, 250, 500, 999], device=device)
    text = torch.randn((4, 120, 4096), generator=rng, device=device) * 0.2
    mask = (torch.arange(120, device=device)[None]
            < torch.tensor([[120], [40], [77], [9]], device=device))
    box = {}

    def before_tp(model, full):
        """The one-process int8 forward, on the whole weights."""
        with torch.no_grad(), quant.quantize_int8(), int8_records(torch) as recs:
            box["one"] = functional_call(model, full, (x, t, text, mask.int()))
        box["one_recs"], box["model"] = recs, model

    step, state, draws, cond, uncond = rank_setup(
        torch, spec["seed"], device, sync, teacher_dir=spec["teacher_dir"], tp=mesh.tp,
        before_tp=before_tp)
    model = box.pop("model")
    tp_lib.reset_counts()
    with torch.no_grad(), quant.quantize_int8(), int8_records(torch) as recs:
        mine = model(x, t, text, mask.int())
    int8_calls = len(recs)
    same = int8_calls == len(box["one_recs"]) and all(
        int8_same(torch, a, b, mesh.tp.index, 2) for a, b in zip(box["one_recs"], recs))
    out = {"int8": {"calls": int8_calls, "codes_and_scales_equal": same,
                    "out_max_abs_diff": float((mine.float() - box["one"].float()).abs().max()),
                    "all_reduces": tp_lib.reduce_from_tp.calls}}
    del recs, box, mine
    before = {k: v.clone() for k, v in state.student.items()}
    pmesh.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    tp_lib.reset_counts()
    t0 = time.monotonic()
    new, metrics = step(state, draws, cond, uncond)
    torch.cuda.synchronize()
    out.update({
        "step_s": time.monotonic() - t0,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": A.launch_counts(),
        "all_reduces": tp_lib.reduce_from_tp.calls, "backward_all_reduces": tp_lib.copy_to_tp.calls,
        "metrics": {k: float(v) for k, v in metrics._asdict().items()},
        "replicated_checksums": {role: bit_checksum(torch, {
            k: v for k, v in getattr(new, role).items() if k not in plan})
            for role in ("student", "critic")}})
    ref = torch.load(spec["ref"], map_location="cpu", mmap=True)
    out["grad_rel_l2"], whole = gathered_grads(sync, ref)
    student = sync.full("student", new.student)
    gathered_before = sync.full("student", before)
    if rank == 0:
        # the update path across ranks: the gathered update against the
        # one-process AdamW update of the gathered gradient (bit for bit)
        tx = topt.make_optimizer(DP_LR)
        own = {k: v.clone() for k, v in gathered_before.items()}
        upd, _ = tx.update(whole["student"], tx.init(own), own)
        topt.apply_updates(own, upd)
        out["update_own_max_diff"] = max(float((student[k] - own[k]).abs().max()) for k in own)
        # and against the one-process step's update, for the record
        num = den = 0.0
        for k, v in student.items():
            want = ref["student"][k].to(device) - ref["before"][k].to(device)
            got = v - gathered_before[k]
            num += float((got - want).square().sum())
            den += float(want.square().sum())
        out["update_rel_l2"] = math.sqrt(num / den)
        out["ref_metrics"] = ref["metrics"]
    del new, student, gathered_before, before, whole, state, step, sync, model, ref
    del draws, cond, uncond
    gc.collect()
    torch.cuda.empty_cache()
    # the fp32 witness: the same step with no bf16 rounding
    set_fp32_precision(False)
    sync = recording()
    step, state, draws, cond, uncond = rank_setup(
        torch, spec["seed"], device, sync, teacher_dir=spec["teacher_dir"], tp=mesh.tp,
        dtype=torch.float32)
    start = copy.deepcopy(state)  # the control's start (the step updates in place)
    t0 = time.monotonic()
    step(state, draws, cond, uncond)
    torch.cuda.synchronize()
    out["fp32_step_s"] = time.monotonic() - t0
    wait_for(spec["ref32"], "one-process fp32 reference")
    ref = torch.load(spec["ref32"], map_location="cpu", mmap=True)
    out["fp32_grad_rel_l2"], _ = gathered_grads(sync, ref)
    # its control: rank 1 drops f's backward all-reduce (it joins the
    # collective and keeps its own partial), which the limit must catch
    real = tp_lib._CopyToTP.backward

    def dropped(ctx, grad):
        tp_lib.copy_to_tp.calls += 1
        tp_lib._all_reduce(grad.clone(), ctx.group)  # rank 0's sum stays whole
        return grad, None

    if rank == 1:
        tp_lib._CopyToTP.backward = staticmethod(dropped)
    try:
        step(start, draws, cond, uncond)
    finally:
        tp_lib._CopyToTP.backward = real
    out["control_grad_rel_l2"], _ = gathered_grads(sync, ref)
    return out


def tp_main_rank(torch, rank: int, spec: dict) -> dict:
    """`train_tdm.main` with --tp 2 in the two rank processes' world (gloo,
    both on cuda:0): the CLI's own mesh, cut model, ZeRO3 layouts over the
    tp plan and teacher slices, one dmd step of PixArt-α-512 at full width
    and RANK_LAYERS blocks, seeded (cut from the checkout's 28 blocks for the
    smoke's clock, `PERF.md` §4), at batch 1 (the
    'tp' ranks share their row; gloo stages each of the step's all-reduces
    through the host), the final gather on both ranks and the fp16 student
    written by rank 0 alone (`write_student` recorded: each leaf's shape),
    no final checkpoint, nor its gather of the whole state (student, critic
    and their AdamW moments through gloo: the CPU tests resume such a
    checkpoint). Returns the step's record (launches, metrics, seconds),
    the all-reduces of the run, main()'s seconds, peak memory and the
    written leaves' shapes."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.parallel import mesh as pmesh, tp as tp_lib

    out_dir = os.path.join(spec["workdir"], "tp_main")
    steps, written = [], []
    write = train_tdm.write_student

    def recorded(params, stacks, path):
        written.append({k: list(v.shape) for k, v in params.items()})
        return write(params, stacks, path)

    train_tdm.write_student = recorded
    gather_state = pmesh.ZeRO3.gather_state
    pmesh.ZeRO3.gather_state = lambda self, state: state  # only for the no-op save
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tp_lib.reset_counts()
    t0 = time.monotonic()
    try:
        with no_final_checkpoint(), family_depth("pixart", RANK_LAYERS):
            train_tdm.main([
                "--output_dir", out_dir, "--max_train_steps", "1", "--train_batch_size", "1",
                "--mixed_precision", "bf16", "--loss_mode", "dmd", "--seed", str(spec["seed"]),
                "--export_lora_rank", "0", "--tp", "2", "--device", "cuda:0",
            ], step_hook=step_hook(torch, steps, 0, f"train --tp 2 rank {rank}"))
    finally:
        train_tdm.write_student = write
        pmesh.ZeRO3.gather_state = gather_state
    return {"main_s": time.monotonic() - t0, "steps": steps,
            "all_reduces": tp_lib.reduce_from_tp.calls,
            "backward_all_reduces": tp_lib.copy_to_tp.calls,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "written": written}


TP_SERVED = (("prompt 0", 3), ("prompt 1", 11), ("prompt 2", 5))  # (cached prompt, seed)


def tp_serve_rows(torch, pipe, cache_path: str, rows) -> tuple:
    """The conditioning and noise a `MicroBatcher` over `pipe` builds for
    these (prompt, seed) requests, batched: the cache's rows in the
    model's dtype and each seed's noise (`serve.batcher.request_noise`)."""
    from tdm_tpu_torch.serve import batcher as B

    dev = pipe.device
    dtype = torch.bfloat16 if B.denoiser_of(pipe).cfg.dtype == torch.bfloat16 else None
    cond_fn = B.make_cond_fn(pipe, cache_path)
    cond = B._cat_rows([B._to_device(cond_fn(p), dev, dtype) for p, _ in rows])
    shape = B.latent_shape(pipe, {})
    noise = torch.cat([B.request_noise(seed, shape) for _, seed in rows]).to(dev)
    return cond, noise


def tp_serve_reference(torch, spec: dict) -> None:
    """The one-process pipeline's latents for the --tp 2 server's first two
    requests, written to spec['serve_ref'] (the parent process runs it
    while the ranks start)."""
    from tdm_tpu_torch.pipelines import from_pretrained

    pipe = from_pretrained(spec["serve_model"], device="cuda")
    cond, noise = tp_serve_rows(torch, pipe, spec["serve_cache"], TP_SERVED[:2])
    latents = pipe(prompt_embeds=cond, latents=noise, output_type="latent").latents
    torch.save(latents.cpu(), spec["serve_ref"] + ".tmp")
    os.replace(spec["serve_ref"] + ".tmp", spec["serve_ref"])
    del pipe
    gc.collect()
    torch.cuda.empty_cache()


def tp_serve_rank(torch, rank: int, spec: dict) -> dict:
    """The `--tp 2` server of the full-width PixArt checkout on [cuda:0,
    cuda:0] in the two rank processes' world (gloo): rank 0 builds the
    server with `serve.server.build_server` (its pipeline cut for rank 0)
    and calls its pipeline on the first two requests' conditioning and
    noise, as its batcher would build them (`tp_serve_rows`): latents
    against the one-process pipeline's (`tp_serve_reference`; relative L2
    ≤ TP_SERVE_TOL) and the first row's image; then serves the first and
    third requests through its batcher: the first row's PNG image the
    same bits with another batch-mate (batch 2, not 4, for the smoke's
    clock: gloo stages each all-reduce through the host). Rank 1 runs
    `serve.server.main` with the same flags, the follower's path, until
    the server's close stops it. Each rank: its sampler's device ms (CUDA
    events around a batch), peak memory, kernel 1's launches and its
    all-reduces per batch. The last use of the world: the server's close
    takes it down."""
    import numpy as np

    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.parallel import tp as tp_lib
    from tdm_tpu_torch.serve import server as tserver

    argv = ["--model", spec["serve_model"], "--embedding_cache", spec["serve_cache"],
            "--device", "cuda:0", "--tp", "2", "--port", "0", "--batch_size", "2",
            "--max_delay_ms", "200"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if rank == 1:
        times, calls = [], []
        real_follow = tp_lib.follow

        def timed_follow(pipe, tp):
            real_run = pipe._run

            def run(*a, **k):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                tp_lib.reset_counts()
                A.reset_launches()
                ev[0].record()
                res = real_run(*a, **k)
                ev[1].record()
                torch.cuda.synchronize()
                times.append(ev[0].elapsed_time(ev[1]))
                calls.append({"launches": A.flash_attention_fwd.launches,
                              "all_reduces": tp_lib.reduce_from_tp.calls,
                              "rows": int(a[0].shape[0])})
                return res

            pipe._run = run
            return real_follow(pipe, tp)

        tp_lib.follow = timed_follow
        try:
            tserver.main(argv)
        finally:
            tp_lib.follow = real_follow
        return {"device_ms": times, "calls": calls,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    server = tserver.build_server(tserver.parse_args(argv)).start()
    try:
        pipe = server.batcher.pipe
        check(pipe.tensor_parallel is not None and pipe.tensor_parallel.n == 2,
              "the --tp 2 server's pipeline is not cut")
        cond, noise = tp_serve_rows(torch, pipe, spec["serve_cache"], TP_SERVED[:2])
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        tp_lib.reset_counts()
        A.reset_launches()
        ev[0].record()
        got = pipe(prompt_embeds=cond, latents=noise)
        ev[1].record()
        torch.cuda.synchronize()
        device_ms = ev[0].elapsed_time(ev[1])
        launches, all_reduces = A.flash_attention_fwd.launches, tp_lib.reduce_from_tp.calls
        futures = [server.batcher.submit(p, seed=s) for p, s in TP_SERVED[::2]]
        served = [np.asarray(f.result(timeout=300)) for f in futures]
    finally:
        server.close()
    t0 = time.monotonic()
    while not os.path.exists(spec["serve_ref"]):  # the parent writes it while the ranks start
        check(time.monotonic() - t0 < 120, "no one-process reference for the --tp 2 server")
        time.sleep(0.5)
    ref = torch.load(spec["serve_ref"]).to(got.latents.device)
    rel = float((got.latents.float() - ref.float()).norm() / ref.float().norm())
    first = got.images[0].float().cpu().numpy()
    return {"rel_l2": rel, "mates_equal": bool(np.array_equal(served[0], first)),
            "device_ms": device_ms, "launches": launches, "all_reduces": all_reduces,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "served": [list(x.shape) for x in served],
            "finite": bool(torch.isfinite(got.latents.float()).all())}


def tp_generate(torch, spec: dict) -> dict:
    """`python -m tdm_tpu_torch.cli.generate --tp 2 --device cuda:0` in
    this process (rank 0: it encodes from the cache, draws the noise and
    decodes) on the 28-block PixArt checkout's cache-served view: `launch`
    starts rank 1 as a `generate` process of its own over gloo on a free
    port, and its exit is checked when the call ends. One prompt at batch
    1 to a PNG; rank 0's kernel-1 launches and all-reduces of the call,
    its seconds (the follower's start and load included)."""
    import numpy as np

    from tdm_tpu_torch.cli import generate
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.parallel import tp as tp_lib

    path = os.path.join(spec["workdir"], "tp_generate.png")
    launches, reduces = A.flash_attention_fwd.launches, tp_lib.reduce_from_tp.calls
    t0 = time.monotonic()
    generate.main(["--model", spec["serve_model"], "--embedding_cache", spec["serve_cache"],
                   "--prompt", TP_SERVED[0][0], "--seed", str(TP_SERVED[0][1]), "--tp", "2",
                   "--device", "cuda:0", "--output", path])
    wall = time.monotonic() - t0
    with open(path, "rb") as f:
        std = float(check_png(f.read(), 512, 512).astype(np.float32).std())
    os.remove(path)
    return {"s": wall, "launches": A.flash_attention_fwd.launches - launches,
            "all_reduces": tp_lib.reduce_from_tp.calls - reduces, "pixel_std": std}


# the --tp 2 step's gathered gradients against the one-process step
# (relative L2): a bound on rounding, not a test of the wiring. bf16
# partial products are summed over 'tp' after they round, as the JAX
# package's sharded dots are, so the cut step rounds elsewhere than the
# whole one (2.317e-02 on the student; its control with a dropped f read
# 2.381e-02, `PERF.md` §6, PR 19)
TP_GRAD_TOL = 5e-2
# the same step in fp32 against the one-process fp32 step: the wiring's
# test, set between the sound step (1.583e-05) and its control (a dropped
# f; `PERF.md` §6, PR 19)
TP_FP32_TOL = 1e-4


def tp_check(res: list, reference: dict, generated: dict) -> dict:
    """The two ranks' --tp 2 results: the training step against the
    one-process batch-2 step (with its control and fp32 witness), int8
    against the one-process int8 forward, train_tdm.main --tp 2, the
    served batch against the one-process pipeline, and `generate --tp 2`:
    printed, then each checked."""
    import dataclasses

    from tdm_tpu_torch.models import pixart

    t = [r["tp"] for r in res]
    m = [r["tp_main"] for r in res]
    loss_rel = {k: abs(t[0]["metrics"][k] - reference["metrics"][k])
                / abs(reference["metrics"][k]) for k in ("loss_student", "loss_critic")}
    s0, s1 = res[0]["tp_serve"], res[1]["tp_serve"]
    g, c, w = t[0]["grad_rel_l2"], t[0]["control_grad_rel_l2"], t[0]["fp32_grad_rel_l2"]
    print(f"[train] --tp 2 on [cuda:0, cuda:0] (gloo), PixArt-α-512 at {RANK_LAYERS} blocks, "
          f"8 of 16 heads a rank, batch 2 on both ranks, one dmd step: the leaves tp does not "
          f"cut equal bit for bit across ranks (checked); gathered gradients' relative L2 "
          f"against the one-process step {g['student']:.3e} (student), {g['critic']:.3e} "
          f"(critic) (limit {TP_GRAD_TOL}); the fp32 witness against the one-process fp32 step "
          f"{w['student']:.3e} / {w['critic']:.3e} (limit {TP_FP32_TOL}, step "
          f"{t[0]['fp32_step_s']:.3f} s), its control (rank 1's f backward all-reduce dropped) "
          f"{c['student']:.3e} / {c['critic']:.3e} (must exceed the limit); losses "
          f"{loss_rel['loss_student']:.3e} / {loss_rel['loss_critic']:.3e} (limit "
          f"{DP_GRAD_TOL}); the gathered update is the one-process AdamW update of the "
          f"gathered gradient (max |diff| {t[0]['update_own_max_diff']:.3g}, checked), and "
          f"{t[0]['update_rel_l2']:.3e} from the one-process step's (not checked: Adam's first "
          f"step is lr·sign(g) wherever |g| ≫ eps); step {t[0]['step_s']:.3f} / "
          f"{t[1]['step_s']:.3f} s, peak {t[0]['peak_gib']:.2f} / {t[1]['peak_gib']:.2f} GiB a "
          f"rank, all-reduces {t[0]['all_reduces']} forward + {t[0]['backward_all_reduces']} "
          f"backward a rank, launches a rank {t[0]['launches']} (checked)", flush=True)
    print(f"[train] --tp 2 int8 forward: {t[0]['int8']['calls']} quantized operands a rank, "
          f"codes and scales equal to the one-process int8 forward's (checked), output max "
          f"|diff| {t[0]['int8']['out_max_abs_diff']:.3g} / {t[1]['int8']['out_max_abs_diff']:.3g}, "
          f"{t[0]['int8']['all_reduces']} sum all-reduces a rank", flush=True)
    print(f"[train] train_tdm.main --tp 2 --device cuda:0 in the ranks' world, PixArt-α-512 at "
          f"{RANK_LAYERS} blocks, seeded, batch 1, one step: {m[0]['steps'][0]['host_s']:.3f} / "
          f"{m[1]['steps'][0]['host_s']:.3f} s, main() {m[0]['main_s']:.1f} / "
          f"{m[1]['main_s']:.1f} s, peak {m[0]['peak_gib']:.2f} / {m[1]['peak_gib']:.2f} GiB a "
          f"rank, all-reduces {m[0]['all_reduces']} forward + {m[0]['backward_all_reduces']} "
          f"backward a rank, launches {m[0]['steps'][0]['launches']}, "
          f"{m[0]['steps'][0]['metrics']}; the student written once, by rank 0, whole "
          f"(checked)", flush=True)
    print(f"[serve] --tp 2 server (serve.server on [cuda:0, cuda:0], gloo, the follower by "
          f"serve.server.main), PixArt-α-512 28 blocks, a batch of 2 latents: relative L2 "
          f"{s0['rel_l2']:.3e} against the one-process pipeline (limit {TP_SERVE_TOL}); a row "
          f"with other batch-mates bit for bit (checked); kernel 1 {s0['launches']} launches "
          f"a batch a rank (checked); sampler device ms (CUDA events) rank 0 "
          f"{s0['device_ms']:.1f}, rank 1 "
          f"{', '.join(f'{m:.1f}' for m in s1['device_ms'])}; all-reduces a batch "
          f"{s0['all_reduces']} / {s1['calls'][-1]['all_reduces']}; peak "
          f"{s0['peak_gib']:.2f} / {s1['peak_gib']:.2f} GiB; two PNG requests through the "
          f"batcher {s0['served']}", flush=True)
    print(f"[generate] --tp 2 --device cuda:0 (rank 1 started by the command, gloo): one "
          f"512x512 PNG in {generated['s']:.1f} s, the follower's start and load included "
          f"(pixel std {generated['pixel_std']:.1f}); rank 0 kernel 1 {generated['launches']} "
          f"launches, {generated['all_reduces']} all-reduces", flush=True)
    check(t[0]["replicated_checksums"] == t[1]["replicated_checksums"],
          f"--tp 2: the leaves 'tp' does not cut differ across the ranks: "
          f"{t[0]['replicated_checksums']} {t[1]['replicated_checksums']}")
    for r in t:
        check(all(v <= TP_GRAD_TOL for v in r["grad_rel_l2"].values()),
              f"--tp 2 gathered gradients against the one-process step: {r['grad_rel_l2']}")
        check(min(r["control_grad_rel_l2"].values()) > TP_FP32_TOL,
              f"--tp 2 fp32 control (f's all-reduce dropped on rank 1) within the limit: "
              f"{r['control_grad_rel_l2']}")
        check(all(v <= TP_FP32_TOL for v in r["fp32_grad_rel_l2"].values()),
              f"--tp 2 fp32 witness against the one-process fp32 step: {r['fp32_grad_rel_l2']}")
        check(r["launches"] == RANK_LAUNCHES,
              f"--tp 2 rank launched {r['launches']}, expected {RANK_LAUNCHES}")
        check(r["int8"]["codes_and_scales_equal"] and r["int8"]["calls"] > 0,
              f"--tp 2 int8: codes and scales differ from one process: {r['int8']}")
    check(t[0]["update_own_max_diff"] == 0.0,
          f"--tp 2 gathered update against the one-process AdamW update of the gathered "
          f"gradient: max |diff| {t[0]['update_own_max_diff']}")
    check(all(v <= DP_GRAD_TOL for v in loss_rel.values()),
          f"--tp 2 losses against the one-process step: {loss_rel}")
    whole = {k: list(p.shape) for k, p in pixart.PixArtTransformer2D(
        dataclasses.replace(pixart.PixArtConfig(), num_layers=RANK_LAYERS),
        device="meta").named_parameters()}
    per_fwd, per_bwd = 3 * RANK_LAYERS, 2 * 4 * RANK_LAYERS  # 3 a block; f 4 a block a backward
    for r, mr in enumerate(m):
        check(len(mr["steps"]) == 1 and mr["steps"][0]["launches"] == RANK_LAUNCHES
              and all(math.isfinite(v) for v in mr["steps"][0]["metrics"].values()),
              f"train_tdm.main --tp 2 rank {r}: {mr['steps']}")
        check(mr["backward_all_reduces"] == per_bwd and mr["all_reduces"] >= 9 * per_fwd
              and mr["all_reduces"] % per_fwd == 0,
              f"train_tdm.main --tp 2 rank {r} all-reduces {mr['all_reduces']} + "
              f"{mr['backward_all_reduces']}, expected {per_fwd} a forward and {per_bwd} a "
              f"step's backwards")
    check(m[0]["written"] == [whole] and m[1]["written"] == [],
          "train_tdm.main --tp 2: the student is not written once, whole, by rank 0")
    check(s0["finite"] and s0["rel_l2"] <= TP_SERVE_TOL,
          f"--tp 2 served latents against one process: rel L2 {s0['rel_l2']} "
          f"(limit {TP_SERVE_TOL})")
    check(s0["mates_equal"], "--tp 2: a served row changed with its batch-mates")
    check(s0["launches"] == PIXART_LAUNCHES_PER_BATCH,
          f"--tp 2 rank 0 launched kernel 1 {s0['launches']}x a batch, expected "
          f"{PIXART_LAUNCHES_PER_BATCH}")
    check(s1["calls"] and all(c["launches"] == PIXART_LAUNCHES_PER_BATCH for c in s1["calls"]),
          f"--tp 2 follower launches per batch: {s1['calls']}")
    check(s0["served"] and all(s == [512, 512, 3] for s in s0["served"]),
          f"--tp 2 served images: {s0['served']}")
    check(generated["launches"] == PIXART_LAUNCHES_PER_BATCH
          and generated["all_reduces"] == 4 * 84 and generated["pixel_std"] > 1.0,
          f"generate --tp 2: {generated}")
    return {"step": t, "loss_rel": loss_rel, "main": m, "serve": [s0, s1],
            "generate": generated}


# --sp 2 on [cuda:0, cuda:0] (the train phase's two gloo ranks): CogVideoX-2B
# at full width, 61 frames at 480×720 (SP_LAT_F latent frames, SP_SHARD video
# rows a rank); the training step at RANK_LAYERS blocks with remat, as the
# recipe's --gradient_checkpointing; the fp32 witness at SP_WITNESS_FRAMES
# latent frames (2 a rank) and SP_WITNESS_LAYERS blocks (the fp32 kernels are
# scalar, gloo stages every permute through the host, and the witness tests
# the wiring, which neither the frame count nor the depth changes)
SP_WITNESS_FRAMES, SP_WITNESS_LAYERS = 4, 2
SP_TEXT_LEN = 120  # the live rows of the seeded T5 conditioning (226 in all)
COG_RANK_LAUNCHES = {k: v * RANK_LAYERS // 30 for k, v in COG_TRAIN_LAUNCHES.items()}
# per attention call at SP_N with the T5 prefix: SP_N − 1 permutes of the K/V
# shard forward, SP_N backward (the K/V with the fp32 dK/dV, then the
# accumulators home)
SP_FWD_PERMUTES, SP_BWD_PERMUTES = SP_N - 1, SP_N
# the sp step's summed gradients against the one-process step (relative L2):
# a bound on rounding (each hop's output rounds to bf16 before the fp32
# merge), not a test of the wiring, which the fp32 witness carries within
# SP_FP32_TOL, its control (rank 1 keeps its own accumulators on the return
# hop) beyond it; the served latents against one process
SP_GRAD_TOL = 5e-2
SP_FP32_TOL = 1e-4
SP_SERVE_TOL = 1e-2


def seed_cogvideox(torch, model, seed: int) -> None:
    """Every parameter N(0, 0.02) but the LayerNorms' scales, 1 + N(0,
    0.02), drawn on the card from the seed, the same in every process. The
    per-head qk norms at unit scale give logits of unit spread: at N(0,
    0.02) every row's softmax is uniform, each key's dV the same and its dK
    ~0, and a shard's gradients sent to the wrong rank would change
    nothing: the sp control could not see its fault."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = 0.02 * torch.randn(p.shape, generator=gen, device="cuda")
            p.copy_(noise + 1 if name.endswith(".scale") else noise)


def sp_text(torch, seed: int, device, batch: int = 1):
    """Seeded T5-shaped conditioning [B, 226, 4096] with SP_TEXT_LEN live
    rows (the family's cond_of zeroes the rest), the same in every process."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    text = 0.2 * torch.randn((batch, COG_TXT, 4096), generator=gen, device="cuda")
    text[:, SP_TEXT_LEN:] = 0
    return text.to(device)


@contextlib.contextmanager
def recorded_permutes():
    """Every `parallel.mesh.ppermute` call recorded: its tensors' count and
    bytes, and its direction (backward when it carries an fp32 tensor: the
    dK/dV accumulators; the bf16 forwards' K/V shards are bf16)."""
    import torch

    from tdm_tpu_torch.parallel import mesh as pmesh

    real, calls = pmesh.ppermute, []

    def recorded(tensors, sp):
        calls.append({"n": len(tensors), "bytes": sum(t.numel() * t.element_size()
                                                      for t in tensors),
                      "backward": any(t.dtype == torch.float32 for t in tensors)})
        return real(tensors, sp)

    pmesh.ppermute = recorded
    try:
        yield calls
    finally:
        pmesh.ppermute = real


def permute_tally(calls: list) -> dict:
    fwd = [c for c in calls if not c["backward"]]
    bwd = [c for c in calls if c["backward"]]
    return {"forward": len(fwd), "backward": len(bwd),
            "forward_mb": sorted({round(c["bytes"] / 1e6, 1) for c in fwd}),
            "backward_mb": sorted({round(c["bytes"] / 1e6, 1) for c in bwd}),
            "gb": sum(c["bytes"] for c in calls) / 1e9}


def sp_serve_model(torch, seed: int, device, sp: bool):
    """CogVideoX-2B (30 blocks, 30×64 heads, bf16 serving weights, seeded),
    its config naming 'sp' when `sp`."""
    import dataclasses

    from tdm_tpu_torch.models import cogvideox as cog

    cfg = dataclasses.replace(cog.CogVideoXConfig(),
                              sequence_parallel_axis="sp" if sp else None)
    model = cog.CogVideoXTransformer3D(cfg, device=device)
    seed_cogvideox(torch, model, seed + 41)
    return model


def sp_serve_call(torch, seed: int, device) -> dict:
    """The pipeline call of the sp serving check: batch 1, 4 NFE on the
    trained grid, SP_FRAMES frames at 480×720, latents out, the seeded
    conditioning and noise."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 43)
    noise = torch.randn((1, 16, SP_LAT_F, 60, 90), generator=gen, device="cuda")
    return {"prompt_embeds": sp_text(torch, seed + 47, device), "latents": noise.to(device),
            "num_frames": SP_FRAMES, "height": 480, "width": 720, "output_type": "latent"}


def sp_serve_reference(torch, spec: dict) -> None:
    """The one-process pipeline's latents for the sp serving check, written
    to spec['sp_serve_ref'] (the parent, while the ranks run), with the
    transformer's bit checksum."""
    from tdm_tpu_torch.pipelines import CogVideoXPipeline

    model = sp_serve_model(torch, spec["seed"], "cuda", sp=False)
    pipe = CogVideoXPipeline(model, device="cuda")
    latents = pipe(**sp_serve_call(torch, spec["seed"], "cuda")).latents
    torch.save({"latents": latents.cpu(), "checksum": bit_checksum(torch, dict(
        model.named_parameters()))}, spec["sp_serve_ref"] + ".tmp")
    os.replace(spec["sp_serve_ref"] + ".tmp", spec["sp_serve_ref"])
    del pipe, model
    gc.collect()
    torch.cuda.empty_cache()


def cog_sp_setup(torch, seed: int, device, sync, mesh=None, frames: int = SP_LAT_F,
                 dtype=None, layers: int = RANK_LAYERS):
    """The sp checks' training step: CogVideoX-2B at full width and
    `layers` blocks with remat, seeded (the teacher, the student and the
    critic start equal), fp32 masters computing in bf16 (or `dtype`), dmd,
    cfg 4.5, the CLI's TDM defaults, AdamW at DP_LR with the clip's norm
    through `sync`, batch 1 of `frames` latent frames at 480×720, the
    seeded conditioning, the CFG null branch zeros, and one seeded
    generator's draws. With `mesh` the denoiser is
    `sequence_parallel_apply` over its 'sp' axis (each rank its frames);
    else the one-process forward. Returns (step, state, draws, cond,
    uncond)."""
    import dataclasses
    import functools

    from torch.func import functional_call

    from tdm_tpu_torch.core import schedules as sched
    from tdm_tpu_torch.models import cogvideox as cog
    from tdm_tpu_torch.train import optim as topt, tdm

    cfg = dataclasses.replace(cog.CogVideoXConfig(), num_layers=layers,
                              sample_frames=frames, remat=True,
                              dtype=dtype or torch.bfloat16,
                              sequence_parallel_axis="sp" if mesh is not None else None)
    model = cog.CogVideoXTransformer3D(cfg, device=device, param_dtype=torch.float32)
    model.requires_grad_(False)
    seed_cogvideox(torch, model, seed + 29)
    full = {k: p.detach() for k, p in model.named_parameters()}
    if mesh is not None:
        fwd = cog.sequence_parallel_apply(model, mesh)

        def denoise_fn(params, x, t, cond):
            return fwd(x, t, cond, params=params)
    else:
        def denoise_fn(params, x, t, cond):
            return functional_call(model, params, (x, t, cond))

    tx_s, tx_c = (topt.make_optimizer(DP_LR, norm_fn=functools.partial(sync.norm, role))
                  for role in ("student", "critic"))
    config = tdm.TDMConfig(use_huber=False, use_separate=False)
    shape = (16, frames, 60, 90)
    step = tdm.build_train_step(denoise_fn, full, sched.cogvideox(device=device), config,
                                tx_s, tx_c, sample_shape=shape, sync=sync)
    state = tdm.init_state(full, full, tx_s, tx_c)
    cond = sp_text(torch, seed + 37, device)
    draws = tdm.make_draws(config, 1, shape, torch.Generator(device=device).manual_seed(seed + 3),
                           device)
    return step, state, draws, cond, torch.zeros_like(cond)


def sp_step_reference(torch, seed: int, path: str, frames: int = SP_LAT_F, dtype=None,
                      layers: int = RANK_LAYERS) -> None:
    """The one-process step of the sp check (its gradients of each role,
    the student before and after, the metrics) written to `path` for the
    ranks (the parent, while they run). In fp32 with TF32 off for the
    witness."""
    if dtype == torch.float32:
        from tdm_tpu_torch.device import set_fp32_precision

        set_fp32_precision(False)
    rec = _Recorder()
    step, state, draws, cond, uncond = cog_sp_setup(torch, seed, "cuda", rec, frames=frames,
                                                    dtype=dtype, layers=layers)
    before = {k: v.to("cpu", copy=True) for k, v in state.student.items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    new, metrics = step(state, draws, cond, uncond)
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    metrics = {k: float(v) for k, v in metrics._asdict().items()}
    torch.save({"grads": {role: {k: v.cpu() for k, v in g.items()}
                          for role, g in rec.grads.items()}, "metrics": metrics,
                "before": before, "student": {k: v.cpu() for k, v in new.student.items()},
                "step_s": step_s}, path + ".tmp")
    os.replace(path + ".tmp", path)
    print(f"[train] the one-process CogVideoX-2B reference step at {layers} blocks, "
          f"{frames} latent frames{' in fp32' if dtype == torch.float32 else ''}: "
          f"{step_s:.3f} s, {metrics}", flush=True)
    del step, state, new, rec
    gc.collect()
    torch.cuda.empty_cache()


def sp_references(torch, spec: dict) -> None:
    """The parent's references of the sp checks, in the order the ranks
    read them."""
    sp_serve_reference(torch, spec)
    sp_step_reference(torch, spec["seed"], spec["sp_ref"])
    sp_step_reference(torch, spec["seed"], spec["sp_ref32"], frames=SP_WITNESS_FRAMES,
                      dtype=torch.float32, layers=SP_WITNESS_LAYERS)


def rel_l2_against(torch, got: dict, ref: dict, device) -> float:
    num = den = 0.0
    for k, g in got.items():
        r = ref[k].to(device).float()
        num += float((g.float() - r).square().sum())
        den += float(r.square().sum())
    return math.sqrt(num / den)


def sp_rank_checks(torch, rank: int, spec: dict) -> dict:
    """The --sp 2 checks of one of the two rank processes (`dp_rank_main`,
    after the tp checks), on the ('data', 'sp') = (1, 2) mesh of their gloo
    world, both on cuda:0:

    * serving: `CogVideoXPipeline(..., sequence_parallel_mesh=mesh)` of the
      seeded 30-block CogVideoX-2B (bf16), batch 1, 4 NFE, SP_FRAMES frames
      at 480×720 (each rank 8 of 16 latent frames, 10,800 video rows),
      latents out: against the one-process pipeline's (the parent's,
      relative L2), its sampler's device ms (CUDA events), kernel 1's
      launches and the permutes of the call, peak memory;
    * the training step at RANK_LAYERS blocks (`cog_sp_setup`, remat),
      batch 1, both ranks on the row and each on its frames: launches,
      permutes by direction, seconds, peak memory, the new weights' bit
      checksums, the summed gradients, losses and update against the
      one-process step (the parent's);
    * the fp32 witness (the same step in fp32, TF32 off, at
      SP_WITNESS_FRAMES latent frames and SP_WITNESS_LAYERS blocks) against
      the one-process fp32 step,
      and its control from the witness's start: rank 1 keeps its own dK/dV
      accumulators on each backward's return hop (it joins the exchange,
      so rank 0's stay whole);
    * `train_tdm.main --sp 2` (`sp_main_rank`)."""
    import copy

    from tdm_tpu_torch.device import set_fp32_precision
    from tdm_tpu_torch.ops import attention as A, ring_attention as ring
    from tdm_tpu_torch.parallel import mesh as pmesh
    from tdm_tpu_torch.pipelines import CogVideoXPipeline

    device = torch.device("cuda", 0)
    mesh = pmesh.make_mesh(1, n_sp=SP_N)
    check(mesh.sp.n == SP_N and mesh.sp.index == rank, f"sp axis {mesh.sp}")
    out = {"seconds": {}}
    t_part = time.monotonic()

    def part_done(name):
        nonlocal t_part
        out["seconds"][name] = time.monotonic() - t_part
        t_part = time.monotonic()

    # serving
    model = sp_serve_model(torch, spec["seed"], device, sp=True)
    checksum = bit_checksum(torch, dict(model.named_parameters()))
    pipe = CogVideoXPipeline(model, sequence_parallel_mesh=mesh, device=device)
    call = sp_serve_call(torch, spec["seed"], device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pmesh.barrier()
    A.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with recorded_permutes() as perms:
        t0 = time.monotonic()
        ev[0].record()
        latents = pipe(**call).latents
        ev[1].record()
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    wait_for(spec["sp_serve_ref"], "one-process sp serving reference")
    ref = torch.load(spec["sp_serve_ref"])
    rel = float((latents.float() - ref["latents"].to(device).float()).norm()
                / ref["latents"].float().norm())
    out["serve"] = {"rel_l2": rel, "finite": bool(torch.isfinite(latents.float()).all()),
                    "shape": list(latents.shape), "device_ms": ev[0].elapsed_time(ev[1]),
                    "wall_s": wall, "launches": A.launch_counts(),
                    "permutes": permute_tally(perms),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "checksum_equal": checksum == ref["checksum"]}
    del pipe, model, latents, call, ref
    gc.collect()
    torch.cuda.empty_cache()
    part_done("serve")

    class Recording(pmesh.DataParallel):
        def reduce(self, role, grads):
            out_ = super().reduce(role, grads)
            self.grads[role] = out_
            return out_

    def recording():
        sync = Recording(mesh)
        sync.grads = {}
        return sync

    # the bf16 step
    sync = recording()
    step, state, draws, cond, uncond = cog_sp_setup(torch, spec["seed"], device, sync, mesh)
    before = {k: v.clone() for k, v in state.student.items()}
    pmesh.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    with recorded_permutes() as perms:
        t0 = time.monotonic()
        new, metrics = step(state, draws, cond, uncond)
        torch.cuda.synchronize()
    rec = {"step_s": time.monotonic() - t0, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": A.launch_counts(), "permutes": permute_tally(perms),
           "metrics": {k: float(v) for k, v in metrics._asdict().items()},
           "checksums": {role: bit_checksum(torch, getattr(new, role))
                         for role in ("student", "critic")}}
    wait_for(spec["sp_ref"], "one-process sp reference step")
    ref = torch.load(spec["sp_ref"], map_location="cpu", mmap=True)
    rec["grad_rel_l2"] = {role: rel_l2_against(torch, g, ref["grads"][role], device)
                          for role, g in sync.grads.items()}
    rec["update_rel_l2"] = rel_l2_against(
        torch, {k: v - ref["before"][k].to(device) for k, v in new.student.items()},
        {k: ref["student"][k] - ref["before"][k] for k in ref["student"]}, device)
    rec["ref_metrics"] = ref["metrics"]
    rec["ref_step_s"] = ref["step_s"]
    out["step"] = rec
    del step, state, new, before, sync, ref, draws, cond, uncond
    gc.collect()
    torch.cuda.empty_cache()
    part_done("step")
    # the fp32 witness and its control
    set_fp32_precision(False)
    sync = recording()
    step, state, draws, cond, uncond = cog_sp_setup(torch, spec["seed"], device, sync, mesh,
                                                    frames=SP_WITNESS_FRAMES,
                                                    dtype=torch.float32,
                                                    layers=SP_WITNESS_LAYERS)
    start = copy.deepcopy(state)
    t0 = time.monotonic()
    step(state, draws, cond, uncond)
    torch.cuda.synchronize()
    out["fp32_step_s"] = time.monotonic() - t0
    wait_for(spec["sp_ref32"], "one-process fp32 sp reference step")
    ref = torch.load(spec["sp_ref32"], map_location="cpu", mmap=True)
    out["fp32_grad_rel_l2"] = {role: rel_l2_against(torch, g, ref["grads"][role], device)
                               for role, g in sync.grads.items()}
    real_bwd, real_perm = ring.RingFlashAttention.backward, pmesh.ppermute
    box = {"in": False, "seen_shard": False}

    def backward(ctx, dout):
        box.update({"in": True, "seen_shard": False})
        try:
            return real_bwd(ctx, dout)
        finally:
            box["in"] = False

    def permute(tensors, sp):
        got = real_perm(tensors, sp)
        if box["in"] and len(tensors) == 4:
            box["seen_shard"] = True
        if box["in"] and box["seen_shard"] and len(tensors) == 2:
            return list(tensors)  # the return hop: its own accumulators kept
        return got

    if rank == 1:
        ring.RingFlashAttention.backward = staticmethod(backward)
        pmesh.ppermute = permute
    try:
        step(start, draws, cond, uncond)
    finally:
        ring.RingFlashAttention.backward, pmesh.ppermute = real_bwd, real_perm
    out["control_grad_rel_l2"] = {role: rel_l2_against(torch, g, ref["grads"][role], device)
                                  for role, g in sync.grads.items()}
    del step, state, start, sync, ref, draws, cond, uncond
    gc.collect()
    torch.cuda.empty_cache()
    pmesh.barrier()
    part_done("fp32_witness_and_control")
    out["main"] = sp_main_rank(torch, rank, spec)
    part_done("main")
    return out


@contextlib.contextmanager
def family_depth(family: str, layers: int):
    """main() on a family's full-width model cut to `layers` blocks: its
    config class (`pixart.PixArtConfig` or `cogvideox.CogVideoXConfig`)
    made with num_layers replaced, every width its own."""
    import dataclasses
    import importlib

    mod = importlib.import_module(f"tdm_tpu_torch.models.{family}")
    name = {"pixart": "PixArtConfig", "cogvideox": "CogVideoXConfig"}[family]
    cls = getattr(mod, name)

    def cut(*args, **kwargs):
        return dataclasses.replace(cls(*args, **kwargs), num_layers=layers)

    cut.tiny = cls.tiny
    setattr(mod, name, cut)
    try:
        yield
    finally:
        setattr(mod, name, cls)


# main() --sp 2's depth: two ranks fit on the card at all 30 blocks, but gloo
# stages each permute through the host, and a 30-block step moves ~55 GB a
# rank, more than the smoke's clock holds; 8 blocks run the same path
SP_MAIN_LAYERS = RANK_LAYERS


def sp_main_rank(torch, rank: int, spec: dict) -> dict:
    """`train_tdm.main --sp 2 --model_family cogvideox --num_frames 61` in
    the two rank processes' world (gloo, both on cuda:0) with the recipe's
    flags (a rank-64 LoRA student, 8-bit Adam, --gradient_checkpointing),
    batch 1, one step, CogVideoX-2B at full width and SP_MAIN_LAYERS blocks,
    seeded (no teacher directory), hash prompt embeddings (no cache: the
    train phase's holds PixArt's 120-token rows): the step's launches,
    metrics and seconds, the permutes by direction, main()'s seconds and
    peak memory; no final checkpoint and no fp16 student (the LoRA file is
    written)."""
    from tdm_tpu_torch.cli import train_tdm

    out_dir = os.path.join(spec["workdir"], "sp_main")
    steps = []
    saved = {k: os.environ.pop(k, None) for k in ("TDM_EMBEDDING_CACHE", "TDM_TAESD_DIR")}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        with no_final_checkpoint(), no_student_export(), \
                family_depth("cogvideox", SP_MAIN_LAYERS), recorded_permutes() as perms:
            train_tdm.main([
                "--output_dir", out_dir, "--max_train_steps", "1", "--train_batch_size", "1",
                "--mixed_precision", "bf16", "--loss_mode", "dmd", "--seed", str(spec["seed"]),
                "--model_family", "cogvideox", "--num_frames", str(SP_FRAMES),
                "--train_lora_rank", str(COG_LORA_RANK), "--use_8bit_adam",
                "--gradient_checkpointing", "--sp", str(SP_N), "--device", "cuda:0",
            ], step_hook=step_hook(torch, steps, 0, f"train --sp {SP_N} rank {rank}"))
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    lora = os.path.join(out_dir + "_cfg4.5_steps900", "tdm_lora.safetensors")
    return {"main_s": time.monotonic() - t0, "steps": steps, "permutes": permute_tally(perms),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "lora_written": os.path.exists(lora)}


def sp_check(res: list) -> dict:
    """The two ranks' --sp 2 results: printed, then each checked."""
    sp = [r["sp"] for r in res]
    sv, st, m = [r["serve"] for r in sp], [r["step"] for r in sp], [r["main"] for r in sp]
    serve_launches = ring_launches({"flash_attention_fwd": 30 * 4, "flash_attention_fwd_lse": 0,
                                    "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0})
    step_launches = ring_launches(COG_RANK_LAUNCHES)
    main_mono = {k: v * SP_MAIN_LAYERS // 30 for k, v in COG_TRAIN_LAUNCHES.items()}
    main_launches = ring_launches(main_mono)
    attn_calls = COG_RANK_LAUNCHES["flash_attention_fwd"] + COG_RANK_LAUNCHES[
        "flash_attention_fwd_lse"]
    step_perms = (SP_FWD_PERMUTES * attn_calls,
                  SP_BWD_PERMUTES * COG_RANK_LAUNCHES["flash_attention_bwd_dq"])
    main_calls = main_mono["flash_attention_fwd"] + main_mono["flash_attention_fwd_lse"]
    main_perms = (SP_FWD_PERMUTES * main_calls,
                  SP_BWD_PERMUTES * main_mono["flash_attention_bwd_dq"])
    g, w, c = st[0]["grad_rel_l2"], sp[0]["fp32_grad_rel_l2"], sp[0]["control_grad_rel_l2"]
    loss_rel = {k: abs(st[0]["metrics"][k] - st[0]["ref_metrics"][k])
                / abs(st[0]["ref_metrics"][k]) for k in ("loss_student", "loss_critic")}
    print(f"[serve] --sp {SP_N} CogVideoX pipeline (sequence_parallel_mesh, gloo, both ranks on "
          f"cuda:0), CogVideoX-2B 30 blocks seeded, {SP_FRAMES} frames 480x720 ({SP_LAT_F} "
          f"latent frames, {SP_SHARD} video rows a rank), batch 1, 4 NFE, latents: relative L2 "
          f"{sv[0]['rel_l2']:.3e} / {sv[1]['rel_l2']:.3e} against the one-process pipeline "
          f"(limit {SP_SERVE_TOL}); sampler device ms (CUDA events) {sv[0]['device_ms']:.1f} / "
          f"{sv[1]['device_ms']:.1f}, wall {sv[0]['wall_s']:.2f} / {sv[1]['wall_s']:.2f} s; "
          f"launches a rank {sv[0]['launches']} (checked: {SP_HOPS} hops an attention call); "
          f"permutes a rank {sv[0]['permutes']} (checked); peak {sv[0]['peak_gib']:.2f} / "
          f"{sv[1]['peak_gib']:.2f} GiB", flush=True)
    print(f"[train] --sp {SP_N} step on [cuda:0, cuda:0] (gloo), CogVideoX-2B at {RANK_LAYERS} "
          f"blocks with remat, {SP_LAT_F} latent frames, batch 1 on both ranks: weights equal "
          f"bit for bit across ranks (checked); summed gradients' relative L2 against the "
          f"one-process step {g['student']:.3e} (student), {g['critic']:.3e} (critic) (limit "
          f"{SP_GRAD_TOL}); the fp32 witness at {SP_WITNESS_LAYERS} blocks and "
          f"{SP_WITNESS_FRAMES} latent frames "
          f"{w['student']:.3e} / {w['critic']:.3e} (limit {SP_FP32_TOL}, step "
          f"{sp[0]['fp32_step_s']:.3f} s), its control (rank 1 keeps its own dK/dV on the "
          f"return hop) {c['student']:.3e} / {c['critic']:.3e} (must exceed the limit); losses "
          f"{loss_rel['loss_student']:.3e} / {loss_rel['loss_critic']:.3e} (limit "
          f"{DP_GRAD_TOL}); the update {st[0]['update_rel_l2']:.3e} from the one-process "
          f"step's (not checked: Adam's first step is lr·sign(g)); step {st[0]['step_s']:.3f} "
          f"/ {st[1]['step_s']:.3f} s (one process {st[0]['ref_step_s']:.3f} s), peak "
          f"{st[0]['peak_gib']:.2f} / {st[1]['peak_gib']:.2f} GiB a rank; launches a rank "
          f"{st[0]['launches']} (checked); permutes a rank {st[0]['permutes']} (checked: "
          f"{SP_FWD_PERMUTES} forward and {SP_BWD_PERMUTES} backward an attention call)",
          flush=True)
    print(f"[train] train_tdm.main --sp {SP_N} --model_family cogvideox --num_frames "
          f"{SP_FRAMES} (LoRA {COG_LORA_RANK}, 8-bit Adam, --gradient_checkpointing, "
          f"{SP_MAIN_LAYERS} blocks, batch 1, one step): {m[0]['steps'][0]['host_s']:.3f} / "
          f"{m[1]['steps'][0]['host_s']:.3f} s, main() {m[0]['main_s']:.1f} / "
          f"{m[1]['main_s']:.1f} s, peak {m[0]['peak_gib']:.2f} / {m[1]['peak_gib']:.2f} GiB "
          f"a rank, launches {m[0]['steps'][0]['launches']} (checked), permutes "
          f"{m[0]['permutes']}, {m[0]['steps'][0]['metrics']}", flush=True)
    print(f"[train] the --sp {SP_N} checks' seconds a rank: {sp[0]['seconds']} / "
          f"{sp[1]['seconds']}", flush=True)
    for r, s_ in enumerate(sv):
        check(s_["finite"] and s_["rel_l2"] <= SP_SERVE_TOL and s_["checksum_equal"],
              f"--sp {SP_N} served latents rank {r}: {s_}")
        check(s_["launches"] == serve_launches,
              f"--sp {SP_N} serving rank {r} launched {s_['launches']}, expected {serve_launches}")
        check((s_["permutes"]["forward"], s_["permutes"]["backward"]) == (30 * 4, 0),
              f"--sp {SP_N} serving rank {r} permutes {s_['permutes']}")
    check(st[0]["checksums"] == st[1]["checksums"],
          f"--sp {SP_N}: the ranks' weights differ after the step: {st[0]['checksums']} "
          f"{st[1]['checksums']}")
    for r in range(2):
        check(all(v <= SP_GRAD_TOL for v in st[r]["grad_rel_l2"].values()),
              f"--sp {SP_N} rank {r} summed gradients: {st[r]['grad_rel_l2']}")
        check(all(v <= SP_FP32_TOL for v in sp[r]["fp32_grad_rel_l2"].values()),
              f"--sp {SP_N} rank {r} fp32 witness: {sp[r]['fp32_grad_rel_l2']}")
        check(min(sp[r]["control_grad_rel_l2"].values()) > SP_FP32_TOL,
              f"--sp {SP_N} rank {r} fp32 control within the limit: "
              f"{sp[r]['control_grad_rel_l2']}")
        check(st[r]["launches"] == step_launches,
              f"--sp {SP_N} step rank {r} launched {st[r]['launches']}, expected {step_launches}")
        check((st[r]["permutes"]["forward"], st[r]["permutes"]["backward"]) == step_perms,
              f"--sp {SP_N} step rank {r} permutes {st[r]['permutes']}, expected {step_perms}")
        check(len(m[r]["steps"]) == 1 and m[r]["steps"][0]["launches"] == main_launches
              and all(math.isfinite(v) for v in m[r]["steps"][0]["metrics"].values()),
              f"train_tdm.main --sp {SP_N} rank {r}: {m[r]['steps']}, expected launches "
              f"{main_launches}")
        check((m[r]["permutes"]["forward"], m[r]["permutes"]["backward"]) == main_perms,
              f"train_tdm.main --sp {SP_N} rank {r} permutes {m[r]['permutes']}, expected "
              f"{main_perms}")
    check(all(v <= DP_GRAD_TOL for v in loss_rel.values()),
          f"--sp {SP_N} losses against the one-process step: {loss_rel}")
    check(m[0]["lora_written"], f"train_tdm.main --sp {SP_N}: no tdm_lora.safetensors")
    return {"serve": sv, "step": st, "loss_rel": loss_rel, "main": m,
            "fp32_grad_rel_l2": [r["fp32_grad_rel_l2"] for r in sp],
            "control_grad_rel_l2": [r["control_grad_rel_l2"] for r in sp],
            "launches_expected": {"serve": serve_launches, "step": step_launches,
                                  "main": main_launches},
            "permutes_expected": {"step": step_perms, "main": main_perms}}


SHAPE_KEYS = ("shape", "dims", "ms", "ms_range", "plain_ms", "library_ms", "library_ms_range",
              "bound_ms", "bound_by")


def kernel_row(name, source, replaces, launches, rec, per, resources, sd3_launches) -> dict:
    """One entry of the `kernels` JSON line: the times of the self and the
    cross shape summed (one PixArt block), the bound of their summed work,
    and the bf16 kernels' registers, spills and HGMMA/HMMA counts; under
    `sd3_train`, each SD3 training shape alone with the kernel's launches
    per SD3 step (`sd3_launches`)."""
    shapes = [r for r in rec["shapes"] if r["group"] == "pixart"]
    nbytes = sum(r["bytes"] for r in shapes)
    ops = sum(r["ops"] for r in shapes)
    bound, by = bound_ms(nbytes, ops)
    lib = [r.get("library_ms") for r in shapes]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": sum(r["ms"] for r in shapes),
        "plain_ms": sum(r["plain_ms"] for r in shapes),
        "bound_ms": bound, "bound_by": by,
        "library_ms": None if None in lib else sum(lib),
        "per": per,
        "shapes": [{k: r.get(k) for k in SHAPE_KEYS} for r in shapes],
        "sd3_train": {"launches_per_step": sd3_launches,
                      "shapes": [{k: r.get(k) for k in SHAPE_KEYS} for r in rec["shapes"]
                                 if r["group"] == "sd3_train"]},
        "resources": resources,
    }


PROBE_BARS = {  # tests/test_tdm_image_e2e.py's bars, on run_probe's numbers
    "decoder_loss < 5e-3": lambda r: r["decoder_loss"] < 5e-3,
    "teacher_dsm_loss < 0.9": lambda r: r["teacher_dsm_loss"] < 0.9,
    "4-NFE before > 50-NFE teacher + 0.03":
        lambda r: r["err_student_4nfe_before"] > r["err_teacher_50nfe"] + 0.03,
    "after < before - 0.02":
        lambda r: r["err_student_4nfe_after"] < r["err_student_4nfe_before"] - 0.02,
    "gap_after < 0.6 gap_before":
        lambda r: (r["err_student_4nfe_after"] - r["err_teacher_50nfe"])
        < 0.6 * (r["err_student_4nfe_before"] - r["err_teacher_50nfe"]),
}


def phase_probe(torch) -> dict:
    """The TDM distill probe (`eval/distill_probe.run_probe`) at the JAX
    defaults on the card: a tiny TAESD decoder (700 steps), the toy
    ε-teacher (3000 DSM steps), 500 TDM steps of the 4-NFE student, and
    the decoded manifold errors at n_eval 256; its numbers, each stage's
    seconds, and the five bars of tests/test_tdm_image_e2e.py (checked)."""
    from tdm_tpu_torch.eval import distill_probe

    timings = {}
    t0 = time.monotonic()
    out = distill_probe.run_probe(device="cuda", timings=timings)
    wall = time.monotonic() - t0
    bars = {name: bool(ok(out)) for name, ok in PROBE_BARS.items()}
    print(f"[probe] gap_closure {out['gap_closure']:.4f}: decoded manifold error 50-NFE "
          f"teacher {out['err_teacher_50nfe']:.4f}, 4-NFE before {out['err_student_4nfe_before']:.4f}"
          f", after {out['err_student_4nfe_after']:.4f}; decoder loss {out['decoder_loss']:.3e}, "
          f"teacher DSM loss {out['teacher_dsm_loss']:.4f}, student loss "
          f"{out['loss_student_final']:.4f}; bars {bars}", flush=True)
    print("[probe] seconds per stage: " + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
          + f"; run_probe {wall:.1f}s", flush=True)
    check(all(bars.values()), f"the distill probe missed a bar: {bars}")
    return {**out, "seconds": timings, "wall_s": wall, "bars": bars}


def timed_phase(fn, *args):
    """fn(*args), with a line of its wall seconds and the disk space the
    run's files hold after it."""
    t0 = time.monotonic()
    out = fn(*args)
    used = shutil.disk_usage(os.path.dirname(os.path.abspath(__file__))).used / 2**30
    print(f"[timing] {fn.__name__} {time.monotonic() - t0:.1f}s (disk used {used:.1f} GiB)",
          flush=True)
    return out


PHASES = ("kernels", "reference", "probe", "serve", "train", "moe", "train_lora", "sd3",
          "diffusers", "train_sd3", "sd15", "train_sd15", "cogvideox", "train_cogvideox")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # a data-parallel training rank of the train phase (dp_ranks starts them)
    ap.add_argument("--dp_rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_spec", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a subset prints no result line)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases: one or more of {PHASES}")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    # the processes the port starts itself (`python -m ...`: the --tp
    # followers) import it from this checkout too
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [here] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, json.loads(args.dp_spec))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    t_start = time.monotonic()
    try:
        dev = phase_device(torch)
        build = phase_build()
        if "kernels" in phases:
            kern = timed_phase(phase_kernels, torch, args.seed)
            ktrain = timed_phase(phase_kernels_train, torch, args.seed)
            ksplash = timed_phase(phase_kernels_splash, torch, args.seed)
            kcog = timed_phase(phase_kernels_cogvideox, torch, args.seed)
            kcog_train = timed_phase(phase_kernels_train_cogvideox, torch, args.seed)
            kring = timed_phase(phase_kernels_ring, torch, args.seed)
        if "reference" in phases:
            timed_phase(phase_reference, torch, args.seed)
            timed_phase(phase_reference_train, torch, args.seed)
            timed_phase(phase_reference_train_sd3, torch, args.seed)
            timed_phase(phase_reference_train_sd15, torch, args.seed)
            timed_phase(phase_reference_sd3, torch, args.seed, workdir)
            timed_phase(phase_reference_cogvideox, torch, args.seed)
            timed_phase(phase_reference_train_cogvideox, torch, args.seed)
            ref_new = timed_phase(phase_reference_eval, torch, args.seed)
        # with the train phase the probe (host-bound) runs while that phase's
        # two rank processes run (the smoke's clock)
        if "probe" in phases and "train" not in phases:
            probe = timed_phase(phase_probe, torch)
        if "serve" in phases:
            serve = timed_phase(phase_serve, torch, args.seed, workdir)
        if "train" in phases:
            train = timed_phase(
                phase_train, torch, args.seed, workdir, "moe" in phases,
                functools.partial(timed_phase, phase_probe, torch) if "probe" in phases
                else None)
            if "probe" in phases:
                probe = train["data_parallel"]["two_ranks"]["meanwhile"]
        if "moe" in phases:
            moe = timed_phase(phase_moe, torch, args.seed, workdir)
        if "train_lora" in phases:
            train_lora = timed_phase(phase_train_lora, torch, args.seed, workdir)
        if "sd3" in phases:
            sd3 = timed_phase(phase_sd3, torch, args.seed, workdir)
        if "diffusers" in phases:
            diffusers = timed_phase(phase_diffusers, torch, args.seed, workdir)
        if "train_sd3" in phases:
            train_sd3 = timed_phase(phase_train_sd3, torch, args.seed, workdir)
        if "sd15" in phases:
            sd15 = timed_phase(phase_sd15, torch, args.seed, workdir)
        if "train_sd15" in phases:
            train_sd15 = timed_phase(phase_train_sd15, torch, args.seed, workdir)
        if "cogvideox" in phases:
            cogvideox = timed_phase(phase_cogvideox, torch, args.seed, workdir)
        if "train_cogvideox" in phases:
            train_cogvideox = timed_phase(phase_train_cogvideox, torch, args.seed, workdir)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[done] {time.monotonic() - t_start:.1f}s", flush=True)
    if phases != list(PHASES):
        print(f"chip_smoke: ran only {phases}; no result line", flush=True)
        return 0
    per_block = ("one PixArt block at batch 4: one self-attention call "
                 "[4,16,1024,1024,72] + one cross-attention call "
                 "[4,16,1024,120,72] (bf16)")
    no_lib = ("; library null: no one PyTorch call computes it alone (SDPA's "
              "backward alone against dQ + dK/dV, and SDPA forward + backward "
              "against the port's lse forward + dQ (delta fused) + dK/dV: "
              "training_attention)")
    kt = ktrain["kernels"]
    res = build["resources"]
    sd3_step = train_sd3["launches_per_step"]

    def by_path(wrapper):
        return {"train": train["launches"][wrapper], "train_moe": moe["launches"][wrapper],
                "train_sd3": train_sd3["launches"][wrapper],
                "train_sd15": train_sd15["launches"][wrapper],
                "train_cogvideox": train_cogvideox["launches"][wrapper]}

    def cog_train(kern, wrapper):
        rec = kcog_train["kernels"][kern]
        return {"cogvideox_train": {
            "launches_per_step": COG_TRAIN_LAUNCHES[wrapper],
            "shapes": [{k: rec.get(k) for k in (*SHAPE_KEYS, "max_abs_err", "sdpa_ms",
                                                "sdpa_ms_range")}]}}

    def sd15_train(rec, wrapper):
        return {"sd15_train": {
            "launches_per_step": SD15_TRAIN_LAUNCHES[wrapper],
            "shapes": [{k: r.get(k) for k in SHAPE_KEYS} for r in rec["shapes"]
                       if r["group"] == "sd15_train"]}}

    def bf16_kernels(lib, suffix=""):
        return {fn: r for fn, r in res[lib].items()
                if ("sm90" in fn or "bf16" in fn) and fn.endswith(suffix)}

    rows = [
        kernel_row("flash_fwd", "tdm_tpu_torch/csrc/flash_fwd.cu",
                   "tdm_tpu/ops/attention.py:291", serve["launches"], kern,
                   per_block + "; library = SDPA forward", bf16_kernels("flash_fwd", ",0>"),
                   sd3_step["flash_attention_fwd"])
        | {"launches_by_path": {
            "serve": serve["launches"], "diffusers_pixart": diffusers["pixart"]["launches"],
            "diffusers_sd3": diffusers["sd3"]["launches"],
            **by_path("flash_attention_fwd"), "sd15": sd15["launches"],
            "cogvideox": cogvideox["launches"]},
           "sd15": {"launches_per_batch": SD15_LAUNCHES_PER_BATCH,
                    "calls_per_batch": {name: calls for name, *_, calls in SD15_SHAPES},
                    "launches_by_head_dim": sd15["launches_by_head_dim"],
                    "shapes": [{k: r.get(k) for k in SHAPE_KEYS} for r in kern["shapes"]
                               if r["group"] == "sd15"]},
           "cogvideox": {"launches_per_batch": COG_LAUNCHES_PER_BATCH,
                         "shapes": [{k: r.get(k) for k in SHAPE_KEYS}
                                    for r in kcog["shapes"]]},
           "cogvideox_train": {"launches_per_step": COG_TRAIN_LAUNCHES["flash_attention_fwd"]},
           "dynamic_smem": build["dynamic_smem"]["flash_fwd"]}
        | sd15_train(kern, "flash_attention_fwd"),
        kernel_row("flash_fwd_lse", "tdm_tpu_torch/csrc/flash_fwd.cu",
                   "tdm_tpu/ops/attention.py:291", train["launches"]["flash_attention_fwd_lse"],
                   kt["flash_fwd_lse"],
                   per_block + "; library = SDPA forward on inputs that require grad",
                   bf16_kernels("flash_fwd", ",1>"), sd3_step["flash_attention_fwd_lse"])
        | {"launches_by_path": by_path("flash_attention_fwd_lse")}
        | sd15_train(kt["flash_fwd_lse"], "flash_attention_fwd_lse")
        | cog_train("flash_fwd_lse", "flash_attention_fwd_lse"),
        kernel_row("flash_bwd_dq", "tdm_tpu_torch/csrc/flash_bwd_dq.cu",
                   "tdm_tpu/ops/attention.py:600", train["launches"]["flash_attention_bwd_dq"],
                   kt["flash_bwd_dq"], per_block + no_lib, bf16_kernels("flash_bwd_dq"),
                   sd3_step["flash_attention_bwd_dq"])
        | {"launches_by_path": by_path("flash_attention_bwd_dq"),
           "dynamic_smem": build["dynamic_smem"]["flash_bwd_dq"]}
        | sd15_train(kt["flash_bwd_dq"], "flash_attention_bwd_dq")
        | cog_train("flash_bwd_dq", "flash_attention_bwd_dq"),
        kernel_row("flash_bwd_dkv", "tdm_tpu_torch/csrc/flash_bwd_dkv.cu",
                   "tdm_tpu/ops/attention.py:635", train["launches"]["flash_attention_bwd_dkv"],
                   kt["flash_bwd_dkv"], per_block + no_lib, bf16_kernels("flash_bwd_dkv"),
                   sd3_step["flash_attention_bwd_dkv"])
        | {"launches_by_path": by_path("flash_attention_bwd_dkv"),
           "dynamic_smem": build["dynamic_smem"]["flash_bwd_dkv"]}
        | sd15_train(kt["flash_bwd_dkv"], "flash_attention_bwd_dkv")
        | cog_train("flash_bwd_dkv", "flash_attention_bwd_dkv"),
        {"name": "splash_fwd", "route": "cuda", "source": "tdm_tpu_torch/csrc/splash_fwd.cu",
         "replaces": "tdm_tpu/ops/attention.py:153", "launches": sd3["launches"],
         "launches_per_batch": sd3["launches_per_batch"],
         "max_abs_err": ksplash["max_abs_err"], "ms": ksplash["ms"],
         "plain_ms": ksplash["plain_ms"], "bound_ms": ksplash["bound_ms"],
         "bound_by": ksplash["bound_by"], "library_ms": ksplash["library_ms"],
         "per": ("one SD3-Medium joint attention call at batch 4 [4,24,4429,4429,64] "
                 "(bf16); library = SDPA forward; flash_ms = the flash kernel (bias "
                 "all 0) at the same shape"),
         "ms_range": ksplash["ms_range"], "library_ms_range": ksplash["library_ms_range"],
         "flash_ms": ksplash["flash_ms"], "flash_ms_range": ksplash["flash_ms_range"],
         "dims": ksplash["dims"], "resources": bf16_kernels("splash_fwd"),
         "dynamic_smem": build["dynamic_smem"]["splash_fwd"],
         "cogvideox": {"shapes": [
             {"shape": r["shape"], "dims": r["dims"], "ms": r["splash_ms"],
              "ms_range": r["splash_ms_range"], "plain_ms": r["plain_ms"],
              "library_ms": r["library_ms"], "library_ms_range": r["library_ms_range"],
              "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
              "max_abs_err": r["splash_max_abs_err"], "flash_ms": r["ms"]}
             for r in kcog["shapes"]]}},
    ]
    spr = train["data_parallel"]["two_ranks"]["sp"]
    sp_main = spr["main"][0]["steps"][0]["launches"]
    ring_per = (f"one rank's ring attention call at --sp {SP_N} (CogVideoX-2B, {SP_FRAMES} "
                f"frames at 480x720): q [1,{COG_H},{SP_Q},{COG_D}] over the {COG_TXT}-row T5 "
                f"prefix and {SP_N} shards of {SP_SHARD} rows, {SP_HOPS} hops, bf16; ms, "
                f"plain_ms and bound_ms the prefix hop plus {SP_N} shard hops (hops: each "
                f"alone, in turns with SDPA at its shape); launches: train_tdm.main --sp "
                f"{SP_N}'s step on rank 0")
    for name, wrapper, kern, src, at in (
            ("ring_fwd_lse", "flash_attention_fwd_lse", "fwd_lse", "flash_fwd.cu", ":223"),
            ("ring_bwd_dq", "flash_attention_bwd_dq", "dq", "flash_bwd_dq.cu", ":302"),
            ("ring_bwd_dkv", "flash_attention_bwd_dkv", "dkv", "flash_bwd_dkv.cu", ":302")):
        call = kring["call"][kern]
        rows.append({
            "name": name, "route": "cuda", "source": f"tdm_tpu_torch/csrc/{src}",
            "ring": "tdm_tpu_torch/ops/ring_attention.py",
            "replaces": f"tdm_tpu/ops/ring_attention.py{at}", "launches": sp_main[wrapper],
            "max_abs_err": max(kring["full_max_abs_err"][x] for x in
                               {"fwd_lse": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}[kern]),
            "ms": call["ms"], "plain_ms": call["plain_ms"], "bound_ms": call["bound_ms"],
            "bound_by": call["bound_by"],
            # SDPA over the rank's whole call computes the forward's function;
            # no one library call computes dQ or dK/dV alone
            "library_ms": kring["sdpa_call_ms"] if kern == "fwd_lse" else None,
            "per": ring_per,
            "hops": {hop: {"dims": r["dims"], **r[kern],
                           "sdpa_ms": r["sdpa_fwd_ms" if kern == "fwd_lse" else "sdpa_bwd_ms"]}
                     for hop, r in kring["hops"].items()},
            "launches_by_path": {"train_sp_step_per_rank": spr["step"][0]["launches"][wrapper],
                                 "serve_sp_per_rank": spr["serve"][0]["launches"][wrapper]}})
    text_encoders = {
        "t5_xxl_pixart": serve["t5"], "clip_l_sd3": diffusers["sd3"]["encoders"]["clip_l"],
        "clip_g_sd3": diffusers["sd3"]["encoders"]["clip_g"],
        "t5_xxl_sd3": diffusers["sd3"]["encoders"]["t5"],
        "clip_l_sd15": sd15["raw_prompts"]["encoder"],
        "t5_xxl_cogvideox": cogvideox["raw_prompts"]["encoder"],
        "serving_peak_gib": {"pixart": serve["peak_gib"], "sd3": diffusers["sd3"]["peak_gib"],
                             "sd15": sd15["raw_prompts"]["peak_gib"],
                             "cogvideox": cogvideox["serve_peak_gib"]},
        "build_cache_rows": serve["cache_rows"]}
    int8 = {"int8_dot": "torch._int_mm (cuBLASLt's int8 GEMM), not a TPU kernel: the JAX "
                        "function is an XLA dot (tdm_tpu/ops/quant.py:47-69)",
            "pixart": serve["int8"], "sd3": sd3["int8"], "sd15": sd15["int8"],
            "cogvideox": cogvideox["int8"], "train_quant_forwards": train["quant_forwards"]}
    offline = {"generate": {"pixart": serve["generate"],
                            "cogvideox_gif": cogvideox["generate_gif"]},
               "evaluate": sd15["evaluate"], "reference_new_modules": ref_new,
               "convert_checkpoint": diffusers["pixart"]["convert"],
               "vae3d_encoder": cogvideox["vae3d_encoder"]}
    print(json.dumps({"kernels": rows, "training_attention": ktrain["pair"], "int8": int8,
                      "offline_verbs": offline, "distill_probe": probe,
                      "text_encoders": text_encoders,
                      "serve": serve, "train": train, "moe": moe, "train_lora": train_lora,
                      "sd3": sd3,
                      "diffusers": diffusers, "train_sd3": train_sd3, "sd15": sd15,
                      "train_sd15": train_sd15, "cogvideox": cogvideox,
                      "cogvideox_train_attention": {
                          k: kcog_train[k] for k in ("dq_plus_dkv_ms", "sdpa_bwd_ms")},
                      "ring": kring,
                      "train_cogvideox": train_cogvideox}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
