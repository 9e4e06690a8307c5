"""TDM distillation CLI of the port: `python -m tdm_tpu_torch.cli.train_tdm`.

Port of `tdm_tpu/cli/train_tdm.py` (`main`, `:27-817`) on one GPU or on a
('data', 'fsdp', 'ep', 'sp', 'tp') mesh of processes, one per GPU, with its flag names and
defaults (`utils/config.py`):

  schedule tables → student / critic / teacher parameters (the teacher
  from --pretrained_model_name_or_path when that is a directory of the
  diffusers denoiser's safetensors, a checkout's `transformer/` or
  `unet/`, else seeded; with --train_lora_rank the student is a LoRA over the frozen
  teacher) → clip → AdamW or 8-bit Adam, under --gradient_accumulation_steps
  → prompt data (an embedding cache from $TDM_EMBEDDING_CACHE, with SD3's
  pooled vectors when it has them; else hash pseudo-embeddings of the
  prompts of --train_data_dir, a .txt/.jsonl file read by the native C++
  loader where g++ builds it, or an HF dataset name or folder read by
  `datasets` with --dataset_config_name) → the TDM step → loop [a batch per micro-step; per
  optimizer step: metrics at step 1 and every 10 → validation grids every
  --validation_steps when $TDM_TAESD_DIR names a diffusers AutoencoderTiny
  directory and the latents are images (a video family renders none, as
  the JAX CLI) → checkpoint every --checkpointing_steps] → final checkpoint,
  `student.safetensors` (fp16, the JAX package's layout) and the kohya
  LoRA `tdm_lora.safetensors`: the trained factors in LoRA mode, else the
  truncated SVD of student − teacher at --export_lora_rank (0 skips it).
A teacher directory in the tdm_tpu layout (a `pipeline.json` beside
`transformer.safetensors` in the JAX package's keys, as `save_pretrained`
or an exported student makes it) is read through the weight carry, which
is how a MoE teacher with its expert leaves loads.

--model_family pixart (PixArt-α; --moe_experts E > 0 swaps each block's
MLP for a top---moe_top_k mixture of E experts, `models/moe.py`, in the
student, the critic and the teacher), sd15 (the SD1.5 UNet under the
scaled-linear schedule, conditioned on CLIP-L tokens; the teacher directory
is the `unet/` folder of an SD1.5 diffusers checkout), sd3 (SD3-Medium
under the shifted flow schedule, conditioned on T5 tokens and the pooled
CLIP vector; a full-size sd3 run whose data has no pooled vectors is
refused with ValueError before any model is built, unless
--allow_pooled_standin) or cogvideox (CogVideoX-2B on video latents of
--num_frames pixel frames, 49 by the config's default, under its
v-prediction schedule, conditioned on T5 tokens [226, 4096]; the teacher
directory is a checkout's `transformer/`). Runs on CUDA unless `--device
cpu` is given, and logs the peak device memory at the end on CUDA; fp32
products run in full fp32 unless --allow_tf32; `TDM_TINY_MODEL=1` swaps in
the tiny config. --quant_forwards runs the no-grad forwards the JAX step
wraps in `q()` (the rollout and the probes) on dynamic int8 products
(`train/tdm.py`, `ops/quant.py`). --push_to_hub uploads the output
directory at the end of the run (`io/hub.push_to_hub`: --hub_model_id,
else the directory's name; --hub_token, else $HF_TOKEN).

Across GPUs (`parallel/mesh.py`): `torchrun --nproc_per_node N -m
tdm_tpu_torch.cli.train_tdm ...`, or N processes with TDM_COORDINATOR,
TDM_NUM_PROCESSES and TDM_PROCESS_ID set, as the JAX CLI reads them; each
process runs on `cuda:LOCAL_RANK` (NCCL), or on the CPU under `--device
cpu` (gloo). --train_batch_size is per data rank (a process, but the
--ep and --tp ranks of one row index share their rows), so the global
batch is N/(ep·tp) times it; every process draws the global batch's
`StepDraws` from the one seeded generator and keeps its rows, so a run's
numbers do not depend on N, and reads its rows' share of the prompts
(host_index = its row index). --fsdp K
shards the student, the critic, their optimizer states and the EMA over K
processes (ZeRO-3; a ValueError when K does not divide N), else every
process keeps the whole state and the gradients are averaged (data
parallelism). Validation and the final gather run on every process; the
files (logs, grids, checkpoints, the exported student and LoRA) are
written by process 0, a checkpoint in the one-process layout, so a run
resumes at another N. Each process logs its peak device memory. The
output directory is shared by all processes (one host, or a shared file
system). --ep K (with --moe_experts) splits every expert leaf of the
student, the critic, their optimizer states, the EMA and the teacher over K
processes that share their rows (the JAX CLI's ('data', 'fsdp', 'ep')
mesh: the global batch is N/K times --train_batch_size), composed with
--fsdp; the JAX CLI's checks come first ("--ep requires --moe_experts > 0",
"--ep composes with --fsdp only", "not divisible", "does not divide N
devices"). --tp K cuts the model Megatron-style over K processes that share
their rows (`parallel/tp.py`: each runs its share of every attention's
heads and feed-forward's width where K divides them, and holds those
slices of the student, the critic, their optimizer states, the EMA and
the teacher; a LoRA student's factors stay whole and each merge is cut),
composed with --fsdp on the ('data', 'fsdp', 'tp') mesh, --quant_forwards,
--use_ema and the LoRA flags. --sp K (cogvideox only) cuts each video's
latent frames over K processes that share their rows (`models/cogvideox.
sequence_parallel_apply`: every attention a ring over the video K/V
shards, `ops/ring_attention.py`), composed with --fsdp on the JAX CLI's
('data', 'sp') or ('data', 'fsdp', 'sp') mesh, where the 'fsdp' ranks
share their rows too: the global batch is N/(K·fsdp) times
--train_batch_size; the JAX CLI's checks come first, in its order
("cogvideox only", "composes with --fsdp only", "--quant_forwards", "does
not divide N devices", then the latent frame count). Validation keeps the
monolithic forward. Refused before the first step, each naming ROADMAP.md's
queue 1, slice 6: --pp > 1, and expert or tensor parallelism with 8-bit
Adam.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import signal
import sys
from typing import Callable, Optional

import numpy as np
import torch


def refuse_unported(cfg) -> None:
    """The JAX CLI's --ep and --sp checks (ValueError, its messages and
    order, `tdm_tpu/cli/train_tdm.py:71-103`), then NotImplementedError
    for a flag whose path is not ported, before any model is built."""
    n_ep = max(cfg.ep, 1)
    if n_ep > 1:
        if cfg.moe_experts <= 0:
            raise ValueError("--ep requires --moe_experts > 0")
        if cfg.tp > 1 or cfg.pp > 1:
            raise ValueError("--ep composes with --fsdp only (tp/pp x ep is unsupported)")
        if cfg.moe_experts % n_ep:
            raise ValueError(f"--moe_experts {cfg.moe_experts} not divisible by --ep {n_ep}")
    if cfg.sp > 1:
        if cfg.model_family != "cogvideox":
            raise ValueError("--sp (frame-sharded sequence parallelism) supports "
                             "--model_family cogvideox only")
        if cfg.tp > 1 or cfg.pp > 1 or n_ep > 1:
            raise ValueError("--sp composes with --fsdp only (tp/pp/ep x sp is unsupported)")
        if cfg.quant_forwards:
            raise ValueError("--sp with --quant_forwards is not supported")
    if cfg.pp > 1:
        raise NotImplementedError(
            f"--pp {cfg.pp}: multi-GPU training is not ported yet: ROADMAP.md queue 1, "
            "slice 6")
    for flag in ("ep", "tp"):
        if getattr(cfg, flag) > 1 and cfg.use_8bit_adam:
            raise NotImplementedError(
                f"--{flag} with --use_8bit_adam: 8-bit moments of leaves split over "
                f"'{flag}' are not ported yet: ROADMAP.md queue 1, slice 6")


def _hold_experts(model, teacher: dict) -> None:
    """Point the module's own expert parameters at this rank's experts of
    the teacher, so that the whole stacks it was built with are freed (its
    forwards read the dicts they are given)."""
    from tdm_tpu_torch.models import moe

    for name, mod in model.named_modules():
        if isinstance(mod, moe.MoEFeedForward):
            for leaf in ("experts_in", "experts_in_bias", "experts_out", "experts_out_bias"):
                setattr(mod, leaf, torch.nn.Parameter(teacher[f"{name}.{leaf}"],
                                                      requires_grad=False))


def _load_taesd(vae_dir: str, latent_channels: int, device):
    """The validation decoder from a diffusers AutoencoderTiny directory
    (TAESD, or TAESD3 for 16-channel latents), as the JAX CLI reads
    $TDM_TAESD_DIR; the decoder side of its converted tree."""
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.models import vae as vae_lib

    vcfg = vae_lib.TAESDConfig.taesd3() if latent_channels == 16 else vae_lib.TAESDConfig()
    dec = vae_lib.TAESDDecoder(vcfg, device=device)
    tree = convert.taesd_params(convert.load_torch_state_dict(vae_dir))["decoder"]
    return from_jax.load_from_jax(convert.flatten(tree), dec)


def main(argv: Optional[list[str]] = None, *, step_hook: Optional[Callable] = None) -> None:
    """Train. `step_hook(step, run)`, when given, is called for every
    micro-step with the number of the optimizer step it belongs to and a
    zero-argument callable that runs it and returns (state, metrics); the
    hook must call it once and return its result (a caller times or profiles
    steps this way)."""
    with contextlib.ExitStack() as closing:
        _train(argv, step_hook, closing)


def _train(argv, step_hook, closing: contextlib.ExitStack) -> None:
    from tdm_tpu_torch import lora as lora_lib
    from tdm_tpu_torch.data import prompts as data_prompts, tokenizer as tok_lib
    from tdm_tpu_torch.device import resolve_device, set_fp32_precision
    from tdm_tpu_torch.io import from_jax
    from tdm_tpu_torch.parallel import mesh as pmesh
    from tdm_tpu_torch.train import families, optim as topt, tdm, validation
    from tdm_tpu_torch.utils import checkpoint as ckpt_lib, config as cfg_lib
    from tdm_tpu_torch.utils import logging as log_lib

    cfg = cfg_lib.parse_args(argv)
    refuse_unported(cfg)
    device = resolve_device(cfg.device)
    # the world of processes the environment asks for (one process per GPU)
    if not torch.distributed.is_initialized() and pmesh.maybe_initialize_distributed(
            device.type):
        closing.callback(torch.distributed.destroy_process_group)
    device = pmesh.local_device(device)
    world, rank = pmesh.world_size(), pmesh.rank()
    if cfg.max_devices > 0 and world > 1:
        raise ValueError("--max_devices is only supported in single-process runs")
    n_fsdp, n_ep, n_tp = max(cfg.fsdp, 1), max(cfg.ep, 1), max(cfg.tp, 1)
    n_sp = max(cfg.sp, 1)
    n_model = n_fsdp * n_ep * n_tp * n_sp
    if world % n_model:
        raise ValueError(
            f"--fsdp {cfg.fsdp} x --tp {cfg.tp} x --pp {cfg.pp} x --ep "
            f"{cfg.ep} x --sp {cfg.sp} does not divide {world} devices"
        )
    mesh = (pmesh.make_mesh(world // n_model, n_fsdp, n_ep, n_tp, n_sp) if world > 1
            else None)
    main_process = rank == 0
    # fp32 products in full fp32 unless --allow_tf32 (reference src/main.py:197-198)
    set_fp32_precision(cfg.allow_tf32)
    out_dir = cfg.resolved_output_dir()
    logger = log_lib.setup_logging(main_process=main_process)
    logger.info("config: %s", cfg)
    logger.info("device: %s%s", device,
                f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
    # --train_batch_size is per data rank (the reference's "per device"):
    # every process is one ('fsdp' ones too) but the 'ep' and 'tp' ranks of
    # a row index, which share its rows; under --sp only the 'data' ranks
    local_batch = cfg.train_batch_size
    n_rows, row_index = (mesh.n_rows, mesh.row_index) if mesh is not None else (1, 0)
    global_batch = local_batch * n_rows
    if mesh is not None:
        logger.info("mesh: %d data x %d fsdp x %d ep x %d sp x %d tp processes, global batch "
                    "%d", mesh.n_data, mesh.n_fsdp, mesh.n_ep, mesh.n_sp, mesh.n_tp,
                    global_batch)

    tiny = os.environ.get("TDM_TINY_MODEL", "") == "1"
    seed = cfg.seed if cfg.seed is not None else 0
    emb_cache_path = os.environ.get("TDM_EMBEDDING_CACHE", "")
    cache = None
    if emb_cache_path and os.path.exists(emb_cache_path):
        cache = data_prompts.EmbeddingCache.load(emb_cache_path)
    families.check_pooled_source(
        cfg.model_family, tiny=tiny, allow_pooled_standin=cfg.allow_pooled_standin,
        has_pooled=cache is not None and cache.pooled is not None,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    bundle = families.build(
        cfg.model_family, tiny=tiny, resolution=cfg.resolution, num_frames=cfg.num_frames,
        gradient_checkpointing=cfg.gradient_checkpointing,
        mixed_precision=cfg.mixed_precision, moe_experts=cfg.moe_experts,
        moe_top_k=cfg.moe_top_k, allow_pooled_standin=cfg.allow_pooled_standin, seed=seed,
        device=device,
    )
    path = cfg.pretrained_model_name_or_path
    if os.path.isfile(os.path.join(path, "pipeline.json")):
        # the tdm_tpu layout: the denoiser in the JAX package's keys
        from tdm_tpu_torch.io import params as params_io

        from_jax.load_from_jax(
            params_io.load_file(os.path.join(path, "transformer.safetensors")), bundle.model)
        teacher = bundle.init_params()
        logger.info("loaded teacher weights from %s (tdm_tpu layout)", path)
    elif os.path.isdir(path):
        from tdm_tpu_torch.io import convert

        teacher = bundle.convert(convert.load_torch_state_dict(path))
        logger.info("loaded teacher weights from %s", path)
    else:
        teacher = bundle.init_params()
        logger.warning(
            "no local checkpoint at %r — training from RANDOM teacher weights "
            "(smoke mode; real distillation needs ported weights)", path,
        )
    sample_shape, seq_len = bundle.sample_shape, bundle.seq_len

    # ---- data: prompts → (text [B,L,D], mask [B,L], pooled [B,P] or None)
    # batches; pooled rides SD3 caches (the CLIP-L/G vectors) ----
    uncond_pair = uncond_pooled = None
    if cache is not None:
        batches = cache.batches(local_batch, seed=seed, host_index=row_index,
                                host_count=n_rows)

        def get_batch():
            b = next(batches)
            return b if len(b) == 3 else (*b, None)

        dataset_size = len(cache.prompts)
        val_rows_fn = lambda: cache.validation_rows(cfg.validation_prompts)  # noqa: E731
        if cache.uncond_embed is not None:
            uncond_pair = (np.asarray(cache.uncond_embed, np.float32),
                           np.asarray(cache.uncond_mask, np.int32))
        if cache.uncond_pooled is not None:
            uncond_pooled = np.asarray(cache.uncond_pooled, np.float32)
        logger.info("streaming %d cached embeddings", len(cache.prompts))
    else:
        tok = tok_lib.HashTokenizer()
        src = cfg.train_data_dir
        batcher = None
        if src and os.path.isfile(src) and src.endswith((".txt", ".jsonl")):
            # the native C++ mmap + prefetch loader; the Python batcher
            # where it cannot be built
            from tdm_tpu_torch.data import native_loader

            reason = native_loader.unavailable_reason()
            if reason is None:
                batcher = native_loader.NativePromptLoader(
                    src, local_batch, caption_column=cfg.caption_column,
                    tokenizer=tok, max_length=seq_len, seed=seed,
                    host_index=row_index, host_count=n_rows,
                )
                closing.callback(batcher.close)
                dataset_size = batcher.num_prompts
                logger.info("native loader: %d prompts from %s", dataset_size, src)
            else:
                logger.warning("native loader unavailable (%s); reading %s with the "
                               "Python batcher", reason, src)
        if batcher is None:
            prompt_list = data_prompts.load_prompts(
                src or list(cfg.validation_prompts) * 8,
                caption_column=cfg.caption_column, max_samples=cfg.max_train_samples,
                dataset_config_name=cfg.dataset_config_name,
            )
            dataset_size = len(prompt_list)
            batcher = iter(data_prompts.PromptBatcher(
                prompt_list, local_batch, tokenizer=tok, max_length=seq_len, seed=seed,
                host_index=row_index, host_count=n_rows,
            ))
        proj = np.random.default_rng(0).normal(
            size=(tok.vocab_size, bundle.embed_dim)
        ).astype(np.float32) * 0.02

        def get_batch():
            b = next(batcher)
            return proj[b["input_ids"]], b["attention_mask"], None

        def val_rows_fn():
            ids, m = tok(list(cfg.validation_prompts), max_length=seq_len)
            return proj[np.asarray(ids)], np.asarray(m), None

        logger.warning(
            "no TDM_EMBEDDING_CACHE — using hash pseudo-embeddings (smoke mode; "
            "build a T5 cache for real training)"
        )

    # ---- optimizers (recipe: README.md:157-178) ----
    accum = max(cfg.gradient_accumulation_steps, 1)
    if cfg.max_train_steps and cfg.max_train_steps > 0:
        n_total_steps = cfg.max_train_steps
    else:
        batches_per_epoch = max(dataset_size // global_batch, 1)
        n_total_steps = cfg.num_train_epochs * max(-(-batches_per_epoch // accum), 1)
        logger.info("epoch accounting: %d optimizer steps", n_total_steps)
    lr = topt.make_lr_schedule(
        cfg.lr_scheduler, cfg.effective_lr(n_rows),
        warmup_steps=cfg.lr_warmup_steps, total_steps=n_total_steps,
    )

    tdm_cfg = tdm.TDMConfig(
        cfg=cfg.cfg, total_steps=cfg.total_steps, num_steps=cfg.num_steps,
        use_huber=cfg.use_huber, use_separate=cfg.use_separate,
        loss_mode=cfg.loss_mode, critic_updates=cfg.critic_updates,
        quant_forwards=cfg.quant_forwards, ema_decay=0.9999 ** (1.0 / accum),
    )
    schedule = bundle.schedule
    # validation keeps the monolithic forward (the JAX CLI's plain_denoise_fn)
    denoise_fn = plain_denoise_fn = bundle.denoise_fn
    if n_sp > 1:
        # the frames cut over 'sp', every attention a ring over the video
        # K/V shards (`models/cogvideox.sequence_parallel_apply`), on the
        # same parameter dicts
        import dataclasses

        from tdm_tpu_torch.models import cogvideox as cog

        frames = bundle.sample_shape[1]
        if frames % n_sp:
            raise ValueError(f"--sp {n_sp} does not divide the latent frame count {frames}")
        bundle.model.cfg = dataclasses.replace(bundle.model.cfg, sequence_parallel_axis="sp")
        sp_fwd = cog.sequence_parallel_apply(bundle.model, mesh)

        def denoise_fn(params, x, t, cond):
            return sp_fwd(x, t, cond, params=params)

        logger.info("sequence parallelism: %d-way frame sharding (ring attention)", n_sp)
    stacks = from_jax.layer_stacks(bundle.model.cfg)
    student_fn = lora_template = None
    student_init = teacher
    if cfg.train_lora_rank > 0:
        # LoRA mode: the student's state is the adapter's factors over the
        # frozen teacher
        lora_template = lora_lib.init_lora(
            bundle.model, cfg.train_lora_rank,
            generator=torch.Generator().manual_seed(seed + 99),
        )
        student_init = {k: v.to(device) for k, v in lora_lib.factors(lora_template).items()}
        logger.info("LoRA training: rank %d, %d adapted modules",
                    cfg.train_lora_rank, len(lora_template.alpha))
    # tensor parallelism: the model's attention and feed-forward modules cut
    # for this rank (`parallel/tp.py`); the dicts are cut by the layouts below
    tp_plan = {}
    if mesh is not None and mesh.n_tp > 1:
        from tdm_tpu_torch.parallel import tp as tp_lib

        tp_plan = tp_lib.parallelize(bundle.model, mesh.tp)
        logger.info("tp: %d leaves cut over %d processes", len(tp_plan), mesh.n_tp)
    if lora_template is not None:
        cut = tp_lib.lora_cutter(tp_plan, mesh.tp) if tp_plan else None
        student_fn = lora_lib.wrap_denoise_fn(denoise_fn, lora_template, stacks=stacks, cut=cut)
    # the step's reducer across processes: ZeRO-3 over 'fsdp', the experts
    # over 'ep' and the tp slices over 'tp', else the gradient mean; none in
    # one process
    sync = None
    if mesh is not None and (mesh.n_fsdp > 1 or mesh.n_ep > 1 or mesh.n_tp > 1):
        sync = pmesh.ZeRO3(mesh, pmesh.ShardLayout(mesh, student_init, tp_plan),
                           pmesh.ShardLayout(mesh, teacher, tp_plan))
    elif mesh is not None:
        sync = pmesh.DataParallel(mesh)

    def make_tx(role):
        return topt.make_optimizer(
            lr, betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_epsilon,
            weight_decay=cfg.adam_weight_decay, max_grad_norm=cfg.max_grad_norm,
            eight_bit=cfg.use_8bit_adam, accumulation_steps=accum,
            norm_fn=topt.global_norm if sync is None else functools.partial(sync.norm, role),
        )

    def local(role, params):
        """This process's part of a role's parameters (all of them unless
        ZeRO-3 shards them)."""
        return params if sync is None else sync.shard(role, params)

    tx_s, tx_c = make_tx("student"), make_tx("critic")
    state = tdm.init_state(local("student", student_init), local("critic", teacher),
                           tx_s, tx_c, use_ema=cfg.use_ema)
    if sync is not None and (mesh.n_ep > 1 or mesh.n_tp > 1):
        # the teacher keeps this rank's experts and tp slices alone; the
        # whole leaves it was built with (the module's, the student's start) go
        teacher = {k: v.clone() for k, v in sync.teacher(teacher).items()}
        student_init = None
        if mesh.n_ep > 1:
            _hold_experts(bundle.model, teacher)
    step_fn = tdm.build_train_step(
        denoise_fn, teacher, schedule, tdm_cfg, tx_s, tx_c, sample_shape=sample_shape,
        student_denoise_fn=student_fn, sync=sync,
    )

    # ---- resume ----
    mgr = ckpt_lib.CheckpointManager(out_dir, total_limit=cfg.checkpoints_total_limit)
    global_step = 0
    if cfg.resume_from_checkpoint:
        step0 = ckpt_lib.resolve_resume_step(out_dir, cfg.resume_from_checkpoint)
        if step0 is not None:
            if sync is None:
                state = mgr.restore(state, step0)
            else:  # the one-process checkpoint, each process keeping its part
                state = sync.shard_state(
                    mgr.restore(sync.full_template(state, tx_s, tx_c), step0), device)
            global_step = int(step0)
            logger.info("resumed from checkpoint-%d", global_step)
        else:
            logger.info("no checkpoint found; starting fresh")

    metrics_log = log_lib.MetricLogger(
        os.path.join(out_dir, cfg.logging_dir), report_to=cfg.report_to,
        enabled=main_process,
    )
    timer = log_lib.StepTimer()

    # ---- fixed validation inputs (prompts of --validation_prompts, noise
    # seed 42), only when a TAESD decoder is given and the latents are
    # images [C, H, W]: TAESD decodes no video latent ----
    decode_fn = val_cond = val_noise = None
    vae_dir = os.environ.get("TDM_TAESD_DIR", "")
    if vae_dir and len(sample_shape) == 3:
        dec = _load_taesd(vae_dir, bundle.sample_shape[0], device)
        decode_fn = lambda z: dec(z.float() / dec.cfg.scaling_factor)  # noqa: E731
        gen = torch.Generator(device=device).manual_seed(42)
        val_noise = torch.randn(
            (len(cfg.validation_prompts), *sample_shape), generator=gen, device=device
        )
        val_text, val_mask, val_pooled = val_rows_fn()
        val_cond = bundle.cond_of(
            torch.as_tensor(val_text, dtype=torch.float32, device=device),
            torch.as_tensor(val_mask, dtype=torch.int32, device=device),
            None if val_pooled is None else torch.as_tensor(val_pooled, device=device),
        )

    # ---- loop: with --gradient_accumulation_steps N, N micro-steps make one
    # optimizer step, which alone advances global_step and the cadences ----
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    uncond = None
    profiler = None
    micro_step = 0
    stop_signal: dict = {"signum": None}
    preempted = False

    def _graceful(signum, frame):
        stop_signal["signum"] = signum
        signal.signal(signum, signal.SIG_DFL)
        logger.warning("signal %d — will checkpoint and exit at the next optimizer step",
                       signum)

    prev_handlers = {}
    with contextlib.suppress(ValueError):  # not on the main thread
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _graceful)

    def to_device(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    def pooled_to_device(a):
        return None if a is None else to_device(a, torch.float32)

    def save_checkpoint(step):
        """Every process takes part (a ZeRO-3 state is gathered); process 0
        writes the one-process layout and prunes."""
        full = state if sync is None else sync.gather_state(state)
        if main_process:
            mgr.save(step, full)
        pmesh.barrier()

    while global_step < n_total_steps:
        text_np, mask_np, pooled_np = get_batch()
        cond = bundle.cond_of(to_device(text_np, torch.float32), to_device(mask_np, torch.int32),
                              pooled_to_device(pooled_np))
        if uncond is None:
            # the CFG null branch: the cache's empty-prompt embedding, else
            # zeros under an all-ones mask (smoke mode); its pooled vector is
            # the cache's empty-prompt one, else zeros when the batches carry
            # pooled vectors, else None (the stand-in folds)
            if uncond_pair is not None:
                u_text = np.broadcast_to(uncond_pair[0][None], np.shape(text_np))
                u_mask = np.broadcast_to(uncond_pair[1][None], np.shape(mask_np))
            else:
                u_text, u_mask = np.zeros(np.shape(text_np)), np.ones(np.shape(mask_np))
            if uncond_pooled is not None:
                u_pooled = np.broadcast_to(uncond_pooled[None],
                                           (np.shape(text_np)[0], *uncond_pooled.shape))
            elif pooled_np is not None:
                u_pooled = np.zeros(np.shape(pooled_np), np.float32)
            else:
                u_pooled = None
            uncond = bundle.cond_of(to_device(u_text, torch.float32),
                                    to_device(u_mask, torch.int32), pooled_to_device(u_pooled))
        draws = tdm.make_draws(tdm_cfg, global_batch, sample_shape, gen, device)
        if mesh is not None:
            draws = tdm.draw_rows(draws, mesh.batch_rows(local_batch))

        def run():
            return step_fn(state, draws, cond, uncond, teacher)

        state, metrics = run() if step_hook is None else step_hook(global_step + 1, run)
        micro_step += 1
        if cfg.debug_nans and not all(bool(torch.isfinite(v)) for v in metrics):
            raise FloatingPointError(
                f"non-finite metrics at step {global_step + 1}: {metrics}")
        if micro_step % accum != 0:
            continue  # inside the window: parameters bit-unchanged, no cadence
        global_step += 1

        dt = timer.tick()
        if global_step % 10 == 0 or global_step == 1:
            m = {k: float(v) for k, v in metrics._asdict().items()}
            if dt:
                m["steps_per_sec"] = 1.0 / max(dt, 1e-9)
            metrics_log.log(m, global_step)
            logger.info("step %d loss_student %.4f loss_critic %.4f",
                        global_step, m["loss_student"], m["loss_critic"])
        if decode_fn is not None and global_step % cfg.validation_steps == 0:
            # on every process (a ZeRO-3 student is gathered); process 0 writes
            val_params = state.ema if cfg.use_ema else state.student
            if sync is not None:
                val_params = sync.compute("student", val_params)
            if student_fn is not None:
                with torch.no_grad():
                    val_params = student_fn.merge(val_params, teacher)
            # every rank runs the same rows; the experts stay split
            with contextlib.nullcontext() if sync is None else sync.moe_scope(None):
                grids = validation.save_validation_images(
                    plain_denoise_fn, val_params, schedule,
                    val_cond, val_noise, decode_fn, output_dir=out_dir, step=global_step,
                    total_steps=cfg.total_steps, write=main_process,
                )
            for k_nfe, grid in grids.items():
                metrics_log.log_image(f"validation/{k_nfe}nfe", grid, global_step)
        if global_step % cfg.checkpointing_steps == 0:
            save_checkpoint(global_step)
            logger.info("saved checkpoint-%d", global_step)
        if cfg.profile_steps > 0 and global_step == 10 and main_process:
            # trace the next N steady-state steps (chrome trace under profile/)
            profiler = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else []),
            ])
            profiler.__enter__()
        if profiler is not None and global_step >= 10 + cfg.profile_steps:
            profiler.__exit__(None, None, None)
            os.makedirs(os.path.join(out_dir, "profile"), exist_ok=True)
            profiler.export_chrome_trace(os.path.join(out_dir, "profile", "trace.json"))
            profiler = None
            logger.info("profile written to %s/profile", out_dir)
        # a signal to any process stops them all at the same step
        if pmesh.any_rank(stop_signal["signum"] is not None, device):
            preempted = True
            break

    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(os.path.join(out_dir, "profile"), exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out_dir, "profile", "trace.json"))
    for sig, handler in prev_handlers.items():
        signal.signal(sig, handler)
    if mgr.latest_step() != global_step:
        save_checkpoint(global_step)
    if preempted:
        logger.warning(
            "preempted by signal %s at step %d — checkpoint saved; resume with "
            "--resume_from_checkpoint latest", stop_signal["signum"], global_step,
        )
        metrics_log.close()
        return

    # ---- the final artifacts (`_export`) ----
    final = state.ema if cfg.use_ema else state.student
    if sync is not None:  # gathered on every process; process 0 writes
        final = sync.full("student", final)
        teacher = sync.full_teacher(teacher)
    if main_process:
        _export(cfg, out_dir, final, teacher, bundle.model, stacks, lora_template,
                global_step, logger)
    pmesh.barrier()
    metrics_log.close()
    if device.type == "cuda":
        logger.log(logging.INFO if main_process else logging.WARNING,
                   "peak device memory %.2f GiB (max_memory_allocated) on process %d",
                   torch.cuda.max_memory_allocated(device) / 2**30, rank)
    logger.info("done at step %d", global_step)


def write_student(params: dict, stacks, out_dir: str) -> None:
    """`student.safetensors`: the student's weights in fp16, in the JAX
    package's layout (its stacked layers re-stacked)."""
    from tdm_tpu_torch.io import from_jax, params as params_io

    flat = from_jax.jax_layout(params, stacks=stacks, dtype=torch.float16)
    params_io.save_file(flat, os.path.join(out_dir, "student.safetensors"))


def _export(cfg, out_dir, final, teacher, model, stacks, lora_template, global_step,
            logger) -> None:
    """The final artifacts: the student, fp16, in the JAX package's layout,
    the kohya LoRA (the reference's released form), and the hub upload."""
    from tdm_tpu_torch import lora as lora_lib

    lora_path = os.path.join(out_dir, "tdm_lora.safetensors")
    if lora_template is not None:
        trained = lora_lib.from_factors(final, lora_template.alpha)
        lora_lib.save_kohya(trained, lora_path, prefix="lora_transformer")
        final = lora_lib.merge(teacher, trained, 1.0, stacks)
    write_student(final, stacks, out_dir)
    if lora_template is None and cfg.export_lora_rank > 0:
        lora = lora_lib.extract_lora(model, teacher, final, cfg.export_lora_rank)
        lora_lib.save_kohya(lora, lora_path, prefix="lora_transformer")
    logger.info("exported student.safetensors%s",
                "" if lora_template is None and cfg.export_lora_rank <= 0
                else " and tdm_lora.safetensors")
    if cfg.push_to_hub:
        # the reference's create_repo + upload_folder (src/main.py:36,125-128);
        # the repo id defaults to the output directory's name, as there
        from tdm_tpu_torch.io import hub as hub_io

        repo_id = cfg.hub_model_id or os.path.basename(os.path.normpath(out_dir))
        url = hub_io.push_to_hub(out_dir, repo_id, token=cfg.hub_token,
                                 commit_message=f"tdm_tpu checkpoint (step {global_step})")
        logger.info("pushed %s to hub: %s", out_dir, url)


if __name__ == "__main__":
    main(sys.argv[1:])
