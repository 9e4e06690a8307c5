"""TDM distillation CLI of the port: `python -m tdm_tpu_torch.cli.train_tdm`.

Port of the single-device path of `tdm_tpu/cli/train_tdm.py` (`main`,
`:27-817`), with its flag names and defaults (`utils/config.py`):

  schedule tables → student / critic / teacher parameters (the teacher
  from --pretrained_model_name_or_path when that is a directory of the
  diffusers transformer's safetensors, a checkout's `transformer/`, else
  seeded; with --train_lora_rank the student is a LoRA over the frozen
  teacher) → clip → AdamW or 8-bit Adam, under --gradient_accumulation_steps
  → prompt data (an embedding cache from $TDM_EMBEDDING_CACHE, with SD3's
  pooled vectors when it has them; else hash pseudo-embeddings of the
  prompts of --train_data_dir, a .txt/.jsonl file read by the native C++
  loader where g++ builds it) → the TDM step → loop [a batch per micro-step; per
  optimizer step: metrics at step 1 and every 10 → validation grids every
  --validation_steps when $TDM_TAESD_DIR names a diffusers AutoencoderTiny
  directory → checkpoint every --checkpointing_steps] → final checkpoint,
  `student.safetensors` (fp16, the JAX package's layout) and the kohya
  LoRA `tdm_lora.safetensors`: the trained factors in LoRA mode, else the
  truncated SVD of student − teacher at --export_lora_rank (0 skips it).

--model_family pixart (PixArt-α) or sd3 (SD3-Medium under the shifted flow
schedule, conditioned on T5 tokens and the pooled CLIP vector; a full-size
sd3 run whose data has no pooled vectors is refused with ValueError before
any model is built, unless --allow_pooled_standin). Runs on CUDA unless
`--device cpu` is given, and logs the peak device memory at the end on
CUDA; `TDM_TINY_MODEL=1` swaps in the tiny config. Refused before the
first step, each naming its ROADMAP slice: --fsdp/--tp/--pp/--sp/--ep > 1
(slice 6), --push_to_hub (slice 7), --quant_forwards (slice 4),
--model_family sd15 (slice 4) and cogvideox (slice 5), --moe_experts
(slice 6).
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
from typing import Callable, Optional

import numpy as np
import torch


def refuse_unported(cfg) -> None:
    """NotImplementedError for a flag whose path is not ported, before any
    model is built."""
    for flag in ("fsdp", "tp", "pp", "sp", "ep"):
        if getattr(cfg, flag) > 1:
            raise NotImplementedError(
                f"--{flag} {getattr(cfg, flag)}: multi-GPU training is not "
                "ported yet: ROADMAP.md queue 1, slice 6"
            )
    if cfg.push_to_hub:
        raise NotImplementedError(
            "--push_to_hub is not ported yet: ROADMAP.md queue 1, slice 7 (io/hub.py)"
        )


def _load_taesd(vae_dir: str, latent_channels: int, device):
    """The validation decoder from a diffusers AutoencoderTiny directory
    (TAESD, or TAESD3 for 16-channel latents), as the JAX CLI reads
    $TDM_TAESD_DIR; the decoder side of its converted tree."""
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.models import vae as vae_lib

    vcfg = vae_lib.TAESDConfig.taesd3() if latent_channels == 16 else vae_lib.TAESDConfig()
    dec = vae_lib.TAESDDecoder(vcfg, device=device)
    tree = convert.taesd_params(convert.load_torch_state_dict(vae_dir))["decoder"]
    dec.load_state_dict(from_jax.state_dict_from_jax(convert.flatten(tree), dec))
    return dec


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
    from tdm_tpu_torch.device import resolve_device
    from tdm_tpu_torch.io import from_jax, params as params_io
    from tdm_tpu_torch.train import families, optim as topt, tdm, validation
    from tdm_tpu_torch.utils import checkpoint as ckpt_lib, config as cfg_lib
    from tdm_tpu_torch.utils import logging as log_lib

    cfg = cfg_lib.parse_args(argv)
    refuse_unported(cfg)
    device = resolve_device(cfg.device)
    out_dir = cfg.resolved_output_dir()
    logger = log_lib.setup_logging()
    logger.info("config: %s", cfg)
    logger.info("device: %s%s", device,
                f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
    global_batch = local_batch = cfg.train_batch_size  # one device, one process

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
        cfg.model_family, tiny=tiny, resolution=cfg.resolution,
        gradient_checkpointing=cfg.gradient_checkpointing,
        mixed_precision=cfg.mixed_precision, moe_experts=cfg.moe_experts,
        allow_pooled_standin=cfg.allow_pooled_standin, seed=seed, device=device,
    )
    path = cfg.pretrained_model_name_or_path
    if os.path.isdir(path):
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
        batches = cache.batches(local_batch, seed=seed)

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
        cfg.lr_scheduler, cfg.effective_lr(1),
        warmup_steps=cfg.lr_warmup_steps, total_steps=n_total_steps,
    )

    def make_tx():
        return topt.make_optimizer(
            lr, betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_epsilon,
            weight_decay=cfg.adam_weight_decay, max_grad_norm=cfg.max_grad_norm,
            eight_bit=cfg.use_8bit_adam, accumulation_steps=accum,
        )

    tx_s, tx_c = make_tx(), make_tx()
    tdm_cfg = tdm.TDMConfig(
        cfg=cfg.cfg, total_steps=cfg.total_steps, num_steps=cfg.num_steps,
        use_huber=cfg.use_huber, use_separate=cfg.use_separate,
        loss_mode=cfg.loss_mode, critic_updates=cfg.critic_updates,
        quant_forwards=cfg.quant_forwards, ema_decay=0.9999 ** (1.0 / accum),
    )
    schedule = bundle.schedule
    denoise_fn = bundle.denoise_fn
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
        student_fn = lora_lib.wrap_denoise_fn(denoise_fn, lora_template, stacks=stacks)
        student_init = {k: v.to(device) for k, v in lora_lib.factors(lora_template).items()}
        logger.info("LoRA training: rank %d, %d adapted modules",
                    cfg.train_lora_rank, len(lora_template.alpha))
    step_fn = tdm.build_train_step(
        denoise_fn, teacher, schedule, tdm_cfg, tx_s, tx_c, sample_shape=sample_shape,
        student_denoise_fn=student_fn,
    )
    state = tdm.init_state(student_init, teacher, tx_s, tx_c, use_ema=cfg.use_ema)

    # ---- resume ----
    mgr = ckpt_lib.CheckpointManager(out_dir, total_limit=cfg.checkpoints_total_limit)
    global_step = 0
    if cfg.resume_from_checkpoint:
        step0 = ckpt_lib.resolve_resume_step(out_dir, cfg.resume_from_checkpoint)
        if step0 is not None:
            state = mgr.restore(state, step0)
            global_step = int(step0)
            logger.info("resumed from checkpoint-%d", global_step)
        else:
            logger.info("no checkpoint found; starting fresh")

    metrics_log = log_lib.MetricLogger(
        os.path.join(out_dir, cfg.logging_dir), report_to=cfg.report_to
    )
    timer = log_lib.StepTimer()

    # ---- fixed validation inputs (prompts of --validation_prompts, noise
    # seed 42), only when a TAESD decoder is given ----
    decode_fn = val_cond = val_noise = None
    vae_dir = os.environ.get("TDM_TAESD_DIR", "")
    if vae_dir:
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
        draws = tdm.make_draws(tdm_cfg, local_batch, sample_shape, gen, device)

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
            val_params = state.ema if cfg.use_ema else state.student
            if student_fn is not None:
                with torch.no_grad():
                    val_params = student_fn.merge(val_params, teacher)
            grids = validation.save_validation_images(
                denoise_fn, val_params, schedule,
                val_cond, val_noise, decode_fn, output_dir=out_dir, step=global_step,
                total_steps=cfg.total_steps,
            )
            for k_nfe, grid in grids.items():
                metrics_log.log_image(f"validation/{k_nfe}nfe", grid, global_step)
        if global_step % cfg.checkpointing_steps == 0:
            mgr.save(global_step, state)
            logger.info("saved checkpoint-%d", global_step)
        if cfg.profile_steps > 0 and global_step == 10:
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
        if stop_signal["signum"] is not None:
            break

    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(os.path.join(out_dir, "profile"), exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out_dir, "profile", "trace.json"))
    for sig, handler in prev_handlers.items():
        signal.signal(sig, handler)
    if mgr.latest_step() != global_step:
        mgr.save(global_step, state)
    if stop_signal["signum"] is not None:
        logger.warning(
            "preempted by signal %d at step %d — checkpoint saved; resume with "
            "--resume_from_checkpoint latest", stop_signal["signum"], global_step,
        )
        metrics_log.close()
        return

    # ---- the final artifacts: the student, fp16, in the JAX package's
    # layout, and the kohya LoRA (the reference's released form) ----
    final = state.ema if cfg.use_ema else state.student
    lora_path = os.path.join(out_dir, "tdm_lora.safetensors")
    if lora_template is not None:
        trained = lora_lib.from_factors(final, lora_template.alpha)
        lora_lib.save_kohya(trained, lora_path, prefix="lora_transformer")
        final = lora_lib.merge(teacher, trained, 1.0, stacks)
    flat = from_jax.jax_layout(final, stacks=stacks)
    params_io.save_file(
        {k: v.astype(np.float16) for k, v in flat.items()},
        os.path.join(out_dir, "student.safetensors"),
    )
    if lora_template is None and cfg.export_lora_rank > 0:
        lora = lora_lib.extract_lora(bundle.model, teacher, final, cfg.export_lora_rank)
        lora_lib.save_kohya(lora, lora_path, prefix="lora_transformer")
    logger.info("exported student.safetensors%s",
                "" if lora_template is None and cfg.export_lora_rank <= 0
                else " and tdm_lora.safetensors")
    metrics_log.close()
    if device.type == "cuda":
        logger.info("peak device memory %.2f GiB (max_memory_allocated)",
                    torch.cuda.max_memory_allocated(device) / 2**30)
    logger.info("done at step %d", global_step)


if __name__ == "__main__":
    main(sys.argv[1:])
