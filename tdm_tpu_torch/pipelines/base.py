"""Pipeline helpers shared by the families: the output record, the LoRA
verbs and the diffusers call-convention pieces of
`tdm_tpu/pipelines/base.py`.

LoRA (`load_lora_weights`, `set_adapters`): adapters merge into the
denoiser's weights in place (the transformer, or SD1.5's UNet). The
pipeline keeps a pristine copy of every weight an adapter touches, and
`set_adapters` re-merges the named adapters from it, so scale 0 gives back
the base (the recipe's teacher baseline).

Noise: with no `latents=`, a pipeline draws its initial noise from a
`torch.Generator` seeded with `seed` (on the CPU, so a seed gives the same
noise on every device). JAX's `PRNGKey(seed)` draws different numbers by
construction: the same seed gives different images in the two packages;
pass `latents=` to feed both the same noise.

Data-parallel serving (`data_parallel_devices`, the counterpart of the JAX
package's `data_parallel_mesh`, `tdm_tpu/pipelines/base.py:71-97`): one
process drives N local devices, as the JAX server does. Each device gets a
replica of the denoiser and the decoder when the attribute is set (the
pipeline's own modules serve the first entry on its device); a call
encodes its prompts and draws its noise for the whole batch, then its rows
split into N equal chunks, which run concurrently (a thread per device,
each on a CUDA stream of its own) and are concatenated in order. So a
row's image does not depend on N. A repeated device is allowed. A
mixture-of-experts denoiser is refused (NotImplementedError): its capacity
drops depend on the whole batch, which the JAX server shards as one global
batch, and a split here would drop other pairs.

Tensor-parallel serving (`tensor_parallel`, the counterpart of the JAX
package's `tensor_parallel_mesh`): set to this process's `TPGroup`
(`parallel/tp.py`), it cuts the denoiser for this rank (its attention and
feed-forward modules run their share of the heads) and the pristine LoRA
weights with it, so a later `set_adapters` merges into the whole weight and
then cuts. On rank 0 every call broadcasts its noise, conditioning and
settings to the followers (`tp.lead`), which run the sampler in step
(`tp.follow`); rank 0 decodes. It is mutually exclusive with
`data_parallel_devices`, with the JAX package's message.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.lora import adapter as lora_lib, io as lora_io
from tdm_tpu_torch.models import moe
from tdm_tpu_torch.ops import quant as quant_lib
from tdm_tpu_torch.parallel import tp as tp_lib


VALUE_RANGES = ("unit", "pm1")


@dataclass
class PipelineOutput:
    """images: [B, H, W, 3] float32 in [0, 1], or videos [B, F, H, W, 3]
    (None with output_type='latent'); latents: the sampler's final x₀
    estimate [B, C, h, w] ([B, C, F, h, w] for a video)."""

    images: Any
    latents: Any = None

    @property
    def frames(self) -> Any:
        """diffusers' video accessor (`pipe(...).frames[0]`): the decoded
        [B, F, H, W, 3] videos. Image and latent outputs raise."""
        if self.images is not None and self.images.dim() == 5:
            return self.images
        raise AttributeError(
            "frames is only available on decoded video outputs ([B,F,H,W,3]); use "
            ".images for decoded images, or .latents with output_type='latent'"
        )


def denoiser_of(pipe) -> torch.nn.Module:
    """A pipeline's denoiser: its `transformer`, or SD1.5's `unet`."""
    model = getattr(pipe, "transformer", None)
    return model if model is not None else pipe.unet


class DiffusionPipelineBase:
    """The LoRA verbs over the pipeline's denoiser (a model with a `cfg`):
    `self.transformer`, or `self.unet` where there is none (SD1.5, as
    `tdm_tpu/pipelines/base.py:285` picks it)."""

    family: str = ""

    def __init__(self):
        self._loras: dict[str, lora_lib.LoRA] = {}
        self._base: dict[str, torch.Tensor] = {}  # pristine adapted weights
        self._active: tuple = ()  # ((name, scale), ...)
        self.quant: Optional[str] = None  # None or 'int8': the sampler's products
        self._replicas: list = []  # one pipeline per data_parallel_devices entry
        self._tp: Optional[tp_lib.TPGroup] = None  # the served 'tp' world this rank leads
        # the 'tp' cut of the denoiser (`tensor_parallel`, or the 'tp' axis of
        # a sequence-parallel mesh) and its leaves (parallel/tp.plan)
        self._tp_cut: Optional[tp_lib.TPGroup] = None
        self._tp_plan: dict = {}
        self.sp_mesh = None  # CogVideoX's sequence_parallel_mesh

    def sampler_scope(self):
        """The scope the sampler runs under: `quant_scope(self.quant)`
        (an unknown mode raises ValueError here, at the call)."""
        return quant_lib.quant_scope(self.quant)

    @property
    def denoiser(self) -> torch.nn.Module:
        return denoiser_of(self)

    @property
    def data_parallel_devices(self) -> Optional[list]:
        """The devices a call's rows are split over (None: this pipeline's
        device alone)."""
        return [r.device for r in self._replicas] or None

    @data_parallel_devices.setter
    def data_parallel_devices(self, devices: Optional[Sequence]) -> None:
        if devices and self._tp is not None:
            raise ValueError(_EXCLUSIVE)
        if devices and self.sp_mesh is not None:
            raise ValueError(SP_DP_EXCLUSIVE)
        if len(devices or ()) > 1 and any(
                isinstance(m, moe.MoEFeedForward) for m in self.denoiser.modules()):
            raise NotImplementedError(
                "--dp with a mixture-of-experts denoiser: a row's capacity drops depend on "
                "the whole batch, and the replicas would split it (ROADMAP.md queue 1, "
                "slice 6)")
        replicas, own = [], False
        for dev in devices or ():
            dev = torch.device(dev)
            if dev == self.device and not own:
                own = True
                replicas.append(self)
            else:
                replicas.append(self._replica(dev))
        self._replicas = replicas

    @property
    def tensor_parallel(self) -> Optional[tp_lib.TPGroup]:
        """This process's place on the 'tp' axis of a tensor-parallel world
        (None: the denoiser runs whole here)."""
        return self._tp

    @tensor_parallel.setter
    def tensor_parallel(self, tp: Optional[tp_lib.TPGroup]) -> None:
        if tp is not None and self._replicas:
            raise ValueError(_EXCLUSIVE)
        if tp is not None and self.sp_mesh is not None:
            raise ValueError(SP_TP_EXCLUSIVE)
        if self._tp_cut is not None:
            raise ValueError("the denoiser is already cut for tensor parallelism")
        if tp is None:
            return
        self._cut_for_tp(tp)
        self._tp = tp

    def _cut_for_tp(self, tp: tp_lib.TPGroup) -> None:
        """Cut the denoiser for this rank of 'tp' (its modules run their
        share of the heads) and the pristine LoRA weights with it."""
        plan = tp_lib.parallelize(self.denoiser, tp)
        self._base = tp_lib.shard_params_tp(self._base, plan, tp)
        self._tp_cut, self._tp_plan = tp, plan

    def _replica(self, device: torch.device) -> "DiffusionPipelineBase":
        """This pipeline with its denoiser, decoder and schedule copied to
        `device`; the text encoders stay behind (prompts are encoded
        before the split)."""
        rep = copy.copy(self)
        rep._replicas = []
        rep.device = device
        for name in ("transformer", "unet", "vae_decoder"):
            module = getattr(self, name, None)
            if module is not None:
                setattr(rep, name, copy.deepcopy(module).to(device))
        schedule = getattr(self, "schedule", None)
        if schedule is not None:
            rep.schedule = dataclasses.replace(
                schedule, alphas=schedule.alphas.to(device), sigmas=schedule.sigmas.to(device))
        return rep

    def run_rows(self, noise: torch.Tensor, cond: Any, uncond: Any, **kw) -> PipelineOutput:
        """The family's `_run(noise, cond, uncond, **kw)` (sampler and
        decode) on these rows, or, with `data_parallel_devices`, on N equal
        chunks of them at once, one per device, concatenated in order.
        Raises ValueError when N does not divide the batch. Under
        `tensor_parallel` (rank 0) the rows and settings go to the
        followers first, which run the sampler in step."""
        if self._tp is not None and self._tp.n > 1:
            tp_lib.lead(self._tp, noise, cond, uncond, kw)
        if not self._replicas:
            return self._run(noise, cond, uncond, **kw)
        n, b = len(self._replicas), noise.shape[0]
        if b % n:
            raise ValueError(
                f"batch {b} does not divide the {n} data-parallel devices — pad the "
                "prompt list"
            )
        per = b // n
        main_stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" \
            else None
        if main_stream is not None and any(r.device != self.device for r in self._replicas):
            main_stream.synchronize()  # the inputs, before another card copies them

        def rows(tree, i, dev):
            if tree is None:
                return None
            if isinstance(tree, torch.Tensor):
                return tree[i * per:(i + 1) * per].to(dev)
            return tuple(rows(t, i, dev) for t in tree)

        def work(i):
            rep = self._replicas[i]
            rep.quant = self.quant
            with torch.inference_mode(), _on_stream(rep.device, main_stream) as stream:
                out = rep._run(rows(noise, i, rep.device), rows(cond, i, rep.device),
                               rows(uncond, i, rep.device), **kw)
                if stream is not None and rep.device == self.device:
                    # the caller's stream reads the results (it waits on this
                    # stream below); the allocator must not hand them out first
                    for t in (out.images, out.latents):
                        if t is not None:
                            t.record_stream(main_stream)
                elif stream is not None:  # another card: done before the copy back
                    stream.synchronize()
            return out, stream

        with ThreadPoolExecutor(max_workers=n, thread_name_prefix="tdm-dp") as pool:
            results = [f.result() for f in [pool.submit(work, i) for i in range(n)]]
        for _, stream in results:
            if stream is not None and stream.device == self.device:
                main_stream.wait_stream(stream)
        outs = [out for out, _ in results]

        def cat(ts):
            return None if ts[0] is None else torch.cat([t.to(self.device) for t in ts])

        return PipelineOutput(images=cat([o.images for o in outs]),
                              latents=cat([o.latents for o in outs]))

    def load_lora_weights(self, path: str, adapter_name: str = "default") -> None:
        """Read a kohya or peft safetensors LoRA and make it the one active
        adapter at scale 1.0."""
        model = self.denoiser
        lora = lora_io.load_lora(path, model=model)
        stacks = from_jax.layer_stacks(model.cfg)
        weights = dict(model.named_parameters())
        for key in lora_lib.adapted_keys(lora, stacks):
            if key not in weights:
                raise KeyError(f"LoRA {path}: the {type(model).__name__} has no weight {key}")
            if key not in self._base:  # untouched by any adapter so far
                self._base[key] = weights[key].detach().clone()
        self._loras[adapter_name] = lora
        self.set_adapters([adapter_name], [1.0])

    @torch.no_grad()
    def set_adapters(
        self, names: Sequence[str], scales: Optional[Sequence[float]] = None
    ) -> None:
        """Merge the named adapters at the given scales into the pristine
        weights; scale 0 leaves an adapter out."""
        scales = list(scales) if scales is not None else [1.0] * len(names)
        model = self.denoiser
        stacks = from_jax.layer_stacks(model.cfg)
        merged = dict(self._base)
        cut = tp_lib.lora_cutter(self._tp_plan, self._tp_cut) if self._tp_plan else None
        for name, scale in zip(names, scales):
            if scale != 0.0:
                merged = lora_lib.merge(merged, self._loras[name], scale, stacks, cut)
        for pipe in [self, *(r for r in self._replicas if r is not self)]:
            weights = dict(pipe.denoiser.named_parameters())
            for key, value in merged.items():
                weights[key].copy_(value)
        self._active = tuple(zip(names, scales))


_EXCLUSIVE = (
    "data_parallel_mesh and tensor_parallel_mesh are mutually "
    "exclusive — a ('data','tp') tensor_parallel_mesh already "
    "carries the batch axis"
)
# a sequence-parallel CogVideoX pipeline against the other two (the JAX
# package's messages, `tdm_tpu/pipelines/cogvideox.py:169-183`)
SP_DP_EXCLUSIVE = (
    "sequence_parallel_mesh and data_parallel_mesh are mutually "
    "exclusive on one pipeline — use a single ('data','sp') "
    "mesh via sequence_parallel_mesh (its 'data' axis already "
    "shards the batch)"
)
SP_TP_EXCLUSIVE = (
    "sequence_parallel_mesh and tensor_parallel_mesh are "
    "mutually exclusive as separate knobs — to COMPOSE them, "
    "pass ONE ('data','sp','tp') mesh as sequence_parallel_mesh: "
    "the 'tp' axis stays automatic inside the shard_map and the "
    "params are megatron-sharded over it"
)


@contextlib.contextmanager
def _on_stream(device: torch.device, main):
    """On CUDA: a side stream of `device`, current for the block, that first
    waits for the work queued on `main` when `main` is on `device` (the
    inputs); elsewhere nothing (yields None)."""
    if device.type != "cuda":
        yield None
        return
    stream = torch.cuda.Stream(device)
    if main is not None and main.device == stream.device:
        stream.wait_stream(main)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield stream


def check_negative_prompt(
    negative_prompt: Optional[Sequence[str]], batch_size: int
) -> Optional[Sequence[str]]:
    """diffusers' check: a str broadcasts to every prompt; a list must have
    one entry per prompt."""
    if negative_prompt is None:
        return None
    if isinstance(negative_prompt, str):
        return [negative_prompt] * batch_size
    if len(negative_prompt) != batch_size:
        raise ValueError(
            f"negative_prompt has {len(negative_prompt)} entries but the "
            f"prompt batch is {batch_size}; pass one negative prompt per "
            "prompt (or a single str for all)"
        )
    return negative_prompt


def repeat_per_prompt(tree: Any, n: int) -> Any:
    """diffusers' num_images_per_prompt: repeat every batch-axis tensor of a
    conditioning tuple n times in repeat_interleave order."""
    if n == 1 or tree is None:
        return tree
    if n < 1:
        raise ValueError(f"num_images_per_prompt must be >= 1, got {n}")
    if isinstance(tree, (tuple, list)):
        return type(tree)(repeat_per_prompt(x, n) for x in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return tree.repeat_interleave(n, dim=0)
    return tree


def generator_for(seed: Optional[int], generator: Optional[torch.Generator]):
    """`generator` wins; else a CPU generator seeded with `seed` (0 when
    None)."""
    if generator is not None:
        return generator
    return torch.Generator().manual_seed(0 if seed is None else int(seed))


def initial_noise(
    latents: Optional[Any],
    generator: torch.Generator,
    shape: tuple,
    device: torch.device,
) -> torch.Tensor:
    """The sampler's starting noise in bf16 (as the JAX package rounds it,
    for every model dtype): caller-given `latents=` win over the generator."""
    if latents is None:
        noise = torch.randn(shape, generator=generator, device=generator.device)
        return noise.to(device=device, dtype=torch.bfloat16)
    latents = torch.as_tensor(latents).to(device=device, dtype=torch.bfloat16)
    if tuple(latents.shape) != tuple(shape):
        raise ValueError(
            f"latents shape {tuple(latents.shape)} != expected {tuple(shape)}"
        )
    return latents


def to_images(decoded: torch.Tensor, *, value_range: str = "unit") -> torch.Tensor:
    """VAE output [B, 3, H, W] → [B, H, W, 3] (a video [B, 3, F, H, W] →
    [B, F, H, W, 3]) float32 in [0, 1]. `value_range`: 'unit' for TAESD
    (its output is [0, 1]), 'pm1' for a KL or 3D VAE ([-1, 1] → /2 + 0.5,
    diffusers' postprocess); then clipped."""
    if value_range not in VALUE_RANGES:
        raise ValueError(f"unknown vae value_range {value_range!r} (one of {VALUE_RANGES})")
    x = decoded.float()
    if value_range == "pm1":
        x = x / 2.0 + 0.5
    x = x.clamp(0.0, 1.0)
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x.permute(0, 2, 3, 4, 1)
