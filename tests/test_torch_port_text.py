"""Prompts in: the port's T5 and CLIP text encoders, their converters and
tokenizers, `encode_prompt` in all four pipelines, both `from_pretrained`
routes for the encoders, raw-prompt serving and the port's `build_cache`,
each against the JAX package on the same numpy inputs at tiny sizes.

Tolerances: fp32 modules to 1e-5 of the largest |reference| (the same sums
in another order); bf16 compute to a relative L2 of 1e-2 (both round every
product to bf16, at different points); cache rows, stored at fp16, to one
fp16 step of each value (2**-10 relative) plus 1e-5. Servers bind port 0
and write only under tmp_path.
"""

import base64
import dataclasses
import json
import logging
import os
import sys
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.cli import build_cache as jbuild
from tdm_tpu.data import tokenizer as jtok
from tdm_tpu.io import convert as jconvert
from tdm_tpu.models import (
    clip as jclip, cogvideox as jcog, mmdit_sd3 as jmmdit, pixart as jpixart, t5 as jt5,
    unet_sd15 as junet,
)
from tdm_tpu.pipelines import loading as jloading
from tdm_tpu.pipelines.cogvideox import CogVideoXPipeline as JCogPipeline
from tdm_tpu.pipelines.pixart import PixArtPipeline as JPixArtPipeline
from tdm_tpu.pipelines.sd15 import SD15Pipeline as JSD15Pipeline
from tdm_tpu.pipelines.sd3 import SD3Pipeline as JSD3Pipeline
from tdm_tpu_torch.cli import build_cache as tbuild
from tdm_tpu_torch.data import prompts as tprompts, tokenizer as ttok
from tdm_tpu_torch.io import convert as tconvert, from_jax, manifest as tmanifest
from tdm_tpu_torch.io import params as params_io
from tdm_tpu_torch.models import (
    clip as tclip, cogvideox as tcog, mmdit_sd3 as tmmdit, pixart as tpixart, t5 as tt5,
    unet_sd15 as tunet,
)
from tdm_tpu_torch.pipelines import (
    CogVideoXPipeline, PixArtPipeline, SD15Pipeline, from_pretrained, save_pretrained,
)
from tdm_tpu_torch.pipelines.sd3 import SD3Pipeline
from tdm_tpu_torch.serve import batcher as tbatcher, server as tserver

torch.set_num_threads(2)

PROMPTS = ["a red fox", "two cats on a sofa at night", "x", "a photo of a dog"]


def assert_f32_close(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), np.abs(got - ref).max()


def assert_rel_l2(got, ref, bound=1e-2):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= bound, rel


# --- the encoders from one JAX init ------------------------------------------


def _jt5_cfg(**kw):
    return dataclasses.replace(jt5.T5Config.tiny(), **kw)


def jax_t5(seed=0, **kw):
    cfg = _jt5_cfg(**kw)
    model = jt5.T5Encoder(cfg=cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32))["params"]
    return model, params


def port_t5(params, **kw):
    cfg = dataclasses.replace(tt5.T5Config.tiny(), **kw)
    return from_jax.load_from_jax(from_jax.flatten_tree(params), tt5.T5Encoder(cfg, device="cpu"))


def jax_clip(seed=0, **kw):
    cfg = dataclasses.replace(jclip.CLIPTextConfig.tiny(), **kw)
    model = jclip.CLIPTextEncoder(cfg=cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16), jnp.int32))["params"]
    return model, params


def port_clip(params, **kw):
    cfg = dataclasses.replace(tclip.CLIPTextConfig.tiny(), **kw)
    return from_jax.load_from_jax(from_jax.flatten_tree(params),
                                  tclip.CLIPTextEncoder(cfg, device="cpu"))


def _ids(rng, b, s, vocab, lengths=None):
    ids = rng.integers(1, vocab - 1, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if lengths is not None:
        mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
        ids = ids * mask
    return ids, mask


def test_relative_position_bucket_matches_jax():
    rel = np.arange(-400, 401)[None, :] - np.arange(0, 9)[:, None]
    for buckets, dist in ((32, 128), (16, 64), (8, 20)):
        np.testing.assert_array_equal(tt5.relative_position_bucket(rel, buckets, dist),
                                      jt5.relative_position_bucket(rel, buckets, dist))


@pytest.mark.parametrize("mask", ["none", "padded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_t5_encoder_matches_jax(mask, dtype):
    """fp32: to 1e-5 of the largest |ref|; bf16 compute (fp32 params in
    JAX, cast at use; bf16 weights in the port): relative L2 under 1e-2.
    A padded row's keys beyond its length get −1e9."""
    model, params = jax_t5(0, dtype=getattr(jnp, dtype))
    enc = port_t5(params, dtype=getattr(torch, dtype))
    assert enc.shared_embedding.dtype == getattr(torch, dtype)
    assert enc.block_0.SelfAttention.relative_attention_bias.dtype == torch.float32
    assert enc.block_1.ln_ff.scale.dtype == torch.float32
    ids, m = _ids(np.random.default_rng(1), 3, 12, 128,
                  lengths=[12, 5, 1] if mask == "padded" else None)
    m_arg = None if mask == "none" else m
    ref = model.apply({"params": params}, jnp.asarray(ids),
                      None if m_arg is None else jnp.asarray(m_arg))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), None if m_arg is None else torch.from_numpy(m_arg))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert_f32_close(got, ref)
    else:
        assert_rel_l2(got, ref)


@pytest.mark.parametrize("case", ["clip_l", "projected_gelu", "legacy_eos", "bf16"])
def test_clip_text_encoder_matches_jax(case):
    """The last state, the penultimate `hidden_states[-2]` (SD3's), and the
    pooled vector: at the first EOS (95), through a projection with exact
    GELU (OpenCLIP-G's), at the highest id for the legacy eos_token_id 2
    (whose rows hold no token 2), and in bf16 compute."""
    kw = {"clip_l": {}, "projected_gelu": {"projection_dim": 8, "activation": "gelu"},
          "legacy_eos": {"eos_token_id": 2}, "bf16": {"projection_dim": 8}}[case]
    jkw = dict(kw, dtype=jnp.bfloat16) if case == "bf16" else kw
    tkw = dict(kw, dtype=torch.bfloat16) if case == "bf16" else kw
    model, params = jax_clip(3, **jkw)
    enc = port_clip(params, **tkw)
    assert enc.token_embedding.dtype == torch.float32  # added in fp32, then cast
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 90, size=(3, 16)).astype(np.int32)
    eos = [5, 15, 0]
    ids[np.arange(3), eos] = 95
    ids[0, 9] = 95  # a second EOS: the first one pools
    ref = model.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids))
    pairs = ((got.last_hidden_state, ref.last_hidden_state),
             (got.hidden_states[-2], ref.hidden_states[-2]), (got.pooled, ref.pooled))
    assert len(got.hidden_states) == len(ref.hidden_states) == 3
    for g, r in pairs:
        (assert_rel_l2 if case == "bf16" else assert_f32_close)(g, r)
    if case == "clip_l":  # pooled = the state at each row's first EOS
        torch.testing.assert_close(got.pooled, got.last_hidden_state[[0, 1, 2], [5, 15, 0]])


# --- converters ---------------------------------------------------------------


def hf_t5_shapes(c) -> dict:
    """The HF T5EncoderModel keys and shapes of a config."""
    d, inner = c.d_model, c.num_heads * c.d_kv
    out = {"shared.weight": (c.vocab_size, d), "encoder.final_layer_norm.weight": (d,)}
    for i in range(c.num_layers):
        b = f"encoder.block.{i}.layer"
        out[f"{b}.0.layer_norm.weight"] = (d,)
        for p in ("q", "k", "v"):
            out[f"{b}.0.SelfAttention.{p}.weight"] = (inner, d)
        out[f"{b}.0.SelfAttention.o.weight"] = (d, inner)
        if i == 0:
            out[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = (c.rel_buckets,
                                                                          c.num_heads)
        out[f"{b}.1.layer_norm.weight"] = (d,)
        out[f"{b}.1.DenseReluDense.wi_0.weight"] = (c.d_ff, d)
        out[f"{b}.1.DenseReluDense.wi_1.weight"] = (c.d_ff, d)
        out[f"{b}.1.DenseReluDense.wo.weight"] = (d, c.d_ff)
    return out


def hf_clip_shapes(c) -> dict:
    """The HF CLIPTextModel(WithProjection) keys and shapes of a config."""
    d, f = c.hidden, c.hidden * c.mlp_ratio
    t = "text_model"
    out = {f"{t}.embeddings.token_embedding.weight": (c.vocab_size, d),
           f"{t}.embeddings.position_embedding.weight": (c.max_positions, d),
           f"{t}.final_layer_norm.weight": (d,), f"{t}.final_layer_norm.bias": (d,)}
    for i in range(c.num_layers):
        b = f"{t}.encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            out[f"{b}.{n}.weight"] = out[f"{b}.{n}.bias"] = (d,)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{b}.self_attn.{p}.weight"] = (d, d)
            out[f"{b}.self_attn.{p}.bias"] = (d,)
        out[f"{b}.mlp.fc1.weight"], out[f"{b}.mlp.fc1.bias"] = (f, d), (f,)
        out[f"{b}.mlp.fc2.weight"], out[f"{b}.mlp.fc2.bias"] = (d, f), (d,)
    if c.projection_dim is not None:
        out["text_projection.weight"] = (c.projection_dim, d)
    return out


def hf_state_dict(shapes: dict, seed: int) -> dict:
    """Seeded fp32 weights at trained-like scales: norms near 1, biases
    near 0, matrices at 1/sqrt(fan in), embeddings and the relative bias
    at 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        x = rng.standard_normal(shape).astype(np.float32)
        if "norm" in k and k.endswith("weight"):
            x = 1.0 + 0.1 * x
        elif k.endswith("bias"):
            x = 0.1 * x
        elif "embedding" not in k and "shared" not in k and "relative" not in k:
            x = x / np.sqrt(shape[1])
        out[k] = x
    return out


def hf_config(cfg) -> dict:
    """The config.json of an HF encoder folder for a port encoder config."""
    if isinstance(cfg, tt5.T5Config):
        return {"architectures": ["T5EncoderModel"], "vocab_size": cfg.vocab_size,
                "d_model": cfg.d_model, "d_kv": cfg.d_kv, "num_heads": cfg.num_heads,
                "d_ff": cfg.d_ff, "num_layers": cfg.num_layers,
                "relative_attention_num_buckets": cfg.rel_buckets,
                "relative_attention_max_distance": cfg.rel_max_distance}
    out = {"architectures": ["CLIPTextModel"], "vocab_size": cfg.vocab_size,
           "hidden_size": cfg.hidden, "num_attention_heads": cfg.num_heads,
           "num_hidden_layers": cfg.num_layers, "max_position_embeddings": cfg.max_positions,
           "eos_token_id": cfg.eos_token_id, "hidden_act": cfg.activation,
           "intermediate_size": cfg.hidden * cfg.mlp_ratio}
    if cfg.projection_dim is not None:
        out.update(architectures=["CLIPTextModelWithProjection"],
                   projection_dim=cfg.projection_dim)
    return out


def write_encoder(folder, cfg, seed: int) -> dict:
    """An HF encoder folder: config.json and model.safetensors (fp32)."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    shapes = hf_t5_shapes(cfg) if isinstance(cfg, tt5.T5Config) else hf_clip_shapes(cfg)
    sd = hf_state_dict(shapes, seed)
    params_io.save_file(sd, os.path.join(folder, "model.safetensors"))
    return sd


@pytest.mark.parametrize("kind", ["t5", "clip", "clip_projected"])
def test_text_converters_match_jax(kind):
    """On a tiny HF state dict: the same tree as the JAX converter, leaf for
    leaf; the HF aliases and buffers ignored; the same messages for a
    missing and for a leftover key; and the converted encoder computes what
    the JAX one computes from JAX's tree."""
    if kind == "t5":
        cfg = tt5.T5Config.tiny()
        sd = hf_state_dict(hf_t5_shapes(cfg), 5)
        sd["encoder.embed_tokens.weight"] = sd["shared.weight"]  # the tied alias
        conv, jconv, missing = tconvert.t5_encoder_params, jconvert.t5_encoder_params, \
            "encoder.block.1.layer.1.DenseReluDense.wo.weight"
    else:
        cfg = dataclasses.replace(tclip.CLIPTextConfig.tiny(), projection_dim=(
            8 if kind == "clip_projected" else None))
        sd = hf_state_dict(hf_clip_shapes(cfg), 6)
        sd["text_model.embeddings.position_ids"] = np.arange(16)[None]
        conv, jconv, missing = tconvert.clip_text_params, jconvert.clip_text_params, \
            "text_model.encoder.layers.0.mlp.fc1.weight"
    got = tconvert.flatten(conv(sd))
    ref = from_jax.flatten_tree(jconv(sd))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    for bad in ({k: v for k, v in sd.items() if k != missing}, {**sd, "extra.weight": sd[missing]}):
        with pytest.raises((KeyError, ValueError)) as te:
            conv(bad)
        with pytest.raises((KeyError, ValueError)) as je:
            jconv(bad)
        assert te.type is je.type and str(te.value) == str(je.value)
    ids, mask = _ids(np.random.default_rng(7), 2, 10, 90, lengths=[10, 4])
    if kind == "t5":
        enc = from_jax.load_from_jax(got, tt5.T5Encoder(cfg, device="cpu"))
        jref = jt5.T5Encoder(cfg=jt5.T5Config.tiny()).apply(
            {"params": jconvert.to_jax(jconv(sd))}, jnp.asarray(ids), jnp.asarray(mask))
        assert_f32_close(enc(ids, mask), jref)
    else:
        enc = from_jax.load_from_jax(got, tclip.CLIPTextEncoder(cfg, device="cpu"))
        jcfg = dataclasses.replace(jclip.CLIPTextConfig.tiny(),
                                   projection_dim=cfg.projection_dim)
        jref = jclip.CLIPTextEncoder(cfg=jcfg).apply(
            {"params": jconvert.to_jax(jconv(sd))}, jnp.asarray(ids))
        assert_f32_close(enc(ids).pooled, jref.pooled)


def test_load_from_jax_equals_the_state_dict_route():
    """The device-side carry gives the module the same values as
    load_state_dict(state_dict_from_jax(...)), a bf16 module too."""
    _, params = jax_t5(2)
    flat = from_jax.flatten_tree(params)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(tt5.T5Config.tiny(), dtype=dtype)
        a = tt5.T5Encoder(cfg, device="cpu")
        a.load_state_dict(from_jax.state_dict_from_jax(flat, a))
        b = from_jax.load_from_jax(flat, tt5.T5Encoder(cfg, device="cpu"))
        for k, v in a.state_dict().items():
            assert b.state_dict()[k].dtype == v.dtype
            torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(KeyError, match="missing keys"):
        from_jax.load_from_jax({k: v for k, v in flat.items() if "wo" not in k},
                               tt5.T5Encoder(tt5.T5Config.tiny(), device="cpu"))


# --- tokenizers ---------------------------------------------------------------


def hf_tokenizer_dir(path) -> str:
    """A local HF tokenizer folder (a WordLevel tokenizer whose pad is 0 and
    EOS 95, appended to every text), readable by AutoTokenizer."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    words = sorted({w for p in PROMPTS + ["a photo of a cat"] for w in p.split()})
    vocab = {"<pad>": 0, "<unk>": 1, **{w: i + 2 for i, w in enumerate(words)}, "</s>": 95}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 95)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                            eos_token="</s>").save_pretrained(str(path))
    return str(path)


def test_tokenizers_match_jax(tmp_path, monkeypatch):
    """HashTokenizer and HFTokenizer give the JAX package's ids and masks;
    without `transformers`, HFTokenizer raises ImportError naming it."""
    folder = hf_tokenizer_dir(tmp_path / "tok")
    for t, j in ((ttok.HashTokenizer(), jtok.HashTokenizer()),
                 (ttok.HashTokenizer(96, eos_id=95), jtok.HashTokenizer(96, eos_id=95)),
                 (ttok.HFTokenizer(folder), jtok.HFTokenizer(folder))):
        for a, b in zip(t(PROMPTS, max_length=6), j(PROMPTS, max_length=6)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    ids, mask = ttok.HFTokenizer(folder)(["a red fox"], max_length=6)
    assert ids[0, 3] == 95 and mask[0].tolist() == [1, 1, 1, 1, 0, 0]
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        ttok.HFTokenizer(folder)


# --- encode_prompt in the four pipelines -----------------------------------------


def _t5_pair(seed, **kw):
    model, params = jax_t5(seed, **kw)
    return (model, params), port_t5(params, **kw)


def _clip_pair(seed, **kw):
    model, params = jax_clip(seed, **kw)
    return (model, params), port_clip(params, **kw)


def family_pipes(family):
    """(JAX pipeline, port pipeline, port __call__ kwargs, latent shape of a
    row) with the same tiny encoders and hash tokenizers; the denoisers are
    the port's tiny ones (encode_prompt never reads JAX's params)."""
    t5_tok = (jtok.HashTokenizer(128), ttok.HashTokenizer(128))
    clip_tok = (jtok.HashTokenizer(96, eos_id=95), ttok.HashTokenizer(96, eos_id=95))
    if family == "pixart":
        (jm, jp), enc = _t5_pair(0)
        jpipe = JPixArtPipeline(jpixart.PixArtTransformer2D(cfg=jpixart.PixArtConfig.tiny()),
                                None, text_encoder=jm, text_encoder_params=jp,
                                tokenizer=t5_tok[0], max_text_len=12)
        pipe = PixArtPipeline(tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny(),
                                                          device="cpu"),
                              text_encoder=enc, tokenizer=t5_tok[1], max_text_len=12,
                              device="cpu")
        return jpipe, pipe, dict(height=128, width=128), (4, 16, 16)
    if family == "sd15":
        (jm, jp), enc = _clip_pair(1)
        jpipe = JSD15Pipeline(junet.UNet2DCondition(cfg=junet.UNetConfig.tiny()), None,
                              text_encoder=jm, text_encoder_params=jp, tokenizer=clip_tok[0],
                              max_text_len=16)
        pipe = SD15Pipeline(tunet.UNet2DCondition(tunet.UNetConfig.tiny(), device="cpu"),
                            text_encoder=enc, tokenizer=clip_tok[1], max_text_len=16,
                            device="cpu")
        return jpipe, pipe, dict(height=64, width=64), (4, 8, 8)
    if family == "cogvideox":
        (jm, jp), enc = _t5_pair(2)
        jpipe = JCogPipeline(jcog.CogVideoXTransformer3D(cfg=jcog.CogVideoXConfig.tiny()), None,
                             text_encoder=jm, text_encoder_params=jp, tokenizer=t5_tok[0])
        pipe = CogVideoXPipeline(tcog.CogVideoXTransformer3D(tcog.CogVideoXConfig.tiny(),
                                                             device="cpu"),
                                 text_encoder=enc, tokenizer=t5_tok[1], device="cpu")
        return jpipe, pipe, dict(num_frames=9, height=64, width=64), (16, 3, 8, 8)
    (jl, jpl), l_enc = _clip_pair(3, hidden=16, num_heads=2, projection_dim=16)
    (jg, jpg), g_enc = _clip_pair(4, hidden=24, num_heads=2, projection_dim=8,
                                  activation="gelu")
    (jt, jpt), t_enc = _t5_pair(5, d_model=48)
    jpipe = JSD3Pipeline(
        jmmdit.SD3Transformer2D(cfg=jmmdit.MMDiTConfig.tiny()), None,
        text_encoders={"clip_l": (jl, jpl), "clip_g": (jg, jpg), "t5": (jt, jpt)},
        tokenizers={"clip_l": clip_tok[0], "clip_g": clip_tok[0], "t5": t5_tok[0]},
        max_t5_len=8, max_clip_len=16)
    pipe = SD3Pipeline(
        tmmdit.SD3Transformer2D(tmmdit.MMDiTConfig.tiny(), device="cpu"),
        text_encoders={"clip_l": l_enc, "clip_g": g_enc, "t5": t_enc},
        tokenizers={"clip_l": clip_tok[1], "clip_g": clip_tok[1], "t5": t5_tok[1]},
        max_t5_len=8, max_clip_len=16, device="cpu")
    return jpipe, pipe, dict(height=64, width=64), (16, 8, 8)


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("family", ["pixart", "sd3", "sd15", "cogvideox"])
def test_encode_prompt_matches_jax(family):
    """Each family's encode_prompt against the JAX pipeline's on the same
    encoders and tokenizers: PixArt (T5 embeds, mask), SD1.5 (CLIP-L's last
    state, mask), CogVideoX (T5 at the transformer's max_text_len, no mask)
    and SD3 (context [B, 16 + 8, 48]: the CLIP-L/G penultimate states
    side by side, zero-padded from 40 to 48, then T5 on the sequence axis;
    pooled [B, 16 + 8]). Then CFG: a raw-prompt call with a negative prompt
    (and with none: "") gives the bits of the call with both encoded."""
    jpipe, pipe, call, row = family_pipes(family)
    got, ref = _leaves(pipe.encode_prompt(PROMPTS)), _leaves(jpipe.encode_prompt(PROMPTS))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if g.is_floating_point():
            assert_f32_close(g, r)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if family == "sd3":
        ctx, pooled = got
        assert ctx.shape == (4, 16 + 8, 48) and pooled.shape == (4, 24)
        assert not ctx[:, :16, 40:].any()  # the padding of the CLIP features
    lat = np.random.default_rng(9).standard_normal((2, *row)).astype(np.float32)
    kw = dict(call, num_inference_steps=2, latents=lat, output_type="latent",
              guidance_scale=2.0)
    for neg in (["low quality", "blurry"], None):
        raw = pipe(PROMPTS[:2], negative_prompt=neg, **kw).latents
        enc = pipe(prompt_embeds=pipe.encode_prompt(PROMPTS[:2]),
                   negative_embeds=pipe.encode_prompt(neg or ["", ""]), **kw).latents
        torch.testing.assert_close(raw, enc, rtol=0, atol=0)
    for g, r in zip(_leaves(pipe.encode_prompt(["low quality"])),
                    _leaves(jpipe.encode_prompt(["low quality"]))):
        if g.is_floating_point():
            assert_f32_close(g, r)


# --- from_pretrained: the bundle and the checkout's text_encoder*/ ----------------


def _jax_bundle(path, family, seed=0):
    """A tiny JAX pipeline with its encoder and a hash tokenizer, written by
    the JAX package's save_pretrained."""
    if family == "sd15":
        cfg = junet.UNetConfig.tiny()
        model = junet.UNet2DCondition(cfg=cfg)
        params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
                            jnp.zeros((1, 16, 32)))["params"]
        jm, jp = jax_clip(seed + 1, max_positions=77)  # SD1.5's 77 tokens
        pipe = JSD15Pipeline(model, params, text_encoder=jm, text_encoder_params=jp,
                             tokenizer=jtok.HashTokenizer(96, eos_id=95))
    else:
        cfg = jpixart.PixArtConfig.tiny()
        model = jpixart.PixArtTransformer2D(cfg=cfg)
        params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 16, 16)),
                            jnp.zeros((1,)), jnp.zeros((1, 8, 32)),
                            jnp.ones((1, 8), jnp.int32))["params"]
        jm, jp = jax_t5(seed + 1)
        pipe = JPixArtPipeline(model, params, text_encoder=jm, text_encoder_params=jp,
                               tokenizer=jtok.HashTokenizer(128))
    pipe.save_pretrained(str(path))
    return pipe


@pytest.mark.parametrize("family", ["pixart", "sd15"])
def test_bundled_encoder_loads_in_both_packages(tmp_path, family):
    """A layout-1 bundle with a T5 (PixArt) or CLIP (SD1.5) encoder and
    {"kind": "hash"}: the JAX package's loads into the port (the same
    encode_prompt); the port's save_pretrained of it loads into the JAX
    package with the same encoder params and tokenizer; a tokenizer the
    caller passes wins."""
    jpipe = _jax_bundle(tmp_path / "jax", family)
    pipe = from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert isinstance(pipe.tokenizer, ttok.HashTokenizer)
    assert (pipe.tokenizer.vocab_size, pipe.tokenizer.eos_id) == (
        jpipe.tokenizer.vocab_size, jpipe.tokenizer.eos_id)
    for g, r in zip(_leaves(pipe.encode_prompt(PROMPTS)), _leaves(jpipe.encode_prompt(PROMPTS))):
        assert_f32_close(g, r) if g.is_floating_point() else np.testing.assert_array_equal(
            g.numpy(), np.asarray(r))
    save_pretrained(str(tmp_path / "port"), pipe)
    back = jloading.from_pretrained(str(tmp_path / "port"))
    assert type(back.text_encoder).__name__ == type(jpipe.text_encoder).__name__
    # the port's configs have no attn_impl (the JAX encoders never read it):
    # the bundle back in the JAX package takes its default
    assert back.text_encoder.cfg == dataclasses.replace(jpipe.text_encoder.cfg,
                                                        attn_impl="auto")
    ref = from_jax.flatten_tree(jpipe.text_encoder_params)
    got = from_jax.flatten_tree(back.text_encoder_params)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert vars(back.tokenizer) == vars(jpipe.tokenizer)
    mine = ttok.HashTokenizer(50)
    assert from_pretrained(str(tmp_path / "jax"), device="cpu", tokenizer=mine).tokenizer is mine


def test_bundle_with_hf_tokenizer_folder_round_trips(tmp_path, caplog):
    """An HFTokenizer of a local folder is bundled as tokenizer/ by the
    port and read back by both packages; a tokenizer that cannot be bundled
    is left out with a warning, as in the JAX package."""
    folder = hf_tokenizer_dir(tmp_path / "tok")
    jm, jp = jax_t5(1)
    pipe = PixArtPipeline(tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny(), device="cpu"),
                          text_encoder=port_t5(jp), tokenizer=ttok.HFTokenizer(folder),
                          device="cpu")
    save_pretrained(str(tmp_path / "port"), pipe)
    meta = json.loads((tmp_path / "port" / "pipeline.json").read_text())
    assert meta["text_encoder"]["tokenizer"] == {"kind": "hf"}
    assert meta["text_encoder"]["family"] == "t5"
    back = jloading.from_pretrained(str(tmp_path / "port"))
    again = from_pretrained(str(tmp_path / "port"), device="cpu")
    assert isinstance(again.tokenizer, ttok.HFTokenizer)
    ref = back.encode_prompt(PROMPTS)
    for g, r in zip(again.encode_prompt(PROMPTS), ref):
        assert_f32_close(g, r) if g.is_floating_point() else np.testing.assert_array_equal(
            g.numpy(), np.asarray(r))
    pipe.tokenizer = lambda texts, max_length: None
    with caplog.at_level(logging.WARNING):
        save_pretrained(str(tmp_path / "nontok"), pipe)
    assert "cannot be bundled" in caplog.text
    assert from_pretrained(str(tmp_path / "nontok"), device="cpu").tokenizer is None


def _denoiser_folder(root, family):
    """model_index.json and the tiny denoiser's folder of a checkout (the
    port's synthetic weights; no VAE)."""
    cfgs = {"pixart": tpixart.PixArtConfig.tiny(), "sd3": tmmdit.MMDiTConfig.tiny(),
            "sd15": tunet.UNetConfig.tiny(), "cogvideox": tcog.CogVideoXConfig.tiny()}
    cfg = cfgs[family]
    if family == "sd15":
        sub, manifest, conf = "unet", "unet_sd15", {
            "_class_name": "UNet2DConditionModel", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "layers_per_block": cfg.layers_per_block,
            "block_out_channels": list(cfg.block_widths), "norm_num_groups": cfg.norm_groups,
            "cross_attention_dim": cfg.context_dim, "attention_head_dim": cfg.num_heads}
    elif family == "cogvideox":
        sub, manifest, conf = "transformer", "cogvideox", {
            "_class_name": "CogVideoXTransformer3DModel", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "patch_size": cfg.patch_size,
            "num_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "attention_head_dim": cfg.head_dim, "text_embed_dim": cfg.text_dim,
            "time_embed_dim": cfg.time_embed_dim, "max_text_seq_length": cfg.max_text_len,
            "sample_frames": (cfg.sample_frames - 1) * 4 + 1, "sample_height": cfg.sample_h,
            "sample_width": cfg.sample_w, "temporal_compression_ratio": 4,
            "use_rotary_positional_embeddings": cfg.use_rotary}
    else:
        sub, manifest = "transformer", family
        conf = {"sample_size": cfg.sample_size, "patch_size": cfg.patch_size,
                "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
                "num_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                "attention_head_dim": cfg.head_dim}
        if family == "pixart":
            conf.update(_class_name="PixArtTransformer2DModel", caption_channels=cfg.caption_dim)
        else:
            conf.update(_class_name="SD3Transformer2DModel", joint_attention_dim=cfg.context_dim,
                        pooled_projection_dim=cfg.pooled_dim,
                        pos_embed_max_size=cfg.pos_embed_max_size)
    index = {"pixart": "PixArtAlphaPipeline", "sd3": "StableDiffusion3Pipeline",
             "sd15": "StableDiffusionPipeline", "cogvideox": "CogVideoXPipeline"}[family]
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"_class_name": index}, f)
    with open(os.path.join(root, sub, "config.json"), "w") as f:
        json.dump(conf, f)
    tmanifest.write_synthetic(manifest, os.path.join(root, sub, "diffusion_pytorch_model.safetensors"),
                              cfg, seed=0)


SD3_ENCODERS = {  # SD3's 77 CLIP positions
    "text_encoder": dataclasses.replace(tclip.CLIPTextConfig.tiny(), hidden=16, num_heads=2,
                                        max_positions=77, projection_dim=16),
    "text_encoder_2": dataclasses.replace(tclip.CLIPTextConfig.tiny(), hidden=24, num_heads=2,
                                          max_positions=77, projection_dim=8,
                                          activation="gelu"),
    "text_encoder_3": dataclasses.replace(tt5.T5Config.tiny(), d_model=48),
}


def write_encoder_checkout(root, family, *, tokenizer_dirs=False) -> str:
    """A tiny diffusers checkout of `family` with its text_encoder*/
    folders (HF layout, seeded) and, optionally, tokenizer*/ folders."""
    root = str(root)
    _denoiser_folder(root, family)
    if family == "sd3":
        encoders = SD3_ENCODERS
    elif family == "sd15":
        encoders = {"text_encoder": dataclasses.replace(tclip.CLIPTextConfig.tiny(),
                                                        max_positions=77)}
    else:
        encoders = {"text_encoder": tt5.T5Config.tiny()}
    for i, (sub, cfg) in enumerate(encoders.items()):
        write_encoder(os.path.join(root, sub), cfg, seed=20 + i)
        if tokenizer_dirs:
            hf_tokenizer_dir(os.path.join(root, sub.replace("text_encoder", "tokenizer")))
    return root


@pytest.mark.parametrize("family", ["pixart", "sd3", "sd15", "cogvideox"])
def test_checkout_text_encoders_load_in_both_packages(tmp_path, family):
    """text_encoder*/ of a checkout (SD3: CLIP-L, CLIP-G with projections,
    T5) through both packages' from_pretrained in fp32, with hash
    tokenizers passed by the caller: the same encode_prompt."""
    root = write_encoder_checkout(tmp_path / "ckpt", family)
    f32 = {"dtype": "float32", "attn_impl": "xla"}
    if family == "sd3":
        kw = {"tokenizers": {"clip_l": ttok.HashTokenizer(96, eos_id=95),
                             "clip_g": ttok.HashTokenizer(96, eos_id=95),
                             "t5": ttok.HashTokenizer(128)}}
        jkw = {"tokenizers": {"clip_l": jtok.HashTokenizer(96, eos_id=95),
                              "clip_g": jtok.HashTokenizer(96, eos_id=95),
                              "t5": jtok.HashTokenizer(128)}}
    else:
        vocab = (96, 95) if family == "sd15" else (128, None)
        kw = {"tokenizer": ttok.HashTokenizer(vocab[0], eos_id=vocab[1])}
        jkw = {"tokenizer": jtok.HashTokenizer(vocab[0], eos_id=vocab[1])}
    pipe = from_pretrained(root, device="cpu", model_config=f32, **kw)
    jpipe = jloading.from_pretrained(root, model_config=f32, **jkw)
    if family == "sd3":
        assert set(pipe.text_encoders) == {"clip_l", "clip_g", "t5"}
        assert pipe.text_encoders["clip_g"].cfg.activation == "gelu"
        assert pipe.text_encoders["clip_l"].cfg.projection_dim == 16
        assert pipe.text_encoders["t5"].cfg.dtype == torch.float32
        pipe.max_t5_len = jpipe.max_t5_len = 8
        pipe.max_clip_len = jpipe.max_clip_len = 16
    else:
        assert pipe.text_encoder.cfg.dtype == torch.float32
        if family == "pixart":
            pipe.max_text_len = jpipe.max_text_len = 12
    for g, r in zip(_leaves(pipe.encode_prompt(PROMPTS)), _leaves(jpipe.encode_prompt(PROMPTS))):
        assert_f32_close(g, r) if g.is_floating_point() else np.testing.assert_array_equal(
            g.numpy(), np.asarray(r))


def test_checkout_tokenizer_folders_and_partial_stacks(tmp_path, monkeypatch):
    """tokenizer*/ folders load as HFTokenizers (SD3: all three); an SD3
    checkout missing one encoder folder gives no stack; without
    `transformers` the load raises ImportError naming it, unless the caller
    passes the tokenizers."""
    root = write_encoder_checkout(tmp_path / "sd3", "sd3", tokenizer_dirs=True)
    pipe = from_pretrained(root, device="cpu")
    assert all(isinstance(t, ttok.HFTokenizer) for t in pipe.tokenizers.values())
    assert pipe.text_encoders["t5"].cfg.dtype == torch.bfloat16  # the default
    ctx, pooled = pipe.encode_prompt(PROMPTS[:2])
    assert ctx.shape == (2, 77 + 256, 48) and pooled.shape == (2, 24)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        from_pretrained(root, device="cpu")
    toks = {k: ttok.HashTokenizer(96, eos_id=95) for k in ("clip_l", "clip_g", "t5")}
    assert from_pretrained(root, device="cpu", tokenizers=toks).tokenizers == toks
    monkeypatch.undo()
    import shutil

    shutil.rmtree(os.path.join(root, "text_encoder_2"))
    pipe = from_pretrained(root, device="cpu")
    assert pipe.text_encoders == {} and not tbatcher.has_encoders(pipe)


# --- serving raw prompts and the port's build_cache ----------------------------------


def _bundle_pipe(encoder: bool) -> PixArtPipeline:
    """A tiny PixArt (fp32) with a TAESD and, when `encoder`, a T5 that
    computes in bf16 (its rows are bf16 values, which fp16 holds exactly)
    and a hash tokenizer; seeded weights."""
    from tdm_tpu_torch.models import vae as tvae

    torch.manual_seed(0)
    transformer = tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny(), device="cpu")
    vae = tvae.TAESDDecoder(tvae.TAESDConfig(width=8, num_stages=1, blocks_per_stage=1),
                            device="cpu")
    with torch.no_grad():
        for p in list(transformer.parameters()) + list(vae.parameters()):
            p.copy_(0.2 * torch.randn_like(p))
    kw = {}
    if encoder:
        _, params = jax_t5(1)
        kw = dict(text_encoder=port_t5(params, dtype=torch.bfloat16),
                  tokenizer=ttok.HashTokenizer(128))
    return PixArtPipeline(transformer, vae_decoder=vae, max_text_len=12, device="cpu", **kw)


def _post(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_server_serves_raw_prompts_like_its_build_cache(tmp_path):
    """`--device cpu` with no cache: the bundle's encoder serves raw
    prompts (and the warm-up's ""); the PNG of a (prompt, seed) equals the
    one served, by a copy of the pipeline without its encoder, from the
    cache that the port's build_cache wrote from the bundle. The cache is
    built at --batch_size 1, the shape a request encodes at, since a
    product over more rows may sum in another order."""
    enc_dir, bare_dir = str(tmp_path / "with_t5"), str(tmp_path / "bare")
    save_pretrained(enc_dir, _bundle_pipe(True))
    save_pretrained(bare_dir, _bundle_pipe(False))
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    cache = str(tmp_path / "cache.npz")
    tbuild.main(["--pipeline", enc_dir, "--prompts", str(prompts), "--out", cache,
                 "--max_length", "12", "--batch_size", "1", "--device", "cpu"])
    served = {}
    for name, extra in (("raw", ["--model", enc_dir]),
                        ("cache", ["--model", bare_dir, "--embedding_cache", cache])):
        srv = tserver.build_server(tserver.parse_args(extra + [
            "--device", "cpu", "--port", "0", "--batch_size", "2", "--max_delay_ms", "200",
            "--height", "128", "--width", "128", "--warmup"]))
        srv.start()
        try:
            assert tbatcher.has_encoders(srv.batcher.pipe) == (name == "raw")
            served[name] = [_post(srv.port, {"prompt": p, "seed": 3 + i})
                            for i, p in enumerate(PROMPTS)]
        finally:
            srv.close()
    for raw, cached in zip(served["raw"], served["cache"]):
        assert raw["format"] == "png" and raw["shape"] == [32, 32, 3]
        assert raw["image"] == cached["image"]
    assert len({r["image"] for r in served["raw"]}) == len(PROMPTS)
    assert base64.b64decode(served["raw"][0]["image"])[:8] == b"\x89PNG\r\n\x1a\n"


def test_server_without_encoders_or_cache_refuses(tmp_path):
    bare_dir = str(tmp_path / "bare")
    save_pretrained(bare_dir, _bundle_pipe(False))
    with pytest.raises(ValueError, match="embedding_cache="):
        tserver.build_server(tserver.parse_args(["--model", bare_dir, "--device", "cpu",
                                                 "--port", "0"]))


def test_encoders_without_a_tokenizer_go_to_encode_prompt_as_in_jax(tmp_path):
    """An attached encoder takes every prompt even with a cache given, as
    the JAX make_cond_fn does: with no tokenizer, encode_prompt raises in
    both packages."""
    from tdm_tpu.serve import batcher as jbatcher

    pipe = _bundle_pipe(True)
    pipe.tokenizer = None
    cache = str(tmp_path / "cache.npz")
    tprompts.EmbeddingCache(np.zeros((1, 12, 32), np.float16), np.ones((1, 12), np.int32),
                            ["a fox"]).save(cache)
    assert tbatcher.has_encoders(pipe)
    with pytest.raises(ValueError, match="tokenizer"):
        tbatcher.make_cond_fn(pipe, embedding_cache=cache)("a fox")
    jpipe = types.SimpleNamespace(family="pixart", text_encoder=jt5.T5Encoder(cfg=_jt5_cfg()),
                                  tokenizer=None)
    jpipe.encode_prompt = lambda p: JPixArtPipeline.encode_prompt(jpipe, p)
    with pytest.raises(ValueError, match="tokenizer"):
        jbatcher.make_cond_fn(jpipe, embedding_cache=cache)("a fox")


def _npz(path):
    z = np.load(path, allow_pickle=True)
    return {k: z[k] for k in z.files}


def _assert_caches_close(got, ref, bf16=False):
    """fp32 encoders: each row within one fp16 step; bf16 ones: a relative
    L2 under 1e-2 per array."""
    assert got.keys() == ref.keys()
    for k in ref:
        if ref[k].dtype == object:
            assert [str(x) for x in got[k]] == [str(x) for x in ref[k]], k
        elif ref[k].dtype.kind == "f":
            assert got[k].dtype == ref[k].dtype == np.float16, k
            a, b = got[k].astype(np.float32), ref[k].astype(np.float32)
            if bf16:
                assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), k
            else:
                np.testing.assert_allclose(a, b, rtol=2**-10, atol=1e-5, err_msg=k)
        else:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("family", ["pixart", "sd3"])
def test_build_cache_pipeline_path_matches_jax_cli(tmp_path, family):
    """`--pipeline` on the same tiny pipeline in both CLIs gives the same
    .npz: prompts, masks, the uncond and validation rows, and for SD3 (a
    checkout with tokenizer folders, its encoders at their default bf16)
    the pooled vectors. The PixArt bundle is the JAX package's (fp32 T5,
    a hash tokenizer)."""
    if family == "pixart":
        path = str(tmp_path / "bundle")
        _jax_bundle(path, "pixart")
        extra = ["--max_length", "12"]
    else:
        path = write_encoder_checkout(tmp_path / "sd3", "sd3", tokenizer_dirs=True)
        extra = []
    prompts = tmp_path / "prompts.jsonl"
    prompts.write_text("\n".join(json.dumps({"prompt": p}) for p in PROMPTS))
    argv = ["--pipeline", path, "--prompts", str(prompts), "--batch_size", "3",
            "--validation_prompts", "a photo of a cat", "x"] + extra
    jbuild.main(argv + ["--out", str(tmp_path / "jax.npz")])
    tbuild.main(argv + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    got, ref = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    _assert_caches_close(got, ref, bf16=family == "sd3")
    if family == "sd3":
        assert got["embeds"].shape == (4, 77 + 256, 48) and got["pooled"].shape == (4, 24)
    cache = tprompts.EmbeddingCache.load(str(tmp_path / "port.npz"))
    assert cache.val_prompts == ["a photo of a cat", "x"]
    with pytest.raises(SystemExit):
        tbuild.main(argv + ["--out", str(tmp_path / "bad.npz"), "--device", "cpu",
                            "--family", "sd15"])


def test_build_cache_t5_path_matches_jax_cli(tmp_path):
    """`--t5` on an HF T5 folder (weights + tokenizer) in both CLIs: the
    whole tree at bf16 in both; embeds to a relative L2 of 1e-2."""
    folder = str(tmp_path / "t5")
    cfg = dataclasses.replace(tt5.T5Config(), d_model=32, d_kv=8, num_heads=4, d_ff=64,
                              num_layers=2)
    write_encoder(folder, cfg, seed=31)
    hf_tokenizer_dir(folder)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS))
    argv = ["--t5", folder, "--prompts", str(prompts), "--max_length", "10",
            "--batch_size", "2", "--d_model", "32", "--num_layers", "2", "--num_heads", "4",
            "--d_ff", "64"]
    jbuild.main(argv + ["--out", str(tmp_path / "jax.npz")])
    tbuild.main(argv + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    got, ref = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    assert got.keys() == ref.keys()
    for k in ("masks", "uncond_mask", "val_masks"):
        np.testing.assert_array_equal(got[k], ref[k])
    for k in ("embeds", "uncond_embed", "val_embeds"):
        a, b = got[k].astype(np.float32), ref[k].astype(np.float32)
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), k
    assert [str(p) for p in got["prompts"]] == PROMPTS
    with pytest.raises(SystemExit):
        tbuild.main(["--prompts", str(prompts), "--out", "x.npz", "--device", "cpu"])


def test_chunked_encode_and_build_match_jax():
    """The chunking (empty-string padding, trimmed) and EmbeddingCache.build
    on one tiny fp32 T5, both packages."""
    from tdm_tpu.data import prompts as jprompts

    model, params = jax_t5(6)
    enc = port_t5(params)
    tok, jtk = ttok.HashTokenizer(128), jtok.HashTokenizer(128)
    got = tprompts.EmbeddingCache.build(
        PROMPTS, tok, lambda i, m: enc(torch.from_numpy(i), torch.from_numpy(m)),
        max_length=8, batch_size=3, val_prompts=["x"])
    ref = jprompts.EmbeddingCache.build(
        PROMPTS, jtk, lambda i, m: model.apply({"params": params}, jnp.asarray(i),
                                               jnp.asarray(m)),
        max_length=8, batch_size=3, val_prompts=["x"])
    for k in ("embeds", "masks", "uncond_embed", "uncond_mask", "val_embeds", "val_masks"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=2**-10,
                                   atol=1e-5, err_msg=k)
    seen = []
    e, m, p = tprompts.chunked_encode(
        PROMPTS, lambda c: (seen.append(list(c)) or np.arange(len(c))[:, None],
                            np.ones((len(c), 1)), None), 3)
    assert seen == [PROMPTS[:3], [PROMPTS[3], "", ""]] and e[:, 0].tolist() == [0, 1, 2, 0]
    assert p is None
