"""The training recipe's own flags in the port against the JAX package on the
CPU: the blockwise-int8 Adam moments (`adam8bit`), gradient accumulation
(optax.MultiSteps), the truncated-SVD LoRA export (`extract_lora`), the LoRA
student's merge, and the training CLI at the JAX CLI's default flags and in
LoRA mode with 8-bit Adam and accumulation.

Inputs come from numpy seeds and pass between the packages as numpy arrays.
The int8 codes are integers of the same fp32 formulas on both sides, so they
agree exactly unless a value lands within roundoff of a rounding boundary;
the tolerances below say where fp32 roundoff in another order enters.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdm_tpu.lora import adapter as jlora, io as jlora_io
from tdm_tpu.train import families as jfamilies, optim as jopt
from tdm_tpu_torch import lora as tlora
from tdm_tpu_torch.io import from_jax, params as tparams
from tdm_tpu_torch.models import pixart as tpixart
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm
from tdm_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX's buffers are read-only)


def _nest(flat):
    """A flat '/'-joined dict → the nested tree the JAX package's LoRA
    functions walk."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# --- the int8 moments ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 255, 4096, 4097, 3 * 256 + 7])
def test_q8_quantize_and_dequantize_match_jax(n):
    """Codes and scales equal JAX's bit for bit, and so does the decode, for
    sizes below, at and across the 256-element block, with an all-zero
    block (the first block of every size above 256; the single element)."""
    rng = np.random.default_rng(20 + n)
    x = (rng.standard_normal(n) * np.logspace(-3, 1, n)).astype(np.float32)
    if n == 1 or n > 256:
        x[: min(n, 256)] = 0.0
    jq = jopt._q8_quantize(jnp.asarray(x))
    tq = topt.q8_quantize(_t(x))
    assert tq.values.dtype == torch.int8 and tq.values.numel() == -(-n // 256) * 256
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert float(tq.scales[0]) == (0.0 if n == 1 or n > 256 else float(np.abs(x).max()))
    np.testing.assert_array_equal(topt.q8_dequantize(tq, x.shape).numpy(),
                                  np.asarray(jopt._q8_dequantize(jq, x.shape)))


def _moments_agree(tq, jq):
    """Codes on ≥ 99.9% of entries and at most 1 apart elsewhere; scales to
    1e-6 relative."""
    got, want = tq.values.numpy().astype(int), np.asarray(jq.values).astype(int)
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.999
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales), rtol=1e-6, atol=0)


def _tree(rng):
    """Leaves under the size gate (fp32 moments) between quantized ones of
    5600 (22 blocks, the last padded), 4100, 4096 and 14000 elements. With
    `_SLICED` the update runs over slices of 40 blocks: the first holds the
    5600 and 4100 leaves, the second the 4096 one, the 14000 leaf is larger
    than a slice and stands alone, and the small leaves share one slice."""
    shapes = {"w": (70, 80), "t": (33,), "x": (4100,), "y": (64, 64), "s": (4, 25),
              "big": (70, 200)}
    return {k: rng.standard_normal(shape).astype(np.float32) for k, shape in shapes.items()}


_SLICED = 40 * 256


@pytest.mark.parametrize("slice_size", [None, _SLICED], ids=["one_slice", "sliced"])
def test_adam8bit_matches_jax_over_three_steps(slice_size, monkeypatch):
    """Three updates of a tree of quantized leaves and leaves under the size
    gate (`_tree`), packed in one slice or cut into several: the updated
    parameters to 1e-5 relative L2, every quantized leaf's codes and scales
    in both moments as `_moments_agree` says (from the second step on they
    are updated from stored codes), the small leaves' moments to 1e-6; the
    moments stay int8 and the LR is read at the incremented count (a
    warmup's first step moves)."""
    if slice_size is not None:
        monkeypatch.setattr(topt, "_SLICE", slice_size)
    rng = np.random.default_rng(21)
    params = _tree(rng)
    spans = topt._layout({k: _t(v) for k, v in params.items()})[0]
    assert len(spans) == (2 if slice_size is None else 4)
    kw = dict(warmup_steps=2, total_steps=10)
    jtx = jopt.adam8bit(jopt.make_lr_schedule("cosine_with_restarts", 1e-2, **kw))
    ttx = topt.adam8bit(topt.make_lr_schedule("cosine_with_restarts", 1e-2, **kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i, scale in enumerate((0.1, 3.0, 0.5)):
        g = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update({k: _t(v) for k, v in g.items()}, tstate, tp)
        topt.apply_updates(tp, tu)
        assert tstate.count == int(jstate.count) == i + 1
        for k in params:
            ref = np.asarray(jp[k])
            assert np.linalg.norm(tp[k].numpy() - ref) <= 1e-5 * np.linalg.norm(ref), (i, k)
        assert not np.array_equal(tp["w"].numpy(), params["w"])  # lr(1) > 0 moved it
        assert tstate.mu.codes.dtype == torch.int8 and tstate.nu.codes.dtype == torch.int8
        for moment, jm in (("mu", jstate.mu), ("nu", jstate.nu)):
            views = topt.leaf_moments(getattr(tstate, moment), tp)
            for k in ("w", "x", "y", "big"):
                _moments_agree(views[k], jm[k])
            for k in ("t", "s"):
                np.testing.assert_allclose(views[k].numpy(), np.asarray(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("eight_bit", [False, True])
def test_accumulation_matches_optax_multisteps(eight_bit, monkeypatch):
    """N = 3 over seven micro-steps with gradients large enough to clip, on
    `_tree` (8-bit: in slices of 40 blocks): inside a window the update is
    None and the parameters keep their bits exactly (a −0.0 entry too);
    after each window they agree with optax.MultiSteps to 1e-6 relative
    (the second window's 8-bit update reads stored codes); mini_step and
    gradient_step advance as optax's."""
    monkeypatch.setattr(topt, "_SLICE", _SLICED)
    rng = np.random.default_rng(22)
    params = _tree(rng)
    params["t"][0] = -0.0
    jtx = jopt.make_optimizer(1e-2, eight_bit=eight_bit, accumulation_steps=3)
    ttx = topt.make_optimizer(1e-2, eight_bit=eight_bit, accumulation_steps=3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(7):
        g = {k: (10.0 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
        assert float(topt.global_norm({k: _t(v) for k, v in g.items()})) > 1.0  # clipped
        before = {k: v.clone() for k, v in tp.items()}
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update({k: _t(v) for k, v in g.items()}, tstate, tp)
        topt.apply_updates(tp, tu)
        assert (tstate.mini_step, tstate.gradient_step) == (
            int(jstate.mini_step), int(jstate.gradient_step))
        if (i + 1) % 3:
            assert tu is None
            for k in tp:
                assert torch.equal(tp[k].view(torch.int32), before[k].view(torch.int32)), (i, k)
        else:
            for k in tp:
                assert not torch.equal(tp[k], before[k])
                ref = np.asarray(jp[k])
                assert np.linalg.norm(tp[k].numpy() - ref) <= 1e-6 * np.linalg.norm(ref), (i, k)
    assert tstate.gradient_step == 2 and tstate.mini_step == 1


# --- the LoRA export and the LoRA student --------------------------------------


def _tiny_model(scan_layers):
    cfg = dataclasses.replace(tpixart.PixArtConfig.tiny(), scan_layers=scan_layers)
    torch.manual_seed(0)
    return tpixart.PixArtTransformer2D(cfg, device="cpu", param_dtype=torch.float32)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_extract_lora_matches_jax(scan_layers):
    """The rank-4 export of a finetune whose deltas are rank 6 with separated
    singular values plus noise: the same entries and alphas as the JAX
    package's on the same weights, and each layer's a@b within 1e-5
    relative (SVD signs are free, the product is not); a stacked tree keeps
    its [L] axis, an unrolled one an entry per layer."""
    model = _tiny_model(scan_layers)
    base = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(23)
    tuned = {}
    for k, w in base.items():
        if w.dim() == 2:
            o, i = w.shape
            u, v = rng.standard_normal((o, 6)), rng.standard_normal((6, i))
            d = (u * np.array([8, 6, 4, 3, 2, 1.5])) @ v + 0.01 * rng.standard_normal((o, i))
            tuned[k] = w + 1e-3 * _t(d.astype(np.float32))
        else:
            tuned[k] = w.clone()
    got = tlora.extract_lora(model, base, tuned, 4)
    stacks = from_jax.layer_stacks(model.cfg)
    jbase = _nest(from_jax.jax_layout(base, stacks=stacks))
    jtuned = _nest(from_jax.jax_layout(tuned, stacks=stacks))
    want = jlora.extract_lora(jbase, jtuned, 4)
    wflat = {jlora.path_str(p): e for p, e in jlora._flatten(want.params).items()}
    assert set(got.params) == set(wflat)
    assert dict(got.alpha) == dict(want.alpha) and set(dict(got.alpha).values()) == {4.0}
    for mpath, entry in got.params.items():
        a, b = entry["a"].numpy(), entry["b"].numpy()
        assert a.shape == np.shape(wflat[mpath]["a"]) and b.shape == np.shape(wflat[mpath]["b"])
        assert (a.ndim == 3) == (scan_layers and mpath.startswith("blocks/"))
        prod, ref = a @ b, np.asarray(wflat[mpath]["a"]) @ np.asarray(wflat[mpath]["b"])
        assert np.linalg.norm(prod - ref) <= 1e-5 * np.linalg.norm(ref), mpath


def test_lora_student_gradients_reach_only_the_factors():
    """The LoRA student's forward (`wrap_denoise_fn`) against the JAX one
    from the same factors (b drawn nonzero, so both factors get a
    gradient): the loss to 1e-5, the factors' gradients to 1e-4 relative
    L2; the base gets no gradient, and the serving merge records none."""
    jb = jfamilies.build("pixart", tiny=True)
    tb = tfamilies.build("pixart", tiny=True, device="cpu")
    teacher = jb.init_params(jax.random.PRNGKey(0))
    template = jlora.init_lora(teacher, jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(24)
    flat = {k: np.asarray(v) for k, v in from_jax.flatten_tree(template.params).items()}
    for k in flat:
        if k.endswith("/b"):
            flat[k] = (0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    x = rng.standard_normal((2, *jb.sample_shape)).astype(np.float32)
    t = np.array([300, 700])
    text = rng.standard_normal((2, 8, jb.embed_dim)).astype(np.float32)
    mask = np.ones((2, 8), np.int32)

    jfn = jlora.wrap_denoise_fn(jb.denoise_fn, template)

    def jloss(lp):
        return jnp.mean(jfn(lp, jnp.asarray(x), jnp.asarray(t),
                            (jnp.asarray(text), jnp.asarray(mask)), teacher) ** 2)

    jl, jg = jax.value_and_grad(jloss)(_nest({k: jnp.asarray(v) for k, v in flat.items()}))
    jg = from_jax.flatten_tree(jg)

    base = {k: v.requires_grad_(True) for k, v in from_jax.state_dict_from_jax(
        from_jax.flatten_tree(teacher), tb.model).items()}
    factors = {k: _t(v).requires_grad_(True) for k, v in flat.items()}
    tfn = tlora.wrap_denoise_fn(tb.denoise_fn, tlora.LoRA(params={}, alpha=template.alpha),
                                stacks=from_jax.layer_stacks(tb.model.cfg))
    loss = (tfn(factors, _t(x), _t(t), (_t(text), _t(mask)), base) ** 2).mean()
    grads = torch.autograd.grad(loss, list(factors.values()) + list(base.values()),
                                allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert all(g is None for g in grads[len(factors):])
    for (k, _), g in zip(factors.items(), grads):
        ref = np.asarray(jg[k])
        assert np.linalg.norm(ref) > 0, k
        assert np.linalg.norm(g.numpy() - ref) <= 1e-4 * np.linalg.norm(ref), k
    served = tlora.merge(base, tlora.from_factors(factors, template.alpha), 1.0,
                         from_jax.layer_stacks(tb.model.cfg))
    assert not any(v.requires_grad for k, v in served.items() if k.endswith("to_q.weight"))


# --- the training CLI -------------------------------------------------------------


def _cli(tmp_path, *extra):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(["--device", "cpu", "--output_dir", str(tmp_path / "run"),
                    "--seed", "0", "--train_batch_size", "2", *extra])
    return tmp_path / "run_cfg4.5_steps900"


@pytest.fixture
def tiny_env(monkeypatch):
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    monkeypatch.delenv("TDM_TAESD_DIR", raising=False)


def test_cli_default_flags_export_the_jax_packages_lora(tmp_path, tiny_env):
    """The JAX CLI's default invocation (--export_lora_rank 32, no flag
    given): tdm_tpu_torch.cli.train_tdm writes student.safetensors and
    tdm_lora.safetensors, whose keys equal those of the JAX package's
    save_kohya(extract_lora(teacher, student, 32)) on the same fp32 weights
    and whose up·down products agree per layer to 1e-4 relative (both files
    hold fp16 factors of the same SVD)."""
    out = _cli(tmp_path, "--max_train_steps", "2", "--lr_warmup_steps", "0",
               "--learning_rate", "1e-3")
    assert (out / "student.safetensors").exists()
    teacher = tfamilies.build("pixart", tiny=True, seed=0, device="cpu").init_params()
    student = {k: torch.from_numpy(v) for k, v in tparams.load_file(
        str(out / "checkpoint-2" / "student.safetensors")).items()}
    stacks = from_jax.layer_stacks(tpixart.PixArtConfig.tiny())
    ref_path = str(tmp_path / "jax_lora.safetensors")
    jlora_io.save_kohya(
        jlora.extract_lora(_nest(from_jax.jax_layout(teacher, stacks=stacks)),
                           _nest(from_jax.jax_layout(student, stacks=stacks)), 32),
        ref_path, prefix="lora_transformer")
    got = tparams.load_file(str(out / "tdm_lora.safetensors"))
    want = tparams.load_file(ref_path)
    assert set(got) == set(want)
    assert any(k.startswith("lora_transformer_blocks_1_attn2_to_q.") for k in got)
    for key in (k for k in want if k.endswith(".lora_up.weight")):
        down = key.replace(".lora_up.", ".lora_down.")
        prod = got[key].astype(np.float64) @ got[down].astype(np.float64)
        ref = want[key].astype(np.float64) @ want[down].astype(np.float64)
        assert np.linalg.norm(ref) > 0, key
        assert np.linalg.norm(prod - ref) <= 1e-4 * np.linalg.norm(ref), key
        np.testing.assert_array_equal(got[key.replace(".lora_up.weight", ".alpha")],
                                      want[key.replace(".lora_up.weight", ".alpha")])


def test_cli_lora_8bit_accumulation_trains_checkpoints_resumes_and_exports(tmp_path, tiny_env):
    """--train_lora_rank 4 --use_8bit_adam --gradient_accumulation_steps 2:
    two optimizer steps of two micro-steps each, a checkpoint at each step
    boundary holding the factors, the int8 moments and the accumulation
    counters; a restore into a fresh state writes the same checkpoint back
    byte for byte; a resume with nothing left to run exports the same
    adapter; the exported kohya file holds rank-4 factors of every default
    target, and the merged student."""
    flags = ["--train_lora_rank", "4", "--use_8bit_adam", "--gradient_accumulation_steps",
             "2", "--checkpointing_steps", "1", "--lr_warmup_steps", "0"]
    out = _cli(tmp_path, "--max_train_steps", "2", *flags)
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("checkpoint")) == [
        "checkpoint-1", "checkpoint-2"]
    meta = json.loads((out / "checkpoint-2" / "state.json").read_text())
    assert meta == {"step": 2, "ema": False, **{
        f"{r}_{k}": v for r in ("student", "critic")
        for k, v in (("mini_step", 0), ("gradient_step", 2), ("inner_count", 2))}}
    ckpt = out / "checkpoint-2"
    critic_opt = tparams.load_file(str(ckpt / "critic_opt.safetensors"))
    assert critic_opt["inner/mu/codes"].dtype == np.int8
    assert critic_opt["inner/nu/codes"].dtype == np.int8
    assert np.abs(critic_opt["inner/nu/codes"]).max() > 0
    assert not np.any(critic_opt["acc/blocks.0.attn1.to_q.weight"])  # reset at the boundary
    student = tparams.load_file(str(ckpt / "student.safetensors"))
    model = tfamilies.build("pixart", tiny=True, device="cpu").model
    template = tlora.init_lora(model, 4)
    assert set(student) == set(tlora.factors(template))
    assert any(np.any(student[k]) for k in student if k.endswith("/b"))  # b left zero

    # restore into a fresh state of the run's shape and write it back
    tx = topt.make_optimizer(1e-4, eight_bit=True, accumulation_steps=2)
    fresh = ttdm.init_state(
        {k: torch.zeros_like(v) for k, v in tlora.factors(template).items()},
        {k: torch.zeros_like(v) for k, v in model.state_dict().items()}, tx, tx)
    restored = tckpt.CheckpointManager(str(out)).restore(fresh)
    assert restored.critic_opt.inner.count == 2 and restored.student_opt.gradient_step == 2
    tckpt.CheckpointManager(str(tmp_path / "copy")).save(2, restored)
    for f in ckpt.iterdir():
        assert (tmp_path / "copy" / "checkpoint-2" / f.name).read_bytes() == f.read_bytes(), f

    lora_bytes = (out / "tdm_lora.safetensors").read_bytes()
    shutil.copy(out / "student.safetensors", tmp_path / "student_first.safetensors")
    _cli(tmp_path, "--max_train_steps", "2", *flags, "--resume_from_checkpoint", "latest")
    assert (out / "tdm_lora.safetensors").read_bytes() == lora_bytes
    assert (out / "student.safetensors").read_bytes() == (
        tmp_path / "student_first.safetensors").read_bytes()

    lora = tlora.load_lora(str(out / "tdm_lora.safetensors"), model=model)
    assert set(lora.params) == set(template.params)
    assert all(e["a"].shape[-1] == 4 and e["b"].shape[-2] == 4 for e in lora.params.values())
    merged = tparams.load_file(str(out / "student.safetensors"))
    assert merged["blocks/attn1/to_q/kernel"].dtype == np.float16
