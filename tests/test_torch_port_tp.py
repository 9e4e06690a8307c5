"""Megatron tensor parallelism of the port (`tdm_tpu_torch/parallel/tp.py`,
`--tp` in the server, `generate` and the training CLI) on the CPU, in
worlds of gloo processes (`tests/parallel_worker.py`):

* the rule: the port's torch layout (`tp.plan`: column layers cut on dim
  0, row layers on dim 1) against the JAX `tp_spec` of each leaf of every
  family's tiny tree, and the modulation heads kept whole under --fsdp
  against JAX's `tp_fsdp_spec`;
* one 2-rank launch: the forward and every gradient of the tiny PixArt,
  SD3, SD1.5 (GEGLU) and CogVideoX against the JAX unsharded model at JAX's
  tp tolerances (2e-5 forward, 3e-5 gradients, `tests/test_tp.py`); int8
  under 'tp' against one process (1e-4, `tests/test_quant.py`); a LoRA
  student merged whole and then cut; ShardLayout under 'tp';
* one TDM step at tp 2 against the one-process step, the leaves 'tp' does
  not cut equal bit for bit across the ranks;
* `train_tdm.main(["--tp", "2", "--fsdp", "2", "--quant_forwards", ...])`
  on 4 ranks writes metrics and `student.safetensors` (as
  `tests/test_tp.py`'s CLI test), and a LoRA student at tp 2 x fsdp 2; the
  checkpoint is the one-process layout and resumes in one process;
* the server and `generate` with `--tp 2 --device cpu` (the follower
  started by rank 0) against `--tp 1`; their refusals with the JAX CLIs'
  messages."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import parallel_worker
from test_torch_port_recipe import _nest
from test_torch_port_train import ADAM_EPS, LR, _update_close
from tdm_tpu.cli import generate as jgenerate
from tdm_tpu.parallel import mesh as jmesh, tp as jtp
from tdm_tpu.train import families as jfamilies
from tdm_tpu_torch.cli import generate as tgenerate, train_tdm
from tdm_tpu_torch.io import from_jax, params as tparams
from tdm_tpu_torch.parallel import tp as ttp
from tdm_tpu_torch.serve import server as tserver
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm

torch.set_num_threads(2)

FAMILIES = ("pixart", "sd3", "sd15", "cogvideox")
BATCH = 2


def _inputs(family: str, jb, rng) -> tuple:
    """One forward's numpy inputs of a family's tiny model, in the
    models' own call order."""
    x = rng.standard_normal((BATCH, *jb.sample_shape)).astype(np.float32)
    t = np.array([10.0, 500.0], np.float32)
    text = rng.standard_normal((BATCH, jb.seq_len, jb.embed_dim)).astype(np.float32)
    mask = np.ones((BATCH, jb.seq_len), np.int32)
    mask[1, 3:] = 0
    if family == "sd3":
        return x, t, text, rng.standard_normal((BATCH, 24)).astype(np.float32)
    if family == "cogvideox":
        return x, t, text
    return x, t, text, mask


@pytest.fixture(scope="module")
def trees():
    """Each family's tiny JAX bundle, the port's bundle, seeded weights (the
    port's init, every leaf moved off it by 5%: zero-init gates would hide
    a wiring fault) and those weights carried into the JAX tree
    (`io/from_jax.jax_layout`)."""
    out = {}
    for i, fam in enumerate(FAMILIES):
        tb = tfamilies.build(fam, tiny=True, seed=i, device="cpu")
        gen = torch.Generator().manual_seed(40 + i)
        sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
              for k, v in tb.init_params().items()}
        flat = from_jax.jax_layout(sd, stacks=from_jax.layer_stacks(tb.model.cfg))
        out[fam] = (jfamilies.build(fam, tiny=True), tb, sd, _nest(flat))
    return out


@pytest.mark.parametrize("fam", FAMILIES)
def test_tp_rules_match_jax_leaf_by_leaf(trees, fam):
    """The port's torch layout at tp 2 (`tp.plan`) cuts exactly the leaves
    JAX's `tp_spec` cuts, on the matching dim ([in, out] kernels against
    [out, in] weights), and the leaves the port keeps whole under --fsdp as
    modulation heads (`tp.is_modulation_head`) are exactly those JAX's
    `tp_fsdp_spec` keeps replicated where its plain fsdp rule would shard
    them (tp 2 and 4, fsdp 2, a lowered size gate). The SD1.5 UNet's 1x1
    spatial proj_in/proj_out stay replicated."""
    _, tb, sd, _ = trees[fam]
    stacks = from_jax.layer_stacks(tb.model.cfg)
    flat = from_jax.jax_layout(sd, stacks=stacks)
    heads = 0
    for path, leaf in flat.items():
        names = ("student", *path.split("/"))
        shape = tuple(leaf.shape)
        for n in (2, 4):
            jspec = tuple(jtp.tp_fsdp_spec(names, shape, n, 2, min_size=64))
            if ttp.is_modulation_head(path):
                assert jspec == (), (path, n)
            elif jmesh.fsdp_spec(shape, 2, min_size=64) or jtp.tp_spec(names, shape, n):
                assert jspec != (), (path, n)  # JAX shards it: not a head it holds
        heads += ttp.is_modulation_head(path)
    assert heads or fam in ("sd15", "cogvideox")  # PixArt: t_block; SD3: norm_out
    want = {}
    for key in sd:
        path, layer = from_jax.jax_name(key, stacks)
        spec = tuple(jtp.tp_spec(("params", *path.split("/")), tuple(flat[path].shape), 2))
        if layer is not None and spec:
            spec = spec[1:]  # a stacked leaf's layer axis
        if "tp" in spec:  # [in, out] kernel or [out] bias → the port's [out, in] dim
            want[key] = len(spec) - 1 - spec.index("tp")
    layout = ttp.plan(tb.model, 2)
    assert {k: c.dim for k, c in layout.items()} == want
    assert len(want) >= 10
    if fam == "sd15":
        spatial = [k for k in sd if k.endswith(("proj_in.weight", "proj_out.weight"))
                   and ".ff." not in k]
        assert spatial and not set(spatial) & set(want)
        assert any(c.halves == 2 for c in layout.values())  # GEGLU's proj_in


def test_tp_world_matches_jax(tmp_path, trees):
    """One 2-rank launch (`parallel_worker.job_tp`): each family's forward
    and gradients against the JAX unsharded model's (jitted, on the carried
    weights), int8 under 'tp', a LoRA student and ShardLayout under 'tp'."""
    cases = {}
    for fam in FAMILIES:
        jb, tb, sd, jparams = trees[fam]
        inputs = _inputs(fam, jb, np.random.default_rng(7))

        def loss(p, inputs=inputs, jb=jb):
            out = jb.model.apply({"params": p}, *inputs)
            return jnp.mean(out ** 2), out

        (_, out), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
        port_out = functional_call(tb.model, sd, tuple(torch.from_numpy(a) for a in inputs))
        np.testing.assert_allclose(port_out.numpy(), np.asarray(out), atol=2e-5, err_msg=fam)
        cases[fam] = {
            "params": sd, "inputs": tuple(torch.from_numpy(a) for a in inputs),
            "out": np.asarray(out),
            "grads": from_jax.state_dict_from_jax(from_jax.flatten_tree(jgrads), tb.model)}
    path = tmp_path / "inputs.pt"
    torch.save({"families": cases}, path)
    outs = parallel_worker.launch("tp", {"inputs": str(path)}, 2, tmp_path, timeout=200)
    for r, o in enumerate(outs):
        for check in (*FAMILIES, "int8", "lora", "layout"):
            assert f"{check} ok {r}" in o, o[-2000:]


def test_tp_step_matches_one_process(tmp_path):
    """One dmd step (two critic updates, Huber, the EMA) at tp 2 against
    the same step in one process: the metrics to 1e-4 relative (the bound of
    `tests/test_torch_port_parallel.py`'s 2-rank step), each role's update
    within `_update_close`'s bounds, the EMA to 1e-6; the leaves
    'tp' does not cut equal bit for bit across the ranks (in the worker)."""
    tb = tfamilies.build("pixart", tiny=True, device="cpu")
    teacher = {k: v.clone() for k, v in tb.init_params().items()}
    gen = torch.Generator().manual_seed(5)
    student = {k: v * (1 + 0.05 * torch.randn(v.shape, generator=gen)) for k, v in teacher.items()}
    config = ttdm.TDMConfig(loss_mode="dmd", critic_updates=2, use_huber=True)
    tx = topt.make_optimizer(LR, eps=ADAM_EPS)
    state = ttdm.init_state(student, teacher, tx, tx, use_ema=True)
    rng = np.random.default_rng(21)
    text = torch.from_numpy(rng.standard_normal((4, 8, tb.embed_dim)).astype(np.float32))
    mask = torch.ones((4, 8), dtype=torch.int32)
    mask[1, 5:] = 0
    cond, uncond = (text, mask), (torch.zeros_like(text), torch.ones_like(mask))
    draws = ttdm.make_draws(config, 4, tb.sample_shape, torch.Generator().manual_seed(9), "cpu")
    inputs, out = tmp_path / "inputs.pt", tmp_path / "out.pt"
    torch.save({"state": state, "teacher": teacher, "lr": LR, "eps": ADAM_EPS,
                "config": {"loss_mode": "dmd", "critic_updates": 2, "use_huber": True},
                "draws": draws, "cond": cond, "uncond": uncond}, inputs)
    before = {role: {k: v.clone() for k, v in getattr(state, role).items()}
              for role in ("student", "critic")}
    step = ttdm.build_train_step(tb.denoise_fn, teacher, tb.schedule, config, tx, tx,
                                 sample_shape=tb.sample_shape)
    ref, metrics = step(state, draws, cond, uncond)
    parallel_worker.launch("step", {"inputs": str(inputs), "out": str(out), "fsdp": 1, "tp": 2},
                           2, tmp_path)
    got = torch.load(out, weights_only=False)
    for name in ttdm.StepMetrics._fields:
        assert got["metrics"][name] == pytest.approx(float(getattr(metrics, name)), rel=1e-4,
                                                     abs=1e-7), name
    new = got["state"]
    for k, v in ref.ema.items():
        torch.testing.assert_close(new.ema[k], v, rtol=0, atol=1e-6)
    for role in ("student", "critic"):
        assert {k: v.shape for k, v in getattr(new, role).items()} == {
            k: v.shape for k, v in getattr(ref, role).items()}
        _update_close(before[role], getattr(ref, role), getattr(new, role), role)


def test_tp_cli_on_four_ranks(tmp_path, monkeypatch):
    """`--tp 2 --fsdp 2 --quant_forwards --use_ema` and a LoRA student at
    tp 2 x fsdp 2, 2 steps each on 4 ranks: metrics, checkpoints and
    `student.safetensors` written by process 0; the checkpoint (the
    one-process layout) resumes in one process for a third step."""
    common = ["--device", "cpu", "--max_train_steps", "2", "--checkpointing_steps", "2",
              "--validation_steps", "100", "--export_lora_rank", "0", "--tp", "2",
              "--fsdp", "2"]
    full = tmp_path / "full"
    lora = tmp_path / "lora"
    argvs = [[*common, "--output_dir", str(full), "--quant_forwards", "--use_ema"],
             [*common, "--output_dir", str(lora), "--train_lora_rank", "4"]]
    parallel_worker.launch("cli_runs", {"argvs": argvs, "shard_min": 512}, 4, tmp_path,
                           env={"TDM_TINY_MODEL": "1"}, timeout=200)
    for run in (full, lora):
        out = next(run.parent.glob(run.name + "*"))
        lines = [json.loads(x) for x in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        assert [m["step"] for m in lines if "loss_student" in m] == [1]
        assert all(np.isfinite(m["loss_student"]) for m in lines if "loss_student" in m)
        assert (out / "student.safetensors").exists() and (out / "checkpoint-2").exists()
    saved = tparams.load_file(str(next(tmp_path.glob("full*")) / "student.safetensors"))
    model = tfamilies.build("pixart", tiny=True, device="cpu").model
    want = from_jax.jax_layout({k: p.detach() for k, p in model.named_parameters()})
    assert {k: tuple(v.shape) for k, v in saved.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    train_tdm.main([*common[:2], "--max_train_steps", "3", "--validation_steps", "100",
                    "--export_lora_rank", "0", "--output_dir", str(full), "--quant_forwards",
                    "--use_ema", "--resume_from_checkpoint", "latest"])
    assert (next(tmp_path.glob("full*")) / "checkpoint-3").exists()


def test_tp_cli_checks(tmp_path, monkeypatch):
    """The JAX CLI's "does not divide" (--tp 3 --fsdp 3 at world 1, its
    message), --sp with --tp, and --tp with 8-bit Adam (slice 6)."""
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    base = ["--device", "cpu", "--output_dir", str(tmp_path / "run")]
    with pytest.raises(ValueError, match=r"--fsdp 3 x --tp 3 x --pp 1 x --ep 1 x --sp 1 "
                                         r"does not divide 1 devices"):
        train_tdm.main([*base, "--tp", "3", "--fsdp", "3"])
    with pytest.raises(ValueError, match=r"tp/pp/ep x sp is unsupported"):
        train_tdm.main([*base, "--tp", "2", "--sp", "2", "--model_family", "cogvideox"])
    with pytest.raises(NotImplementedError, match="slice 6"):
        train_tdm.main([*base, "--tp", "2", "--use_8bit_adam"])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny PixArt pipeline in the tdm_tpu layout and an embedding cache
    of PROMPTS (`tests/test_torch_port_parallel_serve.py`'s)."""
    from test_torch_port_parallel_serve import PROMPTS, _pipe

    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.pipelines import save_pretrained

    root = tmp_path_factory.mktemp("tp")
    pipe, _ = _pipe("pixart")
    save_pretrained(str(root / "pipe"), pipe)
    rng = np.random.default_rng(11)
    EmbeddingCache(rng.standard_normal((4, 8, 32)).astype(np.float16),
                   (np.arange(8)[None] < np.array([[8], [3], [5], [2]])).astype(np.int32),
                   PROMPTS).save(str(root / "cache.npz"))
    return str(root / "pipe"), str(root / "cache.npz")


def _serve(served, *flags):
    model, cache = served
    args = tserver.parse_args(["--model", model, "--embedding_cache", cache, "--device", "cpu",
                               "--port", "0", "--batch_size", "4", "--max_delay_ms", "3000",
                               "--height", "128", "--width", "128", *flags])
    server = tserver.build_server(args).start()
    try:
        from test_torch_port_parallel_serve import PROMPTS

        futures = [server.batcher.submit(p, seed=7 + i) for i, p in enumerate(PROMPTS)]
        results = [f.result(timeout=300) for f in futures]
        return server.batcher.pipe.tensor_parallel, results
    finally:
        server.close()


def test_tp_server_and_generate_answer_as_one_process(served, tmp_path):
    """`--tp 2 --device cpu`: the server starts its follower, answers a
    batch of 4 as the `--tp 1` server does (to 1e-5), and stops it on
    close; `generate --tp 2` writes the `--tp 1` latents (to 1e-5)."""
    tp, two = _serve(served, "--tp", "2")
    assert tp is not None and tp.n == 2 and tp.index == 0
    none, one = _serve(served, "--tp", "1")
    assert none is None
    for a, b in zip(two, one):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    model, cache = served
    lat = {}
    for n in ("2", "1"):
        path = str(tmp_path / f"tp{n}.npy")
        tgenerate.main(["--model", model, "--embedding_cache", cache, "--prompt", "a cat",
                        "a dog", "--num_inference_steps", "2", "--seed", "3", "--height", "128",
                        "--width", "128", "--output_type", "latent", "--output", path,
                        "--device", "cpu", "--tp", n])
        lat[n] = np.load(path)
    np.testing.assert_allclose(lat["2"], lat["1"], atol=1e-5)


def test_generate_tp_refusals_match_jax_cli(served, tmp_path, monkeypatch):
    """`--tp 3` on the tiny PixArt (2 heads, FF 128) shards nothing: the
    JAX CLI's SystemExit, word for word; on CUDA, --tp above the visible
    GPUs: its "only M local devices"."""
    model, cache = served
    args = ["--model", model, "--embedding_cache", cache, "--prompt", "a cat",
            "--output", str(tmp_path / "x.png"), "--tp", "3"]
    with pytest.raises(SystemExit) as jerr:
        jgenerate.main(args)
    with pytest.raises(SystemExit) as terr:
        tgenerate.main([*args, "--device", "cpu"])
    assert str(terr.value) == str(jerr.value) and "shards nothing" in str(terr.value)
    from tdm_tpu_torch import device as tdevice

    monkeypatch.setattr(tdevice, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--tp 3: only 1 local devices"):
        tgenerate.main(args)


def test_tp_server_rules(monkeypatch):
    """--tp and --dp: the JAX server's SystemExit first; on CUDA --tp above
    the visible GPUs raises before any model loads."""
    args = tserver.parse_args(["--model", "unused", "--device", "cpu", "--tp", "2", "--dp", "2"])
    with pytest.raises(SystemExit, match="--tp and --dp are mutually exclusive"):
        tserver.build_server(args)
    from tdm_tpu_torch import device as tdevice

    monkeypatch.setattr(tdevice, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = tserver.parse_args(["--model", "unused", "--tp", "2"])
    with pytest.raises(ValueError, match="--tp 2 needs 2 CUDA devices; 1 visible"):
        tserver.build_server(args)


def test_pipeline_tp_and_dp_are_exclusive():
    """The pipeline's two parallel states refuse each other with the JAX
    package's message."""
    from test_torch_port_parallel_serve import _pipe

    pipe, _ = _pipe("pixart")
    pipe.data_parallel_devices = [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="mutually exclusive"):
        pipe.tensor_parallel = ttp.TPGroup(1)
    pipe.data_parallel_devices = None
    pipe.tensor_parallel = ttp.TPGroup(1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pipe.data_parallel_devices = [torch.device("cpu")] * 2
