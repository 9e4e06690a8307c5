"""Ring attention of the port (`tdm_tpu_torch/ops/ring_attention.py`)
against the JAX package's flash-hop ring on the CPU, and on the card
against its plain run.

* One launch of 4 gloo processes (`tests/parallel_worker.py`, job
  `ring`): rings of n = 1, 2 and 4 ranks (a mesh of 4/n 'data' by n 'sp'
  ranks), each against `tdm_tpu.ops.ring_attention(impl="pallas",
  interpret=True)` under shard_map with check_vma=False on n of the 8 CPU
  devices, as `tests/test_ring_attention.py:116-143` runs it: ragged key
  masks that cross shard boundaries, a batch row whose keys and prefix are
  all masked (its output exactly 0), the replicated prefix with a ragged
  prefix mask, and the gradients of q, k, v and the prefix under a seeded
  cotangent. The JAX references are computed in this process and handed
  over with torch.save. fp32 throughout: the plain hops of the port and
  JAX's interpreted kernels sum in other orders, so each output and
  gradient is held at 5e-5 absolute and relative (the JAX ring tests'
  gradient bound; measured ~1e-6). The worker also counts the permutes:
  n − 1 in the forward and n in the backward (none at n = 1).
* The 'splash' route raises the JAX ValueError, word for word.
* On the card (`cuda`): the kernels' ring in a world of one with the
  prefix (two hops: the merge and the merged-lse backward, no permute)
  against `plain_ring_attention`, bf16. This file imports JAX only inside
  its CPU tests, so the card test runs with `python -m pytest --noconftest
  tests/test_torch_port_ring.py -m cuda` where JAX is absent."""

import numpy as np
import pytest
import torch

import parallel_worker
from tdm_tpu_torch.ops import attention as tattn, ring_attention as tring
from tdm_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

B, H, S, D, S_P = 2, 2, 32, 16, 8
TOL = 5e-5


def _jax_ring(n, q, k, v, mask, k_p, v_p, prefix_mask, g):
    """The JAX flash-hop ring on n CPU devices: its output and the
    gradients of sum(out·g) in q, k, v (and the prefix)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from tdm_tpu.ops.ring_attention import ring_attention

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    seq = P(None, None, "sp", None)
    has_prefix = k_p is not None

    def ring_fn(q, k, v, *prefix):
        def local(q, k, v, m, *pre):
            kw = {}
            if has_prefix:
                kw = dict(prefix_kv=(pre[0], pre[1]), prefix_mask=pre[2])
            return ring_attention(q, k, v, axis_name="sp", key_mask=m, impl="pallas",
                                  interpret=True, **kw)

        specs = (seq, seq, seq, P(None, "sp")) + ((P(), P(), P()) if has_prefix else ())
        return shard_map(local, mesh=mesh, in_specs=specs, out_specs=seq,
                         check_vma=False)(q, k, v, jnp.asarray(mask), *prefix)

    args = [jnp.asarray(a) for a in (q, k, v)]
    if has_prefix:
        args += [jnp.asarray(k_p), jnp.asarray(v_p)]

    def loss(*a):
        extra = (jnp.asarray(prefix_mask),) if has_prefix else ()
        return jnp.sum(ring_fn(*a, *extra) * g)

    out = ring_fn(*args, *((jnp.asarray(prefix_mask),) if has_prefix else ()))
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _case(seed, n, impl, prefix):
    """Seeded fp32 inputs: batch row 0's keys ragged (cut at 21 of 32,
    inside the third of four shards), row 1's all masked, and with a
    prefix its mask ragged on row 0 and all masked on row 1 (so row 1
    attends nothing: output 0)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v, g = (normal(B, H, S, D) for _ in range(4))
    mask = np.ones((B, S), np.int32)
    mask[0, 21:] = 0
    mask[1] = 0
    k_p = v_p = prefix_mask = None
    if prefix:
        k_p, v_p = normal(B, H, S_P, D), normal(B, H, S_P, D)
        prefix_mask = np.ones((B, S_P), np.int32)
        prefix_mask[0, 5:] = 0
        prefix_mask[1] = 0
    out, grads = _jax_ring(n, q, k, v, mask, k_p, v_p, prefix_mask, g)
    case = {"n": n, "impl": impl, "tol": TOL, "zero_rows": 1,
            "q": torch.from_numpy(q), "k": torch.from_numpy(k), "v": torch.from_numpy(v),
            "g": torch.from_numpy(g), "mask": torch.from_numpy(mask),
            "out": torch.from_numpy(np.array(out)),
            "grads": [torch.from_numpy(np.array(x)) for x in grads]}
    if prefix:
        case.update(k_p=torch.from_numpy(k_p), v_p=torch.from_numpy(v_p),
                    prefix_mask=torch.from_numpy(prefix_mask))
    assert float(np.abs(out[1]).max()) == 0.0  # JAX's own convention
    return case


def test_ring_matches_jax_flash_ring(tmp_path):
    """n = 1, 2, 4 with the prefix (impl 'auto', 'pallas', 'xla': one
    route) and n = 2 without it (the local hop seeds the merge), in one
    launch of 4 processes."""
    cases = {"n1_prefix": _case(1, 1, "auto", True), "n2_prefix": _case(2, 2, "pallas", True),
             "n4_prefix": _case(4, 4, "xla", True), "n2": _case(5, 2, "pallas", False)}
    path = tmp_path / "ring.pt"
    torch.save({"cases": cases}, path)
    outs = parallel_worker.launch("ring", {"inputs": str(path)}, 4, tmp_path, timeout=200)
    for r, o in enumerate(outs):
        for name in cases:
            assert f"ring {name} ok {r}" in o, o[-3000:]


def test_ring_splash_raises_the_jax_error():
    """'splash' has no ring route: the JAX package's ValueError."""
    import jax
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from tdm_tpu.ops.ring_attention import ring_attention

    x = np.zeros((1, 1, 8, 4), np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    seq = P(None, None, "sp", None)
    with pytest.raises(ValueError) as jerr:
        shard_map(lambda q, k, v: ring_attention(q, k, v, axis_name="sp", impl="splash"),
                  mesh=mesh, in_specs=(seq,) * 3, out_specs=seq)(x, x, x)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError) as terr:
        tring.ring_attention(t, t, t, group=pmesh.AxisGroup(1, 0, None, (0,)), impl="splash")
    assert str(terr.value) == str(jerr.value) == "unknown ring attention impl 'splash'"


@pytest.mark.cuda
def test_ring_on_card_matches_its_plain_run():
    """A world of one ring with the prefix on the card: the kernels' ring
    (kernel 1 with its lse on both hops, kernels 2 and 3 on both hops of
    the backward, 2 launches each) against `plain_ring_attention` on the
    same bf16 inputs [1, 4, 300, 64] over a 300-row shard and a 226-row
    prefix with a ragged mask: the output and every gradient within a
    relative L2 of 1e-2 (bf16 rounding of p and dS at other points)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, g = (bf16(1, 4, 300, 64) for _ in range(4))
    k_p, v_p = bf16(1, 4, 226, 64), bf16(1, 4, 226, 64)
    mask = (torch.arange(300, device=dev) < 211)[None].int()
    group = pmesh.AxisGroup(1, 0, None, (0,))
    results = []
    for fn in (tring.ring_attention, tring.plain_ring_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, k_p, v_p)]
        tattn.reset_launches()
        out = fn(*leaves[:3], group=group, key_mask=mask, prefix_kv=(leaves[3], leaves[4]))
        grads = torch.autograd.grad((out.float() * g.float()).sum(), leaves)
        results.append((out, grads, tattn.launch_counts()))
    (out, grads, counts), (ref, ref_grads, plain_counts) = results
    assert counts["flash_attention_fwd_lse"] == 2 and counts["flash_attention_bwd_dq"] == 2
    assert counts["flash_attention_bwd_dkv"] == 2 and counts["flash_attention_fwd"] == 0
    assert not any(plain_counts.values())
    for got, want in zip((out.detach(), *grads), (ref.detach(), *ref_grads)):
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel <= 1e-2, rel
