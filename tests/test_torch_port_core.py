"""The port's schedules, sampler and attention against the JAX package.

Inputs come from numpy seeds and go through both packages as numpy arrays.
Everything here is fp32 on the CPU, where the two differ only in the order
of sums and in exp/sin implementations: tolerances are ~1e-5 relative
(1e-4 after the sampler's 1/α ≈ 60× amplification at t=899). The kernel's
own check against its plain version needs the card: it lives in
tests/test_torch_port_rules.py, which imports no JAX.
"""

import atexit
import glob
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

from tdm_tpu.core import sampling as jsampling, schedules as jsched
from tdm_tpu.ops.attention import attention as jattention
from tdm_tpu_torch.core import sampling as tsampling, schedules as tsched
from tdm_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

# The persistent XLA compile cache that tests/conftest.py turns on aborts the
# process ("Fatal Python error: Aborted") when it loads the cached 8-device
# sequence-parallel programs of tests/test_tdm_video.py: on an empty cache
# directory those tests pass, and the next run, which loads what the first
# stored, aborts in both of them. Every pytest-xdist worker imports this
# module while collecting, before any test runs, so pointing the cache at a
# directory of this run alone (shared by its workers, which keeps their
# reuse of each other's compiles) makes every run start from an empty cache.
# Each process registers under <dir>.users and unregisters at exit; the last
# one out removes the directory. A worker that xdist kills while it exits
# (it waits 10 s) may not get that far, so each run also removes the
# directories of earlier runs whose registered processes are all gone.
_RUN = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
_PREFIX = os.path.join(tempfile.gettempdir(), "jax_test_cache_run_")
_CACHE = _PREFIX + _RUN
_USERS = _CACHE + ".users"
_ME = os.path.join(_USERS, str(os.getpid()))


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


def _remove_cache(cache: str) -> None:
    shutil.rmtree(cache, ignore_errors=True)
    shutil.rmtree(cache + ".users", ignore_errors=True)


for _users in glob.glob(_PREFIX + "*.users"):
    try:
        _stale = _users != _USERS and not any(_alive(int(p)) for p in os.listdir(_users))
    except FileNotFoundError:  # another run removed it meanwhile
        continue
    if _stale:
        _remove_cache(_users.removesuffix(".users"))
os.makedirs(_USERS, exist_ok=True)
open(_ME, "w").close()
compilation_cache.set_cache_dir(_CACHE)
compilation_cache.reset_cache()
# The JAX package's CLIs and server turn the cache on themselves
# (`utils.config.enable_compilation_cache`), in the directory that
# $JAX_COMPILATION_CACHE_DIR names: tests/conftest.py's shared one unless
# it names this run's. A worker that ran one of their tests went on with the
# shared directory, where an earlier run had stored the sequence-parallel
# programs, and aborted when it came to them.
os.environ["JAX_COMPILATION_CACHE_DIR"] = _CACHE


@atexit.register
def _remove_the_cache_when_last_out() -> None:
    if os.path.basename(_ME) != str(os.getpid()):
        return  # a forked child exiting: its parent is still using the cache
    os.remove(_ME)
    try:
        last = not os.listdir(_USERS)
    except FileNotFoundError:  # another process was last and removed it
        return
    if last:
        _remove_cache(_CACHE)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module", params=[jsched.EPSILON, jsched.V_PREDICTION, jsched.FLOW])
def schedules(request):
    pt = request.param
    return (
        jsched.ddpm_linear(prediction_type=pt),
        tsched.ddpm_linear(prediction_type=pt, device="cpu"),
    )


def test_schedule_tables_identical(schedules):
    js, ts = schedules
    np.testing.assert_array_equal(np.asarray(js.alphas), ts.alphas.numpy())
    np.testing.assert_array_equal(np.asarray(js.sigmas), ts.sigmas.numpy())
    assert ts.alphas.dtype == torch.float32
    assert (ts.num_train_timesteps, ts.prediction_type) == (
        js.num_train_timesteps, js.prediction_type)


def test_schedule_math_matches(schedules):
    js, ts = schedules
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    out = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    t = np.array([899, 450, 3])
    ref = np.asarray(jsched.add_noise(js, jnp.asarray(x), jnp.asarray(out), jnp.asarray(t)))
    got = tsched.add_noise(ts, _t(x), _t(out), _t(t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg="add_noise")
    for jfn, tfn in (
        (jsched.predicted_origin, tsched.predicted_origin),
        (jsched.predicted_noise, tsched.predicted_noise),
    ):
        ref = np.asarray(jfn(js, jnp.asarray(out), jnp.asarray(t), jnp.asarray(x)))
        got = tfn(ts, _t(out), _t(t), _t(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=jfn.__name__)


def test_add_noise_keeps_x0_dtype():
    """`add_noise` returns the dtype of x₀ (schedules.py:255), so the
    sampler state stays bf16 when the noise is bf16."""
    ts = tsched.ddpm_linear(device="cpu")
    x0 = torch.ones(2, 4, dtype=torch.bfloat16)
    out = tsched.add_noise(ts, x0, torch.ones(2, 4), torch.tensor([10, 20]))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("total,k", [(900, 4), (1000, 4), (900, 1), (10, 3)])
def test_fewstep_grid_matches(total, k):
    np.testing.assert_array_equal(
        tsched.fewstep_grid(total, k).numpy(), np.asarray(jsched.fewstep_grid(total, k))
    )
    assert tsched.fewstep_grid(900, 4).tolist() == [899, 674, 449, 224]
    assert tsched.grid_from_list([999, 856]).tolist() == [999, 856]


def _denoisers():
    """One analytic denoiser in both frameworks: cond is a [B,1,1,1]
    gain, so CFG's two branches differ."""

    def jfn(x, t, cond):
        return jnp.tanh(x * cond) + 1e-3 * t.astype(jnp.float32)[:, None, None, None]

    def tfn(x, t, cond):
        return torch.tanh(x * cond) + 1e-3 * t.float()[:, None, None, None]

    return jfn, tfn


@pytest.mark.parametrize("cfg", [None, 3.0])
def test_sample_fewstep_trajectory_matches(cfg):
    jfn, tfn = _denoisers()
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    cond = np.array([0.7, 1.3], np.float32).reshape(2, 1, 1, 1)
    uncond = np.full((2, 1, 1, 1), 0.2, np.float32)
    jtraj = jsampling.sample_fewstep(
        jfn, jsched.ddpm_linear(), jnp.asarray(noise), jnp.asarray(cond),
        timestep_grid=jsched.fewstep_grid(900, 4), uncond=jnp.asarray(uncond),
        cfg=cfg, return_trajectory=True,
    )
    ttraj = tsampling.sample_fewstep(
        tfn, tsched.ddpm_linear(device="cpu"), _t(noise), _t(cond),
        timestep_grid=tsched.fewstep_grid(900, 4), uncond=_t(uncond),
        cfg=cfg, return_trajectory=True,
    )
    for name in ("final", "states", "x0s", "noise_preds"):
        ref = np.asarray(getattr(jtraj, name))
        got = getattr(ttraj, name).numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4, err_msg=name)
    final = tsampling.sample_fewstep(
        tfn, tsched.ddpm_linear(device="cpu"), _t(noise), _t(cond),
        timestep_grid=tsched.fewstep_grid(900, 4), uncond=_t(uncond), cfg=cfg,
    )
    torch.testing.assert_close(final, ttraj.final, rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [None, 2.0])
def test_predict_x0_matches(cfg):
    jfn, tfn = _denoisers()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([674, 224])
    cond, uncond = np.float32(0.9), np.float32(0.1)
    ref = jsampling.predict_x0(
        jfn, jsched.ddpm_linear(), jnp.asarray(x), jnp.asarray(t), cond,
        uncond=uncond, cfg=cfg,
    )
    got = tsampling.predict_x0(
        tfn, tsched.ddpm_linear(device="cpu"), _t(x), _t(t), torch.tensor(cond),
        uncond=torch.tensor(uncond), cfg=cfg,
    )
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


# --- attention: the plain version against both JAX implementations --------

ATTN_CASES = {
    # name: (b, h, sq, sk, d, key lengths or None)
    "no_mask": (2, 2, 64, 64, 32, None),
    "ragged_mask": (3, 2, 48, 40, 16, [40, 23, 7]),
    "all_masked_row": (2, 2, 32, 24, 16, [24, 0]),
    "sq_ne_sk_d72": (2, 3, 100, 77, 72, [77, 50]),
    "pixart_like": (1, 2, 256, 120, 72, [31]),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_jax(case):
    b, h, sq, sk, d, lengths = ATTN_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    mask = None
    if lengths is not None:
        mask = (np.arange(sk)[None] < np.array(lengths)[:, None]).astype(np.int32)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)
    for impl in ("plain", "auto"):  # on a CPU tensor 'auto' is the plain version
        got = tattn.attention(_t(q), _t(k), _t(v), tmask, impl=impl).numpy()
        for jimpl in ("pallas", "xla"):
            ref = np.asarray(jattention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                impl=jimpl, interpret=True,
            ))
            np.testing.assert_allclose(
                got, ref, rtol=2e-5, atol=2e-5, err_msg=f"{impl} vs {jimpl}"
            )
    if lengths is not None and 0 in lengths:
        assert not got[lengths.index(0)].any()  # all-masked rows give 0


def test_attention_prescales_query_in_its_dtype():
    """q is scaled and rounded back to its dtype before the product, as the
    TPU kernel's caller does (attention.py:424)."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal((1, 1, 8, 16)).astype(np.float32)).bfloat16()
               for _ in range(3))
    scale = 0.3
    qs = (q.float() * scale).to(torch.bfloat16)
    ref = tattn.plain_attention(qs, k, v, None)
    got = tattn.attention(q, k, v, scale=scale)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_attention_rejects_unknown_impl_and_splash():
    """An unknown impl raises; 'splash' is ported (kernel 4) and computes
    the plain function, at a head dim it takes (64) and one it routes to
    the flash path (8)."""
    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(x, x, x, impl="xformers")
    rng = np.random.default_rng(4)
    for d in (64, 8):
        q, k, v = (_t(rng.standard_normal((1, 2, 9, d)).astype(np.float32)) for _ in range(3))
        torch.testing.assert_close(tattn.attention(q, k, v, impl="splash"),
                                   tattn.attention(q, k, v, impl="plain"), rtol=0, atol=0)
