"""The UV ray functions of the port (`ngf_tpu_torch/ops/rays.py`) against
`ngf_tpu/ops/rays.py` on the CPU, with JAX's uniform draws handed to the
port (its key's ``jax.random.uniform`` at the same shape):
``cube_ray_generation_with_end`` (ends inside and past the cube, a ray with
zero direction components: no bound from them), ``sample_pdf``
(deterministic and random, batched, ``side='right'`` at draws equal to CDF
values, the length check), ``refine_cube_ray_generation`` (deterministic and
random; the previous positions take no gradient) to 1e-6 of each value
(and 1e-6 absolute near 0): positions up to 6 differ by a few float32 ulps,
since the CDF's ``torch.cumsum`` adds in another order than XLA's scan and
the inverse transform divides by a CDF step. The valid masks are equal, and
the two dispatchers raise the same errors.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ngf_tpu.ops import rays as jr  # noqa: E402
from ngf_tpu_torch import ops as t_ops  # noqa: E402
from ngf_tpu_torch.ops import rays as tr  # noqa: E402

TOL = 1e-6
B, R, S = 2, 7, 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rays(seed=0):
    rng = np.random.default_rng(seed)
    campos = rng.uniform(-3, 3, (B, 3)).astype(np.float32)
    campos[0] = [0.0, 0.0, 2.5]
    target = rng.uniform(-0.5, 0.5, (B, R, 3)).astype(np.float32)
    d = target - campos[:, None]
    d[0, 0] = [0.0, 0.0, -1.0]  # two zero components
    d[0, 1] = [0.0, 0.3, -1.0]  # one
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # End points along each ray, some inside the cube, some past it.
    t_end = rng.uniform(0.5, 6.0, (B, R, 1)).astype(np.float32)
    t_end[0, :2] = 3.0  # the axis rays end inside the cube
    end = campos[:, None] + d * t_end
    return campos, d.astype(np.float32), end.astype(np.float32)


def _close(got, want, exact=False):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    if exact or want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("jitter", [0.0, 0.8])
def test_cube_ray_generation_with_end(jitter):
    campos, d, end = _rays()
    key = jax.random.PRNGKey(3)
    want = jr.cube_ray_generation_with_end(key, jnp.asarray(campos), jnp.asarray(d),
                                           jnp.asarray(end), S, 1.0, jitter)
    u = np.asarray(jax.random.uniform(key, (B, R, S), dtype=jnp.float32))
    got = tr.cube_ray_generation_with_end(_t(campos), _t(d), _t(end), S, 1.0, jitter, _t(u))
    for g, w in zip(got, want):
        _close(g, w)
    valid = np.asarray(want[2])
    assert 0 < valid.mean() < 1 and valid[0, 0].any(), "the axis ray keeps samples before its end"
    # The end bounds the samples: none valid past it.
    t_end = np.linalg.norm(end - campos[:, None], axis=-1)
    assert not (valid & (np.asarray(want[3]) >= t_end[..., None])).any()


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf(det):
    rng = np.random.default_rng(1)
    bins = np.sort(rng.uniform(0, 4, (B, R, 9)), axis=-1).astype(np.float32)
    weights = rng.uniform(0, 1, (B, R, 8)).astype(np.float32)
    weights[0, 0] = 0.0  # a flat CDF
    weights[1, 2, 3:] = 0.0
    key = jax.random.PRNGKey(7)
    want = jr.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), 16, det=det)
    u = None if det else _t(np.asarray(jax.random.uniform(key, (B, R, 16), dtype=jnp.float32)))
    got = tr.sample_pdf(_t(bins), _t(weights), 16, det=det, u=u)
    assert got.shape == (B, R, 16)
    _close(got, want)
    assert t_ops.sample_pdf is tr.sample_pdf


def test_sample_pdf_right_side_at_cdf_values_and_generator():
    bins = np.array([[0.0, 1.0, 2.0, 3.0]], np.float32)
    weights = np.array([[1.0, 0.0, 1.0]], np.float32)
    cdf = np.concatenate([[0.0], np.cumsum((weights[0] + 1e-5) / (weights[0] + 1e-5).sum())])
    u = np.concatenate([cdf[:3], [0.25, 0.75, 0.999]]).astype(np.float32)[None]
    # The JAX function draws u itself: the deterministic draws of 6 points
    # against the port's given ones, and both on the CDF's own values.
    want = jr.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), 6, det=True)
    got = tr.sample_pdf(_t(bins), _t(weights), 6, det=True)
    _close(got, want)
    on_cdf = tr.sample_pdf(_t(bins), _t(weights), 6, u=_t(u))
    inds = np.searchsorted(cdf.astype(np.float32), u[0], side="right")
    assert inds[0] == 1 and on_cdf[0, 0].item() == 0.0
    # Without u the draws come from the global generator, as torch.rand's do.
    torch.manual_seed(5)
    first = tr.sample_pdf(_t(bins), _t(weights), 6)
    torch.manual_seed(5)
    assert torch.equal(first, tr.sample_pdf(_t(bins), _t(weights), 6))
    with pytest.raises(ValueError, match="one more entry"):
        tr.sample_pdf(_t(bins), _t(bins), 4)
    with pytest.raises(ValueError, match="one more entry"):
        jr.sample_pdf(None, jnp.asarray(bins), jnp.asarray(bins), 4)


@pytest.mark.parametrize("det", [True, False])
def test_refine_cube_ray_generation(det):
    campos, d, _ = _rays(2)
    rng = np.random.default_rng(3)
    prev_ts = np.sort(rng.uniform(0.5, 5.0, (B, R, 10)), axis=-1).astype(np.float32)
    prev_w = rng.uniform(0, 1, (B, R, 10)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jr.refine_cube_ray_generation(key, jnp.asarray(campos), jnp.asarray(d), S,
                                         jnp.asarray(prev_ts), jnp.asarray(prev_w), 1.0, det)
    u = None if det else _t(np.asarray(jax.random.uniform(key, (B, R, S + 1), dtype=jnp.float32)))
    ts = _t(prev_ts).requires_grad_(True)
    got = tr.refine_cube_ray_generation(_t(campos), _t(d), S, ts, _t(prev_w), 1.0, det, u=u)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[0].shape == (B, R, S, 3) and 0 < np.asarray(want[2]).mean() <= 1
    # Only the drawn positions carry a gradient to prev_ts (through the
    # bins), never the sorted-in previous ones: JAX's stop_gradient.
    jg = jax.grad(lambda p: jr.refine_cube_ray_generation(
        key, jnp.asarray(campos), jnp.asarray(d), S, p, jnp.asarray(prev_w), 1.0, det)[3].sum())(
        jnp.asarray(prev_ts))
    got[3].sum().backward()
    _close(ts.grad, jg)


def test_dispatchers():
    assert tr.find_ray_generation_method("cube") is tr.cube_ray_generation
    assert tr.find_refined_ray_generation_method("cube") is tr.refine_cube_ray_generation
    for fn, jfn in ((tr.find_ray_generation_method, jr.find_ray_generation_method),
                    (tr.find_refined_ray_generation_method,
                     jr.find_refined_ray_generation_method)):
        with pytest.raises(RuntimeError) as got:
            fn("sphere")
        with pytest.raises(RuntimeError) as want:
            jfn("sphere")
        assert str(got.value) == str(want.value)
