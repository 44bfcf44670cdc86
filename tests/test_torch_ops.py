"""The port's ops (`ngf_tpu_torch/ops/`) against `ngf_tpu/ops/` on the CPU.

The same numpy inputs, made from seeds, go through the JAX function and its
port (plain PyTorch on the CPU). Tolerances:
- elementwise float32 math (encoding, rays, compositing, trilinear sample):
  ATOL = RTOL = 1e-5, a few float32 ulps of O(1) values summed in another
  order;
- ``grid_sample_2d`` in float32: 1e-5, the same sum of four weighted taps;
- ``grid_sample_2d`` in bfloat16 against JAX: JAX multiplies and sums the
  taps in bfloat16, the port in float32 before one rounding, so they may
  differ by a few bfloat16 ulps: 4 * 2^-8 of the plane's largest value.
The CUDA kernel itself is tested on the card by `tests/test_torch_cuda.py`.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ngf_tpu.ops import compositing as j_comp  # noqa: E402
from ngf_tpu.ops import encoding as j_enc  # noqa: E402
from ngf_tpu.ops import grid_sample as j_gs  # noqa: E402
from ngf_tpu.ops import rays as j_rays  # noqa: E402
from ngf_tpu.ops.pallas_kernels import pallas_grid_sample_2d  # noqa: E402
from ngf_tpu_torch.ops import compositing as t_comp  # noqa: E402
from ngf_tpu_torch.ops import cuda_kernels  # noqa: E402
from ngf_tpu_torch.ops import encoding as t_enc  # noqa: E402
from ngf_tpu_torch.ops import grid_sample as t_gs  # noqa: E402
from ngf_tpu_torch.ops import rays as t_rays  # noqa: E402

ATOL = RTOL = 1e-5
GS_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


class TestEncoding:
    @pytest.mark.parametrize("freqs", [2, 4, 12])
    def test_positional_encoding(self, freqs):
        x = np.random.default_rng(freqs).uniform(-1, 1, (5, 7, 3)).astype(np.float32)
        want = j_enc.positional_encoding(jnp.asarray(x), freqs)
        _close(t_enc.positional_encoding(_t(x), freqs), want, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("freqs", [4, 12])
    def test_infoinv_modulate(self, freqs):
        rng = np.random.default_rng(1)
        feat = rng.normal(size=(64, 6 * freqs)).astype(np.float32)
        xyz = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        want = j_enc.infoinv_modulate(jnp.asarray(feat), jnp.asarray(xyz), freqs)
        _close(t_enc.infoinv_modulate(_t(feat), _t(xyz), freqs), want, atol=1e-4, rtol=1e-4)

    def test_infoinv_channel_mismatch_raises(self):
        with pytest.raises(ValueError):
            t_enc.infoinv_modulate(torch.zeros(4, 10), torch.zeros(4, 3), 4)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0, 1] = 0.0  # exactly-zero components take the 1e-6 substitution
    d[1, :2] = 0.0
    return o, d


AABB = np.array([[-1.5, -1.2, -1.0], [1.5, 1.3, 1.1]], np.float32)


class TestRays:
    def test_ray_aabb_tmin(self):
        o, d = _rays(200, 0)
        want = j_rays.ray_aabb_tmin(jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB), 2.0, 6.0)
        _close(t_rays.ray_aabb_tmin(_t(o), _t(d), _t(AABB), 2.0, 6.0), want)

    def test_ray_aabb_range(self):
        o, d = _rays(200, 1)
        jmin, jmax = j_rays.ray_aabb_range(jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB))
        tmin, tmax = t_rays.ray_aabb_range(_t(o), _t(d), _t(AABB))
        _close(tmin, jmin, rtol=1e-4)
        _close(tmax, jmax, rtol=1e-4)

    @pytest.mark.parametrize("train", [False, True])
    def test_stratified_sample(self, train):
        o, d = _rays(50, 2)
        key = jax.random.PRNGKey(7)
        jpts, jz, jin = j_rays.stratified_sample(
            key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB), 2.0, 6.0, 33, 0.05, train
        )
        # The JAX path draws u = uniform(key, (n, 1)); the port takes it injected.
        jitter = _t(np.asarray(jax.random.uniform(key, (50, 1)))) if train else None
        pts, z, inb = t_rays.stratified_sample(_t(o), _t(d), _t(AABB), 2.0, 6.0, 33, 0.05, jitter)
        _close(z, jz)
        _close(pts, jpts)
        np.testing.assert_array_equal(inb.numpy(), np.asarray(jin))


class TestCompositing:
    def test_raw2alpha(self):
        rng = np.random.default_rng(3)
        sigma = rng.exponential(2.0, (16, 40)).astype(np.float32)
        dist = rng.uniform(0, 0.2, (16, 40)).astype(np.float32)
        want = j_comp.raw2alpha(jnp.asarray(sigma), jnp.asarray(dist))
        for got, w in zip(t_comp.raw2alpha(_t(sigma), _t(dist)), want):
            _close(got, w)


class TestGridSample3D:
    @pytest.mark.parametrize("shape", [(5, 6, 7, 1), (4, 4, 4, 3)])
    def test_matches_jax(self, shape):
        rng = np.random.default_rng(4)
        vol = rng.normal(size=shape).astype(np.float32)
        coords = rng.uniform(-1.2, 1.2, (3, 31, 3)).astype(np.float32)
        want = j_gs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords))
        _close(t_gs.grid_sample_3d(_t(vol), _t(coords)), want)


def _plane_coords(shape, n, seed, lim=1.2):
    rng = np.random.default_rng(seed)
    plane = rng.normal(size=shape).astype(np.float32)
    coords = rng.uniform(-lim, lim, (n, 2)).astype(np.float32)
    return plane, coords


class TestGridSample2D:
    @pytest.mark.parametrize("shape", [(8, 8, 4), (16, 9, 3), (2, 2, 5), (32, 32, 24)])
    def test_matches_jax_and_pallas(self, shape):
        plane, coords = _plane_coords(shape, 257, sum(shape))
        got = t_gs.grid_sample_2d(_t(plane), _t(coords))
        _close(got, j_gs.grid_sample_2d(jnp.asarray(plane), jnp.asarray(coords)), GS_TOL, GS_TOL)
        want = pallas_grid_sample_2d(jnp.asarray(plane), jnp.asarray(coords), interpret=True)
        _close(got, want, GS_TOL, GS_TOL)

    @pytest.mark.parametrize("channels", [slice(0, 24), slice(24, 96)])
    def test_channel_slice_view(self, channels):
        """A channel slice of a 96-channel plane goes in as a view."""
        plane, coords = _plane_coords((16, 16, 96), 300, 5)
        view = _t(plane)[..., channels]
        assert not view.is_contiguous()
        want = j_gs.grid_sample_2d(jnp.asarray(plane[..., channels]), jnp.asarray(coords))
        _close(t_gs.grid_sample_2d(view, _t(coords)), want, GS_TOL, GS_TOL)

    def test_strided_coords(self):
        """The projections xyz[..., 0:2], 1:3, 0::2 are views with stride 3."""
        rng = np.random.default_rng(6)
        plane = rng.normal(size=(12, 10, 4)).astype(np.float32)
        xyz = rng.uniform(-1, 1, (4, 20, 3)).astype(np.float32)
        for sl in (np.s_[..., 0:2], np.s_[..., 1:3], np.s_[..., 0::2]):
            want = j_gs.grid_sample_2d(jnp.asarray(plane), jnp.asarray(xyz[sl]))
            _close(t_gs.grid_sample_2d(_t(plane), _t(xyz)[sl]), want, GS_TOL, GS_TOL)

    def test_torch_grid_sample_oracle(self):
        plane, coords = _plane_coords((11, 13, 6), 400, 8)
        want = F.grid_sample(
            _t(plane).permute(2, 0, 1)[None], _t(coords).view(1, -1, 1, 2),
            mode="bilinear", padding_mode="zeros", align_corners=True,
        )[0, :, :, 0].t()
        _close(t_gs.grid_sample_2d(_t(plane), _t(coords)), want.numpy(), GS_TOL, GS_TOL)

    def test_corners_and_padding(self):
        """Golden of tests/test_pallas_kernels.py: -1/+1 hit texel 0 / size-1
        exactly; stencils fully outside give zero."""
        H, W, C = 5, 7, 2
        plane = np.arange(H * W * C, dtype=np.float32).reshape(H, W, C)
        coords = np.array([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [-3.0, 0.0], [0.0, 3.0]],
                          np.float32)
        got = t_gs.grid_sample_2d(_t(plane), _t(coords)).numpy()
        np.testing.assert_array_equal(got[0], plane[0, 0])
        np.testing.assert_array_equal(got[1], plane[-1, -1])
        np.testing.assert_array_equal(got[2], plane[-1, 0])
        np.testing.assert_array_equal(got[3], 0.0)
        np.testing.assert_array_equal(got[4], 0.0)

    def test_stencil_straddling_edge(self):
        """Half a texel outside: the outside tap weighs 0, not the clamped texel."""
        plane = np.ones((4, 4, 1), np.float32)
        half = 0.5 * 2.0 / 3.0  # half a texel in [-1, 1] units at size 4
        coords = np.array([[-1.0 - half, 0.0], [1.0 + half, 0.0], [0.0, -1.0 - half]], np.float32)
        got = t_gs.grid_sample_2d(_t(plane), _t(coords)).numpy()[:, 0]
        np.testing.assert_allclose(got, 0.5, atol=1e-6)
        want = j_gs.grid_sample_2d(jnp.asarray(plane), jnp.asarray(coords))
        _close(got, np.asarray(want)[:, 0], GS_TOL, GS_TOL)

    def test_batch_shape(self):
        """Golden of tests/test_pallas_kernels.py: the batch shape round-trips."""
        rng = np.random.default_rng(0)
        plane = rng.normal(size=(8, 8, 8)).astype(np.float32)
        coords = rng.uniform(-1, 1, (3, 11, 2)).astype(np.float32)
        got = t_gs.grid_sample_2d(_t(plane), _t(coords))
        assert got.shape == (3, 11, 8)
        want = pallas_grid_sample_2d(jnp.asarray(plane), jnp.asarray(coords), interpret=True)
        _close(got, want, GS_TOL, GS_TOL)

    def test_bfloat16_against_jax(self):
        plane, coords = _plane_coords((16, 16, 8), 500, 9)
        got = t_gs.grid_sample_2d(_t(plane).bfloat16(), _t(coords))
        assert got.dtype == torch.bfloat16
        want = j_gs.grid_sample_2d(jnp.asarray(plane, jnp.bfloat16), jnp.asarray(coords))
        tol = 4 * 2.0 ** -8 * np.abs(plane).max()
        _close(got, np.asarray(want, np.float32), atol=tol, rtol=0)

    def test_small_plane_raises(self):
        with pytest.raises(ValueError):
            t_gs.grid_sample_2d(torch.zeros(1, 5, 2), torch.zeros(3, 2))

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        """No fallback: the kernel's wrapper takes CUDA tensors or raises."""
        with pytest.raises(ValueError):
            cuda_kernels.bilinear_gather_2d(torch.zeros(4, 4, 3), torch.zeros(5, 2))

